"""Ragged paged-attention decode (port of
burst_attn_tpu/ops/paged_attention.py).

K/V live in a shared pool of fixed-size pages `[n_pages, Nkv, page, D]`; a
sequence owns a row of the page table.  One decode step attends each
sequence's single new query against its own pages only, so cost follows
the live length, not max_seq.

`paged_decode_attention` runs the plain `paged_decode_reference` for CPU
tensors.  For CUDA tensors it launches the ragged kernel
(csrc/ragged_paged.cu) as its QT == 1 instance, or raises: that kernel
replaces the TPU's `_decode_kernel` too.  q [B, Nkv, G, D] (GQA folds the
query-head group into the kernel's rows) is viewed as [B, Nkv*G, 1, D],
each live sequence one query token at position lengths - 1 (q_lens =
lengths > 0, kv_lens = lengths).  On an H100 a decode step is bound by
bytes (each live token's K and V rows read once per kv head; the
operations, 4 a byte at G = 4, are nothing): the kernel's decode path cuts
each sequence's pages into splits of 256 positions so that a small batch
still fills the card's 132 SMs, streams each split's 64-token chunks
through shared memory with cp.async (bf16 q on tensor cores, each of four
warps on 16 tokens of a chunk; fp32 q in SIMT fp32), and merges the
splits' partials in a fixed order (two launches are bitwise equal).  Left
for later: TMA and a producer warp, fp8 tensor-core products for 1-byte
pools.  The TPU
kernel's padding of G to 8 sublanes is a TPU tiling artefact and is not
carried over.  Pools are in q's dtype, or 1 B/elem (int8 / fp8 e4m3fn)
with per-token fp32 scales from `quantize_tokens`: the kernel dequantizes
as a column rescale of the scores and of the probabilities, as the TPU
kernel does; the plain version dequantizes the whole pool first.  A
sliding `window` limits the new token to the positions at or above
max(len - window, 0); the kernel starts its page walk there.
"""

import torch

from .flash import KERNEL_DTYPES, _check_kernel_operand

# 1 B/elem pool storage dtypes and the full-range absmax each scale maps
# onto: int8 rounds into [-127, 127]; fp8 e4m3fn casts into +-448.
QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
KERNEL_PAGE_MULTIPLE = 64  # tokens per shared-memory chunk (common.cuh)
# quantized pool dtype codes of the kernels (csrc/common.cuh)
KERNEL_POOL_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}


def _quant_range(dtype):
    """(canonical name, full-scale range) for a 1 B pool dtype."""
    for name, (cand, rng) in QUANT_DTYPES.items():
        if dtype == cand:
            return name, rng
    raise ValueError(f"unsupported quantized pool dtype {dtype!r} "
                     f"(one of {sorted(QUANT_DTYPES)})")


def quantize_tokens(x, dtype=torch.int8):
    """Per-token symmetric quantization of [..., T, D] K/V rows into a
    1 B/elem pool dtype: returns (quantized values, f32 scales [..., T]).
    scale = max|x| / range per token (127 for int8, 448 for fp8 e4m3fn);
    zero rows get scale 1 (they dequantize to exact zeros).  int8 rounds
    half to even and clips; fp8 casts directly (the cast IS the
    rounding)."""
    name, rng = _quant_range(dtype)
    amax = x.float().abs().amax(dim=-1)
    s = torch.where(amax > 0, amax / rng, torch.ones_like(amax))
    xs = x.float() / s[..., None]
    if name == "int8":
        q = torch.clamp(torch.round(xs), -rng, rng).to(torch.int8)
    else:
        q = xs.to(torch.float8_e4m3fn)
    return q, s


def pool_bytes(t):
    """A 1 B/elem pool (or rows for it) seen as uint8, else t itself: pool
    writes, copies and gathers move quantized pages as bytes, since not
    every PyTorch indexing kernel has an fp8 instance."""
    return t.view(torch.uint8) if t.dtype in KERNEL_POOL_DTYPES else t


def gather_pages(pages, scales, idx):
    """Gather pool pages page-contiguously, dequantizing a quantized pool
    (pages times per-token scales, fp32): pages [P, Nkv, page, D], idx
    [..., n] -> [..., Nkv, n*page, D]."""
    g = pool_bytes(pages)[idx.long()].view(pages.dtype)
    if scales is not None:
        g = g.float() * scales[idx.long()][..., None]
    g = g.movedim(-3, -4)
    return g.reshape(*g.shape[:-4], g.shape[-4], g.shape[-3] * g.shape[-2],
                     g.shape[-1])


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           k_scales=None, v_scales=None, window=None,
                           scale=None):
    """One ragged decode step against a paged KV pool.

    q          [B, Nkv, G, D]    one new token per sequence, query heads
                                 grouped under their kv head
    k_pages    [P, Nkv, page, D] shared pool, in q's dtype or int8 / fp8
    v_pages    [P, Nkv, page, D]
    page_table [B, S] int32      pool page id per (sequence, slot); slots at
                                 or past ceil(len/page) are ignored
    lengths    [B] int32         live tokens per sequence (0 = empty)
    k_scales / v_scales  [P, Nkv, page] fp32 per-token dequant scales of a
                                 quantized pool: both or neither
    window     int >= 1 or None  sliding window: the new token (at position
                                 len - 1) sees positions >= len - window

    Returns [B, Nkv, G, D] in q's dtype; empty sequences give zeros."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, page_table,
                                      lengths, scale=scale,
                                      k_scales=k_scales, v_scales=v_scales,
                                      window=window)
    return _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                              k_scales, v_scales, scale, window)


paged_decode_attention.launches = 0


def check_pool_operands(q, k_pages, v_pages, k_scales, v_scales):
    """Check the pool a paged kernel reads: pages in q's dtype, or a
    1 B/elem pool with its two fp32 scale banks.  Returns the pool's dtype
    code (csrc/common.cuh)."""
    dev = q.device
    n_pages, n_kv, page, d = k_pages.shape
    if page % KERNEL_PAGE_MULTIPLE:
        raise ValueError(f"page size {page} must be a multiple of "
                         f"{KERNEL_PAGE_MULTIPLE}")
    pool_dtype = q.dtype
    if k_scales is not None:
        if k_pages.dtype not in KERNEL_POOL_DTYPES:
            raise ValueError(f"a pool with scales must be int8 or fp8 "
                             f"e4m3fn, got {k_pages.dtype}")
        pool_dtype = k_pages.dtype
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            _check_kernel_operand(name, t, dev, torch.float32,
                                  (n_pages, n_kv, page))
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check_kernel_operand(name, t, dev, pool_dtype,
                              (n_pages, n_kv, page, d))
    return KERNEL_POOL_DTYPES.get(pool_dtype, KERNEL_DTYPES[q.dtype])


def data_ptr(t):
    """A tensor's device address for a kernel argument (None for None)."""
    return None if t is None else t.data_ptr()


def _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths, k_scales,
                       v_scales, scale, window):
    from . import ragged_paged  # it imports this module

    b, n_kv, g, d = q.shape
    _check_kernel_operand("q", q, q.device, q.dtype)  # before the view
    # the ragged kernel's QT=1 instance: q_lens None = one token per
    # sequence whose length is > 0; launch checks the rest
    out = ragged_paged.launch(q.view(b, n_kv * g, 1, d), k_pages, v_pages,
                              page_table, None, lengths, k_scales, v_scales,
                              scale, None, False, window,
                              "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out.reshape(q.shape)


def paged_decode_reference(q, k_pages, v_pages, page_table, lengths,
                           scale=None, k_scales=None, v_scales=None,
                           window=None):
    """Plain version of the kernel: gathers each sequence's pages into a
    contiguous cache (dequantized first for a quantized pool) and runs
    dense masked attention in fp32, positions below max(len - window, 0)
    masked with a window.  O(B·S·page) memory."""
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    k = gather_pages(k_pages, k_scales, page_table)  # [B, Nkv, S*page, D]
    v = gather_pages(v_pages, v_scales, page_table)
    s = torch.einsum("bngd,bnjd->bngj", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[2], device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window is not None:
        valid &= pos >= (lengths[:, None] - window).clamp(min=0)
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)  # all-masked -> 0
    return torch.einsum("bngj,bnjd->bngd", p, v.float()).to(q.dtype)
