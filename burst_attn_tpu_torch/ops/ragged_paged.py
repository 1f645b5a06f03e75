"""Ragged paged attention (port of burst_attn_tpu/ops/ragged_paged.py): ONE
launch for a mixed prefill+decode token batch against the paged KV pool.

Each slot brings its own query token count `q_lens[s]` (0 = idle, 1 =
decode, up to the chunk width = prefill); query token t of slot s sits at
absolute position `kv_lens[s] - q_lens[s] + t` and sees the pool positions
at or below it (with a sliding `window`, only its last `window` of
them).  `ragged_paged_attention` launches the hand-written kernel
in csrc/ragged_paged.cu for CUDA tensors (or raises) and runs the plain
version for CPU tensors.  A pure-decode batch (QT == 1) through the kernel
is bitwise `paged_decode_attention` on the same pool: both kernels run one
shared online-softmax update (csrc/common.cuh).

The q layout [S, Nq, QT, D] is indexed directly by the kernel: the TPU
kernel's group folding copies and 8-sublane row padding are TPU tiling
artefacts and have no counterpart.  `ragged_paged_attention_grouped` is
the shared-prefix front end: the private band through the kernel's split-k
partials, the shared band and the log-sum-exp merge in plain torch (they
are plain jnp outside any Pallas kernel in the JAX package too).
`ragged_supported` states the kernel's limits with prefix-stable reasons;
the serving engine maps a declined shape to its dense route.
"""

import math

import torch

from . import _build
from .flash import KERNEL_DTYPES, KERNEL_HEAD_DIMS, _check_kernel_operand
from .paged_attention import (
    KERNEL_PAGE_MULTIPLE, check_pool_operands, data_ptr, gather_pages,
)

KERNEL_MAX_ROWS = 64  # query rows per block (csrc/ragged_paged.cu MAXR)
SMEM_LIMIT = 232448   # dynamic shared memory one block can use on Hopper
LOG2E = math.log2(math.e)


def _smem_plan(d_head: int) -> int:
    """csrc/ragged_paged.cu smem_bytes(): q rows, one K/V chunk, scores,
    per-row state and the chunk's scales, in fp32."""
    rows, ch = KERNEL_MAX_ROWS, KERNEL_PAGE_MULTIPLE
    return 4 * (rows * d_head + ch * (d_head + 4) + ch * d_head + rows * ch
                + 3 * rows + 2 * ch)


def ragged_supported(*, n_kv_heads, n_q_heads, q_tokens, d_head, page,
                     dtype=torch.bfloat16, device="cuda"):
    """Capability probe: None when ragged_paged_attention can serve this
    shape, else a reason whose PREFIX is a stable key (the serving engine
    maps it to a bounded fallback-counter label).  The limits are the CUDA
    kernel's; on the CPU (`device="cpu"`) the plain version takes any head
    dim and dtype, as the JAX probe relaxes the head dim in interpret
    mode.  A quantized pool changes no limit."""
    if q_tokens < 1:
        return f"empty q chunk: q_tokens {q_tokens} < 1"
    if n_q_heads % n_kv_heads:
        return (f"GQA group mismatch: {n_q_heads} query heads not a "
                f"multiple of {n_kv_heads} kv heads")
    if page % KERNEL_PAGE_MULTIPLE:
        return (f"page size {page} is not a multiple of the "
                f"{KERNEL_PAGE_MULTIPLE}-token chunk")
    group = n_q_heads // n_kv_heads
    if group > KERNEL_MAX_ROWS:
        return (f"q-block rows: group {group} exceeds the "
                f"{KERNEL_MAX_ROWS}-row block")
    plan = _smem_plan(d_head)
    if plan > SMEM_LIMIT:
        return (f"shared-memory plan {plan} bytes exceeds the {SMEM_LIMIT} "
                f"a block can use (d_head {d_head})")
    if torch.device(device).type == "cpu":
        return None
    if d_head not in KERNEL_HEAD_DIMS:
        return (f"head dim {d_head} is not one the kernel is built for "
                f"{KERNEL_HEAD_DIMS}")
    if dtype not in KERNEL_DTYPES:
        return f"dtype {dtype} is not one of {list(KERNEL_DTYPES)}"
    return None


def ragged_paged_attention(q, k_pages, v_pages, page_table, q_lens, kv_lens,
                           *, k_scales=None, v_scales=None, window=None,
                           scale=None, ctx_lo=None, emit_partials=False):
    """Mixed prefill+decode ragged attention against a paged KV pool.

    q          [S, Nq, QT, D]    query tokens per slot; rows at or past
                                 q_lens[s] are padding and give zeros
    k_pages    [P, Nkv, page, D] shared pool in q's dtype or int8 / fp8 —
    v_pages    [P, Nkv, page, D] the new tokens' K/V must already be in it
    page_table [S, n_slots] int32 pool page per (slot, table column)
    q_lens     [S] int32         query tokens this launch (0 = idle slot)
    kv_lens    [S] int32         live tokens INCLUDING this launch's
    k_scales / v_scales          [P, Nkv, page] fp32 per-token dequant
                                 scales of a quantized pool, both or neither
    ctx_lo     [S] int32         page-aligned lower context bound: whole
                                 pages below it are excluded
    window     int >= 1 or None  sliding window: the token at position qp
                                 sees qp - window + 1 .. qp
    emit_partials                return the unnormalized split-k partial
                                 (acc [S,Nq,QT,D], m [S,Nq,QT,1],
                                 l [S,Nq,QT,1], fp32, base-2 softmax
                                 domain) instead of the output

    Returns [S, Nq, QT, D] in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if q.shape[1] % k_pages.shape[1]:
        raise ValueError(f"{q.shape[1]} query heads not grouped by "
                         f"{k_pages.shape[1]} kv heads")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        acc, m, l = ragged_paged_partials_reference(
            q, k_pages, v_pages, page_table, q_lens, kv_lens,
            k_scales=k_scales, v_scales=v_scales, scale=scale,
            ctx_lo=ctx_lo, window=window)
        if emit_partials:
            return acc, m, l
        return _normalize(acc, l, q.dtype)
    return _ragged_cuda(q, k_pages, v_pages, page_table, q_lens, kv_lens,
                        k_scales, v_scales, scale, ctx_lo, emit_partials,
                        window)


ragged_paged_attention.launches = 0


def _ragged_cuda(q, k_pages, v_pages, page_table, q_lens, kv_lens, k_scales,
                 v_scales, scale, ctx_lo, emit_partials, window):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu "
                         f"tensors, got {dev}")
    s, n_q, qt, d = q.shape
    n_kv, page = k_pages.shape[1], k_pages.shape[2]
    width = page_table.shape[1]
    reason = ragged_supported(n_kv_heads=n_kv, n_q_heads=n_q, q_tokens=qt,
                              d_head=d, page=page, dtype=q.dtype)
    if reason is not None:
        raise ValueError(f"ragged_paged kernel: {reason}")
    _check_kernel_operand("q", q, dev, q.dtype)
    kv_code = check_pool_operands(q, k_pages, v_pages, k_scales, v_scales)
    _check_kernel_operand("page_table", page_table, dev, torch.int32,
                          (s, width))
    for name, t in (("q_lens", q_lens), ("kv_lens", kv_lens),
                    ("ctx_lo", ctx_lo)):
        if t is not None:
            _check_kernel_operand(name, t, dev, torch.int32, (s,))
    out = acc = m = l = None
    if emit_partials:
        acc = torch.empty(q.shape, dtype=torch.float32, device=dev)
        m = torch.empty((s, n_q, qt, 1), dtype=torch.float32, device=dev)
        l = torch.empty((s, n_q, qt, 1), dtype=torch.float32, device=dev)
        result = (acc, m, l)
    else:
        result = out = torch.empty_like(q)
    if q.numel() == 0:
        return result
    lib = _build.load("ragged_paged")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ragged_paged_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            data_ptr(k_scales), data_ptr(v_scales), page_table.data_ptr(),
            q_lens.data_ptr(), kv_lens.data_ptr(), data_ptr(ctx_lo),
            data_ptr(out), data_ptr(acc), data_ptr(m), data_ptr(l),
            s, n_kv, n_q // n_kv, qt, d, page, width,
            0 if window is None else int(window), KERNEL_DTYPES[q.dtype],
            kv_code, float(scale), stream)
    _build.check(err, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return result


def _normalize(acc, l, dtype):
    """acc / l, with rows that saw nothing (l == 0) giving zeros."""
    return (acc / torch.where(l > 0, l, 1.0)).to(dtype)


def _visible(q_lens, kv_lens, qt, n_pos, page, ctx_lo=None, window=None):
    """[S, QT, n_pos] bool: query token t of slot s sees pool position j.
    Padding rows (t >= q_lens) see nothing; ctx_lo drops whole pages; a
    window drops the positions below each token's band."""
    dev = q_lens.device
    t = torch.arange(qt, device=dev)
    col = torch.arange(n_pos, device=dev)
    qp = (kv_lens - q_lens).long()[:, None] + t[None, :]       # [S, QT]
    valid = col[None, None, :] <= qp[:, :, None]
    if window is not None:
        valid &= col[None, None, :] > qp[:, :, None] - window
    valid &= (t[None, :] < q_lens[:, None])[:, :, None]
    if ctx_lo is not None:
        lo = (ctx_lo.long() // page) * page
        valid &= col[None, None, :] >= lo[:, None, None]
    return valid


def ragged_paged_partials_reference(q, k_pages, v_pages, page_table, q_lens,
                                    kv_lens, *, k_scales=None,
                                    v_scales=None, scale=None, ctx_lo=None,
                                    window=None):
    """Plain version of the kernel's split-k partials: dequantizes the
    gathered pages, then a masked base-2 softmax in fp32 without the final
    division.  Returns (acc [S,Nq,QT,D], m [S,Nq,QT,1], l [S,Nq,QT,1]);
    rows that see nothing give acc 0, m -inf, l 0.  O(S·n_slots·page)
    memory."""
    s, n_q, qt, d = q.shape
    n_kv, page = k_pages.shape[1], k_pages.shape[2]
    group = n_q // n_kv
    if scale is None:
        scale = d**-0.5
    k = gather_pages(k_pages, k_scales, page_table).float()  # [S,Nkv,T,D]
    v = gather_pages(v_pages, v_scales, page_table).float()
    qg = q.reshape(s, n_kv, group, qt, d).float()
    sc = torch.einsum("bngtd,bnjd->bngtj", qg, k) * (scale * LOG2E)
    valid = _visible(q_lens, kv_lens, qt, k.shape[2], page, ctx_lo,
                     window)[:, None, None]                  # [S,1,1,QT,T]
    sc = sc.masked_fill(~valid, float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp2(sc - torch.where(
        torch.isfinite(m), m, 0.0)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bngtj,bnjd->bngtd", p, v)
    return (acc.reshape(s, n_q, qt, d), m.reshape(s, n_q, qt, 1),
            l.reshape(s, n_q, qt, 1))


def ragged_paged_reference(q, k_pages, v_pages, page_table, q_lens, kv_lens,
                           *, k_scales=None, v_scales=None, scale=None,
                           ctx_lo=None, window=None):
    """Plain version of the kernel: dense-gathers every slot's pages and
    runs the masked softmax with the per-row causal (and window) band.
    Padding rows (t >= q_lens) and idle slots give zeros."""
    acc, _, l = ragged_paged_partials_reference(
        q, k_pages, v_pages, page_table, q_lens, kv_lens, k_scales=k_scales,
        v_scales=v_scales, scale=scale, ctx_lo=ctx_lo, window=window)
    return _normalize(acc, l, q.dtype)


def ragged_paged_attention_grouped(
        q, k_pages, v_pages, page_table, q_lens, kv_lens, *,
        group_id, shared_table, shared_lens, k_scales=None, v_scales=None,
        window=None, scale=None):
    """Shared-prefix grouped variant: score each group's shared pages ONCE,
    log-sum-exp merge with every member's private-suffix partial.

    group_id     [S] int32        group index per slot (group rows whose
                                  shared_lens is 0 leave the plain result)
    shared_table [G, n_sh] int32  pool pages of each group's shared prefix
                                  (page-0 padded past its length)
    shared_lens  [G] int32        shared tokens per group, a page multiple

    Every member's shared pages are a prefix of its own page table, and
    causal masking is per query row, so a query inside the shared band
    sees exactly the positions at or below its own.  A window masks both
    bands per row; a shared prefix wholly below a row's band leaves that
    row's shared partial empty (m = -inf, l = 0), which the merge adds as
    nothing.  The private band is
    the kernel with `ctx_lo` at the shared boundary and emit_partials; the
    shared band and the merge are plain torch in the kernel's base-2
    domain, with the -inf guards of the kernel's alpha rule.  Returns
    [S, Nq, QT, D] in q's dtype — equal to the plain launch up to the
    merge's reassociation."""
    s, n_q, qt, d = q.shape
    n_kv, page = k_pages.shape[1], k_pages.shape[2]
    group = n_q // n_kv
    n_sh = shared_table.shape[1]
    if scale is None:
        scale = d**-0.5
    gid = group_id.long()
    lens = shared_lens[gid]
    acc_p, m_p, l_p = ragged_paged_attention(
        q, k_pages, v_pages, page_table, q_lens, kv_lens, k_scales=k_scales,
        v_scales=v_scales, window=window, scale=scale,
        ctx_lo=lens.to(torch.int32), emit_partials=True)

    # shared band: ONE pool gather per group, then a view per member; the
    # dequant is a column rescale of the scores and of p, as in the kernel
    quant = k_scales is not None
    table = shared_table.long()

    def flat(pages):  # [G, n_sh, Nkv, page, ...] -> [S, Nkv, n_sh*page, ...]
        t = pages[table].movedim(2, 1)
        return t.reshape(t.shape[0], n_kv, n_sh * page, *t.shape[4:])[gid]

    k_s = flat(k_pages).float()
    v_s = flat(v_pages).float()
    qg = q.reshape(s, n_kv, group, qt, d).float() * (scale * LOG2E)
    sc = torch.einsum("bngtd,bnjd->bngtj", qg, k_s)
    if quant:
        sc = sc * flat(k_scales)[:, :, None, None, :]
    qp = (kv_lens - q_lens).long()[:, None] + torch.arange(
        qt, device=q.device)[None, :]                            # [S, QT]
    col = torch.arange(n_sh * page, device=q.device)
    valid = col[None, None, :] <= qp[:, :, None]
    valid &= col[None, None, :] < lens[:, None, None]
    if window is not None:
        valid &= col[None, None, :] > qp[:, :, None] - window
    valid = valid[:, None, None]
    sc = torch.where(valid, sc, float("-inf"))
    m_s = sc.amax(dim=-1, keepdim=True)                       # [S,Nkv,G,QT,1]
    # a row with no shared column keeps m = -inf; subtract 0 there so no
    # -inf - -inf NaN is ever formed
    p = torch.where(valid, torch.exp2(sc - torch.where(
        torch.isfinite(m_s), m_s, 0.0)), 0.0)
    l_s = p.sum(dim=-1, keepdim=True)
    if quant:
        p = p * flat(v_scales)[:, :, None, None, :]
    acc_s = torch.einsum("bngtj,bnjd->bngtd", p, v_s)
    m_s = m_s.reshape(s, n_q, qt, 1)
    l_s = l_s.reshape(s, n_q, qt, 1)
    acc_s = acc_s.reshape(s, n_q, qt, d)

    # split-k merge in base 2, -inf guarded the way the kernel guards its
    # alpha rebase
    m_g = torch.maximum(m_p, m_s)
    a_p = torch.where(m_p >= m_g, 1.0, torch.exp2(m_p - m_g))
    a_s = torch.where(m_s >= m_g, 1.0, torch.exp2(m_s - m_g))
    l_g = l_p * a_p + l_s * a_s
    acc_g = acc_p * a_p + acc_s * a_s
    return _normalize(acc_g, l_g, q.dtype)
