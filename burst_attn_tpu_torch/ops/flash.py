"""Flash-attention forward (port of burst_attn_tpu/ops/pallas_flash.py,
forward only).

`flash_fwd` is one online-softmax round with the same contract as
ops/tile.py:tile_fwd; `flash_attention` is the single-device forward the
serving prefill calls.  For CUDA tensors the wrapper launches the
hand-written kernel in csrc/flash_fwd.cu (or raises); for CPU tensors it
runs the plain version, `tile_fwd`/`finalize`.  The TPU kernel's grid
tricks (triangular and band grids, block tuning) have no counterpart: on
Hopper each CTA loops over kv tiles up to its causal diagonal.
"""

import torch

from . import _build
from .masks import MaskSpec, round_spec
from .tile import finalize, init_state, tile_fwd

# dtype codes shared with csrc/common.cuh
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (128,)  # the serving width; others wait for a config


def _check_kernel_operand(name, t, device, dtype=None, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def flash_fwd(q, k, v, m, lse, acc, scale, spec: MaskSpec, *, window=None,
              segments=None, emit_o=False):
    """One online-softmax round; same contract as ops/tile.py:tile_fwd:
    returns updated (m, lse, acc).

    m = lse = acc = None declares a statically empty carry (the state a
    fresh init_state would hold); the kernel then reads no state at all.
    `emit_o=True` returns (m, lse, o) with o = acc / l normalized in q's
    dtype (the fused finalize; empty rows give o = 0, lse = -inf).

    q [B,N,S,D]; k, v [B,Nk,Skv,D] (GQA when Nk < N); m, lse [B,N,S] f32;
    acc [B,N,S,D] f32; lse in the natural-log domain.  `spec` holds host
    ints.  A CUDA tensor launches csrc/flash_fwd.cu (bf16 or fp32, D = 128,
    contiguous); a CPU tensor runs tile_fwd.
    `window`/`segments` are not ported yet."""
    if window is not None or segments is not None:
        raise NotImplementedError("window/segments are not ported yet")
    carry = m is not None
    if not (lse is None) == (acc is None) == (not carry):
        raise ValueError("m, lse, acc must be all None (empty carry) or "
                         "all present")
    b, n, s_q, d = q.shape
    n_kv, s_kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, n_kv, s_kv, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if n % n_kv:
        raise ValueError(f"GQA needs Nq % Nk == 0, got {n} % {n_kv}")
    if q.device.type == "cpu":
        if not carry:
            m, lse, acc = init_state(b, n, s_q, d, device=q.device)
        m, lse, acc = tile_fwd(q, k, v, m, lse, acc, scale, spec)
        if emit_o:
            return m, lse, finalize(m, lse, acc, q.dtype)
        return m, lse, acc
    return _flash_fwd_cuda(q, k, v, m, lse, acc, scale, spec, emit_o)


flash_fwd.launches = 0


def _flash_fwd_cuda(q, k, v, m, lse, acc, scale, spec, emit_o):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu tensors, got {dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_fwd kernel takes {list(KERNEL_DTYPES)}, got "
                         f"{q.dtype}")
    b, n, s_q, d = q.shape
    n_kv, s_kv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    _check_kernel_operand("q", q, dev, q.dtype)
    _check_kernel_operand("k", k, dev, q.dtype)
    _check_kernel_operand("v", v, dev, q.dtype)
    if m is not None:
        _check_kernel_operand("m", m, dev, torch.float32, (b, n, s_q))
        _check_kernel_operand("lse", lse, dev, torch.float32, (b, n, s_q))
        _check_kernel_operand("acc", acc, dev, torch.float32, q.shape)
    m_out = torch.empty((b, n, s_q), dtype=torch.float32, device=dev)
    lse_out = torch.empty((b, n, s_q), dtype=torch.float32, device=dev)
    out = torch.empty(q.shape, dtype=q.dtype if emit_o else torch.float32,
                      device=dev)
    if q.numel() == 0:
        return m_out, lse_out, out
    lib = _build.load("flash_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(m), ptr(lse),
            ptr(acc), m_out.data_ptr(), lse_out.data_ptr(), out.data_ptr(),
            b, n, n_kv, s_q, s_kv, d, KERNEL_DTYPES[q.dtype], float(scale),
            int(spec.q_lo), int(spec.q_hi), int(spec.kv_hi),
            int(spec.causal), int(spec.offset), int(emit_o), stream)
    _build.check(err, "flash_fwd")
    flash_fwd.launches += 1
    return m_out, lse_out, out


def flash_attention(q, k, v, scale=None, causal=False):
    """Single-device flash attention, forward only: q,k,v [B,N,S,D] ->
    o [B,N,S,D] in q's dtype.  One `flash_fwd` with an empty carry and the
    fused finalize (no gradient in this slice)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    spec = round_spec(0, 0, q.shape[2], k.shape[2], causal, "contig")
    _, _, o = flash_fwd(q, k, v, None, None, None, scale, spec, emit_o=True)
    return o
