"""Flash attention, forward and backward (port of
burst_attn_tpu/ops/pallas_flash.py).

`flash_fwd` is one online-softmax round with the same contract as
ops/tile.py:tile_fwd; `flash_bwd` is one backward round with the contract
of ops/tile.py:tile_bwd; `flash_attention` is single-device attention as
an autograd function (one `flash_fwd` forward, one `flash_bwd` backward),
which the serving prefill and the training forward call.  For CUDA
tensors the wrappers launch the hand-written kernels in csrc/flash_fwd.cu
and csrc/flash_bwd.cu (or raise): bf16 q runs the forward and both
backward routes (fused, split) on the tensor cores, fp32 q the SIMT fp32
tiles.  For CPU tensors they run the plain versions,
`tile_fwd`/`finalize` and `tile_bwd`.  The TPU kernels' grid
tricks (triangular and band grids, block tuning) have no counterpart: on
Hopper each CTA loops over the tiles from the first its window band meets
up to its causal diagonal (the forward's q tiles over kv chunks, the
backward's kv tiles over the q tiles whose band reaches them).  Both
directions take a sliding `window` and packed-sequence `segments` = (q
ids [B, Sq], kv ids [B, Skv]): a query sees a key only where the ids are
equal, on top of the causal mask and the window.  On a CUDA tensor the
kernels' WIN and SEG instances (template flags) test the band and the ids
in-kernel; their instances without them are the code they were before.
"""

import math

import torch

from . import _build
from .masks import MaskSpec, round_spec
from .tile import finalize, init_state, tile_bwd, tile_fwd

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


def _ptr(t):
    """A tensor's device address for a ctypes argument; None for NULL."""
    return None if t is None else t.data_ptr()


def seg_operands(segments, b, s_q, s_kv, device):
    """The (q ids [B, Sq], kv ids [B, Skv]) of `segments` as the kernels
    take them: int32, contiguous, on `device`; (None, None) without
    segments.  Raises on a shape that does not match."""
    if segments is None:
        return None, None
    q_ids, kv_ids = segments
    out = []
    for name, t, s in (("q ids", q_ids, s_q), ("kv ids", kv_ids, s_kv)):
        if tuple(t.shape) != (b, s):
            raise ValueError(f"segment {name} have shape {tuple(t.shape)}, "
                             f"expected {(b, s)}")
        if t.is_floating_point() or t.is_complex():
            raise ValueError(f"segment {name} must be integers, got "
                             f"{t.dtype}")
        t = t.to(device=device, dtype=torch.int32).contiguous()
        _check_kernel_operand(f"segment {name}", t, device, torch.int32)
        out.append(t)
    return tuple(out)


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
    `window` (>= 1) keeps each row's last `window` visible columns: cols >
    row + offset - window (masks.dense_mask).  `segments` = (q ids [B,
    Sq], kv ids [B, Skv]) integers: a row sees a column only where the
    ids are equal (ops/tile.py:_with_segments); the kernel's SEG
    instance."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
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
        if segments is not None:
            seg_operands(segments, b, s_q, s_kv, q.device)  # shape checks
        m, lse, acc = tile_fwd(q, k, v, m, lse, acc, scale, spec,
                               window=window, segments=segments)
        if emit_o:
            return m, lse, finalize(m, lse, acc, q.dtype)
        return m, lse, acc
    return _flash_fwd_cuda(q, k, v, m, lse, acc, scale, spec, window,
                           emit_o, segments)


flash_fwd.launches = 0
flash_fwd.seg_launches = 0  # the launches of the SEG instances
flash_fwd.win_launches = 0  # the launches of the WIN instances


def _flash_fwd_cuda(q, k, v, m, lse, acc, scale, spec, window, emit_o,
                    segments=None):
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
    q_ids, kv_ids = seg_operands(segments, b, s_q, s_kv, dev)
    m_out = torch.empty((b, n, s_q), dtype=torch.float32, device=dev)
    lse_out = torch.empty((b, n, s_q), dtype=torch.float32, device=dev)
    out = torch.empty(q.shape, dtype=q.dtype if emit_o else torch.float32,
                      device=dev)
    if q.numel() == 0:
        return m_out, lse_out, out
    lib = _build.load("flash_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(m), _ptr(lse),
            _ptr(acc), m_out.data_ptr(), lse_out.data_ptr(), out.data_ptr(),
            _ptr(q_ids), _ptr(kv_ids), b, n, n_kv, s_q, s_kv, d, KERNEL_DTYPES[q.dtype], float(scale),
            int(spec.q_lo), int(spec.q_hi), int(spec.kv_hi),
            int(spec.causal), int(spec.offset),
            0 if window is None else int(window), int(emit_o), stream)
    _build.check(err, "flash_fwd")
    flash_fwd.launches += 1
    flash_fwd.seg_launches += q_ids is not None
    flash_fwd.win_launches += window is not None
    return m_out, lse_out, out


BWD_ROUTES = ("fused", "dq", "dkdv")
BWD_TILE_Q = 64  # q rows per tile in csrc/flash_bwd.cu (BQ)
BWD_TILE_KV = 64  # kv rows per tile in csrc/flash_bwd.cu (BKV)


def bwd_band_nb(bq: int, bkv: int, window: int) -> int:
    """Exact largest number of q tiles (bq rows) whose band can reach one
    kv tile (bkv rows), over the alignments c0 = j * bkv and the causal
    offsets 0 / -1 (pallas_flash.py bwd_band_nb, l.367)."""
    best = 0
    lcm = bq * bkv // math.gcd(bq, bkv)
    for c0 in range(0, lcm, bkv):
        for off in (0, -1):
            imin = (c0 - off) // bq  # the first causal q row's tile
            imax = (c0 + bkv - 1 + window - 1 - off) // bq
            best = max(best, imax - imin + 1)
    return best


def bwd_band_nbq(bq: int, bkv: int, nqb: int, window) -> int:
    """The q-tile count of one kv tile's backward sweep: nqb without a
    window, else at most bwd_band_nb (pallas_flash.py l.1590)."""
    if window is None:
        return nqb
    return min(nqb, bwd_band_nb(bq, bkv, window))


def bwd_route(q_shape, k_shape, *, fused=None, triangular=False,
              window=None) -> str:
    """"fused" or "split": the backward route flash_bwd takes on the card,
    by the JAX package's dispatch (pallas_flash.py l.1872-1886): an
    explicit `fused=False` takes the split pair and `fused=True` the fused
    kernel; otherwise a triangular causal sweep (the wrapped-diagonal
    grid, `triangular` without a window: here every causal CTA already
    starts at the diagonal) takes the fused kernel, and anything else the
    fused kernel only when its sweep is long enough,
    bwd_band_nbq(64, 64, ceil(Sq / 64), window) * group >= 4, the split
    pair otherwise.  The JAX rule's interpret-mode term has no
    counterpart: a CPU tensor runs tile_bwd on either route."""
    if fused is False:
        return "split"
    if fused or (triangular and window is None):
        return "fused"
    group = q_shape[1] // k_shape[1]
    nqb = -(-q_shape[2] // BWD_TILE_Q)
    nbq = bwd_band_nbq(BWD_TILE_Q, BWD_TILE_KV, nqb, window)
    return "fused" if nbq * group >= 4 else "split"


def flash_bwd(do, q, k, v, delta, lse, scale, spec: MaskSpec, *, fused=None,
              triangular=False, window=None, segments=None):
    """One backward round; same contract as ops/tile.py:tile_bwd: returns
    (dq [B,N,Sq,D], dk [B,Nk,Skv,D], dv [B,Nk,Skv,D]) in float32.

    delta = sum(o * do, -1) [B,N,Sq] f32 (computed by the caller); lse is
    the FINAL log-sum-exp [B,N,Sq] f32.  A CUDA tensor launches
    csrc/flash_bwd.cu (bf16 or fp32, D = 128, contiguous) on the route
    `bwd_route` picks from `fused`, `triangular` and the window: the split
    pair (dq kernel, then dk/dv kernel; no atomics) or the fused kernel;
    both are deterministic like the TPU's.  A CPU tensor runs tile_bwd.
    `window` (>= 1) is flash_fwd's band (the kernels' WIN instances: each
    kv tile sweeps only the q tiles whose band reaches it); `segments` =
    (q ids [B, Sq], kv ids [B, Skv]) as flash_fwd's (the kernels' SEG
    instances)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, n, s_q, d = q.shape
    n_kv, s_kv = k.shape[1], k.shape[2]
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(k.shape) != (b, n_kv, s_kv, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if n % n_kv:
        raise ValueError(f"GQA needs Nq % Nk == 0, got {n} % {n_kv}")
    if q.device.type == "cpu":
        if segments is not None:
            seg_operands(segments, b, s_q, s_kv, q.device)  # shape checks
        return tile_bwd(do, q, k, v, delta, lse, scale, spec, window=window,
                        segments=segments)
    split = bwd_route(q.shape, k.shape, fused=fused, triangular=triangular,
                      window=window) == "split"
    return _flash_bwd_cuda(do, q, k, v, delta, lse, scale, spec,
                           split=split, segments=segments, window=window)


flash_bwd.launches = dict.fromkeys(BWD_ROUTES, 0)
flash_bwd.seg_launches = dict.fromkeys(BWD_ROUTES, 0)  # SEG instances
flash_bwd.win_launches = dict.fromkeys(BWD_ROUTES, 0)  # WIN instances


def _flash_bwd_cuda(do, q, k, v, delta, lse, scale, spec, split,
                    segments=None, window=None):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_bwd runs on cuda or cpu tensors, got {dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_bwd kernel takes {list(KERNEL_DTYPES)}, got "
                         f"{q.dtype}")
    b, n, s_q, d = q.shape
    n_kv, s_kv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_bwd kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    for name, t in (("do", do), ("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, t, dev, q.dtype)
    _check_kernel_operand("delta", delta, dev, torch.float32, (b, n, s_q))
    _check_kernel_operand("lse", lse, dev, torch.float32, (b, n, s_q))
    q_ids, kv_ids = seg_operands(segments, b, s_q, s_kv, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dk = torch.empty(k.shape, **f32)
    dv = torch.empty(k.shape, **f32)
    if split:
        dq = torch.empty(q.shape, **f32)
        counters = None
    else:  # the ordered dq fold adds into zeros, counted per q tile;
        # the last word is the CTAs' start-order ticket
        dq = torch.zeros(q.shape, **f32)
        counters = torch.zeros(b * n * -(-s_q // BWD_TILE_Q) + 1,
                               dtype=torch.int32, device=dev)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _build.load("flash_bwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (b, n, n_kv, s_q, s_kv, d, KERNEL_DTYPES[q.dtype], float(scale),
            int(spec.q_lo), int(spec.q_hi), int(spec.kv_hi),
            int(spec.causal), int(spec.offset),
            0 if window is None else int(window), stream)
    routes = ("dq", "dkdv") if split else ("fused",)
    with torch.cuda.device(dev):
        for route in routes:
            err = getattr(lib, f"flash_bwd_{route}_launch")(
                do.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                delta.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _ptr(counters), _ptr(q_ids),
                _ptr(kv_ids), *args)
            _build.check(err, f"flash_bwd {route}")
            flash_bwd.launches[route] += 1
            flash_bwd.seg_launches[route] += q_ids is not None
            flash_bwd.win_launches[route] += window is not None
    return dq, dk, dv


def fwd_attrs(seg: bool = False):
    """_build.kernel_attrs of kernel 1's instances: bf16 (tensor cores;
    with the fused finalize, the raw accumulator, a window), fp32 (SIMT);
    with `seg` their SEG instances (labels end in " seg")."""
    bf16, fp32 = KERNEL_DTYPES[torch.bfloat16], KERNEL_DTYPES[torch.float32]
    add, tag = (4, " seg") if seg else (0, "")
    return _build.kernel_attrs("flash_fwd", {  # flag: emit_o + 2 * window
        f"bf16{tag}": (bf16, 1 + add), f"bf16 acc{tag}": (bf16, add),
        f"bf16 window{tag}": (bf16, 3 + add), f"fp32{tag}": (fp32, 1 + add)})


def bwd_attrs(seg: bool = False, win: bool = False):
    """_build.kernel_attrs of the backward's kernels: the fused kernel
    (kernels 2-3; bf16 on the tensor cores, fp32 SIMT) and the split pair
    (kernels 4-5) in bf16, on the tensor cores; with `seg` their SEG
    instances (labels end in " seg"), with `win` their WIN instances
    (" win" after that)."""
    bf16, fp32 = KERNEL_DTYPES[torch.bfloat16], KERNEL_DTYPES[torch.float32]
    add = (4 if seg else 0) + (8 if win else 0)
    tag = (" seg" if seg else "") + (" win" if win else "")
    return _build.kernel_attrs("flash_bwd", {  # flag: route + 4 seg + 8 win
        f"bf16 fused{tag}": (bf16, add), f"fp32 fused{tag}": (fp32, add),
        f"bf16 dq{tag}": (bf16, 1 + add), f"bf16 dkdv{tag}": (bf16, 2 + add)})


class _FlashAttention(torch.autograd.Function):
    """o = softmax(q k^T * scale) v with the saved (q, k, v, o, lse) and
    the flash backward (pallas_flash.py's custom_vjp, l.2052-2123)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, fused, window, segment_ids):
        spec = round_spec(0, 0, q.shape[2], k.shape[2], causal, "contig")
        segs = None if segment_ids is None else (segment_ids, segment_ids)
        _, lse, o = flash_fwd(q, k, v, None, None, None, scale, spec,
                              window=window, segments=segs, emit_o=True)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.scale, ctx.spec, ctx.fused = scale, spec, fused
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        delta = (o.float() * do.float()).sum(-1)
        segs = None if segment_ids is None else (segment_ids, segment_ids)
        # the tri gate (pallas_flash.py l.1873-1878): a window leaves the
        # wrapped-diagonal grid for the band rule
        dq, dk, dv = flash_bwd(do.contiguous(), q, k, v, delta, lse,
                               ctx.scale, ctx.spec, fused=ctx.fused,
                               triangular=bool(ctx.spec.causal)
                               and ctx.window is None,
                               window=ctx.window, segments=segs)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def flash_attention(q, k, v, scale=None, causal=False, *, fused=None,
                    window=None, segment_ids=None):
    """Single-device flash attention: q [B,N,S,D], k, v [B,Nk,S,D] ->
    o [B,N,S,D] in q's dtype, differentiable.  The forward is one
    `flash_fwd` with an empty carry and the fused finalize (it keeps lse);
    the backward computes delta = sum(o * do) in fp32 and runs one
    `flash_bwd` (`fused` as there: False takes the split pair), then casts
    the gradients to the inputs' dtypes.  Under `torch.no_grad()`
    (serving) only the forward runs.  `window` (causal only) is the
    sliding-window band of both passes (the backward leaves the
    triangular route for bwd_route's band rule).  `segment_ids` [B, S]
    integers pack several
    documents into one row: attention never crosses a segment boundary
    (both passes run the kernels' SEG instances on the card; the ids get
    no gradient)."""
    if window is not None and not causal:
        raise ValueError("window attention requires causal=True")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if segment_ids is not None:
        if q.shape[2] != k.shape[2]:
            raise ValueError("segment_ids cover both sides only when "
                             f"s_q == s_kv, got {q.shape[2]} != "
                             f"{k.shape[2]}")
        segment_ids = seg_operands((segment_ids, segment_ids), q.shape[0],
                                   q.shape[2], k.shape[2], q.device)[0]
    return _FlashAttention.apply(q, k, v, scale, causal, fused, window,
                                 segment_ids)
