"""Burst (ring) attention, forward and backward (port of
burst_attn_tpu/parallel/burst.py).

W ring positions share one device (parallel/mesh.py): the global
[B, N, S, D] tensors, in layout order, are sharded along S into W
positions (partition id = inter_rank * n_intra + intra_rank), and every
position runs the same per-position program:

  * the scan ring (`_fwd_impl`): round 0 peeled with an empty carry, then
    one online-softmax round per ring round through the tile backend
    (kernel 1, csrc/flash_fwd.cu, for "auto" / "pallas" on a CUDA tensor;
    the plain tile for "jnp"), the KV payload rotated between the rounds
    by copies between the positions' buffers (mesh.ppermute); the double
    ring prefetches the next cycle's base over the inter axis one full
    intra cycle early;
  * the fused ring (`backend="fused_ring"`): the whole ring of every
    position in one launch of kernel 8 (ops/fused_ring.py).  A config the
    fused kernel declines takes the scan ring, with the reason logged and
    counted (`burst.fused_fallback`).

The backward (`_bwd_impl`, the one backward dispatch point, behind the
autograd Function of `burst_attn`) is the communication-optimized one:
K and V stay resident, the q-side bundle (delta, do, q, lse) -- or (o,
do, q, lse) without `optimize_bwd_comm` -- rotates like the forward's
KV, and dq rides an accumulating ring one hop behind it, returned home
by the final hops.  Its scan ring runs the flash backward kernels per
round (kernels 2/3, csrc/flash_bwd.cu; the plain tile_bwd for "jnp" or on
a CPU tensor); with `backend="fused_ring"` the whole backward ring is one
launch of kernel 9 (ops/fused_ring_bwd.py) when the backward gate admits
the config.

Causal load balancing uses the per-round mask scalars of ops/masks.py.
The JAX package's zigzag 3-way case split (full q x first kv half, second
q half x full kv, causal self round) and striped triangular rounds exist
there to pick TPU grids; their three specs are exactly round_spec's, and
the CUDA kernels' loop bounds skip the dead tiles of each, so here every
round runs its kernel on the whole contiguous shard under round_spec
(no slicing copies).  Contig causal rings skip dead rounds outright
(spec_live) and, with a window or max_segment_len, truncate to the live
prefix.

Sliding window (`window`, contig causal rings only, as in the JAX
package): every round is the band j <= i + delta, delta = (q_part -
kv_part) * s (masks.round_spec with the window), and each round's kernel
takes the window beside its spec (kernel 1's and kernels 2-5's WIN
instances on the scan ring, kernels 8-9's on the fused one).  A round the
band cannot reach is skipped (spec_live with the window), and a single
ring runs only its live prefix of r_live = min(W, (s + window - 2) // s +
1) rounds: no rotation and no launch for the others.

Counters: the obs registry's burst.dispatch{path,backend,tile},
burst.fused_fallback{reason,pass}, burst.ring_rounds,
burst.ring_hops{axis} and burst.wire_bytes{pass,dir} (the JAX package's
instruments and labels), advanced at each forward and each backward
dispatch: the port runs eagerly, so a count is a call, not a compile.

`collect_stats=True` returns `(o, obs.DevStats)` (leading axis = ring
position): the scan ring tallies each round's liveness and attended
pairs from the host mask scalars it already holds and reduces the final
state on the device (no host synchronization in the round loop); the
fused route takes kernel 8's in-kernel slot counters.  o and the
gradients are bitwise those of collect_stats=False.  The tallies come
from the mask scalars alone: segment occupancy is not counted, as in the
JAX package.

Packed documents (`segment_ids` [B, S], layout order, sharded like q):
on the scan ring the kv-side ids ride the forward's KV rotation and the
q-side ids the backward's bundle, and each round's kernel gets the
round's (q ids, kv ids) pair (the SEG instances of kernels 1-3); the
fused ring kernels read every position's ids from one stacked [W, B, S]
table, the row of the partition a round consumes.

Wire precision (`wire_dtype` "int8" | "fp8"): the ROTATING payloads
travel quantized with per-block fp32 scales (parallel/ring.wire_quantize),
as in the JAX package.  The scan ring quantizes each position's K and V
once at ring entry per (batch, kv head) and dequantizes every round's
arrival to the compute dtype (the self round reads the resident
full-precision K and V); the backward quantizes the q-side bundle once
per (batch, head) (delta over s under optimize_bwd_comm, o over s and d
otherwise; lse stays fp32), and each dq hop re-quantizes the fp32 partial
with a refreshed per-(batch, head) scale and dequantizes it on arrival:
the folds stay fp32.  The fused route runs kernels 8-9's wire instances
(ops/fused_ring.py, ops/fused_ring_bwd.py).  `collect_stats` reports the
largest |k|, |v| a position quantized (quant_absmax).

Not ported yet (they raise NotImplementedError): the tile sizes of the
flash kernels (block_q, block_kv and the backward's), and meshes with
data or tensor parallel axes of size > 1.
"""

import logging
from dataclasses import dataclass, fields
from typing import Optional, Tuple

import torch

from .. import obs
from ..obs import devstats
from ..ops import fused_ring, fused_ring_bwd
from ..ops.flash import flash_bwd, flash_fwd
from ..ops.masks import (
    LAYOUTS, check_window, live_round_prefix, round_spec, spec_live,
    spec_pair_count,
)
from ..ops.tile import finalize, init_state, tile_bwd, tile_fwd
from . import schedule as sched_ir
from .mesh import as_mesh, ppermute, shard, unshard
from .ring import (
    partition_at_round, ring_coords, ring_round_counts, wire_dequantize,
    wire_quantize,
)

logger = logging.getLogger("burst_attn_tpu_torch")

BACKENDS = ("auto", "jnp", "pallas", "fused_ring")

# dispatch instruments (the JAX package's names; host code only, never
# inside a captured CUDA graph)
_M_DISPATCH = obs.counter(
    "burst.dispatch", "ring dispatches by path (fused kernel vs scan ring)")
_M_FALLBACK = obs.counter(
    "burst.fused_fallback", "fused_ring dispatches declined, by reason")
_M_ROUNDS = obs.counter(
    "burst.ring_rounds", "scheduled ring rounds (incl. the self round)")
_M_HOPS = obs.counter(
    "burst.ring_hops", "scheduled KV ring hops, by mesh axis role")
_M_WIRE = obs.counter(
    "burst.wire_bytes",
    "scheduled ring payload bytes per round by pass and stream "
    "(parallel/schedule.wire_round_bytes)")


@dataclass(frozen=True)
class BurstConfig:
    """Static configuration of burst attention: the JAX BurstConfig's
    fields, so both packages take the same configurations.  A field the
    port does not honour raises NotImplementedError on any value but its
    default (_UNPORTED): the flash kernels' tile sizes are fixed.
    `case_split` takes both values: the zigzag split only picks TPU
    grids, and here every round runs round_spec's uniform spec with the
    dead tiles skipped by the kernel's loop bounds, which is what either
    value computes.  `deterministic` takes both values and changes
    nothing, as in the JAX package: both backward routes of the port are
    deterministic (the dq folds run in a fixed order)."""

    causal: bool = False
    layout: str = "zigzag"  # "zigzag" | "striped" | "contig"
    scale: Optional[float] = None  # default 1/sqrt(head_dim)
    intra_axis: str = "sp"
    inter_axis: Optional[str] = None  # set for the hierarchical double ring
    backend: str = "jnp"  # "auto" | "jnp" | "pallas" | "fused_ring"
    optimize_bwd_comm: bool = True
    block_q: Optional[int] = None
    block_kv: Optional[int] = None
    block_q_bwd: Optional[int] = None
    block_kv_bwd: Optional[int] = None
    deterministic: bool = True
    window: Optional[int] = None
    # a PROMISE that no packed segment spans more than this many tokens:
    # contig causal single rings truncate to the rounds it can reach
    max_segment_len: Optional[int] = None
    wire_dtype: Optional[str] = None
    fused_kv_slots: Optional[int] = None
    fused_block_q: Optional[int] = None
    fused_block_kv: Optional[int] = None
    fused_bwd_slots: Optional[int] = None
    fused_block_q_bwd: Optional[int] = None
    fused_block_kv_bwd: Optional[int] = None
    fused_topology: str = "auto"  # "auto" | "uni" | "bidi" | "double"
    fused_seq_factor: Optional[Tuple[int, int]] = None  # (n_inter, n_intra)
    fused_ccw_slots: Optional[int] = None
    fused_bwd_ccw_slots: Optional[int] = None
    mesh_axes: Optional[Tuple[Tuple[str, int], ...]] = None
    case_split: bool = True

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r}; expected one "
                             f"of {LAYOUTS}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{self.backend!r}")
        check_window(self.window, self.layout, self.causal)
        for name, why in _UNPORTED.items():
            if getattr(self, name) != _DEFAULTS[name]:
                raise NotImplementedError(
                    f"BurstConfig.{name}={getattr(self, name)!r}: {why}")
        if self.max_segment_len is not None and self.max_segment_len < 1:
            raise ValueError(
                f"max_segment_len must be >= 1, got {self.max_segment_len}")
        if self.wire_dtype not in (None, "int8", "fp8"):
            raise ValueError(
                f"wire_dtype must be None, 'int8' or 'fp8', got "
                f"{self.wire_dtype!r}")
        if self.fused_topology not in ("auto", "uni", "bidi", "double"):
            raise ValueError(
                f"fused_topology must be auto|uni|bidi|double, got "
                f"{self.fused_topology!r}")
        if self.fused_seq_factor is not None:
            f = tuple(self.fused_seq_factor)
            if len(f) != 2 or any(x < 1 for x in f):
                raise ValueError(
                    f"fused_seq_factor must be (n_inter, n_intra) positive "
                    f"ints, got {self.fused_seq_factor!r}")
            object.__setattr__(self, "fused_seq_factor", f)
        if self.mesh_axes is not None:
            object.__setattr__(self, "mesh_axes",
                               tuple((str(a), int(sz))
                                     for a, sz in self.mesh_axes))


_TILES_FIXED = ("the flash kernels' tiles are fixed (ops/tuning.py); "
                "leave it None")
# fields the port does not honour -> why; each raises on a value other
# than its default
_UNPORTED = dict(
    block_q=_TILES_FIXED, block_kv=_TILES_FIXED, block_q_bwd=_TILES_FIXED,
    block_kv_bwd=_TILES_FIXED, fused_block_q_bwd=_TILES_FIXED,
    fused_block_kv_bwd=_TILES_FIXED)
_DEFAULTS = {f.name: f.default for f in fields(BurstConfig)}


# ---------------------------------------------------------------------------
# tile dispatch


def _tile_backend(cfg) -> str:
    """Per-round tile backend: "jnp" is the plain tile; "auto", "pallas"
    and the scan-ring rounds of a "fused_ring" config take flash_fwd
    (kernel 1 on a CUDA tensor, its plain version on a CPU tensor)."""
    return "jnp" if cfg.backend == "jnp" else "pallas"


def _tile_fwd(cfg, q, k, v, m, lse, acc, scale, spec, segments=None):
    if _tile_backend(cfg) == "pallas":
        return flash_fwd(q, k, v, m, lse, acc, scale, spec,
                         window=cfg.window, segments=segments)
    if m is None:
        m, lse, acc = init_state(*q.shape, device=q.device)
    return tile_fwd(q, k, v, m, lse, acc, scale, spec, window=cfg.window,
                    segments=segments)


def _tile_bwd(cfg, do, q, k, v, delta, lse, scale, spec, segments=None):
    """One backward round: flash_bwd (on a CUDA tensor the route
    flash.bwd_route picks, tile_bwd on a CPU tensor) or, for "jnp", the
    plain tile."""
    if _tile_backend(cfg) == "pallas":
        return flash_bwd(do, q, k, v, delta, lse, scale, spec,
                         window=cfg.window, segments=segments)
    return tile_bwd(do, q, k, v, delta, lse, scale, spec, window=cfg.window,
                    segments=segments)


def _r_live(cfg, s, s_kv, n_inter, n_intra):
    """Live-round count of a truncatable SINGLE contig causal ring (the
    window band and the max_segment_len reach bound give a live-round
    prefix, masks.live_round_prefix: windowed rings reproduce the closed
    form min(W, (s + window - 2) // s + 1)); shared by the forward and the
    backward; n_intra = no truncation."""
    if ((cfg.window is not None or cfg.max_segment_len is not None)
            and cfg.layout == "contig" and cfg.causal and n_inter == 1
            and n_intra > 1 and s_kv == s):
        return live_round_prefix("contig", s, n_intra, causal=True,
                                 window=cfg.window,
                                 max_segment_len=cfg.max_segment_len)
    return n_intra


# ---------------------------------------------------------------------------
# counters

# (reason-string prefix -> bounded label) for burst.fused_fallback
_FALLBACK_LABELS = (
    ("cross-attention", "cross-attn"),
    ("world < 2", "world-lt-2"),
    ("topology config invalid", "topology-invalid"),
    ("schedule compiler declined", "schedule-compiler"),
    ("shared-memory plan", "smem-budget"),
    ("head dim", "head-dim"),
    ("dtype", "dtype"),
)


def _fallback_label(reason: str) -> str:
    for prefix, label in _FALLBACK_LABELS:
        if reason.startswith(prefix):
            return label
    return "other"


def _note_dispatch(cfg, reason, q_shape, k_shape, n_inter, n_intra,
                   pass_: str = "fwd") -> None:
    """Count one ring dispatch of pass_ ("fwd" | "bwd"): the path it took
    (fused kernel or scan ring), a declined fused config's reason, the
    schedule's rounds and payload hops per axis (ring_round_counts; the
    backward's bundle moves as the forward's KV does) and the pass's
    per-round payload bytes (schedule.wire_round_bytes at the JAX
    package's fp32 width).  Shapes are per position."""
    path = "fused" if cfg.backend == "fused_ring" and reason is None \
        else "scan"
    _M_DISPATCH.inc(path=path, backend=cfg.backend, tile=_tile_backend(cfg))
    if reason is not None:
        _M_FALLBACK.inc(reason=_fallback_label(reason), **{"pass": pass_})
    b, n, s, d = q_shape
    rounds, intra_hops, inter_hops = ring_round_counts(
        n_inter, n_intra, _r_live(cfg, s, k_shape[2], n_inter, n_intra))
    _M_ROUNDS.inc(rounds)
    if intra_hops:
        _M_HOPS.inc(intra_hops, axis="intra")
    if inter_hops:
        _M_HOPS.inc(inter_hops, axis="inter")
    per_round = sched_ir.wire_round_bytes(
        pass_, cfg.wire_dtype, b=b, n=n, n_kv=k_shape[1], s=s, d=d,
        opt_comm=cfg.optimize_bwd_comm)
    for stream, nbytes in per_round.items():
        _M_WIRE.inc(nbytes, **{"pass": pass_, "dir": stream})


def _dispatch(cfg, q, k, n_inter: int, n_intra: int, pass_: str):
    """The fused gate's reason for declining pass_ (None: the fused kernel
    runs; also None for a scan backend), logged and counted with the
    dispatch."""
    reason = None
    if cfg.backend == "fused_ring":
        reason = fused_ring.supported(cfg, q.shape[1:], k.shape[1:],
                                      world=n_intra, n_inter=n_inter,
                                      pass_=pass_, dtype=q.dtype,
                                      device=q.device)
        if reason is not None:
            logger.info("fused_ring %s falling back to the scan ring: %s",
                        "backend" if pass_ == "fwd" else "backward", reason)
    _note_dispatch(cfg, reason, tuple(q.shape[1:]), tuple(k.shape[1:]),
                   n_inter, n_intra, pass_)
    return reason


# ---------------------------------------------------------------------------
# forward


def _fwd_impl(q, k, v, cfg: BurstConfig, n_inter: int, n_intra: int,
              collect: bool = False, seg=None):
    """Ring forward of every position: q [W,B,N,S,D], k/v [W,B,Nk,Skv,D]
    stacked shards (position p at index p) -> (o [W,B,N,S,D] in q.dtype,
    lse [W,B,N,S] f32), plus the ring's DevStats (leading axis W) when
    `collect`.  Every stats step sits behind `if collect` and only reads
    the ring's state, so o and lse are bitwise the collect=False ones.
    `seg`: the positions' segment ids [W,B,S] int32 (or None); the kv
    side's ride the KV rotation."""
    world = n_inter * n_intra
    b, n, s, d = q.shape[1:]
    s_kv = k.shape[3]
    reason = _dispatch(cfg, q, k, n_inter, n_intra, "fwd")
    if cfg.backend == "fused_ring" and reason is None:
        return fused_ring.fused_ring_fwd(q, k, v, cfg, n_inter, n_intra,
                                         collect_stats=collect, seg=seg)

    scale = cfg.scale if cfg.scale is not None else d ** -0.5
    coords = [ring_coords(p, n_inter, n_intra) for p in range(world)]
    wire = cfg.wire_dtype
    # devstats (collect only): per position [rounds, live rounds, pairs],
    # host ints from the round's mask scalars (the spec the kernels run)
    tally = [[0, 0, 0] for _ in range(world)]

    def count(p, spec):
        if collect:
            tally[p][0] += 1
            tally[p][1] += spec_live(spec, cfg.window)
            tally[p][2] += spec_pair_count(spec, s, s_kv, window=cfg.window)

    def compute(p, st, kv_c, r):
        kv_part = partition_at_round(r, *coords[p], n_inter, n_intra)
        spec = round_spec(p, kv_part, s, s_kv, cfg.causal, cfg.layout,
                          window=cfg.window)
        count(p, spec)
        if (cfg.layout == "contig" and cfg.causal
                and not spec_live(spec, cfg.window)):
            # a future round, or one past the band's reach: nothing
            # attends, skip the launch
            return st
        if wire is not None:
            # rescale on consume: the arrival goes back to the compute
            # dtype before any tile math
            kv_c = (wire_dequantize(kv_c[0], kv_c[1], k.dtype),
                    wire_dequantize(kv_c[2], kv_c[3], v.dtype)) + kv_c[4:]
        segs = None if seg is None else (seg[p], kv_c[2])
        return _tile_fwd(cfg, q[p], kv_c[0], kv_c[1], *st, scale, spec,
                         segs)

    def compute_all(states, kv, r):
        return [compute(p, states[p], kv[p], r) for p in range(world)]

    r_live = _r_live(cfg, s, s_kv, n_inter, n_intra)
    # the KV payload, with the kv side's segment ids riding along; under
    # a wire dtype quantized ONCE at ring entry per (batch, kv head): the
    # payload rotates unchanged, so that is quantize-on-send at every hop
    if wire is None:
        kv = [(k[p], v[p]) + (() if seg is None else (seg[p],))
              for p in range(world)]
    else:
        kq, ksc = wire_quantize(k, wire, (3, 4))
        vq, vsc = wire_quantize(v, wire, (3, 4))
        kv = [(kq[p], ksc[p], vq[p], vsc[p])
              + (() if seg is None else (seg[p],)) for p in range(world)]
    kv_base = kv
    # round 0 is always the self round: a statically empty carry
    spec0 = [round_spec(p, p, s, s_kv, cfg.causal, cfg.layout,
                        window=cfg.window) for p in range(world)]
    for p in range(world):
        count(p, spec0[p])
    state = [_tile_fwd(cfg, q[p], k[p], v[p], None, None, None, scale,
                       spec0[p], None if seg is None else (seg[p], seg[p]))
             for p in range(world)]
    for c in range(n_inter):
        if c < n_inter - 1:
            # prefetch the next cycle's base one full intra cycle early
            kv_base_next = ppermute(kv_base, "inter", n_inter, n_intra)
        start = 1 if c == 0 else 0  # cycle 0's round 0 was peeled above
        if not (c == 0 and r_live == 1):
            if c == 0:
                kv = ppermute(kv, "intra", n_inter, n_intra)
            for s_idx in range(start, r_live - 1):
                kv_next = ppermute(kv, "intra", n_inter, n_intra)
                state = compute_all(state, kv, c * n_intra + s_idx)
                kv = kv_next
            # last round of the cycle: no intra send
            state = compute_all(state, kv, c * n_intra + r_live - 1)
        if c < n_inter - 1:
            kv = kv_base = kv_base_next
    o = torch.stack([finalize(*st, q.dtype) for st in state])
    lse = torch.stack([st[1] for st in state])
    if not collect:
        return o, lse
    rounds, live, pairs = (list(col) for col in zip(*tally))
    stats = devstats.ring_stats_all(
        rounds=rounds, rounds_live=live, attn_pairs=pairs,
        total_pairs=[r * s * s_kv for r in rounds], head_dim=d,
        rounds_elided=[world - r for r in rounds],
        m=torch.stack([st[0] for st in state]), lse=lse,
        acc=[st[2] for st in state], quant_absmax=quant_absmax(k, v, wire))
    return o, lse, stats


def quant_absmax(k, v, wire):
    """Per position, the largest |value| the wire quantizer maps to its
    top code: max(|k|, |v|) of each stacked shard [W, ...] (fp32 [W] on
    the device), or 0.0 for a dense wire."""
    if wire is None:
        return 0.0
    return torch.maximum(k.detach().float().abs().flatten(1).amax(1),
                         v.detach().float().abs().flatten(1).amax(1))


# ---------------------------------------------------------------------------
# backward


def _bwd_impl(q, k, v, o, lse, do, cfg: BurstConfig, n_inter: int,
              n_intra: int, seg=None):
    """Communication-optimized ring backward of every position (stacked
    shards as _fwd_impl's; o, do [W,B,N,S,D], lse [W,B,N,S] f32 the
    forward's) -> fp32 (dq, dk, dv) stacked.

    K, V stay resident; the q-side payload (delta|o, do, q, lse) rotates
    like KV did in forward, the q side's segment ids `seg` [W,B,S] with
    it (the kv ids stay resident); dq rides a concurrent accumulating
    ring and is returned home by the final hops.  The ONE backward
    dispatch point: with backend="fused_ring" both rotating streams run
    inside kernel 9 (ops/fused_ring_bwd.py) when the backward gate admits
    the config; declined configs fall through to the scan ring below."""
    reason = _dispatch(cfg, q, k, n_inter, n_intra, "bwd")
    if cfg.backend == "fused_ring" and reason is None:
        return fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, do, cfg,
                                             n_inter, n_intra, seg=seg)

    world = n_inter * n_intra
    b, n, s, d = q.shape[1:]
    s_kv = k.shape[3]
    scale = cfg.scale if cfg.scale is not None else d ** -0.5
    coords = [ring_coords(p, n_inter, n_intra) for p in range(world)]
    # optimize_bwd_comm: the ring payload (delta, not o) shrinks by a
    # factor of head_dim
    first = (o.float() * do.float()).sum(-1) if cfg.optimize_bwd_comm else o
    wire = cfg.wire_dtype
    if wire is None:
        payload = [(first[p], do[p], q[p], lse[p])
                   + (() if seg is None else (seg[p],)) for p in range(world)]
    else:
        # the q-side bundle quantized once at ring entry (it rotates
        # unchanged) per (batch, head); lse stays fp32
        fq, fsc = wire_quantize(first, wire,
                                (3,) if cfg.optimize_bwd_comm else (3, 4))
        doq, dosc = wire_quantize(do, wire, (3, 4))
        qq, qsc = wire_quantize(q, wire, (3, 4))
        payload = [(fq[p], fsc[p], doq[p], dosc[p], qq[p], qsc[p], lse[p])
                   + (() if seg is None else (seg[p],)) for p in range(world)]

    def unpack(pay):
        """(first, do, q, lse, q ids or None) of a payload, dequantized
        to the dense ring's dtypes under a wire dtype."""
        if wire is None:
            return pay[:4] + (pay[4] if seg is not None else None,)
        return (wire_dequantize(pay[0], pay[1], torch.float32
                                if cfg.optimize_bwd_comm else o.dtype),
                wire_dequantize(pay[2], pay[3], do.dtype),
                wire_dequantize(pay[4], pay[5], q.dtype), pay[6],
                pay[7] if seg is not None else None)

    def compute(p, pay, r):
        """(dq, dk, dv) of position p's round r: the rotated q side
        against the resident k/v (roles flip against the forward)."""
        first_r, do_r, q_r, lse_r, qseg_r = unpack(pay)
        delta_r = first_r if cfg.optimize_bwd_comm else (
            first_r.float() * do_r.float()).sum(-1)
        q_part = partition_at_round(r, *coords[p], n_inter, n_intra)
        spec = round_spec(q_part, p, s, s_kv, cfg.causal, cfg.layout,
                          window=cfg.window)
        if (cfg.layout == "contig" and cfg.causal
                and not spec_live(spec, cfg.window)):
            return None  # a dead round: exact zeros, no launch
        segs = None if seg is None else (qseg_r, seg[p])
        return _tile_bwd(cfg, do_r, q_r, k[p], v[p], delta_r, lse_r, scale,
                         spec, segs)

    f32 = dict(dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, **f32)
    dv = torch.zeros(v.shape, **f32)
    dq_intra = [torch.zeros(q.shape[1:], **f32) for _ in range(world)]
    dq_inter = [torch.zeros(q.shape[1:], **f32) for _ in range(world)]

    def fold(dq_acc, pays, r):
        """Every position's round r: dk, dv accumulate in place; returns
        the dq accumulators with this round's contributions added."""
        out = []
        for p in range(world):
            got = compute(p, pays[p], r)
            if got is None:
                out.append(dq_acc[p])
                continue
            dk[p] += got[1]
            dv[p] += got[2]
            out.append(dq_acc[p] + got[0])
        return out

    def hop(dqs, axis):
        """One dq hop; under a wire dtype quantize-before-send with a
        refreshed per-(batch, head) scale (the partial grew since the
        last hop) and dequantize-after-receive to fp32."""
        if wire is None:
            return [t for (t,) in ppermute([(x,) for x in dqs], axis,
                                           n_inter, n_intra, cls="dq")]
        sent = [wire_quantize(x, wire, (2, 3)) for x in dqs]
        return [wire_dequantize(g, sc, torch.float32) for g, sc in
                ppermute(sent, axis, n_inter, n_intra, cls="dq")]

    # Static round truncation, bwd roles: with the q side rotating, round
    # r's q part is me - r, so a truncated contig ring's LIVE rounds are
    # round 0 plus a tail of r_live - 1 rounds at the end of the schedule;
    # the payload jumps the dead middle in ONE rotation.  Round 0's dq (the
    # own chunk's gradient) does not ride along at all: it is held out in
    # dq_home and folded in after the ring's return-home hop.
    r_live = _r_live(cfg, s, s_kv, n_inter, n_intra)
    truncated = r_live < n_intra
    dq_home = None
    pay_base = payload
    for c in range(n_inter):
        if c < n_inter - 1:
            # prefetch the next cycle's base one full intra cycle early
            pay_base_next = ppermute(pay_base, "inter", n_inter, n_intra)
        if c > 0:
            # cycle boundary: fold the intra accumulator into the inter
            # ring's running sum, hop it, and restart the intra ring
            dq_inter = hop([a + b_ for a, b_ in zip(dq_inter, dq_intra)],
                           "inter")
            dq_intra = [torch.zeros_like(x) for x in dq_intra]
        # first round of the cycle: no dq rotation
        if truncated:
            dq_home = fold([torch.zeros_like(x) for x in dq_intra], payload,
                           c * n_intra)
        else:
            dq_intra = fold(dq_intra, payload, c * n_intra)
        if r_live > 1:
            # start == 1 without truncation: the jump is a single hop
            start = n_intra - (r_live - 1)
            payload = ppermute(payload, "intra", n_inter, n_intra, start)
            for s_idx in range(start, n_intra - 1):
                pay_next = ppermute(payload, "intra", n_inter, n_intra)
                # dq leaves with the payload it accumulated for; the
                # arriving dq belongs to the payload held this round
                dq_intra = fold(hop(dq_intra, "intra"), payload,
                                c * n_intra + s_idx)
                payload = pay_next
            # last round of the cycle: rotate dq but not the payload
            dq_intra = fold(hop(dq_intra, "intra"), payload,
                            c * n_intra + n_intra - 1)
        if c < n_inter - 1:
            payload = pay_base = pay_base_next
    # final return-home hops: fold, one inter hop, one intra hop; then the
    # held-out round-0 dq (truncated rings only: it never travelled)
    dq = [a + b_ for a, b_ in zip(dq_inter, dq_intra)]
    if n_inter > 1:
        dq = hop(dq, "inter")
    if r_live > 1:
        dq = hop(dq, "intra")
    if dq_home is not None:
        dq = [a + b_ for a, b_ in zip(dq, dq_home)]
    return torch.stack(dq), dk, dv


class _BurstAttn(torch.autograd.Function):
    """o = burst_attn(q, k, v) on global tensors with the saved stacked
    (q, k, v, o, lse) and the ring backward (the JAX package's custom_vjp,
    _vjp_fwd / _vjp_bwd).  `stats_out`: None, or a list the forward's
    DevStats is appended to (telemetry, outside the graph: the backward
    is the same either way)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, n_inter, n_intra, stats_out=None,
                seg=None):
        world = n_inter * n_intra
        qs, ks, vs = (shard(t, world) for t in (q, k, v))
        out = _fwd_impl(qs, ks, vs, cfg, n_inter, n_intra,
                        collect=stats_out is not None, seg=seg)
        o, lse = out[:2]
        if stats_out is not None:
            stats_out.append(out[2])
        ctx.save_for_backward(qs, ks, vs, o, lse, seg)
        ctx.cfg, ctx.ring = cfg, (n_inter, n_intra)
        return unshard(o)

    @staticmethod
    def backward(ctx, do):
        qs, ks, vs, o, lse, seg = ctx.saved_tensors
        n_inter, n_intra = ctx.ring
        dq, dk, dv = _bwd_impl(qs, ks, vs, o, lse,
                               shard(do.to(qs.dtype), n_inter * n_intra),
                               ctx.cfg, n_inter, n_intra, seg=seg)
        return (unshard(dq).to(qs.dtype), unshard(dk).to(ks.dtype),
                unshard(dv).to(vs.dtype), None, None, None, None, None)


# ---------------------------------------------------------------------------
# global-tensor entry points


def burst_attn(
    q,
    k,
    v,
    *,
    mesh,
    seq_axes=("sp",),
    causal: bool = False,
    layout: str = "zigzag",
    scale: Optional[float] = None,
    backend: str = "auto",
    optimize_bwd_comm: bool = True,
    block_q: Optional[int] = None,
    block_kv: Optional[int] = None,
    block_q_bwd: Optional[int] = None,
    block_kv_bwd: Optional[int] = None,
    batch_axes=None,
    head_axes=None,
    case_split: bool = True,
    window: Optional[int] = None,
    segment_ids=None,
    max_segment_len: Optional[int] = None,
    fused_kv_slots: Optional[int] = None,
    fused_block_q: Optional[int] = None,
    fused_block_kv: Optional[int] = None,
    fused_bwd_slots: Optional[int] = None,
    fused_block_q_bwd: Optional[int] = None,
    fused_block_kv_bwd: Optional[int] = None,
    fused_topology: str = "auto",
    fused_seq_factor: Optional[Tuple[int, int]] = None,
    fused_ccw_slots: Optional[int] = None,
    fused_bwd_ccw_slots: Optional[int] = None,
    wire_dtype: Optional[str] = None,
    collect_stats: bool = False,
):
    """Burst attention on global tensors q [B, N, S, D], k, v [B, Nk, Skv,
    D] (GQA when Nk < N); S must already be in layout order
    (parallel/layouts.to_layout) for causal runs.  Returns o [B, N, S, D]
    in q's dtype.

    mesh: {axis: size} or a parallel.mesh.Mesh; its ring positions share
    the tensors' device.  seq_axes: ("sp",) for a single ring or
    ("inter", "intra") for the hierarchical double ring.  backend: "auto"
    / "pallas" (kernel 1 per round on a CUDA tensor), "jnp" (the plain
    tile), "fused_ring" (kernel 8, the whole ring in one launch).  Skv !=
    S is cross-attention, non-causal only.

    Differentiable: with grad enabled and an input that requires grad,
    the backward runs the ring backward (`_bwd_impl`: the scan ring over
    the flash backward kernels, or kernel 9 for "fused_ring") and returns
    gradients in the inputs' dtypes.  collect_stats: return `(o,
    obs.DevStats)` (leading axis = ring position); publish the stats with
    `stats.publish()` after the step.  o and the gradients through it are
    bitwise those of collect_stats=False.  segment_ids: [B, S] integer
    packed-sequence ids (non-negative, in the same layout order as q;
    sharded like q): attention never crosses a segment boundary, on both
    routes and in the backward.  window: the sliding-window band (contig
    causal only, >= 1; both routes, both passes, the single ring truncated
    to its live rounds).  wire_dtype: "int8" | "fp8" quantizes the
    rotating ring payloads (both routes, both passes); None, the default
    (as the JAX table's fused_wire_dtype), keeps the dense wire.  The tile
    sizes away from their defaults raise (BurstConfig)."""
    if isinstance(seq_axes, str):
        seq_axes = (seq_axes,)
    if len(seq_axes) == 1:
        inter_axis, intra_axis = None, seq_axes[0]
    elif len(seq_axes) == 2:
        inter_axis, intra_axis = seq_axes
    else:
        raise ValueError(f"seq_axes must have 1 or 2 names, got {seq_axes}")
    if q.shape[2] != k.shape[2] and (causal or segment_ids is not None):
        raise ValueError(
            f"cross-attention (s_q {q.shape[2]} != s_kv {k.shape[2]}) "
            "supports non-causal attention without segment_ids only")
    m = as_mesh(mesh, q.device)
    n_inter, n_intra = m.ring(seq_axes)
    cfg = BurstConfig(
        causal=causal, layout=layout, scale=scale, intra_axis=intra_axis,
        inter_axis=inter_axis, backend=backend,
        optimize_bwd_comm=optimize_bwd_comm, block_q=block_q,
        block_kv=block_kv, block_q_bwd=block_q_bwd,
        block_kv_bwd=block_kv_bwd, case_split=case_split, window=window,
        max_segment_len=max_segment_len, fused_kv_slots=fused_kv_slots,
        fused_block_q=fused_block_q, fused_block_kv=fused_block_kv,
        fused_bwd_slots=fused_bwd_slots,
        fused_block_q_bwd=fused_block_q_bwd,
        fused_block_kv_bwd=fused_block_kv_bwd,
        fused_topology=fused_topology, fused_seq_factor=fused_seq_factor,
        fused_ccw_slots=fused_ccw_slots,
        fused_bwd_ccw_slots=fused_bwd_ccw_slots, wire_dtype=wire_dtype,
        mesh_axes=tuple(m.shape.items()))
    world = n_inter * n_intra
    seg = None
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (q.shape[0], q.shape[2]):
            raise ValueError(f"segment_ids have shape "
                             f"{tuple(segment_ids.shape)}, expected "
                             f"{(q.shape[0], q.shape[2])}")
        seg = shard(segment_ids.to(device=q.device, dtype=torch.int32),
                    world, dim=1)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        sink = [] if collect_stats else None
        o = _BurstAttn.apply(q, k, v, cfg, n_inter, n_intra, sink, seg)
        return (o, sink[0]) if collect_stats else o
    out = _fwd_impl(shard(q, world), shard(k, world), shard(v, world), cfg,
                    n_inter, n_intra, collect=collect_stats, seg=seg)
    return (unshard(out[0]), out[2]) if collect_stats else unshard(out[0])


def burst_attn_func(q, k, v, softmax_scale=None, flash: str = "auto",
                    causal: bool = False, optimize_bwd_comm: bool = True,
                    deterministic: bool = True, *, mesh, seq_axes=("sp",)):
    """Reference-style entry point: the zigzag-half causal layout.
    `flash` selects the backend ("auto" | "pallas" | "jnp" |
    "fused_ring"); `optimize_bwd_comm` picks the backward's payload;
    `deterministic` is accepted for parity: both backward routes are
    deterministic."""
    del deterministic
    return burst_attn(q, k, v, mesh=mesh, seq_axes=seq_axes, causal=causal,
                      layout="zigzag", scale=softmax_scale, backend=flash,
                      optimize_bwd_comm=optimize_bwd_comm)


def burst_attn_func_striped(q, k, v, softmax_scale=None, flash: str = "auto",
                            causal: bool = False,
                            optimize_bwd_comm: bool = True,
                            deterministic: bool = True, *, mesh,
                            seq_axes=("sp",)):
    """Reference-style entry point: the striped causal layout."""
    del deterministic
    return burst_attn(q, k, v, mesh=mesh, seq_axes=seq_axes, causal=causal,
                      layout="striped", scale=softmax_scale, backend=flash,
                      optimize_bwd_comm=optimize_bwd_comm)
