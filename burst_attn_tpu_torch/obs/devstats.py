"""Device-side ring telemetry (port of burst_attn_tpu/obs/devstats.py).

Everything else in `burst_attn_tpu_torch.obs` is host-only.  `DevStats`
makes the inside of a ring call visible without a host synchronization in
the ring: a NamedTuple of device tensors that the ring forward fills
beside its carry (`burst_attn(..., collect_stats=True)` returns
`(out, DevStats)`).  The per-round counts (rounds, live rounds, pairs)
come from the host-side mask scalars the ring already holds; the health
fields (row max, lse range, non-finite counts) are device reductions of
the ring's final state.  After the step the caller folds them into the
host registry with `DevStats.publish(...)`: the one place they are read
back to the host.

Every field has a leading axis of length `world` (one row per ring
position, in ring-position order); `slot_use*` are [world, MAX_SLOTS]:

  rounds         executed ring rounds (truncated rings count the live
                 schedule)
  rounds_live    rounds whose mask had ANY attending pair (masks.spec_live)
  attn_pairs     attended (q, kv) pairs summed over rounds (fp32)
  total_pairs    s_q * s_kv summed over executed rounds (occupancy denom)
  flops          4 * head_dim * attn_pairs, the per-position balance
                 measure
  m_max          max running row-max after the ring (scan ring only; the
                 fused kernel keeps m internal: -inf there)
  lse_min/max    finite range of the final log-sum-exp
  nonfinite_lse  count of nan/+inf lse entries (-inf is a legal
                 fully-masked row, not an error)
  nonfinite_acc  count of non-finite accumulator/output entries
  fused_rounds   rounds executed inside the fused kernel (0 on scan)
  rounds_elided  rounds the occupancy compiler removed from the schedule
                 (windowed or segment-bounded contig rings, truncated to
                 their live prefix); never launched, unlike (rounds -
                 rounds_live), which ran fully masked.  A windowed contig
                 ring shows the truncated round count in `rounds` and the
                 band's pairs in `attn_pairs` (spec_pair_count with the
                 window)
  slot_use       per-KV-slot consume counts of the fused forward kernel's
                 primary bank (kernel 8's in-kernel counters; zeros on the
                 scan path)
  slot_use_bwd   per-slot bundle consume counts of the fused BACKWARD
                 kernel (kernel 9).  Zeros on the scan path AND on the
                 autograd path: a backward cannot hand telemetry to the
                 forward's output, so it fills only through the direct
                 `fused_ring_bwd(..., collect_stats=True)` call
  slot_use_ccw / slot_use_bwd_ccw
                 the same for the second bank (the ccw ring of a bidi
                 topology, the double ring's inter bank); published as
                 dir="ccw"
  quant_absmax   the wire quantizer's largest |value| (max |k|, |v| of
                 the position under a wire dtype; 0.0 on a dense wire)
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

# Fixed width of the per-position slot_use vector (a kernel with fewer
# slots zero-pads; the scan path reports all zeros).  The JAX package's
# width, which the fused kernels' counters use too.
MAX_SLOTS = 8

_NEG_INF = float("-inf")
_POS_INF = float("inf")


class DevStats(NamedTuple):
    """Ring telemetry (see the module docstring for field semantics):
    device tensors with a leading ring-position axis."""

    rounds: torch.Tensor          # i32
    rounds_live: torch.Tensor     # i32
    attn_pairs: torch.Tensor      # f32
    total_pairs: torch.Tensor     # f32
    flops: torch.Tensor           # f32
    m_max: torch.Tensor           # f32
    lse_min: torch.Tensor         # f32
    lse_max: torch.Tensor         # f32
    nonfinite_lse: torch.Tensor   # i32
    nonfinite_acc: torch.Tensor   # i32
    fused_rounds: torch.Tensor    # i32
    rounds_elided: torch.Tensor   # i32
    slot_use: torch.Tensor        # i32[MAX_SLOTS]
    slot_use_bwd: torch.Tensor    # i32[MAX_SLOTS]
    slot_use_ccw: torch.Tensor      # i32[MAX_SLOTS]
    slot_use_bwd_ccw: torch.Tensor  # i32[MAX_SLOTS]
    quant_absmax: torch.Tensor      # f32

    def publish(self, registry=None, *, labels: Optional[dict] = None):
        """Fold the stats into a host metrics registry: the one read-back
        to the host (call it after the step).  Per-position gauges carry a
        `device` label (ring position); cross-position extrema and the
        slot / non-finite counters are aggregated.  Same names and labels
        as the JAX package.  Returns the registry."""
        from .registry import default_registry

        reg = registry if registry is not None else default_registry()
        base = dict(labels or {})
        leaves = {f: np.asarray(torch.as_tensor(getattr(self, f))
                                .detach().double().cpu())
                  for f in self._fields}
        if leaves["rounds"].ndim == 0:  # one position's stats
            leaves = {f: a[None, ...] for f, a in leaves.items()}
        world = leaves["rounds"].shape[0]

        for dev in range(world):
            lab = dict(base, device=dev)
            reg.gauge("devstats.rounds",
                      "executed ring rounds per device").set(
                leaves["rounds"][dev], **lab)
            reg.gauge("devstats.rounds_live",
                      "rounds with any attending pair").set(
                leaves["rounds_live"][dev], **lab)
            reg.gauge("devstats.rounds_elided",
                      "rounds the occupancy compiler removed from the "
                      "schedule (never launched)").set(
                leaves["rounds_elided"][dev], **lab)
            total = leaves["total_pairs"][dev]
            occ = leaves["attn_pairs"][dev] / total if total > 0 else 0.0
            reg.gauge("devstats.mask_occupancy",
                      "attended fraction of executed tile area").set(occ,
                                                                     **lab)
            reg.gauge("devstats.flops",
                      "attention flop estimate per device").set(
                leaves["flops"][dev], **lab)

        fl = leaves["flops"]
        mean = float(fl.mean())
        reg.gauge("devstats.flop_imbalance",
                  "max/mean per-device attention flops (1.0 = balanced)"
                  ).set(float(fl.max()) / mean if mean > 0 else 0.0, **base)
        reg.gauge("devstats.m_max",
                  "max running row-max across devices (scan ring)").set(
            float(leaves["m_max"].max()), **base)
        reg.gauge("devstats.lse_min").set(float(leaves["lse_min"].min()),
                                          **base)
        reg.gauge("devstats.lse_max").set(float(leaves["lse_max"].max()),
                                          **base)
        reg.counter("devstats.nonfinite",
                    "non-finite softmax-state entries seen, by array").inc(
            float(leaves["nonfinite_lse"].sum()), which="lse", **base)
        reg.counter("devstats.nonfinite").inc(
            float(leaves["nonfinite_acc"].sum()), which="acc", **base)
        reg.counter("devstats.fused_rounds",
                    "ring rounds executed inside the fused kernel").inc(
            float(leaves["fused_rounds"].sum()), **base)
        for field, pass_, dir_ in (("slot_use", "fwd", "cw"),
                                   ("slot_use_bwd", "bwd", "cw"),
                                   ("slot_use_ccw", "fwd", "ccw"),
                                   ("slot_use_bwd_ccw", "bwd", "ccw")):
            slot_tot = leaves[field].sum(axis=0)
            for j in range(slot_tot.shape[0]):
                if slot_tot[j]:
                    reg.counter(
                        "devstats.slot_use",
                        "fused-ring chunk/bundle consumes per comm slot, "
                        "by pass and ring direction").inc(
                        float(slot_tot[j]), slot=j, dir=dir_, **base,
                        **{"pass": pass_})
        reg.gauge("devstats.quant_absmax",
                  "largest |value| the wire quantizer mapped to its top "
                  "code (0 = dense wire; watch for saturation)").set(
            float(leaves["quant_absmax"].max()), **base)
        reg.counter("devstats.publishes",
                    "DevStats folded into the registry").inc()
        return reg


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """Host numbers to `device` without a synchronization: a pinned
    staging copy, sent non-blocking (a plain host-to-card copy would wait
    for the stream)."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _slots(slot_use, w: int, device) -> torch.Tensor:
    """[w, MAX_SLOTS] int32 slot counters from [w, slots] device counters
    (zero-padded; None = all zeros, the scan path's value)."""
    out = torch.zeros((w, MAX_SLOTS), dtype=torch.int32, device=device)
    if slot_use is not None:
        slot_use = torch.as_tensor(slot_use, device=device).reshape(w, -1)
        out[:, :slot_use.shape[1]] = slot_use.to(torch.int32)
    return out


def ring_stats_all(rounds, rounds_live, attn_pairs, total_pairs, head_dim,
                   m, lse, acc, fused_rounds=0, rounds_elided=0,
                   slot_use=None, slot_use_bwd=None, slot_use_ccw=None,
                   slot_use_bwd_ccw=None, quant_absmax=0.0) -> DevStats:
    """DevStats of every ring position at once, on lse's device: lse [W,
    ...], m [W, ...] or None (fused kernel: the row max never leaves the
    kernel), acc [W, ...] or a list of W tensors (the fp32 accumulators on
    the scan path, the finalized output on the fused path: either way,
    non-finite entries mean the softmax went wrong); the counts are host
    numbers (the ring's mask scalars are host ints), each a scalar or W of
    them; slot_use* are [W, slots] device counters.  `lse` -inf entries are
    legal (fully-masked rows): out of the finite range, not corruption.
    No host synchronization: the counts go up in one non-blocking copy and
    the reductions stay on the device.  `quant_absmax`: a host number, W
    of them, or an fp32 device tensor [W]."""
    w, dev = lse.shape[0], lse.device
    qam = quant_absmax if torch.is_tensor(quant_absmax) else None
    # the int32 rows first, then the fp32 rows: each group a slice of
    # the one upload (a list index would send its index tensor up with a
    # synchronizing copy)
    host = np.empty((7, w), np.float64)
    for row, x in enumerate((rounds, rounds_live, fused_rounds,
                             rounds_elided, attn_pairs, total_pairs,
                             0.0 if qam is not None else quant_absmax)):
        host[row] = x
    with torch.no_grad():
        up = _upload(host, dev)
        i32 = up[:4].to(torch.int32)
        f32 = up[4:].to(torch.float32)
        if qam is not None:  # a device tensor [W] (the wire's amax)
            f32[2] = qam.detach().to(device=dev, dtype=torch.float32)
        lse = lse.detach().reshape(w, -1)
        finite = torch.isfinite(lse)
        if torch.is_tensor(acc):
            bad_acc = (~torch.isfinite(acc.detach().reshape(w, -1))).sum(1)
        else:
            bad_acc = torch.stack([(~torch.isfinite(a.detach())).sum()
                                   for a in acc])
        return DevStats(
            rounds=i32[0], rounds_live=i32[1], attn_pairs=f32[0],
            total_pairs=f32[1], flops=f32[0] * (4.0 * head_dim),
            m_max=(torch.full((w,), _NEG_INF, dtype=torch.float32,
                              device=dev) if m is None
                   else m.detach().reshape(w, -1).amax(1).float()),
            lse_min=torch.where(finite, lse, _POS_INF).amin(1).float(),
            lse_max=torch.where(finite, lse, _NEG_INF).amax(1).float(),
            nonfinite_lse=(torch.isnan(lse) | (lse == _POS_INF)).sum(1)
            .to(torch.int32),
            nonfinite_acc=bad_acc.to(torch.int32),
            fused_rounds=i32[2], rounds_elided=i32[3],
            slot_use=_slots(slot_use, w, dev),
            slot_use_bwd=_slots(slot_use_bwd, w, dev),
            slot_use_ccw=_slots(slot_use_ccw, w, dev),
            slot_use_bwd_ccw=_slots(slot_use_bwd_ccw, w, dev),
            quant_absmax=f32[2])


def ring_stats(rounds, rounds_live, attn_pairs, total_pairs, head_dim,
               m, lse, acc, fused_rounds=0, rounds_elided=0, slot_use=None,
               slot_use_bwd=None, slot_use_ccw=None,
               slot_use_bwd_ccw=None, quant_absmax=0.0) -> DevStats:
    """One ring position's DevStats (0-d fields, [MAX_SLOTS] slot
    vectors): ring_stats_all of a one-position ring (the JAX package's
    per-shard assembly; same field semantics)."""
    def one(x):
        return None if x is None else torch.as_tensor(x)[None]

    st = ring_stats_all(rounds, rounds_live, attn_pairs, total_pairs,
                        head_dim, one(m), one(lse), one(acc), fused_rounds,
                        rounds_elided, one(slot_use), one(slot_use_bwd),
                        one(slot_use_ccw), one(slot_use_bwd_ccw),
                        quant_absmax)
    return DevStats(*(f[0] for f in st))


# per-field reduction across replicas and layers: counts sum, extrema
# max/min
_REDUCE_MAX = ("m_max", "lse_max", "quant_absmax")
_REDUCE_MIN = ("lse_min",)


def cross_reduce(stats: DevStats, dims) -> DevStats:
    """Reduce stats over replica dims that ride beside the ring (the JAX
    package reduces over batch/head mesh axes inside shard_map; here they
    are tensor dims of the fields, e.g. a leading replica axis before the
    ring-position axis).  Empty `dims` = no-op.  Counters sum, the health
    extrema take max / min."""
    dims = tuple(dims)
    if not dims:
        return stats
    out = {}
    for f in stats._fields:
        v = getattr(stats, f)
        if f in _REDUCE_MAX:
            out[f] = v.amax(dim=dims)
        elif f in _REDUCE_MIN:
            out[f] = v.amin(dim=dims)
        else:
            out[f] = v.sum(dim=dims, dtype=v.dtype)
    return DevStats(**out)


def expand_device_axis(stats: DevStats) -> DevStats:
    """Per-position fields -> a leading [1] axis (one position of a ring)."""
    return DevStats(*(a[None, ...] for a in stats))


def merge(a: DevStats, b: DevStats) -> DevStats:
    """Fold two DevStats (e.g. successive transformer layers): counts add,
    extrema max/min, as cross_reduce."""
    out = {}
    for f in a._fields:
        va, vb = getattr(a, f), getattr(b, f)
        if f in _REDUCE_MAX:
            out[f] = torch.maximum(va, vb)
        elif f in _REDUCE_MIN:
            out[f] = torch.minimum(va, vb)
        else:
            out[f] = va + vb
    return DevStats(**out)
