"""Per-round attention mask specifications (port of
burst_attn_tpu/ops/masks.py).

One uniform attention tile is parameterized by five scalars:

    q_lo, q_hi : active query-row range [q_lo, q_hi)    (local indices)
    kv_hi      : active key/value-column range [0, kv_hi)
    causal     : 1 if a causal constraint applies
    offset     : col j visible from row i  iff  j <= i + offset

The scalars are host ints here: the CUDA kernels take them by value, so
a spec never costs a device-to-host read.

The three layouts' causal rounds (rank p of a W ring; s local tokens):

  * zigzag (p holds global chunks p and 2W-1-p):  kv_part == q_part ->
    plain causal; kv_part < q_part -> every q row x the first kv half;
    kv_part > q_part -> the second q half x every kv column.
  * striped (p holds tokens p, p+W, ...):  col j visible from row i iff
    j <= i (kv_part <= q_part) or j <= i - 1 (otherwise).
  * contig:  kv_part < q_part -> full, == -> causal, > -> nothing.

Besides the specs: `spec_live` (does a round attend anything),
`spec_pair_count` (attended pairs, the O(s) closed form of the dense
mask's sum), and the occupancy tables the schedule compiler truncates
rings with (`live_delta_table`, `live_round_prefix`).

`window` (sliding-window causal attention: the query at position p sees
positions p - window + 1 .. p): `dense_mask`, `spec_live` and
`spec_pair_count` take it, and so do the kernels behind them.  On a ring
(contig layout only) every round is the band j <= i + delta with delta =
(q_part - kv_part) * s, so `round_spec(..., window=)` returns that
offset-form causal spec and the window rides beside it; the occupancy
tables (`live_delta_table`, `live_round_prefix`) take it too and give the
windowed ring its live-round prefix, min(W, (s + window - 2) // s + 1).
`max_segment_len` (a promise about packed segment lengths) combines with
it.
"""

from typing import NamedTuple

import numpy as np
import torch


class MaskSpec(NamedTuple):
    """Host-int scalars describing one round's mask."""

    q_lo: int
    q_hi: int
    kv_hi: int
    causal: int
    offset: int


def full_spec(s_q: int, s_kv: int) -> MaskSpec:
    return MaskSpec(0, int(s_q), int(s_kv), 0, 0)


LAYOUTS = ("contig", "zigzag", "striped")


def check_window(window, layout="contig", causal=True) -> None:
    """The JAX package's window checks (burst_attn_tpu/parallel/burst.py
    BurstConfig): a window needs layout="contig", causal=True and
    window >= 1.  None passes."""
    if window is None:
        return
    if layout != "contig":
        raise ValueError(
            "window attention requires layout='contig' (the zigzag/striped "
            "load-balancing permutations break the band structure); got "
            f"layout={layout!r}")
    if not causal:
        raise ValueError("window attention requires causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def round_spec(q_part: int, kv_part: int, s_q: int, s_kv: int, causal: bool,
               layout: str, window=None) -> MaskSpec:
    """Mask spec for one ring round: q_part / kv_part are the global
    partition ids of the query and key/value chunks, s_q / s_kv the local
    lengths (see the module docstring for each layout's cases).  With a
    `window` (contig, causal, >= 1 only: the zigzag/striped permutations
    interleave two token ranges per shard, which one band cannot express)
    the round is the band j <= i + delta, delta = q_part * s_q - kv_part *
    s_kv: the offset-form causal spec, with the window passed beside it to
    the kernels."""
    if window is not None:
        if layout != "contig":
            raise ValueError(
                f"window attention supports layout='contig' only, got "
                f"{layout!r} (the zigzag/striped load-balancing permutations "
                "break the band structure)")
        if not causal:
            raise ValueError("window attention requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        delta = int(q_part) * int(s_q) - int(kv_part) * int(s_kv)
        return MaskSpec(0, int(s_q), int(s_kv), 1, delta)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of "
                         f"{LAYOUTS}")
    if not causal:
        return full_spec(s_q, s_kv)
    q_part, kv_part, s_q, s_kv = int(q_part), int(kv_part), int(s_q), int(s_kv)
    if layout == "zigzag":
        if s_q % 2 or s_kv % 2:
            raise ValueError("zigzag needs even local sequence lengths")
        q_lo = s_q // 2 if kv_part > q_part else 0
        kv_hi = s_kv // 2 if kv_part < q_part else s_kv
        return MaskSpec(q_lo, s_q, kv_hi, int(q_part == kv_part), 0)
    if layout == "striped":
        return MaskSpec(0, s_q, s_kv, 1, 0 if kv_part <= q_part else -1)
    q_hi = 0 if kv_part > q_part else s_q
    return MaskSpec(0, q_hi, s_kv, int(q_part == kv_part), 0)


def spec_live(spec: MaskSpec, window=None) -> bool:
    """Does ANY (row, col) of this round's tile attend?  False for a
    contig causal ring's future rounds (q_hi == 0): the ring skips their
    kernel launch altogether.  With a window, also False when the band's
    lowest column (row q_lo's) lies past the last kv column."""
    live = spec.q_hi > spec.q_lo and spec.kv_hi > 0
    # causal: some row must see col 0 (the earliest col of the chunk)
    live = live and (not spec.causal or spec.q_hi - 1 + spec.offset >= 0)
    if window is not None:
        live = live and spec.q_lo + spec.offset - window + 1 <= spec.kv_hi - 1
    return bool(live)


def spec_pair_count(spec: MaskSpec, s_q: int, s_kv: int, window=None) -> int:
    """Number of attending (row, col) pairs of one round's tile: each row
    in [q_lo, q_hi) sees the clamped column range [max(0, i + offset -
    window + 1), min(kv_hi - 1, i + offset)] (causal, the window band) or
    [0, kv_hi) — the sum of dense_mask without materializing it."""
    rows = np.arange(int(s_q), dtype=np.int64)
    in_row = (rows >= spec.q_lo) & (rows < spec.q_hi)
    hi = (np.minimum(spec.kv_hi - 1, rows + spec.offset) if spec.causal
          else np.full_like(rows, spec.kv_hi - 1))
    lo = np.zeros_like(rows)
    if window is not None and spec.causal:
        lo = np.maximum(lo, rows + spec.offset - window + 1)
    n = np.clip(hi - lo + 1, 0, int(s_kv))
    return int(np.sum(np.where(in_row, n, 0)))


def _host_round_pairs(layout: str, q_part: int, kv_part: int, s: int,
                      causal: bool, window=None) -> int:
    """Attended pairs of the round (q_part, kv_part) at equal local
    lengths `s`: spec_pair_count(round_spec(...)), the form the occupancy
    tables sweep."""
    return spec_pair_count(
        round_spec(q_part, kv_part, s, s, causal, layout, window=window),
        s, s, window=window)


def live_delta_table(layout: str, s: int, world: int, *, causal: bool,
                     window=None, max_segment_len=None):
    """Per-ring-offset occupancy: `live[delta]` is True iff ANY position's
    round at ring offset `delta` (q_part - kv_part = delta mod world)
    attends at least one pair.  The schedule compiler drops every op of an
    offset that is False everywhere.

    `max_segment_len` (contig only) adds the packed-segment reach bound:
    chunks `delta` apart hold tokens at least (delta-1)*s + 1 positions
    apart, so offsets past the bound cannot share a segment.  It is a
    promise about the ids the caller feeds, not checked per batch;
    zigzag/striped interleave token ranges per shard and ignore it.
    `window` (contig causal) kills the offsets its band cannot reach.
    Offset 0 (the self round) is always live."""
    if world < 1:
        raise ValueError(f"need world >= 1, got {world}")
    live = [True]
    for delta in range(1, world):
        alive = (not causal) or any(
            _host_round_pairs(layout, p, (p - delta) % world, s, True,
                              window=window) > 0
            for p in range(world))
        if alive and max_segment_len is not None and layout == "contig":
            # without causality the kv chunk also sits (world - delta)
            # chunks ahead on wrapping positions: a prefix+suffix band,
            # which live_round_prefix refuses to truncate
            dist = (delta - 1) * s + 1
            if not causal:
                dist = min(dist, (world - delta - 1) * s + 1)
            alive = dist <= max_segment_len - 1
        live.append(bool(alive))
    return tuple(live)


def live_round_prefix(layout: str, s: int, world: int, *, causal: bool,
                      window=None, max_segment_len=None) -> int:
    """K + 1 when the live offsets are exactly the prefix {0..K}, else
    `world` (no truncation): the `r_live` the schedule compiler and the
    scan ring's round truncation share.  Contig windowed rings give the
    closed form min(world, (s + window - 2) // s + 1)."""
    live = live_delta_table(layout, s, world, causal=causal, window=window,
                            max_segment_len=max_segment_len)
    k = max(i for i, alive in enumerate(live) if alive)
    return k + 1 if all(live[:k + 1]) else world


def dense_mask(spec: MaskSpec, s_q: int, s_kv: int, device=None,
               window=None) -> torch.Tensor:
    """Materialize the [s_q, s_kv] boolean mask (True = attend): the
    oracle the plain tile uses; the kernel computes the same predicate
    per element.  `window` keeps only the last `window` visible columns
    of each row's causal range: cols > rows + offset - window."""
    rows = torch.arange(s_q, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(s_kv, dtype=torch.int64, device=device)[None, :]
    m = (rows >= spec.q_lo) & (rows < spec.q_hi) & (cols < spec.kv_hi)
    if spec.causal:
        m = m & (cols <= rows + spec.offset)
    if window is not None:
        m = m & (cols > rows + spec.offset - window)
    return m
