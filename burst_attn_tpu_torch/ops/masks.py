"""Per-round attention mask specifications (port of
burst_attn_tpu/ops/masks.py).

One uniform attention tile is parameterized by five scalars:

    q_lo, q_hi : active query-row range [q_lo, q_hi)    (local indices)
    kv_hi      : active key/value-column range [0, kv_hi)
    causal     : 1 if a causal constraint applies
    offset     : col j visible from row i  iff  j <= i + offset

The scalars are host ints here: the CUDA kernel takes them by value, so
a spec never costs a device-to-host read.  Only what the flash forward
consumes is ported so far: `MaskSpec`, `full_spec`, `round_spec` for the
contig layout, and the dense oracle `dense_mask`.
"""

from typing import NamedTuple

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


def round_spec(q_part: int, kv_part: int, s_q: int, s_kv: int, causal: bool,
               layout: str) -> MaskSpec:
    """Mask spec for one ring round of the contig layout: kv_part < q_part
    -> full, == -> causal, > -> fully masked.  The zigzag/striped layouts
    belong to the ring slice and raise here."""
    if layout != "contig":
        raise NotImplementedError(
            f"layout {layout!r} is not ported yet; only 'contig'")
    if not causal:
        return full_spec(s_q, s_kv)
    q_part, kv_part = int(q_part), int(kv_part)
    q_hi = 0 if kv_part > q_part else int(s_q)
    return MaskSpec(0, q_hi, int(s_kv), int(q_part == kv_part), 0)


def dense_mask(spec: MaskSpec, s_q: int, s_kv: int, device=None
               ) -> torch.Tensor:
    """Materialize the [s_q, s_kv] boolean mask (True = attend): the
    oracle the plain tile uses; the kernel computes the same predicate
    per element."""
    rows = torch.arange(s_q, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(s_kv, dtype=torch.int64, device=device)[None, :]
    m = (rows >= spec.q_lo) & (rows < spec.q_hi) & (cols < spec.kv_hi)
    if spec.causal:
        m = m & (cols <= rows + spec.offset)
    return m
