"""Fused ring kernel defaults for the H100 (the port's counterpart of the
fused rows of burst_attn_tpu/ops/tuning.py, whose per-TPU-generation
table does not apply to this card).

csrc/fused_ring_fwd.cu computes 64 query rows against 64-row K/V tiles.
Its fp32 instance stages them as fp32 in shared memory: Q, K (rows padded
by 4 floats) and V take 4 * (64*128 + 64*132 + 64*128) = 99,328 bytes at
D = 128, so two CTAs fit an SM's 227 KB; its bf16 instance (tensor
cores) stages the Q tile and two stages of K, V as bf16 rows of 136,
87,040 bytes.  csrc/fused_ring_bwd.cu's fp32 instance runs the flash
backward's tiles (csrc/flash_bwd_tile.cuh): K, V, Q and dO tiles of 64
rows padded by 4 floats, the P and dS tiles [64][68] and two row vectors,
4 * (4*64*132 + 2*64*68 + 2*64) = 170,496 bytes at D = 128, one CTA per
SM; its bf16 instance (csrc/mma_bwd_tile.cuh) 156,160 bytes, one CTA per
SM.  The gates below price the larger, fp32 plan.  Two slots per bank
(double buffering) is the default for both passes, as on the TPU.
"""

from typing import NamedTuple, Optional

# shared memory a block may use on an H100 (232,448 bytes)
SMEM_BUDGET = 227 * 1024
FUSED_BLOCK_Q = 64    # the kernel's q tile (csrc/fused_ring_fwd.cu BQ)
FUSED_BLOCK_KV = 64   # its kv tile (BKV)
FUSED_KV_SLOTS = 2
FUSED_CCW_SLOTS = 2   # second bank: bidi ccw / double inter prefetch
FUSED_BLOCK_Q_BWD = 64   # the backward kernel's q tile (flash_bwd_tile BQ)
FUSED_BLOCK_KV_BWD = 64  # its kv tile (BKV)


class ResolvedFused(NamedTuple):
    """resolve_fused() result (the JAX package's field names)."""

    block_q: int
    block_kv: int
    kv_slots: int
    smem_budget: int
    block_q_bwd: int
    block_kv_bwd: int
    bwd_slots: int
    ccw_slots: int
    bwd_ccw_slots: int
    wire_dtype: Optional[str] = None


def fused_smem_bytes(block_q: int, block_kv: int, d: int) -> int:
    """Shared memory of one fused-ring CTA: fp32 Q, padded K and V tiles."""
    return 4 * (block_q * d + block_kv * (d + 4) + block_kv * d)


def fused_bwd_smem_bytes(block_q: int, block_kv: int, d: int) -> int:
    """Shared memory of one fused-ring backward CTA: fp32 K, V, Q, dO
    tiles padded by 4 floats, the P and dS tiles and the rows' lse and
    delta."""
    return 4 * (2 * block_kv * (d + 4) + 2 * block_q * (d + 4)
                + 2 * block_q * (block_kv + 4) + 2 * block_q)


def resolve_fused(block_q=None, block_kv=None, kv_slots=None,
                  block_q_bwd=None, block_kv_bwd=None, bwd_slots=None,
                  ccw_slots=None, bwd_ccw_slots=None,
                  wire_dtype=None) -> ResolvedFused:
    """Fill the fused ring kernels' knobs from this card's defaults: the
    forward's tiles and slots, and the backward's (its tiles default to
    the backward kernel's 64 x 64, its slots to two per bank).  Slot
    counts below 2 cannot double-buffer and are rejected.  `wire_dtype`:
    None (the dense wire, the JAX table's fused_wire_dtype default), "int8"
    or "fp8"."""
    if wire_dtype not in (None, "int8", "fp8"):
        raise ValueError(
            f"wire_dtype must be None, 'int8' or 'fp8', got {wire_dtype!r}")
    bq = FUSED_BLOCK_Q if block_q is None else int(block_q)
    bkv = FUSED_BLOCK_KV if block_kv is None else int(block_kv)
    slots = FUSED_KV_SLOTS if kv_slots is None else int(kv_slots)
    bqb = FUSED_BLOCK_Q_BWD if block_q_bwd is None else int(block_q_bwd)
    bkvb = FUSED_BLOCK_KV_BWD if block_kv_bwd is None else int(block_kv_bwd)
    bslots = FUSED_KV_SLOTS if bwd_slots is None else int(bwd_slots)
    cslots = FUSED_CCW_SLOTS if ccw_slots is None else int(ccw_slots)
    bcslots = FUSED_CCW_SLOTS if bwd_ccw_slots is None else int(bwd_ccw_slots)
    for name, n in (("kv_slots", slots), ("bwd_slots", bslots),
                    ("ccw_slots", cslots), ("bwd_ccw_slots", bcslots)):
        if n < 2:
            raise ValueError(f"fused ring needs {name} >= 2, got {n}")
    return ResolvedFused(bq, bkv, slots, SMEM_BUDGET, bqb, bkvb, bslots,
                         cslots, bcslots, wire_dtype)
