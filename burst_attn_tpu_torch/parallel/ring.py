"""Ring arithmetic (port of burst_attn_tpu/parallel/ring.py, the host
parts).

A ring position is a partition id: position p of a flat ring of W
holds layout chunk p; on a two-axis ("inter", "intra") ring, or a flat
ring factored as (n_inter, n_intra), position p = inter_rank * n_intra +
intra_rank.  Every function here takes those coordinates explicitly; the
rotation itself (copies between the positions' buffers) lives in
parallel/mesh.py.

`wire_quantize` / `wire_dequantize` are the symmetric int8 / fp8 ring
payload quantizers (BurstConfig.wire_dtype): per-block scalar fp32
scales, the JAX package's arithmetic bit for bit.
"""

import numpy as np
import torch

from . import schedule

# one representable-range constant per wire dtype: int8 maps amax ->
# +-127, fp8 (e4m3fn, no inf) maps amax -> +-448, its finite max
WIRE_QMAX = {"int8": 127.0, "fp8": 448.0}
# the torch dtype each wire ships
WIRE_TORCH = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def wire_quantize(x, wire, axes):
    """(payload, scale) for one ring hop (the JAX package's wire_quantize).
    `axes` are the amax-reduction dims (everything inside one scale
    block); the scale keeps dims, so dequantization is a broadcast
    multiply.  amax in fp32, scale = max(amax, 1e-30) / QMAX, x / scale
    (a division), int8 rounded half to even and clipped to +-127, fp8 the
    e4m3fn cast.  wire=None passes `x` through with scale None."""
    if wire is None:
        return x, None
    if wire not in WIRE_QMAX:
        raise ValueError(f"wire must be None, 'int8' or 'fp8', got {wire!r}")
    f = x.float()
    amax = f.abs().amax(dim=tuple(axes), keepdim=True)
    scale = amax.clamp(min=1e-30) / WIRE_QMAX[wire]
    if wire == "int8":
        q = torch.clamp(torch.round(f / scale), -127.0, 127.0).to(torch.int8)
    else:
        q = (f / scale).to(torch.float8_e4m3fn)
    return q, scale


def wire_dequantize(q, scale, dtype):
    """Inverse of wire_quantize: rescale in fp32, then cast to the compute
    dtype the dense ring would have shipped; scale None passes q."""
    if scale is None:
        return q
    return (q.float() * scale).to(dtype)


def ring_round_counts(n_inter: int, n_intra: int, r_live=None):
    """(rounds, intra_hops, inter_hops) of ONE forward ring schedule, from
    the compiled program's hop totals.  A truncated contig single ring
    (parallel/burst._r_live) runs r_live rounds with r_live - 1 hops; a
    double ring runs n_intra rounds per cycle with n_intra - 1 intra hops
    and one prefetched inter hop per cycle boundary."""
    if n_inter == 1:
        live = n_intra if r_live is None else r_live
        prog = schedule.compile_fwd("uni", n_intra, r_live=live)
    else:
        prog = schedule.compile_fwd("double", n_intra, n_inter)
    totals = schedule.hop_totals(prog)
    return prog.n_rounds, totals["intra"], totals["inter"]


def ring_coords(position: int, n_inter: int, n_intra: int):
    """(inter_rank, intra_rank) of a ring position."""
    if not 0 <= position < n_inter * n_intra:
        raise ValueError(f"position {position} outside a {n_inter}x{n_intra}"
                         " ring")
    return divmod(int(position), int(n_intra))


def my_partition(inter_rank: int, intra_rank: int, n_intra: int) -> int:
    """The partition id a position holds: inter_rank * n_intra +
    intra_rank."""
    return int(inter_rank) * int(n_intra) + int(intra_rank)


def partition_at_round(r: int, inter_rank: int, intra_rank: int,
                       n_inter: int, n_intra: int) -> int:
    """Partition id of the KV payload a position holds at 0-indexed round
    r: after c inter hops and s intra hops of the forward rotation
    (i -> i+1) it holds the payload of (inter_rank - c, intra_rank - s)."""
    c, s = divmod(int(r), int(n_intra))
    return (((inter_rank - c) % n_inter) * n_intra
            + (intra_rank - s) % n_intra)


def ring_schedule(intra_size: int, inter_size: int = 1) -> np.ndarray:
    """[world, rounds] array: entry (position, r) is the partition id the
    position holds at ring round r."""
    world = inter_size * intra_size
    out = np.empty((world, world), dtype=np.int64)
    for dev in range(world):
        inter_rank, intra_rank = divmod(dev, intra_size)
        for r in range(world):
            out[dev, r] = partition_at_round(r, inter_rank, intra_rank,
                                             inter_size, intra_size)
    return out


def ring_roles(position: int, n_inter: int, n_intra: int, home_offsets=()):
    """Neighbour positions of a ring position: me, cw_dst / cw_src (intra
    ring right / left), ccw_dst / ccw_src, inter_dst / inter_src, and
    `home{j}` for each (inter_off, intra_off) in `home_offsets`."""
    ii, si = ring_coords(position, n_inter, n_intra)

    def ring_id(di, ds):
        return ((ii + di) % n_inter) * n_intra + (si + ds) % n_intra

    roles = {
        "me": int(position),
        "cw_dst": ring_id(0, 1), "cw_src": ring_id(0, -1),
        "ccw_dst": ring_id(0, -1), "ccw_src": ring_id(0, 1),
        "inter_dst": ring_id(1, 0), "inter_src": ring_id(-1, 0),
    }
    for j, (h_i, h_s) in enumerate(home_offsets):
        roles[f"home{j}"] = ring_id(h_i, h_s)
    return roles


def fused_slot_schedule(world: int, slots: int) -> np.ndarray:
    """[world] slot ids: entry r is the slot holding the chunk a position
    consumes at round r of the uni fused ring (a view of the compiled
    "uni" program; slots = 2 is plain double buffering)."""
    if world < 1 or slots < 2:
        raise ValueError(f"need world >= 1 and slots >= 2, got "
                         f"world={world}, slots={slots}")
    prog = schedule.compile_fwd("uni", world, slots=slots)
    return np.asarray(prog.col(schedule.CONSUME_SLOT), dtype=np.int64)
