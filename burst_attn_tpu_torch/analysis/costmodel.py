"""burstcost for the port: static resource plans and an analytic roofline
for the fused ring kernels, priced on the H100 (port of
burst_attn_tpu/analysis/costmodel.py; schema "burstcost-v2").

The JAX module prices TPU generations' VMEM; this one prices the card the
port runs on:

  * SHARED-MEMORY plans of every kernel instance, mirrored from the
    sources' own formulas (csrc/*.cu smem_bytes / kMmaSmem / Smem::bytes,
    the tiles of ops/tuning.py, ops/ragged_paged.py's plan) — what
    cudaFuncGetAttributes must report for the compiled kernel
    (`kernel_smem_plans`; the card half of costcheck's kernel-smem-budget
    holds them to `_build.kernel_attrs`), and the fused gate's admission
    formula against tuning.SMEM_BUDGET (227 KB);
  * the census of the fused ring's flag words and slot banks
    (csrc/ring_sync.cuh counters; the wrappers' allocations in
    ops/fused_ring.py and ops/fused_ring_bwd.py);
  * an analytic ROOFLINE: FLOPs from the masks.spec_pair_count closed
    forms (elided rounds contribute exactly zero — the identity
    cost-model-consistent pins against the devstats pair algebra), ring
    bytes from the per-round stream bytes times the compiled program's
    send census, HBM bytes from the kernels' compulsory traffic — exported
    as the `--cost-json` table fleet/sim.py prices replicas with.

The hardware-free columns (pairs, devstats pairs, FLOPs, stream bytes,
send census, rounds, slots) are the JAX package's, computed the same way
from the port's own schedule compiler; tests/test_torch_costmodel.py
holds them equal.

How the h100 row prices the ring link.  The port's W ring positions SHARE
one card (parallel/mesh.py): a rotation is an on-card copy, its bytes
read and written in HBM.  So `roofline(..., shared=True)` (the default
for "h100") prices a pass as the whole ring on one card: t_mxu = all
positions' FLOPs / peak; the HBM time counts every position's compulsory
traffic plus each rotation's bytes twice (read and write) at the HBM
rate; t_comm is those copies alone.  With one position a card
(`shared=False`, the multi-card ring of ROADMAP A7) a rotation crosses
NVLink: `ici_bw` is the H100 SXM's NVLink 4 rate in one direction
(450 GB/s of its 900 GB/s total), spec-derived and calibration-pending
until the multi-card ring can measure it.

Everything here is host arithmetic over compiled RingPrograms — no
tracing, no device.  The peaks (HW["h100"]) are the one source of the
H100 roofline: chip_smoke.py and bench/step_probe.py import them.
"""

from typing import Dict, List, NamedTuple, Optional, Tuple

from ..ops import tuning
from ..ops.masks import _host_round_pairs, live_round_prefix
from ..parallel import schedule as sched

# ---------------------------------------------------------------------------
# hardware roofline constants


class HwSpec(NamedTuple):
    peak_flops: float  # dense bf16 FLOP/s of one card
    hbm_bw: float      # HBM bytes/s of one card
    ici_bw: float      # one-direction bytes/s of one ring link between cards


HW: Dict[str, HwSpec] = {
    # H100 SXM data sheet: dense bf16 (tensor cores), HBM3, NVLink 4 (450
    # GB/s each way); the card runs below these at a power limit under 700 W
    "h100": HwSpec(989e12, 3.35e12, 450e9),
}
GENERATIONS = ("h100",)

# shared memory of one H100 SM and the most one block may use
SM_SMEM_BYTES = 233472
SMEM_RESERVED = 1024          # the system's share of each resident CTA
SMEM_LIMIT = tuning.SMEM_BUDGET
MAX_THREADS_SM = 2048
MAX_CTAS_SM = 32

# ring flag words a position may hold before the census is a tripwire (an
# unintended per-slot array); the per-item and per-tile counters scale
# with the shape and are counted apart
FLAG_BUDGET = 128

# canonical 8-position benchmark shape (bench.py headline: seq=65536 on
# an 8-ring, 32 heads, d=128 -> per-shard s=8192); the table prices every
# config at this shape AND at the largest shard its gate admits
DEFAULT_SHAPE = dict(b=1, n=32, n_kv=32, s=8192, d=128)
DEFAULT_WORLD = 8
PASSES = ("fwd", "bwd")
WIRE_DTYPES = (None, "int8", "fp8")
# the table prices bf16 payloads: the dtype the ring runs at the headline
TABLE_ITEMSIZE = 2


def _hw(generation: str) -> HwSpec:
    if generation not in HW:
        raise KeyError(f"no HwSpec for generation {generation!r}")
    return HW[generation]


def _factor(world: int) -> Tuple[int, int]:
    """(n_inter, n_intra) the double ring factors a flat world into
    (smallest n_inter >= 2), as the JAX cost model does."""
    n_i = 2
    while world % n_i or (world // n_i) < 2:
        n_i += 1
        if n_i > world // 2:
            raise ValueError(f"world {world} has no double-ring factoring")
    return n_i, world // n_i


def compile_program(pass_: str, topology: str, world: int,
                    rf: tuning.ResolvedFused,
                    r_live: Optional[int] = None) -> sched.RingProgram:
    """The RingProgram the fused dispatch would run for this config (the
    compiler entry of ops/fused_ring._compile_for, without a cfg).  The
    port's wire payloads ride the dense program's table, so the wire
    dtype does not change the program."""
    n_inter, n_intra = (1, world) if topology != "double" else _factor(world)
    if pass_ == "fwd":
        return sched.compile_fwd(topology, n_intra, n_inter,
                                 slots=rf.kv_slots, slots1=rf.ccw_slots,
                                 r_live=r_live)
    return sched.compile_bwd(topology, n_intra, n_inter,
                             slots=rf.bwd_slots, slots1=rf.bwd_ccw_slots,
                             dq_slots=rf.bwd_slots, r_live=r_live)


# ---------------------------------------------------------------------------
# shared-memory plans of the kernel instances (csrc mirrors)

TILE_D = 128            # csrc/mma_tile.cuh kTileD
TILE_LD = TILE_D + 8    # kTileLd: bf16 rows padded by 16 bytes
TILE_CHUNK = 64         # kTileChunk
BQ = BKV = 64           # the flash tiles (flash_tile.cuh, flash_bwd_tile.cuh)


def simt_fwd_smem(d: int = TILE_D) -> int:
    """csrc/flash_tile.cuh smem_bytes<D>: sQ [BQ][D] + sK [BKV][D+4] +
    sV [BKV][D], fp32 (the fp32 instances of kernels 1 and 8)."""
    return 4 * (BQ * d + BKV * (d + 4) + BKV * d)


def mma_fwd_smem(seg: bool = False) -> int:
    """kMmaSmem (+ kSegSmem) of csrc/flash_fwd.cu and fused_ring_fwd.cu:
    the bf16 Q tile and two stages of K, V rows (and their kv ids)."""
    return 2 * 5 * 64 * TILE_LD + (4 * 2 * TILE_CHUNK if seg else 0)


def simt_bwd_smem(d: int = TILE_D) -> int:
    """csrc/flash_bwd_tile.cuh smem_bytes<D>: sK, sV, sQ, sdO [64][D+4],
    sP, sdS [64][BKV+4], lse and delta rows, fp32."""
    return 4 * (4 * 64 * (d + 4) + 2 * 64 * (BKV + 4) + 2 * BQ)


def mma_bwd_smem(seg: bool = False) -> int:
    """csrc/mma_bwd_tile.cuh Smem::bytes: K, V and two stages of Q, dO as
    bf16 tiles, dS^T hi and lo, the step-1 exchange, lse and delta rows
    (and the q rows' ids)."""
    return (2 * (6 * 64 * TILE_LD + 2 * BKV * (BQ + 8)) + 16 * 8 * 8 * 32
            + 4 * 2 * BQ + (4 * BQ if seg else 0))


def mma_dq_smem(seg: bool = False) -> int:
    """csrc/flash_bwd.cu kDqSmem (kDqSegSmem): Q, dO resident and two
    stages of K, V as bf16 tiles (and the kv ids)."""
    return 2 * 6 * 64 * TILE_LD + (4 * 2 * TILE_CHUNK if seg else 0)


# csrc/ragged_paged.cu
RAGGED_MAXR = 64
RAGGED_MAXSPLIT = 32
POOL_ITEMSIZE = {"fp32": 4, "bf16": 2, "int8": 1, "fp8": 1}


def ragged_plan_bytes(*, q_dtype: str, pool_dtype: str,
                      d_head: int = TILE_D, chunk: int = TILE_CHUNK) -> int:
    """csrc/ragged_paged.cu smem_bytes<T, KV, QUANT>: the larger of the
    math's plan (fp32 q: SIMT rows, two stages of K/V in the pool's
    type, scores, row rescales; bf16 q: the mma Q tile, the stages, and
    for a 1-byte pool the chunk widened to bf16) and the emit buffers (a
    block's fp32 rows, their m and l, the merge's split weights)."""
    esz = POOL_ITEMSIZE[pool_dtype]
    quant = esz == 1
    ld = d_head + 16 // esz
    stager = 2 * (2 * chunk * ld * esz) + (4 * 2 * 2 * chunk if quant else 0)
    if q_dtype == "fp32":
        math = (4 * RAGGED_MAXR * d_head + stager + 4 * RAGGED_MAXR * chunk
                + 4 * RAGGED_MAXR)
    else:
        math = (2 * RAGGED_MAXR * TILE_LD + stager
                + (2 * 2 * chunk * TILE_LD if quant else 0))
    emit = 4 * (RAGGED_MAXR * d_head + 4 * RAGGED_MAXR
                + 2 * RAGGED_MAXSPLIT * RAGGED_MAXR) + 16
    return max(math, emit)


class SmemPlan(NamedTuple):
    """One compiled instance's planned shared memory (what
    cudaFuncGetAttributes must report), its threads, the CTAs an SM the
    shared memory admits and the CTAs an SM the design assumes."""

    lib: str
    instance: str
    smem: int
    threads: int
    ctas_by_smem: int
    ctas_assumed: int


def ctas_by_smem(smem: int, threads: int) -> int:
    """Resident CTAs an SM by shared memory (with the per-CTA reserve),
    threads and the block limit."""
    by_smem = SM_SMEM_BYTES // (smem + SMEM_RESERVED)
    return max(0, min(by_smem, MAX_THREADS_SM // threads, MAX_CTAS_SM))


def _plan(lib, instance, smem, threads, assumed=1) -> SmemPlan:
    return SmemPlan(lib, instance, smem, threads,
                    ctas_by_smem(smem, threads), assumed)


def kernel_smem_plans() -> List[SmemPlan]:
    """Every kernel instance whose attributes the card reports
    (ops/flash.fwd_attrs, bwd_attrs, ops/fused_ring.fwd_attrs,
    ops/fused_ring_bwd.bwd_attrs, ops/ragged_paged.ragged_attrs), labelled
    as those report it.  Assumed CTAs an SM: two for the forward tiles of
    kernels 1 and 8 (ops/tuning.py: two CTAs fit an SM) and for the bf16
    dq kernel (its __launch_bounds__(128, 2)), one for the others."""
    out: List[SmemPlan] = []
    for seg in (False, True):
        tag = " seg" if seg else ""
        for lbl in ("bf16", "bf16 acc", "bf16 window"):
            out.append(_plan("flash_fwd", lbl + tag, mma_fwd_smem(seg), 128,
                             2))
        out.append(_plan("flash_fwd", "fp32" + tag, simt_fwd_smem(), 128, 2))
        for win in (False, True):
            t = tag + (" win" if win else "")
            out += [
                _plan("flash_bwd", "bf16 fused" + t, mma_bwd_smem(seg), 256),
                _plan("flash_bwd", "fp32 fused" + t, simt_bwd_smem(), 256),
                _plan("flash_bwd", "bf16 dq" + t, mma_dq_smem(seg), 128, 2),
                _plan("flash_bwd", "bf16 dkdv" + t, mma_bwd_smem(seg), 256)]
    for stats in (False, True):
        for seg in (False, True):
            for win in (False, True):
                t = ((" stats" if stats else "") + (" seg" if seg else "")
                     + (" win" if win else ""))
                for res in ("", " scratch"):
                    out.append(_plan("fused_ring_fwd", "bf16" + res + t,
                                     mma_fwd_smem(seg), 128, 2))
                    out.append(_plan("fused_ring_fwd", "fp32" + res + t,
                                     simt_fwd_smem(), 128, 2))
    for win in (False, True):
        t = (" win" if win else "") + " wire"
        out.append(_plan("fused_ring_fwd", "bf16 scratch" + t,
                         mma_fwd_smem(), 128, 2))
        out.append(_plan("fused_ring_fwd", "fp32 scratch" + t,
                         simt_fwd_smem(), 128, 2))
    bwd = [("bf16", False), ("bf16 traced", False), ("bf16 stats", False)]
    bwd += [(f"bf16{a}", "seg" in a) for a in (" seg", " win", " seg win",
                                                " wire", " win wire")]
    for lbl, seg in bwd:
        out.append(_plan("fused_ring_bwd", lbl, mma_bwd_smem(seg), 256))
    for lbl in ("fp32", "fp32 stats", "fp32 seg", "fp32 win", "fp32 seg win",
                "fp32 wire", "fp32 win wire"):
        out.append(_plan("fused_ring_bwd", lbl, simt_bwd_smem(), 256))
    for q in ("bf16", "fp32"):
        for pool, sfx in ((q, ""), ("int8", " int8"), ("fp8", " fp8")):
            out.append(_plan("ragged_paged", q + sfx,
                             ragged_plan_bytes(q_dtype=q, pool_dtype=pool),
                             128))
    return out


# ---------------------------------------------------------------------------
# the fused ring's plans: gate, shared memory, slot banks, flag words


class ResourcePlan(NamedTuple):
    """Static resource footprint of one fused kernel launch.

    gate_bytes  the dispatch gate's admission formula (fused_ring.supported:
                the fp32 instance's tiles, ops/tuning.py)
    smem_bytes  the largest shared memory of the pass's instances (every
                dtype and template flag; kernel_smem_plans)
    slot_bytes  the global-memory slot banks of all W positions (payload,
                scales of a quantized wire, dq banks)
    flag_words  the ring's flag words a position (arrival and credit
                counters a (bank, slot), done counters a round)
    item_words  the per-item / per-tile counters a position (kernel 8's
                scratch-state versions, kernel 9's dq folds)
    """

    gate_bytes: int
    smem_bytes: int
    slot_bytes: int
    flag_words: int
    item_words: int


def fwd_gate_bytes(rf: tuning.ResolvedFused, d: int) -> int:
    return tuning.fused_smem_bytes(rf.block_q, rf.block_kv, d)


def bwd_gate_bytes(rf: tuning.ResolvedFused, d: int) -> int:
    return tuning.fused_bwd_smem_bytes(rf.block_q_bwd, rf.block_kv_bwd, d)


def _pass_smem(pass_: str, wire: Optional[str]) -> int:
    lib = "fused_ring_fwd" if pass_ == "fwd" else "fused_ring_bwd"
    sizes = [p.smem for p in kernel_smem_plans() if p.lib == lib
             and (p.instance.endswith(" wire") == (wire is not None))]
    return max(sizes)


def fwd_plan(rf: tuning.ResolvedFused, program: sched.RingProgram, *,
             b: int, n: int, n_kv: int, s: int, d: int,
             itemsize: int = 2) -> ResourcePlan:
    """ops/fused_ring.py's allocations for one launch: per bank and slot
    a K and a V chunk (dense: the payload dtype; a wire dtype: the 1-byte
    chunk and its (batch, kv head) scales), per position 2 counters a
    (bank, slot) and 2 a round; the scratch state's per-item versions."""
    w = program.world
    if rf.wire_dtype is None:
        chunk = b * n_kv * s * d * itemsize
    else:
        chunk = -(-(b * n_kv * s * d + 4 * b * n_kv) // 16) * 16
    slot = 2 * w * sum(program.slots) * chunk
    flags = 2 * program.n_banks * max(program.slots) + 2 * program.n_rounds
    items = b * n * -(-s // rf.block_q)
    return ResourcePlan(fwd_gate_bytes(rf, d), _pass_smem("fwd", rf.wire_dtype),
                        slot, flags, items)


def bwd_plan(rf: tuning.ResolvedFused, program: sched.RingProgram, *,
             b: int, n: int, n_kv: int, s: int, d: int, itemsize: int = 2,
             opt_comm: bool = True) -> ResourcePlan:
    """ops/fused_ring_bwd.py's allocations for one launch: per bank and
    slot the q-side bundle (delta | o, do, q at the payload width, lse
    fp32; a wire dtype: 1-byte operands, lse with the scales), per dq bank
    and slot an fp32 dq partial (a wire dtype: its 1-byte slot), per
    position 2 counters a (bank, slot), 4 a dq slot, 3 a round, and the
    dq fold counters a (round, q tile)."""
    w = program.world
    rows = b * n * s
    if rf.wire_dtype is None:
        first = rows * (4 if opt_comm else d * itemsize)
        bundle = first + 2 * rows * d * itemsize + rows * 4
        dq_slot = rows * d * 4
    else:
        first = rows * (1 if opt_comm else d)
        bundle = first + 2 * rows * d + rows * 4 + 4 * 3 * b * n
        nqt = -(-s // rf.block_q_bwd)
        dq_slot = rows * d + -(-(b * n * nqt * 4) // 16) * 16
    dq_slots = list(program.dq_slots) + [0] * (2 - len(program.dq_slots))
    slot = w * (sum(program.slots) * bundle + sum(dq_slots[:2]) * dq_slot)
    flags = (2 * program.n_banks * max(program.slots) + 4 * max(dq_slots[:2])
             + 3 * program.n_rounds)
    items = program.n_rounds * b * n * -(-s // rf.block_q_bwd)
    return ResourcePlan(bwd_gate_bytes(rf, d), _pass_smem("bwd", rf.wire_dtype),
                        slot, flags, items)


def plan(pass_: str, rf: tuning.ResolvedFused, program: sched.RingProgram,
         *, b: int, n: int, n_kv: int, s: int, d: int, itemsize: int = 2,
         opt_comm: bool = True) -> ResourcePlan:
    if pass_ == "fwd":
        return fwd_plan(rf, program, b=b, n=n, n_kv=n_kv, s=s, d=d,
                        itemsize=itemsize)
    if pass_ != "bwd":
        raise ValueError(f"pass_ must be 'fwd' or 'bwd', got {pass_!r}")
    return bwd_plan(rf, program, b=b, n=n, n_kv=n_kv, s=s, d=d,
                    itemsize=itemsize, opt_comm=opt_comm)


def max_admitted_shard(pass_: str, rf: tuning.ResolvedFused, *, d: int,
                       cap: int = 1 << 22) -> int:
    """Largest power-of-two per-shard s the dispatch gate admits (the
    shard the budget proof must cover).  The port's gate prices the
    kernel's fixed tiles, not the shard, so it admits every s up to `cap`
    or none; the slot banks (global memory) are what grows with s."""
    gate = fwd_gate_bytes(rf, d) if pass_ == "fwd" else bwd_gate_bytes(rf, d)
    return cap if gate <= rf.smem_budget else 0


# the serving shapes the ragged plan covers: q dtype x pool dtype (the
# kernel takes head dim 128 and any page multiple of 64; the plan does not
# depend on the page or the group)
RAGGED_MATRIX = tuple(
    dict(q_dtype=q, pool_dtype=pool)
    for q in ("bf16", "fp32") for pool in (q, "int8", "fp8"))

# pool storage dtypes the paged KV cache holds, with their per-element
# byte cost; the 1 B/elem dtypes stream one fp32 scale per (token, kv
# head) for each of K and V
POOL_DTYPES = {"fp32": 4, "bf16": 2, "int8": 1, "fp8": 1}


def ragged_hbm_bytes(*, d_head: int, n_kv: int, kv_len: int,
                     pool_dtype: str) -> int:
    """Analytic HBM bytes ONE decode step's attention must stream per
    sequence: the full resident K+V at the pool's storage width, plus —
    on quantized pools — the fp32 per-token scale columns (the JAX
    function; the port adds the bf16 pool)."""
    eb = POOL_DTYPES[pool_dtype]
    total = 2 * n_kv * kv_len * d_head * eb
    if eb == 1:
        total += 2 * n_kv * kv_len * 4
    return total


def ragged_floor_s(kv_lens, *, n_kv: int, group: int, d_head: int,
                   pool_dtype: str, q_itemsize: int, q_lens=None,
                   generation: str = "h100") -> float:
    """The least time one ragged launch (kernel 7; kernel 6 with q_lens
    None: one query token a live slot) could take on the card: every
    slot's K and V read once at the pool's width (ragged_hbm_bytes), its
    queries read and its outputs written once, at the HBM rate — decode
    attention is bandwidth-bound."""
    hw = _hw(generation)
    total = 0
    for i, kv in enumerate(kv_lens):
        qt = (1 if kv > 0 else 0) if q_lens is None else int(q_lens[i])
        total += ragged_hbm_bytes(d_head=d_head, n_kv=n_kv, kv_len=int(kv),
                                  pool_dtype=pool_dtype)
        total += 2 * qt * n_kv * group * d_head * q_itemsize
    return total / hw.hbm_bw


# ---------------------------------------------------------------------------
# FLOPs: closed forms over the global mask, and the devstats per-round sum


def pass_pairs(layout: str, s: int, world: int, *, causal: bool,
               window: Optional[int] = None) -> int:
    """Closed-form attending (row, col) pair count of ONE full ring pass,
    per (batch, head): the ring visits every (q chunk, kv chunk) pair
    exactly once across all positions and rounds, so the total is the
    GLOBAL S x S mask's pair count (S = world * s) — independent of layout
    and of dead-round elision."""
    del layout  # layouts permute token placement, not the global mask
    S = world * s
    if not causal:
        return S * S
    if window is None:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def devstats_pass_pairs(program: sched.RingProgram, layout: str, s: int, *,
                        causal: bool, window: Optional[int] = None,
                        pair_fn=None) -> int:
    """The devstats pair algebra: sum of the per-round occupancy closed
    form (masks._host_round_pairs, the host twin of spec_pair_count) over
    every position and every EXECUTED round of the compiled program.
    `pair_fn` is a mutation seam for the lint tests."""
    fn = _host_round_pairs if pair_fn is None else pair_fn
    total = 0
    for dev in range(program.world):
        inter, intra = divmod(dev, program.n_intra)
        for r in range(program.n_rounds):
            kv_part = sched.partition_for_round(program, r, inter, intra)
            total += fn(layout, dev, kv_part, s, causal, window)
    return total


def pass_flops(pass_: str, layout: str, *, b: int, n: int, s: int, d: int,
               world: int, causal: bool,
               window: Optional[int] = None) -> float:
    """Analytic tensor-core FLOPs of one pass across the WHOLE ring: 4*d
    per attending pair forward (q k^T + p v, obs/devstats.py's flops),
    2.5x that backward (the 5-matmul recompute factor)."""
    pairs = pass_pairs(layout, s, world, causal=causal, window=window)
    fwd = 4.0 * d * pairs * b * n
    return fwd if pass_ == "fwd" else 2.5 * fwd


# ---------------------------------------------------------------------------
# ring bytes: an independent re-derivation of the wire formula, plus the
# compiled program's send census


def stream_bytes(pass_: str, wire: Optional[str], *, b: int, n: int,
                 n_kv: int, s: int, d: int, opt_comm: bool = True,
                 itemsize: int = 4) -> Dict[str, int]:
    """Per-round per-position ring bytes by stream, re-derived here from
    the payload shapes and quantization rules — deliberately NOT a call
    into schedule.wire_round_bytes, so cost-model-consistent can pin the
    two derivations equal and catch either one drifting."""
    wi = itemsize if wire is None else 1
    scale = 0 if wire is None else 4
    if pass_ == "fwd":
        return {"kv": 2 * (b * n_kv * s * d * wi + b * n_kv * scale)}
    if pass_ != "bwd":
        raise ValueError(f"pass_ must be 'fwd' or 'bwd', got {pass_!r}")
    first = b * n * s * (4 if wire is None else 1) if opt_comm \
        else b * n * s * d * wi
    bundle = first + 2 * b * n * s * d * wi + b * n * s * 4 \
        + 3 * b * n * scale
    dq = b * n * s * d * (4 if wire is None else 1) + b * n * scale
    return {"bundle": bundle, "dq": dq}


def send_census(program: sched.RingProgram) -> Dict[str, int]:
    """Per-position send counts of one compiled pass, straight off the op
    table: payload sends per channel, dq hops (ring + boundary + home /
    final)."""
    rows = program.rows
    n0 = sum(rows["send0"][r] for r in range(program.n_rounds))
    n1 = sum(rows["send1"][r] for r in range(program.n_rounds))
    out = {"send0": int(n0), "send1": int(n1), "dq": 0}
    if program.kind == "bwd":
        out["dq"] = sum(1 for r in range(program.n_rounds)
                        if rows["dq_send"][r] != sched.DQ_NONE)
    return out


def pass_ici_bytes(pass_: str, program: sched.RingProgram, *, b: int,
                   n: int, n_kv: int, s: int, d: int, wire=None,
                   opt_comm: bool = True, itemsize: int = 4) -> int:
    """Total per-position ring bytes of one pass: the per-round stream
    bytes times the compiled program's send census."""
    per = stream_bytes(pass_, wire, b=b, n=n, n_kv=n_kv, s=s, d=d,
                       opt_comm=opt_comm, itemsize=itemsize)
    c = send_census(program)
    if pass_ == "fwd":
        return (c["send0"] + c["send1"]) * per["kv"]
    return (c["send0"] + c["send1"]) * per["bundle"] + c["dq"] * per["dq"]


def pass_hbm_bytes(pass_: str, program: sched.RingProgram, *, b: int,
                   n: int, n_kv: int, s: int, d: int, wire=None,
                   opt_comm: bool = True, itemsize: int = 4) -> int:
    """Per-position compulsory HBM traffic of one pass in the CUDA
    kernels (rotations apart: pass_ici_bytes).

    fwd (kernel 8): q, the own k and v read once, each executed round's
    consumed chunk read once from its slot, o and the fp32 lse written.
    bwd (kernel 9): the resident k, v read once, each round's bundle read
    and its dq partial read and written (fp32; 1 byte a wire dtype), dk,
    dv written fp32."""
    R = program.n_rounds
    wi = itemsize if wire is None else 1
    if pass_ == "fwd":
        chunk = 2 * b * n_kv * s * d * wi
        return (b * n * s * d * itemsize + 2 * b * n_kv * s * d * itemsize
                + R * chunk + b * n * s * d * itemsize + b * n * s * 4)
    per = stream_bytes("bwd", wire, b=b, n=n, n_kv=n_kv, s=s, d=d,
                       opt_comm=opt_comm, itemsize=itemsize)
    return (2 * b * n_kv * s * d * itemsize
            + R * (per["bundle"] + 2 * per["dq"])
            + 2 * b * n_kv * s * d * 4)


# ---------------------------------------------------------------------------
# roofline floors


class CostEstimate(NamedTuple):
    flops: float        # whole-ring pass FLOPs (all positions)
    hbm_bytes: int      # per-position compulsory HBM traffic
    ici_bytes: int      # per-position ring bytes
    t_compute_s: float  # max(tensor-core time, HBM time)
    t_comm_s: float     # the rotations' time (see the module docstring)

    @property
    def floor_s(self) -> float:
        return max(self.t_compute_s, self.t_comm_s)


def _comm_floor_s(pass_: str, program: sched.RingProgram, hw: HwSpec, *,
                  b: int, n: int, n_kv: int, s: int, d: int, wire=None,
                  opt_comm: bool = True, itemsize: int = 4) -> float:
    """One position a card: the critical chain of sends a position must
    wait out, per topology (the JAX model's).  uni serializes every send
    down one link; bidi runs its two directions concurrently; the double
    ring's inter hop is prefetched a full intra cycle early, so only the
    intra chain bounds; the bwd dq stream shares the bundle's links."""
    per = stream_bytes(pass_, wire, b=b, n=n, n_kv=n_kv, s=s, d=d,
                       opt_comm=opt_comm, itemsize=itemsize)
    c = send_census(program)
    if program.topology == "bidi":
        chain = max(c["send0"], c["send1"])
        dq_hops = -(-c["dq"] // 2)
    elif program.topology == "double":
        chain = c["send0"]
        dq_hops = c["dq"]
    else:
        chain = c["send0"] + c["send1"]
        dq_hops = c["dq"]
    if pass_ == "fwd":
        return chain * per["kv"] / hw.ici_bw
    return (chain * per["bundle"] + dq_hops * per["dq"]) / hw.ici_bw


def roofline(pass_: str, generation: str, program: sched.RingProgram, *,
             layout: str, b: int, n: int, n_kv: int, s: int, d: int,
             causal: bool, window: Optional[int] = None, wire=None,
             opt_comm: bool = True, itemsize: int = 4,
             shared: bool = True) -> CostEstimate:
    """The pass's floors on `generation`.  shared=True: the W positions
    share one card (the port today) — the whole ring's FLOPs at the peak,
    every position's HBM traffic plus each rotation read and written in
    HBM; shared=False: one position a card, rotations over the ring link
    (spec-derived, see the module docstring)."""
    hw = _hw(generation)
    w = program.world
    fl = pass_flops(pass_, layout, b=b, n=n, s=s, d=d, world=w,
                    causal=causal, window=window)
    kw = dict(b=b, n=n, n_kv=n_kv, s=s, d=d, wire=wire, opt_comm=opt_comm,
              itemsize=itemsize)
    hbm = pass_hbm_bytes(pass_, program, **kw)
    ici = pass_ici_bytes(pass_, program, **kw)
    if shared:
        copies = 2 * ici * w
        t_comm = copies / hw.hbm_bw
        t_compute = max(fl / hw.peak_flops, (hbm * w + copies) / hw.hbm_bw)
    else:
        t_comm = _comm_floor_s(pass_, program, hw, **kw)
        t_compute = max(fl / w / hw.peak_flops, hbm / hw.hbm_bw)
    return CostEstimate(fl, hbm, ici, t_compute, t_comm)


def predict_floors(pass_: str, *, b: int, n: int, n_kv: int, s: int, d: int,
                   world: int, topology: str = "uni",
                   generation: str = "h100", wire: Optional[str] = None,
                   layout: str = "zigzag", causal: bool = True,
                   window: Optional[int] = None, opt_comm: bool = True,
                   itemsize: int = 2,
                   shared: bool = True) -> Tuple[float, float]:
    """(t_comm_pred_s, t_compute_pred_s) — the model's floors for one
    ring config (contig causal windows compile the elided program)."""
    r_live = None
    if window is not None and layout == "contig" and causal:
        rl = live_round_prefix(layout, s, world, causal=True, window=window)
        r_live = rl if rl < world and topology != "double" else None
    rf = tuning.resolve_fused(wire_dtype=wire)
    program = compile_program(pass_, topology, world, rf, r_live=r_live)
    est = roofline(pass_, generation, program, layout=layout, b=b, n=n,
                   n_kv=n_kv, s=s, d=d, causal=causal, window=window,
                   wire=wire, opt_comm=opt_comm, itemsize=itemsize,
                   shared=shared)
    return est.t_comm_s, est.t_compute_s


def predict_metric(metric: str) -> Optional[float]:
    """Analytic roofline expectation (TFLOP/s a card) for a bench.py-style
    headline metric string ("... TFLOPs/s/chip @ seq=65536 causal bf16"),
    or None when the metric is not a TFLOPs-style headline.  Assumes the
    canonical shape (8 positions, 32 heads, d=128) on one shared H100."""
    import re

    if "TFLOPs/s" not in metric:
        return None
    m = re.search(r"seq=(\d+)", metric)
    if not m:
        return None
    seq = int(m.group(1))
    world = DEFAULT_WORLD
    n, d = DEFAULT_SHAPE["n"], DEFAULT_SHAPE["d"]
    s = max(1, seq // world)
    causal = "causal" in metric
    itemsize = 2 if "bf16" in metric else 4
    passes = PASSES if "fwd+bwd" in metric else ("fwd",)
    t = 0.0
    total_flops = 0.0
    for p in passes:
        tc, tx = predict_floors(p, b=1, n=n, n_kv=n, s=s, d=d, world=world,
                                causal=causal, itemsize=itemsize)
        t += max(tc, tx)
        total_flops += pass_flops(p, "zigzag", b=1, n=n, s=s, d=d,
                                  world=world, causal=causal)
    if t <= 0:
        return None
    return round(total_flops / t / 1e12, 2)


# ---------------------------------------------------------------------------
# the exported cost table (--cost-json): fleet/sim.py's replica prices


def cost_table(world: int = DEFAULT_WORLD,
               shape: Optional[dict] = None) -> dict:
    """The generation x wire-dtype x topology x pass matrix, one row per
    config: resolved knobs, the static plan (at the canonical shape AND
    the largest gate-admitted shard), the roofline (bf16 payloads, the
    positions sharing one card) and a `fits` verdict.  Plus the ragged
    kernel's shared-memory plans and the per-pool-dtype decode HBM
    pricing.  Schema "burstcost-v2" (the JAX table's; the VMEM columns are
    shared-memory columns here: smem_bytes, smem_limit, flag_words)."""
    shp = dict(DEFAULT_SHAPE if shape is None else shape)
    b, n, n_kv, s, d = (shp[k] for k in ("b", "n", "n_kv", "s", "d"))
    rows: List[dict] = []
    for gen in GENERATIONS:
        for wire in WIRE_DTYPES:
            rf = tuning.resolve_fused(wire_dtype=wire)
            for topo in sched.TOPOLOGIES:
                for pass_ in PASSES:
                    program = compile_program(pass_, topo, world, rf)
                    pl = plan(pass_, rf, program, b=b, n=n, n_kv=n_kv, s=s,
                              d=d, itemsize=TABLE_ITEMSIZE)
                    s_max = max_admitted_shard(pass_, rf, d=d)
                    pl_max = plan(pass_, rf, program, b=b, n=n, n_kv=n_kv,
                                  s=s_max, d=d, itemsize=TABLE_ITEMSIZE)
                    est = roofline(pass_, gen, program, layout="zigzag",
                                   b=b, n=n, n_kv=n_kv, s=s, d=d,
                                   causal=True, wire=wire,
                                   itemsize=TABLE_ITEMSIZE)
                    rows.append({
                        "generation": gen, "topology": topo,
                        "wire": wire, "pass": pass_,
                        "block_q": rf.block_q if pass_ == "fwd"
                        else rf.block_q_bwd,
                        "block_kv": rf.block_kv if pass_ == "fwd"
                        else rf.block_kv_bwd,
                        "slots": list(program.slots),
                        "n_rounds": program.n_rounds,
                        "gate_bytes": pl.gate_bytes,
                        "smem_bytes": pl.smem_bytes,
                        "slot_bytes": pl.slot_bytes,
                        "flag_words": pl.flag_words,
                        "item_words": pl.item_words,
                        "budget": rf.smem_budget,
                        "smem_limit": SMEM_LIMIT,
                        "max_shard_seq": s_max,
                        "smem_bytes_at_max": pl_max.smem_bytes,
                        "slot_bytes_at_max": pl_max.slot_bytes,
                        "fits": bool(pl.gate_bytes <= rf.smem_budget
                                     and pl.smem_bytes <= SMEM_LIMIT
                                     and pl_max.smem_bytes <= SMEM_LIMIT
                                     and pl.flag_words <= FLAG_BUDGET),
                        "flops": est.flops,
                        "hbm_bytes": est.hbm_bytes,
                        "ici_bytes": est.ici_bytes,
                        "t_compute_s": est.t_compute_s,
                        "t_comm_s": est.t_comm_s,
                    })
    ragged = []
    for cfgr in RAGGED_MATRIX:
        pb = ragged_plan_bytes(**cfgr)
        ragged.append({**cfgr, "d_head": TILE_D, "plan_bytes": pb,
                       "smem_limit": SMEM_LIMIT,
                       "fits": bool(pb <= SMEM_LIMIT)})
    ragged_hbm = []
    base = ragged_hbm_bytes(d_head=TILE_D, n_kv=n_kv, kv_len=s,
                            pool_dtype="fp32")
    for pool_dtype, eb in sorted(POOL_DTYPES.items()):
        hb = ragged_hbm_bytes(d_head=TILE_D, n_kv=n_kv, kv_len=s,
                              pool_dtype=pool_dtype)
        ragged_hbm.append({
            "d_head": TILE_D, "n_kv": n_kv, "kv_len": s,
            "pool_dtype": pool_dtype, "kv_elem_bytes": eb,
            "hbm_bytes": hb, "win_vs_fp32": base / hb,
        })
    return {
        "schema": "burstcost-v2",
        "world": world,
        "shape": shp,
        "hw": {g: {"peak_flops": h.peak_flops, "hbm_bw": h.hbm_bw,
                   "ici_bw": h.ici_bw} for g, h in sorted(HW.items())},
        "n_rows": len(rows),
        "rows": rows,
        "ragged": ragged,
        "ragged_hbm": ragged_hbm,
    }
