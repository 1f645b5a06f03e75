"""Fused ring forward (port of burst_attn_tpu/ops/fused_ring.py): the
whole R-round forward ring of W ring positions in ONE kernel launch, and
the program tables both fused ring kernels read.

The kernels hold no schedule logic of their own: they interpret a
compiled `RingProgram` (parallel/schedule.py), delivered per position as
an int32 op table whose rows say which (bank, slot) compute consumes,
whether its arrival must be awaited, which channels send (src bank/slot
-> the neighbour's dst slot), and the per-slot capacity credits.  One
kernel body runs every topology the compiler emits (uni, bidi, double).
`ring_plan(..., pass_="bwd")` builds the backward program's tables (the
q-side bundle rotates, the mask scalars swap roles, and the dq streams
add their own need columns) for ops/fused_ring_bwd.py.

`fused_ring_fwd` takes the positions' shards stacked, q [W,B,N,S,D] and
k, v [W,B,Nk,S,D] in layout order, and returns (o [W,B,N,S,D] in q's
dtype, lse [W,B,N,S] fp32).  A CUDA tensor launches csrc/fused_ring_fwd.cu
(bf16 or fp32, D = 128; every position on the one card, with the slot
banks in device memory and the rotation done by the kernel's own copies);
a CPU tensor runs `fused_ring_reference`, the plain version, which walks
the same program on the host and checks its deliveries and credits.

`fused_ring_fwd(..., collect_stats=True)` also returns the per-position
DevStats (obs/devstats.py): the kernel's STATS instance counts each
round's consume per (bank, slot) in device memory (the plain version
counts the same walk), and the occupancy comes from the table's mask
scalars, as in the JAX package.

Packed segments (`seg=`, the positions' ids stacked [W, B, S] int32 in
layout order): all positions share the card, so the stacked ids are the
JAX package's gathered side table (`gather_seg_table`).  Each table row
carries the partition the round consumes (its PART column, JAX's
`with_part`); the kernels' SEG instances read that partition's ids for
the rotating side and the position's own for the resident one.

A sliding `cfg.window` (contig causal rings): the tables carry each
round's offset-form band spec (masks.round_spec with the window), the
kernels' WIN instances test the band (the JAX kernels' static `wnd`),
and the schedule compiler truncates the program to the live rounds
{0 .. r_live - 1} (`occupancy_r_live`): a dead round has no send, no
consume and no slot traffic.

Wire payloads (`cfg.wire_dtype` "int8" | "fp8"): K and V are quantized
once before the launch per (batch, kv head) (parallel/ring.py
wire_quantize), the slot banks hold the 1-byte payload with its fp32
scales behind it in the same slot (no new slots, no extra slot writes),
and each round dequantizes its chunk to the compute dtype as it stages
it; a round of the position's own partition reads the resident
full-precision K and V, as the scan ring's self round does.  The kernel's
WIRE instances (bf16 / fp32, with STATS, SEG and WIN, the scratch state
mode only) and the plain version implement the same.
`collect_stats` reports quant_absmax = max(|k|, |v|) of each position.
"""

import ctypes
import functools
from typing import List, Optional

import numpy as np
import torch

from . import _build
from .flash import KERNEL_DTYPES, KERNEL_HEAD_DIMS, _check_kernel_operand
from .masks import (
    MaskSpec, live_round_prefix, round_spec, spec_live, spec_pair_count,
)
from .tile import finalize, init_state, tile_fwd
from .tuning import (
    FUSED_BLOCK_KV, FUSED_BLOCK_KV_BWD, FUSED_BLOCK_Q, FUSED_BLOCK_Q_BWD,
    fused_bwd_smem_bytes, fused_smem_bytes, resolve_fused,
)
from ..obs.devstats import MAX_SLOTS
from ..parallel import schedule as sched_ir
from ..parallel.ring import (
    ring_coords, ring_roles, wire_dequantize, wire_quantize,
)

# the kernels' wire codes (csrc/common.cuh kInt8, kFp8E4M3; 0 = dense)
WIRE_CODES = {None: 0, "int8": 2, "fp8": 3}

# the kernel's own per-round columns after the program's FWD_COLS: how
# many versions a slot must have received (the local copy-in is version
# 0) before the round's consume / each channel's send source may be read,
# and how many grants the dst slot must have had before a TAKE send
ARRIVE_NEED = sched_ir.FWD_COLS
SRC_NEED = (ARRIVE_NEED + 1, ARRIVE_NEED + 2)
TAKE_NEED = (ARRIVE_NEED + 3, ARRIVE_NEED + 4)
# the partition whose chunk the round consumes (the rotating side's ids)
PART = ARRIVE_NEED + 5
KERNEL_COLS = ARRIVE_NEED + 6
# the backward kernel's columns after the program's BWD_COLS: the same
# five for the bundle, then the dq streams' needs: the versions the dq
# slot consumed this round (DQ_RECV) and the held inter slot (DQI_RECV)
# must have received, and how many grants the dst slot of this round's dq
# send must have had when the send takes a credit
BWD_ARRIVE_NEED = sched_ir.BWD_COLS
BWD_SRC_NEED = (BWD_ARRIVE_NEED + 1, BWD_ARRIVE_NEED + 2)
BWD_TAKE_NEED = (BWD_ARRIVE_NEED + 3, BWD_ARRIVE_NEED + 4)
DQ_ARRIVE_NEED = BWD_ARRIVE_NEED + 5
DQI_ARRIVE_NEED = BWD_ARRIVE_NEED + 6
DQ_TAKE_NEED = BWD_ARRIVE_NEED + 7
BWD_PART = BWD_ARRIVE_NEED + 8
BWD_KERNEL_COLS = BWD_ARRIVE_NEED + 9

_SEND = (sched_ir.SEND0, sched_ir.SEND1)
_SRC_SLOT = (sched_ir.SRC_SLOT0, sched_ir.SRC_SLOT1)
_DST_SLOT = (sched_ir.DST_SLOT0, sched_ir.DST_SLOT1)
_TAKE = (sched_ir.TAKE0, sched_ir.TAKE1)
_GRANT = (sched_ir.GRANT0, sched_ir.GRANT1)
_META_DST = (sched_ir.META_CH0_DST, sched_ir.META_CH1_DST)


def resolve_topology(cfg, n_intra: int, n_inter: int = 1):
    """(topology, n_inter, n_intra) the fused kernel runs for cfg: a real
    inter axis (or cfg.fused_seq_factor on a flat ring) selects the
    double ring; `fused_topology="bidi"` opts a flat ring of >= 3 into the
    counter-rotating schedule; default is uni."""
    if cfg.fused_seq_factor is not None:
        f_i, f_s = cfg.fused_seq_factor
        if n_inter > 1:
            raise ValueError("fused_seq_factor is for flat ring axes; this "
                             "config already has an inter axis")
        if f_i * f_s != n_intra:
            raise ValueError(
                f"fused_seq_factor {cfg.fused_seq_factor} does not tile the "
                f"ring axis ({n_intra} positions)")
        return ("double", f_i, f_s) if f_i > 1 else ("uni", 1, n_intra)
    if n_inter > 1:
        return "double", n_inter, n_intra
    topo = cfg.fused_topology
    if topo in ("auto", "uni", "double"):
        # double without an inter axis or a factor: nothing to nest
        return "uni", 1, n_intra
    if topo == "bidi":
        return ("bidi" if n_intra >= 3 else "uni"), 1, n_intra
    raise ValueError(f"unknown fused_topology {topo!r}")


def occupancy_r_live(cfg, world: int, s) -> Optional[int]:
    """Live-round prefix to truncate the program to, or None for a dense
    program: windowed contig causal rings, and those whose packed segments
    are bounded by cfg.max_segment_len, have the closed-form live set
    {0..r_live-1} (masks.live_round_prefix; JAX fused_ring.py l.173)."""
    if s is None or (cfg.window is None and cfg.max_segment_len is None):
        return None
    r_live = live_round_prefix(cfg.layout, s, world, causal=cfg.causal,
                               window=cfg.window,
                               max_segment_len=cfg.max_segment_len)
    return None if r_live >= world else r_live


def _resolve(cfg):
    return resolve_fused(cfg.fused_block_q, cfg.fused_block_kv,
                         cfg.fused_kv_slots,
                         block_q_bwd=cfg.fused_block_q_bwd,
                         block_kv_bwd=cfg.fused_block_kv_bwd,
                         bwd_slots=cfg.fused_bwd_slots,
                         ccw_slots=cfg.fused_ccw_slots,
                         bwd_ccw_slots=cfg.fused_bwd_ccw_slots,
                         wire_dtype=cfg.wire_dtype)


@functools.lru_cache(maxsize=64)
def _compile_for(cfg, topology: str, n_inter: int, n_intra: int,
                 pass_: str = "fwd", s=None):
    rf = _resolve(cfg)
    # a double ring visits its partitions cycle-major: round r's chunk is
    # not the one r positions back, so a prefix of its rounds is not the
    # live set, and its program stays dense (as the scan ring keeps double
    # rings untruncated, parallel/burst.py _r_live)
    r_live = (None if topology == "double"
              else occupancy_r_live(cfg, n_inter * n_intra, s))
    if pass_ == "fwd":
        return sched_ir.compile_fwd(topology, n_intra, n_inter,
                                    slots=rf.kv_slots, slots1=rf.ccw_slots,
                                    r_live=r_live)
    return sched_ir.compile_bwd(topology, n_intra, n_inter,
                                slots=rf.bwd_slots, slots1=rf.bwd_ccw_slots,
                                dq_slots=rf.bwd_slots, r_live=r_live)


def supported(cfg, q_shape, k_shape, has_segments: bool = False, *,
              world: int, n_inter: int = 1, pass_: str = "fwd",
              dtype=None, device=None, spans_processes: bool = False
              ) -> Optional[str]:
    """None if the fused ring can run this config, else the reason (the
    JAX package's reason prefixes; the TPU's VMEM plan is this card's
    shared-memory plan).  `pass_` ("fwd" | "bwd") selects which kernel's
    gate: the backward compiles its own program (a truncated one needs
    r_live >= 2) and has its own tiles.  Shapes are PER POSITION; `world`
    is the ring axis size (the intra size of a double ring), `n_inter`
    the inter axis size.  With `device` cuda the kernel's own limits
    apply (bf16 / fp32, head dim 128); the plain version on the CPU takes
    any.  Packed segments (`has_segments`) run on both kernels' SEG
    instances: they decline nothing.  A ring whose inter axis spans
    processes (`spans_processes`) is declined: both kernels hold all W
    positions in one launch through a per-position address table in
    this process's memory (across processes: ROADMAP A7b)."""
    del has_segments
    if pass_ not in ("fwd", "bwd"):
        raise ValueError(f"pass_ must be 'fwd' or 'bwd', got {pass_!r}")
    if spans_processes:
        return ("ring axis spans processes: the fused kernels address "
                "every position's slot banks in this process's memory "
                "(ROADMAP A7b)")
    b, n, s, d = q_shape
    if k_shape[2] != s:
        return "cross-attention shard lengths"
    if world * n_inter < 2:
        return "world < 2 (nothing to rotate)"
    try:
        topology, t_inter, t_intra = resolve_topology(cfg, world, n_inter)
    except ValueError as e:
        return f"topology config invalid: {e}"
    try:
        _compile_for(cfg, topology, t_inter, t_intra, pass_, s=s)
    except sched_ir.ScheduleError as e:
        return f"schedule compiler declined: {e}"
    rf = _resolve(cfg)
    if device is not None and torch.device(device).type == "cuda":
        if d not in KERNEL_HEAD_DIMS:
            return f"head dim {d}: the kernel takes {KERNEL_HEAD_DIMS}"
        if dtype not in KERNEL_DTYPES:
            return f"dtype {dtype}: the kernel takes {list(KERNEL_DTYPES)}"
    if pass_ == "fwd":
        tiles = (rf.block_q, rf.block_kv)
        fixed = (FUSED_BLOCK_Q, FUSED_BLOCK_KV)
        smem = fused_smem_bytes(*tiles, d)
    else:
        tiles = (rf.block_q_bwd, rf.block_kv_bwd)
        fixed = (FUSED_BLOCK_Q_BWD, FUSED_BLOCK_KV_BWD)
        smem = fused_bwd_smem_bytes(*tiles, d)
    if tiles != fixed:
        return (f"shared-memory plan: the {pass_} kernel's tiles are "
                f"{fixed[0]} x {fixed[1]} rows, got {tiles[0]} x {tiles[1]}")
    if smem > rf.smem_budget:
        return (f"shared-memory plan {smem} bytes exceeds the fused budget "
                f"{rf.smem_budget}")
    return None


def kernel_statics(prog):
    """The compiled program's static structure: which banks are consumed,
    which channels send (and from which src banks), where credits flow."""
    rows = prog.rows
    R = prog.n_rounds
    consume_banks = tuple(sorted({rows["consume_bank"][r] for r in range(R)}))
    ch_active = tuple(ch for ch in range(prog.n_banks)
                      if any(rows[f"send{ch}"][r] for r in range(R)))
    src_banks0 = tuple(sorted({rows["src_bank0"][r] for r in range(R)
                               if rows["send0"][r]})) or (0,)
    grant_banks = tuple(b for b in range(prog.n_banks)
                        if any(rows[f"grant{b}"][r] for r in range(R)))
    take_chs = tuple(ch for ch in ch_active
                     if any(rows[f"take{ch}"][r] for r in range(R)))
    return dict(consume_banks=consume_banks, ch_active=ch_active,
                src_banks0=src_banks0, grant_banks=grant_banks,
                take_chs=take_chs)


def build_sched_table(cfg, prog, s_q: int, s_kv: int, position: int, *,
                      swap_roles: bool = False):
    """The [R + 1, FWD_COLS|BWD_COLS] int32 table of one ring position:
    per round the mask-spec scalars (the partition the round holds comes
    from the program's rotation applied to the position's ring
    coordinates) beside the program's op columns, then the META row of
    neighbour positions (ring_roles).  `swap_roles` builds backward
    specs (the rotating payload is the q side).  Returns (table, specs)."""
    inter_rank, intra_rank = ring_coords(position, prog.n_inter,
                                         prog.n_intra)
    table = prog.to_table()
    specs = []
    for r in range(prog.n_rounds):
        part_r = sched_ir.partition_for_round(prog, r, inter_rank,
                                              intra_rank)
        if swap_roles:
            sp = round_spec(part_r, position, s_q, s_kv, cfg.causal,
                            cfg.layout, window=cfg.window)
        else:
            sp = round_spec(position, part_r, s_q, s_kv, cfg.causal,
                            cfg.layout, window=cfg.window)
        specs.append(sp)
        table[r, :5] = sp
    roles = ring_roles(position, prog.n_inter, prog.n_intra,
                       prog.home_offsets)
    dirs = prog.channels
    meta = [roles["me"], roles[f"{dirs[0]}_dst"], roles[f"{dirs[0]}_src"]]
    if len(dirs) > 1:
        meta += [roles[f"{dirs[1]}_dst"], roles[f"{dirs[1]}_src"]]
    else:
        meta += [0, 0]
    meta += [roles.get(f"home{j}", 0) for j in range(2)]
    meta_row = np.zeros((1, table.shape[1]), np.int32)
    meta_row[0, :len(meta)] = meta
    return np.concatenate([table, meta_row]).astype(np.int32), specs


def kernel_table(prog, table: np.ndarray) -> np.ndarray:
    """One position's table with the kernel's need columns appended after
    the program's own ([R + 1, KERNEL_COLS] forward, [R + 1,
    BWD_KERNEL_COLS] backward, whose dq columns kernel_table_bwd fills).
    A slot's versions: its copy-in, then one per remote write; a write at
    round t is awaited by reads at rounds > t.  The PART column (the
    consumed partition) is ring_plan's to fill."""
    rows, R = prog.rows, prog.n_rounds
    base = table.shape[1]
    arrive_need, src_need, take_need = base, (base + 1, base + 2), \
        (base + 3, base + 4)
    writes = {}  # (bank, slot) -> rounds of the remote writes into it
    for r in range(R):
        for ch in range(2):
            if rows[f"send{ch}"][r]:
                writes.setdefault((ch, rows[f"dst_slot{ch}"][r]), []).append(r)

    def versions(bank, slot, r):
        return (int((bank, slot) in prog.copy_in)
                + sum(t < r for t in writes.get((bank, slot), ())))

    ncol = BWD_KERNEL_COLS if prog.kind == "bwd" else KERNEL_COLS
    out = np.zeros((R + 1, ncol), np.int32)
    out[:, :base] = table
    takes = {}
    for r in range(R):
        out[r, arrive_need] = versions(rows["consume_bank"][r],
                                       rows["consume_slot"][r], r)
        for ch in range(2):
            if not rows[f"send{ch}"][r]:
                continue
            src_bank = rows["src_bank0"][r] if ch == 0 else 1
            out[r, src_need[ch]] = versions(src_bank, rows[f"src_slot{ch}"][r],
                                            r)
            if rows[f"take{ch}"][r]:
                key = (ch, rows[f"dst_slot{ch}"][r])
                takes[key] = takes.get(key, 0) + 1
                out[r, take_need[ch]] = takes[key]
    return out


def dq_send_target(row):
    """(kind, bank, dst slot, meta column of the receiver) of the dq send
    of one backward table row.  The banks of the dq streams: each ring
    direction owns one (uni: 0; bidi: cw 0, ccw 1), and the double ring's
    held inter partials (its dqi slots) are bank 1.  RING hops to the
    bank's direction neighbour, BOUNDARY one inter step into a dqi slot,
    HOME and FINAL to the owner's home output of the bank (dst slot -1)."""
    kind, bank = int(row[sched_ir.DQ_SEND]), int(row[sched_ir.DQ_BANK])
    if kind == sched_ir.DQ_RING:
        return kind, bank, int(row[sched_ir.DQ_DST_SLOT]), _META_DST[bank]
    if kind == sched_ir.DQ_BOUNDARY:
        return (kind, 1, int(row[sched_ir.DQI_DST_SLOT]),
                sched_ir.META_CH1_DST)
    if kind in (sched_ir.DQ_HOME, sched_ir.DQ_FINAL):
        b = 0 if kind == sched_ir.DQ_FINAL else bank
        return kind, b, -1, (sched_ir.META_HOME0, sched_ir.META_HOME1)[b]
    return kind, bank, -1, -1


def kernel_table_bwd(prog, table: np.ndarray) -> np.ndarray:
    """One position's backward table ([R + 1, BWD_KERNEL_COLS]) with the
    kernel's need columns: the bundle's (kernel_table) and the dq
    streams'.  A dq slot's versions are the remote writes into it (no
    copy-in); a write at round t is awaited by a consume at a round > t.
    The take need counts the takes of the send's dst slot so far."""
    out = kernel_table(prog, table)
    rows, R = prog.rows, prog.n_rounds
    writes = {}  # (dq bank, slot) -> rounds of the remote writes into it
    for r in range(R):
        kind, bank, slot, _ = dq_send_target(table[r])
        if slot >= 0:
            writes.setdefault((bank, slot), []).append(r)
    takes = {}
    for r in range(R):
        if rows["dq_recv"][r]:
            out[r, DQ_ARRIVE_NEED] = sum(
                t < r for t in writes.get((rows["dq_bank"][r],
                                           rows["dq_slot"][r]), ()))
        if rows["dqi_recv"][r]:
            out[r, DQI_ARRIVE_NEED] = sum(
                t < r for t in writes.get((1, rows["dqi_slot"][r]), ()))
        kind, bank, slot, _ = dq_send_target(table[r])
        if slot >= 0 and rows[f"dq_take{bank}"][r]:
            takes[(bank, slot)] = takes.get((bank, slot), 0) + 1
            out[r, DQ_TAKE_NEED] = takes[(bank, slot)]
    return out


@functools.lru_cache(maxsize=64)
def ring_plan(cfg, n_inter: int, n_intra: int, s: int, pass_: str = "fwd"):
    """(program, per-position op tables, stacked kernel tables [W, R + 1,
    KERNEL_COLS | BWD_KERNEL_COLS]) of the forward ring, or with pass_
    "bwd" of the backward ring (its tables built with swapped roles: the
    q-side bundle rotates past the resident K/V), for cfg on W = n_inter *
    n_intra positions of s rows each.  They depend on nothing else, so
    they are built once per (cfg, ring, s, pass) and kept read-only."""
    topology, t_inter, t_intra = resolve_topology(cfg, n_intra, n_inter)
    prog = _compile_for(cfg, topology, t_inter, t_intra, pass_, s=s)
    bwd = pass_ == "bwd"
    tables = tuple(build_sched_table(cfg, prog, s, s, p, swap_roles=bwd)[0]
                   for p in range(n_inter * n_intra))
    to_kernel = kernel_table_bwd if bwd else kernel_table
    sched = np.stack([to_kernel(prog, t) for t in tables])
    part = BWD_PART if bwd else PART
    for p in range(n_inter * n_intra):
        coords = ring_coords(p, prog.n_inter, prog.n_intra)
        sched[p, :prog.n_rounds, part] = [
            sched_ir.partition_for_round(prog, r, *coords)
            for r in range(prog.n_rounds)]
    for t in tables + (sched,):
        t.flags.writeable = False
    return prog, tables, sched


@functools.lru_cache(maxsize=64)
def _sched_on(cfg, n_inter: int, n_intra: int, s: int, device,
              pass_: str = "fwd"):
    """ring_plan's kernel tables on `device`, copied there once."""
    return torch.from_numpy(
        ring_plan(cfg, n_inter, n_intra, s, pass_)[2].copy()).to(device)


def fused_ring_fwd(q, k, v, cfg, n_inter: int, n_intra: int, *,
                   collect_stats: bool = False, seg=None):
    """Forward burst attention of all W = n_inter * n_intra ring positions
    through the fused ring: q [W,B,N,S,D], k/v [W,B,Nk,S,D] (position p's
    shard at index p, layout order) -> (o [W,B,N,S,D] in q.dtype, lse
    [W,B,N,S] f32), plus the ring's DevStats (leading axis W) when
    `collect_stats`: o and lse are bitwise those of the stats-off call.
    Callers check `supported` first.  A CUDA tensor launches the kernel
    (its STATS instance when collecting; its SEG instance with `seg`, the
    positions' packed-sequence ids [W,B,S] integers in layout order); a
    CPU tensor runs fused_ring_reference."""
    w, b, n, s, d = q.shape
    if w != n_inter * n_intra:
        raise ValueError(f"{w} stacked shards for a {n_inter}x{n_intra} "
                         "ring")
    if k.shape[:2] != (w, b) or k.shape[3:] != (s, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if n % k.shape[2]:
        raise ValueError(f"GQA needs Nq % Nk == 0, got {n} % {k.shape[2]}")
    seg = seg_table(seg, w, b, s, q.device)
    prog, tables, _ = ring_plan(cfg, n_inter, n_intra, s, "fwd")
    scale = cfg.scale if cfg.scale is not None else d ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ring_fwd runs on cuda or cpu tensors, got "
                         f"{q.device}")
    slot_use = _slot_counters(prog, w, q.device) if collect_stats else None
    wire = cfg.wire_dtype
    if q.device.type == "cpu":
        o, lse = fused_ring_reference(q, k, v, prog, tables, scale,
                                      slot_use=slot_use, seg=seg,
                                      window=cfg.window, wire=wire)
    else:
        o, lse = _fused_ring_fwd_cuda(
            q, k, v, prog,
            _sched_on(cfg, n_inter, n_intra, s, q.device, "fwd"), scale,
            slot_use=slot_use, seg=seg, window=cfg.window, wire=wire)
    if not collect_stats:
        return o, lse
    from ..parallel.burst import quant_absmax

    return o, lse, _fused_stats(cfg, n_inter, n_intra, prog, o, lse,
                                slot_use, s, d, quant_absmax(k, v, wire))


def seg_table(seg, w: int, b: int, s: int, device):
    """The positions' segment ids as both fused kernels take them: one
    contiguous int32 table [W, B, S] on `device` (None stays None)."""
    if seg is None:
        return None
    if tuple(seg.shape) != (w, b, s):
        raise ValueError(f"seg has shape {tuple(seg.shape)}, expected "
                         f"{(w, b, s)}")
    if seg.is_floating_point() or seg.is_complex():
        raise ValueError(f"seg must be integers, got {seg.dtype}")
    return seg.to(device=device, dtype=torch.int32).contiguous()


def _slot_counters(prog, w: int, device):
    """Zeroed [W, 2, MAX_SLOTS] int32 slot counters of a STATS launch."""
    if max(prog.slots) > MAX_SLOTS:
        raise ValueError(f"collect_stats counts at most {MAX_SLOTS} slots a "
                         f"bank, the program has {max(prog.slots)}")
    return torch.zeros((w, 2, MAX_SLOTS), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=64)
def _occupancy(cfg, n_inter: int, n_intra: int, s: int):
    """(live rounds, attended pairs) of each position's forward program:
    host numbers from the tables' per-round mask scalars, made once per
    (cfg, ring, s) like the plan itself."""
    prog, tables, _ = ring_plan(cfg, n_inter, n_intra, s, "fwd")
    live, pairs = [], []
    for table in tables:
        specs = [MaskSpec(*(int(x) for x in table[r, :5]))
                 for r in range(prog.n_rounds)]
        live.append(sum(spec_live(sp, cfg.window) for sp in specs))
        pairs.append(sum(spec_pair_count(sp, s, s, window=cfg.window)
                         for sp in specs))
    return tuple(live), tuple(pairs)


def _fused_stats(cfg, n_inter: int, n_intra: int, prog, o, lse, slot_use,
                 s: int, d: int, qam=0.0):
    """The fused forward's DevStats (the JAX package's
    fused_ring_fwd(collect_stats=True)): occupancy and liveness from the
    tables' per-round mask scalars, every scheduled round executed in the
    kernel, m never leaves it (-inf), the kernel's slot counters."""
    from ..obs import devstats

    live, pairs = _occupancy(cfg, n_inter, n_intra, s)
    n_rounds = prog.n_rounds
    return devstats.ring_stats_all(
        rounds=n_rounds, rounds_live=live, attn_pairs=pairs,
        total_pairs=float(n_rounds) * s * s, head_dim=d, m=None, lse=lse,
        acc=o, fused_rounds=n_rounds, rounds_elided=prog.world - n_rounds,
        slot_use=slot_use[:, 0],
        slot_use_ccw=slot_use[:, 1] if prog.n_banks > 1 else None,
        quant_absmax=qam)


fused_ring_fwd.launches = 0
fused_ring_fwd.seg_launches = 0  # the launches of the SEG instances
fused_ring_fwd.win_launches = 0  # the launches of the WIN instances
fused_ring_fwd.wire_launches = 0  # the launches of the WIRE instances


class _Slot:
    """One version of a slot in the plain version's banks."""

    def __init__(self, k, v, part, remote):
        self.k, self.v, self.part = k, v, part
        self.remote = remote  # written by a neighbour's send, not copy-in
        self.reads = 0        # consumes and send-source reads
        self.consumed = False


def _copy(x):
    """A slot payload's copy: a tensor, or a (payload, scale) pair."""
    return tuple(t.clone() for t in x) if isinstance(x, tuple) else x.clone()


def fused_ring_reference(q, k, v, prog, tables: List[np.ndarray], scale,
                         slot_use=None, seg=None, window=None, wire=None):
    """Plain version of the fused kernel: walks the compiled program on
    the host with every position's slot banks as tensors, in the kernel's
    order per round (sends at the round's start, then each position's
    consume, then the grants), and computes each round with tile_fwd
    under the table's mask scalars, finalize at the end.  It asserts what
    the kernel relies on: each consume finds the partition the rotation
    says and an arrival exactly when RECV is set, a send reuses a slot only
    with a granted credit after its last version was read, and every
    credit granted is taken.  Same contract as fused_ring_fwd; a
    `slot_use` [W, 2, MAX_SLOTS] int32 tensor counts each round's consume
    per (position, bank, slot), as the kernel's STATS instance does.
    `seg` [W, B, S]: the positions' segment ids; a round masks by the
    position's own ids against the consumed partition's.  `window`: the
    band every round's tile applies beside the table's scalars.  `wire`
    ("int8" | "fp8"): the slots hold (payload, scale) pairs of K and V
    quantized per (batch, kv head) before the walk; a consume dequantizes
    to q's dtype, and a round of the position's own partition reads the
    resident k[p], v[p], as the kernel does."""
    w = q.shape[0]
    n_rounds = prog.n_rounds
    st = kernel_statics(prog)
    banks = [[[None] * prog.slots[bk] for bk in range(prog.n_banks)]
             for _ in range(w)]
    credits = [[[0] * prog.slots[bk] for bk in range(prog.n_banks)]
               for _ in range(w)]
    if wire is None:
        k_in, v_in = k, v
    else:
        k_in = list(zip(*wire_quantize(k, wire, (3, 4))))
        v_in = list(zip(*wire_quantize(v, wire, (3, 4))))
    for p in range(w):
        for cb, cs in prog.copy_in:
            banks[p][cb][cs] = _Slot(_copy(k_in[p]), _copy(v_in[p]), p,
                                     False)
    state = [init_state(*q.shape[1:], device=q.device) for _ in range(w)]
    for r in range(n_rounds):
        for p in range(w):
            row, meta = tables[p][r], tables[p][n_rounds]
            for ch in range(2):
                if not row[_SEND[ch]]:
                    continue
                assert ch in st["ch_active"]
                src_bank = row[sched_ir.SRC_BANK0] if ch == 0 else 1
                src = banks[p][src_bank][row[_SRC_SLOT[ch]]]
                assert src is not None, (p, r, "send from an empty slot")
                src.reads += 1
                dst, ds = int(meta[_META_DST[ch]]), int(row[_DST_SLOT[ch]])
                old = banks[dst][ch][ds]
                if old is None:
                    assert not row[_TAKE[ch]], (p, r, "take on a fresh slot")
                else:
                    assert row[_TAKE[ch]], (p, r, "slot reused without a take")
                    assert credits[dst][ch][ds] > 0, (
                        p, r, f"take of slot {ch}/{ds} before its grant")
                    assert old.reads > 0, (p, r, "overwrite before read")
                    credits[dst][ch][ds] -= 1
                banks[dst][ch][ds] = _Slot(_copy(src.k), _copy(src.v),
                                           src.part, True)
        for p in range(w):
            row = tables[p][r]
            cb = int(row[sched_ir.CONSUME_BANK])
            slot = banks[p][cb][int(row[sched_ir.CONSUME_SLOT])]
            ii, si = ring_coords(p, prog.n_inter, prog.n_intra)
            want = sched_ir.partition_for_round(prog, r, ii, si)
            assert slot is not None and slot.part == want, (
                p, r, "wrong partition delivered")
            assert bool(row[sched_ir.RECV]) == (slot.remote
                                                and not slot.consumed), (
                p, r, "arrival and RECV disagree")
            slot.reads += 1
            slot.consumed = True
            if slot_use is not None:
                slot_use[p, cb, int(row[sched_ir.CONSUME_SLOT])] += 1
            spec = MaskSpec(*(int(x) for x in row[:5]))
            segs = None if seg is None else (seg[p], seg[slot.part])
            if wire is None:
                kk, vv = slot.k, slot.v
            elif slot.part == p:  # the own partition: the resident chunk
                kk, vv = k[p], v[p]
            else:
                kk = wire_dequantize(*slot.k, q.dtype)
                vv = wire_dequantize(*slot.v, q.dtype)
            state[p] = tile_fwd(q[p], kk, vv, *state[p], scale, spec,
                                window=window, segments=segs)
        for p in range(w):
            row = tables[p][r]
            for bk in range(prog.n_banks):
                if row[_GRANT[bk]]:
                    credits[p][bk][int(row[_GRANT[bk]]) - 1] += 1
    assert not any(c for pos in credits for bank in pos for c in bank), (
        "credits granted but never taken")
    o = torch.stack([finalize(*state[p], q.dtype) for p in range(w)])
    lse = torch.stack([state[p][1] for p in range(w)])
    return o, lse


def wire_pack(x, wire, axes):
    """x quantized by wire_quantize over `axes` and packed per position as
    kernel 8's slots hold it: uint8 [W, payload bytes + the fp32 scales,
    padded to 16 bytes]."""
    xq, sc = wire_quantize(x, wire, axes)
    w = x.shape[0]
    payload = xq.view(torch.uint8).reshape(w, -1)
    scales = sc.reshape(w, -1).contiguous().view(torch.uint8)
    n = payload.shape[1] + scales.shape[1]
    out = torch.zeros((w, -(-n // 16) * 16), dtype=torch.uint8,
                      device=x.device)
    out[:, :payload.shape[1]] = payload
    out[:, payload.shape[1]:n] = scales
    return out


def _fused_ring_fwd_cuda(q, k, v, prog, sched, scale, slot_use=None,
                         seg=None, window=None, wire=None):
    dev = q.device
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_ring_fwd kernel takes "
                         f"{list(KERNEL_DTYPES)}, got {q.dtype}")
    w, b, n, s, d = q.shape
    n_kv = k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_ring_fwd kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, t, dev, q.dtype)
    lib = _build.load("fused_ring_fwd")
    code = KERNEL_DTYPES[q.dtype]
    cap = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _build.check(lib.fused_ring_fwd_capacity(
            d, code, int(seg is not None), int(window is not None),
            int(wire is not None), ctypes.byref(cap)),
            "fused_ring_fwd capacity")
    n_items = b * n * -(-s // FUSED_BLOCK_Q)
    per_pos = cap.value // w
    if per_pos < 1:
        raise RuntimeError(f"the card keeps {cap.value} fused-ring CTAs "
                           f"resident, fewer than the {w} positions")
    ctas = min(per_pos, n_items)
    # the WIRE instances keep the state in the scratch (no RESIDENT one)
    resident = n_items <= per_pos and wire is None
    n_banks, max_slots = prog.n_banks, max(prog.slots)
    if wire is None:
        kq_in = vq_in = None
        slot_bytes = 0
        kbanks = [torch.empty((w, prog.slots[bk], b, n_kv, s, d),
                              dtype=q.dtype, device=dev)
                  for bk in range(n_banks)]
    else:  # a slot: the 1-byte chunk, then its (batch, kv head) scales
        kq_in = wire_pack(k, wire, (3, 4))
        vq_in = wire_pack(v, wire, (3, 4))
        slot_bytes = kq_in.shape[1]
        kbanks = [torch.empty((w, prog.slots[bk], slot_bytes),
                              dtype=torch.uint8, device=dev)
                  for bk in range(n_banks)]
    vbanks = [torch.empty_like(t) for t in kbanks]
    # per position: arrival and credit counters per (bank, slot), per
    # round a done counter and the items taken, then (items dealt from the
    # counters) each item's count of rounds whose state is written
    flags = torch.zeros((w, 2 * n_banks * max_slots + 2 * prog.n_rounds
                         + (0 if resident else n_items)),
                        dtype=torch.int32, device=dev)
    ptrs = torch.tensor(
        [[t.data_ptr() + p * t.stride(0) * t.element_size()
          for t in kbanks + vbanks]
         + [flags.data_ptr() + p * flags.stride(0) * 4] for p in range(w)],
        dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    if resident:
        st_m = st_l = st_acc = None
    else:
        f32 = dict(dtype=torch.float32, device=dev)
        st_m = torch.empty((w, b, n, s), **f32)
        st_l = torch.empty((w, b, n, s), **f32)
        st_acc = torch.empty((w, b, n, s, d), **f32)
    o = torch.empty_like(q)
    lse = torch.empty((w, b, n, s), dtype=torch.float32, device=dev)
    copy_in = [bk * 16 + sl + 1 for bk, sl in prog.copy_in] + [0, 0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fused_ring_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptrs.data_ptr(),
            sched.data_ptr(), _ptr(st_m), _ptr(st_l), _ptr(st_acc),
            o.data_ptr(), lse.data_ptr(), w, b, n, n_kv, s, d,
            prog.n_rounds, n_banks, max_slots, ctas, KERNEL_COLS,
            copy_in[0], copy_in[1], code, int(resident), _ptr(slot_use),
            _ptr(seg), 0 if window is None else int(window), float(scale),
            stream, _ptr(kq_in), _ptr(vq_in), WIRE_CODES[wire], slot_bytes)
    _build.check(err, "fused_ring_fwd")
    fused_ring_fwd.launches += 1
    fused_ring_fwd.seg_launches += seg is not None
    fused_ring_fwd.win_launches += window is not None
    fused_ring_fwd.wire_launches += wire is not None
    return o, lse


def _ptr(t):
    return None if t is None else t.data_ptr()


def fwd_attrs(stats: bool = False, seg: bool = False, win: bool = False,
              wire: bool = False):
    """_build.kernel_attrs of kernel 8's four instances (dtype x state
    mode), or with `stats` of the four STATS instances (labels end in
    " stats"), with `seg` of the SEG instances (" seg" after that), with
    `win` of the WIN instances (" win"), with `wire` of the WIRE instances
    (" wire" last; the scratch state mode only)."""
    return _build.kernel_attrs("fused_ring_fwd", {
        f"{name}{'' if res else ' scratch'}{' stats' if stats else ''}"
        f"{' seg' if seg else ''}{' win' if win else ''}"
        f"{' wire' if wire else ''}":
            (code, int(res) | (2 if stats else 0) | (4 if seg else 0)
             | (8 if win else 0) | (16 if wire else 0))
        for name, code in (("bf16", KERNEL_DTYPES[torch.bfloat16]),
                           ("fp32", KERNEL_DTYPES[torch.float32]))
        for res in ((False,) if wire else (True, False))})

