"""Fused ring backward (port of burst_attn_tpu/ops/fused_ring_bwd.py): the
whole R-round backward ring of W ring positions in ONE kernel launch.

Roles flip against the forward (ops/fused_ring.py): each position's K and
V stay resident and its fp32 dk, dv accumulate where they are, while the
q-side BUNDLE (delta, do, q, lse) -- or (o, do, q, lse) without
`optimize_bwd_comm`, delta then recomputed per tile -- rotates exactly like
the forward's KV, and the dq partials ride accumulating rings one hop
behind their bundles.  The kernel interprets the compiled backward
program (parallel/schedule.compile_bwd) through the tables of
`fused_ring.ring_plan(..., pass_="bwd")`: the bundle's bank/slot/send/
credit columns, and per round the dq plan -- which dq ring the round's
contribution folds into, whether a partial arrives, and the send kind:

  RING      onward hop to the bank's direction neighbour
  HOME      the direction's last round: the finished partial goes to its
            owner's home output (`home_offsets` away)
  BOUNDARY  double ring, end of a non-final cycle: fold the held inter
            partial and hop the sum one inter step into a dqi slot
  FINAL     double ring, end of the last cycle: fold and go home

`fused_ring_bwd` takes the stacked shards q, o, do [W,B,N,S,D], k, v
[W,B,Nk,S,D] and lse [W,B,N,S] fp32 (the forward's residuals, layout
order) and returns fp32 (dq, dk, dv) [W,...]; a bidi ring's owner gets
its gradient as two complementary partials (one per direction), summed
here as the JAX package sums them outside its kernel.  A CUDA tensor
launches csrc/fused_ring_bwd.cu; a CPU tensor runs
`fused_ring_bwd_reference`, the plain version, which walks the same
program on the host and checks its deliveries and credits.
`collect_stats=True` adds the bundle slot-consume counters (the kernel's
STATS instance; DevStats.slot_use_bwd), on the direct call only: the
autograd path leaves slot_use_bwd at zero, as in the JAX package.
`seg=` (the positions' packed-sequence ids [W, B, S], as
fused_ring.fused_ring_fwd's): each round masks the bundle's q ids (the
table's BWD_PART column names its partition) against the position's own
kv ids, in the kernel's SEG instance.  A `cfg.window` runs the kernel's
WIN instances (alone or with SEG) on the truncated program of the
windowed ring (ops/fused_ring.py); the STATS instance takes no window
(`collect_stats` with a window raises on the card, as with seg).

Wire payloads (`cfg.wire_dtype` "int8" | "fp8"): the bundle is quantized
once at entry, as the scan ring does it (first, do, q per (batch, head);
lse stays fp32, the three scale vectors riding behind it in its slot),
and every dq partial travels quantized with a fresh scale per (batch,
head, 64-row q tile), the kernel's own q tile: the sender sums and
re-quantizes it, the receiver dequantizes it before it folds (the folds
stay fp32), and the home outputs arrive quantized and are dequantized
here.  The kernel's WIRE instances (bf16 / fp32, with SEG and WIN) and
the plain version implement the same; STATS or a trace with a wire dtype
raise on the card.
"""

import ctypes
from typing import List, Optional

import numpy as np
import torch

from . import _build
from .flash import KERNEL_DTYPES, KERNEL_HEAD_DIMS, _check_kernel_operand
from .fused_ring import (
    _DST_SLOT, _GRANT, _META_DST, _SEND, _SRC_SLOT, _TAKE,
    BWD_KERNEL_COLS, dq_send_target, kernel_statics,
    ring_plan, seg_table, _sched_on, _slot_counters,
)
from .masks import MaskSpec
from .tile import tile_bwd
from .tuning import FUSED_BLOCK_KV_BWD, FUSED_BLOCK_Q_BWD
from ..parallel import schedule as sched_ir
from ..parallel.ring import (
    WIRE_TORCH, ring_coords, wire_dequantize, wire_quantize,
)
from .fused_ring import WIRE_CODES

# per position, the kernel's table of device addresses: the four bundle
# operands of each of two banks, the two dq banks, the two home outputs,
# the flag words (csrc/fused_ring_bwd.cu kNPtr)
_N_PTRS = 13
# a traced launch's record per CTA (csrc/fused_ring_bwd.cu kTraceCols):
# %globaltimer at its start and end, ns its thread 0 waited on dq fold
# counters and on the ring's counters, its items and (q tile, kv tile)
# steps, its SM, its ring position, then the clock64 cycles of the steps'
# parts: the tiles' landing and the row statistics, S^T and dP^T with
# their exchange, P and dS as fragments, dV and dK, the dS^T store, dQ,
# the fold's wait and reductions, its count (barrier, fence, atomic)
TRACE_COLS = ("t0_ns", "t1_ns", "fold_wait_ns", "phase_wait_ns", "items",
              "steps", "sm", "position", "cyc_land", "cyc_s_dp", "cyc_p_ds",
              "cyc_dkdv", "cyc_ds_store", "cyc_dq", "cyc_fold",
              "cyc_publish")


def bwd_statics(prog):
    """The static dq plan of a compiled backward program that the kernel's
    outputs depend on: {dq bank: round of its home send}, one entry per
    home output (the HOME send of each ring direction, or the double
    ring's FINAL return into bank 0)."""
    rows = prog.rows
    home_rounds = {}
    for r in range(prog.n_rounds):
        if rows["dq_send"][r] == sched_ir.DQ_HOME:
            home_rounds[rows["dq_bank"][r]] = r
        elif rows["dq_send"][r] == sched_ir.DQ_FINAL:
            home_rounds[0] = r
    return home_rounds


def dq_bank_slots(prog):
    """Slots of the two dq banks: the ring slots of each direction (uni:
    one bank; bidi: cw and ccw), and for the double ring its intra ring
    (bank 0) and its held inter partials (bank 1, the dqi slots)."""
    sl = list(prog.dq_slots) + [0] * (2 - len(prog.dq_slots))
    return tuple(sl[:2])


def fused_ring_bwd(q, k, v, o, lse, do, cfg, n_inter: int, n_intra: int, *,
                   head_chunk: Optional[int] = None,
                   trace: Optional[torch.Tensor] = None,
                   collect_stats: bool = False, seg=None):
    """Backward burst attention of all W = n_inter * n_intra ring positions
    through the fused ring: q, o, do [W,B,N,S,D], k, v [W,B,Nk,S,D], lse
    [W,B,N,S] fp32 (position p's shard at index p, layout order) -> fp32
    (dq [W,B,N,S,D], dk, dv [W,B,Nk,S,D]).  Callers check
    `fused_ring.supported(..., pass_="bwd")` first.  A CUDA tensor
    launches the kernel; a CPU tensor runs fused_ring_bwd_reference
    (`head_chunk` bounds its score tensors there).  `trace` (bf16 on the
    card only): a zeroed int64 tensor [rows, len(TRACE_COLS)] with a row
    for each CTA of the launch (W * CTAs a position; the card's SM count
    is enough), which the traced instance of the kernel fills
    (`read_trace`).  `collect_stats` also returns the bundle slot-consume
    counters, int32 [W, 2, MAX_SLOTS] per (position, bank, slot), from the
    kernel's STATS instance (the plain version counts the same walk); dq,
    dk, dv are bitwise those of the stats-off call.  `seg`: the positions'
    segment ids [W,B,S] integers (the kernel's SEG instance)."""
    w, b, n, s, d = q.shape
    if w != n_inter * n_intra:
        raise ValueError(f"{w} stacked shards for a {n_inter}x{n_intra} "
                         "ring")
    if k.shape[:2] != (w, b) or k.shape[3:] != (s, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(lse.shape) != (w, b, n, s):
        raise ValueError(f"lse {tuple(lse.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if n % k.shape[2]:
        raise ValueError(f"GQA needs Nq % Nk == 0, got {n} % {k.shape[2]}")
    seg = seg_table(seg, w, b, s, q.device)
    prog, tables, _ = ring_plan(cfg, n_inter, n_intra, s, "bwd")
    scale = cfg.scale if cfg.scale is not None else d ** -0.5
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ring_bwd runs on cuda or cpu tensors, got "
                         f"{q.device}")
    slot_use = _slot_counters(prog, w, q.device) if collect_stats else None
    wire = cfg.wire_dtype
    if q.device.type == "cpu":
        out = fused_ring_bwd_reference(q, k, v, o, lse, do, prog, tables,
                                       scale, cfg.optimize_bwd_comm,
                                       head_chunk=head_chunk,
                                       slot_use=slot_use, seg=seg,
                                       window=cfg.window, wire=wire)
    else:
        out = _fused_ring_bwd_cuda(
            q, k, v, o, lse, do, prog,
            _sched_on(cfg, n_inter, n_intra, s, q.device, "bwd"), scale,
            cfg.optimize_bwd_comm, trace, slot_use=slot_use, seg=seg,
            window=cfg.window, wire=wire)
    return out + (slot_use,) if collect_stats else out


fused_ring_bwd.launches = 0
fused_ring_bwd.seg_launches = 0  # the launches of the SEG instances
fused_ring_bwd.win_launches = 0  # the launches of the WIN instances
fused_ring_bwd.wire_launches = 0  # the launches of the WIRE instances


def dq_wire_roundtrip(x, wire):
    """What a dq partial x [..., S, D] fp32 is after one quantized hop of
    the kernel: quantized per 64-row q tile (FUSED_BLOCK_Q_BWD) of each
    leading index, dequantized to fp32."""
    if wire is None:
        return x
    s = x.shape[-2]
    nqt = -(-s // FUSED_BLOCK_Q_BWD)
    pad = nqt * FUSED_BLOCK_Q_BWD - s
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
    t = xp.unflatten(-2, (nqt, FUSED_BLOCK_Q_BWD))
    back = wire_dequantize(*wire_quantize(t, wire, (-2, -1)), torch.float32)
    return back.flatten(-3, -2)[..., :s, :]


class _Bundle:
    """One version of a bundle slot in the plain version's banks."""

    def __init__(self, ops, part, remote):
        self.ops, self.part = ops, part  # (first, do, q, lse)
        self.remote = remote  # written by a neighbour's send, not copy-in
        self.reads = 0        # consumes and send-source reads
        self.consumed = False


class _Partial:
    """One version of a dq slot: the partial dq of q-partition `part`,
    with the positions whose contributions it holds."""

    def __init__(self, value, part, contrib, remote):
        self.value, self.part, self.contrib = value, part, contrib
        self.remote = remote  # an arrival, not the owner's own merge
        self.done = False     # its last reader finished (sent or merged)


def _tile_bwd_chunked(do, q, k, v, delta, lse, scale, spec, head_chunk,
                      segments=None, window=None):
    """tile_bwd over chunks of `head_chunk` query heads (a multiple of the
    GQA group), so that no score tensor holds every head at once."""
    n, n_kv = q.shape[1], k.shape[1]
    if head_chunk is None or head_chunk >= n:
        return tile_bwd(do, q, k, v, delta, lse, scale, spec, window=window,
                        segments=segments)
    group = n // n_kv
    hc = max(group, head_chunk // group * group)
    parts = [tile_bwd(do[:, h:h + hc], q[:, h:h + hc],
                      k[:, h // group:(h + hc) // group],
                      v[:, h // group:(h + hc) // group], delta[:, h:h + hc],
                      lse[:, h:h + hc], scale, spec, window=window,
                      segments=segments)
             for h in range(0, n, hc)]
    return tuple(torch.cat(x, dim=1) for x in zip(*parts))


def fused_ring_bwd_reference(q, k, v, o, lse, do, prog,
                             tables: List[np.ndarray], scale,
                             optimize_bwd_comm: bool = True, *,
                             head_chunk: Optional[int] = None,
                             slot_use=None, seg=None, window=None,
                             wire=None):
    """Plain version of the fused backward kernel: walks the compiled
    backward program on the host with every position's bundle banks, dq
    slots and home outputs, in the kernel's phases per round (bundle sends
    at the round's start; each position's consume, tile_bwd under the
    table's swapped-role mask scalars and the dq merge; the bundle grants;
    the dq sends; the dq grants).  It asserts what the kernel relies on:
    each bundle consume finds the partition the rotation names and an
    arrival exactly when RECV is set; no bundle or dq slot is reused
    without a granted credit after its last read; each dq partial arrives
    once, on the slot and in the round the table says (DQ_RECV / DQI_RECV
    exactly when one waits there, of the held bundle's partition); every
    position's home outputs hold each round's contribution once (R
    distinct positions: all W on a dense program); no credit is left over.
    Same contract as fused_ring_bwd; a `slot_use` [W, 2, MAX_SLOTS] int32
    tensor counts each round's bundle consume per (position, bank, slot),
    as the kernel's STATS instance does.  `seg` [W, B, S]: the positions'
    segment ids; a round masks the bundle partition's ids against the
    position's own.  `window`: the band every round applies beside the
    table's scalars.  `wire` ("int8" | "fp8"): the bundle is quantized
    once per (batch, head) and dequantized at every consume, and each dq
    send delivers dq_wire_roundtrip of the partial, as the kernel's WIRE
    instances do."""
    w, n_rounds = q.shape[0], prog.n_rounds
    st = kernel_statics(prog)
    if optimize_bwd_comm:
        first = (o.float() * do.float()).sum(-1)
    else:
        first = o
    if wire is not None:
        # the bundle as it comes off the wire (quantized once at entry)
        first = wire_dequantize(
            *wire_quantize(first, wire, (3,) if optimize_bwd_comm
                           else (3, 4)),
            torch.float32 if optimize_bwd_comm else o.dtype)
        do = wire_dequantize(*wire_quantize(do, wire, (3, 4)), do.dtype)
        q = wire_dequantize(*wire_quantize(q, wire, (3, 4)), q.dtype)
    banks = [[[None] * prog.slots[bk] for bk in range(prog.n_banks)]
             for _ in range(w)]
    credits = [[[0] * prog.slots[bk] for bk in range(prog.n_banks)]
               for _ in range(w)]
    dq_slots = [[[None] * n for n in dq_bank_slots(prog)] for _ in range(w)]
    dq_credits = [[[0] * n for n in dq_bank_slots(prog)] for _ in range(w)]
    homes = [[None, None] for _ in range(w)]
    for p in range(w):
        for cb, cs in prog.copy_in:
            banks[p][cb][cs] = _Bundle((first[p], do[p], q[p], lse[p]), p,
                                       False)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for r in range(n_rounds):
        for p in range(w):  # bundle sends, at the round's start
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
                banks[dst][ch][ds] = _Bundle(src.ops, src.part, True)
        for p in range(w):  # consumes and dq merges
            row = tables[p][r]
            slot = banks[p][int(row[sched_ir.CONSUME_BANK])][
                int(row[sched_ir.CONSUME_SLOT])]
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
                slot_use[p, int(row[sched_ir.CONSUME_BANK]),
                         int(row[sched_ir.CONSUME_SLOT])] += 1
            first_r, do_r, q_r, lse_r = slot.ops
            delta_r = first_r if optimize_bwd_comm else (
                first_r.float() * do_r.float()).sum(-1)
            spec = MaskSpec(*(int(x) for x in row[:5]))
            segs = None if seg is None else (seg[slot.part], seg[p])
            dq_c, dk_c, dv_c = _tile_bwd_chunked(do_r, q_r, k[p], v[p],
                                                 delta_r, lse_r, scale, spec,
                                                 head_chunk, segs, window)
            dk[p] += dk_c
            dv[p] += dv_c
            bank, ds = int(row[sched_ir.DQ_BANK]), int(row[sched_ir.DQ_SLOT])
            cur = dq_slots[p][bank][ds]
            arrived = cur is not None and cur.remote and not cur.done
            assert bool(row[sched_ir.DQ_RECV]) == arrived, (
                p, r, "dq arrival and DQ_RECV disagree")
            assert arrived or cur is None or cur.done, (
                p, r, "dq seed over a partial not yet sent")
            value, contrib = dq_c, [p]
            if arrived:
                assert cur.part == want, (p, r, "dq partial of a wrong "
                                          "partition")
                cur.done = True
                value, contrib = cur.value + dq_c, cur.contrib + [p]
            if row[sched_ir.DQI_RECV]:
                held = dq_slots[p][1][int(row[sched_ir.DQI_SLOT])]
                assert held is not None and held.remote and not held.done \
                    and held.part == want, (p, r, "no inter partial held")
                held.done = True
                value, contrib = value + held.value, contrib + held.contrib
            dq_slots[p][bank][ds] = _Partial(value, want, contrib, False)
        for p in range(w):  # bundle grants, once the round's reads are done
            row = tables[p][r]
            for bk in range(prog.n_banks):
                if row[_GRANT[bk]]:
                    credits[p][bk][int(row[_GRANT[bk]]) - 1] += 1
        for p in range(w):  # dq sends
            row, meta = tables[p][r], tables[p][n_rounds]
            kind, sbank, dslot, meta_col = dq_send_target(row)
            assert kind != sched_ir.DQ_NONE, (p, r, "a round without a dq "
                                              "send")
            src = dq_slots[p][int(row[sched_ir.DQ_BANK])][
                int(row[sched_ir.DQ_SLOT])]
            src.done = True
            dst = int(meta[meta_col])
            sent = dq_wire_roundtrip(src.value, wire)
            if dslot < 0:
                assert homes[dst][sbank] is None, (p, r, "home twice")
                homes[dst][sbank] = _Partial(sent, src.part, src.contrib,
                                             True)
                continue
            take = row[sched_ir.DQ_TAKE1 if sbank else sched_ir.DQ_TAKE0]
            old = dq_slots[dst][sbank][dslot]
            if old is None:
                assert not take, (p, r, "dq take on a fresh slot")
            else:
                assert take, (p, r, "dq slot reused without a take")
                assert dq_credits[dst][sbank][dslot] > 0, (
                    p, r, f"take of dq slot {sbank}/{dslot} before its grant")
                assert old.done, (p, r, "dq overwrite before read")
                dq_credits[dst][sbank][dslot] -= 1
            dq_slots[dst][sbank][dslot] = _Partial(sent, src.part,
                                                   src.contrib, True)
        for p in range(w):  # dq grants, once the round's sends are done
            row = tables[p][r]
            for b, col in enumerate((sched_ir.DQ_GRANT0, sched_ir.DQ_GRANT1)):
                if row[col]:
                    dq_credits[p][b][int(row[col]) - 1] += 1
    assert not any(c for pos in credits for bank in pos for c in bank), (
        "credits granted but never taken")
    assert not any(c for pos in dq_credits for bank in pos for c in bank), (
        "dq credits granted but never taken")
    n_homes = len(bwd_statics(prog))
    dq = []
    for p in range(w):
        got = [h for h in homes[p] if h is not None]
        assert len(got) == n_homes, (p, "a home output never arrived")
        contrib = [c for h in got for c in h.contrib]
        assert all(h.part == p for h in got), (p, "home of a wrong partition")
        assert len(contrib) == n_rounds == len(set(contrib)), (
            p, f"dq holds contributions {sorted(contrib)}")
        value = got[0].value
        for h in got[1:]:
            value = value + h.value
        dq.append(value)
    return torch.stack(dq), dk, dv


def read_trace(trace):
    """The records of a traced launch (rows the kernel wrote), as dicts
    of TRACE_COLS."""
    rows = trace.cpu().tolist()
    return [dict(zip(TRACE_COLS, r)) for r in rows if r[1] > 0]


def bwd_attrs(stats: bool = False, seg: bool = False, win: bool = False,
              wire: bool = False):
    """_build.kernel_attrs of kernel 9's instances: bf16 (and traced),
    fp32; with `stats` its two STATS instances (bf16 stats, fp32 stats);
    with `seg` and / or `win` its SEG, WIN or SEG + WIN instances (labels
    "bf16 seg", "fp32 win", "bf16 seg win", ...); with `wire` its WIRE
    instances ("bf16 wire", "fp32 win wire", "bf16 seg wire", ...)."""
    bf16, fp32 = KERNEL_DTYPES[torch.bfloat16], KERNEL_DTYPES[torch.float32]
    if wire:
        flag = 16 | (8 if win else 0) | (4 if seg else 0)
        tag = ((" seg" if seg else "") + (" win" if win else "")
               + " wire")
        return _build.kernel_attrs("fused_ring_bwd", {
            f"bf16{tag}": (bf16, flag), f"fp32{tag}": (fp32, flag)})
    if seg or win:
        flag = (4 if seg else 0) | (8 if win else 0)
        tag = (" seg" if seg else "") + (" win" if win else "")
        return _build.kernel_attrs("fused_ring_bwd", {
            f"bf16{tag}": (bf16, flag), f"fp32{tag}": (fp32, flag)})
    if stats:
        return _build.kernel_attrs("fused_ring_bwd", {
            "bf16 stats": (bf16, 2), "fp32 stats": (fp32, 2)})
    return _build.kernel_attrs("fused_ring_bwd", {
        "bf16": (bf16, 0), "bf16 traced": (bf16, 1), "fp32": (fp32, 0)})


def _fused_ring_bwd_cuda(q, k, v, o, lse, do, prog, sched, scale, opt_comm,
                         trace=None, slot_use=None, seg=None, window=None,
                         wire=None):
    dev = q.device
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused_ring_bwd kernel takes "
                         f"{list(KERNEL_DTYPES)}, got {q.dtype}")
    w, b, n, s, d = q.shape
    n_kv = k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_ring_bwd kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_kernel_operand(name, t, dev, q.dtype)
    _check_kernel_operand("lse", lse, dev, torch.float32, (w, b, n, s))
    if wire is not None and (slot_use is not None or trace is not None):
        raise NotImplementedError(
            "kernel 9 has no WIRE instance with STATS or TRACE: "
            "collect_stats / trace of a wire backward are not built "
            "(ROADMAP B1)")
    lib = _build.load("fused_ring_bwd")
    code = KERNEL_DTYPES[q.dtype]
    cap = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _build.check(lib.fused_ring_bwd_capacity(
            d, code, int(seg is not None), int(window is not None),
            int(wire is not None), ctypes.byref(cap)),
            "fused_ring_bwd capacity")
    n_items = b * n_kv * -(-s // FUSED_BLOCK_KV_BWD)
    per_pos = cap.value // w
    if per_pos < 1:
        raise RuntimeError(f"the card keeps {cap.value} fused-ring CTAs "
                           f"resident, fewer than the {w} positions")
    ctas = min(per_pos, n_items)
    resident = n_items <= per_pos
    if seg is not None and slot_use is not None:
        raise ValueError("the kernel's SEG instances count no slots: "
                         "collect_stats with seg runs on the CPU only")
    if window is not None and slot_use is not None:
        raise NotImplementedError(
            "kernel 9 has no STATS + WIN instance: collect_stats on a "
            "windowed ring's backward runs on the CPU only (ROADMAP B1)")
    if trace is not None:
        if q.dtype != torch.bfloat16 or slot_use is not None or \
                seg is not None or window is not None:
            raise ValueError("a traced fused_ring_bwd launch is bf16 only, "
                             "without collect_stats, seg or a window")
        if (trace.dtype != torch.int64 or trace.device != dev
                or trace.dim() != 2 or trace.shape[0] < w * ctas
                or trace.shape[1] != len(TRACE_COLS)
                or not trace.is_contiguous()):
            raise ValueError(f"trace must be a contiguous int64 tensor "
                             f"[>= {w * ctas}, {len(TRACE_COLS)}] on {dev}")
    # the bundle's first operand: delta [.., S] fp32 (optimize_bwd_comm)
    # or o itself, delta then recomputed per tile
    first = (o.float() * do.float()).sum(-1) if opt_comm else o
    f32 = dict(dtype=torch.float32, device=dev)
    nqt = -(-s // FUSED_BLOCK_Q_BWD)
    n_rows = b * n * s
    # a dq wire slot: the partial's 1-byte payload, then its q tiles'
    # scales, padded to 16 bytes
    wslot = n_rows * d + -(-(b * n * nqt * 4) // 16) * 16
    if wire is None:
        ops = (first, do, q, lse)
    else:
        # the bundle quantized once: 1-byte first, do, q; lse fp32 with the
        # three (batch, head) scale vectors behind it, padded to 16 bytes
        fq, fsc = wire_quantize(first, wire, (3,) if opt_comm else (3, 4))
        doq, dosc = wire_quantize(do, wire, (3, 4))
        qq, qsc = wire_quantize(q, wire, (3, 4))
        if n_rows % 16:
            raise ValueError(f"a wire bundle needs B*N*S a multiple of 16, "
                             f"got {n_rows}")
        scales = torch.cat([x.reshape(w, -1) for x in (fsc, dosc, qsc)],
                           dim=1)
        scales = torch.nn.functional.pad(
            scales, (0, -(-scales.shape[1] // 4) * 4 - scales.shape[1]))
        lse_ext = torch.cat([lse.reshape(w, -1), scales], dim=1)
        ops = tuple(x.view(torch.uint8).reshape(w, -1)
                    for x in (fq, doq, qq)) + (lse_ext.contiguous(),)
    banks = []
    for bk in range(prog.n_banks):
        sl = prog.slots[bk]
        banks.append([torch.empty((w, sl) + x.shape[1:], dtype=x.dtype,
                                  device=dev) for x in ops])
    dq_banks = [torch.empty((w, sl) + q.shape[1:], **f32) if sl else None
                for sl in dq_bank_slots(prog)]
    home_rounds = bwd_statics(prog)
    if wire is None:
        homes = [torch.empty(q.shape, **f32) if b_ in home_rounds else None
                 for b_ in range(2)]
        wbanks, wptrs = [], None
    else:
        homes = [torch.empty((w, wslot), dtype=torch.uint8, device=dev)
                 if b_ in home_rounds else None for b_ in range(2)]
        wbanks = [torch.empty((w, sl, wslot), dtype=torch.uint8, device=dev)
                  if sl else None for sl in dq_bank_slots(prog)]
        wptrs = torch.tensor(
            [[0 if t is None else t.data_ptr() + p * t.stride(0)
              for t in wbanks] for p in range(w)],
            dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    max_slots = max(prog.slots)
    max_dq = max(dq_bank_slots(prog))
    # per position: bundle arrival and credit counters per (bank, slot),
    # dq arrival and credit counters per (dq bank, slot), then per round
    # two done counters (compute, dq send) and the items taken
    flags = torch.zeros((w, 2 * prog.n_banks * max_slots + 4 * max_dq
                         + 3 * prog.n_rounds), dtype=torch.int32, device=dev)
    folds = torch.zeros((w, prog.n_rounds, b * n * nqt), dtype=torch.int32,
                        device=dev)
    ptr_rows = []
    for p in range(w):
        ptr = [0] * _N_PTRS
        for bk, bank in enumerate(banks):
            for i, t in enumerate(bank):
                ptr[4 * bk + i] = t.data_ptr() + p * t.stride(0) * \
                    t.element_size()
        for i, t in enumerate(dq_banks + homes):
            if t is not None:
                ptr[8 + i] = t.data_ptr() + p * t.stride(0) * \
                    t.element_size()
        ptr[12] = flags.data_ptr() + p * flags.stride(0) * 4
        ptr_rows.append(ptr)
    ptrs = torch.tensor(ptr_rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    dk = torch.empty(k.shape, **f32)
    dv = torch.empty(k.shape, **f32)
    copy_in = [bk * 16 + sl + 1 for bk, sl in prog.copy_in] + [0, 0]
    ops = tuple(x.contiguous() for x in ops)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.fused_ring_bwd_launch(
            *(x.data_ptr() for x in ops),
            k.data_ptr(), v.data_ptr(), ptrs.data_ptr(), sched.data_ptr(),
            folds.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if trace is None else trace.data_ptr(), w, b, n, n_kv, s,
            d, prog.n_rounds, prog.n_banks, max_slots, max_dq, ctas,
            BWD_KERNEL_COLS, copy_in[0], copy_in[1], code, int(resident),
            int(opt_comm), None if slot_use is None else slot_use.data_ptr(),
            None if seg is None else seg.data_ptr(),
            0 if window is None else int(window), float(scale), stream,
            WIRE_CODES[wire], None if wptrs is None else wptrs.data_ptr(),
            wslot)
    _build.check(err, "fused_ring_bwd")
    fused_ring_bwd.launches += 1
    fused_ring_bwd.seg_launches += seg is not None
    fused_ring_bwd.win_launches += window is not None
    fused_ring_bwd.wire_launches += wire is not None
    if wire is not None:  # the homes arrive quantized per q tile
        homes = [None if h is None else
                 _dq_from_wire(h, wire, (w, b, n, s, d)) for h in homes]
    dq = homes[0] if homes[1] is None else homes[0] + homes[1]
    return dq, dk, dv


def _dq_from_wire(buf, wire, shape):
    """A dq wire buffer [W, wire slot bytes] (payload [W,B,N,S,D], then a
    scale per (batch, head, 64-row q tile)) dequantized to fp32."""
    w, b, n, s, d = shape
    nqt = -(-s // FUSED_BLOCK_Q_BWD)
    payload = buf[:, :b * n * s * d].view(WIRE_TORCH[wire]).reshape(shape)
    scales = buf[:, b * n * s * d:b * n * s * d + 4 * b * n * nqt].view(
        torch.float32).reshape(w, b, n, nqt, 1)
    scales = scales.repeat_interleave(FUSED_BLOCK_Q_BWD, dim=3)[:, :, :, :s]
    return payload.float() * scales
