"""Ring-schedule IR and compiler (port of burst_attn_tpu/parallel/
schedule.py; numpy only).

A ring schedule is a small compiled PROGRAM: per-round consume / send /
recv / credit ops per stream, emitted once by `compile_fwd` /
`compile_bwd` and lowered twice:

  * `scan_events(program)` flattens it to the ordered (cls, axis, hops)
    stream of rotations the scan ring issues (`parallel/ring.
    ring_round_counts` reports its hop totals);
  * `RingProgram.to_table()` packs it into the int32 op table the fused
    ring kernels (csrc/fused_ring_fwd.cu and csrc/fused_ring_bwd.cu,
    through ops/fused_ring.py and ops/fused_ring_bwd.py) and their plain
    versions interpret: the kernels hold no schedule logic of their own.

Topologies:

  "uni"    the classic single ring: every chunk travels world-1 hops.
  "bidi"   counter-rotating bidirectional ring: offsets
           1..ceil((W-1)/2) arrive clockwise, 1..floor((W-1)/2)
           counter-clockwise, interleaved; each direction owns a slot bank.
  "double" the hierarchical double ring: n_inter cycles of n_intra intra
           hops; the next cycle's base chunk leaves on the inter channel
           ONE FULL INTRA-CYCLE before its consume, into a prefetch bank.
           Runs on a two-axis ("inter", "intra") mesh or factored onto a
           flat ring axis (n_inter * n_intra == world).

Payload moves through at most two send CHANNELS, each owning a slot BANK
on the receiving side (channel 0: cw / intra sends -> bank 0; channel 1:
ccw / inter-prefetch sends -> bank 1).  Per round a table row says which
(bank, slot) compute consumes, whether that slot's arrival must be
awaited first, which channels send (src bank/slot, dst slot), and the
per-slot capacity credits (grant / take) that make slot reuse safe,
assigned here from the write/read order and checked (grant strictly
before take) at compile time.

Backward programs add the dq ring plan (its columns DQ_* and DQI_*):
the q-side bundle moves as the forward's KV, and the dq partials ride
one hop behind it (parallel/burst._bwd_impl's scan ring realizes the
same movement with rotations).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

TOPOLOGIES = ("uni", "bidi", "double")

# ---------------------------------------------------------------------------
# table column layout (shared by both passes; bwd extends fwd).  Columns
# 0..4 hold the per-round mask-spec scalars (ops/masks.round_spec), filled
# per ring position by ops/fused_ring.build_sched_table; everything the
# compiler emits is position-independent.

SPEC0 = 0                 # q_lo, q_hi, kv_hi, causal, offset
CONSUME_BANK = 5
CONSUME_SLOT = 6
RECV = 7                  # 1 = wait payload recv sems on the consume slot
SEND0 = 8                 # channel-0 send issued at this round's first step
SRC_BANK0 = 9
SRC_SLOT0 = 10
DST_SLOT0 = 11
GRANT0 = 12               # bank-0 slot+1 whose credit this round grants
TAKE0 = 13                # 1 = this round's send takes its dst slot's credit
SEND1 = 14
SRC_SLOT1 = 15            # channel-1 sends always source from bank 1
DST_SLOT1 = 16
GRANT1 = 17
TAKE1 = 18
FWD_COLS = 19

DQ_BANK = 19              # which dq ring this round's contribution folds into
DQ_RECV = 20              # 1 = a partial arrives (one hop behind the bundle)
DQ_SLOT = 21
DQ_SEND = 22              # 0 none | 1 ring | 2 home | 3 boundary | 4 final
DQ_DST_SLOT = 23
DQ_GRANT0 = 24
DQ_TAKE0 = 25
DQ_GRANT1 = 26
DQ_TAKE1 = 27
DQI_RECV = 28             # double: consume the held inter partial this round
DQI_SLOT = 29
DQI_DST_SLOT = 30
BWD_COLS = 31

# dq send kinds
DQ_NONE, DQ_RING, DQ_HOME, DQ_BOUNDARY, DQ_FINAL = 0, 1, 2, 3, 4

# meta-row entries (ring positions, filled per position by
# ops/fused_ring.build_sched_table): me, channel-0 dst/src neighbour,
# channel-1 dst/src neighbour, dq home targets per dq bank
META_ME = 0
META_CH0_DST = 1
META_CH0_SRC = 2
META_CH1_DST = 3
META_CH1_SRC = 4
META_HOME0 = 5
META_HOME1 = 6


@dataclass(frozen=True)
class RingProgram:
    """One compiled ring schedule (see module docstring)."""

    kind: str                     # "fwd" | "bwd"
    topology: str                 # "uni" | "bidi" | "double"
    n_inter: int
    n_intra: int
    slots: Tuple[int, ...]        # payload slots per bank (len = n_banks)
    channels: Tuple[str, ...]     # channel dirs: subset of (cw, ccw, inter)
    copy_in: Tuple[Tuple[int, int], ...]  # round-0 local copies (bank, slot)
    rows: Dict[str, Tuple[int, ...]] = field(hash=False)
    # per-round rotation of the consumed payload: partition =
    # ((inter_rank - rot_inter) % I) * N + ((intra_rank - rot_intra) % N)
    rot_inter: Tuple[int, ...] = ()
    rot_intra: Tuple[int, ...] = ()
    # bwd only: dq ring geometry
    dq_slots: Tuple[int, ...] = ()          # ring slots per dq bank (no home)
    home_offsets: Tuple[Tuple[int, int], ...] = ()  # per dq bank:
    #   (inter_off, intra_off) — the final home hop targets the device
    #   `offset` positions forward of the sender
    @property
    def world(self) -> int:
        return self.n_inter * self.n_intra

    @property
    def n_rounds(self) -> int:
        return len(self.rot_intra)

    @property
    def n_banks(self) -> int:
        return len(self.slots)

    @property
    def n_dq_banks(self) -> int:
        return len(self.dq_slots)

    def col(self, name_idx: int) -> Tuple[int, ...]:
        return tuple(self.rows[_COL_NAMES[name_idx]])

    def to_table(self) -> np.ndarray:
        """[n_rounds, FWD_COLS|BWD_COLS] int32 op table (spec cols zeroed:
        they depend on the ring position, see ops/fused_ring.
        build_sched_table)."""
        ncols = BWD_COLS if self.kind == "bwd" else FWD_COLS
        out = np.zeros((self.n_rounds, ncols), dtype=np.int32)
        for idx in range(5, ncols):
            out[:, idx] = self.rows[_COL_NAMES[idx]]
        return out


_COL_NAMES = {
    CONSUME_BANK: "consume_bank", CONSUME_SLOT: "consume_slot", RECV: "recv",
    SEND0: "send0", SRC_BANK0: "src_bank0", SRC_SLOT0: "src_slot0",
    DST_SLOT0: "dst_slot0", GRANT0: "grant0", TAKE0: "take0",
    SEND1: "send1", SRC_SLOT1: "src_slot1", DST_SLOT1: "dst_slot1",
    GRANT1: "grant1", TAKE1: "take1",
    DQ_BANK: "dq_bank", DQ_RECV: "dq_recv", DQ_SLOT: "dq_slot",
    DQ_SEND: "dq_send", DQ_DST_SLOT: "dq_dst_slot",
    DQ_GRANT0: "dq_grant0", DQ_TAKE0: "dq_take0",
    DQ_GRANT1: "dq_grant1", DQ_TAKE1: "dq_take1",
    DQI_RECV: "dqi_recv", DQI_SLOT: "dqi_slot",
    DQI_DST_SLOT: "dqi_dst_slot",
}


class ScheduleError(ValueError):
    """A requested schedule cannot be compiled (bad topology/shape) or an
    emitted schedule failed a compile-time obligation (credit ordering)."""


# ---------------------------------------------------------------------------
# credit assignment: the one place the capacity handshake is derived


def _assign_credits(n_rounds: int, slots: int, writes, reads):
    """Derive the per-round capacity-credit schedule for one slot bank.

    writes: ordered [(round, slot)] REMOTE writes into the bank (the
    neighbor's sends, in issue order; the local round-0 copy-in is version
    0 of its slot and prepended by the caller when it exists).
    reads:  [(round, slot)] every read of the bank (consume + send-source).

    Credits are PER SLOT (the kernel's free counters are indexed like the
    bank): a write that reuses a slot takes that slot's credit at
    its round (take flag — the slot is the send's dst slot, already in the
    table), and the reader grants it at the end of the round holding the
    LAST read of the version being overwritten (grant column = slot + 1).
    A single fungible pool would be unsound for multi-bank-cycle
    schedules: a grant meant to free slot A could be consumed early by a
    write into slot B, silently licensing an overwrite-before-read.  Compile-
    time obligations: at most one grant per round per bank, and every
    grant round strictly precedes its take round (else the kernel
    deadlocks on an ungranted credit).
    """
    grants = [0] * n_rounds  # slot + 1; 0 = no grant
    takes = [0] * n_rounds
    per_slot_writes: Dict[int, List[int]] = {}
    write_meta = []  # (round, slot, version_index)
    for rnd, slot in writes:
        per_slot_writes.setdefault(slot, []).append(rnd)
        write_meta.append((rnd, slot, len(per_slot_writes[slot]) - 1))
    last_read: Dict[Tuple[int, int], int] = {}
    for rnd, slot in reads:
        versions = per_slot_writes.get(slot, [])
        vi = 0
        for j, wr in enumerate(versions):
            if wr <= rnd:
                vi = j
        key = (slot, vi)
        last_read[key] = max(last_read.get(key, -1), rnd)
    for rnd, slot, vi in write_meta:
        if vi == 0:
            continue  # first use of the slot: no credit needed
        takes[rnd] += 1
        prev_key = (slot, vi - 1)
        g = last_read.get(prev_key)
        if g is None:
            raise ScheduleError(
                f"slot {slot} version {vi - 1} overwritten without ever "
                "being read — aliased slot assignment")
        if g >= rnd:
            raise ScheduleError(
                f"credit deadlock: grant for slot {slot} at round {g} does "
                f"not precede the take at round {rnd}")
        if grants[g]:
            raise ScheduleError(
                f"round {g} would grant credits for two slots of one bank "
                f"({grants[g] - 1} and {slot})")
        grants[g] = slot + 1
    if sum(1 for g in grants if g) != sum(takes):
        raise ScheduleError(
            f"unbalanced credits: {sum(1 for g in grants if g)} granted, "
            f"{sum(takes)} taken")
    return grants, takes


def _assign_dq_credits(n_rounds: int, servings):
    """Credits for a dq accumulating ring, whose slots are written twice
    per serving (remote arrival, then the owner's local merged writeback).

    servings: ordered [(round, slot, arrival)] — the rounds this dq bank
    is the active ring, the slot serving them, and whether a partial
    ARRIVES (one hop behind) or the round seeds a fresh partial.  An
    arrival's send was issued during the sender's PREVIOUS serving round
    of this bank (one hop behind by construction), so when it reuses a
    slot the take lands on that round and the grant on the slot's previous
    serving round — which must strictly precede it or the ring deadlocks.
    """
    grants = [0] * n_rounds  # slot + 1; 0 = no grant (per-slot credits)
    takes = [0] * n_rounds
    prev_of_slot: Dict[int, int] = {}
    for k, (rnd, slot, arrival) in enumerate(servings):
        if arrival and k > 0:
            sender_round = servings[k - 1][0]
            if slot in prev_of_slot:
                t_prev = prev_of_slot[slot]
                if t_prev >= sender_round:
                    raise ScheduleError(
                        f"dq credit deadlock: slot {slot} last served at "
                        f"round {t_prev}, rewritten by the send at round "
                        f"{sender_round}")
                takes[sender_round] += 1
                if grants[t_prev]:
                    raise ScheduleError(
                        f"round {t_prev} would grant dq credits for two "
                        f"slots ({grants[t_prev] - 1} and {slot})")
                grants[t_prev] = slot + 1
        prev_of_slot[slot] = rnd
    return grants, takes


# ---------------------------------------------------------------------------
# forward compiler


def _blank_rows(n_rounds: int, ncols: int) -> Dict[str, List[int]]:
    return {name: [0] * n_rounds for idx, name in _COL_NAMES.items()
            if idx < ncols}


def _bidi_order(world: int) -> List[Tuple[str, int]]:
    """Global sweep order of the counter-rotating ring: the self round,
    then cw offset c and ccw offset u interleaved (cw first).  cw carries
    offsets 1..ceil((W-1)/2), ccw offsets 1..floor((W-1)/2)."""
    h_cw = (world - 1 + 1) // 2
    h_ccw = (world - 1) // 2
    order: List[Tuple[str, int]] = [("cw", 0)]
    for j in range(1, max(h_cw, h_ccw) + 1):
        if j <= h_cw:
            order.append(("cw", j))
        if j <= h_ccw:
            order.append(("ccw", j))
    return order


def compile_fwd(topology: str, n_intra: int, n_inter: int = 1, *,
                slots: int = 2, slots1: Optional[int] = None,
                r_live: Optional[int] = None) -> RingProgram:
    """Compile a forward (KV-rotation) ring schedule.

    n_intra/n_inter: ring factorization (uni/bidi use n_inter == 1; double
    requires both >= 2, world = n_inter * n_intra).  slots: payload slots
    of bank 0 (>= 2); slots1: bank 1 (default = slots for bidi, 2 for the
    double prefetch bank).

    r_live: occupancy truncation (dead-round ELISION).  When the per-round
    occupancy (ops/masks.live_round_prefix, built on spec_pair_count) says
    only ring offsets {0..r_live-1} ever attend a pair, the compiled
    program keeps exactly those rounds and OMITS every op of the dead
    tail: no consume, no send/recv, no credit traffic — the elided rounds
    do not exist in the table, so the kernel copies no chunk and sweeps no
    KV for them.  uni keeps its first r_live rounds; bidi degrades to the
    cw-only prefix program (serving offsets 0..r_live-1 down one direction
    is strictly cheaper than splitting a short prefix across two streams,
    and the bidi interleave's tail is not a round prefix); double keeps
    the first r_live rounds of its (cycle-major) visit order — whose flat
    offset IS the round index, so prefix truncation applies directly, and
    the inter prefetch for a cycle that would start at or past r_live is
    elided with it.
    """
    if topology not in TOPOLOGIES:
        raise ScheduleError(f"unknown topology {topology!r}")
    if slots < 2:
        raise ScheduleError(f"need slots >= 2, got {slots}")
    world = n_inter * n_intra
    if world < 1:
        raise ScheduleError(f"need world >= 1, got {world}")
    if topology != "double" and n_inter != 1:
        raise ScheduleError(f"{topology} rings need n_inter == 1")
    if topology == "double" and (n_inter < 2 or n_intra < 1):
        raise ScheduleError(
            f"double ring needs n_inter >= 2 and n_intra >= 1, got "
            f"{n_inter}x{n_intra}")
    if r_live is not None:
        if not (1 <= r_live <= world):
            raise ScheduleError(
                f"r_live must be in [1, world={world}], got {r_live}")
        if r_live == world:
            r_live = None  # no dead tail: compile the dense program

    if topology == "uni":
        prog = _compile_fwd_uni(world, slots, r_live)
    elif topology == "bidi":
        if r_live is not None:
            # a truncated bidi degrades to the cw-only prefix program: the
            # live offsets {0..r_live-1} all fit one direction, and the
            # bidi interleave's own tail is not a round prefix
            prog = _compile_fwd_uni(world, slots, r_live)
        else:
            prog = _compile_fwd_bidi(world, slots,
                                     slots if slots1 is None else slots1)
    else:
        prog = _compile_fwd_double(n_inter, n_intra, slots,
                                   2 if slots1 is None else slots1, r_live)
    return prog


def _compile_fwd_uni(world: int, slots: int, r_live=None) -> RingProgram:
    n_rounds = world if r_live is None else r_live
    c0 = min(slots, world)
    rows = _blank_rows(n_rounds, FWD_COLS)
    writes = [(0, 0)]  # copy-in = version 0 of slot 0
    reads = []
    for r in range(n_rounds):
        slot = r % c0
        rows["consume_slot"][r] = slot
        rows["recv"][r] = int(r > 0)
        reads.append((r, slot))
        if r < n_rounds - 1:
            rows["send0"][r] = 1
            rows["src_slot0"][r] = slot
            rows["dst_slot0"][r] = (r + 1) % c0
            writes.append((r, (r + 1) % c0))
            reads.append((r, slot))
    grants, takes = _assign_credits(n_rounds, c0, writes, reads)
    rows["grant0"], rows["take0"] = grants, takes
    return RingProgram(
        kind="fwd", topology="uni", n_inter=1, n_intra=world,
        slots=(c0,), channels=("cw",), copy_in=((0, 0),),
        rows={k: tuple(v) for k, v in rows.items()},
        rot_inter=(0,) * n_rounds, rot_intra=tuple(range(n_rounds)))


def _compile_fwd_bidi(world: int, slots: int, slots1: int) -> RingProgram:
    order = _bidi_order(world)
    n_rounds = len(order)
    assert n_rounds == world
    h_cw = sum(1 for d, _ in order if d == "cw") - 1
    h_ccw = sum(1 for d, _ in order if d == "ccw")
    c0 = min(slots, h_cw + 1) if h_cw else 1
    c0 = max(c0, 1)
    c1 = max(min(slots1, h_ccw + 1), 1) if h_ccw else 1
    rows = _blank_rows(n_rounds, FWD_COLS)
    rot = []
    writes0, reads0 = [(0, 0)], []
    writes1, reads1 = ([(0, 0)], []) if h_ccw else ([], [])
    copy_in = ((0, 0), (1, 0)) if h_ccw else ((0, 0),)
    for r, (d, j) in enumerate(order):
        bank = 0 if d == "cw" else 1
        c = c0 if bank == 0 else c1
        slot = j % c
        rot.append(j if d == "cw" else -j)
        rows["consume_bank"][r] = bank
        rows["consume_slot"][r] = slot
        rows["recv"][r] = int(j > 0)
        (reads0 if bank == 0 else reads1).append((r, slot))
        # onward send of the just-consumed chunk, same direction
        last = (j == h_cw) if d == "cw" else (j == h_ccw)
        if not last:
            dst = (j + 1) % c
            if bank == 0:
                rows["send0"][r] = 1
                rows["src_slot0"][r] = slot
                rows["dst_slot0"][r] = dst
                writes0.append((r, dst))
                reads0.append((r, slot))
            else:
                rows["send1"][r] = 1
                rows["src_slot1"][r] = slot
                rows["dst_slot1"][r] = dst
                writes1.append((r, dst))
                reads1.append((r, slot))
        # round 0 additionally launches the ccw stream from the bank-1 copy
        if r == 0 and h_ccw:
            rows["send1"][r] = 1
            rows["src_slot1"][r] = 0
            rows["dst_slot1"][r] = 1 % c1
            writes1.append((r, 1 % c1))
            reads1.append((r, 0))
    grants, takes = _assign_credits(n_rounds, c0, writes0, reads0)
    rows["grant0"], rows["take0"] = grants, takes
    if h_ccw:
        grants, takes = _assign_credits(n_rounds, c1, writes1, reads1)
        rows["grant1"], rows["take1"] = grants, takes
    channels = ("cw", "ccw") if h_ccw else ("cw",)
    slots_t = (c0, c1) if h_ccw else (c0,)
    return RingProgram(
        kind="fwd", topology="bidi", n_inter=1, n_intra=world,
        slots=slots_t, channels=channels, copy_in=copy_in,
        rows={k: tuple(v) for k, v in rows.items()},
        rot_inter=(0,) * n_rounds, rot_intra=tuple(rot))


def _compile_fwd_double(n_inter: int, n_intra: int, slots: int,
                        slots1: int, r_live=None) -> RingProgram:
    if slots1 < 2:
        raise ScheduleError(f"double ring needs >= 2 prefetch slots, "
                            f"got {slots1}")
    # dead-round elision: the double ring's visit order is cycle-major, so
    # a round's flat ring offset IS its index — an occupancy prefix of
    # r_live live offsets keeps exactly the first r_live rounds.  Every op
    # whose PURPOSE lies past the horizon goes with them: the intra send
    # feeding round r+1 >= r_live, and the whole inter prefetch of a cycle
    # whose first round (c+1)*n_intra >= r_live.
    n_rounds = n_inter * n_intra if r_live is None else r_live
    c0 = min(slots, n_intra)  # intra bank cycles within one cycle
    c1 = min(slots1, n_inter)
    rows = _blank_rows(n_rounds, FWD_COLS)
    rot_i, rot_s = [], []
    writes0, reads0 = [], []
    writes1, reads1 = [(0, 0)], []  # copy-in: cycle-0 base in prefetch slot 0
    for c in range(n_inter):
        base_slot = c % c1
        for s in range(n_intra):
            r = c * n_intra + s
            if r >= n_rounds:
                break
            rot_i.append(c)
            rot_s.append(s)
            if s == 0:
                # consume the cycle base from the prefetch bank
                rows["consume_bank"][r] = 1
                rows["consume_slot"][r] = base_slot
                rows["recv"][r] = int(c > 0)
                reads1.append((r, base_slot))
                if c < n_inter - 1 and (c + 1) * n_intra < n_rounds:
                    # the signature move: next cycle's base leaves NOW, one
                    # full intra-cycle before its first-step consume
                    rows["send1"][r] = 1
                    rows["src_slot1"][r] = base_slot
                    rows["dst_slot1"][r] = (c + 1) % c1
                    writes1.append((r, (c + 1) % c1))
                    reads1.append((r, base_slot))
                if n_intra > 1 and r + 1 < n_rounds:
                    # intra ring launch: base -> intra-right's bank-0 slot
                    rows["send0"][r] = 1
                    rows["src_bank0"][r] = 1
                    rows["src_slot0"][r] = base_slot
                    rows["dst_slot0"][r] = 1 % c0
                    writes0.append((r, 1 % c0))
                    reads1.append((r, base_slot))
            else:
                slot = s % c0
                rows["consume_slot"][r] = slot
                rows["recv"][r] = 1
                reads0.append((r, slot))
                if s < n_intra - 1 and r + 1 < n_rounds:
                    rows["send0"][r] = 1
                    rows["src_slot0"][r] = slot
                    rows["dst_slot0"][r] = (s + 1) % c0
                    writes0.append((r, (s + 1) % c0))
                    reads0.append((r, slot))
    grants, takes = _assign_credits(n_rounds, c0, writes0, reads0)
    rows["grant0"], rows["take0"] = grants, takes
    grants, takes = _assign_credits(n_rounds, c1, writes1, reads1)
    rows["grant1"], rows["take1"] = grants, takes
    return RingProgram(
        kind="fwd", topology="double", n_inter=n_inter, n_intra=n_intra,
        slots=(c0, c1), channels=("cw", "inter"), copy_in=((1, 0),),
        rows={k: tuple(v) for k, v in rows.items()},
        rot_inter=tuple(rot_i), rot_intra=tuple(rot_s))


# ---------------------------------------------------------------------------
# backward compiler: the q-side bundle replays the forward movement; the
# dq plan is layered on top


def compile_bwd(topology: str, n_intra: int, n_inter: int = 1, *,
                slots: int = 2, slots1: Optional[int] = None,
                dq_slots: Optional[int] = None,
                r_live: Optional[int] = None) -> RingProgram:
    """Compile a backward schedule: the bundle rotates exactly like the
    forward KV (same banks/channels/credits), and a dq plan rides along —
    one accumulating ring per direction, each one hop behind its bundle,
    with a direct return-home hop at the end (see module docstring).

    r_live: occupancy truncation (see compile_fwd).  The backward's roles
    flip — the q bundle rotates past resident KV — so a live-offset
    PREFIX {0..K} means the bundle must visit offsets 0..K of the OTHER
    direction: the truncated program rotates the bundle counter-clockwise
    for K hops (each device serves q-parts me, me+1, .., me+K in order)
    and the dq partial rides one hop behind on the same ccw stream, with
    a single +K return-home hop.  That is strictly fewer rounds, sends
    and credits than the dense program's round-0-plus-tail live set.
    uni/bidi only (a truncated bidi bwd uses the same single-direction
    program); the double bwd keeps its dense dq plan — its cycle-boundary
    folds are not prefix-truncatable — and relies on the per-round masks
    for dead rounds.  r_live == 1 is refused: the program
    would need a zero-offset self-home hop (callers route the self-only
    case to the scan ring).
    """
    world = n_inter * n_intra
    if r_live is not None:
        if not (1 <= r_live <= world):
            raise ScheduleError(
                f"r_live must be in [1, world={world}], got {r_live}")
        if r_live < world and topology in ("uni", "bidi"):
            if r_live == 1:
                raise ScheduleError(
                    "bwd r_live truncation needs r_live >= 2 (a self-only "
                    "ring has no dq return hop)")
            prog = _compile_bwd_truncated(world, r_live, slots,
                                          slots if dq_slots is None
                                          else dq_slots)
            return prog
        r_live = None  # dense (r_live == world, or double: see docstring)
    fwd = compile_fwd(topology, n_intra, n_inter, slots=slots, slots1=slots1)
    n_rounds = fwd.n_rounds
    rows = {k: list(v) for k, v in fwd.rows.items()}
    for idx in range(FWD_COLS, BWD_COLS):
        rows[_COL_NAMES[idx]] = [0] * n_rounds
    dq_c = min(max(2, slots if dq_slots is None else dq_slots), n_rounds)
    world = fwd.world

    if topology in ("uni", "bidi"):
        order = ([("cw", j) for j in range(world)] if topology == "uni"
                 else _bidi_order(world))
        h = {"cw": 0, "ccw": 0}
        for d, j in order:
            h[d] = max(h[d], j)
        c_by = {"cw": min(dq_c, h["cw"] + 1) if h["cw"] else 1,
                "ccw": min(dq_c, h["ccw"] + 1) if h["ccw"] else 1}
        servings = {"cw": [], "ccw": []}
        for r, (d, j) in enumerate(order):
            bank = 0 if d == "cw" else 1
            c = c_by[d]
            slot = j % c
            rows["dq_bank"][r] = bank
            rows["dq_slot"][r] = slot
            # each direction's ring SEEDS at its first serving round (cw:
            # the self round j=0; ccw: j=1, the first ccw bundle) — no
            # partial is in flight yet there
            seed = j == (0 if d == "cw" else 1)
            rows["dq_recv"][r] = int(not seed)
            servings[d].append((r, slot, not seed))
            if j < h[d]:
                rows["dq_send"][r] = DQ_RING
                rows["dq_dst_slot"][r] = (j + 1) % c
            else:
                rows["dq_send"][r] = DQ_HOME
        for d, bank in (("cw", 0), ("ccw", 1)):
            if not servings[d]:
                continue
            grants, takes = _assign_dq_credits(n_rounds, servings[d])
            rows[f"dq_grant{bank}"] = grants
            rows[f"dq_take{bank}"] = takes
        if topology == "uni":
            dq_slots_t = (c_by["cw"],)
            homes = ((0, -h["cw"] % world),)
        else:
            dq_slots_t = ((c_by["cw"], c_by["ccw"]) if h["ccw"]
                          else (c_by["cw"],))
            homes = (((0, -h["cw"] % world), (0, h["ccw"]))
                     if h["ccw"] else ((0, -h["cw"] % world),))
    else:  # double
        n_i, n_s = fwd.n_inter, fwd.n_intra
        c0 = min(dq_c, n_s)
        c1 = min(2, n_i)
        servings0 = []  # intra dq ring
        servings1 = []  # inter (boundary) ping/pong accumulator
        for c in range(n_i):
            for s in range(n_s):
                r = c * n_s + s
                slot = s % c0
                rows["dq_slot"][r] = slot
                rows["dq_recv"][r] = int(s > 0)
                servings0.append((r, slot, s > 0))
                boundary = s == n_s - 1
                if not boundary:
                    rows["dq_send"][r] = DQ_RING
                    rows["dq_dst_slot"][r] = (s + 1) % c0
                else:
                    if c > 0:
                        rows["dqi_recv"][r] = 1
                        rows["dqi_slot"][r] = (c - 1) % c1
                        servings1.append((r, (c - 1) % c1, True))
                    if c < n_i - 1:
                        rows["dq_send"][r] = DQ_BOUNDARY
                        rows["dqi_dst_slot"][r] = c % c1
                    else:
                        rows["dq_send"][r] = DQ_FINAL
        grants, takes = _assign_dq_credits(n_rounds, servings0)
        rows["dq_grant0"], rows["dq_take0"] = grants, takes
        grants, takes = _assign_dq_credits(n_rounds, servings1)
        rows["dq_grant1"], rows["dq_take1"] = grants, takes
        dq_slots_t = (c0, c1)
        homes = ((1, 1),)  # composed inter+1, intra+1 final hop
    return RingProgram(
        kind="bwd", topology=topology, n_inter=fwd.n_inter,
        n_intra=fwd.n_intra, slots=fwd.slots, channels=fwd.channels,
        copy_in=fwd.copy_in, rows={k: tuple(v) for k, v in rows.items()},
        rot_inter=fwd.rot_inter, rot_intra=fwd.rot_intra,
        dq_slots=dq_slots_t, home_offsets=homes)


def _compile_bwd_truncated(world: int, r_live: int, slots: int,
                           dq_slots: int) -> RingProgram:
    """Occupancy-truncated backward: one ccw bundle stream, one ccw dq ring.

    Round j consumes the bundle of q-part me+j (rot_intra[j] = -j mod
    world): the bundle seeds locally (copy_in), travels ccw one hop per
    round, and stops after K = r_live - 1 hops — beyond that every q-part
    is outside the live band on every device, so the rounds are simply
    absent.  The dq partial for the held bundle accumulates one hop behind
    on the same stream (seeded at round 0, ring-forwarded ccw, merged on
    arrival), and at round K the finished partial — by then K devices
    ccw-forward of its owner — returns home with one +K cw hop
    (home_offsets (0, K)).  Credits come from the same assigners as every
    other program."""
    n_rounds = r_live
    k_last = r_live - 1
    c0 = max(min(slots, r_live), 1)
    rows = _blank_rows(n_rounds, BWD_COLS)
    writes = [(0, 0)]  # copy-in = version 0 of slot 0
    reads = []
    for j in range(n_rounds):
        slot = j % c0
        rows["consume_slot"][j] = slot
        rows["recv"][j] = int(j > 0)
        reads.append((j, slot))
        if j < k_last:
            rows["send0"][j] = 1
            rows["src_slot0"][j] = slot
            rows["dst_slot0"][j] = (j + 1) % c0
            writes.append((j, (j + 1) % c0))
            reads.append((j, slot))
    grants, takes = _assign_credits(n_rounds, c0, writes, reads)
    rows["grant0"], rows["take0"] = grants, takes
    dq_c = min(max(2, dq_slots), r_live) if k_last else 1
    servings = []
    for j in range(n_rounds):
        slot = j % dq_c
        rows["dq_slot"][j] = slot
        rows["dq_recv"][j] = int(j > 0)
        servings.append((j, slot, j > 0))
        if j < k_last:
            rows["dq_send"][j] = DQ_RING
            rows["dq_dst_slot"][j] = (j + 1) % dq_c
        else:
            rows["dq_send"][j] = DQ_HOME
    grants, takes = _assign_dq_credits(n_rounds, servings)
    rows["dq_grant0"], rows["dq_take0"] = grants, takes
    return RingProgram(
        kind="bwd", topology="uni", n_inter=1, n_intra=world,
        slots=(c0,), channels=("ccw",), copy_in=((0, 0),),
        rows={k: tuple(v) for k, v in rows.items()},
        rot_inter=(0,) * n_rounds,
        rot_intra=tuple((world - j) % world for j in range(n_rounds)),
        dq_slots=(dq_c,), home_offsets=((0, k_last),))


# ---------------------------------------------------------------------------
# lowerings


def scan_events(program: RingProgram):
    """Lower to the scan ring's ordered stream of (cls, axis, hops)
    rotations: the stream `parallel/burst._fwd_impl` realizes for the uni
    and double topologies; bidi is a fused-only topology but still lowers
    here so its hops are accounted."""
    ev = []
    if program.topology == "double":
        # row-driven so r_live-truncated programs account only the sends
        # they kept; identical to the legacy cycle-major enumeration for
        # dense programs (send1 precedes send0 within a round)
        for r in range(program.n_rounds):
            if program.rows["send1"][r]:
                ev.append(("pay", "inter", 1))
            if program.rows["send0"][r]:
                ev.append(("pay", "intra", 1))
        return ev
    if program.topology == "uni":
        # the truncated bwd program rotates its single stream ccw
        sign = -1 if program.channels == ("ccw",) else 1
        return [("pay", "intra", sign)] * (program.n_rounds - 1)
    # bidi: one event per send, signed direction via hops +-1
    for r in range(program.n_rounds):
        if program.rows["send0"][r]:
            ev.append(("pay", "intra", 1))
        if program.rows["send1"][r]:
            ev.append(("pay", "intra", -1))
    return ev


def hop_totals(program: RingProgram):
    """Per-axis payload hop totals of the compiled schedule — what
    `parallel/ring.ring_round_counts` reports per dispatch."""
    totals = {"intra": 0, "inter": 0}
    for cls, axis, hops in scan_events(program):
        totals[axis] += abs(hops)
    return totals


def partition_for_round(program: RingProgram, r: int, inter_rank, intra_rank):
    """Partition id of the payload a ring position consumes at round r:
    the IR's rotation pair applied to the position's ring coordinates.
    Matches parallel/ring.partition_at_round for the uni/double visit
    order."""
    n_i, n_s = program.n_inter, program.n_intra
    ci = (inter_rank - program.rot_inter[r]) % n_i
    si = (intra_rank - program.rot_intra[r]) % n_s
    return ci * n_s + si


def bank_dirs(program: RingProgram) -> Tuple[str, ...]:
    """Labels of the slot banks, in bank order (cw, ccw or inter)."""
    return program.channels


def wire_itemsize(wire: Optional[str], dense_itemsize: int = 4) -> int:
    """Bytes per element a rotating operand ships under a wire dtype."""
    if wire is None:
        return dense_itemsize
    if wire not in ("int8", "fp8"):
        raise ScheduleError(f"unknown wire dtype {wire!r}")
    return 1


def wire_round_bytes(pass_: str, wire: Optional[str], *, b: int, n: int,
                     n_kv: int, s: int, d: int, opt_comm: bool = True,
                     itemsize: int = 4) -> Dict[str, int]:
    """Per-round per-position payload bytes each rotating stream ships over
    one ring hop, by stream name (the JAX package's derivation):

      fwd  {"kv": ...}                    the k+v chunk (+ scales)
      bwd  {"bundle": ..., "dq": ...}     the q-side bundle (+ scales) and
                                          the streamed dq partial

    `itemsize` is the dense per-element width the count assumes (4, the
    JAX package's fp32 rows, by default).  Quantized streams ship 1 byte
    an element plus one fp32 scale per quantized block at the scan ring's
    granularity (fwd: per (batch, kv head); bundle: per (batch, head) per
    operand; dq: per (batch, head)); lse always ships b*n*s fp32.  Shapes
    are per position.  The burst.wire_bytes counters integrate it per
    dispatch."""
    wi = wire_itemsize(wire, itemsize)
    scale_b = 0 if wire is None else 4
    if pass_ == "fwd":
        return {"kv": 2 * b * n_kv * s * d * wi + 2 * b * n_kv * scale_b}
    if pass_ != "bwd":
        raise ValueError(f"pass_ must be 'fwd' or 'bwd', got {pass_!r}")
    # bundle: (delta | o), do, q quantize; lse stays fp32
    first = b * n * s * (4 if wire is None else 1) if opt_comm \
        else b * n * s * d * wi
    bundle = (first + 2 * b * n * s * d * wi      # do + q
              + b * n * s * 4                      # lse (fp32, exempt)
              + 3 * b * n * scale_b)               # delta|o, do, q scales
    dq = b * n * s * d * (4 if wire is None else 1) + b * n * scale_b
    return {"bundle": bundle, "dq": dq}
