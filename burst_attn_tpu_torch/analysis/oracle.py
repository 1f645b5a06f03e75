"""Host-side schedule oracle for the ring verifiers (the JAX package's
burst_attn_tpu/analysis/oracle.py, numpy only, carried over as it is).

Generates, for a ring topology (n_inter, n_intra, r_live), the EXPECTED
ordered stream of collective events the burst forward / backward shard
programs must issue, and proves — by direct simulation on host integers —
that the expected backward stream really returns every dq contribution to
the device owning its query partition.  The stream the real code
issues (recorded by parallel/mesh.record_collectives while the scan ring
runs) is then required to match the proven stream exactly, so a topology
bug (wrong hop count, missing return-home hop, prefetch landing a cycle
late, truncation referencing a dead round) becomes a static finding
instead of a wrong gradient at scale.

Event convention: (cls, axis, hops) with cls in {"pay", "dq", "a2a"},
axis in {"intra", "inter"} (flat rings use "intra"), hops the rotation
offset (always forward: rank i -> i + hops mod n).  Streams are flat and
in issue order; scan bodies are unrolled.  Runs of identical consecutive
events are compared run-length-encoded (see encode_runs).
"""

from typing import List, Set, Tuple

import numpy as np

Event = Tuple[str, str, int]


# ---------------------------------------------------------------------------
# schedules (mirrors parallel/ring.ring_schedule — duplicated here on
# purpose: the analyzer must not trust the code under test)


def ring_schedule(intra_size: int, inter_size: int = 1) -> np.ndarray:
    """[world, rounds] array: entry (device, r) = partition id held at
    ring round r under the (double-)ring visit order."""
    world = inter_size * intra_size
    out = np.empty((world, world), dtype=np.int64)
    for dev in range(world):
        inter_rank, intra_rank = divmod(dev, intra_size)
        for r in range(world):
            c, s = divmod(r, intra_size)
            out[dev, r] = ((inter_rank - c) % inter_size) * intra_size + (
                (intra_rank - s) % intra_size)
    return out


def expected_hop_totals(n_inter: int, n_intra: int, r_live=None):
    """Per-axis per-leaf forward hop totals, derived from schedule
    TRANSITIONS (not from the implementation's loop structure): one intra
    hop whenever the held partition's intra rank changes between visited
    rounds, one inter hop per cycle boundary (+ the prefetch convention
    that the inter hop replaces the boundary intra hop)."""
    if r_live is None:
        r_live = n_intra if n_inter == 1 else None
    if n_inter == 1:
        return {"intra": r_live - 1, "inter": 0}
    sched = ring_schedule(n_intra, n_inter)
    intra = inter = 0
    row = sched[0]
    for r in range(1, len(row)):
        prev, cur = row[r - 1], row[r]
        if prev // n_intra != cur // n_intra:
            inter += 1
        else:
            intra += 1
    # the boundary round's intra state is re-derived from the prefetched
    # cycle base, so each boundary also costs the intra ring its final
    # rotation back into cycle phase 0 — burst issues n_intra-1 intra hops
    # per cycle (the last round of a cycle never sends).
    return {"intra": n_inter * (n_intra - 1), "inter": inter}


# ---------------------------------------------------------------------------
# forward stream


def fwd_stream(n_inter: int, n_intra: int, r_live=None) -> List[Event]:
    """Expected forward collective stream: per cycle, the inter prefetch of
    the next cycle base is issued FIRST (one full intra cycle early), then
    the cycle's n_intra - 1 intra rotations (round 0 of cycle 0 is peeled
    but still sends; the last round of every cycle never sends)."""
    if r_live is None:
        r_live = n_intra if n_inter == 1 else n_intra
    ev: List[Event] = []
    for c in range(n_inter):
        if c < n_inter - 1:
            ev.append(("pay", "inter", 1))
        live = r_live if n_inter == 1 else n_intra
        ev += [("pay", "intra", 1)] * (live - 1)
    return ev


# ---------------------------------------------------------------------------
# backward stream + return-home proof


def bwd_stream(n_inter: int, n_intra: int, r_live=None) -> List[Event]:
    """Expected backward stream (payload rotations + dq add-and-forward
    ring + final return-home hops), mirroring the schedule semantics:

      cycle c: [inter payload prefetch]  (c < n_inter - 1)
               [inter dq fold-and-forward]  (c > 0)
               first round (no sends), then — when more rounds are live —
               one payload JUMP of n_intra - (r_live-1) hops over the dead
               middle, the scan's alternating payload/dq single hops, and
               the cycle's final dq rotation
      coda:    one inter dq hop (double ring), one intra dq hop.
    """
    if r_live is None:
        r_live = n_intra if n_inter == 1 else n_intra
    ev: List[Event] = []
    for c in range(n_inter):
        if c < n_inter - 1:
            ev.append(("pay", "inter", 1))
        if c > 0:
            ev.append(("dq", "inter", 1))
        live = r_live if n_inter == 1 else n_intra
        if live > 1:
            start = n_intra - (live - 1)
            ev.append(("pay", "intra", start))
            for _ in range(start, n_intra - 1):
                ev.append(("pay", "intra", 1))
                ev.append(("dq", "intra", 1))
            ev.append(("dq", "intra", 1))
    if n_inter > 1:
        ev.append(("dq", "inter", 1))
    if (r_live if n_inter == 1 else n_intra) > 1:
        ev.append(("dq", "intra", 1))
    return ev


def verify_dq_returns_home(n_inter: int, n_intra: int, r_live=None) -> None:
    """Prove by simulation that bwd_stream + the compute schedule return
    every dq contribution to the owner of its query partition.

    Device d = (ci, si) computes, at visited round r, the dq of the query
    partition it currently holds (per ring_schedule).  Contributions ride
    dq_intra within a cycle, fold into dq_inter at boundaries, and take
    the final return hops; truncated rings hold round 0's dq out in
    dq_home.  Raises AssertionError on any contribution landing wrong —
    the generated stream is only handed to the stream matcher if this
    proof passes."""
    if r_live is None:
        r_live = n_intra if n_inter == 1 else n_intra
    world = n_inter * n_intra
    truncated = n_inter == 1 and r_live < n_intra

    def rot(reg, axis, hops):
        """Move per-device contribution sets `hops` forward along axis."""
        new = [set() for _ in range(world)]
        for d in range(world):
            ci, si = divmod(d, n_intra)
            if axis == "intra":
                nd = ci * n_intra + (si + hops) % n_intra
            else:
                nd = ((ci + hops) % n_inter) * n_intra + si
            new[nd] |= reg[d]
        return new

    sched = ring_schedule(n_intra, n_inter)
    dq_intra = [set() for _ in range(world)]
    dq_inter = [set() for _ in range(world)]
    dq_home = [set() for _ in range(world)]

    def compute(r, into):
        for d in range(world):
            into[d].add((d, int(sched[d, r])))  # (computing device, q part)

    for c in range(n_inter):
        if c > 0:
            for d in range(world):
                dq_inter[d] |= dq_intra[d]
            dq_inter = rot(dq_inter, "inter", 1)
            dq_intra = [set() for _ in range(world)]
        live = r_live if n_inter == 1 else n_intra
        compute(c * n_intra, dq_home if truncated else dq_intra)
        if live > 1:
            start = n_intra - (live - 1)
            # payload jumps `start` hops; dq_intra is all-zero then (cycle
            # start), so only the visited rounds' rotations matter
            for s_idx in range(start, n_intra - 1):
                dq_intra = rot(dq_intra, "intra", 1)
                compute(c * n_intra + s_idx, dq_intra)
            dq_intra = rot(dq_intra, "intra", 1)
            compute(c * n_intra + n_intra - 1, dq_intra)
    final = [dq_inter[d] | dq_intra[d] for d in range(world)]
    if n_inter > 1:
        final = rot(final, "inter", 1)
    if (r_live if n_inter == 1 else n_intra) > 1:
        final = rot(final, "intra", 1)
    for d in range(world):
        final[d] |= dq_home[d]
    for d in range(world):
        for (_src, part) in final[d]:
            assert part == d, (
                f"dq of partition {part} landed on device {d} "
                f"(n_inter={n_inter}, n_intra={n_intra}, r_live={r_live})")
    # completeness: every visited (device, round) contribution arrived
    n_contrib = sum(len(s) for s in final)
    visited = world * (r_live if n_inter == 1 else n_intra * n_inter)
    assert n_contrib == visited, (n_contrib, visited)


# ---------------------------------------------------------------------------
# fused ring (in-kernel RDMA rotation, ops/fused_ring.py)


def fused_slot_schedule(world: int, slots: int) -> List[int]:
    """Independent derivation of the fused kernel's per-round KV-slot ids
    (duplicated from parallel/ring.fused_slot_schedule on purpose — the
    analyzer must not trust the code under test).  Round r consumes slot
    r mod C with C = min(slots, world)."""
    return [r % min(slots, world) for r in range(world)]


def verify_fused_ring(world: int, slots: int, slot_sched=None) -> None:
    """Prove by simulation that the fused ring's schedule + semaphore
    protocol is correct, raising AssertionError otherwise:

      delivery      with every device sending its round-r chunk from
                    slot[r] to the RIGHT neighbor's slot[r+1], the chunk a
                    device reads at round r is partition ring_schedule[d, r]
                    — i.e. neighbor-only (+1) sends reproduce the exact
                    schedule the scan ring realizes with ppermute.
      hop count     every chunk travels exactly world - 1 hops (each of the
                    world - 1 per-device sends moves one chunk one hop).
      slot safety   under the capacity handshake (a sender at round
                    r >= C-1 consumes a free credit the receiver grants
                    only after finishing round r+1-C), a maximally-ahead
                    sender can never overwrite a slot version the receiver
                    has not consumed yet.  Simulated with the sender
                    running unboundedly ahead of the receiver.
    """
    C = min(slots, world)
    assert C >= 2, f"fused ring needs >= 2 slots, got {slots}"
    if slot_sched is None:
        slot_sched = fused_slot_schedule(world, slots)
    slot_sched = [int(x) for x in slot_sched]
    assert len(slot_sched) == world, (len(slot_sched), world)
    assert all(0 <= s < C for s in slot_sched), slot_sched

    # ---- delivery + hop count (lockstep rounds) ----
    sched = ring_schedule(world, 1)
    buf = [{slot_sched[0]: d} for d in range(world)]  # slot -> partition id
    hops = {d: 0 for d in range(world)}  # partition -> hops traveled
    for r in range(world):
        sends = []
        for d in range(world):
            assert slot_sched[r] in buf[d], (
                f"device {d} round {r}: slot {slot_sched[r]} never written")
            part = buf[d][slot_sched[r]]
            assert part == int(sched[d, r]), (
                f"device {d} round {r}: holds partition {part}, schedule "
                f"says {int(sched[d, r])}")
            if r < world - 1:
                sends.append(((d + 1) % world, slot_sched[r + 1], part))
        for dst_dev, dst_slot, part in sends:  # all transfers in flight at once
            buf[dst_dev][dst_slot] = part
            hops[part] += 1
    for part, h in hops.items():
        assert h == world - 1, f"partition {part} made {h} hops, not {world - 1}"

    # ---- slot safety: maximally-ahead sender vs slowest receiver ----
    # Versions: the receiver must read version r of slot[r] at round r
    # (version 0 = its own initial copy-in).  The sender may issue the
    # round-r send as soon as its credits allow; each grant is emitted when
    # the receiver FINISHES round t (t <= world-1-C).
    consumed = 0          # receiver's completed rounds
    credits = 0           # unconsumed free credits held by the sender
    slot_version = {slot_sched[0]: 0}
    pending = []          # writes the receiver has not yet read
    for rs in range(world - 1):  # sender's rounds, run as early as possible
        if rs >= C - 1:
            # sender needs one credit: receiver must have finished rounds
            # up to rs + 1 - C before this write may land
            while credits == 0:
                # receiver consumes its next round
                t = consumed
                got = slot_version.get(slot_sched[t])
                assert got == t, (
                    f"receiver reads slot {slot_sched[t]} at round {t} but "
                    f"holds version {got} — overwritten before read")
                consumed += 1
                if t <= world - 1 - C:
                    credits += 1
            credits -= 1
        assert consumed >= rs + 1 - C, (consumed, rs)
        slot_version[slot_sched[rs + 1]] = rs + 1
    while consumed < world:  # receiver drains the tail
        t = consumed
        got = slot_version.get(slot_sched[t])
        assert got == t, (
            f"receiver reads slot {slot_sched[t]} at round {t} but holds "
            f"version {got} — overwritten before read")
        consumed += 1


def fused_bwd_slot_schedule(world: int, slots: int) -> List[int]:
    """Independent derivation of the fused BACKWARD kernel's per-round slot
    ids (the JAX package's parallel/ring.fused_bwd_slot_schedule, kept
    here on purpose —
    the analyzer must not trust the code under test).  Both concurrent
    streams — the q-side bundle and the dq ring — consume slot r mod C at
    round r, C = min(slots, world); the dq return-home hop targets the
    dedicated HOME slot (index C) outside this cycle."""
    return [r % min(slots, world) for r in range(world)]


def verify_fused_ring_bwd(world: int, slots: int, slot_sched=None) -> None:
    """Prove by simulation that the fused backward's schedule + semaphore
    protocol is correct, raising AssertionError otherwise:

      bundle delivery  with every device sending its round-r bundle from
                    slot[r] to the RIGHT neighbor's slot[r+1], the q-side
                    payload a device reads at round r is partition
                    ring_schedule[d, r] — the same schedule the scan
                    backward realizes with ppermute — and every bundle
                    travels exactly world - 1 hops.
      dq return-home   simulating the add-and-forward dq stream (each
                    device folds its round-r contribution into the partial
                    arriving one hop behind the bundle, then streams it
                    onward; round world-1 sends into the right neighbor's
                    HOME slot), every partition's gradient lands on its
                    owner EXACTLY once, carrying all `world` per-device
                    contributions.
      slot safety   under the capacity handshake, a maximally-ahead sender
                    can never overwrite a slot version its receiver has
                    not consumed — proven for the bundle stream (sends at
                    round r's first step, the forward's phase) AND the dq
                    stream (sends streamed DURING round r, one hop behind).
    """
    C = min(slots, world)
    assert C >= 2, f"fused bwd ring needs >= 2 slots, got {slots}"
    if slot_sched is None:
        slot_sched = fused_bwd_slot_schedule(world, slots)
    slot_sched = [int(x) for x in slot_sched]
    assert len(slot_sched) == world, (len(slot_sched), world)
    assert all(0 <= s < C for s in slot_sched), slot_sched

    # ---- bundle delivery + hop count: the rotation topology is identical
    # to the forward KV ring, so the same lockstep simulation applies ----
    sched = ring_schedule(world, 1)
    buf = [{slot_sched[0]: d} for d in range(world)]  # slot -> q partition
    hops = {d: 0 for d in range(world)}
    for r in range(world):
        sends = []
        for d in range(world):
            assert slot_sched[r] in buf[d], (
                f"device {d} round {r}: bundle slot {slot_sched[r]} never "
                "written")
            part = buf[d][slot_sched[r]]
            assert part == int(sched[d, r]), (
                f"device {d} round {r}: holds bundle of partition {part}, "
                f"schedule says {int(sched[d, r])}")
            if r < world - 1:
                sends.append(((d + 1) % world, slot_sched[r + 1], part))
        for dst_dev, dst_slot, part in sends:
            buf[dst_dev][dst_slot] = part
            hops[part] += 1
    for part, h in hops.items():
        assert h == world - 1, (
            f"bundle of partition {part} made {h} hops, not {world - 1}")

    # ---- dq add-and-forward + return-home (lockstep rounds) ----
    # register[d] = set of (contributing device, partition) pairs in the dq
    # partial device d holds for its CURRENT round; home[d] = what landed in
    # d's HOME slot.  A wrong hop order, a dropped fold, or a misdirected
    # final hop all break the exactly-once-with-all-contributions assert.
    reg = [set() for _ in range(world)]
    home = [None] * world
    for r in range(world):
        for d in range(world):
            part = int(sched[d, r])
            reg[d] = reg[d] | {(d, part)}
            parts = {p for (_, p) in reg[d]}
            assert parts == {part}, (
                f"device {d} round {r}: dq partial mixes partitions {parts}")
        if r < world - 1:
            reg = [reg[(d - 1) % world] for d in range(world)]  # one hop right
        else:
            for d in range(world):  # return-home hop into HOME slots
                dst = (d + 1) % world
                assert home[dst] is None, (
                    f"device {dst}: HOME slot written twice")
                home[dst] = reg[d]
    for d in range(world):
        assert home[d] is not None, f"device {d}: dq never arrived home"
        want = {((d + t) % world, d) for t in range(world)}
        assert home[d] == want, (
            f"device {d}: home dq carries {home[d]}, expected every "
            f"contribution of partition {d}: {want}")

    # ---- slot safety: maximally-ahead sender vs slowest receiver ----
    # Bundle stream: sends at round rs read slot[rs] and land version rs+1;
    # the receiver reads version r of slot[r] at round r (version 0 = its
    # own copy-in).  Identical protocol to the forward KV ring.
    consumed, credits = 0, 0
    slot_version = {slot_sched[0]: 0}
    for rs in range(world - 1):
        if rs >= C - 1:
            while credits == 0:
                t = consumed
                got = slot_version.get(slot_sched[t])
                assert got == t, (
                    f"bundle: receiver reads slot {slot_sched[t]} at round "
                    f"{t} but holds version {got} — overwritten before read")
                consumed += 1
                if t <= world - 1 - C:
                    credits += 1
            credits -= 1
        assert consumed >= rs + 1 - C, (consumed, rs)
        slot_version[slot_sched[rs + 1]] = rs + 1
    while consumed < world:
        t = consumed
        got = slot_version.get(slot_sched[t])
        assert got == t, (
            f"bundle: receiver reads slot {slot_sched[t]} at round {t} but "
            f"holds version {got} — overwritten before read")
        consumed += 1

    # Dq stream: phase-shifted — the round-(t) partial is STREAMED during
    # the sender's round t-1 (after each block's fold), so sender round rs
    # writes version rs+1; the receiver consumes no dq at round 0 and must
    # find version t in slot[t] at rounds 1..world-1.  Credits follow the
    # same grant/take schedule as the bundle (one per stream).
    consumed, credits = 0, 0
    dq_version = {}
    for rs in range(world - 1):
        if rs >= C - 1:
            while credits == 0:
                t = consumed
                if t > 0:
                    got = dq_version.get(slot_sched[t])
                    assert got == t, (
                        f"dq: receiver reads slot {slot_sched[t]} at round "
                        f"{t} but holds version {got} — overwritten before "
                        "read")
                consumed += 1
                if t <= world - 1 - C:
                    credits += 1
            credits -= 1
        assert consumed >= rs + 1 - C, (consumed, rs)
        dq_version[slot_sched[rs + 1]] = rs + 1
    while consumed < world:
        t = consumed
        if t > 0:
            got = dq_version.get(slot_sched[t])
            assert got == t, (
                f"dq: receiver reads slot {slot_sched[t]} at round {t} but "
                f"holds version {got} — overwritten before read")
        consumed += 1


# ---------------------------------------------------------------------------
# windowed truncation


def live_rounds_contig(seq: int, world: int, window: int) -> Set[int]:
    """Independent (dense numpy) derivation of the live round set of a
    windowed causal CONTIG single ring: round r is live iff any device's
    (q chunk, kv chunk held at round r) block intersects the causal band
    mask.  The implementation's static truncation must keep exactly this
    set — truncating a live round loses attention mass, keeping a dead
    round wastes a permute and can reference garbage."""
    s = seq // world
    live = set()
    for r in range(world):
        for d in range(world):
            kv_part = (d - r) % world
            qs = np.arange(d * s, (d + 1) * s)[:, None]
            ks = np.arange(kv_part * s, (kv_part + 1) * s)[None, :]
            m = (ks <= qs) & (ks > qs - window)
            if m.any():
                live.add(r)
                break
    return live


def live_rounds_contig_seg(seq: int, world: int,
                           max_segment_len: int) -> Set[int]:
    """Independent (dense numpy) derivation of the live round set of a
    length-bounded packed-segment causal CONTIG single ring: round r is
    live iff SOME admissible segment-id assignment (every segment at most
    `max_segment_len` tokens) puts a shared segment across some device's
    (q chunk, kv chunk at round r) causal block.  Sweeping a length-L
    tiling over all L phase offsets realizes every achievable chunk-to-
    chunk segment reach, so the union over offsets is the adversarial
    (worst-case) live set the compiler's contract-based elision must keep
    exactly."""
    s = seq // world
    live = set()
    L = max_segment_len
    for r in range(world):
        found = False
        for off in range(L):
            for d in range(world):
                kv_part = (d - r) % world
                qs = np.arange(d * s, (d + 1) * s)[:, None]
                ks = np.arange(kv_part * s, (kv_part + 1) * s)[None, :]
                m = (ks <= qs) & ((qs + off) // L == (ks + off) // L)
                if m.any():
                    live.add(r)
                    found = True
                    break
            if found:
                break
    return live


def encode_runs(events: List[Event]) -> List[Tuple[str, str, int, int]]:
    """Run-length encode consecutive identical events: (cls, axis, hops,
    count).  Both oracle and extracted streams are compared in this form
    (payload leaf fan-out is divided out before encoding)."""
    out: List[Tuple[str, str, int, int]] = []
    for ev in events:
        if out and out[-1][:3] == ev:
            out[-1] = (*ev, out[-1][3] + 1)
        else:
            out.append((*ev, 1))
    return out


# ---------------------------------------------------------------------------
# compiled ring programs (parallel/schedule.py)
#
# The schedule compiler emits arbitrary topologies (uni, bidi, double);
# instead of re-deriving each one here, the oracle PROVES every emitted
# program by direct simulation on host integers — delivery of the declared
# rotation schedule, exactly-once consumption, per-bank overwrite-before-
# read safety under the compiled credit schedule with a maximally-ahead
# sender, the double ring's prefetch-distance obligation, and (backward)
# the dq streams' exactly-once return-home with all `world` contributions.
# The program arrives as a plain dict (RingProgram.export()) so the proof
# runs on the raw op table, trusting nothing about how it was built.


def _neighbor(prog, d, direction, hops=1):
    """Flat id of the device `hops` forward of d along a channel dir."""
    n_i, n_s = prog["n_inter"], prog["n_intra"]
    ci, si = divmod(d, n_s)
    if direction == "cw":
        return ci * n_s + (si + hops) % n_s
    if direction == "ccw":
        return ci * n_s + (si - hops) % n_s
    if direction == "inter":
        return ((ci + hops) % n_i) * n_s + si
    raise AssertionError(f"unknown channel dir {direction!r}")


def _expected_part(prog, d, r):
    n_i, n_s = prog["n_inter"], prog["n_intra"]
    ci, si = divmod(d, n_s)
    return (((ci - prog["rot_inter"][r]) % n_i) * n_s
            + (si - prog["rot_intra"][r]) % n_s)


def _prove_payload_delivery(prog) -> None:
    """Lockstep simulation of the payload banks: every consume sees the
    partition the rotation schedule declares, every send is a single
    channel hop, and (full rings) every device consumes every partition
    exactly once."""
    rows = prog["rows"]
    world = prog["n_inter"] * prog["n_intra"]
    n_rounds = len(prog["rot_intra"])
    banks = [dict() for _ in range(world)]  # (bank, slot) -> partition
    seen = [set() for _ in range(world)]
    for d in range(world):
        for bank, slot in prog["copy_in"]:
            banks[d][(bank, slot)] = d
    channels = prog["channels"]
    for r in range(n_rounds):
        key = (rows["consume_bank"][r], rows["consume_slot"][r])
        for d in range(world):
            assert key in banks[d], (
                f"device {d} round {r}: bank/slot {key} never written")
            part = banks[d][key]
            want = _expected_part(prog, d, r)
            assert part == want, (
                f"device {d} round {r}: holds partition {part}, the "
                f"program's rotation says {want}")
            assert part not in seen[d], (
                f"device {d} consumes partition {part} twice (round {r})")
            seen[d].add(part)
        sends = []
        for ch, direction in enumerate(channels):
            if not rows[f"send{ch}"][r]:
                continue
            src_bank = rows["src_bank0"][r] if ch == 0 else 1
            src_slot = rows[f"src_slot{ch}"][r]
            dst_slot = rows[f"dst_slot{ch}"][r]
            for d in range(world):
                src_key = (src_bank, src_slot)
                assert src_key in banks[d], (
                    f"device {d} round {r}: channel {ch} sends from "
                    f"unwritten {src_key}")
                sends.append((_neighbor(prog, d, direction), ch,
                              dst_slot, banks[d][src_key]))
        for dst, ch, dst_slot, part in sends:  # all transfers in flight
            banks[dst][(ch, dst_slot)] = part
    if n_rounds == world:
        for d in range(world):
            assert seen[d] == set(range(world)), (
                f"device {d} consumed {sorted(seen[d])}, not all of "
                f"0..{world - 1}")


def _prove_bank_safety(prog, bank: int) -> None:
    """Maximally-ahead sender vs slowest receiver for one payload bank,
    under the compiled credit schedule: the sender issues every write as
    early as its credits allow; no read may ever see a version other than
    the one the lockstep schedule intends."""
    rows = prog["rows"]
    n_rounds = len(prog["rot_intra"])
    # channel ch writes its own bank (channel index == dst bank id)
    writes = [(r, rows[f"dst_slot{bank}"][r]) for r in range(n_rounds)
              if rows[f"send{bank}"][r]]
    copy_slots = [slot for b, slot in prog["copy_in"] if b == bank]
    reads = []  # (receiver round, slot)
    for r in range(n_rounds):
        if rows["consume_bank"][r] == bank:
            reads.append((r, rows["consume_slot"][r]))
        for ch, _dir in enumerate(prog["channels"]):
            if rows[f"send{ch}"][r]:
                src_bank = rows["src_bank0"][r] if ch == 0 else 1
                if src_bank == bank:
                    reads.append((r, rows[f"src_slot{ch}"][r]))
    grants = [rows[f"grant{bank}"][r] for r in range(n_rounds)]
    takes = [rows[f"take{bank}"][r] for r in range(n_rounds)]
    _prove_async_safety(n_rounds, writes, reads, grants, takes, copy_slots,
                        what=f"payload bank {bank}")


def _prove_async_safety(n_rounds, writes, reads, grants, takes, copy_slots,
                        what: str) -> None:
    """Shared async proof: writes (sender round order) land the moment
    credits allow; the receiver walks its rounds in order and every read
    must see exactly the version the lockstep schedule intends (the last
    write issued at a sender round strictly before the reading round,
    counting round-0 copy-ins as version 0).  Credits are per slot
    (grants[r] carries slot + 1, a take consumes the written slot's own
    credit) — a fungible pool would let a grant meant for one slot
    license an early overwrite of another."""
    per_slot = {s: [-1] for s in copy_slots}  # write rounds; -1 = copy-in
    for r, s in writes:
        per_slot.setdefault(s, []).append(r)

    def expected_version(r, s):
        vi = -1
        for j, wr in enumerate(per_slot.get(s, [])):
            if wr < r:
                vi = j
        return vi

    reads_by_round = {}
    for r, s in reads:
        reads_by_round.setdefault(r, []).append(s)

    version = {s: 0 for s in copy_slots}  # current version INDEX per slot
    windex = {s: (1 if s in copy_slots else 0) for s in per_slot}
    consumed = 0  # receiver's completed rounds
    credits = {}  # slot -> available credits

    def receiver_step():
        nonlocal consumed
        t = consumed
        for s in reads_by_round.get(t, []):
            want = expected_version(t, s)
            got = version.get(s)
            assert got == want, (
                f"{what}: receiver reads slot {s} at round {t} holding "
                f"version {got}, schedule intends {want} — overwritten "
                "before read")
        if grants[t]:
            s = grants[t] - 1
            credits[s] = credits.get(s, 0) + 1
        consumed += 1

    for wr in sorted(set(r for r, _ in writes)):
        slots_here = [s for r, s in writes if r == wr]
        if takes[wr]:
            assert len(slots_here) == 1 or len(set(slots_here)) == 1, (
                f"{what}: take at round {wr} is ambiguous over slots "
                f"{slots_here}")
            s = slots_here[0]
            while credits.get(s, 0) < takes[wr]:
                assert consumed < n_rounds, (
                    f"{what}: sender starves at round {wr} waiting a slot-"
                    f"{s} credit — receiver drained (deadlock)")
                receiver_step()
            credits[s] -= takes[wr]
        for s in slots_here:
            version[s] = windex.get(s, 0)
            windex[s] = windex.get(s, 0) + 1
    while consumed < n_rounds:
        receiver_step()


def _prove_prefetch_distance(prog) -> None:
    """Double-ring obligation: the inter-prefetch payload must be in
    flight for at least one full intra cycle before its consume."""
    if "inter" not in prog["channels"]:
        return
    ch = prog["channels"].index("inter")
    rows = prog["rows"]
    n_rounds = len(prog["rot_intra"])
    n_intra = prog["n_intra"]
    for r in range(n_rounds):
        if not rows[f"send{ch}"][r]:
            continue
        dst_slot = rows[f"dst_slot{ch}"][r]
        consumes = [t for t in range(r + 1, n_rounds)
                    if rows["consume_bank"][t] == ch
                    and rows["consume_slot"][t] == dst_slot]
        assert consumes, (
            f"inter prefetch sent at round {r} into slot {dst_slot} is "
            "never consumed")
        dist = consumes[0] - r
        assert dist >= n_intra, (
            f"inter prefetch distance {dist} rounds < one intra cycle "
            f"({n_intra}) — the slow hop cannot hide (sent round {r}, "
            f"consumed round {consumes[0]})")


def _prove_dq_return_home(prog) -> None:
    """Backward streams: simulate the per-direction add-and-forward dq
    rings (one hop behind their bundles), the double ring's boundary folds
    into the inter accumulator, and every return-home hop — every
    partition's gradient must land on its owner exactly once carrying all
    `world` contributions."""
    rows = prog["rows"]
    world = prog["n_inter"] * prog["n_intra"]
    n_rounds = len(prog["rot_intra"])
    n_banks = len(prog["dq_slots"])
    cur = [[None] * n_banks for _ in range(world)]      # current partials
    pend = [[None] * n_banks for _ in range(world)]     # in-flight ring hops
    inter_held = [None] * world                         # double: dqi register
    inter_pend = [None] * world
    home = [set() for _ in range(world)]
    homes_written = [0] * world
    for r in range(n_rounds):
        bank = rows["dq_bank"][r]
        kind = rows["dq_send"][r]
        moves = []
        for d in range(world):
            if rows["dq_recv"][r]:
                assert pend[d][bank] is not None, (
                    f"device {d} round {r}: dq partial expected but none "
                    "in flight")
                cur[d][bank] = pend[d][bank]
                pend[d][bank] = None
            else:
                cur[d][bank] = set()
            part = _expected_part(prog, d, r)
            cur[d][bank] = cur[d][bank] | {(d, part)}
            parts = {p for _, p in cur[d][bank]}
            assert parts == {part}, (
                f"device {d} round {r}: dq partial mixes partitions "
                f"{sorted(parts)}")
            if rows["dqi_recv"][r]:
                assert inter_pend[d] is not None, (
                    f"device {d} round {r}: inter dq partial expected")
                inter_held[d] = inter_pend[d]
                inter_pend[d] = None
            if kind == 1:  # ring hop, one hop behind the bundle
                direction = prog["channels"][bank] if bank < len(
                    prog["channels"]) else ("ccw" if bank else "cw")
                moves.append(("ring", d, _neighbor(prog, d, direction),
                              bank, cur[d][bank]))
            elif kind == 2:  # direct return-home hop
                h_i, h_s = prog["home_offsets"][bank]
                tgt = _neighbor(prog, _neighbor(prog, d, "inter", h_i),
                                "cw", h_s)
                moves.append(("home", d, tgt, bank, cur[d][bank]))
            elif kind == 3:  # boundary: fold inter_held, hop inter
                val = cur[d][bank] | (inter_held[d] or set())
                inter_held[d] = None
                moves.append(("inter", d, _neighbor(prog, d, "inter"),
                              bank, val))
            elif kind == 4:  # final: fold + composed home hop
                val = cur[d][bank] | (inter_held[d] or set())
                inter_held[d] = None
                h_i, h_s = prog["home_offsets"][0]
                tgt = _neighbor(prog, _neighbor(prog, d, "inter", h_i),
                                "cw", h_s)
                moves.append(("home", d, tgt, bank, val))
        for what, src, dst, bank_, val in moves:
            if what == "ring":
                pend[dst][bank_] = val
            elif what == "inter":
                assert inter_pend[dst] is None, (
                    f"device {dst}: inter dq partial overwritten in flight")
                inter_pend[dst] = val
            else:
                homes_written[dst] += 1
                home[dst] |= val
    expected_homes = sum(
        1 for r in range(n_rounds) if rows["dq_send"][r] in (2, 4))
    # contributors are derived from the ROTATION, not assumed dense: an
    # occupancy-truncated program only ever serves partition p on the
    # devices its kept rounds visit, and exactly those contributions (no
    # more, no fewer) must come home — a dense program reduces to the
    # historical all-`world` set.
    contributors = [set() for _ in range(world)]
    for r in range(n_rounds):
        for d in range(world):
            contributors[_expected_part(prog, d, r)].add(d)
    for d in range(world):
        assert homes_written[d] == expected_homes, (
            f"device {d}: {homes_written[d]} home arrivals, expected "
            f"{expected_homes}")
        want = {(src, d) for src in contributors[d]}
        assert home[d] == want, (
            f"device {d}: home dq carries {sorted(home[d])}, expected the "
            f"{len(want)} scheduled contributions of partition {d}")


def served_deltas(prog: dict) -> Set[int]:
    """Ring offsets (q_part - kv_part mod world) the program's kept rounds
    serve.  Forward programs rotate the KV side (offset = flat rotation);
    backward programs rotate the q side (offset = NEGATED flat rotation).
    This is the skip-safety vocabulary: an occupancy-elided program is
    correct iff this set equals the mask's live-offset set."""
    world = prog["n_inter"] * prog["n_intra"]
    n_s = prog["n_intra"]
    flat = [(prog["rot_inter"][r] * n_s + prog["rot_intra"][r]) % world
            for r in range(len(prog["rot_intra"]))]
    if prog["kind"] == "bwd":
        return {(-f) % world for f in flat}
    return set(flat)


def verify_ring_program(prog: dict, live_deltas=None) -> None:
    """Prove one compiled ring program (RingProgram.export() dict) by
    simulation; raises AssertionError with a specific message on the first
    violated obligation.  Called by burstlint's fused-ring-schedule rule
    for every topology the compiler can emit, and by the mutation tests
    with deliberately-corrupted programs (flipped direction, shortened
    prefetch distance, aliased slot) to prove the proof has teeth.

    live_deltas (optional iterable of ints): SKIP-SAFETY obligation for
    occupancy-elided programs — the kept rounds must serve exactly these
    ring offsets (ops/masks.live_delta_table's True entries): eliding a
    live offset loses attention mass, keeping a dead one reinstates the
    RDMA/sweep cost elision exists to remove.  Both directions fire the
    mutation tests in tests/test_torch_analysis.py."""
    assert prog["n_inter"] >= 1 and prog["n_intra"] >= 1
    wire = prog.get("wire")
    assert wire in (None, "int8", "fp8"), f"unknown wire dtype {wire!r}"
    world = prog["n_inter"] * prog["n_intra"]
    rows = prog["rows"]
    n_rounds = len(prog["rot_intra"])
    assert n_rounds <= world, (n_rounds, world)
    for r in range(n_rounds):
        b = rows["consume_bank"][r]
        assert 0 <= b < len(prog["slots"]), f"round {r}: bad bank {b}"
        assert 0 <= rows["consume_slot"][r] < prog["slots"][b], (
            f"round {r}: consume slot {rows['consume_slot'][r]} out of "
            f"range for bank {b} ({prog['slots'][b]} slots)")
    if live_deltas is not None:
        got = served_deltas(prog)
        want = set(int(x) for x in live_deltas)
        missing, extra = sorted(want - got), sorted(got - want)
        assert not missing, (
            f"elision dropped LIVE ring offsets {missing}: rounds with "
            "attending pairs would never be computed")
        assert not extra, (
            f"program keeps DEAD ring offsets {extra}: fully-masked rounds "
            "still cost RDMA + sweep — not elided")
    _prove_payload_delivery(prog)
    for bank in range(len(prog["slots"])):
        _prove_bank_safety(prog, bank)
    _prove_prefetch_distance(prog)
    if prog["kind"] == "bwd":
        _prove_dq_return_home(prog)
