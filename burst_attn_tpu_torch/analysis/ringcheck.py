"""Ring verifiers (port of burst_attn_tpu/analysis/ringcheck.py).

The JAX family abstractly traces the shard programs and walks their
jaxprs for collectives.  The port's ring runs eagerly on one device, so
the port RECORDS its collectives instead: parallel/mesh.py's
`record_collectives()` makes every `ppermute` append (cls, axis, hops) —
hops derived from the copies it actually made — and every `all_to_all`
("a2a", axis, None).  The real forward and backward of the scan ring
(`burst_attn` on the CPU, backend "jnp", tiny shapes: B1 N2 D16, S = 16 x
W) run under the recorder over a matrix of flat and double rings, and the
recorded streams are held to the host-side schedule oracle
(analysis/oracle.py, which keeps its own copy of the schedules: the
analyzer must not trust the code under test):

  ring-rotation       every ppermute is a bijective uniform rotation of
                      its axis.
  ring-hops           per-axis payload hop totals equal the oracle's
                      transition counts.
  ring-order          the full ordered event stream matches the oracle
                      stream — the double ring's prefetch exactly one
                      intra cycle early, the add-and-forward fold points.
  dq-return-home      the backward's dq substream matches the oracle
                      stream that verify_dq_returns_home PROVES returns
                      every contribution to its owner.
  window-truncation   the windowed (and max_segment_len) contig ring's
                      live-round prefix matches the independent dense
                      derivation: truncation never references a dead
                      round and never drops a live one.
  fused-ring-schedule every program the schedule compiler emits (uni,
                      bidi, double; fwd and bwd; dense and elided) is
                      simulation-proven by the oracle; the scan lowering
                      (schedule.scan_events / hop_totals) of every forward
                      program equals the oracle's stream; the legacy uni
                      slot view (ring.fused_slot_schedule) matches the
                      oracle's derivation.  Host only.
  fused-ring-fused    the card half (check_card): on the fused route,
                      forward and backward, the recorder sees ZERO
                      rotations (the ring lives inside kernels 8 and 9),
                      each pass launches its kernel exactly once with no
                      fallback, and kernel 8's in-kernel slot counters
                      equal the compiled program's per-slot consumes —
                      for uni, bidi, double and a windowed (elided)
                      program.  Without a card it does not run, and
                      says so (CARD_RULES).

Ulysses keeps the JAX contract: exactly 4 all_to_alls on its sequence
axis, no ppermute.
"""

import inspect
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .core import Finding, rule
from . import oracle

rule("ring-rotation", "trace",
     "every ppermute is a bijective uniform rotation of its axis")(None)
rule("ring-hops", "trace",
     "per-axis payload hop totals match the schedule oracle")(None)
rule("ring-order", "trace",
     "ordered collective stream matches the oracle (prefetch distance)")(
    None)
rule("dq-return-home", "trace",
     "bwd dq ring stream matches the proven return-home schedule")(None)
rule("window-truncation", "trace",
     "occupancy truncation (window band / max_segment_len reach) matches "
     "the independent dense live-set derivation")(None)
rule("fused-ring-schedule", "trace",
     "every schedule the compiler emits (uni, bidi, double; fwd AND bwd; "
     "dense and elided) is simulation-proven: delivery of the declared "
     "rotation, per-slot overwrite-before-read safety, prefetch distance "
     ">= one intra cycle, dq exactly-once return-home; its scan lowering "
     "equals the oracle stream")(None)
rule("fused-ring-fused", "card",
     "on the card's fused route the recorder sees zero rotations, each "
     "pass launches its kernel once with no fallback, and kernel 8's slot "
     "counters equal the compiled program's consumes — uni, bidi, double, "
     "elided")(None)

# the card rules this family cannot run without a CUDA device
CARD_RULES = {
    "fused-ring-fused": "needs the CUDA card (kernels 8 and 9 and their "
                        "launch counters); run `python -m "
                        "burst_attn_tpu_torch.analysis --card` there",
}


@dataclass
class RingEntry:
    name: str
    axes: Dict[str, int]          # {"sp": W} or {"inter": a, "intra": b}
    layout: str
    causal: bool
    window: Optional[int] = None
    max_segment_len: Optional[int] = None
    s_local: int = 16

    @property
    def world(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n


ENTRIES = [
    RingEntry("flat2-zigzag-causal", {"sp": 2}, "zigzag", True),
    RingEntry("flat4-zigzag-causal", {"sp": 4}, "zigzag", True),
    RingEntry("flat8-zigzag-causal", {"sp": 8}, "zigzag", True),
    RingEntry("flat4-striped-causal", {"sp": 4}, "striped", True),
    RingEntry("flat4-contig-noncausal", {"sp": 4}, "contig", False),
    RingEntry("flat8-contig-causal", {"sp": 8}, "contig", True),
    RingEntry("double-2x2-zigzag", {"inter": 2, "intra": 2}, "zigzag", True),
    RingEntry("double-2x4-zigzag", {"inter": 2, "intra": 4}, "zigzag", True),
    RingEntry("double-4x2-zigzag", {"inter": 4, "intra": 2}, "zigzag", True),
    RingEntry("window4-contig", {"sp": 4}, "contig", True, window=20),
    RingEntry("window8-contig", {"sp": 8}, "contig", True, window=20),
    RingEntry("segments4-contig", {"sp": 4}, "contig", True,
              max_segment_len=16),
]


def _anchor(fn) -> Tuple[str, int]:
    """file:line of an entry point, for clickable findings."""
    try:
        return inspect.getsourcefile(fn), inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):
        return "<trace>", 0


def _encode(events, findings, where, anchor):
    """Run-length encode recorded (cls, axis, hops) events into the
    oracle's (cls, axis, hops, count) form; a non-rotation is a
    ring-rotation finding and drops out of the stream."""
    path, line = anchor
    clean = []
    for cls, axis, hops in events:
        if cls == "a2a":
            continue
        if hops is None:
            findings.append(Finding(
                rule="ring-rotation", file=path, line=line,
                message=f"{where}: a {cls} permutation on axis {axis!r} is "
                        "not a bijective uniform rotation"))
            continue
        clean.append((cls, axis, hops))
    return oracle.encode_runs(clean)


def _match_streams(got, want, rule_name, where, findings, anchor,
                   only_cls=None):
    if only_cls is not None:
        got = [r for r in got if r[0] == only_cls]
        want = [r for r in want if r[0] == only_cls]
    if got != want:
        path, line = anchor
        findings.append(Finding(
            rule=rule_name, file=path, line=line,
            message=f"{where}: collective stream mismatch — expected "
                    f"{want}, recorded {got}"))


def _check_totals(got_runs, expected, where, findings, anchor):
    path, line = anchor
    totals = {"intra": 0, "inter": 0}
    for cls, axis, hops, count in got_runs:
        if cls != "pay":
            continue
        totals[axis] = totals.get(axis, 0) + hops * count
    for ax in ("intra", "inter"):
        want = expected.get(ax, 0)
        if totals[ax] != want:
            findings.append(Finding(
                rule="ring-hops", file=path, line=line,
                message=f"{where}: payload rotated {totals[ax]} {ax} hops, "
                        f"schedule oracle expects {want}"))


def verify_stream(events, *, kind: str, n_inter: int, n_intra: int,
                  r_live=None, where: str, anchor,
                  window: bool = False) -> List[Finding]:
    """Run the ring rules on one recorded collective stream.

    kind: "fwd" | "bwd".  Shared by verify_ring_entry (recording the real
    ring) and the mutation tests (recording seeded-bad rings); the oracle
    streams are recomputed — and the bwd one re-proven — here, so a
    caller cannot verify against a stale schedule."""
    findings: List[Finding] = []
    got = _encode(events, findings, where, anchor)
    if kind == "fwd":
        want = oracle.encode_runs(oracle.fwd_stream(n_inter, n_intra, r_live))
        _match_streams(got, want, "ring-order", where, findings, anchor)
        _check_totals(got, oracle.expected_hop_totals(n_inter, n_intra,
                                                      r_live),
                      where, findings, anchor)
        if window and r_live is not None:
            got_intra = sum(hops * cnt for cls, ax, hops, cnt in got
                            if cls == "pay" and ax == "intra")
            if got_intra != r_live - 1:
                findings.append(Finding(
                    rule="window-truncation", file=anchor[0], line=anchor[1],
                    message=f"{where}: fwd issues {got_intra} intra hops "
                            f"but the band mask proves {r_live} live rounds "
                            f"({r_live - 1} hops) — truncation references a "
                            "dead round or drops a live one"))
    else:
        oracle.verify_dq_returns_home(n_inter, n_intra, r_live)
        want = oracle.encode_runs(oracle.bwd_stream(n_inter, n_intra, r_live))
        _match_streams(got, want, "ring-order", where, findings, anchor)
        _match_streams(got, want, "dq-return-home", where, findings, anchor,
                       only_cls="dq")
        if window and r_live is not None:
            jump = [r for r in got if r[0] == "pay" and r[2] > 1]
            want_jump = n_intra - (r_live - 1)
            if r_live > 1 and want_jump > 1 and (
                    len(jump) != 1 or jump[0][2] != want_jump):
                findings.append(Finding(
                    rule="window-truncation", file=anchor[0], line=anchor[1],
                    message=f"{where}: bwd dead-middle jump should be one "
                            f"{want_jump}-hop permute, recorded {jump}"))
    return findings


def _ring_inputs(entry: RingEntry, seed: int = 0):
    import torch

    g = torch.Generator().manual_seed(seed)
    seq = entry.world * entry.s_local
    q, k, v, do = (torch.randn((1, 2, seq, 16), generator=g)
                   for _ in range(4))
    seg = None
    if entry.max_segment_len is not None:
        # documents that keep the entry's promise (none spans more than
        # max_segment_len tokens)
        seg = (torch.arange(seq) // entry.max_segment_len)[None].int()
    return q, k, v, do, seg


def verify_ring_entry(entry: RingEntry) -> List[Finding]:
    """Run one topology config's forward and backward on the CPU under
    the recorder and check every ring rule on the two streams."""
    import torch

    from ..parallel import burst, mesh as mesh_mod

    findings: List[Finding] = []
    names = tuple(entry.axes)
    if len(names) == 2:
        n_inter, n_intra = entry.axes[names[0]], entry.axes[names[1]]
    else:
        n_inter, n_intra = 1, entry.axes[names[0]]
    seq = entry.world * entry.s_local

    # the truncated live set comes from the INDEPENDENT dense derivations
    # (live_rounds_contig / live_rounds_contig_seg), not from the
    # implementation's masks.live_round_prefix — agreement between the two
    # is exactly what window-truncation proves
    r_live = None
    truncating = (entry.window is not None
                  or entry.max_segment_len is not None)
    if truncating and n_inter == 1:
        if entry.window is not None:
            live = oracle.live_rounds_contig(seq, entry.world, entry.window)
        else:
            live = oracle.live_rounds_contig_seg(seq, entry.world,
                                                 entry.max_segment_len)
        if live != set(range(len(live))):
            path, line = _anchor(burst._fwd_impl)
            findings.append(Finding(
                rule="window-truncation", file=path, line=line,
                message=f"{entry.name}: live round set {sorted(live)} is "
                        "not a prefix — static truncation cannot express "
                        "it"))
            return findings
        r_live = len(live)

    q, k, v, do, seg = _ring_inputs(entry)
    q.requires_grad_(True)
    kw = dict(mesh=dict(entry.axes), seq_axes=names, causal=entry.causal,
              layout=entry.layout, backend="jnp", window=entry.window,
              segment_ids=seg, max_segment_len=entry.max_segment_len)
    with mesh_mod.record_collectives() as fwd_ev:
        o = burst.burst_attn(q, k, v, **kw)
    with mesh_mod.record_collectives() as bwd_ev:
        o.backward(do)
    if not bool(torch.isfinite(q.grad).all()):
        path, line = _anchor(burst._bwd_impl)
        findings.append(Finding(
            rule="dq-return-home", file=path, line=line,
            message=f"{entry.name}: the ring backward returned non-finite "
                    "dq"))
    findings += verify_stream(
        fwd_ev, kind="fwd", n_inter=n_inter, n_intra=n_intra,
        r_live=r_live, where=f"{entry.name} fwd",
        anchor=_anchor(burst._fwd_impl), window=truncating)
    findings += verify_stream(
        bwd_ev, kind="bwd", n_inter=n_inter, n_intra=n_intra,
        r_live=r_live, where=f"{entry.name} bwd",
        anchor=_anchor(burst._bwd_impl), window=truncating)
    return findings


def verify_ulysses() -> List[Finding]:
    """Ulysses all-to-all contract: exactly 4 all_to_alls (q, k, v in; o
    out) on the sequence axis, no ppermute."""
    import torch

    from ..parallel import mesh as mesh_mod, ulysses

    findings: List[Finding] = []
    anchor = _anchor(ulysses.ulysses_attn)
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 4, 64, 16), generator=g) for _ in range(3))
    with mesh_mod.record_collectives() as ev:
        ulysses.ulysses_attn(q, k, v, mesh={"sp": 4}, causal=True,
                             backend="jnp")
    a2a = [e for e in ev if e[0] == "a2a"]
    pperm = [e for e in ev if e[0] != "a2a"]
    if len(a2a) != 4 or any(e[1] != "sp" for e in a2a):
        findings.append(Finding(
            rule="ring-order", file=anchor[0], line=anchor[1],
            message=f"ulysses: expected exactly 4 all_to_alls on 'sp' "
                    f"(q,k,v scatter-heads + o gather), recorded {a2a}"))
    if pperm:
        findings.append(Finding(
            rule="ring-order", file=anchor[0], line=anchor[1],
            message=f"ulysses: unexpected ppermute(s) in an all-to-all "
                    f"program: {pperm}"))
    return findings


# ---------------------------------------------------------------------------
# fused-ring-schedule: the compiled programs, host only

# (topology, n_inter, n_intra, compile kwargs) matrix of compiler-emitted
# programs proven on every run — fwd AND bwd for each.  The occupancy-
# elided rows (r_live < world) must serve EXACTLY offsets {0..r_live-1}.
# A double ring's programs stay dense in the port (ops/fused_ring.py
# _compile_for), so its elided rows prove the compiler's truncation
# itself; the double BWD ignores r_live by design and is proven dense.
IR_PROOF_CONFIGS = (
    ("uni", 1, 2, {}),
    ("uni", 1, 4, {}),
    ("uni", 1, 8, {}),
    ("uni", 1, 8, {"slots": 3}),
    ("uni", 1, 8, {"slots": 8}),
    ("bidi", 1, 3, {}),
    ("bidi", 1, 4, {}),
    ("bidi", 1, 5, {}),
    ("bidi", 1, 8, {}),
    ("bidi", 1, 8, {"slots": 3, "slots1": 2}),
    ("double", 2, 2, {}),
    ("double", 2, 4, {}),
    ("double", 4, 2, {}),
    ("double", 2, 4, {"slots": 3, "slots1": 3}),
    ("double", 3, 3, {}),
    ("uni", 1, 8, {"r_live": 3}),
    ("uni", 1, 8, {"r_live": 2}),
    ("uni", 1, 4, {"r_live": 3}),
    ("bidi", 1, 8, {"r_live": 3}),
    ("bidi", 1, 5, {"r_live": 2}),
    ("bidi", 1, 8, {"r_live": 4, "slots": 3}),
    ("double", 2, 4, {"r_live": 3}),
    ("double", 4, 2, {"r_live": 5}),
)


def export(prog) -> dict:
    """Plain-dict form of a RingProgram for the oracle: everything the
    simulation proof needs, nothing it must trust the compiler for (the
    JAX RingProgram.export(); the port's programs carry no wire field:
    its wire payloads ride the dense program's table)."""
    return {
        "kind": prog.kind, "topology": prog.topology,
        "n_inter": prog.n_inter, "n_intra": prog.n_intra,
        "slots": prog.slots, "channels": prog.channels,
        "copy_in": prog.copy_in, "rot_inter": prog.rot_inter,
        "rot_intra": prog.rot_intra, "dq_slots": prog.dq_slots,
        "home_offsets": prog.home_offsets, "wire": None,
        "rows": {k: tuple(v) for k, v in prog.rows.items()},
    }


def verify_elided_program(prog_export: dict, r_live: int, *, where: str,
                          anchor=None) -> List[Finding]:
    """fused-ring-schedule, elision obligation: an occupancy-compiled
    program claiming live prefix {0..r_live-1} must serve EXACTLY those
    ring offsets — a compiler that fails to elide a dead round or elides
    a live one both fire."""
    if anchor is None:
        from ..parallel import schedule as sched

        anchor = _anchor(sched.compile_fwd)
    findings: List[Finding] = []
    try:
        oracle.verify_ring_program(prog_export,
                                   live_deltas=tuple(range(r_live)))
    except AssertionError as e:
        findings.append(Finding(
            rule="fused-ring-schedule", file=anchor[0], line=anchor[1],
            message=f"{where}: elision proof failed: {e}"))
    return findings


def _sends(prog) -> int:
    """Payload sends plus dq sends of one position, off the op table."""
    from . import costmodel

    c = costmodel.send_census(prog)
    return c["send0"] + c["send1"] + c["dq"]


def verify_ring_programs() -> List[Finding]:
    """fused-ring-schedule, IR family: every program the schedule compiler
    emits across the topology matrix is proven by direct simulation
    (oracle.verify_ring_program); r_live configs additionally prove the
    served-offset set equals the live prefix and that elision strictly
    shrinks the round count and never grows the send census."""
    from ..parallel import schedule as sched

    findings: List[Finding] = []
    anchor_ir = _anchor(sched.compile_fwd)

    def bad(msg):
        findings.append(Finding(rule="fused-ring-schedule",
                                file=anchor_ir[0], line=anchor_ir[1],
                                message=msg))

    for topology, n_inter, n_intra, kw in IR_PROOF_CONFIGS:
        r_live = kw.get("r_live")
        for kind, compiler in (("fwd", sched.compile_fwd),
                               ("bwd", sched.compile_bwd)):
            tag = (f"{kind} {topology} {n_inter}x{n_intra}"
                   f"{' ' + str(kw) if kw else ''}")
            try:
                prog = compiler(topology, n_intra, n_inter, **kw)
            except sched.ScheduleError as e:
                bad(f"{tag}: compiler refused a supported topology: {e}")
                continue
            elide = (r_live is not None
                     and not (kind == "bwd" and topology == "double"))
            if elide:
                findings += verify_elided_program(
                    export(prog), r_live, where=tag, anchor=anchor_ir)
                dense_kw = {k: w for k, w in kw.items() if k != "r_live"}
                dense = compiler(topology, n_intra, n_inter, **dense_kw)
                if prog.n_rounds >= dense.n_rounds:
                    bad(f"{tag}: elided program keeps {prog.n_rounds} "
                        f"rounds, dense has {dense.n_rounds} — nothing was "
                        "elided")
                if _sends(prog) > _sends(dense):
                    bad(f"{tag}: elided send census {_sends(prog)} exceeds "
                        f"the dense census {_sends(dense)}")
            else:
                try:
                    oracle.verify_ring_program(export(prog))
                except AssertionError as e:
                    bad(f"{tag}: simulation proof failed: {e}")
    return findings


def verify_scan_lowering() -> List[Finding]:
    """fused-ring-schedule, scan lowering: schedule.scan_events of every
    uni and double forward program (dense and elided) is the oracle's
    forward stream, and schedule.hop_totals its transition counts; the
    legacy uni slot view is the oracle's derivation and proves."""
    from ..parallel import ring, schedule as sched

    findings: List[Finding] = []
    anchor = _anchor(sched.scan_events)

    def bad(msg, at=anchor):
        findings.append(Finding(rule="fused-ring-schedule", file=at[0],
                                line=at[1], message=msg))

    for topology, n_inter, n_intra, kw in IR_PROOF_CONFIGS:
        if topology == "bidi":
            continue  # fused-only: no scan counterpart
        r_live = kw.get("r_live")
        prog = sched.compile_fwd(topology, n_intra, n_inter, **kw)
        want_rl = r_live if n_inter == 1 else None
        want = oracle.fwd_stream(n_inter, n_intra, want_rl)
        got = [tuple(e) for e in sched.scan_events(prog)]
        tag = f"fwd {topology} {n_inter}x{n_intra}{' ' + str(kw) if kw else ''}"
        if n_inter > 1 and r_live is not None:
            # the double ring's elided program keeps the first r_live
            # rounds of its cycle-major order: the oracle's dense stream
            # cut at those rounds
            want = _double_prefix(n_inter, n_intra, r_live)
        if oracle.encode_runs(got) != oracle.encode_runs(want):
            bad(f"{tag}: scan_events {oracle.encode_runs(got)} != the "
                f"oracle's {oracle.encode_runs(want)}")
        totals = sched.hop_totals(prog)
        want_tot = {"intra": 0, "inter": 0}
        for _, axis, hops in want:
            want_tot[axis] += hops
        if totals != want_tot:
            bad(f"{tag}: hop_totals {totals} != the oracle's {want_tot}")
    anchor_plan = _anchor(ring.fused_slot_schedule)
    for world, slots in ((2, 2), (4, 2), (8, 2), (8, 3), (8, 8)):
        got = [int(x) for x in ring.fused_slot_schedule(world, slots)]
        want = oracle.fused_slot_schedule(world, slots)
        if got != want:
            bad(f"world={world} slots={slots}: exported slot schedule "
                f"{got} != oracle derivation {want}", anchor_plan)
            continue
        try:
            oracle.verify_fused_ring(world, slots, got)
        except AssertionError as e:
            bad(f"world={world} slots={slots}: schedule proof failed: {e}",
                anchor_plan)
    return findings


def _double_prefix(n_inter: int, n_intra: int, r_live: int):
    """The oracle's dense double-ring forward stream cut to the sends of
    its first r_live rounds: the inter prefetch of cycle c is issued at
    the cycle's first round when cycle c + 1 starts before r_live, each
    intra hop after a consumed round whose successor is live."""
    ev = []
    for r in range(r_live):
        c, s = divmod(r, n_intra)
        if s == 0 and c < n_inter - 1 and (c + 1) * n_intra < r_live:
            ev.append(("pay", "inter", 1))
        if s < n_intra - 1 and r + 1 < r_live:
            ev.append(("pay", "intra", 1))
    return ev


def check_all() -> List[Finding]:
    findings: List[Finding] = []
    for entry in ENTRIES:
        findings += verify_ring_entry(entry)
    findings += verify_ulysses()
    findings += verify_ring_programs()
    findings += verify_scan_lowering()
    return findings


# ---------------------------------------------------------------------------
# fused-ring-fused: the card half

# (name, mesh axes, seq axes, layout, window, fused_topology) of the fused
# route's configs, at B1 N2 S_local 128 D128 bf16
CARD_CASES = (
    ("uni-4", {"sp": 4}, ("sp",), "zigzag", None, "auto"),
    ("bidi-4", {"sp": 4}, ("sp",), "zigzag", None, "bidi"),
    ("double-2x2", {"inter": 2, "intra": 2}, ("inter", "intra"), "zigzag",
     None, "auto"),
    ("windowed-uni-4", {"sp": 4}, ("sp",), "contig", 160, "auto"),
)
CARD_S_LOCAL = 128


def verify_fused_case(name, axes, seq_axes, layout, window,
                      topology) -> List[Finding]:
    """One fused-route config on the card: forward with collect_stats
    and backward, each under the recorder."""
    import numpy as np
    import torch

    from .. import obs
    from ..ops import fused_ring, fused_ring_bwd
    from ..parallel import burst, mesh as mesh_mod

    findings: List[Finding] = []
    anchor = _anchor(fused_ring.fused_ring_fwd)

    def bad(msg):
        findings.append(Finding(rule="fused-ring-fused", file=anchor[0],
                                line=anchor[1], message=f"{name}: {msg}"))

    dev = torch.device("cuda")
    world = 1
    for n in axes.values():
        world *= n
    n_inter, n_intra = (1, world) if len(seq_axes) == 1 else (
        axes[seq_axes[0]], axes[seq_axes[1]])
    s_local = CARD_S_LOCAL
    s = s_local * world
    g = torch.Generator(device=dev).manual_seed(41)
    q, k, v, do = (torch.randn((1, 2, s, 128), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    q.requires_grad_(True)
    before = obs.counter_values()
    f0 = fused_ring.fused_ring_fwd.launches
    b0 = fused_ring_bwd.fused_ring_bwd.launches
    with mesh_mod.record_collectives() as fwd_ev:
        o, st = burst.burst_attn(
            q, k, v, mesh=dict(axes), seq_axes=seq_axes, causal=True,
            layout=layout, backend="fused_ring", window=window,
            fused_topology=topology, collect_stats=True)
    f1 = fused_ring.fused_ring_fwd.launches
    with mesh_mod.record_collectives() as bwd_ev:
        o.backward(do)
    torch.cuda.synchronize()
    deltas = obs.counter_deltas(before)
    fallback = {k_: v_ for k_, v_ in deltas.items()
                if k_.startswith("burst.fused_fallback") and v_}
    if fwd_ev or bwd_ev:
        bad(f"the fused route issued rotations outside the kernels: "
            f"fwd {fwd_ev}, bwd {bwd_ev}")
    if fallback:
        bad(f"the fused gate declined: {fallback}")
    launches = (f1 - f0, fused_ring_bwd.fused_ring_bwd.launches - b0)
    if launches != (1, 1):
        bad(f"kernel launches (fwd, bwd) {launches}, the program is one "
            "launch a pass")
    cfg = burst.BurstConfig(
        causal=True, layout=layout, intra_axis=seq_axes[-1],
        inter_axis=seq_axes[0] if len(seq_axes) == 2 else None,
        backend="fused_ring", window=window, fused_topology=topology)
    prog = fused_ring.ring_plan(cfg, n_inter, n_intra, s_local, "fwd")[0]
    want = np.zeros((2, st.slot_use.shape[-1]), np.int64)
    for r in range(prog.n_rounds):
        want[prog.rows["consume_bank"][r], prog.rows["consume_slot"][r]] += 1
    if st.slot_use is None:
        bad("no slot counters: the forward did not run kernel 8's STATS "
            "instance")
        return findings
    got0 = st.slot_use.cpu().numpy()
    got1 = (st.slot_use_ccw.cpu().numpy() if st.slot_use_ccw is not None
            else np.zeros_like(got0))
    if not ((got0 == want[0][None]).all() and (got1 == want[1][None]).all()):
        bad(f"kernel 8's slot counters {got0[0].tolist()} / "
            f"{got1[0].tolist()} differ from the program's consumes "
            f"{want.tolist()} ({prog.n_rounds} rounds)")
    if not bool(torch.isfinite(q.grad).all()):
        bad("the fused backward returned non-finite dq")
    return findings


def check_card() -> List[Finding]:
    """fused-ring-fused on the card's fused route (the caller checked
    that a CUDA device is visible)."""
    findings: List[Finding] = []
    for case in CARD_CASES:
        findings += verify_fused_case(*case)
    return findings
