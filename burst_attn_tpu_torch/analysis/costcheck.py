"""cost-*: the static resource and roofline verifier (port of
burst_attn_tpu/analysis/costcheck.py).

Three rules back onto the port's burstcost (analysis/costmodel.py):

  kernel-smem-budget     (the JAX package's kernel-vmem-budget, renamed:
                         the card's budget is shared memory) every
                         {uni, bidi, double} x {dense, int8, fp8} x {fwd,
                         bwd} config fits: the dispatch gate's plan within
                         tuning.SMEM_BUDGET (227 KB), the pass's largest
                         kernel instance within the card's per-block limit
                         at the canonical shape AND at the largest shard
                         the gate admits, the ring's flag words under
                         their tripwire; every kernel instance's plan fits
                         the limit and admits the CTAs an SM its design
                         assumes; the ragged kernel's plans equal its
                         gate's (ops/ragged_paged._smem_plan).  The card
                         half (check_card) holds every instance's plan to
                         what cudaFuncGetAttributes reports for the
                         compiled kernel (ops/_build.kernel_attrs): equal
                         shared memory, and the resident CTAs the plan
                         assumes — "admitted => launches, with the memory
                         we said".
  cost-model-consistent  the roofline's inputs agree with the port's own
                         counters: closed-form pass pairs == the devstats
                         per-round pair algebra summed over the compiled
                         program (exactly, elided rounds included), and
                         the model's stream bytes == schedule.
                         wire_round_bytes (the burst.wire_bytes formula)
                         over pass x wire x opt_comm x itemsize.  Its
                         calibration band reads only the card's own kernel
                         times (measured_floor_findings, from
                         chip_smoke.py): no time may fall under 0.95 x the
                         model's floor.  No TPU number is read.
  tuning-table-sound     the resolve_fused defaults obey what dispatch
                         assumes: bwd tiles never larger than fwd, the
                         tiles the kernels are built with, slots >= 2,
                         wire dtypes legal, the budget within the card's
                         per-block limit, and the gate pricing the largest
                         instance of its pass.

Mutation coverage (tests/test_torch_analysis.py): a deflated budget, an
inflated slot plan, a window-blind pair function, a fwd < bwd inversion
and an impossible measured time each fire their rule.
"""

from typing import Iterable, List, Optional

from .core import Finding, rule
from . import costmodel as cm
from ..ops import tuning
from ..parallel import schedule as sched

rule("kernel-smem-budget", "cost",
     "every topology x wire-dtype x pass config and every kernel instance "
     "fits the card's shared memory with the CTAs its design assumes, at "
     "the canonical shape and the largest gate-admitted shard (card half: "
     "plan == the compiled kernel's attributes)")(None)
rule("cost-model-consistent", "cost",
     "roofline FLOPs == devstats pair algebra over compiled programs "
     "(incl. elided rounds); model stream bytes == wire_round_bytes (the "
     "burst.wire_bytes formula); measured card times >= 0.95 x floor")(None)
rule("tuning-table-sound", "cost",
     "resolve_fused defaults obey dispatch's invariants: bwd tiles <= fwd, "
     "the kernels' built tiles, slots >= 2, legal wire dtypes, budget "
     "within the card's limit, the gate pricing the largest instance")(None)

# the card rules this family cannot run without a CUDA device
CARD_RULES = {
    "kernel-smem-budget (card half)":
        "the plans against cudaFuncGetAttributes of the compiled kernels "
        "need the CUDA card; run `python -m burst_attn_tpu_torch.analysis "
        "--card` there",
}

# the small consistency ring: exact identities are shape-independent
_CONSIST_S, _CONSIST_WORLD = 512, 8
# a measured time under this fraction of the model's floor is impossible
CALIB_FAST = 0.95


def _anchor(which: str):
    """Anchor findings at the code whose numbers the model mirrors."""
    import inspect

    try:
        if which == "gate":
            from ..ops import fused_ring
            fn = fused_ring.supported
        elif which == "ragged":
            from ..ops import ragged_paged
            fn = ragged_paged.ragged_supported
        elif which == "wire":
            fn = sched.wire_round_bytes
        elif which == "pairs":
            from ..ops import masks
            fn = masks.spec_pair_count
        elif which == "attrs":
            from ..ops import _build
            fn = _build.kernel_attrs
        else:  # "table"
            fn = tuning.resolve_fused
        return inspect.getsourcefile(fn), inspect.getsourcelines(fn)[1]
    except (OSError, TypeError, ImportError):
        return "<trace>", 0


# ---------------------------------------------------------------------------
# kernel-smem-budget


def check_smem_budget(rf: Optional[tuning.ResolvedFused] = None,
                      world: int = cm.DEFAULT_WORLD,
                      shape: Optional[dict] = None) -> List[Finding]:
    """Prove the config matrix within budget.  `rf` replaces the resolved
    defaults (the mutation seam: a deflated budget or an inflated slot
    plan must fire); default resolves each wire dtype's defaults."""
    findings: List[Finding] = []
    shp = dict(cm.DEFAULT_SHAPE if shape is None else shape)
    b, n, n_kv, s, d = (shp[k] for k in ("b", "n", "n_kv", "s", "d"))
    gate_f, gate_ln = _anchor("gate")

    def bad(msg, at=(gate_f, gate_ln)):
        findings.append(Finding(rule="kernel-smem-budget", message=msg,
                                file=at[0], line=at[1]))

    for wire in cm.WIRE_DTYPES:
        rfw = (tuning.resolve_fused(wire_dtype=wire) if rf is None
               else rf._replace(wire_dtype=wire))
        for topo in sched.TOPOLOGIES:
            for pass_ in cm.PASSES:
                program = cm.compile_program(pass_, topo, world, rfw)
                pl = cm.plan(pass_, rfw, program, b=b, n=n, n_kv=n_kv, s=s,
                             d=d)
                ctx = f"h100/{topo}/{wire or 'dense'}/{pass_}"
                if pl.gate_bytes > rfw.smem_budget:
                    bad(f"{ctx}: gate plan {pl.gate_bytes} B exceeds the "
                        f"fused budget {rfw.smem_budget} B at the canonical "
                        f"shape (s={s}) — the dispatch gate would reject "
                        "its own defaults")
                if pl.smem_bytes > cm.SMEM_LIMIT:
                    bad(f"{ctx}: the pass's largest instance plans "
                        f"{pl.smem_bytes} B of shared memory, past the "
                        f"card's {cm.SMEM_LIMIT} B a block")
                s_max = cm.max_admitted_shard(pass_, rfw, d=d)
                if s_max:
                    pl_max = cm.plan(pass_, rfw, program, b=b, n=n,
                                     n_kv=n_kv, s=s_max, d=d)
                    if pl_max.smem_bytes > cm.SMEM_LIMIT:
                        bad(f"{ctx}: the gate ADMITS shard s={s_max} but "
                            f"the plan there is {pl_max.smem_bytes} B > "
                            f"{cm.SMEM_LIMIT} B — an admitted config that "
                            "cannot launch")
                if pl.flag_words > cm.FLAG_BUDGET:
                    bad(f"{ctx}: ring flag census {pl.flag_words} words a "
                        f"position exceeds the tripwire {cm.FLAG_BUDGET} — "
                        "an unintended per-slot array grew the schedule")
    if rf is not None:
        return findings
    for p in cm.kernel_smem_plans():
        if p.smem > cm.SMEM_LIMIT:
            bad(f"{p.lib} {p.instance}: plans {p.smem} B of shared memory, "
                f"past the card's {cm.SMEM_LIMIT} B a block")
        if p.ctas_by_smem < p.ctas_assumed:
            bad(f"{p.lib} {p.instance}: {p.smem} B admits {p.ctas_by_smem} "
                f"CTA(s) an SM, the design assumes {p.ctas_assumed}")
    from ..ops import ragged_paged
    import torch

    rag = _anchor("ragged")
    for q_dtype, tdt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        plans = [cm.ragged_plan_bytes(q_dtype=q_dtype, pool_dtype=pool)
                 for pool in (q_dtype, "int8", "fp8")]
        gate = ragged_paged._smem_plan(cm.TILE_D, tdt)
        if max(plans) != gate:
            bad(f"ragged {q_dtype}: the instances' plans {plans} peak at "
                f"{max(plans)} B but ragged_supported prices {gate} B", rag)
        if max(plans) > ragged_paged.SMEM_LIMIT:
            bad(f"ragged {q_dtype}: plan {max(plans)} B exceeds the "
                f"kernel's limit {ragged_paged.SMEM_LIMIT} B", rag)
    return findings


def check_attrs(attrs, n_sm: int, plans=None) -> List[Finding]:
    """The card half of kernel-smem-budget on `attrs` ({(lib, instance):
    kernel_attrs row}): every planned instance is reported, with exactly
    the planned shared memory, within the limit, and resident at the
    CTAs an SM its design assumes (never more than the shared memory
    admits)."""
    findings: List[Finding] = []
    at = _anchor("attrs")

    def bad(msg):
        findings.append(Finding(rule="kernel-smem-budget", message=msg,
                                file=at[0], line=at[1]))

    plans = cm.kernel_smem_plans() if plans is None else plans
    for p in plans:
        a = attrs.get((p.lib, p.instance))
        if a is None:
            bad(f"{p.lib} {p.instance}: planned but the card reports no "
                "such instance")
            continue
        if a["smem"] != p.smem:
            bad(f"{p.lib} {p.instance}: the compiled kernel takes "
                f"{a['smem']} B of shared memory, the plan says {p.smem} B")
        if a["smem"] > cm.SMEM_LIMIT:
            bad(f"{p.lib} {p.instance}: {a['smem']} B past the card's "
                f"{cm.SMEM_LIMIT} B a block")
        per_sm = a["ctas"] / n_sm
        if per_sm < p.ctas_assumed or per_sm > p.ctas_by_smem:
            bad(f"{p.lib} {p.instance}: {a['ctas']} CTAs resident on "
                f"{n_sm} SMs ({per_sm:g} an SM), the plan assumes "
                f"{p.ctas_assumed} and the shared memory admits at most "
                f"{p.ctas_by_smem}")
    planned = {(p.lib, p.instance) for p in plans}
    for key in sorted(set(attrs) - planned):
        bad(f"{key[0]} {key[1]}: the card reports an instance the cost "
            "model does not plan")
    return findings


def card_attrs():
    """{(lib, instance): kernel_attrs row} of every instance the wrappers
    report, from the card."""
    from ..ops import flash, fused_ring, fused_ring_bwd, ragged_paged

    rows = {"flash_fwd": flash.fwd_attrs() + flash.fwd_attrs(seg=True),
            "flash_bwd": [a for seg in (False, True) for win in (False, True)
                          for a in flash.bwd_attrs(seg=seg, win=win)],
            "fused_ring_fwd": [
                a for stats in (False, True) for seg in (False, True)
                for win in (False, True)
                for a in fused_ring.fwd_attrs(stats=stats, seg=seg, win=win)]
            + fused_ring.fwd_attrs(wire=True)
            + fused_ring.fwd_attrs(win=True, wire=True),
            "fused_ring_bwd": fused_ring_bwd.bwd_attrs()
            + fused_ring_bwd.bwd_attrs(stats=True)
            + fused_ring_bwd.bwd_attrs(seg=True)
            + fused_ring_bwd.bwd_attrs(win=True)
            + fused_ring_bwd.bwd_attrs(seg=True, win=True)
            + fused_ring_bwd.bwd_attrs(wire=True)
            + fused_ring_bwd.bwd_attrs(win=True, wire=True),
            "ragged_paged": ragged_paged.ragged_attrs()}
    return {(lib, a["instance"]): a for lib, lst in rows.items()
            for a in lst}


def check_card() -> List[Finding]:
    """kernel-smem-budget's card half on the visible card."""
    import torch

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return check_attrs(card_attrs(), n_sm)


# ---------------------------------------------------------------------------
# cost-model-consistent


def check_cost_consistency(pair_fn=None) -> List[Finding]:
    """Pin the roofline's inputs to the port's counters.  `pair_fn`
    substitutes the devstats per-round pair twin (the mutation seam — a
    window-blind variant must fire)."""
    findings: List[Finding] = []
    s, world = _CONSIST_S, _CONSIST_WORLD
    pairs_f, pairs_ln = _anchor("pairs")
    rf = tuning.resolve_fused()
    cases = [(layout, topo, True, None)
             for layout in ("zigzag", "striped", "contig")
             for topo in sched.TOPOLOGIES]
    cases += [("zigzag", "uni", False, None),       # non-causal
              ("contig", "uni", True, 3 * s // 2)]  # windowed -> elision
    for layout, topo, causal, window in cases:
        r_live = None
        if window is not None:
            from ..ops.masks import live_round_prefix
            rl = live_round_prefix(layout, s, world, causal=causal,
                                   window=window)
            r_live = rl if rl < world else None
        program = cm.compile_program("fwd", topo, world, rf, r_live=r_live)
        closed = cm.pass_pairs(layout, s, world, causal=causal,
                               window=window)
        summed = cm.devstats_pass_pairs(program, layout, s, causal=causal,
                                        window=window, pair_fn=pair_fn)
        if closed != summed:
            findings.append(Finding(
                rule="cost-model-consistent",
                message=(f"pair algebra split: closed form says {closed} "
                         f"attending pairs for {layout}/{topo} "
                         f"(causal={causal}, window={window}, s={s}, "
                         f"world={world}) but the devstats per-round sum "
                         f"over the compiled program says {summed} — the "
                         "roofline's FLOPs no longer match what the "
                         "devstats counters integrate"),
                file=pairs_f, line=pairs_ln))
    wire_f, wire_ln = _anchor("wire")
    for pass_ in cm.PASSES:
        for wire in cm.WIRE_DTYPES:
            for opt_comm in (True, False):
                for itemsize in (4, 2):
                    kw = dict(b=2, n=16, n_kv=4, s=s, d=128,
                              opt_comm=opt_comm, itemsize=itemsize)
                    ours = cm.stream_bytes(pass_, wire, **kw)
                    theirs = sched.wire_round_bytes(pass_, wire, **kw)
                    if ours != theirs:
                        findings.append(Finding(
                            rule="cost-model-consistent",
                            message=(f"stream-bytes split for {pass_}/"
                                     f"{wire or 'dense'}/opt_comm="
                                     f"{opt_comm}/itemsize={itemsize}: "
                                     f"model says {ours}, wire_round_bytes "
                                     f"(the burst.wire_bytes formula) says "
                                     f"{theirs}"),
                            file=wire_f, line=wire_ln))
    return findings


def measured_floor_findings(readings: Iterable) -> List[Finding]:
    """The calibration band on the card's own times: `readings` are
    (name, measured seconds, model floor seconds).  A measurement under
    CALIB_FAST x its floor is impossible: the floor (or the timing) is
    wrong.  Slowness has no bound here: a kernel far from its floor is a
    finding of PERF.md, not of the model."""
    findings: List[Finding] = []
    f, ln = _anchor("wire")
    for name, meas, floor in readings:
        if floor > 0 and meas < CALIB_FAST * floor:
            findings.append(Finding(
                rule="cost-model-consistent", file=f, line=ln,
                message=(f"{name}: measured {meas * 1e3:.4f} ms is "
                         f"{meas / floor:.3f}x the model's floor "
                         f"{floor * 1e3:.4f} ms (< {CALIB_FAST}) — an "
                         "impossible reading: recheck the floor's count "
                         "or the timing")))
    return findings


# ---------------------------------------------------------------------------
# tuning-table-sound


def check_tuning_sound(rf: Optional[tuning.ResolvedFused] = None
                       ) -> List[Finding]:
    """The invariants dispatch assumes of the resolved defaults.  `rf`
    replaces them (the mutation seam — a fwd < bwd inversion must fire)."""
    findings: List[Finding] = []
    tab_f, tab_ln = _anchor("table")

    def bad(msg):
        findings.append(Finding(rule="tuning-table-sound", message=msg,
                                file=tab_f, line=tab_ln))

    rows = ([(w, tuning.resolve_fused(wire_dtype=w))
             for w in cm.WIRE_DTYPES] if rf is None
            else [(rf.wire_dtype, rf)])
    for wire, r in rows:
        tag = wire or "dense"
        if r.block_q_bwd > r.block_q or r.block_kv_bwd > r.block_kv:
            bad(f"{tag}: bwd tiles ({r.block_q_bwd},{r.block_kv_bwd}) "
                f"exceed fwd ({r.block_q},{r.block_kv}) — the backward "
                "tiles a subset of the forward's shared memory")
        for field, built in (("block_q", tuning.FUSED_BLOCK_Q),
                             ("block_kv", tuning.FUSED_BLOCK_KV),
                             ("block_q_bwd", tuning.FUSED_BLOCK_Q_BWD),
                             ("block_kv_bwd", tuning.FUSED_BLOCK_KV_BWD)):
            if getattr(r, field) != built:
                bad(f"{tag}: {field}={getattr(r, field)} but the kernel is "
                    f"built with {built}-row tiles")
            if getattr(r, field) % 16:
                bad(f"{tag}: {field}={getattr(r, field)} is not a multiple "
                    "of the 16-row mma tile")
        for field in ("kv_slots", "ccw_slots", "bwd_slots", "bwd_ccw_slots"):
            if getattr(r, field) < 2:
                bad(f"{tag}: {field}={getattr(r, field)} < 2 — the ring "
                    "needs a landing slot while one is in flight")
        if r.wire_dtype not in cm.WIRE_DTYPES:
            bad(f"{tag}: wire_dtype={r.wire_dtype!r} not in "
                f"{cm.WIRE_DTYPES}")
        if r.smem_budget > cm.SMEM_LIMIT:
            bad(f"{tag}: smem_budget={r.smem_budget} exceeds the card's "
                f"{cm.SMEM_LIMIT} B a block — the gate would admit "
                "configs that cannot launch")
    if rf is None:
        for pass_, gate, lib in (
                ("fwd", cm.fwd_gate_bytes(rows[0][1], cm.TILE_D),
                 "fused_ring_fwd"),
                ("bwd", cm.bwd_gate_bytes(rows[0][1], cm.TILE_D),
                 "fused_ring_bwd")):
            biggest = max(p.smem for p in cm.kernel_smem_plans()
                          if p.lib == lib)
            if gate < biggest:
                bad(f"{pass_}: the gate prices {gate} B but an instance "
                    f"of {lib} takes {biggest} B — the gate must price the "
                    "largest instance it admits")
    return findings


def check_all() -> List[Finding]:
    findings = check_smem_budget()
    findings += check_cost_consistency()
    findings += check_tuning_sound()
    return findings
