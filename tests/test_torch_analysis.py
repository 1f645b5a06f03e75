"""The port's analyzer (burst_attn_tpu_torch.analysis) against the JAX
package's: the registry under the JAX names (one rename), a clean run on
the port with zero suppressions, every seeded mutation of the JAX suite
that belongs to a ported family firing under its rule's name, the
oracle's streams equal to JAX's and to what the port's ring records, and
the JSON / SARIF shapes of the JAX renderer.  CPU only: the card half
(fused-ring-fused, the plans against the compiled kernels) is in
tests/test_torch_cuda.py."""

import json
import os
import textwrap

import numpy as np
import pytest
import torch

from burst_attn_tpu.analysis import astlint as jax_astlint
from burst_attn_tpu.analysis import core as jax_core
from burst_attn_tpu.analysis import oracle as jax_oracle

from burst_attn_tpu_torch.analysis import (
    astlint, core, costcheck, modelcheck as mc, oracle, policycheck,
    poolcheck, protocheck, ringcheck,
)
from burst_attn_tpu_torch.analysis.core import RULES, register_all
from burst_attn_tpu_torch.parallel import burst, mesh as mesh_mod, schedule
from burst_attn_tpu_torch.protocols import journal as jp
from burst_attn_tpu_torch.protocols import kvtransfer as kvp
from burst_attn_tpu_torch.protocols import pool as pp

PKG = os.path.dirname(os.path.dirname(os.path.abspath(core.__file__)))
ANCHOR = ("seeded.py", 7)

# the JAX families the port does not carry yet (jaxpr-only: ROADMAP A6)
JAXPR_ONLY = {"fp32-accum", "lse-fp32", "devstats-pure", "ckpt-jit-safe",
              "pipe-fused-pure", "pipe-tick-identity", "ragged-serve-safe"}

register_all()


def _rules_of(findings):
    return {f.rule for f in findings}


def _jax_rules():
    from burst_attn_tpu.analysis import (astlint, costcheck,  # noqa: F401
                                         numerics, obscheck, policycheck,
                                         poolcheck, protocheck, ringcheck,
                                         servecheck)

    return set(jax_core.RULES)


# ---------------------------------------------------------------------------
# registry, clean run, CLI


def test_registry_is_the_jax_names_less_the_jaxpr_families():
    jax = _jax_rules()
    assert len(jax) == 30
    want = (jax - JAXPR_ONLY - {"kernel-vmem-budget"}) | {
        "kernel-smem-budget"}
    assert set(RULES) == want and len(RULES) == 23
    # two registries: importing the port touched nothing of JAX's
    assert "kernel-vmem-budget" in jax_core.RULES
    assert "kernel-smem-budget" not in jax_core.RULES


def test_cli_clean_on_the_port_and_card_rules_not_run(capsys):
    from burst_attn_tpu_torch.analysis.__main__ import main

    assert main(["--json"]) == 0
    d = json.loads(capsys.readouterr().out)
    assert d["n_findings"] == 0, d["findings"]
    assert d["rules_registered"] == sorted(RULES)
    # the card rules say they did not run; they are never counted clean
    assert "fused-ring-fused" in d["not_run"]
    assert "--card" in d["not_run"]["fused-ring-fused"]


def test_cli_list_rules_and_card_without_a_card(capsys):
    from burst_attn_tpu_torch.analysis.__main__ import main

    assert main(["--list-rules"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 23
    if not torch.cuda.is_available():
        assert main(["--card", "--ast-only"]) == 2
        assert "needs a CUDA device" in capsys.readouterr().err


def test_zero_suppressions_in_the_port():
    carried = []
    for p in astlint.default_paths(PKG):
        with open(p, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                for r in core.suppressed_rules(line):
                    if r in RULES:
                        carried.append((os.path.relpath(p, PKG), i, r))
    assert carried == []


# ---------------------------------------------------------------------------
# ring family: the recorded stream against the oracle, seeded mutations


def _record_fwd(hops_per_round, world=4):
    """A fwd-like ring program through mesh.ppermute: rotate a 2-tensor
    payload by the given hop sizes (the healthy 4-ring is [1, 1, 1])."""
    parts = [(torch.zeros(2), torch.zeros(2)) for _ in range(world)]
    with mesh_mod.record_collectives() as ev:
        for h in hops_per_round:
            parts = mesh_mod.ppermute(parts, "intra", 1, world, h)
    return ev


def _verify_fwd(ev, **kw):
    args = dict(kind="fwd", n_inter=1, n_intra=4, where="seeded fwd",
                anchor=ANCHOR)
    args.update(kw)
    return ringcheck.verify_stream(ev, **args)


def test_healthy_ring_is_quiet():
    assert _verify_fwd(_record_fwd([1, 1, 1])) == []


def test_reversed_ring_permutation_fires():
    findings = _verify_fwd(_record_fwd([-1, -1, -1]))
    assert {"ring-order", "ring-hops"} <= _rules_of(findings)
    assert findings[0].file == "seeded.py" and findings[0].line == 7


def test_extra_round_fires_hop_count():
    assert "ring-hops" in _rules_of(_verify_fwd(_record_fwd([1, 1, 1, 1])))


def test_swapped_pair_permutation_fires_rotation():
    with mesh_mod.record_collectives() as ev:
        mesh_mod.record_permutation("pay", "intra",
                                    [(0, 1), (1, 0), (2, 3), (3, 2)], 4)
    assert ev == [("pay", "intra", None)]
    assert "ring-rotation" in _rules_of(_verify_fwd(ev))


def _record_bwd(return_home):
    """A bwd-like program: the 4-tensor bundle and the dq ring one hop
    behind; `return_home=False` drops dq's final hop home."""
    pay = [tuple(torch.zeros(2) for _ in range(4)) for _ in range(4)]
    dq = [(torch.zeros(2),) for _ in range(4)]
    with mesh_mod.record_collectives() as ev:
        pay = mesh_mod.ppermute(pay, "intra", 1, 4, 1)      # the jump
        for _ in range(2):                                  # middle rounds
            pay = mesh_mod.ppermute(pay, "intra", 1, 4)
            dq = mesh_mod.ppermute(dq, "intra", 1, 4, cls="dq")
        dq = mesh_mod.ppermute(dq, "intra", 1, 4, cls="dq")  # last round
        if return_home:
            dq = mesh_mod.ppermute(dq, "intra", 1, 4, cls="dq")
    return ev


def _verify_bwd(ev, **kw):
    args = dict(kind="bwd", n_inter=1, n_intra=4, where="seeded bwd",
                anchor=ANCHOR)
    args.update(kw)
    return ringcheck.verify_stream(ev, **args)


def test_healthy_bwd_ring_is_quiet():
    assert _verify_bwd(_record_bwd(return_home=True)) == []


def test_dq_not_returning_home_fires():
    findings = _verify_bwd(_record_bwd(return_home=False))
    assert "dq-return-home" in _rules_of(findings)
    assert any(f.file == "seeded.py" and f.line == 7 for f in findings)


def test_untruncated_window_ring_fires():
    live = oracle.live_rounds_contig(64, 4, 20)
    assert live == {0, 1, 2}
    findings = _verify_fwd(_record_fwd([1, 1, 1]), r_live=len(live),
                           window=True)
    assert "window-truncation" in _rules_of(findings)
    assert _verify_fwd(_record_fwd([1, 1]), r_live=3, window=True) == []


def test_real_ring_without_truncation_fires(monkeypatch):
    """The real scan ring with its window truncation switched off rotates
    through the dead rounds: window-truncation fires on both passes."""
    entry = next(e for e in ringcheck.ENTRIES if e.name == "window4-contig")
    assert ringcheck.verify_ring_entry(entry) == []
    monkeypatch.setattr(burst, "_r_live",
                        lambda cfg, s, s_kv, n_inter, n_intra: n_intra)
    findings = ringcheck.verify_ring_entry(entry)
    assert "window-truncation" in _rules_of(findings)
    assert any("fwd" in f.message for f in findings
               if f.rule == "window-truncation")


def test_real_dq_ring_on_the_payload_class_fires(monkeypatch):
    """A dq hop issued as a payload rotation: the dq substream no longer
    matches the proven return-home stream."""
    real = mesh_mod.ppermute

    def mislabelled(parts, axis, n_inter, n_intra, hops=1, cls="pay"):
        return real(parts, axis, n_inter, n_intra, hops, "pay")

    monkeypatch.setattr(burst, "ppermute", mislabelled)
    findings = ringcheck.verify_ring_entry(ringcheck.ENTRIES[1])
    assert "dq-return-home" in _rules_of(findings)


@pytest.mark.parametrize("entry", ringcheck.ENTRIES, ids=lambda e: e.name)
def test_recorded_streams_equal_the_jax_oracle(entry):
    """What the port's scan ring issues is the JAX oracle's stream, fwd
    and bwd, over flat W 2/4/8, double 2x2/2x4/4x2, windows, segments."""
    names = tuple(entry.axes)
    n_inter, n_intra = ((1, entry.axes[names[0]]) if len(names) == 1 else
                        (entry.axes[names[0]], entry.axes[names[1]]))
    seq = entry.world * entry.s_local
    r_live = None
    if n_inter == 1 and entry.window is not None:
        r_live = len(jax_oracle.live_rounds_contig(seq, entry.world,
                                                   entry.window))
    elif n_inter == 1 and entry.max_segment_len is not None:
        r_live = len(jax_oracle.live_rounds_contig_seg(
            seq, entry.world, entry.max_segment_len))
    q, k, v, do, seg = ringcheck._ring_inputs(entry)
    q.requires_grad_(True)
    with mesh_mod.record_collectives() as fwd:
        o = burst.burst_attn(q, k, v, mesh=dict(entry.axes), seq_axes=names,
                             causal=entry.causal, layout=entry.layout,
                             backend="jnp", window=entry.window,
                             segment_ids=seg,
                             max_segment_len=entry.max_segment_len)
    with mesh_mod.record_collectives() as bwd:
        o.backward(do)
    assert jax_oracle.encode_runs(fwd) == jax_oracle.encode_runs(
        jax_oracle.fwd_stream(n_inter, n_intra, r_live))
    assert jax_oracle.encode_runs(bwd) == jax_oracle.encode_runs(
        jax_oracle.bwd_stream(n_inter, n_intra, r_live))


def test_ulysses_issues_four_all_to_alls():
    assert ringcheck.verify_ulysses() == []


def test_oracle_equals_jax_over_the_topology_matrix():
    for n_inter, n_intra in ((1, 2), (1, 4), (1, 8), (2, 2), (2, 4),
                             (4, 2), (3, 3)):
        lives = [None] + ([2, 3] if n_inter == 1 and n_intra > 3 else [])
        for r_live in lives:
            args = (n_inter, n_intra, r_live)
            assert oracle.fwd_stream(*args) == jax_oracle.fwd_stream(*args)
            assert oracle.bwd_stream(*args) == jax_oracle.bwd_stream(*args)
            assert (oracle.expected_hop_totals(*args)
                    == jax_oracle.expected_hop_totals(*args))
            oracle.verify_dq_returns_home(*args)
        assert np.array_equal(oracle.ring_schedule(n_intra, n_inter),
                              jax_oracle.ring_schedule(n_intra, n_inter))
    for seq, world, w in ((64, 4, 20), (128, 8, 20), (256, 8, 100)):
        assert (oracle.live_rounds_contig(seq, world, w)
                == jax_oracle.live_rounds_contig(seq, world, w))
        assert (oracle.live_rounds_contig_seg(seq, world, 16)
                == jax_oracle.live_rounds_contig_seg(seq, world, 16))
    for world, slots in ((2, 2), (4, 2), (8, 3)):
        assert (oracle.fused_slot_schedule(world, slots)
                == jax_oracle.fused_slot_schedule(world, slots))


# ---------------------------------------------------------------------------
# fused-ring-schedule: the compiled programs, and mutations of them


def test_ring_program_matrix_proves_clean():
    assert ringcheck.verify_ring_programs() == []
    assert ringcheck.verify_scan_lowering() == []


def test_ring_program_flipped_direction_fires():
    prog = ringcheck.export(schedule.compile_fwd("uni", 8))
    prog["channels"] = ("ccw",)
    with pytest.raises(AssertionError, match="rotation says"):
        oracle.verify_ring_program(prog)
    prog = ringcheck.export(schedule.compile_fwd("bidi", 8))
    prog["channels"] = ("cw", "cw")
    with pytest.raises(AssertionError, match="rotation says"):
        oracle.verify_ring_program(prog)


def test_ring_program_shortened_prefetch_fires():
    prog = ringcheck.export(schedule.compile_bwd("double", 4, 2))
    rows = {k: list(v) for k, v in prog["rows"].items()}
    assert rows["send1"][0] == 1
    late = prog["n_intra"] - 1
    for col in ("send1", "src_slot1", "dst_slot1"):
        rows[col][late] = rows[col][0]
        rows[col][0] = 0
    prog["rows"] = {k: tuple(v) for k, v in rows.items()}
    with pytest.raises(AssertionError, match="prefetch distance"):
        oracle.verify_ring_program(prog)


def test_ring_program_aliased_slot_fires():
    prog = ringcheck.export(schedule.compile_fwd("uni", 8, slots=3))
    rows = {k: list(v) for k, v in prog["rows"].items()}
    rows["dst_slot0"][1] = rows["consume_slot"][1]
    prog["rows"] = {k: tuple(v) for k, v in rows.items()}
    with pytest.raises(AssertionError):
        oracle.verify_ring_program(prog)


def test_ring_program_dropped_home_hop_fires():
    prog = ringcheck.export(schedule.compile_bwd("uni", 8))
    rows = {k: list(v) for k, v in prog["rows"].items()}
    last = max(r for r in range(len(rows["dq_send"]))
               if rows["dq_send"][r] == schedule.DQ_HOME)
    rows["dq_send"][last] = schedule.DQ_NONE
    prog["rows"] = {k: tuple(v) for k, v in rows.items()}
    with pytest.raises(AssertionError, match="home"):
        oracle.verify_ring_program(prog)


def test_elision_mutation_fires_fused_ring_schedule():
    world, r_live = 8, 3
    good = schedule.compile_fwd("uni", world, r_live=r_live)
    assert ringcheck.verify_elided_program(ringcheck.export(good), r_live,
                                           where="m") == []
    dense = schedule.compile_fwd("uni", world)
    f1 = ringcheck.verify_elided_program(ringcheck.export(dense), r_live,
                                         where="m")
    assert any(f.rule == "fused-ring-schedule" and "DEAD" in f.message
               for f in f1)
    over = schedule.compile_fwd("uni", world, r_live=r_live - 1)
    f2 = ringcheck.verify_elided_program(ringcheck.export(over), r_live,
                                         where="m")
    assert any("LIVE" in f.message for f in f2)


def test_slot_schedule_mutation_fires(monkeypatch):
    from burst_attn_tpu_torch.parallel import ring

    monkeypatch.setattr(ring, "fused_slot_schedule",
                        lambda world, slots: np.zeros(world, np.int64))
    findings = ringcheck.verify_scan_lowering()
    assert "fused-ring-schedule" in _rules_of(findings)


def test_scan_lowering_mutation_fires(monkeypatch):
    """A scan lowering that drops the double ring's inter prefetch."""
    real = schedule.scan_events
    monkeypatch.setattr(
        schedule, "scan_events",
        lambda prog: [e for e in real(prog) if e[1] != "inter"])
    findings = ringcheck.verify_scan_lowering()
    assert any(f.rule == "fused-ring-schedule" and "double" in f.message
               for f in findings)


# ---------------------------------------------------------------------------
# AST family


def _lint(tmp_path, source, name="fixture.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    return astlint.lint_file(str(p))


def test_bare_except_pass_fires(tmp_path):
    findings = _lint(tmp_path, """\
        def f():
            try:
                g()
            except Exception:
                pass
    """)
    assert [(f.rule, f.line) for f in findings] == [("silent-except", 4)]


def test_narrow_except_pass_is_flow_control(tmp_path):
    assert _lint(tmp_path, """\
        def f(it):
            try:
                next(it)
            except StopIteration:
                pass
    """) == []


def test_mesh_shape_index_fires_and_get_is_quiet(tmp_path):
    findings = _lint(tmp_path, """\
        def f(mesh, axes):
            return [mesh.shape[a] for a in axes]
    """)
    assert [(f.rule, f.line) for f in findings] == [("mesh-shape-index", 2)]
    assert _lint(tmp_path, """\
        def f(mesh, axes):
            return [mesh.shape.get(a, 1) for a in axes]
    """, "quiet.py") == []


def test_host_sync_time_and_branch_in_a_capture_fire(tmp_path):
    findings = _lint(tmp_path, """\
        import time
        import torch

        def body(x):
            a = x.item()
            b = float(torch.sum(x))
            c = x.cpu()
            t = time.time()
            if x.sum() > 0:
                return a
            return b

        def capture(g, x):
            with torch.cuda.graph(g):
                body(x)
    """)
    got = sorted((f.rule, f.line) for f in findings)
    assert got == [("host-transfer-in-jit", 5), ("host-transfer-in-jit", 6),
                   ("host-transfer-in-jit", 7), ("time-in-jit", 8),
                   ("traced-bool-branch", 9)], got


def test_host_code_outside_a_capture_is_quiet(tmp_path):
    assert _lint(tmp_path, """\
        import time
        import torch

        def host_loop(x, device):
            t = time.time()
            v = float(torch.sum(x))
            if x.sum() > 0 and torch.device(device).type == "cpu":
                return v
            return t
    """) == []


def test_capture_closure_follows_imports_across_modules(tmp_path):
    """The capture in one module reaches a function of another through a
    relative import, and the sync there fires in its own file."""
    pkg = tmp_path / "burst_attn_tpu_torch" / "serving"
    pkg.mkdir(parents=True)
    (tmp_path / "burst_attn_tpu_torch" / "__init__.py").write_text("")
    (pkg / "__init__.py").write_text("")
    (pkg / "step.py").write_text(textwrap.dedent("""\
        def tick(x):
            return int(x.max())
    """))
    (pkg / "graphs.py").write_text(textwrap.dedent("""\
        import torch

        from .step import tick

        def capture(g, x):
            with torch.cuda.graph(g):
                tick(x)
    """))
    findings = astlint.lint_paths(astlint.default_paths(str(tmp_path)))
    assert [(os.path.basename(f.file), f.rule, f.line) for f in findings] \
        == [("step.py", "host-transfer-in-jit", 2)]


def test_obs_call_in_a_capture_fires_devstats_exempt(tmp_path):
    findings = _lint(tmp_path, """\
        import torch
        from burst_attn_tpu_torch import obs
        from burst_attn_tpu_torch.obs import devstats

        _C = obs.counter("c")

        def body(x):
            obs.counter("steps").inc()
            _C.inc()
            devstats.ring_stats_all(rounds=[1])
            return x

        def capture(g, x):
            with torch.cuda.graph(g):
                body(x)
    """)
    assert sorted((f.rule, f.line) for f in findings) == [
        ("obs-jit-safe", 8), ("obs-jit-safe", 9)]


def test_suppression_comment_silences(tmp_path):
    assert _lint(tmp_path, """\
        def f(mesh, a):
            return mesh.shape[a]  # burstlint: disable=mesh-shape-index
    """) == []


def test_transformer_mesh_sizes_stay_quiet():
    """models/transformer.py's host int() of a mesh size: the JAX rule
    fires there (it calls the function traced by the name `checkpoint`),
    the port's rule, retargeted at the CUDA graph capture, does not."""
    path = os.path.join(PKG, "models", "transformer.py")
    with open(path, encoding="utf-8") as f:
        src = f.read().split("\n")
    jax_hits = sorted(f.line for f in jax_astlint.lint_file(path)
                      if f.rule == "host-transfer-in-jit")
    assert len(jax_hits) == 2
    assert all("int(" in src[i - 1] and ".get(a" in src[i - 1]
               for i in jax_hits), [src[i - 1] for i in jax_hits]
    port = astlint.lint_paths(astlint.default_paths(PKG))
    assert not [f for f in port if f.file.endswith("transformer.py")]


def test_the_capture_context_is_the_decode_graph():
    """The real package's captured closure: the graph body, the decode
    tick and what it calls (serving/model.py -> models/paged_decode.py ->
    ops/ragged_paged.py)."""
    paths = astlint.default_paths(PKG)
    import ast

    mods = [astlint._Module(p, ast.parse(open(p, encoding="utf-8").read()),
                            astlint._module_name(p)) for p in paths]
    cap = astlint._captured(astlint._Index(mods))
    names = {os.path.relpath(p, PKG): {getattr(n, "name", None)
                                       for n in nodes}
             for p, nodes in cap.items()}
    assert {"_decode_ticks", "pipelined_tick"} <= names[
        os.path.join("serving", "model.py")]
    assert "ragged_model_step" in names[
        os.path.join("models", "paged_decode.py")]
    assert "ragged_paged_attention" in names[
        os.path.join("ops", "ragged_paged.py")]


# ---------------------------------------------------------------------------
# policy-pure


def _policy_src():
    from burst_attn_tpu_torch.fleet import policy

    with open(os.path.abspath(policy.__file__), encoding="utf-8") as f:
        return f.read()


def test_policy_pure_clean_on_the_port():
    assert policycheck.check_all() == []
    assert "burstlint:" not in _policy_src()


@pytest.mark.parametrize("mutation,needle", [
    ("clock", "time"), ("counter", "global"), ("state", "POLICIES"),
    ("rng", "random")])
def test_policy_pure_smuggles_fire(mutation, needle):
    src = _policy_src()
    anchor = "best = None\n    best_score = None"
    assert anchor in src
    if mutation == "clock":
        src = src.replace(anchor, "best = None\n    import time\n"
                          "    _now = time.time()\n    best_score = None", 1)
    elif mutation == "counter":
        src += ("\n_CALLS = 0\n\n\ndef counting_route(state, req=None):\n"
                "    global _CALLS\n    _CALLS += 1\n"
                "    return route_least_loaded(state, req)\n")
    elif mutation == "state":
        src += "\n\ndef sneaky(state):\n    POLICIES.update({})\n"
    else:
        src = src.replace(anchor, "best = None\n    _r = random.random()\n"
                          "    best_score = None", 1)
    findings = policycheck.check_policy_source(src)
    assert findings and all(f.rule == "policy-pure" for f in findings)
    assert any(needle in f.message for f in findings), findings


@pytest.mark.parametrize("stmt", [
    "import socket\n", "from burst_attn_tpu_torch.fleet import transport\n",
    "import torch\n"])
def test_policy_pure_transport_import_fires(stmt):
    findings = policycheck.check_policy_source(stmt + _policy_src())
    assert any("import" in f.message for f in findings), stmt


# ---------------------------------------------------------------------------
# proto-* on the port's machines


def test_protocheck_anchors_are_the_ports_executors():
    for model, tail in (("transfer", "kvplane.py"),
                        ("journal", "checkpoint.py"),
                        ("pool", "paged_decode.py")):
        path, line = protocheck._anchor(model)
        assert path.endswith(tail) and line > 0
        assert f"{os.sep}burst_attn_tpu_torch{os.sep}" in path


def test_proto_journal_dropped_fsync_fires(monkeypatch):
    real = jp.step

    def dropped_fsync(st, ev):
        if ev[0] == "sync":
            return st, ()
        return real(st, ev)

    monkeypatch.setattr(jp, "step", dropped_fsync)
    findings = protocheck.check_all()
    assert _rules_of(findings) == {"proto-journal-durable"}
    msg = findings[0].message
    assert "DurabilityViolation" in msg and "engine step boundary" in msg


def test_proto_journal_pipelined_lagged_delivery_fires():
    base = mc.journal_model()

    def transitions(s):
        out = []
        for label, nxt in base.transitions(s):
            if label.startswith("pipelined step boundary"):
                def lagged(s=s):
                    j1, _ = jp.step(s.j, ("append", "tokens", mc._RID, 1))
                    j2, _ = jp.step(j1, ("deliver", mc._RID, s.gen + 1))
                    j3, _ = jp.step(j2, ("sync",))
                    return mc.JournalModelState(j3, s.gen + 1, 0)
                out.append(mc.guarded(label, lagged))
            else:
                out.append((label, nxt))
        return tuple(out)

    r = mc.check(base._replace(transitions=transitions), max_depth=24,
                 max_states=50_000)
    assert not r.ok and "DurabilityViolation" in r.violation.message
    assert r.violation.trace == (
        "pipelined launch (defer readback)",
        "pipelined step boundary (readback + sync + deliver)")


def test_proto_transfer_skipped_preconditions_fires(monkeypatch):
    def no_checks(st, rid, slot):
        ent = kvp.staged_entry(st, rid)
        return ent[1] if ent is not None else 2

    monkeypatch.setattr(kvp, "commit_preconditions", no_checks)
    findings = protocheck.check_all()
    assert _rules_of(findings) == {"proto-transfer-atomic"}
    assert findings[0].file.endswith("kvplane.py")


def test_proto_transfer_eager_staging_leak_fires(monkeypatch):
    real = kvp.recv_step

    def eager(st, ev):
        if ev[0] == "page":
            npool, _ = pp.step(st.pool, ("acquire", 1))
            st = st._replace(pool=npool)
        return real(st, ev)

    monkeypatch.setattr(kvp, "recv_step", eager)
    findings = protocheck.check_all()
    assert _rules_of(findings) == {"proto-transfer-atomic"}
    assert "leak" in findings[0].message


def test_proto_pool_noop_cow_fires(monkeypatch):
    real = pp.step

    def no_cow(st, ev):
        if ev[0] == "cow":
            return st, (("cow", ev[1], ev[1]),)
        return real(st, ev)

    monkeypatch.setattr(pp, "step", no_cow)
    findings = protocheck.check_all()
    assert _rules_of(findings) == {"proto-pool-conserved"}
    assert "CowViolation" in findings[0].message


def test_proto_credit_window_deadlock_fires(monkeypatch):
    monkeypatch.setattr(kvp, "PAGE_CREDIT_WINDOW", 1)
    findings = protocheck.check_all()
    assert _rules_of(findings) == {"proto-no-deadlock"}
    assert "deadlock" in findings[0].message


def test_proto_transfer_scale_pair_split_fires(monkeypatch):
    monkeypatch.setattr(kvp, "SCALE_PAIRED", False)
    findings = protocheck.check_all()
    assert _rules_of(findings) == {"proto-transfer-atomic"}
    assert "staging split" in findings[0].message


# ---------------------------------------------------------------------------
# pagepool-cow-safe / pool-quant-safe on the port's engine


def test_poolcheck_skipped_cow_fires(monkeypatch):
    from burst_attn_tpu_torch.serving import engine as eng_mod

    monkeypatch.setattr(eng_mod, "cow_pages",
                        lambda state, *a, **k: (state, []))
    findings = poolcheck._check_cow()
    assert _rules_of(findings) == {"pagepool-cow-safe"}
    assert any("shared page" in f.message for f in findings)


def test_poolcheck_refcount_leak_fires(monkeypatch):
    from burst_attn_tpu_torch.models import paged_decode as pd

    def leaky(self, ids):
        for i in [int(j) for j in ids]:
            if 0 < i < self.n_pages and self._refs[i] > 0:
                self._refs[i] -= 1  # decremented but never freed

    monkeypatch.setattr(pd.PagePool, "release", leaky)
    findings = poolcheck._check_cow()
    assert _rules_of(findings) == {"pagepool-cow-safe"}


def test_pool_quant_cow_scale_split_fires(monkeypatch):
    from burst_attn_tpu_torch.ops.paged_attention import pool_bytes
    from burst_attn_tpu_torch.serving import model as serve_model

    def split_copy(state, src, dst):
        for bank in list(state.k_pages) + list(state.v_pages):
            b = pool_bytes(bank)
            b[list(dst)] = b[list(src)]
        return state

    monkeypatch.setattr(serve_model, "_copy_pages", split_copy)
    findings = poolcheck._check_quant()
    assert _rules_of(findings) == {"pool-quant-safe"}
    assert any("not carried" in f.message for f in findings)


def test_pool_quant_scatter_scale_split_fires(monkeypatch):
    from burst_attn_tpu_torch.serving import engine as eng_mod
    from burst_attn_tpu_torch.serving import model as serve_model

    real = serve_model.ragged_model_step

    def split_step(params, toks, q_lens, state, cfg, **kw):
        out = real(params, toks, q_lens, state, cfg, **kw)
        for s in list(state.k_scales) + list(state.v_scales):
            s.fill_(1.0)
        return out

    monkeypatch.setattr(eng_mod, "ragged_model_step", split_step)
    monkeypatch.setattr(serve_model, "ragged_model_step", split_step)
    findings = poolcheck._check_quant()
    assert _rules_of(findings) == {"pool-quant-safe"}
    assert any("without its scale" in f.message for f in findings)


# ---------------------------------------------------------------------------
# cost family


def test_kernel_smem_budget_fires_on_deflated_budget():
    from burst_attn_tpu_torch.ops import tuning

    rf = tuning.resolve_fused()._replace(smem_budget=64 * 1024)
    findings = costcheck.check_smem_budget(rf=rf)
    assert findings and _rules_of(findings) == {"kernel-smem-budget"}
    assert any("exceeds the fused budget" in f.message for f in findings)


def test_kernel_smem_budget_fires_on_inflated_slot_plan():
    from burst_attn_tpu_torch.ops import tuning

    rf = tuning.resolve_fused(kv_slots=64, bwd_slots=64)
    findings = costcheck.check_smem_budget(rf=rf, world=64)
    assert any(f.rule == "kernel-smem-budget" and "flag census" in f.message
               for f in findings)


def test_cost_model_consistent_fires_on_dropped_elision_term():
    from burst_attn_tpu_torch.ops.masks import _host_round_pairs

    def window_blind(layout, q_part, kv_part, s, causal, window):
        return _host_round_pairs(layout, q_part, kv_part, s, causal, None)

    findings = costcheck.check_cost_consistency(pair_fn=window_blind)
    assert any(f.rule == "cost-model-consistent"
               and "pair algebra split" in f.message for f in findings)


def test_cost_model_consistent_fires_on_an_impossible_time():
    assert costcheck.measured_floor_findings([("k8", 0.036, 0.0355)]) == []
    findings = costcheck.measured_floor_findings([("k8", 0.030, 0.0355)])
    assert _rules_of(findings) == {"cost-model-consistent"}


def test_tuning_table_sound_fires_on_fwd_bwd_inversion():
    from burst_attn_tpu_torch.ops import tuning

    rf = tuning.resolve_fused()._replace(block_q_bwd=128)
    findings = costcheck.check_tuning_sound(rf=rf)
    assert any(f.rule == "tuning-table-sound" and "bwd tiles" in f.message
               for f in findings)


# ---------------------------------------------------------------------------
# output formats: the JAX renderer's shapes


def test_json_render_round_trips_with_the_jax_schema():
    args = dict(rule="time-in-jit", message="m", file="f.py", line=3)
    ours = json.loads(core.render([core.Finding(**args)], as_json=True))
    theirs = json.loads(jax_core.render([jax_core.Finding(**args)],
                                        as_json=True))
    assert set(theirs) | {"not_run"} == set(ours)
    assert ours["findings"] == theirs["findings"] == [args]
    assert ours["n_findings"] == theirs["n_findings"] == 1
    assert ours["rules_registered"] == sorted(RULES)
    assert ours["not_run"] == {}


def test_sarif_round_trips_with_the_jax_schema():
    rows = [dict(rule="silent-except", message="swallowed",
                 file="burst_attn_tpu_torch/x.py", line=12),
            dict(rule="proto-no-deadlock", message="wedged")]
    ours = json.loads(core.render_sarif([core.Finding(**r) for r in rows]))
    theirs = json.loads(jax_core.render_sarif(
        [jax_core.Finding(**r) for r in rows]))
    assert ours["runs"][0]["results"] == theirs["runs"][0]["results"]
    assert set(ours) == set(theirs)
    assert ours["version"] == "2.1.0"
    driver = ours["runs"][0]["tool"]["driver"]
    assert set(driver) == set(theirs["runs"][0]["tool"]["driver"])
    assert [r["id"] for r in driver["rules"]] == sorted(RULES)
    for r in driver["rules"]:
        assert r["shortDescription"]["text"] == RULES[r["id"]].doc


def test_cli_sarif_flag_writes_file(tmp_path):
    from burst_attn_tpu_torch.analysis.__main__ import main

    out = tmp_path / "nested" / "burstlint.sarif"
    assert main(["--ast-only", "--sarif", str(out)]) == 0
    d = json.loads(out.read_text())
    assert d["version"] == "2.1.0" and d["runs"][0]["results"] == []


# ---------------------------------------------------------------------------
# --changed-only


def _spy_families(monkeypatch):
    ran = []
    for name, mod in (("ringcheck", ringcheck), ("poolcheck", poolcheck),
                      ("protocheck", protocheck), ("costcheck", costcheck),
                      ("policycheck", policycheck)):
        monkeypatch.setattr(mod, "check_all",
                            lambda name=name: (ran.append(name), [])[1])
    return ran


def test_changed_only_runs_touched_families_only(monkeypatch):
    ran = _spy_families(monkeypatch)
    monkeypatch.setattr(
        core, "changed_files",
        lambda root: ["/r/burst_attn_tpu_torch/protocols/pool.py"])
    assert core.run_analysis(changed_only=True) == []
    assert ran == ["protocheck"]


def test_changed_only_falls_back_to_full_run_without_git(monkeypatch):
    ran = _spy_families(monkeypatch)
    monkeypatch.setattr(core, "changed_files", lambda root: None)
    core.run_analysis(changed_only=True, ast_only=False)
    assert sorted(ran) == ["costcheck", "policycheck", "poolcheck",
                           "protocheck", "ringcheck"]
