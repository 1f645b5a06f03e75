"""The port's fleet simulator (burst_attn_tpu_torch.fleet.sim) against the
JAX package's: the same seed's trace, policy spec and SimRates give
bit-identical event-log digests and equal report records (wall time
excepted) over every policy, contention, preemption, shedding and
autoscale; the fidelity and promotion gates; the h100 rates from the
port's cost table; the CLI.  The slow cases are the JAX suite's slow
cases: the real process-backed fleet replay and the 1000-replica run."""

import json
import math
import types

import pytest

from burst_attn_tpu.fleet import policy as jpolicy
from burst_attn_tpu.fleet import sim as jsim
from burst_attn_tpu.loadgen import trace as jtrace

from burst_attn_tpu_torch.fleet import policy as fleet_policy
from burst_attn_tpu_torch.fleet import sim
from burst_attn_tpu_torch.fleet.policy import PolicySpec, ScaleParams
from burst_attn_tpu_torch.loadgen import trace as ptrace

RATES = dict(prefill_tokens_per_s=50_000.0, decode_steps_per_s=20.0,
             ship_bytes_per_s=1e9, kv_bytes_per_token=1024.0, boot_s=2.0)
TOY_RATES = sim.SimRates(**RATES)


def _toy(mod, n, *, dt=0.01, prompt_len=64, max_new=8, priority_every=0):
    reqs = []
    for i in range(n):
        prio = 1 if priority_every and i % priority_every == 0 else 0
        reqs.append(mod.TraceRequest(rid=i, t_arrival=round(dt * i, 6),
                                     prompt_len=prompt_len,
                                     prompt_seed=100 + i,
                                     max_new_tokens=max_new, priority=prio))
    return mod.Trace(meta={"vocab": 97}, requests=reqs)


def _record(rep):
    d = rep.to_record()
    d.pop("wall_s")
    return d


def _pair(kind, n, tkw):
    """The same trace from both packages' synthesizers (checked equal)."""
    fn = {"diurnal": "synthesize_diurnal_trace",
          "heavy_tail": "synthesize_heavy_tail_trace"}[kind]
    ours = getattr(ptrace, fn)(n, **tkw)
    theirs = getattr(jtrace, fn)(n, **tkw)
    assert ([tuple(r.__dict__.items()) for r in ours.requests]
            == [tuple(r.__dict__.items()) for r in theirs.requests])
    return ours, theirs


# (trace kind, requests, synthesizer kwargs, simulate kwargs)
CASES = [
    ("heavy_tail", 600, dict(seed=5, vocab=97, mean_interarrival_s=0.002,
                             priority_tenants=4),
     dict(n_replicas=3, slots=4, n_prefill=2)),
    ("heavy_tail", 800, dict(seed=3, vocab=97, mean_interarrival_s=0.001,
                             priority_tenants=4),
     dict(n_replicas=2, slots=4, n_prefill=1)),
    ("diurnal", 1500, dict(seed=7, vocab=97, period_s=60.0, mean_rate=40.0,
                           priority_fraction=0.1),
     dict(n_replicas=4, slots=8)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("policy", sorted(fleet_policy.POLICIES))
def test_same_inputs_same_event_log_as_jax(case, policy):
    kind, n, tkw, skw = CASES[case]
    ours_tr, theirs_tr = _pair(kind, n, tkw)
    ours = sim.simulate(ours_tr, fleet_policy.POLICIES[policy],
                        rates=TOY_RATES, seed=case, **skw)
    theirs = jsim.simulate(theirs_tr, jpolicy.POLICIES[policy],
                           rates=jsim.SimRates(**RATES), seed=case, **skw)
    assert ours.event_log_sha256 == theirs.event_log_sha256
    assert _record(ours) == _record(theirs)
    assert ours.n_done + ours.n_shed == n


@pytest.mark.parametrize("variant", ["shed", "autoscale", "preempt"])
def test_contention_paths_equal_jax(variant):
    tr, jtr = (_toy(m, 300, dt=0.001, max_new=20, priority_every=3)
               for m in (ptrace, jtrace))
    kw = dict(n_replicas=1, slots=2, n_prefill=1)
    if variant == "shed":
        specs = (PolicySpec("shed", max_pending=4),
                 jpolicy.PolicySpec("shed", max_pending=4))
    else:
        name = "priority_preempt" if variant == "preempt" else "least_loaded"
        specs = (fleet_policy.POLICIES[name], jpolicy.POLICIES[name])
    extra = {}
    jextra = {}
    if variant == "autoscale":
        extra = dict(autoscale=ScaleParams(2, 50, 6, 1), scale_interval_s=0.5)
        jextra = dict(autoscale=jpolicy.ScaleParams(2, 50, 6, 1),
                      scale_interval_s=0.5)
    ours = sim.simulate(tr, specs[0], rates=TOY_RATES, **kw, **extra)
    theirs = jsim.simulate(jtr, specs[1], rates=jsim.SimRates(**RATES),
                           **kw, **jextra)
    assert ours.event_log_sha256 == theirs.event_log_sha256
    assert _record(ours) == _record(theirs)
    if variant == "shed":
        assert ours.n_shed > 0 and ours.n_done + ours.n_shed == 300
    elif variant == "autoscale":
        assert ours.scale_ups > 0 and ours.n_done == 300
    else:
        assert sum(ours.preemptions.values()) > 0 and ours.n_done == 300


def test_event_log_is_the_digest_and_repeats(tmp_path):
    tr = _toy(ptrace, 200, dt=0.002)
    logs = []
    for i in range(2):
        path = str(tmp_path / f"events_{i}.log")
        rep = sim.simulate(tr, fleet_policy.POLICIES["affinity"],
                           n_replicas=3, slots=4, n_prefill=2,
                           rates=TOY_RATES, log_path=path)
        logs.append((rep.event_log_sha256, open(path).read()))
    assert logs[0] == logs[1] and logs[0][1]
    import hashlib

    assert hashlib.sha256(logs[0][1].encode()).hexdigest() == logs[0][0]


def test_simulator_executes_the_policy_module(monkeypatch):
    calls = []
    real = fleet_policy.route_least_loaded

    def spy(state, req=None):
        calls.append(req)
        return real(state, req)

    monkeypatch.setattr(fleet_policy, "route_least_loaded", spy)
    rep = sim.simulate(_toy(ptrace, 4), fleet_policy.POLICIES["least_loaded"],
                       n_replicas=2, slots=2, n_prefill=1, rates=TOY_RATES)
    assert rep.n_done == 4 and len(calls) >= 4


def test_rates_from_the_h100_cost_table():
    from burst_attn_tpu_torch.analysis import costmodel

    table = costmodel.cost_table()
    rates = sim.rates_from_cost_table(table, generation="h100")
    fwd = [r for r in table["rows"] if r["pass"] == "fwd"
           and r["wire"] is None]
    t_pass = min(max(r["t_compute_s"], r["t_comm_s"]) for r in fwd)
    assert rates.prefill_tokens_per_s == pytest.approx(8 * 8192 / t_pass)
    step = costmodel.ragged_hbm_bytes(d_head=128, n_kv=32, kv_len=8192,
                                      pool_dtype="fp32")
    assert rates.decode_steps_per_s == pytest.approx(3.35e12 / step)
    assert rates.ship_bytes_per_s == costmodel.HW["h100"].ici_bw
    assert rates == sim.rates_from_cost_table()  # h100 is the default
    with pytest.raises(ValueError, match="schema"):
        sim.rates_from_cost_table({"schema": "nope"})


def _outcome(rid, t_arrival, t_submit, t_done, n_tokens):
    return types.SimpleNamespace(rid=rid, status="done",
                                 t_arrival=t_arrival, t_submit=t_submit,
                                 t_done=t_done,
                                 tokens=list(range(n_tokens)))


def test_fidelity_gate_passes_on_self_consistent_outcomes():
    tr = _toy(ptrace, 40, dt=0.05, prompt_len=100, max_new=10)
    jtr = _toy(jtrace, 40, dt=0.05, prompt_len=100, max_new=10)
    step_s, prefill_s = 0.01, 100 / 5000.0
    outcomes = {}
    for r in tr.requests:
        t_submit = r.t_arrival + prefill_s
        outcomes[r.rid] = _outcome(r.rid, r.t_arrival, t_submit,
                                   t_submit + 10 * step_s, 10)
    v = sim.fidelity_check(tr, outcomes, n_replicas=2, slots=2, n_prefill=1)
    jv = jsim.fidelity_check(jtr, outcomes, n_replicas=2, slots=2,
                             n_prefill=1)
    assert v["ok"] and abs(v["ratio"] - 1.0) < 0.10
    assert v["rtol"] == sim.SIM_FIDELITY_RTOL == 0.35
    assert (v["ratio"], v["rates"]) == (jv["ratio"], jv["rates"])


def test_fidelity_gate_fails_on_a_wrong_world():
    tr = _toy(ptrace, 40, dt=0.001, prompt_len=100, max_new=10)
    outcomes = {}
    for i, r in enumerate(tr.requests):
        outcomes[r.rid] = _outcome(r.rid, r.t_arrival, r.t_arrival + 0.02,
                                   0.02 + (i + 1) * 0.1, 10)
    v = sim.fidelity_check(tr, outcomes, n_replicas=2, slots=2, n_prefill=1)
    assert not v["ok"]


def test_calibrated_rates_round_trip(tmp_path):
    tr = _toy(ptrace, 10, dt=0.05, prompt_len=100, max_new=10)
    outcomes = {r.rid: _outcome(r.rid, r.t_arrival, r.t_arrival + 0.02,
                                r.t_arrival + 0.12, 10) for r in tr.requests}
    rates = sim.calibrate_rates(tr, outcomes, n_prefill=1, slots=2)
    assert math.isinf(rates.ship_bytes_per_s)
    path = sim.save_rates(rates, str(tmp_path / "r" / "rates.json"))
    assert sim.load_rates(path) == rates


def test_promote_policy_requires_a_real_fleet_win():
    simg = {"least_loaded": 100.0, "affinity": 130.0}
    assert sim.promote_policy("least_loaded", simg,
                              {"least_loaded": 11.0}) == "least_loaded"
    assert sim.promote_policy("least_loaded", simg,
                              {"least_loaded": 11.0, "affinity": 10.0}) \
        == "least_loaded"
    assert sim.promote_policy("least_loaded", simg,
                              {"least_loaded": 11.0, "affinity": 11.0}) \
        == "least_loaded"
    assert sim.promote_policy("least_loaded", simg,
                              {"least_loaded": 11.0, "affinity": 12.0}) \
        == "affinity"
    assert sim.promote_policy("affinity", simg, {}) == "affinity"


def test_cli_rates_from_the_table_and_from_a_file(tmp_path, capsys):
    report = tmp_path / "sweep.jsonl"
    assert sim.main(["--requests", "300", "--replicas", "4", "--report",
                     str(report)]) == 0
    recs = [json.loads(line) for line in open(report)]
    assert len(recs) == len(fleet_policy.POLICIES)
    assert all(r["record"] == "sim-policy-report" and r["n_done"] == 300
               for r in recs)
    rates = str(tmp_path / "rates.json")
    sim.save_rates(TOY_RATES, rates)
    assert sim.main(["--requests", "300", "--replicas", "4", "--policy",
                     "least_loaded", "--rates", rates, "--report",
                     str(report)]) == 0
    (rec,) = [json.loads(line) for line in open(report)]
    theirs = jsim.simulate(
        jtrace.synthesize_diurnal_trace(300, seed=0, vocab=97, period_s=600.0,
                                        mean_rate=20.0,
                                        priority_fraction=0.1),
        jpolicy.POLICIES["least_loaded"], n_replicas=4, slots=8,
        rates=jsim.SimRates(**RATES), seed=0)
    assert rec["event_log_sha256"] == theirs.event_log_sha256
    capsys.readouterr()


# -- slow: the JAX suite's slow acceptance cases ------------------------------


@pytest.mark.slow
def test_sim_fidelity_vs_real_fleet_replay(tmp_path):
    """A real process-backed fleet on the CPU (tiny model), the sim
    calibrated from its measured outcome timeline: simulated goodput
    within SIM_FIDELITY_RTOL of measured."""
    from burst_attn_tpu_torch.fleet import FleetCluster

    spec = dict(vocab=97, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
                d_head=16, d_ff=64, seed=0, device="cpu")
    pspec = dict(sp=2, page=128, n_pages=4, max_pages_per_seq=8)
    dspec = dict(sp=2, slots=2, page=128, n_pages=8, max_pages_per_seq=4)
    reqs = [ptrace.TraceRequest(rid=i, t_arrival=round(0.05 * i, 6),
                                prompt_len=128, prompt_seed=100 + i,
                                max_new_tokens=4) for i in range(6)]
    tr = ptrace.Trace(meta={"vocab": 97}, requests=reqs)
    with FleetCluster(spec, prefill_spec=pspec, decode_spec=dspec,
                      n_prefill=1, n_decode=2, out_dir=str(tmp_path),
                      transport="queue") as fc:
        rep = fc.replay(tr, speed=25.0, max_wall_s=420.0)
    assert all(o.status == "done" for o in rep.outcomes.values())
    v = sim.fidelity_check(tr, rep.outcomes, n_replicas=2,
                           slots=dspec["slots"], n_prefill=1)
    assert v["ok"] and v["measured_goodput"] > 0, v


@pytest.mark.slow
def test_sim_1000_replicas_1m_requests_deterministic():
    import time as _time

    tr = ptrace.synthesize_diurnal_trace(1_000_000, seed=7, vocab=97,
                                         period_s=3600.0, mean_rate=400.0,
                                         priority_fraction=0.05)
    rates = sim.rates_from_cost_table()
    digests = []
    for _ in range(2):
        t0 = _time.perf_counter()
        rep = sim.simulate(tr, fleet_policy.POLICIES["least_loaded"],
                           n_replicas=1000, slots=8, rates=rates, seed=7)
        assert _time.perf_counter() - t0 < 60.0
        assert rep.n_done == 1_000_000 and rep.events >= 3_000_000
        digests.append(rep.event_log_sha256)
    assert digests[0] == digests[1]
