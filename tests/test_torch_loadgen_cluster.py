"""The port's multi-process serve cluster (burst_attn_tpu_torch.loadgen.
cluster) on CPU workers (`"device": "cpu"` in the model spec): spawned
workers behind the router survive a mid-decode SIGKILL and a restart from
snapshot + journal with token streams EXACTLY the single-process
oracle's, and a journal resume re-decodes strictly fewer tokens than a
replay from scratch.  Each run carries its own time limits (the cluster's
start / restart timeouts and the replay's max_wall_s)."""

from burst_attn_tpu_torch.loadgen import (
    FaultEvent, LoadGenCluster, Objectives, assert_token_exact, compute_slo,
    evaluate, oracle_replay, synthesize_trace,
)
from burst_attn_tpu_torch.loadgen.slo import counter_total
from burst_attn_tpu_torch.loadgen.worker import build_engine

MODEL_SPEC = dict(vocab=97, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
                  d_head=16, d_ff=64, seed=0, device="cpu")
ENGINE_SPEC = dict(kind="ragged", slots=2, n_pages=6, page=128,
                   max_pages_per_seq=2, chunk=8, max_queue=16)
LIMITS = dict(start_timeout_s=120.0, restart_timeout_s=120.0)


def _trace(n, seed, **kw):
    # budgets floored at 24 tokens: an armed kill lands mid-decode; the
    # arrivals span ~2 s, so a kill waiting for journaled progress (it
    # fires unarmed only once no work can come) finds some
    return synthesize_trace(n, seed=seed, vocab=97, mean_interarrival_s=0.25,
                            prompt_len_max=24, max_new_min=24,
                            max_new_mean=32, max_new_max=40, **kw)


def _oracle(trace, spec):
    return oracle_replay(trace, lambda: build_engine(
        MODEL_SPEC, dict(spec, max_queue=None)))


def test_cluster_kill_and_restart_token_exact(tmp_path):
    """Worker 0 is SIGKILLed mid-decode (its orphans resume on worker 1
    from its journal), then worker 1 is restarted: its replacement
    restores snapshot + journal and finishes what it claimed.  Every
    normal request completes with the oracle's tokens, the poison one is
    rejected, every worker life reports its boot, and the merged exports
    make an SLO report."""
    trace = _trace(8, seed=7, poison_rate=0.15)
    assert any(r.poison for r in trace.requests)
    faults = [FaultEvent(t=0.05, kind="kill", worker=0, note="mid-decode"),
              FaultEvent(t=0.1, kind="restart", worker=1)]
    with LoadGenCluster(MODEL_SPEC, ENGINE_SPEC, n_workers=2,
                        out_dir=str(tmp_path), checkpoint=True,
                        **LIMITS) as cluster:
        report = cluster.replay(trace, faults, speed=1.0, max_wall_s=120)
        cluster.stop()
        metrics, _spans, meta = cluster.merged()
        boots, stopped = list(cluster.boot_s), dict(cluster.stopped)
    assert [k.get("restarted", False) for k in report.kills] == [False, True]
    assert report.kills[0]["detected_by"] == "scheduled-kill"
    assert report.n_done == len(trace.normal())
    assert report.n_rejected == sum(r.poison for r in trace.requests)
    assert_token_exact(report.completed(), _oracle(trace, ENGINE_SPEC))
    assert report.recovered_tokens_resumed > 0
    assert sorted((b["worker"], b["gen"]) for b in boots) == \
        [(0, 0), (1, 0), (1, 1)]
    assert all(b["s"] > 0 and b["total_s"] > 0 for b in boots)
    # the stopped frame carries the kernel counters (0 on the CPU: the
    # wrappers count launches on the card only) and the drained pool
    assert set(stopped) == {1} and set(stopped[1]["kernels"]) == {
        "flash_fwd", "paged_decode", "ragged_paged", "fused_ring_fwd"}
    assert stopped[1]["pool_free"] == stopped[1]["pool_usable"] == 5
    assert meta["processes"] >= 2
    slo = compute_slo(metrics, duration_s=report.duration_v,
                      completed_tokens=report.completed_tokens,
                      n_done=report.n_done,
                      recovery_s=report.recovery_s())
    assert slo["goodput_tokens_per_s"] > 0 and slo["recovery_count"] == 2
    ok, violations = evaluate(slo, Objectives(min_goodput_tokens_per_s=0.01))
    assert ok, violations


def test_cluster_resume_replays_less_than_scratch_legacy(tmp_path):
    """The same trace and kill with journal resume on and off, on the
    ServeEngine kind: both token-exact, and the resumed run re-decodes
    strictly fewer tokens (the workers' counters agree with the
    router's ledger)."""
    spec = dict(ENGINE_SPEC, kind="legacy")
    spec.pop("chunk")
    trace = _trace(8, seed=11)
    oracle = _oracle(trace, spec)
    replayed = {}
    for resume in (True, False):
        with LoadGenCluster(MODEL_SPEC, spec, n_workers=2,
                            out_dir=str(tmp_path / str(resume)),
                            checkpoint=True, resume=resume,
                            **LIMITS) as cluster:
            report = cluster.replay(
                trace, [FaultEvent(t=0.05, kind="kill", worker=0)],
                speed=1.0, max_wall_s=120)
            cluster.stop()
            metrics = cluster.merged()[0]
        assert len(report.kills) == 1
        assert report.n_done == len(trace.normal())
        assert_token_exact(report.completed(), oracle)
        replayed[resume] = report.recovered_tokens_replayed
        if resume:
            assert report.recovered_tokens_resumed > 0
        else:
            assert counter_total(metrics, "serve.recovered_tokens_replayed") \
                >= report.recovered_tokens_replayed > 0
    assert replayed[True] < replayed[False], replayed
