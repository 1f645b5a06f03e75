"""The port's observability package (burst_attn_tpu_torch/obs/) held to
the JAX package's tests/test_obs.py, case for case where the case needs
no JAX: registry math incl. histogram bucket edges, span nesting /
threading and the capture no-op path (the port's form of the under-jit
no-op), exporter round trips (JSONL -> CLI merge, Prometheus text), the
serve-engine counters through a real short `ServeEngine.run`, and ring
round / hop counters matching the schedule.  Then what only the port
has to show: a JSONL written by either package renders through the
other's CLI the same, and one seeded workload through both packages'
engines gives equal counters, histogram counts and trace trees."""

import json
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from burst_attn_tpu_torch import obs
from burst_attn_tpu_torch.obs.__main__ import (
    load_records, merge_records, render_prometheus, render_text,
)
from burst_attn_tpu_torch.obs.registry import Registry


# ---------------------------------------------------------------------------
# registry math


def test_counter_labels_and_total():
    r = Registry()
    c = r.counter("x.count")
    c.inc()
    c.inc(2, path="fused")
    c.inc(3, path="scan")
    assert c.get() == 1
    assert c.get(path="fused") == 2
    assert c.total() == 6
    assert r.counter("x.count") is c  # get-or-create returns the same object


def test_counter_rejects_negative_and_kind_mismatch():
    r = Registry()
    c = r.counter("x")
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(TypeError):
        r.gauge("x")


def test_gauge_set_inc_dec():
    r = Registry()
    g = r.gauge("depth")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.get() == 3
    g.set(7.5, pool="draft")
    assert g.get(pool="draft") == 7.5


def test_histogram_bucket_edges_le_semantics():
    r = Registry()
    h = r.histogram("lat", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.0000001, 2.0, 4.0, 4.1, 100.0):
        h.observe(v)
    snap = h.get()
    # le semantics: a value ON an edge counts in that edge's bucket
    assert snap["buckets"] == {"1.0": 2, "2.0": 2, "4.0": 1, "+Inf": 2}
    assert snap["count"] == 7
    assert snap["min"] == 0.5 and snap["max"] == 100.0
    assert snap["sum"] == pytest.approx(sum((0.5, 1.0, 1.0000001, 2.0, 4.0,
                                             4.1, 100.0)))


def test_histogram_rejects_unsorted_buckets():
    r = Registry()
    with pytest.raises(ValueError):
        r.histogram("bad", buckets=(2.0, 1.0))
    with pytest.raises(ValueError):
        r.histogram("dup", buckets=(1.0, 1.0, 2.0))


def test_histogram_empty_child_snapshot():
    r = Registry()
    h = r.histogram("never")
    assert h.get() == {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                       "buckets": {}}


# ---------------------------------------------------------------------------
# exporters


def _sample_registry():
    r = Registry()
    r.counter("c").inc(3, kind="a")
    r.gauge("g").set(2.5)
    h = r.histogram("h", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    return r


def test_prometheus_text_cumulative_buckets():
    text = _sample_registry().to_prometheus()
    assert '# TYPE burst_c counter' in text
    assert 'burst_c{kind="a"} 3' in text
    assert 'burst_g 2.5' in text
    # cumulative: le0.1 -> 1, le1 -> 2, +Inf -> 3
    assert 'burst_h_bucket{le="0.1"} 1' in text
    assert 'burst_h_bucket{le="1"} 2' in text
    assert 'burst_h_bucket{le="+Inf"} 3' in text
    assert 'burst_h_count 3' in text


def test_jsonl_export_roundtrip(tmp_path):
    r = _sample_registry()
    path = str(tmp_path / "obs.jsonl")
    r.export_jsonl(path)
    r.counter("c").inc(kind="a")  # second snapshot supersedes the first
    r.export_jsonl(path)
    records = load_records(path)
    metrics, spans, meta = merge_records(records)
    assert meta["snapshots"] == 2
    by_name = {(m["name"], tuple(sorted(m["labels"].items()))): m
               for m in metrics}
    assert by_name[("c", (("kind", "a"),))]["value"] == 4  # last wins
    hist = by_name[("h", ())]
    assert hist["count"] == 3 and hist["overflow"] == 1
    text = render_text(metrics, spans, meta, path)
    assert "c{kind=a}" in text and "h" in text
    prom = render_prometheus(metrics)
    assert 'burst_h_bucket{le="+Inf"} 3' in prom


def test_cli_subprocess_json_and_prom(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    _sample_registry().export_jsonl(path)
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs", "--json",
         "--file", path],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    d = json.loads(r.stdout)
    assert {m["name"] for m in d["metrics"]} == {"c", "g", "h"}
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs", "--prom",
         "--file", path],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "# TYPE burst_h histogram" in r.stdout


def test_cli_missing_file_exit_1(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs",
         "--file", str(tmp_path / "nope.jsonl")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 1


def test_cli_unparseable_file_exit_2(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"kind": "meta"}\nnot json at all\n')
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs", "--file", str(p)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 2


# ---------------------------------------------------------------------------
# multi-process merge (obs/aggregate.py + CLI --merge)


def _proc_registry(p):
    """One synthetic process's final state: overlapping counter/gauge/
    histogram children so the cross-process fold is non-trivial."""
    r = Registry()
    r.counter("serve.requests").inc(10 + p, route="a")
    r.counter("train.steps").inc(100 * (p + 1))
    r.gauge("queue.depth").set(2 * p)
    h = r.histogram("lat", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5 + p)  # p=0 -> le1.0 bucket, p>=1 -> overflow
    return r


def _write_proc_files(tmp_path, n=3):
    paths = []
    for p in range(n):
        path = str(tmp_path / f"obs_{p}.jsonl")
        _proc_registry(p).export_jsonl(path, process_index=p)
        paths.append(path)
    return paths


def test_merge_processes_counters_sum_gauges_labeled(tmp_path):
    from burst_attn_tpu_torch.obs.aggregate import merge_files

    _write_proc_files(tmp_path, 3)
    metrics, spans, meta = merge_files([str(tmp_path / "obs*.jsonl")])
    assert meta["processes"] == 3
    assert meta["process_labels"] == ["0", "1", "2"]
    by = {(m["name"], tuple(sorted(m["labels"].items()))): m for m in metrics}
    # counters: summed across processes, no process label
    assert by[("serve.requests", (("route", "a"),))]["value"] == 10 + 11 + 12
    assert by[("train.steps", ())]["value"] == 100 + 200 + 300
    # gauges: last-wins is per-process state -> one child per process
    for p in range(3):
        assert by[("queue.depth", (("process_index", str(p)),))][
            "value"] == 2 * p
    # histograms: bucket-wise add (same edges)
    hist = by[("lat", ())]
    assert hist["count"] == 6 and hist["bucket_counts"] == [3, 1]
    assert hist["overflow"] == 2
    assert hist["min"] == 0.05 and hist["max"] == 2.5


def test_merge_by_process_keeps_children_apart(tmp_path):
    from burst_attn_tpu_torch.obs.aggregate import merge_files

    _write_proc_files(tmp_path, 2)
    metrics, _, meta = merge_files([str(tmp_path / "obs*.jsonl")],
                                   by_process=True)
    by = {(m["name"], tuple(sorted(m["labels"].items()))): m for m in metrics}
    assert by[("serve.requests",
               (("process_index", "0"), ("route", "a")))]["value"] == 10
    assert by[("serve.requests",
               (("process_index", "1"), ("route", "a")))]["value"] == 11
    assert by[("lat", (("process_index", "1"),))]["count"] == 2


def test_merge_histogram_edge_mismatch_stays_per_process(tmp_path):
    from burst_attn_tpu_torch.obs.aggregate import merge_files

    r0 = Registry()
    r0.histogram("lat", buckets=(0.1, 1.0)).observe(0.5)
    r0.export_jsonl(str(tmp_path / "obs_0.jsonl"), process_index=0)
    r1 = Registry()
    r1.histogram("lat", buckets=(0.2, 2.0)).observe(0.5)
    r1.export_jsonl(str(tmp_path / "obs_1.jsonl"), process_index=1)
    metrics, _, _ = merge_files([str(tmp_path / "obs*.jsonl")])
    lat = sorted((m for m in metrics if m["name"] == "lat"),
                 key=lambda m: sorted(m["labels"].items()))
    # apples stay apart from oranges: the mismatched child keeps its
    # process_index label instead of being added bucket-wise
    assert len(lat) == 2
    assert any(m["labels"].get("process_index") == "1" for m in lat)


def test_export_meta_carries_process_index(tmp_path):
    path = str(tmp_path / "obs.jsonl")
    _proc_registry(0).export_jsonl(path, process_index=5)
    metas = [r for r in load_records(path) if r["kind"] == "meta"]
    assert metas and metas[-1]["process_index"] == 5
    # and the package-level exporter tags automatically (process 0 here)
    path2 = str(tmp_path / "obs2.jsonl")
    obs.export_jsonl(path2)
    metas2 = [r for r in load_records(path2) if r["kind"] == "meta"]
    assert metas2 and metas2[-1]["process_index"] == 0


def test_cli_merge_subprocess_report_and_exit_codes(tmp_path):
    _write_proc_files(tmp_path, 2)
    pat = str(tmp_path / "obs*.jsonl")
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs", "--merge", pat,
         "--json"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    d = json.loads(r.stdout)
    assert d["meta"]["processes"] == 2
    by = {(m["name"], tuple(sorted(m["labels"].items()))): m
          for m in d["metrics"]}
    assert by[("serve.requests", (("route", "a"),))]["value"] == 21
    assert [("queue.depth", (("process_index", "0"),)) in by,
            ("queue.depth", (("process_index", "1"),)) in by] == [True, True]
    # text mode renders one report line with process provenance
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs", "--merge", pat],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "2 process export(s)" in r.stdout
    # no matches -> 1; unparseable -> 2
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs", "--merge",
         str(tmp_path / "nope*.jsonl")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    bad = tmp_path / "obs_bad.jsonl"
    bad.write_text("not json\n")
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs", "--merge",
         str(tmp_path / "obs_bad.jsonl")],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 2


# ---------------------------------------------------------------------------
# spans


def test_span_nesting_parent_child():
    obs.reset_spans()
    with obs.span("outer", phase="x") as sp_out:
        sp_out.set("k", 1)
        with obs.span("inner") as sp_in:
            assert sp_in.parent_id == sp_out.span_id
            assert sp_in.depth == 1
    done = obs.completed_spans()
    names = [s.name for s in done]
    assert names == ["inner", "outer"]  # children complete first
    inner, outer = done
    assert inner.parent_id == outer.span_id
    assert outer.parent_id is None
    assert outer.attrs == {"phase": "x", "k": 1}
    assert outer.duration_s >= inner.duration_s >= 0
    # aggregate histogram fed too
    assert obs.histogram("span.outer").get()["count"] >= 1


def test_span_threading_independent_stacks():
    obs.reset_spans()
    barrier = threading.Barrier(2)
    errs = []

    def work(tag):
        try:
            with obs.span(f"t.{tag}") as sp:
                barrier.wait(timeout=10)  # both outer spans live at once
                with obs.span(f"t.{tag}.child") as child:
                    assert child.parent_id == sp.span_id
        except Exception as e:  # noqa: BLE001 — surfaced via errs
            errs.append(e)

    ts = [threading.Thread(target=work, args=(i,), name=f"w{i}")
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert errs == []
    done = {s.name: s for s in obs.completed_spans()}
    assert set(done) == {"t.0", "t.1", "t.0.child", "t.1.child"}
    for i in range(2):
        assert done[f"t.{i}.child"].parent_id == done[f"t.{i}"].span_id
        assert done[f"t.{i}.child"].thread == done[f"t.{i}"].thread == f"w{i}"


def _capturing(monkeypatch):
    """Make the calling thread look like it is capturing a CUDA graph
    (the real capture runs in tests/test_torch_cuda.py on the card)."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)


def test_span_is_noop_under_jit(monkeypatch):
    """The port's form: a span entered while a CUDA graph is being
    captured is a no-op (no clock, no registry, no completed span)."""
    obs.reset_spans()
    before = obs.histogram("span.under_jit").get()["count"]
    _capturing(monkeypatch)
    with obs.span("under_jit") as sp:
        assert sp.span_id is None  # the no-op handle
    monkeypatch.undo()
    assert obs.completed_spans() == []
    assert obs.histogram("span.under_jit").get()["count"] == before


def test_traced_decorator():
    obs.reset_spans()

    @obs.traced("deco.name")
    def g(a, b):
        return a + b

    assert g(2, 3) == 5
    assert [s.name for s in obs.completed_spans()] == ["deco.name"]


# ---------------------------------------------------------------------------
# StepTimer (moved from utils.profiling; single-step summary regression)


def test_steptimer_single_step_summary_is_finite():
    t = obs.StepTimer()
    with t as tt:
        tt.watch(torch.zeros(2))
    s = t.summary(skip_first=1)  # would drop the ONLY step: falls back
    assert s["steps"] == 1
    for k in ("mean_s", "min_s", "max_s", "p50_s", "std_s"):
        assert np.isfinite(s[k]), (k, s)
    assert s["std_s"] == 0.0


def test_steptimer_skip_first_honored_with_multiple_steps():
    t = obs.StepTimer()
    t.times = [100.0, 1.0, 3.0]  # fake a compile-heavy first step
    s = t.summary(skip_first=1)
    assert s["steps"] == 2 and s["mean_s"] == 2.0 and s["max_s"] == 3.0


def test_profiling_shims_still_import():
    from burst_attn_tpu_torch.utils import profiling

    assert profiling.StepTimer is obs.StepTimer
    assert profiling.annotate is obs.annotate
    with profiling.annotate("shim"):  # still a usable context manager
        pass


# ---------------------------------------------------------------------------
# subsystem instrumentation: serve engine + ring dispatch


@pytest.fixture(scope="module")
def model():
    from burst_attn_tpu_torch.models.transformer import (
        ModelConfig, init_params,
    )

    cfg = ModelConfig(
        vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, attn_backend="jnp", remat=False, dtype=torch.float32,
        batch_axis=None, head_axis=None,
    )
    return cfg, init_params(cfg, 0, device="cpu")


def test_serve_engine_counters_advance(model):
    from burst_attn_tpu_torch.models.serve import ServeEngine

    cfg, params = model
    before = {
        "submitted": obs.counter("serve.requests_submitted").total(),
        "admitted": obs.counter("serve.requests_admitted").total(),
        "retired": obs.counter("serve.requests_retired").total(),
        "steps": obs.counter("serve.engine_steps").total(),
        "tokens": obs.counter("serve.tokens_generated").total(),
        "ttft": obs.histogram("serve.ttft_s").get()["count"],
        "tok_lat": obs.histogram("serve.token_latency_s").get()["count"],
    }
    eng = ServeEngine(params, cfg, slots=2, n_pages=10, page=128,
                      max_pages_per_seq=3, device="cpu")
    rng = np.random.default_rng(7)
    budgets = (4, 3)
    for b in budgets:
        eng.submit(rng.integers(1, cfg.vocab, size=6, dtype=np.int32), b)
    got = eng.run()
    assert {len(v) for v in got.values()} == set(budgets)
    assert obs.counter("serve.requests_submitted").total() - \
        before["submitted"] == 2
    assert obs.counter("serve.requests_admitted").total() - \
        before["admitted"] == 2
    assert obs.counter("serve.requests_retired").total() - \
        before["retired"] == 2
    assert obs.counter("serve.engine_steps").total() > before["steps"]
    assert obs.counter("serve.tokens_generated").total() - \
        before["tokens"] == sum(budgets)
    assert obs.histogram("serve.ttft_s").get()["count"] - before["ttft"] == 2
    assert obs.histogram("serve.token_latency_s").get()["count"] \
        > before["tok_lat"]
    # idle engine: gauges read the drained state
    assert obs.gauge("serve.queue_depth").get() == 0
    assert obs.gauge("serve.live_slots").get() == 0
    assert obs.gauge("serve.page_pool_occupancy").get() == 0.0


def test_serve_rejection_counter(model):
    from burst_attn_tpu_torch.models.serve import ServeEngine

    cfg, params = model
    eng = ServeEngine(params, cfg, slots=1, n_pages=4, page=128,
                      max_pages_per_seq=8, device="cpu")
    before = obs.counter("serve.requests_rejected").get(reason="pool-size")
    with pytest.raises(ValueError):
        # needs ceil((300+200)/128)=4 pages; the pool only has 3 usable
        eng.submit(np.ones(300, np.int32), 200)
    assert obs.counter("serve.requests_rejected").get(
        reason="pool-size") == before + 1


def test_ring_round_and_hop_counters_match_schedule():
    """burst.ring_rounds advances by W and burst.ring_hops by W-1 per
    forward dispatch on a W-wide ring (the positions share the CPU)."""
    import burst_attn_tpu_torch as bat

    world = 8
    q = torch.randn(1, 2, world * 16, 8, generator=torch.Generator()
                    .manual_seed(0))
    ql = bat.layouts.to_layout(q, "zigzag", world, 2)
    rounds0 = obs.counter("burst.ring_rounds").total()
    hops0 = obs.counter("burst.ring_hops").get(axis="intra")
    bat.burst_attn(ql, ql, ql, mesh={"sp": world}, causal=True,
                   layout="zigzag", backend="jnp")
    assert obs.counter("burst.ring_rounds").total() - rounds0 == world
    assert obs.counter("burst.ring_hops").get(axis="intra") - hops0 \
        == world - 1


def test_fused_dispatch_fallback_counter():
    """A fused_ring dispatch the kernels decline (cross-attention shard
    lengths, here under grad: the forward and the backward each decline)
    counts a scan-path dispatch per pass and a fallback reason per pass.
    (The port counts each pass's dispatch where it happens; the JAX
    package counts both passes at the forward's trace.)"""
    import burst_attn_tpu_torch as bat

    world = 4
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 2, world * 16, 8, generator=g, requires_grad=True)
    kv = torch.randn(1, 2, world * 32, 8, generator=g)
    scan0 = obs.counter("burst.dispatch").get(path="scan",
                                              backend="fused_ring",
                                              tile="pallas")
    fwd_lab = {"reason": "cross-attn", "pass": "fwd"}
    bwd_lab = {"reason": "cross-attn", "pass": "bwd"}
    fb0 = obs.counter("burst.fused_fallback").get(**fwd_lab)
    fb0b = obs.counter("burst.fused_fallback").get(**bwd_lab)
    o = bat.burst_attn(q, kv, kv, mesh={"sp": world}, layout="contig",
                       backend="fused_ring")
    o.sum().backward()
    assert obs.counter("burst.dispatch").get(
        path="scan", backend="fused_ring", tile="pallas") == scan0 + 2
    assert obs.counter("burst.fused_fallback").get(**fwd_lab) == fb0 + 1
    assert obs.counter("burst.fused_fallback").get(**bwd_lab) == fb0b + 1


def test_ring_round_counts_double_ring():
    from burst_attn_tpu_torch.parallel.ring import ring_round_counts

    assert ring_round_counts(1, 8) == (8, 7, 0)
    assert ring_round_counts(1, 8, r_live=3) == (3, 2, 0)  # windowed
    assert ring_round_counts(2, 4) == (8, 6, 1)
    assert ring_round_counts(1, 1) == (1, 0, 0)  # single device: no hops


# ---------------------------------------------------------------------------
# obs logger


def test_logger_counts_records():
    log = obs.get_logger("obs.test.counting")
    before = obs.counter("log.events").get(level="WARNING")
    log.warning("w1")
    log.warning("w2")
    assert obs.counter("log.events").get(level="WARNING") == before + 2


def test_safe_warn_never_raises():
    class Exploding:
        def warning(self, *a):
            raise RuntimeError("logging machinery torn down")

    n0 = len(obs.dropped_messages())
    obs.safe_warn(Exploding(), "lost message %s", 1)  # must not raise
    dropped = obs.dropped_messages()
    assert len(dropped) == n0 + 1
    assert "lost message" in dropped[-1]


def test_log_helper_delegates_to_obs():
    from burst_attn_tpu_torch.utils.log_helper import get_logger

    log = get_logger("obs.test.shim")
    before = obs.counter("log.events").get(level="ERROR")
    log.error("boom")
    assert obs.counter("log.events").get(level="ERROR") == before + 1


def test_merge_tolerates_truncated_final_line_only(tmp_path):
    """ISSUE 9 satellite: a worker SIGKILLed mid-export leaves a torn
    FINAL line — the merge skips it with a `truncated_lines` count
    instead of failing the whole job view.  Garbage anywhere else (or a
    file that is nothing but garbage) still raises."""
    from burst_attn_tpu_torch.obs.aggregate import (
        load_records_tolerant, merge_files,
    )

    paths = _write_proc_files(tmp_path, 2)
    with open(paths[1], "a", encoding="utf-8") as f:
        f.write('{"kind": "counter", "name": "serve.requ')  # torn by kill
    records, skipped = load_records_tolerant(paths[1])
    assert skipped == 1 and all(isinstance(r, dict) for r in records)
    metrics, _spans, meta = merge_files([str(tmp_path / "obs*.jsonl")])
    assert meta["processes"] == 2
    assert meta["truncated_lines"] == 1
    by = {(m["name"], tuple(sorted(m["labels"].items()))): m for m in metrics}
    assert by[("train.steps", ())]["value"] == 100 + 200  # still summed
    # mid-file corruption is NOT truncation
    lines = open(paths[0], encoding="utf-8").read().splitlines()
    lines.insert(1, "not json")
    open(paths[0], "w", encoding="utf-8").write("\n".join(lines) + "\n")
    with pytest.raises(ValueError, match="not JSON"):
        load_records_tolerant(paths[0])
    # a garbage-only file stays loud (exit-2 path in the CLI)
    only_bad = tmp_path / "obs_bad.jsonl"
    only_bad.write_text("garbage\n")
    with pytest.raises(ValueError):
        load_records_tolerant(str(only_bad))


def test_torn_final_line_trace_tree_partial_but_flagged(tmp_path):
    """ISSUE 19 satellite: a process SIGKILLed mid-export leaves a torn
    final JSONL line — its trace spans that DID land still join the
    cross-process tree, but every tree touching the torn process reads
    as partial-but-flagged (`truncated`), never silently whole; a tree
    whose joining span was ON the lost line additionally drops
    `complete`."""
    from burst_attn_tpu_torch.obs.aggregate import build_trace_trees, merge_files
    from burst_attn_tpu_torch.obs.registry import Registry

    def write(path, proc, spans):
        recs = [dict(kind="trace", trace_id=t, span_id=s, parent_id=par,
                     name=s, start_s=a, duration_s=b - a, clock="wall",
                     attrs={})
                for (t, s, par, a, b) in spans]
        Registry().export_jsonl(str(path), extra_records=recs,
                                process_index=proc)

    # router (proc 0): roots + first-token markers for two requests
    write(tmp_path / "obs_r.jsonl", 0,
          [("t1", "request", None, 0.0, 1.0),
           ("t1", "fleet.first_token", "request", 0.9, 0.9),
           ("t2", "request", None, 0.0, 1.0)])
    # worker (proc 1): t1's phase span lands whole; t2's decode span
    # hangs off a span the torn final line would have carried
    write(tmp_path / "obs_w.jsonl", 1,
          [("t1", "fleet.prefill", "request", 0.1, 0.5),
           ("t2", "fleet.decode", "fleet.transfer", 0.2, 0.8)])
    with open(tmp_path / "obs_w.jsonl", "a", encoding="utf-8") as f:
        f.write('{"kind": "trace", "trace_id": "t2", "span_id": "fleet.tr')
    _metrics, _spans, meta = merge_files([str(tmp_path / "obs_*.jsonl")])
    assert meta["truncated_lines"] == 1
    assert meta["truncated_processes"] == ["1"]
    trees = {t["trace_id"]: t
             for t in build_trace_trees(meta["traces"],
                                        meta["truncated_processes"])}
    # t1: every span landed, but a contributing process lost its tail
    assert trees["t1"]["complete"] and trees["t1"]["truncated"]
    # t2: the lost line held the joining span — partial AND flagged
    assert not trees["t2"]["complete"] and trees["t2"]["truncated"]
    # and the span that did land is still in the partial tree
    assert [s["name"] for s in trees["t2"]["spans"]] \
        == ["request", "fleet.decode"]


# ---------------------------------------------------------------------------
# request tracing (obs/trace.py)


def test_trace_off_by_default_records_nothing():
    from burst_attn_tpu_torch.obs import trace as tracing

    tracing.reset_traces()
    assert not tracing.enabled()
    assert tracing.start_request(1) is None
    tc = tracing.TraceContext("t-off")
    tracing.record_span(tc, "serve.prefill", 0.0, 1.0)
    tracing.marker(tc, "serve.first_token", 0.5)
    tracing.note_ttft(tc, 0.5)
    with tracing.span(tc, "serve.decode"):
        pass
    assert tracing.trace_records() == []
    assert tracing.exemplar_records() == []


def test_trace_context_wire_roundtrip_and_garbage():
    from burst_attn_tpu_torch.obs import trace as tracing

    tracing.enable()
    try:
        tc = tracing.start_request(7, prefix="fleet")
        assert tc.trace_id.startswith("fleet-") and "-r7-" in tc.trace_id
        assert tc.span_id == "request" and tc.parent_id is None
        back = tracing.TraceContext.from_wire(tc.to_wire())
        assert (back.trace_id, back.span_id) == (tc.trace_id, tc.span_id)
        # a peer without tracing never attaches a context; a garbled one
        # must degrade to "no trace", never to an exception
        for garbage in (None, [], ["half"], "a-string", 7, {"t": 1}):
            assert tracing.TraceContext.from_wire(garbage) is None
        # concurrent requests never share a trace_id
        assert tracing.start_request(7).trace_id != tc.trace_id
    finally:
        tracing.reset_traces()


def test_trace_record_span_ids_and_jit_guard(monkeypatch):
    from burst_attn_tpu_torch.obs import trace as tracing

    tracing.enable()
    try:
        tc = tracing.start_request(3)
        tracing.record_span(tc, "serve.queued", 1.0, 2.0)
        tracing.record_span(tc, "serve.request", 0.5, 3.0, root=True, rid=3)
        tracing.record_span(tc, "serve.clip", 2.0, 1.0)  # end < start clips
        # a trace-record call reached during CUDA-graph capture is a no-op
        _capturing(monkeypatch)
        tracing.record_span(tc, "bad.span", 0.0, 1.0)
        tracing.note_ttft(tc, 99.0)
        monkeypatch.undo()
        recs = tracing.trace_records()
        assert [r["name"] for r in recs] \
            == ["serve.queued", "serve.request", "serve.clip"]
        child, root, clip = recs
        # child spans get deterministic name-based ids under the context
        assert (child["span_id"], child["parent_id"]) \
            == ("serve.queued", "request")
        assert (root["span_id"], root["parent_id"]) == ("request", None)
        assert root["attrs"] == {"rid": 3}
        assert clip["duration_s"] == 0.0
        assert all(ex["value"] != 99.0 for ex in tracing.exemplar_records())
    finally:
        tracing.reset_traces()


def test_ttft_breakdown_gap_and_exact_sum():
    from burst_attn_tpu_torch.obs.trace import ttft_breakdown

    def rec(span_id, parent, name, a, b):
        return dict(trace_id="t", span_id=span_id, parent_id=parent,
                    name=name, start_s=a, duration_s=b - a, clock="wall")

    spans = [
        rec("request", None, "serve.request", 10.0, 15.0),
        rec("serve.queued", "request", "serve.queued", 10.0, 11.0),
        rec("serve.prefill", "request", "serve.prefill", 11.5, 12.5),
        rec("serve.first_token", "request", "serve.first_token", 12.5, 12.5),
        # decode starts AT first token: clipped out of the breakdown
        rec("serve.decode", "request", "serve.decode", 12.5, 15.0),
        # grandchild: not a direct child of the root, never a phase
        rec("detail", "serve.prefill", "serve.detail", 11.6, 12.0),
    ]
    bd = ttft_breakdown(spans)
    assert bd["ttft_s"] == pytest.approx(2.5)
    assert bd["clock"] == "wall"
    assert bd["phases"]["queued"] == pytest.approx(1.0)
    assert bd["phases"]["prefill"] == pytest.approx(1.0)
    assert bd["phases"]["gap"] == pytest.approx(0.5)   # 11.0 .. 11.5
    assert "decode" not in bd["phases"] and "detail" not in bd["phases"]
    # phases sum to the TTFT by construction, not within a tolerance
    assert sum(bd["phases"].values()) == pytest.approx(bd["ttft_s"],
                                                       abs=1e-12)
    # no first-token marker: TTFT falls back to the root span's end
    no_ft = [s for s in spans if not s["name"].endswith("first_token")]
    assert ttft_breakdown(no_ft)["ttft_s"] == pytest.approx(5.0)
    # rootless tree (torn merge) yields None, not a crash
    assert ttft_breakdown([s for s in spans if s["parent_id"]]) is None


def test_note_ttft_exemplar_worst_wins_and_bucket_edges():
    from burst_attn_tpu_torch.obs import trace as tracing

    # bucket edges come from the registered histogram when one exists
    obs.histogram("test.trace.ttft_s", buckets=(0.1, 1.0))
    tracing.enable()
    try:
        tracing.note_ttft("trace-a", 0.4, metric="test.trace.ttft_s")
        tracing.note_ttft("trace-b", 0.6, metric="test.trace.ttft_s")
        tracing.note_ttft("trace-c", 0.5, metric="test.trace.ttft_s")
        tracing.note_ttft("trace-d", 7.0, metric="test.trace.ttft_s")
        ex = {(e["metric"], e["le"]): e for e in tracing.exemplar_records()}
        # worst value wins the bucket; a later-but-faster trace does not
        assert ex[("test.trace.ttft_s", "1.0")]["trace_id"] == "trace-b"
        assert ex[("test.trace.ttft_s", "1.0")]["value"] == 0.6
        # beyond the last edge lands on +Inf
        assert ex[("test.trace.ttft_s", "+Inf")]["trace_id"] == "trace-d"
        # unregistered metric falls back to the default latency edges
        tracing.note_ttft("trace-e", 0.6, metric="test.trace.other")
        ex = {(e["metric"], e["le"]): e for e in tracing.exemplar_records()}
        assert ("test.trace.other", "1.0") in ex
    finally:
        tracing.reset_traces()


def test_trace_tail_sampling_keeps_worst_and_unnoted():
    from burst_attn_tpu_torch.obs import trace as tracing

    tracing.enable()
    try:
        n = tracing.TAIL_KEEP + 40
        for i in range(n):
            tc = tracing.TraceContext(f"samp-{i}")
            tracing.record_span(tc, "serve.request", 0.0, 1.0, root=True)
            # trace i has TTFT i seconds: the top TAIL_KEEP are the tail
            tracing.note_ttft(tc, float(i), metric="test.samp.ttft_s")
        # one more trace whose TTFT was never noted (e.g. recorded by a
        # worker process that never sees first-token): always kept
        orphan = tracing.TraceContext("samp-orphan")
        tracing.record_span(orphan, "fleet.prefill", 0.0, 1.0, root=True)
        kept = {r["trace_id"] for r in tracing.trace_records()}
        assert "samp-orphan" in kept
        tail = {f"samp-{i}" for i in range(n - tracing.TAIL_KEEP, n)}
        assert tail <= kept
        # the fast half is dropped except the deterministic head sample
        import zlib as _z
        for i in range(20):
            tid = f"samp-{i}"
            head = _z.crc32(tid.encode()) % tracing.HEAD_SAMPLE_N == 0
            assert (tid in kept) == head
    finally:
        tracing.reset_traces()


def test_render_prometheus_exemplar_lines():
    """ISSUE 19 satellite: `obs --prom` emits OpenMetrics-style exemplar
    suffixes on histogram buckets that have a sampled trace."""
    r = Registry()
    h = r.histogram("ttft", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.6)
    exemplars = [dict(kind="exemplar", metric="ttft", le="1.0",
                      trace_id="fleet-1-r0-1", value=0.6)]
    text = render_prometheus(r.snapshot(), exemplars)
    by_le = {}
    for line in text.splitlines():
        if line.startswith("burst_ttft_bucket"):
            by_le[line.split('le="')[1].split('"')[0]] = line
    assert by_le["1.0"].endswith('# {trace_id="fleet-1-r0-1"} 0.6')
    # buckets without a sampled trace carry no suffix
    assert "#" not in by_le["0.1"] and "#" not in by_le["+Inf"]
    # and no exemplars at all degrades to plain prometheus text
    assert "trace_id" not in render_prometheus(r.snapshot())


def test_cli_trace_and_waterfall_subprocess(tmp_path):
    from burst_attn_tpu_torch.obs import trace as tracing

    tracing.enable()
    try:
        tc = tracing.TraceContext("cli-t1")
        tracing.record_span(tc, "serve.request", 0.0, 2.0, root=True)
        tracing.record_span(tc, "serve.prefill", 0.0, 1.0)
        tracing.marker(tc, "serve.first_token", 1.0)
        path = str(tmp_path / "obs.jsonl")
        Registry().export_jsonl(path,
                                extra_records=tracing.trace_records(),
                                process_index=0)
    finally:
        tracing.reset_traces()
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs", "--trace",
         "--file", path],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "cli-t1" in r.stdout and "[complete]" in r.stdout
    assert "prefill=" in r.stdout and "gap=" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs",
         "--waterfall", "cli-t1", "--file", path],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("waterfall cli-t1")
    assert "serve.first_token" in r.stdout
    # unknown trace id: loud exit 1, like --file on a missing path
    r = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs",
         "--waterfall", "nope", "--file", path],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 1


# ---------------------------------------------------------------------------
# the port against the JAX package: exports render through either CLI, and
# one workload through both packages' engines reports the same


def _cli(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_jsonl_renders_the_same_through_both_clis(tmp_path, capsys):
    """A JSONL the JAX registry writes and one the port's writes (same
    metrics, spans and a trace tree) render identically through the
    port's CLI and the JAX package's: --json, --prom and --trace."""
    from burst_attn_tpu.obs.__main__ import main as jmain
    from burst_attn_tpu.obs.registry import Registry as JRegistry
    from burst_attn_tpu_torch.obs.__main__ import main as pmain

    trace_recs = [
        {"kind": "trace", "trace_id": "x-t1", "span_id": "request",
         "parent_id": None, "name": "serve.request", "start_s": 0.0,
         "duration_s": 2.0, "clock": "perf", "attrs": {"rid": 1}},
        {"kind": "trace", "trace_id": "x-t1", "span_id": "serve.prefill",
         "parent_id": "request", "name": "serve.prefill", "start_s": 0.25,
         "duration_s": 0.75, "clock": "perf", "attrs": {}},
        {"kind": "trace", "trace_id": "x-t1", "span_id": "serve.first_token",
         "parent_id": "request", "name": "serve.first_token",
         "start_s": 1.0, "duration_s": 0.0, "clock": "perf", "attrs": {}}]
    paths = {}
    for tag, reg in (("jax", JRegistry()), ("port", Registry())):
        reg.counter("serve.tokens_generated").inc(7)
        reg.counter("burst.dispatch").inc(2, path="fused", backend="auto",
                                          tile="pallas")
        reg.gauge("serve.queue_depth").set(3)
        h = reg.histogram("serve.ttft_s")
        for v in (0.004, 0.02, 3.0):
            h.observe(v)
        paths[tag] = str(tmp_path / f"{tag}.jsonl")
        reg.export_jsonl(paths[tag], extra_records=trace_recs,
                         process_index=0)
    for flags in (["--json"], ["--prom"], ["--trace"]):
        outs = {}
        for tag, path in paths.items():
            for cli, main in (("jax", jmain), ("port", pmain)):
                rc, out = _cli(main, flags + ["--file", path], capsys)
                assert rc == 0, (flags, tag, cli)
                outs[(tag, cli)] = out
        if flags == ["--json"]:  # the report names its file and time
            outs = {k: json.loads(v) for k, v in outs.items()}
            for v in outs.values():
                v.pop("source")
                v["meta"].pop("last_ts_utc")
        else:
            outs = {k: v.replace(paths[k[0]], "FILE")
                    for k, v in outs.items()}
        first = next(iter(outs.values()))
        assert all(v == first for v in outs.values()), flags
    rc, _ = _cli(pmain, ["--file", str(tmp_path / "none.jsonl")], capsys)
    assert rc == 1


@pytest.fixture(scope="module")
def engines():
    import jax
    import jax.numpy as jnp

    from burst_attn_tpu.models import ModelConfig as JModelConfig
    from burst_attn_tpu.models import init_params as j_init_params
    from burst_attn_tpu_torch.models.transformer import (
        ModelConfig, params_from_jax,
    )

    dims = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                d_head=16, d_ff=128)
    jcfg = JModelConfig(**dims, dtype=jnp.float32, attn_backend="jnp",
                        remat=False, batch_axis=None, head_axis=None)
    cfg = ModelConfig(**dims, dtype=torch.float32, batch_axis=None,
                      head_axis=None)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, params


SERVE_COUNTERS = (
    "serve.requests_submitted", "serve.requests_admitted",
    "serve.requests_retired", "serve.engine_steps", "serve.tokens_generated",
    "serve.ragged_batch_launches", "serve.ragged_batch_prefill_tokens",
    "serve.ragged_batch_decode_tokens", "burst.fused_fallback")
SERVE_HISTS = ("serve.ttft_s", "serve.token_latency_s", "span.serve.run")


def _engine_view(mod, tracing):
    """Counter children and histogram counts of the serve family in one
    package's default registry, plus its recorded trace trees' shapes."""
    counters = {(r["name"], tuple(sorted(r["labels"].items()))): r["value"]
                for r in mod.snapshot()
                if r["kind"] == "counter" and r["name"] in SERVE_COUNTERS}
    hists = {name: mod.histogram(name).get()["count"]
             for name in SERVE_HISTS}
    trees = {}
    for rec in tracing.trace_records():
        trees.setdefault(rec["trace_id"], []).append(
            (rec["name"], rec["span_id"], rec["parent_id"]))
    return counters, hists, sorted(sorted(t) for t in trees.values())


@pytest.mark.parametrize("kind", ["ragged", "serve"])
def test_engine_reports_match_jax(engines, kind):
    """One seeded workload (3 requests, 2 slots, tracing on) through the
    JAX package's engine and the port's: equal counter deltas (requests,
    steps, tokens, batch kinds), equal histogram counts (TTFT, token
    latency, the serve.run span), equal trace trees (span names and
    parents per request), and every TTFT breakdown sums to its TTFT."""
    from burst_attn_tpu import obs as jobs
    from burst_attn_tpu.models.serve import ServeEngine as JServeEngine
    from burst_attn_tpu.obs import trace as jtracing
    from burst_attn_tpu.serving import RaggedServeEngine as JRagged
    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.obs import trace as tracing
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    jcfg, jparams, cfg, params = engines
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 128, size=n, dtype=np.int32)
               for n in (40, 150, 9)]
    budgets = (3, 5, 2)
    kw = dict(slots=2, n_pages=12, page=128, max_pages_per_seq=3)
    if kind == "ragged":
        kw["chunk"] = 64
        jeng = JRagged(jparams, jcfg, use_ragged=False, **kw)
        eng = RaggedServeEngine(params, cfg, device="cpu", **kw)
    else:
        jeng = JServeEngine(jparams, jcfg, **kw)
        eng = ServeEngine(params, cfg, device="cpu", **kw)
    views = {}
    for tag, e, mod, tr in (("jax", jeng, jobs, jtracing),
                            ("port", eng, obs, tracing)):
        before = _engine_view(mod, tr)
        tr.reset_traces()
        tr.enable()
        try:
            for p, b in zip(prompts, budgets):
                e.submit(p, b)
            out = e.run()
            after = _engine_view(mod, tr)
        finally:
            tr.reset_traces()
        counters = {k: v - before[0].get(k, 0.0) for k, v in after[0].items()
                    if v != before[0].get(k, 0.0)}
        hists = {k: v - before[1][k] for k, v in after[1].items()}
        views[tag] = (counters, hists, after[2],
                      {r: list(map(int, t)) for r, t in out.items()})
        if tag == "port":
            for spans in after[2]:
                assert {n for n, _, _ in spans} >= {
                    "serve.queued", "serve.prefill", "serve.first_token",
                    "serve.decode", "serve.request"}
    assert views["port"][3] == views["jax"][3]     # the same tokens
    assert views["port"][0] == views["jax"][0]     # counters
    assert views["port"][1] == views["jax"][1]     # histogram counts
    assert views["port"][2] == views["jax"][2]     # trace trees
    assert views["port"][0][("serve.tokens_generated", ())] == sum(budgets)


def test_ttft_breakdown_sums_to_ttft_on_the_port_engine(engines):
    """The port engine's published breakdown: per request the phases of
    the critical path sum to the TTFT (within 1e-9 relative)."""
    from burst_attn_tpu_torch.obs import trace as tracing
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    _, _, cfg, params = engines
    eng = RaggedServeEngine(params, cfg, device="cpu", slots=2, n_pages=8,
                            page=128, max_pages_per_seq=2, chunk=32)
    tracing.reset_traces()
    tracing.enable()
    try:
        for n in (20, 70, 5):
            eng.submit(np.arange(1, n + 1, dtype=np.int32), 3)
        eng.run()
        recs = tracing.trace_records()
    finally:
        tracing.reset_traces()
    by = {}
    for rec in recs:
        by.setdefault(rec["trace_id"], []).append(rec)
    assert len(by) == 3
    for spans in by.values():
        bd = tracing.ttft_breakdown(spans)
        assert bd["ttft_s"] > 0
        total = sum(bd["phases"].values())
        assert abs(total - bd["ttft_s"]) <= 1e-9 * bd["ttft_s"], bd


@pytest.mark.parametrize("k", [1, 4])
def test_pipelined_engine_counts_like_the_synchronous_one(engines, k):
    """The pipelined engine accounts its ticks where the deferred readback
    lands: a K-tick run of one workload counts the synchronous run's
    serve.tokens_generated, serve.engine_steps and serve.requests_retired
    (on the card the K ticks are one graph replay; here they run
    eagerly)."""
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    _, _, cfg, params = engines
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 128, size=n, dtype=np.int32)
               for n in (30, 90, 7)]
    names = ("serve.tokens_generated", "serve.engine_steps",
             "serve.requests_retired{cause=budget}")
    seen = {}
    for extra in ({}, dict(pipeline=True, multi_step=k)):
        eng = RaggedServeEngine(params, cfg, device="cpu", slots=2,
                                n_pages=8, page=128, max_pages_per_seq=2,
                                chunk=32, **extra)
        for p in prompts:
            eng.submit(p, 9)
        out = eng.run()
        seen[bool(extra)] = (out, [eng.stats[n] for n in names])
    assert seen[True] == seen[False]
    assert seen[False][1][0] == 9 * len(prompts)
