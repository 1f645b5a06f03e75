"""The port's loadgen (burst_attn_tpu_torch.loadgen) held to the JAX
package's: traces byte-identical for the same seed, the single-process
oracle's tokens equal to JAX's on both engine kinds (weights carried by
`params_from_jax`), the open-loop replay token-exact against the oracle
with poison rejected for JAX's reasons, the SLO math equal on the same
export records, and the CLI's gen / replay / slo."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu import loadgen as jlg
from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import ServeEngine as JServeEngine
from burst_attn_tpu.models import init_params as jinit
from burst_attn_tpu.serving import RaggedServeEngine as JRagged
from burst_attn_tpu_torch import obs
from burst_attn_tpu_torch.loadgen import (
    Objectives, RetryBackoff, assert_token_exact, compute_slo, evaluate,
    load_trace, oracle_replay, recovery_stats, replay_trace, save_trace,
    synthesize_trace,
)
from burst_attn_tpu_torch.loadgen import slo as pslo
from burst_attn_tpu_torch.loadgen import trace as ptrace
from burst_attn_tpu_torch.loadgen.worker import build_engine
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax,
)
from burst_attn_tpu_torch.obs.aggregate import merge_files
from burst_attn_tpu_torch.serving import RaggedServeEngine

DIMS = dict(vocab=97, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
            d_head=16, d_ff=64)
MODEL_SPEC = dict(DIMS, seed=0, device="cpu")
ENGINE_SPEC = dict(kind="ragged", slots=2, n_pages=4, page=128,
                   max_pages_per_seq=2, chunk=8, max_queue=8)
ENGINES = {"ragged": (JRagged, RaggedServeEngine, dict(chunk=8)),
           "legacy": (JServeEngine, ServeEngine, {})}


@pytest.mark.parametrize("kind", ["bursty", "diurnal", "heavy_tail"])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_traces_byte_identical_to_jax(tmp_path, kind, seed):
    kw = {"bursty": dict(poison_rate=0.2, shared_fraction=0.3,
                         oversize_len=9999),
          "diurnal": dict(priority_fraction=0.2, period_s=30.0),
          "heavy_tail": dict(n_tenants=8, priority_tenants=2)}[kind]
    fn = {"bursty": "synthesize_trace", "diurnal": "synthesize_diurnal_trace",
          "heavy_tail": "synthesize_heavy_tail_trace"}[kind]
    tj = getattr(jlg.trace, fn)(24, seed=seed, vocab=97, **kw)
    tp_ = getattr(ptrace, fn)(24, seed=seed, vocab=97, **kw)
    jlg.save_trace(tj, str(tmp_path / "j.jsonl"))
    save_trace(tp_, str(tmp_path / "p.jsonl"))
    assert (tmp_path / "p.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    back = load_trace(str(tmp_path / "j.jsonl"))
    for a, b in zip(back.requests, tj.requests):
        assert np.array_equal(a.prompt(97), b.prompt(97))
    bo_j, bo_p = jlg.RetryBackoff(seed=seed), RetryBackoff(seed=seed)
    assert [bo_p.delay(r, a) for r in range(3) for a in (1, 2, 5)] == \
        [bo_j.delay(r, a) for r in range(3) for a in (1, 2, 5)]


def _engine_pair(kind, **extra):
    """(JAX engine factory, port engine factory) on the same weights: the
    JAX model's init, carried by params_from_jax."""
    jcfg = JModelConfig(attn_backend="jnp", remat=False, dtype=jnp.float32,
                        batch_axis=None, head_axis=None, **DIMS)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    pcfg = ModelConfig(remat=False, dtype=torch.float32, batch_axis=None,
                       head_axis=None, **DIMS)
    pparams = params_from_jax(jparams, device="cpu")
    jcls, pcls, kw = ENGINES[kind]
    es = dict(slots=2, n_pages=4, page=128, max_pages_per_seq=2, **kw,
              **extra)
    return (lambda: jcls(jparams, jcfg, **es),
            lambda: pcls(pparams, pcfg, device="cpu", **es))


@pytest.mark.parametrize("kind", ["ragged", "legacy"])
def test_oracle_replay_tokens_equal_jax(kind):
    trace = synthesize_trace(8, seed=5, vocab=97, poison_rate=0.25,
                             prompt_len_max=40, max_new_max=8,
                             oversize_len=9999)
    assert any(r.poison for r in trace.requests)
    mk_j, mk_p = _engine_pair(kind)
    want = jlg.oracle_replay(trace, mk_j)
    got = oracle_replay(trace, mk_p)
    assert got == want and len(got) == len(trace.normal())


def test_replay_token_exact_poison_reasons_and_slo_equal_jax(tmp_path):
    """Open-loop replay on a tight engine (2 slots, 3 usable pages,
    max_queue, an admission policy): sheds and retries happen, poison is
    rejected with the JAX replay's reasons, every completed request
    matches the oracle, and both packages' SLO math reads the same
    numbers from the replay's obs export."""
    trace = synthesize_trace(
        10, seed=7, vocab=97, poison_rate=0.25, mean_interarrival_s=0.01,
        prompt_len_max=40, max_new_max=8, oversize_len=9999)
    adm = {"pool_high": 0.99, "pool_low": 0.5, "queue_high": 6,
           "queue_low": 2}
    mk_j, mk_p = _engine_pair("ragged", max_queue=8)
    from burst_attn_tpu.admission import AdmissionPolicy as JAdm
    from burst_attn_tpu_torch.admission import AdmissionPolicy

    jeng = mk_j()
    jeng.admission = JAdm(**adm)
    peng = mk_p()
    peng.admission = AdmissionPolicy(**adm)
    before = obs.counter_values()
    rj = jlg.replay_trace(jeng, trace, speed=100.0, retry_backoff_s=1.0,
                          max_retries=2000)
    rp = replay_trace(peng, trace, speed=100.0, retry_backoff_s=1.0,
                      max_retries=2000)
    delta = obs.counter_deltas(before)
    assert rp.n_done == len(trace.normal())
    assert {o.rid: o.reason for o in rp.by_status("rejected")} == \
        {o.rid: o.reason for o in rj.by_status("rejected")}
    assert rp.n_rejected == sum(r.poison for r in trace.requests)
    assert_token_exact(rp.completed(), oracle_replay(trace, mk_p))
    assert rp.completed() == rj.completed()
    assert delta["serve.requests_submitted"] >= rp.n_done
    # the SLO math: the port's export through both packages' merge and
    # compute_slo / evaluate gives the same report
    path = str(tmp_path / "obs.jsonl")
    obs.default_registry().export_jsonl(path, process_index=0)
    from burst_attn_tpu.obs.aggregate import merge_files as jmerge

    mp_, mj = merge_files([path])[0], jmerge([path])[0]
    kw = dict(duration_s=rp.duration_v, completed_tokens=rp.completed_tokens,
              n_done=rp.n_done, n_rejected=rp.n_rejected,
              recovery_s=[0.5, 0.1, 2.0])
    sp, sj = compute_slo(mp_, **kw), jlg.compute_slo(mj, **kw)
    assert sp == sj and sp["ttft_count"] > 0
    objs = dict(max_ttft_p99_s=1e-9, min_goodput_tokens_per_s=1e9,
                max_shed_rate=0.0, max_token_p99_s=10.0)
    assert evaluate(sp, Objectives(**objs)) == \
        jlg.evaluate(sj, jlg.Objectives(**objs))
    assert pslo.format_slo(sp) == jlg.format_slo(sj)
    assert recovery_stats([3.0, 1.0]) == jlg.recovery_stats([3.0, 1.0])
    assert pslo.SHED_REASONS == jlg.slo.SHED_REASONS


def test_build_engine_from_specs_runs_the_trace():
    """The worker's spec path (numpy seed init, fp32, the CPU only when
    the spec says so) serves a trace token-exact against its oracle."""
    trace = synthesize_trace(6, seed=2, vocab=97, prompt_len_max=30,
                             max_new_max=6)
    eng = build_engine(MODEL_SPEC, ENGINE_SPEC)
    assert eng.device.type == "cpu" and eng.cfg.dtype == torch.float32
    rep = replay_trace(eng, trace, speed=100.0)
    oracle = oracle_replay(trace, lambda: build_engine(
        MODEL_SPEC, dict(ENGINE_SPEC, max_queue=None)))
    assert_token_exact(rep.completed(), oracle)
    with pytest.raises(ValueError, match="dtype"):
        build_engine(dict(MODEL_SPEC, dtype="float16"), ENGINE_SPEC)


def test_weights_file_gives_the_seeded_model(tmp_path):
    """A `save_weights` file in the spec loads the seed's weights (cast
    to the spec's dtype): the same parameters as the init, bit for bit."""
    from burst_attn_tpu_torch.loadgen.worker import (
        model_from_spec, save_weights,
    )
    from burst_attn_tpu_torch.models.transformer import param_leaves

    p32, cfg, _ = model_from_spec(MODEL_SPEC)
    path = save_weights(p32, str(tmp_path / "w.pt"))
    for dtype in ("float32", "bfloat16"):
        want, _, _ = model_from_spec(dict(MODEL_SPEC, dtype=dtype))
        got, _, _ = model_from_spec(dict(MODEL_SPEC, dtype=dtype,
                                         weights=path))
        for a, b in zip(param_leaves(got), param_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="do not fit"):
        model_from_spec(dict(MODEL_SPEC, n_layers=2, weights=path))


def test_cli_gen_replay_slo(tmp_path, capsys):
    from burst_attn_tpu_torch.loadgen.__main__ import main

    out = str(tmp_path / "traces" / "cli.jsonl")
    assert main(["gen", "--out", out, "--n", "5", "--seed", "3",
                 "--poison-rate", "0.2", "--prompt-len-max", "24",
                 "--max-new-max", "4"]) == 0
    assert "wrote 5 requests" in capsys.readouterr().out
    from burst_attn_tpu.loadgen.__main__ import main as jmain

    jout = str(tmp_path / "traces" / "jax.jsonl")
    jmain(["gen", "--out", jout, "--n", "5", "--seed", "3",
           "--poison-rate", "0.2", "--prompt-len-max", "24",
           "--max-new-max", "4"])
    assert open(out, "rb").read() == open(jout, "rb").read()
    capsys.readouterr()
    assert main(["replay", "--trace", out, "--device", "cpu",
                 "--speed", "50", "--out-dir", str(tmp_path / "lg")]) == 0
    assert "token-exact" in capsys.readouterr().out
    path = str(tmp_path / "obs.jsonl")
    obs.default_registry().export_jsonl(path, process_index=0)
    assert main(["slo", "--obs", path, "--duration-s", "1.0",
                 "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["duration_s"] == 1.0 and report["tokens_generated"] > 0
