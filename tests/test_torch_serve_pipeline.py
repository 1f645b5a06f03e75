"""Port parity for the pipelined RaggedServeEngine (pipeline=True,
multi_step=K) and its two launches, pipelined_tick and multi_step_decode
(CPU, plain attention), on the same weights as the JAX package
(params_from_jax), f32.  Pipelining changes when work is dispatched and
read back, never what is computed: every stream must equal the port's
synchronous engine token for token, greedy and sampled, and the JAX
pipelined engine's where the draws are not random (greedy, int8, fp8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import paged_decode as jpd
from burst_attn_tpu.serving import RaggedServeEngine as JRaggedServeEngine
from burst_attn_tpu.serving import model as jsm
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models.decode import (
    generate, sample_logits, skip_draws,
)
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax,
)
from burst_attn_tpu_torch.serving import (
    RaggedServeEngine, multi_step_decode, pipelined_tick, ragged_model_step,
)
from burst_attn_tpu_torch.serving import model as sm

DIMS = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=32, d_ff=256)
ENGINE = dict(slots=2, n_pages=10, page=128, max_pages_per_seq=4, chunk=4)


@pytest.fixture(scope="module")
def setup():
    jcfg = JModelConfig(**DIMS, dtype=jnp.float32, attn_backend="jnp",
                        remat=False, batch_axis=None, head_axis=None)
    cfg = ModelConfig(**DIMS, dtype=torch.float32, batch_axis=None,
                      head_axis=None)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, DIMS["vocab"], size=n, dtype=np.int32)
               for n in (9, 5, 13, 3)]
    steps = [5, 4, 6, 3]
    refs = [generate(params, torch.from_numpy(p)[None].long(), cfg,
                     steps=s, max_seq=256)[0].tolist()
            for p, s in zip(prompts, steps)]
    return jcfg, jparams, cfg, params, prompts, steps, refs


def _serve(cfg, params, prompts, steps, seed=None, **kw):
    if seed is not None:
        kw["rng"] = torch.Generator().manual_seed(seed)
    eng = RaggedServeEngine(params, cfg, device="cpu", **ENGINE, **kw)
    rids = [eng.submit(p, s) for p, s in zip(prompts, steps)]
    res = eng.run()
    return [res[r] for r in rids], eng


def _stat(eng, name):
    return sum(v for k, v in eng.stats.items() if k.startswith(name))


MATRIX = [
    ("greedy-k1", dict(), 1),
    ("greedy-k4", dict(), 4),
    ("sampled-k1", dict(temperature=0.8), 1),
    ("sampled-k4", dict(temperature=0.8), 4),
    ("sampled-topk-k4", dict(temperature=0.7, top_k=8), 4),
    ("int8-k4", dict(quantize="int8"), 4),
    ("fp8-k4", dict(quantize="fp8"), 4),
]


@pytest.mark.parametrize("name,kw,ms", MATRIX, ids=[m[0] for m in MATRIX])
def test_pipelined_parity_matrix(setup, name, kw, ms):
    """Four requests over two slots, so admissions and retirements
    interleave with launches in flight: the pipelined streams equal the
    synchronous engine's (sampled: from the same generator seed), and the
    JAX pipelined engine's where the draws are not random."""
    jcfg, jparams, cfg, params, prompts, steps, _ = setup
    seed = 7 if "temperature" in kw else None
    base, _ = _serve(cfg, params, prompts, steps, seed=seed, **kw)
    piped, eng = _serve(cfg, params, prompts, steps, seed=seed,
                        pipeline=True, multi_step=ms, **kw)
    assert piped == base, name
    assert eng._pending is None and eng.live == 0
    assert eng.pool.available == ENGINE["n_pages"] - 1
    assert _stat(eng, "serve.ragged_batch_launches") > 0
    if ms > 1:
        assert eng.stats[f"serve.multi_step_launches{{k={ms}}}"] > 0
    if seed is None:
        jeng = JRaggedServeEngine(jparams, jcfg, use_ragged=False,
                                  pipeline=True, multi_step=ms, **ENGINE,
                                  **kw)
        rids = [jeng.submit(p, s) for p, s in zip(prompts, steps)]
        want = jeng.run()
        assert piped == [list(map(int, want[r])) for r in rids], name


def test_pipelined_greedy_matches_generate(setup):
    """Exact against single-stream generate(), not only the synchronous
    engine (a bug the two engines share would pass the matrix)."""
    _, _, cfg, params, prompts, steps, refs = setup
    piped, _ = _serve(cfg, params, prompts, steps, pipeline=True,
                      multi_step=4)
    assert piped == refs


@pytest.mark.parametrize("sampled,ms", [(False, 4), (True, 4), (True, 1)],
                         ids=["greedy-k4", "sampled-k4", "sampled-k1"])
def test_pipelined_eos_truncation_and_reconcile(setup, sampled, ms):
    """An EOS inside a fused launch: the readback cuts the launch at the
    EOS tick (lengths and generator rolled back) and discards the launch
    speculated on top of it; at K=1 the EOS retires a stream the
    speculative launch assumed live, which is discarded with its draws.
    The streams still equal the synchronous engine's."""
    _, _, cfg, params, prompts, steps, refs = setup
    kw = dict(temperature=0.8) if sampled else {}
    seed = 3 if sampled else None
    if sampled:
        first, _ = _serve(cfg, params, prompts, steps, seed=seed, **kw)
        eos = int(first[0][1])
    else:
        eos = int(refs[0][0])  # early for request 0, mid-stream for 2
    base, _ = _serve(cfg, params, prompts, steps, seed=seed, eos_id=eos,
                     **kw)
    piped, eng = _serve(cfg, params, prompts, steps, seed=seed, eos_id=eos,
                        pipeline=True, multi_step=ms, **kw)
    assert piped == base
    assert any(eos in t for t in piped)
    assert _stat(eng, "serve.pipeline_reconciles") > 0
    assert eng.pool.available == ENGINE["n_pages"] - 1


def test_pipelined_drain_quiesces(setup):
    """drain() mid-flight flushes the in-flight launch, requeues live
    work and returns every page; the engine then serves everything
    exactly."""
    _, _, cfg, params, prompts, steps, refs = setup
    eng = RaggedServeEngine(params, cfg, device="cpu", pipeline=True,
                            multi_step=4, **ENGINE)
    rids = [eng.submit(p, s) for p, s in zip(prompts, steps)]
    for _ in range(4):
        eng.step()
    assert eng._pending is not None  # genuinely mid-flight
    eng.drain()
    assert eng._pending is None and eng.live == 0
    assert eng.pool.available == ENGINE["n_pages"] - 1
    assert not eng._lengths.any() and not eng._table.any()
    res = eng.run()
    assert [res[r] for r in rids] == refs


def test_pipelined_prefix_cache_parity(setup):
    """A shared-template workload with the prefix cache on: pipelined and
    synchronous cached engines equal an uncached one, through CoW
    barriers, grouped launches and registrations at deferred readback
    (table rows captured at dispatch); the cache then evicts clean."""
    _, _, cfg, params, _, _, _ = setup
    rng = np.random.default_rng(5)
    tmpl = rng.integers(1, DIMS["vocab"], 128, dtype=np.int32)
    prompts = [np.concatenate([tmpl, rng.integers(1, DIMS["vocab"], n,
                                                  dtype=np.int32)])
               for n in (3, 7)] + [tmpl]  # the last: a full-prompt hit
    kw = dict(ENGINE, max_pages_per_seq=2, chunk=64)

    def serve(**extra):
        eng = RaggedServeEngine(params, cfg, device="cpu", **kw, **extra)
        rids = [eng.submit(p, 5) for p in prompts]
        res = eng.run()
        return [res[r] for r in rids], eng

    oracle, _ = serve()
    base, _ = serve(prefix_cache=True)
    piped, eng = serve(prefix_cache=True, pipeline=True, multi_step=4)
    assert base == oracle and piped == oracle
    assert eng.stats["serve.prefix_hits"] > 0
    eng.cache.evict(eng.pool.n_pages)
    assert eng.pool.in_use == 0 and eng.pool.logical_refs == 0


def test_multi_step_requires_pipeline(setup):
    _, _, cfg, params, _, _, _ = setup
    for bad in (dict(multi_step=4), dict(pipeline=True, multi_step=0)):
        with pytest.raises(ValueError):
            RaggedServeEngine(params, cfg, device="cpu", **ENGINE, **bad)


def _decoding_states(jcfg, cfg):
    """Both packages' paged states with slot 0 prefilled by 9 tokens and
    slot 1 by 5 (slot 2 idle), through ragged_model_step."""
    kw = dict(slots=3, n_pages=8, page=128, max_pages_per_seq=2)
    jst, _ = jpd.init_paged_state(jcfg, **kw)
    st, _ = pd.init_paged_state(cfg, **kw, device="cpu")
    for slot, row in ((0, [1, 2]), (1, [3, 4])):
        jst = jsm.assign_pages(jst, slot, row)
        sm.assign_pages(st, slot, row)
    toks = np.random.default_rng(2).integers(1, DIMS["vocab"], (3, 9),
                                             dtype=np.int32)
    q_lens = np.asarray([9, 5, 0], np.int32)
    return jst, st, toks, q_lens


def test_multi_step_decode_matches_ticks_and_jax(setup):
    """multi_step_decode's K ticks: greedy choices and lengths equal JAX's
    lax.scan launch on the same state; sampled choices and the generator
    state after them equal K pipelined_ticks from the same state."""
    jcfg, jparams, cfg, params, _, _, _ = setup
    jst, st, toks, q_lens = _decoding_states(jcfg, cfg)
    jl, jst = jsm.ragged_model_step(jparams, jnp.asarray(toks),
                                    jnp.asarray(q_lens), jst, jcfg,
                                    attn="dense")
    lg, _ = ragged_model_step(params, torch.from_numpy(toks),
                              torch.from_numpy(q_lens), st, cfg)
    first = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert (lg.argmax(-1).numpy() == first).all()
    live = np.asarray([1, 1, 0], np.int32)
    jch, jst, _ = jsm.multi_step_decode(
        jparams, jnp.asarray(first), jnp.asarray(live), jst,
        jax.random.PRNGKey(0), jcfg, k=3, attn="dense")
    lengths = st.lengths.clone()
    ch, _, _ = multi_step_decode(params, torch.from_numpy(first),
                                 torch.from_numpy(live), st, None, cfg, k=3)
    live_rows = live.astype(bool)
    np.testing.assert_array_equal(ch.numpy()[:, live_rows],
                                  np.asarray(jch)[:, live_rows])
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(jst.lengths))

    # sampled: the fused launch against 3 ticks from the same state (the
    # extra K/V the first run scattered past the rolled-back lengths is
    # overwritten before it is read)
    st.lengths.copy_(lengths)
    sampling = dict(temperature=0.8, top_k=16)
    gen = torch.Generator().manual_seed(1)
    ch, _, _ = multi_step_decode(params, torch.from_numpy(first),
                                 torch.from_numpy(live), st, gen, cfg, k=3,
                                 **sampling)
    after = gen.get_state()
    st.lengths.copy_(lengths)
    gen = torch.Generator().manual_seed(1)
    feed, rows = torch.from_numpy(first).long(), []
    for _ in range(3):
        feed, _ = pipelined_tick(params, feed[:, None],
                                 torch.from_numpy(live), st, gen, cfg,
                                 **sampling)
        rows.append(feed)
    assert torch.equal(ch, torch.stack(rows))
    assert torch.equal(gen.get_state(), after)


def test_skip_draws_matches_sampling():
    """skip_draws leaves the generator where the same number of sampled
    draws leaves it (the truncation's rewind)."""
    logits = torch.randn(3, DIMS["vocab"])
    a = torch.Generator().manual_seed(4)
    b = torch.Generator().manual_seed(4)
    for _ in range(2):
        sample_logits(logits, a, temperature=0.9, top_p=0.8)
    skip_draws(b, tuple(logits.shape), 2, "cpu")
    assert torch.equal(a.get_state(), b.get_state())
    assert torch.equal(sample_logits(logits, a, temperature=0.9),
                       sample_logits(logits, b, temperature=0.9))
