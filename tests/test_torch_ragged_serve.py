"""Port parity for the ragged serving slice: the port's ragged_model_step,
prefix cache, copy-on-write barrier and RaggedServeEngine (CPU, plain
attention) against the JAX package's, on the same weights
(params_from_jax), f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu import obs
from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import paged_decode as jpd
from burst_attn_tpu.models.serve import ServeEngine as JServeEngine
from burst_attn_tpu.serving import RaggedServeEngine as JRaggedServeEngine
from burst_attn_tpu.serving import model as jsm
from burst_attn_tpu_torch.admission import LoadShed
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax,
)
from burst_attn_tpu_torch.serving import RaggedServeEngine, ragged_model_step
from burst_attn_tpu_torch.serving import model as sm

LOGITS_ATOL = 1e-4  # f32 model; matmul/summation order differs

DIMS = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=32, d_ff=256)


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(**DIMS, dtype=jnp.float32, attn_backend="jnp",
                        remat=False, batch_axis=None, head_axis=None)
    cfg = ModelConfig(**DIMS, dtype=torch.float32, batch_axis=None,
                      head_axis=None)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(1, DIMS["vocab"], size=n,
                                                dtype=np.int32)


@pytest.mark.parametrize("attn", ["ragged", "dense", "grouped"])
def test_ragged_model_step_logits_match_jax(model, attn):
    """Three ticks on the same tables through both packages: a mixed
    prefill tick, a tick where slot 2 resumes on slot 0's first page (as a
    prefix hit does), then a decode tick (grouped on slots 0 and 2 when
    attn is "grouped").  Logits and lengths agree."""
    jcfg, jparams, cfg, params = model
    kw = dict(slots=3, n_pages=10, page=128, max_pages_per_seq=3)
    jst, _ = jpd.init_paged_state(jcfg, **kw)
    st, _ = pd.init_paged_state(cfg, **kw, device="cpu")
    rows = {0: [1, 2], 1: [3, 4], 2: [1, 5]}   # slot 2 shares page 1
    for slot in (0, 1):
        jst = jsm.assign_pages(jst, slot, rows[slot])
        sm.assign_pages(st, slot, rows[slot])
    tmpl = _tokens(128, 1)
    grouped = {}
    if attn == "grouped":
        grouped = dict(group_id=np.asarray([1, 0, 1], np.int32),
                       shared_table=np.asarray([[0], [1], [0], [0]],
                                               np.int32),
                       shared_lens=np.asarray([0, 128, 0, 0], np.int32))
    step_attn = "ragged" if attn == "grouped" else attn

    def tick(toks, q_lens, a, extra=None):
        nonlocal jst
        extra = extra or {}
        jl, jst = jsm.ragged_model_step(
            jparams, jnp.asarray(toks), jnp.asarray(q_lens), jst, jcfg,
            attn=a, **{k: jnp.asarray(v) for k, v in extra.items()})
        lg, _ = ragged_model_step(
            params, torch.from_numpy(toks), torch.from_numpy(q_lens), st,
            cfg, attn=a, **{k: torch.from_numpy(v) for k, v in extra.items()})
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, rtol=0)

    toks = np.zeros((3, 128), np.int32)
    toks[0] = tmpl
    toks[1, :50] = _tokens(50, 2)
    tick(toks, np.asarray([128, 50, 0], np.int32), step_attn)
    # slot 2 resumes at 128 on the shared page (its row and length set
    # the way the engine's admission sets them)
    jst = jsm.assign_pages(jst, 2, rows[2])._replace(
        lengths=jst.lengths.at[2].set(128))
    sm.assign_pages(st, 2, rows[2])
    st.lengths[2] = 128
    toks = np.zeros((3, 16), np.int32)
    toks[:, 0] = [7, 9, 0]
    toks[2] = _tokens(16, 3)
    tick(toks, np.asarray([1, 1, 16], np.int32), step_attn)
    toks = np.asarray([[11], [12], [13]], np.int32)
    tick(toks, np.asarray([1, 1, 1], np.int32),
         "grouped" if attn == "grouped" else attn, grouped)
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(jst.lengths))
    np.testing.assert_array_equal(st.page_table.numpy(),
                                  np.asarray(jst.page_table))


def test_unassigned_page_poisons_logits(model):
    """A live slot stepped onto a table column that holds no page gets NaN
    logits in both packages; the other slot is unaffected."""
    jcfg, jparams, cfg, params = model
    kw = dict(slots=2, n_pages=6, page=128, max_pages_per_seq=2)
    jst, _ = jpd.init_paged_state(jcfg, **kw)
    st, _ = pd.init_paged_state(cfg, **kw, device="cpu")
    jst = jsm.assign_pages(jst, 1, [2])
    sm.assign_pages(st, 1, [2])
    toks = np.ones((2, 4), np.int32)
    q_lens = np.asarray([4, 4], np.int32)   # slot 0 owns no page
    jl, _ = jsm.ragged_model_step(jparams, jnp.asarray(toks),
                                  jnp.asarray(q_lens), jst, jcfg)
    lg, _ = ragged_model_step(params, torch.from_numpy(toks),
                              torch.from_numpy(q_lens), st, cfg)
    np.testing.assert_array_equal(torch.isnan(lg).any(-1).numpy(),
                                  np.isnan(np.asarray(jl)).any(-1))
    assert torch.isnan(lg[0]).all() and not torch.isnan(lg[1]).any()


def test_prefix_cache_transitions_match_jax():
    """The same call sequence on both packages' pool + cache gives the
    same page ids, refcounts, free lists, hits and evictions, with the
    pool dtype folded into the hash chain."""
    toks = _tokens(3 * 128 + 40, 4)
    other = toks.copy()
    other[200] = (other[200] % 200) + 1       # diverges in page 1
    log = {}
    for name, pool_cls, cache_cls in (
            ("jax", jpd.PagePool, jpd.PrefixCache),
            ("torch", pd.PagePool, pd.PrefixCache)):
        pool = pool_cls(10, dtype="int8")
        cache = cache_cls(pool)
        chain = cache_cls.chain(toks, 128, dtype=pool.dtype)
        assert chain != cache_cls.chain(toks, 128)  # dtype seeds the chain
        ids = pool.acquire(4)
        cache.insert(chain, ids[:3])
        pool.release(ids)                           # the sequence retires
        hits = cache.lookup(cache_cls.chain(other, 128, dtype=pool.dtype))
        steps = [list(hits), list(pool._refs), pool.available,
                 pool.in_use, pool.logical_refs, pool.has_shared,
                 cache.evictable()]
        steps.append(cache.evict(3))              # page 0 pinned by the hit
        pool.release(hits)
        steps += [cache.evict(3), len(cache), list(pool._refs),
                  list(pool._free), pool.in_use, pool.logical_refs]
        log[name] = steps
    assert log["torch"] == log["jax"]
    assert log["torch"][0] == [1]          # one-page hit, then divergence


def test_cow_pages_match_jax(model):
    """The copy-on-write barrier privatizes the shared boundary page the
    next tokens land in: the same copies, table and refcounts as JAX, and
    the copy carries the page's K/V AND its scales."""
    jcfg, _, cfg, _ = model
    kw = dict(slots=2, n_pages=8, page=128, max_pages_per_seq=3,
              quantize="int8")
    jst, jpool = jpd.init_paged_state(jcfg, **kw)
    st, pool = pd.init_paged_state(cfg, **kw, device="cpu")
    rng = np.random.default_rng(6)
    k = rng.integers(-127, 128, size=jst.k_pages[0].shape).astype(np.int8)
    s = rng.random(jst.k_scales[0].shape).astype(np.float32)
    jst = jst._replace(k_pages=(jnp.asarray(k),) + jst.k_pages[1:],
                       k_scales=(jnp.asarray(s),) + jst.k_scales[1:])
    st.k_pages[0].copy_(torch.from_numpy(k))
    st.k_scales[0].copy_(torch.from_numpy(s))
    for p, state, assign in ((jpool, jst, jsm.assign_pages),
                             (pool, st, sm.assign_pages)):
        ids = p.acquire(2)
        p.share([ids[1]])                  # a cache entry pins page 2
        state = assign(state, 0, ids)
        if p is jpool:
            jst = state._replace(lengths=state.lengths.at[0].set(200))
        else:
            st.lengths[0] = 200
    jst, jcopies = jsm.cow_pages(jst, jpool, 0, 10)
    _, copies = sm.cow_pages(st, pool, 0, 10)
    assert copies == jcopies == [(1, 2, 3)]
    assert pool._refs == jpool._refs and pool._free == jpool._free
    np.testing.assert_array_equal(st.page_table.numpy(),
                                  np.asarray(jst.page_table))
    assert torch.equal(st.k_pages[0][3], st.k_pages[0][2])
    assert torch.equal(st.k_scales[0][3], st.k_scales[0][2])
    np.testing.assert_array_equal(st.k_scales[0].numpy(),
                                  np.asarray(jst.k_scales[0]))


def _engine_prompts():
    rng = np.random.default_rng(0)
    tmpl = rng.integers(1, 256, size=256, dtype=np.int32)
    prompts = [rng.integers(1, 256, size=t, dtype=np.int32)
               for t in (9, 130, 40)]
    prompts += [np.concatenate([tmpl, rng.integers(1, 256, size=t,
                                                   dtype=np.int32)])
                for t in (0, 5, 70)]
    return prompts, [5, 4, 6, 3, 4, 5]


@pytest.mark.parametrize("kw", [{}, {"prefix_cache": True},
                                {"quantize": "int8"},
                                {"prefix_cache": True, "quantize": "fp8"}])
def test_engine_token_exact_with_jax_engine(model, kw):
    """A warm request registers a 256-token template, then six requests
    (three on the template, one of them the exact template) run through
    TWO slots with 64-token chunks: greedy streams identical to the JAX
    engine's, the prefix counters equal, every page back after evict."""
    jcfg, jparams, cfg, params = model
    prompts, budgets = _engine_prompts()
    common = dict(slots=2, n_pages=12, page=128, max_pages_per_seq=4,
                  chunk=64, **kw)
    names = ("serve.prefix_hits", "serve.cow_copies",
             "serve.prefill_tokens_skipped")
    before = [obs.counter(n).get() for n in names]
    jeng = JRaggedServeEngine(jparams, jcfg, use_ragged=False, **common)
    eng = RaggedServeEngine(params, cfg, device="cpu", **common)
    for e in (jeng, eng):
        e.submit(prompts[3], 2)
        e.run()
        for p, n in zip(prompts, budgets):
            e.submit(p, n)
    want = jeng.run()
    assert eng.run() == {rid: list(map(int, t)) for rid, t in want.items()}
    assert [eng.stats[n] for n in names] == [
        obs.counter(n).get() - b for n, b in zip(names, before)]
    if "prefix_cache" in kw:
        assert eng.stats["serve.prefix_hits"] == 3
        assert eng.stats["serve.grouped_launches"] > 0
        eng.cache.evict(100)
    assert eng.pool.in_use == 0 and eng.pool.logical_refs == 0


def test_drain_requeues_and_reserves(model):
    """drain() mid-flight returns every page and requeues in-flight work;
    a later run() re-serves it token-exact."""
    _, _, cfg, params = model
    prompts, budgets = _engine_prompts()
    kw = dict(slots=2, n_pages=12, max_pages_per_seq=4, chunk=64,
              device="cpu")
    ref = RaggedServeEngine(params, cfg, **kw)
    eng = RaggedServeEngine(params, cfg, **kw)
    for e in (ref, eng):
        for p, n in zip(prompts[:3], budgets):
            e.submit(p, n)
    want = ref.run()
    for _ in range(3):
        eng.step()
    assert eng.live == 2 and eng.pool.available < 11
    assert eng.drain() == [0, 1]
    assert eng.live == 0 and eng.pool.available == 11 and eng.pending == 3
    assert eng.run() == want


def test_shed_order_pool_before_queue(model):
    """With max_queue, pool pressure sheds before queue pressure."""
    _, _, cfg, params = model
    eng = RaggedServeEngine(params, cfg, slots=1, n_pages=4,
                            max_pages_per_seq=8, chunk=4, max_queue=2,
                            device="cpu")
    with pytest.raises(ValueError):
        eng.submit([], 5)
    eng.submit(np.ones(200, np.int32), 100)    # 3 pages = the whole pool
    eng.step()
    assert eng.pool.available == 0
    eng.submit(np.ones(4, np.int32), 4)        # empty queue: may wait
    res = eng.try_submit(np.ones(4, np.int32), 4)
    assert res.rid is None and res.reason.value == "pool-exhausted"
    eng2 = RaggedServeEngine(params, cfg, slots=1, n_pages=40,
                             max_pages_per_seq=8, chunk=4, max_queue=1,
                             device="cpu")
    eng2.submit(np.ones(4, np.int32), 4)
    eng2.step()
    eng2.submit(np.ones(4, np.int32), 4)
    with pytest.raises(LoadShed, match="queue-full"):
        eng2.submit(np.ones(4, np.int32), 4)


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_serve_engine_quantized_matches_jax(model, quant):
    """ServeEngine(quantize=...) now runs: a 1-byte pool through the paged
    prefill scatter and the quantized decode step gives the JAX engine's
    tokens."""
    jcfg, jparams, cfg, params = model
    prompts, budgets = _engine_prompts()
    kw = dict(slots=2, n_pages=12, page=128, max_pages_per_seq=4,
              quantize=quant)
    jeng = JServeEngine(jparams, jcfg, **kw)
    eng = ServeEngine(params, cfg, **kw, device="cpu")
    for p, n in zip((prompts[0], prompts[2]), budgets):
        assert jeng.submit(p, n) == eng.submit(p, n)
    want = jeng.run()
    assert eng.run() == {rid: list(map(int, t)) for rid, t in want.items()}
    assert eng.state.k_pages[0].dtype == pd.QUANT_DTYPES[quant][0]


def test_unported_options_raise(model):
    """Both engines take a journal (ported: they keep it as `journal`;
    tests/test_torch_checkpoint.py drives it); a draft model is validated
    as the JAX engines validate it (ValueError for a draft without its
    config, sampling, a vocabulary mismatch, spec_k < 1); multi_step > 1
    without pipeline is a ValueError, as in JAX; the pipelined engine and
    the ServeEngine prefix cache construct."""
    jcfg, jparams, cfg, params = model
    kw = dict(slots=1, n_pages=4, device="cpu")
    journal = object()
    for eng_cls in (RaggedServeEngine, ServeEngine):
        assert eng_cls(params, cfg, **kw, journal=journal).journal is journal
    other = dict(DIMS, vocab=DIMS["vocab"] + 1)
    bad_drafts = (
        ({}, dict(draft_params=params), "needs draft_cfg"),
        ({}, dict(draft_params=params, draft_cfg=cfg, temperature=0.5),
         "temperature == 0"),
        (other, dict(draft_params=params), "share a vocabulary"),
        ({}, dict(draft_params=params, draft_cfg=cfg, spec_k=0),
         "spec_k must be >= 1"))
    for dims, bad, msg in bad_drafts:
        if dims:
            bad = dict(bad, draft_cfg=ModelConfig(
                **dims, dtype=torch.float32, batch_axis=None,
                head_axis=None))
        jbad = dict(bad, draft_params=jparams)
        if "draft_cfg" in bad:
            jbad["draft_cfg"] = JModelConfig(
                **(dims or DIMS), dtype=jnp.float32, attn_backend="jnp",
                remat=False, batch_axis=None, head_axis=None)
        for eng_cls, jeng_cls in ((RaggedServeEngine, JRaggedServeEngine),
                                  (ServeEngine, JServeEngine)):
            with pytest.raises(ValueError, match=msg):
                eng_cls(params, cfg, **kw, **bad)
            with pytest.raises(ValueError, match=msg):
                jeng_cls(jparams, jcfg, slots=1, n_pages=4, **jbad)
    for bad in (dict(multi_step=0), dict(multi_step=2),
                dict(pipeline=True, multi_step=0)):
        with pytest.raises(ValueError):
            RaggedServeEngine(params, cfg, **kw, **bad)
    assert RaggedServeEngine(params, cfg, **kw, pipeline=True,
                             multi_step=2).pipeline
    assert ServeEngine(params, cfg, **kw, prefix_cache=True).cache is not None
    with pytest.raises(ValueError, match="quantize"):
        pd.init_paged_state(cfg, slots=1, n_pages=2, quantize="int4",
                            device="cpu")
