"""Port parity for the serving slice: the port's paged prefill/decode and
ServeEngine (CPU, plain attention) against the JAX package's, on the same
weights (params_from_jax), f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import paged_decode as jpd
from burst_attn_tpu.models.serve import ServeEngine as JServeEngine
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models.decode import sample_logits
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, forward, init_params, params_from_jax,
)

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


def _prompts(lengths, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, DIMS["vocab"], size=t, dtype=np.int32)
            for t in lengths]


def test_params_from_jax_roundtrip(model):
    _, jparams, cfg, params = model
    jleaves, jdef = jax.tree_util.tree_flatten(jparams)
    leaves, tdef = jax.tree_util.tree_flatten(params)
    assert jdef == tdef
    for a, b in zip(jleaves, leaves):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the port's own init has the same names and shapes
    own = init_params(cfg, seed=0, device="cpu")
    assert jax.tree_util.tree_structure(own) == tdef
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(own)] == \
        [tuple(x.shape) for x in leaves]


def test_paged_prefill_and_decode_logits_match_jax(model):
    jcfg, jparams, cfg, params = model
    p0, p1 = _prompts([150, 40])
    jst, jpool = jpd.init_paged_state(jcfg, slots=2, n_pages=8, page=128,
                                      max_pages_per_seq=3)
    st, pool = pd.init_paged_state(cfg, slots=2, n_pages=8, page=128,
                                   max_pages_per_seq=3, device="cpu")
    toks = []
    for slot, p in enumerate((p0, p1)):
        jl, jst = jpd.paged_prefill(jparams, jnp.asarray(p), jst, jpool,
                                    slot, jcfg)
        lg, st = pd.paged_prefill(params, p, st, pool, slot, cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, rtol=0)
        jst = jpd.provision_capacity(jst, jpool, slot, 4)
        st = pd.provision_capacity(st, pool, slot, 4)
        toks.append(int(np.argmax(np.asarray(jl))))
    np.testing.assert_array_equal(st.page_table.numpy(),
                                  np.asarray(jst.page_table))
    tok = np.asarray(toks, np.int32)
    for _ in range(3):
        jl, jst = jpd.paged_decode_step(jparams, jnp.asarray(tok), jst, jcfg)
        lg, st = pd.paged_decode_step(params, torch.from_numpy(tok), st, cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, rtol=0)
        tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(jst.lengths))


def test_engine_token_exact_with_jax_engine(model):
    """Three mixed-length requests through TWO slots (staggered admission
    and slot reuse): greedy output identical to the JAX ServeEngine's, and
    every page back in the pool."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts([9, 130, 40], seed=21)
    budgets = [5, 4, 6]
    kw = dict(slots=2, n_pages=10, page=128, max_pages_per_seq=3)
    jeng = JServeEngine(jparams, jcfg, **kw)
    eng = ServeEngine(params, cfg, **kw, device="cpu")
    for p, n in zip(prompts, budgets):
        assert jeng.submit(p, n) == eng.submit(p, n)
    want = jeng.run()
    got = eng.run()
    assert got == {rid: list(map(int, t)) for rid, t in want.items()}
    assert eng.pool.available == 9


def test_engine_matches_dense_forward(model):
    """Teacher-forced check against the port's own dense plain forward:
    each generated token is the argmax at its position."""
    _, _, cfg, params = model
    (p,) = _prompts([70], seed=31)
    eng = ServeEngine(params, cfg, slots=1, n_pages=4, max_pages_per_seq=2,
                      device="cpu")
    rid = eng.submit(p, 6)
    out = eng.run()[rid]
    full = torch.from_numpy(np.concatenate([p, out[:-1]]).astype(np.int64))
    logits = forward(params, full[None], torch.arange(full.numel())[None],
                     cfg)
    pred = logits[0, len(p) - 1:].argmax(-1).tolist()
    assert pred == out


def test_sink_page_poison(model):
    """A live slot stepped across a page boundary without capacity gets NaN
    logits (as in JAX), and sample_logits(nan_sentinel=True) maps them to
    -1 while the other slot samples normally."""
    jcfg, jparams, cfg, params = model
    p0, p1 = _prompts([128, 20], seed=41)  # slot 0 fills its page exactly
    jst, jpool = jpd.init_paged_state(jcfg, slots=2, n_pages=6, page=128,
                                      max_pages_per_seq=2)
    st, pool = pd.init_paged_state(cfg, slots=2, n_pages=6, page=128,
                                   max_pages_per_seq=2, device="cpu")
    for slot, p in enumerate((p0, p1)):
        _, jst = jpd.paged_prefill(jparams, jnp.asarray(p), jst, jpool, slot,
                                   jcfg)
        _, st = pd.paged_prefill(params, p, st, pool, slot, cfg)
    tok = np.asarray([3, 4], np.int32)
    jl, _ = jpd.paged_decode_step(jparams, jnp.asarray(tok), jst, jcfg)
    lg, _ = pd.paged_decode_step(params, torch.from_numpy(tok), st, cfg)
    np.testing.assert_array_equal(torch.isnan(lg).any(-1).numpy(),
                                  np.isnan(np.asarray(jl)).any(-1))
    assert torch.isnan(lg[0]).all() and not torch.isnan(lg[1]).any()
    assert sample_logits(lg, nan_sentinel=True).tolist()[0] == -1
    assert sample_logits(lg, nan_sentinel=True).tolist()[1] >= 0
    # the engine never gets there: it provisions a whole lifetime
    eng = ServeEngine(params, cfg, slots=1, n_pages=4, max_pages_per_seq=2,
                      device="cpu")
    rid = eng.submit(p0, 3)
    assert len(eng.run()[rid]) == 3


def test_pool_drain_and_reserve(model):
    """drain() mid-flight returns every page and requeues in-flight work;
    a later run() re-serves it token-exact."""
    _, _, cfg, params = model
    prompts = _prompts([9, 130, 40], seed=51)
    kw = dict(slots=2, n_pages=10, page=128, max_pages_per_seq=3,
              device="cpu")
    ref = ServeEngine(params, cfg, **kw)
    eng = ServeEngine(params, cfg, **kw)
    for p in prompts:
        ref.submit(p, 5)
        eng.submit(p, 5)
    want = ref.run()
    eng.step()
    eng.step()
    assert eng.live == 2 and eng.pool.available < 9
    assert eng.drain() == [0, 1]
    assert eng.live == 0 and eng.pool.available == 9
    assert eng.pending == 3
    assert eng.run() == want
    assert eng.pool.available == 9


def test_page_pool_refcounts():
    pool = pd.PagePool(5)
    a = pool.acquire(2)
    assert a == [1, 2] and pool.available == 2
    pool.share([a[0]])
    pool.release(a)
    assert pool.available == 3 and pool.refcount(a[0]) == 1
    with pytest.raises(ValueError):
        pool.release([a[1]])  # already free
    with pytest.raises(RuntimeError):
        pool.acquire(4)
    pool.release([a[0]])
    assert pool.available == 4 and pool.refcount(a[0]) == 0


def test_sample_logits_distribution():
    """Sampled paths are held by distribution (torch.Generator and
    jax.random draw different bits): top-k/top-p keep the same set as the
    JAX rule and frequencies follow the renormalized softmax."""
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -1.0, -2.0, -3.0]])
    n = 20000
    rows = logits.expand(n, -1)
    g = torch.Generator().manual_seed(0)
    for kw, keep in [(dict(top_k=3), 3), (dict(top_p=0.7), 3), ({}, 8)]:
        tok = sample_logits(rows, g, temperature=1.0, **kw)
        freq = torch.bincount(tok, minlength=8).double() / n
        p = torch.softmax(logits[0, :keep].double(), -1)
        assert (freq[keep:] == 0).all()
        assert torch.allclose(freq[:keep], p, atol=0.02)
    assert sample_logits(rows[:2]).tolist() == [0, 0]  # greedy
