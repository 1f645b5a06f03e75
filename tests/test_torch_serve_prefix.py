"""Port parity for the ServeEngine prefix cache and its suffix prefill
(`paged_prefill(cache=)`, `_suffix_attention`; CPU, plain attention)
against the JAX package's, on the same weights (params_from_jax), f32."""

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
from burst_attn_tpu_torch.models.decode import generate
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax,
)

LOGITS_ATOL = 1e-4  # f32 model; matmul/summation order differs
ATTN_ATOL = 1e-5    # one f32 attention, summation order only

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


def _toks(rng, n):
    return rng.integers(1, DIMS["vocab"], n).astype(np.int32)


def test_prefix_cache_engine_parity_and_reuse(model):
    """Two requests sharing a 2-page prefix: with the cache on, the tokens
    equal the uncached engine's and the JAX cached engine's; after both
    retire the cache alone holds the 2 prefix pages; a third request on
    the prefix after that still hits and equals a solo generate()."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(7)
    prefix = _toks(rng, 256)
    pa = np.concatenate([prefix, _toks(rng, 30)])
    pb = np.concatenate([prefix, _toks(rng, 50)])
    kw = dict(slots=2, n_pages=16, page=128, max_pages_per_seq=4)

    def run(eng):
        ra, rb = eng.submit(pa, 4), eng.submit(pb, 4)
        out = eng.run()
        return [list(map(int, out[ra])), list(map(int, out[rb]))]

    base = run(ServeEngine(params, cfg, **kw, device="cpu"))
    eng = ServeEngine(params, cfg, **kw, prefix_cache=True, device="cpu")
    got = run(eng)
    want = run(JServeEngine(jparams, jcfg, **kw, prefix_cache=True))
    assert got == base == want
    assert len(eng.cache) == 2
    assert eng.pool.available == 15 - 2  # only the cached pages stay held
    assert eng.pool.logical_refs == 2
    pc = np.concatenate([prefix, _toks(rng, 10)])
    rc = eng.submit(pc, 3)
    avail = eng.pool.available
    eng.step()  # admits pc: one suffix page + budget, none for the prefix
    assert avail - eng.pool.available == 1
    out = eng.run()
    ref = generate(params, torch.from_numpy(pc)[None].long(), cfg, steps=3,
                   max_seq=512)[0].tolist()
    assert out[rc] == ref


def test_prefix_cache_eviction_under_pressure(model):
    """When the pool cannot cover a new request, the least recently used
    cache entries are evicted to admit it; afterwards only the cache's
    references hold pages."""
    _, _, cfg, params = model
    rng = np.random.default_rng(9)
    p1, p2 = _toks(rng, 256), _toks(rng, 257)
    eng = ServeEngine(params, cfg, slots=1, n_pages=5, page=128,
                      max_pages_per_seq=4, prefix_cache=True, device="cpu")
    r1 = eng.submit(p1, 2)
    out = eng.run()
    assert len(out[r1]) == 2 and len(eng.cache) == 2
    assert eng.pool.available == 2
    r2 = eng.submit(p2, 2)  # 3 pages: must evict one of p1's
    out = eng.run()
    assert len(out[r2]) == 2
    assert len(eng.cache) == 3
    assert (5 - 1) - eng.pool.available == len(eng.cache)


@pytest.mark.parametrize("quant", [False, "int8"])
def test_paged_prefill_cache_matches_jax(model, quant):
    """paged_prefill(cache=) on both packages: a full prefill registers a
    prompt's pages, then a prompt sharing its first page takes the suffix
    prefill; logits, tables, lengths and pool accounting agree, and on
    the f32 pool a decode step after it too."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(3)
    tmpl = _toks(rng, 128)
    p0 = np.concatenate([tmpl, _toks(rng, 70)])
    p1 = np.concatenate([tmpl, _toks(rng, 150)])
    kw = dict(slots=2, n_pages=10, page=128, max_pages_per_seq=3,
              quantize=quant)
    jst, jpool = jpd.init_paged_state(jcfg, **kw)
    st, pool = pd.init_paged_state(cfg, **kw, device="cpu")
    jcache, cache = jpd.PrefixCache(jpool), pd.PrefixCache(pool)
    for slot, p in enumerate((p0, p1)):
        jl, jst = jpd.paged_prefill(jparams, jnp.asarray(p), jst, jpool,
                                    slot, jcfg, cache=jcache)
        lg, _ = pd.paged_prefill(params, p, st, pool, slot, cfg, cache=cache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(st.page_table.numpy(),
                                  np.asarray(jst.page_table))
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(jst.lengths))
    assert st.page_table[1, 0] == st.page_table[0, 0]  # the shared page
    assert pool.available == jpool.available and len(cache) == len(jcache)
    assert pool.refcount(int(st.page_table[0, 0])) == 3  # 2 slots + cache
    if quant:
        # the suffix K/V the decode step reads back went through int8
        # rounding: an f32-rounding difference between the packages can
        # flip one level (1/127 of a token's scale), past LOGITS_ATOL
        return
    for slot in (0, 1):
        jst = jpd.provision_capacity(jst, jpool, slot, 2)
        pd.provision_capacity(st, pool, slot, 2)
    tok = np.asarray([5, 9], np.int32)
    jl, _ = jpd.paged_decode_step(jparams, jnp.asarray(tok), jst, jcfg)
    lg, _ = pd.paged_decode_step(params, torch.from_numpy(tok), st, cfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=LOGITS_ATOL,
                               rtol=0)


def test_paged_prefill_cache_releases_on_failure(model):
    """An exhausted pool at the suffix's acquire releases the lookup's
    references too: nothing leaks."""
    _, _, cfg, params = model
    rng = np.random.default_rng(4)
    tmpl = _toks(rng, 128)
    st, pool = pd.init_paged_state(cfg, slots=2, n_pages=3, page=128,
                                   max_pages_per_seq=3, device="cpu")
    cache = pd.PrefixCache(pool)
    pd.paged_prefill(params, np.concatenate([tmpl, _toks(rng, 5)]), st, pool,
                     0, cfg, cache=cache)
    assert pool.available == 0
    refs = pool.logical_refs
    with pytest.raises(pd.PoolExhausted):
        pd.paged_prefill(params, np.concatenate([tmpl, _toks(rng, 9)]), st,
                         pool, 1, cfg, cache=cache)
    assert pool.logical_refs == refs and int(st.lengths[1]) == 0


@pytest.mark.parametrize("t_pre,t_suf,window", [(128, 1, None),
                                                (128, 37, None),
                                                (256, 128, None),
                                                (256, 100, 160)])
def test_suffix_attention_matches_jax(t_pre, t_suf, window):
    """_suffix_attention (the plain tile on the CPU; kernel 1 on the card)
    against the JAX package's dense path: suffix rows at offset t_pre,
    padded to a page, GQA 4/2, every row (pad rows give 0 in both)."""
    rng = np.random.default_rng(t_pre + t_suf)
    t_pad = -(-t_suf // 128) * 128
    q = rng.standard_normal((1, 4, t_pad, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, t_pre + t_pad, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, t_pre + t_pad, 32)).astype(np.float32)
    want = jpd._suffix_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), t_pre, q_hi=t_suf,
                                 kv_hi=t_pre + t_suf, window=window,
                                 use_flash=False)
    got = pd._suffix_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), t_pre, q_hi=t_suf,
                               kv_hi=t_pre + t_suf, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL,
                               rtol=0)
    assert not got[:, :, t_suf:].any()
