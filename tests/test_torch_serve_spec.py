"""Port parity for speculative serving: paged_multi_step and
rollback_tokens against the JAX package's, and both engines' draft modes
(ServeEngine and RaggedServeEngine with draft_params) against the plain
engines, generate() and the JAX engines' draft modes (CPU, plain
attention), on the same weights (params_from_jax), f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import paged_decode as jpd
from burst_attn_tpu.models.serve import ServeEngine as JServeEngine
from burst_attn_tpu.serving import RaggedServeEngine as JRaggedServeEngine
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models import spec_round
from burst_attn_tpu_torch.models.decode import generate
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax,
)
from burst_attn_tpu_torch.serving import RaggedServeEngine

LOGITS_ATOL = 1e-4  # f32 model; matmul/summation order differs

DIMS = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=32, d_ff=256)
DRAFT_DIMS = dict(vocab=256, d_model=64, n_layers=1, n_heads=2,
                  n_kv_heads=1, d_head=32, d_ff=128)
ENGINES = {"serve": (ServeEngine, JServeEngine, {}),
           "ragged": (RaggedServeEngine, JRaggedServeEngine, {"chunk": 4})}


def _model(dims, seed):
    jcfg = JModelConfig(**dims, dtype=jnp.float32, attn_backend="jnp",
                        remat=False, batch_axis=None, head_axis=None)
    cfg = ModelConfig(**dims, dtype=torch.float32, batch_axis=None,
                      head_axis=None)
    jparams = j_init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def model():
    return _model(DIMS, seed=0)


@pytest.fixture(scope="module")
def draft():
    return _model(DRAFT_DIMS, seed=77)


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, DIMS["vocab"], size=t, dtype=np.int32)
            for t in lengths]


def _generate(cfg, params, prompt, steps):
    return generate(params, torch.from_numpy(prompt)[None].long(), cfg,
                    steps=steps, max_seq=256)[0].tolist()


def _serve(kind, cfg, params, prompts, steps, jax_side=False, **kw):
    """Serve the requests through one engine kind; returns (tokens by
    request, engine)."""
    cls = ENGINES[kind][1 if jax_side else 0]
    kw = dict(slots=2, n_pages=12, page=128, max_pages_per_seq=3,
              **ENGINES[kind][2], **kw)
    if not jax_side:
        kw["device"] = "cpu"
    eng = cls(params, cfg, **kw)
    rids = [eng.submit(p, s) for p, s in zip(prompts, steps)]
    out = eng.run()
    return [list(map(int, out[r])) for r in rids], eng


@pytest.mark.parametrize("kind", ["serve", "ragged"])
def test_draft_engine_matches_plain_engine_and_jax(model, draft, kind):
    """Continuous batching with a weak draft: staggered lengths, slot
    reuse, budget and EOS trims; every stream equals the plain engine's,
    the JAX draft engine's (with the same acceptance counts), and both
    pools drain."""
    jcfg, jparams, cfg, params = model
    jdcfg, jdparams, dcfg, dparams = draft
    prompts = _prompts([9, 5, 12, 7], seed=71)
    steps = [6, 4, 3, 7]
    base, _ = _serve(kind, cfg, params, prompts, steps)
    # an EOS first met inside a stream, so a round trims at it
    eos = base[3][3]
    base, _ = _serve(kind, cfg, params, prompts, steps, eos_id=eos)
    spec, eng = _serve(kind, cfg, params, prompts, steps, eos_id=eos,
                       draft_params=dparams, draft_cfg=dcfg, spec_k=3)
    assert spec == base
    assert any(len(t) < s for t, s in zip(spec, steps))  # EOS trimmed one
    assert eng.pool.available == eng.draft.pool.available == 11
    assert eng.spec_rounds > 0
    assert eng.spec_proposed >= eng.spec_accepted >= 0
    want, jeng = _serve(kind, jcfg, jparams, prompts, steps, jax_side=True,
                        eos_id=eos, draft_params=jdparams, draft_cfg=jdcfg,
                        spec_k=3)
    assert spec == want
    assert (eng.spec_rounds, eng.spec_proposed, eng.spec_accepted) == \
        (jeng.spec_rounds, jeng.spec_proposed, jeng.spec_accepted)
    assert eng.acceptance_rate == jeng.acceptance_rate


@pytest.mark.parametrize("kind", ["serve", "ragged"])
def test_self_draft_matches_generate_and_stops_at_eos(model, kind):
    """draft == target: every proposal accepted, tokens equal generate();
    an EOS inside an accepted block stops the request at its first
    occurrence."""
    _, _, cfg, params = model
    (p0,) = _prompts([9], seed=81)
    want = _generate(cfg, params, p0, 9)
    kw = dict(draft_params=params, draft_cfg=cfg, spec_k=3)
    (got,), eng = _serve(kind, cfg, params, [p0], [9], **kw)
    assert got == want
    assert eng.acceptance_rate == 1.0
    eos = want[2]
    kw["spec_k"] = 4
    (got,), eng = _serve(kind, cfg, params, [p0], [9], eos_id=eos, **kw)
    assert got == want[:want.index(eos) + 1]
    assert eng.pool.available == eng.draft.pool.available == 11


@pytest.mark.parametrize("kind", ["serve", "ragged"])
def test_int8_draft_engine_matches_plain_int8(model, draft, kind):
    """Speculative serving on int8 pools (the draft's pools int8 too):
    token-exact with the plain int8 engine."""
    _, _, cfg, params = model
    _, _, dcfg, dparams = draft
    prompts = _prompts([9, 6, 11], seed=93)
    steps = [5, 5, 5]
    want, _ = _serve(kind, cfg, params, prompts, steps, quantize=True)
    got, eng = _serve(kind, cfg, params, prompts, steps, quantize=True,
                      draft_params=dparams, draft_cfg=dcfg, spec_k=3)
    assert got == want
    assert eng.draft.state.k_pages[0].dtype == torch.int8


@pytest.mark.parametrize("kind", ["serve", "ragged"])
def test_draft_admission_failure_rolls_back_both_pools(model, kind,
                                                       monkeypatch):
    """The target's admission work succeeds and the DRAFT prefill raises:
    both pools return to their levels before admission, the request stays
    at the queue head, and the retry serves it token-exact."""
    _, _, cfg, params = model
    (p0,) = _prompts([9], seed=93)
    eng = ENGINES[kind][0](params, cfg, slots=1, n_pages=8, page=128,
                           max_pages_per_seq=3, draft_params=params,
                           draft_cfg=cfg, spec_k=3, device="cpu",
                           **ENGINES[kind][2])
    avail0, davail0 = eng.pool.available, eng.draft.pool.available
    rid = eng.submit(p0, 5)
    real = spec_round.paged_prefill

    def draft_boom(params_, tokens, state, pool, *a, **k):
        if pool is eng.draft.pool:
            raise RuntimeError("injected draft prefill failure")
        return real(params_, tokens, state, pool, *a, **k)

    monkeypatch.setattr(spec_round, "paged_prefill", draft_boom)
    with pytest.raises(RuntimeError, match="injected draft"):
        eng.step()
    assert eng.pool.available == avail0
    assert eng.draft.pool.available == davail0
    assert eng.pending == 1 and eng.live == 0
    monkeypatch.setattr(spec_round, "paged_prefill", real)
    assert eng.run()[rid] == _generate(cfg, params, p0, 5)
    assert eng.pool.available == avail0 and eng.draft.pool.available == davail0


def test_pipelined_draft_engine_delegates(model, draft):
    """pipeline=True with a draft serves through the synchronous
    speculative rounds: the same tokens, no launch left in flight, no
    decode graphs."""
    _, _, cfg, params = model
    _, _, dcfg, dparams = draft
    prompts = _prompts([9, 5, 13, 3], seed=11)
    steps = [5, 4, 6, 3]
    kw = dict(draft_params=dparams, draft_cfg=dcfg, spec_k=3)
    want, _ = _serve("ragged", cfg, params, prompts, steps, **kw)
    got, eng = _serve("ragged", cfg, params, prompts, steps, pipeline=True,
                      multi_step=4, **kw)
    assert got == want == [_generate(cfg, params, p, s)
                           for p, s in zip(prompts, steps)]
    assert eng.spec_rounds > 0 and eng._pending is None
    assert eng.graphs is None


@pytest.mark.parametrize("quant", [False, "int8"])
def test_paged_multi_step_matches_jax(model, quant):
    """Three slots: live and provisioned, dead, and live at a full page
    with nothing provisioned past it.  The live slot's [T, vocab] logits
    agree with JAX's, the unprovisioned one is NaN on both sides, and the
    lengths agree; then rollback_tokens moves both alike and guards its
    range."""
    jcfg, jparams, cfg, params = model
    kw = dict(slots=3, n_pages=10, page=128, max_pages_per_seq=3,
              quantize=quant)
    jst, jpool = jpd.init_paged_state(jcfg, **kw)
    st, pool = pd.init_paged_state(cfg, **kw, device="cpu")
    for slot, p in ((0, _prompts([150], 1)[0]), (2, _prompts([128], 2)[0])):
        _, jst = jpd.paged_prefill(jparams, jnp.asarray(p), jst, jpool, slot,
                                   jcfg)
        pd.paged_prefill(params, p, st, pool, slot, cfg)
    jst = jpd.provision_capacity(jst, jpool, 0, 4)
    pd.provision_capacity(st, pool, 0, 4)
    toks = np.random.default_rng(3).integers(
        1, DIMS["vocab"], size=(3, 4)).astype(np.int32)
    jlg, jst = jpd.paged_multi_step(jparams, jnp.asarray(toks), jst, jcfg)
    lg, st = pd.paged_multi_step(params, toks, st, cfg)
    jlg = np.asarray(jlg)
    assert lg.shape == (3, 4, DIMS["vocab"]) and lg.dtype == torch.float32
    np.testing.assert_allclose(lg[0].numpy(), jlg[0], atol=LOGITS_ATOL,
                               rtol=0)
    assert torch.isnan(lg[2]).all() and np.isnan(jlg[2]).all()
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(jst.lengths))
    assert st.lengths.tolist() == [154, 0, 132]
    jst = jpd.rollback_tokens(jst, 0, 3)
    assert pd.rollback_tokens(st, 0, 3) is st
    np.testing.assert_array_equal(st.lengths.numpy(), np.asarray(jst.lengths))


def test_rollback_tokens_guard(model):
    """At least one token must remain (retire_slot frees a slot), and n is
    never negative; an empty slot has nothing to roll back."""
    _, _, cfg, params = model
    st, pool = pd.init_paged_state(cfg, slots=2, n_pages=4, page=128,
                                   max_pages_per_seq=2, device="cpu")
    pd.paged_prefill(params, _prompts([5], 4)[0], st, pool, 0, cfg)
    for slot, n in ((0, 5), (0, 6), (0, -1), (1, 0)):
        with pytest.raises(ValueError, match="cannot roll back"):
            pd.rollback_tokens(st, slot, n)
    pd.rollback_tokens(st, 0, 4)
    assert st.lengths.tolist() == [1, 0]


def test_ragged_draft_prefix_cache_mirrors_stay_exact(model, draft):
    """A draft engine with the prefix cache: prefix hits on a template,
    then a long uncached prompt chunked while another slot decodes (mixed
    ticks with a draft catch-up).  After every step the host mirror of the
    lengths equals the device lengths, and every live slot past its
    prefill has the same draft and target length; the tokens equal the
    cache-off run's and generate()'s."""
    _, _, cfg, params = model
    _, _, dcfg, dparams = draft
    rng = np.random.default_rng(5)
    tmpl = rng.integers(1, DIMS["vocab"], size=128, dtype=np.int32)
    prompts = [np.concatenate([tmpl, rng.integers(1, DIMS["vocab"], size=n,
                                                  dtype=np.int32)])
               for n in (0, 5, 9)]
    prompts.append(rng.integers(1, DIMS["vocab"], size=40, dtype=np.int32))
    steps = [7, 9, 5, 6]
    out = {}
    for cache in (False, True):
        eng = RaggedServeEngine(params, cfg, slots=2, n_pages=16, page=128,
                                max_pages_per_seq=3, chunk=4,
                                prefix_cache=cache, draft_params=dparams,
                                draft_cfg=dcfg, spec_k=3, device="cpu")
        eng.submit(tmpl, 2)
        eng.run()  # registers the template when the cache is on
        rids = [eng.submit(p, s) for p, s in zip(prompts, steps)]
        while eng.pending or eng.live:
            eng.step()
            lengths = eng.state.lengths.numpy()
            np.testing.assert_array_equal(eng._lengths, lengths)
            for slot, req in enumerate(eng.slots):
                if req is not None and req.n_prefilled == len(req.prompt):
                    assert int(eng.draft.state.lengths[slot]) == lengths[slot]
        res = eng.results()
        out[cache] = [list(map(int, res[r])) for r in rids]
        assert eng.stats["serve.draft_catchup_launches"] > 0
        assert eng.spec_rounds > 0
        assert eng.draft.pool.available == 15
        if cache:
            assert eng.stats["serve.prefix_hits"] == 3
            assert eng.stats["serve.cow_copies"] > 0
    assert out[True] == out[False] == [_generate(cfg, params, p, s)
                                       for p, s in zip(prompts, steps)]
