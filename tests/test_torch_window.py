"""Port parity for sliding-window serving: the port's plain versions (CPU)
against the JAX package's Pallas kernels in interpret mode and its oracles,
on the same numpy inputs, at the JAX tests' tolerances — flash_fwd and
tile_fwd with a window (tests/test_pallas.py's window seams: 1e-4), paged
decode (tests/test_paged.py's windows: 2e-5), ragged and grouped ragged
attention (2e-6, tests/test_ragged_paged.py's); then the windowed model
end to end: the dense-cache `generate` token-exact against JAX's in fp32,
the paged path and both engines token-exact against it; and the options
that still refuse a window (the training paths run:
tests/test_torch_window_train.py holds them to the JAX package)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models.decode import generate as j_generate
from burst_attn_tpu.models.decode import prefill as j_prefill
from burst_attn_tpu.ops import masks as jmasks
from burst_attn_tpu.ops import paged_attention as jpa
from burst_attn_tpu.ops import pallas_flash as jflash
from burst_attn_tpu.ops import ragged_paged as jrp
from burst_attn_tpu.ops import tile as jtile
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models.decode import generate, prefill
from burst_attn_tpu_torch.models.dist_decode import dist_paged_decode_step
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, forward, params_from_jax,
)
from burst_attn_tpu_torch.ops import flash, masks, tile
from burst_attn_tpu_torch.ops import paged_attention as pa
from burst_attn_tpu_torch.ops import ragged_paged as rp
from burst_attn_tpu_torch.parallel import burst
from burst_attn_tpu_torch.serving import RaggedServeEngine
from burst_attn_tpu_torch.serving.handoff import check_handoff_preconditions


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


# ---------------------------------------------------------------------------
# kernel 1: flash_fwd / tile_fwd with a window

# (s, heads, kv heads, window, offset, carry): window x ragged S (16-row
# blocks), a one-column window, offset -1 with a carry, window >= S
FLASH_CASES = [
    (40, 2, 1, 12, 0, False),
    (32, 4, 2, 1, 0, False),
    (32, 2, 2, 12, -1, True),
    (40, 4, 2, 64, 0, False),
]


@pytest.mark.parametrize("s,n,n_kv,window,offset,carry", FLASH_CASES)
def test_flash_fwd_window_matches_jax(s, n, n_kv, window, offset, carry):
    d, scale = 16, 16**-0.5
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((1, n, s, d), dtype=np.float32)
    k, v = (rng.standard_normal((1, n_kv, s, d), dtype=np.float32)
            for _ in range(2))
    spec = masks.MaskSpec(0, s, s, 1, offset)
    jspec = jmasks.MaskSpec(*(jnp.int32(x) for x in spec))
    jst = jtile.init_state(1, n, s, d)
    if carry:  # a first round's state, from the JAX tile
        k0, v0 = (rng.standard_normal((1, n_kv, s, d), dtype=np.float32)
                  for _ in range(2))
        jst = jtile.tile_fwd(jnp.asarray(q), jnp.asarray(k0),
                             jnp.asarray(v0), *jst, scale,
                             jmasks.MaskSpec(*(jnp.int32(x) for x in
                                               masks.full_spec(s, s))))
    st = [torch.from_numpy(np.array(x)) for x in jst] if carry else \
        [None] * 3
    got = flash.flash_fwd(*_t(q, k, v), *st, scale, spec, window=window)
    wants = [jtile.tile_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            *jst, scale, jspec, window=window)]
    if window > 1:  # the JAX kernel in interpret mode (compiles per case)
        wants.append(jflash.flash_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            *(jst if carry else (None, None, None)), scale, jspec,
            block_q=16, block_kv=16, interpret=True, cast_p=False,
            window=window))
    for want in wants:
        for g, w, name in zip(got, want, ("m", "lse", "acc")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(
        masks.dense_mask(spec, s, s, window=window).numpy(),
        np.asarray(jmasks.dense_mask(jspec, s, s, window=window)))
    assert masks.spec_pair_count(spec, s, s, window=window) == int(
        jmasks.spec_pair_count(jspec, s, s, window=window))
    assert masks.spec_live(spec, window=window) == bool(
        jmasks.spec_live(jspec, window=window))
    if window >= s and not carry:  # no band left: the unwindowed round
        plain = flash.flash_fwd(*_t(q, k, v), None, None, None, scale, spec)
        for g, w in zip(got, plain):
            assert torch.equal(g, w)


def test_single_device_attention_window_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 2, 40, 16), dtype=np.float32)
               for _ in range(3))
    got = tile.single_device_attention(*_t(q, k, v), causal=True, window=7)
    want = jtile.single_device_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    via_flash = flash.flash_attention(*_t(q, k, v), causal=True, window=7)
    np.testing.assert_allclose(via_flash.numpy(), got.numpy(), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match="causal"):
        tile.single_device_attention(*_t(q, k, v), window=7)
    with pytest.raises(ValueError, match="causal"):
        flash.flash_attention(*_t(q, k, v), window=7)


# ---------------------------------------------------------------------------
# kernel 6: paged decode with a window


def _pool(seed, *, slots, n_pages, n_kv, page, d, width, group):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((slots, n_kv, group, d), dtype=np.float32)
    kp = rng.standard_normal((n_pages, n_kv, page, d), dtype=np.float32)
    vp = rng.standard_normal((n_pages, n_kv, page, d), dtype=np.float32)
    table = (rng.permutation(n_pages - 1)[: slots * width] + 1).reshape(
        slots, width).astype(np.int32)
    return q, kp, vp, table


@pytest.mark.parametrize("window", [64, 128, 300])
def test_paged_decode_window_matches_jax(window):
    q, kp, vp, table = _pool(7, slots=3, n_pages=16, n_kv=2, page=128, d=32,
                             width=3, group=2)
    lengths = np.asarray([10, 129, 2 * 128 + 77], np.int32)
    args = (q, kp, vp, table, lengths)
    got = pa.paged_decode_attention(*_t(*args), window=window)
    want = jpa.paged_decode_attention(*map(jnp.asarray, args), window=window)
    want_ref = jpa.paged_decode_reference(*map(jnp.asarray, args),
                                          window=window)
    for w in (want, want_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)
    if window >= 2 * 128 + 77:  # the window covers every live position
        torch.testing.assert_close(
            got, pa.paged_decode_attention(*_t(*args)), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_paged_decode_window_quantized_pool(name):
    q, kp, vp, table = _pool(8, slots=3, n_pages=16, n_kv=2, page=128, d=32,
                             width=3, group=2)
    lengths = np.asarray([10, 129, 333], np.int32)
    jdt = jpa.QUANT_DTYPES[name][0]
    (k8, ks), (v8, vs) = (jpa.quantize_tokens(jnp.asarray(x), dtype=jdt)
                          for x in (kp, vp))
    want = jpa.paged_decode_attention(
        jnp.asarray(q), k8, v8, jnp.asarray(table), jnp.asarray(lengths),
        k_scales=ks, v_scales=vs, window=100)
    tdt = pa.QUANT_DTYPES[name][0]
    (tk, tks), (tv, tvs) = (pa.quantize_tokens(torch.from_numpy(x),
                                               dtype=tdt) for x in (kp, vp))
    got = pa.paged_decode_attention(*_t(q), tk, tv, *_t(table, lengths),
                                    k_scales=tks, v_scales=tvs, window=100)
    # JAX's quantized kernel rounds p to bf16 for its P.V product
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)


# ---------------------------------------------------------------------------
# kernel 7: ragged and grouped ragged attention with a window


def _ragged_case(seed, *, qt=6, d=16, window_kv=(170, 6, 136, 0)):
    rng = np.random.default_rng(seed)
    n_pages, n_kv, page, width, group = 8, 2, 128, 3, 2
    k = rng.standard_normal((n_pages, n_kv, page, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, n_kv, page, d)).astype(np.float32)
    table = np.stack([rng.permutation(n_pages - 1)[:width] + 1
                      for _ in range(4)]).astype(np.int32)
    q_lens = np.asarray([1, qt, qt - 2, 0], np.int32)
    kv_lens = np.asarray(window_kv, np.int32)
    q = rng.standard_normal((4, n_kv * group, qt, d)).astype(np.float32)
    return dict(q=q, k_pages=k, v_pages=v, page_table=table, q_lens=q_lens,
                kv_lens=kv_lens)


def _real(x, q_lens):
    qt = x.shape[2]
    real = np.arange(qt)[None, :] < np.asarray(q_lens)[:, None]
    return np.moveaxis(np.asarray(x), 2, 1)[real]


@pytest.mark.parametrize("window", [1, 5, 40, 500])
def test_ragged_window_matches_jax(window):
    """Against JAX's oracle at every window, and its kernel (interpret
    mode) at one."""
    case = _ragged_case(window)
    got = rp.ragged_paged_attention(**dict(zip(case, _t(*case.values()))),
                                    window=window).numpy()
    jargs = {k: jnp.asarray(v) for k, v in case.items()}
    wants = [jrp.ragged_paged_reference(**jargs, window=window)]
    if window == 5:
        wants.append(jrp.ragged_paged_attention(**jargs, window=window,
                                                interpret=True))
    for w in wants:
        np.testing.assert_allclose(_real(got, case["q_lens"]),
                                   _real(w, case["q_lens"]), rtol=2e-6,
                                   atol=2e-6)


@pytest.mark.parametrize("window,kv1", [(40, 128 + 6), (16, 300)])
def test_grouped_window_matches_jax(window, kv1):
    """Two slots share a one-page prefix: with kv1 = 134 the band of the
    group's rows overlaps the prefix; with kv1 = 300 and window 16 the
    prefix lies wholly below every row's band, so the prefix pass must add
    nothing (and no NaN)."""
    case = _ragged_case(4, window_kv=(170, kv1, kv1 - 2, 0))
    case["page_table"][1, 0] = case["page_table"][2, 0]
    grp = dict(group_id=np.asarray([0, 1, 1, 0], np.int32),
               shared_table=np.asarray([[0, 0], [case["page_table"][1, 0],
                                                 0], [0, 0]], np.int32),
               shared_lens=np.asarray([0, 128, 0], np.int32))
    targs = dict(zip(case, _t(*case.values())))
    got = rp.ragged_paged_attention_grouped(
        **targs, **dict(zip(grp, _t(*grp.values()))), window=window)
    assert not torch.isnan(got).any()
    oracle = jrp.ragged_paged_reference(
        **{k: jnp.asarray(v) for k, v in case.items()}, window=window)
    plain = rp.ragged_paged_attention(**targs, window=window)
    wants = [oracle, plain]
    if kv1 > 128 + window:  # JAX's grouped front end (interpret mode)
        jargs = {k: jnp.asarray(v) for k, v in {**case, **grp}.items()}
        wants.append(jrp.ragged_paged_attention_grouped(
            **jargs, window=window, interpret=True))
    for w in wants:
        np.testing.assert_allclose(_real(got.numpy(), case["q_lens"]),
                                   _real(np.asarray(w), case["q_lens"]),
                                   rtol=2e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# the windowed model end to end

DIMS = dict(vocab=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128)
WINDOW = 4


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(**DIMS, dtype=jnp.float32, attn_backend="jnp",
                        remat=False, batch_axis=None, head_axis=None,
                        window=WINDOW, layout="contig")
    cfg = ModelConfig(**DIMS, dtype=torch.float32, batch_axis=None,
                      head_axis=None, window=WINDOW, layout="contig")
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, params


def test_generate_window_matches_jax(model):
    jcfg, jparams, cfg, params = model
    prompt = np.random.default_rng(9).integers(0, DIMS["vocab"], size=(2, 9),
                                               dtype=np.int32)
    want = np.asarray(j_generate(jparams, jnp.asarray(prompt), jcfg,
                                 steps=6, max_seq=32))
    got = generate(params, prompt, cfg, steps=6, max_seq=32)
    np.testing.assert_array_equal(got.numpy(), want)
    # the window bites: the unwindowed model continues differently
    nowin = dataclasses.replace(cfg, window=None)
    assert not torch.equal(generate(params, prompt, nowin, steps=6,
                                    max_seq=32), got)


def test_paged_window_generate_matches_dense(model):
    """cfg.window threads through paged_prefill (kernel 1's band) and
    paged_decode_step (kernel 6's): the same tokens as the dense-cache
    generate."""
    _, _, cfg, params = model
    t, steps = 9, 5
    prompt = np.random.default_rng(9).integers(0, DIMS["vocab"], size=t,
                                               dtype=np.int32)
    want = generate(params, prompt[None], cfg, steps=steps, max_seq=256)[0]
    state, pool = pd.init_paged_state(cfg, slots=2, n_pages=8, page=128,
                                      max_pages_per_seq=3, device="cpu")
    logits, state = pd.paged_prefill(params, prompt, state, pool, 0, cfg)
    toks = [int(torch.argmax(logits))]
    for _ in range(steps - 1):
        state = pd.ensure_capacity(state, pool, 0)
        lg, state = pd.paged_decode_step(params, torch.tensor([toks[-1], 0]),
                                         state, cfg)
        toks.append(int(torch.argmax(lg[0])))
    assert toks == want.tolist()


def test_engines_window_streams_equal(model):
    """Both engines serve the windowed fp32 model token for token like the
    dense-cache generate, prompts inside and past the window, chunked
    prefill, the ragged prefix cache on and off."""
    _, _, cfg, params = model
    rng = np.random.default_rng(5)
    tmpl = rng.integers(1, DIMS["vocab"], size=128, dtype=np.int32)
    prompts = [rng.integers(1, DIMS["vocab"], size=t, dtype=np.int32)
               for t in (3, 11, 40)]
    prompts += [np.concatenate([tmpl, rng.integers(1, DIMS["vocab"],
                                                   size=t, dtype=np.int32)])
                for t in (5, 30)]
    budget = 6
    want = [generate(params, p[None], cfg, steps=budget,
                     max_seq=len(p) + budget)[0].tolist() for p in prompts]
    kw = dict(slots=3, n_pages=16, page=128, max_pages_per_seq=3,
              device="cpu")
    eng = ServeEngine(params, cfg, **kw)
    rids = [eng.submit(p, budget) for p in prompts]
    out = eng.run()
    assert [out[r] for r in rids] == want
    for cache in (False, True):
        eng = RaggedServeEngine(params, cfg, chunk=16, prefix_cache=cache,
                                **kw)
        eng.submit(tmpl, 2)  # registers the template's page
        eng.run()
        rids = [eng.submit(p, budget) for p in prompts]
        out = eng.run()
        assert [out[r] for r in rids] == want, cache
        if cache:
            assert eng.stats["serve.prefix_hits"] == 2
            assert eng.stats.get("serve.grouped_launches", 0) > 0


def test_dense_forward_window_matches_jax(model):
    """The port's dense plain forward (the serving checks' reference) and
    its prefill against the JAX prefill's logits of the windowed model."""
    jcfg, jparams, cfg, params = model
    tok = np.random.default_rng(2).integers(0, DIMS["vocab"], size=(1, 12),
                                            dtype=np.int32)
    want, _ = j_prefill(jparams, jnp.asarray(tok), jcfg, 16)
    got = forward(params, *_t(tok, np.arange(12)[None]), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    got, cache = prefill(params, *_t(tok), cfg, 16)
    assert cache.length == 12
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# what still refuses a window


def test_window_config_checks_and_unported_paths(model):
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="contig"):
        ModelConfig(**DIMS, window=8)  # the default layout is zigzag
    with pytest.raises(ValueError, match="causal"):
        ModelConfig(**DIMS, window=8, layout="contig", causal=False)
    with pytest.raises(ValueError, match=">= 1"):
        ModelConfig(**DIMS, window=0, layout="contig")
    x = torch.randn(1, 2, 8, 16, generator=torch.Generator().manual_seed(0))
    lse = torch.zeros(1, 2, 8)
    spec = masks.full_spec(8, 8)
    # the windowed training paths run (ported with the backward band):
    # the flash backward is tile_bwd's band on the CPU ...
    got = flash.flash_bwd(x, x, x, x, lse, lse, 1.0, spec, window=4)
    want = tile.tile_bwd(x, x, x, x, lse, lse, 1.0, spec, window=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # ... flash_attention differentiates through it, as autograd does
    # through the plain banded attention ...
    q = x.clone().requires_grad_()
    flash.flash_attention(q, x, x, causal=True, window=4).sum().backward()
    q2 = x.clone().requires_grad_()
    tile.single_device_attention(q2, x, x, causal=True,
                                 window=4).sum().backward()
    np.testing.assert_allclose(q.grad.numpy(), q2.grad.numpy(), atol=1e-5,
                               rtol=0)
    # ... and the contig ring takes a window
    got = burst.burst_attn(x, x, x, mesh={"sp": 2}, causal=True,
                           layout="contig", window=4)
    np.testing.assert_allclose(
        got.numpy(), tile.single_device_attention(
            x, x, x, causal=True, window=4).numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="contig"):
        burst.burst_attn(x, x, x, mesh={"sp": 2}, causal=True,
                         layout="zigzag", window=4)
    state, pool = pd.init_paged_state(cfg, slots=1, n_pages=8, page=128,
                                      max_pages_per_seq=2, device="cpu")
    with pytest.raises(ValueError, match="window"):
        check_handoff_preconditions(state, pool, 0, 128, cfg)
    with pytest.raises(ValueError, match="window"):
        dist_paged_decode_step(params, torch.zeros(1, dtype=torch.long),
                               state, cfg, {"sp": 2})
