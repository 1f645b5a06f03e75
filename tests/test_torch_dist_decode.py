"""Port parity for the dense-shard distributed decode
(models/dist_decode.py): dist_prefill, dist_decode_step and dist_generate
against the JAX package's on the same weights (params_from_jax), fp32 on
the CPU, sp=4.  The JAX side jits its scan ring (attn_backend="jnp") on
the conftest's host devices; the port runs its scan ring ("jnp", "auto":
the plain tile / kernel 1's plain version) and the fused ring's plain
version ("fused_ring").

Tolerance: fp32 logits and cache shards within 1e-5 of the largest
entry of the JAX value (the rings sum in another order); greedy tokens
exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import dist_decode as jdd
from burst_attn_tpu.models.train import make_mesh
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models.decode import generate
from burst_attn_tpu_torch.models.dist_decode import (
    DistCache, dist_decode_step, dist_generate, dist_prefill,
)
from burst_attn_tpu_torch.models.transformer import ModelConfig, \
    forward, params_from_jax
from burst_attn_tpu_torch.serving import ring_prefill_to_pages

DIMS = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128)
B, S, STEPS, GEN = 2, 64, 4, 6
RTOL_MAX = 1e-5  # of the largest entry
LAYOUTS = ("contig", "zigzag", "striped")


def _close(got, want, what):
    want = np.asarray(want)
    tol = RTOL_MAX * float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, atol=tol, rtol=0,
                               err_msg=what)


def _cfg(layout="zigzag", backend="jnp", **kw):
    return ModelConfig(**DIMS, dtype=torch.float32, layout=layout,
                       attn_backend=backend, batch_axis=None, head_axis=None,
                       **kw)


def _jcfg(layout):
    return JModelConfig(**DIMS, attn_backend="jnp", remat=False,
                        dtype=jnp.float32, layout=layout, batch_axis=None,
                        head_axis=None)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's dist_prefill for every layout (last logits and
    cache shards), two dist_decode_steps and a greedy dist_generate on
    the zigzag layout, all on one set of weights."""
    jparams = j_init_params(jax.random.PRNGKey(0), _jcfg("zigzag"))
    jmesh = make_mesh({"sp": 4})
    prompt = np.random.default_rng(1).integers(0, DIMS["vocab"], (B, S)
                                               ).astype(np.int32)
    out = dict(prompt=prompt, prefill={})
    for layout in LAYOUTS:
        jcfg = _jcfg(layout)
        last, cache = jax.jit(lambda p, t, jcfg=jcfg: jdd.dist_prefill(
            p, t, jcfg, jmesh, gen_budget=STEPS))(jparams, prompt)
        out["prefill"][layout] = (
            np.asarray(last), [np.asarray(x) for x in cache.k_shard],
            [np.asarray(x) for x in cache.v_shard])
        if layout == "zigzag":
            step = jax.jit(lambda p, t, pos, c: jdd.dist_decode_step(
                p, t, pos, c, jcfg, jmesh))
            feed = np.array(jnp.argmax(last, axis=-1), np.int32)
            steps = []
            for i in range(2):
                logits, cache = step(jparams, feed, jnp.int32(S + i), cache)
                steps.append((feed, np.asarray(logits)))
                feed = np.array(jnp.argmax(logits, axis=-1), np.int32)
            out["steps"] = steps
            out["tokens"] = np.asarray(jdd.dist_generate(
                jparams, jnp.asarray(prompt), jcfg, jmesh, steps=GEN))
    out["params"] = params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return out


@pytest.mark.parametrize("backend", ["jnp", "fused_ring"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_dist_prefill_matches_jax(ref, layout, backend):
    """Last logits and every layer's K/V shard (layout order) equal the
    JAX package's; the recent buffers start empty."""
    cfg = _cfg(layout, backend)
    last, cache = dist_prefill(ref["params"], torch.from_numpy(ref["prompt"]),
                               cfg, {"sp": 4}, gen_budget=STEPS)
    want_last, want_k, want_v = ref["prefill"][layout]
    _close(last, want_last, "last logits")
    assert isinstance(cache, DistCache) and cache.n_new == 0
    for li in range(DIMS["n_layers"]):
        assert cache.k_shard[li].shape == (B, DIMS["n_kv_heads"], S,
                                           DIMS["d_head"])
        _close(cache.k_shard[li], want_k[li], f"k_shard {li}")
        _close(cache.v_shard[li], want_v[li], f"v_shard {li}")
        assert cache.k_new[li].shape == (B, DIMS["n_kv_heads"], STEPS,
                                         DIMS["d_head"])
        assert not cache.k_new[li].any() and not cache.v_new[li].any()


def test_dist_decode_step_matches_jax(ref):
    """Two decode steps over the sharded prompt cache and the recent
    buffer: logits equal the JAX package's, n_new counts the tokens."""
    cfg = _cfg()
    _, cache = dist_prefill(ref["params"], torch.from_numpy(ref["prompt"]),
                            cfg, {"sp": 4}, gen_budget=STEPS)
    for i, (feed, want) in enumerate(ref["steps"]):
        logits, cache = dist_decode_step(ref["params"],
                                         torch.from_numpy(feed), S + i,
                                         cache, cfg, {"sp": 4})
        _close(logits, want, f"step {i}")
        assert cache.n_new == i + 1


@pytest.mark.parametrize("backend", ["jnp", "fused_ring"])
def test_dist_generate_greedy_token_exact(ref, backend):
    """Greedy dist_generate equals the JAX package's tokens and the
    port's own single-device generate."""
    cfg = _cfg(backend=backend)
    prompt = torch.from_numpy(ref["prompt"])
    got = dist_generate(ref["params"], prompt, cfg, {"sp": 4}, steps=GEN)
    assert got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), ref["tokens"])
    want = generate(ref["params"], prompt, cfg, steps=GEN, max_seq=S + GEN)
    assert torch.equal(got, want)


def test_dist_generate_sampled_repeatable(ref):
    """Sampling draws from the caller's torch.Generator: one seed gives
    one stream, in range; the generator advances."""
    cfg = _cfg()
    prompt = torch.from_numpy(ref["prompt"])
    kw = dict(steps=GEN, temperature=0.9, top_k=16, top_p=0.95)
    runs = []
    for seed in (3, 3, 4):
        gen = torch.Generator().manual_seed(seed)
        runs.append(dist_generate(ref["params"], prompt, cfg, {"sp": 4},
                                  generator=gen, **kw))
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < DIMS["vocab"])).all()
    assert not torch.equal(runs[0], runs[2])


def test_ring_prefill_pages_equal_dist_shards(ref):
    """The handoff's pool pages, read in table order, are dist_prefill's
    layout-order shards (the handoff never re-lays the cache out)."""
    cfg = _cfg()
    page, n_pages, s = 128, 4, 256
    st, pool = pd.init_paged_state(cfg, slots=1, n_pages=n_pages, page=page,
                                   max_pages_per_seq=2, device="cpu")
    prompt = np.random.default_rng(2).integers(0, DIMS["vocab"], s)
    ring_prefill_to_pages(ref["params"], prompt, st, pool, 0, cfg,
                          {"sp": 4})
    _, cache = dist_prefill(ref["params"], torch.from_numpy(prompt[None]),
                            cfg, {"sp": 4}, gen_budget=1)
    table = st.page_table[0, :s // page].long()
    for li in range(DIMS["n_layers"]):
        for pages, shard in ((st.k_pages[li], cache.k_shard[li]),
                             (st.v_pages[li], cache.v_shard[li])):
            paged = torch.cat([pages[p] for p in table], dim=1)
            assert torch.equal(paged, shard[0]), li


def test_window_and_moe_raise(ref):
    """A ring window prefills (the windowed contig ring): its last logits
    are the dense windowed forward's.  MoE layers are ported
    (tests/test_torch_moe.py holds an MoE dist_generate to JAX's); the
    pipeline-parallel config is a training path: serving refuses it."""
    cfg = _cfg("contig", window=16)
    prompt = torch.from_numpy(ref["prompt"]).long()
    last, _ = dist_prefill(ref["params"], prompt, cfg, {"sp": 4},
                           gen_budget=2)
    pos = torch.arange(S)[None].expand(B, S)
    want = forward(ref["params"], prompt, pos, cfg)[:, -1]
    _close(last, want.numpy(), "windowed dist_prefill")
    with pytest.raises(ValueError, match="training path"):
        dist_prefill(ref["params"], prompt,
                     dataclasses.replace(_cfg(), pp_axis="pp"), {"sp": 4},
                     gen_budget=2)
    with pytest.raises(ValueError, match="steps"):
        dist_generate(ref["params"], torch.from_numpy(ref["prompt"]),
                      _cfg(), {"sp": 4}, steps=0)
