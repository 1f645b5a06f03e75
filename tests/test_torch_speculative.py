"""Port parity for speculative decoding over the dense KV cache: the
port's speculative_generate (CPU, plain attention) against the JAX
package's and the port's own generate(), on the same weights
(params_from_jax), f32.  Greedy runs are token-exact; sampled runs are
held to the target distribution (the port's draws are a torch.Generator's,
not jax.random's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import decode as jdec
from burst_attn_tpu.models import speculative as jspec
from burst_attn_tpu_torch.models import SpecStats, speculative_generate
from burst_attn_tpu_torch.models import speculative as spec
from burst_attn_tpu_torch.models.decode import generate, prefill
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax,
)

LOGITS_ATOL = 1e-4  # f32 model; matmul/summation order differs
VOCAB = 97


def _model(layers, d_model, seed):
    """(jcfg, jparams, cfg, params): JAX's test model and the port's copy
    of its weights."""
    dims = dict(vocab=VOCAB, d_model=d_model, n_layers=layers, n_heads=4,
                n_kv_heads=2, d_head=d_model // 4, d_ff=2 * d_model)
    jcfg = JModelConfig(**dims, block_q=8, block_kv=8, attn_backend="jnp",
                        remat=False, dtype=jnp.float32, batch_axis=None,
                        head_axis=None)
    cfg = ModelConfig(**dims, dtype=torch.float32, batch_axis=None,
                      head_axis=None)
    jparams = j_init_params(jax.random.PRNGKey(seed), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def target():
    return _model(2, 64, seed=0)


@pytest.fixture(scope="module")
def weak_draft():
    return _model(1, 32, seed=5)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        1, VOCAB, size=(1, n)).astype(np.int32)


def _generate(cfg, params, prompt, steps):
    return generate(params, torch.from_numpy(prompt).long(), cfg,
                    steps=steps, max_seq=128)[0].numpy()


@pytest.mark.parametrize("k,steps", [(4, 12), (1, 5), (3, 7)])
def test_weak_draft_matches_plain_greedy_and_jax(target, weak_draft, k,
                                                  steps):
    """A WEAK draft (other init, shallower, narrower) still yields exactly
    the target's greedy tokens, equal to JAX's speculative_generate; the
    stats obey JAX's bounds."""
    jcfg_t, jparams_t, cfg_t, params_t = target
    jcfg_d, jparams_d, cfg_d, params_d = weak_draft
    prompt = _prompt(9, seed=2)
    want = _generate(cfg_t, params_t, prompt, steps)
    got, stats = speculative_generate(
        params_t, params_d, prompt, cfg_t, cfg_d, steps=steps, k=k,
        max_seq=128, return_stats=True)
    assert isinstance(stats, SpecStats)
    np.testing.assert_array_equal(got, want)
    jgot, jstats = jspec.speculative_generate(
        jparams_t, jparams_d, jnp.asarray(prompt), jcfg_t, jcfg_d,
        steps=steps, k=k, max_seq=128, return_stats=True)
    np.testing.assert_array_equal(got, np.asarray(jgot))
    assert tuple(stats) == tuple(jstats)
    assert stats.proposed >= stats.accepted >= 0
    assert stats.target_passes <= steps - 1
    assert stats.target_passes >= -(-(steps - 1) // (k + 1))


def test_self_draft_accepts_everything(target):
    """draft == target: every proposal matches the target's greedy choice,
    so passes collapse to ceil((steps - 1) / (k + 1))."""
    _, _, cfg, params = target
    prompt = _prompt(7, seed=3)
    steps, k = 12, 3
    want = _generate(cfg, params, prompt, steps)
    got, stats = speculative_generate(params, params, prompt, cfg, cfg,
                                      steps=steps, k=k, max_seq=128,
                                      return_stats=True)
    np.testing.assert_array_equal(got, want)
    assert stats.accepted == stats.proposed
    assert stats.target_passes == -(-(steps - 1) // (k + 1))


def test_validates(target):
    _, _, cfg, params = target
    other = ModelConfig(vocab=64, d_model=32, n_layers=1, n_heads=4,
                        n_kv_heads=2, d_head=8, d_ff=64, dtype=torch.float32,
                        batch_axis=None, head_axis=None)
    prompt = np.ones((1, 4), np.int32)
    kw = dict(steps=4, max_seq=64)
    with pytest.raises(ValueError, match="share a vocabulary"):
        speculative_generate(params, params, prompt, cfg, other, k=2, **kw)
    with pytest.raises(ValueError, match="k must be"):
        speculative_generate(params, params, prompt, cfg, cfg, k=0, **kw)
    with pytest.raises(ValueError, match="single-sequence"):
        speculative_generate(params, params, np.ones((2, 4), np.int32), cfg,
                             cfg, k=2, **kw)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        speculative_generate(params, params, prompt, cfg, cfg, k=2, steps=4,
                             max_seq=10)


def test_residual_accept_preserves_target_distribution():
    """Monte Carlo check of the Leviathan rule: the first emitted token's
    empirical distribution equals the TARGET p, whatever the (very
    different) draft q."""
    p = torch.tensor([0.55, 0.25, 0.12, 0.08], dtype=torch.float64)
    q = torch.tensor([0.10, 0.60, 0.10, 0.20], dtype=torch.float64)
    p_rows = torch.stack([p, p])  # kk=1 + the bonus row (also p)
    q_rows = q[None]
    rng = torch.Generator().manual_seed(0)
    counts = np.zeros(4)
    n = 3000
    for _ in range(n):
        draft = [int(torch.multinomial(q, 1, generator=rng))]
        n_acc, nxt = spec._residual_accept(p_rows, q_rows, draft, rng)
        counts[draft[0] if n_acc >= 1 else nxt] += 1
    np.testing.assert_allclose(counts / n, p.numpy(), atol=0.03)


def test_sampled_self_draft_accepts_everything(target):
    """draft == target at temperature > 0: p == q, so the acceptance
    ratio is 1 and every proposal is accepted."""
    _, _, cfg, params = target
    prompt = _prompt(7, seed=3)
    steps, k = 10, 3
    got, stats = speculative_generate(
        params, params, prompt, cfg, cfg, steps=steps, k=k, max_seq=128,
        temperature=0.9, rng=torch.Generator().manual_seed(11),
        return_stats=True)
    assert len(got) == steps and np.all((got >= 0) & (got < VOCAB))
    assert stats.accepted == stats.proposed
    assert stats.target_passes == -(-(steps - 1) // (k + 1))


def test_sampled_weak_draft_runs(target, weak_draft):
    _, _, cfg_t, params_t = target
    _, _, cfg_d, params_d = weak_draft
    got, stats = speculative_generate(
        params_t, params_d, _prompt(9, seed=2), cfg_t, cfg_d, steps=9, k=3,
        max_seq=128, temperature=0.7, rng=torch.Generator().manual_seed(1),
        return_stats=True)
    assert len(got) == 9 and np.all((got >= 0) & (got < VOCAB))
    assert stats.proposed >= stats.accepted


def test_feed_verify_logits_match_jax(target):
    """The target's [kk+1, vocab] verify logits from _feed, appended after
    a prefill, equal JAX's _feed; so do the cache lengths."""
    jcfg, jparams, cfg, params = target
    prompt = _prompt(9, seed=4)
    feed = _prompt(5, seed=6)[0]
    _, jcache = jdec.prefill(jparams, jnp.asarray(prompt), jcfg, 64)
    jlg, jcache = jspec._feed(jparams, jcache, jnp.asarray(feed), jcfg)
    _, cache = prefill(params, torch.from_numpy(prompt).long(), cfg, 64)
    lg, cache = spec._feed(params, cache, torch.from_numpy(feed).long(), cfg)
    assert lg.shape == (len(feed), VOCAB)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                               atol=LOGITS_ATOL, rtol=0)
    assert cache.length == int(jcache.length) == 9 + len(feed)
