"""Port parity: burst_attn_tpu_torch.ops.flash (plain path on CPU) against
the JAX package's Pallas flash forward (interpret mode) and its tile_fwd,
on the same numpy inputs, f32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.ops import masks as jmasks
from burst_attn_tpu.ops import pallas_flash as jflash
from burst_attn_tpu.ops import tile as jtile
from burst_attn_tpu_torch.ops import flash, masks, tile

ATOL = 1e-5  # f32 end to end; only summation order differs
# the raw accumulator is unnormalized (sums of up to S weighted rows, |acc|
# ~10 here), so its f32 rounding scales with magnitude: relative 1e-5 too
RTOL = 1e-5


def _inputs(seed, b, n, n_kv, s_q, s_kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, s_q, d), dtype=np.float32)
    k = rng.standard_normal((b, n_kv, s_kv, d), dtype=np.float32)
    v = rng.standard_normal((b, n_kv, s_kv, d), dtype=np.float32)
    return q, k, v


def _jspec(spec):
    return jmasks.MaskSpec(*(jnp.int32(x) for x in spec))


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


# (n, n_kv, s_q, s_kv, causal): GQA, ragged lengths, cross lengths
CASES = [
    (4, 4, 128, 128, True),
    (4, 2, 128, 128, True),
    (4, 2, 100, 100, True),
    (4, 1, 96, 160, False),
]


@pytest.mark.parametrize("n,n_kv,s_q,s_kv,causal", CASES)
def test_flash_fwd_empty_carry_matches_jax(n, n_kv, s_q, s_kv, causal):
    d, scale = 32, 32**-0.5
    q, k, v = _inputs(0, 1, n, n_kv, s_q, s_kv, d)
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    got = flash.flash_fwd(*map(torch.from_numpy, (q, k, v)), None, None,
                          None, scale, spec)
    want_kernel = jflash.flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, None, None,
        scale, _jspec(spec), block_q=64, block_kv=64, interpret=True)
    st = jtile.init_state(1, n, s_q, d)
    want_tile = jtile.tile_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               *st, scale, _jspec(spec))
    _close(got, want_kernel)
    _close(got, want_tile)


def test_flash_fwd_carry_in_matches_jax():
    """Two rounds: a full round from an empty carry, then a causal round
    folding into the carried (m, lse, acc) — vs the JAX kernel and tile."""
    n, n_kv, s, d = 4, 2, 128, 32
    scale = d**-0.5
    q, k1, v1 = _inputs(1, 1, n, n_kv, s, s, d)
    _, k2, v2 = _inputs(2, 1, n, n_kv, s, s, d)
    full = masks.full_spec(s, s)
    diag = masks.round_spec(0, 0, s, s, True, "contig")
    t = torch.from_numpy
    st = flash.flash_fwd(t(q), t(k1), t(v1), None, None, None, scale, full)
    got = flash.flash_fwd(t(q), t(k2), t(v2), *st, scale, diag)

    jq, jk1, jv1, jk2, jv2 = map(jnp.asarray, (q, k1, v1, k2, v2))
    kw = dict(block_q=64, block_kv=64, interpret=True)
    jst = jflash.flash_fwd(jq, jk1, jv1, None, None, None, scale,
                           _jspec(full), **kw)
    want = jflash.flash_fwd(jq, jk2, jv2, *jst, scale, _jspec(diag), **kw)
    _close(got, want)
    tst = jtile.tile_fwd(jq, jk1, jv1, *jtile.init_state(1, n, s, d), scale,
                         _jspec(full))
    _close(got, jtile.tile_fwd(jq, jk2, jv2, *tst, scale, _jspec(diag)))


def test_flash_fwd_masked_round_and_emit_o():
    """A contig future round (q_hi = 0) leaves every row empty: lse = -inf
    and the fused-finalize output is exactly 0, not NaN."""
    n, s, d = 2, 64, 32
    q, k, v = map(torch.from_numpy, _inputs(3, 1, n, n, s, s, d))
    spec = masks.round_spec(0, 1, s, s, True, "contig")
    assert spec.q_hi == 0
    m, lse, o = flash.flash_fwd(q, k, v, None, None, None, d**-0.5, spec,
                                emit_o=True)
    assert torch.isneginf(m).all() and torch.isneginf(lse).all()
    assert o.dtype == q.dtype and (o == 0).all()


@pytest.mark.parametrize("s,causal", [(128, True), (100, False)])
def test_flash_attention_matches_jax(s, causal):
    n, n_kv, d = 4, 2, 32
    q, k, v = _inputs(4, 2, n, n_kv, s, s, d)
    got = flash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), None, causal, block_q=64,
                                  block_kv=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    want_tile = jtile.single_device_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=1),
        jnp.repeat(jnp.asarray(v), 2, axis=1), causal=causal)
    np.testing.assert_allclose(
        tile.single_device_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal).numpy(),
        np.asarray(want_tile), atol=ATOL, rtol=0)


def test_round_spec_contig_matches_jax():
    for q_part, kv_part, causal in [(0, 0, True), (2, 1, True), (1, 2, True),
                                    (1, 2, False)]:
        got = masks.round_spec(q_part, kv_part, 48, 64, causal, "contig")
        want = jmasks.round_spec(jnp.int32(q_part), jnp.int32(kv_part), 48,
                                 64, causal, "contig")
        assert tuple(got) == tuple(int(x) for x in want)
        np.testing.assert_array_equal(
            masks.dense_mask(got, 48, 64).numpy(),
            np.asarray(jmasks.dense_mask(want, 48, 64)))


def test_unported_options_raise():
    q = torch.zeros(1, 2, 8, 32)
    spec = masks.full_spec(8, 8)
    # packed segments are ported: one segment is the unsegmented round,
    # and ids of the wrong shape raise
    ids = torch.zeros(1, 8, dtype=torch.int32)
    got = flash.flash_fwd(q + 1, q, q + 2, None, None, None, 1.0, spec,
                          segments=(ids, ids), emit_o=True)
    want = flash.flash_fwd(q + 1, q, q + 2, None, None, None, 1.0, spec,
                           emit_o=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="segment q ids"):
        flash.flash_fwd(q, q, q, None, None, None, 1.0, spec,
                        segments=(ids[:, :4], ids))
    with pytest.raises(ValueError, match="window"):
        flash.flash_fwd(q, q, q, None, None, None, 1.0, spec, window=0)
    # the ring's spec helpers take a window (contig, causal): the round is
    # the offset-form band; the load-balanced layouts refuse it
    assert masks.round_spec(2, 1, 8, 8, True, "contig", window=4) == \
        masks.MaskSpec(0, 8, 8, 1, 8)
    with pytest.raises(ValueError, match="contig"):
        masks.round_spec(0, 0, 8, 8, True, "zigzag", window=4)
    with pytest.raises(ValueError):
        flash.flash_fwd(q, q, q, torch.zeros(1, 2, 8), None, None, 1.0, spec)
