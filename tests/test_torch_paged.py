"""Port parity: burst_attn_tpu_torch.ops.paged_attention (plain path on
CPU) against the JAX package's paged decode kernel (interpret mode) and
its paged_decode_reference, on the same numpy inputs, f32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.ops import paged_attention as jpa
from burst_attn_tpu_torch.ops import paged_attention as pa

ATOL = 1e-5  # f32 end to end; only summation order differs


def _pool(seed, *, slots, n_pages, n_kv, page, d, width, group):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((slots, n_kv, group, d), dtype=np.float32)
    kp = rng.standard_normal((n_pages, n_kv, page, d), dtype=np.float32)
    vp = rng.standard_normal((n_pages, n_kv, page, d), dtype=np.float32)
    # distinct pages per sequence, like the allocator hands out
    table = (rng.permutation(n_pages - 1)[: slots * width] + 1).reshape(
        slots, width).astype(np.int32)
    return q, kp, vp, table


@pytest.mark.parametrize("group", [1, 4])
def test_paged_decode_matches_jax(group):
    page = 128
    q, kp, vp, table = _pool(0, slots=5, n_pages=20, n_kv=2, page=page, d=32,
                             width=3, group=group)
    # empty, partial first page, exact page boundary, multi-page + tail,
    # the whole table
    lengths = np.asarray([0, 37, page, 2 * page + 5, 3 * page], np.int32)
    args = (q, kp, vp, table, lengths)
    got = pa.paged_decode_attention(*map(torch.from_numpy, args))
    got_ref = pa.paged_decode_reference(*map(torch.from_numpy, args))
    want = jpa.paged_decode_attention(*map(jnp.asarray, args))
    want_ref = jpa.paged_decode_reference(*map(jnp.asarray, args))
    for g in (got, got_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_ref),
                                   atol=ATOL, rtol=0)
    # the empty sequence emits zeros, not NaN
    assert not torch.isnan(got).any()
    assert (got[0] == 0).all()


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quantize_tokens_matches_jax(name):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 2, 16, 32), dtype=np.float32)
    x[0, 0, 3] = 0.0  # a zero row keeps scale 1
    jdt = jpa.QUANT_DTYPES[name][0]
    tdt = pa.QUANT_DTYPES[name][0]
    q, s = pa.quantize_tokens(torch.from_numpy(x), dtype=tdt)
    jq, js = jpa.quantize_tokens(jnp.asarray(x), dtype=jdt)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.float().numpy(),
                                  np.asarray(jq).astype(np.float32))


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_quantized_paged_decode_matches_jax(name):
    """int8 / fp8 pools with per-token scales: the port's plain version
    against the JAX kernel (interpret mode; it rescales score and
    probability columns) and the JAX oracle (dequantizes first)."""
    page = 128
    q, kp, vp, table = _pool(2, slots=4, n_pages=16, n_kv=2, page=page, d=32,
                             width=3, group=4)
    lengths = np.asarray([0, 37, page + 1, 3 * page], np.int32)
    jdt = jpa.QUANT_DTYPES[name][0]
    k8, ks = jpa.quantize_tokens(jnp.asarray(kp), dtype=jdt)
    v8, vs = jpa.quantize_tokens(jnp.asarray(vp), dtype=jdt)
    tdt = pa.QUANT_DTYPES[name][0]
    tk8, tks = pa.quantize_tokens(torch.from_numpy(kp), dtype=tdt)
    tv8, tvs = pa.quantize_tokens(torch.from_numpy(vp), dtype=tdt)
    got = pa.paged_decode_attention(
        torch.from_numpy(q), tk8, tv8, torch.from_numpy(table),
        torch.from_numpy(lengths), k_scales=tks, v_scales=tvs)
    args = (jnp.asarray(q), k8, v8, jnp.asarray(table), jnp.asarray(lengths))
    want = jpa.paged_decode_attention(*args, k_scales=ks, v_scales=vs)
    want_ref = jpa.paged_decode_reference(*args, k_scales=ks, v_scales=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL,
                               rtol=0)
    # the JAX kernel rounds p * scale to bf16 before P.V
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)
    assert (got[0] == 0).all()


def test_unported_options_raise():
    q, kp, vp, table = map(torch.from_numpy, _pool(
        1, slots=1, n_pages=4, n_kv=1, page=128, d=32, width=1, group=1))
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        pa.paged_decode_attention(q, kp, vp, table, lengths, window=0)
    with pytest.raises(ValueError, match="together"):
        pa.paged_decode_attention(q, kp, vp, table, lengths,
                                  k_scales=lengths)
