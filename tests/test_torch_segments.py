"""Port parity for packed sequences (segment ids): the plain tiles, the
flash wrappers (their plain versions on the CPU) and flash_attention of
burst_attn_tpu_torch against the JAX package's tile_fwd / tile_bwd, its
Pallas flash kernels in interpret mode and its flash_attention(
segment_ids=) custom VJP, on the same numpy inputs.  fp32 throughout; the
tolerance is the JAX package's own for segments (tests/test_segments.py):
2e-5, summation order alone differing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.ops import masks as jmasks
from burst_attn_tpu.ops import pallas_flash as jflash
from burst_attn_tpu.ops import tile as jtile
from burst_attn_tpu_torch.ops import flash, masks, tile

TOL = dict(atol=2e-5, rtol=2e-5)


def _packed_ids(seed, b, s, n_docs):
    """[b, s] int32 monotone document ids, n_docs documents a row."""
    rng = np.random.default_rng(seed)
    starts = np.zeros((b, s), np.int32)
    for i in range(b):
        starts[i, rng.choice(np.arange(1, s), n_docs - 1, replace=False)] = 1
    return np.cumsum(starts, axis=1).astype(np.int32)


def _inputs(seed, b, n, n_kv, s_q, s_kv, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n, s_q, d), dtype=np.float32)
    k = rng.standard_normal((b, n_kv, s_kv, d), dtype=np.float32)
    v = rng.standard_normal((b, n_kv, s_kv, d), dtype=np.float32)
    do = rng.standard_normal((b, n, s_q, d), dtype=np.float32)
    if s_q == s_kv:
        ids = _packed_ids(seed, b, s_q, 4)
        segs = (ids, ids)
    else:  # cross lengths: ids of their own, some q ids on no kv row
        segs = (_packed_ids(seed, b, s_q, 5), _packed_ids(seed + 1, b, s_kv,
                                                          3))
    return q, k, v, do, segs


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _jspec(spec):
    return jmasks.MaskSpec(*(jnp.int32(x) for x in spec))


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


# (n, n_kv, s_q, s_kv, causal, window): GQA, ragged and cross lengths,
# a window composed with the segments
CASES = [
    (4, 4, 128, 128, True, None),
    (4, 2, 100, 100, True, None),
    (4, 2, 128, 128, False, None),
    (4, 1, 96, 160, False, None),
    (4, 2, 128, 128, True, 24),
]


@pytest.mark.parametrize("n,n_kv,s_q,s_kv,causal,window", CASES)
def test_tile_fwd_segments_matches_jax(n, n_kv, s_q, s_kv, causal, window):
    q, k, v, _, segs = _inputs(0, 2, n, n_kv, s_q, s_kv)
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    got = tile.tile_fwd(*_t(q, k, v), *tile.init_state(2, n, s_q, 32),
                        32**-0.5, spec, window=window, segments=_t(*segs))
    want = jtile.tile_fwd(*_j(q, k, v), *jtile.init_state(2, n, s_q, 32),
                          32**-0.5, _jspec(spec), window=window,
                          segments=_j(*segs))
    _close(got, want)


@pytest.mark.parametrize("n,n_kv,s_q,s_kv,causal,window", CASES[:4])
def test_tile_bwd_segments_matches_jax(n, n_kv, s_q, s_kv, causal, window):
    q, k, v, do, segs = _inputs(1, 2, n, n_kv, s_q, s_kv)
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    m, lse, acc = jtile.tile_fwd(*_j(q, k, v), *jtile.init_state(
        2, n, s_q, 32), 32**-0.5, _jspec(spec), segments=_j(*segs))
    o = jtile.finalize(m, lse, acc, jnp.float32)
    delta = np.asarray(jnp.sum(o * jnp.asarray(do), -1))
    lse = np.asarray(lse)
    got = tile.tile_bwd(*_t(do, q, k, v, delta, lse), 32**-0.5, spec,
                        segments=_t(*segs))
    want = jtile.tile_bwd(*_j(do, q, k, v, delta, lse), 32**-0.5,
                          _jspec(spec), segments=_j(*segs))
    _close(got, want)


@pytest.mark.parametrize("n,n_kv,s_q,s_kv,causal,window",
                         [CASES[1], CASES[3], CASES[4]])
def test_flash_fwd_segments_matches_jax_kernel(n, n_kv, s_q, s_kv, causal,
                                               window):
    """flash_fwd(segments=) (the plain version on the CPU) against the JAX
    Pallas forward kernel, interpreted, with a carry-in round."""
    q, k, v, _, segs = _inputs(2, 1, n, n_kv, s_q, s_kv)
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    got = flash.flash_fwd(*_t(q, k, v), None, None, None, 32**-0.5, spec,
                          window=window, segments=_t(*segs), emit_o=True)
    want = jflash.flash_fwd(*_j(q, k, v), None, None, None, 32**-0.5,
                            _jspec(spec), block_q=64, block_kv=64,
                            interpret=True, window=window,
                            segments=_j(*segs), emit_o=True)
    _close(got, want)


@pytest.mark.parametrize("n,n_kv,s_q,s_kv,causal,window",
                         [CASES[1], CASES[3]])
def test_flash_bwd_segments_matches_jax_kernel(n, n_kv, s_q, s_kv, causal,
                                               window):
    q, k, v, do, segs = _inputs(3, 1, n, n_kv, s_q, s_kv)
    spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
    _, lse, o = flash.flash_fwd(*_t(q, k, v), None, None, None, 32**-0.5,
                                spec, segments=_t(*segs), emit_o=True)
    delta = (o * torch.from_numpy(do)).sum(-1).numpy()
    lse = lse.numpy()
    for fused in (None, False):
        got = flash.flash_bwd(*_t(do, q, k, v, delta, lse), 32**-0.5, spec,
                              fused=fused, segments=_t(*segs))
        _close(got, tile.tile_bwd(*_t(do, q, k, v, delta, lse), 32**-0.5,
                                  spec, segments=_t(*segs)))
    want = jflash.flash_bwd(*_j(do, q, k, v, delta, lse), 32**-0.5,
                            _jspec(spec), block_q=64, block_kv=64,
                            interpret=True, segments=_j(*segs))
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_segments_matches_jax(causal):
    """flash_attention(segment_ids=): output and the gradients of
    sum(o * do) against the JAX custom VJP (interpreted kernels)."""
    q, k, v, do, (ids, _) = _inputs(4, 1, 4, 2, 128, 128)
    xs = [t.requires_grad_() for t in _t(q, k, v)]
    o = flash.flash_attention(*xs, causal=causal,
                              segment_ids=torch.from_numpy(ids))
    (o * torch.from_numpy(do)).sum().backward()

    def f(q, k, v):
        return jflash.flash_attention(q, k, v, None, causal, 64, 64, 64, 64,
                                      segment_ids=jnp.asarray(ids))

    jo, vjp = jax.vjp(f, *_j(q, k, v))
    _close([o.detach()] + [x.grad for x in xs],
           [jo] + list(vjp(jnp.asarray(do))))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 20)])
def test_single_device_attention_segments_matches_jax(causal, window):
    q, k, v, _, (ids, _) = _inputs(5, 2, 4, 2, 100, 100)
    got = tile.single_device_attention(*_t(q, k, v), causal=causal,
                                       window=window,
                                       segment_ids=torch.from_numpy(ids))
    want = jtile.single_device_attention(*_j(q, k, v), causal=causal,
                                         window=window,
                                         segment_ids=jnp.asarray(ids))
    _close([got], [want])


def test_segments_with_window_forward_matches_jax():
    """A window composes with the segments in flash_attention's forward,
    and in its backward (the band of kernels 2-5): the gradients match
    jax.grad of the JAX flash_attention."""
    q, k, v, do, (ids, _) = _inputs(6, 1, 4, 4, 128, 128)
    xs = [t.requires_grad_() for t in _t(q, k, v)]
    o = flash.flash_attention(*xs, causal=True, window=40,
                              segment_ids=torch.from_numpy(ids))
    (o * torch.from_numpy(do)).sum().backward()

    def f(q, k, v):
        return jflash.flash_attention(q, k, v, None, True, 64, 64,
                                      window=40,
                                      segment_ids=jnp.asarray(ids))

    jo, vjp = jax.vjp(f, *_j(q, k, v))
    _close([o.detach()] + [x.grad for x in xs],
           [jo] + list(vjp(jnp.asarray(do))))


def test_packed_documents_equal_separate_documents():
    """Two documents packed into one row with segment ids give each
    document's attention alone, output and gradients."""
    q, k, v, do, _ = _inputs(7, 1, 4, 2, 160, 160)
    ids = torch.cat([torch.zeros(1, 64, dtype=torch.int32),
                     torch.ones(1, 96, dtype=torch.int32)], dim=1)
    xs = [t.requires_grad_() for t in _t(q, k, v)]
    o = flash.flash_attention(*xs, causal=True, segment_ids=ids)
    (o * torch.from_numpy(do)).sum().backward()
    for sl in (slice(0, 64), slice(64, 160)):
        ys = [t[:, :, sl].clone().requires_grad_() for t in _t(q, k, v)]
        oo = flash.flash_attention(*ys, causal=True)
        (oo * torch.from_numpy(do[:, :, sl])).sum().backward()
        _close([o[:, :, sl].detach()] + [x.grad[:, :, sl] for x in xs],
               [oo.detach()] + [y.grad for y in ys])


def test_segment_ids_are_checked():
    q = torch.zeros(1, 2, 8, 32)
    spec = masks.full_spec(8, 8)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv ids"):
        flash.flash_fwd(q, q, q, None, None, None, 1.0, spec,
                        segments=(ids, ids[:, :5]))
    with pytest.raises(ValueError, match="integers"):
        flash.flash_attention(q, q, q, segment_ids=ids.float())
    with pytest.raises(ValueError, match="s_q == s_kv"):
        flash.flash_attention(q, q[:, :, :4], q[:, :, :4], segment_ids=ids)
