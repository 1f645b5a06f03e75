"""Port parity for packed segments on the ring: `burst_attn(segment_ids=)`
of burst_attn_tpu_torch, its output and the gradients of sum(o * g), on
the scan ring (the plain tiles, "jnp", and flash_fwd / flash_bwd's plain
versions, "auto") and the fused ring (the plain versions of kernels 8 and
9), against the JAX package's scan ring (backend="jnp", jitted, on the
conftest's 8-device CPU mesh) with the same ids; with max_segment_len on
a contig ring whose ids keep the promise (the untruncated result);
collect_stats with segments (o bitwise stats off, the JAX package's
tallies).  The JAX package's interpreted fused kernels are not used.

Tolerance: 2e-4, what tests/test_burst.py pins for the JAX ring with
segments against dense attention (the rings sum the same terms in
another order); the two port routes against each other 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import burst_attn_tpu as jbat
from burst_attn_tpu_torch import burst_attn, obs
from burst_attn_tpu_torch.ops import tile
from burst_attn_tpu_torch.parallel import layouts

TOL = dict(rtol=2e-4, atol=2e-4)


def _jmesh(shape):
    sizes = tuple(shape.values())
    devs = np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    return JMesh(devs, tuple(shape))


def _ids(seed, s, n_docs):
    """[1, s] int32 monotone document ids, boundaries mid-shard."""
    rng = np.random.default_rng(seed)
    cuts = np.zeros(s, np.int32)
    cuts[rng.choice(np.arange(1, s), n_docs - 1, replace=False)] = 1
    return np.cumsum(cuts)[None].astype(np.int32)


def _inputs(seed, n, n_kv, s, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, n, s, d)).astype(np.float32)
    k = rng.standard_normal((1, n_kv, s, d)).astype(np.float32)
    v = rng.standard_normal((1, n_kv, s, d)).astype(np.float32)
    g = rng.standard_normal((1, n, s, d)).astype(np.float32)
    return q, k, v, g


def _port(q, k, v, g, seg, shape, backend, **kw):
    """(o, dq, dk, dv) of the port's burst_attn on layout-order inputs."""
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = burst_attn(*xs, mesh=shape, seq_axes=tuple(shape), backend=backend,
                   segment_ids=torch.from_numpy(seg), **kw)
    (o * torch.from_numpy(g)).sum().backward()
    return [o.detach().numpy()] + [x.grad.numpy() for x in xs]


# (mesh, layout, causal, heads, kv heads, options): JAX's segment cases of
# tests/test_burst.py (contig, zigzag and striped on 8; a double ring
# (2, 4) with GQA; non-causal; case_split=False)
CASES = [
    ({"sp": 8}, "contig", True, 4, 4, {}),
    ({"sp": 8}, "zigzag", True, 4, 4, {}),
    ({"sp": 8}, "striped", True, 4, 4, {}),
    ({"inter": 2, "intra": 4}, "zigzag", True, 4, 2, {}),
    ({"sp": 8}, "contig", False, 4, 4, {}),
    ({"inter": 2, "intra": 4}, "zigzag", True, 4, 4,
     dict(case_split=False)),
    ({"sp": 4}, "zigzag", True, 4, 2, dict(optimize_bwd_comm=False)),
]


@pytest.mark.parametrize("shape,layout,causal,n,n_kv,kw", CASES)
def test_ring_segments_match_jax(shape, layout, causal, n, n_kv, kw):
    world = int(np.prod(list(shape.values())))
    s = 16 * world
    q, k, v, g = _inputs(world + len(kw), n, n_kv, s)
    seg = _ids(3, s, 3)
    ql, kl, vl, gl = (np.asarray(layouts.to_layout(torch.from_numpy(x),
                                                   layout, world, axis=2))
                      for x in (q, k, v, g))
    sl = np.asarray(layouts.to_layout(torch.from_numpy(seg), layout, world,
                                      axis=1))
    jm = _jmesh(shape)
    common = dict(causal=causal, layout=layout, **kw)

    def jloss(q, k, v):
        o = jbat.burst_attn(q, k, v, mesh=jm, seq_axes=tuple(shape),
                            backend="jnp", batch_axes=None, head_axes=None,
                            segment_ids=jnp.asarray(sl), **common)
        return jnp.sum(o * gl), o

    (_, jo), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(ql, kl, vl)
    want = [np.asarray(jo)] + [np.asarray(x) for x in jgrads]
    before = obs.counter_values()
    outs = {}
    for backend in ("jnp", "auto", "fused_ring"):
        outs[backend] = _port(ql, kl, vl, gl, sl, shape, backend, **common)
        for a, b, name in zip(outs[backend], want, ("o", "dq", "dk", "dv")):
            np.testing.assert_allclose(a, b, err_msg=f"{backend} {name}",
                                       **TOL)
    for a, b in zip(outs["fused_ring"], outs["jnp"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # the fused route ran the fused ring (its plain versions), both passes
    assert not any(key.startswith("burst.fused_fallback")
                   for key in obs.counter_deltas(before))
    # and everything equals one-position attention in natural order
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o1 = tile.single_device_attention(*xs, causal=causal,
                                      segment_ids=torch.from_numpy(seg))
    (o1 * torch.from_numpy(g)).sum().backward()
    for a, b in zip(outs["jnp"], [o1.detach()] + [x.grad for x in xs]):
        np.testing.assert_allclose(
            layouts.from_layout(torch.from_numpy(a), layout, world,
                                axis=2).numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("backend", ["jnp", "fused_ring"])
def test_max_segment_len_keeps_the_untruncated_result(backend):
    """A contig causal ring truncated by max_segment_len (documents of at
    most 20 tokens, promise 24, S_local 16: 2 live rounds of 4) gives
    the untruncated ring's output and gradients, and JAX's, with fewer
    scheduled rounds."""
    shape, s = {"sp": 4}, 64
    q, k, v, g = _inputs(9, 4, 2, s)
    seg = (np.arange(s)[None] // 20).astype(np.int32)
    kw = dict(causal=True, layout="contig")
    jm = _jmesh(shape)

    def jloss(q, k, v):
        o = jbat.burst_attn(q, k, v, mesh=jm, seq_axes=("sp",),
                            backend="jnp", batch_axes=None, head_axes=None,
                            segment_ids=jnp.asarray(seg), max_segment_len=24,
                            **kw)
        return jnp.sum(o * g), o

    (_, jo), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    rounds = {}
    outs = {}
    for msl in (None, 24):
        before = obs.counter_values()
        outs[msl] = _port(q, k, v, g, seg, shape, backend,
                          max_segment_len=msl, **kw)
        rounds[msl] = obs.counter_deltas(before)["burst.ring_rounds"]
    assert rounds[24] < rounds[None], rounds
    for a, b, c in zip(outs[24], outs[None],
                       [np.asarray(jo)] + [np.asarray(x) for x in jgrads]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a, c, **TOL)


@pytest.mark.parametrize("backend", ["jnp", "fused_ring"])
def test_collect_stats_with_segments(backend):
    """collect_stats with segments: o bitwise that of stats off, the
    tallies the mask scalars give (segment occupancy is not counted, as
    in the JAX package: its DevStats counts)."""
    shape, world = {"sp": 4}, 4
    x = _inputs(5, 2, 2, 64)[0]
    seg = _ids(6, 64, 3)
    kw = dict(causal=True, layout="zigzag", mesh=shape, backend=backend,
              segment_ids=torch.from_numpy(seg))
    t = torch.from_numpy(x)
    o, st = burst_attn(t, t, t, collect_stats=True, **kw)
    assert torch.equal(o, burst_attn(t, t, t, **kw))
    jm = _jmesh(shape)
    _, jst = jax.jit(lambda q: jbat.burst_attn(
        q, q, q, mesh=jm, seq_axes=("sp",), backend="jnp", batch_axes=None,
        head_axes=None, collect_stats=True, causal=True, layout="zigzag",
        segment_ids=jnp.asarray(seg)))(x)
    for f in ("rounds", "rounds_live", "attn_pairs", "total_pairs"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert float(st.attn_pairs.sum()) == 64 * 65 // 2
