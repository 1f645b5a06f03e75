"""Port parity for the int8 / fp8 ring payloads (`wire_dtype`):
`wire_quantize` bitwise against the JAX package's (payload and scale,
ties at .5 included); the scan ring with a wire dtype against JAX's
backend="jnp" wire ring at world 4 (jitted), forward and gradients; both
routes (the scan ring and kernels 8-9's plain versions) against the
dense ring over the topologies of tests/test_wire_quant.py (uni zigzag,
bidi striped, the double ring, the windowed contig ring, GQA,
optimize_bwd_comm on and off); `wire_round_bytes` against JAX's;
wire_dtype=None bitwise the dense call; the counters and quant_absmax.
Inputs are numpy-seeded, fp32 on the CPU.  The JAX package's fused wire
kernels are not run (their interpret tests fail on this JAX version).

Tolerances: TOL_FWD / TOL_GRAD of tests/test_wire_quant.py against the
dense ring (int8 0.04 / 0.25, fp8 0.2 / 1.5); against JAX's wire ring
the forward within 1e-5 (the same codes from the same k and v) and the
gradients within GRAD_JAX: fp8 ~2x the maximum measured here (1.3e-6);
int8 a tenth of TOL_GRAD, 0.025, since one int8 code of a dq hop flips
where the two packages' fp32 partial sums straddle a rounding boundary
(2 of 2048 dq entries, 0.0137 each measured here: one step of
max|dq| / 127)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import burst_attn_tpu as jbat
from burst_attn_tpu.parallel import ring as jring
from burst_attn_tpu.parallel import schedule as jsched
from burst_attn_tpu_torch import burst_attn, obs
from burst_attn_tpu_torch.parallel import layouts, ring, schedule

TOL_FWD = {"int8": 0.04, "fp8": 0.2}
TOL_GRAD = {"int8": 0.25, "fp8": 1.5}
GRAD_JAX = {"int8": 0.025, "fp8": 3e-6}
WORLD, N, D, SEQ = 4, 2, 16, 16  # tests/test_wire_quant.py's _qkv


def _qkv(seed=11, world=WORLD, n=N, kv_heads=None, layout="zigzag"):
    rng = np.random.default_rng(seed)
    s = SEQ * world
    shapes = [(1, n, s, D)] + [(1, kv_heads or n, s, D)] * 2
    return [layouts.to_layout(torch.from_numpy(
        rng.standard_normal(sh).astype(np.float32)), layout, world, axis=2)
        for sh in shapes]


def _run(qkv, world, wire, **kw):
    """(o, (dq, dk, dv)) of sum(o^2) through the port's burst_attn."""
    ts = [t.clone().requires_grad_() for t in qkv]
    o = burst_attn(*ts, mesh={"sp": world}, causal=True, wire_dtype=wire,
                   **kw)
    return o.detach(), torch.autograd.grad(o.square().sum(), ts)


def _err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_wire_quantize_bitwise_jax(wire):
    """Payload bytes and scales equal JAX's, per block of axes (2, 3) and
    of axis 2, with exact ties: a block whose amax maps to scale 1 holds
    .5 values (int8 rounds half to even) and midpoints of fp8 codes."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
    qmax = jring.WIRE_QMAX[wire]
    tie = ([0.5, 1.5, 2.5, -0.5, -2.5, 126.5] if wire == "int8"
           else [1.0625, 1.1875, -1.0625, 17.0, 272.0, -208.0])
    x[0, 0, 0, :len(tie)] = tie
    x[0, 0, 1, 0] = qmax  # this block's scale is exactly 1
    for axes in ((2, 3), (2,)):
        jq, js = jring.wire_quantize(jnp.asarray(x), wire, axes)
        tq, ts = ring.wire_quantize(torch.from_numpy(x), wire, axes)
        assert tq.dtype == ring.WIRE_TORCH[wire]
        np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                      np.asarray(jq).view(np.uint8))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        back = ring.wire_dequantize(tq, ts, torch.float32)
        np.testing.assert_array_equal(back.numpy(), np.asarray(
            jring.wire_dequantize(jq, js, jnp.float32)))
    assert float(ts[0, 0, 0, 0]) == 1.0  # the tie block
    assert ring.wire_quantize(torch.ones(2), None, (0,))[1] is None
    with pytest.raises(ValueError, match="int8"):
        ring.wire_quantize(torch.ones(2), "int4", (0,))


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_scan_ring_matches_jax_wire_ring(wire):
    """The port's scan ring with a wire dtype against JAX's backend="jnp"
    wire ring, zigzag causal at world 4, optimize_bwd_comm on and off."""
    q, k, v = _qkv()
    g = np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
    jm = JMesh(np.asarray(jax.devices()[:WORLD]), ("sp",))
    for opt in (True, False):
        common = dict(causal=True, layout="zigzag", wire_dtype=wire,
                      optimize_bwd_comm=opt)

        def jl(q, k, v):
            o = jbat.burst_attn(q, k, v, mesh=jm, backend="jnp",
                                batch_axes=None, head_axes=None, **common)
            return jnp.sum(o * g), o

        (_, jo), jg = jax.jit(jax.value_and_grad(
            jl, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(t.numpy()) for t in (q, k, v)))
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o = burst_attn(*ts, mesh={"sp": WORLD}, backend="jnp", **common)
        got = torch.autograd.grad((o * torch.from_numpy(g)).sum(), ts)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                   rtol=0, atol=1e-5)
        for name, a, b in zip(("dq", "dk", "dv"), got, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=GRAD_JAX[wire], err_msg=name)


# (layout, world, kv heads, options): tests/test_wire_quant.py's shapes
TOPOLOGIES = {
    "uni zigzag": ("zigzag", 4, None, {}),
    "bidi striped": ("striped", 4, None, dict(fused_topology="bidi")),
    "double": ("zigzag", 4, None, dict(fused_seq_factor=(2, 2))),
    "windowed contig": ("contig", 4, None, dict(window=20)),
    "gqa": ("zigzag", 4, 1, {}),
    "gqa no opt": ("zigzag", 4, 1, dict(optimize_bwd_comm=False)),
}


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_wire_against_dense_ring(name, wire):
    """Both routes with a wire dtype (the scan ring, and kernels 8-9's
    plain versions on the fused route) against the dense ring of the same
    route; the fused route's plain version also against the scan ring
    with the same wire: its forward is the scan ring's (the same codes,
    the own partition resident), its gradients differ by the dq scales'
    granularity (per 64-row q tile against per (batch, head))."""
    layout, world, kvh, kw = TOPOLOGIES[name]
    qkv = _qkv(world=world, kv_heads=kvh, layout=layout)
    kw = dict(kw, layout=layout)
    scan_wire = None
    for backend in ("jnp", "fused_ring"):
        before = obs.counter_values()
        o0, g0 = _run(qkv, world, None, backend=backend, **kw)
        o1, g1 = _run(qkv, world, wire, backend=backend, **kw)
        if backend == "fused_ring":  # no fallback: the fused route ran
            moved = obs.counter_deltas(before)
            assert not any(x.startswith("burst.fused_fallback")
                           for x in moved), moved
        assert _err(o1, o0) < TOL_FWD[wire], (backend, _err(o1, o0))
        for gn, a, b in zip(("dq", "dk", "dv"), g1, g0):
            assert _err(a, b) < TOL_GRAD[wire], (backend, gn, _err(a, b))
        if backend == "jnp":
            scan_wire = (o1, g1)
    assert _err(o1, scan_wire[0]) < 1e-5
    for a, b in zip(g1, scan_wire[1]):
        assert _err(a, b) < TOL_GRAD[wire]


def test_wire_round_bytes_match_jax():
    """The per-round byte derivation equals JAX's over a grid; int8 ships
    at most half the fp32 bytes, fp8 the same as int8."""
    for wire in (None, "int8", "fp8"):
        for pass_ in ("fwd", "bwd"):
            for b, n, n_kv, s, d in ((1, 4, 4, 128, 64), (2, 8, 2, 64, 128),
                                     (1, 32, 8, 8192, 128)):
                for opt in (True, False):
                    kw = dict(b=b, n=n, n_kv=n_kv, s=s, d=d, opt_comm=opt)
                    assert schedule.wire_round_bytes(pass_, wire, **kw) == \
                        jsched.wire_round_bytes(pass_, wire, **kw)
                    dense = sum(schedule.wire_round_bytes(
                        pass_, None, **kw).values())
                    if wire is not None:
                        assert sum(schedule.wire_round_bytes(
                            pass_, wire, **kw).values()) <= 0.5 * dense
    with pytest.raises(schedule.ScheduleError):
        schedule.wire_itemsize("int4")


def test_wire_none_bitwise_counters_and_quant_absmax():
    """wire_dtype=None is bitwise the call without it on both routes; the
    burst.wire_bytes counters advance by wire_round_bytes of the shard;
    collect_stats reports quant_absmax = max(|k|, |v|) of each position
    under a wire dtype (0 on the dense wire), on both routes, with the
    fused route's slot counters those of the dense run."""
    q, k, v = _qkv()
    for backend in ("jnp", "fused_ring"):
        o_a, g_a = _run((q, k, v), WORLD, None, backend=backend)
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o_b = burst_attn(*ts, mesh={"sp": WORLD}, causal=True,
                         backend=backend)
        g_b = torch.autograd.grad(o_b.square().sum(), ts)
        assert torch.equal(o_a, o_b.detach())
        for a, b in zip(g_a, g_b):
            assert torch.equal(a, b)
    before = obs.counter_values()
    _run((q, k, v), WORLD, "int8", backend="fused_ring")
    moved = obs.counter_deltas(before)
    s = q.shape[2] // WORLD
    fwd = schedule.wire_round_bytes("fwd", "int8", b=1, n=N, n_kv=N, s=s,
                                    d=D)
    bwd = schedule.wire_round_bytes("bwd", "int8", b=1, n=N, n_kv=N, s=s,
                                    d=D)
    assert moved["burst.wire_bytes{dir=kv,pass=fwd}"] == fwd["kv"]
    assert moved["burst.wire_bytes{dir=bundle,pass=bwd}"] == bwd["bundle"]
    assert moved["burst.wire_bytes{dir=dq,pass=bwd}"] == bwd["dq"]
    # position p holds the layout-order shard p of k and v
    want = torch.maximum(k.abs().reshape(1, N, WORLD, s, D).amax((0, 1, 3, 4)),
                         v.abs().reshape(1, N, WORLD, s, D).amax((0, 1, 3, 4)))
    stats = {}
    for backend in ("jnp", "fused_ring"):
        for wire in (None, "int8"):
            _, st = burst_attn(q, k, v, mesh={"sp": WORLD}, causal=True,
                               backend=backend, wire_dtype=wire,
                               collect_stats=True)
            stats[backend, wire] = st
            if wire is None:
                assert (st.quant_absmax == 0).all()
            else:
                np.testing.assert_array_equal(st.quant_absmax.numpy(),
                                              want.numpy())
    assert torch.equal(stats["fused_ring", "int8"].slot_use,
                       stats["fused_ring", None].slot_use)
    assert int(stats["fused_ring", "int8"].slot_use.sum()) == WORLD * WORLD
