"""Port parity for the ring telemetry (obs/devstats.py and burst_attn's
collect_stats): the scan ring's DevStats against the JAX package's
burst_attn(collect_stats=True) (jitted scan ring on the conftest's host
devices) for each layout, causal and not, single and double ring; outputs
and gradients bitwise equal with collect on and off; the fused ring's
plain version replaying the slot schedule (forward and backward); the
publish catalog; merge / cross_reduce; a train step with
collect_devstats.

Tolerance: counts exact; the float health fields (m_max, lse range) within
1e-5 of their magnitude (the rings sum in another order)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import burst_attn_tpu as jbat
from burst_attn_tpu.obs import devstats as jdevstats
from burst_attn_tpu.obs.registry import Registry as JRegistry
from burst_attn_tpu_torch import burst_attn, obs
from burst_attn_tpu_torch.models import train
from burst_attn_tpu_torch.models.transformer import ModelConfig
from burst_attn_tpu_torch.obs import devstats
from burst_attn_tpu_torch.obs.registry import Registry
from burst_attn_tpu_torch.ops import fused_ring, fused_ring_bwd, tuning
from burst_attn_tpu_torch.parallel import burst, ring

COUNTS = ("rounds", "rounds_live", "attn_pairs", "total_pairs", "flops",
          "nonfinite_lse", "nonfinite_acc", "fused_rounds", "rounds_elided",
          "slot_use", "slot_use_bwd", "slot_use_ccw", "slot_use_bwd_ccw",
          "quant_absmax")
FLOATS = ("m_max", "lse_min", "lse_max")


def _qkv(world, n=2, d=16, per=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, n, per * world, d)).astype(np.float32)


def _jstats(x, shape, **kw):
    """The JAX package's jitted scan ring with collect_stats."""
    sizes = tuple(shape.values())
    devs = np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    jm = JMesh(devs, tuple(shape))
    seq_axes = tuple(shape)
    o, st = jax.jit(lambda q: jbat.burst_attn(
        q, q, q, mesh=jm, seq_axes=seq_axes, backend="jnp", batch_axes=None,
        head_axes=None, collect_stats=True, **kw))(x)
    return np.asarray(o), jax.tree_util.tree_map(np.asarray, st)


def _stats_equal(got, want):
    for f in COUNTS:
        np.testing.assert_array_equal(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)),
            err_msg=f)
    for f in FLOATS:
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w,
                                   atol=1e-5 * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=f)


RING_CASES = [
    ({"sp": 4}, "zigzag", True), ({"sp": 4}, "striped", True),
    ({"sp": 4}, "contig", True), ({"sp": 4}, "zigzag", False),
    ({"sp": 4}, "contig", False),
    ({"inter": 2, "intra": 2}, "zigzag", True),
    ({"inter": 2, "intra": 2}, "contig", True),
]


@pytest.mark.parametrize("shape,layout,causal", RING_CASES,
                         ids=[f"{'x'.join(map(str, s.values()))}-{lay}-"
                              f"{'causal' if c else 'full'}"
                              for s, lay, c in RING_CASES])
def test_scan_ring_stats_match_jax(shape, layout, causal):
    """Every DevStats field of the port's scan ring equals the JAX
    package's, per ring position; the output too."""
    world = int(np.prod(list(shape.values())))
    x = _qkv(world)
    kw = dict(causal=causal, layout=layout)
    want_o, want = _jstats(x, shape, **kw)
    o, st = burst_attn(torch.from_numpy(x), torch.from_numpy(x),
                       torch.from_numpy(x), mesh=shape,
                       seq_axes=tuple(shape), backend="jnp",
                       collect_stats=True, **kw)
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5, rtol=0)
    assert st.rounds.shape == (world,)
    assert st.slot_use.shape == (world, devstats.MAX_SLOTS)
    _stats_equal(st, want)
    if causal:  # every position's pairs sum to the global triangle
        s = x.shape[2]
        assert float(st.attn_pairs.sum()) == s * (s + 1) // 2


@pytest.mark.parametrize("backend", ["jnp", "auto", "fused_ring"])
@pytest.mark.parametrize("layout", ["zigzag", "striped", "contig"])
def test_collect_is_bit_identical(backend, layout):
    """collect_stats changes nothing: the output and the gradients (the
    ring backward, fused or scan) are bitwise those of the plain call."""
    x = torch.from_numpy(_qkv(4, seed=1))
    kw = dict(mesh={"sp": 4}, causal=True, layout=layout, backend=backend)

    def run(collect):
        leaf = x.clone().requires_grad_()
        out = burst_attn(leaf, leaf, leaf, collect_stats=collect, **kw)
        o = out[0] if collect else out
        (o.float() ** 2).sum().backward()
        return o.detach(), leaf.grad

    o0, g0 = run(False)
    o1, g1 = run(True)
    assert torch.equal(o0, o1) and torch.equal(g0, g1)


@pytest.mark.parametrize("layout", ["zigzag", "striped"])
def test_fused_slot_use_matches_schedule(layout):
    """The fused ring's plain version counts each round's consume: every
    position replays the compiled slot schedule (bincount), the rounds
    are all fused, m stays inside the kernel (-inf), and the attended
    pairs equal the scan ring's."""
    world = 4
    x = torch.from_numpy(_qkv(world, seed=2))
    kw = dict(mesh={"sp": world}, causal=True, layout=layout)
    o, st = burst_attn(x, x, x, backend="fused_ring", collect_stats=True,
                       **kw)
    slots = min(tuning.resolve_fused(None, None, None).kv_slots, world)
    want = np.bincount(ring.fused_slot_schedule(world, slots),
                       minlength=devstats.MAX_SLOTS)
    assert (st.slot_use.numpy() == want[None, :]).all(), st.slot_use
    assert st.slot_use.sum(dim=1).tolist() == [world] * world
    assert (st.fused_rounds.numpy() == world).all()
    assert (st.m_max.numpy() == -np.inf).all()
    assert not st.nonfinite_lse.any() and not st.nonfinite_acc.any()
    _, st_scan = burst_attn(x, x, x, backend="jnp", collect_stats=True, **kw)
    assert float(st.attn_pairs.sum()) == float(st_scan.attn_pairs.sum())
    np.testing.assert_array_equal(st.attn_pairs.numpy(),
                                  st_scan.attn_pairs.numpy())


def test_fused_bwd_slot_use_direct_call():
    """fused_ring_bwd(collect_stats=True): the bundle consume counts
    replay the backward program (one consume a round); dq, dk, dv are
    bitwise the plain call's.  On the autograd path slot_use_bwd stays
    zero (a backward cannot hand telemetry to the forward's output)."""
    world = 4
    cfg = burst.BurstConfig(causal=True, layout="zigzag",
                            backend="fused_ring")
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(world, 1, 2, 16, 16, generator=g)
                   for _ in range(4))
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, 1, world)
    plain = fused_ring_bwd.fused_ring_bwd(q, k, v, o, lse, do, cfg, 1, world)
    *grads, slot_use = fused_ring_bwd.fused_ring_bwd(
        q, k, v, o, lse, do, cfg, 1, world, collect_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(plain, grads))
    prog = fused_ring.ring_plan(cfg, 1, world, 16, "bwd")[0]
    want = np.zeros((2, devstats.MAX_SLOTS), np.int64)
    for r in range(prog.n_rounds):
        want[prog.rows["consume_bank"][r], prog.rows["consume_slot"][r]] += 1
    assert (slot_use.numpy() == want[None]).all(), slot_use
    x = torch.from_numpy(_qkv(world, seed=4)).requires_grad_()
    o, st = burst_attn(x, x, x, mesh={"sp": world}, causal=True,
                       layout="zigzag", backend="fused_ring",
                       collect_stats=True)
    o.sum().backward()
    assert not st.slot_use_bwd.any() and st.slot_use.any()


def test_publish_catalog_matches_jax():
    """publish() lands the JAX package's names, labels and values: the
    same stats published by both packages give equal registry
    snapshots."""
    x = _qkv(4, seed=5)
    kw = dict(causal=True, layout="striped")
    _, want = _jstats(x, {"sp": 4}, **kw)
    _, st = burst_attn(*(torch.from_numpy(x),) * 3, mesh={"sp": 4},
                       backend="jnp", collect_stats=True, **kw)
    jreg = JRegistry()
    jdevstats.DevStats(*want).publish(jreg, labels={"layout": "striped"})
    reg = st.publish(Registry(), labels={"layout": "striped"})

    def key(r):
        return (r["kind"], r["name"], tuple(sorted(r["labels"].items())))

    got = {key(r): r.get("value") for r in reg.snapshot()}
    exp = {key(r): r.get("value") for r in jreg.snapshot()}
    assert set(got) == set(exp)
    for k_, v in exp.items():
        assert got[k_] == pytest.approx(v, rel=1e-5, abs=1e-6), k_
    assert reg.counter("devstats.publishes").get() == 1
    assert reg.gauge("devstats.flop_imbalance").get(layout="striped") > 1.0


def test_merge_and_cross_reduce_semantics():
    """merge folds layers: counts add, extrema max / min; cross_reduce
    does the same over replica dims; an empty dims tuple is a no-op."""
    ones = torch.ones((2, 2))
    a = devstats.ring_stats(4, 4, 10.0, 20.0, 8, ones, ones,
                            torch.ones((2, 2, 4)))
    b = devstats.ring_stats(4, 2, 6.0, 20.0, 8, 2 * ones, 3 * ones,
                            torch.ones((2, 2, 4)))
    m = devstats.merge(a, b)
    assert int(m.rounds) == 8 and int(m.rounds_live) == 6
    assert float(m.attn_pairs) == 16.0 and float(m.flops) == 16.0 * 32
    assert float(m.m_max) == 2.0
    assert float(m.lse_min) == 1.0 and float(m.lse_max) == 3.0
    both = devstats.DevStats(*(torch.stack([x, y]) for x, y in zip(a, b)))
    assert devstats.cross_reduce(both, ()) is both
    red = devstats.cross_reduce(both, (0,))
    for f in red._fields:
        assert torch.equal(getattr(red, f), getattr(m, f)), f
    one = devstats.expand_device_axis(a)
    assert one.rounds.shape == (1,) and one.slot_use.shape == (1, 8)


def test_nonfinite_detection():
    """-inf lse is a legal fully-masked row; nan and +inf are corruption,
    as is any non-finite accumulator entry."""
    lse = torch.tensor([0.0, float("nan"), float("-inf"), float("inf")])
    acc = torch.tensor([1.0, float("nan"), 2.0])
    st = devstats.ring_stats(1, 1, 1.0, 1.0, 8, torch.ones(2), lse, acc)
    assert int(st.nonfinite_lse) == 2 and int(st.nonfinite_acc) == 1
    assert float(st.lse_min) == 0.0 and float(st.lse_max) == 0.0


def test_train_step_collect_devstats_bitwise():
    """TrainConfig(collect_devstats=True) on a ring: the loss and the
    updated parameters are bitwise those of the stats-off step, the step
    publishes its DevStats (source=train) and metrics do not carry it."""
    cfg = ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=2,
                      n_kv_heads=1, d_head=16, d_ff=64, dtype=torch.float32,
                      batch_axis=None, head_axis=None, attn_backend="jnp")
    mesh = train.make_mesh({"sp": 4})
    batch = train.make_batch(0, cfg, mesh, batch=1, seq=64, device="cpu")
    out = {}
    pubs = obs.counter("devstats.publishes")
    for collect in (False, True):
        tcfg = train.TrainConfig(collect_devstats=collect)
        state = train.init_train_state(0, cfg, tcfg, mesh, device="cpu")
        step = train.make_train_step(cfg, tcfg, mesh, device="cpu")
        before = pubs.get()
        state, metrics = step(state, batch)
        assert set(metrics) == {"loss", "grad_norm"}
        assert pubs.get() - before == int(collect)
        out[collect] = (metrics["loss"], [t.detach().clone() for t in
                                          state[0]["layers"][0].values()])
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                  out[True][1]))
    # the published rounds: n_layers forward rings of 4 rounds a position
    assert obs.gauge("devstats.rounds").get(device=0, source="train") \
        == cfg.n_layers * 4
    with pytest.raises(ValueError, match="ring"):
        train.make_train_step(cfg, train.TrainConfig(collect_devstats=True),
                              None, device="cpu")(
            train.init_train_state(0, cfg, train.TrainConfig(),
                                   device="cpu"),
            train.make_batch(0, cfg, None, batch=1, seq=16, device="cpu"))
