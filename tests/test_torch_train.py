"""Port parity: the single-device trainer of burst_attn_tpu_torch (plain
attention on the CPU) against the JAX package's make_train_step on mesh
sp=1, same weights (params_from_jax), same numpy batch, fp32.

Tolerances: loss, grad_norm and gradients differ only by fp32 summation
order (rtol 1e-5 / 1e-4 with a 1e-6 absolute floor for the smallest
gradient entries).  After two AdamW steps a parameter moves by ~lr per
step whatever its gradient's size (the update is m / sqrt(v)), so the
rounding of a near-zero gradient can reach the parameter at the scale of
lr; the checks allow 1e-5 absolute against lr = 1e-3, and 1e-4 (a tenth
of one step) where two accumulation orders of the same gradients meet:
there one coordinate of 8192 with a near-zero gradient moved 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu.parallel import layouts as jlayouts
from burst_attn_tpu_torch.models import train
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, param_leaves, params_from_jax,
)
from burst_attn_tpu_torch.parallel import layouts

DIMS = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128)
B, S = 2, 64


def _jcfg(**kw):
    return JConfig(**DIMS, block_q=32, block_kv=32, attn_backend="jnp",
                   dtype=jnp.float32, batch_axis=None, head_axis=None, **kw)


def _cfg(**kw):
    return ModelConfig(**DIMS, dtype=torch.float32, batch_axis=None,
                       head_axis=None, **kw)


@pytest.fixture(scope="module")
def setup():
    mesh = jtrain.make_mesh({"sp": 1}, devices=jax.devices()[:1])
    tcfg = jtrain.TrainConfig(lr=1e-3)
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), _jcfg(), tcfg,
                                     mesh)
    params_np = jax.tree.map(np.asarray, jstate[0])
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, DIMS["vocab"], (B, S + 1)).astype(np.int32)
    return mesh, tcfg, params_np, tokens[:, :-1], tokens[:, 1:]


def _state(params_np, tcfg):
    params = params_from_jax(params_np, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_(True)
    return params, train._optimizer(params, tcfg)


def _jbatch(x, y, cfg, mesh):
    return jtrain.batch_from_host(x, y, cfg, mesh)


def _jleaves(tree):
    """JAX parameter tree leaves in the port's param_leaves order."""
    out = [tree["embed"]]
    for layer in tree["layers"]:
        out += [layer[k] for k in ("attn_norm", "wq", "wk", "wv", "wo",
                                   "mlp_norm", "w_gate", "w_up", "w_down")]
    return [np.asarray(a) for a in out + [tree["final_norm"],
                                           tree["lm_head"]]]


def test_param_leaves_order_matches_the_tree(setup):
    _, tcfg, params_np, _, _ = setup
    params = params_from_jax(params_np, device="cpu")
    for a, b in zip(param_leaves(params), _jleaves(params_np)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_loss_and_every_gradient_match_jax(setup):
    mesh, tcfg, params_np, x, y = setup
    jb = _jbatch(x, y, _jcfg(), mesh)
    jp = jax.tree.map(jnp.asarray, params_np)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t, pos, lab: jtrain.loss_fn(p, t, pos, lab, _jcfg(), mesh)
    ))(jp, jb["tokens"], jb["positions"], jb["labels"])
    params, _ = _state(params_np, tcfg)
    b = train.batch_from_host(x, y, _cfg(), device="cpu")
    loss = train.loss_fn(params, b["tokens"], b["positions"], b["labels"],
                         _cfg())
    grads = torch.autograd.grad(loss, list(param_leaves(params)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, w in zip(grads, _jleaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6)


def test_two_train_steps_match_jax(setup):
    mesh, tcfg, params_np, x, y = setup
    jstep = jtrain.make_train_step(_jcfg(), tcfg, mesh)
    jstate = (jax.tree.map(jnp.asarray, params_np),
              jtrain._optimizer(tcfg).init(
                  jax.tree.map(jnp.asarray, params_np)))
    step = train.make_train_step(_cfg(), tcfg, device="cpu")
    state = _state(params_np, tcfg)
    jb = _jbatch(x, y, _jcfg(), mesh)
    b = train.batch_from_host(x, y, _cfg(), device="cpu")
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    for p, w in zip(param_leaves(state[0]), _jleaves(jstate[0])):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-5)


def test_grad_clip_matches_optax(setup):
    """A grad_clip below the gradient norm: the clipped update equals
    optax's clip_by_global_norm (and grad_norm is the norm before it)."""
    mesh, _, params_np, x, y = setup
    tcfg = jtrain.TrainConfig(lr=1e-3, grad_clip=0.05)
    jstate = (jax.tree.map(jnp.asarray, params_np),
              jtrain._optimizer(tcfg).init(
                  jax.tree.map(jnp.asarray, params_np)))
    jstate, jm = jtrain.make_train_step(_jcfg(), tcfg, mesh)(
        jstate, _jbatch(x, y, _jcfg(), mesh))
    state, m = train.make_train_step(_cfg(), tcfg, device="cpu")(
        _state(params_np, tcfg),
        train.batch_from_host(x, y, _cfg(), device="cpu"))
    assert float(m["grad_norm"]) > 0.05
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    for p, w in zip(param_leaves(state[0]), _jleaves(jstate[0])):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-5)


def test_grad_accum_equals_the_full_batch(setup):
    """grad_accum=2 over a batch whose halves mask very differently gives
    the full-batch objective: loss, grad_norm and parameters (and the JAX
    accumulated step's loss)."""
    mesh, tcfg, params_np, x, y = setup
    x4, y4 = np.concatenate([x, x[::-1]]), np.concatenate([y, y[::-1]])
    y4[2:, 8:] = -1  # the second microbatch is mostly masked
    b = train.batch_from_host(x4, y4, _cfg(), device="cpu")
    out = {}
    for accum in (1, 2):
        t = jtrain.TrainConfig(lr=1e-3, grad_accum=accum)
        out[accum] = train.make_train_step(_cfg(), t, device="cpu")(
            _state(params_np, t), b)
    (s1, m1), (s2, m2) = out[1], out[2]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    for p, q in zip(param_leaves(s1[0]), param_leaves(s2[0])):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-4)
    t2 = jtrain.TrainConfig(lr=1e-3, grad_accum=2)
    jstate = (jax.tree.map(jnp.asarray, params_np),
              jtrain._optimizer(t2).init(jax.tree.map(jnp.asarray, params_np)))
    _, jm = jtrain.make_train_step(_jcfg(), t2, mesh)(
        jstate, _jbatch(x4, y4, _jcfg(), mesh))
    np.testing.assert_allclose(float(m2["loss"]), float(jm["loss"]),
                               rtol=1e-5)


def test_remat_on_equals_off(setup):
    _, tcfg, params_np, x, y = setup
    b = train.batch_from_host(x, y, _cfg(), device="cpu")
    grads = {}
    for remat in (True, False):
        params, _ = _state(params_np, tcfg)
        loss = train.loss_fn(params, b["tokens"], b["positions"],
                             b["labels"], _cfg(remat=remat))
        grads[remat] = torch.autograd.grad(loss, list(param_leaves(params)))
    for a, c in zip(grads[True], grads[False]):
        assert torch.equal(a, c)


def test_make_batch_is_seeded_and_shifted():
    a = train.make_batch(3, _cfg(), batch=2, seq=16, device="cpu")
    b = train.make_batch(3, _cfg(), batch=2, seq=16, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert (a["labels"][:, -1] == -1).all()
    assert torch.equal(a["positions"][0], torch.arange(16))


@pytest.mark.parametrize("layout", ["contig", "zigzag", "striped"])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_layouts_match_jax(layout, world):
    s = 32
    np.testing.assert_array_equal(layouts.seq_permutation(layout, s, world),
                                  jlayouts.seq_permutation(layout, s, world))
    np.testing.assert_array_equal(layouts.position_ids(layout, s, world),
                                  jlayouts.position_ids(layout, s, world))
    x = np.random.default_rng(0).standard_normal((2, 3, s, 4)).astype(
        np.float32)
    got = layouts.to_layout(torch.from_numpy(x), layout, world, axis=2)
    want = jlayouts.to_layout(jnp.asarray(x), layout, world, axis=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = layouts.from_layout(got, layout, world, axis=2)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        layouts.to_layout(x, layout, world, axis=2), np.asarray(want))
    if world == 1:
        assert np.array_equal(layouts.seq_permutation(layout, s, 1),
                              np.arange(s))


def test_ring_train_steps_match_jax_and_one_position(setup):
    """Two train steps on a ring of 4 positions (mesh {"sp": 4}, zigzag:
    attention through the ring forward and backward) against the JAX
    train step on a 4-device CPU mesh, and against the port's own step on
    one position from the same weights and batch."""
    _, tcfg, params_np, x, y = setup
    jmesh = jtrain.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    jstep = jtrain.make_train_step(_jcfg(), tcfg, jmesh)
    jstate = (jax.tree.map(jnp.asarray, params_np),
              jtrain._optimizer(tcfg).init(
                  jax.tree.map(jnp.asarray, params_np)))
    jb = _jbatch(x, y, _jcfg(), jmesh)
    out = {}
    for mesh in ({"sp": 4}, None):
        step = train.make_train_step(_cfg(), tcfg, mesh, device="cpu")
        state = _state(params_np, tcfg)
        b = train.batch_from_host(x, y, _cfg(), mesh, device="cpu")
        out[mesh is None] = [step(state, b)[1] for _ in range(2)], state
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
    (ring_m, ring_state), (one_m, one_state) = out[False], out[True]
    for other in (jm, one_m[1]):
        np.testing.assert_allclose(float(ring_m[1]["loss"]),
                                   float(other["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(ring_m[1]["grad_norm"]),
                                   float(other["grad_norm"]), rtol=1e-5)
    # the rings sum each gradient in another order than one position (and
    # than each other): the module docstring's 1e-4 where orders meet
    for p, w, o in zip(param_leaves(ring_state[0]), _jleaves(jstate[0]),
                       param_leaves(one_state[0])):
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=1e-4)
        np.testing.assert_allclose(p.detach().numpy(), o.detach().numpy(),
                                   rtol=0, atol=1e-4)


def test_unported_paths_raise():
    # dp and tp are ported (tests/test_torch_tp_train.py), and beside a
    # pipeline too (tests/test_torch_pp_mesh.py); an axis the model splits
    # no work over is refused
    for sizes in ({"dp": 2, "sp": 1}, {"sp": 4, "tp": 2},
                  {"pp": 2, "dp": 2}, {"pp": 2, "sp": 4, "tp": 2}):
        assert train.make_mesh(sizes) == sizes
    with pytest.raises(ValueError, match="splits no work"):
        train.make_mesh({"sp": 2, "xp": 2})
    # ring telemetry is ported: it takes one microbatch
    with pytest.raises(ValueError, match="grad_accum"):
        train.make_train_step(_cfg(), jtrain.TrainConfig(
            collect_devstats=True, grad_accum=2), device="cpu")
    # packed documents are ported: an all-EOS row is four documents of
    # one token, each without a target
    seg, pos, lab = train.packed_fields_np(np.zeros((1, 4), np.int32), 0)
    assert seg.tolist() == [[0, 1, 2, 3]] and pos.tolist() == [[0] * 4]
    assert lab.tolist() == [[-1] * 4]
    got = train.batch_from_host(np.zeros((1, 4)), np.zeros((1, 4)), _cfg(),
                                packed_eos_id=0, device="cpu")
    assert got["segment_ids"].tolist() == [[0, 1, 2, 3]]
    assert train.make_mesh({"sp": 1}) == {"sp": 1}
    assert train.make_mesh({"dp": 1, "sp": 4}) == {"dp": 1, "sp": 4}
