"""Port parity for an MoE model's expert axis of size > 1 (models/
transformer.py `_mlp_groups`, parallel/moe.py `moe_shard(axis=)`,
models/train.py's coupled dp groups) and for packed training on dp=2
sp=4, against the JAX package's jitted value_and_grad of `loss_fn` on
the same numpy weights (params_from_jax) and batch, fp32, CPU.

The cases are the JAX package's: tests/test_model.py's MoE model on
dp=2 sp=2 tp=2 with expert_axis="dp" (the exchange between the dp
groups), tests/test_pp_model.py's regular side of the pp x ep parity
({"ep": 2, "sp": 2}: the tokens replicated over ep), the experts on the
sequence axis ({"sp": 4}) and
tests/test_packed_training.py's packed dp=2 sp=4 step (burst and
ulysses).  Tolerances are the JAX tests': loss rtol 1e-5, gradients
rtol 1e-4 / atol 1e-5.  The port's gradients are the trainer's
(make_train_step at lr 0 without clipping), so the coupled groups'
all_reduce over dp and the experts' owner gradients are what is held."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu_torch.data import write_token_file
from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, Shards, init_params, param_leaves, params_from_jax,
    tree_leaves,
)
from burst_attn_tpu_torch.parallel import mesh as pmesh
from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

DIMS = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128)
MOE = dict(n_experts=4, moe_capacity_factor=1.25)
B, S = 2, 64
AUX_W = 0.01
LOSS_RTOL = 1e-5
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread (with JAX in the process the default threads
    ran these tiny ops several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    return JConfig(**DIMS, attn_backend="jnp", dtype=jnp.float32,
                   remat=False, **kw)


def _cfg(**kw):
    return ModelConfig(**DIMS, dtype=torch.float32, remat=False, **kw)


def _np_tree(cfg):
    return jax.tree.map(lambda t: t.numpy(),
                        init_params(cfg, seed=0, device="cpu"))


def _tokens(seed=3, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, DIMS["vocab"], (b, s + 1)).astype(np.int32)


def _jax_loss_grads(jcfg, sizes, tree, tok, packed=False):
    """JAX's loss and gradients (as the port's leaves, param_leaves
    order) of loss_fn on `sizes` (the conftest's host devices)."""
    n = int(np.prod(list(sizes.values())))
    jm = jtrain.make_mesh(sizes, devices=jax.devices()[:n])
    jb = jtrain.batch_from_host(tok[:, :-1], tok[:, 1:], jcfg, jm,
                                packed_eos_id=0 if packed else None)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, t, q, lab, seg: jtrain.loss_fn(
            p, t, q, lab, jcfg, jm, moe_aux_weight=AUX_W,
            segment_ids=seg)))(
        jax.tree.map(jnp.asarray, tree), jb["tokens"], jb["positions"],
        jb["labels"], jb.get("segment_ids"))
    return float(loss), list(param_leaves(params_from_jax(
        jax.tree.map(np.asarray, g), device="cpu")))


def _port_step(cfg, sizes, tree, tok, packed=False, tcfg=None):
    """One make_train_step on `sizes` from `tree` -> (loss, whole
    gradients in param_leaves order, collectives recorded, state, step,
    batch)."""
    tcfg = tcfg or train.TrainConfig(lr=0.0, weight_decay=0.0,
                                     grad_clip=1e9, moe_aux_weight=AUX_W)
    mesh = train.make_mesh(sizes)
    params = train.place_params(params_from_jax(tree, device="cpu"), cfg,
                                mesh)
    state = (params, train._optimizer(params, tcfg))
    step = train.make_train_step(cfg, tcfg, mesh, device="cpu")
    batch = train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg, mesh,
                                  packed_eos_id=0 if packed else None,
                                  device="cpu")
    with pmesh.record_collectives() as ev:
        state, m = step(state, batch)
    grads = [torch.cat([t.grad for t in x.parts], dim=x.dim)
             if isinstance(x, Shards) else x.grad.clone()
             for x in tree_leaves(params)]
    return float(m["loss"]), grads, ev, state, step, batch


def _close(got, want, what):
    (lg, gg), (lw, gw) = got, want
    np.testing.assert_allclose(lg, lw, rtol=LOSS_RTOL, err_msg=what)
    assert len(gg) == len(gw), what
    for i, (a, b) in enumerate(zip(gg, gw)):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   err_msg=f"{what}: leaf {i}", **GRAD)


@pytest.fixture(scope="module")
def moe_tree():
    return _np_tree(_cfg(**MOE))


def test_moe_experts_on_dp_match_jax(moe_tree):
    """tests/test_model.py's MoE model on dp=2 sp=2 tp=2 with
    expert_axis="dp" (capacity factor 1.25: choices drop): the routing
    slots of each (dp group, sp position) go to their experts' dp owner
    and back (all_to_all over dp), the replicated leaves' gradients are
    all_reduced over dp, the experts' are their owners'.  Loss and every
    gradient against JAX's, and equal to the port's expert_axis=None run
    on the same mesh (the same routing groups); three steps at lr 1e-3
    lower the loss and move the router, as JAX's test asserts."""
    sizes = {"dp": 2, "sp": 2, "tp": 2}
    tok = _tokens()
    want = _jax_loss_grads(_jcfg(**MOE, expert_axis="dp"), sizes, moe_tree,
                           tok)
    loss, grads, ev, *_ = _port_step(_cfg(**MOE, expert_axis="dp"), sizes,
                                     moe_tree, tok)
    _close((loss, grads), want, "expert_axis dp")
    kinds = {(c, a) for c, a, _ in ev}
    assert ("a2a", "dp") in kinds and ("all_reduce", "dp") in kinds
    # 2 layers x 2 sp positions x (to the owners and back)
    assert sum(c == "a2a" for c, _, _ in ev) == 2 * 2 * 2
    l0, g0, ev0, *_ = _port_step(_cfg(**MOE, expert_axis=None), sizes,
                                 moe_tree, tok)
    assert not any(c == "a2a" for c, _, _ in ev0)
    _close((loss, grads), (l0, g0), "against expert_axis None")
    tcfg = train.TrainConfig(lr=1e-3, moe_aux_weight=AUX_W)
    _, _, _, state, step, batch = _port_step(
        _cfg(**MOE, expert_axis="dp"), sizes, moe_tree, tok, tcfg=tcfg)
    router0 = moe_tree["layers"][0]["router"]
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert np.abs(state[0]["layers"][0]["router"].detach().numpy()
                  - router0).max() > 0


@pytest.mark.parametrize("axis,sizes,n_a2a", [
    ("ep", {"ep": 2, "sp": 2}, 2 * 2 * 2),
    ("sp", {"sp": 4}, 2 * 1 * 2),
], ids=["its-own", "on-sp"])
def test_moe_expert_axis_matches_jax(moe_tree, axis, sizes, n_a2a):
    """{"ep": 2, "sp": 2} (tests/test_pp_model.py's regular side): the
    tokens replicated over ep, each sequence position's slots exchanged
    between its two ep replicas; {"sp": 4} with the experts on the
    sequence axis: the four positions' slots exchanged among them.  Loss
    and every gradient against JAX's; the all_to_alls recorded (2 layers
    x the exchanges x to the owners and back)."""
    kw = dict(MOE, expert_axis=axis, batch_axis=None, head_axis=None)
    tok = _tokens(seed=4)
    want = _jax_loss_grads(_jcfg(**kw), sizes, moe_tree, tok)
    loss, grads, ev, *_ = _port_step(_cfg(**kw), sizes, moe_tree, tok)
    _close((loss, grads), want, f"experts on {axis}")
    assert sum(c == "a2a" and a == axis for c, a, _ in ev) == n_a2a


@pytest.mark.parametrize("strategy,layout", [("burst", "zigzag"),
                                             ("ulysses", "contig")])
def test_packed_dp_sp_train_step_matches_jax(strategy, layout):
    """tests/test_packed_training.py's packed step on dp=2 sp=4 (both
    strategies it parametrizes, remat on as there): loss and every
    gradient against JAX's on the same packed stream."""
    dims = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
                d_head=16, d_ff=128)
    kw = dict(attn_strategy=strategy, layout=layout, batch_axis="dp",
              head_axis=None)
    cfg = ModelConfig(**dims, dtype=torch.float32, remat=True, **kw)
    jcfg = JConfig(**dims, attn_backend="jnp", dtype=jnp.float32,
                   remat=True, **kw)
    tree = _np_tree(cfg)
    tok = train.packed_tokens(5, dims["vocab"], 2, 65)
    sizes = {"dp": 2, "sp": 4}
    want = _jax_loss_grads(jcfg, sizes, tree, tok, packed=True)
    loss, grads, *_ = _port_step(cfg, sizes, tree, tok, packed=True)
    _close((loss, grads), want, f"packed {strategy}")


def test_runner_experts_on_dp(tmp_path):
    """`--n-experts 4 --mesh dp=2,sp=2` trains from the CLI: the runner
    puts the expert axis on dp, as the JAX runner does, and checkpoints."""
    data = str(tmp_path / "tokens.batd")
    write_token_file(data, np.random.default_rng(7).integers(
        0, 128, size=16 * 65))
    runner.main(["--data", data, "--steps", "2", "--batch", "2",
                 "--seq-len", "64", "--vocab", "128", "--d-model", "64",
                 "--n-layers", "1", "--n-heads", "4", "--d-ff", "64",
                 "--n-experts", "4", "--mesh", "dp=2,sp=2", "--device",
                 "cpu", "--ckpt-dir", str(tmp_path / "c")])
    assert Checkpointer(str(tmp_path / "c")).steps() == [2]
