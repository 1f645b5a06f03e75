"""Port parity for the pipeline-parallel model beside dp, tp and ep
(models/pipeline_lm.py on a pp mesh with a batch, head or expert axis;
transformer.shard_params of the stacked tree; the stacked checkpoint
across tp sizes; the runner's `--mesh pp=2,tp=2,sp=2`), against the JAX
package's jitted value_and_grad of `loss_fn` and the port's own regular
path on the same numpy weights and batch, fp32, CPU.

The cases are tests/test_pp_model.py's: pp x dp x sp, pp x tp x sp
against the regular tp x sp path, pp x ep x sp MoE at m=1 against the
regular ep x sp path (m=2: finite, router gradients nonzero) and pp x tp
x sp MoE with expert_axis=None.  Sizes and tolerances are that file's:
vocab 128, d 64, 4 layers, S 32, loss rtol 1e-5, gradients rtol 1e-4 /
atol 1e-5.  The port's gradients are the trainer's (make_train_step at
lr 0 without clipping)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu_torch.data import write_token_file
from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.evaluate import make_eval_step
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, ShardedParams, Shards, init_params, param_leaves,
    params_from_jax, tree_leaves,
)
from burst_attn_tpu_torch.parallel import mesh as pmesh
from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

DIMS = dict(vocab=128, d_model=64, n_layers=4, n_heads=2, n_kv_heads=2,
            d_head=32, d_ff=128)
S = 32
AUX_W = 0.01
LOSS_RTOL = 1e-5
GRAD = dict(rtol=1e-4, atol=1e-5)
BASE = dict(attn_backend="jnp", remat=False, batch_axis=None,
            head_axis=None, seq_axes=("sp",))


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread (with JAX in the process the default threads
    ran these tiny ops several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(**kw):
    return JConfig(**dict(DIMS, **dict(BASE, dtype=jnp.float32, **kw)))


def _cfg(**kw):
    return ModelConfig(**dict(DIMS, **dict(BASE, dtype=torch.float32, **kw)))


def _pp(cfg, m=2, **kw):
    return dataclasses.replace(cfg, pp_axis="pp", pp_microbatches=m, **kw)


def _trees(moe):
    """(the list-of-layers numpy tree, the stacked one) of the port's
    seed-0 init."""
    params = init_params(_cfg(**(dict(n_experts=4) if moe else {})),
                         seed=0, device="cpu")
    flat = jax.tree.map(lambda t: t.numpy(), params)
    return flat, dict(flat, layers={
        k: np.stack([layer[k] for layer in flat["layers"]])
        for k in flat["layers"][0]})


@pytest.fixture(scope="module")
def dense():
    return _trees(False)


@pytest.fixture(scope="module")
def moe():
    return _trees(True)


def _tokens(b):
    return np.random.default_rng(1).integers(
        0, DIMS["vocab"], (b, S + 1)).astype(np.int32)


def _jax(jcfg, sizes, tree, b=2):
    n = int(np.prod(list(sizes.values())))
    jm = jtrain.make_mesh(sizes, devices=jax.devices()[:n])
    tok = _tokens(b)
    jb = jtrain.batch_from_host(tok[:, :-1], tok[:, 1:], jcfg, jm)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, t, q, lab: jtrain.loss_fn(p, t, q, lab, jcfg, jm,
                                            moe_aux_weight=AUX_W)))(
        jax.tree.map(jnp.asarray, tree), jb["tokens"], jb["positions"],
        jb["labels"])
    return float(loss), list(param_leaves(params_from_jax(
        jax.tree.map(np.asarray, g), device="cpu")))


def _port(cfg, sizes, tree, b=2):
    """One make_train_step at lr 0 -> (loss, whole gradients in
    param_leaves order); the collectives it recorded on `_port.events`."""
    tcfg = train.TrainConfig(lr=0.0, weight_decay=0.0, grad_clip=1e9,
                             moe_aux_weight=AUX_W)
    mesh = train.make_mesh(sizes)
    params = train.place_params(params_from_jax(tree, device="cpu"), cfg,
                                mesh)
    state = (params, train._optimizer(params, tcfg))
    tok = _tokens(b)
    batch = train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg, mesh,
                                  device="cpu")
    with pmesh.record_collectives() as ev:
        _, m = train.make_train_step(cfg, tcfg, mesh, device="cpu")(
            state, batch)
    _port.events = ev
    return float(m["loss"]), [
        torch.cat([t.grad for t in x.parts], dim=x.dim)
        if isinstance(x, Shards) else x.grad.clone()
        for x in tree_leaves(params)]


def _stacked(got):
    """A regular path's (loss, per-layer gradients) with the layers'
    gradients stacked per key, as the pp tree's leaves are."""
    loss, grads = got
    layer = grads[1:-2]
    per = len(layer) // DIMS["n_layers"]
    return loss, ([grads[0]] + [torch.stack(layer[j::per])
                                for j in range(per)] + grads[-2:])


def _close(got, want, what):
    (lg, gg), (lw, gw) = got, want
    np.testing.assert_allclose(lg, lw, rtol=LOSS_RTOL, err_msg=what)
    assert len(gg) == len(gw), what
    for i, (a, b) in enumerate(zip(gg, gw)):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   err_msg=f"{what}: leaf {i}", **GRAD)


def test_pp_dp_sp_train_step_matches_jax(dense):
    """tests/test_pp_model.py's pp=2 x dp=2 x sp=2 step (m=2, B4): each dp
    group its own pipeline, the gradients all_reduced over dp; loss and
    every gradient against JAX's."""
    _, stacked = dense
    sizes = {"pp": 2, "dp": 2, "sp": 2}
    want = _jax(_pp(_jcfg(batch_axis="dp")), sizes, stacked, b=4)
    got = _port(_pp(_cfg(batch_axis="dp")), sizes, stacked, b=4)
    _close(got, want, "pp dp sp")
    assert ("all_reduce", "dp") in {(c, a) for c, a, _ in _port.events}


def test_pp_tp_sp_matches_regular_and_jax(dense):
    """pp=2 x tp=2 x sp=2: the stacked leaves split over tp behind the
    stage dim (param_specs' pp branch), each stage's layers the regular
    Megatron block; loss and gradients (joined over tp) against the
    regular tp=2 x sp=2 path and against JAX."""
    flat, stacked = dense
    sizes = {"pp": 2, "tp": 2, "sp": 2}
    got = _port(_pp(_cfg(head_axis="tp")), sizes, stacked)
    assert ("all_reduce", "tp") in {(c, a) for c, a, _ in _port.events}
    _close(got, _stacked(_port(_cfg(head_axis="tp"), {"tp": 2, "sp": 2},
                               flat)), "against the regular path")
    _close(got, _jax(_pp(_jcfg(head_axis="tp")), sizes, stacked), "jax")


def test_pp_ep_moe_matches_regular(moe):
    """tests/test_pp_model.py's pp=2 x ep=2 x sp=2 MoE: at m=1 the routing
    groups are the regular {"ep": 2, "sp": 2} path's, so loss and
    gradients equal it; at m=2 (the groups are the microbatches') the
    loss is finite, the router's gradients nonzero, and both equal
    JAX's."""
    flat, stacked = moe
    cfg = _cfg(n_experts=4, expert_axis="ep")
    sizes = {"pp": 2, "ep": 2, "sp": 2}
    got = _port(_pp(cfg, m=1), sizes, stacked)
    assert ("a2a", "ep") in {(c, a) for c, a, _ in _port.events}
    _close(got, _stacked(_port(cfg, {"ep": 2, "sp": 2}, flat)),
           "m=1 against the regular path")
    loss2, grads2 = _port(_pp(cfg, m=2), sizes, stacked)
    router = grads2[7]  # embed, attn_norm, wq, wk, wv, wo, mlp_norm, router
    assert tuple(router.shape) == (4, 64, 4)
    assert np.isfinite(loss2) and torch.isfinite(router).all()
    assert float(router.abs().sum()) > 0
    _close((loss2, grads2), _jax(_pp(_jcfg(n_experts=4, expert_axis="ep"),
                                     m=2), sizes, stacked), "m=2 jax")


def test_pp_tp_moe_matches_regular(moe):
    """tests/test_pp_model.py's pp=2 x tp=2 x sp=2 MoE with
    expert_axis=None: the experts whole on every tp position (no tp sum
    on the MoE output), the attention's tp sums; loss and gradients
    equal the regular tp=2 x sp=2 path's."""
    flat, stacked = moe
    cfg = _cfg(n_experts=4, head_axis="tp")
    _close(_port(_pp(cfg, m=1), {"pp": 2, "tp": 2, "sp": 2}, stacked),
           _stacked(_port(cfg, {"tp": 2, "sp": 2}, flat)),
           "against the regular path")


def test_pp_experts_on_dp_match_jax(moe):
    """The pipeline with the expert axis on dp (pp=2 x dp=2 x sp=2, m=2):
    the two dp groups' ticks run in lockstep, each stage's MoE exchanging
    slots between them; loss and gradients against JAX's."""
    _, stacked = moe
    sizes = {"pp": 2, "dp": 2, "sp": 2}
    kw = dict(n_experts=4, expert_axis="dp", batch_axis="dp")
    got = _port(_pp(_cfg(**kw)), sizes, stacked, b=4)
    assert ("a2a", "dp") in {(c, a) for c, a, _ in _port.events}
    _close(got, _jax(_pp(_jcfg(**kw)), sizes, stacked, b=4), "jax")


def test_stacked_tp_checkpoint_and_runner(dense, tmp_path):
    """`--mesh pp=2,tp=2,sp=2` trains from the CLI and writes whole
    stacked tensors; the checkpoint restores split at tp=2 and whole at
    tp=1, evaluates alike (bf16) on both meshes and on pp=2 x dp=2 x sp=2,
    and a run resumed at tp=1 reaches the uninterrupted tp=2 run's losses
    within 1e-3."""
    data = str(tmp_path / "tokens.batd")
    write_token_file(data, np.random.default_rng(7).integers(
        0, DIMS["vocab"], size=16 * (S + 1)))
    cfg = _pp(_cfg(head_axis="tp", batch_axis="dp"))
    argv = ["--data", data, "--batch", "2", "--seq-len", str(S),
            "--vocab", "128", "--d-model", "64", "--n-layers", "4",
            "--n-heads", "2", "--d-ff", "128", "--device", "cpu",
            "--mesh", "pp=2,tp=2,sp=2", "--lr", "1e-3", "--log-every", "1"]
    runner.main(argv + ["--steps", "2", "--ckpt-dir", str(tmp_path / "c")])
    ck = Checkpointer(str(tmp_path / "c"))
    assert ck.steps() == [2]
    saved = torch.load(ck._path(2), weights_only=True)["params"]
    assert tuple(saved["layers"]["wq"].shape) == (4, 64, 2, 32)
    # the runner's model: bf16, remat, the zigzag ring, the kernels' route
    run_cfg = dataclasses.replace(cfg, batch_axis=None, remat=True,
                                  layout="zigzag", attn_backend="auto",
                                  dtype=torch.bfloat16)
    tcfg = train.TrainConfig(lr=1e-3)
    split, at = ck.restore_latest(run_cfg, tcfg, {"pp": 2, "tp": 2,
                                                  "sp": 2}, device="cpu")
    assert at == 2 and isinstance(split[0], ShardedParams)
    assert isinstance(split[0]["layers"]["wq"], Shards)
    whole, _ = ck.restore_latest(run_cfg, tcfg, {"pp": 2, "tp": 1,
                                                 "sp": 2}, device="cpu")
    assert not isinstance(whole[0], ShardedParams)
    tok = _tokens(4)
    nll = []
    for state, sizes, c in (
            (split, {"pp": 2, "tp": 2, "sp": 2}, run_cfg),
            (whole, {"pp": 2, "tp": 1, "sp": 2}, run_cfg),
            (whole, {"pp": 2, "dp": 2, "tp": 1, "sp": 2},
             dataclasses.replace(run_cfg, batch_axis="dp"))):
        b = train.batch_from_host(tok[:, :-1], tok[:, 1:], c, sizes,
                                  device="cpu")
        nll.append(float(make_eval_step(c, sizes)(state[0], b)[0]))
    # bf16 activations: the tp split changes the sums' rounding only
    np.testing.assert_allclose(nll[1:], [nll[0]] * 2, rtol=1e-2)
    hist = {}
    for name, extra in (("full", ["--steps", "4"]),
                        ("resumed", ["--steps", "4", "--ckpt-dir",
                                     str(tmp_path / "c"), "--mesh",
                                     "pp=2,sp=2"])):
        rows = []
        real = runner.fit

        def fit(*a, _rows=rows, **kw):
            state, h = real(*a, **kw)
            _rows.extend(h)
            return state, h

        runner.fit = fit
        try:
            runner.main(argv + extra)
        finally:
            runner.fit = real
        hist[name] = {r["step"]: r["loss"] for r in rows if "loss" in r}
    assert sorted(hist["resumed"]) == [3, 4]
    for s in (3, 4):
        np.testing.assert_allclose(hist["resumed"][s], hist["full"][s],
                                   rtol=1e-3)
