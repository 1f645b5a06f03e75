"""Port parity for Ulysses attention with tensor parallelism
(parallel/ulysses.py `head_axes`, the model's attn_strategy="ulysses" on
a tp mesh), against the JAX package's `ulysses_attn(head_axes="tp")` and
its jitted value_and_grad of `loss_fn` on a {"sp": 4, "tp": 2} mesh of
the conftest's host devices, fp32, CPU.

The op case is tests/test_ulysses.py's test_ulysses_with_tp_head_sharding
(16 heads over tp 2 and sp 4; 4 heads is the per-group divisibility
error); tolerances are that file's: forward 1e-4, gradients 2e-4; the
model's loss within 1e-5 and gradients rtol 1e-4 / atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu.parallel.ulysses import ulysses_attn as j_ulysses
from burst_attn_tpu_torch.models import train
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, Shards, init_params, param_leaves, params_from_jax,
    tree_leaves,
)
from burst_attn_tpu_torch.parallel import mesh as pmesh
from burst_attn_tpu_torch.parallel.ulysses import ulysses_attn

FWD_TOL, GRAD_TOL = 1e-4, 2e-4
MESH = {"sp": 4, "tp": 2}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nkv", [8, 16])
def test_ulysses_tp_op_matches_jax(nkv):
    """[1, 16, 256, 32] q (kv heads 16, or 8: GQA), causal: each tp
    group's 8 heads exchanged over sp=4 alone, one attention a sequence
    position over both groups' heads; output and (dq, dk, dv) of
    sum(o * do) against JAX's, and the exchanges recorded a tp group at a
    time; 4 heads (2 a tp group) do not divide by sp=4."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, 16, 256, 32), dtype=np.float32)
    k, v = (rng.standard_normal((1, nkv, 256, 32), dtype=np.float32)
            for _ in range(2))
    do = rng.standard_normal(q.shape, dtype=np.float32)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("sp", "tp"))

    def loss(q, k, v):
        o = j_ulysses(q, k, v, mesh=mesh, seq_axis="sp", causal=True,
                      backend="jnp", head_axes="tp")
        return jnp.sum(o * do), o

    (_, jo), jg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    with pmesh.record_collectives() as ev:
        o = ulysses_attn(qt, kt, vt, mesh=MESH, causal=True, backend="jnp",
                         head_axes="tp")
    (o * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), (qt, kt, vt), jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
    # q, k, v in and o out, a tp group each
    assert ev == [("a2a", "sp", None)] * 8
    bad = torch.zeros(1, 4, 256, 32)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attn(bad, bad, bad, mesh=MESH, head_axes="tp")


def test_ulysses_tp_model_step_matches_jax():
    """A 2-layer model (8 heads, 8 kv heads: 4 a tp group, 1 a position)
    with attn_strategy="ulysses" on {"sp": 4, "tp": 2}, parameters split
    over tp: the train step's loss and every gradient (joined over tp)
    against JAX's value_and_grad; the same model with 4 kv heads is the
    per-group divisibility ValueError before any layer runs."""
    dims = dict(vocab=128, d_model=64, n_layers=2, n_heads=8, n_kv_heads=8,
                d_head=16, d_ff=128)
    kw = dict(attn_strategy="ulysses", layout="contig", batch_axis=None,
              head_axis="tp")
    cfg = ModelConfig(**dims, dtype=torch.float32, remat=False, **kw)
    jcfg = JConfig(**dims, attn_backend="jnp", dtype=jnp.float32,
                   remat=False, **kw)
    tree = jax.tree.map(lambda t: t.numpy(),
                        init_params(cfg, seed=0, device="cpu"))
    tok = np.random.default_rng(3).integers(0, 128, (2, 65)).astype(
        np.int32)
    jm = jtrain.make_mesh(MESH, devices=jax.devices()[:8])
    jb = jtrain.batch_from_host(tok[:, :-1], tok[:, 1:], jcfg, jm)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, t, q, lab: jtrain.loss_fn(p, t, q, lab, jcfg, jm)))(
        jax.tree.map(jnp.asarray, tree), jb["tokens"], jb["positions"],
        jb["labels"])
    tcfg = train.TrainConfig(lr=0.0, weight_decay=0.0, grad_clip=1e9)
    params = train.place_params(params_from_jax(tree, device="cpu"), cfg,
                                MESH)
    state = (params, train._optimizer(params, tcfg))
    batch = train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg, MESH,
                                  device="cpu")
    _, m = train.make_train_step(cfg, tcfg, MESH, device="cpu")(state,
                                                                 batch)
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    want = list(param_leaves(params_from_jax(jax.tree.map(np.asarray, jg),
                                             device="cpu")))
    got = [torch.cat([t.grad for t in x.parts], dim=x.dim)
           if isinstance(x, Shards) else x.grad for x in tree_leaves(params)]
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"leaf {i}")
    gqa = ModelConfig(**dict(dims, n_kv_heads=4), dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match="divisible"):
        train.loss_fn(params, batch["tokens"], batch["positions"],
                      batch["labels"], gqa, MESH)
