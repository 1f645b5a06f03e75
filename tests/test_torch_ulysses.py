"""Port parity for Ulysses all-to-all attention (parallel/ulysses.py) and
the Ulysses model strategy, against the JAX package's `ulysses_attn`
(backend="jnp", jitted on a W-device CPU mesh) on the same numpy inputs.

The port's W positions share the CPU and run the plain tile ("jnp") or
flash_attention's plain versions ("auto", the kernels' route on a card).
Tolerances are the reference's (tests/test_ulysses.py): forward 1e-4,
gradients 2e-4; the fp32 train step's loss within 1e-5 and every
gradient within 1e-4 of its largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu.parallel.ulysses import ulysses_attn as j_ulysses
from burst_attn_tpu_torch.models import train
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, forward_with_aux, param_leaves, params_from_jax,
)
from burst_attn_tpu_torch.parallel.mesh import all_to_all
from burst_attn_tpu_torch.parallel.ulysses import ulysses_attn

FWD_TOL, GRAD_TOL = 1e-4, 2e-4


def _inputs(n, nkv, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, n, s, d), dtype=np.float32)
    k = rng.standard_normal((1, nkv, s, d), dtype=np.float32)
    v = rng.standard_normal((1, nkv, s, d), dtype=np.float32)
    do = rng.standard_normal((1, n, s, d), dtype=np.float32)
    return q, k, v, do


def _jax_ref(q, k, v, do, w, **kw):
    """JAX ulysses_attn's output and (dq, dk, dv) of sum(o * do), one jit."""
    mesh = Mesh(np.array(jax.devices()[:w]), ("sp",))

    def loss(q, k, v):
        o = j_ulysses(q, k, v, mesh=mesh, backend="jnp", **kw)
        return jnp.sum(o * do), o

    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in g]


def _port(q, k, v, do, w, backend, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = ulysses_attn(qt, kt, vt, mesh={"sp": w}, backend=backend, **kw)
    (o * torch.from_numpy(do)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


def _check(got, want):
    o, g = got
    np.testing.assert_allclose(o, want[0], rtol=FWD_TOL, atol=FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), g, want[1]):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("nkv", [8, 16])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(causal, nkv, w):
    """16 q heads over 8 or 16 kv heads (GQA group 2 or 1), W 4 and 8:
    the output and the gradients of both the plain tile and the kernels'
    route equal JAX's."""
    q, k, v, do = _inputs(16, nkv, 128, 32, seed=w + nkv + causal)
    want = _jax_ref(q, k, v, do, w, causal=causal)
    for backend in ("jnp", "auto"):
        _check(_port(q, k, v, do, w, backend, causal=causal), want)


@pytest.mark.parametrize("what", ["window", "segments"])
def test_ulysses_window_and_segments_match_jax(what):
    """The windowed case of tests/test_window.py:160 (W 2, window 24) and
    a packed row of three documents: both reach every position's local
    attention."""
    q, k, v, do = _inputs(4, 2, 128, 16, seed=5)
    if what == "window":
        kw = dict(causal=True, window=24)
        port_kw = kw
    else:
        ids = np.repeat(np.arange(3, dtype=np.int32), [50, 40, 38])[None]
        kw = dict(causal=True, segment_ids=jnp.asarray(ids))
        port_kw = dict(causal=True, segment_ids=torch.from_numpy(ids))
    want = _jax_ref(q, k, v, do, 2, **kw)
    for backend in ("jnp", "auto"):
        _check(_port(q, k, v, do, 2, backend, **port_kw), want)


def test_all_to_all_is_the_tiled_exchange():
    """Position p receives chunk p of every peer, concatenated in peer
    order, as fresh copies; a second exchange with the dims swapped
    restores the inputs."""
    parts = [torch.arange(24.).reshape(4, 6) + 100 * p for p in range(2)]
    out = all_to_all(parts, split_dim=0, concat_dim=1)
    assert [tuple(t.shape) for t in out] == [(2, 12), (2, 12)]
    for p in range(2):
        want = torch.cat([parts[q][2 * p:2 * p + 2] for q in range(2)], 1)
        assert torch.equal(out[p], want)
        assert out[p].data_ptr() not in {t.data_ptr() for t in parts}
    back = all_to_all(out, split_dim=1, concat_dim=0)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))
    with pytest.raises(ValueError, match="divide"):
        all_to_all([torch.zeros(3, 2)] * 2, split_dim=0, concat_dim=1)


DIMS = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
            d_head=16, d_ff=128)
B, S, SP = 1, 64, 4


def _cfg(**kw):
    kw = dict(dict(attn_strategy="ulysses", layout="contig",
                   dtype=torch.float32, batch_axis=None, head_axis=None),
              **kw)
    return ModelConfig(**DIMS, **kw)


def test_ulysses_refusals():
    q = torch.zeros(1, 4, 64, 16)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attn(q, q, q, mesh={"sp": 8})
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attn(q, q[:, :2], q[:, :2], mesh={"sp": 4})
    with pytest.raises(ValueError, match="causal"):
        ulysses_attn(q, q, q, mesh={"sp": 2}, window=8)
    # a tp head axis splits the heads into groups: 4 heads over tp 2 are
    # 2 a group, divisible by sp=2 (the same attention), not by sp=4
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attn(q, q, q, mesh={"sp": 4, "tp": 2}, head_axes="tp")
    x = torch.from_numpy(_inputs(4, 4, 64, 16, 5)[0])
    torch.testing.assert_close(
        ulysses_attn(x, x, x, mesh={"sp": 2, "tp": 2}, head_axes="tp"),
        ulysses_attn(x, x, x, mesh={"sp": 2}), rtol=1e-6, atol=1e-6)
    params = {"embed": torch.zeros(8, 8), "layers": []}
    tok = torch.zeros(1, 64, dtype=torch.long)
    for cfg, mesh, err, match in (
            (_cfg(layout="zigzag"), {"sp": 2}, ValueError, "contig"),
            (_cfg(seq_axes=("inter", "intra")), {"inter": 2, "intra": 2},
             ValueError, "single sequence axis"),
            (_cfg(attn_strategy="star"), {"sp": 2}, ValueError,
             "unknown attn_strategy"),
            (_cfg(head_axis="tp"), {"sp": 4, "tp": 2}, ValueError,
             "divisible")):
        with pytest.raises(err, match=match):
            forward_with_aux(params, tok, tok, cfg, mesh)
    with pytest.raises(ValueError, match="collect_stats requires"):
        forward_with_aux(params, tok, tok, _cfg(), {"sp": 2},
                         collect_stats=True)


def test_ulysses_train_step_matches_jax():
    """The fp32 loss and every parameter's gradient of a 2-layer model
    with attn_strategy="ulysses" over sp=4, against JAX's jitted
    value_and_grad on a 4-device mesh, and against the port's one
    position (the same function)."""
    jcfg = JConfig(**DIMS, attn_strategy="ulysses", layout="contig",
                   attn_backend="jnp", dtype=jnp.float32, batch_axis=None,
                   head_axis=None)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    jmesh = jtrain.make_mesh({"sp": SP}, devices=jax.devices()[:SP])
    tokens = np.random.default_rng(2).integers(
        0, DIMS["vocab"], (B, S + 1)).astype(np.int32)
    x, y = tokens[:, :-1], tokens[:, 1:]
    jb = jtrain.batch_from_host(x, y, jcfg, jmesh)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_fn(p, jb["tokens"], jb["positions"],
                                 jb["labels"], jcfg, jmesh)))(jparams)
    jflat = [np.asarray(jgrads["embed"])]
    for layer in jgrads["layers"]:
        jflat += [np.asarray(layer[k]) for k in (
            "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
            "w_up", "w_down")]
    jflat += [np.asarray(jgrads["final_norm"]), np.asarray(jgrads["lm_head"])]
    np_params = jax.tree.map(np.asarray, jparams)
    for mesh in ({"sp": SP}, None):
        cfg = _cfg()
        params = params_from_jax(np_params, device="cpu")
        leaves = list(param_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        b = train.batch_from_host(x, y, cfg, mesh, device="cpu")
        loss = train.loss_fn(params, b["tokens"], b["positions"],
                             b["labels"], cfg, mesh)
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        for g, want in zip(grads, jflat):
            tol = 1e-4 * float(np.abs(want).max())
            np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=tol)
