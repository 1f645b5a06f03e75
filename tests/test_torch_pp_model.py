"""Port parity for the pipeline-parallel model (models/pipeline_lm.py):
loss and gradients of the port's pp forward against the JAX package's
`pp_forward_with_aux` / `loss_fn` on the same stacked weights
(params_from_jax), the port's pp forward against its own regular path,
remat, MoE layers (ep size 1), packed segment ids, a window on a contig
ring, the JAX package's ValueErrors, the
stacked layout's helpers, a stacked checkpoint, the runner's `--mesh
pp=2,sp=2` and the serving refusal; fp32 on the CPU.

Sizes and tolerances are tests/test_pp_model.py's: vocab 128, d 64, 4
layers, seq 32, loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5.  The
JAX side runs jitted on the 8-device CPU mesh of conftest.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu.models.pipeline_lm import stack_layers as j_stack_layers
from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.decode import generate
from burst_attn_tpu_torch.models.dist_decode import dist_prefill
from burst_attn_tpu_torch.models.pipeline_lm import (
    stack_layers, unstack_layers,
)
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, forward_with_aux, init_params, param_leaves,
    params_from_jax,
)
from burst_attn_tpu_torch.serving import RaggedServeEngine
from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

DIMS = dict(vocab=128, d_model=64, n_layers=4, n_heads=2, n_kv_heads=2,
            d_head=32, d_ff=128)
B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD = dict(rtol=1e-4, atol=1e-5)


def _jcfg(**kw):
    base = dict(dtype=jnp.float32, attn_backend="jnp", remat=False,
                batch_axis=None, head_axis=None, seq_axes=("sp",))
    return JConfig(**dict(DIMS, **dict(base, **kw)))


def _cfg(**kw):
    base = dict(dtype=torch.float32, attn_backend="jnp", remat=False,
                batch_axis=None, head_axis=None, seq_axes=("sp",))
    return ModelConfig(**dict(DIMS, **dict(base, **kw)))


def _pp(cfg, m=2, **kw):
    return dataclasses.replace(cfg, pp_axis="pp", pp_microbatches=m, **kw)


@pytest.fixture(scope="module")
def weights():
    """The port's numpy init (4 layers) as a list-of-layers tree of numpy
    arrays, and the stacked numpy tree both packages' pp paths take."""
    params = init_params(_cfg(), seed=0, device="cpu")
    np_params = {k: (v.numpy() if torch.is_tensor(v) else
                     [{kk: t.numpy() for kk, t in layer.items()}
                      for layer in v]) for k, v in params.items()}
    stacked = dict(np_params, layers={
        k: np.stack([layer[k] for layer in np_params["layers"]])
        for k in np_params["layers"][0]})
    return np_params, stacked


def _tokens(seed=1, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, DIMS["vocab"], (b, s + 1)).astype(np.int32)


def _grads(params, batch, cfg, mesh, seg=None):
    """(loss, {leaf index: grad}) of the port's loss_fn."""
    leaves = list(param_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss = train.loss_fn(params, batch["tokens"], batch["positions"],
                         batch["labels"], cfg, mesh, segment_ids=seg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def test_pp_loss_and_grads_match_jax(weights):
    """{"pp": 2, "sp": 2}, m=2: loss and every gradient against jax.grad of
    the JAX package's loss_fn through pp_forward_with_aux."""
    _, stacked = weights
    jcfg, cfg = _pp(_jcfg()), _pp(_cfg())
    jmesh = jtrain.make_mesh({"pp": 2, "sp": 2}, devices=jax.devices()[:4])
    tok = _tokens()
    jb = jtrain.batch_from_host(tok[:, :-1], tok[:, 1:], jcfg, jmesh)
    jparams = jax.tree.map(jnp.asarray, stacked)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, t, pos, lab: jtrain.loss_fn(p, t, pos, lab, jcfg, jmesh)))(
        jparams, jb["tokens"], jb["positions"], jb["labels"])
    params = params_from_jax(stacked, device="cpu")
    assert isinstance(params["layers"], dict)
    b = train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg,
                              train.make_mesh({"pp": 2, "sp": 2}),
                              device="cpu")
    np.testing.assert_array_equal(b["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    loss, grads = _grads(params, b, cfg, {"pp": 2, "sp": 2})
    np.testing.assert_allclose(loss, float(jloss), rtol=LOSS_RTOL)
    want = list(param_leaves(params_from_jax(
        jax.tree.map(np.asarray, jg), device="cpu")))
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g, w.numpy(), err_msg=f"leaf {i}", **GRAD)


@pytest.mark.parametrize("mesh,m,remat", [
    ({"pp": 2, "sp": 1}, 1, False),
    ({"pp": 4, "sp": 1}, 2, False),
    ({"pp": 2, "sp": 2}, 2, True),
    ({"pp": 2, "inter": 2, "intra": 1}, 2, False),
])
def test_pp_matches_regular_path(weights, mesh, m, remat):
    """The port's pp loss and gradients equal its regular (pp=1) path on
    the same weights and batch: any stage count, microbatches, remat,
    the double ring's axes."""
    np_params, stacked = weights
    seq = ("inter", "intra") if "inter" in mesh else ("sp",)
    cfg = _cfg(seq_axes=seq, remat=remat)
    cfg_pp = _pp(cfg, m=m)
    ring = {a: n for a, n in mesh.items() if a != "pp"}
    tok = _tokens(2)
    b1 = train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg, ring,
                               device="cpu")
    l1, g1 = _grads(params_from_jax(np_params, device="cpu"), b1, cfg, ring)
    bp = train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg_pp, mesh,
                               device="cpu")
    lp, gp = _grads(params_from_jax(stacked, device="cpu"), bp, cfg_pp, mesh)
    np.testing.assert_allclose(lp, l1, rtol=LOSS_RTOL)
    # the regular leaves are per layer, the pp leaves per key stacked
    n_keys = len(stacked["layers"])
    per_layer = np.array(g1[1:-2], dtype=object).reshape(
        DIMS["n_layers"], n_keys)
    for j in range(n_keys):
        np.testing.assert_allclose(gp[1 + j], np.stack(per_layer[:, j]),
                                   err_msg=f"key {j}", **GRAD)
    for i in (0, -2, -1):
        np.testing.assert_allclose(gp[i], g1[i], **GRAD)


def test_pp_moe_matches_regular_and_jax(weights):
    """MoE layers (ep size 1, drops at capacity factor 0.5): at m=1 the pp
    forward equals the regular path (one routing group a ring position);
    at m=2 each microbatch routes alone, as JAX's pp does."""
    kw = dict(n_experts=4, moe_capacity_factor=0.5, expert_axis=None)
    cfg = _cfg(**kw)
    params = init_params(cfg, seed=3, device="cpu")
    stacked = dict(params, layers=stack_layers(params["layers"]))
    tok = _tokens(5)
    ring = {"sp": 2}
    with torch.no_grad():
        b = train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg, ring,
                                  device="cpu")
        want, aux = forward_with_aux(params, b["tokens"], b["positions"],
                                     cfg, ring)
        got, aux_pp = forward_with_aux(stacked, b["tokens"], b["positions"],
                                       _pp(cfg, m=1), {"pp": 2, "sp": 2})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_pp), float(aux), rtol=1e-6)
    # m=2 against JAX's pp on the same weights
    np_stacked = jax.tree.map(lambda t: t.numpy(), stacked)
    jcfg = _pp(_jcfg(**kw))
    jmesh = jtrain.make_mesh({"pp": 2, "sp": 2}, devices=jax.devices()[:4])
    jb = jtrain.batch_from_host(tok[:, :-1], tok[:, 1:], jcfg, jmesh)
    from burst_attn_tpu.models.pipeline_lm import pp_forward_with_aux

    jlogits, jaux = jax.jit(lambda p, t, pos: pp_forward_with_aux(
        p, t, pos, jcfg, jmesh))(jax.tree.map(jnp.asarray, np_stacked),
                                 jb["tokens"], jb["positions"])
    with torch.no_grad():
        got, aux2 = forward_with_aux(stacked, b["tokens"], b["positions"],
                                     _pp(cfg, m=2), {"pp": 2, "sp": 2})
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux2), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("case", ["packed", "window"])
def test_pp_segments_and_window(weights, case):
    """Packed segment ids travel with their microbatch; a window runs on
    the contig ring of each stage: the pp loss and gradients equal the
    regular path's."""
    np_params, stacked = weights
    extra = dict(layout="contig", window=12) if case == "window" else {}
    cfg = _cfg(**extra)
    ring = {"sp": 2}
    eos = 0 if case == "packed" else None
    tok = train.packed_tokens(7, DIMS["vocab"], B, S + 1)
    b1 = train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg, ring,
                               packed_eos_id=eos, device="cpu")
    seg = b1.get("segment_ids")
    if case == "packed":
        assert int(seg.max()) > 0
    l1, g1 = _grads(params_from_jax(np_params, device="cpu"), b1, cfg, ring,
                    seg)
    lp, gp = _grads(params_from_jax(stacked, device="cpu"), b1, _pp(cfg),
                    {"pp": 2, "sp": 2}, seg)
    np.testing.assert_allclose(lp, l1, rtol=LOSS_RTOL)
    for i in (0, -2, -1):
        np.testing.assert_allclose(gp[i], g1[i], **GRAD)


def test_pp_raises(weights):
    """JAX's checks raise ValueError, the expert axis's among them; dp, tp
    and ep beside the pp axis are meshes make_mesh takes (their parity:
    tests/test_torch_pp_mesh.py), an axis the model splits nothing over
    is a ValueError."""
    _, stacked = weights
    params = params_from_jax(stacked, device="cpu")
    tok = torch.zeros((B, S), dtype=torch.int64)
    pos = torch.arange(S).expand(B, S)
    bad = [(_pp(_cfg(), m=3), {"pp": 2, "sp": 1}, ValueError, "divisible"),
           (_pp(_cfg(n_layers=3)), {"pp": 2}, ValueError, "n_layers"),
           (_pp(_cfg()), {"sp": 2}, ValueError, "pp_axis"),
           (_pp(_cfg(attn_strategy="ulysses", layout="contig")),
            {"pp": 2, "sp": 1}, ValueError, "burst"),
           (_pp(_cfg(batch_axis="dp"), m=2), {"pp": 2, "dp": 2},
            ValueError, "per-dp-shard batch"),
           (_pp(_cfg(head_axis="tp", d_ff=127)), {"pp": 2, "tp": 2},
            ValueError, "d_ff"),
           (_pp(_cfg(n_experts=4, expert_axis="ep")), {"pp": 2, "ep": 3},
            ValueError, "not divisible"),
           (_pp(_cfg(n_experts=4, expert_axis="ep")), {"pp": 2},
            ValueError, "expert_axis"),
           (_pp(_cfg()), {"pp": 2, "xp": 2}, ValueError, "splits no work")]
    for cfg, mesh, exc, match in bad:
        with pytest.raises(exc, match=match):
            forward_with_aux(params, tok, pos, cfg, mesh)
    with pytest.raises(ValueError, match="collect_stats"):
        forward_with_aux(params, tok, pos, _pp(_cfg()), {"pp": 2, "sp": 2},
                         collect_stats=True)
    for mesh in ({"pp": 2, "dp": 2}, {"pp": 2, "tp": 2, "sp": 2},
                 {"pp": 4, "sp": 2}):
        assert train.make_mesh(mesh) == mesh


def test_stack_unstack_and_jax_layout(weights):
    """unstack_layers(stack_layers(x)) is x; the port's stacked init has
    the JAX pp init's tree (names, shapes, dtypes)."""
    np_params, _ = weights
    layers = params_from_jax(np_params, device="cpu")["layers"]
    back = unstack_layers(stack_layers(layers), len(layers))
    for a, b in zip(layers, back):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])
    jtree = jax.eval_shape(lambda: {"layers": j_stack_layers(
        [{k: jnp.zeros(v.shape, v.dtype) for k, v in layer.items()}
         for layer in np_params["layers"]])})
    own = init_params(_pp(_cfg()), seed=0, device="cpu")["layers"]
    assert set(own) == set(jtree["layers"])
    for k, v in own.items():
        assert tuple(v.shape) == tuple(jtree["layers"][k].shape), k


def test_stacked_checkpoint_and_train_step(tmp_path):
    """A pp train step on stacked params (AdamW and the clip over the
    stacked leaves) moves the weights; its checkpoint restores bitwise
    and the layer-count check reads the stacked leading dim."""
    cfg = _pp(_cfg())
    mesh = train.make_mesh({"pp": 2, "sp": 2})
    tcfg = train.TrainConfig(lr=1e-3)
    state = train.init_train_state(0, cfg, tcfg, mesh, device="cpu")
    w0 = state[0]["layers"]["wq"].detach().clone()
    step = train.make_train_step(cfg, tcfg, mesh, device="cpu")
    state, m = step(state, train.make_batch(1, cfg, mesh, batch=B, seq=S,
                                            device="cpu"))
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(w0, state[0]["layers"]["wq"])
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    (p2, _), n = ck.restore(1, cfg, tcfg, mesh, device="cpu")
    assert n == 1 and isinstance(p2["layers"], dict)
    for a, b in zip(param_leaves(state[0]), param_leaves(p2)):
        assert torch.equal(a.detach(), b.detach())
    with pytest.raises(ValueError, match="layers"):
        ck.restore(1, dataclasses.replace(cfg, n_layers=2), tcfg, mesh,
                   device="cpu")


def test_runner_pp_mesh(tmp_path):
    """`--mesh pp=2,sp=2 --microbatches 2` trains 2 steps and resumes from
    its stacked checkpoint; --microbatches without a pp axis exits with
    JAX's message."""
    from burst_attn_tpu_torch.data import write_token_file

    data = str(tmp_path / "tok.batd")
    write_token_file(data, np.random.default_rng(0).integers(
        0, 128, 4096).astype(np.int32))
    argv = ["--data", data, "--seq-len", "32", "--vocab", "128",
            "--d-model", "64", "--n-layers", "4", "--n-heads", "2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "c"),
            "--ckpt-every", "2", "--mesh", "pp=2,sp=2", "--microbatches",
            "2", "--batch", "2"]
    runner.main(argv + ["--steps", "2"])
    assert Checkpointer(str(tmp_path / "c")).steps() == [2]
    runner.main(argv + ["--steps", "3"])
    assert Checkpointer(str(tmp_path / "c")).steps() == [2, 3]
    with pytest.raises(SystemExit, match="microbatches"):
        runner.main(argv[:-6] + ["--microbatches", "2", "--steps", "1"])


def test_serving_refuses_pp(weights):
    """Every serving entry point refuses a pp config with a ValueError:
    the pipeline is a training path."""
    np_params, _ = weights
    params = params_from_jax(np_params, device="cpu")
    cfg = _pp(_cfg())
    prompt = torch.zeros((1, 8), dtype=torch.int64)
    calls = [
        lambda: ServeEngine(params, cfg, slots=1, n_pages=4, device="cpu"),
        lambda: RaggedServeEngine(params, cfg, slots=1, n_pages=4,
                                  device="cpu"),
        lambda: generate(params, prompt, cfg, steps=1, max_seq=16),
        lambda: dist_prefill(params, prompt, cfg, {"sp": 2}, gen_budget=1),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="training path"):
            call()
