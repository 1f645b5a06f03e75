"""Port parity for the MoE layers (parallel/moe.py) and the MoE model on
every path the JAX package takes it: `moe_apply` (dense, with drops,
expert-parallel over ep=4 emulated on one device, gradients),
`forward_with_aux` with drops at sp=1 and sp=2 (burst and ulysses), a
train step with the aux term, the fp32 greedy `generate`, both engines
and `dist_generate`, against the JAX package on the same numpy weights
(params_from_jax), fp32 on the CPU.

Tolerances: the reference's (tests/test_moe.py) 2e-4 for the layer,
logits within 2e-4, aux within fp32 rounding, dropped shares equal;
serving greedy tokens exact (capacity factor 64, after
tests/test_decode.py:98: the dense forward then drops nothing)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import forward_with_aux as j_forward_with_aux
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu.models.decode import generate as j_generate
from burst_attn_tpu.models.dist_decode import dist_generate as j_dist_generate
from burst_attn_tpu.parallel import moe as jmoe
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models import train
from burst_attn_tpu_torch.models.decode import generate
from burst_attn_tpu_torch.models.dist_decode import dist_generate
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    MOE_LAYER_KEYS, ModelConfig, forward, forward_with_aux, init_params,
    param_leaves, params_from_jax,
)
from burst_attn_tpu_torch.parallel import moe
from burst_attn_tpu_torch.serving import RaggedServeEngine, handoff_generate
from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

TOL = 2e-4
D, F, E = 16, 32, 8


@pytest.fixture(scope="module")
def layer():
    """MoE weights (the JAX init, std 0.02 as there: a router that
    spreads the tokens) and [2, 32, D] seeded normal tokens."""
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), D, F, E)
    x = np.random.default_rng(1).standard_normal((2, 32, D)).astype(
        np.float32)
    p = moe.MoEParams(*(torch.from_numpy(np.array(a)) for a in jp))
    return jp, p, x


CASES = {"ample": dict(top_k=2, capacity_factor=8.0, ep=None),
         "drops": dict(top_k=1, capacity_factor=0.05, ep=None),
         "ep4": dict(top_k=2, capacity_factor=8.0, ep=4),
         "ep4 drops": dict(top_k=2, capacity_factor=0.5, ep=4)}


def _apply(p, x, ep, pkg, **kw):
    if ep is None:
        return pkg.moe_apply(p, x, mesh=None, **kw)
    mesh = (Mesh(np.array(jax.devices()[:ep]), ("ep",)) if pkg is jmoe
            else {"ep": ep})
    return pkg.moe_apply(p, x, mesh=mesh, axis="ep", **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(layer, case):
    """y within 2e-4, aux within fp32 rounding, the dropped share equal;
    the drop cases drop (their dropped tokens' rows are zero)."""
    jp, p, x = layer
    kw = dict(CASES[case])
    ep = kw.pop("ep")
    jy, jaux, jdrop = jax.jit(lambda jp, x: _apply(jp, x, ep, jmoe, **kw))(
        jp, jnp.asarray(x))
    y, aux, dropped = _apply(p, torch.from_numpy(x), ep, moe, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(dropped) == float(jdrop)
    if "drops" in case:
        assert float(dropped) > 0.3
        assert int((y.reshape(-1, D).norm(dim=-1) == 0).sum()) > 0
    else:
        assert float(dropped) == 0.0


@pytest.mark.parametrize("ep", [None, 4])
def test_moe_grads_match_jax(layer, ep):
    """Gradients of sum(y^2) + 0.01 aux over the weights and the tokens
    (capacity factor 1.0: some choices drop), dense and ep=4."""
    jp, p, x = layer
    kw = dict(top_k=2, capacity_factor=1.0)

    def jloss(jp, x):
        y, aux, _ = _apply(jp, x, ep, jmoe, **kw)
        return jnp.sum(y ** 2) + 0.01 * aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in p]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux, _ = _apply(moe.MoEParams(*leaves), xt, ep, moe, **kw)
    (y.square().sum() + 0.01 * aux).backward()
    for name, t, want in zip(moe.MoEParams._fields + ("x",),
                             leaves + [xt], list(jg) + [jgx]):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0, name
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=TOL,
                                   atol=TOL * float(np.abs(want).max()),
                                   err_msg=name)


def test_capacity_for_and_refusals(layer):
    for tokens in (1, 7, 64, 2048, 8192):
        for e, k, cf in ((8, 2, 1.25), (4, 1, 0.05), (8, 2, 4.0),
                         (16, 4, 64.0)):
            assert moe.capacity_for(tokens, e, k, cf) == \
                jmoe.capacity_for(tokens, e, k, cf)
    assert moe.capacity_for(8192, 8, 2, 1.25) == 2560
    _, p, x = layer
    with pytest.raises(ValueError, match="divisible"):
        moe.moe_apply(p, torch.from_numpy(x), mesh={"ep": 3}, axis="ep")
    with pytest.raises(ValueError, match="divisible"):
        moe.moe_apply(p, torch.from_numpy(x[:, :30]), mesh={"ep": 4},
                      axis="ep")


DIMS = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=64, n_experts=4, moe_top_k=2)
B, S = 2, 64


def _jcfg(**kw):
    kw = dict(dict(attn_backend="jnp", dtype=jnp.float32, batch_axis=None,
                   head_axis=None, remat=False), **kw)
    return JConfig(**DIMS, **kw)


def _cfg(**kw):
    kw = dict(dict(dtype=torch.float32, batch_axis=None, head_axis=None),
              **kw)
    return ModelConfig(**DIMS, **kw)


@pytest.fixture(scope="module")
def model():
    """One set of weights for both packages: the port's numpy init (the
    JAX init draws op by op, seconds at this size), as JAX arrays too."""
    params = init_params(_cfg(), seed=0, device="cpu")
    np_params = jax.tree.map(lambda t: t.numpy(), params)
    return jax.tree.map(jnp.asarray, np_params), np_params


def test_params_from_jax_moe_leaves():
    """The MoE leaves keep their names, shapes and dtypes (router fp32,
    experts cfg.dtype); the port's own init has the same tree, and
    param_leaves puts the router after mlp_norm."""
    jtree = jax.tree.map(np.asarray, jax.jit(j_init_params, static_argnums=1)(
        jax.random.PRNGKey(0), JConfig(**dict(DIMS, n_layers=1),
                                       dtype=jnp.bfloat16)))
    params = params_from_jax(jtree, device="cpu")
    own = init_params(_cfg(dtype=torch.bfloat16), seed=0, device="cpu")
    assert jax.tree.structure(own["layers"][0]) == \
        jax.tree.structure(params["layers"][0])
    for got in (params, own):
        layer = got["layers"][0]
        assert set(layer) == set(MOE_LAYER_KEYS)
        assert tuple(layer["router"].shape) == (64, 4)
        assert tuple(layer["w_gate"].shape) == (4, 64, 64)
        assert tuple(layer["w_down"].shape) == (4, 64, 64)
        assert layer["router"].dtype == torch.float32
        assert layer["w_up"].dtype == torch.bfloat16
    leaves = list(param_leaves(params))
    assert len(leaves) == 1 + len(MOE_LAYER_KEYS) + 2
    assert leaves[7] is params["layers"][0]["router"]
    np.testing.assert_array_equal(
        leaves[7].numpy(), jtree["layers"][0]["router"])
    np.testing.assert_array_equal(
        params["layers"][0]["w_gate"].float().numpy(),
        jtree["layers"][0]["w_gate"].astype(np.float32))


FWD_CASES = {"sp1": ("burst", "zigzag", 1),
             "sp2 burst": ("burst", "zigzag", 2),
             "sp2 ulysses": ("ulysses", "contig", 2)}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_forward_with_aux_matches_jax(model, case):
    """With drops (capacity factor 0.5): every ring / Ulysses position
    routes its own S/W slice of the layout-order tokens, as the JAX
    model's shard_map does; logits within 2e-4, aux within fp32
    rounding.  At sp=2 the groups change the drops, so the logits differ
    from one group's."""
    jparams, np_params = model
    strategy, layout, sp = FWD_CASES[case]
    kw = dict(attn_strategy=strategy, layout=layout, moe_capacity_factor=0.5)
    jcfg, cfg = _jcfg(**kw), _cfg(**kw)
    jmesh = jtrain.make_mesh({"sp": sp}, devices=jax.devices()[:sp])
    tokens = np.random.default_rng(3).integers(
        0, DIMS["vocab"], (B, S + 1)).astype(np.int32)
    jb = jtrain.batch_from_host(tokens[:, :-1], tokens[:, 1:], jcfg, jmesh)
    jlogits, jaux = jax.jit(lambda p, t, pos: j_forward_with_aux(
        p, t, pos, jcfg, jmesh))(jparams, jb["tokens"], jb["positions"])
    params = params_from_jax(np_params, device="cpu")
    b = train.batch_from_host(tokens[:, :-1], tokens[:, 1:], cfg,
                              {"sp": sp}, device="cpu")
    with torch.no_grad():
        logits, aux = forward_with_aux(params, b["tokens"], b["positions"],
                                       cfg, {"sp": sp})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if sp > 1:
        with torch.no_grad():
            one, _ = forward_with_aux(params, b["tokens"], b["positions"],
                                      cfg, None)
        assert not torch.allclose(one, logits, atol=1e-3)


def test_moe_train_step_with_aux_matches_jax(model, tmp_path):
    """One AdamW step at grad_accum 2 (the aux term rides each
    microbatch): loss and grad norm within 1e-5 of JAX's, every
    parameter within 1e-4 after the step; a Checkpointer round trip
    keeps the MoE leaves and the optimizer state."""
    _, np_params = model
    jcfg, cfg = _jcfg(), _cfg()
    tcfg = jtrain.TrainConfig(lr=1e-3, grad_accum=2, moe_aux_weight=0.1)
    jmesh = jtrain.make_mesh({"sp": 1}, devices=jax.devices()[:1])
    tokens = np.random.default_rng(4).integers(
        0, DIMS["vocab"], (B, S + 1)).astype(np.int32)
    x, y = tokens[:, :-1], tokens[:, 1:]
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = (jparams, jtrain._optimizer(tcfg).init(jparams))
    jstate, jm = jtrain.make_train_step(jcfg, tcfg, jmesh)(
        jstate, jtrain.batch_from_host(x, y, jcfg, jmesh))
    params = params_from_jax(np_params, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_(True)
    state = (params, train._optimizer(params, train.TrainConfig(
        lr=1e-3, grad_accum=2, moe_aux_weight=0.1)))
    step = train.make_train_step(cfg, train.TrainConfig(
        lr=1e-3, grad_accum=2, moe_aux_weight=0.1), device="cpu")
    state, m = step(state, train.batch_from_host(x, y, cfg, device="cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    jnew = jax.tree.map(np.asarray, jstate[0])
    for got, want in zip(param_leaves(state[0]), param_leaves(
            params_from_jax(jnew, device="cpu"))):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                   rtol=0, atol=1e-4)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    (p2, _), step_no = ck.restore(1, cfg, train.TrainConfig(), device="cpu")
    assert step_no == 1
    for a, b in zip(param_leaves(state[0]), param_leaves(p2)):
        assert torch.equal(a.detach(), b.detach())


PROMPT, STEPS = 40, 6


@pytest.fixture(scope="module")
def greedy(model):
    """JAX's greedy generate of an MoE model (capacity factor 64) on two
    prompts of PROMPT tokens."""
    jparams, np_params = model
    prompts = np.random.default_rng(5).integers(
        1, DIMS["vocab"], (2, PROMPT)).astype(np.int32)
    want = np.asarray(j_generate(jparams, jnp.asarray(prompts),
                                 _jcfg(moe_capacity_factor=64.0),
                                 steps=STEPS, max_seq=PROMPT + STEPS))
    return prompts, want, params_from_jax(np_params, device="cpu")


def test_moe_generate_and_engines_token_exact(greedy):
    """The dense-cache generate, the ServeEngine, the synchronous and the
    pipelined (K=4) RaggedServeEngine and an early-exit draft engine all
    give JAX's greedy tokens, which the port's dense forward
    teacher-forces."""
    prompts, want, params = greedy
    cfg = _cfg(moe_capacity_factor=64.0)
    got = generate(params, torch.from_numpy(prompts), cfg, steps=STEPS,
                   max_seq=PROMPT + STEPS)
    assert got.tolist() == want.tolist()
    full = torch.from_numpy(np.concatenate([prompts, want], 1)).long()
    pos = torch.arange(full.shape[1] - 1)[None].expand(2, -1)
    with torch.no_grad():
        logits = forward(params, full[:, :-1], pos, cfg)
    assert logits[:, PROMPT - 1:].argmax(-1).tolist() == want.tolist()
    common = dict(slots=2, n_pages=8, page=128, max_pages_per_seq=2,
                  device="cpu")
    draft_cfg = ModelConfig(**dict(DIMS, n_layers=1), dtype=torch.float32,
                            batch_axis=None, head_axis=None,
                            moe_capacity_factor=64.0)
    draft = dict(params, layers=params["layers"][:1])
    engines = (ServeEngine(params, cfg, **common),
               ServeEngine(params, cfg, draft_params=draft,
                           draft_cfg=draft_cfg, spec_k=2, **common),
               RaggedServeEngine(params, cfg, chunk=16, **common),
               RaggedServeEngine(params, cfg, chunk=16, pipeline=True,
                                 multi_step=4, **common))
    for eng in engines:
        rids = [eng.submit(p, STEPS) for p in prompts]
        out = eng.run()
        assert [list(out[r]) for r in rids] == want.tolist(), type(eng)


def test_moe_dist_generate_and_handoff_match_jax(model):
    """dist_generate over sp=4 (zigzag) on the scan ring and the fused
    ring's plain version equals JAX's greedy tokens; the handoff (ring
    prefill into pool pages, page-sharded decode) gives the same."""
    jparams, np_params = model
    prompt = np.random.default_rng(6).integers(
        1, DIMS["vocab"], (1, 128)).astype(np.int32)  # a page
    jmesh = jtrain.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    want = np.asarray(j_dist_generate(jparams, jnp.asarray(prompt),
                                      _jcfg(), jmesh, steps=4))
    params = params_from_jax(np_params, device="cpu")
    for backend in ("jnp", "fused_ring"):
        cfg = _cfg(attn_backend=backend)
        got = dist_generate(params, torch.from_numpy(prompt), cfg,
                            {"sp": 4}, steps=4)
        assert got.tolist() == want.tolist(), backend
    cfg = _cfg()
    state, pool = pd.init_paged_state(cfg, slots=1, n_pages=8, page=128,
                                      max_pages_per_seq=8, device="cpu")
    toks, _ = handoff_generate(params, torch.from_numpy(prompt[0]), state,
                               pool, cfg, {"sp": 4}, steps=4)
    assert [int(t) for t in toks] == want[0].tolist()


def test_runner_cli_and_fit_with_moe_and_ulysses(tmp_path):
    """`--n-experts` trains an MoE model from the CLI, on one device and
    with an expert axis of size 2 (4 experts over ep=3 is JAX's
    ValueError); `fit` of a Ulysses MoE model on sp=2 checkpoints,
    resumes to the uninterrupted run's losses and evaluates."""
    from burst_attn_tpu_torch.data import write_token_file
    from burst_attn_tpu_torch.models import runner

    data = str(tmp_path / "tokens.batd")
    write_token_file(data, np.random.default_rng(7).integers(
        0, 128, size=16 * 65))
    argv = ["--data", data, "--steps", "1", "--seq-len", "64", "--vocab",
            "128", "--d-model", "64", "--n-layers", "1", "--n-heads", "4",
            "--d-ff", "64", "--n-experts", "4", "--device", "cpu"]
    runner.main(argv)
    runner.main(argv + ["--mesh", "ep=2,sp=1", "--ckpt-dir",
                        str(tmp_path / "ep")])
    assert Checkpointer(str(tmp_path / "ep")).steps() == [1]
    with pytest.raises(ValueError, match="not divisible"):
        runner.main(argv + ["--mesh", "ep=3,sp=1"])
    cfg = ModelConfig(**dict(DIMS, n_layers=1), attn_strategy="ulysses",
                      layout="contig", dtype=torch.float32, batch_axis=None,
                      head_axis=None)
    tcfg = train.TrainConfig(lr=1e-3)
    kw = dict(data_path=data, batch=1, seq_len=64, log_every=1,
              eval_data_path=data, eval_every=4, eval_batches=2)
    _, full = runner.fit(cfg, tcfg, runner.RunConfig(steps=4, **kw),
                         {"sp": 2}, device="cpu")
    ck = dict(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2, **kw)
    runner.fit(cfg, tcfg, runner.RunConfig(steps=2, **ck), {"sp": 2},
               device="cpu")
    _, resumed = runner.fit(cfg, tcfg, runner.RunConfig(steps=4, **ck),
                            {"sp": 2}, device="cpu")
    losses = {r["step"]: r["loss"] for r in full if "loss" in r}
    again = {r["step"]: r["loss"] for r in resumed if "loss" in r}
    assert sorted(again) == [3, 4]
    for s_ in again:
        np.testing.assert_allclose(again[s_], losses[s_], rtol=1e-6)
    assert [r for r in full if "eval_loss" in r]
