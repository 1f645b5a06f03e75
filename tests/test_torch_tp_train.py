"""Port parity for training on a dp x sp x tp mesh whose positions share
one device (models/transformer.py, models/train.py, utils/checkpoint.py,
models/runner.py), against the JAX package's single-device forward and the
port's own single-device step, on the same weights (params_from_jax) and
numpy batch, fp32, CPU.

The model and sizes are tests/test_model.py's (and test_runner.py's for
`fit`).  The JAX package's own mesh tests hold its dp=2 sp=2 tp=2 forward
to its single-device forward at rtol = atol = 2e-4; the port is held to
the same single-device forward at the same tolerance, and to its own one
device: the mesh changes only the summation order of the row-parallel
partial sums and of the dp gradient mean."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import forward as j_forward
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models.train import make_mesh as j_make_mesh
from burst_attn_tpu_torch.data import write_token_file
from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, ShardedParams, forward_with_aux, param_leaves,
    params_from_jax, shard_params,
)
from burst_attn_tpu_torch.parallel import layouts
from burst_attn_tpu_torch.parallel import mesh as pmesh
from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

CFG = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128)
MESH = {"dp": 2, "sp": 2, "tp": 2}
RTOL = ATOL = 2e-4  # tests/test_model.py's dist-vs-single tolerance


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: with JAX in the same process, torch's default
    threads ran these tiny ops several times slower (analysis/core.py's
    _one_thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = JConfig(**CFG, block_q=32, block_kv=32, attn_backend="jnp",
                   dtype=jnp.float32, layout="contig")
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _cfg(**kw):
    return ModelConfig(**CFG, dtype=torch.float32, **kw)


def init_params_np(cfg):
    """The port's seed-0 init of `cfg` as a numpy tree (params_from_jax's
    input)."""
    from burst_attn_tpu_torch.models.transformer import init_params

    return jax.tree.map(lambda t: t.numpy(),
                        init_params(cfg, seed=0, device="cpu"))


def test_forward_matches_single_device(weights):
    """tests/test_model.py's first test: the dp=2 sp=2 tp=2 forward
    (zigzag ring, parameters split over tp, logits all_gathered) equals the
    single-device forward, un-permuted, and so does JAX's single-device
    forward on the same weights; the tp and dp collectives are recorded."""
    jcfg, jparams, np_params = weights
    cfg, cfg1 = _cfg(), _cfg(layout="contig")
    params = params_from_jax(np_params, device="cpu")
    b, seq, sp = 2, 64, MESH["sp"]
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (b, seq),
                                           0, cfg.vocab, jnp.int32))
    pos1 = np.broadcast_to(np.arange(seq, dtype=np.int32)[None], (b, seq))
    want = np.asarray(jax.jit(
        lambda p, t, q: j_forward(p, t, q, jcfg, j_make_mesh(
            {"dp": 1, "sp": 1, "tp": 1}, devices=jax.devices()[:1])))(
        jparams, jnp.asarray(tokens), jnp.asarray(pos1)))
    one = forward_with_aux(params, torch.from_numpy(tokens.copy()).long(),
                           torch.from_numpy(pos1.copy()).long(), cfg1)[0]
    perm = layouts.seq_permutation(cfg.layout, seq, sp)
    tok_l = torch.from_numpy(tokens[:, perm]).long()
    pos_l = torch.from_numpy(np.broadcast_to(perm[None], (b, seq)).copy())
    sharded = shard_params(params, cfg, MESH)
    with pmesh.record_collectives() as ev:
        logits = forward_with_aux(sharded, tok_l, pos_l.long(), cfg, MESH)[0]
    natural = torch.from_numpy(layouts.from_layout(logits.detach().numpy(),
                                                   cfg.layout, sp, axis=1))
    np.testing.assert_allclose(natural.numpy(), one.detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(natural.numpy(), want, rtol=RTOL, atol=ATOL)
    kinds = {(c, a) for c, a, _ in ev}
    assert ("all_reduce", "tp") in kinds and ("all_gather", "tp") in kinds
    # 2 layers x (wo, w_down) + the embedding, a dp group each
    assert sum(c == "all_reduce" for c, _, _ in ev) == 2 * (2 * 2 + 1)
    with pytest.raises(ValueError, match="shard_params"):
        forward_with_aux(params, tok_l, pos_l.long(), cfg, MESH)
    with pytest.raises(ValueError, match="not divisible"):
        forward_with_aux(sharded, tok_l[:1], pos_l[:1].long(), cfg, MESH)


def test_vocab_parallel_cross_entropy_matches():
    """The vocab-parallel nll (max, sum-exp and target logit all_reduced
    over the shards) and its gradient equal F.cross_entropy's, masked
    labels included."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(2, 5, 12, generator=g, requires_grad=True)
    labels = torch.randint(0, 12, (2, 5), generator=g)
    labels[0, 1] = -1
    got = train._vocab_parallel_nll(list(logits.chunk(3, dim=-1)),
                                    labels).sum()
    want = F.cross_entropy(logits.flatten(0, 1), torch.where(
        labels >= 0, labels, -100).flatten(), ignore_index=-100,
        reduction="sum")
    torch.testing.assert_close(got, want)
    g1, = torch.autograd.grad(got, logits)
    g2, = torch.autograd.grad(want, logits)
    torch.testing.assert_close(g1, g2)


def test_train_step_decreases_loss(weights):
    """tests/test_model.py's second test on the port: five steps on the dp=2
    sp=2 tp=2 mesh lower the loss; the first step's loss and grad norm
    equal one device's (the dp groups' gradients all_reduced by their
    mean), and every parameter after it too."""
    _, _, np_params = weights
    cfg, cfg1 = _cfg(), _cfg(layout="contig")
    tcfg = train.TrainConfig(lr=1e-2)
    mesh = train.make_mesh(MESH)
    state = (train.place_params(params_from_jax(np_params, device="cpu"),
                                cfg, mesh), None)
    state = (state[0], train._optimizer(state[0], tcfg))
    assert isinstance(state[0], ShardedParams)
    one = train.place_params(params_from_jax(np_params, device="cpu"), cfg1)
    one = (one, train._optimizer(one, tcfg))
    step = train.make_train_step(cfg, tcfg, mesh, device="cpu")
    step1 = train.make_train_step(cfg1, tcfg, device="cpu")
    batch = train.make_batch(1, cfg, mesh, batch=2, seq=64, device="cpu")
    batch1 = train.make_batch(1, cfg1, batch=2, seq=64, device="cpu")
    with pmesh.record_collectives() as ev:
        state, m = step(state, batch)
    one, m1 = step1(one, batch1)
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    n_leaves = len(list(param_leaves(state[0])))
    assert sum(c == "all_reduce" and a == "dp" for c, a, _ in ev) == \
        n_leaves + 1
    from burst_attn_tpu_torch.models.transformer import unshard_params
    for a, b in zip(param_leaves(unshard_params(state[0])),
                    param_leaves(one[0])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-4)
    losses = [float(m["loss"])]
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


def test_double_ring_model():
    """tests/test_model.py's double-ring case: {"inter": 2, "intra": 2,
    "tp": 2} trains a step (finite), at one device's loss."""
    cfg = _cfg(seq_axes=("inter", "intra"), batch_axis=None)
    mesh = train.make_mesh({"inter": 2, "intra": 2, "tp": 2})
    tcfg = train.TrainConfig()
    state = train.init_train_state(0, cfg, tcfg, mesh, device="cpu")
    step = train.make_train_step(cfg, tcfg, mesh, device="cpu")
    batch = train.make_batch(1, cfg, mesh, batch=2, seq=64, device="cpu")
    state, m = step(state, batch)
    cfg1 = _cfg(layout="contig", batch_axis=None)
    s1 = train.init_train_state(0, cfg1, tcfg, device="cpu")
    _, m1 = train.make_train_step(cfg1, tcfg, device="cpu")(
        s1, train.make_batch(1, cfg1, batch=2, seq=64, device="cpu"))
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                               rtol=1e-5)


def test_checkpoint_roundtrip_across_tp(tmp_path):
    """tests/test_checkpoint.py's round trip on the mesh: every leaf and the
    next step's loss bit-identical after a restore at tp=2; the file holds
    the whole tensors, so it restores at tp=1 (the same next loss to
    fp32 rounding) and that tp=1 save restores at tp=2 again."""
    cfg = dataclasses.replace(_cfg(), vocab=128, remat=False)
    tcfg = train.TrainConfig()
    mesh = train.make_mesh(MESH)
    state = train.init_train_state(0, cfg, tcfg, mesh, device="cpu")
    step = train.make_train_step(cfg, tcfg, mesh, device="cpu")
    batch = train.make_batch(1, cfg, mesh, batch=2, seq=32, device="cpu")
    state, _ = step(state, batch)
    ckpt = Checkpointer(str(tmp_path / "run"))
    ckpt.save(1, state)
    restored, at = ckpt.restore_latest(cfg, tcfg, mesh, device="cpu")
    assert at == 1 and isinstance(restored[0], ShardedParams)
    for a, b in zip(param_leaves(state[0]), param_leaves(restored[0])):
        assert torch.equal(a, b)
    flat = {"dp": 2, "sp": 2, "tp": 1}
    one, _ = ckpt.restore_latest(cfg, tcfg, flat, device="cpu")
    assert not isinstance(one[0], ShardedParams)
    _, m2 = step(restored, batch)
    _, m1 = step(state, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    _, m3 = train.make_train_step(cfg, tcfg, flat, device="cpu")(one, batch)
    np.testing.assert_allclose(float(m3["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    ckpt2 = Checkpointer(str(tmp_path / "flat"))
    ckpt2.save(2, one)
    again, _ = ckpt2.restore_latest(cfg, tcfg, mesh, device="cpu")
    assert again[0].tp == 2


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("tp_run") / "toks.batd"
    write_token_file(p, np.random.default_rng(1).integers(0, 512,
                                                          size=60_000))
    return str(p)


def test_fit_runs_and_logs(data_path, tmp_path):
    """tests/test_runner.py's mesh case: `fit` on dp=2 sp=2 tp=2 logs three
    finite losses near ln(512) and evaluates; the CLI takes the same mesh
    (`--mesh dp=2,sp=2,tp=2`) and checkpoints."""
    cfg = ModelConfig(vocab=512, d_model=64, n_layers=1, n_heads=4,
                      n_kv_heads=2, d_head=16, d_ff=128, remat=False,
                      dtype=torch.float32)
    run = runner.RunConfig(data_path=data_path, steps=3, batch=2,
                           seq_len=128, log_every=1, eval_data_path=data_path,
                           eval_every=3, eval_batches=2)
    state, history = runner.fit(cfg, train.TrainConfig(lr=1e-3), run,
                                train.make_mesh(MESH), device="cpu")
    losses = [h["loss"] for h in history if "loss" in h]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert 4.5 < losses[0] < 8.5
    assert any("eval_loss" in h for h in history)
    assert isinstance(state[0], ShardedParams)
    runner.main(["--data", data_path, "--steps", "1", "--batch", "2",
                 "--seq-len", "64", "--vocab", "512", "--d-model", "64",
                 "--n-layers", "1", "--n-heads", "4", "--device", "cpu",
                 "--mesh", "dp=2,sp=2,tp=2", "--ckpt-dir",
                 str(tmp_path / "c")])
    assert Checkpointer(str(tmp_path / "c")).steps() == [1]


def test_out_of_slice_combinations_raise():
    """Combinations with tp and an expert axis run on this file's model:
    an expert axis of size > 1 (its forward is the one without
    one: the exchange moves slots, not results), Ulysses with tp and the
    pipeline beside tp (each the one-device forward); what stays raises
    is JAX's ValueErrors: experts not divisible by the expert axis, the
    expert axis on the pp axis, Ulysses heads a tp group not divisible by
    sp, and an axis the model splits no work over."""
    b, seq = 2, 64
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, CFG["vocab"], (b, seq)))
    pos = torch.arange(seq).expand(b, seq)
    moe = dict(n_experts=4, head_axis=None, batch_axis=None,
               layout="contig")
    flat = params_from_jax(init_params_np(_cfg(**moe)), device="cpu")
    want, aux = forward_with_aux(flat, tok, pos, _cfg(**moe), {"sp": 1})
    got, aux2 = forward_with_aux(flat, tok, pos, _cfg(
        **moe, expert_axis="ep"), {"ep": 2, "sp": 1})
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(aux2, aux)
    dense = dict(layout="contig", batch_axis=None)
    params = params_from_jax(init_params_np(_cfg(**dense)), device="cpu")
    one = forward_with_aux(params, tok, pos, _cfg(**dense))[0]
    uly = dataclasses.replace(_cfg(**dense, attn_strategy="ulysses"),
                              n_kv_heads=4)
    p4 = params_from_jax(init_params_np(uly), device="cpu")
    torch.testing.assert_close(
        forward_with_aux(shard_params(p4, uly, {"sp": 2, "tp": 2}), tok,
                         pos, uly, {"sp": 2, "tp": 2})[0],
        forward_with_aux(p4, tok, pos, dataclasses.replace(
            uly, attn_strategy="burst"))[0], rtol=RTOL, atol=ATOL)
    from burst_attn_tpu_torch.models.pipeline_lm import stack_layers
    pp = _cfg(**dense, pp_axis="pp")
    stacked = dict(params, layers=stack_layers(params["layers"]))
    got = forward_with_aux(shard_params(stacked, pp, {"pp": 2, "tp": 2}),
                           tok, pos, pp, {"pp": 2, "tp": 2})[0]
    torch.testing.assert_close(got, one, rtol=RTOL, atol=ATOL)
    for cfg, mesh, match in (
            (_cfg(**moe, expert_axis="ep"), {"ep": 3}, "not divisible"),
            (_cfg(**moe, expert_axis="pp", pp_axis="pp"), {"pp": 2},
             "pp axis"),
            (_cfg(attn_strategy="ulysses", layout="contig"),
             {"sp": 2, "tp": 2}, "divisible"),
            (_cfg(**dense), {"sp": 2, "xp": 2}, "splits no work")):
        with pytest.raises(ValueError, match=match):
            forward_with_aux(flat, tok, pos, cfg, mesh)
    for sizes in ({"pp": 2, "dp": 2}, {"pp": 2, "tp": 2, "ep": 2}):
        assert train.make_mesh(sizes) == sizes
    with pytest.raises(ValueError, match="splits no work"):
        train.make_mesh({"pp": 2, "xp": 2})
