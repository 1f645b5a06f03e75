"""Port parity for training meshes laid over processes in JAX's
process-major order (parallel/mesh.py `process_layout`): two gloo
processes spawned on the CPU (tests/torch_multiproc_workers.py) against
the JAX package's loss_fn on the 8-device CPU mesh of conftest.py and
against the port's own one-process step on the same weights and batch.

  * one train step each of the narrow 2-layer model (fp32, lr 0, no
    clipping): tp=2 across the processes x sp=2; an MoE model with its
    experts on an ep axis across them (the tokens replicated over ep) and
    on dp across them (the dp groups in lockstep); the single ring sp=4
    split 2 + 2, dense and MoE (the ring positions' routing groups split
    between the processes); Ulysses over sp=2 one position a process; the
    pipeline pp=2 across them x sp=2 at 2 microbatches (a stage a
    process, the stage hops sent and their gradients sent back).
    JAX's loss at rtol 1e-5 and gradients at rtol 1e-4 / atol 1e-5
    (tests/test_torch_ep_train.py's); the one-process step bit for bit
    where the processes split no sequence (tp, ep, dp, pp), within those
    tolerances where they do (each process's tokens' share of the
    gradients summed over them changes fp32 summation order); the
    collectives recorded are the one-process step's plus the sums across
    the processes;
  * a checkpoint of tp=2 across the processes, written by rank 0 after
    the shards' gather, restored into both processes (the next step equal
    to the unsaved state's), into one process at tp=1 and at tp=2;
  * runner --multihost --mesh sp=4 and --mesh tp=2,sp=2: two steps with
    checkpoints, a resume, the held-out eval counting each row once."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_multiproc_workers as W

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu_torch.data import write_token_file
from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.transformer import (
    init_params, param_leaves, params_from_jax, tree_leaves, unshard_params,
)
from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

LOSS_RTOL = 1e-5  # tests/test_torch_ep_train.py
GRAD = dict(rtol=1e-4, atol=1e-5)
MOE = dict(n_experts=4, moe_capacity_factor=1.25)
AUX_W = 0.01  # the workers' TrainConfig.moe_aux_weight

# name -> (mesh, the model's extra fields, whether the processes split
# the sequence)
CASES = {
    "tp2-sp2": ({"tp": 2, "sp": 2}, None, False),
    "ep2-sp2-moe": ({"ep": 2, "sp": 2}, dict(MOE, expert_axis="ep"), False),
    "dp2-sp2-moe-experts-on-dp": ({"dp": 2, "sp": 2},
                                  dict(MOE, expert_axis="dp"), False),
    "sp4-split": ({"sp": 4}, None, True),
    "sp4-split-moe": ({"sp": 4}, dict(MOE), True),
    "ulysses-sp2": ({"sp": 2}, dict(attn_strategy="ulysses",
                                    layout="contig"), True),
    "pp2-sp2": ({"pp": 2, "sp": 2}, dict(pp_axis="pp", pp_microbatches=2),
                False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread, as the children run (the same GEMM blocking
    on both sides, and JAX in this process slows torch's threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(b=2, s=56):
    """[b, s + 1] tokens: b * s valid labels, not a power of two (the
    objective's normalization rounds, so every process must divide where
    the one-process step does)."""
    return np.random.default_rng(3).integers(
        0, W.DIMS["vocab"], (b, s + 1)).astype(np.int32)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """Every CASES case's two processes, in one spawn."""
    cases = [(sizes, "auto", model) for sizes, model, _ in CASES.values()]
    rdzv = tmp_path_factory.mktemp("train") / "rdzv"
    res = W.spawn(W.train_cases, 2, (None, _tokens(), cases),
                  init_method=f"file://{rdzv}", timeout_s=300)
    return {name: [r[i] for r in res] for i, name in enumerate(CASES)}


def _jax_loss_grads(sizes, model):
    """JAX's loss and gradients (the port's leaves, param_leaves order)
    of loss_fn on `sizes` from init_params seed 0's weights."""
    model = model or {}
    cfg = W._cfg(sizes, **model)
    tree = jax.tree.map(lambda t: t.numpy(),
                        init_params(cfg, 0, device="cpu"))
    jcfg = JConfig(**W.DIMS, attn_backend="jnp", dtype=jnp.float32,
                   remat=False, seq_axes=("sp",),
                   batch_axis=cfg.batch_axis, head_axis=cfg.head_axis,
                   **model)
    n = int(np.prod(list(sizes.values())))
    jm = jtrain.make_mesh(sizes, devices=jax.devices()[:n])
    tok = _tokens()
    jb = jtrain.batch_from_host(tok[:, :-1], tok[:, 1:], jcfg, jm)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, t, q, lab: jtrain.loss_fn(p, t, q, lab, jcfg, jm,
                                            moe_aux_weight=AUX_W)))(
        jax.tree.map(jnp.asarray, tree), jb["tokens"], jb["positions"],
        jb["labels"])
    return float(loss), [t.numpy() for t in param_leaves(params_from_jax(
        jax.tree.map(np.asarray, g), device="cpu"))]


def _ring(ev):
    return collections.Counter(e for e in ev if e[0] in ("pay", "dq"))


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_across_processes(train_runs, name):
    """Each case's losses and first-step gradients in both processes
    against JAX's and the one-process step's (module docstring); the
    collectives each process recorded are the one-process step's plus:
    the label count summed over the processes that hold distinct tokens,
    each gradient and the loss over a sequence axis or a pipeline's
    stages across them, each expert leaf's owner gradient over the
    expert axis; over dp and pp each process runs its own groups' or
    stages' rings only."""
    sizes, model, seq_split = CASES[name]
    one = W.train_steps(None, _tokens(), sizes, (), steps=2, model=model)
    jloss, jgrads = _jax_loss_grads(sizes, model)
    n_leaves = len(one["grads"])
    n_exp = 2 * 3 if model and "n_experts" in model else 0
    for r in train_runs[name]:
        assert len(r["grads"]) == n_leaves == len(jgrads)
        np.testing.assert_allclose(r["losses"][0], jloss, rtol=LOSS_RTOL)
        for i, (a, b) in enumerate(zip(r["grads"], jgrads)):
            np.testing.assert_allclose(a, b, err_msg=f"leaf {i}", **GRAD)
        assert r["stats"]["hops"] + r["stats"]["gathers"] > 0
        if seq_split:
            np.testing.assert_allclose(r["losses"], one["losses"],
                                       rtol=LOSS_RTOL)
            for i, (a, b) in enumerate(zip(r["grads"], one["grads"])):
                np.testing.assert_allclose(a, b, err_msg=f"leaf {i}",
                                           **GRAD)
            sp = ("all_reduce", "sp", None)
            assert r["events"] == [sp] + one["events"] + [sp] * (
                n_leaves + 1)
            continue
        assert r["losses"] == one["losses"] and r["norms"] == one["norms"]
        for i, (a, b) in enumerate(zip(r["grads"], one["grads"])):
            np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
        if "pp" in sizes:  # each process its own stage's rings
            assert _ring(r["events"]) + _ring(r["events"]) == _ring(
                one["events"])
            rest = [e for e in r["events"] if e[0] not in ("pay", "dq")]
            assert rest == [e for e in one["events"]
                            if e[0] not in ("pay", "dq")] + [
                ("all_reduce", "pp", None)] * (n_leaves + 1)
        elif "tp" in sizes:
            assert r["events"] == one["events"]
        elif "ep" in sizes:
            assert r["events"] == one["events"] + [
                ("all_reduce", "ep", None)] * n_exp
        else:
            assert _ring(r["events"]) + _ring(r["events"]) == _ring(
                one["events"])
            rest = collections.Counter(e for e in r["events"]
                                       if e[0] not in ("pay", "dq"))
            rest[("all_reduce", "dp", None)] -= 1 + n_exp
            assert rest == collections.Counter(
                e for e in one["events"] if e[0] not in ("pay", "dq"))


def test_tp_checkpoint_across_processes(tmp_path):
    """Checkpointer.save of tp=2 across the processes: rank 0 writes the
    whole tensors after the shards' gather; both processes restore their
    shards and moments exactly (the next step's loss equal to the saved
    state's); one process restores the same checkpoint at tp=1 (the whole
    tree) and at tp=2, whose next step equals the two processes'."""
    tok = _tokens()
    d = str(tmp_path / "ckpt")
    res = W.spawn(W.tp_checkpoint, 2, (tok, d),
                  init_method=f"file://{tmp_path / 'rdzv'}", timeout_s=240)
    for r in res:
        assert r["same"] and r["steps"] == [1]
        assert r["loss_a"] == r["loss_b"]
    whole = res[0]["whole"]
    for a, b in zip(whole, res[1]["whole"]):
        np.testing.assert_array_equal(a, b)
    cfg = W._cfg(W.TP_SP)
    tcfg = train.TrainConfig(lr=1e-3)
    (p1, _), step = Checkpointer(d).restore(1, cfg, tcfg, {"sp": 2},
                                            device="cpu")
    assert step == 1
    for a, b in zip(tree_leaves(p1), whole):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    state = Checkpointer(d).restore(1, cfg, tcfg, W.TP_SP, device="cpu")[0]
    for a, b in zip(tree_leaves(unshard_params(state[0])), whole):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    _, m = train.make_train_step(cfg, tcfg, W.TP_SP, device="cpu")(
        state, train.batch_from_host(tok[:, :-1], tok[:, 1:], cfg, W.TP_SP,
                                     device="cpu"))
    assert float(m["loss"]) == res[0]["loss_b"]


def test_runner_multihost_sp4_and_tp_checkpoints_and_resumes(tmp_path):
    """runner --multihost --mesh sp=4 (the ring split 2 + 2) and --mesh
    tp=2,sp=2 (tp across the processes) in two processes: two steps with
    a checkpoint each (rank 0 writes), a resume from step 1 to the same
    step-2 loss; the losses and the held-out eval (each row counted once,
    not once a process) against the one-process runner: the tp run equal,
    the split ring's within LOSS_RTOL at its first step."""
    seq, vocab = 64, 512
    data, ev_data = str(tmp_path / "train.batd"), str(tmp_path / "ev.batd")
    rng = np.random.default_rng(5)
    write_token_file(data, rng.integers(0, vocab, 16 * (seq + 1)))
    write_token_file(ev_data, rng.integers(0, vocab, 8 * (seq + 1)))
    argv = ["--data", data, "--batch", "1", "--seq-len", str(seq),
            "--vocab", str(vocab), "--d-model", "64", "--n-layers", "2",
            "--n-heads", "4", "--log-every", "1", "--eval-data", ev_data,
            "--eval-every", "2", "--eval-batches", "2"]
    meshes = ("sp=4", "tp=2,sp=2")
    res = W.spawn(W.runner_meshes, 2, (argv, str(tmp_path / "ckpt"),
                                        meshes),
                  init_method=f"file://{tmp_path / 'rdzv'}", timeout_s=300)
    for mesh in meshes:
        _, want = runner.main(argv + ["--mesh", mesh, "--device", "cpu",
                                      "--steps", "2"])
        losses = [h["loss"] for h in want if "loss" in h]
        evals = [h["eval_loss"] for h in want if "eval_loss" in h]
        for r in (rank[mesh] for rank in res):
            got = [h["loss"] for h in r["full"] if "loss" in h]
            got_ev = [h["eval_loss"] for h in r["full"] if "eval_loss" in h]
            assert r["steps_a"] == [1, 2] and r["steps_b"] == [1, 2], r
            assert [(h["step"], h["loss"]) for h in r["resumed"]
                    if "loss" in h] == [(2, got[1])]
            assert len(got_ev) == len(evals) == 1
            if mesh.startswith("tp"):
                assert got == losses and got_ev == evals
            else:
                np.testing.assert_allclose(got[0], losses[0],
                                           rtol=LOSS_RTOL)
                np.testing.assert_allclose(got_ev, evals, rtol=1e-3)
        # both processes logged the same run
        assert [{k: v for k, v in h.items() if k != "step_s"}
                for h in res[0][mesh]["full"]] == [
            {k: v for k, v in h.items() if k != "step_s"}
            for h in res[1][mesh]["full"]]
