"""Port parity for the run across processes (utils/multihost.py,
parallel/mesh.py's process axes, parallel/collectives.py's transport):
two gloo processes a test, spawned on the CPU with a file:// rendezvous
(tests/torch_multiproc_workers.py holds their bodies), against the JAX
package on the 8-device CPU mesh of conftest.py and against the port's
own one-process run on the same inputs.

  * burst_attn forward and backward on the double ring inter=2 (the
    processes) x intra=2 (local), fp32 causal zigzag: JAX's burst_attn
    at ATOL 1e-5 / GRAD_ATOL 2e-4 (tests/test_torch_ring.py's), the
    port's one-process run bit for bit, the same collectives recorded;
  * the dp=2 (the processes) x sp=2 train step of a 2-layer narrow
    model: JAX's loss and gradients at loss rtol 1e-5, gradients rtol
    1e-4 / atol 1e-5 (tests/test_torch_ep_train.py's), the port's
    one-process dp=2 x sp=2 step fed the two rows joined bit for bit;
    the inter=2 (the processes) x intra=2 step held to JAX and to the
    one-process step at those tolerances;
  * runner.main --multihost --mesh dp=2,sp=2: two steps, checkpoints by
    rank 0 only, a resume, losses equal to the one-process train loop on
    the two loader shards' rows joined in rank order; a step on tp, pp
    and ep across the processes and on sp=4 split over them against the
    one-process runner; a pipeline with tp across them raises
    NotImplementedError naming ROADMAP A7b."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_multiproc_workers as W
from jax.sharding import Mesh as JMesh

import burst_attn_tpu as jbat
from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu_torch import burst_attn
from burst_attn_tpu_torch.data import DataLoader, write_token_file
from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, init_params, param_leaves, params_from_jax,
)
from burst_attn_tpu_torch.obs.aggregate import merge_files
from burst_attn_tpu_torch.parallel import mesh as pmesh

ATOL = 1e-5  # tests/test_torch_ring.py: fp32 forward
GRAD_ATOL = 2e-4  # tests/test_torch_ring.py: fp32 ring gradients
LOSS_RTOL = 1e-5  # tests/test_torch_ep_train.py
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread, as the children run (the same GEMM blocking
    on both sides, and JAX in this process slows torch's threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn(tmp_path, fn, *args):
    return W.spawn(fn, 2, args, init_method=f"file://{tmp_path / 'rdzv'}",
                   timeout_s=240)


def _jmesh(shape):
    sizes = tuple(shape.values())
    devs = np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    return JMesh(devs, tuple(shape))


def test_ring_op_across_processes(tmp_path):
    """fp32 B1 N4 S256 D32 causal zigzag on inter=2 x intra=2, the inter
    axis across the processes; the fused backend declines the ring
    (counted under spans-processes) and both processes' halves, joined,
    equal JAX's ring and the port's one-process ring."""
    rng = np.random.default_rng(21)
    q, k, v, g = (rng.standard_normal((1, 4, 256, 32), np.float32)
                  for _ in range(4))
    shape = {"inter": 2, "intra": 2}
    res = _spawn(tmp_path, W.ring_op, q, k, v, g, "cpu", "fused_ring")
    got = {n: np.concatenate([r[n] for r in res], axis=2)
           for n in ("o", "dq", "dk", "dv")}
    common = dict(seq_axes=("inter", "intra"), causal=True, layout="zigzag")
    jm = _jmesh(shape)

    def jloss(q, k, v):
        o = jbat.burst_attn(q, k, v, mesh=jm, backend="jnp",
                            batch_axes=None, head_axes=None, **common)
        return jnp.sum(o * g), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(q, k, v)
    np.testing.assert_allclose(got["o"], np.asarray(jo), atol=ATOL, rtol=0)
    for name, want in zip(("dq", "dk", "dv"), jg):
        np.testing.assert_allclose(got[name], np.asarray(want),
                                   atol=GRAD_ATOL, rtol=GRAD_ATOL,
                                   err_msg=name)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with pmesh.record_collectives() as ev:
        o = burst_attn(tq, tk, tv, mesh=shape, backend="auto", **common)
        (o * torch.from_numpy(g)).sum().backward()
    for name, want in (("o", o), ("dq", tq.grad), ("dk", tk.grad),
                       ("dv", tv.grad)):
        np.testing.assert_array_equal(got[name], want.detach().numpy(),
                                      err_msg=name)
    for r in res:
        assert r["events"] == list(ev)
        # the forward's KV base, the backward's q-side base and two dq hops
        assert r["stats"]["hops"] == 4, r["stats"]
        assert r["fallback"] == {
            "burst.fused_fallback{pass=fwd,reason=spans-processes}": 1,
            "burst.fused_fallback{pass=bwd,reason=spans-processes}": 1}


def _jax_loss_grads(tree, tok, sizes):
    """JAX's loss and gradients of loss_fn on mesh `sizes` (the double
    ring when it has "inter"; the port's leaves, param_leaves order)."""
    ring = "inter" in sizes
    jcfg = JConfig(**W.DIMS, attn_backend="jnp", dtype=jnp.float32,
                   remat=False, batch_axis="dp" if "dp" in sizes else None,
                   head_axis=None,
                   seq_axes=("inter", "intra") if ring else ("sp",))
    jm = jtrain.make_mesh(sizes, devices=jax.devices()[:4])
    jb = jtrain.batch_from_host(tok[:, :-1], tok[:, 1:], jcfg, jm)
    loss, gr = jax.jit(jax.value_and_grad(
        lambda p, t, q, lab: jtrain.loss_fn(p, t, q, lab, jcfg, jm)))(
        jax.tree.map(jnp.asarray, tree), jb["tokens"], jb["positions"],
        jb["labels"])
    return float(loss), [t.numpy() for t in param_leaves(params_from_jax(
        jax.tree.map(np.asarray, gr), device="cpu"))]


def test_train_steps_across_processes(tmp_path):
    """Two train steps in the same two processes: (1) dp=2 across them x
    sp=2 local, a row a process: every process's losses, grad norms and
    gradients equal the one-process dp=2 sp=2 step's bit for bit (the
    groups' gradients meet in all_reduce over the processes, summed in
    position order), its collectives the one-process step's; (2) the
    double ring inter=2 across them x intra=2 local, each process its half
    of the sequence of both rows: the replicated leaves' gradients summed
    over the ring's processes, equal to the one-process step's within
    JAX's tolerances (the split sums change fp32 rounding); both held to
    JAX's loss and gradients; (3) a 4-expert MoE model (no expert axis)
    on dp across them: bitwise the one-process step."""
    cfg = ModelConfig(**W.DIMS, dtype=torch.float32)
    tree = jax.tree.map(lambda t: t.numpy(),
                        init_params(cfg, seed=0, device="cpu"))
    tok = np.random.default_rng(3).integers(
        0, W.DIMS["vocab"], (2, 65)).astype(np.int32)
    moe = dict(n_experts=4, moe_capacity_factor=1.25)
    cases = [(W.DP_SP, ("dp",), None), (W.INTER_INTRA, ("inter",), None),
             (W.DP_SP, ("dp",), moe)]
    res = _spawn(tmp_path, W.train_cases, tree, tok, cases)
    for c, (sizes, _, model) in enumerate(cases):
        one = W.train_steps(None if model else tree, tok, sizes, (),
                            steps=2, model=model)
        if model:  # the MoE model, its routing groups each process's own
            for r in (rank[c] for rank in res):
                assert r["losses"] == one["losses"]
                for i, (a, b) in enumerate(zip(r["grads"], one["grads"])):
                    np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
            continue
        jloss, jgrads = _jax_loss_grads(tree, tok, sizes)
        for r in (rank[c] for rank in res):
            assert len(r["grads"]) == len(one["grads"]) == len(jgrads)
            if c == 0:
                assert r["losses"] == one["losses"]
                assert r["norms"] == one["norms"]
                for i, (a, b) in enumerate(zip(r["grads"], one["grads"])):
                    np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
                # the one-process step's collectives: its own dp group's
                # ring rotations (the one process ran both groups'), the
                # same dp all_reduces, after the sum of the valid-label
                # count over the processes
                ring = [e for e in one["events"] if e[0] in ("pay", "dq")]
                dp = [e for e in one["events"] if e[0] not in ("pay", "dq")]
                assert one["events"] == ring + dp
                assert r["events"] == ([("all_reduce", "dp", None)]
                                       + ring[:len(ring) // 2] + dp)
                # a gather a leaf's gradient, the loss, the label count
                assert r["stats"]["gathers"] == 2 * (len(jgrads) + 2)
            else:
                np.testing.assert_allclose(r["losses"], one["losses"],
                                           rtol=LOSS_RTOL)
                for i, (a, b) in enumerate(zip(r["grads"], one["grads"])):
                    np.testing.assert_allclose(a, b, err_msg=f"leaf {i}",
                                               **GRAD)
                # the ring's hops cross: the forward's and the backward's
                # inter hops a layer, every step
                assert r["stats"]["hops"] > 0
            np.testing.assert_allclose(r["losses"][0], jloss,
                                       rtol=LOSS_RTOL)
            for i, (a, b) in enumerate(zip(r["grads"], jgrads)):
                np.testing.assert_allclose(a, b, err_msg=f"leaf {i}",
                                           **GRAD)


def test_runner_multihost_trains_checkpoints_and_resumes(tmp_path):
    """runner --multihost --mesh dp=2,sp=2 in two processes: each reads
    its shard of the token file; the losses equal the one-process loop on
    the shards' rows joined in rank order; rank 0 alone writes the
    checkpoints, both resume from step 1 to the same step-2 loss; each
    process exports its own obs file and the merge folds both; a step on
    inter=2 x intra=2 has the one-process ring's loss; tp, pp and ep
    across the processes and sp=4 split over them train a step each, the
    loss the one-process runner's (tp, pp, ep: bit for bit); a pipeline
    with tp across them raises naming ROADMAP A7b."""
    seq, vocab = 64, 512
    data = str(tmp_path / "train.batd")
    write_token_file(data, np.random.default_rng(5).integers(
        0, vocab, 16 * (seq + 1)))
    argv = ["--data", data, "--batch", "1", "--seq-len", str(seq),
            "--vocab", str(vocab), "--d-model", "64", "--n-layers", "2",
            "--n-heads", "4", "--log-every", "1",
            "--obs-export", str(tmp_path / "obs.jsonl")]
    res = _spawn(tmp_path, W.runner_run, argv, str(tmp_path / "ckpt"))

    cfg = ModelConfig(vocab=vocab, d_model=64, n_layers=2, n_heads=4,
                      n_kv_heads=4, d_head=16, d_ff=256, batch_axis="dp",
                      head_axis=None)  # the runner's: bf16, remat
    mesh = train.make_mesh(W.DP_SP)
    tcfg = train.TrainConfig()
    state = train.init_train_state(0, cfg, tcfg, mesh, device="cpu")
    step = train.make_train_step(cfg, tcfg, mesh, device="cpu")
    loaders = [DataLoader(data, 1, seq, shard_id=r, num_shards=2, seed=0)
               for r in range(2)]
    want = []
    try:
        for _ in range(2):
            xs, ys = zip(*(dl.next() for dl in loaders))
            state, m = step(state, train.batch_from_host(
                np.concatenate(xs), np.concatenate(ys), cfg, mesh,
                device="cpu"))
            want.append(float(m["loss"]))
    finally:
        for dl in loaders:
            dl.close()
    for r in res:
        assert [h["loss"] for h in r["full"]] == want
        assert [(h["step"], h["loss"]) for h in r["resumed"]] == [
            (2, want[1])]
        assert r["steps_a"] == [1, 2] and r["steps_b"] == [1, 2]
        assert sorted(r["raised"]) == ["tp=2,pp=2,sp=2"], r["raised"]
        assert all("ROADMAP A7b" in msg for msg in r["raised"].values())
        assert sorted(r["ran"]) == ["ep=2,sp=2", "pp=2,sp=2", "sp=4",
                                    "tp=2,sp=2"]
    assert res[0]["writes"] == [1, 2, 2] and res[1]["writes"] == []
    # the meshes that raised before: tp, pp and ep across the processes
    # equal the one-process runner, the ring split 2 + 2 within LOSS_RTOL
    for mesh, hist in res[0]["ran"].items():
        _, one = runner.main(argv + W.RUNNER_EXTRA.get(mesh, []) + [
            "--mesh", mesh, "--device", "cpu", "--steps", "1"])
        assert [h["step"] for h in hist] == [1], mesh
        assert hist == [dict(h, step_s=hist[0]["step_s"]) for h in one] \
            or mesh == "sp=4", (mesh, hist, one)
        np.testing.assert_allclose(hist[0]["loss"], one[0]["loss"],
                                   rtol=LOSS_RTOL, err_msg=mesh)
        assert [h["loss"] for h in res[1]["ran"][mesh]] == [
            h["loss"] for h in hist], mesh
    # --mesh inter=2,intra=2: both processes read the same rows, each its
    # half of the sequence; the loss is the one-process ring's
    cfg2 = ModelConfig(vocab=vocab, d_model=64, n_layers=2, n_heads=4,
                       n_kv_heads=4, d_head=16, d_ff=256, batch_axis=None,
                       head_axis=None, seq_axes=("inter", "intra"))
    mesh2 = train.make_mesh(W.INTER_INTRA)
    state = train.init_train_state(0, cfg2, tcfg, mesh2, device="cpu")
    with DataLoader(data, 1, seq, seed=0) as dl:
        x, y = dl.next()
    _, m = train.make_train_step(cfg2, tcfg, mesh2, device="cpu")(
        state, train.batch_from_host(x, y, cfg2, mesh2, device="cpu"))
    for r in res:
        assert [h["step"] for h in r["inter"]] == [1]
        np.testing.assert_allclose(r["inter"][0]["loss"], float(m["loss"]),
                                   rtol=LOSS_RTOL)
    metrics, _, meta = merge_files([str(tmp_path / "obs.p*.jsonl")])
    assert meta["processes"] == 2
    steps = [m_ for m_ in metrics if m_["name"] == "train.steps"]
    # each process: 2 + 1 dp steps, the inter step and the tp, pp, ep
    # and sp=4 steps (the last export is the sp=4 run's)
    assert steps and sum(m_["value"] for m_ in steps) == 2 * (3 + 1 + 4)
