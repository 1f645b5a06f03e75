"""Port parity: the port's data loader, runner and evaluator on the CPU
against the JAX package's, on the same token file and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.data import DataLoader as JLoader
from burst_attn_tpu.data import write_token_file as jwrite
from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu.models.evaluate import Evaluator as JEvaluator
from burst_attn_tpu_torch.data import (
    DataLoader, read_token_file, write_token_file,
)
from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.evaluate import Evaluator
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, param_leaves, params_from_jax,
)
from burst_attn_tpu_torch import obs
from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

DIMS = dict(vocab=512, d_model=64, n_layers=1, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128)


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("torch_run") / "toks.batd"
    write_token_file(p, np.random.default_rng(1).integers(0, 512,
                                                          size=40_000))
    return str(p)


def _cfg(**kw):
    return ModelConfig(**DIMS, dtype=torch.float32, batch_axis=None,
                       head_axis=None, remat=False, **kw)


def test_token_file_round_trips_like_jax(tmp_path):
    toks = np.random.default_rng(2).integers(0, 70_000, size=1000)
    a, b = tmp_path / "a.batd", tmp_path / "b.batd"
    write_token_file(a, toks)
    jwrite(b, toks)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(read_token_file(a), toks)


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_yields_the_jax_loaders_batches(data_path, shuffle):
    kw = dict(seed=3, shuffle=shuffle)
    with DataLoader(data_path, 2, 128, **kw) as dl, \
            JLoader(data_path, 2, 128, **kw) as jl:
        assert dl.windows_per_epoch == jl.windows_per_epoch
        for _ in range(3):
            for a, b in zip(dl.next(), jl.next()):
                np.testing.assert_array_equal(a, b)
        dl.seek(7)
        jl.seek(7)
        for a, b in zip(dl.next(), jl.next()):
            np.testing.assert_array_equal(a, b)


def test_fit_resume_is_bitwise_on_the_cpu(data_path, tmp_path):
    """2 steps + checkpoint, then a resumed run to step 4: the same losses,
    bit for bit, as an uninterrupted 4-step run (the loader seeks to the
    checkpoint step; state restores exactly)."""
    cfg, tcfg = _cfg(), train.TrainConfig(lr=1e-3)
    kw = dict(data_path=data_path, batch=2, seq_len=128, log_every=1)
    _, hist_all = runner.fit(cfg, tcfg, runner.RunConfig(steps=4, **kw),
                             device="cpu")
    ck = str(tmp_path / "ckpt")
    runner.fit(cfg, tcfg, runner.RunConfig(steps=2, ckpt_dir=ck,
                                           ckpt_every=2, ckpt_keep=1, **kw),
               device="cpu")
    assert Checkpointer(ck).steps() == [2]
    state, hist = runner.fit(cfg, tcfg, runner.RunConfig(
        steps=4, ckpt_dir=ck, ckpt_every=2, ckpt_keep=1, **kw),
        device="cpu")
    assert [h["step"] for h in hist] == [3, 4]
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_all[2:]]
    assert [h["grad_norm"] for h in hist] == [h["grad_norm"]
                                              for h in hist_all[2:]]
    assert Checkpointer(ck).steps() == [4]
    (p2, opt2), step = Checkpointer(ck).restore(4, cfg, tcfg, device="cpu")
    assert step == 4
    for a, b in zip(param_leaves(state[0]), param_leaves(p2)):
        assert torch.equal(a.detach(), b.detach())
    assert (opt2.state_dict()["state"][0]["exp_avg"].equal(
        state[1].state_dict()["state"][0]["exp_avg"]))


def test_fit_logs_eval_and_a_sane_initial_loss(data_path):
    run = runner.RunConfig(data_path=data_path, steps=2, batch=2,
                           seq_len=128, log_every=1, eval_data_path=data_path,
                           eval_every=2, eval_batches=2)
    _, history = runner.fit(_cfg(), train.TrainConfig(lr=1e-3), run,
                            device="cpu")
    losses = [h["loss"] for h in history if "loss" in h]
    assert len(losses) == 2 and 4.5 < losses[0] < 8.5  # ~ln(512) = 6.24
    evals = [h for h in history if "ppl" in h]
    assert evals and 100 < evals[-1]["ppl"] < 2000


def test_evaluator_matches_jax(data_path):
    mesh = jtrain.make_mesh({"sp": 1}, devices=jax.devices()[:1])
    jcfg = JConfig(**DIMS, block_q=32, block_kv=32, attn_backend="jnp",
                   dtype=jnp.float32, batch_axis=None, head_axis=None,
                   remat=False)
    params = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg,
                                     jtrain.TrainConfig(), mesh)[0]
    jev = JEvaluator(jcfg, mesh, data_path, batch=2, seq_len=128,
                     max_batches=3)
    ev = Evaluator(_cfg(), None, data_path, batch=2, seq_len=128,
                   max_batches=3, device="cpu")
    try:
        want, got = jev(params), ev(params_from_jax(
            jax.tree.map(np.asarray, params), device="cpu"))
    finally:
        jev.close()
        ev.close()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=1e-5)


def test_fit_on_a_ring_matches_one_position(data_path, tmp_path):
    """`--mesh sp=2`: the CLI trains and checkpoints on a ring of two
    positions, and fit on that ring (with its eval) gives one position's
    losses and eval loss on the same token stream."""
    argv = ["--data", data_path, "--steps", "1", "--batch", "1",
            "--seq-len", "64", "--vocab", "512", "--d-model", "64",
            "--n-layers", "1", "--n-heads", "4", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "c"), "--mesh", "sp=2"]
    runner.main(argv)
    assert Checkpointer(str(tmp_path / "c")).steps() == [1]
    run = runner.RunConfig(data_path=data_path, steps=2, batch=2,
                           seq_len=128, log_every=1, eval_data_path=data_path,
                           eval_every=2, eval_batches=2)
    tcfg = train.TrainConfig(lr=1e-3)
    hist = {}
    before = obs.counter_values()
    for mesh in (None, train.make_mesh({"sp": 2})):
        _, hist[mesh is None] = runner.fit(_cfg(), tcfg, run, mesh,
                                           device="cpu")
    # the ring run's attention: a forward and a backward dispatch per
    # train step, a forward per eval batch
    assert obs.counter_deltas(before)[
        "burst.dispatch{backend=auto,path=scan,tile=pallas}"] == 2 * 2 + 2
    for key in ("loss", "eval_loss"):
        got = [h[key] for h in hist[False] if key in h]
        want = [h[key] for h in hist[True] if key in h]
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_cli_trains_on_the_cpu_and_refuses_a_ring(data_path, tmp_path):
    argv = ["--data", data_path, "--steps", "1", "--batch", "1",
            "--seq-len", "64", "--vocab", "512", "--d-model", "64",
            "--n-layers", "1", "--n-heads", "4", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "c")]
    runner.main(argv)
    assert Checkpointer(str(tmp_path / "c")).steps() == [1]
    # the sequence ring trains (test_fit_on_a_ring_matches_one_position),
    # and so do dp and tp (tests/test_torch_tp_train.py) and a pipeline
    # beside them (tests/test_torch_pp_mesh.py); --multihost without a
    # cluster environment starts no process group and runs the
    # one-process run (here: resumes the step-1 checkpoint, nothing left
    # to train; across processes: tests/test_torch_multiproc.py), and an
    # axis the model splits no work over is refused
    runner.main(argv + ["--multihost"])
    assert not torch.distributed.is_initialized()
    assert Checkpointer(str(tmp_path / "c")).steps() == [1]
    with pytest.raises(ValueError, match="splits no work"):
        runner.main(argv + ["--mesh", "xp=2"])
    assert runner._parse_mesh("dp=1,sp=1") == {"dp": 1, "sp": 1}
    with pytest.raises(ValueError):
        runner._parse_mesh("sp1")
