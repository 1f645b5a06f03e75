"""Port parity for packed-document training: packed_fields(_np),
batch_from_host(packed_eos_id=), make_packed_batch, document isolation in
forward_with_aux, the packed loss and train step, fit and the Evaluator
with packed_eos_id and the CLI's --packed-eos, against the JAX package on
the same numpy tokens and weights (plain attention on the CPU, fp32).
Loss to 1e-5 and gradients to 1e-4 relative (1e-6 absolute floor): only
fp32 summation order differs; isolation to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import packed_fields as jpacked_fields
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu.models.evaluate import Evaluator as JEvaluator
from burst_attn_tpu_torch.data import write_token_file
from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.evaluate import Evaluator
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, forward_with_aux, init_params, param_leaves,
    params_from_jax,
)
from burst_attn_tpu_torch.parallel import layouts

DIMS = dict(vocab=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128)
KNOWN = np.asarray([[5, 6, 0, 7, 0, 8, 9, 10]], np.int32)  # eos_id 0
KNOWN_FIELDS = ([[0, 0, 0, 1, 1, 2, 2, 2]], [[0, 1, 2, 0, 1, 0, 1, 2]],
                [[6, 0, -1, 0, -1, 9, 10, -1]])


def _cfg(**kw):
    return ModelConfig(**DIMS, dtype=torch.float32, batch_axis=None,
                       head_axis=None, **kw)


def _jcfg(**kw):
    return JConfig(**DIMS, block_q=32, block_kv=32, attn_backend="jnp",
                   dtype=jnp.float32, batch_axis=None, head_axis=None, **kw)


def _jmesh(w):
    return jtrain.make_mesh({"sp": w}, devices=jax.devices()[:w])


def _stream(seed, b, s, eos_rate=0.08):
    """EOS-delimited tokens [b, s] from a numpy seed (eos_id 0)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, DIMS["vocab"], (b, s)).astype(np.int32)
    return np.where(rng.random((b, s)) < eos_rate, 0, tok).astype(np.int32)


def test_packed_fields_known_stream():
    for fields in (train.packed_fields(torch.from_numpy(KNOWN), 0),
                   train.packed_fields_np(KNOWN, 0)):
        for got, want in zip(fields, KNOWN_FIELDS):
            np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_fields_match_jax_on_seeded_streams(seed):
    tokens = _stream(seed, 3, 97, eos_rate=0.15)
    want = jpacked_fields(jnp.asarray(tokens), eos_id=0)
    np_want = jtrain.packed_fields_np(tokens, 0)
    for fields in (train.packed_fields(torch.from_numpy(tokens), 0),
                   train.packed_fields_np(tokens, 0)):
        for got, w, nw in zip(fields, want, np_want):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(w))
            np.testing.assert_array_equal(np.asarray(got), nw)


@pytest.mark.parametrize("w", [1, 2, 4])
def test_batch_from_host_packed_matches_jax(w):
    """Layout-order arrays equal JAX's at sp = 1, 2 and 4 (zigzag): the
    loader's labels are superseded by the re-derived ones."""
    tokens = _stream(3, 2, 64)
    shifted = np.concatenate([tokens[:, 1:], np.full((2, 1), -1, np.int32)],
                             1)
    jcfg, cfg = _jcfg(layout="zigzag"), _cfg(layout="zigzag")
    mesh = {"sp": w} if w > 1 else None
    got = train.batch_from_host(tokens, shifted, cfg, mesh, packed_eos_id=0,
                                device="cpu")
    want = jtrain.batch_from_host(tokens, shifted, jcfg, _jmesh(w),
                                  packed_eos_id=0)
    assert set(got) == set(want) == {"tokens", "positions", "labels",
                                     "segment_ids"}
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    if w == 4:  # the known stream, back in natural order
        b = train.batch_from_host(KNOWN, KNOWN, cfg, {"sp": 4},
                                  packed_eos_id=0, device="cpu")
        for key, want_f in zip(("segment_ids", "positions", "labels"),
                               KNOWN_FIELDS):
            np.testing.assert_array_equal(
                layouts.from_layout(b[key], "zigzag", 4, axis=1).numpy(),
                want_f)


def test_make_packed_batch():
    """Seeded, in layout order, fields packed_fields derives; EOS at rate
    4 / S (about four documents a row, JAX's rate)."""
    cfg = _cfg(layout="zigzag")
    a = train.make_packed_batch(7, cfg, {"sp": 2}, batch=8, seq=512,
                                device="cpu")
    b = train.make_packed_batch(7, cfg, {"sp": 2}, batch=8, seq=512,
                                device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    nat = {k: layouts.from_layout(v, "zigzag", 2, axis=1)
           for k, v in a.items()}
    seg, pos, lab = train.packed_fields(nat["tokens"], 0)
    for key, want in (("segment_ids", seg), ("positions", pos),
                      ("labels", lab)):
        assert torch.equal(nat[key], want.to(nat[key].dtype)), key
    docs = (nat["segment_ids"][:, -1] + 1).float().mean().item()
    assert 3 < docs < 7, docs  # 1 + 4 EOS expected a row
    assert int(nat["tokens"].min()) == 0 and int(
        (nat["tokens"] == 0).sum()) == int(nat["segment_ids"][:, -1].sum()
                                           + (nat["tokens"][:, -1] == 0).sum())


@pytest.mark.parametrize("mesh", [None, {"sp": 2}])
def test_packed_doc_isolated_from_prefix(mesh):
    """Logits of document B inside a packed row equal B's logits alone
    (JAX's test_packed_doc_isolated_from_prefix), on one position and on
    a contig ring of two."""
    cfg = _cfg(layout="contig", remat=False)
    params = init_params(cfg, 0, device="cpu")
    a, bl = 24, 40
    rng = np.random.default_rng(5)
    doc_a = rng.integers(1, cfg.vocab, (1, a))
    doc_b = rng.integers(1, cfg.vocab, (1, bl))

    def logits(tokens, lens):
        seg = np.concatenate([np.full((1, n), i) for i, n in enumerate(lens)],
                             1)
        pos = np.concatenate([np.arange(n)[None] for n in lens], 1)
        with torch.no_grad():
            return forward_with_aux(
                params, torch.from_numpy(tokens), torch.from_numpy(pos), cfg,
                mesh, segment_ids=torch.from_numpy(seg))[0]

    packed = logits(np.concatenate([doc_a, doc_b], 1), (a, bl))
    solo = logits(np.concatenate([doc_b, np.zeros((1, a), np.int64)], 1),
                  (bl, a))
    np.testing.assert_allclose(packed[:, a:].numpy(), solo[:, :bl].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_params():
    tcfg = jtrain.TrainConfig(lr=1e-3)
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), _jcfg(), tcfg,
                                     _jmesh(1))
    return tcfg, jax.tree.map(np.asarray, jstate[0])


def _state(params_np, tcfg):
    params = params_from_jax(params_np, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_(True)
    return params, train._optimizer(params, tcfg)


def _jleaves(tree):
    out = [tree["embed"]]
    for layer in tree["layers"]:
        out += [layer[k] for k in ("attn_norm", "wq", "wk", "wv", "wo",
                                   "mlp_norm", "w_gate", "w_up", "w_down")]
    return [np.asarray(x) for x in out + [tree["final_norm"],
                                           tree["lm_head"]]]


@pytest.mark.parametrize("w", [1, 2])
def test_packed_loss_and_gradients_match_jax(jax_params, w):
    """loss_fn(segment_ids=) and its gradients against JAX's, one position
    and a zigzag ring of two (the JAX scan ring, jnp tiles)."""
    tcfg, params_np = jax_params
    tokens = _stream(4, 2, 64)
    jcfg, cfg = _jcfg(layout="zigzag"), _cfg(layout="zigzag")
    jb = jtrain.batch_from_host(tokens, tokens, jcfg, _jmesh(w),
                                packed_eos_id=0)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.loss_fn(p, b["tokens"], b["positions"],
                                    b["labels"], jcfg, _jmesh(w),
                                    segment_ids=b["segment_ids"])))(
        jax.tree.map(jnp.asarray, params_np), jb)
    mesh = {"sp": w} if w > 1 else None
    b = train.batch_from_host(tokens, tokens, cfg, mesh, packed_eos_id=0,
                              device="cpu")
    params, _ = _state(params_np, tcfg)
    loss = train.loss_fn(params, b["tokens"], b["positions"], b["labels"],
                         cfg, mesh, segment_ids=b["segment_ids"])
    grads = torch.autograd.grad(loss, list(param_leaves(params)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for g, want in zip(grads, _jleaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-6)


def test_packed_train_steps_match_jax(jax_params):
    """Two packed steps of make_train_step (the batch's segment_ids reach
    the attention), loss and grad norm against JAX's; grad_accum=2 gives
    the same objective."""
    tcfg, params_np = jax_params
    tokens = _stream(5, 2, 64)
    jb = jtrain.batch_from_host(tokens, tokens, _jcfg(), _jmesh(1),
                                packed_eos_id=0)
    jstep = jtrain.make_train_step(_jcfg(), tcfg, _jmesh(1))
    jstate = (jax.tree.map(jnp.asarray, params_np),
              jtrain._optimizer(tcfg).init(
                  jax.tree.map(jnp.asarray, params_np)))
    b = train.batch_from_host(tokens, tokens, _cfg(), packed_eos_id=0,
                              device="cpu")
    step = train.make_train_step(_cfg(), tcfg, device="cpu")
    state = _state(params_np, tcfg)
    acc_tcfg = train.TrainConfig(lr=1e-3, grad_accum=2)
    acc_step = train.make_train_step(_cfg(), acc_tcfg, device="cpu")
    acc_state = _state(params_np, acc_tcfg)
    for _ in range(2):
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        acc_state, am = acc_step(acc_state, b)
        for mm in (m, am):
            np.testing.assert_allclose(float(mm["loss"]), float(jm["loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(mm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-5)


@pytest.fixture(scope="module")
def packed_path(tmp_path_factory):
    """A token file of EOS-delimited documents (eos_id 0, ~1 in 40)."""
    p = tmp_path_factory.mktemp("packed_run") / "toks.batd"
    write_token_file(p, _stream(6, 1, 40_000, eos_rate=0.025)[0])
    return str(p)


def test_evaluator_packed_matches_jax(packed_path, jax_params):
    tcfg, params_np = jax_params
    jev = JEvaluator(_jcfg(), _jmesh(1), packed_path, batch=2, seq_len=128,
                     max_batches=3, packed_eos_id=0)
    ev = Evaluator(_cfg(), None, packed_path, batch=2, seq_len=128,
                   max_batches=3, packed_eos_id=0, device="cpu")
    plain = Evaluator(_cfg(), None, packed_path, batch=2, seq_len=128,
                      max_batches=3, device="cpu")
    try:
        params = params_from_jax(params_np, device="cpu")
        want = jev(jax.tree.map(jnp.asarray, params_np))
        got, unpacked = ev(params), plain(params)
    finally:
        jev.close()
        ev.close()
        plain.close()
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"],
                               rtol=1e-5)
    assert got["eval_loss"] != unpacked["eval_loss"]


def test_fit_packed_resumes_and_evaluates_packed(packed_path, tmp_path):
    """fit(packed_eos_id=0): 2 steps + checkpoint, then a resume to step
    4 gives the uninterrupted run's losses bit for bit, and its eval is
    the packed Evaluator's."""
    cfg, tcfg = _cfg(), train.TrainConfig(lr=1e-3)
    kw = dict(data_path=packed_path, batch=2, seq_len=128, log_every=1,
              packed_eos_id=0, eval_data_path=packed_path, eval_every=4,
              eval_batches=2)
    state, hist_all = runner.fit(cfg, tcfg, runner.RunConfig(steps=4, **kw),
                                 device="cpu")
    ck = str(tmp_path / "ckpt")
    runner.fit(cfg, tcfg, runner.RunConfig(steps=2, ckpt_dir=ck,
                                           ckpt_every=2, **kw), device="cpu")
    _, hist = runner.fit(cfg, tcfg, runner.RunConfig(steps=4, ckpt_dir=ck,
                                                     ckpt_every=2, **kw),
                         device="cpu")
    losses = [h["loss"] for h in hist if "loss" in h]
    assert losses == [h["loss"] for h in hist_all if "loss" in h][2:]
    ev = Evaluator(cfg, None, packed_path, batch=2, seq_len=128,
                   max_batches=2, packed_eos_id=0, device="cpu")
    try:
        want = ev(state[0])
    finally:
        ev.close()
    got = [h for h in hist_all if "eval_loss" in h][-1]
    assert got["eval_loss"] == round(want["eval_loss"], 4)


def test_cli_packed_eos(packed_path, tmp_path, monkeypatch):
    """--packed-eos ID reaches RunConfig.packed_eos_id (JAX's flag), and
    the CLI trains packed on the CPU."""
    argv = ["--data", packed_path, "--steps", "1", "--batch", "1",
            "--seq-len", "64", "--vocab", "256", "--d-model", "64",
            "--n-layers", "1", "--n-heads", "4", "--device", "cpu"]
    seen = []
    real_fit = runner.fit

    def spy(cfg, tcfg, run, mesh=None, **kw):
        seen.append(run.packed_eos_id)
        return real_fit(cfg, tcfg, run, mesh, **kw)

    monkeypatch.setattr(runner, "fit", spy)
    runner.main(argv + ["--packed-eos", "0", "--mesh", "sp=2"])
    runner.main(argv)
    assert seen == [0, None]
