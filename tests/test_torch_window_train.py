"""Port parity for windowed training: the sliding-window band in the
backward (tile_bwd, flash_bwd's plain version, flash_attention's
gradients), the ring's mask helpers with a window, the backward route
rule, the windowed contig ring (burst_attn(window=), both routes, uni and
double), a windowed model's loss and gradients, fit with a resume, and
dist_generate with a window, all against the JAX package on the same
numpy inputs and weights, fp32 on the CPU.  The JAX side runs its plain
tiles and its scan ring (backend="jnp", jitted on the conftest's CPU
devices), as tests/test_window.py allows; no interpreted Pallas kernel.

Tolerances are tests/test_window.py's: tiles 1e-4, dense-oracle and
ring gradients 2e-4, the model's loss 1e-5 and gradients 1e-4 of
tests/test_torch_train.py (fp32 summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import burst_attn_tpu as jbat
from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import dist_decode as jdd
from burst_attn_tpu.models import train as jtrain
from burst_attn_tpu.ops import masks as jmasks
from burst_attn_tpu.ops import pallas_flash as jflash
from burst_attn_tpu.ops import tile as jtile
from burst_attn_tpu_torch import burst_attn, obs
from burst_attn_tpu_torch.models import runner, train
from burst_attn_tpu_torch.models.dist_decode import dist_generate
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, param_leaves, params_from_jax,
)
from burst_attn_tpu_torch.ops import flash, masks, tile
from burst_attn_tpu_torch.data import write_token_file
from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

D = 32
SCALE = D**-0.5


def _jmesh(shape):
    sizes = tuple(shape.values())
    devs = np.asarray(jax.devices()[:int(np.prod(sizes))]).reshape(sizes)
    return JMesh(devs, tuple(shape))


def _inputs(seed, n, n_kv, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, n, s, D)).astype(np.float32)
    k = rng.standard_normal((1, n_kv, s, D)).astype(np.float32)
    v = rng.standard_normal((1, n_kv, s, D)).astype(np.float32)
    g = rng.standard_normal((1, n, s, D)).astype(np.float32)
    return q, k, v, g


def _t(*xs):
    return [torch.from_numpy(np.array(x, copy=True)) for x in xs]


def banded_dense(q, k, v, window):
    """tests/test_window.py's dense oracle (JAX)."""
    s_q, s_kv = q.shape[2], k.shape[2]
    s = jnp.einsum("bnid,bnjd->bnij", q, k) * SCALE
    rows, cols = np.arange(s_q)[:, None], np.arange(s_kv)[None, :]
    s = jnp.where((cols <= rows) & (cols > rows - window), s, -jnp.inf)
    return jnp.einsum("bnij,bnjd->bnid", jax.nn.softmax(s, axis=-1), v)


# ---------------------------------------------------------------------------
# the backward tile with a band


@pytest.mark.parametrize("n_kv", [2, 1])
@pytest.mark.parametrize("window", [1, 24, 64])
@pytest.mark.parametrize("segmented", [False, True])
def test_tile_bwd_window_matches_jax(window, n_kv, segmented):
    s = 64
    q, k, v, do = _inputs(window + n_kv, 2, n_kv, s)
    ids = (np.arange(s) // 20)[None].astype(np.int32)
    spec = masks.round_spec(0, 0, s, s, True, "contig")
    jspec = jmasks.MaskSpec(*(jnp.int32(x) for x in spec))
    jsegs = (jnp.asarray(ids), jnp.asarray(ids)) if segmented else None
    segs = (torch.from_numpy(ids),) * 2 if segmented else None
    jst = jtile.tile_fwd(*map(jnp.asarray, (q, k, v)),
                         *jtile.init_state(1, 2, s, D), SCALE, jspec,
                         window=window, segments=jsegs)
    o = np.asarray(jtile.finalize(*jst, jnp.float32))
    lse = np.asarray(jst[1])
    delta = (o * do).sum(-1)
    want = jtile.tile_bwd(*map(jnp.asarray, (do, q, k, v, delta, lse)),
                          SCALE, jspec, window=window, segments=jsegs)
    got = tile.tile_bwd(*_t(do, q, k, v, delta, lse), SCALE, spec,
                        window=window, segments=segs)
    # flash_bwd's plain version is tile_bwd itself on the CPU, on either
    # route the rule could pick
    for fused in (None, False):
        again = flash.flash_bwd(*_t(do, q, k, v, delta, lse), SCALE, spec,
                                window=window, segments=segs, fused=fused)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_flash_attention_window_grads_match_banded_dense():
    q, k, v, do = _inputs(5, 2, 2, 128)
    xs = [t.requires_grad_() for t in _t(q, k, v)]
    o = flash.flash_attention(*xs, causal=True, window=32)
    (o * torch.from_numpy(do)).sum().backward()
    jo, vjp = jax.vjp(lambda a, b, c: banded_dense(a, b, c, 32),
                      *map(jnp.asarray, (q, k, v)))
    want = [jo] + list(vjp(jnp.asarray(do)))
    for a, b, name in zip([o.detach()] + [x.grad for x in xs], want,
                          ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


# ---------------------------------------------------------------------------
# the ring's mask helpers and the route rule


@pytest.mark.parametrize("s", [16, 32])
def test_ring_mask_helpers_match_jax(s):
    for window in (1, 8, 16, 17, 24, 40, 100):
        for qp in range(4):
            for kp in range(4):
                got = masks.round_spec(qp, kp, s, s, True, "contig",
                                       window=window)
                want = jmasks.round_spec(jnp.int32(qp), jnp.int32(kp), s, s,
                                         True, "contig", window=window)
                assert tuple(got) == tuple(int(x) for x in want)
                assert masks.spec_live(got, window) == bool(
                    jmasks.spec_live(want, window))
                assert masks.spec_pair_count(got, s, s, window) == int(
                    jmasks.spec_pair_count(want, s, s, window))
                assert masks._host_round_pairs("contig", qp, kp, s, True,
                                               window) == \
                    jmasks._host_round_pairs("contig", qp, kp, s, True,
                                             window)
        for world in (1, 2, 4, 8):
            for msl in (None, 9, 40):
                kw = dict(causal=True, window=window, max_segment_len=msl)
                assert masks.live_delta_table("contig", s, world, **kw) == \
                    jmasks.live_delta_table("contig", s, world, **kw)
                r = masks.live_round_prefix("contig", s, world, **kw)
                assert r == jmasks.live_round_prefix("contig", s, world, **kw)
                if msl is None:  # the closed form
                    assert r == min(world, (s + window - 2) // s + 1)
    for layout in ("zigzag", "striped"):
        with pytest.raises(ValueError, match="contig"):
            masks.round_spec(0, 0, s, s, True, layout, window=8)
    with pytest.raises(ValueError, match="causal"):
        masks.round_spec(0, 0, s, s, False, "contig", window=8)
    with pytest.raises(ValueError, match=">= 1"):
        masks.round_spec(0, 0, s, s, True, "contig", window=0)


def test_bwd_route_rule_matches_jax():
    for bq, bkv in ((16, 16), (32, 64), (64, 32), (64, 64), (128, 128)):
        for window in (1, 24, 64, 100, 1024):
            assert flash.bwd_band_nb(bq, bkv, window) == \
                jflash.bwd_band_nb(bq, bkv, window)
    for nqb in (1, 2, 4, 32, 128):
        for window in (None, 1, 24, 64, 100, 1024):
            assert flash.bwd_band_nbq(64, 64, nqb, window) == \
                jflash.bwd_band_nbq(64, 64, nqb, window)
    # (N, Nk, S, window, triangular) -> the JAX rule at the port's tiles
    for n, n_kv, s, window, tri in [(16, 16, 8192, None, True),
                                    (16, 16, 8192, 1024, True),
                                    (1, 1, 256, 64, False),
                                    (8, 2, 256, 64, False),
                                    (1, 1, 128, None, False),
                                    (4, 4, 2048, None, False)]:
        nqb = -(-s // 64)
        want = "fused" if (tri and window is None) or jflash.bwd_band_nbq(
            64, 64, nqb, window) * (n // n_kv) >= 4 else "split"
        assert flash.bwd_route((1, n, s, 128), (1, n_kv, s, 128),
                               window=window, triangular=tri) == want
        assert flash.bwd_route((1, n, s, 128), (1, n_kv, s, 128),
                               window=window, triangular=tri,
                               fused=False) == "split"


# ---------------------------------------------------------------------------
# the windowed contig ring


@pytest.mark.parametrize("shape", [{"sp": 8}, {"inter": 2, "intra": 4}])
def test_burst_attn_window_matches_jax(shape):
    """burst_attn(window=24) over shards of 16 tokens (the band crosses a
    shard boundary; a single ring runs 3 live rounds of 8), output and
    the gradients of sum(o * g), the port's three backends against the
    JAX scan ring; the fused route dispatches both passes."""
    q, k, v, g = _inputs(11, 4, 2, 128)
    jm = _jmesh(shape)

    def jloss(q, k, v):
        o = jbat.burst_attn(q, k, v, mesh=jm, seq_axes=tuple(shape),
                            causal=True, layout="contig", backend="jnp",
                            batch_axes=None, head_axes=None, window=24)
        return jnp.sum(o * g), o

    (_, jo), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    want = [np.asarray(jo)] + [np.asarray(x) for x in jgrads]
    for backend in ("jnp", "auto", "fused_ring"):
        before = obs.counter_values()
        xs = [t.requires_grad_() for t in _t(q, k, v)]
        o = burst_attn(*xs, mesh=shape, seq_axes=tuple(shape), causal=True,
                       layout="contig", backend=backend, window=24)
        (o * torch.from_numpy(g)).sum().backward()
        got = [o.detach()] + [x.grad for x in xs]
        for a, b, name in zip(got, want, ("o", "dq", "dk", "dv")):
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{backend} {name}")
        moved = obs.counter_deltas(before)
        assert not any(key.startswith("burst.fused_fallback")
                       for key in moved)
        # a single ring counts its live rounds, a pass each
        if "sp" in shape:
            assert moved["burst.ring_rounds"] == 2 * 3


def test_burst_attn_window_one_is_the_self_round():
    """window=1: every token sees itself only, o == v; the forward runs
    one round; the fused backward declines (a 1-round program has no dq
    return hop) and scans, as in the JAX package."""
    q, k, v, _ = _inputs(12, 2, 2, 64)
    before = obs.counter_values()
    o = burst_attn(*_t(q, k, v), mesh={"sp": 4}, causal=True,
                   layout="contig", backend="fused_ring", window=1)
    np.testing.assert_allclose(o.numpy(), v, rtol=1e-5, atol=1e-5)
    assert obs.counter_deltas(before)["burst.ring_rounds"] == 1
    xs = [t.requires_grad_() for t in _t(q, k, v)]
    burst_attn(*xs, mesh={"sp": 4}, causal=True, layout="contig",
               backend="fused_ring", window=1).sum().backward()
    assert obs.counter_deltas(before)[
        "burst.fused_fallback{pass=bwd,reason=schedule-compiler}"] == 1
    np.testing.assert_allclose(xs[2].grad.numpy(), np.ones_like(v),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the windowed model


DIMS = dict(vocab=128, d_model=64, n_layers=2, n_heads=2, n_kv_heads=2,
            d_head=32, d_ff=128)


def _jcfg(**kw):
    return JConfig(**DIMS, attn_backend="jnp", remat=False,
                   dtype=jnp.float32, batch_axis=None, head_axis=None,
                   layout="contig", **kw)


def _cfg(**kw):
    return ModelConfig(**DIMS, dtype=torch.float32, batch_axis=None,
                       head_axis=None, layout="contig", remat=False, **kw)


def _jleaves(tree):
    out = [tree["embed"]]
    for layer in tree["layers"]:
        out += [layer[k] for k in ("attn_norm", "wq", "wk", "wv", "wo",
                                   "mlp_norm", "w_gate", "w_up", "w_down")]
    return [np.asarray(a) for a in out + [tree["final_norm"],
                                           tree["lm_head"]]]


@pytest.mark.parametrize("sp", [1, 2])
def test_window_model_loss_and_grads_match_jax(sp):
    """A 2-layer model with window 16 at S 64: its loss and every
    gradient against JAX's loss_fn on the same weights and batch (mesh
    sp=1 and a contig ring of 2), and the windowed loss differs from the
    unwindowed one."""
    jmesh = jtrain.make_mesh({"sp": sp}, devices=jax.devices()[:sp])
    jparams = j_init_params(jax.random.PRNGKey(0),
                                      _jcfg(window=16))
    params_np = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, DIMS["vocab"], (2, 65)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    jb = jtrain.batch_from_host(x, y, _jcfg(window=16), jmesh)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t, pos, lab: jtrain.loss_fn(p, t, pos, lab,
                                              _jcfg(window=16), jmesh)))(
        jparams, jb["tokens"], jb["positions"], jb["labels"])
    mesh = train.make_mesh({"sp": sp}) if sp > 1 else None
    losses = {}
    for window in (16, None):
        params = params_from_jax(params_np, device="cpu")
        leaves = list(param_leaves(params))
        for t in leaves:
            t.requires_grad_(True)
        b = train.batch_from_host(x, y, _cfg(window=window), mesh,
                                  device="cpu")
        loss = train.loss_fn(params, b["tokens"], b["positions"],
                             b["labels"], _cfg(window=window), mesh)
        losses[window] = float(loss.detach())
        if window is None:
            continue
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for g, w in zip(grads, _jleaves(jgrads)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6)
    assert abs(losses[16] - losses[None]) > 1e-6


def test_window_fit_resumes_on_a_ring(tmp_path):
    """runner.fit of a windowed model on a contig ring of 2: two steps and
    a checkpoint, then a resumed run to step 3 gives the uninterrupted
    run's losses bit for bit, with an eval that runs the ring forward."""
    data = str(tmp_path / "toks.batd")
    write_token_file(data, np.random.default_rng(3).integers(0, 128,
                                                             size=20_000))
    cfg, tcfg = _cfg(window=24), train.TrainConfig(lr=1e-3)
    mesh = train.make_mesh({"sp": 2})
    kw = dict(data_path=data, batch=1, seq_len=64, log_every=1)
    _, hist_all = runner.fit(cfg, tcfg, runner.RunConfig(steps=3, **kw),
                             mesh, device="cpu")
    ck = str(tmp_path / "ckpt")
    runner.fit(cfg, tcfg, runner.RunConfig(steps=2, ckpt_dir=ck,
                                           ckpt_every=2, ckpt_keep=1, **kw),
               mesh, device="cpu")
    _, hist = runner.fit(cfg, tcfg, runner.RunConfig(
        steps=3, ckpt_dir=ck, ckpt_every=2, ckpt_keep=1,
        eval_data_path=data, eval_every=3, eval_batches=1, **kw),
        mesh, device="cpu")
    train_rows = [h for h in hist if "loss" in h]
    eval_rows = [h for h in hist if "eval_loss" in h]
    assert [h["step"] for h in train_rows] == [3]
    assert train_rows[0]["loss"] == hist_all[2]["loss"]
    assert len(eval_rows) == 1 and np.isfinite(eval_rows[0]["eval_loss"])
    assert Checkpointer(ck).steps() == [3]  # the final step is saved


# ---------------------------------------------------------------------------
# dist_generate with a window


def test_dist_generate_window_matches_jax():
    """tests/test_window.py:246's case: window 8 over a 16-token prompt on
    sp=2 and 11 greedy steps (the later ones band inside the recent
    buffer): the port's dist_generate gives the JAX dist_generate's
    tokens, on both ring routes."""
    dims = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, n_kv_heads=2,
                d_head=16, d_ff=64)
    jcfg = JConfig(**dims, dtype=jnp.float32, attn_backend="jnp",
                   remat=False, batch_axis=None, head_axis=None,
                   layout="contig", window=8)
    jmesh = jtrain.make_mesh({"sp": 2}, devices=jax.devices()[:2])
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    prompt = np.random.default_rng(4).integers(0, 64, (1, 16)).astype(
        np.int32)
    want = np.asarray(jdd.dist_generate(jparams, jnp.asarray(prompt), jcfg,
                                        jmesh, steps=11))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    for backend in ("jnp", "fused_ring"):
        cfg = ModelConfig(**dims, dtype=torch.float32, batch_axis=None,
                          head_axis=None, layout="contig", window=8,
                          attn_backend=backend)
        got = dist_generate(params, torch.from_numpy(prompt), cfg,
                            {"sp": 2}, steps=11)
        np.testing.assert_array_equal(got.numpy(), want)


def test_window_bench_counts_the_band_and_refuses_the_cpu():
    """bench/window_bench.py: the band's pairs as benchmarks/window_bench.py
    counts them (a window of S is causal), and no number without a card."""
    from burst_attn_tpu_torch.bench import window_bench

    for s, w in ((65536, 65536), (65536, 16384), (65536, 4096), (100, 1),
                 (100, 250)):
        ww = min(w, s)
        assert window_bench.band_pairs(s, w) == s * ww - ww * (ww - 1) // 2
    assert window_bench.band_pairs(64, None) == 64 * 65 // 2
    if not torch.cuda.is_available():
        assert window_bench.main(["--seq", "256", "--windows", "64"]) == 1


def test_windowed_ring_stats_match_jax():
    """collect_stats on a windowed contig ring (sp=8, shards of 16, window
    24): the scan ring's DevStats equal the JAX package's field by field
    (3 rounds run, 5 elided, the band's pairs); the fused route reports
    the truncated program (fused_rounds 3) and the same pairs."""
    from burst_attn_tpu_torch.obs import devstats

    x = np.random.default_rng(13).standard_normal((1, 2, 128, 16)).astype(
        np.float32)
    jm = _jmesh({"sp": 8})
    jo, jst = jax.jit(lambda q: jbat.burst_attn(
        q, q, q, mesh=jm, seq_axes=("sp",), backend="jnp", batch_axes=None,
        head_axes=None, collect_stats=True, causal=True, layout="contig",
        window=24))(x)
    t = torch.from_numpy(x)
    kw = dict(mesh={"sp": 8}, causal=True, layout="contig", window=24,
              collect_stats=True)
    o, st = burst_attn(t, t, t, backend="jnp", **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    for f in ("rounds", "rounds_live", "attn_pairs", "total_pairs", "flops",
              "fused_rounds", "rounds_elided", "slot_use"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    for f in ("m_max", "lse_min", "lse_max"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)), atol=1e-5,
                                   rtol=0, err_msg=f)
    assert st.rounds.tolist() == [3] * 8
    assert st.rounds_elided.tolist() == [5] * 8
    _, fst = burst_attn(t, t, t, backend="fused_ring", **kw)
    assert fst.fused_rounds.tolist() == [3] * 8
    assert fst.rounds_elided.tolist() == [5] * 8
    assert torch.equal(fst.attn_pairs, st.attn_pairs)
    assert fst.slot_use.shape == (8, devstats.MAX_SLOTS)
