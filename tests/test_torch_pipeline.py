"""Port parity for the GPipe schedule (parallel/pipeline.py): `pipeline`
against the JAX package's `pipeline` on a ("pp",) CPU mesh of 4 stages
(jitted), at 1, 2 and 4 microbatches; its gradients with and without
remat against jax.grad of JAX's and against the sequential stages; the
bad microbatch count; `stack_stages` against JAX's; the schedule's live
pairs; a tree activation travelling with its microbatch.  Inputs are
numpy-seeded; fp32 on the CPU.  Tolerance: rtol = atol = 1e-5,
tests/test_pipeline.py's; the gradients against JAX's (entries
up to ~300, summed in another order by the two packages' products) take
atol 1e-6 of the largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from burst_attn_tpu.parallel import pipeline as jpipe
from burst_attn_tpu_torch.parallel import pipeline as pipe

P_STAGES = 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _jstage(p, x):
    return x + jnp.tanh(x @ p["w1"]) @ p["w2"]


def _stage(p, x):
    return x + torch.tanh(x @ p["w1"]) @ p["w2"]


def _params(seed, d=16, hidden=32):
    rng = np.random.default_rng(seed)
    return [{"w1": (rng.standard_normal((d, hidden)) * 0.3).astype(np.float32),
             "w2": (rng.standard_normal((hidden, d)) * 0.3).astype(np.float32)}
            for _ in range(P_STAGES)]


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.array(jax.devices()[:P_STAGES]), ("pp",))


def _torch(per_stage):
    return [{k: torch.from_numpy(v) for k, v in p.items()} for p in per_stage]


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_pipeline_matches_jax_and_sequential(jmesh, microbatches):
    per_stage = _params(0)
    x = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    want = jax.jit(lambda s, x: jpipe.pipeline(
        _jstage, s, x, mesh=jmesh, axis="pp", microbatches=microbatches))(
        jpipe.stack_stages([jax.tree.map(jnp.asarray, p) for p in per_stage]),
        jnp.asarray(x))
    stacked = pipe.stack_stages(_torch(per_stage))
    got = pipe.pipeline(_stage, stacked, torch.from_numpy(x),
                        mesh={"pp": P_STAGES}, microbatches=microbatches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    seq = torch.from_numpy(x)
    for p in _torch(per_stage):
        seq = _stage(p, seq)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), **TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_pipeline_grads_match_jax(jmesh, remat):
    """Autograd through the tick loop is the reverse schedule: parameter
    and input gradients of sum(out^2) against jax.grad of JAX's pipeline
    and of the sequential stages."""
    per_stage = _params(2)
    x = np.random.default_rng(3).standard_normal((8, 16)).astype(np.float32)

    def jloss(s, x):
        return jnp.sum(jpipe.pipeline(_jstage, s, x, mesh=jmesh, axis="pp",
                                      microbatches=4, remat=remat) ** 2)

    jstacked = jpipe.stack_stages(
        [jax.tree.map(jnp.asarray, p) for p in per_stage])
    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jstacked,
                                                       jnp.asarray(x))
    stacked = pipe.stack_stages(_torch(per_stage))
    for leaf in stacked.values():
        leaf.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pipe.pipeline(_stage, stacked, xt, mesh={"pp": P_STAGES},
                        microbatches=4, remat=remat)
    out.square().sum().backward()
    for k, got, want in [(k, stacked[k].grad, jg[k]) for k in stacked] + [
            ("x", xt.grad, jgx)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()),
                                   err_msg=k)
    # the sequential model's gradients
    seq_params = _torch(per_stage)
    for p in seq_params:
        for leaf in p.values():
            leaf.requires_grad_(True)
    xs = torch.from_numpy(x).requires_grad_(True)
    y = xs
    for p in seq_params:
        y = _stage(p, y)
    y.square().sum().backward()
    for k in stacked:
        np.testing.assert_allclose(
            stacked[k].grad.numpy(),
            torch.stack([p[k].grad for p in seq_params]).numpy(), **TOL)


def test_pipeline_errors_and_schedule():
    """A batch not divisible by microbatches raises ValueError (as in
    JAX), a mesh without the axis too; the schedule runs M + P - 1 ticks
    and each (stage, microbatch) pair once, stage s on microbatch t - s;
    stack_stages stacks like JAX's."""
    stacked = pipe.stack_stages(_torch(_params(4)))
    x = torch.zeros(6, 16)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        pipe.pipeline(_stage, stacked, x, mesh={"pp": P_STAGES},
                      microbatches=4)
    with pytest.raises(ValueError, match="not an axis"):
        pipe.pipeline(_stage, stacked, x, mesh={"sp": 4}, microbatches=2)
    ticks = list(pipe.gpipe_ticks(3, P_STAGES))
    assert len(ticks) == 3 + P_STAGES - 1
    pairs = [pair for _, live in ticks for pair in live]
    assert sorted(pairs) == [(s, m) for s in range(P_STAGES)
                             for m in range(3)]
    assert all(t - s == m for t, live in ticks for s, m in live)
    per_stage = _params(5)
    want = jpipe.stack_stages([jax.tree.map(jnp.asarray, p)
                               for p in per_stage])
    got = pipe.stack_stages(_torch(per_stage))
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    h = torch.ones(3)
    moved = pipe.hop(h)
    assert torch.equal(moved, h) and moved.data_ptr() != h.data_ptr()


def test_pipeline_carries_a_tree_with_each_microbatch():
    """A tree activation (x, per-row tags, None), as the LM's (x,
    positions, ids): each stage reads the tags of the microbatch it holds,
    the tags come out as they went in and the None leaf stays None; the
    x equals the sequential stages over the whole batch."""
    per_stage = _torch(_params(6))
    stacked = pipe.stack_stages(per_stage)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    tags = torch.arange(8, dtype=torch.float32)

    def stage(p, act):
        xs, tg, none = act
        return _stage(p, xs) + 0.01 * tg[:, None], tg, none

    want = x
    for p in per_stage:
        want = _stage(p, want) + 0.01 * tags[:, None]
    for m in (1, 2, 4):
        got, tg, none = pipe.pipeline(stage, stacked, (x, tags, None),
                                      mesh={"pp": P_STAGES}, microbatches=m)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        assert torch.equal(tg, tags) and none is None
