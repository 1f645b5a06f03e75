"""Port parity for the tp mesh in serving and for the collectives
(parallel/mesh.py) against the JAX package, on the same weights
(params_from_jax) and numpy inputs, fp32, CPU (the port's plain attention;
the JAX side on the conftest's 8 host devices).

The serving models are the JAX tests' (tests/test_serve.py,
tests/test_paged.py, tests/test_decode.py) but for the vocabulary: the
port's tp engine splits embed and lm_head over the vocab (param_specs), so
its vocab must divide by tp, and 97 becomes 96.  Greedy tokens are held
exactly, as the JAX tests hold them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from burst_attn_tpu.models import ModelConfig as JConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import param_specs as j_param_specs
from burst_attn_tpu.models import paged_decode as jpd
from burst_attn_tpu.models.decode import generate as j_generate
from burst_attn_tpu.models.serve import ServeEngine as JServeEngine
from burst_attn_tpu.models.train import make_mesh as j_make_mesh
from burst_attn_tpu.parallel import collectives as jcoll
from burst_attn_tpu.utils.compat import shard_map
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models.decode import generate
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, ShardedParams, Shards, param_specs, params_from_jax,
    shard_params, unshard_params,
)
from burst_attn_tpu_torch.parallel import mesh as pmesh

SERVE = dict(vocab=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_head=16, d_ff=128)


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
def model():
    jcfg = JConfig(**SERVE, block_q=8, block_kv=8, attn_backend="jnp",
                   remat=False, dtype=jnp.float32, batch_axis=None,
                   head_axis=None)
    cfg = ModelConfig(**SERVE, dtype=torch.float32, batch_axis=None,
                      head_axis=None)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, params


# -- the collectives -----------------------------------------------------------

def _lax(fn, parts, axis=0):
    """fn inside a jitted shard_map over a 1-d "x" mesh of len(parts) host
    devices, each holding parts[p] (numpy), every position's result
    stacked [W, ...]."""
    w = len(parts)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:w]), ("x",))
    x = jnp.concatenate([jnp.asarray(p)[None] for p in parts])
    f = jax.jit(shard_map(lambda a: fn(a[0])[None], mesh=mesh,
                          in_specs=JP("x"), out_specs=JP("x"),
                          check_vma=False))
    return np.asarray(f(x))


@pytest.mark.parametrize("w", [2, 4])
def test_collectives_match_lax_and_copy(w):
    """all_reduce (sum / mean / max / min), broadcast, all_gather (tiled
    and stacked) and reduce_scatter on W parts equal their lax
    counterparts inside shard_map; every position's result is a fresh
    tensor (no two share storage, none is an input); the recorder logs
    each with its own class; rank / world_size read the mesh grid."""
    rng = np.random.default_rng(w)
    parts = [rng.standard_normal((4, 6)).astype(np.float32)
             for _ in range(w)]
    tparts = [torch.from_numpy(p) for p in parts]
    cases = [(lambda ps, op=op: pmesh.all_reduce(ps, op, axis="x"),
              lambda a, op=op: jcoll.all_reduce(a, "x", op), "all_reduce")
             for op in ("sum", "mean", "max", "min")]
    cases += [
        (lambda ps: pmesh.broadcast(ps, root=1, axis="x"),
         lambda a: jcoll.broadcast(a, "x", root=1), "broadcast"),
        (lambda ps: pmesh.all_gather(ps, dim=1, axis="x"),
         lambda a: jcoll.all_gather(a, "x", axis=1), "all_gather"),
        (lambda ps: pmesh.all_gather(ps, dim=0, axis="x", tiled=False),
         lambda a: jcoll.all_gather(a, "x", axis=0, tiled=False),
         "all_gather"),
        (lambda ps: pmesh.reduce_scatter(ps, dim=0, axis="x"),
         lambda a: jcoll.reduce_scatter(a, "x", axis=0), "reduce_scatter")]
    for ours, theirs, cls in cases:
        with pmesh.record_collectives() as ev:
            got = ours(tparts)
        assert ev == [(cls, "x", None)]
        want = _lax(theirs, parts)
        assert len(got) == w
        for p in range(w):
            np.testing.assert_allclose(got[p].numpy(), want[p], rtol=1e-6,
                                       atol=1e-6)
        ptrs = {t.data_ptr() for t in got}
        assert len(ptrs) == w
        assert not ptrs & {t.data_ptr() for t in tparts}
    with pytest.raises(ValueError, match="unknown op"):
        pmesh.all_reduce(tparts, "prod")
    m = pmesh.Mesh({"dp": 2, "sp": 2, "tp": 2}, device="cpu")
    assert [pmesh.rank(m, "tp", p) for p in range(8)] == [0, 1] * 4
    assert [pmesh.rank(m, "dp", p) for p in range(8)] == [0] * 4 + [1] * 4
    assert pmesh.world_size(m, "sp") == 2 and pmesh.world_size(m, "ep") == 1


def test_ringcheck_knows_the_collectives():
    """analysis/ringcheck.py sets the dp / tp collectives aside as no ring
    rotation: a ring stream with them between its hops encodes to the
    hops alone, with no ring-rotation finding."""
    from burst_attn_tpu_torch.analysis import ringcheck

    xs = [torch.ones(2), torch.ones(2)]
    with pmesh.record_collectives() as ev:
        pmesh.all_reduce(xs, axis="tp")
        pmesh.ppermute([(x,) for x in xs], "intra", 1, 2)
        for fn in (pmesh.broadcast, pmesh.all_gather,
                   pmesh.reduce_scatter):
            fn(xs, axis="dp")
    assert [e[0] for e in ev] == ["all_reduce", "pay", "broadcast",
                                  "all_gather", "reduce_scatter"]
    findings = []
    runs = ringcheck._encode(ev, findings, "tp", ("x", 1))
    assert not findings
    assert runs == ringcheck.oracle.encode_runs([("pay", "intra", 1)])


def test_all_reduce_is_differentiable():
    """The sum's gradient reaches every part (the all-reduce's transpose
    is the all-reduce of the cotangents)."""
    xs = [torch.randn(3, requires_grad=True) for _ in range(2)]
    out = pmesh.all_reduce(xs, "sum")
    (out[0] * 2 + out[1] * 3).sum().backward()
    for x in xs:
        assert torch.equal(x.grad, torch.full((3,), 5.0))


# -- param_specs and shard_params ----------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(n_experts=4, expert_axis="ep"),
                                dict(pp_axis="pp")])
def test_param_specs_match_jax(kw):
    """param_specs leaf for leaf against the JAX tree (dense, MoE, pp)."""
    dims = dict(SERVE, n_layers=2)
    jspec = j_param_specs(JConfig(**dims, **kw))
    spec = param_specs(ModelConfig(**dims, **kw))
    jl, jdef = jax.tree_util.tree_flatten(
        jspec, is_leaf=lambda x: isinstance(x, JP))
    pl, pdef = jax.tree_util.tree_flatten(
        spec, is_leaf=lambda x: isinstance(x, tuple))
    assert len(jl) == len(pl) > 0
    assert [tuple(a) for a in jl] == [tuple(b) for b in pl]


def test_shard_params_layout_and_checks(model):
    """shard_params splits each Megatron leaf into contiguous per-position
    shards along the dim its spec names (as device_put(NamedSharding) lays
    them out), keeps replicated leaves whole, round-trips through
    unshard_params, and applies JAX's checks."""
    jcfg, jparams, cfg, params = model
    cfgt = dataclasses.replace(cfg, head_axis="tp")
    sp = shard_params(params, cfgt, {"tp": 2})
    assert isinstance(sp, ShardedParams) and sp.tp == 2
    mesh = j_make_mesh({"tp": 2}, devices=jax.devices()[:2])
    jspecs = j_param_specs(dataclasses.replace(jcfg, head_axis="tp"))
    placed = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), jparams,
        jspecs, is_leaf=lambda x: not isinstance(x, (dict, list)))
    lay = sp["layers"][0]
    for name in ("wq", "wo", "w_gate", "w_down"):
        assert isinstance(lay[name], Shards)
        shards = sorted(placed["layers"][0][name].addressable_shards,
                        key=lambda s: s.device.id)
        for t, sh in enumerate(shards):
            np.testing.assert_array_equal(lay[name].parts[t].numpy(),
                                          np.asarray(sh.data))
            assert lay[name].parts[t].is_contiguous()
    assert lay["attn_norm"] is params["layers"][0]["attn_norm"]
    back = unshard_params(sp)
    for k in ("embed", "lm_head"):
        assert torch.equal(back[k], params[k])
    assert shard_params(sp, cfgt, {"tp": 2}) is sp
    for c, mesh_, match in (
            (cfgt, {"tp": 3}, "divisible"),
            (dataclasses.replace(cfgt, vocab=97), {"tp": 2}, "vocab"),
            (dataclasses.replace(cfg, head_axis="model"), {"tp": 2},
             "not an axis")):
        with pytest.raises(ValueError, match=match):
            shard_params(params, c, mesh_)


# -- tensor-parallel serving ---------------------------------------------------

def test_paged_decode_tp_matches_single(model):
    """tests/test_paged.py's tp case: the head-sharded paged prefill and
    decode (every position on its kv-head shard of the pool) give the
    unsharded tokens and JAX's; each tp position holds its own pool
    shard; a head_axis the mesh lacks fails loudly."""
    jcfg, jparams, cfg, params = model
    cfgt = dataclasses.replace(cfg, head_axis="tp")
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(12), (9,), 0,
                                         cfg.vocab))

    def run(mesh, c, ps):
        state, pool = pd.init_paged_state(c, slots=2, n_pages=8, page=128,
                                          max_pages_per_seq=3, mesh=mesh,
                                          device="cpu")
        lg, state = pd.paged_prefill(ps, prompt, state, pool, 0, c,
                                     mesh=mesh)
        toks = [int(lg.argmax())]
        for _ in range(3):
            state = pd.ensure_capacity(state, pool, 0)
            lg, state = pd.paged_decode_step(
                ps, torch.tensor([toks[-1], 0]), state, c, mesh=mesh)
            toks.append(int(lg[0].argmax()))
        return toks, state

    base, _ = run(None, cfg, params)
    split = shard_params(params, cfgt, {"tp": 2})
    got, state = run({"tp": 2}, cfgt, split)
    assert got == base
    assert state.tp == 2 and state.k_pages[0].shape == (2, 8, 1, 128, 16)
    jcfgt = dataclasses.replace(jcfg, head_axis="tp")
    jmesh = j_make_mesh({"tp": 2}, devices=jax.devices()[:2])
    jstate, jpool = jpd.init_paged_state(jcfgt, slots=2, n_pages=8, page=128,
                                         max_pages_per_seq=3)
    lg, jstate = jpd.paged_prefill(jparams, jnp.asarray(prompt), jstate,
                                   jpool, 0, jcfgt, mesh=jmesh)
    want = [int(jnp.argmax(lg))]
    for _ in range(3):
        jstate = jpd.ensure_capacity(jstate, jpool, 0)
        lg, jstate = jpd.paged_decode_step(
            jparams, jnp.asarray([want[-1], 0], jnp.int32), jstate, jcfgt,
            mesh=jmesh)
        want.append(int(jnp.argmax(lg[0])))
    assert got == want
    with pytest.raises(ValueError, match="not an axis"):
        run({"tp": 2}, dataclasses.replace(cfg, head_axis="model"), split)
    # plain parameters on a tp mesh are refused, as the training forward
    # refuses them: the caller splits them once
    with pytest.raises(ValueError, match="shard_params"):
        run({"tp": 2}, cfgt, params)
    state, pool = pd.init_paged_state(cfg, slots=2, n_pages=8, page=128,
                                      max_pages_per_seq=3, device="cpu")
    with pytest.raises(ValueError, match="init_paged_state"):
        pd.paged_prefill(split, prompt, state, pool, 0, cfgt,
                         mesh={"tp": 2})


@pytest.mark.parametrize("quantize", [False, "int8"])
def test_serve_engine_tp_prefix_cache_matches(model, quantize):
    """tests/test_serve.py's prefix_cache x tp cases (and the int8 x tp x
    prefix-cache cross product): the port's tp=2 ServeEngine gives the
    unsharded port engine's tokens and JAX's tp engine's, the shared
    prefix registered; speculative serving takes no mesh (JAX's
    ValueError)."""
    jcfg, jparams, cfg, params = model
    cfgt = dataclasses.replace(cfg, head_axis="tp")
    jcfgt = dataclasses.replace(jcfg, head_axis="tp")
    rng = np.random.RandomState(23 if not quantize else 31)
    prefix = rng.randint(1, cfg.vocab, 256 if not quantize else 128)
    prompts = [np.concatenate([prefix, rng.randint(1, cfg.vocab, 9 + i)])
               for i in range(3)]
    kw = (dict(slots=2, n_pages=16, page=128, max_pages_per_seq=4)
          if not quantize else
          dict(slots=2, n_pages=12, page=128, max_pages_per_seq=3))

    def run(eng):
        rids = [eng.submit(p, 4) for p in prompts]
        out = eng.run()
        assert len(eng.cache) >= 1
        return [list(map(int, out[r])) for r in rids]

    base = run(ServeEngine(params, cfg, **kw, quantize=quantize,
                           prefix_cache=True, device="cpu"))
    eng = ServeEngine(params, cfgt, **kw, quantize=quantize,
                      prefix_cache=True, mesh={"tp": 2}, device="cpu")
    got = run(eng)
    assert isinstance(eng.params, ShardedParams) and eng.state.tp == 2
    want = run(JServeEngine(jparams, jcfgt, **kw, quantize=bool(quantize),
                            prefix_cache=True,
                            mesh=j_make_mesh({"tp": 2},
                                             devices=jax.devices()[:2])))
    assert got == base == want
    with pytest.raises(ValueError, match="no tp mesh"):
        ServeEngine(params, cfgt, **kw, mesh={"tp": 2}, device="cpu",
                    draft_params=params, draft_cfg=cfgt)


def test_generate_with_tp_sharded_params():
    """tests/test_decode.py's tp case: generate() on parameters split over
    tp (the tree carries its mesh: no mesh argument) gives the unsharded
    tokens and JAX's on its device_put tree; the dense cache splits over
    kv heads."""
    dims = dict(vocab=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                d_head=16, d_ff=128)
    jcfg = JConfig(**dims, block_q=8, block_kv=8, attn_backend="jnp",
                   remat=False, dtype=jnp.float32)
    cfg = ModelConfig(**dims, dtype=torch.float32)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(7), (2, 10), 0,
                                         cfg.vocab))
    ref = generate(params, torch.from_numpy(prompt), cfg, steps=6,
                   max_seq=64)
    sharded = shard_params(params, cfg, {"tp": 2})
    out = generate(sharded, torch.from_numpy(prompt), cfg, steps=6,
                   max_seq=64)
    assert torch.equal(out, ref)
    mesh = j_make_mesh({"tp": 2}, devices=jax.devices()[:2])
    jsharded = jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), jparams,
        j_param_specs(jcfg), is_leaf=lambda x: not isinstance(x, (dict, list)))
    want = j_generate(jsharded, jnp.asarray(prompt), jcfg, steps=6,
                      max_seq=64)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
