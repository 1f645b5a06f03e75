"""Port parity for the long-context handoff: ring prefill into pool pages
(burst_attn over sp=4) and sequence-parallel paged decode against the JAX
package's, on the same weights (params_from_jax), fp32 on the CPU.  The
JAX side runs its scan ring (attn_backend="jnp") on the CPU mesh.  Then
the JAX package's handoff fault cases (tests/test_handoff_faults.py) on
the port: a kill recovered from the journal alone, a restart from a bare
paged snapshot, and restartable decode strides, each token-exact with
the JAX handoff's stream."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import paged_decode as jpd
from burst_attn_tpu.models.dist_decode import \
    dist_paged_decode_step as j_dist_step
from burst_attn_tpu.models.train import make_mesh
from burst_attn_tpu.serving import handoff as jhandoff
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models.dist_decode import dist_paged_decode_step
from burst_attn_tpu_torch.models.transformer import ModelConfig, \
    params_from_jax
from burst_attn_tpu_torch import obs
from burst_attn_tpu_torch.parallel.mesh import Mesh
from burst_attn_tpu_torch.serving import (
    TokenJournal, handoff_decode, handoff_generate, journal_tokens_by_ext,
    load_paged_snapshot, ring_prefill_to_pages, save_paged_snapshot,
)
from burst_attn_tpu_torch.serving.handoff import check_handoff_preconditions

DIMS = dict(vocab=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_head=16, d_ff=128)
PAGE, S, STEPS, N_PAGES = 128, 256, 4, 8
ATOL = 1e-5  # fp32; the rings and the merges sum in another order


def _fresh_jax(jcfg):
    return jpd.init_paged_state(jcfg, slots=2, n_pages=N_PAGES, page=PAGE,
                                max_pages_per_seq=6)


def _fresh(cfg):
    return pd.init_paged_state(cfg, slots=2, n_pages=N_PAGES, page=PAGE,
                               max_pages_per_seq=6, device="cpu")


def _cfg(backend):
    return ModelConfig(**DIMS, dtype=torch.float32, layout="zigzag",
                       attn_backend=backend, batch_axis=None, head_axis=None)


@pytest.fixture(scope="module")
def ref():
    """The JAX handoff on a tiny model: the prefill's last-token logits,
    one sequence-parallel decode step's logits, and a whole
    handoff_generate run (tokens and pool pages)."""
    jcfg = JModelConfig(**DIMS, attn_backend="jnp", remat=False,
                        dtype=jnp.float32, layout="zigzag", batch_axis=None,
                        head_axis=None)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    jmesh = make_mesh({"sp": 4})
    prompt = np.random.default_rng(2).integers(0, DIMS["vocab"], S
                                               ).astype(np.int32)
    st, pool = _fresh_jax(jcfg)
    last, st = jhandoff.ring_prefill_to_pages(jparams, jnp.asarray(prompt),
                                              st, pool, 0, jcfg, jmesh)
    st = jpd.provision_capacity(st, pool, 0, STEPS)
    feed = np.zeros((2,), np.int32)
    feed[0] = int(np.argmax(np.asarray(last)))
    step, _ = j_dist_step(jparams, jnp.asarray(feed), st, jcfg, jmesh)
    st, pool = _fresh_jax(jcfg)
    toks, st = jhandoff.handoff_generate(jparams, jnp.asarray(prompt), st,
                                         pool, jcfg, jmesh, steps=STEPS)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return dict(prompt=prompt, params=params, last=np.asarray(last),
                jparams=jax.tree_util.tree_map(np.asarray, jparams),
                step=np.asarray(step)[0], feed=feed, tokens=list(toks),
                k_pages=[np.asarray(x) for x in st.k_pages],
                v_pages=[np.asarray(x) for x in st.v_pages],
                table=np.asarray(st.page_table),
                lengths=np.asarray(st.lengths), available=pool.available)


@pytest.mark.parametrize("backend", ["jnp", "auto", "fused_ring"])
def test_handoff_matches_jax(ref, backend):
    """Every route of the ring prefill lands the same pages, logits and
    greedy tokens as the JAX handoff; the fused route takes the fused
    ring (one dispatch per layer, no fallback)."""
    cfg = _cfg(backend)
    mesh = Mesh({"sp": 4}, device="cpu")
    st, pool = _fresh(cfg)
    before = obs.counter_values()
    last, st = ring_prefill_to_pages(ref["params"], ref["prompt"], st, pool,
                                     0, cfg, mesh)
    np.testing.assert_allclose(last.numpy(), ref["last"], atol=ATOL, rtol=0)
    if backend == "fused_ring":
        moved = obs.counter_deltas(before)
        assert moved["burst.dispatch{backend=fused_ring,path=fused,"
                     "tile=pallas}"] == DIMS["n_layers"]
        assert not any(k.startswith("burst.fused_fallback") for k in moved)
    st = pd.provision_capacity(st, pool, 0, STEPS)
    step, _ = dist_paged_decode_step(ref["params"], ref["feed"], st, cfg,
                                     {"sp": 4})
    np.testing.assert_allclose(step[0].numpy(), ref["step"], atol=ATOL,
                               rtol=0)

    st, pool = _fresh(cfg)
    toks, st = handoff_generate(ref["params"], ref["prompt"], st, pool, cfg,
                                mesh, steps=STEPS)
    assert toks == ref["tokens"]
    np.testing.assert_array_equal(st.page_table.numpy(), ref["table"])
    np.testing.assert_array_equal(st.lengths.numpy(), ref["lengths"])
    assert pool.available == ref["available"]
    for li in range(DIMS["n_layers"]):
        np.testing.assert_allclose(st.k_pages[li].numpy(), ref["k_pages"][li],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(st.v_pages[li].numpy(), ref["v_pages"][li],
                                   atol=ATOL, rtol=0)
    # the slot's pages, released, return the pool to its initial size
    pd.retire_slot(st, pool, 0)
    assert pool.available == N_PAGES - 1


def test_quantized_handoff_matches_jax(ref):
    """An int8 pool: the prefill quantizes each layer's K/V per token into
    its pages and the page-sharded decode dequantizes them, as in JAX."""
    jcfg = JModelConfig(**DIMS, attn_backend="jnp", remat=False,
                        dtype=jnp.float32, layout="zigzag", batch_axis=None,
                        head_axis=None)
    jst, jpool = jpd.init_paged_state(jcfg, slots=2, n_pages=N_PAGES,
                                      page=PAGE, max_pages_per_seq=6,
                                      quantize="int8")
    jparams = jax.tree_util.tree_map(jnp.asarray, ref["jparams"])
    want, jst = jhandoff.handoff_generate(jparams, jnp.asarray(ref["prompt"]),
                                          jst, jpool, jcfg,
                                          make_mesh({"sp": 4}), steps=STEPS)
    cfg = _cfg("fused_ring")
    st, pool = pd.init_paged_state(cfg, slots=2, n_pages=N_PAGES, page=PAGE,
                                   max_pages_per_seq=6, quantize="int8",
                                   device="cpu")
    got, st = handoff_generate(ref["params"], ref["prompt"], st, pool, cfg,
                               {"sp": 4}, steps=STEPS)
    assert got == list(want)
    for li in range(DIMS["n_layers"]):
        np.testing.assert_allclose(st.k_scales[li].numpy(),
                                   np.asarray(jst.k_scales[li]), rtol=1e-5)


def test_handed_off_slot_decodes_on_one_host(ref):
    """The pool the handoff filled (layout order) feeds the single-host
    paged_decode_step directly: the same tokens as the sequence-parallel
    decode."""
    cfg = _cfg("auto")
    st, pool = _fresh(cfg)
    last, st = ring_prefill_to_pages(ref["params"], ref["prompt"], st, pool,
                                     0, cfg, {"sp": 4})
    st = pd.provision_capacity(st, pool, 0, STEPS)
    out = [int(last.argmax())]
    feed = torch.zeros(2, dtype=torch.long)
    for _ in range(STEPS - 1):
        feed[0] = out[-1]
        lg, st = pd.paged_decode_step(ref["params"], feed, st, cfg)
        out.append(int(lg[0].argmax()))
    assert out == ref["tokens"]


def test_handoff_rejections_mutate_nothing(ref):
    """Every rejected request leaves the pool and the state as they were:
    a window, an empty or ragged prompt, a bad slot, a budget past the
    table, a live slot, an exhausted pool; a window cannot be configured
    on the zigzag layout at all."""
    cfg = _cfg("fused_ring")
    mesh = Mesh({"sp": 4}, device="cpu")
    st, pool = _fresh(cfg)
    avail0 = pool.available
    table0 = st.page_table.clone()
    wcfg = copy.copy(cfg)
    object.__setattr__(wcfg, "window", 64)
    for exc, pat, kw in [
            (ValueError, "window", dict(cfg=wcfg)),
            (ValueError, "empty", dict(n_tokens=0)),
            (ValueError, "multiple", dict(n_tokens=100)),
            (ValueError, "negative", dict(steps=-1)),
            (ValueError, "out of range", dict(slot=2)),
            (ValueError, "table width", dict(steps=6 * PAGE))]:
        args = dict(slot=0, n_tokens=S, cfg=cfg, steps=0) | kw
        with pytest.raises(exc, match=pat):
            check_handoff_preconditions(st, pool, args["slot"],
                                        args["n_tokens"], args["cfg"],
                                        steps=args["steps"])
    with pytest.raises(ValueError, match="multiple"):
        ring_prefill_to_pages(ref["params"], ref["prompt"][:100], st, pool,
                              0, cfg, mesh)
    with pytest.raises(ValueError, match="table width"):
        handoff_generate(ref["params"], ref["prompt"], st, pool, cfg, mesh,
                         steps=5 * PAGE)
    with pytest.raises(ValueError, match="steps"):
        handoff_generate(ref["params"], ref["prompt"], st, pool, cfg, mesh,
                         steps=0)
    assert pool.available == avail0
    assert torch.equal(st.page_table, table0) and int(st.lengths.sum()) == 0
    # a live slot is refused, and so is a prompt the pool has no room for
    # once a handoff holds pages
    handoff_generate(ref["params"], ref["prompt"], st, pool, cfg, mesh,
                     steps=STEPS)
    avail1 = pool.available
    with pytest.raises(RuntimeError, match="still live"):
        ring_prefill_to_pages(ref["params"], ref["prompt"], st, pool, 0, cfg,
                              mesh)
    with pytest.raises(RuntimeError, match="exhausted"):
        ring_prefill_to_pages(ref["params"],
                              np.tile(ref["prompt"], 3), st, pool, 1, cfg,
                              mesh)
    assert pool.available == avail1 and int(st.lengths[1]) == 0
    with pytest.raises(ValueError, match="window"):
        ModelConfig(**DIMS, window=64)  # zigzag: the JAX check refuses


def _prefilled(ref, cfg):
    """Fresh pool, ring prefill into slot 0, STEPS of capacity
    provisioned: (first greedy token, state, pool)."""
    st, pool = _fresh(cfg)
    last, st = ring_prefill_to_pages(ref["params"], ref["prompt"], st, pool,
                                     0, cfg, {"sp": 4})
    st = pd.provision_capacity(st, pool, 0, STEPS)
    return int(last.argmax()), st, pool


def test_handoff_kill_journal_only_recovery_token_exact(ref, tmp_path):
    """A kill mid-decode with only the write-ahead journal surviving: the
    replacement re-runs the ring prefill, re-decodes EXACTLY the journal
    lag (equal to the journaled tokens), then continues the stream,
    token-exact with the JAX handoff's."""
    cfg = _cfg("auto")
    jpath = str(tmp_path / "journal.jsonl")
    journal = TokenJournal(jpath, truncate=True)
    first, st, _ = _prefilled(ref, cfg)
    journal.submit(0, 0, [int(t) for t in ref["prompt"]], STEPS)
    journal.tokens(0, [first])
    journal.sync()
    dead_out, st = handoff_decode(ref["params"], st, cfg, {"sp": 4}, slot=0,
                                  last_token=first, n_steps=2,
                                  journal=journal, rid=0)
    del st, journal                         # the "SIGKILL": state is gone
    jt = journal_tokens_by_ext(jpath)[0]
    assert jt == [first] + dead_out == ref["tokens"][:3]

    first2, st, _ = _prefilled(ref, cfg)
    assert first2 == jt[0]                  # the prefill is deterministic
    lag, st = handoff_decode(ref["params"], st, cfg, {"sp": 4}, slot=0,
                             last_token=jt[0], n_steps=len(jt) - 1)
    assert lag == jt[1:]                    # re-decoded lag == journal
    rest, st = handoff_decode(ref["params"], st, cfg, {"sp": 4}, slot=0,
                              last_token=jt[-1], n_steps=STEPS - len(jt))
    assert jt + rest == ref["tokens"]


@pytest.mark.parametrize("quant", [False, "int8"])
def test_handoff_restart_paged_snapshot_roundtrip_token_exact(ref, tmp_path,
                                                              quant):
    """A restart's recovery: snapshot the bare PagedState + pool
    mid-decode, rebuild BOTH from disk, and continue: no re-prefill, no
    re-decode, the stream equal to the uninterrupted one."""
    cfg = _cfg("auto")
    st, pool = pd.init_paged_state(cfg, slots=2, n_pages=N_PAGES, page=PAGE,
                                   max_pages_per_seq=6, quantize=quant,
                                   device="cpu")
    last, st = ring_prefill_to_pages(ref["params"], ref["prompt"], st, pool,
                                     0, cfg, {"sp": 4})
    st = pd.provision_capacity(st, pool, 0, STEPS)
    first = int(last.argmax())
    out, st = handoff_decode(ref["params"], st, cfg, {"sp": 4}, slot=0,
                             last_token=first, n_steps=1)
    path = str(tmp_path / "handoff.npz")
    save_paged_snapshot(path, st, pool, extra={"stream": [first] + out})
    rest0, _ = handoff_decode(ref["params"], st, cfg, {"sp": 4}, slot=0,
                              last_token=out[-1], n_steps=STEPS - 2)
    avail = pool.available
    del st, pool                            # the replacement reads the disk

    st, pool, extra = load_paged_snapshot(path, device="cpu")
    assert pool.available == avail and pool.dtype == (quant or None)
    stream = [int(t) for t in extra["stream"]]
    rest, st = handoff_decode(ref["params"], st, cfg, {"sp": 4}, slot=0,
                              last_token=stream[-1],
                              n_steps=STEPS - len(stream))
    assert rest == rest0
    if not quant:
        assert stream + rest == ref["tokens"]


def test_handoff_stall_restartable_strides_token_exact(ref):
    """Decode strides are restartable (the state is explicit): any split
    of the decode gives the same stream; a slot stepped past its
    provisioned pages raises instead of writing into the sink."""
    cfg = _cfg("auto")
    first, st, _ = _prefilled(ref, cfg)
    out = [first]
    for stride in (1, STEPS - 2):
        toks, st = handoff_decode(ref["params"], st, cfg, {"sp": 4}, slot=0,
                                  last_token=out[-1], n_steps=stride)
        out.extend(toks)
    assert out == ref["tokens"]
    with pytest.raises(RuntimeError, match="NaN"):
        handoff_decode(ref["params"], st, cfg, {"sp": 4}, slot=0,
                       last_token=out[-1], n_steps=PAGE)
