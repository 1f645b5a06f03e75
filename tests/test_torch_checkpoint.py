"""Port parity for crash-consistent serving (serving/checkpoint.py and the
engines' journal hooks), fp32 on the CPU with the JAX package's weights
(params_from_jax): the journals of the same seeded traffic equal the JAX
engines' line for line, recovery from a JAX-written journal gives JAX's
streams, bare paged snapshots read in both directions on every pool
dtype, a JAX engine snapshot is refused, and the prefix cache's index
round-trips as JAX writes it.  Then ports of the JAX package's checkpoint
tests (tests/test_checkpoint_serve.py, the prefix-cache and pipelined
journal cases) on the port's engines, synchronous and pipelined."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from burst_attn_tpu.models import ModelConfig as JModelConfig
from burst_attn_tpu.models import ServeEngine as JServeEngine
from burst_attn_tpu.models import init_params as j_init_params
from burst_attn_tpu.models import paged_decode as jpd
from burst_attn_tpu.serving import RaggedServeEngine as JRaggedServeEngine
from burst_attn_tpu.serving import checkpoint as jckpt
from burst_attn_tpu_torch import obs
from burst_attn_tpu_torch.models import paged_decode as pd
from burst_attn_tpu_torch.models.serve import ServeEngine
from burst_attn_tpu_torch.models.transformer import (
    ModelConfig, params_from_jax,
)
from burst_attn_tpu_torch.serving import RaggedServeEngine
from burst_attn_tpu_torch.serving import checkpoint as ckpt

DIMS = dict(vocab=97, d_model=32, n_layers=1, n_heads=2, n_kv_heads=1,
            d_head=16, d_ff=64)
ENGINE = dict(slots=2, n_pages=6, page=128, max_pages_per_seq=2)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
MAX_NEW = 8
CRASH_STEP = 6          # steps before the "SIGKILL"
KINDS = {"ragged": dict(chunk=8), "legacy": {},
         "pipelined": dict(chunk=8, pipeline=True, multi_step=4)}


@pytest.fixture(scope="module")
def model():
    jcfg = JModelConfig(**DIMS, dtype=jnp.float32, attn_backend="jnp",
                        remat=False, batch_axis=None, head_axis=None)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    cfg = ModelConfig(**DIMS, dtype=torch.float32, batch_axis=None,
                      head_axis=None)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, params


def _engine(model, kind, journal=None, **over):
    _, _, cfg, params = model
    cls = ServeEngine if kind == "legacy" else RaggedServeEngine
    return cls(params, cfg, **{**ENGINE, **KINDS[kind], **over},
               journal=journal, device="cpu")


def _jengine(model, kind, journal=None, **over):
    jcfg, jparams, _, _ = model
    if kind == "legacy":
        return JServeEngine(jparams, jcfg, **ENGINE, journal=journal, **over)
    return JRaggedServeEngine(jparams, jcfg,
                              **{**ENGINE, **KINDS[kind], **over},
                              use_ragged=False, journal=journal)


def _submit_all(eng, journal=None):
    rids = []
    for i, p in enumerate(PROMPTS):
        res = eng.try_submit(p, MAX_NEW)
        assert res.ok, res
        rids.append(res.rid)
        if journal is not None:
            journal.submit(res.rid, i + 100, p, MAX_NEW)
    if journal is not None:
        journal.sync()
    return rids


def _journaled_run(make, journal_mod, path):
    """The seeded traffic through a journaled engine: CRASH_STEP steps
    (the journal as a kill then would leave it is copied aside), then to
    the end.  Returns (streams delivered before the kill by external rid,
    the whole run's streams by external rid, the crash image's path)."""
    journal = journal_mod.TokenJournal(path, truncate=True)
    eng = make(journal)
    _submit_all(eng, journal)
    delivered = {}
    for _ in range(CRASH_STEP):
        for rid, toks in eng.step():
            delivered[rid + 100] = [int(t) for t in toks]
    crash = path + ".crash"
    shutil.copyfile(path, crash)
    out = {rid + 100: [int(t) for t in toks]
           for rid, toks in eng.run().items()}
    journal.close()
    return delivered, out, crash


@pytest.fixture(scope="module")
def jax_runs(model, tmp_path_factory):
    """Per engine kind: the JAX engine's journaled run (journal file,
    crash image, delivered, streams) and its journal-only recovery from
    the crash image."""
    out = {}
    for kind in ("ragged", "legacy"):
        d = tmp_path_factory.mktemp(f"jax_{kind}")
        path = str(d / "journal.jsonl")
        delivered, streams, crash = _journaled_run(
            lambda j: _jengine(model, kind, j), jckpt, path)
        eng = _jengine(model, kind)
        info = jckpt.recover_engine(eng, None, crash)
        rec = dict(delivered)
        rec.update({k: [int(t) for t in v]
                    for k, v in jckpt.run_recovered(eng, info).items()})
        out[kind] = dict(path=path, crash=crash, delivered=delivered,
                         streams=streams, recovered=rec,
                         replayed=info.total_replayed,
                         baseline=info.baseline_replay)
    return out


@pytest.mark.parametrize("kind", ["ragged", "legacy"])
def test_journal_records_equal_jax(model, jax_runs, kind, tmp_path):
    """The same seeded traffic through the JAX package's journaled engine
    and the port's: the journals are equal line for line, both at the
    kill and at the end, and so are the streams."""
    want = jax_runs[kind]
    path = str(tmp_path / "journal.jsonl")
    delivered, streams, crash = _journaled_run(
        lambda j: _engine(model, kind, j), ckpt, path)
    assert streams == want["streams"]
    assert delivered == want["delivered"]
    for mine, theirs in ((path, want["path"]), (crash, want["crash"])):
        a = open(mine).read().splitlines()
        b = open(theirs).read().splitlines()
        assert a == b
    view = ckpt.journal_view(path)
    assert view.done == {0, 1, 2}
    assert {r + 100: t for r, t in view.tokens.items()} == streams


@pytest.mark.parametrize("kind", ["ragged", "legacy"])
def test_recover_from_a_jax_journal(model, jax_runs, kind):
    """The port's recover_engine on the JAX engine's crash image (no
    snapshot) gives the JAX package's run_recovered streams, which are the
    uninterrupted ones."""
    want = jax_runs[kind]
    eng = _engine(model, kind)
    info = ckpt.recover_engine(eng, None, want["crash"])
    assert not info.from_snapshot
    out = dict(want["delivered"])
    out.update(ckpt.run_recovered(eng, info))
    assert out == want["recovered"] == want["streams"]
    assert (info.total_replayed, info.baseline_replay) == \
        (want["replayed"], want["baseline"])


def _mirrors_match(eng):
    """The ragged engine's host mirrors equal the device state."""
    if isinstance(eng, RaggedServeEngine):
        assert np.array_equal(eng._lengths, eng.state.lengths.numpy())
        assert np.array_equal(eng._table, eng.state.page_table.numpy())


@pytest.mark.parametrize("kind", list(KINDS))
def test_snapshot_restore_roundtrip_token_exact(model, kind, tmp_path):
    """Mid-flight snapshot -> fresh engine -> identical remaining streams:
    page banks, page table, per-request metadata and the queue survive the
    disk round trip; the restore writes into the engine's own tensors and
    the ragged engine's host mirrors follow the device state."""
    path = str(tmp_path / "snap.npz")
    eng = _engine(model, kind)
    _submit_all(eng)
    for _ in range(3):
        eng.step()
    ckpt.save_snapshot(eng, path, extra={"tag": "roundtrip"})
    free_at_snap = list(eng.pool._free)
    expect = eng.run()

    eng2 = _engine(model, kind)
    banks = [t.data_ptr() for t in eng2.state.k_pages + eng2.state.v_pages]
    extra = ckpt.restore_into(eng2, ckpt.load_snapshot(path))
    assert extra["tag"] == "roundtrip"
    assert eng2.pool._free == free_at_snap  # allocator state round-trips
    assert [t.data_ptr() for t in eng2.state.k_pages + eng2.state.v_pages] \
        == banks                             # written in place
    _mirrors_match(eng2)
    assert eng2.run() == expect


@pytest.mark.parametrize("kind", list(KINDS))
def test_sampled_engine_rng_state_restores_stream(model, kind, tmp_path):
    """The generator's state is part of the snapshot: a temperature>0
    engine restored mid-run continues the SAME sampled stream."""
    path = str(tmp_path / "snap.npz")
    eng = _engine(model, kind, temperature=0.8, top_k=8)
    _submit_all(eng)
    for _ in range(3):
        eng.step()
    ckpt.save_snapshot(eng, path)
    expect = eng.run()

    eng2 = _engine(model, kind, temperature=0.8, top_k=8)
    ckpt.restore_into(eng2, ckpt.load_snapshot(path))
    assert eng2.run() == expect


@pytest.mark.parametrize("kind", list(KINDS))
def test_journal_crash_recovery_resumes_not_replays(model, kind, tmp_path):
    """Crash with a step-4 snapshot + step-6 journal, recover, finish:
    token-exact with the uninterrupted run AND
    recovered_tokens_replayed strictly below the replay-from-scratch
    baseline; journal-only recovery is token-exact too."""
    snap = str(tmp_path / "snap.npz")
    jour = str(tmp_path / "journal.jsonl")
    jour2 = str(tmp_path / "journal2.jsonl")
    eng = _engine(model, kind)
    _submit_all(eng)
    oracle = {i + 100: t for i, t in eng.run().items()}

    journal = ckpt.TokenJournal(jour, truncate=True)
    eng = _engine(model, kind, journal=journal)
    _submit_all(eng, journal=journal)
    delivered = {}
    for step in range(CRASH_STEP):
        for rid, toks in eng.step():
            delivered[rid + 100] = toks
        if step == 3:
            ckpt.save_snapshot(
                eng, snap,
                extra={"rid_map": {i: i + 100 for i in range(3)},
                       "resume_prefix": {}})
    del eng, journal                        # the "SIGKILL"

    replayed0 = obs.counter("serve.recovered_tokens_replayed").get()
    eng = _engine(model, kind)
    info = ckpt.recover_engine(eng, snap, jour)
    assert info.from_snapshot
    assert obs.counter("serve.recovered_tokens_replayed").get() \
        - replayed0 == info.total_replayed
    eng.journal = ckpt.rewrite_journal(eng, jour2, info.rid_map,
                                       info.resume_prefix)
    out = dict(delivered)
    out.update(ckpt.run_recovered(eng, info))
    assert out == oracle
    assert 0 < info.total_replayed < info.baseline_replay
    # the rewritten journal alone carries the recovered requests to their
    # ends
    eng.journal.close()
    view = ckpt.journal_view(jour2)
    assert view.tokens and view.done == set(view.tokens)
    for rid, toks in view.tokens.items():
        assert toks == oracle[info.rid_map.get(rid, rid)]

    # journal-only recovery (no snapshot survived) is also token-exact
    eng = _engine(model, kind)
    info = ckpt.recover_engine(eng, None, jour)
    assert not info.from_snapshot
    out = dict(delivered)
    out.update(ckpt.run_recovered(eng, info))
    assert out == oracle


def test_sampled_journal_prefix_resume_rejected(model, tmp_path):
    """Journal-prefix resume teacher-forces via prompt concat: only sound
    for greedy decoding, so a sampled engine refuses loudly."""
    path = str(tmp_path / "j.jsonl")
    j = ckpt.TokenJournal(path, truncate=True)
    j.submit(0, 100, [1, 2, 3], 6)
    j.tokens(0, [5, 6])
    j.sync()
    j.close()
    eng = _engine(model, "ragged", temperature=0.8)
    with pytest.raises(ValueError, match="greedy"):
        ckpt.recover_engine(eng, None, path)


def test_snapshot_kind_and_version_mismatch_raise(model, tmp_path):
    path = str(tmp_path / "snap.npz")
    eng = _engine(model, "ragged")
    _submit_all(eng)
    eng.step()
    ckpt.save_snapshot(eng, path)
    leg = _engine(model, "legacy")
    with pytest.raises(ValueError, match="kind|ragged|legacy"):
        ckpt.restore_into(leg, ckpt.load_snapshot(path))
    for over, pat in ((dict(n_pages=8), "geometry"),
                      (dict(quantize="int8"), "dtype")):
        other = _engine(model, "ragged", **over)
        with pytest.raises(ValueError, match=pat):
            ckpt.restore_into(other, ckpt.load_snapshot(path))
        assert other.pool.available == other.pool.n_pages - 1
        assert int(other.state.lengths.sum()) == 0
    _, _, cfg, params = model
    bf16 = RaggedServeEngine(params, dataclasses.replace(
        cfg, dtype=torch.bfloat16), **ENGINE, chunk=8, device="cpu")
    with pytest.raises(ValueError, match="hold"):
        ckpt.restore_into(bf16, ckpt.load_snapshot(path))

    bad = str(tmp_path / "bad.npz")
    ckpt._atomic_savez(bad, {"version": 99, "kind": "ragged"}, {})
    with pytest.raises(ValueError, match="version"):
        ckpt.load_snapshot(bad)


def test_atomic_save_leaves_no_tmp(model, tmp_path):
    path = str(tmp_path / "snap.npz")
    eng = _engine(model, "ragged")
    _submit_all(eng)
    eng.step()
    ckpt.save_snapshot(eng, path)
    assert os.path.exists(path)
    assert not os.path.exists(path + ".tmp")


def test_jax_engine_snapshot_is_refused(model, tmp_path):
    """A JAX engine snapshot holds a PRNG key, not a generator state: the
    port refuses it with a ValueError that names the RNG, before it
    changes anything."""
    path = str(tmp_path / "jax.npz")
    jeng = _jengine(model, "ragged")
    _submit_all(jeng)
    jeng.step()
    jckpt.save_snapshot(jeng, path)
    snap = ckpt.load_snapshot(path)
    assert snap["meta"]["kind"] == "ragged"
    eng = _engine(model, "ragged")
    free0 = list(eng.pool._free)
    with pytest.raises(ValueError, match="RNG"):
        ckpt.restore_into(eng, snap)
    assert eng.pool._free == free0 and not eng._queue and eng.live == 0
    assert int(eng.state.lengths.sum()) == 0
    assert not eng.state.k_pages[0].any()


def _fill(gen, shape, quant):
    """Random page contents of a pool dtype, as float32 numbers."""
    x = gen.standard_normal(shape).astype(np.float32)
    if quant == "int8":
        return np.clip(np.round(x * 40), -127, 127)
    return x


POOLS = [("fp32", torch.float32, jnp.float32, False),
         ("bf16", torch.bfloat16, jnp.bfloat16, False),
         ("int8", torch.float32, jnp.float32, "int8"),
         ("fp8", torch.float32, jnp.float32, "fp8")]


@pytest.mark.parametrize("name,dtype,jdtype,quant", POOLS,
                         ids=[p[0] for p in POOLS])
def test_paged_snapshot_reads_both_ways(model, tmp_path, name, dtype, jdtype,
                                        quant):
    """save_paged_snapshot of each package loads in the other's
    load_paged_snapshot with equal banks (bitwise), scales, table,
    lengths and allocator state: bf16 and fp8 banks travel as raw bytes
    under the JAX dtype names."""
    gen = np.random.default_rng(3)
    kw = dict(slots=2, n_pages=6, page=128, max_pages_per_seq=2,
              quantize=quant)
    st, pool = pd.init_paged_state(
        ModelConfig(**DIMS, dtype=dtype, batch_axis=None, head_axis=None),
        device="cpu", **kw)
    ids = pool.acquire(3)
    pool.share(ids[:1])
    for banks in (st.k_pages, st.v_pages):
        for b in banks:
            b.copy_(torch.from_numpy(_fill(gen, b.shape, quant)).to(b.dtype))
    if quant:
        for banks in (st.k_scales, st.v_scales):
            for b in banks:
                b.copy_(torch.from_numpy(gen.random(b.shape).astype(
                    np.float32)))
    st.page_table[0, :2] = torch.tensor(ids[:2], dtype=torch.int32)
    st.lengths[0] = 200

    def raw(a):
        """A bank's bytes, from a torch tensor or a JAX array."""
        if torch.is_tensor(a):
            a = ckpt._host_array(a)
        return np.asarray(a).view(np.uint8)

    mine = str(tmp_path / "port.npz")
    ckpt.save_paged_snapshot(mine, st, pool, extra={"stream": [1, 2]})
    jst, jpool, extra = jckpt.load_paged_snapshot(mine)
    assert extra == {"stream": [1, 2]}
    assert jpool._free == pool._free and jpool._refs == pool._refs
    assert jpool.dtype == pool.dtype
    fields = ["k_pages", "v_pages"] + (["k_scales", "v_scales"]
                                       if quant else [])
    for f in fields:
        for a, b in zip(getattr(st, f), getattr(jst, f)):
            assert np.array_equal(raw(a), raw(b)), f
    assert np.array_equal(st.page_table.numpy(), np.asarray(jst.page_table))
    assert np.array_equal(st.lengths.numpy(), np.asarray(jst.lengths))

    # and back: the JAX package writes its state, the port reads it
    theirs = str(tmp_path / "jax.npz")
    jckpt.save_paged_snapshot(theirs, jst, jpool, extra={"n": 1})
    st2, pool2, extra = ckpt.load_paged_snapshot(theirs, device="cpu")
    assert extra == {"n": 1}
    assert pool2._free == pool._free and pool2._refs == pool._refs
    assert pool2.dtype == pool.dtype and st2.k_pages[0].dtype == \
        st.k_pages[0].dtype
    for f in fields:
        for a, b in zip(getattr(st2, f), getattr(st, f)):
            assert np.array_equal(raw(a), raw(b)), f
    assert torch.equal(st2.page_table, st.page_table)
    assert torch.equal(st2.lengths, st.lengths)
    # the JAX init of the same spec has the port's geometry
    jst0, _ = jpd.init_paged_state(
        JModelConfig(**DIMS, dtype=jdtype, attn_backend="jnp", remat=False,
                     batch_axis=None, head_axis=None), **kw)
    assert tuple(jst0.k_pages[0].shape) == tuple(st.k_pages[0].shape)


PREFIX_ENGINE = dict(slots=2, n_pages=10, page=128, max_pages_per_seq=2,
                     chunk=64, prefix_cache=True)


def _shared_prompts(rng):
    """One 128-token template (one cacheable page), two suffixed prompts
    and the exact template (the full-prompt hit whose re-absorbed last
    token is the copy-on-write write)."""
    tmpl = rng.integers(1, DIMS["vocab"], size=128)
    return [np.concatenate([tmpl, rng.integers(1, DIMS["vocab"], size=5)]),
            np.concatenate([tmpl, rng.integers(1, DIMS["vocab"], size=9)]),
            tmpl.copy()]


def _serve(eng, prompts, max_new=4):
    rids = [eng.submit(p, max_new) for p in prompts]
    res = eng.run()
    return [[int(t) for t in res[r]] for r in rids]


def test_prefix_cache_meta_matches_jax(model):
    """After the same cached wave, the port's PrefixCache.to_meta equals
    the JAX package's (hashes, page ids, parents, LRU order), and
    from_meta rebuilds the index without bumping a refcount."""
    jcfg, jparams, cfg, params = model
    prompts = _shared_prompts(np.random.default_rng(0xFACE))
    jeng = JRaggedServeEngine(jparams, jcfg, use_ragged=False,
                              **PREFIX_ENGINE)
    eng = RaggedServeEngine(params, cfg, device="cpu", **PREFIX_ENGINE)
    for _ in range(2):
        assert _serve(eng, prompts) == _serve(jeng, prompts)
    meta = eng.cache.to_meta()
    assert meta == jeng.cache.to_meta() and len(meta) == 1
    assert eng.pool._refs == jeng.pool._refs
    refs = list(eng.pool._refs)
    again = pd.PrefixCache.from_meta(eng.pool, meta)
    assert eng.pool._refs == refs
    assert again.to_meta() == meta
    with pytest.raises(ValueError, match="free page"):
        pd.PrefixCache.from_meta(pd.PagePool(10), meta)


def test_checkpoint_roundtrip_mid_shared_flight(model, tmp_path):
    """Snapshot an engine while slots share pinned prefix pages; restore
    into a fresh prefix_cache=True engine: remaining streams equal, the
    index still hits, refcounts drain to zero.  A cache-carrying snapshot
    REFUSES a cache-less restore target."""
    _, _, cfg, params = model

    def build(**over):
        return RaggedServeEngine(params, cfg, device="cpu",
                                 **{**PREFIX_ENGINE, **over})

    prompts = _shared_prompts(np.random.default_rng(0xFACE))
    eng = build()
    wave1 = _serve(eng, prompts)
    rids = [eng.submit(p, 4) for p in prompts]
    eng.step()           # wave 2 mid-flight: admissions pinned shared pages
    assert eng._shared
    path = str(tmp_path / "shared.npz")
    ckpt.save_snapshot(eng, path)
    pins = {s: tuple(p) for s, p in
            ckpt.load_snapshot(path)["meta"]["shared"]}
    assert pins
    expect = eng.run()

    bad = build(prefix_cache=False)
    with pytest.raises(ValueError, match="prefix_cache=True"):
        ckpt.restore_into(bad, ckpt.load_snapshot(path))

    eng2 = build()
    ckpt.restore_into(eng2, ckpt.load_snapshot(path))
    assert eng2._shared == pins
    _mirrors_match(eng2)
    res = eng2.run()
    assert [res[r] for r in rids] == [expect[r] for r in rids]
    assert [res[r] for r in rids] == wave1  # still the uncached oracle
    hits0 = eng2.stats["serve.prefix_hits"]
    assert _serve(eng2, prompts) == wave1
    assert eng2.stats["serve.prefix_hits"] - hits0 >= 3
    eng2.drain()
    eng2.cache.evict(eng2.pool.n_pages)
    assert eng2.pool.in_use == 0 and eng2.pool.logical_refs == 0


def test_pipelined_deferred_journal_ordering(model, tmp_path):
    """Delivery lags one step but durability does not: while a launch is
    in flight its tokens are journaled by a later readback, fsynced, and
    only then delivered.  The journal machine behind
    TokenJournal.delivered raises DurabilityViolation on any token
    returned before its fsync, so a clean run is the proof; the folded
    journal ends equal to the delivered streams."""
    _, _, cfg, params = model
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, DIMS["vocab"], size=n) for n in (9, 5, 13, 3)]
    steps = [5, 4, 6, 3]
    path = str(tmp_path / "pipe.jsonl")
    journal = ckpt.TokenJournal(path, truncate=True)
    eng = RaggedServeEngine(params, cfg, slots=2, n_pages=10, page=128,
                            max_pages_per_seq=4, chunk=4, journal=journal,
                            pipeline=True, multi_step=4, device="cpu")
    rids = []
    for p, s in zip(prompts, steps):
        res = eng.try_submit(p, s)
        assert res.ok
        journal.submit(res.rid, res.rid, p, s)
        rids.append(res.rid)
    journal.sync()

    lagged = False
    out = {}
    for _ in range(10_000):
        for rid, toks in eng.step():
            out[rid] = toks
        if eng._pending is not None:
            durable = sum(len(t) for t in
                          ckpt.journal_view(path).tokens.values())
            lagged = lagged or durable < sum(steps)
        if len(out) == len(rids):
            break
    assert lagged, "pipeline never had a launch in flight"
    assert eng._pending is None
    view = ckpt.journal_view(path)
    for rid in rids:
        assert view.tokens[rid] == out[rid]
        assert rid in view.done


@pytest.mark.parametrize("kind", ["ragged", "legacy", "pipelined"])
def test_drain_journals_resets(model, kind, tmp_path):
    """drain() requeues in-flight work: one reset record each, fsynced;
    the journal's fold after run() equals the results."""
    path = str(tmp_path / "j.jsonl")
    journal = ckpt.TokenJournal(path, truncate=True)
    eng = _engine(model, kind, journal=journal)
    _submit_all(eng, journal)
    for _ in range(2):
        eng.step()
    requeued = eng.drain()
    assert requeued
    recs, _ = ckpt.read_journal(path)
    assert {r["rid"] for r in recs if r["record"] == "reset"} == \
        set(requeued)
    res = eng.run()
    view = ckpt.journal_view(path)
    assert view.tokens == res and view.done == set(res)


@pytest.mark.parametrize("cls", [ServeEngine, RaggedServeEngine])
def test_draft_engines_journal_and_refuse_snapshot(model, cls, tmp_path):
    """A self-draft engine journals every kept token of its rounds (the
    fold equals the streams, which equal the plain engine's); snapshot
    refuses it, as in the JAX package."""
    _, _, cfg, params = model
    extra = {} if cls is ServeEngine else dict(chunk=8)
    path = str(tmp_path / "j.jsonl")
    journal = ckpt.TokenJournal(path, truncate=True)
    eng = cls(params, cfg, slots=2, n_pages=12, page=128,
              max_pages_per_seq=2, draft_params=params, draft_cfg=cfg,
              spec_k=3, journal=journal, device="cpu", **extra)
    plain = cls(params, cfg, slots=2, n_pages=12, page=128,
                max_pages_per_seq=2, device="cpu", **extra)
    _submit_all(eng, journal)
    _submit_all(plain)
    eng.step()
    eng.step()
    with pytest.raises(ValueError, match="draft"):
        ckpt.save_snapshot(eng, str(tmp_path / "s.npz"))
    res = eng.run()
    assert eng.spec_rounds > 0
    assert res == plain.run()
    view = ckpt.journal_view(path)
    assert view.tokens == res and view.done == set(res)


@pytest.mark.parametrize("kind", list(KINDS))
def test_delivery_without_fsync_raises(model, kind, tmp_path):
    """The delivery barrier is live on every engine: with a journal whose
    sync() does nothing, the first stream a step() returns raises
    DurabilityViolation instead of reaching the caller."""
    from burst_attn_tpu_torch.protocols.journal import DurabilityViolation

    class NoSync(ckpt.TokenJournal):
        def sync(self):
            pass

    eng = _engine(model, kind,
                  journal=NoSync(str(tmp_path / "j.jsonl"), truncate=True))
    _submit_all(eng)
    with pytest.raises(DurabilityViolation, match="must run"):
        eng.run()


def test_generator_device_mismatch_is_refused(model, tmp_path):
    """A snapshot's generator state restores only into a generator of the
    same device type; the refusal changes nothing."""
    path = str(tmp_path / "snap.npz")
    eng = _engine(model, "ragged")
    _submit_all(eng)
    eng.step()
    ckpt.save_snapshot(eng, path)
    snap = ckpt.load_snapshot(path)
    assert snap["meta"]["rng"]["device"] == "cpu"
    snap["meta"]["rng"]["device"] = "cuda"
    eng2 = _engine(model, "ragged")
    with pytest.raises(ValueError, match="generator"):
        ckpt.restore_into(eng2, snap)
    assert not eng2._queue and eng2.pool.available == eng2.pool.n_pages - 1
