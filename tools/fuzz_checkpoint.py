#!/usr/bin/env python
"""Checkpoint-recovery fuzz for the PyTorch port (the port of the JAX
package's scripts/fuzz_checkpoint.py): random kill points, N seeds,
token-exact every time, on the card unless `--device cpu` is given.

Per seed, an in-process RaggedServeEngine runs a small random workload
with the write-ahead journal attached; a snapshot lands at a random step
and the engine is "SIGKILLed" (dropped, no drain/close) at a later random
step.  Recovery then proves, for BOTH paths:

  snapshot+journal   restore_into + journal roll-forward (resume)
  journal-only       prefix teacher-forcing from the journal alone

that the delivered streams are bit-identical to an uninterrupted oracle
run, and that resumed recovery re-decoded no more than the
replay-from-scratch baseline (strictly fewer on at least one seed).  A
torn final journal line is injected on every seed and must be tolerated.
`--engines ragged,legacy` runs the same seeds through the ServeEngine too
(kernel 1 prefills, kernel 6 decodes).

`--cache-seeds N` fuzzes the prefix cache's serialization: a
cache-enabled engine runs a shared-prefix workload and is killed
MID-CoW-COPY (inside serving/model.py `_copy_pages`: replacement page
acquired, shared ref not yet dropped), MID-SHARED-ADMISSION (prefix pages
pinned by `PrefixCache.lookup`, not yet assigned to the slot) and
MID-SCALE-SCATTER: an fp8 pool killed INSIDE models/paged_decode.py
`_write_tokens`, after the token bytes were written and before their
scales were — the port writes the pool in place, so unlike the JAX
package's atomic tick this tears a (page, scale) pair in memory.
Recovery restores the snapshot and must be token-exact against an
UNCACHED oracle (a quantized one for the fp8 pool, whose restored banks
must come back fp8 with fp32 scales), and `verify_pool_integrity` must
recount every page's refcount from the live tables and the cache index:
zero leaked, zero double-freed pages, and a full evict drains the pool.

`--pipeline-seeds N` fuzzes the pipelined engine's delivery lag: a
pipeline=True multi_step=4 engine is killed MID-PIPELINE-FLIGHT (at
serving/engine.py `_readback_choices`, the launch's choices never read
back), MID-MULTI-STEP-SCAN (at the dispatch of a fused K-step
`multi_step_decode`) and MID-READBACK (inside `TokenJournal.sync`, the
readback's records buffered, not durable); a fresh pipelined engine
recovering from snapshot+journal must match a SYNCHRONOUS oracle.

`--transport-seeds N` fuzzes the fleet wire protocol: framed messages
truncated, bit-flipped and duplicated; the FrameBuffer must drop every
corrupted frame on its CRC, count torn tails, dedup redelivery, and a
resend of the missing messages must complete the set byte-exactly.

The kill points are named by transitions of the model checker's pool and
journal models (`analysis.modelcheck.event_vocabulary`), so the fuzzer
and the checker cannot drift apart silently.  The model is built once
and shared by every seed: on the card the serving model's full width
(CARD_MODEL_SPEC) at 2 layers, fp32; on the CPU the JAX fuzzer's tiny
MODEL_SPEC.

    python tools/fuzz_checkpoint.py [--device cpu] [--seeds 3]
        [--requests 4] [--cache-seeds 2] [--pipeline-seeds 0]
        [--transport-seeds 0] [--engines ragged]
"""

import argparse
import os
import sys
import tempfile
from typing import Dict, NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

MODEL_SPEC = dict(vocab=97, d_model=32, n_layers=1, n_heads=2,
                  n_kv_heads=1, d_head=16, d_ff=64, seed=0)
# the serving model's full width (chip_smoke.py SERVE_DIMS) at 2 layers
CARD_MODEL_SPEC = dict(vocab=32768, d_model=2048, n_layers=2, n_heads=16,
                       n_kv_heads=4, d_head=128, d_ff=8192, seed=0)
ENGINE_SPEC = dict(slots=2, n_pages=8, page=128, max_pages_per_seq=2,
                   chunk=8)
CACHE_ENGINE_SPEC = dict(slots=2, n_pages=10, page=128, max_pages_per_seq=2,
                         chunk=64)
PIPE_ENGINE_SPEC = dict(ENGINE_SPEC, pipeline=True, multi_step=4)
TOKENS = 97  # prompt ids are drawn below this on every model

# The cache-fuzz kill points, named by the model checker's pool-model
# transitions (checker_kill_modes validates them).
KILL_POINTS = {
    # inside the CoW privatization (replacement acquired, shared ref not
    # yet dropped) — the checker's CoW-barrier append step
    "mid-cow": "append B (CoW barrier + write)",
    # after the prefix-cache hit pinned pages (refcounts bumped, slot not
    # yet wired) — the checker's cache-hit admission step
    "mid-admission": "admit B (cache hit: share + acquire 1)",
    # inside the quantized token write (fp8 pool), between the bytes and
    # their scales — the write half of the checker's append step
    "mid-scale-scatter": "append B (CoW barrier + write)",
}

# The pipelined kill points, named by the journal model's transitions.
PIPELINE_KILL_POINTS = {
    # between dispatch and the deferred readback: the sampled token(s)
    # exist on the device only — never journaled, never delivered
    "mid-pipeline-flight": "pipelined launch (defer readback)",
    # the same window with a fused K-step launch in flight
    "mid-multi-step-scan": "pipelined launch (defer readback)",
    # after readback appended the journal records, before the fsync
    "mid-readback": "pipelined step boundary (readback + sync + deliver)",
}

LAUNCH_KEYS = ("ragged_paged_attention", "flash_fwd",
               "paged_decode_attention")


class SimKill(BaseException):
    """Simulated SIGKILL: derives from BaseException so no engine-level
    `except Exception` rollback runs — a real kill runs nothing."""


class FuzzModel(NamedTuple):
    params: dict
    cfg: object
    device: object


def load_model(device=None, spec=None) -> FuzzModel:
    """The fuzz model, built once: `spec` (default MODEL_SPEC on the CPU,
    CARD_MODEL_SPEC on the card) in fp32 on `device` (None: the card; it
    raises without one)."""
    from burst_attn_tpu_torch.device import resolve_device
    from burst_attn_tpu_torch.loadgen.worker import model_from_spec

    dev = resolve_device(device)
    if spec is None:
        spec = MODEL_SPEC if dev.type == "cpu" else CARD_MODEL_SPEC
    return FuzzModel(*model_from_spec(dict(spec, device=str(dev))))


def build_engine(model: FuzzModel, engine_spec: dict, journal=None):
    """An engine of `engine_spec` ("kind": "ragged" default, or "legacy",
    the ServeEngine, which takes no chunk) on the shared weights."""
    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    es = dict(engine_spec)
    if es.pop("kind", "ragged") == "legacy":
        es.pop("chunk", None)
        return ServeEngine(model.params, model.cfg, journal=journal,
                           device=model.device, **es)
    return RaggedServeEngine(model.params, model.cfg, journal=journal,
                             device=model.device, **es)


def launch_counts() -> Dict[str, int]:
    """Kernel 7 / 1 / 6 launch counters (the wrappers count card launches
    only)."""
    from burst_attn_tpu_torch.ops import flash, paged_attention, ragged_paged

    return {"ragged_paged_attention":
            ragged_paged.ragged_paged_attention.launches,
            "flash_fwd": flash.flash_fwd.launches,
            "paged_decode_attention":
            paged_attention.paged_decode_attention.launches}


def _since(before):
    now = launch_counts()
    return {k: now[k] - before[k] for k in LAUNCH_KEYS}


def checker_kill_modes():
    """The cache fuzz modes, validated against the pool model's
    enumerated transition steps."""
    from burst_attn_tpu_torch.analysis import modelcheck as mc

    vocab = mc.event_vocabulary(mc.pool_model())
    for mode, label in KILL_POINTS.items():
        assert label in vocab, (
            f"fuzz mode {mode!r} names checker step {label!r} which the "
            f"pool model no longer enumerates; vocabulary: {vocab}")
    return tuple(KILL_POINTS)


def pipeline_kill_modes():
    """The pipelined fuzz modes, validated against the journal model's
    enumerated transition steps."""
    from burst_attn_tpu_torch.analysis import modelcheck as mc

    vocab = mc.event_vocabulary(mc.journal_model())
    for mode, label in PIPELINE_KILL_POINTS.items():
        assert label in vocab, (
            f"fuzz mode {mode!r} names checker step {label!r} which the "
            f"journal model no longer enumerates; vocabulary: {vocab}")
    return tuple(PIPELINE_KILL_POINTS)


def seed_workload(seed: int, n_requests: int, lo: int = 4, hi: int = 11,
                  salt: int = 0xC4A5):
    """(prompts, budgets) of a sync or pipeline seed: 2-8 token prompts,
    budgets in [lo, hi) (the JAX fuzzer's draws)."""
    import numpy as np

    rng = np.random.default_rng([salt, int(seed)])
    prompts = [[int(t) for t in rng.integers(1, TOKENS,
                                             int(rng.integers(2, 9)))]
               for _ in range(n_requests)]
    budgets = [int(rng.integers(lo, hi)) for _ in range(n_requests)]
    return prompts, budgets, rng


def submit_all(eng, prompts, budgets, journal=None):
    for i, (p, mx) in enumerate(zip(prompts, budgets)):
        res = eng.try_submit(p, mx)
        assert res.ok, res
        if journal is not None:
            journal.submit(res.rid, i + 100, p, mx)
    if journal is not None:
        journal.sync()


def drive(eng, n: int, out: dict) -> int:
    """Step `eng` until `n` requests have finished into `out` (rid + 100
    -> tokens); returns the steps taken."""
    steps = 0
    while len(out) < n:
        for rid, toks in eng.step():
            out[rid + 100] = toks
        steps += 1
        assert steps < 10_000
    return steps


def oracle_streams(model, prompts, budgets, engine_spec=ENGINE_SPEC):
    """(uninterrupted streams {rid + 100: tokens}, steps) of a workload."""
    eng = build_engine(model, engine_spec)
    submit_all(eng, prompts, budgets)
    out = {}
    return out, drive(eng, len(prompts), out)


def _tear(path):
    with open(path, "ab") as f:  # a partial record the reader must skip
        f.write(b'{"kind": "tokens", "rid": 0')


def run_seed(seed: int, n_requests: int, out_dir: str, model: FuzzModel,
             kind: str = "ragged") -> dict:
    from burst_attn_tpu_torch.serving import checkpoint as ckpt

    prompts, budgets, rng = seed_workload(seed, n_requests)
    spec = dict(ENGINE_SPEC, kind=kind)
    tag = f"{kind}_{seed}"
    snap = os.path.join(out_dir, f"fuzz_{tag}.npz")
    jour = os.path.join(out_dir, f"fuzz_{tag}.jsonl")
    jour2 = os.path.join(out_dir, f"fuzz_{tag}_rewrite.jsonl")

    oracle, n_total_steps = oracle_streams(model, prompts, budgets, spec)

    # crashed run: snapshot at snap_step, SIGKILL at kill_step
    snap_step = int(rng.integers(1, max(2, n_total_steps - 1)))
    kill_step = int(rng.integers(snap_step + 1, n_total_steps + 1))
    before = launch_counts()
    journal = ckpt.TokenJournal(jour, truncate=True)
    eng = build_engine(model, spec, journal=journal)
    submit_all(eng, prompts, budgets, journal=journal)
    rid_map = {i: i + 100 for i in range(n_requests)}
    delivered = {}
    for step in range(kill_step):
        for rid, toks in eng.step():
            delivered[rid_map[rid]] = toks
        if step + 1 == snap_step:
            ckpt.save_snapshot(eng, snap, extra={"rid_map": rid_map,
                                                 "resume_prefix": {}})
    del eng, journal  # the "SIGKILL": no drain, no close, no final sync
    _tear(jour)

    results = {"crash_launches": _since(before)}
    for label, snap_path in (("snapshot+journal", snap),
                             ("journal-only", None)):
        before = launch_counts()
        eng = build_engine(model, spec)
        info = ckpt.recover_engine(eng, snap_path, jour)
        assert info.n_skipped == 1, (label, info.n_skipped)
        if snap_path is not None:
            eng.journal = ckpt.rewrite_journal(eng, jour2, info.rid_map,
                                               info.resume_prefix)
        out = dict(delivered)
        out.update(ckpt.run_recovered(eng, info))
        exact = out == oracle
        bounded = info.total_replayed <= info.baseline_replay
        results[label] = dict(
            exact=exact, killed=True, replayed=info.total_replayed,
            resumed=info.total_resumed, baseline=info.baseline_replay,
            strict=info.total_replayed < info.baseline_replay,
            bounded=bounded, launches=_since(before))
        status = "OK" if exact and bounded else "FAIL"
        print(f"  seed={seed} {label:>16}: {status} "
              f"replayed={info.total_replayed} "
              f"resumed={info.total_resumed} "
              f"baseline={info.baseline_replay} "
              f"(snap@{snap_step} kill@{kill_step}/{n_total_steps})",
              flush=True)
        if not exact:
            print(f"    oracle: {oracle}\n    got:    {out}")
    return results


def _pool_table(eng):
    return eng.state.page_table.cpu().numpy()


def verify_pool_integrity(eng) -> None:
    """Recount every page's EXPECTED refcount from first principles (one
    ref per live slot table row holding it + one per prefix-cache index
    entry) and require the pool's actual `_refs` to match exactly.

    A leaked page shows up as actual > expected (held but unreachable), a
    double-free as actual < expected or as a duplicate free-list entry.
    Also proves the free list is exactly the complement of the held set."""
    pool = eng.pool
    expect = [0] * pool.n_pages
    table = _pool_table(eng)
    for slot, req in enumerate(eng.slots):
        if req is None:
            continue
        for pid in table[slot]:
            if int(pid):
                expect[int(pid)] += 1
    if getattr(eng, "cache", None) is not None:
        for pid in eng.cache._pages.values():
            expect[int(pid)] += 1
    actual = [int(r) for r in pool._refs]
    assert actual[1:] == expect[1:], (
        f"pool refcount mismatch (leak if actual>expected, double-free if "
        f"<): actual={actual} expected={expect}")
    free = [int(p) for p in pool._free]
    assert len(free) == len(set(free)), f"duplicate free-list entry: {free}"
    held = {i for i in range(1, pool.n_pages) if actual[i] > 0}
    assert set(free).isdisjoint(held), "freed page still referenced"
    assert set(free) | held == set(range(1, pool.n_pages)), \
        "page neither free nor referenced (leak)"


def _scale_write_killer(pages, scales):
    """A dispatch mode that lets the token BYTES land in `pages` and
    raises SimKill at the first write into `scales` after them: the tear
    of a (page, scale) pair that only an in-place pool can show."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Killer(TorchDispatchMode):
        bytes_written = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            target = args[0].data_ptr() if args and hasattr(
                args[0], "data_ptr") else None
            if name.startswith("index_put") and target == scales.data_ptr() \
                    and self.bytes_written:
                raise SimKill("mid-scale-scatter")
            out = func(*args, **(kwargs or {}))
            if name.startswith("index_put") and target == pages.data_ptr():
                self.bytes_written = True
            return out

    return Killer()


def _arm_cache_kill(mode, armed):
    """Install `mode`'s kill; returns the undo."""
    from burst_attn_tpu_torch.models import paged_decode as pd
    from burst_attn_tpu_torch.serving import model as serve_model

    if mode == "mid-cow":
        real_copy = serve_model._copy_pages

        def killing_copy(*a, **k):
            if armed["live"] and not armed["fired"]:
                armed["fired"] = True
                raise SimKill("mid-CoW-copy")
            return real_copy(*a, **k)

        serve_model._copy_pages = killing_copy
        return lambda: setattr(serve_model, "_copy_pages", real_copy)
    if mode == "mid-scale-scatter":
        real_write = pd._write_tokens

        def killing_write(pages, scales, page_id, offset, rows):
            if armed["live"] and not armed["fired"] and scales is not None:
                armed["fired"] = True
                killer = _scale_write_killer(pages, scales)
                try:
                    with killer:
                        real_write(pages, scales, page_id, offset, rows)
                finally:
                    armed["torn"] = killer.bytes_written
                raise AssertionError("_write_tokens never wrote its scales")
            return real_write(pages, scales, page_id, offset, rows)

        pd._write_tokens = killing_write
        return lambda: setattr(pd, "_write_tokens", real_write)
    real_lookup = pd.PrefixCache.lookup

    def killing_lookup(self, hashes):
        ids = real_lookup(self, hashes)
        if ids and armed["live"] and not armed["fired"]:
            armed["fired"] = True
            raise SimKill("mid-shared-admission")
        return ids

    pd.PrefixCache.lookup = killing_lookup
    return lambda: setattr(pd.PrefixCache, "lookup", real_lookup)


def cache_workload(seed: int, n_requests: int):
    """A shared-prefix workload: one 128-token template plus private
    suffixes, and the exact template (a full-prompt hit forces a CoW)."""
    import numpy as np

    rng = np.random.default_rng([0xCACE, int(seed)])
    tmpl = [int(t) for t in rng.integers(1, TOKENS, 128)]  # one page
    prompts = [tmpl + [int(t) for t in rng.integers(
        1, TOKENS, int(rng.integers(1, 13)))]
        for _ in range(max(1, n_requests - 1))]
    prompts.append(list(tmpl))
    budgets = [int(rng.integers(4, 11)) for _ in range(len(prompts))]
    return prompts, budgets


def run_cache_seed(seed: int, n_requests: int, out_dir: str,
                   model: FuzzModel) -> dict:
    """One prefix-cache fuzz round: kill at a cache-entangled point,
    snapshot+journal recovery, token-exact vs an UNCACHED oracle, zero
    leaked / double-freed pages."""
    import torch

    from burst_attn_tpu_torch.serving import checkpoint as ckpt

    prompts, budgets = cache_workload(seed, n_requests)
    cached_spec = dict(CACHE_ENGINE_SPEC, prefix_cache=True)
    snap = os.path.join(out_dir, f"cfuzz_{seed}.npz")
    jour = os.path.join(out_dir, f"cfuzz_{seed}.jsonl")
    jour2 = os.path.join(out_dir, f"cfuzz_{seed}_rewrite.jsonl")

    # the exactness bars: UNCACHED uninterrupted runs; the fp8 mode's is
    # the quantized pool's (same numerics, no cache, no kill)
    oracle, _ = oracle_streams(model, prompts, budgets, CACHE_ENGINE_SPEC)
    oracle_q, _ = oracle_streams(model, prompts, budgets,
                                 dict(CACHE_ENGINE_SPEC, quantize="fp8"))

    results = {}
    for mode in checker_kill_modes():
        quant = mode == "mid-scale-scatter"
        mode_spec = dict(cached_spec, quantize="fp8") if quant else cached_spec
        want = oracle_q if quant else oracle
        before = launch_counts()
        journal = ckpt.TokenJournal(jour, truncate=True)
        eng = build_engine(model, mode_spec, journal=journal)
        submit_all(eng, prompts, budgets, journal=journal)
        rid_map = {i: i + 100 for i in range(len(prompts))}
        delivered = {}
        armed = {"live": False, "fired": False, "torn": None}
        undo = _arm_cache_kill(mode, armed)
        step, killed = 0, False
        try:
            while len(delivered) < len(prompts) and step < 10_000:
                for rid, toks in eng.step():
                    delivered[rid_map[rid]] = toks
                step += 1
                if step == 1:
                    ckpt.save_snapshot(eng, snap,
                                       extra={"rid_map": rid_map,
                                              "resume_prefix": {}})
                    armed["live"] = True  # kill at the next entangled event
        except SimKill:
            killed = True
        finally:
            undo()
        del eng, journal  # the "SIGKILL": no drain, no close, no sync
        _tear(jour)

        eng = build_engine(model, mode_spec)
        info = ckpt.recover_engine(eng, snap, jour)
        assert info.n_skipped == 1, info.n_skipped
        verify_pool_integrity(eng)  # restored refcounts internally exact
        if quant:
            # the restored pool is fp8 again, every bank with fp32 scales
            assert eng.pool.dtype == "fp8", eng.pool.dtype
            assert eng.state.k_scales is not None
            assert eng.state.k_pages[0].dtype.itemsize == 1
            assert eng.state.k_scales[0].dtype == torch.float32
        eng.journal = ckpt.rewrite_journal(eng, jour2, info.rid_map,
                                           info.resume_prefix)
        out = dict(delivered)
        out.update(ckpt.run_recovered(eng, info))
        exact = out == want
        # drain-down: after every request retires only the cache holds
        # pages; a full evict must empty the pool with no stragglers
        verify_pool_integrity(eng)
        eng.cache.evict(eng.pool.n_pages)
        leak_free = (eng.pool.in_use == 0
                     and all(r == 0 for r in eng.pool._refs[1:]))
        results[mode] = dict(exact=exact, killed=killed,
                             leak_free=leak_free, torn=armed["torn"],
                             launches=_since(before))
        status = "OK" if exact and killed and leak_free else "FAIL"
        print(f"  cache seed={seed} {mode:>14}: {status} killed={killed} "
              f"exact={exact} leak_free={leak_free}", flush=True)
        if not exact:
            print(f"    oracle: {want}\n    got:    {out}")
    return results


def _arm_pipeline_kill(mode, armed):
    from burst_attn_tpu_torch.serving import checkpoint as ckpt
    from burst_attn_tpu_torch.serving import engine as eng_mod

    def killer(real, what):
        def fn(*a, **k):
            if armed["live"] and not armed["fired"]:
                armed["fired"] = True
                raise SimKill(what)
            return real(*a, **k)
        return fn

    if mode == "mid-pipeline-flight":
        real = eng_mod._readback_choices
        eng_mod._readback_choices = killer(real, mode)
        return lambda: setattr(eng_mod, "_readback_choices", real)
    if mode == "mid-multi-step-scan":
        real = eng_mod.multi_step_decode
        eng_mod.multi_step_decode = killer(real, mode)
        return lambda: setattr(eng_mod, "multi_step_decode", real)
    real = ckpt.TokenJournal.sync
    ckpt.TokenJournal.sync = killer(real, mode)
    return lambda: setattr(ckpt.TokenJournal, "sync", real)


def run_pipeline_seed(seed: int, n_requests: int, out_dir: str,
                      model: FuzzModel) -> dict:
    """One pipelined-engine fuzz round: a pipelined multi_step=4 engine is
    killed inside the delivery-lag window, then a fresh PIPELINED engine
    recovers from snapshot+journal and must deliver token-exact streams vs
    a SYNCHRONOUS uninterrupted oracle."""
    from burst_attn_tpu_torch.serving import checkpoint as ckpt

    prompts, budgets, _ = seed_workload(seed, n_requests, 6, 13, 0x717E)
    snap = os.path.join(out_dir, f"pfuzz_{seed}.npz")
    jour = os.path.join(out_dir, f"pfuzz_{seed}.jsonl")
    jour2 = os.path.join(out_dir, f"pfuzz_{seed}_rewrite.jsonl")
    oracle, _ = oracle_streams(model, prompts, budgets, ENGINE_SPEC)

    results = {}
    for mode in pipeline_kill_modes():
        before = launch_counts()
        journal = ckpt.TokenJournal(jour, truncate=True)
        eng = build_engine(model, PIPE_ENGINE_SPEC, journal=journal)
        submit_all(eng, prompts, budgets, journal=journal)
        rid_map = {i: i + 100 for i in range(n_requests)}
        delivered = {}
        armed = {"live": False, "fired": False}
        undo = _arm_pipeline_kill(mode, armed)
        step, killed = 0, False
        try:
            while len(delivered) < n_requests and step < 10_000:
                for rid, toks in eng.step():
                    delivered[rid_map[rid]] = toks
                step += 1
                if step == 1:
                    ckpt.save_snapshot(eng, snap,
                                       extra={"rid_map": rid_map,
                                              "resume_prefix": {}})
                    armed["live"] = True  # kill at the next lag window
        except SimKill:
            killed = True
        finally:
            undo()
        del eng, journal  # the "SIGKILL": no drain, no close, no sync
        _tear(jour)

        # recovery into a PIPELINED engine: the lag must survive its own
        # restart path, not just a synchronous fallback
        eng = build_engine(model, PIPE_ENGINE_SPEC)
        info = ckpt.recover_engine(eng, snap, jour)
        assert info.n_skipped == 1, info.n_skipped
        eng.journal = ckpt.rewrite_journal(eng, jour2, info.rid_map,
                                           info.resume_prefix)
        out = dict(delivered)
        out.update(ckpt.run_recovered(eng, info))
        exact = out == oracle
        verify_pool_integrity(eng)
        results[mode] = dict(exact=exact, killed=killed, leak_free=True,
                             launches=_since(before))
        status = "OK" if exact and killed else "FAIL"
        print(f"  pipeline seed={seed} {mode:>19}: {status} "
              f"killed={killed} exact={exact}", flush=True)
        if not exact:
            print(f"    oracle: {oracle}\n    got:    {out}")
    return results


def run_transport_seed(seed: int, n_messages: int = 24) -> dict:
    """One seeded fuzz round over the fleet frame transport: bit-flipped
    payloads (the CRC must reject every one), duplicated clean frames
    (Dedup drops the repeat), maybe a torn tail; then a clean resend of
    whatever went missing must leave exactly the original message set,
    byte-identical.  Raises AssertionError on any violation."""
    import numpy as np

    from burst_attn_tpu_torch.fleet import transport as tp

    rng = np.random.default_rng([0xF1EE7, int(seed)])
    originals = {}
    frames = []
    for seq in range(n_messages):
        rid = int(rng.integers(0, 4))
        arr = rng.integers(0, 256, size=int(rng.integers(1, 64)),
                           dtype=np.int64).astype(np.uint8)
        originals[(rid, seq)] = arr
        frames.append(tp.pack_frame(tp.encode_message(
            ("blob", rid, seq, arr),
            force_json=bool(rng.integers(0, 2)))))

    flipped = {i for i in range(n_messages) if rng.random() < 0.25}
    mutated = []
    flip_extents = []  # (start, end) of each flipped frame in the stream
    pos = 0
    n_dups = 0
    for i, fr in enumerate(frames):
        if i in flipped:
            fr = bytearray(fr)
            # strictly inside the payload: the frame parses, its CRC fails
            off = tp._HEADER.size + int(
                rng.integers(0, len(fr) - tp._HEADER.size))
            fr[off] ^= 1 << int(rng.integers(0, 8))
            fr = bytes(fr)
            flip_extents.append((pos, pos + len(fr)))
            mutated.append(fr)
            pos += len(fr)
        else:
            mutated.append(fr)
            pos += len(fr)
            if rng.random() < 0.25:
                mutated.append(fr)  # redelivery: Dedup's job
                pos += len(fr)
                n_dups += 1
    stream = b"".join(mutated)
    cut = None
    if rng.random() < 0.5:  # tear the tail mid-frame
        cut = int(rng.integers(max(1, len(stream) // 2), len(stream)))
        stream = stream[:cut]

    fb = tp.FrameBuffer()
    dd = tp.Dedup()
    accepted = {}
    dup_dropped = 0

    def drain():
        nonlocal dup_dropped
        while fb.frames:
            _, rid, seq, arr = tp.decode_message(fb.frames.popleft())
            if not dd.accept(rid, seq):
                dup_dropped += 1
                continue
            accepted[(rid, seq)] = np.asarray(arr)

    off = 0
    while off < len(stream):
        step = int(rng.integers(1, 1 << 12))
        fb.feed(stream[off:off + step])
        off += step
        drain()
    fb.eof()
    drain()

    for key, arr in accepted.items():  # NEVER accept corrupted bytes
        assert np.array_equal(arr, originals[key]), \
            f"seed={seed}: corrupted payload accepted for {key}"
    n_flips_fed = sum(end <= len(stream) for _, end in flip_extents)
    assert fb.crc_rejected == n_flips_fed, \
        (f"seed={seed}: {n_flips_fed} flipped frames fed but "
         f"{fb.crc_rejected} CRC-rejected")

    missing = sorted(set(originals) - set(accepted))
    for rid, seq in missing:
        fb.feed(tp.pack_frame(tp.encode_message(
            ("blob", rid, seq, originals[(rid, seq)]))))
    drain()
    assert set(accepted) == set(originals), \
        f"seed={seed}: retry left {set(originals) - set(accepted)} missing"
    for key, arr in accepted.items():
        assert np.array_equal(arr, originals[key]), \
            f"seed={seed}: post-retry payload mismatch for {key}"
    return dict(n_frames=n_messages, flipped=len(flipped), dups=n_dups,
                crc_rejected=fb.crc_rejected, torn=fb.torn,
                dup_dropped=dup_dropped, resent=len(missing),
                truncated_at=cut)


def mode_ok(r: dict) -> bool:
    """A mode's verdict: exact, killed and leak-free (a sync recovery
    path also re-decodes no more than the replay baseline)."""
    return (r["exact"] and r["killed"] and r.get("leak_free", True)
            and r.get("bounded", True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/fuzz_checkpoint.py")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default; raises without one)")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--engines", default="ragged",
                    help="comma list of the sync seeds' engines: ragged "
                         "(RaggedServeEngine), legacy (ServeEngine)")
    ap.add_argument("--cache-seeds", type=int, default=2,
                    help="prefix-cache kill-point seeds (mid-CoW-copy + "
                         "mid-shared-admission + mid-scale-scatter on an "
                         "fp8 pool, per seed); 0 disables")
    ap.add_argument("--transport-seeds", type=int, default=0,
                    help="also fuzz the fleet frame transport for N seeds "
                         "(truncate / bit-flip / duplicate mutations)")
    ap.add_argument("--pipeline-seeds", type=int, default=0,
                    help="pipelined-engine delivery-lag kill-point seeds "
                         "(mid-pipeline-flight + mid-multi-step-scan + "
                         "mid-readback on a pipeline=True multi_step=4 "
                         "engine, per seed); 0 disables")
    args = ap.parse_args(argv)

    engines = [e for e in args.engines.split(",") if e]
    model = None
    if args.seeds or args.cache_seeds or args.pipeline_seeds:
        model = load_model(args.device)
    failures = 0
    any_strict = args.seeds == 0  # strict-resume property needs ckpt seeds
    with tempfile.TemporaryDirectory(prefix="ckpt_fuzz_") as td:
        for kind in engines:
            for seed in range(args.seeds):
                r = run_seed(seed, args.requests, td, model, kind)
                for label in ("snapshot+journal", "journal-only"):
                    failures += not mode_ok(r[label])
                    any_strict = any_strict or r[label]["strict"]
        for seed in range(args.cache_seeds):
            for r in run_cache_seed(seed, args.requests, td,
                                    model).values():
                failures += not mode_ok(r)
        for seed in range(args.pipeline_seeds):
            for r in run_pipeline_seed(seed, args.requests, td,
                                       model).values():
                failures += not mode_ok(r)
    for seed in range(args.transport_seeds):
        try:
            st = run_transport_seed(seed)
        except AssertionError as e:
            print(f"  transport seed={seed}: FAIL {e}")
            failures += 1
            continue
        print(f"  transport seed={seed}: OK "
              f"flipped={st['flipped']} crc_rejected={st['crc_rejected']} "
              f"dups={st['dups']}/{st['dup_dropped']} torn={st['torn']} "
              f"resent={st['resent']}")
    if not any_strict:
        print("fuzz_checkpoint: FAIL — no seed demonstrated strict "
              "resume-not-replay (replayed < baseline)")
        failures += 1
    if failures:
        print(f"fuzz_checkpoint: {failures} FAILURES")
        return 1
    parts = []
    if args.seeds:
        parts.append(f"{args.seeds} seeds x 2 recovery paths token-exact, "
                     "recomputation bounded by journal lag")
    if args.cache_seeds:
        parts.append(f"{args.cache_seeds} cache seeds x 3 kill points "
                     "(mid-CoW, mid-admission, mid-scale-scatter) "
                     "token-exact, zero "
                     "leaked/double-freed pages")
    if args.pipeline_seeds:
        parts.append(f"{args.pipeline_seeds} pipeline seeds x 3 kill "
                     "points (mid-flight, mid-multi-step-scan, "
                     "mid-readback) token-exact vs sync oracle")
    if args.transport_seeds:
        parts.append(f"{args.transport_seeds} transport seeds clean "
                     "(CRC rejects, dedup holds, retry completes)")
    print("fuzz_checkpoint: " + "; ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
