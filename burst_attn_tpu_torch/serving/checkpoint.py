"""Crash-consistent serving (port of burst_attn_tpu/serving/checkpoint.py):
engine snapshots and the write-ahead token journal.

Recovery RESUMES instead of replaying, with two durability layers that
compose:

  SNAPSHOT  `save_snapshot(engine, path)` serializes the engine's whole
            serving state (every layer's page banks and scale banks, the
            page table and lengths, per-request metadata, the admission
            queue, the sampler's generator state, the pool's free list and
            refcounts, the prefix cache's index) into ONE atomic `.npz`
            (tmp file, fsync, rename: a crash mid-save leaves the previous
            snapshot intact).  `restore_into` writes it into a fresh
            engine of the same spec, IN PLACE: the page banks, scale
            banks, table and lengths are copied into the engine's own
            tensors and the snapshot's state is set on the engine's own
            generator, because a pipelined engine's CUDA graphs
            (serving/model.DecodeGraphs) are bound to those addresses.
            The ragged engine's host mirrors (`_lengths`, `_table`) are
            rebuilt from the same arrays.  The restored engine's run() is
            token-exact with the uninterrupted one: the same kernels run
            on the same bytes.  Works for `RaggedServeEngine` (synchronous
            or pipelined) and `ServeEngine`.

  JOURNAL   `TokenJournal` is a write-ahead fsynced JSONL of per-tick
            token records: the engines append and call `sync()` once per
            step(), before results leave it, then run the delivery
            barrier (`delivered`), so every token a caller has seen is on
            disk.  The reader is torn-tail tolerant: a kill mid-append
            tears at most the final line, which is skipped and counted;
            corruption anywhere else raises.

`recover_engine` composes them: restore the last snapshot if one exists,
then roll the journal forward.  Sequences in the snapshot re-decode only
the journal LAG (tokens journaled after the snapshot); sequences known
only to the journal resume by prompt-concat prefill (the journaled prefix
is teacher-forced as prompt, never re-decoded).  Journal-prefix resume
needs greedy decoding (temperature 0); snapshot restore restores the
generator, so sampled streams restore exactly.

File formats are the JAX package's.  A bare paged snapshot
(`save_paged_snapshot`) is one format for both packages: bf16 and fp8
banks, which have no numpy dtype, are saved as raw bytes (`np.void` of
the element size, as np.load hands the JAX package's ml_dtypes banks
back) with the element dtype recorded by its JAX name (`page_dtype`).  An
engine snapshot holds a torch.Generator state where the JAX package holds
a PRNG key, so neither package restores the other's engine snapshots:
`restore_into` refuses a JAX one with a ValueError before it changes
anything.

Unsupported for snapshot, as in the JAX package: engines with a draft
model attached (`save_snapshot` raises rather than dropping the draft's
state; such engines still journal).

Counters: the JAX package's obs instruments, under their names:
`serve.recovered_tokens_replayed` (tokens a recovery must re-decode),
`serve.recovered_tokens_resumed` (tokens recovered without re-decoding),
`serve.journal_records`, `serve.checkpoint_saves`,
`serve.journal_reopen_corrupt`; warnings go through the obs logger.
"""

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..protocols import journal as _jp

M_RECOVERED_REPLAYED = obs.counter(
    "serve.recovered_tokens_replayed",
    "previously generated tokens a recovery had to re-decode "
    "(journal lag past the last snapshot)")
M_RECOVERED_RESUMED = obs.counter(
    "serve.recovered_tokens_resumed",
    "previously generated tokens recovered without re-decoding "
    "(snapshot state + journaled prefixes)")
M_JOURNAL_RECORDS = obs.counter(
    "serve.journal_records", "write-ahead token journal records appended")
M_SNAPSHOT_SAVES = obs.counter(
    "serve.checkpoint_saves", "atomic engine snapshots written")
M_JOURNAL_REOPEN_CORRUPT = obs.counter(
    "serve.journal_reopen_corrupt",
    "append-mode journal reopens that found an unreadable file")


def _log():
    return obs.get_logger("burst_attn_tpu_torch.serving.checkpoint")

SNAPSHOT_VERSION = 1

# page-bank element dtypes by the JAX package's names (str of a jnp dtype)
PAGE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}
_DTYPE_NAMES = {v: k for k, v in PAGE_DTYPES.items()}
# the dtypes numpy has no type for: saved as raw bytes, viewed through the
# integer type of their width on the way back
_RAW = {torch.bfloat16: (torch.int16, np.int16),
        torch.float8_e4m3fn: (torch.uint8, np.uint8)}


# -- write-ahead token journal ---------------------------------------------


class TokenJournal:
    """Append-only fsynced JSONL keyed by ENGINE rid.  Records:

      {"record": "submit", "rid": R, "ext": E, "prompt": [...],
       "max_new": M}                     ownership: engine rid R serves
                                         external (router) rid E
      {"record": "tokens", "rid": R, "toks": [...]}   tokens appended
      {"record": "done",   "rid": R}     request finished (journaled
                                         before the result is reported)
      {"record": "reset",  "rid": R}     drain() requeued the request:
                                         its token prefix is void

    The engines write tokens / done / reset; the CALLER writes the submit
    record.  Appends buffer in the file object; `sync()` (flush + fsync)
    is the durability barrier, called by the engines once per step(),
    after the tick's appends and before its results are returned.

    Every append / sync / deliver runs the pure machine
    `protocols.journal.step` in lockstep with the file: `delivered(rid,
    n)` is the engines' delivery barrier and raises DurabilityViolation
    if a caller is about to see tokens no fsync has covered."""

    def __init__(self, path: str, *, truncate: bool = False):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._proto = _jp.init()
        if not truncate and os.path.exists(path) and os.path.getsize(path):
            # append-mode reopen: seed the machine's durable view with the
            # existing file's fold so delivery checks stay exact
            try:
                view = journal_view(path)
                self._proto = self._proto._replace(
                    durable=tuple(sorted((r, len(t))
                                         for r, t in view.tokens.items())),
                    durable_done=tuple(sorted(view.done)))
            except ValueError as e:
                M_JOURNAL_REOPEN_CORRUPT.inc()
                _log().warning(
                    "journal %s unreadable on append-mode reopen (%s); "
                    "delivery tracking restarts empty", path, e)
        self._f = open(path, "w" if truncate else "a", encoding="utf-8")
        self._dirty = False

    def _proto_step(self, event) -> None:
        self._proto, _ = _jp.step(self._proto, event)

    def _append(self, rec: dict) -> None:
        self._proto_step(("append", rec["record"], rec["rid"],
                          len(rec.get("toks", ()))))
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._dirty = True
        M_JOURNAL_RECORDS.inc()

    def submit(self, rid: int, ext: int, prompt, max_new: int) -> None:
        self._append({"record": "submit", "rid": int(rid), "ext": int(ext),
                      "prompt": [int(x) for x in prompt],
                      "max_new": int(max_new)})

    def tokens(self, rid: int, toks) -> None:
        toks = [int(t) for t in toks]
        if toks:
            self._append({"record": "tokens", "rid": int(rid), "toks": toks})

    def done(self, rid: int) -> None:
        self._append({"record": "done", "rid": int(rid)})

    def reset(self, rid: int) -> None:
        self._append({"record": "reset", "rid": int(rid)})

    def sync(self) -> None:
        if self._dirty and not self._f.closed:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._dirty = False
            self._proto_step(("sync",))

    def delivered(self, rid: int, n_total: int) -> None:
        """The delivery barrier: a caller is observing `rid` at `n_total`
        total journaled tokens.  Raises DurabilityViolation
        (protocols.journal) when those tokens are not durable yet, i.e.
        results were returned before sync()."""
        self._proto_step(("deliver", int(rid), int(n_total)))

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()


def read_journal(path: str) -> Tuple[List[dict], int]:
    """(records, n_skipped), torn-tail tolerant: a kill lands mid-append
    at most once, at the END of the file, so a bad FINAL line (with valid
    records before it) is skipped and counted; a bad line anywhere else
    is corruption and raises ValueError."""
    records: List[dict] = []
    n_skipped = 0
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    last = len(lines) - 1
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict) or "record" not in rec:
                raise ValueError("not a journal record")
        except ValueError:
            if i == last and records:
                n_skipped += 1
                continue
            raise ValueError(
                f"corrupt journal line {i + 1} in {path!r}: {line[:120]!r}")
        records.append(rec)
    return records, n_skipped


@dataclass
class JournalView:
    """The journal folded into per-request state (resets applied)."""

    submits: Dict[int, dict] = field(default_factory=dict)   # rid -> record
    tokens: Dict[int, List[int]] = field(default_factory=dict)
    done: set = field(default_factory=set)
    n_skipped: int = 0


def journal_view(path: Optional[str]) -> JournalView:
    """Fold a journal file; a missing path is an empty view (a worker
    killed before its first sync left nothing: recovery starts from the
    prompt)."""
    view = JournalView()
    if not path or not os.path.exists(path):
        return view
    records, view.n_skipped = read_journal(path)
    for rec in records:
        rid = int(rec["rid"])
        kind = rec["record"]
        if kind == "submit":
            view.submits[rid] = rec
            view.tokens.setdefault(rid, [])
        elif kind == "tokens":
            view.tokens.setdefault(rid, []).extend(
                int(t) for t in rec["toks"])
        elif kind == "done":
            view.done.add(rid)
        elif kind == "reset":
            view.tokens[rid] = []
    return view


def journal_tokens_by_ext(path: Optional[str]) -> Dict[int, List[int]]:
    """external rid -> journaled tokens, for every request the journal
    knows (how far each sequence of a dead worker already got)."""
    view = journal_view(path)
    return {int(sub["ext"]): list(view.tokens.get(rid, []))
            for rid, sub in view.submits.items()}


def trim_complete(toks: List[int], max_new: int,
                  eos_id: Optional[int]) -> Optional[List[int]]:
    """If a journaled prefix already satisfies the request (budget hit or
    EOS emitted), the trimmed final stream; else None.  The engines'
    retirement rule: the first EOS wins, then the budget."""
    toks = [int(t) for t in toks]
    if eos_id is not None and eos_id in toks:
        return toks[: toks.index(eos_id) + 1]
    if len(toks) >= max_new:
        return toks[:max_new]
    return None


# -- atomic npz snapshot ----------------------------------------------------


def _atomic_savez(path: str, meta: dict,
                  arrays: Dict[str, np.ndarray]) -> None:
    """Write meta (JSON, as a uint8 entry) + arrays as ONE npz, atomically:
    tmp file, fsync, rename, so a crash mid-save never clobbers the
    previous snapshot."""
    payload = dict(arrays)
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str) -> dict:
    """{"meta": dict, "arrays": {name: np.ndarray}} from one snapshot."""
    with np.load(path) as z:
        arrays = {k: np.asarray(z[k]) for k in z.files if k != "__meta__"}
        meta = json.loads(z["__meta__"].tobytes().decode("utf-8"))
    if meta.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot {path!r} has version "
                         f"{meta.get('version')!r}, this build reads "
                         f"{SNAPSHOT_VERSION}")
    return {"meta": meta, "arrays": arrays}


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A device tensor as the numpy array the snapshot holds: bf16 and
    fp8 as raw bytes (np.void of the element size)."""
    t = t.detach().cpu()
    if t.dtype in _RAW:
        return t.view(_RAW[t.dtype][0]).numpy().view(
            f"V{t.element_size()}")
    return t.numpy()


def _paged_arrays(state) -> Dict[str, np.ndarray]:
    """PagedState -> host arrays."""
    arrays: Dict[str, np.ndarray] = {
        "page_table": _host_array(state.page_table),
        "lengths": _host_array(state.lengths),
    }
    quant = state.k_scales is not None
    for li in range(len(state.k_pages)):
        arrays[f"k_pages_{li}"] = _host_array(state.k_pages[li])
        arrays[f"v_pages_{li}"] = _host_array(state.v_pages[li])
        if quant:
            arrays[f"k_scales_{li}"] = _host_array(state.k_scales[li])
            arrays[f"v_scales_{li}"] = _host_array(state.v_scales[li])
    return arrays


def _page_dtype(meta: dict) -> torch.dtype:
    name = meta.get("page_dtype")
    if name not in PAGE_DTYPES:
        raise ValueError(f"snapshot page dtype {name!r} is not one of "
                         f"{sorted(PAGE_DTYPES)}")
    return PAGE_DTYPES[name]


def _pool_tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """One saved page bank as a host tensor of `dtype`: a raw-byte bank
    (bf16, fp8) is re-viewed through the recorded page dtype; any other
    must already hold it."""
    if a.dtype.kind == "V":
        if dtype not in _RAW or a.dtype.itemsize != dtype.itemsize:
            raise ValueError(f"snapshot page bank of opaque dtype "
                             f"{a.dtype.str} does not hold {dtype}")
        return torch.from_numpy(a.view(_RAW[dtype][1])).view(dtype)
    t = torch.from_numpy(a)
    if t.dtype != dtype:
        raise ValueError(f"snapshot page bank holds {t.dtype}, its pool "
                         f"meta says {dtype}")
    return t


def _banks(arrays: Dict[str, np.ndarray], n_layers: int,
           pool_meta: dict) -> Dict[str, List[torch.Tensor]]:
    """The snapshot's banks as host tensors, by PagedState field."""
    dt = _page_dtype(pool_meta)
    out = {f: [_pool_tensor(arrays[f"{f}_{li}"], dt)
               for li in range(n_layers)] for f in ("k_pages", "v_pages")}
    if "k_scales_0" in arrays:
        out.update({f: [torch.from_numpy(arrays[f"{f}_{li}"])
                        for li in range(n_layers)]
                    for f in ("k_scales", "v_scales")})
    return out


def _paged_from_arrays(arrays: Dict[str, np.ndarray], n_layers: int,
                       pool_meta: dict, device):
    from ..models.paged_decode import PagedState

    banks = _banks(arrays, n_layers, pool_meta)

    def dev(ts):
        return [t.to(device) for t in ts] if ts is not None else None

    return PagedState(
        dev(banks["k_pages"]), dev(banks["v_pages"]),
        torch.from_numpy(arrays["page_table"]).to(device),
        torch.from_numpy(arrays["lengths"]).to(device),
        dev(banks.get("k_scales")), dev(banks.get("v_scales")))


def _pool_meta(pool, state=None) -> dict:
    meta = {"n_pages": int(pool.n_pages),
            "dtype": pool.dtype,
            "free": [int(p) for p in pool._free],
            "refs": [int(r) for r in pool._refs]}
    if state is not None:
        # the page banks' element dtype by its JAX name: bf16 and fp8
        # banks are raw bytes in the file, viewed back through this
        meta["page_dtype"] = _DTYPE_NAMES[state.k_pages[0].dtype]
    return meta


def _check_pool(pool, meta: dict) -> None:
    if int(meta["n_pages"]) != int(pool.n_pages):
        raise ValueError(f"snapshot pool has {meta['n_pages']} pages, "
                         f"engine pool has {pool.n_pages}")
    # restoring a quantized snapshot into a pool of another storage dtype
    # would reinterpret page bytes
    if meta.get("dtype") != pool.dtype:
        raise ValueError(f"snapshot pool dtype {meta.get('dtype')!r} != "
                         f"engine pool dtype {pool.dtype!r}")


def _pool_restore(pool, meta: dict) -> None:
    _check_pool(pool, meta)
    pool._free = [int(p) for p in meta["free"]]
    pool._refs = [int(r) for r in meta["refs"]]


def _new_pool(meta: dict):
    from ..models.paged_decode import PagePool

    pool = PagePool(int(meta["n_pages"]), dtype=meta.get("dtype"))
    _pool_restore(pool, meta)
    return pool


# -- engine snapshot --------------------------------------------------------


def _engine_kind(engine) -> str:
    from ..models.serve import ServeEngine
    from .engine import RaggedServeEngine

    if isinstance(engine, RaggedServeEngine):
        return "ragged"
    if isinstance(engine, ServeEngine):
        return "legacy"
    raise TypeError(f"cannot snapshot a {type(engine).__name__}")


def _check_snapshotable(engine) -> None:
    if engine.draft is not None:
        raise ValueError("snapshot does not support engines with a draft "
                         "model attached (speculative mirror state)")


def _req_to_dict(req, kind: str) -> dict:
    d = {"rid": int(req.rid), "prompt": [int(x) for x in req.prompt],
         "max_new": int(req.max_new_tokens),
         "tokens": [int(t) for t in req.tokens]}
    if kind == "ragged":
        d["n_prefilled"] = int(req.n_prefilled)
    return d


def _req_from_dict(d: dict, kind: str):
    if kind == "ragged":
        from .engine import _Request

        return _Request(int(d["rid"]), np.asarray(d["prompt"], np.int32),
                        int(d["max_new"]),
                        tokens=[int(t) for t in d["tokens"]],
                        t_submit=time.perf_counter(),
                        n_prefilled=int(d.get("n_prefilled", 0)))
    from ..models.serve import _Request

    return _Request(int(d["rid"]), np.asarray(d["prompt"], np.int32),
                    int(d["max_new"]), tokens=[int(t) for t in d["tokens"]],
                    t_submit=time.perf_counter())


def _rng_meta(gen: torch.Generator) -> dict:
    return {"device": gen.device.type,
            "state": gen.get_state().tolist()}


def _check_rng(gen: torch.Generator, meta: dict) -> None:
    if "state" not in meta:
        raise ValueError(
            "snapshot's sampler RNG is a JAX PRNG key (typed/data), not a "
            "torch.Generator state: a JAX engine snapshot does not restore "
            "into this package's engines")
    if meta.get("device") != gen.device.type:
        raise ValueError(f"snapshot's sampler RNG is a {meta.get('device')} "
                         f"generator's state; the engine's generator is on "
                         f"{gen.device.type}")


def snapshot(engine, extra: Optional[dict] = None) -> Tuple[dict, dict]:
    """(meta, arrays) for one engine: everything restore_into needs.
    `extra` is caller payload carried verbatim (a router's engine-rid ->
    external-rid map and resume prefixes, under "rid_map" and
    "resume_prefix", are what recover_engine reads back)."""
    kind = _engine_kind(engine)
    _check_snapshotable(engine)
    # a pipelined engine quiesces first: an in-flight launch holds sampled
    # but unaccounted tokens on the device that no field can represent
    flush = getattr(engine, "flush_pipeline", None)
    if flush is not None:
        flush()
    meta = {
        "version": SNAPSHOT_VERSION,
        "kind": kind,
        "n_layers": len(engine.state.k_pages),
        "slots_n": len(engine.slots),
        "page": int(engine.page),
        "pool": _pool_meta(engine.pool, engine.state),
        "slots": [None if r is None else _req_to_dict(r, kind)
                  for r in engine.slots],
        "queue": [_req_to_dict(r, kind) for r in engine._queue],
        "next_tok": [int(t) for t in engine._next_tok],
        "next_id": int(engine._next_id),
        "finished": [[int(rid), [int(t) for t in toks]]
                     for rid, toks in sorted(engine._finished.items())],
        "rng": _rng_meta(engine._rng),
        "extra": extra or {},
    }
    if engine.cache is not None:
        # pool refcounts (the cache's own references included) ride in
        # meta["pool"]; this is the index itself, LRU-ordered
        meta["prefix_cache"] = engine.cache.to_meta()
        if kind == "ragged":
            meta["shared"] = [[int(s), [int(p) for p in pages]]
                              for s, pages in sorted(engine._shared.items())]
    return meta, _paged_arrays(engine.state)


def save_snapshot(engine, path: str, extra: Optional[dict] = None) -> None:
    """Serialize `engine` to `path` atomically (see the module
    docstring)."""
    meta, arrays = snapshot(engine, extra)
    _atomic_savez(path, meta, arrays)
    M_SNAPSHOT_SAVES.inc()


def restore_into(engine, snap: dict) -> dict:
    """Apply a loaded snapshot to an idle engine built with the same spec
    (same params, slots, pool size and dtype, page size, prefix cache
    on or off).  Returns the snapshot's `extra` payload.  Every check runs
    before anything changes, so a refused snapshot leaves the engine as it
    was.  The state is written IN PLACE: banks, table and lengths are
    copied into the engine's tensors and the generator's state is set on
    the engine's generator, which keep their addresses (CUDA graphs of a
    pipelined engine stay valid); the ragged engine's host mirrors follow
    the restored arrays."""
    meta, arrays = snap["meta"], snap["arrays"]
    kind = _engine_kind(engine)
    _check_snapshotable(engine)
    if meta["kind"] != kind:
        raise ValueError(f"snapshot is for a {meta['kind']!r} engine, "
                         f"restore target is {kind!r}")
    if meta["slots_n"] != len(engine.slots):
        raise ValueError(f"snapshot has {meta['slots_n']} slots, engine "
                         f"has {len(engine.slots)}")
    if meta["page"] != int(engine.page):
        raise ValueError(f"snapshot page size {meta['page']} != engine "
                         f"page size {engine.page}")
    state = engine.state
    n_layers = len(state.k_pages)
    if meta["n_layers"] != n_layers:
        raise ValueError(f"snapshot has {meta['n_layers']} layers, engine "
                         f"model has {n_layers}")
    want = tuple(arrays["k_pages_0"].shape)
    have = tuple(state.k_pages[0].shape)
    if want != have:
        raise ValueError(f"snapshot pool geometry {want} != engine pool "
                         f"geometry {have}")
    if tuple(arrays["page_table"].shape) != tuple(state.page_table.shape):
        raise ValueError(f"snapshot page table "
                         f"{tuple(arrays['page_table'].shape)} != engine "
                         f"page table {tuple(state.page_table.shape)}")
    _check_pool(engine.pool, meta["pool"])
    _check_rng(engine._rng, meta["rng"])
    cache_meta = meta.get("prefix_cache")
    if cache_meta is not None and engine.cache is None:
        raise ValueError("snapshot carries a prefix cache; build the "
                         "restore target with prefix_cache=True")
    if getattr(engine, "_pending", None) is not None:
        raise ValueError("restore target has a launch in flight; restore "
                         "into an idle engine")
    banks = _banks(arrays, n_layers, meta["pool"])
    for name, src in banks.items():
        for dst, s in zip(getattr(state, name), src):
            if dst.dtype != s.dtype:
                raise ValueError(f"snapshot {name} hold {s.dtype}, the "
                                 f"engine's hold {dst.dtype}")

    # -- every check passed: write in place --------------------------------
    from ..ops.paged_attention import pool_bytes
    from ..models.paged_decode import PrefixCache

    for name, src in banks.items():
        for dst, s in zip(getattr(state, name), src):
            pool_bytes(dst).copy_(pool_bytes(s))
    state.page_table.copy_(torch.from_numpy(arrays["page_table"]))
    state.lengths.copy_(torch.from_numpy(arrays["lengths"]))
    _pool_restore(engine.pool, meta["pool"])
    engine.slots = [None if d is None else _req_from_dict(d, kind)
                    for d in meta["slots"]]
    engine._queue = [_req_from_dict(d, kind) for d in meta["queue"]]
    engine._next_tok[:] = meta["next_tok"]
    engine._next_id = int(meta["next_id"])
    engine._finished = {int(rid): [int(t) for t in toks]
                        for rid, toks in meta["finished"]}
    engine._rng.set_state(torch.tensor(meta["rng"]["state"],
                                       dtype=torch.uint8))
    if cache_meta is not None:
        # from_meta does NOT re-bump refcounts: _pool_restore installed
        # the totals that include the cache's references
        engine.cache = PrefixCache.from_meta(engine.pool, cache_meta)
    elif engine.cache is not None:
        # a cache-less snapshot into a cache-enabled engine: start empty
        engine.cache = PrefixCache(engine.pool)
    if kind == "ragged":
        engine._shared = {int(s): tuple(int(p) for p in pages)
                          for s, pages in meta.get("shared", [])}
        engine._lengths[:] = arrays["lengths"]
        engine._table[:] = arrays["page_table"]
        engine._flushed_done = []
    return meta.get("extra", {})


# -- paged-state-level snapshot (the handoff path has no engine) ------------


def save_paged_snapshot(path: str, state, pool,
                        extra: Optional[dict] = None) -> None:
    """Snapshot a bare PagedState + PagePool (the handoff decode loop runs
    without an engine).  Same atomic format; the JAX package's
    load_paged_snapshot reads it, and load_paged_snapshot reads the JAX
    package's."""
    meta = {"version": SNAPSHOT_VERSION, "kind": "paged",
            "n_layers": len(state.k_pages),
            "pool": _pool_meta(pool, state),
            "extra": extra or {}}
    _atomic_savez(path, meta, _paged_arrays(state))
    M_SNAPSHOT_SAVES.inc()


def load_paged_snapshot(path: str, device=None):
    """(PagedState, PagePool, extra) from a save_paged_snapshot file: fresh
    tensors on `device` (default: the card) and a fresh pool, nothing
    shared with the writer (a replacement process rebuilds the whole
    serving state from disk)."""
    snap = load_snapshot(path)
    meta = snap["meta"]
    if meta["kind"] != "paged":
        raise ValueError(f"{path!r} is a {meta['kind']!r} snapshot, not a "
                         "bare paged snapshot")
    state = _paged_from_arrays(snap["arrays"], meta["n_layers"],
                               meta["pool"], resolve_device(device))
    return state, _new_pool(meta["pool"]), meta.get("extra", {})


# -- recovery ---------------------------------------------------------------


@dataclass
class RecoveryInfo:
    """What recover_engine did, per EXTERNAL rid.  `replayed` tokens will
    be re-decoded by the engine (journal lag past the snapshot); `resumed`
    tokens were recovered without re-decoding; `done` requests were
    already complete per the journal and need no engine time.
    `baseline_replay` is what a replay-from-scratch recovery would
    re-decode (every journaled token of every unfinished request): the
    strict upper bound `total_replayed` is held against."""

    rid_map: Dict[int, int] = field(default_factory=dict)   # erid -> ext
    resume_prefix: Dict[int, List[int]] = field(default_factory=dict)
    replayed: Dict[int, int] = field(default_factory=dict)  # ext -> count
    resumed: Dict[int, int] = field(default_factory=dict)   # ext -> count
    done: Dict[int, List[int]] = field(default_factory=dict)
    baseline_replay: int = 0
    from_snapshot: bool = False
    n_skipped: int = 0

    @property
    def total_replayed(self) -> int:
        return sum(self.replayed.values())

    @property
    def total_resumed(self) -> int:
        return sum(self.resumed.values())


def _enqueue_raw(engine, prompt, max_new: int) -> int:
    """Queue a recovered request BYPASSING admission shedding: work that
    was admitted before the crash must not be shed by its own recovery."""
    kind = _engine_kind(engine)
    rid = engine._next_id
    engine._next_id += 1
    engine._queue.append(_req_from_dict(
        {"rid": rid, "prompt": [int(x) for x in prompt],
         "max_new": int(max_new), "tokens": []}, kind))
    return rid


def recover_engine(engine, snapshot_path: Optional[str],
                   journal_path: Optional[str]) -> RecoveryInfo:
    """Restore a freshly built engine from the last snapshot (if any) and
    roll the journal forward (see the module docstring).  The engine is
    left ready to step(); attach a fresh journal with `rewrite_journal`
    first if it should journal.  Journal-prefix resume teacher-forces via
    prompt concat, which needs greedy decoding: raises ValueError for a
    sampled engine when the journal holds sequences the snapshot lacks."""
    info = RecoveryInfo()
    if snapshot_path and os.path.exists(snapshot_path):
        extra = restore_into(engine, load_snapshot(snapshot_path))
        info.from_snapshot = True
        info.rid_map = {int(k): int(v)
                        for k, v in (extra.get("rid_map") or {}).items()}
        info.resume_prefix = {
            int(k): [int(t) for t in v]
            for k, v in (extra.get("resume_prefix") or {}).items()}
    view = journal_view(journal_path)
    info.n_skipped = view.n_skipped

    def journal_finished(rid, jt):
        """The full journaled stream iff the journal proves `rid` done (a
        done record, or complete by EOS / budget against the ORIGINAL
        submit's budget)."""
        if rid in view.done:
            return jt
        sub = view.submits.get(rid)
        if sub is not None and jt:
            return trim_complete(jt, int(sub["max_new"]), engine.eos_id)
        return None

    def account(req, ext, pre, jt):
        have = len(pre) + len(req.tokens)
        lag = max(0, len(jt) - have)
        info.replayed[ext] = lag
        info.resumed[ext] = have
        if lag:
            M_RECOVERED_REPLAYED.inc(lag)
        if have:
            M_RECOVERED_RESUMED.inc(have)

    owned = set()
    # slot residents: a journal-complete request takes its journaled
    # stream and retires on the first step (no decode: _retire_finished
    # runs before any launch); the rest re-decode only the journal lag
    for req in [r for r in engine.slots if r is not None]:
        owned.add(req.rid)
        ext = info.rid_map.get(req.rid, req.rid)
        pre = info.resume_prefix.get(req.rid, [])
        jt = list(view.tokens.get(req.rid, []))
        fin = journal_finished(req.rid, jt)
        if fin is not None:
            req.tokens = [int(t) for t in fin[len(pre):]]
            info.replayed[ext] = 0
            info.resumed[ext] = len(fin)
            M_RECOVERED_RESUMED.inc(len(fin))
            continue
        account(req, ext, pre, jt)
    # queued residents: journal-complete ones LEAVE the queue (admission
    # would prefill and append one token past the finished stream) and
    # surface through info.done
    for req in list(engine._queue):
        owned.add(req.rid)
        ext = info.rid_map.get(req.rid, req.rid)
        pre = info.resume_prefix.get(req.rid, [])
        jt = list(view.tokens.get(req.rid, []))
        fin = journal_finished(req.rid, jt)
        if fin is not None:
            engine._queue.remove(req)
            info.done[ext] = [int(t) for t in fin]
            info.replayed[ext] = 0
            info.resumed[ext] = len(fin)
            M_RECOVERED_RESUMED.inc(len(fin))
            continue
        account(req, ext, pre, jt)

    for rid, sub in sorted(view.submits.items()):
        if rid in owned:
            continue
        ext = int(sub["ext"])
        toks = list(view.tokens.get(rid, []))
        if rid in view.done:
            info.done[ext] = toks
            continue
        complete = trim_complete(toks, int(sub["max_new"]), engine.eos_id)
        if complete is not None:
            # journaled past the finish line but never marked done (the
            # kill landed between the append and the done record)
            info.done[ext] = complete
            info.resumed[ext] = len(complete)
            M_RECOVERED_RESUMED.inc(len(complete))
            continue
        if toks and engine.temperature != 0.0:
            raise ValueError(
                "journal-prefix resume requires greedy decoding "
                "(temperature 0); snapshot-only recovery supports "
                "sampled engines")
        new_rid = _enqueue_raw(engine, list(sub["prompt"]) + toks,
                               int(sub["max_new"]) - len(toks))
        info.rid_map[new_rid] = ext
        if toks:
            info.resume_prefix[new_rid] = toks
            M_RECOVERED_RESUMED.inc(len(toks))
        info.resumed[ext] = len(toks)
        info.replayed[ext] = 0

    info.baseline_replay = sum(
        len(view.tokens.get(rid, []))
        for rid in view.submits if rid not in view.done)
    return info


def rewrite_journal(engine, path: str, rid_map: Dict[int, int],
                    resume_prefix: Dict[int, List[int]]) -> TokenJournal:
    """Start a FRESH journal consistent with a just-recovered engine: one
    submit + one tokens record per in-flight or queued request, so a
    second failure recovers from this journal alone."""
    journal = TokenJournal(path, truncate=True)
    reqs = [r for r in engine.slots if r is not None] + list(engine._queue)
    for req in sorted(reqs, key=lambda r: r.rid):
        pre = resume_prefix.get(req.rid, [])
        # the engine-side prompt of a resumed request is orig_prompt +
        # prefix; the journal records the ORIGINAL request shape
        prompt = [int(x) for x in req.prompt]
        if pre:
            prompt = prompt[:len(prompt) - len(pre)]
        journal.submit(req.rid, rid_map.get(req.rid, req.rid), prompt,
                       req.max_new_tokens + len(pre))
        journal.tokens(req.rid, list(pre) + [int(t) for t in req.tokens])
    journal.sync()
    return journal


def run_recovered(engine, info: RecoveryInfo,
                  max_steps: int = 100_000) -> Dict[int, List[int]]:
    """Drive a recovered engine to completion and return the EXTERNAL
    view: ext rid -> full token stream (journal-resumed prefixes
    prepended, journal-complete requests included without engine time)."""
    out = dict(info.done)
    for erid, toks in engine.run(max_steps).items():
        ext = info.rid_map.get(erid, erid)
        out[ext] = info.resume_prefix.get(erid, []) + [int(t) for t in toks]
    return out
