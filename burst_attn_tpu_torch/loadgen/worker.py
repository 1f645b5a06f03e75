"""Serve worker process for the loadgen cluster (port of
burst_attn_tpu/loadgen/worker.py).

Each worker is an isolated OS process (multiprocessing `spawn` context:
a clean interpreter, its own CUDA context, its own obs registry) running
one serve engine and a small message loop.  The engine runs on the card
unless the model spec asks for the CPU (`"device": "cpu"`, as the tests
do): `device.resolve_device` picks the device in the child, pins TF32
off there (spawned children inherit no `torch.backends` flags), and a
child that finds no card raises, which the loop reports as an "error"
frame: a worker never carries on on the CPU by itself.  Messages travel
as CRC-framed transport frames (fleet/transport.py, QueueTransport over
the spawn queues — the same protocol the socket fleet speaks):

  router -> worker   ("submit", rrid, prompt list, max_new[, resume_toks])
                     ("fault", fault_kind, arg)   hog|unhog|stall|hang|raise
                     ("ping", seq)                heartbeat probe
                     ("stop",)                    finish backlog, export, exit
  worker -> router   ("ready", wid, pid, boot)     boot: seconds a phase
                     ("restored", wid, info)      checkpoint recovery summary
                     ("accepted", wid, rrid)
                     ("rejected", wid, rrid, reason, retryable, message)
                     ("done", wid, rrid, tokens)
                     ("pong", wid, seq)
                     ("stopped", wid, info)       kernel launches, pool
                     ("error", wid, message)      engine loop blew up

The "error" path is ordered for shutdown races: the worker exports its
obs snapshot FIRST (never a torn registry export), then sends the error
frame, then flushes the transport so the frame survives the process
dying immediately after — a worker erroring DURING stop still reports,
and the router's stop() collects it instead of dropping it.

Request ids on the wire are the ROUTER's (trace rids): the worker maps
its engine's local rids back before reporting, so the router never sees
worker-local numbering.

Crash consistency (`ckpt_spec`, serving/checkpoint.py): when enabled the
engine runs with a write-ahead TokenJournal (every generated token is
fsynced before its done record can leave the process) and the worker
snapshots the whole engine every `every` completions.  Three recovery
flows ride on that state:

  * reroute resume — a submit carrying `resume_toks` (the dead worker's
    journaled prefix for that rid) is admitted as prompt+prefix with the
    budget reduced; the prefix is prepended before reporting done, so
    the router sees the original request shape.  Requires greedy decode
    (the prefix must be the continuation the engine would have emitted).
  * restart restore — a replacement worker (`ckpt_spec["restore"]`)
    rebuilds its predecessor's engine from snapshot + journal
    (`recover_engine`), reports what it claimed via "restored", emits
    journal-complete requests as immediate dones, and rewrites a fresh
    journal so a SECOND failure recovers from this life alone.
  * accounting — `serve.recovered_tokens_resumed` counts tokens
    recovered without re-decoding, `serve.recovered_tokens_replayed`
    counts re-decoded ones (resume disabled, or journal lag).

Obs discipline: the engine's serve.* instruments land in this process's
registry; the loop exports a full fsynced snapshot to the worker's JSONL
(tagged `process_index=wid`) every `export_every` completions and again
at clean shutdown.  Each export first brings the counters
`kernel.launches{kernel=...}` up to the kernel wrappers' own launch
counters (which count only launches on the card), so every export is a
consistent snapshot of the engine's work and the kernels it launched.  A SIGKILLed worker therefore leaves its last
snapshot on disk — possibly with one torn final line, which is exactly
the case `obs.aggregate.load_records_tolerant` absorbs.

Fault injection runs INSIDE the worker because that is where the faults
live in production: "hog" grabs pages straight from the engine's pool
(forced pool exhaustion — admission and shed paths see real scarcity),
"unhog" releases them, "stall" freezes the engine loop (delayed retire /
GC pause stand-in) without touching the queue, "hang" wedges the WHOLE
loop — no stepping, no queue drain, no pong — which only the router's
heartbeat detector can distinguish from slow progress.  Worker kill is
not a message — the router SIGKILLs the process, the point being that no
cooperation is required.
"""

import os
import time

DTYPES = ("float32", "bfloat16")  # a model spec's "dtype" values


def kernel_launches() -> dict:
    """This process's launches of the kernels a worker runs, by the
    smoke's kernel names: the wrappers' own counters (bumped only at a
    launch on the card)."""
    from ..ops import flash, fused_ring, paged_attention, ragged_paged

    return {"flash_fwd": flash.flash_fwd.launches,
            "paged_decode": paged_attention.paged_decode_attention.launches,
            "ragged_paged": ragged_paged.ragged_paged_attention.launches,
            "fused_ring_fwd": fused_ring.fused_ring_fwd.launches}


def publish_kernel_launches() -> dict:
    """Bring the obs counters `kernel.launches{kernel=...}` up to the
    wrappers' counts (called before every export); returns the counts."""
    from .. import obs

    counts = kernel_launches()
    c = obs.counter("kernel.launches",
                    "attention kernel launches on the card, by kernel")
    for name, n in counts.items():
        delta = n - int(c.get(kernel=name))
        if delta > 0:
            c.inc(delta, kernel=name)
    return counts


def save_weights(params, path: str) -> str:
    """Write a parameter dictionary for `model_from_spec`'s "weights" key
    (torch.save of host copies): the processes of a cluster then load the
    weights instead of each drawing them again."""
    import torch

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [host(v) for v in x]
        return x.detach().to("cpu")

    tmp = path + ".tmp"
    torch.save(host(params), tmp)
    os.replace(tmp, path)
    return path


def model_from_spec(model_spec: dict):
    """(params, cfg, device) from a plain-dict model spec, re-derived
    from the spec's seed in whatever process calls it (the numpy init of
    `init_params`: every process draws the same weights).  Spec keys
    beyond ModelConfig's: "seed" (0), "dtype" ("float32" default, or
    "bfloat16"), "device" (None = the card; "cpu" only when asked) and
    "weights" (a `save_weights` file of this model's parameters, loaded in
    place of the init: the matrices cast to the dtype, the norms kept
    fp32, as `init_params` makes them).  The device resolves FIRST, so a
    child pins TF32 off before any weight exists, and a child without a
    card raises here."""
    import torch

    from ..device import resolve_device
    from ..models.transformer import ModelConfig, init_params

    ms = dict(model_spec)
    seed = ms.pop("seed", 0)
    dev = resolve_device(ms.pop("device", None))
    dtype = ms.pop("dtype", "float32")
    weights = ms.pop("weights", None)
    if dtype not in DTYPES:
        raise ValueError(f"model spec dtype must be one of {DTYPES}, "
                         f"got {dtype!r}")
    cfg = ModelConfig(remat=False, dtype=getattr(torch, dtype),
                      batch_axis=None, head_axis=None, **ms)
    if weights is None:
        return init_params(cfg, seed, device=dev), cfg, dev
    raw = torch.load(weights, map_location=dev, weights_only=True)
    if tuple(raw["embed"].shape) != (cfg.vocab, cfg.d_model) \
            or len(raw["layers"]) != cfg.n_layers:
        raise ValueError(f"weights {weights!r} do not fit the model spec "
                         f"(embed {tuple(raw['embed'].shape)}, "
                         f"{len(raw['layers'])} layers)")

    def cast(w):
        return w.to(cfg.dtype) if w.dim() > 1 else w

    params = {k: cast(v) if torch.is_tensor(v) else
              [{n: cast(w) for n, w in layer.items()} for layer in v]
              for k, v in raw.items()}
    return params, cfg, dev


def build_engine(model_spec: dict, engine_spec: dict, journal=None):
    """Construct a serve engine from plain-dict specs (everything must be
    picklable across the spawn boundary, so no tensors/params travel —
    each process re-derives identical params from the shared seed).
    `engine_spec["kind"]`: "ragged" (RaggedServeEngine, default) or
    "legacy" (models/serve.py's ServeEngine)."""
    from ..admission import AdmissionPolicy
    from ..models.serve import ServeEngine
    from ..serving import RaggedServeEngine

    params, cfg, dev = model_from_spec(model_spec)
    es = dict(engine_spec)
    kind = es.pop("kind", "ragged")
    adm = es.pop("admission", None)
    if adm is not None:
        adm = AdmissionPolicy(**adm)
    cls = {"ragged": RaggedServeEngine, "legacy": ServeEngine}[kind]
    return cls(params, cfg, admission=adm, journal=journal, device=dev,
               **es)


def _warm(eng) -> None:
    """Run the prefill-chunk + decode launch widths once BEFORE the
    worker reports ready, so the first request pays no first-call costs
    (kernel library load, cuBLAS handles, allocator growth) inside the
    serving loop, where they would delay the queue drain and the
    heartbeat pongs."""
    res = eng.try_submit([1] * 20, 2)
    if res.ok:
        eng.run()


def _export(obs_path: str, wid: int) -> None:
    from .. import obs
    from ..obs import spans as _spans

    publish_kernel_launches()
    obs.default_registry().export_jsonl(
        obs_path, extra_records=_spans.span_records(), process_index=wid)


def worker_main(wid: int, model_spec: dict, engine_spec: dict,
                obs_path: str, request_q, result_q,
                export_every: int = 4, ckpt_spec=None) -> None:
    """Entry point for one spawned worker (cluster.py passes this to
    multiprocessing.Process).  `ckpt_spec` (None disables checkpointing):
    {"journal": path, "snapshot": path, "every": N completions between
    snapshots, "resume": accept resume_toks prefixes, "restore": rebuild
    from the predecessor's snapshot+journal before going ready}."""
    t_boot = time.perf_counter()
    from ..fleet.transport import QueueTransport

    tr = QueueTransport(send_q=result_q, recv_q=request_q)
    try:
        ck = dict(ckpt_spec) if ckpt_spec else None
        journal = None
        rid_map = {}                  # engine rid -> router rid
        resume_prefix = {}            # engine rid -> resumed token prefix
        # warm before any journal/recovery state attaches: the warm
        # request must never land in the journal or a snapshot
        eng = build_engine(model_spec, engine_spec)
        boot = {"device": str(eng.device),
                "build_s": time.perf_counter() - t_boot}
        t0 = time.perf_counter()
        _warm(eng)
        boot["warm_s"] = time.perf_counter() - t0
        if ck is not None:
            from ..serving import checkpoint as ckpt

            if ck.get("restore"):
                # replacement life: recover the predecessor's engine, then
                # start journaling fresh (rewrite_journal) so a second
                # failure recovers from THIS life's journal alone
                t0 = time.perf_counter()
                info = ckpt.recover_engine(eng, ck.get("snapshot"),
                                           ck.get("journal"))
                rid_map = dict(info.rid_map)
                resume_prefix = {r: list(p)
                                 for r, p in info.resume_prefix.items()}
                journal = ckpt.rewrite_journal(eng, ck["journal"], rid_map,
                                               resume_prefix)
                eng.journal = journal
                live = [r for r in eng.slots if r is not None] \
                    + list(eng._queue)
                claimed = sorted(
                    {rid_map.get(r.rid, r.rid) for r in live}
                    | set(info.done))
                boot["restore_s"] = time.perf_counter() - t0
                tr.send(("restored", wid, {
                    "claimed": claimed,
                    "replayed": {int(k): int(v)
                                 for k, v in info.replayed.items()},
                    "resumed": {int(k): int(v)
                                for k, v in info.resumed.items()},
                    "from_snapshot": info.from_snapshot,
                }))
                # requests the journal proves complete need no engine time
                for ext, toks in sorted(info.done.items()):
                    tr.send(("done", wid, int(ext),
                             [int(t) for t in toks]))
            else:
                journal = ckpt.TokenJournal(ck["journal"], truncate=True)
                eng.journal = journal
        _export(obs_path, wid)  # baseline: even an early kill leaves a file
        boot["total_s"] = time.perf_counter() - t_boot
        tr.send(("ready", wid, os.getpid(), boot))
        hogged = []                   # pages held by the "hog" fault
        stall_until = 0.0
        hang = False
        stopping = False
        n_since_export = 0
        n_since_ckpt = 0
        while True:
            if hang:
                # wedged, not dead: the process is alive (liveness polls
                # pass) but drains nothing and answers no pings — only the
                # heartbeat detector can declare this worker gone
                time.sleep(0.05)
                continue
            while True:
                msg = tr.recv()
                if msg is None:
                    break
                op = msg[0]
                if op == "submit":
                    rrid, prompt, max_new = msg[1], msg[2], msg[3]
                    resume_toks = msg[4] if len(msg) > 4 else None
                    if resume_toks and ck is not None \
                            and ck.get("resume", True):
                        comp = ckpt.trim_complete(
                            resume_toks, max_new, eng.eos_id)
                        if comp is not None:
                            # the dead worker journaled past the finish
                            # line — complete with zero engine time
                            ckpt.M_RECOVERED_RESUMED.inc(len(comp))
                            tr.send(("accepted", wid, rrid))
                            tr.send(("done", wid, rrid,
                                          [int(t) for t in comp]))
                            continue
                        res = eng.try_submit(
                            list(prompt) + [int(t) for t in resume_toks],
                            max_new - len(resume_toks))
                        if res.ok:
                            ckpt.M_RECOVERED_RESUMED.inc(
                                len(resume_toks))
                            rid_map[res.rid] = rrid
                            resume_prefix[res.rid] = \
                                [int(t) for t in resume_toks]
                            if journal is not None:
                                # journal the ORIGINAL request shape so
                                # a second recovery composes
                                journal.submit(res.rid, rrid, prompt,
                                               max_new)
                                journal.tokens(res.rid, resume_toks)
                                journal.sync()
                            tr.send(("accepted", wid, rrid))
                        else:
                            tr.send((
                                "rejected", wid, rrid,
                                res.reason.value if res.reason else None,
                                res.retryable, res.message))
                    else:
                        if resume_toks and ck is not None:
                            # resume disabled: the baseline path —
                            # every journaled token gets re-decoded
                            ckpt.M_RECOVERED_REPLAYED.inc(
                                len(resume_toks))
                        res = eng.try_submit(prompt, max_new)
                        if res.ok:
                            rid_map[res.rid] = rrid
                            if journal is not None:
                                journal.submit(res.rid, rrid, prompt,
                                               max_new)
                                journal.sync()
                            tr.send(("accepted", wid, rrid))
                        else:
                            tr.send((
                                "rejected", wid, rrid,
                                res.reason.value if res.reason else None,
                                res.retryable, res.message))
                elif op == "ping":
                    tr.send(("pong", wid, msg[1]))
                elif op == "fault":
                    _, fkind, arg = msg
                    if fkind == "hog":
                        n = min(int(arg), eng.pool.available)
                        if n > 0:
                            hogged += list(eng.pool.acquire(n))
                    elif fkind == "unhog":
                        if hogged:
                            eng.pool.release(hogged)
                            hogged = []
                    elif fkind == "stall":
                        stall_until = time.monotonic() + float(arg)
                    elif fkind == "hang":
                        hang = True
                    elif fkind == "raise":
                        raise RuntimeError(
                            "injected worker fault (raise)")
                    else:
                        tr.send(("error", wid,
                                      f"unknown fault {fkind!r}"))
                elif op == "stop":
                    stopping = True
                else:
                    tr.send(("error", wid, f"unknown op {op!r}"))
            if time.monotonic() < stall_until:
                time.sleep(0.002)
                continue
            if eng.pending or eng.live:
                for erid, toks in eng.step():
                    full = resume_prefix.pop(erid, []) \
                        + [int(t) for t in toks]
                    tr.send(("done", wid, rid_map.pop(erid), full))
                    n_since_export += 1
                    n_since_ckpt += 1
                if ck is not None and ck.get("snapshot") \
                        and n_since_ckpt >= int(ck.get("every", 2)):
                    ckpt.save_snapshot(
                        eng, ck["snapshot"],
                        extra={"rid_map": rid_map,
                               "resume_prefix": resume_prefix})
                    n_since_ckpt = 0
                if n_since_export >= export_every:
                    _export(obs_path, wid)
                    n_since_export = 0
            elif stopping:
                if journal is not None:
                    journal.close()
                _export(obs_path, wid)
                tr.send(("stopped", wid, {
                    "kernels": kernel_launches(),
                    "pool_free": eng.pool.available,
                    "pool_usable": eng.pool.n_pages - 1}))
                return
            else:
                time.sleep(0.002)
    except Exception as e:  # noqa: BLE001 — report, then die visibly
        # obs snapshot FIRST (a torn registry export must never be the
        # price of an error), then the error frame, then a flush so the
        # frame survives this process dying right after
        try:
            _export(obs_path, wid)
        except Exception as ee:  # noqa: BLE001 — export is best-effort
            os.write(2, f"loadgen worker {wid}: obs export failed: "
                        f"{ee}\n".encode())
        try:
            tr.send(("error", wid, f"{type(e).__name__}: {e}"))
            tr.flush()
        except Exception:  # noqa: BLE001 — router gone; stderr is all
            os.write(2, f"loadgen worker {wid}: {e}\n".encode())
        raise
