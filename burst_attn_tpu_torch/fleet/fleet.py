"""Role-split serving fleet: ring-prefill pool -> KV plane -> decode pool
(port of burst_attn_tpu/fleet/fleet.py).

The loadgen cluster (loadgen/cluster.py) runs the fault story with
symmetric workers.  This module splits the roles the way disaggregated
servers do (Mooncake-style prefill/decode disaggregation).  Every member
runs on the card unless the model spec says `"device": "cpu"` (the
tests): the prefill workers' ring pass runs kernel 8 (the fused ring,
`attn_backend="fused_ring"`) or kernel 1 (the scan ring), its W ring
positions sharing the card; the decode replicas step
`dist_paged_decode_step` (plain PyTorch, as it is plain jnp in the JAX
package).  Each member reports its boot seconds in its "ready" frame and
its kernel launches in its obs exports and its "stopped" frame.  The
roles:

  PREFILL workers   one handoff slot each: `ring_prefill_to_pages`
                    absorbs the prompt on an sp mesh, the slot's pages
                    serialize in table order (kvplane.export_slot_pages)
                    and ship as kv_begin/kv_page/kv_end frames.  Pages
                    are HELD until the router acks — a decode replica
                    dying mid-transfer costs a re-ship of the buffered
                    frames, never a re-prefill.
  DECODE replicas   a paged pool + `dist_paged_decode_step`, staging
                    transfers transactionally (kvplane.KvReceiver: admit
                    only after every page lands CRC-clean, zero pool
                    mutation on abort), journaling every sampled token
                    write-ahead, and snapshotting the whole pool every
                    `checkpoint_every` completions.
  ROUTER            one process, two pools, one transport protocol
                    (fleet/transport.py — mp queues in-process, TCP
                    sockets cross-host, SAME frames either way).  It
                    relays KV frames (and buffers them: the transfer can
                    be re-shipped to a sibling without the prefill
                    worker's involvement), routes on live admission
                    gauges from heartbeat pongs (slot occupancy, staged
                    transfers, pool availability), and drives failover.

Failure story, cross-boundary (mirrors cluster.py's matrix):

  kill prefill      mid-ship transfers abort on the decode side (staging
                    dropped, zero pages leaked — `abort_ok` carries the
                    replica's gauges as evidence) and the request re-runs
                    prefill on a sibling; a COMPLETE buffered transfer
                    proceeds without the dead sender.
  kill decode       un-admitted transfers re-ship to a sibling replica;
                    admitted streams resume from the dead replica's
                    journal — the router re-runs prefill with the
                    journaled prefix and the receiving replica
                    teacher-forces it (greedy decode: the prefix IS the
                    continuation), or completes directly when the
                    journal already covers the budget.
  restart decode    the replacement restores the dead life's paged
                    snapshot, rolls the journal forward (re-feeding only
                    the lag), claims its slots, and keeps decoding.
  hog / stall /     same semantics as the cluster, on either pool; a
  hang              hung member is caught by the heartbeat detector
                    generalized across both pools.
  die_mid_ship /    deterministic kill-mid-transfer arming (prefill dies
  die_mid_recv      after sending N pages / decode dies after receiving
                    N pages) for the zero-leak transaction tests.

Token-exactness: every request's full stream (first prefill-sampled
token + greedy decode) is compared against `fleet_oracle` — the same
model stepped in ONE process — and every admitted transfer's page
digests are compared sender vs receiver (byte-identical shipment).  An
fp32 fleet is held token-exact; a bf16 fleet's batch of decode slots
rounds differently from the oracle's single slot, so bf16 streams are
held to the near-tie bar, while its shipped 2-byte pages still match
their digests on both ends.
"""

import multiprocessing as mp
import os
import signal
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..obs import trace as tracing
from ..loadgen.driver import DONE, Outcome, ReplayReport, RetryBackoff
from ..loadgen.trace import Trace
from ..loadgen.worker import (
    kernel_launches, model_from_spec, publish_kernel_launches,
)
from ..protocols import kvtransfer as kv_proto
from . import kvplane
from . import policy as fleet_policy
from .transport import (
    Dedup, QueueTransport, SocketTransport, TransportError, accept, listen,
    send_with_retry,
)

FLEET_FAULT_KINDS = ("kill", "hog", "unhog", "stall", "hang", "restart",
                     "die_mid_ship", "die_mid_recv")
POOLS = ("prefill", "decode")

G_QUEUE_DEPTH = obs.gauge(
    "fleet.queue_depth", "requests waiting for a prefill worker")
G_DECODE_OCC = obs.gauge(
    "fleet.decode_occupancy", "live decode slots across the replica pool")
M_RESHIPS = obs.counter(
    "fleet.kv_reships", "buffered transfers re-shipped to a sibling")
M_SCALE_UPS = obs.counter(
    "fleet.scale_ups", "decode replicas spawned on sustained pressure")
M_SCALE_DOWNS = obs.counter(
    "fleet.scale_downs", "idle decode replicas retired")
M_RING_PREFILLS = obs.counter(
    "fleet.ring_prefills",
    "ring prefill passes of a prefill worker (its warm pass included)")


@dataclass(frozen=True)
class FleetFault:
    """One scheduled fault: at virtual time `t`, do `kind` to `worker`
    of `pool`.  kill/restart wait for armed work exactly like
    cluster.FaultEvent (in-flight + journaled progress on decode;
    an assigned request on prefill); die_mid_ship/die_mid_recv arm
    inside the target and fire on its NEXT transfer (`arg` = pages to
    let through first)."""

    t: float
    pool: str
    worker: int
    kind: str
    arg: float = 0.0
    note: str = ""

    def __post_init__(self):
        if self.pool not in POOLS:
            raise ValueError(f"unknown pool {self.pool!r} (one of {POOLS})")
        if self.kind not in FLEET_FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FLEET_FAULT_KINDS})")
        if self.kind == "die_mid_ship" and self.pool != "prefill":
            raise ValueError("die_mid_ship targets the prefill pool")
        if self.kind == "die_mid_recv" and self.pool != "decode":
            raise ValueError("die_mid_recv targets the decode pool")


@dataclass
class FleetReport(ReplayReport):
    """ReplayReport plus the fleet's evidence ledger: kills carry the
    pool they hit; `transfers` counts committed/aborted/re-shipped KV
    transactions with digest-comparison results and the zero-leak
    evidence (`aborts`: the replica's staging/availability gauges echoed
    after every abort/reject); `scale_events` logs autoscaling."""

    kills: List[dict] = field(default_factory=list)
    transfers: dict = field(default_factory=dict)
    scale_events: List[dict] = field(default_factory=list)
    obs_paths: List[str] = field(default_factory=list)
    recovered_tokens_replayed: int = 0
    recovered_tokens_resumed: int = 0

    def recovery_s(self) -> List[float]:
        """Per-fault recovery spans (virtual), cluster semantics."""
        out = []
        for k in self.kills:
            ts = [self.outcomes[rid].t_done for rid in k["rerouted"]
                  if self.outcomes[rid].t_done is not None]
            out.append(max(ts) - k["t"] if ts else 0.0)
        return out


# -- shared child plumbing --------------------------------------------------


def _child_transport(conn):
    if conn[0] == "queue":
        _, req_q, res_q = conn
        return QueueTransport(send_q=res_q, recv_q=req_q)
    _, host, port, role, wid = conn
    tr = SocketTransport.connect(host, port, retries=30, rid=wid)
    tr.send(("hello", role, wid))
    return tr


def _export(obs_path: str, wid: int, kernels: bool = True) -> None:
    """Export this process's obs snapshot; a member's (`kernels`) first
    brings its kernel.launches counters up to date (the router's own
    export carries no kernel counts: it launches nothing)."""
    from ..obs import spans as _spans
    from ..obs import trace as _trace

    extra = (_spans.span_records() + _trace.trace_records()
             + _trace.exemplar_records())
    if kernels:
        publish_kernel_launches()
    obs.default_registry().export_jsonl(
        obs_path, extra_records=extra, process_index=wid)


def _dispatch_msg(rid: int, prompt, max_new: int, resume=None,
                  trace_wire=None):
    """Router -> prefill work tuple.  `resume` and `trace_wire` are
    OPTIONAL trailing elements, appended only when non-empty — a
    tracing-off run's frames encode byte-identical to a build without
    tracing (the zero-wire-cost-when-off bar)."""
    msg = ("prefill", int(rid), prompt, int(max_new))
    if resume or trace_wire:
        msg = msg + ([int(t) for t in (resume or [])],)
    if trace_wire:
        msg = msg + (list(trace_wire),)
    return msg


def _op(msg):
    return msg["op"] if isinstance(msg, dict) else msg[0]


def _die_loudly(role: str, wid: int, tr, obs_path: str, e: Exception):
    """Worker error path: flush obs BEFORE the error frame so the crash
    never leaves a torn registry export, then flush the transport so the
    frame survives this process dying right after (an error during stop
    must not vanish)."""
    try:
        _export(obs_path, wid)
    except Exception as ee:  # noqa: BLE001 — export is best-effort here
        os.write(2, f"fleet {role} {wid}: obs export failed: {ee}\n".encode())
    try:
        tr.send(("error", wid, f"{type(e).__name__}: {e}"))
        tr.flush()
    except Exception:  # noqa: BLE001 — transport gone with the router
        os.write(2, f"fleet {role} {wid}: {e}\n".encode())


# -- prefill worker ---------------------------------------------------------


def prefill_main(wid: int, model_spec: dict, prefill_spec: dict,
                 obs_path: str, conn) -> None:
    """One ring-prefill worker: a single handoff slot, prompt in ->
    pages out.  Pages are exported in table order with per-page sha256
    digests in the kv_begin meta and HELD until kv_ack/kv_abort retires
    the slot (the transactional sender side)."""
    t_boot = time.perf_counter()
    tr = _child_transport(conn)
    try:
        from ..models.paged_decode import init_paged_state, retire_slot
        from ..models.train import make_mesh
        from ..serving.handoff import ring_prefill_to_pages

        params, cfg, dev = model_from_spec(model_spec)
        boot = {"device": str(dev), "build_s": time.perf_counter() - t_boot}
        ps = dict(prefill_spec)
        if ps.get("trace"):
            tracing.enable()
        mesh = make_mesh({"sp": int(ps.get("sp", 2))})
        page = int(ps.get("page", 128))
        state, pool = init_paged_state(
            cfg, slots=1, n_pages=int(ps.get("n_pages", 4)), page=page,
            max_pages_per_seq=int(ps.get("max_pages_per_seq", 8)),
            quantize=ps.get("quantize", False), device=dev)
        # warm the ring pass on the fleet's prompt shape BEFORE ready: the
        # first call's costs inside the message loop would delay pongs
        t0 = time.perf_counter()
        warm = np.zeros((int(ps.get("warm_len", page)),), np.int32)
        _, state = ring_prefill_to_pages(params, warm, state, pool, 0,
                                         cfg, mesh)
        M_RING_PREFILLS.inc()
        state = retire_slot(state, pool, 0)
        boot["warm_s"] = time.perf_counter() - t0
        _export(obs_path, wid)
        boot["total_s"] = time.perf_counter() - t_boot
        tr.send(("ready", wid, os.getpid(), boot))

        backlog: deque = deque()
        pending: Dict[int, int] = {}   # rid -> n_pages awaiting ack
        hogged: List[int] = []
        stall_until = 0.0
        hang = False
        stopping = False
        die_mid_ship = None
        while True:
            if hang:
                time.sleep(0.05)
                continue
            while True:
                msg = tr.recv(timeout=0.0 if (backlog or pending) else 0.002)
                if msg is None:
                    break
                op = _op(msg)
                if op == "prefill":
                    backlog.append(msg)
                elif op in ("kv_ack", "kv_abort"):
                    rid = int(msg[1])
                    if pending.pop(rid, None) is not None:
                        state = retire_slot(state, pool, 0)
                elif op == "ping":
                    tr.send(("pong", wid, msg[1],
                             {"busy": bool(pending or backlog),
                              "avail": pool.available}))
                elif op == "fault":
                    _, fkind, arg = msg[0], msg[1], msg[2]
                    if fkind == "hog":
                        n = min(int(arg), pool.available)
                        if n > 0:
                            hogged += list(pool.acquire(n))
                    elif fkind == "unhog":
                        if hogged:
                            pool.release(hogged)
                            hogged = []
                    elif fkind == "stall":
                        stall_until = time.monotonic() + float(arg)
                    elif fkind == "hang":
                        hang = True
                    elif fkind == "die_mid_ship":
                        die_mid_ship = int(arg)
                    else:
                        tr.send(("error", wid, f"unknown fault {fkind!r}"))
                elif op == "stop":
                    stopping = True
                else:
                    tr.send(("error", wid, f"unknown op {op!r}"))
            if time.monotonic() < stall_until:
                time.sleep(0.002)
                continue
            if backlog and not pending:
                msg = backlog.popleft()
                rid, prompt, max_new = int(msg[1]), msg[2], int(msg[3])
                resume = [int(t) for t in (msg[4] if len(msg) > 4 and msg[4]
                                           else [])]
                # optional element 5: the router's trace context — spans
                # recorded here join the router's tree on merge
                tc = tracing.TraceContext.from_wire(
                    msg[5] if len(msg) > 5 else None)
                t_p0 = time.perf_counter()
                try:
                    logits, state = ring_prefill_to_pages(
                        params, np.asarray([int(t) for t in prompt],
                                           np.int32),
                        state, pool, 0, cfg, mesh)
                    M_RING_PREFILLS.inc()
                except (RuntimeError, ValueError) as e:
                    # hogged/exhausted pool or a bad request shape: typed,
                    # retryable rejection — the router backs off & re-routes
                    tr.send({"op": "prefill_failed", "rid": rid,
                             "retryable": True,
                             "message": f"{type(e).__name__}: {e}"})
                    continue
                first = resume[0] if resume \
                    else int(logits.argmax())
                tracing.record_span(tc, "fleet.prefill", t_p0,
                                    time.perf_counter(),
                                    prompt_len=len(prompt))
                meta, pages = kvplane.export_slot_pages(state, 0)
                meta.update(
                    rid=rid, max_new=max_new, first_token=first,
                    resume_toks=resume, prompt_len=len(prompt),
                    digests=[kvplane.page_digest(pg) for pg in pages])
                if tc is not None and tracing.enabled():
                    # ride the context to the decode side in the transfer's
                    # meta — absent entirely when tracing is off
                    meta["trace"] = tc.to_wire()
                t_s0 = time.perf_counter()
                # the frame sequence (ops + seq numbers) comes from the
                # transfer machine's sender_plan.  The plan also pins the
                # credit contract: every frame ships without waiting (the
                # one kv_ack arrives only after the replica commits)
                for op, seq in kv_proto.sender_plan(len(pages)):
                    if op == "kv_begin":
                        frame = {"op": op, "rid": rid, "seq": seq,
                                 "meta": meta}
                    elif op == "kv_page":
                        j = seq - 1
                        if die_mid_ship is not None and j >= die_mid_ship:
                            tr.flush()  # delivered frames stay delivered
                            os._exit(17)
                        frame = {"op": op, "rid": rid, "seq": seq,
                                 "page": pages[j]}
                    else:  # kv_end
                        frame = {"op": op, "rid": rid, "seq": seq}
                    send_with_retry(tr, frame, rid=rid)
                tracing.record_span(tc, "fleet.ship", t_s0,
                                    time.perf_counter(),
                                    n_pages=len(pages))
                pending[rid] = int(meta["n_pages"])
            elif stopping and not backlog and not pending:
                _export(obs_path, wid)
                tr.send(("stopped", wid, {
                    "kernels": kernel_launches(),
                    "ring_prefills": int(M_RING_PREFILLS.total()),
                    "pool_free": pool.available,
                    "pool_usable": pool.n_pages - 1}))
                tr.flush()
                return
            elif not backlog:
                time.sleep(0.002)
    except Exception as e:  # noqa: BLE001 — report, then die visibly
        _die_loudly("prefill", wid, tr, obs_path, e)
        raise


# -- decode replica ---------------------------------------------------------


def decode_main(wid: int, model_spec: dict, decode_spec: dict,
                obs_path: str, conn, ckpt_spec=None) -> None:
    """One paged-decode replica: transactional KV admission, batched
    greedy `dist_paged_decode_step` over its live slots, write-ahead
    token journal, paged snapshots every `every` completions, and a
    restore path (`ckpt_spec["restore"]`) that rebuilds the dead life's
    pool from snapshot + journal roll-forward."""
    t_boot = time.perf_counter()
    tr = _child_transport(conn)
    try:
        import torch

        from ..models.decode import sample_logits
        from ..models.dist_decode import dist_paged_decode_step
        from ..models.paged_decode import (
            init_paged_state, provision_capacity, retire_slot,
        )
        from ..models.train import make_mesh
        from ..serving import checkpoint as ckpt

        params, cfg, dev = model_from_spec(model_spec)
        boot = {"device": str(dev), "build_s": time.perf_counter() - t_boot}
        ds = dict(decode_spec)
        if ds.get("trace"):
            tracing.enable()
        mesh = make_mesh({"sp": int(ds.get("sp", 2))})
        slots = int(ds.get("slots", 2))
        page = int(ds.get("page", 128))
        pool_args = dict(slots=slots, n_pages=int(ds.get("n_pages", 8)),
                         page=page,
                         max_pages_per_seq=int(ds.get("max_pages_per_seq",
                                                      4)),
                         quantize=ds.get("quantize", False), device=dev)
        echo_digests = bool(ds.get("echo_digests"))
        export_every = int(ds.get("export_every", 4))
        ck = dict(ckpt_spec) if ckpt_spec else None

        live: Dict[int, dict] = {}   # slot -> {rid, max_new, tokens, fed}
        t_kv0: Dict[int, float] = {}  # rid -> first kv_begin recv time
        boot_dones: List[Tuple[int, List[int]]] = []
        restored_info = None
        if ck and ck.get("restore") and os.path.exists(ck["snapshot"]):
            t0 = time.perf_counter()
            state, pool, extra = ckpt.load_paged_snapshot(ck["snapshot"],
                                                          device=dev)
            try:
                jt = ckpt.journal_tokens_by_ext(ck["journal"])
                jdone = {int(view_sub["ext"])
                         for erid, view_sub
                         in ckpt.journal_view(ck["journal"]).submits.items()
                         if erid in ckpt.journal_view(ck["journal"]).done}
            except (OSError, ValueError):
                jt, jdone = {}, set()
            replayed, resumed = {}, {}
            for s_str, info in (extra.get("slots") or {}).items():
                s, rid = int(s_str), int(info["rid"])
                toks = [int(t) for t in info["tokens"]]
                lag = [int(t) for t in jt.get(rid, [])][len(toks):]
                live[s] = {"rid": rid, "max_new": int(info["max_new"]),
                           "tokens": toks + lag, "fed": int(info["fed"])}
                resumed[rid] = len(toks)
                replayed[rid] = len(lag)
            for rid in sorted(jdone):
                boot_dones.append((rid, [int(t) for t in jt.get(rid, [])]))
            restored_info = {
                "claimed": sorted(info["rid"] for info in live.values()),
                "replayed": replayed, "resumed": resumed,
                "from_snapshot": True,
            }
            boot["restore_s"] = time.perf_counter() - t0
        else:
            state, pool = init_paged_state(cfg, **pool_args)
            if ck and ck.get("restore"):
                restored_info = {"claimed": [], "replayed": {},
                                 "resumed": {}, "from_snapshot": False}
        journal = None
        if ck:
            # fresh journal for THIS life (rewrite_journal semantics): a
            # second failure recovers from this life's records alone
            journal = ckpt.TokenJournal(ck["journal"], truncate=True)
            for info in live.values():
                journal.submit(info["rid"], info["rid"], [],
                               info["max_new"])
                journal.tokens(info["rid"], info["tokens"])
            journal.sync()
        # warm the decode step on a throwaway state of identical shapes —
        # stepping the REAL state would append to restored slots
        t0 = time.perf_counter()
        wstate, _wpool = init_paged_state(cfg, **pool_args)
        dist_paged_decode_step(params, torch.zeros(slots, dtype=torch.long),
                               wstate, cfg, mesh)
        del wstate, _wpool
        boot["warm_s"] = time.perf_counter() - t0
        _export(obs_path, wid)
        if restored_info is not None:
            tr.send(("restored", wid, restored_info))
        for rid, toks in boot_dones:
            tr.send({"op": "done", "rid": rid, "tokens": toks, "stats": {}})
        boot["total_s"] = time.perf_counter() - t_boot
        tr.send(("ready", wid, os.getpid(), boot))

        receiver = kvplane.KvReceiver()
        dedup = Dedup()
        hogged: List[int] = []
        stall_until = 0.0
        hang = False
        stopping = False
        die_mid_recv = None
        recv_count = 0
        n_since_ckpt = 0
        n_since_export = 0

        def _stats() -> dict:
            return {"occ": len(live), "staged": receiver.staging_count(),
                    "avail": pool.available,
                    "slots_free": slots - len(live)}

        def _finish(s: int, st, info: dict):
            tc = info.get("_tc")  # absent on snapshot-restored slots
            if tc is not None:
                tracing.record_span(tc, "fleet.decode",
                                    info.get("_t_admit", 0.0),
                                    time.perf_counter(),
                                    tokens=len(info["tokens"]))
            if journal is not None:
                journal.done(info["rid"])
                journal.sync()
            tr.send({"op": "done", "rid": info["rid"],
                     "tokens": [int(t) for t in info["tokens"]],
                     "stats": _stats()})
            st = retire_slot(st, pool, s)
            del live[s]
            return st

        # a restored slot whose journal already covered the budget
        # finishes with zero engine time
        for s in sorted(live):
            if len(live[s]["tokens"]) >= live[s]["max_new"]:
                live[s]["tokens"] = live[s]["tokens"][:live[s]["max_new"]]
                state = _finish(s, state, live[s])

        while True:
            if hang:
                time.sleep(0.05)
                continue
            while True:
                msg = tr.recv(timeout=0.0 if live else 0.002)
                if msg is None:
                    break
                if isinstance(msg, dict):
                    op, rid = msg["op"], int(msg["rid"])
                    if op == "kv_begin":
                        dedup.forget_rid(rid)  # new attempt, new seq space
                        if dedup.accept(rid, 0):
                            t_kv0[rid] = time.perf_counter()
                            receiver.begin(rid, msg["meta"])
                    elif op == "kv_page":
                        if die_mid_recv is not None:
                            recv_count += 1
                            if recv_count > die_mid_recv:
                                tr.flush()
                                os._exit(19)
                        if dedup.accept(rid, int(msg["seq"])):
                            try:
                                receiver.add_page(rid, int(msg["seq"]) - 1,
                                                  msg["page"])
                            except (KeyError, ValueError) as e:
                                receiver.abort(rid)
                                tr.send({"op": "admit_reject", "rid": rid,
                                         "retryable": True,
                                         "message": str(e),
                                         "stats": _stats()})
                    elif op == "kv_end":
                        if not dedup.accept(rid, int(msg["seq"])):
                            continue
                        st = receiver.staged(rid)
                        meta = st["meta"] if st else {}
                        tc = tracing.TraceContext.from_wire(
                            meta.get("trace"))
                        s = next((x for x in range(slots) if x not in live),
                                 None)
                        t_c0 = time.perf_counter()
                        try:
                            if st is None or not receiver.complete(rid):
                                raise RuntimeError(
                                    f"rid {rid}: transfer incomplete")
                            if s is None:
                                raise RuntimeError("no free decode slot")
                            state = receiver.commit(rid, state, pool, s)
                            state = provision_capacity(
                                state, pool, s, int(meta["max_new"]))
                        except (RuntimeError, ValueError, KeyError) as e:
                            # transactional reject: commit is all-or-
                            # nothing; a provision failure AFTER commit
                            # retires the slot, so the pool is byte-for-
                            # byte where it started (zero-leak)
                            if s is not None and int(state.lengths[s]) != 0:
                                state = retire_slot(state, pool, s)
                            receiver.abort(rid)
                            t_kv0.pop(rid, None)
                            tr.send({"op": "admit_reject", "rid": rid,
                                     "retryable": True,
                                     "message": f"{type(e).__name__}: {e}",
                                     "stats": _stats()})
                            continue
                        now = time.perf_counter()
                        # transfer = first kv frame received -> commit
                        # start; commit = the staged-pages -> pool copy
                        tracing.record_span(tc, "fleet.transfer",
                                            t_kv0.pop(rid, t_c0), t_c0)
                        tracing.record_span(tc, "fleet.commit", t_c0, now)
                        toks = [int(t) for t in
                                (meta.get("resume_toks") or [])] \
                            or [int(meta["first_token"])]
                        info = {"rid": rid, "max_new": int(meta["max_new"]),
                                "tokens": toks, "fed": 0,
                                "_tc": tc, "_t_admit": now}
                        live[s] = info
                        if journal is not None:
                            journal.submit(rid, rid, [], info["max_new"])
                            journal.tokens(rid, toks)
                            journal.sync()
                        admitted = {"op": "admitted", "rid": rid, "slot": s,
                                    "stats": _stats()}
                        if echo_digests:
                            _, committed = kvplane.export_slot_pages(state,
                                                                     s)
                            admitted["digests"] = [
                                kvplane.page_digest(pg) for pg in committed]
                        tr.send(admitted)
                        if len(toks) >= info["max_new"]:
                            info["tokens"] = toks[:info["max_new"]]
                            state = _finish(s, state, info)
                            n_since_ckpt += 1
                    elif op == "kv_abort":
                        receiver.abort(rid)
                        t_kv0.pop(rid, None)
                        tr.send({"op": "abort_ok", "rid": rid,
                                 "stats": _stats()})
                    else:
                        tr.send(("error", wid, f"unknown op {op!r}"))
                else:
                    op = msg[0]
                    if op == "ping":
                        tr.send(("pong", wid, msg[1], _stats()))
                    elif op == "fault":
                        _, fkind, arg = msg[0], msg[1], msg[2]
                        if fkind == "hog":
                            n = min(int(arg), pool.available)
                            if n > 0:
                                hogged += list(pool.acquire(n))
                        elif fkind == "unhog":
                            if hogged:
                                pool.release(hogged)
                                hogged = []
                        elif fkind == "stall":
                            stall_until = time.monotonic() + float(arg)
                        elif fkind == "hang":
                            hang = True
                        elif fkind == "die_mid_recv":
                            die_mid_recv = int(arg)
                            recv_count = 0
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
            if live:
                feed = torch.zeros(slots, dtype=torch.long)
                stepped = dict(live)
                for s, info in stepped.items():
                    feed[s] = info["tokens"][info["fed"]]
                logits, state = dist_paged_decode_step(
                    params, feed, state, cfg, mesh)
                # greedy, one readback for every slot; -1 = NaN row
                picks = sample_logits(logits, nan_sentinel=True).tolist()
                for s, info in stepped.items():
                    info["fed"] += 1
                    if info["fed"] == len(info["tokens"]) \
                            and len(info["tokens"]) < info["max_new"]:
                        t = int(picks[s])
                        if t < 0:
                            raise RuntimeError(
                                f"decode slot {s} logits NaN-poisoned")
                        info["tokens"].append(t)
                        if journal is not None:
                            journal.tokens(info["rid"], [t])
                            journal.sync()
                    if len(info["tokens"]) >= info["max_new"]:
                        state = _finish(s, state, info)
                        n_since_ckpt += 1
                        n_since_export += 1
                if ck and ck.get("snapshot") \
                        and n_since_ckpt >= int(ck.get("every", 2)):
                    ckpt.save_paged_snapshot(
                        ck["snapshot"], state, pool,
                        extra={"slots": {
                            str(s): {"rid": info["rid"],
                                     "max_new": info["max_new"],
                                     "tokens": list(info["tokens"]),
                                     "fed": info["fed"]}
                            for s, info in live.items()}})
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
                    "pool_free": pool.available,
                    "pool_usable": pool.n_pages - 1,
                    "staged": receiver.staging_count()}))
                tr.flush()
                return
            else:
                time.sleep(0.002)
    except Exception as e:  # noqa: BLE001 — report, then die visibly
        _die_loudly("decode", wid, tr, obs_path, e)
        raise


# -- the single-process oracle ----------------------------------------------


def fleet_oracle(trace: Trace, model_spec: dict, *, prefill_spec=None,
                 decode_spec=None):
    """Per-request ground truth in ONE process: ring prefill -> in-
    process handoff -> greedy dist paged decode.  Returns (tokens_by_rid,
    digests_by_rid) — the token streams the fleet must match exactly and
    the page digests shipped transfers must match byte-for-byte."""
    from ..models.paged_decode import init_paged_state, provision_capacity
    from ..models.train import make_mesh
    from ..serving.handoff import handoff_decode, ring_prefill_to_pages

    params, cfg, dev = model_from_spec(model_spec)
    ps = dict(prefill_spec or {})
    ds = dict(decode_spec or {})
    mesh = make_mesh({"sp": int(ps.get("sp", 2))})
    pool_args = dict(slots=1, n_pages=int(ds.get("n_pages", 8)),
                     page=int(ds.get("page", 128)),
                     max_pages_per_seq=int(ds.get("max_pages_per_seq", 4)),
                     quantize=ds.get("quantize", False), device=dev)
    tokens_by_rid, digests_by_rid = {}, {}
    for req in trace.requests:
        state, pool = init_paged_state(cfg, **pool_args)
        prompt = np.asarray([int(t) for t in req.prompt(trace.vocab)],
                            np.int32)
        logits, state = ring_prefill_to_pages(params, prompt, state, pool,
                                              0, cfg, mesh)
        first = int(logits.argmax())
        _, pages = kvplane.export_slot_pages(state, 0)
        digests_by_rid[req.rid] = [kvplane.page_digest(pg) for pg in pages]
        budget = int(req.max_new_tokens)
        state = provision_capacity(state, pool, 0, budget)
        toks, state = handoff_decode(params, state, cfg, mesh, slot=0,
                                     last_token=first, n_steps=budget - 1)
        tokens_by_rid[req.rid] = [first] + [int(t) for t in toks]
    return tokens_by_rid, digests_by_rid


# -- the router -------------------------------------------------------------


class FleetCluster:
    """Spawn both pools, replay a trace across the prefill/decode
    boundary, stop.  Context manager — __exit__ always reaps.

    transport="queue" runs the protocol over multiprocessing queues
    (in-process fleet); transport="socket" runs the SAME frames over
    localhost TCP — the cross-host deployment shape, minus the second
    machine."""

    def __init__(self, model_spec: dict, *, prefill_spec=None,
                 decode_spec=None, n_prefill: int = 1, n_decode: int = 1,
                 out_dir: str, transport: str = "queue",
                 checkpoint_every: int = 2, export_every: int = 4,
                 start_timeout_s: float = 600.0,
                 restart_timeout_s: float = 600.0,
                 hb_interval_s: float = 0.5, hb_timeout_s: float = 60.0,
                 autoscale: bool = False, max_decode: Optional[int] = None,
                 min_decode: int = 1, scale_check_interval_s: float = 0.4,
                 scale_up_after: int = 3, scale_down_after: int = 12,
                 router_policy: str = fleet_policy.DEFAULT_ROUTE_POLICY,
                 trace: bool = False):
        if n_prefill < 1 or n_decode < 1:
            raise ValueError("need >= 1 worker in each pool")
        if transport not in ("queue", "socket"):
            raise ValueError(f"unknown transport {transport!r}")
        if router_policy not in fleet_policy.ROUTE_POLICY_FUNCS:
            raise ValueError(
                f"unknown router_policy {router_policy!r} (one of "
                f"{sorted(fleet_policy.ROUTE_POLICY_FUNCS)})")
        self.model_spec = dict(model_spec)
        self.prefill_spec = dict(prefill_spec or {})
        self.decode_spec = dict(decode_spec or {})
        # request tracing rides the worker specs so restarts and
        # scale-ups inherit it; the key is absent when off, keeping
        # tracing-off spec dicts (and their pickled spawn args) unchanged
        self.trace_enabled = bool(trace)
        if self.trace_enabled:
            self.prefill_spec["trace"] = True
            self.decode_spec["trace"] = True
        self.n_prefill = n_prefill
        self.n_decode = n_decode
        self.out_dir = out_dir
        self.transport = transport
        self.checkpoint_every = checkpoint_every
        self.export_every = export_every
        self.start_timeout_s = start_timeout_s
        self.restart_timeout_s = restart_timeout_s
        self.hb_interval_s = hb_interval_s
        self.hb_timeout_s = hb_timeout_s
        self.autoscale = autoscale
        self.max_decode = max_decode if max_decode is not None else n_decode
        self.min_decode = min_decode
        self.scale_check_interval_s = scale_check_interval_s
        self.scale_up_after = scale_up_after
        self.scale_down_after = scale_down_after
        self.router_policy = router_policy
        self._ctx = mp.get_context("spawn")
        self._m: Dict[Tuple[str, int], dict] = {}  # (role, wid) -> member
        self._alive = {"prefill": set(), "decode": set()}
        self._gen: Dict[Tuple[str, int], int] = {}
        self._obs_files: List[str] = []
        self._next_decode_wid = n_decode
        self._listener = None
        self._port = None
        self.worker_errors: List[tuple] = []
        self._t_spawn: Dict[Tuple[str, int], float] = {}
        # one record a member life: {"pool", "worker", "gen", "s" (spawn
        # to ready, parent clock), and the child's phases}
        self.boot_s: List[dict] = []
        # (role, wid) -> its "stopped" frame's info: kernel launches, free
        # and usable pool pages (equal: nothing leaked), and the prefill
        # worker's ring passes
        self.stopped: Dict[Tuple[str, int], dict] = {}

    # -- paths ---------------------------------------------------------

    def obs_path(self, role: str, wid: int) -> str:
        gen = self._gen.get((role, wid), 0)
        suffix = f"g{gen}" if gen else ""
        return os.path.join(self.out_dir,
                            f"obs_{role[0]}{wid}{suffix}.jsonl")

    def journal_path(self, wid: int) -> str:
        return os.path.join(self.out_dir, f"fleet_journal_d{wid}.jsonl")

    def snapshot_path(self, wid: int) -> str:
        return os.path.join(self.out_dir, f"fleet_ckpt_d{wid}.npz")

    @property
    def obs_paths(self) -> List[str]:
        return list(self._obs_files)

    # -- lifecycle -----------------------------------------------------

    def _spawn(self, role: str, wid: int, restore: bool = False,
               accept: bool = True) -> None:
        """Start one member (with restore=True, its replacement).  Over
        sockets its connection is accepted here unless `accept` is False
        (start() spawns every member first, then accepts them all, so the
        members' boots overlap)."""
        if restore:
            self._gen[(role, wid)] = self._gen.get((role, wid), 0) + 1
        path = self.obs_path(role, wid)
        if role == "decode" and not restore:
            for stale in (path, self.journal_path(wid),
                          self.snapshot_path(wid)):
                if os.path.exists(stale):
                    os.remove(stale)
        if path not in self._obs_files:
            self._obs_files.append(path)
        old = self._m.get((role, wid))
        if old is not None and old["tr"] is not None:
            # a dead life's carrier: never read again
            if isinstance(old["tr"], QueueTransport):
                old["tr"].abandon()
            else:
                old["tr"].close()
        if self.transport == "queue":
            req_q, res_q = self._ctx.Queue(), self._ctx.Queue()
            conn = ("queue", req_q, res_q)
            tr = QueueTransport(send_q=req_q, recv_q=res_q)
        else:
            conn = ("socket", "127.0.0.1", self._port, role, wid)
            tr = None  # attached on accept
        if role == "prefill":
            spec = dict(self.prefill_spec)
            args = (wid, self.model_spec, spec, path, conn)
            target = prefill_main
        else:
            spec = dict(self.decode_spec)
            spec.setdefault("export_every", self.export_every)
            ckpt_spec = {"journal": self.journal_path(wid),
                         "snapshot": self.snapshot_path(wid),
                         "every": self.checkpoint_every,
                         "restore": restore}
            args = (wid, self.model_spec, spec, path, conn, ckpt_spec)
            target = decode_main
        proc = self._ctx.Process(target=target, args=args, daemon=True,
                                 name=f"fleet-{role}-{wid}")
        self._t_spawn[(role, wid)] = time.monotonic()
        proc.start()
        self._m[(role, wid)] = {"proc": proc, "tr": tr, "stats": {},
                                "last_pong": time.monotonic()}
        if self.transport == "socket" and accept:
            self._accept_one()

    def _accept_one(self) -> None:
        """Accept one member connection and bind it by its hello frame."""
        deadline = time.monotonic() + self.start_timeout_s
        while True:
            tr = accept(self._listener,
                        timeout_s=max(deadline - time.monotonic(), 1.0))
            hello = tr.recv(timeout=30.0)
            if hello is None or _op(hello) != "hello":
                tr.close()
                continue
            role, wid = str(hello[1]), int(hello[2])
            key = (role, wid)
            if key in self._m and self._m[key]["tr"] is None:
                self._m[key]["tr"] = tr
                return
            tr.close()  # stale reconnect from a dead life

    def _note_ready(self, key, msg) -> None:
        rec = {"pool": key[0], "worker": key[1], "gen": self._gen.get(key, 0),
               "s": time.monotonic() - self._t_spawn[key]}
        if len(msg) > 3 and isinstance(msg[3], dict):
            rec.update(msg[3])
        self.boot_s.append(rec)

    def start(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        if self.transport == "socket":
            self._listener, self._port = listen()
        for wid in range(self.n_prefill):
            self._spawn("prefill", wid, accept=False)
        for wid in range(self.n_decode):
            self._spawn("decode", wid, accept=False)
        if self.transport == "socket":
            for _ in range(self.n_prefill + self.n_decode):
                self._accept_one()
        deadline = time.monotonic() + self.start_timeout_s
        waiting = {("prefill", w) for w in range(self.n_prefill)} \
            | {("decode", w) for w in range(self.n_decode)}
        while waiting:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet members {sorted(waiting)} not ready within "
                    f"{self.start_timeout_s:g}s")
            for key in sorted(waiting):
                msg = self._poll(*key)
                if msg is None:
                    continue
                if _op(msg) == "ready":
                    waiting.discard(key)
                    self._alive[key[0]].add(key[1])
                    self._m[key]["last_pong"] = time.monotonic()
                    self._note_ready(key, msg)
                elif _op(msg) == "error":
                    raise RuntimeError(
                        f"fleet {key[0]} {key[1]} failed to start: {msg[2]}")
            time.sleep(0.01)

    def __enter__(self) -> "FleetCluster":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, timeout_s: float = 60.0) -> None:
        """Graceful where possible.  Late "error" frames are COLLECTED
        (self.worker_errors), never dropped — an engine that blew up
        during shutdown still reports, and its obs export (flushed
        before the error frame by contract) stays parseable."""
        for role in POOLS:
            for wid in sorted(self._alive[role]):
                try:
                    self._send(role, wid, ("stop",))
                except TransportError:
                    self._alive[role].discard(wid)
        deadline = time.monotonic() + timeout_s
        pending = {(r, w) for r in POOLS for w in self._alive[r]}
        while pending and time.monotonic() < deadline:
            for key in sorted(pending):
                alive = self._m[key]["proc"].is_alive()
                msg = self._poll(*key)
                if msg is None:
                    if not alive:
                        pending.discard(key)
                    continue
                if _op(msg) == "stopped":
                    pending.discard(key)
                    if len(msg) > 2:
                        self.stopped[key] = dict(msg[2])
                elif _op(msg) == "error":
                    self.worker_errors.append((key, msg[2]))
            time.sleep(0.01)
        # final drain: a worker that died after sending "error" must not
        # lose the frame just because its process exited first
        for key, m in self._m.items():
            while True:
                msg = self._poll(*key)
                if msg is None:
                    break
                if _op(msg) == "error":
                    self.worker_errors.append((key, msg[2]))
        for m in self._m.values():
            if m["proc"].is_alive():
                m["proc"].terminate()
            m["proc"].join(timeout=10)
            if m["proc"].is_alive():
                m["proc"].kill()
                m["proc"].join(timeout=10)
            if isinstance(m["tr"], QueueTransport):
                m["tr"].abandon()
        for s in self._alive.values():
            s.clear()

    # -- plumbing ------------------------------------------------------

    def _poll(self, role: str, wid: int):
        m = self._m.get((role, wid))
        if m is None or m["tr"] is None:
            return None
        return m["tr"].recv()

    def _send(self, role: str, wid: int, msg) -> None:
        m = self._m.get((role, wid))
        if m is None or m["tr"] is None:
            raise TransportError(f"no transport for {role} {wid}")
        m["tr"].send(msg)

    def _kill(self, role: str, wid: int) -> None:
        proc = self._m[(role, wid)]["proc"]
        if proc.is_alive() and proc.pid:
            os.kill(proc.pid, signal.SIGKILL)
        proc.join(timeout=10)
        self._alive[role].discard(wid)

    def _journal_resume_map(self, wid: int) -> Dict[int, List[int]]:
        from ..serving.checkpoint import journal_tokens_by_ext

        try:
            return journal_tokens_by_ext(self.journal_path(wid))
        except OSError:
            return {}

    def _journal_has_progress(self, wid: int, rids) -> bool:
        from ..serving.checkpoint import journal_view

        try:
            view = journal_view(self.journal_path(wid))
        except (OSError, ValueError):
            return False
        for erid, sub in view.submits.items():
            ext = int(sub["ext"])
            toks = view.tokens.get(erid, [])
            if (ext in rids and toks and erid not in view.done
                    and len(toks) < int(sub["max_new"])):
                return True
        return False

    # -- replay --------------------------------------------------------

    def replay(self, trace: Trace, faults: Sequence[FleetFault] = (), *,
               speed: float = 25.0, max_wall_s: float = 600.0,
               backoff: Optional[RetryBackoff] = None,
               max_attempts: int = 50) -> FleetReport:
        if not any(self._alive.values()):
            raise RuntimeError("fleet not started (use .start() or the "
                               "context manager)")
        bo = backoff if backoff is not None else RetryBackoff(base_s=0.02,
                                                              cap_s=1.0)
        vocab = trace.vocab
        arrivals = sorted(trace.requests, key=lambda r: (r.t_arrival, r.rid))
        by_rid = {r.rid: r for r in trace.requests}
        outcomes = {r.rid: Outcome(rid=r.rid, kind=r.kind,
                                   t_arrival=r.t_arrival)
                    for r in trace.requests}
        terminal: set = set()
        prefill_q: deque = deque()         # (rid, resume_toks|None)
        busy: Dict[int, Optional[int]] = {w: None
                                          for w in self._alive["prefill"]}
        transfers: Dict[int, dict] = {}
        reship: List[tuple] = []           # (t_due_v, rid)
        retryq: List[tuple] = []           # (t_due_v, rid, resume_toks)
        outstanding = {w: set() for w in self._alive["decode"]}
        if self.trace_enabled:
            tracing.enable()
        trace_ctx: Dict[int, tuple] = {}   # rid -> (ctx, t_dispatch_pc)
        kills: List[dict] = []
        ledger = {"committed": 0, "aborted": 0, "reshipped": 0,
                  "digest_checked": 0, "digest_mismatch": 0, "aborts": []}
        scale_events: List[dict] = []
        restarting: Dict[Tuple[str, int], dict] = {}
        recov = {"replayed": 0, "resumed": 0}
        fault_q = sorted(faults, key=lambda f: (f.t, f.pool, f.worker))
        hb_seq = 0
        last_hb = time.monotonic()
        last_scale = time.monotonic()
        # the heartbeat window opens with the replay, as LoadGenCluster's
        # does: a member idle between start() and replay() was never
        # pinged, so it has not been silent
        for m in self._m.values():
            m["last_pong"] = last_hb
        pressure_ticks = 0
        idle_ticks: Dict[int, int] = {}
        t0 = time.perf_counter()

        def now_v() -> float:
            return (time.perf_counter() - t0) * speed

        def complete_direct(rid: int, toks: List[int], t: float) -> None:
            """The journal already covers the budget: done with zero
            engine time (router-side trim_complete)."""
            out = outcomes[rid]
            out.status = DONE
            out.tokens = [int(x) for x in toks[:by_rid[rid].max_new_tokens]]
            out.t_done = t
            terminal.add(rid)
            recov["resumed"] += len(out.tokens)

        def requeue(rid: int, toks, t: float) -> None:
            if rid in terminal:
                return
            outcomes[rid].retries += 1
            if toks and len(toks) >= by_rid[rid].max_new_tokens:
                complete_direct(rid, list(toks), t)
                return
            if toks:
                recov["resumed"] += len(toks)
            prefill_q.append((rid, list(toks) if toks else None))

        def settle(key, msg) -> None:
            role, wid = key
            op = _op(msg)
            if op == "pong":
                self._m[key]["last_pong"] = time.monotonic()
                if len(msg) > 3 and isinstance(msg[3], dict):
                    self._m[key]["stats"] = msg[3]
            elif op == "error":
                raise RuntimeError(f"fleet {role} {wid} errored: {msg[2]}")
            elif op == "prefill_failed":
                rid = int(msg["rid"])
                busy[wid] = None
                transfers.pop(rid, None)
                if rid not in terminal:
                    outcomes[rid].retries += 1
                    retryq.append((now_v()
                                   + bo.delay(rid, outcomes[rid].retries),
                                   rid, None))
            elif op == "kv_begin":
                rid = int(msg["rid"])
                transfers[rid] = {"frames": [msg], "meta": msg["meta"],
                                  "prefill": wid, "decode": None,
                                  "complete": False, "admitted": False,
                                  "attempts": 0}
                dw = self._pick_decode()
                if dw is not None:
                    transfers[rid]["decode"] = dw
                    self._forward(dw, msg)
            elif op in ("kv_page", "kv_end"):
                rid = int(msg["rid"])
                tf = transfers.get(rid)
                if tf is None:
                    return  # late frame for an already-settled transfer
                tf["frames"].append(msg)
                if op == "kv_end":
                    tf["complete"] = True
                if tf["decode"] is not None:
                    self._forward(tf["decode"], msg)
                elif op == "kv_end":
                    # born while no replica was alive (mid-restart): the
                    # buffered transfer waits in the re-ship queue
                    reship.append((now_v(), rid))
            elif op == "admitted":
                rid = int(msg["rid"])
                tf = transfers.pop(rid, None)
                if tf is None:
                    return
                ledger["committed"] += 1
                sent = tf["meta"].get("digests")
                got = msg.get("digests")
                if sent and got:
                    ledger["digest_checked"] += 1
                    if list(sent) != list(got):
                        ledger["digest_mismatch"] += 1
                pw = tf["prefill"]
                if pw in self._alive["prefill"]:
                    try:
                        self._send("prefill", pw, ("kv_ack", rid))
                    except TransportError:
                        pass  # liveness will reap; pages die with it
                    busy[pw] = None
                outstanding.setdefault(wid, set()).add(rid)
                if rid not in terminal:
                    outcomes[rid].t_submit = now_v()
                    if rid in trace_ctx:
                        # admission IS first token for the fleet: the
                        # decode replica was seeded with first_token
                        ctx, t_disp = trace_ctx[rid]
                        now_pc = time.perf_counter()
                        tracing.marker(ctx, "fleet.first_token", now_pc)
                        obs.histogram(
                            "fleet.ttft_s",
                            "router dispatch -> admitted latency"
                        ).observe(now_pc - t_disp)
                        tracing.note_ttft(ctx, now_pc - t_disp,
                                          metric="fleet.ttft_s")
            elif op == "admit_reject":
                rid = int(msg["rid"])
                st = msg.get("stats") or {}
                ledger["aborted"] += 1
                ledger["aborts"].append(
                    {"rid": rid, "kind": "reject", "decode": wid,
                     "staged_after": st.get("staged"),
                     "avail_after": st.get("avail"),
                     "message": msg.get("message", "")})
                tf = transfers.get(rid)
                if tf is not None:
                    tf["decode"] = None
                    tf["attempts"] += 1
                    if tf["attempts"] > max_attempts:
                        raise RuntimeError(
                            f"transfer rid {rid} rejected "
                            f"{tf['attempts']} times: {msg.get('message')}")
                    reship.append((now_v() + bo.delay(rid, tf["attempts"]),
                                   rid))
            elif op == "abort_ok":
                st = msg.get("stats") or {}
                ledger["aborts"].append(
                    {"rid": int(msg["rid"]), "kind": "abort", "decode": wid,
                     "staged_after": st.get("staged"),
                     "avail_after": st.get("avail")})
            elif op == "done":
                rid = int(msg["rid"])
                outstanding.get(wid, set()).discard(rid)
                if isinstance(msg, dict) and isinstance(msg.get("stats"),
                                                        dict):
                    self._m[key]["stats"] = msg["stats"]
                if rid in terminal:
                    return  # late duplicate after a reroute race
                out = outcomes[rid]
                out.status = DONE
                out.tokens = [int(t) for t in msg["tokens"]]
                out.t_done = now_v()
                terminal.add(rid)
                tci = trace_ctx.pop(rid, None)
                if tci is not None:
                    ctx, t_disp = tci
                    tracing.record_span(ctx, "fleet.request", t_disp,
                                        time.perf_counter(), root=True,
                                        rid=rid)
            # "ready"/"restored"/"stopped" are lifecycle chatter handled
            # by start()/restart/scale paths

        def reap_prefill(wid: int, t: float, detected: str,
                         note: str = "") -> None:
            while True:
                msg = self._poll("prefill", wid)
                if msg is None:
                    break
                settle(("prefill", wid), msg)
            rid = busy.get(wid)
            rerouted = []
            if rid is not None and rid not in terminal:
                tf = transfers.get(rid)
                if tf is not None and not tf["complete"]:
                    # half-shipped: abort the receiver's staging (zero
                    # pages leak — abort_ok's gauges prove it) and re-run
                    # prefill on a sibling
                    if tf["decode"] is not None \
                            and tf["decode"] in self._alive["decode"]:
                        try:
                            self._send("decode", tf["decode"],
                                       {"op": "kv_abort", "rid": rid})
                        except TransportError:
                            pass  # receiver dying too; its reap covers it
                    del transfers[rid]
                    requeue(rid, None, t)
                    rerouted.append(rid)
                elif tf is not None:
                    # fully buffered: the transfer outlives its sender
                    if tf["decode"] is None:
                        reship.append((t, rid))
                else:
                    requeue(rid, None, t)
                    rerouted.append(rid)
            busy.pop(wid, None)
            kills.append({"t": t, "pool": "prefill", "worker": wid,
                          "rerouted": rerouted, "detected_by": detected,
                          "note": note})

        def reap_decode(wid: int, t: float, detected: str,
                        note: str = "") -> None:
            while True:
                msg = self._poll("decode", wid)
                if msg is None:
                    break
                settle(("decode", wid), msg)
            orphans = sorted(outstanding.get(wid, set()) - terminal)
            outstanding.pop(wid, None)
            # un-admitted transfers aimed at the dead replica re-ship to
            # a sibling from the router's buffer — no prefill re-run
            for rid, tf in transfers.items():
                if tf["decode"] == wid and not tf["admitted"]:
                    tf["decode"] = None
                    tf["attempts"] += 1
                    reship.append((t, rid))
            resume_map = self._journal_resume_map(wid)
            kills.append({"t": t, "pool": "decode", "worker": wid,
                          "rerouted": orphans, "detected_by": detected,
                          "note": note})
            for rid in orphans:
                requeue(rid, resume_map.get(rid) or None, t)

        def fire_restart(ev: FleetFault, t: float) -> None:
            key = (ev.pool, ev.worker)
            self._kill(*key)
            while True:
                msg = self._poll(*key)
                if msg is None:
                    break
                settle(key, msg)
            resume_map = {}
            orphans: List[int] = []
            if ev.pool == "decode":
                # read the dead life's journal BEFORE the replacement
                # rewrites it: unclaimed orphans resume from this map
                resume_map = self._journal_resume_map(ev.worker)
                orphans = sorted(outstanding.get(ev.worker, set())
                                 - terminal)
                outstanding.pop(ev.worker, None)
                for rid, tf in transfers.items():
                    if tf["decode"] == ev.worker and not tf["admitted"]:
                        tf["decode"] = None
                        tf["attempts"] += 1
                        reship.append((t, rid))
            else:
                rid = busy.get(ev.worker)
                if rid is not None and rid not in terminal:
                    tf = transfers.get(rid)
                    if tf is not None and not tf["complete"]:
                        if tf["decode"] is not None:
                            try:
                                self._send("decode", tf["decode"],
                                           {"op": "kv_abort", "rid": rid})
                            except TransportError:
                                pass  # receiver reap covers it
                        transfers.pop(rid, None)
                        requeue(rid, None, t)
                        orphans.append(rid)
                busy.pop(ev.worker, None)
            self._spawn(ev.pool, ev.worker, restore=True)
            restarting[key] = {
                "deadline": time.monotonic() + self.restart_timeout_s,
                "orphans": orphans, "resume_map": resume_map, "t": t,
                "note": ev.note, "restored": None, "ready": False,
            }

        def poll_restarting(t: float) -> None:
            for key in sorted(restarting):
                st = restarting[key]
                while True:
                    msg = self._poll(*key)
                    if msg is None:
                        break
                    if _op(msg) == "restored":
                        st["restored"] = msg[2]
                    elif _op(msg) == "ready":
                        st["ready"] = True
                        self._note_ready(key, msg)
                    else:
                        settle(key, msg)  # journal-complete dones
                if st["ready"]:
                    role, wid = key
                    info = st["restored"] or {}
                    recov["replayed"] += sum(
                        int(v) for v in (info.get("replayed") or {}).values())
                    recov["resumed"] += sum(
                        int(v) for v in (info.get("resumed") or {}).values())
                    claimed = {int(r) for r in info.get("claimed", [])}
                    self._alive[role].add(wid)
                    self._m[key]["last_pong"] = time.monotonic()
                    if role == "decode":
                        outstanding.setdefault(wid, set())
                        for rid in sorted(claimed):
                            if rid not in terminal:
                                outstanding[wid].add(rid)
                    else:
                        busy[wid] = None
                    kills.append({"t": st["t"], "pool": role, "worker": wid,
                                  "rerouted": sorted(st["orphans"]),
                                  "restarted": True,
                                  "detected_by": "scheduled-restart",
                                  "note": st["note"]})
                    for rid in sorted(set(st["orphans"]) - claimed):
                        requeue(rid, st["resume_map"].get(rid) or None, t)
                    del restarting[key]
                elif time.monotonic() > st["deadline"]:
                    raise RuntimeError(
                        f"restarted {key[0]} {key[1]} not ready within "
                        f"{self.restart_timeout_s:g}s")

        i = 0
        while len(terminal) < len(outcomes):
            t = now_v()
            # 1) due faults
            while fault_q and fault_q[0].t <= t:
                ev = fault_q[0]
                key = (ev.pool, ev.worker)
                if ev.worker not in self._alive[ev.pool] \
                        and key not in restarting:
                    fault_q.pop(0)
                    continue
                if key in restarting:
                    break
                if ev.kind in ("kill", "restart"):
                    while True:
                        msg = self._poll(*key)
                        if msg is None:
                            break
                        settle(key, msg)
                    work_possible = (i < len(arrivals) or bool(retryq)
                                     or bool(prefill_q) or bool(reship))
                    if ev.pool == "decode":
                        rids = outstanding.get(ev.worker, set())
                        armed = bool(rids) and self._journal_has_progress(
                            ev.worker, rids)
                    else:
                        armed = busy.get(ev.worker) is not None
                    if not armed and work_possible:
                        break
                    fault_q.pop(0)
                    if ev.kind == "restart":
                        fire_restart(ev, t)
                    else:
                        self._kill(*key)
                        if ev.pool == "prefill":
                            reap_prefill(ev.worker, t, "scheduled-kill",
                                         ev.note)
                        else:
                            reap_decode(ev.worker, t, "scheduled-kill",
                                        ev.note)
                else:
                    fault_q.pop(0)
                    try:
                        self._send(ev.pool, ev.worker,
                                   ("fault", ev.kind, ev.arg))
                    except TransportError:
                        pass  # dying member; liveness reap covers it
            # 2) unscheduled deaths
            for role, reaper in (("prefill", reap_prefill),
                                 ("decode", reap_decode)):
                for wid in sorted(self._alive[role]):
                    if not self._m[(role, wid)]["proc"].is_alive():
                        self._alive[role].discard(wid)
                        reaper(wid, t, "liveness")
            if restarting:
                poll_restarting(t)
            # 2c) heartbeat detector, both pools
            now_w = time.monotonic()
            if now_w - last_hb >= self.hb_interval_s:
                last_hb = now_w
                hb_seq += 1
                for role in POOLS:
                    for wid in sorted(self._alive[role]):
                        try:
                            self._send(role, wid, ("ping", hb_seq))
                        except TransportError:
                            pass  # dead member; liveness reap covers it
                for role, reaper in (("prefill", reap_prefill),
                                     ("decode", reap_decode)):
                    for wid in sorted(self._alive[role]):
                        if now_w - self._m[(role, wid)]["last_pong"] \
                                > self.hb_timeout_s:
                            self._kill(role, wid)
                            reaper(wid, t, "heartbeat")
            # 3) arrivals, retries, dispatch, re-ships
            while i < len(arrivals) and arrivals[i].t_arrival <= t:
                prefill_q.append((arrivals[i].rid, None))
                i += 1
            if retryq:
                retryq.sort()
                while retryq and retryq[0][0] <= t:
                    _, rid, toks = retryq.pop(0)
                    if rid not in terminal:
                        prefill_q.append((rid, toks))
            for wid in sorted(self._alive["prefill"]):
                if busy.get(wid) is None and prefill_q:
                    rid, toks = prefill_q.popleft()
                    if rid in terminal:
                        continue
                    req = by_rid[rid]
                    ctx = None
                    if tracing.enabled():
                        # retries reuse the first dispatch's context, so a
                        # rerouted request stays one tree
                        if rid in trace_ctx:
                            ctx = trace_ctx[rid][0]
                        else:
                            ctx = tracing.start_request(rid, prefix="fleet")
                            trace_ctx[rid] = (ctx, time.perf_counter())
                    msg = _dispatch_msg(
                        rid, [int(x) for x in req.prompt(vocab)],
                        req.max_new_tokens, resume=toks,
                        trace_wire=ctx.to_wire() if ctx else None)
                    try:
                        self._send("prefill", wid, msg)
                        busy[wid] = rid
                    except TransportError:
                        prefill_q.appendleft((rid, toks))
                        break
            if reship:
                reship.sort()
                still = []
                for due, rid in reship:
                    tf = transfers.get(rid)
                    if tf is None or rid in terminal:
                        continue
                    if due > t or not tf["complete"]:
                        still.append((due, rid))
                        continue
                    dw = self._pick_decode()
                    if dw is None:
                        still.append((due, rid))
                        continue
                    tf["decode"] = dw
                    ledger["reshipped"] += 1
                    M_RESHIPS.inc()
                    for fr in tf["frames"]:
                        self._forward(dw, fr)
                reship[:] = still
            # 4) member results
            idle = True
            for role in POOLS:
                for wid in sorted(self._alive[role]):
                    while True:
                        msg = self._poll(role, wid)
                        if msg is None:
                            break
                        idle = False
                        settle((role, wid), msg)
            # 5) load gauges + autoscale
            depth = len(prefill_q) + len(retryq) + len(reship)
            occ = sum(int(self._m[("decode", w)]["stats"].get("occ", 0))
                      for w in self._alive["decode"])
            G_QUEUE_DEPTH.set(depth)
            G_DECODE_OCC.set(occ)
            if self.autoscale \
                    and now_w - last_scale >= self.scale_check_interval_s:
                last_scale = now_w
                # capacity inside the policy = serving replicas + ones
                # still booting: a scale-up that hasn't reported ready
                # yet must count, or sustained pressure during its
                # (slow) boot spawns an unbounded pile past max_decode
                decision, pressure_ticks, idle_ticks = \
                    self._autoscale_decide(
                        depth=depth, outstanding=outstanding,
                        transfers=transfers, restarting=restarting,
                        pressure_ticks=pressure_ticks,
                        idle_ticks=idle_ticks)
                if decision.up:
                    wid = self._next_decode_wid
                    self._next_decode_wid += 1
                    self._spawn("decode", wid)
                    restarting[("decode", wid)] = {
                        "deadline": time.monotonic()
                        + self.restart_timeout_s,
                        "orphans": [], "resume_map": {}, "t": t,
                        "note": "scale-up", "restored": None,
                        "ready": False,
                    }
                    scale_events.append({"t": t, "action": "up",
                                         "worker": wid})
                    M_SCALE_UPS.inc()
                if decision.down is not None:
                    wid = decision.down
                    self._alive["decode"].discard(wid)
                    try:
                        self._send("decode", wid, ("stop",))
                    except TransportError:
                        pass  # already gone; terminate below anyway
                    self._m[("decode", wid)]["proc"].join(timeout=30)
                    if self._m[("decode", wid)]["proc"].is_alive():
                        self._m[("decode", wid)]["proc"].terminate()
                    scale_events.append({"t": t, "action": "down",
                                         "worker": wid})
                    M_SCALE_DOWNS.inc()
            if idle:
                time.sleep(0.002)
            if time.perf_counter() - t0 > max_wall_s:
                raise RuntimeError(
                    f"fleet replay exceeded max_wall_s={max_wall_s:g}: "
                    f"{len(terminal)}/{len(outcomes)} terminal, "
                    f"{i}/{len(arrivals)} arrived, depth={depth}, "
                    f"transfers={sorted(transfers)}, "
                    f"alive={[sorted(self._alive[r]) for r in POOLS]}, "
                    f"restarting={sorted(restarting)}")
        while restarting:
            poll_restarting(now_v())
            if restarting:
                time.sleep(0.01)
        if self.trace_enabled:
            # the router's own spans (fleet.request roots, first_token
            # markers) join the workers' in --merge; exported only when
            # tracing so untraced runs keep their historical process set
            rpath = os.path.join(self.out_dir, "obs_router.jsonl")
            _export(rpath, 1000, kernels=False)
            if rpath not in self._obs_files:
                self._obs_files.append(rpath)
        return FleetReport(
            outcomes=outcomes, wall_s=time.perf_counter() - t0, speed=speed,
            kills=kills, transfers=ledger, scale_events=scale_events,
            obs_paths=self.obs_paths,
            recovered_tokens_replayed=recov["replayed"],
            recovered_tokens_resumed=recov["resumed"])

    def _decode_view(self, *, slots_free_default: int = 1,
                     quiet_for=None) -> fleet_policy.FleetView:
        """Snapshot the decode pool's admission gauges as the concrete
        `FleetState` the pure policies read.  `quiet_for` (outstanding
        map + live transfers) switches on the autoscale observation:
        missing gauges then default BUSY (occ/staged -> 1, slots_free ->
        0) exactly like the pre-refactor inline block, so a replica that
        has never ponged can be neither retired nor counted free."""
        reps = []
        for w in sorted(self._alive["decode"]):
            st = self._m[("decode", w)]["stats"]
            quiet = False
            if quiet_for is not None:
                outstanding, transfers = quiet_for
                quiet = (int(st.get("occ", 1)) == 0
                         and int(st.get("staged", 1)) == 0
                         and not outstanding.get(w)
                         and not any(tf["decode"] == w
                                     for tf in transfers.values()))
            reps.append(fleet_policy.ReplicaView(
                wid=w, occ=int(st.get("occ", 0)),
                staged=int(st.get("staged", 0)),
                slots_free=int(st.get("slots_free", slots_free_default)),
                quiet=quiet))
        return fleet_policy.FleetView(replicas=tuple(reps))

    def _pick_decode(self) -> Optional[int]:
        """Load-aware choice, delegated to the pure routing policy
        (fleet/policy.py) the simulator executes too — fewest live+staged
        sequences, preferring replicas that report a free slot (the
        admission gauges ride every pong/done/admitted message)."""
        route = getattr(fleet_policy,
                        fleet_policy.ROUTE_POLICY_FUNCS[self.router_policy])
        return route(self._decode_view(), None)

    def _autoscale_decide(self, *, depth: int, outstanding, transfers,
                          restarting, pressure_ticks: int, idle_ticks):
        """Observation here, decision in fleet/policy.autoscale — the
        same pure function the simulator sweeps lead times with."""
        view = self._decode_view(
            slots_free_default=0, quiet_for=(outstanding, transfers))
        view = view._replace(
            queue_depth=depth,
            wait_for_decode=depth + sum(
                1 for tf in transfers.values() if tf["decode"] is None),
            booting=sum(1 for (role, _w) in restarting if role == "decode"))
        params = fleet_policy.ScaleParams(
            scale_up_after=self.scale_up_after,
            scale_down_after=self.scale_down_after,
            max_decode=self.max_decode, min_decode=self.min_decode)
        return fleet_policy.autoscale(view, params, pressure_ticks,
                                      idle_ticks)

    def _forward(self, decode_wid: int, frame) -> None:
        try:
            self._send("decode", decode_wid, frame)
        except TransportError:
            pass  # dead receiver: reap re-ships the buffered transfer

    def merged(self, by_process: bool = False):
        """Per-member obs exports folded into one job view
        (obs --merge semantics, torn tails tolerated)."""
        from ..obs.aggregate import merge_files

        present = [p for p in self.obs_paths if os.path.exists(p)]
        if not present:
            raise FileNotFoundError(
                f"no fleet obs exports under {self.out_dir!r} yet")
        return merge_files(present, by_process=by_process)
