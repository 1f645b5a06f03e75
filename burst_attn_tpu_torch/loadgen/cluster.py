"""Multi-process serve cluster: router, fault schedule, recovery proof
(port of burst_attn_tpu/loadgen/cluster.py).

N worker processes (loadgen/worker.py — each its own spawned interpreter
with its own CUDA context, on the card unless the model spec says
`"device": "cpu"`, and its own obs registry) behind one in-process
router.  The router replays a Trace open-loop: arrivals
route to the least-loaded alive worker, retryable sheds back off
(seeded exponential + jitter, driver.RetryBackoff) and re-route, and a
FAULT SCHEDULE injects failures at virtual times:

  kill     SIGKILL the worker process (no cooperation, no cleanup — the
           real failure mode).  The router reroutes every rid the dead
           worker still owed to surviving workers.  Without
           checkpointing, greedy decode regenerates each rerouted
           request's tokens EXACTLY from scratch; with
           `checkpoint=True` the reroute carries the dead worker's
           journaled token prefix, so the receiving worker RESUMES
           (prompt+prefix prefill, budget reduced) instead of replaying
           — either way `assert_token_exact` gates against the
           single-process oracle.
  hog      force pool exhaustion inside the worker (pages acquired out
           from under admission) — sheds/deferrals must kick in, and
           `unhog` must let the backlog drain (bounded recovery).
  stall    freeze the worker's engine loop for S seconds (delayed-retire
           / GC-pause stand-in); queued work must survive untouched —
           and the worker still drains its queue, so heartbeat pings are
           answered: a stall must NOT trip the failure detector.
  hang     wedge the worker's WHOLE loop (no stepping, no queue drain,
           no pong) while the process stays alive — invisible to the
           liveness poll, detectable only by the heartbeat detector.
  restart  (requires `checkpoint=True`) SIGKILL the worker, then spawn a
           REPLACEMENT for the same wid that restores from the dead
           life's snapshot + journal (`recover_engine`) and finishes its
           claimed requests itself; orphans the replacement does not
           claim are rerouted from scratch.

Failure detection is two-layered: a passive liveness poll (a dead
process is reaped next tick) and an active HEARTBEAT detector — the
router pings every alive worker each `hb_interval_s` wall seconds, and a
worker silent for `hb_timeout_s` is declared dead (SIGKILL + reap,
`detected_by: "heartbeat"`), which is what catches hangs and wedges that
never exit.  hb_timeout_s defaults generous: a worker's first call of a
width (the kernel library's load, cuBLAS handles) blocks its queue
drain, and that must not read as death.  Workers warm before "ready"
and report their boot seconds (`boot_s`).

Wire-safety note: router<->worker messages travel as CRC-framed
transport frames (fleet/transport.py, QueueTransport over the spawn
queues — the identical protocol the socket fleet ships cross-host), so
every delivered message is integrity-checked, and the frames stay small
(a done record for a canary request is well under PIPE_BUF = 4096
bytes; resume prefixes are bounded by max_new_tokens) so kernel pipe
writes are atomic and a SIGKILL cannot tear a frame mid-message; each
worker also gets its OWN result queue so a dead worker's stream never
interleaves with a live one's.  Torn-write hazards that DO exist — a
kill mid `export_jsonl` or mid journal append — land in files whose
readers (`obs.aggregate.load_records_tolerant`,
`checkpoint.read_journal`) are torn-tail tolerant by contract.

Every worker exports obs JSONL snapshots (`obs_w{wid}.jsonl`; restart
replacements get generation-suffixed files so a dead life's last export
survives the merge), all tagged process_index=wid; `merged()` folds them
into the one job-level view (`obs --merge` semantics) that
loadgen/slo.py evaluates; each export carries the worker's kernel
launches (`kernel.launches{kernel=...}`), and a clean stop reports them
in the "stopped" frame with its pool's free pages (`stopped`).
"""

import multiprocessing as mp
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..fleet.transport import QueueTransport, TransportError
from .driver import DONE, REJECTED, SHED, Outcome, ReplayReport, RetryBackoff
from .trace import Trace
from .worker import worker_main

FAULT_KINDS = ("kill", "hog", "unhog", "stall", "hang", "restart",
               "raise")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: at virtual time `t`, do `kind` to `worker`.

    `kill`/`restart` wait until the target holds at least one in-flight
    request (a kill that lands on an idle worker proves nothing about
    recovery) — and, with checkpointing enabled, until the target's
    journal shows at least one generated token for it (a kill before any
    token is durable proves nothing about RESUME-vs-replay); if the
    trace drains first, they fire anyway so the schedule always
    executes.  `arg`: pages to hog / stall seconds."""

    t: float
    kind: str
    worker: int
    arg: float = 0.0
    note: str = ""

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {FAULT_KINDS})")


def random_fault_schedule(seed: int, *, n_workers: int, t_max: float,
                          kinds: Sequence[str] = ("kill",),
                          n_events: int = 1,
                          arg: float = 0.0) -> List[FaultEvent]:
    """Deterministic random fault schedule for fuzzing: `n_events` faults
    drawn from `kinds` at uniform times in [0, t_max) on uniform workers.
    Same seed -> same schedule (numpy seed-sequence)."""
    rng = np.random.default_rng(int(seed))
    events = []
    for j in range(n_events):
        events.append(FaultEvent(
            t=float(rng.uniform(0.0, t_max)),
            kind=str(kinds[int(rng.integers(len(kinds)))]),
            worker=int(rng.integers(n_workers)), arg=arg,
            note=f"fuzz seed={seed} event={j}"))
    return sorted(events, key=lambda f: (f.t, f.worker))


@dataclass
class ClusterReport(ReplayReport):
    """ReplayReport plus the fault/recovery evidence the tests gate on:
    each kill records WHO died, HOW the death was detected
    (`detected_by`: liveness | heartbeat | scheduled fault), WHAT was
    rerouted or reclaimed, and the virtual time by which every such
    request completed.  `recovered_tokens_replayed` /
    `recovered_tokens_resumed` are the router-side recovery ledger
    (mirroring the workers' serve.recovered_tokens_* counters): tokens
    recoveries re-decoded vs tokens carried over without re-decoding —
    the acceptance gate asserts replayed(resume on) <
    replayed(resume off) on the same trace + fault schedule."""

    kills: List[dict] = field(default_factory=list)
    obs_paths: List[str] = field(default_factory=list)
    recovered_tokens_replayed: int = 0
    recovered_tokens_resumed: int = 0

    def recovery_s(self) -> List[float]:
        """Per-fault recovery spans (virtual): last rerouted/reclaimed
        completion minus fault time; faults that orphaned nothing
        contribute 0."""
        out = []
        for k in self.kills:
            ts = [self.outcomes[rid].t_done for rid in k["rerouted"]
                  if self.outcomes[rid].t_done is not None]
            out.append(max(ts) - k["t"] if ts else 0.0)
        return out


class LoadGenCluster:
    """Spawn, replay, stop.  Use as a context manager — __exit__ always
    reaps worker processes, even when replay raised.

    `checkpoint=True` turns on the crash-consistency layer
    (serving/checkpoint.py): every worker runs with a write-ahead token
    journal and snapshots its engine every `checkpoint_every`
    completions; reroutes then RESUME from the dead worker's journal
    (`resume=False` keeps journaling but replays rerouted requests from
    scratch — the accounting baseline), and the `restart` fault kind
    becomes available."""

    def __init__(self, model_spec: dict, engine_spec: dict, *,
                 n_workers: int, out_dir: str, export_every: int = 4,
                 start_timeout_s: float = 180.0, checkpoint: bool = False,
                 resume: bool = True, checkpoint_every: int = 2,
                 hb_interval_s: float = 0.5, hb_timeout_s: float = 60.0,
                 restart_timeout_s: float = 180.0):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        self.model_spec = dict(model_spec)
        self.engine_spec = dict(engine_spec)
        self.n_workers = n_workers
        self.out_dir = out_dir
        self.export_every = export_every
        self.start_timeout_s = start_timeout_s
        self.checkpoint = checkpoint
        self.resume = resume
        self.checkpoint_every = checkpoint_every
        self.hb_interval_s = hb_interval_s
        self.hb_timeout_s = hb_timeout_s
        self.restart_timeout_s = restart_timeout_s
        self._ctx = mp.get_context("spawn")
        self._procs: Dict[int, mp.Process] = {}
        self._req_q: Dict[int, object] = {}
        self._res_q: Dict[int, object] = {}
        self._tr: Dict[int, QueueTransport] = {}
        self._alive: set = set()
        self.worker_errors: List[tuple] = []   # (wid, message) from stop()
        self._gen: Dict[int, int] = {}       # wid -> restart generation
        self._obs_files: List[str] = []
        self._t_spawn: Dict[int, float] = {}
        # one record a worker life: {"worker", "gen", "s" (spawn to ready,
        # parent clock), and the child's phases: import_s, build_s, warm_s,
        # restore_s, total_s}
        self.boot_s: List[dict] = []
        # wid -> the "stopped" frame's info: kernel launches, free and
        # usable pool pages (equal: nothing leaked)
        self.stopped: Dict[int, dict] = {}

    # -- lifecycle ---------------------------------------------------------

    def obs_path(self, wid: int) -> str:
        """Current-generation obs export path for `wid` (restart
        replacements write their own file so the dead life's export
        survives the merge)."""
        gen = self._gen.get(wid, 0)
        suffix = f"g{gen}" if gen else ""
        return os.path.join(self.out_dir, f"obs_w{wid}{suffix}.jsonl")

    def journal_path(self, wid: int) -> str:
        return os.path.join(self.out_dir, f"journal_w{wid}.jsonl")

    def snapshot_path(self, wid: int) -> str:
        return os.path.join(self.out_dir, f"ckpt_w{wid}.npz")

    @property
    def obs_paths(self) -> List[str]:
        """Every obs export path any worker life has written to."""
        return list(self._obs_files)

    def _spawn(self, wid: int, restore: bool = False) -> None:
        """Start (or, with restore=True, re-start from checkpoint) one
        worker process with fresh queues — stale submits in a dead
        worker's request queue must not replay into its replacement."""
        if restore:
            self._gen[wid] = self._gen.get(wid, 0) + 1
        path = self.obs_path(wid)
        if not restore:
            for stale in (path, self.journal_path(wid),
                          self.snapshot_path(wid)):
                if os.path.exists(stale):
                    os.remove(stale)  # stale state would pollute recovery
        if path not in self._obs_files:
            self._obs_files.append(path)
        ckpt_spec = None
        if self.checkpoint:
            ckpt_spec = {"journal": self.journal_path(wid),
                         "snapshot": self.snapshot_path(wid),
                         "every": self.checkpoint_every,
                         "resume": self.resume, "restore": restore}
        if wid in self._tr:  # a dead life's queues: never read again
            self._tr[wid].abandon()
        self._req_q[wid] = self._ctx.Queue()
        self._res_q[wid] = self._ctx.Queue()
        self._tr[wid] = QueueTransport(send_q=self._req_q[wid],
                                       recv_q=self._res_q[wid])
        proc = self._ctx.Process(
            target=worker_main,
            args=(wid, self.model_spec, self.engine_spec, path,
                  self._req_q[wid], self._res_q[wid], self.export_every,
                  ckpt_spec),
            daemon=True, name=f"loadgen-worker-{wid}")
        self._t_spawn[wid] = time.monotonic()
        proc.start()
        self._procs[wid] = proc

    def _note_ready(self, wid: int, msg) -> None:
        rec = {"worker": wid, "gen": self._gen.get(wid, 0),
               "s": time.monotonic() - self._t_spawn[wid]}
        if len(msg) > 3 and isinstance(msg[3], dict):
            rec.update(msg[3])
        self.boot_s.append(rec)

    def start(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        for wid in range(self.n_workers):
            self._spawn(wid)
        deadline = time.monotonic() + self.start_timeout_s
        waiting = set(range(self.n_workers))
        while waiting:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"workers {sorted(waiting)} not ready within "
                    f"{self.start_timeout_s:g}s")
            for wid in sorted(waiting):
                msg = self._poll(wid)
                if msg is None:
                    continue
                if msg[0] == "ready":
                    waiting.discard(wid)
                    self._alive.add(wid)
                    self._note_ready(wid, msg)
                elif msg[0] == "error":
                    raise RuntimeError(f"worker {wid} failed to start: "
                                       f"{msg[2]}")
            time.sleep(0.01)

    def __enter__(self) -> "LoadGenCluster":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, timeout_s: float = 60.0) -> None:
        """Graceful where possible (workers flush a final obs export),
        SIGKILL where not.  Idempotent."""
        for wid in sorted(self._alive):
            try:
                self._send(wid, ("stop",))
            except TransportError:
                self._alive.discard(wid)
        deadline = time.monotonic() + timeout_s
        pending = set(self._alive)
        while pending and time.monotonic() < deadline:
            for wid in sorted(pending):
                alive = self._procs[wid].is_alive()
                msg = self._poll(wid)
                if msg is None:
                    if not alive:
                        pending.discard(wid)
                    continue
                if msg[0] == "stopped":
                    pending.discard(wid)
                    if len(msg) > 2:
                        self.stopped[wid] = dict(msg[2])
                elif msg[0] == "error":
                    # a worker erroring DURING stop still reports — its
                    # error frame is evidence, not noise (satellite: the
                    # old loop dropped these on the floor)
                    self.worker_errors.append((wid, msg[2]))
            time.sleep(0.01)
        # final drain: a worker that flushed its error frame and died
        # before we polled must not lose it to the terminate below
        for wid in sorted(self._tr):
            while True:
                msg = self._poll(wid)
                if msg is None:
                    break
                if msg[0] == "error":
                    self.worker_errors.append((wid, msg[2]))
        for wid, proc in self._procs.items():
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        for tr in self._tr.values():
            tr.abandon()
        self._alive.clear()

    # -- plumbing ----------------------------------------------------------

    def _poll(self, wid: int):
        return self._tr[wid].recv()

    def _send(self, wid: int, msg) -> None:
        self._tr[wid].send(msg)

    def inject_fault(self, wid: int, kind: str, arg: float = 0.0) -> None:
        """Send one fault message outside a replay schedule (tests use
        this to provoke shutdown races, e.g. kind="raise" then stop())."""
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self._send(wid, ("fault", kind, arg))

    def _kill(self, wid: int) -> None:
        proc = self._procs[wid]
        if proc.is_alive() and proc.pid:
            os.kill(proc.pid, signal.SIGKILL)
        proc.join(timeout=10)
        self._alive.discard(wid)

    def _journal_resume_map(self, wid: int) -> Dict[int, List[int]]:
        """router rid -> journaled tokens from a DEAD worker's journal.
        OSError (no journal yet — killed before the first sync) is an
        empty map; a corrupt non-final line stays loud (ValueError)."""
        from ..serving.checkpoint import journal_tokens_by_ext

        try:
            return journal_tokens_by_ext(self.journal_path(wid))
        except OSError:
            return {}

    def _journal_has_progress(self, wid: int, rids) -> bool:
        """True when the LIVE worker's journal holds >= 1 token for one
        of `rids` that the journal does NOT already prove complete (read
        tolerantly: the worker may be mid-append; an unreadable/torn
        journal just means 'not yet').  The completeness check matters
        for arming kills: the journal is fsynced AHEAD of the done
        message (step() syncs before delivering), so a rid with tokens
        but no done record is guaranteed still mid-decode at file-read
        time — arming on it kills genuinely in-flight work, never a
        request whose done is merely still in the result queue."""
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

    # -- replay ------------------------------------------------------------

    def replay(self, trace: Trace, faults: Sequence[FaultEvent] = (), *,
               speed: float = 25.0, retry_backoff_s: float = 0.1,
               max_retries: int = 500, max_wall_s: float = 240.0,
               backoff: Optional[RetryBackoff] = None) -> ClusterReport:
        """Replay `trace` through the cluster with `faults` injected at
        their virtual times.  Returns when every trace request reached a
        terminal outcome (done / rejected / shed) — including requests
        rerouted off killed workers and requests reclaimed by restarted
        replacements."""
        if not self._alive:
            raise RuntimeError("cluster not started (use .start() or the "
                               "context manager)")
        if any(f.kind == "restart" for f in faults) and not self.checkpoint:
            raise ValueError("the 'restart' fault requires checkpoint=True "
                             "(a replacement can only restore from a "
                             "checkpoint+journal)")
        bo = backoff if backoff is not None else RetryBackoff(
            base_s=retry_backoff_s,
            cap_s=max(retry_backoff_s * 40, 2.0))
        vocab = trace.vocab
        arrivals = sorted(trace.requests, key=lambda r: (r.t_arrival, r.rid))
        by_rid = {r.rid: r for r in trace.requests}
        outcomes = {r.rid: Outcome(rid=r.rid, kind=r.kind,
                                   t_arrival=r.t_arrival)
                    for r in trace.requests}
        retry: List[tuple] = []            # (t_due_v, rid)
        deferred: List[tuple] = []         # (rid, resume_toks|None): no
        #                                    capacity right now (restarting)
        owner: Dict[int, int] = {}         # rid -> wid while in flight
        outstanding = {wid: set() for wid in range(self.n_workers)}
        terminal: set = set()
        fault_q = sorted(faults, key=lambda f: (f.t, f.worker))
        kills: List[dict] = []
        restarting: Dict[int, dict] = {}   # wid -> pending-replacement state
        recov = {"replayed": 0, "resumed": 0}
        last_pong = {wid: time.monotonic() for wid in self._alive}
        hb_seq = 0
        last_hb = time.monotonic()
        t0 = time.perf_counter()

        def now_v() -> float:
            return (time.perf_counter() - t0) * speed

        def route(rid: int, t: float, rerouting: bool = False,
                  resume_toks: Optional[List[int]] = None) -> bool:
            """Send rid to the least-loaded alive worker; False when no
            worker can take it RIGHT NOW (all capacity is mid-restart —
            the caller defers and retries next tick)."""
            if not self._alive:
                if restarting:
                    return False
                raise RuntimeError(
                    f"no workers alive to take rid {rid} "
                    f"({len(terminal)}/{len(outcomes)} terminal)")
            req = by_rid[rid]
            wid = min(self._alive,
                      key=lambda w: (len(outstanding[w]), w))
            owner[rid] = wid
            outstanding[wid].add(rid)
            if rerouting:
                outcomes[rid].retries += 1
            msg = ("submit", rid, [int(x) for x in req.prompt(vocab)],
                   req.max_new_tokens)
            if resume_toks:
                msg = msg + ([int(x) for x in resume_toks],)
            self._send(wid, msg)
            return True

        def settle(msg) -> None:
            op = msg[0]
            if op == "accepted":
                _, wid, rid = msg
                if rid not in terminal:
                    outcomes[rid].t_submit = now_v()
            elif op == "done":
                _, wid, rid, toks = msg
                outstanding.get(wid, set()).discard(rid)
                owner.pop(rid, None)
                if rid in terminal:
                    return  # late duplicate after a reroute race
                out = outcomes[rid]
                out.status = DONE
                out.tokens = [int(t) for t in toks]
                out.t_done = now_v()
                terminal.add(rid)
            elif op == "rejected":
                _, wid, rid, reason, retryable, _message = msg
                outstanding.get(wid, set()).discard(rid)
                owner.pop(rid, None)
                if rid in terminal:
                    return
                out = outcomes[rid]
                if retryable and out.retries < max_retries:
                    out.retries += 1
                    retry.append((now_v() + bo.delay(rid, out.retries), rid))
                else:
                    out.status = SHED if retryable else REJECTED
                    out.reason = reason
                    terminal.add(rid)
            elif op == "pong":
                last_pong[msg[1]] = time.monotonic()
            elif op == "error":
                raise RuntimeError(f"worker {msg[1]} errored: {msg[2]}")
            # "ready"/"restored"/"stopped" are lifecycle chatter — the
            # start()/restart paths consume them; ignored here

        def reap(wid: int, t: float, scheduled: Optional[FaultEvent],
                 detected: str = "liveness") -> None:
            """A worker is gone (scheduled kill, crash, or heartbeat
            verdict): drain what it already delivered, then reroute
            everything it still owed — with its journaled token prefixes
            when checkpointing, so receivers resume instead of replay."""
            while True:
                msg = self._poll(wid)
                if msg is None:
                    break
                settle(msg)
            orphans = sorted(outstanding[wid] - terminal)
            outstanding[wid].clear()
            resume_map = (self._journal_resume_map(wid)
                          if self.checkpoint else {})
            kills.append({
                "t": t, "worker": wid, "rerouted": orphans,
                "scheduled": scheduled is not None, "detected_by": detected,
                "note": scheduled.note if scheduled else "unscheduled exit",
            })
            for rid in orphans:
                toks = resume_map.get(rid) or None
                if toks:
                    recov["resumed" if self.resume
                          else "replayed"] += len(toks)
                if not route(rid, t, rerouting=True, resume_toks=toks):
                    deferred.append((rid, toks))

        def fire_restart(ev: FaultEvent, t: float) -> None:
            """Kill + replace: the replacement restores from the dead
            life's snapshot+journal and claims its work itself; the
            router holds the orphans until "restored"/"ready" arrive."""
            self._kill(ev.worker)
            while True:
                msg = self._poll(ev.worker)
                if msg is None:
                    break
                settle(msg)
            orphans = sorted(outstanding[ev.worker] - terminal)
            outstanding[ev.worker].clear()
            self._spawn(ev.worker, restore=True)
            restarting[ev.worker] = {
                "deadline": time.monotonic() + self.restart_timeout_s,
                "orphans": orphans, "t": t, "note": ev.note,
                "restored": None, "ready": False,
            }

        def poll_restarting(t: float) -> None:
            for wid in sorted(restarting):
                st = restarting[wid]
                while True:
                    msg = self._poll(wid)
                    if msg is None:
                        break
                    if msg[0] == "restored":
                        st["restored"] = msg[2]
                    elif msg[0] == "ready":
                        st["ready"] = True
                        self._note_ready(wid, msg)
                    else:
                        settle(msg)  # journal-complete dones land here
                if st["ready"]:
                    info = st["restored"] or {}
                    recov["replayed"] += sum(
                        int(v) for v in (info.get("replayed") or {}).values())
                    recov["resumed"] += sum(
                        int(v) for v in (info.get("resumed") or {}).values())
                    claimed = {int(r) for r in info.get("claimed", [])}
                    self._alive.add(wid)
                    last_pong[wid] = time.monotonic()
                    for rid in sorted(claimed):
                        if rid not in terminal:
                            outstanding[wid].add(rid)
                            owner[rid] = wid
                    kills.append({
                        "t": st["t"], "worker": wid,
                        "rerouted": sorted(st["orphans"]),
                        "scheduled": True, "restarted": True,
                        "detected_by": "scheduled-restart",
                        "note": st["note"],
                    })
                    # anything the dead life owed that the replacement did
                    # not claim (e.g. submitted but never journaled) goes
                    # back through normal routing from scratch
                    for rid in sorted(set(st["orphans"]) - claimed):
                        if rid not in terminal \
                                and not route(rid, t, rerouting=True):
                            deferred.append((rid, None))
                    del restarting[wid]
                elif time.monotonic() > st["deadline"]:
                    raise RuntimeError(
                        f"restarted worker {wid} not ready within "
                        f"{self.restart_timeout_s:g}s")

        i = 0
        while len(terminal) < len(outcomes):
            t = now_v()
            # 1) due faults
            while fault_q and fault_q[0].t <= t:
                ev = fault_q[0]
                if ev.worker not in self._alive \
                        and ev.worker not in restarting:
                    fault_q.pop(0)
                    continue
                if ev.worker in restarting:
                    break  # re-evaluate once the replacement is up
                if ev.kind in ("kill", "restart"):
                    # wait for in-flight work — and, with checkpointing,
                    # for >= 1 durably journaled token (a pre-progress kill
                    # proves nothing about resume-vs-replay) — unless no
                    # work can ever come.  Settle what the target already
                    # delivered first: a done sitting in its result queue
                    # would otherwise arm the fault against a request
                    # that is no longer in flight.
                    while True:
                        msg = self._poll(ev.worker)
                        if msg is None:
                            break
                        settle(msg)
                    work_possible = (i < len(arrivals) or bool(retry)
                                     or bool(deferred))
                    armed = bool(outstanding[ev.worker])
                    if armed and self.checkpoint:
                        armed = self._journal_has_progress(
                            ev.worker, outstanding[ev.worker])
                    if not armed and work_possible:
                        break
                    fault_q.pop(0)
                    if ev.kind == "restart":
                        fire_restart(ev, t)
                    else:
                        self._kill(ev.worker)
                        reap(ev.worker, t, ev, detected="scheduled-kill")
                else:
                    fault_q.pop(0)
                    self._send(ev.worker, ("fault", ev.kind, ev.arg))
            # 2) unscheduled deaths (crash ≠ kill fault, same recovery)
            for wid in sorted(self._alive):
                if not self._procs[wid].is_alive():
                    self._alive.discard(wid)
                    reap(wid, t, None)
            # 2b) replacements coming up
            if restarting:
                poll_restarting(t)
            # 2c) heartbeat failure detector: ping every alive worker each
            # hb_interval_s; a worker silent past hb_timeout_s is declared
            # dead even though its process is still running (hang/wedge)
            now_w = time.monotonic()
            if now_w - last_hb >= self.hb_interval_s:
                last_hb = now_w
                hb_seq += 1
                for wid in sorted(self._alive):
                    try:
                        self._send(wid, ("ping", hb_seq))
                    except TransportError:
                        pass  # dying worker; the liveness reap covers it
                for wid in sorted(self._alive):
                    if now_w - last_pong.get(wid, now_w) > self.hb_timeout_s:
                        self._kill(wid)
                        reap(wid, t, None, detected="heartbeat")
            # 3) due arrivals + retries + deferred reroutes
            if deferred and self._alive:
                still = []
                for rid, toks in deferred:
                    if rid in terminal:
                        continue
                    if not route(rid, t, rerouting=True, resume_toks=toks):
                        still.append((rid, toks))
                deferred[:] = still
            while i < len(arrivals) and arrivals[i].t_arrival <= t:
                if not route(arrivals[i].rid, t):
                    break  # all capacity mid-restart; retry next tick
                i += 1
            if retry:
                retry.sort()
                while retry and retry[0][0] <= t:
                    if not self._alive:
                        break
                    _, rid = retry.pop(0)
                    if rid not in terminal:
                        if not route(rid, t):
                            deferred.append((rid, None))
            # 4) worker results
            idle = True
            for wid in sorted(self._alive):
                while True:
                    msg = self._poll(wid)
                    if msg is None:
                        break
                    idle = False
                    settle(msg)
            if idle:
                time.sleep(0.002)
            if time.perf_counter() - t0 > max_wall_s:
                n_out = sum(len(s) for s in outstanding.values())
                raise RuntimeError(
                    f"cluster replay exceeded max_wall_s={max_wall_s:g}: "
                    f"{len(terminal)}/{len(outcomes)} terminal, "
                    f"{i}/{len(arrivals)} arrived, {len(retry)} retrying, "
                    f"{len(deferred)} deferred, {n_out} in flight, "
                    f"alive={sorted(self._alive)}, "
                    f"restarting={sorted(restarting)}")
        # the trace can drain before a replacement finishes booting (the
        # dead life delivered its last done in the same tick it was
        # killed, so the restart held no orphans) — wait it out anyway:
        # the kills ledger entry and recovered-token accounting are part
        # of the report, and returning mid-boot would let stop() kill a
        # half-started process.  poll_restarting raises past the
        # restart_timeout_s deadline, so this cannot spin forever.
        while restarting:
            poll_restarting(now_v())
            if restarting:
                time.sleep(0.01)
        return ClusterReport(outcomes=outcomes,
                             wall_s=time.perf_counter() - t0, speed=speed,
                             kills=kills, obs_paths=self.obs_paths,
                             recovered_tokens_replayed=recov["replayed"],
                             recovered_tokens_resumed=recov["resumed"])

    def merged(self, by_process: bool = False):
        """(metrics, spans, meta) — the per-worker obs exports folded into
        one job view with `obs --merge` semantics (counters summed,
        histograms bucket-added, gauges per-process; torn final lines
        from killed workers skipped with a `truncated_lines` count)."""
        from ..obs.aggregate import merge_files

        present = [p for p in self.obs_paths if os.path.exists(p)]
        if not present:
            raise FileNotFoundError(
                f"no worker obs exports under {self.out_dir!r} yet")
        return merge_files(present, by_process=by_process)
