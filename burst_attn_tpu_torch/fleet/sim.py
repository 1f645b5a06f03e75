"""burstsim: seeded discrete-event fleet simulator over burstcost rates
(port of burst_attn_tpu/fleet/sim.py).

The process-backed `FleetCluster` (fleet/fleet.py) proves correctness at a
handful of workers; the policy questions (routing, preemption, tenant
fairness, autoscale lead time) only show up at hundreds of replicas under
diurnal traffic.  This module replays large traces through a heap-based
discrete-event engine in seconds of wall-clock, executing the SAME pure
policy functions the fleet's router runs (fleet/policy.py, provably pure:
analysis/policycheck.py), and emits a seeded-deterministic JSONL report
per policy.  Same trace, spec and rates: the same event log, bit for bit,
as the JAX package's simulator (tests/test_torch_fleet_sim.py).

Replica cost function — provenance, not guesswork: replicas advance by
three rates derived from burstcost's `--cost-json` table
(analysis/costmodel.py, schema burstcost-v2, its h100 rows):

  prefill tokens/s   the best fitting fwd row's ring pass: world*s
                     tokens through max(t_compute_s, t_comm_s);
  decode steps/s     ragged-paged attention's per-step HBM traffic
                     (`ragged_hbm` rows) against the card's HBM rate —
                     decode is bandwidth-bound;
  KV-ship bytes/s    the ring link's rate (`ici_bw`: NVLink between
                     cards, spec-derived).

These are the card's floors.  The port's serving ticks are host-bound,
so a measured fleet runs well below them: `calibrate_rates` rebuilds the
three rates from a REAL fleet run's outcome timeline (the injection
seam), and the fidelity gate replays the real run's trace through the
sim with rates measured FROM that run and pins simulated goodput within
`SIM_FIDELITY_RTOL` of measured (chip_smoke.py's analysis phase runs it
on the card's fleet run).  A sim-found policy becomes `FleetCluster`'s
default only after `promote_policy` sees it reproduce a strict goodput
improvement in a real fleet run.

Determinism contract: virtual time only (the wall clock is read solely
to report `sim.wallclock_per_sim_second`), no RNG anywhere in the
engine, heap ties broken by a monotone sequence number, and every
applied event folded into a SHA-256 event-log digest — two runs over the
same trace and seed produce bit-identical logs.

Event model (3 heap events per request on the happy path):

  ARRIVAL       assign the earliest-free prefill worker (FCFS), schedule
                PREFILL_DONE at start + prompt_len / prefill_rate;
  PREFILL_DONE  route via the policy; admit (ship + decode scheduled as
                one completion event), shed, preempt, or join the
                pending queue;
  DECODE_DONE   retire the run, then drain the pending queue through the
                policy's dequeue order (tenant fairness lives here);
  BOOT / SCALE  autoscale lead-time experiments: scale ticks execute
                fleet/policy.autoscale with boot_s of spawn latency.

Decode service is priced at full occupancy (per-step time = slots /
decode_steps_per_s) — conservative and admission-order independent, so
preemption stays a single event cancellation (epoch bump).  Eviction
loses no decoded tokens (snapshot+journal semantics): the resume price
is re-shipping `kv_tokens` worth of pages, never a re-decode.

CLI: python -m burst_attn_tpu_torch.fleet.sim [--rates table|FILE.json]
(FILE: `save_rates` of `calibrate_rates` from a fleet run).
"""

import argparse
import hashlib
import heapq
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..obs import trace as tracing
from ..loadgen import trace as trace_mod
from ..loadgen.trace import Trace
from . import policy as fleet_policy
from .policy import (FleetView, PolicySpec, ReplicaView, ReqView, RunView,
                     ScaleParams)

C_EVENTS = obs.counter(
    "sim.events_processed", "discrete events applied by the fleet simulator")
G_WALL_RATIO = obs.gauge(
    "sim.wallclock_per_sim_second",
    "wall seconds burned per simulated second (last run)")
G_POLICY_GOODPUT = obs.gauge(
    "sim.policy_goodput",
    "simulated goodput tokens per virtual second, labeled {policy}")
C_PREEMPTIONS = obs.counter(
    "sim.preemptions", "evict-and-resume preemptions, labeled {class}")

SIM_FIDELITY_RTOL = 0.35  # fidelity gate: |sim - measured| / measured

# how many least-loaded candidates the sim state exposes per decision;
# the index is keyed by the exact least-loaded score, so the argmin is
# always candidate 0 and the FleetState contract ("never drop the
# argmin") holds for any K >= 1
_CANDIDATES = 4
_WARM_CAP = 32           # warm templates remembered per replica (FIFO)
_FAIR_SCAN = 32          # pending-queue prefix the dequeue policy scans


@dataclass(frozen=True)
class SimRates:
    """The three rates a simulated replica advances by, plus spawn
    latency.  The seam: build from the cost table
    (`rates_from_cost_table`), from a measured run (`calibrate_rates`),
    or inject obs-counter-calibrated values directly."""

    prefill_tokens_per_s: float
    decode_steps_per_s: float     # aggregate across a replica's slots
    ship_bytes_per_s: float
    kv_bytes_per_token: float
    boot_s: float = 30.0


def rates_from_cost_table(table: Optional[dict] = None, *,
                          generation: str = "h100",
                          pool_dtype: str = "fp32",
                          boot_s: float = 30.0) -> SimRates:
    """Derive `SimRates` from a burstcost `--cost-json` table (computed
    in-process when `table` is None — same data `python -m
    burst_attn_tpu_torch.analysis --cost-json` prints)."""
    if table is None:
        from ..analysis import costmodel
        table = costmodel.cost_table()
    if table.get("schema") != "burstcost-v2":
        raise ValueError(f"unsupported cost table schema "
                         f"{table.get('schema')!r}")
    hw = table["hw"][generation]
    shape = table["shape"]
    world = int(table["world"])
    rows = [r for r in table["rows"]
            if r["generation"] == generation and r["pass"] == "fwd"
            and r["wire"] is None and r["fits"]]
    if not rows:
        raise ValueError(f"no fitting fwd rows for generation "
                         f"{generation!r} in cost table")
    t_pass = min(max(r["t_compute_s"], r["t_comm_s"]) for r in rows)
    prefill_tokens_per_s = world * shape["s"] / t_pass
    hbm_rows = [r for r in table["ragged_hbm"]
                if r["pool_dtype"] == pool_dtype]
    if not hbm_rows:
        raise ValueError(f"no ragged_hbm rows for pool_dtype "
                         f"{pool_dtype!r} in cost table")
    step_bytes = hbm_rows[0]["hbm_bytes"]
    kv_len = hbm_rows[0]["kv_len"]
    return SimRates(
        prefill_tokens_per_s=prefill_tokens_per_s,
        decode_steps_per_s=hw["hbm_bw"] / step_bytes,
        ship_bytes_per_s=hw["ici_bw"],
        kv_bytes_per_token=step_bytes / kv_len,
        boot_s=boot_s)


@dataclass
class SimReport:
    """One policy's replay, seeded-deterministic (wall_s excepted)."""

    policy: str
    seed: int
    n_replicas: int
    slots: int
    n_requests: int
    n_done: int = 0
    n_shed: int = 0
    preemptions: Dict[str, int] = field(default_factory=dict)
    goodput_tokens_per_s: float = 0.0
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    sim_duration_s: float = 0.0
    events: int = 0
    event_log_sha256: str = ""
    scale_ups: int = 0
    scale_downs: int = 0
    wall_s: float = 0.0

    def to_record(self) -> dict:
        d = dict(self.__dict__)
        d["record"] = "sim-policy-report"
        return d


class _SimState:
    """The simulator's `FleetState`: candidate index keyed by the exact
    least-loaded score, maintained incrementally (lazy heap with version
    stamps) so routing stays O(log n) at 1000 replicas."""

    __slots__ = ("occ", "slots", "alive", "version", "cand_heap",
                 "warm_sets", "warm_fifo", "warm_index",
                 "queue_depth", "wait_for_decode", "booting")

    def __init__(self, slots: int):
        self.slots = slots
        self.occ: List[int] = []
        self.alive: List[bool] = []
        self.version: List[int] = []
        self.cand_heap: List[Tuple] = []
        self.warm_sets: List[set] = []
        self.warm_fifo: List[List[int]] = []
        self.warm_index: Dict[int, Dict[int, None]] = {}
        self.queue_depth = 0
        self.wait_for_decode = 0
        self.booting = 0

    # -- executor-side maintenance ------------------------------------

    def add_replica(self) -> int:
        wid = len(self.occ)
        self.occ.append(0)
        self.alive.append(True)
        self.version.append(0)
        self.warm_sets.append(set())
        self.warm_fifo.append([])
        self.touch(wid)
        return wid

    def touch(self, wid: int) -> None:
        """Re-key `wid` in the candidate index after any gauge change."""
        self.version[wid] += 1
        if self.alive[wid]:
            occ = self.occ[wid]
            heapq.heappush(self.cand_heap,
                           (self.slots - occ <= 0, occ, wid,
                            self.version[wid]))

    def retire(self, wid: int) -> None:
        self.alive[wid] = False
        self.version[wid] += 1

    def note_warm(self, wid: int, template_seed: int) -> None:
        if template_seed < 0 or template_seed in self.warm_sets[wid]:
            return
        self.warm_sets[wid].add(template_seed)
        self.warm_fifo[wid].append(template_seed)
        self.warm_index.setdefault(template_seed, {})[wid] = None
        if len(self.warm_fifo[wid]) > _WARM_CAP:
            old = self.warm_fifo[wid].pop(0)
            self.warm_sets[wid].discard(old)
            idx = self.warm_index.get(old)
            if idx is not None:
                idx.pop(wid, None)

    def is_warm(self, wid: int, template_seed: int) -> bool:
        return template_seed in self.warm_sets[wid]

    def _view(self, wid: int) -> ReplicaView:
        occ = self.occ[wid]
        return ReplicaView(wid=wid, occ=occ, staged=0,
                           slots_free=self.slots - occ)

    # -- FleetState ---------------------------------------------------

    @property
    def replicas(self) -> Tuple[ReplicaView, ...]:
        """Top-K candidates by the least-loaded score (argmin first)."""
        heap, valid = self.cand_heap, []
        while heap and len(valid) < _CANDIDATES:
            entry = heapq.heappop(heap)
            _nofree, occ, wid, ver = entry
            if ver == self.version[wid] and self.alive[wid] \
                    and occ == self.occ[wid]:
                valid.append(entry)
        for entry in valid:
            heapq.heappush(heap, entry)
        return tuple(self._view(e[2]) for e in valid)

    def warm_candidates(self, template_seed: int
                        ) -> Tuple[ReplicaView, ...]:
        idx = self.warm_index.get(template_seed)
        if not idx:
            return ()
        out = []
        for wid in idx:
            if self.alive[wid]:
                out.append(self._view(wid))
                if len(out) >= 16:
                    break
        return tuple(out)

    def full_view(self) -> FleetView:
        """Complete wid-sorted snapshot for autoscale ticks (the same
        concrete view the real router hands the policy)."""
        reps = tuple(
            ReplicaView(wid=w, occ=self.occ[w], staged=0,
                        slots_free=self.slots - self.occ[w],
                        quiet=self.occ[w] == 0)
            for w in range(len(self.occ)) if self.alive[w])
        return FleetView(replicas=reps, queue_depth=self.queue_depth,
                         wait_for_decode=self.wait_for_decode,
                         booting=self.booting)


# event codes (digest lines carry the names)
_ARRIVAL, _PREFILL_DONE, _DECODE_DONE, _BOOT, _SCALE = range(5)
_NAMES = ("arrive", "prefill", "decode", "boot", "scale")


def simulate(trace: Trace, spec: PolicySpec, *, n_replicas: int,
             slots: int = 8, n_prefill: Optional[int] = None,
             rates: Optional[SimRates] = None, seed: int = 0,
             autoscale: Optional[ScaleParams] = None,
             scale_interval_s: float = 1.0,
             log_path: Optional[str] = None) -> SimReport:
    """Replay `trace` under policy `spec`.  Pure function of its inputs
    (the seed only labels the report — the engine itself draws nothing);
    `log_path` optionally writes the full event log (tests; the digest
    is always computed)."""
    route = getattr(fleet_policy, spec.route)
    next_waiting = getattr(fleet_policy, spec.next_waiting)
    if rates is None:
        rates = rates_from_cost_table()
    if n_prefill is None:
        n_prefill = max(1, n_replicas // 4)
    step_s = slots / rates.decode_steps_per_s
    ship_inv = (0.0 if math.isinf(rates.ship_bytes_per_s)
                else 1.0 / rates.ship_bytes_per_s)
    bpt = rates.kv_bytes_per_token

    state = _SimState(slots)
    for _ in range(n_replicas):
        state.add_replica()

    views: Dict[int, ReqView] = {}
    arrival_t: Dict[int, float] = {}
    epoch: Dict[int, int] = {}
    run_wid: Dict[int, int] = {}
    run_steps: Dict[int, int] = {}       # steps remaining at admission
    run_t0: Dict[int, float] = {}        # decode start (post-ship)
    run_kv: Dict[int, int] = {}          # resident kv tokens at admission
    runs_by_wid: Dict[int, Dict[int, None]] = {}
    pending: List[int] = []
    served_by_tenant: Dict[int, int] = {}
    ttfts: List[float] = []
    preempt_counts: Dict[str, int] = {}
    booting_wids: set = set()
    pressure_ticks, idle_ticks = 0, {}
    scale_ups = scale_downs = 0
    n_done = n_shed = 0
    tokens_done = 0
    last_done_t = 0.0

    # virtual-clock request tracing: when obs.trace is enabled the sim
    # emits the SAME record schema the live engines do, with clock
    # "virtual" and deterministic trace ids (no RNG, no wall reads — the
    # event-log digest is untouched)
    trc = tracing.enabled()

    def _tc(rid: int) -> tracing.TraceContext:
        return tracing.TraceContext(trace_id=f"sim{seed}-r{rid}",
                                    clock="virtual")

    hasher = hashlib.sha256()
    log_fh = open(log_path, "w", encoding="utf-8") if log_path else None

    def log(t: float, code: int, a: int, b: int) -> None:
        line = f"{t:.6f} {_NAMES[code]} {a} {b}\n"
        hasher.update(line.encode())
        if log_fh is not None:
            log_fh.write(line)

    heap: List[Tuple] = []
    seq = 0

    def push(t: float, code: int, a: int = 0, b: int = 0) -> None:
        nonlocal seq
        heapq.heappush(heap, (t, seq, code, a, b))
        seq += 1

    arrivals = trace.requests  # arrival-ordered by construction
    arr_i = 0
    if arrivals:
        push(arrivals[0].t_arrival, _ARRIVAL, 0)
    if autoscale is not None:
        push(scale_interval_s, _SCALE)
    pf_free = [(0.0, p) for p in range(n_prefill)]
    in_prefill = 0

    def runviews(wid: int) -> Tuple[RunView, ...]:
        out = []
        for rid in runs_by_wid.get(wid, ()):
            v = views[rid]
            out.append(RunView(rid=rid, priority=v.priority,
                               kv_tokens=run_kv[rid]))
        return tuple(out)

    def evict(rid: int, t: float) -> None:
        nonlocal pressure_ticks
        wid = run_wid.pop(rid)
        runs_by_wid[wid].pop(rid, None)
        epoch[rid] += 1  # cancels the in-flight DECODE_DONE
        state.occ[wid] -= 1
        state.touch(wid)
        done = max(0, int((t - run_t0[rid]) / step_s)) \
            if t > run_t0[rid] else 0
        done = min(done, run_steps[rid])
        run_steps[rid] -= done
        run_kv[rid] += done  # journal keeps every decoded token
        cls = str(views[rid].priority)
        preempt_counts[cls] = preempt_counts.get(cls, 0) + 1
        pending.insert(0, rid)  # resume ahead of fresh arrivals

    def admit(rid: int, t: float) -> bool:
        req = views[rid]
        wid = route(state, req)
        if wid is None or not state.alive[wid]:
            return False
        if state.occ[wid] >= slots:
            if spec.preempt and req.priority > 0:
                victim = fleet_policy.preempt_victim(runviews(wid),
                                                     req.priority)
                if victim is None:
                    return False
                evict(victim, t)
            else:
                return False
        resume = rid in run_kv
        if resume:
            ship_bytes = run_kv[rid] * bpt
            steps = run_steps[rid]
        else:
            warm = state.is_warm(wid, req.template_seed) \
                if req.template_seed >= 0 else False
            ship_tokens = req.prompt_len - req.overlap_len if warm \
                else req.prompt_len
            ship_bytes = ship_tokens * bpt
            steps = req.max_new_tokens
            run_kv[rid] = req.prompt_len
            run_steps[rid] = steps
        ship_dur = ship_bytes * ship_inv
        t0 = t + ship_dur
        run_t0[rid] = t0
        run_wid[rid] = wid
        runs_by_wid.setdefault(wid, {})[rid] = None
        state.occ[wid] += 1
        state.touch(wid)
        state.note_warm(wid, req.template_seed)
        epoch[rid] = epoch.get(rid, 0) + 1
        push(t0 + steps * step_s, _DECODE_DONE, rid, epoch[rid])
        if not resume:
            ttfts.append(t0 + step_s - arrival_t[rid])
            if trc:
                tc = _tc(rid)
                tracing.record_span(tc, "sim.ship", t, t0, wid=wid)
                tracing.marker(tc, "sim.first_token", t0 + step_s)
                tracing.note_ttft(tc, t0 + step_s - arrival_t[rid],
                                  metric="sim.ttft_s")
        return True

    def drain(t: float) -> None:
        while pending:
            scan = pending[:_FAIR_SCAN]
            idx = next_waiting([views[r] for r in scan], served_by_tenant)
            rid = scan[idx]
            if not admit(rid, t):
                break
            pending.remove(rid)
            ten = views[rid].tenant
            served_by_tenant[ten] = served_by_tenant.get(ten, 0) + 1

    wall0 = time.perf_counter()
    events = 0
    while heap:
        t, _s, code, a, b = heapq.heappop(heap)
        if code == _ARRIVAL:
            req = arrivals[a]
            arr_i = a + 1
            if arr_i < len(arrivals):
                push(arrivals[arr_i].t_arrival, _ARRIVAL, arr_i)
            arrival_t[req.rid] = req.t_arrival
            views[req.rid] = ReqView(
                rid=req.rid, prompt_len=req.prompt_len,
                max_new_tokens=req.max_new_tokens, tenant=req.tenant,
                priority=req.priority, template_seed=req.template_seed,
                overlap_len=req.overlap_len)
            free_at, pid = heapq.heappop(pf_free)
            start = free_at if free_at > t else t
            done = start + req.prompt_len / rates.prefill_tokens_per_s
            heapq.heappush(pf_free, (done, pid))
            in_prefill += 1
            push(done, _PREFILL_DONE, req.rid)
            if trc:
                tc = _tc(req.rid)
                tracing.record_span(tc, "sim.queued", req.t_arrival, start)
                tracing.record_span(tc, "sim.prefill", start, done, pid=pid)
            log(t, code, req.rid, pid)
        elif code == _PREFILL_DONE:
            in_prefill -= 1
            rid = a
            state.queue_depth = max(0, in_prefill - n_prefill)
            state.wait_for_decode = len(pending)
            if admit(rid, t):
                log(t, code, rid, run_wid[rid])
            else:
                verdict = fleet_policy.admit_or_shed(
                    state, views[rid], len(pending), spec.max_pending)
                if verdict == "shed":
                    n_shed += 1
                    log(t, code, rid, -2)
                else:
                    pending.append(rid)
                    log(t, code, rid, -1)
        elif code == _DECODE_DONE:
            rid = a
            if epoch.get(rid) != b:
                continue  # cancelled by a preemption
            wid = run_wid.pop(rid)
            runs_by_wid[wid].pop(rid, None)
            state.occ[wid] -= 1
            state.touch(wid)
            n_done += 1
            tokens_done += views[rid].max_new_tokens
            last_done_t = t
            if trc:
                tc = _tc(rid)
                tracing.record_span(tc, "sim.decode", run_t0[rid], t,
                                    wid=wid)
                tracing.record_span(tc, "sim.request", arrival_t[rid], t,
                                    root=True, rid=rid)
            log(t, code, rid, wid)
            state.wait_for_decode = len(pending)
            drain(t)
        elif code == _BOOT:
            wid = a
            booting_wids.discard(wid)
            state.booting = len(booting_wids)
            state.alive[wid] = True
            state.touch(wid)
            log(t, code, wid, 0)
            drain(t)
        elif code == _SCALE:
            view = state.full_view()
            decision, pressure_ticks, idle_ticks = fleet_policy.autoscale(
                view, autoscale, pressure_ticks, idle_ticks)
            if decision.up:
                wid = state.add_replica()
                state.alive[wid] = False  # booting: not yet routable
                state.version[wid] += 1
                booting_wids.add(wid)
                state.booting = len(booting_wids)
                scale_ups += 1
                push(t + rates.boot_s, _BOOT, wid)
            if decision.down is not None:
                state.retire(decision.down)
                scale_downs += 1
            log(t, code, int(decision.up),
                -1 if decision.down is None else decision.down)
            # keep ticking while work remains
            if arr_i < len(arrivals) or pending or run_wid:
                push(t + scale_interval_s, _SCALE)
        events += 1
    wall = time.perf_counter() - wall0
    if log_fh is not None:
        log_fh.close()

    duration = last_done_t if last_done_t > 0 else trace.duration_s
    ttfts.sort()

    def pct(p: float) -> float:
        if not ttfts:
            return 0.0
        return ttfts[min(len(ttfts) - 1, int(p * len(ttfts)))]

    report = SimReport(
        policy=spec.name, seed=seed, n_replicas=n_replicas, slots=slots,
        n_requests=len(trace.requests), n_done=n_done, n_shed=n_shed,
        preemptions=dict(sorted(preempt_counts.items())),
        goodput_tokens_per_s=round(tokens_done / duration, 6)
        if duration > 0 else 0.0,
        ttft_p50_s=round(pct(0.50), 6), ttft_p99_s=round(pct(0.99), 6),
        sim_duration_s=round(duration, 6), events=events,
        event_log_sha256=hasher.hexdigest(),
        scale_ups=scale_ups, scale_downs=scale_downs,
        wall_s=round(wall, 3))
    C_EVENTS.inc(events)
    if duration > 0:
        G_WALL_RATIO.set(wall / duration)
    G_POLICY_GOODPUT.set(report.goodput_tokens_per_s, policy=spec.name)
    for cls, n in report.preemptions.items():
        C_PREEMPTIONS.inc(n, **{"class": cls})
    return report


def sweep(trace: Trace, specs, **kw) -> List[SimReport]:
    """Replay the trace under every policy; deterministic order."""
    return [simulate(trace, spec, **kw) for spec in specs]


def write_report_jsonl(reports, path: str) -> str:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for rep in reports:
            f.write(json.dumps(rep.to_record(), sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return path


# --------------------------------------------------------------------------
# fidelity + promotion gates


def save_rates(rates: SimRates, path: str) -> str:
    """Write `rates` as JSON (the CLI's --rates FILE)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(dict(rates.__dict__), f, sort_keys=True)
    return path


def load_rates(path: str) -> SimRates:
    with open(path, encoding="utf-8") as f:
        return SimRates(**json.load(f))


def calibrate_rates(trace: Trace, outcomes: Dict[int, object], *,
                    n_prefill: int, slots: int,
                    boot_s: float = 30.0) -> SimRates:
    """Rebuild `SimRates` from a REAL fleet run's outcome timeline (the
    injection seam, fed from measurement instead of the cost table).

    prefill tokens/s: FCFS busy-span decomposition — replay the
    dispatch order over `n_prefill` earliest-free servers and divide
    prompt tokens by the busy time up to each admission (t_submit marks
    prefill+ship complete in the fleet).  decode steps/s: inverts the
    sim's own service model (per-step time = slots / rate) from the
    aggregate tokens / decode-span ratio, so replaying with these rates
    validates the ENGINE's queueing dynamics, not a rate guess.  A
    math.inf ship rate: the fleet's shipping is folded into the prefill
    span (t_submit marks admission on a replica)."""
    done = [o for o in outcomes.values()
            if o.status == "done" and o.t_submit is not None
            and o.t_done is not None]
    if not done:
        raise ValueError("no completed outcomes to calibrate from")
    by_rid = {r.rid: r for r in trace.requests}
    done.sort(key=lambda o: (o.t_submit, o.rid))
    free = [0.0] * n_prefill
    busy = 0.0
    tokens_in = 0
    for o in done:
        start = max(o.t_arrival, min(free))
        span = max(o.t_submit - start, 1e-9)
        busy += span
        free[free.index(min(free))] = o.t_submit
        tokens_in += by_rid[o.rid].prompt_len
    decode_span = sum(max(o.t_done - o.t_submit, 1e-9) for o in done)
    tokens_out = sum(len(o.tokens) for o in done)
    step_s = decode_span / max(tokens_out, 1)
    return SimRates(
        prefill_tokens_per_s=tokens_in / busy,
        decode_steps_per_s=slots / step_s,
        ship_bytes_per_s=math.inf,  # folded into the prefill span
        kv_bytes_per_token=0.0,
        boot_s=boot_s)


def measured_goodput(outcomes: Dict[int, object]) -> float:
    """tokens / virtual makespan over completed outcomes (the replay's
    constant `speed` factor between virtual and wall seconds cancels in
    the fidelity ratio)."""
    done = [o for o in outcomes.values()
            if o.status == "done" and o.t_done is not None]
    if not done:
        return 0.0
    span = max(o.t_done for o in done) \
        - min(o.t_arrival for o in done)
    return sum(len(o.tokens) for o in done) / max(span, 1e-9)


def fidelity_check(trace: Trace, outcomes: Dict[int, object], *,
                   n_replicas: int, slots: int, n_prefill: int,
                   rtol: float = SIM_FIDELITY_RTOL) -> dict:
    """The fidelity gate: replay a real fleet run's trace through the
    sim with rates calibrated FROM that run and pin simulated goodput
    within `rtol` of measured."""
    rates = calibrate_rates(trace, outcomes, n_prefill=n_prefill,
                            slots=slots)
    rep = simulate(trace, fleet_policy.POLICIES["least_loaded"],
                   n_replicas=n_replicas, slots=slots,
                   n_prefill=n_prefill, rates=rates)
    measured = measured_goodput(outcomes)
    # same definition on the sim side: decode budget == emitted tokens
    sim_tokens = sum(r.max_new_tokens for r in trace.requests)
    sim_span = rep.sim_duration_s - min(
        r.t_arrival for r in trace.requests)
    simulated = sim_tokens / max(sim_span, 1e-9) if rep.n_done else 0.0
    ratio = simulated / measured if measured > 0 else math.inf
    return {"measured_goodput": measured, "simulated_goodput": simulated,
            "ratio": ratio, "rtol": rtol,
            "ok": bool(abs(ratio - 1.0) <= rtol),
            "rates": dict(rates.__dict__), "sim_report": rep.to_record()}


def promote_policy(default: str, sim_goodput: Dict[str, float],
                   fleet_goodput: Dict[str, float]) -> str:
    """The promotion gate: the sim's best policy replaces `default` ONLY
    if a real fleet measurement shows a STRICT goodput improvement over
    the default.  Missing measurements never promote."""
    best = max(sorted(sim_goodput), key=lambda k: sim_goodput[k])
    if best == default:
        return default
    base = fleet_goodput.get(default)
    cand = fleet_goodput.get(best)
    if base is None or cand is None or not cand > base:
        return default
    return best


# --------------------------------------------------------------------------
# CLI: python -m burst_attn_tpu_torch.fleet.sim


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m burst_attn_tpu_torch.fleet.sim",
        description="burstsim: discrete-event fleet simulator "
                    "(policies from fleet/policy.py, rates from "
                    "burstcost)")
    ap.add_argument("--policy", default="all",
                    help="policy name or 'all' (default)")
    ap.add_argument("--trace-kind", default="diurnal",
                    choices=("diurnal", "heavy_tail"))
    ap.add_argument("--requests", type=int, default=20000)
    ap.add_argument("--replicas", type=int, default=100)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prefill", type=int, default=0,
                    help="prefill workers (default replicas/4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--generation", default="h100")
    ap.add_argument("--rates", default="table", metavar="table|FILE",
                    help="'table': rates from the cost table's "
                         "--generation rows (the card's floors); FILE: "
                         "a JSON SimRates (save_rates of calibrate_rates "
                         "from a fleet run)")
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="emit virtual-clock request trace records "
                         "(ride the --json export; render with "
                         "`python -m burst_attn_tpu_torch.obs --trace`)")
    ap.add_argument("--report", metavar="PATH",
                    help="write per-policy JSONL report")
    ap.add_argument("--json", metavar="PATH",
                    help="export sim.* obs metrics as JSONL "
                         "(merges through `python -m "
                         "burst_attn_tpu_torch.obs --merge`)")
    args = ap.parse_args(argv)

    if args.trace_kind == "diurnal":
        tr = trace_mod.synthesize_diurnal_trace(
            args.requests, seed=args.seed, vocab=97, period_s=600.0,
            mean_rate=max(20.0, args.requests / 200.0),
            priority_fraction=0.1)
    else:
        tr = trace_mod.synthesize_heavy_tail_trace(
            args.requests, seed=args.seed, vocab=97,
            mean_interarrival_s=min(0.05, 200.0 / args.requests),
            priority_tenants=2)
    if args.trace:
        tracing.enable()
    rates = (rates_from_cost_table(generation=args.generation)
             if args.rates == "table" else load_rates(args.rates))
    names = sorted(fleet_policy.POLICIES) if args.policy == "all" \
        else [args.policy]
    specs = [fleet_policy.POLICIES[n] for n in names]
    scale = ScaleParams(3, 12, args.replicas, 1) if args.autoscale \
        else None
    reports = sweep(tr, specs, n_replicas=args.replicas, slots=args.slots,
                    n_prefill=args.prefill or None, rates=rates,
                    seed=args.seed, autoscale=scale)
    for rep in reports:
        print(f"{rep.policy:18s} goodput={rep.goodput_tokens_per_s:12.1f} "
              f"tok/s  ttft_p99={rep.ttft_p99_s:8.3f}s  "
              f"done={rep.n_done} shed={rep.n_shed} "
              f"preempt={sum(rep.preemptions.values())} "
              f"events={rep.events} wall={rep.wall_s:.2f}s")
    if args.report:
        print("report:", write_report_jsonl(reports, args.report))
    if args.json:
        print("obs:", obs.export_jsonl(args.json))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
