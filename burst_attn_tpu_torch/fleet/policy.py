"""Pure fleet scheduling policies (port of burst_attn_tpu/fleet/policy.py):
one decision surface.

The router inside `FleetCluster` (fleet.py) takes its decisions through
this module: a `FleetState` protocol describing what a scheduler may
observe, and pure `(state, event) -> decision` functions for each
decision the fleet takes — route, admit/shed, preempt, autoscale.  The
JAX package's discrete-event simulator delegates to the same functions,
so a policy it finds is a policy the fleet can run unchanged.

Purity contract (the JAX package's `policy-pure` rule,
burst_attn_tpu/analysis/policycheck.py, holds for this source too):

  * no wall clock — time is whatever the executor's event loop says;
  * no RNG, global or seeded — decisions are functions of state only;
  * no module state — every call is replayable; tick counters thread
    through arguments and return values;
  * no transport — policies see gauges, never sockets or queues.

Decision semantics (the JAX package's, pinned by tests):

  route_least_loaded   min over replicas of the admission-gauge score
                       `(slots_free <= 0, occ + staged, wid)` — fewest
                       live+staged sequences, preferring a free slot.
  autoscale            pressure ticks (queue waiting AND zero free
                       slots) against `scale_up_after` with boot-aware
                       capacity; per-replica idle ticks against
                       `scale_down_after`, at most one retirement per
                       tick, never below `min_decode`, never while the
                       queue is non-empty.

The other policies (affinity / ttft_tpot / fair_tenant /
priority_preempt) live here too.
"""

from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

try:  # 3.8+: structural typing for the state the executors expose
    from typing import Protocol
except ImportError:  # pragma: no cover - ancient interpreter
    Protocol = object  # type: ignore[assignment]


class ReplicaView(NamedTuple):
    """One decode replica's admission gauges, as the router sees them
    (ride every pong/done/admitted message in the real fleet; maintained
    incrementally by the simulator)."""

    wid: int
    occ: int = 0            # live decode sequences
    staged: int = 0         # transfers staged, not yet admitted
    slots_free: int = 1     # free decode slots reported
    quiet: bool = False     # no work, no staging, nothing in flight
    templates: Tuple[int, ...] = ()  # warm shared-prefix template seeds


class RunView(NamedTuple):
    """One live decode run, as preemption candidates are presented."""

    rid: int
    priority: int = 0
    kv_tokens: int = 0      # resident KV length = evict-and-resume price


class ReqView(NamedTuple):
    """One request at a decision point (routing / admission / dequeue)."""

    rid: int
    prompt_len: int = 0
    max_new_tokens: int = 0
    tenant: int = -1
    priority: int = 0
    template_seed: int = -1
    overlap_len: int = 0


class FleetState(Protocol):
    """What a policy may observe.  Executors implement this however they
    like (the fleet snapshots its gauge dicts; the simulator exposes an
    incrementally-maintained candidate index) — policies only read it.

    `replicas` must be wid-sorted and must always contain the replica a
    full least-loaded scan would pick (an executor may pre-filter for
    scale, but never drop the argmin)."""

    replicas: Sequence[ReplicaView]
    queue_depth: int        # requests waiting for a prefill worker
    wait_for_decode: int    # queue + complete transfers with no replica
    booting: int            # spawned replicas that have not reported ready

    def warm_candidates(self, template_seed: int) -> Sequence[ReplicaView]:
        """Replicas holding `template_seed` warm (prefix pages resident)."""
        ...


class FleetView(NamedTuple):
    """Concrete `FleetState`: the snapshot the real router builds per
    decision (replicas wid-sorted)."""

    replicas: Tuple[ReplicaView, ...] = ()
    queue_depth: int = 0
    wait_for_decode: int = 0
    booting: int = 0

    def warm_candidates(self, template_seed: int) -> Tuple[ReplicaView, ...]:
        return tuple(r for r in self.replicas
                     if template_seed in r.templates)


class ScaleParams(NamedTuple):
    """Autoscale thresholds (FleetCluster constructor knobs)."""

    scale_up_after: int
    scale_down_after: int
    max_decode: int
    min_decode: int


class ScaleDecision(NamedTuple):
    """What one autoscale tick decided.  `up` and `down` may BOTH fire
    in one tick (pressure can come from unassigned transfers while the prefill queue is empty and some
    replica has idled past its threshold)."""

    up: bool = False
    down: Optional[int] = None


# --------------------------------------------------------------------------
# routing


def route_least_loaded(state: FleetState,
                       req: Optional[ReqView] = None) -> Optional[int]:
    """The default: fewest live+staged sequences, preferring replicas
    that report a free slot."""
    best = None
    best_score = None
    for r in state.replicas:
        score = (r.slots_free <= 0, r.occ + r.staged, r.wid)
        if best_score is None or score < best_score:
            best, best_score = r.wid, score
    return best


def route_affinity(state: FleetState,
                   req: Optional[ReqView] = None) -> Optional[int]:
    """TTFT-greedy: a replica with the request's template warm skips
    shipping the shared prefix, so always take one if it has a free
    slot — accepting the prefix cache's rich-get-richer load skew."""
    if req is not None and req.template_seed >= 0 and req.overlap_len > 0:
        best = None
        best_score = None
        for r in state.warm_candidates(req.template_seed):
            if r.slots_free <= 0:
                continue
            score = (r.occ + r.staged, r.wid)
            if best_score is None or score < best_score:
                best, best_score = r.wid, score
        if best is not None:
            return best
    return route_least_loaded(state, req)


TTFT_TPOT_OCC_CAP = 3  # warm-affinity detour allowed this far above argmin


def route_ttft_tpot(state: FleetState,
                    req: Optional[ReqView] = None) -> Optional[int]:
    """TTFT-vs-TPOT aware: take the warm replica (TTFT win: no prefix
    re-ship) only while its load stays within `TTFT_TPOT_OCC_CAP` of the
    least-loaded choice — past that, the co-resident decode slowdown
    (TPOT) outweighs the ship saving and we fall back to least-loaded."""
    fallback = route_least_loaded(state, req)
    if req is None or req.template_seed < 0 or req.overlap_len <= 0 \
            or fallback is None:
        return fallback
    floor = None
    for r in state.replicas:
        if r.wid == fallback:
            floor = r.occ + r.staged
            break
    if floor is None:
        return fallback
    best = None
    best_score = None
    for r in state.warm_candidates(req.template_seed):
        if r.slots_free <= 0 or r.occ + r.staged > floor + TTFT_TPOT_OCC_CAP:
            continue
        score = (r.occ + r.staged, r.wid)
        if best_score is None or score < best_score:
            best, best_score = r.wid, score
    return best if best is not None else fallback


# name -> module attribute; executors resolve through getattr so tests
# can spy on the delegation by monkeypatching the function object
ROUTE_POLICY_FUNCS: Dict[str, str] = {
    "least_loaded": "route_least_loaded",
    "affinity": "route_affinity",
    "ttft_tpot": "route_ttft_tpot",
}


# --------------------------------------------------------------------------
# admission / shedding / dequeue order


def admit_or_shed(state: FleetState, req: ReqView, pending: int,
                  max_pending: Optional[int]) -> str:
    """Hard load shed at the decode boundary: with `max_pending` set, a
    best-effort (priority <= 0) request arriving to a full pending queue
    is shed; priority traffic is never shed (it preempts instead)."""
    if max_pending is not None and pending >= max_pending \
            and req.priority <= 0:
        return "shed"
    return "admit"


def next_waiting_fcfs(waiting: Sequence[ReqView],
                      served_by_tenant: Mapping[int, int]) -> int:
    """Dequeue in arrival order."""
    return 0


def next_waiting_fair_tenant(waiting: Sequence[ReqView],
                             served_by_tenant: Mapping[int, int]) -> int:
    """Tenant-fair dequeue: serve the waiting request whose tenant has
    been served least (ties broken by arrival order) — the counterweight
    to the prefix cache's rich-get-richer bias."""
    best = 0
    best_served = None
    for i, req in enumerate(waiting):
        served = served_by_tenant.get(req.tenant, 0)
        if best_served is None or served < best_served:
            best, best_served = i, served
    return best


# --------------------------------------------------------------------------
# preemption


def preempt_victim(runs: Sequence[RunView], priority: int) -> Optional[int]:
    """Evict-and-resume victim choice when a priority request finds no
    free slot: the strictly-lower-priority run with the least resident
    KV — the cheapest to re-ship on resume, since the snapshot+journal
    machinery makes eviction lose zero decoded tokens (the resume price
    is shipping `kv_tokens` worth of pages back, never a re-decode)."""
    best = None
    best_score = None
    for r in runs:
        if r.priority >= priority:
            continue
        score = (r.priority, r.kv_tokens, r.rid)
        if best_score is None or score < best_score:
            best, best_score = r.rid, score
    return best


# --------------------------------------------------------------------------
# autoscale


def autoscale(state: FleetState, params: ScaleParams, pressure_ticks: int,
              idle_ticks: Mapping[int, int]
              ) -> Tuple[ScaleDecision, int, Dict[int, int]]:
    """One autoscale tick.  Returns the decision plus the threaded tick
    state (pure: the executor owns the counters between calls).

    Pressure = work waiting for decode AND zero free slots, reset on any
    relief; capacity counts booting replicas so a slow boot cannot stack
    spawns past `max_decode`; idle ticks advance per wid-sorted replica
    and at most ONE retirement fires per tick (the scan stops there,
    leaving later replicas' counters untouched)."""
    free = 0
    for r in state.replicas:
        free += r.slots_free
    pressure_ticks = pressure_ticks + 1 \
        if (state.wait_for_decode > 0 and free == 0) else 0
    up = False
    if pressure_ticks >= params.scale_up_after \
            and len(state.replicas) + state.booting < params.max_decode:
        pressure_ticks = 0
        up = True
    ticks = dict(idle_ticks)
    down = None
    for r in state.replicas:
        ticks[r.wid] = ticks.get(r.wid, 0) + 1 if r.quiet else 0
        if ticks[r.wid] >= params.scale_down_after \
                and len(state.replicas) > params.min_decode \
                and state.queue_depth == 0:
            ticks.pop(r.wid)
            down = r.wid
            break
    return ScaleDecision(up=up, down=down), pressure_ticks, ticks


# --------------------------------------------------------------------------
# the policy space the simulator sweeps


class PolicySpec(NamedTuple):
    """One schedulable policy: the full decision bundle the simulator
    executes and the fleet could adopt.  `route`/`next_waiting`/
    `preempt` name module attributes (resolved via getattr, so spies
    see the delegation); `max_pending` None disables shedding."""

    name: str
    route: str = "route_least_loaded"
    next_waiting: str = "next_waiting_fcfs"
    preempt: bool = False
    max_pending: Optional[int] = None


POLICIES: Dict[str, PolicySpec] = {
    "least_loaded": PolicySpec("least_loaded"),
    "affinity": PolicySpec("affinity", route="route_affinity"),
    "ttft_tpot": PolicySpec("ttft_tpot", route="route_ttft_tpot"),
    "fair_tenant": PolicySpec(
        "fair_tenant", next_waiting="next_waiting_fair_tenant"),
    "priority_preempt": PolicySpec("priority_preempt", preempt=True),
}

# FleetCluster's default
DEFAULT_ROUTE_POLICY = "least_loaded"
