"""Open-loop trace replay against one serve engine + the token oracle
(port of burst_attn_tpu/loadgen/driver.py).

The driver is the bridge between a Trace (virtual arrival times) and an
engine (the port's RaggedServeEngine or models/serve.py's ServeEngine —
anything with `try_submit` / `step` / `pending` / `live`).  Replay is OPEN-LOOP:
arrivals fire at `t_arrival / speed` wall seconds after replay start
whether or not the engine has kept up — the workload does not slow down
because the server is struggling, which is exactly the regime where
admission control earns its keep.  Retryable sheds (pool-exhausted,
queue-full, admission-*) go to a virtual-time retry queue with backoff;
non-retryable rejections (poison requests) are terminal outcomes.

`oracle_replay` is the correctness reference: the same trace served
sequentially, one request at a time, on a fresh engine with no load
shedding — in fp32 greedy decode is batch-invariant (token-exact however
requests are batched, chunked, or speculated), so any replay of the trace
that completes a request must emit EXACTLY the oracle's tokens for it.
(In bf16 the batch changes the kernels' rounding, and a near-tie argmax
may flip: bf16 replays are held to the near-tie bar, not to equality.)
`diff_tokens` turns that into the zero-token-corruption assertion the
cluster harness and tests gate on.
"""

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from .trace import Trace

# outcome.status vocabulary
DONE = "done"            # completed; tokens are the engine's output
REJECTED = "rejected"    # non-retryable typed rejection (poison et al.)
SHED = "shed"            # retryable sheds exhausted max_retries


@dataclass(frozen=True)
class RetryBackoff:
    """Seeded exponential backoff with jitter, in VIRTUAL seconds.

    A constant backoff resubmits an entire shed wave in lockstep — every
    rejected request comes back at the same instant and is shed again
    (retry storm).  `delay(rid, attempt)` decorrelates them: the base
    delay doubles per attempt (capped), and a per-(seed, rid, attempt)
    jitter in [1-jitter, 1+jitter] spreads requests apart.  Fully
    deterministic: the same seed gives the same schedule, different rids
    get independent streams (numpy's seed-sequence spawning — no shared
    RNG state, so the schedule is independent of call order)."""

    base_s: float = 0.05
    cap_s: float = 2.0
    factor: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.base_s <= 0:
            raise ValueError(f"base_s must be > 0, got {self.base_s}")
        if self.cap_s < self.base_s:
            raise ValueError(f"cap_s {self.cap_s} < base_s {self.base_s}")
        if self.factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {self.factor}")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")

    def delay(self, rid: int, attempt: int) -> float:
        """Virtual-seconds delay before retry number `attempt` (1-based)
        of request `rid`."""
        if attempt < 1:
            raise ValueError(f"attempt must be >= 1, got {attempt}")
        det = min(self.base_s * self.factor ** (attempt - 1), self.cap_s)
        u = np.random.default_rng(
            [int(self.seed), int(rid), int(attempt)]).random()
        return det * (1.0 + self.jitter * (2.0 * u - 1.0))


@dataclass
class Outcome:
    """What the replay ultimately did with one trace request."""

    rid: int
    kind: str
    status: str = DONE
    reason: Optional[str] = None      # RejectReason value when not DONE
    tokens: List[int] = field(default_factory=list)
    retries: int = 0                  # sheds absorbed before the outcome
    t_arrival: float = 0.0            # virtual seconds (from the trace)
    t_submit: Optional[float] = None  # virtual seconds at accepted submit
    t_done: Optional[float] = None    # virtual seconds at completion


@dataclass
class ReplayReport:
    """Replay outcomes plus the timing context SLO evaluation needs."""

    outcomes: Dict[int, Outcome]
    wall_s: float                     # real seconds the replay took
    speed: float                      # virtual seconds per wall second

    @property
    def duration_v(self) -> float:
        """Virtual span covered (last completion or arrival)."""
        ts = [o.t_done for o in self.outcomes.values() if o.t_done is not None]
        ts += [o.t_arrival for o in self.outcomes.values()]
        return max(ts, default=0.0)

    def by_status(self, status: str) -> List[Outcome]:
        return [o for o in self.outcomes.values() if o.status == status]

    @property
    def n_done(self) -> int:
        return len(self.by_status(DONE))

    @property
    def n_rejected(self) -> int:
        return len(self.by_status(REJECTED))

    @property
    def n_shed(self) -> int:
        return len(self.by_status(SHED))

    @property
    def completed_tokens(self) -> int:
        return sum(len(o.tokens) for o in self.by_status(DONE))

    def completed(self) -> Dict[int, List[int]]:
        """trace rid -> tokens for every completed request (the side the
        oracle diff compares)."""
        return {o.rid: o.tokens for o in self.by_status(DONE)}


def replay_trace(engine, trace: Trace, *, speed: float = 50.0,
                 retry_backoff_s: float = 0.05, max_retries: int = 200,
                 max_wall_s: float = 300.0,
                 backoff: Optional[RetryBackoff] = None) -> ReplayReport:
    """Replay `trace` open-loop against `engine` (already constructed —
    any admission policy / max_queue it carries is what gets exercised).

    `speed` maps virtual trace seconds to wall time (virtual = wall *
    speed), so a 5-virtual-second trace replays in ~0.1 wall seconds at
    the default; timestamps in the report stay in VIRTUAL seconds and are
    therefore speed-invariant.  Retry delays are virtual too: seeded
    exponential backoff + jitter (`backoff`, defaulting to a
    RetryBackoff seeded at `retry_backoff_s` base).
    """
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    bo = backoff if backoff is not None else RetryBackoff(
        base_s=retry_backoff_s, cap_s=max(retry_backoff_s * 40, 2.0))
    vocab = trace.vocab
    arrivals = sorted(trace.requests, key=lambda r: (r.t_arrival, r.rid))
    retry: List[tuple] = []           # (t_due_v, trace rid)
    by_rid = {r.rid: r for r in trace.requests}
    rid_map: Dict[int, int] = {}      # engine rid -> trace rid
    outcomes: Dict[int, Outcome] = {
        r.rid: Outcome(rid=r.rid, kind=r.kind, t_arrival=r.t_arrival)
        for r in trace.requests}

    def _submit(req, now_v: float) -> None:
        out = outcomes[req.rid]
        res = engine.try_submit(req.prompt(vocab), req.max_new_tokens)
        if res.ok:
            rid_map[res.rid] = req.rid
            out.status = DONE         # provisional; completion fills tokens
            out.reason = None
            out.t_submit = now_v
        elif res.retryable and out.retries < max_retries:
            out.retries += 1
            retry.append((now_v + bo.delay(req.rid, out.retries), req.rid))
        else:
            out.status = SHED if res.retryable else REJECTED
            out.reason = res.reason.value if res.reason else None

    t0 = time.perf_counter()
    i = 0
    while True:
        now_v = (time.perf_counter() - t0) * speed
        while i < len(arrivals) and arrivals[i].t_arrival <= now_v:
            _submit(arrivals[i], now_v)
            i += 1
        if retry:
            retry.sort()
            while retry and retry[0][0] <= now_v:
                _, rid = retry.pop(0)
                _submit(by_rid[rid], now_v)
        if engine.pending or engine.live:
            for erid, toks in engine.step():
                out = outcomes[rid_map.pop(erid)]
                out.tokens = [int(t) for t in toks]
                out.t_done = (time.perf_counter() - t0) * speed
        elif i < len(arrivals) or retry:
            # open-loop gap: nothing due yet, nothing in flight
            time.sleep(0.001)
        else:
            break
        if time.perf_counter() - t0 > max_wall_s:
            raise RuntimeError(
                f"replay exceeded max_wall_s={max_wall_s:g}: "
                f"{i}/{len(arrivals)} arrived, {len(retry)} retrying, "
                f"pending={engine.pending}, live={engine.live}")
    return ReplayReport(outcomes=outcomes,
                        wall_s=time.perf_counter() - t0, speed=speed)


def oracle_replay(trace: Trace,
                  make_engine: Callable[[], object]) -> Dict[int, List[int]]:
    """trace rid -> tokens, serving each servable request ALONE on a
    fresh engine from `make_engine` (built with no admission policy so
    nothing is shed).  This is the token-exactness reference: greedy
    decode is batch-invariant, so any engine/cluster replay that
    completes rid must produce exactly these tokens.  Poison requests
    that the engine rejects simply have no oracle entry."""
    eng = make_engine()
    vocab = trace.vocab
    out: Dict[int, List[int]] = {}
    for req in sorted(trace.requests, key=lambda r: r.rid):
        res = eng.try_submit(req.prompt(vocab), req.max_new_tokens)
        if not res.ok:
            continue
        done = eng.run()
        out[req.rid] = [int(t) for t in done[res.rid]]
    return out


def diff_tokens(completed: Dict[int, List[int]],
                oracle: Dict[int, List[int]]) -> List[str]:
    """Zero-token-corruption check: every completed request's tokens must
    equal the oracle's, byte for byte.  Returns human-readable mismatch
    lines (empty = exact); completing a request the oracle could not
    serve is itself a mismatch."""
    bad = []
    for rid in sorted(completed):
        if rid not in oracle:
            bad.append(f"rid {rid}: completed but the oracle rejected it")
        elif completed[rid] != oracle[rid]:
            want, got = oracle[rid], completed[rid]
            n = next((k for k, (a, b) in enumerate(zip(want, got)) if a != b),
                     min(len(want), len(got)))
            bad.append(f"rid {rid}: tokens diverge at position {n}: "
                       f"oracle {want[n:n + 4]}... vs replay {got[n:n + 4]}..."
                       f" (lengths {len(want)} vs {len(got)})")
    return bad


def assert_token_exact(completed: Dict[int, List[int]],
                       oracle: Dict[int, List[int]]) -> None:
    bad = diff_tokens(completed, oracle)
    if bad:
        raise AssertionError(
            "token corruption: replay diverged from the single-process "
            "oracle on " + f"{len(bad)} request(s):\n  " + "\n  ".join(bad))
