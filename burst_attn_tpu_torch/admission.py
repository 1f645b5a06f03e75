"""Typed submission outcomes + SLO-gated admission control for the serve
engine.  A copy of burst_attn_tpu/admission.py (the port imports nothing
of the JAX package); keep the two in step.

A request ROUTER can tell pool pressure from queue pressure without
parsing messages:

  * `RejectReason` — one enum member per rejection label.  The enum VALUE
    is the label string the JAX package's `serve.requests_rejected`
    counter uses, so both packages speak the same names.
  * `InvalidRequest` / `LoadShed` — the typed exceptions `submit()`
    raises.  They subclass ValueError / RuntimeError respectively, so
    plain `except ValueError` callers keep working; new callers read
    `.reason` instead of parsing messages.
  * `SubmitResult` + `ServeEngine.try_submit()` — the non-raising
    surface a router wants: a request id on success, a typed reason (and
    a `retryable` bit: sheds clear, malformed never does) on rejection.
  * `AdmissionPolicy` — hysteresis load-shedding driven by live queue
    depth and pool occupancy.  The hard checks shed only at exhaustion
    (pool literally out of pages, queue literally full); the policy sheds
    EARLY — above a high-water mark — and keeps shedding until pressure
    falls back below a low-water mark, so a saturated engine drains
    instead of oscillating admit/shed at the cliff edge.  Pool pressure
    sheds before queue pressure.

Host-side only: admission decisions happen between device steps, exactly
like the page pool itself.
"""

import enum
from dataclasses import dataclass, field
from typing import Optional


class RejectReason(str, enum.Enum):
    """Why `submit()` refused a request.  Values ARE the
    `serve.requests_rejected{reason=…}` counter labels."""

    # malformed / permanently unservable (InvalidRequest — never retry)
    EMPTY_PROMPT = "empty-prompt"
    BAD_BUDGET = "bad-budget"
    TABLE_WIDTH = "table-width"
    POOL_SIZE = "pool-size"
    # transient load sheds (LoadShed — retry after backoff)
    POOL_EXHAUSTED = "pool-exhausted"
    QUEUE_FULL = "queue-full"
    ADMISSION_POOL = "admission-pool"
    ADMISSION_QUEUE = "admission-queue"

    def __str__(self) -> str:  # counter label / log friendly
        return self.value

    @property
    def retryable(self) -> bool:
        """Sheds clear when load drops; malformed requests never will."""
        return self in _RETRYABLE


_RETRYABLE = frozenset({
    RejectReason.POOL_EXHAUSTED, RejectReason.QUEUE_FULL,
    RejectReason.ADMISSION_POOL, RejectReason.ADMISSION_QUEUE,
})


class SubmitRejected(Exception):
    """Mixin base for typed submit() rejections; `.reason` is the enum."""

    def __init__(self, reason: RejectReason, message: str):
        super().__init__(message)
        self.reason = RejectReason(reason)


class InvalidRequest(SubmitRejected, ValueError):
    """Malformed / permanently unservable — retrying can never succeed."""


class LoadShed(SubmitRejected, RuntimeError):
    """Transient overload shed — retry once pressure drops."""


@dataclass(frozen=True)
class SubmitResult:
    """`try_submit()` outcome: `rid` on success, typed `reason` on
    rejection (plus the human-readable message for logs)."""

    rid: Optional[int] = None
    reason: Optional[RejectReason] = None
    message: str = ""

    @property
    def ok(self) -> bool:
        return self.rid is not None

    @property
    def retryable(self) -> bool:
        return self.reason is not None and self.reason.retryable


@dataclass
class AdmissionPolicy:
    """Hysteresis load shedding from live queue depth + pool occupancy.

    `decide()` is called by `submit()` with the same values the engine's
    gauges export (`serve.page_pool_occupancy` as a fraction of usable
    pages, `serve.queue_depth` as a count).  Each pressure axis carries a
    high/low water mark: shedding STARTS when the live value crosses the
    high mark and STOPS only when it falls back below the low mark — an
    engine at the cliff edge drains a real margin before re-admitting
    instead of flapping.  Pool pressure is evaluated (and shed) before
    queue pressure, extending the hard-shed ordering.

    Set a high mark to None to disable that axis.  One policy instance
    belongs to ONE engine (it carries hysteresis state).
    """

    pool_high: Optional[float] = 0.95
    pool_low: float = 0.80
    queue_high: Optional[int] = None
    queue_low: int = 0
    shed_pool: int = field(default=0, init=False)   # decisions, for tests
    shed_queue: int = field(default=0, init=False)
    _pool_shedding: bool = field(default=False, init=False)
    _queue_shedding: bool = field(default=False, init=False)

    def __post_init__(self):
        if self.pool_high is not None and not self.pool_low <= self.pool_high:
            raise ValueError(
                f"pool_low {self.pool_low} must be <= pool_high "
                f"{self.pool_high}")
        if (self.queue_high is not None
                and not self.queue_low <= self.queue_high):
            raise ValueError(
                f"queue_low {self.queue_low} must be <= queue_high "
                f"{self.queue_high}")

    def decide(self, *, queue_depth: int,
               pool_occupancy: float) -> Optional[RejectReason]:
        """Typed shed reason, or None to admit.  Updates hysteresis state."""
        if self.pool_high is not None:
            if self._pool_shedding:
                self._pool_shedding = pool_occupancy >= self.pool_low
            elif pool_occupancy >= self.pool_high:
                self._pool_shedding = True
            if self._pool_shedding:
                self.shed_pool += 1
                return RejectReason.ADMISSION_POOL
        if self.queue_high is not None:
            if self._queue_shedding:
                self._queue_shedding = queue_depth > self.queue_low
            elif queue_depth >= self.queue_high:
                self._queue_shedding = True
            if self._queue_shedding:
                self.shed_queue += 1
                return RejectReason.ADMISSION_QUEUE
        return None
