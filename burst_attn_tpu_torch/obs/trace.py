"""Distributed request tracing: per-request causal timelines (a copy of
burst_attn_tpu/obs/trace.py).

A `TraceContext` is the identity a request carries from submission to
retirement: a `trace_id` shared by every span in the request's tree, the
recording site's `span_id`, and a `parent_id` linking the span upward.
The context crosses process boundaries as a compact wire form
(`to_wire()` / `from_wire()`) riding as an OPTIONAL trailing element on
fleet messages — absent entirely when tracing is off, so an untraced
run's frames encode byte-identical to a build without this module.

Recording sits under the same capture-safety contract as spans.py:
every record call is a guarded no-op while the calling thread's stream
is capturing a CUDA graph (a record there would run once, at capture).
Tracing is OFF by default; every instrumentation site checks `enabled()`
before doing any work (the serve tick's device work is untouched either
way — only host clocks are read).

Clocks.  Real engines record absolute `time.perf_counter()` timestamps:
CLOCK_MONOTONIC is system-wide on Linux, so spans recorded by the
router, prefill and decode processes of a same-host fleet share one
timeline and merge into a single causal tree (`obs --merge` joins by
trace_id).  The fleet simulator records its virtual event clock with
`clock="virtual"` — same record schema, so a policy's simulated
waterfall diffs directly against a real `--fleet` run.

Sampling is tail-based and bounded.  All spans land in a bounded ring
(MAX_TRACE_RECORDS); at export time a full tree is kept only when its
request's TTFT ranks in the top TAIL_KEEP observed so far (the tail the
p99 argues about) or its trace_id head-samples in deterministically
(1/HEAD_SAMPLE_N, hash-based — no RNG state).  `note_ttft` also pins the
worst trace per latency bucket as an OpenMetrics exemplar, so
`obs --prom` can deep-link `serve_ttft_s` buckets to actual waterfalls.

`ttft_breakdown` is the critical-path analyzer: it decomposes a tree's
TTFT into contiguous phase contributions (uncovered time is an explicit
"gap" phase), so the phases sum to the TTFT by construction.
"""

import collections
import itertools
import os
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .registry import LATENCY_BUCKETS_S, default_registry
from .spans import _tracing

# bounded buffers: a long-serving process cannot grow without limit
MAX_TRACE_RECORDS = 8192
TAIL_KEEP = 64          # full trees kept for the TAIL_KEEP worst TTFTs
HEAD_SAMPLE_N = 8       # plus a deterministic 1/N head sample of the rest

_records = collections.deque(maxlen=MAX_TRACE_RECORDS)
_ttfts: Dict[str, float] = {}          # trace_id -> noted TTFT (bounded below)
_exemplars: Dict[tuple, dict] = {}     # (metric, le) -> worst exemplar record
_lock = threading.Lock()
_seq = itertools.count(1)
_enabled = False


def enable(on: bool = True) -> None:
    """Flip the module-wide tracing switch (default OFF — every
    instrumentation site checks `enabled()` first, so the feature costs
    nothing while this is False)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


@dataclass(frozen=True)
class TraceContext:
    """The identity a request carries: which tree (`trace_id`), which
    span records made under this context hang from (`span_id`), and what
    that span's own parent is (`parent_id`, None at the root)."""

    trace_id: str
    span_id: str = "request"
    parent_id: Optional[str] = None
    clock: str = "wall"

    def child(self, span_id: str) -> "TraceContext":
        """Context for recording under the span named `span_id`."""
        return TraceContext(self.trace_id, span_id, self.span_id, self.clock)

    def to_wire(self) -> List[str]:
        """Compact wire form for transport payloads (msgpack/JSON-able)."""
        return [self.trace_id, self.span_id]

    @staticmethod
    def from_wire(wire) -> Optional["TraceContext"]:
        """Inverse of `to_wire`; None on a missing/garbled field (a peer
        without tracing simply never attaches one)."""
        if not wire or not isinstance(wire, (list, tuple)) or len(wire) < 2:
            return None
        try:
            return TraceContext(str(wire[0]), str(wire[1]))
        except Exception:  # noqa: BLE001 — never let telemetry break serving
            return None


def start_request(rid, prefix: str = "serve",
                  clock: str = "wall") -> Optional[TraceContext]:
    """Root context for a newly submitted request, or None when tracing
    is off (callers keep a single `if tc is not None` guard).  The
    trace_id embeds the pid and a process-local sequence number so
    concurrent engines and fleet processes never collide."""
    if not _enabled:
        return None
    return TraceContext(f"{prefix}-{os.getpid()}-r{rid}-{next(_seq)}",
                        "request", None, clock)


def record_span(tc: Optional[TraceContext], name: str, start_s: float,
                end_s: float, root: bool = False, **attrs) -> None:
    """Record one completed span of `tc`'s tree with EXPLICIT times (the
    caller read the clock, or owns a virtual one — the simulator records
    event times that were never wall instants).  `root=True` records the
    context's own span (parent `tc.parent_id`); otherwise the span is a
    child of `tc.span_id` with a deterministic name-based span_id —
    lifecycle phase names are unique within a request's tree, so ids
    need no coordination across processes.

    No-op when tracing is off, `tc` is None, or the calling thread is
    capturing a CUDA graph (same degrade as spans.span)."""
    if not _enabled or tc is None or _tracing():
        return
    rec = {"kind": "trace", "trace_id": tc.trace_id,
           "span_id": tc.span_id if root else name,
           "parent_id": tc.parent_id if root else tc.span_id,
           "name": name, "start_s": round(float(start_s), 9),
           "duration_s": round(max(0.0, float(end_s) - float(start_s)), 9),
           "clock": tc.clock, "attrs": attrs}
    with _lock:
        _records.append(rec)


def marker(tc: Optional[TraceContext], name: str, t_s: float,
           **attrs) -> None:
    """Zero-duration event span (e.g. the first-token instant)."""
    record_span(tc, name, t_s, t_s, **attrs)


class _SpanCtx:
    """Handle from `span()`: wall-clocked child span as a with-block."""

    __slots__ = ("_tc", "_name", "_attrs", "_t0")

    def __init__(self, tc, name, attrs):
        self._tc, self._name, self._attrs = tc, name, attrs
        self._t0 = None

    def __enter__(self):
        if _enabled and self._tc is not None and not _tracing():
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            record_span(self._tc, self._name, self._t0,
                        time.perf_counter(), **self._attrs)
        return False


def span(tc: Optional[TraceContext], name: str, **attrs) -> _SpanCtx:
    """`with trace.span(tc, "fleet.prefill"): ...` — wall-clock child
    span; a no-op context manager when tracing is off or tc is None."""
    return _SpanCtx(tc, name, attrs)


def note_ttft(tc_or_id, ttft_s: float, metric: str = "serve.ttft_s") -> None:
    """Register a request's measured TTFT with the sampler: ranks the
    trace for tail retention and pins it as the exemplar of `metric`'s
    latency bucket when it is the worst seen there (last-wins on ties —
    fresher waterfalls beat stale ones)."""
    if not _enabled or tc_or_id is None or _tracing():
        return
    trace_id = getattr(tc_or_id, "trace_id", tc_or_id)
    ttft_s = float(ttft_s)
    edges = LATENCY_BUCKETS_S
    m = default_registry()._metrics.get(metric)  # no get-or-create
    if m is not None and getattr(m, "buckets", None):
        edges = m.buckets
    le = next((str(e) for e in edges if ttft_s <= e), "+Inf")
    with _lock:
        _ttfts[str(trace_id)] = ttft_s
        if len(_ttfts) > 4 * TAIL_KEEP:
            # bound the rank table: drop the fastest half, they can never
            # re-enter the kept tail
            for tid in sorted(_ttfts, key=_ttfts.get)[:2 * TAIL_KEEP]:
                del _ttfts[tid]
        have = _exemplars.get((metric, le))
        if have is None or ttft_s >= have["value"]:
            _exemplars[(metric, le)] = {"kind": "exemplar", "metric": metric,
                                        "le": le, "trace_id": str(trace_id),
                                        "value": ttft_s}


def publish_breakdown(phases: Dict[str, float],
                      metric: str = "serve.ttft_breakdown") -> None:
    """Feed a request's phase decomposition into the registry histogram
    `serve.ttft_breakdown{phase=...}` (host-side aggregate view of what
    the per-trace analyzer computes exactly)."""
    if _tracing():
        return
    hist = default_registry().histogram(metric)
    for phase, seconds in phases.items():
        hist.observe(max(0.0, float(seconds)), phase=phase)


def _kept_trace_ids() -> set:
    """Sampling policy at export time: the TAIL_KEEP worst TTFTs plus the
    deterministic head sample.  Traces with no noted TTFT yet (still in
    flight, or recorded by a stage that never sees first-token) are kept —
    dropping them would tear cross-process trees whose TTFT was noted by
    a DIFFERENT process (the router notes; workers just record spans)."""
    with _lock:
        tail = set(sorted(_ttfts, key=_ttfts.get, reverse=True)[:TAIL_KEEP])
        noted = set(_ttfts)
        seen = {r["trace_id"] for r in _records}
    head = {tid for tid in seen
            if zlib.crc32(tid.encode()) % HEAD_SAMPLE_N == 0}
    return tail | head | (seen - noted)


def trace_records() -> List[dict]:
    """Sampled trace records for export (joins spans.span_records() in
    `obs.export_jsonl`'s extra_records)."""
    if not _records:
        return []
    keep = _kept_trace_ids()
    with _lock:
        return [r for r in _records if r["trace_id"] in keep]


def exemplar_records() -> List[dict]:
    with _lock:
        return list(_exemplars.values())


def reset_traces() -> None:
    """Drop all trace state and disable tracing (tests)."""
    global _enabled
    with _lock:
        _records.clear()
        _ttfts.clear()
        _exemplars.clear()
    _enabled = False


def ttft_breakdown(spans: Sequence[dict]) -> Optional[dict]:
    """Critical-path decomposition of one trace tree's TTFT.

    `spans` is the tree's trace records (any order).  The root span
    (parent_id None) anchors t=0; the first-token instant is the end of
    the earliest span whose name ends in "first_token" (falling back to
    the root's end).  Each direct child of the root contributes its
    clipped, non-overlapping share of [root start, first token] walking
    left to right; uncovered time is the explicit "gap" phase — so the
    phases ALWAYS sum to the returned ttft_s exactly (the acceptance
    bar's "within 1%" is float-noise tolerance, not lost time).  Returns
    {"ttft_s", "phases", "clock"} or None when the tree has no root."""
    roots = [s for s in spans if s.get("parent_id") is None]
    if not roots:
        return None
    root = min(roots, key=lambda s: s["start_s"])
    t0 = root["start_s"]
    firsts = [s for s in spans if s["name"].endswith("first_token")]
    if firsts:
        ft = min(firsts, key=lambda s: s["start_s"])
        t_first = ft["start_s"] + ft["duration_s"]
    else:
        t_first = t0 + root["duration_s"]
    children = sorted(
        (s for s in spans
         if s.get("parent_id") == root["span_id"]
         and not s["name"].endswith("first_token")),
        key=lambda s: s["start_s"])
    phases: Dict[str, float] = {}
    cursor, gap = t0, 0.0
    for s in children:
        lo = max(s["start_s"], cursor)
        hi = min(s["start_s"] + s["duration_s"], t_first)
        if hi <= lo:
            continue
        gap += lo - cursor
        key = s["name"].rsplit(".", 1)[-1]
        phases[key] = phases.get(key, 0.0) + (hi - lo)
        cursor = hi
    gap += max(0.0, t_first - cursor)
    phases["gap"] = gap
    return {"ttft_s": t_first - t0, "phases": phases,
            "clock": root.get("clock", "wall")}
