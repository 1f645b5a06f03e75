"""Structured span tracing for host-side phases (port of
burst_attn_tpu/obs/spans.py).

`span("serve.run")` / `@traced("eval")` wrap a block with:

  * a monotonic clock (`time.perf_counter`) whose duration feeds the
    registry histogram `span.<name>`, so the CLI report shows aggregate
    count/total/mean per span name with no extra bookkeeping;
  * parent/child nesting via a per-thread stack (each thread nests
    independently; completed spans land in one shared ring buffer under a
    lock);
  * a `torch.profiler.record_function`, so the same names appear in the
    port's profiler traces (the JAX package's xprof annotation).

Capture safety: while the calling thread's CUDA stream is capturing a
graph (serving/model.py's DecodeGraphs), a registry update or a clock read
would run once at capture and never at replay, so `span()` is a no-op
there: no clock, no registry, no profiler range.  This is the port's form
of the JAX package's "no-op under a jax trace"; instrumentation still
belongs at host boundaries, the degrade only makes a stray call harmless.

`StepTimer` and `annotate` live here; utils/profiling.py re-exports them.
"""

import collections
import contextlib
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .registry import default_registry

# completed spans, newest last; bounded so a long-serving process cannot
# grow without limit (aggregates live in the registry histograms forever)
MAX_SPANS = 4096
_completed = collections.deque(maxlen=MAX_SPANS)
_completed_lock = threading.Lock()
_ids = itertools.count(1)
_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _tracing() -> bool:
    """True while the calling thread's current CUDA stream captures a
    graph: spans and trace records must not read clocks or mutate the
    registry there.  False without CUDA (never initialized)."""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


@dataclass
class Span:
    """One completed span (what the exporter/CLI sees)."""

    name: str
    span_id: int
    parent_id: Optional[int]
    depth: int
    thread: str
    start_s: float          # perf_counter-based, comparable within-process
    duration_s: float
    attrs: Dict[str, object] = field(default_factory=dict)

    def record(self) -> dict:
        return {"kind": "span", "name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "depth": self.depth,
                "thread": self.thread, "start_s": round(self.start_s, 6),
                "duration_s": round(self.duration_s, 9),
                "attrs": self.attrs}


class _LiveSpan:
    """Handle yielded inside a `span()` block; `set(k, v)` attaches attrs."""

    __slots__ = ("name", "span_id", "parent_id", "depth", "attrs")

    def __init__(self, name, span_id, parent_id, depth):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.depth = depth
        self.attrs: Dict[str, object] = {}

    def set(self, key: str, value) -> None:
        self.attrs[key] = value


class _NoopSpan:
    __slots__ = ()
    name = None
    span_id = None
    parent_id = None
    depth = 0
    attrs: Dict[str, object] = {}

    def set(self, key: str, value) -> None:
        return None


_NOOP = _NoopSpan()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Context manager: time a host-side block as a named span.

        with span("serve.step", live=3) as sp:
            ...
            sp.set("admitted", 2)

    During CUDA-graph capture this is a no-op (see module docstring)."""
    if _tracing():
        yield _NOOP
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    live = _LiveSpan(name, next(_ids),
                     parent.span_id if parent else None, len(stack))
    live.attrs.update(attrs)
    stack.append(live)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield live
    finally:
        dur = time.perf_counter() - t0
        stack.pop()
        done = Span(name=name, span_id=live.span_id,
                    parent_id=live.parent_id, depth=live.depth,
                    thread=threading.current_thread().name,
                    start_s=t0, duration_s=dur, attrs=live.attrs)
        with _completed_lock:
            _completed.append(done)
        default_registry().histogram("span." + name).observe(dur)


def traced(name: Optional[str] = None):
    """Decorator form of `span`: `@traced("eval")` or bare `@traced()`
    (uses the function's qualname)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def current_span():
    """The innermost live span on this thread (None at top level)."""
    stack = _stack()
    return stack[-1] if stack else None


def completed_spans(limit: Optional[int] = None) -> List[Span]:
    """Most recent completed spans, oldest first (bounded by MAX_SPANS)."""
    with _completed_lock:
        out = list(_completed)
    return out[-limit:] if limit else out


def span_records(limit: Optional[int] = None) -> List[dict]:
    return [s.record() for s in completed_spans(limit)]


def reset_spans() -> None:
    """Drop the completed-span buffer (tests)."""
    with _completed_lock:
        _completed.clear()


def annotate(name: str):
    """Named range on the profiler timeline only (no clocks, no registry):
    the raw `torch.profiler.record_function`, for callers that want the
    profiler mark without obs state."""
    return torch.profiler.record_function(name)


def _tensors(x):
    """Every tensor inside nested tuples/lists/dicts."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class StepTimer:
    """Wall-clock step timer that waits for the step's device work at exit:

        with timer as t:
            state, metrics = step(state, batch)
            t.watch(metrics["loss"])

    `watch` names tensors of the step; exit synchronizes the CUDA devices
    they live on (CPU tensors need no wait).  Each completed step also
    feeds the registry histogram `span.step_timer`, so step times show up
    in obs exports beside explicit spans.
    """

    def __init__(self, metric: str = "step_timer"):
        self.times: List[float] = []
        self._metric = "span." + metric
        self._t0: Optional[float] = None
        self._watched = None

    def watch(self, *outputs):
        """Register the step's outputs; exit blocks until they are ready."""
        self._watched = outputs
        return outputs[0] if len(outputs) == 1 else outputs

    def __enter__(self):
        self._watched = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            if self._watched is None:
                raise RuntimeError(
                    "StepTimer: call t.watch(outputs) inside the block")
            for dev in {t.device for t in _tensors(self._watched)
                        if t.device.type == "cuda"}:
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - self._t0
            self.times.append(dt)
            default_registry().histogram(self._metric).observe(dt)
        self._watched = None
        return False

    def summary(self, skip_first: int = 1) -> dict:
        """Stats over recorded steps.  The first `skip_first` steps are
        dropped as warm-up unless that would drop every step; every field
        is always finite and `steps` says how many samples they cover."""
        ts = self.times[skip_first:] or self.times
        if not ts:
            return {"steps": 0, "mean_s": 0.0, "min_s": 0.0, "max_s": 0.0,
                    "p50_s": 0.0, "std_s": 0.0}
        mean = sum(ts) / len(ts)
        var = sum((t - mean) ** 2 for t in ts) / len(ts)  # 0.0 for 1 step
        return {"steps": len(ts), "mean_s": mean, "min_s": min(ts),
                "max_s": max(ts), "p50_s": sorted(ts)[len(ts) // 2],
                "std_s": var ** 0.5}
