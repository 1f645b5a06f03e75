"""burst_attn_tpu_torch.obs: metrics, spans, logging, request tracing and
ring telemetry (port of burst_attn_tpu/obs; the port keeps its own copy
and imports nothing of that package).

  * `registry` - per-process counters / gauges / fixed-bucket histograms
    (thread-safe, host-only), with JSONL and Prometheus-text exporters.
  * `spans` - structured span tracer (context manager + decorator,
    monotonic clocks, parent/child nesting, thread-safe) that doubles as a
    `torch.profiler.record_function` range; a no-op while a CUDA graph is
    being captured.
  * `logs` - the obs logger (records counted in the registry) and
    `safe_warn` for teardown paths.
  * `trace` - per-request causal timelines, off by default.
  * `devstats` - the ring's device-side telemetry (`DevStats`).
  * CLI - `python -m burst_attn_tpu_torch.obs [--json|--prom|--merge|
    --trace|--waterfall]` renders a report from a JSONL export (the
    runner's `--obs-export results/obs.jsonl`, or `export_jsonl`); it
    reads the JAX package's exports too (same schema).

Metric catalog and naming conventions: docs/observability.md; the port
emits the same names and labels.

Capture-safety contract: no registry, span or trace call may run inside
a captured CUDA graph (it would run once, at capture, and never at
replay).  Instrumentation lives at host boundaries: dispatch wrappers,
engine loops (the pipelined engine counts its ticks where the deferred
readback lands), harnesses.
"""

import collections
import os

from . import registry as _registry_mod  # noqa: F401
from .registry import (
    Counter, Gauge, Histogram, Registry, LATENCY_BUCKETS_S,
    default_registry,
)
from .spans import (
    Span, StepTimer, annotate, completed_spans, current_span, reset_spans,
    span, span_records, traced,
)
from .logs import dropped_messages, get_logger, safe_warn
# request tracing: the submodule import keeps span-vs-trace naming
# explicit at call sites (`trace.record_span`)
from . import trace
from .trace import TraceContext
from . import devstats
from .devstats import DevStats


def counter(name: str, help: str = "") -> Counter:
    """Get-or-create a counter in the default registry."""
    return default_registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return default_registry().gauge(name, help)


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    return default_registry().histogram(name, help, buckets=buckets)


def snapshot():
    """Every metric child in the default registry as JSON-able dicts."""
    return default_registry().snapshot()


def to_prometheus() -> str:
    return default_registry().to_prometheus()


def counter_values() -> "collections.Counter":
    """Every counter child of the default registry as {"name{k=v,...}":
    value}, labels sorted by key (the port's flat view; a missing key reads
    0)."""
    out = collections.Counter()
    for rec in snapshot():
        if rec["kind"] == "counter":
            lab = ",".join(f"{k}={v}"
                           for k, v in sorted(rec["labels"].items()))
            out[f"{rec['name']}{{{lab}}}" if lab else rec["name"]] = \
                rec["value"]
    return out


def counter_deltas(before) -> "collections.Counter":
    """The counters that moved since `before` (an earlier counter_values()),
    as {"name{k=v,...}": delta}; a missing key reads 0."""
    out = collections.Counter()
    for key, v in counter_values().items():
        if v != before.get(key, 0.0):
            out[key] = v - before.get(key, 0.0)
    return out


def _process_index() -> int:
    """This process's index in a multi-process job: torch.distributed's
    rank when a process group is up, else RANK from the environment, else
    0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 - no process group == process 0
        pass
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0


def export_jsonl(path: str) -> str:
    """Append a full snapshot (metrics + completed spans + traces) to
    `path`, fsynced, tagged with this process's `process_index` so
    per-process files merge cleanly (`python -m burst_attn_tpu_torch.obs
    --merge`)."""
    extra = (span_records() + trace.trace_records()
             + trace.exemplar_records())
    return default_registry().export_jsonl(path,
                                           extra_records=extra,
                                           process_index=_process_index())


def reset() -> None:
    """Clear the default registry, span and trace buffers (tests only)."""
    default_registry().reset()
    reset_spans()
    trace.reset_traces()


__all__ = [
    "Counter", "DevStats", "Gauge", "Histogram", "Registry", "Span",
    "StepTimer", "LATENCY_BUCKETS_S", "TraceContext", "annotate",
    "completed_spans", "counter", "counter_deltas", "counter_values",
    "current_span", "default_registry",
    "devstats", "dropped_messages", "export_jsonl", "gauge", "get_logger",
    "histogram", "reset", "reset_spans", "safe_warn", "snapshot", "span",
    "span_records", "to_prometheus", "trace", "traced",
]
