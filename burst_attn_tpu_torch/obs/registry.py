"""Metrics registry: counters, gauges, fixed-bucket histograms (a copy of
burst_attn_tpu/obs/registry.py; the port imports nothing of that package).

Host-side only, by design.  Every update is a lock-guarded float op on the
Python heap — safe to call from the serving loop, the training loop, loader
threads, and trace-time dispatch code, and cheap enough (sub-microsecond)
that instrumenting a hot host path costs nothing against a device step.
Nothing here may ever touch a device: keeping the registry dumb is what
makes "no registry call inside a captured CUDA graph" easy to keep (an
update there would run once, at capture, never at replay).

Aggregation model: one `Registry` per process (the module default is what
the instrumented subsystems share); multi-process runs export per-process
JSONL files and the CLI merges them.  Counters and gauges fan out by label
set (sorted key/value tuples), like Prometheus children.

Counter semantics note for dispatch instrumentation (parallel/burst.py):
the port runs eagerly, so the dispatch counters advance once per call (the
JAX package's advance once per compiled program; docs/observability.md
names the per-trace entries).

Exporters:
  * `to_prometheus()`  — Prometheus text exposition format (counters,
    gauges, cumulative histogram buckets with `le` labels).
  * `export_jsonl(path)` — append a full snapshot, one JSON object per
    metric child plus a `meta` header, flushed AND fsynced so a killed run
    (driver timeout, SIGKILL) keeps everything exported before the kill.
"""

import bisect
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

# Default histogram buckets: latency-shaped, 100 us .. 60 s.  Fixed at
# construction — observations above the last edge land in the implicit
# +Inf overflow bucket, never resize anything.
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _lkey(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _ldict(key: LabelKey) -> Dict[str, str]:
    return dict(key)


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def _records(self) -> List[dict]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotone float counter with optional labels: `c.inc(2, path="fused")`."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        key = _lkey(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + n

    def get(self, **labels) -> float:
        with self._lock:
            return self._vals.get(_lkey(labels), 0.0)

    def total(self) -> float:
        """Sum over every label child."""
        with self._lock:
            return sum(self._vals.values())

    def _records(self):
        with self._lock:
            return [{"kind": self.kind, "name": self.name,
                     "labels": _ldict(k), "value": v}
                    for k, v in sorted(self._vals.items())]


class Gauge(_Metric):
    """Last-write-wins float gauge (queue depth, occupancy, rates)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: Dict[LabelKey, float] = {}

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._vals[_lkey(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _lkey(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)

    def get(self, **labels) -> float:
        with self._lock:
            return self._vals.get(_lkey(labels), 0.0)

    def _records(self):
        with self._lock:
            return [{"kind": self.kind, "name": self.name,
                     "labels": _ldict(k), "value": v}
                    for k, v in sorted(self._vals.items())]


class _HistChild:
    __slots__ = ("counts", "overflow", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.overflow = 0
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")


class Histogram(_Metric):
    """Fixed-bucket histogram.  Bucket edges are upper bounds with `<=`
    (Prometheus `le`) semantics: a value exactly on an edge counts in that
    edge's bucket; values above the last edge go to the +Inf overflow."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help)
        edges = tuple(buckets) if buckets is not None else LATENCY_BUCKETS_S
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(
                f"histogram {name}: buckets must be strictly increasing, "
                f"got {edges}")
        self.buckets = tuple(float(e) for e in edges)
        self._children: Dict[LabelKey, _HistChild] = {}

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        key = _lkey(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _HistChild(len(self.buckets))
            # first edge >= v (le semantics); past the end -> overflow
            i = bisect.bisect_left(self.buckets, v)
            if i < len(self.buckets):
                child.counts[i] += 1
            else:
                child.overflow += 1
            child.sum += v
            child.count += 1
            child.min = min(child.min, v)
            child.max = max(child.max, v)

    def get(self, **labels) -> dict:
        """Snapshot of one child: count/sum/min/max + per-bucket counts
        (NON-cumulative, keyed by upper edge; "+Inf" is the overflow)."""
        with self._lock:
            child = self._children.get(_lkey(labels))
            if child is None:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "buckets": {}}
            buckets = {repr(e): c for e, c in zip(self.buckets, child.counts)
                       if c}
            if child.overflow:
                buckets["+Inf"] = child.overflow
            return {"count": child.count, "sum": child.sum,
                    "min": child.min, "max": child.max, "buckets": buckets}

    def _records(self):
        with self._lock:
            out = []
            for key, child in sorted(self._children.items()):
                out.append({
                    "kind": self.kind, "name": self.name,
                    "labels": _ldict(key),
                    "count": child.count, "sum": child.sum,
                    "min": child.min, "max": child.max,
                    "bucket_edges": list(self.buckets),
                    "bucket_counts": list(child.counts),
                    "overflow": child.overflow,
                })
            return out


_PROM_SAFE = str.maketrans({".": "_", "-": "_", "/": "_"})


def prom_name(name: str) -> str:
    """`serve.ttft_s` -> `burst_serve_ttft_s` (exposition-format safe)."""
    return "burst_" + name.translate(_PROM_SAFE)


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Registry:
    """Named metrics, get-or-create.  Re-requesting a name returns the same
    object; a kind mismatch (histogram where a counter lives) raises —
    silent shadowing would split a metric across two objects."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def reset(self) -> None:
        """Drop every metric (tests; a long-lived server never calls this)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> List[dict]:
        """All metric children as plain JSON-able dicts."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: List[dict] = []
        for m in metrics:
            out += m._records()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (cumulative histogram buckets)."""
        lines: List[str] = []
        for rec in self.snapshot():
            name = prom_name(rec["name"])
            if rec["kind"] in ("counter", "gauge"):
                lines.append(f"# TYPE {name} {rec['kind']}")
                lines.append(
                    f"{name}{_prom_labels(rec['labels'])} {rec['value']:g}")
                continue
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for edge, cnt in zip(rec["bucket_edges"], rec["bucket_counts"]):
                cum += cnt
                le = 'le="%g"' % edge
                lines.append(
                    f"{name}_bucket{_prom_labels(rec['labels'], le)} {cum}")
            cum += rec["overflow"]
            inf = 'le="+Inf"'
            lines.append(
                f"{name}_bucket{_prom_labels(rec['labels'], inf)} {cum}")
            lines.append(f"{name}_sum{_prom_labels(rec['labels'])}"
                         f" {rec['sum']:g}")
            lines.append(f"{name}_count{_prom_labels(rec['labels'])}"
                         f" {rec['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_jsonl(self, path: str, extra_records: Sequence[dict] = (),
                     process_index: Optional[int] = None) -> str:
        """Append a full snapshot to `path` (one JSON object per line,
        `meta` header first), fsynced before returning — a run killed right
        after export still leaves a complete, parseable file.

        `process_index`: multi-host process label written into the meta
        header (the CLI `--merge` reader keys per-process states on it);
        the registry itself stays device-free — obs.export_jsonl fills
        it in."""
        records = self.snapshot()
        meta = {
            "kind": "meta",
            "ts_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "pid": os.getpid(),
            "n_records": len(records) + len(extra_records),
        }
        if process_index is not None:
            meta["process_index"] = int(process_index)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps(meta) + "\n")
            for rec in records:
                f.write(json.dumps(rec) + "\n")
            for rec in extra_records:
                f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return path


# the per-process default registry every instrumented subsystem shares
_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT
