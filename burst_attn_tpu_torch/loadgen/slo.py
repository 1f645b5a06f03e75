"""SLO evaluation from merged obs exports + replay outcomes (port of
burst_attn_tpu/loadgen/slo.py; it reads the port's engines' histograms
`serve.ttft_s` / `serve.token_latency_s` and `admission.RejectReason`).

The serve SLOs:

  ttft_p50_s / ttft_p99_s          time-to-first-token quantiles, from the
                                   `serve.ttft_s` histogram
  token_latency_p50_s / _p99_s     per-token latency quantiles, from
                                   `serve.token_latency_s`
  throughput_tokens_per_s          every generated token (counter) / window
  goodput_tokens_per_s             tokens of COMPLETED requests / window —
                                   tokens burned on requests that never
                                   finished (killed worker, shed after
                                   partial work) do not count
  shed_rate                        shed decisions / submit attempts

Quantiles come from histogram BUCKETS, not raw samples — the merged
multi-process export is the only thing that exists after a worker dies,
so the SLO layer reads exactly what `obs --merge` emits (bucket_counts
are per-bin, the `+Inf` overflow falls back to the observed max: the
honest bound when the tail escaped the bins).  Two schemas are handled:
export records (`bucket_edges`/`bucket_counts` lists) and live
`Histogram.get()` snapshots (`buckets` dict), the latter as before/after
window deltas so benches can scope to a measurement window.

`Objectives` + `evaluate` turn a report into a typed pass/fail with
human-readable violations.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..admission import RejectReason

# reason labels that count as LOAD SHED (retryable) rather than
# malformed-request rejection — derived from the enum, never restated
SHED_REASONS = frozenset(r.value for r in RejectReason if r.retryable)


def quantile_from_record(rec: dict, q: float) -> float:
    """Quantile from ONE merged-export histogram record
    (`bucket_edges` + per-bin `bucket_counts` + `overflow`).  Returns the
    upper edge of the bin where the cumulative count crosses q; overflow
    mass falls back to the record's `max`."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"q must be in (0, 1], got {q}")
    edges = rec.get("bucket_edges") or []
    counts = rec.get("bucket_counts") or []
    overflow = rec.get("overflow", 0)
    total = sum(counts) + overflow
    if total <= 0:
        return float(rec.get("max", 0.0) or 0.0)
    need, seen = q * total, 0
    for edge, count in zip(edges, counts):
        seen += count
        if seen >= need:
            return float(edge)
    return float(rec.get("max", 0.0) or 0.0)


def quantile_from_window(before: dict, after: dict, q: float) -> float:
    """Quantile of the observations that landed BETWEEN two
    `Histogram.get()` snapshots (`buckets` dict keyed by upper edge,
    "+Inf" = overflow)."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"q must be in (0, 1], got {q}")
    db = dict(before.get("buckets") or {})
    deltas = [(edge, count - db.get(edge, 0))
              for edge, count in (after.get("buckets") or {}).items()]
    finite = sorted(((float(e), d) for e, d in deltas if e != "+Inf"),
                    key=lambda ed: ed[0])
    overflow = sum(d for e, d in deltas if e == "+Inf")
    total = sum(d for _, d in finite) + overflow
    if total <= 0:
        return float(after.get("max", 0.0) or 0.0)
    need, seen = q * total, 0
    for edge, d in finite:
        seen += d
        if seen >= need:
            return edge
    return float(after.get("max", 0.0) or 0.0)


def find_metric(metrics: Sequence[dict], name: str,
                kind: Optional[str] = None) -> List[dict]:
    """All merged-export records for one metric name (label children of a
    counter each appear as their own record)."""
    return [rec for rec in metrics
            if rec.get("name") == name
            and (kind is None or rec.get("kind") == kind)]


def counter_total(metrics: Sequence[dict], name: str,
                  label: Optional[Tuple[str, frozenset]] = None) -> int:
    """Sum a counter's children; `label=("reason", {"queue-full", ...})`
    restricts to children whose label value is in the set."""
    total = 0
    for rec in find_metric(metrics, name, kind="counter"):
        labels = rec.get("labels") or {}
        if label is not None:
            key, allowed = label
            if labels.get(key) not in allowed:
                continue
        total += int(rec.get("value", 0))
    return total


def recovery_stats(recovery_s: Sequence[float]) -> Dict[str, object]:
    """Per-fault recovery-span stats (`ClusterReport.recovery_s()` — the
    virtual seconds from each fault to its last recovered completion).
    Nearest-rank quantiles over the RAW samples: recovery spans come from
    the router's fault ledger, not from histogram buckets, and a fault
    schedule has few events — bucketing would only lose the tail."""
    samples = sorted(float(s) for s in recovery_s)
    out: Dict[str, object] = {"recovery_count": len(samples)}
    if not samples:
        out.update({"recovery_p50_s": 0.0, "recovery_p99_s": 0.0,
                    "recovery_max_s": 0.0})
        return out
    n = len(samples)
    for q in (0.50, 0.99):
        idx = min(n - 1, max(0, int(-(-q * n // 1)) - 1))  # ceil(q*n) - 1
        out[f"recovery_p{int(q * 100)}_s"] = samples[idx]
    out["recovery_max_s"] = samples[-1]
    return out


def compute_slo(metrics: Sequence[dict], *, duration_s: float,
                completed_tokens: Optional[int] = None,
                n_done: Optional[int] = None,
                n_rejected: Optional[int] = None,
                recovery_s: Optional[Sequence[float]] = None
                ) -> Dict[str, object]:
    """One SLO report from a merged metrics view (`obs --merge` output or
    `aggregate.merge_files(...)[0]`).

    `duration_s` is the measurement window the rates divide by — VIRTUAL
    trace seconds when the caller replayed at a speed factor (rates then
    describe the modeled workload, invariant to replay speed).  The
    caller supplies completion-side numbers the metrics cannot know:
    `completed_tokens`/`n_done` come from replay outcomes (goodput counts
    only finished requests — a killed worker's partial tokens are not
    good work)."""
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    report: Dict[str, object] = {"duration_s": duration_s}
    for short, name in (("ttft", "serve.ttft_s"),
                        ("token_latency", "serve.token_latency_s")):
        recs = find_metric(metrics, name, kind="histogram")
        count = sum(int(r.get("count", 0)) for r in recs)
        report[f"{short}_count"] = count
        for q in (0.50, 0.99):
            key = f"{short}_p{int(q * 100)}_s"
            if len(recs) == 1:
                report[key] = quantile_from_record(recs[0], q)
            elif not recs or not count:
                report[key] = 0.0
            else:
                # edge-mismatched children survived the merge un-added
                # (mixed binaries); the max child quantile is the honest
                # conservative read
                report[key] = max(quantile_from_record(r, q) for r in recs)
    n_tokens = counter_total(metrics, "serve.tokens_generated")
    submitted = counter_total(metrics, "serve.requests_submitted")
    shed = counter_total(metrics, "serve.requests_rejected",
                         label=("reason", SHED_REASONS))
    invalid = counter_total(metrics, "serve.requests_rejected") - shed
    attempts = submitted + shed + invalid
    report.update({
        "tokens_generated": n_tokens,
        "throughput_tokens_per_s": n_tokens / duration_s,
        "requests_submitted": submitted,
        "requests_retired": counter_total(metrics, "serve.requests_retired"),
        "shed_decisions": shed,
        "invalid_rejections": invalid,
        "shed_rate": shed / attempts if attempts else 0.0,
    })
    if completed_tokens is not None:
        report["completed_tokens"] = int(completed_tokens)
        report["goodput_tokens_per_s"] = completed_tokens / duration_s
    if n_done is not None:
        report["n_done"] = int(n_done)
    if n_rejected is not None:
        report["n_rejected"] = int(n_rejected)
    if recovery_s is not None:
        report.update(recovery_stats(recovery_s))
    return report


@dataclass(frozen=True)
class Objectives:
    """SLO targets; None disables that check."""

    max_ttft_p99_s: Optional[float] = None
    max_token_p99_s: Optional[float] = None
    min_goodput_tokens_per_s: Optional[float] = None
    max_shed_rate: Optional[float] = None


def evaluate(report: Dict[str, object],
             objectives: Objectives) -> Tuple[bool, List[str]]:
    """(ok, violations) — each violation names the SLO, the observed
    value, and the bound, ready for a test assertion or a CI log."""
    checks = (
        ("ttft_p99_s", objectives.max_ttft_p99_s, "<="),
        ("token_latency_p99_s", objectives.max_token_p99_s, "<="),
        ("goodput_tokens_per_s", objectives.min_goodput_tokens_per_s, ">="),
        ("shed_rate", objectives.max_shed_rate, "<="),
    )
    violations = []
    for key, bound, sense in checks:
        if bound is None:
            continue
        value = report.get(key)
        if value is None:
            violations.append(f"{key}: objective set ({sense} {bound:g}) "
                              "but the report carries no value")
            continue
        ok = value <= bound if sense == "<=" else value >= bound
        if not ok:
            violations.append(f"{key}: {float(value):.6g} violates "
                              f"{sense} {bound:g}")
    return (not violations), violations


def format_slo(report: Dict[str, object]) -> str:
    """Human-readable one-per-line rendering (CLI / bench logs)."""
    order = ("duration_s", "ttft_p50_s", "ttft_p99_s",
             "token_latency_p50_s", "token_latency_p99_s",
             "throughput_tokens_per_s", "goodput_tokens_per_s",
             "completed_tokens", "tokens_generated", "requests_submitted",
             "requests_retired", "n_done", "n_rejected", "shed_decisions",
             "invalid_rejections", "shed_rate", "recovery_count",
             "recovery_p50_s", "recovery_p99_s", "recovery_max_s")
    lines = []
    for key in order:
        if key in report:
            v = report[key]
            lines.append(f"  {key:<26} "
                         + (f"{v:.6g}" if isinstance(v, float) else str(v)))
    for key in sorted(set(report) - set(order)):
        lines.append(f"  {key:<26} {report[key]}")
    return "\n".join(lines)
