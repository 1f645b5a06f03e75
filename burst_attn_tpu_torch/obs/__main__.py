"""obs CLI:  python -m burst_attn_tpu_torch.obs [--json] [--prom] [--file PATH]
                                   [--merge GLOB [--by-process]]
                                   [--trace] [--waterfall TRACE_ID]

A copy of burst_attn_tpu/obs/__main__.py: it reads the JSONL either
package writes (same schema).

Renders a report from a run's JSONL export (written by
`obs.export_jsonl`, which the training runner calls). A file may hold
several export snapshots (the exporter appends); the report shows each
metric's LAST exported state — i.e. the final state of the run — and
aggregates spans across snapshots.

`--merge GLOB` switches to the MULTI-PROCESS view: every matching file is
one process's export, and the report is the job-level fold (counters sum,
histograms add bucket-wise, gauges keep a `process_index` label — see
obs/aggregate.py).  `--by-process` keeps every child per process instead.

`--trace` renders per-request trace trees (joined by trace_id across
merged process exports) with each tree's critical-path TTFT breakdown;
`--waterfall TRACE_ID` draws one tree as an ASCII timeline.  `--prom`
attaches OpenMetrics exemplars (`# {trace_id="..."} value`) to histogram
buckets that have a sampled trace.

Exit status: 0 on a rendered report, 1 when the file is missing/empty,
2 on unparseable content.
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Tuple

DEFAULT_PATH = os.path.join("results", "obs.jsonl")


def load_records(path: str) -> List[dict]:
    """Parse every JSONL line; raises ValueError on a bad line (the bench
    post-run assertion leans on this being strict)."""
    records = []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not JSON: {e}") from e
            if not isinstance(rec, dict) or "kind" not in rec:
                raise ValueError(f"{path}:{i}: not an obs record: {line[:80]}")
            records.append(rec)
    return records


def merge_records(records: List[dict]) -> Tuple[List[dict], List[dict], dict]:
    """(final metric states, all spans, summary meta).  Metrics are keyed by
    (kind, name, labels) with last-wins — each snapshot is a full dump, so
    the last one is the run's final state.  Trace and exemplar records get
    their own channels (`meta["traces"]` / `meta["exemplars"]`): keying
    them like metrics would collapse every request's same-named lifecycle
    span into one."""
    metrics: Dict[tuple, dict] = {}
    spans: List[dict] = []
    traces: Dict[tuple, dict] = {}
    exemplars: Dict[tuple, dict] = {}
    n_snapshots = 0
    last_ts = ""
    seen_span_ids = set()
    for rec in records:
        kind = rec.get("kind")
        if kind == "meta":
            n_snapshots += 1
            last_ts = rec.get("ts_utc", last_ts)
        elif kind == "span":
            # spans re-export with every snapshot (append model): dedup by id
            sid = (rec.get("thread"), rec.get("span_id"))
            if sid not in seen_span_ids:
                seen_span_ids.add(sid)
                spans.append(rec)
        elif kind == "trace":
            # span ids are deterministic within a trace, so re-exported
            # snapshots dedup naturally on (trace_id, span_id)
            traces[(rec.get("trace_id"), rec.get("span_id"))] = rec
        elif kind == "exemplar":
            key = (rec.get("metric"), rec.get("le"))
            have = exemplars.get(key)
            if have is None or rec.get("value", 0) >= have.get("value", 0):
                exemplars[key] = rec
        else:
            key = (kind, rec.get("name"),
                   tuple(sorted((rec.get("labels") or {}).items())))
            metrics[key] = rec
    meta = {"snapshots": n_snapshots, "last_ts_utc": last_ts,
            "n_metrics": len(metrics), "n_spans": len(spans),
            "n_traces": len({t.get("trace_id") for t in traces.values()}),
            "traces": list(traces.values()),
            "exemplars": list(exemplars.values())}
    return list(metrics.values()), spans, meta


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def _hist_line(rec: dict) -> str:
    parts = [f"count={rec['count']}", f"sum={rec['sum']:.6g}"]
    if rec["count"]:
        parts += [f"mean={rec['sum'] / rec['count']:.6g}",
                  f"min={rec['min']:.6g}", f"max={rec['max']:.6g}"]
    nonzero = [f"le{edge:g}:{cnt}" for edge, cnt in
               zip(rec.get("bucket_edges", []), rec.get("bucket_counts", []))
               if cnt]
    if rec.get("overflow"):
        nonzero.append(f"le+Inf:{rec['overflow']}")
    if nonzero:
        parts.append("buckets[" + " ".join(nonzero) + "]")
    return "  ".join(parts)


def render_text(metrics: List[dict], spans: List[dict], meta: dict,
                source: str) -> str:
    lines = [f"obs report — {source} "
             f"({meta['snapshots']} snapshot(s), last {meta['last_ts_utc']}, "
             f"{meta['n_metrics']} metrics, {meta['n_spans']} spans)"]
    by_kind: Dict[str, List[dict]] = {"counter": [], "gauge": [],
                                      "histogram": []}
    for rec in metrics:
        by_kind.setdefault(rec["kind"], []).append(rec)
    width = max([len(r["name"] + _fmt_labels(r.get("labels") or {}))
                 for r in metrics] + [20]) + 2
    for kind in ("counter", "gauge", "histogram"):
        recs = sorted(by_kind.get(kind, ()),
                      key=lambda r: (r["name"], sorted(
                          (r.get("labels") or {}).items())))
        if not recs:
            continue
        lines.append(f"{kind}s:")
        for rec in recs:
            tag = rec["name"] + _fmt_labels(rec.get("labels") or {})
            if kind == "histogram":
                lines.append(f"  {tag:<{width}} {_hist_line(rec)}")
            else:
                lines.append(f"  {tag:<{width}} {rec['value']:g}")
    if spans:
        lines.append("recent spans (newest last):")
        for rec in spans[-20:]:
            indent = "  " * (1 + int(rec.get("depth") or 0))
            lines.append(f"{indent}{rec['name']}  "
                         f"{rec['duration_s'] * 1e3:.3f} ms"
                         f"  [{rec.get('thread', '?')}]")
    return "\n".join(lines)


def render_prometheus(metrics: List[dict],
                      exemplars: List[dict] = ()) -> str:
    """Rebuild Prometheus text from merged final metric states.  Histogram
    buckets with a sampled trace gain an OpenMetrics exemplar suffix
    (`... # {trace_id="..."} value`) so a dashboard's p99 bucket can
    deep-link the actual waterfall (`obs --waterfall TRACE_ID`)."""
    from .registry import prom_name

    def plabels(labels, extra=""):
        parts = [f'{k}="{v}"' for k, v in sorted((labels or {}).items())]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    by_bucket = {(ex.get("metric"), ex.get("le")): ex for ex in exemplars}

    def exemplar(metric, le):
        ex = by_bucket.get((metric, le))
        if ex is None:
            return ""
        return f' # {{trace_id="{ex["trace_id"]}"}} {ex["value"]:g}'

    lines = []
    for rec in sorted(metrics, key=lambda r: (r["name"], sorted(
            (r.get("labels") or {}).items()))):
        name = prom_name(rec["name"])
        if rec["kind"] in ("counter", "gauge"):
            lines.append(f"# TYPE {name} {rec['kind']}")
            lines.append(f"{name}{plabels(rec.get('labels'))} "
                         f"{rec['value']:g}")
            continue
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        for edge, cnt in zip(rec["bucket_edges"], rec["bucket_counts"]):
            cum += cnt
            lines.append(f"{name}_bucket"
                         f"{plabels(rec.get('labels'), 'le=%s' % json.dumps(str(edge)))} {cum}"
                         f"{exemplar(rec['name'], str(edge))}")
        cum += rec.get("overflow", 0)
        lines.append(f"{name}_bucket"
                     f"{plabels(rec.get('labels'), 'le=%s' % json.dumps('+Inf'))} {cum}"
                     f"{exemplar(rec['name'], '+Inf')}")
        lines.append(f"{name}_sum{plabels(rec.get('labels'))} {rec['sum']:g}")
        lines.append(f"{name}_count{plabels(rec.get('labels'))} "
                     f"{rec['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_trace_trees(trees: List[dict]) -> str:
    """One line per request tree: identity, join status, and the
    critical-path TTFT breakdown (phases sum to the TTFT by
    construction — `trace.ttft_breakdown`)."""
    from .trace import ttft_breakdown

    if not trees:
        return "obs traces: none recorded (tracing off, or nothing sampled)"
    lines = [f"obs traces — {len(trees)} tree(s)"]
    for tree in trees:
        procs = sorted({str(s.get("process_index"))
                        for s in tree["spans"] if "process_index" in s})
        status = "complete" if tree["complete"] else "PARTIAL"
        if tree["truncated"]:
            status += "+truncated"
        head = (f"  {tree['trace_id']}  [{status}]  "
                f"{len(tree['spans'])} span(s)")
        if procs:
            head += f"  procs[{','.join(procs)}]"
        lines.append(head)
        bd = ttft_breakdown(tree["spans"])
        if bd is not None:
            phases = "  ".join(f"{k}={v * 1e3:.3f}ms"
                               for k, v in bd["phases"].items())
            lines.append(f"    ttft {bd['ttft_s'] * 1e3:.3f}ms "
                         f"({bd['clock']} clock): {phases}")
    return "\n".join(lines)


def render_waterfall(tree: dict) -> str:
    """ASCII waterfall of one trace tree: every span as a positioned bar
    on the request's own timeline (t=0 at the earliest span start)."""
    spans = sorted(tree["spans"], key=lambda s: (s["start_s"], s["name"]))
    t0 = spans[0]["start_s"]
    t1 = max(s["start_s"] + s["duration_s"] for s in spans)
    total = max(t1 - t0, 1e-9)
    width = 48
    name_w = max(len(s["name"]) for s in spans) + 2
    status = "complete" if tree["complete"] else "PARTIAL"
    if tree["truncated"]:
        status += "+truncated"
    lines = [f"waterfall {tree['trace_id']}  [{status}]  "
             f"span {total * 1e3:.3f}ms"]
    for s in spans:
        lo = int((s["start_s"] - t0) / total * width)
        hi = int((s["start_s"] + s["duration_s"] - t0) / total * width)
        bar = " " * lo + ("|" if hi <= lo else "#" * (hi - lo))
        proc = (f" p{s['process_index']}"
                if "process_index" in s else "")
        lines.append(f"  {s['name']:<{name_w}}[{bar:<{width}}] "
                     f"+{(s['start_s'] - t0) * 1e3:.3f}ms "
                     f"{s['duration_s'] * 1e3:.3f}ms{proc}")
    return "\n".join(lines)


def _render_traces(meta: dict, args) -> int:
    from .aggregate import build_trace_trees

    trees = build_trace_trees(meta.get("traces", []),
                              meta.get("truncated_processes", ()))
    if args.waterfall:
        for tree in trees:
            if tree["trace_id"] == args.waterfall:
                print(render_waterfall(tree))
                return 0
        print(f"obs: no trace tree {args.waterfall!r} "
              f"({len(trees)} tree(s) present)", file=sys.stderr)
        return 1
    if args.as_json:
        from .trace import ttft_breakdown

        print(json.dumps([dict(t, breakdown=ttft_breakdown(t["spans"]))
                          for t in trees], indent=1))
    else:
        print(render_trace_trees(trees))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m burst_attn_tpu_torch.obs",
        description="render a report from an obs JSONL export")
    ap.add_argument("--file", default=DEFAULT_PATH,
                    help=f"JSONL export to read (default: {DEFAULT_PATH})")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable JSON")
    ap.add_argument("--prom", action="store_true",
                    help="emit Prometheus text exposition format")
    ap.add_argument("--merge", action="append", metavar="GLOB", default=[],
                    help="merge per-process exports matching this glob into "
                         "one job-level report (repeatable)")
    ap.add_argument("--by-process", action="store_true",
                    help="with --merge: keep every metric child per process "
                         "(process_index label) instead of folding")
    ap.add_argument("--trace", action="store_true",
                    help="render per-request trace trees with their "
                         "critical-path TTFT breakdown")
    ap.add_argument("--waterfall", metavar="TRACE_ID",
                    help="ASCII waterfall for one trace tree (implies "
                         "--trace)")
    args = ap.parse_args(argv)

    if args.merge:
        from .aggregate import merge_files, resolve_files

        try:
            metrics, spans, meta = merge_files(args.merge,
                                               by_process=args.by_process)
        except FileNotFoundError as e:
            print(f"obs: {e}", file=sys.stderr)
            return 1
        except ValueError as e:
            print(f"obs: {e}", file=sys.stderr)
            return 2
        source = (f"merge of {meta['processes']} process export(s) "
                  f"[{', '.join(resolve_files(args.merge))}]")
        if args.trace or args.waterfall:
            return _render_traces(meta, args)
        if args.prom:
            sys.stdout.write(render_prometheus(metrics,
                                               meta.get("exemplars", ())))
        elif args.as_json:
            print(json.dumps({"source": source, "meta": meta,
                              "metrics": metrics, "spans": spans}, indent=1))
        else:
            print(render_text(metrics, spans, meta, source))
        return 0

    if not os.path.exists(args.file):
        print(f"obs: no export at {args.file} (run bench.py or call "
              "obs.export_jsonl first)", file=sys.stderr)
        return 1
    try:
        records = load_records(args.file)
    except ValueError as e:
        print(f"obs: {e}", file=sys.stderr)
        return 2
    if not records:
        print(f"obs: {args.file} is empty", file=sys.stderr)
        return 1
    metrics, spans, meta = merge_records(records)
    if args.trace or args.waterfall:
        return _render_traces(meta, args)
    if args.prom:
        sys.stdout.write(render_prometheus(metrics,
                                           meta.get("exemplars", ())))
    elif args.as_json:
        print(json.dumps({"source": args.file, "meta": meta,
                          "metrics": metrics, "spans": spans}, indent=1))
    else:
        print(render_text(metrics, spans, meta, args.file))
    return 0


if __name__ == "__main__":
    sys.exit(main())
