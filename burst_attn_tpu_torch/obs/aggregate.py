"""Cross-process obs aggregation: merge per-process JSONL exports (a copy
of burst_attn_tpu/obs/aggregate.py).

A multi-process job exports ONE JSONL snapshot file
per process (`obs.export_jsonl` tags the `meta` header with that process's
`process_index`).  This module folds those per-process final states into a
single job-level report — the "one merged metrics view per job" the serving
north star needs — with Prometheus-style semantics per metric kind:

  counters    SUM across processes (each process counted disjoint events)
  gauges      last-wins is only meaningful WITHIN a process, so gauges keep
              a `process_index` label instead of being merged away
  histograms  bucket-wise ADD when the bucket edges agree (they do for any
              same-binary job); edge-mismatched children fall back to
              per-process children with a `process_index` label
  spans       concatenated, each tagged `process_index`
  traces      joined by trace_id across processes (deterministic span ids
              dedup re-exports); `build_trace_trees` folds them into
              per-request trees flagged for completeness/truncation
  exemplars   worst-value-wins per (metric, bucket)

`--by-process` skips the cross-process arithmetic entirely: every metric
child keeps its own `process_index` label (the per-process drill-down view).

CLI:  python -m burst_attn_tpu_torch.obs --merge 'results/obs*.jsonl'
                                         [--by-process] [--json | --prom]
"""

import glob
import json
import os
from typing import Dict, List, Sequence, Tuple

from .__main__ import merge_records


def load_records_tolerant(path: str) -> Tuple[List[dict], int]:
    """Like __main__.load_records, but a bad FINAL line is skipped with a
    count instead of raising — the signature of a snapshot truncated by a
    kill (SIGKILL mid-write leaves a partial last line; everything before
    it is a complete, fsynced earlier snapshot).  A bad line anywhere
    ELSE still raises ValueError: mid-file corruption is not truncation
    and must stay loud.  Returns (records, n_skipped)."""
    with open(path, encoding="utf-8") as f:
        lines = [(i, line.strip()) for i, line in enumerate(f, 1)]
    lines = [(i, line) for i, line in lines if line]
    records: List[dict] = []
    for pos, (i, line) in enumerate(lines):
        bad = None
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            bad = f"{path}:{i}: not JSON: {e}"
            rec = None
        if bad is None and (not isinstance(rec, dict) or "kind" not in rec):
            bad = f"{path}:{i}: not an obs record: {line[:80]}"
        if bad is not None:
            # only a bad FINAL line with valid records before it reads as
            # truncation — a file that is nothing but garbage stays loud
            if pos == len(lines) - 1 and records:
                return records, 1
            raise ValueError(bad)
        records.append(rec)
    return records, 0


def resolve_files(patterns: Sequence[str]) -> List[str]:
    """Expand globs (sorted, deduped).  Literal paths pass through."""
    out = []
    for pat in patterns:
        hits = sorted(glob.glob(pat))
        out += hits if hits else ([pat] if os.path.exists(pat) else [])
    seen, files = set(), []
    for f in out:
        if f not in seen:
            seen.add(f)
            files.append(f)
    return files


def load_process_states(files: Sequence[str]):
    """Per-process final states: [(process_label, metrics, spans, meta)].

    Each file is one process's (possibly multi-snapshot) export; within a
    file the existing last-wins merge applies.  The process label comes
    from the newest `meta` record's `process_index` when present (the
    exporter writes it), else the file's position in the sorted list —
    and collides are disambiguated by position so two re-exports of
    process 0 never silently alias."""
    states = []
    used = set()
    for i, path in enumerate(files):
        # tolerant: a killed worker's final partial line is skipped with a
        # `truncated_lines` count (mid-file corruption still raises)
        records, skipped = load_records_tolerant(path)
        if not records:
            continue
        metrics, spans, meta = merge_records(records)
        label = None
        for rec in records:
            if rec.get("kind") == "meta" and "process_index" in rec:
                label = rec["process_index"]  # newest snapshot wins
        if label is None or str(label) in used:
            label = i
        label = str(label)
        used.add(label)
        states.append((label, metrics, spans,
                       dict(meta, file=path, truncated_lines=skipped)))
    return states


def _child_key(rec: dict, extra: Tuple = ()) -> tuple:
    return (rec["kind"], rec.get("name"),
            tuple(sorted((rec.get("labels") or {}).items())) + tuple(extra))


def _tagged(rec: dict, proc: str) -> dict:
    out = dict(rec)
    out["labels"] = dict(rec.get("labels") or {}, process_index=proc)
    return out


def merge_processes(states, by_process: bool = False):
    """Fold per-process final states into one report.

    Returns (metrics, spans, meta) in the same record schema the CLI
    renderers consume.  See the module docstring for per-kind semantics."""
    metrics: Dict[tuple, dict] = {}
    spans: List[dict] = []
    traces: Dict[tuple, dict] = {}
    exemplars: Dict[tuple, dict] = {}
    truncated_procs: List[str] = []
    n_snapshots = 0
    n_truncated = 0
    last_ts = ""
    for proc, proc_metrics, proc_spans, proc_meta in states:
        n_snapshots += proc_meta.get("snapshots", 0)
        n_truncated += proc_meta.get("truncated_lines", 0)
        if proc_meta.get("truncated_lines"):
            truncated_procs.append(proc)
        last_ts = max(last_ts, proc_meta.get("last_ts_utc", ""))
        for rec in proc_spans:
            spans.append(dict(rec, process_index=proc))
        for rec in proc_meta.get("traces", ()):
            # trace spans join ACROSS processes by trace_id; span ids are
            # deterministic per tree, so cross-export re-reads dedup here
            key = (rec.get("trace_id"), rec.get("span_id"))
            traces.setdefault(key, dict(rec, process_index=proc))
        for rec in proc_meta.get("exemplars", ()):
            key = (rec.get("metric"), rec.get("le"))
            have = exemplars.get(key)
            if have is None or rec.get("value", 0) >= have.get("value", 0):
                exemplars[key] = rec
        for rec in proc_metrics:
            kind = rec["kind"]
            if by_process or kind == "gauge":
                # gauges: last-wins is per-process state; a cross-process
                # sum/last would fabricate a value no process ever reported
                tagged = _tagged(rec, proc)
                metrics[_child_key(tagged)] = tagged
                continue
            key = _child_key(rec)
            have = metrics.get(key)
            if have is None:
                metrics[key] = dict(rec, labels=dict(rec.get("labels") or {}))
            elif kind == "counter":
                have["value"] += rec["value"]
            elif kind == "histogram":
                if have.get("bucket_edges") == rec.get("bucket_edges"):
                    have["count"] += rec["count"]
                    have["sum"] += rec["sum"]
                    have["min"] = min(have["min"], rec["min"])
                    have["max"] = max(have["max"], rec["max"])
                    have["bucket_counts"] = [
                        a + b for a, b in zip(have["bucket_counts"],
                                              rec["bucket_counts"])]
                    have["overflow"] = (have.get("overflow", 0)
                                        + rec.get("overflow", 0))
                else:
                    # mismatched edges (mixed binaries): keep both children
                    # apart rather than adding apples to oranges
                    tagged = _tagged(rec, proc)
                    metrics[_child_key(tagged)] = tagged
            else:  # unknown kinds pass through per process
                tagged = _tagged(rec, proc)
                metrics[_child_key(tagged)] = tagged
    meta = {
        "snapshots": n_snapshots,
        "last_ts_utc": last_ts,
        "processes": len(states),
        "process_labels": [s[0] for s in states],
        "n_metrics": len(metrics),
        "n_spans": len(spans),
        "n_traces": len({t.get("trace_id") for t in traces.values()}),
        "truncated_lines": n_truncated,
        "truncated_processes": truncated_procs,
        "traces": list(traces.values()),
        "exemplars": list(exemplars.values()),
    }
    return list(metrics.values()), spans, meta


def build_trace_trees(traces, truncated_processes=()):
    """Group merged trace records into per-request trees, joined by
    trace_id.  Each tree is
    {"trace_id", "spans" (by start time), "complete", "truncated"}:

      complete   the tree has a root (parent_id None) and every span's
                 parent resolves within the tree — the cross-process join
                 actually closed.
      truncated  some contributing process's export lost its final line
                 (the SIGKILL signature `load_records_tolerant` skips) —
                 the tree is read as partial-but-flagged, never silently
                 whole.
    """
    truncated = {str(p) for p in truncated_processes}
    by_trace: Dict[str, List[dict]] = {}
    for rec in traces:
        by_trace.setdefault(rec.get("trace_id"), []).append(rec)
    trees = []
    for trace_id in sorted(by_trace, key=str):
        spans = sorted(by_trace[trace_id], key=lambda s: s.get("start_s", 0))
        ids = {s.get("span_id") for s in spans}
        complete = (any(s.get("parent_id") is None for s in spans)
                    and all(s.get("parent_id") in ids for s in spans
                            if s.get("parent_id") is not None))
        torn = any(str(s.get("process_index")) in truncated for s in spans)
        trees.append({"trace_id": trace_id, "spans": spans,
                      "complete": complete, "truncated": torn})
    return trees


def merge_files(patterns: Sequence[str], by_process: bool = False):
    """Glob -> per-process states -> one merged (metrics, spans, meta).

    Raises FileNotFoundError when the patterns match nothing and ValueError
    on unparseable content (the CLI maps these to exit 1 / 2)."""
    files = resolve_files(patterns)
    if not files:
        raise FileNotFoundError(
            f"no obs exports match {list(patterns)!r}")
    states = load_process_states(files)
    if not states:
        raise FileNotFoundError(
            f"obs exports {files!r} contain no records")
    return merge_processes(states, by_process=by_process)
