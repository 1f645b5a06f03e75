"""loadgen: trace-replay load harness, fault injection, SLO gates (port of
burst_attn_tpu/loadgen), in four layers:

  trace    deterministic workload model — seeded ragged/bursty/poison
           traces serialized as replayable JSONL (loadgen/trace.py)
  driver   open-loop replay against one engine + the single-process
           token oracle and the zero-corruption diff (loadgen/driver.py)
  cluster  N spawned serve workers behind a router with first-class
           fault injection (kill / pool-hog / stall / hang / restart), a
           heartbeat failure detector, journal-aware resume rerouting,
           and merged obs (loadgen/cluster.py, loadgen/worker.py)
  slo      p50/p99 TTFT + token latency, goodput, shed-rate, per-fault
           recovery percentiles from the merged export; Objectives
           pass/fail (loadgen/slo.py)

CLI: python -m burst_attn_tpu_torch.loadgen {gen,replay,slo} ...
"""

from .cluster import (
    ClusterReport, FaultEvent, LoadGenCluster, random_fault_schedule,
)
from .driver import (
    Outcome, ReplayReport, RetryBackoff, assert_token_exact, diff_tokens,
    oracle_replay, replay_trace,
)
from .slo import Objectives, compute_slo, evaluate, format_slo, \
    recovery_stats
from .trace import Trace, TraceRequest, load_trace, save_trace, \
    synthesize_trace

__all__ = [
    "ClusterReport", "FaultEvent", "LoadGenCluster", "Objectives",
    "Outcome", "ReplayReport", "RetryBackoff", "Trace", "TraceRequest",
    "assert_token_exact", "compute_slo", "diff_tokens", "evaluate",
    "format_slo", "load_trace", "oracle_replay", "random_fault_schedule",
    "recovery_stats", "replay_trace", "save_trace", "synthesize_trace",
]
