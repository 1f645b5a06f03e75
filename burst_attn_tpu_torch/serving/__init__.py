"""Ragged paged serving (port of burst_attn_tpu/serving): one kernel, one
pool, one engine.

  * `ops/ragged_paged.py` — one launch per layer attends a mixed
    chunked-prefill + decode token batch against the paged KV pool
    (csrc/ragged_paged.cu on the card).
  * `serving.model.ragged_model_step` — the transformer step that scatters
    each slot's new K/V into its pages and attends through that kernel.
  * `serving.engine.RaggedServeEngine` — continuous batching: per-step
    admission, chunked prefill interleaved with in-flight decode, prefix
    cache with copy-on-write pages, int8/fp8 pools, and speculative
    decoding as a scheduler policy (`draft_params`: k draft proposals a
    slot, one verify launch at QT = k+1).
  * `serving.handoff` — the long-context handoff: a ring-sharded
    prefill (`burst_attn`) lands its K/V directly in pool pages, then
    sequence-parallel paged decode (`handoff_generate`,
    `ring_prefill_to_pages`; `handoff_decode` is the resumable, journaled
    decode).
  * `serving.checkpoint` — crash consistency: atomic engine and paged
    snapshots, the write-ahead token journal, and resume-not-replay
    recovery (`recover_engine`, `run_recovered`) for both engines and the
    bare handoff state.
"""

from .checkpoint import (
    RecoveryInfo, TokenJournal, journal_tokens_by_ext, journal_view,
    load_paged_snapshot, load_snapshot, read_journal, recover_engine,
    restore_into, rewrite_journal, run_recovered, save_paged_snapshot,
    save_snapshot, trim_complete,
)
from .engine import RaggedServeEngine
from .handoff import (
    check_handoff_preconditions, handoff_decode, handoff_generate,
    ring_prefill_to_pages,
)
from .model import multi_step_decode, pipelined_tick, ragged_model_step

__all__ = [
    "RaggedServeEngine",
    "RecoveryInfo",
    "TokenJournal",
    "check_handoff_preconditions",
    "handoff_decode",
    "handoff_generate",
    "journal_tokens_by_ext",
    "journal_view",
    "load_paged_snapshot",
    "load_snapshot",
    "multi_step_decode",
    "pipelined_tick",
    "ragged_model_step",
    "read_journal",
    "recover_engine",
    "restore_into",
    "rewrite_journal",
    "ring_prefill_to_pages",
    "run_recovered",
    "save_paged_snapshot",
    "save_snapshot",
    "trim_complete",
]
