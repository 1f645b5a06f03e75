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
    `ring_prefill_to_pages`).

Not ported yet: the checkpoint layer.
"""

from .engine import RaggedServeEngine
from .handoff import handoff_generate, ring_prefill_to_pages
from .model import multi_step_decode, pipelined_tick, ragged_model_step

__all__ = ["RaggedServeEngine", "handoff_generate", "multi_step_decode",
           "pipelined_tick", "ragged_model_step", "ring_prefill_to_pages"]
