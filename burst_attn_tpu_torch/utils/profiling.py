"""Step timing: re-exports of `StepTimer` and `annotate`, whose home is
`burst_attn_tpu_torch.obs.spans` (as burst_attn_tpu/utils/profiling.py
re-exports the JAX package's).  StepTimer also feeds the registry
histogram `span.step_timer`; profiles of the card are taken with
`torch.profiler` directly."""

from ..obs.spans import StepTimer, annotate  # noqa: F401

__all__ = ["StepTimer", "annotate"]
