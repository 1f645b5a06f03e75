"""PyTorch/CUDA port of burst_attn_tpu for NVIDIA Hopper (H100).

The JAX package `burst_attn_tpu` is the reference; module names here
mirror it so each counterpart is easy to find.  Kernels are hand-written
CUDA C++ for `sm_90a` (`csrc/`), built at first use and bound through
ctypes (`ops/_build.py`).  Each kernel wrapper runs its plain PyTorch
version for CPU tensors only; a CUDA tensor launches the kernel or raises.

This package imports `torch`, never `jax`, and nothing of
`burst_attn_tpu`.  Entry points default to `device="cuda"` and raise when
no CUDA device is present unless the caller passes `device="cpu"`.

Ported so far: the serving engines (models/serve.py, serving/engine.py),
the trainer on one device or a sequence ring (models/train.py,
models/runner.py), ring attention forward and backward (`burst_attn`
over a mesh whose ring positions share one device; the scan ring over
the flash kernels, or the fused ring kernels), the long-context handoff
(serving/handoff.py), the dense-shard distributed decode
(models/dist_decode.py) and the observability package (`obs`: metrics,
spans, request traces, ring telemetry, the `python -m
burst_attn_tpu_torch.obs` report).

Public API (reference parity):
    burst_attn              -- global-tensor ring attention (autograd)
    burst_attn_func         -- reference-style alias (zigzag layout)
    burst_attn_func_striped -- reference-style alias (striped layout)
    BurstConfig             -- static configuration
    layouts                 -- sequence layouts (to_layout / from_layout)
    obs                     -- metrics registry, spans, traces, DevStats
"""

from . import obs
from .parallel import layouts
from .parallel.burst import (
    BurstConfig,
    burst_attn,
    burst_attn_func,
    burst_attn_func_striped,
)

__all__ = [
    "BurstConfig",
    "burst_attn",
    "burst_attn_func",
    "burst_attn_func_striped",
    "layouts",
    "obs",
]
