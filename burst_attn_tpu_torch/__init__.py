"""PyTorch/CUDA port of burst_attn_tpu for NVIDIA Hopper (H100).

The JAX package `burst_attn_tpu` is the reference; module names here
mirror it so each counterpart is easy to find.  Kernels are hand-written
CUDA C++ for `sm_90a` (`csrc/`), built at first use and bound through
ctypes (`ops/_build.py`).  Each kernel wrapper runs its plain PyTorch
version for CPU tensors only; a CUDA tensor launches the kernel or raises.

This package imports `torch`, never `jax`, and nothing of
`burst_attn_tpu`.  Entry points default to `device="cuda"` and raise when
no CUDA device is present unless the caller passes `device="cpu"`.

Ported so far: the `ServeEngine` serving path (models/serve.py) with the
flash-forward prefill kernel and the paged-decode kernel.
"""
