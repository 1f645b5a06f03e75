"""Attention ops: mask specs, the plain online-softmax tile, and the CUDA
kernels with their wrappers (flash forward, paged decode)."""
