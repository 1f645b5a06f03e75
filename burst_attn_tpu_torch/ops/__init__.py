"""Attention ops: mask specs, the plain online-softmax tile, and the CUDA
kernels with their wrappers (flash forward and backward, paged decode,
ragged paged attention, the fused ring forward)."""
