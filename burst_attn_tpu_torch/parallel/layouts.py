"""Sequence-sharding layouts: contiguous, zigzag-half and striped (port of
burst_attn_tpu/parallel/layouts.py).

A layout is a permutation of the global sequence: after permuting,
contiguous equal chunks over the ring (device-major order) give each
device its layout chunk.

  * contig : identity; chunk p holds global tokens [p*C, (p+1)*C)
  * zigzag : chunk p holds global chunks p and 2W-1-p of size S/(2W)
  * striped: chunk p holds global tokens p, p+W, p+2W, ...

The index math is numpy; `to_layout`/`from_layout` take a numpy array or
a torch tensor and return the same kind.  With world 1 every layout is
the identity, which the single-device trainer relies on.
"""

import numpy as np
import torch

LAYOUTS = ("contig", "zigzag", "striped")


def seq_permutation(layout: str, seq_len: int, world: int) -> np.ndarray:
    """perm[i] = global token index that position i of the layout-ordered
    sequence holds."""
    if seq_len % world != 0:
        raise ValueError(f"seq_len {seq_len} not divisible by world {world}")
    if layout == "contig":
        return np.arange(seq_len)
    if layout == "zigzag":
        if seq_len % (2 * world) != 0:
            raise ValueError(f"zigzag needs seq_len % (2*world) == 0, got "
                             f"{seq_len}, {world}")
        chunks = np.arange(seq_len).reshape(2 * world, -1)
        order = []
        for p in range(world):
            order += [chunks[p], chunks[2 * world - 1 - p]]
        return np.concatenate(order)
    if layout == "striped":
        # position (p, i) -> global token p + i*world
        return np.arange(seq_len).reshape(seq_len // world, world).T.reshape(
            -1)
    raise ValueError(f"unknown layout {layout!r}; expected one of {LAYOUTS}")


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def _take(x, perm: np.ndarray, axis: int):
    if torch.is_tensor(x):
        idx = torch.from_numpy(np.ascontiguousarray(perm)).to(x.device)
        return torch.index_select(x, axis, idx)
    return np.take(x, perm, axis=axis)


def to_layout(x, layout: str, world: int, axis: int):
    """Permute the global sequence axis into layout order."""
    return _take(x, seq_permutation(layout, x.shape[axis], world), axis)


def from_layout(x, layout: str, world: int, axis: int):
    """Inverse of to_layout: back to natural token order."""
    perm = inverse_permutation(seq_permutation(layout, x.shape[axis], world))
    return _take(x, perm, axis)


def position_ids(layout: str, seq_len: int, world: int) -> np.ndarray:
    """[world, seq_len // world] global position of each local token."""
    return seq_permutation(layout, seq_len, world).reshape(world, -1)
