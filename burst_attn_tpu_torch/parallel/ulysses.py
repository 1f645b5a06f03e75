"""Ulysses all-to-all sequence parallelism (port of
burst_attn_tpu/parallel/ulysses.py).

Instead of rotating K/V around a ring, each position exchanges its
sequence shard for a head shard (one all-to-all per tensor), runs
FULL-sequence attention on its N/W heads, and exchanges back.  The W
positions share one device (parallel/mesh.py): the exchange is
`mesh.all_to_all`, which copies every chunk into its receiver's fresh
buffer, and each position launches its own local attention (kernel 1
forward, the flash backward kernels 2-5 by `ops/flash.bwd_route`, through
the autograd `flash_attention`; its plain version on a CPU tensor).  One
launch over all heads would be the single-device step and hide the
exchange.

Differentiable end to end through autograd: `flash_attention` is an
autograd Function and the all-to-all is chunk + cat, whose transpose is
the all-to-all back.

GQA: the tiled all-to-all hands position p the p-th contiguous chunk of
the q heads and the p-th chunk of the kv heads; with G = N / Nkv, q head h
reads kv head h // G, so the grouping survives because both are split in
contiguous chunks.  Hence the check that N and Nkv divide by W.
"""

from typing import Optional

import torch

from ..ops.flash import flash_attention
from ..ops.tile import single_device_attention
from .mesh import Mesh, _names, all_to_all


def _local_attention(q, k, v, scale, causal, backend, window=None,
                     segment_ids=None):
    """Full-sequence attention of one position: "jnp" is the plain tile
    (single_device_attention), every other backend the flash kernels
    (flash_attention: the kernels on a CUDA tensor, their plain versions
    on a CPU one)."""
    if backend == "jnp":
        return single_device_attention(q, k, v, scale, causal,
                                       window=window,
                                       segment_ids=segment_ids)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           scale, causal, window=window,
                           segment_ids=segment_ids)


def ulysses_attn(q, k, v, *, mesh, seq_axis: str = "sp",
                 causal: bool = False, scale: Optional[float] = None,
                 backend: str = "auto", head_axes=None,
                 window: Optional[int] = None, segment_ids=None):
    """All-to-all sequence-parallel attention on global [B, N, S, D]
    tensors in NATURAL token order (no ring layouts): S is sharded over
    `seq_axis` of `mesh` ({"sp": W} or a Mesh), W positions sharing the
    tensors' device.  q [B, N, S, D], k / v [B, Nkv, S, D] -> o
    [B, N, S, D] in q's dtype, differentiable.  `window` (causal only)
    bands every position's attention; `segment_ids` [B, S] ints pack
    documents (each position holds the whole sequence after the
    exchange, so the ids need none).

    Raises ValueError unless N and Nkv divide by W ("divisible"), and
    NotImplementedError for a tensor-parallel `head_axes` of size > 1
    (ROADMAP A7: the port's axes other than the sequence's have size 1).
    The JAX signature's block sizes and batch axes have no counterpart:
    the kernels' tiles are fixed and the batch is whole on the device."""
    shape = dict(mesh.shape if isinstance(mesh, Mesh) else mesh)
    w = int(shape.get(seq_axis, 1))
    tp = 1
    for a in _names(head_axes):
        tp *= int(shape.get(a, 1))
    if tp > 1:
        raise NotImplementedError(
            f"ulysses with head_axes {head_axes!r} of size {tp}: tensor "
            "parallelism rides with the multi-card ring (ROADMAP A7)")
    if q.shape[1] % w or k.shape[1] % w:
        raise ValueError(
            f"ulysses needs q heads {q.shape[1]} and kv heads {k.shape[1]} "
            f"divisible by the '{seq_axis}' axis size {w}")
    if q.shape[2] % w:
        raise ValueError(f"sequence length {q.shape[2]} does not divide by "
                         f"the '{seq_axis}' axis size {w}")
    if window is not None and not causal:
        raise ValueError("window attention requires causal=True")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device, dtype=torch.int32)
    # the positions' sequence shards [B, N, S/W, D]: views of the global
    # tensors (position p holds slice p), copied only by the exchange
    qs, ks, vs = (t.chunk(w, dim=2) for t in (q, k, v))
    # scatter heads, gather the sequence: [B, N/W, S, D] a position
    qh = all_to_all(qs, split_dim=1, concat_dim=2, axis=seq_axis)
    kh = all_to_all(ks, split_dim=1, concat_dim=2, axis=seq_axis)
    vh = all_to_all(vs, split_dim=1, concat_dim=2, axis=seq_axis)
    oh = [_local_attention(qh[p], kh[p], vh[p], scale, causal, backend,
                           window=window, segment_ids=segment_ids)
          for p in range(w)]
    # scatter the sequence back, gather the heads
    return torch.cat(all_to_all(oh, split_dim=2, concat_dim=1,
                                axis=seq_axis), dim=2)
