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

With a tensor-parallel head axis the heads come in tp groups of N/tp
contiguous heads (the tp positions' column-parallel projections side by
side): each group's all-to-all exchanges its own heads only, and each
sequence position runs one launch over its share of every group's heads,
so the check is per group: N/tp and Nkv/tp divide by W.

Across processes (a Mesh whose sequence axis spans them, utils/
multihost.py): q, k, v and o are this process's part of S (its
positions' shards), the all-to-alls reach the other processes'
positions (mesh.all_to_all over the transport), and the packed-document
ids, which every position needs whole after the exchange, are gathered
from the processes first.
"""

from typing import Optional

import torch

from ..ops.flash import flash_attention
from ..ops.tile import single_device_attention
from .mesh import Mesh, _gathered, _names, all_to_all, local_size


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

    `head_axes` (the mesh's tensor-parallel axis, or None) splits the heads
    into tp groups of N/tp contiguous heads, as the JAX shard_map spec
    P(batch, head, seq, None) does: each tp group's all-to-all exchanges
    only its own heads, and after the exchange every sequence position
    runs ONE attention launch over its share of every tp group's heads
    (the groups are independent; one launch a position and tp group would
    only split the work).  Raises ValueError unless each tp group's q and
    kv heads divide by W ("divisible").
    The JAX signature's block sizes and batch axes have no counterpart:
    the kernels' tiles are fixed and the batch is whole on the device."""
    shape = dict(mesh.shape if isinstance(mesh, Mesh) else mesh)
    w = int(shape.get(seq_axis, 1))
    m = local_size(mesh, seq_axis)  # the positions held here
    tp = 1
    for a in _names(head_axes):
        tp *= int(shape.get(a, 1))
    if (q.shape[1] % tp or k.shape[1] % tp or (q.shape[1] // tp) % w
            or (k.shape[1] // tp) % w):
        raise ValueError(
            f"ulysses needs per-group q heads {q.shape[1]}/{tp} and kv heads "
            f"{k.shape[1]}/{tp} divisible by the '{seq_axis}' axis size {w}")
    if q.shape[2] % m:
        raise ValueError(f"sequence length {q.shape[2]} does not divide by "
                         f"the '{seq_axis}' axis size {w}")
    if window is not None and not causal:
        raise ValueError("window attention requires causal=True")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if segment_ids is not None:
        segment_ids = segment_ids.to(device=q.device, dtype=torch.int32)
        if m < w:  # the whole sequence's ids, from every process
            segment_ids = torch.cat(_gathered(
                [segment_ids.contiguous()], seq_axis, mesh)[0], dim=1)

    def exchange(t):
        """Each tp group's heads of t: its positions' sequence shards
        [B, N/tp, S/W, D] (views of the global tensor, copied only by the
        exchange) all-to-all'd into [B, N/tp/W, S, D] a position."""
        return [all_to_all(g.chunk(m, dim=2), split_dim=1, concat_dim=2,
                           axis=seq_axis, mesh=mesh)
                for g in t.chunk(tp, dim=1)]

    # scatter heads, gather the sequence, then each position's heads of
    # every tp group side by side: [B, N/W, S, D] a position
    qh, kh, vh = ([torch.cat([g[p] for g in x], dim=1) if tp > 1
                   else x[0][p] for p in range(m)]
                  for x in (exchange(q), exchange(k), exchange(v)))
    oh = [_local_attention(qh[p], kh[p], vh[p], scale, causal, backend,
                           window=window, segment_ids=segment_ids)
          for p in range(m)]
    # scatter the sequence back, gather the heads: a tp group at a time
    heads = [o.chunk(tp, dim=1) for o in oh]
    return torch.cat([torch.cat(all_to_all([h[t] for h in heads],
                                           split_dim=2, concat_dim=1,
                                           axis=seq_axis, mesh=mesh), dim=2)
                      for t in range(tp)], dim=1)
