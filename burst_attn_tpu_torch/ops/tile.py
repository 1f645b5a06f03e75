"""Plain online-softmax attention tile with carry-in state (port of
burst_attn_tpu/ops/tile.py).

One round of FlashAttention-style attention: given carry state (m =
running row max, lse = running log-sum-exp, acc = unnormalized output
accumulator), fold in the contribution of one KV block; `tile_bwd` is the
matching backward round.  These are the plain versions behind the flash
kernels (ops/flash.py) and the numerics oracles the kernels are held to.

Conventions (the JAX package's, kept at the public surface):
  q, k, v : [B, N, S, D]
  m, lse  : [B, N, S]     float32, initialized to -inf
  acc     : [B, N, S, D]  float32, initialized to 0, unnormalized
  final   : o = acc * exp(m - lse)   (guarded for fully-masked rows)

GQA: N query heads, Nk kv heads with N % Nk == 0; kv head g serves query
heads [g*G, (g+1)*G).
"""

import torch

from .masks import MaskSpec, dense_mask, round_spec

NEG_INF = float("-inf")


def init_state(batch, heads, seq, dim, device=None):
    m = torch.full((batch, heads, seq), NEG_INF, dtype=torch.float32,
                   device=device)
    lse = torch.full((batch, heads, seq), NEG_INF, dtype=torch.float32,
                     device=device)
    acc = torch.zeros((batch, heads, seq, dim), dtype=torch.float32,
                      device=device)
    return m, lse, acc


def _expand_kv(x, n_q_heads):
    """Repeat kv heads to match query heads (GQA)."""
    n_kv = x.shape[1]
    if n_kv == n_q_heads:
        return x
    if n_q_heads % n_kv:
        raise ValueError(f"GQA needs Nq % Nk == 0, got {n_q_heads} % {n_kv}")
    return x.repeat_interleave(n_q_heads // n_kv, dim=1)


def _with_segments(mask, segments):
    """Intersect a [s_q, s_kv] structural mask with the packed-sequence
    (segment-ids) equality mask.  segments = (q_seg [B, s_q], kv_seg
    [B, s_kv]) int; tokens attend only within their own segment.  Returns
    a [B, 1, s_q, s_kv] mask (batch-dependent)."""
    if segments is None:
        return mask
    q_seg, kv_seg = segments
    return mask[None, None] & (q_seg[:, None, :, None]
                               == kv_seg[:, None, None, :])


def tile_fwd(q, k, v, m, lse, acc, scale, spec: MaskSpec, window=None,
             segments=None):
    """One online-softmax round; returns updated (m, lse, acc).
    `window`: the sliding-window lower bound (masks.dense_mask).
    `segments`: packed-sequence ids, see _with_segments."""
    s_q, s_kv = q.shape[2], k.shape[2]
    k = _expand_kv(k, q.shape[1])
    v = _expand_kv(v, q.shape[1])
    mask = _with_segments(
        dense_mask(spec, s_q, s_kv, device=q.device, window=window), segments)

    s = torch.einsum("bnid,bnjd->bnij", q.float(), k.float()) * scale
    s = s.masked_fill(~mask, NEG_INF)

    m_new = torch.maximum(m, s.amax(dim=-1))
    # alpha rescales the old accumulator; rows where m stays -inf keep
    # alpha=1 (their acc is 0 anyway) to avoid -inf - -inf = nan.
    alpha = torch.where(m >= m_new, 1.0, torch.exp(m - m_new))
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    l_step = p.sum(dim=-1)

    acc = acc * alpha[..., None] + torch.einsum("bnij,bnjd->bnid", p,
                                                v.float())
    prior = torch.where(torch.isneginf(lse), 0.0, torch.exp(lse - m_new))
    total = prior + l_step
    lse_new = torch.where(total > 0, m_new + torch.log(total), NEG_INF)
    return m_new, lse_new, acc


def finalize(m, lse, acc, dtype):
    """Normalize the accumulator: o = acc * exp(m - lse)."""
    o_scale = torch.where(torch.isneginf(lse), 0.0, torch.exp(m - lse))
    return (acc * o_scale[..., None]).to(dtype)


def tile_bwd(do, q, k, v, delta, lse, scale, spec: MaskSpec, window=None,
             segments=None):
    """One backward round; returns this round's (dq, dk, dv) in float32.
    The plain version behind the flash backward kernels (ops/flash.py).

    delta = sum(o * do, -1) [B, N, S] float32 (precomputed once); lse is
    the FINAL log-sum-exp of the query rows, so p = exp(s - lse) is the
    true softmax probability.  Masked entries, and rows whose lse is -inf
    (fully masked), contribute exact zeros.  GQA sums dk/dv over each
    kv head's group of query heads.  `window`: the sliding-window band
    (masks.dense_mask), as tile_fwd's.  `segments`: packed-sequence ids,
    see _with_segments."""
    n_q, n_kv = q.shape[1], k.shape[1]
    s_q, s_kv = q.shape[2], k.shape[2]
    q32, do32 = q.float(), do.float()
    kx = _expand_kv(k, n_q).float()
    vx = _expand_kv(v, n_q).float()
    mask = _with_segments(
        dense_mask(spec, s_q, s_kv, device=q.device, window=window),
        segments) & ~torch.isneginf(lse)[..., None]

    s = torch.einsum("bnid,bnjd->bnij", q32, kx) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum("bnij,bnid->bnjd", p, do32)
    dp = torch.einsum("bnid,bnjd->bnij", do32, vx)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bnij,bnjd->bnid", ds, kx)
    dk = torch.einsum("bnij,bnid->bnjd", ds, q32)
    if n_kv != n_q:
        g = n_q // n_kv
        dk = dk.reshape(dk.shape[0], n_kv, g, s_kv, -1).sum(dim=2)
        dv = dv.reshape(dv.shape[0], n_kv, g, s_kv, -1).sum(dim=2)
    return dq, dk, dv


def single_device_attention(q, k, v, scale=None, causal=False,
                            window=None, segment_ids=None):
    """Full attention on one device via the plain tile (a one-round
    "ring").  GQA is expanded inside the tile.  `window` (causal only)
    limits each query to its last `window` positions.  `segment_ids`
    [B, S] int packs several sequences into one row: attention never
    crosses a segment boundary."""
    if window is not None and not causal:
        raise ValueError("window attention requires causal=True")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, n, s, d = q.shape
    spec = round_spec(0, 0, s, k.shape[2], causal, "contig")
    m, lse, acc = init_state(b, n, s, d, device=q.device)
    segs = None if segment_ids is None else (segment_ids, segment_ids)
    m, lse, acc = tile_fwd(q, k, v, m, lse, acc, scale, spec, window=window,
                           segments=segs)
    return finalize(m, lse, acc, q.dtype)
