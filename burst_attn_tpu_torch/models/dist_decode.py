"""Sequence-parallel paged decode (port of the page-sharded half of
burst_attn_tpu/models/dist_decode.py), in plain PyTorch: the JAX function
runs no Pallas kernel either.

The pool's page dimension is split over the W ring positions (position w
owns pages [w*P/W, (w+1)*P/W)).  Each position takes an online-softmax
partial of every slot's new query over the table entries whose pages it
owns, and the partials merge by log-sum-exp (`_merge`): the
pmax / psum merge of the JAX package, here over positions that share one
device.  Decode attends every cached position, so the pages may hold
their tokens in any order: the handoff (serving/handoff.py) fills them in
the ring's layout order.

Not ported yet: the dense-shard `dist_prefill` / `dist_decode_step` /
`dist_generate` path (DistCache).
"""

import torch

from ..ops.paged_attention import pool_bytes
from ..parallel.mesh import as_mesh
from ..parallel.ring import my_partition, ring_coords
from .paged_decode import PagedState, _write_tokens
from .transformer import ModelConfig, _attn_out, _logits, _mlp, _qkv_proj, \
    _rms_norm


def _merge(parts):
    """Log-space merge of [(m, l, acc)] partials (m, l [...], acc [..., D]
    unnormalized): the attention output acc_g / l_g."""
    m_g = parts[0][0]
    for m, _, _ in parts[1:]:
        m_g = torch.maximum(m_g, m)
    l_g = sum(l * torch.exp(m - m_g) for m, l, _ in parts)
    acc_g = sum(acc * torch.exp(m - m_g)[..., None] for m, _, acc in parts)
    return acc_g / torch.clamp(l_g, min=1e-30)[..., None]


def _partial_attn(q, k, v, scale, valid):
    """Unnormalized online-softmax partial of q [B,N,1,D] against k/v
    [B,Nk,T,D] over the positions where `valid` [B, T] is True.  Returns
    (m, l, acc) of shapes [B,N,1], [B,N,1], [B,N,1,D] in fp32; a fully
    masked partial has m = -1e30, neutral under the merge.  GQA through a
    grouped query axis (the cache is never repeated)."""
    b, n, _, d = q.shape
    nk = k.shape[1]
    qg = q.reshape(b, nk, n // nk, 1, d).float()
    s = torch.einsum("bngid,bnjd->bngij", qg, k.float()) * scale
    s = s.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    # fully-masked partial: exp(-inf - -inf) guard
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bngij,bnjd->bngid", p, v.float())
    m = torch.where(torch.isfinite(m), m, -1e30)
    return (m.reshape(b, n, 1), l.reshape(b, n, 1), acc.reshape(b, n, 1, d))


def _page_partition(position: int, n_inter: int, n_intra: int) -> int:
    """Linear shard index of a ring position over the (possibly nested)
    sequence axes: the partition id it holds in the ring."""
    return my_partition(*ring_coords(position, n_inter, n_intra), n_intra)


def _shard_partial(q, kp, vp, ks, vs, table, lengths, lo, p_loc):
    """One position's partial over the table entries it owns (pool pages
    [lo, lo + p_loc); page 0, the sink, is never a real token)."""
    slots, cols = table.shape
    page = kp.shape[2]
    owned = (table >= lo) & (table < lo + p_loc) & (table != 0)
    idx = (torch.clamp(table - lo, 0, p_loc - 1) + lo).long()
    # [slots, cols, Nkv, page, D]; a 1 B pool is gathered as bytes
    k_loc = pool_bytes(kp)[idx].view(kp.dtype)
    v_loc = pool_bytes(vp)[idx].view(vp.dtype)
    if ks is not None:
        k_loc = k_loc.float() * ks[idx][..., None]
        v_loc = v_loc.float() * vs[idx][..., None]
    k_loc = k_loc.movedim(2, 1).flatten(2, 3)  # [slots, Nkv, cols*page, D]
    v_loc = v_loc.movedim(2, 1).flatten(2, 3)
    col_pos = torch.arange(cols * page, device=table.device)[None, :]
    valid = (col_pos < lengths[:, None]) & owned.repeat_interleave(page, 1)
    return _partial_attn(q, k_loc, v_loc, q.shape[-1] ** -0.5, valid)


def dist_paged_decode_step(params, tokens, state: PagedState,
                           cfg: ModelConfig, mesh):
    """One decode step for every live slot against a PAGE-SHARDED pool,
    IN PLACE (like paged_decode_step): appends each live slot's token to
    its page, then per layer merges the positions' partials.
    tokens [slots] int -> (fp32 logits [slots, vocab], state).  A live slot
    whose next page was never provisioned gets NaN logits.  n_pages must
    divide by the ring's world (cfg.seq_axes over `mesh`)."""
    if cfg.window is not None:
        raise ValueError(
            "dist_paged_decode_step requires cfg.window=None: pages hold "
            "layout-order tokens")
    dev = state.lengths.device
    n_inter, n_intra = as_mesh(mesh, dev).ring(cfg.seq_axes)
    world = n_inter * n_intra
    tokens = torch.as_tensor(tokens, device=dev).long()
    slots = tokens.shape[0]
    page = state.k_pages[0].shape[2]
    n_pages = state.k_pages[0].shape[0]
    if n_pages % world:
        raise ValueError(f"n_pages {n_pages} must divide by the sequence "
                         f"world {world} to shard the pool page dim")
    p_loc = n_pages // world
    lengths = state.lengths
    live = lengths > 0
    pos = lengths.long()
    x = params["embed"][tokens[:, None]].to(cfg.dtype)
    slot_page = (lengths // page).long()
    offset = (lengths % page).long()
    width = state.page_table.shape[1]
    page_id = state.page_table.gather(
        1, slot_page.clamp(max=width - 1)[:, None])[:, 0]
    page_id = torch.where(slot_page < width, page_id, 0)
    boundary_unassigned = live & (page_id == 0)
    page_id = torch.where(live, page_id, 0).long()
    lengths_new = lengths + live.to(torch.int32)
    quant = state.k_scales is not None
    for li, p in enumerate(params["layers"]):
        kp, vp = state.k_pages[li], state.v_pages[li]
        ks = state.k_scales[li] if quant else None
        vs = state.v_scales[li] if quant else None
        q, k, v = _qkv_proj(p, x, pos[:, None], cfg)
        _write_tokens(kp, ks, page_id, offset, k[:, :, 0])
        _write_tokens(vp, vs, page_id, offset, v[:, :, 0])
        parts = [_shard_partial(q, kp, vp, ks, vs, state.page_table,
                                lengths_new,
                                _page_partition(w, n_inter, n_intra) * p_loc,
                                p_loc)
                 for w in range(world)]
        o = _merge(parts).to(cfg.dtype)         # [slots, N, 1, D]
        x = x + _attn_out(p, o)
        x = x + _mlp(p, x)
    logits = _logits(_rms_norm(x, params["final_norm"]),
                     params["lm_head"])[:, 0]
    logits = logits.masked_fill(boundary_unassigned[:, None], float("nan"))
    state.lengths.copy_(lengths_new)
    return logits, state
