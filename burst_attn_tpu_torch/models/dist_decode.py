"""Distributed long-context inference (port of
burst_attn_tpu/models/dist_decode.py): ring prefill with a
SEQUENCE-SHARDED KV cache, then LSE-merged decode across the shards.

Two caches, one merge:

  * dense shards (`DistCache`, `dist_prefill` / `dist_decode_step` /
    `dist_generate`): the ring forward (burst_attn over cfg.seq_axes;
    "fused_ring" runs kernel 8, "auto" / "pallas" the scan ring over
    kernel 1) absorbs the prompt once, capturing each layer's rope'd K/V
    in LAYOUT order: ring position w owns columns [w*S/W, (w+1)*S/W).
    A decode step takes, per layer, each position's online-softmax
    partial of the new query against its columns, merges them in log
    space (the JAX package's pmax / psum over the ring axes, here over
    positions that share one device), then merges once more with a small
    buffer of the tokens generated so far.  Decode attends every cached
    position, and full-visibility attention is permutation-invariant, so
    the layout order never needs undoing.
  * pool pages (`dist_paged_decode_step`): the pool's page dimension is
    split over the W positions (position w owns pages [w*P/W,
    (w+1)*P/W)) and each position's partial covers the table entries
    whose pages it owns; the handoff (serving/handoff.py) fills them in
    the ring's layout order.

Both are plain PyTorch: the JAX functions run no Pallas kernel either
(the prefill's attention is the ring's kernels).  GQA keeps a grouped
query axis: the cache is never repeated to N heads.
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.paged_attention import pool_bytes
from ..parallel import layouts
from ..parallel.burst import burst_attn
from ..parallel.mesh import as_mesh
from ..parallel.ring import my_partition, ring_coords
from .paged_decode import PagedState, _write_tokens
from .transformer import ModelConfig, _attn_out, _logits, _mlp, _qkv_proj, \
    _rms_norm, check_serving


class DistCache(NamedTuple):
    """The dense-shard decode cache (the JAX package's fields)."""

    # per layer, [B, Nkv, S, D] in layout order (position w owns columns
    # [w*S/W, (w+1)*S/W)), dtype cfg.dtype
    k_shard: Tuple[torch.Tensor, ...]
    v_shard: Tuple[torch.Tensor, ...]
    # per layer, the recent-token buffers [B, Nkv, R, D]
    k_new: Tuple[torch.Tensor, ...]
    v_new: Tuple[torch.Tensor, ...]
    n_new: int  # valid positions in *_new (a host int)


def ring_forward(params, tokens, cfg: ModelConfig, mesh, on_kv=None):
    """The ring-sharded forward of a [B, S] prompt (natural order, on the
    params' device): every layer's attention is burst_attn over the ring,
    K/V and activations stay in layout order end to end.  `on_kv(layer,
    k, v)` receives each layer's rope'd K/V in cfg.dtype.  Returns (hidden
    states [B, S, d_model] before the final norm, in layout order; the
    layout permutation)."""
    check_serving(cfg)
    dev = params["embed"].device
    m = as_mesh(mesh, dev)
    n_inter, n_intra = m.ring(cfg.seq_axes)
    b, s = tokens.shape
    perm = layouts.seq_permutation(cfg.layout, s, n_inter * n_intra)
    perm_t = torch.from_numpy(np.asarray(perm)).to(dev)
    pos = perm_t[None, :].expand(b, s)
    tokens_l = torch.as_tensor(tokens, device=dev).long()[:, perm_t]
    x = params["embed"][tokens_l].to(cfg.dtype)
    for li, p in enumerate(params["layers"]):
        q, k, v = _qkv_proj(p, x, pos, cfg)
        k, v = k.to(cfg.dtype), v.to(cfg.dtype)
        o = burst_attn(q, k, v, mesh=m, seq_axes=cfg.seq_axes,
                       causal=cfg.causal, layout=cfg.layout,
                       backend=cfg.attn_backend, block_q=cfg.block_q,
                       block_kv=cfg.block_kv, batch_axes=cfg.batch_axis,
                       head_axes=cfg.head_axis, window=cfg.window)
        if on_kv is not None:
            on_kv(li, k, v)
        x = x + _attn_out(p, o)
        x = x + _mlp(p, x, cfg, inference=True)[0]
    return x, perm


def dist_prefill(params, tokens, cfg: ModelConfig, mesh, *, gen_budget: int):
    """Absorb a [B, S] prompt (natural order) with the ring forward.

    Returns (last_logits [B, vocab] fp32, DistCache).  S must divide by the
    ring's world (as the layout requires); gen_budget sizes the recent-KV
    buffers.  A `cfg.window` (contig) prefills through the windowed ring
    (burst_attn(window=): kernel 8's WIN instance, or kernel 1's on the
    live rounds of the scan ring), and each decode step bands the shards
    and the recent buffer by global position."""
    check_serving(cfg)
    with torch.no_grad():
        ks, vs = [], []
        x, perm = ring_forward(params, tokens, cfg, mesh,
                               lambda li, k, v: (ks.append(k), vs.append(v)))
        # only ONE position feeds decoding (the full [B, S, vocab] fp32
        # logits would be GBs at these contexts): the last NATURAL token
        # sits at layout position inv_perm[s - 1]
        last = int(layouts.inverse_permutation(perm)[tokens.shape[1] - 1])
        xf = _rms_norm(x[:, last], params["final_norm"])
        last_logits = _logits(xf, params["lm_head"])
    b = x.shape[0]
    shape_new = (b, cfg.n_kv_heads, gen_budget, cfg.d_head)
    zeros = lambda: tuple(torch.zeros(shape_new, dtype=cfg.dtype,
                                      device=x.device)
                          for _ in range(cfg.n_layers))
    return last_logits, DistCache(tuple(ks), tuple(vs), zeros(), zeros(), 0)


def _merge(parts):
    """Log-space merge of [(m, l, acc)] partials (m, l [...], acc [..., D]
    unnormalized): the attention output acc_g / l_g."""
    m_g = parts[0][0]
    for m, _, _ in parts[1:]:
        m_g = torch.maximum(m_g, m)
    l_g = sum(l * torch.exp(m - m_g) for m, l, _ in parts)
    acc_g = sum(acc * torch.exp(m - m_g)[..., None] for m, _, acc in parts)
    return acc_g / torch.clamp(l_g, min=1e-30)[..., None]


def _partial_attn(q, k, v, scale, valid=None, n_valid=None, col_lo=None):
    """Unnormalized online-softmax partial of q [B,N,1,D] against k/v
    [B,Nk,T,D] over the positions where `valid` [B, T] is True (None: all),
    columns >= n_valid masked, columns < col_lo masked (the sliding-window
    lower bound in this buffer's local coordinates).  Returns (m, l, acc)
    of shapes [B,N,1], [B,N,1], [B,N,1,D] in fp32; a fully masked partial
    has m = -1e30, neutral under the merge.  GQA through a grouped query
    axis (the cache is never repeated)."""
    b, n, _, d = q.shape
    nk, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, nk, n // nk, 1, d).float()
    s = torch.einsum("bngid,bnjd->bngij", qg, k.float()) * scale
    if n_valid is not None or col_lo is not None:
        cols = torch.arange(t, device=k.device)
        keep = torch.ones(t, dtype=torch.bool, device=k.device)
        if n_valid is not None:
            keep &= cols < n_valid
        if col_lo is not None:
            keep &= cols >= col_lo
        s = s.masked_fill(~keep, float("-inf"))
    if valid is not None:
        s = s.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    # fully-masked partial: exp(-inf - -inf) guard
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bngij,bnjd->bngid", p, v.float())
    m = torch.where(torch.isfinite(m), m, -1e30)
    return (m.reshape(b, n, 1), l.reshape(b, n, 1), acc.reshape(b, n, 1, d))


def dist_decode_step(params, token, position: int, cache: DistCache,
                     cfg: ModelConfig, mesh):
    """One token: [B] int -> (fp32 logits [B, vocab], updated cache).
    `position` is the token's global position (the prompt length plus the
    tokens decoded before it).  Per layer: each ring position's partial
    over its columns of the shard, a log-space merge across positions,
    the token's k/v written into the recent buffer at n_new, a partial
    over the n_new + 1 recent columns, and the final merge.  The recent
    buffers are updated in place."""
    check_serving(cfg)
    dev = cache.k_shard[0].device
    n_inter, n_intra = as_mesh(mesh, dev).ring(cfg.seq_axes)
    world = n_inter * n_intra
    token = torch.as_tensor(token, device=dev).long()
    b = token.shape[0]
    scale = cfg.d_head ** -0.5
    n_new = cache.n_new
    if n_new >= cache.k_new[0].shape[2]:
        raise ValueError(f"recent buffer full ({n_new} tokens): raise "
                         "dist_prefill's gen_budget")
    s_loc = cache.k_shard[0].shape[2] // world
    with torch.no_grad():
        x = params["embed"][token[:, None]].to(cfg.dtype)  # [B, 1, d]
        pos = torch.full((b, 1), int(position), device=dev)
        for li, p in enumerate(params["layers"]):
            q, k, v = _qkv_proj(p, x, pos, cfg)
            kc, vc = cache.k_shard[li], cache.v_shard[li]
            parts = []
            for w in range(world):
                col_lo = None
                if cfg.window is not None:
                    # contig layout (the windowed models' only one): this
                    # shard's first token is globally at part * s_loc
                    part = _page_partition(w, n_inter, n_intra)
                    col_lo = int(position) - cfg.window + 1 - part * s_loc
                cols = slice(w * s_loc, (w + 1) * s_loc)
                parts.append(_partial_attn(q, kc[:, :, cols], vc[:, :, cols],
                                           scale, col_lo=col_lo))
            # merge across the ring positions in log space: the max of m,
            # then the sums of the rescaled l and acc (pmax / psum)
            m_g = parts[0][0]
            for m_w, _, _ in parts[1:]:
                m_g = torch.maximum(m_g, m_w)
            l_g = sum(l_w * torch.exp(m_w - m_g) for m_w, l_w, _ in parts)
            acc_g = sum(a_w * torch.exp(m_w - m_g)[..., None]
                        for m_w, _, a_w in parts)
            # the recent tokens + the token being computed; slot j holds
            # global position position - n_new + j, so the band's lower
            # bound lands at slot n_new - window + 1
            kr, vr = cache.k_new[li], cache.v_new[li]
            kr[:, :, n_new] = k[:, :, 0].to(cfg.dtype)
            vr[:, :, n_new] = v[:, :, 0].to(cfg.dtype)
            rec_lo = n_new - cfg.window + 1 if cfg.window is not None \
                else None
            rec = _partial_attn(q, kr, vr, scale, n_valid=n_new + 1,
                                col_lo=rec_lo)
            o = _merge([(m_g, l_g, acc_g), rec]).to(cfg.dtype)
            x = x + _attn_out(p, o)
            x = x + _mlp(p, x, cfg, inference=True)[0]
        logits = _logits(_rms_norm(x, params["final_norm"]),
                         params["lm_head"])[:, 0]
    return logits, cache._replace(n_new=n_new + 1)


def dist_generate(params, prompt, cfg: ModelConfig, mesh, *, steps: int,
                  temperature: float = 0.0, top_k=None, top_p=None,
                  generator: Optional[torch.Generator] = None):
    """Greedy or sampled generation with the sequence-sharded prompt
    cache: prompt [B, S] natural order -> [B, steps] int64 tokens on the
    params' device.  Sampling is models.decode.sample_logits's, its draws
    from `generator` (a torch.Generator on the params' device; greedy
    needs none)."""
    check_serving(cfg)
    from .decode import sample_logits

    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    prompt = torch.as_tensor(prompt, device=params["embed"].device).long()
    s = prompt.shape[1]

    def pick(logits):
        return sample_logits(logits, generator, temperature=temperature,
                             top_k=top_k, top_p=top_p)

    last_logits, cache = dist_prefill(params, prompt, cfg, mesh,
                                      gen_budget=steps)
    out = [pick(last_logits)]
    for i in range(steps - 1):
        logits, cache = dist_decode_step(params, out[-1], s + i, cache, cfg,
                                         mesh)
        out.append(pick(logits))
    return torch.stack(out, dim=1)


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
    check_serving(cfg)
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
        x = x + _mlp(p, x, cfg, inference=True)[0]
    logits = _logits(_rms_norm(x, params["final_norm"]),
                     params["lm_head"])[:, 0]
    logits = logits.masked_fill(boundary_unassigned[:, None], float("nan"))
    state.lengths.copy_(lengths_new)
    return logits, state
