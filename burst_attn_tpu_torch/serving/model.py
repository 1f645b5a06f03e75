"""The model step behind RaggedServeEngine (port of
burst_attn_tpu/serving/model.py): scatter each slot's new tokens' K/V into
its pool pages, attend the whole ragged batch in one kernel launch per
layer, return next-token logits.

One function serves every engine tick shape: per-slot `q_lens` is a
tensor (0 = idle slot, 1 = decode, up to the chunk width = prefill), so
admission, retirement and chunking change no shape.

`attn` selects the attention: "ragged" is the one-launch kernel
(ops/ragged_paged.py); "grouped" its shared-prefix front end; "dense" the
gather-based route the engine takes when `ragged_supported` declines the
shape — same math, O(slots·max_ctx) memory.  Each takes cfg.window.

In place: the JAX step donates the state and returns a new one; here the
pools, scale banks and lengths are updated IN PLACE and the same state is
returned.  Loud-failure contract (models/paged_decode.py's): a live slot
whose tokens would land in an unassigned (page 0) table column gets NaN
logits, and the engine raises instead of attending sink-page garbage.

Host-side table edits (`assign_pages`, `free_slots`, `cow_pages`) read
the device state once per call, never once per slot of a tick.
`pipelined_tick` and `multi_step_decode` are not ported yet.
"""

import torch

from ..models.paged_decode import PagedState, PagePool, _write_tokens
from ..models.transformer import (
    ModelConfig, _attn_out, _logits, _mlp, _qkv_proj, _rms_norm,
)
from ..ops.paged_attention import pool_bytes
from ..ops.ragged_paged import (
    ragged_paged_attention, ragged_paged_attention_grouped,
    ragged_paged_reference,
)


def ragged_model_step(params, tokens, q_lens, state: PagedState,
                      cfg: ModelConfig, attn: str = "ragged",
                      all_logits: bool = False, group_id=None,
                      shared_table=None, shared_lens=None):
    """Advance every active slot by its own token count in ONE pass, IN
    PLACE on `state`.

    tokens  [slots, QT] int — slot s consumes tokens[s, :q_lens[s]] (the
            rest is padding; idle slots pass q_lens == 0)
    q_lens  [slots] int32 — tokens this launch per slot; each slot's pages
            for positions lengths .. lengths+q_lens-1 must be assigned

    attn == "grouped" routes the shared-prefix launch: (group_id [slots],
    shared_table [G, n_sh], shared_lens [G]) assign each slot to a prefix
    group whose pinned pages are scored once and merged with the slot's
    private band.

    Returns (logits, state with lengths += q_lens):
      all_logits=False: [slots, vocab] fp32 at each slot's LAST consumed
        token — the next-token distribution a scheduler samples from.
      all_logits=True:  [slots, QT, vocab] fp32.
    No host sync."""
    if attn not in ("ragged", "dense", "grouped"):
        raise ValueError(
            f"attn must be 'ragged', 'dense' or 'grouped', got {attn!r}")
    if attn == "grouped" and (group_id is None or shared_table is None
                              or shared_lens is None):
        raise ValueError("attn='grouped' needs group_id, shared_table "
                         "and shared_lens")
    dev = state.lengths.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    q_lens = torch.as_tensor(q_lens, device=dev).to(torch.int32)
    slots, qt = tokens.shape
    page = state.k_pages[0].shape[2]
    width = state.page_table.shape[1]
    quant = state.k_scales is not None
    live = q_lens > 0
    base = torch.where(live, state.lengths, 0)
    t_ix = torch.arange(qt, device=dev)[None, :]
    real = (t_ix < q_lens[:, None]) & live[:, None]          # [slots, QT]
    pos = base.long()[:, None] + t_ix                         # absolute
    pids = state.page_table.gather(1, (pos // page).clamp(max=width - 1))
    # a live slot's REAL token mapping to the sink page means its page was
    # never assigned: poison its logits
    boundary_unassigned = (real & (pids == 0)).any(dim=1)
    # padding/idle tokens scatter into the reserved sink page 0 (the only
    # place where the scatter has duplicate indices)
    pids = torch.where(real, pids, 0).long()
    offs = pos % page
    kv_lens = (base + q_lens).to(torch.int32)

    x = params["embed"][tokens].to(cfg.dtype)                 # [S, QT, dm]
    for li, p in enumerate(params["layers"]):
        kp, vp = state.k_pages[li], state.v_pages[li]
        q, k, v = _qkv_proj(p, x, pos, cfg)
        # scatter the new K/V FIRST so attention reads a complete pool
        ks = state.k_scales[li] if quant else None
        vs = state.v_scales[li] if quant else None
        _write_tokens(kp, ks, pids, offs, k.transpose(1, 2))  # [S,QT,Nkv,D]
        _write_tokens(vp, vs, pids, offs, v.transpose(1, 2))
        if attn == "ragged":
            o = ragged_paged_attention(q, kp, vp, state.page_table, q_lens,
                                       kv_lens, k_scales=ks, v_scales=vs,
                                       window=cfg.window)
        elif attn == "grouped":
            o = ragged_paged_attention_grouped(
                q, kp, vp, state.page_table, q_lens, kv_lens,
                group_id=group_id, shared_table=shared_table,
                shared_lens=shared_lens, k_scales=ks, v_scales=vs,
                window=cfg.window)
        else:  # the kernel's plain version: gathers every slot's pages
            o = ragged_paged_reference(q, kp, vp, state.page_table, q_lens,
                                       kv_lens, k_scales=ks, v_scales=vs,
                                       window=cfg.window)
        x = x + _attn_out(p, o)
        x = x + _mlp(p, x)
    x = _rms_norm(x, params["final_norm"])
    if all_logits:
        logits = _logits(x, params["lm_head"])
        logits = logits.masked_fill(boundary_unassigned[:, None, None],
                                    float("nan"))
    else:
        last = (q_lens.long() - 1).clamp(0, qt - 1)
        x_last = x.gather(1, last[:, None, None].expand(-1, 1, x.shape[-1]))
        logits = _logits(x_last, params["lm_head"])[:, 0]
        logits = logits.masked_fill(boundary_unassigned[:, None],
                                    float("nan"))
    state.lengths.add_(torch.where(live, q_lens, 0))
    return logits, state


def assign_pages(state: PagedState, slot: int, ids) -> PagedState:
    """Host-side: point `slot`'s table row at freshly acquired pages (the
    engine reserves a request's FULL lifetime at admission, before any
    token lands).  The slot's length stays 0 until the first chunk; the
    slot must be empty (freed) first.  One readback, one upload."""
    if not ids:
        return state
    if int(state.lengths[slot]) != 0:
        raise RuntimeError(f"slot {slot} is still live; free_slot first")
    state.page_table[slot, :len(ids)] = torch.tensor(
        ids, dtype=torch.int32, device=state.page_table.device)
    return state


def _copy_pages(state: PagedState, src, dst) -> PagedState:
    """Copy-on-write's device half, IN PLACE: every layer's K/V at pages
    src[i] goes to pages dst[i], and on a quantized pool the per-token
    scales with them — a page column is never separated from its scale
    column."""
    dev = state.page_table.device
    src = torch.as_tensor(src, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.long, device=dev)
    banks = list(state.k_pages) + list(state.v_pages)
    if state.k_scales is not None:
        banks += list(state.k_scales) + list(state.v_scales)
    for bank in banks:
        b = pool_bytes(bank)
        b[dst] = b[src]
    return state


def cow_pages(state: PagedState, pool: PagePool, slot: int,
              n_tokens: int, cache=None):
    """Copy-on-write barrier: make every page that will receive K/V writes
    for `slot`'s next `n_tokens` tokens PRIVATE (refcount 1) before the
    step scatters into it.

    The scatter in ragged_model_step targets table columns
    lengths//page .. (lengths+n_tokens-1)//page; any of those pages the
    allocator holds at refcount > 1 (pinned by the prefix cache and/or
    other slots) is copied to a fresh page, the table column is rewritten
    to the copy, and one reference on the shared page is dropped.  Reads
    the slot's length and table row once (callers gate on
    pool.has_shared).

    Returns (state, copies) where copies is [(col, shared_pid, new_pid)].
    Raises RuntimeError if the pool cannot supply a replacement page even
    after evicting unpinned cache pages (`cache` optional)."""
    if n_tokens <= 0:
        return state, []
    page = state.k_pages[0].shape[2]
    length = int(state.lengths[slot])
    first, last = length // page, (length + int(n_tokens) - 1) // page
    row = state.page_table[slot].tolist()
    copies = []
    for col in range(first, min(last, len(row) - 1) + 1):
        pid = int(row[col])
        if pid == 0 or pool.refcount(pid) <= 1:
            continue
        if pool.available < 1 and cache is not None:
            cache.evict(1)
        if pool.available < 1:
            raise RuntimeError(
                f"copy-on-write for slot {slot} col {col}: pool exhausted "
                f"(page {pid} shared at refcount {pool.refcount(pid)})")
        (new,) = pool.acquire(1)
        _copy_pages(state, [pid], [new])
        state.page_table[slot, col] = new
        pool.release([pid])
        copies.append((col, pid, new))
    return state, copies


def free_slot(state: PagedState, pool: PagePool, slot: int) -> PagedState:
    """Host-side: release EVERY page in `slot`'s table row and empty it.
    Unlike paged_decode.retire_slot it does not stop at length 0: the
    ragged engine assigns pages at admission, before the first chunk, so a
    slot can hold pages at length 0 and they must not leak."""
    return free_slots(state, pool, [slot])


def free_slots(state: PagedState, pool: PagePool, slots) -> PagedState:
    """Batched free_slot: one table readback and one write no matter how
    many slots retire this tick (pages release in slot order)."""
    slots = list(slots)
    if not slots:
        return state
    table = state.page_table.cpu()
    for slot in slots:
        ids = [i for i in table[slot].tolist() if i != 0]
        if ids:
            pool.release(ids)
    idx = torch.tensor(slots, dtype=torch.long,
                       device=state.page_table.device)
    state.page_table[idx] = 0
    state.lengths[idx] = 0
    return state
