"""The long-context handoff (port of burst_attn_tpu/serving/handoff.py): a
ring-sharded prefill whose K/V lands DIRECTLY in pool pages, feeding
sequence-parallel paged decode.

  1. PREFILL at ring scale: each layer's attention is `burst_attn` over
     the ring (cfg.attn_backend picks the route: "fused_ring" runs the
     whole ring in one kernel launch, "auto" the scan ring over the flash
     kernel);
  2. HANDOFF: each layer's rope'd K/V is scattered straight from the
     ring's layout-order activations into pool pages, with no re-layout
     copy: page p holds layout positions [p*page, (p+1)*page);
  3. DECODE: models/dist_decode.dist_paged_decode_step shards the pool's
     pages over the same ring positions and LSE-merges their partials;
     `handoff_decode` runs it in restartable greedy strides, journaling
     each token before the next step (crash consistency: a killed decode
     resumes from its last durable token, or from a paged snapshot,
     instead of re-running the ring prefill).

Skipping the re-layout is correct because decode attends EVERY cached
position and full-visibility attention is permutation-invariant; that
needs cfg.window=None.  The pool is the single-host engines' PagedState /
PagePool, so a handed-off slot can also be decoded by paged_decode_step.
The ring's positions share one device (parallel/mesh.py).
"""

import numpy as np
import torch

from ..models.decode import sample_logits
from ..models.dist_decode import dist_paged_decode_step, ring_forward
from ..models.paged_decode import (
    PagedState, PagePool, _scatter_pages, provision_capacity,
    write_table_row,
)
from ..models.transformer import (
    ModelConfig, _logits, _rms_norm, check_serving,
)
from ..parallel import layouts


def check_handoff_preconditions(state: PagedState, pool: PagePool,
                                slot: int, n_tokens: int,
                                cfg: ModelConfig, *, steps: int = 0) -> int:
    """Validate EVERY admission precondition of a handoff (prompt shape,
    window mode, slot state, table width, pool pages for the prompt PLUS
    the decode budget `steps`) before a single page is acquired or a
    single state field changed: a raise here leaves the pool and the state
    exactly as they were.  Returns the prompt's page count."""
    page = int(state.k_pages[0].shape[2])
    if cfg.window is not None:
        raise ValueError("ring_prefill_to_pages requires cfg.window=None "
                         "(layout-order pages; see module docstring)")
    if n_tokens <= 0:
        raise ValueError(f"empty prompt (n_tokens={n_tokens})")
    if n_tokens % page:
        raise ValueError(f"prompt length {n_tokens} must be a multiple of "
                         f"the page size {page} for the direct-scatter "
                         f"handoff")
    if steps < 0:
        raise ValueError(f"negative decode budget ({steps})")
    if not 0 <= slot < state.lengths.shape[0]:
        raise ValueError(f"slot {slot} out of range "
                         f"[0, {state.lengths.shape[0]})")
    n_prefill = n_tokens // page
    n_total = -(-(n_tokens + steps) // page)
    if n_total > state.page_table.shape[1]:
        raise ValueError(f"request needs {n_total} pages (prompt "
                         f"{n_prefill} + decode budget {steps} tokens) > "
                         f"table width {state.page_table.shape[1]}")
    if int(state.lengths[slot]) != 0:
        raise RuntimeError(f"slot {slot} is still live; retire it first")
    if pool.available < n_total:
        raise RuntimeError(f"page pool exhausted: want {n_total}, have "
                           f"{pool.available}")
    return n_prefill


def ring_prefill_to_pages(params, tokens, state: PagedState, pool: PagePool,
                          slot: int, cfg: ModelConfig, mesh):
    """Absorb a [S] prompt into batch slot `slot` with the ring-sharded
    forward, landing each layer's K/V directly in pool pages, IN PLACE.
    Returns (last-token logits [vocab] fp32, state).  S must be a page
    multiple and divide by the ring's world (as the layout requires);
    every precondition is checked first, and a failure during the pass
    releases the pages it acquired."""
    check_serving(cfg)
    tokens = np.asarray(tokens).reshape(-1)
    n_need = check_handoff_preconditions(state, pool, slot,
                                         int(tokens.shape[0]), cfg)
    ids = pool.acquire(n_need)
    try:
        logits = _ring_prefill(params, tokens, state, ids, slot, cfg, mesh)
    except Exception:
        pool.release(ids)
        raise
    return logits, state


def _ring_forward(params, tokens, cfg: ModelConfig, mesh, on_kv=None):
    """models.dist_decode.ring_forward of a [S] prompt (batch 1): returns
    (hidden states [1, S, d_model] before the final norm, in layout
    order; the layout permutation)."""
    tokens = torch.from_numpy(np.asarray(tokens).reshape(1, -1)
                              .astype(np.int64))
    return ring_forward(params, tokens, cfg, mesh, on_kv)


def _ring_prefill(params, tokens, state: PagedState, ids, slot,
                  cfg: ModelConfig, mesh):
    """The forward with the cache capture replaced by a paged scatter:
    K/V stays in layout order end to end, the pages ARE the sharded
    cache."""
    dev = state.lengths.device
    page_ids = torch.tensor(ids, dtype=torch.long, device=dev)
    quant = state.k_scales is not None

    def to_pages(li, k, v):
        # THE handoff: layout-order K/V -> pool pages, no re-layout copy
        _scatter_pages(state.k_pages[li], k, page_ids,
                       state.k_scales[li] if quant else None)
        _scatter_pages(state.v_pages[li], v, page_ids,
                       state.v_scales[li] if quant else None)

    x, perm = _ring_forward(params, tokens, cfg, mesh, to_pages)
    # the last NATURAL token sits at layout position inv_perm[s - 1]
    s = int(tokens.shape[0])
    last = int(layouts.inverse_permutation(perm)[s - 1])
    xf = _rms_norm(x[:, last:last + 1], params["final_norm"])
    logits = _logits(xf, params["lm_head"])[0, 0]
    write_table_row(state, slot, page_ids)
    state.lengths[slot] = s
    return logits


def handoff_generate(params, prompt, state: PagedState, pool: PagePool,
                     cfg: ModelConfig, mesh, *, steps: int, slot: int = 0,
                     temperature: float = 0.0, top_k=None, top_p=None,
                     rng=None):
    """End-to-end long-context path on one slot: ring prefill into pool
    pages, provision the decode budget, then sequence-parallel paged
    decode steps.  Returns ([steps] tokens, state).  Sampling follows
    models.decode.sample_logits; `rng` is a torch.Generator on the
    state's device (greedy at temperature 0 needs none).  Admission is
    all-or-nothing: the decode budget is validated with the prompt's
    pages before the ring pass runs, so a rejected request mutates
    nothing."""
    check_serving(cfg)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    prompt = np.asarray(prompt).reshape(-1)
    check_handoff_preconditions(state, pool, slot, int(prompt.shape[0]),
                                cfg, steps=steps)
    last_logits, state = ring_prefill_to_pages(params, prompt, state, pool,
                                               slot, cfg, mesh)
    state = provision_capacity(state, pool, slot, steps)

    def pick(logits):
        tok = int(sample_logits(logits[None, :], rng,
                                temperature=temperature, top_k=top_k,
                                top_p=top_p, nan_sentinel=True)[0])
        if tok < 0:
            raise RuntimeError("handoff logits are NaN-poisoned")
        return tok

    out = [pick(last_logits)]
    feed = torch.zeros(state.lengths.shape[0], dtype=torch.long)
    for _ in range(steps - 1):
        feed[slot] = out[-1]
        logits, state = dist_paged_decode_step(params, feed, state, cfg,
                                               mesh)
        out.append(pick(logits[slot]))
    return out, state


def handoff_decode(params, state: PagedState, cfg: ModelConfig, mesh, *,
                   slot: int, last_token: int, n_steps: int, journal=None,
                   rid: int = 0):
    """Resumable greedy decode on an already-provisioned handoff slot:
    `n_steps` sequence-parallel paged steps (dist_paged_decode_step)
    continuing from `last_token`, the newest token already in the stream
    (prefill-sampled or journal-recovered).  Returns ([n_steps] tokens,
    state).

    The caller owns the split: after `ring_prefill_to_pages` +
    `provision_capacity`, or after `serving.checkpoint.load_paged_snapshot`
    rebuilt the state, decode proceeds in strides, and with a `journal`
    (a TokenJournal) each emitted token is appended under `rid` and
    fsynced before the next step (write-ahead), so a killed decode resumes
    from its last durable token.  Greedy only: a resumed stream must be
    the continuation the dead decode would have produced.  A step whose
    logits are NaN (the slot stepped past its provisioned pages)
    raises."""
    check_serving(cfg)
    feed = torch.zeros(state.lengths.shape[0], dtype=torch.long)
    cur = int(last_token)
    out = []
    for i in range(n_steps):
        feed[slot] = cur
        logits, state = dist_paged_decode_step(params, feed, state, cfg, mesh)
        cur = int(sample_logits(logits[slot][None, :], nan_sentinel=True)[0])
        if cur < 0:
            raise RuntimeError(
                f"handoff decode step {i} logits are NaN-poisoned: slot "
                f"{slot} stepped without provisioned capacity")
        out.append(cur)
        if journal is not None:
            journal.tokens(rid, [cur])
            journal.sync()
    return out, state
