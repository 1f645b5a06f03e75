"""The model step behind RaggedServeEngine (port of
burst_attn_tpu/serving/model.py): scatter each slot's new tokens' K/V into
its pool pages, attend the whole ragged batch in one kernel launch per
layer, return next-token logits.  `ragged_model_step` itself lives in
models/paged_decode.py, beside the paged steps it generalizes (its
`paged_multi_step` is one call of it), and is exported here.

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
the device state once per call, never once per slot of a tick;
`cow_pages` reads none when the caller passes the slot's length and table
row from its host mirror.

The pipelined engine's two launches: `pipelined_tick` is the tick with
the sampled choice left on the device; `multi_step_decode` runs K
pure-decode ticks, on the card as ONE replay of a CUDA graph captured over
the K tick bodies (`DecodeGraphs`, the counterpart of the JAX package's
one `lax.scan` launch), on the CPU as K eager ticks.
"""

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..models.decode import sample_logits
from ..models.paged_decode import PagePool, PagedState, ragged_model_step
from ..models.transformer import ModelConfig
from ..ops import ragged_paged as _rp
from ..ops.paged_attention import pool_bytes


def upload(values, dtype, device):
    """Host values (a list or numpy array) as a tensor on `device`.  To a
    CUDA device through pinned memory with non_blocking=True: the copy
    waits for nothing the device is running, where one from pageable
    memory synchronizes the stream."""
    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def pipelined_tick(params, tokens, q_lens, state: PagedState, rng,
                   cfg: ModelConfig, *, attn: str = "ragged",
                   temperature: float = 0.0, top_k=None, top_p=None,
                   group_id=None, shared_table=None, shared_lens=None):
    """One engine tick with the sampled choice kept ON THE DEVICE: the
    synchronous engine's ragged_model_step followed by the same
    sample_logits(nan_sentinel=True) draw from `rng`, with nothing read
    back.  The pipelined engine feeds the choice straight into its next
    launch and reads it back one tick later.

    Returns (choice [slots] int64 on the state's device, state)."""
    logits, state = ragged_model_step(
        params, tokens, q_lens, state, cfg, attn=attn, group_id=group_id,
        shared_table=shared_table, shared_lens=shared_lens)
    choice = sample_logits(logits, rng, temperature=temperature,
                           top_k=top_k, top_p=top_p, nan_sentinel=True)
    return choice, state


def _decode_ticks(params, toks, q_lens, state, rng, cfg, k, attn,
                  temperature, top_k, top_p):
    """k decode ticks, each feeding its choice into the next: [k, slots]
    int64.  The body of multi_step_decode, eager or captured."""
    outs = []
    for _ in range(k):
        toks, _ = pipelined_tick(params, toks[:, None], q_lens, state, rng,
                                 cfg, attn=attn, temperature=temperature,
                                 top_k=top_k, top_p=top_p)
        outs.append(toks)
    return torch.stack(outs)


def multi_step_decode(params, first_toks, q_lens, state: PagedState, rng,
                      cfg: ModelConfig, *, k: int, attn: str = "ragged",
                      temperature: float = 0.0, top_k=None, top_p=None,
                      graphs: Optional["DecodeGraphs"] = None):
    """K pure-decode ticks fused into one launch.

    Each tick is pipelined_tick at q_len 1 per live slot, feeding its
    choice into the next, so the choices and the draws from `rng` are
    exactly what k consecutive synchronous ticks give.

    first_toks [slots] int — each live slot's next token (the previous
               launch's choice, possibly still in flight on the device)
    q_lens     [slots] int32 — 1 for live slots, 0 idle; constant across
               the k ticks (no admission or retirement inside the window)

    On a CUDA state the k ticks are ONE replay of the CUDA graph that
    `graphs` holds for (k, attn, sampling settings), captured at first
    use (None: a graph captured for this call alone).  The returned
    choices are then that graph's output buffer, valid until its next
    replay.  A failed capture or replay raises; no eager loop stands in.
    On a CPU state the k ticks run eagerly.

    Returns (choices [k, slots] int64, state with lengths += k * q_lens,
    rng after k ticks' draws).  A NaN-poisoned row samples -1, as in the
    synchronous tick."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev = state.lengths.device
    if dev.type != "cuda":
        toks = torch.as_tensor(first_toks, device=dev).reshape(-1).long()
        return (_decode_ticks(params, toks, q_lens, state, rng, cfg, k, attn,
                              temperature, top_k, top_p), state, rng)
    if graphs is None:
        graphs = DecodeGraphs(params, state, cfg, rng)
    elif not (graphs.params is params and graphs.state is state
              and graphs.generator is rng and graphs.cfg == cfg):
        raise ValueError("graphs are bound to other params, state or rng")
    return (graphs.replay(first_toks, q_lens, k=k, attn=attn,
                          temperature=temperature, top_k=top_k, top_p=top_p),
            state, rng)


class _Graph(NamedTuple):
    graph: object          # torch.cuda.CUDAGraph
    feed: torch.Tensor     # [slots] int64 input: the first tick's tokens
    q_lens: torch.Tensor   # [slots] int32 input
    out: torch.Tensor      # [k, slots] int64 output: the choices
    launches: int          # kernel 7 launches a replay makes


class DecodeGraphs:
    """CUDA graphs of k fused decode ticks, one per (k, attn, temperature,
    top_k, top_p), bound by address to one engine's params, paged state
    and generator.  Every write the engine makes to the state between
    replays (admission, retirement, copy-on-write, a lengths rollback)
    must stay in place, and the generator is registered with each graph,
    so a replay draws from its current offset and advances it by k
    ticks' draws.

    A capture first runs the k tick bodies once on its own stream with
    every q_len 0 (the padding scatters into the sink page; no length,
    table row or live page changes): that loads the kernels and
    allocates their per-stream split counters and cuBLAS's workspace
    outside the capture.  The generator is restored after it.  A replay
    adds the kernel launches its capture recorded to the wrappers'
    counters (the capture itself launches nothing and counts nothing).
    `captures`, `replays` and `warmup_ticks` (the ticks the warm-ups ran)
    count.  Each graph keeps its captured cudaGraph_t beside the
    executable (`raw_cuda_graph()`: the analyzer lists its nodes)."""

    def __init__(self, params, state: PagedState, cfg: ModelConfig,
                 generator: Optional[torch.Generator]):
        self.params, self.state, self.cfg = params, state, cfg
        self.generator = generator
        self._graphs: Dict[Tuple, _Graph] = {}
        self._stream = None
        self.captures = 0
        self.replays = 0
        self.warmup_ticks = 0

    def replay(self, first_toks, q_lens, *, k, attn, temperature, top_k,
               top_p):
        """Copy the feed and q_lens into the graph's inputs (device or
        pinned host tensors: no host sync) and replay it; returns its
        [k, slots] choices buffer."""
        key = (k, attn, float(temperature), top_k, top_p)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(*key)
        g.feed.copy_(torch.as_tensor(first_toks).reshape(-1),
                     non_blocking=True)
        g.q_lens.copy_(torch.as_tensor(q_lens).reshape(-1),
                       non_blocking=True)
        g.graph.replay()
        self.replays += 1
        _rp.ragged_paged_attention.launches += g.launches
        return g.out

    def _capture(self, k, attn, temperature, top_k, top_p) -> _Graph:
        dev = self.state.lengths.device
        slots = self.state.lengths.shape[0]
        feed = torch.zeros(slots, dtype=torch.long, device=dev)
        q_lens = torch.zeros(slots, dtype=torch.int32, device=dev)
        rng = self.generator if temperature > 0 else None

        def body():
            return _decode_ticks(self.params, feed, q_lens, self.state, rng,
                                 self.cfg, k, attn, temperature, top_k,
                                 top_p)

        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream = self._stream
        saved = rng.get_state() if rng is not None else None
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            body()  # the warm-up, at q_len 0
        if rng is not None:
            rng.set_state(saved)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if rng is not None:
            graph.register_generator_state(rng)
        before = _rp.ragged_paged_attention.launches
        with torch.cuda.graph(graph, stream=stream):
            out = body()
        graph.instantiate()
        launches = _rp.ragged_paged_attention.launches - before
        _rp.ragged_paged_attention.launches = before
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.captures += 1
        self.warmup_ticks += k
        return _Graph(graph, feed, q_lens, out, launches)


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
    src, dst = upload(src, torch.long, dev), upload(dst, torch.long, dev)
    banks = list(state.k_pages) + list(state.v_pages)
    if state.k_scales is not None:
        banks += list(state.k_scales) + list(state.v_scales)
    for bank in banks:
        b = pool_bytes(bank)
        b[dst] = b[src]
    return state


def cow_pages(state: PagedState, pool: PagePool, slot: int,
              n_tokens: int, cache=None, length: Optional[int] = None,
              row=None):
    """Copy-on-write barrier: make every page that will receive K/V writes
    for `slot`'s next `n_tokens` tokens PRIVATE (refcount 1) before the
    step scatters into it.

    The scatter in ragged_model_step targets table columns
    lengths//page .. (lengths+n_tokens-1)//page; any of those pages the
    allocator holds at refcount > 1 (pinned by the prefix cache and/or
    other slots) is copied to a fresh page, the table column is rewritten
    to the copy, and one reference on the shared page is dropped.  Reads
    the slot's length and table row once (callers gate on
    pool.has_shared), or takes them from the caller's host mirror
    (`length`, `row`: then nothing waits on the device).

    Returns (state, copies) where copies is [(col, shared_pid, new_pid)].
    Raises RuntimeError if the pool cannot supply a replacement page even
    after evicting unpinned cache pages (`cache` optional)."""
    if n_tokens <= 0:
        return state, []
    page = state.k_pages[0].shape[2]
    if length is None:
        length = int(state.lengths[slot])
    first, last = length // page, (length + int(n_tokens) - 1) // page
    row = state.page_table[slot].tolist() if row is None else list(row)
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
