"""RaggedServeEngine: continuous batching over the one-launch ragged kernel
(port of burst_attn_tpu/serving/engine.py, the synchronous engine).

models/serve.py's engine prefills a whole prompt at admission and then
decodes one token per tick — a long prompt stalls every in-flight stream
for its full prefill.  This engine schedules PREFILL AS CHUNKS through the
same launch that decodes:

  * submit() queues; admission reserves a request's FULL page lifetime up
    front (prompt + budget — a mid-generation OOM is impossible by
    construction) but moves no tokens.
  * Every tick builds one ragged batch: each mid-prefill slot consumes its
    next `chunk` prompt tokens, each decoding slot its single next token,
    idle slots ride along with q_len 0.  One `ragged_model_step` serves
    them all (one kernel launch per layer); a slot whose chunk completes
    its prompt samples its first token THAT tick.
  * Load shedding (`max_queue`): POOL pressure sheds before QUEUE
    pressure; an optional `admission` policy sheds early with hysteresis.
    Every rejection is a typed InvalidRequest / LoadShed; `try_submit()`
    is the non-raising surface.
  * Prefix cache (`prefix_cache=True`): admission looks the prompt's
    full-page hash chain up, pins the hit pages by refcount and resumes
    the chunked prefill at the divergence point (a full-prompt hit at
    T-1); every write into a shared page goes through the copy-on-write
    barrier first; ticks where >= 2 live slots share pinned pages run the
    grouped launch (`group_attn`).
  * `quantize=True | "int8" | "fp8"` stores the pool at 1 B/elem.

Kernel routing: `ragged_supported` probes each launch width once, on shape
alone; a declined shape takes the dense route and counts one
`burst.fused_fallback{reason=...,pass=serve}`.  A build or launch failure
raises.

Metrics: the JAX engine's obs instruments are not ported; `stats` keeps
the counts under the JAX counter names (`serve.ragged_batch_launches`
by kind, `serve.prefix_hits`, `serve.cow_copies`,
`serve.prefill_tokens_skipped`, `burst.fused_fallback`), plus
`serve.grouped_launches`, the ticks that took the grouped launch.

Not ported yet: speculative decoding (`draft_params`), the journal,
`pipeline=True` and `multi_step > 1`.
"""

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..admission import (
    AdmissionPolicy, InvalidRequest, LoadShed, RejectReason, SubmitRejected,
    SubmitResult,
)
from ..device import resolve_device
from ..models.decode import sample_logits
from ..models.paged_decode import PrefixCache, init_paged_state
from ..models.transformer import ModelConfig
from ..ops.ragged_paged import ragged_supported
from .model import assign_pages, cow_pages, free_slot, free_slots, \
    ragged_model_step

# reason-string prefix -> bounded counter label (probe reasons embed
# shapes, which would explode label cardinality verbatim)
_FALLBACK_LABELS = (
    ("empty q chunk", "empty-chunk"),
    ("GQA group mismatch", "gqa-group"),
    ("page size", "page-size"),
    ("q-block rows", "block-rows"),
    ("shared-memory plan", "smem-budget"),
    ("head dim", "head-dim"),
    ("dtype", "dtype"),
)


def _fallback_label(reason: str) -> str:
    for prefix, label in _FALLBACK_LABELS:
        if reason.startswith(prefix):
            return label
    return "other"


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray          # [T] int32
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    n_prefilled: int = 0        # prompt tokens absorbed so far
    hashes: Optional[List[bytes]] = None  # full-page prefix chain, memoized


class RaggedServeEngine:
    """Host-side continuous-batching loop over ragged_model_step.  Not
    thread-safe; drive it from one thread.  `params` must live on `device`
    (default: the card)."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int, n_pages: int,
                 page: int = 128, max_pages_per_seq: int = 64,
                 quantize=False, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 rng: Optional[torch.Generator] = None,
                 chunk: Optional[int] = None, max_queue: Optional[int] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 draft_params=None, draft_cfg: Optional[ModelConfig] = None,
                 spec_k: int = 4, use_ragged: Optional[bool] = None,
                 prefix_cache: bool = False, group_attn: bool = True,
                 journal=None, pipeline: bool = False, multi_step: int = 1,
                 device=None):
        if draft_params is not None or draft_cfg is not None:
            raise NotImplementedError(
                "speculative serving (draft_params) is not ported yet")
        if journal is not None:
            raise NotImplementedError("the token journal is not ported yet")
        if multi_step < 1:
            raise ValueError(f"multi_step must be >= 1, got {multi_step}")
        if pipeline or multi_step > 1:
            raise NotImplementedError(
                "the pipelined engine (pipeline=True, multi_step > 1) is not "
                "ported yet")
        self.device = resolve_device(device)
        # logits accumulate in fp32: upcast lm_head once, not per tick
        self.params = dict(params, lm_head=params["lm_head"].float())
        self.cfg = cfg
        self.eos_id = eos_id
        self.page = page
        self.chunk = page if chunk is None else chunk
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        self.max_queue = max_queue
        self.admission = admission
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(0)
        self._rng = rng
        self.state, self.pool = init_paged_state(
            cfg, slots=slots, n_pages=n_pages, page=page,
            max_pages_per_seq=max_pages_per_seq, quantize=quantize,
            device=self.device)
        # None: probe per launch width; True/False force a route
        self.use_ragged = use_ragged
        self._attn_cache: Dict[int, str] = {}
        self.cache = PrefixCache(self.pool) if prefix_cache else None
        self.group_attn = group_attn
        # slot -> the shared page ids pinned at admission: the grouping key
        # of attn="grouped"; trimmed when the CoW barrier privatizes a
        # boundary page, dropped at retire/drain
        self._shared: Dict[int, Tuple[int, ...]] = {}
        self.slots: List[Optional[_Request]] = [None] * slots
        self._next_tok = np.zeros((slots,), np.int32)
        self._queue: List[_Request] = []
        self._next_id = 0
        self._finished: Dict[int, List[int]] = {}
        self.stats: Counter = Counter()

    # -- client surface ----------------------------------------------------

    def _occupancy(self) -> float:
        """Fraction of usable pool pages physically held (a shared page
        counts once; page 0 is the sink)."""
        usable = self.pool.n_pages - 1
        return (usable - self.pool.available) / usable if usable else 0.0

    def submit(self, tokens, max_new_tokens: int) -> int:
        """Queue a prompt; returns a request id.  Raises InvalidRequest (a
        ValueError) on malformed / permanently unservable requests,
        LoadShed (a RuntimeError) when shed — both carry a typed
        `.reason`.  Pool pressure sheds BEFORE queue pressure, hard
        exhaustion before the soft `admission` policy."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise InvalidRequest(RejectReason.EMPTY_PROMPT, "empty prompt")
        if max_new_tokens < 1:
            raise InvalidRequest(RejectReason.BAD_BUDGET,
                                 f"max_new_tokens must be >= 1, got "
                                 f"{max_new_tokens}")
        need = self._pages_for(tokens.size, max_new_tokens)
        width = self.state.page_table.shape[1]
        if need > width:
            raise InvalidRequest(RejectReason.TABLE_WIDTH,
                                 f"request needs {need} pages > "
                                 f"max_pages_per_seq {width}")
        if need > self.pool.n_pages - 1:  # page 0 is the reserved sink
            raise InvalidRequest(RejectReason.POOL_SIZE,
                                 f"request needs {need} pages but the pool "
                                 f"only has {self.pool.n_pages - 1} usable "
                                 "pages total")
        if self.max_queue is not None:
            # pool pressure first; pages the prefix cache could evict on
            # demand count as free here
            avail = self.pool.available
            if self.cache is not None:
                avail += self.cache.evictable()
            if self._queue and need > avail:
                raise LoadShed(RejectReason.POOL_EXHAUSTED,
                               f"load shed (pool-exhausted): request needs "
                               f"{need} pages, {avail} free or evictable, "
                               f"{len(self._queue)} already waiting")
            if len(self._queue) >= self.max_queue:
                raise LoadShed(RejectReason.QUEUE_FULL,
                               f"load shed (queue-full): {len(self._queue)} "
                               f"waiting >= max_queue {self.max_queue}")
        if self.admission is not None:
            occ = self._occupancy()
            reason = self.admission.decide(queue_depth=len(self._queue),
                                           pool_occupancy=occ)
            if reason is not None:
                raise LoadShed(reason,
                               f"load shed ({reason}): admission policy — "
                               f"queue_depth={len(self._queue)}, "
                               f"pool_occupancy={occ:.3f}")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Request(rid, tokens, max_new_tokens))
        return rid

    def try_submit(self, tokens, max_new_tokens: int) -> SubmitResult:
        """Non-raising submit for routers: rid on success, typed reason
        (with its `retryable` bit) on rejection."""
        try:
            return SubmitResult(rid=self.submit(tokens, max_new_tokens))
        except SubmitRejected as e:
            return SubmitResult(reason=e.reason, message=str(e))

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def live(self) -> int:
        return sum(r is not None for r in self.slots)

    def results(self) -> Dict[int, List[int]]:
        return dict(self._finished)

    def run(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drive step() until every submitted request finishes."""
        for _ in range(max_steps):
            if not self._queue and self.live == 0:
                return self.results()
            self.step()
        raise RuntimeError(f"run() exceeded {max_steps} steps")

    def drain(self) -> List[int]:
        """Graceful shutdown: release every in-flight slot's pages and put
        its request BACK at the queue head (reset to un-prefilled; greedy
        decode regenerates the identical tokens on re-admission).  Returns
        the requeued rids in their new queue order.  The engine stays
        usable — run() after drain() serves everything."""
        inflight = [req for req in self.slots if req is not None]
        live_slots = [s for s, req in enumerate(self.slots) if req is not None]
        free_slots(self.state, self.pool, live_slots)
        self.slots = [None] * len(self.slots)
        self._shared.clear()
        inflight.sort(key=lambda r: r.rid)
        for req in reversed(inflight):
            req.tokens = []
            req.n_prefilled = 0
            self._queue.insert(0, req)
        return [r.rid for r in inflight]

    # -- engine ------------------------------------------------------------

    def _count(self, name: str, n: int = 1, **labels) -> None:
        if labels:
            name += "{" + ",".join(f"{k}={v}" for k, v in labels.items()) \
                + "}"
        self.stats[name] += n

    def _pages_for(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new) // self.page)

    def _attn_for(self, qt: int) -> str:
        """Attention route for a launch width, probed once per width on
        shape alone; a declined probe counts one labeled fallback."""
        if self.use_ragged is True:
            return "ragged"
        if self.use_ragged is False:
            return "dense"
        if qt not in self._attn_cache:
            reason = ragged_supported(
                n_kv_heads=self.cfg.n_kv_heads, n_q_heads=self.cfg.n_heads,
                q_tokens=qt, d_head=self.cfg.d_head, page=self.page,
                dtype=self.cfg.dtype, device=self.device)
            if reason is not None:
                self._count("burst.fused_fallback",
                            reason=_fallback_label(reason), **{"pass": "serve"})
            self._attn_cache[qt] = "dense" if reason is not None else "ragged"
        return self._attn_cache[qt]

    def _hashes(self, req: _Request) -> List[bytes]:
        if req.hashes is None:
            req.hashes = PrefixCache.chain(req.prompt, self.page,
                                           dtype=self.pool.dtype)
        return req.hashes

    def _register_prefix(self, slot: int, req: _Request) -> None:
        """Register a just-prefilled prompt's full pages.  Runs after the
        prompt-completing chunk, so the ids are the post-CoW ones."""
        if self.cache is None:
            return
        hashes = self._hashes(req)
        if hashes:
            row = self.state.page_table[slot, :len(hashes)].tolist()
            self.cache.insert(hashes, row)

    def _admit(self) -> None:
        """Reserve queued requests' full page lifetime into free slots
        (FIFO; a request that does not fit blocks the ones behind it).  No
        tokens move here — prefill is chunked through later ticks.

        With a prefix cache the head's prompt is first looked up in the
        hash chain: hit pages are pinned and wired into the slot's table,
        the chunked prefill resumes at the divergence point, and only the
        remainder is acquired fresh.  A FULL-prompt hit resumes at T-1:
        the last prompt token is re-absorbed through one chunk (its logits
        sample token 0), and that write into the last shared page is what
        the CoW barrier privatizes."""
        for slot, occupant in enumerate(self.slots):
            if occupant is not None or not self._queue:
                continue
            req = self._queue[0]
            need = self._pages_for(len(req.prompt), req.max_new_tokens)
            hits: List[int] = []
            if self.cache is not None:
                hits = self.cache.lookup(self._hashes(req))
                short = (need - len(hits)) - self.pool.available
                if short > 0:
                    self.cache.evict(short)
                need -= len(hits)
            if need > self.pool.available:
                if hits:
                    self.pool.release(hits)
                break
            ids = self.pool.acquire(need)
            try:
                assign_pages(self.state, slot, hits + ids)
                if hits:
                    t_pre = len(hits) * self.page
                    t_resume = (t_pre if t_pre < len(req.prompt)
                                else len(req.prompt) - 1)
                    self.state.lengths[slot] = t_resume
                    req.n_prefilled = t_resume
                    self._shared[slot] = tuple(hits)
                    self._count("serve.prefix_hits")
                    self._count("serve.prefill_tokens_skipped", t_resume)
            except Exception:
                # free_slot releases hits and ids together (the lookup's
                # pin and the acquire both belong to the row)
                req.n_prefilled = 0
                self._shared.pop(slot, None)
                free_slot(self.state, self.pool, slot)
                raise
            self._queue.pop(0)
            self.slots[slot] = req

    def _cow_barrier(self, q_lens) -> None:
        """Privatize every page the imminent launch will scatter into while
        the allocator holds it at refcount > 1, and trim the slot's
        pinned-prefix key past the first privatized column.  Skipped
        entirely unless the pool holds a shared page."""
        if not self.pool.has_shared:
            return
        for slot, req in enumerate(self.slots):
            if req is None or not q_lens[slot]:
                continue
            _, copies = cow_pages(self.state, self.pool, slot,
                                  int(q_lens[slot]), cache=self.cache)
            if not copies:
                continue
            self._count("serve.cow_copies", len(copies))
            shared = self._shared.get(slot)
            if shared:
                first = min(col for col, _, _ in copies)
                if first < len(shared):
                    if first:
                        self._shared[slot] = shared[:first]
                    else:
                        del self._shared[slot]

    def _build_groups(self):
        """Group live slots whose pinned shared-prefix tuples are EXACTLY
        equal; returns (group_id [slots], shared_table [slots+1, n_sh],
        shared_lens [slots+1]) device tensors, or None unless some group
        has >= 2 live members.  Group 0 is the null group (shared_lens 0);
        the group axis is padded to slots+1 rows and n_sh to a power of
        two, as in the JAX engine, so both compare on the same shapes."""
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            key = self._shared.get(slot)
            if key:
                groups.setdefault(key, []).append(slot)
        real = sorted((k, v) for k, v in groups.items() if len(v) >= 2)
        if not real:
            return None
        n_sh = max(len(k) for k, _ in real)
        n_sh = 1 << (n_sh - 1).bit_length()
        gid = np.zeros((len(self.slots),), np.int32)
        n_rows = len(self.slots) + 1
        table = np.zeros((n_rows, n_sh), np.int32)
        lens = np.zeros((n_rows,), np.int32)
        for g, (key, members) in enumerate(real, start=1):
            table[g, :len(key)] = key
            lens[g] = len(key) * self.page
            for s in members:
                gid[s] = g
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (gid, table, lens))

    def _sample(self, logits) -> np.ndarray:
        return sample_logits(
            logits, self._rng, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p,
            nan_sentinel=True).cpu().numpy()

    def _retire_finished(self) -> List[Tuple[int, List[int]]]:
        done = []
        retiring: List[int] = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            hit_eos = (self.eos_id is not None and req.tokens
                       and req.tokens[-1] == self.eos_id)
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                retiring.append(slot)
                self.slots[slot] = None
                self._shared.pop(slot, None)
                self._finished[req.rid] = req.tokens
                done.append((req.rid, req.tokens))
        # one batched table edit for the whole wave
        free_slots(self.state, self.pool, retiring)
        return done

    def step(self) -> List[Tuple[int, List[int]]]:
        """One engine tick: retire -> admit -> ONE ragged launch moving
        every active slot (prefill chunks + decode singles together).
        Returns requests that finished THIS tick."""
        done = self._retire_finished()
        self._admit()
        if self.live == 0:
            return done

        prefilling = [s for s, r in enumerate(self.slots)
                      if r is not None and r.n_prefilled < len(r.prompt)]
        qt = self.chunk if prefilling else 1
        slots = len(self.slots)
        toks = np.zeros((slots, qt), np.int32)
        q_lens = np.zeros((slots,), np.int32)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if req.n_prefilled < len(req.prompt):
                seg = req.prompt[req.n_prefilled:req.n_prefilled + qt]
                toks[slot, :len(seg)] = seg
                q_lens[slot] = len(seg)
            else:
                toks[slot, 0] = self._next_tok[slot]
                q_lens[slot] = 1
        self._cow_barrier(q_lens)
        attn = self._attn_for(qt)
        groups = (self._build_groups()
                  if self.group_attn and self._shared and attn == "ragged"
                  else None)
        toks_dev = torch.from_numpy(toks).to(self.device)
        q_lens_dev = torch.from_numpy(q_lens).to(self.device)
        if groups is not None:
            gid, gtable, glens = groups
            logits, _ = ragged_model_step(
                self.params, toks_dev, q_lens_dev, self.state, self.cfg,
                attn="grouped", group_id=gid, shared_table=gtable,
                shared_lens=glens)
        else:
            logits, _ = ragged_model_step(
                self.params, toks_dev, q_lens_dev, self.state, self.cfg,
                attn=attn)
        choice = self._sample(logits)
        kind = ("mixed" if prefilling and len(prefilling) < self.live
                else "prefill" if prefilling else "decode")
        self._count("serve.ragged_batch_launches", kind=kind)
        if groups is not None:
            self._count("serve.grouped_launches")

        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if choice[slot] < 0:  # sample_logits NaN-poison sentinel
                raise RuntimeError(
                    f"slot {slot} (rid {req.rid}) logits are NaN-poisoned: "
                    "a live slot was stepped without assigned pages")
            if req.n_prefilled < len(req.prompt):
                req.n_prefilled += int(q_lens[slot])
                if req.n_prefilled < len(req.prompt):
                    continue
                # the chunk completed the prompt: its last-token logits ARE
                # the first-token distribution
                self._register_prefix(slot, req)
            tok = int(choice[slot])
            req.tokens.append(tok)
            self._next_tok[slot] = tok
        done += self._retire_finished()
        return done
