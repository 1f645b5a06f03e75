"""Continuous-batching serving engine over the paged KV stack (port of
burst_attn_tpu/models/serve.py:ServeEngine).

  * `submit(tokens, max_new_tokens)` queues a request (typed rejections
    from admission.py; `try_submit` is the non-raising surface).
  * `step()` advances the world by one token: admits queued requests into
    free slots whenever the pool can cover their prompt AND their whole
    decode budget (admission = page accounting, so a mid-generation OOM is
    impossible by construction), runs ONE decode step for every live slot,
    retires finished sequences (EOS or budget), and returns the newly
    finished (id, tokens) pairs.
  * `run()` loops `step()` until no work remains; `drain()` requeues
    in-flight work and returns every page to the pool.

Each prefill runs the flash kernel once per layer and each step runs the
paged-decode kernel once per layer (on a CUDA device).  Device tensors
never change shape; admission and retirement only rewrite the page table
and lengths.  Per-slot bookkeeping is host-side Python over ONE [slots]
token fetch per step.

`quantize=True | "int8" | "fp8"` stores the pool at 1 B/elem with
per-token scales (models/paged_decode.py).

`prefix_cache=True` keeps a content-hashed `PrefixCache` of full prompt
pages: admission reuses the cached pages of a prompt's longest cached
prefix and prefills only the suffix (`paged_prefill(cache=)`: kernel 1
on an offset mask over the cached context), and registers the prompt's
full pages.  Cached pages outlive their requests (the cache holds one
reference each); under pool pressure admission evicts the least recently
used ones that no live request shares.

Speculative serving (`draft_params`, `draft_cfg`, `spec_k`): a draft
model with its own paged state, mirroring the target's slot geometry,
proposes spec_k tokens a slot a tick (k single paged steps, kernel 6 on
the card); ONE `paged_multi_step` scores every slot's k+1 positions
(kernel 7 at QT = k+1 on the card); each slot keeps its matching prefix
plus one target token, and both states roll back with one lengths
decrement.  Greedy only; every request's tokens equal the plain engine's.
`acceptance_rate` = spec_accepted / spec_proposed.

`journal=` (serving/checkpoint.TokenJournal): the write-ahead token
journal.  Each emitted token is appended as it lands (the prefill-sampled
first token, every decode step's, a speculative round's kept tokens),
`done` at retirement and `reset` for each request drain() requeues; step()
fsyncs the tick's records once and runs the delivery barrier BEFORE it
returns, so every token a caller has seen is durable.  Snapshots and
recovery: serving/checkpoint.py.

Not ported yet: tensor-parallel meshes, and the obs metrics and request
tracing.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..admission import (
    AdmissionPolicy, InvalidRequest, LoadShed, RejectReason, SubmitRejected,
    SubmitResult,
)
from ..device import resolve_device
from .decode import sample_logits
from .paged_decode import (
    PrefixCache, init_paged_state, paged_decode_step, paged_multi_step,
    paged_prefill, provision_capacity, retire_slot,
)
from .spec_round import Draft, SpecCounters
from .transformer import ModelConfig


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray          # [T] int32
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)  # generated so far


class ServeEngine(SpecCounters):
    """Host-side continuous-batching loop.  Not thread-safe; drive it from
    one thread.  `params` must live on `device` (default: the card)."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int, n_pages: int,
                 page: int = 128, max_pages_per_seq: int = 64,
                 quantize=False, mesh=None, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 rng: Optional[torch.Generator] = None,
                 prefix_cache: bool = False, draft_params=None,
                 draft_cfg: Optional[ModelConfig] = None, spec_k: int = 4,
                 max_queue: Optional[int] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 journal=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet")
        self.device = resolve_device(device)
        # the logits accumulate in fp32: upcast lm_head once here, so no
        # step makes a fresh fp32 copy of it (_logits' cast is then a no-op)
        self.params = dict(params, lm_head=params["lm_head"].float())
        self.cfg = cfg
        self.eos_id = eos_id
        self.page = page
        self.max_queue = max_queue
        self.admission = admission
        self.temperature = temperature
        self.top_k, self.top_p = top_k, top_p
        # the write-ahead TokenJournal (serving/checkpoint.py): token, done
        # and reset records, fsynced once per step() before results return
        self.journal = journal
        if rng is None:
            rng = torch.Generator(device=self.device)
            rng.manual_seed(0)
        self._rng = rng
        self.state, self.pool = init_paged_state(
            cfg, slots=slots, n_pages=n_pages, page=page,
            max_pages_per_seq=max_pages_per_seq, quantize=quantize,
            device=self.device)
        self.cache = PrefixCache(self.pool) if prefix_cache else None
        # speculative serving: a DRAFT model with its own paged state whose
        # slot geometry and pool dtype mirror the target's; greedy only
        self.draft = None if draft_params is None else Draft(
            self.params, params, draft_params, cfg, draft_cfg,
            temperature=temperature, spec_k=spec_k, slots=slots,
            n_pages=n_pages, page=page, max_pages_per_seq=max_pages_per_seq,
            quantize=quantize, device=self.device)
        self.slots: List[Optional[_Request]] = [None] * slots
        self._next_tok = np.zeros((slots,), np.int64)
        self._queue: List[_Request] = []
        self._next_id = 0
        self._finished: Dict[int, List[int]] = {}

    # -- client surface ----------------------------------------------------

    def _occupancy(self) -> float:
        """Fraction of usable pool pages held (page 0 is the sink)."""
        usable = self.pool.n_pages - 1
        return (usable - self.pool.available) / usable if usable else 0.0

    def submit(self, tokens, max_new_tokens: int) -> int:
        """Queue a prompt; returns a request id (tokens appear in step()
        results / results() once finished).

        Raises InvalidRequest (a ValueError) on malformed / permanently
        unservable requests; with `max_queue` or an `admission` policy set,
        raises LoadShed (a RuntimeError) when shed — pool pressure
        (`pool-exhausted`) sheds BEFORE queue pressure (`queue-full`), hard
        exhaustion before the policy's hysteresis sheds."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise InvalidRequest(RejectReason.EMPTY_PROMPT, "empty prompt")
        if max_new_tokens < 1:
            raise InvalidRequest(
                RejectReason.BAD_BUDGET,
                f"max_new_tokens must be >= 1, got {max_new_tokens} "
                "(prefill always samples one)")
        need = self._pages_for(tokens.size, max_new_tokens)
        width = self.state.page_table.shape[1]
        if need > width:
            raise InvalidRequest(
                RejectReason.TABLE_WIDTH,
                f"request needs {need} pages > max_pages_per_seq {width}")
        if need > self.pool.n_pages - 1:  # page 0 is the reserved sink
            # a permanently unservable request would deadlock the FIFO
            raise InvalidRequest(
                RejectReason.POOL_SIZE,
                f"request needs {need} pages but the pool only has "
                f"{self.pool.n_pages - 1} usable pages total")
        if self.max_queue is not None:
            if self._queue and need > self.pool.available:
                raise LoadShed(
                    RejectReason.POOL_EXHAUSTED,
                    f"load shed (pool-exhausted): request needs {need} "
                    f"pages, {self.pool.available} free, "
                    f"{len(self._queue)} already waiting")
            if len(self._queue) >= self.max_queue:
                raise LoadShed(
                    RejectReason.QUEUE_FULL,
                    f"load shed (queue-full): {len(self._queue)} waiting "
                    f">= max_queue {self.max_queue}")
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
        its request BACK at the queue head (generated tokens reset; under
        greedy decoding the prefill re-samples the identical first token).
        Returns the requeued rids in their new queue order.  The engine
        stays usable — run() after drain() serves everything.  The prefix
        cache keeps its pages."""
        inflight = [req for req in self.slots if req is not None]
        for slot, req in enumerate(self.slots):
            if req is not None:
                self._retire_slot(slot)
                self.slots[slot] = None
        inflight.sort(key=lambda r: r.rid)
        for req in reversed(inflight):
            req.tokens = []
            self._queue.insert(0, req)
            if self.journal is not None:
                self.journal.reset(req.rid)
        if self.journal is not None:
            self.journal.sync()
        return [r.rid for r in inflight]

    # -- engine ------------------------------------------------------------

    def _slack(self) -> int:
        return self.draft.slack if self.draft is not None else 0

    def _pages_for(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new + self._slack()) // self.page)

    def _retire_slot(self, slot: int) -> None:
        """retire_slot on the target state and, in draft mode, the
        draft's."""
        retire_slot(self.state, self.pool, slot)
        if self.draft is not None:
            self.draft.retire(slot)

    def _admit(self) -> None:
        """Move queued requests into free slots while the pool can cover
        their FULL lifetime (prompt pages now + decode pages provisioned up
        front — admission is the only allocation point).  FIFO: a request
        that does not fit blocks the ones behind it."""
        for slot, occupant in enumerate(self.slots):
            if occupant is not None or not self._queue:
                continue
            req = self._queue[0]
            need = self._pages_for(len(req.prompt), req.max_new_tokens)
            if need > self.pool.available and self.cache is not None:
                # cached pages no live request shares free up here (LRU);
                # the estimate is cache-blind, so this can evict prefixes
                # the request would have reused: correct, conservative
                self.cache.evict(need - self.pool.available)
            if need > self.pool.available:
                break
            if self.draft is not None and need > self.draft.pool.available:
                # the draft pool duplicates pages the target may share
                # through the prefix cache: check it before the target
                # prefill, not halfway through admission
                break
            try:
                logits, _ = paged_prefill(self.params, req.prompt, self.state,
                                          self.pool, slot, self.cfg,
                                          cache=self.cache)
                provision_capacity(self.state, self.pool, slot,
                                   req.max_new_tokens + self._slack())
                if self.draft is not None:
                    self.draft.prefill(req.prompt, slot, req.max_new_tokens)
            except Exception:
                # paged_prefill releases its own pages on failure; pages an
                # earlier call of this block committed to a table row (the
                # target prefill before a draft-side raise, a prefill before
                # a provision failure) are released here, in both pools
                self._retire_slot(slot)
                raise
            tok = self._sample(logits[None, :])[0]
            if tok < 0:  # sample_logits NaN-poison sentinel
                self._retire_slot(slot)
                raise RuntimeError(f"slot {slot} (rid {req.rid}) prefill "
                                   "logits are NaN-poisoned")
            # dequeue only once prefill + provision + sample succeeded: a
            # failure above leaves the request at the queue head
            self._queue.pop(0)
            req.tokens.append(int(tok))
            if self.journal is not None:
                self.journal.tokens(req.rid, [int(tok)])
            self.slots[slot] = req
            self._next_tok[slot] = int(tok)

    def _sample(self, logits) -> np.ndarray:
        return sample_logits(
            logits, self._rng, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p,
            nan_sentinel=True).cpu().numpy()

    def _retire_finished(self) -> List[Tuple[int, List[int]]]:
        done = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            hit_eos = (self.eos_id is not None and req.tokens
                       and req.tokens[-1] == self.eos_id)
            if hit_eos or len(req.tokens) >= req.max_new_tokens:
                self._retire_slot(slot)
                self.slots[slot] = None
                self._finished[req.rid] = req.tokens
                done.append((req.rid, req.tokens))
                if self.journal is not None:
                    self.journal.done(req.rid)
        return done

    def step(self) -> List[Tuple[int, List[int]]]:
        """One engine tick (see _step).  With a journal attached this is
        also the durability barrier: the tick's journal records are
        fsynced BEFORE its results are returned, then the journal's
        delivery check runs for every stream leaving the engine, so any
        token a caller has seen survives a crash (write-ahead)."""
        done = self._step()
        if self.journal is not None:
            self.journal.sync()
            for rid, toks in done:
                self.journal.delivered(rid, len(toks))
        return done

    def _step(self) -> List[Tuple[int, List[int]]]:
        """One engine tick: retire -> admit -> one decode advance for every
        live slot (a single token, or a whole speculative round in draft
        mode).  Returns requests that finished THIS tick.

        Admit and retire alternate until stable: a freshly admitted request
        can already be complete (max_new_tokens == 1, or the
        prefill-sampled token IS eos) and must retire — freeing its slot —
        WITHOUT a decode step, or it would get a token past its budget."""
        done = self._retire_finished()
        while True:
            before = self.pending
            self._admit()
            done += self._retire_finished()
            if self.pending == before:
                break
        if self.live == 0:
            return done
        if self.draft is not None:
            self._spec_round()
            return done
        logits, _ = paged_decode_step(
            self.params, torch.from_numpy(self._next_tok).to(self.device),
            self.state, self.cfg)
        toks = self._sample(logits)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if toks[slot] < 0:  # sample_logits NaN-poison sentinel
                raise RuntimeError(
                    f"slot {slot} (rid {req.rid}) logits are NaN-poisoned: "
                    "a live slot was stepped without provisioned capacity")
            req.tokens.append(int(toks[slot]))
            if self.journal is not None:
                self.journal.tokens(req.rid, [int(toks[slot])])
            self._next_tok[slot] = int(toks[slot])
        return done

    def _spec_round(self) -> None:
        """One speculative round for EVERY live slot: the draft's spec_k
        proposals and its catch-up (Draft.propose), the target scoring
        all k+1 positions in ONE paged_multi_step, the acceptance on the
        host (Draft.accept, which rolls the draft back), then the target's
        lengths down by what was not kept, one subtraction."""
        first = torch.from_numpy(self._next_tok).to(self.device)
        d_toks, bad = self.draft.propose(first)
        lg_t, _ = paged_multi_step(
            self.params, torch.cat([first[:, None], d_toks], dim=1),
            self.state, self.cfg)
        undo = self.draft.accept(self.slots, d_toks, lg_t, bad, self.eos_id,
                                 self._next_tok, self.journal)
        self.state.lengths.sub_(torch.from_numpy(undo).to(self.device))
