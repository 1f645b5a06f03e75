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

Metrics: the JAX engine's obs instruments under their names (the
serve.* family serving/engine.py also reports through: requests
submitted / rejected / admitted / retired, engine steps, tokens, queue /
slot / pool gauges, TTFT and token-latency histograms, host_gap_fraction,
spec_acceptance_rate); `run()` is the span `serve.run`, and with request
tracing on (`obs.trace.enable()`) each request records serve.queued,
serve.prefill, the serve.first_token marker, serve.decode and its
serve.request root.

`mesh` with cfg.head_axis "tp" (JAX's tensor-parallel ServeEngine): the
engine splits the parameters over the tp positions once
(transformer.shard_params; split ones are taken as they are), gives each
position its kv-head shard of the pool (init_paged_state(mesh=)), and
every prefill and decode step runs each position's kernel launches on
its own shard (models/paged_decode.py): a decode tick launches kernel 6
tp times a layer.  Speculative serving takes no mesh (JAX's ValueError).
"""

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..admission import (
    AdmissionPolicy, InvalidRequest, LoadShed, RejectReason, SubmitRejected,
    SubmitResult,
)
from .. import obs
from ..device import resolve_device
from ..obs import trace as tracing
from .decode import sample_logits
from .paged_decode import (
    PrefixCache, init_paged_state, paged_decode_step, paged_multi_step,
    paged_prefill, provision_capacity, retire_slot,
)
from .spec_round import Draft, SpecCounters
from .transformer import (
    ModelConfig, check_serving, check_tp, fp32_head, shard_params,
)

# the JAX ServeEngine's instruments (serving/engine.py shares the names)
_M_SUBMITTED = obs.counter("serve.requests_submitted")
_M_REJECTED = obs.counter("serve.requests_rejected",
                          "submissions refused up front, by reason")
_M_ADMITTED = obs.counter("serve.requests_admitted")
_M_RETIRED = obs.counter("serve.requests_retired",
                         "finished requests, by cause (eos | budget)")
_M_STEPS = obs.counter("serve.engine_steps")
_M_TOKENS = obs.counter("serve.tokens_generated")
_M_QUEUE = obs.gauge("serve.queue_depth")
_M_LIVE = obs.gauge("serve.live_slots")
_M_POOL = obs.gauge("serve.page_pool_occupancy",
                    "fraction of usable pool pages currently held")
_M_SPEC_RATE = obs.gauge("serve.spec_acceptance_rate")
_M_TTFT = obs.histogram("serve.ttft_s")
_M_TOK_LAT = obs.histogram("serve.token_latency_s")
# host time a tick spent outside its device window (prefill + sample,
# decode step + sample), as a fraction of tick wall time (cumulative)
_M_HOST_GAP = obs.gauge("serve.host_gap_fraction",
                        "host gap seconds / launch-tick wall seconds")


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray          # [T] int32
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)  # generated so far
    t_submit: float = 0.0       # perf_counter at submit (TTFT anchor)


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
        check_serving(cfg)
        if draft_params is not None and draft_cfg is not None \
                and mesh is not None:
            raise ValueError("speculative serving requires no tp mesh "
                             "and temperature == 0")
        self.device = resolve_device(device)
        self.mesh = mesh
        if check_tp(cfg, mesh, strict=True) > 1:
            params = shard_params(params, cfg, mesh)
        # the logits accumulate in fp32: upcast lm_head once here, so no
        # step makes a fresh fp32 copy of it (_logits' cast is then a no-op)
        self.params = fp32_head(params)
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
            mesh=mesh, device=self.device)
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
        self._host_gap_s = self._launch_wall_s = self._tick_dev_s = 0.0

    # -- client surface ----------------------------------------------------

    def _reject(self, exc_cls, reason: RejectReason, message: str):
        _M_REJECTED.inc(reason=reason.value)
        raise exc_cls(reason, message)

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
            self._reject(InvalidRequest, RejectReason.EMPTY_PROMPT,
                         "empty prompt")
        if max_new_tokens < 1:
            self._reject(
                InvalidRequest, RejectReason.BAD_BUDGET,
                f"max_new_tokens must be >= 1, got {max_new_tokens} "
                "(prefill always samples one)")
        need = self._pages_for(tokens.size, max_new_tokens)
        width = self.state.page_table.shape[1]
        if need > width:
            self._reject(
                InvalidRequest, RejectReason.TABLE_WIDTH,
                f"request needs {need} pages > max_pages_per_seq {width}")
        if need > self.pool.n_pages - 1:  # page 0 is the reserved sink
            # a permanently unservable request would deadlock the FIFO
            self._reject(
                InvalidRequest, RejectReason.POOL_SIZE,
                f"request needs {need} pages but the pool only has "
                f"{self.pool.n_pages - 1} usable pages total")
        if self.max_queue is not None:
            if self._queue and need > self.pool.available:
                self._reject(
                    LoadShed, RejectReason.POOL_EXHAUSTED,
                    f"load shed (pool-exhausted): request needs {need} "
                    f"pages, {self.pool.available} free, "
                    f"{len(self._queue)} already waiting")
            if len(self._queue) >= self.max_queue:
                self._reject(
                    LoadShed, RejectReason.QUEUE_FULL,
                    f"load shed (queue-full): {len(self._queue)} waiting "
                    f">= max_queue {self.max_queue}")
        if self.admission is not None:
            occ = self._occupancy()
            reason = self.admission.decide(queue_depth=len(self._queue),
                                           pool_occupancy=occ)
            if reason is not None:
                self._reject(LoadShed, reason,
                             f"load shed ({reason}): admission policy — "
                             f"queue_depth={len(self._queue)}, "
                             f"pool_occupancy={occ:.3f}")
        rid = self._next_id
        self._next_id += 1
        req = _Request(rid, tokens, max_new_tokens,
                       t_submit=time.perf_counter())
        # an attribute, not a field: snapshots never see the trace context
        req._tc = tracing.start_request(rid)
        self._queue.append(req)
        _M_SUBMITTED.inc()
        _M_QUEUE.set(len(self._queue))
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
        with obs.span("serve.run"):
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
        _M_QUEUE.set(len(self._queue))
        _M_LIVE.set(0)
        _M_POOL.set(self._occupancy())
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
            t_adm = time.perf_counter()  # queued ends / prefill starts here
            try:
                logits, _ = paged_prefill(self.params, req.prompt, self.state,
                                          self.pool, slot, self.cfg,
                                          mesh=self.mesh, cache=self.cache)
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
            now = time.perf_counter()
            # the prefill and its sample wait on the device: the tick's
            # device window
            self._tick_dev_s += now - t_adm
            _M_ADMITTED.inc()
            _M_TOKENS.inc()  # the prefill-sampled first token
            _M_TTFT.observe(now - req.t_submit)
            _M_QUEUE.set(len(self._queue))
            tc = getattr(req, "_tc", None)
            if tc is not None:
                # contiguous phases on one clock: the breakdown sums to TTFT
                req._t_first = now
                tracing.record_span(tc, "serve.queued", req.t_submit, t_adm)
                tracing.record_span(tc, "serve.prefill", t_adm, now)
                tracing.marker(tc, "serve.first_token", now)
                tracing.note_ttft(tc, now - req.t_submit)
                tracing.publish_breakdown({"queued": t_adm - req.t_submit,
                                           "prefill": now - t_adm})

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
                _M_RETIRED.inc(cause="eos" if hit_eos else "budget")
                tc = getattr(req, "_tc", None)
                if tc is not None:
                    now = time.perf_counter()
                    tracing.record_span(
                        tc, "serve.decode",
                        getattr(req, "_t_first", req.t_submit), now,
                        tokens=len(req.tokens))
                    tracing.record_span(tc, "serve.request", req.t_submit,
                                        now, root=True, rid=req.rid)
        return done

    def _note_tick(self, dt: float, added: int,
                   dev_s: Optional[float] = None) -> None:
        """Per-tick obs update: queue / slot / pool gauges, the tick and
        its tokens, and the amortized per-token latency (live streams
        advance together: each stream's tokens arrived dt / (added / live)
        apart).  `dev_s` is the tick's device window; the rest of dt feeds
        serve.host_gap_fraction."""
        if dev_s is not None:
            self._host_gap_s += max(0.0, dt - dev_s)
            self._launch_wall_s += dt
            if self._launch_wall_s > 0:
                _M_HOST_GAP.set(self._host_gap_s / self._launch_wall_s)
        _M_STEPS.inc()
        _M_QUEUE.set(len(self._queue))
        live = self.live
        _M_LIVE.set(live)
        _M_POOL.set(self._occupancy())
        if added:
            _M_TOKENS.inc(added)
            _M_TOK_LAT.observe(dt * live / added)
        rate = self.acceptance_rate
        if rate is not None:
            _M_SPEC_RATE.set(rate)

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
        t0 = time.perf_counter()
        self._tick_dev_s = 0.0  # _admit credits its prefill windows here
        done = self._retire_finished()
        while True:
            before = self.pending
            self._admit()
            done += self._retire_finished()
            if self.pending == before:
                break
        if self.live == 0:
            self._note_tick(time.perf_counter() - t0, 0,
                            self._tick_dev_s or None)
            return done
        td0 = time.perf_counter()
        if self.draft is not None:
            added = self._spec_round()
            # the round's launches are back to back: its device window
            self._tick_dev_s += time.perf_counter() - td0
            self._note_tick(time.perf_counter() - t0, added,
                            self._tick_dev_s)
            return done
        logits, _ = paged_decode_step(
            self.params, torch.from_numpy(self._next_tok).to(self.device),
            self.state, self.cfg, mesh=self.mesh)
        toks = self._sample(logits)  # waits on the device: the window ends
        self._tick_dev_s += time.perf_counter() - td0
        added = 0
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
            added += 1
        self._note_tick(time.perf_counter() - t0, added, self._tick_dev_s)
        return done

    def _spec_round(self) -> int:
        """One speculative round for EVERY live slot: the draft's spec_k
        proposals and its catch-up (Draft.propose), the target scoring
        all k+1 positions in ONE paged_multi_step, the acceptance on the
        host (Draft.accept, which rolls the draft back), then the target's
        lengths down by what was not kept, one subtraction.  Returns the
        tokens kept."""
        first = torch.from_numpy(self._next_tok).to(self.device)
        d_toks, bad = self.draft.propose(first)
        lg_t, _ = paged_multi_step(
            self.params, torch.cat([first[:, None], d_toks], dim=1),
            self.state, self.cfg)
        n_before = sum(len(r.tokens) for r in self.slots if r is not None)
        undo = self.draft.accept(self.slots, d_toks, lg_t, bad, self.eos_id,
                                 self._next_tok, self.journal)
        self.state.lengths.sub_(torch.from_numpy(undo).to(self.device))
        return sum(len(r.tokens) for r in self.slots
                   if r is not None) - n_before
