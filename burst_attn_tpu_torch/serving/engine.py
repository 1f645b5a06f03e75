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
  * Speculative decoding (`draft_params`, `draft_cfg`, `spec_k`) is a
    scheduler policy: when a draft model is attached and no slot is
    mid-prefill, the tick is a speculative round (k draft proposals a slot
    through single paged steps on the draft's own state, ONE all-logits
    verify at QT = k+1, per-slot prefix acceptance, one lengths rollback a
    state).  Ticks with a slot mid-prefill chunk as usual and keep the
    draft in step with one catch-up launch for the decoding slots.  The
    draft prefills its whole prompt at admission.  Greedy only; streams
    are token-exact with the plain engine.  `pipeline=True` with a draft
    serves through these synchronous rounds.
  * Pipelined (`pipeline=True`): each tick dispatches the NEXT launch
    before it reads the previous one back, so the host's scheduling of
    tick N+1 overlaps the device's work on tick N; delivery lags one tick.
    When no admission or retirement can land at the unread launch's
    readback, the next launch is dispatched speculatively on its still
    on-device choices; an EOS the readback finds retires a stream the
    speculation assumed live, and the speculative launch is discarded
    (lengths and generator rolled back).  `multi_step=K` fuses up to K
    pure-decode ticks into one launch: on the card one replay of a CUDA
    graph of K ticks (`model.DecodeGraphs`), cut at its first EOS by the
    readback.  Streams are token-exact with the synchronous engine, greedy
    and sampled: every launch is the synchronous tick's computation, and
    a rollback restores the generator to where the synchronous engine's
    draws leave it.  The dispatch waits on nothing the device runs: host
    values go up through pinned memory, the choices come down into pinned
    memory behind an event, and lengths and table rows are read from host
    mirrors.

Kernel routing: `ragged_supported` probes each launch width once, on shape
alone; a declined shape takes the dense route and counts one
`burst.fused_fallback{reason=...,pass=serve}`.  A build or launch failure
raises.

Metrics: the JAX engine's obs instruments under their names and labels
(the serve.* catalog of docs/observability.md: requests submitted /
rejected / admitted / retired, engine steps, tokens, queue / slot / pool
gauges, TTFT and token-latency histograms, host_gap_fraction, the ragged
batch, prefix-cache and pipeline families, burst.fused_fallback), plus
two of the port's own: `serve.grouped_launches` (ticks that took the
grouped launch) and `serve.draft_catchup_launches` (the draft's catch-up
launches of mixed ticks).  `run()` is the span `serve.run`; with request
tracing on (`obs.trace.enable()`), each request records serve.queued,
serve.prefill, the serve.first_token marker, serve.decode and its
serve.request root, and its TTFT breakdown.  Counters advance on the host
where a tick is accounted: the synchronous readback, or the pipelined
engine's deferred readback, which counts each tick a fused launch kept
(`serve.engine_steps` and `serve.tokens_generated` of a K-tick run equal
the synchronous run's); nothing is counted inside a captured CUDA graph.
`stats` is a read-only view of the registry's counters since the engine
was built ("name{k=v,...}" -> delta, labels sorted).  `spec_rounds`,
`spec_proposed`, `spec_accepted` and `acceptance_rate` count the
speculative rounds.  `graphs.captures` and `graphs.replays` count the
K-tick CUDA graphs.

Journal (`journal=`, a serving/checkpoint.TokenJournal): every token is
appended where the host accounts it (the synchronous readback, the
pipelined engine's deferred readback, a speculative round's kept tokens),
`done` at retirement, `reset` for each request drain() requeues.  Each
step() fsyncs its records once and then runs the delivery barrier for
the streams it returns (`_journal_barrier`), so a token is durable before
any caller sees it; on the pipelined path delivery lags one tick and
durability does not.  Snapshots (`save_snapshot` flushes the pipeline
first) and recovery: serving/checkpoint.py.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..obs import trace as tracing
from ..admission import (
    AdmissionPolicy, InvalidRequest, LoadShed, RejectReason, SubmitRejected,
    SubmitResult,
)
from ..device import resolve_device
from ..models.decode import skip_draws
from ..models.paged_decode import PrefixCache, init_paged_state
from ..models.spec_round import Draft, SpecCounters
from ..models.transformer import ModelConfig, check_serving
from ..ops.ragged_paged import ragged_supported
from .model import (
    DecodeGraphs, assign_pages, cow_pages, free_slot, free_slots,
    multi_step_decode, pipelined_tick, ragged_model_step, upload,
)

# the JAX engine's instruments (same names as models/serve.py: the registry
# get-or-creates, so both engines share one serve.* family)
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
                    "fraction of usable pool pages currently held; also "
                    "published per pool storage dtype under a {dtype} label")
_M_SPEC_RATE = obs.gauge("serve.spec_acceptance_rate")
_M_TTFT = obs.histogram("serve.ttft_s")
_M_TOK_LAT = obs.histogram("serve.token_latency_s")
# host time a tick spent outside its device window (dispatch to readback),
# as a fraction of tick wall time (cumulative); on the pipelined engine
# host work overlapped with a busy device is not a gap
_M_HOST_GAP = obs.gauge("serve.host_gap_fraction",
                        "host gap seconds / launch-tick wall seconds")
_M_RECONCILE = obs.counter(
    "serve.pipeline_reconciles",
    "speculatively scheduled pipelined work discarded, by divergence cause")
_M_MULTI = obs.counter(
    "serve.multi_step_launches",
    "fused multi-step decode launches, by static scan depth {k}")
_M_RB_LAUNCH = obs.counter("serve.ragged_batch_launches",
                           "one-kernel ragged launches, by batch kind")
_M_RB_PREFILL = obs.counter("serve.ragged_batch_prefill_tokens",
                            "prompt tokens absorbed through ragged launches")
_M_RB_DECODE = obs.counter("serve.ragged_batch_decode_tokens",
                           "decode tokens advanced through ragged launches")
_M_RB_FILL = obs.gauge("serve.ragged_batch_fill",
                       "real-token fraction of the last launch's [slots, "
                       "chunk] token grid")
_M_FALLBACK = obs.counter("burst.fused_fallback")
_M_PREFIX_HITS = obs.counter("serve.prefix_hits",
                             "admissions that pinned >= 1 cached prefix page")
_M_PREFIX_MISSES = obs.counter(
    "serve.prefix_misses", "cache-enabled admissions finding no cached prefix")
_M_PAGES_SHARED = obs.counter(
    "serve.pages_shared", "prefix pages pinned (refcount bumped) at admission")
_M_COW = obs.counter("serve.cow_copies",
                     "shared pages privatized by the copy-on-write barrier")
_M_SKIPPED = obs.counter(
    "serve.prefill_tokens_skipped",
    "prompt tokens whose prefill was skipped via cached pages")
_M_POOL_PHYS = obs.gauge(
    "serve.page_pool_occupancy_physical",
    "fraction of usable pool pages physically held (shared pages count "
    "ONCE — identical to serve.page_pool_occupancy)")
_M_POOL_LOG = obs.gauge(
    "serve.page_pool_occupancy_logical",
    "sum of page refcounts over usable pages — may exceed 1.0; the gap to "
    "the physical gauge is the pages saved by prefix sharing")
_M_POOL_BYTES = obs.gauge(
    "serve.page_pool_bytes",
    "device bytes physically held by in-use KV pages (k + v + scale banks "
    "across all layers), by pool storage {dtype}")
# the port's own: ticks that took the grouped launch, and the draft's
# catch-up launches of mixed ticks
_M_GROUPED = obs.counter("serve.grouped_launches",
                         "ticks that took the grouped shared-prefix launch")
_M_CATCHUP = obs.counter("serve.draft_catchup_launches",
                         "draft catch-up launches of mixed ticks")


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
    t_submit: float = 0.0       # perf_counter at submit (TTFT anchor)


@dataclass
class _Pending:
    """A launch whose sampled choices are still on the device: what the
    deferred readback needs to replay the synchronous engine's post-sample
    accounting one tick late."""
    choices: torch.Tensor        # [k, slots] int64, on the device
    host: Optional[torch.Tensor]  # pinned [k, slots], filled behind `event`
    event: Optional[torch.cuda.Event]
    k: int                       # fused decode depth (1 = one tick)
    q_lens: np.ndarray           # [slots] tokens a tick
    advance: np.ndarray          # [slots] length advance (q_lens * k)
    prefill_advance: np.ndarray  # [slots] prompt tokens consumed (k == 1)
    tok_delta: np.ndarray        # [slots] tokens the readback appends if no
    #                              EOS fires inside the launch
    rng_before: Optional[torch.Tensor]  # generator state before the launch
    table_rows: Dict[int, np.ndarray]   # slot -> table row at dispatch, for
    #                              prefix registration at readback
    t_dispatch: float = 0.0      # perf_counter when the launch was issued

    @property
    def feed_next(self) -> torch.Tensor:
        """The last tick's choices: the next launch's tokens."""
        return self.choices[-1]


def _readback_choices(p: _Pending) -> np.ndarray:
    """THE pipeline sync point: wait for an in-flight launch's sampled
    choices and return them [k, slots] on the host."""
    if p.event is None:
        return p.choices.numpy()
    p.event.synchronize()
    return p.host.numpy()


class RaggedServeEngine(SpecCounters):
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
        check_serving(cfg)
        if multi_step < 1:
            raise ValueError(f"multi_step must be >= 1, got {multi_step}")
        if multi_step > 1 and not pipeline:
            raise ValueError("multi_step > 1 requires pipeline=True")
        self.pipeline = bool(pipeline)
        self.multi_step = int(multi_step)
        self._pending: Optional[_Pending] = None
        self._flushed_done: List[Tuple[int, List[int]]] = []
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
        # None: probe per launch width; True/False force a route
        self.use_ragged = use_ragged
        self._attn_cache: Dict[int, str] = {}
        self.cache = PrefixCache(self.pool) if prefix_cache else None
        self.group_attn = group_attn
        # slot -> the shared page ids pinned at admission: the grouping key
        # of attn="grouped"; trimmed when the CoW barrier privatizes a
        # boundary page, dropped at retire/drain
        self._shared: Dict[int, Tuple[int, ...]] = {}
        # speculative decoding: a draft model with its own paged state (slot
        # geometry and pool dtype as the target's; no host mirror: its
        # lengths are read only at admission)
        self.draft = None if draft_params is None else Draft(
            self.params, params, draft_params, cfg, draft_cfg,
            temperature=temperature, spec_k=spec_k, slots=slots,
            n_pages=n_pages, page=page, max_pages_per_seq=max_pages_per_seq,
            quantize=quantize, device=self.device)
        self.slots: List[Optional[_Request]] = [None] * slots
        self._next_tok = np.zeros((slots,), np.int32)
        # host mirrors of the device lengths (as every dispatched launch
        # leaves them) and page table: the dispatch path reads these, never
        # the device
        self._lengths = np.zeros((slots,), np.int64)
        self._table = np.zeros((slots, max_pages_per_seq), np.int32)
        self._queue: List[_Request] = []
        self._next_id = 0
        self._finished: Dict[int, List[int]] = {}
        self._obs_base = obs.counter_values()
        self._host_gap_s = self._launch_wall_s = 0.0
        self._pool_dtype = self.pool.dtype or str(
            self.state.k_pages[0].dtype).replace("torch.", "")
        banks = list(self.state.k_pages) + list(self.state.v_pages)
        if self.state.k_scales is not None:
            banks += list(self.state.k_scales) + list(self.state.v_scales)
        self._page_nbytes = sum(a.nbytes // a.shape[0] for a in banks)
        # the K-tick decode graphs (the card only; the CPU runs K ticks; a
        # draft engine never takes the pipelined path)
        self.graphs = (DecodeGraphs(self.params, self.state, cfg, self._rng)
                       if self.device.type == "cuda" and self.multi_step > 1
                       and self.draft is None else None)

    # -- client surface ----------------------------------------------------

    @property
    def stats(self) -> Dict[str, float]:
        """The registry's counters that moved since this engine was built,
        {"name{k=v,...}": delta} (a view: the registry is the one store,
        shared by every engine of the process)."""
        return obs.counter_deltas(self._obs_base)

    def _reject(self, exc_cls, reason: RejectReason, message: str):
        _M_REJECTED.inc(reason=reason.value)
        raise exc_cls(reason, message)

    def _occupancy(self) -> float:
        """Fraction of usable pool pages physically held (a shared page
        counts once; page 0 is the sink)."""
        usable = self.pool.n_pages - 1
        return (usable - self.pool.available) / usable if usable else 0.0

    def _set_pool_gauges(self) -> None:
        """Physical occupancy (a shared page once) on the plain gauge, by
        pool dtype and as `_physical`; the logical view (sum of refcounts);
        the bytes the held pages take."""
        occ = self._occupancy()
        _M_POOL.set(occ)
        _M_POOL.set(occ, dtype=self._pool_dtype)
        _M_POOL_PHYS.set(occ)
        usable = self.pool.n_pages - 1
        _M_POOL_LOG.set(self.pool.logical_refs / usable if usable else 0.0)
        held = usable - self.pool.available if usable else 0
        _M_POOL_BYTES.set(held * self._page_nbytes, dtype=self._pool_dtype)

    def submit(self, tokens, max_new_tokens: int) -> int:
        """Queue a prompt; returns a request id.  Raises InvalidRequest (a
        ValueError) on malformed / permanently unservable requests,
        LoadShed (a RuntimeError) when shed — both carry a typed
        `.reason`.  Pool pressure sheds BEFORE queue pressure, hard
        exhaustion before the soft `admission` policy."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            self._reject(InvalidRequest, RejectReason.EMPTY_PROMPT,
                         "empty prompt")
        if max_new_tokens < 1:
            self._reject(InvalidRequest, RejectReason.BAD_BUDGET,
                         f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
        need = self._pages_for(tokens.size, max_new_tokens)
        width = self.state.page_table.shape[1]
        if need > width:
            self._reject(InvalidRequest, RejectReason.TABLE_WIDTH,
                         f"request needs {need} pages > "
                         f"max_pages_per_seq {width}")
        if need > self.pool.n_pages - 1:  # page 0 is the reserved sink
            self._reject(InvalidRequest, RejectReason.POOL_SIZE,
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
                self._reject(LoadShed, RejectReason.POOL_EXHAUSTED,
                             f"load shed (pool-exhausted): request needs "
                             f"{need} pages, {avail} free or evictable, "
                             f"{len(self._queue)} already waiting")
            if len(self._queue) >= self.max_queue:
                self._reject(LoadShed, RejectReason.QUEUE_FULL,
                             f"load shed (queue-full): {len(self._queue)} "
                             f"waiting >= max_queue {self.max_queue}")
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
        its request BACK at the queue head (reset to un-prefilled; greedy
        decode regenerates the identical tokens on re-admission).  Returns
        the requeued rids in their new queue order.  The engine stays
        usable — run() after drain() serves everything.  A pipelined engine
        first flushes its in-flight launch (its finishers retire and come
        back from the next step())."""
        self.flush_pipeline()
        inflight = [req for req in self.slots if req is not None]
        live_slots = [s for s, req in enumerate(self.slots) if req is not None]
        self._free(live_slots)
        self.slots = [None] * len(self.slots)
        self._shared.clear()
        inflight.sort(key=lambda r: r.rid)
        for req in reversed(inflight):
            req.tokens = []
            req.n_prefilled = 0
            self._queue.insert(0, req)
            if self.journal is not None:
                self.journal.reset(req.rid)
        if self.journal is not None:
            self.journal.sync()
        _M_QUEUE.set(len(self._queue))
        _M_LIVE.set(0)
        self._set_pool_gauges()
        return [r.rid for r in inflight]

    # -- engine ------------------------------------------------------------

    def _slack(self) -> int:
        return self.draft.slack if self.draft is not None else 0

    def _pages_for(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new + self._slack()) // self.page)

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
                _M_FALLBACK.inc(reason=_fallback_label(reason),
                                **{"pass": "serve"})
            self._attn_cache[qt] = "dense" if reason is not None else "ragged"
        return self._attn_cache[qt]

    def _hashes(self, req: _Request) -> List[bytes]:
        if req.hashes is None:
            req.hashes = PrefixCache.chain(req.prompt, self.page,
                                           dtype=self.pool.dtype)
        return req.hashes

    def _register_prefix(self, slot: int, req: _Request,
                         row: np.ndarray) -> None:
        """Register a just-prefilled prompt's full pages.  `row` is the
        slot's table row as the prompt-completing launch saw it, after its
        CoW barrier (captured at dispatch: a later launch's CoW cannot shift
        the registered ids)."""
        if self.cache is None:
            return
        hashes = self._hashes(req)
        if hashes:
            self.cache.insert(hashes, [int(x) for x in row[:len(hashes)]])

    def _free(self, slots: List[int]) -> None:
        """free_slots and the host mirrors with it; in draft mode the
        draft's slots retire too."""
        free_slots(self.state, self.pool, slots)
        self._table[slots] = 0
        self._lengths[slots] = 0
        if self.draft is not None:
            for slot in slots:
                self.draft.retire(slot)

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
            if need > self.pool.available or (
                    self.draft is not None
                    and need + len(hits) > self.draft.pool.available):
                # the draft pool holds the whole prompt privately: check it
                # before any page moves
                if hits:
                    self.pool.release(hits)
                break
            ids = self.pool.acquire(need)
            try:
                assign_pages(self.state, slot, hits + ids)
                self._table[slot, :len(hits) + len(ids)] = hits + ids
                if hits:
                    t_pre = len(hits) * self.page
                    t_resume = (t_pre if t_pre < len(req.prompt)
                                else len(req.prompt) - 1)
                    self.state.lengths[slot] = t_resume
                    self._lengths[slot] = t_resume
                    req.n_prefilled = t_resume
                    self._shared[slot] = tuple(hits)
                    _M_PREFIX_HITS.inc()
                    _M_PAGES_SHARED.inc(len(hits))
                    _M_SKIPPED.inc(t_resume)
                elif self.cache is not None:
                    _M_PREFIX_MISSES.inc()
                if self.draft is not None:
                    # the draft prefills its WHOLE prompt now; per-tick
                    # catch-ups then keep it on the target's stream
                    self.draft.prefill(req.prompt, slot, req.max_new_tokens)
            except Exception:
                # free_slot releases hits and ids together (the lookup's
                # pin and the acquire both belong to the row); the draft's
                # prefill pages, if it got that far, go back too
                req.n_prefilled = 0
                self._shared.pop(slot, None)
                free_slot(self.state, self.pool, slot)
                self._table[slot] = 0
                self._lengths[slot] = 0
                if self.draft is not None:
                    self.draft.retire(slot)
                raise
            self._queue.pop(0)
            self.slots[slot] = req
            _M_ADMITTED.inc()
            _M_QUEUE.set(len(self._queue))
            tc = getattr(req, "_tc", None)
            if tc is not None:
                req._t_admit = time.perf_counter()
                tracing.record_span(tc, "serve.queued", req.t_submit,
                                    req._t_admit)

    def _cow_barrier(self, q_lens) -> None:
        """Privatize every page the imminent launch will scatter into while
        the allocator holds it at refcount > 1, and trim the slot's
        pinned-prefix key past the first privatized column.  Skipped
        entirely unless the pool holds a shared page.  Reads lengths and
        rows from the host mirrors."""
        if not self.pool.has_shared:
            return
        for slot, req in enumerate(self.slots):
            if req is None or not q_lens[slot]:
                continue
            _, copies = cow_pages(self.state, self.pool, slot,
                                  int(q_lens[slot]), cache=self.cache,
                                  length=int(self._lengths[slot]),
                                  row=self._table[slot])
            if not copies:
                continue
            for col, _, new in copies:
                self._table[slot, col] = new
            _M_COW.inc(len(copies))
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
        return tuple(upload(a, torch.int32, self.device)
                     for a in (gid, table, lens))

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
        # one batched table edit for the whole wave
        self._free(retiring)
        if done:
            _M_LIVE.set(self.live)
            self._set_pool_gauges()
        return done

    def _note_tick(self, dt: float, added: int,
                   dev_s: Optional[float] = None) -> None:
        """Per-step gauges and, when tokens were produced, the amortized
        per-token latency (live streams advance together: each stream's
        tokens arrived dt / (added / live) apart).  `dev_s` is the step's
        device window; the rest of dt feeds serve.host_gap_fraction.  The
        tick counters (serve.engine_steps, serve.tokens_generated) advance
        where the ticks are accounted (_account)."""
        if dev_s is not None:
            self._host_gap_s += max(0.0, dt - dev_s)
            self._launch_wall_s += dt
            if self._launch_wall_s > 0:
                _M_HOST_GAP.set(self._host_gap_s / self._launch_wall_s)
        _M_QUEUE.set(len(self._queue))
        live = self.live
        _M_LIVE.set(live)
        self._set_pool_gauges()
        if added:
            _M_TOK_LAT.observe(dt * live / added)
        rate = self.acceptance_rate
        if rate is not None:
            _M_SPEC_RATE.set(rate)

    @staticmethod
    def _account(ticks: int, added: int) -> None:
        """Count `ticks` model ticks that produced `added` tokens: where the
        host accounts them (a readback or a speculative round), never
        inside a captured graph."""
        _M_STEPS.inc(ticks)
        if added:
            _M_TOKENS.inc(added)

    def _journal_barrier(self, done: List[Tuple[int, List[int]]]) -> None:
        """Durability, then delivery: fsync the tick's journal records,
        then run the journal machine's deliver transition for every stream
        leaving the engine (it raises DurabilityViolation if a returned
        token is not durable yet)."""
        if self.journal is None:
            return
        self.journal.sync()
        for rid, toks in done:
            self.journal.delivered(rid, len(toks))

    def step(self) -> List[Tuple[int, List[int]]]:
        """One engine tick (see _step; _pipelined_step when pipeline=True
        and no draft is attached).  With a journal attached this is also
        the durability barrier: the tick's records are fsynced BEFORE its
        results are returned.  On the pipelined path the fsync still comes
        before delivery, so delivery lags one step behind generation."""
        if self.pipeline and self.draft is None:
            return self._pipelined_step()
        done = self._step()
        self._journal_barrier(done)
        return done

    def _step(self) -> List[Tuple[int, List[int]]]:
        """One synchronous tick: retire -> admit -> ONE ragged launch
        moving every active slot (prefill chunks + decode singles
        together) -> its readback (or a speculative round, or a mixed tick
        with the draft's catch-up).  Returns requests that finished THIS
        tick."""
        t0 = time.perf_counter()
        done = self._retire_finished()
        self._admit()
        if self.live == 0:
            self._account(1, 0)
            self._note_tick(time.perf_counter() - t0, 0)
            return done
        td0 = time.perf_counter()
        if self.draft is None:
            added = self._readback(self._launch_deferred())[0]
        elif all(r is None or r.n_prefilled == len(r.prompt)
                 for r in self.slots):
            added = self._spec_round()
        else:
            added = self._mixed_draft_tick()
        # the launch and its readback (which waits on the device) are the
        # tick's device window
        t1 = time.perf_counter()
        self._note_tick(t1 - t0, added, t1 - td0)
        done += self._retire_finished()
        return done

    # -- pipelined engine --------------------------------------------------
    #
    # Under pipeline=True one launch stays in flight: each tick dispatches
    # the NEXT launch (speculatively, when no admission or retirement can
    # land at the unread launch's readback) BEFORE it waits for the
    # previous one, whose readback replays the synchronous engine's
    # accounting one tick late.  The synchronous tick is the same dispatch
    # followed at once by its readback.

    def _spec_plan(self) -> Optional[int]:
        """Fused decode depth k for a speculative launch on top of the
        unread pending launch, or None when the synchronous engine could
        admit or retire at the pending readback (EOS is the one event this
        cannot predict: the reconcile in _pipelined_step handles it)."""
        p = self._pending
        if self._queue and any(r is None for r in self.slots):
            return None                  # admission would land next tick
        any_live = False
        k = self.multi_step
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            any_live = True
            if req.n_prefilled + int(p.prefill_advance[slot]) \
                    < len(req.prompt):
                return None              # still mid-prefill after pending
            remaining = req.max_new_tokens \
                - (len(req.tokens) + int(p.tok_delta[slot]))
            if remaining < 1:
                return None              # budget retire at pending readback
            k = min(k, remaining)
        if not any_live:
            return None
        if self._shared and self.group_attn:
            # shared-prefix ticks follow the synchronous engine's per-tick
            # grouped-launch decision; never fuse across them
            k = 1
        return k

    def _dispatch_deferred(self, *, feed, q_lens, qt, k, prefill_advance,
                           tok_delta, kind) -> _Pending:
        """Shared dispatch of both launch flavours: CoW-protect the window,
        route the kernel, launch, and start the choices' copy to pinned
        host memory, WITHOUT waiting for any of it.  `feed` is the
        [slots, qt] token grid for k == 1 or the [slots] next-token feed
        of a fused k-tick launch (host numpy or a device tensor still in
        flight)."""
        self._cow_barrier(q_lens * k)
        # the post-CoW table row of each slot this launch completes the
        # prompt of: prefix registration at readback must see the table as
        # the synchronous engine would, before a later launch's CoW
        table_rows: Dict[int, np.ndarray] = {}
        if self.cache is not None:
            for slot, req in enumerate(self.slots):
                if req is not None and prefill_advance[slot] and \
                        req.n_prefilled + int(prefill_advance[slot]) \
                        == len(req.prompt):
                    table_rows[slot] = self._table[slot].copy()
        attn = self._attn_for(qt)
        sampled = self.temperature > 0
        rng_before = self._rng.get_state() if sampled else None
        if not torch.is_tensor(feed):
            feed = upload(feed, torch.long, self.device)
        q_lens_dev = upload(q_lens, torch.int32, self.device)
        sampling = dict(temperature=self.temperature, top_k=self.top_k,
                        top_p=self.top_p)
        t_dispatch = time.perf_counter()
        if k > 1:
            choices, _, _ = multi_step_decode(
                self.params, feed, q_lens_dev, self.state, self._rng,
                self.cfg, k=k, attn=attn, graphs=self.graphs, **sampling)
            _M_MULTI.inc(k=str(k))
        else:
            groups = (self._build_groups()
                      if self.group_attn and self._shared
                      and attn == "ragged" else None)
            grouped = {}
            if groups is not None:
                attn = "grouped"
                grouped = dict(zip(("group_id", "shared_table",
                                    "shared_lens"), groups))
                _M_GROUPED.inc()
            choice, _ = pipelined_tick(
                self.params, feed, q_lens_dev, self.state, self._rng,
                self.cfg, attn=attn, **sampling, **grouped)
            choices = choice[None]
        _M_RB_LAUNCH.inc(kind=kind)
        n_prefill = int(prefill_advance.sum())
        if n_prefill:
            _M_RB_PREFILL.inc(n_prefill)
        _M_RB_FILL.set(float(q_lens.sum()) / (len(self.slots) * qt))
        advance = (q_lens * k).astype(np.int64)
        self._lengths += advance
        host = event = None
        if choices.is_cuda:
            host = torch.empty(choices.shape, dtype=choices.dtype,
                               pin_memory=True)
            host.copy_(choices, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return _Pending(
            choices=choices, host=host, event=event, k=k, q_lens=q_lens,
            advance=advance, prefill_advance=prefill_advance,
            tok_delta=tok_delta, rng_before=rng_before,
            table_rows=table_rows, t_dispatch=t_dispatch)

    def _launch_deferred(self) -> _Pending:
        """The synchronous tick's batch build — prefill chunks + decode
        singles from the fully accounted host state — as one launch, fused
        to multi_step depth when every live slot is pure-decode and no
        admission or retirement can land inside the window."""
        prefilling = [s for s, r in enumerate(self.slots)
                      if r is not None and r.n_prefilled < len(r.prompt)]
        qt = self.chunk if prefilling else 1
        slots = len(self.slots)
        toks = np.zeros((slots, qt), np.int32)
        q_lens = np.zeros((slots,), np.int32)
        prefill_advance = np.zeros((slots,), np.int32)
        tok_delta = np.zeros((slots,), np.int32)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if req.n_prefilled < len(req.prompt):
                seg = req.prompt[req.n_prefilled:req.n_prefilled + qt]
                toks[slot, :len(seg)] = seg
                q_lens[slot] = len(seg)
                prefill_advance[slot] = len(seg)
                if req.n_prefilled + len(seg) == len(req.prompt):
                    tok_delta[slot] = 1
            else:
                toks[slot, 0] = self._next_tok[slot]
                q_lens[slot] = 1
                tok_delta[slot] = 1
        k = 1
        if not prefilling and self.multi_step > 1 \
                and not (self._shared and self.group_attn) \
                and not (self._queue
                         and any(r is None for r in self.slots)):
            k = self.multi_step
            for req in self.slots:
                if req is not None:
                    k = min(k, req.max_new_tokens - len(req.tokens))
            k = max(1, k)
        if k > 1:
            tok_delta = q_lens * k
        kind = ("mixed" if prefilling and len(prefilling) < self.live
                else "prefill" if prefilling else "decode")
        return self._dispatch_deferred(
            feed=(toks if k == 1 else toks[:, 0]), q_lens=q_lens, qt=qt,
            k=k, prefill_advance=prefill_advance, tok_delta=tok_delta,
            kind=kind)

    def _launch_speculative(self, k: int) -> _Pending:
        """Launch the next k decode ticks on top of the UNREAD pending
        launch, its last on-device choice row as their tokens: nothing
        read back between the two launches."""
        p = self._pending
        slots = len(self.slots)
        q_lens = np.asarray([1 if r is not None else 0
                             for r in self.slots], np.int32)
        feed = p.feed_next
        return self._dispatch_deferred(
            feed=(feed[:, None] if k == 1 else feed), q_lens=q_lens, qt=1,
            k=k, prefill_advance=np.zeros((slots,), np.int32),
            tok_delta=q_lens * k, kind="decode")

    def _rollback_lengths(self, undo: np.ndarray) -> None:
        """Take `undo` [slots] tokens off the device lengths IN PLACE (the
        decode graphs hold their address) and off the mirror; the K/V
        scattered past the new lengths is overwritten before it is read."""
        self.state.lengths.sub_(upload(undo, torch.int32, self.device))
        self._lengths -= undo

    def _readback(self, p: _Pending) -> Tuple[int, bool, bool]:
        """Deferred host half of launch `p`: wait for its sampled choices
        (the pipeline's sync point) and replay the synchronous engine's
        post-sample accounting.  A fused launch is cut at its FIRST EOS
        tick — tokens past it are schedule the synchronous engine never
        produces — by rolling the lengths back and rewinding the generator
        to the state before the launch plus the draws of the kept ticks.
        Returns (tokens added, diverged, truncated); `diverged` means the
        readback produced an event (EOS, budget retire, truncation) that
        invalidates any launch speculated on top of this one.  The ticks
        kept and their tokens are counted here, where they are accounted
        (first tokens also observe the TTFT and close the request's
        prefill span)."""
        choices = _readback_choices(p)
        slots = len(self.slots)
        keep = p.k
        if p.k > 1 and self.eos_id is not None:
            for j in range(p.k):
                if any(self.slots[s] is not None and p.q_lens[s]
                       and choices[j, s] == self.eos_id
                       for s in range(slots)):
                    keep = j + 1
                    break
        added = 0
        nan_at = None
        for j in range(keep):
            row = choices[j]
            for slot, req in enumerate(self.slots):
                if req is None or not p.q_lens[slot]:
                    continue
                if row[slot] < 0:  # sample_logits NaN-poison sentinel
                    nan_at = (slot, req.rid)
                    break
                if j == 0 and p.prefill_advance[slot]:
                    req.n_prefilled += int(p.prefill_advance[slot])
                    if req.n_prefilled < len(req.prompt):
                        continue
                    # the chunk completed the prompt: its last-token logits
                    # ARE the first-token distribution
                    self._register_prefix(slot, req, p.table_rows.get(slot))
                    self._first_token(req)
                else:
                    _M_RB_DECODE.inc()
                tok = int(row[slot])
                req.tokens.append(tok)
                if self.journal is not None:
                    self.journal.tokens(req.rid, [tok])
                self._next_tok[slot] = tok
                added += 1
            if nan_at is not None:
                break
        self._account(keep, added)
        truncated = keep < p.k
        if truncated:
            self._rollback_lengths(np.where(p.q_lens > 0, p.k - keep, 0))
            if p.rng_before is not None:
                self._rng.set_state(p.rng_before)
                skip_draws(self._rng, (slots, self.cfg.vocab), keep,
                           self.device)
            _M_RECONCILE.inc(cause="scan-eos")
        if nan_at is not None:
            slot, rid = nan_at
            raise RuntimeError(
                f"slot {slot} (rid {rid}) logits are NaN-poisoned: a live "
                "slot was stepped without assigned pages")
        eos = self.eos_id is not None and any(
            req is not None and req.tokens
            and req.tokens[-1] == self.eos_id for req in self.slots)
        budget = any(
            req is not None and len(req.tokens) >= req.max_new_tokens
            for req in self.slots)
        return added, (eos or budget or truncated), truncated

    def _first_token(self, req: _Request) -> None:
        """A request's first token was just accounted: the TTFT, and with
        tracing its prefill span, first-token marker and breakdown (queued
        ends where prefill starts, prefill at the first-token instant: the
        phases sum to the TTFT)."""
        now = time.perf_counter()
        _M_TTFT.observe(now - req.t_submit)
        tc = getattr(req, "_tc", None)
        if tc is not None:
            t_adm = getattr(req, "_t_admit", req.t_submit)
            req._t_first = now
            tracing.record_span(tc, "serve.prefill", t_adm, now,
                                prompt_len=len(req.prompt))
            tracing.marker(tc, "serve.first_token", now)
            tracing.note_ttft(tc, now - req.t_submit)
            tracing.publish_breakdown({"queued": t_adm - req.t_submit,
                                       "prefill": now - t_adm})

    def _pipelined_step(self) -> List[Tuple[int, List[int]]]:
        """One pipelined tick: dispatch the next launch (speculatively if
        safe), THEN wait for the previous one — its results are what this
        call returns, so delivery lags one tick.  When the readback retires
        a stream the speculation assumed live, the speculative launch is
        rolled back (lengths and generator) and the tick falls back to the
        synchronous retire/admit/launch sequence, so the schedule is always
        the synchronous engine's.  The readback journals the tokens it
        accounts; the journal barrier runs before this returns."""
        t0 = time.perf_counter()
        done = self._flushed_done
        self._flushed_done = []
        p = self._pending
        if p is None:
            # pipeline (re)fill: the synchronous tick's head, one deferred
            # launch, nothing to read back yet
            done += self._retire_finished()
            self._admit()
            if self.live:
                self._pending = self._launch_deferred()
            self._journal_barrier(done)
            return done
        # was the pending launch already done when the tick began?  Then
        # none of the wait below is device time
        ready0 = p.event is None or p.event.query()
        k_spec = self._spec_plan()
        spec = self._launch_speculative(k_spec) if k_spec else None
        self._pending = None
        added, diverged, truncated = self._readback(p)
        t_rb = time.perf_counter()
        if spec is not None and diverged:
            # reconcile: discard the speculative launch (its K/V sits past
            # the logical lengths and is overwritten before it is read)
            self._rollback_lengths(spec.advance)
            if spec.rng_before is not None and not truncated:
                # (a truncation already rewound the generator)
                self._rng.set_state(spec.rng_before)
            _M_RECONCILE.inc(cause="eos-retire")
            spec = None
        if spec is not None:
            # the speculation was right: the launch in flight IS the next
            # tick
            self._pending = spec
        else:
            done += self._retire_finished()
            self._admit()
            if self.live:
                self._pending = self._launch_deferred()
        dt = time.perf_counter() - t0
        # device window: the pending launch ran from tick start to its
        # readback unless it was already done; the launch now in flight
        # runs from its dispatch to tick end
        dev_s = 0.0 if ready0 else t_rb - t0
        if self._pending is not None:
            dev_s += time.perf_counter() - self._pending.t_dispatch
        self._note_tick(dt, added, min(dev_s, dt))
        self._journal_barrier(done)
        return done

    def flush_pipeline(self) -> List[Tuple[int, List[int]]]:
        """Quiesce the pipeline: wait for any in-flight launch, run its
        deferred accounting and retire its finishers.  They are also
        queued onto the next step()'s return, so a loop polling step()
        loses no completion.  A no-op with nothing in flight (and on a
        synchronous engine).  drain() and serving.checkpoint.snapshot call
        it first.  The finishers pass the journal barrier here."""
        p = self._pending
        if p is None:
            return []
        self._pending = None
        self._readback(p)
        done = self._retire_finished()
        self._journal_barrier(done)
        self._flushed_done.extend(done)
        return done

    # -- speculative decoding ----------------------------------------------

    def _mixed_draft_tick(self) -> int:
        """A draft engine's tick with a slot mid-prefill: the plain chunked
        tick, then one ragged launch on the draft state feeding each
        DECODING slot the token the target just consumed (a slot still
        mid-prefill already holds its whole prompt in the draft state and
        must not step)."""
        decoding = np.asarray([r is not None
                               and r.n_prefilled == len(r.prompt)
                               for r in self.slots])
        dtoks = np.where(decoding, self._next_tok, 0)
        added = self._readback(self._launch_deferred())[0]
        if decoding.any():
            d = self.draft
            ragged_model_step(
                d.params, upload(dtoks[:, None], torch.long, self.device),
                upload(decoding.astype(np.int32), torch.int32, self.device),
                d.state, d.cfg, attn="ragged")
            _M_CATCHUP.inc()
        return added

    def _spec_round(self) -> int:
        """One speculative round for every live slot (none mid-prefill):
        the copy-on-write barrier for the k+1 positions the verify writes
        into the target pool (the draft pool is never shared: its prefill
        acquires privately), the draft's proposals and catch-up
        (Draft.propose), ONE all-logits ragged verify of [last |
        proposals] at QT = k+1 on the target, the acceptance on the host
        (Draft.accept, which rolls the draft back), then the target's
        rollback through _rollback_lengths, which keeps the host mirror
        exact.  Returns the tokens kept."""
        k = self.spec_k
        q_lens = np.asarray([k + 1 if r is not None else 0
                             for r in self.slots], np.int32)
        self._cow_barrier(q_lens)
        first = upload(self._next_tok, torch.long, self.device)
        d_toks, bad = self.draft.propose(first)
        lg_t, _ = ragged_model_step(
            self.params, torch.cat([first[:, None], d_toks], dim=1),
            upload(q_lens, torch.int32, self.device), self.state, self.cfg,
            attn=self._attn_for(k + 1), all_logits=True)
        self._lengths += q_lens
        _M_RB_LAUNCH.inc(kind="spec-verify")
        n_before = sum(len(r.tokens) for r in self.slots if r is not None)
        undo = self.draft.accept(self.slots, d_toks, lg_t, bad, self.eos_id,
                                 self._next_tok, self.journal)
        self._rollback_lengths(undo)
        added = sum(len(r.tokens) for r in self.slots
                    if r is not None) - n_before
        _M_RB_DECODE.inc(added)
        self._account(1, added)
        return added
