"""Paged KV-cache serving path (port of burst_attn_tpu/models/paged_decode.py):
a shared page pool and ragged continuous batching on top of
ops/paged_attention.py.

  * `PagePool` (host-side): the refcounted free list of pool pages.
    Sequences acquire pages as they grow and release them on retirement —
    admission control falls out of `available`.
  * `PagedState` (device tensors): per-layer page pools, the page table,
    per-sequence lengths.  Shapes never change; the host rewrites the
    table (tiny int32 tensors) as sequences come and go.
  * `paged_prefill` absorbs a prompt into freshly acquired pages (flash
    attention over the contiguous prompt, then a scatter of the rope'd K/V
    into the pages); `paged_decode_step` appends one token per live slot
    and attends through the paged kernel.  A windowed model (cfg.window)
    bands both; the pages keep every token, as in the JAX package.
  * `paged_prefill(cache=)` reuses the full prompt pages a `PrefixCache`
    holds: only the suffix is computed, attending the gathered (and, on a
    1-byte pool, dequantized) cached context plus itself through ONE
    offset mask on the flash kernel (`_suffix_attention`), and the
    prompt's full pages are registered for later requests.
  * `ragged_model_step` advances every slot by its own token count in
    one pass (the ragged kernel; serving/model.py's engine step);
    `paged_multi_step` is that step at T tokens for every live slot
    (speculative verification) and `rollback_tokens` un-appends them.

In-place updates: the JAX functions donate the state and return a new
one.  Here the pools, table and lengths are updated IN PLACE (index_put_ /
index_copy_) and the same state object is returned, so call sites keep
the JAX shape `logits, state = paged_decode_step(...)`.  The pool is sized
to fill device memory, so a copy per step is not an option.

Page 0 is a reserved sink: dead slots scatter their mandatory K/V write
into it, and a LIVE slot whose next page is 0 (capacity was never
provisioned) gets NaN logits, which sample_logits(nan_sentinel=True)
turns into -1.

Quantized pools (`init_paged_state(quantize="int8" | "fp8")`) store
1 B/elem pages with per-token fp32 scales beside them; every write
quantizes into both, every read dequantizes through both, and a page is
never copied without its scales.  `PrefixCache` is the content-hashed
index of full prompt pages the ragged engine shares through the pool's
refcounts; `to_meta` / `from_meta` carry it through an engine snapshot
(serving/checkpoint.py).

Tensor-parallel serving (`mesh` with cfg.head_axis, as the JAX
functions take it): `init_paged_state(mesh=)` gives every tp position its
own kv-head shard of each layer's pool and scale banks (a bank is then
stacked [tp, P, Nkv / tp, page, D], position t's shard the contiguous
[t]); the page table and lengths stay shared.  Each position projects
its heads with its shard of the weights (transformer.shard_params, once;
plain parameters with a tp mesh are a ValueError) and launches its own kernel on its
own shard, as JAX's shard_map does per device: kernel 1 for a prompt
(`_prompt_attention_dispatch`) and for a cached prefix's suffix
(`_suffix_attention_dispatch`), kernel 6 for a decode step
(`_paged_attention_dispatch`: tp launches a layer).  The row-parallel
wo and w_down partial sums meet in all_reduce, the vocab-parallel embed
masks each shard's ids before its all_reduce, and the logits are
all_gathered.  ragged_model_step (RaggedServeEngine, which takes no mesh
in JAX) refuses a tp state.
"""

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.flash import flash_fwd
from ..ops.masks import MaskSpec
from ..ops.paged_attention import (
    QUANT_DTYPES, gather_pages, paged_decode_attention, pool_bytes,
    quantize_tokens,
)
from ..ops.ragged_paged import (
    ragged_paged_attention, ragged_paged_attention_grouped,
    ragged_paged_reference,
)
from ..protocols import pool as pool_proto
from .decode import _flash_prompt_attention
from .transformer import (
    ModelConfig, _attn_out, _embed, _logits, _mlp, _qkv_from_h, _qkv_proj,
    _rms_norm, check_tp, tp_of, tp_parts, tp_sum,
)


# the pool machine's exception types (RuntimeError / ValueError
# subclasses), importable from here as before
PoolExhausted = pool_proto.PoolExhausted
PoolRefError = pool_proto.PoolRefError


def resolve_pool_dtype(quantize, default):
    """(pool storage dtype, canonical tag) for an init_paged_state-style
    `quantize` knob: False -> (default, None); True / "int8" -> int8;
    "fp8" -> float8_e4m3fn.  The tag is the string every downstream user
    keys on (the prefix-cache hash seed, the pool's `dtype`)."""
    if not quantize:
        return default, None
    name = "int8" if quantize is True else str(quantize)
    if name not in QUANT_DTYPES:
        raise ValueError(f"quantize must be False, True, or one of "
                         f"{sorted(QUANT_DTYPES)}; got {quantize!r}")
    return QUANT_DTYPES[name][0], name


@dataclass
class PagedState:
    """Device-side paged cache (one pool per layer, table shared).  A
    quantized pool keeps per-token fp32 dequant scales beside the pages;
    the scale banks are pool state exactly like the page bytes."""
    k_pages: List[torch.Tensor]  # each [P, Nkv, page, D]
    v_pages: List[torch.Tensor]
    page_table: torch.Tensor     # [slots, max_pages_per_seq] int32
    lengths: torch.Tensor        # [slots] int32 (0 = empty slot)
    k_scales: Optional[List[torch.Tensor]] = None  # each [P, Nkv, page]
    v_scales: Optional[List[torch.Tensor]] = None
    # tp positions sharing the pool: > 1 stacks every bank [tp, P, Nkv/tp,
    # ...] (position t's kv-head shard the contiguous [t])
    tp: int = 1


def page_size(state: PagedState) -> int:
    """Tokens a pool page holds."""
    return state.k_pages[0].shape[-2]


def _bank(state: PagedState, li: int, t: int):
    """(k pages, v pages, k scales, v scales) of layer li as tp position t
    holds them (the whole banks without tp; scales None unless
    quantized)."""
    pick = ((lambda b: b) if state.tp == 1 else (lambda b: b[t]))
    quant = state.k_scales is not None
    return (pick(state.k_pages[li]), pick(state.v_pages[li]),
            pick(state.k_scales[li]) if quant else None,
            pick(state.v_scales[li]) if quant else None)


def _check_tp(params, state: PagedState, cfg: ModelConfig, mesh) -> None:
    """Raise unless the parameters' tp split agrees with `mesh` (tp_of,
    strict as JAX's _check_tp_mesh) and with the state's kv-head
    shards."""
    tp = tp_of(params, cfg, mesh, strict=True)
    if tp != state.tp:
        raise ValueError(f"the paged state holds {state.tp} tp shard(s), "
                         f"the call runs tp={tp}: pass the same mesh to "
                         "init_paged_state")


def _prompt_attention_dispatch(qs, ks, vs, cfg: ModelConfig):
    """Prompt attention of every tp position on its head shard: one flash
    kernel (kernel 1) launch a position on a CUDA tensor (JAX's
    head-sharded shard_map)."""
    return [_flash_prompt_attention(q, k, v, window=cfg.window)
            for q, k, v in zip(qs, ks, vs)]


def _paged_attention_dispatch(qgs, state: PagedState, li: int, lengths,
                              cfg: ModelConfig):
    """Paged decode attention of every tp position over its own kv-head
    shard of layer li's pool (and scales): kernel 6 once a position, the
    page table and lengths shared."""
    out = []
    for t, qg in enumerate(qgs):
        kp, vp, ks, vs = _bank(state, li, t)
        out.append(paged_decode_attention(qg, kp, vp, state.page_table,
                                          lengths, k_scales=ks, v_scales=vs,
                                          window=cfg.window))
    return out


def _suffix_attention_dispatch(qs, ks, vs, t_pre, q_hi, kv_hi,
                               cfg: ModelConfig):
    """The prefix cache's suffix attention of every tp position on its
    head shard (kernel 1 on the offset mask, once a position)."""
    return [_suffix_attention(q, k, v, t_pre, q_hi=q_hi, kv_hi=kv_hi,
                              window=cfg.window)
            for q, k, v in zip(qs, ks, vs)]


class PagePool:
    """Host-side REFCOUNTED page allocator for a PagedState.

    `acquire(n)` pops page ids from the free list at refcount 1 (raises
    PoolExhausted, a RuntimeError, when short — callers use `available`
    for admission control); `release(ids)` decrements and returns a page to
    the free list when its count reaches zero; `share(ids)` adds a
    reference to live pages.  The pool never touches device memory: pages
    are recycled by table rewrite, stale contents are simply never
    addressed.  Page 0 is the reserved write sink and never enters the
    free list.  `dtype` is the storage tag of the pools it fronts: None =
    full precision, "int8" / "fp8" = 1 B pages with scale banks.

    Every mutation runs through the pure transition function
    `protocols.pool.step` (the JAX package's machine, same ids and
    messages), with `_free` / `_refs` kept as the mutable mirror of the
    machine state (snapshots read them directly)."""

    def __init__(self, n_pages: int, dtype: Optional[str] = None):
        self.n_pages = n_pages
        self.dtype = dtype
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._refs = [0] * n_pages

    def proto_state(self) -> pool_proto.PoolState:
        """The allocator as the machine's immutable PoolState."""
        return pool_proto.from_lists(self.n_pages, self._free, self._refs)

    def _step(self, event):
        st, out = pool_proto.step(self.proto_state(), event)
        self._free = list(st.free)
        self._refs = list(st.refs)
        return out

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """PHYSICAL pages currently held (each shared page counts once)."""
        return self.n_pages - 1 - len(self._free)

    @property
    def logical_refs(self) -> int:
        """Sum of refcounts — the pages the pool would need WITHOUT
        sharing."""
        return sum(self._refs)

    @property
    def has_shared(self) -> bool:
        """True iff any page is held at refcount > 1: the cheap gate that
        lets the serving engine skip the copy-on-write scan."""
        return any(r > 1 for r in self._refs)

    def refcount(self, i: int) -> int:
        return self._refs[int(i)]

    def acquire(self, n: int) -> List[int]:
        out = self._step(("acquire", int(n)))
        return list(out[0][1])

    def share(self, ids) -> None:
        """Add one reference to already-live pages."""
        self._step(("share", tuple(int(i) for i in ids)))

    def release(self, ids) -> None:
        # the machine validates the whole batch before mutating anything:
        # an over-release would put a still-referenced page on the free list
        self._step(("release", tuple(int(i) for i in ids)))


class PrefixCache:
    """Host-side page-aligned prefix cache (automatic prefix caching,
    restricted to FULL pages).

    Maps the rolling hash of each full-page token prefix to the pool page
    holding that page's K/V (one page id is valid across every layer's
    pool — the table is layer-shared).  The cache owns ONE pool reference
    per registered page, so cached pages survive their sequences retiring;
    `evict(n)` drops least-recently-used leaf entries and their refs.  A
    write into a shared page goes through the engine's copy-on-write
    barrier (serving/model.cow_pages) first."""

    def __init__(self, pool: PagePool):
        self._pool = pool
        self._pages: Dict[bytes, int] = {}   # prefix hash -> page id
        self._lru: "OrderedDict[bytes, None]" = OrderedDict()  # oldest first
        # chain structure: a lookup stops at the first miss, so an entry
        # whose parent is gone can never hit again — eviction goes
        # leaf-first
        self._parent: Dict[bytes, Optional[bytes]] = {}
        self._nkids: Dict[bytes, int] = {}

    @staticmethod
    def chain(tokens, page: int, dtype: Optional[str] = None) -> List[bytes]:
        """Rolling hash per FULL page of `tokens` (1-D int array): entry i
        identifies the whole prefix tokens[:(i+1)*page].  The pool's
        storage `dtype` tag seeds the chain, so an entry made against an
        int8 pool never aliases one made against fp8 or full precision;
        dtype None keeps the full-precision chain.  Same bytes as the JAX
        package's chain."""
        toks = np.asarray(tokens, np.int32)
        out: List[bytes] = []
        h = b"" if dtype is None else f"pool:{dtype}".encode()
        for i in range(len(toks) // page):
            h = hashlib.sha1(h + toks[i * page:(i + 1) * page].tobytes()
                             ).digest()
            out.append(h)
        return out

    def __len__(self):
        return len(self._pages)

    def lookup(self, hashes: List[bytes]) -> List[int]:
        """Longest cached prefix of `hashes`; bumps the pool refcount of
        every returned page (the caller owns the new references) and marks
        the entries recently used."""
        ids: List[int] = []
        for h in hashes:
            pid = self._pages.get(h)
            if pid is None:
                break
            ids.append(pid)
            self._lru.move_to_end(h)
        self._pool.share(ids)
        return ids

    def insert(self, hashes: List[bytes], page_ids) -> None:
        """Register a prompt's FULL hash chain (hashes[i]'s parent is
        hashes[i-1]); the cache takes one reference per NEWLY inserted
        page.  Entries already present are only marked recently used."""
        assert len(hashes) == len(page_ids)
        prev: Optional[bytes] = None
        for h, pid in zip(hashes, page_ids):
            if h in self._pages:
                self._lru.move_to_end(h)
            else:
                self._pool.share([int(pid)])
                self._pages[h] = int(pid)
                self._lru[h] = None
                self._parent[h] = prev
                self._nkids[h] = 0
                if prev is not None:
                    self._nkids[prev] += 1
            prev = h

    def evictable(self) -> int:
        """Upper bound on the pages evict() could free now: entries whose
        page only the cache references (a shed heuristic, not a
        guarantee — a parent pinned behind a live child counts)."""
        return sum(1 for pid in self._pages.values()
                   if self._pool.refcount(pid) == 1)

    def to_meta(self) -> List[List[str]]:
        """JSON-able snapshot of the index: [hash_hex, page_id, parent_hex]
        per entry in LRU order (least recent first), as the JAX package
        writes it.  Pool refcounts are NOT included: the pool serializes
        its own `_refs` wholesale (serving/checkpoint._pool_meta), and this
        index's references are part of that total."""
        return [[h.hex(), str(self._pages[h]),
                 (self._parent[h] or b"").hex()]
                for h in self._lru]

    @classmethod
    def from_meta(cls, pool: PagePool, meta) -> "PrefixCache":
        """Rebuild an index captured by to_meta against an already-restored
        pool.  Does NOT call pool.share: the restored refcounts already
        include this index's references, and bumping them again would leak
        every cached page."""
        cache = cls(pool)
        for h_hex, pid, parent_hex in meta:
            h = bytes.fromhex(h_hex)
            parent = bytes.fromhex(parent_hex) or None
            pid = int(pid)
            if pool.refcount(pid) < 1:
                raise ValueError(
                    f"prefix-cache meta references free page {pid}")
            cache._pages[h] = pid
            cache._lru[h] = None
            cache._parent[h] = parent
            cache._nkids.setdefault(h, 0)
            if parent is not None:
                cache._nkids[parent] = cache._nkids.get(parent, 0) + 1
        return cache

    def evict(self, n: int) -> int:
        """Free up to n pages by dropping entries, least recently used
        first among LEAVES, skipping entries a live sequence still shares.
        Returns the pages actually freed."""
        freed = 0
        progress = True
        while freed < n and progress:
            progress = False
            for h in list(self._lru):
                if freed >= n:
                    break
                if self._nkids.get(h, 0) > 0:
                    continue  # not a leaf
                if self._pool.refcount(self._pages[h]) > 1:
                    continue  # shared with a live sequence
                del self._lru[h]
                self._pool.release([self._pages.pop(h)])
                parent = self._parent.pop(h)
                self._nkids.pop(h, None)
                if parent is not None and parent in self._nkids:
                    self._nkids[parent] -= 1
                freed += 1
                progress = True  # a parent may have become a leaf
        return freed


def init_paged_state(cfg: ModelConfig, *, slots: int, n_pages: int,
                     page: int = 128, max_pages_per_seq: int = 64,
                     quantize=False, mesh=None, device=None):
    """Fresh pool + allocator: (PagedState, PagePool).  `page` must be a
    multiple of 128, as in the JAX package, so both accept the same
    configurations.  Total pool capacity is n_pages * page tokens shared
    by all slots.  `quantize`: False = pools in cfg.dtype; True or "int8"
    = int8 pools; "fp8" = float8_e4m3fn pools, each with fp32 scale banks
    [n_pages, Nkv, page] initialized to ones.  `mesh` with cfg.head_axis
    of size tp > 1: every bank stacked [tp, ...] over the tp positions,
    each holding its Nkv / tp kv heads (the JAX pool's kv-head
    sharding)."""
    if page % 128:
        raise ValueError(f"page size {page} must be a multiple of 128")
    dt, tag = resolve_pool_dtype(quantize, cfg.dtype)
    dev = resolve_device(device)
    tp = check_tp(cfg, mesh, strict=True)
    shape = (n_pages, cfg.n_kv_heads, page, cfg.d_head)
    if tp > 1:
        shape = (tp, n_pages, cfg.n_kv_heads // tp, page, cfg.d_head)

    def banks(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for _ in range(cfg.n_layers)]

    state = PagedState(
        banks(shape, dt), banks(shape, dt),
        torch.zeros((slots, max_pages_per_seq), dtype=torch.int32,
                    device=dev),
        torch.zeros((slots,), dtype=torch.int32, device=dev), tp=tp)
    if tag is not None:
        state.k_scales = [b.fill_(1.0) for b in banks(shape[:-1],
                                                      torch.float32)]
        state.v_scales = [b.fill_(1.0) for b in banks(shape[:-1],
                                                      torch.float32)]
    return state, PagePool(n_pages, dtype=tag)


def write_table_row(state: PagedState, slot: int, row) -> PagedState:
    """Point `slot`'s table row at the page ids `row` (a sequence or an
    integer tensor), the rest of the row at the sink page 0, IN PLACE
    (JAX's `_write_table_row`)."""
    row = torch.as_tensor(row, dtype=torch.int32)
    state.page_table[slot] = 0
    state.page_table[slot, :row.numel()] = row.to(state.page_table.device)
    return state


def _scatter_pages(pages, new, page_ids, scales=None):
    """Write [1, Nkv, T, D] rope'd K/V into pool pages `page_ids` IN PLACE
    (T padded to a whole number of pages by the caller).  A quantized pool
    passes its `scales` bank: the rows quantize per token into the pool's
    dtype and both banks are written together."""
    page = pages.shape[2]
    n_kv, t, d = new.shape[1:]
    chunks = new[0].reshape(n_kv, t // page, page, d).transpose(0, 1)
    if scales is None:
        pages.index_copy_(0, page_ids, chunks.to(pages.dtype))
        return
    q8, s = quantize_tokens(chunks, dtype=pages.dtype)
    pool_bytes(pages).index_copy_(0, page_ids, pool_bytes(q8))
    scales.index_copy_(0, page_ids, s)


def _write_tokens(pages, scales, page_id, offset, rows):
    """Write K or V rows [..., Nkv, D] at pool positions (page_id, offset)
    [...] IN PLACE; a quantized pool (scales given) gets the rows
    quantized per token into its bytes and scales together."""
    if scales is None:
        pages[page_id, :, offset] = rows.to(pages.dtype)
        return
    q8, s = quantize_tokens(rows, dtype=pages.dtype)
    pool_bytes(pages)[page_id, :, offset] = pool_bytes(q8)
    scales[page_id, :, offset] = s


def _suffix_attention(q, k, v, t_pre, q_hi, kv_hi, window=None):
    """Causal attention of suffix queries (absolute positions t_pre..)
    over the full [cached prefix + suffix] context: one offset MaskSpec —
    col j visible from suffix row i iff j <= i + t_pre — on the flash
    kernel (kernel 1) for a CUDA tensor, its plain version (tile_fwd) for
    a CPU one.  q [B, N, T, D] and k, v [B, Nkv, S, D] may carry padded
    tail rows and columns: q_hi and kv_hi keep them invisible, and a pad
    row's output is 0.  Returns o [B, N, T, D] in q's dtype."""
    spec = MaskSpec(0, int(q_hi), int(kv_hi), 1, int(t_pre))
    _, _, o = flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                        None, None, None, q.shape[-1] ** -0.5, spec,
                        window=window, emit_o=True)
    return o


def paged_prefill(params, tokens, state: PagedState, pool: PagePool,
                  slot: int, cfg: ModelConfig, mesh=None,
                  cache: Optional[PrefixCache] = None):
    """Absorb one prompt [T] into batch slot `slot`: acquires ceil(T/page)
    pages, runs the prompt pass (flash attention + paged K/V scatter) and
    writes the slot's table row, all IN PLACE on `state`.  Returns
    (last-token logits [vocab] fp32, state).  On a failure the acquired
    pages are released before re-raising.

    `cache` (PrefixCache): the full pages whose token prefix is cached
    are REUSED — their K/V is never recomputed; the suffix runs a shorter
    prefill that attends the cached context through an offset mask
    (_suffix_attention) — and the prompt's own full pages are registered
    (the whole chain, hits included).  At least one suffix token always
    stays: its logits are the caller's.  On a failure the lookup's
    references are released with the acquired pages.

    `mesh` with cfg.head_axis: tensor-parallel (the state from
    init_paged_state(mesh=)); every tp position runs its own kernel
    launches on its head shard."""
    _check_tp(params, state, cfg, mesh)
    dev = state.lengths.device
    tokens = torch.as_tensor(tokens, device=dev).reshape(-1).long()
    t = tokens.numel()
    page = page_size(state)
    max_pages = state.page_table.shape[1]
    n_need = -(-t // page)
    if n_need > max_pages:
        raise ValueError(f"prompt needs {n_need} pages > table width "
                         f"{max_pages}")
    length = int(state.lengths[slot])
    if length != 0:
        raise RuntimeError(f"slot {slot} is still live (len {length}); "
                           "retire_slot first or its pages leak")
    hashes: List[bytes] = []
    if cache is not None:
        hashes = PrefixCache.chain(tokens.cpu().numpy(), page,
                                   dtype=pool.dtype)
        hits = cache.lookup(hashes[:(t - 1) // page])
        if hits:
            t_pre = len(hits) * page
            ids: List[int] = []
            try:
                # inside the try: an exhausted pool must release the
                # lookup's references too
                ids = pool.acquire(-(-(t - t_pre) // page))
                logits = _prefill_suffix(params, tokens[t_pre:], state, hits,
                                         ids, slot, cfg)
            except Exception:
                pool.release(ids + hits)  # hits carry the lookup's refs
                raise
            n_full = t // page
            cache.insert(hashes[:n_full], hits + ids[:n_full - len(hits)])
            return logits, state
    ids = pool.acquire(n_need)
    try:
        logits = _prefill(params, tokens, state, ids, slot, cfg)
    except Exception:
        pool.release(ids)
        raise
    if cache is not None:
        cache.insert(hashes[:t // page], ids[:t // page])
    return logits, state


def _prefill_suffix(params, suffix, state: PagedState, ctx_ids, suf_ids,
                    slot, cfg):
    """Prefill of a prompt whose first t_pre = len(ctx_ids) * page tokens'
    K/V already sit in cached pages: q/k/v for the SUFFIX only (padded to
    whole pages), attention over the gathered context + suffix through
    one offset mask, the suffix K/V scattered into suf_ids, and the slot's
    table row pointed at [ctx_ids | suf_ids].  Each tp position gathers
    its own kv-head shard of the context.  Returns the last prompt
    token's logits [vocab] fp32."""
    t_suf = suffix.numel()
    dev = suffix.device
    page = page_size(state)
    t_pre = len(ctx_ids) * page
    t_pad = len(suf_ids) * page
    toks = F.pad(suffix, (0, t_pad - t_suf))[None]
    pos = t_pre + torch.arange(t_pad, device=dev)[None]
    ctx = torch.tensor(ctx_ids, dtype=torch.long, device=dev)
    page_ids = torch.tensor(suf_ids, dtype=torch.long, device=dev)
    x = _embed(params, toks, cfg)
    for li, p in enumerate(params["layers"]):
        h = _rms_norm(x, p["attn_norm"])
        parts = tp_parts(p)
        qs, ks_, vs_, news = [], [], [], []
        for t, pt in enumerate(parts):
            kp, vp, ksc, vsc = _bank(state, li, t)
            q, k, v = _qkv_from_h(pt, h, pos, cfg)
            # the context dequantized through the pool's gather; the
            # padded suffix rows and columns stay invisible (q_hi, kv_hi)
            kc = gather_pages(kp, ksc, ctx)[None].to(cfg.dtype)
            vc = gather_pages(vp, vsc, ctx)[None].to(cfg.dtype)
            qs.append(q)
            ks_.append(torch.cat([kc, k.to(cfg.dtype)], dim=2))
            vs_.append(torch.cat([vc, v.to(cfg.dtype)], dim=2))
            news.append((k, v))
        os = _suffix_attention_dispatch(qs, ks_, vs_, t_pre, t_suf,
                                        t_pre + t_suf, cfg)
        for t, (k, v) in enumerate(news):
            kp, vp, ksc, vsc = _bank(state, li, t)
            _scatter_pages(kp, k, page_ids, ksc)
            _scatter_pages(vp, v, page_ids, vsc)
        x = x + tp_sum([_attn_out(pt, o) for pt, o in zip(parts, os)],
                       cfg.head_axis)
        x = x + _mlp(p, x, cfg, inference=True)[0]
    x = _rms_norm(x[:, t_suf - 1:t_suf], params["final_norm"])
    logits = _logits(x, params["lm_head"])[0, 0]
    write_table_row(state, slot, torch.cat([ctx, page_ids]))
    state.lengths[slot] = t_pre + t_suf
    return logits


def _prefill(params, tokens, state: PagedState, ids, slot, cfg):
    t = tokens.numel()
    dev = tokens.device
    page = page_size(state)
    t_pad = len(ids) * page
    pos = torch.arange(t, device=dev)[None]
    page_ids = torch.tensor(ids, dtype=torch.long, device=dev)
    x = _embed(params, tokens[None], cfg)
    pad = (0, 0, 0, t_pad - t)
    for li, p in enumerate(params["layers"]):
        h = _rms_norm(x, p["attn_norm"])
        parts = tp_parts(p)
        qkv = [_qkv_from_h(pt, h, pos, cfg) for pt in parts]
        # the prompt attends its own full-precision K/V; only the pool
        # stores the (possibly quantized) copies
        os = _prompt_attention_dispatch(*zip(*qkv), cfg)
        for pos_t, (_, k, v) in enumerate(qkv):
            kp, vp, ksc, vsc = _bank(state, li, pos_t)
            _scatter_pages(kp, F.pad(k, pad), page_ids, ksc)
            _scatter_pages(vp, F.pad(v, pad), page_ids, vsc)
        x = x + tp_sum([_attn_out(pt, o) for pt, o in zip(parts, os)],
                       cfg.head_axis)
        x = x + _mlp(p, x, cfg, inference=True)[0]
    x = _rms_norm(x[:, -1:], params["final_norm"])
    logits = _logits(x, params["lm_head"])[0, 0]
    write_table_row(state, slot, page_ids)
    state.lengths[slot] = t
    return logits


def paged_decode_step(params, tokens, state: PagedState, cfg: ModelConfig,
                      mesh=None):
    """One decode step for EVERY live slot (ragged batch), IN PLACE.

    tokens: [slots] int — next input token per slot (ignored for empty
    slots).  Every live slot must already own the page its next token
    lands in (`ensure_capacity` / `provision_capacity`); a live slot that
    does not gets NaN logits instead of silently writing into the sink.
    Returns ([slots, vocab] fp32 logits, state).  No host sync.

    `mesh` with cfg.head_axis: tensor-parallel; each tp position writes
    its kv heads into its pool shard and runs kernel 6 over it."""
    _check_tp(params, state, cfg, mesh)
    dev = state.lengths.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    slots = tokens.shape[0]
    page = page_size(state)
    width = state.page_table.shape[1]
    lengths = state.lengths
    live = lengths > 0
    pos = lengths.long()  # next position = current length (0 when dead)
    x = _embed(params, tokens[:, None], cfg)  # [slots, 1, d]
    group = cfg.n_heads // cfg.n_kv_heads

    # which (page, offset) receives the new token per slot
    slot_page = (lengths // page).long()
    offset = (lengths % page).long()
    in_table = slot_page < width
    page_id = state.page_table.gather(
        1, slot_page.clamp(max=width - 1)[:, None])[:, 0]
    page_id = torch.where(in_table, page_id, 0)
    # a LIVE slot mapping to page 0 skipped ensure_capacity at a page
    # boundary: its token would land in the sink — poison its logits
    boundary_unassigned = live & (page_id == 0)
    page_id = torch.where(live, page_id, 0).long()  # dead slots -> sink
    new_lengths = lengths + live.to(torch.int32)

    for li, p in enumerate(params["layers"]):
        h = _rms_norm(x, p["attn_norm"])
        parts = tp_parts(p)
        qgs = []
        for t, pt in enumerate(parts):
            kp, vp, ks, vs = _bank(state, li, t)
            q, k, v = _qkv_from_h(pt, h, pos[:, None], cfg)
            _write_tokens(kp, ks, page_id, offset, k[:, :, 0])
            _write_tokens(vp, vs, page_id, offset, v[:, :, 0])
            qgs.append(q.reshape(slots, k.shape[1], group,
                                 cfg.d_head).contiguous())
        os = _paged_attention_dispatch(qgs, state, li, new_lengths, cfg)
        x = x + tp_sum([_attn_out(pt, o.reshape(slots, -1, 1, cfg.d_head))
                        for pt, o in zip(parts, os)], cfg.head_axis)
        x = x + _mlp(p, x, cfg, inference=True)[0]
    x = _rms_norm(x, params["final_norm"])
    logits = _logits(x, params["lm_head"])[:, 0]
    logits = logits.masked_fill(boundary_unassigned[:, None], float("nan"))
    state.lengths.copy_(new_lengths)
    return logits, state


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
    if state.tp > 1:
        raise ValueError("ragged_model_step takes no tp state: the ragged "
                         "engine serves without a mesh, as in the JAX "
                         "package")
    dev = state.lengths.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    q_lens = torch.as_tensor(q_lens, device=dev).to(torch.int32)
    slots, qt = tokens.shape
    page = page_size(state)
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
        x = x + _mlp(p, x, cfg, inference=True)[0]
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


def paged_multi_step(params, tokens, state: PagedState, cfg: ModelConfig):
    """Append T tokens to EVERY live slot in one pass, IN PLACE
    (speculative verification): tokens [slots, T] -> ([slots, T, vocab]
    fp32 logits, state with lengths += T for live slots).

    The new tokens' K/V scatter into the pool first; then each live slot's
    T queries attend its pages causally: ragged_model_step at q_len T for
    every live slot, so a CUDA state takes the ragged kernel and a CPU
    state its plain version (the JAX function's dense gather).  Capacity
    for all T tokens must be provisioned: a live slot mapping any of them
    to page 0 gets NaN logits.  Dead slots scatter nothing and give
    logits the caller ignores.  Rollback is `rollback_tokens`, or a
    lengths decrement: entries past lengths are invisible, and on a
    quantized pool so are their stale scales."""
    dev = state.lengths.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    q_lens = torch.where(state.lengths > 0, tokens.shape[1], 0).to(
        torch.int32)
    return ragged_model_step(params, tokens, q_lens, state, cfg,
                             attn="ragged", all_logits=True)


def rollback_tokens(state: PagedState, slot: int, n: int) -> PagedState:
    """Host-side: un-append the last n tokens of `slot` (speculative
    rejection), IN PLACE.  Pure lengths bookkeeping: entries past lengths
    are invisible and the next append overwrites them; pages stay
    assigned.  The JAX package's single-slot guard, kept for direct
    callers of paged_multi_step.  Neither engine calls it: ServeEngine
    and RaggedServeEngine roll every slot back at once with one lengths
    subtraction (the ragged engine through `_rollback_lengths`, which
    keeps its host mirror), and this function reads the device."""
    length = int(state.lengths[slot])
    if n < 0 or n >= length:
        # n == length would zero the slot while its table row still owns
        # pages: retire_slot returns early on length 0 and the pages leak
        raise ValueError(f"cannot roll back {n} of {length} tokens "
                         "(at least one must remain; retire_slot frees)")
    state.lengths[slot] = length - n
    return state


def ensure_capacity(state: PagedState, pool: PagePool, slot: int
                    ) -> PagedState:
    """Host-side: guarantee `slot` has a page for its next token, acquiring
    one if its last page is full.  Call before paged_decode_step."""
    length = int(state.lengths[slot])
    page = page_size(state)
    if length % page != 0 or length == 0:
        return state  # room in the current page (or empty slot)
    slot_page = length // page
    if slot_page >= state.page_table.shape[1]:
        raise RuntimeError(f"slot {slot} exceeded max_pages_per_seq")
    if int(state.page_table[slot, slot_page]) != 0:
        # idempotent: page 0 is the sink, so 0 reliably means unassigned
        return state
    (new_id,) = pool.acquire(1)
    state.page_table[slot, slot_page] = new_id
    return state


def provision_capacity(state: PagedState, pool: PagePool, slot: int,
                       n_tokens: int) -> PagedState:
    """Host-side: pre-assign every page `slot` needs to absorb `n_tokens`
    MORE tokens, so a decode loop of that many steps needs no further
    allocation (one table read here instead of one per step)."""
    if n_tokens <= 0:
        return state
    length = int(state.lengths[slot])
    if length == 0:
        raise RuntimeError(
            f"slot {slot} is empty; paged_prefill acquires its own pages — "
            "provisioning now would leak them when prefill rewrites the row")
    page = page_size(state)
    need_through = (length + n_tokens - 1) // page  # highest column needed
    if need_through >= state.page_table.shape[1]:
        raise RuntimeError(
            f"slot {slot}: {n_tokens} more tokens need table column "
            f"{need_through} >= max_pages_per_seq "
            f"{state.page_table.shape[1]}")
    row = state.page_table[slot].tolist()
    missing = [c for c in range(need_through + 1) if row[c] == 0]
    if not missing:
        return state
    ids = pool.acquire(len(missing))
    dev = state.page_table.device
    state.page_table[slot, torch.tensor(missing, device=dev)] = torch.tensor(
        ids, dtype=torch.int32, device=dev)
    return state


def retire_slot(state: PagedState, pool: PagePool, slot: int) -> PagedState:
    """Host-side: release a finished sequence's pages (used or
    pre-acquired) and empty the slot, zeroing its table row so a later
    prefill/provision cannot mistake stale ids for assignments."""
    if int(state.lengths[slot]) == 0:
        return state
    pool.release([i for i in state.page_table[slot].tolist() if i != 0])
    state.lengths[slot] = 0
    state.page_table[slot] = 0
    return state
