"""The KV transfer plane (port of burst_attn_tpu/fleet/kvplane.py): pool
pages on the wire, transactionally.

`ring_prefill_to_pages` (serving/handoff.py) lands a prompt's K/V in the
PREFILL worker's pool pages, in layout order.  To hand the request to a
decode replica in another process those pages must move, and the
handoff's permutation-invariance argument (decode attends every cached
position; validity is table membership, never ordering) means they move
VERBATIM: page j of the slot's table row on the prefill side becomes page
j of the replica's table row, whatever physical pool ids each side
assigned.  No re-layout, no reordering, byte-identical payloads: the
tests compare `page_bytes` on both ends.  A natively quantized pool
(int8/fp8) ships its 1 B/elem pages the same way, with the per-token
fp32 scale columns riding each kv_page frame as sidecars: a (page, scale)
pair stages, commits and aborts as one unit, and both ends must agree on
the pool dtype (checked before a single page is acquired).

Host copies: the slot's pages are gathered on the pool's device and
copied to the host once.  Arrays whose dtype numpy has (fp32, int8, the
fp32 scales) travel as numpy arrays, as in the JAX package; bf16 and fp8
pages as CPU torch tensors (fleet/transport.py carries both, byte for
byte).  `page_bytes` and `page_digest` equal the JAX package's for the
same page contents.

The transfer is TRANSACTIONAL on the receive side:

    kv_begin(meta)  ->  stage (zero pool mutation)
    kv_page(j) x n  ->  stage (zero pool mutation)
    commit()        ->  precondition-check, acquire, scatter, table row
    abort()         ->  drop staging (zero pool mutation, nothing leaks)

`commit` checks EVERY precondition (page-shape match, table width, live
slot, pool availability) before acquiring a single page, and releases on
any scatter failure: an aborted or half-shipped transfer leaves both
pools exactly as they were ("zero page leaks").
"""

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..models.paged_decode import PagePool, PagedState, write_table_row
from ..ops.paged_attention import pool_bytes
from ..protocols import kvtransfer as _kvp, pool as _pool_proto
from ..serving.checkpoint import PAGE_DTYPES
from .transport import array_bytes, host_array

M_KV_PAGES_SHIPPED = obs.counter(
    "fleet.kv_pages_shipped", "pool pages serialized onto the wire")
M_KV_BYTES_SHIPPED = obs.counter(
    "fleet.kv_bytes_shipped", "KV payload bytes serialized")
M_KV_COMMITTED = obs.counter(
    "fleet.kv_transfers_committed", "transfers admitted by a replica")
M_KV_ABORTED = obs.counter(
    "fleet.kv_transfers_aborted", "transfers aborted with staging dropped")

_DTYPE_NAMES = {v: k for k, v in PAGE_DTYPES.items()}


def _dtype_name(dtype: torch.dtype) -> str:
    """A pool dtype by the JAX package's name (str of the jnp dtype)."""
    return _DTYPE_NAMES[dtype]


def _nbytes(a) -> int:
    return a.nbytes if isinstance(a, np.ndarray) \
        else a.numel() * a.element_size()


def export_slot_pages(state: PagedState, slot: int) -> Tuple[dict, List[dict]]:
    """Serialize one live slot's pages in TABLE ORDER.

    Returns (meta, pages): meta describes the stream (page geometry,
    layer/head counts, dtype, token length); pages[j] holds table column
    j's per-layer K and V arrays [n_kv, page, d_head] on the host — page j
    on the wire is position range [j*page, (j+1)*page) in layout order,
    exactly what the sender's table row j pointed at.

    A quantized pool ships its 1 B/elem pages VERBATIM plus fp32 scale
    sidecars: pages[j]["ks"] / ["vs"] carry table column j's per-layer
    [n_kv, page] dequant columns, and meta["quantized"] is True so the
    receive side can refuse a cross-precision commit before touching its
    pool.  A (page, scale) pair always rides in ONE kv_page frame."""
    length = int(state.lengths[slot])
    if length == 0:
        raise ValueError(f"slot {slot} is not live; nothing to export")
    quant = state.k_scales is not None
    page = int(state.k_pages[0].shape[2])
    n_pages = -(-length // page)
    n_layers = len(state.k_pages)
    idx = state.page_table[slot, :n_pages].long()

    def gathered(banks):
        # one device gather + one host copy a layer; the gather reads a
        # 1-byte pool through its uint8 view (no fp8 indexing kernel)
        return [host_array(pool_bytes(b)[idx].view(b.dtype)) for b in banks]

    k_host, v_host = gathered(state.k_pages), gathered(state.v_pages)
    if quant:
        ks_host, vs_host = gathered(state.k_scales), gathered(state.v_scales)
    meta = {
        "length": length,
        "page": page,
        "n_pages": int(n_pages),
        "n_layers": n_layers,
        "n_kv": int(state.k_pages[0].shape[1]),
        "d_head": int(state.k_pages[0].shape[3]),
        "dtype": _dtype_name(state.k_pages[0].dtype),
        "quantized": quant,
    }
    pages = []
    for j in range(n_pages):
        pg = {"k": [k_host[li][j] for li in range(n_layers)],
              "v": [v_host[li][j] for li in range(n_layers)]}
        if quant:
            pg["ks"] = [ks_host[li][j] for li in range(n_layers)]
            pg["vs"] = [vs_host[li][j] for li in range(n_layers)]
        pages.append(pg)
        M_KV_PAGES_SHIPPED.inc()
        M_KV_BYTES_SHIPPED.inc(sum(_nbytes(a) for a in _page_arrays(pg)))
    return meta, pages


def _page_arrays(pg: dict) -> list:
    """Every array of one page message in canonical order: k, v, then the
    scale sidecars when the pool is quantized."""
    arrays = list(pg["k"]) + list(pg["v"])
    if "ks" in pg:
        arrays += list(pg["ks"]) + list(pg["vs"])
    return arrays


def page_bytes(pg: dict) -> bytes:
    """Canonical byte string of one page message (k then v then the scale
    sidecars, layer order) — the unit the byte-identity tests and
    `page_digest` hash.  A quantized page's digest covers its scales, so
    a (page, scale) pair that forked anywhere on the wire cannot match."""
    return b"".join(array_bytes(a) for a in _page_arrays(pg))


def page_digest(pg: dict) -> str:
    return hashlib.sha256(page_bytes(pg)).hexdigest()


def _stack(arrays, dtype: torch.dtype, device) -> torch.Tensor:
    """Staged host arrays (numpy or CPU torch) stacked into one tensor of
    the pool's dtype on the pool's device; a 1-byte dtype as its bytes."""
    ts = [a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a)) for a in arrays]
    t = torch.stack(ts)
    if t.dtype != dtype:
        t = t.to(dtype)
    return pool_bytes(t).to(device)


class KvReceiver:
    """Staging area + transactional commit on the decode side.  Staging
    never touches the pool; only `commit` does, and only after every
    precondition passes.

    Control decisions (staging lifecycle, commit preconditions, and the
    page ids a commit acquires) come from the pure machine
    `protocols.kvtransfer.recv_step`.  This class keeps the payload
    arrays (which the machine does not model) in lockstep with the
    machine's staging set and asserts the real pool hands out exactly the
    ids the machine computed."""

    def __init__(self):
        self._staging: Dict[int, dict] = {}
        self._proto = _kvp.RecvState((), _pool_proto.init(1), (), 0)

    def _proto_step(self, event):
        self._proto, outs = _kvp.recv_step(self._proto, event)
        return outs

    def begin(self, rid: int, meta: dict) -> None:
        # a re-shipped attempt for the same rid replaces stale staging
        self._proto_step(("begin", rid, int(meta["n_pages"])))
        self._staging[rid] = {"meta": dict(meta), "pages": {}}

    def add_page(self, rid: int, j: int, pg: dict) -> None:
        # machine first: it owns the "page with no begin" staging check;
        # shape validation failures roll the (pure, free to keep) prior
        # machine state back so payloads and staging never diverge
        prev = self._proto
        self._proto_step(("page", rid, int(j)))
        st = self._staging[rid]
        meta = st["meta"]
        try:
            want = (meta["n_kv"], meta["page"], meta["d_head"])
            for a in list(pg["k"]) + list(pg["v"]):
                if tuple(a.shape) != want:
                    raise ValueError(
                        f"page {j} shape {tuple(a.shape)} != {want}")
            if len(pg["k"]) != meta["n_layers"] \
                    or len(pg["v"]) != meta["n_layers"]:
                raise ValueError(f"page {j} layer count mismatch")
            if meta.get("quantized"):
                # quantized streams stage (page, scale) PAIRS: a frame
                # missing its sidecars (or malformed) is rejected whole
                if "ks" not in pg or "vs" not in pg:
                    raise ValueError(
                        f"page {j}: quantized stream frame is missing "
                        f"its scale sidecars")
                want_s = (meta["n_kv"], meta["page"])
                for a in list(pg["ks"]) + list(pg["vs"]):
                    if tuple(a.shape) != want_s:
                        raise ValueError(
                            f"page {j} scale shape {tuple(a.shape)} != "
                            f"{want_s}")
                if len(pg["ks"]) != meta["n_layers"] \
                        or len(pg["vs"]) != meta["n_layers"]:
                    raise ValueError(f"page {j} scale layer count mismatch")
            elif "ks" in pg or "vs" in pg:
                raise ValueError(
                    f"page {j}: scale sidecars on a full-precision stream")
        except ValueError:
            self._proto = prev
            raise
        st["pages"][int(j)] = pg

    def complete(self, rid: int) -> bool:
        ent = _kvp.staged_entry(self._proto, rid)
        return ent is not None and _kvp.staging_complete(ent)

    def staged(self, rid: int) -> Optional[dict]:
        return self._staging.get(rid)

    def staging_count(self) -> int:
        return len(self._staging)

    def abort(self, rid: int) -> bool:
        """Drop staging for `rid`.  Pool untouched by construction."""
        dropped = bool(self._proto_step(("abort", rid)))
        self._staging.pop(rid, None)
        if dropped:
            M_KV_ABORTED.inc()
        return dropped

    def _proto_snapshot(self, state: PagedState, pool: PagePool,
                        n_slots: int) -> "_kvp.RecvState":
        """The machine's view of THIS commit: real staging + the real
        pool/slot occupancy (slot page sets are irrelevant to commit
        preconditions, so they stay empty)."""
        lengths = state.lengths.tolist()
        return _kvp.RecvState(
            staging=self._proto.staging,
            pool=pool.proto_state(),
            slots=tuple((1 if int(lengths[i]) else 0, ())
                        for i in range(n_slots)),
            table_width=int(state.page_table.shape[1]))

    def commit(self, rid: int, state: PagedState, pool: PagePool,
               slot: int) -> PagedState:
        """Scatter the staged pages into `slot` (IN PLACE, like every
        state update of the port): all preconditions up-front,
        acquire-scatter-table under release-on-failure, then drop
        staging.  Raises with ZERO pool mutation when the transfer cannot
        be admitted (incomplete staging, live slot, table overflow, pool
        exhaustion)."""
        snap = self._proto_snapshot(state, pool, int(state.lengths.shape[0]))
        ent = _kvp.staged_entry(snap, rid)
        if ent is None:
            raise KeyError(f"commit for rid {rid} with no staging")
        if not _kvp.staging_complete(ent):
            raise ValueError(
                f"rid {rid} staged {len(ent[2])}/{ent[1]} pages; "
                f"transfer incomplete")
        st = self._staging[rid]
        meta = st["meta"]
        n = int(meta["n_pages"])
        page = int(state.k_pages[0].shape[2])
        if meta["page"] != page:
            raise ValueError(f"sender page size {meta['page']} != pool "
                             f"page size {page}")
        if len(state.k_pages) != meta["n_layers"]:
            raise ValueError("layer count mismatch")
        quant = state.k_scales is not None
        if bool(meta.get("quantized")) != quant:
            kind = ["full-precision", "quantized"]
            raise ValueError(
                f"pool precision mismatch: sender "
                f"{kind[bool(meta.get('quantized'))]}, receiver "
                f"{kind[quant]}")
        pool_dt = _dtype_name(state.k_pages[0].dtype)
        if str(meta["dtype"]) != pool_dt:
            raise ValueError(f"sender pool dtype {meta['dtype']} != "
                             f"receiver pool dtype {pool_dt}")
        # the remaining control preconditions + the acquire run the full
        # machine commit on the snapshot; the real pool then replays the
        # acquire and MUST hand out the machine's exact ids
        snap2, outs = _kvp.recv_step(snap, ("commit", rid, slot))
        ids = list(outs[0][2])
        got = pool.acquire(n)
        assert got == ids, (
            f"pool/machine divergence: machine acquired {ids}, "
            f"pool acquired {got}")
        try:
            dev = state.k_pages[0].device
            idx = torch.tensor(ids, dtype=torch.long, device=dev)
            pages = [st["pages"][j] for j in range(n)]
            banks = [("k", state.k_pages), ("v", state.v_pages)]
            if quant:
                # the scale sidecar lands in the SAME try block as its
                # page: any failure releases every acquired id, so a page
                # can never be resident without its scales
                banks += [("ks", state.k_scales), ("vs", state.v_scales)]
            for key, bank in banks:
                for li in range(meta["n_layers"]):
                    rows = _stack([pg[key][li] for pg in pages],
                                  bank[li].dtype, dev)
                    pool_bytes(bank[li]).index_copy_(0, idx, rows)
            write_table_row(state, slot, idx)
            state.lengths[slot] = int(meta["length"])
        except Exception:
            pool.release(ids)
            raise
        self._proto = self._proto._replace(staging=snap2.staging)
        del self._staging[rid]
        M_KV_COMMITTED.inc()
        return state
