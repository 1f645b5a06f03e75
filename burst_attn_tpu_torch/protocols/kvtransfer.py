"""The transactional KV transfer machine (port of
burst_attn_tpu/protocols/kvtransfer.py): stage/commit/abort + the
sender's hold-until-ack plan, pure.

Receiver side extracts `fleet/kvplane.KvReceiver` + its `commit`:
staging NEVER touches the pool; `commit` checks every control
precondition (staging present, transfer complete, table width, dead
slot, pool availability) BEFORE acquiring a single page, in the
receiver's order (the data-shape preconditions, page geometry and layer
counts, are arrays the receiver checks between `complete` and the
table-width check; the machine does not model payload bytes).
`KvReceiver.commit` runs `commit_preconditions` and then takes its page
ids from this machine's acquire, asserting they match the real pool's.

Sender side extracts the prefill worker's ship loop
(`fleet/fleet.prefill_main`): one transfer is the frame sequence
`sender_plan(n_pages)` (kv_begin(seq 0), kv_page(seq 1..n),
kv_end(seq n+1)), after which the worker HOLDS the shipped pages until
the router's kv_ack (post-commit) or kv_abort retires them.
`PAGE_CREDIT_WINDOW` pins the flow-control contract: the sender may
ship the whole transfer without per-page credits, because the one ack
only arrives AFTER kv_end reaches the replica and commits; a per-page
credit window against a commit-time-only ack is a circular wait.

Receiver state/events:

  ("begin", rid, n)     stage a transfer (re-begin replaces staging)
  ("page", rid, j)      stage page j (KvStagingError without a begin)
  ("abort", rid)        drop staging; outputs ("aborted", rid) if any
  ("commit", rid, slot) preconditions -> acquire -> install -> unstage;
                        outputs ("committed", rid, ids)
  ("crash",)            staging vanishes (it was process memory); the
                        pool and slots of the crashed process die with
                        it, and a restart restores snapshot state
"""

from typing import NamedTuple, Tuple

from . import ProtocolError, pool as pool_proto


class KvStagingError(ProtocolError, KeyError):
    pass


class KvCommitError(ProtocolError, ValueError):
    pass


class KvSlotLive(ProtocolError, RuntimeError):
    pass


# -- sender ------------------------------------------------------------------

# Flow-control contract (see module docstring): None = the sender may
# ship every frame of one transfer without waiting for credits.
PAGE_CREDIT_WINDOW = None

# Pair contract for natively quantized pools (int8/fp8 storage with
# per-token fp32 scale columns): one kv_page frame carries the page AND
# its scale sidecar, staged and committed as a unit — kvplane.add_page
# rejects a frame missing its sidecars whole, and commit scatters both
# under one release-on-failure block.
SCALE_PAIRED = True


def pair_members(j: int) -> Tuple[Tuple[str, int], ...]:
    """The staging units one quantized kv_page frame carries: the page
    column and the scale sidecar ride the SAME frame, so they can only
    land (or abort, or die) together."""
    if SCALE_PAIRED:
        return (("page", int(j)), ("scale", int(j)))
    return (("page", int(j)),)


def sender_plan(n_pages: int) -> Tuple[Tuple[str, int], ...]:
    """The exact (op, seq) frame sequence one transfer ships, in order.
    `prefill_main` iterates this to build its kv_begin/kv_page/kv_end
    frames."""
    return ((("kv_begin", 0),)
            + tuple(("kv_page", j + 1) for j in range(int(n_pages)))
            + (("kv_end", int(n_pages) + 1),))


class SendState(NamedTuple):
    n_pages: int
    next_i: int            # index into sender_plan
    pages_acked: int       # per-page credits returned (always 0 today)
    holding: Tuple[int, ...]  # pool pages pinned until kv_ack/kv_abort
    acked: bool


def send_init(n_pages: int, holding: Tuple[int, ...]) -> SendState:
    return SendState(int(n_pages), 0, 0, tuple(holding), False)


def send_enabled(st: SendState) -> bool:
    """May the sender ship its next frame?  Encodes the credit contract
    — with PAGE_CREDIT_WINDOW None this is just 'plan not exhausted'."""
    plan = sender_plan(st.n_pages)
    if st.acked or st.next_i >= len(plan):
        return False
    if PAGE_CREDIT_WINDOW is not None:
        pages_in_flight = max(0, st.next_i - 1) - st.pages_acked
        if plan[st.next_i][0] == "kv_page" \
                and pages_in_flight >= PAGE_CREDIT_WINDOW:
            return False
    return True


def send_step(st: SendState, event: Tuple) -> Tuple[SendState, Tuple]:
    kind = event[0]
    if kind == "send":
        if not send_enabled(st):
            raise KvCommitError("sender has no frame to send "
                                "(plan exhausted, acked, or out of credits)")
        op, seq = sender_plan(st.n_pages)[st.next_i]
        return st._replace(next_i=st.next_i + 1), ((op, seq),)
    if kind == "ack":
        # the router's kv_ack: the replica committed; retire the held
        # pages (the caller releases st.holding from its pool)
        return (st._replace(acked=True, holding=()),
                (("retire", st.holding),))
    if kind == "crash":
        # the prefill worker died: held pages die with its pool; the
        # router's heartbeat path re-ships from a sibling
        return send_init(st.n_pages, ())._replace(acked=st.acked), ()
    raise ValueError(f"unknown sender event {event!r}")


# -- receiver ----------------------------------------------------------------


class RecvState(NamedTuple):
    # ((rid, n_pages, got_frozenset), ...) sorted by rid
    staging: Tuple[Tuple[int, int, frozenset], ...]
    pool: pool_proto.PoolState
    # slots[i] = (live: 0|1, pages held by that slot)
    slots: Tuple[Tuple[int, Tuple[int, ...]], ...]
    table_width: int


def recv_init(pool: pool_proto.PoolState, n_slots: int,
              table_width: int) -> RecvState:
    return RecvState((), pool, ((0, ()),) * n_slots, int(table_width))


def staged_entry(st: RecvState, rid: int):
    for ent in st.staging:
        if ent[0] == rid:
            return ent
    return None


def _set_staging(st: RecvState, rid: int, ent) -> RecvState:
    rest = tuple(e for e in st.staging if e[0] != rid)
    if ent is not None:
        rest = tuple(sorted(rest + (ent,)))
    return st._replace(staging=rest)


def staging_complete(ent) -> bool:
    _, n, got = ent
    return len(got) == n and all(j in got for j in range(n))


def commit_preconditions(st: RecvState, rid: int, slot: int) -> int:
    """Every CONTROL precondition of a commit, checked with zero pool
    mutation, the receiver's order and messages.  Returns n_pages.
    Skipping it would commit half-shipped transfers and leak acquired
    pages."""
    ent = staged_entry(st, rid)
    if ent is None:
        raise KvStagingError(f"commit for rid {rid} with no staging")
    _, n, got = ent
    if not staging_complete(ent):
        raise KvCommitError(
            f"rid {rid} staged {len(got)}/{n} pages; transfer incomplete")
    if n > st.table_width:
        raise KvCommitError(f"transfer needs {n} pages > table width "
                            f"{st.table_width}")
    if st.slots[slot][0]:
        raise KvSlotLive(f"slot {slot} is still live; retire it first")
    if pool_proto.available(st.pool) < n:
        raise pool_proto.PoolExhausted(
            f"page pool exhausted: want {n}, have "
            f"{pool_proto.available(st.pool)}")
    return n


def recv_step(st: RecvState, event: Tuple) -> Tuple[RecvState, Tuple]:
    kind = event[0]
    if kind == "begin":
        rid, n = int(event[1]), int(event[2])
        # a re-shipped attempt for the same rid replaces stale staging
        return _set_staging(st, rid, (rid, n, frozenset())), ()
    if kind == "page":
        rid, j = int(event[1]), int(event[2])
        ent = staged_entry(st, rid)
        if ent is None:
            raise KvStagingError(f"kv_page for rid {rid} with no kv_begin")
        rid_, n, got = ent
        return _set_staging(st, rid, (rid, n, got | {j})), ()
    if kind == "abort":
        rid = int(event[1])
        ent = staged_entry(st, rid)
        if ent is None:
            return st, ()
        # drop staging; pool untouched by construction
        return _set_staging(st, rid, None), (("aborted", rid),)
    if kind == "commit":
        rid, slot = int(event[1]), int(event[2])
        n = commit_preconditions(st, rid, slot)
        npool, out = pool_proto.step(st.pool, ("acquire", n))
        ids = out[0][1]
        slots = list(st.slots)
        slots[slot] = (1, ids)
        st = _set_staging(
            st._replace(pool=npool, slots=tuple(slots)), rid, None)
        return st, (("committed", rid, ids),)
    if kind == "retire":
        slot = int(event[1])
        live, ids = st.slots[slot]
        if not live:
            return st, ()
        npool, _ = pool_proto.step(st.pool, ("release", ids))
        slots = list(st.slots)
        slots[slot] = (0, ())
        return st._replace(pool=npool, slots=tuple(slots)), ()
    if kind == "crash":
        return st._replace(staging=()), ()
    raise ValueError(f"unknown receiver event {event!r}")
