"""The write-ahead token journal machine (port of
burst_attn_tpu/protocols/journal.py): delivered => durable, pure.

Mirrors `serving/checkpoint.TokenJournal` + `journal_view`: appends
BUFFER (a file object's userspace buffer), `sync` (flush + fsync) folds
the buffered records into the DURABLE view, and a crash drops whatever
was buffered but not yet synced.  The delivery barrier the engines
enforce (step() syncs before returning results) is an explicit machine
transition: `("deliver", rid, n_total)` asserts that the caller-visible
stream of `rid` (`n_total` tokens) is already durable, raising
`DurabilityViolation` otherwise.  `TokenJournal.delivered()` runs exactly
this transition, so an engine edit that returns tokens before the sync
barrier fails loudly in every test that drives a journaled engine.

State (all hashable; per-rid maps are sorted tuples of pairs):

  buffered       record tuples in append order, not yet durable:
                 ("tokens", rid, k) | ("done", rid) | ("reset", rid)
                 | ("submit", rid)
  durable        ((rid, n_tokens), ...) — the folded on-disk view
                 (resets applied, exactly journal_view's fold)
  durable_done   rids whose "done" record is on disk
  delivered      ((rid, n_tokens), ...) — the high-water mark of what
                 callers have SEEN (not part of the file; the invariant
                 ties it to `durable`)

Events:

  ("append", kind, rid, k)   buffer one record (k = token count; 0 for
                             submit/done/reset)
  ("sync",)                  fold buffered into durable
  ("deliver", rid, n)        caller observes rid at n total tokens;
                             raises DurabilityViolation if n exceeds
                             the durable count
  ("crash",)                 buffered records vanish; durable survives;
                             `delivered` survives too — the caller
                             already saw those tokens, which is exactly
                             why the invariant matters after recovery

Pipelined delivery lag: the pipelined RaggedServeEngine samples each
launch's tokens ON THE DEVICE and reads them back one step late, so a
token exists for one tick in neither `buffered` nor `durable`: it is not
a journal event yet.  The machine needs no new event for this: the
deferred readback appends, syncs, and only then delivers, and a crash
mid-flight means the token was never journaled and recovery regenerates
it.  The lag changes WHEN deliver runs (one step after generation), not
the invariant.
"""

from typing import NamedTuple, Tuple

from . import ProtocolError


class DurabilityViolation(ProtocolError, RuntimeError):
    """Tokens reached a caller before their journal records were
    fsynced — a crash now would un-happen delivered output."""


class JournalState(NamedTuple):
    buffered: Tuple[Tuple, ...]
    durable: Tuple[Tuple[int, int], ...]
    durable_done: Tuple[int, ...]
    delivered: Tuple[Tuple[int, int], ...]


def init() -> JournalState:
    return JournalState((), (), (), ())


def _get(pairs: Tuple[Tuple[int, int], ...], rid: int) -> int:
    for r, n in pairs:
        if r == rid:
            return n
    return 0


def _set(pairs: Tuple[Tuple[int, int], ...], rid: int,
         n: int) -> Tuple[Tuple[int, int], ...]:
    out = tuple((r, v) for r, v in pairs if r != rid)
    return tuple(sorted(out + ((rid, n),)))


def durable_tokens(st: JournalState, rid: int) -> int:
    return _get(st.durable, rid)


def delivered_tokens(st: JournalState, rid: int) -> int:
    return _get(st.delivered, rid)


def durable_within_delivered(st: JournalState) -> bool:
    """The safety invariant proto-journal-durable proves over every
    interleaving: no caller ever saw a token that is not on disk."""
    return all(n <= _get(st.durable, rid) for rid, n in st.delivered)


def step(st: JournalState, event: Tuple) -> Tuple[JournalState, Tuple]:
    kind = event[0]
    if kind == "append":
        rkind, rid = event[1], int(event[2])
        k = int(event[3]) if len(event) > 3 else 0
        if rkind not in ("tokens", "done", "reset", "submit"):
            raise ValueError(f"unknown journal record kind {rkind!r}")
        if rkind == "tokens" and k <= 0:
            return st, ()  # TokenJournal.tokens() drops empty appends
        rec = (rkind, rid, k) if rkind == "tokens" else (rkind, rid)
        return st._replace(buffered=st.buffered + (rec,)), ()
    if kind == "sync":
        durable, done = st.durable, st.durable_done
        for rec in st.buffered:
            rkind, rid = rec[0], rec[1]
            if rkind == "tokens":
                durable = _set(durable, rid, _get(durable, rid) + rec[2])
            elif rkind == "reset":
                durable = _set(durable, rid, 0)
            elif rkind == "done" and rid not in done:
                done = tuple(sorted(done + (rid,)))
        return JournalState((), durable, done, st.delivered), ()
    if kind == "deliver":
        rid, n = int(event[1]), int(event[2])
        have = _get(st.durable, rid)
        if n > have:
            raise DurabilityViolation(
                f"rid {rid}: delivering {n} token(s) but only {have} "
                f"are durable — sync() must run before results leave "
                f"the engine")
        if n > _get(st.delivered, rid):
            st = st._replace(delivered=_set(st.delivered, rid, n))
        return st, ()
    if kind == "crash":
        return st._replace(buffered=()), ()
    raise ValueError(f"unknown journal event {event!r}")
