"""The PagePool refcount machine (port of burst_attn_tpu/protocols/pool.py):
free-list + refcount algebra, pure.

State is the WHOLE allocator (free list order matters: acquire pops
from the tail exactly like `PagePool.acquire`, so the ids the machine
hands out are the pool's).  Page 0 is the reserved
write sink and never enters the free list or carries a ref.

Events:

  ("acquire", n)        -> outputs (("acquired", ids),)
  ("share", ids)        -> outputs ()
  ("release", ids)      -> outputs (("freed", ids_returned_to_free),)
  ("write", pid)        -> outputs ()     the CoW write barrier: writing
                           a page held at refcount > 1 is a silent
                           cross-request corruption; the machine raises
                           CowViolation
  ("cow", pid)          -> outputs (("cow", old, new),)  privatize one
                           shared page: acquire a private replacement,
                           drop one ref from the shared original

Exceptions keep the pool's types AND messages: `PoolExhausted` is a
RuntimeError, `PoolRefError` is a ValueError; `PagePool`
(models/paged_decode.py) re-raises them verbatim.
"""

from typing import Iterable, List, NamedTuple, Tuple

from . import ProtocolError


class PoolExhausted(ProtocolError, RuntimeError):
    pass


class PoolRefError(ProtocolError, ValueError):
    pass


class CowViolation(ProtocolError):
    """A write targeted a page held at refcount > 1 (missing CoW)."""


class PoolState(NamedTuple):
    n_pages: int
    free: Tuple[int, ...]   # tail = next page handed out (stack order)
    refs: Tuple[int, ...]   # len == n_pages; refs[0] unused (sink)


def init(n_pages: int) -> PoolState:
    return PoolState(n_pages=n_pages,
                     free=tuple(range(n_pages - 1, 0, -1)),
                     refs=(0,) * n_pages)


def from_lists(n_pages: int, free: Iterable[int],
               refs: Iterable[int]) -> PoolState:
    return PoolState(n_pages=int(n_pages),
                     free=tuple(int(p) for p in free),
                     refs=tuple(int(r) for r in refs))


def available(st: PoolState) -> int:
    return len(st.free)


def in_use(st: PoolState) -> int:
    return st.n_pages - 1 - len(st.free)


def conserved(st: PoolState) -> bool:
    """The conservation law: every usable page is EITHER on the free
    list (refcount 0) or referenced (refcount > 0), never both, never
    neither, never twice."""
    free = set(st.free)
    if len(free) != len(st.free):
        return False  # duplicate free-list entry (double-free)
    held = {i for i in range(1, st.n_pages) if st.refs[i] > 0}
    if free & held:
        return False  # freed page still referenced
    if any(st.refs[i] != 0 for i in st.free):
        return False
    return free | held == set(range(1, st.n_pages))


def step(st: PoolState, event: Tuple) -> Tuple[PoolState, Tuple]:
    kind = event[0]
    if kind == "acquire":
        n = int(event[1])
        if n > len(st.free):
            raise PoolExhausted(
                f"page pool exhausted: want {n}, have {len(st.free)}")
        ids = [st.free[-1 - k] for k in range(n)]  # pop order
        refs = list(st.refs)
        for i in ids:
            refs[i] = 1
        nxt = PoolState(st.n_pages, st.free[:len(st.free) - n], tuple(refs))
        return nxt, (("acquired", tuple(ids)),)
    if kind == "share":
        ids = [int(i) for i in event[1]]
        for i in ids:
            if not 0 < i < st.n_pages:
                raise PoolRefError(f"bad page id {i}")
            if st.refs[i] == 0:
                raise PoolRefError(
                    f"page {i} is free; share() needs a live page")
        refs = list(st.refs)
        for i in ids:
            refs[i] += 1
        return PoolState(st.n_pages, st.free, tuple(refs)), ()
    if kind == "release":
        # an over-release would put the page on the free list while
        # another sequence still references it — corrupt both, silently
        ids = [int(i) for i in event[1]]
        counts: dict = {}
        for i in ids:
            counts[i] = counts.get(i, 0) + 1
        for i, c in counts.items():
            if not 0 < i < st.n_pages:  # page 0 is the reserved sink
                raise PoolRefError(f"bad page id {i}")
            if st.refs[i] < c:
                raise PoolRefError(
                    f"page {i} released {c}x but has {st.refs[i]} refs")
        refs = list(st.refs)
        free: List[int] = list(st.free)
        for i in ids:
            refs[i] -= 1
            if refs[i] == 0:
                free.append(i)
        return PoolState(st.n_pages, tuple(free), tuple(refs)), ()
    if kind == "write":
        pid = int(event[1])
        if pid and st.refs[pid] > 1:
            raise CowViolation(
                f"write to page {pid} at refcount {st.refs[pid]} "
                f"without a CoW copy first")
        return st, ()
    if kind == "cow":
        # serving/model.cow_pages, reduced to its pool algebra: the
        # caller owns one of `pid`'s refs; acquire a private replacement
        # and move that ref onto it (the copy itself is device work the
        # machine does not model)
        pid = int(event[1])
        if not 0 < pid < st.n_pages or st.refs[pid] == 0:
            raise PoolRefError(f"cow of non-live page {pid}")
        st2, out = step(st, ("acquire", 1))
        new = out[0][1][0]
        st3, _ = step(st2, ("release", (pid,)))
        return st3, (("cow", pid, new),)
    raise ValueError(f"unknown pool event {event!r}")
