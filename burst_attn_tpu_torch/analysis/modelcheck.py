"""burstcheck: bounded explicit-state model checking for the serving
protocols (port of burst_attn_tpu/analysis/modelcheck.py).

The checker explores EVERY interleaving of a small protocol model to a
bounded depth, with a crash injected at every step, and proves safety
invariants over each reachable state.  The models are not shadow
re-implementations: their transitions call the exact pure machines in
`burst_attn_tpu_torch.protocols` that the port executes (`FrameBuffer.feed`,
`KvReceiver.commit`, `TokenJournal.sync/delivered`, `PagePool.acquire/
share/release` all delegate to the same `*_step` functions).  A bug
planted in a machine — or a policy edit that reorders production's
calls — is a bug the checker reaches by exhaustive search, not by luck.

Mechanics (TLA+/stateright in miniature):

  * breadth-first search over `(state, transitions)` with every state
    canonicalized and hashed for dedup — BFS order makes the FIRST
    violation found a MINIMAL counterexample trace;
  * crash transitions (process death, restart-from-snapshot) are
    ordinary transitions enabled at every step, so "kill -9 between
    these two lines" is just another interleaving;
  * transitions that raise `ProtocolError` resolve to a terminal
    `Violated` state carrying the message — a machine-level assertion
    (CoW barrier, durability barrier) IS a checkable invariant;
  * bounded liveness: a non-quiescent state where no NON-FAULT
    transition is enabled is a deadlock (a system that can only make
    progress by crashing is wedged);
  * `max_depth` / `max_states` bound the search; hitting a bound sets
    `truncated` (the gate runs exhaustive bounds for these model sizes;
    the deep sweeps of tests/test_torch_modelcheck.py run larger models).

The three models at the bottom — `transfer_model`, `journal_model`,
`pool_model` — back burstlint's proto-* rules (analysis/protocheck.py)
and export the event vocabulary a crash fuzzer derives its kill points
from.
"""

from collections import deque
from typing import Any, Callable, NamedTuple, Optional, Tuple

from ..protocols import (ProtocolError, journal as journal_proto,
                         kvtransfer as kv_proto, pool as pool_proto,
                         transport as wire_proto)


class Violated(NamedTuple):
    """Terminal state: a transition tripped a machine-level assertion
    or a model-level audit.  Carries the message, nothing else."""
    message: str


class Model(NamedTuple):
    name: str
    init_state: Any
    # state -> ((label, next_state), ...): every enabled transition
    transitions: Callable[[Any], Tuple[Tuple[str, Any], ...]]
    # state -> violation message or None
    invariant: Callable[[Any], Optional[str]]
    # state -> True when the protocol run has resolved (stop expanding)
    quiescent: Callable[[Any], bool]
    # label prefixes treated as FAULTS: excluded from the deadlock
    # enabled-set (crash/dup injection must not mask a wedged protocol)
    fault_prefixes: Tuple[str, ...] = ("crash", "dup")


class Violation(NamedTuple):
    kind: str        # "invariant" | "deadlock"
    message: str
    trace: Tuple[str, ...]   # transition labels, init -> violating state


class CheckResult(NamedTuple):
    model: str
    ok: bool
    states: int          # distinct states reached
    transitions: int     # transitions fired
    depth: int           # deepest level fully explored
    truncated: bool      # a bound stopped the search before exhaustion
    violation: Optional[Violation]


def canon(obj: Any) -> Any:
    """Canonical hashable form of a state: frozensets become sorted
    tuples so two states equal up to set iteration order hash
    identically, recursively through (named)tuples."""
    if isinstance(obj, frozenset):
        return ("\x00fs", tuple(sorted(canon(x) for x in obj)))
    if isinstance(obj, tuple):
        return tuple(canon(x) for x in obj)
    return obj


def state_key(state: Any):
    return hash(canon(state))


def guarded(label: str, fn: Callable[[], Any]) -> Tuple[str, Any]:
    """Run one transition; a ProtocolError becomes a Violated terminal
    state (the machine's own barrier fired under this interleaving)."""
    try:
        return label, fn()
    except ProtocolError as e:
        return label, Violated(f"{type(e).__name__}: {e}")


def check(model: Model, *, max_depth: int = 20,
          max_states: int = 200_000) -> CheckResult:
    """BFS over every interleaving of `model` to `max_depth`.

    Returns on the FIRST violation (minimal by BFS order) or after the
    bounded frontier is exhausted."""
    init = model.init_state
    seen = {state_key(init)}
    # key -> (parent_key, label); trace reconstruction walks this
    parents: dict = {state_key(init): (None, None)}
    frontier = deque([(init, state_key(init), 0)])
    n_states, n_transitions, depth_reached = 1, 0, 0
    truncated = False

    def trace_to(key) -> Tuple[str, ...]:
        labels = []
        while True:
            pkey, label = parents[key]
            if label is None:
                break
            labels.append(label)
            key = pkey
        return tuple(reversed(labels))

    def violation_at(key, kind, msg) -> CheckResult:
        return CheckResult(model.name, False, n_states, n_transitions,
                           depth_reached, truncated,
                           Violation(kind, msg, trace_to(key)))

    while frontier:
        state, key, depth = frontier.popleft()
        depth_reached = max(depth_reached, depth)
        if isinstance(state, Violated):
            return violation_at(key, "invariant", state.message)
        msg = model.invariant(state)
        if msg is not None:
            return violation_at(key, "invariant", msg)
        if model.quiescent(state):
            continue
        if depth >= max_depth:
            truncated = True
            continue
        succ = model.transitions(state)
        n_transitions += len(succ)
        live = [lbl for lbl, _ in succ
                if not lbl.startswith(model.fault_prefixes)]
        if not live:
            return violation_at(
                key, "deadlock",
                "no non-fault transition enabled in a non-quiescent "
                "state (enabled faults: "
                + (", ".join(lbl for lbl, _ in succ) or "none") + ")")
        for label, nxt in succ:
            nkey = state_key(nxt)
            if nkey in seen:
                continue
            if n_states >= max_states:
                truncated = True
                break
            seen.add(nkey)
            parents[nkey] = (key, label)
            n_states += 1
            frontier.append((nxt, nkey, depth + 1))
    return CheckResult(model.name, True, n_states, n_transitions,
                       depth_reached, truncated, None)


def event_vocabulary(model: Model, *, max_depth: int = 12,
                     max_states: int = 20_000) -> Tuple[str, ...]:
    """Every transition label reachable within the bound — the shared
    event vocabulary a crash fuzzer derives kill points
    from (a fuzz mode names a checker step, so the two harnesses can
    never drift apart silently)."""
    labels = set()
    seen = {state_key(model.init_state)}
    frontier = deque([(model.init_state, 0)])
    while frontier:
        state, depth = frontier.popleft()
        if isinstance(state, Violated) or model.quiescent(state) \
                or depth >= max_depth or len(seen) >= max_states:
            continue
        for label, nxt in model.transitions(state):
            labels.add(label.split("#")[0].strip())
            nkey = state_key(nxt)
            if nkey not in seen:
                seen.add(nkey)
                frontier.append((nxt, depth + 1))
    return tuple(sorted(labels))


def format_trace(v: Violation) -> str:
    steps = " -> ".join(v.trace) if v.trace else "<initial state>"
    return f"[{v.kind}] {v.message}; counterexample ({len(v.trace)} " \
           f"step(s)): {steps}"


# ---------------------------------------------------------------------------
# Model 1: the KV transfer plane (fleet/kvplane.py + fleet/fleet.py ship
# loop + fleet/transport.py dedup).  One transfer of `n_pages` pages
# from a prefill sender to a decode replica's pool, over an ordered
# wire that can redeliver (dup) frames, with either process killable.
# ---------------------------------------------------------------------------

_RID = 7  # arbitrary request id; the machines treat it opaquely


class TransferState(NamedTuple):
    send: kv_proto.SendState
    wire: Tuple[Tuple[str, int], ...]   # (op, seq) frames in flight, FIFO
    acks: int                           # kv_ack frames in flight
    nacks: int                          # kv_abort frames in flight
    dedup: wire_proto.DedupState
    recv: kv_proto.RecvState
    delivered: frozenset                # (op, seq) ever delivered (dup pool)
    committed: int
    crashed_r: int                      # receiver restarts so far (bound 1)
    sender_dead: int
    aborted: int
    # quantized pools only: page indexes whose fp32 scale sidecar is
    # staged.  Kept OUTSIDE the machine (which models control, not
    # payload) so a mutation that splits the (page, scale) pair — frames
    # carrying one half — diverges from the machine's staging set and
    # the pair invariant catches it.
    scales: frozenset = frozenset()


def transfer_model(n_pages: int = 2, pool_pages: int = 4,
                   table_width: int = 4, quantized: bool = False) -> Model:
    """`quantized=True` models a natively quantized (int8/fp8) pool's
    transfer: every kv_page frame carries a (page, scale) PAIR
    (`kv_proto.pair_members`), and the invariants additionally prove
    exactly-once PAIR landing — staging never splits a pair, a commit
    never materializes a page column whose scale sidecar did not ship,
    and crash/abort at any step drops both halves together."""
    holding = tuple(range(1, n_pages + 1))  # sender-side pinned pages
    init = TransferState(
        send=kv_proto.send_init(n_pages, holding),
        wire=(), acks=0, nacks=0,
        dedup=wire_proto.dedup_init(),
        recv=kv_proto.recv_init(pool_proto.init(pool_pages), 1,
                                table_width),
        delivered=frozenset(), committed=0, crashed_r=0,
        sender_dead=0, aborted=0)

    def apply_frame(s: TransferState, op: str, seq: int) -> TransferState:
        """Deliver one (op, seq) frame through dedup into the receiver —
        the router's forwarding path, compressed.  Stale frames that
        outlive a receiver restart (staging lost, queue transport kept
        the bytes) drop exactly like the router's abort path drops
        them; a kv_end whose commit is rejected aborts staging and
        sends kv_abort back."""
        ndd, outs = wire_proto.dedup_step(s.dedup, ("frame", _RID, seq))
        s = s._replace(dedup=ndd, delivered=s.delivered | {(op, seq)})
        if outs[0][0] == "dup":
            return s
        if op == "kv_begin":
            nrecv, _ = kv_proto.recv_step(s.recv, ("begin", _RID, n_pages))
            # a re-begin replaces staging: its sidecars reset with it
            return s._replace(recv=nrecv, scales=frozenset())
        if op == "kv_page":
            staged_page = False
            for unit, j in kv_proto.pair_members(seq - 1):
                if unit == "page":
                    try:
                        nrecv, _ = kv_proto.recv_step(
                            s.recv, ("page", _RID, j))
                    except ProtocolError:
                        return s  # stale page after a restart: dropped
                    s = s._replace(recv=nrecv)
                    staged_page = True
                elif unit == "scale" and quantized and staged_page:
                    s = s._replace(scales=s.scales | {j})
            return s
        # kv_end: the commit attempt
        pre = kv_proto.staged_entry(s.recv, _RID)
        try:
            nrecv, couts = kv_proto.recv_step(s.recv, ("commit", _RID, 0))
        except ProtocolError:
            # rejected: router aborts staging, kv_abort goes back
            nrecv, _ = kv_proto.recv_step(s.recv, ("abort", _RID))
            return s._replace(recv=nrecv, nacks=1, scales=frozenset())
        landed = couts[0][2] if couts and couts[0][0] == "committed" else ()
        got = len(pre[2]) if pre is not None else 0
        if pre is None or not kv_proto.staging_complete(pre):
            return Violated(
                f"commit landed {len(landed)} pool page(s) with only "
                f"{got}/{n_pages} shipped pages staged — transfer "
                f"atomicity broken (pages materialized that never "
                f"shipped)")
        if quantized and s.scales != frozenset(range(n_pages)):
            return Violated(
                f"commit landed {len(landed)} quantized page column(s) "
                f"with only {len(s.scales)}/{n_pages} scale sidecars "
                f"staged — (page, scale) pair landing broken (a resident "
                f"page would dequant with stale or missing scales)")
        return s._replace(recv=nrecv, committed=s.committed + 1, acks=1,
                          scales=frozenset())

    def transitions(s: TransferState):
        out = []
        if not s.sender_dead and kv_proto.send_enabled(s.send):
            def ship(s=s):
                nsend, fouts = kv_proto.send_step(s.send, ("send",))
                return s._replace(send=nsend, wire=s.wire + fouts)
            op, seq = kv_proto.sender_plan(n_pages)[s.send.next_i]
            out.append(guarded(f"ship {op}#{seq}", ship))
        if s.wire:
            op, seq = s.wire[0]
            out.append(guarded(
                f"deliver {op}#{seq}",
                lambda s=s, op=op, seq=seq: _pop_and_apply(s, op, seq)))
        if s.acks and not s.sender_dead:
            def take_ack(s=s):
                nsend, _ = kv_proto.send_step(s.send, ("ack",))
                return s._replace(send=nsend, acks=0)
            out.append(guarded("take kv_ack", take_ack))
        if s.nacks and not s.sender_dead:
            out.append(guarded(
                "take kv_abort",
                lambda s=s: s._replace(
                    send=s.send._replace(holding=()), nacks=0, aborted=1)))
        # fault injection: each fires at EVERY step it is enabled
        if not s.crashed_r and not s.committed:
            def crash_recv(s=s):
                # process death: staging + pool die; restart restores
                # the pool from the last snapshot (fresh here — the
                # transfer had not committed).  Queue transport keeps
                # undelivered bytes, so stale frames still arrive.
                return s._replace(
                    recv=kv_proto.recv_init(pool_proto.init(pool_pages),
                                            1, table_width),
                    crashed_r=1, scales=frozenset())
            out.append(guarded("crash receiver (restart from snapshot)",
                               crash_recv))
        if not s.sender_dead and not s.send.acked and not s.committed:
            def crash_send(s=s):
                # in-flight ack/abort frames die with the connection
                nsend, _ = kv_proto.send_step(s.send, ("crash",))
                nrecv, _ = kv_proto.recv_step(s.recv, ("abort", _RID))
                return s._replace(send=nsend, wire=(), recv=nrecv,
                                  acks=0, nacks=0, sender_dead=1,
                                  aborted=1, scales=frozenset())
            out.append(guarded("crash sender (router aborts transfer)",
                               crash_send))
        for op, seq in sorted(s.delivered):
            out.append(guarded(
                f"dup {op}#{seq}",
                lambda s=s, op=op, seq=seq: apply_frame(s, op, seq)))
        return tuple(out)

    def _pop_and_apply(s: TransferState, op: str, seq: int):
        s = s._replace(wire=s.wire[1:])
        return apply_frame(s, op, seq)

    def invariant(s: TransferState) -> Optional[str]:
        if s.committed > 1:
            return (f"transfer landed {s.committed} times — exactly-once "
                    f"broken (double-served KV pages after redelivery)")
        pool = s.recv.pool
        if not pool_proto.conserved(pool):
            return ("pool conservation broken: a page is on the free "
                    "list and referenced (or neither) after this "
                    "interleaving")
        held = {i for i in range(1, pool.n_pages) if pool.refs[i] > 0}
        owned = set()
        for live, ids in s.recv.slots:
            if live:
                owned |= set(ids)
        if held != owned:
            leaked = sorted(held - owned) or sorted(owned - held)
            return (f"page leak: pool pages {leaked} referenced but "
                    f"owned by no slot after kill/abort — the transfer "
                    f"plane must leave the pool exactly as it was")
        if s.send.acked and s.send.holding:
            return "sender acked but still holds shipped pages"
        if quantized and not isinstance(s, Violated):
            # pair-staging integrity: the sidecar set must mirror the
            # machine's staged page set at EVERY reachable state — a
            # frame that carried one half of a (page, scale) pair shows
            # up here as a split before commit can even be attempted
            ent = kv_proto.staged_entry(s.recv, _RID)
            got = frozenset(ent[2]) if ent is not None else frozenset()
            if s.scales != got:
                return (f"(page, scale) staging split: page columns "
                        f"{sorted(got)} staged but scale sidecars "
                        f"{sorted(s.scales)} — a kv_page frame carried "
                        f"one half of a pair")
        return None

    def quiescent(s: TransferState) -> bool:
        landed = s.send.acked and s.acks == 0 and s.committed == 1
        resolved_abort = (s.aborted and s.committed == 0 and s.nacks == 0
                          and kv_proto.staged_entry(s.recv, _RID) is None)
        return bool(landed or resolved_abort)

    return Model("transfer", init, transitions, invariant, quiescent)


# ---------------------------------------------------------------------------
# Model 2: the token journal + delivery barrier (serving/checkpoint.py
# TokenJournal, serving/engine.py step()).  One stream generating
# `n_tokens` tokens; the engine's step boundary syncs then delivers;
# crash drops the file buffer and restarts generation from the durable
# fold — exactly rewrite_journal + run_recovered's contract.
#
# The pipelined engine adds a one-step DELIVERY LAG: a launch
# samples its token on device ("pipelined launch"), and only the NEXT
# step boundary reads it back, journals it, fsyncs, and delivers —
# modeled by the `inflight` field.  A crash while a token is in flight
# simply drops it (it was never journaled; recovery regenerates it), so
# the delivered ⟹ durable invariant must hold over every interleaving of
# both the synchronous and the pipelined transitions.
# ---------------------------------------------------------------------------


class JournalModelState(NamedTuple):
    j: journal_proto.JournalState
    gen: int        # tokens the engine has produced (appended) so far
    inflight: int = 0  # tokens sampled on device, not yet read back


def journal_model(n_tokens: int = 3) -> Model:
    init = JournalModelState(journal_proto.init(), 0)

    def transitions(s: JournalModelState):
        out = []
        if s.gen < n_tokens:
            out.append(guarded(
                f"generate token #{s.gen + 1} (append)",
                lambda s=s: JournalModelState(
                    journal_proto.step(
                        s.j, ("append", "tokens", _RID, 1))[0],
                    s.gen + 1, s.inflight)))
        out.append(guarded(
            "sync (fsync barrier)",
            lambda s=s: s._replace(
                j=journal_proto.step(s.j, ("sync",))[0])))
        if s.gen > journal_proto.delivered_tokens(s.j, _RID):
            def step_boundary(s=s):
                # the engine's step() return: sync, THEN results leave.
                # A mutated sync (dropped fsync) makes the deliver
                # transition raise DurabilityViolation right here.
                j1, _ = journal_proto.step(s.j, ("sync",))
                j2, _ = journal_proto.step(j1, ("deliver", _RID, s.gen))
                return s._replace(j=j2)
            out.append(guarded(
                f"engine step boundary (sync + deliver {s.gen})",
                step_boundary))
        if s.inflight == 0 and s.gen + 1 <= n_tokens:
            # the pipelined engine dispatches a launch and returns WITHOUT
            # reading the sampled token back: it exists on device only —
            # nothing is journaled yet, nothing may be delivered from it
            out.append(guarded(
                "pipelined launch (defer readback)",
                lambda s=s: s._replace(inflight=1)))
        if s.inflight:
            def pipe_boundary(s=s):
                # the NEXT step(): deferred readback journals the
                # in-flight token, fsync, THEN the stream (now at gen+1)
                # is delivered — the fsync stays before delivery even
                # though delivery lags the launch by one step.  A mutation
                # that reorders deliver before sync trips
                # DurabilityViolation on this transition.
                j1, _ = journal_proto.step(
                    s.j, ("append", "tokens", _RID, 1))
                j2, _ = journal_proto.step(j1, ("sync",))
                j3, _ = journal_proto.step(
                    j2, ("deliver", _RID, s.gen + 1))
                return JournalModelState(j3, s.gen + 1, 0)
            out.append(guarded(
                "pipelined step boundary (readback + sync + deliver)",
                pipe_boundary))
        def crash(s=s):
            j1, _ = journal_proto.step(s.j, ("crash",))
            # restart: rewrite_journal folds the durable view; the
            # resumed engine regenerates from the durable token count.
            # An in-flight (never-journaled) device token vanishes with
            # the process — recovery regenerates it too.
            return JournalModelState(j1, journal_proto.durable_tokens(
                j1, _RID), 0)
        out.append(guarded("crash engine (restart from journal)", crash))
        return tuple(out)

    def invariant(s: JournalModelState) -> Optional[str]:
        if not journal_proto.durable_within_delivered(s.j):
            return (f"delivered {journal_proto.delivered_tokens(s.j, _RID)}"
                    f" token(s) but only "
                    f"{journal_proto.durable_tokens(s.j, _RID)} are "
                    f"durable — a crash now un-happens delivered output")
        return None

    def quiescent(s: JournalModelState) -> bool:
        return journal_proto.delivered_tokens(s.j, _RID) >= n_tokens

    return Model("journal", init, transitions, invariant, quiescent)


# ---------------------------------------------------------------------------
# Model 3: the CoW page pool under prefix sharing (models/paged_decode
# PagePool + PrefixCache + the engine's _cow_barrier policy).  Sequence
# A admits two pages and donates one to the prefix cache; sequence B
# admits against the cache (hit while the entry lives, miss after
# eviction), appends into its tail page (the CoW barrier), and both
# retire; the cache evicts.  Every interleaving of those steps.
# ---------------------------------------------------------------------------


class PoolModelState(NamedTuple):
    pool: pool_proto.PoolState
    pc_a: int            # 0 admit, 1 donate, 2 retire, 3 done
    pc_b: int            # 0 admit, 1 append, 2 retire, 3 done
    pc_c: int            # 0 empty, 1 entry live, 2 evicted
    a_pages: Tuple[int, ...]
    b_pages: Tuple[int, ...]
    cache_pages: Tuple[int, ...]


def pool_model(n_pages: int = 5) -> Model:
    init = PoolModelState(pool_proto.init(n_pages), 0, 0, 0, (), (), ())

    def transitions(s: PoolModelState):
        out = []
        if s.pc_a == 0:
            def a_admit(s=s):
                p, o = pool_proto.step(s.pool, ("acquire", 2))
                return s._replace(pool=p, pc_a=1, a_pages=tuple(o[0][1]))
            out.append(guarded("admit A (acquire 2)", a_admit))
        if s.pc_a == 1 and s.pc_c == 0:
            def donate(s=s):
                shared = (s.a_pages[0],)
                p, _ = pool_proto.step(s.pool, ("share", shared))
                return s._replace(pool=p, pc_a=2, pc_c=1,
                                  cache_pages=shared)
            out.append(guarded("donate A prefix to cache (share)", donate))
        if s.pc_a == 2:
            def a_retire(s=s):
                p, _ = pool_proto.step(s.pool, ("release", s.a_pages))
                return s._replace(pool=p, pc_a=3, a_pages=())
            out.append(guarded("retire A (release)", a_retire))
        if s.pc_b == 0 and s.pc_c == 1:
            def b_hit(s=s):
                shared = s.cache_pages
                p, _ = pool_proto.step(s.pool, ("share", shared))
                p, o = pool_proto.step(p, ("acquire", 1))
                return s._replace(pool=p, pc_b=1,
                                  b_pages=shared + tuple(o[0][1]))
            out.append(guarded("admit B (cache hit: share + acquire 1)",
                               b_hit))
        if s.pc_b == 0 and s.pc_c == 2:
            def b_miss(s=s):
                p, o = pool_proto.step(s.pool, ("acquire", 2))
                return s._replace(pool=p, pc_b=1, b_pages=tuple(o[0][1]))
            out.append(guarded("admit B (cache miss: acquire 2)", b_miss))
        if s.pc_b == 1:
            def b_append(s=s):
                # the engine's _cow_barrier: privatize the tail page iff
                # it is shared, then write.  A mutated no-op cow leaves
                # the page shared and the write event raises
                # CowViolation under this interleaving.
                tail = s.b_pages[0]
                pool, pages = s.pool, s.b_pages
                if pool.refs[tail] > 1:
                    pool, o = pool_proto.step(pool, ("cow", tail))
                    tail = o[0][2]
                    pages = (tail,) + pages[1:]
                pool, _ = pool_proto.step(pool, ("write", tail))
                return s._replace(pool=pool, pc_b=2, b_pages=pages)
            out.append(guarded("append B (CoW barrier + write)", b_append))
        if s.pc_b == 2:
            def b_retire(s=s):
                p, _ = pool_proto.step(s.pool, ("release", s.b_pages))
                return s._replace(pool=p, pc_b=3, b_pages=())
            out.append(guarded("retire B (release)", b_retire))
        if s.pc_c == 1:
            def evict(s=s):
                p, _ = pool_proto.step(s.pool, ("release", s.cache_pages))
                return s._replace(pool=p, pc_c=2, cache_pages=())
            out.append(guarded("evict cache entry (release)", evict))
        # crash + restore: the pool snapshot round-trips _free/_refs
        # wholesale (checkpoint _pool_meta/_pool_restore), so a restored
        # pool is bit-identical — the transition is the identity on the
        # pool and the checker proves the interleaving-independence of
        # that claim by reaching the same states with and without it.
        out.append(("crash engine (restore pool from snapshot)", s))
        return tuple(out)

    def invariant(s: PoolModelState) -> Optional[str]:
        if not pool_proto.conserved(s.pool):
            return ("pool conservation broken (double-free, freed-but-"
                    "referenced, or lost page) under this interleaving")
        owners: dict = {}
        for p in s.a_pages + s.b_pages + s.cache_pages:
            owners[p] = owners.get(p, 0) + 1
        for i in range(1, s.pool.n_pages):
            if s.pool.refs[i] != owners.get(i, 0):
                return (f"refcount drift: page {i} has refcount "
                        f"{s.pool.refs[i]} but {owners.get(i, 0)} "
                        f"owner(s) hold it")
        return None

    def quiescent(s: PoolModelState) -> bool:
        return (s.pc_a == 3 and s.pc_b == 3 and s.pc_c == 2
                and pool_proto.available(s.pool) == s.pool.n_pages - 1)

    return Model("pool", init, transitions, invariant, quiescent)


ALL_MODELS = (transfer_model, journal_model, pool_model)
