"""The port's protocol machines (burst_attn_tpu_torch.protocols: pool,
transport, kvtransfer) held to the JAX package's, transition for
transition: seeded event sequences, crashes included, give equal states,
equal outputs and the same exception types and messages in both
packages; the port's PagePool runs the machine and hands out the JAX
PagePool's ids and refcounts."""

import inspect

import numpy as np
import pytest
import torch

from burst_attn_tpu.models.paged_decode import PagePool as JPagePool
from burst_attn_tpu.protocols import (kvtransfer as jkv, pool as jpool,
                                      transport as jwire)
from burst_attn_tpu_torch.models.paged_decode import (
    PagePool, PoolExhausted, PoolRefError, init_paged_state,
)
from burst_attn_tpu_torch.models.transformer import ModelConfig
from burst_attn_tpu_torch.protocols import (
    ProtocolError, kvtransfer as kvp, pool as pp, transport as wp,
)

SEEDS = (0, 1, 2, 3)


def _apply(step_j, step_p, st_j, st_p, ev):
    """One event through both machines: both return equal (state,
    outputs), or both raise the same exception type name and message
    (the states then stay as they were)."""
    try:
        nj, oj = step_j(st_j, ev)
        ej = None
    except Exception as e:  # noqa: BLE001 — compared below
        ej = e
    try:
        np_, op = step_p(st_p, ev)
        ep = None
    except Exception as e:  # noqa: BLE001 — compared below
        ep = e
    if ej is not None or ep is not None:
        assert ej is not None and ep is not None, (ev, ej, ep)
        assert type(ej).__name__ == type(ep).__name__, (ev, ej, ep)
        assert str(ej) == str(ep), (ev, ej, ep)
        # the same class hierarchy by name (ProtocolError and a builtin)
        assert [c.__name__ for c in type(ej).__mro__] == \
            [c.__name__ for c in type(ep).__mro__], (ev, ej, ep)
        return st_j, st_p, True
    assert nj == np_, ev
    assert oj == op, ev
    return nj, np_, False


def _pool_events(rng, n_pages, n):
    ids = list(range(-1, n_pages + 1))
    for _ in range(n):
        k = int(rng.integers(5))
        if k == 0:
            yield ("acquire", int(rng.integers(0, 4)))
        elif k == 1:
            yield ("share", tuple(int(rng.choice(ids))
                                  for _ in range(rng.integers(1, 3))))
        elif k == 2:
            yield ("release", tuple(int(rng.choice(ids))
                                    for _ in range(rng.integers(1, 4))))
        elif k == 3:
            yield ("write", int(rng.integers(0, n_pages)))
        else:
            yield ("cow", int(rng.integers(0, n_pages)))


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_machine_matches_jax(seed):
    rng = np.random.default_rng(seed)
    st_j, st_p = jpool.init(7), pp.init(7)
    assert st_j == st_p
    raised = 0
    for ev in _pool_events(rng, 7, 300):
        st_j, st_p, r = _apply(jpool.step, pp.step, st_j, st_p, ev)
        raised += r
        assert pp.conserved(st_p) and jpool.conserved(st_j)
        assert pp.available(st_p) == jpool.available(st_j)
        assert pp.in_use(st_p) == jpool.in_use(st_j)
    assert raised > 0  # the sequence reached the error paths too


@pytest.mark.parametrize("seed", SEEDS)
def test_pagepool_matches_jax_pagepool(seed):
    """One seeded acquire/share/release sequence through both packages'
    PagePool: the same ids, free lists, refcounts and exceptions."""
    rng = np.random.default_rng(100 + seed)
    jp_, tp_ = JPagePool(9), PagePool(9)
    held = []
    for _ in range(200):
        k = int(rng.integers(3))
        if k == 0:
            n = int(rng.integers(0, 5))
            calls = (lambda p: p.acquire(n),)
        elif k == 1:
            ids = [int(rng.choice(held))] if held and rng.random() < .8 \
                else [int(rng.integers(0, 9))]
            calls = (lambda p: p.share(ids),)
        else:
            ids = [int(rng.choice(held)) for _ in range(rng.integers(1, 3))] \
                if held and rng.random() < .8 else [int(rng.integers(0, 9))]
            calls = (lambda p: p.release(ids),)
        outs = []
        for pool in (jp_, tp_):
            try:
                outs.append(("ok", calls[0](pool)))
            except (RuntimeError, ValueError) as e:
                outs.append((type(e).__name__, str(e)))
        assert outs[0] == outs[1]
        if k == 0 and outs[1][0] == "ok":
            held += outs[1][1]
        held = [i for i in held if tp_.refcount(i) > 0]
        assert tp_._free == jp_._free and tp_._refs == jp_._refs
        assert (tp_.available, tp_.in_use, tp_.logical_refs,
                tp_.has_shared) == (jp_.available, jp_.in_use,
                                    jp_.logical_refs, jp_.has_shared)
    assert tp_.proto_state() == jp_.proto_state()


def test_pagepool_runs_the_machine(monkeypatch):
    events = []
    real = pp.step

    def spy(st, ev):
        events.append(ev)
        return real(st, ev)

    monkeypatch.setattr(pp, "step", spy)
    pool = PagePool(n_pages=5)
    ids = pool.acquire(2)
    pool.share(ids[:1])
    pool.release(ids + ids[:1])
    assert events == [("acquire", 2), ("share", (ids[0],)),
                      ("release", tuple(ids + ids[:1]))]
    # the exceptions every existing `except` catches: the machine's types,
    # still RuntimeError / ValueError, importable from models.paged_decode
    with pytest.raises(PoolExhausted, match="page pool exhausted"):
        pool.acquire(9)
    with pytest.raises(PoolRefError, match="is free"):
        pool.share([1])
    assert issubclass(PoolExhausted, RuntimeError)
    assert issubclass(PoolRefError, ValueError)
    assert PoolExhausted is pp.PoolExhausted


def _frame_stream(rng, n):
    """Frames of random payloads, some corrupted: a payload bit flip (CRC
    reject), a broken magic (desync), junk; chunked at random cuts."""
    from burst_attn_tpu_torch.fleet import transport as tp

    data = b""
    for _ in range(n):
        payload = bytes(rng.integers(0, 256, int(rng.integers(1, 40)),
                                     dtype=np.uint8))
        fr = bytearray(tp.pack_frame(payload))
        u = rng.random()
        if u < 0.15:
            fr[-1] ^= 1
        elif u < 0.2:
            fr[0] ^= 0xFF
        data += bytes(fr)
    cuts = sorted(int(c) for c in rng.integers(0, len(data),
                                               int(rng.integers(1, 8))))
    chunks, prev = [], 0
    for c in cuts + [len(data)]:
        chunks.append(data[prev:c])
        prev = c
    return chunks


@pytest.mark.parametrize("seed", SEEDS)
def test_wire_and_dedup_machines_match_jax(seed):
    rng = np.random.default_rng(200 + seed)
    st_j, st_p = jwire.wire_init(), wp.wire_init()
    for chunk in _frame_stream(rng, 12):
        st_j, st_p, _ = _apply(jwire.wire_step, wp.wire_step, st_j, st_p,
                               ("feed", chunk))
    # a torn tail then EOF
    st_j, st_p, _ = _apply(jwire.wire_step, wp.wire_step, st_j, st_p,
                           ("feed", b"BAF1\x00\x00"))
    st_j, st_p, _ = _apply(jwire.wire_step, wp.wire_step, st_j, st_p,
                           ("eof",))
    assert st_p == st_j
    d_j, d_p = jwire.dedup_init(), wp.dedup_init()
    for _ in range(100):
        if rng.random() < 0.1:
            ev = ("forget", int(rng.integers(0, 3)))
        else:
            ev = ("frame", int(rng.integers(0, 3)), int(rng.integers(0, 4)))
        d_j, d_p, _ = _apply(jwire.dedup_step, wp.dedup_step, d_j, d_p, ev)
    assert wp.MAGIC == jwire.MAGIC and wp.MAX_FRAME == jwire.MAX_FRAME
    assert wp._HEADER.format == jwire._HEADER.format


def _recv_events(rng, n):
    for _ in range(n):
        k = int(rng.integers(7))
        rid = int(rng.integers(0, 3))
        if k == 0:
            yield ("begin", rid, int(rng.integers(1, 4)))
        elif k in (1, 2):
            yield ("page", rid, int(rng.integers(0, 4)))
        elif k == 3:
            yield ("abort", rid)
        elif k == 4:
            yield ("commit", rid, int(rng.integers(0, 2)))
        elif k == 5:
            yield ("retire", int(rng.integers(0, 2)))
        else:
            yield ("crash",) if rng.random() < 0.3 else ("page", rid, 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_kvtransfer_machines_match_jax(seed):
    rng = np.random.default_rng(300 + seed)
    st_j = jkv.recv_init(jpool.init(6), 2, 3)
    st_p = kvp.recv_init(pp.init(6), 2, 3)
    kinds = set()
    scripted = [("begin", 0, 2), ("page", 0, 0), ("commit", 0, 0),
                ("page", 0, 1), ("commit", 0, 0), ("begin", 1, 1),
                ("page", 1, 0), ("commit", 1, 0), ("retire", 0),
                ("commit", 1, 0), ("begin", 2, 3), ("crash",)]
    for ev in scripted + list(_recv_events(rng, 400)):
        st_j, st_p, r = _apply(jkv.recv_step, kvp.recv_step, st_j, st_p, ev)
        kinds.add((ev[0], r))
        assert pp.conserved(st_p.pool)
    assert ("commit", False) in kinds and ("commit", True) in kinds
    # the sender's hold-until-ack plan, crash included
    for n in (0, 1, 3):
        assert kvp.sender_plan(n) == jkv.sender_plan(n)
        s_j, s_p = jkv.send_init(n, (4, 5)), kvp.send_init(n, (4, 5))
        for ev in [("send",)] * (n + 1) + [("crash",), ("send",),
                                          ("ack",), ("send",)]:
            s_j, s_p, _ = _apply(jkv.send_step, kvp.send_step, s_j, s_p, ev)
            assert kvp.send_enabled(s_p) == jkv.send_enabled(s_j)
    assert kvp.PAGE_CREDIT_WINDOW == jkv.PAGE_CREDIT_WINDOW
    assert kvp.pair_members(2) == jkv.pair_members(2)


def test_kvreceiver_and_prefill_run_the_machine(monkeypatch):
    from burst_attn_tpu_torch.fleet import fleet
    from burst_attn_tpu_torch.fleet.kvplane import KvReceiver

    # the prefill worker's ship loop iterates the machine's plan
    assert "sender_plan" in inspect.getsource(fleet.prefill_main)
    rx = KvReceiver()
    with pytest.raises(KeyError, match="no kv_begin"):
        rx.add_page(4, 0, {"k": [], "v": []})
    rx.begin(4, {"n_pages": 1, "n_kv": 1, "page": 128, "d_head": 16,
                 "n_layers": 1, "length": 2, "dtype": "float32"})
    rx.add_page(4, 0, {"k": [np.zeros((1, 128, 16), np.float32)],
                       "v": [np.zeros((1, 128, 16), np.float32)]})
    assert rx.complete(4)

    class Marker(ProtocolError):
        pass

    def boom(st, rid, slot):
        raise Marker("machine seam reached")

    monkeypatch.setattr(kvp, "commit_preconditions", boom)
    cfg = ModelConfig(n_layers=1, n_kv_heads=1, n_heads=1, d_head=16,
                      dtype=torch.float32)
    state, pool = init_paged_state(cfg, slots=1, n_pages=4, page=128,
                                   max_pages_per_seq=2, device="cpu")
    with pytest.raises(Marker):
        rx.commit(4, state, pool, 0)
    assert pool.available == 3  # nothing acquired
