"""The port's KV plane and fleet policies (burst_attn_tpu_torch.fleet)
held to the JAX package's, in one process: `export_slot_pages` on pool
contents carried from JAX gives JAX's meta, `page_bytes` and
`page_digest` (fp32 and int8 pools); pages framed through the wire and
committed land byte-identical (bf16 and fp8 pools too); every refused
commit raises JAX's message and leaks zero pages; the routing / admission
/ preemption / autoscale decisions equal JAX's over seeded views; and the
policy source passes the JAX package's purity rule."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from burst_attn_tpu.analysis.policycheck import check_policy_source
from burst_attn_tpu.fleet import kvplane as jkv
from burst_attn_tpu.fleet import policy as jpol
from burst_attn_tpu.fleet import transport as jt
from burst_attn_tpu.models.paged_decode import PagePool as JPagePool
from burst_attn_tpu.models.paged_decode import PagedState as JPagedState
from burst_attn_tpu_torch.fleet import (
    FleetFault, KvReceiver, export_slot_pages, page_bytes, page_digest,
)
from burst_attn_tpu_torch.fleet import policy as pol
from burst_attn_tpu_torch.fleet import transport as tp
from burst_attn_tpu_torch.models.paged_decode import PagedState, PagePool

N_LAYERS, N_KV, PAGE, D = 2, 1, 128, 8
NP_DT = {"float32": np.float32, "int8": np.int8,
         "bfloat16": ml_dtypes.bfloat16,
         "float8_e4m3fn": ml_dtypes.float8_e4m3fn}


def _banks(seed, dtype, n_pool):
    """Per-layer K, V (and, for a 1-byte pool, scale) banks as numpy."""
    rng = np.random.default_rng(seed)
    shape = (n_pool, N_KV, PAGE, D)
    quant = dtype in ("int8", "float8_e4m3fn")

    def bank():
        x = rng.standard_normal(shape).astype(np.float32)
        if dtype == "int8":
            return rng.integers(-128, 128, shape, dtype=np.int8)
        return (x * 4).astype(NP_DT[dtype])

    k = [bank() for _ in range(N_LAYERS)]
    v = [bank() for _ in range(N_LAYERS)]
    sc = None
    if quant:
        sc = [[rng.random((n_pool, N_KV, PAGE)).astype(np.float32)
               for _ in range(N_LAYERS)] for _ in range(2)]
    return k, v, sc


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _port_state(k, v, sc, slots=2, max_pages=4):
    return PagedState(
        [_t(a) for a in k], [_t(a) for a in v],
        torch.zeros(slots, max_pages, dtype=torch.int32),
        torch.zeros(slots, dtype=torch.int32),
        [_t(a) for a in sc[0]] if sc else None,
        [_t(a) for a in sc[1]] if sc else None)


def _live(state, slot, ids, length):
    state.page_table[slot, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    state.lengths[slot] = length
    return state


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_export_equals_jax_on_carried_state(dtype):
    """The same pool contents and table row in both packages: equal meta,
    and every page's bytes and digest equal JAX's."""
    k, v, sc = _banks(1, dtype, 6)
    ids = [4, 2, 5]
    jtab = np.zeros((2, 4), np.int32)
    jtab[1, :3] = ids
    jstate = JPagedState(
        tuple(jnp.asarray(a) for a in k), tuple(jnp.asarray(a) for a in v),
        jnp.asarray(jtab), jnp.asarray(np.array([0, 300], np.int32)),
        tuple(jnp.asarray(a) for a in sc[0]) if sc else None,
        tuple(jnp.asarray(a) for a in sc[1]) if sc else None)
    pstate = _live(_port_state(k, v, sc), 1, ids, 300)
    jmeta, jpages = jkv.export_slot_pages(jstate, 1)
    pmeta, ppages = export_slot_pages(pstate, 1)
    assert pmeta == jmeta and pmeta["n_pages"] == 3
    assert [page_bytes(p) for p in ppages] == \
        [jkv.page_bytes(p) for p in jpages]
    assert [page_digest(p) for p in ppages] == \
        [jkv.page_digest(p) for p in jpages]
    # the kv_page frames each package ships are the same bytes
    for force_json in (False, True):
        for pj, pp_ in zip(jpages, ppages):
            assert tp.pack_frame(tp.encode_message(
                {"op": "kv_page", "page": pp_}, force_json=force_json)) == \
                jt.pack_frame(jt.encode_message(
                    {"op": "kv_page", "page": pj}, force_json=force_json))
    with pytest.raises(ValueError, match="not live"):
        export_slot_pages(pstate, 0)


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16",
                                   "float8_e4m3fn"])
@pytest.mark.parametrize("force_json", [False, True])
def test_wire_roundtrip_commit_byte_exact(dtype, force_json):
    """export -> real frames -> stage -> commit into another pool: the
    replica's pages byte-match the sender's (the digests too), whatever
    page ids each side holds; bf16 / fp8 digests equal JAX's digest of the
    same bits."""
    k, v, sc = _banks(2, dtype, 4)
    src = _live(_port_state(k, v, sc), 0, [3, 1], 256)
    meta, pages = export_slot_pages(src, 0)
    rx = KvReceiver()
    fr = tp.pack_frame(tp.encode_message(
        {"op": "kv_begin", "rid": 7, "meta": meta}, force_json=force_json))
    m = tp.decode_message(tp.unpack_frame(fr))
    rx.begin(m["rid"], m["meta"])
    for j, pg in enumerate(pages):
        fr = tp.pack_frame(tp.encode_message(
            {"op": "kv_page", "rid": 7, "seq": j + 1, "page": pg},
            force_json=force_json))
        m = tp.decode_message(tp.unpack_frame(fr))
        rx.add_page(m["rid"], m["seq"] - 1, m["page"])
    assert rx.complete(7)
    k2, v2, sc2 = _banks(3, dtype, 8)
    dst = _port_state(k2, v2, sc2)
    pool = PagePool(8, dtype={"int8": "int8", "float8_e4m3fn": "fp8"}.get(
        dtype))
    pool.acquire(1)  # disturb the free list: other ids than the sender's
    avail0 = pool.available
    dst = rx.commit(7, dst, pool, 1)
    assert pool.available == avail0 - 2 and rx.staging_count() == 0
    assert int(dst.lengths[1]) == 256
    meta2, pages2 = export_slot_pages(dst, 1)
    assert meta2 == meta
    assert [page_digest(p) for p in pages2] == [page_digest(p) for p in pages]
    # JAX's digest of the same page: the numpy (ml_dtypes) banks the
    # sender's pool was built from, at the pool ids its table row names
    for j, pid in enumerate([3, 1]):
        jpg = {"k": [a[pid] for a in k], "v": [a[pid] for a in v]}
        if sc:
            jpg.update(ks=[a[pid] for a in sc[0]], vs=[a[pid] for a in sc[1]])
        assert page_digest(pages[j]) == jkv.page_digest(jpg)


def test_commit_rejections_leak_zero_pages_with_jax_messages():
    """Every way a commit can be refused leaves the pool exactly as it
    was, with the JAX receiver's exception type and message."""
    k, v, _ = _banks(4, "float32", 4)
    src = _live(_port_state(k, v, None), 0, [1, 2], 256)
    meta, pages = export_slot_pages(src, 0)

    def pair(n_pool=8, quantize=None, page=PAGE, n_layers=N_LAYERS,
             live_len=0):
        """(port state, pool, JAX state, pool) of the same geometry."""
        shape = (n_pool, N_KV, page, D)
        dt = np.int8 if quantize else np.float32
        banks = [np.zeros(shape, dt) for _ in range(n_layers)]
        scales = [np.ones(shape[:3], np.float32) for _ in range(n_layers)] \
            if quantize else None
        ps = PagedState([_t(a) for a in banks], [_t(a) for a in banks],
                        torch.zeros(1, 4, dtype=torch.int32),
                        torch.tensor([live_len], dtype=torch.int32),
                        [_t(a) for a in scales] if quantize else None,
                        [_t(a) for a in scales] if quantize else None)
        js = JPagedState(tuple(jnp.asarray(a) for a in banks),
                         tuple(jnp.asarray(a) for a in banks),
                         jnp.zeros((1, 4), jnp.int32),
                         jnp.asarray(np.array([live_len], np.int32)),
                         tuple(jnp.asarray(a) for a in scales)
                         if quantize else None,
                         tuple(jnp.asarray(a) for a in scales)
                         if quantize else None)
        return ps, PagePool(n_pool, quantize), js, JPagePool(n_pool,
                                                             quantize)

    def both(stage, geometry, exc):
        rp, rj = KvReceiver(), jkv.KvReceiver()
        for rx in (rp, rj):
            stage(rx)
        ps, pp_, js, jp_ = pair(**geometry)
        a0 = pp_.available
        with pytest.raises(exc) as ep:
            rp.commit(7, ps, pp_, 0)
        with pytest.raises(exc) as ej:
            rj.commit(7, js, jp_, 0)
        assert str(ep.value) == str(ej.value)
        assert pp_.available == a0 == jp_.available  # zero leaks
        assert rp.staging_count() == rj.staging_count()
        assert rp.abort(7) == rj.abort(7)
        assert rp.staging_count() == 0
        return str(ep.value)

    def full(rx):
        rx.begin(7, meta)
        for j, pg in enumerate(pages):
            rx.add_page(7, j, pg)

    def half(rx):
        rx.begin(7, meta)
        rx.add_page(7, 0, pages[0])

    assert "incomplete" in both(half, {}, ValueError)
    assert "live" in both(full, dict(live_len=8), RuntimeError)
    assert "exhausted" in both(full, dict(n_pool=2), RuntimeError)
    assert "precision" in both(full, dict(quantize="int8"), ValueError)
    assert "layer count" in both(full, dict(n_layers=1), ValueError)
    assert "page size" in both(full, dict(page=256), ValueError)
    assert "no staging" in both(lambda rx: None, {}, KeyError)
    bad = dict(pages[0], k=[a[:, :64, :] for a in pages[0]["k"]])
    msgs = []
    for rx in (KvReceiver(), jkv.KvReceiver()):
        rx.begin(7, meta)
        with pytest.raises(ValueError) as e:
            rx.add_page(7, 0, bad)
        msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            rx.add_page(7, 0, dict(pages[0], ks=pages[0]["k"]))
        msgs.append(str(e.value))
        assert not rx.complete(7)
    assert msgs[:2] == msgs[2:] and "shape" in msgs[0]
    with pytest.raises(KeyError, match="no kv_begin"):
        KvReceiver().add_page(3, 0, pages[0])
    with pytest.raises(ValueError, match="pool"):
        FleetFault(t=0.0, pool="gpu", worker=0, kind="kill")
    with pytest.raises(ValueError):
        FleetFault(t=0.0, pool="decode", worker=0, kind="die_mid_ship")
    FleetFault(t=0.0, pool="prefill", worker=0, kind="die_mid_ship")


def _views(rng, mod):
    reps = tuple(mod.ReplicaView(
        wid=w, occ=int(rng.integers(0, 4)), staged=int(rng.integers(0, 2)),
        slots_free=int(rng.integers(0, 3)), quiet=bool(rng.random() < .4),
        templates=tuple(int(t) for t in rng.choice(5, int(rng.integers(3)),
                                                   replace=False)))
        for w in sorted(rng.choice(8, int(rng.integers(1, 6)), replace=False)))
    return mod.FleetView(replicas=reps, queue_depth=int(rng.integers(0, 3)),
                         wait_for_decode=int(rng.integers(0, 3)),
                         booting=int(rng.integers(0, 2)))


def _req(rng, mod):
    return mod.ReqView(rid=int(rng.integers(100)),
                       prompt_len=int(rng.integers(1, 300)),
                       max_new_tokens=int(rng.integers(1, 30)),
                       tenant=int(rng.integers(-1, 4)),
                       priority=int(rng.integers(0, 3)),
                       template_seed=int(rng.integers(-1, 5)),
                       overlap_len=int(rng.integers(0, 2)) * 128)


@pytest.mark.parametrize("seed", range(4))
def test_policy_decisions_equal_jax(seed):
    rj, rp = (np.random.default_rng(seed) for _ in range(2))
    params = dict(scale_up_after=2, scale_down_after=3, max_decode=6,
                  min_decode=1)
    press_j = press_p = 0
    idle_j, idle_p = {}, {}
    for _ in range(60):
        vj, vp = _views(rj, jpol), _views(rp, pol)
        qj, qp = _req(rj, jpol), _req(rp, pol)
        assert vj == vp and qj == qp
        for name in pol.ROUTE_POLICY_FUNCS.values():
            assert getattr(pol, name)(vp, qp) == getattr(jpol, name)(vj, qj)
            assert getattr(pol, name)(vp, None) == \
                getattr(jpol, name)(vj, None)
        pending = int(rj.integers(0, 4))
        rp.integers(0, 4)
        assert pol.admit_or_shed(vp, qp, pending, 2) == \
            jpol.admit_or_shed(vj, qj, pending, 2)
        waiting_j = [_req(rj, jpol) for _ in range(3)]
        waiting_p = [_req(rp, pol) for _ in range(3)]
        served = {t: int(rj.integers(0, 3)) for t in range(-1, 4)}
        {t: int(rp.integers(0, 3)) for t in range(-1, 4)}
        for name in ("next_waiting_fcfs", "next_waiting_fair_tenant"):
            assert getattr(pol, name)(waiting_p, served) == \
                getattr(jpol, name)(waiting_j, served)
        runs = [pol.RunView(rid=i, priority=int(rj.integers(0, 3)),
                            kv_tokens=int(rj.integers(0, 500)))
                for i in range(4)]
        [rp.integers(0, 3) + rp.integers(0, 500) for _ in range(4)]
        jruns = [jpol.RunView(*r) for r in runs]
        assert pol.preempt_victim(runs, qp.priority) == \
            jpol.preempt_victim(jruns, qj.priority)
        dj, press_j, idle_j = jpol.autoscale(vj, jpol.ScaleParams(**params),
                                             press_j, idle_j)
        dp, press_p, idle_p = pol.autoscale(vp, pol.ScaleParams(**params),
                                            press_p, idle_p)
        assert (dp, press_p, idle_p) == (dj, press_j, idle_j)
    assert {k: v._asdict() for k, v in pol.POLICIES.items()} == \
        {k: v._asdict() for k, v in jpol.POLICIES.items()}
    assert pol.DEFAULT_ROUTE_POLICY == jpol.DEFAULT_ROUTE_POLICY


def test_policy_source_passes_the_purity_rule():
    import burst_attn_tpu_torch.fleet.policy as mod

    with open(mod.__file__) as f:
        src = f.read()
    assert check_policy_source(src) == []
    # the rule is live: a clock read smuggled in fires
    assert check_policy_source(src + "\nimport time\n")
    assert dataclasses.is_dataclass(FleetFault)


def test_dispatch_wire_zero_cost_when_untraced():
    """The router's dispatch tuple carries the trace context only when
    tracing is on: untraced frames are the historical 4- / 5-tuples, and
    every form encodes to the JAX router's bytes."""
    from burst_attn_tpu.fleet.fleet import _dispatch_msg as jdispatch
    from burst_attn_tpu_torch.fleet.fleet import _dispatch_msg
    from burst_attn_tpu_torch.obs.trace import TraceContext

    prompt = [3, 1, 4, 1, 5]
    wire = TraceContext("fleet-1-r7-1").to_wire()
    for kw in ({}, dict(resume=[9, 9]), dict(trace_wire=wire),
               dict(resume=[9], trace_wire=wire)):
        for force_json in (False, True):
            assert tp.encode_message(_dispatch_msg(7, prompt, 4, **kw),
                                     force_json=force_json) == \
                jt.encode_message(jdispatch(7, prompt, 4, **kw),
                                  force_json=force_json)
    assert _dispatch_msg(7, prompt, 4) == ("prefill", 7, prompt, 4)
    msg = _dispatch_msg(7, prompt, 4, trace_wire=wire)
    assert len(msg) == 6 and msg[4] == []
    assert TraceContext.from_wire(msg[5]).trace_id == "fleet-1-r7-1"
