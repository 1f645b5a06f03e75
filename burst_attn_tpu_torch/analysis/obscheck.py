"""obs-jit-safe's dynamic half and the device-program purity rules (port of
burst_attn_tpu/analysis/obscheck.py: devstats-pure, ckpt-jit-safe,
pipe-fused-pure, pipe-tick-identity).

The JAX rules walk traced jaxprs for host-callback and collective
primitives.  On the port the same hazards are a host read inside a step
(an `.item()`, an `int(t)`, a `.tolist()`, a data-dependent shape: each
waits for the device) and, in a captured CUDA graph, a host node, a
host-device or peer copy or a collective.  Each rule has two halves:

  CPU   the real function runs under analysis/opstream.py's recorder and
        its op stream must hold no host read (and, where the rule says
        so, no collective and no copy across devices), or must equal a
        reference stream op for op;
  card  the same code runs on the card under
        `torch.cuda.set_sync_debug_mode("error")` (a synchronizing op
        raises) and, where JAX traces a program, is captured in a CUDA
        graph whose nodes are listed through the CUDA driver API
        (`graph_census`): a capture that fails is the finding.

  obs-jit-safe        the plain burst_attn forward and backward make no
                      host read (astlint.py carries the AST half);
  devstats-pure       burst_attn(collect_stats=True) forward and backward
                      make no host read on the scan and the fused routes,
                      and the collect_stats=False stream equals that of the
                      entry without stats (`_fwd_impl(collect=False)`,
                      `_BurstAttn` with no sink) op for op — on the card
                      with equal kernel launch counts;
  ckpt-jit-safe       ragged_model_step (dense, ragged) and
                      paged_decode_step make no host read; on the card
                      each is captured in a CUDA graph;
  pipe-fused-pure     multi_step_decode at k=4 (dense, ragged) makes no
                      host read and issues no collective; on the card the
                      DecodeGraphs graph holds only kernel, memset and
                      device-to-device copy nodes, and its kernel 7 nodes
                      equal the launches its capture counted;
  pipe-tick-identity  the K=1 body (serving/model.py `_decode_ticks`)
                      records the synchronous tick's stream
                      (ragged_model_step + sample_logits(nan_sentinel=
                      True)), greedy and sampled; on the card the K=1
                      graph's replay gives the eager tick's choices,
                      lengths and generator state, and the same kernels.
"""

import contextlib
import ctypes
import inspect
from typing import Dict, List, Sequence

import torch

from . import opstream
from .core import Finding, rule

rule("devstats-pure", "trace",
     "stats-enabled ring fwd/bwd make no host read; the stats-off stream "
     "equals the entry without stats op for op")(None)
rule("ckpt-jit-safe", "trace",
     "serve-step programs (ragged_model_step / paged_decode_step) make no "
     "host read and capture in a CUDA graph — checkpoint/journal writes "
     "stay at the host dispatch boundary")(None)
rule("pipe-fused-pure", "trace",
     "the fused multi-step decode (pipelined engine) makes no host read "
     "and no collective; its CUDA graph holds no host, host-device, peer "
     "or collective node")(None)
rule("pipe-tick-identity", "trace",
     "the K=1 pipelined tick records the synchronous engine tick's op "
     "stream (model step + sample) and replays to its choices — "
     "pipelining moves WHEN readback happens, never WHAT is computed")(None)

CARD_RULES = {
    f"{r} (card half)": "needs the CUDA card (sync-debug runs, CUDA graph "
                        "captures and their node census); run `python -m "
                        "burst_attn_tpu_torch.analysis --card` there"
    for r in ("obs-jit-safe", "devstats-pure", "ckpt-jit-safe",
              "pipe-fused-pure", "pipe-tick-identity")}


def _anchor(fn):
    try:
        return inspect.getsourcefile(fn), inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):
        return "<trace>", 0


def check_host_reads(stream: Sequence[opstream.OpEvent], *, where: str,
                     anchor, rule_name: str = "obs-jit-safe"
                     ) -> List[Finding]:
    """Flag every host read and data-dependent shape of one stream."""
    path, line = anchor
    return [Finding(
        rule=rule_name, file=path, line=line,
        message=f"{where}: {e.format()} "
                + ("reads a tensor's values on the host"
                   if e.host_read else "has a data-dependent shape")
                + " — a device-to-host wait per executed step; it must "
                  "stay at the host dispatch boundary")
        for e in stream if e.host_read or e.data_dependent]


def check_collective_free(stream: Sequence[opstream.OpEvent], *, where: str,
                          anchor, rule_name: str = "pipe-fused-pure"
                          ) -> List[Finding]:
    """Flag every collective and every copy across devices of a stream
    that must be a purely local device program."""
    path, line = anchor
    out = []
    for e in stream:
        if e.collective is not None or e.cross_device:
            what = (f"collective {e.collective}" if e.collective is not None
                    else f"copy across devices {e.format()}")
            out.append(Finding(
                rule=rule_name, file=path, line=line,
                message=f"{where}: {what} inside the decode program — the "
                        "fused launch must be a purely local device "
                        "program (no wire traffic hidden inside it)"))
    return out


def check_identity(got: Sequence[opstream.OpEvent],
                   want: Sequence[opstream.OpEvent], *, rule_name: str,
                   anchor, what: str) -> List[Finding]:
    """One finding when two streams differ, naming the first op where."""
    a = [e.signature() for e in got]
    b = [e.signature() for e in want]
    i = opstream.first_divergence(a, b)
    if i is None:
        return []
    path, line = anchor

    def at(s):
        return s[i].format() if i < len(s) else "<end of stream>"

    return [Finding(
        rule=rule_name, file=path, line=line,
        message=f"{what}: the streams diverge at op {i} ({len(a)} vs "
                f"{len(b)} ops): {at(got)} vs {at(want)}")]


def check_off_identity(stream_off, stream_plain, *, anchor,
                       what="collect_stats=False stream vs the entry "
                            "without stats") -> List[Finding]:
    """devstats-pure half 2: the stats-off stream equals the plain one."""
    return check_identity(stream_off, stream_plain, rule_name="devstats-pure",
                          anchor=anchor, what=what)


# ---------------------------------------------------------------------------
# the ring entries

RING_W = 4
RING_DIMS = {"cpu": dict(b=1, n=2, s=16, d=8),
             "cuda": dict(b=1, n=2, s=128, d=128)}


def _ring_leaves(device, seed=0):
    dims = RING_DIMS[torch.device(device).type]
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(dims["b"], dims["n"], dims["s"] * RING_W, dims["d"],
                        generator=g).to(device=device, dtype=torch.bfloat16)
            for _ in range(3)]


def _grad_leaves(qkv):
    return [t.detach().clone().requires_grad_() for t in qkv]


def _entry_run(entry, qkv, backend, collect_stats, grad=True):
    """Forward (and backward) of `entry` (burst_attn or a stand-in with
    its signature) on fresh leaves."""
    q, k, v = _grad_leaves(qkv) if grad else qkv
    out = entry(q, k, v, mesh={"sp": RING_W}, causal=True, layout="zigzag",
                backend=backend, collect_stats=collect_stats)
    o = out[0] if collect_stats else out
    if grad:
        o.float().sum().backward()
    return out


def _plain_run(qkv, backend, grad=True):
    """The entry without stats: `_BurstAttn` with no sink (grad) or
    `_fwd_impl(collect=False)` (no grad), on the cfg burst_attn builds."""
    from ..parallel import burst
    from ..parallel.mesh import shard, unshard

    cfg = burst.BurstConfig(causal=True, layout="zigzag", intra_axis="sp",
                            backend=backend,
                            mesh_axes=(("sp", RING_W),))
    if grad:
        q, k, v = _grad_leaves(qkv)
        o = burst._BurstAttn.apply(q, k, v, cfg, 1, RING_W, None, None)
        o.float().sum().backward()
        return o
    q, k, v = qkv
    return unshard(burst._fwd_impl(shard(q, RING_W), shard(k, RING_W),
                                   shard(v, RING_W), cfg, 1, RING_W,
                                   collect=False)[0])


def check_ring_purity(device="cpu", entry=None,
                      backends=("jnp", "fused_ring")) -> List[Finding]:
    """obs-jit-safe (plain forward + backward) and devstats-pure (stats
    on: no host read; stats off: the plain entry's stream) on `device`.
    `entry` substitutes burst_attn (the mutation seam)."""
    from ..parallel import burst

    entry = entry or burst.burst_attn
    qkv = _ring_leaves(device)
    anchor_b = _anchor(burst.burst_attn)
    findings: List[Finding] = []
    with opstream.record() as st:
        _entry_run(entry, qkv, backends[0], False)
    findings += check_host_reads(st, where="burst_attn fwd+bwd",
                                 anchor=anchor_b, rule_name="obs-jit-safe")
    for backend in backends:
        with opstream.record() as st:
            _entry_run(entry, qkv, backend, True)
        findings += check_host_reads(
            st, where=f"burst_attn fwd+bwd (collect_stats=True, {backend})",
            anchor=anchor_b, rule_name="devstats-pure")
        for grad in (True, False):
            ctx = contextlib.nullcontext() if grad else torch.no_grad()
            with ctx, opstream.record() as off:
                _entry_run(entry, qkv, backend, False, grad=grad)
            with ctx, opstream.record() as plain:
                _plain_run(qkv, backend, grad=grad)
            findings += check_off_identity(
                off, plain, anchor=anchor_b,
                what=f"burst_attn collect_stats=False ({backend}, "
                     f"{'fwd+bwd' if grad else 'fwd'}) vs the entry "
                     "without stats")
    return findings


# ---------------------------------------------------------------------------
# the serve steps

def serve_setup(device="cpu", seed=0):
    """A tiny serving model: (params, cfg).  The card's takes kernel 7's
    head dim and the serving dtype."""
    from ..models.transformer import ModelConfig, init_params

    if torch.device(device).type == "cuda":
        cfg = ModelConfig(vocab=256, d_model=256, n_layers=1, n_heads=2,
                          n_kv_heads=1, d_head=128, d_ff=512,
                          dtype=torch.bfloat16)
    else:
        cfg = ModelConfig(vocab=97, d_model=16, n_layers=1, n_heads=2,
                          n_kv_heads=1, d_head=8, d_ff=32,
                          dtype=torch.float32)
    return init_params(cfg, seed, device=device), cfg


def fresh_state(cfg, device):
    """A paged state with two live slots: one at 5 tokens on one page, one
    at 130 on two (past the first page boundary)."""
    from ..models.paged_decode import init_paged_state, write_table_row

    state, _ = init_paged_state(cfg, slots=2, n_pages=4, page=128,
                                max_pages_per_seq=2, device=device)
    write_table_row(state, 0, [1])
    write_table_row(state, 1, [2, 3])
    state.lengths.copy_(torch.tensor([5, 130], dtype=torch.int32))
    return state


def _steps(params, cfg, device):
    """(where, anchor fn, call on a state) of the checkpointed serve
    steps."""
    from ..models.paged_decode import paged_decode_step
    from ..serving import model as sm

    toks2 = torch.zeros((2, 8), dtype=torch.long, device=device)
    qlens = torch.ones(2, dtype=torch.int32, device=device)
    toks1 = torch.zeros(2, dtype=torch.long, device=device)
    out = [(f"ragged_model_step (attn={a})", sm.ragged_model_step,
            lambda st, a=a: sm.ragged_model_step(params, toks2, qlens, st,
                                                 cfg, attn=a))
           for a in ("dense", "ragged")]
    out.append(("paged_decode_step", paged_decode_step,
                lambda st: paged_decode_step(params, toks1, st, cfg)))
    return out


def check_serve_steps(device="cpu") -> List[Finding]:
    """ckpt-jit-safe, pipe-fused-pure and pipe-tick-identity's CPU
    halves (the recorded streams)."""
    from ..serving import model as sm

    params, cfg = serve_setup(device)
    findings: List[Finding] = []
    for where, fn, call in _steps(params, cfg, device):
        with opstream.record() as st:
            call(fresh_state(cfg, device))
        findings += check_host_reads(st, where=where, anchor=_anchor(fn),
                                     rule_name="ckpt-jit-safe")
    first = torch.zeros(2, dtype=torch.long, device=device)
    qlens = torch.ones(2, dtype=torch.int32, device=device)
    anchor_ms = _anchor(sm.multi_step_decode)
    for attn in ("dense", "ragged"):
        where = f"multi_step_decode (k=4, attn={attn})"
        with opstream.record() as st:
            sm.multi_step_decode(params, first, qlens,
                                 fresh_state(cfg, device),
                                 torch.Generator(device).manual_seed(0),
                                 cfg, k=4, attn=attn)
        findings += check_host_reads(st, where=where, anchor=anchor_ms,
                                     rule_name="pipe-fused-pure")
        findings += check_collective_free(st, where=where, anchor=anchor_ms)
    findings += check_tick_identity(params, cfg, device)
    return findings


def _sync_tick(params, toks, q_lens, state, rng, cfg, temperature):
    """The synchronous engine's tick on the K=1 feed: ragged_model_step +
    sample_logits(nan_sentinel=True), as one [1, slots] launch result."""
    from ..models.decode import sample_logits
    from ..serving import model as sm

    logits, _ = sm.ragged_model_step(params, toks[:, None], q_lens, state,
                                     cfg, attn="ragged")
    choice = sample_logits(logits, rng, temperature=temperature, top_k=None,
                           top_p=None, nan_sentinel=True)
    return torch.stack([choice])


def check_tick_identity(params, cfg, device="cpu", body=None
                        ) -> List[Finding]:
    """pipe-tick-identity's CPU half: the K=1 body's stream equals the
    synchronous tick's, greedy and sampled.  `body` substitutes
    serving/model.py's `_decode_ticks` (the mutation seam)."""
    from ..serving import model as sm

    body = body or sm._decode_ticks
    toks = torch.tensor([3, 7], dtype=torch.long, device=device)
    qlens = torch.ones(2, dtype=torch.int32, device=device)
    findings: List[Finding] = []
    for temperature in (0.0, 0.8):
        streams = []
        for fn in (lambda st, g: body(params, toks, qlens, st, g, cfg, 1,
                                      "ragged", temperature, None, None),
                   lambda st, g: _sync_tick(params, toks, qlens, st, g, cfg,
                                            temperature)):
            state = fresh_state(cfg, device)
            gen = torch.Generator(device).manual_seed(5)
            with opstream.record() as st:
                fn(state, gen)
            streams.append(st)
        findings += check_identity(
            streams[0], streams[1], rule_name="pipe-tick-identity",
            anchor=_anchor(sm._decode_ticks),
            what=f"K=1 pipelined body vs the synchronous tick "
                 f"(temperature {temperature})")
    return findings


def check_all() -> List[Finding]:
    return check_ring_purity("cpu") + check_serve_steps("cpu")


# ---------------------------------------------------------------------------
# the card half

@contextlib.contextmanager
def sync_errors():
    """Every synchronizing op inside the block raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _package_frame(exc) -> str:
    """The innermost frame of the port (outside analysis/) in exc's
    traceback: where the synchronizing op was issued."""
    import os
    import traceback

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f.filename.startswith(pkg)
              and os.sep + "analysis" + os.sep not in f.filename]
    if not frames:
        return "outside the package"
    f = frames[-1]
    return f"{os.path.relpath(f.filename, pkg)}:{f.lineno} `{f.line}`"


def sync_checked(fn, *, where, anchor, rule_name):
    """Run fn() recorded under sync_errors(): (result, findings).  A
    synchronizing op is a finding (its RuntimeError, located at the
    port's innermost frame), as is a host read or a device-to-host copy
    in the stream."""
    path, line = anchor
    try:
        with sync_errors(), opstream.record() as st:
            out = fn()
    except RuntimeError as e:
        return None, [Finding(rule=rule_name, file=path, line=line,
                              message=f"{where}: synchronized with the "
                                      f"host under sync-debug 'error' at "
                                      f"{_package_frame(e)}: {e}")]
    findings = check_host_reads(st, where=where, anchor=anchor,
                                rule_name=rule_name)
    findings += [Finding(rule=rule_name, file=path, line=line,
                         message=f"{where}: {e.format()} copies the device "
                                 "to the host inside the step")
                 for e in st.cross_device()
                 if e.outputs and e.outputs[0][2] == "cpu"]
    return out, findings


# the CUDA driver API's CUgraphNodeType and CUmemorytype values (cuda.h)
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty", 6: "wait_event", 7: "event_record",
               8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}
_MEM_HOST, _MEM_DEVICE, _MEM_UNIFIED = 1, 2, 4
_PTR_MEMORY_TYPE, _PTR_DEVICE_ORDINAL = 2, 9
# CUDA_MEMCPY3D: the byte offsets of srcMemoryType, srcHost, srcDevice
# and of dstMemoryType, dstHost, dstDevice
_SRC_OFF, _DST_OFF = (32, 40, 48), (120, 128, 136)
_DRIVER = []


def _driver():
    if not _DRIVER:
        drv = ctypes.CDLL("libcuda.so.1")
        V, P = ctypes.c_void_p, ctypes.POINTER
        for name, args in (
                ("cuGraphGetNodes", [V, V, P(ctypes.c_size_t)]),
                ("cuGraphNodeGetType", [V, P(ctypes.c_int)]),
                ("cuGraphKernelNodeGetParams", [V, V]),
                ("cuFuncGetName", [P(ctypes.c_char_p), V]),
                ("cuGraphMemcpyNodeGetParams", [V, V]),
                ("cuPointerGetAttribute", [V, ctypes.c_int,
                                           ctypes.c_uint64])):
            getattr(drv, name).argtypes = args
            getattr(drv, name).restype = ctypes.c_int
        _DRIVER.append(drv)
    return _DRIVER[0]


def _ck(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA driver error {err}")


def _endpoint(drv, buf, offs):
    """(memory type, device ordinal) of one end of a memcpy node."""
    mtype = ctypes.c_int.from_buffer(buf, offs[0]).value
    host = ctypes.c_uint64.from_buffer(buf, offs[1]).value
    dptr = ctypes.c_uint64.from_buffer(buf, offs[2]).value
    ptr = host if mtype == _MEM_HOST else dptr
    if mtype == _MEM_UNIFIED:
        t = ctypes.c_uint()
        _ck(drv.cuPointerGetAttribute(ctypes.byref(t), _PTR_MEMORY_TYPE,
                                      ptr), "cuPointerGetAttribute")
        mtype = t.value
    ordinal = -1
    if mtype == _MEM_DEVICE:
        o = ctypes.c_int()
        _ck(drv.cuPointerGetAttribute(ctypes.byref(o), _PTR_DEVICE_ORDINAL,
                                      ptr), "cuPointerGetAttribute")
        ordinal = o.value
    return mtype, ordinal


def graph_census(graph) -> Dict[str, object]:
    """The nodes of a captured torch.cuda.CUDAGraph (built with
    keep_graph=True), through the CUDA driver API: {"kernels": [names in
    node order], "memset": n, "memcpy": {"dtod": n, "htod": n, "dtoh": n,
    "htoh": n, "peer": n}, "other": {node type: n}}."""
    drv = _driver()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _ck(drv.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _ck(drv.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = {"kernels": [], "memset": 0,
           "memcpy": dict.fromkeys(("dtod", "htod", "dtoh", "htoh", "peer"),
                                   0),
           "other": {}}
    for node in nodes:
        t = ctypes.c_int()
        _ck(drv.cuGraphNodeGetType(node, ctypes.byref(t)),
            "cuGraphNodeGetType")
        kind = _NODE_TYPES.get(t.value, f"type {t.value}")
        if kind == "kernel":
            buf = (ctypes.c_char * 256)()
            _ck(drv.cuGraphKernelNodeGetParams(node, buf),
                "cuGraphKernelNodeGetParams")
            func = ctypes.c_void_p.from_buffer(buf, 0)
            name = ctypes.c_char_p()
            _ck(drv.cuFuncGetName(ctypes.byref(name), func), "cuFuncGetName")
            out["kernels"].append(name.value.decode())
        elif kind == "memset":
            out["memset"] += 1
        elif kind == "memcpy":
            buf = (ctypes.c_char * 256)()
            _ck(drv.cuGraphMemcpyNodeGetParams(node, buf),
                "cuGraphMemcpyNodeGetParams")
            (st, so), (dt, do) = (_endpoint(drv, buf, _SRC_OFF),
                                  _endpoint(drv, buf, _DST_OFF))
            if st == dt == _MEM_DEVICE:
                key = "dtod" if so == do else "peer"
            else:
                key = ("h" if st == _MEM_HOST else "d") + "to" + (
                    "h" if dt == _MEM_HOST else "d")
            out["memcpy"][key] += 1
        else:
            out["other"][kind] = out["other"].get(kind, 0) + 1
    return out


def census_findings(census, *, where, anchor, rule_name) -> List[Finding]:
    """A captured device program holds kernel, memset and device-to-device
    copy nodes only: no host node, host-device or peer copy, collective
    kernel or any other node."""
    path, line = anchor
    bad = {k: v for k, v in census["memcpy"].items() if v and k != "dtod"}
    bad.update(census["other"])
    nccl = [k for k in census["kernels"] if "nccl" in k.lower()]
    if nccl:
        bad["nccl kernels"] = len(nccl)
    if not census["kernels"]:
        bad["no kernel node at all"] = 0
    if not bad:
        return []
    return [Finding(rule=rule_name, file=path, line=line,
                    message=f"{where}: the captured graph holds {bad} — a "
                            "device program must be kernels, memsets and "
                            "device-to-device copies only")]


def capture(fn, stream):
    """Capture fn() into a kept CUDA graph on `stream` (warmed there
    first): (graph, fn's output in the graph's memory)."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # the warm-up: libraries, workspaces, per-stream scratch
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    graph.instantiate()
    return graph, out


def _launch_counts():
    from ..ops import flash, fused_ring, fused_ring_bwd

    return (flash.flash_fwd.launches, dict(flash.flash_bwd.launches),
            fused_ring.fused_ring_fwd.launches,
            fused_ring_bwd.fused_ring_bwd.launches)


def _counted(fn):
    before = _launch_counts()
    fn()
    after = _launch_counts()
    return (after[0] - before[0],
            {k: after[1][k] - before[1][k] for k in after[1]},
            after[2] - before[2], after[3] - before[3])


def check_ring_card(entry=None) -> List[Finding]:
    """obs-jit-safe and devstats-pure on the card: the scan route (kernels
    1-5 a round) and the fused route (kernels 8 and 9), stats on and off,
    under sync_errors(); the stats-off run's stream and kernel launches
    equal the entry without stats'."""
    from ..parallel import burst

    entry = entry or burst.burst_attn
    qkv = _ring_leaves("cuda")
    anchor = _anchor(burst.burst_attn)
    findings: List[Finding] = []
    for backend in ("auto", "fused_ring"):
        for stats in (False, True):  # the warm-up: plans, libraries
            _entry_run(entry, qkv, backend, stats)
        torch.cuda.synchronize()
        for stats, name in ((False, "obs-jit-safe"), (True, "devstats-pure")):
            _, f = sync_checked(
                lambda: _entry_run(entry, qkv, backend, stats),
                where=f"burst_attn fwd+bwd ({backend}, collect_stats="
                      f"{stats})", anchor=anchor, rule_name=name)
            findings += f
        torch.cuda.synchronize()
        with opstream.record() as off:
            n_off = _counted(lambda: _entry_run(entry, qkv, backend, False))
        with opstream.record() as plain:
            n_plain = _counted(lambda: _plain_run(qkv, backend))
        findings += check_off_identity(
            off, plain, anchor=anchor,
            what=f"burst_attn collect_stats=False ({backend}, fwd+bwd, "
                 "cuda) vs the entry without stats")
        if n_off != n_plain:
            findings.append(Finding(
                rule="devstats-pure", file=anchor[0], line=anchor[1],
                message=f"{backend}: kernel launches (flash_fwd, flash_bwd, "
                        f"fused_ring_fwd, fused_ring_bwd) with stats off "
                        f"{n_off} != the entry without stats {n_plain}"))
        if backend == "fused_ring" and (n_off[2] == 0 or n_off[3] == 0):
            findings.append(Finding(
                rule="devstats-pure", file=anchor[0], line=anchor[1],
                message=f"the fused route launched kernels 8/9 {n_off[2]}/"
                        f"{n_off[3]} times: the check did not run it"))
    return findings


def check_steps_card() -> List[Finding]:
    """ckpt-jit-safe on the card: each serve step eager under
    sync_errors(), then captured in a CUDA graph and its nodes listed."""
    params, cfg = serve_setup("cuda")
    stream = torch.cuda.Stream()
    findings: List[Finding] = []
    for where, fn, call in _steps(params, cfg, "cuda"):
        anchor = _anchor(fn)
        state = fresh_state(cfg, "cuda")
        call(state)  # the warm-up
        torch.cuda.synchronize()
        findings += sync_checked(lambda: call(state), where=where,
                                  anchor=anchor,
                                  rule_name="ckpt-jit-safe")[1]
        try:
            graph, _ = capture(lambda: call(state), stream)
        except RuntimeError as e:
            findings.append(Finding(
                rule="ckpt-jit-safe", file=anchor[0], line=anchor[1],
                message=f"{where}: CUDA graph capture failed: {e}"))
            continue
        findings += census_findings(graph_census(graph), where=where,
                                    anchor=anchor, rule_name="ckpt-jit-safe")
    return findings


def check_decode_graphs_card() -> List[Finding]:
    """pipe-fused-pure on the card: the k=4 DecodeGraphs graph (dense,
    ragged): a replay under sync_errors(), its node census, its kernel 7
    nodes against the launches the capture counted."""
    from ..serving import model as sm

    params, cfg = serve_setup("cuda")
    anchor = _anchor(sm.multi_step_decode)
    findings: List[Finding] = []
    first = torch.tensor([3, 7], dtype=torch.long, device="cuda")
    qlens = torch.ones(2, dtype=torch.int32, device="cuda")
    for attn in ("dense", "ragged"):
        where = f"DecodeGraphs (k=4, attn={attn})"
        state = fresh_state(cfg, "cuda")
        gen = torch.Generator("cuda").manual_seed(0)
        graphs = sm.DecodeGraphs(params, state, cfg, gen)
        kw = dict(k=4, attn=attn, temperature=0.0, top_k=None, top_p=None)
        try:
            graphs.replay(first, qlens, **kw)  # captures
            torch.cuda.synchronize()
        except RuntimeError as e:
            findings.append(Finding(
                rule="pipe-fused-pure", file=anchor[0], line=anchor[1],
                message=f"{where}: CUDA graph capture failed at "
                        f"{_package_frame(e)}: {e}"))
            continue
        findings += sync_checked(lambda: graphs.replay(first, qlens, **kw),
                                  where=where, anchor=anchor,
                                  rule_name="pipe-fused-pure")[1]
        key = (4, attn, 0.0, None, None)
        census = graph_census(graphs._graphs[key].graph)
        findings += census_findings(census, where=where, anchor=anchor,
                                    rule_name="pipe-fused-pure")
        k7 = sum("ragged_kernel" in k for k in census["kernels"])
        if k7 != graphs._graphs[key].launches:
            findings.append(Finding(
                rule="pipe-fused-pure", file=anchor[0], line=anchor[1],
                message=f"{where}: {k7} kernel 7 nodes in the graph, "
                        f"{graphs._graphs[key].launches} launches counted "
                        "at its capture"))
    return findings


SPIN = "spin_kernel"  # torch.cuda._sleep's kernel: the window's fences


def _cuda_kernels(fn) -> List[str]:
    """Names of the CUDA kernels fn() runs eagerly, in start order
    (profiler).  In a process that profiled before, the profiler can miss
    the first few dozen kernels of a window: fn runs after 256 small
    kernels and between two spin kernels, and only what lies between the
    spins is returned (None when the profiler lost a fence)."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            pad.add_(1)
        torch.cuda._sleep(1000)
        fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset"))),
                 key=lambda e: e.time_range.start)
    names = [e.name for e in evs]
    fences = [i for i, n in enumerate(names) if SPIN in n]
    if len(fences) != 2:
        return None
    return names[fences[0] + 1:fences[1]]


def demangle(name: str) -> str:
    """A kernel's mangled symbol as the profiler names it (libstdc++'s
    __cxa_demangle); the symbol itself when it does not demangle."""
    if not _DEMANGLE:
        lib = ctypes.CDLL("libstdc++.so.6")
        fn = lib.__cxa_demangle
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int)]
        free = ctypes.CDLL(None).free
        free.argtypes = [ctypes.c_void_p]
        _DEMANGLE.extend((fn, free))
    fn, free = _DEMANGLE
    status = ctypes.c_int()
    ptr = fn(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not ptr:
        return name
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        free(ptr)


_DEMANGLE: list = []


def _same_kernels(a: List[str], b: List[str]) -> bool:
    return [k.replace(" ", "") for k in a] == [k.replace(" ", "")
                                               for k in b]


def check_tick_card() -> List[Finding]:
    """pipe-tick-identity on the card: the K=1 body (`_decode_ticks`)
    replayed from its DecodeGraphs graph and run eagerly, from twin states
    and generators, gives the same choices, lengths and generator state,
    three ticks in turn; the graph's kernel nodes (`graph_census`, in
    capture order) are the kernels the eager body runs (profiler)."""
    from ..serving import model as sm

    params, cfg = serve_setup("cuda")
    anchor = _anchor(sm._decode_ticks)
    toks = torch.tensor([3, 7], dtype=torch.long, device="cuda")
    qlens = torch.ones(2, dtype=torch.int32, device="cuda")
    findings: List[Finding] = []

    def bad(msg):
        findings.append(Finding(rule="pipe-tick-identity", file=anchor[0],
                                line=anchor[1], message=msg))

    for temperature in (0.0, 0.8):
        kw = dict(temperature=temperature, top_k=None, top_p=None)
        st_e, st_g = fresh_state(cfg, "cuda"), fresh_state(cfg, "cuda")
        gen_e = torch.Generator("cuda").manual_seed(5)
        gen_g = torch.Generator("cuda").manual_seed(5)
        graphs = sm.DecodeGraphs(params, st_g, cfg, gen_g)

        def graph_tick():
            return graphs.replay(toks, qlens, k=1, attn="ragged",
                                 **kw).clone()

        def eager_tick():
            return sm._decode_ticks(params, toks, qlens, st_e, gen_e, cfg,
                                    1, "ragged", temperature, None, None)

        eager_kernels, captured_ok = [], True
        for turn in range(3):
            what = f"temperature {temperature}, tick {turn}"
            try:
                got = graph_tick()  # the first turn captures
            except RuntimeError as e:
                bad(f"{what}: the K=1 capture failed at "
                    f"{_package_frame(e)}: {e}")
                captured_ok = False
                break
            if turn == 2:
                out = []
                eager_kernels = _cuda_kernels(
                    lambda: out.append(eager_tick()))
                want = out[0]
            else:
                want = eager_tick()
            if not torch.equal(got, want):
                bad(f"{what}: choices {got.tolist()} (K=1 graph) vs "
                    f"{want.tolist()} (eager)")
            if not torch.equal(st_e.lengths, st_g.lengths):
                bad(f"{what}: lengths {st_g.lengths.tolist()} vs "
                    f"{st_e.lengths.tolist()}")
            if not torch.equal(gen_e.get_state(), gen_g.get_state()):
                bad(f"{what}: the generator state after the K=1 replay "
                    "differs from the eager body's")
        if not captured_ok:
            continue
        if eager_kernels is None:
            bad(f"temperature {temperature}: the profiler lost a fence of "
                "the eager body's window")
            continue
        key = (1, "ragged", temperature, None, None)
        captured = [demangle(k) for k in
                    graph_census(graphs._graphs[key].graph)["kernels"]]
        if not captured or not _same_kernels(captured, eager_kernels):
            i = opstream.first_divergence(captured, eager_kernels)
            at = [k[i] if i < len(k) else "<end>"
                  for k in (captured, eager_kernels)]
            bad(f"temperature {temperature}: the K=1 graph's "
                f"{len(captured)} kernels differ from the eager body's "
                f"{len(eager_kernels)} at kernel {i}: {at[0]} vs {at[1]}")
    return findings


def check_card() -> List[Finding]:
    return (check_ring_card() + check_steps_card()
            + check_decode_graphs_card() + check_tick_card())
