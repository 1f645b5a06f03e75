"""Time the port's attention kernels of one checkout on the card, for an
A/B of two commits in one call.

    python tools/kernel_ab.py --root PATH --tag NAME [--parts fwd,bwd,...]

imports `burst_attn_tpu_torch` from the checkout at PATH (its kernels
build into PATH/build/kernels), times kernel 1 (causal, B1 N16/4 S2048,
plain and with window 1024, and B1 N16 S8192, bf16), the fused backward
(kernels 2-3) and the split pair (kernels 4-5, each kernel's device time
from the profiler) at B1 N16 S8192 bf16 causal and at a scan-ring round's
shape (B1 N16 S2048, causal and full), kernel 6 (8 slots, lengths 0-2112,
bf16 and int8 pools,
and bf16 with window 1024) and kernel 7 (the mixed q_lens 0/1/37/128
batch, bf16, plain and with window 1024) with CUDA events on seeded
inputs, and prints one line `AB {json}` with the card.  Kernels 6 and 7
run for microseconds, less than their wrappers take on the host, so
their `*_ms` are device times per call from a CUDA graph of 20 calls
replayed between CUDA events, and `*_eager_ms` times eager calls (host
included).  `micro` times kernel 7 on single-block cases (bf16, G 1,
one kv head, d 128, page 128; device time per call, as above): one
64-row block against 1 or 8 chunks of 64 positions alone on the card,
264 and 528 such blocks at once, one decode slot of 512 positions (2
splits) and of 64, one 64-row block at 2048 positions (4 splits
merged).  `grid` (a checkout whose kernel 7 records its CTAs) times
the traced launch of the mixed batch, plain and with window 1024, and
reports its grid: CTAs, those that ran each tile and those that exited
at once, their %globaltimer spans (median, max) and SM cycles a chunk,
the launch's span; beside it torch.profiler's device time of kernel 7
and of SDPA on the gathered band (the smoke's windowed yardstick), per
kernel.  `ring` times the fused ring kernels 8 and 9 (bf16, causal
zigzag) at bench.py's headline (B1 N32 S65536 D128, sp=8) and at the
ring train step's shape (train_smoke's model, B1 N16 S8192 over sp=4),
one eager launch at a time, kernel 9 on kernel 8's o and lse.  `trace`
(a checkout whose kernel 9 records its CTAs) times a traced kernel-9
launch at both shapes and reports, over the CTAs, the share of their
span spent waiting on dq fold counters and on the ring's counters, with
each kernel's registers and spill bytes (cudaFuncGetAttributes).
`fwd` and `bwd` also report kernels 1-5's registers and spill bytes
where the checkout has `flash.fwd_attrs`.  `sass` builds every kernel
library of the checkout and reports a digest of each kernel's SASS
(`cuobjdump -sass`, the source's anonymous-namespace tag taken out of the
names): equal digests in the parent's and the change's lines mean the
kernel's code did not move.  `split_step` times chip_smoke.py's train
step through the split backward (train_smoke's model, B1 S8192 bf16,
seed-0 weights; the checkout's chip_smoke.py supplies the model, so a
parent unpacked for it needs that file beside its package).  `bounds`
builds kernel 4's bf16 instance twice from the checkout's csrc/, as it
is and with its launch bounds' minimum of two CTAs an SM taken out,
and reports each build's registers and spill (ptxas) and time.
`--parts` picks among fwd, bwd, decode, ragged, micro, grid, ring,
trace, sass, split_step and bounds.  `--fwd-tile simt` builds kernel 8's bf16 instance on the SIMT
tile (FUSED_FWD_TILE_SIMT=1, a checkout that has the switch).  Run it
from a parent
and a change in turns (parent, change, change, parent): times of two
calls may come from two cards.  It uses only arguments that every port
checkout since the sliding window takes, and builds only the kernel
sources that the
checkout's `_build.SIGNATURES` lists (paged decode has its own source in
a checkout before it became the ragged kernel's QT=1 instance).
"""

import argparse
import json
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--parts", default="fwd,bwd,decode,ragged")
    ap.add_argument("--fwd-tile", choices=("default", "simt"),
                    default="default")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    from burst_attn_tpu_torch.ops import _build, flash, masks
    from burst_attn_tpu_torch.ops import paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    parts = set(args.parts.split(","))
    if args.fwd_tile == "simt":
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DFUSED_FWD_TILE_SIMT=1",)
    _build.build_all(list(dict.fromkeys(name for part, name in (
        ("fwd", "flash_fwd"), ("bwd", "flash_fwd"), ("bwd", "flash_bwd"),
        ("decode", "paged_decode"), ("decode", "ragged_paged"),
        ("ragged", "ragged_paged"), ("micro", "ragged_paged"),
        ("grid", "ragged_paged"), ("ring", "fused_ring_fwd"),
        ("ring", "fused_ring_bwd"), ("trace", "fused_ring_fwd"),
        ("trace", "fused_ring_bwd"), ("split_step", "flash_fwd"),
        ("split_step", "flash_bwd"), ("bounds", "flash_fwd"),
        *(("sass", name) for name in _build.SIGNATURES))
        if part in parts and name in _build.SIGNATURES)))
    # (each once: build_all starts one nvcc a name)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    def t_ms(fn, iters, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def g_ms(fn, replays=10, calls=20):
        # `calls` calls in one CUDA graph, replayed between events
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        return t_ms(graph.replay, replays) / calls

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"tag": args.tag, "card": card, "fwd_tile": args.fwd_tile}
    if parts & {"ring", "trace"}:
        out.update(ring(torch, dev, t_ms, parts))
    if "fwd" in parts:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = r(1, 16, 2048, 128), r(1, 4, 2048, 128), r(1, 4, 2048, 128)
        out["fwd_s2048_ms"] = t_ms(lambda: flash.flash_attention(
            q, k, v, None, True), 40)
        out["fwd_s2048_w1024_ms"] = t_ms(lambda: flash.flash_attention(
            q, k, v, None, True, window=1024), 40)
        q, k, v = (r(1, 16, 8192, 128) for _ in range(3))
        out["fwd_s8192_ms"] = t_ms(lambda: flash.flash_attention(
            q, k, v, None, True), 10)
    if "bwd" in parts:
        # (tag, S, causal, timed calls): the train shape, a scan-ring round
        for tag, s, causal, iters in (("s8192", 8192, True, 6),
                                      ("s2048", 2048, True, 40),
                                      ("s2048_full", 2048, False, 40)):
            g = torch.Generator(device=dev).manual_seed(1)
            q, k, v = (r(1, 16, s, 128) for _ in range(3))
            spec = (masks.round_spec(0, 0, s, s, True, "contig") if causal
                    else masks.full_spec(s, s))
            _, lse, o = flash.flash_fwd(q, k, v, None, None, None,
                                        128**-0.5, spec, emit_o=True)
            do = r(1, 16, s, 128)
            delta = (o.float() * do.float()).sum(-1)
            out[f"bwd_fused_{tag}_ms"] = t_ms(lambda: flash.flash_bwd(
                do, q, k, v, delta, lse, 128**-0.5, spec), iters, 1)
            out[f"bwd_split_{tag}_ms"] = split_ms(
                torch, lambda: flash.flash_bwd(do, q, k, v, delta, lse,
                                               128**-0.5, spec, fused=False))
            del q, k, v, o, do, delta, lse
    if parts & {"fwd", "bwd"} and hasattr(flash, "fwd_attrs"):
        out["flash_attrs"] = flash.fwd_attrs() + flash.bwd_attrs()

    g = torch.Generator(device=dev).manual_seed(2)
    lengths = (0, 1, 128, 2112, 2048, 1000, 129, 1536)
    kp, vp = r(160, 4, 128, 128), r(160, 4, 128, 128)
    free = list(np.random.default_rng(0).permutation(159) + 1)
    table = np.zeros((8, 17), np.int32)
    for i, ln in enumerate(lengths):
        for c in range(-(-ln // 128)):
            table[i, c] = free.pop()
    table = torch.from_numpy(table).to(dev)
    if "decode" in parts:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        qd = r(8, 4, 4, 128)
        def dec():
            return pa.paged_decode_attention(qd, kp, vp, table, lens)

        out["decode_bf16_ms"] = g_ms(dec)
        out["decode_bf16_eager_ms"] = t_ms(dec, 100)
        out["decode_bf16_w1024_ms"] = g_ms(
            lambda: pa.paged_decode_attention(qd, kp, vp, table, lens,
                                              window=1024))
        (k8, ks), (v8, vs) = (pa.quantize_tokens(x.float(), dtype=torch.int8)
                              for x in (kp, vp))
        out["decode_int8_ms"] = g_ms(lambda: pa.paged_decode_attention(
            qd, k8, v8, table, lens, k_scales=ks, v_scales=vs))
    ql = torch.tensor((0, 1, 37, 128, 128, 1, 128, 37), dtype=torch.int32,
                      device=dev)
    kl = torch.tensor((0, 2112, 37, 1024, 2048, 1, 700, 1500),
                      dtype=torch.int32, device=dev)
    qr = r(8, 16, 128, 128)
    if "ragged" in parts:
        def rag():
            return rp.ragged_paged_attention(qr, kp, vp, table, ql, kl)

        out["ragged_bf16_ms"] = g_ms(rag)
        out["ragged_bf16_eager_ms"] = t_ms(rag, 40)
        out["ragged_bf16_w1024_ms"] = g_ms(
            lambda: rp.ragged_paged_attention(qr, kp, vp, table, ql, kl,
                                              window=1024))
    if "micro" in parts:
        def block_case(n_slots, group, qt, kv, q_len=None, page=128):
            g = torch.Generator(device=dev).manual_seed(3)
            width = -(-kv // page)
            pool = [torch.randn(n_slots * width + 1, 1, page, 128,
                                generator=g, device=dev).bfloat16()
                    for _ in range(2)]
            tab = (torch.arange(n_slots * width, dtype=torch.int32,
                                device=dev) + 1).reshape(n_slots, width)
            q = torch.randn(n_slots, group, qt, 128, generator=g,
                            device=dev).bfloat16()
            qls, kls = (torch.full((n_slots,), x, dtype=torch.int32,
                                   device=dev) for x in (q_len or qt, kv))
            return lambda: rp.ragged_paged_attention(q, *pool, tab, qls, kls)

        for name, case in (("1blk_1ch", (1, 1, 64, 64)),
                           ("1blk_8ch", (1, 1, 64, 512)),
                           ("264blk_8ch", (264, 1, 64, 512)),
                           ("528blk_8ch", (528, 1, 64, 512)),
                           ("dec_512", (1, 4, 1, 512)),
                           ("dec_64", (1, 4, 1, 64)),
                           ("1blk_2048", (1, 1, 64, 2048))):
            out[f"micro_{name}_ms"] = g_ms(block_case(*case))
    if "grid" in parts:
        out.update(grid(torch, rp, g_ms, qr, kp, vp, table, ql, kl))
    if "sass" in parts:
        out["sass"] = sass_digests(_build)
    if "split_step" in parts:
        out.update(split_step(torch, dev))
    if "bounds" in parts:
        out["dq_bounds"] = dq_bounds(torch, dev, _build, flash, masks, r)
    print("AB " + json.dumps(out), flush=True)
    return 0


def sass_digests(_build):
    """{library: {kernel: digest}}: a sha256 of each kernel's SASS in the
    checkout's built libraries (cuobjdump -sass, instruction lines only),
    the anonymous-namespace tag in its name (it follows the source file's
    contents) taken out."""
    import hashlib
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = {}
    for name in _build.SIGNATURES:
        sass = subprocess.run([tool, "-sass", str(_build._target(name)[1])],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs, cur = {}, None
        for line in sass.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                cur = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                             m.group(1))
                funcs[cur] = hashlib.sha256()
            elif cur is not None and line.strip():
                funcs[cur].update(line.strip().encode())
        res[name] = {f: h.hexdigest()[:16] for f, h in funcs.items()}
    return res


def split_step(torch, dev, steps=3):
    """The `split_step` part: chip_smoke.py's split-backward train step,
    one warm-up then `steps` timed steps (host clock, synchronized)."""
    import statistics
    import time

    import chip_smoke as cs
    from burst_attn_tpu_torch.models import train

    cfg = cs._train_model(cs.TRAIN_DIMS["n_layers"], torch.bfloat16)
    tcfg = train.TrainConfig()
    state = cs._seed_state(cfg, tcfg, dev)
    batch = train.make_batch(1, cfg, batch=1, seq=cs.TRAIN_SEQ, device=dev)
    step = train.make_train_step(cfg, tcfg, device=dev)
    times = []
    with cs.split_train_backward():
        for _ in range(1 + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return {"split_step_ms": statistics.median(times[1:]),
            "split_step_ms_all": times[1:]}


def dq_bounds(torch, dev, _build, flash, masks, r):
    """The `bounds` part: kernel 4's bf16 instance (flash_bwd_dq_mma_kernel)
    built from a copy of the checkout's csrc/ with and without the
    minimum of two CTAs an SM in its launch bounds; each build's ptxas
    registers and spill line and its device ms at B1 N16 S8192 bf16
    causal (profiler, as split_ms), in turns two, none, none, two.  Both
    builds compute the same sums: their dq must be bitwise equal."""
    import ctypes
    import shutil

    src = (_build.CSRC / "flash_bwd.cu").read_text()
    bound = "__launch_bounds__(kDqNT, 2)"
    if src.count(bound) != 1:
        raise RuntimeError("the checkout's dq kernel has no two-CTA bound")
    q, k, v, do = (r(1, 16, 8192, 128) for _ in range(4))
    spec = masks.round_spec(0, 0, 8192, 8192, True, "contig")
    _, lse, o = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5, spec,
                                emit_o=True)
    args = (do, q, k, v, (o.float() * do.float()).sum(-1), lse, 128**-0.5,
            spec)
    work = _build.BUILD_DIR.parent / "dq_bounds"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work)
    built = _build._LIBS.pop("flash_bwd", None)
    res, libs, outs = {}, {}, []
    try:
        for tag, text in (("two_ctas", bound), ("none", "__launch_bounds__"
                                                        "(kDqNT)")):
            (work / "flash_bwd.cu").write_text(src.replace(bound, text))
            so = work / f"flash_bwd_{tag}.so"
            log = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(so), str(work / "flash_bwd.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, check=True).stdout
            lines = log.splitlines()
            at = next(i for i, ln in enumerate(lines)
                      if "Compiling entry" in ln and "dq_mma_kernel" in ln)
            libs[tag] = ctypes.CDLL(str(so))
            for fn, argtypes in _build.SIGNATURES["flash_bwd"].items():
                getattr(libs[tag], fn).argtypes = list(argtypes)
                getattr(libs[tag], fn).restype = ctypes.c_int
            res[tag] = {"ptxas": [ln.split(":", 1)[-1].strip()
                                  for ln in lines[at + 1:at + 4]
                                  if "spill" in ln or "registers" in ln],
                        "dq_ms": []}
            _build._LIBS["flash_bwd"] = libs[tag]
            outs.append(flash.flash_bwd(*args, fused=False)[0])
        for tag in ("two_ctas", "none", "none", "two_ctas"):
            _build._LIBS["flash_bwd"] = libs[tag]
            res[tag]["dq_ms"].append(split_ms(torch, lambda: flash.flash_bwd(
                *args, fused=False))["dq"])
    finally:
        _build._LIBS.pop("flash_bwd", None)
        if built is not None:
            _build._LIBS["flash_bwd"] = built
    res["bitwise_equal"] = bool(torch.equal(*outs))
    return res


# the split pair's kernel names in every checkout: the SIMT kernels
# (flash_bwd_dq_kernel, flash_bwd_kv_kernel) and the tensor-core bf16
# instances (flash_bwd_dq_mma_kernel, flash_bwd_dkdv_mma_kernel)
SPLIT_KERNELS = {"dq": ("flash_bwd_dq_kernel", "flash_bwd_dq_mma_kernel"),
                 "dkdv": ("flash_bwd_kv_kernel",
                          "flash_bwd_dkdv_mma_kernel")}


def split_ms(torch, fn, calls=3):
    """Device ms a launch of the split pair's dq and dk/dv kernels, from
    the profiler (as chip_smoke.py's time_flash_bwd reads them), by either
    generation's kernel names, over the launches the profiler recorded (a
    later profiler session of a process has dropped some); raises if
    either reads 0."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = {"dq": [0.0, 0], "dkdv": [0.0, 0]}
    for e in prof.key_averages():
        for part, names in SPLIT_KERNELS.items():
            if any(name in e.key for name in names):
                total[part][0] += e.self_device_time_total / 1e3
                total[part][1] += e.count
    res = {part: t / n if n else 0.0 for part, (t, n) in total.items()}
    if not (res["dq"] > 0 and res["dkdv"] > 0):
        raise RuntimeError(f"split kernels not profiled: {res}")
    return res


# (tag, positions, heads, local S): bench.py's headline over sp=8, the ring
# train step (train_smoke's 16 heads, S 8192) over sp=4
RING_SHAPES = (("headline", 8, 32, 8192), ("ring_step", 4, 16, 2048))


def ring(torch, dev, t_ms, parts):
    """The `ring` and `trace` parts: kernels 8 and 9 at RING_SHAPES."""
    from burst_attn_tpu_torch.ops import fused_ring
    from burst_attn_tpu_torch.ops import fused_ring_bwd as frb
    from burst_attn_tpu_torch.parallel import burst

    cfg = burst.BurstConfig(backend="fused_ring", causal=True,
                            layout="zigzag")
    res = {}
    for tag, w, n, s in RING_SHAPES:
        g = torch.Generator(device=dev).manual_seed(5)
        q, k, v, do = (torch.randn(w, 1, n, s, 128, generator=g,
                                   device=dev).bfloat16() for _ in range(4))
        o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, 1, w)
        heavy = tag == "headline"
        if "ring" in parts:
            res[f"k8_{tag}_ms"] = t_ms(
                lambda: fused_ring.fused_ring_fwd(q, k, v, cfg, 1, w),
                3 if heavy else 20, 1)
            res[f"k9_{tag}_ms"] = t_ms(
                lambda: frb.fused_ring_bwd(q, k, v, o, lse, do, cfg, 1, w),
                2 if heavy else 10, 1)
        if "trace" in parts:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            trace = torch.zeros((sms, len(frb.TRACE_COLS)),
                                dtype=torch.int64, device=dev)
            res[f"k9_{tag}_traced_ms"] = t_ms(
                lambda: frb.fused_ring_bwd(q, k, v, o, lse, do, cfg, 1, w,
                                           trace=trace), 1 if heavy else 5, 1)
            recs = frb.read_trace(trace)  # the last launch's records
            span = [r["t1_ns"] - r["t0_ns"] for r in recs]
            fold = [r["fold_wait_ns"] / sp for r, sp in zip(recs, span)]
            phase = [r["phase_wait_ns"] / sp for r, sp in zip(recs, span)]
            res[f"k9_{tag}_trace"] = dict(
                ctas=len(recs), span_ns_max=max(span),
                span_ns_min=min(span),
                fold_wait_share_mean=sum(fold) / len(fold),
                fold_wait_share_max=max(fold),
                phase_wait_share_mean=sum(phase) / len(phase),
                phase_wait_share_max=max(phase),
                steps=sum(r["steps"] for r in recs),
                items=sum(r["items"] for r in recs),
                # clock64 cycles a step by part, averaged over the steps
                cycles_a_step={
                    c[4:]: sum(r[c] for r in recs) / max(
                        1, sum(r["steps"] for r in recs))
                    for c in frb.TRACE_COLS if c.startswith("cyc_")})
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    if "trace" in parts:
        res["attrs"] = fused_ring.fwd_attrs() + frb.bwd_attrs()
    return res


def grid(torch, rp, g_ms, q, kp, vp, table, ql, kl, window=1024):
    """The `grid` part: kernel 7's traced grid on the mixed batch, plain
    and windowed (with the traced launch's device time), and the
    profiler's per-kernel device times of kernel 7 and of SDPA on the
    gathered band (windowed)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    s, n_q, qt, d = q.shape
    n_kv, page, width = kp.shape[1], kp.shape[2], table.shape[1]
    group = n_q // n_kv
    res = {}
    for tag, win in (("ragged", None), ("ragged_w1024", window)):
        trace = torch.zeros(rp.trace_shape(s, n_kv, qt, group, width, page),
                            dtype=torch.int64, device=q.device)
        def traced():
            return rp.launch(q, kp, vp, table, ql, kl, None, None, d**-0.5,
                             None, False, win, "grid", trace=trace)

        traced_ms = g_ms(traced)  # the last launch's records stay
        torch.cuda.synchronize()
        recs = rp.read_trace(trace.cpu(), qt, group, width, page)
        t0 = min(r["t0_ns"] for r in recs)
        live = [r for r in recs if r["kind"] != "exit"]
        dead = [r for r in recs if r["kind"] == "exit"]

        def med(xs):
            xs = sorted(xs)
            return xs[len(xs) // 2] if xs else None

        span = [r["t1_ns"] - r["t0_ns"] for r in live]
        chunks = [r["e"] - r["a"] + 1 for r in live]
        res[tag + "_grid"] = dict(
            traced_ms=traced_ms, ctas=len(recs), exit=len(dead),
            decode=sum(r["kind"] == "decode" for r in live),
            prefill=sum(r["kind"] == "prefill" for r in live),
            live_ns_median=med(span), live_ns_max=max(span),
            exit_ns_median=med([r["t1_ns"] - r["t0_ns"] for r in dead]),
            chunks_max=max(chunks), chunks_sum=sum(chunks),
            cycles_a_chunk=sum(r["cycles"] for r in live) / sum(chunks),
            last_start_ns=max(r["t0_ns"] for r in live) - t0,
            span_ns=max(r["t1_ns"] for r in recs) - t0)
    # SDPA on each slot's band, as chip_smoke.py's windowed yardstick
    lo = (kl - ql - window + 1).clamp(min=0)
    pos = (lo.long()[:, None] + torch.arange(window + qt, device=q.device)
           ).clamp(max=width * page - 1)
    pid = table.long().gather(1, pos // page)
    kd, vd = (x[pid, :, pos % page].movedim(2, 1).contiguous()
              for x in (kp, vp))
    t = torch.arange(qt, device=q.device)
    qp = (kl - ql).long()[:, None] + t[None, :]
    real = t[None, :] < ql[:, None]
    mask = ((pos[:, None, :] <= qp[:, :, None])
            & (pos[:, None, :] > qp[:, :, None] - window) & real[:, :, None])
    mask[:, :, 0] |= ~real
    calls = (("ragged_w1024", lambda: rp.ragged_paged_attention(
        q, kp, vp, table, ql, kl, window=window)),
             ("sdpa_w1024", lambda: F.scaled_dot_product_attention(
                 q, kd, vd, attn_mask=mask[:, None], enable_gqa=True)))
    for tag, fn in calls:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        res[tag + "_profile_ms"] = {
            e.key[:80]: e.self_device_time_total / 1e3 / 20
            for e in prof.key_averages() if e.self_device_time_total > 0}
    return res


if __name__ == "__main__":
    sys.exit(main())
