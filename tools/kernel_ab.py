"""Time the port's attention kernels of one checkout on the card, for an
A/B of two commits in one call.

    python tools/kernel_ab.py --root PATH --tag NAME [--parts fwd,bwd,...]

imports `burst_attn_tpu_torch` from the checkout at PATH (its kernels
build into PATH/build/kernels), times kernel 1 (causal, B1 N16/4 S2048,
plain and with window 1024, and B1 N16 S8192, bf16), the fused backward
(kernels 2-3) and the split pair (kernels 4-5, each kernel's device time
from the profiler) at B1 N16 S8192 bf16 causal, kernel 6 (8 slots, lengths 0-2112, bf16 and int8 pools,
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
where the checkout has `flash.fwd_attrs`.  `--parts` picks among fwd,
bwd, decode, ragged, micro, grid, ring and trace.  `--fwd-tile simt` builds kernel 8's bf16 instance on the SIMT
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
        ("trace", "fused_ring_bwd"))
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
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (r(1, 16, 8192, 128) for _ in range(3))
        spec = masks.round_spec(0, 0, 8192, 8192, True, "contig")
        _, lse, o = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5,
                                    spec, emit_o=True)
        do = r(1, 16, 8192, 128)
        delta = (o.float() * do.float()).sum(-1)
        out["bwd_fused_s8192_ms"] = t_ms(lambda: flash.flash_bwd(
            do, q, k, v, delta, lse, 128**-0.5, spec), 6, 1)
        out["bwd_split_s8192_ms"] = split_ms(
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
    print("AB " + json.dumps(out), flush=True)
    return 0


def split_ms(torch, fn, calls=3):
    """Device ms a call of the split pair's dq and dk/dv kernels, from the
    profiler (as chip_smoke.py's time_flash_bwd reads them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    res = {"dq": 0.0, "dkdv": 0.0}
    for e in prof.key_averages():
        for part, name in (("dq", "flash_bwd_dq_kernel"),
                           ("dkdv", "flash_bwd_kv_kernel")):
            if name in e.key:
                res[part] += e.self_device_time_total / 1e3 / calls
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
