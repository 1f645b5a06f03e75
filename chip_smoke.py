"""Smoke run of the PyTorch/CUDA port (burst_attn_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still builds and serves on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, with its time, the plain version's time, one
     PyTorch library call's time (a yardstick only, never used by the
     port) and its roofline bound;
  4. the ServeEngine at the serving benchmark's width (vocab 32768,
     d_model 2048, 8 layers, 16/4 heads, d_ff 8192, bf16, random weights
     from a seed): 12 requests over 8 slots, launch counters read around
     the run, greedy tokens teacher-forced through the dense plain forward;
  5. a `kernels` JSON line, then the result line
     {"ok": true, "device": {...}} last.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

import contextlib
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# the serving benchmark's model (benchmarks/serve_bench.py defaults)
SERVE_DIMS = dict(vocab=32768, d_model=2048, n_layers=8, n_heads=16,
                  n_kv_heads=4, d_head=128, d_ff=8192)
SLOTS, N_PAGES, PAGE, MAX_PAGES = 8, 160, 128, 17
N_REQUESTS = 12

# kernel-vs-plain tolerances, scaled to the values compared.  Both sides
# compute in fp32 and differ only in summation order and exp2-vs-exp, so
# an fp32 run differs by rounding alone; in bf16 each side rounds its
# output once, so they may differ by up to two bf16 ulps (2 * 2^-7
# relative), with an absolute floor for outputs near zero.  The checks
# run at both dtypes: fp32 catches a small fault (one page of a long
# context skipped moves |o| ~ 0.03 outputs by ~4e-2) that bf16 rounding
# could hide.
O_TOL = {"bf16": dict(atol=2e-3, rtol=1.6e-2),
         "fp32": dict(atol=1e-5, rtol=1e-4)}
STATS_ATOL = {"bf16": 1e-3, "fp32": 1e-4}  # m, lse (always fp32)
ACC_RTOL = 1e-4     # raw fp32 accumulator, relative to its largest entry
# Greedy tokens vs the dense plain forward, teacher-forced.  In bf16 the
# engine's per-token decode matmuls and incremental K/V round differently
# from one dense pass, which flips near-tied argmaxes: with the kernels
# swapped for their plain versions (the control run below) the engine
# agreed at 97.2% (559/575) on an H100.  So bf16 requires >= 95% AND every
# disagreement to be a near tie (reference logit gap <= TIE_GAP; logits
# have std ~0.9 here, a real fault gives O(1) gaps); fp32 at the same
# width must agree token for token.
MIN_AGREE_BF16 = 0.95
TIE_GAP = 0.1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call (CUDA events around `iters`
    calls, after `warmup` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = n_flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_breakdown(fn, n_calls, top=6):
    """Profile `n_calls` calls of `fn` with torch.profiler: returns (wall
    ms per call, device ms per call, [(kernel name, device ms per call)]
    of the `top` kernels by self device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_calls
    rows = [(e.key, e.self_device_time_total / 1e3 / n_calls)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(t for _, t in rows), [(k[:60], t) for k, t in rows[:top]]


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _dtype_key(dtype):
    import torch

    return {torch.bfloat16: "bf16", torch.float32: "fp32"}[dtype]


def _check_o(what, got, want, dtype):
    """Assert the kernel's output `got` matches the plain `want` within
    O_TOL[dtype]; returns the max-abs error."""
    import torch

    torch.testing.assert_close(got, want, **O_TOL[_dtype_key(dtype)],
                               msg=lambda m: f"{what}: {m}")
    return _max_err(got, want)


def check_flash(device, b=1, n=16, n_kv=4, s=2048, d=128, dtype=None,
                seed=0, timing=True):
    """flash_fwd against tile_fwd/finalize on the card: causal at S=s,
    causal at a ragged S, non-causal with a carry-in.  Returns the record
    for the kernels line (times at the first case), or with `timing`
    False the largest o error."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash, masks, tile

    dtype = dtype or torch.bfloat16
    key = _dtype_key(dtype)
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    scale = d**-0.5
    worst = 0.0
    cases = [("causal", s, True, False), ("causal-ragged", 1000, True, False),
             ("carry-noncausal", s // 2, False, True)]
    for name, sl, causal, carry in cases:
        q, k, v = rand(b, n, sl, d), rand(b, n_kv, sl, d), rand(b, n_kv, sl, d)
        spec = masks.round_spec(0, 0, sl, sl, causal, "contig")
        st0 = tile.init_state(b, n, sl, d, device=device)
        if carry:  # a first round's state, from the plain tile
            k0, v0 = rand(b, n_kv, sl, d), rand(b, n_kv, sl, d)
            st0 = tile.tile_fwd(q, k0, v0, *st0, scale,
                                masks.full_spec(sl, sl))
            m, lse, acc = flash.flash_fwd(q, k, v, *st0, scale, spec)
            pm, plse, pacc = tile.tile_fwd(q, k, v, *st0, scale, spec)
            acc_err = _max_err(acc, pacc)
            acc_tol = ACC_RTOL * float(pacc.abs().max())
            assert acc_err <= acc_tol, f"flash {name}: acc err {acc_err}"
            err = acc_err / max(float(pacc.abs().max()), 1e-30)
        else:
            m, lse, o = flash.flash_fwd(q, k, v, None, None, None, scale,
                                        spec, emit_o=True)
            pm, plse, pacc = tile.tile_fwd(q, k, v, *st0, scale, spec)
            err = _check_o(f"flash {name}", o,
                           tile.finalize(pm, plse, pacc, dtype), dtype)
            worst = max(worst, err)
        for got, want, what in [(m, pm, "m"), (lse, plse, "lse")]:
            e = _max_err(got, want)
            assert e <= STATS_ATOL[key], f"flash {name}: {what} err {e}"
        assert torch.isfinite(lse).all()  # every row sees >= 1 column
        print(f"flash_fwd {key} {name}: S={sl} max_abs_err={err:.3e} "
              f"(tolerance {O_TOL[key]})", flush=True)
    if not timing:
        return worst

    q, k, v = rand(b, n, s, d), rand(b, n_kv, s, d), rand(b, n_kv, s, d)
    spec = masks.round_spec(0, 0, s, s, True, "contig")
    ms = time_ms(lambda: flash.flash_attention(q, k, v, None, True))

    def plain():
        st0 = tile.init_state(b, n, s, d, device=device)
        st = tile.tile_fwd(q, k, v, *st0, scale, spec)
        return tile.finalize(*st, dtype)

    plain_ms = time_ms(plain, iters=3, warmup=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pairs = b * s * (s + 1) // 2
    esz = q.element_size()
    n_bytes = esz * (q.numel() * 2 + k.numel() * 2) + 4 * 2 * b * n * s
    bms, by = bound_ms(n_bytes, 4 * pairs * n * d)
    return dict(name="flash_fwd", route="cuda",
                source="burst_attn_tpu_torch/csrc/flash_fwd.cu",
                replaces="burst_attn_tpu/ops/pallas_flash.py:419",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def check_paged_decode(device, n_kv=4, group=4, d=128, page=PAGE,
                       lengths=(0, 1, 128, 2112, 2048, 1000, 129, 1536),
                       n_pages=N_PAGES, width=MAX_PAGES, dtype=None, seed=0,
                       timing=True):
    """paged_decode_attention against paged_decode_reference on the card
    at 8 slots with ragged lengths.  Returns the kernels-line record, or
    with `timing` False the max-abs error."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import paged_attention as pa

    dtype = dtype or torch.bfloat16
    slots = len(lengths)
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(slots, n_kv, group, d, generator=g,
                    device=device).to(dtype)
    kp = torch.randn(n_pages, n_kv, page, d, generator=g,
                     device=device).to(dtype)
    vp = torch.randn(n_pages, n_kv, page, d, generator=g,
                     device=device).to(dtype)
    rng = np.random.default_rng(seed)
    free = list(rng.permutation(n_pages - 1) + 1)
    table = np.zeros((slots, width), np.int32)
    for i, ln in enumerate(lengths):
        for c in range(-(-ln // page)):
            table[i, c] = free.pop()
    table = torch.from_numpy(table).to(device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)

    o = pa.paged_decode_attention(q, kp, vp, table, lens)
    want = pa.paged_decode_reference(q, kp, vp, table, lens)
    err = _check_o("paged_decode", o, want, dtype)
    for i, ln in enumerate(lengths):
        assert ln or (o[i] == 0).all(), "an empty slot must give zeros"
    key = _dtype_key(dtype)
    print(f"paged_decode {key} lengths={list(lengths)} max_abs_err={err:.3e} "
          f"(tolerance {O_TOL[key]})", flush=True)
    if not timing:
        return err

    ms = time_ms(lambda: pa.paged_decode_attention(q, kp, vp, table, lens))
    plain_ms = time_ms(
        lambda: pa.paged_decode_reference(q, kp, vp, table, lens), iters=5)
    # the library yardstick: SDPA over the cache gathered to dense
    idx = table.long()
    kd = kp[idx].movedim(2, 1).reshape(slots, n_kv, width * page, d)
    vd = vp[idx].movedim(2, 1).reshape(slots, n_kv, width * page, d)
    qd = q.reshape(slots, n_kv * group, 1, d)
    mask = (torch.arange(width * page, device=device)[None, :]
            < lens[:, None])[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True))
    live = int(sum(lengths))
    esz = q.element_size()
    n_bytes = (esz * (2 * live * n_kv * d + 2 * q.numel())
               + 4 * (table.numel() + slots))
    bms, by = bound_ms(n_bytes, 4 * live * n_kv * group * d)
    return dict(name="paged_decode", route="cuda",
                source="burst_attn_tpu_torch/csrc/paged_decode.cu",
                replaces="burst_attn_tpu/ops/paged_attention.py:56",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


@contextlib.contextmanager
def plain_attention():
    """Route the serving path's attention through the plain versions: the
    bf16 noise-floor control.  The kernel wrappers launch for every CUDA
    tensor by design, so only patching the two call sites can do this."""
    from unittest import mock

    import burst_attn_tpu_torch.models.paged_decode as pd
    from burst_attn_tpu_torch.ops import paged_attention as pa, tile

    def decode(q, kp, vp, table, lengths):
        return pa.paged_decode_reference(q, kp, vp, table, lengths)

    def prompt(q, k, v):
        return tile.single_device_attention(q, k, v, causal=True)

    with mock.patch.object(pd, "paged_decode_attention", decode), \
            mock.patch.object(pd, "_flash_prompt_attention", prompt):
        yield


def serve(cfg, device, *, n_requests=N_REQUESTS, slots=SLOTS,
          n_pages=N_PAGES, page=PAGE, max_pages=MAX_PAGES, len_lo=100,
          len_hi=2048, new_lo=32, new_hi=64, seed=0, timing=True):
    """Drive the ServeEngine through run() with the launch counters set to
    0 just before and read just after; check budgets, pool drain and the
    teacher-forced agreement with the dense plain forward; then (`timing`)
    time a prefill and steady decode steps.  Returns a dict of results."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.models.transformer import forward, init_params
    from burst_attn_tpu_torch.ops import flash, paged_attention as pa

    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=device)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    lens = [len_lo, len_hi] + list(rng.integers(len_lo, len_hi + 1,
                                                n_requests - 2))
    budgets = list(rng.integers(new_lo, new_hi + 1, n_requests))
    prompts = [rng.integers(1, cfg.vocab, size=int(t), dtype=np.int32)
               for t in lens]
    eng = ServeEngine(params, cfg, slots=slots, n_pages=n_pages, page=page,
                      max_pages_per_seq=max_pages, eos_id=None, device=device)
    rids = [eng.submit(p, int(n)) for p, n in zip(prompts, budgets)]

    flash.flash_fwd.launches = 0
    pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    out = eng.run()
    run_s = time.perf_counter() - t0
    launches = {"flash_fwd": flash.flash_fwd.launches,
                "paged_decode": pa.paged_decode_attention.launches}

    for rid, n in zip(rids, budgets):
        toks = out[rid]
        assert len(toks) == n, f"request {rid}: {len(toks)} of {n} tokens"
        assert all(0 <= t < cfg.vocab for t in toks)
    assert eng.pool.available == n_pages - 1, "pool did not drain"
    n_generated = int(sum(budgets))

    agree = total = 0
    gaps = []  # (token index, reference logit gap) per disagreement
    for rid, p in zip(rids, prompts):
        full = np.concatenate([p, np.asarray(out[rid][:-1], np.int32)])
        tok = torch.from_numpy(full.astype(np.int64)).to(device)[None]
        pos = torch.arange(tok.shape[1], device=device)[None]
        with torch.no_grad():
            logits = forward(params, tok, pos, cfg)
        assert torch.isfinite(logits).all()
        lg = logits[0, len(p) - 1:]
        got = torch.as_tensor(out[rid], device=device)
        pred = lg.argmax(-1)
        miss = (pred != got).nonzero()[:, 0]
        agree += len(out[rid]) - len(miss)
        total += len(out[rid])
        # how close each disagreement is to a tie, in reference logits
        for i in miss.tolist():
            gaps.append((i, float(lg[i, pred[i]] - lg[i, got[i]])))
        del logits, lg

    res = dict(launches=launches, n_requests=n_requests,
               n_generated=n_generated, agree=agree, total=total, gaps=gaps,
               run_s=run_s, init_s=init_s, run_tok_s=n_generated / run_s,
               min_decode_steps=-(-(n_generated - n_requests) // slots))
    if not timing:
        return res
    # steady-state timing: one full-length prefill; then decode steps with
    # every slot live at ~len_hi context
    long_prompt = prompts[1]
    sync = torch.cuda.synchronize
    times = []
    for _ in range(3):
        eng.submit(long_prompt, 1)
        sync()
        t0 = time.perf_counter()
        eng.step()  # admits (one prefill) and retires at once: budget 1
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = sorted(times)[1]  # median of 3

    def one_prefill():
        eng.submit(long_prompt, 1)
        eng.step()

    prof_prefill = device_breakdown(one_prefill, 2)
    for _ in range(slots):
        eng.submit(long_prompt[: len_hi - new_hi], new_hi)
    eng.step()  # admits every slot
    n_steps = new_hi // 2
    sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    prof_step = device_breakdown(eng.step, 4)
    eng.drain()
    res.update(prefill_ms=prefill_ms, prefill_len=len(long_prompt),
               decode_step_ms=step_ms, decode_tok_s=slots * 1e3 / step_ms,
               prof_prefill=prof_prefill, prof_step=prof_step)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # imported only now: run alone, outside a checkout, this raises
    from burst_attn_tpu_torch.models.transformer import ModelConfig
    from burst_attn_tpu_torch.ops import _build

    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_flash(device, dtype=torch.float32, timing=False)
    check_paged_decode(device, dtype=torch.float32, timing=False)
    kernels = [check_flash(device), check_paged_decode(device)]

    cfg = ModelConfig(**SERVE_DIMS, dtype=torch.bfloat16, batch_axis=None,
                      head_axis=None)
    res = serve(cfg, device)
    n_layers = cfg.n_layers
    launches = res["launches"]
    print(f"serve: {res['n_requests']} requests, {res['n_generated']} tokens "
          f"in {res['run_s']:.2f} s ({res['run_tok_s']:.1f} tok/s), "
          f"launches {launches}, params init {res['init_s']:.1f} s",
          flush=True)
    assert launches["flash_fwd"] == n_layers * res["n_requests"], launches
    assert launches["paged_decode"] % n_layers == 0, launches
    assert launches["paged_decode"] >= n_layers * res["min_decode_steps"], \
        launches
    rate = res["agree"] / res["total"]
    worst_gap = max((g for _, g in res["gaps"]), default=0.0)
    print(f"bf16 teacher-forced agreement with the dense forward: "
          f"{res['agree']}/{res['total']} = {rate:.4f}, largest reference "
          f"logit gap at a disagreement {worst_gap:.4f}", flush=True)
    assert rate >= MIN_AGREE_BF16, rate
    assert worst_gap <= TIE_GAP, res["gaps"]
    with plain_attention():
        ctrl = serve(cfg, device, timing=False)
    assert sum(ctrl["launches"].values()) == 0, ctrl["launches"]
    print(f"control, same bf16 engine with plain attention: "
          f"{ctrl['agree']}/{ctrl['total']}", flush=True)
    cfg32 = ModelConfig(**SERVE_DIMS, dtype=torch.float32, batch_axis=None,
                        head_axis=None)
    res32 = serve(cfg32, device, timing=False)
    print(f"fp32 teacher-forced agreement: {res32['agree']}/{res32['total']}",
          flush=True)
    assert res32["agree"] == res32["total"], res32["gaps"]
    assert res32["launches"]["flash_fwd"] == cfg32.n_layers * N_REQUESTS
    print(f"prefill {res['prefill_len']} tokens: {res['prefill_ms']:.2f} ms; "
          f"decode step ({SLOTS} slots): {res['decode_step_ms']:.2f} ms = "
          f"{res['decode_tok_s']:.1f} tok/s", flush=True)

    for what in ("prefill", "step"):
        wall, dev, top = res[f"prof_{what}"]
        print(f"profile {what}: wall {wall:.2f} ms, device {dev:.2f} ms "
              f"(busy {dev / wall:.2f}); top kernels (ms): "
              + "; ".join(f"{k} {t:.3f}" for k, t in top), flush=True)

    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels],
                      "card": card,
                      "serve": {k: res[k] for k in (
                          "prefill_ms", "prefill_len", "decode_step_ms",
                          "decode_tok_s", "run_s", "run_tok_s",
                          "n_generated", "agree", "total")},
                      "fp32_agree": [res32["agree"], res32["total"]],
                      "control_agree": [ctrl["agree"], ctrl["total"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
