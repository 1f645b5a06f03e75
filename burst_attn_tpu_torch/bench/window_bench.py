"""Sliding-window attention on the card: the cost follows the window, not
the sequence (port of benchmarks/window_bench.py).

Times the forward of `flash_attention` (kernel 1, csrc/flash_fwd.cu) at a
fixed sequence over shrinking windows with CUDA events, and reports the
band-normalised rate: the band of width w over s tokens has s * w -
w * (w - 1) / 2 attended pairs (the first w rows ramp up), 4 * D flops
each, so a window equal to the sequence gives the causal convention.

    python -m burst_attn_tpu_torch.bench.window_bench \\
        --seq 65536 --windows 65536,16384,4096 --out results/window.jsonl

A window "none" is plain causal attention.  Rows are printed as JSON;
`--out` appends them to a JSON-lines file (nothing is written without
it).  The CLI refuses to run without a CUDA device, as the JAX bench
refuses off a TPU: a CPU number is not the card's.
"""

import argparse
import json
import sys

import torch

from ..ops.flash import flash_attention
from .step_probe import card_line


def band_pairs(s: int, window) -> int:
    """Attended (query, key) pairs of causal attention over s tokens with
    a sliding window (None: plain causal)."""
    w = s if window is None else min(int(window), s)
    return s * w - w * (w - 1) // 2


def time_fwd(q, k, v, window, iters: int = 10, warmup: int = 2) -> float:
    """ms a call of flash_attention's forward (causal, `window`), by CUDA
    events over `iters` calls after `warmup`."""
    with torch.no_grad():
        for _ in range(warmup):
            flash_attention(q, k, v, None, True, window=window)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            flash_attention(q, k, v, None, True, window=window)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(seq: int, heads: int, dim: int, windows, iters: int = 10,
        seed: int = 0):
    """One row per window: {seq, heads, dim, window, fwd_ms, band_tflops,
    card}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(1, heads, seq, dim, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    name = card_line()
    rows = []
    for wnd in windows:
        ms = time_fwd(q, k, v, wnd, iters=iters)
        flops = 4 * heads * dim * band_pairs(seq, wnd)
        rows.append({"seq": seq, "heads": heads, "dim": dim, "window": wnd,
                     "fwd_ms": ms, "band_tflops": flops / (ms * 1e-3) / 1e12,
                     "card": name})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=65536)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--windows", default="65536,16384,4096",
                    help="comma list; 'none' = plain causal")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="append the rows to this JSON-lines file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_bench: no CUDA device; refusing to record numbers",
              file=sys.stderr)
        return 1
    windows = [None if tok.strip().lower() == "none" else int(tok)
               for tok in args.windows.split(",")]
    rows = run(args.seq, args.heads, args.dim, windows, iters=args.iters)
    for rec in rows:
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for rec in rows:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
