"""Step-overhead probe on the card (port of benchmarks/step_probe.py).

Times a minimal kernel whose loop iteration does what one kv-tile
iteration of kernels 1, 8 and 9 does and nothing else: fetch one bf16
[bkv, d] block from a capped pool (index j % n_pool, so every iteration
reads another block) and, unless --no-matmul, add q @ block[:w]^T into an
fp32 [bq, 128] accumulator.  Sweeping bkv (bytes) against the step count
splits the per-step cost into

    t_step = t_fixed + bytes / bw + flops / rate

by least squares over the matmul and no-matmul sweeps (`fit`).
`t_fixed` is what an iteration costs beyond its bytes and operations.

`step_probe` launches csrc/step_probe.cu for CUDA tensors and runs the
plain `step_probe_reference` for CPU tensors.  Besides the product it
returns each CTA's wrapping 32-bit sum of the words it fetched, which
shows that the whole block was read every step.

    python -m burst_attn_tpu_torch.bench.step_probe --out build/step_probe.jsonl

runs the product sweep, then the fetch-only one, and prints the fit;
`--no-matmul` runs the fetch-only sweep alone.

The CLI refuses to run without a CUDA device, as the JAX probe refuses
off a TPU.  Each cell's row has the JAX probe's fields (`us_minus_dma`
subtracts the bytes term at the H100's 3.35 TB/s) plus whether the pool
fits the 50 MB L2 (then the fetch measures L2, not HBM) and the card.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..analysis.costmodel import HW
from ..ops import _build

# the H100's roofline (the cost model's h100 row: the one source)
HBM_BYTES_PER_S = HW["h100"].hbm_bw
PEAK_BF16_FLOPS = HW["h100"].peak_flops
L2_BYTES = 50 * 2**20        # the H100's L2
ROWS_PER_CTA = 16            # q rows per CTA (csrc/step_probe.cu RQ)
OUT_COLS = 128               # the accumulator's columns
KERNEL_DIM = 128


def n_ctas(bq: int) -> int:
    """CTAs of a launch: the q rows split 16 to a CTA."""
    return -(-int(bq) // ROWS_PER_CTA)


def _check(q, pool, steps):
    if q.dim() != 3 or q.shape[0] != 1 or pool.dim() != 3:
        raise ValueError(f"q must be [1, bq, d] and pool [n_pool, bkv, d], "
                         f"got {tuple(q.shape)} and {tuple(pool.shape)}")
    if q.shape[2] != pool.shape[2]:
        raise ValueError(f"q dim {q.shape[2]} != pool dim {pool.shape[2]}")
    if q.dtype != torch.bfloat16 or pool.dtype != torch.bfloat16:
        raise ValueError("q and pool must be bf16")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")


def step_probe(q, pool, steps: int, matmul: bool = True):
    """q [1, bq, d] bf16, pool [n_pool, bkv, d] bf16 -> (out [1, bq, 128]
    fp32 = sum_{j < steps} q @ pool[j % n_pool][:w]^T with w = min(128,
    bkv) and columns w.. zero (all zero without `matmul`), sums [n_cta]
    int64: CTA c's wrapping 32-bit sum of the 32-bit words of rows c,
    c + n_cta, ... of every block it fetched).  A CUDA tensor launches
    csrc/step_probe.cu (d = 128, contiguous); a CPU tensor runs
    step_probe_reference."""
    _check(q, pool, steps)
    if q.device.type == "cpu":
        return step_probe_reference(q, pool, steps, matmul)
    if q.device.type != "cuda" or pool.device != q.device:
        raise ValueError(f"step_probe runs on cuda or cpu tensors, got "
                         f"{q.device} and {pool.device}")
    bq, d = q.shape[1], q.shape[2]
    if d != KERNEL_DIM:
        raise ValueError(f"step_probe kernel takes d = {KERNEL_DIM}, got {d}")
    for name, t in (("q", q), ("pool", pool)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    n_cta = n_ctas(bq)
    out = torch.empty((1, bq, OUT_COLS), dtype=torch.float32,
                      device=q.device)
    sums = torch.empty(n_cta, dtype=torch.int32, device=q.device)
    lib = _build.load("step_probe")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.step_probe_launch(
            q.data_ptr(), pool.data_ptr(), out.data_ptr(), sums.data_ptr(),
            bq, pool.shape[1], d, pool.shape[0], int(steps), int(matmul),
            n_cta, stream)
    _build.check(err, "step_probe")
    step_probe.launches += 1
    return out, sums.long() & 0xFFFFFFFF


step_probe.launches = 0


def step_probe_reference(q, pool, steps: int, matmul: bool = True):
    """Plain version of the kernel: the block pool[i] is visited
    count_i = |{j < steps : j % n_pool == i}| times, so the product is
    q @ (sum_i count_i pool[i][:w])^T, taken in fp64 and returned as fp32,
    and each CTA's sum is the int64 sum of its rows' 32-bit words (as
    unsigned) times count_i, mod 2^32."""
    _check(q, pool, steps)
    n_pool, bkv, d = pool.shape
    bq = q.shape[1]
    counts = torch.bincount(torch.arange(steps, device=pool.device) % n_pool,
                            minlength=n_pool)
    out = torch.zeros((1, bq, OUT_COLS), dtype=torch.float32,
                      device=q.device)
    if matmul:
        w = min(OUT_COLS, bkv)
        kw = (counts.double()[:, None, None]
              * pool[:, :w].double()).sum(dim=0)               # [w, d]
        out[0, :, :w] = (q[0].double() @ kw.t()).float()
    n_cta = n_ctas(bq)
    words = pool.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    row_sums = words.sum(dim=-1)                                # [n_pool, bkv]
    owner = torch.arange(bkv, device=pool.device) % n_cta
    per_cta = torch.zeros((n_pool, n_cta), dtype=torch.int64,
                          device=pool.device)
    per_cta.index_add_(1, owner, row_sums)
    per_cta = (per_cta & 0xFFFFFFFF) * counts[:, None]
    return out, per_cta.sum(dim=0) & 0xFFFFFFFF


def fit(rows):
    """Least squares of us_per_step = t_fixed + bytes / bw + flops / rate
    over the probe rows (each with bkv, matmul, us_per_step and the dims):
    returns {"t_fixed_us", "gb_per_s", "tflop_per_s", "residuals_us"}.
    A fitted slope <= 0 (no measurable cost) gives None for its rate."""
    a, y = [], []
    for r in rows:
        a.append([1.0, step_bytes(r), step_flops(r)])
        y.append(r["us_per_step"])
    a, y = np.asarray(a), np.asarray(y)
    scale = np.maximum(np.abs(a).max(axis=0), 1e-30)  # condition the columns
    coef, *_ = np.linalg.lstsq(a / scale, y, rcond=None)
    coef = coef / scale
    resid = y - a @ coef

    def rate(c, unit):  # c is microseconds per byte or per operation
        return None if c <= 0 else float(1e6 / c / unit)

    return {"t_fixed_us": float(coef[0]),
            "gb_per_s": rate(coef[1], 1e9),
            "tflop_per_s": rate(coef[2], 1e12),
            "residuals_us": [float(x) for x in resid]}


def step_bytes(row) -> int:
    """Bytes one step must move: its bf16 [bkv, d] block."""
    return row["bkv"] * row["dim"] * 2


def step_flops(row) -> int:
    """Operations of one step's product: 2 * bq * w * d."""
    return (2 * row["bq"] * min(OUT_COLS, row["bkv"]) * row["dim"]
            if row["matmul"] else 0)


def bound_us(row) -> float:
    """The least time one step could take on the card: the larger of its
    bytes over 3.35 TB/s and its operations over the 989 TFLOP/s bf16
    peak."""
    return max(step_bytes(row) / HBM_BYTES_PER_S,
               step_flops(row) / PEAK_BF16_FLOPS) * 1e6


def time_cell(bq, bkv, steps, dim, matmul, device, iters=5, warmup=2):
    """One cell on the card: milliseconds per launch (CUDA events around
    `iters` launches after `warmup`), from seeded inputs."""
    n_pool = min(steps, 512)
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(1, bq, dim, generator=g, device=device).bfloat16()
    pool = torch.randn(n_pool, bkv, dim, generator=g,
                       device=device).bfloat16()
    for _ in range(warmup):
        step_probe(q, pool, steps, matmul)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        step_probe(q, pool, steps, matmul)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, n_pool * bkv * dim * 2


def cell_row(bq, bkv, steps, dim, matmul, ms, pool_bytes, card):
    """A JSON row with the JAX probe's fields (unrounded), the H100 bytes
    term, the L2 verdict, the bound and the card."""
    step_us = ms * 1e3 / steps
    mb = bkv * dim * 2 / 1e6
    row = {"bq": bq, "bkv": bkv, "steps": steps, "matmul": matmul,
           "dim": dim, "ms": ms, "us_per_step": step_us,
           "kv_mb_per_step": mb,
           # residual after the 3.35 TB/s bytes term
           "us_minus_dma": step_us - mb / (HBM_BYTES_PER_S / 1e9) * 1e3,
           "pool_mb": pool_bytes / 1e6,
           "pool_fits_l2": pool_bytes <= L2_BYTES, "card": card}
    row["bound_us_per_step"] = bound_us(row)
    return row


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sweep(bq, dim, kv_blocks, steps_list, matmuls, device, card,
          record=print):
    """Every (matmul, bkv, steps) cell in the JAX probe's order; each row
    goes to `record` as it is measured.  Returns the rows."""
    rows = []
    for matmul in matmuls:
        for bkv in kv_blocks:
            for steps in steps_list:
                ms, pool_bytes = time_cell(bq, bkv, steps, dim, matmul,
                                           device)
                row = cell_row(bq, bkv, steps, dim, matmul, ms, pool_bytes,
                               card)
                record(row)
                rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--bq", type=int, default=2048,
                    help="rows of the resident block the matmul feeds")
    ap.add_argument("--kv-blocks", default="256,1024,2048,4096",
                    help="comma list of kv block heights (bytes scale)")
    ap.add_argument("--steps", default="512,2048,8192",
                    help="comma list of loop lengths (fixed-cost scale)")
    ap.add_argument("--no-matmul", action="store_true",
                    help="only the fetch-only sweep (no product, no fit); "
                         "by default both sweeps run and are fitted")
    ap.add_argument("--out", default="build/step_probe.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_probe: no CUDA device; refusing to record numbers",
              file=sys.stderr)
        return 1
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    card = card_line()
    print(card, flush=True)

    def record(row):
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)

    matmuls = (False,) if args.no_matmul else (True, False)
    rows = sweep(args.bq, args.dim,
                 [int(x) for x in args.kv_blocks.split(",") if x],
                 [int(x) for x in args.steps.split(",") if x], matmuls,
                 torch.device("cuda"), card, record)
    if len({r["matmul"] for r in rows}) == 2:
        print(json.dumps({"fit": fit(rows), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
