"""Time the port's attention kernels of one checkout on the card, for an
A/B of two commits in one call.

    python tools/kernel_ab.py --root PATH --tag NAME [--parts fwd,bwd,...]

imports `burst_attn_tpu_torch` from the checkout at PATH (its kernels
build into PATH/build/kernels), times kernel 1 (causal, B1 N16/4 S2048
and B1 N16 S8192, bf16), the fused backward (kernels 2-3, B1 N16 S8192
bf16 causal), kernel 6 (8 slots, lengths 0-2112, bf16 and int8 pools)
and kernel 7 (the mixed q_lens 0/1/37/128 batch, bf16) with CUDA events
on seeded inputs (`--parts` picks among fwd, bwd, decode and ragged), and
prints one line `AB {json}` with the card.  Run it
from a parent and a change in turns (parent, change, change, parent):
times of two calls may come from two cards.  It uses only arguments that
every port checkout since the ring backward takes.
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
    _build.build_all(list(dict.fromkeys(name for part, name in (
        ("fwd", "flash_fwd"), ("bwd", "flash_fwd"), ("bwd", "flash_bwd"),
        ("decode", "paged_decode"), ("ragged", "ragged_paged"))
        if part in parts)))  # each once: build_all starts one nvcc a name
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

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"tag": args.tag, "card": card}
    if "fwd" in parts:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = r(1, 16, 2048, 128), r(1, 4, 2048, 128), r(1, 4, 2048, 128)
        out["fwd_s2048_ms"] = t_ms(lambda: flash.flash_attention(
            q, k, v, None, True), 40)
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
        del q, k, v, o, do, delta, lse

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
        out["decode_bf16_ms"] = t_ms(lambda: pa.paged_decode_attention(
            qd, kp, vp, table, lens), 100)
        (k8, ks), (v8, vs) = (pa.quantize_tokens(x.float(), dtype=torch.int8)
                              for x in (kp, vp))
        out["decode_int8_ms"] = t_ms(lambda: pa.paged_decode_attention(
            qd, k8, v8, table, lens, k_scales=ks, v_scales=vs), 100)
    if "ragged" in parts:
        ql = torch.tensor((0, 1, 37, 128, 128, 1, 128, 37), dtype=torch.int32,
                          device=dev)
        kl = torch.tensor((0, 2112, 37, 1024, 2048, 1, 700, 1500),
                          dtype=torch.int32, device=dev)
        qr = r(8, 16, 128, 128)
        out["ragged_bf16_ms"] = t_ms(lambda: rp.ragged_paged_attention(
            qr, kp, vp, table, ql, kl), 40)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
