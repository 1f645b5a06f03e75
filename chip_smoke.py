"""Smoke run of the PyTorch/CUDA port (burst_attn_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port still builds and serves on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel)
     and print each instance of kernels 1-5, 8 and 9 with its registers,
     local (spill) bytes, shared memory and resident CTAs (the bf16
     instances of kernels 1-5, 8 and 9 run on mma.sync tensor-core tiles,
     the fp32 ones on the SIMT tiles);
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, with its time, the plain version's time, one
     PyTorch library call's time (a yardstick only, never used by the
     port) and its roofline bound: flash forward, and on the prefix
     cache's suffix mask (t_suf queries padded to the page after t_pre
     cached keys, causal at offset t_pre; bf16 and fp32; timed beside
     SDPA with the same offset mask); paged decode (the
     ragged kernel's QT=1 instance) on bf16, fp32, int8 and fp8 pools;
     the ragged kernel on a mixed prefill + decode batch (fp32, bf16,
     int8, fp8 pools), its split-k partials with a page-aligned ctx_lo
     (fp32 and bf16), and its QT=1 rows bitwise against paged decode; both
     at G = 1, 4, 16 and 64; paged decode at up to 16384 positions (32
     splits); every one of these two launches torch.equal; the paged
     kernels' `ms`, like every row's, times eager calls, and their
     `graph_ms` (SDPA's `library_graph_ms`) the device alone through a
     CUDA graph, since their eager calls time the host; the flash
     backward's fused kernel and split dq + dk/dv pair against tile_bwd
     (fp32 and bf16, MHA and GQA, causal, non-causal, ragged S; the fused
     kernel 20 launches bitwise equal, the split pair 2), autograd through
     flash_attention against autograd through the plain tile; at the
     train step's shape (B1 N16/16 S8192 D128 bf16 causal) the forward
     against tile_fwd/finalize, with its time, bound and SDPA's time
     there, the three backward kernels against tile_bwd (each route
     bitwise repeatable), and their times beside tile_bwd's and SDPA's
     backward; the fused route against the split pair at the train shape
     and at a scan-ring round's (B1 N16 S2048 MHA, causal and a full
     non-causal round);
  4. the ServeEngine at the serving benchmark's width (vocab 32768,
     d_model 2048, 16/4 heads, d_ff 8192; depth cut from its 8 layers to
     4, random weights from a seed): 12 requests over 8 slots in bf16 and fp32, plus a bf16 run
     with plain attention (the noise floor), the fp32 model on an int8
     pool against plain attention, launch counters read around each run,
     greedy tokens teacher-forced through the dense plain forward; the
     prefix cache (`prefix_cache=True`, fp32): a 1024-token template,
     8 requests on it, tokens equal to cache off, every prefill a suffix
     prefill through kernel 1 (launches counted), the cache's pages and
     the pool as the arithmetic says; bf16 TTFT of a 2048-token prompt
     with its first 1024 tokens cached and uncached, profiled;
  5. the RaggedServeEngine at the same width (chunk 128): the same 12
     requests in bf16, fp32 (token-exact with the dense forward and with
     the fp32 ServeEngine) and with plain attention; a prefix-cache wave
     on a 1024-token template (tokens equal to the cache-off run, counter
     values as expected, the pool empty after drain and evict); int8 and
     fp8 pools against plain attention; TTFT of a 2048-token prompt, a
     decode tick and a mixed tick, with a profiler breakdown; then the
     pipelined engine (`pipeline=True`) at K=1 and K=4 (`multi_step`,
     one CUDA graph replay a fused launch): fp32 token-exact with the
     synchronous engine, bf16 equal or flipped at near ties, sampled
     (temperature 0.8, top-k 8) token-exact from the same seed, an EOS
     workload (reconciles), the prefix wave; kernel 7 launched once a
     layer for every tick the device ran; the decode tick at ~2K
     context, synchronous, K=1 and K=4 in turns, with busy shares and
     the graphs' captures and replays; then speculative serving (k=4;
     drafts: the model itself and its first 2 layers, the early exit of
     serve_bench.py --spec-layers 2): kernel 7 at the verify width (QT 2
     and 5 in all 8 slots at ~2K context) against its plain version on
     bf16, fp32, int8 and fp8 pools, timed beside SDPA with the same
     causal mask; `speculative_generate` on the longest prompt (fp32
     self-draft token-exact with `generate`, every proposal accepted;
     bf16 early exit equal or parted at a near tie; fp32 sampled
     self-draft accepting >= 99%); both engines' draft modes on the 12
     requests at half their budgets, 4 of them in slots just retired
     (fp32 self-draft token-exact with the plain fp32 engine at
     acceptance 1, bf16 early exit held to the teacher-forced bar, an
     int8 pool against the plain int8 engine; the ragged engine also
     pipelined and on the prefix wave), every plain paged attention
     refused, launches of kernels 1, 6 and 7 exactly as the rounds say,
     both pools drained; tokens/s of a plain tick, a self-draft round and
     an early-exit round (bf16, 8 slots at ~2K) with busy shares; then
     crash-consistent serving (serving/checkpoint.py), bf16 (fp32's
     recoveries are the fuzz phase's, phase 11): the
     12 requests through the ServeEngine, the synchronous and the
     pipelined (K=4) RaggedServeEngine, and the ragged prefix wave, a
     snapshot mid-run (MB, save ms), a fresh engine restored from it (load
     and restore ms; the pipelined target's decode graph captured before
     the restore, none after) finishing token-exact with the uninterrupted
     run; the two synchronous engines journaled (TokenJournal), killed
     after the snapshot with the journal's last line torn, recovered with
     recover_engine from snapshot + journal (token-exact; replayed tokens
     below the replay-from-scratch count) and from the journal alone (at
     the teacher-forced bar, partings near ties);
     launches of kernels 1, 6, 7 held to each run's admissions and ticks;
     the bf16 decode tick (8 slots at ~2K), synchronous and K=4, with and
     without the journal, and its fsyncs (one a step);
  6. training at the training benchmark's width and depth
     (benchmarks/train_smoke.py: vocab 32768, d_model 2048, 16 layers,
     16/16 heads, d_ff 8192, bf16, remat; 1.21 B parameters from a seed)
     at B=1, S=8192: make_train_step on one batch, launch counters read
     around the timed steps (2 x 16 flash_fwd and 16 fused flash_bwd per
     step), loss finite and falling, step ms, tokens/s, MFU, a profiled
     step, and two steps through the split backward; one step's loss and
     gradients at fp32 (2 layers, S=2048) against plain attention;
     runner.fit on a seeded token file (2 layers, S=2048) with an eval,
     then a checkpoint and a resumed run that repeats its losses; then
     the same model, seed and batch on a ring, mesh {"sp": 4} zigzag,
     through the fused route (kernels 8 and 9: exactly 32 + 16 launches a
     step) and the scan route (512 flash_fwd + 256 flash_bwd), no
     fallback, losses falling and the first two within CONTROL_RTOL of
     the single-device run, step ms, tokens/s, MFU and a profile each;
     fp32 ring parity against the single-device kernels on both routes;
     before the ring step, kernels 8 and 9 held against their plain
     versions at the shape it gives them, with each one's ms a launch and
     a traced kernel-9 launch (bitwise the untraced one) that gives the
     share of its CTAs' time spent waiting on dq fold counters and on
     the ring's counters, and each kernel's STATS instance (collect_stats)
     bitwise the stats-off one and timed beside it in turns off on on off
     (their registers and spills, printed after the build, equal the
     stats-off instances');
     runner.fit on mesh {"sp": 4} (`--mesh sp=4`) with a resume;
  7. (run after phase 3) the ring forward: the fused ring kernel
     (kernel 8) against its plain
     version over W = 2, 3, 4, 8 ring positions on the card (uni, bidi,
     double 2x2 and 2x4; 2 and 3 slots; causal zigzag, striped, contig
     and non-causal; GQA; fp32 and bf16; local S 256-1024; two launches
     torch.equal) and 20 launches at W=8 on two slots bitwise equal; then
     burst_attn at bench.py's headline shape (B1 N32 S65536 D128 bf16,
     causal zigzag, mesh {"sp": 8}): the fused ring against the scan ring
     over kernel 1 (1 fused launch, 64 flash launches, no fallback),
     kernel 8 against its plain version there, with its time, the scan
     route's, the plain version's and SDPA's on the natural-order
     sequence; then the ring backward: kernel 9 against its plain version
     over W = 2-8 (uni, bidi, double 2x2 and 2x4, the truncated contig
     program; 2 and 3 slots; causal zigzag, striped, contig and
     non-causal; both optimize_bwd_comm payloads; GQA; fp32 and bf16;
     resident and not; two launches torch.equal) and 20 launches at W=8
     bitwise; burst_attn forward + backward at the headline shape, fused
     (one launch each of kernels 8 and 9) against scan (64 + 64), no
     fallback, gradients within bf16 tolerance, kernel 9 against its
     plain version there (by head chunks), the times of kernel 9, both
     routes and SDPA's backward;
  8. the long-context handoff at the serving width (after phase 5):
     first its ring kernels at the shapes it gives them (sp=4, N16/4,
     S_local 8192, bf16, causal zigzag; seeded tensors): kernel 8 against
     its plain version, and kernel 1 in each scan-ring round of one
     position against tile_fwd; then a
     32768-token prompt over sp=4 prefilled through kernel 8 and, as the
     control, the scan ring, 32 greedy decode steps through
     dist_paged_decode_step (8 kernel-8 launches, no fallback; bf16: the
     fused stream teacher-forced through the scan route >= 95% with near
     ties only, each route's prefill argmax at all 32768 prompt positions
     against a dense single-device forward >= 95% with near ties only,
     and each route's stream against that forward with near ties only);
     fp32 at 4096 tokens
     token-exact across the routes, with the dense plain forward and
     with paged_decode_step (kernel 6) on the handed-off slot; page
     counts and a rejected request; prefill (TTFT) and decode times;
     kernel 9 against its plain version at the handoff's op shape; the
     handoff's crash consistency (bf16, fused route): half the decode
     through handoff_decode with a journal, a paged snapshot saved,
     loaded and decoded on, and a journal-only recovery after a kill (a
     second prefill, the lag re-decoded), both equal to the uninterrupted
     stream, kernel 8 once a layer a prefill; then the dense-shard
     distributed decode (models/dist_decode.py: dist_prefill,
     dist_decode_step, dist_generate) on the same 32768-token prompt over
     sp=4, bf16, through kernel 8 and the scan ring (launches exact: 8
     kernel-8 launches, or 128 kernel-1 rounds; no fallback; the fused
     stream teacher-forced through the scan route's dist_decode_step at
     the handoff's bar), prefill and decode-step times (wall; device from
     the profiler); fp32 at 4096 tokens token-exact across the routes and
     with handoff_generate's stream; then the ring telemetry:
     burst_attn(collect_stats=True) at the handoff's op shape on both
     routes (outputs bitwise those of stats off, kernel 8's slot_use the
     slot schedule's bincount, equal attn_pairs sums) and kernel 9's
     direct collect_stats call (bitwise; bundle counts the backward
     program's); then the obs package on the engines (6 of the 12
     requests, bf16): the synchronous and the K=4 RaggedServeEngine and
     the ServeEngine with request tracing on, counters equal to the
     admission and tick arithmetic (K=4 equal to synchronous), every
     TTFT breakdown summing to its TTFT, the exported JSONL rendered by
     `python -m burst_attn_tpu_torch.obs` (--json, --prom, --trace), the
     instruments' host cost a tick; then serving under load (the `fleet`
     phase, the serving model at 2 layers, every worker process on the
     card, all loading one weights file): the seed-0 trace (24 requests,
     2 poison) replayed open-loop through a RaggedServeEngine in fp32
     (token-exact with `oracle_replay`) and bf16 (the teacher-forced bar)
     with its SLO report and kernel 7 once a layer a ragged launch; the
     LoadGenCluster of 2 ServeEngine workers (fp32, journaled) through a
     kill and a restart, then the kill with resume off (token-exact, the
     resume re-decoding strictly fewer tokens), recovery and boot
     seconds; the FleetCluster of 1 prefill worker (sp=2, kernel 8) and 2
     decode replicas (sp=2): fp32 over queues with a replica dying after
     its first received page and the other restarted mid-stream
     (token-exact with `fleet_oracle`), bf16 over sockets (digests equal
     on both ends, the near-tie bar); zero pages left in any pool, KV MB
     and ms a page, TTFT; each worker life's reported kernel launches
     held to its own work counters;
  9. (run after phase 3) sliding-window serving and kernel 10: kernel 1
     with windows 1, 100, 1024 and 4096 (>= S: bitwise the unwindowed
     kernel) at B1 N16/4 S2048 bf16, offset 0 and -1 with a ragged
     kv_hi; kernel 6 with windows 64, 1024, 3000 on bf16, int8 and fp8
     pools (its QT=1 ragged rows bitwise; 3000, above every length,
     bitwise the unwindowed kernel); kernel 7 with windows 64, 1024 and
     4096 (bitwise the unwindowed kernel) on the mixed batch and the
     grouped shared-prefix launch (a
     prefix wholly below the band adds nothing, no NaN); each two launches
     torch.equal, timed beside its plain version, SDPA with the band and
     its bound; kernel 10 (the step-overhead probe) against its plain
     version at bq 2048 (bkv 128-4096, 8 and 512 steps, with and without
     the product, fetch checksums equal), then bench.step_probe's sweep
     (bkv 256-4096 x steps 512-8192, both variants) and its least-squares
     fit; (after phase 5) the serving model with window 1024 (layout
     contig): both engines in fp32 (token-exact with the dense windowed
     forward and with each other) and bf16 (>= 95%, near ties only),
     launch counts around each run, `generate` on a 2048-token prompt
     (token-exact, fp32), an int8 pool through the ragged engine against
     plain attention, the last-position logits with and without the
     window (equal within the window, apart beyond it), and both engines'
     decode ticks beside the unwindowed ones;
 10. (after the packed segments) windowed training: kernels 2-5's WIN
     instances against tile_bwd(window=) (bf16 and fp32, both routes,
     windows 1, 40, 200, 300, GQA, ragged S; window >= S bitwise the
     instances without WIN; with packed segments), kernels 8-9's on the
     windowed contig ring's truncated program (r_live rounds, the ring
     step's shape and a band across two shards, with segments; kernel
     8's STATS instance reporting the truncation), all two launches
     torch.equal, and their times at the train shape / the ring step
     beside the causal launch, the plain versions, SDPA with the band
     mask and the band's bound; bench/window_bench.py once; the windowed
     `dist_generate` (window 1024, 32768 tokens over sp=4 bf16 on both
     routes: the teacher-forced bar, prefill and decode ms; fp32 at 4096
     token-exact with the dense windowed `generate`); the windowed train
     step on one card and on a contig ring of 4 (both routes: exact WIN
     launches, losses against plain attention under the band and one
     device, fp32 parity at 2 layers); `[t s]` marks give the seconds
     since the start after each group of phases;
 11. (after the fleet phase) the analyzer (burst_attn_tpu_torch.analysis)
     in-process: its 30 rules' CPU families and card halves, zero
     findings — every HMMA of every built library's SASS on an F32
     accumulator; the ring (scan and fused routes, stats on and off),
     the serve steps, the K=4 decode graphs, the K=1 tick and the ragged
     launch under sync-debug "error", the steps and launches captured in
     CUDA graphs whose nodes (listed by the CUDA driver API) are kernels,
     memsets and device copies only, the K=1 replay equal to the eager
     tick; every planned kernel instance's shared memory equal to
     cudaFuncGetAttributes', <= 227 KB, at the CTAs an SM the plan
     assumes; fused-ring-fused on the card's fused route (zero
     rotations, one launch a pass, kernel 8's slot counters the
     program's); the measured times of kernels 8-9 at the headline and
     6-7 at their decode shapes beside the cost model's h100 floors (none
     under 0.95 x); the simulator calibrated from the fleet phase's bf16
     run (fidelity within SIM_FIDELITY_RTOL) beside the cost table's
     h100 rates; then the crash-recovery fuzzer (tools/fuzz_checkpoint.py)
     in-process at the serving width (2 layers, fp32): a sync seed
     through both engines (snapshot + journal and journal-only recovery),
     a prefix-cache seed (mid-CoW, mid-admission, mid-scale-scatter on an
     fp8 pool: killed between a token's bytes and its scales), a pipelined
     seed (mid-flight, mid-multi-step-scan, mid-readback) and two
     transport seeds, every mode exact, killed and leak-free, with its
     kernel 7 / 1 / 6 launches;
 12. (after the mesh2 phase, beside which its processes boot) the run
     across processes: two processes on the one card (utils/multihost.
     spawn, gloo over tcp://127.0.0.1, the CUDA payloads staged through
     pinned host buffers): burst_attn
     forward and backward on inter=2 (the processes) x intra=2 at the
     ring train step's shard (B1 N16 S_local 2048 D128 bf16 causal
     zigzag), the fused backend declined and counted, against the
     one-process scan ring (bitwise expected, gated at the ring phases'
     bf16 tolerances), its ms and the ms each prefetched inter hop
     waited after its intra cycle; the dp=2 (the processes) x sp=2 train
     step at the training width (4 layers, S 8192, a row a process) from
     the seed weights, every loss and the first step's gradients against
     the one-process dp=2 x sp=2 step (MESH_TRAIN_RTOL / MESH_GRAD_RTOL,
     bitwise expected), step and staging ms; `runner --multihost --mesh
     dp=2,sp=2` (1 layer at the training width): a checkpoint written by
     rank 0 alone while the other waits, and a resume in both; a child that fails or
     times out fails the run;
 13. a `train` JSON line, a `kernels` JSON line, then the result line
     {"ok": true, "device": {...}} last.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

import atexit
import contextlib
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), from the
# cost model's h100 row, the one source of the port's roofline
from burst_attn_tpu_torch.analysis.costmodel import HW

PEAK_BF16_FLOPS = HW["h100"].peak_flops
PEAK_HBM_BYTES = HW["h100"].hbm_bw

# the serving benchmark's model (benchmarks/serve_bench.py defaults) at
# its full width; depth cut from 8 layers to 4 so that the smoke, with
# the windowed-training phases, stays within ~660 s (every serving phase
# is host-bound with a cost a layer: at 8 layers the smoke took 767 s on
# an H100 80GB HBM3 at 700 W whose host ran the serving ticks ~50%
# slower than the fastest host seen)
SERVE_DIMS = dict(vocab=32768, d_model=2048, n_layers=4, n_heads=16,
                  n_kv_heads=4, d_head=128, d_ff=8192)
SLOTS, N_PAGES, PAGE, MAX_PAGES = 8, 160, 128, 17
CHUNK = 128
N_REQUESTS = 12
OBS_REQUESTS = 6  # the obs phase's share of the seeded requests

# kernel-vs-plain tolerances, scaled to the values compared.  Both sides
# compute in fp32 and differ only in summation order and exp2-vs-exp (and,
# on 1-byte pools, where the per-token scale multiplies), so an fp32 run
# differs by rounding alone; in bf16 each side rounds its output once, so
# they may differ by up to two bf16 ulps (2 * 2^-7 relative), with an
# absolute floor for outputs near zero.  The checks run at both dtypes:
# fp32 catches a small fault (one page of a long context skipped moves
# |o| ~ 0.03 outputs by ~4e-2) that bf16 rounding could hide.
O_TOL = {"bf16": dict(atol=2e-3, rtol=1.6e-2),
         "fp32": dict(atol=1e-5, rtol=1e-4)}
STATS_ATOL = {"bf16": 1e-3, "fp32": 1e-4}  # m, lse (always fp32)
ACC_RTOL = 1e-4     # raw fp32 accumulator, relative to its largest entry
# Greedy tokens vs the dense plain forward, teacher-forced.  In bf16 the
# engine's per-token decode matmuls and incremental K/V round differently
# from one dense pass, which flips near-tied argmaxes: with the kernels
# swapped for their plain versions (the control runs below) the engine
# agreed at 97.2% (559/575) on an H100.  So bf16 requires >= 95% AND every
# disagreement to be a near tie (reference logit gap <= TIE_GAP; logits
# have std ~0.9 here, a real fault gives O(1) gaps); fp32 at the same
# width must agree token for token.  A quantized pool is held to the same
# engine with plain attention: token-exact, or a flip at a near tie of
# the dense forward.
MIN_AGREE_BF16 = 0.95
TIE_GAP = 0.1

# Backward kernels vs tile_bwd: both compute in fp32 from the same inputs
# (bf16 inputs widen exactly) and differ only in summation order and
# exp2-vs-exp, so each of dq, dk, dv must agree to fp32 rounding relative
# to its largest entry: max-abs error <= BWD_RTOL * max|ref| + BWD_ATOL.
BWD_RTOL, BWD_ATOL = 1e-4, 1e-6
# launches of the fused backward on each check case, all bitwise equal:
# its CTAs take their kv tile from a start-order ticket, and the dq fold
# order must not depend on the dispatch order; the split pair sums without
# atomics, and its second launch must be bitwise equal too
FUSED_BWD_REPEATS = 20
SPLIT_BWD_REPEATS = 2
# the training benchmark's model (benchmarks/train_smoke.py defaults: MHA,
# remat, bf16, one device); its sequence is cut from 32768 to 8192, where
# a step of the first SIMT kernels takes ~1 s instead of ~15-20 s
TRAIN_DIMS = dict(vocab=32768, d_model=2048, n_layers=16, n_heads=16,
                  n_kv_heads=16, d_head=128, d_ff=8192)
TRAIN_SEQ = 8192
TRAIN_STEPS = 3  # timed, after one warm-up step
# One step's loss and gradients, kernels vs plain attention, fp32 at full
# width: the attention outputs differ by fp32 rounding (~1e-7 relative)
# and every later op is the same on both sides, so the loss must agree to
# LOSS_RTOL and each gradient to GRAD_RTOL of its largest entry; a skipped
# tile or a wrong scale moves them by >1e-2.
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
# Resumed vs uninterrupted fit losses: the embedding's backward sums with
# CUDA atomics, whose order changes the bf16 gradients' last bits from run
# to run, so steps after the checkpoint agree closely but not bitwise.
RESUME_RTOL = 1e-3
# The bf16 training run vs the same run with plain attention: the two
# round attention outputs and gradients to bf16 at different points, so
# the first loss (the forward) and the second (after one update) agree to
# bf16 rounding, not bitwise; later steps drift apart as rounding grows.
CONTROL_RTOL = 1e-2


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


def graph_ms(fn, calls=20, replays=10):
    """Mean device milliseconds per call of `fn` with the host out of the
    way: `calls` calls captured into one CUDA graph, replayed `replays`
    times between CUDA events.  The paged kernels run for microseconds,
    less than their wrappers take on the host, so time_ms around eager
    calls times the host: their rows and SDPA's beside them report this
    as `graph_ms` / `library_graph_ms` beside `ms`."""
    import torch

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
    return time_ms(graph.replay, iters=replays, warmup=2) / calls


def host_ms(fn, repeats=3):
    """Median host milliseconds of `fn`, synchronized on both sides."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = n_flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_breakdown(fn, n_calls, top=6):
    """Profile `n_calls` calls of `fn` with torch.profiler: returns (wall
    ms per call, device ms per call, [(kernel name, device ms per call)]
    of the `top` kernels by device time).  Only the device's own events
    (kernels, copies, fills) are summed: a CPU op's row repeats the device
    time of the kernels it launched, and a user annotation's device row
    (`Optimizer.step#AdamW.step`) spans kernels counted already."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_calls
    rows = [(e.key, e.self_device_time_total / 1e3 / n_calls)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(t for _, t in rows), [(k[:60], t) for k, t in rows[:top]]


def print_profile(what, prof):
    wall, dev, top = prof
    print(f"profile {what}: wall {wall:.2f} ms, device {dev:.2f} ms "
          f"(busy {dev / wall:.2f}); top kernels (ms): "
          + "; ".join(f"{k} {t:.3f}" for k, t in top), flush=True)


def _max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _obs_now():
    """The obs registry's counters now ({"name{k=v,...}": value})."""
    from burst_attn_tpu_torch import obs

    return obs.counter_values()


def _obs_since(before):
    """The obs counters that moved since `before` (an _obs_now())."""
    from burst_attn_tpu_torch import obs

    return obs.counter_deltas(before)


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
        print(f"flash_fwd {key} {name}: N{n}/{n_kv} S={sl} "
              f"max_abs_err={err:.3e} "
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


def time_flash_train(device):
    """Kernel 1 at the train step's shape (B1 N16/16 S8192 D128 bf16
    causal), where a step launches it 32 times (forward and remat): its
    time through flash_attention, its bound and SDPA's time, as a dict
    for kernel 1's record."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash

    n, s, d = TRAIN_DIMS["n_heads"], TRAIN_SEQ, TRAIN_DIMS["d_head"]
    g = torch.Generator(device=device).manual_seed(12)
    q, k, v = (torch.randn(1, n, s, d, generator=g, device=device).to(
        torch.bfloat16) for _ in range(3))
    ms = time_ms(lambda: flash.flash_attention(q, k, v, None, True),
                 iters=10, warmup=2)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=10, warmup=2)
    pairs = s * (s + 1) // 2
    n_bytes = q.element_size() * 4 * q.numel() + 4 * 2 * n * s
    bms, by = bound_ms(n_bytes, 4 * pairs * n * d)
    print(f"flash_fwd at the train shape B1 N{n}/{n} S={s} D{d} bf16 "
          f"causal: {ms:.4f} ms (SDPA {lib_ms:.4f}, bound {bms:.4f} by "
          f"{by})", flush=True)
    return dict(shape=f"B1 N{n}/{n} S{s} D{d} bf16 causal", ms=ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)


def _pool(g, device, dtype, quant, n_pages, n_kv, page, d):
    """Random k/v pools in `dtype`, or quantized to `quant` ("int8" /
    "fp8") with their per-token scales."""
    import torch

    from burst_attn_tpu_torch.ops import paged_attention as pa

    k, v = (torch.randn(n_pages, n_kv, page, d, generator=g, device=device)
            for _ in range(2))
    if quant is None:
        return k.to(dtype), v.to(dtype), None, None
    qdt = pa.QUANT_DTYPES[quant][0]
    (k8, ks), (v8, vs) = (pa.quantize_tokens(x, dtype=qdt) for x in (k, v))
    return k8, v8, ks, vs


def _table(seed, lengths, n_pages, page, width, device):
    """Distinct random pages per slot, enough for each slot's length."""
    import numpy as np
    import torch

    free = list(np.random.default_rng(seed).permutation(n_pages - 1) + 1)
    table = np.zeros((len(lengths), width), np.int32)
    for i, ln in enumerate(lengths):
        for c in range(-(-ln // page)):
            table[i, c] = free.pop()
    return torch.from_numpy(table).to(device)


# the paged decode kernel's check batch: 8 slots of ragged lengths
PAGED_LENGTHS = (0, 1, 128, 2112, 2048, 1000, 129, 1536)


def check_paged_decode(device, n_kv=4, group=4, d=128, page=PAGE,
                       lengths=PAGED_LENGTHS,
                       n_pages=N_PAGES, width=MAX_PAGES, dtype=None,
                       quant=None, seed=0, timing=True):
    """paged_decode_attention against paged_decode_reference on the card
    at 8 slots with ragged lengths, on a pool in q's dtype or quantized.
    Returns the kernels-line record, or with `timing` False the max-abs
    error (and, on a quantized pool, the kernel's ms)."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import paged_attention as pa

    dtype = dtype or torch.bfloat16
    slots = len(lengths)
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(slots, n_kv, group, d, generator=g,
                    device=device).to(dtype)
    kp, vp, ks, vs = _pool(g, device, dtype, quant, n_pages, n_kv, page, d)
    table = _table(seed, lengths, n_pages, page, width, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)

    def kernel():
        return pa.paged_decode_attention(q, kp, vp, table, lens,
                                         k_scales=ks, v_scales=vs)

    o = kernel()
    assert torch.equal(o, kernel()), "paged_decode: two launches differ"
    want = pa.paged_decode_reference(q, kp, vp, table, lens, k_scales=ks,
                                     v_scales=vs)
    err = _check_o(f"paged_decode {quant or ''}", o, want, dtype)
    for i, ln in enumerate(lengths):
        assert ln or (o[i] == 0).all(), "an empty slot must give zeros"
    key = _dtype_key(dtype)
    print(f"paged_decode {key} pool={quant or key} lengths={list(lengths)} "
          f"max_abs_err={err:.3e} (tolerance {O_TOL[key]}); two launches "
          "torch.equal", flush=True)
    if quant is not None and timing:
        ms = graph_ms(kernel)
        print(f"paged_decode {key} pool={quant}: {ms:.4f} ms", flush=True)
        return err, ms
    if not timing:
        return err

    ms = time_ms(kernel)
    dev_ms = graph_ms(kernel)
    plain_ms = time_ms(
        lambda: pa.paged_decode_reference(q, kp, vp, table, lens), iters=5)
    # the library yardstick: SDPA over the cache gathered to dense
    idx = table.long()
    kd = kp[idx].movedim(2, 1).reshape(slots, n_kv, width * page, d)
    vd = vp[idx].movedim(2, 1).reshape(slots, n_kv, width * page, d)
    qd = q.reshape(slots, n_kv * group, 1, d)
    mask = (torch.arange(width * page, device=device)[None, :]
            < lens[:, None])[:, None, None, :]
    def lib():
        return F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                              enable_gqa=True)

    lib_ms, lib_dev_ms = time_ms(lib), graph_ms(lib)
    # what the function must move: the K/V of the live positions, q of the
    # non-empty slots (an empty slot's zeros need no q), every output row,
    # the table entries of the live pages, the lengths
    live = int(sum(lengths))
    esz = q.element_size()
    q_bytes = esz * n_kv * group * d * sum(ln > 0 for ln in lengths)
    n_bytes = (esz * (2 * live * n_kv * d + q.numel()) + q_bytes
               + 4 * (sum(-(-ln // page) for ln in lengths) + slots))
    bms, by = bound_ms(n_bytes, 4 * live * n_kv * group * d)
    print(f"paged_decode bf16 {slots} slots: {ms:.4f} ms a call timing "
          f"eager calls ({dev_ms:.4f} on the device, CUDA graph), plain "
          f"{plain_ms:.4f}, SDPA on the gathered cache {lib_ms:.4f} "
          f"({lib_dev_ms:.4f}), bound {bms:.5f} by {by}", flush=True)
    return dict(name="paged_decode", route="cuda",
                source="burst_attn_tpu_torch/csrc/ragged_paged.cu",
                replaces="burst_attn_tpu/ops/paged_attention.py:56",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, graph_ms=dev_ms,
                library_graph_ms=lib_dev_ms)


# the ragged kernel's check batch at the serving shapes: idle, decode at
# the longest context, a first chunk shorter than a page, a full chunk
# ending exactly on a page edge (1024), a full chunk at 2K, a decode of a
# 1-token sequence, a full chunk mid-page, a short tail chunk
RAGGED_Q_LENS = (0, 1, 37, 128, 128, 1, 128, 37)
RAGGED_KV_LENS = (0, 2112, 37, 1024, 2048, 1, 700, 1500)


def _ragged_case(device, dtype, quant, seed, n_kv=4, group=4, d=128,
                 page=PAGE, n_pages=N_PAGES, width=MAX_PAGES,
                 q_lens=RAGGED_Q_LENS, kv_lens=RAGGED_KV_LENS, qt=CHUNK):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    slots = len(q_lens)
    q = torch.randn(slots, n_kv * group, qt, d, generator=g,
                    device=device).to(dtype)
    kp, vp, ks, vs = _pool(g, device, dtype, quant, n_pages, n_kv, page, d)
    table = _table(seed, kv_lens, n_pages, page, width, device)
    ql, kl = (torch.tensor(x, dtype=torch.int32, device=device)
              for x in (q_lens, kv_lens))
    return q, kp, vp, table, ql, kl, ks, vs


def check_ragged(device, dtype, quant=None, seed=1, timing=False):
    """ragged_paged_attention against ragged_paged_reference on the mixed
    batch; with `timing`, the kernels-line record (times, SDPA yardstick
    over the gathered cache with a causal-band mask, bound from this
    batch's live positions and visible pairs)."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import ragged_paged as rp

    q, kp, vp, table, ql, kl, ks, vs = _ragged_case(device, dtype, quant,
                                                    seed)
    kw = dict(k_scales=ks, v_scales=vs)

    def kernel():
        return rp.ragged_paged_attention(q, kp, vp, table, ql, kl, **kw)

    o = kernel()
    assert torch.equal(o, kernel()), "ragged_paged: two launches differ"
    want = rp.ragged_paged_reference(q, kp, vp, table, ql, kl, **kw)
    err = _check_o(f"ragged {quant or ''}", o, want, dtype)
    assert (o[0] == 0).all() and (o[2, :, 37:] == 0).all(), \
        "idle slots and padding rows must give zeros"
    key = _dtype_key(dtype)
    print(f"ragged_paged {key} pool={quant or key} q_lens="
          f"{list(RAGGED_Q_LENS)} kv_lens={list(RAGGED_KV_LENS)} "
          f"max_abs_err={err:.3e} (tolerance {O_TOL[key]}); two launches "
          "torch.equal", flush=True)
    if not timing:
        return err
    ms = time_ms(kernel)
    dev_ms = graph_ms(kernel)
    plain_ms = time_ms(lambda: rp.ragged_paged_reference(
        q, kp, vp, table, ql, kl, **kw), iters=5)
    slots, n_q, qt, d = q.shape
    n_kv, page, width = kp.shape[1], kp.shape[2], table.shape[1]
    idx = table.long()
    kd = kp[idx].movedim(2, 1).reshape(slots, n_kv, width * page, d)
    vd = vp[idx].movedim(2, 1).reshape(slots, n_kv, width * page, d)
    t = torch.arange(qt, device=device)
    qp = (kl - ql).long()[:, None] + t[None, :]
    real = t[None, :] < ql[:, None]
    col = torch.arange(width * page, device=device)
    mask = (col[None, None, :] <= qp[:, :, None]) & real[:, :, None]
    mask[:, :, 0] |= ~real  # padding rows see one column (no NaN rows)
    def lib():
        return F.scaled_dot_product_attention(q, kd, vd,
                                              attn_mask=mask[:, None],
                                              enable_gqa=True)

    lib_ms, lib_dev_ms = time_ms(lib), graph_ms(lib)
    pairs = n_q * sum(q_len * (kv - q_len) + q_len * (q_len + 1) // 2
                      for q_len, kv in zip(RAGGED_Q_LENS, RAGGED_KV_LENS))
    # what the function must move: the K/V of the live positions once per
    # (slot, kv head), q of the real tokens only (padding rows and idle
    # slots give zeros without it), every output row, the table entries of
    # the live pages, q_lens and kv_lens
    live = sum(RAGGED_KV_LENS)
    token_bytes = kp.element_size() * d + (4 if ks is not None else 0)
    n_bytes = (2 * live * n_kv * token_bytes
               + q.element_size() * n_q * d * sum(RAGGED_Q_LENS)
               + q.element_size() * q.numel()
               + 4 * (sum(-(-kv // page) for kv in RAGGED_KV_LENS)
                      + 2 * slots))
    bms, by = bound_ms(n_bytes, 4 * pairs * d)
    print(f"ragged_paged bf16 mixed batch: {ms:.4f} ms a call timing eager "
          f"calls ({dev_ms:.4f} on the device, CUDA graph), plain "
          f"{plain_ms:.4f}, SDPA {lib_ms:.4f} ({lib_dev_ms:.4f}), bound "
          f"{bms:.5f} by {by}", flush=True)
    return dict(name="ragged_paged", route="cuda",
                source="burst_attn_tpu_torch/csrc/ragged_paged.cu",
                replaces="burst_attn_tpu/ops/ragged_paged.py:57",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, graph_ms=dev_ms,
                library_graph_ms=lib_dev_ms)


def check_ragged_partials(device, dtype, seed=2):
    """emit_partials with a page-aligned ctx_lo against the plain
    partials: the same -inf rows, acc / m / l within rounding (fp32:
    ACC_RTOL-scale; bf16 q: the tensor-core tile's bf16 p, O_TOL's rtol on
    acc and l, STATS_ATOL on m); two launches torch.equal."""
    import torch

    from burst_attn_tpu_torch.ops import ragged_paged as rp

    q, kp, vp, table, ql, kl, _, _ = _ragged_case(device, dtype, None, seed)
    lo = torch.tensor([0, 1024, 0, 512, 1024, 0, 256, 1408],
                      dtype=torch.int32, device=device)
    got = rp.ragged_paged_attention(q, kp, vp, table, ql, kl, ctx_lo=lo,
                                    emit_partials=True)
    again = rp.ragged_paged_attention(q, kp, vp, table, ql, kl, ctx_lo=lo,
                                      emit_partials=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "partials: two launches differ"
    want = rp.ragged_paged_partials_reference(q, kp, vp, table, ql, kl,
                                              ctx_lo=lo)
    key = _dtype_key(dtype)
    errs = []
    for a, b, what in zip(got, want, ("acc", "m", "l")):
        assert torch.equal(torch.isinf(a), torch.isinf(b)), what
        fin = torch.isfinite(b)
        errs.append(_max_err(a[fin], b[fin]))
        if key == "fp32":
            torch.testing.assert_close(a[fin], b[fin], atol=1e-4, rtol=1e-5,
                                       msg=lambda m: f"partials {what}: {m}")
        elif what == "acc":  # the raw accumulator, to its largest entry
            assert errs[-1] <= ACC_RTOL * float(b.abs().max()), (what, errs)
        elif what == "m":
            assert errs[-1] <= STATS_ATOL[key], (what, errs)
        else:
            torch.testing.assert_close(a[fin], b[fin], atol=0.0,
                                       rtol=ACC_RTOL)
    tol = ("atol 1e-4 rtol 1e-5" if key == "fp32" else
           f"acc {ACC_RTOL} of its largest entry, m {STATS_ATOL[key]}, "
           f"l rtol {ACC_RTOL}")
    print(f"ragged_paged partials {key} ctx_lo={lo.tolist()}: max_abs_err "
          f"acc {errs[0]:.3e} m {errs[1]:.3e} l {errs[2]:.3e} "
          f"(tolerance {tol}); two launches torch.equal", flush=True)


def check_ragged_decode_rows(device, dtype, quant=None, seed=3):
    """A QT=1 batch through the ragged kernel is bitwise the paged decode
    kernel's output on the same pool."""
    import torch

    from burst_attn_tpu_torch.ops import paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp

    lengths = (0, 1, 128, 2112, 2048, 1000, 129, 1536)
    n_kv, group, d = 4, 4, 128
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(len(lengths), n_kv, group, d, generator=g,
                    device=device).to(dtype)
    kp, vp, ks, vs = _pool(g, device, dtype, quant, N_PAGES, n_kv, PAGE, d)
    table = _table(seed, lengths, N_PAGES, PAGE, MAX_PAGES, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    dec = pa.paged_decode_attention(q, kp, vp, table, lens, k_scales=ks,
                                    v_scales=vs)
    rag = rp.ragged_paged_attention(
        q.reshape(len(lengths), n_kv * group, 1, d), kp, vp, table,
        (lens > 0).to(torch.int32), lens, k_scales=ks, v_scales=vs)
    assert torch.equal(rag.reshape(dec.shape), dec), \
        f"QT=1 ragged rows differ from paged decode ({dtype}, {quant})"
    print(f"ragged_paged QT=1 {_dtype_key(dtype)} pool={quant or 'same'}: "
          "torch.equal to paged_decode", flush=True)


GROUPS = (1, 4, 16, 64)  # query heads a kv head (Nq 64 over 64 / G)


def check_ragged_groups(device):
    """Both paths of csrc/ragged_paged.cu at G = 1, 4, 16 and 64 query
    heads a kv head: the mixed batch through ragged_paged_attention (at G
    64 each block is one token of 64 rows, so its decode slots take the
    prefill tile) and a one-token-a-slot batch at the same lengths through
    paged_decode_attention, bf16 and fp32, against the plain versions at
    O_TOL, two launches torch.equal each."""
    import torch

    from burst_attn_tpu_torch.ops import paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp

    worst = 0.0
    for group in GROUPS:
        n_kv = 64 // group
        for dtype in (torch.bfloat16, torch.float32):
            q, kp, vp, table, ql, kl, _, _ = _ragged_case(
                device, dtype, None, seed=50 + group, n_kv=n_kv, group=group)
            o = rp.ragged_paged_attention(q, kp, vp, table, ql, kl)
            assert torch.equal(o, rp.ragged_paged_attention(
                q, kp, vp, table, ql, kl)), f"ragged G={group} repeat"
            err = _check_o(f"ragged G={group}", o, rp.ragged_paged_reference(
                q, kp, vp, table, ql, kl), dtype)
            qd = q[:, :, 0].reshape(len(RAGGED_Q_LENS), n_kv, group,
                                    q.shape[-1]).contiguous()
            od = pa.paged_decode_attention(qd, kp, vp, table, kl)
            assert torch.equal(od, pa.paged_decode_attention(
                qd, kp, vp, table, kl)), f"paged_decode G={group} repeat"
            errd = _check_o(f"paged_decode G={group}", od,
                            pa.paged_decode_reference(qd, kp, vp, table, kl),
                            dtype)
            worst = max(worst, err, errd)
            print(f"ragged_paged / paged_decode {_dtype_key(dtype)} G={group} "
                  f"(Nkv {n_kv}): max_abs_err {err:.3e} / {errd:.3e} "
                  f"(tolerance {O_TOL[_dtype_key(dtype)]}); two launches "
                  "torch.equal", flush=True)
        del q, kp, vp
        torch.cuda.empty_cache()
    return worst


# a decode batch long enough for many splits: a 128-page table is cut into
# 32 splits of 512 positions
LONG_LENGTHS = (16384, 16000, 12345, 8192, 4097, 1, 0, 2112)
LONG_WIDTH = 128


def check_decode_long(device, n_kv=4, group=4, d=128):
    """Kernel 6 on 8 slots of up to 16384 positions (32 splits merged in
    split order), bf16 and fp32 pools and bf16 q on an int8 pool, against
    paged_decode_reference at O_TOL, two launches torch.equal; the bf16
    batch's device time beside SDPA's on the gathered cache."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import paged_attention as pa

    n_pages = sum(-(-ln // PAGE) for ln in LONG_LENGTHS) + 1
    table = _table(7, LONG_LENGTHS, n_pages, PAGE, LONG_WIDTH, device)
    lens = torch.tensor(LONG_LENGTHS, dtype=torch.int32, device=device)
    slots = len(LONG_LENGTHS)
    worst = 0.0
    for dtype, quant in ((torch.bfloat16, None), (torch.float32, None),
                         (torch.bfloat16, "int8")):
        g = torch.Generator(device=device).manual_seed(61)
        q = torch.randn(slots, n_kv, group, d, generator=g,
                        device=device).to(dtype)
        kp, vp, ks, vs = _pool(g, device, dtype, quant, n_pages, n_kv, PAGE,
                               d)
        kw = dict(k_scales=ks, v_scales=vs)
        o = pa.paged_decode_attention(q, kp, vp, table, lens, **kw)
        assert torch.equal(o, pa.paged_decode_attention(
            q, kp, vp, table, lens, **kw)), "long decode: two launches differ"
        what = f"paged_decode {_dtype_key(dtype)} pool={quant or 'same'} long"
        err = _check_o(what, o, pa.paged_decode_reference(
            q, kp, vp, table, lens, **kw), dtype)
        assert (o[6] == 0).all(), "an empty slot must give zeros"
        worst = max(worst, err)
        print(f"{what}: lengths {list(LONG_LENGTHS)} (table {LONG_WIDTH} "
              f"pages), max_abs_err={err:.3e} (tolerance "
              f"{O_TOL[_dtype_key(dtype)]}); two launches torch.equal",
              flush=True)
        if dtype == torch.bfloat16 and quant is None:
            ms = graph_ms(lambda: pa.paged_decode_attention(
                q, kp, vp, table, lens))
            idx = table.long()
            kd = kp[idx].movedim(2, 1).reshape(slots, n_kv, -1, d)
            vd = vp[idx].movedim(2, 1).reshape(slots, n_kv, -1, d)
            mask = (torch.arange(kd.shape[2], device=device)[None, :]
                    < lens[:, None])
            mask[:, 0] = True  # an empty slot's row attends one column
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                q.reshape(slots, n_kv * group, 1, d), kd, vd,
                attn_mask=mask[:, None, None], enable_gqa=True))
            n_bytes = 2 * 2 * sum(LONG_LENGTHS) * n_kv * d
            print(f"paged_decode bf16 long batch: {ms:.4f} ms a call on the "
                  f"device (CUDA graph), SDPA on the gathered cache "
                  f"{lib_ms:.4f}, K/V bytes bound "
                  f"{bound_ms(n_bytes, 0)[0]:.5f}", flush=True)
            del kd, vd
        del kp, vp
    return worst


def _bwd_inputs(device, dtype, n, n_kv, s, causal, seed, b=1, d=128,
                window=None, segs=None):
    """(do, q, k, v, delta, lse, scale, spec) of one backward round:
    random q, k, v, do; lse and o from the forward kernel (with `window`
    and `segs`, its WIN / SEG instance); delta = sum(o * do) in fp32, as
    flash_attention's backward computes it."""
    import torch

    from burst_attn_tpu_torch.ops import flash, masks

    g = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn(b, n, s, d, generator=g, device=device).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, n_kv, s, d, generator=g, device=device).to(dtype)
            for _ in range(2))
    spec = masks.round_spec(0, 0, s, s, causal, "contig")
    scale = d**-0.5
    _, lse, o = flash.flash_fwd(q, k, v, None, None, None, scale, spec,
                                window=window, segments=segs, emit_o=True)
    delta = (o.float() * do.float()).sum(-1)
    return do, q, k, v, delta, lse, scale, spec


def _bwd_errs(got, want, what, scale=None):
    """Assert (dq, dk, dv) match the plain ones within BWD_RTOL of each
    one's largest entry (or of `scale`) + BWD_ATOL; returns the three
    max-abs errors."""
    errs = []
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        err = _max_err(a, b)
        tol = BWD_RTOL * (float(b.abs().max()) if scale is None
                          else scale) + BWD_ATOL
        assert err <= tol, f"{what} {name}: max-abs err {err:.3e} > {tol:.3e}"
        errs.append(err)
    return errs


# (name, heads, kv heads, S, causal, routes): fused (None) and split (False)
BWD_CASES = (("MHA causal", 16, 16, 2048, True, (None, False)),
             ("GQA causal", 16, 4, 2048, True, (None, False)),
             ("GQA non-causal", 16, 4, 2048, False, (None,)),
             ("GQA causal ragged", 16, 4, 2000, True, (None, False)))


def check_flash_bwd(device, dtype, seed=4):
    """flash_bwd's fused kernel and split pair against tile_bwd on the card
    at D=128, B=1 (BWD_CASES); the fused kernel runs FUSED_BWD_REPEATS
    times, the split pair SPLIT_BWD_REPEATS, each route bitwise equal.
    Returns the largest errors {"fused": [dq, dk, dv], "split": [dq, dk,
    dv]}."""
    import torch

    from burst_attn_tpu_torch.ops import flash, tile

    key = _dtype_key(dtype)
    worst = {"fused": [0.0] * 3, "split": [0.0] * 3}
    for i, (name, n, n_kv, s, causal, routes) in enumerate(BWD_CASES):
        args = _bwd_inputs(device, dtype, n, n_kv, s, causal, seed + i)
        want = tile.tile_bwd(*args)
        for fused in routes:
            route = "split" if fused is False else "fused"
            got = flash.flash_bwd(*args, fused=fused)
            errs = _bwd_errs(got, want, f"flash_bwd {key} {name} {route}")
            worst[route] = [max(a, b) for a, b in zip(worst[route], errs)]
            # the fused route's ticketed, ordered dq fold; the split pair's
            # atomic-free sums
            repeats = (FUSED_BWD_REPEATS if route == "fused"
                       else SPLIT_BWD_REPEATS)
            for _ in range(repeats - 1):
                again = flash.flash_bwd(*args, fused=fused)
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    f"flash_bwd {key} {name}: {route} route not bitwise " \
                    "repeatable"
            print(f"flash_bwd {key} {name} N{n}/{n_kv} S={s} {route}: "
                  f"max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
                  f"{errs[2]:.3e} (tolerance {BWD_RTOL} max|ref| + "
                  f"{BWD_ATOL}); {repeats} launches bitwise equal",
                  flush=True)
        del want, got
    return worst


def check_flash_autograd(device, n=16, n_kv=4, s=2048, d=128, seed=9):
    """Gradients through the autograd flash_attention (forward kernel,
    fused backward kernel) against autograd through tile_fwd + finalize,
    fp32, causal GQA."""
    import torch

    from burst_attn_tpu_torch.ops import flash, tile

    g = torch.Generator(device=device).manual_seed(seed)

    def rand(heads):
        return torch.randn(1, heads, s, d, generator=g, device=device)

    q = rand(n).requires_grad_()
    k, v = rand(n_kv).requires_grad_(), rand(n_kv).requires_grad_()
    w = rand(n)
    got = torch.autograd.grad(
        (flash.flash_attention(q, k, v, causal=True) * w).sum(), (q, k, v))
    want = torch.autograd.grad(
        (tile.single_device_attention(q, k, v, causal=True) * w).sum(),
        (q, k, v))
    errs = _bwd_errs(got, want, "flash_attention autograd")
    print(f"flash_attention autograd fp32 N{n}/{n_kv} S={s} causal: "
          f"max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
          f"against autograd through tile_fwd + finalize", flush=True)
    return max(errs)


def time_flash_bwd(device, worst, dtype=None):
    """The backward kernels at the training shape (B1 N16 Nk16 S8192 D128
    bf16 causal), where the train step launches them: the fused kernel
    and the split pair held against tile_bwd (~25 GB transient, freed
    before returning) as check_flash_bwd holds them, each route twice and
    bitwise equal; then their times (each split kernel's device time from
    the profiler, by the bf16 instances' names), the plain tile_bwd's, and
    the backward of SDPA (a yardstick only, never used by the port); then
    the two routes at a scan-ring round's shape (bwd_routes).  Folds the
    errors into `worst`; returns the kernels-line records of
    flash_bwd_fused (with the routes' times), flash_bwd_dq and
    flash_bwd_dkdv, and the split pair's ms."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash, tile

    dtype = dtype or torch.bfloat16
    key = _dtype_key(dtype)
    n, n_kv, s = TRAIN_DIMS["n_heads"], TRAIN_DIMS["n_kv_heads"], TRAIN_SEQ
    args = _bwd_inputs(device, dtype, n, n_kv, s, True, seed=11)
    do, q, k, v, delta, lse, _, _ = args
    want = tile.tile_bwd(*args)
    torch.cuda.empty_cache()
    for fused in (None, False):
        route = "split" if fused is False else "fused"
        got = flash.flash_bwd(*args, fused=fused)
        errs = _bwd_errs(got, want, f"flash_bwd {key} train shape {route}")
        worst[route] = [max(a, b) for a, b in zip(worst[route], errs)]
        again = flash.flash_bwd(*args, fused=fused)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            f"flash_bwd at the train shape: {route} route not bitwise " \
            "repeatable"
        del again
        print(f"flash_bwd {key} train shape N{n}/{n_kv} S={s} {route}: "
              f"max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
              f"{errs[2]:.3e} (tolerance {BWD_RTOL} max|ref| + {BWD_ATOL})"
              "; bitwise repeatable", flush=True)
        del got
    del want
    fused_ms = time_ms(lambda: flash.flash_bwd(*args), iters=5, warmup=1)
    split_ms = time_ms(lambda: flash.flash_bwd(*args, fused=False), iters=3,
                       warmup=1)
    _, _, top = device_breakdown(lambda: flash.flash_bwd(*args, fused=False),
                                 3, top=4)
    dq_ms = sum(t for name, t in top if "flash_bwd_dq_mma_kernel" in name)
    dkdv_ms = sum(t for name, t in top
                  if "flash_bwd_dkdv_mma_kernel" in name)
    assert dq_ms > 0 and dkdv_ms > 0, f"split kernels not profiled: {top}"
    plain_ms = time_ms(lambda: tile.tile_bwd(*args), iters=2, warmup=1)
    torch.cuda.empty_cache()  # tile_bwd's transient
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), do,
                                                 retain_graph=True),
                     iters=5, warmup=1)
    del o, qr, kr, vr
    print(f"flash_bwd at B1 N{n}/{n_kv} S={s} D128 {_dtype_key(dtype)} "
          f"causal: fused {fused_ms:.3f} ms, split pair {split_ms:.3f} ms "
          f"(dq {dq_ms:.3f} + dk/dv {dkdv_ms:.3f} by the profiler), plain "
          f"tile_bwd {plain_ms:.3f} ms, SDPA backward {lib_ms:.3f} ms",
          flush=True)

    # what each function must move and compute: do, q, k, v, delta, lse
    # read once, its fp32 gradients written once; the causal pairs' matmuls
    # (S = QK^T and dP = dO V^T for each; dQ = dS K for dq; dV = P^T dO and
    # dK = dS^T Q for dk/dv)
    pairs = s * (s + 1) // 2
    esz = q.element_size()
    reads = esz * 2 * (q.numel() + k.numel()) + 4 * 2 * delta.numel()
    flops_per_matmul = 2 * pairs * n * q.shape[-1]
    recs = []
    for name, ms, err, written, matmuls, lib, replaces in (
            ("flash_bwd_fused", fused_ms, max(worst["fused"]),
             q.numel() + 2 * k.numel(), 5, lib_ms,
             "burst_attn_tpu/ops/pallas_flash.py:1379 (_bwd_fused_tri_kernel)"
             ", burst_attn_tpu/ops/pallas_flash.py:1127 (_bwd_fused_kernel)"),
            ("flash_bwd_dq", dq_ms, worst["split"][0], q.numel(), 3, None,
             "burst_attn_tpu/ops/pallas_flash.py:865 (_dq_kernel)"),
            ("flash_bwd_dkdv", dkdv_ms, max(worst["split"][1:]),
             2 * k.numel(), 4, None,
             "burst_attn_tpu/ops/pallas_flash.py:945 (_dkdv_kernel)")):
        bms, by = bound_ms(reads + 4 * written, matmuls * flops_per_matmul)
        recs.append(dict(name=name, route="cuda",
                         source="burst_attn_tpu_torch/csrc/flash_bwd.cu",
                         replaces=replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib))
    del args, do, q, k, v, delta, lse
    torch.cuda.empty_cache()
    recs[0]["routes"] = bwd_routes(device, dtype, {"fused": fused_ms,
                                                   "split": split_ms})
    return recs, split_ms


# a scan-ring round of the ring train step (train_smoke's 16 heads, S 8192
# over sp=4: S_local 2048, MHA): causal (the diagonal round) and full (a
# round below it)
ROUND_SEQ = TRAIN_SEQ // 4


def bwd_routes(device, dtype, train):
    """The fused route against the split pair at a scan-ring round's shape
    (B1 N16 S2048 MHA D128, causal and full), CUDA events, fused, split,
    split, fused in turns, beside `train` (the routes' ms at the train
    shape).  The JAX package takes the split pair for short sweeps by
    itself (pallas_flash.py:1879-1881: fused when bwd_band_nbq(...) *
    group >= 4); the port takes it only on fused=False.  Prints one line;
    returns {shape: {"fused": ms, "split": ms}}."""
    from burst_attn_tpu_torch.ops import flash

    n = TRAIN_DIMS["n_heads"]
    res = {"train_causal": train}
    for tag, causal in (("round_causal", True), ("round_full", False)):
        args = _bwd_inputs(device, dtype, n, n, ROUND_SEQ, causal, seed=13)
        t = {"fused": [], "split": []}
        for route in ("fused", "split", "split", "fused"):
            t[route].append(time_ms(lambda: flash.flash_bwd(
                *args, fused=None if route == "fused" else False), iters=20))
        res[tag] = {r: sum(x) / len(x) for r, x in t.items()}
    print(f"flash_bwd routes, fused / split ms: B1 N{n} S{TRAIN_SEQ} "
          f"causal {train['fused']:.4f} / {train['split']:.4f}; rounds "
          f"(means of 2 x 20 calls, f s s f) B1 N{n} S{ROUND_SEQ} "
          f"{_dtype_key(dtype)} causal "
          f"{res['round_causal']['fused']:.4f} / "
          f"{res['round_causal']['split']:.4f}, full round "
          f"{res['round_full']['fused']:.4f} / "
          f"{res['round_full']['split']:.4f}; the port takes the fused "
          "route unless fused=False", flush=True)
    return res


@contextlib.contextmanager
def plain_attention():
    """Route both engines' attention through the plain versions: the
    noise-floor control.  The kernel wrappers launch for every CUDA tensor
    by design, so only patching the call sites can do this."""
    from unittest import mock

    import burst_attn_tpu_torch.models.paged_decode as pd
    from burst_attn_tpu_torch.ops import paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp
    from burst_attn_tpu_torch.ops import tile

    def decode(q, kp, vp, table, lengths, k_scales=None, v_scales=None,
               window=None):
        return pa.paged_decode_reference(q, kp, vp, table, lengths,
                                         k_scales=k_scales, v_scales=v_scales,
                                         window=window)

    def prompt(q, k, v, window=None):
        return tile.single_device_attention(q, k, v, causal=True,
                                            window=window)

    def ragged(q, kp, vp, table, q_lens, kv_lens, **kw):
        return rp.ragged_paged_reference(q, kp, vp, table, q_lens, kv_lens,
                                         **kw)

    with mock.patch.object(pd, "paged_decode_attention", decode), \
            mock.patch.object(pd, "_flash_prompt_attention", prompt), \
            mock.patch.object(pd, "ragged_paged_attention", ragged), \
            mock.patch.object(pd, "ragged_paged_attention_grouped",
                              _plain_grouped):
        yield


def _plain_grouped(q, kp, vp, table, q_lens, kv_lens, *, group_id,
                   shared_table, shared_lens, **kw):
    """The grouped launch's value with plain attention (the grouping only
    reorders the sums)."""
    from burst_attn_tpu_torch.ops import ragged_paged as rp

    return rp.ragged_paged_reference(q, kp, vp, table, q_lens, kv_lens, **kw)


_PARAMS = {}


def model(dtype, device):
    """(cfg, params) at the serving width, random weights from seed 0;
    made once per dtype (numpy init of its parameters takes seconds)."""
    import torch

    from burst_attn_tpu_torch.models.transformer import (
        ModelConfig, init_params,
    )

    cfg = ModelConfig(**SERVE_DIMS, dtype=dtype, batch_axis=None,
                      head_axis=None)
    if torch.float32 not in _PARAMS:
        _PARAMS[torch.float32] = init_params(
            ModelConfig(**SERVE_DIMS, dtype=torch.float32, batch_axis=None,
                        head_axis=None), seed=0, device=device)
    if dtype not in _PARAMS:
        # init_params draws fp32 numbers and casts the matrices: the same
        # cast of the fp32 model gives the same weights; norms stay fp32
        def cast(w):
            return w.to(dtype) if w.dim() > 1 else w

        src = _PARAMS[torch.float32]
        _PARAMS[dtype] = {k: cast(v) if torch.is_tensor(v) else
                          [{n: cast(w) for n, w in lay.items()} for lay in v]
                          for k, v in src.items()}
    return cfg, _PARAMS[dtype]


def requests(cfg, seed=1, n_requests=N_REQUESTS, len_lo=100, len_hi=2048,
             new_lo=32, new_hi=64):
    """The 12 seeded requests: (prompts, budgets)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = [len_lo, len_hi] + list(rng.integers(len_lo, len_hi + 1,
                                                n_requests - 2))
    budgets = [int(n) for n in rng.integers(new_lo, new_hi + 1, n_requests)]
    prompts = [rng.integers(1, cfg.vocab, size=int(t), dtype=np.int32)
               for t in lens]
    return prompts, budgets


def drive(eng, prompts, budgets, counters):
    """Submit, run() with the launch counters of `counters` (kernel
    wrappers) set to 0 just before and read just after; check budgets and
    the pool drain.  Returns (tokens by request in submit order, launches,
    seconds)."""
    rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    out = eng.run()
    run_s = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    toks = [out[r] for r in rids]
    for t, n in zip(toks, budgets):
        assert len(t) == n, f"{len(t)} of {n} tokens"
        assert all(0 <= x < eng.cfg.vocab for x in t)
    return toks, launches, run_s


def agreement(cfg, params, prompts, toks, device):
    """Teacher-force each request's prompt + generated tokens through the
    dense plain forward: (agreeing tokens, total, [(index, reference
    logit gap)] per disagreement)."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.models.transformer import forward

    agree = total = 0
    gaps = []
    for p, out in zip(prompts, toks):
        full = np.concatenate([p, np.asarray(out[:-1], np.int32)])
        tok = torch.from_numpy(full.astype(np.int64)).to(device)[None]
        pos = torch.arange(tok.shape[1], device=device)[None]
        with torch.no_grad():
            logits = forward(params, tok, pos, cfg)
        assert torch.isfinite(logits).all()
        lg = logits[0, len(p) - 1:]
        got = torch.as_tensor(out, device=device)
        pred = lg.argmax(-1)
        miss = (pred != got).nonzero()[:, 0]
        agree += len(out) - len(miss)
        total += len(out)
        for i in miss.tolist():
            gaps.append((i, float(lg[i, pred[i]] - lg[i, got[i]])))
        del logits, lg
    return agree, total, gaps


def near_tie_flips(cfg, params, prompts, toks, want, device):
    """Where two runs' greedy streams part (first differing token of each
    request), the dense forward's logit gap between the two choices:
    [(request, index, gap)]."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.models.transformer import forward

    flips = []
    for r, (p, a, b) in enumerate(zip(prompts, toks, want)):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        full = np.concatenate([p, np.asarray(a[:i], np.int32)])
        tok = torch.from_numpy(full.astype(np.int64)).to(device)[None]
        pos = torch.arange(tok.shape[1], device=device)[None]
        with torch.no_grad():
            lg = forward(params, tok, pos, cfg)[0, -1]
        flips.append((r, i, abs(float(lg[a[i]] - lg[b[i]]))))
    return flips


def check_agreement(what, res, bf16, against="the dense forward",
                    min_agree=MIN_AGREE_BF16):
    agree, total, gaps = res
    worst = max((g for _, g in gaps), default=0.0)
    print(f"{what}: teacher-forced agreement with {against} "
          f"{agree}/{total} = {agree / total:.4f}, largest reference logit "
          f"gap at a disagreement {worst:.4f}", flush=True)
    if bf16:
        assert agree / total >= min_agree, what
        assert worst <= TIE_GAP, (what, gaps)
    else:
        assert agree == total, (what, gaps)


def serve_engine_phase(device):
    """The ServeEngine runs: bf16 (launch counts), plain-attention
    control, fp32, the fp32 model on an int8 pool vs plain attention; then
    a timed prefill and decode steps."""
    import torch

    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.ops import flash, paged_attention as pa

    counters = (flash.flash_fwd, pa.paged_decode_attention)
    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, device=device)
    res = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        cfg, params = model(dtype, device)
        prompts, budgets = requests(cfg)
        eng = ServeEngine(params, cfg, **kw)
        toks, launches, run_s = drive(eng, prompts, budgets, counters)
        assert eng.pool.available == N_PAGES - 1, "pool did not drain"
        n_gen = sum(budgets)
        min_steps = -(-(n_gen - N_REQUESTS) // SLOTS)
        assert launches["flash_fwd"] == cfg.n_layers * N_REQUESTS, launches
        assert launches["paged_decode_attention"] % cfg.n_layers == 0
        assert launches["paged_decode_attention"] >= cfg.n_layers * min_steps
        print(f"ServeEngine {name}: {N_REQUESTS} requests, {n_gen} tokens "
              f"in {run_s:.2f} s ({n_gen / run_s:.1f} tok/s), launches "
              f"{launches}", flush=True)
        check_agreement(f"ServeEngine {name}", agreement(
            cfg, params, prompts, toks, device), name == "bf16")
        res[name] = dict(toks=toks, launches=launches, run_s=run_s,
                         n_gen=n_gen, eng=eng, prompts=prompts)
        if name == "bf16":
            with plain_attention():
                ctrl, cl, _ = drive(ServeEngine(params, cfg, **kw), prompts,
                                    budgets, counters)
            assert sum(cl.values()) == 0, cl
            a, t, _ = agreement(cfg, params, prompts, ctrl, device)
            print(f"ServeEngine control, bf16 with plain attention: "
                  f"{a}/{t}", flush=True)
            res["control"] = (a, t)

    # the fp32 model on an int8 pool: the decode kernel's quantized branch
    # through the engine, held to the same engine with plain attention
    cfg, params = model(torch.float32, device)
    prompts, budgets = requests(cfg)
    runs = []
    for plain in (False, True):
        with plain_attention() if plain else contextlib.nullcontext():
            eng = ServeEngine(params, cfg, quantize="int8", **kw)
            runs.append(drive(eng, prompts, budgets, counters))
        assert eng.pool.available == N_PAGES - 1, "pool did not drain"
    (toks, launches, _), (want, cl, _) = runs
    assert sum(cl.values()) == 0, cl
    assert launches["flash_fwd"] == cfg.n_layers * N_REQUESTS, launches
    assert launches["paged_decode_attention"] >= cfg.n_layers * min_steps
    flips = near_tie_flips(cfg, params, prompts, toks, want, device)
    same = sum(a == b for a, b in zip(toks, want))
    print(f"ServeEngine fp32 model, int8 pool: launches {launches}; kernel "
          f"vs plain attention {same}/{N_REQUESTS} streams identical; flips "
          f"(request, token, dense-forward logit gap) {flips}", flush=True)
    assert all(g <= TIE_GAP for _, _, g in flips), flips
    res["quant"] = (same, flips)
    res["quant_toks"] = toks  # the speculative phase's int8 reference

    # steady-state timing (bf16): one full-length prefill; then decode
    # steps with every slot live at ~2K context
    eng, prompts = res["bf16"]["eng"], res["bf16"]["prompts"]
    long_prompt = prompts[1]

    def one_prefill():
        eng.submit(long_prompt, 1)
        eng.step()  # admits (one prefill) and retires at once: budget 1

    res["prefill_ms"] = host_ms(one_prefill)
    res["prof_prefill"] = device_breakdown(one_prefill, 2)
    for _ in range(SLOTS):
        eng.submit(long_prompt[:2048 - 64], 64)
    eng.step()  # admits every slot
    n_steps = 32
    res["decode_step_ms"] = host_ms(lambda: [eng.step()
                                             for _ in range(n_steps)],
                                    repeats=1) / n_steps
    res["prof_step"] = device_breakdown(eng.step, 4)
    eng.drain()
    return res


# the tp sizes of the tp phase: the serving model's 4 kv heads split in
# two and in four
TP_SIZES = (2, 4)
# an fp32 near tie: tp changes only the summation order of the wo and
# w_down partial sums (~1e-7 relative), so a tp stream may part from the
# unsharded one only where the dense forward's two choices lie closer
TP_TIE_GAP = 1e-4


def tp_serve_phase(device, serve_res):
    """Tensor-parallel serving at the serving width (fp32, SERVE_DIMS, 4
    kv heads): ServeEngine(mesh={"tp": T}) for T in TP_SIZES on the 12
    seeded requests, the parameters split over T positions (the vocab
    too), each position's kv-head shard of the pool.  Its tokens equal
    the unsharded fp32 engine's (serve_engine_phase; a parting only at an
    fp32 near tie of the dense forward, TP_TIE_GAP); kernel 1 launches T
    times a request a layer and kernel 6 T times a layer a decode tick
    (the counters read around one tick with every slot live); then the
    decode tick's host ms (every slot live at ~2K context) beside the
    unsharded engine's.  Returns the phase's numbers, its launches under
    "launches"."""
    import dataclasses

    import torch

    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.models.transformer import ShardedParams
    from burst_attn_tpu_torch.ops import flash, paged_attention as pa

    t_phase = time.perf_counter()
    counters = (flash.flash_fwd, pa.paged_decode_attention)
    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, device=device)
    cfg, params = model(torch.float32, device)
    cfgt = dataclasses.replace(cfg, head_axis="tp")
    prompts, budgets = requests(cfg)
    want = serve_res["fp32"]["toks"]
    base = serve_res["fp32"]["launches"]
    long_prompt = prompts[1]

    def tick_ms(eng):
        """host ms of a decode tick with every slot live at ~2K, and the
        launches of one such tick"""
        for _ in range(SLOTS):
            eng.submit(long_prompt[:2048 - 64], 64)
        eng.step()  # admits every slot
        for f in counters:
            f.launches = 0
        eng.step()
        torch.cuda.synchronize()
        one = {f.__name__: f.launches for f in counters}
        ms = host_ms(lambda: [eng.step() for _ in range(16)],
                     repeats=1) / 16
        eng.drain()
        return ms, one

    res = {"launches": {"flash_fwd": 0, "paged_decode_attention": 0},
           "tick_ms": {1: tick_ms(serve_res["fp32"]["eng"])[0]}}
    for tp in TP_SIZES:
        eng = ServeEngine(params, cfgt, mesh={"tp": tp}, **kw)
        assert isinstance(eng.params, ShardedParams) and eng.state.tp == tp
        toks, launches, run_s = drive(eng, prompts, budgets, counters)
        assert eng.pool.available == N_PAGES - 1, "pool did not drain"
        assert launches == {k: tp * v for k, v in base.items()}, (launches,
                                                                   base)
        flips = near_tie_flips(cfg, params, prompts, toks, want, device)
        same = sum(a == b for a, b in zip(toks, want))
        assert all(g <= TP_TIE_GAP for _, _, g in flips), flips
        ms, one = tick_ms(eng)
        assert one == {"flash_fwd": 0,
                       "paged_decode_attention": tp * cfg.n_layers}, one
        for k_, v_ in launches.items():
            res["launches"][k_] += v_
        res[f"tp{tp}"] = dict(same=same, flips=flips, run_s=run_s,
                              launches=launches, tick_launches=one)
        res["tick_ms"][tp] = ms
        print(f"tp ServeEngine fp32, tp={tp}: 12 requests in {run_s:.2f} s, "
              f"{same}/{N_REQUESTS} streams equal the unsharded engine's, "
              f"flips {flips}; launches {launches} (unsharded {base}); a "
              f"decode tick launches {one} (kernel 6 = tp x {cfg.n_layers} "
              f"layers), {ms:.3f} ms (unsharded {res['tick_ms'][1]:.3f} ms)",
              flush=True)
        del eng
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"tp serve phase: {res['seconds']:.1f} s", flush=True)
    return res


def ragged_engine_phase(device, serve_res):
    """RaggedServeEngine runs at the serving width: bf16 (launch counts,
    agreement), plain-attention control, fp32 (exact vs the dense forward
    and the fp32 ServeEngine), int8/fp8 pools vs plain attention, the
    prefix-cache wave, and the timings."""
    import torch

    from burst_attn_tpu_torch.ops import ragged_paged as rp
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    counters = (rp.ragged_paged_attention,)
    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, chunk=CHUNK, device=device)
    res = {}

    def run(dtype, **extra):
        cfg, params = model(dtype, device)
        prompts, budgets = requests(cfg)
        eng = RaggedServeEngine(params, cfg, **kw, **extra)
        toks, launches, run_s = drive(eng, prompts, budgets, counters)
        assert eng.pool.available == N_PAGES - 1, "pool did not drain"
        ticks = sum(v for k, v in eng.stats.items()
                    if k.startswith("serve.ragged_batch_launches"))
        fallbacks = sum(v for k, v in eng.stats.items()
                        if k.startswith("burst.fused_fallback"))
        return cfg, params, prompts, eng, toks, launches, run_s, ticks, \
            fallbacks

    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        cfg, params, prompts, eng, toks, launches, run_s, ticks, fb = run(
            dtype)
        n = launches["ragged_paged_attention"]
        print(f"RaggedServeEngine {name}: {N_REQUESTS} requests, "
              f"{sum(map(len, toks))} tokens in {run_s:.2f} s, {ticks} "
              f"launch ticks, ragged launches {n}, dense fallbacks {fb}, "
              f"stats {dict(eng.stats)}", flush=True)
        assert fb == 0 and n == cfg.n_layers * ticks > 0, (fb, n, ticks)
        check_agreement(f"RaggedServeEngine {name}", agreement(
            cfg, params, prompts, toks, device), name == "bf16")
        res[name] = dict(toks=toks, launches=n, run_s=run_s, ticks=ticks,
                         eng=eng, prompts=prompts)
    assert res["fp32"]["toks"] == serve_res["fp32"]["toks"], \
        "fp32 ragged engine tokens differ from the fp32 ServeEngine's"
    print("RaggedServeEngine fp32 tokens equal the fp32 ServeEngine's",
          flush=True)
    with plain_attention():
        cfg, params, prompts, _, ctrl, cl, _, _, _ = run(torch.bfloat16)
    assert sum(cl.values()) == 0, cl
    a, t, _ = agreement(cfg, params, prompts, ctrl, device)
    print(f"RaggedServeEngine control, bf16 with plain attention: {a}/{t}",
          flush=True)
    res["control"] = (a, t)

    # quantized pools: the fp32 model through the kernel vs plain attention
    res["quant"] = {}
    for q in ("int8", "fp8"):
        cfg, params, prompts, _, toks, launches, _, ticks, _ = run(
            torch.float32, quantize=q)
        assert launches["ragged_paged_attention"] == cfg.n_layers * ticks
        with plain_attention():
            want = run(torch.float32, quantize=q)[4]
        flips = near_tie_flips(cfg, params, prompts, toks, want, device)
        same = sum(a == b for a, b in zip(toks, want))
        print(f"RaggedServeEngine fp32 model, {q} pool: kernel vs plain "
              f"attention {same}/{N_REQUESTS} streams identical; flips "
              f"(request, token, dense-forward logit gap) {flips}",
              flush=True)
        assert all(g <= TIE_GAP for _, _, g in flips), flips
        res["quant"][q] = (same, flips)
        res[f"quant_toks_{q}"] = toks
    cfg, params, prompts, _, toks, _, _, _, _ = run(torch.bfloat16,
                                                    quantize="int8")
    a, t, _ = agreement(cfg, params, prompts, toks, device)
    print(f"RaggedServeEngine bf16 model, int8 pool: teacher-forced "
          f"agreement with the dense forward {a}/{t} = {a / t:.4f}",
          flush=True)
    res["bf16_int8_agree"] = (a, t)
    res["prefix"], res["prefix_toks"] = prefix_wave(device)
    res.update(ragged_timings(device))
    return res


PREFIX_TAILS = (0, 17, 90, 128, 129, 200, 255, 300)


def prefix_prompts(cfg, tails=PREFIX_TAILS, template_len=1024):
    """The prefix wave's seeded template and its prompts (the template
    plus each tail; tail 0 is the exact template)."""
    import numpy as np

    rng = np.random.default_rng(7)
    tmpl = rng.integers(1, cfg.vocab, size=template_len, dtype=np.int32)
    return tmpl, [np.concatenate([tmpl, rng.integers(
        1, cfg.vocab, size=t, dtype=np.int32)]) for t in tails]


def prefix_wave(device, tails=PREFIX_TAILS,
                template_len=1024, budget=24, **engine_kw):
    """fp32: a warm request registers a 1024-token template; then 8
    requests on it (tails of 0-300 tokens, one the exact template) run
    with the cache on and off.  Tokens must be equal; the counters must
    read what the admission arithmetic says; the grouped launch must run;
    drain + evict must return every page.  `engine_kw` (pipeline=True,
    multi_step=K) goes to both engines.  Returns (stats, tokens)."""
    import torch

    from burst_attn_tpu_torch.serving import RaggedServeEngine

    cfg, params = model(torch.float32, device)
    tmpl, prompts = prefix_prompts(cfg, tails, template_len)
    out = {}
    for cache in (False, True):
        eng = RaggedServeEngine(params, cfg, slots=SLOTS, n_pages=N_PAGES,
                                page=PAGE, max_pages_per_seq=MAX_PAGES,
                                chunk=CHUNK, prefix_cache=cache,
                                device=device, **engine_kw)
        eng.submit(tmpl, 2)
        eng.run()
        stats0 = dict(eng.stats)
        rids = [eng.submit(p, budget) for p in prompts]
        res = eng.run()
        out[cache] = [res[r] for r in rids]
        stats = {k: v - stats0.get(k, 0) for k, v in eng.stats.items()}
    n_pre = template_len // PAGE
    want = {"serve.prefix_hits": len(tails),
            # a full-prompt hit resumes at T-1
            "serve.prefill_tokens_skipped": sum(
                n_pre * PAGE - (t == 0) for t in tails),
            # ... and its re-absorbed token privatizes the last shared page
            "serve.cow_copies": sum(t == 0 for t in tails)}
    knobs = {k: v for k, v in engine_kw.items()
             if not k.startswith("draft_")}
    print(f"prefix wave (fp32, template {template_len}, tails {list(tails)}"
          f", {knobs or 'synchronous'}): stats {stats}", flush=True)
    assert out[True] == out[False], "prefix-cache tokens differ from cache-off"
    for k, v in want.items():
        assert stats.get(k, 0) == v, (k, stats.get(k), v)
    assert stats.get("serve.grouped_launches", 0) > 0, stats
    eng.drain()
    eng.cache.evict(N_PAGES)
    assert eng.pool.in_use == 0 and eng.pool.logical_refs == 0
    if eng.draft is not None:  # the draft's pool holds no shared page
        assert eng.draft.pool.available == N_PAGES - 1
    print("prefix wave: tokens equal the cache-off run; after drain and "
          "evict in_use 0, logical_refs 0", flush=True)
    return stats, out[True]


def ragged_timings(device, cm=None):
    """bf16 RaggedServeEngine: TTFT of one 2048-token prompt (16 chunks),
    a decode tick with 8 live slots at ~2K context, and a mixed tick (one
    128-token chunk + 7 decodes), with profiler breakdowns.  `cm`: the
    (cfg, params) to serve, default the bf16 serving model."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.serving import RaggedServeEngine

    cfg, params = cm or model(torch.bfloat16, device)
    eng = RaggedServeEngine(params, cfg, slots=SLOTS, n_pages=N_PAGES,
                            page=PAGE, max_pages_per_seq=MAX_PAGES,
                            chunk=CHUNK, device=device)
    long_prompt = np.random.default_rng(9).integers(
        1, cfg.vocab, size=2048, dtype=np.int32)

    def ttft():
        eng.submit(long_prompt, 1)
        eng.run()

    out = dict(ttft_ms=host_ms(ttft), ttft_ticks=2048 // CHUNK)
    # 7 slots decoding at ~2K context, then an 8th arriving with a long
    # prompt: its 16 chunks are mixed ticks
    for _ in range(SLOTS - 1):
        eng.submit(long_prompt[:2048 - 96], 96)
    while any(r is None or r.n_prefilled < len(r.prompt)
              for r in eng.slots[:SLOTS - 1]):
        eng.step()
    eng.submit(long_prompt, 4)
    eng.step()  # admits it: the first mixed tick
    out["mixed_tick_ms"] = host_ms(eng.step, repeats=5)
    out["prof_mixed"] = device_breakdown(eng.step, 4)
    while eng.slots[SLOTS - 1] is not None:
        eng.step()
    eng.submit(long_prompt[:2048 - 96], 64)
    eng.step()  # admits it
    while any(r.n_prefilled < len(r.prompt) for r in eng.slots):
        eng.step()
    assert eng.live == SLOTS
    n_steps = 16
    out["decode_tick_ms"] = host_ms(
        lambda: [eng.step() for _ in range(n_steps)], repeats=1) / n_steps
    out["prof_decode"] = device_breakdown(eng.step, 4)
    eng.drain()
    return out


K_PIPE = 4  # the pipelined engine's fused decode depth (multi_step)


def _device_ticks(eng):
    """The ticks the device ran for an engine's launches: one a launch, K
    a fused K-tick launch, plus the K-tick warm-ups of its decode graphs'
    captures.  Kernel 7 launches once a layer a tick."""
    ticks = 0
    for key, n in eng.stats.items():
        if key.startswith("serve.ragged_batch_launches"):
            ticks += n
        elif key.startswith("serve.multi_step_launches{k="):
            ticks += (int(key[len("serve.multi_step_launches{k="):-1])
                      - 1) * n
    return ticks + (eng.graphs.warmup_ticks if eng.graphs else 0)


def pipelined_phase(device, rag):
    """The pipelined RaggedServeEngine (pipeline=True) at K=1 and K=4 on
    the 12 requests: fp32 token-exact with the synchronous engine (itself
    exact with the dense forward), bf16 equal to it or flipped at near
    ties only; sampled (temperature 0.8, top-k 8) token-exact with the
    synchronous engine from the same generator seed; an EOS workload
    (fused launches cut at an EOS, speculation reconciled); the prefix
    wave.  Every run drains the pool and launches kernel 7 once a layer
    for every tick the device ran; graph captures and replays counted."""
    import torch

    from burst_attn_tpu_torch.ops import ragged_paged as rp
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    counters = (rp.ragged_paged_attention,)
    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, chunk=CHUNK, device=device)
    res = {}

    def engine(dtype, ms, pipeline=True, seed=None, **extra):
        cfg, params = model(dtype, device)
        if seed is not None:
            extra["rng"] = torch.Generator(device=device).manual_seed(seed)
        return cfg, params, RaggedServeEngine(
            params, cfg, **kw, pipeline=pipeline, multi_step=ms, **extra)

    def check_run(eng, cfg, launches):
        assert eng.pool.available == N_PAGES - 1, "pool did not drain"
        assert eng._pending is None
        n = launches["ragged_paged_attention"]
        assert n == cfg.n_layers * _device_ticks(eng) > 0, \
            (n, dict(eng.stats))
        return n

    def graphs(eng):
        g = eng.graphs
        return (g.captures, g.replays) if g is not None else (0, 0)

    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        want = rag[name]["toks"]
        for ms in (1, K_PIPE):
            cfg, params, eng = engine(dtype, ms)
            prompts, budgets = requests(cfg)
            toks, launches, run_s = drive(eng, prompts, budgets, counters)
            n = check_run(eng, cfg, launches)
            flips = near_tie_flips(cfg, params, prompts, toks, want, device)
            same = sum(a == b for a, b in zip(toks, want))
            caps, reps = graphs(eng)
            print(f"pipelined RaggedServeEngine {name} K={ms}: "
                  f"{N_REQUESTS} requests, {sum(map(len, toks))} tokens in "
                  f"{run_s:.2f} s, ragged launches {n}, graph captures "
                  f"{caps}, replays {reps}, stats {dict(eng.stats)}; "
                  f"{same}/{N_REQUESTS} streams equal the synchronous "
                  f"engine's; flips (request, token, dense-forward logit "
                  f"gap) {flips}", flush=True)
            if name == "fp32":
                assert toks == want, "fp32 pipelined tokens differ"
            assert all(g <= TIE_GAP for _, _, g in flips), flips
            if ms > 1:
                assert eng.stats[f"serve.multi_step_launches{{k={ms}}}"] > 0
                assert caps > 0 and reps > 0, (caps, reps)
            res[f"{name}_k{ms}"] = dict(same=same, flips=flips, run_s=run_s,
                                        launches=n, captures=caps,
                                        replays=reps)

    # sampled: the same generator seed through the three engines
    streams = {}
    for ms, pipe in ((1, False), (1, True), (K_PIPE, True)):
        cfg, params, eng = engine(torch.float32, ms, pipeline=pipe, seed=11,
                                  temperature=0.8, top_k=8)
        prompts, budgets = requests(cfg)
        toks, launches, _ = drive(eng, prompts, budgets, counters)
        check_run(eng, cfg, launches)
        streams[(ms, pipe)] = toks
    same = [sum(a == b for a, b in zip(streams[k], streams[(1, False)]))
            for k in ((1, True), (K_PIPE, True))]
    print(f"pipelined RaggedServeEngine fp32 sampled (temperature 0.8, "
          f"top-k 8, seed 11): K=1 {same[0]}/{N_REQUESTS}, K={K_PIPE} "
          f"{same[1]}/{N_REQUESTS} streams equal the synchronous engine's",
          flush=True)
    assert same == [N_REQUESTS, N_REQUESTS], same
    res["sampled_same"] = same

    # EOS: 8 short requests, so every launch after their prefill is pure
    # decode; the EOS token first appears at or after a stream's 8th token
    cfg, params = model(torch.float32, device)
    prompts, _ = requests(cfg)
    prompts = [p[:256] for p in prompts[:SLOTS]]
    budgets = [32] * SLOTS

    def eos_run(ms, pipe, eos_id):
        _, _, eng = engine(torch.float32, ms, pipeline=pipe, eos_id=eos_id)
        rids = [eng.submit(p, n) for p, n in zip(prompts, budgets)]
        for f in counters:
            f.launches = 0
        out = eng.run()
        check_run(eng, cfg, {"ragged_paged_attention":
                             rp.ragged_paged_attention.launches})
        return [out[r] for r in rids], eng

    free, _ = eos_run(1, False, None)
    eos = next(t for s in free for t in s[8:]
               if all(t not in x[:8] for x in free))
    outs = {}
    for ms, pipe in ((1, False), (K_PIPE, True)):
        outs[pipe], eng = eos_run(ms, pipe, eos)
    rec = sum(v for k, v in eng.stats.items()
              if k.startswith("serve.pipeline_reconciles"))
    cut = sum(len(t) < n for t, n in zip(outs[True], budgets))
    print(f"pipelined RaggedServeEngine fp32 EOS {eos}: {cut} of {SLOTS} "
          f"streams end at it; K={K_PIPE} stats {dict(eng.stats)}",
          flush=True)
    assert outs[True] == outs[False], "EOS streams differ"
    assert cut > 0 and rec > 0, (cut, rec)
    assert eng.stats[f"serve.multi_step_launches{{k={K_PIPE}}}"] > 0
    res["eos"] = dict(cut=cut, reconciles=rec)

    stats, toks = prefix_wave(device, pipeline=True, multi_step=K_PIPE)
    assert toks == rag["prefix_toks"], "pipelined prefix wave tokens differ"
    print("pipelined prefix wave: tokens equal the synchronous wave's",
          flush=True)
    res["prefix"] = stats
    res["launches"] = res[f"bf16_k{K_PIPE}"]["launches"]
    return res


def pipelined_ticks(device, n_steps=16):
    """bf16 decode ticks with every slot live at ~2K context through the
    synchronous engine and the pipelined one at K=1 and K=4, each filled
    once, timed in turns (sync, K=1, K=4, K=4, K=1, sync): ms a tick =
    wall / ticks advanced; then a profiled window each (busy share), and
    the K=4 engine's graph captures and replays."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.serving import RaggedServeEngine

    cfg, params = model(torch.bfloat16, device)
    prompt = np.random.default_rng(9).integers(1, cfg.vocab, size=2048 - 256,
                                               dtype=np.int32)
    engs = {}
    for name, extra in (("sync", {}), ("k1", dict(pipeline=True)),
                        ("k4", dict(pipeline=True, multi_step=K_PIPE))):
        eng = RaggedServeEngine(params, cfg, slots=SLOTS, n_pages=N_PAGES,
                                page=PAGE, max_pages_per_seq=MAX_PAGES,
                                chunk=CHUNK, device=device, **extra)
        for _ in range(SLOTS):
            eng.submit(prompt, 256)
        while eng.pending or any(r is None or r.n_prefilled < len(r.prompt)
                                 for r in eng.slots):
            eng.step()
        for _ in range(2):  # the first fused launches (K=4: its capture)
            eng.step()
        engs[name] = eng

    def tick_ms(eng):
        before = sum(len(r.tokens) for r in eng.slots)
        ms = host_ms(lambda: [eng.step() for _ in range(n_steps)], repeats=1)
        return ms * SLOTS / (sum(len(r.tokens) for r in eng.slots) - before)

    times = {k: [] for k in engs}
    for name in ("sync", "k1", "k4", "k4", "k1", "sync"):
        times[name].append(tick_ms(engs[name]))
    out = {"tick_ms": {k: sum(v) / len(v) for k, v in times.items()},
           "tick_ms_turns": times}
    for name, eng in engs.items():
        before = sum(len(r.tokens) for r in eng.slots)
        wall, dev, top = device_breakdown(eng.step, 4)
        ticks = (sum(len(r.tokens) for r in eng.slots) - before) / SLOTS
        out[f"prof_{name}"] = (wall, dev, top)
        out[f"busy_{name}"] = dev / wall
        out[f"ticks_profiled_{name}"] = ticks
        assert eng.live == SLOTS
    g = engs["k4"].graphs
    out["k4_graphs"] = {"captures": g.captures, "replays": g.replays}
    assert g.captures > 0 and g.replays > 0
    for eng in engs.values():
        eng.drain()
        assert eng.pool.available == N_PAGES - 1
    return out


def serve_prefix_phase(device, tails=(0, 17, 90, 128, 129, 200, 255, 300),
                       template_len=1024, budget=24):
    """ServeEngine(prefix_cache=True) at the serving width.  fp32: a warm
    request registers a 1024-token template, then 8 requests on it (tails
    0-300, one the exact template) with the cache on and off: tokens
    equal; every request's prefill takes the suffix path (kernel 1 on the
    offset mask, counted: a launch a layer), the tokens skipped, the
    cache's pages and the pool as the arithmetic says; drain keeps the
    cache, evict empties the pool.  bf16: TTFT of a 2048-token prompt
    whose first 1024 tokens are cached, against the same shape uncached
    (a fresh tail each repeat, median of 3)."""
    from unittest import mock

    import numpy as np
    import torch

    import burst_attn_tpu_torch.models.paged_decode as pd
    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.ops import flash

    suffix = dict(calls=0, launches=0, t_pre=0)
    real = pd._suffix_attention

    def counted(q, k, v, t_pre, q_hi, kv_hi, window=None):
        before = flash.flash_fwd.launches
        o = real(q, k, v, t_pre, q_hi, kv_hi, window=window)
        suffix["launches"] += flash.flash_fwd.launches - before
        suffix["calls"] += 1
        suffix["t_pre"] += t_pre
        return o

    cfg, params = model(torch.float32, device)
    rng = np.random.default_rng(7)
    tmpl = rng.integers(1, cfg.vocab, size=template_len, dtype=np.int32)
    prompts = [np.concatenate([tmpl, rng.integers(1, cfg.vocab, size=t,
                                                  dtype=np.int32)])
               for t in tails]
    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, device=device)
    out, res = {}, {}
    for cache in (False, True):
        eng = ServeEngine(params, cfg, prefix_cache=cache, **kw)
        eng.submit(tmpl, 2)
        eng.run()
        rids = [eng.submit(p, budget) for p in prompts]
        flash.flash_fwd.launches = 0
        suffix.update(calls=0, launches=0, t_pre=0)
        with mock.patch.object(pd, "_suffix_attention", counted):
            got = eng.run()
        out[cache] = [got[r] for r in rids]
        assert flash.flash_fwd.launches == cfg.n_layers * len(tails)
        res[cache] = dict(suffix)
    n_pre = template_len // PAGE
    skipped = sum((n_pre - (t == 0)) * PAGE for t in tails)
    n_cached = n_pre + sum((template_len + t) // PAGE - n_pre for t in tails)
    print(f"ServeEngine prefix wave (fp32, template {template_len}, tails "
          f"{list(tails)}): suffix prefills {res[True]}, cache "
          f"{len(eng.cache)} pages, pool in use {eng.pool.in_use}",
          flush=True)
    assert out[True] == out[False], "prefix-cache tokens differ from off"
    assert res[False]["calls"] == 0
    assert res[True] == dict(calls=cfg.n_layers * len(tails),
                             launches=cfg.n_layers * len(tails),
                             t_pre=cfg.n_layers * skipped), res[True]
    assert len(eng.cache) == n_cached, (len(eng.cache), n_cached)
    assert eng.pool.in_use == eng.pool.logical_refs == n_cached
    eng.drain()
    assert len(eng.cache) == n_cached
    eng.cache.evict(N_PAGES)
    assert eng.pool.in_use == 0 and eng.pool.logical_refs == 0
    print("ServeEngine prefix wave: tokens equal the cache-off run; after "
          "retirement only the cache holds pages; after evict in_use 0",
          flush=True)

    # TTFT, bf16: a 2048-token prompt on a cached 1024-token template
    cfg, params = model(torch.bfloat16, device)
    rng = np.random.default_rng(13)
    tmpl = rng.integers(1, cfg.vocab, size=1024, dtype=np.int32)
    ttft, busy = {}, {}
    for cache in (False, True):
        eng = ServeEngine(params, cfg, prefix_cache=cache, **kw)
        eng.submit(tmpl, 1)
        eng.step()  # registers the template (cache on)

        def one():  # a fresh tail each time: only the template is cached
            eng.submit(np.concatenate([tmpl, rng.integers(
                1, cfg.vocab, size=1024, dtype=np.int32)]), 1)
            eng.step()  # admits (one prefill) and retires: budget 1

        what = "cached" if cache else "uncached"
        ttft[what] = host_ms(one)
        prof = device_breakdown(one, 2)
        busy[what] = prof[1] / prof[0]
        print_profile(f"ServeEngine TTFT, template {what}", prof)
    print(f"ServeEngine TTFT, a 2048-token prompt (bf16): template of 1024 "
          f"cached {ttft['cached']:.2f} ms, uncached {ttft['uncached']:.2f} "
          f"ms (median of 3)", flush=True)
    return dict(suffix_launches=res[True]["launches"], cached_pages=n_cached,
                ttft_ms=ttft, ttft_busy=busy)


SUFFIX_SHAPES = ((1024, 1024), (896, 128), (1024, 300), (1920, 17))


def check_flash_suffix(device, n=16, n_kv=4, d=128):
    """Kernel 1 on the suffix prefill's offset mask (t_suf queries padded
    to the page after t_pre cached keys, causal at offset t_pre) against
    tile_fwd/finalize, bf16 and fp32, at the prefix wave's shapes and the
    TTFT's (1024 after 1024); the record times the latter in bf16 beside
    SDPA with the same offset mask."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash, masks, tile

    g = torch.Generator(device=device).manual_seed(31)
    scale = d**-0.5
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        key = _dtype_key(dtype)
        for t_pre, t_suf in SUFFIX_SHAPES:
            t_pad = -(-t_suf // PAGE) * PAGE
            q = torch.randn(1, n, t_pad, d, generator=g,
                            device=device).to(dtype)
            k, v = (torch.randn(1, n_kv, t_pre + t_pad, d, generator=g,
                                device=device).to(dtype) for _ in range(2))
            spec = masks.MaskSpec(0, t_suf, t_pre + t_suf, 1, t_pre)
            m, lse, o = flash.flash_fwd(q, k, v, None, None, None, scale,
                                        spec, emit_o=True)
            st = tile.tile_fwd(q, k, v, *tile.init_state(1, n, t_pad, d,
                                                         device=device),
                               scale, spec)
            err = _check_o(f"flash_fwd[suffix] {key} t_pre {t_pre} t_suf "
                           f"{t_suf}", o, tile.finalize(*st, dtype), dtype)
            assert not o[:, :, t_suf:].any()  # pad rows give 0
            fin = torch.isfinite(st[1])
            assert torch.equal(torch.isfinite(lse), fin)
            assert _max_err(lse[fin], st[1][fin]) <= STATS_ATOL[key]
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            print(f"flash_fwd[suffix] {key} t_pre {t_pre} t_suf {t_suf} "
                  f"(padded to {t_pad}): max_abs_err={err:.3e}", flush=True)
    t_pre = t_suf = 1024
    q = torch.randn(1, n, t_suf, d, generator=g,
                    device=device).to(torch.bfloat16)
    k, v = (torch.randn(1, n_kv, t_pre + t_suf, d, generator=g,
                        device=device).to(torch.bfloat16) for _ in range(2))
    spec = masks.MaskSpec(0, t_suf, t_pre + t_suf, 1, t_pre)
    ms = time_ms(lambda: flash.flash_fwd(q, k, v, None, None, None, scale,
                                         spec, emit_o=True))

    def plain():
        st = tile.tile_fwd(q, k, v, *tile.init_state(1, n, t_suf, d,
                                                     device=device),
                           scale, spec)
        return tile.finalize(*st, q.dtype)

    plain_ms = time_ms(plain, iters=3, warmup=1)
    rows = torch.arange(t_suf, device=device)[:, None]
    cols = torch.arange(t_pre + t_suf, device=device)[None, :]
    mask = cols <= rows + t_pre
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True))
    pairs = int(mask.sum())
    n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) \
        + 4 * 2 * n * t_suf
    bms, by = bound_ms(n_bytes, 4 * pairs * n * d)
    print(f"flash_fwd[suffix] bf16 N{n}/{n_kv} t_pre {t_pre} t_suf {t_suf}: "
          f"{ms:.4f} ms, plain {plain_ms:.3f}, SDPA (offset mask) "
          f"{lib_ms:.4f}, bound {bms:.4f} ({by})", flush=True)
    return dict(name="flash_fwd[suffix]", route="cuda",
                source="burst_attn_tpu_torch/csrc/flash_fwd.cu",
                replaces="burst_attn_tpu/ops/pallas_flash.py:419",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def _reset_counts():
    from burst_attn_tpu_torch.ops import flash, fused_ring, fused_ring_bwd

    flash.flash_fwd.launches = flash.flash_fwd.seg_launches = 0
    flash.flash_fwd.win_launches = 0
    for route in flash.BWD_ROUTES:
        flash.flash_bwd.launches[route] = 0
        flash.flash_bwd.seg_launches[route] = 0
        flash.flash_bwd.win_launches[route] = 0
    for fn in (fused_ring.fused_ring_fwd, fused_ring_bwd.fused_ring_bwd):
        fn.launches = fn.seg_launches = fn.win_launches = 0


def _counts():
    """The training path's attention kernels' launch counters: flash_fwd,
    flash_bwd by route (fused, dq, dkdv), the fused ring's forward and
    backward, and (keys ending in _seg, _win) the launches of their SEG
    and WIN instances among them."""
    from burst_attn_tpu_torch.ops import flash, fused_ring, fused_ring_bwd

    fr, frb = fused_ring.fused_ring_fwd, fused_ring_bwd.fused_ring_bwd
    out = {"flash_fwd": flash.flash_fwd.launches, **flash.flash_bwd.launches,
           "fused_ring_fwd": fr.launches, "fused_ring_bwd": frb.launches}
    for tag in ("seg", "win"):
        out |= {"flash_fwd_" + tag: getattr(flash.flash_fwd,
                                            f"{tag}_launches"),
                **{f"{r}_{tag}": x for r, x in getattr(
                    flash.flash_bwd, f"{tag}_launches").items()},
                "fused_ring_fwd_" + tag: getattr(fr, f"{tag}_launches"),
                "fused_ring_bwd_" + tag: getattr(frb, f"{tag}_launches")}
    return out


_COUNT_KEYS = ("flash_fwd", "fused", "dq", "dkdv", "fused_ring_fwd",
               "fused_ring_bwd")


def _launches(**nonzero):
    """A _counts() dict: the named counts, every other one 0."""
    return {k: nonzero.get(k, 0)
            for k in _COUNT_KEYS + tuple(f"{x}_{tag}" for tag in ("seg",
                                                                   "win")
                                         for x in _COUNT_KEYS)}


def _train_model(n_layers, dtype, **kw):
    import torch

    from burst_attn_tpu_torch.models.transformer import ModelConfig

    return ModelConfig(**{**TRAIN_DIMS, "n_layers": n_layers}, **{
        "dtype": dtype, "batch_axis": None, "head_axis": None,
        "remat": True, **kw})


_SEED_PARAMS = {}


def _seed_state(cfg, tcfg, device):
    """(params, optimizer) equal to train.init_train_state(0, cfg, tcfg):
    the random init (~25 s for the 1.21 B model, numpy on the host) runs
    once per model shape and dtype, and every later call copies it.  A
    shallower model of the same widths and dtype takes the deeper seed's
    first layers (the pp phase)."""
    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import param_leaves

    key = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab, cfg.dtype)
    deeper = [k for k in _SEED_PARAMS if k[1:] == key[1:] and k[0] > key[0]]
    if key not in _SEED_PARAMS and deeper:
        # a shallower model of the same widths: the deeper seed's first
        # layers (init_params draws layer by layer, embed first, the
        # final norm and lm_head last: these are not init_params(cfg)'s
        # values, but the same seed's at every width)
        leaves = _SEED_PARAMS[deeper[0]]
        per = len(leaves[1:-2]) // deeper[0][0]
        _SEED_PARAMS[key] = leaves[:1 + per * cfg.n_layers] + leaves[-2:]
    if key not in _SEED_PARAMS:
        params, opt = train.init_train_state(0, cfg, tcfg, device=device)
        _SEED_PARAMS[key] = [t.detach().clone() for t in
                             param_leaves(params)]
        return params, opt
    params = _params_like(_SEED_PARAMS[key], cfg)
    return params, train._optimizer(params, tcfg)


def _params_like(leaves, cfg):
    """A parameter dictionary (param_leaves order) holding copies of
    `leaves`, each requiring grad."""
    from burst_attn_tpu_torch.models.transformer import LAYER_KEYS

    it = iter(t.clone().requires_grad_(True) for t in leaves)
    embed = next(it)
    layers = [{k: next(it) for k in LAYER_KEYS} for _ in range(cfg.n_layers)]
    return {"embed": embed, "layers": layers, "final_norm": next(it),
            "lm_head": next(it)}


def train_phase(device):
    """make_train_step at the training benchmark's width and depth (bf16,
    remat, B=1, S=TRAIN_SEQ, weights from numpy seed 0) on one fixed batch:
    a warm-up and TRAIN_STEPS timed steps with the fused backward (launch
    counters read around the timed steps; the loss must be finite and
    fall), a profiled step, then two steps through the split backward.
    Last, the control: the same model from the same seed with plain
    attention takes the same first 1 + TRAIN_STEPS steps; its first two
    losses (the forward; one update) must match within CONTROL_RTOL."""
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import param_leaves

    cfg = _train_model(TRAIN_DIMS["n_layers"], torch.bfloat16)
    tcfg = train.TrainConfig()
    t0 = time.perf_counter()
    state = [_seed_state(cfg, tcfg, device)]
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in param_leaves(state[0][0]))
    batch = train.make_batch(1, cfg, batch=1, seq=TRAIN_SEQ, device=device)

    def run(step, n_steps):
        """(losses, grad norms, host ms per step, launches)"""
        _reset_counts()
        losses, norms, times = [], [], []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, m = step(state[0], batch)  # the state is updated in place
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return losses, norms, times, _counts()

    n_layers = cfg.n_layers
    step = train.make_train_step(cfg, tcfg, device=device)
    warm = run(step, 1)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, times, launches = run(step, TRAIN_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = _launches(flash_fwd=2 * n_layers * TRAIN_STEPS,
                     fused=n_layers * TRAIN_STEPS)
    assert launches == want, (launches, want)
    losses = warm[0] + losses
    assert all(map(math.isfinite, losses + warm[1] + norms)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"

    step_ms = statistics.median(times)
    d_head = TRAIN_DIMS["d_head"]
    # benchmarks/train_smoke.py's model FLOPs: 6 per parameter and token,
    # plus attention (scores + pv = 4 S^2 N D per layer forward, halved
    # causal, x3.5 forward + backward)
    attn_flops = (n_layers * 3.5 * 4 * TRAIN_SEQ * TRAIN_SEQ
                  * TRAIN_DIMS["n_heads"] * d_head / 2)
    flops = 6.0 * n_params * TRAIN_SEQ + attn_flops
    res = dict(n_params=n_params, seq=TRAIN_SEQ, init_s=init_s,
               losses=losses, grad_norms=warm[1] + norms, step_ms=step_ms,
               step_ms_all=times,
               tokens_per_s=TRAIN_SEQ / (step_ms / 1e3),
               model_tflops_per_s=flops / (step_ms / 1e3) / 1e12,
               mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
               launches_per_step={k: v // TRAIN_STEPS
                                  for k, v in launches.items()},
               peak_gb=peak_gb)
    res["launches"] = launches
    res["prof"] = device_breakdown(lambda: step(state[0], batch), 1, top=8)

    with split_train_backward():
        s_losses, _, s_times, s_launches = run(step, 2)
    want = _launches(flash_fwd=2 * 2 * n_layers, dq=2 * n_layers,
                     dkdv=2 * n_layers)
    assert s_launches == want, (s_launches, want)
    assert all(map(math.isfinite, s_losses)), s_losses
    res.update(split_step_ms=s_times[-1], split_losses=s_losses,
               split_launches=s_launches)

    state[0] = None  # the kernel run's parameters and optimizer
    torch.cuda.empty_cache()
    state[0] = _seed_state(cfg, tcfg, device)
    with plain_train_attention():
        c_losses, _, c_times, c_launches = run(step, 1 + TRAIN_STEPS)
    assert sum(c_launches.values()) == 0, c_launches
    state[0] = None
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses, c_losses)]
    assert max(diffs[:2]) <= CONTROL_RTOL, (losses, c_losses)
    res.update(control_losses=c_losses, control_step_ms=c_times[-1])
    print(f"train step ({n_params / 1e9:.3f} B parameters, bf16, remat, B=1 "
          f"S={TRAIN_SEQ}): {step_ms:.1f} ms (median of {TRAIN_STEPS}: "
          f"{[round(t, 1) for t in times]}), {res['tokens_per_s']:.0f} "
          f"tokens/s, {res['model_tflops_per_s']:.1f} model TFLOP/s, MFU "
          f"{res['mfu']:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; "
          f"losses {[round(x, 4) for x in losses]}; launches per step "
          f"{res['launches_per_step']}; peak {peak_gb:.1f} GB; init "
          f"{init_s:.1f} s", flush=True)
    print(f"train step, split backward: {s_times[-1]:.1f} ms; losses "
          f"{[round(x, 4) for x in s_losses]}; launches over 2 steps "
          f"{s_launches}", flush=True)
    print(f"train step, control with plain attention from the same seed: "
          f"{c_times[-1]:.1f} ms; losses {[round(x, 4) for x in c_losses]} "
          f"(kernels {[round(x, 4) for x in losses]}; rel diffs "
          f"{[float(f'{d:.2e}') for d in diffs]})", flush=True)
    return res


# the dp x sp x tp train step: its mesh, the training model's width at
# 4 layers (depth cut: one device holds every position's shard), B = dp
MESH_TRAIN = {"dp": 2, "sp": 2, "tp": 2}
MESH_TRAIN_LAYERS = 4
MESH_TRAIN_STEPS = 2  # after the first; every step compared, these timed
# the mesh step against one device, same weights and batch, bf16: each
# loss, and the first step's grad norm, within MESH_TRAIN_RTOL (H100
# readings 9.8e-6 to 9.8e-5, grad norm 1.3e-4); each (clipped) gradient of
# the first step within MESH_GRAD_RTOL in relative l2 norm (readings
# 5.1e-3 to 2.5e-2 a leaf; two single-device routes, the kernels and plain
# attention, read 3.7e-3 to 1.8e-2: bf16 rounding through 4 layers); a
# wrong kernel-9 output or dp reduction moves a leaf by O(1), a wrong
# gradient scale moves the grad norm
MESH_TRAIN_RTOL = 1e-3
MESH_GRAD_RTOL = 5e-2


def _whole_grads(params):
    """(name, gradient) of every tree leaf of `params` after a step, a
    split leaf's shards' gradients joined into its whole tensor (a pp
    tree's stacked leaves named "layers.<key>")."""
    import torch

    from burst_attn_tpu_torch.models.transformer import (
        Shards, layer_keys, tree_leaves,
    )

    layers = params["layers"]
    names = ["embed"] + ([f"layers.{k}" for k in layer_keys(layers)]
                         if isinstance(layers, dict) else
                         [f"layers[{i}].{k}" for i, layer in enumerate(
                             layers) for k in layer_keys(layer)]) + [
        "final_norm", "lm_head"]
    grads = [torch.cat([t.grad for t in x.parts], dim=x.dim)
             if isinstance(x, Shards) else x.grad.clone()
             for x in tree_leaves(params)]
    return list(zip(names, grads))


def mesh_train_phase(device):
    """A dp=2 sp=2 tp=2 train step at the training model's width (bf16,
    remat, 4 layers, B=2 S=TRAIN_SEQ, the fused ring over each dp group's
    sp=2 ring, its tp positions' heads in one launch) against the same
    model, weights and batch on one device (the flash kernels): every
    loss of 1 + MESH_TRAIN_STEPS steps and the first step's grad norm
    within MESH_TRAIN_RTOL, and each of the first step's (clipped)
    gradients, joined over tp, within MESH_GRAD_RTOL in relative l2
    norm; launches a mesh step:
    kernel 8 twice (forward, remat recompute) and kernel 9 once a layer
    and a dp group; step ms of both (median of the steps after the
    first).  Returns the phase's numbers."""
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import (
        ModelConfig, ShardedParams,
    )

    t_phase = time.perf_counter()
    layers, b = MESH_TRAIN_LAYERS, MESH_TRAIN["dp"]
    cfg1 = _train_model(TRAIN_DIMS["n_layers"], torch.bfloat16)
    tcfg = train.TrainConfig()
    key = (cfg1.n_layers, cfg1.d_model, cfg1.n_heads, cfg1.n_kv_heads,
           cfg1.d_ff, cfg1.vocab, cfg1.dtype)
    if key not in _SEED_PARAMS:
        _seed_state(cfg1, tcfg, device)
    leaves = _SEED_PARAMS[key]
    per = len(leaves[1:-2]) // cfg1.n_layers
    # the seed's embed, first `layers` layers, final norm and lm_head
    cut = leaves[:1 + per * layers] + leaves[-2:]
    one_cfg = _train_model(layers, torch.bfloat16)
    mesh_cfg = ModelConfig(**{**TRAIN_DIMS, "n_layers": layers},
                           dtype=torch.bfloat16, remat=True,
                           attn_backend="fused_ring")
    res = {"mesh": MESH_TRAIN, "layers": layers, "batch": b,
           "seq": TRAIN_SEQ}
    grads = {}
    for name, cfg, mesh in (("one device", one_cfg, None),
                            ("mesh", mesh_cfg, train.make_mesh(MESH_TRAIN))):
        params = train.place_params(_params_like(cut, one_cfg), cfg, mesh)
        assert isinstance(params, ShardedParams) == (mesh is not None)
        state = (params, train._optimizer(params, tcfg))
        step = train.make_train_step(cfg, tcfg, mesh, device=device)
        batch = train.make_batch(1, cfg, mesh, batch=b, seq=TRAIN_SEQ,
                                 device=device)
        losses, gnorms, times, launches = [], [], [], []
        for i in range(1 + MESH_TRAIN_STEPS):
            _reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            launches.append(_counts())
            if i == 0:
                grads[name] = _whole_grads(params)
        assert all(map(math.isfinite, losses + gnorms)), (name, losses)
        if mesh is None:
            want = _launches(flash_fwd=2 * layers, fused=layers)
        else:
            want = _launches(fused_ring_fwd=2 * layers * MESH_TRAIN["dp"],
                             fused_ring_bwd=layers * MESH_TRAIN["dp"])
        assert all(x == want for x in launches), (name, launches, want)
        res[name] = dict(losses=losses, grad_norms=gnorms,
                         step_ms=statistics.median(times[1:]),
                         step_ms_all=times, launches_per_step=launches[0])
        del state, step, params
        torch.cuda.empty_cache()
    one, mesh_r = res["one device"], res["mesh"]
    rels = [abs(a - c) / abs(c) for a, c in zip(
        mesh_r["losses"] + mesh_r["grad_norms"][:1],
        one["losses"] + one["grad_norms"][:1])]
    assert max(rels) <= MESH_TRAIN_RTOL, (rels, mesh_r, one)
    res["loss_rel_diffs"] = rels[:-1]
    res["grad_norm_rel_diff"] = rels[-1]
    errs = {}
    for (what, a), (what1, c) in zip(grads["mesh"], grads["one device"]):
        assert what == what1 and a.shape == c.shape, (what, what1)
        errs[what] = float((a.float() - c.float()).norm()
                           / c.float().norm().clamp(min=1e-30))
    del grads
    worst = max(errs, key=errs.get)
    res["grad_rel_l2"] = errs
    print(f"mesh train step gradients, relative l2 error a leaf: {errs}",
          flush=True)
    assert errs[worst] <= MESH_GRAD_RTOL, (worst, errs[worst])
    res["seconds"] = time.perf_counter() - t_phase
    print(f"mesh train step {MESH_TRAIN} ({layers} layers of the training "
          f"model, bf16, remat, B={b} S={TRAIN_SEQ}, fused ring): "
          f"{mesh_r['step_ms']:.1f} ms (one device "
          f"{one['step_ms']:.1f} ms, same weights and batch); losses "
          f"{mesh_r['losses']} (one device {one['losses']}; rel diffs "
          f"{[float(f'{d:.2e}') for d in rels[:-1]]}); first grad norm "
          f"{mesh_r['grad_norms'][0]} (one device {one['grad_norms'][0]}; "
          f"rel diff {rels[-1]:.2e}); largest relative l2 error of a "
          f"gradient {errs[worst]:.2e} ({worst}); launches "
          f"a step {mesh_r['launches_per_step']}; phase "
          f"{res['seconds']:.1f} s", flush=True)
    return res


# the run across processes: two processes share the one card (gloo, the
# payloads staged through pinned host buffers; NCCL refuses two ranks on
# one device), each check against the one-process run on the card
MH_RING = dict(b=1, n=16, s=2048, d=128)  # a ring position's shard: the
# ring train step's (N16, S_local 2048), on inter=2 (the processes) x
# intra=2 (local): S = 8192
MH_MESH = {"dp": 2, "sp": 2}  # the train step: dp across the processes
MH_STEPS = 2  # after the first; every step compared, these timed
MH_RING_CALLS = 3  # the ring op: a compared call, then these timed
MH_TIMEOUT_S = 600.0  # a child not done by then fails the phase
# runner --multihost: the loader shards, the rank-0 checkpoint (written
# while the other process waits) and the resume at the training model's
# full width, 1 layer, S 2048
MH_RUNNER = dict(vocab=TRAIN_DIMS["vocab"], d_model=TRAIN_DIMS["d_model"],
                 n_layers=1, n_heads=TRAIN_DIMS["n_heads"],
                 d_ff=TRAIN_DIMS["d_ff"], seq=2048)
# (d) the single ring sp=4 split 2 + 2 between the processes (every hop
# crosses them), at MH_RING's shard: S 8192
MH_SP_RING = {"sp": 4}
# (e) a train step a newly crossing axis, at the training model's width
# (MH_NEW_LAYERS layer a stage, bf16, remat, S TRAIN_SEQ): tp=2 across
# the processes x sp=2, the MoE model (MOE) with its experts on dp=2
# across them x sp=2, the pipeline pp=2 across them (a stage a process,
# 2 microbatches of a row) x sp=2; a compared step, then MH_NEW_STEPS
# timed
MH_NEW_MESH = {"tp": {"tp": 2, "sp": 2}, "ep": {"dp": 2, "sp": 2},
               "pp": {"pp": 2, "sp": 2}}
MH_NEW_LAYERS = 1
MH_NEW_STEPS = 1
MH_MOE_SEED = 3  # _moe_params' seed of (e)'s MoE weights


def _mh_new_cfg(name):
    """(e)'s model for `name` ("tp", "ep" or "pp")."""
    import torch

    kw = {"tp": dict(head_axis="tp"),
          "ep": dict(batch_axis="dp", expert_axis="dp", **MOE),
          "pp": dict(pp_axis="pp", pp_microbatches=2)}[name]
    stages = MH_NEW_MESH[name].get("pp", 1)
    return _train_model(MH_NEW_LAYERS * stages, torch.bfloat16, **kw)


def _mh_new_params(name, cfg, paths, device):
    """(e)'s weights, whole: the seed weights' first layers (tp; pp's
    stacked), or _moe_params from MH_MOE_SEED on the card (ep): the same
    in every process."""
    import dataclasses

    import torch

    from burst_attn_tpu_torch.models.pipeline_lm import stack_layers

    if name == "ep":
        return _moe_params(cfg, MH_MOE_SEED, device)
    cut = torch.load(paths["seed"], map_location=device)
    per = len(cut[1:-2]) // MESH_TRAIN_LAYERS
    flat = dataclasses.replace(cfg, pp_axis=None, pp_microbatches=1)
    params = _params_like(cut[:1 + per * cfg.n_layers] + cut[-2:], flat)
    if cfg.pp_axis is None:
        return params
    return dict(params, layers=stack_layers(
        [{k: t.detach() for k, t in x.items()} for x in params["layers"]]))


def _mh_ring_launches(r, held, w, what):
    """Kernels 1-5 on the scan ring in one process: `held` positions x `w`
    rounds of kernel 1, of the flash backward on the route it took (the
    fused kernel, or the split pair), kernels 8-9 never."""
    n = held * w
    assert r["flash_fwd"] == n and r["fused_ring_fwd"] == 0 and r[
        "fused_ring_bwd"] == 0, (what, r)
    assert (r["fused"] == n and r["dq"] == r["dkdv"] == 0) or (
        r["fused"] == 0 and r["dq"] == r["dkdv"] == n), (what, r)


def _mh_gathered_grads(params):
    """_whole_grads of a tree whose tp shards may lie in several
    processes: their gradients gathered first (every process calls it)."""
    import torch

    from burst_attn_tpu_torch.models.transformer import Shards, tree_leaves
    from burst_attn_tpu_torch.parallel.mesh import _gathered

    named = _whole_grads(params)
    out = []
    for (what, g), x in zip(named, tree_leaves(params)):
        if isinstance(x, Shards) and x.total > len(x.parts):
            g = torch.cat(_gathered([t.grad for t in x.parts], x.axis,
                                    x.mesh)[0], dim=x.dim)
        out.append((what, g))
    return out


def _mh_ring_inputs(device):
    """The ring op's q, k, v, do (bf16, layout order, the whole S) from a
    seeded generator on the card: the same tensors in every process."""
    import torch

    r = MH_RING
    g = torch.Generator(device=device).manual_seed(41)
    return [torch.randn(r["b"], r["n"], 4 * r["s"], r["d"], generator=g,
                        device=device).to(torch.bfloat16) for _ in range(4)]


def _mh_ring(mesh, backend, q, k, v, do, seq_axes=("inter", "intra")):
    """burst_attn forward and backward on `mesh`'s ring over `seq_axes`
    (the double ring by default) -> (o, dq, dk, dv)."""
    from burst_attn_tpu_torch.parallel import burst

    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    o = burst.burst_attn(qs, ks, vs, mesh=mesh, seq_axes=seq_axes,
                         causal=True, layout="zigzag", backend=backend)
    o.backward(do)
    return o.detach(), qs.grad, ks.grad, vs.grad


def _mh_train_cfg(layers):
    import torch

    return _train_model(layers, torch.bfloat16, batch_axis="dp")


def _mh_steps(step, state, batch, n):
    """n train steps: (losses, grad norms, host ms a step)."""
    import torch

    losses, norms, times = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m = step(state, batch)  # the state is updated in place
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return losses, norms, times


def _mh_wait(paths, key):
    """Block until the parent has written paths[key] ("go": the children
    may take the card; "ready": the one-process references are written)
    or given up (paths["abort"]: raises); returns the seconds waited."""
    t0 = time.perf_counter()
    while not os.path.exists(paths[key]):
        if os.path.exists(paths["abort"]):
            raise RuntimeError("the parent's one-process references failed")
        if time.perf_counter() - t0 > MH_TIMEOUT_S:
            raise TimeoutError(f"the parent wrote no {key!r} file")
        time.sleep(0.05)
    return time.perf_counter() - t0


def _mh_runner(paths):
    """(c) runner --multihost --mesh dp=2,sp=2 at MH_RUNNER's size: a
    step with a checkpoint, then a run resuming from it: both histories,
    this rank's checkpoint writes, the checkpoint steps left, seconds."""
    from burst_attn_tpu_torch.models import runner
    from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

    writes = []
    write = Checkpointer._write

    def counted(self, step_, state_):
        writes.append(step_)
        return write(self, step_, state_)

    Checkpointer._write = counted
    d = MH_RUNNER
    argv = ["--data", paths["tokens"], "--multihost", "--mesh", "dp=2,sp=2",
            "--batch", "1", "--seq-len", str(d["seq"]), "--vocab",
            str(d["vocab"]), "--d-model", str(d["d_model"]), "--n-layers",
            str(d["n_layers"]), "--n-heads", str(d["n_heads"]),
            "--d-ff", str(d["d_ff"]), "--log-every", "1", "--ckpt-dir",
            paths["ckpt"], "--ckpt-every", "1", "--ckpt-keep", "1",
            "--device", paths["device"]]
    t = time.perf_counter()
    try:
        _, first = runner.main(argv + ["--steps", "1"])
        _, resumed = runner.main(argv + ["--steps", "2"])
    finally:
        Checkpointer._write = write
    return dict(first=first, resumed=resumed, writes=writes,
                steps=Checkpointer(paths["ckpt"]).steps(),
                s=time.perf_counter() - t)


def _mh_sp_ring(paths, device, rank):
    """(d) in a child: the single ring sp=4 split 2 + 2 between the two
    processes on its half of S (positions 2 rank, 2 rank + 1), the fused
    backend declined (counted) and kernels 1-5 launched on the scan ring,
    bitwise against the one-process sp=4 ring in paths["sp4"]; then
    MH_RING_CALLS timed calls: ms, bytes staged, the wait of the
    payload hops posted a round early and of the blocking dq hops."""
    import statistics

    import torch

    from burst_attn_tpu_torch import obs
    from burst_attn_tpu_torch.parallel.collectives import TAGS
    from burst_attn_tpu_torch.utils import multihost

    mesh = multihost.make_hybrid_mesh(ici={}, dcn=MH_SP_RING, device=device)
    half = 2 * MH_RING["s"]
    sl = slice(rank * half, (rank + 1) * half)
    q, k, v, do = (t[:, :, sl].contiguous()
                   for t in _mh_ring_inputs(device))
    want = [t[:, :, sl] for t in torch.load(paths["sp4"],
                                            map_location=device)]
    obs0 = obs.counter_values()
    _reset_counts()
    got = _mh_ring(mesh, "fused_ring", q, k, v, do, seq_axes=("sp",))
    torch.cuda.synchronize()
    out = {"launches": _counts()}
    _mh_ring_launches(out["launches"], 2, MH_SP_RING["sp"], "sp4 ring")
    out["fallback"] = {k_: v_ for k_, v_ in obs.counter_deltas(
        obs0).items() if k_.startswith("burst.fused_fallback")}
    assert out["fallback"] == {
        "burst.fused_fallback{pass=fwd,reason=spans-processes}": 1,
        "burst.fused_fallback{pass=bwd,reason=spans-processes}": 1}, \
        out["fallback"]
    bad = [n for n, a, b in zip(("o", "dq", "dk", "dv"), got, want)
           if not torch.equal(a, b)]
    assert not bad, f"sp=4 ring across processes differs in {bad}"
    del got, want
    mesh.transport.reset_stats()
    times = []
    for _ in range(MH_RING_CALLS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _mh_ring(mesh, "fused_ring", q, k, v, do, seq_axes=("sp",))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    st = mesh.transport.stats
    n_pay, s_pay = st["waits_by_tag"].get(TAGS[("pay", "intra")], [0, 0.0])
    n_dq, s_dq = st["waits_by_tag"].get(TAGS[("dq", "intra")], [0, 0.0])
    out.update(ms=statistics.median(times), ms_all=times, transport=st,
               staged_mb_a_call=st["bytes"] / MH_RING_CALLS / 1e6,
               stage_ms_a_call=st["stage_s"] / MH_RING_CALLS * 1e3,
               pay_hop_wait_ms=s_pay / max(n_pay, 1) * 1e3,
               dq_hop_wait_ms=s_dq / max(n_dq, 1) * 1e3,
               hops_a_call=st["hops"] / MH_RING_CALLS)
    return out


def _mh_new_step(paths, device, rank, name):
    """(e) in a child: the train step of `name` (MH_NEW_MESH) laid over
    the two processes from the whole weights every process makes alike
    (its tp shards, its dp group's row and experts, or its stage): the
    compared step's loss, grad norm and every gradient (tp shards
    gathered) bitwise the one-process step's in paths[name], its kernel
    1-5 launches (this process's ring: 2 positions x 2 rounds a layer
    run, its stage's layers x the microbatches; kernel 1 twice with
    remat); then MH_NEW_STEPS timed steps: ms and the transport's bytes a
    step."""
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train

    sizes = MH_NEW_MESH[name]
    ref = torch.load(paths[name], map_location=device)
    cfg = _mh_new_cfg(name)
    # a process's layer runs a step: its stage's layers x the microbatches
    units = cfg.n_layers // sizes.get("pp", 1) * cfg.pp_microbatches
    tcfg = train.TrainConfig()
    mesh = train.make_mesh(sizes, process_axes="auto", device=device)
    params = train.place_params(_mh_new_params(name, cfg, paths, device),
                                cfg, mesh)
    state = (params, train._optimizer(params, tcfg))
    step = train.make_train_step(cfg, tcfg, mesh, device=device)
    batch = train.make_batch(1, cfg, sizes, batch=sizes.get("dp", 1)
                             * cfg.pp_microbatches, seq=TRAIN_SEQ,
                             device=device)
    if "dp" in sizes:
        batch = {k_: v_[rank:rank + 1] for k_, v_ in batch.items()}
    _reset_counts()
    losses, norms, _ = _mh_steps(step, state, batch, 1)
    launches = _counts()
    w = sizes["sp"]
    per = {k_: v_ // units for k_, v_ in launches.items()}
    _mh_ring_launches(dict(per, flash_fwd=per["flash_fwd"] // 2), w, w,
                      f"{name} step")
    grads = _mh_gathered_grads(params)
    bad = [what for (what, a), b in zip(grads, ref["grads"])
           if not torch.equal(a, b)]
    del grads, ref["grads"]
    assert not bad, f"{name} step across processes differs in {bad}"
    assert losses == ref["losses"][:1] and norms == ref["grad_norms"][:1], (
        losses, norms, ref)
    mesh.transport.reset_stats()
    more = _mh_steps(step, state, batch, MH_NEW_STEPS)
    st = mesh.transport.stats
    assert more[0] == ref["losses"][1:], (more[0], ref["losses"])
    out = dict(launches=launches, losses=losses + more[0],
               grad_norms=norms + more[1], ms_all=more[2],
               ms=statistics.median(more[2]), transport=st,
               staged_mb_a_step=st["bytes"] / MH_NEW_STEPS / 1e6,
               stage_ms_a_step=st["stage_s"] / MH_NEW_STEPS * 1e3,
               wait_ms_a_step=st["wait_s"] / MH_NEW_STEPS * 1e3)
    del state, step, params
    torch.cuda.empty_cache()
    return out


def _mh_child(paths):
    """One of the two processes of the multihost phase (rank from the
    group), booted beside the phase before it: once the parent writes
    "go", (c) runner --multihost (while the parent computes the
    one-process references); then (a) the ring op on its half of S,
    checked against the one-process output in paths["ring"]; (b) the dp=2
    x sp=2 train step on its row of the batch from the seed weights in
    paths["seed"], every loss and the first step's gradients against
    paths["train"]; (d) the single ring sp=4 split between the processes
    (_mh_sp_ring); (e) the tp step, the MoE step with its experts on dp
    and the pp step, tp, dp and pp across the processes (_mh_new_step).
    Returns the numbers; any mismatch raises."""
    import statistics

    import torch

    from burst_attn_tpu_torch import obs
    from burst_attn_tpu_torch.device import resolve_device
    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.utils import multihost

    out = {"go_wait_s": _mh_wait(paths, "go")}
    t_child = time.perf_counter()
    device = resolve_device(paths["device"])
    rank = multihost.process_index()
    out.update(rank=rank, runner=_mh_runner(paths))
    torch.cuda.empty_cache()
    out["ready_wait_s"] = _mh_wait(paths, "ready")
    # (a) the ring op, inter across the processes
    mesh = multihost.make_hybrid_mesh(ici={"intra": 2}, dcn={"inter": 2},
                                      device=device)
    half = 2 * MH_RING["s"]
    sl = slice(rank * half, (rank + 1) * half)
    q, k, v, do = (t[:, :, sl].contiguous()
                   for t in _mh_ring_inputs(device))
    want = [t[:, :, sl] for t in torch.load(paths["ring"],
                                            map_location=device)]
    obs0 = obs.counter_values()
    _reset_counts()
    # the fused backend: declined across processes, the scan ring runs
    got = _mh_ring(mesh, "fused_ring", q, k, v, do)
    torch.cuda.synchronize()
    out["ring_launches"] = _counts()
    out["ring_fallback"] = {k_: v_ for k_, v_ in obs.counter_deltas(
        obs0).items() if k_.startswith("burst.fused_fallback")}
    out["ring_o_err"] = _check_o("multihost ring o", got[0], want[0],
                                 torch.bfloat16)
    out["ring_grad_err"] = _check_grads_bf16("multihost ring", got[1:],
                                             want[1:])
    out["ring_bitwise"] = all(torch.equal(a, b) for a, b in zip(got, want))
    del got, want
    mesh.transport.reset_stats()
    times = []
    for _ in range(MH_RING_CALLS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _mh_ring(mesh, "fused_ring", q, k, v, do)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    st = mesh.transport.stats
    out["ring_ms"] = statistics.median(times)
    out["ring_ms_all"] = times
    out["ring_transport"] = st
    # the inter hops waited for after their intra cycle: the payload
    # stream's (the forward's KV base, the backward's q-side base)
    n_pay, s_pay = st["waits_by_tag"].get(1, [0, 0.0])
    n_dq, s_dq = st["waits_by_tag"].get(2, [0, 0.0])
    out["prefetch_wait_ms"] = s_pay / max(n_pay, 1) * 1e3
    out["dq_hop_wait_ms"] = s_dq / max(n_dq, 1) * 1e3
    out["stage_ms_a_call"] = st["stage_s"] / MH_RING_CALLS * 1e3
    del q, k, v, do
    # (b) the train step, dp across the processes
    ref = torch.load(paths["train"], map_location=device)
    cfg = _mh_train_cfg(ref["layers"])
    tcfg = train.TrainConfig()
    mesh = train.make_mesh(MH_MESH, process_axes=("dp",), device=device)
    cut = torch.load(paths["seed"], map_location=device)
    params = train.place_params(_params_like(cut, cfg), cfg, mesh)
    del cut
    state = (params, train._optimizer(params, tcfg))
    step = train.make_train_step(cfg, tcfg, mesh, device=device)
    full = train.make_batch(1, cfg, MH_MESH, batch=MH_MESH["dp"],
                            seq=TRAIN_SEQ, device=device)
    batch = {k_: v_[rank:rank + 1] for k_, v_ in full.items()}
    _reset_counts()
    losses, norms, times = _mh_steps(step, state, batch, 1)
    out["train_launches"] = _counts()
    errs = {}
    for (what, a), b in zip(_whole_grads(params), ref["grads"]):
        errs[what] = (float((a.float() - b.float()).norm()
                            / b.float().norm().clamp(min=1e-30)),
                      _max_err(a, b))
    del ref["grads"]
    mesh.transport.reset_stats()
    more = _mh_steps(step, state, batch, MH_STEPS)
    losses, norms, times = (x + y for x, y in zip((losses, norms, times),
                                                  more))
    st = mesh.transport.stats
    out.update(losses=losses, grad_norms=norms, step_ms_all=times,
               step_ms=statistics.median(times[1:]),
               stage_ms_a_step=st["stage_s"] / MH_STEPS * 1e3,
               gather_wait_ms_a_step=st["wait_s"] / MH_STEPS * 1e3,
               gathered_mb_a_step=st["bytes"] / MH_STEPS / 1e6,
               grad_errs=errs)
    rels = [abs(a - c) / abs(c) for a, c in zip(
        losses + norms[:1], ref["losses"] + ref["grad_norms"][:1])]
    out["loss_rel_diffs"] = rels
    out["train_bitwise"] = (losses == ref["losses"]
                            and norms == ref["grad_norms"]
                            and all(e[1] == 0 for e in errs.values()))
    assert max(rels) <= MESH_TRAIN_RTOL, (rels, losses, ref["losses"])
    worst = max(errs, key=lambda w: errs[w][0])
    assert errs[worst][0] <= MESH_GRAD_RTOL, (worst, errs[worst])
    del state, step, params, batch, full
    torch.cuda.empty_cache()
    # (d) the single ring split between the processes; (e) tp and the
    # MoE experts on dp across them
    out["sp4"] = _mh_sp_ring(paths, device, rank)
    for name in MH_NEW_MESH:
        out[name] = _mh_new_step(paths, device, rank, name)
    out["child_s"] = time.perf_counter() - t_child
    return out


def _mh_references(device, paths):
    """The one-process references the children check against, written
    under `paths`: (a)'s ring op on the same mesh on the scan route
    (outputs, and its ms), (b)'s seed weights (the training model's first
    MESH_TRAIN_LAYERS layers) and the one-process dp=2 x sp=2 step on
    them (every loss and grad norm, the first step's gradients, ms), (d)'s
    one-process sp=4 ring and (e)'s one-process steps likewise.  Returns
    ((a)'s ms, (b)'s numbers, (d) and (e)'s)."""
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train

    ring1 = {"inter": 2, "intra": 2}
    inputs = _mh_ring_inputs(device)
    torch.save(list(_mh_ring(ring1, "auto", *inputs)), paths["ring"])
    torch.save(list(_mh_ring(MH_SP_RING, "auto", *inputs,
                             seq_axes=("sp",))), paths["sp4"])
    times, sp4_times = [], []
    for _ in range(MH_RING_CALLS):
        for mesh, seq_axes, ts in ((ring1, ("inter", "intra"), times),
                                   (MH_SP_RING, ("sp",), sp4_times)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _mh_ring(mesh, "auto", *inputs, seq_axes=seq_axes)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
    del inputs
    layers = MESH_TRAIN_LAYERS
    cfg1 = _train_model(TRAIN_DIMS["n_layers"], torch.bfloat16)
    key = (cfg1.n_layers, cfg1.d_model, cfg1.n_heads, cfg1.n_kv_heads,
           cfg1.d_ff, cfg1.vocab, cfg1.dtype)
    if key not in _SEED_PARAMS:
        _seed_state(cfg1, train.TrainConfig(), device)
    leaves = _SEED_PARAMS[key]
    per = len(leaves[1:-2]) // cfg1.n_layers
    cut = leaves[:1 + per * layers] + leaves[-2:]
    torch.save(cut, paths["seed"])
    cfg = _mh_train_cfg(layers)
    tcfg = train.TrainConfig()
    params = train.place_params(_params_like(cut, cfg), cfg, MH_MESH)
    state = (params, train._optimizer(params, tcfg))
    step = train.make_train_step(cfg, tcfg, MH_MESH, device=device)
    batch = train.make_batch(1, cfg, MH_MESH, batch=MH_MESH["dp"],
                             seq=TRAIN_SEQ, device=device)
    losses, norms, _ = _mh_steps(step, state, batch, 1)
    grads = [g for _, g in _whole_grads(params)]
    more = _mh_steps(step, state, batch, MH_STEPS)
    one = dict(losses=losses + more[0], grad_norms=norms + more[1],
               step_ms=statistics.median(more[2]))
    torch.save(dict(layers=layers, grads=grads, **one), paths["train"])
    del state, step, params, batch, grads
    torch.cuda.empty_cache()
    new = {"sp4_ms": statistics.median(sp4_times), "sp4_ms_all": sp4_times}
    for name, sizes in MH_NEW_MESH.items():
        cfg = _mh_new_cfg(name)
        params = train.place_params(_mh_new_params(name, cfg, paths, device),
                                    cfg, sizes)
        state = (params, train._optimizer(params, tcfg))
        step = train.make_train_step(cfg, tcfg, sizes, device=device)
        batch = train.make_batch(1, cfg, sizes, batch=sizes.get("dp", 1)
                                 * cfg.pp_microbatches, seq=TRAIN_SEQ,
                                 device=device)
        losses, norms, _ = _mh_steps(step, state, batch, 1)
        grads = [g for _, g in _whole_grads(params)]
        more = _mh_steps(step, state, batch, MH_NEW_STEPS)
        new[name] = dict(losses=losses + more[0], grad_norms=norms + more[1],
                         step_ms=statistics.median(more[2]))
        torch.save(dict(grads=grads, **new[name]), paths[name])
        del state, step, params, batch, grads
        torch.cuda.empty_cache()
    return statistics.median(times), one, new


class MultihostPhase:
    """Two processes on the one card (tests/torch_multiproc_workers.py's
    spawn, a tcp://127.0.0.1 rendezvous, gloo), started here so that their boot
    (imports, the group) runs beside the phase before this one: they hold
    no CUDA context until finish() writes "go".  Then (a) burst_attn
    forward and backward at the ring train step's shard (B1 N16 S_local
    2048 D128 bf16 causal zigzag) on inter=2 (the processes) x intra=2,
    the fused backend declined (counted) and the scan ring's kernels 1-5
    launched, against the one-process run on the same mesh; (b) the dp=2
    (the processes) x sp=2 train step of the training model's width at
    MESH_TRAIN_LAYERS layers (bf16, remat, S=TRAIN_SEQ, a row a process)
    from the seed weights, every loss of 1 + MH_STEPS steps and the first
    step's gradients against the one-process dp=2 x sp=2 step
    (MESH_TRAIN_RTOL / MESH_GRAD_RTOL; bitwise expected); (c) runner
    --multihost --mesh dp=2,sp=2 (MH_RUNNER): a step with a checkpoint
    written by rank 0 alone, then a resume in both; (d) the single ring
    sp=4 split 2 + 2 between the processes at (a)'s shard, bitwise the
    one-process sp=4 ring, each process's kernel 1-5 launches exact (its 2
    positions x 4 rounds), the fused backend's decline counted; (e) a
    step at the training model's width (MH_NEW_LAYERS layer a stage) on
    tp=2 across the processes x sp=2, on the MoE model with its experts on
    dp=2 across them x sp=2 and on the pipeline pp=2 across them x sp=2,
    each bitwise the one-process step on the same weights and batch.  The children run (c)
    while finish() computes the one-process references (_mh_references),
    which reach them through files under build/multihost/ (with the token
    file; a "ready" file last).  A child that fails or outlives
    MH_TIMEOUT_S fails the phase; a smoke that fails before finish()
    writes "abort" at exit, and the children stop."""

    def __init__(self, device):
        import shutil
        import threading
        from pathlib import Path

        import numpy as np

        from burst_attn_tpu_torch.data import write_token_file

        self.device = device
        self.root = Path(__file__).resolve().parent / "build" / "multihost"
        shutil.rmtree(self.root, ignore_errors=True)
        self.root.mkdir(parents=True)
        self.paths = {k: str(self.root / f) for k, f in (
            ("ring", "ring_ref.pt"), ("seed", "seed.pt"),
            ("sp4", "sp4_ref.pt"), ("tp", "tp_ref.pt"), ("ep", "ep_ref.pt"),
            ("pp", "pp_ref.pt"),
            ("train", "train_ref.pt"), ("tokens", "train.batd"),
            ("ckpt", "ckpt"), ("go", "go"), ("ready", "ready"),
            ("abort", "abort"))}
        self.paths["device"] = str(device)
        rng = np.random.default_rng(5)  # runner_phase's token file
        write_token_file(self.paths["tokens"], rng.integers(
            0, MH_RUNNER["vocab"], size=16 * (MH_RUNNER["seq"] + 1)))
        self.got, self.t_spawn = {}, time.perf_counter()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        atexit.register(self._abort)

    def _run(self):
        sys.path.insert(0, str(self.root.parents[1] / "tests"))
        import torch_multiproc_workers as W

        try:
            self.got["res"] = W.spawn(
                _mh_child, 2, (self.paths,),
                init_method=f"tcp://127.0.0.1:{W.free_port()}",
                timeout_s=MH_TIMEOUT_S, out_dir=str(self.root))
        except BaseException as e:  # noqa: BLE001 -- raised by finish()
            self.got["error"] = e
        self.got["s"] = time.perf_counter() - self.t_spawn

    def _abort(self):
        if self.root.exists():
            (self.root / "abort").touch()

    def finish(self):
        """Run the phase: "go", the references, "ready", the children's
        results checked and printed.  Returns the numbers with the
        children's kernel launches."""
        import shutil
        from pathlib import Path

        t_phase = time.perf_counter()
        paths = self.paths
        Path(paths["go"]).touch()
        try:
            t0 = time.perf_counter()
            ring1_ms, one, new = _mh_references(self.device, paths)
            t_refs = time.perf_counter() - t0
            Path(paths["ready"]).touch()
        except BaseException:
            Path(paths["abort"]).touch()
            raise
        finally:
            self.thread.join()
        if "error" in self.got:
            raise self.got["error"]
        out = _mh_report(self.got["res"], ring1_ms, one, new, t_refs)
        shutil.rmtree(self.root, ignore_errors=True)
        out["children_s"] = self.got["s"]
        out["boot_overlap_s"] = t_phase - self.t_spawn
        out["seconds"] = time.perf_counter() - t_phase
        waits = [round(r["ready_wait_s"], 1) for r in out["ranks"]]
        print(f"multihost phase: {out['seconds']:.1f} s (the children "
              f"booted beside the phase before it, "
              f"{out['boot_overlap_s']:.1f} s earlier; the one-process "
              f"references {t_refs:.1f} s beside their runner; the "
              f"children waited {waits} s for them)", flush=True)
        return out


def _mh_report(res, ring1_ms, one, new, t_refs):
    """The multihost phase's checks of the children's results `res`, its
    lines and numbers."""
    card = card_line()
    layers = MESH_TRAIN_LAYERS
    launches = {}
    for r in res:
        # the scan ring: kernel 1 every round, the flash backward's route
        # every backward round, kernels 8-9 never (declined)
        rl, tl = r["ring_launches"], r["train_launches"]
        assert rl["flash_fwd"] > 0 and rl["fused_ring_fwd"] == 0 and rl[
            "fused_ring_bwd"] == 0, rl
        assert rl["fused"] + rl["dq"] + rl["dkdv"] > 0, rl
        assert r["ring_fallback"] == {
            "burst.fused_fallback{pass=fwd,reason=spans-processes}": 1,
            "burst.fused_fallback{pass=bwd,reason=spans-processes}": 1}, \
            r["ring_fallback"]
        assert tl["flash_fwd"] > 0 and tl["fused"] + tl["dq"] > 0, tl
        for src in (rl, tl, r["sp4"]["launches"],
                    *(r[name]["launches"] for name in MH_NEW_MESH)):
            for name, n in src.items():
                launches[name] = launches.get(name, 0) + n
        # every dp replica saw the same losses, the resume continued
        rn = r["runner"]
        assert [h["step"] for h in rn["first"]] == [1], rn
        assert [h["step"] for h in rn["resumed"]] == [2], rn
        assert all(map(math.isfinite, [h["loss"] for h in rn["first"]
                                       + rn["resumed"]])), rn
        assert rn["steps"] == [2], rn
    assert res[0]["runner"]["writes"] == [1, 2], res[0]["runner"]
    assert res[1]["runner"]["writes"] == [], res[1]["runner"]
    for run in ("first", "resumed"):  # the dp replicas' losses agree
        assert [h["loss"] for h in res[0]["runner"][run]] == [
            h["loss"] for h in res[1]["runner"][run]], run
    out = {"references_s": t_refs,
           "ring_one_process_ms": ring1_ms, "train_one_process": one,
           "one_process_new": new,
           "launches": {k: v for k, v in launches.items() if v},
           "ranks": [{k: v for k, v in r.items() if k != "runner"}
                     | {"runner": {k: v for k, v in r["runner"].items()
                                   if k != "writes"}} for r in res]}
    r0 = res[0]
    print(f"multihost ring op (2 processes on one card, gloo; inter=2 "
          f"across the processes x intra=2, B1 N16 S_local 2048 D128 bf16 "
          f"causal zigzag, S 8192; {card}): "
          f"{[round(r['ring_ms'], 2) for r in res]} ms a forward + "
          f"backward (one process, same mesh: {ring1_ms:.2f} ms); max "
          f"|o diff| {[r['ring_o_err'] for r in res]}, max |grad diff| "
          f"{[r['ring_grad_err'] for r in res]} (bitwise "
          f"{[r['ring_bitwise'] for r in res]}); prefetched inter hop "
          f"waited {[round(r['prefetch_wait_ms'], 3) for r in res]} ms "
          f"after its intra cycle, dq hop "
          f"{[round(r['dq_hop_wait_ms'], 3) for r in res]} ms; staging "
          f"{[round(r['stage_ms_a_call'], 3) for r in res]} ms a call; "
          f"{r0['ring_transport']['bytes'] / MH_RING_CALLS / 1e6:.1f} MB "
          f"sent a call; launches {r0['ring_launches']}; fused fallback "
          f"{r0['ring_fallback']}", flush=True)
    print(f"multihost train step (dp=2 across 2 processes on one card x "
          f"sp=2; {layers} layers of the training model, bf16, remat, a "
          f"row of S={TRAIN_SEQ} a process; {card}): "
          f"{[round(r['step_ms'], 1) for r in res]} ms (one process, dp=2 x "
          f"sp=2: {one['step_ms']:.1f} ms); losses {r0['losses']} (one "
          f"process {one['losses']}; bitwise "
          f"{[r['train_bitwise'] for r in res]}); largest max |grad diff| "
          f"{max(e[1] for r in res for e in r['grad_errs'].values())}; "
          f"staging {[round(r['stage_ms_a_step'], 1) for r in res]} ms a "
          f"step, gather wait "
          f"{[round(r['gather_wait_ms_a_step'], 1) for r in res]} ms a "
          f"step, {r0['gathered_mb_a_step']:.0f} MB gathered a step; "
          f"launches a step {r0['train_launches']}", flush=True)
    sp4 = [r["sp4"] for r in res]
    print(f"multihost single ring (sp=4 split 2 + 2 between 2 processes on "
          f"one card, gloo; B1 N16 S_local 2048 D128 bf16 causal zigzag, S "
          f"8192; {card}): {[round(x['ms'], 2) for x in sp4]} ms a forward "
          f"+ backward (one process, sp=4: {new['sp4_ms']:.2f} ms); bitwise "
          f"the one-process ring; staged "
          f"{[round(x['staged_mb_a_call'], 1) for x in sp4]} MB a call "
          f"({[round(x['stage_ms_a_call'], 2) for x in sp4]} ms of staging; "
          f"{sp4[0]['hops_a_call']:.0f} hops); the payload hops posted a "
          f"round early waited {[round(x['pay_hop_wait_ms'], 3) for x in sp4]}"
          f" ms each, the dq hops "
          f"{[round(x['dq_hop_wait_ms'], 3) for x in sp4]} ms; launches "
          f"{sp4[0]['launches']}; fused fallback {sp4[0]['fallback']}",
          flush=True)
    for name, what in (("tp", "tp=2 across the processes x sp=2"),
                       ("ep", "MoE (8 experts, top-2), its experts on dp=2 "
                              "across the processes x sp=2"),
                       ("pp", "pp=2 across the processes, a stage each, x "
                              "sp=2, 2 microbatches of a row")):
        rs = [r[name] for r in res]
        print(f"multihost {name} train step ({what}; {MH_NEW_LAYERS} layer "
              f"a stage of the training model, bf16, remat, "
              f"S={TRAIN_SEQ}; {card}): "
              f"{[round(x['ms'], 1) for x in rs]} ms (one process, same "
              f"weights and batch: {new[name]['step_ms']:.1f} ms); losses "
              f"{rs[0]['losses']} (one process {new[name]['losses']}), "
              f"gradients bitwise; staged "
              f"{[round(x['staged_mb_a_step'], 1) for x in rs]} MB a step "
              f"({[round(x['stage_ms_a_step'], 1) for x in rs]} ms staging, "
              f"{[round(x['wait_ms_a_step'], 1) for x in rs]} ms waiting); "
              f"launches {rs[0]['launches']}", flush=True)
    print(f"multihost runner --multihost --mesh dp=2,sp=2 ({MH_RUNNER}): "
          f"step 1 loss {r0['runner']['first'][0]['loss']:.4f} (checkpoint "
          f"written by rank 0 alone), resumed step 2 loss "
          f"{r0['runner']['resumed'][0]['loss']:.4f} on both ranks; "
          f"{[round(r['runner']['s'], 1) for r in res]} s", flush=True)
    return out


# the pipeline beside dp and tp, the MoE model's expert axis on dp, Ulysses
# with tp, every position on the one card; the training model's
# width, bf16, remat, 4 layers (every position's share on the one card)
MESH2_LAYERS = 4
PP_MESH = {"pp": 2, "dp": 2, "sp": 2, "tp": 2}
PP_MESH_B, PP_MESH_SEQ = 4, 2048  # m=2: one row a microbatch and dp group
EP_MESH = {"dp": 2, "sp": 2, "tp": 2}
EP_B = 2
ULY_TP_MESH = {"sp": 4, "tp": 2}
# the MoE step with its experts on dp against the same mesh without an
# expert axis: the first two losses (the forward, one update) within
# EP_LOSS_RTOL (the exchange moves slots, not results: the forwards
# agree to the last bit, and the expert gradients differ by their
# summation order, [E/2, 2C, d] rows against two groups' [E, C, d]; the
# third loss, after two bf16 AdamW updates of routed weights, read
# 8.2e-4 on an H100 and is reported, as train_phase reports its control's
# later losses); the dropped share a layer within EP_DROP_ATOL (a routing
# near tie in a later layer may flip a choice; equal on the H100)
EP_LOSS_RTOL = 1e-3
EP_DROP_ATOL = 1e-3


def _stacked_grads(named, n_layers):
    """_whole_grads of a list-of-layers tree with each key's layers
    stacked, named as a pp tree's leaves ("layers.<key>")."""
    import torch

    head, body, tail = named[:1], named[1:-2], named[-2:]
    per = len(body) // n_layers
    return head + [(f"layers.{name.split('.', 1)[1]}",
                    torch.stack([g for _, g in body[j::per]]))
                   for j, name in ((j, body[j][0]) for j in range(per))] \
        + tail


def _rel_l2(got, want):
    """{name: relative l2 error} of two (name, gradient) lists."""
    errs = {}
    for (what, a), (what1, c) in zip(got, want):
        assert what == what1 and a.shape == c.shape, (what, what1)
        errs[what] = float((a.float() - c.float()).norm()
                           / c.float().norm().clamp(min=1e-30))
    return errs


def _mesh_steps(name, cfg, mesh, params, batch, device, want):
    """1 + MESH_TRAIN_STEPS make_train_step steps of `params` on `mesh`
    (None: one device): losses, first-step grad norm and whole gradients
    (joined over tp), host ms a step, each step's launches (each must be
    `want`, a _counts() dict) and no fused-ring fallback."""
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train

    tcfg = train.TrainConfig()
    state = (params, train._optimizer(params, tcfg))
    step = train.make_train_step(cfg, tcfg, mesh, device=device)
    obs0 = _obs_now()
    losses, gnorms, times, launches, grads = [], [], [], [], None
    for i in range(1 + MESH_TRAIN_STEPS):
        _reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        launches.append(_counts())
        if i == 0:
            grads = _whole_grads(params)
    assert all(map(math.isfinite, losses + gnorms)), (name, losses)
    assert all(x == want for x in launches), (name, launches, want)
    assert not any(k.startswith("burst.fused_fallback")
                   for k in _obs_since(obs0)), (name, _obs_since(obs0))
    return dict(losses=losses, grad_norms=gnorms,
                step_ms=statistics.median(times[1:]), step_ms_all=times,
                launches_per_step=launches[0]), grads


def _against_one(name, res, one, grads, grads1, card):
    """The mesh run `res` against the one-device run `one`: each loss and
    the first grad norm within MESH_TRAIN_RTOL, each first-step gradient
    within MESH_GRAD_RTOL relative l2; records and prints them."""
    rels = [abs(a - c) / abs(c) for a, c in zip(
        res["losses"] + res["grad_norms"][:1],
        one["losses"] + one["grad_norms"][:1])]
    assert max(rels) <= MESH_TRAIN_RTOL, (name, rels, res, one)
    errs = _rel_l2(grads, grads1)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= MESH_GRAD_RTOL, (name, worst, errs)
    res.update(loss_rel_diffs=rels[:-1], grad_norm_rel_diff=rels[-1],
               grad_rel_l2=errs, one_device=one)
    print(f"{name}: {res['step_ms']:.1f} ms a step (one device "
          f"{one['step_ms']:.1f} ms, same weights and batch); losses "
          f"{res['losses']} (one device {one['losses']}; rel diffs "
          f"{[float(f'{d:.2e}') for d in rels[:-1]]}); first grad norm rel "
          f"diff {rels[-1]:.2e}; largest relative l2 error of a gradient "
          f"{errs[worst]:.2e} ({worst}); launches a step "
          f"{res['launches_per_step']}; {card}", flush=True)


def _tree_grads(params, loss):
    """(name, whole gradient) of every tree leaf of `params` from
    torch.autograd.grad of `loss` (a split leaf's shards joined)."""
    import torch

    from burst_attn_tpu_torch.models.transformer import (
        Shards, param_leaves, tree_leaves,
    )

    flat = list(torch.autograd.grad(loss, list(param_leaves(params))))
    out = []
    for x in tree_leaves(params):
        n = len(x) if isinstance(x, Shards) else 1
        g, flat = flat[:n], flat[n:]
        out.append(torch.cat(g, dim=x.dim) if isinstance(x, Shards)
                   else g[0])
    return out


def mesh2_train_phase(device):
    """The pipeline beside dp and tp, the expert axis on dp and Ulysses
    with tp at the training model's width (bf16,
    remat, MESH2_LAYERS layers of the seed-0 weights, fused ring):
    (1) the pipeline beside dp and tp, PP_MESH at m=2, B4 S2048, against
    one device on the same weights and batch: each of the 1 +
    MESH_TRAIN_STEPS losses and the first grad norm within
    MESH_TRAIN_RTOL, each first-step gradient (joined over tp, the
    one device's stacked per key) within MESH_GRAD_RTOL relative l2,
    exactly 2 kernel-8 and 1 kernel-9 launches a layer, microbatch and dp
    group; (2) the MoE model (8 experts, top-2, factor 1.25) with its
    experts on dp on EP_MESH, B2 S8192, against the same mesh without an
    expert axis: the losses, each layer's dropped share
    within EP_DROP_ATOL, the same launches, both step times (the first
    two losses within EP_LOSS_RTOL, the third reported); (3) Ulysses
    on ULY_TP_MESH, B1 S8192, against one device as (1), kernel 1 twice
    and the fused backward once a layer and sequence position; (4) fp32
    parity at 2 layers, S2048: pp=2 tp=2 sp=2 MoE at m=1 on the kernels
    against the regular tp=2 sp=2 path, loss within LOSS_RTOL, each
    gradient within GRAD_RTOL of its largest entry; (5) runner.fit with a
    resume on {"pp": 2, "dp": 2, "sp": 2}.  Every part prints its
    numbers beside the card's name and power limit."""
    import dataclasses
    from unittest import mock

    import numpy as np
    import torch

    import burst_attn_tpu_torch.models.transformer as tr
    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.pipeline_lm import stack_layers

    t_phase = time.perf_counter()
    card = card_line()
    layers = MESH2_LAYERS
    cfg1 = _train_model(TRAIN_DIMS["n_layers"], torch.bfloat16)
    key = (cfg1.n_layers, cfg1.d_model, cfg1.n_heads, cfg1.n_kv_heads,
           cfg1.d_ff, cfg1.vocab, cfg1.dtype)
    if key not in _SEED_PARAMS:
        _seed_state(cfg1, train.TrainConfig(), device)
    leaves = _SEED_PARAMS[key]
    per = len(leaves[1:-2]) // cfg1.n_layers
    cut = leaves[:1 + per * layers] + leaves[-2:]
    one_cfg = _train_model(layers, torch.bfloat16)
    res = {"card": card}

    # (1) pp x dp x sp x tp
    pp_cfg = _train_model(layers, torch.bfloat16, attn_backend="fused_ring",
                          batch_axis="dp", head_axis="tp", pp_axis="pp",
                          pp_microbatches=2)
    one_batch = train.make_batch(1, one_cfg, batch=PP_MESH_B,
                                 seq=PP_MESH_SEQ, device=device)
    one, g1 = _mesh_steps("pp one device", one_cfg, None,
                          train.place_params(_params_like(cut, one_cfg),
                                             one_cfg), one_batch, device,
                          _launches(flash_fwd=2 * layers, fused=layers))
    del one_batch
    flat = _params_like(cut, one_cfg)
    stacked = dict(flat, layers=stack_layers(
        [{k: t.detach() for k, t in x.items()} for x in flat["layers"]]))
    del flat
    mesh = train.make_mesh(PP_MESH)
    n = layers * pp_cfg.pp_microbatches * PP_MESH["dp"]
    pp_res, g = _mesh_steps(
        "pp x dp x sp x tp", pp_cfg, mesh,
        train.place_params(stacked, pp_cfg, mesh),
        train.make_batch(1, pp_cfg, mesh, batch=PP_MESH_B, seq=PP_MESH_SEQ,
                         device=device), device,
        _launches(fused_ring_fwd=2 * n, fused_ring_bwd=n))
    _against_one(f"pp x dp x sp x tp train step {PP_MESH} ({layers} layers "
                 f"of the training model, bf16, remat, B={PP_MESH_B} "
                 f"S={PP_MESH_SEQ}, m=2, fused ring)", pp_res, one, g,
                 _stacked_grads(g1, layers), card)
    res["pp_dp_sp_tp"] = pp_res
    del stacked, g, g1
    torch.cuda.empty_cache()

    # (2) the MoE model with its experts on dp, against no expert axis
    runs = {}
    for ea in ("dp", None):
        cfg = _train_model(layers, torch.bfloat16, **MOE,
                           attn_backend="fused_ring", batch_axis="dp",
                           head_axis="tp", expert_axis=ea)
        mesh = train.make_mesh(EP_MESH)
        params = train.place_params(_moe_params(cfg, 0, device), cfg, mesh)
        batch = train.make_batch(1, cfg, mesh, batch=EP_B, seq=TRAIN_SEQ,
                                 device=device)
        # each layer's dropped share, from one forward of the seed-0
        # weights: the mean over its routing calls (an sp position's
        # exchange over dp, which averages the dp groups; without an
        # expert axis a dp group's sp position each, dp group by dp group)
        drops = []
        real = tr.moe_shard

        def recorded(*a, _drops=drops, **kw):
            out = real(*a, **kw)
            _drops.append(float(out[2]))
            return out

        with mock.patch.object(tr, "moe_shard", recorded), \
                torch.no_grad():
            tr.forward_with_aux(params, batch["tokens"], batch["positions"],
                                cfg, mesh)
        drops = np.array(drops).reshape(-1, layers, EP_MESH["sp"])
        n = layers * EP_MESH["dp"]
        r, _ = _mesh_steps(f"moe expert_axis={ea}", cfg, mesh, params,
                           batch, device,
                           _launches(fused_ring_fwd=2 * n,
                                     fused_ring_bwd=n))
        r["dropped"] = [float(x) for x in drops.mean(axis=(0, 2))]
        runs[ea] = r
        del params, batch
        torch.cuda.empty_cache()
    ep, none = runs["dp"], runs[None]
    rels = [abs(a - c) / abs(c) for a, c in zip(ep["losses"],
                                                 none["losses"])]
    drop_diff = [abs(a - c) for a, c in zip(ep["dropped"], none["dropped"])]
    assert max(rels[:2]) <= EP_LOSS_RTOL, (rels, ep, none)
    assert max(drop_diff) <= EP_DROP_ATOL, (ep["dropped"], none["dropped"])
    assert ep["launches_per_step"] == none["launches_per_step"]
    res["moe_ep_on_dp"] = dict(ep, loss_rel_diffs=rels,
                               dropped_abs_diffs=drop_diff,
                               no_expert_axis=none)
    print(f"moe train step, experts on dp, {EP_MESH} ({layers} layers, "
          f"{MOE['n_experts']} experts top-{MOE['moe_top_k']}, factor 1.25, "
          f"bf16, remat, B={EP_B} S={TRAIN_SEQ}, fused ring): "
          f"{ep['step_ms']:.1f} ms a step (no expert axis "
          f"{none['step_ms']:.1f} ms); losses {ep['losses']} (no expert "
          f"axis {none['losses']}; rel diffs "
          f"{[float(f'{d:.2e}') for d in rels]}); dropped share a layer "
          f"{[round(x, 6) for x in ep['dropped']]} (no expert axis "
          f"{[round(x, 6) for x in none['dropped']]}; equal: "
          f"{ep['dropped'] == none['dropped']}); launches a step "
          f"{ep['launches_per_step']}; {card}", flush=True)

    # (3) Ulysses with tp
    uly_cfg = _train_model(layers, torch.bfloat16, attn_strategy="ulysses",
                           layout="contig", head_axis="tp")
    one_c = dataclasses.replace(one_cfg, layout="contig")
    one, g1 = _mesh_steps(
        "ulysses one device", one_c, None,
        train.place_params(_params_like(cut, one_c), one_c),
        train.make_batch(1, one_c, batch=1, seq=TRAIN_SEQ, device=device),
        device, _launches(flash_fwd=2 * layers, fused=layers))
    mesh = train.make_mesh(ULY_TP_MESH)
    n = layers * ULY_TP_MESH["sp"]
    uly, g = _mesh_steps(
        "ulysses x tp", uly_cfg, mesh,
        train.place_params(_params_like(cut, one_c), uly_cfg, mesh),
        train.make_batch(1, uly_cfg, mesh, batch=1, seq=TRAIN_SEQ,
                         device=device), device,
        _launches(flash_fwd=2 * n, fused=n))
    _against_one(f"ulysses x tp train step {ULY_TP_MESH} ({layers} layers, "
                 f"bf16, remat, B=1 S={TRAIN_SEQ}; a sequence position's "
                 f"kernel launches take both tp groups' heads)", uly, one,
                 g, g1, card)
    res["ulysses_tp"] = uly
    del g, g1
    torch.cuda.empty_cache()

    # (4) fp32 parity: pp x tp x sp MoE (m=1) against the regular path
    base = _train_model(2, torch.float32, **MOE, attn_backend="fused_ring",
                        head_axis="tp")
    params = _moe_params(base, 0, device)
    got = {}
    for name, cfg, mesh in (
            ("regular", base, {"tp": 2, "sp": 2}),
            ("pp", dataclasses.replace(base, pp_axis="pp"),
             {"pp": 2, "tp": 2, "sp": 2})):
        p = {k: (v.detach().clone() if k != "layers" else
                 [{kk: t.detach().clone() for kk, t in x.items()}
                  for x in v]) for k, v in params.items()}
        if cfg.pp_axis is not None:
            p["layers"] = stack_layers(p["layers"])
        p = train.place_params(p, cfg, mesh)
        batch = train.make_batch(2, cfg, mesh, batch=2, seq=2048,
                                 device=device)
        _reset_counts()
        loss = train.loss_fn(p, batch["tokens"], batch["positions"],
                             batch["labels"], cfg, mesh,
                             moe_aux_weight=0.01)
        grads = _tree_grads(p, loss)
        launches = _counts()
        assert launches == _launches(fused_ring_fwd=2 * 2,
                                     fused_ring_bwd=2), (name, launches)
        got[name] = float(loss.detach()), grads
        del p, batch
    (loss_r, gr), (loss_p, gp) = got["regular"], got["pp"]
    keys = len(gr[1:-2]) // 2
    gr = ([gr[0]] + [torch.stack(gr[1:-2][j::keys]) for j in range(keys)]
          + gr[-2:])
    loss_err = abs(loss_p - loss_r) / abs(loss_r)
    assert loss_err <= LOSS_RTOL, (loss_p, loss_r)
    worst = 0.0
    for a, b in zip(gp, gr):
        ref = float(b.abs().max())
        err = _max_err(a, b)
        assert err <= GRAD_RTOL * ref + 1e-12, (err, ref)
        worst = max(worst, err / max(ref, 1e-30))
    res["pp_tp_moe_parity"] = dict(loss_rel_err=loss_err,
                                   grad_rel_err=worst, launches=launches)
    print(f"pp x tp x sp MoE parity fp32 ({{'pp': 2, 'tp': 2, 'sp': 2}}, "
          f"m=1, 2 layers at full width, B2 S2048, fused ring, experts "
          f"whole on every tp position): loss {loss_p:.6f} vs {loss_r:.6f} "
          f"(tp=2 sp=2), rel err {loss_err:.2e}; worst gradient error "
          f"{worst:.2e} of its largest entry; {card}", flush=True)
    del params, got, gr, gp
    torch.cuda.empty_cache()

    # (5) fit with a checkpoint and a resume beside dp
    res["fit"] = runner_phase(device, mesh={"pp": 2, "dp": 2, "sp": 2},
                              batch=4, pp_axis="pp", pp_microbatches=2,
                              batch_axis="dp")
    print(f"  ({card})", flush=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"mesh2 phase: {res['seconds']:.1f} s", flush=True)
    return res


@contextlib.contextmanager
def plain_train_attention():
    """Route the training forward's attention through the plain tile
    (autograd differentiates it): the reference for the kernel route."""
    from unittest import mock

    import burst_attn_tpu_torch.models.transformer as tr
    from burst_attn_tpu_torch.ops import tile

    def plain(q, k, v, scale=None, causal=False, window=None,
              segment_ids=None):
        return tile.single_device_attention(q, k, v, scale, causal,
                                            window=window,
                                            segment_ids=segment_ids)

    with mock.patch.object(tr, "flash_attention", plain):
        yield


@contextlib.contextmanager
def split_train_backward():
    """Route the training forward's attention backward through the split
    dq + dk/dv kernels (flash_attention's fused=False) instead of the
    fused kernel the model takes."""
    import functools
    from unittest import mock

    import burst_attn_tpu_torch.models.transformer as tr
    from burst_attn_tpu_torch.ops import flash

    with mock.patch.object(tr, "flash_attention", functools.partial(
            flash.flash_attention, fused=False)):
        yield


def train_parity(device, n_layers=2, seq=2048, **kw):
    """One step's loss and gradients at full width, fp32: the kernel route
    (flash forward, remat recompute, fused backward) against the same
    model with plain attention, within LOSS_RTOL and GRAD_RTOL.  `kw`
    configures the model (MOE: its weights from _moe_params)."""
    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import (
        init_params, layer_keys, param_leaves,
    )

    cfg = _train_model(n_layers, torch.float32, **kw)
    params = (_moe_params(cfg, 0, device) if cfg.n_experts
              else init_params(cfg, seed=0, device=device))
    leaves = list(param_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    batch = train.make_batch(2, cfg, batch=1, seq=seq, device=device)

    def loss_grads():
        loss = train.loss_fn(params, batch["tokens"], batch["positions"],
                             batch["labels"], cfg)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    _reset_counts()
    loss_k, grads_k = loss_grads()
    launches = _counts()
    want = _launches(flash_fwd=2 * n_layers, fused=n_layers)
    assert launches == want, (launches, want)
    with plain_train_attention():
        loss_p, grads_p = loss_grads()
    assert _counts() == launches, "the plain route launched a kernel"
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    assert loss_err <= LOSS_RTOL, (loss_k, loss_p)
    names = ["embed"] + [f"layers.{i}.{k}" for i in range(n_layers)
                         for k in layer_keys(params["layers"][i])] + [
        "final_norm", "lm_head"]
    worst = (0.0, "")
    for name, a, b in zip(names, grads_k, grads_p):
        ref = float(b.abs().max())
        err = _max_err(a, b)
        assert err <= GRAD_RTOL * ref + 1e-12, \
            f"gradient {name}: max-abs err {err:.3e} of max {ref:.3e}"
        worst = max(worst, (err / max(ref, 1e-30), name))
    moe = (f", {cfg.n_experts} experts top-{cfg.moe_top_k}"
           if cfg.n_experts else "")
    print(f"train parity fp32 ({n_layers} layers at full width, S={seq}"
          f"{moe}): "
          f"loss {loss_k:.6f} (kernels) vs {loss_p:.6f} (plain), rel err "
          f"{loss_err:.2e}; worst gradient error {worst[0]:.2e} of its "
          f"largest entry ({worst[1]}); launches {launches}", flush=True)
    return dict(loss_rel_err=loss_err, grad_rel_err=worst[0],
                grad_worst=worst[1])


def _tree_copy(x):
    """A copy of a parameter tree (dicts, lists, Shards, tensors), every
    tensor a fresh leaf requiring grad."""
    from burst_attn_tpu_torch.models.transformer import Shards

    if isinstance(x, dict):
        return {k: _tree_copy(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree_copy(v) for v in x]
    if isinstance(x, Shards):
        return x.map(_tree_copy)
    return x.detach().clone().requires_grad_(True)


@contextlib.contextmanager
def _one_init(runner):
    """Inside the block, runner.fit's first init_train_state runs and is
    kept; a later one (the same seed and model: a fit's rerun from
    scratch) gets a copy of it with a fresh optimizer instead of numpy's
    init again (~5 s of host time at full width, 2 layers)."""
    from burst_attn_tpu_torch.models import train

    real, kept = runner.init_train_state, []

    def init(seed, cfg, tcfg, mesh=None, *, device=None):
        if kept:
            params = _tree_copy(kept[0])
            return params, train._optimizer(params, tcfg)
        params, opt = real(seed, cfg, tcfg, mesh, device=device)
        kept.append(_tree_copy(params))
        return params, opt

    runner.init_train_state = init
    try:
        yield
    finally:
        runner.init_train_state = real


def runner_phase(device, n_layers=2, seq=2048, steps=4, mesh=None,
                 packed_eos_id=None, batch=1, **kw):
    """runner.fit at full width with `n_layers` layers on a seeded random
    token file (bf16, B=1): an uninterrupted run with an eval at the end;
    then a run that checkpoints at steps/2 (max_to_keep=1) and a second
    run resuming from that checkpoint to `steps`, whose losses must match
    the uninterrupted run's within RESUME_RTOL.  On one device, or with
    `mesh` (e.g. {"sp": 4}, as `--mesh sp=4` gives it) on the ring through
    the fused ring kernels.  With `packed_eos_id` the token files are
    EOS-delimited documents (EOS at rate 4 / seq, as make_packed_batch
    draws it) and the run trains and evaluates packed: every attention
    launch of the run is a SEG instance's.  `kw` configures the model
    further: MOE (every MLP routed), attn_strategy="ulysses" (with a
    mesh: every position launches kernel 1 and the fused backward), or
    pp_axis="pp" with pp_microbatches (a mesh with a pp axis, `batch`
    rows: the stacked checkpoint, each kernel launched a layer a
    microbatch), with batch_axis="dp" beside it (each dp group's
    launches).  The files live in a temporary directory under the
    checkout's build/, deleted at the end."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from burst_attn_tpu_torch.data import write_token_file
    from burst_attn_tpu_torch.models import runner, train
    from burst_attn_tpu_torch.utils.checkpoint import Checkpointer

    ulysses = kw.get("attn_strategy") == "ulysses"
    ring = mesh is not None and not ulysses and mesh.get("sp", 1) > 1
    # kernel launches a layer: a Ulysses position each, a pp microbatch each
    pp = kw.get("pp_axis") is not None
    n_mb = kw.get("pp_microbatches", 1)
    pos = mesh["sp"] if ulysses else n_mb
    if kw.get("batch_axis"):  # each dp group its own launches
        pos *= mesh[kw["batch_axis"]]
    cfg = _train_model(n_layers, torch.bfloat16,
                       **(dict(attn_backend="fused_ring") if ring else {}),
                       **kw)
    tcfg = train.TrainConfig()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    half = steps // 2
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_",
                                     dir=build) as tmp:
        rng = np.random.default_rng(5)
        data, held = (os.path.join(tmp, f) for f in ("train.batd",
                                                     "eval.batd"))
        for path, size in ((data, 16 * (seq + 1)), (held, 4 * (seq + 1))):
            toks = rng.integers(0, cfg.vocab, size=size)
            if packed_eos_id is not None:
                toks = np.where(rng.random(size) < 4.0 / seq, packed_eos_id,
                                np.maximum(toks, 1))
            write_token_file(path, toks)
        kw = dict(data_path=data, batch=batch, seq_len=seq, log_every=1,
                  eval_data_path=held, eval_every=steps, eval_batches=2,
                  packed_eos_id=packed_eos_id)
        ck = os.path.join(tmp, "ckpt")
        _reset_counts()
        t0 = time.perf_counter()
        with _one_init(runner):
            _, full = runner.fit(cfg, tcfg,
                                 runner.RunConfig(steps=steps, **kw), mesh,
                                 device=device)
            fit_s = time.perf_counter() - t0
            launches = _counts()
            ckw = dict(ckpt_dir=ck, ckpt_every=half, ckpt_keep=1, **kw)
            runner.fit(cfg, tcfg, runner.RunConfig(steps=half, **ckw), mesh,
                       device=device)
        assert Checkpointer(ck).steps() == [half], Checkpointer(ck).steps()
        _, resumed = runner.fit(cfg, tcfg,
                                runner.RunConfig(steps=steps, **ckw), mesh,
                                device=device)
        assert Checkpointer(ck).steps() == [steps], Checkpointer(ck).steps()
    assert not os.path.exists(tmp)

    # the uninterrupted run: one backward per layer and train step, one
    # forward per layer for each eval batch (no grad, so no recompute)
    fwd, bwd = (("fused_ring_fwd", "fused_ring_bwd") if ring
                else ("flash_fwd", "fused"))
    n_eval = launches[fwd] - 2 * n_layers * steps * pos
    assert n_eval > 0 and n_eval % (n_layers * pos) == 0, launches
    want = {fwd: launches[fwd], bwd: n_layers * steps * pos}
    if packed_eos_id is not None:  # the train steps and the eval, packed
        want.update({f"{x}_seg": c for x, c in want.items()})
    assert launches == _launches(**want), launches
    loss_a = {r["step"]: r["loss"] for r in full if "loss" in r}
    loss_b = {r["step"]: r["loss"] for r in resumed if "loss" in r}
    evals = [r["eval_loss"] for r in full if "eval_loss" in r]
    assert sorted(loss_a) == list(range(1, steps + 1)), full
    assert sorted(loss_b) == list(range(half + 1, steps + 1)), resumed
    assert len(evals) == 1 and math.isfinite(evals[0]), full
    assert all(map(math.isfinite, loss_a.values()))
    diff = max(abs(loss_b[s] - loss_a[s]) / abs(loss_a[s]) for s in loss_b)
    assert diff <= RESUME_RTOL, (loss_a, loss_b)
    print(f"runner.fit ({n_layers} layers at full width, bf16, S={seq}"
          f"{f', mesh {mesh}, fused ring' if ring else ''}"
          f"{f', mesh {mesh}, ulysses' if ulysses else ''}"
          f"{f', B{batch}, {n_mb} microbatches' if pp else ''}"
          f"{f', {cfg.n_experts} experts' if cfg.n_experts else ''}"
          f"{f', packed_eos_id {packed_eos_id}' if packed_eos_id is not None else ''}): "
          f"{steps} steps in {fit_s:.1f} s, losses "
          f"{[round(loss_a[s], 4) for s in sorted(loss_a)]}, eval loss "
          f"{evals[0]:.4f}, launches {launches}; resumed from the step-"
          f"{half} checkpoint: losses "
          f"{[round(loss_b[s], 4) for s in sorted(loss_b)]}, largest rel "
          f"diff {diff:.2e} (bitwise: {diff == 0})", flush=True)
    return dict(losses=[loss_a[s] for s in sorted(loss_a)],
                resumed_losses=[loss_b[s] for s in sorted(loss_b)],
                resume_rel_diff=diff, eval_loss=evals[0], fit_s=fit_s,
                launches=launches)


# ---------------------------------------------------------------------------
# the ring forward: kernel 8 (the fused ring) and burst_attn

# kernel 8 against its plain version: (positions, layout, causal, heads,
# kv heads, local S, dtype, knobs); "two_axis" = an ("inter", "intra")
# mesh, fused_seq_factor = the double ring factored onto a flat axis
FUSED_CASES = (
    (2, "zigzag", True, 4, 2, 256, "fp32", {}),
    (3, "striped", True, 4, 1, 256, "bf16", dict(fused_kv_slots=3)),
    (3, "contig", True, 4, 2, 512, "fp32", dict(fused_topology="bidi")),
    (4, "zigzag", True, 8, 2, 512, "bf16", {}),
    (4, "striped", True, 4, 4, 256, "fp32", dict(fused_kv_slots=3)),
    (4, "contig", True, 4, 1, 1024, "bf16", {}),
    (4, "zigzag", False, 4, 2, 256, "fp32", dict(fused_topology="bidi")),
    (8, "zigzag", True, 4, 2, 256, "bf16",
     dict(fused_topology="bidi", fused_kv_slots=3, fused_ccw_slots=3)),
    (4, "zigzag", True, 4, 2, 256, "fp32", dict(two_axis=(2, 2))),
    (4, "striped", True, 8, 2, 512, "bf16",
     dict(two_axis=(2, 2), fused_kv_slots=3)),
    (8, "zigzag", True, 4, 2, 256, "bf16", dict(fused_seq_factor=(2, 4))),
    (8, "contig", True, 4, 1, 512, "fp32", dict(two_axis=(2, 4))),
    # more q tiles than resident CTAs: the state goes through scratch
    (8, "zigzag", True, 16, 4, 1024, "bf16", {}),
    (8, "striped", False, 8, 2, 512, "fp32", {}),
)
REPEATS_W8 = 20  # launches at W=8 on two slots, all bitwise equal
# the op at bench.py's headline shape and world (its fused leg's ring)
RING_B, RING_N, RING_S, RING_W = 1, 32, 65536, 8
# the handoff at the serving width: prompt over sp=4, greedy decode steps
HANDOFF_PROMPT, HANDOFF_SP, HANDOFF_STEPS = 32768, 4, 32
HANDOFF_PROMPT_FP32 = 4096


def _fused_setup(device, w, layout, causal, n, n_kv, s, key, knobs, seed):
    """(cfg, (n_inter, n_intra), (q, k, v) stacked per position, program,
    tables) of one kernel-8 case."""
    import torch

    from burst_attn_tpu_torch.ops import fused_ring
    from burst_attn_tpu_torch.parallel import burst

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[key]
    knobs = dict(knobs)
    n_inter, n_intra = knobs.pop("two_axis", (1, w))
    axes = ("inter", "intra") if n_inter > 1 else ("sp",)
    cfg = burst.BurstConfig(causal=causal, layout=layout,
                            backend="fused_ring", intra_axis=axes[-1],
                            inter_axis=axes[0] if n_inter > 1 else None,
                            **knobs)
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(w, 1, n, s, 128, generator=g, device=device).to(dtype)
    k, v = (torch.randn(w, 1, n_kv, s, 128, generator=g,
                        device=device).to(dtype) for _ in range(2))
    reason = fused_ring.supported(cfg, q.shape[1:], k.shape[1:],
                                  world=n_intra, n_inter=n_inter,
                                  dtype=dtype, device=device)
    assert reason is None, reason
    topo = fused_ring.resolve_topology(cfg, n_intra, n_inter)
    prog = fused_ring._compile_for(cfg, *topo, s=s)
    tables = [fused_ring.build_sched_table(cfg, prog, s, s, p)[0]
              for p in range(w)]
    return cfg, (n_inter, n_intra), (q, k, v), prog, tables


def check_fused_ring(device):
    """Kernel 8 against fused_ring_reference over FUSED_CASES (two launches
    torch.equal, outputs within O_TOL, lse within STATS_ATOL), then
    REPEATS_W8 launches at W=8 on two slots (each slot rewritten four
    times a launch), all bitwise equal.  Returns the largest o error."""
    import torch

    from burst_attn_tpu_torch.ops import fused_ring

    worst = 0.0
    for i, (w, layout, causal, n, n_kv, s, key, knobs) in enumerate(
            FUSED_CASES):
        cfg, ring, qkv, prog, tables = _fused_setup(
            device, w, layout, causal, n, n_kv, s, key, knobs, seed=i)
        o, lse = fused_ring.fused_ring_fwd(*qkv, cfg, *ring)
        o2, lse2 = fused_ring.fused_ring_fwd(*qkv, cfg, *ring)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2), "repeat"
        po, plse = fused_ring.fused_ring_reference(*qkv, prog, tables,
                                                   128 ** -0.5)
        what = (f"fused_ring_fwd {key} W={w} {prog.topology} {layout} "
                f"causal={causal} N{n}/{n_kv} S_local={s} slots="
                f"{list(prog.slots)}")
        err = _check_o(what, o, po, qkv[0].dtype)
        lse_err = _max_err(lse, plse)
        assert lse_err <= STATS_ATOL[key], (what, lse_err)
        worst = max(worst, err)
        print(f"{what}: max_abs_err={err:.3e} lse {lse_err:.3e}, two "
              f"launches equal", flush=True)
    cfg, ring, qkv, _, _ = _fused_setup(device, 8, "zigzag", True, 8, 2, 512,
                                        "bf16", {}, seed=99)
    first = fused_ring.fused_ring_fwd(*qkv, cfg, *ring)
    for _ in range(REPEATS_W8 - 1):
        again = fused_ring.fused_ring_fwd(*qkv, cfg, *ring)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])
    print(f"fused_ring_fwd W=8 slots=2: {REPEATS_W8} launches bitwise equal",
          flush=True)
    return worst


def ring_op_phase(device):
    """burst_attn at bench.py's headline shape (B1 N32 S65536 D128 bf16,
    causal zigzag) over mesh {"sp": 8}: the fused ring against the scan
    ring over kernel 1 (bf16 tolerance), the launch counters of each
    route, kernel 8 against its plain version at this shape, and the
    times of kernel 8, the scan route, the plain version and SDPA on the
    natural-order sequence (a yardstick).  Returns kernel 8's record for
    the kernels line."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash, fused_ring, masks
    from burst_attn_tpu_torch.parallel import burst, layouts, mesh

    b, n, s, w, d = RING_B, RING_N, RING_S, RING_W, 128
    g = torch.Generator(device=device).manual_seed(7)
    nat = [torch.randn(b, n, s, d, generator=g, device=device).to(
        torch.bfloat16) for _ in range(3)]
    q, k, v = (layouts.to_layout(t, "zigzag", w, 2) for t in nat)
    kw = dict(mesh={"sp": w}, causal=True, layout="zigzag")

    obs0 = _obs_now()
    flash.flash_fwd.launches = fused_ring.fused_ring_fwd.launches = 0
    with torch.no_grad():
        fused = burst.burst_attn(q, k, v, backend="fused_ring", **kw)
    torch.cuda.synchronize()
    fused_launches = (fused_ring.fused_ring_fwd.launches,
                      flash.flash_fwd.launches)
    with torch.no_grad():
        scan = burst.burst_attn(q, k, v, backend="auto", **kw)
    torch.cuda.synchronize()
    scan_launches = flash.flash_fwd.launches
    assert fused_launches == (1, 0), fused_launches
    # zigzag skips no round: every position runs all W rounds
    assert scan_launches == w * w, scan_launches
    assert not any(key.startswith("burst.fused_fallback")
                   for key in _obs_since(obs0)), dict(_obs_since(obs0))
    scan_err = _check_o("burst_attn fused vs scan", fused, scan,
                        torch.bfloat16)
    assert torch.isfinite(fused).all()

    cfg = burst.BurstConfig(backend="fused_ring", **{
        k_: v_ for k_, v_ in kw.items() if k_ != "mesh"})
    qs, ks, vs = (mesh.shard(t, w) for t in (q, k, v))
    del scan
    o, lse = fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, w)
    assert torch.equal(o, mesh.shard(fused, w))
    prog = fused_ring._compile_for(cfg, "uni", 1, w, s=s // w)
    tables = [fused_ring.build_sched_table(cfg, prog, s // w, s // w, p)
              for p in range(w)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    po, plse = fused_ring.fused_ring_reference(qs, ks, vs, prog,
                                               [t[0] for t in tables],
                                               d ** -0.5)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _check_o("fused_ring_fwd at the headline shape", o, po,
                   torch.bfloat16)
    assert _max_err(lse, plse) <= STATS_ATOL["bf16"]
    del po, plse
    torch.cuda.empty_cache()

    ms = time_ms(lambda: fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, w),
                 iters=3, warmup=1)
    with torch.no_grad():
        scan_ms = time_ms(lambda: burst.burst_attn(q, k, v, backend="auto",
                                                   **kw), iters=3, warmup=1)
        fused_op_ms = time_ms(lambda: burst.burst_attn(
            q, k, v, backend="fused_ring", **kw), iters=3, warmup=1)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *nat, is_causal=True), iters=5, warmup=2)
    # what the ring must do: the causal pairs this layout's rounds attend
    # (4 * D flops each: q.k and p.v), and the bytes of q, k, v read once,
    # o (bf16) and lse (fp32) written once, and every slot copy of the
    # program (the copy-in and each send: a K and a V chunk, read and
    # written)
    pairs = sum(masks.spec_pair_count(sp, s // w, s // w)
                for _, specs in tables for sp in specs)
    chunk = 2 * b * n * (s // w) * d * 2  # K and V of one position, bf16
    copies = w * (sum(prog.rows["send0"]) + sum(prog.rows["send1"])
                  + len(prog.copy_in))
    n_bytes = 2 * (4 * b * n * s * d) + 4 * b * n * s + 2 * copies * chunk
    bms, by = bound_ms(n_bytes, 4 * d * b * n * pairs)
    print(f"burst_attn at B{b} N{n} S{s} D{d} bf16 causal zigzag, mesh "
          f"{{'sp': {w}}}: fused ring {fused_op_ms:.2f} ms (kernel 8 "
          f"{ms:.2f} ms, 1 launch), scan ring over kernel 1 {scan_ms:.2f} ms "
          f"({scan_launches} launches), fused vs scan max_abs_err "
          f"{scan_err:.3e}; plain version {plain_ms:.0f} ms (kernel vs plain "
          f"{err:.3e}); SDPA on the natural-order sequence {lib_ms:.2f} ms; "
          f"bound {bms:.3f} ms ({by}); {pairs * b * n / 1e9:.3f} G causal "
          f"pairs", flush=True)
    return dict(name="fused_ring_fwd", route="cuda",
                source="burst_attn_tpu_torch/csrc/fused_ring_fwd.cu",
                replaces="burst_attn_tpu/ops/fused_ring.py:401",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, op_ms=fused_op_ms,
                scan_ms=scan_ms, scan_launches=scan_launches,
                fused_vs_scan_err=scan_err)


def _handoff_cfg(dtype, backend):
    from burst_attn_tpu_torch.models.transformer import ModelConfig

    return ModelConfig(**SERVE_DIMS, dtype=dtype, batch_axis=None,
                       head_axis=None, layout="zigzag", attn_backend=backend,
                       seq_axes=("sp",))


def _handoff_state(cfg, prompt_len, device):
    from burst_attn_tpu_torch.models.paged_decode import init_paged_state

    width = -(-(prompt_len + HANDOFF_STEPS) // PAGE)
    n_pages = -(-(width + 1) // HANDOFF_SP) * HANDOFF_SP  # + the sink
    return init_paged_state(cfg, slots=2, n_pages=n_pages, page=PAGE,
                            max_pages_per_seq=width, device=device)


def _kernel_counters():
    from burst_attn_tpu_torch.ops import flash, fused_ring, paged_attention

    return (flash.flash_fwd, fused_ring.fused_ring_fwd,
            paged_attention.paged_decode_attention)


def _stream_check(what, cfg, params, prompt, toks, device, bf16):
    """Greedy tokens teacher-forced through a dense single-device
    forward: fp32 through the plain `forward`, token-exact; bf16 (whose
    plain forward would materialize S x S scores) through forward_with_aux
    (kernel 1 over the whole sequence, no ring), every disagreement a
    near tie.  The bf16 stream's agreement rate is reported but not held
    to MIN_AGREE_BF16: at the ~3.5% near-tie flip rate measured over 575
    tokens, 32 tokens show 2 flips about one run in three, so the rate
    says nothing here; a fault shows as an O(1) gap.  The >=
    MIN_AGREE_BF16 rule holds the ring prefill at every prompt position
    against this same dense forward (_prefill_check), and the fused
    stream against the scan route (_forced_agreement).  Returns the dense
    forward's fp32 logits at the prompt positions [len(prompt), vocab]."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.models.transformer import (
        forward, forward_with_aux,
    )

    full = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
    tok = torch.from_numpy(full.astype(np.int64)).to(device)[None]
    pos = torch.arange(tok.shape[1], device=device)[None]
    with torch.no_grad():
        full = (forward_with_aux(params, tok, pos, cfg)[0] if bf16
                else forward(params, tok, pos, cfg))[0]
    lg = full[len(prompt) - 1:]
    got = torch.as_tensor(toks, device=device)
    pred = lg.argmax(-1)
    miss = (pred != got).nonzero()[:, 0].tolist()
    gaps = [(i, float(lg[i, pred[i]] - lg[i, got[i]])) for i in miss]
    check_agreement(what, (len(toks) - len(miss), len(toks), gaps), bf16,
                    min_agree=0.0)
    return full[:len(prompt)]


def _prefill_check(what, cfg, params, prompt, dense, mesh):
    """The ring prefill's next-token argmax at EVERY prompt position
    (serving.handoff's ring forward, all positions' logits) against the
    dense forward's `dense` [len(prompt), vocab]: >= MIN_AGREE_BF16 and
    every disagreement a near tie.  Over HANDOFF_PROMPT positions the
    rate means something, where a 32-token stream's does not."""
    import torch

    from burst_attn_tpu_torch.models.transformer import _logits, _rms_norm
    from burst_attn_tpu_torch.parallel import layouts
    from burst_attn_tpu_torch.serving import handoff

    with torch.no_grad():
        x, perm = handoff._ring_forward(params, prompt, cfg, mesh)
        # layout position inv_perm[i] holds natural token i
        nat = torch.from_numpy(layouts.inverse_permutation(perm)).to(
            x.device)
        x = x[0, nat]
        got = torch.cat([
            _logits(_rms_norm(x[i:i + 4096], params["final_norm"]),
                    params["lm_head"]).argmax(-1)
            for i in range(0, x.shape[0], 4096)])
    pred = dense.argmax(-1)
    miss = (pred != got).nonzero()[:, 0]
    gaps = (dense[miss, pred[miss]] - dense[miss, got[miss]]).tolist()
    check_agreement(what, (len(got) - len(miss), len(got),
                           list(zip(miss.tolist(), gaps))), True)


def _forced_agreement(cfg, params, prompt, toks, mesh, device):
    """Teacher-force `cfg`'s route on a token stream: its ring prefill
    then one dist_paged_decode_step per token of `toks`; (agreeing
    tokens, total, [(index, logit gap)] per disagreement) of its argmax
    against the stream."""
    import torch

    from burst_attn_tpu_torch.models import paged_decode as pd
    from burst_attn_tpu_torch.models.dist_decode import (
        dist_paged_decode_step,
    )
    from burst_attn_tpu_torch.serving import ring_prefill_to_pages

    st, pool = _handoff_state(cfg, len(prompt), device)
    with torch.no_grad():
        lg, st = ring_prefill_to_pages(params, prompt, st, pool, 0, cfg,
                                       mesh)
        pd.provision_capacity(st, pool, 0, len(toks))
        rows = [lg]
        feed = torch.zeros(2, dtype=torch.long, device=device)
        for t in toks[:-1]:
            feed[0] = t
            lg, st = dist_paged_decode_step(params, feed, st, cfg, mesh)
            rows.append(lg[0])
    gaps = []
    for i, (row, t) in enumerate(zip(rows, toks)):
        p = int(row.argmax())
        if p != t:
            gaps.append((i, float(row[p] - row[t])))
    return len(toks) - len(gaps), len(toks), gaps


def check_handoff_kernels(device):
    """The ring kernels at the shapes the handoff prefill gives them
    (HANDOFF_SP positions, B1, N16/Nk4, S_local = HANDOFF_PROMPT /
    HANDOFF_SP, bf16, causal zigzag) on seeded tensors: kernel 8 against
    fused_ring_reference (two launches torch.equal, o within O_TOL, lse
    within STATS_ATOL); then kernel 1 in each scan-ring round of position
    1, whose rounds hold all three zigzag specs (the causal self round,
    the first kv half, the second q half), against tile_fwd on the same
    carry-in (m, lse within STATS_ATOL, acc within ACC_RTOL), and the
    last round's finalize within O_TOL.  Returns the largest o errors
    (kernel 8, kernel 1)."""
    import torch

    from burst_attn_tpu_torch.ops import flash, fused_ring, masks, tile
    from burst_attn_tpu_torch.parallel import ring

    w, s, d = HANDOFF_SP, HANDOFF_PROMPT // HANDOFF_SP, 128
    n, n_kv = SERVE_DIMS["n_heads"], SERVE_DIMS["n_kv_heads"]
    bf16, scale = torch.bfloat16, d ** -0.5
    cfg, topo, (q, k, v), prog, tables = _fused_setup(
        device, w, "zigzag", True, n, n_kv, s, "bf16", {}, seed=21)
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, *topo)
    o2, lse2 = fused_ring.fused_ring_fwd(q, k, v, cfg, *topo)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2), "repeat"
    del o2, lse2
    po, plse = fused_ring.fused_ring_reference(q, k, v, prog, tables, scale)
    what = (f"fused_ring_fwd at the handoff's shape: bf16 W={w} zigzag "
            f"causal N{n}/{n_kv} S_local={s}")
    k8_err = _check_o(what, o, po, bf16)
    lse_err = _max_err(lse, plse)
    assert lse_err <= STATS_ATOL["bf16"], (what, lse_err)
    print(f"{what}: max_abs_err={k8_err:.3e} lse {lse_err:.3e}, two "
          f"launches equal", flush=True)
    del o, lse, po, plse
    torch.cuda.empty_cache()

    p = 1
    coords = ring.ring_coords(p, 1, w)
    st = tile.init_state(1, n, s, d, device=device)
    errs = []
    for r in range(w):
        part = ring.partition_at_round(r, *coords, 1, w)
        spec = masks.round_spec(p, part, s, s, True, "zigzag")
        carry = (None, None, None) if r == 0 else st
        got = flash.flash_fwd(q[p], k[part], v[part], *carry, scale, spec)
        st = tile.tile_fwd(q[p], k[part], v[part], *st, scale, spec)
        for a, b_, name in zip(got[:2], st[:2], ("m", "lse")):
            e = _max_err(a, b_)
            assert e <= STATS_ATOL["bf16"], (r, spec, name, e)
        acc_err = _max_err(got[2], st[2])
        acc_max = float(st[2].abs().max())
        assert acc_err <= ACC_RTOL * acc_max, (r, spec, "acc", acc_err)
        errs.append(f"round {r} kv {part} {tuple(spec)}: acc "
                    f"{acc_err / acc_max:.1e} of max")
    k1_err = _check_o("flash_fwd scan round finalize",
                      tile.finalize(*got, bf16), tile.finalize(*st, bf16),
                      bf16)
    print(f"flash_fwd in the scan ring's rounds of position {p} at the "
          f"handoff's shape (bf16 N{n}/{n_kv} S_local={s}, spec = q_lo, "
          f"q_hi, kv_hi, causal, offset): {'; '.join(errs)}; finalize "
          f"max_abs_err={k1_err:.3e}", flush=True)
    del q, k, v, st, got
    torch.cuda.empty_cache()
    return k8_err, k1_err


def handoff_checkpoint(device, mesh, prompt, want):
    """The handoff's crash consistency at the serving width (bf16, the
    fused route): a ring prefill (kernel 8), then half the decode steps
    through handoff_decode with a TokenJournal (each token appended and
    fsynced before the next step); save_paged_snapshot, drop the state,
    load_paged_snapshot and decode the rest from the last token: the
    stream must equal the uninterrupted handoff_generate's (`want`).
    Then the kill with only the journal left: a second ring prefill, the
    journal's lag re-decoded (equal to the journal), the rest decoded:
    the same stream.  Kernel 8 launches once a layer a prefill and no
    other attention kernel runs (the decode step is plain torch).
    Returns (record, launches)."""
    import os

    import torch

    from burst_attn_tpu_torch.models import paged_decode as pd
    from burst_attn_tpu_torch.ops import ragged_paged as rp
    from burst_attn_tpu_torch.serving import (
        TokenJournal, handoff_decode, journal_tokens_by_ext,
        load_paged_snapshot, ring_prefill_to_pages, save_paged_snapshot,
    )

    cfg = _handoff_cfg(torch.bfloat16, "fused_ring")
    params = model(torch.bfloat16, device)[1]
    d = _ckpt_dir()
    jpath, snap = str(d / "handoff.jsonl"), str(d / "handoff.npz")
    counters = _kernel_counters() + (rp.ragged_paged_attention,)
    half = HANDOFF_STEPS // 2

    def prefilled():
        st, pool = _handoff_state(cfg, len(prompt), device)
        last, st = ring_prefill_to_pages(params, prompt, st, pool, 0, cfg,
                                         mesh)
        pd.provision_capacity(st, pool, 0, HANDOFF_STEPS)
        return int(last.argmax()), st, pool

    def decode(st, last, n, journal=None):
        return handoff_decode(params, st, cfg, mesh, slot=0, last_token=last,
                              n_steps=n, journal=journal, rid=0)

    for f in counters:
        f.launches = 0
    rec = {}
    with torch.no_grad():
        journal = TokenJournal(jpath, truncate=True)
        first, st, pool = prefilled()
        journal.submit(0, 0, prompt, HANDOFF_STEPS)
        journal.tokens(0, [first])
        journal.sync()
        out, st = decode(st, first, half - 1, journal)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_paged_snapshot(snap, st, pool, extra={"stream": [first] + out})
        rec["save_ms"] = (time.perf_counter() - t0) * 1e3
        rec["mb"] = os.path.getsize(snap) / 1e6
        avail = pool.available
        del st, pool                        # the restart reads the disk
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        st, pool, extra = load_paged_snapshot(snap, device=device)
        torch.cuda.synchronize()
        rec["load_ms"] = (time.perf_counter() - t0) * 1e3
        assert pool.available == avail
        stream = [int(t) for t in extra["stream"]]
        rest, st = decode(st, stream[-1], HANDOFF_STEPS - len(stream))
        assert stream + rest == want, "restarted handoff stream differs"
        del st, pool
        journal.close()
        # the kill: the journal alone survives
        jt = journal_tokens_by_ext(jpath)[0]
        assert jt == want[:half], (jt, want[:half])
        first2, st, pool = prefilled()
        assert first2 == jt[0]
        lag, st = decode(st, jt[0], len(jt) - 1)
        assert lag == jt[1:], "re-decoded lag differs from the journal"
        rest2, st = decode(st, jt[-1], HANDOFF_STEPS - len(jt))
        assert jt + rest2 == want, "journal-recovered handoff stream differs"
        del st, pool
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counters}
    want_launches = dict.fromkeys(launches, 0)
    want_launches["fused_ring_fwd"] = 2 * cfg.n_layers
    assert launches == want_launches, launches
    print(f"handoff checkpoint (bf16 fused, {len(prompt)} tokens, sp="
          f"{HANDOFF_SP}): {half} tokens journaled (one fsync each), paged "
          f"snapshot {rec['mb']:.1f} MB saved in {rec['save_ms']:.1f} ms, "
          f"loaded in {rec['load_ms']:.1f} ms; the restarted stream and the "
          f"journal-only recovery (a second prefill, {len(jt) - 1} tokens "
          f"re-decoded equal to the journal) both equal the uninterrupted "
          f"{HANDOFF_STEPS} tokens; launches {launches}", flush=True)
    return rec, launches


def handoff_phase(device):
    """serving.handoff at the serving benchmark's width: a
    HANDOFF_PROMPT-token prompt over sp=4 (zigzag), prefilled through
    kernel 8 (attn_backend="fused_ring") and, as the control, the scan
    ring over kernel 1 ("auto"), then HANDOFF_STEPS greedy tokens through
    dist_paged_decode_step; the same in fp32 at HANDOFF_PROMPT_FP32
    tokens, token-exact across the routes, with the dense forward and
    with the single-host paged_decode_step (kernel 6) on the handed-off
    slot; the pool's page counts around each run and a rejected request.
    Returns the timings, agreements and the fused run's launches."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.models import paged_decode as pd
    from burst_attn_tpu_torch.models.dist_decode import (
        dist_paged_decode_step,
    )
    from burst_attn_tpu_torch.parallel import burst
    from burst_attn_tpu_torch.parallel.mesh import Mesh
    from burst_attn_tpu_torch.serving import (
        handoff_generate, ring_prefill_to_pages,
    )

    mesh = Mesh({"sp": HANDOFF_SP}, device=device)
    rng = np.random.default_rng(13)
    res = {}
    for key, dtype, plen in (("bf16", torch.bfloat16, HANDOFF_PROMPT),
                             ("fp32", torch.float32, HANDOFF_PROMPT_FP32)):
        prompt = rng.integers(1, SERVE_DIMS["vocab"], plen).astype(np.int32)
        res[f"_{key}_prompt"] = prompt
        toks = {}
        for backend in ("fused_ring", "auto"):
            cfg, params = model(dtype, device)
            cfg = _handoff_cfg(dtype, backend)
            st, pool = _handoff_state(cfg, plen, device)
            free0 = pool.available
            counters = _kernel_counters()
            obs0 = _obs_now()
            for f in counters:
                f.launches = 0
            with torch.no_grad():
                out, st = handoff_generate(params, prompt, st, pool, cfg,
                                           mesh, steps=HANDOFF_STEPS)
            torch.cuda.synchronize()
            launches = {f.__name__: f.launches for f in counters}
            stats = dict(_obs_since(obs0))
            n_layers = SERVE_DIMS["n_layers"]
            want = ({"flash_fwd": 0, "fused_ring_fwd": n_layers} if
                    backend == "fused_ring" else
                    {"flash_fwd": n_layers * HANDOFF_SP * HANDOFF_SP,
                     "fused_ring_fwd": 0})
            assert {k_: launches[k_] for k_ in want} == want, launches
            assert launches["paged_decode_attention"] == 0, launches
            assert not any(k_.startswith("burst.fused_fallback")
                           for k_ in stats), stats
            need = -(-(plen + HANDOFF_STEPS) // PAGE)
            assert pool.available == free0 - need, (pool.available, free0)
            assert all(0 <= t < cfg.vocab for t in out)
            toks[backend] = out
            if key == "bf16":
                res[f"launches_{backend}"] = launches
            # a request the pool cannot hold is refused and leaks nothing
            try:
                ring_prefill_to_pages(params, np.tile(prompt, 2), st, pool,
                                      1, cfg, mesh)
                raise AssertionError("an oversized handoff was admitted")
            except (RuntimeError, ValueError):
                pass
            assert pool.available == free0 - need
            pd.retire_slot(st, pool, 0)
            assert pool.available == free0
            if key == "bf16":
                # the prefill alone (TTFT less one sampling), then decode
                def prefill():
                    pd.retire_slot(st, pool, 0)
                    with torch.no_grad():
                        ring_prefill_to_pages(params, prompt, st, pool, 0,
                                              cfg, mesh)
                res[f"prefill_ms_{backend}"] = host_ms(prefill)
                res[f"prof_prefill_{backend}"] = device_breakdown(prefill, 1)
                pd.provision_capacity(st, pool, 0, HANDOFF_STEPS)
                feed = torch.zeros(2, dtype=torch.long, device=device)
                feed[0] = out[0]

                def step():
                    with torch.no_grad():
                        dist_paged_decode_step(params, feed, st, cfg, mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HANDOFF_STEPS - 5):
                    step()
                torch.cuda.synchronize()
                res[f"decode_ms_{backend}"] = (
                    (time.perf_counter() - t0) * 1e3 / (HANDOFF_STEPS - 5))
                res[f"prof_decode_{backend}"] = device_breakdown(step, 4)
                pd.retire_slot(st, pool, 0)
            del st, pool
        for b in toks:
            params = model(dtype, device)[1]
            dense = _stream_check(
                f"handoff {key} {b} ({plen}-token prompt, sp={HANDOFF_SP})",
                _handoff_cfg(dtype, "auto"), params, prompt, toks[b], device,
                key == "bf16")
            if key == "bf16":
                _prefill_check(f"handoff bf16 {b} prefill at every prompt "
                               f"position", _handoff_cfg(dtype, b), params,
                               prompt, dense, mesh)
            del dense
        a, c = toks["fused_ring"], toks["auto"]
        same = sum(x == y for x, y in zip(a, c))
        if key == "fp32":
            assert a == c, (a, c)
            res["_fp32_tokens"] = a
        else:
            # the scan route teacher-forced on the fused route's stream
            forced = _forced_agreement(_handoff_cfg(dtype, "auto"),
                                       model(dtype, device)[1], prompt, a,
                                       mesh, device)
            check_agreement("handoff bf16 fused stream", forced, True,
                            against="the scan route")
            res["bf16_forced_agree"] = forced[0]
            res["checkpoint"], res["launches_checkpoint"] = \
                handoff_checkpoint(device, mesh, prompt, a)
        res[f"{key}_routes_equal"] = same
        print(f"handoff {key}: fused and scan routes' free-running streams "
              f"agree on {same}/{HANDOFF_STEPS} tokens", flush=True)
        if key == "fp32":
            # the handed-off slot on one host: paged_decode_step (kernel 6)
            cfg = _handoff_cfg(dtype, "fused_ring")
            params = model(dtype, device)[1]
            st, pool = _handoff_state(cfg, plen, device)
            with torch.no_grad():
                last, st = ring_prefill_to_pages(params, prompt, st, pool, 0,
                                                 cfg, mesh)
            pd.provision_capacity(st, pool, 0, HANDOFF_STEPS)
            one = [int(last.argmax())]
            feed = torch.zeros(2, dtype=torch.long, device=device)
            paged0 = _kernel_counters()[2].launches
            for _ in range(HANDOFF_STEPS - 1):
                feed[0] = one[-1]
                with torch.no_grad():
                    lg, st = pd.paged_decode_step(params, feed, st, cfg)
                one.append(int(lg[0].argmax()))
            assert _kernel_counters()[2].launches - paged0 == \
                SERVE_DIMS["n_layers"] * (HANDOFF_STEPS - 1)
            assert one == toks["fused_ring"], (one, toks["fused_ring"])
            print("handoff fp32: the handed-off slot decoded by "
                  "paged_decode_step (kernel 6) gives the same tokens",
                  flush=True)
    print(f"handoff prefill ({HANDOFF_PROMPT} tokens, bf16, sp="
          f"{HANDOFF_SP}): fused ring {res['prefill_ms_fused_ring']:.1f} ms, "
          f"scan ring {res['prefill_ms_auto']:.1f} ms; decode step "
          f"(dist_paged_decode_step): {res['decode_ms_fused_ring']:.2f} / "
          f"{res['decode_ms_auto']:.2f} ms", flush=True)
    return res


# ---------------------------------------------------------------------------
# the dense-shard distributed decode, the ring telemetry and obs


def _dist_forced_agreement(cfg, params, prompt, toks, mesh, device):
    """Teacher-force `cfg`'s route of models.dist_decode on a stream: its
    dist_prefill, then one dist_decode_step per token of `toks`; (agreeing
    tokens, total, [(index, logit gap)] per disagreement)."""
    import torch

    from burst_attn_tpu_torch.models.dist_decode import (
        dist_decode_step, dist_prefill,
    )

    p = torch.from_numpy(prompt.astype("int64"))[None].to(device)
    with torch.no_grad():
        lg, cache = dist_prefill(params, p, cfg, mesh, gen_budget=len(toks))
        rows = [lg[0]]
        for i, t in enumerate(toks[:-1]):
            lg, cache = dist_decode_step(
                params, torch.tensor([t], device=device), len(prompt) + i,
                cache, cfg, mesh)
            rows.append(lg[0])
    gaps = []
    for i, (row, t) in enumerate(zip(rows, toks)):
        p_ = int(row.argmax())
        if p_ != t:
            gaps.append((i, float(row[p_] - row[t])))
    return len(toks) - len(gaps), len(toks), gaps


def dist_generate_phase(device, hand):
    """models.dist_decode (DistCache: dist_prefill, dist_decode_step,
    dist_generate) at the handoff's shape: a HANDOFF_PROMPT-token prompt
    over sp=HANDOFF_SP (zigzag) of the serving model, bf16, through
    kernel 8 ("fused_ring") and the scan ring over kernel 1 ("auto"),
    HANDOFF_STEPS greedy tokens.  Launches are exact (kernel 8 once a
    layer, or kernel 1 once a ring round of every position and layer; no
    fallback); the fused stream meets the handoff's teacher-forced bar
    against the scan route's dist_decode_step.  Prefill ms and decode ms
    a step (wall; device from the profiler) per route.  fp32 at
    HANDOFF_PROMPT_FP32 tokens: both routes token-exact with each other
    and with handoff_generate's stream, which handoff_phase held to the
    dense forward."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.models.dist_decode import (
        dist_decode_step, dist_generate, dist_prefill,
    )
    from burst_attn_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"sp": HANDOFF_SP}, device=device)
    n_layers = SERVE_DIMS["n_layers"]
    res = {}
    for key, dtype, prompt in (
            ("bf16", torch.bfloat16, hand["_bf16_prompt"]),
            ("fp32", torch.float32, hand["_fp32_prompt"])):
        params = model(dtype, device)[1]
        p = torch.from_numpy(prompt.astype(np.int64))[None].to(device)
        toks = {}
        for backend in ("fused_ring", "auto"):
            cfg = _handoff_cfg(dtype, backend)
            counters = _kernel_counters()
            obs0 = _obs_now()
            for f in counters:
                f.launches = 0
            with torch.no_grad():
                out = dist_generate(params, p, cfg, mesh,
                                    steps=HANDOFF_STEPS)
            torch.cuda.synchronize()
            launches = {f.__name__: f.launches for f in counters}
            stats = dict(_obs_since(obs0))
            want = ({"flash_fwd": 0, "fused_ring_fwd": n_layers,
                     "paged_decode_attention": 0} if backend == "fused_ring"
                    else {"flash_fwd": n_layers * HANDOFF_SP * HANDOFF_SP,
                          "fused_ring_fwd": 0, "paged_decode_attention": 0})
            assert launches == want, (key, backend, launches)
            assert not any(k_.startswith("burst.fused_fallback")
                           for k_ in stats), stats
            assert out.shape == (1, HANDOFF_STEPS)
            toks[backend] = [int(t) for t in out[0]]
            if key == "bf16":
                res[f"launches_{backend}"] = launches

                def prefill():
                    with torch.no_grad():
                        return dist_prefill(params, p, cfg, mesh,
                                            gen_budget=HANDOFF_STEPS)
                res[f"prefill_ms_{backend}"] = host_ms(prefill)
                res[f"prof_prefill_{backend}"] = device_breakdown(prefill, 1)
                _, cache = prefill()
                feed = torch.tensor([toks[backend][0]], device=device)
                n_new = cache.n_new

                def step():
                    with torch.no_grad():
                        dist_decode_step(params, feed, len(prompt) + n_new,
                                         cache._replace(n_new=n_new), cfg,
                                         mesh)
                res[f"decode_ms_{backend}"] = host_ms(
                    lambda: [step() for _ in range(8)]) / 8
                res[f"prof_decode_{backend}"] = device_breakdown(step, 4)
                del cache
        a, c = toks["fused_ring"], toks["auto"]
        if key == "fp32":
            # handoff_phase held handoff_generate's fp32 stream to the
            # dense forward token for token
            assert a == c, (a, c)
            assert a == hand["_fp32_tokens"], (a, hand["_fp32_tokens"])
            print(f"dist_generate fp32 ({len(prompt)}-token prompt): fused "
                  f"and scan routes token-exact with each other and with "
                  f"handoff_generate (itself exact with the dense forward)",
                  flush=True)
        else:
            forced = _dist_forced_agreement(_handoff_cfg(dtype, "auto"),
                                            params, prompt, a, mesh, device)
            check_agreement("dist_generate bf16 fused stream", forced, True,
                            against="the scan route's dist_decode_step")
            res["bf16_forced_agree"] = forced[0]
            res["bf16_routes_equal"] = sum(x == y for x, y in zip(a, c))
        torch.cuda.empty_cache()
    print(f"dist_generate ({HANDOFF_PROMPT} tokens, bf16, sp={HANDOFF_SP}):"
          f" prefill fused ring {res['prefill_ms_fused_ring']:.1f} ms, scan "
          f"ring {res['prefill_ms_auto']:.1f} ms; decode step "
          f"{res['decode_ms_fused_ring']:.2f} / {res['decode_ms_auto']:.2f} "
          f"ms; device {res['prof_decode_fused_ring'][1]:.2f} ms a step",
          flush=True)
    return res


def devstats_phase(device):
    """burst_attn(collect_stats=True) at the handoff's op shape (B1,
    N16/4, S = HANDOFF_PROMPT over sp=HANDOFF_SP, bf16, causal zigzag):
    the fused route (kernel 8's STATS instance) and the scan route (kernel
    1), each bitwise equal to its stats-off call; the fused slot_use
    replays the slot schedule; the routes' attn_pairs sums are equal (the
    causal triangle); kernel 9's direct collect_stats call bitwise equal
    to the stats-off one, its bundle counts the backward program's; the
    stats published into a fresh registry.  Returns the launches and the
    published catalog's size."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.obs import devstats
    from burst_attn_tpu_torch.obs.registry import Registry
    from burst_attn_tpu_torch.ops import flash, fused_ring, fused_ring_bwd
    from burst_attn_tpu_torch.ops.tuning import resolve_fused
    from burst_attn_tpu_torch.parallel import burst, layouts, ring
    from burst_attn_tpu_torch.parallel.mesh import shard

    w, s = HANDOFF_SP, HANDOFF_PROMPT
    n, n_kv = SERVE_DIMS["n_heads"], SERVE_DIMS["n_kv_heads"]
    g = torch.Generator(device=device).manual_seed(37)
    q, k, v = (layouts.to_layout(
        torch.randn(1, h, s, 128, generator=g, device=device)
        .to(torch.bfloat16), "zigzag", w, 2) for h in (n, n_kv, n_kv))
    kw = dict(mesh={"sp": w}, causal=True, layout="zigzag")
    res, stats = {}, {}
    for backend in ("fused_ring", "auto"):
        with torch.no_grad():
            plain = burst.burst_attn(q, k, v, backend=backend, **kw)
            f0, k0 = flash.flash_fwd.launches, \
                fused_ring.fused_ring_fwd.launches
            o, st = burst.burst_attn(q, k, v, backend=backend,
                                     collect_stats=True, **kw)
        torch.cuda.synchronize()
        res[f"launches_{backend}"] = (flash.flash_fwd.launches - f0,
                                      fused_ring.fused_ring_fwd.launches - k0)
        assert torch.equal(o, plain), f"{backend}: stats changed o"
        assert res[f"launches_{backend}"] == (
            (0, 1) if backend == "fused_ring" else (w * w, 0))
        stats[backend] = st
        del o, plain
    fused, scan = stats["fused_ring"], stats["auto"]
    slots = min(resolve_fused(None, None, None).kv_slots, w)
    want = np.bincount(ring.fused_slot_schedule(w, slots),
                       minlength=devstats.MAX_SLOTS)
    got = fused.slot_use.cpu().numpy()
    assert (got == want[None]).all(), (got, want)
    assert (fused.fused_rounds.cpu() == w).all()
    pairs = (float(fused.attn_pairs.sum()), float(scan.attn_pairs.sum()))
    assert pairs[0] == pairs[1] == s * (s + 1) // 2, pairs
    assert not fused.nonfinite_acc.any() and not scan.nonfinite_lse.any()
    # kernel 9's direct call, on the forward's residuals
    cfg = burst.BurstConfig(causal=True, layout="zigzag",
                            backend="fused_ring")
    qs, ks, vs = (shard(t, w) for t in (q, k, v))
    o, lse = fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, w)
    do = torch.randn(o.shape, generator=g, device=device).to(o.dtype)
    b0 = fused_ring_bwd.fused_ring_bwd.launches
    plain = fused_ring_bwd.fused_ring_bwd(qs, ks, vs, o, lse, do, cfg, 1, w)
    *grads, slot_use = fused_ring_bwd.fused_ring_bwd(
        qs, ks, vs, o, lse, do, cfg, 1, w, collect_stats=True)
    torch.cuda.synchronize()
    assert fused_ring_bwd.fused_ring_bwd.launches - b0 == 2
    assert all(torch.equal(a, b) for a, b in zip(plain, grads)), \
        "kernel 9's stats instance changed dq/dk/dv"
    prog = fused_ring.ring_plan(cfg, 1, w, s // w, "bwd")[0]
    want_bwd = np.zeros((2, devstats.MAX_SLOTS), np.int64)
    for r in range(prog.n_rounds):
        want_bwd[prog.rows["consume_bank"][r],
                 prog.rows["consume_slot"][r]] += 1
    assert (slot_use.cpu().numpy() == want_bwd[None]).all(), slot_use
    del plain, grads, o, lse, do, qs, ks, vs, q, k, v
    reg = Registry()
    for backend, st in stats.items():
        st.publish(reg, labels={"route": backend})
    res["published"] = len(reg.snapshot())
    res["slot_use_fwd"] = got[0].tolist()
    res["slot_use_bwd"] = slot_use[0, 0].tolist()
    res["attn_pairs"] = pairs[0]
    res["flop_imbalance"] = reg.gauge("devstats.flop_imbalance").get(
        route="auto")
    print(f"devstats at the handoff's op shape (bf16 W={w} zigzag causal "
          f"N{n}/{n_kv} S={s}): both routes bitwise equal to stats off; "
          f"fused slot_use per position {res['slot_use_fwd']} (the "
          f"schedule's bincount), kernel 9 bundle slot_use "
          f"{res['slot_use_bwd']}; attn_pairs {pairs[0]:.0f} on both "
          f"routes; flop imbalance {res['flop_imbalance']:.4f}; "
          f"{res['published']} registry children published", flush=True)
    torch.cuda.empty_cache()
    return res


def _obs_cli(path, *flags):
    """python -m burst_attn_tpu_torch.obs on `path`: (exit code, stdout)."""
    out = subprocess.run(
        [sys.executable, "-m", "burst_attn_tpu_torch.obs", *flags,
         "--file", path], capture_output=True, text=True, timeout=300)
    return out.returncode, out.stdout


def obs_phase(device, pticks):
    """The obs package on the serving engines at the serving width
    (bf16, OBS_REQUESTS of the seeded requests): the RaggedServeEngine
    synchronous and pipelined at K=K_PIPE, and the ServeEngine with
    request tracing on.  Each engine's counters equal the admission and
    tick arithmetic (every request submitted, admitted and retired once;
    the tokens its budgets add; the K-tick engine's tokens, ticks and
    retirements equal the synchronous engine's); every traced request's
    TTFT breakdown sums to its TTFT; the exported JSONL renders through
    the port's CLI (--json, --prom, --trace).  The per-tick cost of the
    instruments (the host calls a tick makes) is timed, beside the decode
    ticks pipelined_ticks timed with them in."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch import obs
    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.obs import trace as tracing
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    cfg, params = model(torch.bfloat16, device)
    prompts, budgets = requests(cfg, n_requests=OBS_REQUESTS)
    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, device=device)
    names = ("serve.requests_submitted", "serve.requests_admitted",
             "serve.requests_retired{cause=budget}", "serve.tokens_generated",
             "serve.engine_steps")
    res, seen = {}, {}
    path = os.path.join(_ckpt_dir(), "obs_smoke.jsonl")
    if os.path.exists(path):
        os.remove(path)
    tracing.reset_traces()
    tracing.enable()
    try:
        for name, cls, extra in (
                ("ragged_sync", RaggedServeEngine, dict(chunk=CHUNK)),
                ("ragged_k4", RaggedServeEngine,
                 dict(chunk=CHUNK, pipeline=True, multi_step=K_PIPE)),
                ("serve", ServeEngine, {})):
            eng = cls(params, cfg, **kw, **extra)
            ttft0 = obs.histogram("serve.ttft_s").get()["count"]
            before = obs.counter_values()
            toks, _, run_s = drive(eng, prompts, budgets, ())
            moved = obs.counter_deltas(before)
            seen[name] = toks
            counts = [moved[k_] for k_ in names]
            assert counts[:4] == [OBS_REQUESTS] * 3 + [sum(budgets)], \
                (name, counts)
            ticks = sum(v for k_, v in moved.items()
                        if k_.startswith("serve.ragged_batch_launches"))
            if name == "ragged_sync":
                # one launch a tick: the steps are the run's ticks
                assert counts[4] == ticks, (counts, ticks)
            res[name] = dict(zip(("submitted", "admitted", "retired",
                                  "tokens", "steps"), counts))
            res[name]["launch_ticks"] = ticks
            assert obs.histogram("serve.ttft_s").get()["count"] - ttft0 \
                == OBS_REQUESTS
            res.setdefault("run_s", {})[name] = run_s
        assert seen["ragged_k4"] == seen["ragged_sync"]
        for k_ in ("tokens", "steps", "retired"):
            assert res["ragged_k4"][k_] == res["ragged_sync"][k_], (k_, res)
        recs = tracing.trace_records()
        obs.export_jsonl(path)
    finally:
        tracing.reset_traces()
    by = {}
    for rec in recs:
        by.setdefault(rec["trace_id"], []).append(rec)
    assert len(by) == 3 * OBS_REQUESTS, len(by)
    worst = 0.0
    for spans in by.values():
        bd = tracing.ttft_breakdown(spans)
        worst = max(worst, abs(sum(bd["phases"].values()) - bd["ttft_s"])
                    / bd["ttft_s"])
    assert worst <= 1e-9, worst
    res["breakdown_worst_rel"] = worst
    for flags, probe in ((("--json",), '"metrics"'),
                         (("--prom",), "# TYPE burst_serve_tokens_generated"),
                         (("--trace",), "[complete]")):
        rc, out = _obs_cli(path, *flags)
        assert rc == 0 and probe in out, (flags, rc, out[:400])
    report = json.loads(_obs_cli(path, "--json")[1])
    res["exported_metrics"] = len(report["metrics"])
    # the instruments' host cost a tick: what _note_tick and _account do
    eng = RaggedServeEngine(params, cfg, chunk=CHUNK, **kw)
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        eng._account(1, SLOTS)
        eng._note_tick(0.002, SLOTS, 0.001)
    res["instrument_us_per_tick"] = (time.perf_counter() - t0) * 1e6 / n
    res["decode_tick_ms"] = dict(pticks["tick_ms"])
    print(f"obs: engines' counters equal the admission and tick arithmetic "
          f"({OBS_REQUESTS} requests, {sum(budgets)} tokens; synchronous "
          f"{res['ragged_sync']['steps']:.0f} steps = K={K_PIPE} "
          f"{res['ragged_k4']['steps']:.0f}); {len(by)} traced requests, "
          f"TTFT breakdown worst relative gap {worst:.2e}; export renders "
          f"through the CLI ({res['exported_metrics']} metric children); "
          f"instruments {res['instrument_us_per_tick']:.1f} us a tick; "
          f"decode tick with them in: synchronous "
          f"{res['decode_tick_ms']['sync']:.3f} ms, K={K_PIPE} "
          f"{res['decode_tick_ms']['k4']:.3f} ms", flush=True)
    return res


# ---------------------------------------------------------------------------
# the ring backward: kernel 9 (the fused ring backward), burst_attn's
# gradients and training on the ring

# kernel 9 against its plain version: (positions, layout, causal, heads,
# kv heads, local S, dtype, knobs), as FUSED_CASES
FUSED_BWD_CASES = (
    # one kv tile per CTA: dk, dv stay in registers across the rounds
    (2, "zigzag", True, 2, 1, 256, "fp32", {}),
    (3, "striped", True, 4, 1, 256, "bf16", dict(fused_bwd_slots=3)),
    (3, "contig", True, 4, 2, 512, "fp32", dict(fused_topology="bidi")),
    (4, "zigzag", True, 8, 2, 2048, "bf16", dict(optimize_bwd_comm=False)),
    (4, "striped", True, 4, 4, 256, "fp32",
     dict(fused_bwd_slots=3, optimize_bwd_comm=False)),
    (4, "contig", True, 4, 1, 512, "bf16", {}),
    # a truncated contig program: 3 live rounds of 4
    (4, "contig", True, 4, 2, 256, "fp32", dict(max_segment_len=300)),
    (4, "zigzag", False, 4, 2, 256, "fp32", dict(fused_topology="bidi")),
    (5, "zigzag", True, 4, 2, 256, "bf16",
     dict(fused_topology="bidi", fused_bwd_slots=3, fused_bwd_ccw_slots=3)),
    (4, "zigzag", True, 4, 2, 256, "fp32", dict(two_axis=(2, 2))),
    (4, "striped", True, 8, 2, 512, "bf16",
     dict(two_axis=(2, 2), fused_bwd_slots=3, optimize_bwd_comm=False)),
    (8, "zigzag", True, 4, 2, 256, "bf16", dict(fused_seq_factor=(2, 4))),
    (8, "contig", True, 4, 1, 512, "fp32", dict(two_axis=(2, 4))),
    # more kv tiles than resident CTAs: dk, dv go through the outputs
    (8, "zigzag", True, 16, 4, 1024, "bf16", {}),
    (8, "striped", False, 8, 2, 512, "fp32",
     dict(fused_topology="bidi", fused_bwd_slots=3)),
)
# the ring training cell: train_smoke's model at B1 S8192 over sp=4
RING_TRAIN_SP = 4
# bf16 gradients of two routes: each rounds its fp32 gradient to bf16 once
# (two ulps apart at most, 2 * 2^-7 relative), with an absolute floor for
# entries near zero relative to the largest one
GRAD_BF16_RTOL, GRAD_BF16_FLOOR = 1.6e-2, 1e-3


def _fused_bwd_setup(device, case, seed):
    """(cfg, ring, (q, k, v, o, lse, do) stacked, bwd program, tables) of
    one kernel-9 case: o and lse from kernel 8."""
    import torch

    from burst_attn_tpu_torch.ops import fused_ring

    w, layout, causal, n, n_kv, s, key, knobs = case
    cfg, ring, (q, k, v), _, _ = _fused_setup(device, w, layout, causal, n,
                                              n_kv, s, key, knobs, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1000)
    do = torch.randn(q.shape, generator=g, device=device).to(q.dtype)
    reason = fused_ring.supported(cfg, q.shape[1:], k.shape[1:],
                                  world=ring[1], n_inter=ring[0],
                                  pass_="bwd", dtype=q.dtype, device=device)
    assert reason is None, reason
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring)
    prog, tables, _ = fused_ring.ring_plan(cfg, *ring, s, "bwd")
    return cfg, ring, (q, k, v, o, lse, do), prog, tables


def _resident(w, b, n_kv, s):
    """Whether kernel 9 keeps dk, dv in registers: no more (b, kv head, kv
    tile) items than CTAs per position (one CTA per SM)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return b * n_kv * -(-s // 64) <= sms // w


def check_fused_ring_bwd(device):
    """Kernel 9 against fused_ring_bwd_reference over FUSED_BWD_CASES (two
    launches torch.equal; dq, dk, dv within BWD_RTOL of their largest
    entry + BWD_ATOL), then REPEATS_W8 launches at W=8 on two slots (each
    bundle and dq slot rewritten several times a launch), all bitwise
    equal.  Returns the largest error."""
    import torch

    from burst_attn_tpu_torch.ops import fused_ring_bwd

    worst = 0.0
    for i, case in enumerate(FUSED_BWD_CASES):
        cfg, ring, args, prog, tables = _fused_bwd_setup(device, case,
                                                         seed=40 + i)
        got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
        again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), "repeat"
        del again
        want = fused_ring_bwd.fused_ring_bwd_reference(
            *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm)
        w, layout, causal, n, n_kv, s, key, knobs = case
        what = (f"fused_ring_bwd {key} W={w} {prog.topology} {layout} "
                f"causal={causal} N{n}/{n_kv} S_local={s} slots="
                f"{list(prog.slots)} dq slots {list(prog.dq_slots)} "
                f"rounds {prog.n_rounds} optimize_bwd_comm="
                f"{cfg.optimize_bwd_comm} resident="
                f"{_resident(w, 1, n_kv, s)}")
        errs = _bwd_errs(got, want, what)
        worst = max([worst] + errs)
        print(f"{what}: max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
              f"{errs[2]:.3e}, two launches equal", flush=True)
        del got, want, args
    cfg, ring, args, _, _ = _fused_bwd_setup(
        device, (8, "zigzag", True, 8, 2, 512, "bf16", {}), seed=99)
    first = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
    for _ in range(REPEATS_W8 - 1):
        again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    print(f"fused_ring_bwd W=8 slots=2: {REPEATS_W8} launches bitwise equal",
          flush=True)
    return worst


def _check_grads_bf16(what, got, want):
    """bf16 gradients of two routes within GRAD_BF16_RTOL, with an absolute
    floor of GRAD_BF16_FLOOR times the largest entry; returns the largest
    max-abs error."""
    import torch

    errs = []
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        floor = GRAD_BF16_FLOOR * float(b.float().abs().max())
        torch.testing.assert_close(a, b, rtol=GRAD_BF16_RTOL, atol=floor,
                                   msg=lambda m: f"{what} {name}: {m}")
        errs.append(_max_err(a, b))
    return max(errs)


def _bwd_bound(tables, prog, b, n, n_kv, s, d, esz, opt=True, pairs=None,
               extra_bytes=0, wire=None):
    """(bound ms, bound_by, attended pairs) of one kernel-9 launch: the
    pairs the table's swapped-role specs attend (10 * D flops each: S, dP,
    dV, dK and dQ), or `pairs` (those a packed mask leaves); the bytes of
    q, do, k, v and the bundle's delta and lse read once, of dq, dk, dv
    (fp32) written once, of every copy the program makes: each bundle
    copy-in and send, each dq hop (read and written), and `extra_bytes`
    (the segment ids).  With a `wire` dtype a bundle copy and a dq hop
    move schedule.wire_round_bytes' quantized bytes."""
    from burst_attn_tpu_torch.ops import masks
    from burst_attn_tpu_torch.parallel import schedule as sched_ir

    w = len(tables)
    if pairs is None:
        pairs = sum(masks.spec_pair_count(
            masks.MaskSpec(*map(int, t[r, :5])), s, s)
            for t in tables for r in range(prog.n_rounds)) * b * n
    q_bytes = b * n * s * d * esz
    kv_bytes = 2 * b * n_kv * s * d * esz
    stats = 4 * b * n * s
    bundle = 2 * q_bytes + (stats if opt else q_bytes) + stats
    copies = w * (sum(prog.rows["send0"]) + sum(prog.rows["send1"])
                  + len(prog.copy_in))
    dq_slot = 4 * b * n * s * d
    dq_hop = dq_slot
    if wire is not None:
        wr = sched_ir.wire_round_bytes("bwd", wire, b=b, n=n, n_kv=n_kv,
                                       s=s, d=d, opt_comm=opt)
        bundle, dq_hop = wr["bundle"], wr["dq"]
    dq_hops = w * sum(1 for r in range(prog.n_rounds)
                      if prog.rows["dq_send"][r] != sched_ir.DQ_NONE)
    n_bytes = (w * (2 * q_bytes + kv_bytes + 2 * stats)
               + w * (dq_slot + 4 * 2 * b * n_kv * s * d)
               + 2 * copies * bundle + 2 * dq_hops * dq_hop + extra_bytes)
    bms, by = bound_ms(n_bytes, 10 * d * pairs)
    return bms, by, pairs


def ring_bwd_op_phase(device):
    """burst_attn forward + backward at bench.py's headline shape (B1 N32
    S65536 D128 bf16, causal zigzag, mesh {"sp": 8}): the fused route
    (kernels 8 and 9, one launch each) against the scan route (kernel 1
    and the fused flash backward per round: 64 launches each), no
    fallback, gradients within the bf16 tolerance; kernel 9 called alone
    gives the fused route's gradients bit for bit and is held against its
    plain version run by head chunks (8 of 32 heads at a time: all 32
    would hold ~4 x 8.6 GB of fp32 scores per round); the times of kernel
    9, of both routes' forward + backward, of the plain version, and of
    SDPA's backward and forward + backward on the natural-order sequence
    (the yardstick).  Returns kernel 9's record for the kernels line."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash, fused_ring, fused_ring_bwd
    from burst_attn_tpu_torch.parallel import burst, layouts, mesh

    b, n, s, w, d = RING_B, RING_N, RING_S, RING_W, 128
    bf16 = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(17)
    nat = [torch.randn(b, n, s, d, generator=g, device=device).to(bf16)
           for _ in range(4)]
    q, k, v, do = (layouts.to_layout(t, "zigzag", w, 2) for t in nat)
    kw = dict(mesh={"sp": w}, causal=True, layout="zigzag")

    def grads(backend):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = burst.burst_attn(*leaves, backend=backend, **kw)
        return torch.autograd.grad(o, leaves, do)

    obs0 = _obs_now()
    _reset_counts()
    fused = grads("fused_ring")
    torch.cuda.synchronize()
    fused_launches = _counts()
    _reset_counts()
    scan = grads("auto")
    torch.cuda.synchronize()
    scan_launches = _counts()
    assert fused_launches == _launches(fused_ring_fwd=1, fused_ring_bwd=1), \
        fused_launches
    # zigzag skips no round: every position runs all W rounds, both passes
    assert scan_launches == _launches(flash_fwd=w * w, fused=w * w), \
        scan_launches
    assert not any(key.startswith("burst.fused_fallback")
                   for key in _obs_since(obs0)), dict(_obs_since(obs0))
    assert all(torch.isfinite(x).all() for x in fused)
    scan_err = _check_grads_bf16("burst_attn gradients fused vs scan",
                                 fused, scan)
    del scan

    cfg = burst.BurstConfig(backend="fused_ring", causal=True,
                            layout="zigzag")
    qs, ks, vs, dos = (mesh.shard(t, w) for t in (q, k, v, do))
    o, lse = fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, w)
    kg = fused_ring_bwd.fused_ring_bwd(qs, ks, vs, o, lse, dos, cfg, 1, w)
    for a, x in zip(kg, fused):
        assert torch.equal(mesh.unshard(a).to(bf16), x), \
            "kernel 9 alone differs from burst_attn's fused gradients"
    del fused
    prog, tables, _ = fused_ring.ring_plan(cfg, 1, w, s // w, "bwd")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = fused_ring_bwd.fused_ring_bwd_reference(
        qs, ks, vs, o, lse, dos, prog, tables, d ** -0.5, head_chunk=8)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = _bwd_errs(kg, want, "fused_ring_bwd at the headline shape")
    del want, kg
    torch.cuda.empty_cache()

    ms = time_ms(lambda: fused_ring_bwd.fused_ring_bwd(
        qs, ks, vs, o, lse, dos, cfg, 1, w), iters=2, warmup=0)
    fused_op_ms = time_ms(lambda: grads("fused_ring"), iters=1, warmup=0)
    scan_op_ms = time_ms(lambda: grads("auto"), iters=1, warmup=0)
    del o, lse
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in nat[:3])
    lib_fb_ms = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True),
        (qr, kr, vr), nat[3]), iters=3, warmup=1)
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        out, (qr, kr, vr), nat[3], retain_graph=True), iters=3, warmup=1)
    del out, qr, kr, vr
    bms, by, pairs = _bwd_bound(tables, prog, b, n, n, s // w, d, 2)
    print(f"burst_attn forward + backward at B{b} N{n} S{s} D{d} bf16 causal "
          f"zigzag, mesh {{'sp': {w}}}: fused ring {fused_op_ms:.2f} ms "
          f"(kernel 9 {ms:.2f} ms, 1 launch), scan ring {scan_op_ms:.2f} ms "
          f"({scan_launches['flash_fwd']} flash_fwd + "
          f"{scan_launches['fused']} flash_bwd launches), fused vs scan "
          f"gradients max_abs_err {scan_err:.3e}; plain version by head "
          f"chunks {plain_ms:.0f} ms (kernel 9 vs plain dq {errs[0]:.3e} dk "
          f"{errs[1]:.3e} dv {errs[2]:.3e}); SDPA on the natural-order "
          f"sequence: backward {lib_ms:.2f} ms, forward + backward "
          f"{lib_fb_ms:.2f} ms; kernel 9 bound {bms:.3f} ms ({by}); "
          f"{pairs / 1e9:.3f} G causal pairs", flush=True)
    return dict(name="fused_ring_bwd", route="cuda",
                source="burst_attn_tpu_torch/csrc/fused_ring_bwd.cu",
                replaces="burst_attn_tpu/ops/fused_ring_bwd.py:168",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                op_ms=fused_op_ms, scan_op_ms=scan_op_ms,
                library_fwd_bwd_ms=lib_fb_ms,
                fused_vs_scan_grad_err=scan_err)


def check_ring_kernels_at(device, what, w, n, n_kv, s, seed, fwd=True,
                          head_chunk=None, timing=False):
    """Kernel 9 (and, with `fwd`, kernel 8) at one op shape of the main
    path: W = w positions, B1, N{n}/Nk{n_kv}, S_local = s, bf16, causal
    zigzag, default knobs, on seeded tensors (o and lse from kernel 8).
    Each kernel launched twice, torch.equal; kernel 8's o within O_TOL and
    lse within STATS_ATOL of fused_ring_reference; kernel 9's dq, dk, dv
    within BWD_RTOL/BWD_ATOL of fused_ring_bwd_reference (by head chunks
    of `head_chunk` heads).  With `timing`: each kernel's ms a launch
    (CUDA events), and one traced kernel-9 launch (bitwise the untraced
    one) whose CTA records give the share of their span spent waiting on
    dq fold counters and on the ring's counters.  Returns the largest
    errors (kernel 8's o or 0.0 without `fwd`, kernel 9's) and the timing
    dict (empty without `timing`)."""
    import torch

    from burst_attn_tpu_torch.ops import fused_ring, fused_ring_bwd

    cfg, ring, args, prog, tables = _fused_bwd_setup(
        device, (w, "zigzag", True, n, n_kv, s, "bf16", {}), seed=seed)
    what = f"{what}: bf16 W={w} zigzag causal N{n}/{n_kv} S_local={s}"
    k8_err = 0.0
    if fwd:
        q, k, v, o, lse, _ = args
        o2, lse2 = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(lse, lse2), "repeat"
        del o2, lse2
        fprog, ftables, _ = fused_ring.ring_plan(cfg, *ring, s, "fwd")
        po, plse = fused_ring.fused_ring_reference(q, k, v, fprog, ftables,
                                                   128 ** -0.5)
        k8_err = _check_o(f"fused_ring_fwd at {what}", o, po,
                          torch.bfloat16)
        lse_err = _max_err(lse, plse)
        assert lse_err <= STATS_ATOL["bf16"], (what, lse_err)
        del po, plse
        print(f"fused_ring_fwd at {what}: max_abs_err={k8_err:.3e} lse "
              f"{lse_err:.3e}, two launches equal", flush=True)
    got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
    again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "repeat"
    del again
    timed = {}
    if timing:
        q, k, v = args[:3]
        # the STATS instances beside the stats-off ones, in turns off on
        # on off, their outputs bitwise the stats-off ones': kernel 8 at
        # its launch (the wrapper with collect_stats also assembles the
        # DevStats, timed on its own below), kernel 9 through its wrapper
        calls = {("k9", False): lambda: fused_ring_bwd.fused_ring_bwd(
                     *args, cfg, *ring),
                 ("k9", True): lambda: fused_ring_bwd.fused_ring_bwd(
                     *args, cfg, *ring, collect_stats=True)}
        if fwd:
            fprog = fused_ring.ring_plan(cfg, *ring, s, "fwd")[0]
            sched = fused_ring._sched_on(cfg, *ring, s, q.device, "fwd")
            slots = fused_ring._slot_counters(fprog, w, q.device)
            calls[("k8", False)] = lambda: fused_ring._fused_ring_fwd_cuda(
                q, k, v, fprog, sched, 128 ** -0.5)
            calls[("k8", True)] = lambda: fused_ring._fused_ring_fwd_cuda(
                q, k, v, fprog, sched, 128 ** -0.5, slot_use=slots)
            o_on = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring,
                                             collect_stats=True)
            assert torch.equal(o_on[0], o) and torch.equal(o_on[1], lse), \
                "kernel 8's stats instance changed o / lse"
            del o_on
            timed["k8_ms"] = time_ms(
                lambda: fused_ring.fused_ring_fwd(q, k, v, cfg, *ring),
                iters=10, warmup=2)
            timed["k8_stats_call_ms"] = time_ms(
                lambda: fused_ring.fused_ring_fwd(q, k, v, cfg, *ring,
                                                  collect_stats=True),
                iters=10, warmup=2)
        g_on = calls[("k9", True)]()
        assert all(torch.equal(a, b) for a, b in zip(g_on, got)), \
            "kernel 9's stats instance changed dq / dk / dv"
        del g_on
        turns = {key: [] for key in calls}
        for on in (False, True, True, False):
            for kern in ("k8", "k9"):
                if (kern, on) in calls:
                    turns[(kern, on)].append(time_ms(calls[(kern, on)],
                                                     iters=10, warmup=2))
        for (kern, on), ts in turns.items():
            key = ("k8_launch" if kern == "k8" else kern) + (
                "_stats" if on else "")
            timed[f"{key}_ms"] = sum(ts) / len(ts)
            timed[f"{key}_ms_turns"] = ts
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        trace = torch.zeros((sms, len(fused_ring_bwd.TRACE_COLS)),
                            dtype=torch.int64, device=device)
        traced = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring,
                                               trace=trace)
        assert all(torch.equal(a, b) for a, b in zip(traced, got)), \
            "traced kernel 9 differs"
        del traced
        recs = fused_ring_bwd.read_trace(trace)
        span = [r["t1_ns"] - r["t0_ns"] for r in recs]
        timed["k9_fold_wait_share"] = sum(
            r["fold_wait_ns"] for r in recs) / sum(span)
        timed["k9_phase_wait_share"] = sum(
            r["phase_wait_ns"] for r in recs) / sum(span)
        timed["k9_ctas"] = len(recs)
        print(f"kernels 8 and 9 at {what}: kernel 8 "
              f"{timed.get('k8_ms', float('nan')):.3f} ms (at its launch "
              f"{timed.get('k8_launch_ms', float('nan')):.3f}, stats "
              f"instance {timed.get('k8_launch_stats_ms', float('nan')):.3f};"
              f" collect_stats call with the DevStats "
              f"{timed.get('k8_stats_call_ms', float('nan')):.3f}), kernel 9 "
              f"{timed['k9_ms']:.3f} ms (stats instance "
              f"{timed['k9_stats_ms']:.3f}) a launch (turns off on on off, "
              f"mean of 10 each); a traced "
              f"kernel-9 launch: {len(recs)} CTAs spend "
              f"{timed['k9_fold_wait_share']:.4f} of their time waiting on "
              f"dq fold counters and {timed['k9_phase_wait_share']:.4f} on "
              f"the ring's counters", flush=True)
    t0 = time.perf_counter()
    want = fused_ring_bwd.fused_ring_bwd_reference(
        *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm,
        head_chunk=head_chunk)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    errs = _bwd_errs(got, want, f"fused_ring_bwd at {what}")
    del got, want, args
    torch.cuda.empty_cache()
    print(f"fused_ring_bwd at {what} (optimize_bwd_comm="
          f"{cfg.optimize_bwd_comm}, resident={_resident(w, 1, n_kv, s)}): "
          f"max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}, "
          f"two launches equal; plain version {plain_ms:.0f} ms", flush=True)
    return k8_err, max(errs), timed


def ring_train_phase(device, single):
    """make_train_step on the ring: train_smoke's model (bf16, remat, the
    seed-0 weights of phase 6) at B=1, S=TRAIN_SEQ over mesh {"sp":
    RING_TRAIN_SP} (zigzag: S_local 2048) on phase 6's batch, for the
    fused route (attn_backend="fused_ring": kernel 8 twice and kernel 9
    once per layer and step) and the scan route ("auto": kernel 1 and the
    fused flash backward per round), each a warm-up and TRAIN_STEPS timed
    steps: exact launch counts per step, no fallback, losses finite and
    falling, the first two within CONTROL_RTOL of phase 6's single-device
    run (`single`: train_phase's result); step ms, tokens/s, MFU and a
    profiled step per route."""
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.parallel import burst

    w = RING_TRAIN_SP
    mesh = {"sp": w}
    n_layers = TRAIN_DIMS["n_layers"]
    tcfg = train.TrainConfig()
    out = {}
    for backend in ("fused_ring", "auto"):
        cfg = _train_model(n_layers, torch.bfloat16, attn_backend=backend)
        state = [_seed_state(cfg, tcfg, device)]
        batch = train.make_batch(1, cfg, mesh, batch=1, seq=TRAIN_SEQ,
                                 device=device)
        step = train.make_train_step(cfg, tcfg, mesh, device=device)
        obs0 = _obs_now()
        losses, times = [], []
        for i in range(1 + TRAIN_STEPS):
            if i == 1:
                _reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, m = step(state[0], batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        launches = _counts()
        per_step = ({"fused_ring_fwd": 2 * n_layers,
                     "fused_ring_bwd": n_layers} if backend == "fused_ring"
                    else {"flash_fwd": 2 * n_layers * w * w,
                          "fused": n_layers * w * w})
        want = _launches(**{k: v * TRAIN_STEPS for k, v in per_step.items()})
        assert launches == want, (backend, launches, want)
        assert not any(key.startswith("burst.fused_fallback")
                       for key in _obs_since(obs0)), dict(_obs_since(obs0))
        assert all(map(math.isfinite, losses)), losses
        assert losses[-1] < losses[0], f"loss did not fall: {losses}"
        diffs = [abs(a - b_) / abs(b_)
                 for a, b_ in zip(losses, single["losses"])]
        assert max(diffs[:2]) <= CONTROL_RTOL, (backend, losses,
                                                single["losses"])
        step_ms = statistics.median(times[1:])
        n_params = single["n_params"]
        attn_flops = (n_layers * 3.5 * 4 * TRAIN_SEQ * TRAIN_SEQ
                      * TRAIN_DIMS["n_heads"] * TRAIN_DIMS["d_head"] / 2)
        flops = 6.0 * n_params * TRAIN_SEQ + attn_flops
        prof = device_breakdown(lambda: step(state[0], batch), 1, top=8)
        out[backend] = dict(
            step_ms=step_ms, step_ms_all=times[1:], losses=losses,
            tokens_per_s=TRAIN_SEQ / (step_ms / 1e3),
            mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
            launches=launches,
            launches_per_step={k: v // TRAIN_STEPS
                               for k, v in launches.items() if v},
            rel_diff_vs_single=diffs[:2], prof=prof)
        print(f"ring train step ({backend}, mesh {mesh}, zigzag, bf16, B=1 "
              f"S={TRAIN_SEQ}): {step_ms:.1f} ms (median of {TRAIN_STEPS}: "
              f"{[round(t_, 1) for t_ in times[1:]]}), "
              f"{out[backend]['tokens_per_s']:.0f} tokens/s, MFU "
              f"{out[backend]['mfu']:.4f}; losses "
              f"{[round(x, 4) for x in losses]} (single device "
              f"{[round(x, 4) for x in single['losses']]}, rel diffs "
              f"{[float(f'{x:.2e}') for x in diffs]}); launches per step "
              f"{out[backend]['launches_per_step']}", flush=True)
        print_profile(f"ring train step, {backend}", prof)
        state[0] = None
        torch.cuda.empty_cache()
    return out


def ring_train_parity(device, n_layers=2, seq=2048, routes=None,
                      sp=RING_TRAIN_SP):
    """One step's loss and gradients at full width, fp32, on the ring
    (mesh {"sp": sp}, zigzag) through the fused route and the scan route
    (or the `routes` {name: model options}, e.g. Ulysses), each against
    the single-device kernels on the same weights and batch: loss within
    LOSS_RTOL, every gradient within GRAD_RTOL of its largest entry."""
    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import (
        LAYER_KEYS, init_params, param_leaves,
    )

    routes = routes or {b: dict(attn_backend=b)
                        for b in ("fused_ring", "auto")}
    mesh = {"sp": sp}
    base = _train_model(n_layers, torch.float32)
    params = init_params(base, seed=0, device=device)
    leaves = list(param_leaves(params))
    for t in leaves:
        t.requires_grad_(True)

    def loss_grads(cfg, m):
        batch = train.make_batch(2, cfg, m, batch=1, seq=seq, device=device)
        loss = train.loss_fn(params, batch["tokens"], batch["positions"],
                             batch["labels"], cfg, m)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    loss_1, grads_1 = loss_grads(base, None)
    names = ["embed"] + [f"layers.{i}.{k}" for i in range(n_layers)
                         for k in LAYER_KEYS] + ["final_norm", "lm_head"]
    res = {}
    for backend, opts in routes.items():
        cfg = _train_model(n_layers, torch.float32, **opts)
        _reset_counts()
        loss_r, grads_r = loss_grads(cfg, mesh)
        launches = _counts()
        loss_err = abs(loss_r - loss_1) / abs(loss_1)
        assert loss_err <= LOSS_RTOL, (backend, loss_r, loss_1)
        worst = (0.0, "")
        for name, a, b_ in zip(names, grads_r, grads_1):
            ref = float(b_.abs().max())
            err = _max_err(a, b_)
            assert err <= GRAD_RTOL * ref + 1e-12, \
                f"{backend} gradient {name}: max-abs err {err:.3e} of max " \
                f"{ref:.3e}"
            worst = max(worst, (err / max(ref, 1e-30), name))
        kind = ("ulysses" if opts.get("attn_strategy") == "ulysses"
                else "ring")
        print(f"{kind} train parity fp32 ({backend}, mesh {mesh}, {n_layers} "
              f"layers at full width, S={seq}): loss {loss_r:.6f} (ring) vs "
              f"{loss_1:.6f} (one device), rel err {loss_err:.2e}; worst "
              f"gradient error {worst[0]:.2e} of its largest entry "
              f"({worst[1]}); launches {launches}", flush=True)
        res[backend] = dict(loss_rel_err=loss_err, grad_rel_err=worst[0],
                            grad_worst=worst[1])
    return res


# ---------------------------------------------------------------------------
# sliding-window serving: kernels 1, 6 and 7 with a window and the windowed
# serving model; kernel 10, the step-overhead probe

# the serving model's window: half the longest prompt, so bands both inside
# a prompt and at its edge are exercised
WINDOW = 1024
FLASH_WINDOWS = (1, 100, 1024, 4096)  # 4096 >= S: no band left
DECODE_WINDOWS = (64, 1024, 3000)
RAGGED_WINDOWS = (64, 1024)
WIDE_WINDOW = 4096  # above every length of the ragged check batch
# kernel 10 against its plain version: (bkv, steps), with and without the
# product, at bq 2048 (steps past 512 wrap the pool, n_pool = 512, as the
# sweep's cells and the kernels line's do); then
# benchmarks/step_probe.py's default sweep
PROBE_BQ = 2048
PROBE_CHECKS = ((128, 8), (128, 512), (256, 8), (256, 512), (4096, 8),
                (4096, 512), (1024, 2048), (2048, 8192))
PROBE_KV_BLOCKS = (256, 1024, 2048, 4096)
PROBE_STEPS = (512, 2048, 8192)
PROBE_ROW_CELL = (1024, 2048)  # the kernels line's cell (bkv, steps)
# the product adds `steps` fp32 per-step products into each entry:
# rounding relative to the largest entry (the plain version sums in fp64)
PROBE_RTOL = 1e-5
# last-position logits, windowed vs unwindowed model (fp32): a prompt no
# longer than the window gives the same band, so the same bits; a longer
# one loses its first positions and moves the logits by far more
WINDOW_SAME_ATOL, WINDOW_DIFF_MIN = 1e-5, 1e-3


def wmodel(dtype, device):
    """The serving model (same weights) with the sliding window WINDOW."""
    import dataclasses

    cfg, params = model(dtype, device)
    return dataclasses.replace(cfg, window=WINDOW, layout="contig"), params


def _check_stats(what, got, want):
    """lse or m of a kernel against its plain version: the same -inf rows
    (a row whose band is empty), finite entries within STATS_ATOL."""
    import torch

    assert torch.equal(torch.isinf(got), torch.isinf(want)), what
    fin = torch.isfinite(want)
    e = _max_err(got[fin], want[fin])
    assert e <= STATS_ATOL["fp32"], f"{what}: err {e}"


def check_flash_window(device, b=1, n=16, n_kv=4, s=2048, d=128):
    """Kernel 1 with a window against tile_fwd/finalize at the serving
    prefill's shape (bf16): windows 1, 100, 1024 and 4096 (>= S, bitwise
    the unwindowed kernel), offset 0 with every column and offset -1 with
    a ragged kv_hi; two launches torch.equal.  Returns the kernels-line
    record (times at WINDOW, offset 0)."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash, masks, tile

    bf16 = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(31)
    q = torch.randn(b, n, s, d, generator=g, device=device).to(bf16)
    k, v = (torch.randn(b, n_kv, s, d, generator=g, device=device).to(bf16)
            for _ in range(2))
    scale = d**-0.5
    worst = 0.0
    for window in FLASH_WINDOWS:
        for offset, kv_hi in ((0, s), (-1, s - 37)):
            spec = masks.MaskSpec(0, s, kv_hi, 1, offset)

            def kernel(w=window):
                return flash.flash_fwd(q, k, v, None, None, None, scale,
                                       spec, window=w, emit_o=True)

            m, lse, o = kernel()
            assert all(torch.equal(a, c) for a, c in zip((m, lse, o),
                                                         kernel())), \
                f"flash_fwd window={window}: two launches differ"
            pm, plse, pacc = tile.tile_fwd(
                q, k, v, *tile.init_state(b, n, s, d, device=device), scale,
                spec, window=window)
            what = f"flash_fwd window={window} offset={offset} kv_hi={kv_hi}"
            err = _check_o(what, o, tile.finalize(pm, plse, pacc, bf16),
                           bf16)
            _check_stats(what + " lse", lse, plse)
            same = ""
            if window >= s:
                full = kernel(None)
                assert all(torch.equal(a, c) for a, c in zip((m, lse, o),
                                                             full)), what
                same = "; torch.equal to the unwindowed kernel"
            worst = max(worst, err)
            print(f"{what}: N{n}/{n_kv} S={s} bf16, window used {window}, "
                  f"max_abs_err={err:.3e} (tolerance {O_TOL['bf16']}); two "
                  f"launches torch.equal{same}", flush=True)
            del pm, plse, pacc

    spec = masks.MaskSpec(0, s, s, 1, 0)
    ms = time_ms(lambda: flash.flash_attention(q, k, v, None, True,
                                               window=WINDOW))

    def plain():
        st = tile.tile_fwd(q, k, v, *tile.init_state(b, n, s, d,
                                                     device=device),
                           scale, spec, window=WINDOW)
        return tile.finalize(*st, bf16)

    plain_ms = time_ms(plain, iters=3, warmup=1)
    band = masks.dense_mask(spec, s, s, device=device, window=WINDOW)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=band, enable_gqa=True))
    pairs = b * masks.spec_pair_count(spec, s, s, window=WINDOW)
    esz = q.element_size()
    n_bytes = esz * (q.numel() * 2 + k.numel() * 2) + 4 * 2 * b * n * s
    bms, by = bound_ms(n_bytes, 4 * pairs * n * d)
    print(f"flash_fwd[window={WINDOW}] B{b} N{n}/{n_kv} S={s} bf16: "
          f"{ms:.4f} ms (plain {plain_ms:.4f}, SDPA with the band mask "
          f"{lib_ms:.4f}, bound {bms:.4f} by {by})", flush=True)
    return dict(name="flash_fwd[window]", route="cuda",
                source="burst_attn_tpu_torch/csrc/flash_fwd.cu",
                replaces="burst_attn_tpu/ops/pallas_flash.py:419",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def _gather_band(kp, vp, table, lo, n_band):
    """Each slot's K/V positions lo .. lo + n_band - 1 gathered from the
    pool into [slots, Nkv, n_band, D] (positions past the table clamp):
    the library yardstick's input."""
    import torch

    slots, width = table.shape
    page = kp.shape[2]
    pos = (lo.long()[:, None] + torch.arange(n_band, device=kp.device)
           ).clamp(max=width * page - 1)                      # [S, n_band]
    pid = table.long().gather(1, pos // page)                 # [S, n_band]
    off = pos % page

    def one(pool):
        g = pool[pid, :, off]                                 # [S, n, Nkv, D]
        return g.movedim(2, 1).contiguous()

    return one(kp), one(vp), pos


def check_paged_decode_window(device, n_kv=4, group=4, d=128,
                              lengths=(0, 1, 128, 2112, 2048, 1000, 129,
                                       1536)):
    """Kernel 6 with a window on the slice-1 decode case: windows 64, 1024
    and 3000 on bf16, int8 and fp8 pools against paged_decode_reference;
    two launches torch.equal, and the ragged kernel's QT=1 rows bitwise
    equal.  Returns the kernels-line record (bf16 pool, WINDOW)."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp

    bf16 = torch.bfloat16
    slots = len(lengths)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    table = _table(0, lengths, N_PAGES, PAGE, MAX_PAGES, device)
    worst = 0.0
    for quant in (None, "int8", "fp8"):
        g = torch.Generator(device=device).manual_seed(41)
        q = torch.randn(slots, n_kv, group, d, generator=g,
                        device=device).to(bf16)
        kp, vp, ks, vs = _pool(g, device, bf16, quant, N_PAGES, n_kv, PAGE,
                               d)
        for window in DECODE_WINDOWS:
            kw = dict(k_scales=ks, v_scales=vs, window=window)
            o = pa.paged_decode_attention(q, kp, vp, table, lens, **kw)
            assert torch.equal(o, pa.paged_decode_attention(
                q, kp, vp, table, lens, **kw)), "two launches differ"
            want = pa.paged_decode_reference(q, kp, vp, table, lens, **kw)
            what = f"paged_decode bf16 pool={quant or 'bf16'} window={window}"
            err = _check_o(what, o, want, bf16)
            rag = rp.ragged_paged_attention(
                q.reshape(slots, n_kv * group, 1, d), kp, vp, table,
                (lens > 0).to(torch.int32), lens, **kw)
            assert torch.equal(rag.reshape(o.shape), o), what + " ragged"
            if window >= max(lengths):  # no band left: the unwindowed code
                assert torch.equal(o, pa.paged_decode_attention(
                    q, kp, vp, table, lens, k_scales=ks, v_scales=vs)), what
            worst = max(worst, err)
            print(f"{what}: window used {window}, lengths {list(lengths)}, "
                  f"max_abs_err={err:.3e} (tolerance {O_TOL['bf16']}); two "
                  "launches torch.equal; ragged QT=1 rows torch.equal"
                  + ("; torch.equal to the unwindowed kernel"
                     if window >= max(lengths) else ""), flush=True)

    g = torch.Generator(device=device).manual_seed(41)
    q = torch.randn(slots, n_kv, group, d, generator=g, device=device).to(bf16)
    kp, vp, _, _ = _pool(g, device, bf16, None, N_PAGES, n_kv, PAGE, d)
    kw = dict(window=WINDOW)

    def kernel():
        return pa.paged_decode_attention(q, kp, vp, table, lens, **kw)

    ms, dev_ms = time_ms(kernel), graph_ms(kernel)
    plain_ms = time_ms(lambda: pa.paged_decode_reference(
        q, kp, vp, table, lens, **kw), iters=5)
    lo = (lens - WINDOW).clamp(min=0)
    kd, vd, pos = _gather_band(kp, vp, table, lo, WINDOW)
    mask = pos < lens[:, None]
    mask[:, 0] = True  # an empty slot's row attends one column (no NaN)
    def lib():
        return F.scaled_dot_product_attention(
            q.reshape(slots, n_kv * group, 1, d), kd, vd,
            attn_mask=mask[:, None, None], enable_gqa=True)

    lib_ms, lib_dev_ms = time_ms(lib), graph_ms(lib)
    # what the function must move: the K/V of each slot's band, q of the
    # non-empty slots, every output row, the table entries of the band's
    # pages, the lengths
    band = [min(ln, WINDOW) for ln in lengths]
    pages = sum(((ln - 1) // PAGE - max(ln - WINDOW, 0) // PAGE + 1)
                for ln in lengths if ln)
    esz = q.element_size()
    n_bytes = (esz * 2 * sum(band) * n_kv * d
               + esz * n_kv * group * d * (sum(ln > 0 for ln in lengths)
                                           + slots)
               + 4 * (pages + slots))
    bms, by = bound_ms(n_bytes, 4 * sum(band) * n_kv * group * d)
    print(f"paged_decode[window={WINDOW}] bf16 {slots} slots: {ms:.4f} ms "
          f"timing eager calls ({dev_ms:.4f} on the device, CUDA graph; "
          f"plain {plain_ms:.4f}, SDPA on the gathered band {lib_ms:.4f} "
          f"({lib_dev_ms:.4f}), bound {bms:.5f} by {by})", flush=True)
    return dict(name="paged_decode[window]", route="cuda",
                source="burst_attn_tpu_torch/csrc/ragged_paged.cu",
                replaces="burst_attn_tpu/ops/paged_attention.py:56",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, graph_ms=dev_ms,
                library_graph_ms=lib_dev_ms)


def check_ragged_window(device):
    """Kernel 7 with a window on the mixed batch (q_lens 0/1/37/128):
    windows 64 and 1024, fp32, bf16 and an int8 pool, against
    ragged_paged_reference, two launches torch.equal; the grouped
    shared-prefix launch with a window (at 64 the shared page lies wholly
    below some rows' bands), no NaN.  Returns the kernels-line record
    (bf16, WINDOW)."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import ragged_paged as rp

    worst = 0.0
    for dtype, quant in ((torch.float32, None), (torch.bfloat16, None),
                         (torch.bfloat16, "int8")):
        q, kp, vp, table, ql, kl, ks, vs = _ragged_case(device, dtype, quant,
                                                        seed=43)
        key = _dtype_key(dtype)
        for window in RAGGED_WINDOWS + (WIDE_WINDOW,):
            kw = dict(k_scales=ks, v_scales=vs, window=window)
            o = rp.ragged_paged_attention(q, kp, vp, table, ql, kl, **kw)
            assert torch.equal(o, rp.ragged_paged_attention(
                q, kp, vp, table, ql, kl, **kw)), "two launches differ"
            want = rp.ragged_paged_reference(q, kp, vp, table, ql, kl, **kw)
            what = f"ragged_paged {key} pool={quant or key} window={window}"
            err = _check_o(what, o, want, dtype)
            if window == WIDE_WINDOW:  # above every length: no band left
                assert torch.equal(o, rp.ragged_paged_attention(
                    q, kp, vp, table, ql, kl, k_scales=ks, v_scales=vs)), what
            worst = max(worst, err)
            print(f"{what}: window used {window}, q_lens "
                  f"{list(RAGGED_Q_LENS)} kv_lens {list(RAGGED_KV_LENS)}, "
                  f"max_abs_err={err:.3e} (tolerance {O_TOL[key]}); two "
                  "launches torch.equal"
                  + ("; torch.equal to the unwindowed kernel"
                     if window == WIDE_WINDOW else ""), flush=True)

    # the grouped launch: slots 3 and 4 (128-token chunks at 896 and 1920)
    # share their first page
    q, kp, vp, table, ql, kl, _, _ = _ragged_case(device, torch.float32,
                                                  None, seed=44)
    table[4, 0] = table[3, 0]
    grp = dict(group_id=torch.tensor([0, 0, 0, 1, 1, 0, 0, 0],
                                     dtype=torch.int32, device=device),
               shared_table=torch.stack([torch.zeros_like(table[3, :1]),
                                         table[3, :1]]),
               shared_lens=torch.tensor([0, PAGE], dtype=torch.int32,
                                        device=device))
    for window in RAGGED_WINDOWS:
        got = rp.ragged_paged_attention_grouped(q, kp, vp, table, ql, kl,
                                                window=window, **grp)
        assert not torch.isnan(got).any(), "grouped window: NaN"
        want = rp.ragged_paged_reference(q, kp, vp, table, ql, kl,
                                         window=window)
        err = _check_o(f"ragged grouped window={window}", got, want,
                       torch.float32)
        print(f"ragged_paged grouped fp32 window={window}: one shared page "
              f"for slots 3-4, max_abs_err={err:.3e}, no NaN", flush=True)

    q, kp, vp, table, ql, kl, _, _ = _ragged_case(device, torch.bfloat16,
                                                  None, seed=43)
    kw = dict(window=WINDOW)

    def kernel():
        return rp.ragged_paged_attention(q, kp, vp, table, ql, kl, **kw)

    ms, dev_ms = time_ms(kernel), graph_ms(kernel)
    plain_ms = time_ms(lambda: rp.ragged_paged_reference(
        q, kp, vp, table, ql, kl, **kw), iters=5)
    slots, n_q, qt, d = q.shape
    n_kv = kp.shape[1]
    # SDPA over each slot's band: positions from its first token's band
    # start, WINDOW + CHUNK of them, masked per row
    lo = (kl - ql - WINDOW + 1).clamp(min=0)
    n_band = WINDOW + CHUNK
    kd, vd, pos = _gather_band(kp, vp, table, lo, n_band)
    t = torch.arange(qt, device=device)
    qp = (kl - ql).long()[:, None] + t[None, :]
    real = t[None, :] < ql[:, None]
    mask = ((pos[:, None, :] <= qp[:, :, None])
            & (pos[:, None, :] > qp[:, :, None] - WINDOW) & real[:, :, None])
    mask[:, :, 0] |= ~real  # padding rows see one column (no NaN rows)
    def lib():
        return F.scaled_dot_product_attention(q, kd, vd,
                                              attn_mask=mask[:, None],
                                              enable_gqa=True)

    lib_ms, lib_dev_ms = time_ms(lib), graph_ms(lib)
    # pairs: each real token sees min(WINDOW, its position + 1) positions;
    # bytes: the K/V of each slot's band once per kv head, q of the real
    # tokens, every output row, the band's table entries, q_lens, kv_lens
    pairs = n_q * sum(min(WINDOW, kv - q_len + i + 1)
                      for q_len, kv in zip(RAGGED_Q_LENS, RAGGED_KV_LENS)
                      for i in range(q_len))
    spans = [(max(kv - q_len - WINDOW + 1, 0), kv)
             for q_len, kv in zip(RAGGED_Q_LENS, RAGGED_KV_LENS) if q_len]
    live = sum(hi - lo_ for lo_, hi in spans)
    pages = sum((hi - 1) // PAGE - lo_ // PAGE + 1 for lo_, hi in spans)
    esz = q.element_size()
    n_bytes = (2 * live * n_kv * esz * d
               + esz * n_q * d * sum(RAGGED_Q_LENS) + esz * q.numel()
               + 4 * (pages + 2 * slots))
    bms, by = bound_ms(n_bytes, 4 * pairs * d)
    print(f"ragged_paged[window={WINDOW}] bf16 mixed batch: {ms:.4f} ms "
          f"timing eager calls ({dev_ms:.4f} on the device, CUDA graph; "
          f"plain {plain_ms:.4f}, SDPA on the gathered band {lib_ms:.4f} "
          f"({lib_dev_ms:.4f}), bound {bms:.5f} by {by})", flush=True)
    return dict(name="ragged_paged[window]", route="cuda",
                source="burst_attn_tpu_torch/csrc/ragged_paged.cu",
                replaces="burst_attn_tpu/ops/ragged_paged.py:57",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, graph_ms=dev_ms,
                library_graph_ms=lib_dev_ms)


def check_step_probe(device, d=128):
    """Kernel 10 against its plain version at bq 2048, d 128: each
    PROBE_CHECKS cell with and without the product, the output within
    PROBE_RTOL of its largest entry (exactly zero without the product),
    the fetch checksums equal, two launches torch.equal.  Returns the
    kernels-line record at PROBE_ROW_CELL with the product."""
    import torch

    from burst_attn_tpu_torch.bench import step_probe as sp

    def inputs(bkv, steps):
        g = torch.Generator(device=device).manual_seed(bkv + steps)
        q = torch.randn(1, PROBE_BQ, d, generator=g, device=device).bfloat16()
        pool = torch.randn(min(steps, 512), bkv, d, generator=g,
                           device=device).bfloat16()
        return q, pool

    worst = 0.0
    for bkv, steps in PROBE_CHECKS:
        q, pool = inputs(bkv, steps)
        for matmul in (True, False):
            out, sums = sp.step_probe(q, pool, steps, matmul)
            again = sp.step_probe(q, pool, steps, matmul)
            assert torch.equal(out, again[0]) and torch.equal(sums, again[1])
            want, want_sums = sp.step_probe_reference(q, pool, steps, matmul)
            top = float(want.abs().max())
            err = _max_err(out, want)
            assert err <= PROBE_RTOL * top, (bkv, steps, matmul, err, top)
            assert torch.equal(sums, want_sums), "fetch checksums differ"
            worst = max(worst, err / max(top, 1e-30))
            print(f"step_probe bq={PROBE_BQ} bkv={bkv} steps={steps} "
                  f"matmul={matmul}: max_abs_err {err:.3e} of largest "
                  f"{top:.3e} (tolerance {PROBE_RTOL} of it); "
                  f"{sums.numel()} fetch checksums equal; two launches "
                  "torch.equal", flush=True)
    bkv, steps = PROBE_ROW_CELL
    q, pool = inputs(bkv, steps)
    ms = time_ms(lambda: sp.step_probe(q, pool, steps), iters=5, warmup=2)
    plain_ms = time_ms(lambda: sp.step_probe_reference(q, pool, steps),
                       iters=3, warmup=1)
    # what the outputs need: q and the pool read once (the checksums need
    # every word), the out and sums written once; the product as the plain
    # version takes it, the count-weighted pool sum (n_pool * w * d
    # multiply-adds) and one [bq, d] x [d, w] product
    w = min(128, bkv)
    n_bytes = 2 * (q.numel() + pool.numel()) + 4 * PROBE_BQ * 128 + 4 * (
        PROBE_BQ // 16)
    bms, by = bound_ms(n_bytes, 2 * pool.shape[0] * w * d
                       + 2 * PROBE_BQ * w * d)
    # the work the probe prescribes, `steps` block fetches and products,
    # as a yardstick apart from the bound
    work_ms, _ = bound_ms(steps * 2 * bkv * d,
                          steps * 2 * PROBE_BQ * w * d)
    print(f"step_probe bkv={bkv} steps={steps} matmul: {ms:.4f} ms (plain "
          f"{plain_ms:.4f}, bound {bms:.4f} by {by}, the prescribed per-step "
          f"work {work_ms:.4f}; library: none, no single PyTorch call "
          "streams `steps` distinct blocks)", flush=True)
    return dict(name="step_probe", route="cuda",
                source="burst_attn_tpu_torch/csrc/step_probe.cu",
                replaces="benchmarks/step_probe.py:63",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None, probe_work_ms=work_ms,
                library="none: no single PyTorch call streams `steps` "
                        "distinct blocks through one product")


def probe_phase(device, card):
    """The probe's main path: bench.step_probe's sweep (the JAX probe's
    default cells: bkv 256-4096 x steps 512-8192, with and without the
    product) with its launch counter read around it, each row printed,
    then the least-squares fit and its residuals."""
    from burst_attn_tpu_torch.bench import step_probe as sp

    sp.step_probe.launches = 0
    rows = sp.sweep(PROBE_BQ, 128, PROBE_KV_BLOCKS, PROBE_STEPS,
                    (True, False), device, card,
                    record=lambda r: print("step_probe row " + json.dumps(r),
                                           flush=True))
    launches = sp.step_probe.launches
    fit = sp.fit(rows)
    assert len(fit["residuals_us"]) == len(rows)
    print(f"step_probe fit: t_fixed {fit['t_fixed_us']:.4f} us per "
          f"iteration, {fit['gb_per_s']} GB/s, {fit['tflop_per_s']} "
          f"TFLOP/s; residuals (us) "
          + ", ".join(f"{x:.4f}" for x in fit["residuals_us"])
          + f"; {launches} launches", flush=True)
    return dict(rows=rows, fit=fit, launches=launches)


def window_bites(device, prompts):
    """fp32, through paged_prefill (the ServeEngine's admission path,
    kernel 1): each prompt's last-position logits with the window against
    the same model without it.  Returns [(length, max-abs difference)]."""
    import torch

    from burst_attn_tpu_torch.models import paged_decode as pd

    cfg_w, params = wmodel(torch.float32, device)
    cfg_n, _ = model(torch.float32, device)
    out = []
    for p in prompts:
        logits = []
        for cfg in (cfg_w, cfg_n):
            st, pool = pd.init_paged_state(
                cfg, slots=1, n_pages=MAX_PAGES + 1, page=PAGE,
                max_pages_per_seq=MAX_PAGES, device=device)
            with torch.no_grad():
                lg, _ = pd.paged_prefill(params, p, st, pool, 0, cfg)
            logits.append(lg)
        diff = _max_err(*logits)
        out.append((len(p), diff))
        if len(p) <= WINDOW:
            assert diff <= WINDOW_SAME_ATOL, (len(p), diff)
        else:
            assert diff > WINDOW_DIFF_MIN, (len(p), diff)
    print(f"window bites (fp32 paged_prefill, window {WINDOW} vs none): "
          f"(prompt length, last-position logits max-abs difference) "
          f"{[(n, float(f'{x:.3e}')) for n, x in out]}; <= {WINDOW} tokens "
          f"within {WINDOW_SAME_ATOL}, longer ones beyond {WINDOW_DIFF_MIN}",
          flush=True)
    return out


def decode_ticks(device, n_steps=16):
    """bf16 decode tick with every slot live at ~2K context, unwindowed
    and windowed, for each engine, timed in turns (none, window, window,
    none) on engines filled once.  Returns {engine: {"none": ms,
    "window": ms}}."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    prompt = np.random.default_rng(9).integers(1, SERVE_DIMS["vocab"],
                                               size=2048 - 96,
                                               dtype=np.int32)
    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, device=device)
    res = {}
    for name, engine, extra in (("ServeEngine", ServeEngine, {}),
                                ("RaggedServeEngine", RaggedServeEngine,
                                 {"chunk": CHUNK})):
        engs = {}
        for tag, (cfg, params) in (("none", model(torch.bfloat16, device)),
                                   ("window", wmodel(torch.bfloat16,
                                                     device))):
            eng = engine(params, cfg, **kw, **extra)
            for _ in range(SLOTS):
                eng.submit(prompt, 96)
            while eng.pending or any(
                    r is None or getattr(r, "n_prefilled", len(r.prompt))
                    < len(r.prompt) for r in eng.slots):
                eng.step()
            assert eng.live == SLOTS
            engs[tag] = eng
        times = {"none": [], "window": []}
        for tag in ("none", "window", "window", "none"):
            eng = engs[tag]
            times[tag].append(host_ms(lambda: [eng.step()
                                               for _ in range(n_steps)],
                                      repeats=1) / n_steps)
        for eng in engs.values():
            eng.drain()
        res[name] = {t: sum(v) / len(v) for t, v in times.items()}
        print(f"{name} bf16 decode tick ({SLOTS} slots at ~2K context): "
              f"unwindowed {res[name]['none']:.3f} ms, window {WINDOW} "
              f"{res[name]['window']:.3f} ms (each the mean of two turns)",
              flush=True)
    return res


def window_serve_phase(device):
    """The serving model with window=1024, layout contig, at full width and
    depth: the 12 requests through the ServeEngine and the
    RaggedServeEngine in fp32 (token-exact with the dense windowed forward
    and with each other) and bf16 (>= 95%, near ties only), launch counts
    around each run; the dense `generate` on the 2048-token prompt
    (token-exact in fp32); an int8 pool through the ragged engine against
    plain attention; the window's effect on the last-position logits; the
    decode tick beside the unwindowed one."""
    import torch

    from burst_attn_tpu_torch.models.decode import generate
    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.ops import flash
    from burst_attn_tpu_torch.ops import paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, device=device)
    engines = (("ServeEngine", ServeEngine, {},
                (flash.flash_fwd, pa.paged_decode_attention)),
               ("RaggedServeEngine", RaggedServeEngine, {"chunk": CHUNK},
                (rp.ragged_paged_attention, flash.flash_fwd)))
    res = {"window": WINDOW}
    for key, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cfg, params = wmodel(dtype, device)
        prompts, budgets = requests(cfg)
        streams = {}
        for name, engine, extra, counters in engines:
            eng = engine(params, cfg, **kw, **extra)
            toks, launches, run_s = drive(eng, prompts, budgets, counters)
            assert eng.pool.available == N_PAGES - 1, "pool did not drain"
            if name == "ServeEngine":
                assert launches["flash_fwd"] == cfg.n_layers * N_REQUESTS
                assert launches["paged_decode_attention"] > 0
            else:
                ticks = sum(v for k, v in eng.stats.items()
                            if k.startswith("serve.ragged_batch_launches"))
                fb = sum(v for k, v in eng.stats.items()
                         if k.startswith("burst.fused_fallback"))
                assert fb == 0 and launches["ragged_paged_attention"] == \
                    cfg.n_layers * ticks > 0, (launches, ticks, fb)
                assert launches["flash_fwd"] == 0, launches
            print(f"{name} {key} window {WINDOW}: {N_REQUESTS} requests, "
                  f"{sum(budgets)} tokens in {run_s:.2f} s, launches "
                  f"{launches}", flush=True)
            check_agreement(f"{name} {key} window {WINDOW}", agreement(
                cfg, params, prompts, toks, device), key == "bf16",
                against=f"the dense forward with window {WINDOW}")
            streams[name] = toks
            res[f"{name}_{key}_launches"] = launches
        if key == "fp32":
            assert streams["ServeEngine"] == streams["RaggedServeEngine"], \
                "windowed fp32 engines' tokens differ"
            print(f"window {WINDOW} fp32: the two engines' tokens are equal",
                  flush=True)
            res["fp32_prompts"] = prompts

    # the dense-cache generate on the 2048-token prompt (fp32)
    cfg, params = wmodel(torch.float32, device)
    prompt = res["fp32_prompts"][1]
    flash.flash_fwd.launches = 0
    toks = generate(params, torch.from_numpy(prompt.astype("int64"))[None],
                    cfg, steps=32, max_seq=len(prompt) + 32)[0].tolist()
    gen_launches = flash.flash_fwd.launches
    assert gen_launches == cfg.n_layers, gen_launches
    print(f"generate fp32 window {WINDOW}: {len(prompt)}-token prompt, 32 "
          f"tokens, flash_fwd launches {gen_launches}", flush=True)
    check_agreement(f"generate fp32 window {WINDOW}", agreement(
        cfg, params, [prompt], [toks], device), False,
        against=f"the dense forward with window {WINDOW}")
    res["generate_launches"] = gen_launches

    # an int8 pool through the ragged engine (fp32 model) vs plain attention
    prompts, budgets = requests(cfg)
    runs = []
    for plain in (False, True):
        with plain_attention() if plain else contextlib.nullcontext():
            eng = RaggedServeEngine(params, cfg, quantize="int8",
                                    chunk=CHUNK, **kw)
            runs.append(drive(eng, prompts, budgets,
                              (rp.ragged_paged_attention,)))
    (toks, launches, _), (want, cl, _) = runs
    assert sum(cl.values()) == 0 and launches["ragged_paged_attention"] > 0
    flips = near_tie_flips(cfg, params, prompts, toks, want, device)
    same = sum(a == b for a, b in zip(toks, want))
    print(f"RaggedServeEngine fp32 window {WINDOW}, int8 pool: launches "
          f"{launches}; kernel vs plain attention {same}/{N_REQUESTS} "
          f"streams identical; flips (request, token, dense-forward logit "
          f"gap) {flips}", flush=True)
    assert all(g <= TIE_GAP for _, _, g in flips), flips
    res["int8"] = (same, flips)

    res["bites"] = window_bites(device, prompts)
    res["decode_tick_ms"] = decode_ticks(device)
    return res


# ---------------------------------------------------------------------------
# speculative serving: speculative_generate on the dense cache, the
# ServeEngine's draft mode (paged_multi_step) and the RaggedServeEngine's
# draft rounds (the verify on kernel 7 at QT = k+1)

SPEC_K = 4  # proposals a round (serve_bench.py --spec-k's default)
# the early-exit draft: the target's first 2 of 4 layers, weights shared
# (serve_bench.py --spec-layers 2)
SPEC_EXIT_LAYERS = 2
SPEC_STEPS = 64  # speculative_generate's tokens on the longest prompt
# the draft engines' runs serve all 12 seeded requests at their budgets
# over SPEC_BUDGET_DIV (16-32 new tokens): the 8 slots fill and 4 requests
# take slots just retired, in half the rounds of the full budgets (a cut
# to make room for the multihost phase)
SPEC_BUDGET_DIV = 2
# kernel 7 at the verify width: 8 slots decoding at the serving run's
# context lengths, every one with k+1 query tokens
VERIFY_KV_LENS = (2117, 2053, 1797, 1500, 1029, 700, 305, 5)


def spec_drafts(dtype, device):
    """(cfg, params, {"self": (params, cfg), "exit": (params, cfg)}): the
    serving model and its two drafts, the model itself and its first
    SPEC_EXIT_LAYERS layers over the same weights."""
    import dataclasses

    cfg, params = model(dtype, device)
    exit_cfg = dataclasses.replace(cfg, n_layers=SPEC_EXIT_LAYERS)
    exit_params = dict(params, layers=params["layers"][:SPEC_EXIT_LAYERS])
    return cfg, params, {"self": (params, cfg),
                         "exit": (exit_params, exit_cfg)}


@contextlib.contextmanager
def no_plain_attention():
    """Make every plain attention of the paged paths raise: a speculative
    run on the card must attend through kernels 6 and 7 only."""
    from unittest import mock

    import burst_attn_tpu_torch.models.paged_decode as pd
    from burst_attn_tpu_torch.ops import paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp

    def refuse(*a, **kw):
        raise AssertionError("a speculative path called a plain attention")

    with mock.patch.object(pd, "ragged_paged_reference", refuse), \
            mock.patch.object(rp, "ragged_paged_reference", refuse), \
            mock.patch.object(rp, "ragged_paged_partials_reference",
                              refuse), \
            mock.patch.object(pa, "paged_decode_reference", refuse):
        yield


def check_ragged_verify(device):
    """Kernel 7 at the verify width (QT = 2 and k+1 in every live slot)
    against its plain version on bf16, fp32, int8 and fp8 pools, two
    launches torch.equal; then the kernels-line entry at QT = k+1, bf16:
    eager and CUDA-graph times, the plain version's, SDPA's with the same
    causal mask on the gathered cache, and the bound by bytes."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import ragged_paged as rp

    bf16, fp32 = torch.bfloat16, torch.float32
    worst = 0.0
    for qt in (2, SPEC_K + 1):
        for dt, quant in ((bf16, None), (fp32, None), (fp32, "int8"),
                          (bf16, "fp8")):
            q, kp, vp, table, ql, kl, ks, vs = _ragged_case(
                device, dt, quant, seed=31 + qt, q_lens=(qt,) * SLOTS,
                kv_lens=VERIFY_KV_LENS, qt=qt)
            kw = dict(k_scales=ks, v_scales=vs)
            o = rp.ragged_paged_attention(q, kp, vp, table, ql, kl, **kw)
            assert torch.equal(o, rp.ragged_paged_attention(
                q, kp, vp, table, ql, kl, **kw)), \
                "ragged_paged at the verify width: two launches differ"
            want = rp.ragged_paged_reference(q, kp, vp, table, ql, kl, **kw)
            err = _check_o(f"ragged verify QT={qt} {quant or ''}", o, want,
                           dt)
            worst = max(worst, err)
            print(f"ragged_paged verify QT={qt} {_dtype_key(dt)} pool="
                  f"{quant or _dtype_key(dt)} kv_lens="
                  f"{list(VERIFY_KV_LENS)} max_abs_err={err:.3e} (tolerance "
                  f"{O_TOL[_dtype_key(dt)]}); two launches torch.equal",
                  flush=True)
    qt = SPEC_K + 1
    q, kp, vp, table, ql, kl, _, _ = _ragged_case(
        device, bf16, None, seed=37, q_lens=(qt,) * SLOTS,
        kv_lens=VERIFY_KV_LENS, qt=qt)

    def kernel():
        return rp.ragged_paged_attention(q, kp, vp, table, ql, kl)

    ms, dev_ms = time_ms(kernel), graph_ms(kernel)
    plain_ms = time_ms(lambda: rp.ragged_paged_reference(
        q, kp, vp, table, ql, kl), iters=5)
    slots, n_q, _, d = q.shape
    n_kv, page, width = kp.shape[1], kp.shape[2], table.shape[1]
    idx = table.long()
    kd = kp[idx].movedim(2, 1).reshape(slots, n_kv, width * page, d)
    vd = vp[idx].movedim(2, 1).reshape(slots, n_kv, width * page, d)
    qp = (kl - ql).long()[:, None] + torch.arange(qt, device=device)[None]
    col = torch.arange(width * page, device=device)
    mask = col[None, None, :] <= qp[:, :, None]

    def lib():
        return F.scaled_dot_product_attention(q, kd, vd,
                                              attn_mask=mask[:, None],
                                              enable_gqa=True)

    lib_ms, lib_dev_ms = time_ms(lib), graph_ms(lib)
    pairs = n_q * sum(qt * (kv - qt) + qt * (qt + 1) // 2
                      for kv in VERIFY_KV_LENS)
    # what the function must move: the live positions' K and V once per
    # (slot, kv head), q and o, the live pages' table entries, the lengths
    live = sum(VERIFY_KV_LENS)
    n_bytes = (2 * live * n_kv * d * kp.element_size()
               + 2 * q.element_size() * q.numel()
               + 4 * (sum(-(-kv // page) for kv in VERIFY_KV_LENS)
                      + 2 * slots))
    bms, by = bound_ms(n_bytes, 4 * pairs * d)
    print(f"ragged_paged verify (QT={qt}, {SLOTS} slots to "
          f"{max(VERIFY_KV_LENS)} positions, Nkv4 G4 D128 bf16): {ms:.4f} ms "
          f"a call timing eager calls ({dev_ms:.4f} on the device, CUDA "
          f"graph), plain {plain_ms:.4f}, SDPA {lib_ms:.4f} "
          f"({lib_dev_ms:.4f}), bound {bms:.5f} by {by}", flush=True)
    return worst, dict(shape=f"{SLOTS} slots x QT {qt}, kv to "
                       f"{max(VERIFY_KV_LENS)}, Nkv4 G4 D128 bf16",
                       ms=ms, graph_ms=dev_ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, library_ms=lib_ms,
                       library_graph_ms=lib_dev_ms)


def spec_generate_phase(device, prompts):
    """speculative_generate at B=1 on the longest of the 12 prompts, 64
    tokens: fp32 self-draft token-exact with generate() (every proposal
    accepted, ceil(63 / 5) target passes), bf16 early-exit equal to
    generate() or parted at a near tie, fp32 sampled self-draft (T 0.8)
    accepting >= 99%; both prompts through kernel 1; wall ms of generate
    and of each draft in bf16."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.models import speculative_generate
    from burst_attn_tpu_torch.models.decode import generate
    from burst_attn_tpu_torch.ops import flash

    prompt = max(prompts, key=len)
    max_seq = len(prompt) + SPEC_STEPS + SPEC_K + 1
    tok = torch.from_numpy(prompt.astype(np.int64)).to(device)[None]
    kw = dict(steps=SPEC_STEPS, k=SPEC_K, max_seq=max_seq,
              return_stats=True)
    out = {}
    passes = -(-(SPEC_STEPS - 1) // (SPEC_K + 1))
    cfg, params, drafts = spec_drafts(torch.float32, device)
    want = generate(params, tok, cfg, steps=SPEC_STEPS,
                    max_seq=max_seq)[0].tolist()
    flash.flash_fwd.launches = 0
    got, st = speculative_generate(params, params, tok, cfg, cfg, **kw)
    assert flash.flash_fwd.launches == 2 * cfg.n_layers, \
        flash.flash_fwd.launches
    assert got.tolist() == want, "fp32 self-draft tokens differ"
    assert st.accepted == st.proposed and st.target_passes == passes, st
    rng = torch.Generator(device=device).manual_seed(5)
    _, sst = speculative_generate(params, params, tok, cfg, cfg, rng=rng,
                                  temperature=0.8, **kw)
    out["fp32_self"] = dict(st._asdict())
    out["fp32_sampled_self"] = dict(sst._asdict())
    assert sst.accepted >= 0.99 * sst.proposed, sst
    print(f"speculative_generate fp32 self-draft ({len(prompt)}-token prompt"
          f", {SPEC_STEPS} tokens, k={SPEC_K}): tokens equal generate(), "
          f"{st}; sampled (T 0.8): {sst}, acceptance "
          f"{sst.accepted / sst.proposed:.4f}", flush=True)

    cfg, params, drafts = spec_drafts(torch.bfloat16, device)
    runs = {"generate": lambda: generate(params, tok, cfg, steps=SPEC_STEPS,
                                         max_seq=max_seq)[0].tolist()}
    for name, (dp, dc) in drafts.items():
        runs[name] = (lambda dp=dp, dc=dc: speculative_generate(
            params, dp, tok, cfg, dc, **kw))
    toks = {}
    for name, fn in runs.items():
        res = fn()
        toks[name] = res if name == "generate" else res[0].tolist()
        if name != "generate":
            out[f"bf16_{name}"] = dict(res[1]._asdict())
        out[f"bf16_{name}_ms"] = host_ms(fn, repeats=1)
    for name in drafts:
        flips = near_tie_flips(cfg, params, [prompt], [toks[name]],
                               [toks["generate"]], device)
        assert all(g <= TIE_GAP for _, _, g in flips), (name, flips)
        out[f"bf16_{name}_flips"] = flips
    ex = out["bf16_exit"]
    print(f"speculative_generate bf16 ({card_line()}): generate "
          f"{out['bf16_generate_ms']:.1f} ms, self-draft "
          f"{out['bf16_self_ms']:.1f} ms ({out['bf16_self']['target_passes']}"
          f" target passes), early-exit {SPEC_EXIT_LAYERS}-layer draft "
          f"{out['bf16_exit_ms']:.1f} ms (acceptance "
          f"{ex['accepted'] / ex['proposed']:.4f}, {ex['target_passes']} "
          f"target passes); flips against generate() (request, token, "
          f"dense-forward logit gap): self {out['bf16_self_flips']}, exit "
          f"{out['bf16_exit_flips']}", flush=True)
    return out


def _spec_run(eng_cls, dtype, device, draft, quantize=False, **extra):
    """The seeded requests at SPEC_BUDGET_DIV of their budgets through a
    draft engine with every plain paged attention refused; the launch counters of kernels 1, 6, 7 set to 0
    just before the run and read just after, and kernel 7's counter read
    around every speculative round: launches["spec_verify"] is the sum of
    those deltas, the verify launches the wrapper counted.  Returns (cfg,
    params, prompts, engine, tokens, launches)."""
    from burst_attn_tpu_torch.ops import flash, paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp

    cfg, params, drafts = spec_drafts(dtype, device)
    dp, dc = drafts[draft]
    prompts, budgets = requests(cfg)
    budgets = [n // SPEC_BUDGET_DIV for n in budgets]
    eng = eng_cls(params, cfg, slots=SLOTS, n_pages=N_PAGES, page=PAGE,
                  max_pages_per_seq=MAX_PAGES, quantize=quantize,
                  draft_params=dp, draft_cfg=dc, spec_k=SPEC_K,
                  device=device, **extra)
    verify = [0]
    spec_round = eng._spec_round

    def counted_round():
        before = rp.ragged_paged_attention.launches
        spec_round()
        verify[0] += rp.ragged_paged_attention.launches - before

    eng._spec_round = counted_round
    with no_plain_attention():
        toks, launches, run_s = drive(
            eng, prompts, budgets, (flash.flash_fwd, pa.paged_decode_attention,
                                    rp.ragged_paged_attention))
    launches["spec_verify"] = verify[0]
    assert eng.pool.available == eng.draft.pool.available == N_PAGES - 1, \
        "a pool did not drain"
    assert eng.spec_rounds > 0
    rounds, n_draft = eng.spec_rounds, dc.n_layers
    n_tgt = cfg.n_layers
    # one kernel-7 verify a target layer a round, and no other launch of
    # kernel 7 inside a round
    assert launches["spec_verify"] == n_tgt * rounds, (launches, rounds)
    # the draft's k proposals and its catch-up: kernel 6 once a layer each
    assert launches["paged_decode_attention"] == \
        n_draft * (SPEC_K + 1) * rounds, (launches, rounds)
    pool = f" {quantize} pool" if quantize else ""
    print(f"{eng_cls.__name__} {_dtype_key(dtype)}{pool} {draft}-draft: "
          f"{len(prompts)} requests, "
          f"{sum(map(len, toks))} tokens in {run_s:.2f} s, {rounds} rounds, "
          f"acceptance {eng.acceptance_rate:.4f}, launches {launches}",
          flush=True)
    if eng_cls.__name__ == "ServeEngine":
        assert launches["flash_fwd"] == (n_tgt + n_draft) * len(prompts)
        assert launches["ragged_paged_attention"] == n_tgt * rounds
    else:
        st = eng.stats
        assert not any(k.startswith("burst.fused_fallback") for k in st), st
        ticks = sum(v for k, v in st.items()
                    if k.startswith("serve.ragged_batch_launches"))
        assert st["serve.ragged_batch_launches{kind=spec-verify}"] == rounds
        assert launches["flash_fwd"] == n_draft * len(prompts)
        assert launches["ragged_paged_attention"] == n_tgt * ticks \
            + n_draft * st["serve.draft_catchup_launches"], (launches, st)
        assert eng.graphs is None
    return cfg, params, prompts, eng, toks, launches


def _heads(streams, toks):
    """Each of `streams` (a plain engine's tokens by request) cut to the
    length of the matching stream of `toks` (a run at shorter budgets)."""
    return [w[:len(t)] for w, t in zip(streams, toks, strict=True)]


def spec_engines_phase(device, serve_res, rag):
    """Both engines' draft modes on the seeded requests at shorter budgets
    (_spec_run): fp32 self-draft token-exact with the heads of the plain
    fp32 engine's streams (every proposal accepted),
    bf16 early-exit draft held to the teacher-forced bar, fp32 self-draft
    on an int8 pool against the plain int8 engine (equal, or a flip at a
    near tie); the RaggedServeEngine also pipelined (delegated: the same
    tokens, no graph) and on the prefix-cache wave.  Launch counts and
    drained pools in every run (_spec_run)."""
    import torch

    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    fp32, bf16 = torch.float32, torch.bfloat16
    res = {}
    for eng_cls, plain, extra in (
            (ServeEngine, serve_res, {}),
            (RaggedServeEngine, rag, {"chunk": CHUNK})):
        name = eng_cls.__name__
        _, _, _, eng, toks, launches = _spec_run(eng_cls, fp32, device,
                                                 "self", **extra)
        n = len(toks)
        assert toks == _heads(plain["fp32"]["toks"], toks), \
            f"{name} fp32 self-draft"
        assert eng.acceptance_rate == 1.0, eng.acceptance_rate
        rec = {"fp32_self_rounds": eng.spec_rounds, "fp32_self": launches}
        cfg, params, prompts, eng, toks, launches = _spec_run(
            eng_cls, bf16, device, "exit", **extra)
        check_agreement(f"{name} bf16 early-exit draft", agreement(
            cfg, params, prompts, toks, device), True)
        rec.update(bf16_exit=launches, bf16_exit_rounds=eng.spec_rounds,
                   bf16_exit_acceptance=eng.acceptance_rate)
        cfg, params, prompts, _, toks, _ = _spec_run(
            eng_cls, fp32, device, "self", quantize="int8", **extra)
        want = _heads(rag["quant_toks_int8"] if eng_cls is RaggedServeEngine
                      else serve_res["quant_toks"], toks)
        flips = near_tie_flips(cfg, params, prompts, toks, want, device)
        same = sum(a == b for a, b in zip(toks, want))
        print(f"{name} fp32 int8 pool self-draft: {same}/{n} "
              f"streams equal the plain int8 engine's; flips (request, "
              f"token, dense-forward logit gap) {flips}", flush=True)
        assert all(g <= TIE_GAP for _, _, g in flips), flips
        rec["int8_same"] = same
        res[name] = rec
    _, _, _, eng, toks, _ = _spec_run(RaggedServeEngine, fp32, device, "self",
                                      chunk=CHUNK, pipeline=True,
                                      multi_step=K_PIPE)
    assert toks == _heads(rag["fp32"]["toks"], toks)
    assert eng._pending is None
    print("RaggedServeEngine fp32 self-draft, pipeline=True multi_step="
          f"{K_PIPE}: tokens equal the synchronous engine's, no graph",
          flush=True)
    cfg, params, drafts = spec_drafts(fp32, device)
    dp, dc = drafts["self"]
    with no_plain_attention():
        stats, toks = prefix_wave(device, draft_params=dp, draft_cfg=dc,
                                  spec_k=SPEC_K)
    assert toks == rag["prefix_toks"], "self-draft prefix wave tokens differ"
    print("self-draft prefix wave: tokens equal the plain wave's; both "
          "pools drained", flush=True)
    res["prefix"] = stats
    return res


def spec_timings(device, n_rounds=8):
    """bf16, 8 slots decoding at ~2K context, both engines: tokens/s of
    the plain synchronous tick, of a self-draft round (the ceiling:
    acceptance 1) and of an early-exit round (the honest number for random
    weights), timed in turns (plain, self, exit, exit, self, plain; tokens
    added over the wall of n_rounds steps); then one profiled step each:
    device ms and busy share."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    cfg, params, drafts = spec_drafts(torch.bfloat16, device)
    prompt = np.random.default_rng(9).integers(1, cfg.vocab, size=2048 - 256,
                                               dtype=np.int32)
    out = {}
    for eng_cls, extra in ((ServeEngine, {}),
                           (RaggedServeEngine, {"chunk": CHUNK})):
        engs = {}
        for name in ("plain", "self", "exit"):
            spec = {} if name == "plain" else dict(
                draft_params=drafts[name][0], draft_cfg=drafts[name][1],
                spec_k=SPEC_K)
            eng = eng_cls(params, cfg, slots=SLOTS, n_pages=N_PAGES,
                          page=PAGE, max_pages_per_seq=MAX_PAGES,
                          device=device, **extra, **spec)
            for _ in range(SLOTS):
                eng.submit(prompt, 256)
            while eng.pending or any(
                    r is None or len(r.tokens) < 2 for r in eng.slots):
                eng.step()
            engs[name] = eng

        def tok_s(eng):
            before = sum(len(r.tokens) for r in eng.slots)
            ms = host_ms(lambda: [eng.step() for _ in range(n_rounds)],
                         repeats=1)
            return (sum(len(r.tokens) for r in eng.slots) - before) \
                / ms * 1e3

        turns = {k: [] for k in engs}
        for name in ("plain", "self", "exit", "exit", "self", "plain"):
            turns[name].append(tok_s(engs[name]))
        rec = {"tok_s": {k: sum(v) / len(v) for k, v in turns.items()},
               "tok_s_turns": turns}
        for name, eng in engs.items():
            wall, dev, top = device_breakdown(eng.step, 1)
            rec[f"{name}_step"] = dict(wall_ms=wall, device_ms=dev,
                                       busy=dev / wall)
            if name != "plain":
                rec[f"{name}_acceptance"] = eng.acceptance_rate
            print_profile(f"{eng_cls.__name__} {name} "
                          f"{'round' if name != 'plain' else 'tick'} "
                          f"(bf16, {SLOTS} slots at ~2K)", (wall, dev, top))
            assert eng.live == SLOTS
            eng.drain()
            assert eng.pool.available == N_PAGES - 1
        t = rec["tok_s"]
        print(f"{eng_cls.__name__} speculative (bf16, {SLOTS} slots at ~2K, "
              f"k={SPEC_K}; {card_line()}): tokens/s plain tick "
              f"{t['plain']:.1f}, self-draft round {t['self']:.1f} "
              f"(acceptance {rec['self_acceptance']:.4f}), early-exit "
              f"{SPEC_EXIT_LAYERS}-layer round {t['exit']:.1f} (acceptance "
              f"{rec['exit_acceptance']:.4f}); busy plain "
              f"{rec['plain_step']['busy']:.3f}, self "
              f"{rec['self_step']['busy']:.3f}, exit "
              f"{rec['exit_step']['busy']:.3f}", flush=True)
        out[eng_cls.__name__] = rec
    return out


def speculative_phase(device, serve_res, rag):
    """The speculative phase (after the pipelined one): kernel 7 at the
    verify width, speculative_generate, both engines' draft modes, the
    timings.  Returns (kernel 7's verify record, the phase's results)."""
    t0 = time.perf_counter()
    err, verify = check_ragged_verify(device)
    res = {"generate": spec_generate_phase(device, serve_res["fp32"][
        "prompts"])}
    res["engines"] = spec_engines_phase(device, serve_res, rag)
    res["timings"] = spec_timings(device)
    res["seconds"] = time.perf_counter() - t0
    print(f"speculative phase: {res['seconds']:.1f} s", flush=True)
    return err, verify, res


# ---------------------------------------------------------------------------
# crash-consistent serving: engine snapshots, the write-ahead journal,
# recovery (serving/checkpoint.py)

# Ticks before the snapshot and before the kill of the 12 requests.  No
# request can finish before tick 32 (every budget is >= 32 tokens and a
# request gains at most one a tick), so at the kill every request is still
# in flight or queued: a recovery from the snapshot re-runs the original's
# ticks exactly (the same launch shapes on the same bytes, so bf16 must be
# token-exact too), re-decoding the journal's lag past the snapshot.
CKPT_SNAP_TICK, CKPT_KILL_TICK = 12, 28
CKPT_PREFIX_TICK = 3  # the prefix wave's snapshot: pinned pages in flight


def _ckpt_dir():
    """Snapshots and journals go under the checkout's build/ (ignored by
    git), nowhere else."""
    import pathlib

    d = pathlib.Path(__file__).resolve().parent / "build" / "ckpt"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _ckpt_engine(kind, dtype, device):
    """The serving cell's engine of `kind`: "ServeEngine", "ragged" (the
    synchronous RaggedServeEngine), "pipelined" (K_PIPE) or "prefix"
    (the ragged engine with prefix_cache=True)."""
    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    cfg, params = model(dtype, device)
    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, device=device)
    if kind == "ServeEngine":
        return ServeEngine(params, cfg, **kw)
    extra = {"pipelined": dict(pipeline=True, multi_step=K_PIPE),
             "prefix": dict(prefix_cache=True)}.get(kind, {})
    return RaggedServeEngine(params, cfg, chunk=CHUNK, **kw, **extra)


def _ckpt_traffic(kind, cfg):
    """(warm-up requests, prompts, budgets): the 12 seeded requests; the
    prefix wave (prefix_wave's template and tails) after a warm request
    that registers the template."""
    if kind != "prefix":
        return [], *requests(cfg)
    tmpl, prompts = prefix_prompts(cfg)
    return [(tmpl, 2)], prompts, [24] * len(prompts)


def _total_tokens(eng):
    return (sum(len(r.tokens) for r in eng.slots if r is not None)
            + sum(len(t) for t in eng._finished.values()))


def _counted(eng, run):
    """Call `run()` (eng.run, or run_recovered on eng) with the launch
    counters of kernels 1, 6 and 7 set to 0 just before and read just
    after, and hold them to what the run's admissions and ticks imply.
    ServeEngine: kernel 1 once a layer an admission (every queued request
    is admitted once), kernel 6 once a layer a decode step (a step whose
    new tokens outnumber its admissions: an admission samples one token,
    a decode step one a live slot); RaggedServeEngine: kernel 7 once a
    layer a tick the device ran.  Returns (run's result, launches)."""
    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.ops import flash, paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp

    counters = (flash.flash_fwd, pa.paged_decode_attention,
                rp.ragged_paged_attention)
    n_layers = eng.cfg.n_layers
    legacy = isinstance(eng, ServeEngine)
    decodes = [0]
    if legacy:
        admissions = len(eng._queue)
        real = eng.step

        def step():
            q0, t0 = len(eng._queue), _total_tokens(eng)
            done = real()
            if _total_tokens(eng) - t0 > q0 - len(eng._queue):
                decodes[0] += 1
            return done

        eng.step = step
    else:
        ticks0 = _device_ticks(eng)
    for f in counters:
        f.launches = 0
    out = run()
    launches = {f.__name__: f.launches for f in counters}
    if legacy:
        del eng.step
        want = {"flash_fwd": n_layers * admissions,
                "paged_decode_attention": n_layers * decodes[0],
                "ragged_paged_attention": 0}
    else:
        want = {"flash_fwd": 0, "paged_decode_attention": 0,
                "ragged_paged_attention": n_layers * (_device_ticks(eng)
                                                      - ticks0)}
    assert launches == want, (launches, want)
    return out, launches


def _tear(path):
    """A kill mid-append: the journal's last line cut in half.  Returns
    the torn copy's path."""
    data = open(path, "rb").read()
    start = data.rstrip(b"\n").rfind(b"\n") + 1
    last = data[start:].rstrip(b"\n")
    torn = str(path) + ".torn"
    with open(torn, "wb") as f:
        f.write(data[:start] + last[:len(last) // 2])
    return torn


def checkpoint_run(kind, dtype, device):
    """One engine kind in one dtype at the serving width.  The traffic
    runs with a TokenJournal attached (the synchronous engines) to
    CKPT_SNAP_TICK (CKPT_PREFIX_TICK for the prefix wave), where
    save_snapshot runs (size, ms); the journal's state at CKPT_KILL_TICK
    is kept as the kill's; the engine then runs to the end: the
    uninterrupted streams.  A fresh engine of the same spec (the
    pipelined one warmed first, so its K-tick graph exists before the
    restore) loads and restores the snapshot (ms; graph captures must not
    grow) and finishes: token-exact.  The synchronous engines then
    recover from the torn journal with the snapshot (token-exact;
    replayed < baseline) and without it (in bf16 at the teacher-forced
    bar, every parting from the uninterrupted stream a near tie; the
    fuzz phase holds fp32 journal-only recovery token-exact).  Launches
    of kernels 1, 6, 7 held to each run's admissions and ticks."""
    import os
    import shutil

    import torch

    from burst_attn_tpu_torch.serving import checkpoint as ckpt

    d = _ckpt_dir()
    key = _dtype_key(dtype)
    what = f"checkpoint {kind} {key}"
    cfg, params = model(dtype, device)
    warm, prompts, budgets = _ckpt_traffic(kind, cfg)
    journaled = kind in ("ServeEngine", "ragged")
    snap_tick = CKPT_PREFIX_TICK if kind == "prefix" else CKPT_SNAP_TICK
    snap, jpath = str(d / "snap.npz"), str(d / "journal.jsonl")
    eng = _ckpt_engine(kind, dtype, device)
    for p, n in warm:
        eng.submit(p, n)
    eng.run()
    journal = ckpt.TokenJournal(jpath, truncate=True) if journaled else None
    eng.journal = journal
    rids = []
    for p, n in zip(prompts, budgets):
        rids.append(eng.submit(p, n))
        if journal is not None:
            journal.submit(rids[-1], rids[-1], p, n)
    if journal is not None:
        journal.sync()
    delivered = {}
    res = {}
    for tick in range(CKPT_KILL_TICK if journaled else snap_tick):
        for rid, toks in eng.step():
            delivered[rid] = list(toks)
        if tick + 1 == snap_tick:
            assert eng.live > 0, "nothing in flight at the snapshot"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save_snapshot(eng, snap)
            res["save_ms"] = (time.perf_counter() - t0) * 1e3
            res["mb"] = os.path.getsize(snap) / 1e6
    if journaled:
        shutil.copyfile(jpath, jpath + ".kill")
    out = eng.run()
    expect = {r: out[r] for r in rids}
    del eng
    if journal is not None:
        journal.close()

    target = _ckpt_engine(kind, dtype, device)
    captures = 0
    if kind == "pipelined":
        target.submit(prompts[0][:256], 2 * K_PIPE)
        target.run()
        captures = target.graphs.captures
        assert captures > 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.restore_into(target, ckpt.load_snapshot(snap))
    torch.cuda.synchronize()
    res["restore_ms"] = (time.perf_counter() - t0) * 1e3
    if kind == "pipelined":
        assert target.graphs.captures == captures, "the restore captured"
    if kind != "ServeEngine":
        import numpy as np

        assert np.array_equal(target._lengths,
                              target.state.lengths.cpu().numpy())
        assert np.array_equal(target._table,
                              target.state.page_table.cpu().numpy())
    got, launches = _counted(target, target.run)
    assert {r: got[r] for r in rids} == expect, f"{what}: restored streams"
    res["launches"] = {"roundtrip": launches}
    if target.cache is not None:
        target.cache.evict(N_PAGES)
    assert target.pool.available == N_PAGES - 1, "pool did not drain"
    del target
    print(f"{what}: snapshot at tick {snap_tick} of {len(rids)} requests, "
          f"{res['mb']:.1f} MB, save {res['save_ms']:.1f} ms, load and "
          f"restore {res['restore_ms']:.1f} ms; the restored engine's "
          f"{len(rids)} streams equal the uninterrupted run's; launches "
          f"{launches}", flush=True)
    if not journaled:
        return res

    torn = _tear(jpath + ".kill")
    assert ckpt.journal_view(torn).n_skipped == 1
    for use_snap in (True, False):
        eng = _ckpt_engine(kind, dtype, device)
        info = ckpt.recover_engine(eng, snap if use_snap else None, torn)
        assert info.n_skipped == 1 and info.from_snapshot == use_snap
        assert not info.done, "a request finished before the kill"
        run, launches = _counted(eng, lambda: ckpt.run_recovered(eng, info))
        assert eng.pool.available == N_PAGES - 1, "pool did not drain"
        del eng
        full = dict(delivered)
        full.update(run)
        toks = [full[r] for r in rids]
        how = "snapshot + journal" if use_snap else "journal only"
        same = sum(full[r] == expect[r] for r in rids)
        print(f"{what} recovery ({how}, kill at tick {CKPT_KILL_TICK}, "
              f"torn last line): replayed {info.total_replayed} of a "
              f"replay-from-scratch {info.baseline_replay}, resumed "
              f"{info.total_resumed}, {len(info.done)} complete in the "
              f"journal; {same}/{len(rids)} streams equal the uninterrupted "
              f"run's; launches {launches}", flush=True)
        rec = dict(replayed=info.total_replayed,
                   baseline=info.baseline_replay,
                   resumed=info.total_resumed, same=same, launches=launches)
        if use_snap:
            assert info.total_replayed < info.baseline_replay, rec
            assert same == len(rids), f"{what}: snapshot recovery differs"
        else:
            # the resumed streams re-prefill prompt + prefix, which the
            # original decoded: bf16 rounding may part them at near ties
            check_agreement(f"{what} journal-resumed", agreement(
                cfg, params, prompts, toks, device), True)
            flips = near_tie_flips(cfg, params, prompts, toks,
                                   [expect[r] for r in rids], device)
            assert all(g <= TIE_GAP for _, _, g in flips), flips
            rec["flips"] = flips
        res["snapshot_recovery" if use_snap else "journal_recovery"] = rec
    return res


# the journal cost's requests: every slot stays live through the timed
# ticks (K_PIPE x 34 tokens at most), and the drain after them stays short
JOURNAL_BUDGET = 160


def journal_ticks(device, n_steps=16):
    """bf16 decode ticks with every slot live at ~2K context through the
    synchronous ragged engine and the pipelined one (K_PIPE), each with
    and without a TokenJournal, timed in turns (off, on, on, off): ms a
    tick = wall / ticks advanced, and the fsyncs the journal made in the
    timed steps with their mean ms (os.fsync counted and timed on the
    host clock)."""
    import os
    from unittest import mock

    import numpy as np
    import torch

    from burst_attn_tpu_torch.serving import RaggedServeEngine
    from burst_attn_tpu_torch.serving import checkpoint as ckpt

    cfg, params = model(torch.bfloat16, device)
    prompt = np.random.default_rng(9).integers(1, cfg.vocab, size=2048 - 256,
                                               dtype=np.int32)
    d = _ckpt_dir()
    engs = {}
    for name, extra in (("sync", {}),
                        ("k4", dict(pipeline=True, multi_step=K_PIPE))):
        for on in (False, True):
            journal = (ckpt.TokenJournal(str(d / f"ticks_{name}.jsonl"),
                                         truncate=True) if on else None)
            eng = RaggedServeEngine(params, cfg, slots=SLOTS,
                                    n_pages=N_PAGES, page=PAGE,
                                    max_pages_per_seq=MAX_PAGES, chunk=CHUNK,
                                    journal=journal, device=device, **extra)
            for _ in range(SLOTS):
                rid = eng.submit(prompt, JOURNAL_BUDGET)
                if journal is not None:
                    journal.submit(rid, rid, prompt, JOURNAL_BUDGET)
            while eng.pending or any(r is None or r.n_prefilled
                                     < len(r.prompt) for r in eng.slots):
                eng.step()
            for _ in range(2):
                eng.step()
            engs[(name, on)] = eng
    fsyncs = {k: 0 for k in engs}
    fsync_s = {k: 0.0 for k in engs}
    steps = {k: 0 for k in engs}
    real_fsync = os.fsync

    def tick_ms(k):
        eng = engs[k]

        def counting(fd):
            t0 = time.perf_counter()
            real_fsync(fd)
            fsync_s[k] += time.perf_counter() - t0
            fsyncs[k] += 1

        before = sum(len(r.tokens) for r in eng.slots)
        with mock.patch.object(os, "fsync", counting):
            ms = host_ms(lambda: [eng.step() for _ in range(n_steps)],
                         repeats=1)
        steps[k] += n_steps
        return ms * SLOTS / (sum(len(r.tokens) for r in eng.slots) - before)

    times = {k: [] for k in engs}
    for name in ("sync", "k4"):
        for on in (False, True, True, False):
            times[(name, on)].append(tick_ms((name, on)))
    out = {}
    for (name, on), t in times.items():
        tag = f"{name}_{'journal' if on else 'plain'}"
        n = fsyncs[(name, on)]
        out[tag] = dict(tick_ms=sum(t) / len(t), turns=t, fsyncs=n,
                        steps=steps[(name, on)],
                        fsync_ms=fsync_s[(name, on)] * 1e3 / n if n else 0.0)
        assert (fsyncs[(name, on)] == steps[(name, on)]) if on else \
            fsyncs[(name, on)] == 0, (tag, fsyncs, steps)
        assert engs[(name, on)].live == SLOTS
    for eng in engs.values():
        eng.drain()
        assert eng.pool.available == N_PAGES - 1
        if eng.journal is not None:
            eng.journal.close()
    return out


def checkpoint_phase(device):
    """The checkpoint phase (after the speculative one): snapshot round
    trips of four engines (ServeEngine, the synchronous and the pipelined
    RaggedServeEngine, the ragged prefix wave) and the two synchronous
    engines' crash recoveries, in bf16; then the journal's cost
    on the ragged decode tick, synchronous and pipelined.  Returns its
    results, with the bf16 runs' launches of kernels 1, 6 and 7 summed
    under "launches"."""
    import torch

    t0 = time.perf_counter()
    res = {}
    launches = {"flash_fwd": 0, "paged_decode_attention": 0,
                "ragged_paged_attention": 0}
    # bf16 only: the fp32 recoveries (token-exact journal-only recovery of
    # both engines, the pipelined and prefix-cache recoveries) are the
    # fuzz phase's, at the same width on 2 layers
    dtype = torch.bfloat16
    for kind in ("ServeEngine", "ragged", "pipelined", "prefix"):
        r = checkpoint_run(kind, dtype, device)
        res[f"{kind}_{_dtype_key(dtype)}"] = r
        runs = [r["launches"]["roundtrip"]] + [
            r[k]["launches"] for k in ("snapshot_recovery",
                                       "journal_recovery") if k in r]
        for run in runs:
            for name, n in run.items():
                launches[name] += n
    torch.cuda.empty_cache()
    res["ticks"] = jt = journal_ticks(device)
    print("journal cost, bf16 decode tick (8 slots at ~2K), ms a tick "
          "(mean of two turns) without / with a TokenJournal: synchronous "
          f"{jt['sync_plain']['tick_ms']:.3f} / "
          f"{jt['sync_journal']['tick_ms']:.3f}, K={K_PIPE} "
          f"{jt['k4_plain']['tick_ms']:.3f} / "
          f"{jt['k4_journal']['tick_ms']:.3f}; fsyncs "
          f"{jt['sync_journal']['fsyncs']} in "
          f"{jt['sync_journal']['steps']} steps "
          f"({jt['sync_journal']['fsync_ms']:.3f} ms each), "
          f"{jt['k4_journal']['fsyncs']} in {jt['k4_journal']['steps']} "
          f"({jt['k4_journal']['fsync_ms']:.3f} ms each)", flush=True)
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    print(f"checkpoint phase: {res['seconds']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# packed documents: the SEG instances of kernels 1-5, 8 and 9 against their
# plain versions and their times, the packed train step on one device and
# on the ring, and runner.fit with packed_eos_id

# the instances without SEG keep the registers and local (spill) bytes a
# thread they had before the SEG flag existed (PERF.md, row by row)
NO_SEG_ATTRS = {
    "flash_fwd": {"bf16": (168, 0), "bf16 window": (178, 0)},
    "flash_bwd": {"bf16 fused": (255, 8), "bf16 dq": (242, 0),
                  "bf16 dkdv": (242, 0)},
    "fused_ring_fwd": {"bf16": (174, 0), "bf16 scratch": (176, 0)},
    "fused_ring_bwd": {"bf16": (255, 32)},
}
SEG_DOC_LEN = 512  # the second timed id pattern: documents of 512 tokens
PACKED_SEED = 1    # make_packed_batch's seed for the packed train steps
PACKED_STEPS = 2   # timed packed train steps, after a warm-up
# kernel 1 with segments: (name, heads, kv heads, Sq, Skv, causal, window);
# cross lengths take ids of their own on each side, some q ids on no kv
# row (rows that see nothing: lse -inf, o 0)
SEG_FLASH_CASES = (
    ("MHA causal", 16, 16, 2048, 2048, True, None),
    ("GQA causal", 16, 4, 2048, 2048, True, None),
    ("GQA non-causal", 16, 4, 2048, 2048, False, None),
    ("cross lengths", 16, 4, 1000, 2048, False, None),
    ("window 1024", 16, 4, 2048, 2048, True, 1024))
# kernels 8 and 9 with segments: (positions, layout, causal, heads, kv
# heads, local S, dtype, knobs, ids: "packed" = eight seeded documents,
# "docs" = documents of SEG_RING_DOC tokens, within the truncation's
# promise)
SEG_RING_DOC = 500
SEG_RING_CASES = (
    (4, "zigzag", True, 8, 2, 512, "bf16", {}, "packed"),
    (4, "striped", True, 8, 2, 512, "fp32", {}, "packed"),
    (4, "contig", True, 8, 2, 512, "bf16", {}, "packed"),
    (4, "zigzag", True, 8, 2, 512, "bf16", dict(two_axis=(2, 2)), "packed"),
    (3, "zigzag", False, 8, 8, 384, "fp32", {}, "packed"),
    (4, "contig", True, 8, 2, 512, "bf16", dict(max_segment_len=600),
     "docs"),
    (4, "contig", True, 8, 2, 512, "fp32", dict(max_segment_len=600),
     "docs"))


def _packed_ids(seed, b, s, n_docs):
    """[b, s] int32 document ids, monotone from 0: n_docs documents a row
    at boundaries drawn from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    starts = np.zeros((b, s), np.int32)
    for i in range(b):
        starts[i, rng.choice(np.arange(1, s), n_docs - 1, replace=False)] = 1
    return np.cumsum(starts, axis=1).astype(np.int32)


def _seg_patterns(s):
    """The two id patterns timed at s tokens (natural order, [1, s]
    int32): the ids of make_packed_batch's seeded stream (EOS at rate
    4 / s: about four documents) and documents of SEG_DOC_LEN tokens,
    which put a boundary in most 64-token chunks."""
    import numpy as np

    from burst_attn_tpu_torch.models import train

    toks = train.packed_tokens(PACKED_SEED, TRAIN_DIMS["vocab"], 1, s)
    return {"packed": train.packed_fields_np(toks, 0)[0],
            f"docs{SEG_DOC_LEN}": (np.arange(s)[None] // SEG_DOC_LEN).astype(
                np.int32)}


def _live_pairs(ids, causal=True):
    """The (query, key) pairs a packed mask leaves over natural-order ids
    [B, S]: per document of c tokens c (c + 1) / 2 causal (c^2 not), the
    same pairs whatever implements them or rotates them on a ring."""
    import numpy as np

    total = 0
    for row in np.asarray(ids):
        c = np.unique(row, return_counts=True)[1].astype(np.int64)
        total += int((c * (c + 1) // 2).sum() if causal else (c * c).sum())
    return total


def _seg_mask(ids, causal=True):
    """The boolean [B, 1, S, S] mask of SDPA for natural-order ids: causal
    and the same document."""
    import torch

    s = ids.shape[1]
    m = ids[:, None, :, None] == ids[:, None, None, :]
    if causal:
        m = m & torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
    return m


def _stats_close(what, got, want, key):
    """m / lse within STATS_ATOL (-inf where a row sees nothing, on both
    sides); returns the largest finite error."""
    import torch

    torch.testing.assert_close(got, want, atol=STATS_ATOL[key], rtol=0,
                               msg=lambda m: f"{what}: {m}")
    fin = torch.isfinite(want)
    return _max_err(got[fin], want[fin])


def check_flash_segments(device):
    """Kernels 1-5's SEG instances against their plain versions (tile_fwd,
    tile_bwd with segments) on the card, bf16 and fp32, SEG_FLASH_CASES
    for the forward (with a carry-in round on the first), the first four
    for the fused backward and the split pair; each launched twice,
    torch.equal; one segment covering every row gives bitwise the output
    of the instances without SEG.  Returns the largest errors {"fwd": o,
    "fused": (dq, dk, dv), "split": (...)}."""
    import torch

    from burst_attn_tpu_torch.ops import flash, masks, tile

    worst = {"fwd": 0.0, "fused": [0.0] * 3, "split": [0.0] * 3}
    for dtype in (torch.float32, torch.bfloat16):
        key = _dtype_key(dtype)
        for ci, (name, n, n_kv, s_q, s_kv, causal, window) in enumerate(
                SEG_FLASH_CASES):
            g = torch.Generator(device=device).manual_seed(40 + ci)
            q, do = (torch.randn(1, n, s_q, 128, generator=g,
                                 device=device).to(dtype) for _ in range(2))
            k, v = (torch.randn(1, n_kv, s_kv, 128, generator=g,
                                device=device).to(dtype) for _ in range(2))
            if s_q == s_kv:
                ids = torch.from_numpy(_packed_ids(40 + ci, 1, s_q, 8)).to(
                    device)
                segs = (ids, ids)
            else:
                segs = tuple(torch.from_numpy(_packed_ids(
                    40 + ci + j, 1, sl, nd)).to(device)
                    for j, (sl, nd) in enumerate(((s_q, 6), (s_kv, 4))))
            spec = masks.round_spec(0, 0, s_q, s_kv, causal, "contig")
            what = f"{key} {name} N{n}/{n_kv} Sq {s_q} Skv {s_kv}"
            m, lse, o = flash.flash_fwd(q, k, v, None, None, None,
                                        128**-0.5, spec, window=window,
                                        segments=segs, emit_o=True)
            again = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5,
                                    spec, window=window, segments=segs,
                                    emit_o=True)
            assert all(torch.equal(a, b) for a, b in zip((m, lse, o),
                                                         again)), what
            st = tile.tile_fwd(q, k, v, *tile.init_state(
                1, n, s_q, 128, device=device), 128**-0.5, spec,
                window=window, segments=segs)
            err = _check_o(f"flash_fwd[seg] {what}", o,
                           tile.finalize(*st, dtype), dtype)
            _stats_close(f"flash_fwd[seg] {what} m", m, st[0], key)
            _stats_close(f"flash_fwd[seg] {what} lse", lse, st[1], key)
            worst["fwd"] = max(worst["fwd"], err)
            if ci == 0:  # a carry-in round, and one segment = no segments
                got = flash.flash_fwd(q, k, v, *st, 128**-0.5, spec,
                                      segments=segs)
                want = tile.tile_fwd(q, k, v, *st, 128**-0.5, spec,
                                     segments=segs)
                acc_err = _max_err(got[2], want[2])
                assert acc_err <= ACC_RTOL * float(want[2].abs().max()), \
                    (what, acc_err)
                one = torch.zeros_like(segs[0])
                for emit in (True, False):
                    a = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5,
                                        spec, segments=(one, one),
                                        emit_o=emit)
                    b = flash.flash_fwd(q, k, v, None, None, None, 128**-0.5,
                                        spec, emit_o=emit)
                    assert all(torch.equal(x, y) for x, y in zip(a, b)), \
                        f"flash_fwd one segment {key} emit_o={emit}"
            print(f"flash_fwd[seg] {what}"
                  f"{f' window {window}' if window else ''}: max_abs_err="
                  f"{err:.3e} (tolerance {O_TOL[key]}), two launches equal"
                  f"{'; carry-in round and one segment = unsegmented' if ci == 0 else ''}",
                  flush=True)
            del st
            if window is not None:
                continue
            delta = (o.float() * do.float()).sum(-1)
            args = (do, q, k, v, delta, lse, 128**-0.5, spec)
            want = tile.tile_bwd(*args, segments=segs)
            for fused in (None, False):
                route = "split" if fused is False else "fused"
                got = flash.flash_bwd(*args, fused=fused, segments=segs)
                again = flash.flash_bwd(*args, fused=fused, segments=segs)
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    (what, route)
                errs = _bwd_errs(got, want, f"flash_bwd[seg] {what} {route}")
                worst[route] = [max(a, b) for a, b in zip(worst[route],
                                                          errs)]
                if ci == 0:
                    one = torch.zeros_like(segs[0])
                    a = flash.flash_bwd(*args, fused=fused,
                                        segments=(one, one))
                    b = flash.flash_bwd(*args, fused=fused)
                    assert all(torch.equal(x, y) for x, y in zip(a, b)), \
                        f"flash_bwd one segment {key} {route}"
                print(f"flash_bwd[seg] {what} {route}: max_abs_err dq "
                      f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}, two "
                      f"launches equal"
                      f"{'; one segment = unsegmented' if ci == 0 else ''}",
                      flush=True)
            del want, got, again, args
    torch.cuda.empty_cache()
    return worst


def _seg_ring_case(device, case, seed):
    """(cfg, ring, (q, k, v, o, lse, do) stacked, seg [W, 1, S_local],
    bwd program, tables) of one SEG_RING_CASES case: o and lse from
    kernel 8's SEG instance."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.ops import fused_ring
    from burst_attn_tpu_torch.parallel import layouts, mesh

    w, layout, causal, n, n_kv, s, key, knobs, pattern = case
    cfg, ring, args, prog, tables = _fused_bwd_setup(
        device, (w, layout, causal, n, n_kv, s, key, knobs), seed)
    ids = (_packed_ids(seed, 1, w * s, 8) if pattern == "packed"
           else (np.arange(w * s)[None] // SEG_RING_DOC).astype(np.int32))
    seg = mesh.shard(layouts.to_layout(torch.from_numpy(ids), layout, w,
                                       axis=1).to(device), w, dim=1)
    q, k, v, _, _, do = args
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
    return cfg, ring, (q, k, v, o, lse, do), seg, prog, tables


def check_ring_segments(device):
    """Kernels 8 and 9's SEG instances against fused_ring_reference and
    fused_ring_bwd_reference with the same ids (SEG_RING_CASES: zigzag,
    striped and contig, the double ring, non-causal, a contig program
    truncated by max_segment_len whose ids keep the promise, which must
    also give the untruncated ring's o and gradients); each launched
    twice, torch.equal; on the first case one segment gives bitwise the
    instances without SEG.  Returns the largest errors (kernel 8's o,
    kernel 9's of dq, dk, dv)."""
    import dataclasses

    import torch

    from burst_attn_tpu_torch.ops import fused_ring, fused_ring_bwd

    k8_err, k9_err = 0.0, 0.0
    for ci, case in enumerate(SEG_RING_CASES):
        w, layout, causal, n, n_kv, s, key, knobs, pattern = case
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[key]
        cfg, ring, args, seg, prog, tables = _seg_ring_case(device, case,
                                                            seed=60 + ci)
        q, k, v, o, lse, do = args
        what = (f"{key} W={w} {layout} {'causal' if causal else 'full'} "
                f"N{n}/{n_kv} S_local {s} {knobs or ''} ids {pattern}")
        again = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse), what
        fprog, ftables, _ = fused_ring.ring_plan(cfg, *ring, s, "fwd")
        po, plse = fused_ring.fused_ring_reference(q, k, v, fprog, ftables,
                                                   128 ** -0.5, seg=seg)
        err8 = _check_o(f"fused_ring_fwd[seg] {what}", o, po, dtype)
        _stats_close(f"fused_ring_fwd[seg] {what} lse", lse, plse, key)
        got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
        again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), what
        want = fused_ring_bwd.fused_ring_bwd_reference(
            *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm,
            seg=seg)
        errs = _bwd_errs(got, want, f"fused_ring_bwd[seg] {what}")
        note = ""
        if ci == 0:
            one = torch.zeros_like(seg)
            a = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=one)
            b = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), what
            a = fused_ring_bwd.fused_ring_bwd(q, k, v, *b, do, cfg, *ring,
                                              seg=one)
            b = fused_ring_bwd.fused_ring_bwd(q, k, v, *b, do, cfg, *ring)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), what
            note = "; one segment = unsegmented"
        if cfg.max_segment_len is not None:
            assert prog.n_rounds < w and fprog.n_rounds < w, what
            full = dataclasses.replace(cfg, max_segment_len=None)
            fo, flse = fused_ring.fused_ring_fwd(q, k, v, full, *ring,
                                                 seg=seg)
            _check_o(f"truncated vs full {what}", o, fo, dtype)
            _stats_close(f"truncated vs full {what} lse", lse, flse, key)
            fgot = fused_ring_bwd.fused_ring_bwd(q, k, v, fo, flse, do, full,
                                                 *ring, seg=seg)
            _bwd_errs(got, fgot, f"truncated vs full {what}")
            note += (f"; {fprog.n_rounds} + {prog.n_rounds} rounds of {w} "
                     "give the untruncated ring's o and gradients")
        k8_err, k9_err = max(k8_err, err8), max(k9_err, *errs)
        print(f"fused_ring[seg] {what}: kernel 8 max_abs_err {err8:.3e}, "
              f"kernel 9 dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}"
              f"; two launches equal{note}", flush=True)
        del args, got, again, want
    torch.cuda.empty_cache()
    return k8_err, k9_err


def time_flash_segments(device, worst):
    """Kernels 1-5's SEG instances at the train step's shape (B1 N16/16
    S8192 D128 bf16 causal), on the two id patterns of _seg_patterns:
    kernel 1 through flash_attention, the fused backward and the split
    pair (each split kernel's device time by the profiler); the same
    calls without segments in the same run; the plain versions (tile_fwd,
    tile_bwd with segments; packed ids) and SDPA with the boolean mask
    (causal and the same document), forward and backward.  The kernels
    are held to the plain versions on the packed ids (the fused and split
    backward, two launches each bitwise).  Bound: the pairs the ids leave
    (_live_pairs), the unsegmented rows' bytes plus the ids.  Returns the
    kernels-line records flash_fwd[seg], flash_bwd_fused[seg],
    flash_bwd_dq[seg] and flash_bwd_dkdv[seg]."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash, masks, tile

    n, s, d = TRAIN_DIMS["n_heads"], TRAIN_SEQ, TRAIN_DIMS["d_head"]
    g = torch.Generator(device=device).manual_seed(31)
    q, k, v, do = (torch.randn(1, n, s, d, generator=g, device=device).to(
        torch.bfloat16) for _ in range(4))
    spec = masks.round_spec(0, 0, s, s, True, "contig")
    esz = q.element_size()
    t = {}  # (pattern or "none", kernel) -> ms
    out = {}
    for pattern, ids_np in [("none", None)] + list(_seg_patterns(s).items()):
        ids = None if ids_np is None else torch.from_numpy(ids_np).to(device)
        segs = None if ids is None else (ids, ids)
        t[pattern, "fwd"] = time_ms(lambda: flash.flash_attention(
            q, k, v, None, True, segment_ids=ids), iters=10, warmup=2)
        _, lse, o = flash.flash_fwd(q, k, v, None, None, None, d**-0.5, spec,
                                    segments=segs, emit_o=True)
        delta = (o.float() * do.float()).sum(-1)
        args = (do, q, k, v, delta, lse, d**-0.5, spec)
        if pattern == "packed":  # the kernels against the plain versions
            st = tile.tile_fwd(q, k, v, *tile.init_state(1, n, s, d,
                                                         device=device),
                               d**-0.5, spec, segments=segs)
            fwd_err = _check_o("flash_fwd[seg] train shape", o,
                               tile.finalize(*st, q.dtype), q.dtype)
            worst["fwd"] = max(worst["fwd"], fwd_err)
            del st
            want = tile.tile_bwd(*args, segments=segs)
            for fused in (None, False):
                route = "split" if fused is False else "fused"
                got = flash.flash_bwd(*args, fused=fused, segments=segs)
                again = flash.flash_bwd(*args, fused=fused, segments=segs)
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    route
                errs = _bwd_errs(got, want,
                                 f"flash_bwd[seg] train shape {route}")
                worst[route] = [max(a, b) for a, b in zip(worst[route],
                                                          errs)]
                del got, again
            del want
            torch.cuda.empty_cache()
            t[pattern, "plain_fwd"] = time_ms(lambda: tile.finalize(
                *tile.tile_fwd(q, k, v, *tile.init_state(
                    1, n, s, d, device=device), d**-0.5, spec,
                    segments=segs), q.dtype), iters=2, warmup=1)
            t[pattern, "plain_bwd"] = time_ms(lambda: tile.tile_bwd(
                *args, segments=segs), iters=2, warmup=1)
            torch.cuda.empty_cache()
        t[pattern, "fused"] = time_ms(lambda: flash.flash_bwd(
            *args, segments=segs), iters=5, warmup=1)
        t[pattern, "split"] = time_ms(lambda: flash.flash_bwd(
            *args, fused=False, segments=segs), iters=3, warmup=1)
        # each split kernel's ms: the pair's CUDA-event ms split by the
        # profiler's shares (in this phase the profiler's own per-call
        # sums came to ~2/3 of the pair's event time)
        _, _, top = device_breakdown(lambda: flash.flash_bwd(
            *args, fused=False, segments=segs), 3, top=4)
        dq_p = sum(x for name, x in top if "flash_bwd_dq_mma_kernel" in name)
        dkdv_p = sum(x for name, x in top
                     if "flash_bwd_dkdv_mma_kernel" in name)
        assert dq_p > 0 and dkdv_p > 0, top
        t[pattern, "dq"] = t[pattern, "split"] * dq_p / (dq_p + dkdv_p)
        t[pattern, "dkdv"] = t[pattern, "split"] * dkdv_p / (dq_p + dkdv_p)
        t[pattern, "profiler"] = (dq_p, dkdv_p)
        if ids is not None:
            mask = _seg_mask(ids)
            t[pattern, "lib_fwd"] = time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       attn_mask=mask),
                iters=5, warmup=2)
            qr, kr, vr = (x.detach().clone().requires_grad_()
                          for x in (q, k, v))
            lo = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)
            t[pattern, "lib_bwd"] = time_ms(lambda: torch.autograd.grad(
                lo, (qr, kr, vr), do, retain_graph=True), iters=5, warmup=1)
            del lo, qr, kr, vr, mask
            out[pattern] = _live_pairs(ids_np)
        del args, o, lse, delta
        torch.cuda.empty_cache()
    pats = [p for p in out]
    print(f"SEG kernels at the train shape B1 N{n}/{n} S{s} D{d} bf16 "
          "causal, ms (no segments / " + " / ".join(
              f"{p} ({out[p] / (s * (s + 1) // 2):.3f} of the causal pairs)"
              for p in pats) + "): " + "; ".join(
              f"{kern} " + " / ".join(f"{t[p, kern]:.4f}"
                                      for p in ["none"] + pats)
              for kern in ("fwd", "fused", "split", "dq", "dkdv"))
          + " (split: the pair's CUDA-event ms, dq and dkdv its shares by "
          "the profiler, whose own ms were " + " / ".join(
              f"{t[p, 'profiler'][0]:.4f} + {t[p, 'profiler'][1]:.4f}"
              for p in ["none"] + pats) + "); SDPA with "
          "the mask fwd " + " / ".join(f"{t[p, 'lib_fwd']:.4f}" for p in pats)
          + ", bwd " + " / ".join(f"{t[p, 'lib_bwd']:.4f}" for p in pats)
          + f"; plain (packed) fwd {t['packed', 'plain_fwd']:.3f}, bwd "
          f"{t['packed', 'plain_bwd']:.3f}", flush=True)
    ids_bytes = 4 * 2 * s
    recs = []
    for name, kern, lib, src, rep_, reads, written, matmuls, err in (
            ("flash_fwd[seg]", "fwd", "lib_fwd", "flash_fwd.cu",
             "burst_attn_tpu/ops/pallas_flash.py:419 (_fwd_kernel, segments)",
             esz * 3 * q.numel(), esz * q.numel() + 4 * n * s, 2,
             worst["fwd"]),
            ("flash_bwd_fused[seg]", "fused", "lib_bwd", "flash_bwd.cu",
             "burst_attn_tpu/ops/pallas_flash.py:1127 (_bwd_fused_kernel, "
             "segments)", esz * 4 * q.numel() + 4 * 2 * n * s,
             4 * 3 * q.numel(), 5, max(worst["fused"])),
            ("flash_bwd_dq[seg]", "dq", None, "flash_bwd.cu",
             "burst_attn_tpu/ops/pallas_flash.py:865 (_dq_kernel, segments)",
             esz * 4 * q.numel() + 4 * 2 * n * s, 4 * q.numel(), 3,
             worst["split"][0]),
            ("flash_bwd_dkdv[seg]", "dkdv", None, "flash_bwd.cu",
             "burst_attn_tpu/ops/pallas_flash.py:945 (_dkdv_kernel, "
             "segments)", esz * 4 * q.numel() + 4 * 2 * n * s,
             4 * 2 * q.numel(), 4, max(worst["split"][1:]))):
        bounds = {p: bound_ms(reads + written + ids_bytes,
                              matmuls * 2 * out[p] * n * d) for p in pats}
        plain = t["packed", "plain_fwd" if kern == "fwd" else "plain_bwd"]
        recs.append(dict(
            name=name, route="cuda",
            source=f"burst_attn_tpu_torch/csrc/{src}", replaces=rep_,
            max_abs_err=err, ms=t["packed", kern], plain_ms=plain,
            bound_ms=bounds["packed"][0], bound_by=bounds["packed"][1],
            library_ms=t["packed", lib] if lib else None,
            seg={"shape": f"B1 N{n}/{n} S{s} D{d} bf16 causal",
                 "ms_unsegmented": t["none", kern],
                 **{p: {"ms": t[p, kern], "bound_ms": bounds[p][0],
                        "bound_by": bounds[p][1], "live_pairs": out[p],
                        "library_ms": t[p, lib] if lib else None}
                    for p in pats}}))
    for rec in recs[2:]:  # the split pair's CUDA-event time, the profiler
        rec["seg"]["split_pair_ms"] = {p: t[p, "split"]
                                       for p in ["none"] + pats}
        rec["seg"]["profiler_ms"] = {p: t[p, "profiler"]
                                     for p in ["none"] + pats}
    return recs


def time_ring_segments(device, lib):
    """Kernels 8 and 9's SEG instances at the ring train step's shape (W=4,
    B1 N16/16 S_local 2048 D128 bf16 causal zigzag) on the two id patterns
    (in layout order), beside the same launches without segments, each
    held to its plain version with the packed ids (two launches equal);
    the plain versions' host-timed walk; `lib`: SDPA with the mask at the
    same global shape (B1 N16 S8192, natural order: time_flash_segments'
    {pattern: (fwd ms, bwd ms)}).  Bound: the pairs the ids leave, the
    unsegmented rows' bytes (ring_op_phase's for kernel 8, _bwd_bound's
    for kernel 9) plus the ids.  Returns the kernels-line records
    fused_ring_fwd[seg] and fused_ring_bwd[seg]."""
    import torch

    from burst_attn_tpu_torch.ops import fused_ring, fused_ring_bwd
    from burst_attn_tpu_torch.parallel import layouts, mesh

    w, n, s_loc = RING_TRAIN_SP, TRAIN_DIMS["n_heads"], TRAIN_SEQ // \
        RING_TRAIN_SP
    d, b = TRAIN_DIMS["d_head"], 1
    cfg, ring, args, prog, tables = _fused_bwd_setup(
        device, (w, "zigzag", True, n, n, s_loc, "bf16", {}), seed=33)
    q, k, v, _, _, do = args
    fprog = fused_ring.ring_plan(cfg, *ring, s_loc, "fwd")[0]
    t, pairs, errs = {}, {}, {}
    for pattern, ids_np in [("none", None)] + list(
            _seg_patterns(TRAIN_SEQ).items()):
        seg = None
        if ids_np is not None:
            seg = mesh.shard(layouts.to_layout(torch.from_numpy(ids_np),
                                               "zigzag", w, axis=1).to(device),
                             w, dim=1)
            pairs[pattern] = _live_pairs(ids_np)
        o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
        bargs = (q, k, v, o, lse, do)
        if pattern == "packed":
            again = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
            assert torch.equal(again[0], o) and torch.equal(again[1], lse)
            t0 = time.perf_counter()
            po, _ = fused_ring.fused_ring_reference(
                q, k, v, fprog, fused_ring.ring_plan(cfg, *ring, s_loc,
                                                     "fwd")[1],
                128 ** -0.5, seg=seg)
            torch.cuda.synchronize()
            t["plain_fwd"] = (time.perf_counter() - t0) * 1e3
            errs["k8"] = _check_o("fused_ring_fwd[seg] ring step shape", o,
                                  po, torch.bfloat16)
            del po, again
            got = fused_ring_bwd.fused_ring_bwd(*bargs, cfg, *ring, seg=seg)
            again = fused_ring_bwd.fused_ring_bwd(*bargs, cfg, *ring,
                                                  seg=seg)
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            t0 = time.perf_counter()
            want = fused_ring_bwd.fused_ring_bwd_reference(
                *bargs, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm,
                seg=seg)
            torch.cuda.synchronize()
            t["plain_bwd"] = (time.perf_counter() - t0) * 1e3
            errs["k9"] = max(_bwd_errs(got, want,
                                       "fused_ring_bwd[seg] ring step shape"))
            del got, again, want
            torch.cuda.empty_cache()
        t[pattern, "k8"] = time_ms(lambda: fused_ring.fused_ring_fwd(
            q, k, v, cfg, *ring, seg=seg), iters=10, warmup=2)
        t[pattern, "k9"] = time_ms(lambda: fused_ring_bwd.fused_ring_bwd(
            *bargs, cfg, *ring, seg=seg), iters=10, warmup=2)
        del o, lse, bargs
    pats = list(pairs)
    chunk = 2 * b * n * s_loc * d * 2  # K and V of one position, bf16
    copies = w * (sum(fprog.rows["send0"]) + sum(fprog.rows["send1"])
                  + len(fprog.copy_in))
    ids_bytes = 4 * b * TRAIN_SEQ
    k8_bytes = (2 * (4 * b * n * TRAIN_SEQ * d) + 4 * b * n * TRAIN_SEQ
                + 2 * copies * chunk + ids_bytes)
    bounds = {}
    for p in pats:
        bounds["k8", p] = bound_ms(k8_bytes, 4 * d * b * n * pairs[p])
        bounds["k9", p] = _bwd_bound(tables, prog, b, n, n, s_loc, d, 2,
                                     pairs=pairs[p] * b * n,
                                     extra_bytes=ids_bytes)[:2]
    print(f"SEG kernels 8 and 9 at the ring step's shape (W={w} B1 "
          f"N{n}/{n} S_local {s_loc} bf16 causal zigzag), ms a launch (no "
          "segments / " + " / ".join(pats) + "): kernel 8 " + " / ".join(
              f"{t[p, 'k8']:.4f}" for p in ["none"] + pats) + ", kernel 9 "
          + " / ".join(f"{t[p, 'k9']:.4f}" for p in ["none"] + pats)
          + f"; plain versions (packed) {t['plain_fwd']:.0f} / "
          f"{t['plain_bwd']:.0f} ms; max_abs_err {errs}", flush=True)
    recs = []
    for name, kern, src, rep_, li in (
            ("fused_ring_fwd[seg]", "k8", "fused_ring_fwd.cu",
             "burst_attn_tpu/ops/fused_ring.py:1049 (_fused_fwd_kernel, "
             "has_seg)", 0),
            ("fused_ring_bwd[seg]", "k9", "fused_ring_bwd.cu",
             "burst_attn_tpu/ops/fused_ring_bwd.py:1087 (_fused_bwd_kernel, "
             "has_seg)", 1)):
        recs.append(dict(
            name=name, route="cuda",
            source=f"burst_attn_tpu_torch/csrc/{src}", replaces=rep_,
            max_abs_err=errs[kern], ms=t["packed", kern],
            plain_ms=t["plain_fwd" if kern == "k8" else "plain_bwd"],
            bound_ms=bounds[kern, "packed"][0],
            bound_by=bounds[kern, "packed"][1], library_ms=lib["packed"][li],
            seg={"shape": f"W={w} B1 N{n}/{n} S_local {s_loc} D{d} bf16 "
                          "causal zigzag (the ring train step's)",
                 "ms_unsegmented": t["none", kern],
                 **{p: {"ms": t[p, kern], "bound_ms": bounds[kern, p][0],
                        "bound_by": bounds[kern, p][1],
                        "live_pairs": pairs[p],
                        "library_ms": lib[p][li]} for p in pats}}))
    del args, q, k, v, do
    torch.cuda.empty_cache()
    return recs


def _train_run(step, state, batch, n_steps):
    """(losses, grad norms, host ms per step, launches) of n_steps steps
    of `step` on `batch`, the launch counters set to 0 before."""
    import torch

    _reset_counts()
    losses, norms, times = [], [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state[0], batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return losses, norms, times, _counts()


def packed_train_phase(device):
    """The packed train step: make_train_step on make_packed_batch(
    PACKED_SEED) at train_smoke's width and depth (bf16, remat, B=1,
    S=TRAIN_SEQ, the seed-0 weights of the train phase): a warm-up and
    PACKED_STEPS timed steps, exactly 2 SEG forward launches and one SEG
    fused backward a layer and step and nothing else, the loss finite and
    falling; one step through the split backward (the SEG dq and dk/dv
    kernels); the control from the same seed with plain attention under
    the same segment mask, whose first two losses must be within
    CONTROL_RTOL.  Then, fp32 at 2 layers: document isolation (the logits
    of document B inside a packed row equal B's alone within 1e-5 of the
    largest logit: fp32 summation order, the packed row's 64-token chunks
    cut B at other columns than B's own) and
    one step's loss and gradients, kernels against plain attention,
    within LOSS_RTOL and GRAD_RTOL."""
    import statistics

    import numpy as np
    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import (
        LAYER_KEYS, forward_with_aux, init_params, param_leaves,
    )

    cfg = _train_model(TRAIN_DIMS["n_layers"], torch.bfloat16)
    tcfg = train.TrainConfig()
    n_layers = cfg.n_layers
    state = [_seed_state(cfg, tcfg, device)]
    batch = train.make_packed_batch(PACKED_SEED, cfg, batch=1, seq=TRAIN_SEQ,
                                    device=device)
    docs = int(batch["segment_ids"].max()) + 1
    step = train.make_train_step(cfg, tcfg, device=device)
    warm = _train_run(step, state, batch, 1)
    losses, norms, times, launches = _train_run(step, state, batch,
                                                PACKED_STEPS)
    per = dict(flash_fwd=2 * n_layers * PACKED_STEPS,
               fused=n_layers * PACKED_STEPS)
    want = _launches(**per, **{f"{k}_seg": x for k, x in per.items()})
    assert launches == want, (launches, want)
    losses = warm[0] + losses
    assert all(map(math.isfinite, losses + norms)), losses
    assert losses[-1] < losses[0], f"packed loss did not fall: {losses}"
    with split_train_backward():
        s_losses, _, s_times, s_launches = _train_run(step, state, batch, 1)
    per = dict(flash_fwd=2 * n_layers, dq=n_layers, dkdv=n_layers)
    want = _launches(**per, **{f"{k}_seg": x for k, x in per.items()})
    assert s_launches == want, (s_launches, want)
    assert all(map(math.isfinite, s_losses)), s_losses
    step_ms = statistics.median(times)
    res = dict(seq=TRAIN_SEQ, documents=docs, losses=losses, step_ms=step_ms,
               step_ms_all=times, tokens_per_s=TRAIN_SEQ / (step_ms / 1e3),
               launches=launches,
               launches_per_step={k: x // PACKED_STEPS
                                  for k, x in launches.items() if x},
               split_launches=s_launches, split_step_ms=s_times[0],
               prof=device_breakdown(lambda: step(state[0], batch), 1,
                                     top=8))
    state[0] = None
    torch.cuda.empty_cache()
    state[0] = _seed_state(cfg, tcfg, device)
    with plain_train_attention():
        c_losses, _, c_times, c_launches = _train_run(step, state, batch, 2)
    assert sum(c_launches.values()) == 0, c_launches
    state[0] = None
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses, c_losses)]
    assert max(diffs[:2]) <= CONTROL_RTOL, (losses, c_losses)
    res.update(control_losses=c_losses, control_rel_diffs=diffs[:2],
               control_step_ms=c_times[-1])
    print(f"packed train step (bf16, remat, B=1 S={TRAIN_SEQ}, {docs} "
          f"documents, make_packed_batch seed {PACKED_SEED}): {step_ms:.1f} "
          f"ms (median of {PACKED_STEPS}: {[round(x, 1) for x in times]}), "
          f"{res['tokens_per_s']:.0f} tokens/s; losses "
          f"{[round(x, 4) for x in losses]}; launches per step "
          f"{res['launches_per_step']}; split backward {s_times[0]:.1f} ms "
          f"{s_launches}; control with plain attention under the mask "
          f"{[round(x, 4) for x in c_losses]} (rel diffs "
          f"{[float(f'{x:.2e}') for x in diffs[:2]]})", flush=True)
    print_profile("packed train step", res["prof"])
    res["prof"] = res["prof"][:2]  # wall and device ms for the JSON line
    torch.cuda.empty_cache()

    # fp32 at 2 layers: document isolation, then loss and gradient parity
    cfg32 = _train_model(2, torch.float32)
    params = init_params(cfg32, seed=0, device=device)
    a, bl = 700, 2048 - 700
    rng = np.random.default_rng(7)
    doc_a = rng.integers(1, cfg32.vocab, (1, a))
    doc_b = rng.integers(1, cfg32.vocab, (1, bl))

    def logits(tokens, lens):
        seg = np.concatenate([np.full((1, x), i) for i, x in enumerate(lens)],
                             1)
        pos = np.concatenate([np.arange(x)[None] for x in lens], 1)
        with torch.no_grad():
            return forward_with_aux(
                params, torch.from_numpy(tokens).to(device),
                torch.from_numpy(pos).to(device), cfg32,
                segment_ids=torch.from_numpy(seg).to(device))[0]

    _reset_counts()
    packed = logits(np.concatenate([doc_a, doc_b], 1), (a, bl))
    solo = logits(np.concatenate([doc_b, np.zeros((1, a), np.int64)], 1),
                  (bl, a))
    iso = _counts()
    assert iso["flash_fwd"] == iso["flash_fwd_seg"] == 2 * 2, iso
    iso_err = _max_err(packed[:, a:], solo[:, :bl])
    iso_ref = float(solo[:, :bl].abs().max())
    assert iso_err <= 1e-5 * iso_ref, (iso_err, iso_ref)
    del packed, solo
    leaves = list(param_leaves(params))
    for x in leaves:
        x.requires_grad_(True)
    pb = train.make_packed_batch(2, cfg32, batch=1, seq=2048, device=device)

    def loss_grads():
        loss = train.loss_fn(params, pb["tokens"], pb["positions"],
                             pb["labels"], cfg32,
                             segment_ids=pb["segment_ids"])
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    _reset_counts()
    loss_k, grads_k = loss_grads()
    plaunch = _counts()
    per = dict(flash_fwd=2 * 2, fused=2)
    assert plaunch == _launches(**per, **{f"{k}_seg": x
                                          for k, x in per.items()}), plaunch
    with plain_train_attention():
        loss_p, grads_p = loss_grads()
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    assert loss_err <= LOSS_RTOL, (loss_k, loss_p)
    names = ["embed"] + [f"layers.{i}.{x}" for i in range(2)
                         for x in LAYER_KEYS] + ["final_norm", "lm_head"]
    worst = (0.0, "")
    for name, ga, gb in zip(names, grads_k, grads_p):
        ref = float(gb.abs().max())
        err = _max_err(ga, gb)
        assert err <= GRAD_RTOL * ref + 1e-12, \
            f"packed gradient {name}: max-abs err {err:.3e} of max {ref:.3e}"
        worst = max(worst, (err / max(ref, 1e-30), name))
    res.update(isolation_max_abs_err=iso_err, isolation_max_logit=iso_ref,
               parity=dict(loss_rel_err=loss_err, grad_rel_err=worst[0],
                           grad_worst=worst[1]))
    print(f"packed fp32 at 2 layers, S=2048: document B's logits in a packed"
          f" row vs alone max_abs_err {iso_err:.3e} (<= 1e-5 x the largest, "
          f"{iso_ref:.3f}); packed loss "
          f"{loss_k:.6f} (kernels) vs {loss_p:.6f} (plain), rel err "
          f"{loss_err:.2e}; worst gradient error {worst[0]:.2e} of its "
          f"largest entry ({worst[1]}); launches {plaunch}", flush=True)
    del params, leaves, grads_k, grads_p
    torch.cuda.empty_cache()
    return res


def packed_ring_train_phase(device, single):
    """The packed ring train step: make_packed_batch(PACKED_SEED) in
    zigzag order over mesh {"sp": RING_TRAIN_SP} (bf16, remat, the seed-0
    weights), the fused route (kernels 8 and 9's SEG instances: 2 and 1
    launches a layer and step) and the scan route (kernels 1-3's: 2 W^2
    and W^2), each a warm-up and PACKED_STEPS timed steps: exact launch
    counts, no fallback, the first two losses within CONTROL_RTOL of the
    single-device packed run (`single`); fp32 at 2 layers and S=2048 the
    loss within LOSS_RTOL and every gradient within GRAD_RTOL of one
    device's.  Then a contig ring (fp32, B1 N8/2 S4096, sp=4, documents of
    512 tokens) with max_segment_len=1024 on both routes: the output and
    gradients of the untruncated ring, with fewer burst.ring_rounds."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import (
        LAYER_KEYS, init_params, param_leaves,
    )
    from burst_attn_tpu_torch.parallel import burst

    w = RING_TRAIN_SP
    mesh = {"sp": w}
    n_layers = TRAIN_DIMS["n_layers"]
    tcfg = train.TrainConfig()
    out = {}
    for backend in ("fused_ring", "auto"):
        cfg = _train_model(n_layers, torch.bfloat16, attn_backend=backend)
        state = [_seed_state(cfg, tcfg, device)]
        batch = train.make_packed_batch(PACKED_SEED, cfg, mesh, batch=1,
                                        seq=TRAIN_SEQ, device=device)
        step = train.make_train_step(cfg, tcfg, mesh, device=device)
        obs0 = _obs_now()
        warm = _train_run(step, state, batch, 1)
        losses, _, times, launches = _train_run(step, state, batch,
                                                PACKED_STEPS)
        per = ({"fused_ring_fwd": 2 * n_layers, "fused_ring_bwd": n_layers}
               if backend == "fused_ring" else
               {"flash_fwd": 2 * n_layers * w * w, "fused": n_layers * w * w})
        per = {k: x * PACKED_STEPS for k, x in per.items()}
        want = _launches(**per, **{f"{k}_seg": x for k, x in per.items()})
        assert launches == want, (backend, launches, want)
        assert not any(key.startswith("burst.fused_fallback")
                       for key in _obs_since(obs0)), dict(_obs_since(obs0))
        losses = warm[0] + losses
        assert all(map(math.isfinite, losses)), losses
        diffs = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                     single["losses"])]
        assert max(diffs[:2]) <= CONTROL_RTOL, (backend, losses,
                                                single["losses"])
        step_ms = statistics.median(times)
        prof = device_breakdown(lambda: step(state[0], batch), 1, top=8)
        print_profile(f"packed ring train step, {backend}", prof)
        out[backend] = dict(step_ms=step_ms, step_ms_all=times,
                            prof=prof[:2],
                            losses=losses, rel_diff_vs_single=diffs[:2],
                            tokens_per_s=TRAIN_SEQ / (step_ms / 1e3),
                            launches=launches,
                            launches_per_step={
                                k: x // PACKED_STEPS
                                for k, x in launches.items() if x})
        print(f"packed ring train step ({backend}, mesh {mesh}, zigzag, "
              f"bf16, B=1 S={TRAIN_SEQ}): {step_ms:.1f} ms (median of "
              f"{PACKED_STEPS}: {[round(x, 1) for x in times]}); losses "
              f"{[round(x, 4) for x in losses]} (single device "
              f"{[round(x, 4) for x in single['losses']]}, rel diffs "
              f"{[float(f'{x:.2e}') for x in diffs[:2]]}); launches per step "
              f"{out[backend]['launches_per_step']}", flush=True)
        state[0] = None
        torch.cuda.empty_cache()

    # fp32 at 2 layers: the ring's loss and gradients against one device's
    base = _train_model(2, torch.float32)
    params = init_params(base, seed=0, device=device)
    leaves = list(param_leaves(params))
    for x in leaves:
        x.requires_grad_(True)

    def loss_grads(cfg, m):
        pb = train.make_packed_batch(2, cfg, m, batch=1, seq=2048,
                                     device=device)
        loss = train.loss_fn(params, pb["tokens"], pb["positions"],
                             pb["labels"], cfg, m,
                             segment_ids=pb["segment_ids"])
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    loss_1, grads_1 = loss_grads(base, None)
    names = ["embed"] + [f"layers.{i}.{x}" for i in range(2)
                         for x in LAYER_KEYS] + ["final_norm", "lm_head"]
    parity = {}
    for backend in ("fused_ring", "auto"):
        cfg = dataclasses.replace(base, attn_backend=backend)
        loss_r, grads_r = loss_grads(cfg, mesh)
        loss_err = abs(loss_r - loss_1) / abs(loss_1)
        assert loss_err <= LOSS_RTOL, (backend, loss_r, loss_1)
        worst = (0.0, "")
        for name, ga, gb in zip(names, grads_r, grads_1):
            ref = float(gb.abs().max())
            err = _max_err(ga, gb)
            assert err <= GRAD_RTOL * ref + 1e-12, \
                f"packed ring {backend} gradient {name}: {err:.3e} of {ref:.3e}"
            worst = max(worst, (err / max(ref, 1e-30), name))
        parity[backend] = dict(loss_rel_err=loss_err, grad_rel_err=worst[0],
                               grad_worst=worst[1])
    print(f"packed ring parity fp32 (mesh {mesh}, 2 layers, S=2048) vs one "
          f"device: {parity}", flush=True)
    del params, leaves, grads_1
    torch.cuda.empty_cache()

    # a contig ring truncated by max_segment_len, ids keeping the promise
    s, n, n_kv, msl = 4096, 8, 2, 1024
    g = torch.Generator(device=device).manual_seed(35)
    q, k, v, do = (torch.randn(1, h, s, 128, generator=g, device=device)
                   for h in (n, n_kv, n_kv, n))
    ids = torch.from_numpy((np.arange(s)[None] // 512).astype(np.int32)).to(
        device)
    trunc = {}
    for backend in ("fused_ring", "auto"):
        res = {}
        for cut in (None, msl):
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            before = _obs_now()
            o = burst.burst_attn(*xs, mesh=mesh, causal=True, layout="contig",
                                 backend=backend, segment_ids=ids,
                                 max_segment_len=cut)
            (o * do).sum().backward()
            rounds = _obs_since(before).get("burst.ring_rounds", 0)
            res[cut] = ([o.detach()] + [x.grad for x in xs], rounds)
        (full, r_full), (got, r_cut) = res[None], res[msl]
        assert r_cut < r_full, (backend, r_cut, r_full)
        o_err = _check_o(f"truncated {backend} ring", got[0], full[0],
                         torch.float32)
        errs = _bwd_errs(got[1:], full[1:], f"truncated {backend} ring")
        trunc[backend] = dict(ring_rounds=r_cut, ring_rounds_full=r_full,
                              o_err=o_err, grad_errs=errs)
    print(f"contig ring with max_segment_len={msl} (fp32 B1 N{n}/{n_kv} "
          f"S{s}, mesh {mesh}, documents of 512): the untruncated ring's o "
          f"and gradients with fewer rounds: {trunc}", flush=True)
    out["parity"] = parity
    out["truncated"] = trunc
    return out


# ---------------------------------------------------------------------------
# windowed training: the WIN instances of kernels 2-5, 8 and 9 against their
# plain versions and their times, the windowed train step on one device and
# on the ring (both routes), dist_generate with a window, and
# bench/window_bench.py

# the training model's band: Mistral-7B's sliding_window / context ratio
# (4096 of 32K) at TRAIN_SEQ, the serving cell's window
TRAIN_WINDOW = 1024
WIN_STEPS = 2  # timed windowed train steps, after a warm-up
# kernels 2-5 with a window: (name, heads, kv heads, S, window): one
# column, a band inside one 64-row tile, bands across tiles, a ragged S
WIN_BWD_CASES = (("MHA window 1", 16, 16, 2048, 1),
                 ("GQA window 40", 16, 4, 2048, 40),
                 ("GQA window 300", 16, 4, 2048, 300),
                 ("GQA ragged S window 200", 8, 2, 1000, 200))
# kernels 8 and 9 with a window: (positions, heads, kv heads, local S,
# window, dtype, ids): the ring train step's shape; a band that crosses
# two shard boundaries (r_live 3 of 4), fp32 too; with packed documents
WIN_RING_CASES = ((4, 16, 16, 2048, TRAIN_WINDOW, "bf16", False),
                  (4, 8, 2, 512, 700, "bf16", False),
                  (4, 8, 2, 512, 700, "fp32", False),
                  (4, 8, 2, 512, 700, "bf16", True))


def _band_mask(s, window, device):
    """SDPA's boolean [S, S] mask of the causal band (True: attend)."""
    import torch

    i = torch.arange(s, device=device)
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)


def check_flash_bwd_window(device):
    """Kernels 2-5's WIN instances against tile_bwd(window=) on the card,
    bf16 and fp32, WIN_BWD_CASES on both routes (the fused kernel and the
    split pair), each launched twice and bitwise equal; a window above S
    gives bitwise the instances without WIN; WIN + SEG (packed documents
    under a band of 300).  Returns the largest errors {"fused": (dq, dk,
    dv), "split": (...)}."""
    import torch

    from burst_attn_tpu_torch.ops import flash, tile

    worst = {"fused": [0.0] * 3, "split": [0.0] * 3}
    for dtype in (torch.float32, torch.bfloat16):
        key = _dtype_key(dtype)
        for ci, (name, n, n_kv, s, window) in enumerate(WIN_BWD_CASES):
            args = _bwd_inputs(device, dtype, n, n_kv, s, True,
                               seed=70 + ci, window=window)
            want = tile.tile_bwd(*args, window=window)
            errs = {}
            for fused in (True, False):
                route = "fused" if fused else "split"
                got = flash.flash_bwd(*args, fused=fused, window=window)
                again = flash.flash_bwd(*args, fused=fused, window=window)
                assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                    (key, name, route)
                # on the gradients' scale: a one-column band (window 1)
                # has dq = 0 in exact arithmetic (a row sees itself alone,
                # dP_ii = delta_i), so its error is that cancellation's
                errs[route] = _bwd_errs(
                    got, want, f"flash_bwd[window] {key} {name} {route}",
                    scale=max(float(x.abs().max()) for x in want))
                worst[route] = [max(a, b) for a, b in zip(worst[route],
                                                          errs[route])]
                del got, again
            print(f"flash_bwd[window] {key} {name} N{n}/{n_kv} S{s}: "
                  + "; ".join(f"{r} max_abs_err dq {e[0]:.3e} dk {e[1]:.3e}"
                              f" dv {e[2]:.3e}" for r, e in errs.items())
                  + ", two launches equal", flush=True)
            del args, want
        # a window above S: no band left, the instances without WIN
        args = _bwd_inputs(device, dtype, 16, 4, 2048, True, seed=75)
        for fused in (True, False):
            a = flash.flash_bwd(*args, fused=fused, window=4096)
            b = flash.flash_bwd(*args, fused=fused)
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (key, fused)
        # WIN + SEG
        ids = torch.from_numpy(_packed_ids(76, 1, 2048, 8)).to(device)
        segs = (ids, ids)
        args = _bwd_inputs(device, dtype, 16, 4, 2048, True, seed=76,
                           window=300, segs=segs)
        want = tile.tile_bwd(*args, window=300, segments=segs)
        for fused in (True, False):
            route = "fused" if fused else "split"
            got = flash.flash_bwd(*args, fused=fused, window=300,
                                  segments=segs)
            again = flash.flash_bwd(*args, fused=fused, window=300,
                                    segments=segs)
            assert all(torch.equal(x, y) for x, y in zip(got, again)), route
            errs = _bwd_errs(got, want, f"flash_bwd[window+seg] {key} {route}")
            worst[route] = [max(x, y) for x, y in zip(worst[route], errs)]
        print(f"flash_bwd[window] {key}: window 4096 >= S 2048 bitwise the "
              f"instances without WIN (both routes); window 300 + 8 packed "
              f"documents within tolerance, two launches equal", flush=True)
        del args, want, got, again
    torch.cuda.empty_cache()
    return worst


def time_flash_bwd_window(device, worst):
    """Kernels 2-5's WIN instances at the windowed train step's shape (B1
    N16/16 S8192 D128 bf16 causal, window TRAIN_WINDOW): held to
    tile_bwd(window=) on both routes (two launches bitwise), then the
    fused kernel's and the split pair's ms (each split kernel's share by
    the profiler), the unwindowed fused kernel's in the same run, the
    plain tile_bwd's and SDPA's backward with the band as a boolean mask.
    Bound: the band's pairs (S w - w (w - 1) / 2 a head), 10 D flops each
    fused (6 D dq, 8 D dk/dv), the rows' bytes read and written once.
    Returns the kernels-line records flash_bwd_fused[window],
    flash_bwd_dq[window], flash_bwd_dkdv[window]."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash, tile

    n, s, w = TRAIN_DIMS["n_heads"], TRAIN_SEQ, TRAIN_WINDOW
    args = _bwd_inputs(device, torch.bfloat16, n, n, s, True, seed=77,
                       window=w)
    do, q, k, v, delta, lse, _, _ = args
    want = tile.tile_bwd(*args, window=w)
    for fused in (True, False):
        route = "fused" if fused else "split"
        got = flash.flash_bwd(*args, fused=fused, window=w)
        again = flash.flash_bwd(*args, fused=fused, window=w)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), route
        errs = _bwd_errs(got, want, f"flash_bwd[window] train shape {route}")
        worst[route] = [max(a, b) for a, b in zip(worst[route], errs)]
        del got, again
    del want
    torch.cuda.empty_cache()
    route = flash.bwd_route(q.shape, k.shape, window=w, triangular=True)
    t = {"fused": time_ms(lambda: flash.flash_bwd(*args, fused=True,
                                                  window=w), iters=5,
                          warmup=1),
         "split": time_ms(lambda: flash.flash_bwd(*args, fused=False,
                                                  window=w), iters=5,
                          warmup=1),
         "unwindowed": time_ms(lambda: flash.flash_bwd(*args, fused=True),
                               iters=3, warmup=1)}
    _, _, top = device_breakdown(lambda: flash.flash_bwd(
        *args, fused=False, window=w), 3, top=4)
    dq_p = sum(x for name, x in top if "flash_bwd_dq_mma_kernel" in name)
    dkdv_p = sum(x for name, x in top if "flash_bwd_dkdv_mma_kernel" in name)
    assert dq_p > 0 and dkdv_p > 0, top
    t["dq"] = t["split"] * dq_p / (dq_p + dkdv_p)
    t["dkdv"] = t["split"] * dkdv_p / (dq_p + dkdv_p)
    t["plain"] = time_ms(lambda: tile.tile_bwd(*args, window=w), iters=2,
                         warmup=1)
    torch.cuda.empty_cache()
    mask = _band_mask(s, w, device)
    t["library_fwd"] = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), iters=5, warmup=2)
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lo = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)
    t["library"] = time_ms(lambda: torch.autograd.grad(
        lo, (qr, kr, vr), do, retain_graph=True), iters=5, warmup=1)
    del lo, qr, kr, vr, mask
    pairs = n * (s * w - w * (w - 1) // 2)
    print(f"flash_bwd[window] at B1 N{n}/{n} S{s} D128 bf16 window {w} "
          f"(the route rule picks {route}): fused {t['fused']:.3f} ms, split "
          f"pair {t['split']:.3f} ms (dq {t['dq']:.3f} + dk/dv "
          f"{t['dkdv']:.3f} by the profiler's shares), unwindowed fused "
          f"{t['unwindowed']:.3f} ms; plain tile_bwd {t['plain']:.3f} ms; "
          f"SDPA backward with the band mask {t['library']:.3f} ms; "
          f"{pairs / n / (s * (s + 1) // 2):.3f} of the causal pairs",
          flush=True)
    esz = q.element_size()
    reads = esz * 2 * (q.numel() + k.numel()) + 4 * 2 * delta.numel()
    recs = []
    for name, kern, err, written, matmuls, lib, rep_ in (
            ("flash_bwd_fused[window]", "fused", max(worst["fused"]),
             q.numel() + 2 * k.numel(), 5, t["library"],
             "burst_attn_tpu/ops/pallas_flash.py:1127 (_bwd_fused_kernel, "
             "the banded sweep of bwd_band_nbq)"),
            ("flash_bwd_dq[window]", "dq", worst["split"][0], q.numel(), 3,
             None, "burst_attn_tpu/ops/pallas_flash.py:865 (_dq_kernel, "
             "window)"),
            ("flash_bwd_dkdv[window]", "dkdv", max(worst["split"][1:]),
             2 * k.numel(), 4, None,
             "burst_attn_tpu/ops/pallas_flash.py:945 (_dkdv_kernel, "
             "window)")):
        bms, by = bound_ms(reads + 4 * written, matmuls * 2 * pairs * 128)
        recs.append(dict(name=name, route="cuda",
                         source="burst_attn_tpu_torch/csrc/flash_bwd.cu",
                         replaces=rep_, max_abs_err=err, ms=t[kern],
                         plain_ms=t["plain"], bound_ms=bms, bound_by=by,
                         library_ms=lib,
                         window={"shape": f"B1 N{n}/{n} S{s} D128 bf16 "
                                          f"causal window {w}",
                                 "route_rule": route, "pairs": pairs,
                                 "ms_unwindowed_fused": t["unwindowed"],
                                 "library_fwd_ms": t["library_fwd"]}))
    for rec in recs[1:]:
        rec["window"]["split_pair_ms"] = t["split"]
        rec["window"]["profiler_ms"] = (dq_p, dkdv_p)
    del args, do, q, k, v, delta, lse
    torch.cuda.empty_cache()
    return recs


def _win_ring_case(device, case, seed):
    """(cfg, ring, (q, k, v, o, lse, do) stacked, seg or None, bwd
    program, tables, fwd program) of one WIN_RING_CASES case: o and lse
    from kernel 8's WIN instance."""
    import numpy as np
    import torch

    from burst_attn_tpu_torch.ops import fused_ring
    from burst_attn_tpu_torch.parallel import mesh

    w, n, n_kv, s, window, key, packed = case
    cfg, ring, args, prog, tables = _fused_bwd_setup(
        device, (w, "contig", True, n, n_kv, s, key, dict(window=window)),
        seed)
    seg = None
    if packed:
        ids = _packed_ids(seed, 1, w * s, 8)
        seg = mesh.shard(torch.from_numpy(np.ascontiguousarray(ids)).to(
            device), w, dim=1)
    q, k, v, _, _, do = args
    o, lse = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
    fprog = fused_ring.ring_plan(cfg, *ring, s, "fwd")[0]
    return cfg, ring, (q, k, v, o, lse, do), seg, prog, tables, fprog


def check_ring_window(device):
    """Kernels 8 and 9's WIN instances on the windowed contig ring's
    truncated program (WIN_RING_CASES): r_live = min(W, (S + w - 2) // S
    + 1) rounds in both programs; against fused_ring_reference and
    fused_ring_bwd_reference with the window (head chunks of 4 at the
    ring step's shape), each launched twice and bitwise equal; kernel 8's
    STATS + WIN instance reports the truncated round count, the elided
    rounds and the band's pairs, o bitwise the stats-off launch.  Returns
    the largest errors (kernel 8's o, kernel 9's of dq, dk, dv) and the
    ring step's r_live."""
    import torch

    from burst_attn_tpu_torch.ops import fused_ring, fused_ring_bwd, masks

    k8_err, k9_err, step_r_live = 0.0, 0.0, None
    for ci, case in enumerate(WIN_RING_CASES):
        w, n, n_kv, s, window, key, packed = case
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[key]
        cfg, ring, args, seg, prog, tables, fprog = _win_ring_case(
            device, case, seed=80 + ci)
        q, k, v, o, lse, do = args
        r_live = min(w, (s + window - 2) // s + 1)
        assert fprog.n_rounds == prog.n_rounds == r_live < w, (case, r_live)
        if ci == 0:
            step_r_live = r_live
        what = (f"{key} W={w} N{n}/{n_kv} S_local {s} window {window}"
                f"{' packed' if packed else ''}")
        again = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring, seg=seg)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse), what
        ftables = fused_ring.ring_plan(cfg, *ring, s, "fwd")[1]
        po, plse = fused_ring.fused_ring_reference(
            q, k, v, fprog, ftables, 128 ** -0.5, seg=seg, window=window)
        err8 = _check_o(f"fused_ring_fwd[window] {what}", o, po, dtype)
        _stats_close(f"fused_ring_fwd[window] {what} lse", lse, plse, key)
        del po, plse, again
        got = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
        again = fused_ring_bwd.fused_ring_bwd(*args, cfg, *ring, seg=seg)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), what
        want = fused_ring_bwd.fused_ring_bwd_reference(
            *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm,
            seg=seg, window=window, head_chunk=4)
        errs = _bwd_errs(got, want, f"fused_ring_bwd[window] {what}")
        note = ""
        if ci == 0:  # the STATS + WIN instance
            so, slse, st = fused_ring.fused_ring_fwd(q, k, v, cfg, *ring,
                                                     collect_stats=True)
            assert torch.equal(so, o) and torch.equal(slse, lse), what
            pairs = [sum(masks.spec_pair_count(
                masks.MaskSpec(*map(int, t[r, :5])), s, s, window)
                for r in range(fprog.n_rounds)) for t in ftables]
            assert st.fused_rounds.cpu().tolist() == [r_live] * w
            assert st.rounds_elided.cpu().tolist() == [w - r_live] * w
            assert st.attn_pairs.cpu().tolist() == [float(x) for x in pairs]
            note = (f"; STATS instance: fused_rounds {r_live}, elided "
                    f"{w - r_live}, attn_pairs {pairs} (the band's)")
        k8_err, k9_err = max(k8_err, err8), max(k9_err, *errs)
        print(f"fused_ring[window] {what}: r_live {r_live} of {w} rounds; "
              f"kernel 8 max_abs_err {err8:.3e}, kernel 9 dq {errs[0]:.3e} "
              f"dk {errs[1]:.3e} dv {errs[2]:.3e}; two launches equal{note}",
              flush=True)
        del args, got, again, want
        torch.cuda.empty_cache()
    return k8_err, k9_err, step_r_live


def time_ring_window(device, lib, errs):
    """Kernels 8 and 9's WIN instances at the windowed ring train step's
    shape (W=4, B1 N16/16 S_local 2048 D128 bf16, window TRAIN_WINDOW:
    r_live 2 of 4 rounds), beside the unwindowed contig launches in the
    same run; the plain versions' host-timed walk; `lib`: SDPA with the
    band mask at the global shape (fwd ms, bwd ms).  Bound: the band's
    pairs, kernel 8's rows and the truncated program's copies, kernel 9's
    by _bwd_bound with the band's pairs.  Returns the kernels-line records
    fused_ring_fwd[window] and fused_ring_bwd[window]."""
    import dataclasses

    import torch

    from burst_attn_tpu_torch.ops import fused_ring, fused_ring_bwd, masks

    case = WIN_RING_CASES[0]
    w, n, _, s, window, _, _ = case
    cfg, ring, args, _, prog, tables, fprog = _win_ring_case(device, case,
                                                             seed=88)
    q, k, v, o, lse, do = args
    d, b = 128, 1
    t = {}
    t0 = time.perf_counter()
    fused_ring.fused_ring_reference(
        q, k, v, fprog, fused_ring.ring_plan(cfg, *ring, s, "fwd")[1],
        128 ** -0.5, window=window)
    torch.cuda.synchronize()
    t["plain_fwd"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fused_ring_bwd.fused_ring_bwd_reference(
        *args, prog, tables, 128 ** -0.5, cfg.optimize_bwd_comm,
        window=window, head_chunk=4)
    torch.cuda.synchronize()
    t["plain_bwd"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()
    dense = dataclasses.replace(cfg, window=None)
    for name, c in (("win", cfg), ("dense", dense)):
        oo, ll = fused_ring.fused_ring_fwd(q, k, v, c, *ring)
        t[name, "k8"] = time_ms(lambda: fused_ring.fused_ring_fwd(
            q, k, v, c, *ring), iters=10, warmup=2)
        t[name, "k9"] = time_ms(lambda: fused_ring_bwd.fused_ring_bwd(
            q, k, v, oo, ll, do, c, *ring), iters=10, warmup=2)
        del oo, ll
    pairs = b * n * sum(masks.spec_pair_count(
        masks.MaskSpec(*map(int, tb[r, :5])), s, s, window)
        for tb in fused_ring.ring_plan(cfg, *ring, s, "fwd")[1]
        for r in range(fprog.n_rounds))
    chunk = 2 * b * n * s * d * 2  # K and V of one position, bf16
    copies = w * (sum(fprog.rows["send0"]) + sum(fprog.rows["send1"])
                  + len(fprog.copy_in))
    k8_bytes = (2 * 4 * q.numel() + 4 * lse.numel()
                + 2 * copies * chunk)  # q, k, v, o bf16; lse; copies
    b8 = bound_ms(k8_bytes, 4 * d * pairs)
    b9 = _bwd_bound(tables, prog, b, n, n, s, d, 2, pairs=pairs)[:2]
    print(f"WIN kernels 8 and 9 at the ring step's shape (W={w} B1 N{n}/{n} "
          f"S_local {s} bf16, window {window}: {fprog.n_rounds} of {w} "
          f"rounds), ms a launch: kernel 8 {t['win', 'k8']:.4f} (unwindowed "
          f"contig {t['dense', 'k8']:.4f}), kernel 9 {t['win', 'k9']:.4f} "
          f"(unwindowed {t['dense', 'k9']:.4f}); bounds {b8[0]:.4f} / "
          f"{b9[0]:.4f} ms; plain versions {t['plain_fwd']:.0f} / "
          f"{t['plain_bwd']:.0f} ms", flush=True)
    recs = []
    for name, kern, src, rep_, bnd, li, err in (
            ("fused_ring_fwd[window]", "k8", "fused_ring_fwd.cu",
             "burst_attn_tpu/ops/fused_ring.py:1049 (_fused_fwd_kernel, "
             "wnd, r_live)", b8, 0, errs[0]),
            ("fused_ring_bwd[window]", "k9", "fused_ring_bwd.cu",
             "burst_attn_tpu/ops/fused_ring_bwd.py:1087 (_fused_bwd_kernel, "
             "wnd, r_live)", b9, 1, errs[1])):
        recs.append(dict(
            name=name, route="cuda",
            source=f"burst_attn_tpu_torch/csrc/{src}", replaces=rep_,
            max_abs_err=err, ms=t["win", kern],
            plain_ms=t["plain_fwd" if kern == "k8" else "plain_bwd"],
            bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib[li],
            window={"shape": f"W={w} B1 N{n}/{n} S_local {s} D{d} bf16 "
                             f"contig window {window} (the windowed ring "
                             "train step's)",
                    "r_live": fprog.n_rounds, "pairs": pairs,
                    "ms_unwindowed": t["dense", kern]}))
    del args, q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return recs


def _win_ring_live(w, s, window):
    """(forward, backward) launches of kernel 1 / flash_bwd a layer on the
    windowed single contig scan ring of w positions: the live rounds of
    its r_live-truncated schedule (round 0 and the next r_live - 1 in the
    forward; round 0 and the last r_live - 1 in the backward), each
    position's round live by masks.spec_live with the window."""
    from burst_attn_tpu_torch.ops import masks
    from burst_attn_tpu_torch.parallel.ring import partition_at_round

    r_live = masks.live_round_prefix("contig", s, w, causal=True,
                                     window=window)

    def live(qp, kp):
        return masks.spec_live(masks.round_spec(qp, kp, s, s, True, "contig",
                                                window=window), window)

    fwd = sum(live(p, partition_at_round(r, 0, p, 1, w))
              for p in range(w) for r in range(r_live))
    bwd_rounds = [0] + list(range(w - (r_live - 1), w))
    bwd = sum(live(partition_at_round(r, 0, p, 1, w), p)
              for p in range(w) for r in bwd_rounds)
    return fwd, bwd, r_live


def _win_parity(device, mesh=None, backends=(None,)):
    """fp32, 2 layers at full width, S 2048, window TRAIN_WINDOW: the loss
    and gradients of one step against the one-device plain-attention
    step (mesh None: the kernels on one device; else the ring's routes),
    within LOSS_RTOL and GRAD_RTOL of the largest entry."""
    import dataclasses

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import (
        LAYER_KEYS, init_params, param_leaves,
    )

    base = _train_model(2, torch.float32, layout="contig",
                        window=TRAIN_WINDOW)
    params = init_params(base, seed=0, device=device)
    leaves = list(param_leaves(params))
    for x in leaves:
        x.requires_grad_(True)

    def loss_grads(cfg, m):
        batch = train.make_batch(2, cfg, m, batch=1, seq=2048, device=device)
        loss = train.loss_fn(params, batch["tokens"], batch["positions"],
                             batch["labels"], cfg, m)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    with plain_train_attention():
        loss_p, grads_p = loss_grads(base, None)
    names = ["embed"] + [f"layers.{i}.{x}" for i in range(2)
                         for x in LAYER_KEYS] + ["final_norm", "lm_head"]
    out = {}
    for backend in backends:
        cfg = base if backend is None else dataclasses.replace(
            base, attn_backend=backend)
        _reset_counts()
        loss_k, grads_k = loss_grads(cfg, mesh)
        launches = _counts()
        assert sum(launches[k + "_win"] for k in _COUNT_KEYS) > 0, launches
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        assert loss_err <= LOSS_RTOL, (backend, loss_k, loss_p)
        worst = (0.0, "")
        for name, ga, gb in zip(names, grads_k, grads_p):
            ref = float(gb.abs().max())
            err = _max_err(ga, gb)
            assert err <= GRAD_RTOL * ref + 1e-12, \
                f"window {backend} gradient {name}: {err:.3e} of {ref:.3e}"
            worst = max(worst, (err / max(ref, 1e-30), name))
        out[backend or "one device"] = dict(
            loss_rel_err=loss_err, grad_rel_err=worst[0],
            grad_worst=worst[1])
    del params, leaves, grads_p
    torch.cuda.empty_cache()
    return out


def window_train_phase(device):
    """The windowed train step on one device: train_smoke's model with
    window TRAIN_WINDOW (layout contig; bf16, remat, B=1, S=TRAIN_SEQ,
    the seed-0 weights) on make_batch(1): a warm-up and WIN_STEPS timed
    steps, exactly 2 WIN forward launches a layer and step (kernel 1) and
    one WIN backward a layer and step on the route flash.bwd_route picks,
    nothing else; the loss finite; the control from the same seed with
    plain attention under the band, whose first two losses must be within
    CONTROL_RTOL; then fp32 parity at 2 layers (_win_parity)."""
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.ops import flash

    n_layers = TRAIN_DIMS["n_layers"]
    cfg = _train_model(n_layers, torch.bfloat16, layout="contig",
                       window=TRAIN_WINDOW)
    tcfg = train.TrainConfig()
    state = [_seed_state(cfg, tcfg, device)]
    batch = train.make_batch(1, cfg, batch=1, seq=TRAIN_SEQ, device=device)
    step = train.make_train_step(cfg, tcfg, device=device)
    warm = _train_run(step, state, batch, 1)
    losses, norms, times, launches = _train_run(step, state, batch,
                                                WIN_STEPS)
    shape = (1, TRAIN_DIMS["n_heads"], TRAIN_SEQ, TRAIN_DIMS["d_head"])
    route = flash.bwd_route(shape, shape, window=TRAIN_WINDOW,
                            triangular=True)
    per = dict(flash_fwd=2 * n_layers * WIN_STEPS)
    per |= ({"fused": n_layers * WIN_STEPS} if route == "fused" else
            {"dq": n_layers * WIN_STEPS, "dkdv": n_layers * WIN_STEPS})
    want = _launches(**per, **{f"{k}_win": x for k, x in per.items()})
    assert launches == want, (launches, want)
    losses = warm[0] + losses
    assert all(map(math.isfinite, losses + norms)), losses
    # one step through the split pair (the WIN dq and dk/dv kernels)
    with split_train_backward():
        s_losses, _, s_times, s_launches = _train_run(step, state, batch, 1)
    per = dict(flash_fwd=2 * n_layers, dq=n_layers, dkdv=n_layers)
    want = _launches(**per, **{f"{k}_win": x for k, x in per.items()})
    assert s_launches == want, (s_launches, want)
    assert all(map(math.isfinite, s_losses)), s_losses
    step_ms = statistics.median(times)
    res = dict(seq=TRAIN_SEQ, window=TRAIN_WINDOW, bwd_route=route,
               split_launches=s_launches, split_step_ms=s_times[0],
               losses=losses, step_ms=step_ms, step_ms_all=times,
               tokens_per_s=TRAIN_SEQ / (step_ms / 1e3), launches=launches,
               launches_per_step={k: x // WIN_STEPS
                                  for k, x in launches.items() if x},
               prof=device_breakdown(lambda: step(state[0], batch), 1,
                                     top=8))
    state[0] = None
    torch.cuda.empty_cache()
    state[0] = _seed_state(cfg, tcfg, device)
    with plain_train_attention():
        c_losses, _, c_times, c_launches = _train_run(step, state, batch, 2)
    assert sum(c_launches.values()) == 0, c_launches
    state[0] = None
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses, c_losses)]
    assert max(diffs[:2]) <= CONTROL_RTOL, (losses, c_losses)
    res.update(control_losses=c_losses, control_rel_diffs=diffs[:2],
               control_step_ms=c_times[-1])
    print(f"windowed train step (window {TRAIN_WINDOW}, bf16, remat, B=1 "
          f"S={TRAIN_SEQ}): {step_ms:.1f} ms (median of {WIN_STEPS}: "
          f"{[round(x, 1) for x in times]}), {res['tokens_per_s']:.0f} "
          f"tokens/s; losses {[round(x, 4) for x in losses]}; launches per "
          f"step {res['launches_per_step']} (backward route {route}); "
          f"control with plain attention under the band "
          f"{[round(x, 4) for x in c_losses]} (rel diffs "
          f"{[float(f'{x:.2e}') for x in diffs[:2]]})", flush=True)
    print_profile("windowed train step", res["prof"])
    res["prof"] = res["prof"][:2]
    torch.cuda.empty_cache()
    res["parity"] = _win_parity(device)
    print(f"windowed train parity fp32 (2 layers, S=2048, window "
          f"{TRAIN_WINDOW}) vs plain attention: {res['parity']}", flush=True)
    return res


def window_ring_train_phase(device, single):
    """The windowed ring train step: the model of window_train_phase over
    mesh {"sp": RING_TRAIN_SP} (contig: S_local 2048, r_live 2 of 4), the
    fused route (kernels 8 and 9's WIN instances: 2 and 1 launches a layer
    and step) and the scan route (kernels 1-5's: the live rounds of the
    truncated schedule, _win_ring_live), each a warm-up and WIN_STEPS
    timed steps: exact launch counts, no fallback, the first two losses
    within CONTROL_RTOL of the single-device windowed run (`single`);
    fp32 at 2 layers the loss and gradients of both routes against one
    device with plain attention (_win_parity)."""
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.ops import flash

    w = RING_TRAIN_SP
    mesh = {"sp": w}
    n_layers = TRAIN_DIMS["n_layers"]
    s_loc = TRAIN_SEQ // w
    n_fwd, n_bwd, r_live = _win_ring_live(w, s_loc, TRAIN_WINDOW)
    shape = (1, TRAIN_DIMS["n_heads"], s_loc, TRAIN_DIMS["d_head"])
    route = flash.bwd_route(shape, shape, window=TRAIN_WINDOW)
    tcfg = train.TrainConfig()
    out = dict(r_live=r_live, scan_live_rounds=dict(fwd=n_fwd, bwd=n_bwd),
               scan_bwd_route=route)
    for backend in ("fused_ring", "auto"):
        cfg = _train_model(n_layers, torch.bfloat16, attn_backend=backend,
                           layout="contig", window=TRAIN_WINDOW)
        state = [_seed_state(cfg, tcfg, device)]
        batch = train.make_batch(1, cfg, mesh, batch=1, seq=TRAIN_SEQ,
                                 device=device)
        step = train.make_train_step(cfg, tcfg, mesh, device=device)
        obs0 = _obs_now()
        warm = _train_run(step, state, batch, 1)
        losses, _, times, launches = _train_run(step, state, batch,
                                                WIN_STEPS)
        if backend == "fused_ring":
            per = {"fused_ring_fwd": 2 * n_layers, "fused_ring_bwd": n_layers}
        else:
            per = {"flash_fwd": 2 * n_layers * n_fwd}
            per |= ({"fused": n_layers * n_bwd} if route == "fused" else
                    {"dq": n_layers * n_bwd, "dkdv": n_layers * n_bwd})
        per = {k: x * WIN_STEPS for k, x in per.items()}
        want = _launches(**per, **{f"{k}_win": x for k, x in per.items()})
        assert launches == want, (backend, launches, want)
        assert not any(key.startswith("burst.fused_fallback")
                       for key in _obs_since(obs0)), dict(_obs_since(obs0))
        losses = warm[0] + losses
        assert all(map(math.isfinite, losses)), losses
        diffs = [abs(a - b) / abs(b) for a, b in zip(losses,
                                                     single["losses"])]
        assert max(diffs[:2]) <= CONTROL_RTOL, (backend, losses,
                                                single["losses"])
        step_ms = statistics.median(times)
        prof = device_breakdown(lambda: step(state[0], batch), 1, top=8)
        print_profile(f"windowed ring train step, {backend}", prof)
        out[backend] = dict(step_ms=step_ms, step_ms_all=times,
                            prof=prof[:2], losses=losses,
                            rel_diff_vs_single=diffs[:2], launches=launches,
                            tokens_per_s=TRAIN_SEQ / (step_ms / 1e3),
                            launches_per_step={
                                k: x // WIN_STEPS
                                for k, x in launches.items() if x})
        print(f"windowed ring train step ({backend}, mesh {mesh}, contig, "
              f"window {TRAIN_WINDOW}: r_live {r_live} of {w}, bf16, B=1 "
              f"S={TRAIN_SEQ}): {step_ms:.1f} ms (median of {WIN_STEPS}: "
              f"{[round(x, 1) for x in times]}); losses "
              f"{[round(x, 4) for x in losses]} (single device "
              f"{[round(x, 4) for x in single['losses']]}, rel diffs "
              f"{[float(f'{x:.2e}') for x in diffs[:2]]}); launches per step "
              f"{out[backend]['launches_per_step']}"
              + (f" = 2 x {n_layers} layers x {n_fwd} live forward rounds "
                 f"and {n_layers} x {n_bwd} live backward rounds ({route})"
                 if backend == "auto" else ""), flush=True)
        state[0] = None
        torch.cuda.empty_cache()
    out["parity"] = _win_parity(device, mesh, ("fused_ring", "auto"))
    print(f"windowed ring parity fp32 (mesh {mesh}, 2 layers, S=2048) vs one "
          f"device with plain attention: {out['parity']}", flush=True)
    return out


def window_dist_phase(device, hand):
    """dist_generate with window WINDOW (the serving model, contig) over
    sp=HANDOFF_SP, both routes (kernel 8's WIN instance once a layer;
    kernel 1's once a live round of every position and layer), no
    fallback.  fp32 at HANDOFF_PROMPT_FP32 tokens: both routes token-exact
    with each other and with the single-device dense windowed `generate`.
    bf16 at HANDOFF_PROMPT tokens: the fused stream against the scan
    route's dist_decode_step, teacher-forced (the serving bar); prefill
    ms and decode ms a step per route."""
    import dataclasses

    import numpy as np
    import torch

    from burst_attn_tpu_torch.models.decode import generate
    from burst_attn_tpu_torch.models.dist_decode import (
        dist_decode_step, dist_generate, dist_prefill,
    )
    from burst_attn_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh({"sp": HANDOFF_SP}, device=device)
    n_layers = SERVE_DIMS["n_layers"]
    res = {}
    for key, dtype, prompt in (
            ("fp32", torch.float32, hand["_fp32_prompt"]),
            ("bf16", torch.bfloat16, hand["_bf16_prompt"])):
        params = model(dtype, device)[1]
        p = torch.from_numpy(prompt.astype(np.int64))[None].to(device)
        n_fwd = _win_ring_live(HANDOFF_SP, len(prompt) // HANDOFF_SP,
                               WINDOW)[0]
        toks = {}
        for backend in ("fused_ring", "auto"):
            cfg = dataclasses.replace(_handoff_cfg(dtype, backend),
                                      layout="contig", window=WINDOW)
            _reset_counts()
            obs0 = _obs_now()
            with torch.no_grad():
                out = dist_generate(params, p, cfg, mesh,
                                    steps=HANDOFF_STEPS)
            torch.cuda.synchronize()
            per = ({"fused_ring_fwd": n_layers} if backend == "fused_ring"
                   else {"flash_fwd": n_layers * n_fwd})
            launches = _counts()
            assert launches == _launches(**per, **{
                f"{k}_win": x for k, x in per.items()}), (key, launches)
            assert not any(k_.startswith("burst.fused_fallback")
                           for k_ in _obs_since(obs0))
            toks[backend] = [int(t) for t in out[0]]
            if key == "bf16":
                res[f"launches_{backend}"] = per

                def prefill():
                    with torch.no_grad():
                        return dist_prefill(params, p, cfg, mesh,
                                            gen_budget=HANDOFF_STEPS)
                res[f"prefill_ms_{backend}"] = host_ms(prefill)
                _, cache = prefill()
                feed = torch.tensor([toks[backend][0]], device=device)
                n_new = cache.n_new

                def step():
                    with torch.no_grad():
                        dist_decode_step(params, feed, len(prompt) + n_new,
                                         cache._replace(n_new=n_new), cfg,
                                         mesh)
                res[f"decode_ms_{backend}"] = host_ms(
                    lambda: [step() for _ in range(8)]) / 8
                del cache
        a, c = toks["fused_ring"], toks["auto"]
        if key == "fp32":
            wcfg = dataclasses.replace(_handoff_cfg(dtype, "auto"),
                                       layout="contig", window=WINDOW)
            with torch.no_grad():
                dense = generate(params, p, wcfg, steps=HANDOFF_STEPS,
                                 max_seq=len(prompt) + HANDOFF_STEPS)
            dense = [int(t) for t in dense[0]]
            assert a == c == dense, (a, c, dense)
            print(f"dist_generate window {WINDOW} fp32 ({len(prompt)}-token "
                  f"prompt, sp={HANDOFF_SP}): fused and scan routes "
                  f"token-exact with each other and with the dense windowed "
                  f"generate; scan forward launches a layer {n_fwd}",
                  flush=True)
        else:
            forced = _dist_forced_agreement(dataclasses.replace(
                _handoff_cfg(dtype, "auto"), layout="contig", window=WINDOW),
                params, prompt, a, mesh, device)
            check_agreement(f"dist_generate window {WINDOW} bf16 fused "
                            "stream", forced, True,
                            against="the scan route's dist_decode_step")
            res["bf16_forced_agree"] = forced[0]
            res["bf16_routes_equal"] = sum(x == y for x, y in zip(a, c))
        torch.cuda.empty_cache()
    print(f"dist_generate window {WINDOW} ({HANDOFF_PROMPT} tokens, bf16, "
          f"sp={HANDOFF_SP}): prefill fused ring "
          f"{res['prefill_ms_fused_ring']:.1f} ms, scan ring "
          f"{res['prefill_ms_auto']:.1f} ms; decode step "
          f"{res['decode_ms_fused_ring']:.2f} / {res['decode_ms_auto']:.2f} "
          f"ms", flush=True)
    return res


def window_bench_phase(device):
    """bench/window_bench.py once at its defaults (kernel 1's forward at
    S 65536, N32, D128 bf16 over windows 65536, 16384, 4096), its rows
    printed: the time follows the band."""
    from burst_attn_tpu_torch.bench import window_bench

    rows = window_bench.run(65536, 32, 128, [65536, 16384, 4096], iters=5)
    for r in rows:
        print(f"window_bench: {json.dumps(r)}", flush=True)
    assert rows[-1]["fwd_ms"] < rows[0]["fwd_ms"], rows
    return rows


# ---------------------------------------------------------------------------
# MoE models, served and trained, and Ulysses attention

# the expert count and top-k of Mixtral-8x7B on the repo's widths
MOE = dict(n_experts=8, moe_top_k=2)
# serving: n_experts / top_k makes the training capacity every token, so
# the dense reference forward (which routes with it) drops nothing; the
# engines route drop-free whatever the factor
MOE_SERVE_CF = 4.0
MOE_REQUESTS = 6  # the MoE serve phase's share of the seeded requests
# training: TRAIN_DIMS' widths at 4 layers: at 16 the expert weights alone
# are 6.4 B parameters, and with AdamW's state they do not fit in 80 GB
MOE_TRAIN_LAYERS = 4
ULYSSES_SP = 4  # the Ulysses train step's positions (4 heads each)


# A bf16 MoE stream against the dense MoE forward: besides the near ties
# of the logits, a token whose top-k expert choice is itself a near tie
# routes differently on the two sides (their bf16 activations differ by
# rounding) and moves its logits by O(1).  Such a disagreement is
# accepted where the dense forward's router logits at that token, in
# some layer, put the k-th and (k+1)-th expert within ROUTER_TIE (a few
# bf16 ulps of the hidden state move a router logit by ~0.004 a layer;
# the router logits have std ~0.9).  fp32 stays token-exact.
ROUTER_TIE = 0.05


def moe_agreement(cfg, params, prompts, toks, device):
    """agreement()'s teacher-forced pass through the dense MoE forward,
    recording every layer's router margin (the k-th minus the (k+1)-th
    router logit) at every position: (agreeing tokens, total, [(index,
    logit gap, smallest router margin of that position over the
    layers)] per disagreement)."""
    from unittest import mock

    import torch

    import burst_attn_tpu_torch.models.transformer as tr

    k = cfg.moe_top_k
    margins = []
    real = tr.moe_shard

    def recorded(p, x, **kw):
        top = torch.topk(x.float() @ p.router.float(), k + 1, dim=-1).values
        margins.append(top[:, k - 1] - top[:, k])
        return real(p, x, **kw)

    agree = total = 0
    out_gaps = []
    with mock.patch.object(tr, "moe_shard", recorded):
        for p, out in zip(prompts, toks):
            margins.clear()
            a, t, gaps = agreement(cfg, params, [p], [out], device)
            agree, total = agree + a, total + t
            m = torch.stack(margins).amin(dim=0)  # over the layers
            out_gaps += [(i, g, float(m[len(p) - 1 + i])) for i, g in gaps]
    return agree, total, out_gaps


def check_moe_agreement(what, res):
    """check_agreement for a bf16 MoE stream: >= MIN_AGREE_BF16, and each
    disagreement a near tie of the logits (<= TIE_GAP) or of the router
    at that token (<= ROUTER_TIE)."""
    agree, total, gaps = res
    shown = [(i, round(g, 4), round(m, 4)) for i, g, m in gaps]
    print(f"{what}: teacher-forced agreement with the dense MoE forward "
          f"{agree}/{total} = {agree / total:.4f}; disagreements (index, "
          f"logit gap, router margin) {shown}", flush=True)
    assert agree / total >= MIN_AGREE_BF16, what
    assert all(g <= TIE_GAP or m <= ROUTER_TIE for _, g, m in gaps), \
        (what, gaps)


def _moe_params(cfg, seed, device):
    """init_params' tree for an MoE `cfg` (norm scales of ones, matrices
    normal(std 0.02), the router fp32), drawn in fp32 on the card from a
    torch generator seeded with `seed` and cast to cfg.dtype: the same
    seed gives the fp32 and bf16 models the same weights.  (numpy's init
    of the 1.6 B expert weights takes ~20 s of host time.)"""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    d, nh, nkv, hd, f, e = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, cfg.d_ff, cfg.n_experts)

    def w(*shape, dtype=cfg.dtype):
        return (torch.randn(*shape, generator=g, device=device)
                * 0.02).to(dtype)

    def ones():
        return torch.ones(d, dtype=torch.float32, device=device)

    layers = [{"attn_norm": ones(), "wq": w(d, nh, hd), "wk": w(d, nkv, hd),
               "wv": w(d, nkv, hd), "wo": w(nh, hd, d), "mlp_norm": ones(),
               "router": w(d, e, dtype=torch.float32),
               "w_gate": w(e, d, f), "w_up": w(e, d, f),
               "w_down": w(e, f, d)} for _ in range(cfg.n_layers)]
    return {"embed": w(cfg.vocab, d), "layers": layers,
            "final_norm": ones(), "lm_head": w(cfg.vocab, d)}


_MOE_PARAMS = {}


def _moe_serve_model(dtype, device):
    """(cfg, params) of the MoE serving model: SERVE_DIMS with MOE at
    capacity factor MOE_SERVE_CF, seed 0; made once per dtype."""
    from burst_attn_tpu_torch.models.transformer import ModelConfig

    cfg = ModelConfig(**SERVE_DIMS, **MOE, moe_capacity_factor=MOE_SERVE_CF,
                      dtype=dtype, batch_axis=None, head_axis=None)
    if dtype not in _MOE_PARAMS:
        _MOE_PARAMS[dtype] = _moe_params(cfg, 0, device)
    return cfg, _MOE_PARAMS[dtype]


def serve_timings(cfg, params, device):
    """serve_engine_phase's ServeEngine timing on (cfg, params): one
    2048-token prefill (host ms), then decode steps with all SLOTS slots
    live at ~2K context (host ms a step, and a profiled step)."""
    import numpy as np

    from burst_attn_tpu_torch.models.serve import ServeEngine

    eng = ServeEngine(params, cfg, slots=SLOTS, n_pages=N_PAGES, page=PAGE,
                      max_pages_per_seq=MAX_PAGES, device=device)
    long_prompt = np.random.default_rng(9).integers(
        1, cfg.vocab, size=2048, dtype=np.int32)

    def one_prefill():
        eng.submit(long_prompt, 1)
        eng.step()

    out = dict(prefill_ms=host_ms(one_prefill))
    for _ in range(SLOTS):
        eng.submit(long_prompt[:2048 - 64], 64)
    eng.step()
    n_steps = 16
    out["decode_step_ms"] = host_ms(lambda: [eng.step()
                                             for _ in range(n_steps)],
                                    repeats=1) / n_steps
    out["prof_step"] = device_breakdown(eng.step, 4)
    eng.drain()
    return out


def _graph_vs_eager(cfg, params, device, k=K_PIPE):
    """multi_step_decode's CUDA graph of k decode ticks against k eager
    pipelined ticks from the same paged state (two slots decoding after a
    prefill tick): the same choices and lengths.  Returns the ragged
    launches a replay made."""
    import torch

    from burst_attn_tpu_torch.models import paged_decode as pd
    from burst_attn_tpu_torch.ops import ragged_paged as rp
    from burst_attn_tpu_torch.serving import model as sm

    st, _ = pd.init_paged_state(cfg, slots=3, n_pages=8, page=PAGE,
                                max_pages_per_seq=3, device=device)
    for slot, row in ((0, [1, 2, 3]), (1, [4, 5, 6])):
        sm.assign_pages(st, slot, row)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab, (3, 100), generator=g).to(device)
    q_lens = torch.tensor([100, 37, 0], dtype=torch.int32, device=device)
    with torch.no_grad():
        logits, _ = sm.ragged_model_step(params, toks, q_lens, st, cfg)
        first = logits.argmax(-1)
        live = torch.tensor([1, 1, 0], dtype=torch.int32, device=device)
        lengths = st.lengths.clone()
        feed, rows = first, []
        for _ in range(k):
            feed, _ = sm.pipelined_tick(params, feed[:, None], live, st,
                                        None, cfg)
            rows.append(feed)
        eager, eager_len = torch.stack(rows), st.lengths.clone()
        graphs = sm.DecodeGraphs(params, st, cfg, None)
        moved = []
        for _ in range(2):  # the first call captures, both replay
            st.lengths.copy_(lengths)
            before = rp.ragged_paged_attention.launches
            choices, _, _ = sm.multi_step_decode(params, first, live, st,
                                                 None, cfg, k=k,
                                                 graphs=graphs)
            torch.cuda.synchronize()
            assert torch.equal(choices, eager), (choices, eager)
            assert torch.equal(st.lengths, eager_len)
            moved.append(rp.ragged_paged_attention.launches - before)
    assert graphs.captures == 1 and graphs.replays == 2, graphs
    assert moved[1] == k * cfg.n_layers, moved
    return moved[1]


def moe_serve_phase(device, serve_res, rag, hand):
    """The MoE serving model (SERVE_DIMS, 8 experts, top-2) through both
    engines on MOE_REQUESTS of the seeded requests: bf16 (the 95% and
    near-tie bar against the dense MoE forward) and fp32 (token-exact
    with it, the two engines equal); the pipelined engine at K=4 (fp32,
    token-exact with the synchronous engine) and its graph replay against
    4 eager ticks; one early-exit draft round per request (fp32,
    token-exact with the plain engine); exact launches of kernels 1, 6
    and 7; decode tick, mixed tick and TTFT beside the dense model's of
    this run (serve_res, rag).  Then dist_generate of the MoE model at
    HANDOFF_PROMPT_FP32 tokens over sp=HANDOFF_SP, fp32, token-exact
    across the fused and the scan route (kernel 8 / kernel 1, exact
    launches).  MoE routing is plain PyTorch, as in JAX."""
    import dataclasses

    import numpy as np
    import torch

    from burst_attn_tpu_torch.models.dist_decode import dist_generate
    from burst_attn_tpu_torch.models.serve import ServeEngine
    from burst_attn_tpu_torch.ops import flash, fused_ring
    from burst_attn_tpu_torch.ops import paged_attention as pa
    from burst_attn_tpu_torch.ops import ragged_paged as rp
    from burst_attn_tpu_torch.parallel.mesh import Mesh
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    t0 = time.perf_counter()
    counters = (flash.flash_fwd, pa.paged_decode_attention,
                rp.ragged_paged_attention)
    kw = dict(slots=SLOTS, n_pages=N_PAGES, page=PAGE,
              max_pages_per_seq=MAX_PAGES, device=device)
    n_req = MOE_REQUESTS
    res = {"launches": dict.fromkeys(("flash_fwd", "paged_decode_attention",
                                      "ragged_paged_attention"), 0)}

    def add(launches):
        for k_, v in launches.items():
            res["launches"][k_] += v

    toks = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        cfg, params = _moe_serve_model(dtype, device)
        prompts, budgets = requests(cfg, seed=3, n_requests=n_req,
                                    len_hi=1024, new_lo=16, new_hi=32)
        n_gen = sum(budgets)
        min_steps = -(-(n_gen - n_req) // SLOTS)
        eng = ServeEngine(params, cfg, **kw)
        t_s, l_s, run_s = drive(eng, prompts, budgets, counters)
        assert eng.pool.available == N_PAGES - 1, "pool did not drain"
        assert l_s["flash_fwd"] == cfg.n_layers * n_req, l_s
        assert l_s["ragged_paged_attention"] == 0, l_s
        assert l_s["paged_decode_attention"] % cfg.n_layers == 0, l_s
        assert l_s["paged_decode_attention"] >= cfg.n_layers * min_steps
        eng = RaggedServeEngine(params, cfg, chunk=CHUNK, **kw)
        t_r, l_r, run_r = drive(eng, prompts, budgets, counters)
        assert eng.pool.available == N_PAGES - 1, "pool did not drain"
        ticks = sum(v for k_, v in eng.stats.items()
                    if k_.startswith("serve.ragged_batch_launches"))
        assert not any(k_.startswith("burst.fused_fallback")
                       for k_ in eng.stats), dict(eng.stats)
        assert l_r == {"flash_fwd": 0, "paged_decode_attention": 0,
                       "ragged_paged_attention": cfg.n_layers * ticks}, \
            (l_r, ticks)
        if name == "bf16":
            add(l_s)
            add(l_r)
        for eng_name, t in (("ServeEngine", t_s), ("RaggedServeEngine", t_r)):
            if name == "bf16":
                check_moe_agreement(f"MoE {eng_name} bf16", moe_agreement(
                    cfg, params, prompts, t, device))
            else:
                check_agreement(f"MoE {eng_name} fp32", agreement(
                    cfg, params, prompts, t, device), False)
        print(f"moe serve {name}: {n_req} requests, {n_gen} tokens; "
              f"ServeEngine {run_s:.2f} s, launches {l_s}; "
              f"RaggedServeEngine {run_r:.2f} s, {ticks} ticks, launches "
              f"{l_r}", flush=True)
        toks[name] = (t_s, t_r, prompts, budgets)
    t_s, t_r, prompts, budgets = toks["fp32"]
    assert t_s == t_r, "fp32 MoE engines disagree"
    agree = {k_: sum(a == b for a, b in zip(*toks[k_][:2]))
             for k_ in ("bf16", "fp32")}
    print(f"moe serve: the engines' streams identical bf16 "
          f"{agree['bf16']}/{n_req}, fp32 {agree['fp32']}/{n_req} (fp32 "
          f"token-exact with the dense MoE forward)", flush=True)

    # the pipelined engine at K=4 (fp32): token-exact with the synchronous
    cfg, params = _moe_serve_model(torch.float32, device)
    eng = RaggedServeEngine(params, cfg, chunk=CHUNK, pipeline=True,
                            multi_step=K_PIPE, **kw)
    t_p, l_p, _ = drive(eng, prompts, budgets, counters)
    assert eng.pool.available == N_PAGES - 1 and eng._pending is None
    assert t_p == t_r, "pipelined MoE engine differs from the synchronous"
    assert l_p["ragged_paged_attention"] == \
        cfg.n_layers * _device_ticks(eng) > 0, (l_p, dict(eng.stats))
    captures, replays = eng.graphs.captures, eng.graphs.replays
    assert captures >= 1 and replays >= 1, (captures, replays)
    cfg16, params16 = _moe_serve_model(torch.bfloat16, device)
    replay_launches = _graph_vs_eager(cfg16, params16, device)
    print(f"moe serve pipelined K={K_PIPE} fp32: token-exact with the "
          f"synchronous engine, ragged launches {l_p}, graph captures "
          f"{captures}, replays {replays}; bf16 graph replay of {K_PIPE} "
          f"ticks equal to {K_PIPE} eager ticks ({replay_launches} kernel-7 "
          f"launches a replay)", flush=True)

    # an early-exit draft (the first SPEC_EXIT_LAYERS layers), fp32: the
    # speculative stream is the plain engine's
    draft_cfg = dataclasses.replace(cfg, n_layers=SPEC_EXIT_LAYERS)
    draft = dict(params, layers=params["layers"][:SPEC_EXIT_LAYERS])
    eng = ServeEngine(params, cfg, draft_params=draft, draft_cfg=draft_cfg,
                      spec_k=SPEC_K, **kw)
    with no_plain_attention():
        t_d, l_d, _ = drive(eng, prompts[:2], budgets[:2], counters)
    rounds = eng.spec_rounds
    assert t_d == t_s[:2], "the MoE draft engine's stream differs"
    assert rounds > 0 and l_d["flash_fwd"] == (
        cfg.n_layers + SPEC_EXIT_LAYERS) * 2, (l_d, rounds)
    assert l_d["paged_decode_attention"] == \
        SPEC_EXIT_LAYERS * (SPEC_K + 1) * rounds, (l_d, rounds)
    assert l_d["ragged_paged_attention"] == cfg.n_layers * rounds, l_d
    res.update(spec_rounds=rounds, spec_acceptance=eng.acceptance_rate,
               spec_launches=l_d)
    print(f"moe serve early-exit draft ({SPEC_EXIT_LAYERS} layers, k "
          f"{SPEC_K}) fp32: token-exact with the plain engine, {rounds} "
          f"rounds, acceptance {eng.acceptance_rate:.4f}, launches {l_d}",
          flush=True)

    # the timings (bf16), by the dense model's procedures of this run
    cfg16, params16 = _moe_serve_model(torch.bfloat16, device)
    st = serve_timings(cfg16, params16, device)
    rt = ragged_timings(device, (cfg16, params16))
    res.update(prefill_ms=st["prefill_ms"],
               decode_step_ms=st["decode_step_ms"],
               ttft_ms=rt["ttft_ms"], decode_tick_ms=rt["decode_tick_ms"],
               mixed_tick_ms=rt["mixed_tick_ms"],
               prof_decode_tick=rt["prof_decode"][:2],
               prof_serve_step=st["prof_step"][:2],
               dense=dict(prefill_ms=serve_res["prefill_ms"],
                          decode_step_ms=serve_res["decode_step_ms"],
                          ttft_ms=rag["ttft_ms"],
                          decode_tick_ms=rag["decode_tick_ms"],
                          mixed_tick_ms=rag["mixed_tick_ms"],
                          prof_decode_tick=rag["prof_decode"][:2]))
    d = res["dense"]
    print(f"moe serve timings bf16 (MoE vs dense {SERVE_DIMS['n_layers']}-"
          f"layer model, ms): ServeEngine prefill 2048 tokens "
          f"{res['prefill_ms']:.2f} vs {d['prefill_ms']:.2f}, decode step "
          f"({SLOTS} slots) {res['decode_step_ms']:.2f} vs "
          f"{d['decode_step_ms']:.2f}; RaggedServeEngine TTFT "
          f"{res['ttft_ms']:.2f} vs {d['ttft_ms']:.2f}, decode tick "
          f"{res['decode_tick_ms']:.2f} vs {d['decode_tick_ms']:.2f} "
          f"(device {res['prof_decode_tick'][1]:.2f} vs "
          f"{d['prof_decode_tick'][1]:.2f}), mixed tick "
          f"{res['mixed_tick_ms']:.2f} vs {d['mixed_tick_ms']:.2f}",
          flush=True)
    print_profile("MoE RaggedServeEngine decode tick", rt["prof_decode"])
    print_profile("MoE ServeEngine decode step", st["prof_step"])

    # dist_generate of the MoE model (fp32): both routes token-exact
    mesh = Mesh({"sp": HANDOFF_SP}, device=device)
    prompt = hand["_fp32_prompt"]
    p = torch.from_numpy(prompt.astype(np.int64))[None].to(device)
    dist = {}
    for backend in ("fused_ring", "auto"):
        dcfg = dataclasses.replace(cfg, layout="zigzag",
                                   attn_backend=backend)
        dc = _kernel_counters()
        for f in dc:
            f.launches = 0
        obs0 = _obs_now()
        with torch.no_grad():
            out = dist_generate(params, p, dcfg, mesh, steps=HANDOFF_STEPS)
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in dc}
        want = ({"flash_fwd": 0, "fused_ring_fwd": cfg.n_layers,
                 "paged_decode_attention": 0} if backend == "fused_ring"
                else {"flash_fwd": cfg.n_layers * HANDOFF_SP * HANDOFF_SP,
                      "fused_ring_fwd": 0, "paged_decode_attention": 0})
        assert launches == want, (backend, launches)
        assert not any(k_.startswith("burst.fused_fallback")
                       for k_ in _obs_since(obs0))
        dist[backend] = ([int(t) for t in out[0]], launches)
    assert dist["fused_ring"][0] == dist["auto"][0], dist
    _stream_check("moe dist_generate fp32", cfg, params, prompt,
                  dist["auto"][0], device, False)
    res.update(dist_launches={b: v[1] for b, v in dist.items()},
               dist_tokens=len(dist["auto"][0]))
    print(f"moe dist_generate fp32 ({len(prompt)}-token prompt, "
          f"sp={HANDOFF_SP}, zigzag): fused and scan routes token-exact "
          f"with each other and the dense MoE forward; launches "
          f"{res['dist_launches']}", flush=True)
    res["seconds"] = time.perf_counter() - t0
    return res


def moe_train_phase(device):
    """make_train_step on the MoE training model: TRAIN_DIMS' widths at
    MOE_TRAIN_LAYERS layers, 8 experts, top-2, capacity factor 1.25
    (JAX's default), bf16, remat, B=1 S=TRAIN_SEQ, weights from
    _moe_params(seed 0): a warm-up and TRAIN_STEPS timed steps (exact
    launches: kernel 1 twice and the fused backward once a layer and
    step), loss finite and falling; the aux loss and dropped share of a
    forward; the MoE layer's own forward and backward times at the step's
    shape (its share of the step); step ms and MFU counting only the
    top-k experts' FLOPs as live work; then fp32 parity at 2 layers and
    S2048 against plain attention, and runner.fit with a resume at one
    layer."""
    import statistics
    from unittest import mock

    import torch

    import burst_attn_tpu_torch.models.transformer as tr
    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.parallel import moe

    t0 = time.perf_counter()
    n_layers = MOE_TRAIN_LAYERS
    cfg = _train_model(n_layers, torch.bfloat16, **MOE)
    tcfg = train.TrainConfig()
    params = _moe_params(cfg, 0, device)
    leaves = list(tr.param_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    state = (params, train._optimizer(params, tcfg))
    n_params = sum(t.numel() for t in leaves)
    e, k, d, f = cfg.n_experts, cfg.moe_top_k, cfg.d_model, cfg.d_ff
    live = n_params - n_layers * 3 * d * f * (e - k)
    batch = train.make_batch(1, cfg, batch=1, seq=TRAIN_SEQ, device=device)
    step = train.make_train_step(cfg, tcfg, device=device)
    losses, times = [], []
    for i in range(1 + TRAIN_STEPS):
        if i == 1:
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = _launches(flash_fwd=2 * n_layers * TRAIN_STEPS,
                     fused=n_layers * TRAIN_STEPS)
    assert launches == want, (launches, want)
    assert all(map(math.isfinite, losses)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    step_ms = statistics.median(times[1:])

    # the aux loss and every layer's dropped share, from one forward
    drops = []
    real = tr.moe_shard

    def recorded(*a, **kw_):
        y, aux, dropped = real(*a, **kw_)
        drops.append(dropped)
        return y, aux, dropped

    with mock.patch.object(tr, "moe_shard", recorded), torch.no_grad():
        _, aux = tr.forward_with_aux(params, batch["tokens"],
                                     batch["positions"], cfg)
    drops = [float(x) for x in drops]
    assert len(drops) == n_layers and math.isfinite(float(aux))

    # one MoE layer at the step's shape: forward, forward + backward, and
    # the expert products alone (the rest is routing, dispatch, combine)
    g = torch.Generator(device=device).manual_seed(41)
    x = torch.randn(TRAIN_SEQ, d, generator=g, device=device).to(cfg.dtype)
    mp = moe.MoEParams(*(params["layers"][0][n].detach()
                         for n in moe.MoEParams._fields))
    cap = moe.capacity_for(TRAIN_SEQ, e, k, cfg.moe_capacity_factor)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: moe.moe_shard(mp, x, top_k=k, capacity=cap),
                         iters=5, warmup=1)
        r = moe.route(x, mp.router, k, cap)
        h = moe.dispatch(x, r)
        gemm_ms = time_ms(lambda: moe.expert_mlp(mp.w_gate, mp.w_up,
                                                 mp.w_down, h),
                          iters=5, warmup=1)
    xg = x.detach().requires_grad_(True)
    mg = moe.MoEParams(*(t.detach().requires_grad_(True) for t in mp))

    def fwd_bwd():
        y, aux_, _ = moe.moe_shard(mg, xg, top_k=k, capacity=cap)
        torch.autograd.grad(y.float().square().mean() + aux_,
                            [xg, *mg])

    fb_ms = time_ms(fwd_bwd, iters=3, warmup=1)
    # a layer's MoE in a remat step: the forward, its recompute, the
    # backward
    moe_step_ms = n_layers * (fwd_ms + fb_ms)
    attn_flops = (n_layers * 3.5 * 4 * TRAIN_SEQ * TRAIN_SEQ
                  * TRAIN_DIMS["n_heads"] * TRAIN_DIMS["d_head"] / 2)
    flops = 6.0 * live * TRAIN_SEQ + attn_flops
    res = dict(n_params=n_params, live_params=live, seq=TRAIN_SEQ,
               n_layers=n_layers, losses=losses, step_ms=step_ms,
               step_ms_all=times[1:],
               tokens_per_s=TRAIN_SEQ / (step_ms / 1e3),
               model_tflops_per_s=flops / (step_ms / 1e3) / 1e12,
               mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
               launches=launches,
               launches_per_step={k_: v // TRAIN_STEPS
                                  for k_, v in launches.items() if v},
               aux=float(aux), dropped=drops, capacity=cap,
               slot_rows_per_live_row=e * cap / (TRAIN_SEQ * k),
               moe_layer_fwd_ms=fwd_ms, moe_layer_fwd_bwd_ms=fb_ms,
               moe_expert_gemm_fwd_ms=gemm_ms,
               moe_share_of_step=moe_step_ms / step_ms, peak_gb=peak_gb)
    res["prof"] = device_breakdown(lambda: step(state, batch), 1, top=8)
    print(f"moe train step ({n_params / 1e9:.3f} B parameters, "
          f"{live / 1e9:.3f} B live at top-{k} of {e}, {n_layers} layers, "
          f"bf16, remat, B=1 S={TRAIN_SEQ}, capacity {cap} a expert): "
          f"{step_ms:.1f} ms (median of {TRAIN_STEPS}: "
          f"{[round(t_, 1) for t_ in times[1:]]}), "
          f"{res['tokens_per_s']:.0f} tokens/s, MFU {res['mfu']:.4f} "
          f"(live FLOPs: only the top-{k} experts' products count); losses "
          f"{[round(x_, 4) for x_ in losses]}; aux {float(aux):.4f}, "
          f"dropped share by layer {[round(x_, 4) for x_ in drops]}; "
          f"launches per step {res['launches_per_step']}; peak "
          f"{peak_gb:.1f} GB", flush=True)
    print(f"moe layer at the step's shape (T {TRAIN_SEQ}, bf16): forward "
          f"{fwd_ms:.3f} ms (expert products {gemm_ms:.3f}, routing, "
          f"dispatch and combine the rest), forward + backward "
          f"{fb_ms:.3f} ms; {n_layers} layers' forward, recompute and "
          f"backward {moe_step_ms:.1f} ms = {res['moe_share_of_step']:.3f} "
          f"of the step", flush=True)
    print_profile("moe train step", res["prof"])
    del state, params, leaves, batch
    torch.cuda.empty_cache()
    res["parity"] = train_parity(device, **MOE)
    # fit with a checkpoint and a resume, one MoE layer at full width
    res["fit"] = runner_phase(device, n_layers=1, **MOE)
    res["seconds"] = time.perf_counter() - t0
    return res


def ulysses_rows(device):
    """Kernels 1 and 2-3 at the shape each Ulysses position gives them,
    B1 N4 S8192 D128 bf16 causal: held against their plain versions, with
    times, bounds and SDPA's time (kernels-line records
    flash_fwd[ulysses] and flash_bwd_fused[ulysses])."""
    import torch
    import torch.nn.functional as F

    from burst_attn_tpu_torch.ops import flash, tile

    n = TRAIN_DIMS["n_heads"] // ULYSSES_SP
    fwd = check_flash(device, n=n, n_kv=n, s=TRAIN_SEQ, seed=33)
    fwd["name"] = "flash_fwd[ulysses]"
    torch.cuda.empty_cache()
    args = _bwd_inputs(device, torch.bfloat16, n, n, TRAIN_SEQ, True,
                       seed=34)
    do, q, k, v, delta, lse, _, _ = args
    want = tile.tile_bwd(*args)
    got = flash.flash_bwd(*args, triangular=True)
    errs = _bwd_errs(got, want, "flash_bwd[ulysses]")
    del got, want
    torch.cuda.empty_cache()
    ms = time_ms(lambda: flash.flash_bwd(*args, triangular=True), iters=10,
                 warmup=2)
    plain_ms = time_ms(lambda: tile.tile_bwd(*args), iters=2, warmup=1)
    torch.cuda.empty_cache()
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), do,
                                                 retain_graph=True),
                     iters=10, warmup=2)
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    esz = q.element_size()
    reads = esz * 2 * (q.numel() + k.numel()) + 4 * 2 * delta.numel()
    bms, by = bound_ms(reads + 4 * (q.numel() + 2 * k.numel()),
                       5 * 2 * pairs * n * q.shape[-1])
    bwd = dict(name="flash_bwd_fused[ulysses]", route="cuda",
               source="burst_attn_tpu_torch/csrc/flash_bwd.cu",
               replaces="burst_attn_tpu/ops/pallas_flash.py:1379 "
                        "(_bwd_fused_tri_kernel)",
               max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=lib_ms)
    del args, do, q, k, v, delta, lse, o, qr, kr, vr
    torch.cuda.empty_cache()
    for rec in (fwd, bwd):
        print(f"{rec['name']} at B1 N{n}/{n} S={TRAIN_SEQ} D128 bf16 causal:"
              f" {rec['ms']:.4f} ms (plain {rec['plain_ms']:.2f}, SDPA "
              f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} by "
              f"{rec['bound_by']}), max_abs_err {rec['max_abs_err']:.3e}",
              flush=True)
    return [fwd, bwd]


def ulysses_train_phase(device, single, ring_tr):
    """make_train_step with attn_strategy="ulysses" (layout contig) on
    train_smoke's 16-layer model, bf16, remat, B=1 S=TRAIN_SEQ over
    {"sp": ULYSSES_SP} (the positions share the card), the seed-0 weights
    and batch of the single-device step: a warm-up and TRAIN_STEPS timed
    steps with exact launches (each position's kernel 1 twice a layer on
    its N/W heads over all S tokens, its fused backward once), losses
    finite and falling, the first two within CONTROL_RTOL of the single
    device's; one windowed (TRAIN_WINDOW) and one packed step with their
    WIN / SEG launches; step ms beside one device and both rings of this
    run; fp32 parity against one device at 2 layers, S2048; runner.fit
    with a resume and the evaluator on the mesh."""
    import dataclasses
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.ops import flash

    t0 = time.perf_counter()
    w = ULYSSES_SP
    mesh = {"sp": w}
    n_layers = TRAIN_DIMS["n_layers"]
    cfg = _train_model(n_layers, torch.bfloat16, attn_strategy="ulysses",
                       layout="contig")
    tcfg = train.TrainConfig()
    state = _seed_state(cfg, tcfg, device)
    batch = train.make_batch(1, cfg, mesh, batch=1, seq=TRAIN_SEQ,
                             device=device)
    step = train.make_train_step(cfg, tcfg, mesh, device=device)
    losses, times = [], []
    for i in range(1 + TRAIN_STEPS):
        if i == 1:
            _reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m = step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = _counts()
    per_step = dict(flash_fwd=2 * n_layers * w, fused=n_layers * w)
    want = _launches(**{k: v * TRAIN_STEPS for k, v in per_step.items()})
    assert launches == want, (launches, want)
    assert all(map(math.isfinite, losses)), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    diffs = [abs(a - b) / abs(b) for a, b in zip(losses, single["losses"])]
    assert max(diffs[:2]) <= CONTROL_RTOL, (losses, single["losses"])
    step_ms = statistics.median(times[1:])
    prof = device_breakdown(lambda: step(state, batch), 1, top=8)
    res = dict(mesh=mesh, step_ms=step_ms, step_ms_all=times[1:],
               losses=losses, rel_diff_vs_single=diffs[:2],
               tokens_per_s=TRAIN_SEQ / (step_ms / 1e3),
               mfu=single["mfu"] * single["step_ms"] / step_ms,
               launches=launches, launches_per_step=per_step,
               prof=prof[:2],
               single_step_ms=single["step_ms"],
               ring_step_ms={b: r["step_ms"] for b, r in ring_tr.items()})
    print(f"ulysses train step (mesh {mesh}, contig, bf16, B=1 "
          f"S={TRAIN_SEQ}): {step_ms:.1f} ms (median of {TRAIN_STEPS}: "
          f"{[round(t_, 1) for t_ in times[1:]]}) vs one device "
          f"{single['step_ms']:.1f}, fused ring "
          f"{ring_tr['fused_ring']['step_ms']:.1f}, scan ring "
          f"{ring_tr['auto']['step_ms']:.1f}; MFU {res['mfu']:.4f}; losses "
          f"{[round(x, 4) for x in losses]} (single device rel diffs "
          f"{[float(f'{x:.2e}') for x in diffs]}); launches per step "
          f"{per_step}", flush=True)
    print_profile("ulysses train step", prof)

    # one windowed and one packed step: the WIN and SEG instances
    shape = (1, TRAIN_DIMS["n_heads"] // w, TRAIN_SEQ, TRAIN_DIMS["d_head"])
    route = flash.bwd_route(shape, shape, window=TRAIN_WINDOW)
    wcfg = dataclasses.replace(cfg, window=TRAIN_WINDOW)
    extra = {}
    for what, c, b, tag, rt in (
            ("windowed", wcfg, batch, "win", route),
            ("packed", cfg, train.make_packed_batch(
                PACKED_SEED, cfg, mesh, batch=1, seq=TRAIN_SEQ,
                device=device), "seg", "fused")):
        s_ = train.make_train_step(c, tcfg, mesh, device=device)
        _reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, m = s_(state, b)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        got = _counts()
        want = {"flash_fwd": 2 * n_layers * w,
                f"flash_fwd_{tag}": 2 * n_layers * w}
        for r in (("dq", "dkdv") if rt == "split" else (rt,)):
            want.update({r: n_layers * w, f"{r}_{tag}": n_layers * w})
        assert got == _launches(**want), (what, got, want)
        assert math.isfinite(loss), (what, loss)
        extra[what] = dict(loss=loss, step_ms=ms, launches=want)
        print(f"ulysses {what} train step: {ms:.1f} ms (one step, "
              f"untimed warm-up), loss {loss:.4f}, launches {want}",
              flush=True)
    res.update(extra)
    del state, batch
    torch.cuda.empty_cache()
    res["parity"] = ring_train_parity(
        device, routes={"ulysses": dict(attn_strategy="ulysses",
                                        layout="contig")}, sp=w)
    # fit with a checkpoint, a resume and the evaluator, on the sp=4 mesh
    res["fit"] = runner_phase(device, mesh=mesh, attn_strategy="ulysses",
                              layout="contig")
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# the pipeline-parallel model: make_train_step on a pp mesh (stages sharing
# the card, GPipe microbatches), at the training model's full width

PP_B, PP_SEQ = 4, 2048  # the single-device step's 8192 tokens, 4 rows
PP_LAYERS = 8  # half the training model's depth (cut to free the
# multihost phase's seconds: the pp steps and their control halve)
PP_CASES = (  # (name, mesh, microbatches, attention backend)
    ("pp4", {"pp": 4, "sp": 1}, 4, "auto"),
    ("pp2 x sp2", {"pp": 2, "sp": 2}, 2, "fused_ring"),
)


def _pp_state(cfg, tcfg, device):
    """(params, optimizer) of a pp model: _seed_state's seed-0 weights of
    the regular model of the same shape, its layers stacked."""
    import dataclasses

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import layer_keys

    base = dataclasses.replace(cfg, pp_axis=None, pp_microbatches=1)
    params, _ = _seed_state(base, tcfg, device)
    layers = params["layers"]
    stacked = {k: torch.stack([x[k].detach() for x in layers])
               for k in layer_keys(layers[0])}
    del layers
    params = dict(params, layers=stacked)
    for k in ("embed", "final_norm", "lm_head"):
        params[k] = params[k].detach().requires_grad_(True)
    for t in stacked.values():
        t.requires_grad_(True)
    return params, train._optimizer(params, tcfg)


def pp_train_phase(device):
    """make_train_step on the pipeline-parallel model at train_smoke's
    width and PP_LAYERS layers (bf16, remat), B=PP_B S=PP_SEQ (the
    single-device step's 8192 tokens), the seed-0 weights' first PP_LAYERS
    layers (_seed_state) and one batch:
    one device (the control, B4 in one launch a layer), then PP_CASES:
    pp=4 x sp=1 at 4 microbatches (kernel 1 twice and the fused backward
    once a layer a microbatch) and pp=2 x sp=2 at 2 microbatches on the
    fused ring (kernel 8 twice and kernel 9 once a layer a microbatch);
    each a warm-up and TRAIN_STEPS timed steps with exact launches, losses
    finite and falling, the first two within CONTROL_RTOL of the one
    device's; a profiled step each (device ms, busy share); one pp=4 step
    through the split backward (kernels 4-5); fp32 parity at 2 layers
    against one device (pp_train_parity); runner.fit with a stacked
    checkpoint and a resume on {"pp": 2, "sp": 2}."""
    import dataclasses
    import statistics

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.transformer import param_leaves

    t0 = time.perf_counter()
    n_layers = PP_LAYERS
    tcfg = train.TrainConfig()
    base = _train_model(n_layers, torch.bfloat16)
    tokens = PP_B * PP_SEQ
    attn_flops = (n_layers * 3.5 * 4 * PP_SEQ * PP_SEQ * PP_B
                  * TRAIN_DIMS["n_heads"] * TRAIN_DIMS["d_head"] / 2)
    out = {}
    runs = [("one device", None, 1, "auto")] + list(PP_CASES)
    for name, mesh, m, backend in runs:
        cfg = (base if mesh is None else dataclasses.replace(
            base, pp_axis="pp", pp_microbatches=m, attn_backend=backend))
        state = (_seed_state(cfg, tcfg, device) if mesh is None
                 else _pp_state(cfg, tcfg, device))
        batch = train.make_batch(1, cfg, mesh, batch=PP_B, seq=PP_SEQ,
                                 device=device)
        step = train.make_train_step(cfg, tcfg, mesh, device=device)
        obs0 = _obs_now()
        losses, times = [], []
        for i in range(1 + TRAIN_STEPS):
            if i == 1:
                _reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, met = step(state, batch)
            losses.append(float(met["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        launches = _counts()
        per = n_layers * m  # a layer a microbatch
        per_step = ({"fused_ring_fwd": 2 * per, "fused_ring_bwd": per}
                    if backend == "fused_ring"
                    else {"flash_fwd": 2 * per, "fused": per})
        want = _launches(**{k: v * TRAIN_STEPS for k, v in per_step.items()})
        assert launches == want, (name, launches, want)
        assert not any(key.startswith("burst.fused_fallback")
                       for key in _obs_since(obs0)), dict(_obs_since(obs0))
        assert all(map(math.isfinite, losses)), (name, losses)
        assert losses[-1] < losses[0], f"{name}: loss did not fall: {losses}"
        if mesh is not None:
            one = out["one device"]["losses"]
            diffs = [abs(a - b) / abs(b) for a, b in zip(losses, one)]
            assert max(diffs[:2]) <= CONTROL_RTOL, (name, losses, one)
        else:
            diffs = [0.0, 0.0]
            n_params = sum(t.numel() for t in param_leaves(state[0]))
        step_ms = statistics.median(times[1:])
        prof = device_breakdown(lambda: step(state, batch), 1, top=8)
        flops = 6.0 * n_params * tokens + attn_flops
        res = dict(mesh=mesh, microbatches=m, step_ms=step_ms,
                   step_ms_all=times[1:], losses=losses,
                   rel_diff_vs_one_device=diffs[:2],
                   tokens_per_s=tokens / (step_ms / 1e3),
                   mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
                   launches=launches, launches_per_step=per_step,
                   profiled_step_ms=prof[0], device_ms=prof[1],
                   busy=prof[1] / prof[0])
        if name == "pp4":  # one step through the split backward
            with split_train_backward():
                _reset_counts()
                _, met = step(state, batch)
                split_loss = float(met["loss"])
                split_launches = _counts()
            want = _launches(flash_fwd=2 * per, dq=per, dkdv=per)
            assert split_launches == want, (split_launches, want)
            assert math.isfinite(split_loss)
            res.update(split_launches=split_launches, split_loss=split_loss)
        out[name] = res
        print(f"pp train step ({name}, mesh {mesh}, {m} microbatches, "
              f"{backend}, bf16, B={PP_B} S={PP_SEQ}, {n_layers} layers): "
              f"{step_ms:.1f} ms (median of {TRAIN_STEPS}: "
              f"{[round(t_, 1) for t_ in times[1:]]}), "
              f"{res['tokens_per_s']:.0f} tokens/s, MFU {res['mfu']:.4f}; "
              f"losses {[round(x, 4) for x in losses]} (one-device rel "
              f"diffs {[float(f'{x:.2e}') for x in diffs[:2]]}); launches "
              f"per step {per_step}", flush=True)
        print_profile(f"pp train step, {name}", prof)
        del state, batch, step
        torch.cuda.empty_cache()
    out["parity"] = pp_train_parity(device)
    out["fit"] = runner_phase(device, mesh={"pp": 2, "sp": 2}, batch=2,
                              pp_axis="pp", pp_microbatches=2)
    out["seconds"] = time.perf_counter() - t0
    return out


def pp_train_parity(device, n_layers=2, seq=2048, b=2):
    """One step's loss and gradients at full width, fp32, B2 S2048: the pp
    model at 2 microbatches on {"pp": 2, "sp": 1} (kernel 1, the fused
    backward) and on {"pp": 2, "sp": 2} through the fused ring (kernels 8
    and 9), each against the single-device kernels on the same weights
    and tokens: loss within LOSS_RTOL, every gradient within GRAD_RTOL of
    its largest entry."""
    import dataclasses

    import torch

    from burst_attn_tpu_torch.models import train
    from burst_attn_tpu_torch.models.pipeline_lm import stack_layers
    from burst_attn_tpu_torch.models.transformer import (
        init_params, layer_keys, param_leaves,
    )

    base = _train_model(n_layers, torch.float32)
    params = init_params(base, seed=0, device=device)

    def loss_grads(cfg, mesh, p):
        leaves = list(param_leaves(p))
        for t in leaves:
            t.requires_grad_(True)
        batch = train.make_batch(2, cfg, mesh, batch=b, seq=seq,
                                 device=device)
        loss = train.loss_fn(p, batch["tokens"], batch["positions"],
                             batch["labels"], cfg, mesh)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    loss_1, grads_1 = loss_grads(base, None, params)
    # the regular leaves by layer, stacked per key as the pp leaves are
    keys = layer_keys(params["layers"][0])
    per_layer = grads_1[1:-2]
    want = ([grads_1[0]]
            + [torch.stack(per_layer[j::len(keys)]) for j in range(len(keys))]
            + list(grads_1[-2:]))
    names = ["embed"] + [f"layers.{k}" for k in keys] + ["final_norm",
                                                         "lm_head"]
    stacked = dict(params, layers=stack_layers(
        [{k: t.detach() for k, t in x.items()} for x in params["layers"]]))
    res = {}
    for name, mesh, backend in (("pp2", {"pp": 2, "sp": 1}, "auto"),
                                ("pp2 x sp2", {"pp": 2, "sp": 2},
                                 "fused_ring")):
        cfg = dataclasses.replace(base, pp_axis="pp", pp_microbatches=2,
                                  attn_backend=backend)
        p = {k: (v.detach().clone() if k != "layers" else
                 {kk: t.detach().clone() for kk, t in v.items()})
             for k, v in stacked.items()}
        _reset_counts()
        loss_p, grads_p = loss_grads(cfg, mesh, p)
        launches = _counts()
        loss_err = abs(loss_p - loss_1) / abs(loss_1)
        assert loss_err <= LOSS_RTOL, (name, loss_p, loss_1)
        worst = (0.0, "")
        for nm, a, w_ in zip(names, grads_p, want):
            ref = float(w_.abs().max())
            err = _max_err(a, w_)
            assert err <= GRAD_RTOL * ref + 1e-12, \
                f"pp {name} gradient {nm}: {err:.3e} of max {ref:.3e}"
            worst = max(worst, (err / max(ref, 1e-30), nm))
        print(f"pp train parity fp32 ({name}, mesh {mesh}, 2 microbatches, "
              f"{n_layers} layers at full width, B{b} S={seq}): loss "
              f"{loss_p:.6f} vs {loss_1:.6f} (one device), rel err "
              f"{loss_err:.2e}; worst gradient error {worst[0]:.2e} of its "
              f"largest entry ({worst[1]}); launches {launches}", flush=True)
        res[name] = dict(loss_rel_err=loss_err, grad_rel_err=worst[0],
                         grad_worst=worst[1])
    del params, stacked
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# int8 / fp8 ring payloads (wire_dtype): kernels 8 and 9's WIRE instances

WIRE_DTYPES = ("int8", "fp8")
# tests/test_wire_quant.py's tolerances against the dense ring (l.48-49)
WIRE_TOL_FWD = {"int8": 0.04, "fp8": 0.2}
WIRE_TOL_GRAD = {"int8": 0.25, "fp8": 1.5}
# kernel 9 against its plain version under a wire dtype.  The wrapper
# quantizes the bundle once, so both read the same codes: dk and dv differ
# by summation order alone and are held to BWD_RTOL, as the dense
# instances.  dq's partial is re-quantized per 64-row q tile at every hop,
# and the two sum it in another order, so a code can flip at a rounding
# boundary: each q tile of dq within WIRE_DQ_CODES codes of that tile's
# own scale, one code being the step at the tile's largest entry (1/127
# of it for int8; 32/448 for fp8, e4m3's spacing at the top of its range;
# tests/test_torch_cuda.py holds the same)
WIRE_DQ_STEP = {"int8": 1 / 127, "fp8": 32 / 448}
# the largest readings on an H100 (the card tests and the smoke): 2.0 codes
# int8 (two hops each flipping one), 1.5 fp8; the limit about twice that
WIRE_DQ_CODES = {"int8": 4, "fp8": 3}


def _wire_bwd_errs(got, want, wire, what):
    """Assert kernel 9's WIRE (dq, dk, dv) match the plain ones: dk, dv
    within BWD_RTOL (_bwd_errs), dq per 64-row q tile within
    WIRE_DQ_CODES codes of the tile's scale + BWD_ATOL.  Returns (the
    three max-abs errors, dq's largest tile error in codes)."""
    import torch

    errs = [_max_err(got[0], want[0])] + _bwd_errs(
        got[1:], want[1:], what)[:2]
    s = want[0].shape[-2]
    nqt = -(-s // 64)
    err = (got[0].float() - want[0].float()).abs()
    ref = want[0].float().abs()
    if nqt * 64 != s:
        err, ref = (torch.nn.functional.pad(t, (0, 0, 0, nqt * 64 - s))
                    for t in (err, ref))
    err, ref = (t.unflatten(-2, (nqt, 64)).amax((-2, -1))
                for t in (err, ref))
    step = WIRE_DQ_STEP[wire] * ref
    codes = float((err / step.clamp_min(1e-30)).max())
    bad = int((err > WIRE_DQ_CODES[wire] * step + BWD_ATOL).sum())
    assert not bad, (f"{what} dq: {bad} q tiles beyond "
                     f"{WIRE_DQ_CODES[wire]} codes of their scale (largest "
                     f"{codes:.2f} codes)")
    return errs, codes


def _wire_k8_bound(cfg, ring, q, k, lse, pairs, wire):
    """(bound ms, bound_by) of one kernel-8 launch with a wire dtype: q, k,
    v, o (bf16) and lse once, 4 D flops a pair, and every program copy
    (copy-in and sends) of the quantized K+V chunk, read and written."""
    from burst_attn_tpu_torch.ops import fused_ring
    from burst_attn_tpu_torch.parallel import schedule as sched_ir

    w, b, n, s, d = q.shape
    fprog = fused_ring.ring_plan(cfg, *ring, s, "fwd")[0]
    copies = w * (sum(fprog.rows["send0"]) + sum(fprog.rows["send1"])
                  + len(fprog.copy_in))
    chunk = sched_ir.wire_round_bytes("fwd", wire, b=b, n=n,
                                      n_kv=k.shape[2], s=s, d=d)["kv"]
    n_bytes = (2 * 2 * q.numel() + 2 * 2 * k.numel() + 4 * lse.numel()
               + 2 * copies * chunk)
    return bound_ms(n_bytes, 4 * d * pairs)


def wire_phase(device):
    """burst_attn(wire_dtype=) on kernels 8 and 9's WIRE instances at the
    ring train step's shape (B1 N16/16 S_local 2048 D128 bf16, sp=4,
    zigzag), int8 and fp8: the fused route (one launch each, no fallback)
    against the scan ring with the same wire (the forward at the bf16
    O_TOL, the gradients within WIRE_TOL_GRAD) and against the dense fused
    route (WIRE_TOL_FWD / WIRE_TOL_GRAD); each kernel against its own
    plain version (kernel 8 at O_TOL: its dequantized tiles are the plain
    version's; kernel 9's dk, dv within BWD_RTOL and dq within
    WIRE_DQ_CODES codes of each q tile's scale, by head chunks); the
    STATS instance's slot counts equal to the dense run's and quant_absmax
    the positions' max |k|, |v|; the time of a launch of each beside the
    dense launch in turns (dense, int8, fp8, fp8, int8, dense), registers
    and spills, the bound from the quantized schedule.wire_round_bytes.  Then one windowed contig launch pair (the
    windowed ring step's shape, int8) against the scan ring, and one int8
    forward + backward at bench.py's headline shape (B1 N32 S65536 D128,
    sp=8) beside the dense call.  Returns (the kernels-line records
    fused_ring_fwd[wire int8|fp8], fused_ring_bwd[wire int8|fp8], the
    phase's numbers)."""
    import dataclasses

    import torch

    from burst_attn_tpu_torch.ops import fused_ring, fused_ring_bwd, masks
    from burst_attn_tpu_torch.parallel import burst, layouts, mesh

    t_phase = time.perf_counter()
    bf16, d = torch.bfloat16, 128
    w, n = RING_TRAIN_SP, TRAIN_DIMS["n_heads"]
    n_kv, S = TRAIN_DIMS["n_kv_heads"], TRAIN_SEQ
    s = S // w
    g = torch.Generator(device=device).manual_seed(41)
    q, k, v, do = (layouts.to_layout(
        torch.randn(1, h, S, d, generator=g, device=device).to(bf16),
        "zigzag", w, 2) for h in (n, n_kv, n_kv, n))
    kw = dict(mesh={"sp": w}, causal=True, layout="zigzag")
    main_launches = {("fwd", x): 0 for x in WIRE_DTYPES}
    main_launches.update({("bwd", x): 0 for x in WIRE_DTYPES})

    def fwd_bwd(backend, wire, qq=q, kk=k, vv=v, dd=do, **extra):
        """(o, grads) of burst_attn; a fused call with a wire dtype counts
        its launches as the phase's main-path launches."""
        n8 = fused_ring.fused_ring_fwd.wire_launches
        n9 = fused_ring_bwd.fused_ring_bwd.wire_launches
        leaves = [t.detach().requires_grad_() for t in (qq, kk, vv)]
        o = burst.burst_attn(*leaves, backend=backend, wire_dtype=wire,
                             **dict(kw, **extra))
        grads = torch.autograd.grad(o, leaves, dd)
        torch.cuda.synchronize()
        if wire is not None and backend == "fused_ring":
            main_launches["fwd", wire] += (
                fused_ring.fused_ring_fwd.wire_launches - n8)
            main_launches["bwd", wire] += (
                fused_ring_bwd.fused_ring_bwd.wire_launches - n9)
        return o.detach(), grads

    res = {}
    o_d, g_d = fwd_bwd("fused_ring", None)
    cfgs = {x: burst.BurstConfig(causal=True, layout="zigzag",
                                 backend="fused_ring", wire_dtype=x)
            for x in (None,) + WIRE_DTYPES}
    qs, ks, vs, dos = (mesh.shard(t, w) for t in (q, k, v, do))
    prog, tables, _ = fused_ring.ring_plan(cfgs["int8"], 1, w, s, "bwd")
    fprog, ftables, _ = fused_ring.ring_plan(cfgs["int8"], 1, w, s, "fwd")
    pairs = n * sum(masks.spec_pair_count(
        masks.MaskSpec(*map(int, tb[r, :5])), s, s)
        for tb in ftables for r in range(fprog.n_rounds))
    for wire in WIRE_DTYPES:
        obs0 = _obs_now()
        _reset_counts()
        o_f, g_f = fwd_bwd("fused_ring", wire)
        assert _counts() == _launches(fused_ring_fwd=1, fused_ring_bwd=1), \
            _counts()
        o_s, g_s = fwd_bwd("auto", wire)
        assert not any(x.startswith("burst.fused_fallback")
                       for x in _obs_since(obs0)), dict(_obs_since(obs0))
        r = {"fwd_vs_scan": _check_o(f"wire {wire} kernel 8 vs the scan ring",
                                     o_f, o_s, bf16),
             "fwd_vs_dense": _max_err(o_f, o_d),
             "grad_vs_scan": [_max_err(a, b) for a, b in zip(g_f, g_s)],
             "grad_vs_dense": [_max_err(a, b) for a, b in zip(g_f, g_d)]}
        assert r["fwd_vs_dense"] < WIRE_TOL_FWD[wire], r
        assert max(r["grad_vs_scan"]) < WIRE_TOL_GRAD[wire], r
        assert max(r["grad_vs_dense"]) < WIRE_TOL_GRAD[wire], r
        del o_s, g_s, g_f
        # each kernel against its own plain version
        cfg = cfgs[wire]
        o8, lse8 = fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, w)
        assert torch.equal(mesh.unshard(o8), o_f), \
            "kernel 8 alone differs from burst_attn's wire forward"
        t0 = time.perf_counter()
        po, plse = fused_ring.fused_ring_reference(
            qs, ks, vs, fprog, ftables, d ** -0.5, wire=wire)
        torch.cuda.synchronize()
        r["plain_fwd_ms"] = (time.perf_counter() - t0) * 1e3
        r["k8_vs_plain"] = _check_o(f"wire {wire} kernel 8 vs its plain "
                                    "version", o8, po, bf16)
        r["k8_lse_vs_plain"] = _max_err(lse8, plse)
        assert r["k8_lse_vs_plain"] <= STATS_ATOL["bf16"], r
        del po, plse
        got = fused_ring_bwd.fused_ring_bwd(qs, ks, vs, o8, lse8, dos, cfg,
                                            1, w)
        t0 = time.perf_counter()
        want = fused_ring_bwd.fused_ring_bwd_reference(
            qs, ks, vs, o8, lse8, dos, prog, tables, d ** -0.5,
            head_chunk=4, wire=wire)
        torch.cuda.synchronize()
        r["plain_bwd_ms"] = (time.perf_counter() - t0) * 1e3
        r["k9_vs_plain"], r["k9_dq_codes"] = _wire_bwd_errs(
            got, want, wire, f"wire {wire} kernel 9 vs its plain version")
        del got, want
        # slot counts and quant_absmax (the STATS instance)
        _, st = burst.burst_attn(q, k, v, backend="fused_ring",
                                 wire_dtype=wire, collect_stats=True, **kw)
        _, st0 = burst.burst_attn(q, k, v, backend="fused_ring",
                                  collect_stats=True, **kw)
        assert torch.equal(st.slot_use, st0.slot_use), (st.slot_use,
                                                        st0.slot_use)
        want_qam = torch.maximum(ks.float().abs().flatten(1).amax(1),
                                 vs.float().abs().flatten(1).amax(1))
        assert torch.equal(st.quant_absmax, want_qam), (st.quant_absmax,
                                                        want_qam)
        assert float(st0.quant_absmax.abs().max()) == 0.0
        r["slot_use"] = st.slot_use.tolist()
        r["quant_absmax"] = st.quant_absmax.tolist()
        res[wire] = r
        del o8, lse8, o_f
        torch.cuda.empty_cache()
        print(f"wire {wire} at the ring train step's shape (W={w} B1 "
              f"N{n}/{n_kv} S_local {s} bf16 zigzag): kernel 8 vs the scan "
              f"ring with {wire} {r['fwd_vs_scan']:.3e}, vs its plain version "
              f"{r['k8_vs_plain']:.3e} (lse {r['k8_lse_vs_plain']:.3e}), vs "
              f"the dense ring {r['fwd_vs_dense']:.3e}; gradients vs the scan "
              f"ring {[float(f'{x:.3e}') for x in r['grad_vs_scan']]}, "
              f"kernel 9 vs its plain version "
              f"{[float(f'{x:.3e}') for x in r['k9_vs_plain']]} (dq "
              f"{r['k9_dq_codes']:.2f} codes of its q tile's scale at the "
              f"worst tile), vs the dense "
              f"ring {[float(f'{x:.3e}') for x in r['grad_vs_dense']]}; "
              f"slot_use equal to the dense run's; quant_absmax "
              f"{max(r['quant_absmax']):.4f}", flush=True)
    del o_d, g_d
    # a launch of each in turns, beside the dense launch
    o_by, lse_by = {}, {}
    for x in (None,) + WIRE_DTYPES:
        o_by[x], lse_by[x] = fused_ring.fused_ring_fwd(qs, ks, vs, cfgs[x],
                                                       1, w)
    turns = {(kern, x): [] for kern in ("k8", "k9")
             for x in (None,) + WIRE_DTYPES}
    for x in (None, "int8", "fp8", "fp8", "int8", None):
        turns["k8", x].append(time_ms(lambda: fused_ring.fused_ring_fwd(
            qs, ks, vs, cfgs[x], 1, w), iters=10, warmup=2))
        turns["k9", x].append(time_ms(lambda: fused_ring_bwd.fused_ring_bwd(
            qs, ks, vs, o_by[x], lse_by[x], dos, cfgs[x], 1, w), iters=10,
            warmup=2))
    ms = {key: sum(v_) / len(v_) for key, v_ in turns.items()}
    attrs = {"k8": {a["instance"]: a for a in
                    fused_ring.fwd_attrs(wire=True)
                    + fused_ring.fwd_attrs(stats=True, wire=True)
                    + fused_ring.fwd_attrs(win=True, wire=True)
                    + fused_ring.fwd_attrs(stats=True, win=True, wire=True)},
             "k9": {a["instance"]: a for a in
                    fused_ring_bwd.bwd_attrs(wire=True)
                    + fused_ring_bwd.bwd_attrs(win=True, wire=True)}}
    for kern, rows in attrs.items():
        for a in rows.values():
            assert 0 < a["regs"] <= 255 and a["ctas"] >= 1, (kern, a)
            print(f"{'fused_ring_fwd' if kern == 'k8' else 'fused_ring_bwd'}"
                  f" {a['instance']}: {a['regs']} registers, "
                  f"{a['local_bytes']} local (spill) bytes a thread, "
                  f"{a['smem']} B of shared memory, {a['ctas']} CTAs "
                  f"resident", flush=True)
    bounds = {}
    for x in WIRE_DTYPES:
        bounds["k8", x] = _wire_k8_bound(cfgs[x], (1, w), qs, ks,
                                         lse_by[x], pairs, x)
        bounds["k9", x] = _bwd_bound(tables, prog, 1, n, n_kv, s, d, 2,
                                     wire=x)[:2]
    del o_by, lse_by
    torch.cuda.empty_cache()
    print(f"wire kernels at the ring train step's shape, ms a launch (turns "
          f"dense int8 fp8 fp8 int8 dense, mean of 10 each): kernel 8 dense "
          f"{ms['k8', None]:.4f}, int8 {ms['k8', 'int8']:.4f}, fp8 "
          f"{ms['k8', 'fp8']:.4f}; kernel 9 dense {ms['k9', None]:.4f}, int8 "
          f"{ms['k9', 'int8']:.4f}, fp8 {ms['k9', 'fp8']:.4f}; bounds int8 "
          f"{bounds['k8', 'int8'][0]:.4f} ({bounds['k8', 'int8'][1]}) / "
          f"{bounds['k9', 'int8'][0]:.4f} ({bounds['k9', 'int8'][1]}) ms",
          flush=True)

    # one windowed contig launch pair: the windowed ring step's shape
    wg = torch.Generator(device=device).manual_seed(43)
    wq, wk, wv, wdo = (torch.randn(1, h, S, d, generator=wg,
                                   device=device).to(bf16)
                       for h in (n, n_kv, n_kv, n))
    win = dict(layout="contig", window=TRAIN_WINDOW)
    o_wf, g_wf = fwd_bwd("fused_ring", "int8", wq, wk, wv, wdo, **win)
    o_ws, g_ws = fwd_bwd("auto", "int8", wq, wk, wv, wdo, **win)
    o_wd, g_wd = fwd_bwd("fused_ring", None, wq, wk, wv, wdo, **win)
    res["window"] = {
        "fwd_vs_scan": _check_o("wire int8 windowed kernel 8 vs the scan ring",
                                o_wf, o_ws, bf16),
        "grad_vs_scan": [_max_err(a, b) for a, b in zip(g_wf, g_ws)],
        "fwd_vs_dense": _max_err(o_wf, o_wd),
        "grad_vs_dense": [_max_err(a, b) for a, b in zip(g_wf, g_wd)]}
    assert max(res["window"]["grad_vs_scan"]) < WIRE_TOL_GRAD["int8"]
    assert res["window"]["fwd_vs_dense"] < WIRE_TOL_FWD["int8"]
    assert max(res["window"]["grad_vs_dense"]) < WIRE_TOL_GRAD["int8"]
    wcfg = dataclasses.replace(cfgs["int8"], layout="contig",
                               window=TRAIN_WINDOW)
    wqs, wks, wvs, wdos = (mesh.shard(t, w) for t in (wq, wk, wv, wdo))
    wo, wl = fused_ring.fused_ring_fwd(wqs, wks, wvs, wcfg, 1, w)
    res["window"]["k8_ms"] = time_ms(lambda: fused_ring.fused_ring_fwd(
        wqs, wks, wvs, wcfg, 1, w), iters=10, warmup=2)
    res["window"]["k9_ms"] = time_ms(lambda: fused_ring_bwd.fused_ring_bwd(
        wqs, wks, wvs, wo, wl, wdos, wcfg, 1, w), iters=10, warmup=2)
    print(f"wire int8 windowed contig ring (W={w} N{n}/{n_kv} S_local {s} "
          f"window {TRAIN_WINDOW}): kernel 8 vs the scan ring "
          f"{res['window']['fwd_vs_scan']:.3e}, gradients "
          f"{[float(f'{x:.3e}') for x in res['window']['grad_vs_scan']]}; "
          f"vs the dense windowed ring {res['window']['fwd_vs_dense']:.3e} / "
          f"{[float(f'{x:.3e}') for x in res['window']['grad_vs_dense']]}; "
          f"ms a launch: kernel 8 {res['window']['k8_ms']:.4f}, kernel 9 "
          f"{res['window']['k9_ms']:.4f}", flush=True)
    del wq, wk, wv, wdo, wqs, wks, wvs, wdos, wo, wl, o_wf, g_wf, o_ws
    del g_ws, o_wd, g_wd, q, k, v, do, qs, ks, vs, dos
    torch.cuda.empty_cache()

    # the headline shape: one int8 forward + backward beside the dense one
    b, hn, hs, hw = RING_B, RING_N, RING_S, RING_W
    hg = torch.Generator(device=device).manual_seed(47)
    hq, hk, hv, hdo = (layouts.to_layout(
        torch.randn(b, hn, hs, d, generator=hg, device=device).to(bf16),
        "zigzag", hw, 2) for _ in range(4))
    kw = dict(mesh={"sp": hw}, causal=True, layout="zigzag")
    o_i, g_i = fwd_bwd("fused_ring", "int8", hq, hk, hv, hdo)
    o_h, g_h = fwd_bwd("fused_ring", None, hq, hk, hv, hdo)
    head = {"fwd_vs_dense": _max_err(o_i, o_h),
            "grad_vs_dense": [_max_err(a, b_) for a, b_ in zip(g_i, g_h)]}
    assert head["fwd_vs_dense"] < WIRE_TOL_FWD["int8"], head
    assert max(head["grad_vs_dense"]) < WIRE_TOL_GRAD["int8"], head
    del o_i, g_i, o_h, g_h
    head["dense_ms"] = time_ms(lambda: fwd_bwd("fused_ring", None, hq, hk,
                                               hv, hdo), iters=1, warmup=0)
    head["int8_ms"] = time_ms(lambda: fwd_bwd("fused_ring", "int8", hq, hk,
                                              hv, hdo), iters=1, warmup=0)
    res["headline"] = head
    print(f"wire int8 burst_attn forward + backward at B{b} N{hn} S{hs} D{d} "
          f"bf16 causal zigzag, mesh {{'sp': {hw}}}: {head['int8_ms']:.2f} ms "
          f"(dense {head['dense_ms']:.2f} ms in the same run); vs the dense "
          f"ring {head['fwd_vs_dense']:.3e} / "
          f"{[float(f'{x:.3e}') for x in head['grad_vs_dense']]}", flush=True)
    del hq, hk, hv, hdo
    torch.cuda.empty_cache()

    recs = []
    for kern, name, src, rep_ in (
            ("k8", "fused_ring_fwd", "fused_ring_fwd.cu",
             "burst_attn_tpu/ops/fused_ring.py:1049 (_fused_fwd_kernel, "
             "wire: l.678-690, l.931-937)"),
            ("k9", "fused_ring_bwd", "fused_ring_bwd.cu",
             "burst_attn_tpu/ops/fused_ring_bwd.py:1087 (_fused_bwd_kernel, "
             "_wire_quant_tile: l.110-120, l.608-625)")):
        for x in WIRE_DTYPES:
            r = res[x]
            err = (max(r["fwd_vs_scan"], r["k8_vs_plain"]) if kern == "k8"
                   else max(r["k9_vs_plain"]))
            recs.append(dict(
                name=f"{name}[wire {x}]", route="cuda",
                source=f"burst_attn_tpu_torch/csrc/{src}", replaces=rep_,
                launches=main_launches["fwd" if kern == "k8" else "bwd", x],
                max_abs_err=err, ms=ms[kern, x],
                plain_ms=r["plain_fwd_ms" if kern == "k8"
                           else "plain_bwd_ms"],
                bound_ms=bounds[kern, x][0], bound_by=bounds[kern, x][1],
                library_ms=None,
                wire={"shape": f"W={w} B1 N{n}/{n_kv} S_local {s} D{d} bf16 "
                               "zigzag (the ring train step's)",
                      "ms_dense": ms[kern, None],
                      "turns_ms": turns[kern, x],
                      "turns_ms_dense": turns[kern, None],
                      "attrs": [a for a in attrs[kern].values()
                                if " win" not in a["instance"]
                                and " stats" not in a["instance"]]}))
    res["main_launches"] = {f"{p_} {x}": c
                            for (p_, x), c in main_launches.items()}
    res["seconds"] = time.perf_counter() - t_phase
    return recs, res


def seg_wire_phase(device):
    """Kernels 8 and 9's SEG + WIRE instances (packed ids with an int8 or
    fp8 ring payload) at the ring train step's shape (W=4 B1 N16/16
    S_local 2048 D128 bf16 causal zigzag) on the packed pattern's ids
    (_seg_patterns): burst_attn(segment_ids=, wire_dtype=) on the fused
    route (one launch of each SEG + WIRE instance, no fallback) against
    the scan ring with the same ids and wire (the forward at the bf16
    O_TOL, the gradients within WIRE_TOL_GRAD); each kernel against its
    plain version with the same ids and wire (kernel 8 at O_TOL, kernel 9
    by _wire_bwd_errs); two launches equal; ms a launch beside the SEG
    launch without a wire.  Bound: the pairs the ids leave (4 D flops a
    pair forward, 10 D backward), q, k, v, o, lse and the ids once, every
    program copy of the quantized chunk or bundle.  No library call
    computes a quantized ring (library_ms null).  Returns the
    kernels-line records fused_ring_fwd[seg+wire int8|fp8] and
    fused_ring_bwd[seg+wire int8|fp8], and the phase's numbers."""
    import torch

    from burst_attn_tpu_torch.ops import fused_ring, fused_ring_bwd
    from burst_attn_tpu_torch.parallel import burst, layouts, mesh

    t_phase = time.perf_counter()
    bf16, d, b = torch.bfloat16, 128, 1
    w, n = RING_TRAIN_SP, TRAIN_DIMS["n_heads"]
    n_kv, S = TRAIN_DIMS["n_kv_heads"], TRAIN_SEQ
    s = S // w
    ids_np = _seg_patterns(S)["packed"]
    ids = layouts.to_layout(torch.from_numpy(ids_np), "zigzag", w,
                            axis=1).to(device)
    seg = mesh.shard(ids, w, dim=1)
    g = torch.Generator(device=device).manual_seed(53)
    q, k, v, do = (layouts.to_layout(
        torch.randn(1, h, S, d, generator=g, device=device).to(bf16),
        "zigzag", w, 2) for h in (n, n_kv, n_kv, n))
    qs, ks, vs, dos = (mesh.shard(t, w) for t in (q, k, v, do))
    kw = dict(mesh={"sp": w}, causal=True, layout="zigzag", segment_ids=ids)
    pairs = _live_pairs(ids_np) * b * n
    res, recs = {"live_pairs": pairs}, []
    for wire in WIRE_DTYPES:
        out, launched = {}, {}
        for backend in ("fused_ring", "auto"):
            obs0 = _obs_now()
            n8 = fused_ring.fused_ring_fwd.wire_launches
            n9 = fused_ring_bwd.fused_ring_bwd.wire_launches
            s8 = fused_ring.fused_ring_fwd.seg_launches
            s9 = fused_ring_bwd.fused_ring_bwd.seg_launches
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o = burst.burst_attn(*leaves, backend=backend, wire_dtype=wire,
                                 **kw)
            grads = torch.autograd.grad(o, leaves, do)
            torch.cuda.synchronize()
            assert not any(x.startswith("burst.fused_fallback")
                           for x in _obs_since(obs0)), \
                dict(_obs_since(obs0))
            launched[backend] = (
                fused_ring.fused_ring_fwd.wire_launches - n8,
                fused_ring_bwd.fused_ring_bwd.wire_launches - n9,
                fused_ring.fused_ring_fwd.seg_launches - s8,
                fused_ring_bwd.fused_ring_bwd.seg_launches - s9)
            out[backend] = o.detach(), grads
        # the fused route's launches are the SEG + WIRE instances'
        assert launched["fused_ring"] == (1, 1, 1, 1), launched
        assert launched["auto"] == (0, 0, 0, 0), launched
        (o_f, g_f), (o_s, g_s) = out["fused_ring"], out["auto"]
        r = {"main_launches": launched["fused_ring"][:2],
             "fwd_vs_scan": _check_o(f"seg+wire {wire} kernel 8 vs the scan "
                                     "ring", o_f, o_s, bf16),
             "grad_vs_scan": [_max_err(a, b_) for a, b_ in zip(g_f, g_s)]}
        assert max(r["grad_vs_scan"]) < WIRE_TOL_GRAD[wire], r
        del out, g_f, g_s, o_s
        cfg = burst.BurstConfig(causal=True, layout="zigzag",
                                backend="fused_ring", wire_dtype=wire)
        fprog, ftables, _ = fused_ring.ring_plan(cfg, 1, w, s, "fwd")
        prog, tables, _ = fused_ring.ring_plan(cfg, 1, w, s, "bwd")
        o8, lse8 = fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, w, seg=seg)
        again = fused_ring.fused_ring_fwd(qs, ks, vs, cfg, 1, w, seg=seg)
        assert torch.equal(again[0], o8) and torch.equal(again[1], lse8)
        assert torch.equal(mesh.unshard(o8), o_f), \
            "kernel 8 alone differs from burst_attn's seg + wire forward"
        t0 = time.perf_counter()
        po, plse = fused_ring.fused_ring_reference(
            qs, ks, vs, fprog, ftables, d ** -0.5, seg=seg, wire=wire)
        torch.cuda.synchronize()
        r["plain_fwd_ms"] = (time.perf_counter() - t0) * 1e3
        r["k8_vs_plain"] = _check_o(f"seg+wire {wire} kernel 8 vs its plain "
                                    "version", o8, po, bf16)
        r["k8_lse_vs_plain"] = _stats_close(
            f"seg+wire {wire} kernel 8 lse", lse8, plse, "bf16")
        del po, plse, again
        bargs = (qs, ks, vs, o8, lse8, dos)
        got = fused_ring_bwd.fused_ring_bwd(*bargs, cfg, 1, w, seg=seg)
        again = fused_ring_bwd.fused_ring_bwd(*bargs, cfg, 1, w, seg=seg)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        t0 = time.perf_counter()
        want = fused_ring_bwd.fused_ring_bwd_reference(
            *bargs, prog, tables, d ** -0.5, cfg.optimize_bwd_comm, seg=seg,
            head_chunk=4, wire=wire)
        torch.cuda.synchronize()
        r["plain_bwd_ms"] = (time.perf_counter() - t0) * 1e3
        r["k9_vs_plain"], r["k9_dq_codes"] = _wire_bwd_errs(
            got, want, wire, f"seg+wire {wire} kernel 9 vs its plain version")
        del got, again, want
        torch.cuda.empty_cache()
        dense = burst.BurstConfig(causal=True, layout="zigzag",
                                  backend="fused_ring")
        od, lsed = fused_ring.fused_ring_fwd(qs, ks, vs, dense, 1, w,
                                             seg=seg)
        turns = {x: {"k8": [], "k9": []} for x in ("seg", "seg+wire")}
        for x in ("seg", "seg+wire", "seg+wire", "seg"):
            c, oo, ll = (dense, od, lsed) if x == "seg" else (cfg, o8, lse8)
            turns[x]["k8"].append(time_ms(lambda: fused_ring.fused_ring_fwd(
                qs, ks, vs, c, 1, w, seg=seg), iters=10, warmup=2))
            turns[x]["k9"].append(time_ms(
                lambda: fused_ring_bwd.fused_ring_bwd(
                    qs, ks, vs, oo, ll, dos, c, 1, w, seg=seg), iters=10,
                warmup=2))
        ms = {x: {kern: sum(v_) / len(v_) for kern, v_ in t_.items()}
              for x, t_ in turns.items()}
        copies = w * (sum(fprog.rows["send0"]) + sum(fprog.rows["send1"])
                      + len(fprog.copy_in))
        from burst_attn_tpu_torch.parallel import schedule as sched_ir

        chunk = sched_ir.wire_round_bytes("fwd", wire, b=b, n=n, n_kv=n_kv,
                                          s=s, d=d)["kv"]
        ids_bytes = 4 * b * S
        k8_bound = bound_ms(2 * 2 * q.numel() + 2 * 2 * k.numel()
                            + 4 * lse8.numel() + 2 * copies * chunk
                            + ids_bytes, 4 * d * pairs)
        k9_bound = _bwd_bound(tables, prog, b, n, n_kv, s, d, 2,
                              pairs=pairs, extra_bytes=ids_bytes,
                              wire=wire)[:2]
        del od, lsed, o8, lse8, bargs, o_f
        torch.cuda.empty_cache()
        r.update(ms=ms, turns_ms=turns, k8_bound=k8_bound, k9_bound=k9_bound)
        res[wire] = r
        print(f"seg+wire {wire} at the ring train step's shape (W={w} B1 "
              f"N{n}/{n_kv} S_local {s} bf16 zigzag, packed ids, "
              f"{pairs} live pairs): kernel 8 vs the scan ring "
              f"{r['fwd_vs_scan']:.3e}, vs its plain version "
              f"{r['k8_vs_plain']:.3e}; gradients vs the scan ring "
              f"{[float(f'{x:.3e}') for x in r['grad_vs_scan']]}, kernel 9 "
              f"vs its plain version "
              f"{[float(f'{x:.3e}') for x in r['k9_vs_plain']]} (dq "
              f"{r['k9_dq_codes']:.2f} codes); ms a launch (turns seg, "
              f"seg+wire, seg+wire, seg): kernel 8 {ms['seg+wire']['k8']:.4f}"
              f" (seg alone {ms['seg']['k8']:.4f}), kernel 9 "
              f"{ms['seg+wire']['k9']:.4f} (seg alone {ms['seg']['k9']:.4f});"
              f" bounds {k8_bound[0]:.4f} ({k8_bound[1]}) / "
              f"{k9_bound[0]:.4f} ({k9_bound[1]}) ms; plain versions "
              f"{r['plain_fwd_ms']:.0f} / {r['plain_bwd_ms']:.0f} ms",
              flush=True)
    attrs = {"k8": [a for x in (False, True) for a in fused_ring.fwd_attrs(
                 seg=True, win=x, wire=True)],
             "k9": [a for x in (False, True) for a in
                    fused_ring_bwd.bwd_attrs(seg=True, win=x, wire=True)]}
    for kern, rows in attrs.items():
        for a in rows:
            assert 0 < a["regs"] <= 255 and a["ctas"] >= 1, (kern, a)
            print(f"{'fused_ring_fwd' if kern == 'k8' else 'fused_ring_bwd'}"
                  f" {a['instance']}: {a['regs']} registers, "
                  f"{a['local_bytes']} local (spill) bytes a thread, "
                  f"{a['smem']} B of shared memory, {a['ctas']} CTAs "
                  f"resident", flush=True)
    for kern, name, src, rep_ in (
            ("k8", "fused_ring_fwd", "fused_ring_fwd.cu",
             "burst_attn_tpu/ops/fused_ring.py:1049 (_fused_fwd_kernel, "
             "has_seg with wire: l.401, l.678-690)"),
            ("k9", "fused_ring_bwd", "fused_ring_bwd.cu",
             "burst_attn_tpu/ops/fused_ring_bwd.py:1087 (_fused_bwd_kernel, "
             "has_seg with wire: l.168-173)")):
        for x in WIRE_DTYPES:
            r = res[x]
            err = (max(r["fwd_vs_scan"], r["k8_vs_plain"]) if kern == "k8"
                   else max(r["k9_vs_plain"]))
            bnd = r[f"{kern}_bound"]
            recs.append(dict(
                name=f"{name}[seg+wire {x}]", route="cuda",
                source=f"burst_attn_tpu_torch/csrc/{src}", replaces=rep_,
                launches=r["main_launches"][0 if kern == "k8" else 1],
                max_abs_err=err, ms=r["ms"]["seg+wire"][kern],
                plain_ms=r["plain_fwd_ms" if kern == "k8"
                           else "plain_bwd_ms"],
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                wire={"shape": f"W={w} B1 N{n}/{n_kv} S_local {s} D{d} bf16 "
                               "causal zigzag, packed ids (the ring train "
                               "step's)",
                      "ms_seg_alone": r["ms"]["seg"][kern],
                      "turns_ms": r["turns_ms"]["seg+wire"][kern],
                      "turns_ms_seg": r["turns_ms"]["seg"][kern],
                      "attrs": attrs[kern]}))
    del q, k, v, do, qs, ks, vs, dos
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    print(f"seg+wire phase: {res['seconds']:.1f} s", flush=True)
    return recs, res


# ---------------------------------------------------------------------------
# serving under load: the loadgen trace replayed open-loop in process, the
# multi-process serve cluster with a kill and a restart, the disaggregated
# prefill / decode fleet with its KV plane (every worker on the card)

# the serving model at its full width, 2 layers: every worker process
# draws its own weights (numpy, seed 0) and the phase boots ~10 of them
FLEET_DIMS = dict(SERVE_DIMS, n_layers=2)
# the trace: seed 0, 24 requests (prompts 100-2048 tokens, budgets 16-64,
# bursty arrivals over ~1.3 s), 2 of them poison (an empty prompt, a zero
# budget)
LOAD_TRACE = dict(n_requests=24, seed=0, prompt_len_min=100,
                  prompt_len_max=2048, prompt_len_log_mean=6.5,
                  prompt_len_log_sigma=0.8, max_new_min=16, max_new_max=64,
                  max_new_mean=32.0, poison_rate=0.05)
LOAD_ENGINE = dict(kind="ragged", slots=SLOTS, n_pages=N_PAGES, page=PAGE,
                   max_pages_per_seq=MAX_PAGES, chunk=CHUNK, max_queue=32)
# the cluster: the ServeEngine kind (kernels 1 and 6), fp32, journaled
CLUSTER_ENGINE = dict(kind="legacy", slots=4, n_pages=40, page=PAGE,
                      max_pages_per_seq=9, max_queue=32)
CLUSTER_TRACE = dict(n_requests=8, seed=1, prompt_len_min=100,
                     prompt_len_max=1024, prompt_len_log_mean=6.0,
                     mean_interarrival_s=0.25, max_new_min=24,
                     max_new_max=48, max_new_mean=32.0)
# the fleet: 1 ring-prefill worker (sp=2, the fused ring: kernel 8) and 2
# decode replicas (sp=2), page-multiple prompts
FLEET_PROMPTS = (512, 1024, 384, 896, 640, 768)
FLEET_BUDGETS = (24, 16, 32, 20, 28, 18)
FLEET_PSPEC = dict(sp=2, page=PAGE, n_pages=10, max_pages_per_seq=9,
                   warm_len=512)
FLEET_DSPEC = dict(sp=2, slots=2, page=PAGE, n_pages=20, max_pages_per_seq=9)
FLEET_LIMITS = dict(start_timeout_s=300.0, restart_timeout_s=300.0)


_FLEET_WEIGHTS = {}  # "path": the phase's save_weights file


def _fleet_spec(dtype, **kw):
    """A worker's model spec: the seed-0 weights from the phase's file
    (each process loads them instead of drawing them again)."""
    return dict(FLEET_DIMS, seed=0, dtype=dtype,
                weights=_FLEET_WEIGHTS["path"], **kw)


def _last_export(path):
    """The metric records of an obs file's last snapshot (a killed worker
    may leave a torn final line; the snapshot before it is whole)."""
    from burst_attn_tpu_torch.obs.aggregate import load_records_tolerant

    recs, _ = load_records_tolerant(path)
    last = []
    for r in recs:
        last = [] if r["kind"] == "meta" else last + [r]
    return last


def _ctr(recs, name, **labels):
    return sum(int(r.get("value", 0)) for r in recs
               if r["kind"] == "counter" and r["name"] == name
               and all(r["labels"].get(k) == v for k, v in labels.items()))


def _registry_window(before, after):
    """Merged-export-shaped metric records of what the registry counted
    between two snapshots (counters and histograms; the window's max is
    the later snapshot's)."""
    key = (lambda r: (r["kind"], r["name"],
                      tuple(sorted(r["labels"].items()))))
    old = {key(r): r for r in before}
    out = []
    for r in after:
        o = old.get(key(r))
        if r["kind"] == "counter":
            out.append(dict(r, value=r["value"] - (o["value"] if o else 0)))
        elif r["kind"] == "histogram":
            d = dict(r)
            if o:
                d["bucket_counts"] = [a - b for a, b in zip(
                    r["bucket_counts"], o["bucket_counts"])]
                d["overflow"] = r["overflow"] - o["overflow"]
                d["count"] = r["count"] - o["count"]
            out.append(d)
    return out


def _load_trace():
    from burst_attn_tpu_torch.loadgen import synthesize_trace

    kw = dict(LOAD_TRACE)
    trace = synthesize_trace(kw.pop("n_requests"), vocab=FLEET_DIMS["vocab"],
                             **kw)
    assert sum(r.poison for r in trace.requests) == 2
    return trace


def load_replay_phase(device):
    """(a) The trace replayed open-loop (speed 1: virtual seconds are wall
    seconds) through a RaggedServeEngine in this process, fp32 then bf16:
    fp32 token-exact with `oracle_replay`, bf16 to the teacher-forced
    near-tie bar; the poison requests rejected; kernel 7 launched once a
    layer for every ragged launch the engine counted; the SLO report of
    the replay's window of the registry."""
    import torch

    from burst_attn_tpu_torch import obs
    from burst_attn_tpu_torch.loadgen import (
        assert_token_exact, compute_slo, format_slo, oracle_replay,
        replay_trace,
    )
    from burst_attn_tpu_torch.loadgen.worker import model_from_spec
    from burst_attn_tpu_torch.ops import ragged_paged
    from burst_attn_tpu_torch.serving import RaggedServeEngine

    trace = _load_trace()
    k7 = ragged_paged.ragged_paged_attention
    res = {"launches": 0}
    for dtype in ("float32", "bfloat16"):
        params, cfg, dev = model_from_spec(_fleet_spec(dtype))
        es = {k: v for k, v in LOAD_ENGINE.items() if k != "kind"}

        def make(max_queue=es["max_queue"]):
            return RaggedServeEngine(params, cfg, device=dev,
                                     **dict(es, max_queue=max_queue))

        eng = make()
        snap0, c0 = obs.snapshot(), obs.counter_values()
        k7.launches = 0
        rep = replay_trace(eng, trace, speed=1.0, max_wall_s=300.0)
        launches = k7.launches
        window = _registry_window(snap0, obs.snapshot())
        dc = obs.counter_deltas(c0)
        ticks = sum(n for k, n in dc.items()
                    if k.startswith("serve.ragged_batch_launches"))
        assert launches == cfg.n_layers * ticks > 0, (launches, ticks)
        assert rep.n_done == len(trace.normal()), rep.outcomes
        assert sorted(o.reason for o in rep.by_status("rejected")) == \
            ["bad-budget", "empty-prompt"]
        slo = compute_slo(window, duration_s=rep.duration_v,
                          completed_tokens=rep.completed_tokens,
                          n_done=rep.n_done, n_rejected=rep.n_rejected)
        done = rep.completed()
        if dtype == "float32":
            t0 = time.perf_counter()
            oracle = oracle_replay(trace, lambda: make(None))
            oracle_s = time.perf_counter() - t0
            assert_token_exact(done, oracle)
            agree = None
        else:
            oracle_s = None
            rids = sorted(done)
            prompts = [trace.requests[r].prompt(cfg.vocab) for r in rids]
            agree = agreement(cfg, params, prompts, [done[r] for r in rids],
                              dev)
            check_agreement("loadgen replay, bf16", agree, True)
        res[dtype] = {
            "wall_s": rep.wall_s, "done": rep.n_done,
            "rejected": rep.n_rejected, "shed": rep.n_shed,
            "completed_tokens": rep.completed_tokens, "ticks": ticks,
            "ragged_launches": launches, "oracle_s": oracle_s,
            "agreement": agree[:2] if agree else None,
            "slo": {k: v for k, v in slo.items()}}
        res["launches"] += launches
        print(f"loadgen replay ({dtype}, {len(trace.requests)} requests, "
              f"{rep.n_done} done, {rep.n_rejected} rejected, "
              f"{rep.completed_tokens} tokens in {rep.wall_s:.2f} s wall; "
              f"{ticks} ragged ticks, kernel 7 x {launches}): TTFT p50 "
              f"{slo['ttft_p50_s'] * 1e3:.1f} ms p99 "
              f"{slo['ttft_p99_s'] * 1e3:.1f} ms, token latency p50 "
              f"{slo['token_latency_p50_s'] * 1e3:.2f} ms p99 "
              f"{slo['token_latency_p99_s'] * 1e3:.2f} ms, goodput "
              f"{slo['goodput_tokens_per_s']:.1f} tok/s, shed rate "
              f"{slo['shed_rate']:.3f}", flush=True)
        print(format_slo(slo), flush=True)
        del eng, params
        torch.cuda.empty_cache()
    return res


def _cluster_trace():
    from burst_attn_tpu_torch.loadgen import synthesize_trace

    kw = dict(CLUSTER_TRACE)
    return synthesize_trace(kw.pop("n_requests"), vocab=FLEET_DIMS["vocab"],
                            **kw)


def _check_worker_lives(paths, n_layers, legacy):
    """Each worker life's last obs export: its kernel launches against the
    work it counted in the same snapshot.  ServeEngine: kernel 1 once a
    layer an admission, kernel 6 a whole number of layers' worth, at most
    one decode a step; RaggedServeEngine: kernel 7 once a layer a ragged
    launch.  Returns the launches summed over the lives."""
    total = {"flash_fwd": 0, "paged_decode": 0, "ragged_paged": 0}
    for path in paths:
        recs = _last_export(path)
        k = {n: _ctr(recs, "kernel.launches", kernel=n) for n in total}
        if legacy:
            assert k["flash_fwd"] == n_layers * _ctr(
                recs, "serve.requests_admitted"), (path, k)
            assert k["paged_decode"] % n_layers == 0 and k["paged_decode"] \
                <= n_layers * _ctr(recs, "serve.engine_steps"), (path, k)
            assert k["ragged_paged"] == 0, (path, k)
        else:
            assert k["ragged_paged"] == n_layers * _ctr(
                recs, "serve.ragged_batch_launches"), (path, k)
        for n in total:
            total[n] += k[n]
    return total


def cluster_phase(out_root):
    """(b) LoadGenCluster: 2 ServeEngine workers on the card, fp32,
    journaled and snapshotted; worker 0 killed mid-decode, worker 1
    restarted from snapshot + journal; fp32 token-exact with the oracle.
    Then the same trace and kill with journal resume off: the resumed run
    re-decodes strictly fewer tokens than the replay from scratch."""
    import threading

    from burst_attn_tpu_torch.loadgen import (
        FaultEvent, LoadGenCluster, assert_token_exact, oracle_replay,
    )
    from burst_attn_tpu_torch.loadgen.worker import build_engine

    spec = _fleet_spec("float32")
    trace = _cluster_trace()
    t0 = time.perf_counter()
    oracle = oracle_replay(trace, lambda: build_engine(
        spec, dict(CLUSTER_ENGINE, max_queue=None)))
    res = {"oracle_s": time.perf_counter() - t0}
    faults = {True: [FaultEvent(t=0.05, kind="kill", worker=0),
                     FaultEvent(t=0.1, kind="restart", worker=1)],
              False: [FaultEvent(t=0.05, kind="kill", worker=0)]}
    launches = {"flash_fwd": 0, "paged_decode": 0}
    clusters = {resume: LoadGenCluster(
        spec, CLUSTER_ENGINE, n_workers=2,
        out_dir=os.path.join(out_root, f"r{resume:d}"), checkpoint=True,
        resume=resume, **FLEET_LIMITS) for resume in (True, False)}
    # both clusters' workers boot together; the replays run one at a time
    t0 = time.perf_counter()
    errors = []

    def start_scratch():
        try:
            clusters[False].start()
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    starter = threading.Thread(target=start_scratch)
    starter.start()
    try:
        clusters[True].start()
        starter.join()
        if errors:
            raise errors[0]
        res["start_s"] = time.perf_counter() - t0
        for resume in (True, False):
            cl = clusters[resume]
            t0 = time.perf_counter()
            rep = cl.replay(trace, faults[resume], speed=1.0,
                            max_wall_s=300.0)
            cl.stop()
            boots, stopped, paths = cl.boot_s, cl.stopped, cl.obs_paths
            assert all(b["device"].startswith("cuda") for b in boots), boots
            assert rep.n_done == len(trace.requests), rep.outcomes
            assert_token_exact(rep.completed(), oracle)
            kills = [(k["worker"], k.get("restarted", False),
                      k["detected_by"]) for k in rep.kills]
            assert kills == ([(0, False, "scheduled-kill"),
                              (1, True, "scheduled-restart")] if resume
                             else [(0, False, "scheduled-kill")]), rep.kills
            for info in stopped.values():
                assert info["pool_free"] == info["pool_usable"], stopped
            lives = _check_worker_lives(paths, FLEET_DIMS["n_layers"], True)
            if resume:
                for n in launches:
                    launches[n] += lives[n]
            res["resume" if resume else "scratch"] = {
                "wall_s": rep.wall_s, "cluster_s": time.perf_counter() - t0,
                "kills": rep.kills, "recovery_s": rep.recovery_s(),
                "replayed": rep.recovered_tokens_replayed,
                "resumed": rep.recovered_tokens_resumed,
                "boot_s": boots, "worker_launches": lives}
            print(f"cluster ({'resume' if resume else 'scratch'}, 2 "
                  f"ServeEngine workers, fp32, {len(trace.requests)} "
                  f"requests): token-exact; kills {kills}; recovery "
                  f"{['%.3f' % s for s in rep.recovery_s()]} s; tokens "
                  f"re-decoded {rep.recovered_tokens_replayed}, resumed "
                  f"{rep.recovered_tokens_resumed}; boot s a worker "
                  + ", ".join(f"w{b['worker']}g{b['gen']} {b['s']:.1f} "
                              f"(build {b['build_s']:.1f}, warm "
                              f"{b['warm_s']:.2f})" for b in boots)
                  + f"; kernel 1 x {lives['flash_fwd']}, kernel 6 x "
                  f"{lives['paged_decode']}", flush=True)
    finally:
        starter.join()
        for cl in clusters.values():
            cl.stop()
    assert res["resume"]["resumed"] > 0
    assert res["resume"]["replayed"] < res["scratch"]["replayed"], res
    res["launches"] = launches
    return res


def _fleet_trace():
    from burst_attn_tpu_torch.loadgen.trace import Trace, TraceRequest

    return Trace(meta={"vocab": FLEET_DIMS["vocab"]}, requests=[
        TraceRequest(rid=i, t_arrival=0.1 * i, prompt_len=n,
                     prompt_seed=500 + i, max_new_tokens=b)
        for i, (n, b) in enumerate(zip(FLEET_PROMPTS, FLEET_BUDGETS))])


def _fleet_numbers(paths):
    """KV bytes and pages shipped, the ship and transfer spans a page, the
    prefill worker's kernel launches against its ring passes."""
    shipped = pages = 0
    ship_s = xfer_s = 0.0
    k8 = passes = k1 = 0
    for path in paths:  # the members' exports
        recs = _last_export(path)
        if os.path.basename(path).startswith("obs_p"):
            # what the prefill workers shipped (a replica's export of its
            # committed pages for the digest echo counts there too)
            shipped += _ctr(recs, "fleet.kv_bytes_shipped")
            pages += _ctr(recs, "fleet.kv_pages_shipped")
        for r in recs:
            if r["kind"] == "trace" and r["name"] == "fleet.ship":
                ship_s += r["duration_s"]
            if r["kind"] == "trace" and r["name"] == "fleet.transfer":
                xfer_s += r["duration_s"]
        n8 = _ctr(recs, "kernel.launches", kernel="fused_ring_fwd")
        n_pass = _ctr(recs, "fleet.ring_prefills")
        assert n8 == FLEET_DIMS["n_layers"] * n_pass, (path, n8, n_pass)
        assert _ctr(recs, "burst.fused_fallback") == 0, path
        k8 += n8
        passes += n_pass
        k1 += _ctr(recs, "kernel.launches", kernel="flash_fwd")
    assert k1 == 0  # the fused route: no scan-ring round ran
    return {"kv_mb": shipped / 1e6, "pages": pages,
            "ship_ms_a_page": 1e3 * ship_s / max(pages, 1),
            "transfer_ms_a_page": 1e3 * xfer_s / max(pages, 1),
            "fused_ring_launches": k8, "ring_passes": passes}


def _fleet_runs():
    """fleet_run_phase's two fleets: (dtype, transport, decode spec,
    faults)."""
    from burst_attn_tpu_torch.fleet import FleetFault

    return (("float32", "queue", dict(FLEET_DSPEC), [
                FleetFault(t=0.0, pool="decode", worker=1,
                           kind="die_mid_recv", arg=1),
                FleetFault(t=0.2, pool="decode", worker=0, kind="restart")]),
            ("bfloat16", "socket", dict(FLEET_DSPEC, echo_digests=True), []))


class _FleetBoot:
    """fleet_run_phase's two FleetClusters, each started in a thread of its
    own, so that their members boot beside the cluster phase's workers;
    `join()` waits for both (raising a start's error) and gives the
    seconds from here, `stop()` stops both."""

    def __init__(self, out_root):
        import threading

        from burst_attn_tpu_torch.fleet import FleetCluster

        self.fleets = {dtype: FleetCluster(
            _fleet_spec(dtype, attn_backend="fused_ring"),
            prefill_spec=FLEET_PSPEC, decode_spec=dspec, n_prefill=1,
            n_decode=2, out_dir=os.path.join(out_root, dtype),
            transport=transport, checkpoint_every=1, trace=True,
            **FLEET_LIMITS) for dtype, transport, dspec, _ in _fleet_runs()}
        self.errors = []
        self.t0 = time.perf_counter()
        self.threads = [threading.Thread(target=self._start, args=(fc,))
                        for fc in self.fleets.values()]
        for t in self.threads:
            t.start()

    def _start(self, fc):
        try:
            fc.start()
        except Exception as e:  # noqa: BLE001 — raised by join()
            self.errors.append(e)

    def join(self) -> float:
        for t in self.threads:
            t.join()
        if self.errors:
            raise self.errors[0]
        return time.perf_counter() - self.t0

    def stop(self) -> None:
        for t in self.threads:
            t.join()
        for fc in self.fleets.values():
            fc.stop()


def fleet_run_phase(out_root, boot):
    """(c) FleetCluster: 1 prefill worker (sp=2, kernel 8) and 2 decode
    replicas (sp=2), every member on the card.  fp32 over queues: a
    decode replica dies after receiving its first page (the buffered
    transfer re-ships to its sibling) and the other is killed mid-stream
    and restarted from its snapshot; token-exact with `fleet_oracle`, zero
    pages left in any pool.  bf16 over sockets: the 2-byte pages'
    digests, recomputed from the replica's pool after each commit, match
    the sender's; the streams meet the teacher-forced near-tie bar.  The
    two fleets (`boot`, a _FleetBoot) booted beside the cluster phase;
    they replay one at a time."""
    from burst_attn_tpu_torch.fleet import fleet_oracle

    trace = _fleet_trace()
    res = {}
    t0 = time.perf_counter()
    oracle, _ = fleet_oracle(
        trace, _fleet_spec("float32", attn_backend="fused_ring"),
        prefill_spec=FLEET_PSPEC, decode_spec=FLEET_DSPEC)
    res["oracle_s"] = time.perf_counter() - t0
    start_s = boot.join()
    launches = 0
    for dtype, transport, dspec, faults in _fleet_runs():
        t0 = time.perf_counter()
        fc = boot.fleets[dtype]
        rep = fc.replay(trace, faults, speed=1.0, max_wall_s=300.0)
        fc.stop()
        paths = [p for p in fc.obs_paths
                 if not p.endswith("obs_router.jsonl")]
        launches += _fleet_run_check(dtype, transport, dspec, rep,
                                     fc.boot_s, fc.stopped, paths, trace,
                                     oracle, start_s, t0, res)
    res["launches"] = launches
    return res


def _fleet_run_check(dtype, transport, dspec, rep, boots, stopped, paths,
                     trace, oracle, start_s, t0, res):
    """fleet_run_phase's checks and numbers of one fleet's replay (into
    res[dtype]); returns its kernel 8 launches."""
    from burst_attn_tpu_torch.loadgen.worker import model_from_spec

    spec = _fleet_spec(dtype, attn_backend="fused_ring")
    assert all(b["device"].startswith("cuda") for b in boots), boots
    assert rep.n_done == len(trace.requests), rep.outcomes
    for info in stopped.values():  # zero pages leaked anywhere
        assert info["pool_free"] == info["pool_usable"], stopped
    nums = _fleet_numbers(paths)
    done = rep.completed()
    # arrival to admission on a replica (the first token, sampled by
    # the prefill, rides the transfer); journal-completed requests
    # have no admission
    ttft = sorted((o.t_submit - o.t_arrival) * 1e3
                  for o in rep.outcomes.values()
                  if o.t_submit is not None)
    if dtype == "float32":
        assert done == oracle, (done, oracle)
        assert rep.transfers["reshipped"] >= 1, rep.transfers
        assert sorted((k["pool"], k["worker"], bool(k.get("restarted")))
                      for k in rep.kills) == [("decode", 0, True),
                                              ("decode", 1, False)]
        agree = None
    else:
        assert rep.transfers["digest_checked"] == len(trace.requests)
        assert rep.transfers["digest_mismatch"] == 0, rep.transfers
        params, cfg, dev = model_from_spec(spec)
        rids = sorted(done)
        agree = agreement(cfg, params,
                          [trace.requests[r].prompt(cfg.vocab)
                           for r in rids], [done[r] for r in rids], dev)
        del params
        # 138 tokens are too few for a 95% rate at the ~3.5% flip
        # rate: every disagreement a near tie
        check_agreement("fleet, bf16", agree, True, min_agree=0.0)
    if dtype == "bfloat16":  # the fault-free run: the sim's input
        res["_sim"] = dict(trace=trace, outcomes=rep.outcomes,
                           n_replicas=2, slots=dspec["slots"],
                           n_prefill=1)
    res[dtype] = {"transport": transport, "wall_s": rep.wall_s,
                  "start_s": start_s,
                  "fleet_s": time.perf_counter() - t0,
                  "kills": rep.kills, "transfers": {
                      k: v for k, v in rep.transfers.items()
                      if k != "aborts"},
                  "recovery_s": rep.recovery_s(),
                  "ttft_ms": ttft, "boot_s": boots,
                  "agreement": agree[:2] if agree else None, **nums}
    print(f"fleet ({dtype}, {transport}, 1 prefill sp=2 fused ring + "
          f"2 decode sp=2, {len(trace.requests)} requests): "
          f"{'token-exact' if agree is None else 'near-tie bar met'}; "
          f"{rep.transfers['committed']} transfers committed, "
          f"{rep.transfers['reshipped']} re-shipped; KV "
          f"{nums['kv_mb']:.1f} MB in {nums['pages']} pages, ship "
          f"{nums['ship_ms_a_page']:.2f} ms a page, transfer "
          f"{nums['transfer_ms_a_page']:.2f} ms a page; TTFT from "
          f"arrival p50 {ttft[len(ttft) // 2]:.0f} ms max "
          f"{ttft[-1]:.0f} ms; kernel 8 x {nums['fused_ring_launches']}"
          f" = {FLEET_DIMS['n_layers']} x {nums['ring_passes']} ring "
          f"passes; boot s " + ", ".join(
              f"{b['pool'][0]}{b['worker']}g{b['gen']} {b['s']:.1f}"
              for b in boots), flush=True)
    return nums["fused_ring_launches"]


def fleet_phase(device):
    """Serving under load, (a)-(c); every number a wall time on the card's
    host clock.  Returns the results with the launches each kernel made
    in this phase (in this process and, reported, in the workers)."""
    import shutil

    import torch

    from burst_attn_tpu_torch.obs import trace as tracing

    from burst_attn_tpu_torch.loadgen.worker import (
        model_from_spec, save_weights,
    )

    t0 = time.perf_counter()
    out_root = os.path.join(_ckpt_dir().parent, "fleet")
    shutil.rmtree(out_root, ignore_errors=True)
    os.makedirs(out_root)
    params, _, _ = model_from_spec(dict(FLEET_DIMS, seed=0, device=device))
    _FLEET_WEIGHTS["path"] = save_weights(
        params, os.path.join(out_root, "weights.pt"))
    del params
    res = {"weights_s": time.perf_counter() - t0}
    res["load"] = load_replay_phase(device)
    torch.cuda.empty_cache()
    # the fleets' members boot beside the cluster phase's workers
    boot = _FleetBoot(out_root)
    try:
        res["cluster"] = cluster_phase(out_root)
        res["fleet"] = fleet_run_phase(out_root, boot)
    finally:
        boot.stop()
    res["_sim"] = res["fleet"].pop("_sim")
    res["launches"] = {
        "ragged_paged": res["load"]["launches"],
        "flash_fwd": res["cluster"]["launches"]["flash_fwd"],
        "paged_decode": res["cluster"]["launches"]["paged_decode"],
        "fused_ring_fwd": res["fleet"]["launches"]}
    for name, n in res["launches"].items():
        assert n > 0, res["launches"]
    tracing.enable(False)  # the fleet's router switched it on here
    os.remove(_FLEET_WEIGHTS.pop("path"))
    res["seconds"] = time.perf_counter() - t0
    print(f"fleet phase: {res['seconds']:.1f} s", flush=True)
    return res


def analysis_phase(sim_in, k8_rec, k9_rec, k6_rec, k7_rec, sass_jobs):
    """The analyzer on the card: its CPU families and its card halves in
    this process (zero findings; the SASS from `sass_jobs`, started after
    the build); the measured times the smoke already took beside the cost
    model's h100 floors; the simulator calibrated from the fleet phase's
    bf16 run.  Returns the numbers."""
    import torch

    from burst_attn_tpu_torch.analysis import (
        costcheck, numerics, obscheck, ringcheck, servecheck,
    )
    from burst_attn_tpu_torch.analysis import costmodel as cm
    from burst_attn_tpu_torch.analysis.core import (
        RULES, register_all, run_analysis,
    )
    from burst_attn_tpu_torch.fleet import sim
    from burst_attn_tpu_torch.ops.tuning import resolve_fused

    t0 = time.perf_counter()
    register_all()
    not_run = {}
    findings = run_analysis(not_run=not_run)
    t_cpu = time.perf_counter() - t0
    # the card halves: what run_analysis(card=True) adds to the families,
    # each timed
    halves = {}
    t1 = time.perf_counter()
    sass = numerics.finish_sass(sass_jobs)
    halves["SASS dumps (waited for)"] = time.perf_counter() - t1
    for name, fn in (("kernel-smem-budget", costcheck.check_card),
                     ("fused-ring-fused", ringcheck.check_card),
                     ("numerics (SASS, bf16 ring)",
                      lambda: numerics.check_card(sass)),
                     ("obscheck ring", obscheck.check_ring_card),
                     ("obscheck serve steps", obscheck.check_steps_card),
                     ("obscheck decode graphs",
                      obscheck.check_decode_graphs_card),
                     ("obscheck K=1 tick", obscheck.check_tick_card),
                     ("servecheck", lambda: servecheck.check_card(sass))):
        t1 = time.perf_counter()
        findings += fn()
        halves[name] = time.perf_counter() - t1
    t_card = sum(halves.values())
    assert not findings, "\n".join(f.format() for f in findings)
    assert len(RULES) == 30, sorted(RULES)
    plans = cm.kernel_smem_plans()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"analysis: {len(RULES)} rules, zero findings; CPU families "
          f"{t_cpu:.1f} s (not run without the card: {sorted(not_run)}), "
          f"card halves {t_card:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in halves.items())
          + f"): {len(plans)} kernel instances' "
          f"shared memory equal to their plans (largest "
          f"{max(p.smem for p in plans)} B of {cm.SMEM_LIMIT}), resident "
          f"CTAs within the plans on {n_sm} SMs; fused-ring-fused clean on "
          f"{len(ringcheck.CARD_CASES)} fused configs; every HMMA of the "
          "built libraries on an F32 accumulator; the steps, decode graphs "
          "and ragged launches sync-free and captured with kernel, memset "
          "and device-copy nodes only", flush=True)

    # the measured times beside the model's floors (seconds)
    rf = resolve_fused()
    shape = dict(b=RING_B, n=RING_N, n_kv=RING_N, s=RING_S // RING_W, d=128)
    rows = []
    for rec, pass_ in ((k8_rec, "fwd"), (k9_rec, "bwd")):
        prog = cm.compile_program(pass_, "uni", RING_W, rf)
        est = cm.roofline(pass_, "h100", prog, layout="zigzag", causal=True,
                          itemsize=2, **shape)
        rows.append((rec["name"], rec["ms"] / 1e3, est.floor_s))
    dec = dict(n_kv=4, group=4, d_head=128, pool_dtype="bf16", q_itemsize=2)
    rows.append((k6_rec["name"] + " (device)", k6_rec["graph_ms"] / 1e3,
                 cm.ragged_floor_s(PAGED_LENGTHS, **dec)))
    rows.append((k7_rec["name"] + " (device)", k7_rec["graph_ms"] / 1e3,
                 cm.ragged_floor_s(RAGGED_KV_LENS, q_lens=RAGGED_Q_LENS,
                                   **dec)))
    bad = costcheck.measured_floor_findings(rows)
    assert not bad, "\n".join(f.format() for f in bad)
    res = {"findings": 0, "rules": len(RULES), "not_run_on_cpu":
           sorted(not_run), "cpu_s": t_cpu, "card_s": t_card,
           "card_halves_s": halves, "instances": len(plans), "n_sm": n_sm,
           "floors": []}
    for name, meas, floor in rows:
        res["floors"].append({"name": name, "ms": meas * 1e3,
                              "floor_ms": floor * 1e3,
                              "ratio": meas / floor})
        print(f"analysis floor {name}: measured {meas * 1e3:.4f} ms, the "
              f"cost model's h100 floor {floor * 1e3:.4f} ms, ratio "
              f"{meas / floor:.3f}", flush=True)
    for want, (name, _, floor) in zip((35.576, 88.941), rows[:2]):
        assert abs(floor * 1e3 - want) <= 1e-3 * want, (name, floor, want)

    # the simulator calibrated from the fleet phase's bf16 run
    verdict = sim.fidelity_check(
        sim_in["trace"], sim_in["outcomes"],
        n_replicas=sim_in["n_replicas"], slots=sim_in["slots"],
        n_prefill=sim_in["n_prefill"])
    table = sim.rates_from_cost_table(generation="h100")
    cal = verdict["rates"]
    sim.save_rates(sim.SimRates(**cal),
                   os.path.join(_ckpt_dir().parent, "fleet_rates.json"))
    res["fidelity"] = {k: verdict[k] for k in (
        "measured_goodput", "simulated_goodput", "ratio", "rtol", "ok")}
    # the ship rate calibrates to infinity (folded into the prefill
    # span): JSON has no inf, so it is written as null
    res["rates"] = {"calibrated": {k: None if v == math.inf else v
                                   for k, v in cal.items()},
                    "table_h100": dict(table.__dict__)}
    res["rates_ratio"] = {k: cal[k] / getattr(table, k) for k in (
        "prefill_tokens_per_s", "decode_steps_per_s")}
    print(f"analysis sim: fidelity on the fleet's bf16 run: measured "
          f"goodput {verdict['measured_goodput']:.2f} tok/s (virtual), "
          f"simulated {verdict['simulated_goodput']:.2f}, ratio "
          f"{verdict['ratio']:.3f} (rtol {verdict['rtol']}); calibrated "
          f"rates prefill {cal['prefill_tokens_per_s']:.1f} tok/s, decode "
          f"{cal['decode_steps_per_s']:.2f} steps/s; the cost table's h100 "
          f"rates prefill {table.prefill_tokens_per_s:.1f} tok/s, decode "
          f"{table.decode_steps_per_s:.1f} steps/s; calibrated / table "
          + ", ".join(f"{k} {v:.3g}" for k, v in res["rates_ratio"].items()),
          flush=True)
    assert verdict["ok"], verdict
    res["seconds"] = time.perf_counter() - t0
    print(f"analysis phase: {res['seconds']:.1f} s", flush=True)
    return res


def _fuzz_tool():
    """tools/fuzz_checkpoint.py of this checkout, imported as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "fuzz_checkpoint.py")
    spec = importlib.util.spec_from_file_location("fuzz_checkpoint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FUZZ_LAYERS = 2  # the fuzz model: the serving width's first 2 layers


def fuzz_phase(device):
    """The crash-recovery fuzzer in-process on the card, at the serving
    width (SERVE_DIMS' fp32 weights, its first FUZZ_LAYERS layers): one
    sync seed through each engine (snapshot + journal and journal-only),
    one prefix-cache seed (3 kill points, mid-scale-scatter on an fp8
    pool), one pipelined seed (3 kill points), two transport seeds.
    Kernels 7, 1 and 6's counters are set to 0 before each seed and read
    after; every mode must be exact, killed and leak-free, and every seed
    must launch its engine's kernels.  Returns the launches summed and
    the per-mode results."""
    import dataclasses
    import tempfile

    import torch

    from burst_attn_tpu_torch.ops import flash, paged_attention, ragged_paged

    fz = _fuzz_tool()
    t0 = time.perf_counter()
    cfg, params = model(torch.float32, device)
    fm = fz.FuzzModel(dict(params, layers=params["layers"][:FUZZ_LAYERS]),
                      dataclasses.replace(cfg, n_layers=FUZZ_LAYERS), device)
    counters = {"ragged_paged": ragged_paged.ragged_paged_attention,
                "flash_fwd": flash.flash_fwd,
                "paged_decode": paged_attention.paged_decode_attention}
    launches = dict.fromkeys(counters, 0)
    res = {"modes": {}}

    def seed_run(what, fn):
        for f in counters.values():
            f.launches = 0
        t = time.perf_counter()
        out = fn()
        n = {k: f.launches for k, f in counters.items()}
        for k, v in n.items():
            launches[k] += v
        return out, n, time.perf_counter() - t

    strict = False
    with tempfile.TemporaryDirectory(dir=_ckpt_dir()) as td:
        for kind in ("ragged", "legacy"):
            r, n, sec = seed_run(kind, lambda: fz.run_seed(0, 4, td, fm,
                                                           kind))
            want = (("ragged_paged",) if kind == "ragged"
                    else ("flash_fwd", "paged_decode"))
            assert all(n[k] > 0 for k in want), (kind, n)
            for label in ("snapshot+journal", "journal-only"):
                res["modes"][f"{kind} {label}"] = r[label]
                strict = strict or r[label]["strict"]
            print(f"fuzz sync seed 0 ({kind}): {sec:.1f} s, launches "
                  f"kernel 7 {n['ragged_paged']}, kernel 1 "
                  f"{n['flash_fwd']}, kernel 6 {n['paged_decode']}",
                  flush=True)
        for what, fn in (("cache", fz.run_cache_seed),
                         ("pipeline", fz.run_pipeline_seed)):
            r, n, sec = seed_run(what, lambda: fn(0, 4, td, fm))
            assert n["ragged_paged"] > 0, (what, n)
            res["modes"].update({f"{what} {m}": v for m, v in r.items()})
            print(f"fuzz {what} seed 0: {sec:.1f} s, launches kernel 7 "
                  f"{n['ragged_paged']}, kernel 1 {n['flash_fwd']}, "
                  f"kernel 6 {n['paged_decode']}", flush=True)
    assert strict, "no sync recovery re-decoded fewer than the baseline"
    for name, r in res["modes"].items():
        k = r["launches"]
        print(f"fuzz {name}: exact={r['exact']} killed={r['killed']} "
              f"leak_free={r.get('leak_free', True)}"
              + (f" torn={r['torn']}" if "torn" in r else "")
              + f"; launches kernel 7 {k['ragged_paged_attention']}, "
              f"kernel 1 {k['flash_fwd']}, kernel 6 "
              f"{k['paged_decode_attention']}", flush=True)
        assert fz.mode_ok(r), (name, r)
    assert res["modes"]["cache mid-scale-scatter"]["torn"], \
        "the scale-scatter kill did not land between bytes and scales"
    for seed in (0, 1):
        st = fz.run_transport_seed(seed)
        print(f"fuzz transport seed {seed}: flipped {st['flipped']} "
              f"crc_rejected {st['crc_rejected']} dups "
              f"{st['dups']}/{st['dup_dropped']} torn {st['torn']} resent "
              f"{st['resent']}", flush=True)
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    print(f"fuzz phase: {len(res['modes'])} modes exact, killed and "
          f"leak-free at the serving width ({FUZZ_LAYERS} layers, fp32) "
          f"on {device}; launches kernel 7 {launches['ragged_paged']}, "
          f"kernel 1 {launches['flash_fwd']}, kernel 6 "
          f"{launches['paged_decode']}; {res['seconds']:.1f} s", flush=True)
    return res


def _stop_jobs(jobs):
    """Kill the processes of `jobs` ({name: (Popen, ...)}) still running."""
    for proc, *_ in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _mark(t_start, what):
    """Print the seconds since the smoke started, after `what`."""
    print(f"[{time.perf_counter() - t_start:.1f} s] {what} done", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # imported only now: run alone, outside a checkout, this raises
    from burst_attn_tpu_torch.ops import _build

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    # the analysis phase's SASS dumps (one cuobjdump a library) run beside
    # the phases before it; any still running at exit are stopped
    from burst_attn_tpu_torch.analysis import numerics

    sass_jobs = numerics.start_sass()
    atexit.register(_stop_jobs, sass_jobs)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    from burst_attn_tpu_torch.ops import flash, fused_ring, fused_ring_bwd

    # kernels 1-5, 8 and 9 per instance (cudaFuncGetAttributes)
    attrs_by_lib = {"flash_fwd": flash.fwd_attrs(),
                  "flash_bwd": flash.bwd_attrs(),
                  "fused_ring_fwd": fused_ring.fwd_attrs(),
                  "fused_ring_bwd": fused_ring_bwd.bwd_attrs()}
    # the STATS instances of kernels 8 and 9 (collect_stats): registers
    # and spills equal to the stats-off instances'
    stats_attrs = {"fused_ring_fwd": fused_ring.fwd_attrs(stats=True),
                   "fused_ring_bwd": fused_ring_bwd.bwd_attrs(stats=True)}
    for name, rows in stats_attrs.items():
        off = {a["instance"]: a for a in attrs_by_lib[name]}
        for a in rows:
            b = off[a["instance"][:-len(" stats")]]
            assert (a["regs"], a["local_bytes"]) == (
                b["regs"], b["local_bytes"]), (name, a, b)
    # the SEG instances (packed segments); the instances without SEG keep
    # their registers and spills
    seg_attrs = {"flash_fwd": flash.fwd_attrs(seg=True),
                 "flash_bwd": flash.bwd_attrs(seg=True),
                 "fused_ring_fwd": fused_ring.fwd_attrs(seg=True)
                 + fused_ring.fwd_attrs(stats=True, seg=True),
                 "fused_ring_bwd": fused_ring_bwd.bwd_attrs(seg=True)}
    # the WIN instances (the window band of kernels 2-5, 8 and 9); the
    # instances without SEG and WIN keep their registers and spills
    win_attrs = {"flash_bwd": flash.bwd_attrs(win=True)
                 + flash.bwd_attrs(seg=True, win=True),
                 "fused_ring_fwd": fused_ring.fwd_attrs(win=True)
                 + fused_ring.fwd_attrs(stats=True, win=True)
                 + fused_ring.fwd_attrs(seg=True, win=True)
                 + fused_ring.fwd_attrs(stats=True, seg=True, win=True),
                 "fused_ring_bwd": fused_ring_bwd.bwd_attrs(win=True)
                 + fused_ring_bwd.bwd_attrs(seg=True, win=True)}
    for name, rows in win_attrs.items():
        for a in rows:
            assert 0 < a["regs"] <= 255 and a["ctas"] >= 1, (name, a)
    for name, want in NO_SEG_ATTRS.items():
        got = {a["instance"]: (a["regs"], a["local_bytes"])
               for a in attrs_by_lib[name]}
        assert {k: got[k] for k in want} == want, (name, got, want)
    for name, rows in (list(attrs_by_lib.items()) + list(stats_attrs.items())
                       + list(seg_attrs.items()) + list(win_attrs.items())):
        for a in rows:
            print(f"{name} {a['instance']}: {a['regs']} registers, "
                  f"{a['local_bytes']} local (spill) bytes a thread, "
                  f"{a['smem']} B of shared memory, {a['ctas']} CTAs "
                  f"resident", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, fp32 = torch.bfloat16, torch.float32
    check_flash(device, dtype=fp32, timing=False)
    check_paged_decode(device, dtype=fp32, timing=False)
    quant_ms = {q: check_paged_decode(device, dtype=dt, quant=q)[1]
                for q, dt in (("int8", fp32), ("fp8", bf16))}
    for dt, q in ((fp32, None), (fp32, "int8"), (bf16, "int8"),
                  (bf16, "fp8")):
        check_ragged(device, dt, q)
    for dt in (fp32, bf16):
        check_ragged_partials(device, dt)
    for dt, q in ((bf16, None), (fp32, None), (bf16, "int8")):
        check_ragged_decode_rows(device, dt, q)
    group_err = check_ragged_groups(device)
    long_err = check_decode_long(device)
    torch.cuda.empty_cache()
    kernels = [check_flash(device), check_paged_decode(device),
               check_ragged(device, bf16, timing=True)]
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], long_err,
                                    group_err)
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], group_err)
    # kernel 1 on the prefix cache's suffix mask
    suffix_rec = check_flash_suffix(device)
    # sliding-window kernels 1, 6, 7 and kernel 10 (the step probe)
    window_recs = [check_flash_window(device),
                   check_paged_decode_window(device),
                   check_ragged_window(device), check_step_probe(device)]
    torch.cuda.empty_cache()
    probe = probe_phase(device, card)
    bwd_worst = {"fused": [0.0] * 3, "split": [0.0] * 3}
    for dt in (fp32, bf16):
        for route, errs in check_flash_bwd(device, dt).items():
            bwd_worst[route] = [max(a, b)
                                for a, b in zip(bwd_worst[route], errs)]
    autograd_err = check_flash_autograd(device)
    # the forward kernel at the train step's shape (B1 N16/16 S8192 bf16)
    fwd_err = check_flash(device, n=TRAIN_DIMS["n_heads"],
                          n_kv=TRAIN_DIMS["n_kv_heads"], s=TRAIN_SEQ,
                          timing=False)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], fwd_err)
    torch.cuda.empty_cache()  # the plain tile's transient
    kernels[0]["train_shape"] = time_flash_train(device)
    bwd_recs, split_ms = time_flash_bwd(device, bwd_worst)
    kernels += bwd_recs
    # each record's instances (kernel 1's serving and train rows share them)
    by_label = {a["instance"]: a for rows in (attrs_by_lib["flash_fwd"],
                                              attrs_by_lib["flash_bwd"])
                for a in rows}
    for rec, labels in zip([kernels[0], window_recs[0], *bwd_recs],
                           (("bf16", "bf16 acc", "fp32"), ("bf16 window",),
                            ("bf16 fused", "fp32 fused"), ("bf16 dq",),
                            ("bf16 dkdv",))):
        rec["attrs"] = [by_label[x] for x in labels]
    torch.cuda.empty_cache()
    fused_err = check_fused_ring(device)
    ring_rec = ring_op_phase(device)
    ring_rec["attrs"] = attrs_by_lib["fused_ring_fwd"]
    ring_rec["max_abs_err"] = max(ring_rec["max_abs_err"], fused_err)
    kernels.append(ring_rec)
    torch.cuda.empty_cache()
    fused_bwd_err = check_fused_ring_bwd(device)
    ring_bwd_rec = ring_bwd_op_phase(device)
    ring_bwd_rec["attrs"] = attrs_by_lib["fused_ring_bwd"]
    ring_bwd_rec["max_abs_err"] = max(ring_bwd_rec["max_abs_err"],
                                      fused_bwd_err)
    kernels.append(ring_bwd_rec)
    torch.cuda.empty_cache()
    # packed documents: the SEG instances of kernels 1-5, 8 and 9
    t_seg = time.perf_counter()
    seg_worst = check_flash_segments(device)
    seg_k8_err, seg_k9_err = check_ring_segments(device)
    seg_recs = time_flash_segments(device, seg_worst)
    seg_lib = {p: (seg_recs[0]["seg"][p]["library_ms"],
                   seg_recs[1]["seg"][p]["library_ms"])
               for p in _seg_patterns(TRAIN_SEQ)}
    seg_recs += time_ring_segments(device, seg_lib)
    seg_recs[4]["max_abs_err"] = max(seg_recs[4]["max_abs_err"], seg_k8_err)
    seg_recs[5]["max_abs_err"] = max(seg_recs[5]["max_abs_err"], seg_k9_err)
    for rec, lib, labels in zip(seg_recs, (
            "flash_fwd", "flash_bwd", "flash_bwd", "flash_bwd",
            "fused_ring_fwd", "fused_ring_bwd"), (
            None, ("bf16 fused seg", "fp32 fused seg"), ("bf16 dq seg",),
            ("bf16 dkdv seg",), None, None)):
        rec["attrs"] = [a for a in seg_attrs[lib]
                        if labels is None or a["instance"] in labels]
    print(f"packed-segment kernel phases: {time.perf_counter() - t_seg:.1f} "
          "s", flush=True)
    torch.cuda.empty_cache()
    # windowed training: the WIN instances of kernels 2-5, 8 and 9
    t_win = time.perf_counter()
    win_worst = check_flash_bwd_window(device)
    win_k8_err, win_k9_err, _ = check_ring_window(device)
    win_recs = time_flash_bwd_window(device, win_worst)
    win_recs += time_ring_window(
        device, (win_recs[0]["window"]["library_fwd_ms"],
                 win_recs[0]["library_ms"]), (win_k8_err, win_k9_err))
    for rec, lib, labels in zip(win_recs, (
            "flash_bwd", "flash_bwd", "flash_bwd", "fused_ring_fwd",
            "fused_ring_bwd"), (
            ("bf16 fused win", "fp32 fused win"), ("bf16 dq win",),
            ("bf16 dkdv win",), None, None)):
        rec["attrs"] = [a for a in win_attrs[lib]
                        if (labels is None and " seg" not in a["instance"]
                            and " stats" not in a["instance"])
                        or (labels is not None and a["instance"] in labels)]
    wbench = window_bench_phase(device)
    print(f"window kernel phases: {time.perf_counter() - t_win:.1f} s",
          flush=True)
    torch.cuda.empty_cache()

    _mark(t_start, "kernel phases")
    serve_res = serve_engine_phase(device)
    print(f"ServeEngine prefill {len(serve_res['bf16']['prompts'][1])} "
          f"tokens: {serve_res['prefill_ms']:.2f} ms; decode step "
          f"({SLOTS} slots): {serve_res['decode_step_ms']:.2f} ms = "
          f"{SLOTS * 1e3 / serve_res['decode_step_ms']:.1f} tok/s",
          flush=True)
    print_profile("ServeEngine prefill", serve_res["prof_prefill"])
    print_profile("ServeEngine decode step", serve_res["prof_step"])
    tpsrv = tp_serve_phase(device, serve_res)
    sprefix = serve_prefix_phase(device)

    rag = ragged_engine_phase(device, serve_res)
    print(f"RaggedServeEngine TTFT, one 2048-token prompt "
          f"({rag['ttft_ticks']} chunks): {rag['ttft_ms']:.2f} ms; decode "
          f"tick ({SLOTS} slots at ~2K): {rag['decode_tick_ms']:.2f} ms = "
          f"{SLOTS * 1e3 / rag['decode_tick_ms']:.1f} tok/s; mixed tick "
          f"(one {CHUNK}-token chunk + {SLOTS - 1} decodes): "
          f"{rag['mixed_tick_ms']:.2f} ms", flush=True)
    print_profile("RaggedServeEngine mixed tick", rag["prof_mixed"])
    print_profile("RaggedServeEngine decode tick", rag["prof_decode"])
    pipe = pipelined_phase(device, rag)
    pticks = pipelined_ticks(device)
    tm = pticks["tick_ms"]
    print(f"pipelined decode tick ({SLOTS} slots at ~2K, bf16), ms a tick "
          f"(mean of two turns): synchronous {tm['sync']:.3f}, K=1 "
          f"{tm['k1']:.3f}, K={K_PIPE} {tm['k4']:.3f}; busy synchronous "
          f"{pticks['busy_sync']:.3f}, K=1 {pticks['busy_k1']:.3f}, "
          f"K={K_PIPE} {pticks['busy_k4']:.3f}; K={K_PIPE} graph captures "
          f"{pticks['k4_graphs']['captures']}, replays "
          f"{pticks['k4_graphs']['replays']}", flush=True)
    for name, what in (("sync", "synchronous"), ("k1", "K=1"),
                       ("k4", f"K={K_PIPE}")):
        print_profile(f"pipelined decode step, {what} "
                      f"({pticks[f'ticks_profiled_{name}']:.0f} ticks in 4 "
                      f"steps)", pticks[f"prof_{name}"])
    _mark(t_start, "serving phases")
    verify_err, verify_rec, spec = speculative_phase(device, serve_res, rag)
    ckpt_res = checkpoint_phase(device)
    _mark(t_start, "speculative and checkpoint phases")
    wserve = window_serve_phase(device)
    k8_err, k1_err = check_handoff_kernels(device)
    ring_rec["max_abs_err"] = max(ring_rec["max_abs_err"], k8_err)
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], k1_err)
    # kernel 9 at the handoff's op shape (kernel 8 was held there above)
    _, k9_err, _ = check_ring_kernels_at(
        device, "the handoff's op shape", HANDOFF_SP,
        SERVE_DIMS["n_heads"], SERVE_DIMS["n_kv_heads"],
        HANDOFF_PROMPT // HANDOFF_SP, seed=23, fwd=False,
        head_chunk=SERVE_DIMS["n_heads"] // SERVE_DIMS["n_kv_heads"])
    ring_bwd_rec["max_abs_err"] = max(ring_bwd_rec["max_abs_err"], k9_err)
    hand = handoff_phase(device)
    print_profile("handoff prefill, fused ring",
                  hand["prof_prefill_fused_ring"])
    print_profile("handoff prefill, scan ring", hand["prof_prefill_auto"])
    print_profile("handoff decode step", hand["prof_decode_fused_ring"])
    dist = dist_generate_phase(device, hand)
    t_wd = time.perf_counter()
    wdist = window_dist_phase(device, hand)
    print(f"windowed dist_generate phase: {time.perf_counter() - t_wd:.1f} s",
          flush=True)
    print_profile("dist_generate prefill, fused ring",
                  dist["prof_prefill_fused_ring"])
    print_profile("dist_generate prefill, scan ring",
                  dist["prof_prefill_auto"])
    print_profile("dist_generate decode step", dist["prof_decode_fused_ring"])
    _mark(t_start, "window serving, handoff and dist_generate phases")
    dstats = devstats_phase(device)
    obs_res = obs_phase(device, pticks)

    _mark(t_start, "devstats and obs phases")
    fleet_res = fleet_phase(device)
    _mark(t_start, "fleet phase")
    analysis_res = analysis_phase(
        fleet_res["_sim"], ring_rec, ring_bwd_rec, kernels[1], kernels[2],
        sass_jobs)
    _mark(t_start, "analysis phase")
    fuzz_res = fuzz_phase(device)
    _mark(t_start, "fuzz phase")
    moe_srv = moe_serve_phase(device, serve_res, rag, hand)
    _MOE_PARAMS.clear()
    _mark(t_start, "moe serve phase")
    _PARAMS.clear()  # the serving models' weights
    torch.cuda.empty_cache()
    tr = train_phase(device)
    print_profile("train step", tr["prof"])
    # kernels 8 and 9 at the shape the ring train step gives them
    k8_err, k9_err, step_shape = check_ring_kernels_at(
        device, "the ring train step's shape", RING_TRAIN_SP,
        TRAIN_DIMS["n_heads"], TRAIN_DIMS["n_kv_heads"],
        TRAIN_SEQ // RING_TRAIN_SP, seed=29, timing=True)
    ring_rec["ring_step_ms"] = step_shape["k8_ms"]
    ring_bwd_rec["ring_step_ms"] = step_shape["k9_ms"]
    # the STATS instances: attrs, and their time beside the stats-off time
    for rec, kern, lib in ((ring_rec, "k8_launch", "fused_ring_fwd"),
                           (ring_bwd_rec, "k9", "fused_ring_bwd")):
        rec["stats"] = {
            "attrs": stats_attrs[lib], "ring_step_ms": step_shape[
                f"{kern}_stats_ms"],
            "ring_step_ms_off": step_shape[f"{kern}_ms"],
            "turns_ms": {"off": step_shape[f"{kern}_ms_turns"],
                         "on": step_shape[f"{kern}_stats_ms_turns"]}}
    ring_rec["stats"]["collect_stats_call_ms"] = step_shape[
        "k8_stats_call_ms"]
    ring_bwd_rec["ring_step_trace"] = {
        k: step_shape[k] for k in ("k9_fold_wait_share",
                                   "k9_phase_wait_share", "k9_ctas")}
    ring_rec["max_abs_err"] = max(ring_rec["max_abs_err"], k8_err)
    ring_bwd_rec["max_abs_err"] = max(ring_bwd_rec["max_abs_err"], k9_err)
    _mark(t_start, "train phase and ring kernels at the step's shape")
    ring_tr = ring_train_phase(device, tr)
    t_packed = time.perf_counter()
    ptr = packed_train_phase(device)
    pring = packed_ring_train_phase(device, ptr)
    t_wt = time.perf_counter()
    wtr = window_train_phase(device)
    wring = window_ring_train_phase(device, wtr)
    print(f"windowed training phases: {time.perf_counter() - t_wt:.1f} s",
          flush=True)
    uly = ulysses_train_phase(device, tr, ring_tr)
    uly_rows = ulysses_rows(device)
    _mark(t_start, "ulysses train phase")
    mtr = mesh_train_phase(device)
    _mark(t_start, "mesh train phase")
    # the multihost phase's two processes boot beside the mesh2 phase
    mh_run = MultihostPhase(device)
    m2 = mesh2_train_phase(device)
    _mark(t_start, "mesh2 train phase")
    mh = mh_run.finish()
    _mark(t_start, "multihost phase")
    pp_res = pp_train_phase(device)
    _mark(t_start, "pp train phase")
    _SEED_PARAMS.clear()  # the training model's seed-0 weights
    torch.cuda.empty_cache()
    moe_tr = moe_train_phase(device)
    _mark(t_start, "moe train phase")
    wire_recs, wire_res = wire_phase(device)
    sw_recs, sw_res = seg_wire_phase(device)
    _mark(t_start, "wire and seg+wire phases")
    parity = train_parity(device)
    ring_parity = ring_train_parity(device)
    fit_res = runner_phase(device)
    ring_fit = runner_phase(device, mesh={"sp": RING_TRAIN_SP})
    pfit = runner_phase(device, packed_eos_id=0)
    print(f"packed training phases: {time.perf_counter() - t_packed:.1f} s "
          "(with the phases between them)", flush=True)

    _mark(t_start, "training phases")
    launches = {"flash_fwd": serve_res["bf16"]["launches"]["flash_fwd"],
                "paged_decode": serve_res["bf16"]["launches"][
                    "paged_decode_attention"],
                "ragged_paged": rag["bf16"]["launches"],
                "flash_bwd_fused": tr["launches"]["fused"],
                "flash_bwd_dq": tr["split_launches"]["dq"],
                "flash_bwd_dkdv": tr["split_launches"]["dkdv"],
                # the handoff's prefill and the ring train step's
                "fused_ring_fwd": hand["launches_fused_ring"][
                    "fused_ring_fwd"] + ring_tr["fused_ring"]["launches"][
                    "fused_ring_fwd"] + dist["launches_fused_ring"][
                    "fused_ring_fwd"],
                "fused_ring_bwd": ring_tr["fused_ring"]["launches"][
                    "fused_ring_bwd"],
                # the windowed serve phase's bf16 runs, the probe's sweep
                "flash_fwd[window]": wserve["ServeEngine_bf16_launches"][
                    "flash_fwd"],
                "paged_decode[window]": wserve["ServeEngine_bf16_launches"][
                    "paged_decode_attention"],
                "ragged_paged[window]": wserve[
                    "RaggedServeEngine_bf16_launches"][
                    "ragged_paged_attention"],
                "step_probe": probe["launches"],
                # the ServeEngine prefix wave's suffix prefills
                "flash_fwd[suffix]": sprefix["suffix_launches"],
                # the packed train step (its split step for kernels 4-5),
                # the packed ring step's scan route and the packed fit
                # (kernels 1-3), the packed ring step's fused route
                # (kernels 8-9): SEG instances only
                "flash_fwd[seg]": sum(x["flash_fwd_seg"] for x in (
                    ptr["launches"], pring["auto"]["launches"],
                    pfit["launches"])),
                "flash_bwd_fused[seg]": sum(x["fused_seg"] for x in (
                    ptr["launches"], pring["auto"]["launches"],
                    pfit["launches"])),
                "flash_bwd_dq[seg]": ptr["split_launches"]["dq_seg"],
                "flash_bwd_dkdv[seg]": ptr["split_launches"]["dkdv_seg"],
                "fused_ring_fwd[seg]": pring["fused_ring"]["launches"][
                    "fused_ring_fwd_seg"],
                "fused_ring_bwd[seg]": pring["fused_ring"]["launches"][
                    "fused_ring_bwd_seg"],
                # the windowed train step (its split step for kernels
                # 4-5), the windowed ring step's scan route (kernels 1-3)
                # and fused route (kernels 8-9), the windowed
                # dist_generate's prefills: WIN instances only
                "flash_bwd_fused[window]": wtr["launches"]["fused_win"]
                + wring["auto"]["launches"]["fused_win"],
                "flash_bwd_dq[window]": wtr["split_launches"]["dq_win"]
                + wtr["launches"]["dq_win"]
                + wring["auto"]["launches"]["dq_win"],
                "flash_bwd_dkdv[window]": wtr["split_launches"]["dkdv_win"]
                + wtr["launches"]["dkdv_win"]
                + wring["auto"]["launches"]["dkdv_win"],
                "fused_ring_fwd[window]": wring["fused_ring"]["launches"][
                    "fused_ring_fwd_win"]
                + wdist["launches_fused_ring"]["fused_ring_fwd"],
                "fused_ring_bwd[window]": wring["fused_ring"]["launches"][
                    "fused_ring_bwd_win"]}
    # kernel 1's WIN instance on the training paths too
    launches["flash_fwd[window]"] += (
        wtr["launches"]["flash_fwd_win"]
        + wring["auto"]["launches"]["flash_fwd_win"]
        + wdist["launches_auto"]["flash_fwd"])
    # the MoE models: the serve phase's bf16 engine runs (kernels 1, 6,
    # 7) and its fp32 dist_generate (kernel 8 fused, kernel 1 on the scan
    # route), the MoE train step's timed steps (kernels 1 and 2-3); the
    # Ulysses train step's timed steps (kernels 1 and 2-3 at its shape)
    moe_launches = {
        "flash_fwd": moe_srv["launches"]["flash_fwd"]
        + moe_srv["dist_launches"]["auto"]["flash_fwd"]
        + moe_tr["launches"]["flash_fwd"],
        "paged_decode": moe_srv["launches"]["paged_decode_attention"],
        "ragged_paged": moe_srv["launches"]["ragged_paged_attention"],
        "flash_bwd_fused": moe_tr["launches"]["fused"],
        "fused_ring_fwd": moe_srv["dist_launches"]["fused_ring"][
            "fused_ring_fwd"]}
    for name, n in moe_launches.items():
        assert n > 0, moe_launches
        launches[name] += n
    launches["flash_fwd[ulysses]"] = uly["launches"]["flash_fwd"]
    launches["flash_bwd_fused[ulysses]"] = uly["launches"]["fused"]
    # the pipeline-parallel model: the pp=4 steps (kernel 1 and the fused
    # backward, its split step kernels 4-5), the pp=2 x sp=2 steps and fit
    # on the fused ring (kernels 8-9)
    pp4, pp22, ppfit = (pp_res["pp4"], pp_res["pp2 x sp2"],
                        pp_res["fit"]["launches"])
    pp_launches = {
        "flash_fwd": pp4["launches"]["flash_fwd"]
        + pp4["split_launches"]["flash_fwd"],
        "flash_bwd_fused": pp4["launches"]["fused"],
        "flash_bwd_dq": pp4["split_launches"]["dq"],
        "flash_bwd_dkdv": pp4["split_launches"]["dkdv"],
        "fused_ring_fwd": pp22["launches"]["fused_ring_fwd"]
        + ppfit["fused_ring_fwd"],
        "fused_ring_bwd": pp22["launches"]["fused_ring_bwd"]
        + ppfit["fused_ring_bwd"]}
    for name, n in pp_launches.items():
        assert n > 0, pp_launches
        launches[name] += n
    # the wire and seg+wire phases' burst_attn calls on the fused route
    for rec in wire_recs + sw_recs:
        launches[rec["name"]] = rec["launches"]
    for rec in seg_recs + win_recs + uly_rows + wire_recs + sw_recs:
        assert launches[rec["name"]] > 0, (rec["name"], launches)
    kernels += (window_recs + [suffix_rec] + seg_recs + win_recs + uly_rows
                + wire_recs + sw_recs)
    # tensor parallelism: the tp phase's engines (kernels 1 and 6, every
    # tp position's launches), the mesh train step (kernels 8 and 9, every
    # dp group's, its tp positions' heads in one launch)
    tp_launches = {"flash_fwd": tpsrv["launches"]["flash_fwd"],
                   "paged_decode": tpsrv["launches"][
                       "paged_decode_attention"]}
    mesh_launches = {
        "fused_ring_fwd": sum(mtr["mesh"]["launches_per_step"][
            "fused_ring_fwd"] for _ in mtr["mesh"]["losses"]),
        "fused_ring_bwd": sum(mtr["mesh"]["launches_per_step"][
            "fused_ring_bwd"] for _ in mtr["mesh"]["losses"])}
    # the mesh2 phase: the pp x dp x sp x tp steps, the fp32 pp
    # x tp x sp MoE parity and the pp x dp fit (kernels 8-9), the MoE steps
    # with and without the experts on dp (kernels 8-9), the Ulysses x tp
    # steps (kernels 1 and 2-3, every sequence position's launch over both
    # tp groups' heads)
    def _steps(r, name):
        return r["launches_per_step"][name] * len(r["losses"])

    pp_mesh_launches = {
        name: _steps(m2["pp_dp_sp_tp"], name) + m2["fit"]["launches"][name]
        + m2["pp_tp_moe_parity"]["launches"][name]
        for name in ("fused_ring_fwd", "fused_ring_bwd")}
    ep_launches = {
        name: sum(_steps(r, name) for r in (
            m2["moe_ep_on_dp"], m2["moe_ep_on_dp"]["no_expert_axis"]))
        for name in ("fused_ring_fwd", "fused_ring_bwd")}
    uly_tp_launches = {"flash_fwd": _steps(m2["ulysses_tp"], "flash_fwd"),
                       "flash_bwd_fused": _steps(m2["ulysses_tp"], "fused")}
    # the multihost phase's two processes: the ring op across them and the
    # dp train step (kernels 1-5 by the route each round takes)
    mh_launches = {name: mh["launches"].get(key, 0) for name, key in (
        ("flash_fwd", "flash_fwd"), ("flash_bwd_fused", "fused"),
        ("flash_bwd_dq", "dq"), ("flash_bwd_dkdv", "dkdv"))}
    mh_launches = {k: v for k, v in mh_launches.items() if v}
    assert mh_launches.get("flash_fwd"), mh_launches
    for extra in (tp_launches, mesh_launches, pp_mesh_launches, ep_launches,
                  uly_tp_launches, mh_launches):
        for name, n in extra.items():
            assert n > 0, extra
            launches[name] += n
    kernels[2]["pipelined_launches"] = pipe["launches"]
    assert pipe["launches"] > 0
    # the speculative phase's bf16 early-exit runs of both engines
    spec_launches = {
        name: sum(spec["engines"][e]["bf16_exit"][fn]
                  for e in ("ServeEngine", "RaggedServeEngine"))
        for name, fn in (("flash_fwd", "flash_fwd"),
                         ("paged_decode", "paged_decode_attention"),
                         ("ragged_paged", "ragged_paged_attention"))}
    for name, n in spec_launches.items():
        assert n > 0, spec_launches
        launches[name] += n
    kernels[2]["spec_verify"] = verify_rec | {"launches": sum(
        spec["engines"][e]["bf16_exit"]["spec_verify"]
        for e in ("ServeEngine", "RaggedServeEngine"))}
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"], verify_err)
    # the checkpoint phase's bf16 restored and recovered runs, and the
    # handoff's two checkpointed prefills
    ckpt_launches = {
        "flash_fwd": ckpt_res["launches"]["flash_fwd"],
        "paged_decode": ckpt_res["launches"]["paged_decode_attention"],
        "ragged_paged": ckpt_res["launches"]["ragged_paged_attention"],
        "fused_ring_fwd": hand["launches_checkpoint"]["fused_ring_fwd"]}
    for name, n in ckpt_launches.items():
        assert n > 0, ckpt_launches
        launches[name] += n
    # serving under load: the in-process replays' kernel 7, the cluster's
    # ServeEngine workers' kernels 1 and 6 and the fleet's prefill
    # worker's kernel 8, as the workers reported them
    for name, n in fleet_res["launches"].items():
        launches[name] += n
    # the fuzz phase's seeds (kernel 7 in every ragged tick and K=4 graph,
    # kernels 1 and 6 in the ServeEngine's)
    for name, n in fuzz_res["launches"].items():
        assert n > 0, fuzz_res["launches"]
        launches[name] += n
    for rec in kernels:
        rec["launches"] = launches[rec["name"]]
        if rec["name"] in spec_launches:
            rec["speculative_launches"] = spec_launches[rec["name"]]
        if rec["name"] in ckpt_launches:
            rec["checkpoint_launches"] = ckpt_launches[rec["name"]]
        if rec["name"] in moe_launches:
            rec["moe_launches"] = moe_launches[rec["name"]]
        if rec["name"] in fuzz_res["launches"]:
            rec["fuzz_launches"] = fuzz_res["launches"][rec["name"]]
        if rec["name"] in pp_launches:
            rec["pp_launches"] = pp_launches[rec["name"]]
        if rec["name"] in fleet_res["launches"]:
            rec["fleet_launches"] = fleet_res["launches"][rec["name"]]
        if rec["name"] in tp_launches:
            rec["tp_launches"] = tp_launches[rec["name"]]
        if rec["name"] in mesh_launches:
            rec["mesh_launches"] = mesh_launches[rec["name"]]
        for tag, extra in (("pp_mesh_launches", pp_mesh_launches),
                           ("ep_launches", ep_launches),
                           ("ulysses_tp_launches", uly_tp_launches),
                           ("multihost_launches", mh_launches)):
            if rec["name"] in extra:
                rec[tag] = extra[rec["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    wall, dev, _ = tr["prof"]
    print(json.dumps({"train": {
        k: tr[k] for k in ("n_params", "seq", "step_ms", "step_ms_all",
                           "tokens_per_s", "model_tflops_per_s", "mfu",
                           "losses", "grad_norms", "launches_per_step",
                           "peak_gb", "split_step_ms", "split_losses",
                           "control_losses", "control_step_ms")}
        | {"profiled_step_ms": wall, "device_ms": dev, "busy": dev / wall,
           "bwd_split_pair_ms": split_ms,
           "autograd_max_abs_err": autograd_err,
           "parity": parity, "fit": fit_res,
           "ring": {"mesh": {"sp": RING_TRAIN_SP},
                    **{route: {k: v for k, v in r.items() if k != "prof"}
                       | {"profiled_step_ms": r["prof"][0],
                          "device_ms": r["prof"][1]}
                       for route, r in ring_tr.items()},
                    "parity": ring_parity, "fit": ring_fit},
           "packed": ptr, "packed_ring": pring, "packed_fit": pfit},
        "card": card}))
    print(json.dumps({
        "kernels": [{k: r[k] for k in keys}
                    | {k: r[k] for k in ("library", "graph_ms",
                                         "library_graph_ms", "ring_step_ms",
                                         "ring_step_trace", "train_shape",
                                         "routes", "attrs",
                                         "pipelined_launches", "spec_verify",
                                         "speculative_launches",
                                         "checkpoint_launches",
                                         "moe_launches", "pp_launches",
                                         "fleet_launches", "tp_launches",
                                         "mesh_launches", "pp_mesh_launches",
                                         "ep_launches", "ulysses_tp_launches",
                                         "multihost_launches", "stats",
                                         "seg", "window", "wire")
                       if k in r}
                    for r in kernels],
        "card": card,
        "window_serve": {k: v for k, v in wserve.items()
                         if k != "fp32_prompts"},
        "step_probe_fit": probe["fit"],
        "paged_decode_quant_graph_ms": quant_ms,
        "serve": {"prefill_ms": serve_res["prefill_ms"],
                  "decode_step_ms": serve_res["decode_step_ms"],
                  "run_s": serve_res["bf16"]["run_s"],
                  "n_generated": serve_res["bf16"]["n_gen"],
                  "control_agree": serve_res["control"],
                  "int8_identical": serve_res["quant"][0]},
        "ragged": {k: rag[k] for k in ("ttft_ms", "decode_tick_ms",
                                       "mixed_tick_ms", "control",
                                       "bf16_int8_agree", "prefix")}
        | {"run_s": rag["bf16"]["run_s"], "ticks": rag["bf16"]["ticks"],
           "quant_identical": {q: v[0] for q, v in rag["quant"].items()}},
        "pipelined": {k: v for k, v in pipe.items() if k != "launches"}
        | {k: v for k, v in pticks.items() if not k.startswith("prof_")},
        "serve_prefix": sprefix,
        "speculative": spec,
        "checkpoint": ckpt_res,
        "ring": {k: ring_rec[k] for k in ("op_ms", "scan_ms",
                                          "scan_launches",
                                          "fused_vs_scan_err")},
        "ring_bwd": {k: ring_bwd_rec[k] for k in (
            "op_ms", "scan_op_ms", "library_fwd_bwd_ms",
            "fused_vs_scan_grad_err")},
        "handoff": {k: v for k, v in hand.items()
                    if not k.startswith(("prof_", "_"))},
        "dist_generate": {k: v for k, v in dist.items()
                          if not k.startswith("prof_")}
        | {k: v[:2] for k, v in dist.items() if k.startswith("prof_")},
        "devstats": dstats,
        "obs": obs_res,
        "window_train": wtr,
        "window_ring_train": {k: v for k, v in wring.items()},
        "window_dist_generate": wdist,
        "window_bench": wbench,
        "moe_serve": moe_srv,
        "moe_train": {k: v for k, v in moe_tr.items() if k != "prof"}
        | {"profiled_step_ms": moe_tr["prof"][0],
           "device_ms": moe_tr["prof"][1]},
        "ulysses_train": uly,
        "pp_train": pp_res,
        "wire": wire_res,
        "seg_wire": sw_res,
        "tp_serve": {k: v for k, v in tpsrv.items() if k != "launches"},
        "mesh_train": mtr,
        "mesh2_train": m2,
        "multihost": mh,
        "fleet": {k: v for k, v in fleet_res.items()
                  if k not in ("launches", "_sim")},
        "analysis": analysis_res,
        "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
