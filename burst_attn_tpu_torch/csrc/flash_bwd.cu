// Flash-attention backward: the split dq and dk/dv kernels and the fused
// dq+dk+dv kernel.
//
// Replaces: burst_attn_tpu/ops/pallas_flash.py `_dq_kernel` (l.865) and
// `_dkdv_kernel` (l.945) (the split backward of `flash_bwd`), and
// `_bwd_fused_kernel` (l.1127, via `_flash_bwd_fused`) and
// `_bwd_fused_tri_kernel` (l.1379, via `_flash_bwd_fused_tri`), the fused
// single-pass backward on the rectangular and the wrapped-diagonal causal
// grids.  All compute ops/tile.py:tile_bwd.
//
// Contract: dO, q [B,N,Sq,D], k, v [B,Nk,Skv,D] (bf16 or fp32; GQA: query
// head h reads kv head h / (N/Nk)), delta = sum(o*dO, -1) and the final
// lse [B,N,Sq] fp32 (natural log).  Outputs fp32 dq [B,N,Sq,D] and dk, dv
// [B,Nk,Skv,D].  The mask scalars (q_lo, q_hi, kv_hi, causal, offset)
// arrive by value; ragged lengths are masked in-kernel, and rows whose
// lse is -inf contribute exact zeros.  With SEG (a template flag of every
// kernel; null id pointers take the instances without it) q_ids [B,Sq]
// and kv_ids [B,Skv] int32 pack documents into a row: a pair counts only
// where the ids are equal (pallas_flash.py `_block_mask`).  P and dS are
// zeroed by that test itself, in full tiles too (a tile is full for the
// mask scalars, not for the ids); every tile the scalars leave is
// computed, skipping tiles that share no document is later work.  With
// WIN (another template flag; window 0 takes the instances without it)
// the mask gains the sliding-window band: row r sees column c only where
// c > r + offset - window (pallas_flash.py `_block_mask` with `wnd`).
// Each kv-tile CTA sweeps only the q tiles whose band reaches it, from
// the diagonal up to the last row with row + offset - window < its last
// visible column (flash_bwd_tile.cuh kv_tile_rows: the banded fused sweep
// of `_bwd_fused_kernel`, l.1127, as a loop bound), and each dq CTA the kv
// chunks from its first row's band start (q_tile_cols); a tile the band
// cuts tests it per element, a tile inside it does not (the full-tile
// shortcut of mma_bwd_tile.cuh's step checks the band too).  A window at
// or above the sequence leaves every range and value as the instance
// without WIN computes them: the two are bitwise equal.
//
// Per (q tile i, kv tile j) step, with P = exp2(S*scale*log2e - lse*log2e):
//   S = Q K^T, dP = dO V^T, dS = P * (dP - delta),
//   dV += P^T dO, dK += dS^T Q, dQ += dS K;
// dq and dk are multiplied by the scale once, at the end (pallas_flash.py
// l.1210 does the same for dk).
//
// What bounds it on an H100: tensor FLOPs.  The causal training shape
// (S = 8192, 16 heads, D = 128) is ~0.69 TFLOP of five matmuls against
// ~0.1 GB of traffic.  Causal loops start at the diagonal so dead tiles
// cost nothing (the CUDA counterpart of the TPU kernel's triangular grid).
// The bf16 instances run on the tensor cores, the fp32 ones on SIMT:
//  * the fused kernel's bf16 instance (kernels 2-3 on the train step and
//    every scan-ring round) runs on the tile of the
//    fused ring backward's bf16 instance (mma_bwd_tile.cuh: eight warps on
//    mma.sync m16n8k16, K and V of the CTA's kv tile in shared memory as
//    bf16, dK and dV in accumulator fragments, Q and dO of the next q
//    tile landing by cp.async.cg in a second stage while this step's
//    products run, P and dS rebuilt in registers and fed to their
//    products as two bf16 terms, so the gradients hold the fp32 plain
//    version's tolerance; ~156 KB of shared memory, one CTA an SM).  It
//    issues 16 * D flops an attended pair on mma.sync, below wgmma's
//    rate; a TMA producer warp feeding wgmma is the next step.
//  * the split pair's bf16 instances (kernels 4-5): dq on the forward's
//    tile (mma_tile.cuh, four warps of 16 q rows, K and V streamed in two
//    cp.async stages, 4 products a pair-tile, ~104 KB, two CTAs an SM:
//    flash_bwd_dq_mma), dk/dv on the fused kernel's tile without parts
//    3-4 and the fold (6 products a step: flash_bwd_dkdv_mma); both feed
//    P and dS as two bf16 terms, so they hold the same tolerance.
//  * the fp32 instances are the first version: SIMT fp32 on the CUDA
//    cores (no tensor cores, no TMA), exact to the plain version's fp32
//    math up to summation order; the fp32 parity checks rest on them.
//    Every operand tile is read from device memory once per step into
//    shared memory as fp32, and each thread keeps a 4x4 block of S and dP
//    (or an 8x4 block of dK, dV, dQ) in registers.
//
// Kernels (no atomics in the split pair: two launches are bitwise equal):
//   flash_bwd_dq    one CTA per (b, q head, 64-row q tile); Q, dO resident;
//                   loops over the kv tiles it can see; writes dq once.
//   flash_bwd_dkdv  one CTA per (b, kv head, 64-row kv tile); K, V
//                   resident; loops over the group's q heads and the q
//                   tiles that can see tile j; the GQA sum happens in the
//                   CTA; writes dk, dv once.
//   flash_bwd_fused the dkdv kernel that also folds dS K into an fp32 dq
//                   buffer (zeroed by the caller): SIMT for fp32,
//                   flash_bwd_fused_mma for bf16.
//
// Determinism of the fused kernel (the TPU kernels sum dq in grid order on
// one core; two launches here are bitwise equal too): dq tile i receives
// one partial from every kv tile j that sees it, added in increasing j.
// An int32 counter per (b, q head, q tile), zeroed by the caller, says how
// many partials have landed; the CTA of kv tile j waits until it reads
// j - J0, adds its partial (L2 loads and stores), fences, and increments
// it.  The kv tiles that see q tile i are always a contiguous range
// J0..J-1 (both ends of the q loop are non-decreasing in j; J0 = 0 without
// a band, with one the tile of the first row's band start), so j - J0 is
// the right count to wait for.  The
// CUDA model does not promise that blocks start in increasing blockIdx,
// so a CTA does not take its kv tile from blockIdx: thread 0 takes a
// ticket with one atomicAdd on the word after the counters (zeroed with
// them), and the ticket decodes to (kv tile j, kv head, batch), j fastest.
// Tickets follow start order, so the CTA of tile j-1 holds a smaller
// ticket and has already started when tile j waits on it: it owns an SM
// and cannot be starved by its waiter, and by induction from tile 0 (which
// never waits) no wait deadlocks, whatever the dispatch order and however
// few CTAs are resident (the wait still traps after ring_sync.cuh's
// timeout rather than hang the card).  The fold order is unchanged: tile j
// still waits for the count j.  The ticket is decoded in unsigned
// arithmetic and its ranges are asserted with __builtin_assume: a decoded
// index of unknown sign and range made the kernel ~4% slower (28.9 against
// 27.8 ms at B1 N16 S8192 bf16 causal; NVIDIA H100 80GB HBM3, 700.00 W;
// tools/kernel_ab.py), and so did blockIdx.x plus a ticket-derived zero,
// while the atomic alone cost 0.1%.  Which instructions carry the cost
// was not found: every build's loops hold the same FFMA and LDS counts,
// and the slow blockIdx build has fewer integer instructions in its q loop
// than the parent and the parent's 202 registers.  Each CTA walks its
// q tiles from the last down, so every kv tile reaches tile i at the same
// position in its loop and waits only for the previous tile's add, not
// for its whole sweep.
// The bf16 instance keeps the ticket, the walk and the fold order, and
// folds its dq fragments with mma_bwd_tile.cuh's fold_add and fold_count
// (reductions at L2 behind the same per-q-tile counters); fold_dq
// (flash_bwd_tile.cuh) folds the fp32 instance's.  Both folds are the
// fused ring backward's too.

#include "flash_bwd_tile.cuh"
#include "mma_bwd_tile.cuh"

namespace {

using namespace bat;
using namespace bat::bwd;

template <typename T, int D, bool SEG, bool WIN>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const T* __restrict__ dO, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ delta,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    const int* __restrict__ q_ids,
                    const int* __restrict__ kv_ids, int N, int Nk,
                    float scale, Mask mk, int window) {
  static_assert(D == 128, "thread mapping assumes 32 lanes x 4 columns");
  extern __shared__ float4 smem4[];
  const Tiles<D> t(reinterpret_cast<float*>(smem4));
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * BQ;
  const int Sq = mk.Sq, Skv = mk.Skv;
  const size_t bh = (size_t)b * N + h;
  const size_t bhk = (size_t)b * Nk + h / (N / Nk);

  load_rows<T, D, BQ, NT>(q + bh * Sq * D, i0, Sq, t.q, Tiles<D>::LD, 1.f);
  load_rows<T, D, BQ, NT>(dO + bh * Sq * D, i0, Sq, t.dO, Tiles<D>::LD, 1.f);
  load_row_stats(lse + bh * Sq, delta + bh * Sq, i0, Sq, t.lse2, t.delta);

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  // kv columns this q tile can see (as flash_fwd.cu; WIN: from the band)
  int c_lo, c_end;
  q_tile_cols<WIN>(mk, i0, window, c_lo, c_end);
  const float scale_log2 = scale * kLog2e;
  for (int j0 = c_lo / BKV * BKV; j0 < c_end; j0 += BKV) {
    __syncthreads();  // the previous tile's readers of sK, sV, sdS are done
    load_rows<T, D, BKV, NT>(k + bhk * Skv * D, j0, Skv, t.k, Tiles<D>::LD,
                             1.f);
    load_rows<T, D, BKV, NT>(v + bhk * Skv * D, j0, Skv, t.v, Tiles<D>::LD,
                             1.f);
    __syncthreads();
    scores<D, false, SEG, WIN>(t, scale_log2, i0, j0, mk,
                               SEG ? q_ids + (size_t)b * Sq : nullptr,
                               SEG ? kv_ids + (size_t)b * Skv : nullptr,
                               window);
    __syncthreads();
    accum_q<D>(t, acc);
  }
  store_block<D>(dq + bh * Sq * D, i0, Sq, acc, scale);
}

// The SIMT kv-side kernel's body: the split route's dk/dv kernel, or with
// FUSED the fused kernel.  The instances without WIN run it from
// flash_bwd_kv_kernel, whose parameters are those it had before the band
// existed, and take the code they had on every branch without WIN; the
// WIN instances run it from flash_bwd_kv_win_kernel.  (Built with the
// window as a Mask field, and then as a parameter of this kernel, the
// fp32 fused instance took 206 registers against its 208; so built, it
// takes 208 again.)
template <typename T, int D, bool FUSED, bool SEG, bool WIN>
__device__ __forceinline__ void bwd_kv_body(
    const T* __restrict__ dO, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ delta, const float* __restrict__ lse,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    int* __restrict__ counters, const int* __restrict__ q_ids,
    const int* __restrict__ kv_ids, int N, int Nk, float scale, Mask mk,
    int window) {
  static_assert(D == 128, "thread mapping assumes 32 lanes x 4 columns");
  extern __shared__ float4 smem4[];
  const Tiles<D> t(reinterpret_cast<float*>(smem4));
  const int Sq = mk.Sq, Skv = mk.Skv;
  const int nqb = (Sq + BQ - 1) / BQ;
  // the split route has no waits and takes its tile from blockIdx; the
  // fused route decodes a start-order ticket (the word after the fold
  // counters), kv tile fastest, so a CTA waiting on tile j-1 of its head
  // waits on a smaller ticket: a CTA that has started and holds an SM
  int b = blockIdx.z, hk = blockIdx.y, jt = blockIdx.x;
  if constexpr (FUSED) {
    const unsigned nkt = gridDim.x;
    const unsigned tk =
        (unsigned)take_ticket(counters + (size_t)gridDim.z * N * nqb);
    jt = (int)(tk % nkt);
    hk = (int)((tk / nkt) % (unsigned)Nk);
    b = (int)(tk / (nkt * (unsigned)Nk));
    // the ranges blockIdx would give: without them the fused kernel ran
    // ~4% slower (see the note at the top)
    __builtin_assume(jt >= 0 && jt < (int)gridDim.x);
    __builtin_assume(hk >= 0 && hk < Nk);
    __builtin_assume(b >= 0 && b < (int)gridDim.z);
  }
  const int j0 = jt * BKV, G = N / Nk;
  const size_t bhk = (size_t)b * Nk + hk;

  load_rows<T, D, BKV, NT>(k + bhk * Skv * D, j0, Skv, t.k, Tiles<D>::LD,
                           1.f);
  load_rows<T, D, BKV, NT>(v + bhk * Skv * D, j0, Skv, t.v, Tiles<D>::LD,
                           1.f);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[r][e] = dva[r][e] = 0.f;

  // q rows that can see some column of this tile: [i_lo, i_hi); causal
  // rows see column j0 from row j0 - offset on, WIN rows up to the band's
  int i_lo = max(mk.q_lo, 0), i_hi = min(mk.q_hi, Sq);
  if (mk.causal) i_lo = max(i_lo, j0 - mk.offset);
  if (j0 >= min(mk.kv_hi, Skv)) i_hi = i_lo;
  if constexpr (WIN) kv_tile_rows<true>(mk, j0, window, i_lo, i_hi);
  const int t_lo = i_lo / BQ;
  const int t_hi = (i_hi > i_lo) ? (i_hi + BQ - 1) / BQ : t_lo;

  const float scale_log2 = scale * kLog2e;
  for (int g = 0; g < G; ++g) {
    const size_t bh = (size_t)b * N + (size_t)hk * G + g;
    for (int it = t_hi - 1; it >= t_lo; --it) {
      const int i0 = it * BQ;
      __syncthreads();  // the previous step's readers of sQ .. sdS are done
      load_rows<T, D, BQ, NT>(q + bh * Sq * D, i0, Sq, t.q, Tiles<D>::LD,
                              1.f);
      load_rows<T, D, BQ, NT>(dO + bh * Sq * D, i0, Sq, t.dO, Tiles<D>::LD,
                              1.f);
      load_row_stats(lse + bh * Sq, delta + bh * Sq, i0, Sq, t.lse2,
                     t.delta);
      __syncthreads();
      if constexpr (WIN)
        scores<D, true, SEG, true>(t, scale_log2, i0, j0, mk,
                                   SEG ? q_ids + (size_t)b * Sq : nullptr,
                                   SEG ? kv_ids + (size_t)b * Skv : nullptr,
                                   window);
      else
        scores<D, true, SEG>(t, scale_log2, i0, j0, mk,
                             SEG ? q_ids + (size_t)b * Sq : nullptr,
                             SEG ? kv_ids + (size_t)b * Skv : nullptr);
      __syncthreads();
      accum_kv<D>(t, dka, dva);
      if constexpr (FUSED) {
        float part[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[r][e] = 0.f;
        accum_q<D>(t, part);
        // the tile's contributors fold from its first kv tile on
        if constexpr (WIN)
          fold_dq<D>(dq + bh * Sq * D, counters + bh * nqb + it,
                     jt - first_kv_tile<true>(mk, i0, window), i0, Sq, part,
                     scale, false);
        else
          fold_dq<D>(dq + bh * Sq * D, counters + bh * nqb + it, jt, i0, Sq,
                     part, scale, false);
      }
    }
  }
  store_block<D>(dk + bhk * Skv * D, j0, Skv, dka, scale);
  store_block<D>(dv + bhk * Skv * D, j0, Skv, dva, 1.f);
}

template <typename T, int D, bool FUSED, bool SEG>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_kv_kernel(const T* __restrict__ dO, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ delta,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dv,
                    int* __restrict__ counters,
                    const int* __restrict__ q_ids,
                    const int* __restrict__ kv_ids, int N, int Nk,
                    float scale, Mask mk) {
  bwd_kv_body<T, D, FUSED, SEG, false>(dO, q, k, v, delta, lse, dq, dk, dv,
                                       counters, q_ids, kv_ids, N, Nk, scale,
                                       mk, 0);
}

template <typename T, int D, bool FUSED, bool SEG>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_kv_win_kernel(const T* __restrict__ dO, const T* __restrict__ q,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ delta,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        float* __restrict__ dk, float* __restrict__ dv,
                        int* __restrict__ counters,
                        const int* __restrict__ q_ids,
                        const int* __restrict__ kv_ids, int N, int Nk,
                        float scale, Mask mk, int window) {
  bwd_kv_body<T, D, FUSED, SEG, true>(dO, q, k, v, delta, lse, dq, dk, dv,
                                      counters, q_ids, kv_ids, N, Nk, scale,
                                      mk, window);
}

// The SIMT kv-side kernel of (FUSED, SEG, WIN) and its launch arguments
template <typename T, int D, bool FUSED, bool SEG, bool WIN>
constexpr auto kv_kernel() {
  if constexpr (WIN)
    return flash_bwd_kv_win_kernel<T, D, FUSED, SEG>;
  else
    return flash_bwd_kv_kernel<T, D, FUSED, SEG>;
}

// The fused kernel's bf16 instance on the tensor cores (mma_bwd_tile.cuh).
// The ticket, the q-tile walk (the group's q heads in turn, each from its
// last tile down) and the fold order are the SIMT kernel's; a step's Q and
// dO land in stage (s + 1) % 2 while step s runs, their lse (base 2, +inf
// for a row that sees nothing or lies past Sq: P = 0 with no test) and
// delta in registers until the step's tiles have landed; SEG: the q
// rows' ids likewise (sm.qid), the lane's two kv columns' ids in
// registers for the CTA's life (mbwd::kv_tile_ids).
template <bool SEG, bool WIN>
__global__ void __launch_bounds__(mbwd::NT, 1)
flash_bwd_fused_mma_kernel(const __nv_bfloat16* __restrict__ dO,
                           const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ delta,
                           const float* __restrict__ lse,
                           float* __restrict__ dq, float* __restrict__ dk,
                           float* __restrict__ dv, int* __restrict__ counters,
                           const int* __restrict__ q_ids,
                           const int* __restrict__ kv_ids, int N, int Nk,
                           float scale, Mask mk, int window) {
  constexpr int D = kTileD, MQ = mbwd::BQ, MKV = mbwd::BKV;
  extern __shared__ float4 smem4[];
  const mbwd::Smem sm(reinterpret_cast<char*>(smem4));
  const int Sq = mk.Sq, Skv = mk.Skv;
  const int nqb = (Sq + MQ - 1) / MQ;
  const unsigned nkt = gridDim.x;
  const unsigned tk =
      (unsigned)take_ticket(counters + (size_t)gridDim.z * N * nqb);
  const int jt = (int)(tk % nkt);
  const int hk = (int)((tk / nkt) % (unsigned)Nk);
  const int b = (int)(tk / (nkt * (unsigned)Nk));
  __builtin_assume(jt >= 0 && jt < (int)gridDim.x);
  __builtin_assume(hk >= 0 && hk < Nk);
  __builtin_assume(b >= 0 && b < (int)gridDim.z);
  const int j0 = jt * MKV, G = N / Nk;
  const size_t bhk = (size_t)b * Nk + hk;

  // q rows that can see some column of this tile: [i_lo, i_hi)
  int i_lo, i_hi;
  kv_tile_rows<WIN>(mk, j0, window, i_lo, i_hi);
  const int t_lo = i_lo / MQ;
  const int t_hi = (i_hi > i_lo) ? (i_hi + MQ - 1) / MQ : t_lo;
  const int nt = t_hi - t_lo, n_st = G * nt;

  float lse_next = neg_inf(), delta_next = 0.f;
  int qid_next = -1, kid0 = 0, kid1 = 0;
  auto issue = [&](int s, int st) {  // step s: q head s / nt, tile from top
    const int i0 = (t_hi - 1 - s % nt) * MQ;
    const size_t bh = (size_t)b * N + (size_t)hk * G + s / nt;
    const int valid = min(MQ, Sq - i0);
    cp_tile<MQ, mbwd::NT>(sm.q(st), q + (bh * Sq + i0) * D, valid);
    cp_tile<MQ, mbwd::NT>(sm.dO(st), dO + (bh * Sq + i0) * D, valid);
    const int rr = threadIdx.x % MQ;
    if (threadIdx.x < MQ)
      lse_next = rr < valid ? lse[bh * Sq + i0 + rr] : neg_inf();
    else if (threadIdx.x < 2 * MQ)
      delta_next = rr < valid ? delta[bh * Sq + i0 + rr] : 0.f;
    else if (SEG && threadIdx.x < 3 * MQ)
      qid_next = rr < valid ? q_ids[(size_t)b * Sq + i0 + rr] : -1;
  };
  mbwd::KvAcc acc;
  acc.zero();
  if (n_st > 0) {
    const int valid = min(MKV, Skv - j0);
    cp_tile<MKV, mbwd::NT>(sm.k, k + (bhk * Skv + j0) * D, valid);
    cp_tile<MKV, mbwd::NT>(sm.v, v + (bhk * Skv + j0) * D, valid);
    if constexpr (SEG)
      mbwd::kv_tile_ids(kv_ids + (size_t)b * Skv, j0, Skv, kid0, kid1);
    issue(0, 0);
  }
  cp_async_commit();
  const float scale_log2 = scale * kLog2e;
  for (int s = 0; s < n_st; ++s) {
    const int st = s & 1, qt = t_hi - 1 - s % nt, i0 = qt * MQ;
    const size_t bh = (size_t)b * N + (size_t)hk * G + s / nt;
    cp_async_wait<0>();  // step s's tiles have landed
    if (threadIdx.x < MQ)
      sm.lse2[threadIdx.x] =
          (lse_next == neg_inf()) ? CUDART_INF_F : lse_next * kLog2e;
    else if (threadIdx.x < 2 * MQ)
      sm.delta[threadIdx.x - MQ] = delta_next;
    else if (SEG && threadIdx.x < 3 * MQ)
      sm.qid[threadIdx.x - 2 * MQ] = qid_next;
    __syncthreads();
    if (s + 1 < n_st) issue(s + 1, st ^ 1);
    cp_async_commit();
    float part[8][4];
    mbwd::step<true, SEG, WIN>(sm, st, acc, mk, i0, j0, scale_log2, part,
                               nullptr, kid0, kid1, window);
    int* counter = counters + bh * nqb + qt;
    // the tile's contributors fold from its first kv tile on
    mbwd::fold_add(dq + bh * Sq * D, counter,
                   jt - first_kv_tile<WIN>(mk, i0, window), i0, Sq, part,
                   scale, false, nullptr);
    mbwd::fold_count(counter);
  }
  cp_async_wait<0>();
  mbwd::store_frag(dk + bhk * Skv * D, j0, Skv, acc.dk, scale);
  mbwd::store_frag(dv + bhk * Skv * D, j0, Skv, acc.dv, 1.f);
}

// The split pair's dq kernel (kernel 4), bf16 instance, on the forward's
// tensor-core tile (mma_tile.cuh): dq is the forward with two score
// products and K in V's place.  One CTA of four warps per (b, q head,
// 64-row q tile), the longest causal tiles first (as kernel 1); warp w
// holds q rows 16 w .. (lane (g, c): rows g and g + 8, dQ columns
// 8n + 2c, 2c + 1), Q and dO resident in shared memory, K and V streamed
// in 64-token chunks through two cp.async stages (mma_fold's walk: WIN
// starts it at the chunk of the first row's band start and skips a chunk
// wholly below a warp's band).  A chunk, per warp:
//   S = Q K^T, dP = dO V^T       (m16n8k16 bf16, fp32 accumulators)
//   P = exp2(S*scale*log2e - lse2), from the final lse (no running max),
//   0 outside the mask; dS = P * (dP - delta), in fp32 registers;
//   dQ += dS K                   (dS from the accumulators as the A
//                                 operand, as two bf16 terms, exactly as
//                                 the forward feeds P to P.V)
// 4 products a pair-tile (8 * D flops a pair) against the forward's 3.
// dS K goes to fresh fragments four n-tiles at a time and is added to dQ
// by fp32 adds (the tensor cores' accumulation is not round-to-nearest:
// mma_bwd_tile.cuh).  The scale is applied once, at the store.  A row
// that sees nothing, or lies past Sq, has lse2 = +inf and its last
// visible column -1: P = 0, exact zeros.  Two CTAs an SM (shared memory
// allows no third), and the launch bounds say so: without the 2, ptxas
// held the kernel to 168 registers and spilled 16 B, and it ran 2.00-2.02
// ms against 1.78-1.80 at B1 N16 S8192 causal, bitwise the same dq
// (tools/kernel_ab.py --parts bounds; NVIDIA H100 80GB HBM3, 700.00 W).
// SEG: the lane's two rows' ids in registers, each chunk's 64 kv ids
// staged beside its K and V (two stages of 64 int32 after the tiles), as
// the forward's mma_fold does.
constexpr int kDqNT = 128;
constexpr size_t kDqSmem = sizeof(__nv_bfloat16) * 6 * 64 * kTileLd;
constexpr size_t kDqSegSmem = kDqSmem + sizeof(int) * 2 * kTileChunk;

template <bool SEG, bool WIN>
__global__ void __launch_bounds__(kDqNT, 2)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ dO,
                        const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ delta,
                        const float* __restrict__ lse, float* __restrict__ dq,
                        const int* __restrict__ q_ids,
                        const int* __restrict__ kv_ids, int N, int Nk,
                        float scale, Mask mk, int window) {
  constexpr int D = kTileD, LD = kTileLd, CH = kTileChunk, MQ = 64;
  constexpr int TILE = 64 * LD;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sdO = sQ + TILE;
  __nv_bfloat16* sKV = sdO + TILE;  // stage i: K, then V
  int* sIds = reinterpret_cast<int*>(sKV + 4 * TILE);  // (SEG)
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4, mi = lane / 8, r8 = lane % 8;
  const int Sq = mk.Sq, Skv = mk.Skv;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MQ;
  const size_t bh = (size_t)b * N + h;
  const size_t bhk = (size_t)b * Nk + h / (N / Nk);

  const int valid_q = min(MQ, Sq - q0);
  cp_tile<MQ, kDqNT>(sQ, q + (bh * Sq + q0) * D, valid_q);
  cp_tile<MQ, kDqNT>(sdO, dO + (bh * Sq + q0) * D, valid_q);
  // the lane's rows: lse (base 2), delta, last visible column
  float lse2[2], dl[2];
  int hi[2], lo[2], qid[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qr = q0 + 16 * w + g + 8 * hf;
    const float l = qr < Sq ? lse[bh * Sq + qr] : neg_inf();
    lse2[hf] = (l == neg_inf()) ? CUDART_INF_F : l * kLog2e;
    dl[hf] = qr < Sq ? delta[bh * Sq + qr] : 0.f;
    int h_ = min(mk.kv_hi, Skv) - 1;
    if (mk.causal) h_ = min(h_, qr + mk.offset);
    hi[hf] = mk.row_ok(qr) ? h_ : -1;
    lo[hf] = WIN ? (mk.row_ok(qr) ? qr + mk.offset - window + 1 : INT_MAX)
                 : 0;
    qid[hf] = (SEG && qr < Sq) ? q_ids[(size_t)b * Sq + qr] : -1;
  }
  const int w_hi = __reduce_max_sync(0xffffffffu, max(hi[0], hi[1]));
  const int w_lo =
      WIN ? __reduce_min_sync(0xffffffffu, min(lo[0], lo[1])) : 0;
  // the chunks: up to the last active row's causal diagonal and kv_hi,
  // WIN from the chunk that holds the first active row's band start
  int c_lo, c_end;
  q_tile_cols<WIN>(mk, q0, window, c_lo, c_end);
  const int i_begin = c_lo / CH;
  const int n = c_end > 0 ? (c_end + CH - 1) / CH : 0;
  auto issue = [&](int i) {
    __nv_bfloat16* st = sKV + (i & 1) * 2 * TILE;
    const int valid = min(CH, Skv - CH * i);
    cp_tile<CH, kDqNT>(st, k + (bhk * Skv + (size_t)CH * i) * D, valid);
    cp_tile<CH, kDqNT>(st + TILE, v + (bhk * Skv + (size_t)CH * i) * D,
                       valid);
    if constexpr (SEG) {
      if ((int)threadIdx.x < valid)
        cp_async4(sIds + (i & 1) * CH + threadIdx.x,
                  kv_ids + (size_t)b * Skv + CH * i + threadIdx.x);
    }
  };
  if (i_begin < n) issue(i_begin);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;
  // the lane's ldmatrix rows of Q and dO (WarpTile::set_q)
  const int arow = (16 * w + r8 + 8 * (mi % 2)) * LD + 8 * (mi / 2);
  const float scale_log2 = scale * kLog2e;
  for (int i = i_begin; i < n; ++i) {
    cp_async_wait<0>();  // chunk i (and Q, dO) has landed
    __syncthreads();     // ... for every thread; chunk i - 1 is done with
    if (i + 1 < n) issue(i + 1);
    cp_async_commit();
    const int j0 = CH * i;
    if (j0 > w_hi) continue;
    if (WIN && j0 + CH - 1 < w_lo) continue;
    const __nv_bfloat16* sK = sKV + (i & 1) * 2 * TILE;
    const __nv_bfloat16* sV = sK + TILE;
    const int* sid = SEG ? sIds + (i & 1) * CH : nullptr;

    float s[CH / 8][4], dp[CH / 8][4];
#pragma unroll
    for (int j = 0; j < CH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ldmatrix_x4(qa, sQ + arow + 16 * kk);
      ldmatrix_x4(oa, sdO + arow + 16 * kk);
#pragma unroll
      for (int jj = 0; jj < CH / 16; ++jj) {
        const int boff = (16 * jj + 8 * (mi / 2) + r8) * LD + 16 * kk +
                         8 * (mi % 2);
        uint32_t b4[4];
        ldmatrix_x4(b4, sK + boff);
        mma_bf16(s[2 * jj], qa, b4[0], b4[1]);
        mma_bf16(s[2 * jj + 1], qa, b4[2], b4[3]);
        ldmatrix_x4(b4, sV + boff);
        mma_bf16(dp[2 * jj], oa, b4[0], b4[1]);
        mma_bf16(dp[2 * jj + 1], oa, b4[2], b4[3]);
      }
    }
    // dS as the A fragments of dS K, hi and lo terms per k-step kt
    uint32_t ah[CH / 16][4], al[CH / 16][4];
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2, col = j0 + 8 * j + 2 * c + (e & 1);
        const float p =
            col <= hi[hf] && (!WIN || col >= lo[hf]) &&
                    (!SEG || sid[col - j0] == qid[hf])
                ? mbwd::ex2_approx(fmaf(s[j][e], scale_log2, -lse2[hf]))
                : 0.f;
        ds[e] = p * (dp[j][e] - dl[hf]);
      }
      const int kt = j / 2, r0 = 2 * (j % 2);
      split_bf16(ds[0], ds[1], ah[kt][r0], al[kt][r0]);
      split_bf16(ds[2], ds[3], ah[kt][r0 + 1], al[kt][r0 + 1]);
    }
    // dQ += dS K, four n-tiles of columns at a time into fresh fragments
#pragma unroll
    for (int d4 = 0; d4 < D / 32; ++d4) {
      float t[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[u][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < CH / 16; ++kt) {
#pragma unroll
        for (int dh = 0; dh < 2; ++dh) {
          uint32_t b4[4];
          ldmatrix_x4_trans(b4, sK + (16 * kt + 8 * (mi % 2) + r8) * LD +
                                    32 * d4 + 16 * dh + 8 * (mi / 2));
          mma_bf16(t[2 * dh], ah[kt], b4[0], b4[1]);
          mma_bf16(t[2 * dh + 1], ah[kt], b4[2], b4[3]);
          mma_bf16(t[2 * dh], al[kt], b4[0], b4[1]);
          mma_bf16(t[2 * dh + 1], al[kt], b4[2], b4[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * d4 + u][e] += t[u][e];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qr = q0 + 16 * w + g + 8 * hf;
    if (qr >= Sq) continue;
    float* o = dq + (bh * Sq + qr) * D;
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
      *reinterpret_cast<float2*>(o + 8 * nn + 2 * c) =
          make_float2(acc[nn][2 * hf] * scale, acc[nn][2 * hf + 1] * scale);
  }
}

// The split pair's dk/dv kernel (kernel 5), bf16 instance, on the fused
// kernel's tile (mma_bwd_tile.cuh) without the fold: parts 1-2 of a step
// (step_kv: S^T, dP^T and their exchange, P and dS as two bf16 terms,
// dV += P^T dO, dK += dS^T Q), 6 products a step against the fused
// kernel's 8, no dS^T tile, no dQ, no counters.  Nothing waits, so the
// kv tile comes from blockIdx; the q-tile walk (the group's q heads in
// turn, each from its last tile down) and the two Q/dO stages are the
// fused kernel's, and dk, dv are written once (the GQA sum in the CTA).
// SEG: the ids as the fused kernel holds them.
template <bool SEG, bool WIN>
__global__ void __launch_bounds__(mbwd::NT, 1)
flash_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ dO,
                          const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ delta,
                          const float* __restrict__ lse,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const int* __restrict__ q_ids,
                          const int* __restrict__ kv_ids, int N, int Nk,
                          float scale, Mask mk, int window) {
  constexpr int D = kTileD, MQ = mbwd::BQ, MKV = mbwd::BKV;
  extern __shared__ float4 smem4[];
  const mbwd::Smem sm(reinterpret_cast<char*>(smem4));
  const int Sq = mk.Sq, Skv = mk.Skv;
  const int b = blockIdx.z, hk = blockIdx.y, j0 = blockIdx.x * MKV;
  const int G = N / Nk;
  const size_t bhk = (size_t)b * Nk + hk;

  // q rows that can see some column of this tile: [i_lo, i_hi)
  int i_lo, i_hi;
  kv_tile_rows<WIN>(mk, j0, window, i_lo, i_hi);
  const int t_lo = i_lo / MQ;
  const int t_hi = (i_hi > i_lo) ? (i_hi + MQ - 1) / MQ : t_lo;
  const int nt = t_hi - t_lo, n_st = G * nt;

  float lse_next = neg_inf(), delta_next = 0.f;
  int qid_next = -1, kid0 = 0, kid1 = 0;
  auto issue = [&](int s, int st) {  // step s: q head s / nt, tile from top
    const int i0 = (t_hi - 1 - s % nt) * MQ;
    const size_t bh = (size_t)b * N + (size_t)hk * G + s / nt;
    const int valid = min(MQ, Sq - i0);
    cp_tile<MQ, mbwd::NT>(sm.q(st), q + (bh * Sq + i0) * D, valid);
    cp_tile<MQ, mbwd::NT>(sm.dO(st), dO + (bh * Sq + i0) * D, valid);
    const int rr = threadIdx.x % MQ;
    if (threadIdx.x < MQ)
      lse_next = rr < valid ? lse[bh * Sq + i0 + rr] : neg_inf();
    else if (threadIdx.x < 2 * MQ)
      delta_next = rr < valid ? delta[bh * Sq + i0 + rr] : 0.f;
    else if (SEG && threadIdx.x < 3 * MQ)
      qid_next = rr < valid ? q_ids[(size_t)b * Sq + i0 + rr] : -1;
  };
  mbwd::KvAcc acc;
  acc.zero();
  if (n_st > 0) {
    const int valid = min(MKV, Skv - j0);
    cp_tile<MKV, mbwd::NT>(sm.k, k + (bhk * Skv + j0) * D, valid);
    cp_tile<MKV, mbwd::NT>(sm.v, v + (bhk * Skv + j0) * D, valid);
    if constexpr (SEG)
      mbwd::kv_tile_ids(kv_ids + (size_t)b * Skv, j0, Skv, kid0, kid1);
    issue(0, 0);
  }
  cp_async_commit();
  const float scale_log2 = scale * kLog2e;
  for (int s = 0; s < n_st; ++s) {
    const int st = s & 1, i0 = (t_hi - 1 - s % nt) * MQ;
    cp_async_wait<0>();  // step s's tiles have landed
    __syncthreads();     // ... for every thread; step s - 1 is done with
                         // the other stage, lse2, delta and the exchange
    if (threadIdx.x < MQ)
      sm.lse2[threadIdx.x] =
          (lse_next == neg_inf()) ? CUDART_INF_F : lse_next * kLog2e;
    else if (threadIdx.x < 2 * MQ)
      sm.delta[threadIdx.x - MQ] = delta_next;
    else if (SEG && threadIdx.x < 3 * MQ)
      sm.qid[threadIdx.x - 2 * MQ] = qid_next;
    if (s + 1 < n_st) issue(s + 1, st ^ 1);
    cp_async_commit();
    // (part 1's barrier publishes lse2 and delta before they are read)
    mbwd::step_kv<SEG, WIN>(sm, st, acc, mk, i0, j0, scale_log2, kid0,
                            kid1, window);
  }
  cp_async_wait<0>();
  mbwd::store_frag(dk + bhk * Skv * D, j0, Skv, acc.dk, scale);
  mbwd::store_frag(dv + bhk * Skv * D, j0, Skv, acc.dv, 1.f);
}

enum Route { kFused = 0, kDq = 1, kDkdv = 2 };

// bf16 runs on the tensor cores, fp32 on the SIMT tile
template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

template <typename T, int D, bool SEG, bool WIN>
cudaError_t launch(int route, const void* dO, const void* q, const void* k,
                   const void* v, const void* delta, const void* lse,
                   void* dq, void* dk, void* dv, void* counters,
                   const int* q_ids, const int* kv_ids, int B, int N, int Nk,
                   int Sq, int Skv, float scale, Mask mk, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  const T* o_ = static_cast<const T*>(dO);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const float* de = static_cast<const float*>(delta);
  const float* ls = static_cast<const float*>(lse);
  cudaError_t e;
  if (route == kDq) {
    static bool set = false;
    const dim3 grid((Sq + BQ - 1) / BQ, N, B);
    if constexpr (kMma<T>) {
      const size_t dsmem = SEG ? kDqSegSmem : kDqSmem;
      e = allow_smem(flash_bwd_dq_mma_kernel<SEG, WIN>, dsmem, &set);
      if (e != cudaSuccess) return e;
      flash_bwd_dq_mma_kernel<SEG, WIN><<<grid, kDqNT, dsmem, stream>>>(
          o_, q_, k_, v_, de, ls, static_cast<float*>(dq), q_ids, kv_ids, N,
          Nk, scale, mk, window);
    } else {
      e = allow_smem(flash_bwd_dq_kernel<T, D, SEG, WIN>, smem, &set);
      if (e != cudaSuccess) return e;
      flash_bwd_dq_kernel<T, D, SEG, WIN><<<grid, NT, smem, stream>>>(
          o_, q_, k_, v_, de, ls, static_cast<float*>(dq), q_ids, kv_ids, N,
          Nk, scale, mk, window);
    }
    return cudaGetLastError();
  }
  const dim3 grid((Skv + BKV - 1) / BKV, Nk, B);
  if (route == kFused) {
    static bool set = false;
    if constexpr (kMma<T>) {
      const size_t msmem = mbwd::Smem::bytes(SEG);
      e = allow_smem(flash_bwd_fused_mma_kernel<SEG, WIN>, msmem, &set);
      if (e != cudaSuccess) return e;
      flash_bwd_fused_mma_kernel<SEG, WIN>
          <<<grid, mbwd::NT, msmem, stream>>>(
              o_, q_, k_, v_, de, ls, static_cast<float*>(dq),
              static_cast<float*>(dk), static_cast<float*>(dv),
              static_cast<int*>(counters), q_ids, kv_ids, N, Nk, scale, mk,
              window);
    } else {
      const auto kern = kv_kernel<T, D, true, SEG, WIN>();
      e = allow_smem(kern, smem, &set);
      if (e != cudaSuccess) return e;
      if constexpr (WIN)
        kern<<<grid, NT, smem, stream>>>(
            o_, q_, k_, v_, de, ls, static_cast<float*>(dq),
            static_cast<float*>(dk), static_cast<float*>(dv),
            static_cast<int*>(counters), q_ids, kv_ids, N, Nk, scale, mk,
            window);
      else
        kern<<<grid, NT, smem, stream>>>(
            o_, q_, k_, v_, de, ls, static_cast<float*>(dq),
            static_cast<float*>(dk), static_cast<float*>(dv),
            static_cast<int*>(counters), q_ids, kv_ids, N, Nk, scale, mk);
    }
    return cudaGetLastError();
  }
  if (route == kDkdv) {
    static bool set = false;
    if constexpr (kMma<T>) {
      const size_t msmem = mbwd::Smem::bytes(SEG);
      e = allow_smem(flash_bwd_dkdv_mma_kernel<SEG, WIN>, msmem, &set);
      if (e != cudaSuccess) return e;
      flash_bwd_dkdv_mma_kernel<SEG, WIN>
          <<<grid, mbwd::NT, msmem, stream>>>(
              o_, q_, k_, v_, de, ls, static_cast<float*>(dk),
              static_cast<float*>(dv), q_ids, kv_ids, N, Nk, scale, mk,
              window);
    } else {
      const auto kern = kv_kernel<T, D, false, SEG, WIN>();
      e = allow_smem(kern, smem, &set);
      if (e != cudaSuccess) return e;
      if constexpr (WIN)
        kern<<<grid, NT, smem, stream>>>(
            o_, q_, k_, v_, de, ls, nullptr, static_cast<float*>(dk),
            static_cast<float*>(dv), nullptr, q_ids, kv_ids, N, Nk, scale,
            mk, window);
      else
        kern<<<grid, NT, smem, stream>>>(
            o_, q_, k_, v_, de, ls, nullptr, static_cast<float*>(dk),
            static_cast<float*>(dv), nullptr, q_ids, kv_ids, N, Nk, scale,
            mk);
    }
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool SEG>
cudaError_t launch_win(bool win, int route, const void* dO, const void* q,
                       const void* k, const void* v, const void* delta,
                       const void* lse, void* dq, void* dk, void* dv,
                       void* counters, const int* q_ids, const int* kv_ids,
                       int B, int N, int Nk, int Sq, int Skv, float scale,
                       Mask mk, int window, cudaStream_t stream) {
  return win ? launch<T, 128, SEG, true>(route, dO, q, k, v, delta, lse, dq,
                                         dk, dv, counters, q_ids, kv_ids, B,
                                         N, Nk, Sq, Skv, scale, mk, window,
                                         stream)
             : launch<T, 128, SEG, false>(route, dO, q, k, v, delta, lse, dq,
                                          dk, dv, counters, q_ids, kv_ids, B,
                                          N, Nk, Sq, Skv, scale, mk, 0,
                                          stream);
}

int dispatch(int route, const void* dO, const void* q, const void* k,
             const void* v, const void* delta, const void* lse, void* dq,
             void* dk, void* dv, void* counters, const void* q_ids,
             const void* kv_ids, int B, int N, int Nk, int Sq, int Skv,
             int D, int dtype, float scale, int q_lo, int q_hi, int kv_hi,
             int causal, int offset, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nk <= 0 || N % Nk != 0 || D != 128 || window < 0 ||
      (q_ids == nullptr) != (kv_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  const Mask mk{q_lo, q_hi, kv_hi, causal, offset, Sq, Skv};
  const int* qi = static_cast<const int*>(q_ids);
  const int* ki = static_cast<const int*>(kv_ids);
  const bool win = window > 0;
#define LAUNCH_ARGS                                                         \
  win, route, dO, q, k, v, delta, lse, dq, dk, dv, counters, qi, ki, B, N, \
      Nk, Sq, Skv, scale, mk, window, st
  if (dtype == kBFloat16)
    return (int)(qi ? launch_win<__nv_bfloat16, true>(LAUNCH_ARGS)
                    : launch_win<__nv_bfloat16, false>(LAUNCH_ARGS));
  if (dtype == kFloat32)
    return (int)(qi ? launch_win<float, true>(LAUNCH_ARGS)
                    : launch_win<float, false>(LAUNCH_ARGS));
#undef LAUNCH_ARGS
  return (int)cudaErrorInvalidValue;
}

// The attributes (common.cuh kernel_attrs) of one route's kernel
template <typename T, bool SEG, bool WIN>
cudaError_t attrs_of(int route, int* out) {
  const size_t smem = smem_bytes<128>();
  if (route == kFused) {
    if constexpr (kMma<T>)
      return kernel_attrs(flash_bwd_fused_mma_kernel<SEG, WIN>, mbwd::NT,
                          mbwd::Smem::bytes(SEG), out);
    else
      return kernel_attrs(kv_kernel<T, 128, true, SEG, WIN>(), NT, smem,
                          out);
  }
  if (route == kDq) {
    if constexpr (kMma<T>)
      return kernel_attrs(flash_bwd_dq_mma_kernel<SEG, WIN>, kDqNT,
                          SEG ? kDqSegSmem : kDqSmem, out);
    else
      return kernel_attrs(flash_bwd_dq_kernel<T, 128, SEG, WIN>, NT, smem,
                          out);
  }
  if (route == kDkdv) {
    if constexpr (kMma<T>)
      return kernel_attrs(flash_bwd_dkdv_mma_kernel<SEG, WIN>, mbwd::NT,
                          mbwd::Smem::bytes(SEG), out);
    else
      return kernel_attrs(kv_kernel<T, 128, false, SEG, WIN>(), NT, smem,
                          out);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t attrs_flag(int route, bool seg, bool win, int* out) {
  if (seg)
    return win ? attrs_of<T, true, true>(route, out)
               : attrs_of<T, true, false>(route, out);
  return win ? attrs_of<T, false, true>(route, out)
             : attrs_of<T, false, false>(route, out);
}

}  // namespace

// The attributes of `flag`'s kernel for `dtype`: flag & 3 the route (0
// fused, 1 dq, 2 dk/dv), bit 2 its SEG instance, bit 3 its WIN instance.
extern "C" int flash_bwd_attrs(int dtype, int flag, int* out) {
  const int route = flag & 3;
  const bool seg = (flag & 4) != 0, win = (flag & 8) != 0;
  if (dtype == kBFloat16)
    return (int)attrs_flag<__nv_bfloat16>(route, seg, win, out);
  if (dtype == kFloat32) return (int)attrs_flag<float>(route, seg, win, out);
  return (int)cudaErrorInvalidValue;
}

// Three entry points with one argument list: the split pair reads only
// the outputs it writes (dq; dk and dv); the fused kernel needs a zeroed
// dq and zeroed counters [B, N, ceil(Sq / 64)] int32 plus one ticket word
// after them.  q_ids, kv_ids: both null (no segments) or both [B,Sq],
// [B,Skv] int32.  window: 0 (none; the instances without WIN) or >= 1.
#define BWD_ARGS                                                            \
  const void *dO, const void *q, const void *k, const void *v,              \
      const void *delta, const void *lse, void *dq, void *dk, void *dv,     \
      void *counters, const void *q_ids, const void *kv_ids, int B, int N,  \
      int Nk, int Sq, int Skv, int D, int dtype, float scale, int q_lo,     \
      int q_hi, int kv_hi, int causal, int offset, int window, void *stream
#define BWD_PASS                                                            \
  dO, q, k, v, delta, lse, dq, dk, dv, counters, q_ids, kv_ids, B, N, Nk,  \
      Sq, Skv, D, dtype, scale, q_lo, q_hi, kv_hi, causal, offset, window, \
      stream

extern "C" int flash_bwd_fused_launch(BWD_ARGS) {
  return dispatch(kFused, BWD_PASS);
}
extern "C" int flash_bwd_dq_launch(BWD_ARGS) { return dispatch(kDq, BWD_PASS); }
extern "C" int flash_bwd_dkdv_launch(BWD_ARGS) {
  return dispatch(kDkdv, BWD_PASS);
}
