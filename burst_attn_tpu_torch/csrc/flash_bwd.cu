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
// lse is -inf contribute exact zeros.
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
// Two tiles:
//  * the fused kernel's bf16 instance (kernels 2-3 on the train step and
//    every scan-ring round) runs on the tensor cores, on the tile of the
//    fused ring backward's bf16 instance (mma_bwd_tile.cuh: eight warps on
//    mma.sync m16n8k16, K and V of the CTA's kv tile in shared memory as
//    bf16, dK and dV in accumulator fragments, Q and dO of the next q
//    tile landing by cp.async.cg in a second stage while this step's
//    products run, P and dS rebuilt in registers and fed to their
//    products as two bf16 terms, so the gradients hold the fp32 plain
//    version's tolerance; ~156 KB of shared memory, one CTA an SM).  It
//    issues 16 * D flops an attended pair on mma.sync, below wgmma's
//    rate; a TMA producer warp feeding wgmma is the next step.
//  * the fp32 instances and the split pair (kernels 4-5) are still the
//    first version: SIMT fp32 on the CUDA cores (no tensor cores, no
//    TMA), exact to the plain version's fp32 math up to summation order.
//    Every operand tile is read from device memory once per step into
//    shared memory as fp32, and each thread keeps a 4x4 block of S and dP
//    (or an 8x4 block of dK, dV, dQ) in registers.
//
// Kernels (256 threads, one CTA per SM):
//   flash_bwd_dq    one CTA per (b, q head, 64-row q tile); Q, dO resident;
//                   loops over the kv tiles it can see; writes dq once.
//   flash_bwd_dkdv  one CTA per (b, kv head, 64-row kv tile); K, V
//                   resident; loops over the group's q heads and the q
//                   tiles that can see tile j; the GQA sum happens in the
//                   CTA (no atomics); writes dk, dv once.
//   flash_bwd_fused the dkdv kernel that also folds dS K into an fp32 dq
//                   buffer (zeroed by the caller): SIMT for fp32,
//                   flash_bwd_fused_mma for bf16.
//
// Determinism of the fused kernel (the TPU kernels sum dq in grid order on
// one core; two launches here are bitwise equal too): dq tile i receives
// one partial from every kv tile j that sees it, added in increasing j.
// An int32 counter per (b, q head, q tile), zeroed by the caller, says how
// many partials have landed; the CTA of kv tile j waits until it reads j,
// adds its partial (L2 loads and stores), fences, and increments it.  The
// kv tiles that see q tile i are always the prefix 0..J-1 (the q loop's
// start is non-decreasing in j), so j is the right count to wait for.  The
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

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const T* __restrict__ dO, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ delta,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    int N, int Nk, float scale, Mask mk) {
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

  // kv columns this q tile can see (as flash_fwd.cu)
  const int r_lo = max(i0, mk.q_lo);
  const int r_hi = min(min(i0 + BQ, mk.q_hi), Sq);
  int c_end = 0;
  if (r_lo < r_hi) {
    c_end = min(mk.kv_hi, Skv);
    if (mk.causal) c_end = min(c_end, r_hi + mk.offset);
  }
  const float scale_log2 = scale * kLog2e;
  for (int j0 = 0; j0 < c_end; j0 += BKV) {
    __syncthreads();  // the previous tile's readers of sK, sV, sdS are done
    load_rows<T, D, BKV, NT>(k + bhk * Skv * D, j0, Skv, t.k, Tiles<D>::LD,
                             1.f);
    load_rows<T, D, BKV, NT>(v + bhk * Skv * D, j0, Skv, t.v, Tiles<D>::LD,
                             1.f);
    __syncthreads();
    scores<D, false>(t, scale_log2, i0, j0, mk);
    __syncthreads();
    accum_q<D>(t, acc);
  }
  store_block<D>(dq + bh * Sq * D, i0, Sq, acc, scale);
}

template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_kv_kernel(const T* __restrict__ dO, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ delta,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dv,
                    int* __restrict__ counters, int N, int Nk, float scale,
                    Mask mk) {
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
  // rows see column j0 from row j0 - offset on
  int i_lo = max(mk.q_lo, 0), i_hi = min(mk.q_hi, Sq);
  if (mk.causal) i_lo = max(i_lo, j0 - mk.offset);
  if (j0 >= min(mk.kv_hi, Skv)) i_hi = i_lo;
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
      scores<D, true>(t, scale_log2, i0, j0, mk);
      __syncthreads();
      accum_kv<D>(t, dka, dva);
      if constexpr (FUSED) {
        float part[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[r][e] = 0.f;
        accum_q<D>(t, part);
        fold_dq<D>(dq + bh * Sq * D, counters + bh * nqb + it, jt, i0, Sq,
                   part, scale, false);
      }
    }
  }
  store_block<D>(dk + bhk * Skv * D, j0, Skv, dka, scale);
  store_block<D>(dv + bhk * Skv * D, j0, Skv, dva, 1.f);
}

// The fused kernel's bf16 instance on the tensor cores (mma_bwd_tile.cuh).
// The ticket, the q-tile walk (the group's q heads in turn, each from its
// last tile down) and the fold order are the SIMT kernel's; a step's Q and
// dO land in stage (s + 1) % 2 while step s runs, their lse (base 2, +inf
// for a row that sees nothing or lies past Sq: P = 0 with no test) and
// delta in registers until the step's tiles have landed.
__global__ void __launch_bounds__(mbwd::NT, 1)
flash_bwd_fused_mma_kernel(const __nv_bfloat16* __restrict__ dO,
                           const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ delta,
                           const float* __restrict__ lse,
                           float* __restrict__ dq, float* __restrict__ dk,
                           float* __restrict__ dv, int* __restrict__ counters,
                           int N, int Nk, float scale, Mask mk) {
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
  int i_lo = max(mk.q_lo, 0), i_hi = min(mk.q_hi, Sq);
  if (mk.causal) i_lo = max(i_lo, j0 - mk.offset);
  if (j0 >= min(mk.kv_hi, Skv)) i_hi = i_lo;
  const int t_lo = i_lo / MQ;
  const int t_hi = (i_hi > i_lo) ? (i_hi + MQ - 1) / MQ : t_lo;
  const int nt = t_hi - t_lo, n_st = G * nt;

  float lse_next = neg_inf(), delta_next = 0.f;
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
  };
  mbwd::KvAcc acc;
  acc.zero();
  if (n_st > 0) {
    const int valid = min(MKV, Skv - j0);
    cp_tile<MKV, mbwd::NT>(sm.k, k + (bhk * Skv + j0) * D, valid);
    cp_tile<MKV, mbwd::NT>(sm.v, v + (bhk * Skv + j0) * D, valid);
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
    __syncthreads();
    if (s + 1 < n_st) issue(s + 1, st ^ 1);
    cp_async_commit();
    float part[8][4];
    mbwd::step(sm, st, acc, mk, i0, j0, scale_log2, part);
    int* counter = counters + bh * nqb + qt;
    mbwd::fold_add(dq + bh * Sq * D, counter, jt, i0, Sq, part, scale, false,
                   nullptr);
    mbwd::fold_count(counter);
  }
  cp_async_wait<0>();
  mbwd::store_frag(dk + bhk * Skv * D, j0, Skv, acc.dk, scale);
  mbwd::store_frag(dv + bhk * Skv * D, j0, Skv, acc.dv, 1.f);
}

enum Route { kFused = 0, kDq = 1, kDkdv = 2 };

// bf16's fused route runs on the tensor cores; the rest on the SIMT tile
template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

template <typename T, int D>
cudaError_t launch(int route, const void* dO, const void* q, const void* k,
                   const void* v, const void* delta, const void* lse,
                   void* dq, void* dk, void* dv, void* counters, int B,
                   int N, int Nk, int Sq, int Skv, float scale, Mask mk,
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
    e = allow_smem(flash_bwd_dq_kernel<T, D>, smem, &set);
    if (e != cudaSuccess) return e;
    const dim3 grid((Sq + BQ - 1) / BQ, N, B);
    flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
        o_, q_, k_, v_, de, ls, static_cast<float*>(dq), N, Nk, scale, mk);
    return cudaGetLastError();
  }
  const dim3 grid((Skv + BKV - 1) / BKV, Nk, B);
  if (route == kFused) {
    static bool set = false;
    if constexpr (kMma<T>) {
      const size_t msmem = mbwd::Smem::bytes();
      e = allow_smem(flash_bwd_fused_mma_kernel, msmem, &set);
      if (e != cudaSuccess) return e;
      flash_bwd_fused_mma_kernel<<<grid, mbwd::NT, msmem, stream>>>(
          o_, q_, k_, v_, de, ls, static_cast<float*>(dq),
          static_cast<float*>(dk), static_cast<float*>(dv),
          static_cast<int*>(counters), N, Nk, scale, mk);
    } else {
      e = allow_smem(flash_bwd_kv_kernel<T, D, true>, smem, &set);
      if (e != cudaSuccess) return e;
      flash_bwd_kv_kernel<T, D, true><<<grid, NT, smem, stream>>>(
          o_, q_, k_, v_, de, ls, static_cast<float*>(dq),
          static_cast<float*>(dk), static_cast<float*>(dv),
          static_cast<int*>(counters), N, Nk, scale, mk);
    }
    return cudaGetLastError();
  }
  if (route == kDkdv) {
    static bool set = false;
    e = allow_smem(flash_bwd_kv_kernel<T, D, false>, smem, &set);
    if (e != cudaSuccess) return e;
    flash_bwd_kv_kernel<T, D, false><<<grid, NT, smem, stream>>>(
        o_, q_, k_, v_, de, ls, nullptr, static_cast<float*>(dk),
        static_cast<float*>(dv), nullptr, N, Nk, scale, mk);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

int dispatch(int route, const void* dO, const void* q, const void* k,
             const void* v, const void* delta, const void* lse, void* dq,
             void* dk, void* dv, void* counters, int B, int N, int Nk,
             int Sq, int Skv, int D, int dtype, float scale, int q_lo,
             int q_hi, int kv_hi, int causal, int offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nk <= 0 || N % Nk != 0 || D != 128) return (int)cudaErrorInvalidValue;
  const Mask mk{q_lo, q_hi, kv_hi, causal, offset, Sq, Skv};
  if (dtype == kBFloat16)
    return (int)launch<__nv_bfloat16, 128>(route, dO, q, k, v, delta, lse,
                                           dq, dk, dv, counters, B, N, Nk,
                                           Sq, Skv, scale, mk, st);
  if (dtype == kFloat32)
    return (int)launch<float, 128>(route, dO, q, k, v, delta, lse, dq, dk,
                                   dv, counters, B, N, Nk, Sq, Skv, scale,
                                   mk, st);
  return (int)cudaErrorInvalidValue;
}

// The attributes (common.cuh kernel_attrs) of one route's kernel
template <typename T>
cudaError_t attrs_of(int route, int* out) {
  const size_t smem = smem_bytes<128>();
  if (route == kFused) {
    if constexpr (kMma<T>)
      return kernel_attrs(flash_bwd_fused_mma_kernel, mbwd::NT,
                          mbwd::Smem::bytes(), out);
    else
      return kernel_attrs(flash_bwd_kv_kernel<T, 128, true>, NT, smem, out);
  }
  if (route == kDq)
    return kernel_attrs(flash_bwd_dq_kernel<T, 128>, NT, smem, out);
  if (route == kDkdv)
    return kernel_attrs(flash_bwd_kv_kernel<T, 128, false>, NT, smem, out);
  return cudaErrorInvalidValue;
}

}  // namespace

// The attributes of `route`'s kernel (0 fused, 1 dq, 2 dk/dv) for `dtype`.
extern "C" int flash_bwd_attrs(int dtype, int route, int* out) {
  if (dtype == kBFloat16) return (int)attrs_of<__nv_bfloat16>(route, out);
  if (dtype == kFloat32) return (int)attrs_of<float>(route, out);
  return (int)cudaErrorInvalidValue;
}

// Three entry points with one argument list: the split pair reads only
// the outputs it writes (dq; dk and dv); the fused kernel needs a zeroed
// dq and zeroed counters [B, N, ceil(Sq / 64)] int32 plus one ticket word
// after them.
#define BWD_ARGS                                                            \
  const void *dO, const void *q, const void *k, const void *v,              \
      const void *delta, const void *lse, void *dq, void *dk, void *dv,     \
      void *counters, int B, int N, int Nk, int Sq, int Skv, int D,         \
      int dtype, float scale, int q_lo, int q_hi, int kv_hi, int causal,    \
      int offset, void *stream
#define BWD_PASS                                                            \
  dO, q, k, v, delta, lse, dq, dk, dv, counters, B, N, Nk, Sq, Skv, D,     \
      dtype, scale, q_lo, q_hi, kv_hi, causal, offset, stream

extern "C" int flash_bwd_fused_launch(BWD_ARGS) {
  return dispatch(kFused, BWD_PASS);
}
extern "C" int flash_bwd_dq_launch(BWD_ARGS) { return dispatch(kDq, BWD_PASS); }
extern "C" int flash_bwd_dkdv_launch(BWD_ARGS) {
  return dispatch(kDkdv, BWD_PASS);
}
