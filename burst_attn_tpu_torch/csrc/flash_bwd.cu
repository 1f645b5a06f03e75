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
// ~0.1 GB of traffic.  This first version does NOT reach that bound: it is
// SIMT fp32 on the CUDA cores (no tensor cores, no TMA), exact to the plain
// version's fp32 math up to summation order.  What the design does about
// the bound: every operand tile is read from device memory once per step
// into shared memory as fp32, each thread keeps a 4x4 block of S and dP
// (or an 8x4 block of dK, dV, dQ) in registers, and causal loops start at
// the diagonal so dead tiles cost nothing (the CUDA counterpart of the TPU
// kernel's triangular grid).
//
// Kernels (256 threads; ~170 KB of dynamic shared memory, one CTA per SM):
//   flash_bwd_dq    one CTA per (b, q head, 64-row q tile); Q, dO resident;
//                   loops over the kv tiles it can see; writes dq once.
//   flash_bwd_dkdv  one CTA per (b, kv head, 64-row kv tile); K, V
//                   resident; loops over the group's q heads and the q
//                   tiles that can see tile j; the GQA sum happens in the
//                   CTA (no atomics); writes dk, dv once.
//   flash_bwd_fused the dkdv kernel that also folds dS K into an fp32 dq
//                   buffer (zeroed by the caller).
//
// Determinism of the fused kernel (the TPU kernels sum dq in grid order on
// one core; two launches here are bitwise equal too): dq tile i receives
// one partial from every kv tile j that sees it, added in increasing j.
// An int32 counter per (b, q head, q tile), zeroed by the caller, says how
// many partials have landed; the CTA of kv tile j waits until it reads j,
// adds its partial (L2 loads and stores), fences, and increments it.  The
// kv tiles that see q tile i are always the prefix 0..J-1 (the q loop's
// start is non-decreasing in j), so j is the right count to wait for.  The
// kv tile index is blockIdx.x, and blocks are dispatched in increasing
// linear index, so tile j-1 is resident or finished whenever tile j waits:
// no deadlock.  Each CTA walks its q tiles from the last down, so every
// kv tile reaches tile i at the same position in its loop and waits only
// for the previous tile's add, not for its whole sweep.

#include "common.cuh"

namespace {

using namespace bat;

constexpr int BQ = 64;         // q rows per tile
constexpr int BKV = 64;        // kv rows per tile
constexpr int NT = 256;        // threads per CTA
constexpr int LDP = BKV + 4;   // row stride of the P and dS tiles

template <int D>
constexpr size_t smem_bytes() {
  // sK, sV, sQ, sdO [64][D+4]; sP, sdS [64][LDP]; lse2, delta [BQ]
  return sizeof(float) * (4 * 64 * (D + 4) + 2 * 64 * LDP + 2 * BQ);
}

struct Mask {
  int q_lo, q_hi, kv_hi, causal, offset, Sq, Skv;

  __device__ __forceinline__ bool row_ok(int row) const {
    return row >= q_lo && row < q_hi && row < Sq;
  }
  __device__ __forceinline__ bool col_ok(int row, int col) const {
    return col < kv_hi && col < Skv && (!causal || col <= row + offset);
  }
};

// The shared-memory tiles of one CTA.
template <int D>
struct Tiles {
  static constexpr int LD = D + 4;  // padded: conflict-free float4 row reads
  float *k, *v, *q, *dO, *p, *ds, *lse2, *delta;

  __device__ __forceinline__ explicit Tiles(float* base) {
    k = base;
    v = k + 64 * LD;
    q = v + 64 * LD;
    dO = q + 64 * LD;
    p = dO + 64 * LD;
    ds = p + 64 * LDP;
    lse2 = ds + 64 * LDP;
    delta = lse2 + BQ;
  }
};

// Rows [r0, r0 + BQ) of one head's lse (as base 2) and delta; rows past
// Sq read lse = -inf (they contribute nothing) and delta = 0.
__device__ __forceinline__ void load_row_stats(const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int r0, int Sq, float* sL,
                                               float* sD) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int row = r0 + r;
    const float l = row < Sq ? lse[row] : neg_inf();
    sL[r] = (l == neg_inf()) ? neg_inf() : l * kLog2e;
    sD[r] = row < Sq ? delta[row] : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for one (q tile, kv tile) pair, then
// P = exp2(S * scale_log2 - lse2) under the mask and dS = P * (dP - delta),
// written to t.p (if WRITE_P) and t.ds [BQ][LDP].  Thread (ty = tid / 16,
// tx = tid % 16) owns rows ty + 16 r and columns tx + 16 c.
template <int D, bool WRITE_P>
__device__ __forceinline__ void scores(const Tiles<D>& t, float scale_log2,
                                       int i0, int j0, const Mask& mk) {
  constexpr int LD = Tiles<D>::LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 kk[4], vv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kk[c] = *reinterpret_cast<const float4*>(t.k + (tx + 16 * c) * LD + d);
      vv[c] = *reinterpret_cast<const float4*>(t.v + (tx + 16 * c) * LD + d);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 qq =
          *reinterpret_cast<const float4*>(t.q + (ty + 16 * r) * LD + d);
      const float4 oo =
          *reinterpret_cast<const float4*>(t.dO + (ty + 16 * r) * LD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] += dot4(qq, kk[c]);
        dp[r][c] += dot4(oo, vv[c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rl = ty + 16 * r, row = i0 + rl;
    const float l2 = t.lse2[rl], dl = t.delta[rl];
    const bool row_ok = mk.row_ok(row) && l2 != neg_inf();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cl = tx + 16 * c;
      const float p = (row_ok && mk.col_ok(row, j0 + cl))
                          ? exp2f(s[r][c] * scale_log2 - l2)
                          : 0.f;
      if (WRITE_P) t.p[rl * LDP + cl] = p;
      t.ds[rl * LDP + cl] = p * (dp[r][c] - dl);
    }
  }
}

// dV += P^T dO and dK += dS^T Q over one q tile.  Thread (w = tid / 32,
// lane) owns kv rows 8w .. 8w+7 and columns 4 lane .. 4 lane + 3.
template <int D>
__device__ __forceinline__ void accum_kv(const Tiles<D>& t, float dk[8][4],
                                         float dv[8][4]) {
  constexpr int LD = Tiles<D>::LD;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll 2
  for (int i = 0; i < BQ; ++i) {
    const float4 qq = *reinterpret_cast<const float4*>(t.q + i * LD + 4 * lane);
    const float4 oo =
        *reinterpret_cast<const float4*>(t.dO + i * LD + 4 * lane);
    float p[8], ds[8];
    *reinterpret_cast<float4*>(p) =
        *reinterpret_cast<const float4*>(t.p + i * LDP + 8 * w);
    *reinterpret_cast<float4*>(p + 4) =
        *reinterpret_cast<const float4*>(t.p + i * LDP + 8 * w + 4);
    *reinterpret_cast<float4*>(ds) =
        *reinterpret_cast<const float4*>(t.ds + i * LDP + 8 * w);
    *reinterpret_cast<float4*>(ds + 4) =
        *reinterpret_cast<const float4*>(t.ds + i * LDP + 8 * w + 4);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      dv[r][0] += p[r] * oo.x; dv[r][1] += p[r] * oo.y;
      dv[r][2] += p[r] * oo.z; dv[r][3] += p[r] * oo.w;
      dk[r][0] += ds[r] * qq.x; dk[r][1] += ds[r] * qq.y;
      dk[r][2] += ds[r] * qq.z; dk[r][3] += ds[r] * qq.w;
    }
  }
}

// dQ += dS K over one kv tile.  Thread (w, lane) owns q rows 8w .. 8w+7
// and columns 4 lane .. 4 lane + 3.
template <int D>
__device__ __forceinline__ void accum_q(const Tiles<D>& t, float dq[8][4]) {
  constexpr int LD = Tiles<D>::LD;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll 2
  for (int j = 0; j < BKV; j += 4) {
    float4 kk[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      kk[u] = *reinterpret_cast<const float4*>(t.k + (j + u) * LD + 4 * lane);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 ds =
          *reinterpret_cast<const float4*>(t.ds + (8 * w + r) * LDP + j);
      dq[r][0] += ds.x * kk[0].x + ds.y * kk[1].x + ds.z * kk[2].x +
                  ds.w * kk[3].x;
      dq[r][1] += ds.x * kk[0].y + ds.y * kk[1].y + ds.z * kk[2].y +
                  ds.w * kk[3].y;
      dq[r][2] += ds.x * kk[0].z + ds.y * kk[1].z + ds.z * kk[2].z +
                  ds.w * kk[3].z;
      dq[r][3] += ds.x * kk[0].w + ds.y * kk[1].w + ds.z * kk[2].w +
                  ds.w * kk[3].w;
    }
  }
}

// Write an 8x4-per-thread fp32 block (rows r0 + 8w + r < S of a row-major
// [S, D] matrix), times `mul`.
template <int D>
__device__ __forceinline__ void store_block(float* __restrict__ dst, int r0,
                                            int S, const float acc[8][4],
                                            float mul) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = r0 + 8 * w + r;
    if (row < S)
      *reinterpret_cast<float4*>(dst + (size_t)row * D + 4 * lane) =
          make_float4(acc[r][0] * mul, acc[r][1] * mul, acc[r][2] * mul,
                      acc[r][3] * mul);
  }
}

// Add this CTA's dq partial to q tile i0 of one head's dq [Sq, D] in kv-tile
// order: wait until `*counter == j`, add through L2, fence, increment.
template <int D>
__device__ __forceinline__ void fold_dq(float* __restrict__ dq, int* counter,
                                        int j, int i0, int Sq,
                                        const float part[8][4], float scale) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    // a wait of seconds means the dispatch-order assumption broke: trap
    // (the launch then fails loudly) rather than hang the card
    for (long long n = 0; *reinterpret_cast<volatile int*>(counter) != j;
         ++n) {
      if (n > (1LL << 24)) __trap();
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = i0 + 8 * w + r;
    if (row < Sq) {
      float4* p = reinterpret_cast<float4*>(dq + (size_t)row * D + 4 * lane);
      float4 a = __ldcg(p);
      a.x += part[r][0] * scale; a.y += part[r][1] * scale;
      a.z += part[r][2] * scale; a.w += part[r][3] * scale;
      __stcg(p, a);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(counter, 1);
}

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
  const int b = blockIdx.z, hk = blockIdx.y, jt = blockIdx.x;
  const int j0 = jt * BKV, G = N / Nk;
  const int Sq = mk.Sq, Skv = mk.Skv;
  const int nqb = (Sq + BQ - 1) / BQ;
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
                   part, scale);
      }
    }
  }
  store_block<D>(dk + bhk * Skv * D, j0, Skv, dka, scale);
  store_block<D>(dv + bhk * Skv * D, j0, Skv, dva, 1.f);
}

enum Route { kFused = 0, kDq = 1, kDkdv = 2 };

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
    e = allow_smem(flash_bwd_kv_kernel<T, D, true>, smem, &set);
    if (e != cudaSuccess) return e;
    flash_bwd_kv_kernel<T, D, true><<<grid, NT, smem, stream>>>(
        o_, q_, k_, v_, de, ls, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<int*>(counters), N, Nk, scale, mk);
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

}  // namespace

// Three entry points with one argument list: the split pair reads only
// the outputs it writes (dq; dk and dv); the fused kernel needs a zeroed
// dq and zeroed counters [B, N, ceil(Sq / 64)] int32.
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
