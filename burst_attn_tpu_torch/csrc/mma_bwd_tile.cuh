// Tensor-core flash-backward tile for Hopper (sm_90a), built on mma.sync
// and mma_tile.cuh's pieces (cp.async staging, ldmatrix feeds, the
// m16n8k16 bf16 product, split_bf16): one CTA of eight warps holds a
// 64-row K/V tile and its fp32 dK, dV, and takes 64-row Q/dO tiles past
// it, one (q tile, kv tile) step at a time.  Included, not built alone;
// nothing in it depends on the ring: the bf16 instances of the fused ring
// backward (fused_ring_bwd.cu, kernel 9) and of the flash backward's fused
// kernel (flash_bwd.cu, kernels 2-3) run it, and the split pair's dk/dv
// kernel (flash_bwd.cu, kernel 5) runs its parts 1-2 (step<false>).
//
// A step, with P = exp2(S*scale*log2e - lse2) under the mask and
// dS = P*(dP - delta) (the scale of dS is applied by the caller, once):
//   1. S^T = K Q^T     warps 0-3 (kv rows 16w .. 16w+15, all 64 q columns)
//      dP^T = V dO^T   warps 4-7 (the same kv rows)
//      each warp hands its accumulators to its partner (w ^ 4) through
//      shared memory, so both warps of a pair hold S^T and dP^T in
//      registers and rebuild P^T and dS^T there, in fp32;
//   2. dV += P^T dO and dK += dS^T Q: warp w's 16 kv rows, columns
//      64 (w / 4) .. +63, so a thread holds 2 x 32 fp32 of dK, dV instead
//      of 2 x 64 (four warps holding all 128 columns would need ~250
//      registers and spill); P^T and dS^T are the A fragments straight
//      from the accumulators (the register layout of mma_tile.cuh's P);
//   3. dS^T goes to shared memory once, as bf16 hi and lo tiles;
//   4. dQ = dS K: warp w's q rows 16 (w % 4) .., columns 64 (w / 4) ..,
//      dS read back with ldmatrix.trans; the partial stays in registers
//      for the caller's fold (fold_add below).
// P and dS enter their products as two bf16 terms (split_bf16: the
// rounded value, then its rounded residual), ~16 significant bits, so the
// gradients stay at fp32 grade against the plain version (rounded once,
// P and dS moved them by up to 2.7e-3 of their largest entry in the plain
// emulation of tests/test_torch_ring_bwd.py); Q, K, V and dO arrive in
// bf16 and are exact.  That is 8 products a step where one
// rounding would take 5, the price of keeping the fp32 tolerance.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_bwd_tile.cuh"  // bwd::Mask
#include "mma_tile.cuh"
#include "ring_sync.cuh"

namespace bat {
namespace mbwd {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;          // q rows per tile
constexpr int BKV = 64;         // kv rows per tile
constexpr int NT = 256;         // eight warps
constexpr int LD = kTileLd;     // bf16 row stride of K, V, Q, dO
constexpr int LDS = BQ + 8;     // bf16 row stride of the dS^T tiles
constexpr int TILE = 64 * LD;   // elements of one staged tile

// The shared memory of one CTA: K, V; Q and dO in two stages (the next
// step's tiles land while this one's products run); dS^T as hi and lo;
// the exchange of step 1 (float4 [warp][n-tile][lane]); the q rows' lse
// (base 2) and delta; with packed segments (`seg`) the q rows' ids.
struct Smem {
  bf16 *k, *v, *stage, *dsh, *dsl;  // stage: Q of stage 0, 1, then dO's
  float4* x;
  float *lse2, *delta;
  int* qid;  // (SEG steps only)

  static constexpr size_t bytes(bool seg = false) {
    return sizeof(bf16) * (6 * TILE + 2 * BKV * LDS) +
           sizeof(float4) * 8 * 8 * 32 + sizeof(float) * 2 * BQ +
           (seg ? sizeof(int) * BQ : 0);
  }
  __device__ __forceinline__ explicit Smem(char* base) {
    bf16* b = reinterpret_cast<bf16*>(base);
    k = b;
    v = k + TILE;
    stage = v + TILE;
    dsh = stage + 4 * TILE;
    dsl = dsh + BKV * LDS;
    x = reinterpret_cast<float4*>(dsl + BKV * LDS);
    lse2 = reinterpret_cast<float*>(x + 8 * 8 * 32);
    delta = lse2 + BQ;
    qid = reinterpret_cast<int*>(delta + BQ);
  }
  // (computed, not arrays of pointers: indexed by the runtime stage, an
  // array went to local memory)
  __device__ __forceinline__ bf16* q(int st) const { return stage + st * TILE; }
  __device__ __forceinline__ bf16* dO(int st) const {
    return stage + (2 + st) * TILE;
  }
};

// fp32 dK, dV of the CTA's kv tile in mma accumulator fragments: warp w
// holds kv rows 16 (w % 4) + g (e < 2) and + 8 (e >= 2), columns
// 64 (w / 4) + 8n + 2c + (e & 1), with lane = 4g + c.
struct KvAcc {
  float dk[8][4], dv[8][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }
};

// (row, column) of fragment element (n, e) for warp w: rows from
// 16 (w % 4), columns from 64 (w / 4)
__device__ __forceinline__ int frag_row(int e) {
  return 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int frag_col(int n) {
  return 64 * (threadIdx.x / 128) + 8 * n + 2 * (threadIdx.x % 4);
}

// 2^x by the SFU (ex2.approx.ftz: 2 ulp; 0 for x = -inf)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + 64) (< S) of an fp32 row-major [S, kTileD] matrix into /
// out of fragments (through L2: another CTA may own the rows next), times
// `mul` on the way out.
__device__ __forceinline__ void load_frag(const float* src, int r0, int S,
                                          float (&a)[8][4]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + frag_row(2 * hf);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float2 x = make_float2(0.f, 0.f);
      if (row < S)
        x = __ldcg(reinterpret_cast<const float2*>(
            src + (size_t)row * kTileD + frag_col(n)));
      a[n][2 * hf] = x.x;
      a[n][2 * hf + 1] = x.y;
    }
  }
}
__device__ __forceinline__ void store_frag(float* dst, int r0, int S,
                                           const float (&a)[8][4],
                                           float mul) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + frag_row(2 * hf);
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      __stcg(reinterpret_cast<float2*>(dst + (size_t)row * kTileD +
                                       frag_col(n)),
             make_float2(a[n][2 * hf] * mul, a[n][2 * hf + 1] * mul));
  }
}

// One (q tile i0, kv tile j0) step on stage st's Q/dO tiles: dK, dV
// accumulate into acc, dQ's partial (unscaled) is returned in dq.  lse2
// (the rows' lse in base 2, +inf for a row that sees nothing or lies past
// S) and delta of the q tile must be in shared memory; all threads take
// part; on return the stage's tiles may be refilled after a
// __syncthreads().  With `cyc` (a tracing thread), adds the clock64
// cycles of S^T/dP^T and the exchange (cyc[0]), of P and dS as fragments
// (cyc[1]), of dV and dK (cyc[2]), of the dS^T store (cyc[3]) and of dQ
// (cyc[4]).  DQ = false stops after part 2 (no dS^T store, no dQ: `dq`
// is left as it is); lse2 and delta are first read after part 1's
// barrier, so a caller may write them after its own barrier that ends
// the previous step.  SEG (packed segments) tests sm.qid[row] (the q
// tile's ids, in shared memory like lse2) against the lane's two kv
// columns' ids kid0 (column col0) and kid1 (col0 + 8) on every element,
// the full tile's included: P, and with it dS, is zeroed by that test,
// since the final lse of a row that sees nothing of this tile is finite.
// WIN (the sliding-window band `window`) tests the band on every
// element of a tile the band cuts: the full-tile shortcut also needs the
// tile's lowest column inside the band of its last row.
template <bool DQ = true, bool SEG = false, bool WIN = false>
__device__ __forceinline__ void step(const Smem& sm, int st, KvAcc& acc,
                                     const bwd::Mask& mk, int i0, int j0,
                                     float scale_log2, float (&dq)[8][4],
                                     long long* cyc = nullptr, int kid0 = 0,
                                     int kid1 = 0, int window = 0) {
  long long t0 = cyc ? clock64() : 0;
  auto lap = [&](int i) {
    if (cyc) {
      const long long t = clock64();
      cyc[i] += t - t0;
      t0 = t;
    }
  };
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int kvg = w % 4, h = w / 4, g = lane / 4, c = lane % 4;
  const int mi = lane / 8, r8 = lane % 8;

  // ---- 1. S^T (h = 0) or dP^T (h = 1) for kv rows 16 kvg .. ----
  {
    float x[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
    const bf16* a_base = (h ? sm.v : sm.k) +
                         (16 * kvg + r8 + 8 * (mi % 2)) * LD + 8 * (mi / 2);
    const bf16* b_base =
        (h ? sm.dO(st) : sm.q(st)) + (8 * (mi / 2) + r8) * LD + 8 * (mi % 2);
#pragma unroll
    for (int kk = 0; kk < kTileD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_base + 16 * kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        ldmatrix_x4(b, b_base + 16 * jj * LD + 16 * kk);
        mma_bf16(x[2 * jj], a, b[0], b[1]);
        mma_bf16(x[2 * jj + 1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
      sm.x[(w * 8 + n) * 32 + lane] =
          make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
  }
  __syncthreads();
  lap(0);

  // ---- P^T and dS^T from the exchange (S^T of warp kvg, dP^T of warp
  // kvg + 4), straight into the A fragments of their products: per
  // k-step kt (q rows 16 kt ..) the hi and lo terms (split_bf16); n-tile
  // n is register 2 (n % 2) (row g) and 2 (n % 2) + 1 (row g + 8) of
  // k-step n / 2.  lse2 is +inf on a row that sees nothing (or lies past
  // S), so its P is exp2(-inf) = 0 with no test; a tile wholly inside the
  // mask tests nothing else either. ----
  const bool full = i0 >= mk.q_lo && i0 + BQ <= min(mk.q_hi, mk.Sq) &&
                    j0 + BKV <= min(mk.kv_hi, mk.Skv) &&
                    (!mk.causal || j0 + BKV - 1 <= i0 + mk.offset) &&
                    (!WIN || j0 > i0 + BQ - 1 + mk.offset - window);
  const int col0 = j0 + 16 * kvg + g;  // kv position of row g
  uint32_t pf[BQ / 16][2][4], sf[BQ / 16][2][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int ql = 8 * n + 2 * c;  // q row of element e & 1 == 0
    const float2 l2 = *reinterpret_cast<const float2*>(sm.lse2 + ql);
    const float2 dl = *reinterpret_cast<const float2*>(sm.delta + ql);
    const float4 s4 = sm.x[(kvg * 8 + n) * 32 + lane];
    const float4 d4 = sm.x[((kvg + 4) * 8 + n) * 32 + lane];
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse = (e & 1) ? l2.y : l2.x;
      p[e] = ex2_approx(fmaf(sv[e], scale_log2, -lse));
      if (!full) {
        const int row = i0 + ql + (e & 1), col = col0 + 8 * (e / 2);
        if (!(mk.row_ok(row) && mk.col_ok<WIN>(row, col, window)))
          p[e] = 0.f;
      }
      if constexpr (SEG) {
        if (sm.qid[ql + (e & 1)] != ((e / 2) ? kid1 : kid0)) p[e] = 0.f;
      }
      ds[e] = p[e] * (dv[e] - ((e & 1) ? dl.y : dl.x));
    }
    const int kt = n / 2, r0 = 2 * (n % 2);
    split_bf16(p[0], p[1], pf[kt][0][r0], pf[kt][1][r0]);
    split_bf16(p[2], p[3], pf[kt][0][r0 + 1], pf[kt][1][r0 + 1]);
    split_bf16(ds[0], ds[1], sf[kt][0][r0], sf[kt][1][r0]);
    split_bf16(ds[2], ds[3], sf[kt][0][r0 + 1], sf[kt][1][r0 + 1]);
  }

  lap(1);
  // ---- 2. dV += P^T dO, dK += dS^T Q over the 64 q rows, four n-tiles
  // of columns at a time: their products go to fresh accumulators (eight
  // independent chains), added to dV, dK by fp32 adds.  The tensor cores'
  // fp32 accumulation is not round-to-nearest: accumulated in place over
  // a launch's thousands of products, the kv gradients drifted by 1.6e-4
  // of their largest entry on the card (W=8, S_local 1024), past the
  // plain version's tolerance. ----
#pragma unroll
  for (int d2 = 0; d2 < 4; d2 += 2) {
    float tv[4][4], tk[4][4];  // n-tiles 2 d2 .. 2 d2 + 3 of dV, dK
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) tv[u][e] = tk[u][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt) {
#pragma unroll
      for (int dh = 0; dh < 2; ++dh) {
        const int off = (16 * kt + 8 * (mi % 2) + r8) * LD + 64 * h +
                        16 * (d2 + dh) + 8 * (mi / 2);
        uint32_t b[4];
        ldmatrix_x4_trans(b, sm.dO(st) + off);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_bf16(tv[2 * dh], pf[kt][t], b[0], b[1]);
          mma_bf16(tv[2 * dh + 1], pf[kt][t], b[2], b[3]);
        }
        ldmatrix_x4_trans(b, sm.q(st) + off);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          mma_bf16(tk[2 * dh], sf[kt][t], b[0], b[1]);
          mma_bf16(tk[2 * dh + 1], sf[kt][t], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc.dv[2 * d2 + u][e] += tv[u][e];
        acc.dk[2 * d2 + u][e] += tk[u][e];
      }
  }

  lap(2);
  if constexpr (!DQ) return;
  // ---- 3. dS^T to shared memory: warps 0-3 the hi terms, 4-7 the lo.
  // A register reg of k-step kt holds rows g + 8 (reg % 2), columns
  // 16 kt + 8 (reg / 2) + 2c, 2c + 1 ----
  {
    bf16* dst = (h ? sm.dsl : sm.dsh) + (16 * kvg + g) * LDS + 2 * c;
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt)
#pragma unroll
      for (int reg = 0; reg < 4; ++reg)
        // (not sf[kt][h]: a runtime index put sf in local memory)
        *reinterpret_cast<uint32_t*>(dst + 8 * (reg % 2) * LDS + 16 * kt +
                                     8 * (reg / 2)) =
            h ? sf[kt][1][reg] : sf[kt][0][reg];
  }
  __syncthreads();
  lap(3);

  // ---- 4. dQ = dS K: q rows 16 kvg .., columns 64 h .. ----
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < BKV / 16; ++kt) {
    uint32_t ah[4], al[4];
    const int aoff = (16 * kt + 8 * (mi / 2) + r8) * LDS + 16 * kvg +
                     8 * (mi % 2);
    ldmatrix_x4_trans(ah, sm.dsh + aoff);
    ldmatrix_x4_trans(al, sm.dsl + aoff);
    const int boff = (16 * kt + 8 * (mi % 2) + r8) * LD + 64 * h +
                     8 * (mi / 2);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, sm.k + boff + 16 * dd);
      mma_bf16(dq[2 * dd], ah, b[0], b[1]);
      mma_bf16(dq[2 * dd + 1], ah, b[2], b[3]);
      mma_bf16(dq[2 * dd], al, b[0], b[1]);
      mma_bf16(dq[2 * dd + 1], al, b[2], b[3]);
    }
  }
  lap(4);
}

// Parts 1-2 of a step alone: dK, dV accumulate into acc (the split pair's
// dk/dv kernel: 6 products a step, no dS^T tile, no dQ)
template <bool SEG = false, bool WIN = false>
__device__ __forceinline__ void step_kv(const Smem& sm, int st, KvAcc& acc,
                                        const bwd::Mask& mk, int i0, int j0,
                                        float scale_log2, int kid0 = 0,
                                        int kid1 = 0, int window = 0) {
  float unused[8][4];
  step<false, SEG, WIN>(sm, st, acc, mk, i0, j0, scale_log2, unused,
                        nullptr, kid0, kid1, window);
}

// The ids step<., true> tests against, for the CTA's kv tile j0 of one
// batch row's kv ids [Skv]: the lane's columns col0 = j0 + 16 (w % 4) +
// g and col0 + 8 (-1 past Skv: those columns are masked anyway).
__device__ __forceinline__ void kv_tile_ids(const int* kv_ids, int j0,
                                            int Skv, int& kid0, int& kid1) {
  const int col0 = j0 + 16 * ((threadIdx.x / 32) % 4) + (threadIdx.x % 32) / 4;
  kid0 = col0 < Skv ? kv_ids[col0] : -1;
  kid1 = col0 + 8 < Skv ? kv_ids[col0 + 8] : -1;
}

// Fold this CTA's dq partial (fragments of step(), times scale) into q
// tile i0 of one head's dq [S, kTileD] as kv tile j of the tile's
// contributors, which fold in increasing j (bwd::fold_dq's protocol):
// wait until `*counter` reaches j, then add (or, seeding, write) the
// partial by reductions performed at L2 (red.global.add, four floats
// each: lanes c and c ^ 1 trade a pair, so that one holds row g's four
// columns, the other row g + 8's; nothing is read back into the SM).
// The count is fold_count's; the order stays fixed, since kv tile j - 1's
// reductions are performed before its count (two launches are bitwise
// equal).  Deferring the count past the next step's products, to
// hide the fence, made the chain of kv tiles wait longer: the ring step's
// kernel 9 took 14.07 ms against 10.43 (tools/kernel_ab.py, H100).  With
// `wait_ns`, thread 0 adds the time it waited.
__device__ __forceinline__ void fold_add(float* __restrict__ dq,
                                         const int* counter, int j, int i0,
                                         int S, const float (&part)[8][4],
                                         float scale, bool seed,
                                         long long* wait_ns) {
  if (threadIdx.x == 0) {  // (the acquire load orders what follows)
    const unsigned long long t0 = wait_ns ? global_ns() : 0;
    wait_ge(counter, j);
    if (wait_ns) *wait_ns += (long long)(global_ns() - t0);
  }
  __syncthreads();
  const bool odd = threadIdx.x % 2;  // c odd: row g + 8, columns 2c - 2 ..
  const int row = i0 + frag_row(odd ? 2 : 0);
  const int col = frag_col(0) - (odd ? 2 : 0);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float s0 = odd ? part[n][0] : part[n][2];  // the partner's pair
    const float s1 = odd ? part[n][1] : part[n][3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    const float4 v =
        odd ? make_float4(r0, r1, part[n][2], part[n][3])
            : make_float4(part[n][0], part[n][1], r0, r1);
    if (row >= S) continue;
    float4* p = reinterpret_cast<float4*>(dq + (size_t)row * kTileD + col +
                                          8 * n);
    const float4 a = make_float4(v.x * scale, v.y * scale, v.z * scale,
                                 v.w * scale);
    if (seed)
      __stcg(p, a);
    else
      atomicAdd(p, a);
  }
}

// Count a fold_add once every thread's reductions are issued: a barrier,
// then thread 0's release fence (acq_rel, lighter than __threadfence's
// sequentially consistent one) and count.
__device__ __forceinline__ void fold_count(int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    atomicAdd(counter, 1);
  }
}

}  // namespace mbwd
}  // namespace bat
