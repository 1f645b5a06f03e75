// The flash backward's SIMT fp32 tiles and tile math, shared by
// flash_bwd.cu (one backward round: the split dq and dk/dv kernels and the
// fused kernel) and the fp32 instance of fused_ring_bwd.cu (every round of
// the backward ring), so an fp32 ring round of the fused ring backward
// does the flash backward's arithmetic on the same tiles.  The bf16
// instances (both fused kernels, the split pair) run on tensor-core tiles
// (mma_bwd_tile.cuh, mma_tile.cuh).
//
// Per (q tile i, kv tile j) step, with P = exp2(S*scale*log2e - lse*log2e):
//   S = Q K^T, dP = dO V^T, dS = P * (dP - delta),
//   dV += P^T dO, dK += dS^T Q, dQ += dS K;
// the scale of dS is applied by the callers, once.
#pragma once

#include "common.cuh"
#include "ring_sync.cuh"

namespace bat {
namespace bwd {

constexpr int BQ = 64;         // q rows per tile
constexpr int BKV = 64;        // kv rows per tile
constexpr int NT = 256;        // threads per CTA
constexpr int LDP = BKV + 4;   // row stride of the P and dS tiles

template <int D>
constexpr size_t smem_bytes() {
  // sK, sV, sQ, sdO [64][D+4]; sP, sdS [64][LDP]; lse2, delta [BQ]
  return sizeof(float) * (4 * 64 * (D + 4) + 2 * 64 * LDP + 2 * BQ);
}

// The five mask scalars and the lengths.  The sliding-window band
// `window` of the WIN instances travels beside it (a kernel parameter of
// its own: a wider Mask parameter changed the instances without WIN):
// row r sees column c only where c > r + offset - window
// (masks.dense_mask).
struct Mask {
  int q_lo, q_hi, kv_hi, causal, offset, Sq, Skv;

  __device__ __forceinline__ bool row_ok(int row) const {
    return row >= q_lo && row < q_hi && row < Sq;
  }
  template <bool WIN = false>
  __device__ __forceinline__ bool col_ok(int row, int col,
                                         int window = 0) const {
    return col < kv_hi && col < Skv && (!causal || col <= row + offset) &&
           (!WIN || col > row + offset - window);
  }
};

// The q rows [i_lo, i_hi) that see some column of the kv tile [j0, j0 +
// BKV) (i_hi <= i_lo: none): causal rows from j0 - offset on (the
// diagonal) and, WIN, rows up to the last whose band still reaches the
// tile's last visible column (row + offset - window < that column).
template <bool WIN>
__device__ __forceinline__ void kv_tile_rows(const Mask& mk, int j0,
                                             int window, int& i_lo,
                                             int& i_hi) {
  i_lo = max(mk.q_lo, 0);
  i_hi = min(mk.q_hi, mk.Sq);
  if (mk.causal) i_lo = max(i_lo, j0 - mk.offset);
  if (j0 >= min(mk.kv_hi, mk.Skv)) i_hi = i_lo;
  if (WIN)
    i_hi = min(i_hi, min(j0 + BKV, min(mk.kv_hi, mk.Skv)) + window - 1 -
                         mk.offset);
}

// The kv columns [c_lo, c_end) that the rows of q tile [i0, i0 + BQ) can
// see (c_end <= c_lo: none): up to the last active row's diagonal and
// kv_hi and, WIN, from the first active row's band start.  The kv tiles
// that see the q tile are exactly c_lo / BKV .. (c_end - 1) / BKV, the
// tiles whose kv_tile_rows range meets it: a contiguous range, so the
// fused kernels' dq folds count a tile's contributors from c_lo / BKV.
template <bool WIN>
__device__ __forceinline__ void q_tile_cols(const Mask& mk, int i0,
                                            int window, int& c_lo,
                                            int& c_end) {
  const int r_lo = max(i0, mk.q_lo);
  const int r_hi = min(min(i0 + BQ, mk.q_hi), mk.Sq);
  c_end = 0;
  if (r_lo < r_hi) {
    c_end = min(mk.kv_hi, mk.Skv);
    if (mk.causal) c_end = min(c_end, r_hi + mk.offset);
  }
  c_lo = WIN ? max(0, r_lo + mk.offset - window + 1) : 0;
}

// The first kv tile that sees q tile [i0, i0 + BQ): its contributors to
// a dq fold are counted from it (0 without a band)
template <bool WIN>
__device__ __forceinline__ int first_kv_tile(const Mask& mk, int i0,
                                             int window) {
  if (!WIN) return 0;
  int c_lo, c_end;
  q_tile_cols<true>(mk, i0, window, c_lo, c_end);
  return c_lo / BKV;
}

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
// tx = tid % 16) owns rows ty + 16 r and columns tx + 16 c.  SEG adds the
// packed-sequence test qs[row] == ks[col] (one batch row's int32 ids):
// P and dS are zeroed by the test itself, since a row's final lse is
// finite while it may see nothing of this tile.  WIN adds the band
// `window` (Mask::col_ok<true>); a row whose band ends before the tile
// gets P = 0 the same way.
template <int D, bool WRITE_P, bool SEG = false, bool WIN = false>
__device__ __forceinline__ void scores(const Tiles<D>& t, float scale_log2,
                                       int i0, int j0, const Mask& mk,
                                       const int* qs = nullptr,
                                       const int* ks = nullptr,
                                       int window = 0) {
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
      const float p = (row_ok && mk.col_ok<WIN>(row, j0 + cl, window) &&
                       (!SEG || __ldg(qs + row) == __ldg(ks + j0 + cl)))
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


// The CTA's ticket: one atomicAdd on `*ticket` by thread 0, shared with the
// block.  Tickets are handed out in the order CTAs START, whatever order
// the hardware dispatches them in, so a CTA holding ticket t knows that
// every ticket below t belongs to a CTA that is already resident or done.
__device__ __forceinline__ int take_ticket(int* ticket) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  return s_ticket;
}

// Fold this CTA's dq partial (times scale) into q tile i0 of one head's dq
// [S, D] as kv tile j of the tile's contributors, which fold in increasing
// j: wait until `*counter` reaches j, add (or, seeding, write) through L2,
// fence, count.  The wait traps after ring_sync's timeout.
template <int D>
__device__ __forceinline__ void fold_dq(float* __restrict__ dq, int* counter,
                                        int j, int i0, int S,
                                        const float part[8][4], float scale,
                                        bool seed) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    wait_ge(counter, j);
    __threadfence();
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = i0 + 8 * w + r;
    if (row < S) {
      float4* p = reinterpret_cast<float4*>(dq + (size_t)row * D + 4 * lane);
      float4 a = seed ? make_float4(0.f, 0.f, 0.f, 0.f) : __ldcg(p);
      a.x += part[r][0] * scale; a.y += part[r][1] * scale;
      a.z += part[r][2] * scale; a.w += part[r][3] * scale;
      __stcg(p, a);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(counter, 1);
}

}  // namespace bwd
}  // namespace bat
