// The flash forward's online-softmax tile, SIMT fp32, shared by
// flash_fwd.cu (one round with a carry) and the fp32 instance of
// fused_ring_fwd.cu (every round of a ring): one CTA of NT threads holds
// BQ query rows' (m, l, acc) in registers and folds 64-row K/V tiles into
// them under the five mask scalars, so an fp32 ring round of the fused
// kernel does kernel 1's arithmetic on the same tile.  Both kernels' bf16
// instances run mma_tile.cuh's tensor-core WarpTile (mma_fold) instead.
//
// Thread layout: 16 (tx, columns) x 8 (ty, rows); thread (tx, ty) owns
// rows ty*RPT .. ty*RPT+RPT-1, score columns tx + 16c, and output columns
// c*64 + tx*4 .. +3.  Softmax runs in base 2 (q pre-scaled by
// scale*log2e, exp2f); m is kept in base 2, l linear.
#pragma once

#include "common.cuh"

namespace bat {
namespace flash {

constexpr int BQ = 64;         // q rows per CTA
constexpr int BKV = 64;        // kv rows per tile
constexpr int NT = 128;        // threads: 16 (tx) x 8 (ty)
constexpr int RPT = BQ / 8;    // q rows per thread
constexpr int CPT = BKV / 16;  // score columns per thread

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D] + sK [BKV][D+4] (sP [BQ][BKV+1] aliases it) + sV [BKV][D]
  return sizeof(float) * (BQ * D + BKV * (D + 4) + BKV * D);
}

// 8 elements through L2 only (ld.global.cg): for buffers that other CTAs
// rewrite while the kernel runs, whose lines an SM's L1 could hold stale.
__device__ __forceinline__ void load8_cg(const float* p, float* o) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8_cg(const __nv_bfloat16* p, float* o) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// load_rows (common.cuh) with the L2-only loads.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows_cg(const T* src, int r0, int S,
                                             float* dst, int ld) {
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NT) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    float v[8];
    if (r0 + r < S) {
      load8_cg(src + (size_t)(r0 + r) * D + col, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * ld + col);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// load_rows_cg of a wire payload: rows of D bytes, dequantized to T (and
// held as fp32) by wire_value.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows_wire(const uint8_t* src, int r0,
                                               int S, float* dst, int ld,
                                               float sc, int wire) {
  constexpr int kChunks = D / 8;
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NT) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    float v[8];
    if (r0 + r < S) {
      const uint2 u =
          __ldcg(reinterpret_cast<const uint2*>(src + (size_t)(r0 + r) * D +
                                                col));
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = wire_value<T>(b[e], sc, wire);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * ld + col);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// One q tile's online-softmax state (registers).
template <int D>
struct Rows {
  static constexpr int DC = D / 64;  // float4 groups per thread along d
  float m[RPT], l[RPT], acc[RPT][DC * 4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      m[i] = neg_inf();
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < DC * 4; ++e) acc[i][e] = 0.f;
    }
  }
};

// Fold the K/V rows [0, Skv) of one (batch, kv head) — kb/vb point at
// row 0 — into the state of q rows q0 .. q0+BQ-1, whose pre-scaled values
// are in sQ.  Tiles past the last visible column (no active row, kv_hi,
// the causal diagonal of the tile's last row) are skipped; every element
// is masked by (q_lo, q_hi, kv_hi, causal, offset).  WIN adds the
// sliding-window band `window` (kernel 1 and the fused ring's WIN
// instances): row r
// sees only columns above r + offset - window, and the loop starts at the
// tile holding the first active row's lowest column, so tiles below the
// band are never loaded and a CTA's cost follows the window, not the
// sequence (the TPU kernel's band grid, pallas_flash.py fwd_band_nb, as a
// loop bound).  WIN is a template flag so that the unwindowed instance
// compiles to the same code as before the band existed; SEG, another,
// adds the packed-sequence test qs[row] == ks[col] (the ids of one batch
// row, int32, read through the read-only cache; every tile the bounds
// leave is computed).  A row that sees no column of a tile keeps its
// state (m_new = m, alpha = 1, p = 0).  CG reads K/V through L2 only.
// All threads take part; on return sK/sV may be refilled after a
// __syncthreads().  WIRE (with CG; kernel 8's quantized slots): with
// `wire` kInt8 or kFp8E4M3, kb and vb address rows of D wire bytes that
// load_rows_wire dequantizes by ksc, vsc; with `wire` 0 they are T rows.
template <typename T, int D, bool CG, bool WIN = false, bool SEG = false,
          bool WIRE = false>
__device__ __forceinline__ void fold(Rows<D>& st, const float* sQ, float* sK,
                                     float* sV, const T* kb, const T* vb,
                                     int Skv, int q0, int Sq, int q_lo,
                                     int q_hi, int kv_hi, int causal,
                                     int offset, int window = 0,
                                     const int* qs = nullptr,
                                     const int* ks = nullptr, int wire = 0,
                                     float ksc = 1.f, float vsc = 1.f) {
  constexpr int LDK = D + 4;  // padded: conflict-free float4 row reads
  constexpr int LDP = BKV + 1;
  constexpr int DC = Rows<D>::DC;
  static_assert(BQ * LDP <= BKV * LDK, "sP must fit in sK");
  float* sP = sK;  // written only after every thread finished reading K
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // kv columns this q tile can see: none when no row is active; causal
  // rows stop at their diagonal, so tiles past the last row's are skipped
  const int r_lo = max(q0, q_lo);
  const int r_hi = min(min(q0 + BQ, q_hi), Sq);
  int c_end = 0;
  if (r_lo < r_hi) {
    c_end = min(kv_hi, Skv);
    if (causal) c_end = min(c_end, r_hi + offset);
  }
  // the band's lowest column over the tile's rows is the first row's
  const int c_begin =
      WIN ? max(0, r_lo + offset - window + 1) / BKV * BKV : 0;

  for (int j0 = c_begin; j0 < c_end; j0 += BKV) {
    __syncthreads();  // the previous tile's P/V readers are done
    if (WIRE && wire != 0) {
      load_rows_wire<T, D, BKV>(reinterpret_cast<const uint8_t*>(kb), j0,
                                Skv, sK, LDK, ksc, wire);
      load_rows_wire<T, D, BKV>(reinterpret_cast<const uint8_t*>(vb), j0,
                                Skv, sV, D, vsc, wire);
    } else if constexpr (CG) {
      load_rows_cg<T, D, BKV>(kb, j0, Skv, sK, LDK);
      load_rows_cg<T, D, BKV>(vb, j0, Skv, sV, D);
    } else {
      load_rows<T, D, BKV, NT>(kb, j0, Skv, sK, LDK, 1.f);
      load_rows<T, D, BKV, NT>(vb, j0, Skv, sV, D, 1.f);
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kk[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        kk[c] = *reinterpret_cast<const float4*>(sK + (tx + 16 * c) * LDK + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(sQ + (ty * RPT + i) * D + d);
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] += dot4(qq, kk[c]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      const bool row_ok = row >= q_lo && row < q_hi && row < Sq;
      float mx = neg_inf();
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = j0 + tx + 16 * c;
        const bool ok = row_ok && col < kv_hi && col < Skv &&
                        (!causal || col <= row + offset) &&
                        (!WIN || col > row + offset - window) &&
                        (!SEG || __ldg(qs + row) == __ldg(ks + col));
        s[i][c] = ok ? s[i][c] : neg_inf();
        mx = fmaxf(mx, s[i][c]);
      }
      // the 16 threads of a row are one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(st.m[i], mx);
      // rows that stay at -inf keep alpha = 1 (acc is 0): no -inf - -inf
      const float alpha = (st.m[i] >= m_new) ? 1.f : exp2f(st.m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = (s[i][c] == neg_inf()) ? 0.f : exp2f(s[i][c] - m_new);
        s[i][c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      st.l[i] = st.l[i] * alpha + sum;
      st.m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DC * 4; ++e) st.acc[i][e] *= alpha;
    }

    __syncthreads();  // every thread is done reading sK: P may overwrite it
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        sP[(ty * RPT + i) * LDP + tx + 16 * c] = s[i][c];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float4 vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        vv[c] = *reinterpret_cast<const float4*>(sV + j * D + c * 64 + tx * 4);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = sP[(ty * RPT + i) * LDP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          st.acc[i][4 * c] += p * vv[c].x;
          st.acc[i][4 * c + 1] += p * vv[c].y;
          st.acc[i][4 * c + 2] += p * vv[c].z;
          st.acc[i][4 * c + 3] += p * vv[c].w;
        }
      }
    }
  }
}

}  // namespace flash
}  // namespace bat
