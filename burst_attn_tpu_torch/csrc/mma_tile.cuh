// Tensor-core attention tile for Hopper (sm_90a), built on mma.sync:
// cp.async staging, ldmatrix fragment loads and one warp's online-softmax
// step over a 64-token K/V chunk.  Included, not built alone.
//
// A warp owns 16 query rows.  S = Q.K^T and O += P.V run on
// mma.sync.m16n8k16 with bf16 inputs and fp32 accumulation; Q's A
// fragments are re-read from shared memory each k-step (held for the whole
// walk they cost 32 registers a thread, and the kernel spilled), P is
// rebuilt from the S accumulators as the A fragments of the P.V product
// (the FlashAttention register layout), so nothing of S or P touches
// shared memory.  K and V
// chunks sit in shared memory as bf16 rows of kTileLd elements (the 16-byte
// pad makes the eight rows an ldmatrix reads fall on distinct banks); V is
// read with ldmatrix.trans.  The softmax is base 2: the caller hands each
// score's factor (scale * log2(e), times a per-token dequantization scale
// for a 1-byte pool) and a visibility test, and the -inf guards keep a
// fully masked row at m = -inf, l = 0, O = 0.  Nothing here depends on the
// paged layout: the ragged kernel (kernel 7, and kernel 6 as its QT=1
// instance) steps WarpTile over its pages; the flash forward's and the
// fused ring forward's bf16 instances (kernels 1 and 8) walk their K/V
// rows through mma_fold below.

#pragma once

#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace bat {

constexpr int kTileChunk = 64;   // K/V tokens per chunk
constexpr int kTileD = 128;      // head dim
constexpr int kTileLd = kTileD + 8;  // bf16 row stride in shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous global -> shared copy (L2 only: the chunks stream)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// 4-byte asynchronous global -> shared copy (through L1): a chunk's
// packed-sequence ids, staged beside its K and V
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy `rows` rows of RB bytes each (contiguous in global memory) into
// shared rows LDB bytes apart; every thread of the NT-thread block issues
// its share of 16-byte pieces.
template <int RB, int LDB, int NT>
__device__ __forceinline__ void cp_rows(char* dst, const char* src,
                                        int rows) {
  constexpr int P = RB / 16;
  for (int i = threadIdx.x; i < rows * P; i += NT) {
    const int r = i / P, c = i % P;
    cp_async16(dst + r * LDB + c * 16, src + (size_t)r * RB + c * 16);
  }
}

// ROWS rows of kTileD bf16 (kTileD apart in global memory) into shared
// rows kTileLd apart: rows [0, valid) by cp.async, the rest zeroed (a
// padding row must hold finite values: P = 0 times garbage can be NaN)
template <int ROWS, int NT>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src,
                                        int valid) {
  constexpr int P = kTileD / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < ROWS * P; i += NT) {
    const int r = i / P, c = (i % P) * 8;
    if (r < valid)
      cp_async16(dst + r * kTileLd + c, src + (size_t)r * kTileD + c);
    else
      *reinterpret_cast<uint4*>(dst + r * kTileLd + c) =
          make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a.b, one m16n8k16 product: bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 wire bytes (8-byte aligned, through L2) times the block's scale, each
// rounded to bf16 (fp32 multiply, round to nearest even: the plain
// version's (q.float() * scale).to(bf16)) and packed as one 16-byte row
// piece.
__device__ __forceinline__ uint4 wire_bf16x8(const uint8_t* src, float sc,
                                             int wire) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(src));
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&u);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack_bf16(wire_byte(b[2 * i], wire) * sc,
                     wire_byte(b[2 * i + 1], wire) * sc);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// cp_tile's rows from a wire payload: ROWS rows of kTileD bytes (kTileD
// apart) dequantized to bf16 into shared rows kTileLd apart by plain loads
// and stores (the 1-byte rows cannot go through cp.async as bf16); rows
// [valid, ROWS) zeroed.
template <int ROWS, int NT>
__device__ __forceinline__ void deq_tile(__nv_bfloat16* dst,
                                         const uint8_t* src, int valid,
                                         float sc, int wire) {
  constexpr int P = kTileD / 8;  // 16-byte pieces a shared row
  for (int i = threadIdx.x; i < ROWS * P; i += NT) {
    const int r = i / P, c = (i % P) * 8;
    *reinterpret_cast<uint4*>(dst + r * kTileLd + c) =
        r < valid ? wire_bf16x8(src + (size_t)r * kTileD + c, sc, wire)
                  : make_uint4(0, 0, 0, 0);
  }
}

// (a, b) as two bf16 pairs whose sum carries ~16 significant bits: hi the
// rounded values, lo the rounded residuals
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// One warp's 16 query rows through a K/V walk.  Lane (g = lane / 4,
// c = lane % 4) holds rows g and g + 8 of the warp's tile: columns
// 8n + 2c, 8n + 2c + 1 of O's n-tile n (o[n][0..1] row g, o[n][2..3] row
// g + 8), and a partial row sum l over its own columns (reduced across the
// quad by finish()).  m is the row's running max, base 2, quad-uniform.
struct WarpTile {
  const __nv_bfloat16* q;  // the lane's ldmatrix row of the Q tile
  float o[kTileD / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kTileD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = neg_inf();
    l[0] = l[1] = 0.f;
  }

  // Q rows [0, 16) of the warp's tile: bf16 rows kTileLd apart in shared
  // memory, resident for the whole walk
  __device__ __forceinline__ void set_q(const __nv_bfloat16* sQ) {
    const int lane = threadIdx.x % 32;
    q = sQ + ((lane % 8) + 8 * ((lane / 8) % 2)) * kTileLd + 8 * (lane / 16);
  }

  // One chunk of NTOK tokens (a multiple of 16; bf16 rows kTileLd apart).
  // factor(col) is the score factor of token col (fp32), visible(half,
  // col) whether row g (half 0) or g + 8 (half 1) sees it, pscale(col) the
  // factor applied to p before the P.V product (the value dequantization
  // scale, 1 for a full-precision pool).  P.V takes p as two bf16 terms
  // (rounded p, then its rounded residual) against the same V fragments:
  // p rounded once to bf16 moved outputs of rows that see few positions
  // by up to 2.5e-3 on the card, past the bf16 output tolerance, and the
  // second product adds half again the tensor-core work a chunk, no extra
  // shared-memory reads.  l sums the unrounded p.
  template <int NTOK, typename Factor, typename Visible, typename PScale>
  __device__ __forceinline__ void step(const __nv_bfloat16* sK,
                                       const __nv_bfloat16* sV, Factor factor,
                                       Visible visible, PScale pscale) {
    static_assert(NTOK % 16 == 0, "whole k-steps of P.V");
    constexpr int NS = NTOK / 8;  // score n-tiles
    const int lane = threadIdx.x % 32, c = lane % 4, mi = lane / 8,
              r8 = lane % 8;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTileD / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, q + 16 * kk);
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
        uint32_t kb[4];
        ldmatrix_x4(kb, sK + (16 * jj + 8 * (mi / 2) + r8) * kTileLd +
                            16 * kk + 8 * (mi % 2));
        mma_bf16(s[2 * jj], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jj + 1], qa, kb[2], kb[3]);
      }
    }

    float mx[2][2] = {{neg_inf(), neg_inf()}, {neg_inf(), neg_inf()}};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + (e & 1), half = e / 2;
        const float x = s[j][e] * factor(col);
        s[j][e] = visible(half, col) ? x : neg_inf();
        mx[half][j % 2] = fmaxf(mx[half][j % 2], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = fmaxf(mx[h][0], mx[h][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[h], x);
      alpha[h] = (m[h] >= m_new) ? 1.f : exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e / 2;
        const float p =
            (s[j][e] == neg_inf()) ? 0.f : exp2f(s[j][e] - m[half]);
        sum[half] += p;
        s[j][e] = p * pscale(8 * j + 2 * c + (e & 1));
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], alpha[h], sum[h]);
#pragma unroll
    for (int n = 0; n < kTileD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

#pragma unroll
    for (int kt = 0; kt < NTOK / 16; ++kt) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kt][0], s[2 * kt][1], ph[0], pl[0]);
      split_bf16(s[2 * kt][2], s[2 * kt][3], ph[1], pl[1]);
      split_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dd = 0; dd < kTileD / 16; ++dd) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sV + (16 * kt + 8 * (mi % 2) + r8) * kTileLd +
                                  16 * dd + 8 * (mi / 2));
        mma_bf16(o[2 * dd], ph, vb[0], vb[1]);
        mma_bf16(o[2 * dd + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * dd], pl, vb[0], vb[1]);
        mma_bf16(o[2 * dd + 1], pl, vb[2], vb[3]);
      }
    }
  }

  // Reduce each row's sum across its quad; after this l[h] is the row's.
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
  }
};


// Fold the K/V rows [0, Skv) of one (batch, kv head) (kb, vb: row 0, bf16
// rows kTileD apart) into four warps' WarpTile state of q rows q0 ..
// q0 + 63 (warp w: rows 16 w ..), whose bf16 values are in sQ (rows
// kTileLd apart), under the five mask scalars (q_lo, q_hi, kv_hi, causal,
// offset) and, with WIN, the sliding-window band: row r sees only columns
// above r + offset - window.  64-token chunks go through two stages of
// sKV (K then V a stage, 4 * 64 * kTileLd elements in all) by cp.async.cg,
// a chunk's copy landing while the previous chunk's products run.  The
// chunk range is flash::fold's (flash_tile.cuh): none when no row is
// active, up to the last active row's causal diagonal and kv_hi, and with
// WIN from the chunk that holds the first active row's lowest column, so
// chunks below the band are never loaded (a windowed prefill costs
// O(S * window)).  A warp skips a chunk wholly past its rows' last
// visible column (and, WIN, wholly below their band).  WIN is a template
// flag: a runtime test slowed paged decode 0.341 -> 0.488 ms, and the
// instance without it is the code kernel 8 ran before the band existed.
// Rows and columns past Sq, Skv are staged as zeros and masked.  SEG
// (a template flag, as WIN) adds the packed-sequence test: row r sees
// column c only where q_ids[r] == kv_ids[c] (the ids of one batch row,
// int32); each lane holds its two rows' ids in registers, and a chunk's
// 64 kv ids land in sIds (two stages of 64 ints) by cp.async beside its
// K and V.  It skips no chunk a segment boundary leaves dead: every chunk
// the bounds above leave is computed and masked by id.  A row may then
// see no column of a chunk while its state is live: WarpTile::step keeps
// its m, l and alpha as they are (x = -inf, m_new = m, alpha = 1, p = 0).
// WIRE (a template flag, as WIN) lets the K/V rows be a ring's wire
// payload (kernel 8's quantized slots): with `wire` kInt8 or kFp8E4M3, kb
// and vb address 1-byte rows (kTileD bytes apart) whose values times ksc,
// vsc are staged as bf16 by deq_tile (plain loads, so a chunk's loads are
// not overlapped with the previous chunk's products); with `wire` 0 the
// rows are bf16 as without WIRE.
// The caller has issued, and not committed, the Q tile's copies; all 128
// threads take part; on return nothing is in flight.
template <bool WIN, bool SEG = false, bool WIRE = false>
__device__ __forceinline__ void mma_fold(
    WarpTile& wt, const __nv_bfloat16* sQ, __nv_bfloat16* sKV,
    const __nv_bfloat16* kb, const __nv_bfloat16* vb, int Sq, int Skv,
    int q0, float scale_log2, int q_lo, int q_hi, int kv_hi, int causal,
    int offset, int window, const int* q_ids = nullptr,
    const int* kv_ids = nullptr, int* sIds = nullptr, int wire = 0,
    float ksc = 1.f, float vsc = 1.f) {
  constexpr int BQ = 64, NT = 128, TILE = 64 * kTileLd;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4;
  const int r_lo = max(q0, q_lo), r_hi = min(min(q0 + BQ, q_hi), Sq);
  int c_end = 0;
  if (r_lo < r_hi) {
    c_end = min(kv_hi, Skv);
    if (causal) c_end = min(c_end, r_hi + offset);
  }
  // the band's lowest column over the tile's rows is the first row's
  const int i_begin =
      WIN ? max(0, r_lo + offset - window + 1) / kTileChunk : 0;
  const int n = c_end > 0 ? (c_end + kTileChunk - 1) / kTileChunk : 0;
  // the columns each of the lane's rows sees, [lo, hi] (hi = -1: none),
  // and the warp's extremes: a chunk outside them leaves the warp's state
  // as it is
  int hi[2], lo[2], qid[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qr = q0 + 16 * w + g + 8 * hf;
    const bool ok = qr >= q_lo && qr < q_hi && qr < Sq;
    int h_ = min(kv_hi, Skv) - 1;
    if (causal) h_ = min(h_, qr + offset);
    hi[hf] = ok ? h_ : -1;
    lo[hf] = WIN ? (ok ? qr + offset - window + 1 : INT_MAX) : 0;
    qid[hf] = (SEG && ok) ? q_ids[qr] : 0;
  }
  const int w_hi = __reduce_max_sync(0xffffffffu, max(hi[0], hi[1]));
  const int w_lo =
      WIN ? __reduce_min_sync(0xffffffffu, min(lo[0], lo[1])) : 0;
  auto issue = [&](int i) {
    __nv_bfloat16* st = sKV + (i & 1) * 2 * TILE;
    const int valid = min(kTileChunk, Skv - kTileChunk * i);
    if (WIRE && wire != 0) {
      const size_t at = (size_t)kTileChunk * i * kTileD;  // bytes
      deq_tile<kTileChunk, NT>(
          st, reinterpret_cast<const uint8_t*>(kb) + at, valid, ksc, wire);
      deq_tile<kTileChunk, NT>(
          st + TILE, reinterpret_cast<const uint8_t*>(vb) + at, valid, vsc,
          wire);
    } else {
      cp_tile<kTileChunk, NT>(st, kb + (size_t)kTileChunk * i * kTileD,
                              valid);
      cp_tile<kTileChunk, NT>(st + TILE,
                              vb + (size_t)kTileChunk * i * kTileD, valid);
    }
    if constexpr (SEG) {
      if ((int)threadIdx.x < valid)
        cp_async4(sIds + (i & 1) * kTileChunk + threadIdx.x,
                  kv_ids + kTileChunk * i + threadIdx.x);
    }
  };
  if (i_begin < n) issue(i_begin);
  cp_async_commit();
  wt.set_q(sQ + 16 * w * kTileLd);
  for (int i = i_begin; i < n; ++i) {
    cp_async_wait<0>();  // chunk i (and Q) has landed
    __syncthreads();     // ... for every thread; chunk i - 1 is done with
    if (i + 1 < n) issue(i + 1);
    cp_async_commit();
    const int j0 = kTileChunk * i;
    if (j0 > w_hi) continue;
    if (WIN && j0 + kTileChunk - 1 < w_lo) continue;
    const __nv_bfloat16* sK = sKV + (i & 1) * 2 * TILE;
    const int* sid = SEG ? sIds + (i & 1) * kTileChunk : nullptr;
    wt.step<kTileChunk>(
        sK, sK + TILE, [&](int) { return scale_log2; },
        [&](int hf, int col) {
          return j0 + col <= hi[hf] && (!WIN || j0 + col >= lo[hf]) &&
                 (!SEG || sid[col] == qid[hf]);
        },
        [&](int) { return 1.f; });
  }
  cp_async_wait<0>();
}

}  // namespace bat
