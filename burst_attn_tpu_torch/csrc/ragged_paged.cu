// Ragged paged attention: one launch for a mixed chunked-prefill + decode
// token batch against the shared K/V page pool.
//
// Replaces: burst_attn_tpu/ops/ragged_paged.py `_ragged_kernel` (via
// `ragged_paged_attention`), the Pallas TPU kernel whose grid walks
// (slot, kv-head, q-block, page-slot) with the page tables, lengths and
// context bounds delivered by scalar prefetch.  Full-precision pools and
// int8 / fp8 e4m3 pools with per-token fp32 scales; the split-k hooks
// (ctx_lo, emit_partials) of the grouped shared-prefix front end; the
// sliding window.
//
// Contract: q [S,Nq,QT,D] bf16/fp32; k/v pages [P,Nkv,page,D] in q's dtype
// or 1 B/elem with scales [P,Nkv,page] fp32; page_table [S,width], q_lens
// [S], kv_lens [S] (including this launch's tokens) and optional ctx_lo [S],
// all int32.  Query token t of slot s sits at kv_lens[s] - q_lens[s] + t
// and sees the positions at or below it, except whole pages below
// ctx_lo[s] and, with window > 0, the positions below its band (a token
// at position qp sees qp - window + 1 .. qp).  Output [S,Nq,QT,D] in q's
// dtype, or (emit_partials) the unnormalised fp32 accumulator [S,Nq,QT,D]
// with the base-2 running max m and sum l [S,Nq,QT]; rows at or past
// q_lens[s] (and idle slots) give zeros, or acc 0 / m -inf / l 0.
//
// What bounds it on an H100: for a decode-heavy batch, device-memory bytes
// (each live K/V row read once per slot and kv head); for a batch of long
// prefill chunks, operations (4 per visible (query head, position) pair
// and head-dim element).  What the design does about it: one CTA per
// (slot, kv head, block of bq query tokens), the G query heads of the kv
// head folded into the block's rows (bq * G <= 64), so GQA shares every
// loaded chunk; a block of at most 16 rows (a decode batch) runs an
// instance sized for 16, as the decode kernel is.  Each CTA reads its own
// page ids from the table and loops only over the pages from the larger of
// ctx_lo//page and its first query token's window band up to its last
// query token's position, skipping the 64-token chunks wholly below that
// band: pages above the causal edge or below the window are never loaded,
// so cost follows each slot's length (or window), and an idle slot or an
// all-padding block writes its zeros and exits.  K/V go through shared
// memory in 64-token chunks, and the online softmax (fp32, base 2, q
// pre-scaled by scale*log2e) is the update the decode kernel runs (common.cuh PagedRows), so a QT == 1 batch
// is bit-identical to paged_decode.cu.  The TPU kernel's sublane padding,
// group folding copies and clamped dead-page fetches have no counterpart.
// Not yet done: tensor cores (wgmma) for the prefill rows, TMA, and a
// split-k over pages for long decode contexts — later work.

#include "common.cuh"

namespace {

using namespace bat;

constexpr int CH = kPagedChunk;
constexpr int NT = kPagedThreads;
// query rows per block (bq tokens x G heads): prefill blocks hold up to 64;
// a block of at most 16 rows (a decode batch) runs an instance sized for
// 16, which carries no idle row slots through its unrolled loops
constexpr int MAXR = 64;
constexpr int MAXR_DECODE = 16;

template <int D, int ROWS>
constexpr size_t smem_bytes() {
  // sQ [ROWS][D] + sK [CH][D+4] + sV [CH][D] + sS [ROWS][CH] + sA, sM, sL
  // + sKs, sVs
  return sizeof(float) * (ROWS * D + CH * (D + 4) + CH * D + ROWS * CH +
                          3 * ROWS + 2 * CH);
}

template <typename T, typename KV, int D, int ROWS, bool QUANT, bool WIN>
__global__ void __launch_bounds__(NT)
ragged_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
              const KV* __restrict__ vp, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ table,
              const int* __restrict__ q_lens, const int* __restrict__ kv_lens,
              const int* __restrict__ ctx_lo, T* __restrict__ out,
              float* __restrict__ acc_out, float* __restrict__ m_out,
              float* __restrict__ l_out, int Nkv, int G, int QT, int page,
              int width, int bq, int window, float scale_log2) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + ROWS * D;
  float* sV = sK + CH * (D + 4);
  float* sS = sV + CH * D;     // scores, then probabilities, [rows][CH]
  float* sA = sS + ROWS * CH;  // per-row rescale of the current chunk
  float* sM = sA + ROWS;
  float* sL = sM + ROWS;
  float* sKs = sL + ROWS;      // the chunk's scales (quantized pools)
  float* sVs = sKs + CH;

  const int qb = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = bq * G;     // row r = token t0q + r / G, head r % G
  const int t0q = qb * bq;
  const int q_len = q_lens[s];
  const int q_start = kv_lens[s] - q_len;  // position of query token 0
  const bool partials = acc_out != nullptr;
  // element offset of row r's [D] vector in q / out / acc (rows past QT
  // are not stored)
  auto row_off = [&](int r) {
    const int t = t0q + r / G, g = r % G;
    return ((((size_t)s * Nkv + h) * G + g) * QT + t) * D;
  };
  auto row_stored = [&](int r) { return t0q + r / G < QT; };

  if (t0q >= q_len) {  // idle slot or an all-padding block
    for (int i = tid; i < rows * D; i += NT) {
      const int r = i / D;
      if (!row_stored(r)) continue;
      if (partials) {
        acc_out[row_off(r) + i % D] = 0.f;
        if (i % D == 0) {
          m_out[row_off(r) / D] = neg_inf();
          l_out[row_off(r) / D] = 0.f;
        }
      } else {
        store(out + row_off(r) + i % D, 0.f);
      }
    }
    return;
  }

  for (int i = tid; i < rows * D; i += NT) {
    const int r = i / D;
    sQ[i] = row_stored(r) ? to_float(q[row_off(r) + i % D]) * scale_log2
                          : 0.f;
  }
  // the block's last visible position: its last real token's
  const int p_max = q_start + min(q_len, t0q + bq) - 1;
  const int lo = ctx_lo != nullptr ? ctx_lo[s] : 0;
  const int p_end = min(p_max / page, width - 1);
  // the band of the block's first token starts lowest: every row's band
  // lies at or above it (the same start as the decode kernel's for QT=1);
  // WIN is a template flag so that the unwindowed instance compiles to the
  // same code as before the band existed
  const int band_lo = WIN ? q_start + t0q - window + 1 : 0;

  PagedRows<ROWS> st;
  st.init();
  for (int p = WIN ? max(max(lo, 0) / page, max(band_lo, 0) / page)
                   : max(lo, 0) / page;
       p <= p_end; ++p) {
    const int pid = table[(size_t)s * width + p];
    const size_t head0 = ((size_t)pid * Nkv + h) * page;  // token row
    for (int c0 = 0; c0 < page; c0 += CH) {
      const int t0 = p * page + c0;  // position of the chunk's first token
      if (t0 > p_max) break;
      if (WIN && t0 + CH <= band_lo) continue;  // below every row's band
      __syncthreads();  // the previous chunk's readers are done
      load_paged_chunk<KV, D, QUANT>(kp, vp, ks, vs, head0 + c0, sK, sV,
                                     sKs, sVs);
      __syncthreads();
      st.template chunk<D, QUANT>(
          sQ, sK, sV, sKs, sVs, sS, sA, rows, [&](int r, int t) {
            const int tq = t0q + r / G;
            return tq < q_len && t0 + t <= q_start + tq &&
                   (!WIN || t0 + t > q_start + tq - window);
          });
    }
  }

  st.park(sM, sL, rows);
  __syncthreads();
  if (partials) {
    for (int r = tid; r < rows; r += NT) {
      if (!row_stored(r)) continue;
      m_out[row_off(r) / D] = sM[r];
      l_out[row_off(r) / D] = sL[r];
    }
  }
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= rows) break;
      if (!row_stored(r)) continue;
      if (partials) {
        acc_out[row_off(r) + tid] = st.acc[r];
      } else {
        const float l = sL[r];  // masked rows (l == 0) emit zeros
        store(out + row_off(r) + tid, l > 0.f ? st.acc[r] / l : 0.f);
      }
    }
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *table, *q_lens, *kv_lens, *ctx_lo;
  void *out, *acc, *m, *l;
  int S, Nkv, G, QT, page, width, window;
  float scale;
};

template <typename T, typename KV, int D, int ROWS, bool QUANT, bool WIN>
cudaError_t launch_rows_win(const Args& a, int bq, cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = smem_bytes<D, ROWS>();
  cudaError_t e =
      allow_smem(ragged_kernel<T, KV, D, ROWS, QUANT, WIN>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.QT + bq - 1) / bq, a.Nkv, a.S);
  ragged_kernel<T, KV, D, ROWS, QUANT, WIN><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.kp),
      static_cast<const KV*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.table),
      static_cast<const int*>(a.q_lens), static_cast<const int*>(a.kv_lens),
      static_cast<const int*>(a.ctx_lo), static_cast<T*>(a.out),
      static_cast<float*>(a.acc), static_cast<float*>(a.m),
      static_cast<float*>(a.l), a.Nkv, a.G, a.QT, a.page, a.width, bq,
      a.window, a.scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, typename KV, int D, int ROWS, bool QUANT>
cudaError_t launch_rows(const Args& a, int bq, cudaStream_t stream) {
  if (a.window > 0)
    return launch_rows_win<T, KV, D, ROWS, QUANT, true>(a, bq, stream);
  return launch_rows_win<T, KV, D, ROWS, QUANT, false>(a, bq, stream);
}

template <typename T, typename KV, int D, bool QUANT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // bq query tokens per block; a decode batch (QT == 1) runs G rows
  const int bq = a.QT < MAXR / a.G ? a.QT : MAXR / a.G;
  if (bq * a.G <= MAXR_DECODE)
    return launch_rows<T, KV, D, MAXR_DECODE, QUANT>(a, bq, stream);
  return launch_rows<T, KV, D, MAXR, QUANT>(a, bq, stream);
}

template <typename T, int D>
cudaError_t dispatch_pool(int kv_dtype, int dtype, const Args& a,
                          cudaStream_t stream) {
  if (kv_dtype == dtype) return launch<T, T, D, false>(a, stream);
  if (a.ks == nullptr || a.vs == nullptr) return cudaErrorInvalidValue;
  if (kv_dtype == kInt8) return launch<T, int8_t, D, true>(a, stream);
  if (kv_dtype == kFp8E4M3)
    return launch<T, __nv_fp8_e4m3, D, true>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ragged_paged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* table,
    const void* q_lens, const void* kv_lens, const void* ctx_lo, void* out,
    void* acc, void* m, void* l, int S, int Nkv, int G, int QT, int D,
    int page, int width, int window, int dtype, int kv_dtype, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAXR || page % CH != 0 || D != 128 || QT < 1)
    return (int)cudaErrorInvalidValue;
  if ((out == nullptr) == (acc == nullptr) ||
      (acc != nullptr && (m == nullptr || l == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k_pages, v_pages, k_scales, v_scales, table,
               q_lens, kv_lens, ctx_lo,  out,      acc,      m,
               l,      S,       Nkv,     G,        QT,       page,
               width,  window,  scale};
  if (dtype == kBFloat16)
    return (int)dispatch_pool<__nv_bfloat16, 128>(kv_dtype, dtype, a, st);
  if (dtype == kFloat32)
    return (int)dispatch_pool<float, 128>(kv_dtype, dtype, a, st);
  return (int)cudaErrorInvalidValue;
}
