// Paged decode attention: one new query token per sequence against its own
// pages of a shared K/V pool.
//
// Replaces: burst_attn_tpu/ops/paged_attention.py `_decode_kernel` (via
// `paged_decode_attention`), the Pallas TPU kernel whose grid walks
// (batch, kv-head, page-slot) with the page table delivered by scalar
// prefetch.  Full-precision pools, and int8 / fp8 e4m3 pools with per-token
// fp32 scales; the sliding window.
//
// Contract: q [B,Nkv,G,D] (the G query heads of each kv head folded
// together), k/v pages [P,Nkv,page,D] in q's dtype or 1 B/elem with scales
// [P,Nkv,page] fp32, page_table [B,width] int32, lengths [B] int32 (0 =
// empty slot -> zeros), window (<= 0: none; else the new token sees the
// positions at or above lo = max(len - window, 0)).  Output [B,Nkv,G,D] in
// q's dtype.
//
// What bounds it on an H100: device-memory bytes — each live token's K and
// V rows are read once (at 8 slots x 2048 tokens x 4 kv heads x 128 x bf16,
// ~34 MB per layer, ~10 us at 3.35 TB/s); the FLOPs (4 per byte) are
// nothing.  What the design does about it: one CTA per (slot, kv head)
// reads its own page ids from the table (no scalar prefetch on Hopper) and
// loops over only the live pages (with a window, from the page holding lo,
// skipping the 64-token chunks wholly below lo), so cost follows the live
// length or the window, not the table width; every K/V byte is read
// exactly once, with
// coalesced 8-element loads of 64-token chunks (a page's tokens are
// contiguous for one head); the G query rows of the group share each
// loaded chunk, so GQA costs no extra traffic, and a 1-byte pool halves
// (bf16) or quarters (fp32) it.  Softmax is online in fp32, base 2 (q
// pre-scaled by scale*log2e), through the update it shares with the ragged
// kernel (common.cuh PagedRows), so a ragged decode row is bit-identical to
// this kernel's.  Not yet done: a split-k over pages (B*Nkv CTAs underfill
// 132 SMs at small batch) and load/compute overlap — later work.

#include "common.cuh"

namespace {

using namespace bat;

constexpr int CH = kPagedChunk;
constexpr int NT = kPagedThreads;
constexpr int MAXG = 16;   // query rows per kv head

template <int D>
constexpr size_t smem_bytes() {
  // sQ [MAXG][D] + sK [CH][D+4] + sV [CH][D] + sS [MAXG][CH] + sA, sM, sL
  // + sKs, sVs
  return sizeof(float) * (MAXG * D + CH * (D + 4) + CH * D + MAXG * CH +
                          3 * MAXG + 2 * CH);
}

template <typename T, typename KV, int D, bool QUANT, bool WIN>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int Nkv, int G, int page, int width, int window,
                    float scale_log2) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + MAXG * D;
  float* sV = sK + CH * (D + 4);
  float* sS = sV + CH * D;     // scores, then probabilities, [G][CH]
  float* sA = sS + MAXG * CH;  // per-row rescale of the current chunk
  float* sM = sA + MAXG;
  float* sL = sM + MAXG;       // per-row final sums
  float* sKs = sL + MAXG;      // the chunk's scales (quantized pools)
  float* sVs = sKs + CH;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t qoff = ((size_t)b * Nkv + h) * G * D;
  for (int i = tid; i < G * D; i += NT)
    sQ[i] = to_float(q[qoff + i]) * scale_log2;

  const int len = lengths[b];
  const int n_live = len > 0 ? min((len + page - 1) / page, width) : 0;
  // the band's start; WIN is a template flag so that the unwindowed
  // instance compiles to the same code as before the band existed
  const int lo = WIN ? max(len - window, 0) : 0;

  PagedRows<MAXG> st;
  st.init();
  for (int p = WIN ? lo / page : 0; p < n_live; ++p) {
    const int pid = table[(size_t)b * width + p];
    const size_t head0 = ((size_t)pid * Nkv + h) * page;  // token row
    for (int c0 = 0; c0 < page; c0 += CH) {
      const int t0 = p * page + c0;  // position of the chunk's first token
      if (t0 >= len) break;
      if (WIN && t0 + CH <= lo) continue;  // wholly below the window
      __syncthreads();  // the previous chunk's readers are done
      load_paged_chunk<KV, D, QUANT>(kp, vp, ks, vs, head0 + c0, sK, sV,
                                     sKs, sVs);
      __syncthreads();
      st.template chunk<D, QUANT>(
          sQ, sK, sV, sKs, sVs, sS, sA, G,
          [&](int, int t) {
            return t0 + t < len && (!WIN || t0 + t >= lo);
          });
    }
  }

  st.park(sM, sL, G);
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float lg = sL[g];  // empty sequences (l == 0) emit zeros
      store(out + qoff + (size_t)g * D + tid,
            lg > 0.f ? st.acc[g] / lg : 0.f);
    }
  }
}

template <typename T, typename KV, int D, bool QUANT, bool WIN>
cudaError_t launch_win(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* lengths, void* out, int B, int Nkv, int G,
                   int page, int width, int window, float scale,
                   cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = smem_bytes<D>();
  cudaError_t e =
      allow_smem(paged_decode_kernel<T, KV, D, QUANT, WIN>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(Nkv, B);
  paged_decode_kernel<T, KV, D, QUANT, WIN><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), Nkv, G, page,
      width, window, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, typename KV, int D, bool QUANT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* lengths, void* out, int B, int Nkv, int G,
                   int page, int width, int window, float scale,
                   cudaStream_t stream) {
  if (window > 0)
    return launch_win<T, KV, D, QUANT, true>(q, kp, vp, ks, vs, table,
                                             lengths, out, B, Nkv, G, page,
                                             width, window, scale, stream);
  return launch_win<T, KV, D, QUANT, false>(q, kp, vp, ks, vs, table,
                                            lengths, out, B, Nkv, G, page,
                                            width, window, scale, stream);
}

template <typename T, int D>
cudaError_t dispatch_pool(int kv_dtype, int dtype, const void* q,
                          const void* kp, const void* vp, const void* ks,
                          const void* vs, const void* table,
                          const void* lengths, void* out, int B, int Nkv,
                          int G, int page, int width, int window, float scale,
                          cudaStream_t stream) {
  if (kv_dtype == dtype)
    return launch<T, T, D, false>(q, kp, vp, ks, vs, table, lengths, out, B,
                                  Nkv, G, page, width, window, scale, stream);
  if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
  if (kv_dtype == kInt8)
    return launch<T, int8_t, D, true>(q, kp, vp, ks, vs, table, lengths,
                                      out, B, Nkv, G, page, width, window,
                                      scale, stream);
  if (kv_dtype == kFp8E4M3)
    return launch<T, __nv_fp8_e4m3, D, true>(q, kp, vp, ks, vs, table,
                                             lengths, out, B, Nkv, G, page,
                                             width, window, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scales,
                                   const void* v_scales, const void* table,
                                   const void* lengths, void* out, int B,
                                   int Nkv, int G, int D, int page, int width,
                                   int window, int dtype, int kv_dtype,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAXG || page % CH != 0 || D != 128)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return (int)dispatch_pool<__nv_bfloat16, 128>(
        kv_dtype, dtype, q, k_pages, v_pages, k_scales, v_scales, table,
        lengths, out, B, Nkv, G, page, width, window, scale, st);
  if (dtype == kFloat32)
    return (int)dispatch_pool<float, 128>(
        kv_dtype, dtype, q, k_pages, v_pages, k_scales, v_scales, table,
        lengths, out, B, Nkv, G, page, width, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
