// Paged decode attention: one new query token per sequence against its own
// pages of a shared K/V pool.
//
// Replaces: burst_attn_tpu/ops/paged_attention.py `_decode_kernel` (via
// `paged_decode_attention`), the Pallas TPU kernel whose grid walks
// (batch, kv-head, page-slot) with the page table delivered by scalar
// prefetch.  Full-precision pools only (no int8/fp8 scales, no window).
//
// Contract: q [B,Nkv,G,D] (the G query heads of each kv head folded
// together), k/v pages [P,Nkv,page,D], page_table [B,width] int32, lengths
// [B] int32 (0 = empty slot -> zeros).  Output [B,Nkv,G,D] in q's dtype.
//
// What bounds it on an H100: device-memory bytes — each live token's K and
// V rows are read once (at 8 slots x 2048 tokens x 4 kv heads x 128 x bf16,
// ~34 MB per layer, ~10 us at 3.35 TB/s); the FLOPs (4 per byte) are
// nothing.  What the design does about it: one CTA per (slot, kv head)
// reads its own page ids from the table (no scalar prefetch on Hopper) and
// loops over only ceil(len/page) live pages, so cost follows the live
// length, not the table width; every K/V byte is read exactly once, with
// 16-byte coalesced loads of 64-token chunks (a page's tokens are
// contiguous for one head); the G query rows of the group share each
// loaded chunk, so GQA costs no extra traffic.  Softmax is online in fp32,
// base 2 (q pre-scaled by scale*log2e).  Not yet done: a split-k over pages
// (B*Nkv CTAs underfill 132 SMs at small batch) and load/compute overlap —
// later work.

#include "common.cuh"

namespace {

using namespace bat;

constexpr int CH = 64;     // tokens per shared-memory chunk
constexpr int NT = 128;    // threads per CTA
constexpr int MAXG = 16;   // query rows per kv head
constexpr int NW = NT / 32;

template <int D>
constexpr size_t smem_bytes() {
  // sQ [MAXG][D] + sK [CH][D+4] + sV [CH][D] + sS [MAXG][CH] + sA + sL
  return sizeof(float) *
         (MAXG * D + CH * (D + 4) + CH * D + MAXG * CH + 2 * MAXG);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int Nkv, int G, int page, int width, float scale_log2) {
  constexpr int LDK = D + 4;  // padded: conflict-free float4 row reads
  static_assert(D <= NT, "one output column per thread");
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + MAXG * D;
  float* sV = sK + CH * LDK;
  float* sS = sV + CH * D;   // scores, then probabilities, [G][CH]
  float* sA = sS + MAXG * CH;  // per-row rescale of the current chunk
  float* sL = sA + MAXG;       // per-row final sums

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qoff = ((size_t)b * Nkv + h) * G * D;
  for (int i = tid; i < G * D; i += NT)
    sQ[i] = to_float(q[qoff + i]) * scale_log2;

  const int len = lengths[b];
  const int n_live = len > 0 ? min((len + page - 1) / page, width) : 0;

  // online-softmax state: warp w owns rows w, w + NW, ...
  float m_r[MAXG / NW], l_r[MAXG / NW];
#pragma unroll
  for (int r = 0; r < MAXG / NW; ++r) {
    m_r[r] = neg_inf();
    l_r[r] = 0.f;
  }
  float acc[MAXG];  // output column d = tid of every row
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  for (int p = 0; p < n_live; ++p) {
    const int pid = table[(size_t)b * width + p];
    const size_t base = ((size_t)pid * Nkv + h) * page * D;
    for (int c0 = 0; c0 < page; c0 += CH) {
      const int t0 = p * page + c0;  // position of the chunk's first token
      if (t0 >= len) break;
      __syncthreads();  // the previous chunk's readers are done
      load_rows<T, D, CH, NT>(kp + base + (size_t)c0 * D, 0, CH, sK, LDK,
                              1.f);
      load_rows<T, D, CH, NT>(vp + base + (size_t)c0 * D, 0, CH, sV, D, 1.f);
      __syncthreads();

      {  // scores: thread (t, g0) computes rows g0, g0 + NT/CH, ...
        const int t = tid % CH;
        for (int g = tid / CH; g < G; g += NT / CH) {
          float s = 0.f;
#pragma unroll 8
          for (int d = 0; d < D; d += 4)
            s += dot4(*reinterpret_cast<const float4*>(sQ + g * D + d),
                      *reinterpret_cast<const float4*>(sK + t * LDK + d));
          sS[g * CH + t] = (t0 + t < len) ? s : neg_inf();
        }
      }
      __syncthreads();

#pragma unroll
      for (int r = 0; r < MAXG / NW; ++r) {
        const int g = warp + NW * r;
        if (g >= G) break;  // warp-uniform
        const float s0 = sS[g * CH + lane], s1 = sS[g * CH + lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_r[r], mx);
        const float alpha = (m_r[r] >= m_new) ? 1.f : exp2f(m_r[r] - m_new);
        const float p0 = (s0 == neg_inf()) ? 0.f : exp2f(s0 - m_new);
        const float p1 = (s1 == neg_inf()) ? 0.f : exp2f(s1 - m_new);
        float sum = p0 + p1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        m_r[r] = m_new;
        l_r[r] = l_r[r] * alpha + sum;
        sS[g * CH + lane] = p0;
        sS[g * CH + lane + 32] = p1;
        if (lane == 0) sA[g] = alpha;
      }
      __syncthreads();

      if (tid < D) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g] *= sA[g];
#pragma unroll 4
        for (int j = 0; j < CH; ++j) {
          const float vv = sV[j * D + tid];
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) acc[g] += sS[g * CH + j] * vv;
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MAXG / NW; ++r) {
      const int g = warp + NW * r;
      if (g < G) sL[g] = l_r[r];
    }
  }
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float lg = sL[g];  // empty sequences (l == 0) emit zeros
      store(out + qoff + (size_t)g * D + tid, lg > 0.f ? acc[g] / lg : 0.f);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* lengths, void* out, int B,
                   int Nkv, int G, int page, int width, float scale,
                   cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = allow_smem(paged_decode_kernel<T, D>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(Nkv, B);
  paged_decode_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), Nkv, G, page,
      width, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(int dtype, const void* q, const void* kp,
                           const void* vp, const void* table,
                           const void* lengths, void* out, int B, int Nkv,
                           int G, int page, int width, float scale,
                           cudaStream_t stream) {
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, D>(q, kp, vp, table, lengths, out, B, Nkv,
                                    G, page, width, scale, stream);
  if (dtype == kFloat32)
    return launch<float, D>(q, kp, vp, table, lengths, out, B, Nkv, G, page,
                            width, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* table,
                                   const void* lengths, void* out, int B,
                                   int Nkv, int G, int D, int page, int width,
                                   int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAXG || page % CH != 0) return (int)cudaErrorInvalidValue;
  if (D == 128)
    return (int)dispatch_dtype<128>(dtype, q, k_pages, v_pages, table,
                                    lengths, out, B, Nkv, G, page, width,
                                    scale, st);
  return (int)cudaErrorInvalidValue;
}
