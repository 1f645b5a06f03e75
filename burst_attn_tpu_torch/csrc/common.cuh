// Helpers shared by the port's CUDA kernels (included, not built alone).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace bat {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dtype codes shared with the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kInt8 = 2;     // quantized pools: 1 B/elem + fp32 scales
constexpr int kFp8E4M3 = 3;

__device__ __forceinline__ float neg_inf() { return -CUDART_INF_F; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 8 consecutive elements, 16-byte aligned -> fp32
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
// 1-byte pool values convert exactly to fp32 (the scales are applied to
// the scores and probabilities, not here)
__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(b[i]);
}
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* o) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const __nv_fp8_e4m3* b = reinterpret_cast<const __nv_fp8_e4m3*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(b[i]);
}

// Copy rows [r0, r0 + ROWS) of a row-major [S, D] matrix into shared memory
// as fp32 with row stride `ld` (a multiple of 4), times `mul`.  Rows at or
// past S are zero-filled.  All NT threads of the block take part.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int r0,
                                          int S, float* dst, int ld,
                                          float mul) {
  constexpr int kChunks = D / 8;  // 8-element chunks per row
#pragma unroll 4
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NT) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    float v[8];
    if (r0 + r < S) {
      load8(src + (size_t)(r0 + r) * D + col, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * ld + col);
    d[0] = make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
    d[1] = make_float4(v[4] * mul, v[5] * mul, v[6] * mul, v[7] * mul);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// ---------------------------------------------------------------------------
// The paged kernels' shared online-softmax update (paged_decode.cu and
// ragged_paged.cu).  A decode row of the ragged kernel is bit-identical to
// the decode kernel's row because both run THIS code on the same 64-token
// chunks in the same order: the same fmaf chain for each score, the same
// shuffle trees for the row max and sum, the same alpha rule and the same
// fmaf per output column.  Per-row arithmetic does not depend on how many
// rows a block holds (MAXR), so the row count is a template parameter.

constexpr int kPagedChunk = 64;   // tokens per shared-memory chunk
constexpr int kPagedThreads = 128;

__device__ __forceinline__ float dot4_fma(float s, float4 a, float4 b) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Online-softmax state of one block's rows: warp w owns rows w, w + NW, ...
// (m and l replicated across its lanes); thread d < D owns output column d
// of every row.
template <int MAXR>
struct PagedRows {
  static constexpr int NW = kPagedThreads / 32;
  float m[MAXR / NW], l[MAXR / NW];
  float acc[MAXR];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < MAXR / NW; ++i) {
      m[i] = neg_inf();
      l[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  }

  // One chunk: scores of `rows` query rows (sQ [rows][D], pre-scaled by
  // scale*log2e) against the chunk's keys (sK [CH][D+4]), masked by
  // valid(row, token), then the base-2 online softmax and P.V into acc.
  // Quantized pools pass their per-token scales (sKs, sVs [CH]): the
  // dequantization is a column rescale of the scores and of p, as in the
  // TPU kernels.  sS [MAXR][CH] and sA [MAXR] are scratch.  All threads
  // of the block call it; it synchronises internally and on return the
  // chunk's shared buffers may be refilled after one __syncthreads().
  template <int D, bool QUANT, typename Valid>
  __device__ __forceinline__ void chunk(const float* __restrict__ sQ,
                                        const float* __restrict__ sK,
                                        const float* __restrict__ sV,
                                        const float* __restrict__ sKs,
                                        const float* __restrict__ sVs,
                                        float* __restrict__ sS,
                                        float* __restrict__ sA, int rows,
                                        Valid valid) {
    constexpr int CH = kPagedChunk, NT = kPagedThreads, LDK = D + 4;
    static_assert(CH == 64, "two scores per lane in the row reductions");
    static_assert(D <= NT, "one output column per thread");
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    {  // scores: thread (t, r0) computes rows r0, r0 + NT/CH, ...
      const int t = tid % CH;
      for (int r = tid / CH; r < rows; r += NT / CH) {
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; d += 4)
          s = dot4_fma(s, *reinterpret_cast<const float4*>(sQ + r * D + d),
                       *reinterpret_cast<const float4*>(sK + t * LDK + d));
        if constexpr (QUANT) s *= sKs[t];
        sS[r * CH + t] = valid(r, t) ? s : neg_inf();
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXR / NW; ++i) {
      const int r = warp + NW * i;
      if (r >= rows) break;  // warp-uniform
      const float s0 = sS[r * CH + lane], s1 = sS[r * CH + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = (m[i] >= m_new) ? 1.f : exp2f(m[i] - m_new);
      const float p0 = (s0 == neg_inf()) ? 0.f : exp2f(s0 - m_new);
      const float p1 = (s1 == neg_inf()) ? 0.f : exp2f(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      m[i] = m_new;
      l[i] = fmaf(l[i], alpha, sum);
      sS[r * CH + lane] = QUANT ? p0 * sVs[lane] : p0;
      sS[r * CH + lane + 32] = QUANT ? p1 * sVs[lane + 32] : p1;
      if (lane == 0) sA[r] = alpha;
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < rows) acc[r] *= sA[r];
#pragma unroll 4
      for (int j = 0; j < CH; ++j) {
        const float vv = sV[j * D + tid];
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (r < rows) acc[r] = fmaf(sS[r * CH + j], vv, acc[r]);
      }
    }
  }

  // Park each row's (m, l) in shared memory for the epilogue (call, then
  // __syncthreads(), then read sM/sL[row]).
  __device__ __forceinline__ void park(float* sM, float* sL, int rows) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane != 0) return;
#pragma unroll
    for (int i = 0; i < MAXR / NW; ++i) {
      const int r = warp + NW * i;
      if (r < rows) {
        sM[r] = m[i];
        sL[r] = l[i];
      }
    }
  }
};

// Load one chunk of a page (CH tokens of one kv head: rows row0.. of the
// pool seen as [P*Nkv*page, D]) into sK/sV as fp32, and the chunk's scales
// (ks/vs seen as [P*Nkv*page]) for quantized pools.
template <typename KV, int D, bool QUANT>
__device__ __forceinline__ void load_paged_chunk(
    const KV* __restrict__ kp, const KV* __restrict__ vp,
    const float* __restrict__ ks, const float* __restrict__ vs, size_t row0,
    float* sK, float* sV, float* sKs, float* sVs) {
  constexpr int CH = kPagedChunk, NT = kPagedThreads;
  load_rows<KV, D, CH, NT>(kp + row0 * D, 0, CH, sK, D + 4, 1.f);
  load_rows<KV, D, CH, NT>(vp + row0 * D, 0, CH, sV, D, 1.f);
  if constexpr (QUANT) {
    if (threadIdx.x < CH) {
      sKs[threadIdx.x] = ks[row0 + threadIdx.x];
      sVs[threadIdx.x] = vs[row0 + threadIdx.x];
    }
  }
}

// Set a kernel's dynamic shared memory limit once per instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

}  // namespace bat
