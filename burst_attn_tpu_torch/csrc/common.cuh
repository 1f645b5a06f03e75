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
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// One wire byte (a ring payload quantized by parallel/ring.py
// wire_quantize) -> fp32: `wire` kInt8 (a signed byte) or kFp8E4M3; exact.
__device__ __forceinline__ float wire_byte(uint8_t b, int wire) {
  if (wire == kInt8) return static_cast<float>(static_cast<int8_t>(b));
  __nv_fp8_e4m3 x;
  x.__x = b;
  return static_cast<float>(x);
}

// The value a wire byte dequantizes to in the compute type T: fp32 times
// the block's scale, rounded to T, as fp32 (the plain version's
// (q.float() * scale).to(T)).
template <typename T>
__device__ __forceinline__ float wire_value(uint8_t b, float sc, int wire) {
  const float x = wire_byte(b, wire) * sc;
  if constexpr (std::is_same<T, float>::value) return x;
  return to_float(static_cast<T>(x));
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

// Set a kernel's dynamic shared memory limit once per instantiation.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

// One kernel's registers a thread, local (spill) bytes a thread, dynamic
// shared memory and resident CTAs on the card (nt threads a CTA, `smem`
// bytes, the limit set by allow_smem first): out[0..3].
template <typename K>
cudaError_t kernel_attrs(K kernel, int nt, size_t smem, int* out) {
  bool set = false;  // (a launch's own flag stays as it is)
  cudaError_t e = allow_smem(kernel, smem, &set);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  if ((e = cudaFuncGetAttributes(&a, kernel)) != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt,
                                                    smem);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm * sms;
  return cudaSuccess;
}

}  // namespace bat
