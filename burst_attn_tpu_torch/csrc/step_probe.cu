// The step-overhead probe: the cost of one kv-tile iteration beyond its
// bytes and operations.
//
// Replaces: benchmarks/step_probe.py `kernel` (l.63, `pl.pallas_call`
// l.95), the Pallas TPU kernel whose grid step j fetches one bf16
// [bkv, d] block pool[j % n_pool] and adds q[bq, d] @ block[:w]^T
// (w = min(128, bkv)) into an fp32 [bq, 128] scratch that is zeroed at
// step 0 and written at the last step.  Without the matmul, every step
// still fetches its block.
//
// Contract: q [1, bq, D] bf16, pool [n_pool, bkv, D] bf16 (D = 128), out
// [1, bq, 128] fp32 = sum_{j < steps} q @ pool[j % n_pool][:w]^T, columns
// w..127 zero (all zero without the matmul); sums [n_cta] uint32: CTA c's
// wrapping 32-bit sum of every 32-bit word it fetched.
//
// Design on the H100.  One TPU grid step becomes one iteration of each
// CTA's loop over `steps`.  bq = 2048 x D = 128 in bf16 is 512 KB, which
// does not fit in 227 KB of shared memory, so the CTAs split the q rows:
// CTA c holds rows 16c .. 16c+15 (fp32 in shared memory) and their
// [16, 128] accumulator in registers, one output column per thread.  So
// that device memory still sees one whole block per step, as on the TPU,
// the CTAs also split the block's rows for the fetch: CTA c loads rows
// c, c + n_cta, ... of pool[j % n_pool], streamed through registers in
// 16-byte words (a warp takes two 256-byte rows at a time, so a 256 KB
// block of bkv >= 1024 never has to fit in shared memory), and folds
// every 32-bit word into a wrapping 32-bit sum.  The sum keeps the
// compiler from dropping the fetch, is exact and independent of order,
// and lets the test check that every word was read.  For the product
// every CTA also reads pool[j % n_pool][:w] (32 KB, from L2 after the
// first CTA) into shared memory as fp32, between two barriers, as kernel
// 1's kv loop does with each K tile; the products run on the CUDA cores
// in fp32, as kernels 1, 8 and 9 do.  Each step's product is summed apart
// and added to the accumulator once, as the TPU kernel adds one MXU
// product a step to its scratch: over 8192 steps the accumulator then
// takes 8192 roundings, not 32 per step.
//
// What bounds it: with the matmul, the fp32 products (4.2 MFLOP per step
// per CTA on CUDA cores, far below the tensor-core peak the bound assumes);
// without it, the fetch's bytes.  The probe exists to measure what the
// bound leaves out: t_step = t_fixed + bytes/bw + flops/rate, fitted over
// bkv and steps by bench/step_probe.py.

#include "common.cuh"

namespace {

using namespace bat;

constexpr int D = 128;      // head dim
constexpr int W = 128;      // output columns
constexpr int RQ = 16;      // q rows per CTA
constexpr int NT = 128;     // threads: one output column each
constexpr int LDK = D + 4;  // padded: conflict-free float4 row reads
constexpr int kWordsPerRow16 = D * 2 / 16;  // 16-byte words per block row

constexpr size_t smem_bytes() {
  return sizeof(float) * (RQ * D + W * LDK);  // sQ + sK
}

template <bool MM>
__global__ void __launch_bounds__(NT)
step_probe_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ pool,
                  float* __restrict__ out, unsigned* __restrict__ sums,
                  int bq, int bkv, int n_pool, int steps) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + RQ * D;
  __shared__ unsigned s_sum;

  const int c = blockIdx.x, n_cta = gridDim.x, tid = threadIdx.x;
  const int r0 = c * RQ;
  const int w = min(W, bkv);
  // this CTA's share of every block: rows c, c + n_cta, ...
  const int my_rows = c < bkv ? (bkv - c + n_cta - 1) / n_cta : 0;
  const size_t blk = (size_t)bkv * D;

  if (tid == 0) s_sum = 0u;
  if constexpr (MM) load_rows<__nv_bfloat16, D, RQ, NT>(q, r0, bq, sQ, D, 1.f);
  float acc[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) acc[r] = 0.f;
  unsigned sum = 0u;

  for (int j = 0; j < steps; ++j) {
    const __nv_bfloat16* kb = pool + (size_t)(j % n_pool) * blk;
    const uint4* rows = reinterpret_cast<const uint4*>(kb);
    for (int i = tid; i < my_rows * kWordsPerRow16; i += NT) {
      const int row = c + (i / kWordsPerRow16) * n_cta;
      const uint4 u = rows[(size_t)row * kWordsPerRow16 + i % kWordsPerRow16];
      sum += u.x + u.y + u.z + u.w;
    }
    if constexpr (MM) {
      __syncthreads();  // the previous step's readers of sK are done
      load_rows<__nv_bfloat16, D, W, NT>(kb, 0, w, sK, LDK, 1.f);
      __syncthreads();
      if (tid < w) {
        float part[RQ];  // this step's product, added to acc once
#pragma unroll
        for (int r = 0; r < RQ; ++r) part[r] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
          const float4 kk =
              *reinterpret_cast<const float4*>(sK + tid * LDK + d);
#pragma unroll
          for (int r = 0; r < RQ; ++r)
            part[r] += dot4(*reinterpret_cast<const float4*>(sQ + r * D + d),
                            kk);
        }
#pragma unroll
        for (int r = 0; r < RQ; ++r) acc[r] += part[r];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r)
    if (r0 + r < bq) out[(size_t)(r0 + r) * W + tid] = acc[r];

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  __syncthreads();  // s_sum's zero is visible
  if (tid % 32 == 0) atomicAdd(&s_sum, sum);
  __syncthreads();
  if (tid == 0) sums[c] = s_sum;
}

template <bool MM>
cudaError_t launch(const void* q, const void* pool, void* out, void* sums,
                   int bq, int bkv, int n_pool, int steps, int n_cta,
                   cudaStream_t stream) {
  static bool smem_set = false;
  cudaError_t e = allow_smem(step_probe_kernel<MM>, smem_bytes(), &smem_set);
  if (e != cudaSuccess) return e;
  step_probe_kernel<MM><<<n_cta, NT, smem_bytes(), stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(pool), static_cast<float*>(out),
      static_cast<unsigned*>(sums), bq, bkv, n_pool, steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int step_probe_launch(const void* q, const void* pool, void* out,
                                 void* sums, int bq, int bkv, int d,
                                 int n_pool, int steps, int matmul, int n_cta,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d != D || bq < 1 || bkv < 1 || n_pool < 1 || steps < 1 ||
      n_cta != (bq + RQ - 1) / RQ)
    return (int)cudaErrorInvalidValue;
  if (matmul)
    return (int)launch<true>(q, pool, out, sums, bq, bkv, n_pool, steps,
                             n_cta, st);
  return (int)launch<false>(q, pool, out, sums, bq, bkv, n_pool, steps, n_cta,
                            st);
}
