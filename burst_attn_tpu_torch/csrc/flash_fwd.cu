// Flash-attention forward: one online-softmax round with carry-in state.
//
// Replaces: burst_attn_tpu/ops/pallas_flash.py `_fwd_kernel` (via
// `flash_fwd`), the Pallas TPU kernel that folds one K/V block into a
// carry-in (m, lse, acc) over a (batch, head, q-block, kv-block) grid.
//
// Contract (same as ops/tile.py:tile_fwd): q [B,N,Sq,D], k/v [B,Nk,Skv,D]
// (GQA: query head h reads kv head h / (N/Nk)), optional carry m/lse [B,N,Sq]
// f32 + acc [B,N,Sq,D] f32 (all null = statically empty carry).  Outputs m
// and lse in the natural-log domain and either the raw f32 accumulator or,
// with EMIT, the normalized output o = acc / l in q's dtype.  The five mask
// scalars (q_lo, q_hi, kv_hi, causal, offset) and the sliding window
// (window <= 0: none; else row r sees columns above r + offset - window)
// arrive by value.  With SEG (a template flag, as WIN; null id pointers
// take the instances without it) q_ids [B,Sq] and kv_ids [B,Skv] int32
// pack documents into a row: row r sees column c only where their ids
// are equal (burst_attn_tpu/ops/pallas_flash.py `_block_mask`'s segment
// test).  The SEG instances compute every chunk the mask scalars leave
// and mask by id; skipping chunks that share no document is later work.
//
// What bounds it on an H100: tensor FLOPs — causal prefill at S=2048,
// N=16, D=128 is ~17 GFLOP per call against ~8 MB of traffic, far above the
// card's ~295 FLOP/byte ridge.  One CTA per (b, h, 64-row q tile) keeps
// Q resident in shared memory and streams 64-row K/V tiles, so device
// memory is read ~once per q tile; the kv loop stops at the causal
// diagonal (and at kv_hi), and with a window starts at the band's first
// tile, so dead tiles cost nothing — the CUDA counterpart of the TPU
// kernel's triangular and band grids: a windowed prefill costs
// O(S * window), not O(S^2).  Ragged lengths are masked in-kernel (no
// padding to a tile multiple).  Two instances by q's dtype:
//  * bf16 (the serving prefill, the train step, every scan-ring round):
//    the tensor cores, as kernel 8's bf16 instance runs them —
//    mma_tile.cuh's WarpTile, four warps x 16 q rows on mma.sync
//    m16n8k16 (S = Q K^T, O += P V with P as two bf16 terms, fp32
//    accumulators), the Q tile in shared memory as bf16, 64-token K/V
//    chunks in two stages by cp.async.cg (mma_fold, shared with kernel 8;
//    the window band is its WIN template flag), ~87 KB of shared memory,
//    two CTAs an SM.  It issues 6 * D flops an attended pair (P V twice)
//    on mma.sync, below wgmma's rate; a TMA producer warp feeding wgmma is
//    the next step.
//  * fp32: the first version's SIMT tile (flash_tile.cuh, fp32 on the
//    CUDA cores, no tensor cores), exact to the plain version's fp32 math
//    up to summation order; the fp32 parity checks rest on it.
//
// Softmax runs in base 2 (scores times scale*log2e, exp2f), like the TPU
// kernel; m and lse are converted back to natural log at the end.  The
// carry-in arrives in natural log and converts on the way in: m -> m *
// log2e, l = exp(lse - m) (0 where m = -inf).

#include "flash_tile.cuh"
#include "mma_tile.cuh"

namespace {

using namespace bat;
using flash::BQ;
using flash::NT;
using flash::RPT;

template <typename T, bool EMIT, int D, bool WIN, bool SEG>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ m_in,
                 const float* __restrict__ lse_in,
                 const float* __restrict__ acc_in, float* __restrict__ m_out,
                 float* __restrict__ lse_out, void* __restrict__ out_raw,
                 const int* __restrict__ q_ids,
                 const int* __restrict__ kv_ids, int N, int Nk, int Sq,
                 int Skv, float scale_log2, int q_lo, int q_hi, int kv_hi,
                 int causal, int offset, int window) {
  constexpr int DC = flash::Rows<D>::DC;
  using OutT = typename std::conditional<EMIT, T, float>::type;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * D;
  float* sV = sK + flash::BKV * (D + 4);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)b * N + h;
  const size_t bhk = (size_t)b * Nk + h / (N / Nk);
  const T* qb = q + bh * Sq * D;

  load_rows<T, D, BQ, NT>(qb, q0, Sq, sQ, D, scale_log2);

  flash::Rows<D> st;
  st.init();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (acc_in != nullptr && row < Sq) {
      const float mi = m_in[bh * Sq + row];
      st.m[i] = mi * kLog2e;  // base-2 domain
      st.l[i] = (mi == neg_inf()) ? 0.f : expf(lse_in[bh * Sq + row] - mi);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(
            acc_in + (bh * Sq + row) * D + c * 64 + tx * 4);
        st.acc[i][4 * c] = a.x; st.acc[i][4 * c + 1] = a.y;
        st.acc[i][4 * c + 2] = a.z; st.acc[i][4 * c + 3] = a.w;
      }
    }
  }

  flash::fold<T, D, false, WIN, SEG>(
      st, sQ, sK, sV, k + bhk * Skv * D, v + bhk * Skv * D, Skv, q0, Sq,
      q_lo, q_hi, kv_hi, causal, offset, window,
      SEG ? q_ids + (size_t)b * Sq : nullptr,
      SEG ? kv_ids + (size_t)b * Skv : nullptr);

  OutT* out = reinterpret_cast<OutT*>(out_raw);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= Sq) continue;
    const float mn = st.m[i] * kLn2;  // back to the natural-log domain
    if (tx == 0) {
      m_out[bh * Sq + row] = mn;
      lse_out[bh * Sq + row] =
          (st.l[i] > 0.f) ? mn + logf(st.l[i]) : neg_inf();
    }
    // EMIT: fused finalize o = acc / l (empty rows give 0, not NaN)
    const float inv = EMIT ? ((st.l[i] > 0.f) ? 1.f / st.l[i] : 0.f) : 1.f;
    OutT* o = out + (bh * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(o + c * 64 + tx * 4 + e, st.acc[i][4 * c + e] * inv);
  }
}

// The bf16 instance on the tensor cores: warp w holds q rows q0 + 16 w ..
// (lane (g, c) rows g and g + 8, O columns 8n + 2c, 2c + 1; WarpTile).
// Shared memory: the Q tile, two stages of K and V; SEG adds the stages'
// kv ids (2 x 64 int32).
constexpr size_t kMmaSmem = sizeof(__nv_bfloat16) * 5 * 64 * kTileLd;
constexpr size_t kSegSmem = sizeof(int) * 2 * kTileChunk;

template <bool EMIT, bool WIN, bool SEG>
__global__ void __launch_bounds__(NT)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ m_in,
                     const float* __restrict__ lse_in,
                     const float* __restrict__ acc_in,
                     float* __restrict__ m_out, float* __restrict__ lse_out,
                     void* __restrict__ out_raw,
                     const int* __restrict__ q_ids,
                     const int* __restrict__ kv_ids, int N, int Nk, int Sq,
                     int Skv, float scale_log2, int q_lo, int q_hi,
                     int kv_hi, int causal, int offset, int window) {
  constexpr int D = kTileD;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sKV = sQ + BQ * kTileLd;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y;
  // the longest q tiles first: a causal tile's chunks grow with its index,
  // and the last CTAs to start were the longest ones (0.1916 -> 0.1671 ms
  // at B1 N16/4 S2048, 2.068 -> 1.750 at B1 N16 S8192, causal;
  // tools/kernel_ab.py, NVIDIA H100 80GB HBM3, 700.00 W)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t bh = (size_t)b * N + h;
  const size_t bhk = (size_t)b * Nk + h / (N / Nk);

  cp_tile<BQ, NT>(sQ, q + (bh * Sq + q0) * D, min(BQ, Sq - q0));
  WarpTile wt;
  wt.init();
  if (acc_in != nullptr) {  // the carry, into the base-2 domain
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qr = q0 + 16 * w + g + 8 * hf;
      if (qr >= Sq) continue;
      const size_t at = bh * Sq + qr;
      const float mi = m_in[at];
      wt.m[hf] = mi * kLog2e;
      // the quad's sum is kept by lane c = 0 (finish() adds the quad)
      wt.l[hf] = (c == 0 && mi != neg_inf()) ? expf(lse_in[at] - mi) : 0.f;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float2 a =
            *reinterpret_cast<const float2*>(acc_in + at * D + 8 * n + 2 * c);
        wt.o[n][2 * hf] = a.x;
        wt.o[n][2 * hf + 1] = a.y;
      }
    }
  }
  if constexpr (SEG)
    mma_fold<WIN, true>(wt, sQ, sKV, k + bhk * Skv * D, v + bhk * Skv * D,
                        Sq, Skv, q0, scale_log2, q_lo, q_hi, kv_hi, causal,
                        offset, window, q_ids + (size_t)b * Sq,
                        kv_ids + (size_t)b * Skv,
                        reinterpret_cast<int*>(sKV + 4 * 64 * kTileLd));
  else
    mma_fold<WIN>(wt, sQ, sKV, k + bhk * Skv * D, v + bhk * Skv * D, Sq,
                  Skv, q0, scale_log2, q_lo, q_hi, kv_hi, causal, offset,
                  window);
  wt.finish();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qr = q0 + 16 * w + g + 8 * hf;
    if (qr >= Sq) continue;
    const size_t at = bh * Sq + qr;
    const float l = wt.l[hf];
    const float mn = wt.m[hf] * kLn2;  // back to the natural-log domain
    if (c == 0) {
      m_out[at] = mn;
      lse_out[at] = (l > 0.f) ? mn + logf(l) : neg_inf();
    }
    if constexpr (EMIT) {  // o = acc / l (empty rows give 0, not NaN)
      const float inv = (l > 0.f) ? 1.f / l : 0.f;
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out_raw) + at * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(o + 8 * n + 2 * c) =
            pack_bf16(wt.o[n][2 * hf] * inv, wt.o[n][2 * hf + 1] * inv);
    } else {
      float* o = static_cast<float*>(out_raw) + at * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(o + 8 * n + 2 * c) =
            make_float2(wt.o[n][2 * hf], wt.o[n][2 * hf + 1]);
    }
  }
}

// bf16 on the tensor cores, fp32 on the SIMT tile
template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

template <typename T, bool EMIT, int D, bool WIN, bool SEG>
auto kernel_of() {
  if constexpr (kMma<T>)
    return flash_fwd_mma_kernel<EMIT, WIN, SEG>;
  else
    return flash_fwd_kernel<T, EMIT, D, WIN, SEG>;
}

template <typename T, int D, bool SEG>
constexpr size_t smem_of() {
  return kMma<T> ? kMmaSmem + (SEG ? kSegSmem : 0) : flash::smem_bytes<D>();
}

template <typename T, bool EMIT, int D, bool WIN, bool SEG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* m_in, const void* lse_in, const void* acc_in,
                   void* m_out, void* lse_out, void* out, const int* q_ids,
                   const int* kv_ids, int B, int N, int Nk, int Sq, int Skv,
                   float scale, int q_lo, int q_hi, int kv_hi, int causal,
                   int offset, int window, cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = smem_of<T, D, SEG>();
  const auto kernel = kernel_of<T, EMIT, D, WIN, SEG>();
  cudaError_t e = allow_smem(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, N, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(m_in),
      static_cast<const float*>(lse_in), static_cast<const float*>(acc_in),
      static_cast<float*>(m_out), static_cast<float*>(lse_out), out, q_ids,
      kv_ids, N, Nk, Sq, Skv, scale * kLog2e, q_lo, q_hi, kv_hi, causal,
      offset, window);
  return cudaGetLastError();
}

// The attributes (common.cuh kernel_attrs) of one instance
template <typename T, bool EMIT, bool WIN, bool SEG>
cudaError_t attrs(int* out) {
  return kernel_attrs(kernel_of<T, EMIT, 128, WIN, SEG>(), NT,
                      smem_of<T, 128, SEG>(), out);
}

template <typename T, bool SEG>
cudaError_t attrs_emit(int flag, int* out) {
  switch (flag & 3) {  // bit 0: emit_o, bit 1: a window
    case 0: return attrs<T, false, false, SEG>(out);
    case 1: return attrs<T, true, false, SEG>(out);
    case 2: return attrs<T, false, true, SEG>(out);
    case 3: return attrs<T, true, true, SEG>(out);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t attrs_of(int flag, int* out) {  // bit 2: segments
  return (flag & 4) ? attrs_emit<T, true>(flag, out)
                    : attrs_emit<T, false>(flag, out);
}

template <typename T, int D, bool SEG>
cudaError_t dispatch_emit(int emit_o, const void* q, const void* k,
                          const void* v, const void* m_in, const void* lse_in,
                          const void* acc_in, void* m_out, void* lse_out,
                          void* out, const int* q_ids, const int* kv_ids,
                          int B, int N, int Nk, int Sq, int Skv, float scale,
                          int q_lo, int q_hi, int kv_hi, int causal,
                          int offset, int window, cudaStream_t stream) {
#define FWD_ARGS                                                            \
  q, k, v, m_in, lse_in, acc_in, m_out, lse_out, out, q_ids, kv_ids, B, N,  \
      Nk, Sq, Skv, scale, q_lo, q_hi, kv_hi, causal, offset, window, stream
  if (emit_o)
    return window > 0 ? launch<T, true, D, true, SEG>(FWD_ARGS)
                      : launch<T, true, D, false, SEG>(FWD_ARGS);
  return window > 0 ? launch<T, false, D, true, SEG>(FWD_ARGS)
                    : launch<T, false, D, false, SEG>(FWD_ARGS);
#undef FWD_ARGS
}

template <typename T, int D>
cudaError_t dispatch_seg(int emit_o, const void* q, const void* k,
                         const void* v, const void* m_in, const void* lse_in,
                         const void* acc_in, void* m_out, void* lse_out,
                         void* out, const int* q_ids, const int* kv_ids,
                         int B, int N, int Nk, int Sq, int Skv, float scale,
                         int q_lo, int q_hi, int kv_hi, int causal,
                         int offset, int window, cudaStream_t stream) {
#define FWD_ARGS                                                            \
  emit_o, q, k, v, m_in, lse_in, acc_in, m_out, lse_out, out, q_ids,        \
      kv_ids, B, N, Nk, Sq, Skv, scale, q_lo, q_hi, kv_hi, causal, offset,  \
      window, stream
  if (q_ids != nullptr) return dispatch_emit<T, D, true>(FWD_ARGS);
  return dispatch_emit<T, D, false>(FWD_ARGS);
#undef FWD_ARGS
}

}  // namespace

// The attributes of the instance for `dtype` and `flag` (bit 0: emit_o,
// bit 1: a window, bit 2: segments): registers, local bytes, shared
// memory, resident CTAs.
extern "C" int flash_fwd_attrs(int dtype, int flag, int* out) {
  if (dtype == kBFloat16) return (int)attrs_of<__nv_bfloat16>(flag, out);
  if (dtype == kFloat32) return (int)attrs_of<float>(flag, out);
  return (int)cudaErrorInvalidValue;
}

// q_ids, kv_ids: both null (no segments) or both [B,Sq], [B,Skv] int32
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* m_in, const void* lse_in,
                                const void* acc_in, void* m_out,
                                void* lse_out, void* out, const void* q_ids,
                                const void* kv_ids, int B, int N, int Nk,
                                int Sq, int Skv, int D, int dtype,
                                float scale, int q_lo, int q_hi, int kv_hi,
                                int causal, int offset, int window,
                                int emit_o, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % Nk != 0 || D != 128 || (q_ids == nullptr) != (kv_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* qi = static_cast<const int*>(q_ids);
  const int* ki = static_cast<const int*>(kv_ids);
#define FWD_ARGS                                                            \
  emit_o, q, k, v, m_in, lse_in, acc_in, m_out, lse_out, out, qi, ki, B, N, \
      Nk, Sq, Skv, scale, q_lo, q_hi, kv_hi, causal, offset, window, st
  if (dtype == kBFloat16)
    return (int)dispatch_seg<__nv_bfloat16, 128>(FWD_ARGS);
  if (dtype == kFloat32) return (int)dispatch_seg<float, 128>(FWD_ARGS);
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}
