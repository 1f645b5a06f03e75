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
// scalars (q_lo, q_hi, kv_hi, causal, offset) arrive by value.
//
// What bounds it on an H100: tensor FLOPs — causal prefill at S=2048,
// N=16, D=128 is ~17 GFLOP per call against ~8 MB of traffic, far above the
// card's ~295 FLOP/byte ridge.  This first version does NOT reach that
// bound: it computes in fp32 on the CUDA cores (no tensor cores, no TMA),
// which keeps it simple and exact to the plain version's fp32 math.  What
// the design does about the bound: one CTA per (b, h, 64-row q tile) keeps
// Q resident in shared memory and streams 64-row K/V tiles, so device
// memory is read ~once per q tile; the kv loop stops at the causal
// diagonal (and at kv_hi), so dead tiles cost nothing — the CUDA
// counterpart of the TPU kernel's triangular grid.  Ragged lengths are
// masked in-kernel (no padding to a tile multiple).  wgmma/TMA come later.
//
// Softmax runs in base 2 (q pre-scaled by scale*log2e, exp2f), like the TPU
// kernel; m and lse are converted back to natural log at the end.

#include "common.cuh"

namespace {

using namespace bat;

constexpr int BQ = 64;        // q rows per CTA
constexpr int BKV = 64;       // kv rows per tile
constexpr int NT = 128;       // threads: 16 (tx, columns) x 8 (ty, rows)
constexpr int RPT = BQ / 8;   // q rows per thread
constexpr int CPT = BKV / 16; // score columns per thread

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D] + sK [BKV][D+4] (sP [BQ][BKV+1] aliases it) + sV [BKV][D]
  return sizeof(float) * (BQ * D + BKV * (D + 4) + BKV * D);
}

template <typename T, bool EMIT, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ m_in,
                 const float* __restrict__ lse_in,
                 const float* __restrict__ acc_in, float* __restrict__ m_out,
                 float* __restrict__ lse_out, void* __restrict__ out_raw,
                 int N, int Nk, int Sq, int Skv, float scale_log2, int q_lo,
                 int q_hi, int kv_hi, int causal, int offset) {
  constexpr int LDK = D + 4;       // padded: conflict-free float4 row reads
  constexpr int LDP = BKV + 1;
  constexpr int DC = D / 64;       // float4 groups per thread along d
  static_assert(BQ * LDP <= BKV * LDK, "sP must fit in sK");
  using OutT = typename std::conditional<EMIT, T, float>::type;

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * D;
  float* sV = sK + BKV * LDK;
  float* sP = sK;  // written only after every thread finished reading K

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)b * N + h;
  const size_t bhk = (size_t)b * Nk + h / (N / Nk);
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bhk * Skv * D;
  const T* vb = v + bhk * Skv * D;

  load_rows<T, D, BQ, NT>(qb, q0, Sq, sQ, D, scale_log2);

  float m[RPT], l[RPT], acc[RPT][DC * 4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DC * 4; ++e) acc[i][e] = 0.f;
    if (acc_in != nullptr && row < Sq) {
      const float mi = m_in[bh * Sq + row];
      m[i] = mi * kLog2e;  // base-2 domain
      l[i] = (mi == neg_inf()) ? 0.f : expf(lse_in[bh * Sq + row] - mi);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(
            acc_in + (bh * Sq + row) * D + c * 64 + tx * 4);
        acc[i][4 * c] = a.x; acc[i][4 * c + 1] = a.y;
        acc[i][4 * c + 2] = a.z; acc[i][4 * c + 3] = a.w;
      }
    }
  }

  // kv columns this q tile can see: none when no row is active; causal
  // rows stop at their diagonal, so tiles past the last row's are skipped
  const int r_lo = max(q0, q_lo);
  const int r_hi = min(min(q0 + BQ, q_hi), Sq);
  int c_end = 0;
  if (r_lo < r_hi) {
    c_end = min(kv_hi, Skv);
    if (causal) c_end = min(c_end, r_hi + offset);
  }

  for (int j0 = 0; j0 < c_end; j0 += BKV) {
    __syncthreads();  // the previous tile's P/V readers are done
    load_rows<T, D, BKV, NT>(kb, j0, Skv, sK, LDK, 1.f);
    load_rows<T, D, BKV, NT>(vb, j0, Skv, sV, D, 1.f);
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
                        (!causal || col <= row + offset);
        s[i][c] = ok ? s[i][c] : neg_inf();
        mx = fmaxf(mx, s[i][c]);
      }
      // the 16 threads of a row are one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // rows that stay at -inf keep alpha = 1 (acc is 0): no -inf - -inf
      const float alpha = (m[i] >= m_new) ? 1.f : exp2f(m[i] - m_new);
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
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DC * 4; ++e) acc[i][e] *= alpha;
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
          acc[i][4 * c] += p * vv[c].x;
          acc[i][4 * c + 1] += p * vv[c].y;
          acc[i][4 * c + 2] += p * vv[c].z;
          acc[i][4 * c + 3] += p * vv[c].w;
        }
      }
    }
  }

  OutT* out = reinterpret_cast<OutT*>(out_raw);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= Sq) continue;
    const float mn = m[i] * kLn2;  // back to the natural-log domain
    if (tx == 0) {
      m_out[bh * Sq + row] = mn;
      lse_out[bh * Sq + row] = (l[i] > 0.f) ? mn + logf(l[i]) : neg_inf();
    }
    // EMIT: fused finalize o = acc / l (empty rows give 0, not NaN)
    const float inv = EMIT ? ((l[i] > 0.f) ? 1.f / l[i] : 0.f) : 1.f;
    OutT* o = out + (bh * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(o + c * 64 + tx * 4 + e, acc[i][4 * c + e] * inv);
  }
}

template <typename T, bool EMIT, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* m_in, const void* lse_in, const void* acc_in,
                   void* m_out, void* lse_out, void* out, int B, int N, int Nk,
                   int Sq, int Skv, float scale, int q_lo, int q_hi,
                   int kv_hi, int causal, int offset, cudaStream_t stream) {
  static bool smem_set = false;
  const size_t smem = smem_bytes<D>();
  cudaError_t e =
      allow_smem(flash_fwd_kernel<T, EMIT, D>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, N, B);
  flash_fwd_kernel<T, EMIT, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(m_in),
      static_cast<const float*>(lse_in), static_cast<const float*>(acc_in),
      static_cast<float*>(m_out), static_cast<float*>(lse_out), out, N, Nk,
      Sq, Skv, scale * kLog2e, q_lo, q_hi, kv_hi, causal, offset);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_emit(int emit_o, const void* q, const void* k,
                          const void* v, const void* m_in, const void* lse_in,
                          const void* acc_in, void* m_out, void* lse_out,
                          void* out, int B, int N, int Nk, int Sq, int Skv,
                          float scale, int q_lo, int q_hi, int kv_hi,
                          int causal, int offset, cudaStream_t stream) {
  if (emit_o)
    return launch<T, true, D>(q, k, v, m_in, lse_in, acc_in, m_out, lse_out,
                              out, B, N, Nk, Sq, Skv, scale, q_lo, q_hi,
                              kv_hi, causal, offset, stream);
  return launch<T, false, D>(q, k, v, m_in, lse_in, acc_in, m_out, lse_out,
                             out, B, N, Nk, Sq, Skv, scale, q_lo, q_hi,
                             kv_hi, causal, offset, stream);
}

template <int D>
cudaError_t dispatch_dtype(int dtype, int emit_o, const void* q,
                           const void* k, const void* v, const void* m_in,
                           const void* lse_in, const void* acc_in,
                           void* m_out, void* lse_out, void* out, int B,
                           int N, int Nk, int Sq, int Skv, float scale,
                           int q_lo, int q_hi, int kv_hi, int causal,
                           int offset, cudaStream_t stream) {
  if (dtype == kBFloat16)
    return dispatch_emit<__nv_bfloat16, D>(
        emit_o, q, k, v, m_in, lse_in, acc_in, m_out, lse_out, out, B, N, Nk,
        Sq, Skv, scale, q_lo, q_hi, kv_hi, causal, offset, stream);
  if (dtype == kFloat32)
    return dispatch_emit<float, D>(
        emit_o, q, k, v, m_in, lse_in, acc_in, m_out, lse_out, out, B, N, Nk,
        Sq, Skv, scale, q_lo, q_hi, kv_hi, causal, offset, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* m_in, const void* lse_in,
                                const void* acc_in, void* m_out,
                                void* lse_out, void* out, int B, int N,
                                int Nk, int Sq, int Skv, int D, int dtype,
                                float scale, int q_lo, int q_hi, int kv_hi,
                                int causal, int offset, int emit_o,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % Nk != 0) return (int)cudaErrorInvalidValue;
  if (D == 128)
    return (int)dispatch_dtype<128>(dtype, emit_o, q, k, v, m_in, lse_in,
                                    acc_in, m_out, lse_out, out, B, N, Nk, Sq,
                                    Skv, scale, q_lo, q_hi, kv_hi, causal,
                                    offset, st);
  return (int)cudaErrorInvalidValue;
}
