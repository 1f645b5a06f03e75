// Ragged paged attention: one launch for a mixed chunked-prefill + decode
// token batch against the shared K/V page pool.  Paged decode is its
// QT == 1 instance.
//
// Replaces: burst_attn_tpu/ops/ragged_paged.py `_ragged_kernel` (via
// `ragged_paged_attention`) and burst_attn_tpu/ops/paged_attention.py
// `_decode_kernel` (via `paged_decode_attention`, which launches this
// kernel with q [B,Nkv,G,D] seen as [B,Nkv*G,1,D], q_lens = lengths > 0,
// kv_lens = lengths): the Pallas TPU kernels whose grids walk (slot,
// kv-head, q-block, page-slot) with the page tables, lengths and context
// bounds delivered by scalar prefetch.  Full-precision pools and int8 /
// fp8 e4m3 pools with per-token fp32 scales; the split-k hooks (ctx_lo,
// emit_partials) of the grouped shared-prefix front end; the sliding
// window.
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
// Work: a block is bq query tokens of one slot and one kv head, the G
// query heads folded into its rows (bq * G <= 64, row r = token r / G,
// head r % G), so GQA shares every loaded K/V chunk.  Its positions run
// from the larger of ctx_lo's page and its first token's band start up to
// its last token's position, in 64-token chunks: pages above the causal
// edge or below the window are never loaded.  Split-k over the context,
// with the plan the host computes from shapes alone and passes in
// (ops/ragged_paged.py `split_plan`): a decode block's split covers ppd
// pages (256 positions, more when the table would cut into more than 32
// splits), a prefill block's ppf (twice that: its splits pay a q tile and
// a 32 KB partial each, its chunks are dearer); either grows until its
// kind's possible CTAs stay within a fixed count, past which the grid
// needs no more parallelism, so the partials' scratch is bounded whatever
// the slot count.  The grid is (nqb * nsd, Nkv, S), one CTA per (block,
// split); a CTA whose split holds no visible position exits at once, and
// an idle block's split 0 writes its zeros.  The page id of the next
// chunk is read one chunk ahead, so no table load stalls a copy.  So an
// 8-slot decode batch is ~29 x Nkv live CTAs, not 8 x Nkv, and a
// 2K-context prefill chunk no longer waits on one CTA walking 32 chunks.
// Each split's rows (acc, m, l, base 2) are final when the block fits one
// split, else a partial in the scratch ws (a slot per (slot, kv head,
// split) of min(16, bq * G) rows for decode, since a (slot, kv head) holds
// at most one decode block; a slot per (block, split) of bq * G rows for
// prefill); the last of the block's live splits to arrive (one atomicAdd
// on the block's counter, which it resets to 0 for the next launch)
// merges them in split order with the alpha rule's -inf guards, so two
// launches are bitwise equal.  With a trace buffer each CTA records what
// it ran, its chunks and its %globaltimer span (the card tests hold the
// host mirror `cta_plan` to it; tools/kernel_ab.py reads the spans).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s; ~295 operations
// a byte): decode rows, bytes (4 operations per K/V byte at G = 4: each
// live token's K and V rows read once per slot and kv head); prefill rows,
// at 64 rows per loaded chunk ~128 operations per K/V byte, so bytes for
// the causal mixed batch, operations for long chunks at long context.
//
// bf16 q, tensor cores (mma_tile.cuh WarpTile: mma.sync m16n8k16, bf16
// in, fp32 accumulate, ldmatrix feeds), the online softmax in registers
// (base 2, the scores times scale*log2e in fp32 rather than a pre-scaled
// bf16 q, which would round q again; the -inf guards keep masked rows at
// zeros), p as two bf16 terms for P.V (rounded p and its rounded residual:
// one rounding alone missed the bf16 tolerance on rows that see few
// positions).  A block with more than 16 live rows (real tokens x G) takes
// the prefill tile: one warpgroup, each warp 16 rows against the whole
// chunk, m16 row tiles of padding rows skipping their math.  A block with
// at most 16 (every QT = 1 launch at G <= 16, a decode slot or a short
// tail inside a mixed launch) takes the decode tile: each warp the same 16
// rows against its own 16 tokens of the chunk, the four slices merged at
// the end, so each K/V byte leaves shared memory once.  The path is chosen
// per block, on a block-uniform condition.  K/V chunks (16 KB of a page's
// contiguous rows per kv head) stream through shared memory by cp.async,
// double-buffered, one barrier a chunk: the next chunk loads while this
// one computes.  int8 / fp8 pages are staged as bytes and widened to bf16
// in shared memory (exact: both fit bf16's significand and exponent);
// their scales stay a column rescale of the scores and of p.  ~88 KB of
// shared memory, so two CTAs share an SM.
//
// fp32 q: SIMT fp32 on both paths (PagedRows below, 16 or 64 rows), the
// token-exact correctness mode; no TF32.
//
// Later work: wgmma + TMA with a producer warp (warp specialisation), fp8
// tensor-core products for 1-byte pools, 128-row blocks for long chunks.

#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

using namespace bat;

constexpr int D = kTileD;       // head dim
constexpr int CH = kTileChunk;  // tokens per K/V chunk
constexpr int NT = 128;         // threads per CTA
constexpr int MAXR = 64;        // rows per block
constexpr int DROWS = 16;       // a block with at most this many live rows decodes
constexpr int MAXSPLIT = 32;    // most splits a block's merge buffers hold

__device__ __forceinline__ float dot4_fma(float s, float4 a, float4 b) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

struct Params {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *table, *q_lens, *kv_lens, *ctx_lo;
  void* out;
  float *acc, *m, *l;  // emit_partials outputs (else null)
  float* ws;           // split partials: acc, then m, then l
  int* counters;       // one arrival counter per block item, zero
  long long* trace;    // per-CTA records (kind, a, e, t0, t1, cycles) or null
  int S, Nkv, G, QT, page, width, window, bq, nqb;
  int ppd, nsd, ppf, nsf;  // pages a split and splits: decode, prefill
  int rd;                  // rows of a decode partial: min(DROWS, bq * G)
  size_t n_dec, n_ws;      // decode partial rows (prefill's follow), all rows
  float scale_log2;
};

// One block: tokens [t0q, t0q + bq) of slot s, kv head h; `live` of its
// rows are real (<= 0: an idle slot or an all-padding block).  Without
// q_lens (paged decode) a slot holds one token when its length is > 0.
struct Blk {
  int s, h, qb, t0q, q_len, q_start, live, ctx_lo;
};

__device__ __forceinline__ Blk block(const Params& p, int s, int h, int qb) {
  Blk b;
  b.s = s;
  b.h = h;
  b.qb = qb;
  b.t0q = qb * p.bq;
  const int kv = p.kv_lens[s];  // the three loads in flight together
  b.q_len = p.q_lens != nullptr ? p.q_lens[s] : (kv > 0 ? 1 : 0);
  b.ctx_lo = p.ctx_lo != nullptr ? p.ctx_lo[s] : 0;
  b.q_start = kv - b.q_len;  // position of query token 0
  b.live = (min(b.q_len, b.t0q + p.bq) - b.t0q) * p.G;
  return b;
}

// element offset of row r's [D] vector in q / out / acc
__device__ __forceinline__ size_t row_off(const Params& p, const Blk& b,
                                          int r) {
  const int t = b.t0q + r / p.G, g = r % p.G;
  return ((((size_t)b.s * p.Nkv + b.h) * p.G + g) * p.QT + t) * D;
}
// rows past QT are not stored (the last block of a QT not divisible by bq)
__device__ __forceinline__ bool row_stored(const Params& p, const Blk& b,
                                           int r) {
  return b.t0q + r / p.G < p.QT;
}

// The chunks [c_lo, c_hi] the block's rows may see: from the larger of
// ctx_lo's page and the first token's band start (WIN) up to the last real
// token's position; c_lo > c_hi when nothing is visible.  WIN is a
// template flag, so a window at or above every length walks exactly the
// unwindowed chunks with the unwindowed code.
template <bool WIN>
__device__ __forceinline__ void chunk_span(const Params& p, const Blk& b,
                                           int& c_lo, int& c_hi) {
  const int t_end = min(b.q_len, b.t0q + p.bq);
  const int hi = min(b.q_start + t_end - 1, p.width * p.page - 1);
  int lo = max(b.ctx_lo, 0) / p.page * p.page;
  if (WIN) lo = max(lo, b.q_start + b.t0q - p.window + 1);
  c_lo = lo / CH;
  c_hi = hi >= 0 ? hi / CH : -1;
}

// pool page of chunk c of slot s, and the chunk's first pool row (of
// [P*Nkv*page] rows) for kv head h
__device__ __forceinline__ int chunk_page(const Params& p, int s, int c) {
  return p.table[(size_t)s * p.width + c * CH / p.page];
}
__device__ __forceinline__ size_t chunk_row0(const Params& p, int h, int c,
                                             int pid) {
  return ((size_t)pid * p.Nkv + h) * p.page + c * CH % p.page;
}

// rows [r0, r1) of the block (those stored) as zeros / empty partials
template <typename T>
__device__ void write_empty(const Params& p, const Blk& b, int r0, int r1) {
  for (int i = threadIdx.x; i < (r1 - r0) * D; i += NT) {
    const int r = r0 + i / D;
    if (!row_stored(p, b, r)) continue;
    const size_t off = row_off(p, b, r);
    if (p.acc != nullptr) {
      p.acc[off + i % D] = 0.f;
      if (i % D == 0) {
        p.m[off / D] = neg_inf();
        p.l[off / D] = 0.f;
      }
    } else {
      store(static_cast<T*>(p.out) + off + i % D, 0.f);
    }
  }
}

// Two stages of one chunk's K and V rows in the pool's storage type
// ([CH][LD], rows padded by 16 bytes: conflict-free row reads, and for
// bf16 exactly the mma tile's layout), filled by cp.async, and of a
// 1-byte pool's scales.
template <typename KV, bool QUANT>
struct Stager {
  static constexpr int LD = D + 16 / (int)sizeof(KV);
  static constexpr size_t kStage = 2 * (size_t)CH * LD * sizeof(KV);
  static constexpr size_t kBytes = 2 * kStage + (QUANT ? 4 * 2 * 2 * CH : 0);
  char* base;

  __device__ explicit Stager(char* smem) : base(smem) {}
  __device__ KV* k(int st) const {
    return reinterpret_cast<KV*>(base + st * kStage);
  }
  __device__ KV* v(int st) const { return k(st) + CH * LD; }
  __device__ float* ks(int st) const {
    return reinterpret_cast<float*>(base + 2 * kStage) + st * 2 * CH;
  }
  __device__ float* vs(int st) const { return ks(st) + CH; }

  // start the copy of chunk c (on pool page pid) into stage st (the
  // caller commits)
  __device__ void issue(const Params& p, int h, int c, int pid,
                        int st) const {
    const size_t row0 = chunk_row0(p, h, c, pid);
    constexpr int RB = D * sizeof(KV);
    cp_rows<RB, LD * sizeof(KV), NT>(
        reinterpret_cast<char*>(k(st)),
        reinterpret_cast<const char*>(static_cast<const KV*>(p.kp) + row0 * D),
        CH);
    cp_rows<RB, LD * sizeof(KV), NT>(
        reinterpret_cast<char*>(v(st)),
        reinterpret_cast<const char*>(static_cast<const KV*>(p.vp) + row0 * D),
        CH);
    if constexpr (QUANT) {
      const int tid = threadIdx.x;
      if (tid < CH / 4)
        cp_async16(ks(st) + 4 * tid, p.ks + row0 + 4 * tid);
      else if (tid < CH / 2)
        cp_async16(vs(st) + 4 * (tid - CH / 4), p.vs + row0 + 4 * (tid - CH / 4));
    }
  }
};

// The result of a block's split, handed from the math to emit(): acc
// [MAXR][D], m and l [MAXR] (base 2), rows [0, live); the math's buffers
// are dead by then, so these alias them.  wm, wl: the decode tile's
// per-warp (m, l); w, wls: the merge's split maxima (then weights) and
// sums [MAXSPLIT][MAXR].
struct EmitSmem {
  float *o, *m, *l, *wm, *wl, *w, *wls;
  int* flag;
  static constexpr size_t kBytes =
      4 * ((size_t)MAXR * D + 4 * MAXR + 2 * MAXSPLIT * MAXR) + 16;
  __device__ explicit EmitSmem(char* smem) {
    o = reinterpret_cast<float*>(smem);
    m = o + MAXR * D;
    l = m + MAXR;
    wm = l + MAXR;
    wl = wm + MAXR;
    w = wl + MAXR;
    wls = w + MAXSPLIT * MAXR;
    flag = reinterpret_cast<int*>(wls + MAXSPLIT * MAXR);
  }
};

// ---------------------------------------------------------------------------
// SIMT fp32 (fp32 q): online-softmax state of up to ROWS rows.  Warp w owns
// rows w, w + NW, ... (m and l replicated across its lanes); thread d owns
// output column d of every row.

template <int ROWS>
struct PagedRows {
  static constexpr int NW = NT / 32;
  float m[ROWS / NW], l[ROWS / NW];
  float acc[ROWS];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < ROWS / NW; ++i) {
      m[i] = neg_inf();
      l[i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  }

  // One chunk: scores of `rows` query rows (sQ [rows][D] fp32, pre-scaled
  // by scale*log2e) against the chunk's keys (sK [CH][LDK] in the pool's
  // storage type), masked by valid(row, token), then the base-2 online
  // softmax and P.V (sV [CH][LDV]) into acc.  Quantized pools pass their
  // per-token scales (sKs, sVs [CH]): the dequantization is a column
  // rescale of the scores and of p.  sS [ROWS][CH] and sA [ROWS] are
  // scratch.  All threads call it; it synchronises internally, and the
  // chunk's buffers may be refilled after one more __syncthreads().
  template <bool QUANT, typename KS, int LDK, int LDV, typename Valid>
  __device__ __forceinline__ void chunk(const float* __restrict__ sQ,
                                        const KS* __restrict__ sK,
                                        const KS* __restrict__ sV,
                                        const float* __restrict__ sKs,
                                        const float* __restrict__ sVs,
                                        float* __restrict__ sS,
                                        float* __restrict__ sA, int rows,
                                        Valid valid) {
    static_assert(CH == 64, "two scores per lane in the row reductions");
    static_assert(D == NT, "one output column per thread");
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    {  // scores: thread (t, r0) computes rows r0, r0 + NT/CH, ...
      const int t = tid % CH;
      for (int r = tid / CH; r < rows; r += NT / CH) {
        float s = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 8) {
          float k[8];
          load8(sK + t * LDK + d, k);
          const float* qr = sQ + r * D + d;
          s = dot4_fma(s, *reinterpret_cast<const float4*>(qr),
                       make_float4(k[0], k[1], k[2], k[3]));
          s = dot4_fma(s, *reinterpret_cast<const float4*>(qr + 4),
                       make_float4(k[4], k[5], k[6], k[7]));
        }
        if constexpr (QUANT) s *= sKs[t];
        sS[r * CH + t] = valid(r, t) ? s : neg_inf();
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ROWS / NW; ++i) {
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

#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows) acc[r] *= sA[r];
#pragma unroll 4
    for (int j = 0; j < CH; ++j) {
      const float vv = to_float(sV[j * LDV + tid]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < rows) acc[r] = fmaf(sS[r * CH + j], vv, acc[r]);
    }
  }
};

template <typename KV, bool QUANT, int ROWS>
constexpr size_t simt_smem() {
  return 4 * (size_t)ROWS * D + Stager<KV, QUANT>::kBytes +
         4 * (size_t)ROWS * CH + 4 * ROWS;
}

// chunks [a, e] of the block through SIMT fp32, ROWS >= live rows
template <typename KV, bool QUANT, bool WIN, int ROWS>
__device__ void simt_path(const Params& p, char* smem, const Blk& b, int a,
                          int e) {
  using St = Stager<KV, QUANT>;
  const int tid = threadIdx.x;
  float* sQ = reinterpret_cast<float*>(smem);
  const St stg(smem + 4 * ROWS * D);
  float* sS = reinterpret_cast<float*>(smem + 4 * ROWS * D + St::kBytes);
  float* sA = sS + ROWS * CH;
  const float* q = static_cast<const float*>(p.q);
  for (int i = tid; i < b.live * D; i += NT)
    sQ[i] = q[row_off(p, b, i / D) + i % D] * p.scale_log2;
  const int n = e - a + 1;
  stg.issue(p, b.h, a, chunk_page(p, b.s, a), 0);
  cp_async_commit();
  int pid = n > 1 ? chunk_page(p, b.s, a + 1) : 0;  // one chunk ahead
  PagedRows<ROWS> st;
  st.init();
  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();  // chunk i has landed
    __syncthreads();     // ... for every thread; chunk i - 1 is done with
    if (i + 1 < n) stg.issue(p, b.h, a + i + 1, pid, (i + 1) & 1);
    if (i + 2 < n) pid = chunk_page(p, b.s, a + i + 2);  // used next turn
    cp_async_commit();
    const int pos0 = (a + i) * CH;
    st.template chunk<QUANT, KV, St::LD, St::LD>(
        sQ, stg.k(i & 1), stg.v(i & 1), stg.ks(i & 1), stg.vs(i & 1), sS, sA,
        b.live, [&](int r, int t) {
          const int qp = b.q_start + b.t0q + r / p.G;
          return pos0 + t <= qp && (!WIN || pos0 + t > qp - p.window);
        });
  }
  __syncthreads();  // the emit buffers alias the stages
  const EmitSmem em(smem);
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < ROWS / PagedRows<ROWS>::NW; ++i) {
    const int r = warp + PagedRows<ROWS>::NW * i;
    if (lane == 0 && r < b.live) {
      em.m[r] = st.m[i];
      em.l[r] = st.l[i];
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (r < b.live) em.o[r * D + tid] = st.acc[r];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Tensor cores (bf16 q): mma_tile.cuh WarpTile.  Prefill (DEC false): warp
// w owns rows 16w .. 16w + 15 against all CH tokens of each chunk; an m16
// row tile wholly of padding rows skips its math.  Decode (DEC true, <= 16
// live rows): every warp owns rows 0 .. 15 against its own 16 tokens of
// each chunk (four online softmaxes over disjoint token slices, merged in
// warp order at the end), so each K/V byte is read from shared memory
// once.

template <typename KV, bool QUANT>
constexpr size_t mma_smem() {
  return 2 * (size_t)MAXR * kTileLd + Stager<KV, QUANT>::kBytes +
         (QUANT ? 2 * 2 * (size_t)CH * kTileLd : 0);
}

template <typename KV, bool QUANT, bool WIN, bool DEC>
__device__ void mma_path(const Params& p, char* smem, const Blk& b, int a,
                         int e) {
  using bf16 = __nv_bfloat16;
  using St = Stager<KV, QUANT>;
  constexpr int TILE = CH * kTileLd;   // elements of one K or V chunk
  constexpr int NTOK = DEC ? 16 : CH;  // tokens of a chunk per warp
  constexpr int QROWS = DEC ? DROWS : MAXR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  // sQ [MAXR][kTileLd] | the stages | 1-byte pool: the chunk widened to a
  // bf16 (K, V) tile pair
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  const St stg(smem + 2 * MAXR * kTileLd);
  bf16* conv =
      reinterpret_cast<bf16*>(smem + 2 * MAXR * kTileLd + St::kBytes);
  const bf16* q = static_cast<const bf16*>(p.q);
  for (int i = tid; i < QROWS * (D / 8); i += NT) {  // live rows, zeros else
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    bf16* dst = sQ + r * kTileLd + c8;
    if (r < b.live)
      cp_async16(dst, q + row_off(p, b, r) + c8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  const int n = e - a + 1;
  stg.issue(p, b.h, a, chunk_page(p, b.s, a), 0);
  cp_async_commit();
  int pid = n > 1 ? chunk_page(p, b.s, a + 1) : 0;  // one chunk ahead

  const int rbase = DEC ? 0 : 16 * warp;  // the warp's first row
  const int tok0 = DEC ? 16 * warp : 0;   // the warp's first token of a chunk
  const bool warp_live = rbase < b.live;
  int hi[2], lo[2];  // visible positions of the lane's rows g, g + 8
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = rbase + g + 8 * hf;
    const int qp = b.q_start + b.t0q + r / p.G;
    hi[hf] = r < b.live ? qp : -1;
    lo[hf] = WIN ? qp - p.window + 1 : 0;
  }
  // the warp's rows see positions within [rlo, rhi]
  const int rhi = b.q_start + b.t0q + min(rbase + 15, b.live - 1) / p.G;
  const int rlo = b.q_start + b.t0q + rbase / p.G - p.window + 1;
  WarpTile wt;
  wt.init();
  wt.set_q(sQ + rbase * kTileLd);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<0>();  // chunk i (and q) has landed
    __syncthreads();     // ... for every thread; chunk i - 1 is done with
    if (i + 1 < n) stg.issue(p, b.h, a + i + 1, pid, (i + 1) & 1);
    if (i + 2 < n) pid = chunk_page(p, b.s, a + i + 2);  // used next turn
    cp_async_commit();
    const int st = i & 1;
    const bf16* sK;
    if constexpr (QUANT) {  // widen the 1-byte chunk to bf16 (exact)
      for (int j = tid; j < 2 * CH * (D / 16); j += NT) {
        const int kv = j / (CH * (D / 16)), rc = j % (CH * (D / 16));
        const int r = rc / (D / 16), c16 = (rc % (D / 16)) * 16;
        const uint4 u = *reinterpret_cast<const uint4*>(
            (kv ? stg.v(st) : stg.k(st)) + r * St::LD + c16);
        const KV* v = reinterpret_cast<const KV*>(&u);
        uint32_t w[8];
#pragma unroll
        for (int x = 0; x < 8; ++x)
          w[x] = pack_bf16(to_float(v[2 * x]), to_float(v[2 * x + 1]));
        uint4* dst =
            reinterpret_cast<uint4*>(conv + kv * TILE + r * kTileLd + c16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      sK = conv;
    } else {
      sK = reinterpret_cast<const bf16*>(stg.k(st));
    }
    const bf16* sV = sK + TILE;
    const float* sks = stg.ks(st);
    const float* svs = stg.vs(st);
    const int pos0 = (a + i) * CH + tok0;  // the warp's first token
    // a warp whose rows see none of its tokens keeps its state as is (the
    // update would leave m, l, O unchanged)
    if (warp_live && pos0 <= rhi && (!WIN || pos0 + NTOK - 1 >= rlo)) {
      const float sl2 = p.scale_log2;
      wt.template step<NTOK>(
          sK + tok0 * kTileLd, sV + tok0 * kTileLd,
          [&](int col) { return QUANT ? sl2 * sks[tok0 + col] : sl2; },
          [&](int hf, int col) {
            const int pos = pos0 + col;
            return pos <= hi[hf] && (!WIN || pos >= lo[hf]);
          },
          [&](int col) { return QUANT ? svs[tok0 + col] : 1.f; });
    }
  }
  wt.finish();
  __syncthreads();  // the emit buffers alias the tiles
  const EmitSmem em(smem);
  // prefill: the warp's rows; decode: warp w's slice state as rows 16w ..
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int slot = 16 * warp + g + 8 * hf;
    if (!DEC && slot >= b.live) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(em.o + slot * D + 8 * nt + 2 * c) =
          make_float2(wt.o[nt][2 * hf], wt.o[nt][2 * hf + 1]);
    if (c == 0) {
      (DEC ? em.wm : em.m)[slot] = wt.m[hf];
      (DEC ? em.wl : em.l)[slot] = wt.l[hf];
    }
  }
  __syncthreads();
  if constexpr (DEC) {  // merge the four slices in warp order, in place
    for (int i = tid; i < b.live * D; i += NT) {
      const int r = i / D;
      float mg = em.wm[r];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) mg = fmaxf(mg, em.wm[16 * w + r]);
      float acc = 0.f, l = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) {
        const float mw = em.wm[16 * w + r];
        const float x = (mw >= mg) ? 1.f : exp2f(mw - mg);
        acc = fmaf(em.o[16 * w * D + i], x, acc);
        l = fmaf(em.wl[16 * w + r], x, l);
      }
      em.o[i] = acc;  // row r of slice 0: read above by this thread only
      if (i % D == 0) {
        em.m[r] = mg;
        em.l[r] = l;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The split's rows out: final when the block's positions fit one split,
// else a partial in ws; the item's last split to arrive merges the
// partials in split order (fixed: two launches are bitwise equal) and
// resets the item's counter for the next launch.

// four consecutive columns of a row out, as q's dtype
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

template <typename T>
__device__ void emit(const Params& p, char* smem, const Blk& b, bool dec,
                     int sp, int sp_lo, int sp_hi) {
  constexpr int D4 = D / 4;
  const EmitSmem em(smem);
  const int tid = threadIdx.x, live = b.live, rows = p.bq * p.G;
  // columns 4 * (i % D4) .. + 3 of row i / D4
  auto put = [&](int i, float4 acc, float m, float l) {
    const size_t off = row_off(p, b, i / D4) + 4 * (i % D4);
    if (p.acc != nullptr) {
      store4(p.acc + off, acc);
      if (i % D4 == 0) {
        p.m[off / D] = m;
        p.l[off / D] = l;
      }
    } else {  // masked rows (l == 0) emit zeros
      const float inv = l > 0.f ? 1.f / l : 0.f;
      store4(static_cast<T*>(p.out) + off,
             make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
    }
  };
  const float4* o4 = reinterpret_cast<const float4*>(em.o);
  if (sp_lo == sp_hi) {
    for (int i = tid; i < live * D4; i += NT)
      put(i, o4[i], em.m[i / D4], em.l[i / D4]);
    write_empty<T>(p, b, live, rows);
    return;
  }
  const size_t sh = (size_t)b.s * p.Nkv + b.h;
  const size_t item = sh * p.nqb + b.qb;  // the block's counter
  float4* ws_acc = reinterpret_cast<float4*>(p.ws);
  float* ws_m = p.ws + p.n_ws * D;
  float* ws_l = ws_m + p.n_ws;
  // the block's partials: (slot, kv head, split) for decode, (block,
  // split) for prefill, `stride` rows each; base = split 0, row 0
  const int stride = dec ? p.rd : rows;
  const size_t base =
      dec ? sh * p.nsd * p.rd : p.n_dec + item * p.nsf * (size_t)rows;
  const size_t mine = base + (size_t)sp * stride;
  for (int i = tid; i < live * D4; i += NT) ws_acc[mine * D4 + i] = o4[i];
  for (int r = tid; r < live; r += NT) {
    ws_m[mine + r] = em.m[r];
    ws_l[mine + r] = em.l[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(p.counters + item, 1);
    const int last = prev == sp_hi - sp_lo;
    if (last) p.counters[item] = 0;  // every split arrived: reset
    *em.flag = last;
  }
  __syncthreads();
  if (!*em.flag) return;
  __threadfence();
  const int nl = sp_hi - sp_lo + 1;
  const size_t first = base + (size_t)sp_lo * stride;
  for (int t = tid; t < nl * live; t += NT) {  // every split's (m, l) at once
    const int j = t / live, r = t % live;
    em.w[j * MAXR + r] = __ldcg(ws_m + first + (size_t)j * stride + r);
    em.wls[j * MAXR + r] = __ldcg(ws_l + first + (size_t)j * stride + r);
  }
  __syncthreads();
  for (int r = tid; r < live; r += NT) {  // each row's max, weights, sum
    float mg = neg_inf();
    for (int j = 0; j < nl; ++j) mg = fmaxf(mg, em.w[j * MAXR + r]);
    float l = 0.f;
    for (int j = 0; j < nl; ++j) {
      const float mj = em.w[j * MAXR + r];
      const float w = (mj >= mg) ? 1.f : exp2f(mj - mg);
      em.w[j * MAXR + r] = w;
      l = fmaf(em.wls[j * MAXR + r], w, l);
    }
    em.m[r] = mg;
    em.l[r] = l;
  }
  __syncthreads();
  // the weighted sum in split order (fixed: two launches are bitwise
  // equal), U splits' loads in flight at a time
  constexpr int U = 8;
  for (int i = tid; i < live * D4; i += NT) {
    const int r = i / D4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < nl; j0 += U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (j0 + u < nl)
          v[u] = __ldcg(ws_acc + (first + (size_t)(j0 + u) * stride) * D4 + i);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j0 + u >= nl) break;
        const float w = em.w[(j0 + u) * MAXR + r];
        acc.x = fmaf(v[u].x, w, acc.x);
        acc.y = fmaf(v[u].y, w, acc.y);
        acc.z = fmaf(v[u].z, w, acc.z);
        acc.w = fmaf(v[u].w, w, acc.w);
      }
    }
    put(i, acc, em.m[r], em.l[r]);
  }
  write_empty<T>(p, b, live, rows);
}

template <typename T, typename KV, bool QUANT>
constexpr size_t smem_bytes() {
  constexpr size_t math = std::is_same<T, float>::value
                              ? simt_smem<KV, QUANT, MAXR>()
                              : mma_smem<KV, QUANT>();
  return math > EmitSmem::kBytes ? math : EmitSmem::kBytes;
}

// The CTA's trace record (kind, a, e, t0, t1, cycles) for thread 0 of a
// traced instance, else null: computed where it is used, so no register
// holds it across the math.  TRACE is a template flag: as a runtime test
// it cost the untraced launches ~1% (tools/kernel_ab.py A/B on an H100
// 80GB HBM3 at 700 W).
template <bool TRACE>
__device__ __forceinline__ long long* trace_rec(const Params& p) {
  if (!TRACE || threadIdx.x != 0) return nullptr;
  return p.trace +
         (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
          blockIdx.x) * 6;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// CTA (x, h, s) of the grid (nqb * nsd, Nkv, S): block x / nsd, split
// x % nsd (a prefill block has nsf <= nsd splits; the rest exit).  Every
// return is block-uniform.  A CTA that runs a tile records its kind (1
// decode, 2 prefill) and chunks [a, e] in its trace record.
template <typename T, typename KV, bool QUANT, bool WIN, bool TRACE>
__device__ void item(const Params& p, char* smem, int x, int h, int s) {
  const int qb = x / p.nsd, sp = x % p.nsd;
  const Blk b = block(p, s, h, qb);
  const int rows = p.bq * p.G;
  if (b.live <= 0) {  // idle slot or an all-padding block
    if (sp == 0) write_empty<T>(p, b, 0, rows);
    return;
  }
  int c_lo, c_hi;
  chunk_span<WIN>(p, b, c_lo, c_hi);
  if (c_lo > c_hi) {  // nothing visible (ctx_lo past the tokens)
    if (sp == 0) write_empty<T>(p, b, 0, rows);
    return;
  }
  // chunks per split of the block's kind
  const bool dec = b.live <= DROWS;
  const int cps = (dec ? p.ppd : p.ppf) * p.page / CH;
  const int sp_lo = c_lo / cps, sp_hi = c_hi / cps;
  if (sp < sp_lo || sp > sp_hi) return;
  const int a = max(c_lo, sp * cps), e = min(c_hi, sp * cps + cps - 1);
  if (long long* rec = trace_rec<TRACE>(p)) {
    rec[0] = dec ? 1 : 2;
    rec[1] = a;
    rec[2] = e;
  }
  if constexpr (std::is_same<T, float>::value) {
    if (dec)
      simt_path<KV, QUANT, WIN, DROWS>(p, smem, b, a, e);
    else
      simt_path<KV, QUANT, WIN, MAXR>(p, smem, b, a, e);
  } else {
    if (dec)
      mma_path<KV, QUANT, WIN, true>(p, smem, b, a, e);
    else
      mma_path<KV, QUANT, WIN, false>(p, smem, b, a, e);
  }
  emit<T>(p, smem, b, dec, sp, sp_lo, sp_hi);
}

template <typename T, typename KV, bool QUANT, bool WIN, bool TRACE>
__global__ void __launch_bounds__(NT) ragged_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  if (long long* rec = trace_rec<TRACE>(p)) {  // an exit unless item says more
    rec[0] = 0;
    rec[1] = 0;
    rec[2] = -1;
    rec[3] = global_ns();
    rec[5] = clock64();
  }
  item<T, KV, QUANT, WIN, TRACE>(p, reinterpret_cast<char*>(smem4),
                                 blockIdx.x, blockIdx.y, blockIdx.z);
  if (!TRACE) return;
  __syncthreads();  // every thread done (item's returns are block-uniform)
  if (long long* rec = trace_rec<TRACE>(p)) {
    rec[4] = global_ns();
    rec[5] = clock64() - rec[5];
  }
}

template <typename T, typename KV, bool QUANT, bool WIN, bool TRACE>
cudaError_t launch_win(const Params& p, cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t smem = smem_bytes<T, KV, QUANT>();
  cudaError_t e =
      allow_smem(ragged_kernel<T, KV, QUANT, WIN, TRACE>, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.nqb * p.nsd, p.Nkv, p.S);
  ragged_kernel<T, KV, QUANT, WIN, TRACE><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename KV, bool QUANT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.trace != nullptr) {  // traced instances: bf16 q on a bf16 pool only
    if constexpr (std::is_same<T, __nv_bfloat16>::value &&
                  std::is_same<KV, T>::value) {
      if (p.window > 0) return launch_win<T, KV, QUANT, true, true>(p, stream);
      return launch_win<T, KV, QUANT, false, true>(p, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (p.window > 0) return launch_win<T, KV, QUANT, true, false>(p, stream);
  return launch_win<T, KV, QUANT, false, false>(p, stream);
}

template <typename T>
cudaError_t dispatch_pool(int kv_dtype, int dtype, const Params& p,
                          cudaStream_t stream) {
  if (kv_dtype == dtype) return launch<T, T, false>(p, stream);
  if (p.ks == nullptr || p.vs == nullptr) return cudaErrorInvalidValue;
  if (kv_dtype == kInt8) return launch<T, int8_t, true>(p, stream);
  if (kv_dtype == kFp8E4M3) return launch<T, __nv_fp8_e4m3, true>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_lens may be null: one query token per slot whose kv_lens is > 0 (paged
// decode).  (ppd, nsd, ppf, nsf): the split plan (ops/ragged_paged.py
// split_plan).  ws holds n_ws floats (ops/ragged_paged.py scratch_floats:
// the split partials' rows of D + 2 floats) and counters S * Nkv * nqb
// zeroed ints, which every launch leaves zero; both null when no block
// kind splits.  trace, when not null (bf16 q on a bf16 pool only), gets 6
// int64 a CTA of the grid (nqb * nsd, Nkv, S), x fastest.
extern "C" int ragged_paged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* table,
    const void* q_lens, const void* kv_lens, const void* ctx_lo, void* out,
    void* acc, void* m, void* l, void* ws, void* counters, void* trace,
    int S, int Nkv, int G, int QT, int D_, int page, int width, int window,
    int ppd, int nsd, int ppf, int nsf, int n_ws, int dtype, int kv_dtype,
    float scale, void* stream) {
  if (G < 1 || G > MAXR || page % CH != 0 || D_ != D || QT < 1 || ppd < 1 ||
      ppf < 1 || width < 0)
    return (int)cudaErrorInvalidValue;
  // the split plan covers the table in at most MAXSPLIT splits of each
  // kind, and ws has the rows it needs
  const int bq = QT < MAXR / G ? QT : MAXR / G;  // a decode batch: G rows
  const int nqb = (QT + bq - 1) / bq, rows = bq * G;
  const int rd = rows < DROWS ? rows : DROWS;
  auto splits = [&](int pps) {
    const int n = (width + pps - 1) / pps;
    return n > 1 ? n : 1;
  };
  const size_t n_dec = nsd > 1 ? (size_t)S * Nkv * nsd * rd : 0;
  const size_t n_pre = nsf > 1 ? (size_t)S * Nkv * nqb * nsf * rows : 0;
  if (nsd != splits(ppd) || nsf != splits(ppf) || nsf > nsd ||
      nsd > MAXSPLIT || (size_t)n_ws != (n_dec + n_pre) * (D + 2) ||
      (n_ws > 0 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((out == nullptr) == (acc == nullptr) ||
      (acc != nullptr && (m == nullptr || l == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.kp = k_pages;
  p.vp = v_pages;
  p.ks = static_cast<const float*>(k_scales);
  p.vs = static_cast<const float*>(v_scales);
  p.table = static_cast<const int*>(table);
  p.q_lens = static_cast<const int*>(q_lens);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.ctx_lo = static_cast<const int*>(ctx_lo);
  p.out = out;
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.trace = static_cast<long long*>(trace);
  p.S = S;
  p.Nkv = Nkv;
  p.G = G;
  p.QT = QT;
  p.page = page;
  p.width = width;
  p.window = window;
  p.bq = bq;
  p.nqb = nqb;
  p.ppd = ppd;
  p.nsd = nsd;
  p.ppf = ppf;
  p.nsf = nsf;
  p.rd = rd;
  p.n_dec = n_dec;
  p.n_ws = n_dec + n_pre;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return (int)dispatch_pool<__nv_bfloat16>(kv_dtype, dtype, p, st);
  if (dtype == kFloat32)
    return (int)dispatch_pool<float>(kv_dtype, dtype, p, st);
  return (int)cudaErrorInvalidValue;
}
