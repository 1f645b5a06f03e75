// Fused ring backward: the whole R-round ring attention backward of W ring
// positions in ONE launch, driven by a compiled backward ring program.
//
// Replaces: burst_attn_tpu/ops/fused_ring_bwd.py `_fused_bwd_kernel`
// (l.168, called by `fused_ring_bwd`), the Pallas TPU kernel that walks a
// (round, batch, head, q-block) grid on one core with K/V resident in
// VMEM, rotates the q-side bundle between chips with remote DMAs into slot
// banks, and streams each dq block onward one hop behind its bundle.
//
// Contract: per position p, the local k, v [B,Nk,S,D] (resident; GQA: q
// head h reads kv head h / (N/Nk)) and the local bundle (first, dO, q,
// lse): first is delta = sum(o*dO, -1) [B,N,S] fp32, or o [B,N,S,D] itself
// (OPT = 0: delta recomputed per tile from the rotated o and dO), dO and q
// [B,N,S,D], lse [B,N,S] fp32 (the forward's final lse, natural log);
// stacked [W,...].  A per-position op table sched [W][R+1][NCOL] int32
// (rows 0..R-1: the five mask scalars with q/kv roles swapped, the
// program's op columns of burst_attn_tpu_torch/parallel/schedule.py and
// the need counts of ops/fused_ring.py; row R: neighbour positions), a
// table of each position's bundle banks, dq banks, home outputs and flag
// words, and zeroed fold counters [W][R][B*N*nqt].  Outputs fp32 dk, dv
// [W,B,Nk,S,D] and, written by the positions that finish each partial,
// one fp32 dq per home bank [W,B,N,S,D] (bidi: two, summed by the caller).
//
// Per round and per (kv tile, q tile) pair the mask leaves live, with
// P = exp2(S*scale*log2e - lse*log2e) from the FINAL lse (no online
// softmax): dV += P^T dO, dS = P*(dP - delta), dK += dS^T Q, dQ += dS K;
// the scale of dS is applied once to dK and per partial to dQ.
//
// Design (Hopper, one card holding every position):
//  * Cooperative persistent grid, G CTAs per position, all co-resident.
//    An item is (b, kv head, 64-row kv tile); its CTA loops over the GQA
//    group's q heads, so dk and dv never race.  RESIDENT (no more items
//    than CTAs): CTA j owns item j and keeps its dk, dv in registers
//    across all R rounds.  Otherwise the CTAs take a round's items in
//    increasing order from a per-(position, round) counter, so a CTA that
//    drew light items (a causal round's kv tiles differ in work by up to
//    the number of q tiles) takes more of them; dk, dv then go to the fp32
//    outputs between rounds, read back through L2 since another SM may
//    hold the item next round.
//  * The tile (bf16): mma_bwd_tile.cuh, eight warps on mma.sync m16n8k16.
//    K and V of the item go to shared memory once, as bf16, by cp.async
//    (L2 only); dK, dV stay in accumulator fragments (a warp: 16 kv rows x
//    64 columns of each).  Q and dO of the next live q tile are copied
//    from the rotated bundle slot by cp.async.cg into the second of two
//    stages while the current tile's products run (.cg reads through L2:
//    another CTA rewrites the slot during the launch), and its lse and
//    delta are loaded into registers then (OPT = 0 recomputes delta from
//    the rotated o and the staged dO).  P and dS are rebuilt in registers
//    from the S^T, dP^T accumulators and enter their products as two bf16
//    terms, so the gradients hold the fp32 tolerance of the plain version.
//    The fp32 instance runs the flash backward's SIMT tile
//    (flash_bwd_tile.cuh), fp32 in shared memory, as before.
//  * Each round has three phases.  S: every CTA copies its 1/G share of
//    each bundle send (four operands, src slot -> the neighbour's dst
//    slot) and counts it on the receiver's per-(bank, slot) arrival
//    counter, after the source's arrivals and the dst slot's credit.  A:
//    after the bundle (and, DQ_RECV, the arriving dq partial) has landed,
//    the items' compute; each (kv tile, q tile) dq partial is added into
//    the round's dq slot in increasing kv-tile order behind a per-(round,
//    q tile) fold counter (the kv tiles that see a q tile are always a
//    prefix, so tile j waits for the count j): deterministic, two launches
//    are bitwise equal.  A seeding round (no arrival) writes where it
//    would add.  The last CTA of the position to finish A grants the
//    bundle credits.  B: once every CTA of the position finished A, each
//    copies its share of the dq slot's q tiles (plus, DQI_RECV, the held
//    inter partial) to the send's target: the next position's dq slot
//    (RING), a dqi slot one inter step on (BOUNDARY) or the owner's home
//    output (HOME, FINAL), and counts the arrival; the last CTA to finish
//    B grants the dq credits.
//  * No deadlock: every wait at round r depends only on events of earlier
//    rounds or earlier phases of round r, except the fold waits, which
//    depend on smaller items of the same phase; items are taken in
//    increasing order and every CTA is resident, so the least unfinished
//    (round, phase, item) can always proceed.
//  * The counters are per round (done of A, done of B, folds) or count
//    versions cumulatively (arrivals, credits), so no wait can mistake one
//    round's progress for another's.  Sync primitives: ring_sync.cuh.
//
// What bounds it on an H100: tensor FLOPs (10 * D per attended pair:
// S, dP, dV, dK, dQ), e.g. ~88 TFLOP at B1 N32 S65536 D128 causal against
// ~10 GB of bundle, dq and dk/dv traffic.  The bf16 tile issues 16 * D
// flops a pair (the two-term P and dS double the three products they
// feed) on mma.sync, below wgmma's rate; what the dq folds' waits and the
// ring's phase waits cost, a traced launch measures (TRACE, a template
// flag: per CTA its %globaltimer span, the ns its thread 0 waited on fold
// counters and on the ring's counters, its items and steps, and the
// clock64 cycles of each part of a step).  Measured so, the dq fold (32 KB
// of fp32 reductions at L2 and a fenced count a step) is the largest
// part of a step, the elementwise P/dS work next; the waits are ~5-6%.
// A TMA producer warp feeding wgmma is the next step.
//
// Slot use (STATS, a compile-time flag: the JAX kernel's collect_stats
// bundle tally): when a position's round-r bundle has landed, thread 0 of
// the position's CTA 0 adds one to that position's slot_use[bank][slot]
// (int32 [W][2][kMaxSlots], zeroed by the host): one plain increment in
// global memory with no barrier of its own, as each word has one writer.
// The stats-off instances compile to the code without it.
//
// Packed segments (SEG, a compile-time flag: the JAX kernel's `has_seg`
// with its gathered side table, swapped to [B, world, S, 1]): every
// position's ids in one [W,B,S] int32 table.  A round masks the q ids of
// the bundle's partition (the op table's PART column) against the
// position's own kv ids: a pair counts only where they are equal, and P
// and dS are zeroed by that test itself (a row's final lse is finite
// while it may see nothing of a tile).  The bf16 tile holds the lane's two
// kv columns' ids in registers for the item and the q tile's ids in
// shared memory beside lse2 (mma_bwd_tile.cuh step<., true>); the fp32
// tile reads them through the read-only cache.  No STATS instance with
// SEG (the autograd path never counts the backward's slots).
//
// Sliding window (WIN, a compile-time flag: the JAX kernel's static `wnd`
// band, burst_attn_tpu/ops/fused_ring_bwd.py l.556-573): the table's
// round r holds the bundle of the partition r positions on, with the
// offset of masks.round_spec(..., window); an item's q-tile loop runs
// from the diagonal up to the last q tile whose band reaches the kv tile
// (flash_bwd_tile.cuh kv_tile_rows<true>) and step<., ., true> tests the
// band per element.  The kv tiles that see a q tile are then a range
// J0 .. J-1 that need not start at 0: tile j folds as contributor j - J0,
// and J0 seeds the slot on a round with no arrival.  The program is the
// compiler's truncated one (r_live live rounds; ops/fused_ring.py
// occupancy_r_live).  WIN combines with SEG; not with TRACE or STATS.
//
// Wire payloads (WIRE, a compile-time flag; the JAX kernel's `wire`
// branch, burst_attn_tpu/ops/fused_ring_bwd.py l.110-120 and l.600-625),
// the code `wire` (kInt8 or kFp8E4M3) read at run time:
//  * the bundle is quantized once by the host at entry, as the scan ring
//    does it: first (delta over s, or o over s and d), dO and q as 1-byte
//    payloads with an fp32 scale per (batch, head); lse stays fp32, and
//    the three scale vectors [B*N] follow it in the lse operand's slot,
//    so they ride its copies and credits.  A step stages Q and dO
//    dequantized to bf16 (deq_tile: plain loads, not cp.async) and reads
//    delta (or the o rows) dequantized; every round dequantizes, the self
//    round too (its bundle went through the quantizer like the others);
//  * a dq partial travels quantized: phase B sums the q tile's fp32
//    partial (plus a held inter partial), takes its amax over the tile
//    (one CTA's reduction), scale = max(amax, 1e-30) / QMAX, and writes
//    x / scale rounded to nearest even (int8: rintf, clipped to +-127;
//    fp8: the cuda_fp8.h conversion) with the scale into the receiver's
//    dq wire slot [rows x D bytes, then B*N*nqt scales] (or the owner's
//    home wire output, which the host dequantizes).  The receiver
//    dequantizes an arrival into its fp32 dq slot at the start of phase
//    A, as fold contributor 0 of each q tile, so the folds stay fp32 and
//    keep their order.  WIRE combines with SEG (the ids stay int32 in
//    the side table; the bundle's quantized q and dO are masked by them
//    as the full-precision ones are) and WIN, not with STATS or TRACE.

#include <type_traits>

#include "flash_bwd_tile.cuh"
#include "mma_bwd_tile.cuh"
#include "ring_sync.cuh"

namespace {

using namespace bat;
using namespace bat::bwd;

// op-table columns (parallel/schedule.py) and the kernel's own need
// columns (ops/fused_ring.py, BWD_KERNEL_COLS); tests/test_torch_ring_bwd.py
// holds these numbers to those two modules
constexpr int kConsumeBank = 5, kConsumeSlot = 6, kSrcBank0 = 9;
constexpr int kDqBank = 19, kDqRecv = 20, kDqSlot = 21, kDqSend = 22;
constexpr int kDqDstSlot = 23, kDqiRecv = 28, kDqiSlot = 29;
constexpr int kDqiDstSlot = 30;
constexpr int kArriveNeed = 31, kDqArriveNeed = 36, kDqiArriveNeed = 37;
constexpr int kDqTakeNeed = 38, kPart = 39;
// width of a position's slot_use row per bank (obs/devstats.py MAX_SLOTS)
constexpr int kMaxSlots = 8;
constexpr int kMetaCh1Dst = 3, kMetaHome0 = 5, kMetaHome1 = 6;
constexpr int kDqRing = 1, kDqHome = 2, kDqBoundary = 3, kDqFinal = 4;
// per send channel ch (0 or 1) and per dq bank b (0 or 1)
__device__ __forceinline__ int col_send(int ch) { return ch ? 14 : 8; }
__device__ __forceinline__ int col_src_slot(int ch) { return ch ? 15 : 10; }
__device__ __forceinline__ int col_dst_slot(int ch) { return ch ? 16 : 11; }
__device__ __forceinline__ int col_grant(int ch) { return ch ? 17 : 12; }
__device__ __forceinline__ int col_take(int ch) { return ch ? 18 : 13; }
__device__ __forceinline__ int col_src_need(int ch) { return ch ? 33 : 32; }
__device__ __forceinline__ int col_take_need(int ch) { return ch ? 35 : 34; }
__device__ __forceinline__ int meta_dst(int ch) { return ch ? 3 : 1; }
__device__ __forceinline__ int col_dq_grant(int b) { return b ? 26 : 24; }
__device__ __forceinline__ int col_dq_take(int b) { return b ? 27 : 25; }

// the address table of one position (ops/fused_ring_bwd.py _N_PTRS): the
// four bundle operands of bank b at 4b + op, the dq banks, the homes, the
// flags
constexpr int kNPtr = 13, kDqPtr = 8, kHomePtr = 10, kFlagsPtr = 12;

struct Params {
  const void* first;      // [W,B,N,S] fp32 (OPT) or [W,B,N,S,D] T
  const void* dO;         // [W,B,N,S,D]
  const void* q;
  const float* lse;       // [W,B,N,S]
  const void* k;          // [W,B,Nk,S,D]
  const void* v;
  const long long* ptrs;  // [W][kNPtr]
  const int* sched;       // [W][R+1][NCOL]
  int* folds;             // [W][R][B*N*nqt], zeroed
  float* dk;              // [W,B,Nk,S,D]
  float* dv;
  int W, B, N, Nk, S, R, NB, MS, MDQ, G, ncol;
  int copy_in[2];         // bank * 16 + slot + 1, or 0
  int resident, opt;
  float scale;
  long long* trace;       // [W*G][kTraceCols] (TRACE instances)
  int* slot_use;          // [W][2][kMaxSlots] consumes (STATS instances)
  const int* seg;         // [W,B,S] packed-sequence ids (SEG instances)
  int window;             // the band (WIN instances; 0 for the others)
  // WIRE instances: the wire code, per position the two dq wire banks
  // [W][2], a dq wire slot's bytes (payload rows x D, then the q tiles'
  // scales, padded to 16)
  int wire;
  const long long* wptrs;
  long long dq_wslot_bytes;
};

constexpr int kTraceCols = 16;

// bf16 runs the tensor-core tile, fp32 the SIMT one
template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

template <typename T, int D, bool SEG = false>
constexpr size_t smem_size() {
  return kMma<T> ? mbwd::Smem::bytes(SEG) : smem_bytes<D>();
}

// one position's counters: bundle arrive, free [NB][MS]; dq arrive, free
// [2][MDQ]; done of phase A [R], done of phase B [R], items taken [R]
struct Flags {
  int* base;
  int NB, MS, MDQ, R;
  __device__ int* arrive(int bank, int slot) const {
    return base + bank * MS + slot;
  }
  __device__ int* free_(int bank, int slot) const {
    return base + NB * MS + bank * MS + slot;
  }
  __device__ int* dq_arrive(int bank, int slot) const {
    return base + 2 * NB * MS + bank * MDQ + slot;
  }
  __device__ int* dq_free(int bank, int slot) const {
    return base + 2 * NB * MS + 2 * MDQ + bank * MDQ + slot;
  }
  __device__ int* done_a(int round) const {
    return base + 2 * NB * MS + 4 * MDQ + round;
  }
  __device__ int* done_b(int round) const {
    return base + 2 * NB * MS + 4 * MDQ + R + round;
  }
  __device__ int* taken(int round) const {
    return base + 2 * NB * MS + 4 * MDQ + 2 * R + round;
  }
};

// 4 consecutive elements through L2 -> fp32
__device__ __forceinline__ void load4_cg(const float* p, float* o) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void load4_cg(const __nv_bfloat16* p, float* o) {
  const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// load_rows (common.cuh) through L2: rows [r0, r0 + ROWS) of a row-major
// [S, D] slot into shared memory as fp32, row stride ld; rows past S zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows_l2(const T* src, int r0, int S,
                                             float* dst, int ld) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NT) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) load4_cg(src + (size_t)(r0 + r) * D + col, v);
    *reinterpret_cast<float4*>(dst + r * ld + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// load_rows_l2 of a wire payload: rows of D bytes dequantized by `sc` to T
// (held as fp32; common.cuh wire_value)
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows_l2_wire(const uint8_t* src, int r0,
                                                  int S, float* dst, int ld,
                                                  float sc, int wire) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NT) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < S) {
      const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(
          src + (size_t)(r0 + r) * D + col));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = wire_value<T>((u >> (8 * e)) & 0xffu, sc, wire);
    }
    *reinterpret_cast<float4*>(dst + r * ld + col) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// x / sc as a wire byte, rounded to nearest even (the plain version's
// parallel/ring.py wire_quantize): int8 rintf clipped to +-127, fp8 e4m3
// by the cuda_fp8.h conversion (saturating to +-448)
__device__ __forceinline__ unsigned wire_code(float x, float sc, int wire) {
  const float y = x / sc;
  if (wire == kInt8) {
    const float r = fminf(fmaxf(rintf(y), -127.f), 127.f);
    return static_cast<unsigned>(__float2int_rn(r)) & 0xffu;
  }
  const __nv_fp8_e4m3 f(y);
  return f.__x;
}

// four wire bytes (little-endian in u) times sc, as fp32
__device__ __forceinline__ float4 wire_f4(unsigned u, float sc, int wire) {
  return make_float4(wire_byte(u & 0xffu, wire) * sc,
                     wire_byte((u >> 8) & 0xffu, wire) * sc,
                     wire_byte((u >> 16) & 0xffu, wire) * sc,
                     wire_byte((u >> 24) & 0xffu, wire) * sc);
}

// The q tile's row statistics through L2: lse (as base 2; -inf past S) and
// delta, read from the bundle (OPT) or computed from its o rows and the dO
// tile already in shared memory.  Ends with __syncthreads.
// WIRE: `first` is the wire payload (delta, or the o rows) with scale fsc.
template <typename T, int D, bool WIRE = false>
__device__ __forceinline__ void load_stats(const Tiles<D>& t,
                                           const float* lse,
                                           const void* first, int i0, int S,
                                           bool opt, int wire = 0,
                                           float fsc = 1.f) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const int row = i0 + r;
    const float l = row < S ? __ldcg(lse + row) : neg_inf();
    t.lse2[r] = (l == neg_inf()) ? neg_inf() : l * kLog2e;
    if (opt && WIRE)
      t.delta[r] =
          row < S ? wire_byte(__ldcg(static_cast<const uint8_t*>(first) +
                                     row), wire) * fsc
                  : 0.f;
    else if (opt)
      t.delta[r] = row < S ? __ldcg(static_cast<const float*>(first) + row)
                           : 0.f;
  }
  if (!opt) {
    // warp w sums rows w, w + 8, ...: lane owns columns 4 lane .. +3
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const T* o = static_cast<const T*>(first);
    for (int r = w; r < BQ; r += NT / 32) {
      const int row = i0 + r;
      float acc = 0.f;
      if (row < S) {
        float ov[4];
        if constexpr (WIRE) {
          const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(
              static_cast<const uint8_t*>(first) + (size_t)row * D +
              4 * lane));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ov[e] = wire_value<T>((u >> (8 * e)) & 0xffu, fsc, wire);
        } else {
          load4_cg(o + (size_t)row * D + 4 * lane, ov);
        }
        const float4 g = *reinterpret_cast<const float4*>(
            t.dO + r * Tiles<D>::LD + 4 * lane);
        acc = ov[0] * g.x + ov[1] * g.y + ov[2] * g.z + ov[3] * g.w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) t.delta[r] = acc;
    }
  }
  __syncthreads();
}

// An 8x4-per-thread fp32 block of rows r0 + 8w + r < S, as store_block
// writes it, through L2.
template <int D>
__device__ __forceinline__ void load_block(const float* src, int r0, int S,
                                           float acc[8][4]) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = r0 + 8 * w + r;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S)
      a = __ldcg(reinterpret_cast<const float4*>(src + (size_t)row * D +
                                                 4 * lane));
    acc[r][0] = a.x; acc[r][1] = a.y; acc[r][2] = a.z; acc[r][3] = a.w;
  }
}

// delta = sum(o * dO, -1) of the staged q tile for OPT = 0: o rows from
// the rotated bundle (through L2), dO from shared memory; rows past S get
// 0.  Warp w sums rows w, w + 8, ...: lane owns columns 4 lane .. +3.
// WIRE: o is the wire payload with scale fsc (dequantized to bf16).
template <bool WIRE = false>
__device__ __forceinline__ void mma_delta(const mbwd::Smem& sm, int st,
                                          const __nv_bfloat16* o, int i0,
                                          int S, int wire = 0,
                                          float fsc = 1.f) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  for (int r = w; r < BQ; r += NT / 32) {
    const int row = i0 + r;
    float acc = 0.f;
    if (row < S) {
      float ov[4];
      if constexpr (WIRE) {
        const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(
            reinterpret_cast<const uint8_t*>(o) + (size_t)row * 128 +
            4 * lane));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ov[e] = wire_value<__nv_bfloat16>((u >> (8 * e)) & 0xffu,
                                                   fsc, wire);
      } else {
        load4_cg(o + (size_t)row * 128 + 4 * lane, ov);
      }
      const uint2 u = *reinterpret_cast<const uint2*>(
          sm.dO(st) + r * mbwd::LD + 4 * lane);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      acc = ov[0] * a.x + ov[1] * a.y + ov[2] * b.x + ov[3] * b.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) sm.delta[r] = acc;
  }
}

// How many kv tiles attend q tile [i0, i0 + BQ) under the mask: they are
// the range first_kv_tile .. first + count - 1 (the kv-tile loop's q
// range below is exactly the tiles each kv tile sees; flash_bwd_tile.cuh
// q_tile_cols).
template <bool WIN>
__device__ __forceinline__ int kv_tiles_seen(const Mask& mk, int i0,
                                             int window) {
  int c_lo, c_end;
  q_tile_cols<WIN>(mk, i0, window, c_lo, c_end);
  if (c_end <= c_lo) return 0;
  return (c_end + BKV - 1) / BKV - c_lo / BKV;
}

template <typename T, int D, bool TRACE, bool STATS, bool SEG, bool WIN,
          bool WIRE>
__global__ void __launch_bounds__(NT, 1) fused_ring_bwd_kernel(const Params p) {
  static_assert(D == 128, "thread mapping assumes 32 lanes x 4 columns");
  static_assert(mbwd::NT == NT && mbwd::BQ == BQ && mbwd::BKV == BKV,
                "both tiles share the CTA shape");
  constexpr bool MMA = kMma<T>;
  constexpr int LD = Tiles<D>::LD;
  extern __shared__ float4 smem4[];
  __shared__ int item_slot;
  const Tiles<D> t(reinterpret_cast<float*>(smem4));          // fp32
  const mbwd::Smem sm(reinterpret_cast<char*>(smem4));        // bf16

  // TRACE: thread 0's waits and counts (written at the end)
  unsigned long long t_start = 0;
  long long fold_ns = 0, phase_ns = 0, n_it = 0, n_steps = 0;
  long long cyc[8] = {};  // clock64 cycles by part of a step
  if (TRACE && threadIdx.x == 0) t_start = global_ns();
  auto wait_on = [&](const int* c, int need) {
    if (TRACE) {
      const unsigned long long t0 = global_ns();
      wait_ge(c, need);
      phase_ns += (long long)(global_ns() - t0);
    } else {
      wait_ge(c, need);
    }
  };

  const int pos = blockIdx.x / p.G, j = blockIdx.x % p.G;
  const int S = p.S, N = p.N, Nk = p.Nk, group = N / Nk;
  const int nqt = (S + BQ - 1) / BQ, nkt = (S + BKV - 1) / BKV;
  const int n_items = p.B * Nk * nkt, n_units = p.B * N * nqt;
  const int* tab = p.sched + (size_t)pos * (p.R + 1) * p.ncol;
  const int* meta = tab + (size_t)p.R * p.ncol;
  const size_t rows = (size_t)p.B * N * S;  // q-side rows of one position
  // WIRE: the three bundle scale vectors after lse, padded to 16 bytes
  const size_t scb = ((size_t)3 * p.B * N * 4 + 15) / 16 * 16;
  // bytes of one slot of each bundle operand: first, dO, q, lse (WIRE:
  // 1-byte payloads, lse and the scales)
  const size_t op_bytes[4] = {
      WIRE ? (p.opt ? rows : rows * D)
           : (p.opt ? rows * 4 : rows * D * sizeof(T)),
      rows * D * (WIRE ? 1 : sizeof(T)), rows * D * (WIRE ? 1 : sizeof(T)),
      rows * 4 + (WIRE ? scb : 0)};
  const char* local[4] = {
      static_cast<const char*>(p.first) + pos * op_bytes[0],
      static_cast<const char*>(p.dO) + pos * op_bytes[1],
      static_cast<const char*>(p.q) + pos * op_bytes[2],
      reinterpret_cast<const char*>(p.lse) + pos * op_bytes[3]};
  auto ptr = [&](int who, int i) { return p.ptrs[(size_t)who * kNPtr + i]; };
  auto flags = [&](int who) {
    return Flags{reinterpret_cast<int*>(ptr(who, kFlagsPtr)), p.NB, p.MS,
                 p.MDQ, p.R};
  };
  auto op_slot = [&](int who, int bank, int op, int slot) {
    return reinterpret_cast<char*>(ptr(who, 4 * bank + op)) +
           (size_t)slot * op_bytes[op];
  };
  auto dq_slot = [&](int who, int bank, int slot) {
    return reinterpret_cast<float*>(ptr(who, kDqPtr + bank)) +
           (size_t)slot * rows * D;
  };
  const Flags fl = flags(pos);

  // the local bundle into its program-designated slot(s): version 0
  for (int c = 0; c < 2; ++c) {
    if (p.copy_in[c] == 0) continue;
    const int cb = (p.copy_in[c] - 1) / 16, cs = (p.copy_in[c] - 1) % 16;
#pragma unroll
    for (int op = 0; op < 4; ++op)
      copy_share<NT>(local[op], op_slot(pos, cb, op, cs), op_bytes[op], j,
                     p.G);
    publish(fl.arrive(cb, cs));
  }

  const size_t kv_base = (size_t)pos * p.B * Nk * S * D;
  const T* kp = static_cast<const T*>(p.k) + kv_base;
  const T* vp = static_cast<const T*>(p.v) + kv_base;
  const float scale_log2 = p.scale * kLog2e;
  float dka[8][4], dva[8][4];  // fp32 tile: dk, dv of the item
  mbwd::KvAcc acc;             // bf16 tile: the same, as fragments

  for (int r = 0; r < p.R; ++r) {
    const int* row = tab + (size_t)r * p.ncol;
    const int cb = row[kConsumeBank], cs = row[kConsumeSlot];
    const int dqb = row[kDqBank], dqs = row[kDqSlot];
    const bool recv = row[kDqRecv] != 0;

    // ---- S: this CTA's share of each bundle send ----
    for (int ch = 0; ch < 2; ++ch) {
      if (!row[col_send(ch)]) continue;
      const int sb = ch == 0 ? row[kSrcBank0] : 1;
      const int ss = row[col_src_slot(ch)], ds = row[col_dst_slot(ch)];
      const int dst = meta[meta_dst(ch)];
      const Flags dfl = flags(dst);
      if (threadIdx.x == 0) {
        wait_on(fl.arrive(sb, ss), row[col_src_need(ch)] * p.G);
        // the dst slot is being reused: its readers must have granted it
        if (row[col_take(ch)])
          wait_on(dfl.free_(ch, ds), row[col_take_need(ch)]);
        __threadfence();
      }
      __syncthreads();
#pragma unroll
      for (int op = 0; op < 4; ++op)
        copy_share<NT>(op_slot(pos, sb, op, ss), op_slot(dst, ch, op, ds),
                       op_bytes[op], j, p.G);
      publish(dfl.arrive(ch, ds));
    }

    // ---- A: the round's bundle (and arriving dq partial) must have
    // landed; a seeding round waits for the previous round's sends, which
    // may still read the slot it overwrites ----
    if (threadIdx.x == 0) {
      wait_on(fl.arrive(cb, cs), row[kArriveNeed] * p.G);
      if constexpr (STATS) {
        if (j == 0) p.slot_use[((size_t)pos * 2 + cb) * kMaxSlots + cs] += 1;
      }
      if (recv)
        wait_on(fl.dq_arrive(dqb, dqs), row[kDqArriveNeed] * p.G);
      else if (r > 0)
        wait_on(fl.done_b(r - 1), p.G);
      __threadfence();
    }
    __syncthreads();

    const char* first_c = op_slot(pos, cb, 0, cs);
    const T* do_c = reinterpret_cast<const T*>(op_slot(pos, cb, 1, cs));
    const T* q_c = reinterpret_cast<const T*>(op_slot(pos, cb, 2, cs));
    const float* lse_c = reinterpret_cast<const float*>(
        op_slot(pos, cb, 3, cs));
    float* dq_c = dq_slot(pos, dqb, dqs);
    int* folds = p.folds + ((size_t)pos * p.R + r) * n_units;
    // WIRE: the bundle's per-(batch, head) scales of first, dO, q
    const float* bsc = lse_c + rows;
    const size_t n_bh = (size_t)p.B * N;
    const uint8_t* first_w = reinterpret_cast<const uint8_t*>(first_c);
    const uint8_t* do_w = reinterpret_cast<const uint8_t*>(do_c);
    const uint8_t* q_w = reinterpret_cast<const uint8_t*>(q_c);
    // an arriving dq partial is fold contributor 0 of each q tile (WIRE)
    const int jshift = WIRE && recv ? 1 : 0;
    if constexpr (WIRE) {
      if (recv) {  // dequantize the arrival into the fp32 dq slot
        const char* wsrc =
            reinterpret_cast<const char*>(p.wptrs[(size_t)pos * 2 + dqb]) +
            (size_t)dqs * p.dq_wslot_bytes;
        const float* wsc = reinterpret_cast<const float*>(wsrc + rows * D);
        for (int u = j; u < n_units; u += p.G) {
          const int i0 = (u % nqt) * BQ;
          const size_t base = ((size_t)(u / nqt) * S + i0) * D;
          const float sc = __ldcg(wsc + u);
          const int n = min(BQ, S - i0) * (D / 4);
          for (int e = threadIdx.x; e < n; e += NT)
            __stcg(reinterpret_cast<float4*>(dq_c + base) + e,
                   wire_f4(__ldcg(reinterpret_cast<const unsigned*>(
                               wsrc + base) + e), sc, p.wire));
          __threadfence();
          __syncthreads();
          if (threadIdx.x == 0) atomicAdd(folds + u, 1);
        }
      }
    }
    const Mask mk{row[0], row[1], row[2], row[3], row[4], S, S};
    const int wnd = WIN ? p.window : 0;  // the band (WIN)
    const bool last = r == p.R - 1;
    const int part = SEG ? row[kPart] : 0;  // the bundle's partition

    const bool resident = p.resident != 0;
    for (int it = next_item(fl.taken(r), &item_slot, j, true, resident,
                            n_items);
         it < n_items; it = next_item(fl.taken(r), &item_slot, j, false,
                                      resident, n_items)) {
      const int jt = it % nkt, hk = (it / nkt) % Nk, b = it / (nkt * Nk);
      const int j0 = jt * BKV;
      const size_t bhk = (size_t)b * Nk + hk;
      float* dk_out = p.dk + kv_base + bhk * S * D;
      float* dv_out = p.dv + kv_base + bhk * S * D;
      if (TRACE && threadIdx.x == 0) ++n_it;

      // q rows that can see some column of this tile: [i_lo, i_hi)
      int i_lo, i_hi;
      kv_tile_rows<WIN>(mk, j0, wnd, i_lo, i_hi);
      const int t_lo = i_lo / BQ;
      const int t_hi = (i_hi > i_lo) ? (i_hi + BQ - 1) / BQ : t_lo;
      // SEG: the bundle partition's q ids and the position's kv ids
      const int* qids =
          SEG ? p.seg + ((size_t)part * p.B + b) * S : nullptr;
      const int* kvids = SEG ? p.seg + ((size_t)pos * p.B + b) * S : nullptr;

      if constexpr (MMA) {
        // the item's steps: (q head g, q tile qt) for g ascending and qt
        // from t_hi - 1 down; Q, dO of step s + 1 land in stage (s + 1) % 2
        // while step s runs, its lse and delta in registers
        const int nt = t_hi - t_lo, n_st = group * nt;
        const float* f32_first = reinterpret_cast<const float*>(first_c);
        float lse_next = neg_inf(), delta_next = 0.f;
        int qid_next = -1, kid0 = 0, kid1 = 0;
        auto issue = [&](int s, int st) {
          const int qt = t_hi - 1 - s % nt, i0 = qt * BQ;
          const size_t bh = (size_t)b * N + hk * group + s / nt;
          const int valid = min(BQ, S - i0);
          if constexpr (WIRE) {
            deq_tile<BQ, NT>(sm.q(st), q_w + (bh * S + i0) * D, valid,
                             __ldcg(bsc + 2 * n_bh + bh), p.wire);
            deq_tile<BQ, NT>(sm.dO(st), do_w + (bh * S + i0) * D, valid,
                             __ldcg(bsc + n_bh + bh), p.wire);
          } else {
            cp_tile<BQ, NT>(sm.q(st), q_c + (bh * S + i0) * D, valid);
            cp_tile<BQ, NT>(sm.dO(st), do_c + (bh * S + i0) * D, valid);
          }
          const int rr = threadIdx.x % BQ;
          if (threadIdx.x < BQ)
            lse_next = rr < valid ? __ldcg(lse_c + bh * S + i0 + rr)
                                  : neg_inf();
          else if (WIRE && threadIdx.x < 2 * BQ && p.opt)
            delta_next =
                rr < valid
                    ? wire_byte(__ldcg(first_w + bh * S + i0 + rr), p.wire) *
                          __ldcg(bsc + bh)
                    : 0.f;
          else if (threadIdx.x < 2 * BQ && p.opt)
            delta_next = rr < valid ? __ldcg(f32_first + bh * S + i0 + rr)
                                    : 0.f;
          else if (SEG && threadIdx.x >= 2 * BQ && threadIdx.x < 3 * BQ)
            qid_next = rr < valid ? qids[i0 + rr] : -1;
        };
        if (n_st > 0) {
          cp_tile<BKV, NT>(sm.k, kp + (bhk * S + j0) * D, min(BKV, S - j0));
          cp_tile<BKV, NT>(sm.v, vp + (bhk * S + j0) * D, min(BKV, S - j0));
          if constexpr (SEG) mbwd::kv_tile_ids(kvids, j0, S, kid0, kid1);
          issue(0, 0);
        }
        cp_async_commit();
        if (!resident && r > 0) {
          mbwd::load_frag(dk_out, j0, S, acc.dk);
          mbwd::load_frag(dv_out, j0, S, acc.dv);
        } else if (r == 0 || !resident) {
          acc.zero();
        }
        const bool tr = TRACE && threadIdx.x == 0;
        for (int s = 0; s < n_st; ++s) {
          const int st = s & 1, qt = t_hi - 1 - s % nt, i0 = qt * BQ;
          const size_t bh = (size_t)b * N + hk * group + s / nt;
          const long long c0 = tr ? clock64() : 0;
          cp_async_wait<0>();  // step s's tiles have landed
          if (threadIdx.x < BQ)  // +inf: the row sees nothing (P = 0)
            sm.lse2[threadIdx.x] =
                (lse_next == neg_inf()) ? CUDART_INF_F : lse_next * kLog2e;
          else if (threadIdx.x < 2 * BQ && p.opt)
            sm.delta[threadIdx.x - BQ] = delta_next;
          else if (SEG && threadIdx.x >= 2 * BQ && threadIdx.x < 3 * BQ)
            sm.qid[threadIdx.x - 2 * BQ] = qid_next;
          __syncthreads();
          if (!p.opt) {
            if constexpr (WIRE)
              mma_delta<true>(sm, st,
                              reinterpret_cast<const __nv_bfloat16*>(
                                  first_w + bh * S * D),
                              i0, S, p.wire, __ldcg(bsc + bh));
            else
              mma_delta(sm, st,
                        reinterpret_cast<const __nv_bfloat16*>(first_c) +
                            bh * S * D,
                        i0, S);
            __syncthreads();
          }
          if (s + 1 < n_st) issue(s + 1, st ^ 1);
          cp_async_commit();
          float part[8][4];
          if (tr) cyc[0] += clock64() - c0;
          mbwd::step<true, SEG, WIN>(sm, st, acc, mk, i0, j0, scale_log2,
                                     part, tr ? cyc + 1 : nullptr, kid0,
                                     kid1, wnd);
          const long long c1 = tr ? clock64() : 0;
          // the tile's contributors fold from its first kv tile on, which
          // seeds the slot on a round with no arrival
          const int jf = jt - first_kv_tile<WIN>(mk, i0, wnd);
          mbwd::fold_add(dq_c + bh * S * D, folds + bh * nqt + qt,
                         jf + jshift, i0, S, part, p.scale,
                         !recv && jf == 0, tr ? &fold_ns : nullptr);
          const long long c2 = tr ? clock64() : 0;
          mbwd::fold_count(folds + bh * nqt + qt);
          if (tr) {
            cyc[6] += c2 - c1;
            cyc[7] += clock64() - c2;
            ++n_steps;
          }
        }
        cp_async_wait<0>();
        if (!resident || last) {
          mbwd::store_frag(dk_out, j0, S, acc.dk, last ? p.scale : 1.f);
          mbwd::store_frag(dv_out, j0, S, acc.dv, 1.f);
        }
      } else {
        __syncthreads();  // the previous item's readers of sK, sV are done
        load_rows<T, D, BKV, NT>(kp + bhk * S * D, j0, S, t.k, LD, 1.f);
        load_rows<T, D, BKV, NT>(vp + bhk * S * D, j0, S, t.v, LD, 1.f);
        if (!resident && r > 0) {
          load_block<D>(dk_out, j0, S, dka);
          load_block<D>(dv_out, j0, S, dva);
        } else if (r == 0 || !resident) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
        }
        for (int g = 0; g < group; ++g) {
          const size_t bh = (size_t)b * N + hk * group + g;
          for (int qt = t_hi - 1; qt >= t_lo; --qt) {
            const int i0 = qt * BQ;
            __syncthreads();  // the previous step's readers of sQ .. sdS
            if constexpr (WIRE) {
              load_rows_l2_wire<T, D, BQ>(q_w + bh * S * D, i0, S, t.q, LD,
                                          __ldcg(bsc + 2 * n_bh + bh),
                                          p.wire);
              load_rows_l2_wire<T, D, BQ>(do_w + bh * S * D, i0, S, t.dO,
                                          LD, __ldcg(bsc + n_bh + bh),
                                          p.wire);
            } else {
              load_rows_l2<T, D, BQ>(q_c + bh * S * D, i0, S, t.q, LD);
              load_rows_l2<T, D, BQ>(do_c + bh * S * D, i0, S, t.dO, LD);
            }
            __syncthreads();
            if constexpr (WIRE)
              load_stats<T, D, true>(
                  t, lse_c + bh * S, first_w + (p.opt ? bh * S : bh * S * D),
                  i0, S, p.opt != 0, p.wire, __ldcg(bsc + bh));
            else
              load_stats<T, D>(t, lse_c + bh * S,
                               first_c + (p.opt ? bh * S * 4
                                                : bh * S * D * sizeof(T)),
                               i0, S, p.opt != 0);
            scores<D, true, SEG, WIN>(t, scale_log2, i0, j0, mk, qids,
                                      kvids, wnd);
            __syncthreads();
            accum_kv<D>(t, dka, dva);
            float part[8][4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[i][e] = 0.f;
            accum_q<D>(t, part);
            const int jf = jt - first_kv_tile<WIN>(mk, i0, wnd);
            fold_dq<D>(dq_c + bh * S * D, folds + bh * nqt + qt, jf + jshift,
                       i0, S, part, p.scale, !recv && jf == 0);
          }
        }
        if (!resident || last) {
          store_block<D>(dk_out, j0, S, dka, last ? p.scale : 1.f);
          store_block<D>(dv_out, j0, S, dva, 1.f);
        }
      }
    }

    // ---- A done: the position's last CTA grants the bundle slots ----
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(fl.done_a(r), 1) == p.G - 1) {
        __threadfence();
        for (int bk = 0; bk < p.NB && bk < 2; ++bk)
          if (row[col_grant(bk)] > 0)
            atomicAdd(fl.free_(bk, row[col_grant(bk)] - 1), 1);
      }
    }

    // ---- B: once every CTA of the position finished A (its dq folds,
    // and the dk, dv an item's next CTA reads), this CTA's share of the
    // dq send ----
    if (threadIdx.x == 0) {
      wait_on(fl.done_a(r), p.G);
      __threadfence();
    }
    __syncthreads();
    const int kind = row[kDqSend];
    const bool home = kind == kDqHome || kind == kDqFinal;
    if (kind == kDqRing || kind == kDqBoundary || home) {
      const bool dqi = row[kDqiRecv] != 0;
      const int sbank = kind == kDqBoundary ? 1 : (kind == kDqFinal ? 0 : dqb);
      const int dslot = kind == kDqBoundary ? row[kDqiDstSlot]
                                            : row[kDqDstSlot];
      const int dst = kind == kDqBoundary ? meta[kMetaCh1Dst]
                      : home ? meta[sbank ? kMetaHome1 : kMetaHome0]
                             : meta[meta_dst(sbank)];
      const Flags dfl = flags(dst);
      float* out = home ? reinterpret_cast<float*>(ptr(dst, kHomePtr + sbank))
                        : dq_slot(dst, sbank, dslot);
      const float* held = dqi ? dq_slot(pos, 1, row[kDqiSlot]) : nullptr;
      if (threadIdx.x == 0) {
        if (!home && row[col_dq_take(sbank)])
          wait_on(dfl.dq_free(sbank, dslot), row[kDqTakeNeed]);
        if (dqi)
          wait_on(fl.dq_arrive(1, row[kDqiSlot]), row[kDqiArriveNeed] * p.G);
        __threadfence();
      }
      __syncthreads();
      constexpr int kVec = D / 4;  // float4 per row
      if constexpr (WIRE) {
        // quantize each q tile's partial with a fresh scale on the way out
        __shared__ float red[NT / 32];
        char* wout =
            home ? reinterpret_cast<char*>(ptr(dst, kHomePtr + sbank))
                 : reinterpret_cast<char*>(
                       p.wptrs[(size_t)dst * 2 + sbank]) +
                       (size_t)dslot * p.dq_wslot_bytes;
        const char* hw =
            dqi ? reinterpret_cast<const char*>(p.wptrs[(size_t)pos * 2 + 1]) +
                      (size_t)row[kDqiSlot] * p.dq_wslot_bytes
                : nullptr;
        const float qmax = p.wire == kInt8 ? 127.f : 448.f;
        constexpr int kPer = BQ * kVec / NT;  // float4 a thread
        for (int u = j; u < n_units; u += p.G) {
          const int qt = u % nqt, i0 = qt * BQ;
          const size_t base = ((size_t)(u / nqt) * S + i0) * D;
          const bool zero = !recv && kv_tiles_seen<WIN>(mk, i0, wnd) == 0;
          const int n = min(BQ, S - i0) * kVec;
          const float hsc =
              dqi ? __ldcg(reinterpret_cast<const float*>(hw + rows * D) + u)
                  : 0.f;
          float4 a[kPer];
          float amax = 0.f;
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int e = threadIdx.x + k * NT;
            a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (e >= n) continue;
            if (!zero)
              a[k] = __ldcg(reinterpret_cast<const float4*>(dq_c + base) + e);
            if (dqi) {
              const float4 h = wire_f4(
                  __ldcg(reinterpret_cast<const unsigned*>(hw + base) + e),
                  hsc, p.wire);
              a[k].x += h.x; a[k].y += h.y; a[k].z += h.z; a[k].w += h.w;
            }
            amax = fmaxf(amax, fmaxf(fmaxf(fabsf(a[k].x), fabsf(a[k].y)),
                                     fmaxf(fabsf(a[k].z), fabsf(a[k].w))));
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
          if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
          __syncthreads();
#pragma unroll
          for (int w2 = 0; w2 < NT / 32; ++w2) amax = fmaxf(amax, red[w2]);
          const float sc = fmaxf(amax, 1e-30f) / qmax;
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const int e = threadIdx.x + k * NT;
            if (e >= n) continue;
            const unsigned w4 = wire_code(a[k].x, sc, p.wire) |
                                wire_code(a[k].y, sc, p.wire) << 8 |
                                wire_code(a[k].z, sc, p.wire) << 16 |
                                wire_code(a[k].w, sc, p.wire) << 24;
            __stcg(reinterpret_cast<unsigned*>(wout + base) + e, w4);
          }
          if (threadIdx.x == 0)
            __stcg(reinterpret_cast<float*>(wout + rows * D) + u, sc);
          __syncthreads();  // red is read before the next tile's writes
        }
      } else
      for (int u = j; u < n_units; u += p.G) {
        const int qt = u % nqt, i0 = qt * BQ;
        const size_t base = ((size_t)(u / nqt) * S + i0) * D;
        // a q tile no kv tile saw this round holds only its arrival, or
        // nothing on a seeding round
        const bool zero = !recv && kv_tiles_seen<WIN>(mk, i0, wnd) == 0;
        const int n_rows = min(BQ, S - i0);
        for (int e = threadIdx.x; e < n_rows * kVec; e += NT) {
          const size_t at = base / 4 + e;
          float4 a = zero ? make_float4(0.f, 0.f, 0.f, 0.f)
                          : __ldcg(reinterpret_cast<const float4*>(dq_c) + at);
          if (dqi) {
            const float4 h =
                __ldcg(reinterpret_cast<const float4*>(held) + at);
            a.x += h.x; a.y += h.y; a.z += h.z; a.w += h.w;
          }
          __stcg(reinterpret_cast<float4*>(out) + at, a);
        }
      }
      if (home)
        __syncthreads();
      else
        publish(dfl.dq_arrive(sbank, dslot));
    }

    // ---- B done: the position's last CTA grants the dq slots ----
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(fl.done_b(r), 1) == p.G - 1) {
        __threadfence();
        for (int bk = 0; bk < 2; ++bk)
          if (row[col_dq_grant(bk)] > 0)
            atomicAdd(fl.dq_free(bk, row[col_dq_grant(bk)] - 1), 1);
      }
    }
  }

  if (TRACE && threadIdx.x == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    long long* rec = p.trace + (size_t)blockIdx.x * kTraceCols;
    rec[0] = (long long)t_start;
    rec[1] = (long long)global_ns();
    rec[2] = fold_ns;
    rec[3] = phase_ns;
    rec[4] = n_it;
    rec[5] = n_steps;
    rec[6] = smid;
    rec[7] = pos;
    for (int i = 0; i < 8; ++i) rec[8 + i] = cyc[i];
  }
}

template <typename T, int D, bool TRACE, bool STATS = false,
          bool SEG = false, bool WIN = false, bool WIRE = false>
cudaError_t setup(int* max_blocks) {
  static bool smem_set = false;
  auto kernel = fused_ring_bwd_kernel<T, D, TRACE, STATS, SEG, WIN, WIRE>;
  const size_t smem = smem_size<T, D, SEG>();
  cudaError_t e = allow_smem(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                    smem);
  if (e != cudaSuccess) return e;
  *max_blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename T, int D, bool TRACE, bool STATS, bool SEG = false,
          bool WIN = false, bool WIRE = false>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int max_blocks = 0;
  cudaError_t e = setup<T, D, TRACE, STATS, SEG, WIN, WIRE>(&max_blocks);
  if (e != cudaSuccess) return e;
  if (p.G * p.W > max_blocks) return cudaErrorCooperativeLaunchTooLarge;
  Params args = p;
  void* argv[] = {&args};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(
          fused_ring_bwd_kernel<T, D, TRACE, STATS, SEG, WIN, WIRE>),
      dim3(p.W * p.G), dim3(NT), argv, smem_size<T, D, SEG>(), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int D, bool TRACE, bool STATS, bool SEG = false,
          bool WIN = false, bool WIRE = false>
cudaError_t attrs(int* out) {
  int max_blocks = 0;
  cudaError_t e =
      setup<T, D, TRACE, STATS, SEG, WIN, WIRE>(&max_blocks);  // smem
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(
      &a, fused_ring_bwd_kernel<T, D, TRACE, STATS, SEG, WIN, WIRE>);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem_size<T, D, SEG>();
  out[3] = max_blocks;
  return cudaSuccess;
}

// the instances without TRACE and STATS, by (SEG, WIN), and the WIRE
// instances (by SEG and WIN)
template <typename T>
cudaError_t setup_plain(bool seg, bool win, int* max_blocks,
                        bool wire = false) {
  if (wire)
    return seg ? (win ? setup<T, 128, false, false, true, true, true>(max_blocks)
                      : setup<T, 128, false, false, true, false, true>(max_blocks))
           : win ? setup<T, 128, false, false, false, true, true>(max_blocks)
                 : setup<T, 128, false, false, false, false, true>(max_blocks);
  if (seg)
    return win ? setup<T, 128, false, false, true, true>(max_blocks)
               : setup<T, 128, false, false, true, false>(max_blocks);
  return win ? setup<T, 128, false, false, false, true>(max_blocks)
             : setup<T, 128, false, false, false, false>(max_blocks);
}
template <typename T>
cudaError_t attrs_plain(bool seg, bool win, int* out, bool wire = false) {
  if (wire)
    return seg ? (win ? attrs<T, 128, false, false, true, true, true>(out)
                      : attrs<T, 128, false, false, true, false, true>(out))
           : win ? attrs<T, 128, false, false, false, true, true>(out)
                 : attrs<T, 128, false, false, false, false, true>(out);
  if (seg)
    return win ? attrs<T, 128, false, false, true, true>(out)
               : attrs<T, 128, false, false, true, false>(out);
  return win ? attrs<T, 128, false, false, false, true>(out)
             : attrs<T, 128, false, false, false, false>(out);
}
template <typename T>
cudaError_t launch_plain(bool seg, bool win, const Params& p,
                         cudaStream_t st) {
  if (p.wire != 0)
    return seg ? (win ? launch<T, 128, false, false, true, true, true>(p, st)
                      : launch<T, 128, false, false, true, false, true>(p, st))
           : win ? launch<T, 128, false, false, false, true, true>(p, st)
                 : launch<T, 128, false, false, false, false, true>(p, st);
  if (seg)
    return win ? launch<T, 128, false, false, true, true>(p, st)
               : launch<T, 128, false, false, true, false>(p, st);
  return win ? launch<T, 128, false, false, false, true>(p, st)
             : launch<T, 128, false, false, false, false>(p, st);
}

}  // namespace

// How many CTAs the card keeps resident at once for this kernel (its SEG
// instance when `seg`, its WIN instance when `win`, its WIRE instance when
// `wire`).
extern "C" int fused_ring_bwd_capacity(int D, int dtype, int seg, int win,
                                       int wire, int* max_blocks) {
  if (D != 128) return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return (int)setup_plain<__nv_bfloat16>(seg, win, max_blocks, wire);
  if (dtype == kFloat32)
    return (int)setup_plain<float>(seg, win, max_blocks, wire);
  return (int)cudaErrorInvalidValue;
}

// One instance's registers a thread, local (spill) bytes a thread, dynamic
// shared memory and resident CTAs on the card: out[0..3].  flags: bit 0
// TRACE (bf16 only), bit 1 STATS (not with TRACE), bit 2 SEG, bit 3 WIN
// (SEG and WIN alone or together, with neither TRACE nor STATS), bit 4
// WIRE (alone or with SEG and WIN, with neither TRACE nor STATS).
extern "C" int fused_ring_bwd_attrs(int dtype, int flags, int* out) {
  const int trace = flags & 1, stats = (flags >> 1) & 1,
            seg = (flags >> 2) & 1, win = (flags >> 3) & 1,
            wire = (flags >> 4) & 1;
  if ((trace && stats) || ((seg || win || wire) && (trace || stats)))
    return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return (int)(trace   ? attrs<__nv_bfloat16, 128, true, false>(out)
                 : stats ? attrs<__nv_bfloat16, 128, false, true>(out)
                         : attrs_plain<__nv_bfloat16>(seg, win, out, wire));
  if (dtype == kFloat32 && !trace)
    return (int)(stats ? attrs<float, 128, false, true>(out)
                       : attrs_plain<float>(seg, win, out, wire));
  return (int)cudaErrorInvalidValue;
}

// seg: null, or every position's ids [W,B,S] int32 (the SEG instances);
// window: 0, or the band of the WIN instances (>= 1); neither with trace
// or slot_use.  wire: 0, or kInt8 / kFp8E4M3 (the WIRE instances: first,
// dO, q the quantized bundle, lse followed by its scales, the home
// outputs wire buffers; wptrs [W][2] the dq wire banks of dq_wslot_bytes
// a slot); not with trace or slot_use.
extern "C" int fused_ring_bwd_launch(
    const void* first, const void* dO, const void* q, const void* lse,
    const void* k, const void* v, const void* ptrs, const void* sched,
    void* folds, void* dk, void* dv, void* trace, int W, int B, int N,
    int Nk, int S, int D, int R, int NB, int MS, int MDQ, int G, int ncol,
    int copy_in0, int copy_in1, int dtype, int resident, int opt,
    void* slot_use, const void* seg, int window, float scale,
    void* stream, int wire, const void* wptrs, long long dq_wslot_bytes) {
  const bool banded = seg != nullptr || window > 0;
  if (N % Nk != 0 || D != 128 || NB < 1 || NB > 2 || G < 1 || MDQ < 1 ||
      window < 0 ||
      (trace != nullptr && (dtype != kBFloat16 || slot_use != nullptr)) ||
      (banded && (trace != nullptr || slot_use != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (wire != 0 &&
      ((wire != kInt8 && wire != kFp8E4M3) || trace != nullptr || slot_use != nullptr || wptrs == nullptr ||
       dq_wslot_bytes % 16 != 0))
    return (int)cudaErrorInvalidValue;
  Params p{first,
           dO,
           q,
           static_cast<const float*>(lse),
           k,
           v,
           static_cast<const long long*>(ptrs),
           static_cast<const int*>(sched),
           static_cast<int*>(folds),
           static_cast<float*>(dk),
           static_cast<float*>(dv),
           W, B, N, Nk, S, R, NB, MS, MDQ, G, ncol,
           {copy_in0, copy_in1},
           resident, opt,
           scale,
           static_cast<long long*>(trace),
           static_cast<int*>(slot_use),
           static_cast<const int*>(seg),
           window,
           wire,
           static_cast<const long long*>(wptrs),
           dq_wslot_bytes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool stats = slot_use != nullptr;
  const bool sg = seg != nullptr, win = window > 0;
  if (dtype == kBFloat16)
    return (int)(trace   ? launch<__nv_bfloat16, 128, true, false>(p, st)
                 : stats ? launch<__nv_bfloat16, 128, false, true>(p, st)
                         : launch_plain<__nv_bfloat16>(sg, win, p, st));
  if (dtype == kFloat32)
    return (int)(stats ? launch<float, 128, false, true>(p, st)
                       : launch_plain<float>(sg, win, p, st));
  return (int)cudaErrorInvalidValue;
}
