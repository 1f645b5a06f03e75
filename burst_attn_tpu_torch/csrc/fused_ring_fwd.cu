// Fused ring forward: the whole R-round ring attention forward of W ring
// positions in ONE launch, driven by a compiled ring program.
//
// Replaces: burst_attn_tpu/ops/fused_ring.py `_fused_fwd_kernel` (l.401,
// called by `fused_ring_fwd`), the Pallas TPU kernel that walks a
// (round, batch, head, q-block) grid on one core, rotates K/V between
// chips with remote DMAs into slot banks guarded by send / recv / credit
// semaphores, and merges every round's online softmax.
//
// Contract: per position p, q [B,N,S,D] and its local k/v [B,Nk,S,D] in
// layout order (stacked [W,...]; GQA: head h reads kv head h / (N/Nk));
// a per-position op table sched [W][R+1][NCOL] int32 (rows 0..R-1: the
// five mask scalars and the program's op columns of
// burst_attn_tpu_torch/parallel/schedule.py plus the need counts below;
// row R: neighbour positions); a table of the positions' slot-bank base
// addresses and flag words.  Outputs o [W,B,N,S,D] in q's dtype and lse
// [W,B,N,S] fp32 (natural log; -inf and o = 0 for rows that see nothing).
//
// Design (Hopper, one card holding every position):
//  * Cooperative persistent grid: G CTAs per position, all co-resident
//    (cudaLaunchCooperativeKernel refuses a grid that is not), so a CTA
//    that spins on another position's progress never holds an SM the
//    awaited CTA needs.  An item is (b, h, 64-row q tile); every item of
//    a round reads that round's consume slot.  RESIDENT: CTA j owns item
//    j for all R rounds.  Otherwise the CTAs take a round's items in
//    increasing order from a per-(position, round) counter (a causal
//    round's q tiles differ in work by up to the number of kv tiles, and
//    a fixed deal left the CTAs of the light ones idle), so round r+1's
//    item x may go to a CTA while another is still folding x in round r:
//    each item has a version word, counted (after a fence) when its
//    round's state is written, and the round r+1 taker waits until it
//    reads r+1 before it reads the state.  A per-item wait, not a wait on
//    the round's done counter: an item's round-r fold is normally long
//    finished when its round r+1 turn comes (both rounds deal in the same
//    order), so nobody waits for the round's slowest CTA.  The wait cannot
//    deadlock: a CTA leaves round r only when all of its items are taken,
//    and their holders are resident and wait on nothing of round r+1.
//  * Rotation follows the table.  At a round's start each CTA copies its
//    1/G share of every send (the chunk's K and V, src slot -> the
//    neighbour's dst slot, through L2), then publishes it: __syncthreads,
//    __threadfence, atomicAdd on the receiver's per-(bank, slot) arrival
//    counter.  A consumer's thread 0 spins with ld.acquire.gpu until the
//    counter reaches need * G (the counters are cumulative; need counts
//    the slot's versions, the local copy-in being version 0).  Slot data
//    is read with ld.global.cg: another CTA rewrites it during the kernel
//    and an SM's L1 could hold a stale line.
//  * Credits: per-(position, bank, slot) counters.  When the last of a
//    position's G CTAs finishes a round (a per-(position, round) done
//    counter: a position's CTAs need not be in the same round), it grants
//    the slot the GRANT column names; a sender whose TAKE flag
//    is set waits until the receiver's grants on the dst slot reach its
//    TAKE need before overwriting it.  Every wait traps after 60 s of
//    %globaltimer: a schedule fault ends the launch with an error, it
//    does not hang the card.
//  * State: when a position has no more items than CTAs (RESIDENT), each
//    CTA keeps its one tile's (m, l, acc) in registers and its Q tile in
//    shared memory across all R rounds.  Otherwise the state of a CTA's
//    several tiles does not fit on chip (at B1 N32 S_local 8192 one
//    position's fp32 state is 134 MB against the card's ~60 MB of
//    registers and shared memory), and it goes to an fp32 scratch between
//    rounds: 2 * 130 * 4 bytes per row and round against 2 * S * D flops
//    per row and round, well under 1% of the kernel's time.  The scratch
//    moves through L2 (ld.global.cg / st.global.cg): the next round's
//    holder of an item may sit on another SM.
//  * The tile (bf16): mma_tile.cuh's WarpTile, four warps x 16 q rows on
//    mma.sync m16n8k16 (S = Q K^T, O += P V, P as two bf16 terms), the Q
//    tile in shared memory as bf16, 64-token K/V chunks of the consume
//    slot double-buffered by cp.async.cg (L2 only), a chunk's copy landing
//    while the previous chunk's products run (mma_tile.cuh's mma_fold,
//    the chunk loop kernel 1's bf16 instance runs too, with the window
//    band on the WIN instances); (o fragments, m, l) stay in registers
//    across the rounds when RESIDENT.  Dead chunks are skipped by the loop bounds of
//    flash::fold, masked columns by the table's five scalars.  The fp32 instance runs kernel 1's SIMT tile (flash_tile.cuh:
//    fp32 in shared memory), so a ring round of it does kernel 1's
//    arithmetic.  FUSED_FWD_TILE_SIMT=1 at build time puts the bf16
//    instance on that tile too (for an A/B of the tile alone; off by
//    default).
//
// What bounds it on an H100: tensor FLOPs (the causal pairs attended:
// 4 * D flops each), e.g. ~35 TFLOP at B1 N32 S65536 D128 against ~2 GB
// of q/k/v/o and slot copies.  The bf16 tile issues 6 * D a pair (P V
// twice) on mma.sync, below wgmma's rate; a TMA producer warp feeding
// wgmma is the next step.
//
// Slot use (STATS, a compile-time flag: the JAX kernel's collect_stats slot
// tally): when a position's round-r consume slot has landed, thread 0 of
// the position's CTA 0 adds one to that position's slot_use[bank][slot]
// (int32 [W][2][kMaxSlots], zeroed by the host): one plain increment in
// global memory with no barrier of its own, as each word has one writer.
// The stats-off instances compile to the code without it.
//
// Packed segments (SEG, another compile-time flag: the JAX kernel's
// `has_seg` with its gathered side table, burst_attn_tpu/ops/fused_ring.py
// `gather_seg_table`): every position's ids in one [W,B,S] int32 table
// (all positions share the card, so nothing is gathered).  Round r of
// position p masks its own q ids against the ids of the partition it
// consumes, which the op table's PART column names: row r sees column c
// only where seg[p][b][r] == seg[part][b][c].  The bf16 tile stages each
// chunk's kv ids beside K and V (mma_fold<false, true>), the fp32 tile
// reads them through the read-only cache (flash::fold's SEG).  Every
// chunk the mask scalars leave is computed; a row that sees nothing of a
// whole round keeps its state.
//
// Sliding window (WIN, a compile-time flag: the JAX kernel's static `wnd`
// band of `_block_has_work` / `_block_full` / `_block_mask`,
// burst_attn_tpu/ops/fused_ring.py l.714-732): a windowed contig ring's
// round r holds the chunk r positions back, its table row the offset
// r * S (masks.round_spec with the window), and the band keeps row i to
// columns above i + offset - window.  Both tiles start their chunk loop
// at the chunk of the first row's band start and skip a chunk the band
// leaves wholly (mma_fold<true>, flash::fold's WIN).  The program itself
// is truncated to the live rounds {0 .. r_live - 1} by the schedule
// compiler (ops/fused_ring.py occupancy_r_live): the dead rounds have no
// send, no consume and no slot traffic at all.  A row whose band ends
// before a live round's chunk keeps its carried state (or lse -inf).
//
// Wire payloads (WIRE, a compile-time flag; the JAX kernel's `wire`
// branch, burst_attn_tpu/ops/fused_ring.py l.678-690 and l.931-937): the
// host quantizes each position's K and V once before the launch
// (parallel/ring.py wire_quantize, an fp32 scale per (batch, kv head)),
// and the slot banks hold that 1-byte payload (int8 or fp8 e4m3, the
// runtime code `wire`) with its scales behind it in the same slot: a slot
// is slot_bytes long (the payload, then the B * Nk scales padded to 16
// bytes), so the scales ride the payload's copies, arrivals and credits
// with no slot of their own.  A round's chunk is dequantized as it is
// staged (deq_tile / load_rows_wire: fp32 times the scale, rounded to T),
// so the tiles compute in T as without WIRE; q is never quantized.  A
// round that consumes the position's own partition (the op table's PART
// column) reads the resident full-precision k_in, v_in instead, as the
// scan ring's self round does: only bytes that cross a link are
// quantized.  WIRE combines with SEG (the kv ids of the consumed
// partition stay full int32 in the side table: only K and V cross a link
// quantized) and with WIN, but has no RESIDENT instance: the WIRE
// instances keep the state in the scratch between rounds whatever the
// item count (half the instances to build; the scratch costs well under
// 1% of a round, see State above).

#include <type_traits>

#include "flash_tile.cuh"
#include "mma_tile.cuh"
#include "ring_sync.cuh"

#ifndef FUSED_FWD_TILE_SIMT
#define FUSED_FWD_TILE_SIMT 0
#endif

namespace {

using namespace bat;
using flash::BQ;
using flash::NT;
using flash::RPT;

// op-table columns (parallel/schedule.py) and the kernel's own need
// columns (ops/fused_ring.py, KERNEL_COLS); tests/test_torch_ring.py
// holds these numbers to those two modules
constexpr int kConsumeBank = 5, kConsumeSlot = 6, kSrcBank0 = 9;
constexpr int kArriveNeed = 19, kPart = 24;
// width of a position's slot_use row per bank (obs/devstats.py MAX_SLOTS)
constexpr int kMaxSlots = 8;
// per send channel ch (0 or 1)
__device__ __forceinline__ int col_send(int ch) { return ch ? 14 : 8; }
__device__ __forceinline__ int col_src_slot(int ch) { return ch ? 15 : 10; }
__device__ __forceinline__ int col_dst_slot(int ch) { return ch ? 16 : 11; }
__device__ __forceinline__ int col_grant(int ch) { return ch ? 17 : 12; }
__device__ __forceinline__ int col_take(int ch) { return ch ? 18 : 13; }
__device__ __forceinline__ int col_src_need(int ch) { return ch ? 21 : 20; }
__device__ __forceinline__ int col_take_need(int ch) { return ch ? 23 : 22; }
__device__ __forceinline__ int meta_dst(int ch) { return ch ? 3 : 1; }
struct Params {
  const void* q;          // [W,B,N,S,D]
  const void* k_in;       // [W,B,Nk,S,D]
  const void* v_in;
  const long long* ptrs;  // [W][2*NB+1]: k bank bases, v bank bases, flags
  const int* sched;       // [W][R+1][NCOL]
  float* st_m;            // [W,B,N,S] base-2 m (scratch, not RESIDENT)
  float* st_l;            // [W,B,N,S] linear l
  float* st_acc;          // [W,B,N,S,D]
  void* o;                // [W,B,N,S,D]
  float* lse;             // [W,B,N,S]
  int W, B, N, Nk, S, R, NB, MS, G, ncol;
  int copy_in[2];         // bank * 16 + slot + 1, or 0
  float scale_log2;
  int* slot_use;          // [W][2][kMaxSlots] consumes (STATS instances)
  const int* seg;         // [W,B,S] packed-sequence ids (SEG instances)
  int window;             // the band (WIN instances; 0 for the others)
  // WIRE instances: every position's packed local chunk of K and of V
  // [W][slot_bytes] (payload, then scales), the wire code, a slot's bytes
  const char* kq_in;
  const char* vq_in;
  int wire;
  long long slot_bytes;
};

// one position's counters: arrive, free [NB][MS]; done [R], items taken
// [R]; per item the rounds whose state is written (not RESIDENT)
struct Flags {
  int* base;
  int NB, MS, R;
  __device__ int* arrive(int bank, int slot) const {
    return base + bank * MS + slot;
  }
  __device__ int* free_(int bank, int slot) const {
    return base + NB * MS + bank * MS + slot;
  }
  __device__ int* done(int round) const {
    return base + 2 * NB * MS + round;
  }
  __device__ int* taken(int round) const {
    return base + 2 * NB * MS + R + round;
  }
  __device__ int* version(int item) const {
    return base + 2 * NB * MS + 2 * R + item;
  }
};

// bf16 runs the tensor-core tile (unless built with FUSED_FWD_TILE_SIMT)
template <typename T>
constexpr bool kMma =
    std::is_same<T, __nv_bfloat16>::value && !FUSED_FWD_TILE_SIMT;

// shared memory of the tensor-core tile: the Q tile, two stages of K, V
// (SEG: and of their kv ids)
constexpr size_t kMmaSmem = sizeof(__nv_bfloat16) * 5 * 64 * kTileLd;
constexpr size_t kSegSmem = sizeof(int) * 2 * kTileChunk;

template <typename T, int D, bool SEG = false>
constexpr size_t smem_size() {
  return kMma<T> ? kMmaSmem + (SEG ? kSegSmem : 0) : flash::smem_bytes<D>();
}

// One q tile's WarpTile state through the fp32 scratch (through L2): the
// warp's rows q0 + 16 w + g (+ 8), m (base 2), l (the quad's sum, kept by
// lane c = 0), the lane's o columns.
__device__ __forceinline__ void mma_load(WarpTile& wt, const float* st_m,
                                         const float* st_l,
                                         const float* st_acc, size_t row0,
                                         int q0, int S) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qr = q0 + 16 * w + g + 8 * hf;
    if (qr >= S) continue;
    const size_t at = row0 + qr;
    wt.m[hf] = __ldcg(st_m + at);
    wt.l[hf] = c == 0 ? __ldcg(st_l + at) : 0.f;
#pragma unroll
    for (int n = 0; n < kTileD / 8; ++n) {
      const float2 a = __ldcg(reinterpret_cast<const float2*>(
          st_acc + at * kTileD + 8 * n + 2 * c));
      wt.o[n][2 * hf] = a.x;
      wt.o[n][2 * hf + 1] = a.y;
    }
  }
}
// the same out, after wt.finish()
__device__ __forceinline__ void mma_store(const WarpTile& wt, float* st_m,
                                          float* st_l, float* st_acc,
                                          size_t row0, int q0, int S) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qr = q0 + 16 * w + g + 8 * hf;
    if (qr >= S) continue;
    const size_t at = row0 + qr;
    if (c == 0) {
      __stcg(st_m + at, wt.m[hf]);
      __stcg(st_l + at, wt.l[hf]);
    }
#pragma unroll
    for (int n = 0; n < kTileD / 8; ++n)
      __stcg(reinterpret_cast<float2*>(st_acc + at * kTileD + 8 * n + 2 * c),
             make_float2(wt.o[n][2 * hf], wt.o[n][2 * hf + 1]));
  }
}

template <typename T, int D, bool RESIDENT, bool STATS, bool SEG, bool WIN,
          bool WIRE>
__global__ void __launch_bounds__(NT) fused_ring_fwd_kernel(const Params p) {
  constexpr bool MMA = kMma<T>;
  constexpr int DC = flash::Rows<D>::DC;
  extern __shared__ float4 smem4[];
  __shared__ int item_slot;
  // fp32 tile: sQ, sK, sV as fp32; bf16 tile: the Q tile, then the stages
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * D;
  float* sV = sK + flash::BKV * (D + 4);
  __nv_bfloat16* mQ = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* mKV = mQ + BQ * kTileLd;

  const int pos = blockIdx.x / p.G, j = blockIdx.x % p.G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = p.S, N = p.N, Nk = p.Nk;
  const int* tab = p.sched + (size_t)pos * (p.R + 1) * p.ncol;
  const int* meta = tab + (size_t)p.R * p.ncol;
  const int np = 2 * p.NB + 1;
  const size_t chunk = (size_t)p.B * Nk * S * D;  // elements of K (or V)
  // a slot's bytes: the chunk in T, or (WIRE) its 1-byte payload and scales
  const size_t bytes = WIRE ? (size_t)p.slot_bytes : chunk * sizeof(T);
  const Flags fl{reinterpret_cast<int*>(p.ptrs[(size_t)pos * np + 2 * p.NB]),
                 p.NB, p.MS, p.R};
  auto kslot = [&](int who, int bank, int slot) {
    if constexpr (WIRE)
      return reinterpret_cast<T*>(
          reinterpret_cast<char*>(p.ptrs[(size_t)who * np + bank]) +
          (size_t)slot * bytes);
    return reinterpret_cast<T*>(p.ptrs[(size_t)who * np + bank]) +
           (size_t)slot * chunk;
  };
  auto vslot = [&](int who, int bank, int slot) {
    if constexpr (WIRE)
      return reinterpret_cast<T*>(
          reinterpret_cast<char*>(p.ptrs[(size_t)who * np + p.NB + bank]) +
          (size_t)slot * bytes);
    return reinterpret_cast<T*>(p.ptrs[(size_t)who * np + p.NB + bank]) +
           (size_t)slot * chunk;
  };

  // the local chunk into its program-designated slot(s): version 0
  const T* k_in = static_cast<const T*>(p.k_in) + (size_t)pos * chunk;
  const T* v_in = static_cast<const T*>(p.v_in) + (size_t)pos * chunk;
  const void* k_src = k_in;
  const void* v_src = v_in;
  if constexpr (WIRE) {
    k_src = p.kq_in + (size_t)pos * bytes;
    v_src = p.vq_in + (size_t)pos * bytes;
  }
  for (int c = 0; c < 2; ++c) {
    if (p.copy_in[c] == 0) continue;
    const int cb = (p.copy_in[c] - 1) / 16, cs = (p.copy_in[c] - 1) % 16;
    copy_share<NT>(k_src, kslot(pos, cb, cs), bytes, j, p.G);
    copy_share<NT>(v_src, vslot(pos, cb, cs), bytes, j, p.G);
    publish(fl.arrive(cb, cs));
  }

  const int nqt = (S + BQ - 1) / BQ;
  const int n_items = p.B * N * nqt;
  const T* q = static_cast<const T*>(p.q) + (size_t)pos * p.B * N * S * D;
  const size_t row_base = (size_t)pos * p.B * N * S;  // state / lse rows
  flash::Rows<D> st;  // fp32 tile
  WarpTile wt;        // bf16 tile

  for (int r = 0; r < p.R; ++r) {
    const int* row = tab + (size_t)r * p.ncol;
    const int cb = row[kConsumeBank], cs = row[kConsumeSlot];

    // ---- sends: this CTA's share of each channel's copy ----
    for (int ch = 0; ch < 2; ++ch) {
      if (!row[col_send(ch)]) continue;
      const int sb = ch == 0 ? row[kSrcBank0] : 1;
      const int ss = row[col_src_slot(ch)], ds = row[col_dst_slot(ch)];
      const int dst = meta[meta_dst(ch)];
      const Flags dfl{
          reinterpret_cast<int*>(p.ptrs[(size_t)dst * np + 2 * p.NB]), p.NB,
          p.MS, p.R};
      if (threadIdx.x == 0) {
        wait_ge(fl.arrive(sb, ss), row[col_src_need(ch)] * p.G);
        // the dst slot is being reused: its readers must have granted it
        if (row[col_take(ch)])
          wait_ge(dfl.free_(ch, ds), row[col_take_need(ch)]);
        __threadfence();
      }
      __syncthreads();
      copy_share<NT>(kslot(pos, sb, ss), kslot(dst, ch, ds), bytes, j, p.G);
      copy_share<NT>(vslot(pos, sb, ss), vslot(dst, ch, ds), bytes, j, p.G);
      publish(dfl.arrive(ch, ds));
    }

    // ---- this round's chunk must have landed ----
    if (threadIdx.x == 0) {
      wait_ge(fl.arrive(cb, cs), row[kArriveNeed] * p.G);
      __threadfence();
      if constexpr (STATS) {
        if (j == 0) p.slot_use[((size_t)pos * 2 + cb) * kMaxSlots + cs] += 1;
      }
    }
    __syncthreads();

    const T* kc = kslot(pos, cb, cs);
    const T* vc = vslot(pos, cb, cs);
    const bool last = r == p.R - 1;
    const int part = SEG ? row[kPart] : 0;  // the consumed partition
    // WIRE: a round of the own partition reads the resident k_in, v_in
    // (code 0); another dequantizes the slot's payload by its scales
    const bool own = WIRE && row[kPart] == pos;
    const int wire = WIRE && !own ? p.wire : 0;
    const float* ksc = reinterpret_cast<const float*>(
        reinterpret_cast<const char*>(kc) + chunk);
    const float* vsc = reinterpret_cast<const float*>(
        reinterpret_cast<const char*>(vc) + chunk);
    if (own) {
      kc = k_in;
      vc = v_in;
    }
    // a (batch, kv head)'s rows: T elements, or payload bytes
    const size_t kv_rows = (size_t)S * D * (wire != 0 ? 1 : sizeof(T));
    for (int it = next_item(fl.taken(r), &item_slot, j, true, RESIDENT,
                            n_items);
         it < n_items; it = next_item(fl.taken(r), &item_slot, j, false,
                                      RESIDENT, n_items)) {
      const int qt = it % nqt, h = (it / nqt) % N, b = it / (nqt * N);
      const int q0 = qt * BQ;
      const size_t bh = (size_t)b * N + h;
      const size_t bhk = (size_t)b * Nk + h / (N / Nk);
      const size_t at0 = row_base + bh * S;  // state / lse row of q row 0
      // SEG: the position's q ids and the consumed partition's kv ids
      const int* qids =
          SEG ? p.seg + ((size_t)pos * p.B + b) * S : nullptr;
      const int* kvids =
          SEG ? p.seg + ((size_t)part * p.B + b) * S : nullptr;
      if (!RESIDENT && r > 0) {  // the item's round r - 1 state is written
        if (threadIdx.x == 0) {
          wait_ge(fl.version(it), r);
          __threadfence();
        }
        __syncthreads();
      }
      if constexpr (MMA) {
        __syncthreads();  // the previous item's readers of the tiles
        if (!RESIDENT || r == 0)
          cp_tile<BQ, NT>(mQ, q + (bh * S + q0) * D, min(BQ, S - q0));
        if (r == 0 || !RESIDENT) wt.init();
        if (r > 0 && !RESIDENT)
          mma_load(wt, p.st_m, p.st_l, p.st_acc, at0, q0, S);
        if constexpr (WIRE)
          mma_fold<WIN, SEG, true>(
              wt, mQ, mKV,
              reinterpret_cast<const __nv_bfloat16*>(
                  reinterpret_cast<const char*>(kc) + bhk * kv_rows),
              reinterpret_cast<const __nv_bfloat16*>(
                  reinterpret_cast<const char*>(vc) + bhk * kv_rows),
              S, S, q0, p.scale_log2, row[0], row[1], row[2], row[3],
              row[4], WIN ? p.window : 0, qids, kvids,
              SEG ? reinterpret_cast<int*>(mKV + 4 * 64 * kTileLd)
                  : nullptr,
              wire, wire ? ksc[bhk] : 1.f, wire ? vsc[bhk] : 1.f);
        else if constexpr (SEG)
          mma_fold<WIN, true>(
              wt, mQ, mKV, kc + bhk * S * D, vc + bhk * S * D, S, S, q0,
              p.scale_log2, row[0], row[1], row[2], row[3], row[4],
              WIN ? p.window : 0, qids, kvids,
              reinterpret_cast<int*>(mKV + 4 * 64 * kTileLd));
        else
          mma_fold<WIN>(wt, mQ, mKV, kc + bhk * S * D, vc + bhk * S * D, S,
                        S, q0, p.scale_log2, row[0], row[1], row[2], row[3],
                        row[4], WIN ? p.window : 0);
        if (!last && RESIDENT) continue;
        wt.finish();
        if (!last) {
          mma_store(wt, p.st_m, p.st_l, p.st_acc, at0, q0, S);
        } else {  // o = acc / l, lse in natural log
          const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
          const int g = lane / 4, c = lane % 4;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int qr = q0 + 16 * w + g + 8 * hf;
            if (qr >= S) continue;
            const size_t at = at0 + qr;
            const float l = wt.l[hf];
            const float inv = (l > 0.f) ? 1.f / l : 0.f;
            if (c == 0)
              p.lse[at] = (l > 0.f) ? wt.m[hf] * kLn2 + logf(l) : neg_inf();
            T* o = static_cast<T*>(p.o) + at * D;
#pragma unroll
            for (int nn = 0; nn < D / 8; ++nn)
              *reinterpret_cast<uint32_t*>(o + 8 * nn + 2 * c) =
                  pack_bf16(wt.o[nn][2 * hf] * inv,
                            wt.o[nn][2 * hf + 1] * inv);
          }
        }
      } else {
        if (!RESIDENT || r == 0) {
          __syncthreads();  // the previous item's readers of sQ are done
          load_rows<T, D, BQ, NT>(q + bh * S * D, q0, S, sQ, D, p.scale_log2);
        }
        if (r == 0 || !RESIDENT) st.init();
        if (r > 0 && !RESIDENT) {
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int qr = q0 + ty * RPT + i;
            if (qr >= S) continue;
            const size_t at = at0 + qr;
            st.m[i] = __ldcg(p.st_m + at);
            st.l[i] = __ldcg(p.st_l + at);
#pragma unroll
            for (int c = 0; c < DC; ++c) {
              const float4 a = __ldcg(reinterpret_cast<const float4*>(
                  p.st_acc + at * D + c * 64 + tx * 4));
              st.acc[i][4 * c] = a.x; st.acc[i][4 * c + 1] = a.y;
              st.acc[i][4 * c + 2] = a.z; st.acc[i][4 * c + 3] = a.w;
            }
          }
        }

        if constexpr (WIRE)
          flash::fold<T, D, true, WIN, SEG, true>(
              st, sQ, sK, sV,
              reinterpret_cast<const T*>(reinterpret_cast<const char*>(kc) +
                                         bhk * kv_rows),
              reinterpret_cast<const T*>(reinterpret_cast<const char*>(vc) +
                                         bhk * kv_rows),
              S, q0, S, row[0], row[1], row[2], row[3], row[4],
              WIN ? p.window : 0, qids, kvids, wire,
              wire ? ksc[bhk] : 1.f, wire ? vsc[bhk] : 1.f);
        else if constexpr (SEG)
          flash::fold<T, D, true, WIN, true>(
              st, sQ, sK, sV, kc + bhk * S * D, vc + bhk * S * D, S, q0, S,
              row[0], row[1], row[2], row[3], row[4], WIN ? p.window : 0,
              qids, kvids);
        else
          flash::fold<T, D, true, WIN>(st, sQ, sK, sV, kc + bhk * S * D,
                                       vc + bhk * S * D, S, q0, S, row[0],
                                       row[1], row[2], row[3], row[4],
                                       WIN ? p.window : 0);

        if (!last && RESIDENT) continue;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int qr = q0 + ty * RPT + i;
          if (qr >= S) continue;
          const size_t at = at0 + qr;
          if (last) {  // fused finalize: o = acc / l, lse in natural log
            const float inv = (st.l[i] > 0.f) ? 1.f / st.l[i] : 0.f;
            if (tx == 0)
              p.lse[at] = (st.l[i] > 0.f) ? st.m[i] * kLn2 + logf(st.l[i])
                                          : neg_inf();
            T* o = static_cast<T*>(p.o) + at * D;
#pragma unroll
            for (int c = 0; c < DC; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                store(o + c * 64 + tx * 4 + e, st.acc[i][4 * c + e] * inv);
          } else {
            if (tx == 0) {
              __stcg(p.st_m + at, st.m[i]);
              __stcg(p.st_l + at, st.l[i]);
            }
#pragma unroll
            for (int c = 0; c < DC; ++c)
              __stcg(reinterpret_cast<float4*>(p.st_acc + at * D + c * 64 +
                                               tx * 4),
                     make_float4(st.acc[i][4 * c], st.acc[i][4 * c + 1],
                                 st.acc[i][4 * c + 2], st.acc[i][4 * c + 3]));
          }
        }
      }
      // the item's round-r state is written: its round r + 1 taker may go
      if (!RESIDENT && !last) publish(fl.version(it));
    }

    // ---- round done: the position's last CTA grants the freed slots ----
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(fl.done(r), 1) == p.G - 1) {
        __threadfence();
        for (int b = 0; b < p.NB && b < 2; ++b)
          if (row[col_grant(b)] > 0)
            atomicAdd(fl.free_(b, row[col_grant(b)] - 1), 1);
      }
    }
  }
}

template <typename T, int D, bool RESIDENT, bool STATS = false,
          bool SEG = false, bool WIN = false, bool WIRE = false>
cudaError_t setup(int* max_blocks) {
  static bool smem_set = false;
  auto kernel = fused_ring_fwd_kernel<T, D, RESIDENT, STATS, SEG, WIN, WIRE>;
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

template <typename T, int D, bool RESIDENT, bool STATS, bool SEG, bool WIN,
          bool WIRE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int max_blocks = 0;
  cudaError_t e =
      setup<T, D, RESIDENT, STATS, SEG, WIN, WIRE>(&max_blocks);
  if (e != cudaSuccess) return e;
  if (p.G * p.W > max_blocks) return cudaErrorCooperativeLaunchTooLarge;
  Params args = p;
  void* argv[] = {&args};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(
          fused_ring_fwd_kernel<T, D, RESIDENT, STATS, SEG, WIN, WIRE>),
      dim3(p.W * p.G), dim3(NT), argv, smem_size<T, D, SEG>(), stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int D, bool RESIDENT, bool STATS, bool SEG, bool WIN,
          bool WIRE>
cudaError_t attrs(int* out) {
  int max_blocks = 0;
  cudaError_t e = setup<T, D, RESIDENT, STATS, SEG, WIN, WIRE>(
      &max_blocks);  // smem limit
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(
      &a, fused_ring_fwd_kernel<T, D, RESIDENT, STATS, SEG, WIN, WIRE>);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem_size<T, D, SEG>();
  out[3] = max_blocks;
  return cudaSuccess;
}

// the instances: (SEG, WIN) x (STATS) x (RESIDENT), and WIRE by (SEG, WIN)
// x (STATS) without RESIDENT
template <typename T, int D, bool STATS, bool SEG, bool WIN, bool WIRE>
cudaError_t dispatch_state(int resident, const Params& p, cudaStream_t st) {
  if constexpr (WIRE)
    return resident ? cudaErrorInvalidValue
                    : launch<T, D, false, STATS, SEG, WIN, WIRE>(p, st);
  else
    return resident ? launch<T, D, true, STATS, SEG, WIN, WIRE>(p, st)
                    : launch<T, D, false, STATS, SEG, WIN, WIRE>(p, st);
}

template <typename T, int D, bool SEG, bool WIN, bool WIRE>
cudaError_t dispatch_stats(int resident, const Params& p, cudaStream_t st) {
  return p.slot_use != nullptr
             ? dispatch_state<T, D, true, SEG, WIN, WIRE>(resident, p, st)
             : dispatch_state<T, D, false, SEG, WIN, WIRE>(resident, p, st);
}

template <typename T, int D>
cudaError_t dispatch_flags(int resident, const Params& p, cudaStream_t st) {
  const bool seg = p.seg != nullptr, win = p.window > 0;
  if (p.wire != 0) {
    if (seg)
      return win ? dispatch_stats<T, D, true, true, true>(resident, p, st)
                 : dispatch_stats<T, D, true, false, true>(resident, p, st);
    return win ? dispatch_stats<T, D, false, true, true>(resident, p, st)
               : dispatch_stats<T, D, false, false, true>(resident, p, st);
  }
  if (seg)
    return win ? dispatch_stats<T, D, true, true, false>(resident, p, st)
               : dispatch_stats<T, D, true, false, false>(resident, p, st);
  return win ? dispatch_stats<T, D, false, true, false>(resident, p, st)
             : dispatch_stats<T, D, false, false, false>(resident, p, st);
}

template <int D>
cudaError_t dispatch(int dtype, int resident, const Params& p,
                     cudaStream_t st) {
  if (dtype == kBFloat16)
    return dispatch_flags<__nv_bfloat16, D>(resident, p, st);
  if (dtype == kFloat32) return dispatch_flags<float, D>(resident, p, st);
  return cudaErrorInvalidValue;
}

template <typename T, bool RESIDENT, bool SEG, bool WIN, bool WIRE>
cudaError_t attrs_stats(int stats, int* out) {
  return stats ? attrs<T, 128, RESIDENT, true, SEG, WIN, WIRE>(out)
               : attrs<T, 128, RESIDENT, false, SEG, WIN, WIRE>(out);
}

template <typename T, bool RESIDENT>
cudaError_t attrs_of(int stats, int seg, int win, int wire, int* out) {
  if (wire) {
    if (RESIDENT) return cudaErrorInvalidValue;
    if (seg)
      return win ? attrs_stats<T, false, true, true, true>(stats, out)
                 : attrs_stats<T, false, true, false, true>(stats, out);
    return win ? attrs_stats<T, false, false, true, true>(stats, out)
               : attrs_stats<T, false, false, false, true>(stats, out);
  }
  if (seg)
    return win ? attrs_stats<T, RESIDENT, true, true, false>(stats, out)
               : attrs_stats<T, RESIDENT, true, false, false>(stats, out);
  return win ? attrs_stats<T, RESIDENT, false, true, false>(stats, out)
             : attrs_stats<T, RESIDENT, false, false, false>(stats, out);
}

template <typename T, bool SEG, bool WIN, bool WIRE>
cudaError_t capacity_of(int* max_blocks) {
  if constexpr (WIRE) {  // the scratch state only
    return setup<T, 128, false, false, SEG, WIN, WIRE>(max_blocks);
  } else {
    int a = 0, b = 0;
    cudaError_t e;
    if ((e = setup<T, 128, true, false, SEG, WIN, WIRE>(&a)) != cudaSuccess)
      return e;
    if ((e = setup<T, 128, false, false, SEG, WIN, WIRE>(&b)) != cudaSuccess)
      return e;
    *max_blocks = a < b ? a : b;
    return cudaSuccess;
  }
}

template <typename T>
cudaError_t capacity_flags(int seg, int win, int wire, int* max_blocks) {
  if (wire) {
    if (seg)
      return win ? capacity_of<T, true, true, true>(max_blocks)
                 : capacity_of<T, true, false, true>(max_blocks);
    return win ? capacity_of<T, false, true, true>(max_blocks)
               : capacity_of<T, false, false, true>(max_blocks);
  }
  if (seg)
    return win ? capacity_of<T, true, true, false>(max_blocks)
               : capacity_of<T, true, false, false>(max_blocks);
  return win ? capacity_of<T, false, true, false>(max_blocks)
             : capacity_of<T, false, false, false>(max_blocks);
}

}  // namespace

// One instance's registers a thread, local (spill) bytes a thread, dynamic
// shared memory and resident CTAs on the card: out[0..3].  flags: bit 0
// RESIDENT, bit 1 STATS, bit 2 SEG, bit 3 WIN, bit 4 WIRE (not with
// RESIDENT).
extern "C" int fused_ring_fwd_attrs(int dtype, int flags, int* out) {
  const int resident = flags & 1, stats = (flags >> 1) & 1,
            seg = (flags >> 2) & 1, win = (flags >> 3) & 1,
            wire = (flags >> 4) & 1;
  if (dtype == kBFloat16)
    return (int)(resident ? attrs_of<__nv_bfloat16, true>(stats, seg, win,
                                                          wire, out)
                          : attrs_of<__nv_bfloat16, false>(stats, seg, win,
                                                           wire, out));
  if (dtype == kFloat32)
    return (int)(resident
                     ? attrs_of<float, true>(stats, seg, win, wire, out)
                     : attrs_of<float, false>(stats, seg, win, wire, out));
  return (int)cudaErrorInvalidValue;
}

// How many CTAs the card keeps resident at once for this kernel (both
// state modes have the same footprint up to registers; the smaller wins),
// of the SEG instances when `seg`, of the WIN instances when `win`, of the
// WIRE instances when `wire`.
extern "C" int fused_ring_fwd_capacity(int D, int dtype, int seg, int win,
                                       int wire, int* max_blocks) {
  if (D != 128) return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return (int)capacity_flags<__nv_bfloat16>(seg, win, wire, max_blocks);
  if (dtype == kFloat32)
    return (int)capacity_flags<float>(seg, win, wire, max_blocks);
  return (int)cudaErrorInvalidValue;
}

// seg: null, or every position's ids [W,B,S] int32 (the SEG instances);
// window: 0, or the band of the WIN instances (>= 1); wire: 0, or kInt8 /
// kFp8E4M3 with the positions' packed quantized chunks kq_in, vq_in of
// slot_bytes each (the WIRE instances; k_in, v_in stay the full-precision
// chunks the own-partition round reads)
extern "C" int fused_ring_fwd_launch(
    const void* q, const void* k_in, const void* v_in, const void* ptrs,
    const void* sched, void* st_m, void* st_l, void* st_acc, void* o,
    void* lse, int W, int B, int N, int Nk, int S, int D, int R, int NB,
    int MS, int G, int ncol, int copy_in0, int copy_in1, int dtype,
    int resident, void* slot_use, const void* seg, int window, float scale,
    void* stream, const void* kq_in, const void* vq_in, int wire,
    long long slot_bytes) {
  if (N % Nk != 0 || D != 128 || NB < 1 || NB > 2 || G < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (wire != 0 && (wire != kInt8 && wire != kFp8E4M3))
    return (int)cudaErrorInvalidValue;
  if (wire != 0 &&
      (kq_in == nullptr || vq_in == nullptr || slot_bytes % 16 != 0 ||
       slot_bytes < (long long)B * Nk * S * D + 4LL * B * Nk))
    return (int)cudaErrorInvalidValue;
  Params p{q,
           k_in,
           v_in,
           static_cast<const long long*>(ptrs),
           static_cast<const int*>(sched),
           static_cast<float*>(st_m),
           static_cast<float*>(st_l),
           static_cast<float*>(st_acc),
           o,
           static_cast<float*>(lse),
           W, B, N, Nk, S, R, NB, MS, G, ncol,
           {copy_in0, copy_in1},
           scale * kLog2e,
           static_cast<int*>(slot_use),
           static_cast<const int*>(seg),
           window,
           static_cast<const char*>(kq_in),
           static_cast<const char*>(vq_in),
           wire,
           slot_bytes};
  return (int)dispatch<128>(dtype, resident, p,
                            static_cast<cudaStream_t>(stream));
}
