// Decode attention for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes: the "tc" route of ops/decode_attention.py, bf16 at
// head_dim 64 or 128 with up to 16 query heads a KV head, and over an int8
// cache the "tc8" route (decode_attention_tc_q8, below). The CUDA-core
// kernel of decode_attention.cu stays as the "simt" route (f32, head_dim
// 16 and 32) and, over an int8 cache, the "q8" route.
//
// A kernel of the port alone: it replaces no Pallas kernel. The JAX package
// computes decode attention in `_attend_cache`
// (tpu_kubernetes/models/decode.py:150-197), and for the paged cache first
// gathers each row's pages into a virtual dense row (`virtual` in
// `decode_step_paged`, :1270-1313); XLA fuses the gather, the f32 casts and
// the two einsums inside the jitted step.
//
// Computes what decode_attention.cu computes (its header says it in full):
// for a chunk of c <= MAX_CHUNK query positions a row (c = 1 is a decode
// step, c = k + 1 a speculative verify window), query head g * rep + r at
// chunk position j attends KV head g's positions p < limits[row, j], less
// the pad gap [prompt_lengths[row], prompt_slots) of a ragged row, with f32
// scores scaled by sm_scale, an f32 softmax and f32 sums of P.V, and o
// written once in bf16; the cache is dense (b, kv, S, d) or one pool layer
// (n_pages + 1, kv, page_size, d) read through a (b, max_pages) page table.
//
// Bound: bytes. Each admitted position's K and V rows are read once for the
// whole group of query heads; the work per byte (2 * rep flops a K or V
// value) is far below the card's ratio. What the design does about it:
//
// * one launch. A cluster of CLUSTER blocks takes one (row, KV head, column
//   group). A column is one (query head, chunk position) pair of the KV
//   head's rep * c; a group is at most 16 of them (more go on the grid's y
//   axis beside the KV heads: llama-1b's verify window of 9 at rep 2 is two
//   groups), so O^T's registers cost what 16 heads cost at c = 1. The
//   group's admitted positions, in 64-position tiles (whole tiles of [0,
//   prompt_lengths) and of [prompt_slots, limit), limit the largest of the
//   group's columns', worked out on the device from the row's own limits
//   and gap), are shared out in CLUSTER contiguous
//   runs; a block with no tile skips to the merge, so a row of a few
//   hundred positions costs a few tiles and not the span. Each block merges
//   its warps' partials, then the blocks merge theirs through
//   distributed shared memory, each block a slice of d, in rank order: no
//   partial goes to global memory and no second kernel runs;
// * bytes in flight from one producer warp. Tiles come by TMA (4-D tensor
//   maps, 128-byte swizzle) into a ring of STAGES stages completed on
//   mbarriers, K and V of a tile together: a dense tile is one box a
//   128-byte chunk of d; a paged tile one box a page (a page of 16
//   positions at d 128 is 4 KB, contiguous in the pool), and a paged box
//   whose positions are all masked, or past the table, is not loaded;
// * the tensor cores, with the positions on M: each of four consumer warps
//   takes 16 positions of a tile and computes S^T = K . q^T with mma.sync
//   m16n8k16 (the K rows by ldmatrix, the group's query rows, zero-padded
//   to 8 or 16 columns, as B fragments held in registers for the whole
//   call), then an online softmax down each column (shuffles across the 8
//   lanes
//   that share it), P^T through movmatrix straight into the B fragment of
//   O^T += V^T . P^T (V^T by ldmatrix.trans). P is rounded to bf16, the
//   sums stay f32. A wide group costs no more loads than a narrow one, and
//   no per-head register accumulators beyond O^T's fragments;
// * masked positions: their scores are set to -inf before the max (a
//   select, so a stale or NaN K row changes nothing), each column past its
//   own limit too; a column with no admitted position yet keeps max -inf
//   and weighs nothing. In a warp's 16 positions that mix admitted and
//   masked ones, the V rows masked for every column of the group are
//   zeroed in shared memory first (P is 0 there, and 0 * NaN is not); a
//   position some column admits lies below that column's limit, so this
//   chunk or an earlier one wrote it and its V row holds real data.
//
// The int8 route (`decode_attention_tc_q8`, kernel
// `decode_attention_tc_q8_kernel`) is the same kernel over the int8 cache of
// `kv_quant` (the reference's `_attend_cache` with `k_scale`/`v_scale`,
// decode.py:167-169, 193-195): the body below is templated on the cache's
// storage type, and the bf16 instantiation is the code above. Its bytes a
// position are 2 (d + 4) in place of 4 d; on the CUDA cores
// (decode_attention.cu's q8) it paid the simt kernel's split and merge. For
// int8 (Q8 in the body):
//
// * K/V rows are d bytes; tiles come by TMA as before (d 128: a 128-byte
//   swizzled row; d 64: plain 64-byte rows, and a page of one position, a
//   box TMA cannot place, by cp.async) into a 48 KB ring (3 stages at d
//   128, 6 at d 64). A tile's scales (a position and KV head each, f32)
//   come on the same mbarrier: by TMA beside each box of 8 positions or
//   more, else by cp.async from the producer's lanes
//   (cp.async.mbarrier.arrive);
// * K is the A operand as before, its pairs of consecutive d widened to
//   bf16 exactly (hopper::i8_pairs_within; the d order of the contraction
//   is permuted, and q's B fragments follow it). The position's k_scale
//   multiplies its row of S^T after the MMA, so the sums run in another
//   order than the reference's (k * s) . q;
// * V^T as A needs pairs of consecutive positions of one d, d bytes apart:
//   a lane reads d / 8 bytes of each of four position rows and builds the
//   pairs with byte permutes (hopper::i8_pairs_across); O^T's rows are d in
//   that permuted order (red8 spreads them over the banks when the warps'
//   partials are stored). v_scale multiplies P before P is rounded to bf16;
// * a masked position's P and K row are selected away, never multiplied by
//   its scale: an unwritten pool page's scales may be anything, NaN
//   included. int8 K/V hold no NaN, so no V row is zeroed; a consumer warp
//   fences its reads of a stage (the generic proxy) before releasing it to
//   the producer's next TMA write (the async proxy).
//
// Built with -DDECODE_ATTENTION_TRACE (decode_attention_trace.py), each
// block stamps %globaltimer at the phases above, for a timeline of a launch.
//
// Determinism: the tiles, their split over the cluster, a warp's positions
// and every merge order follow from the row's own limits and gap alone (not
// the batch, the layout, the span or the other rows); there are no float
// atomics. Dense and paged rows give the same bits, and so do two replays.
// Every column must leave at least one position unmasked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

#ifdef DECODE_ATTENTION_TRACE
// decode_attention_trace.py's build: %globaltimer (ns) at phase k of
// block b, stamped by thread `who`, at [b * TRACE_PHASES + k]
constexpr int TRACE_BLOCKS = 8192, TRACE_PHASES = 9;
__device__ unsigned long long g_trace[TRACE_BLOCKS * TRACE_PHASES];
#define TRACE(k, who)                                                     \
  do {                                                                    \
    const unsigned b = blockIdx.x + gridDim.x * (blockIdx.y +             \
                                                 gridDim.y * blockIdx.z); \
    if (threadIdx.x == (who) && b < TRACE_BLOCKS) {                       \
      unsigned long long t;                                               \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));              \
      g_trace[b * TRACE_PHASES + (k)] = t;                                \
    }                                                                     \
  } while (0)
#else
#define TRACE(k, who) \
  do {                \
  } while (0)
#endif

// Four blocks a cluster and a 64 KB ring: three blocks an SM, so llama-1b's
// 8 rows x 8 KV heads (256 blocks) fit the card in one wave
constexpr int CLUSTER = 4;                // blocks a (row, KV head)
constexpr int CONSUMERS = 4;              // warps, 16 positions a tile each
constexpr int T = 16 * CONSUMERS;         // positions a tile (a ring stage)
constexpr int NT = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int RING_BYTES = 64 * 1024;
constexpr int MAX_REP = 16;               // query heads a KV head
constexpr int MAX_CHUNK = 16;             // query positions a row
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;               // (b, h, c, d) contiguous
  __nv_bfloat16* o;                     // like q
  const long long* limits;              // [row * limits_stride + j * c_stride]
  long long limits_stride, c_stride;
  const int* prompt_lengths;            // (b,) or null: no pad gap
  const int* prompt_slots;              // (b,) or null: the scalar below
  int prompt_slots_scalar;
  const int* table;                     // (b, max_pages) or null: dense
  int max_pages;
  int page_size;
  int h, kv, span;
  int c, groups;                        // chunk positions; column groups
  float scale_log2;                     // sm_scale * log2(e)
  // the int8 route: k/v rows (for cp.async) and their scales, a position's
  // at [row or page] * s0 + g * s1 + (p or p % page_size) * s2, elements
  const int8_t* k;
  const int8_t* v;
  long long ks0, ks1, ks2, vs0, vs1, vs2;
  const float* k_scale;
  const float* v_scale;
  long long kss0, kss1, kss2, vss0, vss1, vss2;
  int scale_tma;                        // scales by TMA (else cp.async)
};

template <int D, int NB>
struct Smem {
  static constexpr int CH = D / hopper::CHUNK;      // 128-byte chunks a row
  static constexpr int TILE = T * D * 2;            // a K or a V tile
  static constexpr int STAGE = 2 * TILE;            // K, then V
  static constexpr int STAGES = RING_BYTES / STAGE; // d 128: 2, d 64: 4
  static constexpr int HEADS = 8 * NB;              // columns, padded
  // the block's partial, which the cluster reads: m, l [HEADS], acc [HEADS][D]
  static constexpr int PART_OFF = STAGES * STAGE;
  static constexpr int PART_BYTES = 4 * HEADS * (D + 2);
  // full[STAGES], empty[STAGES]
  static constexpr int BAR_OFF = PART_OFF + PART_BYTES;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;  // 1024: align
  // the warps' partials, laid over the drained ring
  static_assert(CONSUMERS * 4 * HEADS * (D + 2) <= PART_OFF, "ring");
  static_assert(STAGES >= 2, "ring");
};

// the int8 cache's: K and V tiles of T rows of D bytes, then the stages'
// scales, [STAGES][2][SCALES] f32 (k_scale, v_scale): a box of `rows`
// positions' at slot (box) * pitch, pitch = rows, or 32 (128 bytes, where a
// TMA destination is aligned) for a box of 8 or 16 by TMA
constexpr int RING8_BYTES = 48 * 1024;
constexpr int SCALES = 4 * T;           // f32 a stage's K (or V) scales take
constexpr int SCALE_TMA_ROWS = 8;       // scales by TMA from boxes this long
template <int D, int NB>
struct Smem8 {
  static constexpr int TILE = T * D;                // a K or a V tile
  static constexpr int STAGE = 2 * TILE;            // K, then V
  static constexpr int STAGES = RING8_BYTES / STAGE;  // d 128: 3, d 64: 6
  static constexpr int HEADS = 8 * NB;
  static constexpr int SCALE_OFF = STAGES * STAGE;
  static constexpr int PART_OFF = SCALE_OFF + STAGES * 2 * SCALES * 4;
  static constexpr int PART_BYTES = 4 * HEADS * (D + 2);
  static constexpr int BAR_OFF = PART_OFF + PART_BYTES;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
  static_assert(CONSUMERS * 4 * HEADS * (D + 2) <= SCALE_OFF, "ring");
  static_assert(STAGES >= 2, "ring");
};

// a column group's admitted positions: p < lim (the largest of its
// columns' limits), outside [glo, ghi); its tiles are [0, n_a) and then
// from b_start on, n in all
struct Row {
  int lim, glo, ghi, n_a, b_start, n;

  __device__ __forceinline__ bool admitted(int p) const {
    return p < lim && !(p >= glo && p < ghi);
  }
  __device__ __forceinline__ int tile(int j) const {
    return j < n_a ? j : b_start + (j - n_a);
  }
};

// chunk position j's limit of a row, clamped into [0, span]
__device__ __forceinline__ int col_limit(const Args& a, int row, int j) {
  const long long lim = a.limits[row * a.limits_stride + j * a.c_stride];
  return static_cast<int>(lim < 0 ? 0 : lim < a.span ? lim : a.span);
}

// the group's columns are [col0, col0 + ncols) of the KV head's rep * c,
// column r * c + j being query head r at chunk position j
template <bool MULTI>
__device__ __forceinline__ Row plan_row(const Args& a, int row, int col0,
                                        int ncols) {
  Row r;
  if constexpr (MULTI) {
    r.lim = 0;
    // the group's chunk positions: all c of them once ncols >= c
    for (int i = 0; i < (ncols < a.c ? ncols : a.c); ++i) {
      const int l = col_limit(a, row, (col0 + i) % a.c);
      r.lim = l > r.lim ? l : r.lim;
    }
  } else {
    r.lim = col_limit(a, row, 0);
  }
  r.glo = r.ghi = 0;
  if (a.prompt_lengths != nullptr) {
    r.glo = a.prompt_lengths[row];
    r.ghi = a.prompt_slots != nullptr ? a.prompt_slots[row]
                                      : a.prompt_slots_scalar;
  }
  const int all = (r.lim + T - 1) / T;
  if (r.glo < r.ghi && r.glo < r.lim) {
    r.n_a = (r.glo + T - 1) / T;
    r.b_start = r.ghi / T > r.n_a ? r.ghi / T : r.n_a;
    r.n = r.n_a + (r.ghi < r.lim && all > r.b_start ? all - r.b_start : 0);
  } else {
    r.n_a = r.b_start = r.n = all;
  }
  return r;
}

// the byte offset of 16-byte unit `unit` of tile row `pos` (128-byte
// swizzle: chunks of T rows, the unit XOR the row's low three bits)
__device__ __forceinline__ uint32_t swz(int pos, int unit) {
  return static_cast<uint32_t>((unit >> 3) * T * 128 + pos * 128 +
                               (((unit & 7) ^ (pos & 7)) << 4));
}

// the byte offset of 16-byte unit `unit` of an int8 tile's row `pos`: a
// d 128 row is one 128-byte swizzled chunk, a d 64 row plain 64 bytes
template <int D>
__device__ __forceinline__ uint32_t row8(int pos, int unit) {
  return D == 128 ? swz(pos, unit)
                  : static_cast<uint32_t>(pos * 64 + unit * 16);
}

// The int8 producer's stage k of a tile at position p0 of row `row`, KV head
// g: once the consumers have released the stage (round > 0), the K and V
// boxes of `rows` positions that the `lo`/`hi` ballots mark needed (a lane
// boxes lane and lane + 32), by TMA (or, when a box is under the 128 bytes
// a TMA destination is aligned to, a page of one position at d 64, by
// cp.async), and the scales of their positions inside the span by cp.async
// (a lane positions lane and lane + 32, whose pages come from the lanes of
// their boxes by shuffle: one table read a box), or, for boxes of at least
// SCALE_TMA_ROWS positions with 16-byte aligned strides, by TMA beside the
// box's K and V (a box's at slot j * pitch). The stage's mbarrier
// counts every lane's
// cp.async and the TMA bytes: the boxes' bytes may land before lane 0
// arms it with them, which its own pending arrival keeps open
template <int D>
__device__ __forceinline__ void produce8(
    const Args& a, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap* tm_ks, const CUtensorMap* tm_vs, uint8_t* stage,
    float* scales, uint64_t* full, uint64_t* empty, int round, int row,
    int g, const int* tab, int p0, int rows, int pitch, unsigned lo,
    unsigned hi, int lane) {
  constexpr int TILE = T * D;
  const bool paged = tab != nullptr;
  const bool small = rows * D < 128;
  const int boxes = T / rows;
  auto needed = [&](int j) { return ((j < 32 ? lo : hi) >> (j & 31)) & 1u; };
  int box_page[2], pos_page[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    box_page[h] = paged && j < boxes && needed(j)
                      ? __ldg(tab + (p0 + j * rows) / a.page_size) : 0;
  }
  // position i lies in box i / rows: under 32 boxes (rows >= 2), lane
  // i / rows's first; at rows 1, this lane's own
#pragma unroll
  for (int h = 0; h < 2; ++h)
    pos_page[h] = rows == 1 ? box_page[h]
                            : __shfl_sync(0xffffffffu, box_page[0],
                                          (lane + 32 * h) / rows);
  if (lane == 0 && round > 0) hopper::mbar_wait(empty, (round - 1) & 1);
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h, p = p0 + j * rows;
    if (small || j >= boxes || !needed(j)) continue;
    uint8_t* dst = stage + j * rows * D;
    const int at_p = paged ? p % a.page_size : p;
    const int at_r = paged ? box_page[h] : row;
    hopper::tma_load_4d(dst, &tm_k, full, 0, at_p, g, at_r);
    hopper::tma_load_4d(dst + TILE, &tm_v, full, 0, at_p, g, at_r);
    if (a.scale_tma) {
      hopper::tma_load_3d(scales + j * pitch, tm_ks, full, at_p, g, at_r);
      hopper::tma_load_3d(scales + SCALES + j * pitch, tm_vs, full, at_p, g,
                          at_r);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h, p = p0 + i;
    if (!needed(i / rows) || p >= a.span) continue;
    // a position's element offset at strides (s0, s1, s2)
    auto at = [&](long long s0, long long s1, long long s2) {
      return paged ? pos_page[h] * s0 + g * s1 + (p % a.page_size) * s2
                   : row * s0 + g * s1 + p * s2;
    };
    if (!a.scale_tma) {
      const int slot = (i / rows) * pitch + i % rows;
      hopper::cp_async_4(scales + slot,
                         a.k_scale + at(a.kss0, a.kss1, a.kss2));
      hopper::cp_async_4(scales + SCALES + slot,
                         a.v_scale + at(a.vss0, a.vss1, a.vss2));
    }
    if (small)
#pragma unroll
      for (int u = 0; u < D / 16; ++u) {
        hopper::cp_async_16(stage + i * D + 16 * u,
                            a.k + at(a.ks0, a.ks1, a.ks2) + 16 * u);
        hopper::cp_async_16(stage + TILE + i * D + 16 * u,
                            a.v + at(a.vs0, a.vs1, a.vs2) + 16 * u);
      }
  }
  // every lane's cp.async counted before lane 0's arrival arms the phase
  hopper::cp_async_mbar_arrive(full);
  __syncwarp();
  if (lane == 0)
    hopper::mbar_arrive_expect_tx(
        full, small ? 0u
                    : static_cast<uint32_t>(2 * (__popc(lo) + __popc(hi)) *
                                            rows * (D + (a.scale_tma ? 4 : 0))));
}

// where d sits in an int8 block's row of warp partials: O^T's d are
// gq * D / 8 + 2 mb (+ 1), so the 8 lanes gq of one store would share two
// banks; a XOR of d's bits 2..3 (d 64: bit 2) by gq's upper bits spreads
// them over eight (a permutation within each gq's D / 8 values)
template <int D>
__device__ __forceinline__ int red8(int d) {
  const int gq = d / (D / 8);
  return d ^ (D == 128 ? 4 * (gq >> 1) : 4 * (gq >> 2));
}

// slots a box of `rows` positions' scales take in a stage (see Smem8)
__device__ __forceinline__ int scale_pitch(const Args& a, int rows) {
  return a.scale_tma && rows < 32 ? 32 : rows;
}

// KT: the cache's storage type, bf16 or int8 (Q8). MULTI: more than one
// query position a row (c > 1), so each column masks past its own limit;
// c = 1 (a decode step) compiles without that mask
template <typename KT, int D, int NB, bool MULTI>
__device__ __forceinline__ void attend_tc(const CUtensorMap& tm_k,
                                          const CUtensorMap& tm_v,
                                          const Args& a,
                                          const CUtensorMap* tm_ks = nullptr,
                                          const CUtensorMap* tm_vs = nullptr) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  using L = std::conditional_t<Q8, Smem8<D, NB>, Smem<D, NB>>;
  constexpr int S = L::STAGES, HEADS = L::HEADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + S;
  float* part_m = reinterpret_cast<float*>(smem + L::PART_OFF);
  float* part_l = part_m + HEADS;
  float* part_acc = part_l + HEADS;

  const int rank = static_cast<int>(hopper::cluster_ctarank());
  const int g = MULTI ? blockIdx.y / a.groups : blockIdx.y, row = blockIdx.z;
  const int rep = a.h / a.kv;
  // this group's columns: [col0, col0 + ncols) of the KV head's rep * c
  // (at c = 1 the group is the KV head's query heads)
  const int npos = MULTI ? a.c : 1;     // chunk positions a row
  const int col0 = MULTI ? (blockIdx.y % a.groups) * HEADS : 0;
  const int ncols =
      rep * npos - col0 < HEADS ? rep * npos - col0 : HEADS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the producer's first lane sets up the ring while the row loads
  if (tid == CONSUMERS * 32) {
    hopper::prefetch_tensor_map(&tm_k);
    hopper::prefetch_tensor_map(&tm_v);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  const Row rw = plan_row<MULTI>(a, row, col0, ncols);
  const int j0 = rank * rw.n / CLUSTER, n_mine = (rank + 1) * rw.n / CLUSTER - j0;
  TRACE(0, 0);
  // the consumers wait for the ring's barriers; the producer goes on
  if (warp == CONSUMERS) {
    __syncwarp();
    hopper::named_barrier_arrive(1, NT);
  } else {
    hopper::named_barrier_sync(1, NT);
  }
  TRACE(1, 0);

  // a consumer lane's O^T (d x columns): rows 16 mb + gq (and + 8),
  // columns 8 nb + 2 t4 (+ 1); its running max (base 2) and its share of
  // the sum
  const int gq = lane / 4, t4 = lane % 4;
  float acc[D / 16][NB][4], m[NB][2], l[NB][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int mb = 0; mb < D / 16; ++mb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][nb][i] = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[nb][e] = -INFINITY;
      l[nb][e] = 0.f;
    }
  }

  if (warp == CONSUMERS) {
    // -- producer: a lane a TMA box ------------------------------------------
    const bool paged = a.table != nullptr;
    const int rows = paged && a.page_size < T ? a.page_size : T;  // a box
    const int boxes = T / rows;                  // boxes a tile and chunk
    const int* tab = paged ? a.table + static_cast<long long>(row) * a.max_pages
                           : nullptr;
    for (int k = 0; k < n_mine; ++k) {
      const int s = k % S, round = k / S;
      const int p0 = rw.tile(j0 + k) * T;
      // a box is loaded if one of its positions is admitted and it lies in
      // the table; a dense tile is one box, and it holds an admitted one
      auto needed = [&](int j) {
        const int p = p0 + j * rows;
        return j < boxes && (!paged || (p < rw.lim && p < a.span &&
                                        !(p >= rw.glo && p + rows <= rw.ghi)));
      };
      const unsigned lo = __ballot_sync(0xffffffffu, needed(lane));
      const unsigned hi = __ballot_sync(0xffffffffu, needed(lane + 32));
      if constexpr (Q8) {
        produce8<D>(a, tm_k, tm_v, tm_ks, tm_vs, smem + s * L::STAGE,
                    reinterpret_cast<float*>(smem + L::SCALE_OFF) +
                        s * 2 * SCALES,
                    &full[s], &empty[s], round, row, g, tab, p0, rows,
                    scale_pitch(a, rows), lo, hi, lane);
      } else {
        if (lane == 0) {
          if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
          hopper::mbar_arrive_expect_tx(
              &full[s], static_cast<uint32_t>(2 * L::CH * (__popc(lo) + __popc(hi))
                                              * rows * 128));
        }
        __syncwarp();
        for (int i = lane; i < 2 * L::CH * boxes; i += 32) {
          const int v = i / (L::CH * boxes), c = (i / boxes) % L::CH;
          const int j = i % boxes;
          if (!(((j < 32 ? lo : hi) >> (j & 31)) & 1u)) continue;
          uint8_t* dst = smem + s * L::STAGE + v * L::TILE + c * T * 128 +
                         j * rows * 128;
          const CUtensorMap* tm = v ? &tm_v : &tm_k;
          const int p = p0 + j * rows;
          if (paged)
            hopper::tma_load_4d(dst, tm, &full[s], c * hopper::CHUNK,
                                p % a.page_size, g, __ldg(tab + p / a.page_size));
          else
            hopper::tma_load_4d(dst, tm, &full[s], c * hopper::CHUNK, p, g, row);
        }
      }
      if (k == 0) TRACE(2, CONSUMERS * 32);
    }
  } else {
    // -- consumers: 16 positions of each tile a warp ---------------------------
    // q^T as B fragments: k = d (16 a step), n = the group's columns,
    // padded; a column's rows are contiguous in q (b, h, c, d)
    uint32_t qf[D / 16][NB][2];
    const __nv_bfloat16* qg =
        a.q + ((static_cast<long long>(row) * a.h + g * rep) * npos + col0) *
                  D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int col = 8 * nb + gq;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        if constexpr (Q8) {
          // the int8 K fragment's d order: lane t4's k16 step ks takes d
          // t4 * D / 4 + 4 ks + (0, 1 | 2, 3)
          const __nv_bfloat16* p = qg + col * D + t4 * (D / 4) + 4 * ks;
          const uint2 w = col < ncols ? *reinterpret_cast<const uint2*>(p)
                                      : make_uint2(0u, 0u);
          qf[ks][nb][0] = w.x;
          qf[ks][nb][1] = w.y;
          continue;
        }
        const __nv_bfloat16* p = qg + col * D + 16 * ks + 2 * t4;
        qf[ks][nb][0] = col < ncols ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        qf[ks][nb][1] =
            col < ncols ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
      }
    }
    // this lane's columns' own limits (a padding column admits nothing)
    int clim[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * nb + 2 * t4 + e;
        clim[nb][e] = MULTI && col < ncols
                          ? col_limit(a, row, (col0 + col) % a.c) : 0;
      }
    const uint32_t ring = hopper::smem_u32(smem);
    // int8: where a tile position's scales sit (see Smem8)
    const int s_rows =
        a.table != nullptr && a.page_size < T ? a.page_size : T;
    const int s_pitch = Q8 ? scale_pitch(a, s_rows) : 0;

    for (int k = 0; k < n_mine; ++k) {
      const int s = k % S;
      const int r0 = 16 * warp;                  // this warp's first tile row
      const int p0 = rw.tile(j0 + k) * T + r0;
      const int pa = p0 + gq, pb = pa + 8;
      const bool va = rw.admitted(pa), vb = rw.admitted(pb);
      const unsigned any = __ballot_sync(0xffffffffu, va || vb);
      const bool all = __ballot_sync(0xffffffffu, va && vb) == 0xffffffffu;
      hopper::mbar_wait(&full[s], (k / S) & 1);
      if (k == 0) TRACE(3, 0);
      if (any) {
        const uint32_t kt = ring + s * L::STAGE, vt = kt + L::TILE;
        if constexpr (!Q8) if (!all) {
          // masked V rows to zero: stale, or another row's, maybe not finite
          for (int i = lane; i < 16 * L::CH * 8; i += 32) {
            const int r = i / (L::CH * 8), unit = i % (L::CH * 8);
            if (!rw.admitted(p0 + r))
              asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                           :: "r"(vt + swz(r0 + r, unit)), "r"(0u) : "memory");
          }
          __syncwarp();
        }
        // S^T (16 positions x 8 columns a block) = K . q^T
        float sc[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nb][i] = 0.f;
        if constexpr (Q8) {
          // rows r0 + gq and r0 + gq + 8, this lane's d / 4 bytes of each
          uint32_t ka[D / 16], kb[D / 16];
#pragma unroll
          for (int u = 0; u < D / 64; ++u) {
            const uint4 x = hopper::lds128(kt + row8<D>(r0 + gq, t4 * (D / 64) + u));
            const uint4 y =
                hopper::lds128(kt + row8<D>(r0 + gq + 8, t4 * (D / 64) + u));
            ka[4 * u] = x.x, ka[4 * u + 1] = x.y, ka[4 * u + 2] = x.z,
            ka[4 * u + 3] = x.w;
            kb[4 * u] = y.x, kb[4 * u + 1] = y.y, kb[4 * u + 2] = y.z,
            kb[4 * u + 3] = y.w;
          }
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t af[4];
            hopper::i8_pairs_within(ka[ks], af[0], af[2]);
            hopper::i8_pairs_within(kb[ks], af[1], af[3]);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              hopper::mma_m16n8k16(sc[nb], af, qf[ks][nb][0], qf[ks][nb][1]);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t af[4];
            hopper::ldmatrix_x4<false>(
                af, kt + swz(r0 + (lane & 7) + (lane & 8), 2 * ks + lane / 16));
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              hopper::mma_m16n8k16(sc[nb], af, qf[ks][nb][0], qf[ks][nb][1]);
          }
        }
        // int8: the positions' k_scale (times the softmax's scale) and
        // v_scale; a masked position's may be anything and is selected away
        float ksa = 0.f, ksb = 0.f, vsa = 0.f, vsb = 0.f;
        if constexpr (Q8) {
          const float* scl = reinterpret_cast<const float*>(
                                 smem + L::SCALE_OFF) + s * 2 * SCALES;
          const int sa = (r0 + gq) / s_rows * s_pitch + (r0 + gq) % s_rows;
          const int sb =
              (r0 + gq + 8) / s_rows * s_pitch + (r0 + gq + 8) % s_rows;
          ksa = scl[sa] * a.scale_log2;
          ksb = scl[sb] * a.scale_log2;
          vsa = scl[SCALES + sa];
          vsb = scl[SCALES + sb];
        }
        // online softmax down each column; P^T into B fragments
        uint32_t pfr[NB][2];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          float x[4];
          if constexpr (Q8) {
            x[0] = sc[nb][0] * ksa;
            x[1] = sc[nb][1] * ksa;
            x[2] = sc[nb][2] * ksb;
            x[3] = sc[nb][3] * ksb;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) x[i] = sc[nb][i] * a.scale_log2;
          }
          if constexpr (MULTI) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (!va || pa >= clim[nb][e]) x[e] = -INFINITY;
              if (!vb || pb >= clim[nb][e]) x[2 + e] = -INFINITY;
            }
          } else {
            if (!va) x[0] = x[1] = -INFINITY;
            if (!vb) x[2] = x[3] = -INFINITY;
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float mx = fmaxf(x[e], x[2 + e]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
            // with MULTI, -inf while the column has admitted nothing: it
            // weighs 0; at c = 1 one of the warp's 16 positions is admitted
            const float mn = fmaxf(m[nb][e], mx);
            const float ms = MULTI && mn == -INFINITY ? 0.f : mn;
            const float alpha = hopper::exp2_approx(m[nb][e] - ms);
            x[e] = hopper::exp2_approx(x[e] - ms);
            x[2 + e] = hopper::exp2_approx(x[2 + e] - ms);
            l[nb][e] = l[nb][e] * alpha + (x[e] + x[2 + e]);
            m[nb][e] = mn;
#pragma unroll
            for (int mb = 0; mb < D / 16; ++mb) {
              acc[mb][nb][e] *= alpha;
              acc[mb][nb][2 + e] *= alpha;
            }
          }
          if constexpr (Q8) {
            // v_scale into P before its rounding; a masked position's P
            // and scale are selected away, not multiplied
            x[0] = va ? x[0] * vsa : 0.f;
            x[1] = va ? x[1] * vsa : 0.f;
            x[2] = vb ? x[2] * vsb : 0.f;
            x[3] = vb ? x[3] * vsb : 0.f;
          }
          pfr[nb][0] = hopper::movmatrix_trans(hopper::pack_bf16x2(x[0], x[1]));
          pfr[nb][1] = hopper::movmatrix_trans(hopper::pack_bf16x2(x[2], x[3]));
        }
        // O^T (d x heads) += V^T . P^T
        if constexpr (Q8) {
          // positions r0 + 2 t4, + 1, + 8, + 9 (P^T's k), this lane's d / 8
          // bytes of each: O^T's rows gq and gq + 8 of m16 tile mb are d
          // gq * D / 8 + 2 mb and + 1
          constexpr int VW = D / 32;
          uint32_t w[4][VW];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int pos = r0 + 2 * t4 + (r & 1) + 8 * (r >> 1);
            if constexpr (D == 128) {
              const uint4 x = hopper::lds128(vt + row8<D>(pos, gq));
              w[r][0] = x.x, w[r][1] = x.y, w[r][2] = x.z, w[r][3] = x.w;
            } else {
              const uint2 x = hopper::lds64(vt + pos * D + gq * (D / 8));
              w[r][0] = x.x, w[r][1] = x.y;
            }
          }
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            uint32_t lo[4], hi[4];
            hopper::i8_pairs_across(w[0][j], w[1][j], lo);
            hopper::i8_pairs_across(w[2][j], w[3][j], hi);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t af[4] = {lo[2 * h], lo[2 * h + 1], hi[2 * h],
                                      hi[2 * h + 1]};
#pragma unroll
              for (int nb = 0; nb < NB; ++nb)
                hopper::mma_m16n8k16(acc[2 * j + h][nb], af, pfr[nb][0],
                                     pfr[nb][1]);
            }
          }
        } else {
#pragma unroll
          for (int mb = 0; mb < D / 16; ++mb) {
            uint32_t af[4];
            hopper::ldmatrix_x4<true>(
                af, vt + swz(r0 + (lane & 7) + (lane & 16) / 2,
                             2 * mb + (lane & 8) / 8));
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              hopper::mma_m16n8k16(acc[mb][nb], af, pfr[nb][0], pfr[nb][1]);
          }
        }
        // the zeroed rows are ordinary stores: order them before the
        // producer's next TMA write to this stage
        if constexpr (!Q8) if (!all) hopper::fence_proxy_async();
      }
      // int8: this warp's reads of the stage (the generic proxy) before the
      // producer's next TMA or cp.async write to it
      if constexpr (Q8) hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    // this warp's sums, from the 8 lanes that share a column
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[nb][e] += __shfl_xor_sync(0xffffffffu, l[nb][e], 4);
        l[nb][e] += __shfl_xor_sync(0xffffffffu, l[nb][e], 8);
        l[nb][e] += __shfl_xor_sync(0xffffffffu, l[nb][e], 16);
      }
  }

  // the warps' partials over the ring, once every warp is done with it; a
  // block without a tile has an empty partial, which no merge reads past m
  TRACE(4, 0);
  __syncthreads();
  float* red_m = reinterpret_cast<float*>(smem);     // [CONSUMERS][HEADS]
  float* red_l = red_m + CONSUMERS * HEADS;
  float* red_acc = red_l + CONSUMERS * HEADS;        // [CONSUMERS][HEADS][D]
  if (n_mine == 0) {
    for (int i = tid; i < ncols; i += NT) part_m[i] = -INFINITY;
  } else if (warp < CONSUMERS) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int hw = warp * HEADS + 8 * nb + 2 * t4 + e;
        if (gq == 0) {
          red_m[hw] = m[nb][e];
          red_l[hw] = l[nb][e];
        }
#pragma unroll
        for (int mb = 0; mb < D / 16; ++mb) {
          if constexpr (Q8) {
            const int d = gq * (D / 8) + 2 * mb;
            red_acc[hw * D + red8<D>(d)] = acc[mb][nb][e];
            red_acc[hw * D + red8<D>(d + 1)] = acc[mb][nb][2 + e];
          } else {
            red_acc[hw * D + 16 * mb + gq] = acc[mb][nb][e];
            red_acc[hw * D + 16 * mb + gq + 8] = acc[mb][nb][2 + e];
          }
        }
      }
  }
  __syncthreads();

  // the block's partial: its warps merged in order
  for (int i = n_mine > 0 ? tid : ncols * D; i < ncols * D; i += NT) {
    const int head = i / D, d = i % D;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) mb = fmaxf(mb, red_m[w * HEADS + head]);
    float sum = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) {
      const float mw = red_m[w * HEADS + head];
      const float wt = mw == -INFINITY ? 0.f : hopper::exp2_approx(mw - mb);
      sum = fmaf(wt, red_acc[(w * HEADS + head) * D + (Q8 ? red8<D>(d) : d)],
                 sum);
      lb = fmaf(wt, red_l[w * HEADS + head], lb);
    }
    part_acc[head * D + d] = sum;
    if (d == 0) {
      part_m[head] = mb;
      part_l[head] = lb;
    }
  }
  TRACE(5, 0);
  hopper::cluster_sync();
  TRACE(6, 0);

  // this block's slice of d: every block's partial, merged in rank order
  constexpr int DS = D / CLUSTER;
  const uint32_t pm = hopper::smem_u32(part_m);
  for (int i = tid; i < ncols * DS; i += NT) {
    const int head = i / DS, d = rank * DS + i % DS;
    // every load issued at once; an empty partial's l and acc are not
    // written, and weigh nothing
    float mj[CLUSTER], lj[CLUSTER], aj[CLUSTER], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < CLUSTER; ++j) {
      mj[j] = hopper::ld_cluster_f32(hopper::mapa(pm + 4 * head, j));
      lj[j] = hopper::ld_cluster_f32(hopper::mapa(pm + 4 * (HEADS + head), j));
      aj[j] = hopper::ld_cluster_f32(
          hopper::mapa(pm + 4 * (2 * HEADS + head * D + d), j));
    }
#pragma unroll
    for (int j = 0; j < CLUSTER; ++j) mx = fmaxf(mx, mj[j]);
    float sum = 0.f, lsum = 0.f;
#pragma unroll
    for (int j = 0; j < CLUSTER; ++j) {
      if (mj[j] == -INFINITY) continue;
      const float wt = hopper::exp2_approx(mj[j] - mx);
      lsum = fmaf(wt, lj[j], lsum);
      sum = fmaf(wt, aj[j], sum);
    }
    a.o[((static_cast<long long>(row) * a.h + g * rep) * npos + col0 + head) *
            D + d] = __float2bfloat16_rn(sum / lsum);
  }
  TRACE(7, 0);
  hopper::cluster_sync();               // no block leaves while it is read
  TRACE(8, 0);
}

template <int D, int NB, bool MULTI>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    decode_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ Args a) {
  attend_tc<__nv_bfloat16, D, NB, MULTI>(tm_k, tm_v, a);
}

template <int D, int NB, bool MULTI>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    decode_attention_tc_q8_kernel(const __grid_constant__ CUtensorMap tm_k,
                                  const __grid_constant__ CUtensorMap tm_v,
                                  const __grid_constant__ CUtensorMap tm_ks,
                                  const __grid_constant__ CUtensorMap tm_vs,
                                  const __grid_constant__ Args a) {
  attend_tc<int8_t, D, NB, MULTI>(tm_k, tm_v, a, &tm_ks, &tm_vs);
}

// the four tensor maps of a launch: K, V and, on the int8 route, their
// scales
struct Maps {
  CUtensorMap k, v, ks, vs;
};

template <typename KT, int D, int NB, bool MULTI>
cudaError_t launch(const Maps& m, const Args& a, int b,
                   cudaStream_t stream) {
  static hopper_host::SmemLimit limit;
  cudaError_t err;
  if constexpr (std::is_same<KT, int8_t>::value) {
    constexpr int smem = Smem8<D, NB>::BYTES;
    err = hopper_host::allow_smem(decode_attention_tc_q8_kernel<D, NB, MULTI>,
                                  smem, limit);
    if (err != cudaSuccess) return err;
    decode_attention_tc_q8_kernel<D, NB, MULTI>
        <<<dim3(CLUSTER, a.kv * a.groups, b), NT, smem, stream>>>(
            m.k, m.v, m.ks, m.vs, a);
  } else {
    constexpr int smem = Smem<D, NB>::BYTES;
    err = hopper_host::allow_smem(decode_attention_tc_kernel<D, NB, MULTI>,
                                  smem, limit);
    if (err != cudaSuccess) return err;
    decode_attention_tc_kernel<D, NB, MULTI>
        <<<dim3(CLUSTER, a.kv * a.groups, b), NT, smem, stream>>>(m.k, m.v,
                                                                 a);
  }
  return cudaGetLastError();
}

// a decode step: up to 8 query heads a KV head in one group of 8, more in
// one of 16; a chunk: groups of 16 columns
template <typename KT, int D>
cudaError_t launch_nb(const Maps& m, Args a, int b, cudaStream_t stream) {
  const int cols = a.h / a.kv * a.c;
  a.groups = (cols + 15) / 16;
  if (a.c > 1) return launch<KT, D, 2, true>(m, a, b, stream);
  return cols <= 8 ? launch<KT, D, 1, false>(m, a, b, stream)
                   : launch<KT, D, 2, false>(m, a, b, stream);
}

// the Args and checks both entries share (0, or an invalid value)
int make_args(Args& a, const void* q, void* o, const long long* limits,
              long long limits_stride, long long c_stride,
              const int* prompt_lengths, const int* prompt_slots,
              int prompt_slots_scalar, const int* table, int max_pages,
              int page_size, long long n0, int b, int h, int kv, int c,
              int head_dim, int span, float sm_scale) {
  const bool paged = table != nullptr;
  if (b <= 0 || h <= 0 || kv <= 0 || h % kv || h / kv > MAX_REP || span <= 0 ||
      c < 1 || c > MAX_CHUNK ||
      n0 <= 0 || (head_dim != 64 && head_dim != 128) ||
      (paged && (max_pages <= 0 || page_size <= 0 ||
                 (page_size & (page_size - 1)) ||
                 static_cast<long long>(max_pages) * page_size != span)))
    return static_cast<int>(cudaErrorInvalidValue);
  a = Args{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.limits = limits;
  a.limits_stride = limits_stride;
  a.c_stride = c_stride;
  a.prompt_lengths = prompt_lengths;
  a.prompt_slots = prompt_slots;
  a.prompt_slots_scalar = prompt_slots_scalar;
  a.table = table;
  a.max_pages = max_pages;
  a.page_size = page_size;
  a.h = h;
  a.kv = kv;
  a.span = span;
  a.c = c;
  a.groups = 1;
  a.scale_log2 = sm_scale * LOG2E;
  return 0;
}

}  // namespace

// q (b, h, c, d) contiguous bf16, 1 <= c <= MAX_CHUNK, h = rep * kv with
// rep <= 16, d 64 or 128;
// k/v dense (b, kv, span, d), n0 = b, or with `table` (b, max_pages) int32
// one layer of a page pool (n0 = n_pages + 1, kv, page_size, d), page_size
// a power of two with max_pages * page_size = span; both bf16 with element
// strides (s0, s1, s2) that are multiples of 8, the last dimension
// contiguous, 16-byte aligned; o like q. limits int64 at [row *
// limits_stride + j * c_stride] for chunk position j; prompt_lengths (b,)
// int32 or null (no pad gap);
// prompt_slots (b,) int32, or null and then prompt_slots_scalar for every
// row. Launches one kernel on `stream`, allocates nothing, returns
// cudaGetLastError() (0 = launched).
extern "C" int decode_attention_tc(
    const void* q, const void* k, const void* v, void* o,
    const long long* limits, long long limits_stride, long long c_stride,
    const int* prompt_lengths, const int* prompt_slots,
    int prompt_slots_scalar, const int* table, int max_pages, int page_size,
    long long n0, int b, int h, int kv, int c, int head_dim, int span,
    long long ks0,
    long long ks1, long long ks2, long long vs0, long long vs1, long long vs2,
    float sm_scale, void* stream) {
  const bool paged = table != nullptr;
  Args a;
  if (make_args(a, q, o, limits, limits_stride, c_stride, prompt_lengths,
                prompt_slots, prompt_slots_scalar, table, max_pages,
                page_size, n0, b, h, kv, c, head_dim, span, sm_scale) ||
      (ks0 | ks1 | ks2 | vs0 | vs1 | vs2) % 8 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // (d, positions, kv, rows or pages), innermost first, strides in bytes
  const uint64_t dims[4] = {static_cast<uint64_t>(head_dim),
                            static_cast<uint64_t>(paged ? page_size : span),
                            static_cast<uint64_t>(kv),
                            static_cast<uint64_t>(n0)};
  const uint64_t kstr[3] = {static_cast<uint64_t>(ks2) * 2,
                            static_cast<uint64_t>(ks1) * 2,
                            static_cast<uint64_t>(ks0) * 2};
  const uint64_t vstr[3] = {static_cast<uint64_t>(vs2) * 2,
                            static_cast<uint64_t>(vs1) * 2,
                            static_cast<uint64_t>(vs0) * 2};
  const uint32_t box[4] = {hopper::CHUNK,
                           static_cast<uint32_t>(paged && page_size < T
                                                     ? page_size : T),
                           1, 1};
  Maps m;
  cudaError_t err = hopper_host::encode_bf16(&m.k, k, 4, dims, kstr, box);
  if (err == cudaSuccess)
    err = hopper_host::encode_bf16(&m.v, v, 4, dims, vstr, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = head_dim == 64 ? launch_nb<__nv_bfloat16, 64>(m, a, b, s)
                       : launch_nb<__nv_bfloat16, 128>(m, a, b, s);
  return static_cast<int>(err);
}

// The int8 route: as `decode_attention_tc`, with k/v int8 (the same
// layouts; element strides multiples of 16, 16-byte aligned) and their
// f32 scales, KV head g's position p at k_scale + row * kss0 + g * kss1 +
// p * kss2 (paged: table[row, p / page_size] * kss0 + g * kss1 + (p %
// page_size) * kss2); q and o bf16.
extern "C" int decode_attention_tc_q8(
    const void* q, const void* k, const void* v, void* o,
    const float* k_scale, const float* v_scale, const long long* limits,
    long long limits_stride, long long c_stride, const int* prompt_lengths,
    const int* prompt_slots, int prompt_slots_scalar, const int* table,
    int max_pages, int page_size, long long n0, int b, int h, int kv, int c,
    int head_dim, int span, long long ks0, long long ks1, long long ks2,
    long long vs0, long long vs1, long long vs2, long long kss0,
    long long kss1, long long kss2, long long vss0, long long vss1,
    long long vss2, float sm_scale, void* stream) {
  const bool paged = table != nullptr;
  Args a;
  if (make_args(a, q, o, limits, limits_stride, c_stride, prompt_lengths,
                prompt_slots, prompt_slots_scalar, table, max_pages,
                page_size, n0, b, h, kv, c, head_dim, span, sm_scale) ||
      k_scale == nullptr || v_scale == nullptr ||
      (ks0 | ks1 | ks2 | vs0 | vs1 | vs2) % 16 ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t dims[4] = {static_cast<uint64_t>(head_dim),
                            static_cast<uint64_t>(paged ? page_size : span),
                            static_cast<uint64_t>(kv),
                            static_cast<uint64_t>(n0)};
  const uint64_t kstr[3] = {static_cast<uint64_t>(ks2),
                            static_cast<uint64_t>(ks1),
                            static_cast<uint64_t>(ks0)};
  const uint64_t vstr[3] = {static_cast<uint64_t>(vs2),
                            static_cast<uint64_t>(vs1),
                            static_cast<uint64_t>(vs0)};
  const uint32_t box[4] = {static_cast<uint32_t>(head_dim),
                           static_cast<uint32_t>(paged && page_size < T
                                                     ? page_size : T),
                           1, 1};
  const CUtensorMapSwizzle sw = head_dim == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
  Maps m;
  cudaError_t err = hopper_host::encode(&m.k, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                        k, 4, dims, kstr, box, sw);
  if (err == cudaSuccess)
    err = hopper_host::encode(&m.v, CU_TENSOR_MAP_DATA_TYPE_UINT8, v, 4,
                              dims, vstr, box, sw);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the scales by TMA where a box of them is at least SCALE_TMA_ROWS
  // positions and their rows meet TMA's 16-byte alignment; else cp.async
  const bool aligned8 =
      kss2 == 1 && vss2 == 1 && (kss0 | kss1 | vss0 | vss1) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(k_scale) |
       reinterpret_cast<uintptr_t>(v_scale)) % 16 == 0;
  a.scale_tma = aligned8 && box[1] >= SCALE_TMA_ROWS;
  if (a.scale_tma) {
    const uint64_t sdims[3] = {dims[1], dims[2], dims[3]};
    const uint64_t ksstr[2] = {static_cast<uint64_t>(kss1) * 4,
                               static_cast<uint64_t>(kss0) * 4};
    const uint64_t vsstr[2] = {static_cast<uint64_t>(vss1) * 4,
                               static_cast<uint64_t>(vss0) * 4};
    const uint32_t sbox[3] = {box[1], 1, 1};
    err = hopper_host::encode(&m.ks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              k_scale, 3, sdims, ksstr, sbox,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
      err = hopper_host::encode(&m.vs, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                v_scale, 3, sdims, vsstr, sbox,
                                CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks0 = ks0;
  a.ks1 = ks1;
  a.ks2 = ks2;
  a.vs0 = vs0;
  a.vs1 = vs1;
  a.vs2 = vs2;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.kss0 = kss0;
  a.kss1 = kss1;
  a.kss2 = kss2;
  a.vss0 = vss0;
  a.vss1 = vss1;
  a.vss2 = vss2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = head_dim == 64 ? launch_nb<int8_t, 64>(m, a, b, s)
                       : launch_nb<int8_t, 128>(m, a, b, s);
  return static_cast<int>(err);
}

#ifdef DECODE_ATTENTION_TRACE
// copies the first n stamps of the last traced launches to `host`, then
// zeroes them on the device (0 = done)
extern "C" int decode_attention_tc_trace(void* host, int n) {
  if (n < 0 || n > TRACE_BLOCKS * TRACE_PHASES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemcpyFromSymbol(host, g_trace, n * 8ull);
  static unsigned long long zero[TRACE_BLOCKS * TRACE_PHASES];
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_trace, zero, n * 8ull);
  return static_cast<int>(err);
}
#endif
