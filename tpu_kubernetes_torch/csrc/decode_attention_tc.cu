// Decode attention for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes: the "tc" route of ops/decode_attention.py, bf16 at
// head_dim 64 or 128 with up to 16 query heads a KV head. The CUDA-core
// kernel of decode_attention.cu stays as the "simt" route (f32, head_dim
// 16 and 32).
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

// MULTI: more than one query position a row (c > 1), so each column masks
// past its own limit; c = 1 (a decode step) compiles without that mask
template <int D, int NB, bool MULTI>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT)
    decode_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ Args a) {
  using L = Smem<D, NB>;
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
        if (!all) {
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
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t af[4];
          hopper::ldmatrix_x4<false>(
              af, kt + swz(r0 + (lane & 7) + (lane & 8), 2 * ks + lane / 16));
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            hopper::mma_m16n8k16(sc[nb], af, qf[ks][nb][0], qf[ks][nb][1]);
        }
        // online softmax down each column; P^T into B fragments
        uint32_t pfr[NB][2];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          float x[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] = sc[nb][i] * a.scale_log2;
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
          pfr[nb][0] = hopper::movmatrix_trans(hopper::pack_bf16x2(x[0], x[1]));
          pfr[nb][1] = hopper::movmatrix_trans(hopper::pack_bf16x2(x[2], x[3]));
        }
        // O^T (d x heads) += V^T . P^T
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
        // the zeroed rows are ordinary stores: order them before the
        // producer's next TMA write to this stage
        if (!all) hopper::fence_proxy_async();
      }
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
          red_acc[hw * D + 16 * mb + gq] = acc[mb][nb][e];
          red_acc[hw * D + 16 * mb + gq + 8] = acc[mb][nb][2 + e];
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
      sum = fmaf(wt, red_acc[(w * HEADS + head) * D + d], sum);
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
cudaError_t launch(const CUtensorMap& tk, const CUtensorMap& tv,
                   const Args& a, int b, cudaStream_t stream) {
  constexpr int smem = Smem<D, NB>::BYTES;
  static hopper_host::SmemLimit limit;
  cudaError_t err = hopper_host::allow_smem(
      decode_attention_tc_kernel<D, NB, MULTI>, smem, limit);
  if (err != cudaSuccess) return err;
  decode_attention_tc_kernel<D, NB, MULTI>
      <<<dim3(CLUSTER, a.kv * a.groups, b), NT, smem, stream>>>(tk, tv, a);
  return cudaGetLastError();
}

// a decode step: up to 8 query heads a KV head in one group of 8, more in
// one of 16; a chunk: groups of 16 columns
template <int D>
cudaError_t launch_nb(const CUtensorMap& tk, const CUtensorMap& tv, Args a,
                      int b, cudaStream_t stream) {
  const int cols = a.h / a.kv * a.c;
  a.groups = (cols + 15) / 16;
  if (a.c > 1) return launch<D, 2, true>(tk, tv, a, b, stream);
  return cols <= 8 ? launch<D, 1, false>(tk, tv, a, b, stream)
                   : launch<D, 2, false>(tk, tv, a, b, stream);
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
  if (b <= 0 || h <= 0 || kv <= 0 || h % kv || h / kv > MAX_REP || span <= 0 ||
      c < 1 || c > MAX_CHUNK ||
      n0 <= 0 || (head_dim != 64 && head_dim != 128) ||
      (paged && (max_pages <= 0 || page_size <= 0 ||
                 (page_size & (page_size - 1)) ||
                 static_cast<long long>(max_pages) * page_size != span)) ||
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
  CUtensorMap tk, tv;
  cudaError_t err = hopper_host::encode_bf16(&tk, k, 4, dims, kstr, box);
  if (err == cudaSuccess)
    err = hopper_host::encode_bf16(&tv, v, 4, dims, vstr, box);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = head_dim == 64 ? launch_nb<64>(tk, tv, a, b, s)
                       : launch_nb<128>(tk, tv, a, b, s);
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
