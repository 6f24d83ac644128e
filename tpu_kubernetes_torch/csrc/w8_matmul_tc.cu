// Weight-only int8 matmul for Hopper (sm_90a) on the tensor cores, plain C
// interface for ctypes: the "tc" route of ops/w8_matmul.py, bf16 x of at
// most 128 rows (a decode step of 1..8, a verify window of 72). The
// CUDA-core kernel of w8_matmul.cu stays as the "gemv" route (f32 x, and
// widths the tiles below do not take).
//
// A kernel of the port alone: it replaces no Pallas kernel. The JAX package
// reads every serving weight through `weight()`
// (tpu_kubernetes/models/quant.py:58-68), `q.astype(dtype) * s.astype(dtype)`,
// and XLA fuses that dequantize into the consuming dot.
//
// Computes what w8_matmul.cu computes for bf16: y = x @ W with W[k, n] =
// round_bf16(q[k, n] * round_bf16(s[n])), the reference's weight bit for
// bit; x (M, K) and y (M, N) bf16, q (K, N) int8 row-major, s (N,) f32; f32
// sums, y rounded to bf16 once.
//
// Bound: bytes (2 * M flops a weight byte at M <= 8). On the CUDA cores
// each weight cost M fmas plus its dequantize, ~13 instructions at 8 rows,
// more issue than the bytes take. What the design does about it:
//
// * the products go to mma.sync m16n8k16 (bf16 in, f32 sums) with A and B
//   swapped: 16 output columns on the instruction's M, up to 8 x rows on
//   its N, so a decode step of 1..8 rows fills it with no padding; more
//   rows take more blocks along z, which read the same weights from L2.
//   The CUDA cores only widen and scale the weights: a lane reads 16 bytes
//   of each of four weight rows (k, k + 1, k + 8, k + 9 of a 16-deep
//   slice), forms each column's (k, k + 1) pair with byte permutes and an
//   f32 add (hopper::i8_pairs_across: int8 to bf16 exactly) and multiplies
//   it by the column's bf16 scale with one correctly rounded bf16x2
//   multiply, which is the reference's round_bf16(q * s_bf16); a lane's 16
//   columns are the rows of eight m16 tiles. About 3.3 instructions a
//   weight, whatever the row count;
// * the weights come by TMA: a producer warp keeps a ring of STAGES stages
//   full, each a 64 x 128 int8 tile (128-byte swizzle, 8 KB) and the x tile
//   of the same 64 positions (8 rows, 1 KB), completed on one mbarrier; four
//   consumer warps take 16 positions of each stage, and each fences its
//   reads of a stage (the generic proxy) before releasing it to the next
//   TMA write (the async proxy): without the fence, blocks sharing a
//   multiprocessor read refilled stages;
// * K is split over the CS blocks of a thread-block cluster (grid y; the
//   split, ops/w8_matmul.py tc_split, depends on K and N alone). The four
//   warps' sums are added in order through shared memory (in fragment
//   order, each store a row of 32 banks), then reduce-scattered: block r
//   owns a CS-th of the values, every block stores each of its sums into
//   the owner's slot for its rank through distributed shared memory and
//   arrives on the owner's mbarrier, and each owner adds the CS slots in
//   rank order and rounds them to bf16: one launch, one wait a block, no
//   scratch in device memory, no float atomics;
// * every output element's sum has one order that depends on K and N only:
//   an MMA's result for one x row does not depend on the others, the
//   stages, the warps' slices and the cluster split follow from K and N.
//   So a 72-row verify window writes, row for row, the bits an 8-row decode
//   step would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int CONSUMERS = 4;              // warps, 16 positions a stage each
constexpr int NT = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int COLS = 128;                 // columns a block (tc_split's TC_COLS)
constexpr int KT = 16 * CONSUMERS;        // positions a stage (TC_KT)
constexpr int MT = 8;                     // x rows a block
constexpr int STAGES = 4;
constexpr int W_TILE = KT * COLS;         // 8 KB of int8 weights
constexpr int X_TILE = MT * KT * 2;       // 1 KB of bf16 x
constexpr int STAGE = W_TILE + X_TILE;    // a multiple of 1024
constexpr int RING = STAGES * STAGE;
// the slices the cluster's blocks send this block: [CS][MT * COLS / CS] f32
constexpr int RECV_OFF = RING;
constexpr int BAR_OFF = RECV_OFF + MT * COLS * 4;  // full, empty, then recv
constexpr int SMEM = BAR_OFF + 16 * STAGES + 8 + 1024;  // 1024: alignment
// the warps' sums, [CONSUMERS][32][32] f32 (fragment order: value i of
// lane l at i * 32 + l), laid over the drained ring
static_assert(CONSUMERS * MT * COLS * 4 <= RING, "ring");
static_assert(STAGE % 1024 == 0, "a stage's tiles start on a swizzle atom");

struct Args {
  const float* s;
  __nv_bfloat16* y;
  int M, K, N, kb;
};

template <int CS>
__global__ void __cluster_dims__(1, CS, 1) __launch_bounds__(NT)
    w8_matmul_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* recv_bar = empty + STAGES;     // the cluster's other blocks
  float* recv = reinterpret_cast<float*>(smem + RECV_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * COLS, m0 = blockIdx.z * MT;
  const int k_lo = blockIdx.y * a.kb;
  const int k_hi = min(a.K, k_lo + a.kb);
  const int n_st = k_hi > k_lo ? (k_hi - k_lo + KT - 1) / KT : 0;
  if (tid == CONSUMERS * 32) {
    hopper::prefetch_tensor_map(&tm_q);
    hopper::prefetch_tensor_map(&tm_x);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    if constexpr (CS > 1) hopper::mbar_init(recv_bar, CS - 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the cluster's barriers are initialised before any block arrives on
  // another's (the wait comes at the end, long after)
  if constexpr (CS > 1) hopper::cluster_arrive_relaxed();

  // a consumer lane's D fragments: tile tau's rows g and g + 8 are columns
  // n0 + 16 g + 2 tau and + 1, its columns x rows 2 t and 2 t + 1
  const int g = lane / 4, t = lane % 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (warp == CONSUMERS) {
    // -- producer: one lane issues each stage's two TMA loads --------------
    if (lane == 0)
      for (int k = 0; k < n_st; ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) hopper::mbar_wait(&empty[s], ((k / STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], STAGE);
        uint8_t* dst = smem + s * STAGE;
        const int kk = k_lo + k * KT;
        hopper::tma_load_2d(dst, &tm_q, &full[s], n0, kk);
        hopper::tma_load_2d(dst + W_TILE, &tm_x, &full[s], kk, m0);
      }
    __syncwarp();                       // the warp meets the barrier whole
  } else {
    // -- consumers: 16 positions of each stage a warp ----------------------
    // the lane's 16 columns' scales, rounded to bf16, as {s, s} pairs
    uint32_t s2[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int n = n0 + 16 * g + c;
      const float sc = n < a.N ? __ldg(a.s + n) : 0.f;
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(sc));
      s2[c] = h | (h << 16);
    }
    const uint32_t ring = hopper::smem_u32(smem);
    const int r0 = 16 * warp;                   // this warp's first position
    const int ra = r0 + 2 * t;                  // rows k, k + 1, k + 8, k + 9
    for (int k = 0; k < n_st; ++k) {
      const int s = k % STAGES;
      hopper::mbar_wait(&full[s], (k / STAGES) & 1);
      const uint32_t wt = ring + s * STAGE, xt = wt + W_TILE;
      // W rows (128-byte swizzle: unit g of row r at g ^ (r & 7))
      const uint4 wa = hopper::lds128(wt + ra * 128 + ((g ^ (ra & 7)) << 4));
      const uint4 wb =
          hopper::lds128(wt + (ra + 1) * 128 + ((g ^ ((ra + 1) & 7)) << 4));
      const uint4 wc =
          hopper::lds128(wt + (ra + 8) * 128 + ((g ^ ((ra + 8) & 7)) << 4));
      const uint4 wd =
          hopper::lds128(wt + (ra + 9) * 128 + ((g ^ ((ra + 9) & 7)) << 4));
      // x^T as B: x row g at positions ra, ra + 1 (unit 2 warp) and ra + 8,
      // ra + 9 (unit 2 warp + 1), each pair 4 bytes at 4 t in its unit
      const uint32_t b0 =
          hopper::lds32(xt + g * 128 + (((2 * warp) ^ g) << 4) + 4 * t);
      const uint32_t b1 =
          hopper::lds32(xt + g * 128 + (((2 * warp + 1) ^ g) << 4) + 4 * t);
      const uint32_t wab[4][2] = {{wa.x, wb.x}, {wa.y, wb.y}, {wa.z, wb.z},
                                  {wa.w, wb.w}};
      const uint32_t wcd[4][2] = {{wc.x, wd.x}, {wc.y, wd.y}, {wc.z, wd.z},
                                  {wc.w, wd.w}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // word j: the lane's columns 4 j .. 4 j + 3, tiles 2 j and 2 j + 1
        uint32_t lo[4], hi[4];
        hopper::i8_pairs_across(wab[j][0], wab[j][1], lo);
        hopper::i8_pairs_across(wcd[j][0], wcd[j][1], hi);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 4 * j + 2 * h;          // tile 2 j + h: columns c, c + 1
          const uint32_t af[4] = {hopper::bf16x2_mul(lo[2 * h], s2[c]),
                                  hopper::bf16x2_mul(lo[2 * h + 1], s2[c + 1]),
                                  hopper::bf16x2_mul(hi[2 * h], s2[c]),
                                  hopper::bf16x2_mul(hi[2 * h + 1], s2[c + 1])};
          hopper::mma_m16n8k16(acc[2 * j + h], af, b0, b1);
        }
      }
      // this warp's reads of the stage (the generic proxy) before the
      // producer's next TMA write to it (the async proxy)
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
  }

  // the warps' sums over the drained ring in fragment order (each store a
  // row of 32 banks), then added in warp order; partials stay in that order
  // until the output: value i of lane l is D fragment acc[i / 4][i % 4],
  // column 16 (l / 4) + 2 (i / 4) + (i % 4) / 2, x row 2 (l % 4) + i % 2
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (warp < CONSUMERS) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      red[(warp * 32 + i) * 32 + lane] = acc[i / 4][i % 4];
  }
  __syncthreads();
  // a reduce-scatter over the cluster: block r owns values [r * SHARE,
  // (r + 1) * SHARE) of the order; every block adds its warps' sums in warp
  // order and stores each value into its owner's slot for this block's
  // rank (a store to another block's shared memory through mapa), then
  // arrives on the owners' barriers; each owner adds the CS slots in rank
  // order and writes its values of y. One wait a block, no block reads
  // another's memory, and a block that has sent and received may leave
  constexpr int SHARE = MT * COLS / CS;
  const int rank = CS > 1 ? static_cast<int>(hopper::cluster_ctarank()) : 0;
  if constexpr (CS > 1) hopper::cluster_wait();
  const uint32_t recv_u32 = hopper::smem_u32(recv);
  for (int j = tid; j < MT * COLS; j += NT) {
    float v = red[j];
#pragma unroll
    for (int w = 1; w < CONSUMERS; ++w) v += red[w * MT * COLS + j];
    const int owner = j / SHARE;
    const int slot = rank * SHARE + j % SHARE;
    if (CS == 1 || owner == rank)
      recv[slot] = v;
    else
      hopper::st_cluster_f32(hopper::mapa(recv_u32 + 4 * slot, owner), v);
  }
  __syncthreads();
  if constexpr (CS > 1) {
    if (tid < CS && tid != rank)
      hopper::mbar_arrive_cluster(
          hopper::mapa(hopper::smem_u32(recv_bar), tid));
    hopper::mbar_wait_cluster(recv_bar, 0);
  }
  for (int i = tid; i < SHARE; i += NT) {
    float v = recv[i];
#pragma unroll
    for (int r = 1; r < CS; ++r) v += recv[r * SHARE + i];
    const int j = rank * SHARE + i, f = j / 32, l = j % 32;
    const int c = 16 * (l / 4) + 2 * (f / 4) + (f % 4) / 2;
    const int n = n0 + c, mm = m0 + 2 * (l % 4) + f % 2;
    if (mm < a.M && n < a.N)
      a.y[static_cast<long long>(mm) * a.N + n] = __float2bfloat16_rn(v);
  }
}

template <int CS>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tx,
                   const Args& a, cudaStream_t stream) {
  static hopper_host::SmemLimit limit;
  cudaError_t err =
      hopper_host::allow_smem(w8_matmul_tc_kernel<CS>, SMEM, limit);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + COLS - 1) / COLS, CS, (a.M + MT - 1) / MT);
  w8_matmul_tc_kernel<CS><<<grid, NT, SMEM, stream>>>(tq, tx, a);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) and y (M, N) bf16 contiguous, x 16-byte aligned; q (K, N) int8
// contiguous, 16-byte aligned; s (N,) f32; K a multiple of 16, N of 16.
// K split over a cluster of `cs` blocks (1, 2, 4 or 8) in ranges of `kb`
// positions, a multiple of 64 (cs * kb >= K; a range past K is empty).
// M <= 65535 * 8. Launches one kernel on `stream`, allocates nothing,
// returns cudaGetLastError() (0 = launched).
extern "C" int w8_matmul_tc(const void* x, const int8_t* q, const float* s,
                            void* y, int M, int K, int N, int kb, int cs,
                            void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 16 || N % 16 || kb <= 0 ||
      kb % KT || static_cast<long long>(kb) * cs < K ||
      (M + MT - 1) / MT > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // q: (N, K) innermost first, boxes of 128 columns x 64 positions; x: (K,
  // M), boxes of 64 positions x 8 rows; out-of-range reads are zero
  const uint64_t q_dims[2] = {static_cast<uint64_t>(N),
                              static_cast<uint64_t>(K)};
  const uint64_t q_str[1] = {static_cast<uint64_t>(N)};
  const uint32_t q_box[2] = {COLS, KT};
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K),
                              static_cast<uint64_t>(M)};
  const uint64_t x_str[1] = {static_cast<uint64_t>(K) * 2};
  const uint32_t x_box[2] = {KT, MT};
  CUtensorMap tq, tx;
  cudaError_t err = hopper_host::encode(
      &tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 2, q_dims, q_str, q_box,
      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = hopper_host::encode_bf16(&tx, x, 2, x_dims, x_str, x_box);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.s = s;
  a.y = static_cast<__nv_bfloat16*>(y);
  a.M = M;
  a.K = K;
  a.N = N;
  a.kb = kb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cs) {
    case 1: err = launch<1>(tq, tx, a, st); break;
    case 2: err = launch<2>(tq, tx, a, st); break;
    case 4: err = launch<4>(tq, tx, a, st); break;
    case 8: err = launch<8>(tq, tx, a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
