// Grouped (ragged) matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of tpu_kubernetes/ops/grouped_matmul.py:
//
// * `_gmm_kernel` (launched by `_gmm_call`): out[rows_e] = lhs[rows_e] @
//   rhs[e] for contiguous row groups, rows_e = [off[e], off[e+1]) with
//   off = the running sum of group_sizes. Entry point `gmm_forward`. With
//   trans_rhs it multiplies by rhs[e]^T instead, which is the backward's
//   dlhs = dout @ rhs[e]^T without a transposed copy of the weights.
// * `_gmm_drhs_kernel` (launched by `_gmm_drhs_call`): drhs[e] =
//   lhs[rows_e]^T @ dout[rows_e], zero for an empty group. Entry point
//   `gmm_drhs`.
//
// Semantics kept from the reference: each row belongs to at most one group
// (rows past the last offset belong to none and come out as zero, as in
// `grouped_matmul_reference`); a row tile that a group boundary splits
// masks the lhs rows outside the group to zero before the product, as
// `_row_mask` does; every product accumulates in f32 and is cast to the
// inputs' type once, at the end. Group sizes are read on the device (the
// grid is sized from static shapes only), so a call never waits for the
// host.
//
// Design (first, simple version). Forward: one block of 256 threads per
// (64-column tile, 64-row tile, group), the reference's (row block, group)
// tiles laid out as a parallel grid. The block computes the group offsets
// from group_sizes in shared memory and returns at once when its group
// owns no row of its tile (at most M/64 + E - 1 blocks of a column have
// work). Otherwise it walks K in 32-deep slices: the lhs slice (rows
// outside the group zeroed) is staged transposed as f32 and the rhs slice
// as f32; each thread owns a 4x4 output tile and reads its 4 rows and 4
// columns as one float4 each. The block writes only its group's rows, so
// every output row is written once, by one block, with no atomics; the
// last group's blocks also write the zero rows past the last offset.
// Spreading the groups over blocks keeps the card busy when few rows meet
// many experts (decode: 8 rows, 8 experts).
//
// drhs: one block of 256 threads per (64-row K tile, 64-column N tile,
// group); it walks the group's rows in 32-row slices and sums lhs^T @ dout
// in registers, so no atomics are needed and the result does not depend on
// launch order. Both run on the CUDA cores in f32 (no TF32, no tensor
// cores); both stay as the f32 routes.
//
// What bounds it on this card: at the training and prefill shapes the
// products are far above the H100's ops-per-byte ridge, so a good kernel is
// bound by tensor-core operations; at the decode shape (8 real rows) a
// call must read every used expert's weights, so it is bound by bytes.
// These two issue scalar f32 FMAs fed from shared memory. `gmm_forward`
// and `gmm_drhs` stay as the f32 routes (the port runs no f32 product on
// TF32).
//
// Entry point `gmm_forward_tc`: the forward and its dlhs form for bf16 on
// the tensor cores. The work is a list of (128-row tile, group) items, at
// most M/128 + E - 1 of them, built on the device from group_sizes by every
// CTA; each item is crossed with the N/128 column tiles. A persistent grid
// of one CTA per SM walks that list. A CTA has two consumer warpgroups (64
// rows of the 128 each) and a producer warp that streams 64-deep K slices
// of the lhs row tile and of rhs[group] through a 5-stage TMA ring guarded
// by full/empty mbarriers; the consumers run wgmma m64n128k16 from shared
// memory, keeping one k-slice of wgmma in flight. rhs is read through a 3-D
// tensor map over (E, K, N) with the group as the outer coordinate: without
// trans_rhs rhs[e] (K, N) is an MN-major B (wgmma's transpose bit), with it
// rhs[e] (N, K) is a K-major B, so neither layout is copied. A product row
// depends only on its lhs row, so the whole row tile is multiplied and the
// epilogue writes only the rows the item's group owns (each output row once,
// no atomics, no lhs masking); the last group's items also write the zero
// rows past sum(group_sizes). The ring runs on across items, so one item's
// epilogue overlaps the next one's loads. No call waits for the host.
//
// Entry point `gmm_drhs_tc`: the weight gradient for bf16 on the tensor
// cores. A work item is one (group, 128-row K tile, 128-column N tile) of
// the output (E, K, N), so every item owns its tile (no atomics, no
// dependence on launch order); E·(K/128)·(N/128) items, the groups with the
// most rows first (group sizes differ under a real router split), walked by
// a persistent grid of one CTA per SM. An item contracts over its group's
// own rows in 64-row slices starting at off[g]: the producer warp streams
// the lhs slice (64 rows × 128 K, two 64-wide chunks) and the dout slice
// (64 rows × 128 N) through a 5-stage TMA ring (rows at or past M read as
// zero); each consumer warpgroup owns 64 of the tile's K rows and runs
// wgmma m64n128k16 with A = lhsᵀ read from shared memory as it lies (lhs
// rows are the contraction and its 64 K values run along the product's M:
// an MN-major A, wgmma's transpose-A bit) and B = dout (MN-major, the
// transpose-B bit). Only a group's last slice holds rows of the next group
// (or rows past the sum): after that stage's full barrier each consumer
// warpgroup zeroes those rows of its own lhs chunk, as `_row_mask` masks
// lhs and not dout, so a non-finite dout value there reaches the product as
// it does in the reference; it then fences the stores to the async proxy
// and syncs the warpgroup before its wgmma. Rows before off[g] never enter,
// because the slice starts there. The epilogue writes the tile in bf16
// once; an empty group's items load nothing and write zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;       // forward: rows per block; drhs: K rows per block
constexpr int BN = 64;       // columns per block
constexpr int BK = 32;       // forward: contraction slice; drhs: row slice
constexpr int NT = 256;      // threads per block (16 x 16, 4x4 outputs each)
constexpr int TS = BN + 4;   // padded row stride of the shared tiles (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// off[0..e] = running sum of group_sizes, each clamped to [0, m]: rows at
// or past m belong to no row of the output, and a negative size counts 0.
__device__ void group_offsets(const int* __restrict__ group_sizes, int e,
                              int m, int* off) {
  if (threadIdx.x == 0) {
    long long acc = 0;
    off[0] = 0;
    for (int g = 0; g < e; ++g) {
      acc += max(group_sizes[g], 0);
      off[g + 1] = static_cast<int>(acc < m ? acc : m);
    }
  }
  __syncthreads();
}

// out (m, n) = per-group lhs (m, k) @ B_g, with B_g = rhs[g] (k, n), or
// rhs[g]^T when TRANS (rhs then (e, n, k)).
template <typename T, bool TRANS>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
           const int* __restrict__ group_sizes, T* __restrict__ out, int m,
           int k, int n, int e) {
  __shared__ __align__(16) float as[BK * TS];   // lhs slice, [kk][row]
  __shared__ __align__(16) float bs[BK * TS];   // rhs slice, [kk][col]
  extern __shared__ int off[];                  // e + 1 offsets

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * BN;
  const int r0 = blockIdx.y * BM;
  const int g = blockIdx.z;
  const int r_end = min(r0 + BM, m);
  group_offsets(group_sizes, e, m, off);
  // the group's rows in this tile, [lo, hi); the last group also writes
  // the rows past the last offset, [hi, w_end), as zeros
  const int lo = max(off[g], r0), hi = min(off[g + 1], r_end);
  const int w_end = g == e - 1 ? r_end : hi;
  if (lo >= w_end) return;           // the same answer in every thread

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (lo < hi) {
    const T* b = rhs + static_cast<long long>(g) * k * n;
    for (int k0 = 0; k0 < k; k0 += BK) {
      __syncthreads();               // the last slice's readers are done
      for (int idx = tid; idx < BM * BK; idx += NT) {
        const int r = idx / BK, c = idx % BK, gr = r0 + r;
        as[c * TS + r] = (gr >= lo && gr < hi)
            ? to_f32(lhs[static_cast<long long>(gr) * k + k0 + c]) : 0.f;
      }
      if (TRANS) {
        for (int idx = tid; idx < BK * BN; idx += NT) {
          const int col = idx / BK, c = idx % BK;
          bs[c * TS + col] =
              to_f32(b[static_cast<long long>(n0 + col) * k + k0 + c]);
        }
      } else {
        for (int idx = tid; idx < BK * BN; idx += NT) {
          const int c = idx / BN, col = idx % BN;
          bs[c * TS + col] =
              to_f32(b[static_cast<long long>(k0 + c) * n + n0 + col]);
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        const float4 a4 = *reinterpret_cast<const float4*>(as + c * TS + ty * 4);
        const float4 b4 = *reinterpret_cast<const float4*>(bs + c * TS + tx * 4);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row < lo || row >= w_end) continue;
    T* orow = out + static_cast<long long>(row) * n + n0 + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[j] = from_f32<T>(acc[i][j]);
  }
}

// drhs (e, k, n): drhs[g] = lhs[rows_g]^T @ dout[rows_g], zero when empty.
template <typename T>
__global__ void __launch_bounds__(NT)
gmm_drhs_kernel(const T* __restrict__ lhs, const T* __restrict__ dout,
                const int* __restrict__ group_sizes, T* __restrict__ drhs,
                int m, int k, int n, int e) {
  __shared__ __align__(16) float ls[BK * TS];   // lhs rows, [row][kcol]
  __shared__ __align__(16) float ds[BK * TS];   // dout rows, [row][col]
  extern __shared__ int off[];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * BM;
  const int g = blockIdx.z;
  group_offsets(group_sizes, e, m, off);
  const int lo = off[g], hi = off[g + 1];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int s0 = lo; s0 < hi; s0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * BM; idx += NT) {
      const int r = idx / BM, c = idx % BM, gr = s0 + r;
      const bool ok = gr < hi;
      ls[r * TS + c] =
          ok ? to_f32(lhs[static_cast<long long>(gr) * k + k0 + c]) : 0.f;
      ds[r * TS + c] =
          ok ? to_f32(dout[static_cast<long long>(gr) * n + n0 + c]) : 0.f;
    }
    __syncthreads();
    const int rows = min(BK, hi - s0);     // rows past hi add 0
    for (int r = 0; r < rows; ++r) {
      const float4 a4 = *reinterpret_cast<const float4*>(ls + r * TS + ty * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(ds + r * TS + tx * 4);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  T* base = drhs + static_cast<long long>(g) * k * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* orow = base + static_cast<long long>(k0 + ty * 4 + i) * n + n0 + tx * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T>
cudaError_t launch_forward(const void* lhs, const void* rhs, const void* gs,
                           void* out, int m, int k, int n, int e, int trans,
                           cudaStream_t stream) {
  const dim3 grid(n / BN, (m + BM - 1) / BM, e);
  const size_t smem = sizeof(int) * (e + 1);
  if (trans)
    gmm_kernel<T, true><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(lhs), static_cast<const T*>(rhs),
        static_cast<const int*>(gs), static_cast<T*>(out), m, k, n, e);
  else
    gmm_kernel<T, false><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(lhs), static_cast<const T*>(rhs),
        static_cast<const int*>(gs), static_cast<T*>(out), m, k, n, e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_drhs(const void* lhs, const void* dout, const void* gs,
                        void* drhs, int m, int k, int n, int e,
                        cudaStream_t stream) {
  const dim3 grid(n / BN, k / BM, e);
  const size_t smem = sizeof(int) * (e + 1);
  gmm_drhs_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(dout),
      static_cast<const int*>(gs), static_cast<T*>(drhs), m, k, n, e);
  return cudaGetLastError();
}

bool bad_dims(int m, int k, int n, int e) {
  // the wrapper holds K and N to multiples of 128; the tiles need 64 (and
  // drhs loads its K and N tiles with one loop, so BM == BN); the forward's
  // row tiles are the grid's y dimension
  static_assert(BM == BN, "drhs stages K and N tiles with one loop");
  return m <= 0 || (m + BM - 1) / BM > 65535 || e <= 0 || e > 4096 ||
         k <= 0 || n <= 0 || k % BM || n % BN;
}

// -- the tensor-core forward (bf16) ----------------------------------------------

namespace tc {

using hopper::CHUNK;

constexpr int TM = 128;          // rows of an item: two consumer warpgroups
constexpr int TN = 128;          // columns of an output tile
constexpr int TK = 64;           // contraction slice per stage
constexpr int STAGES = 5;
constexpr int NT = 384;
constexpr int CONSUMERS = 256;
constexpr uint32_t A_BYTES = TM * TK * 2;    // 16 KB
constexpr uint32_t B_BYTES = TK * TN * 2;    // 16 KB
constexpr uint32_t B_OFF = STAGES * A_BYTES;
constexpr uint32_t BAR_OFF = B_OFF + STAGES * B_BYTES;
constexpr uint32_t INT_OFF = BAR_OFF + 8 * 2 * STAGES;

// bytes of dynamic shared memory for e groups (+1024 to align the base)
inline size_t smem_bytes(int e) {
  return INT_OFF + sizeof(int) * 2 * (e + 1) + 1024;
}

// the largest g with first[g] <= i; for 0 <= i < first[e] that group owns
// rows (an empty group's first equals the next one's)
__device__ __forceinline__ int find_group(const int* first, int e, int i) {
  int lo = 0, hi = e - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (first[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

struct Item {
  int g, r0, ct;     // group, first row of the row tile, column tile
  int lo, hi;        // rows [lo, hi) of the tile this item writes
  bool compute;      // some of them are below sum(group_sizes)
};

__device__ __forceinline__ Item decode(const int* off, const int* first,
                                       int e, int m, int n_tiles, int w) {
  Item it;
  const int i = w / n_tiles;
  it.ct = w % n_tiles;
  it.g = find_group(first, e, i);
  it.r0 = (off[it.g] / TM + (i - first[it.g])) * TM;
  const int end = it.g == e - 1 ? m : off[it.g + 1];
  it.lo = max(off[it.g], it.r0);
  it.hi = min(end, it.r0 + TM);
  it.compute = it.lo < min(it.hi, off[e]);
  return it;
}

template <bool TRANS>
__global__ void __launch_bounds__(NT, 1)
gmm_tc_kernel(const __grid_constant__ CUtensorMap tm_a,
              const __grid_constant__ CUtensorMap tm_b,
              const int* __restrict__ group_sizes,
              __nv_bfloat16* __restrict__ out, int m, int k, int n, int e) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* off = reinterpret_cast<int*>(smem + INT_OFF);   // e + 1 offsets
  int* first = off + e + 1;                            // first item of a group

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
    // offsets clamped to [0, m] (a negative size counts 0), and the row
    // tiles of each group's rows; the last group's range runs on to m, so
    // the ranges cover every row once
    long long acc = 0;
    off[0] = 0;
    first[0] = 0;
    for (int g = 0; g < e; ++g) {
      acc += max(group_sizes[g], 0);
      off[g + 1] = static_cast<int>(acc < m ? acc : m);
    }
    for (int g = 0; g < e; ++g) {
      const int lo = off[g], hi = g == e - 1 ? m : off[g + 1];
      first[g + 1] = first[g] + (lo < hi ? (hi - 1) / TM - lo / TM + 1 : 0);
    }
  }
  __syncthreads();

  const int n_tiles = n / TN;
  const int total = first[e] * n_tiles;
  const int nk = k / TK;

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- producer --------------------------------------------------------------
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      hopper::prefetch_tensor_map(&tm_a);
      hopper::prefetch_tensor_map(&tm_b);
      int slot = 0;   // k-slices issued so far, across items
      for (int w = blockIdx.x; w < total; w += gridDim.x) {
        const Item it = decode(off, first, e, m, n_tiles, w);
        if (!it.compute) continue;
        for (int kb = 0; kb < nk; ++kb, ++slot) {
          const int s = slot % STAGES, round = slot / STAGES;
          if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* a = smem + s * A_BYTES;
          uint8_t* b = smem + B_OFF + s * B_BYTES;
          hopper::mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
          hopper::tma_load_2d(a, &tm_a, &full[s], kb * TK, it.r0);
          if (TRANS) {
            hopper::tma_load_3d(b, &tm_b, &full[s], kb * TK, it.ct * TN, it.g);
          } else {
#pragma unroll
            for (int c = 0; c < TN / CHUNK; ++c)
              hopper::tma_load_3d(b + c * (TK * 128), &tm_b, &full[s],
                                  it.ct * TN + c * CHUNK, kb * TK, it.g);
          }
        }
      }
    }
  } else {
    // -- consumers: rows 64*wg .. 64*wg + 63 of each item -------------------------
    hopper::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_in = 64 * wg + 16 * (t / 32) + lane / 4;   // and r_in + 8
    const int cq = 2 * (lane % 4);
    const int sum_end = off[e];
    int slot = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const Item it = decode(off, first, e, m, n_tiles, w);
      float acc[TN / 2];
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
      if (it.compute) {
        int prev = 0;
        for (int kb = 0; kb < nk; ++kb, ++slot) {
          const int s = slot % STAGES;
          hopper::mbar_wait(&full[s], (slot / STAGES) & 1);
          const uint32_t a = hopper::smem_u32(smem + s * A_BYTES) + wg * 64 * 128;
          const uint32_t b = hopper::smem_u32(smem + B_OFF + s * B_BYTES);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TK / 16; ++kk) {
            const uint64_t da = hopper::desc_sw128(a + kk * 32, 16,
                                                   hopper::SW128_ATOM);
            // TRANS: rhs[g] rows are N, K contiguous (K-major); else rows
            // are K and 64-wide N chunks sit TK*128 bytes apart (MN-major)
            const uint64_t db =
                TRANS ? hopper::desc_sw128(b + kk * 32, 16, hopper::SW128_ATOM)
                      : hopper::desc_sw128(b + kk * 16 * 128, TK * 128,
                                           hopper::SW128_ATOM);
            hopper::wgmma_ss_m64n128<TRANS ? 0 : 1>(acc, da, db, 1);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();            // the slice before is done
          if (kb > 0) hopper::mbar_arrive(&empty[prev]);
          prev = s;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_operands(acc);
        hopper::mbar_arrive(&empty[prev]);
      }
      // rows of other groups are left to their own items; rows past the
      // sum come out zero
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = it.r0 + r_in + 8 * h;
        if (row < it.lo || row >= it.hi) continue;
        const bool zero = row >= sum_end;
        __nv_bfloat16* orow = out + static_cast<long long>(row) * n + it.ct * TN + cq;
#pragma unroll
        for (int jc = 0; jc < TN / 8; ++jc) {
          const float x0 = zero ? 0.f : acc[4 * jc + 2 * h];
          const float x1 = zero ? 0.f : acc[4 * jc + 2 * h + 1];
          *reinterpret_cast<uint32_t*>(orow + 8 * jc) = hopper::pack_bf16x2(x0, x1);
        }
      }
    }
  }
}

cudaError_t launch_forward(const void* lhs, const void* rhs, const void* gs,
                           void* out, int m, int k, int n, int e, int trans,
                           cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs)) % 16)
    return cudaErrorInvalidValue;     // TMA reads from 16-byte aligned bases
  CUtensorMap tm_a, tm_b;
  const uint64_t dims_a[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
  const uint64_t str_a[1] = {static_cast<uint64_t>(k) * 2};
  const uint32_t box_a[2] = {TK, TM};
  cudaError_t err = hopper_host::encode_bf16(&tm_a, lhs, 2, dims_a, str_a, box_a);
  if (err != cudaSuccess) return err;
  const uint64_t kn = static_cast<uint64_t>(k) * n * 2;
  if (trans) {            // rhs (e, n, k): dims (k, n, e)
    const uint64_t dims[3] = {static_cast<uint64_t>(k), static_cast<uint64_t>(n),
                              static_cast<uint64_t>(e)};
    const uint64_t str[2] = {static_cast<uint64_t>(k) * 2, kn};
    const uint32_t box[3] = {TK, TN, 1};
    err = hopper_host::encode_bf16(&tm_b, rhs, 3, dims, str, box);
  } else {                // rhs (e, k, n): dims (n, k, e)
    const uint64_t dims[3] = {static_cast<uint64_t>(n), static_cast<uint64_t>(k),
                              static_cast<uint64_t>(e)};
    const uint64_t str[2] = {static_cast<uint64_t>(n) * 2, kn};
    const uint32_t box[3] = {CHUNK, TK, 1};
    err = hopper_host::encode_bf16(&tm_b, rhs, 3, dims, str, box);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(e);
  auto kernel = trans ? &gmm_tc_kernel<true> : &gmm_tc_kernel<false>;
  static hopper_host::SmemLimit limit[2];
  err = hopper_host::allow_smem(kernel, static_cast<int>(smem), limit[trans]);
  if (err != cudaSuccess) return err;
  const long long work =
      static_cast<long long>((m + TM - 1) / TM + e - 1) * (n / TN);
  const int sms = hopper_host::sm_count();
  const int grid = static_cast<int>(work < sms ? work : sms);
  kernel<<<grid, NT, smem, stream>>>(
      tm_a, tm_b, static_cast<const int*>(gs), static_cast<__nv_bfloat16*>(out),
      m, k, n, e);
  return cudaGetLastError();
}

}  // namespace tc

// -- the tensor-core weight gradient (bf16) -----------------------------------------

namespace tc_drhs {

using hopper::CHUNK;

constexpr int TK = 128;          // K rows of an output tile: two consumer warpgroups
constexpr int TN = 128;          // N columns of an output tile
constexpr int TR = 64;           // group rows (the contraction) per stage
constexpr int STAGES = 5;
constexpr int NT = 384;
constexpr int CONSUMERS = 256;
constexpr uint32_t CHUNK_BYTES = TR * 128;                 // 64 rows x 64 values
constexpr uint32_t A_BYTES = (TK / CHUNK) * CHUNK_BYTES;   // lhs slice, 16 KB
constexpr uint32_t B_BYTES = (TN / CHUNK) * CHUNK_BYTES;   // dout slice, 16 KB
constexpr uint32_t B_OFF = STAGES * A_BYTES;
constexpr uint32_t BAR_OFF = B_OFF + STAGES * B_BYTES;
constexpr uint32_t INT_OFF = BAR_OFF + 8 * 2 * STAGES;

// bytes of dynamic shared memory for e groups (+1024 to align the base)
inline size_t smem_bytes(int e) {
  return INT_OFF + sizeof(int) * (2 * e + 1) + 1024;
}

__global__ void __launch_bounds__(NT, 1)
gmm_drhs_tc_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                   const __grid_constant__ CUtensorMap tm_dout,
                   const int* __restrict__ group_sizes,
                   __nv_bfloat16* __restrict__ drhs, int m, int k, int n,
                   int e) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  int* off = reinterpret_cast<int*>(smem + INT_OFF);   // e + 1 offsets
  int* order = off + e + 1;                            // groups, most rows first

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  group_offsets(group_sizes, e, m, off);
  // each group's rank by rows, descending, ties by index
  for (int g = threadIdx.x; g < e; g += NT) {
    const int rows = off[g + 1] - off[g];
    int rank = 0;
    for (int h = 0; h < e; ++h) {
      const int other = off[h + 1] - off[h];
      rank += other > rows || (other == rows && h < g);
    }
    order[rank] = g;
  }
  __syncthreads();

  const int n_tiles = n / TN;
  const int per_group = (k / TK) * n_tiles;
  const int total = e * per_group;

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- producer --------------------------------------------------------------
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      hopper::prefetch_tensor_map(&tm_lhs);
      hopper::prefetch_tensor_map(&tm_dout);
      int slot = 0;   // row slices issued so far, across items
      for (int w = blockIdx.x; w < total; w += gridDim.x) {
        const int g = order[w / per_group];
        const int kt = (w % per_group) / n_tiles, nt = w % n_tiles;
        for (int r0 = off[g]; r0 < off[g + 1]; r0 += TR, ++slot) {
          const int s = slot % STAGES, round = slot / STAGES;
          if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* a = smem + s * A_BYTES;
          uint8_t* b = smem + B_OFF + s * B_BYTES;
          hopper::mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
#pragma unroll
          for (int c = 0; c < TK / CHUNK; ++c)
            hopper::tma_load_2d(a + c * CHUNK_BYTES, &tm_lhs, &full[s],
                                kt * TK + c * CHUNK, r0);
#pragma unroll
          for (int c = 0; c < TN / CHUNK; ++c)
            hopper::tma_load_2d(b + c * CHUNK_BYTES, &tm_dout, &full[s],
                                nt * TN + c * CHUNK, r0);
        }
      }
    }
  } else {
    // -- consumers: K rows 64*wg .. 64*wg + 63 of each tile ------------------------
    hopper::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_in = 64 * wg + 16 * (t / 32) + lane / 4;   // and r_in + 8
    const int cq = 2 * (lane % 4);
    int slot = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const int g = order[w / per_group];
      const int kt = (w % per_group) / n_tiles, nt = w % n_tiles;
      const int lo = off[g], hi = off[g + 1];
      float acc[TN / 2];
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
      if (lo < hi) {
        int prev = 0;
        for (int r0 = lo; r0 < hi; r0 += TR, ++slot) {
          const int s = slot % STAGES;
          hopper::mbar_wait(&full[s], (slot / STAGES) & 1);
          uint8_t* a = smem + s * A_BYTES + wg * CHUNK_BYTES;   // this warpgroup's K
          const int valid = hi - r0;
          if (valid < TR) {
            // the rows past the group's end: zero lhs, not dout (_row_mask)
            uint4* tail = reinterpret_cast<uint4*>(a + valid * 128);
            for (int i = t; i < (TR - valid) * 8; i += 128)
              tail[i] = make_uint4(0u, 0u, 0u, 0u);
            hopper::fence_proxy_async();
            hopper::named_barrier_sync(1 + wg, 128);
          }
          const uint32_t a_addr = hopper::smem_u32(a);
          const uint32_t b_addr = hopper::smem_u32(smem + B_OFF + s * B_BYTES);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < TR / 16; ++kk) {
            // 16 rows a step; lhs (A) and dout (B) are both MN-major
            const uint64_t da = hopper::desc_sw128(a_addr + kk * 16 * 128,
                                                   CHUNK_BYTES, hopper::SW128_ATOM);
            const uint64_t db = hopper::desc_sw128(b_addr + kk * 16 * 128,
                                                   CHUNK_BYTES, hopper::SW128_ATOM);
            hopper::wgmma_ss_m64n128<1, 1>(acc, da, db, 1);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();            // the slice before is done
          if (r0 > lo) hopper::mbar_arrive(&empty[prev]);
          prev = s;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_operands(acc);
        hopper::mbar_arrive(&empty[prev]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat16* orow =
            drhs + (static_cast<long long>(g) * k + kt * TK + r_in + 8 * h) * n +
            nt * TN + cq;
#pragma unroll
        for (int jc = 0; jc < TN / 8; ++jc)
          *reinterpret_cast<uint32_t*>(orow + 8 * jc) =
              hopper::pack_bf16x2(acc[4 * jc + 2 * h], acc[4 * jc + 2 * h + 1]);
      }
    }
  }
}

cudaError_t launch(const void* lhs, const void* dout, const void* gs,
                   void* drhs, int m, int k, int n, int e, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(dout)) % 16)
    return cudaErrorInvalidValue;     // TMA reads from 16-byte aligned bases
  const long long total =
      static_cast<long long>(e) * (k / TK) * (n / TN);
  if (total > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap tm_lhs, tm_dout;
  const uint32_t box[2] = {CHUNK, TR};
  const uint64_t dims_l[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
  const uint64_t str_l[1] = {static_cast<uint64_t>(k) * 2};
  const uint64_t dims_d[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(m)};
  const uint64_t str_d[1] = {static_cast<uint64_t>(n) * 2};
  cudaError_t err = hopper_host::encode_bf16(&tm_lhs, lhs, 2, dims_l, str_l, box);
  if (err == cudaSuccess)
    err = hopper_host::encode_bf16(&tm_dout, dout, 2, dims_d, str_d, box);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(e);
  static hopper_host::SmemLimit limit;
  err = hopper_host::allow_smem(gmm_drhs_tc_kernel, static_cast<int>(smem), limit);
  if (err != cudaSuccess) return err;
  const int sms = hopper_host::sm_count();
  const int grid = static_cast<int>(total < sms ? total : sms);
  gmm_drhs_tc_kernel<<<grid, NT, smem, stream>>>(
      tm_lhs, tm_dout, static_cast<const int*>(gs),
      static_cast<__nv_bfloat16*>(drhs), m, k, n, e);
  return cudaGetLastError();
}

}  // namespace tc_drhs

}  // namespace

// The tensor-core route of `gmm_forward`: the same arguments and layouts,
// bf16 only. Returns cudaGetLastError() (0 = launched).
extern "C" int gmm_forward_tc(const void* lhs, const void* rhs,
                              const void* group_sizes, void* out, int m, int k,
                              int n, int e, int trans_rhs, void* stream) {
  if (bad_dims(m, k, n, e) || k % tc::TK || n % tc::TN)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc::launch_forward(lhs, rhs, group_sizes, out, m, k,
                                             n, e, trans_rhs,
                                             static_cast<cudaStream_t>(stream)));
}

// lhs (m, k), rhs (e, k, n) [or (e, n, k) with trans_rhs], group_sizes (e,)
// int32, out (m, n); lhs, rhs and out all bf16 (is_bf16=1) or all f32, all
// contiguous on one device. Launches on `stream`, allocates nothing,
// returns cudaGetLastError() (0 = launched).
extern "C" int gmm_forward(const void* lhs, const void* rhs,
                           const void* group_sizes, void* out, int m, int k,
                           int n, int e, int is_bf16, int trans_rhs,
                           void* stream) {
  if (bad_dims(m, k, n, e)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_forward<__nv_bfloat16>(lhs, rhs, group_sizes, out, m, k,
                                              n, e, trans_rhs, s)
              : launch_forward<float>(lhs, rhs, group_sizes, out, m, k, n, e,
                                      trans_rhs, s);
  return static_cast<int>(err);
}

// The tensor-core route of `gmm_drhs`: the same arguments and layouts, bf16
// only. Returns cudaGetLastError() (0 = launched).
extern "C" int gmm_drhs_tc(const void* lhs, const void* dout,
                           const void* group_sizes, void* drhs, int m, int k,
                           int n, int e, void* stream) {
  if (bad_dims(m, k, n, e) || k % tc_drhs::TK || n % tc_drhs::TN)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tc_drhs::launch(lhs, dout, group_sizes, drhs, m, k,
                                          n, e,
                                          static_cast<cudaStream_t>(stream)));
}

// lhs (m, k), dout (m, n), group_sizes (e,) int32, drhs (e, k, n); lhs,
// dout and drhs all bf16 or all f32, contiguous. Every element of drhs is
// written (empty groups with zeros). Returns cudaGetLastError().
extern "C" int gmm_drhs(const void* lhs, const void* dout,
                        const void* group_sizes, void* drhs, int m, int k,
                        int n, int e, int is_bf16, void* stream) {
  if (bad_dims(m, k, n, e)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_drhs<__nv_bfloat16>(lhs, dout, group_sizes, drhs, m, k,
                                           n, e, s)
              : launch_drhs<float>(lhs, dout, group_sizes, drhs, m, k, n, e, s);
  return static_cast<int>(err);
}
