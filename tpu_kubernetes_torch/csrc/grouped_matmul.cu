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
// cores).
//
// What bounds it on this card: at the training and prefill shapes the
// products are far above the H100's ops-per-byte ridge, so a good kernel is
// bound by tensor-core operations; at the decode shape (8 real rows) a
// call must read every used expert's weights, so it is bound by bytes.
// This one issues scalar f32 FMAs fed from shared memory; wgmma, TMA and
// a split over K for the few-row case are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

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
