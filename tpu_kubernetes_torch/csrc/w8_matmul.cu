// Weight-only int8 matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// A kernel of the port alone: it replaces no Pallas kernel. The JAX package
// reads every weight of its serving path through `weight()`
// (tpu_kubernetes/models/quant.py:58-68), `q.astype(dtype) * s.astype(dtype)`,
// and leaves XLA to fuse that dequantize into the consuming dot, so the bf16
// weight never reaches device memory there. The port's plain version
// (`tpu_kubernetes_torch/ops/w8_matmul.py`, `w8_matmul_reference`) writes the
// dequantized weight out and reads it back before `torch.matmul`: more bytes
// than bf16 serving moves.
//
// Computes y = x @ W, W[k, n] = round_T(float(q[k, n]) * float(round_T(s[n])))
// (round_T: to bf16 for a bf16 model, none for f32), the reference's weight
// bit for bit; x (M, K) and y (M, N) in T (bf16 or f32), q (K, N) int8
// row-major, s (N,) f32. The sums are f32; y is rounded to T once.
//
// Bound: bytes. A decode step multiplies a handful of rows (M = 1..8, a
// speculative verify window 72) by each weight once, 2 * M flops a weight
// byte, far below the card's ratio, so the time is the weight's bytes over
// the memory rate. What the design does about it:
//
// * a block of 256 threads owns 128 output columns: 16 lanes along N, each
//   reading 8 consecutive int8 weights (one 8-byte load; a warp reads two
//   128-byte rows), by 16 lanes along K, each taking every 16th row of the
//   block's K range, in chunks of KCH = 256 positions: a lane issues the
//   chunk's 16 weight loads (128 bytes in flight a lane) before it stages
//   x and waits, so the weights and x of a chunk take one round trip to
//   memory; the weights are formed in registers and never stored;
// * x rows are staged in shared memory as f32, MT = 8 rows a block (more
//   rows take more blocks along z, which read the same weights again, from
//   L2 when they run together);
// * K is split over the CS blocks of a thread-block cluster (grid y, CS of
//   1, 2, 4 or 8) so that about one block a multiprocessor runs at every
//   width: the split depends on K and N alone (the wrapper picks it). Each
//   block sums its range into shared memory; then block r of the cluster
//   adds the CS blocks' partial tiles, read through distributed shared
//   memory in rank order, for its share of the columns and rounds them to
//   T: one launch, no scratch in device memory, no float atomics;
// * every output element's sum has one order that depends on K and N only,
//   never on M or on where its row sits: each lane's chain of fmas over its
//   rows of the range, the 16 K lanes added pairwise by a shuffle then the 8
//   warps in order through shared memory, then the cluster's blocks in
//   order. So a 72-row verify window writes, row for row, the bits an 8-row
//   decode step would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;                 // threads a block
constexpr int TN = 16;                  // lanes along N
constexpr int TK = NT / TN;             // lanes along K
constexpr int VN = 8;                   // int8 weights a lane loads
constexpr int COLS = TN * VN;           // columns a block (ops/w8_matmul.py COLS)
constexpr int MT = 8;                   // x rows a block
constexpr int KCH = 256;                // K positions a chunk
constexpr int UNROLL = KCH / TK;        // rows a lane loads ahead: 16
constexpr int NWARPS = NT / 32;

struct Args {
  const void* x;
  const int8_t* q;
  const float* s;
  void* y;
  int M, K, N, kb;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a value rounded to T and widened back: the reference's bf16 weight
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f32<T>(from_f32<T>(v));
}

template <typename T, int CS>
__global__ void __cluster_dims__(1, CS, 1) __launch_bounds__(NT)
    w8_matmul_kernel(const __grid_constant__ Args a) {
  __shared__ float s_x[MT][KCH];
  __shared__ float s_red[NWARPS][MT][COLS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tn = tid % TN, tk = tid / TN;
  const int n0 = blockIdx.x * COLS + tn * VN;
  const int k_lo = blockIdx.y * a.kb;
  const int k_hi = min(a.K, k_lo + a.kb);
  const int m0 = blockIdx.z * MT;
  const bool col_ok = n0 < a.N;         // N % VN == 0: a vector is in or out
  const T* x = static_cast<const T*>(a.x);

  float sc[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j)
    sc[j] = col_ok ? round_t<T>(__ldg(a.s + n0 + j)) : 0.f;

  float acc[MT][VN];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VN; ++j) acc[m][j] = 0.f;

  for (int kc = k_lo; kc < k_hi; kc += KCH) {
    const int kn = min(KCH, k_hi - kc);
    // the chunk's rows of this lane, kk = tk + TK * u: the weight loads
    // first, then x's, one wait for both
    const int8_t* qp = a.q + static_cast<long long>(kc + tk) * a.N + n0;
    uint2 u8[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      u8[u] = col_ok && tk + TK * u < kn
                  ? __ldg(reinterpret_cast<const uint2*>(
                        qp + static_cast<long long>(TK * u) * a.N))
                  : make_uint2(0u, 0u);
    for (int i = tid; i < MT * KCH; i += NT) {
      const int m = i / KCH, kk = i % KCH;
      s_x[m][kk] = m0 + m < a.M && kk < kn
                       ? to_f32<T>(x[static_cast<long long>(m0 + m) * a.K +
                                     kc + kk])
                       : 0.f;
    }
    __syncthreads();
    if (col_ok) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kk = tk + TK * u;
        if (kk < kn) {
          const int8_t* b = reinterpret_cast<const int8_t*>(&u8[u]);
          float w[VN];
#pragma unroll
          for (int j = 0; j < VN; ++j)
            w[j] = round_t<T>(static_cast<float>(b[j]) * sc[j]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xm = s_x[m][kk];
#pragma unroll
            for (int j = 0; j < VN; ++j) acc[m][j] = fmaf(xm, w[j], acc[m][j]);
          }
        }
      }
    }
    __syncthreads();                    // s_x is restaged
  }

  // the K lanes of a column: tk 2w and 2w + 1 share warp w (lanes l and
  // l ^ 16), added by a shuffle; then the warps, in order, into s_red[0]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VN; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 16) s_red[warp][m][tn * VN + j] = v;
    }
  __syncthreads();
  for (int i = tid; i < MT * COLS; i += NT) {
    const int m = i / COLS, c = i % COLS;
    float v = s_red[0][m][c];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) v += s_red[w][m][c];
    s_red[0][m][c] = v;
  }
  // the cluster's partial tiles, each block's in its s_red[0]; block r
  // adds them in rank order for columns [r * COLS / CS, (r + 1) * COLS / CS)
  if constexpr (CS > 1)
    hopper::cluster_sync();
  else
    __syncthreads();
  const int rank = CS > 1 ? static_cast<int>(hopper::cluster_ctarank()) : 0;
  constexpr int SHARE = COLS / CS;
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(&s_red[0][0][0]));
  for (int i = tid; i < MT * SHARE; i += NT) {
    const int m = i / SHARE, c = rank * SHARE + i % SHARE;
    const int n = blockIdx.x * COLS + c, mm = m0 + m;
    float v;
    if constexpr (CS > 1) {
      const uint32_t off = static_cast<uint32_t>((m * COLS + c) * 4);
      v = hopper::ld_cluster_f32(hopper::mapa(base + off, 0));
#pragma unroll
      for (int r = 1; r < CS; ++r)
        v += hopper::ld_cluster_f32(hopper::mapa(base + off, r));
    } else {
      v = s_red[0][m][c];
    }
    if (mm < a.M && n < a.N)
      static_cast<T*>(a.y)[static_cast<long long>(mm) * a.N + n] =
          from_f32<T>(v);
  }
  if constexpr (CS > 1) hopper::cluster_sync();  // no block leaves while read
}

template <typename T, int CS>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const dim3 grid((a.N + COLS - 1) / COLS, CS, (a.M + MT - 1) / MT);
  w8_matmul_kernel<T, CS><<<grid, NT, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int cs, cudaStream_t s) {
  switch (cs) {
    case 1: return launch<T, 1>(a, s);
    case 2: return launch<T, 2>(a, s);
    case 4: return launch<T, 4>(a, s);
    case 8: return launch<T, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) and y (M, N) contiguous, bf16 (is_bf16=1) or f32; q (K, N) int8
// contiguous, 8-byte aligned, N a multiple of 8; s (N,) f32. K split over
// a cluster of `cs` blocks (1, 2, 4 or 8) in ranges of `kb` positions
// (cs * kb >= K > (cs - 1) * kb). M <= 65535 * 8. Launches one kernel on
// `stream`, allocates nothing, returns cudaGetLastError() (0 = launched).
extern "C" int w8_matmul(const void* x, const int8_t* q, const float* s,
                         void* y, int M, int K, int N, int kb, int cs,
                         int is_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % VN || kb <= 0 || cs <= 0 ||
      static_cast<long long>(kb) * cs < K ||
      static_cast<long long>(kb) * (cs - 1) >= K || (M + MT - 1) / MT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.q = q;
  a.s = s;
  a.y = y;
  a.M = M;
  a.K = K;
  a.N = N;
  a.kb = kb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(a, cs, st)
                                  : dispatch<float>(a, cs, st);
  return static_cast<int>(err);
}
