// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, ports of the Pallas TPU kernels of
// tpu_kubernetes/ops/flash_attention.py (both launched by `_bwd`):
//
// * flash_bwd_dq_kernel replaces `_bwd_dq_kernel`: dQ for one q tile,
//   walking K/V tiles up to the offset-aligned causal diagonal.
// * flash_bwd_dkv_kernel replaces `_bwd_dkv_kernel`: dK and dV for one K/V
//   tile, walking q tiles from the first one that sees it under the causal
//   mask, qb0 = max(k0 - offset, 0) / BQ.
//
// Both recompute the probabilities from the forward's per-row log-sum-exp,
// P = exp(sm_scale * Q.K^T - lse), with masked scores set to -1e30 (never
// -inf, so exp gives exactly 0 and never NaN), and take
// dS = P * (dP - delta) * sm_scale with dP = dO.V^T and delta = rowsum(dO*O)
// computed by the caller in f32. Scores, P, dP, dS and the accumulators are
// f32; dq, dk, dv are written in the inputs' type at the end. Causal is
// aligned bottom-right (offset = seq_k - seq_q), as in the forward; ragged
// edges (any seq_q, seq_k) are masked in the kernel.
//
// Design (first, simple version, like flash_fwd.cu). 128 threads per block,
// 64x64 score tiles. Every operand tile is staged in shared memory as f32
// and transposed ([head_dim][64 + 4]), so that
//   - the score-like products (S = Q.K^T, dP = dO.V^T) give each thread a
//     4x8 tile read with float4 loads, as in the forward;
//   - the products that reduce over the tile (dQ += dS.K, dV += P^T.dO,
//     dK += dS^T.Q) give each thread 4 rows and head_dim/8 columns taken
//     with a stride of 8 (column tx + 8c), which reads the transposed tile
//     without bank conflicts. dS (and P) go back through shared memory,
//     stored so a thread reads its 4 rows as one float4.
// dK and dV of a K/V tile are summed in registers over the q tiles of one
// block: no atomics, so the result does not depend on launch order. All
// products run on the CUDA cores as f32 FMAs (no TF32, no tensor cores).
//
// What bounds it on this card: at the training shape both kernels need far
// more operations than bytes (3 and 4 tile products per score), so a good
// kernel is bound by tensor-core operations. This one issues scalar f32
// FMAs fed from shared memory and is bound by that; wgmma, TMA and tuning
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;           // q rows per tile
constexpr int BK = 64;           // kv rows per tile
constexpr int NT = 128;          // threads per block
constexpr int TS = 64 + 4;       // row stride of the transposed tiles (floats)
constexpr float NEG_INF = -1e30f;

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

// rows [r0, r0 + 64) of a (rows, D) matrix into dst[d * TS + r] as f32,
// zero past `rows`
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 int r0, int rows) {
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, d = e % D, gr = r0 + r;
    dst[d * TS + r] = gr < rows ? to_f32(src[(long)gr * D + d]) : 0.f;
  }
}

// acc[i][j] += sum_d a[d][ra + i] * b[d][cb + j]: a 4x8 tile of A.B^T from
// two transposed tiles
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[4][8],
                                             const float* aT, const float* bT,
                                             int ra, int cb) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(aT + d * TS + ra);
    const float4 b0 = *reinterpret_cast<const float4*>(bT + d * TS + cb);
    const float4 b1 = *reinterpret_cast<const float4*>(bT + d * TS + cb + 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][c] += sum_{n < count} w[n * TS + r0 + i] * bT[(tx + 8c) * TS + n]:
// 4 rows of W^T.B where W is stored [n][row] and B transposed [col][n]
template <int D>
__device__ __forceinline__ void reduce_product(float (&acc)[4][D / 8],
                                               const float* w, const float* bT,
                                               int r0, int tx, int count) {
  for (int n = 0; n < count; ++n) {
    const float4 wa = *reinterpret_cast<const float4*>(w + n * TS + r0);
    const float wv[4] = {wa.x, wa.y, wa.z, wa.w};
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float bv = bT[(tx + 8 * c) * TS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(wv[i], bv, acc[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // qT, doT, kT, vT [D][TS]; dsT [BK][TS]; lse, delta [BQ]
  return sizeof(float) * (4 * D * TS + BK * TS + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int seq_q, int seq_k, int causal, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* doT = qT + D * TS;
  float* kT = doT + D * TS;
  float* vT = kT + D * TS;
  float* dsT = vT + D * TS;        // [kv col][q row]
  float* lse_s = dsT + BK * TS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;         // q rows ty*4 .. ty*4+3
  const int tx = tid & 7;          // kv cols tx*8 .. +7; dq cols tx + 8c
  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int offset = seq_k - seq_q;

  const T* kp = k + bh * seq_k * (long)D;
  const T* vp = v + bh * seq_k * (long)D;
  stage_transposed<T, D>(qT, q + bh * seq_q * (long)D, q0, seq_q);
  stage_transposed<T, D>(doT, dout + bh * seq_q * (long)D, q0, seq_q);
  for (int r = tid; r < BQ; r += NT) {
    const bool ok = q0 + r < seq_q;
    lse_s[r] = ok ? lse[bh * seq_q + q0 + r] : 0.f;
    delta_s[r] = ok ? delta[bh * seq_q + q0 + r] : 0.f;
  }

  float acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;

  // q tile rows [q0, q0 + BQ) see columns up to row + offset when causal
  const int kv_end = causal ? min(seq_k, q0 + BQ + offset) : seq_k;
  const int num_kb = (kv_end + BK - 1) / BK;

  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the last tile's readers are done; Q, dO visible
    stage_transposed<T, D>(kT, kp, k0, seq_k);
    stage_transposed<T, D>(vT, vp, k0, seq_k);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_product<D>(s, qT, kT, ty * 4, tx * 8);
    tile_product<D>(dp, doT, vT, ty * 4, tx * 8);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx * 8 + j;
        const bool keep = row < seq_q && col < seq_k &&
                          (!causal || col <= row + offset);
        const float sc = keep ? s[i][j] * sm_scale : NEG_INF;
        const float p = expf(sc - lse_s[r]);
        s[i][j] = p * (dp[i][j] - delta_s[r]) * sm_scale;   // dS
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(dsT + (tx * 8 + j) * TS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // dQ += dS . K over this tile's columns (past kv_end dS is 0)
    reduce_product<D>(acc, dsT, kT, ty * 4, tx, min(BK, kv_end - k0));
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_q) continue;
    T* out = dq + (bh * seq_q + row) * (long)D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) out[tx + 8 * c] = from_f32<T>(acc[i][c]);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // kT, vT, qT, doT [D][TS]; pS, dsS [BQ][TS]; lse, delta [BQ]
  return sizeof(float) * (4 * D * TS + 2 * BQ * TS + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int seq_q, int seq_k, int causal,
                     float sm_scale) {
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);
  float* vT = kT + D * TS;
  float* qT = vT + D * TS;
  float* doT = qT + D * TS;
  float* pS = doT + D * TS;        // [q row][kv col]
  float* dsS = pS + BQ * TS;       // [q row][kv col]
  float* lse_s = dsS + BQ * TS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;         // kv rows ty*4 .. ty*4+3
  const int tx = tid & 7;          // q cols tx*8 .. +7; dk/dv cols tx + 8c
  const long bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int offset = seq_k - seq_q;

  const T* qp = q + bh * seq_q * (long)D;
  const T* dop = dout + bh * seq_q * (long)D;
  stage_transposed<T, D>(kT, k + bh * seq_k * (long)D, k0, seq_k);
  stage_transposed<T, D>(vT, v + bh * seq_k * (long)D, k0, seq_k);

  float dk_acc[4][D / 8], dv_acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // the first q row that sees column k0 under the causal mask
  const int qb0 = causal ? max(k0 - offset, 0) / BQ : 0;
  const int num_qb = (seq_q + BQ - 1) / BQ;

  for (int qb = qb0; qb < num_qb; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();  // the last tile's readers are done; K, V visible
    stage_transposed<T, D>(qT, qp, q0, seq_q);
    stage_transposed<T, D>(doT, dop, q0, seq_q);
    for (int r = tid; r < BQ; r += NT) {
      const bool ok = q0 + r < seq_q;
      lse_s[r] = ok ? lse[bh * seq_q + q0 + r] : 0.f;
      delta_s[r] = ok ? delta[bh * seq_q + q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: kv rows ty*4 + i, q cols tx*8 + j
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_product<D>(s, kT, qT, ty * 4, tx * 8);
    tile_product<D>(dp, vT, doT, ty * 4, tx * 8);

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tx * 8 + j, row = q0 + r;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty * 4 + i;
        const bool keep = row < seq_q && col < seq_k &&
                          (!causal || col <= row + offset);
        const float sc = keep ? s[i][j] * sm_scale : NEG_INF;
        const float p = expf(sc - lse_s[r]);
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - delta_s[r]) * sm_scale;  // dS
      }
      *reinterpret_cast<float4*>(pS + r * TS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dsS + r * TS + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

    // dV += P^T . dO and dK += dS^T . Q over this tile's valid q rows
    const int qn = min(BQ, seq_q - q0);
    reduce_product<D>(dv_acc, pS, doT, ty * 4, tx, qn);
    reduce_product<D>(dk_acc, dsS, qT, ty * 4, tx, qn);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= seq_k) continue;
    T* dko = dk + (bh * seq_k + row) * (long)D;
    T* dvo = dv + (bh * seq_k + row) * (long)D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      dko[tx + 8 * c] = from_f32<T>(dk_acc[i][c]);
      dvo[tx + 8 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int seq_q, int seq_k, int causal,
                      float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_q + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), seq_q, seq_k, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int seq_q, int seq_k,
                       int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_k + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), seq_q, seq_k, causal,
      sm_scale);
  return cudaGetLastError();
}

bool valid(int bh, int seq_q, int seq_k, int causal) {
  return bh > 0 && seq_q > 0 && seq_k > 0 && !(causal && seq_q > seq_k);
}

}  // namespace

// q, dout (bh, seq_q, head_dim), k/v (bh, seq_k, head_dim) contiguous, all
// bf16 (is_bf16=1) or all f32; lse, delta (bh, seq_q) f32; dq like q.
// Launches on `stream`, allocates nothing, returns cudaGetLastError()
// (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int seq_q,
                            int seq_k, int head_dim, int is_bf16, int causal,
                            float sm_scale, void* stream) {
  if (!valid(bh, seq_q, seq_k, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, D) \
  launch_dq<T, D>(q, k, v, dout, lse, delta, dq, bh, seq_q, seq_k, causal, \
                  sm_scale, s)
  cudaError_t err = cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: err = is_bf16 ? DQ(__nv_bfloat16, 16) : DQ(float, 16); break;
    case 32: err = is_bf16 ? DQ(__nv_bfloat16, 32) : DQ(float, 32); break;
    case 64: err = is_bf16 ? DQ(__nv_bfloat16, 64) : DQ(float, 64); break;
    case 128: err = is_bf16 ? DQ(__nv_bfloat16, 128) : DQ(float, 128); break;
    default: break;
  }
#undef DQ
  return static_cast<int>(err);
}

// Same inputs; dk, dv like k, v.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int seq_q, int seq_k, int head_dim, int is_bf16,
                             int causal, float sm_scale, void* stream) {
  if (!valid(bh, seq_q, seq_k, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKV(T, D) \
  launch_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, bh, seq_q, seq_k, \
                   causal, sm_scale, s)
  cudaError_t err = cudaErrorInvalidValue;
  switch (head_dim) {
    case 16: err = is_bf16 ? DKV(__nv_bfloat16, 16) : DKV(float, 16); break;
    case 32: err = is_bf16 ? DKV(__nv_bfloat16, 32) : DKV(float, 32); break;
    case 64: err = is_bf16 ? DKV(__nv_bfloat16, 64) : DKV(float, 64); break;
    case 128: err = is_bf16 ? DKV(__nv_bfloat16, 128) : DKV(float, 128); break;
    default: break;
  }
#undef DKV
  return static_cast<int>(err);
}
