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
// kernel is bound by tensor-core operations. These two issue scalar f32
// FMAs fed from shared memory and are bound by that. They stay as the f32
// routes (the port runs no f32 product on TF32) and serve head_dim 16/32.
//
// Entry point `flash_bwd_dkv_tc`: dK and dV for bf16 at head_dim 64 or 128
// on the tensor cores. One CTA of 384 threads per (128-row K/V tile,
// batch*head), launched heaviest first under causal masking (the first K/V
// tiles see the most q rows): two consumer warpgroups of 64 K/V rows each
// and a producer warp. The producer loads the K and V tiles once (TMA
// through 3-D tensor maps over (d, seq, b*h), so rows past a head's seq
// read as zero), then streams 64-row Q and dO tiles through a 3-stage ring,
// from the first q tile that sees the K/V tile, max(k0 - offset, 0) / 64;
// its 32 lanes copy each tile's 64 lse and delta values beside it and all
// arrive on the stage's full barrier. The four products need no transposed
// copy:
//   S^T  = K·Q^T   wgmma m64n64k16, A = K and B = Q, both K-major in shared;
//   dP^T = V·dO^T  the same form;
//   dV  += P^T·dO  A = P^T rounded to bf16 straight from the S^T accumulator
//                  (register A), B = dO, MN-major (transpose bit), as V in
//                  the forward;
//   dK  += dS^T·Q  A = dS^T likewise, B = Q, MN-major.
// lse and delta belong to the q columns of S^T: a thread reads the 16
// columns of its fragment from the stage. P^T = exp(sm_scale·S^T - lse)
// (exp2 with log2(e) folded in), masked to -1e30 only on tiles that cross
// the diagonal or a ragged end (rows past seq_q give P = 0 exactly);
// dS^T = P^T·(dP^T - delta)·sm_scale in f32, then rounded to bf16 for dK.
// dK and dV are summed in f32 registers over the q tiles and written once
// in bf16. Unlike the CUDA-core kernel, which keeps P and dS in f32 and is
// bit-equal to the plain version, this one rounds P^T and dS^T to bf16
// before the two reducing products.
//
// Entry point `flash_bwd_dq_tc`: dQ for bf16 at head_dim 64 or 128 on the
// tensor cores, the forward's shape of work with one product more. One CTA
// of 384 threads per (128-row q tile, batch*head), launched heaviest first
// under causal masking (the last q tiles see the most keys): two consumer
// warpgroups of 64 q rows each and a producer warp. The producer loads the
// Q and dO tiles once (TMA through the same 3-D tensor maps, so rows past
// a head's seq read as zero), then streams 64-row K and V tiles through a
// 3-stage ring up to kv_end = min(seq_k, q0 + 128 + offset). Shared memory
// at d 128: Q and dO 2 x 32 KB, a stage K + V 2 x 16 KB, so 3 stages take
// 160 KB (d 64: half). Each thread reads the lse and delta of its own two
// q rows once: they are constant over the walk, so they need no ring. Per
// K/V tile, none of the products needs a transposed copy:
//   S  = Q·K^T   wgmma m64n64k16, A = Q and B = K, both K-major in shared;
//   dP = dO·V^T  the same form;
//   dQ += dS·K   A = dS rounded to bf16 straight from the dP accumulator
//                (register A), B = K, MN-major (transpose bit), as V in the
//                forward's P·V.
// P = exp(sm_scale·S - lse) (exp2 with log2(e) folded in), masked to -1e30
// only on tiles that cross the diagonal or the ragged end of seq_k;
// dS/sm_scale = P·(dP - delta) in f32, rounded to bf16 for dS·K, and
// sm_scale multiplies the f32 sum once at the end. dQ (64 f32 a thread at
// d 128, beside S and dP, 32 + 32) stays in registers over the walk and is
// written once in bf16, with no atomics. Like dK/dV's tensor-core kernel it
// rounds dS to bf16 before the reducing product, so it is held to the f32
// dQ within that rounding rather than to the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

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
  // asked of the runtime once a device, not at every launch (nor while a
  // CUDA graph captures)
  static hopper_host::SmemLimit limit;
  cudaError_t err = hopper_host::allow_smem(
      flash_bwd_dq_kernel<T, D>, static_cast<int>(smem), limit);
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
  static hopper_host::SmemLimit limit;
  cudaError_t err = hopper_host::allow_smem(
      flash_bwd_dkv_kernel<T, D>, static_cast<int>(smem), limit);
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

// -- the tensor-core dK/dV kernel (bf16, head_dim 64 and 128) ------------------------

namespace tc {

using hopper::CHUNK;

constexpr int BKV = 128;         // K/V rows per CTA: two consumer warpgroups
constexpr int BQ = 64;           // q rows per stage
constexpr int STAGES = 3;
constexpr int NT = 384;          // 2 consumer warpgroups + the producer's
constexpr int CONSUMERS = 256;
constexpr int PRODUCERS = 32;    // the producer warp arrives on each full barrier
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int CH = D / CHUNK;                  // 64-wide d chunks
  static constexpr uint32_t KV_CHUNK = BKV * 128;       // bytes of one chunk
  static constexpr uint32_t Q_CHUNK = BQ * 128;
  static constexpr uint32_t KV_BYTES = CH * KV_CHUNK;   // the K or the V tile
  static constexpr uint32_t Q_BYTES = CH * Q_CHUNK;     // one Q or dO tile
  static constexpr uint32_t V_OFF = KV_BYTES;
  static constexpr uint32_t RING_OFF = 2 * KV_BYTES;    // stage s: Q, then dO
  static constexpr uint32_t STAGE_BYTES = 2 * Q_BYTES;
  static constexpr uint32_t VEC_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static constexpr uint32_t BAR_OFF = VEC_OFF + 2 * STAGES * BQ * 4;
  // kv_full, full[S], empty[S]; 1024 bytes to align the base
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int bh_count,
                        int seq_q, int seq_k, int causal, float sm_scale) {
  using L = Smem<D>;
  constexpr int S = STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* lse_s = reinterpret_cast<float*>(smem + L::VEC_OFF);   // [S][BQ]
  float* delta_s = lse_s + S * BQ;                              // [S][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  // heaviest first: under causal masking the first K/V tiles see the most
  // q rows
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int k0 = static_cast<int>(blockIdx.x) / bh_count * BKV;
  const int offset = seq_k - seq_q;
  const int qb0 = causal ? max(k0 - offset, 0) / BQ : 0;
  const int n_q = (seq_q + BQ - 1) / BQ - qb0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], PRODUCERS);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- producer warp: lane 0 issues every TMA load ------------------------------
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x < 2 * 128 + PRODUCERS) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        hopper::prefetch_tensor_map(&tm_q);
        hopper::prefetch_tensor_map(&tm_k);
        hopper::prefetch_tensor_map(&tm_v);
        hopper::prefetch_tensor_map(&tm_do);
        hopper::mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::CH; ++c) {
          hopper::tma_load_3d(smem + c * L::KV_CHUNK, &tm_k, kv_full,
                              c * CHUNK, k0, bh);
          hopper::tma_load_3d(smem + L::V_OFF + c * L::KV_CHUNK, &tm_v,
                              kv_full, c * CHUNK, k0, bh);
        }
      }
      const long vec = static_cast<long>(bh) * seq_q;
      for (int j = 0; j < n_q; ++j) {
        const int s = j % S, round = j / S;
        if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
        const int q0 = (qb0 + j) * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = q0 + r < seq_q;
          lse_s[s * BQ + r] = ok ? lse[vec + q0 + r] : 0.f;
          delta_s[s * BQ + r] = ok ? delta[vec + q0 + r] : 0.f;
        }
        if (lane == 0) {
          uint8_t* qt = smem + L::RING_OFF + s * L::STAGE_BYTES;
          hopper::mbar_arrive_expect_tx(&full[s], 2 * L::Q_BYTES);
#pragma unroll
          for (int c = 0; c < L::CH; ++c) {
            hopper::tma_load_3d(qt + c * L::Q_CHUNK, &tm_q, &full[s],
                                c * CHUNK, q0, bh);
            hopper::tma_load_3d(qt + L::Q_BYTES + c * L::Q_CHUNK, &tm_do,
                                &full[s], c * CHUNK, q0, bh);
          }
        } else {
          hopper::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // -- consumers: K/V rows 64*wg .. 64*wg + 63 -----------------------------------
    hopper::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row0 = k0 + 64 * wg + 16 * (t / 32) + lane / 4;   // and row0 + 8
    const int cq = 2 * (lane % 4);
    const float c2 = sm_scale * LOG2E;   // scores in base-2 exponent units
    const uint32_t k_base = hopper::smem_u32(smem) + wg * 64 * 128;
    const uint32_t v_base = hopper::smem_u32(smem + L::V_OFF) + wg * 64 * 128;

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    for (int j = 0; j < n_q; ++j) {
      const int s = j % S;
      const int q0 = (qb0 + j) * BQ;
      const uint32_t q_base =
          hopper::smem_u32(smem + L::RING_OFF + s * L::STAGE_BYTES);
      const uint32_t do_base = q_base + L::Q_BYTES;
      hopper::mbar_wait(&full[s], (j / S) & 1);

      // S^T = K·Q^T and dP^T = V·dO^T (kv rows x q columns)
      float acc_s[BQ / 2], acc_dp[BQ / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kstep = (kk / 4) * L::KV_CHUNK + (kk % 4) * 32;
        const uint32_t qstep = (kk / 4) * L::Q_CHUNK + (kk % 4) * 32;
        hopper::wgmma_ss_m64n64<0>(
            acc_s, hopper::desc_sw128(k_base + kstep, 16, hopper::SW128_ATOM),
            hopper::desc_sw128(q_base + qstep, 16, hopper::SW128_ATOM), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t kstep = (kk / 4) * L::KV_CHUNK + (kk % 4) * 32;
        const uint32_t qstep = (kk / 4) * L::Q_CHUNK + (kk % 4) * 32;
        hopper::wgmma_ss_m64n64<0>(
            acc_dp, hopper::desc_sw128(v_base + kstep, 16, hopper::SW128_ATOM),
            hopper::desc_sw128(do_base + qstep, 16, hopper::SW128_ATOM), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc_s);
      hopper::fence_operands(acc_dp);

      // P^T and dS^T in f32; lse and delta by q column. Only tiles that
      // cross the diagonal or a ragged end are masked.
      const float* lse_t = lse_s + s * BQ;
      const float* delta_t = delta_s + s * BQ;
      const bool mask = q0 + BQ > seq_q || k0 + BKV > seq_k ||
                        (causal && k0 + BKV - 1 > q0 + offset);
#pragma unroll
      for (int jc = 0; jc < BQ / 8; ++jc) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * jc + cq);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_t + 8 * jc + cq);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lg = (e ? l2.y : l2.x) * LOG2E;
          const float dl = e ? d2.y : d2.x;
          float v0 = fmaf(acc_s[4 * jc + e], c2, -lg);
          float v1 = fmaf(acc_s[4 * jc + 2 + e], c2, -lg);
          if (mask) {
            const int col = q0 + 8 * jc + cq + e;
            const bool out = col >= seq_q;
            if (out || row0 >= seq_k || (causal && row0 > col + offset))
              v0 = NEG_INF;
            if (out || row0 + 8 >= seq_k || (causal && row0 + 8 > col + offset))
              v1 = NEG_INF;
          }
          const float p0 = hopper::exp2_approx(v0);
          const float p1 = hopper::exp2_approx(v1);
          acc_s[4 * jc + e] = p0;
          acc_s[4 * jc + 2 + e] = p1;
          acc_dp[4 * jc + e] = p0 * (acc_dp[4 * jc + e] - dl) * sm_scale;
          acc_dp[4 * jc + 2 + e] = p1 * (acc_dp[4 * jc + 2 + e] - dl) * sm_scale;
        }
      }
      // P^T and dS^T in bf16, laid out as wgmma's register A operand
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = hopper::pack_bf16x2(acc_s[8 * kk + 2 * r],
                                          acc_s[8 * kk + 2 * r + 1]);
          dsa[kk][r] = hopper::pack_bf16x2(acc_dp[8 * kk + 2 * r],
                                           acc_dp[8 * kk + 2 * r + 1]);
        }
      }

      // dV += P^T·dO and dK += dS^T·Q: dO and Q (q rows x d) are MN-major
      // B operands, 16 q rows a step, d chunks Q_CHUNK apart
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t db = hopper::desc_sw128(do_base + kk * 16 * 128,
                                               L::Q_CHUNK, hopper::SW128_ATOM);
        if constexpr (D == 64)
          hopper::wgmma_rs_m64n64<1>(acc_dv, pa[kk], db, 1);
        else
          hopper::wgmma_rs_m64n128<1>(acc_dv, pa[kk], db, 1);
      }
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint64_t db = hopper::desc_sw128(q_base + kk * 16 * 128,
                                               L::Q_CHUNK, hopper::SW128_ATOM);
        if constexpr (D == 64)
          hopper::wgmma_rs_m64n64<1>(acc_dk, dsa[kk], db, 1);
        else
          hopper::wgmma_rs_m64n128<1>(acc_dk, dsa[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc_dv);
      hopper::fence_operands(acc_dk);
      hopper::mbar_arrive(&empty[s]);
    }

    const long base = static_cast<long>(bh) * seq_k;
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc) {
      const int col = 8 * jc + cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= seq_k) continue;
        const long at = (base + row) * D + col;
        *reinterpret_cast<uint32_t*>(dk + at) =
            hopper::pack_bf16x2(acc_dk[4 * jc + 2 * h], acc_dk[4 * jc + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv + at) =
            hopper::pack_bf16x2(acc_dv[4 * jc + 2 * h], acc_dv[4 * jc + 2 * h + 1]);
      }
    }
  }
}

// The four TMA maps of a backward kernel: q and dout over (d, seq_q, b*h)
// read in boxes of q_rows rows, k and v over (d, seq_k, b*h) in boxes of
// kv_rows rows, 64 d values wide.
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

template <int D>
cudaError_t encode_bwd_maps(BwdMaps& tm, const void* q, const void* k,
                            const void* v, const void* dout, int bh,
                            int seq_q, int seq_k, uint32_t q_rows,
                            uint32_t kv_rows) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16)
    return cudaErrorInvalidValue;   // TMA reads from 16-byte aligned bases
  const uint32_t box_q[3] = {CHUNK, q_rows, 1}, box_kv[3] = {CHUNK, kv_rows, 1};
  const uint64_t dims_q[3] = {D, static_cast<uint64_t>(seq_q),
                              static_cast<uint64_t>(bh)};
  const uint64_t dims_kv[3] = {D, static_cast<uint64_t>(seq_k),
                               static_cast<uint64_t>(bh)};
  const uint64_t str_q[2] = {D * 2, static_cast<uint64_t>(seq_q) * D * 2};
  const uint64_t str_kv[2] = {D * 2, static_cast<uint64_t>(seq_k) * D * 2};
  cudaError_t err = hopper_host::encode_bf16(&tm.q, q, 3, dims_q, str_q, box_q);
  if (err == cudaSuccess)
    err = hopper_host::encode_bf16(&tm.dout, dout, 3, dims_q, str_q, box_q);
  if (err == cudaSuccess)
    err = hopper_host::encode_bf16(&tm.k, k, 3, dims_kv, str_kv, box_kv);
  if (err == cudaSuccess)
    err = hopper_host::encode_bf16(&tm.v, v, 3, dims_kv, str_kv, box_kv);
  return err;
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int seq_q, int seq_k,
                       int causal, float sm_scale, cudaStream_t stream) {
  BwdMaps tm;
  cudaError_t err = encode_bwd_maps<D>(tm, q, k, v, dout, bh, seq_q, seq_k,
                                       BQ, BKV);
  if (err != cudaSuccess) return err;
  constexpr uint32_t smem = Smem<D>::BYTES;
  static hopper_host::SmemLimit limit;
  err = hopper_host::allow_smem(flash_bwd_dkv_tc_kernel<D>,
                                static_cast<int>(smem), limit);
  if (err != cudaSuccess) return err;
  const long blocks = static_cast<long>((seq_k + BKV - 1) / BKV) * bh;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_bwd_dkv_tc_kernel<D><<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
      tm.q, tm.k, tm.v, tm.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), bh, seq_q, seq_k, causal, sm_scale);
  return cudaGetLastError();
}

// -- the tensor-core dQ kernel (bf16, head_dim 64 and 128) ---------------------------

constexpr int DQ_ROWS = 128;     // q rows per CTA: two consumer warpgroups
constexpr int DQ_KV = 64;        // K/V rows per stage

template <int D>
struct DqSmem {
  static constexpr int CH = D / CHUNK;                  // 64-wide d chunks
  static constexpr uint32_t Q_CHUNK = DQ_ROWS * 128;    // bytes of one chunk
  static constexpr uint32_t KV_CHUNK = DQ_KV * 128;
  static constexpr uint32_t Q_BYTES = CH * Q_CHUNK;     // the Q or the dO tile
  static constexpr uint32_t KV_BYTES = CH * KV_CHUNK;   // one K or V tile
  static constexpr uint32_t DO_OFF = Q_BYTES;
  static constexpr uint32_t RING_OFF = 2 * Q_BYTES;     // stage s: K, then V
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
  static constexpr uint32_t BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  // q_full, full[S], empty[S]; 1024 bytes to align the base
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int bh_count,
                       int seq_q, int seq_k, int causal, float sm_scale) {
  using L = DqSmem<D>;
  constexpr int S = STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  // heaviest first: under causal masking the last q tiles see the most keys
  const int n_qt = (seq_q + DQ_ROWS - 1) / DQ_ROWS;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count) * DQ_ROWS;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int offset = seq_k - seq_q;
  const int kv_end = causal ? min(seq_k, q0 + DQ_ROWS + offset) : seq_k;
  const int n_kv = (kv_end + DQ_KV - 1) / DQ_KV;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- producer: one thread issues every TMA load -------------------------------
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      hopper::prefetch_tensor_map(&tm_q);
      hopper::prefetch_tensor_map(&tm_k);
      hopper::prefetch_tensor_map(&tm_v);
      hopper::prefetch_tensor_map(&tm_do);
      hopper::mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::CH; ++c) {
        hopper::tma_load_3d(smem + c * L::Q_CHUNK, &tm_q, q_full, c * CHUNK,
                            q0, bh);
        hopper::tma_load_3d(smem + L::DO_OFF + c * L::Q_CHUNK, &tm_do, q_full,
                            c * CHUNK, q0, bh);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % S, round = j / S;
        if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* kt = smem + L::RING_OFF + s * L::STAGE_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], L::STAGE_BYTES);
#pragma unroll
        for (int c = 0; c < L::CH; ++c) {
          hopper::tma_load_3d(kt + c * L::KV_CHUNK, &tm_k, &full[s],
                              c * CHUNK, j * DQ_KV, bh);
          hopper::tma_load_3d(kt + L::KV_BYTES + c * L::KV_CHUNK, &tm_v,
                              &full[s], c * CHUNK, j * DQ_KV, bh);
        }
      }
    }
  } else {
    // -- consumers: q rows 64*wg .. 64*wg + 63 of the tile ------------------------
    hopper::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * (t / 32) + lane / 4;   // and row0 + 8
    const int cq = 2 * (lane % 4);
    const float c2 = sm_scale * LOG2E;   // scores in base-2 exponent units
    const uint32_t q_base = hopper::smem_u32(smem) + wg * 64 * 128;
    const uint32_t do_base = q_base + L::DO_OFF;

    // lse (base 2) and delta of this thread's two q rows, constant over the
    // walk; rows past seq_q are never written
    const long vec = static_cast<long>(bh) * seq_q;
    const float lg0 = row0 < seq_q ? lse[vec + row0] * LOG2E : 0.f;
    const float lg1 = row0 + 8 < seq_q ? lse[vec + row0 + 8] * LOG2E : 0.f;
    const float dl0 = row0 < seq_q ? delta[vec + row0] : 0.f;
    const float dl1 = row0 + 8 < seq_q ? delta[vec + row0 + 8] : 0.f;
    // the last key each row sees under the causal mask
    const int last0 = row0 + offset;
    const int last1 = row0 + 8 + offset;

    float acc_dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;

    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % S;
      const int k0 = j * DQ_KV;
      const uint32_t k_base =
          hopper::smem_u32(smem + L::RING_OFF + s * L::STAGE_BYTES);
      const uint32_t v_base = k_base + L::KV_BYTES;
      hopper::mbar_wait(&full[s], (j / S) & 1);
      // a warpgroup whose rows all lie past seq_q, or (causal) a tile wholly
      // past the diagonal of its last row, adds nothing: under causal
      // masking the lower warpgroup skips the CTA's last tile when offset
      // is a multiple of 64
      if (wq0 < seq_q && (!causal || k0 <= wq0 + 63 + offset)) {
        // S = Q·K^T and dP = dO·V^T (q rows x kv columns)
        float acc_s[DQ_KV / 2], acc_dp[DQ_KV / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qstep = (kk / 4) * L::Q_CHUNK + (kk % 4) * 32;
          const uint32_t kstep = (kk / 4) * L::KV_CHUNK + (kk % 4) * 32;
          hopper::wgmma_ss_m64n64<0>(
              acc_s, hopper::desc_sw128(q_base + qstep, 16, hopper::SW128_ATOM),
              hopper::desc_sw128(k_base + kstep, 16, hopper::SW128_ATOM),
              kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qstep = (kk / 4) * L::Q_CHUNK + (kk % 4) * 32;
          const uint32_t kstep = (kk / 4) * L::KV_CHUNK + (kk % 4) * 32;
          hopper::wgmma_ss_m64n64<0>(
              acc_dp, hopper::desc_sw128(do_base + qstep, 16, hopper::SW128_ATOM),
              hopper::desc_sw128(v_base + kstep, 16, hopper::SW128_ATOM),
              kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(acc_s);
        hopper::fence_operands(acc_dp);

        // P and dS/sm_scale in f32; lse and delta by q row. Only tiles that
        // cross the diagonal or the ragged end of seq_k are masked.
        const bool mask = k0 + DQ_KV > seq_k ||
                          (causal && k0 + DQ_KV - 1 > wq0 + offset);
#pragma unroll
        for (int jc = 0; jc < DQ_KV / 8; ++jc) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v0 = fmaf(acc_s[4 * jc + e], c2, -lg0);
            float v1 = fmaf(acc_s[4 * jc + 2 + e], c2, -lg1);
            if (mask) {
              const int key = k0 + 8 * jc + cq + e;
              if (key >= seq_k || (causal && key > last0)) v0 = NEG_INF;
              if (key >= seq_k || (causal && key > last1)) v1 = NEG_INF;
            }
            const float p0 = hopper::exp2_approx(v0);
            const float p1 = hopper::exp2_approx(v1);
            acc_dp[4 * jc + e] = p0 * (acc_dp[4 * jc + e] - dl0);
            acc_dp[4 * jc + 2 + e] = p1 * (acc_dp[4 * jc + 2 + e] - dl1);
          }
        }
        // dS in bf16, laid out as wgmma's register A operand
        uint32_t dsa[DQ_KV / 16][4];
#pragma unroll
        for (int kk = 0; kk < DQ_KV / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            dsa[kk][r] = hopper::pack_bf16x2(acc_dp[8 * kk + 2 * r],
                                             acc_dp[8 * kk + 2 * r + 1]);
        }

        // dQ += dS·K: K (kv rows x d) is an MN-major B, 16 kv rows a step,
        // d chunks KV_CHUNK apart
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_KV / 16; ++kk) {
          const uint64_t db = hopper::desc_sw128(k_base + kk * 16 * 128,
                                                 L::KV_CHUNK, hopper::SW128_ATOM);
          if constexpr (D == 64)
            hopper::wgmma_rs_m64n64<1>(acc_dq, dsa[kk], db, 1);
          else
            hopper::wgmma_rs_m64n128<1>(acc_dq, dsa[kk], db, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(acc_dq);
      }
      hopper::mbar_arrive(&empty[s]);
    }

    // sm_scale, left out of dS above, multiplies the f32 sum once
    const long base = static_cast<long>(bh) * seq_q;
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc) {
      const int col = 8 * jc + cq;
      if (row0 < seq_q)
        *reinterpret_cast<uint32_t*>(dq + (base + row0) * D + col) =
            hopper::pack_bf16x2(acc_dq[4 * jc] * sm_scale,
                                acc_dq[4 * jc + 1] * sm_scale);
      if (row0 + 8 < seq_q)
        *reinterpret_cast<uint32_t*>(dq + (base + row0 + 8) * D + col) =
            hopper::pack_bf16x2(acc_dq[4 * jc + 2] * sm_scale,
                                acc_dq[4 * jc + 3] * sm_scale);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int seq_q, int seq_k, int causal,
                      float sm_scale, cudaStream_t stream) {
  BwdMaps tm;
  cudaError_t err = encode_bwd_maps<D>(tm, q, k, v, dout, bh, seq_q, seq_k,
                                       DQ_ROWS, DQ_KV);
  if (err != cudaSuccess) return err;
  constexpr uint32_t smem = DqSmem<D>::BYTES;
  static hopper_host::SmemLimit limit;
  err = hopper_host::allow_smem(flash_bwd_dq_tc_kernel<D>,
                                static_cast<int>(smem), limit);
  if (err != cudaSuccess) return err;
  const long blocks = static_cast<long>((seq_q + DQ_ROWS - 1) / DQ_ROWS) * bh;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_bwd_dq_tc_kernel<D><<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
      tm.q, tm.k, tm.v, tm.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), bh,
      seq_q, seq_k, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace tc

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

// The tensor-core route of `flash_bwd_dq`: the same arguments without
// is_bf16; q, k, v, dout bf16, head_dim 64 or 128. Returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int bh, int seq_q,
                               int seq_k, int head_dim, int causal,
                               float sm_scale, void* stream) {
  if (!valid(bh, seq_q, seq_k, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64)
    err = tc::launch_dq<64>(q, k, v, dout, lse, delta, dq, bh, seq_q, seq_k,
                            causal, sm_scale, s);
  else if (head_dim == 128)
    err = tc::launch_dq<128>(q, k, v, dout, lse, delta, dq, bh, seq_q, seq_k,
                             causal, sm_scale, s);
  return static_cast<int>(err);
}

// The tensor-core route of `flash_bwd_dkv`: the same arguments without
// is_bf16; q, k, v, dout bf16, head_dim 64 or 128. Returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int bh,
                                int seq_q, int seq_k, int head_dim, int causal,
                                float sm_scale, void* stream) {
  if (!valid(bh, seq_q, seq_k, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64)
    err = tc::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, seq_q,
                             seq_k, causal, sm_scale, s);
  else if (head_dim == 128)
    err = tc::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, seq_q,
                              seq_k, causal, sm_scale, s);
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
