// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// tpu_kubernetes/ops/flash_attention.py (launched by `_fwd`). It computes
// the same thing: online-softmax attention over (batch*heads, seq, head_dim)
// tensors, causal aligned bottom-right (offset = seq_k - seq_q) or not,
// masked scores set to -1e30 exactly as the reference does, f32 running
// max / denominator / accumulator, O written in the inputs' type and the
// per-row log-sum-exp written as f32 (unbroadcast: one value per row).
//
// Design (first, simple version). One thread block of 128 threads per
// (64-row q tile, batch*head). Q (pre-scaled by sm_scale, as the TPU kernel
// does) and each 64-row K/V tile are staged in shared memory as f32; Q and
// K are stored transposed so a thread reads its 4 query rows and 8 key
// columns with float4 loads. Each thread owns a 4x8 tile of the score
// block; the 8 threads that share a row group reduce the row max and sum
// with warp shuffles. P goes back through shared memory for the P.V
// product, where each thread owns 4 rows x head_dim/8 output columns. The
// K/V walk stops at the offset-aligned causal diagonal. All products run
// on the CUDA cores in f32 (no TF32, no tensor cores).
//
// What bounds it on this card: at the main path's prefill shapes the work
// is far above the H100's ops-per-byte ridge, so a good kernel is bound by
// tensor-core operations. This one runs scalar f32 FMAs fed from shared
// memory, so it is bound by shared-memory load issue; wgmma, TMA and
// tuning are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;           // q rows per block
constexpr int BK = 64;           // kv rows per tile
constexpr int NT = 128;          // threads per block
constexpr int TS = BQ + 4;       // row stride of the transposed tiles (floats)
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

template <int D>
constexpr size_t smem_bytes() {
  // qT [D][TS], kT [D][TS], v [BK][D], pT [BK][TS]
  return sizeof(float) * (2 * D * TS + BK * D + BK * TS);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq_q, int seq_k, int causal,
                 float sm_scale) {
  constexpr int CPT = D / 8;     // output columns per thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + D * TS;
  float* vs = kT + D * TS;
  float* pT = vs + BK * D;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;       // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 7;        // column group within the row group
  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int offset = seq_k - seq_q;

  const T* qp = q + bh * seq_q * (long)D;
  const T* kp = k + bh * seq_k * (long)D;
  const T* vp = v + bh * seq_k * (long)D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D, gr = q0 + r;
    qT[d * TS + r] = gr < seq_q ? to_f32(qp[(long)gr * D + d]) * sm_scale : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // q tile rows [q0, q0 + BQ) see columns up to row + offset when causal
  const int kv_end = causal ? min(seq_k, q0 + BQ + offset) : seq_k;
  const int num_kb = (kv_end + BK - 1) / BK;

  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // last tile's readers are done; Q is visible
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D, gr = k0 + r;
      const bool ok = gr < seq_k;
      kT[d * TS + r] = ok ? to_f32(kp[(long)gr * D + d]) : 0.f;
      vs[r * D + d] = ok ? to_f32(vp[(long)gr * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qT + d * TS + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(kT + d * TS + tx * 8);
      const float4 kc = *reinterpret_cast<const float4*>(kT + d * TS + tx * 8 + 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx * 8 + j;
        const bool keep = col < seq_k && (!causal || col <= row + offset);
        if (!keep) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of a row group are lanes differing in the low 3 bits
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = expf(m[i] - mx);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(pT + (tx * 8 + j) * TS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    const int kn = min(BK, kv_end - k0);   // columns past kv_end add 0
    for (int j = 0; j < kn; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(pT + j * TS + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float* vrow = vs + j * D + tx * CPT;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = vrow[c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_q) continue;
    T* orow = o + (bh * seq_q + row) * (long)D + tx * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[c] = from_f32<T>(acc[i][c] / l[i]);
    if (tx == 0) lse[bh * seq_q + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq_q, int seq_k, int causal,
                   float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (seq_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq_q, seq_k, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int seq_q, int seq_k, int head_dim,
                         int causal, float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, seq_q, seq_k, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, seq_q, seq_k, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, seq_q, seq_k, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, seq_q, seq_k, causal, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (bh, seq_q, head_dim), k/v (bh, seq_k, head_dim) contiguous, all bf16
// (is_bf16=1) or all f32; o like q; lse (bh, seq_q) f32. Launches on
// `stream`, allocates nothing, returns cudaGetLastError() (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int seq_q, int seq_k, int head_dim,
                         int is_bf16, int causal, float sm_scale,
                         void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || (causal && seq_q > seq_k))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, bh, seq_q, seq_k,
                                            head_dim, causal, sm_scale, s)
              : dispatch_dim<float>(q, k, v, o, lse, bh, seq_q, seq_k,
                                    head_dim, causal, sm_scale, s);
  return static_cast<int>(err);
}
