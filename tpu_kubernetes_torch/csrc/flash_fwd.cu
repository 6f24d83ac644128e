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
// memory, so it is bound by shared-memory load issue. It stays as the f32
// route (the port runs no f32 product on TF32) and serves head_dim 16/32.
//
// Entry point `flash_fwd_tc`: the same function for bf16 at head_dim 64 or
// 128 on the tensor cores. One CTA of 384 threads per (128-row q tile,
// batch*head), launched heaviest first under causal masking: two consumer
// warpgroups of 64 q rows each and a producer warp. The producer loads the
// Q tile once and streams 128-row K and V tiles through a ring of 2 (d 128)
// or 3 (d 64) stages with TMA (3-D tensor maps over (d, seq, b*h), so rows
// past a head's seq read as zero and never come from the next head), each
// stage guarded by full/empty mbarriers. A consumer computes S = Q·K^T with
// wgmma m64n128k16 from shared memory, masks only the tiles that cross the
// offset-aligned diagonal or the ragged end to -1e30, runs the online
// softmax on the accumulator fragments in f32 (exp2 with sm_scale·log2(e)
// folded in), rounds P to bf16 in registers and feeds it as wgmma's
// register A operand for O += P·V (V row-major is an MN-major B). O is
// divided by the row sum at the end and written in bf16; the log-sum-exp is
// turned back to natural log, f32, one value per row, as the backward
// kernels read it. The numbers differ from the PR 1 kernel's in two places:
// Q is not pre-scaled (the scale multiplies the f32 scores), and P is
// rounded to bf16 before the division by the row sum rather than after.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

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
  static hopper_host::SmemLimit limit;
  cudaError_t err = hopper_host::allow_smem(flash_fwd_kernel<T, D>,
                                            static_cast<int>(smem), limit);
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

// -- the tensor-core kernel (bf16, head_dim 64 and 128) ----------------------------

namespace tc {

using hopper::CHUNK;

constexpr int BQ = 128;          // q rows per CTA: two consumer warpgroups
constexpr int BKV = 128;         // kv rows per tile
constexpr int NT = 384;          // 2 consumer warpgroups + the producer's
constexpr int CONSUMERS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int CH = D / CHUNK;                  // 64-wide d chunks
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr uint32_t Q_CHUNK = BQ * 128;         // bytes of one chunk
  static constexpr uint32_t KV_CHUNK = BKV * 128;
  static constexpr uint32_t Q_BYTES = CH * Q_CHUNK;
  static constexpr uint32_t KV_BYTES = CH * KV_CHUNK;   // one K or V tile
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, k_full[S], v_full[S], empty[S]; 1024 bytes to align the base
  static constexpr uint32_t BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int bh_count, int seq_q, int seq_k, int causal,
                    float sm_scale) {
  using L = Smem<D>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* empty = v_full + S;

  // heaviest first: under causal masking the last q tiles see the most keys
  const int n_qt = (seq_q + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count) * BQ;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int offset = seq_k - seq_q;
  const int kv_end = causal ? min(seq_k, q0 + BQ + offset) : seq_k;
  const int n_kv = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- producer: one thread issues every TMA load ---------------------------
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 2 * 128) {
      hopper::prefetch_tensor_map(&tm_q);
      hopper::prefetch_tensor_map(&tm_k);
      hopper::prefetch_tensor_map(&tm_v);
      hopper::mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::CH; ++c)
        hopper::tma_load_3d(smem + c * L::Q_CHUNK, &tm_q, q_full, c * CHUNK,
                            q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % S, round = j / S;
        if (round > 0) hopper::mbar_wait(&empty[s], (round - 1) & 1);
        uint8_t* kt = smem + L::K_OFF + s * L::KV_BYTES;
        uint8_t* vt = smem + L::V_OFF + s * L::KV_BYTES;
        hopper::mbar_arrive_expect_tx(&k_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::CH; ++c)
          hopper::tma_load_3d(kt + c * L::KV_CHUNK, &tm_k, &k_full[s],
                              c * CHUNK, j * BKV, bh);
        hopper::mbar_arrive_expect_tx(&v_full[s], L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::CH; ++c)
          hopper::tma_load_3d(vt + c * L::KV_CHUNK, &tm_v, &v_full[s],
                              c * CHUNK, j * BKV, bh);
      }
    }
  } else {
    // -- consumers: 64 q rows each ---------------------------------------------
    hopper::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * (t / 32) + lane / 4;   // and row0 + 8
    const int cq = 2 * (lane % 4);
    const float c2 = sm_scale * LOG2E;   // scores in base-2 exponent units
    const uint32_t q_base = hopper::smem_u32(smem) + wg * 64 * 128;

    float acc_o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;   // running max, base 2
    float l0 = 0.f, l1 = 0.f;               // this thread's share of the sum

    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % S;
      const uint32_t ph = (j / S) & 1;
      const int k0 = j * BKV;
      const uint32_t k_base = hopper::smem_u32(smem + L::K_OFF + s * L::KV_BYTES);
      const uint32_t v_base = hopper::smem_u32(smem + L::V_OFF + s * L::KV_BYTES);

      float acc_s[BKV / 2];
      hopper::mbar_wait(&k_full[s], ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk / 4) * L::Q_CHUNK + (kk % 4) * 32;
        const uint32_t kstep = (kk / 4) * L::KV_CHUNK + (kk % 4) * 32;
        hopper::wgmma_ss_m64n128<0>(
            acc_s, hopper::desc_sw128(q_base + step, 16, hopper::SW128_ATOM),
            hopper::desc_sw128(k_base + kstep, 16, hopper::SW128_ATOM),
            kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc_s);

      // only tiles that cross the diagonal or the ragged end are masked
      const bool mask = k0 + BKV > seq_k ||
                        (causal && k0 + BKV - 1 > q0 + offset);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jc = 0; jc < BKV / 8; ++jc) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v0 = acc_s[4 * jc + e] * c2;
          float v1 = acc_s[4 * jc + 2 + e] * c2;
          if (mask) {
            const int col = k0 + 8 * jc + cq + e;
            if (col >= seq_k || (causal && col > row0 + offset)) v0 = NEG_INF;
            if (col >= seq_k || (causal && col > row0 + 8 + offset)) v1 = NEG_INF;
          }
          acc_s[4 * jc + e] = v0;
          acc_s[4 * jc + 2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
      // the four lanes of a quad hold one row between them
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = hopper::exp2_approx(m0 - mx0);
      const float alpha1 = hopper::exp2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int jc = 0; jc < BKV / 8; ++jc) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = hopper::exp2_approx(acc_s[4 * jc + e] - mx0);
          const float p1 = hopper::exp2_approx(acc_s[4 * jc + 2 + e] - mx1);
          acc_s[4 * jc + e] = p0;
          acc_s[4 * jc + 2 + e] = p1;
          sum0 += p0;
          sum1 += p1;
        }
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int jc = 0; jc < D / 8; ++jc) {
        acc_o[4 * jc] *= alpha0;
        acc_o[4 * jc + 1] *= alpha0;
        acc_o[4 * jc + 2] *= alpha1;
        acc_o[4 * jc + 3] *= alpha1;
      }
      // P in bf16, laid out as wgmma's register A operand
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = hopper::pack_bf16x2(acc_s[8 * kk + 2 * r],
                                          acc_s[8 * kk + 2 * r + 1]);
      }

      hopper::mbar_wait(&v_full[s], ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        // V (kv rows x d) is MN-major: 16 kv rows a step, d chunks KV_CHUNK apart
        const uint64_t db = hopper::desc_sw128(v_base + kk * 16 * 128,
                                               L::KV_CHUNK, hopper::SW128_ATOM);
        if constexpr (D == 64)
          hopper::wgmma_rs_m64n64<1>(acc_o, pa[kk], db, 1);
        else
          hopper::wgmma_rs_m64n128<1>(acc_o, pa[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc_o);
      hopper::mbar_arrive(&empty[s]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const long base = static_cast<long>(bh) * seq_q;
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc) {
      const int col = 8 * jc + cq;
      if (row0 < seq_q)
        *reinterpret_cast<uint32_t*>(o + (base + row0) * D + col) =
            hopper::pack_bf16x2(acc_o[4 * jc] * inv0, acc_o[4 * jc + 1] * inv0);
      if (row0 + 8 < seq_q)
        *reinterpret_cast<uint32_t*>(o + (base + row0 + 8) * D + col) =
            hopper::pack_bf16x2(acc_o[4 * jc + 2] * inv1,
                                acc_o[4 * jc + 3] * inv1);
    }
    if (lane % 4 == 0) {
      if (row0 < seq_q) lse[base + row0] = m0 * LN2 + logf(l0);
      if (row0 + 8 < seq_q) lse[base + row0 + 8] = m1 * LN2 + logf(l1);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int seq_q, int seq_k, int causal,
                   float sm_scale, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorInvalidValue;   // TMA reads from 16-byte aligned bases
  CUtensorMap tm_q, tm_k, tm_v;
  const uint32_t box_q[3] = {CHUNK, BQ, 1}, box_kv[3] = {CHUNK, BKV, 1};
  const uint64_t dims_q[3] = {D, static_cast<uint64_t>(seq_q),
                              static_cast<uint64_t>(bh)};
  const uint64_t dims_kv[3] = {D, static_cast<uint64_t>(seq_k),
                               static_cast<uint64_t>(bh)};
  const uint64_t str_q[2] = {D * 2, static_cast<uint64_t>(seq_q) * D * 2};
  const uint64_t str_kv[2] = {D * 2, static_cast<uint64_t>(seq_k) * D * 2};
  cudaError_t err = hopper_host::encode_bf16(&tm_q, q, 3, dims_q, str_q, box_q);
  if (err == cudaSuccess)
    err = hopper_host::encode_bf16(&tm_k, k, 3, dims_kv, str_kv, box_kv);
  if (err == cudaSuccess)
    err = hopper_host::encode_bf16(&tm_v, v, 3, dims_kv, str_kv, box_kv);
  if (err != cudaSuccess) return err;
  constexpr uint32_t smem = Smem<D>::BYTES;
  static hopper_host::SmemLimit limit;
  err = hopper_host::allow_smem(flash_fwd_tc_kernel<D>, static_cast<int>(smem),
                                limit);
  if (err != cudaSuccess) return err;
  const long blocks = static_cast<long>((seq_q + BQ - 1) / BQ) * bh;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  flash_fwd_tc_kernel<D><<<static_cast<unsigned>(blocks), NT, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), bh, seq_q, seq_k, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The tensor-core route: q (bh, seq_q, head_dim), k/v (bh, seq_k,
// head_dim) contiguous bf16 with head_dim 64 or 128; o like q; lse (bh,
// seq_q) f32. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int seq_q, int seq_k,
                            int head_dim, int causal, float sm_scale,
                            void* stream) {
  if (bh <= 0 || seq_q <= 0 || seq_k <= 0 || (causal && seq_q > seq_k))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (head_dim) {
    case 64:
      err = tc::launch<64>(q, k, v, o, lse, bh, seq_q, seq_k, causal, sm_scale, s);
      break;
    case 128:
      err = tc::launch<128>(q, k, v, o, lse, bh, seq_q, seq_k, causal, sm_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

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
