// Fused multi-tensor AdamW for Hopper (sm_90a), plain C interface for
// ctypes.
//
// A kernel of the port alone: the JAX package has no Pallas kernel here.
// Its train step (tpu_kubernetes/train/trainer.py, `make_optimizer`:
// optax.chain(clip_by_global_norm, adamw)) runs inside one jitted program,
// where XLA fuses the update. The port's eager update ran about a dozen
// f32 elementwise kernels a leaf plus an f32 copy of every gradient for
// the norm; these two launches do the same arithmetic in one pass.
//
// * `adamw_sumsq`: the sum of squares of every gradient leaf, in f32. One
//   block per CHUNK elements of a leaf writes its partial sum; the block
//   that finishes last (an integer ticket, no float atomics) adds the
//   partials in block order and writes sqrt(sum). The order of every sum
//   is fixed by the grid alone, so a replay gives the same norm each time.
// * `adamw_update`: per element, in place, what the plain version
//   (`tpu_kubernetes_torch/ops/adamw.py`, `adamw_update_reference_`)
//   computes: the clip as a divisor and a factor (the norm rounded to the
//   leaf's dtype, and the clip; 1 and 1 below the clip), mu and nu in f32
//   stored in the leaf's dtype, the bias corrections, u + wd * p, and
//   p + lr * u with lr rounded to the leaf's dtype. Every operation is a
//   correctly rounded __f*_rn intrinsic, so no contraction into an FMA
//   moves a rounding: given the same norm, the result is the plain
//   version's bit for bit.
//
// The leaves (at most MAX_LEAVES: a model's stacked leaves are a dozen)
// travel as one kernel parameter (`__grid_constant__`, read in place, never
// copied per thread): their addresses, sizes and dtypes (bf16 or f32, the
// MoE router). Under a CUDA graph the parameter is captured by
// value, which is right: the state's addresses are fixed, and so are the
// gradients' in the graph's pool. Bound: bytes. The update reads g, p, mu
// and nu and writes p, mu and nu (14 bytes an element in bf16), the norm
// reads g once more (2 bytes); 16-byte vector loads and stores where a
// leaf's four tensors are 16-byte aligned, one element at a time for the
// tail of a leaf and for any leaf that is not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 48;
constexpr int NT = 256;
constexpr int VEC = 8;                 // elements a thread takes at once
constexpr int CHUNK = 16384;           // elements a block; a VEC multiple

struct Leaves {
  int n;
  int first_block[MAX_LEAVES + 1];     // leaf i owns [first_block[i], ..[i+1])
  long long numel[MAX_LEAVES];
  unsigned char bf16[MAX_LEAVES];      // 1: bf16, 0: f32
  unsigned char vec[MAX_LEAVES];       // 1: all of its tensors 16B aligned
  const void* g[MAX_LEAVES];
  void* p[MAX_LEAVES];
  void* mu[MAX_LEAVES];
  void* nu[MAX_LEAVES];
};

struct Hyper {
  float one_minus_b1, b1, one_minus_b2, b2, eps, wd, clip;
};

__device__ __forceinline__ int leaf_of(const Leaves& t, int block) {
  int i = 0;
  while (block >= t.first_block[i + 1]) ++i;
  return i;
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float get(const void* b, long long i) {
    return static_cast<const float*>(b)[i];
  }
  static __device__ __forceinline__ void put(void* b, long long i, float x) {
    static_cast<float*>(b)[i] = x;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void get8(const void* b, long long i,
                                              float (&x)[VEC]) {
    const float4* s = reinterpret_cast<const float4*>(
        static_cast<const float*>(b) + i);
    const float4 a = s[0], c = s[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
  }
  static __device__ __forceinline__ void put8(void* b, long long i,
                                              const float (&x)[VEC]) {
    float4* d = reinterpret_cast<float4*>(static_cast<float*>(b) + i);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const void* b, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i]);
  }
  static __device__ __forceinline__ void put(void* b, long long i, float x) {
    static_cast<__nv_bfloat16*>(b)[i] = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void get8(const void* b, long long i,
                                              float (&x)[VEC]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(b) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void put8(void* b, long long i,
                                              const float (&x)[VEC]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(b) + i) = raw;
  }
};

// the block's sum of v, in an order fixed by the thread layout alone;
// valid in thread 0
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[NT / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < NT / 32; ++w) s = __fadd_rn(s, warp_sums[w]);
  }
  __syncthreads();
  return s;
}

// the end of the part of [begin, end) that the vector loop takes: all of
// it but a leaf's last (end - begin) % VEC elements when the leaf is
// aligned, none of it when not
__device__ __forceinline__ long long vector_end(const Leaves& t, int leaf,
                                                long long begin,
                                                long long end) {
  return t.vec[leaf] ? begin + (end - begin) / VEC * VEC : begin;
}

template <typename T>
__device__ __forceinline__ float chunk_sumsq(const Leaves& t, int leaf,
                                             long long begin, long long end) {
  const void* g = t.g[leaf];
  const long long vend = vector_end(t, leaf, begin, end);
  float acc = 0.f;
  for (long long i = begin + VEC * threadIdx.x; i < vend; i += VEC * NT) {
    float x[VEC];
    Io<T>::get8(g, i, x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
  }
  for (long long j = vend + threadIdx.x; j < end; j += NT) {
    const float x = Io<T>::get(g, j);
    acc = __fadd_rn(acc, __fmul_rn(x, x));
  }
  return acc;
}

__global__ void __launch_bounds__(NT)
    adamw_sumsq_kernel(const __grid_constant__ Leaves t,
                       float* __restrict__ partial,
                       unsigned int* __restrict__ ticket,
                       float* __restrict__ norm) {
  const int leaf = leaf_of(t, blockIdx.x);
  const long long begin =
      static_cast<long long>(blockIdx.x - t.first_block[leaf]) * CHUNK;
  const long long end =
      begin + CHUNK < t.numel[leaf] ? begin + CHUNK : t.numel[leaf];
  const float acc = t.bf16[leaf]
                        ? chunk_sumsq<__nv_bfloat16>(t, leaf, begin, end)
                        : chunk_sumsq<float>(t, leaf, begin, end);
  const float s = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    __threadfence();                   // the partial before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float total = 0.f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += NT)
    total = __fadd_rn(total, __ldcg(partial + b));
  total = block_sum(total);
  if (threadIdx.x == 0) {
    *norm = __fsqrt_rn(total);
    *ticket = 0u;
  }
}

// one element of the update, every operation rounded once
__device__ __forceinline__ void adamw_element(const Hyper& h, float div,
                                              float mul, float lr, float bc1,
                                              float bc2, float g, float& p,
                                              float& mu, float& nu) {
  g = __fmul_rn(__fdiv_rn(g, div), mul);
  mu = __fadd_rn(__fmul_rn(h.one_minus_b1, g), __fmul_rn(h.b1, mu));
  nu = __fadd_rn(__fmul_rn(h.one_minus_b2, __fmul_rn(g, g)),
                 __fmul_rn(h.b2, nu));
  float u = __fdiv_rn(__fdiv_rn(mu, bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), h.eps));
  u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(lr, u));
}

template <typename T>
__device__ __forceinline__ void chunk_update(const Leaves& t, int leaf,
                                             long long begin, long long end,
                                             const Hyper& h, float nrm,
                                             const float* scalars) {
  // optax's select (`norm < clip`) as a divisor and a factor: below the
  // clip g / 1 * 1 is g itself
  const bool keep = nrm < h.clip;
  const float div = keep ? 1.f : Io<T>::round(nrm);
  const float mul = keep ? 1.f : h.clip;
  const float lr = Io<T>::round(scalars[0]);
  const float bc1 = scalars[1], bc2 = scalars[2];
  const void* g = t.g[leaf];
  void* p = t.p[leaf];
  void* mu = t.mu[leaf];
  void* nu = t.nu[leaf];
  const long long vend = vector_end(t, leaf, begin, end);
  for (long long i = begin + VEC * threadIdx.x; i < vend; i += VEC * NT) {
    float gv[VEC], pv[VEC], mv[VEC], nv[VEC];
    Io<T>::get8(g, i, gv);
    Io<T>::get8(p, i, pv);
    Io<T>::get8(mu, i, mv);
    Io<T>::get8(nu, i, nv);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      adamw_element(h, div, mul, lr, bc1, bc2, gv[k], pv[k], mv[k], nv[k]);
    Io<T>::put8(p, i, pv);
    Io<T>::put8(mu, i, mv);
    Io<T>::put8(nu, i, nv);
  }
  for (long long j = vend + threadIdx.x; j < end; j += NT) {
    float pj = Io<T>::get(p, j), mj = Io<T>::get(mu, j),
          nj = Io<T>::get(nu, j);
    adamw_element(h, div, mul, lr, bc1, bc2, Io<T>::get(g, j), pj, mj, nj);
    Io<T>::put(p, j, pj);
    Io<T>::put(mu, j, mj);
    Io<T>::put(nu, j, nj);
  }
}

__global__ void __launch_bounds__(NT)
    adamw_update_kernel(const __grid_constant__ Leaves t,
                        const float* __restrict__ norm,
                        const float* __restrict__ scalars,
                        const __grid_constant__ Hyper h) {
  const int leaf = leaf_of(t, blockIdx.x);
  const long long begin =
      static_cast<long long>(blockIdx.x - t.first_block[leaf]) * CHUNK;
  const long long end =
      begin + CHUNK < t.numel[leaf] ? begin + CHUNK : t.numel[leaf];
  const float nrm = *norm;
  if (t.bf16[leaf])
    chunk_update<__nv_bfloat16>(t, leaf, begin, end, h, nrm, scalars);
  else
    chunk_update<float>(t, leaf, begin, end, h, nrm, scalars);
}

bool aligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// fills `t` from the host arrays; p, mu, nu may be null (the norm reads g
// only). → the grid, or -1 when the leaves do not fit
long long fill(Leaves& t, int n, const long long* numel, const int* is_bf16,
               const void* const* g, void* const* p, void* const* mu,
               void* const* nu) {
  if (n <= 0 || n > MAX_LEAVES) return -1;
  t.n = n;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] <= 0) return -1;
    t.first_block[i] = static_cast<int>(blocks);
    blocks += (numel[i] + CHUNK - 1) / CHUNK;
    if (blocks > 0x7fffffffLL) return -1;
    t.numel[i] = numel[i];
    t.bf16[i] = is_bf16[i] ? 1 : 0;
    t.g[i] = g[i];
    t.p[i] = p ? p[i] : nullptr;
    t.mu[i] = mu ? mu[i] : nullptr;
    t.nu[i] = nu ? nu[i] : nullptr;
    t.vec[i] = aligned(g[i]) && (!p || (aligned(p[i]) && aligned(mu[i]) &&
                                        aligned(nu[i])));
  }
  t.first_block[n] = static_cast<int>(blocks);
  return blocks;
}

}  // namespace

// The blocks of a launch over leaves of these sizes (the length of the
// partial sums `adamw_sumsq` takes); -1 when they do not fit.
extern "C" long long adamw_blocks(int n, const long long* numel) {
  if (n <= 0 || n > MAX_LEAVES) return -1;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] <= 0) return -1;
    blocks += (numel[i] + CHUNK - 1) / CHUNK;
  }
  return blocks <= 0x7fffffffLL ? blocks : -1;
}

// g[i]: n contiguous gradient leaves of numel[i] elements, bf16 where
// is_bf16[i] else f32; partial: adamw_blocks(n, numel) floats of scratch;
// ticket: one unsigned int, zero (the launch leaves it zero again); norm:
// one float, written with sqrt(sum of every g^2). Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (0 = launched).
extern "C" int adamw_sumsq(int n, const long long* numel, const int* is_bf16,
                           const void* const* g, float* partial,
                           long long partial_len, unsigned int* ticket,
                           float* norm, void* stream) {
  Leaves t;
  const long long blocks = fill(t, n, numel, is_bf16, g, nullptr, nullptr,
                                nullptr);
  if (blocks <= 0 || blocks != partial_len)
    return static_cast<int>(cudaErrorInvalidValue);
  adamw_sumsq_kernel<<<static_cast<unsigned>(blocks), NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(t, partial,
                                                            ticket, norm);
  return static_cast<int>(cudaGetLastError());
}

// The update in place: p[i], mu[i], nu[i] like g[i] (contiguous, same
// dtype); norm: the f32 global norm; scalars: three f32 values on the
// device, the step size (minus the learning rate of this count) and the
// two bias corrections; the rest AdamW's constants as f32. Launches on
// `stream`, allocates nothing, returns cudaGetLastError() (0 = launched).
extern "C" int adamw_update(int n, const long long* numel, const int* is_bf16,
                            const void* const* g, void* const* p,
                            void* const* mu, void* const* nu,
                            const float* norm, const float* scalars,
                            float one_minus_b1, float b1, float one_minus_b2,
                            float b2, float eps, float wd, float clip,
                            void* stream) {
  Leaves t;
  const long long blocks = fill(t, n, numel, is_bf16, g, p, mu, nu);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{one_minus_b1, b1, one_minus_b2, b2, eps, wd, clip};
  adamw_update_kernel<<<static_cast<unsigned>(blocks), NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, norm, scalars,
                                                             h);
  return static_cast<int>(cudaGetLastError());
}
