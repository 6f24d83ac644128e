// Decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// A kernel of the port alone: it replaces no Pallas kernel. The JAX package
// computes decode attention in `_attend_cache`
// (tpu_kubernetes/models/decode.py:152-197), and for the paged cache first
// gathers each row's pages into a (max_pages * page_size)-wide virtual dense
// row (`virtual` in `decode_step_paged`, :1270-1313); XLA fuses that gather,
// the f32 casts of the cache and the two einsums inside the jitted step. The
// port's plain version (`tpu_kubernetes_torch/ops/decode_attention.py`,
// `decode_attention_reference`) runs them as separate kernels: an f32 copy
// of the whole cache span in every layer and step, the scores, the softmax
// and P.V, and for the paged cache a gathered copy of every row besides.
//
// Computes, for a chunk of c <= MAX_CHUNK query positions a row (q (b, h, c,
// d); c = 1 is a decode step, c = k + 1 a speculative verify window): query
// head hq = g * rep + r at chunk position j attends the KV head g's
// positions p < limits[row, j], less the pad gap [prompt_lengths[row],
// prompt_slots) of a ragged row, with
// scores scaled by sm_scale in f32, an f32 softmax and P.V in f32, and o
// written once in the cache's dtype (bf16 or f32). A position's K/V row
// lies at
//   dense: k + row * s0 + g * s1 + p * s2,
//   paged: k + table[row, p / page_size] * s0 + g * s1 + (p % page_size) * s2
// (strides in elements, the last dimension contiguous).
//
// Bound: bytes. Each admitted position's K and V rows are read once, for
// all `rep` query heads of their group, in 16-byte vector loads; q is read
// once and o written once; the work per byte (2 * rep flops a K or V value)
// is far below the card's ratio. What the design does about it:
//
// * one block per (split of SPLIT positions, KV head, row). The split is a
//   fixed number of positions, the same for every batch and for both
//   layouts, so dense and paged read and sum in the same order and give the
//   same bits. The grid covers the full span (shapes are static under a
//   CUDA graph, and nothing reads a limit on the host); a block whose
//   split lies wholly past the row's largest limit, or inside its pad gap,
//   writes an empty partial (max -inf, sum 0) and returns without reading
//   the cache;
// * positions the masks exclude are never read. The plain version weights
//   them by exp(-1e30 - m) = 0.0 exactly, so skipping them changes only the
//   order of the sums;
// * inside a block, a group of D / VEC lanes takes one position at a time,
//   with UNROLL positions' loads in flight (a split is short, so a block's
//   chain of dependent loads is too): each lane loads 16 bytes of the K
//   row, the group's dot products with
//   the rep query rows (held in shared memory as f32) are reduced by
//   shuffles, and the split's scores go to shared memory. The split's max
//   and sum per query head follow, then the same groups stream the V rows
//   and accumulate p * v in registers; warps reduce by shuffles, then
//   through shared memory, in a fixed order;
// * a second, small kernel merges the splits of each (row, query head),
//   rescaling each partial by exp(m_split - m), in a fixed order and with
//   no float atomics: a replay gives the same bits every time. Empty
//   splits cost it no load of their accumulators.
//
// The int8 route (`decode_attention_q8`, kernel `decode_attention_q8_kernel`)
// is the same kernel over an int8 cache (`kv_quant`, the reference's
// `_attend_cache` with `k_scale`/`v_scale`, decode.py:167-169, 193-195):
// a K/V row loads as 8-byte vectors of int8, widened in registers and
// multiplied by its position's f32 scale (read once a position a KV head,
// the same `k32 * k_scale` product as the reference), so the cache's bytes
// a position are d + 4 in place of 2d; the splits, the masks, the paged
// addressing and the merge are the bf16/f32 kernel's. q and o stay bf16 or
// f32.
//
// A column is one (query head, chunk position) pair of a KV head's rep * c:
// column r * c + j, whose q and o rows are contiguous in (b, h, c, d). The
// columns of a KV head share one pass over the split's K/V, up to MAX_RC of
// them (their accumulators are registers, sized by a template parameter:
// 1, 2, 4 or MAX_RC for a decode step, MAX_RC for a chunk); more (rep * c >
// MAX_RC) take ceil(rep * c / MAX_RC) passes. Each column masks the
// positions past its own limit; a column
// with none admitted in a split writes an empty partial there. Every
// column must leave at least one position unmasked (position limit - 1 is
// the chunk row's own new token); a column with none has no defined
// softmax here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;                 // threads a block: 4 warps
constexpr int NWARPS = NT / 32;
constexpr int SPLIT = 64;               // positions a block
constexpr int UNROLL = 4;               // loads a lane keeps in flight
constexpr int MAX_RC = 8;               // columns a pass over K/V
constexpr int MAX_SPLITS = 1024;        // a span of at most 65,536
constexpr int MAX_CHUNK = 16;           // query positions a row

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_m;                        // (b, h * c, n_splits)
  float* part_l;                        // (b, h * c, n_splits)
  float* part_acc;                      // (b, h * c, n_splits, d)
  const long long* limits;              // [row * limits_stride + j * c_stride]
  long long limits_stride, c_stride;
  const int* prompt_lengths;            // (b,) or null: no pad gap
  const int* prompt_slots;              // (b,) or null: the scalar below
  int prompt_slots_scalar;
  const int* table;                     // (b, max_pages) or null: dense
  int max_pages;
  int page_size;
  int b, h, kv, c, span, n_splits;
  long long ks0, ks1, ks2, vs0, vs1, vs2;
  float sm_scale;
  const float* k_scale;                 // int8 route: a position's scales,
  const float* v_scale;                 // laid out as k/v less the last dim
  long long kss0, kss1, kss2, vss0, vss1, vss2;
};

// 16 bytes of T, widened to f32
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&x)[N]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float get(const __nv_bfloat16* p,
                                              long long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, long long i,
                                             float x) {
    p[i] = __float2bfloat16_rn(x);
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[N]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = u.x;
    x[1] = u.y;
    x[2] = u.z;
    x[3] = u.w;
  }
  static __device__ __forceinline__ float get(const float* p, long long i) {
    return p[i];
  }
  static __device__ __forceinline__ void put(float* p, long long i, float x) {
    p[i] = x;
  }
};

// 8 int8 values (8 bytes), widened to f32; the caller applies the scale
template <>
struct Vec<int8_t> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const int8_t* p, float (&x)[N]) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = static_cast<float>(b[i]);
  }
};

// chunk position j's limit of a row, at most the span
__device__ __forceinline__ int col_limit(const Args& a, int row, int j) {
  const long long lim = a.limits[row * a.limits_stride + j * a.c_stride];
  return static_cast<int>(lim < a.span ? lim : a.span);
}

__device__ __forceinline__ bool in_gap(int p, int gap_lo, int gap_hi) {
  return p >= gap_lo && p < gap_hi;
}

// the offset, in elements, of position p's row of KV head g
__device__ __forceinline__ long long row_offset(const int* tab, int row, int p,
                                                int ps, long long s0,
                                                long long s2) {
  if (tab == nullptr) return row * s0 + p * s2;
  const int i = p / ps;
  return static_cast<long long>(__ldg(tab + i)) * s0 + (p - i * ps) * s2;
}

// The body of both kernels: T the type of q and o, KT the cache's (T, or
// int8 with a scale a position). MULTI: more than one position a row
// (c > 1), so each column masks past its own limit; a decode step (c = 1)
// compiles without that mask
template <typename T, typename KT, int D, int RC, bool MULTI>
__device__ __forceinline__ void attend(const Args& a) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  constexpr int VEC = Vec<KT>::N;
  constexpr int LPR = D / VEC;          // lanes a K/V row: 2..32
  constexpr int GROUPS = NT / LPR;      // positions in flight a block
  static_assert(LPR >= 1 && LPR <= 32 && (32 % LPR) == 0, "head_dim");

  __shared__ float s_q[RC][D];
  __shared__ int s_lim[RC];
  __shared__ float s_p[RC][SPLIT];
  __shared__ float s_acc[NWARPS][RC][D];

  const int split = blockIdx.x, g = blockIdx.y, row = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / LPR, sub = tid % LPR;
  const int cols = a.h / a.kv * a.c;     // the KV head's columns

  int lim = col_limit(a, row, 0);       // the row's largest limit
  if (MULTI)
    for (int j = 1; j < a.c; ++j) {
      const int l = col_limit(a, row, j);
      lim = l > lim ? l : lim;
    }
  int gap_lo = 0, gap_hi = 0;           // the pad gap [gap_lo, gap_hi)
  if (a.prompt_lengths != nullptr) {
    gap_lo = a.prompt_lengths[row];
    gap_hi = a.prompt_slots != nullptr ? a.prompt_slots[row]
                                       : a.prompt_slots_scalar;
  }
  const int lo = split * SPLIT;
  const int hi = lim < lo ? lo : lim < lo + SPLIT ? lim : lo + SPLIT;
  const int n = hi - lo;
  const bool any = n > 0 && !(lo >= gap_lo && hi <= gap_hi);

  // the first column of this KV head, in (b, h * c) order
  const long long head0 =
      (static_cast<long long>(row) * a.h + g * (a.h / a.kv)) * a.c;
  if (!any) {
    // an empty partial: the merge skips it, so its acc is never read
    for (int r = tid; r < cols; r += NT) {
      const long long idx = (head0 + r) * a.n_splits + split;
      a.part_m[idx] = -INFINITY;
      a.part_l[idx] = 0.f;
    }
    return;
  }

  const T* q = static_cast<const T*>(a.q);
  const KT* kp = static_cast<const KT*>(a.k) + g * a.ks1 + sub * VEC;
  const KT* vp = static_cast<const KT*>(a.v) + g * a.vs1 + sub * VEC;
  const float* ksp = Q8 ? a.k_scale + g * a.kss1 : nullptr;
  const float* vsp = Q8 ? a.v_scale + g * a.vss1 : nullptr;
  const int* tab =
      a.table != nullptr ? a.table + static_cast<long long>(row) * a.max_pages
                         : nullptr;

  for (int r0 = 0; r0 < cols; r0 += RC) {
    const int rc = cols - r0 < RC ? cols - r0 : RC;
    for (int i = tid; i < rc * D; i += NT)
      s_q[i / D][i % D] = Vec<T>::get(q, (head0 + r0) * D + i);
    if (MULTI)
      for (int r = tid; r < rc; r += NT)
        s_lim[r] = col_limit(a, row, (r0 + r) % a.c);
    for (int i = tid; i < rc * SPLIT; i += NT) s_p[i / SPLIT][i % SPLIT] = -INFINITY;
    __syncthreads();

    // scores: a group takes positions grp, grp + GROUPS, ...; UNROLL
    // loads are issued before the first is used, and every lane of a warp
    // takes part in each round's shuffles
    for (int base = 0; base < n; base += GROUPS * UNROLL) {
      float x[UNROLL][VEC];
      bool valid[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * GROUPS + grp, p = lo + i;
        valid[u] = i < n && !in_gap(p, gap_lo, gap_hi);
        if (valid[u]) {
          Vec<KT>::load(
              kp + row_offset(tab, row, p, a.page_size, a.ks0, a.ks2), x[u]);
          if constexpr (Q8) {
            const float sc = __ldg(
                ksp + row_offset(tab, row, p, a.page_size, a.kss0, a.kss2));
#pragma unroll
            for (int j = 0; j < VEC; ++j) x[u][j] *= sc;
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) x[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * GROUPS + grp;
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          if (r < rc) {
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              s = fmaf(s_q[r][sub * VEC + j], x[u][j], s);
#pragma unroll
            for (int off = LPR / 2; off > 0; off >>= 1)
              s += __shfl_xor_sync(0xffffffffu, s, off);
            if (valid[u] && sub == 0 && (!MULTI || lo + i < s_lim[r]))
              s_p[r][i] = s * a.sm_scale;
          }
        }
      }
    }
    __syncthreads();

    // the split's max and sum a column; the scores become exp(s - m), and
    // a column with nothing admitted here keeps max -inf and weighs 0
    for (int r = warp; r < rc; r += NWARPS) {
      float m = -INFINITY;
      for (int i = lane; i < n; i += 32) m = fmaxf(m, s_p[r][i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float l = 0.f;
      for (int i = lane; i < n; i += 32) {
        // masked: exp(-inf) = 0; at c = 1 a split that runs has an
        // admitted position, so m is finite
        const float e = MULTI && m == -INFINITY ? 0.f : expf(s_p[r][i] - m);
        s_p[r][i] = e;
        l += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (lane == 0) {
        const long long idx = (head0 + r0 + r) * a.n_splits + split;
        a.part_m[idx] = m;
        a.part_l[idx] = l;
      }
    }
    __syncthreads();

    // P.V: each group accumulates its positions, VEC outputs a lane
    float acc[RC][VEC];
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;
    for (int base = 0; base < n; base += GROUPS * UNROLL) {
      float x[UNROLL][VEC];
      bool valid[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * GROUPS + grp, p = lo + i;
        valid[u] = i < n && !in_gap(p, gap_lo, gap_hi);
        if (valid[u]) {
          Vec<KT>::load(
              vp + row_offset(tab, row, p, a.page_size, a.vs0, a.vs2), x[u]);
          if constexpr (Q8) {
            const float sc = __ldg(
                vsp + row_offset(tab, row, p, a.page_size, a.vss0, a.vss2));
#pragma unroll
            for (int j = 0; j < VEC; ++j) x[u][j] *= sc;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!valid[u]) continue;
        const int i = base + u * GROUPS + grp;
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          if (r < rc) {
            const float pr = s_p[r][i];
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              acc[r][j] = fmaf(pr, x[u][j], acc[r][j]);
          }
        }
      }
    }
    // the groups of a warp, then the warps, in a fixed order
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r < rc) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float s = acc[r][j];
#pragma unroll
          for (int off = LPR; off < 32; off <<= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (lane < LPR) s_acc[warp][r][sub * VEC + j] = s;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < rc * D; i += NT) {
      const int r = i / D, e = i % D;
      float s = s_acc[0][r][e];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) s += s_acc[w][r][e];
      a.part_acc[((head0 + r0 + r) * a.n_splits + split) * D + e] = s;
    }
    __syncthreads();                    // s_q, s_p, s_acc are reused
  }
}

template <typename T, int D, int RC, bool MULTI>
__global__ void __launch_bounds__(NT)
    decode_attention_kernel(const __grid_constant__ Args a) {
  attend<T, T, D, RC, MULTI>(a);
}

template <typename T, int D, int RC, bool MULTI>
__global__ void __launch_bounds__(NT)
    decode_attention_q8_kernel(const __grid_constant__ Args a) {
  attend<T, int8_t, D, RC, MULTI>(a);
}

// o[row, hq, j] = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - m), m
// the largest m_s; empty splits (m_s = -inf) weigh 0 and their acc is not
// read. One block a column (row, query head, chunk position): the weights
// go to shared memory,
// then NT / D chunks of D threads each sum every (NT / D)-th split's acc
// (UNROLL at a time) and the chunks add up in order, so the sums have a
// fixed order.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
    decode_attention_merge_kernel(const __grid_constant__ Args a) {
  constexpr int CHUNKS = NT / D;
  __shared__ float s_w[MAX_SPLITS];
  __shared__ float s_red[NWARPS];
  __shared__ float s_acc[CHUNKS][D];
  const long long bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n_splits;
  const float* pm = a.part_m + bh * n;
  const float* pl = a.part_l + bh * n;

  float m = -INFINITY;
  for (int s = tid; s < n; s += NT) m = fmaxf(m, pm[s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) s_red[warp] = m;
  __syncthreads();
  m = s_red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) m = fmaxf(m, s_red[w]);
  __syncthreads();

  float l = 0.f;
  for (int s = tid; s < n; s += NT) {
    const float ms = pm[s];
    const float w = ms == -INFINITY ? 0.f : expf(ms - m);
    s_w[s] = w;
    l = fmaf(w, pl[s], l);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  if (lane == 0) s_red[warp] = l;
  __syncthreads();
  l = s_red[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) l += s_red[w];

  const int e = tid % D, c = tid / D;
  const float* acc_p = a.part_acc + bh * n * D + e;
  float acc = 0.f;
  for (int s0 = c; s0 < n; s0 += CHUNKS * UNROLL) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * CHUNKS;
      x[u] = s < n && s_w[s] != 0.f ? acc_p[static_cast<long long>(s) * D]
                                    : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int s = s0 + u * CHUNKS;
      if (s < n) acc = fmaf(s_w[s], x[u], acc);
    }
  }
  s_acc[c][e] = acc;
  __syncthreads();
  if (c == 0) {
#pragma unroll
    for (int k = 1; k < CHUNKS; ++k) acc += s_acc[k][e];
    Vec<T>::put(static_cast<T*>(a.o), bh * D + e, acc / l);
  }
}

template <typename T, typename KT, int D, int RC, bool MULTI>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const dim3 grid(a.n_splits, a.kv, a.b);
  if constexpr (std::is_same<KT, int8_t>::value)
    decode_attention_q8_kernel<T, D, RC, MULTI><<<grid, NT, 0, s>>>(a);
  else
    decode_attention_kernel<T, D, RC, MULTI><<<grid, NT, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attention_merge_kernel<T, D><<<a.b * a.h * a.c, NT, 0, s>>>(a);
  return cudaGetLastError();
}

// the columns a pass: a decode step's query heads of a KV head, rounded up
// to a power of two (their accumulators live in registers), at most
// MAX_RC; a chunk's, MAX_RC
template <typename T, typename KT, int D>
cudaError_t launch_rc(const Args& a, cudaStream_t s) {
  const int cols = a.h / a.kv * a.c;
  if (a.c > 1) return launch<T, KT, D, MAX_RC, true>(a, s);
  if (cols <= 1) return launch<T, KT, D, 1, false>(a, s);
  if (cols <= 2) return launch<T, KT, D, 2, false>(a, s);
  if (cols <= 4) return launch<T, KT, D, 4, false>(a, s);
  return launch<T, KT, D, MAX_RC, false>(a, s);
}

template <typename T, typename KT>
cudaError_t dispatch_dim(const Args& a, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch_rc<T, KT, 16>(a, s);
    case 32: return launch_rc<T, KT, 32>(a, s);
    case 64: return launch_rc<T, KT, 64>(a, s);
    case 128: return launch_rc<T, KT, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// the arguments both entry points share (null scales: the bf16/f32 route)
int make_args(Args& a, const void* q, const void* k, const void* v, void* o,
              float* part_m, float* part_l, float* part_acc,
              const long long* limits, long long limits_stride,
              long long c_stride, const int* prompt_lengths,
              const int* prompt_slots, int prompt_slots_scalar,
              const int* table, int max_pages, int page_size, int b, int h,
              int kv, int c, int span, long long ks0, long long ks1,
              long long ks2, long long vs0, long long vs1, long long vs2,
              float sm_scale) {
  if (b <= 0 || h <= 0 || kv <= 0 || h % kv || span <= 0 || c < 1 ||
      c > MAX_CHUNK ||
      span > MAX_SPLITS * SPLIT ||
      (table != nullptr && (max_pages <= 0 || page_size <= 0 ||
                            max_pages * page_size != span)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.part_m = part_m;
  a.part_l = part_l;
  a.part_acc = part_acc;
  a.limits = limits;
  a.limits_stride = limits_stride;
  a.c_stride = c_stride;
  a.prompt_lengths = prompt_lengths;
  a.prompt_slots = prompt_slots;
  a.prompt_slots_scalar = prompt_slots_scalar;
  a.table = table;
  a.max_pages = max_pages;
  a.page_size = page_size;
  a.b = b;
  a.h = h;
  a.kv = kv;
  a.c = c;
  a.span = span;
  a.n_splits = (span + SPLIT - 1) / SPLIT;
  a.ks0 = ks0;
  a.ks1 = ks1;
  a.ks2 = ks2;
  a.vs0 = vs0;
  a.vs1 = vs1;
  a.vs2 = vs2;
  a.sm_scale = sm_scale;
  a.k_scale = a.v_scale = nullptr;
  a.kss0 = a.kss1 = a.kss2 = a.vss0 = a.vss1 = a.vss2 = 0;
  return 0;
}

}  // namespace

// Positions a block: the wrapper sizes the partials by it.
extern "C" int decode_attention_split() { return SPLIT; }

// q (b, h, c, d) contiguous, 1 <= c <= MAX_CHUNK; k/v dense (b, kv, span, d) or, with `table`
// (b, max_pages) int32, one layer of a page pool (n_pages + 1, kv,
// page_size, d), in both cases with element strides (s0, s1, s2) and the
// last dimension contiguous, 16-byte aligned rows; all bf16 (is_bf16=1) or
// all f32; o like q. limits int64 at [row * limits_stride + j * c_stride]
// for chunk position j; prompt_lengths (b,) int32 or null (no pad gap);
// prompt_slots (b,) int32, or null and then prompt_slots_scalar for every
// row. part_m, part_l (b, h * c, n_splits) and part_acc (b, h * c,
// n_splits, d) f32 scratch, n_splits = ceil(span / SPLIT). Launches two kernels on `stream`,
// allocates nothing, returns cudaGetLastError() (0 = launched).
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, void* o, float* part_m,
    float* part_l, float* part_acc, const long long* limits,
    long long limits_stride, long long c_stride, const int* prompt_lengths,
    const int* prompt_slots, int prompt_slots_scalar, const int* table,
    int max_pages, int page_size, int b, int h, int kv, int c, int head_dim,
    int span, int is_bf16, long long ks0,
    long long ks1, long long ks2, long long vs0, long long vs1, long long vs2,
    float sm_scale, void* stream) {
  Args a;
  const int bad = make_args(a, q, k, v, o, part_m, part_l, part_acc, limits,
                            limits_stride, c_stride, prompt_lengths,
                            prompt_slots, prompt_slots_scalar, table,
                            max_pages, page_size, b, h, kv, c, span, ks0,
                            ks1, ks2, vs0, vs1, vs2, sm_scale);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_dim<__nv_bfloat16, __nv_bfloat16>(a, head_dim, s)
              : dispatch_dim<float, float>(a, head_dim, s);
  return static_cast<int>(err);
}

// The int8 route: as `decode_attention`, with k/v int8 (the same layouts
// and strides, rows 8-byte aligned) and k_scale/v_scale f32, a position's
// scale of KV head g at k_scale + row * kss0 + g * kss1 + p * kss2 (paged:
// table[row, p / page_size] * kss0 + g * kss1 + (p % page_size) * kss2);
// q and o bf16 (is_bf16=1) or f32.
extern "C" int decode_attention_q8(
    const void* q, const void* k, const void* v, void* o, float* part_m,
    float* part_l, float* part_acc, const float* k_scale,
    const float* v_scale, const long long* limits, long long limits_stride,
    long long c_stride, const int* prompt_lengths, const int* prompt_slots,
    int prompt_slots_scalar, const int* table, int max_pages, int page_size,
    int b, int h, int kv, int c, int head_dim, int span, int is_bf16,
    long long ks0, long long ks1, long long ks2, long long vs0, long long vs1,
    long long vs2, long long kss0, long long kss1, long long kss2,
    long long vss0, long long vss1, long long vss2, float sm_scale,
    void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  const int bad = make_args(a, q, k, v, o, part_m, part_l, part_acc, limits,
                            limits_stride, c_stride, prompt_lengths,
                            prompt_slots, prompt_slots_scalar, table,
                            max_pages, page_size, b, h, kv, c, span, ks0,
                            ks1, ks2, vs0, vs1, vs2, sm_scale);
  if (bad) return bad;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.kss0 = kss0;
  a.kss1 = kss1;
  a.kss2 = kss2;
  a.vss0 = vss0;
  a.vss1 = vss1;
  a.vss2 = vss2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_dim<__nv_bfloat16, int8_t>(a, head_dim, s)
              : dispatch_dim<float, int8_t>(a, head_dim, s);
  return static_cast<int>(err);
}
