// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// mbarriers, TMA tile loads, cp.async copies completed on an mbarrier,
// thread-block cluster barriers and distributed shared-memory loads,
// warp-level mma.sync with ldmatrix and movmatrix, the exact widening of
// int8 to bf16 pairs, wgmma shared-memory descriptors and the wgmma
// instructions themselves, all as inline PTX, plus the host side: the
// encoding of a TMA tensor map, and the SM count and shared-memory limit
// that a launch needs, each asked of the runtime once per device. Included
// by flash_fwd.cu, flash_bwd.cu, grouped_matmul.cu, decode_attention_tc.cu,
// w8_matmul.cu and w8_matmul_tc.cu; the build hashes this header into the
// name of every library (ops/_build.py).
//
// Layout convention. Every tile that wgmma reads is loaded by TMA with
// CU_TENSOR_MAP_SWIZZLE_128B from a box whose inner extent is 64 bf16 (128
// bytes), so a tile is a stack of 128-byte rows, swizzled in atoms of 8 rows
// (1024 bytes), and each tile starts on a 1024-byte boundary. A wider
// operand is several such 64-column chunks one after another.
//
// * K-major operand (the contraction runs along the 128-byte row): the
//   descriptor's stride byte offset (SBO) is 1024, the step between 8-row
//   groups; the leading byte offset is unused. The k-th 16-deep slice of a
//   chunk starts 32·k bytes into it.
// * MN-major operand (rows are the contraction, the 64 contiguous values
//   run along M or N): SBO = 1024 is the step between groups of 8
//   contraction rows, LBO the step between 64-wide chunks along M/N. The
//   k-th 16-deep slice starts 16·128·k bytes in; wgmma's transpose bit is
//   set for such an operand (TRANS_B for B, TRANS_A for an A read from
//   shared memory; an A of 64 rows is one chunk, so its LBO is unused).
//
// Under the 128-byte swizzle the 16-byte pieces of a row are permuted only
// within that row, so row r of a chunk is bytes [128r, 128r + 128): a
// kernel may overwrite whole rows of a tile that TMA delivered (zeroing
// them) with ordinary stores, then fence_proxy_async() before wgmma reads
// the tile.
//
// Accumulator fragment of wgmma m64nNk16 (f32), thread t of the warpgroup,
// warp w = t / 32, lane l: d[4j + 0..1] is row 16w + l/4, columns
// 8j + 2(l%4) + 0..1; d[4j + 2..3] is the row 8 below. The register A
// operand of a following m64nNk16 takes the same rows and, for its 16-deep
// slice k, the pairs d[8k + 0..7] as four bf16x2 words: that is how a
// flash-attention P goes from the S accumulator into P·V (and the
// backward's Pᵀ and dSᵀ into dV and dK) without shared memory.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

constexpr uint32_t SW128_ATOM = 1024;   // bytes of one 8-row swizzle atom
constexpr int CHUNK = 64;               // bf16 values in one 128-byte row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers -----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// makes this thread's ordinary shared-memory stores visible to the async
// proxy (TMA, wgmma's shared-memory operands)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// waits for `threads` threads (a multiple of 32) at named barrier `id`
// (1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// arrives at named barrier `id` without waiting for it (the threads that
// wait there with named_barrier_sync see this thread's writes before it)
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// 2^x, approximate (2 ulp), flushing subnormals; 2^-1e30 is +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- TMA tile loads (completion counted in bytes on `bar`) ------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- cp.async copies completed on an mbarrier ------------------------------------

// copies 4 (or 16) bytes from global to shared memory, asynchronously
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// `bar` waits, in its current phase, for every cp.async this thread has
// issued: its pending count rises by one now and falls by one when they
// land, so the phase cannot complete before them
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// -- thread-block clusters ----------------------------------------------------------

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster: shared-memory writes before it
// are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the cluster address of `smem_addr` (a shared::cta address) in block `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t smem_addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_addr), "r"(rank));
  return r;
}

// the cluster barrier split in two: arrive (relaxed: after a
// fence_barrier_init it publishes the barriers' init) and wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void st_cluster_f32(uint32_t cluster_addr,
                                               float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               :: "r"(cluster_addr), "f"(v) : "memory");
}

// arrives on the mbarrier at `cluster_addr` (another block's, through
// mapa), releasing this thread's and, through a block barrier before it,
// its block's writes at cluster scope
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(cluster_addr) : "memory");
}

// mbar_wait with acquire at cluster scope: the writes other blocks released
// with their arrivals are visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t cluster_addr) {
  float x;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(x) : "r"(cluster_addr) : "memory");
  return x;
}

// -- warp-level mma.sync and its fragment moves ---------------------------------

// four 8x8 b16 matrices from shared memory, one row address a lane (lanes
// 8j..8j+7 give matrix j's rows); lane l gets row l/4, columns 2(l%4) and
// 2(l%4)+1 of each, or with TRANS, rows 2(l%4), 2(l%4)+1 of column l/4
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16"
                 " {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16"
                 " {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr) : "memory");
}

// the transpose of an 8x8 b16 matrix held one row a lane quad (lane l: row
// l/4, columns 2(l%4), 2(l%4)+1) in the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// d (16 x 8, f32) += a (16 x 16, row-major) · b (16 x 8, column-major),
// bf16 operands. Lane l, g = l/4, t = l%4: a = {(g, 2t..), (g+8, 2t..),
// (g, 2t+8..), (g+8, 2t+8..)}, b = {(2t.., g), (2t+8.., g)}, d = {(g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}; each pair packed low index first.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
      " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- int8 to bf16, exactly ------------------------------------------------------------

// Every int8 is a bf16. A byte u = x + 128 (x ^ 0x80) set into the low
// byte of the f32 2^23 (0x4B000000) is the f32 2^23 + u; less 2^23 + 128
// it is x, exactly, and x's f32 has at most 8 significant bits, so its
// upper half is x's bf16. Per value: a byte permute and an f32 add; per
// pair, one more permute that takes the two upper halves.
constexpr uint32_t I8_MAGIC = 0x4B000000u;
constexpr float I8_BIAS = 8388736.f;    // 2^23 + 128

// byte e of w (already XORed with 0x80808080) as an f32
__device__ __forceinline__ float i8_to_f32(uint32_t w_biased, int e) {
  return __uint_as_float(__byte_perm(w_biased, I8_MAGIC, 0x7440 | e)) -
         I8_BIAS;
}

// bf16x2 {lo, hi} from two f32 that are exact in bf16
__device__ __forceinline__ uint32_t upper_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// pairs across two words: p[e] = {bf16(a.byte e), bf16(b.byte e)}, e = 0..3
// (a column's values at two rows k and k + 1 of a row-major int8 tile)
__device__ __forceinline__ void i8_pairs_across(uint32_t a, uint32_t b,
                                                uint32_t (&p)[4]) {
  a ^= 0x80808080u;
  b ^= 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    p[e] = upper_halves(i8_to_f32(a, e), i8_to_f32(b, e));
}

// pairs within one word: {bf16(w.byte 0), bf16(w.byte 1)} and bytes 2, 3
__device__ __forceinline__ void i8_pairs_within(uint32_t w, uint32_t& p01,
                                                uint32_t& p23) {
  w ^= 0x80808080u;
  p01 = upper_halves(i8_to_f32(w, 0), i8_to_f32(w, 1));
  p23 = upper_halves(i8_to_f32(w, 2), i8_to_f32(w, 3));
}

// a bf16x2 product, correctly rounded (mul.rn.bf16x2)
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 16 bytes or 4 bytes of shared memory (a cta address)
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// -- warpgroup register split ------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// -- wgmma ---------------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of an accumulator above the
// wgmma_wait that completes it
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d (64 x N, f32) += A (64 x 16, shared; K-major, or MN-major with
// TRANS_A = 1) · B (16 x N, shared; K-major, or MN-major with TRANS_B = 1);
// scale_d = 0 overwrites d.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

// d (64 x N, f32) += A (64 x 16, four bf16x2 registers a thread) · B
// (16 x N, shared; MN-major with TRANS_B = 1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}


}  // namespace hopper

// -- host: TMA tensor maps -------------------------------------------------------------

namespace hopper_host {

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled (its CUDA 12.0 form), found through
// the runtime (CUDA 12.5 or later) so the library needs no -lcuda; nullptr
// when the driver does not offer it
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tensor of `type` and `rank` dimensions, innermost first: dims[i]
// values, strides[i] bytes between steps of dimension i + 1 (rank - 1 of
// them), read in boxes of box[i] values with `swizzle`, out-of-range
// elements read as zero. → cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type,
                          const void* base, int rank, const uint64_t* dims,
                          const uint64_t* strides, const uint32_t* box,
                          CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = fn(map, type, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(base), d, s, b, e,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// a bf16 tensor in 128-byte swizzled boxes (see encode)
inline cudaError_t encode_bf16(CUtensorMap* map, const void* base, int rank,
                               const uint64_t* dims, const uint64_t* strides,
                               const uint32_t* box) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

constexpr int MAX_DEVICES = 64;

// the current device (the wrappers make the tensors' device current), or
// -1 when it is past MAX_DEVICES and cannot be cached
inline int cached_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 0;
  return dev < MAX_DEVICES ? dev : -1;
}

// streaming multiprocessors of the current device, asked of the runtime
// once per device
inline int sm_count() {
  static std::atomic<int> cached[MAX_DEVICES];
  const int dev = cached_device();
  int n = dev >= 0 ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (n > 0) return n;
  int cur = 0;
  cudaGetDevice(&cur);
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, cur) !=
      cudaSuccess || n <= 0)
    n = 132;
  if (dev >= 0) cached[dev].store(n, std::memory_order_relaxed);
  return n;
}

// the dynamic shared memory one kernel has been allowed on each device;
// one zero-initialised static per kernel
struct SmemLimit {
  std::atomic<int> bytes[MAX_DEVICES];
};

// allows `kernel` `bytes` of dynamic shared memory on the current device,
// asking the runtime only the first time or when a launch needs more
template <typename Kernel>
inline cudaError_t allow_smem(Kernel* kernel, int bytes, SmemLimit& limit) {
  const int dev = cached_device();
  if (dev >= 0 && limit.bytes[dev].load(std::memory_order_relaxed) >= bytes)
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev >= 0) {
    int seen = limit.bytes[dev].load(std::memory_order_relaxed);
    while (seen < bytes &&
           !limit.bytes[dev].compare_exchange_weak(seen, bytes)) {
    }
  }
  return err;
}

}  // namespace hopper_host
