// The Hopper pieces shared by the wgmma / TMA kernels (w4a8_dx.cu, w4a8_matmul.cu,
// wi8_matmul.cu, expert_ragged.cu, expert_ragged_bwd.cu, flash_blockwise.cu, flash_prefill.cu, int8_wgmma.cuh for
// w8a8_matmul.cu and vit_mlp.cu, int8_decode.cuh, decode_common.cuh): mbarriers, TMA
// tensor-map and bulk loads, the run-time lookup of the tensor-map encoder
// (cudaGetDriverEntryPoint: no -lcuda), shared-memory matrix descriptors for wgmma, the wgmma
// fence / commit / wait instructions, and the device's SM count.
//
// Descriptor fields (PTX ISA, "Matrix Descriptor Format"; checked on the card):
//   * unswizzled MN-major operand (w4a8_dx's B): 8 x 8 core matrices, LBO = bytes between
//     core matrices along K, SBO = bytes between them along M / N (swapped, every element is
//     wrong);
//   * K-major with the 128-byte swizzle (rows of 128 bytes, 16-byte chunk c of row r stored
//     at chunk c ^ (r % 8), the layout the TMA unit writes with CU_TENSOR_MAP_SWIZZLE_128B):
//     SBO = 1024 bytes (8 rows of 128 bytes), LBO unused, the tile base 1024-byte aligned;
//     a step along K inside the 128-byte row adds its byte offset to the start address;
//   * MN-major with the 128-byte swizzle (flash_blockwise's V, read with the transpose bit):
//     rows of 64 16-bit elements along N, one per K step; SBO = 1024 bytes between groups of
//     8 K rows, LBO = bytes between groups of 64 columns (CUTLASS's canonical GMMA layouts).
#pragma once

#include <cuda.h>   // CUtensorMap (the encoder is fetched at run time)
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace ovla_hp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// make the initialized barriers visible to the async proxy (TMA) and the other threads
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`; a wait past ~10 s of
// clocks (a broken ring) traps, so the launch fails instead of hanging the card. kHintNs > 0
// bounds how long a waiting thread stays suspended before it looks again (try_wait's suspend
// time hint; w4a8_grouped.cu's ring)
template <int kHintNs = 0>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    if constexpr (kHintNs > 0)
      asm volatile(
          "{\n"
          ".reg .pred P1;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2, %3;\n"
          "selp.u32 %0, 1, 0, P1;\n"
          "}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity), "n"(kHintNs)
          : "memory");
    else
      asm volatile(
          "{\n"
          ".reg .pred P1;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
          "selp.u32 %0, 1, 0, P1;\n"
          "}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// ---- TMA and bulk copies ----
// a TMA box at (c0, c1) of a 2-D `map` into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
// a TMA box at (c0, c1, c2) of a 3-D `map` into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
// a TMA box at (c0, c1, c2, c3) of a 4-D `map`, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16) into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// make this thread's generic-proxy shared-memory stores visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a named barrier over `count` threads (ids 1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma ----
// an unswizzled shared-memory descriptor at `p`: lbo, sbo in bytes
__device__ __forceinline__ uint64_t desc_plain(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}
// a K-major, 128-byte-swizzled descriptor at `p` (the tile base 1024-byte aligned, `p` that
// base plus a K offset inside the 128-byte row): SBO = 1024 bytes, layout type 1 (B128)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
// an MN-major, 128-byte-swizzled descriptor at `p` (16-bit elements: rows of 64 along M / N,
// one row per K step, as a TMA box writes [K rows][64 columns]): SBO = 1024 bytes between
// groups of 8 K rows, LBO = `lbo` bytes between groups of 64 columns
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* p, uint32_t lbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d[32] (+)= A (64 x 16 bf16 at `da`) . B (16 x 64 bf16 at `db`), each K-major, or MN-major
// where its transpose bit (kTransA, kTransB) is 1; scale_d = 0 drops d
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_bf16_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d[32] (+)= A (4 registers: this thread's 16 x 16 bf16 fragment of its warp's rows) .
// B (16 x 64 bf16 at `db`, MN-major: the transpose bit); scale_d = 0 drops d
__device__ __forceinline__ void wgmma_bf16_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64] (+)= A (4 registers: this thread's 16 x 16 bf16 fragment of its warp's rows) .
// B (16 x 128 bf16 at `db`, MN-major: the transpose bit; kTransB = 0: K-major); scale_d = 0
// drops d
template <int kTransB = 1>
__device__ __forceinline__ void wgmma_bf16_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
}

// d[64] (+)= A (4 registers: this thread's 16 x 16 fp16 fragment of its warp's rows) .
// B (16 x 128 fp16 at `db`, MN-major: the transpose bit); scale_d = 0 drops d
__device__ __forceinline__ void wgmma_f16_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64] (+)= A (64 x 16 bf16 at `da`) . B (16 x 128 bf16 at `db`), each K-major, or MN-major
// where its transpose bit (kTransA, kTransB) is 1; scale_d = 0 drops d
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_bf16_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// keep the compiler from moving accesses of an accumulator across an asynchronous wgmma (an
// empty asm per register; ptxas sees nothing)
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- the device (host) ----
// the SMs of the current device, looked up once (132, an H100 SXM's, if the query fails): the
// size of a persistent grid, and what the decode attentions' cluster rule fills
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
    return count;
  }();
  return n;
}

// A kernel attribute set by cudaFuncSetAttribute holds on the current device only, so a
// launcher that opts in once keeps the result for each device it has run on (a process may
// launch on several cards: a rank's thread on cuda:1). Keep one as a function-local static of a
// function with internal linkage, so that each library's copy has its own. Two threads that
// race both make the call, which is harmless.
constexpr int kMaxDevices = 64;
struct PerDevice {
  std::atomic<bool> ready[kMaxDevices] = {};
  std::atomic<int> value[kMaxDevices] = {};
  template <typename F>
  int get(F&& f) {
    int d = 0;
    if (cudaGetDevice(&d) != cudaSuccess || d < 0 || d >= kMaxDevices) return f();
    if (!ready[d].load(std::memory_order_acquire)) {
      value[d].store(f(), std::memory_order_relaxed);
      ready[d].store(true, std::memory_order_release);
    }
    return value[d].load(std::memory_order_relaxed);
  }
};

// ---- tensor maps (host) ----
// cuTensorMapEncodeTiled, looked up at run time through cudaGetDriverEntryPoint
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a map of `rank` dims (dims[0] contiguous; strides[i] the bytes between steps of dim i + 1,
// multiples of 16) in boxes of `box`; boxes past the edge are zero-filled
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                   const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                   CUtensorMapSwizzle swizzle) {
#ifndef OVLA_NO_CONTEXT_BIND
  // cuTensorMapEncodeTiled needs a current context, which the runtime binds to a thread only at
  // its first runtime call: a thread that never made one (autograd's backward thread, a serving
  // or rank thread) would be refused. Bind the primary context of the card that holds `base`
  // (a fresh thread's current device is 0, whatever card the tensor is on), which also makes
  // that card current for the launch that follows.
  static thread_local bool bound = false;
  cudaPointerAttributes attr;
  int cur = -1;
  if (cudaPointerGetAttributes(&attr, base) != cudaSuccess || attr.device < 0 ||
      cudaGetDevice(&cur) != cudaSuccess)
    return false;
  if (!bound || cur != attr.device) {
    if (cudaSetDevice(attr.device) != cudaSuccess) return false;
    bound = true;
  }
#endif
  EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], elem[5];
  for (int i = 0; i < rank; ++i) d[i] = dims[i], b[i] = box[i], elem[i] = 1;
  for (int i = 0; i + 1 < rank; ++i) s[i] = strides[i];
  return fn(map, type, cuuint32_t(rank), const_cast<void*>(base), d, s, b, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D map over [rows, cols] (cols contiguous, row stride `stride` bytes) in boxes of
// [box_rows, box_cols]
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                      uint64_t rows, uint64_t cols, uint64_t stride, uint32_t box_rows,
                      uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {cols, rows}, strides[1] = {stride};
  const uint32_t box[2] = {box_cols, box_rows};
  return encode(map, type, 2, base, dims, strides, box, swizzle);
}

// a 3-D map over grouped int4 codes, packed uint8 [G][N][gsz / 2] (group-major), in boxes of
// [rows][64 bytes] of one group (a 128-deep chunk: gsz a multiple of 128; 64-byte swizzle, as a
// nibble plane) or [rows][16 bytes] (one 32-deep k step: gsz a multiple of 32; unswizzled);
// rows past N and groups past G are zero-filled, so a box never reads the next group's rows
inline bool encode_groups(CUtensorMap* map, const void* base, int G, int N, int gsz, int rows) {
  const bool chunk = gsz % 128 == 0;
  const uint64_t dims[3] = {uint64_t(gsz / 2), uint64_t(N), uint64_t(G)};
  const uint64_t strides[2] = {uint64_t(gsz / 2), uint64_t(N) * uint64_t(gsz / 2)};
  const uint32_t box[3] = {chunk ? 64u : 16u, uint32_t(rows), 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, base, dims, strides, box,
                chunk ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// a 4-D map over attention's [B, T, H, Dh] bf16 (element strides sb, st; the [H, Dh] slab of a
// token contiguous) in boxes of [rows tokens][64 columns] of one head, 128-byte swizzle; tokens
// past T are zero-filled
inline bool encode_heads(CUtensorMap* map, const void* base, int B, int T, int H, int Dh,
                         long long sb, long long st, int rows) {
  const uint64_t dims[4] = {uint64_t(Dh), uint64_t(H), uint64_t(T), uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(Dh) * 2, uint64_t(st) * 2, uint64_t(sb) * 2};
  const uint32_t box[4] = {64, 1, uint32_t(rows), 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace ovla_hp
