// w4a8_dx: the straight-through backward of the grouped-int4 products,
// dx = g · dequant(W), with the weight dequantized on chip.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/linear.py::_w4a8_dx_kernel
// (reached through _w4a8_dx_pallas from _w4a8_ste_bwd, the backward of both
// w4a8 forwards). Semantics kept exactly:
//   dx[m, gi·gsz + j] = Σ_n bf16(g[m, n] · s[n, gi]) · code[gi, n, j]
// the scaled gradient rounded to bf16 (round to nearest even) even where g is
// fp32, the codes widened to bf16 exactly, bf16 products (exact in fp32)
// summed in fp32 over all N, the sum cast to g's type. Only the order of the
// fp32 sums differs from the TPU kernel (and from w4a8_dx_plain).
//
// Layouts: g [M, N] row-major (bf16 or fp32); q uint8 [G, N, gsz/2], the
// port's packed int4 codes (byte b of a row: code 2b in its low nibble, 2b + 1
// in its high nibble, two's complement); s_t fp32 [G, N], the scales
// transposed by the wrapper (s [N, G] is one small copy away); dx [M, G·gsz]
// in g's type. The kernel takes N and gsz multiples of 128 (the JAX chip
// rule) and 16-byte aligned g, q and s_t; the wrapper sends the rest to the
// bf16-dequant product in PyTorch, and a launch the kernel refuses raises.
//
// Bound on the H100 at the OpenVLA-7B QLoRA shapes (B = 8, T = 320, M = 2560;
// g [2560, 4096] against 32 groups of [4096, 128] codes, g [2560, 11008]
// against 32 of [11008, 128], g [2560, 4096] against 86 of [4096, 128]): 86,
// 231 and 231 GFLOP of bf16 products (0.087 / 0.233 / 0.233 ms at
// 989 TFLOP/s) against 37, 79 and 37 MB of g, codes, scales and dx
// (0.011-0.024 ms at 3.35 TB/s): bound by the tensor cores' operations.
//
// Design: wgmma fed by a TMA ring, warp-specialized. A block owns one
// [128, 128] tile of dx: 128 rows of M and 128 columns of one group (gsz a
// multiple of 128, so the scale is a per-n vector inside the tile). 288
// threads: two consumer warpgroups (64 rows each) and one producer warp.
//   * One producer thread keeps a ring of kStages = 4 stages in flight, each
//     one 64-deep chunk of N: the g tile [128 m][64 n] (a TMA box, 128-byte
//     swizzle, rows past M zero-filled by the TMA unit), the packed codes
//     [64 n][64 bytes] (a TMA box) and the stage's scale vector
//     s_t[gi, n0:n0+64] (a bulk copy), all completing on the stage's "full"
//     mbarrier by their byte count. The consumers release a stage through its
//     "empty" mbarrier. (A ring filled by one warp's cp.async copies ran at
//     1.4 TB/s and bounded the kernel: every copy was one thread's 16 bytes.)
//   * The transform on chip is way (a): A = bf16(g · s) is built in registers
//     from the staged g tile (fp32 product, then RNE: the same rounding per
//     (m, n) as the TPU kernel), as the register-A operand of
//     wgmma.m64n128k16 bf16 x bf16 -> fp32. B = the codes widened to bf16 in
//     shared memory, stored [n][j] and read as an MN-major B (no transpose):
//     8 x 8 core matrices of 8 n-rows of 16 bytes, the 8 n-cores of a column
//     block contiguous (LBO = 128 bytes along n), the 16 column blocks 1024
//     bytes apart (SBO). Each consumer thread widens 32 codes per stage with
//     the magic number (code nibble c: ((c ^ 8) | 0x4300) read as bf16 is
//     128 + (c ^ 8), minus 136 gives the two's complement value, exact for
//     all 16 codes); fence.proxy.async makes the threads' stores visible to
//     wgmma, and a named barrier joins the two warpgroups before either
//     reads the tile.
//   * Each warpgroup issues a stage's 4 wgmma (k = 16 each) and then waits
//     only for the previous stage's, so one stage multiplies while the next
//     is widened and built (two register sets for A, kBBuffers = 3 B tiles).
//   * Blocks walk the column tiles (the groups) fastest, so the blocks in
//     flight share their g rows through L2; G = 86 leaves a partial last wave.
#include <cuda.h>   // CUtensorMap (the encoder is fetched at run time: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovla_dx {

constexpr int kBM = 128;             // rows of M per block: 2 warpgroups x 64
constexpr int kBJ = 128;             // dx columns per block (one group's slice)
constexpr int kBN = 64;              // n per stage
constexpr int kStages = 4;           // ring depth
constexpr int kBBuffers = 3;         // widened B tiles
constexpr int kWgmmaInFlight = 1;    // stages of wgmma left in flight
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kBBytes = kBN * kBJ * 2;      // one widened B tile, bf16
constexpr int kNCore = 128;          // B tile: bytes between core matrices along n (K)
constexpr int kJCore = 1024;         // and along j (N): the 8 n-cores of a column block
// the descriptor's leading (LBO) and stride (SBO) byte offsets: for an
// unswizzled MN-major operand, LBO steps along K and SBO along M / N
constexpr uint32_t kLBO = kNCore, kSBO = kJCore;
constexpr int kCodeBytes = kBN * 64;        // the stage's codes: [64 n][64 bytes]

template <typename T>
struct Layout {
  static constexpr int G_BYTES = kBM * kBN * int(sizeof(T));   // 128-byte rows, swizzled
  static constexpr int STAGE = (G_BYTES + kCodeBytes + kBN * 4 + 1023) / 1024 * 1024;
  static constexpr int TX_BYTES = G_BYTES + kCodeBytes + kBN * 4;
  // + 1024: the base is rounded up to the 1024 bytes the 128-byte swizzle needs
  static constexpr size_t kSmem =
      1024 + size_t(kBBuffers) * kBBytes + size_t(kStages) * STAGE + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`; a wait
// past ~10 s of clocks (a broken ring) traps, so the launch fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
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
// a TMA box at (c0, c1) of `map` into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16) into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 8 packed codes (4 bytes; byte b: code 2b low nibble, 2b + 1 high nibble) ->
// 8 bf16 in order: ((c ^ 8) | 0x4300) is bf16 128 + (c ^ 8); minus 136 it is
// the sign-extended code, exactly
__device__ __forceinline__ uint4 widen8(uint32_t w) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x = __byte_perm(lo, hi, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
    x = ((x & 0x000F000Fu) | 0x43004300u) ^ 0x00080008u;
    __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x), bias);
    r[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}
// g[r, n], g[r, n + 1] (n even) of a staged tile: 128-byte rows under the
// TMA's 128-byte swizzle (16-byte chunk k of row r stored at chunk k ^ (r % 8));
// fp32 rows are two boxes of 32 columns
__device__ __forceinline__ float2 g_pair(const __nv_bfloat16* gs, int r, int n) {
  const int off = r * 64 + ((((n >> 3) ^ r) & 7) << 3) + (n & 7);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gs + off));
}
__device__ __forceinline__ float2 g_pair(const float* gs, int r, int n) {
  const int off = (n >> 5) * (kBM * 32) + r * 32 + (((((n & 31) >> 2) ^ r) & 7) << 2) + (n & 3);
  return *reinterpret_cast<const float2*>(gs + off);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the MN-major, unswizzled shared-memory descriptor of a B tile at `p`
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(kLBO >> 4) << 16) |
         (uint64_t(kSBO >> 4) << 32);
}

// d[64] = A (4 registers: this thread's 16 x 16 fragment of its warp's rows)
// x B (16 n x 128 j at `desc`, MN-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
// keep the compiler from moving accumulator accesses across the asynchronous
// wgmma (an empty asm per register; ptxas sees nothing)
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    w4a8_dx_kernel(const __grid_constant__ CUtensorMap tm_g,
                   const __grid_constant__ CUtensorMap tm_q, const float* __restrict__ s_t,
                   T* __restrict__ dx, int M, int N, int G, int gsz) {
  using L = Layout<T>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bbuf = smem;                                     // [kBBuffers][kBBytes]
  uint8_t* ring = smem + kBBuffers * kBBytes;               // [kStages][STAGE]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::STAGE);
  uint64_t* empty = full + kStages;

  const int col0 = blockIdx.x * kBJ, m0 = blockIdx.y * kBM;
  const int gi = col0 / gsz, j0 = col0 - gi * gsz;
  const int n_chunks = N / kBN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);    // the producer's arrival, then the stage's bytes
      mbar_init(empty + i, 1);   // one consumer thread, after both warpgroups read it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread keeps the ring of g, code and scale tiles full ----
    if (tid == kConsumers) {
      for (int c = 0; c < n_chunks; ++c) {
        const int slot = c % kStages, n0 = c * kBN;
        mbar_wait(empty + slot, ((c / kStages) & 1) ^ 1);   // the first round passes
        uint8_t* st = ring + slot * L::STAGE;
        mbar_expect_tx(full + slot, L::TX_BYTES);
#pragma unroll
        for (int b = 0; b < int(sizeof(T)) / 2; ++b)   // fp32 rows: two 32-column boxes
          tma_load_2d(st + b * (kBM * 128), &tm_g, n0 + b * 32, m0, full + slot);
        tma_load_2d(st + L::G_BYTES, &tm_q, j0 / 2, gi * N + n0, full + slot);
        bulk_load(st + L::G_BYTES + kCodeBytes, s_t + (size_t)gi * N + n0, kBN * 4, full + slot);
      }
    }
  } else {
    // ---- two consumer warpgroups: 64 rows each ----
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int gq = lane >> 2, t4 = lane & 3;
    const int row0 = wg * 64 + warp * 16 + gq;   // this thread's rows: row0, row0 + 8
    const int wn = tid % kBN, wq = tid / kBN;    // widening: code row n, 32-code quarter
    float acc[64];   // written first by a wgmma that does not accumulate

    // stage c: widen its codes into B buffer c % 3, build its A fragments in
    // `a`, issue its wgmma, then wait for the stage before's: a buffer is
    // rewritten only after both warpgroups have passed the barrier of the
    // stage after its own, a register set after its wgmma is done
    auto stage = [&](int c, uint32_t (&a)[4][4]) {
      const int slot = c % kStages;
      mbar_wait(full + slot, (c / kStages) & 1);
      const uint8_t* st = ring + slot * L::STAGE;
      const T* gs = reinterpret_cast<const T*>(st);
      const uint8_t* cs = st + L::G_BYTES;
      const float* ss = reinterpret_cast<const float*>(cs + kCodeBytes);
      uint8_t* bt = bbuf + (c % kBBuffers) * kBBytes;

      // B: codes 32 wq .. 32 wq + 31 of row wn, widened into 4 core-matrix rows
      const uint4 w = *reinterpret_cast<const uint4*>(cs + wn * 64 + wq * 16);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cj = 4 * wq + e;   // column block of 8 j
        *reinterpret_cast<uint4*>(bt + cj * kJCore + (wn / 8) * kNCore + (wn % 8) * 16) =
            widen8(words[e]);
      }
      // A: bf16(g · s) for this thread's fragment of each 16-deep step
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + 8 * (i & 1), n = kk * 16 + 2 * t4 + 8 * (i >> 1);
          const float2 gv = g_pair(gs, r, n);
          const float2 sv = *reinterpret_cast<const float2*>(ss + n);
          a[kk][i] = pack_bf16(gv.x * sv.x, gv.y * sv.y);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      if (tid == 0) mbar_arrive(empty + slot);   // both warpgroups are done with the stage

      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16(acc, a[kk], b_desc(bt + kk * 2 * kNCore), c > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kWgmmaInFlight) : "memory");
      fence_operands(acc);
    };
    uint32_t a0[4][4], a1[4][4];
    for (int c = 0; c < n_chunks; c += 2) {   // n_chunks is even (N a multiple of 128)
      stage(c, a0);
      stage(c + 1, a1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);

    // accumulator block i (columns 8i .. 8i + 7): rows row0 / row0 + 8
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + row0 + 8 * hr;
      if (m >= M) continue;
      T* out = dx + (size_t)m * (size_t(G) * gsz) + col0 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 16; ++i) store2(out + 8 * i, acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
    }
  }
}

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

// a 2D map over [rows, cols] (cols contiguous, row stride `stride` bytes) in boxes of
// [box_rows, box_cols]; boxes past the edge are zero-filled
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                      uint64_t rows, uint64_t cols, uint64_t stride, uint32_t box_rows,
                      uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {stride};
  const cuuint32_t box[2] = {box_cols, box_rows}, elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* g, const void* q, const float* s_t, void* dx, int M, int N, int G,
           int gsz, cudaStream_t stream) {
  CUtensorMap tm_g, tm_q;
  const bool bf16 = sizeof(T) == 2;
  if (!encode_2d(&tm_g, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                 g, M, N, uint64_t(N) * sizeof(T), kBM, 128 / sizeof(T),
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, uint64_t(G) * N, gsz / 2, gsz / 2,
                 kBN, 64, CU_TENSOR_MAP_SWIZZLE_NONE))
    return int(cudaErrorInvalidValue);
  auto kernel = w4a8_dx_kernel<T>;
  const size_t smem = Layout<T>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(G * gsz / kBJ, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(tm_g, tm_q, s_t, static_cast<T*>(dx), M, N, G, gsz);
  return int(cudaGetLastError());
}

}  // namespace ovla_dx

// s_t: the scales transposed, fp32 [G, N]. Returns the launch's cudaError_t
// (0 on success); cudaErrorInvalidValue for shapes the kernel does not take
// (N or gsz not a multiple of 128, g, q or s_t not 16-byte aligned, M past the
// grid's 65535 row blocks) or when cuTensorMapEncodeTiled cannot be found.
extern "C" int ovla_w4a8_dx(const void* g, const void* q, const float* s_t, void* dx, int M,
                            int N, int G, int gsz, int is_bf16, void* stream) {
  auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (M < 1 || (M + ovla_dx::kBM - 1) / ovla_dx::kBM > 65535 || N < 128 || N % 128 ||
      gsz < 128 || gsz % 128 || G < 1 || misaligned(g) || misaligned(q) || misaligned(s_t))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ovla_dx::launch<__nv_bfloat16>(g, q, s_t, dx, M, N, G, gsz, st)
                 : ovla_dx::launch<float>(g, q, s_t, dx, M, N, G, gsz, st);
}
