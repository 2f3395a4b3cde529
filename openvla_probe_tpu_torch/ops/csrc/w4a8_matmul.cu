// w4a8_matmul: out[M, N] = cast((Σ_g f32(x8[:, g] · q4[g]ᵀ) · s[:, g]) · s_x), grouped int4
// weights times per-row int8 activations.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/linear.py::_w4a8_pallas_kernel (reached
// through _w4a8_pallas_matmul from matmul_t for every grouped-int4 leaf under the kernel
// gate whose N and group size are multiples of 128). Semantics kept bit for bit:
//   * per-row codes clip(rint(x / s_x), -127, 127) with s_x = max(max|x| / 127, 1e-8) and
//     IEEE divisions (round half to even, as jnp.round);
//   * per group g, in group order 0..G-1, the exact int32 product of the group's codes,
//     folded as acc = acc + f32(p) · s[n, g] with two roundings (written with the _rn
//     intrinsics: nvcc would contract them into an FMA, which rounds once);
//   * out = cast(acc · s_x).
// The packed weights are the port's layout (ops/linear.py): uint8 [G, N, gsz / 2], byte j
// holding code 2j in its low nibble and code 2j + 1 in its high nibble.
//
// Bound on the H100 at the OpenVLA-7B shapes:
//   * decode, M = 24: the int4 weight stream, half a byte per weight plus a 4-byte scale per
//     128: 8.9 MB per 4096 x 4096 launch, 2.7 us at 3.35 TB/s;
//   * prefill, towers and train steps, M = 2560-6912: int8 tensor-core operations, 0.117 ms
//     for 6912 x 4096 x 4096 at 1979 TOP/s. The group fold costs 4 instructions per output
//     element and group (16 K elements per 128 x 128 x 128 step of a block: ~512 issue
//     cycles of an SM, against ~500 cycles of int8 wgmma for the same step).
// What bounds it there in fact (knock-out builds timed by tools/kernel_ab.py, PERF.md §6): at
// 6912 x 4096 x 4096 the pre-pass takes 0.04 ms of 0.51, the stage handoffs and each block's
// set-up and stores with no load and no work 0.19 (the scales' load 0.03 of it, the stores
// 0.02), and the products, the fold and the weights' fragments add 0.17, 0.08 and 0.06.
//
// One wrapper call makes two launches: the pre-pass (quant_rows, int8_mma.cuh), one block per
// row, writes the int8 codes x8 [M, K] and s_x [M] once; then one of two GEMM routes.
//
// M > 64 (towers, prefill, train steps): int8 wgmma fed by TMA, warp-specialized (the shape of
// w4a8_dx.cu), with the roles of the operands swapped: the block computes outᵀ, a tile of
// 128 weight rows (n) x 128 rows of x (m), so the int4 weights are wgmma's register operand
// A and are widened in registers, and the activation codes are its shared-memory operand B.
// 288 threads:
//   * one producer thread keeps a 6-stage ring full, each stage one 128-deep k chunk: the
//     activation codes [128 rows][128 bytes] (a TMA box, 128-byte swizzle, rows past M
//     zero-filled) and the packed codes of the block's 128 weight rows [128 n][64 bytes] (a
//     TMA box over q read as [G·N, gsz / 2], 64-byte swizzle), completing on the stage's
//     "full" mbarrier;
//   * two consumer warpgroups of 64 weight rows x 128 rows of x. Per stage each warp loads its
//     16 rows' packed codes with two ldmatrix (8 consecutive codes of one row a thread),
//     widens them into the register fragments of wgmma.m64n128k32.s32.s8.s8 (4 per chunk;
//     scale-d = 0 at a group's first step restarts the int32 accumulator), waits, releases
//     the stage through its "empty" mbarrier and, after a group's last chunk, folds the int32
//     sums into the fp32 accumulator in group order (a thread's two weight rows: two scales);
//   * k order: a fragment takes a thread's 8 consecutive codes at k 4 t4 .. 4 t4 + 3 and
//     16 + 4 t4 .. 16 + 4 t4 + 3, so the pre-pass stores each 32-code block of activation
//     codes in the matching order (int8_mma.cuh stored_offset), as for the decode route;
//   * f32(p) by the magic number: __int_as_float(p + 0x4B400000) - 12582912 is exact for
//     |p| < 2^22, and |p| <= 127 · 8 · gsz <= 4,161,536 for gsz <= 4096 (the launcher's cap);
//   * the block's scales are staged once, transposed to [G][128] in shared memory, with
//     16 loads in flight per thread.
//   Why the weights are the register operand: as wgmma's shared-memory B they must first be
//   widened into an int8 tile there, and that design (by the consumers under a named barrier
//   each chunk, or by warps of their own) took 0.60-0.62 ms at 6912 x 4096 x 4096 on an H100
//   against this one's 0.51 (tools/kernel_ab.py; PERF.md §6).
// M <= 64 (decode): mma.sync m16n8k32 s8 x s8 -> s32 fed by a TMA ring, the groups split
// across warps. A block owns 32 rows (M <= 64: one or two row blocks) and 64 columns over all
// of K, so each activation chunk is staged once per 64 columns (N = 4096: 64 blocks); one
// producer thread keeps 12 stages in flight (48 KB of the weight stream), each the activation
// codes [32 rows][128 bytes] (128-byte swizzle) and the packed codes [64 n][64 bytes]
// (64-byte swizzle: conflict-free ldmatrix rows). The consumer warps take one group each per
// wave (all 64 columns: 16 independent accumulator tiles, where one warp walking every group
// would wait on one short chain of products after another), release each stage through its
// "empty" mbarrier, and write their group's terms t = f32(p) · s[n, g] to shared memory; then
// every thread folds the wave's terms into its outputs in group order (acc + t), so the fold
// is the TPU kernel's, bit for bit, with no atomics and no sums out of order. A wave spans at
// most as many chunks as the ring has stages (eight groups of 128, six of 256, three of 512,
// one warp at 1024 and up, which walks its own chunks in order): a warp that waited on a
// stage a whole phase ahead would find its parity already complete and read the stage before
// its chunk landed. The packed codes go straight from shared memory into B fragments
// (ldmatrix hands each thread 8 consecutive codes of one channel) and are widened in
// registers; a fragment takes k in another order than those 8 codes, so for this route the
// pre-pass stores each 32-code block of activation codes in the matching order (int8_mma.cuh
// stored_offset; an integer dot product does not depend on the order of its terms).
#include "hopper.cuh"
#include "int8_mma.cuh"

namespace ovla_w4 {

namespace hp = ovla_hp;
using ovla_i8::ldmatrix_x4;
using ovla_i8::mma_s8_16832;
using ovla_i8::quant_rows;
using ovla_i8::store2;

constexpr int kChunk = 128;   // k per stage

// f32(p) by the magic number, exact for |p| < 2^22
__device__ __forceinline__ float to_f32(int p) {
  return __fsub_rn(__int_as_float(p + 0x4B400000), 12582912.f);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the fold of one group: acc = acc + f32(p) · s, two roundings
__device__ __forceinline__ float fold(float acc, int p, float s) {
  return __fadd_rn(acc, __fmul_rn(to_f32(p), s));
}

// ---------------------------------------------------------------------------
// M > 64: wgmma with the weights as the register operand

constexpr int kWBN = 128, kWBM = 128;     // block tile: 128 weight rows (n) x 128 rows of x (m)
constexpr int kWStages = 6;
constexpr int kWConsumers = 256;          // two warpgroups, 64 weight rows each
constexpr int kWThreads = kWConsumers + 32;
constexpr int kWABytes = kWBM * kChunk;       // activation codes of a stage, 16 KB
constexpr int kWQBytes = kWBN * kChunk / 2;   // packed codes of a stage, 8 KB
constexpr int kWStage = kWABytes + kWQBytes;  // 24 KB, a multiple of 1024

inline size_t wgmma_smem(int G) {
  // + 1024: the base is rounded up to the 1024 bytes the 128-byte swizzle needs
  return 1024 + size_t(kWStages) * kWStage + size_t(kWBN) * G * 4 + 2 * kWStages * 8;
}

// Stage the block's scales, rows n0 .. n0 + BN - 1 of s [N, G] (one contiguous slab),
// transposed into ss [G][BN] by `nthreads` threads (thread index t), 16 independent loads
// in flight per thread
template <int BN>
__device__ __forceinline__ void stage_scales(float* ss, const float* __restrict__ s, int n0,
                                             int G, int t, int nthreads) {
  const int total = BN * G;
  for (int base = 0; base < total; base += 16 * nthreads) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = base + u * nthreads + t;
      v[u] = i < total ? s[(long long)n0 * G + i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = base + u * nthreads + t;
      if (i < total) {
        const int n = i / G;
        ss[(i - n * G) * BN + n] = v[u];
      }
    }
  }
}

// d[64] (+)= A (4 registers: this thread's 16 x 32 int8 fragment of its warp's rows) ·
// B (32 x 128 at `db`, K-major), int8 -> int32; scale_d = 0 drops d
__device__ __forceinline__ void wgmma_s8_rs_m64n128k32(int (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <typename T>
__global__ void __launch_bounds__(kWThreads, 1)
    w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_q, const float* __restrict__ sx,
                      const float* __restrict__ s, T* __restrict__ out, int M, int N, int K,
                      int gsz) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  float* ss = reinterpret_cast<float*>(ring + kWStages * kWStage);   // [G][128] scales
  const int G = K / gsz, KC = K / kChunk, CPG = gsz / kChunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + kWBN * G);
  uint64_t* empty = full + kWStages;
  const int n0 = blockIdx.x * kWBN, m0 = blockIdx.y * kWBM;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kWStages; ++i) {
      hp::mbar_init(full + i, 1);    // the producer's arrival, then the stage's bytes
      hp::mbar_init(empty + i, 2);   // one thread of each consumer warpgroup
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kWConsumers) {
    // ---- producer: one thread keeps the ring of activation and packed-code tiles full ----
    if (tid == kWConsumers) {
      for (int c = 0; c < KC; ++c) {
        const int slot = c % kWStages;
        hp::mbar_wait(empty + slot, ((c / kWStages) & 1) ^ 1);   // the first round passes
        uint8_t* st = ring + slot * kWStage;
        hp::mbar_expect_tx(full + slot, kWStage);
        hp::tma_load_2d(st, &tm_a, c * kChunk, m0, full + slot);
        hp::tma_load_2d(st + kWABytes, &tm_q, (c % CPG) * (kChunk / 2), (c / CPG) * N + n0,
                        full + slot);
      }
    }
    return;
  }

  // ---- two consumer warpgroups: weight rows 64 wg .. 64 wg + 63 of the tile x 128 rows of x
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int nw = wg * 64 + warp * 16;   // this warp's 16 weight rows
  stage_scales<kWBN>(ss, s, n0, G, tid, kWConsumers);
  hp::named_barrier(1, kWConsumers);

  int p[64];     // the group's int32 sums, written first by a wgmma with scale-d = 0
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int c = 0; c < KC; ++c) {
    const int slot = c % kWStages;
    hp::mbar_wait(full + slot, (c / kWStages) & 1);
    const uint8_t* at = ring + slot * kWStage;   // B: the chunk's activation codes
    const uint8_t* qs = at + kWABytes;            // the packed codes, 64-byte rows, swizzled
    // A: ldmatrix hands lane (g8, t4) the packed bytes 4 t4 .. 4 t4 + 3 of row g8 of the
    // 8-row group in k32 step kk (matrix kk; 16-byte chunk kk of row n stored at
    // kk ^ ((n >> 1) & 3)), i.e. its codes 8 t4 .. 8 t4 + 7, which the register fragment
    // takes at k 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3 (the pre-pass's order)
    uint32_t w[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = nw + 8 * h + (lane & 7);
      ldmatrix_x4(w[h], qs + n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4));
    }
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ovla_i8::widen(w[0][kk], a[kk][0], a[kk][2]);   // rows g8: k 4 t4.., 16 + 4 t4..
      ovla_i8::widen(w[1][kk], a[kk][1], a[kk][3]);   // rows g8 + 8
    }
    const int first = (c % CPG) == 0;
    hp::fence_operands(p);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s8_rs_m64n128k32(p, a[kk], hp::desc_sw128(at + kk * 32), !(first && kk == 0));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_operands(p);
    if (wt == 0) hp::mbar_arrive(empty + slot);
    if ((c + 1) % CPG == 0) {   // group c / CPG complete: fold it, in group order
      const float* sg = ss + (c / CPG) * kWBN + nw + g8;
      const float s0 = sg[0], s1 = sg[8];   // this thread's weight rows g8, g8 + 8
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = fold(acc[i], p[i], (i & 2) ? s1 : s0);
    }
  }

  // accumulator block i (rows of x 8i .. 8i + 7): weight rows g8 (e < 2), g8 + 8; rows of x
  // 2 t4, 2 t4 + 1 (e & 1)
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 8 * i + 2 * t4 + (e & 1);
      if (m < M)
        store1(out + (long long)m * N + n0 + nw + g8 + 8 * (e >> 1), __fmul_rn(acc[4 * i + e], sx[m]));
    }
}

template <typename T>
int launch_wgmma(const int8_t* xq, const float* sx, const uint8_t* q, const float* s, T* out,
                 int M, int N, int K, int gsz, cudaStream_t stream) {
  CUtensorMap tm_a, tm_q;
  const int G = K / gsz;
  if (!hp::encode_2d(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, kWBM, kChunk,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, uint64_t(G) * N, gsz / 2, gsz / 2,
                     kWBN, kChunk / 2, CU_TENSOR_MAP_SWIZZLE_64B))
    return int(cudaErrorInvalidValue);
  auto kernel = w4a8_wgmma_kernel<T>;
  const size_t smem = wgmma_smem(G);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N / kWBN, (M + kWBM - 1) / kWBM);
  kernel<<<grid, kWThreads, smem, stream>>>(tm_a, tm_q, sx, s, out, M, N, K, gsz);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// M <= 64: mma.sync over a TMA ring, the groups split across warps

constexpr int kDBM = 32;                      // rows per block (M <= 64: one or two blocks)
constexpr int kDBN = 64;                      // columns per block
constexpr int kDStages = 12;
constexpr int kDWarps = 8;                    // consumer warps, at most one group each per wave
constexpr int kDConsumers = 32 * kDWarps;
constexpr int kDThreads = kDConsumers + 32;
constexpr int kDABytes = kDBM * kChunk;       // activation codes of a stage, 4 KB
constexpr int kDQBytes = kDBN * kChunk / 2;   // packed codes of a stage, 4 KB
constexpr int kDStage = kDABytes + kDQBytes;
constexpr int kDTPitch = kDBN + 8;            // a term row's pitch (floats): 2-way float2 stores
constexpr int kDTerms = kDBM * kDTPitch;      // one warp's terms [32 rows][64 columns]
constexpr int kDFold = kDBM * kDBN / kDConsumers;   // output elements per thread

inline size_t decode_smem(int G) {
  return 1024 + size_t(kDStages) * kDStage + size_t(kDWarps) * kDTerms * 4 +
         size_t(kDBN) * G * 4 + 2 * kDStages * 8;
}

template <typename T>
__global__ void __launch_bounds__(kDThreads, 1)
    w4a8_decode_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_q, const float* __restrict__ sx,
                       const float* __restrict__ s, T* __restrict__ out, int M, int N, int K,
                       int gsz) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  float* terms = reinterpret_cast<float*>(ring + kDStages * kDStage);   // [warp][32][pitch]
  float* ss = terms + kDWarps * kDTerms;                                // [G][64] scales
  const int G = K / gsz, KC = K / kChunk, CPG = gsz / kChunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(ss + kDBN * G);
  uint64_t* empty = full + kDStages;
  const int n0 = blockIdx.x * kDBN, m0 = blockIdx.y * kDBM;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kDStages; ++i) {
      hp::mbar_init(full + i, 1);
      hp::mbar_init(empty + i, 1);   // lane 0 of the warp that consumed the stage
    }
    hp::mbar_init_fence();
  }
  stage_scales<kDBN>(ss, s, n0, G, tid, kDThreads);
  __syncthreads();

  if (tid >= kDConsumers) {
    if (tid == kDConsumers) {
      for (int c = 0; c < KC; ++c) {
        const int slot = c % kDStages;
        hp::mbar_wait(empty + slot, ((c / kDStages) & 1) ^ 1);
        uint8_t* st = ring + slot * kDStage;
        hp::mbar_expect_tx(full + slot, kDStage);
        hp::tma_load_2d(st, &tm_a, c * kChunk, m0, full + slot);
        hp::tma_load_2d(st + kDABytes, &tm_q, (c % CPG) * (kChunk / 2), (c / CPG) * N + n0,
                        full + slot);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  float* tw = terms + warp * kDTerms;
  float acc[kDFold];   // output element tid + 256 k: row (tid + 256 k) / 64, column % 64
#pragma unroll
  for (int k = 0; k < kDFold; ++k) acc[k] = 0.f;

  // waves of W groups: warp w < W takes group W v + w and writes its terms
  // t = f32(p) · s[n, g] (one rounding); then every thread folds the wave's terms into its
  // elements in group order (acc + t, the second rounding). The W · CPG chunks of a wave fit
  // in the ring (or W = 1), so no warp waits on a stage before the chunk one phase earlier
  // in it has landed: those were all consumed before the wave's barrier.
  const int W = min(kDWarps, max(1, kDStages / CPG));
  for (int g0 = 0; g0 < G; g0 += W) {
    const int g = g0 + warp;
    if (warp < W && g < G) {
      int p[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[mt][j][e] = 0;
      for (int c = g * CPG; c < (g + 1) * CPG; ++c) {
        const int slot = c % kDStages;
        hp::mbar_wait(full + slot, (c / kDStages) & 1);
        const uint8_t* ast = ring + slot * kDStage;
        const uint8_t* bst = ast + kDABytes;
        // packed B words: matrix kk of n8 tile j hands lane (g8, t4) the packed bytes
        // 4 t4 .. 4 t4 + 3 of channel g8 in k32 step kk (64-byte rows, 16-byte chunk kk of
        // row n stored at chunk kk ^ ((n >> 1) & 3))
        uint32_t bw[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = j * 8 + (lane & 7);
          ldmatrix_x4(bw[j], bst + n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // A: 128-byte rows, 16-byte chunk k of row r stored at chunk k ^ (r % 8)
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int r = mt * 16 + (lane & 15);
            ldmatrix_x4(a[mt], ast + r * 128 + (((kk * 2 + (lane >> 4)) ^ (r & 7)) << 4));
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t b0, b1;
            ovla_i8::widen(bw[j][kk], b0, b1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_s8_16832(p[mt][j], a[mt], b0, b1);
          }
        }
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(empty + slot);
      }
      const float* sg = ss + g * kDBN + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 sv = *reinterpret_cast<const float2*>(sg + 8 * j);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(tw + (mt * 16 + g8 + 8 * h) * kDTPitch + 8 * j + 2 * t4) =
                make_float2(__fmul_rn(to_f32(p[mt][j][2 * h]), sv.x),
                            __fmul_rn(to_f32(p[mt][j][2 * h + 1]), sv.y));
      }
    }
    hp::named_barrier(1, kDConsumers);   // the wave's terms written
    const int gn = min(W, G - g0);
    for (int w = 0; w < gn; ++w) {
#pragma unroll
      for (int k = 0; k < kDFold; ++k) {
        const int e = tid + kDConsumers * k;
        acc[k] = __fadd_rn(acc[k], terms[w * kDTerms + (e / kDBN) * kDTPitch + e % kDBN]);
      }
    }
    hp::named_barrier(1, kDConsumers);   // the terms read before the next wave writes them
  }

#pragma unroll
  for (int k = 0; k < kDFold; ++k) {
    const int e = tid + kDConsumers * k, m = m0 + e / kDBN;
    if (m < M) store1(out + (long long)m * N + n0 + e % kDBN, __fmul_rn(acc[k], sx[m]));
  }
}

template <typename T>
int launch_decode(const int8_t* xq, const float* sx, const uint8_t* q, const float* s, T* out,
                  int M, int N, int K, int gsz, cudaStream_t stream) {
  CUtensorMap tm_a, tm_q;
  const int G = K / gsz;
  if (!hp::encode_2d(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, kDBM, kChunk,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, uint64_t(G) * N, gsz / 2, gsz / 2,
                     kDBN, kChunk / 2, CU_TENSOR_MAP_SWIZZLE_64B))
    return int(cudaErrorInvalidValue);
  auto kernel = w4a8_decode_kernel<T>;
  const size_t smem = decode_smem(G);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N / kDBN, (M + kDBM - 1) / kDBM);
  kernel<<<grid, kDThreads, smem, stream>>>(tm_a, tm_q, sx, s, out, M, N, K, gsz);
  return int(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* q, const void* s, void* out, void* xq, void* sx, int M, int N,
        int K, int gsz, cudaStream_t stream) {
  int8_t* codes = static_cast<int8_t*>(xq);
  float* scales = static_cast<float*>(sx);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  T* o = static_cast<T*>(out);
  // both routes take the codes in the k order of their packed-code fragments
  const cudaError_t err = quant_rows<T, true, false>(x, codes, scales, nullptr, M, K, stream);
  if (err != cudaSuccess) return int(err);
  if (M <= 64) return launch_decode<T>(codes, scales, qp, sp, o, M, N, K, gsz, stream);
  return launch_wgmma<T>(codes, scales, qp, sp, o, M, N, K, gsz, stream);
}

}  // namespace ovla_w4

// Returns the launches' cudaError_t (0 on success). x [M, K] (bf16 or fp32), q packed uint8
// [K / gsz, N, gsz / 2], s fp32 [N, K / gsz], out [M, N] in x's type, and the scratch xq int8
// [M, K] and sx fp32 [M] for the pre-pass: all contiguous and 16-byte aligned; N and gsz
// multiples of 128, gsz <= 4096 (the exact int32 -> fp32 conversion), K a multiple of gsz,
// at most 128 groups (the staged scales), M past the grid's 65535 row blocks refused.
extern "C" int ovla_w4a8_matmul(const void* x, const void* q, const void* s, void* out, void* xq,
                                void* sx, int M, int N, int K, int gsz, int is_bf16,
                                void* stream) {
  auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (M < 1 || (M + ovla_w4::kWBM - 1) / ovla_w4::kWBM > 65535 || N < 128 || N % 128 != 0 ||
      gsz < 128 || gsz % 128 != 0 || gsz > 4096 || K < gsz || K % gsz != 0 || K / gsz > 128 ||
      misaligned(x) || misaligned(q) || misaligned(xq))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return ovla_w4::run<__nv_bfloat16>(x, q, s, out, xq, sx, M, N, K, gsz, st);
  return ovla_w4::run<float>(x, q, s, out, xq, sx, M, N, K, gsz, st);
}
