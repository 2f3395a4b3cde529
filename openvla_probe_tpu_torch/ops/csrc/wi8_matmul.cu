// wi8_matmul: out[M, N] = cast((x[M, K] · bf16(q[N, K])ᵀ in fp32) · s[N]), the
// weight-only int8 matmul of the int8 serving tiers.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/linear.py::_wi8_kernel (reached
// through _wi8_matmul_2d from matmul_t for every per-channel int8 leaf under
// the kernel gate). Function kept: the int8 codes widen to bf16 exactly, so
// every product is the TPU's; the sum is fp32 (only its order differs); the
// per-channel scale multiplies the fp32 sum; one cast to x's type at the end.
// x is never quantized and no product runs in TF32.
//
// Bound on the H100 at the OpenVLA-7B shapes:
//   * prefill, M = 6912 (B = 24 x T = 288), (K, N) in {(4096, 4096),
//     (4096, 11008), (11008, 4096)}: 0.23-0.62 TFLOP per launch against
//     57-163 MB, so it is bound by bf16 tensor-core operations (0.23-0.63 ms
//     at 989 TFLOP/s); SigLIP's fc2 on the int4 tier, 6144 x 4304 x 1152, too;
//   * decode and lm_head, M = 24: the int8 weight stream (16.8-131 MB per
//     launch, 6.6 GB per decode step) bounds it at 5-39 us per launch, about
//     2 ms per step at 3.35 TB/s.
// What bounds it in fact (knock-out builds: scratch copies with one piece of work removed,
// timed by tools/kernel_ab.py, PERF.md §6): at 6912 x 4096 x 4096 (0.41 ms with a producer
// warp) the x loads past the ring's first fill cost nothing and the stores 0.01 ms, the
// fragments' loads and widening 0.05; at 24 x 4096 x 4096 (15 us) a launch with no load and
// no product takes 5.9 us (set-up and the fold), streaming with no product 12.4.
//
// The int8 -> bf16 widening (`widen2`), exact for every code c in -128..127: a byte
// permutation builds the bf16 words 0x43 | (c & 0x7F) = 128 + (c & 0x7F) and
// 0x43 | (c & 0x80) = 128 or 256 (c < 0), and one bf16x2 subtraction of the two gives c,
// which is representable, so the subtraction does not round (bf16 has 7 fraction bits: a
// single bias of 128 would need 8). tests/test_torch_kernel_arith_oneshot.py checks all 256
// codes.
//
// M > 64 (prefill, the SigLIP fc2): bf16 wgmma m64n256k16 fed by TMA, warp-specialized (the
// shape of w4a8_matmul.cu). The block computes outᵀ, a tile of 128 weight rows (n) x 256 rows
// of x (m), so the int8 weights are wgmma's register operand A, widened in registers, and x
// is its shared-memory operand B; each code is widened once per 256 rows of x. 384 threads:
//   * a producer warpgroup, which gives its registers to the consumers (setmaxnreg; 7-8 %
//     faster than one producer warp of a 288-thread block, tools/kernel_ab.py), in which one
//     thread keeps a 5-stage ring full, each stage one 64-deep k chunk: x
//     [256 rows][128 bytes] (a TMA box, 128-byte swizzle, rows past M and k past K
//     zero-filled: SigLIP's K = 4304 ends in a partial box) and the codes of the block's 128
//     weight rows [128 n][64 bytes] (a TMA box, 64-byte swizzle), on full / empty mbarriers;
//   * two consumer warpgroups of 64 weight rows x 256 rows of x (128 fp32 accumulators a
//     thread). Per stage each thread loads its fragment's code pairs (k 2 t4, 2 t4 + 1 and
//     2 t4 + 8, 2 t4 + 9 of its rows g, g + 8 in each k16 step: x's k order, which the
//     register fragment must match) with 16-bit loads, conflict-free under the swizzle,
//     widens them after the stage's wait, then issues the four wgmma and waits for them
//     before the next stage's fragments are built: no register of an in-flight wgmma is
//     written by another instruction, and the other warpgroup's products run meanwhile.
// M <= 64 (decode steps, lm_head): mma.sync m16n8k16 bf16 fed by TMA, split-K across warps.
// A block owns 32 weight columns (N = 4096: 128 blocks, one wave on the 132 SMs) and 32 rows
// of x (M <= 64: one or two row blocks) over all of K. 8 consumer warps take the 128-deep k
// chunks in turn (chunk c to warp c % 8), each from two stages of its own (16 stages, 64 KB
// of weights in flight a block: a warp never waits on a stage another warp frees, so no wait
// runs a whole mbarrier phase ahead); one producer thread fills them in chunk order. In a
// k16 step a thread takes 4 consecutive k, 4 t4 .. 4 t4 + 3, at the fragment's slots
// 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 for both operands (an 8-byte load of x, a 4-byte load
// of codes: the same k in the same slots, and a dot product does not depend on the order of
// its terms). At the end each warp's fp32 partial sums go to shared memory and every output
// is their sum in warp order 0..7, then times s: a fixed order, no atomics.
// fp32 activations (the tiny test configurations) take a scalar fp32-FMA kernel
// (ovla_wi8_matmul_scalar; the wrapper counts it as wi8_matmul_scalar): a bf16 product would
// round x.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace ovla_wi8 {

namespace hp = ovla_hp;

// two int8 codes (byte sel & 0xF and (sel >> 8) & 0xF of w: 0x5140 the low pair, 0x7362 the
// high pair) -> bf16x2, the first code in the low half; exact
template <uint32_t SEL>
__device__ __forceinline__ uint32_t widen2(uint32_t w) {
  const uint32_t a = __byte_perm(w, 0x43434343u, SEL);   // [c0, 0x43, c1, 0x43]
  const uint32_t lo = a & 0xFF7FFF7Fu;                     // 128 + (c & 0x7F)
  const uint32_t hi = a & 0xFF80FF80u;                     // 128, or 256 where c < 0
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                             *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t lds_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// ---------------------------------------------------------------------------
// M > 64: wgmma with the weights as the register operand

constexpr int kPBN = 128;                     // weight rows per block: two warpgroups of 64
constexpr int kPBM = 256;                     // rows of x per block: wgmma's n
constexpr int kPBK = 64;                      // k per stage: one 128-byte row of x
constexpr int kPStages = 5;
constexpr int kPConsumers = 256;
constexpr int kPThreads = kPConsumers + 128;  // a producer warpgroup: setmaxnreg hands its registers over
constexpr int kPAcc = kPBM / 2;               // fp32 accumulators a thread
constexpr int kPXBytes = kPBM * kPBK * 2;     // x of a stage
constexpr int kPQBytes = kPBN * kPBK;         // codes of a stage, 8 KB
constexpr int kPStage = kPXBytes + kPQBytes;  // a multiple of 1024
constexpr size_t kPSmem = 1024 + size_t(kPStages) * kPStage + 2 * kPStages * 8;

#define OVLA_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                     "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[128] += A (4 registers: this thread's 16 x 16 bf16 fragment of its warp's rows) ·
// B (16 x 256 bf16 at `db`, K-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : OVLA_ACC8(0), OVLA_ACC8(8), OVLA_ACC8(16), OVLA_ACC8(24), OVLA_ACC8(32), OVLA_ACC8(40),
        OVLA_ACC8(48), OVLA_ACC8(56), OVLA_ACC8(64), OVLA_ACC8(72), OVLA_ACC8(80), OVLA_ACC8(88),
        OVLA_ACC8(96), OVLA_ACC8(104), OVLA_ACC8(112), OVLA_ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef OVLA_ACC8

// The codes of rows r (bytes k, k + 1) in a [rows][64 bytes] tile with the 64-byte swizzle
// (16-byte chunk c of row r stored at chunk c ^ ((r >> 1) & 3))
__device__ __forceinline__ const uint8_t* code_at(const uint8_t* qs, int r, int k) {
  return qs + r * 64 + ((((k >> 4) ^ (r >> 1)) & 3) << 4) + (k & 15);
}

__global__ void __launch_bounds__(kPThreads, 1)
    wi8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_q, const float* __restrict__ s,
                     __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kPStages * kPStage);
  uint64_t* empty = full + kPStages;
  const int n0 = blockIdx.x * kPBN, m0 = blockIdx.y * kPBM;
  const int KT = (K + kPBK - 1) / kPBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kPStages; ++i) {
      hp::mbar_init(full + i, 1);    // the producer's arrival, then the stage's bytes
      hp::mbar_init(empty + i, 2);   // one thread of each consumer warpgroup
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kPConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // ---- producer: one thread keeps the ring of x and code tiles full ----
    if (tid == kPConsumers) {
      for (int c = 0; c < KT; ++c) {
        const int slot = c % kPStages;
        hp::mbar_wait(empty + slot, ((c / kPStages) & 1) ^ 1);   // the first round passes
        uint8_t* st = ring + slot * kPStage;
        hp::mbar_expect_tx(full + slot, kPStage);
        hp::tma_load_2d(st, &tm_x, c * kPBK, m0, full + slot);
        hp::tma_load_2d(st + kPXBytes, &tm_q, c * kPBK, n0, full + slot);
      }
    }
    return;
  }

  // ---- two consumer warpgroups: weight rows 64 wg .. 64 wg + 63 of the tile x kPBM rows of x
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;   // this thread's fragment rows r0, r0 + 8

  float d[kPAcc];
#pragma unroll
  for (int i = 0; i < kPAcc; ++i) d[i] = 0.f;
  for (int c = 0; c < KT; ++c) {
    const int slot = c % kPStages;
    hp::mbar_wait(full + slot, (c / kPStages) & 1);
    const uint8_t* xs = ring + slot * kPStage;
    const uint8_t* qs = xs + kPXBytes;
    // A fragments of the stage's four k16 steps: a0 / a1 rows r0 / r0 + 8 at k 2 t4, 2 t4 + 1,
    // a2 / a3 the same rows at k 2 t4 + 8, 2 t4 + 9 (x's k order)
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = kk * 16 + 2 * t4;
      af[kk][0] = widen2<0x5140>(lds_u16(code_at(qs, r0, k)));
      af[kk][1] = widen2<0x5140>(lds_u16(code_at(qs, r0 + 8, k)));
      af[kk][2] = widen2<0x5140>(lds_u16(code_at(qs, r0, k + 8)));
      af[kk][3] = widen2<0x5140>(lds_u16(code_at(qs, r0 + 8, k + 8)));
    }
    hp::fence_operands(d);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // k16 step kk: 32 bytes along each 128-byte x row
      wgmma_rs(d, af[kk], hp::desc_sw128(xs + kk * 32));
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_operands(d);
    if (wt == 0) hp::mbar_arrive(empty + slot);
  }

  // accumulator block j (rows of x 8 j .. 8 j + 7): weight rows r0 (e < 2), r0 + 8; rows of x
  // 8 j + 2 t4 + (e & 1)
  const int n = n0 + r0;
  const float s0 = n < N ? s[n] : 0.f, s8 = n + 8 < N ? s[n + 8] : 0.f;
#pragma unroll
  for (int j = 0; j < kPBM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 8 * j + 2 * t4 + (e & 1), nn = n + 8 * (e >> 1);
      if (m < M && nn < N)
        out[(long long)m * N + nn] = __float2bfloat16(d[4 * j + e] * ((e >> 1) ? s8 : s0));
    }
}

// ---------------------------------------------------------------------------
// M <= 64: mma.sync over TMA stages, K split across warps

constexpr int kDBN = 32;                      // weight columns per block
constexpr int kDBM = 32;                      // rows of x per block
constexpr int kDBK = 128;                     // k per stage
constexpr int kDWarps = 8;                    // consumer warps, chunk c to warp c % 8
constexpr int kDSlots = 2;                    // stages of each warp's own
constexpr int kDStages = kDWarps * kDSlots;
constexpr int kDConsumers = 32 * kDWarps;
constexpr int kDThreads = kDConsumers + 32;
constexpr int kDXBox = kDBM * 128;            // x [32 rows][64 k] bf16, 4 KB
constexpr int kDXBytes = 2 * kDXBox;          // x of a stage: two boxes
constexpr int kDQBytes = kDBN * kDBK;         // codes of a stage [32 n][128 bytes], 4 KB
constexpr int kDStage = kDXBytes + kDQBytes;  // 12 KB
constexpr int kDPitch = kDBN + 8;             // partial sums' row pitch (floats)
constexpr size_t kDSmem = 1024 + size_t(kDStages) * kDStage + 2 * kDStages * 8;
static_assert(kDWarps * kDBM * kDPitch * 4 <= kDStages * kDStage, "partials fit the ring");

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kDThreads, 1)
    wi8_decode_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_q, const float* __restrict__ s,
                      __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDStages * kDStage);
  uint64_t* empty = full + kDStages;
  const int n0 = blockIdx.x * kDBN, m0 = blockIdx.y * kDBM;
  const int KT = (K + kDBK - 1) / kDBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kDStages; ++i) {
      hp::mbar_init(full + i, 1);
      hp::mbar_init(empty + i, 1);   // lane 0 of the warp that owns the stage
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kDConsumers) {
    if (tid == kDConsumers) {
      for (int c = 0; c < KT; ++c) {   // chunk c: warp c % 8, its stage (c / 8) % 2
        const int r = c / kDWarps, slot = (c % kDWarps) * kDSlots + r % kDSlots;
        hp::mbar_wait(empty + slot, ((r / kDSlots) & 1) ^ 1);
        uint8_t* st = ring + slot * kDStage;
        hp::mbar_expect_tx(full + slot, kDStage);
        hp::tma_load_2d(st, &tm_x, c * kDBK, m0, full + slot);
        hp::tma_load_2d(st + kDXBox, &tm_x, c * kDBK + 64, m0, full + slot);
        hp::tma_load_2d(st + kDXBytes, &tm_q, c * kDBK, n0, full + slot);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  // the scale of this thread's column in the fold (one column a thread), loaded before the
  // stages arrive
  static_assert(kDConsumers % kDBN == 0, "a thread folds one column");
  const float s_col = n0 + tid % kDBN < N ? s[n0 + tid % kDBN] : 0.f;
  float acc[2][4][4];   // m16 tiles 0, 1 x n8 tiles 0..3
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int r = 0; warp + kDWarps * r < KT; ++r) {
    const int slot = warp * kDSlots + r % kDSlots;
    hp::mbar_wait(full + slot, (r / kDSlots) & 1);
    const uint8_t* xs = ring + slot * kDStage;
    const uint8_t* qs = xs + kDXBytes;
#pragma unroll
    for (int i = 0; i < kDBK / 16; ++i) {
      // x rows mt * 16 + g (+ 8), k 16 i + 4 t4 .. + 3: box i / 4, 16-byte chunk
      // 2 (i % 4) + t4 / 2 stored at chunk ^ (row % 8), bytes 8 (t4 % 2) ..
      uint2 xa[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = mt * 16 + g + 8 * h, chunk = 2 * (i % 4) + (t4 >> 1);
          xa[mt][h] = *reinterpret_cast<const uint2*>(
              xs + (i / 4) * kDXBox + row * 128 + ((chunk ^ (row & 7)) << 4) + 8 * (t4 & 1));
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // codes of column nt * 8 + g at k 16 i + 4 t4 .. + 3 (128-byte rows, 16-byte chunk i
        // stored at chunk i ^ (n % 8))
        const int n = nt * 8 + g;
        const uint32_t w = *reinterpret_cast<const uint32_t*>(qs + n * 128 +
                                                              ((i ^ (n & 7)) << 4) + 4 * t4);
        const uint32_t b0 = widen2<0x5140>(w), b1 = widen2<0x7362>(w);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16_16816(acc[mt][nt], xa[mt][0].x, xa[mt][1].x, xa[mt][0].y, xa[mt][1].y, b0, b1);
      }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + slot);
  }

  // every warp's stages consumed: the ring takes the partial sums [warp][32 rows][pitch]
  hp::named_barrier(1, kDConsumers);
  float* part = reinterpret_cast<float*>(ring);
  float* pw = part + warp * kDBM * kDPitch;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(pw + (mt * 16 + g + 8 * h) * kDPitch + nt * 8 + 2 * t4) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  hp::named_barrier(1, kDConsumers);
#pragma unroll
  for (int k = 0; k < kDBM * kDBN / kDConsumers; ++k) {
    const int e = tid + kDConsumers * k, row = e / kDBN, col = e % kDBN;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDWarps; ++w) sum += part[(w * kDBM + row) * kDPitch + col];
    const int m = m0 + row, n = n0 + col;
    if (m < M && n < N) out[(long long)m * N + n] = __float2bfloat16(sum * s_col);
  }
}

// ---------------------------------------------------------------------------
// fp32 activations: 16 x 16 outputs per block, one per thread, K staged by 16

constexpr int kF32Tile = 16;

__global__ void __launch_bounds__(kF32Tile* kF32Tile)
    wi8_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, float* __restrict__ out, int M, int N, int K) {
  __shared__ float xs[kF32Tile][kF32Tile + 1];
  __shared__ float qs[kF32Tile][kF32Tile + 1];
  const int tx = threadIdx.x % kF32Tile, ty = threadIdx.x / kF32Tile;
  const int m = blockIdx.y * kF32Tile + ty, n = blockIdx.x * kF32Tile + tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += kF32Tile) {
    const int mr = blockIdx.y * kF32Tile + ty, nr = blockIdx.x * kF32Tile + ty;
    xs[ty][tx] = (mr < M && k0 + tx < K) ? x[(long long)mr * K + k0 + tx] : 0.f;
    qs[ty][tx] = (nr < N && k0 + tx < K) ? float(q[(long long)nr * K + k0 + tx]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32Tile; ++kk) acc = fmaf(xs[ty][kk], qs[tx][kk], acc);
    __syncthreads();
  }
  if (m < M && n < N) out[(long long)m * N + n] = acc * s[n];
}

template <class Kernel>
int launch_tma(Kernel kernel, size_t smem, int threads, int bm, int bn, int box_m, int box_n,
               CUtensorMapSwizzle q_swizzle, const void* x, const void* q, const float* s,
               void* out, int M, int N, int K, cudaStream_t stream) {
  CUtensorMap tm_x, tm_q;
  if (!hp::encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, uint64_t(K) * 2, box_m,
                     64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, K, box_n,
                     q_swizzle == CU_TENSOR_MAP_SWIZZLE_64B ? 64 : 128, q_swizzle))
    return int(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  kernel<<<grid, threads, smem, stream>>>(tm_x, tm_q, s, static_cast<__nv_bfloat16*>(out), M,
                                          N, K);
  return int(cudaGetLastError());
}

}  // namespace ovla_wi8

namespace {
bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }
}  // namespace

// The bf16 routes (M > 64: wgmma; M <= 64: mma.sync); is_bf16 = 0 is refused
// (cudaErrorInvalidValue): fp32 x takes ovla_wi8_matmul_scalar. Returns the launch's
// cudaError_t (0 on success). x, q, s, out contiguous; K a multiple of 16 (the TMA maps'
// 16-byte rows of q); x and q 16-byte aligned.
extern "C" int ovla_wi8_matmul(const void* x, const void* q, const void* s, void* out, int M,
                               int N, int K, int is_bf16, void* stream) {
  namespace w = ovla_wi8;
  if (!is_bf16 || M < 1 || N < 1 || K < 16 || K % 16 != 0 || misaligned(x) || misaligned(q) ||
      (M + w::kPBM - 1) / w::kPBM > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  if (M <= 64)
    return w::launch_tma(w::wi8_decode_kernel, w::kDSmem, w::kDThreads, w::kDBM, w::kDBN,
                         w::kDBM, w::kDBN, CU_TENSOR_MAP_SWIZZLE_128B, x, q, sf, out, M, N, K,
                         st);
  return w::launch_tma(w::wi8_wgmma_kernel, w::kPSmem, w::kPThreads, w::kPBM, w::kPBN, w::kPBM,
                       w::kPBN, CU_TENSOR_MAP_SWIZZLE_64B, x, q, sf, out, M, N, K, st);
}

// fp32 x: the scalar fp32-FMA kernel, the same function.
extern "C" int ovla_wi8_matmul_scalar(const void* x, const void* q, const void* s, void* out,
                                      int M, int N, int K, void* stream) {
  namespace w = ovla_wi8;
  if (M < 1 || N < 1 || K < 1 || (M + w::kF32Tile - 1) / w::kF32Tile > 65535)
    return int(cudaErrorInvalidValue);
  const dim3 grid((N + w::kF32Tile - 1) / w::kF32Tile, (M + w::kF32Tile - 1) / w::kF32Tile);
  w::wi8_f32_kernel<<<grid, w::kF32Tile * w::kF32Tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), M, N, K);
  return int(cudaGetLastError());
}
