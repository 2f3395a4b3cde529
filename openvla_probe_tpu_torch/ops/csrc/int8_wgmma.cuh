// The int8 wgmma core shared by w8a8_matmul.cu and vit_mlp.cu: out[m, n] = epi(Σ_k x8[m, k] ·
// w8[n, k], m, n), the exact int32 sum handed to the caller's epilogue functor. Above M = 64 int8
// wgmma fed by TMA on a persistent grid; at M <= 64 the split-K decode route of int8_decode.cuh
// with the same functor (`run_int8`; w8a8_matmul.cu picks its routes itself).
//
// Design (w8a8_matmul's wgmma route, templated on the epilogue and the weight form). A tile is
// outᵀ: kBN = 128 weight rows (n) x kBM rows of activation codes (m, wgmma's N), so one skeleton
// serves three weight forms: int8 weights are wgmma's shared-memory operand A; nibble planes are
// rebuilt in registers straight into its register operand A (widening 4-bit codes into a
// shared-memory tile first cost 0.60-0.62 ms against 0.51 at 6912 x 4096 x 4096 in
// w4a8_matmul.cu), and so are grouped int4 codes (W::kInt4, the int4 requant route): each weight
// row's s8 made at the tile's start from its G scales, r per (row, group) by an IEEE division, a
// 16-entry code table a row a chunk (int8_mma.cuh requant_lut: four lanes a word, shuffles), the
// nibbles looked up with byte permutes (requant). The activation codes are its shared-memory
// operand B in their natural k order (or the pre-pass's permuted order for packed codes). 384
// threads:
//   * a producer warpgroup that gives its registers to the consumers (setmaxnreg, as
//     wi8_matmul.cu), in which one thread keeps a ring of 128-deep k chunks full with TMA boxes:
//     activation codes [kBM rows][128 bytes] (128-byte swizzle; rows past M and k past K
//     zero-filled: SigLIP's K = 4304), and int8 weights [128 n][128 bytes] (128-byte swizzle) or
//     the hi and lo planes [128 n][64 bytes] each (64-byte swizzle: conflict-free ldmatrix rows),
//     or the int4 codes from a 3-D map [G][N][gsz / 2] (rows past N zero-filled inside each
//     group): one box [128 n][64 bytes] a chunk where gsz is a multiple of 128 (64-byte
//     swizzle, a nibble plane's layout), else four boxes [128 n][16 bytes], one 32-deep k step
//     of one group each (unswizzled: 8 rows of 16 bytes are 128 contiguous bytes, so ldmatrix
//     is conflict-free; a step past K not loaded), on full / empty mbarriers; it runs on into
//     the block's next tile while the consumers store the last one;
//   * two consumer warpgroups of 64 weight rows x kBM rows, one int32 accumulator over all of K
//     (no group fold): per chunk four wgmma.m64nNk32.s32.s8.s8 committed as one group. int8
//     leaves keep one group in flight: the consumer waits for the group before (wgmma_wait<1>)
//     and releases its stage, so the next chunk's wait and descriptors are sent under the
//     products. The nibble and int4 loaders build each chunk's fragments (two ldmatrix per plane
//     a warp, `rebuild` or `requant`) between groups and wait for their group: ptxas serializes a register-A wgmma
//     behind fragments written while a group is in flight (C7513), and a second fragment buffer
//     measured 1.5-2.3 % slower than the wait; the other warpgroup's products run meanwhile;
//   * the epilogue, on the accumulators in registers: either direct (w8a8_matmul: the functor's
//     `head`, the scales, then 2-byte stores a weight row apart) or, for a functor with kStaged
//     (the fused tower kernels), staged through shared memory in rounds of 32 activation rows x
//     64 weight rows a warpgroup: `head2` turns two accumulators of a weight row into T (the
//     scales, bias and LayerScale, each step rounded as the function says) into a buffer of
//     row pitch 64 + 16 / sizeof(T) elements (the fragment writes of a warp hit 32 distinct
//     banks), read back as 16-byte vectors of one output row, so that the row operand's reads
//     (a residual, out = rt(r + head): issued at the start of the round, before the fragment
//     writes, added by `add_rows`) and the stores are whole 128-byte rows of the tile.
//     At the towers' short K (8-9 chunks a tile) the epilogue is most of a tile's time: with
//     none at all fused_ln_w8a8's launch-weighted mix ran 0.035 ms against 0.079 on an H100
//     80GB HBM3 at 700 W (tools/kernel_ab.py knock-outs, PERF.md §6), so the functors keep it
//     to few instructions (bf16x2 steps, one conversion for two outputs).
//   int8: kBM = 256 (m64n256, 128 accumulators a thread, 4 stages of 48 KB) or kBM = 128 (m64n128,
//   64 accumulators, 6 stages of 32 KB); nibble: kBM = 192 (m64n192, 96 accumulators, 5 stages of
//   40 KB); int4: kBM = 192 (6 stages of 32 KB); 168 registers a thread, the most ptxas gives a
//   384-thread block.
#pragma once

#include "int8_decode.cuh"

namespace ovla_wg {

namespace hp = ovla_hp;
using ovla_i8::ldmatrix_x4;
using ovla_i8::to_f32;
using ovla_i8d::Groups;
using ovla_i8d::store1;
using ovla_i8d::W;

constexpr int kChunk = 128;                 // k per stage
constexpr int kBN = 128;                    // weight rows per block: two warpgroups of 64
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + a producer warpgroup (setmaxnreg)
constexpr int kStgRows = 32;                // activation rows a round of the staged epilogue

// the weight forms: int8 leaves (W::kInt8, shared-memory A), and packed 4-bit codes rebuilt in
// registers into the register A (W::kNibble: the two planes; W::kInt4: grouped int4 codes
// requantized per row)
template <W WF, int BM>
struct Pre {
  static constexpr bool kRegA = WF != W::kInt8;
  static_assert(WF != W::kHi, "the hi plane alone has no wgmma route");
  static_assert(kRegA ? BM == 192 : (BM == 256 || BM == 128), "the instantiated tile shapes");
  static constexpr int kBM = BM;                      // activation rows per block: wgmma's N
  static constexpr int kABytes = kBM * kChunk;       // activation codes of a stage
  // int8 [128][128], hi then lo [128][64], or int4 [4 k steps][128][16]
  static constexpr int kQBytes = WF == W::kInt4 ? kBN * kChunk / 2 : kBN * kChunk;
  static constexpr int kStage = kABytes + kQBytes;   // a multiple of 1024
  static constexpr int kStages = WF == W::kNibble ? 5 : WF == W::kInt4 ? 6 : (BM == 256 ? 4 : 6);
  static constexpr int kAcc = kBM / 2;               // int32 accumulators a thread
};

// the staged epilogue's buffer: two warpgroups x 32 rows x (64 + 16 / sizeof(T)) elements
template <typename T>
struct Stg {
  static constexpr int kV = 16 / sizeof(T);   // elements of a 16-byte vector
  static constexpr int kPitch = 64 + kV;      // elements a staged row
  static constexpr int kBytes = 2 * kStgRows * kPitch * sizeof(T);
  static constexpr int kItems = kStgRows * (64 / kV) / 128;   // vectors a thread a round
};

template <W WF, int BM, typename T, bool STAGED>
constexpr size_t smem_bytes() {
  using P = Pre<WF, BM>;
  return 1024 + size_t(P::kStages) * P::kStage + (STAGED ? Stg<T>::kBytes : 0) +
         2 * P::kStages * 8;
}

#define OVLA_IACC8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[128] += A (64 x 32 int8 at `da`, K-major) · B (32 x 256 int8 at `db`, K-major)
__device__ __forceinline__ void wgmma_s8_ss_m64n256k32(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : OVLA_IACC8(0), OVLA_IACC8(8), OVLA_IACC8(16), OVLA_IACC8(24), OVLA_IACC8(32),
        OVLA_IACC8(40), OVLA_IACC8(48), OVLA_IACC8(56), OVLA_IACC8(64), OVLA_IACC8(72),
        OVLA_IACC8(80), OVLA_IACC8(88), OVLA_IACC8(96), OVLA_IACC8(104), OVLA_IACC8(112),
        OVLA_IACC8(120)
      : "l"(da), "l"(db), "n"(1));
}

// d[64] += A (64 x 32 int8 at `da`, K-major) · B (32 x 128 int8 at `db`, K-major)
__device__ __forceinline__ void wgmma_s8_ss_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : OVLA_IACC8(0), OVLA_IACC8(8), OVLA_IACC8(16), OVLA_IACC8(24), OVLA_IACC8(32),
        OVLA_IACC8(40), OVLA_IACC8(48), OVLA_IACC8(56)
      : "l"(da), "l"(db), "n"(1));
}

// d[96] += A (4 registers: this thread's 16 x 32 int8 fragment of its warp's rows) ·
// B (32 x 192 int8 at `db`, K-major)
__device__ __forceinline__ void wgmma_s8_rs_m64n192k32(int (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p;\n"
      "}\n"
      : OVLA_IACC8(0), OVLA_IACC8(8), OVLA_IACC8(16), OVLA_IACC8(24), OVLA_IACC8(32),
        OVLA_IACC8(40), OVLA_IACC8(48), OVLA_IACC8(56), OVLA_IACC8(64), OVLA_IACC8(72),
        OVLA_IACC8(80), OVLA_IACC8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}
#undef OVLA_IACC8

// An epilogue functor (EpiW8 in int8_decode.cuh; the fused tower epilogues in vit_mlp.cu):
//   Col col(int n)                          the per-weight-row operands, read once a tile
//   float row(int m)                        the activation row's scale s_x
//   float head(int acc, float sxm, Col)     the value before any row operand
//   float tail(float y, long long o)        the output at flat index o from head's y (direct)
//   operator()(int acc, int m, int n)       the whole epilogue of one output (the decode route)
//   kStaged: stage the tile through shared memory, with
//     void head2(int a0, int a1, float sx0, float sx1, Col, T& y0, T& y1)   two outputs of one
//       weight row (activation rows m, m + 1) as T
//     uint4 add_rows(uint4 r, uint4 y)      16 bytes of rowop + 16 bytes of head values, in T;
//   then `rowop` (nullptr, or [M, N] in T, read-only) is
//   added last: out = rt(rowop[m, n] + head)
template <typename T, W WF, int BM, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_lo, const Epi epi, T* __restrict__ out,
                 int M, int N, int K, int vec, const Groups grp) {
  using P = Pre<WF, BM>;
  constexpr int S = P::kStages;
  constexpr bool kStaged = Epi::kStaged;
  constexpr bool NIB = WF == W::kNibble, INT4 = WF == W::kInt4;
  static_assert(!(INT4 && kStaged), "the int4 form stores direct (its s8 replaces the functor's s)");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  T* stg = reinterpret_cast<T*>(ring + S * P::kStage);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + S * P::kStage + (kStaged ? Stg<T>::kBytes : 0));
  uint64_t* empty = full + S;
  // tile t: weight rows (t % NT) · 128, activation rows (t / NT) · kBM; block b takes tiles
  // b, b + gridDim.x, ...
  const int NT = (N + kBN - 1) / kBN, tiles = NT * ((M + P::kBM - 1) / P::kBM);
  const int KC = (K + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hp::mbar_init(full + i, 1);    // the producer's arrival, then the stage's bytes
      hp::mbar_init(empty + i, 2);   // one thread of each consumer warpgroup
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // ---- producer: one thread keeps the ring of activation and weight tiles full, running
    // ahead into the block's next tile while the consumers store the last one
    if (tid == kConsumers) {
      int g = 0;   // the block's chunks so far, over its tiles: stage g % S, round g / S
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = (t % NT) * kBN, m0 = (t / NT) * P::kBM;
        for (int c = 0; c < KC; ++c, ++g) {
          const int slot = g % S;
          hp::mbar_wait(empty + slot, ((g / S) & 1) ^ 1);   // the first round passes
          uint8_t* st = ring + slot * P::kStage;
          if constexpr (INT4) {
            // gsz a multiple of 128: the chunk in one box [128 n][64 bytes] (64-byte swizzle);
            // else its 32-deep k steps, one box [128 n][16 bytes] of one group each, at
            // st + kABytes + 2048 kk, a step past K not loaded (its codes map to 0)
            const int steps = grp.gsz % kChunk == 0 ? 1 : min(4, (K - c * kChunk) / 32);
            const int box = grp.gsz % kChunk == 0 ? P::kQBytes : kBN * 16;
            hp::mbar_expect_tx(full + slot, P::kABytes + steps * box);
            hp::tma_load_2d(st, &tm_a, c * kChunk, m0, full + slot);
            for (int kk = 0; kk < steps; ++kk) {
              const int k = c * kChunk + 32 * kk;
              hp::tma_load_3d(st + P::kABytes + kk * box, &tm_q, (k % grp.gsz) / 2, n0,
                              k / grp.gsz, full + slot);
            }
            continue;
          }
          hp::mbar_expect_tx(full + slot, P::kStage);
          hp::tma_load_2d(st, &tm_a, c * kChunk, m0, full + slot);
          if constexpr (NIB) {
            hp::tma_load_2d(st + P::kABytes, &tm_q, c * (kChunk / 2), n0, full + slot);
            hp::tma_load_2d(st + P::kABytes + kBN * kChunk / 2, &tm_lo, c * (kChunk / 2), n0,
                            full + slot);
          } else {
            hp::tma_load_2d(st + P::kABytes, &tm_q, c * kChunk, n0, full + slot);
          }
        }
      }
    }
    return;
  }

  // ---- two consumer warpgroups: weight rows 64 wg .. 64 wg + 63 of the tile x kBM rows
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g8;   // this thread's weight rows r0, r0 + 8

  const bool one_group = INT4 && grp.gsz % kChunk == 0;   // int4: a chunk lies in one group
  int g = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = (t % NT) * kBN, m0 = (t / NT) * P::kBM;
    // int4: s8 of this thread's weight rows n0 + r0 + 8 h (0 past N), the 4 lanes t4 of a row
    // taking its G scales in turn (a max: any order)
    float s8[2] = {0.f, 0.f};
    if constexpr (INT4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + r0 + 8 * h;
        float mx = __int_as_float(0xff800000u);   // -inf
        if (n < N)
          for (int gi = t4; gi < grp.G; gi += 4)
            mx = fmaxf(mx, __ldg(grp.s + (long long)n * grp.G + gi));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        s8[h] = n < N ? __fmul_rn(mx, ovla_i8::kReqS8) : 0.f;
      }
    }
    // int4: the scale s[n, g] of weight row n = n0 + r0 + 8 h in the group holding k (0 past N
    // and past K), and the requant r from it; one group a chunk: each chunk's scales loaded a
    // chunk ahead
    auto group_s = [&](int h, int k) {
      const int n = n0 + r0 + 8 * h, gi = k / grp.gsz;
      return n < N && gi < grp.G ? __ldg(grp.s + (long long)n * grp.G + gi) : 0.f;
    };
    float snext[2] = {0.f, 0.f};
    if constexpr (INT4) {
      if (one_group) snext[0] = group_s(0, 0), snext[1] = group_s(1, 0);
    }
    int d[P::kAcc];
#pragma unroll
    for (int i = 0; i < P::kAcc; ++i) d[i] = 0;
    for (int c = 0; c < KC; ++c, ++g) {
      const int slot = g % S;
      ovla_i8::Lut tbl[2];   // int4, one group a chunk: the tables of this thread's two rows
      if constexpr (INT4) {
        if (one_group) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float sv = snext[h];
            snext[h] = group_s(h, (c + 1) * kChunk);
            tbl[h] = ovla_i8::requant_lut(ovla_i8::requant_r(sv, s8[h]), lane);
          }
        }
      }
      hp::mbar_wait(full + slot, (g / S) & 1);
      const uint8_t* as = ring + slot * P::kStage;   // B: the chunk's activation codes
      const uint8_t* qs = as + P::kABytes;            // A: the weights
      uint32_t f[4][4];   // packed codes: the chunk's register fragments
      if constexpr (INT4) {
        // one group a chunk: a nibble plane's layout (64-byte rows, 16-byte chunk kk of row n
        // at kk ^ ((n >> 1) & 3)); else box kk [128 n][16 bytes] at 2048 kk. ldmatrix hands lane
        // (g8, t4) the packed bytes 4 t4 .. 4 t4 + 3 of row g8 (+ 8 h) in k32 step kk, its codes
        // 8 t4 .. 8 t4 + 7, requantized by the row's table into the fragment's k 4 t4 .. 4 t4 + 3
        // and 16 + 4 t4 .. 16 + 4 t4 + 3 (the pre-pass's order)
        uint32_t ph[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = wg * 64 + warp * 16 + 8 * h + (lane & 7);
          ldmatrix_x4(ph[h], qs + (one_group ? n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4)
                                             : (lane >> 3) * (kBN * 16) + n * 16));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const ovla_i8::Lut tb =
                one_group ? tbl[h]
                          : ovla_i8::requant_lut(
                                ovla_i8::requant_r(group_s(h, c * kChunk + 32 * kk), s8[h]), lane);
            ovla_i8::requant(ph[h][kk], tb, f[kk][h], f[kk][h + 2]);   // rows g8 (+ 8 h)
          }
        }
      } else if constexpr (NIB) {
        // ldmatrix hands lane (g8, t4) the packed bytes 4 t4 .. 4 t4 + 3 of row g8 of the
        // 8-row group in k32 step kk (matrix kk; 16-byte chunk kk of row n stored at
        // kk ^ ((n >> 1) & 3)), i.e. its codes 8 t4 .. 8 t4 + 7 of each plane, rebuilt into
        // the fragment's k 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3 (the pre-pass's order)
        uint32_t ph[2][4], pl[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = wg * 64 + warp * 16 + 8 * h + (lane & 7);
          const int off = n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4);
          ldmatrix_x4(ph[h], qs + off);
          ldmatrix_x4(pl[h], qs + kBN * kChunk / 2 + off);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ovla_i8::rebuild(ph[0][kk], pl[0][kk], f[kk][0], f[kk][2]);   // rows g8
          ovla_i8::rebuild(ph[1][kk], pl[1][kk], f[kk][1], f[kk][3]);   // rows g8 + 8
        }
      }
      hp::fence_operands(d);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // k32 step kk: 32 bytes along each 128-byte row
        if constexpr (P::kRegA)
          wgmma_s8_rs_m64n192k32(d, f[kk], hp::desc_sw128(as + kk * 32));
        else if constexpr (BM == 256)
          wgmma_s8_ss_m64n256k32(d, hp::desc_sw128(qs + wg * 64 * kChunk + kk * 32),
                                 hp::desc_sw128(as + kk * 32));
        else
          wgmma_s8_ss_m64n128k32(d, hp::desc_sw128(qs + wg * 64 * kChunk + kk * 32),
                                 hp::desc_sw128(as + kk * 32));
      }
      hp::wgmma_commit();
      if constexpr (P::kRegA) {
        // ptxas serializes a register-A wgmma behind the next chunk's fragments anyway (C7513):
        // wait for this group and release its stage (1.5-2.3 % faster than a group in flight)
        hp::wgmma_wait<0>();
        hp::fence_operands(d);
        if (wt == 0) hp::mbar_arrive(empty + slot);
      } else {
        hp::wgmma_wait<1>();   // the group before this one is done: release its stage
        hp::fence_operands(d);
        if (c > 0 && wt == 0) hp::mbar_arrive(empty + (g - 1) % S);
      }
    }
    if constexpr (!P::kRegA) {
      hp::wgmma_wait<0>();
      hp::fence_operands(d);
      if (wt == 0) hp::mbar_arrive(empty + (g - 1) % S);   // the tile's last stage
    }

    // accumulator block j (activation rows 8 j .. 8 j + 7): weight rows r0 (e < 2), r0 + 8;
    // activation rows 8 j + 2 t4 + (e & 1)
    using Col = typename Epi::Col;
    if constexpr (!kStaged) {
      const int n = n0 + r0;
      Col c0{}, c8{};
      if constexpr (INT4) {   // the requantized rows' scales s8 in place of the functor's s
        c0 = Col{s8[0]}, c8 = Col{s8[1]};
      } else {
        if (n < N) c0 = epi.col(n);
        if (n + 8 < N) c8 = epi.col(n + 8);
      }
#pragma unroll
      for (int j = 0; j < P::kBM / 8; ++j) {
        const int m = m0 + 8 * j + 2 * t4;
        const float sm0 = m < M ? epi.row(m) : 0.f, sm1 = m + 1 < M ? epi.row(m + 1) : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int mm = m + (e & 1), nn = n + 8 * (e >> 1);
          const long long o = (long long)mm * N + nn;
          if (mm < M && nn < N)
            store1(out + o, epi.tail(epi.head(d[4 * j + e], (e & 1) ? sm1 : sm0, (e >> 1) ? c8 : c0), o));
        }
      }
    } else {
      // rounds of 32 activation rows: the warpgroup's [32 m][64 n] block of head values in T
      // through its buffer; then thread wt stores the vectors i = wt + 128 k of the round (row
      // i / VR, columns (i % VR) · V ..), the row operand's vectors read at the round's start
      constexpr int V = Stg<T>::kV, PT = Stg<T>::kPitch, VR = 64 / V, IT = Stg<T>::kItems;
      T* buf = stg + wg * kStgRows * PT;
      const int nl = warp * 16 + g8;   // this thread's weight rows nl, nl + 8 of the buffer
      const int n = n0 + r0;
      const Col c0 = n < N ? epi.col(n) : Col{}, c8 = n + 8 < N ? epi.col(n + 8) : Col{};
#pragma unroll
      for (int R = 0; R < P::kBM / kStgRows; ++R) {
        uint4 r[IT];   // the row operand's vectors of this thread's outputs
#pragma unroll
        for (int k = 0; k < IT; ++k) {
          const int i = wt + 128 * k, m = m0 + R * kStgRows + i / VR;
          const int nb = n0 + wg * 64 + (i % VR) * V;
          if (vec && epi.rowop && m < M && nb < N)
            r[k] = __ldg(reinterpret_cast<const uint4*>(epi.rowop + (long long)m * N + nb));
        }
#pragma unroll
        for (int jj = 0; jj < kStgRows / 8; ++jj) {
          const int j = R * (kStgRows / 8) + jj, ml = 8 * jj + 2 * t4, m = m0 + 8 * j + 2 * t4;
          const float sm0 = m < M ? epi.row(m) : 0.f, sm1 = m + 1 < M ? epi.row(m + 1) : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // weight row nl + 8 h: activation rows ml, ml + 1
            T y0, y1;
            epi.head2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], sm0, sm1, h ? c8 : c0, y0, y1);
            buf[ml * PT + nl + 8 * h] = y0;
            buf[(ml + 1) * PT + nl + 8 * h] = y1;
          }
        }
        hp::named_barrier(1 + wg, 128);
#pragma unroll
        for (int k = 0; k < IT; ++k) {
          const int i = wt + 128 * k, rl = i / VR, m = m0 + R * kStgRows + rl;
          const int nb = n0 + wg * 64 + (i % VR) * V;
          if (m >= M || nb >= N) continue;
          const uint4 y = *reinterpret_cast<const uint4*>(buf + rl * PT + (i % VR) * V);
          const long long o = (long long)m * N + nb;
          if (vec) {
            *reinterpret_cast<uint4*>(out + o) = epi.rowop ? epi.add_rows(r[k], y) : y;
          } else {
            const T* yt = reinterpret_cast<const T*>(&y);
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (nb + v < N) store1(out + o + v, epi.tail(to_f32(yt[v]), o + v));
          }
        }
        hp::named_barrier(1 + wg, 128);   // the buffer is free for the next round
      }
    }
  }
}

// One launch of the wgmma route: codes xq int8 [M, K], weights q int8 [N, K] (or the planes q =
// hi, lo, uint8 [N, K / 2] with W::kNibble, or grouped int4 codes q uint8 [G][N][gsz / 2] with
// W::kInt4 and `grp`). Returns the cudaError_t.
template <typename T, W WF, int BM, class Epi>
int launch_wgmma(const int8_t* xq, const uint8_t* q, const uint8_t* lo, const Epi& epi, T* out,
                 int M, int N, int K, cudaStream_t stream, const Groups grp = {}) {
  using P = Pre<WF, BM>;
  constexpr bool NIB = WF == W::kNibble;
  constexpr size_t kSmem = smem_bytes<WF, BM, T, Epi::kStaged>();
  CUtensorMap tm_a, tm_q, tm_lo;
  const uint64_t qcols = NIB ? K / 2 : K;
  const uint32_t qbox = NIB ? kChunk / 2 : kChunk;
  const CUtensorMapSwizzle qsw = NIB ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hp::encode_2d(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, P::kBM, kChunk,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      (WF == W::kInt4
           ? !hp::encode_groups(&tm_q, q, grp.G, N, grp.gsz, kBN)
           : !hp::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, qcols, qcols, kBN, qbox,
                            qsw)) ||
      (NIB && !hp::encode_2d(&tm_lo, CU_TENSOR_MAP_DATA_TYPE_UINT8, lo, N, qcols, qcols, kBN,
                             qbox, qsw)))
    return int(cudaErrorInvalidValue);
  if (!NIB) tm_lo = tm_q;   // unused
  int vec = 0;   // the staged stores and row operand reads as 16-byte vectors: aligned rows
  if constexpr (Epi::kStaged) {
    auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    vec = N % 8 == 0 && aligned(out) && (epi.rowop == nullptr || aligned(epi.rowop));
  }
  auto kernel = wgmma_kernel<T, WF, BM, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((N + kBN - 1) / kBN) * ((M + P::kBM - 1) / P::kBM);
  const int sms = hp::sm_count();
  const int grid = int(tiles < sms ? tiles : sms);   // one persistent block an SM
  kernel<<<grid, kThreads, kSmem, stream>>>(tm_a, tm_q, tm_lo, epi, out, M, N, K, vec, grp);
  return int(cudaGetLastError());
}

// The int8 tile rows above M = 64 for an int8-weight GEMM of M x N: the tiling whose modelled time,
// waves (ceil(tiles / SMs)) x rows a tile x the cost of a row, is the least; a 128-row tile's row
// costs 1.2 of a 256-row tile's (128-row tiles ran w8a8_matmul's turbo wgmma mix 1.21x slower on
// an H100), so 128 rows win only where 256-row tiles leave most of a last wave idle (DINOv2's
// proj and fc2, N = 1024: 200 tiles on 132 SMs). Measured on an H100 80GB HBM3 at 700 W, the
// towers' launch-weighted mixes in ms under this rule / all 128 / all 256: fused_ln_w8a8 0.0792 /
// 0.0823 / 0.0809, fused_mlp_residual 0.2723 / 0.2873 / 0.2765 (PERF.md §6).
inline int tile_rows(int M, int N) {
  const long long sms = hp::sm_count(), nt = (N + kBN - 1) / kBN;
  const long long w256 = (nt * ((M + 255) / 256) + sms - 1) / sms;
  const long long w128 = (nt * ((M + 127) / 128) + sms - 1) / sms;
  return 128 * 12 * w128 < 256 * 10 * w256 ? 128 : 256;
}

// out = epi(xq · qᵀ) over int8 weights: the decode route at M <= 64, else the wgmma route with
// `tile_rows`' tile. Returns the cudaError_t.
template <typename T, class Epi>
int run_int8(const int8_t* xq, const int8_t* q, const Epi& epi, T* out, int M, int N, int K,
             cudaStream_t stream) {
  namespace d = ovla_i8d;
  const uint8_t* qp = reinterpret_cast<const uint8_t*>(q);
  if (M <= 64) return d::launch<d::W::kInt8>(xq, qp, nullptr, epi, out, M, N, K, stream);
  if (tile_rows(M, N) == 128)
    return launch_wgmma<T, W::kInt8, 128>(xq, qp, nullptr, epi, out, M, N, K, stream);
  return launch_wgmma<T, W::kInt8, 256>(xq, qp, nullptr, epi, out, M, N, K, stream);
}

}  // namespace ovla_wg
