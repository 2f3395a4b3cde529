// The backward of expert_ragged (the grouped expert product of the sparse-MoE trunk,
// expert_ragged.cu): for y[m] = x[m] · w[e(m)]ᵀ [· s[e(m)]] over rows sorted by expert
// (group_sizes[e] rows of expert e, in expert order, rows past their sum 0),
//   expert_ragged_dx: dx[m, :] = dy[m, :] · w[e(m)]  (codes: (dy[m] ⊙ s[e(m)]) · q[e(m)]) -> [M, I]
//   expert_ragged_dw: dW[e]    = Σ over expert e's rows of dy[m]ᵀ · x[m]               -> [E, O, I]
// both with fp32 sums and one rounding to the output's type; rows past the groups' sum give
// dx = 0 and take no part in dW; an expert with no rows gets dW = 0, written.
//
// Replaces XLA's transpose of lax.ragged_dot_general, by which jax.grad differentiates
// openvla_probe_tpu/models/moe.py::_expert_ragged (a Mosaic grouped matmul on the TPU). XLA
// scales the fp32 cotangent by s[e_row] before the transposed product and multiplies it by the
// codes widened to the activation type: the product of an fp32 operand. Both kernels read the
// group sizes on the device (int32): no host sync, no pre-pass.
//
// Bound on the H100 at the Mixtral-8x7B training shapes (M = 2·B·T = 5120 top-2 rows, E = 8,
// D = 4096, F = 14336, LoRA r = 32):
//   * dx of an int8 base: 2·5120·14336·4096 = 0.60 TFLOP a launch, bound by tensor-core
//     operations (0.61 ms at 989 TFLOP/s; two products a scaled cotangent, 1.22 ms);
//   * the LoRA dx: dy · B (N = r) by reading dy once (0.044 ms at O = 14336), dt · A (K = r) by
//     writing dx once (0.044 ms at I = 14336);
//   * dW of a LoRA factor (dA [8, 32, I], dB [8, O, 32]): by reading dy and x once
//     (5120 · (O + I) · 2 bytes, 0.044 ms at 3.35 TB/s at O = 14336).
//
// Every tensor-core route is wgmma fed by TMA, warp-specialized, on a persistent grid (one CTA
// an SM), in the shape of w4a8_dx.cu and expert_ragged.cu's prefill route. 384 threads: a
// producer warpgroup at 40 registers (setmaxnreg), in which one thread keeps a ring of 64-deep
// stages of the contraction full on full / empty mbarriers, and two consumer warpgroups of 64
// output rows each at 232 registers. Each stage's (int8 dx) or 128 of the contraction's (kPromote
// stages: bf16 dx, dW) products go into fresh accumulators (scale-d = 0) that are then added to
// the running fp32 sums: a tensor-core accumulator drops the low bits of its addends
// (expert_ragged.cu). A fixed summation order and no atomics on every route: two runs give the
// same bits.
//
// dx: a tile is 128 rows of one expert (it never spans two: it starts at its expert's row; the
// rows of the next expert it holds are computed and never stored) x BN columns of I. Every CTA
// builds the work list from the group sizes (expert_ragged.cu's plan / work_at): (expert,
// column tile, chunk of the contraction, row tile), the row tiles fastest, so an expert's weight
// slice [O, BN] stays in L2 while its row tiles read it; then the zero tiles of the rows past
// the sum. Each stage: dy [128 rows][64 o] (a TMA box, 128-byte swizzle, K-major) and the
// weights of its 64 rows of O:
//   * int8 codes (BN = 128): a TMA box [64 o][128 i] (128-byte swizzle) and the stage's 64
//     scales s[e, o0:o0+64] (a bulk copy), all on the stage's full mbarrier by byte count. Three
//     warps of the producer warpgroup widen the codes once a stage to fp16 (`widen2h`, exact)
//     into an unswizzled MN-major tile (w4a8_dx.cu's layout: 8 x 8 core matrices, 128 bytes
//     apart along o, 1024 along i), one of kBufs, which both consumer warpgroups read by
//     descriptor (bfull / bempty mbarriers). The scale rides on operand A, as the plain version
//     and XLA put it: v = fp32(dy · s[e, o]); each row's v over the stage is scaled by a power
//     of two 2^k (its largest |v| into [2^14, 2^15)) and split into two fp16 terms, hi =
//     fp16(v'), lo = fp16(v' - hi), within 2^-22 · |v'| of v' (`build_terms`); wgmma
//     m64n128k16 f16 with the terms as register A, two products a k16 step, the stage's sums
//     added to the running fp32 ones times 2^-k. Products are exact in fp32 and every stage is
//     promoted: at 5120 x 14336 -> 4096 (4096 -> 14336) 5541 (14967) outputs sit off the
//     correctly rounded value of an fp64 reference, the fp32 plain version 19257 (49122); three
//     exact bf16 terms (v split by truncation, the 128-deep promotion) gave 8083 (26230) at
//     3.33 (3.26) ms.
//     Registers: 64 running sums + 64 of the stage + 32 fragment registers (2 terms x 4 k16
//     steps x 4) + the stage's 32 v a consumer thread, under setmaxnreg's 232 (ptxas reports the
//     launch bound's 168, no spill); the fragments are built between groups (after
//     wgmma_wait<0>), so no register of an in-flight wgmma is written (ptxas C7513), and the
//     other warpgroup's products run meanwhile.
//     What bounds it (H100 80GB HBM3 at 700 W, 2.79 / 2.73 ms against a 0.61 operations bound;
//     knock-out copies of this file timed in turns by tools/kernel_ab.py, PERF.md §6): with no
//     fragment build the products and the ring alone take 2.10 / 2.07 (70 % of the two
//     products' peak over tiles of 128 rows, of which an expert's last holds the next one's);
//     with no products the build, the widening and the ring take 1.83 / 1.81; one term 2.26 /
//     2.22; no widening or no per-stage fold is no faster. The fragment build is what the
//     products do not hide: taking turns on the tensor cores (named barriers) and building half
//     a stage ahead (two fragment sets) were each 2-5 % slower.
//   * bf16 weights: BN / 64 TMA boxes [64 o][64 i] (128-byte swizzle), wgmma's operand B read
//     MN-major with the transpose bit; one product a k16 step, both operands in shared memory.
//     BN = 64 where I <= 64 (a LoRA dy · B: N = r, the columns past I zero-filled by the TMA
//     unit), else 128. Where the tiles alone leave the card short (dy · B: 40 row tiles at M =
//     5120), the contraction is cut into `splits` chunks across CTAs (ops/expert_ragged.py::
//     dx_tiling, a pure function of the shapes): each chunk's fp32 partial tile goes to a
//     workspace, and a second grid adds the chunks in order and casts once. Unsplit, the
//     epilogue goes through shared memory as whole 16-byte pieces of output rows: dt · A (one k
//     step a tile) is bound by its stores (0.166 -> 0.071 ms to F with the staging).
//
// dW: a tile is 128 channels of the wide operand P x BN of the narrow one Q (BN = 64 where the
// narrow side is <= 64, a LoRA factor's r, else 128), the rows of one expert its contraction:
// dB [E, O, r] (P = dy, Q = t), and dA [E, r, I] computed as its transpose dAᵀ = xᵀ · dt (P = x,
// Q = dt) and stored transposed, so wgmma's 64-row minimum is not spent on r. Both operands are
// MN-major in the contraction: TMA boxes [64 rows][64 channels] (128-byte swizzle), wgmma ss with
// both transpose bits, one P box a consumer warpgroup. The last stage of a piece zeroes its P
// rows past it in shared memory (fence.proxy.async, a warpgroup barrier) before the products,
// so the next expert's rows add nothing. With few output tiles (a LoRA factor, or one expert
// holding every row) an expert's rows are cut into chunks of `rows` (a pure function of the
// shapes, ops/expert_ragged.py::dw_split_rows): a piece that is its expert's only one writes
// dW[e] itself, the others their fp32 partial tiles to a workspace, and a second grid adds each
// such expert's pieces in chunk order and casts once. Bound by reading dy and x: 0.075 ms at
// (14336, 32) against 0.044; the reduce grid and the partials take 0.007 of it.
//
// Any other input (fp32, O or I off the 16-byte rows of the TMA maps) takes the scalar routes,
// ovla_expert_ragged_dx_scalar and ovla_expert_ragged_dw_scalar (fp32 FMAs), which the wrappers
// count apart.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace ovla_erb {

namespace hp = ovla_hp;
using bf16 = __nv_bfloat16;

constexpr int kMaxE = 1024;
constexpr int kBM = 128;                      // dx: rows a tile; dW: channels of P a tile
constexpr int kBK = 64;                       // contraction a stage
constexpr int kStages = 6;
constexpr int kBufs = 3;                      // int8 dx: widened code tiles
constexpr int kPromote = 2;                   // stages a chunk in fresh accumulators (128 deep)
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;    // + a producer warpgroup (setmaxnreg)
constexpr int kWideners = 96;                 // int8 dx: producer warps 1..3
constexpr int kBox = 64 * 128;                // a TMA box [64][64] bf16 (or [64][128] codes)
constexpr int kDyBytes = kBM * kBK * 2;       // dx: dy [128 rows][64 o], 16 KB
constexpr int kBTile = kBK * 128 * 2;         // a widened code tile [64 o][128 i] fp16, 16 KB
constexpr int kWorkInts = 2 * kMaxE + 3;      // the work list: item_start [E + 2], row_start [E + 1]

// two int8 codes (byte sel & 0xF and (sel >> 8) & 0xF of w: 0x5140 the low pair, 0x7362 the
// high pair) -> fp16x2, the first code in the low half; exact: (c ^ 0x80) | 0x6400 read as fp16 is
// 1024 + (c + 128), and one fp16x2 subtraction of 1152 gives c (fp16 steps by 1 in [1024, 2048))
template <uint32_t SEL>
__device__ __forceinline__ uint32_t widen2h(uint32_t w) {
  const uint32_t a = __byte_perm(w ^ 0x80808080u, 0x64646464u, SEL);   // [c0 ^ 0x80, 0x64, ..]
  __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&a), __floats2half2_rn(1152.f, 1152.f));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t as_u32(__half2 v) { return *reinterpret_cast<uint32_t*>(&v); }

__device__ __forceinline__ long long warp_scan(long long v, int lane) {   // inclusive
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// d (+)= A · B for a 64-row warpgroup tile of BN columns, both operands in shared memory
template <int BN, int kTA, int kTB>
__device__ __forceinline__ void mma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                       int scale_d) {
  if constexpr (BN == 128) hp::wgmma_bf16_ss_m64n128k16<kTA, kTB>(d, da, db, scale_d);
  else hp::wgmma_bf16_ss_m64n64k16<kTA, kTB>(d, da, db, scale_d);
}

// ---------------------------------------------------------------------------
// dx: the work list (expert_ragged.cu's plan / work_at, with chunks of the contraction)

struct Work {
  int e;       // expert, or -1: rows past the groups' sum (zeros)
  int row0;    // first row
  int rows;    // rows of the tile
  int n0;      // first column of I
  int chunk;   // chunk of the contraction
};

// Warp 0: every expert's first row (row_start, clamped to M) and first item (item_start:
// ceil(rows / kBM) row tiles x `per` (column tile, chunk) pairs an expert), then the zero tiles
// of the rows past the sum, `zero_per` a row tile, up to item_start[E + 1]
__device__ void plan(const int* __restrict__ gs, int E, int M, int per, int zero_per,
                     int* item_start, int* row_start) {
  const int lane = threadIdx.x & 31;
  long long rows = 0, items = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const long long g = e < E ? max(gs[e], 0) : 0;
    const long long p = rows + warp_scan(g, lane);
    const int begin = int(min(p - g, (long long)M)), end = int(min(p, (long long)M));
    const long long n = (long long)((end - begin + kBM - 1) / kBM) * per;
    const long long ip = items + warp_scan(n, lane);
    if (e < E) row_start[e] = begin, item_start[e] = int(ip - n);
    rows = __shfl_sync(0xFFFFFFFFu, p, 31);
    items = __shfl_sync(0xFFFFFFFFu, ip, 31);
  }
  if (lane == 0) {
    const int S = int(min(rows, (long long)M));
    row_start[E] = S;
    item_start[E] = int(items);
    item_start[E + 1] = int(items) + (M - S + kBM - 1) / kBM * zero_per;
  }
}

// item i: the last e in [0, E] with item_start[e] <= i (e = E: a zero tile); within it the row
// tiles fastest, then the column tiles, then the chunks
__device__ __forceinline__ Work work_at(int i, const int* item_start, const int* row_start, int E,
                                        int M, int NT, int BN) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (item_start[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  const int begin = row_start[lo], end = lo < E ? row_start[lo + 1] : M;
  const int mtiles = (end - begin + kBM - 1) / kBM, j = i - item_start[lo];
  const int row0 = begin + (j % mtiles) * kBM, pair = j / mtiles;
  return Work{lo < E ? lo : -1, row0, min(kBM, end - row0), (pair % NT) * BN, pair / NT};
}

template <bool kInt8, int BN>
struct Dx {
  static_assert(!kInt8 || BN == 128, "the codes' tile is 128 columns");
  static constexpr int kW = kInt8 ? kBK * BN : (BN / 64) * kBox;   // codes, or bf16 boxes
  static constexpr int kStage = (kDyBytes + kW + (kInt8 ? kBK * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int kRing = kInt8 || BN == 64 ? kStages : kStages - 1;   // fits the staging
  static constexpr int kBufBytes = kInt8 ? kBufs * kBTile : 0;
  // bf16: the epilogue's staging, [64 rows][BN + 8] bf16 a warpgroup (conflict-free fragment
  // writes), read back as 16-byte pieces of whole output rows
  static constexpr int kPitch = BN * 2 + 16;
  static constexpr int kStgBytes = kInt8 ? 0 : 2 * 64 * kPitch;
  static constexpr int kBars = 2 * kRing + (kInt8 ? 2 * kBufs : 0);
  // + 1024: the base is rounded up to the 1024 bytes the 128-byte swizzle needs
  static constexpr size_t kSmem =
      1024 + size_t(kRing) * kStage + kBufBytes + kStgBytes + kBars * 8 + kWorkInts * 4;
  static constexpr int kAcc = BN / 2;
};

// The two fp16 terms of this thread's fragment of each k16 step of a stage, and the power of two
// of each of its rows (rl, rl + 8): dy [128 rows][64 o] bf16 at dys (128-byte rows, 16-byte chunk
// c of row r at c ^ (r % 8)), the stage's scales at ss (past O: 0, so the next expert's codes add
// nothing). v = fp32(dy · s) (__fmul_rn: never contracted); the row's largest |v| over the
// stage's 64 o (four threads a row: two shuffles) sets k with max |v| · 2^k in [2^14, 2^15), so
// no term overflows fp16 and the row's large values keep 11 + 11 bits; v' = v · 2^k (exact), hi
// = fp16(v'), lo = fp16(v' - hi) (the difference exact in fp32): hi + lo is within 2^-22 · |v'|
// of v'. inv = 2^-k undoes it when the stage's sums are added to the running ones
__device__ __forceinline__ void build_terms(uint32_t (&a)[4][2][4], float (&inv)[2],
                                            const bf16* dys, const float* ss, int o_left, int rl,
                                            int t4) {
  float2 v[4][4];
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rl + 8 * (i & 1), n = kk * 16 + 2 * t4 + 8 * (i >> 1);
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          dys + r * 64 + ((((n >> 3) ^ r) & 7) << 3) + (n & 7)));
      const float2 sv = n < o_left ? *reinterpret_cast<const float2*>(ss + n)
                                   : make_float2(0.f, 0.f);
      v[kk][i] = make_float2(__fmul_rn(d.x, sv.x), __fmul_rn(d.y, sv.y));
      mx[i & 1] = fmaxf(mx[i & 1], fmaxf(fabsf(v[kk][i].x), fabsf(v[kk][i].y)));
    }
  float sc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xFFFFFFFFu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xFFFFFFFFu, mx[h], 2));
    // max |v| in [2^(e - 127), 2^(e - 126)): k = 141 - e (e >= 15 keeps 2^-k a normal float)
    const uint32_t e = max((__float_as_uint(mx[h]) >> 23) & 0xFFu, 15u);
    sc[h] = __uint_as_float((268u - e) << 23);
    inv[h] = __uint_as_float((e - 14u) << 23);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = __fmul_rn(v[kk][i].x, sc[i & 1]), x1 = __fmul_rn(v[kk][i].y, sc[i & 1]);
      const __half2 hi = __floats2half2_rn(x0, x1);
      const float2 fh = __half22float2(hi);
      a[kk][0][i] = as_u32(hi);
      a[kk][1][i] = as_u32(__floats2half2_rn(__fsub_rn(x0, fh.x), __fsub_rn(x1, fh.y)));
    }
}

// S chunks of KC stages each; S > 1: each chunk's fp32 partials to ws [S][M][I] (no zero tiles)
template <bool kInt8, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    expert_ragged_dx_kernel(const __grid_constant__ CUtensorMap tm_dy,
                            const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ s,
                            const int* __restrict__ gs, bf16* __restrict__ dx,
                            float* __restrict__ ws, int M, int O, int I, int E, int S, int KC) {
  using L = Dx<kInt8, BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bbuf = ring + L::kRing * L::kStage;
  uint8_t* stg = bbuf + L::kBufBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stg + L::kStgBytes);
  uint64_t* empty = full + L::kRing;
  uint64_t* bfull = empty + L::kRing;   // int8: a widened tile written
  uint64_t* bempty = bfull + kBufs;    // int8: a widened tile read by both warpgroups
  int* item_start = reinterpret_cast<int*>(full + L::kBars);
  int* row_start = item_start + kMaxE + 2;
  const int NT = (I + BN - 1) / BN, KT = (O + kBK - 1) / kBK;
  const bool split = S > 1;
  const int tid = threadIdx.x;

  if (tid < 32) plan(gs, E, M, NT * S, split ? 0 : NT, item_start, row_start);
  if (tid == 32) {
    for (int i = 0; i < L::kRing; ++i) {
      hp::mbar_init(full + i, 1);    // the producer's arrival, then the stage's bytes
      hp::mbar_init(empty + i, 2);   // one thread of each consumer warpgroup
    }
    if constexpr (kInt8)
      for (int i = 0; i < kBufs; ++i) {
        hp::mbar_init(bfull + i, kWideners);
        hp::mbar_init(bempty + i, 2);
      }
    hp::mbar_init_fence();
  }
  __syncthreads();
  const int items = item_start[E + 1];

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - kConsumers;
    if (pt == 0) {
      // ---- one thread keeps the ring full across the CTA's items ----
      int c = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Work wk = work_at(i, item_start, row_start, E, M, NT, BN);
        if (wk.e < 0) continue;
        const int k0 = wk.chunk * KC, k1 = min(KT, k0 + KC), wrow = wk.e * O;
        for (int kc = k0; kc < k1; ++kc, ++c) {
          const int slot = c % L::kRing;
          hp::mbar_wait(empty + slot, ((c / L::kRing) & 1) ^ 1);   // the first round passes
          uint8_t* st = ring + slot * L::kStage;
          if constexpr (kInt8) {
            const int sb = min(kBK, O - kc * kBK) * 4;   // the scales left in the expert's O
            hp::mbar_expect_tx(full + slot, kDyBytes + L::kW + sb);
            hp::tma_load_2d(st, &tm_dy, kc * kBK, wk.row0, full + slot);
            hp::tma_load_2d(st + kDyBytes, &tm_w, wk.n0, wrow + kc * kBK, full + slot);
            hp::bulk_load(st + kDyBytes + L::kW, s + wrow + kc * kBK, sb, full + slot);
          } else {
            hp::mbar_expect_tx(full + slot, kDyBytes + L::kW);
            hp::tma_load_2d(st, &tm_dy, kc * kBK, wk.row0, full + slot);
#pragma unroll
            for (int h = 0; h < BN / 64; ++h)
              hp::tma_load_2d(st + kDyBytes + h * kBox, &tm_w, wk.n0 + 64 * h, wrow + kc * kBK,
                              full + slot);
          }
        }
      }
    } else if constexpr (kInt8) {
      // ---- three warps widen each stage's codes once into an fp16 tile both warpgroups read -
      if (pt < 32) return;
      const int wt = pt - 32;
      int c = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Work wk = work_at(i, item_start, row_start, E, M, NT, BN);
        if (wk.e < 0) continue;
        const int k0 = wk.chunk * KC, k1 = min(KT, k0 + KC);
        for (int kc = k0; kc < k1; ++kc, ++c) {
          const int slot = c % L::kRing, b = c % kBufs;
          hp::mbar_wait(full + slot, (c / L::kRing) & 1);
          hp::mbar_wait(bempty + b, ((c / kBufs) & 1) ^ 1);   // the first round passes
          const uint8_t* q = ring + slot * L::kStage + kDyBytes;
          uint8_t* bt = bbuf + b * kBTile;
          // 16 codes (chunk ch of code row k, 128-byte swizzle) -> two core-matrix rows: column
          // blocks 2 ch and 2 ch + 1, row k % 8 of core matrix k / 8 along o
          for (int t = wt; t < kBK * 8; t += kWideners) {
            const int k = t % kBK, ch = t / kBK;
            const uint4 v = *reinterpret_cast<const uint4*>(q + k * 128 + ((ch ^ (k & 7)) << 4));
            uint8_t* d = bt + 2 * ch * 1024 + (k >> 3) * 128 + (k & 7) * 16;
            *reinterpret_cast<uint4*>(d) = make_uint4(widen2h<0x5140>(v.x), widen2h<0x7362>(v.x),
                                                      widen2h<0x5140>(v.y), widen2h<0x7362>(v.y));
            *reinterpret_cast<uint4*>(d + 1024) =
                make_uint4(widen2h<0x5140>(v.z), widen2h<0x7362>(v.z), widen2h<0x5140>(v.w),
                           widen2h<0x7362>(v.w));
          }
          hp::fence_proxy_async();
          hp::mbar_arrive(bfull + b);
        }
      }
    }
    return;
  }

  // ---- two consumer warpgroups: rows 64 wg .. 64 wg + 63 of the tile x BN columns ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int rl = wg * 64 + warp * 16 + g;   // this thread's fragment rows rl, rl + 8
  int c = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Work wk = work_at(i, item_start, row_start, E, M, NT, BN);
    if (wk.e < 0) {   // rows past the groups' sum: dx = 0
      for (int j = tid; j < wk.rows * (BN / 8); j += kConsumers) {
        const int col = wk.n0 + (j % (BN / 8)) * 8;
        if (col < I)
          *reinterpret_cast<uint4*>(dx + (long long)(wk.row0 + j / (BN / 8)) * I + col) =
              make_uint4(0, 0, 0, 0);
      }
      continue;
    }
    const int k0 = wk.chunk * KC, k1 = min(KT, k0 + KC);
    float acc[L::kAcc];
#pragma unroll
    for (int j = 0; j < L::kAcc; ++j) acc[j] = 0.f;
    float part[L::kAcc];
    for (int kc = k0; kc < k1; ++kc, ++c) {
      const int slot = c % L::kRing;
      hp::mbar_wait(full + slot, (c / L::kRing) & 1);
      const uint8_t* st = ring + slot * L::kStage;
      if constexpr (kInt8) {
        uint32_t a[4][2][4];
        float inv[2];
        build_terms(a, inv, reinterpret_cast<const bf16*>(st),
                    reinterpret_cast<const float*>(st + kDyBytes + L::kW), O - kc * kBK, rl, t4);
        const int b = c % kBufs;
        hp::mbar_wait(bfull + b, (c / kBufs) & 1);
        const uint8_t* bt = bbuf + b * kBTile;
        hp::fence_operands(part);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // k16 step kk: two core matrices along o
#pragma unroll
          for (int t = 0; t < 2; ++t)
            hp::wgmma_f16_rs_m64n128k16(part, a[kk][t], hp::desc_plain(bt + kk * 256, 128, 1024),
                                        kk + t > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_operands(part);
        if (wt == 0) {
          hp::mbar_arrive(empty + slot);
          hp::mbar_arrive(bempty + b);
        }
        // the stage's sums, times 2^-k of their row, into the running ones (accumulator j:
        // row rl where j % 4 < 2, else rl + 8)
#pragma unroll
        for (int j = 0; j < L::kAcc; ++j) acc[j] = fmaf(part[j], inv[(j >> 1) & 1], acc[j]);
      } else {
        const bool fresh = (kc - k0) % kPromote == 0;   // 128-deep chunks, promoted
        hp::fence_operands(part);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // 32 bytes along each dy row, 16 rows of the weights
          mma_ss<BN, 0, 1>(part, hp::desc_sw128(st + wg * 64 * 128 + kk * 32),
                           hp::desc_sw128_mn(st + kDyBytes + kk * 16 * 128, kBox),
                           !(fresh && kk == 0));
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_operands(part);
        if (wt == 0) hp::mbar_arrive(empty + slot);
        if ((kc - k0) % kPromote == kPromote - 1 || kc == k1 - 1) {
#pragma unroll
          for (int j = 0; j < L::kAcc; ++j) acc[j] += part[j];
        }
      }
    }

    // accumulator block j (columns 8 j .. 8 j + 7): rows rl (e < 2), rl + 8; columns
    // 8 j + 2 t4 + (e & 1)
    if constexpr (!kInt8) {
      if (!split) {   // through the staging: whole 16-byte pieces of each output row
        uint8_t* sw = stg + wg * 64 * L::kPitch;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(sw + (rl - wg * 64 + 8 * hr) * L::kPitch +
                                               (8 * j + 2 * t4) * 2) =
                __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
        hp::named_barrier(2 + wg, 128);
        for (int q = wt; q < 64 * (BN / 8); q += 128) {
          const int row = q / (BN / 8), col = wk.n0 + (q % (BN / 8)) * 8;
          if (wg * 64 + row < wk.rows && col < I)
            *reinterpret_cast<uint4*>(dx + (long long)(wk.row0 + wg * 64 + row) * I + col) =
                *reinterpret_cast<const uint4*>(sw + row * L::kPitch + (q % (BN / 8)) * 16);
        }
        hp::named_barrier(2 + wg, 128);   // the staging is free for the next tile
        continue;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rl + 8 * hr;
      if (r >= wk.rows) continue;
      const long long row = wk.row0 + r;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = wk.n0 + 8 * j + 2 * t4;
        if (col >= I) continue;
        if (split)
          *reinterpret_cast<float2*>(ws + ((long long)wk.chunk * M + row) * I + col) =
              make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(dx + row * I + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      }
    }
  }
}

// The split's second grid: dx[m][i..i+3] = the sum of the S chunks' fp32 partials, in chunk
// order, cast once; rows past the groups' sum 0
__global__ void __launch_bounds__(256)
    expert_ragged_dx_reduce(const float* __restrict__ part, const int* __restrict__ gs,
                            bf16* __restrict__ dx, int M, int I, int E, int S) {
  __shared__ int total;
  if (threadIdx.x < 32) {   // the groups' sum, clamped to M
    long long t = 0;
    for (int e = threadIdx.x; e < E; e += 32) t += max(gs[e], 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xFFFFFFFFu, t, o);
    if (threadIdx.x == 0) total = int(min(t, (long long)M));
  }
  __syncthreads();
  const long long per = (long long)M * I;
  for (long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4; idx < per;
       idx += (long long)gridDim.x * blockDim.x * 4) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (idx / I < total)
      for (int c = 0; c < S; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(part + c * per + idx);
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dx + idx);
    o[0] = __floats2bfloat162_rn(sum.x, sum.y);
    o[1] = __floats2bfloat162_rn(sum.z, sum.w);
  }
}

// ---------------------------------------------------------------------------
// dW: pieces (expert, chunk of `rows` rows) of the contraction

struct Piece {
  int e;       // expert, or -1: no piece
  int r0;      // first row
  int r1;      // one past the last row
  int whole;   // the expert's only piece: its sum is dW[e] itself
};

// Piece j: direct (rows >= M): expert j's whole group (possibly empty); split: the j-th
// non-empty intersection, in row order, of an expert's rows with a chunk [c·rows, (c+1)·rows)
__device__ Piece piece_at(const int* __restrict__ gs, int E, int M, int rows, int j) {
  long long start = 0;
  for (int e = 0; e < E; ++e) {
    const long long n = max(gs[e], 0);
    const long long b = min(start, (long long)M), end = min(start + n, (long long)M);
    start += n;
    if (rows >= M) {
      if (e == j) return Piece{e, int(b), int(end), 1};
      continue;
    }
    const long long cnt = end > b ? (end - 1) / rows - b / rows + 1 : 0;
    if (j < cnt) {
      const long long c = b / rows + j;
      return Piece{e, int(max(b, c * rows)), int(min(end, (c + 1) * rows)), int(cnt == 1)};
    }
    j -= int(cnt);
  }
  return Piece{-1, 0, 0, 0};
}

template <int BN>
struct Dw {
  static constexpr int kStage = 2 * kBox + (BN / 64) * kBox;   // P (a box a warpgroup), Q
  static constexpr size_t kSmem = 1024 + size_t(kStages) * kStage + 2 * kStages * 8;
  static constexpr int kAcc = BN / 2;
};

// dw [E, O, I] bf16: each expert's sum where it is one piece (direct: always); ws: the other
// pieces' fp32 partials [pieces][O][I] (split). P [M, Ad] is the operand of 128-channel tiles,
// Q [M, Bd] the other; trans = 0: P = dy (Ad = O), the tile stored as [o = a][i = b]; trans = 1:
// P = x (Ad = I), stored as [o = b][i = a]
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    expert_ragged_dw_kernel(const __grid_constant__ CUtensorMap tm_p,
                            const __grid_constant__ CUtensorMap tm_q,
                            const int* __restrict__ gs, bf16* __restrict__ dw,
                            float* __restrict__ ws, int M, int O, int I, int E, int rows,
                            int trans) {
  using L = Dw<BN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::kStage);
  uint64_t* empty = full + kStages;
  const int Ad = trans ? I : O, Bd = trans ? O : I;
  const int BT = (Bd + BN - 1) / BN, tiles = (Ad + kBM - 1) / kBM * BT;
  const bool split = rows < M;
  const int items = (split ? (M + rows - 1) / rows + E : E) * tiles;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hp::mbar_init(full + i, 1);
      hp::mbar_init(empty + i, 2);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      int c = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Piece pc = piece_at(gs, E, M, rows, i / tiles);
        const int t = i % tiles, a0 = t / BT * kBM, b0 = t % BT * BN;
        for (int r = pc.r0; r < pc.r1; r += kBK, ++c) {   // none where pc.e < 0
          const int slot = c % kStages;
          hp::mbar_wait(empty + slot, ((c / kStages) & 1) ^ 1);
          uint8_t* st = ring + slot * L::kStage;
          hp::mbar_expect_tx(full + slot, L::kStage);
          hp::tma_load_2d(st, &tm_p, a0, r, full + slot);
          hp::tma_load_2d(st + kBox, &tm_p, a0 + 64, r, full + slot);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            hp::tma_load_2d(st + (2 + h) * kBox, &tm_q, b0 + 64 * h, r, full + slot);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int rl = wg * 64 + warp * 16 + g;   // this thread's fragment channels rl, rl + 8
  int c = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Piece pc = piece_at(gs, E, M, rows, i / tiles);
    if (pc.e < 0) continue;
    const int t = i % tiles, a0 = t / BT * kBM, b0 = t % BT * BN;
    const bool part_out = !pc.whole;   // to the workspace, for the reduce grid
    const long long base = (long long)(part_out ? i / tiles : pc.e) * O * I;
    if (pc.r1 <= pc.r0) {   // an expert with no rows (direct): dW = 0
      for (int j = tid; j < kBM * BN; j += kConsumers) {
        const int a = a0 + j / BN, b = b0 + j % BN;
        if (a < Ad && b < Bd)
          dw[base + (trans ? (long long)b * I + a : (long long)a * I + b)] = __float2bfloat16(0.f);
      }
      continue;
    }
    float acc[L::kAcc];
#pragma unroll
    for (int j = 0; j < L::kAcc; ++j) acc[j] = 0.f;
    float part[L::kAcc];
    int kc = 0;
    for (int r = pc.r0; r < pc.r1; r += kBK, ++kc, ++c) {
      const int slot = c % kStages;
      hp::mbar_wait(full + slot, (c / kStages) & 1);
      uint8_t* st = ring + slot * L::kStage;
      uint8_t* ps = st + wg * kBox;   // this warpgroup's 64 channels of P
      const int valid = pc.r1 - r;
      if (valid < kBK) {   // the rows past the piece (the next expert's, or chunk's) add 0
        for (int j = wt; j < (kBK - valid) * 8; j += 128)
          *reinterpret_cast<uint4*>(ps + (valid + j / 8) * 128 + (j % 8) * 16) =
              make_uint4(0, 0, 0, 0);
        hp::fence_proxy_async();
        hp::named_barrier(2 + wg, 128);
      }
      hp::fence_operands(part);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // k16 step kk: 16 rows of 128 bytes of each operand
        mma_ss<BN, 1, 1>(part, hp::desc_sw128_mn(ps + kk * 16 * 128, kBox),
                         hp::desc_sw128_mn(st + 2 * kBox + kk * 16 * 128, kBox),
                         !(kc % kPromote == 0 && kk == 0));
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_operands(part);
      if (wt == 0) hp::mbar_arrive(empty + slot);
      if (kc % kPromote == kPromote - 1 || r + kBK >= pc.r1) {
#pragma unroll
        for (int j = 0; j < L::kAcc; ++j) acc[j] += part[j];
      }
    }

    // accumulator block j: channels a0 + rl (e < 2), + 8 of P; b0 + 8 j + 2 t4 + (e & 1) of Q
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int a = a0 + rl + 8 * hr;
      if (a >= Ad) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int b = b0 + 8 * j + 2 * t4;
        if (b >= Bd) continue;
        const float v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
        if (!trans) {
          const long long at = base + (long long)a * I + b;
          if (part_out) *reinterpret_cast<float2*>(ws + at) = make_float2(v0, v1);
          else *reinterpret_cast<__nv_bfloat162*>(dw + at) = __floats2bfloat162_rn(v0, v1);
        } else {
          const long long at = base + (long long)b * I + a;
          if (part_out) {
            ws[at] = v0;
            ws[at + I] = v1;
          } else {
            dw[at] = __float2bfloat16(v0);
            dw[at + I] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

// The split's second grid: dW[e][o][i..i+3] = the sum over expert e's pieces, in chunk order, of
// their fp32 partials, cast once, where it has two or more (one: the piece wrote dW[e]); an
// expert with no piece 0
__global__ void __launch_bounds__(256)
    expert_ragged_dw_reduce(const float* __restrict__ part, const int* __restrict__ gs,
                            bf16* __restrict__ dw, int M, int O, int I, int E, int rows) {
  __shared__ int first[kMaxE + 1];   // each expert's first piece
  if (threadIdx.x < 32) {   // warp 0: the pieces an expert, scanned (piece_at's count)
    const int lane = threadIdx.x;
    long long start = 0, pieces = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + lane;
      const long long n = e < E ? max(gs[e], 0) : 0;
      const long long p = start + warp_scan(n, lane);
      const long long b = min(p - n, (long long)M), end = min(p, (long long)M);
      const long long cnt = end > b ? (end - 1) / rows - b / rows + 1 : 0;
      const long long q = pieces + warp_scan(cnt, lane);
      if (e < E) first[e] = int(q - cnt);
      start = __shfl_sync(0xFFFFFFFFu, p, 31);
      pieces = __shfl_sync(0xFFFFFFFFu, q, 31);
    }
    if (lane == 0) first[E] = int(pieces);
  }
  __syncthreads();
  const long long per = (long long)O * I;
  for (long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4; idx < per * E;
       idx += (long long)gridDim.x * blockDim.x * 4) {
    const int e = int(idx / per);
    if (first[e + 1] - first[e] == 1) continue;   // its one piece wrote dW[e]
    const long long within = idx - (long long)e * per;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = first[e]; p < first[e + 1]; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(part + (long long)p * per + within);
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dw + idx);
    o[0] = __floats2bfloat162_rn(sum.x, sum.y);
    o[1] = __floats2bfloat162_rn(sum.z, sum.w);
  }
}

// ---------------------------------------------------------------------------
// the scalar routes' tiles of dx: each expert's rows in tiles of `bm` from its first row, then
// the rows past the groups' sum; rows clamped to M

struct RowTile {
  int e;      // expert, or -1: rows past the groups' sum (zeros)
  int row0;   // first row
  int rows;   // rows of the tile (<= 0: no tile)
};

__device__ RowTile row_tile(const int* __restrict__ gs, int E, int M, int bm, int t) {
  long long start = 0;
  for (int e = 0; e < E; ++e) {
    const long long n = max(gs[e], 0);
    const long long te = (n + bm - 1) / bm;
    if (t < te) {
      const long long row0 = start + (long long)t * bm;
      const long long rows = min(min((long long)bm, n - (long long)t * bm), (long long)M - row0);
      return RowTile{e, int(min(row0, (long long)M)), int(rows)};
    }
    t -= int(te);
    start += n;
  }
  const long long row0 = min(start, (long long)M) + (long long)t * bm;
  return RowTile{-1, int(min(row0, (long long)M)), int(min((long long)bm, (long long)M - row0))};
}

// ---------------------------------------------------------------------------
// the scalar routes: fp32 FMAs, 16 x 16 outputs a block, one a thread

constexpr int kSTile = 16;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// dx: TX dy and output type; TW the weights' (TX, or int8 codes with scales)
template <typename TX, typename TW>
__global__ void __launch_bounds__(kSTile* kSTile)
    dx_scalar_kernel(const TX* __restrict__ dy, const TW* __restrict__ w,
                     const float* __restrict__ s, const int* __restrict__ gs, TX* __restrict__ dx,
                     int M, int O, int I, int E) {
  __shared__ float as[kSTile][kSTile + 1];
  __shared__ float wsh[kSTile][kSTile + 1];
  __shared__ RowTile tile;
  if (threadIdx.x == 0) tile = row_tile(gs, E, M, kSTile, blockIdx.x);
  __syncthreads();
  const RowTile tl = tile;
  if (tl.rows <= 0) return;
  const int tx = threadIdx.x % kSTile, ty = threadIdx.x / kSTile;
  const int n = blockIdx.y * kSTile + tx;
  if (tl.e < 0) {
    if (ty < tl.rows && n < I) dx[(long long)(tl.row0 + ty) * I + n] = from_f32<TX>(0.f);
    return;
  }
  const TW* we = w + (long long)tl.e * O * I;
  float acc = 0.f;
  for (int k0 = 0; k0 < O; k0 += kSTile) {
    const int k = k0 + tx;
    float a = 0.f;
    if (ty < tl.rows && k < O) {
      a = to_f32<TX>(dy[(long long)(tl.row0 + ty) * O + k]);
      if (s != nullptr) a *= s[(long long)tl.e * O + k];
    }
    as[ty][tx] = a;   // [row][k]
    wsh[ty][tx] = (k0 + ty < O && n < I) ? to_f32<TW>(we[(long long)(k0 + ty) * I + n]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSTile; ++kk) acc = fmaf(as[ty][kk], wsh[kk][tx], acc);
    __syncthreads();
  }
  if (ty < tl.rows && n < I) dx[(long long)(tl.row0 + ty) * I + n] = from_f32<TX>(acc);
}

// dW: output (o, i) of expert blockIdx.z, its rows summed in order
template <typename T>
__global__ void __launch_bounds__(kSTile* kSTile)
    dw_scalar_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const int* __restrict__ gs, T* __restrict__ dw, int M, int O, int I, int E) {
  __shared__ int range[2];
  const int e = blockIdx.z;
  if (threadIdx.x == 0) {
    long long start = 0;
    for (int j = 0; j < e; ++j) start += max(gs[j], 0);
    range[0] = int(min(start, (long long)M));
    range[1] = int(min(start + max(gs[e], 0), (long long)M));
  }
  __syncthreads();
  const int i = blockIdx.x * kSTile + threadIdx.x % kSTile;
  const int o = blockIdx.y * kSTile + threadIdx.x / kSTile;
  if (o >= O || i >= I) return;
  float acc = 0.f;
  for (int m = range[0]; m < range[1]; ++m)
    acc = fmaf(to_f32<T>(dy[(long long)m * O + o]), to_f32<T>(x[(long long)m * I + i]), acc);
  dw[((long long)e * O + o) * I + i] = from_f32<T>(acc);
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

template <bool kInt8, int BN>
int launch_dx(const void* dy, const void* w, const float* s, const int* gs, float* ws, void* dx,
              int M, int O, int I, int E, int splits, cudaStream_t st) {
  using L = Dx<kInt8, BN>;
  // a runtime call before the tensor maps: it makes the device's context current on this thread,
  // which the driver's encoder needs (autograd runs the backward on a thread of its own, where
  // nothing else may have touched the card yet)
  auto kernel = expert_ragged_dx_kernel<kInt8, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::kSmem));
  if (err != cudaSuccess) return int(err);
  CUtensorMap tm_dy, tm_w;
  if (!hp::encode_2d(&tm_dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dy, M, O, uint64_t(O) * 2, kBM, kBK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !(kInt8 ? hp::encode_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, uint64_t(E) * O, I, I, kBK,
                              128, CU_TENSOR_MAP_SWIZZLE_128B)
              : hp::encode_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, uint64_t(E) * O, I,
                              uint64_t(I) * 2, kBK, 64, CU_TENSOR_MAP_SWIZZLE_128B)))
    return int(cudaErrorInvalidValue);
  const int KT = (O + kBK - 1) / kBK, KC = (KT + splits - 1) / splits;
  const int S = (KT + KC - 1) / KC;   // chunks with stages (<= splits)
  const long long NT = (I + BN - 1) / BN;
  const long long most = ((M + kBM - 1) / kBM + (long long)E + 1) * NT * S;   // items, at most
  const dim3 grid(unsigned(most < hp::sm_count() ? most : hp::sm_count()));
  kernel<<<grid, kThreads, L::kSmem, st>>>(tm_dy, tm_w, s, gs, static_cast<bf16*>(dx), ws, M, O,
                                           I, E, S, KC);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return int(err);
  const long long quads = (long long)M * I / 4, blocks = (quads + 255) / 256;
  expert_ragged_dx_reduce<<<unsigned(blocks < 8 * hp::sm_count() ? blocks : 8 * hp::sm_count()),
                            256, 0, st>>>(
      ws, gs, static_cast<bf16*>(dx), M, I, E, S);
  return int(cudaGetLastError());
}

template <int BN>
int launch_dw(const void* dy, const void* x, const int* gs, void* ws, void* dw, int M, int O,
              int I, int E, int rows, cudaStream_t st) {
  const bool trans = O < I, split = rows < M;
  const int Ad = trans ? I : O, Bd = trans ? O : I;
  auto kernel = expert_ragged_dw_kernel<BN>;   // the runtime call first, as launch_dx's
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(Dw<BN>::kSmem));
  if (err != cudaSuccess) return int(err);
  CUtensorMap tm_p, tm_q;
  if (!hp::encode_2d(&tm_p, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, trans ? x : dy, M, Ad,
                     uint64_t(Ad) * 2, kBK, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, trans ? dy : x, M, Bd,
                     uint64_t(Bd) * 2, kBK, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  const long long tiles = (long long)((Ad + kBM - 1) / kBM) * ((Bd + BN - 1) / BN);
  const long long items = (split ? (M + rows - 1) / rows + E : E) * tiles;
  const dim3 grid(unsigned(items < hp::sm_count() ? items : hp::sm_count()));
  kernel<<<grid, kThreads, Dw<BN>::kSmem, st>>>(tm_p, tm_q, gs, static_cast<bf16*>(dw),
                                                static_cast<float*>(ws), M, O, I, E,
                                                split ? rows : M, int(trans));
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return int(err);
  const long long quads = (long long)E * O * I / 4, blocks = (quads + 255) / 256;
  expert_ragged_dw_reduce<<<unsigned(blocks < 8 * hp::sm_count() ? blocks : 8 * hp::sm_count()),
                            256, 0, st>>>(
      static_cast<const float*>(ws), gs, static_cast<bf16*>(dw), M, O, I, E, rows);
  return int(cudaGetLastError());
}

}  // namespace ovla_erb

// dx on the tensor cores: dy bf16 [M, O], w [E, O, I] bf16 (w_int8 = 0) or int8 codes with
// s fp32 [E, O] (w_int8 = 1), group_sizes int32 [E] on the device, dx bf16 [M, I]; all
// contiguous and 16-byte aligned, O a multiple of 8, I of 16 (codes) or 8 (bf16). tile_n: the
// columns of a tile, 128, or 64 for bf16 weights; splits > 1: the contraction cut into that many
// chunks across CTAs, their fp32 partials in ws [splits · M · I] (16-byte aligned), added by a
// second grid (ops/expert_ragged.py::dx_tiling picks both). Refuses anything else
// (cudaErrorInvalidValue). Returns the last launch's cudaError_t.
extern "C" int ovla_expert_ragged_dx(const void* dy, const void* w, const void* s,
                                     const void* group_sizes, void* ws, void* dx, int M, int O,
                                     int I, int E, int w_int8, int tile_n, int splits,
                                     void* stream) {
  namespace r = ovla_erb;
  const long long NT = (I + 63) / 64;
  if (M < 1 || O < 8 || O % 8 || I < 8 || I % (w_int8 ? 16 : 8) || E < 1 || E > r::kMaxE ||
      (long long)E * O > 2147483647LL || (tile_n != 128 && (w_int8 || tile_n != 64)) ||
      splits < 1 || (splits > 1 && (ws == nullptr || r::misaligned(ws))) ||
      ((M + r::kBM - 1) / r::kBM + (long long)E + 1) * NT * splits > 2147483647LL ||
      (long long)splits * M * I > (1LL << 40) || r::misaligned(dy) || r::misaligned(w) ||
      r::misaligned(dx) || (w_int8 && (s == nullptr || r::misaligned(s))))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sf = static_cast<const float*>(s);
  const auto* gi = static_cast<const int*>(group_sizes);
  auto* wf = static_cast<float*>(ws);
  if (w_int8) return r::launch_dx<true, 128>(dy, w, sf, gi, wf, dx, M, O, I, E, splits, st);
  return tile_n == 64 ? r::launch_dx<false, 64>(dy, w, sf, gi, wf, dx, M, O, I, E, splits, st)
                      : r::launch_dx<false, 128>(dy, w, sf, gi, wf, dx, M, O, I, E, splits, st);
}

// The depth of a stage of the contraction (ops/expert_ragged.py::DX_STAGE mirrors it).
extern "C" int ovla_expert_ragged_bwd_stage() { return ovla_erb::kBK; }

// dW on the tensor cores: dy bf16 [M, O], x bf16 [M, I], group_sizes int32 [E], dw bf16
// [E, O, I]; O and I multiples of 8, all 16-byte aligned. The tile: 128 channels of the wider
// of dy (O >= I) and x (O < I: dW's transpose computed, stored transposed) x 64 of the other
// where it is <= 64, else 128 (ops/expert_ragged.py::dw_tiling mirrors it). rows >= M: one grid
// writes dW; rows < M (a multiple of 64): the pieces' fp32 partials into ws,
// [(ceil(M / rows) + E) · O · I] floats, then the reduce grid. Returns the last launch's
// cudaError_t.
extern "C" int ovla_expert_ragged_dw(const void* dy, const void* x, const void* group_sizes,
                                     void* ws, void* dw, int M, int O, int I, int E, int rows,
                                     void* stream) {
  namespace r = ovla_erb;
  const bool split = rows < M;
  const long long narrow = O < I ? O : I, wide = O < I ? I : O;
  const long long tiles = (wide + r::kBM - 1) / r::kBM * ((narrow + 63) / 64);
  const long long pieces = split ? (M + rows - 1) / rows + E : E;
  if (M < 1 || O < 8 || O % 8 || I < 8 || I % 8 || E < 1 || E > r::kMaxE || rows < 1 ||
      (split && (rows % r::kBK || ws == nullptr || r::misaligned(ws))) ||
      pieces * tiles > 2147483647LL || (long long)E * O * I > (1LL << 40) ||
      r::misaligned(dy) || r::misaligned(x) || r::misaligned(dw))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gi = static_cast<const int*>(group_sizes);
  return narrow <= 64 ? r::launch_dw<64>(dy, x, gi, ws, dw, M, O, I, E, rows, st)
                      : r::launch_dw<128>(dy, x, gi, ws, dw, M, O, I, E, rows, st);
}

// The scalar routes: dy fp32 (bf16 = 0) or bf16 [M, O]; w [E, O, I] of dy's type (w_int8 = 0,
// s null) or int8 codes with s fp32 [E, O]; dx of dy's type [M, I]; any M, O, I >= 1.
extern "C" int ovla_expert_ragged_dx_scalar(const void* dy, const void* w, const void* s,
                                            const void* group_sizes, void* dx, int M, int O,
                                            int I, int E, int bf16_, int w_int8, void* stream) {
  namespace r = ovla_erb;
  if (M < 1 || O < 1 || I < 1 || E < 1 || E > r::kMaxE || (I + r::kSTile - 1) / r::kSTile > 65535 ||
      (w_int8 != 0) != (s != nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + r::kSTile - 1) / r::kSTile + E + 1, (I + r::kSTile - 1) / r::kSTile);
  const auto* sf = static_cast<const float*>(s);
  const auto* gi = static_cast<const int*>(group_sizes);
  if (bf16_) {
    using T = r::bf16;
    if (w_int8)
      r::dx_scalar_kernel<T, int8_t><<<grid, r::kSTile * r::kSTile, 0, st>>>(
          static_cast<const T*>(dy), static_cast<const int8_t*>(w), sf, gi, static_cast<T*>(dx),
          M, O, I, E);
    else
      r::dx_scalar_kernel<T, T><<<grid, r::kSTile * r::kSTile, 0, st>>>(
          static_cast<const T*>(dy), static_cast<const T*>(w), sf, gi, static_cast<T*>(dx), M, O,
          I, E);
  } else {
    if (w_int8)
      r::dx_scalar_kernel<float, int8_t><<<grid, r::kSTile * r::kSTile, 0, st>>>(
          static_cast<const float*>(dy), static_cast<const int8_t*>(w), sf, gi,
          static_cast<float*>(dx), M, O, I, E);
    else
      r::dx_scalar_kernel<float, float><<<grid, r::kSTile * r::kSTile, 0, st>>>(
          static_cast<const float*>(dy), static_cast<const float*>(w), sf, gi,
          static_cast<float*>(dx), M, O, I, E);
  }
  return int(cudaGetLastError());
}

// dy [M, O] and x [M, I] fp32 (bf16 = 0) or bf16, dw [E, O, I] of their type; any M, O, I >= 1.
extern "C" int ovla_expert_ragged_dw_scalar(const void* dy, const void* x,
                                            const void* group_sizes, void* dw, int M, int O,
                                            int I, int E, int bf16_, void* stream) {
  namespace r = ovla_erb;
  if (M < 1 || O < 1 || I < 1 || E < 1 || E > 65535 || (O + r::kSTile - 1) / r::kSTile > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((I + r::kSTile - 1) / r::kSTile, (O + r::kSTile - 1) / r::kSTile, E);
  const auto* gi = static_cast<const int*>(group_sizes);
  if (bf16_)
    r::dw_scalar_kernel<r::bf16><<<grid, r::kSTile * r::kSTile, 0, st>>>(
        static_cast<const r::bf16*>(dy), static_cast<const r::bf16*>(x), gi,
        static_cast<r::bf16*>(dw), M, O, I, E);
  else
    r::dw_scalar_kernel<float><<<grid, r::kSTile * r::kSTile, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x), gi, static_cast<float*>(dw),
        M, O, I, E);
  return int(cudaGetLastError());
}
