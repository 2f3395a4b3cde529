// The split-K decode route of the int8 GEMMs at decode M, shared by w8a8_matmul.cu (M <= 64,
// int8 weights, nibble planes or grouped int4 codes requantized in registers), vit_mlp.cu
// (M <= 64, through int8_wgmma.cuh's run_int8) and nib_hi_dot.cu (the hi plane alone): out[m, n] =
// epi(Σ_k x8[m, k] · w8[n, k], m, n), the exact int32 sum, then the caller's fp32 epilogue.
//
// Bound on the H100 at the OpenVLA-7B decode shapes (M = 24): the weight stream, 16.8 MB of
// int8 codes for 4096 x 4096 (5.0 us at 3.35 TB/s), 8.4 MB of the hi plane alone (2.5 us).
// The earlier mma.sync kernels walked all of K in each 32 x 32 block, one barrier a chunk,
// a few KB of weights in flight a block: latency-bound at 5-11x the bound.
//
// Design (wi8_matmul.cu's decode route, on int8 codes). A block owns kBN = 32 weight
// columns and kBM = 32 rows of activation codes (M <= 32 a row block; rows past M are
// zero-filled by TMA and never stored) over all of K. 8 consumer warps take the 128-deep k
// chunks in turn (chunk c to warp c % 8), each from two stages of its own (16 stages: 128 KB of
// int8 weights and codes in flight a block, 96 KB for the hi plane), which one producer thread
// fills in chunk order with TMA: the activation codes [32 rows][128 bytes] (128-byte swizzle)
// and the weights, int8 [32 n][128 bytes] (128-byte swizzle), each packed plane
// [32 n][64 bytes] (64-byte swizzle: conflict-free ldmatrix rows), or grouped int4 codes from a
// 3-D map [G][N][gsz / 2]: one box [32 n][64 bytes] a chunk as a plane where gsz is a multiple of
// 128, else four boxes [32 n][16 bytes] (one 32-deep k step of one group each). A warp waits
// only on its own stages, so no wait runs a whole mbarrier phase ahead of its chunk. Products
// on mma.sync m16n8k32 s8 x s8 -> s32, A the activation codes by ldmatrix, B the weights: int8
// codes by ldmatrix in their natural k order, or packed codes (ldmatrix hands each thread 8
// consecutive codes of one channel) widened (the hi plane), rebuilt from both planes, or
// requantized by the column's table (int4: s8 of the block's 32 columns made once into shared
// memory, which the epilogue takes in place of s) into int8 in registers; a fragment takes
// those 8 codes at k 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3, so for packed weights the
// pre-pass stores each 32-code block of activation codes in the matching order (int8_mma.cuh
// stored_offset). At the end each warp's
// int32 partial sums go to shared memory (the ring, consumed), every output is their sum over
// the 8 warps (an integer sum: no order changes a bit), then the epilogue and one store.
// How the activation codes reach a block: every block loads its own copy of each chunk's
// codes through TMA from L2 (the pre-pass has just written them): at 24 x 4096 x 4096,
// 128 blocks read 12.6 MB of codes from L2 beside 8.4 MB of hi plane (16.8 MB of int8 codes)
// from device memory. A knock-out build with no code loads was 0.1-0.9 us faster of 13-17
// (tools/kernel_ab.py on an H100 80GB HBM3 at 700 W; PERF.md §6), so the codes stay a
// per-block load.
// What bounds it: not the bytes. A build with no loads and no products takes 8.8 us of the
// 12.9 at 24 x 4096 x 4096 on the fused norm's codes (launch, set-up, the stages' handoffs,
// the fold), the weight stream the other 4. Launching it as the pre-pass's programmatic
// dependent (PDL, the first round's weights sent before the codes) measured 4 % slower in two
// timings and 5 % faster in a third: not kept.
#pragma once

#include "hopper.cuh"
#include "int8_mma.cuh"

namespace ovla_i8d {

namespace hp = ovla_hp;
using ovla_i8::ldmatrix_x4;
using ovla_i8::mma_s8_16832;

// what a stage's weight tile holds: int8 codes, the two nibble planes, the hi plane alone, or
// grouped int4 codes requantized to int8 per row in registers (the int4 requant route)
enum class W { kInt8, kNibble, kHi, kInt4 };

// W::kInt4's operands beside its tensor map: the group scales s fp32 [N][G] and the group size
// (a multiple of 32: each 32-deep k step lies in one group)
struct Groups {
  const float* s = nullptr;
  int G = 0, gsz = 0;
};

constexpr int kBM = 32;                    // rows of activation codes per block
constexpr int kBN = 32;                    // weight columns per block
constexpr int kChunk = 128;                // k per stage
constexpr int kWarps = 8;                  // consumer warps, chunk c to warp c % 8
constexpr int kSlots = 2;                  // stages of each warp's own
constexpr int kStages = kWarps * kSlots;
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;
constexpr int kABytes = kBM * kChunk;      // activation codes of a stage, 4 KB
constexpr int kPlane = kBN * kChunk / 2;   // one packed plane of a stage, 2 KB
constexpr int kPitch = kBN + 8;            // partial sums' row pitch (ints)

// a multiple of 1024: every tile stays swizzle-aligned
template <W kW>
__host__ __device__ constexpr int stage_bytes() {
  return kABytes + (kW == W::kHi || kW == W::kInt4 ? kPlane : 2 * kPlane);
}
// + 1024: the base rounded up for the 128-byte swizzle
template <W kW>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + size_t(kStages) * stage_bytes<kW>() + 2 * kStages * 8;
}
static_assert(kWarps * kBM * kPitch * 4 <= kStages * stage_bytes<W::kHi>(), "partials fit");

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The epilogues, each product rounded once (the _rn intrinsics keep nvcc from contracting)
struct EpiW8 {   // w8a8: (f32(acc) · s_x) · s; int8_wgmma.cuh's functor interface, stored direct
  static constexpr bool kStaged = false;
  struct Col {
    float s = 0.f;
  };
  const float* sx;
  const float* s;
  // read-only loads (ld.global.nc): the compiler may hoist them past the output stores
  __device__ __forceinline__ Col col(int n) const { return {__ldg(s + n)}; }
  __device__ __forceinline__ float row(int m) const { return __ldg(sx + m); }
  __device__ __forceinline__ float head(int acc, float sxm, const Col& c) const {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), sxm), c.s);
  }
  __device__ __forceinline__ float tail(float y, long long) const { return y; }
  __device__ __forceinline__ float operator()(int acc, int m, int n) const {
    return head(acc, row(m), col(n));
  }
};
struct EpiHi {   // nib_hi_dot: ((f32(acc) · 16 + f32(rowsum) · 7.5) · s_x) · s
  const float* sx;
  const float* s;
  const int* rowsum;
  __device__ __forceinline__ float operator()(int acc, int m, int n) const {
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), 16.f),
                              __fmul_rn(__int2float_rn(rowsum[m]), 7.5f));
    return __fmul_rn(__fmul_rn(v, sx[m]), s[n]);
  }
};

// the int4 form is held to 113 registers so that two blocks share an SM (as the hi plane's do):
// it then spills 136 bytes, and still ran lm_head's decode shape 1.45x faster than at one block
// an SM with no spill (PERF.md §6)
template <W kW, typename T, typename Epi>
__global__ void __launch_bounds__(kThreads, kW == W::kInt4 ? 2 : 1)
    decode_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_lo, const Epi epi, T* __restrict__ out,
                  int M, int N, int K, const Groups grp) {
  constexpr int kStage = stage_bytes<kW>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ float s8s[kBN];   // W::kInt4: the block's weight rows' s8 (0 past N)
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int KC = (K + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hp::mbar_init(full + i, 1);
      hp::mbar_init(empty + i, 1);   // lane 0 of the warp that owns the stage
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      for (int c = 0; c < KC; ++c) {   // chunk c: warp c % 8, its stage (c / 8) % 2
        const int r = c / kWarps, slot = (c % kWarps) * kSlots + r % kSlots;
        hp::mbar_wait(empty + slot, ((r / kSlots) & 1) ^ 1);   // the first round passes
        uint8_t* st = ring + slot * kStage;
        if constexpr (kW == W::kInt4) {
          // gsz a multiple of 128: the chunk in one box [32 n][64 bytes] (64-byte swizzle);
          // else its 32-deep k steps, one box [32 n][16 bytes] of one group each, at
          // st + kABytes + 512 kk, a step past K not loaded (its codes map to 0)
          const int steps = grp.gsz % kChunk == 0 ? 1 : min(4, (K - c * kChunk) / 32);
          const int box = grp.gsz % kChunk == 0 ? kPlane : kBN * 16;
          hp::mbar_expect_tx(full + slot, kABytes + steps * box);
          hp::tma_load_2d(st, &tm_a, c * kChunk, m0, full + slot);
          for (int kk = 0; kk < steps; ++kk) {
            const int k = c * kChunk + 32 * kk;
            hp::tma_load_3d(st + kABytes + kk * box, &tm_q, (k % grp.gsz) / 2, n0, k / grp.gsz,
                            full + slot);
          }
          continue;
        }
        hp::mbar_expect_tx(full + slot, kStage);
        hp::tma_load_2d(st, &tm_a, c * kChunk, m0, full + slot);
        if constexpr (kW == W::kInt8) {
          hp::tma_load_2d(st + kABytes, &tm_q, c * kChunk, n0, full + slot);
        } else {
          hp::tma_load_2d(st + kABytes, &tm_q, c * (kChunk / 2), n0, full + slot);
          if constexpr (kW == W::kNibble)
            hp::tma_load_2d(st + kABytes + kPlane, &tm_lo, c * (kChunk / 2), n0, full + slot);
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32, g8 = lane >> 2, t4 = lane & 3;
  int acc[2][4][4];   // m16 tiles 0, 1 x n8 tiles 0..3
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

  // W::kInt4: the scale s[n, g] of this lane's column j * 8 + g8 of n8 tile j in the group
  // holding k (0 past N and past K), and the requant r from it
  auto group_s = [&](int j, int k) {
    const int n = n0 + j * 8 + g8, g = k / grp.gsz;
    return n < N && g < grp.G ? __ldg(grp.s + (long long)n * grp.G + g) : 0.f;
  };
  auto group_r = [&](int j, float sv) { return ovla_i8::requant_r(sv, s8s[j * 8 + g8]); };
  // one group a chunk (gsz a multiple of 128): each chunk's scales loaded a chunk of this warp
  // ahead, so no load latency stands between the stage's arrival and its products
  const bool one_group = kW == W::kInt4 && grp.gsz % kChunk == 0;
  float snext[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (kW == W::kInt4) {
    if (one_group)
#pragma unroll
      for (int j = 0; j < 4; ++j) snext[j] = group_s(j, warp * kChunk);
    // s8 of weight row n0 + tid / 8: 8 lanes take its G scales in turn (a max: any order); the
    // consumers alone, so the producer's first loads are not held back
    const int n = n0 + tid / 8;
    float mx = __int_as_float(0xff800000u);   // -inf
    if (n < N)
      for (int g = tid % 8; g < grp.G; g += 8)
        mx = fmaxf(mx, __ldg(grp.s + (long long)n * grp.G + g));
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    if (tid % 8 == 0) s8s[tid / 8] = n < N ? __fmul_rn(mx, ovla_i8::kReqS8) : 0.f;
    hp::named_barrier(2, kConsumers);
  }
  for (int r = 0; warp + kWarps * r < KC; ++r) {
    const int slot = warp * kSlots + r % kSlots, c = warp + kWarps * r;
    ovla_i8::Lut tbl[4];   // W::kInt4, one group a chunk: the tables of this lane's 4 columns
    if constexpr (kW == W::kInt4) {
      if (one_group) {
        float sv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sv[j] = snext[j], snext[j] = group_s(j, (c + kWarps) * kChunk);
#pragma unroll
        for (int j = 0; j < 4; ++j) tbl[j] = ovla_i8::requant_lut(group_r(j, sv[j]), lane);
      }
    }
    hp::mbar_wait(full + slot, (r / kSlots) & 1);
    const uint8_t* as = ring + slot * kStage;
    const uint8_t* qs = as + kABytes;
    // B words of n8 tile j: b[j][2 kk], b[j][2 kk + 1] are the fragment's two registers in
    // k32 step kk (channel g8; k 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3 of the step)
    uint32_t b[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = j * 8 + (lane & 7);
      if constexpr (kW == W::kInt8) {
        // 128-byte rows, 16-byte chunk i of row n stored at chunk i ^ (n % 8); matrix i of
        // an ldmatrix hands lane (g8, t4) bytes 4 t4 .. 4 t4 + 3 of chunk i
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w[4];
          ldmatrix_x4(w, qs + n * 128 + ((((lane >> 3) + 4 * h) ^ (n & 7)) << 4));
#pragma unroll
          for (int i = 0; i < 4; ++i) b[j][4 * h + i] = w[i];
        }
      } else if constexpr (kW == W::kInt4) {
        // one group a chunk: a nibble plane's layout (64-byte rows, 16-byte chunk kk stored at
        // kk ^ ((n >> 1) & 3)); else box kk [32 n][16 bytes] at 512 kk. Either way lane (g8, t4)
        // gets the packed bytes 4 t4 .. 4 t4 + 3 of row n in k32 step kk, codes 8 t4 .. 8 t4 + 7,
        // requantized by the row's table
        uint32_t ph[4];
        ldmatrix_x4(ph, qs + (one_group ? n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4)
                                        : (lane >> 3) * (kBN * 16) + n * 16));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const ovla_i8::Lut t =
              one_group ? tbl[j]
                        : ovla_i8::requant_lut(group_r(j, group_s(j, c * kChunk + 32 * kk)), lane);
          ovla_i8::requant(ph[kk], t, b[j][2 * kk], b[j][2 * kk + 1]);
        }
      } else {
        // 64-byte rows, 16-byte chunk kk (k32 step kk) of row n stored at kk ^ ((n >> 1) & 3):
        // lane (g8, t4) gets the packed bytes 4 t4 .. 4 t4 + 3, codes 8 t4 .. 8 t4 + 7
        const int off = n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4);
        uint32_t ph[4];
        ldmatrix_x4(ph, qs + off);
        if constexpr (kW == W::kNibble) {
          uint32_t pl[4];
          ldmatrix_x4(pl, qs + kPlane + off);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ovla_i8::rebuild(ph[kk], pl[kk], b[j][2 * kk], b[j][2 * kk + 1]);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) ovla_i8::widen(ph[kk], b[j][2 * kk], b[j][2 * kk + 1]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A: 128-byte rows, 16-byte chunk i of row r stored at chunk i ^ (r % 8)
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], as + row * 128 + (((kk * 2 + (lane >> 4)) ^ (row & 7)) << 4));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_s8_16832(acc[mt][j], a[mt], b[j][2 * kk], b[j][2 * kk + 1]);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + slot);
  }

  // every warp's stages consumed: the ring takes the partial sums [warp][32 rows][pitch]
  hp::named_barrier(1, kConsumers);
  int* part = reinterpret_cast<int*>(ring);
  int* pw = part + warp * kBM * kPitch;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(pw + (mt * 16 + g8 + 8 * h) * kPitch + j * 8 + 2 * t4) =
            make_int2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  hp::named_barrier(1, kConsumers);
#pragma unroll
  for (int k = 0; k < kBM * kBN / kConsumers; ++k) {
    const int e = tid + kConsumers * k, row = e / kBN, col = e % kBN;
    const int m = m0 + row, n = n0 + col;
    if (m < M && n < N) {
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += part[(w * kBM + row) * kPitch + col];
      if constexpr (kW == W::kInt4)   // the requantized rows' scales s8 in place of s
        store1(out + (long long)m * N + n, epi.head(sum, epi.row(m), typename Epi::Col{s8s[col]}));
      else
        store1(out + (long long)m * N + n, epi(sum, m, n));
    }
  }
}

// One launch over codes xq int8 [M, K] (for packed weights in the stored_offset k order) and
// weights q: int8 [N, K], or the packed planes q (hi) and lo, uint8 [N, K / 2], or (W::kInt4)
// grouped int4 codes q, uint8 [G][N][gsz / 2] with `grp` (K = G · gsz; the epilogue's s unused).
// Returns the cudaError_t: the tensor maps need K a multiple of 16 (of 32 for packed codes) and
// 16-byte aligned pointers, which the callers check.
// `static`: each library's copy keeps its own opt-in state (w4a8_grouped.cu resident_clusters)
template <W kW, typename T, typename Epi>
static int launch(const int8_t* xq, const uint8_t* q, const uint8_t* lo, const Epi& epi, T* out,
                  int M, int N, int K, cudaStream_t stream, const Groups grp = {}) {
  CUtensorMap tm_a, tm_q, tm_lo;
  const bool packed = kW != W::kInt8;
  const uint64_t qcols = packed ? K / 2 : K;
  const CUtensorMapSwizzle qsw = packed ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hp::encode_2d(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, kBM, kChunk,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      (kW == W::kInt4 ? !hp::encode_groups(&tm_q, q, grp.G, N, grp.gsz, kBN)
                      : !hp::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, qcols, qcols,
                                       kBN, packed ? kChunk / 2 : kChunk, qsw)) ||
      (kW == W::kNibble && !hp::encode_2d(&tm_lo, CU_TENSOR_MAP_DATA_TYPE_UINT8, lo, N, qcols,
                                          qcols, kBN, kChunk / 2, qsw)))
    return int(cudaErrorInvalidValue);
  if (kW != W::kNibble) tm_lo = tm_q;   // unused
  auto kernel = decode_kernel<kW, T, Epi>;
  // the shared-memory opt-in once a kernel and process (host time: up to 1351 launches a call)
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes<kW>()));
  if (opt_in != cudaSuccess) return int(opt_in);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem_bytes<kW>(), stream>>>(tm_a, tm_q, tm_lo, epi, out, M, N, K, grp);
  return int(cudaGetLastError());
}

}  // namespace ovla_i8d
