// w4a8_grouped: out[M, N] = cast(s_x[m] · Σ_g f32(Σ_{k in g} x8[m, k] · q4[g, n, k]) · s[n, g]):
// per-row int8 activation codes times grouped int4 weight codes, each group's exact int32
// product scaled by its own group scale.
//
// Replaces the XLA op openvla_probe_tpu/ops/linear.py::_w4a8_dot_grouped (forward :511-522): the
// decode-M product (M <= 32) of grouped int4 leaves and of mix leaves' int4 copies off the
// kernel gate (the turbo tier over bits=4 and bits="mix" weights). Semantics:
//   * per-row codes clip(rint(x / s_x), -127, 127) with s_x = max(max|x| / 127, 1e-8) and IEEE
//     divisions (round half to even), the pre-pass quant_rows of int8_mma.cuh;
//   * the exact int32 product of each segment of K (a 128-deep chunk cut at the group
//     boundaries), folded into an fp32 sum as acc + f32(p) · s[n, g], two roundings (the _rn
//     intrinsics keep nvcc from contracting);
//   * the fp32 sums in a fixed order: chunk c belongs to warp c % 8, each warp folds its
//     segments in k order, the 8 warps' sums are added in warp order, then · s_x and the cast.
//     The plain version (ops/linear.py::w4a8_grouped_plain) states that order, so the kernel is
//     bit-equal to it; against the JAX package, whose einsum order is unspecified, it is held
//     within a tolerance. No step depends on M or N (a column's sums are the same in any tile),
//     so fusing q/k/v or gate/up into one leaf changes no output bit.
// Weight codes are the port's packed layout, group-major: uint8 [G][N][gsz / 2], byte j holding
// code 2j in its low nibble and 2j + 1 in its high nibble (two's complement); s fp32 [N][G].
//
// Bound on the H100 at the OpenVLA-7B decode shapes (M = 24): the int4 codes and the scales,
// 8.4 + 0.5 MB at 4096 x 4096 (2.7 us at 3.35 TB/s), 65.7 + 4.1 MB at lm_head's 32064 x 4096
// (20.8 us).
//
// Design: the split-K decode core of int8_decode.cuh (its grouped-int4 loads, W::kInt4's
// stages) with a grouped fold. A block owns kBN = 32 columns and kBM = 32 rows over all of K;
// one producer thread fills each consumer warp's two stages in chunk order by TMA: the
// activation codes [32 rows][128 bytes] (128-byte swizzle) and the int4 codes from a 3-D map
// over [G][N][gsz / 2], one box [32 n][64 bytes] a chunk (64-byte swizzle) where gsz is a
// multiple of 128 (a chunk is then one group), else one box [32 n][16 bytes] per 32-deep k step
// (a step lies in one group: gsz is a multiple of 32). 8 consumer warps take the chunks in turn;
// the packed codes are widened to int8 in registers (ldmatrix hands each thread 8 consecutive
// codes of one channel; the pre-pass stores each 32-code block of activation codes in the
// matching stored_offset order) for mma.sync m16n8k32 s8 x s8 -> s32. At the end of each
// segment every accumulator is folded into its fp32 sum with the scale of its column (the
// column of a C fragment element, j · 8 + 2 · t4 + e % 2, not the B fragment's); at one group a
// chunk each chunk's scales are loaded a chunk of this warp ahead. Then the warps' fp32 sums meet
// in shared memory (the consumed ring) and each output adds them in warp order. Unlike
// w4a8_matmul.cu (N a multiple of 128), any N that is a multiple of 8 is taken: columns past N
// are zero-filled by TMA and never stored.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, tools/kernel_ab.py; PERF.md §6): 0.0337
// ms launch-weighted against the 0.0048 bound, 0.0227 at 4096 x 4096. A knock-out without the
// fold ran 0.0293: the fold's fp32 sums hold 128 registers a thread, one block an SM (80 and two
// blocks without them), which the shapes of several waves of column blocks pay (N = 11008 and
// lm_head); a fold within ~80 registers is the next step.
#include "int8_decode.cuh"

namespace ovla_w4g {

namespace hp = ovla_hp;
namespace d = ovla_i8d;
using d::kABytes;
using d::kBM;
using d::kBN;
using d::kChunk;
using d::kConsumers;
using d::kPitch;
using d::kPlane;
using d::kSlots;
using d::kStages;
using d::kThreads;
using d::kWarps;
using ovla_i8::ldmatrix_x4;
using ovla_i8::mma_s8_16832;

constexpr int kStage = d::stage_bytes<d::W::kInt4>();   // 4 KB of codes + 2 KB of int4 codes
static_assert(kWarps * kBM * kPitch * 4 <= kStages * kStage, "the fp32 partials fit the ring");

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_q, const float* __restrict__ sx,
                   const float* __restrict__ s, T* __restrict__ out, int M, int N, int G,
                   int gsz) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int K = G * gsz;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int KC = (K + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  const bool one_group = gsz % kChunk == 0;

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
        const int steps = one_group ? 1 : min(4, (K - c * kChunk) / 32);
        const int box = one_group ? kPlane : kBN * 16;
        hp::mbar_expect_tx(full + slot, kABytes + steps * box);
        hp::tma_load_2d(st, &tm_a, c * kChunk, m0, full + slot);
        for (int kk = 0; kk < steps; ++kk) {
          const int k = c * kChunk + 32 * kk;
          hp::tma_load_3d(st + kABytes + kk * box, &tm_q, (k % gsz) / 2, n0, k / gsz,
                          full + slot);
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32, g8 = lane >> 2, t4 = lane & 3;
  int acc[2][4][4];     // m16 tiles 0, 1 x n8 tiles 0..3: the segment's int32 sums
  float facc[2][4][4];  // this warp's fp32 sums
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0, facc[mt][j][e] = 0.f;

  // the scales of this lane's accumulator columns n0 + j · 8 + 2 · t4 + h in group g (0 past N)
  auto load_scales = [&](int g, float (&sc)[4][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + j * 8 + 2 * t4 + h;
        sc[j][h] = n < N ? __ldg(s + (long long)n * G + g) : 0.f;
      }
  };
  // acc + f32(p) · s, each step rounded once; the segment's int32 sums restart at 0
  auto fold = [&](const float (&sc)[4][2]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          facc[mt][j][e] =
              __fadd_rn(facc[mt][j][e], __fmul_rn(__int2float_rn(acc[mt][j][e]), sc[j][e & 1]));
          acc[mt][j][e] = 0;
        }
  };

  float snext[4][2];
  if (one_group && warp < KC) load_scales(warp * kChunk / gsz, snext);
  for (int r = 0; warp + kWarps * r < KC; ++r) {
    const int slot = warp * kSlots + r % kSlots, c = warp + kWarps * r;
    const int steps = min(4, (K - c * kChunk) / 32);
    float sc[4][2];
    if (one_group) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j][0] = snext[j][0], sc[j][1] = snext[j][1];
      if (c + kWarps < KC) load_scales((c + kWarps) * kChunk / gsz, snext);
    }
    hp::mbar_wait(full + slot, (r / kSlots) & 1);
    const uint8_t* as = ring + slot * kStage;
    const uint8_t* qs = as + kABytes;
    // B words of n8 tile j: b[j][2 kk], b[j][2 kk + 1] are the fragment's two registers in k32
    // step kk (channel g8; k 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3 of the step). One
    // group a chunk: 64-byte rows, 16-byte chunk kk of row n stored at kk ^ ((n >> 1) & 3);
    // else box kk [32 n][16 bytes] at 512 kk. Lane (g8, t4) gets the packed bytes
    // 4 t4 .. 4 t4 + 3 of row n in step kk, codes 8 t4 .. 8 t4 + 7, widened to int8.
    uint32_t b[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = j * 8 + (lane & 7);
      uint32_t ph[4];
      ldmatrix_x4(ph, qs + (one_group ? n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4)
                                      : (lane >> 3) * (kBN * 16) + n * 16));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ovla_i8::widen(ph[kk], b[j][2 * kk], b[j][2 * kk + 1]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < steps) {
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
        const int k = c * kChunk + 32 * kk;
        if (!one_group && ((k + 32) % gsz == 0 || kk == steps - 1)) {   // a segment ends
          load_scales(k / gsz, sc);
          fold(sc);
        }
      }
    }
    if (one_group) fold(sc);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + slot);
  }

  // every warp's stages consumed: the ring takes the fp32 sums [warp][32 rows][pitch]
  hp::named_barrier(1, kConsumers);
  float* part = reinterpret_cast<float*>(ring);
  float* pw = part + warp * kBM * kPitch;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(pw + (mt * 16 + g8 + 8 * h) * kPitch + j * 8 + 2 * t4) =
            make_float2(facc[mt][j][2 * h], facc[mt][j][2 * h + 1]);
  hp::named_barrier(1, kConsumers);
#pragma unroll
  for (int k = 0; k < kBM * kBN / kConsumers; ++k) {
    const int e = tid + kConsumers * k, row = e / kBN, col = e % kBN;
    const int m = m0 + row, n = n0 + col;
    if (m < M && n < N) {
      float sum = part[row * kPitch + col];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, part[(w * kBM + row) * kPitch + col]);
      d::store1(out + (long long)m * N + n, __fmul_rn(sum, __ldg(sx + m)));
    }
  }
}

template <typename T>
int run(const int8_t* xq, const float* sx, const uint8_t* q, const float* s, void* out, int M,
        int N, int G, int gsz, cudaStream_t stream) {
  CUtensorMap tm_a, tm_q;
  const int K = G * gsz;
  if (!hp::encode_2d(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, kBM, kChunk,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::encode_groups(&tm_q, q, G, N, gsz, kBN))
    return int(cudaErrorInvalidValue);
  auto kernel = grouped_kernel<T>;
  const size_t smem = d::smem_bytes<d::W::kInt4>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(tm_a, tm_q, sx, s, static_cast<T*>(out), M, N, G,
                                           gsz);
  return int(cudaGetLastError());
}

}  // namespace ovla_w4g

// Returns the launches' cudaError_t (0 on success). x [M, K] (bf16 when is_bf16, else fp32),
// scratch xq int8 [M, K] and sx fp32 [M] (the pre-pass writes the codes in the stored_offset k
// order of the packed fragments), q packed uint8 [G][N][gsz / 2] (group-major), s fp32 [N][G],
// out [M, N] in x's type. All contiguous; x, xq and q 16-byte aligned; gsz a multiple of 32
// (each 32-deep k step in one group; the wrapper refuses other group sizes), K = G · gsz,
// N a multiple of 8, M up to 65535 row blocks of 32.
extern "C" int ovla_w4a8_grouped(const void* x, void* xq, void* sx, const void* q, const void* s,
                                 void* out, int M, int N, int G, int gsz, int is_bf16,
                                 void* stream) {
  auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  const long long K = (long long)G * gsz;
  if (M < 1 || (M + ovla_i8d::kBM - 1) / ovla_i8d::kBM > 65535 || N < 8 || N % 8 != 0 || G < 1 ||
      gsz < 32 || gsz % 32 != 0 || K > (1 << 30) || !x || !s || misaligned(x) ||
      misaligned(xq) || misaligned(q))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* codes = static_cast<int8_t*>(xq);
  float* scales = static_cast<float*>(sx);
  using ovla_i8::quant_rows;
  const cudaError_t err =
      is_bf16 ? quant_rows<__nv_bfloat16, true, false>(x, codes, scales, nullptr, M, int(K), st)
              : quant_rows<float, true, false>(x, codes, scales, nullptr, M, int(K), st);
  if (err != cudaSuccess) return int(err);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  if (is_bf16)
    return ovla_w4g::run<__nv_bfloat16>(codes, scales, qp, sp, out, M, N, G, gsz, st);
  return ovla_w4g::run<float>(codes, scales, qp, sp, out, M, N, G, gsz, st);
}
