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
//     128: 8.9 MB per 4096 x 4096 launch, 2.7 us at 3.35 TB/s (about 1 ms of trunk weights
//     per decode step, half of int8's);
//   * prefill and towers, M = 6144-6912: int8 tensor-core operations, 0.117 ms for
//     6912 x 4096 x 4096 at 1979 TOP/s.
//
// Design. One wrapper call makes two launches:
//   1. the pre-pass (quant_rows, int8_mma.cuh), one block per row, writes the int8 codes
//      x8 [M, K] and s_x [M] once (the TPU kernel quantizes each row tile once into VMEM;
//      redone in every column block, as an early version of the fused ViT kernels did with
//      their LayerNorm, it would repeat the work N / BN times);
//   2. the grouped GEMM on mma.sync m16n8k32 s8 x s8 -> s32, four k-steps per 128-deep
//      chunk. Codes and packed weights stream through a cp.async ring of 128-deep k chunks
//      (one 16-byte copy carries 32 codes of one output channel), one barrier per chunk.
//      The packed weights go straight from the staged chunk into B fragments (ldmatrix
//      hands each thread 8 consecutive codes of one channel) and are widened to int8 in
//      registers (nibbles sign-extended, never to bf16: the products stay the TPU's int8
//      MXU products). A fragment takes k in another order than those 8 codes, so the
//      pre-pass stores each 32-code block of activation codes in the matching order (an
//      integer dot product does not depend on the order of its terms). The block's group
//      scales are staged in shared memory once; after each group the int32 fragments fold
//      into the fp32 accumulators.
//      M > 64: 128 x 128 tiles, 8 warps of 64 x 32, 3 stages. M <= 64 (decode): 32 x 32
//      tiles, 4 warps of 16 x 16, 8 stages, so a 4096-wide product spreads over 128 blocks
//      with ~48 KB of each block's stream in flight.
// wgmma, TMA and split K for the decode products are later work.
#include "int8_mma.cuh"

namespace ovla_w4 {

using namespace ovla_i8;

// ---------------------------------------------------------------------------
// grouped GEMM

constexpr int kChunk = 128;          // k per staged chunk
constexpr int kAP = kChunk + 16;     // int8 code tile pitch: 36 words, conflict-free ldmatrix rows
constexpr int kBPk = kChunk / 2;     // packed bytes of one channel per chunk
constexpr int kBP = kBPk + 16;       // packed tile pitch: 20 words, conflict-free ldmatrix rows

template <int BM, int BN, int WM, int WN, int STAGES>
struct Cfg {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;   // m16 / n8 tiles per warp
  static constexpr int kAStage = BM * kAP, kBStage = BN * kBP;
  // the stages, then the block's scales [BN][G]
  static size_t smem(int G) {
    return size_t(STAGES) * (kAStage + kBStage) + size_t(BN) * G * sizeof(float);
  }
};

template <typename T, int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN)
    w4a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                     const uint8_t* __restrict__ q, const float* __restrict__ s,
                     T* __restrict__ out, int M, int N, int K, int gsz) {
  using C = Cfg<BM, BN, WM, WN, STAGES>;
  constexpr int MT = C::MT, NT = C::NT, kThreads = C::kThreads;
  extern __shared__ __align__(16) uint8_t w4_smem[];
  int8_t* as = reinterpret_cast<int8_t*>(w4_smem);                    // [STAGES][BM][kAP]
  uint8_t* bp = w4_smem + STAGES * C::kAStage;                        // [STAGES][BN][kBP]
  float* ss = reinterpret_cast<float*>(bp + STAGES * C::kBStage);     // [BN][G] scales
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int KC = K / kChunk, CPG = gsz / kChunk, G = K / gsz, half = gsz / 2;

  auto load = [&](int c) {
    const int k0 = c * kChunk;
    int8_t* ad = as + (c % STAGES) * C::kAStage;
    for (int i = threadIdx.x; i < BM * (kChunk / 16); i += kThreads) {
      const int r = i / (kChunk / 16), cc = i % (kChunk / 16), m = m0 + r;
      const bool ok = m < M;   // rows past M are zero-filled
      cp_async16(ad + r * kAP + cc * 16, ok ? xq + (long long)m * K + k0 + cc * 16 : xq,
                 ok ? 16 : 0);
    }
    uint8_t* bd = bp + (c % STAGES) * C::kBStage;
    const uint8_t* src = q + ((long long)(k0 / gsz) * N + n0) * half + (k0 % gsz) / 2;
    for (int i = threadIdx.x; i < BN * (kBPk / 16); i += kThreads) {
      const int r = i / (kBPk / 16), cc = i % (kBPk / 16);
      cp_async16(bd + r * kBP + cc * 16, src + (long long)r * half + cc * 16, 16);
    }
  };
  // the block's scales: rows n0 .. n0 + BN of s [N, G], one contiguous slab
  for (int i = threadIdx.x; i < BN * G; i += kThreads) ss[i] = s[(long long)n0 * G + i];

  int p[MT][NT][4];
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[mt][j][e] = 0, acc[mt][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KC) load(st);
    cp_async_commit();
  }
  for (int c = 0; c < KC; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk c landed for every thread; chunk c - 1's stage consumed
    if (c + STAGES - 1 < KC) load(c + STAGES - 1);
    cp_async_commit();
    const int8_t* ast = as + (c % STAGES) * C::kAStage;
    const uint8_t* bst = bp + (c % STAGES) * C::kBStage;
    // packed B words: ldmatrix matrix kk of n8 tile j hands lane (g8, t4) the packed bytes
    // 4 t4 .. 4 t4 + 3 of channel g8 in k32 step kk, i.e. its codes 8 t4 .. 8 t4 + 7
    uint32_t bw[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      ldmatrix_x4(bw[j], bst + ((wn * NT + j) * 8 + (lane & 7)) * kBP + (lane >> 3) * 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // ldmatrix on the int8 code tile read as b16: each 8 x 16-byte matrix hands lane
      // (g8, t4) bytes 4 t4 .. 4 t4 + 3 of row g8, the s8 A fragment layout
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], ast + ((wm * MT + mt) * 16 + (lane & 15)) * kAP + kk * 32 +
                               (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        widen(bw[j][kk], b0, b1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8_16832(p[mt][j], a[mt], b0, b1);
      }
    }
    if ((c + 1) % CPG == 0) {   // group c / CPG complete: fold it, in group order
      const int g = c / CPG;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int nl = (wn * NT + j) * 8 + 2 * t4;   // column within the block
        const float s0 = ss[nl * G + g], s1 = ss[(nl + 1) * G + g];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][j][e] = __fadd_rn(acc[mt][j][e],
                                      __fmul_rn(__int2float_rn(p[mt][j][e]), (e & 1) ? s1 : s0));
            p[mt][j][e] = 0;
          }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + (wn * NT + j) * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + (wm * MT + mt) * 16 + g8 + 8 * h;
        if (m >= M) continue;
        const float sm = sx[m];
        store2(out + (long long)m * N + n, __fmul_rn(acc[mt][j][2 * h], sm),
               __fmul_rn(acc[mt][j][2 * h + 1], sm));
      }
    }
}

template <typename T, int BM, int BN, int WM, int WN, int STAGES>
int launch_gemm(const int8_t* xq, const float* sx, const uint8_t* q, const float* s, T* out,
                int M, int N, int K, int gsz, cudaStream_t stream) {
  using C = Cfg<BM, BN, WM, WN, STAGES>;
  auto kernel = w4a8_gemm_kernel<T, BM, BN, WM, WN, STAGES>;
  const size_t smem = C::smem(K / gsz);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, C::kThreads, smem, stream>>>(xq, sx, q, s, out, M, N, K, gsz);
  return int(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* q, const void* s, void* out, void* xq, void* sx, int M, int N,
        int K, int gsz, cudaStream_t stream) {
  int8_t* codes = static_cast<int8_t*>(xq);
  float* scales = static_cast<float*>(sx);
  // the pre-pass stores the codes in the k order of the packed-code fragments
  const cudaError_t err = quant_rows<T, true, false>(x, codes, scales, nullptr, M, K, stream);
  if (err != cudaSuccess) return int(err);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  T* o = static_cast<T*>(out);
  if (M <= 64) return launch_gemm<T, 32, 32, 2, 2, 8>(codes, scales, qp, sp, o, M, N, K, gsz, stream);
  return launch_gemm<T, 128, 128, 2, 4, 3>(codes, scales, qp, sp, o, M, N, K, gsz, stream);
}

}  // namespace ovla_w4

// Returns the launches' cudaError_t (0 on success). x [M, K] (bf16 or fp32), q packed uint8
// [K / gsz, N, gsz / 2], s fp32 [N, K / gsz], out [M, N] in x's type, and the scratch xq int8
// [M, K] and sx fp32 [M] for the pre-pass: all contiguous and 16-byte aligned; N and gsz
// multiples of 128, K a multiple of gsz, at most 128 groups.
extern "C" int ovla_w4a8_matmul(const void* x, const void* q, const void* s, void* out, void* xq,
                                void* sx, int M, int N, int K, int gsz, int is_bf16,
                                void* stream) {
  if (M < 1 || N < 128 || N % 128 != 0 || gsz < 128 || gsz % 128 != 0 || K < gsz ||
      K % gsz != 0 || K / gsz > 128)   // the staged scales: 128 x 128 fp32 at most
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return ovla_w4::run<__nv_bfloat16>(x, q, s, out, xq, sx, M, N, K, gsz, st);
  return ovla_w4::run<float>(x, q, s, out, xq, sx, M, N, K, gsz, st);
}
