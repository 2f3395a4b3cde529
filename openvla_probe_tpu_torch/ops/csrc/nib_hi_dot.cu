// nib_hi_dot: out[M, N] = cast(((f32(Σ_k x8[m, k] · hi[n, k]) · 16 + f32(Σ_k x8[m, k]) · 7.5)
// · s_x[m]) · s[n]), the decode-M product of a nibble weight leaf that streams only its hi plane.
//
// Replaces the XLA op openvla_probe_tpu/ops/linear.py::_nib_hi_dot (reached from _nib_matmul
// for M <= 32: the decode steps and lm_head of the nibble weights). With the lo nibble at its
// midpoint, w ≈ (16·hi + 7.5)·s, so the product is one int8 dot with the hi codes plus a rank-1
// correction by the row sums of the activation codes. Semantics kept bit for bit:
//   * per-row codes clip(rint(x / s_x), -127, 127) with s_x = max(max|x| / 127, 1e-8) and IEEE
//     divisions (round half to even);
//   * the exact int32 sums Σ x8·hi and Σ x8;
//   * f32(acc)·16 and f32(rowsum)·7.5 each rounded once, their sum rounded once, then
//     (· s_x) · s, in that order (the _rn intrinsics keep nvcc from contracting to an FMA).
// The hi plane is the port's packed layout: uint8 [N, K / 2], byte j holding code 2j in its low
// nibble and 2j + 1 in its high nibble, two's complement.
//
// Bound on the H100 at the OpenVLA-7B decode shapes (M = 24): the hi plane, half a byte per
// weight: 8.4 MB for 4096 x 4096 (2.5 us at 3.35 TB/s), 70.5 MB for lm_head's 32064 x 4096.
//
// Design. One call makes two launches:
//   1. the pre-pass (quant_rows, int8_mma.cuh), one block per row, writes the codes, s_x and
//      the row sums of the codes. It stores each 32-code block of codes in the k order the
//      GEMM's B fragments take (below): the activation codes of 24 rows at K = 11008 (264 KB)
//      do not fit in shared memory, so the GEMM streams them by k chunk beside the weights;
//   2. the GEMM on mma.sync m16n8k32 s8 x s8 -> s32: 32 x 32 tiles, 4 warps of 16 x 16, a
//      cp.async ring of 8 stages of 128-deep k chunks, one barrier per chunk. The packed codes
//      go straight from the staged chunk into B fragments (ldmatrix hands each thread 8
//      consecutive codes of one channel, widened to int8 in registers); a fragment takes k in
//      another order than those 8 codes, which the pre-pass's order matches (an integer dot
//      product does not depend on the order of its terms). Columns past N are zero-filled and
//      masked at the store. Split K and TMA are later work.
#include "int8_mma.cuh"

namespace ovla_nib {

using namespace ovla_i8;

// ---------------------------------------------------------------------------
// GEMM over the hi plane

constexpr int kChunk = 128;          // k per staged chunk
constexpr int kAP = kChunk + 16;     // code tile pitch: 36 words, conflict-free ldmatrix rows
constexpr int kBPk = kChunk / 2;     // packed bytes of one channel per chunk
constexpr int kBP = kBPk + 16;       // packed tile pitch: 20 words, conflict-free ldmatrix rows
constexpr int BM = 32, BN = 32, WM = 2, WN = 2, STAGES = 8;
constexpr int kThreads = 32 * WM * WN;
constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
constexpr int kAStage = BM * kAP, kBStage = BN * kBP;
constexpr size_t kSmem = size_t(STAGES) * (kAStage + kBStage);

template <typename T>
__global__ void __launch_bounds__(kThreads)
    nib_hi_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                       const int* __restrict__ rowsum, const uint8_t* __restrict__ hi,
                       const float* __restrict__ s, T* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) uint8_t nib_smem[];
  int8_t* as = reinterpret_cast<int8_t*>(nib_smem);      // [STAGES][BM][kAP]
  uint8_t* bp = nib_smem + STAGES * kAStage;             // [STAGES][BN][kBP]
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int KC = (K + kChunk - 1) / kChunk, Kh = K / 2;

  auto load = [&](int c) {
    const int k0 = c * kChunk;
    int8_t* ad = as + (c % STAGES) * kAStage;
    for (int i = threadIdx.x; i < BM * (kChunk / 16); i += kThreads) {
      const int r = i / (kChunk / 16), k = k0 + (i % (kChunk / 16)) * 16, m = m0 + r;
      const bool ok = m < M && k < K;   // rows past M and k past K are zero-filled
      cp_async16(ad + r * kAP + (k - k0), ok ? xq + (long long)m * K + k : xq, ok ? 16 : 0);
    }
    uint8_t* bd = bp + (c % STAGES) * kBStage;
    for (int i = threadIdx.x; i < BN * (kBPk / 16); i += kThreads) {
      const int r = i / (kBPk / 16), u = i % (kBPk / 16), n = n0 + r;
      const bool ok = n < N && k0 + 32 * u < K;
      cp_async16(bd + r * kBP + 16 * u, ok ? hi + (long long)n * Kh + k0 / 2 + 16 * u : hi,
                 ok ? 16 : 0);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;

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
    const int8_t* ast = as + (c % STAGES) * kAStage;
    const uint8_t* bst = bp + (c % STAGES) * kBStage;
    // packed B words: ldmatrix matrix kk of n8 tile j hands lane (g8, t4) the packed bytes
    // 4 t4 .. 4 t4 + 3 of channel g8 in k32 step kk, i.e. its codes 8 t4 .. 8 t4 + 7
    uint32_t bw[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      ldmatrix_x4(bw[j], bst + ((wn * NT + j) * 8 + (lane & 7)) * kBP + (lane >> 3) * 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
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
        for (int mt = 0; mt < MT; ++mt) mma_s8_16832(acc[mt][j], a[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + (wn * NT + j) * 8 + 2 * t4;
    if (n >= N) continue;   // N is a multiple of 8: n + 1 < N too
    const float s0 = s[n], s1 = s[n + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + (wm * MT + mt) * 16 + g8 + 8 * h;
        if (m >= M) continue;
        const float sm = sx[m];
        const float corr = __fmul_rn(__int2float_rn(rowsum[m]), 7.5f);
        const float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][j][2 * h]), 16.f), corr);
        const float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][j][2 * h + 1]), 16.f), corr);
        store2(out + (long long)m * N + n, __fmul_rn(__fmul_rn(v0, sm), s0),
               __fmul_rn(__fmul_rn(v1, sm), s1));
      }
  }
}

template <typename T>
int run(const void* x, const void* hi, const void* s, void* out, void* xq, void* sx, void* rs,
        int M, int N, int K, cudaStream_t stream) {
  int8_t* codes = static_cast<int8_t*>(xq);
  float* scales = static_cast<float*>(sx);
  int* rowsum = static_cast<int*>(rs);
  // the codes in the k order of the packed-code fragments, and their row sums
  cudaError_t err = quant_rows<T, true, true>(x, codes, scales, rowsum, M, K, stream);
  if (err != cudaSuccess) return int(err);
  auto kernel = nib_hi_gemm_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, kSmem, stream>>>(codes, scales, rowsum,
                                            static_cast<const uint8_t*>(hi),
                                            static_cast<const float*>(s), static_cast<T*>(out),
                                            M, N, K);
  return int(cudaGetLastError());
}

}  // namespace ovla_nib

// Returns the launches' cudaError_t (0 on success). x [M, K] (bf16 or fp32), hi packed uint8
// [N, K / 2], s fp32 [N], out [M, N] in x's type, and the pre-pass's scratch xq int8 [M, K],
// sx fp32 [M], rowsum int32 [M]: all contiguous and 16-byte aligned; K a multiple of 32, N of 8.
extern "C" int ovla_nib_hi_dot(const void* x, const void* hi, const void* s, void* out, void* xq,
                               void* sx, void* rowsum, int M, int N, int K, int is_bf16,
                               void* stream) {
  if (M < 1 || N < 8 || N % 8 != 0 || K < 32 || K % 32 != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ovla_nib::run<__nv_bfloat16>(x, hi, s, out, xq, sx, rowsum, M, N, K, st);
  return ovla_nib::run<float>(x, hi, s, out, xq, sx, rowsum, M, N, K, st);
}
