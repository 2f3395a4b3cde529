// w8a8_matmul: out[M, N] = cast((f32(Σ_k x8[m, k] · q8[n, k]) · s_x[m]) · s[n]), per-row int8
// activation codes times per-channel int8 weight codes.
//
// Replaces the XLA op openvla_probe_tpu/ops/linear.py::_w8a8_dot (the turbo tier's int8 linears,
// the prefill of nibble weights through _nib_matmul, the int4 requant route) and the prequant
// branch of its matmul_t (codes handed over by the fused RMSNorm -> int8 kernel). Semantics kept
// bit for bit:
//   * per-row codes clip(rint(x / s_x), -127, 127) with s_x = max(max|x| / 127, 1e-8) and IEEE
//     divisions (round half to even, as jnp.round), or the given codes and scales;
//   * the exact int32 product (|sum| <= 127² · K < 2³¹ for K < 133,000);
//   * out = cast((f32(acc) · s_x) · s), the conversion and the two products each rounded once
//     (the _rn intrinsics: nvcc would not contract them, but they say so).
// Weight codes come in one of two forms:
//   * int8 [N, K];
//   * two nibble planes hi, lo, packed uint8 [N, K / 2] (byte j: code 2j in its low nibble,
//     2j + 1 in its high nibble, two's complement), whose exact int8 codes 16·hi + lo + 8 the
//     loader rebuilds in registers (openvla_probe_tpu/ops/linear.py::nibble_reconstruct_q8 fused
//     in). As a byte, 16·hi + lo + 8 is (hi's nibble << 4) | (lo's nibble ^ 8): the low nibble is
//     lo + 8 in 0..15 and 16·hi + 128 ≡ hi's nibble << 4 (mod 256), so no intermediate leaves
//     its range. The same codes give the same output in both forms.
//
// Bound on the H100 at the OpenVLA-7B shapes: prefill and towers (M = 6144-6912) by int8
// tensor-core operations, 0.117 ms for 6912 x 4096 x 4096 at 1979 TOP/s; decode (M = 24) by the
// weight stream, 16.8 MB per 4096 x 4096 launch (5.0 us at 3.35 TB/s).
//
// Design (a first version: mma.sync, no wgmma or TMA). One call makes one or two launches:
//   1. for float activations, the pre-pass (quant_rows, int8_mma.cuh) writes the codes
//      [M, K] and s_x [M];
//   2. the GEMM on mma.sync m16n8k32 s8 x s8 -> s32, four k-steps per 128-deep chunk. Codes and
//      weights stream through a cp.async ring of 128-deep k chunks, one barrier per chunk, and
//      are read with ldmatrix. int8 weights in their natural k order, as the codes of the
//      pre-pass or of the fused norm. Nibble planes go straight from the staged chunk into B
//      fragments: ldmatrix hands each thread 8 consecutive codes of one channel from each plane,
//      rebuilt to int8 in registers; a fragment takes k in another order than those 8 codes, so
//      for nibble weights the pre-pass stores each 32-code block of activation codes in the
//      matching order (an integer dot product does not depend on the order of its terms; the
//      fused norm's codes, in natural order, never meet nibble weights). Ragged edges are
//      zero-filled by the copies (rows past M, columns past N, k past K in 16-code units) and
//      masked at the store.
//      M > 64: 128 x 128 tiles, 8 warps of 64 x 32, 3 stages. M <= 64 (decode): 32 x 32 tiles,
//      4 warps of 16 x 16, 8 stages, so a 4096-wide product spreads over 128 blocks.
#include "int8_mma.cuh"

namespace ovla_w8 {

using namespace ovla_i8;

// ---------------------------------------------------------------------------
// GEMM

constexpr int kChunk = 128;        // k per staged chunk
// tile pitch: 36 words, conflict-free ldmatrix rows. A row of a weight tile holds a channel's
// 128 int8 codes, or its 64 packed bytes of the hi plane, then 64 of the lo plane.
constexpr int kP = kChunk + 16;

template <int BM, int BN, int WM, int WN, int STAGES, bool NIB>
struct Cfg {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;   // m16 / n8 tiles per warp
  static constexpr int kAStage = BM * kP;
  static constexpr int kBStage = BN * kP;
  static constexpr size_t kSmem = size_t(STAGES) * (kAStage + kBStage);
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
};

// 8 packed codes of each plane (one word each) -> the 8 int8 codes 16·hi + lo + 8 in k order
// (two words)
__device__ __forceinline__ void rebuild(uint32_t ph, uint32_t pl, uint32_t& w0, uint32_t& w1) {
  const uint32_t ev = ((ph & 0x0F0F0F0Fu) << 4) | ((pl & 0x0F0F0F0Fu) ^ 0x08080808u);  // 0 2 4 6
  const uint32_t od = (ph & 0xF0F0F0F0u) | (((pl >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);  // 1 3 5 7
  w0 = __byte_perm(ev, od, 0x5140);   // codes 0, 1, 2, 3
  w1 = __byte_perm(ev, od, 0x7362);   // codes 4, 5, 6, 7
}

// two blocks per SM: 110.6 KB of shared memory each at the 128 x 128 tiles, so at most 128
// registers a thread (one block per SM at 156 was 1.6x slower, nibble loader)
template <typename T, int BM, int BN, int WM, int WN, int STAGES, bool NIB>
__global__ void __launch_bounds__(32 * WM * WN, 2)
    w8a8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                     const uint8_t* __restrict__ q, const uint8_t* __restrict__ lo,
                     const float* __restrict__ s, T* __restrict__ out, int M, int N, int K) {
  using C = Cfg<BM, BN, WM, WN, STAGES, NIB>;
  constexpr int MT = C::MT, NT = C::NT, kThreads = C::kThreads;
  extern __shared__ __align__(16) uint8_t w8_smem[];
  int8_t* as = reinterpret_cast<int8_t*>(w8_smem);                       // [STAGES][BM][kP]
  uint8_t* bs = w8_smem + STAGES * C::kAStage;                           // [STAGES][BN][kP]
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int KC = (K + kChunk - 1) / kChunk, Kh = K / 2;

  auto load = [&](int c) {
    const int k0 = c * kChunk;
    int8_t* ad = as + (c % STAGES) * C::kAStage;
    for (int i = threadIdx.x; i < BM * (kChunk / 16); i += kThreads) {
      const int r = i / (kChunk / 16), k = k0 + (i % (kChunk / 16)) * 16, m = m0 + r;
      const bool ok = m < M && k < K;   // rows past M and k past K are zero-filled
      cp_async16(ad + r * kP + (k - k0), ok ? xq + (long long)m * K + k : xq, ok ? 16 : 0);
    }
    uint8_t* bd = bs + (c % STAGES) * C::kBStage;
    if constexpr (NIB) {
      // 32 codes (16 packed bytes) per copy: units 0-3 of a row from the hi plane, 4-7 from lo
      for (int i = threadIdx.x; i < BN * 8; i += kThreads) {
        const int r = i / 8, u = i % 8, n = n0 + r, k = k0 + 32 * (u % 4);
        const bool ok = n < N && k < K;
        const uint8_t* plane = u < 4 ? q : lo;
        cp_async16(bd + r * kP + 16 * u, ok ? plane + (long long)n * Kh + k / 2 : plane,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < BN * (kChunk / 16); i += kThreads) {
        const int r = i / (kChunk / 16), k = k0 + (i % (kChunk / 16)) * 16, n = n0 + r;
        const bool ok = n < N && k < K;
        cp_async16(bd + r * kP + (k - k0), ok ? q + (long long)n * K + k : q, ok ? 16 : 0);
      }
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
    const int8_t* ast = as + (c % STAGES) * C::kAStage;
    const uint8_t* bst = bs + (c % STAGES) * C::kBStage;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // ldmatrix on an int8 tile read as b16: each 8 x 16-byte matrix hands lane (g8, t4)
      // bytes 4 t4 .. 4 t4 + 3 of row g8, the s8 fragment layout of A and of int8 B; of a
      // packed plane, the bytes 4 t4 .. 4 t4 + 3 of channel g8 in k32 step kk, i.e. its codes
      // 8 t4 .. 8 t4 + 7 (the order the pre-pass stored the activation codes in)
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], ast + ((wm * MT + mt) * 16 + (lane & 15)) * kP + kk * 32 +
                               (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // matrices: n8 tile j, then n8 tile j + 1; of each, int8 k 0-15 and 16-31, or the
        // hi and the lo plane's packed word
        const uint8_t* row = bst + ((wn * NT + j + (lane >> 4)) * 8 + (lane & 7)) * kP;
        uint32_t b[4];
        if constexpr (NIB) {
          ldmatrix_x4(b, row + ((lane >> 3) & 1) * 64 + kk * 16);
          rebuild(b[0], b[1], b[0], b[1]);
          rebuild(b[2], b[3], b[2], b[3]);
        } else {
          ldmatrix_x4(b, row + kk * 32 + ((lane >> 3) & 1) * 16);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_s8_16832(acc[mt][j], a[mt], b[0], b[1]);
          mma_s8_16832(acc[mt][j + 1], a[mt], b[2], b[3]);
        }
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
        store2(out + (long long)m * N + n,
               __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][j][2 * h]), sm), s0),
               __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][j][2 * h + 1]), sm), s1));
      }
  }
}

template <typename T, int BM, int BN, int WM, int WN, int STAGES, bool NIB>
int launch_gemm(const int8_t* xq, const float* sx, const uint8_t* q, const uint8_t* lo,
                const float* s, T* out, int M, int N, int K, cudaStream_t stream) {
  using C = Cfg<BM, BN, WM, WN, STAGES, NIB>;
  auto kernel = w8a8_gemm_kernel<T, BM, BN, WM, WN, STAGES, NIB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::kSmem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(xq, sx, q, lo, s, out, M, N, K);
  return int(cudaGetLastError());
}

template <typename T, bool NIB>
int gemm(const int8_t* xq, const float* sx, const uint8_t* q, const uint8_t* lo, const float* s,
         T* out, int M, int N, int K, cudaStream_t stream) {
  if (M <= 64)
    return launch_gemm<T, 32, 32, 2, 2, 8, NIB>(xq, sx, q, lo, s, out, M, N, K, stream);
  return launch_gemm<T, 128, 128, 2, 4, 3, NIB>(xq, sx, q, lo, s, out, M, N, K, stream);
}

template <typename T>
int run(const int8_t* xq, const float* sx, const uint8_t* q, const uint8_t* lo, const float* s,
        void* out, int M, int N, int K, cudaStream_t stream) {
  T* o = static_cast<T*>(out);
  return lo ? gemm<T, true>(xq, sx, q, lo, s, o, M, N, K, stream)
            : gemm<T, false>(xq, sx, q, lo, s, o, M, N, K, stream);
}

}  // namespace ovla_w8

// Returns the launches' cudaError_t (0 on success). x_kind: 0 = the codes xq int8 [M, K] and
// scales sx fp32 [M] are given (x unused), 1 = x fp32 [M, K], 2 = x bf16 [M, K], whose codes and
// scales the pre-pass writes into xq and sx. q: int8 codes [N, K] when lo is null, else the hi
// plane, lo the lo plane, both packed uint8 [N, K / 2], with float activations only. s fp32
// [N]; out [M, N], bf16 when out_bf16 else fp32. All contiguous and 16-byte aligned; K a
// multiple of 16 (of 32 for planes), N a multiple of 8.
extern "C" int ovla_w8a8_matmul(const void* x, void* xq, void* sx, const void* q, const void* lo,
                                const void* s, void* out, int M, int N, int K, int x_kind,
                                int out_bf16, void* stream) {
  if (M < 1 || N < 8 || N % 8 != 0 || K < 16 || K % (lo ? 32 : 16) != 0 || x_kind < 0 ||
      x_kind > 2 || (x_kind && !x) || (lo && !x_kind))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* codes = static_cast<int8_t*>(xq);
  float* scales = static_cast<float*>(sx);
  if (x_kind) {
    // for nibble planes, the codes in the k order of the packed-code fragments
    using ovla_i8::quant_rows;
    cudaError_t err;
    if (x_kind == 2)
      err = lo ? quant_rows<__nv_bfloat16, true, false>(x, codes, scales, nullptr, M, K, st)
               : quant_rows<__nv_bfloat16, false, false>(x, codes, scales, nullptr, M, K, st);
    else
      err = lo ? quant_rows<float, true, false>(x, codes, scales, nullptr, M, K, st)
               : quant_rows<float, false, false>(x, codes, scales, nullptr, M, K, st);
    if (err != cudaSuccess) return int(err);
  }
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const uint8_t* lp = static_cast<const uint8_t*>(lo);
  const float* sp = static_cast<const float*>(s);
  if (out_bf16) return ovla_w8::run<__nv_bfloat16>(codes, scales, qp, lp, sp, out, M, N, K, st);
  return ovla_w8::run<float>(codes, scales, qp, lp, sp, out, M, N, K, st);
}
