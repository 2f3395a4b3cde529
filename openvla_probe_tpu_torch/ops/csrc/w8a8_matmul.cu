// w8a8_matmul: out[M, N] = cast((f32(Σ_k x8[m, k] · q8[n, k]) · s_x[m]) · s[n]), per-row int8
// activation codes times per-channel int8 weight codes.
//
// Replaces the XLA op openvla_probe_tpu/ops/linear.py::_w8a8_dot (the turbo tier's int8 linears,
// the prefill of nibble weights through _nib_matmul, the int4 requant route) and the prequant
// branch of its matmul_t (codes handed over by the fused RMSNorm -> int8 kernel). Semantics kept
// bit for bit:
//   * per-row codes clip(rint(x / s_x), -127, 127) with s_x = max(max|x| / 127, 1e-8) and IEEE
//     divisions (round half to even, as jnp.round), or the given codes and scales;
//   * the exact int32 product (|sum| <= 127² · K < 2³¹ for K < 133,000), so no order of its
//     terms, no split of K and no order of adding the splits changes a bit;
//   * out = cast((f32(acc) · s_x) · s), the conversion and the two products each rounded once
//     (the _rn intrinsics: nvcc would not contract them, but they say so).
// Weight codes come in one of two forms:
//   * int8 [N, K];
//   * two nibble planes hi, lo, packed uint8 [N, K / 2] (byte j: code 2j in its low nibble,
//     2j + 1 in its high nibble, two's complement), whose exact int8 codes 16·hi + lo + 8 the
//     loader rebuilds in registers (openvla_probe_tpu/ops/linear.py::nibble_reconstruct_q8 fused
//     in; int8_mma.cuh rebuild). The same codes give the same output in both forms.
//
// Bound on the H100 at the OpenVLA-7B shapes: prefill and towers (M = 6144-6912) and train
// steps (M = 2560) by int8 tensor-core operations, 0.117 ms for 6912 x 4096 x 4096 at
// 1979 TOP/s; decode (M = 24) by the weight stream, 16.8 MB per 4096 x 4096 launch (5.0 us at
// 3.35 TB/s). The earlier kernels (mma.sync from ldmatrix fragments, every thread's cp.async
// copies, one barrier a chunk) took 0.480 ms (int8) and 0.573 (nibble) at 6912 x 4096 x 4096
// and 0.027 at 24 x 4096 x 4096 on an H100 80GB HBM3 at 700 W (PERF.md §6).
//
// ovla_w4a8_requant (the int4 requant route, openvla_probe_tpu/ops/linear.py::_w4a8_dot_requant):
// the same GEMM with grouped int4 weights requantized to int8 in the weight loader (W::kInt4 of
// int8_wgmma.cuh and int8_decode.cuh): no [N, K] int8 copy, no op before the launch but the
// activation pre-pass. Bound at its 7B shapes: lm_head at decode by the int4 codes' 66 MB
// (0.021 ms at 3.35 TB/s); SigLIP's fc1 (6144 x 1152 x 4304) and a train step's lm_head
// (2560 x 4096 x 32064) by int8 operations. The route it replaces (the requant as seven PyTorch
// ops making a 131 MB int8 copy at lm_head, then this GEMM) took 3.242 ms at lm_head decode and
// 0.314 at SigLIP's fc1 on an H100 80GB HBM3 at 700 W (PERF.md §6).
//
// One call makes one or two launches: for float activations the pre-pass (quant_rows,
// int8_mma.cuh) writes the codes [M, K] and s_x [M] (for nibble planes each 32-code block in
// the stored_offset k order the packed fragments take); then one of two GEMM routes.
//
// M > 64 (prefill, towers, train steps): the int8 wgmma core of int8_wgmma.cuh (a producer
// warpgroup's TMA ring, two consumer warpgroups computing outᵀ on a persistent grid), with the
// EpiW8 epilogue (int8_decode.cuh): s_x and s applied by the two _rn products, bf16 or fp32 stored
// direct, columns past N and rows past M masked. int8 weights: kBM = 256 (m64n256, wgmma's
// shared-memory A); nibble planes: kBM = 192 (m64n192, rebuilt in registers into its register A).
// What bounds it (knock-out builds timed by tools/kernel_ab.py on an H100 80GB HBM3 at 700 W,
// PERF.md §6): at 6912 x 4096 x 4096 on the prequant codes (0.185 ms) the ring's handoffs, not
// its bytes nor the products: with no products 0.176, with no activation-code loads (2/3 of
// the bytes) 0.178, with half the stages 0.244; then the epilogue's stores (none: 0.148).
// The persistent grid took 0-7 % off a grid of one block a tile at the prefill shapes (and
// added up to 3 % at three of the towers' eight).
// M <= 64 (decode steps, lm_head): the split-K decode route of int8_decode.cuh, int8 codes or
// the two planes rebuilt in registers.
#include "int8_wgmma.cuh"

namespace ovla_w8 {

template <typename T>
int run(const int8_t* xq, const float* sx, const uint8_t* q, const uint8_t* lo, const float* s,
        void* out, int M, int N, int K, cudaStream_t stream) {
  namespace d = ovla_i8d;
  T* o = static_cast<T*>(out);
  const d::EpiW8 epi{sx, s};
  if (M <= 64)
    return lo ? d::launch<d::W::kNibble>(xq, q, lo, epi, o, M, N, K, stream)
              : d::launch<d::W::kInt8>(xq, q, lo, epi, o, M, N, K, stream);
  return lo ? ovla_wg::launch_wgmma<T, d::W::kNibble, 192>(xq, q, lo, epi, o, M, N, K, stream)
            : ovla_wg::launch_wgmma<T, d::W::kInt8, 256>(xq, q, lo, epi, o, M, N, K, stream);
}

// the int4 requant route: grouped int4 codes requantized to int8 in the weight loader, the
// epilogue's s the rows' s8 (computed in the kernel; the functor's s unused)
template <typename T>
int run_requant(const int8_t* xq, const float* sx, const uint8_t* q, const ovla_i8d::Groups& grp,
                void* out, int M, int N, int K, cudaStream_t stream) {
  namespace d = ovla_i8d;
  T* o = static_cast<T*>(out);
  const d::EpiW8 epi{sx, nullptr};
  if (M <= 64) return d::launch<d::W::kInt4>(xq, q, nullptr, epi, o, M, N, K, stream, grp);
  return ovla_wg::launch_wgmma<T, d::W::kInt4, 192>(xq, q, nullptr, epi, o, M, N, K, stream, grp);
}

// The row-parallel product (tensor parallelism with the contraction split over ranks, which XLA
// partitions _w8a8_dot into): the rank's row absmax (before the ranks' MAX all-reduce), codes
// from the row scale given after it, the exact int32 partial of the rank's K slice (summed across
// ranks in int32), then the epilogue.
//
// The absmax and the codes are one block a row (grid.x: any M), each thread walking the row in
// 16-byte loads. Both are bound by bytes on the H100: at 6912 x 5504 bf16 rows the codes read
// 76 MB and write 38 MB (0.034 ms at 3.35 TB/s), the absmax reads 76 MB (0.023 ms). The earlier
// pre-pass (one thread a code, a 2-byte load and a 1-byte store each) took 0.129 ms there on an
// H100 80GB HBM3 at 700 W (PERF.md §6).

constexpr float kMagic = 12582912.f;   // 1.5 · 2^23: t + kMagic rounds t half to even

// Threads a row for `units` pieces of work: up to 256 at prefill and tower rows (a row of up to
// 256 pieces in one pass: SigLIP fc2's 135 code units at 6144 x 2160 took 0.0208 ms against
// 0.0243 at 128 threads a row), up to 512 at decode rows (M <= 64: a few blocks, each with fewer
// dependent loads a thread; quant_rows' reading, int8_mma.cuh), never more warps than the row has
// pieces. (H100 80GB HBM3 at 700 W, tools/kernel_ab.py; PERF.md §6.)
inline int row_threads(int M, long long units) {
  const long long cap = M <= 64 ? 512 : 256, t = (units + 31) / 32 * 32;
  return int(t < cap ? t : cap);
}

// max|x| over a row, as the fp32 [M] x.abs().amax(-1).float(): the max of the magnitudes' bit
// patterns, sign bits cleared (nonnegative floats order as their bits; a NaN's pattern is above
// every number's, so a NaN propagates as in amax). A row is read as 32-bit words, W a load: 4
// (16 bytes) where a row's bytes are a multiple of 16, else 2 (bf16 rows with K % 8 = 4).
template <bool BF16, int W>
__global__ void __launch_bounds__(512)
    row_absmax_kernel(const uint32_t* __restrict__ x, float* __restrict__ amax, int words) {
  __shared__ uint32_t red[16];
  const uint32_t* xr = x + (long long)blockIdx.x * words;
  constexpr uint32_t kMask = BF16 ? 0x7FFF7FFFu : 0x7FFFFFFFu;
  uint32_t m = 0;
#pragma unroll 4
  for (int w = W * threadIdx.x; w < words; w += W * blockDim.x) {
    uint32_t v[W];
    if constexpr (W == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + w);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(xr + w);
      v[0] = u.x, v[1] = u.y;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) m = BF16 ? __vmaxu2(m, v[i] & kMask) : max(m, v[i] & kMask);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t other = __shfl_xor_sync(0xffffffffu, m, o);
    m = BF16 ? __vmaxu2(m, other) : max(m, other);
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < int(blockDim.x / 32); ++i) m = BF16 ? __vmaxu2(m, red[i]) : max(m, red[i]);
    if constexpr (BF16) m = max(m & 0xFFFFu, m >> 16) << 16;   // the bf16 value's fp32 bits
    amax[blockIdx.x] = __uint_as_float(m);
  }
}

// The codes clip(rint(v / s), -127, 127) of 16 values in the low bytes of c (two's complement),
// with IEEE quotients (as quant_code): clipped, then rounded half to even by adding 1.5 · 2^23
// (rint is monotone and ±127 are integers, so clip(rint(q)) = rint(clip(q)); a NaN clips to
// -127, as quant_code's fmaxf does), the low byte of the sum's bits then the code. No
// conversion instruction: those run at a quarter of the FMA rate.
__device__ __forceinline__ void given_codes(const float (&v)[16], float s, uint32_t (&c)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    c[i] = __float_as_uint(__fadd_rn(fminf(fmaxf(__fdiv_rn(v[i], s), -127.f), 127.f), kMagic));
}

// VW values of a row at p as fp32: one 16-byte load (VW = 8 bf16 or 4 fp32 values) or, for bf16
// rows whose length is not a multiple of 8 (rows not 16-byte aligned), one 8-byte load of 4
template <typename T, int VW>
__device__ __forceinline__ void load_vw(const T* p, float* v) {
  if constexpr (VW == 8) {   // bf16: a value's fp32 bits are its 16 bits shifted up
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[2 * i] = __uint_as_float(w[i] << 16), v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  } else {
    float f[4];
    ovla_i8::load4(p, f);
    v[0] = f[0], v[1] = f[1], v[2] = f[2], v[3] = f[3];
  }
}

// xq[m, k] = clip(rint(x[m, k] / sx[m]), -127, 127) for k < Kv, 0 for Kv <= k < Kp (zero codes
// against a weight padded with zero codes: the int32 sum unchanged). A thread makes 16 codes
// [k, k + 16) at a time (Kp a multiple of 16: the pad columns are whole units): the values in
// 16-byte loads (VW values each; a row's one unit that straddles Kv loads only the vectors
// before it, Kv a multiple of VW), the codes by given_codes, one 16-byte store; PERM stores each
// 32-code block in the packed fragments' k order (nibble planes), stored_offset: codes k..k+3
// and k+8..k+11 of a unit at (k & ~31) + 8h, k+4..k+7 and k+12..k+15 at (k & ~31) + 16 + 8h,
// h = (k / 16) & 1, two 8-byte stores. At 6912 x 5504 (0.0437 ms on an H100 80GB HBM3 at 700 W,
// bound 0.034) its loads and its stores do not overlap: with no stores it took 0.0327, with no
// loads 0.0312. Neither the quotient by a reciprocal product (one division a row, the exact one
// only near a tie: 63 registers against 40, 0.0484) nor two units' loads in flight a thread
// (0.0445) took less (tools/kernel_ab.py, PERF.md §6).
template <typename T, int VW, bool PERM>
__global__ void __launch_bounds__(512)
    quant_given_kernel(const T* __restrict__ x, const float* __restrict__ sx,
                       int8_t* __restrict__ xq, int Kv, int Kp) {
  const T* xr = x + (long long)blockIdx.x * Kv;
  int8_t* qr = xq + (long long)blockIdx.x * Kp;
  const float s = __ldg(sx + blockIdx.x);
#pragma unroll 2
  for (int k = 16 * threadIdx.x; k < Kp; k += 16 * blockDim.x) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};   // a unit past Kv: zero codes
    if (k < Kv) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16 / VW; ++j) {
        if (k + VW * j < Kv) {
          load_vw<T, VW>(xr + k + VW * j, v + VW * j);
        } else {
#pragma unroll
          for (int i = 0; i < VW; ++i) v[VW * j + i] = 0.f;
        }
      }
      uint32_t c[16];
      given_codes(v, s, c);
#pragma unroll
      for (int i = 0; i < 4; ++i)   // codes 4i..4i+3, zero past Kv (Kv a multiple of 4)
        w[i] = k + 4 * i < Kv ? __byte_perm(__byte_perm(c[4 * i], c[4 * i + 1], 0x0040),
                                            __byte_perm(c[4 * i + 2], c[4 * i + 3], 0x0040),
                                            0x5410)
                              : 0u;
    }
    if constexpr (PERM) {
      int8_t* b = qr + (k & ~31) + 8 * ((k >> 4) & 1);
      *reinterpret_cast<uint2*>(b) = make_uint2(w[0], w[2]);
      *reinterpret_cast<uint2*>(b + 16) = make_uint2(w[1], w[3]);
    } else {
      *reinterpret_cast<uint4*>(qr + k) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// out[m, n] = cast((f32(acc[m, n]) · sx[m]) · s[n]), each product rounded once: EpiW8's
// arithmetic. A 2-D grid: blocks of kEpiRows rows (grid.x, any M) by 256 columns (grid.y, each
// block's tiles 256 · gridDim.y columns apart where N needs more than 65535 tiles), a thread 8
// outputs of a row: two 16-byte loads of acc, s[n .. n + 8) as two float4 __ldg (N · 4 bytes,
// resident in L1 / L2), sx[m] once, one 16-byte bf16 store or two float4 stores. Bound by bytes on
// the H100: 6912 x 4096 reads 113 MB and writes 57 MB of bf16 (0.051 ms at 3.35 TB/s); the
// earlier kernel (one output a thread, a 64-bit division for its row and column) took 0.104 ms on
// an H100 80GB HBM3 at 700 W (PERF.md §6). VEC = N % 8 == 0 (every row 16-byte aligned);
// otherwise the same threads and outputs, element by element (the rule, not a fallback).
constexpr int kEpiRows = 8;

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * kEpiRows)
    epilogue_kernel(const int* __restrict__ acc, const float* __restrict__ sx,
                    const float* __restrict__ s, T* __restrict__ out, int M, int N) {
  const long long m = (long long)blockIdx.x * kEpiRows + threadIdx.y;
  if (m >= M) return;
  const float r = __ldg(sx + m);
  for (long long n = 8LL * (blockIdx.y * 32 + threadIdx.x); n < N; n += 256LL * gridDim.y) {
    const long long i = m * N + n;
    if constexpr (VEC) {
      const int4 a0 = __ldg(reinterpret_cast<const int4*>(acc + i));
      const int4 a1 = __ldg(reinterpret_cast<const int4*>(acc + i + 4));
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(s + n));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + n + 4));
      const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __fmul_rn(__fmul_rn(__int2float_rn(a[j]), r), sc[j]);
      if constexpr (sizeof(T) == 2) {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
          w[j] = *reinterpret_cast<const uint32_t*>(&b);
        }
        *reinterpret_cast<uint4*>(out + i) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        *reinterpret_cast<float4*>(out + i) = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(out + i + 4) = make_float4(o[4], o[5], o[6], o[7]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n + j < N)
          ovla_i8d::store1(out + i + j, __fmul_rn(__fmul_rn(__int2float_rn(__ldg(acc + i + j)), r),
                                                  __ldg(s + n + j)));
    }
  }
}

int run_i32(const int8_t* xq, const uint8_t* q, const uint8_t* lo, int* acc, int M, int N, int K,
            cudaStream_t stream) {
  namespace d = ovla_i8d;
  const d::EpiI32 epi{};
  if (M <= 64)
    return lo ? d::launch<d::W::kNibble>(xq, q, lo, epi, acc, M, N, K, stream)
              : d::launch<d::W::kInt8>(xq, q, lo, epi, acc, M, N, K, stream);
  return lo ? ovla_wg::launch_wgmma<int, d::W::kNibble, 192>(xq, q, lo, epi, acc, M, N, K, stream)
            : ovla_wg::launch_wgmma<int, d::W::kInt8, 256>(xq, q, lo, epi, acc, M, N, K, stream);
}

}  // namespace ovla_w8

namespace {
bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }
}  // namespace

// Returns the launches' cudaError_t (0 on success). x_kind: 0 = the codes xq int8 [M, K] and
// scales sx fp32 [M] are given (x unused), 1 = x fp32 [M, K], 2 = x bf16 [M, K], whose codes and
// scales the pre-pass writes into xq and sx. q: int8 codes [N, K] when lo is null, else the hi
// plane, lo the lo plane, both packed uint8 [N, K / 2], with float activations only. s fp32
// [N]; out [M, N], bf16 when out_bf16 else fp32. All contiguous; x, xq, q and lo 16-byte
// aligned (the TMA maps); K a multiple of 16 (of 32 for planes), N a multiple of 8; M up to
// 65535 · 192 (the tile count stays an int).
extern "C" int ovla_w8a8_matmul(const void* x, void* xq, void* sx, const void* q, const void* lo,
                                const void* s, void* out, int M, int N, int K, int x_kind,
                                int out_bf16, void* stream) {
  if (M < 1 || N < 8 || N % 8 != 0 || K < 16 || K % (lo ? 32 : 16) != 0 || x_kind < 0 ||
      x_kind > 2 || (x_kind && !x) || (lo && !x_kind) || (M + 191) / 192 > 65535 ||
      misaligned(x) || misaligned(xq) || misaligned(q) || misaligned(lo))
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

// The int4 requant route (openvla_probe_tpu/ops/linear.py::_w4a8_dot_requant, XLA on the TPU):
// out = w8a8(x, requant(q, s)) with the int8 codes and their per-row scales s8 made in the GEMM's
// weight loader, in registers (int8_mma.cuh requant_lut / requant), so no [N, K] int8 copy
// exists. Returns the launches' cudaError_t (0 on success). x [M, K] (bf16 when is_bf16, else
// fp32), scratch xq int8 [M, K] and sx fp32 [M] (the pre-pass writes the codes in the
// stored_offset k order of the packed fragments), q packed uint8 [G][N][gsz / 2] (group-major),
// s fp32 [N][G], out [M, N] in x's type. All contiguous; x, xq and q 16-byte aligned; gsz a
// multiple of 32 (each 32-deep k step in one group; the wrapper refuses other group sizes),
// K = G · gsz, N a multiple of 8.
extern "C" int ovla_w4a8_requant(const void* x, void* xq, void* sx, const void* q, const void* s,
                                 void* out, int M, int N, int G, int gsz, int is_bf16,
                                 void* stream) {
  const long long K = (long long)G * gsz;
  if (M < 1 || N < 8 || N % 8 != 0 || G < 1 || gsz < 32 || gsz % 32 != 0 || K > (1 << 30) ||
      (M + 191) / 192 > 65535 || !x || !s || misaligned(x) || misaligned(xq) || misaligned(q))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* codes = static_cast<int8_t*>(xq);
  float* scales = static_cast<float*>(sx);
  using ovla_i8::quant_rows;
  const cudaError_t err =
      is_bf16 ? quant_rows<__nv_bfloat16, true, false>(x, codes, scales, nullptr, M, int(K), st)
              : quant_rows<float, true, false>(x, codes, scales, nullptr, M, int(K), st);
  if (err != cudaSuccess) return int(err);
  const ovla_i8d::Groups grp{static_cast<const float*>(s), G, gsz};
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  if (is_bf16)
    return ovla_w8::run_requant<__nv_bfloat16>(codes, scales, qp, grp, out, M, N, int(K), st);
  return ovla_w8::run_requant<float>(codes, scales, qp, grp, out, M, N, int(K), st);
}

// The row-parallel product's local row absmax: amax fp32 [M] = max |x[m, :]| of x [M, K] (bf16
// when x_bf16, else fp32), bit-equal to x.abs().amax(-1).float(). K a multiple of 4, x 16-byte
// aligned; any M >= 1. Returns the launch's cudaError_t.
extern "C" int ovla_w8a8_row_absmax(const void* x, void* amax, int M, int K, int x_bf16,
                                    void* stream) {
  if (M < 1 || K < 4 || K % 4 != 0 || !x || !amax || misaligned(x))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = x_bf16 ? K / 2 : K;      // 32-bit words a row
  const bool wide = words % 4 == 0;          // 16-byte loads, else 8-byte (bf16, K % 8 = 4)
  const int thr = ovla_w8::row_threads(M, words / (wide ? 4 : 2));
  const auto* xp = static_cast<const uint32_t*>(x);
  float* out = static_cast<float*>(amax);
  using ovla_w8::row_absmax_kernel;
  if (x_bf16) {
    if (wide) row_absmax_kernel<true, 4><<<M, thr, 0, st>>>(xp, out, words);
    else row_absmax_kernel<true, 2><<<M, thr, 0, st>>>(xp, out, words);
  } else {
    row_absmax_kernel<false, 4><<<M, thr, 0, st>>>(xp, out, words);
  }
  return int(cudaGetLastError());
}

// The row-parallel product's pre-pass: codes xq int8 [M, Kp] of x [M, Kv] (bf16 when x_bf16,
// else fp32) from the given row scales sx fp32 [M] (zero past Kv; for nibble planes, `perm`,
// in the packed fragments' k order). Kv a multiple of 4, Kp >= Kv a multiple of 16 (of 32 with
// perm, and then Kp = Kv); x and xq 16-byte aligned; any M >= 1. bf16 rows take 16-byte loads
// where Kv % 8 = 0 (every row 16-byte aligned), 8-byte loads otherwise. Returns the launch's
// cudaError_t.
extern "C" int ovla_w8a8_quant_given(const void* x, const void* sx, void* xq, int M, int Kv,
                                     int Kp, int x_bf16, int perm, void* stream) {
  if (M < 1 || Kv < 4 || Kv % 4 != 0 || Kp < Kv || Kp % (perm ? 32 : 16) != 0 ||
      (perm && Kp != Kv) || !x || !sx || !xq || misaligned(x) || misaligned(xq))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int thr = ovla_w8::row_threads(M, Kp / 16);
  const float* s = static_cast<const float*>(sx);
  int8_t* c = static_cast<int8_t*>(xq);
  using ovla_w8::quant_given_kernel;
  if (x_bf16) {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    if (Kv % 8 == 0) {
      if (perm) quant_given_kernel<__nv_bfloat16, 8, true><<<M, thr, 0, st>>>(xp, s, c, Kv, Kp);
      else quant_given_kernel<__nv_bfloat16, 8, false><<<M, thr, 0, st>>>(xp, s, c, Kv, Kp);
    } else {   // perm needs Kv = Kp, a multiple of 32
      quant_given_kernel<__nv_bfloat16, 4, false><<<M, thr, 0, st>>>(xp, s, c, Kv, Kp);
    }
  } else {
    const auto* xp = static_cast<const float*>(x);
    if (perm) quant_given_kernel<float, 4, true><<<M, thr, 0, st>>>(xp, s, c, Kv, Kp);
    else quant_given_kernel<float, 4, false><<<M, thr, 0, st>>>(xp, s, c, Kv, Kp);
  }
  return int(cudaGetLastError());
}

// The row-parallel product's GEMM: acc int32 [M, N] = xq int8 [M, K] · q[N, K]ᵀ exactly, on the
// w8a8_matmul routes (wgmma above M = 64, the split-K decode route at and below) with the
// epilogue left out. q: int8 codes [N, K] when lo is null, else the hi plane and lo the lo plane,
// packed uint8 [N, K / 2] (xq then in the packed k order). xq, q and lo 16-byte aligned; K a
// multiple of 16 (of 32 for planes), N of 8. Returns the launch's cudaError_t.
extern "C" int ovla_w8a8_matmul_i32(const void* xq, const void* q, const void* lo, void* acc,
                                    int M, int N, int K, void* stream) {
  if (M < 1 || N < 8 || N % 8 != 0 || K < 16 || K % (lo ? 32 : 16) != 0 ||
      (M + 191) / 192 > 65535 || misaligned(xq) || misaligned(q) || misaligned(lo) || !acc)
    return int(cudaErrorInvalidValue);
  return ovla_w8::run_i32(static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(q),
                          static_cast<const uint8_t*>(lo), static_cast<int*>(acc), M, N, K,
                          static_cast<cudaStream_t>(stream));
}

// The row-parallel product's epilogue after the ranks' int32 SUM: out [M, N] (bf16 when
// out_bf16, else fp32) = cast((f32(acc) · sx[m]) · s[n]). Any M, N >= 1; acc, s and out 16-byte
// aligned. Returns the launch's cudaError_t.
extern "C" int ovla_w8a8_epilogue(const void* acc, const void* sx, const void* s, void* out,
                                  int M, int N, int out_bf16, void* stream) {
  using ovla_w8::kEpiRows;
  if (M < 1 || N < 1 || !acc || !sx || !s || !out || misaligned(acc) || misaligned(s) ||
      misaligned(out))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (N + 255LL) / 256;
  const dim3 grid(unsigned((M + kEpiRows - 1LL) / kEpiRows),
                  unsigned(tiles < 65535 ? tiles : 65535));
  const dim3 block(32, kEpiRows);
  const int* a = static_cast<const int*>(acc);
  const float* sxp = static_cast<const float*>(sx);
  const float* sp = static_cast<const float*>(s);
  using ovla_w8::epilogue_kernel;
  const bool vec = N % 8 == 0;
  if (out_bf16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    if (vec) epilogue_kernel<__nv_bfloat16, true><<<grid, block, 0, st>>>(a, sxp, sp, o, M, N);
    else epilogue_kernel<__nv_bfloat16, false><<<grid, block, 0, st>>>(a, sxp, sp, o, M, N);
  } else {
    auto* o = static_cast<float*>(out);
    if (vec) epilogue_kernel<float, true><<<grid, block, 0, st>>>(a, sxp, sp, o, M, N);
    else epilogue_kernel<float, false><<<grid, block, 0, st>>>(a, sxp, sp, o, M, N);
  }
  return int(cudaGetLastError());
}
