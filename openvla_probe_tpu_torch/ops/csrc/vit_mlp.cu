// Fused int8 (w8a8) kernels of a quantized ViT tower block:
//
//   fused_ln_w8a8       out = [res +] [ls ·] (w8a8(LN?(x)) + b)        (qkv entry, proj exit)
//   fused_mlp_residual  out = x + ls2 · (w8a8_fc2(act(w8a8_fc1(LN2(x)) + b1)) + b2)
//
// Replace the TPU kernels openvla_probe_tpu/ops/vit_mlp.py::_ln_w8a8_kernel
// (through fused_ln_w8a8) and ::_vit_mlp_kernel (through fused_mlp_residual).
// Cast points kept exactly: LayerNorm in fp32, rounded to the input type T;
// per-row sx = max(max|h| / 127, 1e-8) from the rounded value; codes
// clip(rint(h / sx), -127, 127) with an IEEE division and round-half-even;
// the int8 x int8 product accumulated in int32 (exact, so any order and any
// zero-filled tail give the same integer); ((acc · sx) · s) in fp32, cast to
// T; bias add, LayerScale multiply and residual add each in T (fp32 op, one
// rounding); activation in fp32, cast to T. Built without fast math, and every
// fp32 op whose contraction into an FMA would change its rounding is written
// with the _rn intrinsics.
//
// Bound on the H100 at the OpenVLA-7B shapes (B = 24; DINOv2 M = 6264,
// D = 1024, F = 4096; SigLIP M = 6144, D = 1152, F = 4304): the products are
// 13-105 GOP a call against 15-40 MB, so both are bound by int8 tensor-core
// operations (7-53 us at 1979 TOP/s).
//
// Design: pre-passes plus the int8 wgmma core that w8a8_matmul runs on
// (int8_wgmma.cuh: a producer warpgroup's TMA ring, two consumer warpgroups on
// a persistent grid, 256- or 128-row tiles by its `tile_rows` rule; the
// split-K decode route of int8_decode.cuh at M <= 64), each GEMM with the
// EpiAffine functor below, staged through shared memory so that the residual
// reads and the stores are whole rows. One call is a chain of launches on one
// stream:
//   * fused_ln_w8a8: ln_quant_rows (LayerNorm, quantize; int8_mma.cuh) or
//     quant_rows writes the codes [M, K] and sx [M] once (the earlier kernel
//     redid each row's LayerNorm for every column block), then the GEMM
//     (scales, bias, [LayerScale], [residual]);
//   * fused_mlp_residual: ln_quant_rows (LN2) -> the fc1 GEMM (scales, bias)
//     writes y [M, F] in T to device memory (51 MB at DINOv2, through L2) ->
//     quant_rows over whole rows of y, applying the activation as it reads
//     them (g = rt(act(y)): the row max over all of F is exact in any order,
//     and the GELU runs at that pass's full occupancy, not in the GEMM's
//     epilogue) -> the fc2 GEMM (scales, bias, LayerScale, + x). fc2's K tail
//     at SigLIP's F = 4304 is zero-filled by TMA, which adds nothing to the
//     int32 sums.
// Launch-weighted over the towers at B = 24 on an H100 80GB HBM3 at 700 W
// (tools/kernel_ab.py, in turns with the earlier kernels; PERF.md §6):
// fused_mlp_residual 1.171 -> 0.272 ms, fused_ln_w8a8 0.264 -> 0.079. What is
// left is mostly the GEMMs' epilogues at the towers' short K (with no
// epilogue at all: 0.172 / 0.035) and, in the MLP, y's round trip and its
// quantize pass (without them: 0.199).
// The earlier kernels copied the TPU kernels' plan (a block's rows resident in
// shared memory, the weights streamed past them through a cp.async ring with
// one barrier a 16 KB chunk on mma.sync; the MLP's [32, F] intermediate in
// shared memory on a cluster of two, F <= 8192): latency-bound.
#include "int8_wgmma.cuh"

#include <math.h>

#include <type_traits>

namespace ovla_vm {

using ovla_i8::rt;
using ovla_i8::to_f32;

// activation in fp32, the same expressions as PyTorch's CUDA GELU
__device__ __forceinline__ float act_f32(float x, int act) {
  if (act == 0) return x * 0.5f * (1.0f + erff(x * float(M_SQRT1_2)));           // gelu (erf)
  if (act == 1) {                                                                 // gelu_tanh
    const float kBeta = float(M_SQRT2 * M_2_SQRTPI * 0.5), kKappa = 0.044715f;
    const float inner = kBeta * (x + kKappa * (x * x * x));
    return 0.5f * x * (1.0f + tanhf(inner));
  }
  return x * (1.0f / (1.0f + expf(-(1.702f * x))));                               // quick_gelu
}

// y = rt((f32(acc) · sx) · s); y = rt(y + b); [y = rt(y · ls)]; [out = rt(rowop + y)]: the
// qkv entry and fc1 (no ls, no rowop), the proj exit (rowop = res, DINOv2's ls) and fc2
// (rowop = x, ls2). In bf16 the steps after the first rounding are bf16x2 operations on two
// outputs at once (add.bf16x2, mul.bf16x2: the exact sum or product of two bf16 values rounded
// once, which is what rounding their fp32 sum or product to bf16 gives, fp32 holding the exact
// product and more than 2 · 8 + 2 bits of any sum), the first rounding one cvt.rn.bf16x2.f32 for
// both: the epilogue is the tiles' bound at these shapes, and each fp32 <-> bf16 conversion runs
// at a quarter of the arithmetic rate.
template <typename T>
struct EpiAffine {
  static constexpr bool kStaged = true;
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  struct Col {
    float s = 0.f, b = 0.f, ls = 1.f;
    __nv_bfloat162 b2, ls2;   // bf16: (b, b) and (ls, ls)
  };
  const float* sx;
  const float* s;
  const T* b;
  const T* ls;      // nullptr: no LayerScale
  const T* rowop;   // nullptr, or [M, N]: added last
  int N;
  // read-only loads (ld.global.nc), as every operand below
  __device__ __forceinline__ Col col(int n) const {
    Col c;
    c.s = __ldg(s + n);
    const T bn = __ldg(b + n), lsn = ls ? __ldg(ls + n) : T(1.f);
    c.b = to_f32(bn), c.ls = to_f32(lsn);
    if constexpr (kBf16) c.b2 = __halves2bfloat162(bn, bn), c.ls2 = __halves2bfloat162(lsn, lsn);
    return c;
  }
  __device__ __forceinline__ float row(int m) const { return __ldg(sx + m); }
  __device__ __forceinline__ float head(int acc, float sxm, const Col& c) const {
    float y = rt<T>(__fmul_rn(__fmul_rn(__int2float_rn(acc), sxm), c.s));
    y = rt<T>(__fadd_rn(y, c.b));
    if (ls) y = rt<T>(__fmul_rn(y, c.ls));
    return y;
  }
  __device__ __forceinline__ void head2(int a0, int a1, float s0, float s1, const Col& c, T& y0,
                                        T& y1) const {
    if constexpr (kBf16) {
      __nv_bfloat162 y = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(__int2float_rn(a0), s0), c.s),
                                               __fmul_rn(__fmul_rn(__int2float_rn(a1), s1), c.s));
      y = __hadd2(y, c.b2);
      if (ls) y = __hmul2(y, c.ls2);
      y0 = __low2bfloat16(y), y1 = __high2bfloat16(y);
    } else {
      y0 = head(a0, s0, c), y1 = head(a1, s1, c);
    }
  }
  __device__ __forceinline__ uint4 add_rows(const uint4& r, const uint4& y) const {
    uint4 o;
    const uint32_t* rw = &r.x;
    const uint32_t* yw = &y.x;
    uint32_t* ow = &o.x;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kBf16) {
        const __nv_bfloat162 v = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(rw + i),
                                         *reinterpret_cast<const __nv_bfloat162*>(yw + i));
        ow[i] = *reinterpret_cast<const uint32_t*>(&v);
      } else {
        ow[i] = __float_as_uint(__fadd_rn(__uint_as_float(rw[i]), __uint_as_float(yw[i])));
      }
    }
    return o;
  }
  __device__ __forceinline__ float tail(float y, long long o) const {
    return rowop ? __fadd_rn(to_f32(__ldg(rowop + o)), y) : y;
  }
  __device__ __forceinline__ float operator()(int acc, int m, int n) const {
    return tail(head(acc, row(m), col(n)), (long long)m * N + n);
  }
};

// g = rt(act(y)) from fc1's y = rt(rt((f32(acc) · sx) · s) + b): applied by g's quantize pass
// as it reads y, at that kernel's full occupancy (an epilogue of 8 consumer warps an SM spent
// 0.11 ms of fc1's 0.19 at DINOv2 on it)
template <typename T>
struct ActRT {
  int act;
  __device__ __forceinline__ float operator()(float y) const { return rt<T>(act_f32(y, act)); }
};

template <typename T>
int fused_ln_w8a8(const void* x, const void* ln_s, const void* ln_b, const void* q, const void* s,
                  const void* b, const void* res, const void* ls, void* out, int M, int K, int N,
                  float eps, int8_t* codes, float* sx, cudaStream_t st) {
  const cudaError_t err =
      ln_s ? ovla_i8::ln_quant_rows<T>(x, ln_s, ln_b, eps, codes, sx, M, K, st)
           : ovla_i8::quant_rows<T, false, false>(x, codes, sx, nullptr, M, K, st);
  if (err != cudaSuccess) return int(err);
  const EpiAffine<T> epi{sx, static_cast<const float*>(s), static_cast<const T*>(b),
                         static_cast<const T*>(ls), static_cast<const T*>(res), N};
  return ovla_wg::run_int8(codes, static_cast<const int8_t*>(q), epi, static_cast<T*>(out), M, N,
                           K, st);
}

template <typename T>
int fused_mlp(const void* x, const void* ln_s, const void* ln_b, const void* q1, const void* s1,
              const void* b1, const void* q2, const void* s2, const void* b2, const void* ls2,
              void* out, int M, int D, int F, float eps, int act, int8_t* h8, float* sx1,
              int8_t* g8, float* sx2, cudaStream_t st) {
  T* y = reinterpret_cast<T*>(g8 + (long long)M * F);   // fc1's y [M, F] in T, after g's codes
  cudaError_t err = ovla_i8::ln_quant_rows<T>(x, ln_s, ln_b, eps, h8, sx1, M, D, st);
  if (err != cudaSuccess) return int(err);
  const EpiAffine<T> fc1{sx1, static_cast<const float*>(s1), static_cast<const T*>(b1), nullptr,
                         nullptr, F};
  int e = ovla_wg::run_int8(h8, static_cast<const int8_t*>(q1), fc1, y, M, F, D, st);
  if (e != 0) return e;
  err = ovla_i8::quant_rows<T, false, false>(y, g8, sx2, nullptr, M, F, st, ActRT<T>{act});
  if (err != cudaSuccess) return int(err);
  const EpiAffine<T> fc2{sx2, static_cast<const float*>(s2), static_cast<const T*>(b2),
                         static_cast<const T*>(ls2), static_cast<const T*>(x), D};
  return ovla_wg::run_int8(g8, static_cast<const int8_t*>(q2), fc2, static_cast<T*>(out), M, D, F,
                           st);
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace ovla_vm

// Both return the first failing launch's cudaError_t (0 on success), and launch nothing for
// arguments they refuse (cudaErrorInvalidValue). All tensors contiguous; x, the weight codes
// and the code buffers 16-byte aligned (the pre-passes' vector loads and the TMA maps).
//
// fused_ln_w8a8: x [M, K] in T (bf16 when is_bf16, else fp32), K a multiple of 16; ln_s, ln_b [K]
// or both null (no LayerNorm); q int8 [N, K]; s fp32 [N]; b [N]; res [M, N] or null; ls [N] or
// null; out [M, N]. codes_out int8 [M, K] and sx_out fp32 [M]: the pre-pass writes the
// activation codes and scales there and the GEMM reads them (required).
extern "C" int ovla_fused_ln_w8a8(const void* x, const void* ln_s, const void* ln_b,
                                  const void* q, const void* s, const void* b, const void* res,
                                  const void* ls, void* out, int M, int K, int N, float eps,
                                  void* codes_out, void* sx_out, int is_bf16, void* stream) {
  using ovla_vm::misaligned;
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || !codes_out || !sx_out || !ln_s != !ln_b ||
      misaligned(x) || misaligned(q) || misaligned(codes_out) || misaligned(ln_s) ||
      misaligned(ln_b))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* codes = static_cast<int8_t*>(codes_out);
  float* sx = static_cast<float*>(sx_out);
  if (is_bf16)
    return ovla_vm::fused_ln_w8a8<__nv_bfloat16>(x, ln_s, ln_b, q, s, b, res, ls, out, M, K, N,
                                                 eps, codes, sx, st);
  return ovla_vm::fused_ln_w8a8<float>(x, ln_s, ln_b, q, s, b, res, ls, out, M, K, N, eps, codes,
                                       sx, st);
}

// fused_mlp_residual: x [M, D] in T, D and F multiples of 16; ln_s, ln_b [D]; q1 int8 [F, D], s1
// fp32 [F], b1 [F]; q2 int8 [D, F], s2 fp32 [D], b2 [D], ls2 [D]; out [M, D]; act 0 gelu,
// 1 gelu_tanh, 2 quick_gelu. Buffers (required): h8_out int8 [M, D] and sx1_out fp32 [M], the LN2
// codes and scales; g8_out M · F · (1 + sizeof(T)) bytes: g's codes [M, F], then fc1's output y
// [M, F] in T (g = act(y)); sx2_out fp32 [M], g's row scales.
extern "C" int ovla_fused_mlp_residual(const void* x, const void* ln_s, const void* ln_b,
                                       const void* q1, const void* s1, const void* b1,
                                       const void* q2, const void* s2, const void* b2,
                                       const void* ls2, void* out, int M, int D, int F, float eps,
                                       int act, void* h8_out, void* sx1_out, void* g8_out,
                                       void* sx2_out, int is_bf16, void* stream) {
  using ovla_vm::misaligned;
  if (M < 1 || D < 16 || F < 16 || D % 16 != 0 || F % 16 != 0 || act < 0 || act > 2 || !ln_s ||
      !ln_b || !h8_out || !sx1_out || !g8_out || !sx2_out || misaligned(x) || misaligned(ln_s) ||
      misaligned(ln_b) || misaligned(q1) || misaligned(q2) || misaligned(h8_out) ||
      misaligned(g8_out))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* h8 = static_cast<int8_t*>(h8_out);
  int8_t* g8 = static_cast<int8_t*>(g8_out);
  float* sx1 = static_cast<float*>(sx1_out);
  float* sx2 = static_cast<float*>(sx2_out);
  if (is_bf16)
    return ovla_vm::fused_mlp<__nv_bfloat16>(x, ln_s, ln_b, q1, s1, b1, q2, s2, b2, ls2, out, M,
                                             D, F, eps, act, h8, sx1, g8, sx2, st);
  return ovla_vm::fused_mlp<float>(x, ln_s, ln_b, q1, s1, b1, q2, s2, b2, ls2, out, M, D, F, eps,
                                   act, h8, sx1, g8, sx2, st);
}
