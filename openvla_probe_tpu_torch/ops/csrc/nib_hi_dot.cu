// nib_hi_dot: out[M, N] = cast(((f32(Σ_k x8[m, k] · hi[n, k]) · 16 + f32(Σ_k x8[m, k]) · 7.5)
// · s_x[m]) · s[n]), the decode-M product of a nibble weight leaf that streams only its hi plane.
//
// Replaces the XLA op openvla_probe_tpu/ops/linear.py::_nib_hi_dot (reached from _nib_matmul
// for M <= 32: the decode steps and lm_head of the nibble weights). With the lo nibble at its
// midpoint, w ≈ (16·hi + 7.5)·s, so the product is one int8 dot with the hi codes plus a rank-1
// correction by the row sums of the activation codes. Semantics kept bit for bit:
//   * per-row codes clip(rint(x / s_x), -127, 127) with s_x = max(max|x| / 127, 1e-8) and IEEE
//     divisions (round half to even);
//   * the exact int32 sums Σ x8·hi and Σ x8 (|Σ x8·hi| <= 127 · 8 · K), whatever their order;
//   * f32(acc)·16 and f32(rowsum)·7.5 each rounded once, their sum rounded once, then
//     (· s_x) · s, in that order (the _rn intrinsics keep nvcc from contracting to an FMA).
// The hi plane is the port's packed layout: uint8 [N, K / 2], byte j holding code 2j in its low
// nibble and 2j + 1 in its high nibble, two's complement.
//
// Bound on the H100 at the OpenVLA-7B decode shapes (M = 24): the hi plane, half a byte per
// weight: 8.4 MB for 4096 x 4096 (2.5 us at 3.35 TB/s), 70.5 MB for lm_head's 32064 x 4096.
// The earlier kernel (32 x 32 blocks, each walking all of K behind an 8-stage cp.async ring, one
// barrier a chunk) took 0.029 ms at 24 x 4096 x 4096 on an H100 80GB HBM3 at 700 W: latency,
// not bytes (PERF.md §6).
//
// Design. One call makes two launches:
//   1. the pre-pass (quant_rows, int8_mma.cuh), one block per row, writes the codes, s_x and
//      the row sums of the codes, each 32-code block of codes in the k order the packed
//      fragments take (stored_offset);
//   2. the split-K decode route of int8_decode.cuh on the hi plane (W::kHi): a block owns 32
//      columns over all of K, 8 consumer warps take the 128-deep chunks in turn from TMA
//      stages of their own, the packed codes widened to int8 in registers for mma.sync, the
//      warps' int32 partial sums added in shared memory before the epilogue (EpiHi). Any M:
//      blocks of 32 rows.
#include "int8_decode.cuh"

namespace ovla_nib {

template <typename T>
int run(const void* x, const void* hi, const void* s, void* out, void* xq, void* sx, void* rs,
        int M, int N, int K, cudaStream_t stream) {
  namespace d = ovla_i8d;
  int8_t* codes = static_cast<int8_t*>(xq);
  float* scales = static_cast<float*>(sx);
  int* rowsum = static_cast<int*>(rs);
  // the codes in the k order of the packed-code fragments, and their row sums
  cudaError_t err = ovla_i8::quant_rows<T, true, true>(x, codes, scales, rowsum, M, K, stream);
  if (err != cudaSuccess) return int(err);
  const d::EpiHi epi{scales, static_cast<const float*>(s), rowsum};
  return d::launch<d::W::kHi>(codes, static_cast<const uint8_t*>(hi), nullptr, epi,
                              static_cast<T*>(out), M, N, K, stream);
}

}  // namespace ovla_nib

// Returns the launches' cudaError_t (0 on success). x [M, K] (bf16 or fp32), hi packed uint8
// [N, K / 2], s fp32 [N], out [M, N] in x's type, and the pre-pass's scratch xq int8 [M, K],
// sx fp32 [M], rowsum int32 [M]: all contiguous; x, hi and xq 16-byte aligned (the TMA maps);
// K a multiple of 32, N of 8; M past the grid's 65535 row blocks refused.
extern "C" int ovla_nib_hi_dot(const void* x, const void* hi, const void* s, void* out, void* xq,
                               void* sx, void* rowsum, int M, int N, int K, int is_bf16,
                               void* stream) {
  auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (M < 1 || (M + ovla_i8d::kBM - 1) / ovla_i8d::kBM > 65535 || N < 8 || N % 8 != 0 ||
      K < 32 || K % 32 != 0 || misaligned(x) || misaligned(hi) || misaligned(xq))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ovla_nib::run<__nv_bfloat16>(x, hi, s, out, xq, sx, rowsum, M, N, K, st);
  return ovla_nib::run<float>(x, hi, s, out, xq, sx, rowsum, M, N, K, st);
}
