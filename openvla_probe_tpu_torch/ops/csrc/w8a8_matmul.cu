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
