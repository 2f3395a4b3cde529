// rms_norm_quant: x [M, D] -> int8 codes [M, D] and fp32 row scales [M] of the RMS-normed rows,
// h = cast(cast(x · rsqrt(mean(x²) + eps)) · w), s = max(max|h| / 127, 1e-8),
// codes clip(rint(h / s), -127, 127).
//
// Replaces the TPU kernel openvla_probe_tpu/ops/rmsnorm_quant.py::_rmsq_kernel (reached through
// rms_norm_quant from llama._norm_maybe_quant where every consumer of a Llama norm takes the
// w8a8 int8 product). Semantics as that kernel and as the port's plain version (rms_norm, then
// the per-row quantization): the mean of squares in fp32; x · rsqrt in fp32 cast to the
// activation type BEFORE the weight multiply, whose product is cast again; the absmax, the
// division by 127 and the division by the scale as IEEE fp32 operations, round half to even.
// The one difference is the order of the row sum of squares (a block reduction here), so the
// variance, and with it a code at a rounding tie or a row's scale, can differ: every row that
// differs is held to the plain arithmetic with its reciprocal RMS moved by a few ulps.
//
// Bound on the H100 at the OpenVLA-7B prefill (M = 6912, D = 4096, bf16): bytes, 56.6 MB read
// and 28.3 MB of codes written, 0.025 ms at 3.35 TB/s. One block per row reads its row once
// into shared memory as fp32 and makes three passes over it there (sum of squares, normed
// values and their absmax, codes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovla_rmsq {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, w));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) v = op(v, red[w]);
  __syncthreads();   // every thread has read red before it is reused
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsq_kernel(const T* __restrict__ x, const T* __restrict__ w, int8_t* __restrict__ q,
                float* __restrict__ sx, int D, float eps) {
  extern __shared__ float hs[];        // [D]: the row, then its normed values
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float v = to_f32(xr[d]);
    hs[d] = v;
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  ss = block_reduce(ss, red, [](float a, float b) { return __fadd_rn(a, b); });
  const float var = __fdiv_rn(ss, static_cast<float>(D));
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  float amax = 0.f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    const float h = round_to<T>(__fmul_rn(round_to<T>(__fmul_rn(hs[d], r)), to_f32(w[d])));
    hs[d] = h;
    amax = fmaxf(amax, fabsf(h));
  }
  amax = block_reduce(amax, red, [](float a, float b) { return fmaxf(a, b); });
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  int8_t* qr = q + row * D;
  for (int d = threadIdx.x; d < D; d += kThreads)
    qr[d] = static_cast<int8_t>(
        __float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(hs[d], s)), -127.f), 127.f)));
  if (threadIdx.x == 0) sx[row] = s;
}

template <typename T>
int run(const void* x, const void* w, void* q, void* sx, int M, int D, float eps,
        cudaStream_t stream) {
  auto kernel = rmsq_kernel<T>;
  const size_t smem = sizeof(float) * D;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<M, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                        static_cast<int8_t*>(q), static_cast<float*>(sx), D, eps);
  return int(cudaGetLastError());
}

}  // namespace ovla_rmsq

// Returns the launch's cudaError_t (0 on success). x [M, D] and w [D] (both bf16 or both fp32),
// q int8 [M, D], sx fp32 [M]: all contiguous; D at most 57,344 (the row in shared memory).
extern "C" int ovla_rms_norm_quant(const void* x, const void* w, void* q, void* sx, int M, int D,
                                   float eps, int is_bf16, void* stream) {
  if (M < 1 || D < 1 || D > 57344) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return ovla_rmsq::run<__nv_bfloat16>(x, w, q, sx, M, D, eps, st);
  return ovla_rmsq::run<float>(x, w, q, sx, M, D, eps, st);
}
