// decode_split_attention: one decode query per (batch, head) over the frozen
// prefill K/V and the generated-token K/V, with one joint softmax.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/decode_attention.py::_decode_kernel
// (through decode_flash_attention; caller models/llama.py::_split_attention on
// the frozen-KV decode of the `pallas` tier). Semantics kept exactly:
//   q' = float(q) * scale; s_c = q' . k_c in fp32 over the T prefill keys then
//   the A generated keys; s_c = NEG_INF (finite) where the key's validity is 0;
//   m = one max over both segments; p_c = expf(s_c - m) in fp32 and never
//   rounded; out = (sum_c p_c v_c in fp32) / max(sum_c p_c, 1e-30), cast to
//   the input type. (The stacked-decode kernel, decode_attention.cu, rounds P
//   to bf16 like XLA; this one must not.)
//
// Bound on the H100 at the OpenVLA-7B decode shape (B = 24, q [24, 1, 32, 128],
// kp/vp [24, 288, 32, 128], kd/vd [24, 6, 32, 128] bf16): 116 MB of K/V per
// launch (35 us at 3.35 TB/s) against 58 MFLOP, so it is bytes-bound.
//
// Two routes, chosen by the wrapper's declared rule before the launch
// (ops/decode_attention.py::decode_ring_eligible), each launcher refusing what
// it does not take:
//  * ovla_decode_split_attention: bf16 at Dh = 128 with 16-byte aligned rows
//    and strides: the ring route of decode_common.cuh (bulk copies of whole
//    rows through each warp's ring of stages, K then V, the two segments one
//    key index space with the boundary at T anywhere in a 16-key chunk; q.k
//    and P.V on mma.sync, q' and p as three bf16 terms each; keys split
//    across a cluster of 1, 2 or 4 CTAs by B * H (1 at serving), the max
//    exchanged before p, the sums added with the P.V partials at the combine,
//    since p is never rounded).
//  * ovla_decode_split_attention_scalar: fp32, other head dims, unaligned rows.
//    One block of 128 threads per (b, h) reads every K row and every V row
//    once, in place (a warp per key for the scores, a thread per head dim for
//    P.V); scores and probabilities stay in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace ovla {

constexpr int kDsThreads = 128;
constexpr int kDsWarps = kDsThreads / 32;
constexpr int kDsMaxKeys = 4096;
constexpr float kDsNegInf = -2.3819763e38f;

__device__ __forceinline__ float ds_f32(float x) { return x; }
__device__ __forceinline__ float ds_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T ds_cast(float x);
template <>
__device__ __forceinline__ float ds_cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 ds_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct SplitArgs {
  const void* q;     // [B, 1, H, Dh], batch stride q_sb
  const void* kp;    // [B, T, H, Dh]
  const void* vp;
  const void* kd;    // [B, A, H, Dh]
  const void* vd;
  const int32_t* pre_valid;   // [B, T]
  const int32_t* dec_valid;   // [B, A]
  void* o;           // contiguous [B, 1, H, Dh]
  int B, H, T, A, Dh;
  long long q_sb, kp_sb, kp_st, vp_sb, vp_st, kd_sb, kd_st, vd_sb, vd_st;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kDsThreads) decode_split_kernel(SplitArgs a) {
  extern __shared__ float ds_smem[];
  const int S = a.T + a.A, Dh = a.Dh;
  float* q_s = ds_smem;                 // [Dh]
  float* p_s = q_s + Dh;                // [S]: scores, then probabilities
  float* red = p_s + S;                 // [kDsWarps]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * Dh;
  const T* KP = static_cast<const T*>(a.kp) + b * a.kp_sb + h * Dh;
  const T* VP = static_cast<const T*>(a.vp) + b * a.vp_sb + h * Dh;
  const T* KD = static_cast<const T*>(a.kd) + b * a.kd_sb + h * Dh;
  const T* VD = static_cast<const T*>(a.vd) + b * a.vd_sb + h * Dh;
  const int32_t* pv = a.pre_valid + (long long)b * a.T;
  const int32_t* dv = a.dec_valid + (long long)b * a.A;

  for (int d = tid; d < Dh; d += kDsThreads) q_s[d] = ds_f32(Q[d]) * a.scale;
  __syncthreads();

  // scores: a warp per key, [prefill keys | generated keys]
  for (int c = warp; c < S; c += kDsWarps) {
    const bool pre = c < a.T;
    const T* krow = pre ? KP + c * a.kp_st : KD + (c - a.T) * a.kd_st;
    float dot = 0.f;
    for (int d = lane; d < Dh; d += 32) dot += q_s[d] * ds_f32(krow[d]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
    if (lane == 0) p_s[c] = (pre ? pv[c] : dv[c - a.T]) > 0 ? dot : kDsNegInf;
  }
  __syncthreads();

  // one max over both segments, then p = expf(s - m) and its sum, all fp32
  float m = kDsNegInf;
  for (int c = tid; c < S; c += kDsThreads) m = fmaxf(m, p_s[c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, w));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int i = 1; i < kDsWarps; ++i) m = fmaxf(m, red[i]);
  __syncthreads();   // every thread has read red before it is reused
  float l = 0.f;
  for (int c = tid; c < S; c += kDsThreads) {
    const float e = expf(p_s[c] - m);
    p_s[c] = e;
    l += e;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = 0.f;
  for (int i = 0; i < kDsWarps; ++i) l += red[i];
  const float den = fmaxf(l, 1e-30f);

  T* O = static_cast<T*>(a.o) + ((long long)b * a.H + h) * Dh;
  for (int d = tid; d < Dh; d += kDsThreads) {
    float acc = 0.f;
    for (int c = 0; c < a.T; ++c) acc += p_s[c] * ds_f32(VP[c * a.vp_st + d]);
    for (int c = 0; c < a.A; ++c) acc += p_s[a.T + c] * ds_f32(VD[c * a.vd_st + d]);
    O[d] = ds_cast<T>(acc / den);
  }
}

template <typename T>
int launch_decode_split(const SplitArgs& a, cudaStream_t stream) {
  auto kernel = decode_split_kernel<T>;
  const size_t smem = sizeof(float) * (a.Dh + a.T + a.A + kDsWarps);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(a.H, a.B), kDsThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace ovla

// The scalar route. Returns the launch's cudaError_t (0 on success). Each
// token's [H, Dh] slab contiguous; strides in elements.
extern "C" int ovla_decode_split_attention_scalar(
    const void* q, const void* kp, const void* vp, const void* kd, const void* vd,
    const int32_t* pre_valid, const int32_t* dec_valid, void* o, int B, int H, int T, int A,
    int Dh, long long q_sb, long long kp_sb, long long kp_st, long long vp_sb, long long vp_st,
    long long kd_sb, long long kd_st, long long vd_sb, long long vd_st, float scale, int is_bf16,
    void* stream) {
  if (B < 1 || H < 1 || T < 1 || A < 1 || Dh < 1 || Dh > 128 || T + A > ovla::kDsMaxKeys)
    return int(cudaErrorInvalidValue);
  ovla::SplitArgs a{q, kp, vp, kd, vd, pre_valid, dec_valid, o, B, H, T, A, Dh,
                    q_sb, kp_sb, kp_st, vp_sb, vp_st, kd_sb, kd_st, vd_sb, vd_st, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ovla::launch_decode_split<__nv_bfloat16>(a, s)
                 : ovla::launch_decode_split<float>(a, s);
}

namespace ovla {

__global__ void __launch_bounds__(ovla_dec::kThreads, ovla_dec::kMinBlocksPerSm)
    decode_split_ring_kernel(ovla_dec::RingArgs a) {
  ovla_dec::ring_decode<ovla_dec::kSplit>(a);
}

}  // namespace ovla

// The ring route: bf16 at Dh = 128, every K/V pointer and stride 16-byte aligned, T, A >= 1,
// T + A <= 4096; anything else is refused (cudaErrorInvalidValue) before a launch. `cs` CTAs a
// (b, h): 1, 2 or 4, or 0 for cluster_size's rule (ovla_decode_split_attention; a given size
// times the rule against the others).
extern "C" int ovla_decode_split_attention_cs(
    const void* q, const void* kp, const void* vp, const void* kd, const void* vd,
    const int32_t* pre_valid, const int32_t* dec_valid, void* o, int B, int H, int T, int A,
    int Dh, long long q_sb, long long kp_sb, long long kp_st, long long vp_sb, long long vp_st,
    long long kd_sb, long long kd_st, long long vd_sb, long long vd_st, float scale, int is_bf16,
    int cs, void* stream) {
  const void* ptrs[4] = {kp, vp, kd, vd};
  const long long strides[8] = {kp_sb, kp_st, vp_sb, vp_st, kd_sb, kd_st, vd_sb, vd_st};
  if (B < 1 || H < 1 || T < 1 || A < 1 ||
      !ovla_dec::ring_takes(is_bf16, Dh, T + A, ptrs, 4, strides, 8))
    return int(cudaErrorInvalidValue);
  ovla_dec::RingArgs a{q, kp, vp, kd, vd, pre_valid, dec_valid, o, B, H, T, T + A,
                       q_sb, kp_sb, kp_st, vp_sb, vp_st, kd_sb, kd_st, vd_sb, vd_st,
                       scale, 0, cs ? cs : ovla_dec::cluster_size(B * H),
                       ovla_dec::ring_keys(T + A, 0, false)};
  return ovla_dec::launch_ring(ovla::decode_split_ring_kernel, a,
                               static_cast<cudaStream_t>(stream));
}

// The ring route at cluster_size's rule. The signature is the scalar route's.
extern "C" int ovla_decode_split_attention(
    const void* q, const void* kp, const void* vp, const void* kd, const void* vd,
    const int32_t* pre_valid, const int32_t* dec_valid, void* o, int B, int H, int T, int A,
    int Dh, long long q_sb, long long kp_sb, long long kp_st, long long vp_sb, long long vp_st,
    long long kd_sb, long long kd_st, long long vd_sb, long long vd_st, float scale, int is_bf16,
    void* stream) {
  return ovla_decode_split_attention_cs(q, kp, vp, kd, vd, pre_valid, dec_valid, o, B, H, T, A,
                                        Dh, q_sb, kp_sb, kp_st, vp_sb, vp_st, kd_sb, kd_st,
                                        vd_sb, vd_st, scale, is_bf16, 0, stream);
}
