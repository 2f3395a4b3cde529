// decode_attention: one query per (batch, head) over the stacked KV cache, for
// the greedy decode steps.
//
// Replaces no Pallas kernel: on the parity and turbo tiers the JAX package
// decodes with XLA attention (openvla_probe_tpu/models/llama.py:225-229,
// reached with Tq = 1). Semantics of that branch kept exactly, in its two
// score types:
//   fp32 scores (parity): s_c = (q . k_c in fp32) * scale + mask_c;
//   bf16 scores (turbo): s_c = bf16(bf16(q . k_c) * scale + bf16(mask_c)), so
//   bf16(bf16(q . k_c) * scale) for a valid key and bf16(NEG_INF) for a masked
//   one (the product is far below NEG_INF's last place);
// mask_c = 0 where kv_valid[b, c] > 0 and c <= offset, else the finite NEG_INF;
// p = softmax(s) in fp32 (exp(s - m) / l); p cast to the input type (bf16);
// out = sum_c p_c v_c in fp32, cast to the input type.
//
// Bound on the H100 at the OpenVLA-7B decode shape (B=24, q [24, 1, 32, 128],
// k/v [24, 295, 32, 128] bf16, the query at slot 291): 115 MB of the K/V up to
// the query (34 us at 3.35 TB/s) against 58 MFLOP, so it is bytes-bound; at
// generate's middle step (B = 8, S = 352, slot 335) 44 MB (13 us) over only
// 256 (b, h) pairs for 132 SMs.
//
// Two routes, chosen by the wrapper's declared rule before the launch
// (ops/attention.py::decode_ring_eligible), each launcher refusing what it
// does not take:
//  * ovla_decode_attention: bf16 at Dh = 128 with 16-byte aligned rows and
//    strides: the ring route of decode_common.cuh (bulk copies of whole rows
//    through each warp's ring of stages, K then V; q.k and P.V on mma.sync;
//    keys split across a cluster of 1, 2 or 4 CTAs by B * H: 1 at serving and
//    for generate's 8 rows, 4 for a single row; only keys up to the query's
//    position are read, unless a row has no valid key there). P is rounded
//    to bf16 after the division by the whole row's sum, so the cluster
//    exchanges its max and then its sum before any CTA forms P.
//  * ovla_decode_attention_scalar: fp32, other head dims, unaligned rows. One
//    block of 128 threads per (b, h) reads each K row and each V row once,
//    coalesced (a warp per key for q . k, a thread per head dim for PV), and
//    keeps scores and probabilities in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace ovla {

constexpr int kDecThreads = 128;
constexpr int kDecMaxS = 4096;
constexpr float kDecNegInf = -2.3819763e38f;

__device__ __forceinline__ float dec_f32(float x) { return x; }
__device__ __forceinline__ float dec_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T dec_cast(float x);
template <>
__device__ __forceinline__ float dec_cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 dec_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct DecodeArgs {
  const void* q;           // [B, 1, H, Dh]: batch stride q_sb, head slab contiguous
  const void* k;           // [B, S, H, Dh]
  const void* v;
  void* o;                 // contiguous [B, 1, H, Dh]
  const int32_t* kv_valid; // [B, S]
  int B, H, S, Dh;
  long long q_sb, k_sb, k_st, v_sb, v_st;
  float scale;
  int offset;              // absolute position of the query (causal rule)
  int bf16_scores;         // 1: the turbo tier's bf16 scores
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads) decode_attention_kernel(DecodeArgs a) {
  extern __shared__ float dsmem[];
  const int S = a.S, Dh = a.Dh;
  float* q_s = dsmem;        // [Dh]
  float* p_s = q_s + Dh;     // [S]: scores, then probabilities
  float* red = p_s + S;      // [kDecThreads / 32]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kDecThreads / 32;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * Dh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + h * Dh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + h * Dh;
  const int32_t* valid = a.kv_valid + (long long)b * S;

  for (int d = tid; d < Dh; d += kDecThreads) q_s[d] = dec_f32(Q[d]);
  __syncthreads();

  // scores: a warp per key, lanes across the head dim
  for (int c = warp; c < S; c += kWarps) {
    const T* krow = K + c * a.k_st;
    float dot = 0.f;
    for (int d = lane; d < Dh; d += 32) dot += q_s[d] * dec_f32(krow[d]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, w);
    if (lane == 0) {
      const bool ok = valid[c] > 0 && c <= a.offset;
      if (a.bf16_scores)
        p_s[c] = ok ? bf16_round(__fmul_rn(bf16_round(dot), a.scale)) : bf16_round(kDecNegInf);
      else
        p_s[c] = dot * a.scale + (ok ? 0.f : kDecNegInf);
    }
  }
  __syncthreads();

  // block max, then exp and block sum
  float m = kDecNegInf;
  for (int c = tid; c < S; c += kDecThreads) m = fmaxf(m, p_s[c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, w));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  __syncthreads();   // every thread has read red before it is reused
  float l = 0.f;
  for (int c = tid; c < S; c += kDecThreads) {
    const float e = expf(p_s[c] - m);
    p_s[c] = e;
    l += e;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = 0.f;
  for (int i = 0; i < kWarps; ++i) l += red[i];
  for (int c = tid; c < S; c += kDecThreads) p_s[c] = dec_f32(dec_cast<T>(p_s[c] / l));
  __syncthreads();

  // PV: a thread per head-dim column, V rows read coalesced
  T* O = static_cast<T*>(a.o) + ((long long)b * a.H + h) * Dh;
  for (int d = tid; d < Dh; d += kDecThreads) {
    float acc = 0.f;
    for (int c = 0; c < S; ++c) acc += p_s[c] * dec_f32(V[c * a.v_st + d]);
    O[d] = dec_cast<T>(acc);
  }
}

template <typename T>
int launch_decode_attention(const DecodeArgs& a, cudaStream_t stream) {
  if (a.S < 1 || a.S > kDecMaxS || a.Dh < 1 || a.B < 1 || a.H < 1)
    return int(cudaErrorInvalidValue);
  auto kernel = decode_attention_kernel<T>;
  const size_t smem = sizeof(float) * (a.Dh + a.S + kDecThreads / 32);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(a.H, a.B), kDecThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace ovla

// The scalar route. Returns the launch's cudaError_t (0 on success).
extern "C" int ovla_decode_attention_scalar(const void* q, const void* k, const void* v,
                                            void* o, const int32_t* kv_valid, int B, int H,
                                            int S, int Dh, long long q_sb, long long k_sb,
                                            long long k_st, long long v_sb, long long v_st,
                                            float scale, int offset, int bf16_scores,
                                            int is_bf16, void* stream) {
  ovla::DecodeArgs a{q, k, v, o, kv_valid, B, H, S, Dh, q_sb, k_sb, k_st, v_sb, v_st,
                     scale, offset, bf16_scores};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ovla::launch_decode_attention<__nv_bfloat16>(a, s)
                 : ovla::launch_decode_attention<float>(a, s);
}

namespace ovla {

template <int kMode>
__global__ void __launch_bounds__(ovla_dec::kThreads, ovla_dec::kMinBlocksPerSm)
    decode_ring_kernel(ovla_dec::RingArgs a) {
  ovla_dec::ring_decode<kMode>(a);
}

}  // namespace ovla

// The ring route: bf16 at Dh = 128, K/V pointers and strides 16-byte aligned, S <= 4096;
// anything else is refused (cudaErrorInvalidValue) before a launch. `cs` CTAs a (b, h): 1, 2 or
// 4, or 0 for cluster_size's rule (ovla_decode_attention; a given size times the rule against
// the others).
extern "C" int ovla_decode_attention_cs(const void* q, const void* k, const void* v, void* o,
                                        const int32_t* kv_valid, int B, int H, int S, int Dh,
                                        long long q_sb, long long k_sb, long long k_st,
                                        long long v_sb, long long v_st, float scale, int offset,
                                        int bf16_scores, int is_bf16, int cs, void* stream) {
  const void* ptrs[2] = {k, v};
  const long long strides[4] = {k_sb, k_st, v_sb, v_st};
  if (B < 1 || H < 1 || !ovla_dec::ring_takes(is_bf16, Dh, S, ptrs, 2, strides, 4))
    return int(cudaErrorInvalidValue);
  ovla_dec::RingArgs a{q, k, v, k, v, kv_valid, kv_valid, o, B, H, S, S,
                       q_sb, k_sb, k_st, v_sb, v_st, k_sb, k_st, v_sb, v_st,
                       scale, offset, cs ? cs : ovla_dec::cluster_size(B * H),
                       ovla_dec::ring_keys(S, offset, true)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_scores
             ? ovla_dec::launch_ring(ovla::decode_ring_kernel<ovla_dec::kBf16Scores>, a, s)
             : ovla_dec::launch_ring(ovla::decode_ring_kernel<ovla_dec::kFp32Scores>, a, s);
}

// The ring route at cluster_size's rule. The signature is the scalar route's.
extern "C" int ovla_decode_attention(const void* q, const void* k, const void* v, void* o,
                                     const int32_t* kv_valid, int B, int H, int S, int Dh,
                                     long long q_sb, long long k_sb, long long k_st,
                                     long long v_sb, long long v_st, float scale, int offset,
                                     int bf16_scores, int is_bf16, void* stream) {
  return ovla_decode_attention_cs(q, k, v, o, kv_valid, B, H, S, Dh, q_sb, k_sb, k_st, v_sb,
                                  v_st, scale, offset, bf16_scores, is_bf16, 0, stream);
}
