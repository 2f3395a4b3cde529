// stacked_decode_i8: softmax(q · K[li]) @ V[li] for one decode query per batch row over one
// layer of the int8 flat stacked KV cache, the dequantization fused.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/decode_attention.py::_stacked_i8_kernel
// (reached through stacked_decode_attention_i8 from llama.decode_step_stacked_i8, the
// pallas_kv8 tier's decode). Semantics kept, per kv head:
//   kf = f32(kq) · ks and vf = f32(vq) · vs per (slot, kv head); for each of its n_rep query
//   heads qh = f32(q) · scale (the scale applied BEFORE the dot); fp32 scores, NEG_INF where
//   the slot is not valid; one max, p = exp(s - m), l = Σp; P·V in fp32 with P unrounded;
//   out = cast(pv / max(l, 1e-30)).
// The TPU kernel's scalar-prefetched layer index is only how its BlockSpecs pick the layer:
// here the wrapper passes the layer's base pointers.
//
// Bound on the H100 at OpenVLA-7B, B = 24, S = 320 slots, 32 heads of 128: one layer's int8
// K and V codes (62.9 MB) and fp32 scales (2 MB) per launch, 0.019 ms at 3.35 TB/s; 32 x 6 =
// 192 launches per serving call.
//
// Design. One block per (batch row, kv head), 768 blocks at 7B, 8 warps. One head's cache
// rows are Dh bytes at a stride of Hkv · Dh: Dh / 4 lanes cover one slot with a 4-byte load
// each (a warp reads a whole 128-byte row at Dh = 128), so K and V stream from device memory
// straight into registers, every code read once and dequantized in registers; each kv head's
// dequantized values serve its n_rep query heads (GQA). Scores and then probabilities stay in
// shared memory (n_rep · S floats); the P·V partial sums are reduced across lanes, then
// across warps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ovla_sd {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr float kNegInf = -2.3819763e38f;   // the JAX kernel's finite NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// block-wide max (MAX) or sum of one value per thread; every thread gets the result
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = MAX ? fmaxf(v, scratch[w]) : v + scratch[w];
  __syncthreads();   // scratch is reused by the next reduction
  return v;
}

template <typename T, int DH, int NREP>
__global__ void __launch_bounds__(kThreads)
    stacked_decode_i8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                             const float* __restrict__ ks, const int8_t* __restrict__ vq,
                             const float* __restrict__ vs, const int* __restrict__ valid,
                             T* __restrict__ out, int H, int Hkv, int S, float scale) {
  constexpr int LPS = DH / 4, SPW = 32 / LPS;   // lanes per slot, slots per warp pass
  extern __shared__ float sd_smem[];
  float* sc = sd_smem;                          // [NREP][S] scores, then probabilities
  float* part = sc + NREP * S;                  // [kWarps][NREP][DH] partial P·V
  float* scratch = part + kWarps * NREP * DH;   // [kWarps]
  float* lsum = scratch + kWarps;               // [NREP]
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPS, d0 = 4 * (lane % LPS);
  const long long row = (long long)Hkv * DH;    // bytes per slot of the flat cache
  const int8_t* kb = kq + (long long)b * S * row + kvh * DH + d0;
  const int8_t* vb = vq + (long long)b * S * row + kvh * DH + d0;
  const float* ksb = ks + (long long)b * S * Hkv + kvh;
  const float* vsb = vs + (long long)b * S * Hkv + kvh;
  const int* ok = valid + (long long)b * S;

  float qv[NREP][4];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const T* qh = q + ((long long)b * H + kvh * NREP + r) * DH + d0;
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[r][i] = __fmul_rn(to_f32(qh[i]), scale);
  }

  // scores: slot s = s0 + sub, its Dh codes over LPS lanes
#pragma unroll 4
  for (int s0 = warp * SPW; s0 < S; s0 += kWarps * SPW) {
    const int s = s0 + sub;
    float dot[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) dot[r] = 0.f;
    if (s < S) {
      const char4 c = *reinterpret_cast<const char4*>(kb + s * row);
      const float sk = ksb[(long long)s * Hkv];
      const float kf[4] = {__fmul_rn(float(c.x), sk), __fmul_rn(float(c.y), sk),
                           __fmul_rn(float(c.z), sk), __fmul_rn(float(c.w), sk)};
#pragma unroll
      for (int r = 0; r < NREP; ++r)
        dot[r] = qv[r][0] * kf[0] + qv[r][1] * kf[1] + qv[r][2] * kf[2] + qv[r][3] * kf[3];
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int o = LPS / 2; o > 0; o >>= 1) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
    if (s < S && lane % LPS == 0) {
      const bool attend = ok[s] > 0;
#pragma unroll
      for (int r = 0; r < NREP; ++r) sc[r * S + s] = attend ? dot[r] : kNegInf;
    }
  }
  __syncthreads();

  // one softmax per query head: probabilities over the scores in place
  for (int r = 0; r < NREP; ++r) {
    float m = -INFINITY;
    for (int s = threadIdx.x; s < S; s += kThreads) m = fmaxf(m, sc[r * S + s]);
    m = block_reduce<true>(m, scratch);
    float l = 0.f;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      const float e = expf(sc[r * S + s] - m);
      sc[r * S + s] = e;
      l += e;
    }
    l = block_reduce<false>(l, scratch);   // its barriers also publish the probabilities
    if (threadIdx.x == 0) lsum[r] = l;
  }

  // P·V: each lane accumulates its 4 dims over its slots
  float pv[NREP][4];
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[r][i] = 0.f;
#pragma unroll 4
  for (int s0 = warp * SPW; s0 < S; s0 += kWarps * SPW) {
    const int s = s0 + sub;
    if (s < S) {
      const char4 c = *reinterpret_cast<const char4*>(vb + s * row);
      const float sv = vsb[(long long)s * Hkv];
      const float vf[4] = {__fmul_rn(float(c.x), sv), __fmul_rn(float(c.y), sv),
                           __fmul_rn(float(c.z), sv), __fmul_rn(float(c.w), sv)};
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float p = sc[r * S + s];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[r][i] += p * vf[i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = LPS; o < 32; o <<= 1) pv[r][i] += __shfl_xor_sync(0xffffffffu, pv[r][i], o);
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[(warp * NREP + r) * DH + d0 + i] = pv[r][i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NREP * DH; t += kThreads) {
    const int r = t / DH, d = t % DH;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += part[(w * NREP + r) * DH + d];
    out[((long long)b * H + kvh * NREP + r) * DH + d] =
        from_f32<T>(__fdiv_rn(v, fmaxf(lsum[r], 1e-30f)));
  }
}

inline size_t smem_bytes(int S, int dh, int nrep) {
  return sizeof(float) * (size_t(nrep) * S + size_t(kWarps) * nrep * dh + kWarps + nrep);
}

template <typename T, int DH, int NREP>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* valid, void* out, int B, int H, int Hkv, int S, float scale,
           cudaStream_t stream) {
  auto kernel = stacked_decode_i8_kernel<T, DH, NREP>;
  const size_t smem = smem_bytes(S, DH, NREP);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
      static_cast<const int*>(valid), static_cast<T*>(out), H, Hkv, S, scale);
  return int(cudaGetLastError());
}

template <typename T, int DH>
int launch_rep(int nrep, const void* q, const void* kq, const void* ks, const void* vq,
               const void* vs, const void* valid, void* out, int B, int H, int Hkv, int S,
               float scale, cudaStream_t st) {
  switch (nrep) {
    case 1: return launch<T, DH, 1>(q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, scale, st);
    case 2: return launch<T, DH, 2>(q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, scale, st);
    case 4: return launch<T, DH, 4>(q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, scale, st);
    case 8: return launch<T, DH, 8>(q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, scale, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_dh(int dh, int nrep, const void* q, const void* kq, const void* ks, const void* vq,
              const void* vs, const void* valid, void* out, int B, int H, int Hkv, int S,
              float scale, cudaStream_t st) {
  switch (dh) {
    case 16: return launch_rep<T, 16>(nrep, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, scale, st);
    case 32: return launch_rep<T, 32>(nrep, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, scale, st);
    case 64: return launch_rep<T, 64>(nrep, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, scale, st);
    case 128: return launch_rep<T, 128>(nrep, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, scale, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace ovla_sd

// Returns the launch's cudaError_t (0 on success). q [B, 1, H, Dh] and out in q's type (bf16 or
// fp32); one layer's kq / vq int8 [B, S, Hkv · Dh] and ks / vs fp32 [B, S, Hkv]; valid int32
// [B, S]; all contiguous. Dh in {16, 32, 64, 128}, H / Hkv in {1, 2, 4, 8}.
extern "C" int ovla_stacked_decode_i8(const void* q, const void* kq, const void* ks,
                                      const void* vq, const void* vs, const void* valid,
                                      void* out, int B, int H, int Hkv, int S, int Dh,
                                      float scale, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 ||
      ovla_sd::smem_bytes(S, Dh, H / Hkv) > 200 * 1024)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ovla_sd::launch_dh<__nv_bfloat16>(Dh, H / Hkv, q, kq, ks, vq, vs, valid, out, B, H,
                                             Hkv, S, scale, st);
  return ovla_sd::launch_dh<float>(Dh, H / Hkv, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S,
                                   scale, st);
}
