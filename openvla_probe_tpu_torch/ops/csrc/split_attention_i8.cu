// split_attention_i8: one decode query per (batch, head) over an int8 frozen prefill segment
// and the generated-token buffer, with one joint softmax (the turbo_kv8 tier's decode step).
//
// Replaces the XLA function openvla_probe_tpu/models/llama.py::_split_attention_i8 (:746-800),
// which the JAX package runs on the TPU's integer MXU. Semantics kept:
//   * q row-quantized over Dh: s_q = max(max|q|, 1e-8) / 127 (the clamp before the IEEE
//     division), codes clip(rint(q / s_q), -127, 127);
//   * the exact int32 q · Kp (four codes a word, __dp4a), rescaled as (f32(acc) · s_q) · s_k,
//     then · scale + the additive mask (0 or the finite NEG_INF), rounded to the scores dtype
//     (bf16 on the turbo tiers);
//   * the decode segment q · Kd summed in fp32 and rounded to the scores dtype, then · scale +
//     mask, rounded again;
//   * one fp32 softmax over [prefill | decode]: p = expf(s - max) / sum, an IEEE division;
//   * the prefill probabilities times the V scales (pf = p · s_v), row-quantized with
//     s_p = max(max|pf|, 1e-12) / 127 over the whole row (the row held in shared memory, its max
//     taken before any code is made), codes clip(rint(pf / s_p), -127, 127); the exact int32
//     p · Vp, times s_p;
//   * plus the decode probabilities cast to q's dtype times Vd, summed in fp32;
//   * the sum cast to q's dtype.
// Every division is an IEEE division (__fdiv_rn), every rounding to nearest even; every product
// and sum of the scores is rounded once (the _rn intrinsics keep nvcc from contracting). The
// int32 dots are exact in any order; the fp32 sums (the softmax denominator, q · Kd, the
// decode segment's p · V) run in another order than the plain version's, so the two are held
// by ops/decode_attention.py::compare_split_attention_i8. No dequantized K or V reaches memory.
//
// Bound on the H100 at the OpenVLA-7B serving shape (B = 24, H = Hkv = 32, Dh = 128, T = 288,
// A = 6 generated slots): the int8 Kp and Vp, 2 · 24 · 288 · 4096 = 56.6 MB, their scales
// 1.8 MB and the bf16 decode buffer 2.4 MB: 60.8 MB, 0.018 ms at 3.35 TB/s; 192 launches a
// call (32 layers x 6 steps).
//
// Design (a first kernel, right before fast): one block of 256 threads per (kv head, batch)
// row; for each of its n_rep query heads (GQA: H / Hkv >= 1) in turn, warp 0 quantizes q into
// shared memory, each thread takes one prefill key (its whole row of codes in 16-byte loads
// issued together, then __dp4a against q's codes) and each warp every eighth decode slot, the
// scores and probabilities of the whole row stay in shared memory (T + A <= 4096), block
// reductions give the softmax's max and sum and pf's max, and for p · Vp each thread owns 16
// head dims and a share of the keys (one 16-byte load of V a key, integer products), the
// shares added in shared memory. Every CTA is resident at once at the serving shape (768 on
// 132 SMs), so a CTA's chain of dependent loads is the kernel's time: the first version (a
// warp a key with 4-byte loads and a shuffle sum, 4-byte V loads) took 0.112 ms, a thread a
// key 0.064, and 16-byte V loads 0.050 (timed in turns in one process on an H100 80GB HBM3
// at 700 W; PERF.md §6). The ring routes of
// decode_common.cuh and stacked_decode_i8.cu's exact int8 -> fp16 byte permutes are left to a
// later kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovla_si8 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 256;
constexpr int kMaxKeys = 4096;
constexpr float kNegInf = -2.3819763e38f;   // ops/attention.py NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Args {
  const void* q;          // [B, 1, H, Dh] bf16 or fp32
  const int8_t* kq;       // [B, T, Hkv, Dh]
  const float* ks;        // [B, T, Hkv]
  const int8_t* vq;
  const float* vs;
  const void* kd;         // [B, A, Hkv, Dh] in q's dtype
  const void* vd;
  const int* pre_valid;   // [B, T]
  const int* dec_valid;   // [B, A]
  void* out;              // [B, 1, H, Dh] in q's dtype
  int B, H, Hkv, n_pre, n_dec, Dh;   // T prefill tokens, A decode slots
  float scale;
  int scores_bf16;
};

// block-wide max / sum over kThreads (warp trees, then the warps in order); `red` is reused,
// so each call first waits for every reader of the last one
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, w));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  return r;
}
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, w));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = __fadd_rn(r, red[i]);
  return r;
}

__device__ __forceinline__ int code(float x, float s) {
  return __float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) split_i8_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float qf[kMaxDh];              // q in fp32
  __shared__ uint32_t qw[kMaxDh / 4];       // q's codes, four a word in d order
  __shared__ int part[16 * kThreads];       // p · Vp shares [split][Dh]
  __shared__ float red[kWarps];
  __shared__ float sq_sh;
  const int T_ = a.n_pre, A = a.n_dec, Dh = a.Dh, Hkv = a.Hkv, W = Dh / 4;
  float* sc = reinterpret_cast<float*>(smem);               // the row's T + A scores, then p
  int8_t* pi = reinterpret_cast<int8_t*>(sc + T_ + A);      // the prefill codes of p
  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rep = a.H / Hkv;
  const T* q = static_cast<const T*>(a.q);
  const T* kd = static_cast<const T*>(a.kd);
  const T* vd = static_cast<const T*>(a.vd);
  T* out = static_cast<T*>(a.out);
  const bool sbf = a.scores_bf16 != 0;
  auto round_s = [&](float x) { return sbf ? round_bf16(x) : x; };
  auto row = [&](int s) { return (long long)(b * T_ + s) * Hkv + hk; };        // prefill token
  auto drow = [&](int s) { return (long long)(b * A + s) * Hkv + hk; };        // decode slot

  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const long long qbase = ((long long)b * a.H + h) * Dh;
    // q: warp 0, each lane its words of 4 head dims (W <= 64)
    if (warp == 0) {
      float v[2][4];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int w = lane + 32 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[i][e] = w < W ? to_f(q[qbase + 4 * w + e]) : 0.f;
          if (w < W) qf[4 * w + e] = v[i][e];
          amax = fmaxf(amax, fabsf(v[i][e]));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int w = lane + 32 * i;
        if (w < W) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) word |= (uint32_t(code(v[i][e], s)) & 0xFFu) << (8 * e);
          qw[w] = word;
        }
      }
      if (lane == 0) sq_sh = s;
    }
    __syncthreads();
    const float s_q = sq_sh;

    // the prefill scores: a thread per key, its row's codes loaded whole (16-byte loads where
    // Dh is a multiple of 16, else words), its scale and validity beside them, then the dots
    for (int s = tid; s < T_; s += kThreads) {
      const int8_t* kr = a.kq + row(s) * Dh;
      const float ks = __ldg(a.ks + row(s));
      const bool valid = a.pre_valid[b * T_ + s] > 0;
      int acc = 0;
      if (Dh % 16 == 0) {
#pragma unroll 8
        for (int w = 0; w < Dh / 16; ++w) {
          const int4 c = __ldg(reinterpret_cast<const int4*>(kr) + w);
          acc = __dp4a(c.x, int(qw[4 * w]), acc);
          acc = __dp4a(c.y, int(qw[4 * w + 1]), acc);
          acc = __dp4a(c.z, int(qw[4 * w + 2]), acc);
          acc = __dp4a(c.w, int(qw[4 * w + 3]), acc);
        }
      } else {
#pragma unroll 8
        for (int w = 0; w < W; ++w)
          acc = __dp4a(int(__ldg(reinterpret_cast<const uint32_t*>(kr) + w)), int(qw[w]), acc);
      }
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), s_q), ks);
      sc[s] = round_s(__fadd_rn(__fmul_rn(v, a.scale), valid ? 0.f : kNegInf));
    }
    // the decode scores: a warp per slot, fp32 sums of the products
    for (int s = warp; s < A; s += kWarps) {
      const T* kr = kd + drow(s) * Dh;
      float acc = 0.f;
      for (int d = lane; d < Dh; d += 32) acc = __fadd_rn(acc, __fmul_rn(qf[d], to_f(kr[d])));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      if (lane == 0) {
        const float v = __fmul_rn(round_s(acc), a.scale);
        sc[T_ + s] = round_s(__fadd_rn(v, a.dec_valid[b * A + s] > 0 ? 0.f : kNegInf));
      }
    }
    __syncthreads();

    // one softmax over [prefill | decode]; pf = p · s_v over the prefill, and its row max
    float m = __int_as_float(static_cast<int>(0xff800000u));   // -inf
    for (int i = tid; i < T_ + A; i += kThreads) m = fmaxf(m, sc[i]);
    m = block_max(m, red);
    float sum = 0.f;
    for (int i = tid; i < T_ + A; i += kThreads) {
      const float e = expf(__fsub_rn(sc[i], m));
      sc[i] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = block_sum(sum, red);
    float pmax = 0.f;
    for (int i = tid; i < T_ + A; i += kThreads) {
      float p = __fdiv_rn(sc[i], sum);
      if (i < T_) {
        p = __fmul_rn(p, __ldg(a.vs + row(i)));
        pmax = fmaxf(pmax, fabsf(p));
      }
      sc[i] = p;
    }
    pmax = block_max(pmax, red);
    const float s_p = __fdiv_rn(fmaxf(pmax, 1e-12f), 127.f);
    for (int i = tid; i < T_; i += kThreads) pi[i] = static_cast<int8_t>(code(sc[i], s_p));
    __syncthreads();

    // p · Vp: thread (split, w) owns `vec` head dims (16: one 16-byte load a key, where Dh is a
    // multiple of 16; else 4, a word) over every nsplit-th key, integer products
    const int vec = Dh % 16 == 0 ? 16 : 4, per_row = Dh / vec, nsplit = kThreads / per_row;
    const int wd = tid % per_row, split = tid / per_row;
    if (split < nsplit) {
      int o[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = 0;
      if (vec == 16) {
#pragma unroll 4
        for (int s = split; s < T_; s += nsplit) {
          const int4 c = __ldg(reinterpret_cast<const int4*>(a.vq + row(s) * Dh) + wd);
          const uint32_t w[4] = {uint32_t(c.x), uint32_t(c.y), uint32_t(c.z), uint32_t(c.w)};
          const int p = pi[s];
#pragma unroll
          for (int e = 0; e < 16; ++e)
            o[e] += p * int(static_cast<int8_t>(w[e / 4] >> (8 * (e % 4))));
        }
      } else {
#pragma unroll 4
        for (int s = split; s < T_; s += nsplit) {
          const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(a.vq + row(s) * Dh) + wd);
          const int p = pi[s];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] += p * int(static_cast<int8_t>(w >> (8 * e)));
        }
      }
      if (vec == 16) {
#pragma unroll
        for (int e = 0; e < 16; ++e) part[split * Dh + 16 * wd + e] = o[e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[split * Dh + 4 * wd + e] = o[e];
      }
    }
    __syncthreads();
    // the shares' exact sum · s_p, plus the decode segment, cast to q's dtype
    for (int d = tid; d < Dh; d += kThreads) {
      int tot = 0;
      for (int i = 0; i < nsplit; ++i) tot += part[i * Dh + d];
      float dec = 0.f;
#pragma unroll 4
      for (int s = 0; s < A; ++s)
        dec = __fadd_rn(dec, __fmul_rn(to_f(from_f<T>(sc[T_ + s])), to_f(vd[drow(s) * Dh + d])));
      out[qbase + d] = from_f<T>(__fadd_rn(__fmul_rn(__int2float_rn(tot), s_p), dec));
    }
    __syncthreads();   // the next head reuses the row's buffers
  }
}

}  // namespace ovla_si8

// Returns the launch's cudaError_t (0 on success). q [B, 1, H, Dh] (bf16 when is_bf16, else
// fp32); kq, vq int8 and ks, vs fp32 [B, T, Hkv, (Dh)]; kd, vd [B, A, Hkv, Dh] in q's dtype;
// pre_valid [B, T] and dec_valid [B, A] int32 (1 = attend); out [B, 1, H, Dh] in q's dtype;
// scores rounded to bf16 when scores_bf16. All contiguous and 4-byte aligned; Dh a multiple of
// 4 up to 256, H a multiple of Hkv, 1 <= T, 1 <= A, T + A <= 4096.
extern "C" int ovla_split_attention_i8(const void* q, const void* kq, const void* ks,
                                       const void* vq, const void* vs, const void* kd,
                                       const void* vd, const void* pre_valid,
                                       const void* dec_valid, void* out, int B, int H, int Hkv,
                                       int T, int A, int Dh, float scale, int is_bf16,
                                       int scores_bf16, void* stream) {
  using namespace ovla_si8;
  auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) != 0; };
  if (B < 1 || B > 65535 || Hkv < 1 || H < Hkv || H % Hkv != 0 || T < 1 || A < 1 ||
      T + A > kMaxKeys || Dh < 4 || Dh % 4 != 0 || Dh > kMaxDh || !q || !ks || !vs ||
      !pre_valid || !dec_valid || misaligned(kq) || misaligned(vq) || !kq || !vq || !kd ||
      !vd || !out)
    return int(cudaErrorInvalidValue);
  const Args a{q, static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
               static_cast<const int8_t*>(vq), static_cast<const float*>(vs), kd, vd,
               static_cast<const int*>(pre_valid), static_cast<const int*>(dec_valid), out,
               B, H, Hkv, T, A, Dh, scale, scores_bf16};
  const size_t smem = (size_t(T + A) * 4 + T + 15) / 16 * 16;
  const dim3 grid(Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    split_i8_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(a);
  else
    split_i8_kernel<float><<<grid, kThreads, smem, st>>>(a);
  return int(cudaGetLastError());
}
