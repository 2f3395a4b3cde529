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
// The one difference is the order of the row sum of squares, so the variance, and with it a
// code at a rounding tie or a row's scale, can differ: every row that differs is held to the
// plain arithmetic with its reciprocal RMS moved by a few ulps (compare_rms_norm_quant).
//
// Bound on the H100 at the OpenVLA-7B prefill (M = 6912, D = 4096, bf16): bytes, 56.6 MB read
// and 28.3 MB of codes written, 0.025 ms at 3.35 TB/s; at decode (M = 24) 196 KB, the launch
// and one load latency. The earlier kernel (one 256-thread block a row, 2-byte loads, the row
// staged as fp32 in shared memory, three passes over it, four block barriers, 1-byte stores, a
// cudaFuncSetAttribute every call) took 0.061 ms at M = 6912 and 0.008 at M = 24 on an H100
// 80GB HBM3 at 700 W (PERF.md §6).
//
// Design: one block a row, the row in registers. Thread t holds the V-element vectors
// d = (j · threads + t) · V, j < S, of x (16-byte loads: V = 8 bf16 or 4 fp32) and of w, so a
// row and the weight are read once with every load in flight at the start. The sum of squares:
// each thread over its vectors in order (j, then the elements), each square and sum rounded
// once; the warp's 32 partials by an xor butterfly (16, 8, 4, 2, 1); then the warps' in warp
// order through one shared-memory exchange (tests/test_torch_kernel_arith_requant.py rehearses
// this order). h in bf16 pairs (one conversion for two, the weight product as a bf16x2 multiply:
// the same roundings), the absmax likewise (a max: any order), then each thread stores its
// codes, V bytes a vector. The codes come from h · (1 / s), with the IEEE division only where
// that product lies within 2^-14 of a half-integer (quant_code: the same codes), and round by a
// magic-number add: no conversion op an element, which run at a quarter of the FMA rate.
// Declared rule for the vector width: V = 16 / sizeof(T) where D is a multiple of it and x, w and
// the codes are 16-byte aligned, else V = 1 (2- or 4-byte loads, 1-byte stores; the same passes).
// Threads (run_v): 128 with S = 1, 2, 4 or 8 vectors each (the fewest that cover D); up to 512
// for longer rows and where the rows are fewer than the SMs: D up to 4096 · V. No dynamic shared
// memory, so nothing is set before a launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovla_rmsq {

// the SMs of the current device, looked up once (132, an H100 SXM's, if the query fails)
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
    return count;
  }();
  return n;
}

constexpr int kThreads = 128;   // a block, where S <= 8 vectors a thread cover D
constexpr int kMaxS = 8;
constexpr int kMaxThreads = 512;   // long rows and few rows (128 registers a thread)
constexpr float kMagic = 12582912.f;   // 1.5 · 2^23: x + kMagic rounds x (|x| < 2^22) half to even
constexpr int kMagicBits = 0x4B400000;   // its bit pattern: the integer sits in the low bits

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

// V elements of T: one 16-byte vector (V = 16 / sizeof(T)) or one element (V = 1), kept packed
template <typename T, int V>
struct Vec {
  static_assert(V == 1 || V * sizeof(T) == 16, "a 16-byte vector or one element");
  T e[V];
};
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
  if constexpr (V == 1) {
    return {{__ldg(p)}};
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Vec<T, V>*>(&u);
  }
}

// h = rt(rt(x · r) · w) of V elements, and their absmax folded into amax (bf16: into the pair
// m2). bf16 pairs: one conversion rounds two products, the bf16 product of two bf16 values
// (exact in fp32, then rounded once) is rt(a · w), and the max of |h| is a bf16 max
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> norm(const Vec<T, V>& x, const Vec<T, V>& w, float r,
                                          float& amax, __nv_bfloat162& m2) {
  Vec<T, V> h;
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 2) {
      const __nv_bfloat162 a = __floats2bfloat162_rn(__fmul_rn(to_f32(x.e[i]), r),
                                                     __fmul_rn(to_f32(x.e[i + 1]), r));
      const __nv_bfloat162 p = __hmul2(a, __halves2bfloat162(w.e[i], w.e[i + 1]));
      h.e[i] = __low2bfloat16(p), h.e[i + 1] = __high2bfloat16(p);
      m2 = __hmax2(m2, __habs2(p));
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = round_to<T>(__fmul_rn(round_to<T>(__fmul_rn(to_f32(x.e[i]), r)),
                                            to_f32(w.e[i])));
      h.e[i] = static_cast<T>(v);
      amax = fmaxf(amax, fabsf(v));
    }
  }
  return h;
}

// The codes clip(rint(h / s), -127, 127) of V values, with the IEEE quotient, from h · (1 / s):
// that product is within 2.3e-5 of h / s's correctly rounded value (|h / s| <= 127, two
// roundings of 2^-24 each), so where it lies more than 2^-14 from a half-integer both round to
// the same integer; where one of the V lies nearer, the exact divisions decide (a branch a
// vector, rarely taken). The clip is the identity here: |h| <= max|h| and s >= max|h| / 127 (one
// rounding) keep |h / s| below 127.5. Rounded half to even by adding 1.5 · 2^23, whose low byte
// is then the code's two's complement (no conversion op: those run at a quarter of the FMA
// rate). Returns each code in the low byte of c[i].
template <int V>
__device__ __forceinline__ void quant_codes(const float (&h)[V], float s, float inv,
                                            uint32_t (&c)[V]) {
  float t[V];
  bool near = false;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    t[i] = __fmul_rn(h[i], inv);
    const float tm = __fadd_rn(t[i], kMagic);
    near |= fabsf(__fsub_rn(t[i], __fsub_rn(tm, kMagic))) > 0.5f - 0x1p-14f;
    c[i] = __float_as_uint(tm);
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < V; ++i) c[i] = __float_as_uint(__fadd_rn(__fdiv_rn(h[i], s), kMagic));
  }
}

// V codes (in the low bytes of c) at p: one V-byte store
template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const uint32_t (&c)[V]) {
  if constexpr (V == 1) {
    *p = static_cast<int8_t>(c[0] & 0xFF);
  } else {
    uint32_t w[V / 4];
#pragma unroll
    for (int i = 0; i < V / 4; ++i)
      w[i] = __byte_perm(__byte_perm(c[4 * i], c[4 * i + 1], 0x0040),
                         __byte_perm(c[4 * i + 2], c[4 * i + 3], 0x0040), 0x5410);
    if constexpr (V == 8)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

template <typename T, int V, int S, int kMaxT>
__global__ void __launch_bounds__(kMaxT)
    rmsq_kernel(const T* __restrict__ x, const T* __restrict__ w, int8_t* __restrict__ q,
                float* __restrict__ sx, int D, float eps) {
  __shared__ float red[2][kMaxT / 32];   // the warps' partial sums, then their maxima
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, nw = blockDim.x / 32;
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  // the row and the weight, every load in flight at once
  Vec<T, V> xv[S], wv[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int d = (j * blockDim.x + tid) * V;
    if (d < D) {
      xv[j] = load_vec<T, V>(xr + d);
      wv[j] = load_vec<T, V>(w + d);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) xv[j].e[i] = wv[j].e[i] = static_cast<T>(0.f);
    }
  }
  float ss = 0.f;   // past D: squares of 0, nothing added
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = to_f32(xv[j].e[i]);
      ss = __fadd_rn(ss, __fmul_rn(v, v));
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if (lane == 0) red[0][warp] = ss;
  __syncthreads();
  ss = red[0][0];
  for (int i = 1; i < nw; ++i) ss = __fadd_rn(ss, red[0][i]);
  const float var = __fdiv_rn(ss, static_cast<float>(D));
  const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));

  float amax = 0.f;   // past D: h of 0
  __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int j = 0; j < S; ++j) xv[j] = norm<T, V>(xv[j], wv[j], r, amax, m2);
  amax = fmaxf(amax, fmaxf(__low2float(m2), __high2float(m2)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[1][warp] = amax;
  __syncthreads();
  amax = red[1][0];
  for (int i = 1; i < nw; ++i) amax = fmaxf(amax, red[1][i]);
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f), inv = __fdiv_rn(1.f, s);

  int8_t* qr = q + row * D;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int d = (j * blockDim.x + tid) * V;
    if (d < D) {
      float h[V];
#pragma unroll
      for (int i = 0; i < V; ++i) h[i] = to_f32(xv[j].e[i]);
      uint32_t c[V];
      quant_codes<V>(h, s, inv, c);
      store_codes<V>(qr + d, c);
    }
  }
  if (tid == 0) sx[row] = s;
}

template <typename T, int V, int MT>
int launch_s(int S, int threads, const T* x, const T* w, int8_t* q, float* sx, int M, int D,
             float eps, cudaStream_t stream) {
  switch (S) {
    case 1: rmsq_kernel<T, V, 1, MT><<<M, threads, 0, stream>>>(x, w, q, sx, D, eps); break;
    case 2: rmsq_kernel<T, V, 2, MT><<<M, threads, 0, stream>>>(x, w, q, sx, D, eps); break;
    case 4: rmsq_kernel<T, V, 4, MT><<<M, threads, 0, stream>>>(x, w, q, sx, D, eps); break;
    default: rmsq_kernel<T, V, 8, MT><<<M, threads, 0, stream>>>(x, w, q, sx, D, eps);
  }
  return int(cudaGetLastError());
}

// The launch rule: a row of `vecs` vectors takes 128 threads with S = 1, 2, 4 or 8 vectors each
// (the fewest that cover it); rows longer than 1024 vectors, or rows fewer than the SMs (decode
// steps: each row's latency chain is the kernel's time, so it is cut into more threads), take up
// to 512 threads with the fewest S that cover the row
template <typename T, int V>
int run_v(const T* x, const T* w, int8_t* q, float* sx, int M, int D, float eps,
          cudaStream_t stream) {
  const int vecs = (D + V - 1) / V;
  int threads = kThreads, S = 1;
  while (S < kMaxS && threads * S < vecs) S *= 2;
  if (threads * S < vecs || M < sm_count()) {
    threads = (vecs + 31) / 32 * 32, S = 1;
    while (threads > kMaxThreads && S < kMaxS)
      S *= 2, threads = ((vecs + S - 1) / S + 31) / 32 * 32;
    if (threads > kMaxThreads) return int(cudaErrorInvalidValue);
    if (threads > kThreads)
      return launch_s<T, V, kMaxThreads>(S, threads, x, w, q, sx, M, D, eps, stream);
  }
  return launch_s<T, V, kThreads>(S, threads, x, w, q, sx, M, D, eps, stream);
}

template <typename T>
int run(const void* x, const void* w, void* q, void* sx, int M, int D, float eps,
        cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(sx);
  if (D % V == 0 && aligned(x) && aligned(w) && aligned(q))
    return run_v<T, V>(xp, wp, qp, sp, M, D, eps, stream);
  return run_v<T, 1>(xp, wp, qp, sp, M, D, eps, stream);
}

}  // namespace ovla_rmsq

// Returns the launch's cudaError_t (0 on success). x [M, D] and w [D] (both bf16 or both fp32),
// q int8 [M, D], sx fp32 [M]: all contiguous; D at most 4096 · V (32,768 bf16 or 16,384 fp32
// elements with 16-byte vectors, 4096 with one-element ones).
extern "C" int ovla_rms_norm_quant(const void* x, const void* w, void* q, void* sx, int M, int D,
                                   float eps, int is_bf16, void* stream) {
  if (M < 1 || D < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return ovla_rmsq::run<__nv_bfloat16>(x, w, q, sx, M, D, eps, st);
  return ovla_rmsq::run<float>(x, w, q, sx, M, D, eps, st);
}
