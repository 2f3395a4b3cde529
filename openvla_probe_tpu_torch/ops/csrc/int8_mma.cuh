// Pieces shared by the int8 tensor-core GEMMs (w4a8_matmul.cu, w8a8_matmul.cu, nib_hi_dot.cu,
// vit_mlp.cu, int8_decode.cuh, int8_wgmma.cuh; vit_attention.cu takes the cp.async pieces):
// the cp.async ring, ldmatrix, the mma.sync m16n8k32 s8 x s8 -> s32 instruction, the per-row
// activation quantization of the JAX package (clip(rint(x / s_x), -127, 127) with IEEE
// division, round half to even) and the pre-pass kernels that apply it (quant_rows; ln_quant_rows,
// a LayerNorm first, for vit_mlp.cu), the k order
// that lets packed 4-bit codes feed a fragment, and the widening of packed 4-bit codes (one
// plane, or the two nibble planes rebuilt into their exact int8 codes, or grouped int4 codes
// requantized to int8 by a per-row table) in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovla_i8 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a 16-byte copy into shared memory; src_bytes = 0 zero-fills it (a ragged edge)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(a), v[1] = __high2float(a), v[2] = __low2float(b), v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {   // exact: v was bf16
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
// round an fp32 value to T and back: a T-typed intermediate of the function
template <typename T>
__device__ __forceinline__ float rt(float x);
template <>
__device__ __forceinline__ float rt<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rt<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int quant_code(float h, float sx) {
  return __float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(h, sx)), -127.f), 127.f));
}

// Activation codes for packed 4-bit weights: a B fragment widens 8 consecutive codes
// 8 t4 .. 8 t4 + 7 of a channel into the registers that pair with A's k 4 t4 .. 4 t4 + 3 and
// 16 + 4 t4 .. 16 + 4 t4 + 3, so in each 32-code block the activation codes 8 t4 + i are stored
// at 4 t4 + i and 8 t4 + 4 + i at 16 + 4 t4 + i (an integer dot product does not depend on the
// order of its terms).
__device__ __forceinline__ int stored_offset(int k) {   // k: a multiple of 4
  const int c4 = (k & 31) >> 2;                          // 4-code chunk within the block
  return (k & ~31) + 4 * ((c4 & 1) ? 4 + (c4 >> 1) : (c4 >> 1));
}

// ---------------------------------------------------------------------------
// The activation pre-pass of the three GEMMs, its own launch before each GEMM: per-row int8
// codes [M, K] and scales s_x [M], one block per row (a warp per row leaves decode-sized M with
// a few warps looping over K one load latency at a time). PERM stores each 32-code block in the
// k order of the packed-code fragments (stored_offset), for 4-bit weights; ROWSUM also writes
// the exact row sums of the codes (nib_hi_dot's correction term). K: a multiple of 4. The row
// is read from device memory once: the max pass keeps it in shared memory for the code pass
// when it fits in the 48 KB a launch takes without opting in, beside the kernel's static
// reduction slots (read twice, a long row missed the L2 at prefill M: 0.138 ms for
// 6912 x 11008 bf16 rows on an H100, 0.099 read once; PERF.md §6). `fn` maps each value first
// (the identity, or vit_mlp.cu's activation rounded to T: the codes of act(x)). kThr threads a
// row: kQThreads, or 512 for w4a8_grouped.cu's decode rows (fewer dependent loads a thread:
// 0.0062 against 0.0071 ms for 24 x 4096 bf16 rows; PERF.md §6); the codes do not depend on it.
constexpr int kQThreads = 128;
constexpr int kQRowBytes = 48 * 1024 - 256;

struct Ident {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

template <typename T, bool PERM, bool ROWSUM, class Fn, int kThr>
__global__ void __launch_bounds__(kThr)
    quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx,
                      int* __restrict__ rowsum, int K, int cached, const Fn fn) {
  __shared__ float red[kThr / 32];
  __shared__ int ired[kThr / 32];
  extern __shared__ __align__(16) uint8_t qr_raw[];
  T* row_s = reinterpret_cast<T*>(qr_raw);   // the row, when `cached`
  const int row = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* xr = x + (long long)row * K;
  // a grid launched as this one's programmatic dependent (w4a8_grouped.cu's GEMM) may start now:
  // it waits (griddepcontrol.wait) for this grid's completion before it reads the codes; for a
  // grid launched without that attribute, a no-op
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  float amax = 0.f;
#pragma unroll 4
  for (int k = 4 * threadIdx.x; k < K; k += 4 * kThr) {
    float v[4];
    load4(xr + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = fn(v[i]);
    if (cached) store4(row_s + k, v);   // exact: fn's values are T values
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))));
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, w));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThr / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  int8_t* qr = xq + (long long)row * K;
  int sum = 0;
  const T* src = cached ? row_s : xr;
#pragma unroll 4
  for (int k = 4 * threadIdx.x; k < K; k += 4 * kThr) {
    float v[4];
    load4(src + k, v);
    if (!cached) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = fn(v[i]);
    }
    const int c0 = quant_code(v[0], s), c1 = quant_code(v[1], s);
    const int c2 = quant_code(v[2], s), c3 = quant_code(v[3], s);
    if constexpr (ROWSUM) sum += c0 + c1 + c2 + c3;
    char4 c;
    c.x = static_cast<signed char>(c0), c.y = static_cast<signed char>(c1);
    c.z = static_cast<signed char>(c2), c.w = static_cast<signed char>(c3);
    *reinterpret_cast<char4*>(qr + (PERM ? stored_offset(k) : k)) = c;
  }
  if constexpr (ROWSUM) {
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (lane == 0) ired[warp] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kThr / 32; ++w) total += ired[w];
      rowsum[row] = total;
    }
  }
  if (threadIdx.x == 0) sx[row] = s;
}

template <typename T, bool PERM, bool ROWSUM, class Fn = Ident, int kThr = kQThreads>
cudaError_t quant_rows(const void* x, int8_t* xq, float* sx, int* rowsum, int M, int K,
                       cudaStream_t stream, const Fn& fn = Fn{}) {
  const size_t row_bytes = size_t(K) * sizeof(T);
  const int cached = row_bytes <= size_t(kQRowBytes);
  quant_rows_kernel<T, PERM, ROWSUM, Fn, kThr><<<M, kThr, cached ? row_bytes : 0, stream>>>(
      static_cast<const T*>(x), xq, sx, rowsum, K, cached, fn);
  return cudaGetLastError();
}

// The LayerNorm pre-pass of the fused tower GEMMs (vit_mlp.cu): h = rt_T(LayerNorm(x)) in fp32,
// each op rounded once (mean = Σ x / K; var = Σ (x - mean)² / K; h = (x - mean) · rsqrt(var + eps)
// · scale + bias, rounded to T), then quant_rows' per-row codes and s_x of h. One block a row, the
// row cached in shared memory (and h written over it) when it fits, as quant_rows; the sums in a
// fixed order: each thread its 4-vectors k = 4 tid + 512 i in turn, the elements in k order, then
// the warp's 32 partials by an xor butterfly (16, 8, 4, 2, 1), then the 4 warps' in warp order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int w = 1; w < kQThreads / 32; ++w) t += red[w];
  __syncthreads();   // red is free again
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kQThreads)
    ln_quant_rows_kernel(const T* __restrict__ x, const T* __restrict__ sc,
                         const T* __restrict__ bi, float eps, int8_t* __restrict__ xq,
                         float* __restrict__ sx, int K, int cached) {
  __shared__ float red[kQThreads / 32];
  extern __shared__ __align__(16) uint8_t qr_raw[];
  T* row_s = reinterpret_cast<T*>(qr_raw);   // the row, then h, when `cached`
  const int row = blockIdx.x;
  const T* xr = x + (long long)row * K;
  float sum = 0.f;
  for (int k = 4 * threadIdx.x; k < K; k += 4 * kQThreads) {
    float v[4];
    load4(xr + k, v);
    if (cached) store4(row_s + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) sum += v[i];
  }
  const float mean = __fdiv_rn(block_sum(sum, red), float(K));
  const T* src = cached ? row_s : xr;
  float sq = 0.f;
  for (int k = 4 * threadIdx.x; k < K; k += 4 * kQThreads) {
    float v[4];
    load4(src + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dv = __fsub_rn(v[i], mean);
      sq = __fadd_rn(sq, __fmul_rn(dv, dv));
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(block_sum(sq, red), float(K)), eps));
  auto ln = [&](int k, float (&h)[4]) {   // h at k .. k + 3, from the row's x
    float v[4], s4[4], b4[4];
    load4(src + k, v);
    load4(sc + k, s4);
    load4(bi + k, b4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = rt<T>(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), rstd), s4[i]), b4[i]));
  };
  float amax = 0.f;
  for (int k = 4 * threadIdx.x; k < K; k += 4 * kQThreads) {
    float h[4];
    ln(k, h);
    if (cached) store4(row_s + k, h);   // this thread's own elements: no other reads them
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(h[0]), fabsf(h[1])), fmaxf(fabsf(h[2]), fabsf(h[3]))));
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, w));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  int8_t* qr = xq + (long long)row * K;
  for (int k = 4 * threadIdx.x; k < K; k += 4 * kQThreads) {
    float h[4];
    if (cached)
      load4(row_s + k, h);
    else
      ln(k, h);
    char4 c;
    c.x = static_cast<signed char>(quant_code(h[0], s));
    c.y = static_cast<signed char>(quant_code(h[1], s));
    c.z = static_cast<signed char>(quant_code(h[2], s));
    c.w = static_cast<signed char>(quant_code(h[3], s));
    *reinterpret_cast<char4*>(qr + k) = c;
  }
  if (threadIdx.x == 0) sx[row] = s;
}

template <typename T>
cudaError_t ln_quant_rows(const void* x, const void* sc, const void* bi, float eps, int8_t* xq,
                          float* sx, int M, int K, cudaStream_t stream) {
  const size_t row_bytes = size_t(K) * sizeof(T);
  const int cached = row_bytes <= size_t(kQRowBytes);
  ln_quant_rows_kernel<T><<<M, kQThreads, cached ? row_bytes : 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(sc), static_cast<const T*>(bi), eps, xq, sx,
      K, cached);
  return cudaGetLastError();
}

// 8 packed codes (4 bytes; byte j: code 2j in its low nibble, 2j + 1 in its high nibble) ->
// 8 sign-extended int8 codes in k order (2 words)
__device__ __forceinline__ void widen(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t a = w & 0x0F0F0F0Fu;          // codes 0, 2, 4, 6 (low nibbles)
  const uint32_t b = (w >> 4) & 0x0F0F0F0Fu;   // codes 1, 3, 5, 7 (high nibbles)
  lo = __byte_perm(a, b, 0x5140);              // codes 0, 1, 2, 3
  hi = __byte_perm(a, b, 0x7362);              // codes 4, 5, 6, 7
  // each byte v in 0..15 -> (v ^ 8) - 8, the two's complement nibble widened
  lo = __vsub4(lo ^ 0x08080808u, 0x08080808u);
  hi = __vsub4(hi ^ 0x08080808u, 0x08080808u);
}

// 8 packed codes of each nibble plane (one word each, as `widen` takes them) -> the 8 exact int8
// codes 16·hi + lo + 8 in k order (two words). As a byte, 16·hi + lo + 8 is
// (hi's nibble << 4) | (lo's nibble ^ 8): the low nibble is lo + 8 in 0..15 and
// 16·hi + 128 ≡ hi's nibble << 4 (mod 256), so no intermediate leaves its range
// (openvla_probe_tpu/ops/linear.py::nibble_reconstruct_q8, fused into the loaders).
__device__ __forceinline__ void rebuild(uint32_t ph, uint32_t pl, uint32_t& w0, uint32_t& w1) {
  const uint32_t ev = ((ph & 0x0F0F0F0Fu) << 4) | ((pl & 0x0F0F0F0Fu) ^ 0x08080808u);  // 0 2 4 6
  const uint32_t od = (ph & 0xF0F0F0F0u) | (((pl >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);  // 1 3 5 7
  w0 = __byte_perm(ev, od, 0x5140);   // codes 0, 1, 2, 3
  w1 = __byte_perm(ev, od, 0x7362);   // codes 4, 5, 6, 7
}

// ---------------------------------------------------------------------------
// The int4 requant (openvla_probe_tpu/ops/linear.py::_w4a8_dot_requant, fused into the loaders):
// per weight row n, s8 = f32(max_g s[n, g]) · f32(7/127); per group, r = s[n, g] / (s8 + 1e-30)
// (IEEE division); code = clip(rint(f32(q4) · r), -127, 127). The constants are the float32
// roundings of the doubles 7/127 and 1e-30, as the JAX package's weak-typed Python floats are.
constexpr float kReqS8 = static_cast<float>(7.0 / 127.0);
constexpr float kReqTiny = static_cast<float>(1e-30);

__device__ __forceinline__ float requant_r(float s, float s8) {
  return __fdiv_rn(s, __fadd_rn(s8, kReqTiny));
}
// clip(rint(q · r), -127, 127): the product rounded once, then rounded half to even
__device__ __forceinline__ int requant_code(int q, float r) {
  return min(max(__float2int_rn(__fmul_rn(static_cast<float>(q), r)), -127), 127);
}

// A row's requant table: byte v of the four words is the code of the packed nibble v (v = 0..15,
// q4 = v - 16 · (v >= 8)). The four lanes t4 = 0..3 that hold one weight row in a fragment each
// compute one word (its four entries) from the row's r and gather the other three by shuffles.
struct Lut {
  uint32_t t[4];
};
__device__ __forceinline__ Lut requant_lut(float r, int lane) {
  const int t4 = lane & 3, q0 = t4 < 2 ? 4 * t4 : 4 * t4 - 16;
  const uint32_t c0 = requant_code(q0, r) & 0xFF, c1 = requant_code(q0 + 1, r) & 0xFF;
  const uint32_t c2 = requant_code(q0 + 2, r) & 0xFF, c3 = requant_code(q0 + 3, r) & 0xFF;
  const uint32_t word = c0 | (c1 << 8) | (c2 << 16) | (c3 << 24);
  Lut L;
#pragma unroll
  for (int j = 0; j < 4; ++j) L.t[j] = __shfl_sync(0xffffffffu, word, (lane & ~3) | j);
  return L;
}
// 8 packed codes (one word, as `widen` takes it: nibble i is code i) -> their 8 requantized int8
// codes in k order (two words), by table: each nibble's low 3 bits pick a byte of the half-table
// of nibbles 0..7 and of 8..15, and its high bit the half (selectors kept below 8: __byte_perm's
// sign-replicating selectors are never used)
__device__ __forceinline__ uint32_t lut4(uint32_t sel, uint32_t half, const Lut& L) {
  const uint32_t a = __byte_perm(L.t[0], L.t[1], sel), b = __byte_perm(L.t[2], L.t[3], sel);
  const uint32_t k = __byte_perm(0u, 0xFFFFFFFFu, half);   // 0xFF in the bytes of nibbles >= 8
  return (a & ~k) | (b & k);
}
__device__ __forceinline__ void requant(uint32_t p, const Lut& L, uint32_t& w0, uint32_t& w1) {
  const uint32_t sel = p & 0x77777777u, half = (p >> 1) & 0x44444444u;
  w0 = lut4(sel, half, L);                 // codes 0, 1, 2, 3
  w1 = lut4(sel >> 16, half >> 16, L);     // codes 4, 5, 6, 7
}

}  // namespace ovla_i8
