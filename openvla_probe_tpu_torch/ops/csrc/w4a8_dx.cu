// w4a8_dx: the straight-through backward of the grouped-int4 products,
// dx = g · dequant(W), with the weight dequantized on chip.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/linear.py::_w4a8_dx_kernel
// (reached through _w4a8_dx_pallas from _w4a8_ste_bwd, the backward of both
// w4a8 forwards). Semantics kept exactly:
//   dx[m, gi·gsz + j] = Σ_n bf16(g[m, n] · s[n, gi]) · code[gi, n, j]
// the scaled gradient rounded to bf16 (round to nearest even) even where g is
// fp32, the codes widened to bf16 exactly, bf16 products (exact in fp32)
// summed in fp32 over all N, the sum cast to g's type. Only the order of the
// fp32 sums differs from the TPU kernel (and from w4a8_dx_plain).
//
// Layouts: g [M, N] row-major (bf16 or fp32); q uint8 [G, N, gsz/2], the
// port's packed int4 codes (byte b of a row: code 2b in its low nibble, 2b + 1
// in its high nibble, two's complement); s fp32 [N, G]; dx [M, G·gsz] in g's
// type. The wrapper sends N and gsz multiples of 128 here (the JAX chip rule);
// the rest take the bf16-dequant product in PyTorch.
//
// Bound on the H100 at the OpenVLA-7B QLoRA shapes (B = 8, T = 320, M = 2560;
// g [2560, 4096] against 32 groups of [4096, 128] codes, g [2560, 11008]
// against 32 of [11008, 128], g [2560, 4096] against 86 of [4096, 128]): 86,
// 231 and 231 GFLOP of bf16 products (0.087 / 0.233 / 0.233 ms at
// 989 TFLOP/s) against 37, 79 and 37 MB of g, codes, scales and dx
// (0.011-0.024 ms at 3.35 TB/s): bound by the tensor cores' operations.
//
// Design: right first, simple. A block owns one [64, 128] tile of dx: 64 rows
// of M and 128 columns of one group (gsz a multiple of 128, so a tile never
// spans two groups and the scale is a per-n vector inside it: no transposes).
// It walks N in chunks of 64: the g stripe [64, 64] is loaded, multiplied by
// s[n, gi] in fp32 and rounded to bf16 into shared memory (the A operand,
// row-major over n); the packed codes [64 n, 128 j] are widened to bf16 and
// stored transposed, [j][n], so that each B fragment register holds two
// consecutive n of one column j, as mma.sync m16n8k16 .row.col wants it (the
// contraction runs over the weight's OUT dim n; the forward contracts over
// its in dim). 8 warps, each 32 rows x 32 columns: 2 x 4 mma.sync m16n8k16
// bf16 -> fp32 per 16-deep step. Blocks walk the groups fastest, so the
// blocks in flight share their g rows through L2. No cp.async ring, no
// wgmma / TMA: that is later work (ROADMAP).
#include "attention_common.cuh"

namespace ovla_dx {

using ovla::lds32;
using ovla::mma_bf16;

constexpr int kBM = 64;              // rows of M per block
constexpr int kBJ = 128;             // dx columns per block (one group's slice)
constexpr int kBN = 64;              // n per staged chunk
constexpr int kThreads = 256;        // 8 warps: 2 (rows) x 4 (columns)
constexpr int kPitch = kBN + 8;      // bf16 pitch of both tiles: 4-word bank skew

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h), v[2 * i + 1] = __high2float(h);
  }
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// code e (0..7) of a word of 8 packed codes, sign-extended, as bf16 (exact)
__device__ __forceinline__ __nv_bfloat16 code_bf16(uint32_t w, int e) {
  const int v = int((w >> (4 * e)) & 0xFu);
  return __int2bfloat16_rn((v ^ 8) - 8);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    w4a8_dx_kernel(const T* __restrict__ g, const uint8_t* __restrict__ q,
                   const float* __restrict__ s, T* __restrict__ dx, int M, int N, int G, int gsz) {
  __shared__ __align__(16) __nv_bfloat16 gs_s[kBM * kPitch];   // bf16(g · s) [m][n]
  __shared__ __align__(16) __nv_bfloat16 cs_s[kBJ * kPitch];   // codes, transposed [j][n]

  const int col0 = blockIdx.x * kBJ, m0 = blockIdx.y * kBM;
  const int gi = col0 / gsz, j0 = col0 - gi * gsz;
  const int K = G * gsz, half = gsz / 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wj = warp >> 1;
  const uint8_t* qg = q + (size_t)gi * N * half + j0 / 2;   // row n at qg + n * half

  float acc[2][4][4] = {};
  for (int n0 = 0; n0 < N; n0 += kBN) {
    __syncthreads();   // the previous chunk's tiles consumed
    // A: 64 x 64 scaled gradients, 8 consecutive n per task
    for (int i = tid; i < kBM * kBN / 8; i += kThreads) {
      const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8, m = m0 + r;
      float v[8];
      if (m < M) {
        load8(g + (size_t)m * N + n0 + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      __nv_bfloat16* dst = gs_s + r * kPitch + c;
#pragma unroll
      for (int e = 0; e < 8; e += 2)
        store2(dst + e, v[e] * __ldg(s + (size_t)(n0 + c + e) * G + gi),
               v[e + 1] * __ldg(s + (size_t)(n0 + c + e + 1) * G + gi));
    }
    // B: rows n0 + 2 rp and n0 + 2 rp + 1, 16 codes each (8 bytes) at code
    // 32 c + 16 wh; stored as pairs (n, n + 1) of one column j
    {
      const int rp = tid % 32, c = (tid / 32) % 4, wh = tid / 128;
      const size_t off = (size_t)(n0 + 2 * rp) * half + 16 * c + 8 * wh;
      const uint2 a = *reinterpret_cast<const uint2*>(qg + off);
      const uint2 b = *reinterpret_cast<const uint2*>(qg + off + half);
      const uint32_t wa[2] = {a.x, a.y}, wb[2] = {b.x, b.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = 32 * c + 16 * wh + 8 * h + e;
          __nv_bfloat162 pair;
          pair.x = code_bf16(wa[h], e);
          pair.y = code_bf16(wb[h], e);
          *reinterpret_cast<__nv_bfloat162*>(cs_s + j * kPitch + 2 * rp) = pair;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBN; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* pa = gs_s + (wm * 32 + mt * 16 + gq) * kPitch + kk + 2 * t4;
        a[mt][0] = lds32(pa);
        a[mt][1] = lds32(pa + 8 * kPitch);
        a[mt][2] = lds32(pa + 8);
        a[mt][3] = lds32(pa + 8 * kPitch + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* pb = cs_s + (wj * 32 + nt * 8 + gq) * kPitch + kk + 2 * t4;
        const uint32_t b0 = lds32(pb), b1 = lds32(pb + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wm * 32 + mt * 16 + gq + 8 * hr;
      if (m >= M) continue;
      T* row = dx + (size_t)m * K + col0 + wj * 32 + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store2(row + nt * 8, acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
    }
  }
}

template <typename T>
int launch(const void* g, const void* q, const float* s, void* dx, int M, int N, int G, int gsz,
           cudaStream_t stream) {
  const dim3 grid(G * gsz / kBJ, (M + kBM - 1) / kBM);
  w4a8_dx_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(g),
                                                   static_cast<const uint8_t*>(q), s,
                                                   static_cast<T*>(dx), M, N, G, gsz);
  return int(cudaGetLastError());
}

}  // namespace ovla_dx

// Returns the launch's cudaError_t (0 on success); cudaErrorInvalidValue for
// shapes the kernel does not take (N or gsz not a multiple of 128, M past the
// grid's 65535 row blocks).
extern "C" int ovla_w4a8_dx(const void* g, const void* q, const float* s, void* dx, int M, int N,
                            int G, int gsz, int is_bf16, void* stream) {
  if (M < 1 || (M + ovla_dx::kBM - 1) / ovla_dx::kBM > 65535 || N < 128 || N % 128 ||
      gsz < 128 || gsz % 128 || G < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ovla_dx::launch<__nv_bfloat16>(g, q, s, dx, M, N, G, gsz, st)
                 : ovla_dx::launch<float>(g, q, s, dx, M, N, G, gsz, st);
}
