// Fused int8 (w8a8) kernels of a quantized ViT tower block:
//
//   fused_ln_w8a8       out = [res +] [ls ·] (w8a8(LN?(x)) + b)        (qkv entry, proj exit)
//   fused_mlp_residual  out = x + ls2 · (w8a8_fc2(act(w8a8_fc1(LN2(x)) + b1)) + b2)
//
// Replace the TPU kernels openvla_probe_tpu/ops/vit_mlp.py::_ln_w8a8_kernel
// (through fused_ln_w8a8) and ::_vit_mlp_kernel (through fused_mlp_residual).
// Cast points kept exactly: LayerNorm in fp32, rounded to the input type T;
// per-row sx = max(max|h| / 127, 1e-8) from the rounded value; codes
// clip(rint(h / sx), -127, 127) with an IEEE division and round-half-even;
// the int8 x int8 product accumulated in int32 (exact, so any order gives the
// same integer); ((acc · sx) · s) in fp32, cast to T; bias add, LayerScale
// multiply and residual add each in T (fp32 op, one rounding); activation in
// fp32, cast to T. Built without fast math, and every fp32 op whose
// contraction into an FMA would change its rounding is written with the _rn
// intrinsics.
//
// Bound on the H100 at the OpenVLA-7B shapes (B = 24; DINOv2 M = 6264,
// D = 1024, F = 4096; SigLIP M = 6144, D = 1152, F = 4304): the products are
// 13-105 GOP per launch against 15-40 MB, so both are bound by int8
// tensor-core operations (7-53 us at 1979 TOP/s).
//
// Design. mma.sync m16n8k32 s8 x s8 -> s32. A block owns a tile of rows and
// keeps their int8 activation codes resident in shared memory for the whole
// K (the TPU kernels keep them in VMEM); the weights, [N, K] int8, stream
// through a cp.async ring of 128-byte-deep chunks, mostly from L2 (a tower's
// weights, 8.4-9.9 MB, fit in the 50 MB L2 that all blocks share), with one
// barrier per chunk. Both kernels are bound by that L2 stream at these sizes,
// so the design question is how many rows share each weight byte.
//   * fused_ln_w8a8: 32 rows x 1024 output columns per block; the LayerNorm
//     and the quantization of the block's rows are recomputed per column
//     block (four passes over K against 1024 K multiply-adds).
//   * fused_mlp_residual: the TPU kernel keeps both weight matrices and the
//     [bm, F] intermediate in VMEM; a Hopper block has 227 KB. A cluster of
//     two blocks owns 32 rows: block c computes fc1 for its half of F and
//     keeps that half of g (32 x F/2 in T: 138 KB at F = 4304) in shared
//     memory; fc2's row quantization needs each row's max over all of F, so
//     the pair exchanges row maxima through distributed shared memory, each
//     block quantizes its half of g in place and copies the other half's
//     codes from its peer, then computes fc2 for its half of D. Each block
//     streams half of each weight matrix, a quarter of the weight bytes per
//     row of a 16-row block streaming both. The [M, F] intermediate never
//     touches device memory.
// F = 4304 (SigLIP) is no multiple of 32 or 64: the fc1 output columns past
// F are dropped, and fc2's K tail (codes and weights) is zero-filled, which
// adds nothing to the integer sums.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace ovla {

constexpr int kVmThreads = 256;   // 8 warps
constexpr int kChunkK = 128;      // weight bytes (k) per staged chunk
constexpr int kChunkP = kChunkK + 16;   // staged pitch: 36 words, conflict-free fragments

// A ring of STAGES weight chunks of CHUNK_N rows (output columns) x 128 bytes (k)
template <int CHUNK_N, int STAGES>
struct Ring {
  static constexpr int kChunkN = CHUNK_N, kStages = STAGES;
  static constexpr int kStageBytes = CHUNK_N * kChunkP;
  static constexpr int kBytes = STAGES * kStageBytes;
};
// Per chunk a block pays a barrier and its fragment loads, so each ring uses
// the largest chunks its block's shared memory leaves room for, ahead of
// more chunks in flight.
using LnRing = Ring<128, 3>;    // two 16 KB chunks in flight
using MlpRing = Ring<128, 2>;   // one 16 KB chunk in flight

__device__ __forceinline__ uint32_t vm_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void vm_cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(vm_smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void vm_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void vm_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void vm_ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(vm_smem_u32(p)));
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float vm_f32(float x) { return x; }
__device__ __forceinline__ float vm_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T vm_cast(float x);
template <>
__device__ __forceinline__ float vm_cast<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 vm_cast<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even
}
// round an fp32 value to T and back: the T-typed intermediates of the XLA chain
template <typename T>
__device__ __forceinline__ float rt(float x) { return vm_f32(vm_cast<T>(x)); }

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// activation in fp32, the same expressions as PyTorch's CUDA GELU
__device__ __forceinline__ float vm_act(float x, int act) {
  if (act == 0) return x * 0.5f * (1.0f + erff(x * float(M_SQRT1_2)));           // gelu (erf)
  if (act == 1) {                                                                 // gelu_tanh
    const float kBeta = float(M_SQRT2 * M_2_SQRTPI * 0.5), kKappa = 0.044715f;
    const float inner = kBeta * (x + kKappa * (x * x * x));
    return 0.5f * x * (1.0f + tanhf(inner));
  }
  return x * (1.0f / (1.0f + expf(-(1.702f * x))));                               // quick_gelu
}

__device__ __forceinline__ int8_t quant_code(float h, float sx) {
  const float c = fminf(fmaxf(rintf(__fdiv_rn(h, sx)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(c));
}

// One warp: LayerNorm (optional) + per-row int8 quantization of one row of K
// values into `codes` (zero-filled up to KR) and its scale into *sx.
template <typename T>
__device__ void ln_quant_row(const T* __restrict__ xr, int K, const T* __restrict__ sc,
                             const T* __restrict__ bi, float eps, int8_t* codes, int KR,
                             float* sx) {
  const int lane = threadIdx.x % 32;
  float mean = 0.f, rstd = 0.f;
  if (sc != nullptr) {
    float sum = 0.f;
    for (int k = lane; k < K; k += 32) sum += vm_f32(xr[k]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    mean = __fdiv_rn(sum, float(K));
    float sq = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float d = __fsub_rn(vm_f32(xr[k]), mean);
      sq = __fadd_rn(sq, __fmul_rn(d, d));
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, w);
    rstd = rsqrtf(__fadd_rn(__fdiv_rn(sq, float(K)), eps));
  }
  auto h_at = [&](int k) -> float {
    const float x = vm_f32(xr[k]);
    if (sc == nullptr) return x;
    const float hn = __fmul_rn(__fsub_rn(x, mean), rstd);
    return rt<T>(__fadd_rn(__fmul_rn(hn, vm_f32(sc[k])), vm_f32(bi[k])));
  };
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(h_at(k)));
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, w));
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  for (int k = lane; k < KR; k += 32) codes[k] = k < K ? quant_code(h_at(k), s) : int8_t(0);
  if (lane == 0) *sx = s;
}

// acc[BM x (n-chunks)] = codes[BM, KR] · W[n, :KR]ᵀ for n in [n_begin, n_end),
// W int8 [N, K] row-major in global memory; epi(r, n, acc) per valid output.
// The weights stream through the ring (one barrier per chunk); BM = 32 rows,
// 8 warps: warp w owns m16 tile (w & 1) and a quarter of each chunk's n8 tiles.
template <int BM, class R, class Epi>
__device__ void gemm_resident_rows(const int8_t* __restrict__ A, int lda,
                                   const int8_t* __restrict__ W, int K, int KR,
                                   int n_begin, int n_end, int8_t* wstage, Epi epi) {
  constexpr int kChunkN = R::kChunkN, kStages = R::kStages, kStageBytes = R::kStageBytes;
  constexpr int MW = BM / 16;                              // warps along m
  constexpr int NTW = (kChunkN / 8) / ((kVmThreads / 32) / MW);   // n8 tiles per warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % MW, wn = warp / MW;
  const int kchunks = KR / kChunkK;
  const int nchunks = (n_end - n_begin + kChunkN - 1) / kChunkN;
  const int total = nchunks * kchunks;

  auto load = [&](int c) {
    const int n0 = n_begin + (c / kchunks) * kChunkN, k0 = (c % kchunks) * kChunkK;
    int8_t* dst = wstage + (c % kStages) * kStageBytes;
    for (int i = threadIdx.x; i < kChunkN * (kChunkK / 16); i += kVmThreads) {
      const int r = i / (kChunkK / 16), cc = i % (kChunkK / 16), n = n0 + r, k = k0 + cc * 16;
      const bool ok = n < n_end && k < K;
      vm_cp_async16(dst + r * kChunkP + cc * 16, ok ? W + (long long)n * K + k : W,
                    ok ? 16 : 0);
    }
  };

  int acc[NTW][4];
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < total) load(c);
    vm_commit();
  }
  for (int c = 0; c < total; ++c) {
    if (c % kchunks == 0) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    }
    vm_wait<kStages - 2>();
    __syncthreads();   // chunk c landed for every thread; chunk c - 1's stage consumed
    if (c + kStages - 1 < total) load(c + kStages - 1);
    vm_commit();
    const int8_t* ws = wstage + (c % kStages) * kStageBytes;
    const int kb = (c % kchunks) * kChunkK;
#pragma unroll
    for (int kk = 0; kk < kChunkK; kk += 32) {
      // ldmatrix on the int8 tiles read as b16: each 8 x 16-byte matrix hands
      // lane (g, t4) bytes 4 t4 .. 4 t4 + 3 of row g, the s8 fragment layout
      uint32_t a[4];
      vm_ldmatrix_x4(a, A + (wm * 16 + (lane & 15)) * lda + kb + kk + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NTW; j += 2) {   // n8 tiles j, j + 1: (n, k 0..15), (n, k 16..31)
        uint32_t b[4];
        const int n = (wn * NTW + j) * 8 + (lane & 7) + ((lane >> 4) << 3);
        vm_ldmatrix_x4(b, ws + n * kChunkP + kk + ((lane >> 3) & 1) * 16);
        mma_s8_16832(acc[j], a, b[0], b[1]);
        mma_s8_16832(acc[j + 1], a, b[2], b[3]);
      }
    }
    if (c % kchunks == kchunks - 1) {
      const int n0 = n_begin + (c / kchunks) * kChunkN;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n = n0 + (wn * NTW + j) * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ne = n + (e & 1);
          if (ne < n_end) epi(wm * 16 + g + (e >> 1) * 8, ne, acc[j][e]);
        }
      }
    }
  }
  vm_wait<0>();
  __syncthreads();   // every warp done with the ring and the resident codes
}

// ---------------------------------------------------------------------------
// fused_ln_w8a8

constexpr int kLnRows = 32;
// Output columns per block: each block redoes its rows' LayerNorm and
// quantization (four passes over each row), so wide column blocks pay off.
constexpr int kLnCols = 1024;

template <typename T>
struct LnArgs {
  const T* x;
  const T* ln_s;   // nullptr: no LayerNorm
  const T* ln_b;
  const int8_t* q;
  const float* s;
  const T* b;
  const T* res;    // nullptr: no residual
  const T* ls;     // nullptr: no LayerScale
  T* out;
  int M, K, N;
  float eps;
  int8_t* codes_out;   // nullptr, or [M, K]: the activation codes (verification)
  float* sx_out;       // nullptr, or [M]: their row scales
};

// Copy a block's resident codes rows [m0, m0 + rows) x [k0, k1) and their
// scales to device memory (for verification against the plain version).
__device__ void dump_codes(const int8_t* codes, int ld, const float* sx, int m0, int rows, int M,
                           int k0, int k1, int K, int8_t* codes_out, float* sx_out) {
  const int w = k1 - k0;
  for (int i = threadIdx.x; i < rows * w; i += kVmThreads) {
    const int r = i / w, k = k0 + i % w;
    if (m0 + r < M) codes_out[(long long)(m0 + r) * K + k] = codes[r * ld + k];
  }
  if (sx_out && threadIdx.x < rows && m0 + int(threadIdx.x) < M) sx_out[m0 + threadIdx.x] = sx[threadIdx.x];
}

__host__ __device__ inline int ln_lda(int K) { return round_up(K, kChunkK) + 16; }
__host__ __device__ inline size_t ln_smem(int K) {
  return size_t(kLnRows) * ln_lda(K) + LnRing::kBytes + kLnRows * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kVmThreads) fused_ln_w8a8_kernel(LnArgs<T> a) {
  extern __shared__ __align__(16) uint8_t vm_smem[];
  const int lda = ln_lda(a.K), KR = round_up(a.K, kChunkK);
  int8_t* codes = reinterpret_cast<int8_t*>(vm_smem);                 // [32][lda]
  int8_t* wstage = codes + kLnRows * lda;                             // the weight ring
  float* sx = reinterpret_cast<float*>(wstage + LnRing::kBytes);      // [32]
  const int m0 = blockIdx.y * kLnRows, warp = threadIdx.x / 32;

  for (int r = warp; r < kLnRows; r += kVmThreads / 32) {
    const int m = min(m0 + r, a.M - 1);   // rows past M: quantize a real row, never stored
    ln_quant_row<T>(a.x + (long long)m * a.K, a.K, a.ln_s, a.ln_b, a.eps, codes + r * lda, KR,
                    sx + r);
  }
  __syncthreads();
  if (a.codes_out && blockIdx.x == 0)
    dump_codes(codes, lda, sx, m0, kLnRows, a.M, 0, a.K, a.K, a.codes_out, a.sx_out);

  const int n_begin = blockIdx.x * kLnCols, n_end = min(a.N, n_begin + kLnCols);
  gemm_resident_rows<kLnRows, LnRing>(codes, lda, a.q, a.K, KR, n_begin, n_end, wstage,
                              [&](int r, int n, int acc) {
                                const int m = m0 + r;
                                if (m >= a.M) return;
                                float y = rt<T>(__fmul_rn(__fmul_rn(float(acc), sx[r]), a.s[n]));
                                y = rt<T>(__fadd_rn(y, vm_f32(a.b[n])));
                                if (a.ls) y = rt<T>(__fmul_rn(y, vm_f32(a.ls[n])));
                                const long long o = (long long)m * a.N + n;
                                if (a.res) y = __fadd_rn(vm_f32(a.res[o]), y);
                                a.out[o] = vm_cast<T>(y);
                              });
}

// ---------------------------------------------------------------------------
// fused_mlp_residual

constexpr int kMlpRows = 32;

template <typename T>
struct MlpArgs {
  const T* x;
  const T* ln_s;
  const T* ln_b;
  const int8_t* q1;   // [F, D]
  const float* s1;
  const T* b1;
  const int8_t* q2;   // [D, F]
  const float* s2;
  const T* b2;
  const T* ls2;
  T* out;
  int M, D, F;
  float eps;
  int act;
  int8_t* h8_out;   // nullptr, or [M, D] / [M] / [M, F] / [M]: the LN2 codes, their
  float* sx1_out;   // scales, the g codes and their scales (verification)
  int8_t* g8_out;
  float* sx2_out;
};

// One cluster of two blocks owns 32 rows. Block c computes fc1 for its half
// of F, the halves exchange their row maxima, each quantizes its half of g in
// place, copies the other half's codes from its peer's shared memory, and
// computes fc2 for its half of D over all of F. Each block streams half of
// each weight matrix, so a row costs a quarter of the weight bytes of a
// 16-row block that streams both whole.
template <typename T>
struct MlpLayout {
  int fsplit, dsplit, ldh, pitch;
  __host__ __device__ MlpLayout(int D, int F) {
    fsplit = round_up((F + 1) / 2, 16);        // fc1 columns / g codes of block 0
    dsplit = round_up((D + 1) / 2, 8);         // fc2 columns of block 0
    ldh = round_up(D, kChunkK) + 16;           // LN2(x) codes [32][ldh]
    // one row of the g region: block c's half of g (in T) at byte 0, then the
    // row's int8 codes over all of F (round_up(F, 128) + 16 bytes) written
    // over it; 16 mod 128 bytes of skew keep the fragment loads conflict-free
    const int codes = round_up(F, kChunkK) + 16;
    const int g = round_up(fsplit * int(sizeof(T)), 16);
    pitch = codes >= g ? codes : round_up(g - 16, kChunkK) + 16;
  }
  __host__ __device__ size_t smem() const {
    return size_t(kMlpRows) * pitch + size_t(kMlpRows) * ldh + MlpRing::kBytes +
           (3 * kMlpRows + (kVmThreads / 32) * kMlpRows) * sizeof(float);
  }
};

template <typename T>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kVmThreads)
    fused_mlp_residual_kernel(MlpArgs<T> a) {
  extern __shared__ __align__(16) uint8_t vm_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank()), peer = rank ^ 1;
  const MlpLayout<T> L(a.D, a.F);
  uint8_t* gr = vm_smem;                                                   // [32][pitch]
  int8_t* h8 = reinterpret_cast<int8_t*>(gr + kMlpRows * L.pitch);         // [32][ldh]
  int8_t* wstage = h8 + kMlpRows * L.ldh;                                  // the weight ring
  float* sx1 = reinterpret_cast<float*>(wstage + MlpRing::kBytes);         // [32]
  float* sx2 = sx1 + kMlpRows;                                             // [32]
  float* amax_part = sx2 + kMlpRows;                                       // [32], read by the peer
  float* amax_w = amax_part + kMlpRows;                                    // [8 warps][32]
  const int m0 = (blockIdx.x / 2) * kMlpRows, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int DR = round_up(a.D, kChunkK), FR = round_up(a.F, kChunkK);
  const int f0 = rank * L.fsplit, f1 = rank ? a.F : min(a.F, L.fsplit);   // this block's F half
  const int c0 = rank * L.fsplit, c1 = rank ? FR : L.fsplit;             // ... of the codes, tail zeros
  auto g_at = [&](int r, int j) -> T& {   // g of column f0 + j of row r
    return reinterpret_cast<T*>(gr + r * L.pitch)[j];
  };

  // LN2 + quantize the cluster's rows (each block does all 32)
  for (int r = warp; r < kMlpRows; r += kVmThreads / 32) {
    const int m = min(m0 + r, a.M - 1);   // rows past M: a real row, never stored
    ln_quant_row<T>(a.x + (long long)m * a.D, a.D, a.ln_s, a.ln_b, a.eps, h8 + r * L.ldh, DR,
                    sx1 + r);
  }
  __syncthreads();
  if (a.h8_out && rank == 0)
    dump_codes(h8, L.ldh, sx1, m0, kMlpRows, a.M, 0, a.D, a.D, a.h8_out, a.sx1_out);

  // fc1 + bias + activation over this block's F half -> g (in T), with each
  // row's max |g| per thread: rows (lane >> 2) + 8 e for e = 0..3
  float amax[4] = {0.f, 0.f, 0.f, 0.f};
  gemm_resident_rows<kMlpRows, MlpRing>(h8, L.ldh, a.q1, a.D, DR, f0, f1, wstage,
                                        [&](int r, int n, int acc) {
                                          float y = rt<T>(__fmul_rn(__fmul_rn(float(acc), sx1[r]), a.s1[n]));
                                          y = rt<T>(__fadd_rn(y, vm_f32(a.b1[n])));
                                          const float gv = rt<T>(vm_act(y, a.act));
                                          g_at(r, n - f0) = vm_cast<T>(gv);
                                          amax[(r >> 3) & 3] = fmaxf(amax[(r >> 3) & 3], fabsf(gv));
                                        });
  // row maxima: lanes of one row share lane >> 2, then the warps, then the pair
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = amax[e];
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    if ((lane & 3) == 0) amax_w[warp * kMlpRows + (lane >> 2) + 8 * e] = v;
  }
  __syncthreads();
  if (threadIdx.x < kMlpRows) {
    float v = 0.f;
    for (int w = 0; w < kVmThreads / 32; ++w) v = fmaxf(v, amax_w[w * kMlpRows + threadIdx.x]);
    amax_part[threadIdx.x] = v;
  }
  cluster.sync();   // both halves' row maxima written
  if (threadIdx.x < kMlpRows) {
    const float* peer_part = cluster.map_shared_rank(amax_part, peer);
    const float v = fmaxf(amax_part[threadIdx.x], peer_part[threadIdx.x]);
    sx2[threadIdx.x] = fmaxf(__fdiv_rn(v, 127.f), 1e-8f);
  }
  __syncthreads();

  // quantize this block's half of g row by row into the row's codes: the
  // codes of row r stay inside row r, which is read into registers first
  constexpr int kPer = 16;   // codes per thread per row (half of F <= 4096)
  for (int r = 0; r < kMlpRows; ++r) {
    int8_t c[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = c0 + threadIdx.x + i * kVmThreads;
      c[i] = k < f1 ? quant_code(vm_f32(g_at(r, k - f0)), sx2[r]) : int8_t(0);
    }
    __syncthreads();
    int8_t* row = reinterpret_cast<int8_t*>(gr + r * L.pitch);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = c0 + threadIdx.x + i * kVmThreads;
      if (k < c1) row[k] = c[i];
    }
    __syncthreads();
  }
  if (a.g8_out)
    dump_codes(reinterpret_cast<const int8_t*>(gr), L.pitch, sx2, m0, kMlpRows, a.M, c0,
               min(c1, a.F), a.F, a.g8_out, rank == 0 ? a.sx2_out : nullptr);
  cluster.sync();   // both halves' codes written
  {  // the other half's codes, from the peer's shared memory
    const uint8_t* pg = cluster.map_shared_rank(gr, peer);
    const int p0 = peer * L.fsplit, p1 = peer ? FR : L.fsplit, chunks = (p1 - p0) / 16;
    for (int i = threadIdx.x; i < kMlpRows * chunks; i += kVmThreads) {
      const int r = i / chunks, off = r * L.pitch + p0 + (i % chunks) * 16;
      *reinterpret_cast<uint4*>(gr + off) = *reinterpret_cast<const uint4*>(pg + off);
    }
  }
  __syncthreads();

  // fc2 over all of F for this block's half of D, + bias, LayerScale, residual
  const int d0 = rank * L.dsplit, d1 = rank ? a.D : min(a.D, L.dsplit);
  gemm_resident_rows<kMlpRows, MlpRing>(reinterpret_cast<const int8_t*>(gr), L.pitch, a.q2,
                                        a.F, FR, d0, d1, wstage,
                                        [&](int r, int n, int acc) {
                                          const int m = m0 + r;
                                          if (m >= a.M) return;
                                          float y = rt<T>(__fmul_rn(__fmul_rn(float(acc), sx2[r]), a.s2[n]));
                                          y = rt<T>(__fadd_rn(y, vm_f32(a.b2[n])));
                                          y = rt<T>(__fmul_rn(y, vm_f32(a.ls2[n])));
                                          const long long o = (long long)m * a.D + n;
                                          a.out[o] = vm_cast<T>(__fadd_rn(vm_f32(a.x[o]), y));
                                        });
  cluster.sync();   // the peer has finished reading this block's shared memory
}

template <typename T>
int launch_fused_ln_w8a8(const LnArgs<T>& a, cudaStream_t stream) {
  const size_t smem = ln_smem(a.K);
  auto kernel = fused_ln_w8a8_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.N + kLnCols - 1) / kLnCols, (a.M + kLnRows - 1) / kLnRows);
  kernel<<<grid, kVmThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_fused_mlp(const MlpArgs<T>& a, cudaStream_t stream) {
  const size_t smem = MlpLayout<T>(a.D, a.F).smem();
  auto kernel = fused_mlp_residual_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<2 * ((a.M + kMlpRows - 1) / kMlpRows), kVmThreads, smem, stream>>>(a);   // clusters of 2
  return int(cudaGetLastError());
}

}  // namespace ovla

// Both return the launch's cudaError_t (0 on success). All tensors contiguous
// and 16-byte aligned; K, D, F multiples of 16.
extern "C" int ovla_fused_ln_w8a8(const void* x, const void* ln_s, const void* ln_b,
                                  const void* q, const void* s, const void* b, const void* res,
                                  const void* ls, void* out, int M, int K, int N, float eps,
                                  void* codes_out, void* sx_out, int is_bf16, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    ovla::LnArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(ln_s),
                      static_cast<const T*>(ln_b), static_cast<const int8_t*>(q),
                      static_cast<const float*>(s), static_cast<const T*>(b),
                      static_cast<const T*>(res), static_cast<const T*>(ls), static_cast<T*>(out),
                      M, K, N, eps, static_cast<int8_t*>(codes_out),
                      static_cast<float*>(sx_out)};
    return ovla::launch_fused_ln_w8a8(a, st);
  }
  ovla::LnArgs<float> a{static_cast<const float*>(x), static_cast<const float*>(ln_s),
                        static_cast<const float*>(ln_b), static_cast<const int8_t*>(q),
                        static_cast<const float*>(s), static_cast<const float*>(b),
                        static_cast<const float*>(res), static_cast<const float*>(ls),
                        static_cast<float*>(out), M, K, N, eps, static_cast<int8_t*>(codes_out),
                        static_cast<float*>(sx_out)};
  return ovla::launch_fused_ln_w8a8(a, st);
}

extern "C" int ovla_fused_mlp_residual(const void* x, const void* ln_s, const void* ln_b,
                                       const void* q1, const void* s1, const void* b1,
                                       const void* q2, const void* s2, const void* b2,
                                       const void* ls2, void* out, int M, int D, int F, float eps,
                                       int act, void* h8_out, void* sx1_out, void* g8_out,
                                       void* sx2_out, int is_bf16, void* stream) {
  if (M < 1 || D < 16 || F < 32 || D % 16 != 0 || F % 16 != 0 || F > 8192 || act < 0 ||
      act > 2)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    ovla::MlpArgs<T> a{static_cast<const T*>(x),  static_cast<const T*>(ln_s),
                       static_cast<const T*>(ln_b), static_cast<const int8_t*>(q1),
                       static_cast<const float*>(s1), static_cast<const T*>(b1),
                       static_cast<const int8_t*>(q2), static_cast<const float*>(s2),
                       static_cast<const T*>(b2), static_cast<const T*>(ls2),
                       static_cast<T*>(out), M, D, F, eps, act,
                       static_cast<int8_t*>(h8_out), static_cast<float*>(sx1_out),
                       static_cast<int8_t*>(g8_out), static_cast<float*>(sx2_out)};
    return ovla::launch_fused_mlp(a, st);
  }
  ovla::MlpArgs<float> a{static_cast<const float*>(x),  static_cast<const float*>(ln_s),
                         static_cast<const float*>(ln_b), static_cast<const int8_t*>(q1),
                         static_cast<const float*>(s1), static_cast<const float*>(b1),
                         static_cast<const int8_t*>(q2), static_cast<const float*>(s2),
                         static_cast<const float*>(b2), static_cast<const float*>(ls2),
                         static_cast<float*>(out), M, D, F, eps, act,
                         static_cast<int8_t*>(h8_out), static_cast<float*>(sx1_out),
                         static_cast<int8_t*>(g8_out), static_cast<float*>(sx2_out)};
  return ovla::launch_fused_mlp(a, st);
}
