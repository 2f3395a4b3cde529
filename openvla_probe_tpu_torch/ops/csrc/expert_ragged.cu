// expert_ragged: the grouped expert product of the sparse-MoE trunk,
//   out[m, :] = cast((x[m, :] · w[e(m)]ᵀ in fp32) [· s[e(m), :]])
// for rows x [M, I] sorted by expert (rows of expert e contiguous, group_sizes[e] of them, in
// expert order) against an expert stack w [E, O, I] (bf16, or int8 codes with fp32
// per-(expert, output-channel) scales s [E, O]). Rows past the sum of the group sizes come out
// 0, as ragged_dot's.
//
// Replaces openvla_probe_tpu/models/moe.py::_expert_ragged, which is
// lax.ragged_dot_general (XLA; a Mosaic grouped matmul on the TPU) over the expert-sorted rows
// of moe_ffn_sorted: three launches a MoE layer (gate, up, down). Function kept: bf16 products
// are exact in fp32 and the sums are fp32 (only their order differs); int8 codes widen to bf16
// exactly (|q| <= 127), the scale multiplies the fp32 sum, and one cast to x's type ends it.
//
// The group sizes stay on the device: every CTA reads group_sizes itself and finds its tile from
// their running sum, so the host never waits on the card for them (one read a product would be
// 96 host syncs a forward at 32 layers). The grid covers ceil(M / BM) + E + 1 row tiles: each
// expert's rows split into ceil(n_e / BM) tiles starting at its first row (no tile spans two
// experts), then the tiles of the rows past the groups' sum, which write zeros; a CTA left
// without a tile returns. Row tiles run along grid x, so the CTAs that run together share a
// column tile of one expert's weights, which then comes from L2.
//
// Bound on the H100 at the Mixtral-8x7B shapes (E = 8, top-2, D = 4096, F = 14336):
//   * prefill, M = 2·B·T rows (4608 at B = 8, T = 288): 0.54 TFLOP a launch against 0.47 GB
//     (int8) or 0.94 GB (bf16) of weights, so bound by bf16 tensor-core operations (0.55 ms at
//     989 TFLOP/s);
//   * decode, M = 2·B (16 rows over 8 experts): bound by the weight stream, every expert's
//     [O, I] read once (0.47 GB int8, 0.14 ms at 3.35 TB/s).
// A simple kernel first (PERF.md §6 has its times): mma.sync m16n8k16 (bf16 x bf16 -> fp32)
// with a 3-stage cp.async ring of 32-deep k chunks, 64 x 128 output tiles of 8 warps (32 x 32
// each), ldmatrix fragments for x and bf16 weights, int8 codes widened in registers. wgmma,
// TMA and a persistent grid are later work.
//
// The sums: each 32-deep chunk goes into fresh mma accumulators, then into the running fp32
// sums by ordinary adds. An mma.sync aligns its products to its largest addend, the running
// sum included, and drops their low bits: with one running accumulator over K = 4096 the
// kernel left 5-14x as many outputs off the correctly rounded value as the fp32 plain
// version, some two bf16 steps from it (an fp64 reference on the H100, PERF.md §6); with
// the chunks promoted it is on a par with the plain version.
//
// Any other input (fp32 x, I or O not a multiple of 8) takes the scalar route,
// ovla_expert_ragged_scalar (fp32 FMAs over 16 x 16 tiles, the same tile map), which the
// wrapper counts as expert_ragged_scalar.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovla_er {

constexpr int kMaxE = 1024;     // experts a launch takes
constexpr int kBM = 64;         // rows of x a tile
constexpr int kBN = 128;        // output channels a tile
constexpr int kBK = 32;         // k a stage
constexpr int kStages = 3;
constexpr int kThreads = 256;   // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int kXPitch = kBK + 8;          // bf16 elements: 80-byte rows, conflict-free ldmatrix
constexpr int kWPitchB = kBK + 8;         // bf16 weights, the same
constexpr int kWPitchQ = kBK + 16;        // int8 codes: 48-byte rows
constexpr int kXStage = kBM * kXPitch;    // bf16 elements
constexpr int kWStageBytes = kBN * kWPitchB * 2;   // >= kBN * kWPitchQ

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16- and 8-byte copies into shared memory; src_bytes = 0 zero-fills (a ragged edge)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
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
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two int8 codes (bytes 0 and 1 of w) -> bf16x2, the first code in the low half; exact for
// every code (wi8_matmul.cu's widening: 128 + (c & 0x7F) minus 128 or 256)
__device__ __forceinline__ uint32_t widen2(uint32_t w) {
  const uint32_t a = __byte_perm(w, 0x43434343u, 0x5140);
  const uint32_t lo = a & 0xFF7FFF7Fu, hi = a & 0xFF80FF80u;
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                             *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t lds_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

struct Tile {
  int e;      // expert, or -1 for a tile of rows past the groups' sum (zeros)
  int row0;   // first row
  int rows;   // rows of the tile (<= 0: no tile)
};

// Tile `t` of the map (thread 0 of a CTA computes it; E reads of group_sizes). Rows are clamped
// to M, so group sizes that sum past M never send a read or a write out of bounds.
__device__ Tile find_tile(const int* __restrict__ gs, int E, int M, int bm, int t) {
  int start = 0;
  for (int e = 0; e < E; ++e) {
    const int n = max(gs[e], 0);
    const int te = (n + bm - 1) / bm;
    if (t < te) {
      const int row0 = start + t * bm;
      return Tile{e, row0, min(min(bm, n - t * bm), M - row0)};
    }
    t -= te;
    start += n;
  }
  const int row0 = min(start, M) + t * bm;
  return Tile{-1, row0, min(bm, M - row0)};
}

template <typename T>
__device__ __forceinline__ void zero_tile(T* out, const Tile& tl, int n0, int bn, int O) {
  for (int i = threadIdx.x; i < tl.rows * bn; i += blockDim.x) {
    const int r = i / bn, n = n0 + i % bn;
    if (n < O) out[(long long)(tl.row0 + r) * O + n] = T(0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 x, bf16 or int8 weights: mma.sync

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
    expert_ragged_mma(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w,
                      const float* __restrict__ s, const int* __restrict__ gs,
                      __nv_bfloat16* __restrict__ out, int M, int O, int I, int E) {
  __shared__ __align__(16) __nv_bfloat16 xs[kStages][kXStage];
  __shared__ __align__(16) uint8_t ws[kStages][kWStageBytes];
  __shared__ Tile tile;
  const int tid = threadIdx.x;
  if (tid == 0) tile = find_tile(gs, E, M, kBM, blockIdx.x);
  __syncthreads();
  const Tile tl = tile;
  if (tl.rows <= 0) return;
  const int n0 = blockIdx.y * kBN;
  if (tl.e < 0) {
    zero_tile(out, tl, n0, kBN, O);
    return;
  }

  const long long w_off = (long long)tl.e * O * I;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w) + w_off;
  const uint8_t* wq = static_cast<const uint8_t*>(w) + w_off;
  const __nv_bfloat16* xr = x + (long long)tl.row0 * I;
  const int KT = (I + kBK - 1) / kBK;

  // one stage: x [64 rows][32 k] (a 16-byte chunk a thread), weights [128 n][32 k] (two
  // 16-byte chunks of bf16 or two 8-byte chunks of codes a thread); rows past the tile, n past
  // O and k past I zero-filled
  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * kBK;
    {
      const int r = tid >> 2, c = tid & 3, k = k0 + c * 8;
      const bool ok = r < tl.rows && k < I;
      cp_async16(&xs[slot][r * kXPitch + c * 8], ok ? xr + (long long)r * I + k : x,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 64 * i, c = tid & 3, k = k0 + c * 8, n = n0 + r;
      const bool ok = n < O && k < I;
      if (kInt8) {
        cp_async8(&ws[slot][r * kWPitchQ + c * 8], ok ? wq + (long long)n * I + k : wq,
                  ok ? 8 : 0);
      } else {
        cp_async16(&ws[slot][(r * kWPitchB + c * 8) * 2], ok ? wb + (long long)n * I + k : wb,
                   ok ? 16 : 0);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // rows wm * 32 .. + 31, columns wn * 32 .. + 31
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();   // stage kt has landed (this thread's copies)
    __syncthreads();                // everyone's; and the slot refilled below is consumed
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk);
    cp_async_commit();
    const int slot = kt % kStages;
    const __nv_bfloat16* xsl = xs[slot];
    const uint8_t* wsl = ws[slot];
    // this chunk's sums in fresh accumulators, then added to the running sums in fp32 FADDs:
    // an mma's accumulator aligns its products to the largest term, so a running sum of
    // thousands of products would truncate each new chunk's low bits
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[mt][nt][v] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // matrices: rows 0-7 / 8-15 x k 0-7 / 8-15 -> a0, a1, a2, a3
        const int r = wm * 32 + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(a[mt], xsl + r * kXPitch + kk + 8 * (lane >> 4));
      }
      uint32_t b[4][2];
      if (kInt8) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint8_t* p = wsl + (wn * 32 + nt * 8 + g) * kWPitchQ + kk + 2 * t4;
          b[nt][0] = widen2(lds_u16(p));
          b[nt][1] = widen2(lds_u16(p + 8));
        }
      } else {
        const __nv_bfloat16* wsb = reinterpret_cast<const __nv_bfloat16*>(wsl);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          // matrices: n 0-7 / 8-15 of the pair x k 0-7 / 8-15 -> b0, b1 of nt 2p, 2p + 1
          const int j = lane >> 3;
          const int n = wn * 32 + p * 16 + (lane & 7) + 8 * (j >> 1);
          uint32_t r[4];
          ldmatrix_x4(r, wsb + n * kWPitchB + kk + 8 * (j & 1));
          b[2 * p][0] = r[0], b[2 * p][1] = r[1], b[2 * p + 1][0] = r[2], b[2 * p + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(part[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] += part[mt][nt][v];
  }
  cp_async_wait<0>();

  const float* se = kInt8 ? s + (long long)tl.e * O : nullptr;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn * 32 + nt * 8 + 2 * t4;   // O % 8 == 0: n and n + 1 are both in or out
    if (n >= O) continue;
    float s0 = 1.f, s1 = 1.f;
    if (kInt8) s0 = se[n], s1 = se[n + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + g + 8 * h;
        if (r >= tl.rows) continue;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (kInt8) v0 *= s0, v1 *= s1;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)(tl.row0 + r) * O + n) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

// ---------------------------------------------------------------------------
// any other input: scalar fp32 FMAs, 16 x 16 outputs a block, one a thread, k staged by 16

constexpr int kSTile = 16;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// TX: x and output type; TW: weight type (TX, or int8 codes with scales)
template <typename TX, typename TW>
__global__ void __launch_bounds__(kSTile* kSTile)
    expert_ragged_scalar_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                                const float* __restrict__ s, const int* __restrict__ gs,
                                TX* __restrict__ out, int M, int O, int I, int E) {
  __shared__ float xs[kSTile][kSTile + 1];
  __shared__ float wsh[kSTile][kSTile + 1];
  __shared__ Tile tile;
  if (threadIdx.x == 0) tile = find_tile(gs, E, M, kSTile, blockIdx.x);
  __syncthreads();
  const Tile tl = tile;
  if (tl.rows <= 0) return;
  const int n0 = blockIdx.y * kSTile;
  if (tl.e < 0) {
    for (int i = threadIdx.x; i < tl.rows * kSTile; i += blockDim.x) {
      const int r = i / kSTile, n = n0 + i % kSTile;
      if (n < O) out[(long long)(tl.row0 + r) * O + n] = from_f32<TX>(0.f);
    }
    return;
  }
  const int tx = threadIdx.x % kSTile, ty = threadIdx.x / kSTile;
  const TW* we = w + (long long)tl.e * O * I;
  float acc = 0.f;
  for (int k0 = 0; k0 < I; k0 += kSTile) {
    const int k = k0 + tx;
    xs[ty][tx] = (ty < tl.rows && k < I) ? to_f32<TX>(x[(long long)(tl.row0 + ty) * I + k]) : 0.f;
    wsh[ty][tx] = (n0 + ty < O && k < I) ? to_f32<TW>(we[(long long)(n0 + ty) * I + k]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSTile; ++kk) acc = fmaf(xs[ty][kk], wsh[tx][kk], acc);
    __syncthreads();
  }
  const int n = n0 + tx;
  if (ty < tl.rows && n < O) {
    if (s != nullptr) acc *= s[(long long)tl.e * O + n];
    out[(long long)(tl.row0 + ty) * O + n] = from_f32<TX>(acc);
  }
}

template <typename TX, typename TW>
int launch_scalar(const void* x, const void* w, const void* s, const void* gs, void* out, int M,
                  int O, int I, int E, cudaStream_t st) {
  const dim3 grid((M + kSTile - 1) / kSTile + E + 1, (O + kSTile - 1) / kSTile);
  expert_ragged_scalar_kernel<TX, TW><<<grid, kSTile * kSTile, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<const float*>(s),
      static_cast<const int*>(gs), static_cast<TX*>(out), M, O, I, E);
  return int(cudaGetLastError());
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace ovla_er

// The tensor-core route: x bf16 [M, I], w [E, O, I] bf16 (w_int8 = 0) or int8 codes with
// s fp32 [E, O] (w_int8 = 1), group_sizes int32 [E] on the device, out bf16 [M, O]; all
// contiguous and 16-byte aligned, I and O multiples of 8. Refuses anything else
// (cudaErrorInvalidValue). Returns the launch's cudaError_t.
extern "C" int ovla_expert_ragged(const void* x, const void* w, const void* s,
                                  const void* group_sizes, void* out, int M, int O, int I, int E,
                                  int w_int8, void* stream) {
  namespace r = ovla_er;
  const long long tiles = (M + r::kBM - 1) / r::kBM + (long long)E + 1;
  if (M < 1 || O < 8 || I < 8 || O % 8 || I % 8 || E < 1 || E > r::kMaxE ||
      tiles > 2147483647LL || (O + r::kBN - 1) / r::kBN > 65535 || r::misaligned(x) ||
      r::misaligned(w) || r::misaligned(out) || (w_int8 && s == nullptr))
    return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(tiles), (O + r::kBN - 1) / r::kBN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* sf = static_cast<const float*>(s);
  const auto* gi = static_cast<const int*>(group_sizes);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (w_int8)
    r::expert_ragged_mma<true><<<grid, r::kThreads, 0, st>>>(xb, w, sf, gi, ob, M, O, I, E);
  else
    r::expert_ragged_mma<false><<<grid, r::kThreads, 0, st>>>(xb, w, sf, gi, ob, M, O, I, E);
  return int(cudaGetLastError());
}

// The scalar route: x fp32 (x_bf16 = 0) or bf16 [M, I]; w [E, O, I] of x's type (w_int8 = 0,
// s null) or int8 codes with s fp32 [E, O]; out of x's type [M, O]; any M, O, I >= 1.
extern "C" int ovla_expert_ragged_scalar(const void* x, const void* w, const void* s,
                                         const void* group_sizes, void* out, int M, int O, int I,
                                         int E, int x_bf16, int w_int8, void* stream) {
  namespace r = ovla_er;
  if (M < 1 || O < 1 || I < 1 || E < 1 || E > r::kMaxE || (O + r::kSTile - 1) / r::kSTile > 65535 ||
      (w_int8 != 0) != (s != nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return w_int8 ? r::launch_scalar<__nv_bfloat16, int8_t>(x, w, s, group_sizes, out, M, O, I, E, st)
                  : r::launch_scalar<__nv_bfloat16, __nv_bfloat16>(x, w, s, group_sizes, out, M,
                                                                   O, I, E, st);
  return w_int8 ? r::launch_scalar<float, int8_t>(x, w, s, group_sizes, out, M, O, I, E, st)
                : r::launch_scalar<float, float>(x, w, s, group_sizes, out, M, O, I, E, st);
}
