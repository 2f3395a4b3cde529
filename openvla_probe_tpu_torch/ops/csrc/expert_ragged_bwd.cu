// The backward of expert_ragged (the grouped expert product of the sparse-MoE trunk,
// expert_ragged.cu): for y[m] = x[m] · w[e(m)]ᵀ [· s[e(m)]] over rows sorted by expert
// (group_sizes[e] rows of expert e, in expert order, rows past their sum 0),
//   expert_ragged_dx: dx[m, :] = dy[m, :] · w[e(m)]  (codes: (dy[m] ⊙ s[e(m)]) · q[e(m)]) -> [M, I]
//   expert_ragged_dw: dW[e]    = Σ over expert e's rows of dy[m]ᵀ · x[m]               -> [E, O, I]
// both with fp32 sums and one rounding to the output's type; rows past the groups' sum give
// dx = 0 and take no part in dW; an expert with no rows gets dW = 0, written.
//
// Replaces XLA's transpose of lax.ragged_dot_general, by which jax.grad differentiates
// openvla_probe_tpu/models/moe.py::_expert_ragged (a Mosaic grouped matmul on the TPU). XLA
// scales the fp32 cotangent by s[e_row] before the transposed product and multiplies it by the
// codes widened to the activation type: the product of an fp32 operand. Both kernels read the
// group sizes on the device (int32): no host sync, no pre-pass.
//
// Bound on the H100 at the Mixtral-8x7B training shapes (M = 2·B·T = 5120 top-2 rows, E = 8,
// D = 4096, F = 14336, LoRA r = 32):
//   * dx of an int8 base: 2·5120·14336·4096 = 0.60 TFLOP a launch, bound by bf16 tensor-core
//     operations (0.61 ms at 989 TFLOP/s); the LoRA dx (K or N = 32) are bound by their bytes;
//   * dW of a LoRA factor (dA [8, 32, I], dB [8, O, 32]): bound by reading dy and x once
//     (5120 · (O + I) · 2 bytes, 0.05 ms at 3.35 TB/s at O = 14336).
//
// Both tensor-core routes are mma.sync m16n8k16 (bf16 in, fp32 accumulators) on 128 x 128 output
// tiles, 256 threads as 2 x 4 warps of 64 x 32, fed by a cp.async ring of 64-deep chunks (dx 4
// stages, dW 3). The contraction runs along a dim that is not contiguous in the operands the kernel
// reads as "B" (dx: the stack's O; dW: the rows of dy and x), so those tiles are MN-major and
// reach the tensor cores through ldmatrix.trans (16-bit only). Every 128 of the contraction go
// into fresh accumulators that are then added to the running fp32 sums (the promotion of
// expert_ragged.cu: a tensor-core accumulator drops the low bits of its addends).
//
// dx: a tile is 128 rows of one expert (it never spans two: it starts at its expert's row, the
// rows past its group are zero-filled and never stored) x 128 columns of I; blockIdx.y walks the
// tiles of every expert in order, then the zero tiles of the rows past the sum; blocks past the
// last tile return. bf16 weights go from the ring to ldmatrix.trans. int8 codes cannot (8-bit
// ldmatrix.trans does not exist, and wgmma's 8-bit form takes K-major operands only): each stage
// (its codes and its 64 scales, both by cp.async) is widened in shared memory, code by code, to
// v = fp32(s[e, o] · q[e, o, i]) written as three bf16 terms (hi, mid, lo: hi + mid + lo = v
// exactly), one stage ahead of the products into a second set of terms, so one barrier a stage
// serves both; the tile takes three products of dy with the terms. That keeps the function of
// the fp32 plain version (one fp32 rounding of each scaled weight, exact bf16 x bf16 products,
// fp32 sums) at three times the tensor-core work of a bf16 product; two terms (v to 16 bits)
// would leave 2^-17 of each product, by estimate enough to misround one output in a few hundred.
//   What bounds it (H100 80GB HBM3 at 700 W, 5120 x 14336 -> 4096 int8: 6.2 ms against a 0.61 ms
//   operations bound; knock-out copies of this file timed by tools/kernel_ab.py): with no products
//   it still takes 4.2 ms, with no widening 4.4, with one term 4.3. Each fragment is loaded by
//   every warp that uses it (A by four warps, each of B's three terms by two), ~160 KB of
//   ldmatrix a 64-deep stage: shared memory, not the tensor cores, is the likely bound.
//
// dW: a tile is 128 output channels x 128 input columns of one expert; its rows are the
// contraction. With few output tiles (a LoRA factor: r = 32 gives 256 tiles in all, and random
// routing may send every row to one expert) the rows are cut into chunks of `rows` (a pure
// function of the shapes, ops/expert_ragged.py::dw_split_rows) and each (expert, chunk) piece
// writes its fp32 partial tile to a workspace; a second grid adds each expert's pieces in chunk
// order and casts once. No atomics on any route: two runs give the same bits.
//
// Any other input (fp32, O or I off the 16-byte rows) takes the scalar routes,
// ovla_expert_ragged_dx_scalar and ovla_expert_ragged_dw_scalar (fp32 FMAs), which the wrappers
// count apart.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ovla_erb {

using bf16 = __nv_bfloat16;

constexpr int kMaxE = 1024;
constexpr int kBM = 128;                 // dx: rows of dy a tile; dW: output channels a tile
constexpr int kBN = 128;                 // output columns a tile
constexpr int kBK = 64;                  // contraction a stage
constexpr int kStages = 3;
constexpr int kPromote = 2;              // stages a chunk in fresh accumulators (128 deep)
constexpr int kThreads = 256;            // 8 warps: 2 (rows) x 4 (columns) of 64 x 32
constexpr int kAPitch = kBK + 8;         // dx's dy tile [128 rows][64 k]: 144-byte rows
constexpr int kBPitch = kBN + 8;         // [64 k][128 columns] bf16 tiles: 272-byte rows
constexpr int kQPitch = kBN + 16;        // [64 k][128 columns] int8 codes: 144-byte rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) where !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 codes (byte sel & 0xF and (sel >> 8) & 0xF of w) -> bf16x2, exact (expert_ragged.cu's)
template <uint32_t SEL>
__device__ __forceinline__ __nv_bfloat162 widen2(uint32_t w) {
  const uint32_t a = __byte_perm(w, 0x43434343u, SEL);   // [c0, 0x43, c1, 0x43]
  const uint32_t lo = a & 0xFF7FFF7Fu;                     // 128 + (c & 0x7F)
  const uint32_t hi = a & 0xFF80FF80u;                     // 128, or 256 where c < 0
  return __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                 *reinterpret_cast<const __nv_bfloat162*>(&hi));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the tiles of dx: each expert's rows in tiles of `bm` from its first row, then the rows past
// the groups' sum; rows clamped to M (group sizes summing past M read and write nothing beyond)

struct RowTile {
  int e;      // expert, or -1: rows past the groups' sum (zeros)
  int row0;   // first row
  int rows;   // rows of the tile (<= 0: no tile)
};

__device__ RowTile row_tile(const int* __restrict__ gs, int E, int M, int bm, int t) {
  long long start = 0;
  for (int e = 0; e < E; ++e) {
    const long long n = max(gs[e], 0);
    const long long te = (n + bm - 1) / bm;
    if (t < te) {
      const long long row0 = start + (long long)t * bm;
      const long long rows = min(min((long long)bm, n - (long long)t * bm), (long long)M - row0);
      return RowTile{e, int(min(row0, (long long)M)), int(rows)};
    }
    t -= int(te);
    start += n;
  }
  const long long row0 = min(start, (long long)M) + (long long)t * bm;
  return RowTile{-1, int(min(row0, (long long)M)), int(min((long long)bm, (long long)M - row0))};
}

constexpr int kDxStages = 4;   // dx's ring: stage kc + 1 is widened while kc is multiplied

template <bool kInt8>
struct DxSmem {
  static constexpr int kA = kBM * kAPitch * 2;                          // dy [128][64]
  static constexpr int kW = kInt8 ? kBK * kQPitch : kBK * kBPitch * 2;  // codes or bf16 [64][128]
  static constexpr int kS = kInt8 ? kBK * 4 : 0;                        // the stage's scales
  static constexpr int kStage = kA + kW + kS;
  static constexpr int kTerm = kBK * kBPitch * 2;                       // one bf16 term [64][128]
  // int8: two sets of three terms (the stage being multiplied and the next, being widened)
  static constexpr size_t kBytes = size_t(kDxStages) * kStage + (kInt8 ? 6 * kTerm : 0);
};

// widen one int8 stage (raw codes [64][128] and their 64 scales): v = fp32(s[o] · q) as three
// bf16 terms hi + mid + lo = v (exact: v has 24 significant bits), into terms[0..2]
__device__ __forceinline__ void widen_stage(const uint8_t* raw, uint8_t* terms, int tid) {
  const float* sc = reinterpret_cast<const float*>(raw + kBK * kQPitch);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = tid + kThreads * i, kr = j / 8, c = j % 8;
    const uint4 q = *reinterpret_cast<const uint4*>(raw + kr * kQPitch + c * 16);
    const float sv = sc[kr];   // 0 past O (zero-filled)
    const uint32_t words[4] = {q.x, q.y, q.z, q.w};
    uint32_t hi[8], mid[8], lo[8];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 f =
            __bfloat1622float2(h ? widen2<0x7362>(words[w]) : widen2<0x5140>(words[w]));
        const float v0 = f.x * sv, v1 = f.y * sv;
        const __nv_bfloat162 th = __floats2bfloat162_rn(v0, v1);
        const float2 fh = __bfloat1622float2(th);
        const float r0 = v0 - fh.x, r1 = v1 - fh.y;
        const __nv_bfloat162 tm = __floats2bfloat162_rn(r0, r1);
        const float2 fm = __bfloat1622float2(tm);
        hi[2 * w + h] = as_u32(th);
        mid[2 * w + h] = as_u32(tm);
        lo[2 * w + h] = as_u32(__floats2bfloat162_rn(r0 - fm.x, r1 - fm.y));
      }
    }
    const int off = (kr * kBPitch + c * 16) * 2;
    uint4* d0 = reinterpret_cast<uint4*>(terms + off);
    uint4* d1 = reinterpret_cast<uint4*>(terms + DxSmem<true>::kTerm + off);
    uint4* d2 = reinterpret_cast<uint4*>(terms + 2 * DxSmem<true>::kTerm + off);
    d0[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    d0[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    d1[0] = make_uint4(mid[0], mid[1], mid[2], mid[3]);
    d1[1] = make_uint4(mid[4], mid[5], mid[6], mid[7]);
    d2[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    d2[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 1)
    expert_ragged_dx_kernel(const bf16* __restrict__ dy, const void* __restrict__ wv,
                            const float* __restrict__ s, const int* __restrict__ gs,
                            bf16* __restrict__ dx, int M, int O, int I, int E) {
  using S = DxSmem<kInt8>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ RowTile tile_s;
  const int tid = threadIdx.x;
  if (tid == 0) tile_s = row_tile(gs, E, M, kBM, blockIdx.y);
  __syncthreads();
  const RowTile tl = tile_s;
  if (tl.rows <= 0) return;
  const int n0 = blockIdx.x * kBN;
  if (tl.e < 0) {   // rows past the groups' sum: dx = 0
    for (int j = tid; j < tl.rows * (kBN / 8); j += kThreads) {
      const int c = n0 + (j % (kBN / 8)) * 8;
      if (c < I)
        *reinterpret_cast<uint4*>(dx + (long long)(tl.row0 + j / (kBN / 8)) * I + c) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const long long wrow0 = (long long)tl.e * O;   // the expert's first weight row
  const int KT = (O + kBK - 1) / kBK;
  uint8_t* terms = smem + kDxStages * S::kStage;
  auto slot = [&](int kc) { return smem + (kc % kDxStages) * S::kStage; };
  auto load = [&](int kc) {
    if (kc >= KT) return;
    uint8_t* st = slot(kc);
    const int k0 = kc * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // dy: 128 rows x 8 chunks
      const int j = tid + kThreads * i, r = j / 8, c = j % 8;
      const bool ok = r < tl.rows && k0 + c * 8 < O;
      cp16(st + (r * kAPitch + c * 8) * 2,
           ok ? dy + (long long)(tl.row0 + r) * O + k0 + c * 8 : dy, ok);
    }
    uint8_t* ws = st + S::kA;
    if constexpr (kInt8) {
      const int8_t* q = static_cast<const int8_t*>(wv);
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // codes: 64 rows x 8 chunks of 16
        const int j = tid + kThreads * i, kr = j / 8, c = j % 8;
        const bool ok = k0 + kr < O && n0 + c * 16 < I;
        cp16(ws + kr * kQPitch + c * 16, ok ? q + (wrow0 + k0 + kr) * I + n0 + c * 16 : q, ok);
      }
      if (tid < kBK / 4) {   // the 64 scales s[e, k0 ..], 4 a chunk (O % 8 == 0)
        const bool ok = k0 + tid * 4 < O;
        cp16(ws + S::kW + tid * 16, ok ? s + wrow0 + k0 + tid * 4 : s, ok);
      }
    } else {
      const bf16* w = static_cast<const bf16*>(wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // bf16: 64 rows x 16 chunks of 8
        const int j = tid + kThreads * i, kr = j / 16, c = j % 16;
        const bool ok = k0 + kr < O && n0 + c * 8 < I;
        cp16(ws + (kr * kBPitch + c * 8) * 2, ok ? w + (wrow0 + k0 + kr) * I + n0 + c * 8 : w,
             ok);
      }
    }
  };

  const int warp = tid / 32, lane = tid % 32, wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[a][b][v] = part[a][b][v] = 0.f;

#pragma unroll
  for (int i = 0; i < kDxStages - 1; ++i) {
    load(i);
    cp_commit();
  }
  if constexpr (kInt8) {   // stage 0's terms before the loop
    cp_wait<kDxStages - 2>();
    __syncthreads();
    widen_stage(slot(0) + S::kA, terms, tid);
  }
  for (int kc = 0; kc < KT; ++kc) {
    // int8: stage kc + 1 landed (it is widened below) and stage kc's terms written; bf16:
    // stage kc landed. Every warp is done with stage kc - 1, whose slot and terms are reused.
    if constexpr (kInt8) cp_wait<kDxStages - 3>();
    else cp_wait<kDxStages - 2>();
    __syncthreads();
    load(kc + kDxStages - 1);
    cp_commit();
    const uint8_t* st = slot(kc);
    const uint8_t* bsrc = st + S::kA;
    constexpr int kTerms = kInt8 ? 3 : 1;
    if constexpr (kInt8) {
      bsrc = terms + (kc % 2) * 3 * S::kTerm;
      if (kc + 1 < KT)
        widen_stage(slot(kc + 1) + S::kA, terms + ((kc + 1) % 2) * 3 * S::kTerm, tid);
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(a[mt], st + ((wm * 64 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kAPitch +
                             kk * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        const uint8_t* bt = bsrc + t * S::kTerm;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, bt + ((kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kBPitch +
                             wn * 32 + np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma16816(part[mt][2 * np], a[mt], b[0], b[1]);
            mma16816(part[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    if (kc % kPromote == kPromote - 1 || kc == KT - 1) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc[a][b][v] += part[a][b][v];
            part[a][b][v] = 0.f;
          }
    }
  }
  cp_wait<0>();

  // accumulator (mt, nt): rows wm·64 + 16 mt + g (v < 2) and + 8 (v >= 2), columns
  // n0 + wn·32 + 8 nt + 2 t4 (+1)
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 64 + mt * 16 + g + 8 * h;
      if (r >= tl.rows) continue;
      bf16* orow = dx + (long long)(tl.row0 + r) * I;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
        if (col < I)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// dW: pieces (expert, chunk of `rows` rows) of the contraction

struct Piece {
  int e;    // expert, or -1: no piece
  int r0;   // first row
  int r1;   // one past the last row
};

// Piece j: direct (rows >= M): expert j's whole group (possibly empty); split: the j-th
// non-empty intersection, in row order, of an expert's rows with a chunk [c·rows, (c+1)·rows)
__device__ Piece piece_at(const int* __restrict__ gs, int E, int M, int rows, int j) {
  long long start = 0;
  for (int e = 0; e < E; ++e) {
    const long long n = max(gs[e], 0);
    const long long b = min(start, (long long)M), end = min(start + n, (long long)M);
    start += n;
    if (rows >= M) {
      if (e == j) return Piece{e, int(b), int(end)};
      continue;
    }
    const long long cnt = end > b ? (end - 1) / rows - b / rows + 1 : 0;
    if (j < cnt) {
      const long long c = b / rows + j;
      return Piece{e, int(max(b, c * rows)), int(min(end, (c + 1) * rows))};
    }
    j -= int(cnt);
  }
  return Piece{-1, 0, 0};
}

struct DwSmem {
  static constexpr int kTile = kBK * kBPitch * 2;   // [64 rows][128] bf16
  static constexpr int kStage = 2 * kTile;          // dy, x
  static constexpr size_t kBytes = size_t(kStages) * kStage;
};

// out: dW [E, O, I] in bf16 (direct) or the pieces' fp32 partials [pieces][O][I] (split)
template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    expert_ragged_dw_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                            const int* __restrict__ gs, void* __restrict__ out, int M, int O,
                            int I, int E, int rows) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ Piece piece_s;
  const int tid = threadIdx.x;
  if (tid == 0) piece_s = piece_at(gs, E, M, rows, blockIdx.y);
  __syncthreads();
  const Piece pc = piece_s;
  if (pc.e < 0) return;
  const int IT = (I + kBN - 1) / kBN;
  const int o0 = (blockIdx.x / IT) * kBM, i0 = (blockIdx.x % IT) * kBN;
  const int KT = (pc.r1 - pc.r0 + kBK - 1) / kBK;

  auto load = [&](int kc) {
    if (kc >= KT) return;
    uint8_t* st = smem + (kc % kStages) * DwSmem::kStage;
    const int r0 = pc.r0 + kc * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // 64 rows x 16 chunks of each
      const int j = tid + kThreads * i, kr = j / 16, c = j % 16;
      const bool row_ok = r0 + kr < pc.r1;
      const bool ok_o = row_ok && o0 + c * 8 < O, ok_i = row_ok && i0 + c * 8 < I;
      cp16(st + (kr * kBPitch + c * 8) * 2, ok_o ? dy + (long long)(r0 + kr) * O + o0 + c * 8 : dy,
           ok_o);
      cp16(st + DwSmem::kTile + (kr * kBPitch + c * 8) * 2,
           ok_i ? x + (long long)(r0 + kr) * I + i0 + c * 8 : x, ok_i);
    }
  };

  const int warp = tid / 32, lane = tid % 32, wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[a][b][v] = part[a][b][v] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    load(i);
    cp_commit();
  }
  for (int kc = 0; kc < KT; ++kc) {
    cp_wait<kStages - 2>();
    __syncthreads();
    load(kc + kStages - 1);
    cp_commit();
    const uint8_t* st = smem + (kc % kStages) * DwSmem::kStage;
    const uint8_t* xs = st + DwSmem::kTile;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A[o][k] = dy[k][o]: the [k][o] tile transposed by ldmatrix.trans; matrix j = lane / 8
      // holds channels +8 (j & 1) and rows +8 (j >> 1)
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4_t(a[mt], st + ((kk * 16 + (lane & 7) + (lane >> 4) * 8) * kBPitch + wm * 64 +
                               mt * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, xs + ((kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kBPitch + wn * 32 +
                           np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma16816(part[mt][2 * np], a[mt], b[0], b[1]);
          mma16816(part[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if (kc % kPromote == kPromote - 1 || kc == KT - 1) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc[a][b][v] += part[a][b][v];
            part[a][b][v] = 0.f;
          }
    }
  }
  cp_wait<0>();

  const long long base = (long long)(kSplit ? blockIdx.y : pc.e) * O;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + wm * 64 + mt * 16 + g + 8 * h;
      if (o >= O) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = i0 + wn * 32 + nt * 8 + 2 * t4;
        if (col >= I) continue;
        const long long at = (base + o) * I + col;
        if constexpr (kSplit)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + at) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

// The split's second grid: dW[e][o][i..i+3] = the sum over expert e's pieces, in chunk order, of
// their fp32 partials, cast once; an expert with no piece 0
__global__ void __launch_bounds__(256)
    expert_ragged_dw_reduce(const float* __restrict__ part, const int* __restrict__ gs,
                            bf16* __restrict__ dw, int M, int O, int I, int E, int rows) {
  __shared__ int first[kMaxE + 1];   // each expert's first piece
  if (threadIdx.x == 0) {
    long long start = 0;
    int p = 0;
    for (int e = 0; e < E; ++e) {
      const long long n = max(gs[e], 0);
      const long long b = min(start, (long long)M), end = min(start + n, (long long)M);
      start += n;
      first[e] = p;
      p += end > b ? int((end - 1) / rows - b / rows + 1) : 0;
    }
    first[E] = p;
  }
  __syncthreads();
  const long long per = (long long)O * I;
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (idx >= per * E) return;
  const int e = int(idx / per);
  const long long within = idx - (long long)e * per;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = first[e]; p < first[e + 1]; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(part + (long long)p * per + within);
    sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dw + idx);
  o[0] = __floats2bfloat162_rn(sum.x, sum.y);
  o[1] = __floats2bfloat162_rn(sum.z, sum.w);
}

// ---------------------------------------------------------------------------
// the scalar routes: fp32 FMAs, 16 x 16 outputs a block, one a thread

constexpr int kSTile = 16;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// dx: TX dy and output type; TW the weights' (TX, or int8 codes with scales)
template <typename TX, typename TW>
__global__ void __launch_bounds__(kSTile* kSTile)
    dx_scalar_kernel(const TX* __restrict__ dy, const TW* __restrict__ w,
                     const float* __restrict__ s, const int* __restrict__ gs, TX* __restrict__ dx,
                     int M, int O, int I, int E) {
  __shared__ float as[kSTile][kSTile + 1];
  __shared__ float wsh[kSTile][kSTile + 1];
  __shared__ RowTile tile;
  if (threadIdx.x == 0) tile = row_tile(gs, E, M, kSTile, blockIdx.x);
  __syncthreads();
  const RowTile tl = tile;
  if (tl.rows <= 0) return;
  const int tx = threadIdx.x % kSTile, ty = threadIdx.x / kSTile;
  const int n = blockIdx.y * kSTile + tx;
  if (tl.e < 0) {
    if (ty < tl.rows && n < I) dx[(long long)(tl.row0 + ty) * I + n] = from_f32<TX>(0.f);
    return;
  }
  const TW* we = w + (long long)tl.e * O * I;
  float acc = 0.f;
  for (int k0 = 0; k0 < O; k0 += kSTile) {
    const int k = k0 + tx;
    float a = 0.f;
    if (ty < tl.rows && k < O) {
      a = to_f32<TX>(dy[(long long)(tl.row0 + ty) * O + k]);
      if (s != nullptr) a *= s[(long long)tl.e * O + k];
    }
    as[ty][tx] = a;   // [row][k]
    wsh[ty][tx] = (k0 + ty < O && n < I) ? to_f32<TW>(we[(long long)(k0 + ty) * I + n]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSTile; ++kk) acc = fmaf(as[ty][kk], wsh[kk][tx], acc);
    __syncthreads();
  }
  if (ty < tl.rows && n < I) dx[(long long)(tl.row0 + ty) * I + n] = from_f32<TX>(acc);
}

// dW: output (o, i) of expert blockIdx.z, its rows summed in order
template <typename T>
__global__ void __launch_bounds__(kSTile* kSTile)
    dw_scalar_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const int* __restrict__ gs, T* __restrict__ dw, int M, int O, int I, int E) {
  __shared__ int range[2];
  const int e = blockIdx.z;
  if (threadIdx.x == 0) {
    long long start = 0;
    for (int j = 0; j < e; ++j) start += max(gs[j], 0);
    range[0] = int(min(start, (long long)M));
    range[1] = int(min(start + max(gs[e], 0), (long long)M));
  }
  __syncthreads();
  const int i = blockIdx.x * kSTile + threadIdx.x % kSTile;
  const int o = blockIdx.y * kSTile + threadIdx.x / kSTile;
  if (o >= O || i >= I) return;
  float acc = 0.f;
  for (int m = range[0]; m < range[1]; ++m)
    acc = fmaf(to_f32<T>(dy[(long long)m * O + o]), to_f32<T>(x[(long long)m * I + i]), acc);
  dw[((long long)e * O + o) * I + i] = from_f32<T>(acc);
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

template <bool kInt8>
int launch_dx(const void* dy, const void* w, const float* s, const int* gs, void* dx, int M,
              int O, int I, int E, cudaStream_t st) {
  auto kernel = expert_ragged_dx_kernel<kInt8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(DxSmem<kInt8>::kBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((I + kBN - 1) / kBN, (M + kBM - 1) / kBM + E + 1);
  kernel<<<grid, kThreads, DxSmem<kInt8>::kBytes, st>>>(
      static_cast<const bf16*>(dy), w, s, gs, static_cast<bf16*>(dx), M, O, I, E);
  return int(cudaGetLastError());
}

}  // namespace ovla_erb

// dx on the tensor cores: dy bf16 [M, O], w [E, O, I] bf16 (w_int8 = 0) or int8 codes with
// s fp32 [E, O] (w_int8 = 1), group_sizes int32 [E] on the device, dx bf16 [M, I]; all
// contiguous and 16-byte aligned, O a multiple of 8, I of 16 (codes) or 8 (bf16). Refuses
// anything else (cudaErrorInvalidValue). Returns the launch's cudaError_t.
extern "C" int ovla_expert_ragged_dx(const void* dy, const void* w, const void* s,
                                     const void* group_sizes, void* dx, int M, int O, int I,
                                     int E, int w_int8, void* stream) {
  namespace r = ovla_erb;
  if (M < 1 || O < 8 || O % 8 || I < 8 || I % (w_int8 ? 16 : 8) || E < 1 || E > r::kMaxE ||
      (long long)(M + r::kBM - 1) / r::kBM + E + 1 > 65535 || r::misaligned(dy) ||
      r::misaligned(w) || r::misaligned(dx) || (w_int8 && s == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sf = static_cast<const float*>(s);
  const auto* gi = static_cast<const int*>(group_sizes);
  return w_int8 ? r::launch_dx<true>(dy, w, sf, gi, dx, M, O, I, E, st)
                : r::launch_dx<false>(dy, w, sf, gi, dx, M, O, I, E, st);
}

// dW on the tensor cores: dy bf16 [M, O], x bf16 [M, I], group_sizes int32 [E], dw bf16
// [E, O, I]; O and I multiples of 8, all 16-byte aligned. rows >= M: one grid writes dW;
// rows < M (a multiple of 64): the pieces' fp32 partials into ws, [(ceil(M / rows) + E) · O · I]
// floats, then the reduce grid. Returns the last launch's cudaError_t.
extern "C" int ovla_expert_ragged_dw(const void* dy, const void* x, const void* group_sizes,
                                     void* ws, void* dw, int M, int O, int I, int E, int rows,
                                     void* stream) {
  namespace r = ovla_erb;
  const bool split = rows < M;
  const long long tiles = (long long)((O + r::kBM - 1) / r::kBM) * ((I + r::kBN - 1) / r::kBN);
  const long long pieces = split ? (M + rows - 1) / rows + E : E;
  if (M < 1 || O < 8 || O % 8 || I < 8 || I % 8 || E < 1 || E > r::kMaxE || rows < 1 ||
      (split && (rows % r::kBK || ws == nullptr || r::misaligned(ws))) || pieces > 65535 ||
      tiles > 2147483647LL || r::misaligned(dy) || r::misaligned(x) || r::misaligned(dw))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gi = static_cast<const int*>(group_sizes);
  auto kernel = split ? r::expert_ragged_dw_kernel<true> : r::expert_ragged_dw_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(r::DwSmem::kBytes));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(unsigned(tiles), unsigned(pieces)), r::kThreads, r::DwSmem::kBytes, st>>>(
      static_cast<const r::bf16*>(dy), static_cast<const r::bf16*>(x), gi, split ? ws : dw, M, O,
      I, E, split ? rows : M);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return int(err);
  const long long quads = (long long)E * O * I / 4;
  r::expert_ragged_dw_reduce<<<unsigned((quads + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), gi, static_cast<r::bf16*>(dw), M, O, I, E, rows);
  return int(cudaGetLastError());
}

// The scalar routes: dy fp32 (bf16 = 0) or bf16 [M, O]; w [E, O, I] of dy's type (w_int8 = 0,
// s null) or int8 codes with s fp32 [E, O]; dx of dy's type [M, I]; any M, O, I >= 1.
extern "C" int ovla_expert_ragged_dx_scalar(const void* dy, const void* w, const void* s,
                                            const void* group_sizes, void* dx, int M, int O,
                                            int I, int E, int bf16_, int w_int8, void* stream) {
  namespace r = ovla_erb;
  if (M < 1 || O < 1 || I < 1 || E < 1 || E > r::kMaxE || (I + r::kSTile - 1) / r::kSTile > 65535 ||
      (w_int8 != 0) != (s != nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + r::kSTile - 1) / r::kSTile + E + 1, (I + r::kSTile - 1) / r::kSTile);
  const auto* sf = static_cast<const float*>(s);
  const auto* gi = static_cast<const int*>(group_sizes);
  if (bf16_) {
    using T = r::bf16;
    if (w_int8)
      r::dx_scalar_kernel<T, int8_t><<<grid, r::kSTile * r::kSTile, 0, st>>>(
          static_cast<const T*>(dy), static_cast<const int8_t*>(w), sf, gi, static_cast<T*>(dx),
          M, O, I, E);
    else
      r::dx_scalar_kernel<T, T><<<grid, r::kSTile * r::kSTile, 0, st>>>(
          static_cast<const T*>(dy), static_cast<const T*>(w), sf, gi, static_cast<T*>(dx), M, O,
          I, E);
  } else {
    if (w_int8)
      r::dx_scalar_kernel<float, int8_t><<<grid, r::kSTile * r::kSTile, 0, st>>>(
          static_cast<const float*>(dy), static_cast<const int8_t*>(w), sf, gi,
          static_cast<float*>(dx), M, O, I, E);
    else
      r::dx_scalar_kernel<float, float><<<grid, r::kSTile * r::kSTile, 0, st>>>(
          static_cast<const float*>(dy), static_cast<const float*>(w), sf, gi,
          static_cast<float*>(dx), M, O, I, E);
  }
  return int(cudaGetLastError());
}

// dy [M, O] and x [M, I] fp32 (bf16 = 0) or bf16, dw [E, O, I] of their type; any M, O, I >= 1.
extern "C" int ovla_expert_ragged_dw_scalar(const void* dy, const void* x,
                                            const void* group_sizes, void* dw, int M, int O,
                                            int I, int E, int bf16_, void* stream) {
  namespace r = ovla_erb;
  if (M < 1 || O < 1 || I < 1 || E < 1 || E > 65535 || (O + r::kSTile - 1) / r::kSTile > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((I + r::kSTile - 1) / r::kSTile, (O + r::kSTile - 1) / r::kSTile, E);
  const auto* gi = static_cast<const int*>(group_sizes);
  if (bf16_)
    r::dw_scalar_kernel<r::bf16><<<grid, r::kSTile * r::kSTile, 0, st>>>(
        static_cast<const r::bf16*>(dy), static_cast<const r::bf16*>(x), gi,
        static_cast<r::bf16*>(dw), M, O, I, E);
  else
    r::dw_scalar_kernel<float><<<grid, r::kSTile * r::kSTile, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x), gi, static_cast<float*>(dw),
        M, O, I, E);
  return int(cudaGetLastError());
}
