// One-shot row-softmax attention: the scalar route of the prefill and ViT-tower
// kernels (fp32 inputs, head dims their tensor-core kernels do not take).
//
// One CTA owns (batch b, head h, a block of kBlockQ query rows) and keeps the
// WHOLE fp32 score row of each of its queries in shared memory (Tk <= 1024),
// exactly as the TPU's one-shot kernels keep the whole score tile in VMEM:
//
//   phase 1  s[r][c] = q_r . k_c in fp32 over staged K tiles, then the scale
//            and the mask (masked scores become the finite NEG_INF)
//   phase 2  per row: m = max s, p = expf(s - m), l = sum p (fp32 p); the
//            row is overwritten with p as the PV operand
//   phase 3  o[r] = sum_c p[r][c] * v_c in fp32 over staged V tiles,
//            out = o / max(l, 1e-30) cast to the input type
//
// No online rescaling up to 1024 keys: the numerics are the one-shot
// kernel's, only the order of the fp32 sums differs. Unmasked calls (the ViT
// towers) take any Tk: the three phases run once per chunk of at most 1024
// keys, and each chunk rescales the running sums by expf(m_old - m_new) with
// the running row max m (an online softmax, the same function up to fp32
// rounding); with one chunk the rescale is an exact no-op (the sums start at 0).
// Products are scalar fp32 FMAs (bf16 inputs are upcast exactly, so a bf16 x
// bf16 product is exact in fp32, as on the MXU); the ViT kernel's dot is full
// fp32 by definition, so neither kernel may use TF32 tensor cores (their
// bf16 tensor-core routes: flash_prefill.cu, vit_attention.cu). The layout
// below is what a simple kernel needs to be right on every shape it takes:
//
//   * inputs are [B, T, H, Dh] with arbitrary batch/token strides and a
//     contiguous head slab (stride Dh for heads, 1 for Dh), so the ViT's
//     q/k/v slices of one [B*N, 3D] qkv product are read in place;
//   * K/V tiles are staged with a row pitch of Dh + 4 floats, which makes the
//     phase-1 float4 column reads conflict-free for Dh = 64, 72 and 128;
//   * the head dims of the path (64, 72, 128) are compile-time constants
//     (no runtime division in the staging loops, float4 shared-memory reads
//     in the score loop); any other Dh <= 128 takes the runtime-Dh instance;
//   * Dh <= 128 (phase 3 keeps 4 x 4 fp32 accumulators per thread);
//   * the score rows take at most 1024 keys of shared memory (128 KB).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ovla {

constexpr float kNegInf = -2.3819763e38f;  // XLA's finite mask value
constexpr int kBlockQ = 32;                // query rows per CTA
constexpr int kBlockK = 64;                // keys per staged K/V tile
constexpr int kThreads = 256;
constexpr int kMaxDh = 128;
constexpr int kMaxTk = 1024;
constexpr int kPitchPad = 4;               // K/V tile row pitch = Dh + 4 floats

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;                 // contiguous [B, Tq, H, Dh]
  const int32_t* kv_valid; // [B, Tk] (1 = attend) or nullptr
  int B, H, Tq, Tk, Dh;
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;  // element strides: batch, token
  float scale;
  int offset;              // absolute position of query 0 (causal rule)
  int causal;
};

// The bf16 mma.sync pieces of vit_attention.cu: a 32-bit shared-memory load
// of two bf16 values and mma.sync m16n8k16 bf16 x bf16 -> fp32 (exact
// products, fp32 sums).
__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lane t gets rows 2(t%4), 2(t%4)+1 of column t/4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}
// two bf16 values (RNE) in one register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// ---- the causal key-tile skip of the tensor-core flash kernels (flash_prefill.cu,
// flash_blockwise.cu; tests/test_torch_kernel_arith_skip_fold.py and
// tests/test_torch_kernel_arith_oneshot.py emulate it) ----
// A 64-key tile is skipped for 64 query rows when it lies wholly above their causal diagonal,
// or past the last valid key of the batch row, or holds no valid key at all, once every one of
// those rows has seen a valid key: such a row has a finite max m and gets
// p = expf(NEG_INF - m) = 0 from every key of the tile (and, in the online softmax, a
// correction of 1), so skipping it leaves its bits as they are. A row that has seen no valid
// key has m = NEG_INF and counts every masked key at p = 1 (the mean of V over Tk), so when
// the batch row's first valid key lies past the first row's diagonal the rows visit every
// tile. The rule depends only on the mask.
constexpr int kSkipRows = 64, kSkipKeys = 64;

// Whether the 64 query rows from qw must visit key tile j. okw: the batch row's validity bits
// (bit c % 32 of word c / 32); first and last: its first and last valid key (INT_MAX and -1
// when there is none).
__device__ __forceinline__ bool visits(const AttnArgs& a, const uint32_t* okw, int first,
                                       int last, int qw, int j) {
  if (qw >= a.Tq) return false;   // rows past Tq are not written
  if (!a.causal || first > qw + a.offset) return true;   // a row sees no valid key: every tile
  const int k0 = j * kSkipKeys;
  const int q_last = min(qw + kSkipRows, a.Tq) - 1;
  if (k0 > min(q_last + a.offset, last)) return false;   // above the diagonal or past the keys
  const uint32_t w1 = 2 * j + 1 < (a.Tk + 31) / 32 ? okw[2 * j + 1] : 0u;
  return k0 <= first || (okw[2 * j] | w1) != 0u;           // a tile of invalid keys after the first
}

// Stage batch row b's validity bits into okw (a ballot per 32 keys, by every warp of a block of
// `nthreads`) and lower *first_s / raise *last_s (set to INT_MAX / -1 before, read after a
// __syncthreads) to its first and last valid key.
__device__ __forceinline__ void stage_valid_bits(const AttnArgs& a, int b, uint32_t* okw,
                                                 int* first_s, int* last_s, int nthreads) {
  const int32_t* valid = a.kv_valid ? a.kv_valid + (long long)b * a.Tk : nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int w = warp; w < (a.Tk + 31) / 32; w += nthreads / 32) {
    const int t = w * 32 + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, t < a.Tk && (!valid || valid[t] > 0));
    if (lane == 0) {
      okw[w] = bits;
      if (bits) {
        atomicMin(first_s, w * 32 + __ffs(bits) - 1);
        atomicMax(last_s, w * 32 + 31 - __clz(bits));
      }
    }
  }
}

__host__ __device__ inline int attention_chunk(int Tk) { return Tk < kMaxTk ? Tk : kMaxTk; }

__host__ __device__ inline size_t attention_smem_bytes(int Tk, int Dh) {
  return sizeof(float) * (size_t(kBlockQ) * Dh + size_t(kBlockQ) * attention_chunk(Tk) +
                          size_t(kBlockK) * (Dh + kPitchPad) + 3 * kBlockQ);
}

// Stage rows [k0, k0 + kBlockK) of one head of K or V as fp32, zero past Tk.
template <typename T>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long long st, int k0,
                                           int Tk, int Dh) {
  for (int i = threadIdx.x; i < kBlockK * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh, t = k0 + r;
    dst[r * (Dh + kPitchPad) + d] = t < Tk ? to_f32(src[t * st + d]) : 0.f;
  }
}

// kScaleQFirst: q is scaled in fp32 before the dot (ViT kernel); otherwise the
// fp32 dot is scaled (prefill kernel). kRoundP: P is rounded to the input type
// before PV (prefill kernel: bf16 P, fp32 accumulation). kDh: the head dim
// as a compile-time constant, or 0 to read it from the arguments.
template <typename T, bool kScaleQFirst, bool kRoundP, int kDh>
__global__ void __launch_bounds__(kThreads) attention_rows_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int Tk = a.Tk, Dh = kDh > 0 ? kDh : a.Dh, KP = Dh + kPitchPad;
  const int CH = attention_chunk(Tk);      // keys per chunk
  float* q_s = smem;                       // [kBlockQ][Dh]
  float* s_s = q_s + kBlockQ * Dh;         // [kBlockQ][CH]: scores, then P
  float* kv_s = s_s + kBlockQ * CH;        // [kBlockK][KP]
  float* l_s = kv_s + kBlockK * KP;        // [kBlockQ] running sums
  float* m_s = l_s + kBlockQ;              // [kBlockQ] running row maxima
  float* a_s = m_s + kBlockQ;              // [kBlockQ] this chunk's rescale

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * Dh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + h * Dh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + h * Dh;
  const int32_t* valid = a.kv_valid ? a.kv_valid + (long long)b * Tk : nullptr;

  for (int i = tid; i < kBlockQ * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh, t = q0 + r;
    float x = t < a.Tq ? to_f32(Q[t * a.q_st + d]) : 0.f;
    if (kScaleQFirst) x *= a.scale;
    q_s[i] = x;
  }
  if (tid < kBlockQ) {
    l_s[tid] = 0.f;
    m_s[tid] = kNegInf;
  }
  const int py = tid / 32, px = tid % 32;   // phase 3: rows {py + 8 i} x columns {px + 32 j}
  float o[4][4] = {};

  for (int c0 = 0; c0 < Tk; c0 += CH) {
    const int cend = min(c0 + CH, Tk);
    // phase 1: thread (ty, tx) owns rows {ty, ty + 16} x keys {tx + 16 j}
    {
      const int ty = tid / 16, tx = tid % 16;
      for (int k0 = c0; k0 < cend; k0 += kBlockK) {
        __syncthreads();  // q_s written / previous tile consumed
        stage_tile(kv_s, K, a.k_st, k0, Tk, Dh);
        __syncthreads();
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const float* qa = q_s + ty * Dh;
        const float* qb = q_s + (ty + 16) * Dh;
        if constexpr (kDh > 0 && kDh % 4 == 0) {
#pragma unroll 2
          for (int d = 0; d < kDh; d += 4) {
            const float4 xa = *reinterpret_cast<const float4*>(qa + d);
            const float4 xb = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 kk = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * KP + d);
              acc[0][j] += xa.x * kk.x;
              acc[0][j] += xa.y * kk.y;
              acc[0][j] += xa.z * kk.z;
              acc[0][j] += xa.w * kk.w;
              acc[1][j] += xb.x * kk.x;
              acc[1][j] += xb.y * kk.y;
              acc[1][j] += xb.z * kk.z;
              acc[1][j] += xb.w * kk.w;
            }
          }
        } else {
          for (int d = 0; d < Dh; ++d) {
            const float xa = qa[d], xb = qb[d];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float kk = kv_s[(tx + 16 * j) * KP + d];
              acc[0][j] += xa * kk;
              acc[1][j] += xb * kk;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = k0 + tx + 16 * j;
            if (c < cend) {
              const float s = kScaleQFirst ? acc[i][j] : acc[i][j] * a.scale;
              bool ok = valid ? valid[c] > 0 : true;
              if (a.causal) ok = ok && (c <= q0 + r + a.offset);
              s_s[r * CH + c - c0] = ok ? s : kNegInf;
            }
          }
        }
      }
    }
    __syncthreads();

    // phase 2: one warp per row; a fully masked row has m = NEG_INF and
    // p = exp(0) = 1 on every key, so its output is the mean of V. The running
    // max and sum carry over chunks (one chunk: m_s = NEG_INF, l_s = 0 before).
    {
      const int warp = tid / 32, lane = tid % 32, cn = cend - c0;
      for (int r = warp; r < kBlockQ; r += kThreads / 32) {
        float* row = s_s + r * CH;
        float m = m_s[r];
        for (int c = lane; c < cn; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, w));
        float l = 0.f;
        for (int c = lane; c < cn; c += 32) {
          const float p = expf(row[c] - m);
          l += p;
          row[c] = kRoundP ? to_f32(from_f32<T>(p)) : p;
        }
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
        if (lane == 0) {
          const float alpha = expf(m_s[r] - m);
          l_s[r] = l_s[r] * alpha + l;
          m_s[r] = m;
          a_s[r] = alpha;
        }
      }
    }
    __syncthreads();

    // phase 3: rescale the running output, then add this chunk's P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[py + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }
    for (int k0 = c0; k0 < cend; k0 += kBlockK) {
      __syncthreads();  // P rows final / previous tile consumed
      stage_tile(kv_s, V, a.v_st, k0, Tk, Dh);
      __syncthreads();
      const int kn = min(kBlockK, cend - k0);
      for (int kk = 0; kk < kn; ++kk) {
        float vv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = px + 32 * j;
          vv[j] = d < Dh ? kv_s[kk * KP + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = s_s[(py + 8 * i) * CH + k0 - c0 + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] += p * vv[j];
        }
      }
    }
    __syncthreads();  // this chunk's P and rescale consumed
  }

  T* O = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = py + 8 * i, t = q0 + r;
    if (t >= a.Tq) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    T* orow = O + ((long long)b * a.Tq + t) * a.H * Dh + h * Dh;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = px + 32 * j;
      if (d < Dh) orow[d] = from_f32<T>(o[i][j] / den);
    }
  }
}

// Launch on `stream`; returns the launch's cudaError_t (0 on success).
template <typename T, bool kScaleQFirst, bool kRoundP, int kDh = 0>
int launch_attention_rows(const AttnArgs& a, cudaStream_t stream) {
  const bool masked = a.causal || a.kv_valid != nullptr;   // masked calls: one chunk
  if (a.Dh < 1 || a.Dh > kMaxDh || a.Tk < 1 || (masked && a.Tk > kMaxTk) || a.Tq < 1 ||
      (kDh > 0 && a.Dh != kDh))
    return int(cudaErrorInvalidValue);
  auto kernel = attention_rows_kernel<T, kScaleQFirst, kRoundP, kDh>;
  const size_t smem = attention_smem_bytes(a.Tk, a.Dh);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace ovla
