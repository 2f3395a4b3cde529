// vit_attention: unmasked bidirectional attention for the ViT towers.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/attention.py::_vit_flash_kernel
// (reached through vit_flash_attention). Function kept: q is upcast to fp32 and
// multiplied by scale = fp32(1/sqrt(Dh)) BEFORE the dot; s = q . k in fp32;
// p = expf(s - m) stays fp32; pv = p . v in fp32; out = pv / max(l, 1e-30)
// rounded to the input type (RNE). No mask: every one of the N tokens is a key.
// Only the order of the fp32 sums differs from the TPU kernel.
//
// Two routes, chosen by the wrapper (ops/attention.py::vit_mma_eligible) and
// counted apart; neither falls back to the other:
//
// * ovla_vit_attention: bf16, Dh a multiple of 8 up to 128, 16-byte aligned
//   rows (the towers: DINOv2 [B, 261, 16, 64], SigLIP [B, 256, 16, 72], read in
//   place as strided views of one qkv product). A flash kernel on the tensor
//   cores. A block of 4 warps owns 64 query rows of one (b, h), 16 rows a
//   warp; Q's fragments stay in registers; K and V tiles of 64 keys stream
//   through shared memory in a two-stage cp.async ring (row pitch Dh + 8:
//   conflict-free fragment loads); S = Q Kᵀ on mma.sync m16n8k16
//   bf16 x bf16 -> fp32; the row max, the row sum and the output stay in
//   registers with an online rescale by expf(m_old - m_new): no score goes to
//   shared or device memory. The last key tile masks keys >= N to the finite
//   NEG_INF, as the TPU kernel masks col < N. The numerics:
//     - q * scale: where 1/sqrt(Dh) is a power of two (Dh = 16, 64) fp32(q) *
//       scale is exact and scaling commutes with every fp32 rounding, so one
//       bf16 pass of q . k times scale afterwards gives exactly the products
//       and sums of (q * scale) . k. Elsewhere (Dh = 72) the scaled q is an
//       fp32 value that bf16 cannot hold: it is split into three bf16 terms
//       hi + mid + lo (each the RNE of what the previous ones leave; three
//       8-bit significands cover fp32's 24, so the split is exact apart from
//       underflow of the low terms near 1e-38) and Q Kᵀ runs three passes into
//       one fp32 accumulator. Never TF32.
//     - the QK depth is Dh rounded up to 16 (Dh = 72: 80), with zeros in the
//       padded columns of Q and of every K tile; PV has Dh / 8 n-tiles of 8.
//     - p is not rounded to bf16: it is split into hi = bf16(p) and
//       lo = bf16(p - hi) (two terms, p carried to about 2^-16 of its value)
//       and both go through mma.sync against the same V fragment
//       (ldmatrix.trans).
//   Bound at the tower shapes (B = 24, bf16): q/k/v/out 51 / 57 MB against
//   6.7 / 7.2 GFLOP of the function at 989 TFLOP/s: bound by bytes
//   (15 / 17 us at 3.35 TB/s). The kernel issues 1.5x (Dh = 64) and about
//   2.8x (Dh = 72) the function's products for the exact splits.
//
// * ovla_vit_attention_scalar: every other call (fp32 inputs, other head
//   dims, unaligned rows): the scalar fp32-FMA kernel of attention_common.cuh
//   (q scaled before the dot; keys past 1024 in chunks with an online
//   rescale), the same function.
#include <utility>

#include "attention_common.cuh"
#include "int8_mma.cuh"   // the cp.async ring pieces

namespace ovla {

using ovla_i8::cp_async16;
using ovla_i8::cp_async_commit;
using ovla_i8::cp_async_wait;

constexpr int kVitThreads = 128;   // 4 warps x 16 query rows
constexpr int kVitRows = 64;       // query rows per block
constexpr int kVitKeys = 64;       // keys per K / V tile

template <int DH>
struct VitLayout {
  static constexpr int DP = (DH + 15) / 16 * 16;          // QK depth, padded to 16
  static constexpr int P = DP + 8;                         // bf16 row pitch: bank skew
  static constexpr int TILE = kVitKeys * P;                // one K or V tile
  static constexpr bool kExactScale = DH == 16 || DH == 64;   // 1/sqrt(Dh) a power of two
  static constexpr int NQ = kExactScale ? 1 : 3;           // bf16 terms of the scaled q
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) * (size_t(kVitRows) * P + 4 * TILE);
};

// lanes 0-15 address two 8x8 bf16 matrices, transposed (keys 0-7, then 8-15)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(ovla_i8::smem_u32(p)));
}

// cp.async rows [t0, t0 + rows) of one head ([.., DH] at token stride st) into
// a tile of pitch P; rows at or past N are zero-filled
template <int DH, int P>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int t0, int rows, int N) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < rows * CH; i += kVitThreads) {
    const int r = i / CH, c = i % CH, t = t0 + r;
    const bool ok = t < N;
    cp_async16(dst + r * P + c * 8, ok ? src + t * st + c * 8 : src, ok ? 16 : 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(kVitThreads) vit_attention_mma_kernel(AttnArgs a) {
  using L = VitLayout<DH>;
  constexpr int P = L::P, KT = L::DP / 16, NO = DH / 8, NQ = L::NQ;
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][P]
  __nv_bfloat16* ring = q_s + kVitRows * P;                          // [2][K | V][64][P]

  const int N = a.Tk;
  const int q0 = blockIdx.x * kVitRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * DH;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * DH;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * DH;
  const int n_tiles = (N + kVitKeys - 1) / kVitKeys;

  if constexpr (L::DP > DH) {   // zero the padded QK depth of Q and of both K stages
    const __nv_bfloat16 z = __float2bfloat16(0.f);
    for (int i = tid; i < kVitRows * (L::DP - DH); i += kVitThreads) {
      const int r = i / (L::DP - DH), c = DH + i % (L::DP - DH);
      q_s[r * P + c] = z;
      ring[r * P + c] = z;
      ring[2 * L::TILE + r * P + c] = z;
    }
  }
  load_rows<DH, P>(q_s, Q, a.q_st, q0, kVitRows, N);
  load_rows<DH, P>(ring, K, a.k_st, 0, kVitKeys, N);
  load_rows<DH, P>(ring + L::TILE, V, a.v_st, 0, kVitKeys, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, for every tile: q itself where
  // the scale is a power of two, else the three bf16 terms of fp32(q) * scale
  uint32_t qf[NQ][KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16* qa = q_s + (r0 + g + 8 * (i & 1)) * P + kk * 16 + 2 * t4 + 8 * (i >> 1);
      if constexpr (NQ == 1) {
        qf[0][kk][i] = lds32(qa);
      } else {
        const __nv_bfloat162 qv = *reinterpret_cast<const __nv_bfloat162*>(qa);
        float x0 = __low2float(qv) * a.scale, x1 = __high2float(qv) * a.scale;
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          qf[t][kk][i] = pack_bf16(x0, x1);
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&qf[t][kk][i]);
          x0 -= __low2float(hv), x1 -= __high2float(hv);   // exact: what the term leaves
        }
      }
    }
  }

  float o[NO][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g and g + 8 of the warp

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kVitKeys;
    if (j + 1 < n_tiles) {
      __nv_bfloat16* nxt = ring + ((j + 1) & 1) * 2 * L::TILE;
      load_rows<DH, P>(nxt, K, a.k_st, k0 + kVitKeys, kVitKeys, N);
      load_rows<DH, P>(nxt + L::TILE, V, a.v_st, k0 + kVitKeys, kVitKeys, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = ring + (j & 1) * 2 * L::TILE;
    const __nv_bfloat16* vs = ks + L::TILE;

    // S = Q Kᵀ for this warp's 16 rows x 64 keys (8 n8 tiles), NQ passes
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kb = ks + (nt * 8 + g) * P + kk * 16 + 2 * t4;
        const uint32_t b0 = lds32(kb), b1 = lds32(kb + 8);
#pragma unroll
        for (int t = 0; t < NQ; ++t)
          mma_bf16(s[nt], qf[t][kk][0], qf[t][kk][1], qf[t][kk][2], qf[t][kk][3], b0, b1);
      }
    }
    float mx[2] = {kNegInf, kNegInf};
    const bool ragged = k0 + kVitKeys > N;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = L::kExactScale ? s[nt][e] * a.scale : s[nt][e];
        if (ragged && k0 + nt * 8 + 2 * t4 + (e & 1) >= N) x = kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      corr[hr] = expf(m[hr] - m_new);   // 0 on the first tile (m = NEG_INF)
      m[hr] = m_new;
      l[hr] *= corr[hr];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);   // 0 for a masked key
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      o[nt][0] *= corr[0], o[nt][1] *= corr[0];
      o[nt][2] *= corr[1], o[nt][3] *= corr[1];
    }
    // O += P V with p = hi + lo. The accumulator layout of S tiles 2kk and
    // 2kk + 1 is the A-fragment layout of keys 16kk..16kk+15.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* pa = s[2 * kk];
      const float* pb = s[2 * kk + 1];
      uint32_t hi[4] = {pack_bf16(pa[0], pa[1]), pack_bf16(pa[2], pa[3]),
                        pack_bf16(pb[0], pb[1]), pack_bf16(pb[2], pb[3])};
      uint32_t lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* src = i < 2 ? pa : pb;
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi[i]);
        const int e = (i & 1) * 2;
        lo[i] = pack_bf16(src[e] - __low2float(hv), src[e + 1] - __high2float(hv));
      }
      // lanes 8i..8i+7 address matrix i: keys +(i & 1) * 8, columns +(i >> 1) * 8
      const int mi = lane >> 3, rr = lane & 7;
      const __nv_bfloat16* vrow = vs + (kk * 16 + (mi & 1) * 8 + rr) * P + (mi >> 1) * 8;
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + np * 16);
        mma_bf16(o[2 * np], hi[0], hi[1], hi[2], hi[3], bv[0], bv[1]);
        mma_bf16(o[2 * np], lo[0], lo[1], lo[2], lo[3], bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], hi[0], hi[1], hi[2], hi[3], bv[2], bv[3]);
        mma_bf16(o[2 * np + 1], lo[0], lo[1], lo[2], lo[3], bv[2], bv[3]);
      }
      if constexpr (NO % 2) {   // the last 8 columns (Dh = 72: 64..71)
        uint32_t bv[2];
        ldmatrix_x2_trans(bv, vs + (kk * 16 + (mi & 1) * 8 + rr) * P + (NO - 1) * 8);
        mma_bf16(o[NO - 1], hi[0], hi[1], hi[2], hi[3], bv[0], bv[1]);
        mma_bf16(o[NO - 1], lo[0], lo[1], lo[2], lo[3], bv[0], bv[1]);
      }
    }
    __syncthreads();   // this stage is refilled by the next iteration's copy
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + r0 + g + 8 * hr;
    if (row >= N) continue;
    const float den = fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow = O + ((long long)b * N + row) * a.H * DH + h * DH;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[nt][hr * 2] / den, o[nt][hr * 2 + 1] / den);
    }
  }
}

template <int DH>
int launch_vit_mma(const AttnArgs& a, cudaStream_t stream) {
  auto kernel = vit_attention_mma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(VitLayout<DH>::kSmem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Tk + kVitRows - 1) / kVitRows, a.H, a.B);
  kernel<<<grid, kVitThreads, VitLayout<DH>::kSmem, stream>>>(a);
  return int(cudaGetLastError());
}

// The tensor-core route's rule (ops/attention.py::vit_mma_eligible states it
// too): Dh a multiple of 8 up to 128, 16-byte aligned rows.
inline bool vit_mma_eligible(const AttnArgs& a) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool strides = (a.q_sb | a.q_st | a.k_sb | a.k_st | a.v_sb | a.v_st) % 8 == 0;
  return a.Dh >= 8 && a.Dh <= kMaxDh && a.Dh % 8 == 0 && aligned(a.q) && aligned(a.k) &&
         aligned(a.v) && aligned(a.o) && strides && a.Tk >= 1 && a.B >= 1 && a.H >= 1;
}

template <int... DHS>
int launch_vit_mma_dh(const AttnArgs& a, cudaStream_t s, std::integer_sequence<int, DHS...>) {
  int err = int(cudaErrorInvalidValue);
  ((a.Dh == 8 * (DHS + 1) ? (err = launch_vit_mma<8 * (DHS + 1)>(a, s), true) : false) || ...);
  return err;
}

// The scalar route: fp32 towers' head dims (DINOv2 64, SigLIP 72) get
// compile-time instances; bf16 reaches it only off the tensor-core rule.
template <typename T>
int launch_vit_scalar(const AttnArgs& a, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (a.Dh == 64) return launch_attention_rows<T, true, false, 64>(a, s);
    if (a.Dh == 72) return launch_attention_rows<T, true, false, 72>(a, s);
  }
  return launch_attention_rows<T, true, false>(a, s);
}

}  // namespace ovla

// bf16 only; cudaErrorInvalidValue for a call outside the tensor-core rule.
// Returns the launch's cudaError_t (0 on success).
extern "C" int ovla_vit_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int N, int Dh, long long q_sb, long long q_st,
                                  long long k_sb, long long k_st, long long v_sb,
                                  long long v_st, float scale, void* stream) {
  ovla::AttnArgs a{q, k, v, o, nullptr, B, H, N, N, Dh, q_sb, q_st,
                   k_sb, k_st, v_sb, v_st, scale, 0, 0};
  if (!ovla::vit_mma_eligible(a)) return int(cudaErrorInvalidValue);
  return ovla::launch_vit_mma_dh(a, static_cast<cudaStream_t>(stream),
                                 std::make_integer_sequence<int, ovla::kMaxDh / 8>{});
}

extern "C" int ovla_vit_attention_scalar(const void* q, const void* k, const void* v, void* o,
                                         int B, int H, int N, int Dh, long long q_sb,
                                         long long q_st, long long k_sb, long long k_st,
                                         long long v_sb, long long v_st, float scale,
                                         int is_bf16, void* stream) {
  ovla::AttnArgs a{q, k, v, o, nullptr, B, H, N, N, Dh, q_sb, q_st,
                   k_sb, k_st, v_sb, v_st, scale, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ovla::launch_vit_scalar<__nv_bfloat16>(a, s)
                 : ovla::launch_vit_scalar<float>(a, s);
}
