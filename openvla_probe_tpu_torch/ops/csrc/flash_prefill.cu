// flash_prefill: causal + key-validity masked one-shot attention for the
// Llama prefill.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/attention.py::_flash_flat_kernel
// (reached through _flash_oneshot / flash_attention for Tk <= 1024). Semantics
// kept exactly: s = (q . k in fp32) * scale, scale = 1/sqrt(Dh) applied after
// the dot; ok = kv_valid[b, c] > 0 && (!causal || c <= q + offset); masked
// scores = NEG_INF (finite); p = expf(s - m); l = sum p; P cast to the input
// type (bf16) for PV with fp32 accumulation; out = pv / max(l, 1e-30).
//
// Bound on the H100 at the OpenVLA-7B prefill shape (B=24, q [24, 288, 32, 128],
// k/v [24, 295, 32, 128] bf16): ~229 MB of q/k/v/out per layer (68 us at
// 3.35 TB/s) against 33 GFLOP of bf16 products (34 us at 989 TFLOP/s), so it
// is bytes-bound.
//
// Design. The TPU program held one head-group's whole [Tq, Tkp] fp32 score
// tile in VMEM (442 KB per head at T = 288), more than a block's 227 KB of
// shared memory. A block here owns 32 query rows of one (b, h) and holds
// their whole fp32 score rows (Tk <= 1024), so the one-shot numerics stay
// exact with no online rescaling: max, exp/sum, then PV as three passes.
//   * bf16 with Dh = 64 or 128 and 16-byte aligned rows (the main path):
//     QKᵀ and PV run on the tensor cores with mma.sync m16n8k16 bf16 ->
//     fp32, the same bf16-product / fp32-accumulate arithmetic as the MXU;
//     4 warps split each 32x64 score tile and the 32xDh output; K and V
//     (transposed) are staged per 64-key tile in shared memory with padded
//     pitches that make every fragment load bank-conflict-free; P overwrites
//     its own fp32 score row as bf16.
//   * every other case (fp32 inputs, other head dims): the scalar fp32-FMA
//     kernel of attention_common.cuh, same function.
// K/V are read once per 32-row block (Tq/32 = 9 times per head at T = 288,
// mostly from L2); wgmma/TMA staging and keeping K/V resident across the row
// blocks of a head are later work.
#include "attention_common.cuh"

namespace ovla {

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kTileK = 64;        // keys per staged K / V tile

template <int DH>
struct MmaLayout {
  static constexpr int QP = DH + 8;       // q / k tile pitch (bf16): 4-word bank skew
  static constexpr int VP = kTileK + 8;   // transposed-v tile pitch (bf16)
  static constexpr int KV_ELEMS = (kTileK * QP > DH * VP) ? kTileK * QP : DH * VP;
  __host__ __device__ static int score_pitch(int Tk) {  // fp32 words, 4-word bank skew
    return (Tk + kTileK - 1) / kTileK * kTileK + 4;
  }
  __host__ __device__ static size_t smem_bytes(int Tk) {
    return sizeof(__nv_bfloat16) * (kBlockQ * QP + KV_ELEMS) +
           sizeof(float) * (size_t(kBlockQ) * score_pitch(Tk) + kBlockQ);
  }
};

template <int DH>
__global__ void __launch_bounds__(kMmaThreads) flash_prefill_mma_kernel(AttnArgs a) {
  using L = MmaLayout<DH>;
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [32][QP]
  __nv_bfloat16* kv_s = q_s + kBlockQ * L::QP;   // K [64][QP] or Vᵀ [DH][VP]
  float* s_s = reinterpret_cast<float*>(kv_s + L::KV_ELEMS);          // [32][SP]
  const int Tk = a.Tk, SP = L::score_pitch(Tk);
  float* l_s = s_s + kBlockQ * SP;

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;   // 16-row block, column half
  const int r0 = wm * 16;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * DH;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * DH;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * DH;
  const int32_t* valid = a.kv_valid ? a.kv_valid + (long long)b * Tk : nullptr;
  constexpr int CH = DH / 8;   // 16-byte chunks per row
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < kBlockQ * CH; i += kMmaThreads) {
    const int r = i / CH, c = i % CH, t = q0 + r;
    *reinterpret_cast<uint4*>(q_s + r * L::QP + c * 8) =
        t < a.Tq ? *reinterpret_cast<const uint4*>(Q + t * a.q_st + c * 8) : zero4;
  }

  // phase 1: S = Q Kᵀ; warp (wm, wn) computes rows r0..r0+15 x keys wn*32..+31 of a tile
  for (int k0 = 0; k0 < Tk; k0 += kTileK) {
    __syncthreads();
    for (int i = tid; i < kTileK * CH; i += kMmaThreads) {
      const int r = i / CH, c = i % CH, t = k0 + r;
      *reinterpret_cast<uint4*>(kv_s + r * L::QP + c * 8) =
          t < Tk ? *reinterpret_cast<const uint4*>(K + t * a.k_st + c * 8) : zero4;
    }
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < DH; kk += 16) {
      const __nv_bfloat16* qa = q_s + (r0 + g) * L::QP + kk + 2 * t4;
      const uint32_t a0 = lds32(qa), a1 = lds32(qa + 8 * L::QP);
      const uint32_t a2 = lds32(qa + 8), a3 = lds32(qa + 8 * L::QP + 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* kb = kv_s + (wn * 32 + nt * 8 + g) * L::QP + kk + 2 * t4;
        mma_bf16(acc[nt], a0, a1, a2, a3, lds32(kb), lds32(kb + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >> 1) * 8;
        const int c = k0 + wn * 32 + nt * 8 + 2 * t4 + (e & 1);
        if (c < Tk) {
          bool ok = valid ? valid[c] > 0 : true;
          if (a.causal) ok = ok && (c <= q0 + r + a.offset);
          s_s[r * SP + c] = ok ? acc[nt][e] * a.scale : kNegInf;
        }
      }
    }
  }
  __syncthreads();

  // phase 2: one warp per row: m, p = expf(s - m), l = sum p (fp32); P is
  // written as bf16 over the front of its own fp32 row (element c of P sits
  // in float slot c/2, read before it is overwritten), zero-padded to the tile
  const int Tk64 = (Tk + kTileK - 1) / kTileK * kTileK;
  for (int r = warp; r < kBlockQ; r += kMmaThreads / 32) {
    float* row = s_s + r * SP;
    __nv_bfloat16* prow = reinterpret_cast<__nv_bfloat16*>(row);
    float m = kNegInf;
    for (int c = lane; c < Tk; c += 32) m = fmaxf(m, row[c]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, w));
    float l = 0.f;
    for (int c0 = 0; c0 < Tk; c0 += 32) {
      const int c = c0 + lane;
      const float p = c < Tk ? expf(row[c] - m) : 0.f;
      l += p;
      __syncwarp();
      if (c < Tk) prow[c] = __float2bfloat16(p);
      __syncwarp();
    }
    for (int c = Tk + lane; c < Tk64; c += 32) prow[c] = __float2bfloat16(0.f);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
    if (lane == 0) l_s[r] = l;
  }

  // phase 3: O = P V; warp (wm, wn) owns rows r0..r0+15 x columns wn*DH/2..+DH/2-1
  constexpr int NT = DH / 16;
  float o[NT][4] = {};
  for (int k0 = 0; k0 < Tk; k0 += kTileK) {
    __syncthreads();
    for (int i = tid; i < kTileK * CH; i += kMmaThreads) {   // Vᵀ tile: [d][key]
      const int r = i % kTileK, c = i / kTileK, t = k0 + r;
      uint4 x = t < Tk ? *reinterpret_cast<const uint4*>(V + t * a.v_st + c * 8) : zero4;
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv_s[(c * 8 + j) * L::VP + r] = xv[j];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 16) {
      const __nv_bfloat16* pa =
          reinterpret_cast<const __nv_bfloat16*>(s_s + (r0 + g) * SP) + k0 + kk + 2 * t4;
      const __nv_bfloat16* pa8 = reinterpret_cast<const __nv_bfloat16*>(s_s + (r0 + g + 8) * SP) +
                                 k0 + kk + 2 * t4;
      const uint32_t a0 = lds32(pa), a1 = lds32(pa8), a2 = lds32(pa + 8), a3 = lds32(pa8 + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* vb = kv_s + (wn * (DH / 2) + nt * 8 + g) * L::VP + kk + 2 * t4;
        mma_bf16(o[nt], a0, a1, a2, a3, lds32(vb), lds32(vb + 8));
      }
    }
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + half * 8, t = q0 + r;
    if (t >= a.Tq) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
    __nv_bfloat16* orow = O + ((long long)b * a.Tq + t) * a.H * DH + h * DH;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int d = wn * (DH / 2) + nt * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(orow + d) =
          __floats2bfloat162_rn(o[nt][half * 2] / den, o[nt][half * 2 + 1] / den);
    }
  }
}

template <int DH>
int launch_flash_prefill_mma(const AttnArgs& a, cudaStream_t stream) {
  auto kernel = flash_prefill_mma_kernel<DH>;
  const size_t smem = MmaLayout<DH>::smem_bytes(a.Tk);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// The tensor-core kernel takes 16-byte aligned bf16 rows (uint4 staging).
inline bool mma_eligible(const AttnArgs& a) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool strides = (a.q_sb | a.q_st | a.k_sb | a.k_st | a.v_sb | a.v_st) % 8 == 0;
  return (a.Dh == 64 || a.Dh == 128) && aligned(a.q) && aligned(a.k) && aligned(a.v) &&
         aligned(a.o) && strides && a.Tk >= 1 && a.Tk <= kMaxTk && a.Tq >= 1;
}

}  // namespace ovla

// Returns the launch's cudaError_t (0 on success).
extern "C" int ovla_flash_prefill(const void* q, const void* k, const void* v, void* o,
                                  const int32_t* kv_valid, int B, int H, int Tq, int Tk,
                                  int Dh, long long q_sb, long long q_st, long long k_sb,
                                  long long k_st, long long v_sb, long long v_st, float scale,
                                  int offset, int causal, int is_bf16, void* stream) {
  ovla::AttnArgs a{q, k, v, o, kv_valid, B, H, Tq, Tk, Dh, q_sb, q_st,
                   k_sb, k_st, v_sb, v_st, scale, offset, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && ovla::mma_eligible(a)) {
    return Dh == 128 ? ovla::launch_flash_prefill_mma<128>(a, s)
                     : ovla::launch_flash_prefill_mma<64>(a, s);
  }
  if (is_bf16) return ovla::launch_attention_rows<__nv_bfloat16, false, true>(a, s);
  return ovla::launch_attention_rows<float, false, true>(a, s);
}
