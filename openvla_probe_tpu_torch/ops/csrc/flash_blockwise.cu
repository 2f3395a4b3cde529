// flash_blockwise: causal + key-validity masked online-softmax attention for
// any key length (the Llama forward at Tk > 1024: candidate scoring of long
// rows).
//
// Replaces the TPU kernel openvla_probe_tpu/ops/attention.py::_flash_kernel
// (reached through flash_attention when Tk > 1024). Function kept: q upcast to
// fp32 and scaled, k and v upcast to fp32; per key block s = q . k,
// ok = kv_valid[b, c] > 0 && (!causal || c <= qi + offset), masked scores =
// NEG_INF (finite); m' = max(m, rowmax s), p = expf(s - m'),
// corr = expf(m - m'), l = l * corr + sum p, acc = acc * corr + p . v with p
// in fp32; out = acc / max(l, 1e-30) cast to the input type. This is not the
// one-shot kernel's numeric class (flash_prefill.cu scales after the dot and
// rounds P to bf16 before PV).
//
// Two differences from the TPU program, both deliberate:
//   * the TPU wrapper pads Tk to a multiple of 128 in device memory, so a
//     query row with no valid key also counts the pad keys in l and returns
//     sum(V) / Tk_padded; here keys past Tk get a score of -inf (p = 0
//     exactly), so such a row returns the mean of V over the Tk keys, the rule
//     the port keeps for the one-shot kernel too. Nothing is padded in memory:
//     the last K/V tile and the last query tile are masked in the kernel;
//   * bf16 path: the scale multiplies the fp32 dot (q . k) * scale instead of
//     (q * scale) . k, since the tensor cores take the bf16 q as it is; the two
//     differ only by fp32 rounding (at Dh = 64 the scale is 1/8 and they are
//     equal).
//
// Bound on the H100 at the scoring shape of the path (q/k/v [8, 1088, 32, 128]
// bf16, Cb = 8 rows of 1 + 256 + 831 tokens): 285 MB of q/k/v/out (85 us at
// 3.35 TB/s) against 155 GFLOP (every key block visited, as the TPU kernel
// does: 157 us at 989 TFLOP/s), so it is bound by operations.
//
// Design (a first version: right, simple, no Tk limit):
//   * bf16 with Dh = 64 or 128 and 16-byte aligned rows (the path): a block of
//     4 warps owns 64 query rows of one (b, h), 16 rows a warp; Q fragments
//     stay in registers; K/V tiles of 64 keys stream through shared memory in
//     a two-stage cp.async ring (pitch Dh + 8: conflict-free fragment loads);
//     S = Q Kᵀ on mma.sync m16n8k16 bf16 -> fp32; m, l and the output stay in
//     registers. PV must not round p to bf16: each p is split into
//     hi = bf16(p) and lo = bf16(p - hi) and both go through mma.sync against
//     the same V fragment (ldmatrix.trans), so p is carried to about 2^-16 of
//     its value (two tensor-core products instead of a scalar fp32 FMA loop,
//     which would run at 67 instead of 989 TFLOP/s; TF32 would cut p and V to
//     10 bits and is never used);
//   * every other case (fp32 inputs, other head dims, unaligned rows): a
//     scalar fp32-FMA kernel with the same function, q scaled before the dot
//     as in the TPU program, on the staging of attention_common.cuh.
// Skipping key blocks above the causal diagonal, wgmma and TMA are later work.
#include "attention_common.cuh"
#include "int8_mma.cuh"   // the cp.async ring pieces

namespace ovla {

using ovla_i8::cp_async16;
using ovla_i8::cp_async_commit;
using ovla_i8::cp_async_wait;

constexpr int kBwThreads = 128;   // 4 warps x 16 query rows
constexpr int kBwRows = 64;       // query rows per block
constexpr int kBwKeys = 64;       // keys per K / V tile

template <int DH>
struct BwLayout {
  static constexpr int P = DH + 8;                 // bf16 row pitch: 4-word bank skew
  static constexpr int TILE = kBwKeys * P;         // one K or V tile
  static constexpr size_t kSmem = sizeof(__nv_bfloat16) * (size_t(kBwRows) * P + 4 * TILE);
};

// Stage rows [k0, k0 + 64) of K and V (this (b, h)) into one ring stage; rows
// past Tk are zero-filled.
template <int DH>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                             const __nv_bfloat16* K, const __nv_bfloat16* V,
                                             const AttnArgs& a, int k0) {
  constexpr int CH = DH / 8;
  for (int i = threadIdx.x; i < kBwKeys * CH; i += kBwThreads) {
    const int r = i / CH, c = i % CH, t = k0 + r;
    const bool ok = t < a.Tk;
    cp_async16(ks + r * BwLayout<DH>::P + c * 8, ok ? K + t * a.k_st + c * 8 : K, ok ? 16 : 0);
    cp_async16(vs + r * BwLayout<DH>::P + c * 8, ok ? V + t * a.v_st + c * 8 : V, ok ? 16 : 0);
  }
}

template <int DH>
__global__ void __launch_bounds__(kBwThreads) flash_blockwise_mma_kernel(AttnArgs a) {
  using L = BwLayout<DH>;
  constexpr int KT = DH / 16;   // k16 steps of Q Kᵀ
  constexpr int NO = DH / 8;    // n8 output tiles
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][P]
  __nv_bfloat16* ring = q_s + kBwRows * L::P;                        // [2][K | V][64][P]

  const int q0 = blockIdx.x * kBwRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;
  const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * DH;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * DH;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * DH;
  const int32_t* valid = a.kv_valid ? a.kv_valid + (long long)b * a.Tk : nullptr;
  const int n_tiles = (a.Tk + kBwKeys - 1) / kBwKeys;

  {
    constexpr int CH = DH / 8;
    for (int i = tid; i < kBwRows * CH; i += kBwThreads) {
      const int r = i / CH, c = i % CH, t = q0 + r;
      const bool ok = t < a.Tq;
      cp_async16(q_s + r * L::P + c * 8, ok ? Q + t * a.q_st + c * 8 : Q, ok ? 16 : 0);
    }
  }
  load_kv_tile<DH>(ring, ring + L::TILE, K, V, a, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KT][4];   // this warp's 16 query rows as A fragments, for every tile
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const __nv_bfloat16* qa = q_s + (r0 + g) * L::P + kk * 16 + 2 * t4;
    qf[kk][0] = lds32(qa), qf[kk][1] = lds32(qa + 8 * L::P);
    qf[kk][2] = lds32(qa + 8), qf[kk][3] = lds32(qa + 8 * L::P + 8);
  }

  float o[NO][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // rows g and g + 8 of the warp
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBwKeys;
    if (j + 1 < n_tiles) {
      __nv_bfloat16* nxt = ring + ((j + 1) & 1) * 2 * L::TILE;
      load_kv_tile<DH>(nxt, nxt + L::TILE, K, V, a, k0 + kBwKeys);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = ring + (j & 1) * 2 * L::TILE;
    const __nv_bfloat16* vs = ks + L::TILE;

    // S = Q Kᵀ for this warp's 16 rows x 64 keys (8 n8 tiles)
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kb = ks + (nt * 8 + g) * L::P + kk * 16 + 2 * t4;
        mma_bf16(s[nt], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], lds32(kb), lds32(kb + 8));
      }
    }
    // scale, mask, and the running max of each of the thread's two rows
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + nt * 8 + 2 * t4 + (e & 1), hr = e >> 1;
        float x = s[nt][e] * a.scale;
        if (c >= a.Tk) {
          x = -INFINITY;                       // past the keys: p = 0 exactly
        } else {
          bool ok = valid ? valid[c] > 0 : true;
          if (a.causal) ok = ok && (c <= row[hr] + a.offset);
          if (!ok) x = kNegInf;
        }
        s[nt][e] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      // exactly 1 while every key so far is masked (m = m' = NEG_INF), exactly
      // 0 once a valid key follows masked blocks: expf, not a fast approximation
      corr[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
      l[hr] *= corr[hr];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      o[nt][0] *= corr[0], o[nt][1] *= corr[0];
      o[nt][2] *= corr[1], o[nt][3] *= corr[1];
    }
    // O += P V with p = hi + lo, both bf16 halves through the tensor cores.
    // The accumulator layout of S tiles 2kk and 2kk + 1 is the A-fragment
    // layout of keys 16kk..16kk+15.
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
      const __nv_bfloat16* vrow = vs + (kk * 16 + (mi & 1) * 8 + rr) * L::P + (mi >> 1) * 8;
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + np * 16);
        mma_bf16(o[2 * np], hi[0], hi[1], hi[2], hi[3], bv[0], bv[1]);
        mma_bf16(o[2 * np], lo[0], lo[1], lo[2], lo[3], bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], hi[0], hi[1], hi[2], hi[3], bv[2], bv[3]);
        mma_bf16(o[2 * np + 1], lo[0], lo[1], lo[2], lo[3], bv[2], bv[3]);
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
    if (row[hr] >= a.Tq) continue;
    const float den = fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow = O + ((long long)b * a.Tq + row[hr]) * a.H * DH + h * DH;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[nt][hr * 2] / den, o[nt][hr * 2 + 1] / den);
    }
  }
}

template <int DH>
int launch_blockwise_mma(const AttnArgs& a, cudaStream_t stream) {
  auto kernel = flash_blockwise_mma_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(BwLayout<DH>::kSmem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Tq + kBwRows - 1) / kBwRows, a.H, a.B);
  kernel<<<grid, kBwThreads, BwLayout<DH>::kSmem, stream>>>(a);
  return int(cudaGetLastError());
}

// --- scalar fp32-FMA version (fp32 inputs, other head dims) ------------------------
// One block of 256 threads owns kBlockQ = 32 query rows of one (b, h); per key
// tile of kBlockK = 64: S on fp32 FMAs (q scaled before the dot), then one warp
// per row updates m and l and writes p, then acc = acc * corr + P V.

constexpr int kSPitch = kBlockK + 16;   // score tile pitch (floats): two rows per warp apart

__host__ __device__ inline size_t blockwise_rows_smem(int Dh) {
  return sizeof(float) * (size_t(kBlockQ) * Dh + size_t(kBlockK) * (Dh + kPitchPad) +
                          size_t(kBlockQ) * kSPitch + 3 * kBlockQ);
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads) flash_blockwise_rows_kernel(AttnArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int Tk = a.Tk, Dh = kDh > 0 ? kDh : a.Dh, KP = Dh + kPitchPad;
  float* q_s = smem;                       // [kBlockQ][Dh], scaled
  float* kv_s = q_s + kBlockQ * Dh;        // [kBlockK][KP]: a K tile, then a V tile
  float* p_s = kv_s + kBlockK * KP;        // [kBlockQ][kSPitch]: scores, then p
  float* m_s = p_s + kBlockQ * kSPitch;    // running max, sum, this tile's correction
  float* l_s = m_s + kBlockQ;
  float* c_s = l_s + kBlockQ;

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * Dh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + h * Dh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + h * Dh;
  const int32_t* valid = a.kv_valid ? a.kv_valid + (long long)b * Tk : nullptr;

  for (int i = tid; i < kBlockQ * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh, t = q0 + r;
    q_s[i] = t < a.Tq ? to_f32(Q[t * a.q_st + d]) * a.scale : 0.f;
  }
  if (tid < kBlockQ) m_s[tid] = kNegInf, l_s[tid] = 0.f;

  const int ty = tid / 16, tx = tid % 16;   // scores: rows {ty, ty + 16} x keys {tx + 16 j}
  const int py = tid / 32, px = tid % 32;   // output: rows {py + 8 i} x columns {px + 32 j}
  float o[4][4] = {};
  for (int k0 = 0; k0 < Tk; k0 += kBlockK) {
    __syncthreads();   // q_s written / the previous V tile consumed
    stage_tile(kv_s, K, a.k_st, k0, Tk, Dh);
    __syncthreads();
    float acc[2][4] = {};
    for (int d = 0; d < Dh; ++d) {
      const float xa = q_s[ty * Dh + d], xb = q_s[(ty + 16) * Dh + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = kv_s[(tx + 16 * j) * KP + d];
        acc[0][j] += xa * kk;
        acc[1][j] += xb * kk;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = -INFINITY;   // past the keys: p = 0 exactly
        if (c < Tk) {
          bool ok = valid ? valid[c] > 0 : true;
          if (a.causal) ok = ok && (c <= q0 + r + a.offset);
          x = ok ? acc[i][j] : kNegInf;
        }
        p_s[r * kSPitch + tx + 16 * j] = x;
      }
    }
    __syncthreads();   // scores written, K consumed
    for (int r = warp; r < kBlockQ; r += kThreads / 32) {
      float* row = p_s + r * kSPitch;
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0, row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr, m_s[r] = m_new, l_s[r] = l_s[r] * corr + sum;
      }
    }
    stage_tile(kv_s, V, a.v_st, k0, Tk, Dh);
    __syncthreads();   // p, corrections and the V tile ready
    const int kn = min(kBlockK, Tk - k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[py + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= corr;
    }
    for (int kk = 0; kk < kn; ++kk) {
      float vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = px + 32 * j;
        vv[j] = d < Dh ? kv_s[kk * KP + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(py + 8 * i) * kSPitch + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] += p * vv[j];
      }
    }
  }
  __syncthreads();

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

template <typename T, int kDh = 0>
int launch_blockwise_rows(const AttnArgs& a, cudaStream_t stream) {
  if (a.Dh < 1 || a.Dh > kMaxDh || a.Tk < 1 || a.Tq < 1 || (kDh > 0 && a.Dh != kDh))
    return int(cudaErrorInvalidValue);
  auto kernel = flash_blockwise_rows_kernel<T, kDh>;
  const size_t smem = blockwise_rows_smem(a.Dh);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Tq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// The tensor-core kernel takes 16-byte aligned bf16 rows (cp.async staging).
inline bool blockwise_mma_eligible(const AttnArgs& a) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool strides = (a.q_sb | a.q_st | a.k_sb | a.k_st | a.v_sb | a.v_st) % 8 == 0;
  return (a.Dh == 64 || a.Dh == 128) && aligned(a.q) && aligned(a.k) && aligned(a.v) &&
         aligned(a.o) && strides && a.Tk >= 1 && a.Tq >= 1;
}

}  // namespace ovla

// Returns the launch's cudaError_t (0 on success).
extern "C" int ovla_flash_blockwise(const void* q, const void* k, const void* v, void* o,
                                    const int32_t* kv_valid, int B, int H, int Tq, int Tk,
                                    int Dh, long long q_sb, long long q_st, long long k_sb,
                                    long long k_st, long long v_sb, long long v_st, float scale,
                                    int offset, int causal, int is_bf16, void* stream) {
  ovla::AttnArgs a{q, k, v, o, kv_valid, B, H, Tq, Tk, Dh, q_sb, q_st,
                   k_sb, k_st, v_sb, v_st, scale, offset, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && ovla::blockwise_mma_eligible(a)) {
    return Dh == 128 ? ovla::launch_blockwise_mma<128>(a, s)
                     : ovla::launch_blockwise_mma<64>(a, s);
  }
  if (is_bf16) return ovla::launch_blockwise_rows<__nv_bfloat16>(a, s);
  return ovla::launch_blockwise_rows<float>(a, s);
}
