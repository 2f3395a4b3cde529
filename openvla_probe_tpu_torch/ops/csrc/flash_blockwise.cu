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
// bf16, Cb = 8 rows of 1 + 256 + 831 tokens, right-padded to 1000-1088): 285 MB
// of q/k/v/out (85 us at 3.35 TB/s) against 80 GFLOP of the causal, unpadded
// products (81 us at 989 TFLOP/s; 155 GFLOP if every key tile is visited, as
// the TPU kernel does).
//
// Tile skip (causal only; `visits` in attention_common.cuh, shared with
// flash_prefill.cu). A key tile is skipped for 64 query rows when it lies
// wholly above their causal diagonal, or past the last valid key of the batch
// row, or holds no valid key at all, once every one of those rows has seen a
// valid key: such a row gets p = expf(NEG_INF - m) = 0 and corr = 1 from the
// tile, so skipping it leaves its bits as they are. A row that has seen no
// valid key counts the tile's masked keys at p = 1 (the mean of V over Tk), so
// when the first valid key lies past the first row's diagonal the rows visit
// every tile. The rule depends only on the mask, so it is decided before the
// first tile (tests/test_torch_kernel_arith_skip_fold.py emulates it). The
// query blocks with the most tiles start first.
//
// Design:
//   * bf16 with Dh = 64 or 128 and 16-byte aligned rows (the path): wgmma fed
//     by TMA, warp-specialized (FA3's shape). A block owns 128 query rows of
//     one (b, h); 288 threads. One producer thread loads Q once and keeps a
//     4-stage ring of K and V tiles (64 keys, 128-byte swizzle, TMA boxes of a
//     4-D map over [B, T, H, Dh] with the caller's strides, rows past T
//     zero-filled) on full / empty mbarriers, loading only the tiles one of
//     the block's two 64-row halves visits. Two consumer warpgroups of 64 rows:
//     S = Q Kᵀ by wgmma m64n64k16 (Q and K from shared memory, K-major), then
//     the scale, the mask (the batch row's validity bits, staged once as a
//     bitmask), the online softmax in registers, and O += P V by wgmma
//     m64n{Dh}k16 with P as the register A operand and V read MN-major (the
//     transpose bit). PV must not round p to bf16: each p is split into
//     hi = bf16(p) and lo = bf16(p - hi), both multiplied by V, so p is carried
//     to about 2^-16 of its value; TF32 would cut p and V to 10 bits and is
//     never used;
//   * every other case (fp32 inputs, other head dims, unaligned rows): a
//     scalar fp32-FMA kernel with the same function, q scaled before the dot
//     as in the TPU program, on the staging of attention_common.cuh.
#include <climits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace ovla {

namespace hp = ovla_hp;

constexpr int kFwRows = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int kFwKeys = 64;        // keys per K / V tile
constexpr int kFwStages = 4;
constexpr int kFwConsumers = 256;
constexpr int kFwThreads = kFwConsumers + 32;

template <int DH>
struct FwLayout {
  static constexpr int NB = DH / 64;                      // 128-byte column blocks of a row
  static constexpr int Q_BLK = kFwRows * 128;             // one column block of Q, 16 KB
  static constexpr int KV_BLK = kFwKeys * 128;            // one column block of K or V, 8 KB
  static constexpr int Q_BYTES = NB * Q_BLK;
  static constexpr int STAGE = 2 * NB * KV_BLK;           // K, then V
  // Q, the ring, the barriers (Q, full and empty per stage), the validity bits
  static size_t smem(int Tk) {
    return 1024 + size_t(Q_BYTES) + size_t(kFwStages) * STAGE + (1 + 2 * kFwStages) * 8 +
           4 * size_t((Tk + 31) / 32 + 1);
  }
};

template <int DH>
__global__ void __launch_bounds__(kFwThreads, 1)
    flash_blockwise_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v, AttnArgs a) {
  using L = FwLayout<DH>;
  constexpr int NO = DH / 2;   // output accumulator registers per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = q_s + L::Q_BYTES;                                    // [stage][K | V]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kFwStages * L::STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFwStages;
  uint32_t* okw = reinterpret_cast<uint32_t*>(empty + kFwStages);   // validity bits of the keys
  __shared__ int first_s, last_s;

  // the query blocks with the most key tiles first (the last along Tq)
  const int h = blockIdx.x, b = blockIdx.y, q0 = (gridDim.z - 1 - blockIdx.z) * kFwRows;
  const int tid = threadIdx.x, lane = tid % 32;
  const int n_words = (a.Tk + 31) / 32, n_tiles = (a.Tk + kFwKeys - 1) / kFwKeys;

  if (tid == 0) {
    hp::mbar_init(q_full, 1);
    for (int i = 0; i < kFwStages; ++i) {
      hp::mbar_init(full + i, 1);    // the producer's arrival, then the tile's bytes
      hp::mbar_init(empty + i, 2);   // one thread of each consumer warpgroup
    }
    hp::mbar_init_fence();
    first_s = INT_MAX, last_s = -1;
  }
  __syncthreads();
  // the batch row's validity bits and its first and last valid key
  stage_valid_bits(a, b, okw, &first_s, &last_s, kFwThreads);
  __syncthreads();
  const int first = first_s, last = last_s;

  if (tid >= kFwConsumers) {
    // ---- producer: Q once, then the ring of K and V tiles the block visits ----
    if (tid == kFwConsumers) {
      hp::mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < L::NB; ++nb)
        hp::tma_load_4d(q_s + nb * L::Q_BLK, &tm_q, nb * 64, h, q0, b, q_full);
      int i = 0;
      for (int j = 0; j < n_tiles; ++j) {
        if (!visits(a, okw, first, last, q0, j) && !visits(a, okw, first, last, q0 + 64, j))
          continue;
        const int slot = i % kFwStages;
        hp::mbar_wait(empty + slot, ((i / kFwStages) & 1) ^ 1);   // the first round passes
        uint8_t* st = ring + slot * L::STAGE;
        hp::mbar_expect_tx(full + slot, L::STAGE);
#pragma unroll
        for (int nb = 0; nb < L::NB; ++nb) {
          hp::tma_load_4d(st + nb * L::KV_BLK, &tm_k, nb * 64, h, j * kFwKeys, b, full + slot);
          hp::tma_load_4d(st + (L::NB + nb) * L::KV_BLK, &tm_v, nb * 64, h, j * kFwKeys, b,
                          full + slot);
        }
        ++i;
      }
    }
    return;
  }

  // ---- two consumer warpgroups: query rows qw .. qw + 63 ----
  const int wg = tid / 128, wt = tid % 128, g = lane >> 2, t4 = lane & 3;
  const int qw = q0 + wg * 64, other = q0 + (1 - wg) * 64;
  const int row[2] = {qw + (wt / 32) * 16 + g, qw + (wt / 32) * 16 + g + 8};
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  hp::mbar_wait(q_full, 0);

  int i = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const bool mine = visits(a, okw, first, last, qw, j);
    if (!mine && !visits(a, okw, first, last, other, j)) continue;
    const int slot = i % kFwStages;
    hp::mbar_wait(full + slot, (i / kFwStages) & 1);
    ++i;
    if (!mine) {   // the other half's tile
      if (wt == 0) hp::mbar_arrive(empty + slot);
      continue;
    }
    const uint8_t* ks = ring + slot * L::STAGE;
    const uint8_t* vs = ks + L::NB * L::KV_BLK;

    // S = Q Kᵀ: this warpgroup's 64 rows x 64 keys
    float s[32];
    hp::fence_operands(s);
    hp::wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < L::NB; ++nb)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_bf16_ss_m64n64k16(s, hp::desc_sw128(q_s + nb * L::Q_BLK + wg * 64 * 128 + kk * 32),
                                    hp::desc_sw128(ks + nb * L::KV_BLK + kk * 32), nb + kk > 0);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_operands(s);

    // scale, mask, and the running max of each of the thread's two rows
    const int k0 = j * kFwKeys;
    const uint32_t bits[2] = {okw[2 * j], 2 * j + 1 < n_words ? okw[2 * j + 1] : 0u};
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = nt * 8 + 2 * t4 + (e & 1), c = k0 + kc, hr = e >> 1;
        float x = s[4 * nt + e] * a.scale;
        if (c >= a.Tk) {
          x = -INFINITY;                       // past the keys: p = 0 exactly
        } else {
          bool ok = (bits[kc >> 5] >> (kc & 31)) & 1u;
          if (a.causal) ok = ok && (c <= row[hr] + a.offset);
          if (!ok) x = kNegInf;
        }
        s[4 * nt + e] = x;
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
    for (int e = 0; e < 32; ++e) {
      const float p = expf(s[e] - m[(e >> 1) & 1]);
      s[e] = p;
      l[(e >> 1) & 1] += p;
    }
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] *= corr[(e >> 1) & 1];

    // O += P V with p = hi + lo: the accumulator layout of S's n8 blocks 2kk and
    // 2kk + 1 is the register-A layout of keys 16kk .. 16kk + 15
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* src = s + 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        hi[kk][r] = pack_bf16(src[0], src[1]);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][r]);
        lo[kk][r] = pack_bf16(src[0] - __low2float(hv), src[1] - __high2float(hv));
      }
    }
    hp::fence_operands(o);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = hp::desc_sw128_mn(vs + kk * 16 * 128, L::KV_BLK);
      if constexpr (DH == 128) {
        hp::wgmma_bf16_rs_m64n128k16(o, hi[kk], vd, 1);
        hp::wgmma_bf16_rs_m64n128k16(o, lo[kk], vd, 1);
      } else {
        hp::wgmma_bf16_rs_m64n64k16(o, hi[kk], vd, 1);
        hp::wgmma_bf16_rs_m64n64k16(o, lo[kk], vd, 1);
      }
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_operands(o);
    if (wt == 0) hp::mbar_arrive(empty + slot);
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
    for (int nt = 0; nt < DH / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + 2 * t4) =
          __floats2bfloat162_rn(o[4 * nt + 2 * hr] / den, o[4 * nt + 2 * hr + 1] / den);
    }
  }
}

template <int DH>
int launch_blockwise_wgmma(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = FwLayout<DH>::smem(a.Tk);
  const int q_blocks = (a.Tq + kFwRows - 1) / kFwRows;
  if (smem > 232448 || q_blocks > 65535 || a.B > 65535) return int(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!hp::encode_heads(&tm_q, a.q, a.B, a.Tq, a.H, DH, a.q_sb, a.q_st, kFwRows) ||
      !hp::encode_heads(&tm_k, a.k, a.B, a.Tk, a.H, DH, a.k_sb, a.k_st, kFwKeys) ||
      !hp::encode_heads(&tm_v, a.v, a.B, a.Tk, a.H, DH, a.v_sb, a.v_st, kFwKeys))
    return int(cudaErrorInvalidValue);
  auto kernel = flash_blockwise_wgmma_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(a.H, a.B, q_blocks);
  kernel<<<grid, kFwThreads, smem, stream>>>(tm_q, tm_k, tm_v, a);
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

// The tensor-core kernel takes bf16 at Dh = 64 or 128 with 16-byte aligned rows (the TMA
// maps' strides).
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
    return Dh == 128 ? ovla::launch_blockwise_wgmma<128>(a, s)
                     : ovla::launch_blockwise_wgmma<64>(a, s);
  }
  if (is_bf16) return ovla::launch_blockwise_rows<__nv_bfloat16>(a, s);
  return ovla::launch_blockwise_rows<float>(a, s);
}
