// flash_prefill: causal + key-validity masked one-shot attention for the
// Llama prefill.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/attention.py::_flash_flat_kernel
// (reached through _flash_oneshot / flash_attention for Tk <= 1024). Function
// kept exactly: s = (q . k in fp32) * scale, scale = 1/sqrt(Dh) applied after
// the dot; ok = kv_valid[b, c] > 0 && (!causal || c <= q + offset); masked
// scores = NEG_INF (finite); m = the max over the WHOLE key row; p = expf(s - m);
// l = sum p over the unrounded fp32 p; P rounded to bf16 once for one bf16 PV
// with fp32 accumulation; out = pv / max(l, 1e-30). A row with no valid key has
// m = NEG_INF and p = 1 on each of the Tk keys: the mean of V over Tk (keys past
// Tk get p = 0 exactly). An online softmax is another function (P rounded
// against a running max, then rescaled), and so is a p split into bf16 halves
// (flash_blockwise.cu): neither is used.
//
// Bound on the H100 at the OpenVLA-7B prefill shape (B=24, q [24, 288, 32, 128],
// k/v [24, 295, 32, 128] bf16): ~229 MB of q/k/v/out per layer (68 us at
// 3.35 TB/s) against 33 GFLOP of bf16 products before the causal skip (34 us at
// 989 TFLOP/s), so it is bytes-bound.
//
// Design (bf16, Dh = 64 or 128, 16-byte aligned rows; the route the wrapper
// names flash_prefill): wgmma fed by TMA, warp-specialized, on the pieces of
// flash_blockwise.cu. A block owns 128 query rows of one (b, h); 288 threads.
//   * Two passes over the key tiles (64 keys) the block visits: pass 1 computes
//     S = Q Kᵀ and each row's max; pass 2 computes S again by the same wgmma
//     sequence on the same bits (the same fp32 scores), then p, l, bf16(P) as
//     wgmma's register operand, and O += P V with V read MN-major (the
//     transpose bit). O is never rescaled. The products cost 1.5x those of one
//     pass (two QKᵀ, one PV), still under the bytes bound at the path's shape.
//   * One producer thread loads Q once (a TMA box of [128 rows][64 columns] per
//     64 columns, 128-byte swizzle; rows past Tq zero-filled) and keeps a
//     4-stage ring of K tiles (pass 1) and K and V tiles (pass 2) full: TMA
//     boxes of a 4-D map over [B, T, H, Dh] with the caller's strides (parity's
//     K / V are views of the stacked cache), keys past Tk zero-filled, on full /
//     empty mbarriers. Two consumer warpgroups of 64 rows read each stage.
//   * The batch row's key validity is staged once as a bitmask; keys at or past
//     Tk are masked in the kernel as well (score -inf, p = 0).
//   * The causal key-tile skip of flash_blockwise.cu (`visits`,
//     attention_common.cuh), with its guard: a 64-row group skips a tile only
//     once every one of its rows has seen a valid key, so a skipped tile holds
//     only scores of NEG_INF for those rows, which change neither m nor (at
//     p = 0) l or O.
//   * The query blocks of one (b, h) are launched side by side, the block with
//     the most key tiles first, so their re-reads of the head's K and V (116 MB
//     a layer at the path's shape, the L2 holds 50) come from L2.
// Every other case (fp32 inputs, other head dims, unaligned rows) is the scalar
// fp32-FMA kernel of attention_common.cuh, the same function, launched through
// ovla_flash_prefill_scalar (the wrapper counts it as flash_prefill_scalar).
#include <climits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace ovla {

namespace hp = ovla_hp;

constexpr int kPfRows = 128;   // query rows per block: two consumer warpgroups of 64
constexpr int kPfKeys = kSkipKeys;   // keys per K / V tile
constexpr int kPfStages = 4;
constexpr int kPfConsumers = 256;
constexpr int kPfThreads = kPfConsumers + 32;

template <int DH>
struct PfLayout {
  static constexpr int NB = DH / 64;                   // 128-byte column blocks of a row
  static constexpr int Q_BLK = kPfRows * 128;          // one column block of Q, 16 KB
  static constexpr int KV_BLK = kPfKeys * 128;         // one column block of K or V, 8 KB
  static constexpr int Q_BYTES = NB * Q_BLK;
  static constexpr int K_BYTES = NB * KV_BLK;
  static constexpr int STAGE = 2 * K_BYTES;            // K, then V (pass 2)
  // Q, the ring, the barriers (Q, full and empty per stage), the validity bits
  static size_t smem(int Tk) {
    return 1024 + size_t(Q_BYTES) + size_t(kPfStages) * STAGE + (1 + 2 * kPfStages) * 8 +
           4 * size_t((Tk + 31) / 32 + 1);
  }
};

// This warpgroup's 64 rows x 64 keys of S = Q Kᵀ from a K tile at `ks`, scaled and masked:
// keys at or past Tk -inf, masked keys NEG_INF. The same instructions in both passes, so
// the same bits.
template <int DH>
__device__ __forceinline__ void scores(float (&s)[32], const uint8_t* q_s, const uint8_t* ks,
                                       const AttnArgs& a, const uint32_t* okw, int j, int wg,
                                       int t4, const int (&row)[2]) {
  using L = PfLayout<DH>;
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
  const int k0 = j * kPfKeys, n_words = (a.Tk + 31) / 32;
  const uint32_t bits[2] = {okw[2 * j], 2 * j + 1 < n_words ? okw[2 * j + 1] : 0u};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kc = nt * 8 + 2 * t4 + (e & 1), c = k0 + kc;
      float x = s[4 * nt + e] * a.scale;
      if (c >= a.Tk) {
        x = -INFINITY;                       // past the keys: p = 0 exactly
      } else {
        bool ok = (bits[kc >> 5] >> (kc & 31)) & 1u;
        if (a.causal) ok = ok && (c <= row[e >> 1] + a.offset);
        if (!ok) x = kNegInf;
      }
      s[4 * nt + e] = x;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kPfThreads, 1)
    flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, AttnArgs a) {
  using L = PfLayout<DH>;
  constexpr int NO = DH / 2;   // output accumulator registers per thread
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = q_s + L::Q_BYTES;                                    // [stage][K | V]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kPfStages * L::STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kPfStages;
  uint32_t* okw = reinterpret_cast<uint32_t*>(empty + kPfStages);   // validity bits of the keys
  __shared__ int first_s, last_s;

  // the query blocks of one (b, h) side by side, the one with the most key tiles (the last
  // along Tq) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kPfRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int n_tiles = (a.Tk + kPfKeys - 1) / kPfKeys;

  if (tid == 0) {
    hp::mbar_init(q_full, 1);
    for (int i = 0; i < kPfStages; ++i) {
      hp::mbar_init(full + i, 1);    // the producer's arrival, then the tile's bytes
      hp::mbar_init(empty + i, 2);   // one thread of each consumer warpgroup
    }
    hp::mbar_init_fence();
    first_s = INT_MAX, last_s = -1;
  }
  __syncthreads();
  stage_valid_bits(a, b, okw, &first_s, &last_s, kPfThreads);
  __syncthreads();
  const int first = first_s, last = last_s;

  if (tid >= kPfConsumers) {
    // ---- producer: Q once, then K tiles (pass 1) and K and V tiles (pass 2) ----
    if (tid == kPfConsumers) {
      hp::mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < L::NB; ++nb)
        hp::tma_load_4d(q_s + nb * L::Q_BLK, &tm_q, nb * 64, h, q0, b, q_full);
      int i = 0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int j = 0; j < n_tiles; ++j) {
          if (!visits(a, okw, first, last, q0, j) && !visits(a, okw, first, last, q0 + 64, j))
            continue;
          const int slot = i % kPfStages;
          hp::mbar_wait(empty + slot, ((i / kPfStages) & 1) ^ 1);   // the first round passes
          uint8_t* st = ring + slot * L::STAGE;
          hp::mbar_expect_tx(full + slot, pass ? L::STAGE : L::K_BYTES);
#pragma unroll
          for (int nb = 0; nb < L::NB; ++nb) {
            hp::tma_load_4d(st + nb * L::KV_BLK, &tm_k, nb * 64, h, j * kPfKeys, b, full + slot);
            if (pass)
              hp::tma_load_4d(st + L::K_BYTES + nb * L::KV_BLK, &tm_v, nb * 64, h, j * kPfKeys,
                              b, full + slot);
          }
          ++i;
        }
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
  for (int e = 0; e < NO; ++e) o[e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  hp::mbar_wait(q_full, 0);

  int i = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {   // the whole row's max: the quad's four threads hold its 64-key columns
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 1));
        m[hr] = fmaxf(m[hr], __shfl_xor_sync(0xffffffffu, m[hr], 2));
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const bool mine = visits(a, okw, first, last, qw, j);
      if (!mine && !visits(a, okw, first, last, other, j)) continue;
      const int slot = i % kPfStages;
      hp::mbar_wait(full + slot, (i / kPfStages) & 1);
      ++i;
      if (!mine) {   // the other half's tile
        if (wt == 0) hp::mbar_arrive(empty + slot);
        continue;
      }
      const uint8_t* ks = ring + slot * L::STAGE;
      float s[32];
      scores<DH>(s, q_s, ks, a, okw, j, wg, t4, row);
      if (pass == 0) {
#pragma unroll
        for (int e = 0; e < 32; ++e) m[(e >> 1) & 1] = fmaxf(m[(e >> 1) & 1], s[e]);
        if (wt == 0) hp::mbar_arrive(empty + slot);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = expf(s[e] - m[(e >> 1) & 1]);
        s[e] = p;
        l[(e >> 1) & 1] += p;
      }
      // O += bf16(P) V: the accumulator layout of S's n8 blocks 2kk and 2kk + 1 is the
      // register-A layout of keys 16kk .. 16kk + 15
      uint32_t pf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* src = s + 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
          pf[kk][r] = pack_bf16(src[0], src[1]);
        }
      const uint8_t* vs = ks + L::K_BYTES;
      hp::fence_operands(o);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vd = hp::desc_sw128_mn(vs + kk * 16 * 128, L::KV_BLK);
        if constexpr (DH == 128)
          hp::wgmma_bf16_rs_m64n128k16(o, pf[kk], vd, 1);
        else
          hp::wgmma_bf16_rs_m64n64k16(o, pf[kk], vd, 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_operands(o);
      if (wt == 0) hp::mbar_arrive(empty + slot);
    }
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
int launch_flash_prefill_wgmma(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = PfLayout<DH>::smem(a.Tk);
  if (smem > 232448 || a.H > 65535 || a.B > 65535) return int(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!hp::encode_heads(&tm_q, a.q, a.B, a.Tq, a.H, DH, a.q_sb, a.q_st, kPfRows) ||
      !hp::encode_heads(&tm_k, a.k, a.B, a.Tk, a.H, DH, a.k_sb, a.k_st, kPfKeys) ||
      !hp::encode_heads(&tm_v, a.v, a.B, a.Tk, a.H, DH, a.v_sb, a.v_st, kPfKeys))
    return int(cudaErrorInvalidValue);
  auto kernel = flash_prefill_wgmma_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.Tq + kPfRows - 1) / kPfRows, a.H, a.B);
  kernel<<<grid, kPfThreads, smem, stream>>>(tm_q, tm_k, tm_v, a);
  return int(cudaGetLastError());
}

// The tensor-core route's rule (attention.py prefill_mma_eligible declares the same): bf16
// at Dh = 64 or 128, 16-byte aligned rows (the TMA maps' strides), 1 <= Tk <= 1024.
inline bool prefill_mma_eligible(const AttnArgs& a, int is_bf16) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool strides = (a.q_sb | a.q_st | a.k_sb | a.k_st | a.v_sb | a.v_st) % 8 == 0;
  return is_bf16 && (a.Dh == 64 || a.Dh == 128) && aligned(a.q) && aligned(a.k) &&
         aligned(a.v) && aligned(a.o) && strides && a.Tk >= 1 && a.Tk <= kMaxTk && a.Tq >= 1;
}

}  // namespace ovla

// The tensor-core route; an input outside its rule is refused (cudaErrorInvalidValue).
// Returns the launch's cudaError_t (0 on success).
extern "C" int ovla_flash_prefill(const void* q, const void* k, const void* v, void* o,
                                  const int32_t* kv_valid, int B, int H, int Tq, int Tk,
                                  int Dh, long long q_sb, long long q_st, long long k_sb,
                                  long long k_st, long long v_sb, long long v_st, float scale,
                                  int offset, int causal, int is_bf16, void* stream) {
  const ovla::AttnArgs a{q, k, v, o, kv_valid, B, H, Tq, Tk, Dh, q_sb, q_st,
                         k_sb, k_st, v_sb, v_st, scale, offset, causal};
  if (!ovla::prefill_mma_eligible(a, is_bf16)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Dh == 128 ? ovla::launch_flash_prefill_wgmma<128>(a, s)
                   : ovla::launch_flash_prefill_wgmma<64>(a, s);
}

// The scalar route (fp32, other head dims, unaligned rows): the same function on fp32 FMAs.
extern "C" int ovla_flash_prefill_scalar(const void* q, const void* k, const void* v, void* o,
                                         const int32_t* kv_valid, int B, int H, int Tq, int Tk,
                                         int Dh, long long q_sb, long long q_st, long long k_sb,
                                         long long k_st, long long v_sb, long long v_st,
                                         float scale, int offset, int causal, int is_bf16,
                                         void* stream) {
  const ovla::AttnArgs a{q, k, v, o, kv_valid, B, H, Tq, Tk, Dh, q_sb, q_st,
                         k_sb, k_st, v_sb, v_st, scale, offset, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return ovla::launch_attention_rows<__nv_bfloat16, false, true>(a, s);
  return ovla::launch_attention_rows<float, false, true>(a, s);
}
