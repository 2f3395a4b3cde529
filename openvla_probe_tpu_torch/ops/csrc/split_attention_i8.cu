// split_attention_i8: one decode query per (batch, head) over an int8 frozen prefill segment
// and the generated-token buffer, with one joint softmax (the turbo_kv8 tier's decode step).
//
// Replaces the XLA function openvla_probe_tpu/models/llama.py::_split_attention_i8 (:746-800),
// which the JAX package runs on the TPU's integer MXU. Semantics kept:
//   * q row-quantized over Dh: s_q = max(max|q|, 1e-8) / 127 (the clamp before the IEEE
//     division), codes clip(rint(q / s_q), -127, 127);
//   * the exact int32 q · Kp, rescaled as (f32(acc) · s_q) · s_k, then · scale + the additive
//     mask (0 or the finite NEG_INF), rounded to the scores dtype (bf16 on the turbo tiers);
//   * the decode segment q · Kd summed in fp32 and rounded to the scores dtype, then · scale +
//     mask, rounded again;
//   * one fp32 softmax over [prefill | decode]: p = expf(s - max) / sum, an IEEE division;
//   * the prefill probabilities times the V scales (pf = p · s_v), row-quantized with
//     s_p = max(max|pf|, 1e-12) / 127 over the whole row (its max taken before any code is
//     made), codes clip(rint(pf / s_p), -127, 127); the exact int32 p · Vp, times s_p;
//   * plus the decode probabilities cast to q's dtype times Vd, summed in fp32;
//   * the sum cast to q's dtype.
// Every division is an IEEE division (__fdiv_rn), every rounding to nearest even; every product
// and sum of the scores is rounded once (the _rn intrinsics keep nvcc from contracting). The
// integer dots are exact in any order; the fp32 sums (the softmax denominator, q · Kd, the
// decode segment's p · V) run in another order than the plain version's, so the two are held
// by ops/decode_attention.py::compare_split_attention_i8. No dequantized K or V reaches memory.
//
// Bound on the H100 at the OpenVLA-7B serving shape (B = 24, H = Hkv = 32, Dh = 128, T = 288,
// A = 6 generated slots): the int8 Kp and Vp, 2 · 24 · 288 · 4096 = 56.6 MB, their scales
// 1.8 MB and the bf16 decode buffer 2.4 MB: 60.8 MB, 0.018 ms at 3.35 TB/s; 192 launches a
// call (32 layers x 6 steps).
//
// Two routes, chosen by the wrapper's declared rule (ops/decode_attention.py::
// split_ring_eligible) before the launch, each launcher refusing what it does not take:
//  * ovla_split_attention_i8: bf16 q at Dh = 128, n_rep in {1, 2, 4, 8}: the ring route below.
//  * ovla_split_attention_i8_scalar: every other call (fp32 q, other head dims, other n_rep):
//    the first version, one block of 256 threads a (kv head, batch), a thread a prefill key
//    (16-byte loads, __dp4a), each query head of the kv head in turn, p · Vp by 16-byte loads.
//    Every CTA of the serving shape is resident at once, so that kernel's time was one CTA's
//    chain of dependent phases (quantize q, the scores, the max, the sum, pf's max, the codes,
//    p · V), no V byte asked for before the softmax ended, K and V read again for each query
//    head (0.049 ms at serving on an H100 80GB HBM3 at 700 W; PERF.md §6).
//
// The ring route (decode_common.cuh's, on stacked_decode_i8.cu's int8 rows):
//  * Grid (Hkv * cs, B), cs CTAs (one cluster, `cluster_size`'s rule: 1 at serving's 768
//    (b, kv head) pairs, one wave, launched without the cluster attribute; 4 at one row) a
//    (b, kv head), 4 warps a CTA. CTA `rank` owns prefill keys [rank * per, min(T, (rank + 1) *
//    per)); rank 0 also takes the A decode slots. Warp w streams chunks w, w + 4, ... of 16 keys,
//    its K chunks then its V chunks, through 2 stages of its own (16-byte cp.async copies, 4 a
//    lane, at a 144-byte row pitch, arriving on the stage's mbarrier), so its first V chunks are
//    in flight while the softmax runs; no block-wide barrier inside the streams. The scales
//    and validity of the CTA's keys are read into shared memory while the first chunks fly.
//  * GQA in one pass: the n_rep query heads of the kv head are the columns of the mma's B
//    operand, so K and V are read once a kv head.
//  * Exact integer dots on fp16 tensor cores: a code c becomes the fp16 value c by a byte
//    permute (decode_common.cuh codes_h2); q's codes and p's codes are integers below 128, so
//    each rides as one fp16 column. q · k: S^T = K · q (mma.sync m16n8k16, fp32 sums), each
//    product at most 127², a 128-deep sum below 2.1e6 < 2^24: exact. p · V: out^T = V^T · P^T
//    (V by ldmatrix.trans), exact in fp32 while a warp has summed at most 1040 keys (1040 ·
//    127² < 2^24), so every 1024 keys of a warp (kHandoff chunks) and at the end its sums move
//    into int32 in shared memory; the whole row (T <= 4095) stays below 2^31.
//  * The scores: the key's dot (exact) · s_q · s_k · scale + mask, rounded, into shared memory;
//    rank 0's decode slots by a warp a slot (fp32 products of q and Kd, shuffle sums) while the
//    first K chunks fly. Each head's max, then its sum of expf(s - m), then pf's max over the
//    prefill keys are each taken over the whole row, across the cluster (a slot every CTA reads
//    after a cluster barrier) before anything that depends on them: p codes made against a
//    CTA's own max would compute another function. Rank 0 adds the CTAs' int32 p · V sums, the
//    decode segment (bf16 p times Vd, fp32, a thread a head dim) and stores.
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_ab.py in turns with the first version;
// PERF.md §6): 0.0340 ms at the serving shape against 0.0498 (bound 0.0183), 80 registers at
// n_rep 1, no spill; one row 0.0175 against 0.0193, the same at 1, 2 and 4 CTAs.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace ovla_sir {

namespace cg = cooperative_groups;
using ovla_dec::ceil_div;
using ovla_dec::codes_h2;
using ovla_dec::keys_per_cta;
using ovla_dec::kRows;
using ovla_dec::kThreads;
using ovla_dec::kWarps;
using ovla_dec::mma_f16;

constexpr int kDh = 128;                       // the head dim of the ring route
constexpr int kRowBytes = kDh;                 // one int8 row of K or V
constexpr int kPitch = kRowBytes + 16;         // 9 16-byte units: conflict-free ldmatrix
constexpr int kWarpStages = 2;                 // each warp's ring depth
constexpr int kStages = kWarps * kWarpStages;
constexpr int kStageBytes = kRows * kPitch;
constexpr int kHandoff = 64;                   // chunks (1024 keys) a warp between int32 hand-offs
constexpr int kMaxKeys = 4096;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kNegInf = -2.3819763e38f;      // ops/attention.py NEG_INF
static_assert(kThreads == kDh, "a thread per head dim");
static_assert(kHandoff * kRows * 127 * 127 < (1 << 24), "a warp's fp32 sums stay exact");

struct Args {
  const __nv_bfloat16* q;    // [B, 1, H, Dh]
  const int8_t* kq;          // [B, T, Hkv, Dh]
  const float* ks;           // [B, T, Hkv]
  const int8_t* vq;
  const float* vs;
  const __nv_bfloat16* kd;   // [B, A, Hkv, Dh]
  const __nv_bfloat16* vd;
  const int* pre_valid;      // [B, T]
  const int* dec_valid;      // [B, A]
  __nv_bfloat16* out;        // [B, 1, H, Dh]
  int B, H, Hkv, T, A;
  float scale;
  int scores_bf16;
  int cs;                    // CTAs a (b, kv head): the cluster size
};

// bytes of dynamic shared memory a CTA takes: the ring, its barriers, the warps' int32 p · V,
// q in fp32, the CTA's int32 p · V for the cluster's sum, the keys' scales, the scores (then pf,
// then p's codes) and the decode slots' scores (then their bf16 p), the reduction and cluster
// slots, q's fp16 codes, the keys' validity
inline size_t smem_bytes(int T, int A, int cs, int nrep) {
  const size_t per = keys_per_cta(T, cs);
  return size_t(kStages) * kStageBytes + kStages * sizeof(uint64_t) +
         sizeof(float) * (size_t(kWarps + 2) * nrep * kDh + 2 * per + nrep * (per + A) +
                          kWarps * (nrep + 1) + 4 * nrep) +
         sizeof(__half) * nrep * kDh + per;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ int code(float x, float s) {
  return __float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
}

// per head r: the max (kMax) or the sum of every thread's v[r] over the CTA (warp trees, then
// the warps in order), then over the cluster's CTAs in rank order through `slot` [NREP], a
// cluster-wide slot no other exchange uses
template <int NREP, bool kMax>
__device__ __forceinline__ void reduce_heads(float (&v)[NREP], float* red, float* slot, int cs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, v[r], o);
      v[r] = kMax ? fmaxf(v[r], y) : __fadd_rn(v[r], y);
    }
    if (lane == 0) red[warp * (NREP + 1) + r] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float x = red[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      x = kMax ? fmaxf(x, red[w * (NREP + 1) + r]) : __fadd_rn(x, red[w * (NREP + 1) + r]);
    v[r] = x;
  }
  __syncthreads();   // `red` is free again
  if (cs == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0)
#pragma unroll
    for (int r = 0; r < NREP; ++r) slot[r] = v[r];
  cluster.sync();
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float x = cluster.map_shared_rank(slot, 0)[r];
    for (int i = 1; i < cs; ++i) {
      const float y = cluster.map_shared_rank(slot, i)[r];
      x = kMax ? fmaxf(x, y) : __fadd_rn(x, y);
    }
    v[r] = x;
  }
}

template <int NREP>
__global__ void __launch_bounds__(kThreads, NREP <= 2 ? ovla_dec::kMinBlocksPerSm : 1)
    split_ring_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int cs = a.cs, T_ = a.T, A = a.A;
  const int kvh = blockIdx.x / cs, rank = blockIdx.x % cs, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;          // mma fragment row / column pair
  const int per = keys_per_cta(T_, cs);
  const int k0 = min(T_, rank * per), k1 = min(T_, k0 + per), n = k1 - k0;
  const int nch = ceil_div(n, kRows);
  // this warp's chunks: keys [16 j, 16 j + 16) of the CTA for j = warp, warp + 4, ...; its K
  // chunks, then its V chunks, through its own stages
  const int nk = nch > warp ? ceil_div(nch - warp, kWarps) : 0, total = 2 * nk;
  const int nA = rank == 0 ? A : 0;               // the decode slots: rank 0's
  const bool sbf = a.scores_bf16 != 0;
  auto round_s = [&](float x) { return sbf ? round_bf16(x) : x; };

  unsigned char* ring = smem;                                   // [kWarps][kWarpStages][..]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);   // [kStages]
  int* ipart = reinterpret_cast<int*>(full + kStages);          // [kWarps][NREP][kDh]
  float* qf = reinterpret_cast<float*>(ipart + kWarps * NREP * kDh);   // [NREP][kDh]
  int* xo = reinterpret_cast<int*>(qf + NREP * kDh);            // [NREP][kDh]: the CTA's p · V
  float* ks_sm = reinterpret_cast<float*>(xo + NREP * kDh);     // [per]
  float* vs_sm = ks_sm + per;                                   // [per]
  float* s_sm = vs_sm + per;                                    // [NREP][per]
  float* d_sm = s_sm + NREP * per;                              // [NREP][A]
  float* red = d_sm + NREP * A;                                 // [kWarps][NREP + 1]
  float* xm = red + kWarps * (NREP + 1);                        // [NREP] cluster slots:
  float* xl = xm + NREP;                                        //   the max, the sum,
  float* xp = xl + NREP;                                        //   pf's max
  float* sq = xp + NREP;                                        // [NREP]: s_q
  __half* qh = reinterpret_cast<__half*>(sq + NREP);            // [NREP][kDh]: q's codes
  int8_t* ok_sm = reinterpret_cast<int8_t*>(qh + NREP * kDh);   // [per]
  unsigned char* my_ring = ring + warp * kWarpStages * kStageBytes;
  uint64_t* my_full = full + warp * kWarpStages;

  const long long rowb = (long long)a.Hkv * kDh;                // bytes a token
  const int8_t* kb = a.kq + (long long)b * T_ * rowb + kvh * kDh;
  const int8_t* vb = a.vq + (long long)b * T_ * rowb + kvh * kDh;

  if (lane == 0) {
    for (int i = 0; i < kWarpStages; ++i) ovla_hp::mbar_init(&my_full[i], 32);
    ovla_hp::mbar_init_fence();
  }
  __syncwarp();

  // the warp's u-th chunk into its stage u % kWarpStages: 16-byte cp.async copies, lane L the
  // unit L % 8 of rows L / 8 + 4i, each lane's copies arriving on the stage's barrier (32
  // arrivals a phase). Any byte is a finite code, so the stale rows of a partial chunk need no
  // clearing: their p code is 0.
  auto issue = [&](int u) {
    const bool is_v = u >= nk;
    const int j = warp + kWarps * (is_v ? u - nk : u);
    const int r0 = k0 + j * kRows;
    const int rows = min(kRows, k1 - r0);
    const uint32_t dst = ovla_hp::smem_u32(my_ring + (u % kWarpStages) * kStageBytes) +
                         (lane / 8) * kPitch + (lane % 8) * 16;
    const int8_t* src = (is_v ? vb : kb) + (long long)(r0 + lane / 8) * rowb + (lane % 8) * 16;
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i)
      if (lane / 8 + 4 * i < rows)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 4 * i * kPitch),
                     "l"(src + 4 * i * rowb)
                     : "memory");
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     ovla_hp::smem_u32(&my_full[u % kWarpStages]))
                 : "memory");
  };
  for (int u = 0; u < min(kWarpStages, total); ++u) issue(u);

  // while the first chunks fly: the warps' int32 sums cleared, the CTA's scales and validity
  for (int i = tid; i < kWarps * NREP * kDh; i += kThreads) ipart[i] = 0;
  for (int i = tid; i < n; i += kThreads) {
    const long long sk = (long long)b * T_ + k0 + i;
    ks_sm[i] = a.ks[sk * a.Hkv + kvh];
    vs_sm[i] = a.vs[sk * a.Hkv + kvh];
    ok_sm[i] = a.pre_valid[sk] > 0;
  }

  // q's codes per head (thread tid: dim tid), as fp16 into shared memory; q in fp32 beside them
  {
    float xq[NREP], mq[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      xq[r] = __bfloat162float(a.q[((long long)b * a.H + kvh * NREP + r) * kDh + tid]);
      qf[r * kDh + tid] = xq[r];
      mq[r] = fabsf(xq[r]);
    }
    reduce_heads<NREP, true>(mq, red, nullptr, 1);
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float s = __fdiv_rn(fmaxf(mq[r], 1e-8f), 127.f);
      qh[r * kDh + tid] = __int2half_rn(code(xq[r], s));
      if (tid == 0) sq[r] = s;
    }
    __syncthreads();
  }
  // B's columns for q · k: column g is head g (0 past NREP); a thread's words at dims
  // 16U + 4t4 .. + 3 stand for the fragment's k = 2t4, 2t4 + 1 and 2t4 + 8, 2t4 + 9, as K's
  uint32_t qb[8][2];
#pragma unroll
  for (int U = 0; U < 8; ++U) {
    const __half* qc = qh + g * kDh + 16 * U + 4 * t4;
    qb[U][0] = g < NREP ? *reinterpret_cast<const uint32_t*>(qc) : 0u;
    qb[U][1] = g < NREP ? *reinterpret_cast<const uint32_t*>(qc + 2) : 0u;
  }

  // rank 0's decode slots, a warp a slot, a lane 4 head dims: fp32 products and sums, the sum
  // rounded to the scores dtype, · scale, + mask, rounded again
  for (int s = warp; s < nA; s += kWarps) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        a.kd + ((long long)(b * A + s) * a.Hkv + kvh) * kDh + 4 * lane);
    const float kv[4] = {__bfloat162float(__ushort_as_bfloat16(raw.x & 0xffffu)),
                         __bfloat162float(__ushort_as_bfloat16(raw.x >> 16)),
                         __bfloat162float(__ushort_as_bfloat16(raw.y & 0xffffu)),
                         __bfloat162float(__ushort_as_bfloat16(raw.y >> 16))};
    const bool ok = a.dec_valid[b * A + s] > 0;
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc = __fadd_rn(acc, __fmul_rn(qf[r * kDh + 4 * lane + i], kv[i]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      if (lane == 0)
        d_sm[r * A + s] =
            round_s(__fadd_rn(__fmul_rn(round_s(acc), a.scale), ok ? 0.f : kNegInf));
    }
  }

  // q · k: a warp's chunk is one 16-key tile; head r's exact dot is column r
  for (int u = 0; u < nk; ++u) {
    ovla_hp::mbar_wait(&my_full[u % kWarpStages], (u / kWarpStages) & 1);
    const unsigned char* stage = my_ring + (u % kWarpStages) * kStageBytes;
    uint32_t w[8][2];   // unit U (dims 16U ..): this lane's word of rows g and g + 8
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t r4[4];
      const int mi = lane / 8;   // matrices: rows 0-7 / 8-15 of units 2p, 2p + 1
      ovla_dec::ldsm_x4(r4, stage + ((lane % 8) + 8 * (mi % 2)) * kPitch + (2 * p + mi / 2) * 16,
                        false);
      w[2 * p][0] = r4[0];
      w[2 * p][1] = r4[1];
      w[2 * p + 1][0] = r4[2];
      w[2 * p + 1][1] = r4[3];
    }
    __syncwarp();
    if (u + kWarpStages < total) issue(u + kWarpStages);
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int U = 0; U < 8; ++U) {
      const uint32_t x0 = w[U][0] ^ 0x80808080u, x1 = w[U][1] ^ 0x80808080u;
      const uint32_t af[4] = {codes_h2(x0, 0x4140), codes_h2(x1, 0x4140), codes_h2(x0, 0x4342),
                              codes_h2(x1, 0x4342)};
      mma_f16(c, af, qb[U][0], qb[U][1]);
    }
    const int key = (warp + kWarps * u) * kRows + g;
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const int src = (lane & ~3) | (r / 2);
      const float lo = __shfl_sync(0xffffffffu, c[r % 2], src);       // key g
      const float hi = __shfl_sync(0xffffffffu, c[2 + r % 2], src);   // key g + 8
      if (t4 == r % 4) {
        if (key < n) s_sm[r * per + key] = lo;
        if (key + 8 < n) s_sm[r * per + key + 8] = hi;
      }
    }
  }
  __syncthreads();

  // the scores: (dot · s_q) · s_k, · scale + mask, rounded; each head's max over the row
  float m[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) m[r] = -INFINITY;   // a CTA may own no key
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = ok_sm[i];
    const float sk = ks_sm[i];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float v = __fmul_rn(__fmul_rn(s_sm[r * per + i], sq[r]), sk);
      const float sc = round_s(__fadd_rn(__fmul_rn(v, a.scale), ok ? 0.f : kNegInf));
      s_sm[r * per + i] = sc;
      m[r] = fmaxf(m[r], sc);
    }
  }
  for (int s = tid; s < nA; s += kThreads)
#pragma unroll
    for (int r = 0; r < NREP; ++r) m[r] = fmaxf(m[r], d_sm[r * A + s]);
  reduce_heads<NREP, true>(m, red, xm, cs);

  // e = expf(s - m) and its sum over the row
  float l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) l[r] = 0.f;
  for (int i = tid; i < n; i += kThreads)
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float e = expf(__fsub_rn(s_sm[r * per + i], m[r]));
      s_sm[r * per + i] = e;
      l[r] = __fadd_rn(l[r], e);
    }
  for (int s = tid; s < nA; s += kThreads)
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float e = expf(__fsub_rn(d_sm[r * A + s], m[r]));
      d_sm[r * A + s] = e;
      l[r] = __fadd_rn(l[r], e);
    }
  reduce_heads<NREP, false>(l, red, xl, cs);

  // p = e / l; pf = p · s_v over the prefill and its max over the row; the decode p in bf16
  float pm[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) pm[r] = 0.f;
  for (int i = tid; i < n; i += kThreads)
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float pf = __fmul_rn(__fdiv_rn(s_sm[r * per + i], l[r]), vs_sm[i]);
      s_sm[r * per + i] = pf;
      pm[r] = fmaxf(pm[r], fabsf(pf));
    }
  for (int s = tid; s < nA; s += kThreads)
#pragma unroll
    for (int r = 0; r < NREP; ++r) d_sm[r * A + s] = round_bf16(__fdiv_rn(d_sm[r * A + s], l[r]));
  reduce_heads<NREP, true>(pm, red, xp, cs);
  float sp[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) sp[r] = __fdiv_rn(fmaxf(pm[r], 1e-12f), 127.f);
  // p's codes against the row's s_p, as floats in place (0 past the CTA's keys, up to the last
  // chunk's end)
  for (int i = tid; i < nch * kRows; i += kThreads)
#pragma unroll
    for (int r = 0; r < NREP; ++r)
      s_sm[r * per + i] = i < n ? float(code(s_sm[r * per + i], sp[r])) : 0.f;
  __syncthreads();

  // p · V: out^T = V^T · P^T, this lane's column g (head g) of P; acc[U]: dims 16U + 2g (rows
  // g: e 0, 1) and 16U + 2g + 1 (rows g + 8: e 2, 3), columns 2t4 + (e & 1)
  float acc[8][4];
#pragma unroll
  for (int U = 0; U < 8; ++U) acc[U][0] = acc[U][1] = acc[U][2] = acc[U][3] = 0.f;
  // the exact fp32 sums into the warp's int32 ones, then restarted
  auto handoff = [&] {
#pragma unroll
    for (int U = 0; U < 8; ++U)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * t4 + (e & 1);
        if (col < NREP)
          ipart[(warp * NREP + col) * kDh + 16 * U + 2 * g + (e >> 1)] += __float2int_rn(acc[U][e]);
        acc[U][e] = 0.f;
      }
  };
  for (int u = nk; u < total; ++u) {
    const int kbase = (warp + kWarps * (u - nk)) * kRows;   // the chunk's first key
    uint32_t pb0 = 0u, pb1 = 0u;
    if (g < NREP) {
      const float* pc = s_sm + g * per + kbase + 2 * t4;
      const float2 lo = *reinterpret_cast<const float2*>(pc);
      const float2 hi = *reinterpret_cast<const float2*>(pc + 8);
      const __half2 l2 = __floats2half2_rn(lo.x, lo.y), h2 = __floats2half2_rn(hi.x, hi.y);
      pb0 = *reinterpret_cast<const uint32_t*>(&l2);
      pb1 = *reinterpret_cast<const uint32_t*>(&h2);
    }
    ovla_hp::mbar_wait(&my_full[u % kWarpStages], (u / kWarpStages) & 1);
    const unsigned char* stage = my_ring + (u % kWarpStages) * kStageBytes;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t r4[4];
      const int mi = lane / 8;   // matrices: keys 0-7 / 8-15 of units 2p, 2p + 1
      ovla_dec::ldsm_x4(r4, stage + ((lane % 8) + 8 * (mi % 2)) * kPitch + (2 * p + mi / 2) * 16,
                        true);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // unit U = 2p + h: r4[2h] keys 2t4, 2t4 + 1 and r4[2h + 1] keys 2t4 + 8, + 9, at dims
        // 16U + 2g (bytes 0, 2: fragment row g) and 16U + 2g + 1 (bytes 1, 3: row g + 8)
        const uint32_t x0 = r4[2 * h] ^ 0x80808080u, x1 = r4[2 * h + 1] ^ 0x80808080u;
        const uint32_t af[4] = {codes_h2(x0, 0x4240), codes_h2(x0, 0x4341),
                                codes_h2(x1, 0x4240), codes_h2(x1, 0x4341)};
        mma_f16(acc[2 * p + h], af, pb0, pb1);
      }
    }
    __syncwarp();
    if (u + kWarpStages < total) issue(u + kWarpStages);
    if ((u - nk + 1) % kHandoff == 0) handoff();
  }
  handoff();
  __syncthreads();

  // thread tid: head dim tid of every head. The warps' int32 sums (exact in any order), the
  // decode segment (rank 0), the cluster's CTAs added by rank 0
  int tot[NREP];
  float dec[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    tot[r] = 0;
    dec[r] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot[r] += ipart[(w * NREP + r) * kDh + tid];
  }
  for (int s = 0; s < nA; ++s) {
    const float v = __bfloat162float(a.vd[((long long)(b * A + s) * a.Hkv + kvh) * kDh + tid]);
#pragma unroll
    for (int r = 0; r < NREP; ++r) dec[r] = __fadd_rn(dec[r], __fmul_rn(d_sm[r * A + s], v));
  }
  __nv_bfloat16* out = a.out + ((long long)b * a.H + kvh * NREP) * kDh + tid;
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < NREP; ++r) xo[r * kDh + tid] = tot[r];
    cluster.sync();
    if (rank == 0)
      for (int i = 1; i < cs; ++i)
#pragma unroll
        for (int r = 0; r < NREP; ++r) tot[r] += cluster.map_shared_rank(xo, i)[r * kDh + tid];
  }
  if (rank == 0)
#pragma unroll
    for (int r = 0; r < NREP; ++r)
      out[r * kDh] =
          __float2bfloat16_rn(__fadd_rn(__fmul_rn(__int2float_rn(tot[r]), sp[r]), dec[r]));
  if (cs > 1) cg::this_cluster().sync();   // every CTA's shared memory stays until rank 0 read it
}

// `static`: each library's copy keeps its own opt-in state (w4a8_grouped.cu's resident_clusters)
template <int NREP>
static int launch(const Args& a, cudaStream_t stream) {
  auto kernel = split_ring_kernel<NREP>;
  const size_t smem = smem_bytes(a.T, a.A, a.cs, NREP);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  // the shared-memory opt-in once a kernel and process, at the most any launch takes
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kMaxSmem));
  if (opt_in != cudaSuccess) return int(opt_in);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv * a.cs, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;   // one CTA a (b, kv head): no cluster
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace ovla_sir

// ---- the scalar route: the first version ----
namespace ovla_si8 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDh = 256;
constexpr int kMaxKeys = 4096;
constexpr float kNegInf = -2.3819763e38f;   // ops/attention.py NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Args {
  const void* q;          // [B, 1, H, Dh] bf16 or fp32
  const int8_t* kq;       // [B, T, Hkv, Dh]
  const float* ks;        // [B, T, Hkv]
  const int8_t* vq;
  const float* vs;
  const void* kd;         // [B, A, Hkv, Dh] in q's dtype
  const void* vd;
  const int* pre_valid;   // [B, T]
  const int* dec_valid;   // [B, A]
  void* out;              // [B, 1, H, Dh] in q's dtype
  int B, H, Hkv, n_pre, n_dec, Dh;   // T prefill tokens, A decode slots
  float scale;
  int scores_bf16;
};

// block-wide max / sum over kThreads (warp trees, then the warps in order); `red` is reused,
// so each call first waits for every reader of the last one
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, w));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  return r;
}
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, w));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = __fadd_rn(r, red[i]);
  return r;
}

__device__ __forceinline__ int code(float x, float s) {
  return __float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) split_i8_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float qf[kMaxDh];              // q in fp32
  __shared__ uint32_t qw[kMaxDh / 4];       // q's codes, four a word in d order
  __shared__ int part[16 * kThreads];       // p · Vp shares [split][Dh]
  __shared__ float red[kWarps];
  __shared__ float sq_sh;
  const int T_ = a.n_pre, A = a.n_dec, Dh = a.Dh, Hkv = a.Hkv, W = Dh / 4;
  float* sc = reinterpret_cast<float*>(smem);               // the row's T + A scores, then p
  int8_t* pi = reinterpret_cast<int8_t*>(sc + T_ + A);      // the prefill codes of p
  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_rep = a.H / Hkv;
  const T* q = static_cast<const T*>(a.q);
  const T* kd = static_cast<const T*>(a.kd);
  const T* vd = static_cast<const T*>(a.vd);
  T* out = static_cast<T*>(a.out);
  const bool sbf = a.scores_bf16 != 0;
  auto round_s = [&](float x) { return sbf ? round_bf16(x) : x; };
  auto row = [&](int s) { return (long long)(b * T_ + s) * Hkv + hk; };        // prefill token
  auto drow = [&](int s) { return (long long)(b * A + s) * Hkv + hk; };        // decode slot

  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const long long qbase = ((long long)b * a.H + h) * Dh;
    // q: warp 0, each lane its words of 4 head dims (W <= 64)
    if (warp == 0) {
      float v[2][4];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int w = lane + 32 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[i][e] = w < W ? to_f(q[qbase + 4 * w + e]) : 0.f;
          if (w < W) qf[4 * w + e] = v[i][e];
          amax = fmaxf(amax, fabsf(v[i][e]));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int w = lane + 32 * i;
        if (w < W) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) word |= (uint32_t(code(v[i][e], s)) & 0xFFu) << (8 * e);
          qw[w] = word;
        }
      }
      if (lane == 0) sq_sh = s;
    }
    __syncthreads();
    const float s_q = sq_sh;

    // the prefill scores: a thread per key, its row's codes loaded whole (16-byte loads where
    // Dh is a multiple of 16, else words), its scale and validity beside them, then the dots
    for (int s = tid; s < T_; s += kThreads) {
      const int8_t* kr = a.kq + row(s) * Dh;
      const float ks = __ldg(a.ks + row(s));
      const bool valid = a.pre_valid[b * T_ + s] > 0;
      int acc = 0;
      if (Dh % 16 == 0) {
#pragma unroll 8
        for (int w = 0; w < Dh / 16; ++w) {
          const int4 c = __ldg(reinterpret_cast<const int4*>(kr) + w);
          acc = __dp4a(c.x, int(qw[4 * w]), acc);
          acc = __dp4a(c.y, int(qw[4 * w + 1]), acc);
          acc = __dp4a(c.z, int(qw[4 * w + 2]), acc);
          acc = __dp4a(c.w, int(qw[4 * w + 3]), acc);
        }
      } else {
#pragma unroll 8
        for (int w = 0; w < W; ++w)
          acc = __dp4a(int(__ldg(reinterpret_cast<const uint32_t*>(kr) + w)), int(qw[w]), acc);
      }
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), s_q), ks);
      sc[s] = round_s(__fadd_rn(__fmul_rn(v, a.scale), valid ? 0.f : kNegInf));
    }
    // the decode scores: a warp per slot, fp32 sums of the products
    for (int s = warp; s < A; s += kWarps) {
      const T* kr = kd + drow(s) * Dh;
      float acc = 0.f;
      for (int d = lane; d < Dh; d += 32) acc = __fadd_rn(acc, __fmul_rn(qf[d], to_f(kr[d])));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      if (lane == 0) {
        const float v = __fmul_rn(round_s(acc), a.scale);
        sc[T_ + s] = round_s(__fadd_rn(v, a.dec_valid[b * A + s] > 0 ? 0.f : kNegInf));
      }
    }
    __syncthreads();

    // one softmax over [prefill | decode]; pf = p · s_v over the prefill, and its row max
    float m = __int_as_float(static_cast<int>(0xff800000u));   // -inf
    for (int i = tid; i < T_ + A; i += kThreads) m = fmaxf(m, sc[i]);
    m = block_max(m, red);
    float sum = 0.f;
    for (int i = tid; i < T_ + A; i += kThreads) {
      const float e = expf(__fsub_rn(sc[i], m));
      sc[i] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = block_sum(sum, red);
    float pmax = 0.f;
    for (int i = tid; i < T_ + A; i += kThreads) {
      float p = __fdiv_rn(sc[i], sum);
      if (i < T_) {
        p = __fmul_rn(p, __ldg(a.vs + row(i)));
        pmax = fmaxf(pmax, fabsf(p));
      }
      sc[i] = p;
    }
    pmax = block_max(pmax, red);
    const float s_p = __fdiv_rn(fmaxf(pmax, 1e-12f), 127.f);
    for (int i = tid; i < T_; i += kThreads) pi[i] = static_cast<int8_t>(code(sc[i], s_p));
    __syncthreads();

    // p · Vp: thread (split, w) owns `vec` head dims (16: one 16-byte load a key, where Dh is a
    // multiple of 16; else 4, a word) over every nsplit-th key, integer products
    const int vec = Dh % 16 == 0 ? 16 : 4, per_row = Dh / vec, nsplit = kThreads / per_row;
    const int wd = tid % per_row, split = tid / per_row;
    if (split < nsplit) {
      int o[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = 0;
      if (vec == 16) {
#pragma unroll 4
        for (int s = split; s < T_; s += nsplit) {
          const int4 c = __ldg(reinterpret_cast<const int4*>(a.vq + row(s) * Dh) + wd);
          const uint32_t w[4] = {uint32_t(c.x), uint32_t(c.y), uint32_t(c.z), uint32_t(c.w)};
          const int p = pi[s];
#pragma unroll
          for (int e = 0; e < 16; ++e)
            o[e] += p * int(static_cast<int8_t>(w[e / 4] >> (8 * (e % 4))));
        }
      } else {
#pragma unroll 4
        for (int s = split; s < T_; s += nsplit) {
          const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(a.vq + row(s) * Dh) + wd);
          const int p = pi[s];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] += p * int(static_cast<int8_t>(w >> (8 * e)));
        }
      }
      if (vec == 16) {
#pragma unroll
        for (int e = 0; e < 16; ++e) part[split * Dh + 16 * wd + e] = o[e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[split * Dh + 4 * wd + e] = o[e];
      }
    }
    __syncthreads();
    // the shares' exact sum · s_p, plus the decode segment, cast to q's dtype
    for (int d = tid; d < Dh; d += kThreads) {
      int tot = 0;
      for (int i = 0; i < nsplit; ++i) tot += part[i * Dh + d];
      float dec = 0.f;
#pragma unroll 4
      for (int s = 0; s < A; ++s)
        dec = __fadd_rn(dec, __fmul_rn(to_f(from_f<T>(sc[T_ + s])), to_f(vd[drow(s) * Dh + d])));
      out[qbase + d] = from_f<T>(__fadd_rn(__fmul_rn(__int2float_rn(tot), s_p), dec));
    }
    __syncthreads();   // the next head reuses the row's buffers
  }
}

}  // namespace ovla_si8

// The ring route: bf16 q, kd and vd at Dh = 128, H / Hkv in {1, 2, 4, 8}, 1 <= T, 1 <= A,
// T + A <= 4096, kq and vq 16-byte aligned; anything else is refused (cudaErrorInvalidValue)
// before a launch. Returns the launch's cudaError_t (0 on success). Arguments as
// ovla_split_attention_i8_scalar's, then `cs` CTAs a (b, kv head): 1, 2 or 4, or 0 for
// cluster_size's rule.
extern "C" int ovla_split_attention_i8_cs(const void* q, const void* kq, const void* ks,
                                          const void* vq, const void* vs, const void* kd,
                                          const void* vd, const void* pre_valid,
                                          const void* dec_valid, void* out, int B, int H,
                                          int Hkv, int T, int A, int Dh, float scale, int is_bf16,
                                          int scores_bf16, int cs, void* stream) {
  const int nrep = Hkv > 0 ? H / Hkv : 0;
  auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (!is_bf16 || Dh != ovla_sir::kDh || B < 1 || B > 65535 || Hkv < 1 || H % Hkv != 0 ||
      (nrep != 1 && nrep != 2 && nrep != 4 && nrep != 8) || T < 1 || A < 1 ||
      T + A > ovla_sir::kMaxKeys || !q || !ks || !vs || !kd || !vd || !pre_valid ||
      !dec_valid || !out || !kq || !vq || misaligned(kq) || misaligned(vq) || misaligned(kd))
    return int(cudaErrorInvalidValue);
  cs = cs ? cs : ovla_dec::cluster_size(B * Hkv);
  if (cs != 1 && cs != 2 && cs != 4) return int(cudaErrorInvalidValue);
  const ovla_sir::Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
                         static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
                         static_cast<const float*>(vs), static_cast<const __nv_bfloat16*>(kd),
                         static_cast<const __nv_bfloat16*>(vd),
                         static_cast<const int*>(pre_valid), static_cast<const int*>(dec_valid),
                         static_cast<__nv_bfloat16*>(out), B, H, Hkv, T, A, scale, scores_bf16,
                         cs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nrep) {
    case 1: return ovla_sir::launch<1>(a, st);
    case 2: return ovla_sir::launch<2>(a, st);
    case 4: return ovla_sir::launch<4>(a, st);
    default: return ovla_sir::launch<8>(a, st);
  }
}

// The ring route at cluster_size's rule. The signature is the scalar route's.
extern "C" int ovla_split_attention_i8(const void* q, const void* kq, const void* ks,
                                       const void* vq, const void* vs, const void* kd,
                                       const void* vd, const void* pre_valid,
                                       const void* dec_valid, void* out, int B, int H, int Hkv,
                                       int T, int A, int Dh, float scale, int is_bf16,
                                       int scores_bf16, void* stream) {
  return ovla_split_attention_i8_cs(q, kq, ks, vq, vs, kd, vd, pre_valid, dec_valid, out, B, H,
                                    Hkv, T, A, Dh, scale, is_bf16, scores_bf16, 0, stream);
}

// The scalar route. Returns the launch's cudaError_t (0 on success). q [B, 1, H, Dh] (bf16 when
// is_bf16, else fp32); kq, vq int8 and ks, vs fp32 [B, T, Hkv, (Dh)]; kd, vd [B, A, Hkv, Dh] in
// q's dtype; pre_valid [B, T] and dec_valid [B, A] int32 (1 = attend); out [B, 1, H, Dh] in q's
// dtype; scores rounded to bf16 when scores_bf16. All contiguous and 4-byte aligned; Dh a
// multiple of 4 up to 256, H a multiple of Hkv, 1 <= T, 1 <= A, T + A <= 4096.
extern "C" int ovla_split_attention_i8_scalar(const void* q, const void* kq, const void* ks,
                                              const void* vq, const void* vs, const void* kd,
                                              const void* vd, const void* pre_valid,
                                              const void* dec_valid, void* out, int B, int H,
                                              int Hkv, int T, int A, int Dh, float scale,
                                              int is_bf16, int scores_bf16, void* stream) {
  using namespace ovla_si8;
  auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) != 0; };
  if (B < 1 || B > 65535 || Hkv < 1 || H < Hkv || H % Hkv != 0 || T < 1 || A < 1 ||
      T + A > kMaxKeys || Dh < 4 || Dh % 4 != 0 || Dh > kMaxDh || !q || !ks || !vs ||
      !pre_valid || !dec_valid || misaligned(kq) || misaligned(vq) || !kq || !vq || !kd ||
      !vd || !out)
    return int(cudaErrorInvalidValue);
  const Args a{q, static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
               static_cast<const int8_t*>(vq), static_cast<const float*>(vs), kd, vd,
               static_cast<const int*>(pre_valid), static_cast<const int*>(dec_valid), out,
               B, H, Hkv, T, A, Dh, scale, scores_bf16};
  const size_t smem = (size_t(T + A) * 4 + T + 15) / 16 * 16;
  const dim3 grid(Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    split_i8_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(a);
  else
    split_i8_kernel<float><<<grid, kThreads, smem, st>>>(a);
  return int(cudaGetLastError());
}
