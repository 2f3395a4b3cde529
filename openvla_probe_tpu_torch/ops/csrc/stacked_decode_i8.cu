// stacked_decode_i8: softmax(q · K[li]) @ V[li] for one decode query per batch row over one
// layer of the int8 flat stacked KV cache, the dequantization fused.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/decode_attention.py::_stacked_i8_kernel
// (reached through stacked_decode_attention_i8 from llama.decode_step_stacked_i8, the
// pallas_kv8 tier's decode). Semantics kept, per kv head:
//   kf = f32(kq) · ks and vf = f32(vq) · vs per (slot, kv head); for each of its n_rep query
//   heads qh = f32(q) · scale (the scale applied BEFORE the dot); fp32 scores, NEG_INF where
//   the slot is not valid; one max, p = exp(s - m), l = Σp; P·V in fp32 with P unrounded;
//   out = cast(pv / max(l, 1e-30)).
// The TPU kernel's scalar-prefetched layer index is only how its BlockSpecs pick the layer:
// here the wrapper passes the layer's base pointers. Keys at or past `n` count as masked: the
// decode step passes n = slot + 1, whose later slots are masked anyway, so only keys [0, n) are
// read; a row with no valid key among them is masked everywhere and, as in the plain version,
// returns the mean of V over all S slots (p = 1 at every slot).
//
// Bound on the H100 at OpenVLA-7B, B = 24, S = 320 slots, 32 heads of 128, the query at slot
// 288 + t: one layer's int8 K and V codes of the keys up to the query (≈ 58 MB at n = 294) and
// their fp32 scales per launch, ≈ 0.018 ms at 3.35 TB/s; 32 x 6 = 192 launches per serving
// call.
//
// Two routes, chosen by the wrapper's declared rule (ops/decode_attention.py::
// stacked_ring_eligible) before the launch, each launcher refusing what it does not take:
//  * ovla_stacked_decode_i8: bf16 q at Dh = 128, n_rep in {1, 2, 4, 8}, S <= kRingMaxKeys:
//    the ring route below.
//  * ovla_stacked_decode_i8_scalar: every other call (fp32 q, Dh 16, 32 or 64): one block of
//    256 threads per (batch row, kv head) streams K and V from device memory into registers
//    (Dh / 4 lanes a slot, a 4-byte load each), dequantizes each code by an int -> float
//    conversion and keeps scores and probabilities in shared memory.
//
// The ring route (decode_common.cuh's, for int8 rows):
//  * Grid (Hkv * cs, B), cs CTAs (one cluster, `cluster_size`'s rule: 1 at serving's 768
//    (b, kv head) pairs, one wave, launched without the cluster attribute) a (b, kv head), 4
//    warps a CTA. CTA `rank` owns keys [rank * per, min(n, (rank + 1) * per)). Warp w streams
//    chunks w, w + 4, ... of 16 keys, its K chunks then its V chunks, through kWarpStages stages
//    of its own (16-byte cp.async copies, 4 a lane, at a 144-byte row pitch; each lane's copies
//    arrive on the stage's mbarrier), so its first V chunks are in flight while the max runs;
//    no block-wide barrier inside the streams. One 128-byte cp.async.bulk a row instead took
//    0.038 ms a serving launch against these copies' 0.032, in one run (PERF.md §6). The
//    scales and validity of the CTA's keys are read into shared memory (plain loads issued
//    after the first chunks) and used only after the K stream.
//  * No int -> float conversion: on sm_90 it runs at a quarter rate, 16 a clock per SM, and a
//    launch has 63 M codes. A code c becomes the fp16 value c exactly by a byte permute that
//    puts c ^ 0x80 (= c + 128) under the exponent of 1024 (0x64XX = 1024 + (c + 128)) and a
//    half2 subtraction of 1152: five instructions per four codes, none of them a conversion
//    (one XOR, two permutes, two subtractions). fp16 and not bf16 because bf16's 7 stored
//    significand bits cannot hold the 8-bit c + 128.
//  * q · k: S^T = K · q' by mma.sync m16n8k16 in fp16 (K from ldmatrix: 16 dims a k step, a
//    thread's 4-byte word 4t4..4t4+3 standing for the fragment's k = 2t4, 2t4 + 1, 2t4 + 8,
//    2t4 + 9, and q' in the same order), exact products summed in fp32. q' = fp32(q) · scale,
//    scaled per head by a power of two 2^E (max |q' 2^E| in [2^14, 2^15)) so that its three
//    fp16 terms hold it to 2^-39 of that max, rides in B's columns (head r, term t in column
//    3r + t); the terms are made once a CTA, a thread a head dim, into shared memory. The key's
//    dot is the sum of its head's three columns, times 2^-E, times its scale ks (factored out
//    of the dot).
//  * P · V: out^T = V^T · (p · vs)^T: V's codes by ldmatrix.trans (16-bit elements: a thread
//    gets dims 2g, 2g + 1 of keys 2t4, 2t4 + 1, split by byte permutes into the two rows of its
//    fragment); p = exp(s - m) against the joint max and p · vs in fp32, scaled by the CTA's
//    power of two, as three fp16 terms made once a key into shared memory (a thread a key,
//    after the max), B's columns read from there. The warps' partial sums are added in warp
//    order, each head's term columns in order; l = Σ p by thread, then warps in order.
//  * Cluster (cs > 1): each head's max over the CTA's keys goes to a slot every CTA reads after
//    a cluster barrier, so all CTAs form p against the joint max; rank 0 adds the CTAs' P · V
//    and sums in rank order.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace ovla_sdr {

namespace cg = cooperative_groups;
using ovla_dec::ceil_div;
using ovla_dec::keys_per_cta;
using ovla_dec::kRows;
using ovla_dec::kThreads;
using ovla_dec::kWarps;

constexpr int kDh = 128;                       // the head dim of the ring route
constexpr int kRowBytes = kDh;                 // one int8 row of K or V
constexpr int kPitch = kRowBytes + 16;         // its pitch in a stage: 9 16-byte units, so the
                                               // 8 rows an ldmatrix reads hit distinct banks
constexpr int kWarpStages = 2;                 // each warp's ring depth (3: no faster)
constexpr int kStages = kWarps * kWarpStages;
constexpr int kStageBytes = kRows * kPitch;
constexpr int kRingMaxKeys = 1024;
constexpr float kNegInf = -2.3819763e38f;      // the JAX kernel's finite NEG_INF
static_assert(kThreads == kDh, "a thread per head dim at the combine");

struct Args {
  const __nv_bfloat16* q;   // [B, 1, H, Dh]
  const int8_t* kq;         // one layer: [B, S, Hkv * Dh]
  const float* ks;          // [B, S, Hkv]
  const int8_t* vq;
  const float* vs;
  const int32_t* valid;     // [B, S]
  __nv_bfloat16* out;       // [B, 1, H, Dh]
  int B, H, Hkv, S;
  int n;                    // keys [0, n) are read; keys past n count as masked
  float scale;
  int cs;                   // CTAs a (b, kv head): the cluster size
};

// two codes (bytes `sel` of w ^ 0x80808080) as an exact fp16 pair: 0x64XX is 1024 + XX
__device__ __forceinline__ uint32_t codes_h2(uint32_t wx, uint32_t sel) {
  const uint32_t h = __byte_perm(wx, 0x64646464u, sel);
  const __half2 v =
      __hsub2(*reinterpret_cast<const __half2*>(&h), __half2half2(__ushort_as_half(0x6480)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^E (and 2^-E in `inv`) with mx · 2^E in [2^14, 2^15) for a normal mx > 0, else 1
__device__ __forceinline__ float pow2_for(float mx, float& inv) {
  const int e = int((__float_as_uint(mx) >> 23) & 0xff) - 127;   // floor(log2 mx)
  int E = (mx > 0.f && e > -127) ? 14 - e : 0;
  E = max(-113, min(100, E));
  inv = __uint_as_float(uint32_t(127 - E) << 23);
  return __uint_as_float(uint32_t(127 + E) << 23);
}

// term `t` of x as a sum of three fp16: exact where x's last place is at least 2^-24 (fp16's
// least subnormal), which holds for |x| >= 0.5
__device__ __forceinline__ __half h_term(float x, int t) {
  const __half t0 = __float2half_rn(x);
  const float r = x - __half2float(t0);
  const __half t1 = __float2half_rn(r);
  const __half t2 = __float2half_rn(r - __half2float(t1));
  return t == 0 ? t0 : t == 1 ? t1 : t2;
}

// d (16 x 8 fp32) += a (16 x 16 fp16, row-major fragment) . b (16 x 8 fp16, column fragment)
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the ring's bytes, or the warps' partial P·V after it ([kWarps][8 NT][kDh] floats)
__host__ __device__ constexpr size_t union_bytes(int nt) {
  return size_t(kStages) * kStageBytes > size_t(kWarps) * 8 * nt * kDh * 4
             ? size_t(kStages) * kStageBytes
             : size_t(kWarps) * 8 * nt * kDh * 4;
}

// bytes of dynamic shared memory a CTA takes: the ring (or the partial P·V), its barriers, the
// CTA's scales, scores, reduction slots, cluster slots and output vectors, the fp16 terms of q'
// and of p·vs, its validity bytes
inline size_t smem_bytes(int n, int cs, int nrep) {
  const int per = keys_per_cta(n, cs), nt = (3 * nrep + 7) / 8;
  return union_bytes(nt) + kStages * sizeof(uint64_t) +
         sizeof(float) * (size_t(2 + nrep) * per + kWarps * (2 * nrep + 1) + 2 * nrep +
                          nrep * kDh) +
         sizeof(__half) * 3 * nrep * (size_t(kDh) + per) + per;
}

template <int NREP>
__global__ void __launch_bounds__(kThreads, NREP <= 2 ? ovla_dec::kMinBlocksPerSm : 1)
    stacked_ring_kernel(Args a) {
  constexpr int NT = (3 * NREP + 7) / 8;      // n8 tiles of (head, term) columns
  extern __shared__ __align__(128) unsigned char smem[];
  const int cs = a.cs;
  const int kvh = blockIdx.x / cs, rank = blockIdx.x % cs, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;        // mma fragment row / column pair
  const int per = keys_per_cta(a.n, cs);
  const int k0 = min(a.n, rank * per), k1 = min(a.n, k0 + per), n = k1 - k0;
  const int nch = ceil_div(n, kRows);
  // this warp's chunks: keys [16 j, 16 j + 16) of the CTA for j = warp, warp + 4, ...; its K
  // chunks, then its V chunks, through its own stages
  const int nk = nch > warp ? ceil_div(nch - warp, kWarps) : 0, total = 2 * nk;

  unsigned char* ring = smem;                                     // [kWarps][kWarpStages][..]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + union_bytes(NT));   // [kStages]
  float* ks_sm = reinterpret_cast<float*>(full + kStages);        // [per]
  float* vs_sm = ks_sm + per;                                     // [per]
  float* s_sm = vs_sm + per;                                      // [NREP][per]: dots, scores
  float* red = s_sm + NREP * per;                                 // [kWarps][NREP + 1]
  float* lw = red + kWarps * (NREP + 1);                          // [kWarps][NREP]
  float* xm = lw + kWarps * NREP;                                 // [NREP]: cluster maxima
  float* xl = xm + NREP;                                          // [NREP]: cluster sums
  float* cta_o = xl + NREP;                                       // [NREP][kDh]
  __half* qh = reinterpret_cast<__half*>(cta_o + NREP * kDh);     // [3 NREP][kDh]: q' terms
  __half* ph = qh + 3 * NREP * kDh;                               // [3 NREP][per]: p·vs terms
  int8_t* ok_sm = reinterpret_cast<int8_t*>(ph + 3 * NREP * per); // [per]
  unsigned char* my_ring = ring + warp * kWarpStages * kStageBytes;
  uint64_t* my_full = full + warp * kWarpStages;

  const long long rowb = (long long)a.Hkv * kDh;                  // bytes a slot
  const int8_t* kb = a.kq + (long long)b * a.S * rowb + kvh * kDh;
  const int8_t* vb = a.vq + (long long)b * a.S * rowb + kvh * kDh;

  if (lane == 0) {
    for (int i = 0; i < kWarpStages; ++i) ovla_hp::mbar_init(&my_full[i], 32);
    ovla_hp::mbar_init_fence();
  }
  __syncwarp();

  // the warp's u-th chunk into its stage u % kWarpStages: 16-byte cp.async copies, lane L the
  // unit L % 8 of rows L / 8 + 4i, each lane's copies arriving on the stage's barrier (32
  // arrivals a phase). Any byte is a finite code, so the stale rows of a partial chunk need no
  // clearing: their p is 0.
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

  // the CTA's scales and validity, read while the first chunks fly; used after the K stream
  for (int i = tid; i < n; i += kThreads) {
    const long long sk = (long long)b * a.S + k0 + i;
    ks_sm[i] = a.ks[sk * a.Hkv + kvh];
    vs_sm[i] = a.vs[sk * a.Hkv + kvh];
    ok_sm[i] = a.valid[sk] > 0;
  }

  // q' = fp32(q) · scale per head, times a power of two (max |q' 2^E| in [2^14, 2^15)), as
  // three fp16 terms by head dim (thread tid: dim tid), then B's columns (head r, term t in
  // column 3r + t of tile nt): this lane's column 8 nt + g at dims 16U + 4t4 .. + 3
  float invq[NREP];
  {
    float xq[NREP], mq[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      xq[r] = __fmul_rn(__bfloat162float(a.q[((long long)b * a.H + kvh * NREP + r) * kDh + tid]),
                        a.scale);
      mq[r] = fabsf(xq[r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mq[r] = fmaxf(mq[r], __shfl_xor_sync(0xffffffffu, mq[r], o));
    }
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < NREP; ++r) red[warp * (NREP + 1) + r] = mq[r];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float mx = red[r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red[w * (NREP + 1) + r]);
      const float p2 = pow2_for(mx, invq[r]);
#pragma unroll
      for (int t = 0; t < 3; ++t) qh[(3 * r + t) * kDh + tid] = h_term(xq[r] * p2, t);
    }
    __syncthreads();   // the terms are in; `red` is free again
  }
  uint32_t qb[NT][8][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + g;
#pragma unroll
    for (int U = 0; U < 8; ++U) {
      const __half* qc = qh + c * kDh + 16 * U + 4 * t4;
      qb[nt][U][0] = c < 3 * NREP ? *reinterpret_cast<const uint32_t*>(qc) : 0u;
      qb[nt][U][1] = c < 3 * NREP ? *reinterpret_cast<const uint32_t*>(qc + 2) : 0u;
    }
  }

  // q · k: a warp's chunk is one 16-key tile; each head's dot is the sum of its term columns
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
    float c[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int U = 0; U < 8; ++U) {
      const uint32_t x0 = w[U][0] ^ 0x80808080u, x1 = w[U][1] ^ 0x80808080u;
      const uint32_t af[4] = {codes_h2(x0, 0x4140), codes_h2(x1, 0x4140), codes_h2(x0, 0x4342),
                              codes_h2(x1, 0x4342)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_f16(c[nt], af, qb[nt][U][0], qb[nt][U][1]);
    }
    const int key = (warp + kWarps * u) * kRows + g;
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float lo = 0.f, hi = 0.f;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int col = 3 * r + t, nt = col / 8, src = (lane & ~3) | ((col % 8) / 2);
        lo += __shfl_sync(0xffffffffu, c[nt][col % 2], src);
        hi += __shfl_sync(0xffffffffu, c[nt][2 + col % 2], src);
      }
      if (t4 == r % 4) {
        if (key < n) s_sm[r * per + key] = lo * invq[r];
        if (key + 8 < n) s_sm[r * per + key + 8] = hi * invq[r];
      }
    }
  }
  __syncthreads();

  // the scores (the key's scale, the mask), each head's max over the CTA's keys, and the
  // CTA's largest V scale
  float m[NREP], vmax = 0.f;
#pragma unroll
  for (int r = 0; r < NREP; ++r) m[r] = -INFINITY;   // a CTA may own no key
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = ok_sm[i];
    const float sk = ks_sm[i];
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      const float s = ok ? s_sm[r * per + i] * sk : kNegInf;
      s_sm[r * per + i] = s;
      m[r] = fmaxf(m[r], s);
    }
    vmax = fmaxf(vmax, vs_sm[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) red[warp * (NREP + 1) + r] = m[r];
    red[warp * (NREP + 1) + NREP] = vmax;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m[r] = red[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m[r] = fmaxf(m[r], red[w * (NREP + 1) + r]);
  }
  vmax = red[NREP];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) vmax = fmaxf(vmax, red[w * (NREP + 1) + NREP]);
  if (cs > 1) {   // the joint max over the cluster's keys
    cg::cluster_group cluster = cg::this_cluster();
    if (tid < NREP) xm[tid] = m[tid];
    cluster.sync();
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      m[r] = -INFINITY;
      for (int i = 0; i < cs; ++i) m[r] = fmaxf(m[r], cluster.map_shared_rank(xm, i)[r]);
    }
  }
  // a row with no valid key among the n holds only masked scores, so p = 1 at every key of
  // [0, S): the ring's, and the rest read after it
  const bool masked_row = !(m[0] > kNegInf);
  float invv;
  const float p2v = pow2_for(vmax, invv);

  // p = exp(s - m) against the joint max, and p·vs · 2^Ev as three fp16 terms, by key (keys past
  // n up to the last chunk's end 0); l = Σp by thread, then warps in order at the end
  float lsum[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) lsum[r] = 0.f;
  for (int i = tid; i < nch * kRows; i += kThreads) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float x = 0.f;
      if (i < n) {
        const float p = expf(s_sm[r * per + i] - m[r]);
        lsum[r] += p;
        x = __fmul_rn(p, vs_sm[i]) * p2v;
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) ph[(3 * r + t) * per + i] = h_term(x, t);
    }
  }
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], o);
    if (lane == 0) lw[warp * NREP + r] = lsum[r];
  }
  __syncthreads();

  // P·V: out^T = V^T · (p vs 2^Ev)^T; this lane's columns 8 nt + g: head r = c / 3, term c % 3
  float acc[8][NT][4];
#pragma unroll
  for (int U = 0; U < 8; ++U)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[U][nt][0] = acc[U][nt][1] = acc[U][nt][2] = acc[U][nt][3] = 0.f;
  for (int u = nk; u < total; ++u) {
    const int kbase = (warp + kWarps * (u - nk)) * kRows;   // the chunk's first key
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = nt * 8 + g;
      const __half* pc = ph + c * per + kbase + 2 * t4;
      pb[nt][0] = c < 3 * NREP ? *reinterpret_cast<const uint32_t*>(pc) : 0u;
      pb[nt][1] = c < 3 * NREP ? *reinterpret_cast<const uint32_t*>(pc + 8) : 0u;
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
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_f16(acc[2 * p + h][nt], af, pb[nt][0], pb[nt][1]);
      }
    }
    __syncwarp();
    if (u + kWarpStages < total) issue(u + kWarpStages);
  }

  __syncthreads();   // every warp is done with the ring: the partial P·V takes its place
  float* part = reinterpret_cast<float*>(ring);   // [kWarps][8 NT][kDh]
#pragma unroll
  for (int U = 0; U < 8; ++U)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* pc = part + (warp * 8 * NT + nt * 8 + 2 * t4) * kDh + 16 * U + 2 * g;
      pc[0] = acc[U][nt][0];
      pc[kDh] = acc[U][nt][1];
      pc[1] = acc[U][nt][2];
      pc[kDh + 1] = acc[U][nt][3];
    }
  __syncthreads();
  // thread tid owns head dim tid of every head: the warps' partials, each head's terms in order
  float o[NREP], l[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    float s = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = part + w * 8 * NT * kDh;
      s += (pw[(3 * r) * kDh + tid] + pw[(3 * r + 1) * kDh + tid]) + pw[(3 * r + 2) * kDh + tid];
      ls += lw[w * NREP + r];
    }
    o[r] = s * invv;
    l[r] = ls;
  }
  if (masked_row) {
    // the keys past the ring's, p = 1 each, a CTA's share in order
    float tail = 0.f;
    const int8_t* V = vb + tid;
    const float* vsb = a.vs + (long long)b * a.S * a.Hkv + kvh;
    for (int c = a.n + rank; c < a.S; c += cs)
      tail += __fmul_rn(float(V[c * rowb]), vsb[(long long)c * a.Hkv]);
#pragma unroll
    for (int r = 0; r < NREP; ++r) o[r] += tail;
  }

  __nv_bfloat16* out = a.out + ((long long)b * a.H + kvh * NREP) * kDh + tid;
  if (cs == 1) {
#pragma unroll
    for (int r = 0; r < NREP; ++r)
      out[r * kDh] = __float2bfloat16(o[r] / fmaxf(masked_row ? float(a.S) : l[r], 1e-30f));
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int r = 0; r < NREP; ++r) cta_o[r * kDh + tid] = o[r];
  if (tid < NREP) xl[tid] = l[tid];
  cluster.sync();
  if (rank == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      float tsum = 0.f, lt = 0.f;
      for (int i = 0; i < cs; ++i) {
        tsum += cluster.map_shared_rank(cta_o, i)[r * kDh + tid];
        lt += cluster.map_shared_rank(xl, i)[r];
      }
      out[r * kDh] = __float2bfloat16(tsum / fmaxf(masked_row ? float(a.S) : lt, 1e-30f));
    }
  }
  cluster.sync();   // every CTA's shared memory stays until rank 0 has read it
}

template <int NREP>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = stacked_ring_kernel<NREP>;
  const size_t smem = smem_bytes(a.n, a.cs, NREP);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
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
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace ovla_sdr

namespace ovla_sd {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr float kNegInf = -2.3819763e38f;   // the JAX kernel's finite NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// block-wide max (MAX) or sum of one value per thread; every thread gets the result
template <bool MAX>
__device__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = MAX ? fmaxf(v, scratch[w]) : v + scratch[w];
  __syncthreads();   // scratch is reused by the next reduction
  return v;
}

template <typename T, int DH, int NREP>
__global__ void __launch_bounds__(kThreads)
    stacked_decode_i8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                             const float* __restrict__ ks, const int8_t* __restrict__ vq,
                             const float* __restrict__ vs, const int* __restrict__ valid,
                             T* __restrict__ out, int H, int Hkv, int S, int n, float scale) {
  constexpr int LPS = DH / 4, SPW = 32 / LPS;   // lanes per slot, slots per warp pass
  extern __shared__ float sd_smem[];
  float* sc = sd_smem;                          // [NREP][S] scores, then probabilities
  float* part = sc + NREP * S;                  // [kWarps][NREP][DH] partial P·V
  float* scratch = part + kWarps * NREP * DH;   // [kWarps]
  float* lsum = scratch + kWarps;               // [NREP]
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPS, d0 = 4 * (lane % LPS);
  const long long row = (long long)Hkv * DH;    // bytes per slot of the flat cache
  const int8_t* kb = kq + (long long)b * S * row + kvh * DH + d0;
  const int8_t* vb = vq + (long long)b * S * row + kvh * DH + d0;
  const float* ksb = ks + (long long)b * S * Hkv + kvh;
  const float* vsb = vs + (long long)b * S * Hkv + kvh;
  const int* ok = valid + (long long)b * S;

  float qv[NREP][4];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    const T* qh = q + ((long long)b * H + kvh * NREP + r) * DH + d0;
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[r][i] = __fmul_rn(to_f32(qh[i]), scale);
  }

  // scores: slot s = s0 + sub, its Dh codes over LPS lanes
#pragma unroll 4
  for (int s0 = warp * SPW; s0 < S; s0 += kWarps * SPW) {
    const int s = s0 + sub;
    float dot[NREP];
#pragma unroll
    for (int r = 0; r < NREP; ++r) dot[r] = 0.f;
    if (s < S) {
      const char4 c = *reinterpret_cast<const char4*>(kb + s * row);
      const float sk = ksb[(long long)s * Hkv];
      const float kf[4] = {__fmul_rn(float(c.x), sk), __fmul_rn(float(c.y), sk),
                           __fmul_rn(float(c.z), sk), __fmul_rn(float(c.w), sk)};
#pragma unroll
      for (int r = 0; r < NREP; ++r)
        dot[r] = qv[r][0] * kf[0] + qv[r][1] * kf[1] + qv[r][2] * kf[2] + qv[r][3] * kf[3];
    }
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int o = LPS / 2; o > 0; o >>= 1) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
    if (s < S && lane % LPS == 0) {
      const bool attend = ok[s] > 0 && s < n;
#pragma unroll
      for (int r = 0; r < NREP; ++r) sc[r * S + s] = attend ? dot[r] : kNegInf;
    }
  }
  __syncthreads();

  // one softmax per query head: probabilities over the scores in place
  for (int r = 0; r < NREP; ++r) {
    float m = -INFINITY;
    for (int s = threadIdx.x; s < S; s += kThreads) m = fmaxf(m, sc[r * S + s]);
    m = block_reduce<true>(m, scratch);
    float l = 0.f;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      const float e = expf(sc[r * S + s] - m);
      sc[r * S + s] = e;
      l += e;
    }
    l = block_reduce<false>(l, scratch);   // its barriers also publish the probabilities
    if (threadIdx.x == 0) lsum[r] = l;
  }

  // P·V: each lane accumulates its 4 dims over its slots
  float pv[NREP][4];
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[r][i] = 0.f;
#pragma unroll 4
  for (int s0 = warp * SPW; s0 < S; s0 += kWarps * SPW) {
    const int s = s0 + sub;
    if (s < S) {
      const char4 c = *reinterpret_cast<const char4*>(vb + s * row);
      const float sv = vsb[(long long)s * Hkv];
      const float vf[4] = {__fmul_rn(float(c.x), sv), __fmul_rn(float(c.y), sv),
                           __fmul_rn(float(c.z), sv), __fmul_rn(float(c.w), sv)};
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
        const float p = sc[r * S + s];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[r][i] += p * vf[i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int o = LPS; o < 32; o <<= 1) pv[r][i] += __shfl_xor_sync(0xffffffffu, pv[r][i], o);
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[(warp * NREP + r) * DH + d0 + i] = pv[r][i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NREP * DH; t += kThreads) {
    const int r = t / DH, d = t % DH;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += part[(w * NREP + r) * DH + d];
    out[((long long)b * H + kvh * NREP + r) * DH + d] =
        from_f32<T>(__fdiv_rn(v, fmaxf(lsum[r], 1e-30f)));
  }
}

inline size_t smem_bytes(int S, int dh, int nrep) {
  return sizeof(float) * (size_t(nrep) * S + size_t(kWarps) * nrep * dh + kWarps + nrep);
}

template <typename T, int DH, int NREP>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* valid, void* out, int B, int H, int Hkv, int S, int n, float scale,
           cudaStream_t stream) {
  auto kernel = stacked_decode_i8_kernel<T, DH, NREP>;
  const size_t smem = smem_bytes(S, DH, NREP);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
      static_cast<const int*>(valid), static_cast<T*>(out), H, Hkv, S, n, scale);
  return int(cudaGetLastError());
}

template <typename T, int DH>
int launch_rep(int nrep, const void* q, const void* kq, const void* ks, const void* vq,
               const void* vs, const void* valid, void* out, int B, int H, int Hkv, int S,
               int n, float scale, cudaStream_t st) {
  switch (nrep) {
    case 1: return launch<T, DH, 1>(q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, n, scale, st);
    case 2: return launch<T, DH, 2>(q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, n, scale, st);
    case 4: return launch<T, DH, 4>(q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, n, scale, st);
    case 8: return launch<T, DH, 8>(q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, n, scale, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_dh(int dh, int nrep, const void* q, const void* kq, const void* ks, const void* vq,
              const void* vs, const void* valid, void* out, int B, int H, int Hkv, int S, int n,
              float scale, cudaStream_t st) {
  switch (dh) {
    case 16: return launch_rep<T, 16>(nrep, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, n, scale, st);
    case 32: return launch_rep<T, 32>(nrep, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, n, scale, st);
    case 64: return launch_rep<T, 64>(nrep, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, n, scale, st);
    case 128: return launch_rep<T, 128>(nrep, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, n, scale, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace ovla_sd

// The ring route: bf16 q at Dh = 128, H / Hkv in {1, 2, 4, 8}, 1 <= n <= S <= kRingMaxKeys, the
// cache pointers 16-byte aligned; anything else is refused (cudaErrorInvalidValue) before a
// launch. Returns the launch's cudaError_t (0 on success). q [B, 1, H, 128] and out bf16; one
// layer's kq / vq int8 [B, S, Hkv · 128] and ks / vs fp32 [B, S, Hkv]; valid int32 [B, S]; all
// contiguous. `cs` CTAs a (b, kv head): 1, 2 or 4, or 0 for cluster_size's rule.
extern "C" int ovla_stacked_decode_i8_cs(const void* q, const void* kq, const void* ks,
                                         const void* vq, const void* vs, const void* valid,
                                         void* out, int B, int H, int Hkv, int S, int Dh, int n,
                                         float scale, int is_bf16, int cs, void* stream) {
  const int nrep = Hkv > 0 ? H / Hkv : 0;
  if (!is_bf16 || Dh != ovla_sdr::kDh || B < 1 || Hkv < 1 || H % Hkv != 0 ||
      (nrep != 1 && nrep != 2 && nrep != 4 && nrep != 8) || n < 1 || n > S ||
      S > ovla_sdr::kRingMaxKeys || reinterpret_cast<uintptr_t>(kq) % 16 ||
      reinterpret_cast<uintptr_t>(vq) % 16)
    return int(cudaErrorInvalidValue);
  cs = cs ? cs : ovla_dec::cluster_size(B * Hkv);
  if (cs != 1 && cs != 2 && cs != 4) return int(cudaErrorInvalidValue);
  const ovla_sdr::Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
                         static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
                         static_cast<const float*>(vs), static_cast<const int32_t*>(valid),
                         static_cast<__nv_bfloat16*>(out), B, H, Hkv, S, n, scale, cs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nrep) {
    case 1: return ovla_sdr::launch<1>(a, st);
    case 2: return ovla_sdr::launch<2>(a, st);
    case 4: return ovla_sdr::launch<4>(a, st);
    default: return ovla_sdr::launch<8>(a, st);
  }
}

// The ring route at cluster_size's rule. The signature is the scalar route's.
extern "C" int ovla_stacked_decode_i8(const void* q, const void* kq, const void* ks,
                                      const void* vq, const void* vs, const void* valid,
                                      void* out, int B, int H, int Hkv, int S, int Dh, int n,
                                      float scale, int is_bf16, void* stream) {
  return ovla_stacked_decode_i8_cs(q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, Dh, n, scale,
                                   is_bf16, 0, stream);
}

// The scalar route. Returns the launch's cudaError_t (0 on success). q [B, 1, H, Dh] and out in
// q's type (bf16 or fp32); one layer's kq / vq int8 [B, S, Hkv · Dh] and ks / vs fp32
// [B, S, Hkv]; valid int32 [B, S]; all contiguous. Dh in {16, 32, 64, 128}, H / Hkv in
// {1, 2, 4, 8}; keys at or past n count as masked.
extern "C" int ovla_stacked_decode_i8_scalar(const void* q, const void* kq, const void* ks,
                                             const void* vq, const void* vs, const void* valid,
                                             void* out, int B, int H, int Hkv, int S, int Dh,
                                             int n, float scale, int is_bf16, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 ||
      ovla_sd::smem_bytes(S, Dh, H / Hkv) > 200 * 1024)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ovla_sd::launch_dh<__nv_bfloat16>(Dh, H / Hkv, q, kq, ks, vq, vs, valid, out, B, H,
                                             Hkv, S, n, scale, st);
  return ovla_sd::launch_dh<float>(Dh, H / Hkv, q, kq, ks, vq, vs, valid, out, B, H, Hkv, S, n,
                                   scale, st);
}
