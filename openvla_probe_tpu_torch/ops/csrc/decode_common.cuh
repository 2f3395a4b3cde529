// The ring route of the two decode attentions (decode_split_attention.cu, decode_attention.cu):
// one bf16 query per (batch, head) at Dh = 128 over S keys, K and V streamed by bulk copies
// through each warp's ring of shared-memory stages, q.k and P.V on the tensor cores, the keys
// of a (b, h) split across a thread block cluster whose CTAs share the exact joint max and sum
// through distributed shared memory.
//
// What bounds it on the H100: bytes. At the OpenVLA-7B serving shape (q [24, 1, 32, 128],
// 295 keys) a launch reads 116 MB of K/V (35 us at 3.35 TB/s) against 58 MFLOP. Streaming
// at that rate against ~1-2 us of loaded latency needs ~25-50 KB in flight per SM, asked
// for early: the kernels these replace kept one 256-byte row in flight per warp (load,
// reduce, store the score, then the next row) and asked for no V byte before the softmax.
//
// Design.
//  * Grid (H * cs, B), cs CTAs (one cluster) per (b, h), 128 threads (4 warps) a CTA. The ring
//    reads keys [0, n): n = S for the split decode, n = min(S, offset + 1) for decode_attention,
//    whose keys past the query's position are masked. CTA `rank` owns keys [rank * per,
//    min(n, (rank + 1) * per)), per = ceil(n / cs) rounded up to 16 keys. Keys [0, n0) are
//    rows of segment 0, keys [n0, S) of segment 1 (the frozen prefill and the generated tokens
//    of the split decode; decode_attention has one segment), so a chunk may straddle the
//    boundary: each row is its own copy. A decode_attention row with no valid key among the n
//    is masked everywhere, so p = 1 at each of its S keys (the plain version's mean of V): the
//    keys past n are then read after the ring, plainly (no main path sends such a row).
//  * Chunks of 16 keys: warp w owns chunks w, w + 4, ... of its CTA, its K chunks then its V
//    chunks through its own kWarpStages stages (a full mbarrier each). Its lanes issue one
//    cp.async.bulk of 256 bytes per row, at a pitch of 272 bytes (conflict-free ldmatrix);
//    after reading a stage the warp refills it with its chunk kWarpStages ahead, so its first
//    V chunks are in flight while the max, the sums and the cluster exchanges run. No
//    block-wide sync inside the streams.
//  * q.k: S^T = K . q by mma.sync m16n8k16 (K the row-major A from ldmatrix, q the B operand
//    in registers), exact bf16 products summed in fp32; P.V: out^T = V^T . P^T (V by
//    ldmatrix.trans). An fp32 operand rides as three bf16 terms in B's columns, exact to
//    2^-100: the split decode's q' = fp32(q) * scale and its unrounded p; decode_attention's
//    bf16 q and bf16 P take one column. A key's dot or a head dim's sum adds its term columns
//    in order; the warps' P.V add in warp order.
//  * Cluster (cs > 1): each CTA's max, then (decode_attention, whose P is rounded after the
//    division) its sum, go to a slot every CTA of the cluster reads (map_shared_rank) after a
//    cluster barrier, so every CTA holds the same joint m and l before it forms p; the partial
//    P.V vectors (and, for the split decode, the sums) are added by rank 0 in rank order, and a
//    last barrier keeps every CTA's shared memory alive until rank 0 has read it. Rescaling
//    per-CTA softmaxes at the combine (flash decoding) would compute another function.
//  * The cluster size (`cluster_size`): the fewest of 1, 2 and 4 CTAs a (b, h) that set at
//    least 7/8 of the SMs to work. Serving (24 x 32 = 768 pairs on 132 SMs, 6 CTAs an SM at
//    ~37 KB of shared memory each: one wave) and generate at 8 rows (256 pairs) take one CTA
//    a (b, h); 1, 2, 4 rows take 4, 2, 1. One row is what generate_text and a one-observation
//    predict_action send (generate_greedy_batch pads to 8 rows); chip_smoke.py times the rule
//    against one CTA a (b, h) there (the `_cs` launchers). PERF.md §6 has the times of each
//    size at each shape: a cluster at serving takes two waves.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace ovla_dec {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDh = 128;                       // the head dim of the ring route
constexpr int kRowBytes = kDh * 2;             // one bf16 row of K or V
constexpr int kPitch = kRowBytes + 16;         // its pitch in a stage: conflict-free ldmatrix
constexpr int kRows = 16;                      // rows a stage: one mma tile of keys
constexpr int kWarpStages = 2;                 // each warp's ring depth
constexpr int kStages = kWarps * kWarpStages;
constexpr int kStageBytes = kRows * kPitch;
constexpr int kMaxKeys = 4096;
constexpr int kMinBlocksPerSm = 6;             // the serving decode's 768 CTAs in one wave
constexpr float kNegInf = -2.3819763e38f;
static_assert(kThreads == kDh, "a thread per head dim at the combine");

enum Mode { kSplit = 0, kFp32Scores = 1, kBf16Scores = 2 };

struct RingArgs {
  const void* q;              // [B, 1, H, Dh], batch stride q_sb
  const void* k0;             // segment 0: [B, n0, H, Dh]
  const void* v0;
  const void* k1;             // segment 1: [B, S - n0, H, Dh] (unused where n0 = S)
  const void* v1;
  const int32_t* valid0;      // [B, n0]
  const int32_t* valid1;      // [B, S - n0]
  void* o;                    // contiguous [B, 1, H, Dh]
  int B, H, n0, S;
  long long q_sb, k0_sb, k0_st, v0_sb, v0_st, k1_sb, k1_st, v1_sb, v1_st;   // elements
  float scale;
  int offset;                 // decode_attention: the query's position (keys c > offset masked)
  int cs;                     // CTAs a (b, h): the cluster size
  int keys;                   // the ring's keys [0, keys): S, or decode_attention's
                              // min(S, offset + 1) (`ring_keys`)
};

// the keys the ring reads: decode_attention's keys past the query's position only count in a
// row that has no valid key before it
inline int ring_keys(int S, int offset, bool causal) {
  return causal ? (offset < 0 ? 0 : offset < S ? offset + 1 : S) : S;
}

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// keys a CTA owns: ceil(S / cs) rounded up to whole stages
__host__ __device__ constexpr int keys_per_cta(int S, int cs) {
  return ceil_div(ceil_div(S, cs), kRows) * kRows;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) | (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

// term `t` of x as a sum of three bf16: x == (t0 + t1) + t2 exactly for |x| >= 2^-100 (8 + 8
// + 8 significand bits; below, t2 leaves bf16's normal range); terms past 2 are 0
__device__ __forceinline__ __nv_bfloat16 bf16_term(float x, int t) {
  const __nv_bfloat16 t0 = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(t0);
  const __nv_bfloat16 t1 = __float2bfloat16_rn(r);
  const __nv_bfloat16 t2 = __float2bfloat16_rn(r - __bfloat162float(t1));
  return t == 0 ? t0 : t == 1 ? t1 : t == 2 ? t2 : __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p, bool trans) {
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(ovla_hp::smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(ovla_hp::smem_u32(p)));
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row-major fragment) . b (16 x 8 bf16, column fragment)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 codes (bytes `sel` of w ^ 0x80808080) as an exact fp16 pair: the byte permute puts
// c + 128 under the exponent of 1024 (0x64XX is 1024 + XX), the half2 subtraction takes 1152
// (stacked_decode_i8.cu, split_attention_i8.cu)
__device__ __forceinline__ uint32_t codes_h2(uint32_t wx, uint32_t sel) {
  const uint32_t h = __byte_perm(wx, 0x64646464u, sel);
  const __half2 v =
      __hsub2(*reinterpret_cast<const __half2*>(&h), __half2half2(__ushort_as_half(0x6480)));
  return *reinterpret_cast<const uint32_t*>(&v);
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

// max or sum over the block's 128 threads, the warps added in order; `red` reused after
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, w);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = kMax ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();
  return r;
}

// the max or the sum of every CTA's `x` in the cluster, in rank order (the same value in
// every CTA); `slot` is a shared float no other exchange uses
template <bool kMax>
__device__ __forceinline__ float cluster_reduce(float x, float* slot, int cs) {
  if (cs == 1) return x;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = x;
  cluster.sync();
  float r = kMax ? -INFINITY : 0.f;
  for (int i = 0; i < cs; ++i) {
    const float y = *cluster.map_shared_rank(slot, i);
    r = kMax ? fmaxf(r, y) : r + y;
  }
  return r;
}

// bytes of dynamic shared memory a CTA takes: the ring, its barriers, the combine's vector,
// the reductions' slots, the CTA's scores
inline size_t ring_smem_bytes(int keys, int cs) {
  return size_t(kStages) * kStageBytes + kStages * sizeof(uint64_t) +
         sizeof(float) * (kDh + kWarps + 4 + keys_per_cta(keys, cs));
}

template <int kMode>
__device__ __forceinline__ void ring_decode(const RingArgs& a) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;                        // [kWarps][kWarpStages][kRows][kPitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);   // [kStages]
  float* cta_part = reinterpret_cast<float*>(full + kStages);  // [kDh]: this CTA's P.V
  float* red = cta_part + kDh;                                 // [kWarps]
  float* xch = red + kWarps;                                   // [4]: cluster slots
  float* s_sm = xch + 4;                                       // the CTA's scores, then p

  const int cs = a.cs;
  const int h = blockIdx.x / cs, rank = blockIdx.x % cs, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;                       // mma fragment row / column pair
  const int per = keys_per_cta(a.keys, cs);
  const int k0 = min(a.keys, rank * per), k1 = min(a.keys, k0 + per), n = k1 - k0;
  const int nch = ceil_div(n, kRows);
  // this warp's chunks: keys [16 j, 16 j + 16) of the CTA for j = warp, warp + 4, ...; its K
  // chunks, then its V chunks, through its own stages
  const int nk = nch > warp ? ceil_div(nch - warp, kWarps) : 0, total = 2 * nk;
  unsigned char* my_ring = ring + warp * kWarpStages * kStageBytes;
  uint64_t* my_full = full + warp * kWarpStages;

  // stale rows of a partial chunk must be finite (a 0 probability times them is 0)
  for (int i = lane; i < kWarpStages * kStageBytes / 16; i += 32)
    reinterpret_cast<uint4*>(my_ring)[i] = make_uint4(0, 0, 0, 0);
  ovla_hp::fence_proxy_async();
  if (lane == 0) {
    for (int i = 0; i < kWarpStages; ++i) ovla_hp::mbar_init(&my_full[i], 1);
    ovla_hp::mbar_init_fence();
  }
  __syncwarp();

  // the warp's u-th chunk into its stage u % kWarpStages, a row a lane
  auto issue = [&](int u) {
    const bool is_v = u >= nk;
    const int j = warp + kWarps * (is_v ? u - nk : u);
    const int r0 = k0 + j * kRows;
    const int rows = min(kRows, k1 - r0);
    uint64_t* bar = &my_full[u % kWarpStages];
    if (lane == 0) ovla_hp::mbar_expect_tx(bar, rows * kRowBytes);
    __syncwarp();
    if (lane < rows) {
      const int c = r0 + lane;
      const bool seg1 = c >= a.n0;
      const int cc = seg1 ? c - a.n0 : c;
      const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(
          is_v ? (seg1 ? a.v1 : a.v0) : (seg1 ? a.k1 : a.k0));
      const long long sb = is_v ? (seg1 ? a.v1_sb : a.v0_sb) : (seg1 ? a.k1_sb : a.k0_sb);
      const long long st = is_v ? (seg1 ? a.v1_st : a.v0_st) : (seg1 ? a.k1_st : a.k0_st);
      ovla_hp::fence_proxy_async();   // after the warp's reads of the stage (a __syncwarp)
      ovla_hp::bulk_load(my_ring + (u % kWarpStages) * kStageBytes + lane * kPitch,
                         base + b * sb + cc * st + h * kDh, kRowBytes, bar);
    }
  };
  for (int u = 0; u < min(kWarpStages, total); ++u) issue(u);

  // q as the mma's B operand, column = bf16 term: the split decode's q' = fp32(q) * scale in
  // three terms (columns 0-2), decode_attention's bf16 q as it is (column 0)
  uint32_t qb[kDh / 16][2];
  {
    const __nv_bfloat16* Q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * kDh;
#pragma unroll
    for (int ks = 0; ks < kDh / 16; ++ks) {
      __nv_bfloat16 e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16 x = Q[ks * 16 + 2 * t4 + (i & 1) + 8 * (i >> 1)];
        e[i] = kMode == kSplit ? bf16_term(__bfloat162float(x) * a.scale, g)
                               : (g == 0 ? x : __float2bfloat16_rn(0.f));
      }
      qb[ks][0] = pack2(e[0], e[1]);
      qb[ks][1] = pack2(e[2], e[3]);
    }
  }

  // q . k: a warp's chunk is one 16-key tile, S^T = K . q on the tensor cores (exact bf16
  // products, fp32 sums); the key's dot is the sum of its row's term columns
  for (int u = 0; u < nk; ++u) {
    ovla_hp::mbar_wait(&my_full[u % kWarpStages], (u / kWarpStages) & 1);
    const unsigned char* stage = my_ring + (u % kWarpStages) * kStageBytes;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < kDh / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, stage + ((lane % 8) + 8 * ((lane / 8) % 2)) * kPitch + ks * 32 + 16 * (lane / 16),
              false);
      mma16816(c, af, qb[ks][0], qb[ks][1]);
    }
    __syncwarp();
    if (u + kWarpStages < total) issue(u + kWarpStages);
    const float lo = c[0] + c[1] + __shfl_down_sync(0xffffffffu, c[0], 1);   // key g
    const float hi = c[2] + c[3] + __shfl_down_sync(0xffffffffu, c[2], 1);   // key g + 8
    const int key = (warp + kWarps * u) * kRows + g;
    if (t4 == 0) {
      if (key < n) s_sm[key] = lo;
      if (key + 8 < n) s_sm[key + 8] = hi;
    }
  }
  __syncthreads();

  // the scores (mask and scale), one max over the cluster's keys, p = expf(s - m) in fp32,
  // its sum
  float m = -INFINITY;   // a CTA may own no key
  for (int i = tid; i < n; i += kThreads) {
    const int c = k0 + i;
    const float dot = s_sm[i];
    float s;
    if (kMode == kSplit) {
      const int ok = c < a.n0 ? a.valid0[(long long)b * a.n0 + c]
                              : a.valid1[(long long)b * (a.S - a.n0) + c - a.n0];
      s = ok > 0 ? dot : kNegInf;
    } else {
      const bool ok = a.valid0[(long long)b * a.S + c] > 0 && c <= a.offset;
      if (kMode == kBf16Scores)
        s = ok ? bf16_round(__fmul_rn(bf16_round(dot), a.scale)) : bf16_round(kNegInf);
      else
        s = __fadd_rn(__fmul_rn(dot, a.scale), ok ? 0.f : kNegInf);
    }
    s_sm[i] = s;
    m = fmaxf(m, s);
  }
  m = cluster_reduce<true>(block_reduce<true>(m, red), &xch[0], cs);
  // decode_attention: a row with no valid key among the ring's holds only masked scores (one
  // value, for |q.k * scale| < 2^103), so p = 1 at every key of [0, S), the ring's and the rest
  const float masked = kMode == kBf16Scores ? bf16_round(kNegInf) : kNegInf;
  const bool masked_row = kMode != kSplit && !(m > masked);
  float l = 0.f;
  for (int c = tid; c < n; c += kThreads) {
    const float e = expf(s_sm[c] - m);
    s_sm[c] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);
  if (kMode != kSplit) {
    // P = bf16(p / l) against the joint sum, before any P.V
    l = cluster_reduce<false>(l, &xch[1], cs);
    if (masked_row) l = float(a.S);
    for (int c = tid; c < n; c += kThreads) s_sm[c] = bf16_round(s_sm[c] / l);
    __syncthreads();
  }

  // P.V: out^T = V^T . P^T on the tensor cores, P's bf16 terms as B's columns (the split
  // decode's unrounded p in three terms, decode_attention's bf16 P in one); 8 tiles of 16 head
  // dims, a warp's chunk one 16-key step
  float acc[kDh / 16][4];
#pragma unroll
  for (int mt = 0; mt < kDh / 16; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  for (int u = nk; u < total; ++u) {
    const int kb = (warp + kWarps * (u - nk)) * kRows;          // the chunk's first key
    __nv_bfloat16 e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kb + 2 * t4 + (i & 1) + 8 * (i >> 1);
      const float p = key < n ? s_sm[key] : 0.f;
      e[i] = kMode == kSplit ? bf16_term(p, g)
                             : (g == 0 ? __float2bfloat16_rn(p) : __float2bfloat16_rn(0.f));
    }
    const uint32_t b0 = pack2(e[0], e[1]), b1 = pack2(e[2], e[3]);
    ovla_hp::mbar_wait(&my_full[u % kWarpStages], (u / kWarpStages) & 1);
    const unsigned char* stage = my_ring + (u % kWarpStages) * kStageBytes;
#pragma unroll
    for (int mt = 0; mt < kDh / 16; ++mt) {
      uint32_t af[4];
      ldsm_x4(af, stage + ((lane % 8) + 8 * (lane / 16)) * kPitch + mt * 32 + 16 * ((lane / 8) % 2),
              true);
      mma16816(acc[mt], af, b0, b1);
    }
    __syncwarp();
    if (u + kWarpStages < total) issue(u + kWarpStages);
  }
  // the warp's partial out (the sum of its term columns) into its own stage 0, then the warps
  // added in order, a thread a head dim
  float* part = reinterpret_cast<float*>(my_ring);
#pragma unroll
  for (int mt = 0; mt < kDh / 16; ++mt) {
    const float lo = acc[mt][0] + acc[mt][1] + __shfl_down_sync(0xffffffffu, acc[mt][0], 1);
    const float hi = acc[mt][2] + acc[mt][3] + __shfl_down_sync(0xffffffffu, acc[mt][2], 1);
    if (t4 == 0) {
      part[mt * 16 + g] = lo;
      part[mt * 16 + g + 8] = hi;
    }
  }
  __syncthreads();
  float o = 0.f;   // thread tid owns head dim tid
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    o += reinterpret_cast<const float*>(ring + w * kWarpStages * kStageBytes)[tid];
  if (masked_row) {
    // the keys past the ring's, P = bf16(1 / S) each (as the ring's), a CTA's share in order
    const float P = bf16_round(1.f / l);
    const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(a.v0) + b * a.v0_sb + h * kDh + tid;
    for (int c = a.keys + rank; c < a.S; c += cs) o += P * __bfloat162float(V[c * a.v0_st]);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + ((long long)b * a.H + h) * kDh + tid;
  if (cs == 1) {
    *out = __float2bfloat16(kMode == kSplit ? o / fmaxf(l, 1e-30f) : o);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cta_part[tid] = o;
  if (kMode == kSplit && tid == 0) xch[1] = l;
  cluster.sync();
  if (rank == 0) {
    float tsum = 0.f, lt = 0.f;
    for (int r = 0; r < cs; ++r) {
      tsum += cluster.map_shared_rank(cta_part, r)[tid];
      if (kMode == kSplit) lt += *cluster.map_shared_rank(&xch[1], r);
    }
    *out = __float2bfloat16(kMode == kSplit ? tsum / fmaxf(lt, 1e-30f) : tsum);
  }
  cluster.sync();   // every CTA's shared memory stays until rank 0 has read it
}

// the number of CTAs a (b, h): the fewest of 1, 2 and 4 that set at least 7/8 of the SMs to
// work (more CTAs than SMs only share the SMs, and clusters cost their exchanges)
inline int cluster_size(int pairs) {
  const int sms = ovla_hp::sm_count();
  for (int cs = 1; cs < 4; cs *= 2)
    if (8 * pairs * cs >= 7 * sms) return cs;
  return 4;
}

// the ring route's rule, checked by its launchers: bf16 at Dh = 128, 1 <= S <= kMaxKeys, every
// K/V base pointer and stride 16-byte aligned (bulk copies of whole rows)
inline bool ring_takes(int is_bf16, int Dh, int S, const void* const* ptrs, int nptrs,
                       const long long* strides, int nstrides) {
  if (!is_bf16 || Dh != kDh || S < 1 || S > kMaxKeys) return false;
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  for (int i = 0; i < nstrides; ++i)
    if (strides[i] % 8) return false;
  return true;
}

template <typename Kernel>
int launch_ring(Kernel kernel, const RingArgs& a, cudaStream_t stream) {
  if (a.cs != 1 && a.cs != 2 && a.cs != 4) return int(cudaErrorInvalidValue);
  const size_t smem = ring_smem_bytes(a.keys, a.cs);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H * a.cs, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace ovla_dec
