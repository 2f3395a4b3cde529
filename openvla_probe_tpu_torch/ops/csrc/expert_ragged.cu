// expert_ragged: the grouped expert product of the sparse-MoE trunk,
//   out[m, :] = cast((x[m, :] · w[e(m)]ᵀ in fp32) [· s[e(m), :]])
// for rows x [M, I] sorted by expert (rows of expert e contiguous, group_sizes[e] of them, in
// expert order) against an expert stack w [E, O, I] (bf16, or int8 codes with fp32
// per-(expert, output-channel) scales s [E, O]). Rows past the sum of the group sizes come out
// 0, as ragged_dot's.
//
// Replaces openvla_probe_tpu/models/moe.py::_expert_ragged, which is
// lax.ragged_dot_general (XLA; a Mosaic grouped matmul on the TPU) over the expert-sorted rows
// of moe_ffn_sorted: three launches a MoE layer (gate, up, down). Function kept: bf16 products
// are exact in fp32 and the sums are fp32 (only their order differs); int8 codes widen to bf16
// exactly (|q| <= 128, `widen2`, wi8_matmul.cu's), the scale multiplies the fp32 sum, and one
// cast to x's type ends it.
//
// The group sizes stay on the device: every CTA reads group_sizes itself, so the host never
// waits on the card for them (one read a product would be 96 host syncs a forward at 32
// layers), and no pre-pass is launched. Group sizes are clamped so the rows never pass M.
//
// Bound on the H100 at the Mixtral-8x7B shapes (E = 8, top-2, D = 4096, F = 14336):
//   * prefill, M = 2·B·T rows (4608 at B = 8, T = 288): 0.54 TFLOP a launch against 0.47 GB
//     (int8) or 0.94 GB (bf16) of weights, so bound by bf16 tensor-core operations (0.55 ms at
//     989 TFLOP/s);
//   * decode, M = 2·B (16 rows over 8 experts): bound by the weight stream, every used expert's
//     [O, I] read once (0.47 GB int8, 0.14 ms at 3.35 TB/s; bf16 twice that).
//
// The wrapper picks the route from M alone (ops/expert_ragged.py::ragged_prefill_route):
//
// M > 64, the prefill route: bf16 wgmma fed by TMA on a persistent grid (one CTA an SM), in the
// shape of wi8_matmul.cu's M > 64 route. Every CTA builds the work list from the group sizes
// (a warp scan over E <= 1024 sizes into shared memory) and walks its items with stride
// gridDim.x: (expert, n-tile, m-tile), the m-tiles of an n-tile fastest, so the CTAs in flight
// share each n-tile of one expert's weights through L2 and every weight comes from HBM about
// once; then the zero tiles of the rows past the sum. A tile is 128 weight rows (output
// channels) x 128 rows of x, computed as outᵀ: the weights are wgmma's operand A, x its operand
// B. A tile never spans two experts: it starts at its expert's row, and the rows of the next
// expert it holds are computed and never stored (~11 % of the rows at 576 an expert). 384
// threads:
//   * a producer warpgroup that gives its registers away (setmaxnreg), in which one thread
//     keeps a 6-stage ring of 64-deep k chunks full on full / empty mbarriers and runs on into
//     the CTA's next item while the consumers store the last: x [128 rows][64 k] (a TMA box,
//     128-byte swizzle, rows past M zero-filled) and the weights [128 n][64 k] of a map over
//     [E·O, I] (int8: 64-byte swizzle; bf16: 128-byte);
//   * two consumer warpgroups of 64 weight rows x 128 rows of x (m64n128k16). int8 codes are
//     loaded from the stage with 16-bit loads, widened in registers into the register-A
//     fragment (wgmma rs) between groups, so no register of an in-flight wgmma is written
//     (ptxas C7513); bf16 weights are read from shared memory (wgmma ss).
//   * The sums: each 128-deep chunk (kPPromote = 2 stages) goes into fresh accumulators
//     (scale-d = 0), is waited for and added to the running fp32 sums; one warpgroup's adds
//     run under the other's products. A tensor-core accumulator aligns its products to its
//     largest addend, the running sum included, and drops their low bits: with one running
//     accumulator over K = 4096 the kernel left 52432 of 66M int8 outputs off the correctly
//     rounded value of an fp64 reference, the fp32 plain version 11012, the promoted kernel
//     6615 (PERF.md §6). 64 + 64 accumulators, the fragments and the addressing take the 168
//     registers ptxas gives a 384-thread block, no spill.
//   * The epilogue multiplies by the scale in fp32, casts once to bf16 and stores masked by
//     the tile's rows and by O.
//   What bounds it (H100 80GB HBM3 at 700 W, 4608 x 4096 -> 14336 int8, 1.19 ms against a 0.55 ms
//   operations bound; knock-out copies of this file timed by tools/kernel_ab.py): the data path.
//   With no product, no widening and no promotion the stream of x and codes through the ring alone
//   takes 0.94 ms (~57 GB/s into each SM); the products add 0.28, the widening 0.21, the promotion
//   0.12, the stores 0.04. x multicast to a two-CTA cluster (half the L2 reads) gained 1 % in int8
//   and 0-9 % in bf16; with a cluster-scope release on each remote arrival it ran 2x slower. Larger
//   tiles would move fewer bytes a product but leave no registers for the promotion.
// M <= 64, the decode route: the used experts' weights streamed with K split across warps, in the
// shape of wi8_matmul.cu's M <= 64 route. A block owns (expert, 32 weight rows, 16 rows of the
// expert's group) over all of K; a block whose expert has no rows there returns before it issues
// any load, so an unused expert's weights are never read. 8 consumer warps take the k chunks in
// turn (chunk c to warp c % 8; 128 bytes of each weight row a chunk: 128 k of codes, 64 of bf16),
// each from one stage of its own, which one producer thread fills by TMA: the weights [32 n][128
// bytes] and x [16 rows][64 k] boxes from the block's first row. One stage a warp keeps a block
// (int8 / bf16) at 65 / 49 KB of shared memory and 84 / 78 registers, so two blocks share an SM and
// one's set-up and fold run under the other's stream (two stages a warp and 32-row blocks, one
// block an SM: 0.239 ms against 0.159). mma.sync m16n8k16 in a permuted k order (wi8_matmul.cu's),
// each chunk into fresh accumulators added to the running sums (the promotion at no extra cost); at
// the end the warps' fp32 partials are added in warp order 0..7 through shared memory, then times
// s. Bound by the used experts' bytes: 0.159 ms weighted over moe_turbo's decode launches against
// 0.123; with no product it still takes 0.150 (the stream). A fixed summation order and no atomics
// on either route: two runs give the same bits.
//
// Any other input (fp32 x, int8 codes with I not a multiple of 16, bf16 with I not a multiple
// of 8, O not a multiple of 8) takes the scalar route, ovla_expert_ragged_scalar (fp32 FMAs
// over 16 x 16 tiles), which the wrapper counts as expert_ragged_scalar.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace ovla_er {

namespace hp = ovla_hp;

constexpr int kMaxE = 1024;      // experts a launch takes
constexpr int kDecodeRows = 64;  // the most rows the decode route takes

// two int8 codes (byte sel & 0xF and (sel >> 8) & 0xF of w: 0x5140 the low pair, 0x7362 the
// high pair) -> bf16x2, the first code in the low half; exact (wi8_matmul.cu's widening)
template <uint32_t SEL>
__device__ __forceinline__ uint32_t widen2(uint32_t w) {
  const uint32_t a = __byte_perm(w, 0x43434343u, SEL);   // [c0, 0x43, c1, 0x43]
  const uint32_t lo = a & 0xFF7FFF7Fu;                     // 128 + (c & 0x7F)
  const uint32_t hi = a & 0xFF80FF80u;                     // 128, or 256 where c < 0
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                             *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t lds_u16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ long long warp_scan(long long v, int lane) {   // inclusive
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(0xFFFFFFFFu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// ---------------------------------------------------------------------------
// M > 64: wgmma on a persistent grid of (expert, n-tile, m-tile) items

constexpr int kPBN = 128;                     // weight rows a tile: two warpgroups of 64
constexpr int kPBM = 128;                     // rows of x a tile: wgmma's n
constexpr int kPBK = 64;                      // k a stage: one 128-byte row of x
constexpr int kPStages = 6;
constexpr int kPPromote = 2;                  // stages a chunk in fresh accumulators
constexpr int kPConsumers = 256;
constexpr int kPThreads = kPConsumers + 128;  // a producer warpgroup (setmaxnreg)
constexpr int kPAcc = kPBM / 2;               // fp32 accumulators a thread
constexpr int kPXBytes = kPBM * kPBK * 2;     // x of a stage, 16 KB

template <bool kInt8>
struct Prefill {
  static constexpr int kWBytes = kPBN * kPBK * (kInt8 ? 1 : 2);   // weights of a stage
  static constexpr int kStage = kPXBytes + kWBytes;                // a multiple of 1024
  // the ring, its barriers, the work list (item_start [E + 2], row_start [E + 1])
  static constexpr size_t kSmem =
      1024 + size_t(kPStages) * kStage + 2 * kPStages * 8 + (2 * kMaxE + 3) * 4;
};

struct Work {
  int e;      // expert, or -1: rows past the groups' sum (zeros)
  int row0;   // first row of x
  int rows;   // rows of the tile
  int n0;     // first weight row (output channel)
};

// Warp 0: every expert's first row (row_start, clamped to M) and first item (item_start:
// ceil(rows / kPBM) m-tiles x NT n-tiles an expert), then the zero tiles of the rows past the
// sum up to item_start[E + 1]
__device__ void plan(const int* __restrict__ gs, int E, int M, int NT, int* item_start,
                     int* row_start) {
  const int lane = threadIdx.x & 31;
  long long rows = 0, items = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const long long g = e < E ? max(gs[e], 0) : 0;
    const long long p = rows + warp_scan(g, lane);
    const int begin = int(min(p - g, (long long)M)), end = int(min(p, (long long)M));
    const long long n = (long long)((end - begin + kPBM - 1) / kPBM) * NT;
    const long long ip = items + warp_scan(n, lane);
    if (e < E) row_start[e] = begin, item_start[e] = int(ip - n);
    rows = __shfl_sync(0xFFFFFFFFu, p, 31);
    items = __shfl_sync(0xFFFFFFFFu, ip, 31);
  }
  if (lane == 0) {
    const int S = int(min(rows, (long long)M));
    row_start[E] = S;
    item_start[E] = int(items);
    item_start[E + 1] = int(items) + (M - S + kPBM - 1) / kPBM * NT;
  }
}

// item i of the list: the last e in [0, E] with item_start[e] <= i (e = E: a zero tile)
__device__ __forceinline__ Work work_at(int i, const int* item_start, const int* row_start, int E,
                                        int M) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (item_start[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  const int begin = row_start[lo], end = lo < E ? row_start[lo + 1] : M;
  const int mtiles = (end - begin + kPBM - 1) / kPBM, j = i - item_start[lo];
  const int row0 = begin + (j % mtiles) * kPBM;
  return Work{lo < E ? lo : -1, row0, min(kPBM, end - row0), (j / mtiles) * kPBN};
}

// The codes of row r (bytes k, k + 1) in a [rows][64 bytes] tile with the 64-byte swizzle
// (16-byte chunk c of row r stored at chunk c ^ ((r >> 1) & 3))
__device__ __forceinline__ const uint8_t* code_at(const uint8_t* qs, int r, int k) {
  return qs + r * 64 + ((((k >> 4) ^ (r >> 1)) & 3) << 4) + (k & 15);
}

// One stage's products into d (fresh: d dropped first) by a consumer warpgroup, waited for:
// x [128 rows][64 k] at xs (128-byte swizzle) is operand B; the weights at ws are operand A,
// int8 codes widened in registers (the fragments built before the group, so no register of an
// in-flight wgmma is written), or bf16 from shared memory.
template <bool kInt8>
__device__ __forceinline__ void stage_products(float (&d)[kPAcc], const uint8_t* xs,
                                               const uint8_t* ws, int wg, int r0, int t4,
                                               bool fresh) {
  if constexpr (kInt8) {
    // A fragments of the stage's four k16 steps: a0 / a1 rows r0 / r0 + 8 at k 2 t4, 2 t4 + 1,
    // a2 / a3 the same rows at k 2 t4 + 8, 2 t4 + 9 (x's k order)
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = kk * 16 + 2 * t4;
      af[kk][0] = widen2<0x5140>(lds_u16(code_at(ws, r0, k)));
      af[kk][1] = widen2<0x5140>(lds_u16(code_at(ws, r0 + 8, k)));
      af[kk][2] = widen2<0x5140>(lds_u16(code_at(ws, r0, k + 8)));
      af[kk][3] = widen2<0x5140>(lds_u16(code_at(ws, r0 + 8, k + 8)));
    }
    hp::fence_operands(d);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // k16 step kk: 32 bytes along each 128-byte x row
      hp::wgmma_bf16_rs_m64n128k16<0>(d, af[kk], hp::desc_sw128(xs + kk * 32),
                                      !(fresh && kk == 0));
  } else {
    hp::fence_operands(d);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::wgmma_bf16_ss_m64n128k16(d, hp::desc_sw128(ws + wg * 64 * 128 + kk * 32),
                                   hp::desc_sw128(xs + kk * 32), !(fresh && kk == 0));
  }
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_operands(d);
}

template <bool kInt8>
__global__ void __launch_bounds__(kPThreads, 1)
    expert_ragged_prefill(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ s,
                          const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int M,
                          int O, int I, int E) {
  using P = Prefill<kInt8>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kPStages * P::kStage);
  uint64_t* empty = full + kPStages;
  int* item_start = reinterpret_cast<int*>(empty + kPStages);
  int* row_start = item_start + kMaxE + 2;
  const int NT = (O + kPBN - 1) / kPBN, KT = (I + kPBK - 1) / kPBK;
  const int tid = threadIdx.x;

  if (tid < 32) plan(gs, E, M, NT, item_start, row_start);
  if (tid == 32) {
    for (int i = 0; i < kPStages; ++i) {
      hp::mbar_init(full + i, 1);    // the producer's arrival, then the stage's bytes
      hp::mbar_init(empty + i, 2);   // one thread of each consumer warpgroup
    }
    hp::mbar_init_fence();
  }
  __syncthreads();
  const int items = item_start[E + 1];

  if (tid >= kPConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // ---- producer: one thread keeps the ring full across the CTA's items ----
    if (tid == kPConsumers) {
      int c = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Work wk = work_at(i, item_start, row_start, E, M);
        if (wk.e < 0) continue;
        const int wrow = wk.e * O + wk.n0;
        for (int kc = 0; kc < KT; ++kc, ++c) {
          const int slot = c % kPStages;
          hp::mbar_wait(empty + slot, ((c / kPStages) & 1) ^ 1);   // the first round passes
          uint8_t* st = ring + slot * P::kStage;
          hp::mbar_expect_tx(full + slot, P::kStage);
          hp::tma_load_2d(st, &tm_x, kc * kPBK, wk.row0, full + slot);
          hp::tma_load_2d(st + kPXBytes, &tm_w, kc * kPBK, wrow, full + slot);
        }
      }
    }
    return;
  }

  // ---- two consumer warpgroups: weight rows 64 wg .. 64 wg + 63 of the tile x kPBM rows of x
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;   // this thread's fragment rows r0, r0 + 8
  int c = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const Work wk = work_at(i, item_start, row_start, E, M);
    if (wk.e < 0) {
      for (int j = tid; j < wk.rows * kPBN; j += kPConsumers) {
        const int n = wk.n0 + j % kPBN;
        if (n < O) out[(long long)(wk.row0 + j / kPBN) * O + n] = __float2bfloat16(0.f);
      }
      continue;
    }
    float acc[kPAcc];
#pragma unroll
    for (int j = 0; j < kPAcc; ++j) acc[j] = 0.f;
    float part[kPAcc];
    for (int kc = 0; kc < KT; ++kc, ++c) {
      const int slot = c % kPStages;
      hp::mbar_wait(full + slot, (c / kPStages) & 1);
      const uint8_t* xs = ring + slot * P::kStage;
      stage_products<kInt8>(part, xs, xs + kPXBytes, wg, r0, t4, kc % kPPromote == 0);
      if (wt == 0) hp::mbar_arrive(empty + slot);
      if (kc % kPPromote == kPPromote - 1 || kc == KT - 1) {
#pragma unroll
        for (int j = 0; j < kPAcc; ++j) acc[j] += part[j];
      }
    }

    // accumulator block j (rows of x 8 j .. 8 j + 7): weight rows r0 (e < 2), r0 + 8; rows of x
    // 8 j + 2 t4 + (e & 1)
    const int n = wk.n0 + r0;
    float s0 = 1.f, s8 = 1.f;
    if constexpr (kInt8) {
      const float* se = s + (long long)wk.e * O;
      s0 = n < O ? se[n] : 0.f;
      s8 = n + 8 < O ? se[n + 8] : 0.f;
    }
    __nv_bfloat16* ot = out + (long long)wk.row0 * O;
#pragma unroll
    for (int j = 0; j < kPBM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * j + 2 * t4 + (e & 1), nn = n + 8 * (e >> 1);
        if (m < wk.rows && nn < O) {
          const float v = kInt8 ? acc[4 * j + e] * ((e >> 1) ? s8 : s0) : acc[4 * j + e];
          ot[(long long)m * O + nn] = __float2bfloat16(v);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// M <= 64: the used experts' weights streamed by TMA, K split across warps, mma.sync

constexpr int kDBN = 32;                      // weight rows a block
constexpr int kDBM = 16;                      // rows of x a block: one m16 tile
constexpr int kDRowBytes = 128;               // bytes of each weight row a stage
constexpr int kDWarps = 8;                    // consumer warps, chunk c to warp c % 8
constexpr int kDConsumers = 32 * kDWarps;
constexpr int kDThreads = kDConsumers + 32;
constexpr int kDXBox = kDBM * 128;            // x [16 rows][64 k] bf16, 2 KB
constexpr int kDWBytes = kDBN * kDRowBytes;   // weights of a stage, 4 KB
constexpr int kDPitch = kDBN + 8;             // partial sums' row pitch (floats)

template <bool kInt8>
struct Decode {
  static constexpr int kBK = kInt8 ? 128 : 64;             // k a stage
  static constexpr int kXBoxes = kBK / 64;                 // x boxes a stage
  static constexpr int kStage = kDWBytes + kXBoxes * kDXBox;   // 8 / 6 KB, 1024-aligned
  // one stage a warp: two blocks an SM, whose set-up and fold run under each other's stream
  static constexpr size_t kSmem = 1024 + size_t(kDWarps) * kStage + 2 * kDWarps * 8;
  static_assert(kDWarps * kDBM * kDPitch * 4 <= kDWarps * kStage, "partials fit the ring");
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <bool kInt8>
__global__ void __launch_bounds__(kDThreads, 2)
    expert_ragged_decode(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ s,
                         const int* __restrict__ gs, __nv_bfloat16* __restrict__ out, int M,
                         int O, int I, int E) {
  using D = Decode<kInt8>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDWarps * D::kStage);
  uint64_t* empty = full + kDWarps;
  __shared__ int blk[2];   // the block's first row of x and its rows
  const int e = blockIdx.y, n0 = blockIdx.x * kDBN, tid = threadIdx.x;

  if (tid < 32) {   // rows before expert e (e = E: the rows past the groups' sum), clamped to M
    long long p = 0;
    for (int j = tid; j < e; j += 32) p += max(gs[j], 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xFFFFFFFFu, p, o);
    if (tid == 0) {
      const long long n = e < E ? max(gs[e], 0) : (long long)M;
      const int begin = int(min(p, (long long)M)), end = int(min(p + n, (long long)M));
      const int row0 = begin + kDBM * blockIdx.z;
      blk[0] = row0;
      blk[1] = min(kDBM, end - row0);
    }
  }
  __syncthreads();
  const int row0 = blk[0], rows = blk[1];
  if (rows <= 0) return;   // no rows here: none of the expert's weights are read
  if (e == E) {
    for (int j = tid; j < rows * kDBN; j += kDThreads) {
      const int n = n0 + j % kDBN;
      if (n < O) out[(long long)(row0 + j / kDBN) * O + n] = __float2bfloat16(0.f);
    }
    return;
  }

  if (tid == 0) {
    for (int i = 0; i < kDWarps; ++i) {
      hp::mbar_init(full + i, 1);
      hp::mbar_init(empty + i, 1);   // lane 0 of the warp that owns the stage
    }
    hp::mbar_init_fence();
  }
  __syncthreads();
  const int KT = (I + D::kBK - 1) / D::kBK;

  if (tid >= kDConsumers) {
    if (tid == kDConsumers) {
      const int wrow = e * O + n0;
      for (int c = 0; c < KT; ++c) {   // chunk c: warp c % 8, its stage
        const int slot = c % kDWarps, r = c / kDWarps;
        hp::mbar_wait(empty + slot, (r & 1) ^ 1);
        uint8_t* st = ring + slot * D::kStage;
        hp::mbar_expect_tx(full + slot, D::kStage);
        hp::tma_load_2d(st, &tm_w, c * D::kBK, wrow, full + slot);
#pragma unroll
        for (int h = 0; h < D::kXBoxes; ++h)
          hp::tma_load_2d(st + kDWBytes + h * kDXBox, &tm_x, c * D::kBK + 64 * h, row0,
                          full + slot);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  float acc[4][4];   // n8 tiles 0..3
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[nt][v] = 0.f;

  for (int r = 0; warp + kDWarps * r < KT; ++r) {
    hp::mbar_wait(full + warp, r & 1);
    const uint8_t* ws = ring + warp * D::kStage;
    const uint8_t* xs = ws + kDWBytes;
    float part[4][4];   // this chunk's sums, added to the running sums after it
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) part[nt][v] = 0.f;
#pragma unroll
    for (int i = 0; i < D::kBK / 16; ++i) {
      // k 16 i + 4 t4 .. + 3 at the fragment's slots 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 of both
      // operands; x rows g, g + 8: box i / 4, 16-byte chunk 2 (i % 4) + t4 / 2 stored at
      // chunk ^ (row % 8), bytes 8 (t4 % 2) ..
      const int chunk = 2 * (i % 4) + (t4 >> 1);
      uint2 xa[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h;
        xa[h] = *reinterpret_cast<const uint2*>(xs + (i / 4) * kDXBox + row * 128 +
                                                ((chunk ^ (row & 7)) << 4) + 8 * (t4 & 1));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // weight row nt * 8 + g (128-byte rows, 16-byte chunk c stored at c ^ (n % 8)): codes
        // at k 16 i + 4 t4 .. + 3 (chunk i, bytes 4 t4 ..), bf16 at the same k as x's
        const int n = nt * 8 + g;
        uint32_t b0, b1;
        if constexpr (kInt8) {
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(ws + n * 128 + ((i ^ (n & 7)) << 4) + 4 * t4);
          b0 = widen2<0x5140>(w), b1 = widen2<0x7362>(w);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(
              ws + n * 128 + ((chunk ^ (n & 7)) << 4) + 8 * (t4 & 1));
          b0 = w.x, b1 = w.y;
        }
        mma_bf16_16816(part[nt], xa[0].x, xa[1].x, xa[0].y, xa[1].y, b0, b1);
      }
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(empty + warp);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[nt][v] += part[nt][v];
  }

  // every warp's stages consumed: the ring takes the partial sums [warp][16 rows][pitch]
  hp::named_barrier(1, kDConsumers);
  float* part = reinterpret_cast<float*>(ring);
  float* pw = part + warp * kDBM * kDPitch;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(pw + (g + 8 * h) * kDPitch + nt * 8 + 2 * t4) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  hp::named_barrier(1, kDConsumers);
#pragma unroll
  for (int k = 0; k < kDBM * kDBN / kDConsumers; ++k) {
    const int idx = tid + kDConsumers * k, row = idx / kDBN, col = idx % kDBN, n = n0 + col;
    if (row >= rows || n >= O) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kDWarps; ++w) sum += part[(w * kDBM + row) * kDPitch + col];
    if constexpr (kInt8) sum *= s[(long long)e * O + n];
    out[(long long)(row0 + row) * O + n] = __float2bfloat16(sum);
  }
}

template <bool kInt8>
int launch_prefill(const void* x, const void* w, const float* s, const int* gs, void* out, int M,
                   int O, int I, int E, cudaStream_t st) {
  CUtensorMap tm_x, tm_w;
  if (!hp::encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, I, uint64_t(I) * 2, kPBM, kPBK,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::encode_2d(&tm_w,
                     kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w,
                     uint64_t(E) * O, I, uint64_t(I) * (kInt8 ? 1 : 2), kPBN, kPBK,
                     kInt8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  auto kernel = expert_ragged_prefill<kInt8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(Prefill<kInt8>::kSmem));
  if (err != cudaSuccess) return int(err);
  const long long NT = (O + kPBN - 1) / kPBN;
  const long long most = ((M + kPBM - 1) / kPBM + (long long)E + 1) * NT;   // items, at most
  const dim3 grid(unsigned(most < hp::sm_count() ? most : hp::sm_count()));
  kernel<<<grid, kPThreads, Prefill<kInt8>::kSmem, st>>>(tm_x, tm_w, s, gs,
                                                          static_cast<__nv_bfloat16*>(out), M, O,
                                                          I, E);
  return int(cudaGetLastError());
}

template <bool kInt8>
int launch_decode(const void* x, const void* w, const float* s, const int* gs, void* out, int M,
                  int O, int I, int E, cudaStream_t st) {
  using D = Decode<kInt8>;
  CUtensorMap tm_x, tm_w;
  if (!hp::encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, I, uint64_t(I) * 2, kDBM,
                     64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::encode_2d(&tm_w,
                     kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w,
                     uint64_t(E) * O, I, uint64_t(I) * (kInt8 ? 1 : 2), kDBN, D::kBK,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  auto kernel = expert_ragged_decode<kInt8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(D::kSmem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((O + kDBN - 1) / kDBN, E + 1, (M + kDBM - 1) / kDBM);
  kernel<<<grid, kDThreads, D::kSmem, st>>>(tm_x, tm_w, s, gs, static_cast<__nv_bfloat16*>(out),
                                            M, O, I, E);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// any other input: scalar fp32 FMAs, 16 x 16 outputs a block, one a thread, k staged by 16

struct Tile {
  int e;      // expert, or -1 for a tile of rows past the groups' sum (zeros)
  int row0;   // first row
  int rows;   // rows of the tile (<= 0: no tile)
};

// Tile `t` of the scalar route's map (thread 0 of a CTA computes it; E reads of group_sizes):
// each expert's rows in ceil(n_e / bm) tiles from its first row, then the rows past the sum.
// Rows are clamped to M, so group sizes that sum past M never send a read or a write out of
// bounds.
__device__ Tile find_tile(const int* __restrict__ gs, int E, int M, int bm, int t) {
  int start = 0;
  for (int e = 0; e < E; ++e) {
    const int n = max(gs[e], 0);
    const int te = (n + bm - 1) / bm;
    if (t < te) {
      const int row0 = start + t * bm;
      return Tile{e, row0, min(min(bm, n - t * bm), M - row0)};
    }
    t -= te;
    start += n;
  }
  const int row0 = min(start, M) + t * bm;
  return Tile{-1, row0, min(bm, M - row0)};
}

constexpr int kSTile = 16;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t v) { return float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// TX: x and output type; TW: weight type (TX, or int8 codes with scales)
template <typename TX, typename TW>
__global__ void __launch_bounds__(kSTile* kSTile)
    expert_ragged_scalar_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                                const float* __restrict__ s, const int* __restrict__ gs,
                                TX* __restrict__ out, int M, int O, int I, int E) {
  __shared__ float xs[kSTile][kSTile + 1];
  __shared__ float wsh[kSTile][kSTile + 1];
  __shared__ Tile tile;
  if (threadIdx.x == 0) tile = find_tile(gs, E, M, kSTile, blockIdx.x);
  __syncthreads();
  const Tile tl = tile;
  if (tl.rows <= 0) return;
  const int n0 = blockIdx.y * kSTile;
  if (tl.e < 0) {
    for (int i = threadIdx.x; i < tl.rows * kSTile; i += blockDim.x) {
      const int r = i / kSTile, n = n0 + i % kSTile;
      if (n < O) out[(long long)(tl.row0 + r) * O + n] = from_f32<TX>(0.f);
    }
    return;
  }
  const int tx = threadIdx.x % kSTile, ty = threadIdx.x / kSTile;
  const TW* we = w + (long long)tl.e * O * I;
  float acc = 0.f;
  for (int k0 = 0; k0 < I; k0 += kSTile) {
    const int k = k0 + tx;
    xs[ty][tx] = (ty < tl.rows && k < I) ? to_f32<TX>(x[(long long)(tl.row0 + ty) * I + k]) : 0.f;
    wsh[ty][tx] = (n0 + ty < O && k < I) ? to_f32<TW>(we[(long long)(n0 + ty) * I + k]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSTile; ++kk) acc = fmaf(xs[ty][kk], wsh[tx][kk], acc);
    __syncthreads();
  }
  const int n = n0 + tx;
  if (ty < tl.rows && n < O) {
    if (s != nullptr) acc *= s[(long long)tl.e * O + n];
    out[(long long)(tl.row0 + ty) * O + n] = from_f32<TX>(acc);
  }
}

template <typename TX, typename TW>
int launch_scalar(const void* x, const void* w, const void* s, const void* gs, void* out, int M,
                  int O, int I, int E, cudaStream_t st) {
  const dim3 grid((M + kSTile - 1) / kSTile + E + 1, (O + kSTile - 1) / kSTile);
  expert_ragged_scalar_kernel<TX, TW><<<grid, kSTile * kSTile, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<const float*>(s),
      static_cast<const int*>(gs), static_cast<TX*>(out), M, O, I, E);
  return int(cudaGetLastError());
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace ovla_er

// The tensor-core routes: x bf16 [M, I], w [E, O, I] bf16 (w_int8 = 0) or int8 codes with
// s fp32 [E, O] (w_int8 = 1), group_sizes int32 [E] on the device, out bf16 [M, O]; all
// contiguous, x, w and out 16-byte aligned, O a multiple of 8, I a multiple of 16 (int8: the
// TMA map's 16-byte rows of codes) or 8 (bf16). prefill = 1 takes the wgmma route on a
// persistent grid, prefill = 0 the split-K decode route (M <= kDecodeRows). Refuses anything
// else (cudaErrorInvalidValue). Returns the launch's cudaError_t.
extern "C" int ovla_expert_ragged(const void* x, const void* w, const void* s,
                                  const void* group_sizes, void* out, int M, int O, int I, int E,
                                  int w_int8, int prefill, void* stream) {
  namespace r = ovla_er;
  const long long items = ((M + r::kPBM - 1) / r::kPBM + (long long)E + 1) *
                          ((O + r::kPBN - 1) / r::kPBN);
  if (M < 1 || O < 8 || O % 8 || I < 8 || I % (w_int8 ? 16 : 8) || E < 1 || E > r::kMaxE ||
      (long long)E * O > 2147483647LL || items > 2147483647LL ||
      (!prefill && M > r::kDecodeRows) || r::misaligned(x) || r::misaligned(w) ||
      r::misaligned(out) || (w_int8 && s == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* sf = static_cast<const float*>(s);
  const auto* gi = static_cast<const int*>(group_sizes);
  if (prefill)
    return w_int8 ? r::launch_prefill<true>(x, w, sf, gi, out, M, O, I, E, st)
                  : r::launch_prefill<false>(x, w, sf, gi, out, M, O, I, E, st);
  return w_int8 ? r::launch_decode<true>(x, w, sf, gi, out, M, O, I, E, st)
                : r::launch_decode<false>(x, w, sf, gi, out, M, O, I, E, st);
}

// The most rows the decode route takes (ops/expert_ragged.py::DECODE_ROWS mirrors it).
extern "C" int ovla_expert_ragged_decode_rows() { return ovla_er::kDecodeRows; }

// The scalar route: x fp32 (x_bf16 = 0) or bf16 [M, I]; w [E, O, I] of x's type (w_int8 = 0,
// s null) or int8 codes with s fp32 [E, O]; out of x's type [M, O]; any M, O, I >= 1.
extern "C" int ovla_expert_ragged_scalar(const void* x, const void* w, const void* s,
                                         const void* group_sizes, void* out, int M, int O, int I,
                                         int E, int x_bf16, int w_int8, void* stream) {
  namespace r = ovla_er;
  if (M < 1 || O < 1 || I < 1 || E < 1 || E > r::kMaxE || (O + r::kSTile - 1) / r::kSTile > 65535 ||
      (w_int8 != 0) != (s != nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return w_int8 ? r::launch_scalar<__nv_bfloat16, int8_t>(x, w, s, group_sizes, out, M, O, I, E, st)
                  : r::launch_scalar<__nv_bfloat16, __nv_bfloat16>(x, w, s, group_sizes, out, M,
                                                                   O, I, E, st);
  return w_int8 ? r::launch_scalar<float, int8_t>(x, w, s, group_sizes, out, M, O, I, E, st)
                : r::launch_scalar<float, float>(x, w, s, group_sizes, out, M, O, I, E, st);
}
