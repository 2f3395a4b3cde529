// w4a8_grouped: out[M, N] = cast(s_x[m] · Σ_g f32(Σ_{k in g} x8[m, k] · q4[g, n, k]) · s[n, g]):
// per-row int8 activation codes times grouped int4 weight codes, each group's exact int32
// product scaled by its own group scale.
//
// Replaces the XLA op openvla_probe_tpu/ops/linear.py::_w4a8_dot_grouped (forward :511-522): the
// decode-M product (M <= 32) of grouped int4 leaves and of mix leaves' int4 copies off the
// kernel gate (the turbo tier over bits=4 and bits="mix" weights). Semantics:
//   * per-row codes clip(rint(x / s_x), -127, 127) with s_x = max(max|x| / 127, 1e-8) and IEEE
//     divisions (round half to even), the pre-pass quant_rows of int8_mma.cuh (a launch of its
//     own: the decode steps' norms are plain, so no fused norm hands over the codes);
//   * the exact int32 product of each segment of K (a 128-deep chunk cut at the group
//     boundaries), folded into an fp32 sum as acc + f32(p) · s[n, g], two roundings (the _rn
//     intrinsics keep nvcc from contracting);
//   * the fp32 sums in a fixed order: chunk c belongs to class c % 8, each class folds its
//     segments in k order into a sum of its own, the 8 classes' sums are added in class order,
//     then · s_x and the cast. The plain version (ops/linear.py::w4a8_grouped_plain) states that
//     order, so the kernel is bit-equal to it; against the JAX package, whose einsum order is
//     unspecified, it is held within a tolerance. No step depends on M or N (a column's sums are
//     the same in any tile), so fusing q/k/v or gate/up into one leaf changes no output bit.
// Weight codes are the port's packed layout, group-major: uint8 [G][N][gsz / 2], byte j holding
// code 2j in its low nibble and 2j + 1 in its high nibble (two's complement); s fp32 [N][G].
//
// Bound on the H100 at the OpenVLA-7B decode shapes (M = 24): the int4 codes and the scales,
// 8.4 + 0.5 MB at 4096 x 4096 (2.7 us at 3.35 TB/s), 65.7 + 4.1 MB at lm_head's 32064 x 4096
// (20.8 us).
//
// Design. The first version (int8_decode.cuh's split-K core, one CTA a 32-column tile,
// each of 8 warps folding the whole 32 x 32 tile) held 128 registers a thread, one CTA an SM, and
// left the card half idle at N = 4096 (128 tiles); every CTA paid its set-up and a cold ring.
// Here:
//  * A cluster of two CTAs a 32-row x 32-column tile splits K by class: rank r takes the chunks
//    of classes 4r .. 4r + 3. In a CTA, warp w folds class 4r + w % 4 over columns 16 (w / 4) ..
//    16 (w / 4) + 15, so the two warps of a class read the same stages (an empty barrier of two
//    arrivals) and each holds half the tile: 16 int32 and 16 fp32 sums, 96 registers in all, and
//    two CTAs share an SM (__launch_bounds__(.., 2); 12 stages of 6 KB each, 3 a class). At
//    N = 4096 the 256 CTAs fill the card in one wave.
//  * One producer thread a CTA fills the stages by TMA in chunk order (the activation codes
//    [32 rows][128 bytes], 128-byte swizzle; the int4 codes from a 3-D map over
//    [G][N][gsz / 2], one box [32 n][64 bytes] a chunk, 64-byte swizzle, where gsz is a multiple
//    of 128, else one box [32 n][16 bytes] per 32-deep k step, which lies in one group). The
//    packed codes are widened to int8 in registers (ldmatrix hands each thread 8 consecutive
//    codes of one channel; the pre-pass stores each 32-code block of activation codes in the
//    matching stored_offset order) for mma.sync m16n8k32 s8 x s8 -> s32. At the end of a
//    segment each accumulator is folded with the scale of its column (one group a chunk: the
//    scales loaded a chunk of the class ahead).
//  * The GEMM is the pre-pass's programmatic dependent launch: its CTAs start, set up their
//    barriers and send the first stages' weights while the pre-pass runs, and wait
//    (griddepcontrol.wait) only before the activation codes and s_x.
//  * Every class's fp32 sums go to a slot of rank 1's shared memory (rank 0's by distributed
//    shared memory, then an mbarrier arrival of release semantics at cluster scope); rank 1 adds
//    the 8 slots in class order, multiplies by s_x and stores, then releases the slots for the
//    next tile. No atomics. (A chain of turns, each class adding its sums to a shared tile in
//    turn with a named barrier between, cost ~4 us a launch: PERF.md §6.)
//  * A persistent grid: min(tiles, resident clusters) clusters, each walking tiles
//    cluster + i · clusters with its barriers set up once, the producer filling the next tile's
//    stages while the consumers add and store. Columns past N (N a multiple of 8) are
//    zero-filled by TMA and never stored, rows past M likewise.
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_ab.py in turns with the first version;
// PERF.md §6): 0.0281 ms launch-weighted against 0.0342 (24 x 4096 x 4096 0.0199 against
// 0.0227, of which the pre-pass alone 0.0065 and the GEMM alone 0.0179; lm_head 0.0874 against
// 0.1155); 96 registers, no spill, 132 clusters resident. Knock-outs: with no load at all it
// still takes 0.022 weighted, so the launch, the pre-pass, the set-up and the classes' handoff
// bound it, not the bytes (a 0.0048 bound).
#include <cooperative_groups.h>

#include "int8_decode.cuh"

namespace ovla_w4g {

namespace cg = cooperative_groups;
namespace hp = ovla_hp;
using ovla_i8::ldmatrix_x4;
using ovla_i8::mma_s8_16832;

constexpr int kBM = 32;                    // rows of activation codes a tile
constexpr int kBN = 32;                    // weight columns a tile
constexpr int kChunk = 128;                // k a stage
constexpr int kClasses = 8;                // fp32 sums a column: chunk c folds into class c % 8
constexpr int kRanks = 2;                  // CTAs of a cluster: rank r takes classes 4r .. 4r + 3
constexpr int kLocal = kClasses / kRanks;  // classes a CTA takes
constexpr int kWarps = 2 * kLocal;         // warp w: class 4r + w % 4, column half w / 4
constexpr int kSlots = 3;                  // stages of each class
constexpr int kStages = kLocal * kSlots;
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kABytes = kBM * kChunk;      // activation codes of a stage, 4 KB
constexpr int kPlane = kBN * kChunk / 2;   // int4 codes of a stage, 2 KB
constexpr int kStage = kABytes + kPlane;   // a multiple of 1024: every tile swizzle-aligned
constexpr int kPitch = kBN + 4;            // the classes' sums: row pitch (floats)
constexpr int kTile = kBM * kPitch;        // floats of a class's sums
static_assert(kStage % 1024 == 0, "stages stay 1024-byte aligned");

// + 1024: the base rounded up for the 128-byte swizzle; the ring, the 8 classes' sums (rank 1's
// copy read), the full / empty barriers and rank 1's receive / rank 0's release barriers. Two
// CTAs an SM: 2 (kSmem + 1 KB reserved) <= 228 KB
constexpr size_t kSmem = 1024 + size_t(kStages) * kStage + size_t(kClasses) * kTile * 4 +
                         (2 * kStages + 2) * sizeof(uint64_t);
static_assert(2 * (kSmem + 1024) <= 228 * 1024, "two CTAs an SM");

// the shared::cluster address of `p` (this CTA's shared memory) in the CTA of rank `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(hp::smem_u32(p)), "r"(rank));
  return r;
}
// one arrival on a barrier of another CTA of the cluster, releasing this thread's earlier
// accesses (its stores into that CTA's shared memory, its reads of its own) at cluster scope
__device__ __forceinline__ void remote_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void store_remote(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}
// programmatic dependent launch: wait until the grid this one depends on (the pre-pass) has
// completed and its writes are visible (returns at once when launched without the attribute)
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// a ring stage's wait: a suspend-time hint of 32 ns, so a waiting thread looks again at least
// that often (0.0281 -> 0.0278 ms launch-weighted against no hint; PERF.md §6)
constexpr int kWaitHintNs = 32;

// wait for the phase of parity `parity` of a barrier that another CTA arrives on (acquire at
// cluster scope); traps past ~10 s of clocks, as mbar_wait
__device__ __forceinline__ void cluster_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hp::smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_q, const float* __restrict__ sx,
                   const float* __restrict__ s, T* __restrict__ out, int M, int N, int G,
                   int gsz) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  float* part = reinterpret_cast<float*>(ring + kStages * kStage);   // [class][32 rows][pitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + kClasses * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* xfull = empty + kStages;             // rank 1: classes 0-3 of this tile are in
  uint64_t* xfree = xfull + 1;                   // rank 0: rank 1 has read the last tile's
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int ci = blockIdx.x / kRanks, nclusters = gridDim.x / kRanks;
  const int K = G * gsz;
  const int KC = (K + kChunk - 1) / kChunk;
  const int nt = (N + kBN - 1) / kBN, tiles = nt * ((M + kBM - 1) / kBM);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool one_group = gsz % kChunk == 0;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hp::mbar_init(full + i, 1);
      hp::mbar_init(empty + i, 2);   // lane 0 of each of the class's two warps
    }
    hp::mbar_init(xfull, kConsumers);   // every consumer of rank 0, after its stores
    hp::mbar_init(xfree, kConsumers);   // every consumer of rank 1, after its reads
    hp::mbar_init_fence();
  }
  cluster.sync();   // both CTAs' barriers set up before any arrival from the other

  if (warp == kWarps) {
    if (lane == 0) {
      // chunk c of tile round i: this rank's when (c % 8) / 4 == rank; class c % 8 takes stages
      // (c % 4) · kSlots .. of its own, and it is the class's (i · nc + c / 8)-th chunk
      auto mine = [&](int c) { return (c % kClasses) / kLocal == rank; };
      auto slot_of = [&](int i, int c, int& u) {
        const int nc = (KC - 1 - c % kClasses) / kClasses + 1;
        u = i * nc + c / kClasses;
        return (c % kLocal) * kSlots + u % kSlots;
      };
      auto load_a = [&](int slot, int c, int m0) {
        hp::tma_load_2d(ring + slot * kStage, &tm_a, c * kChunk, m0, full + slot);
      };
      auto load_q = [&](int slot, int c, int n0) {   // expects the stage's bytes, then its loads
        const int steps = one_group ? 1 : min(4, (K - c * kChunk) / 32);
        const int box = one_group ? kPlane : kBN * 16;
        hp::mbar_expect_tx(full + slot, kABytes + steps * box);
        for (int kk = 0; kk < steps; ++kk) {
          const int k = c * kChunk + 32 * kk;
          hp::tma_load_3d(ring + slot * kStage + kABytes + kk * box, &tm_q, (k % gsz) / 2, n0,
                          k / gsz, full + slot);
        }
      };
      // The first tile's first kSlots chunks of each class find their stages free: their weights
      // go out while the pre-pass (this grid's programmatic predecessor) still runs, their
      // activation codes once it has completed. Then every other chunk in order.
      const int n00 = (ci % nt) * kBN, m00 = (ci / nt) * kBM;
      int u;
      for (int c = 0; c < KC && c / kClasses < kSlots; ++c)
        if (mine(c)) load_q(slot_of(0, c, u), c, n00);
      wait_prior_grid();
      for (int c = 0; c < KC && c / kClasses < kSlots; ++c)
        if (mine(c)) load_a(slot_of(0, c, u), c, m00);
      for (int i = 0, t = ci; t < tiles; ++i, t += nclusters) {
        const int n0 = (t % nt) * kBN, m0 = (t / nt) * kBM;
        for (int c = i == 0 ? kSlots * kClasses : 0; c < KC; ++c) {
          if (!mine(c)) continue;
          const int slot = slot_of(i, c, u);
          hp::mbar_wait<kWaitHintNs>(empty + slot, ((u / kSlots) & 1) ^ 1);
          load_q(slot, c, n0);
          load_a(slot, c, m0);
        }
      }
    }
    return;
  }

  const int l = warp % kLocal, half = warp / kLocal, p = kLocal * rank + l;
  const int nc = KC > p ? (KC - 1 - p) / kClasses + 1 : 0;   // chunks of class p a tile
  const int g8 = lane >> 2, t4 = lane & 3;
  const uint32_t peer_part = cluster_addr(part, 1), peer_xfull = cluster_addr(xfull, 1);
  const uint32_t peer_xfree = cluster_addr(xfree, 0);

  for (int i = 0, t = ci; t < tiles; ++i, t += nclusters) {
    const int n0 = (t % nt) * kBN, m0 = (t / nt) * kBM;
    int acc[2][2][4];     // m16 tiles 0, 1 x this half's n8 tiles: the segment's int32 sums
    float facc[2][2][4];  // the class's fp32 sums
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0, facc[mt][j][e] = 0.f;

    // the scales of this lane's accumulator columns n0 + (2 half + j) · 8 + 2 t4 + h in group g
    // (0 past N)
    auto load_scales = [&](int g, float (&sc)[2][2]) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + (2 * half + j) * 8 + 2 * t4 + h;
          sc[j][h] = n < N ? __ldg(s + (long long)n * G + g) : 0.f;
        }
    };
    // acc + f32(p) · s, each step rounded once; the segment's int32 sums restart at 0
    auto fold = [&](const float (&sc)[2][2]) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            facc[mt][j][e] = __fadd_rn(facc[mt][j][e],
                                       __fmul_rn(__int2float_rn(acc[mt][j][e]), sc[j][e & 1]));
            acc[mt][j][e] = 0;
          }
    };

    float snext[2][2];
    if (one_group && nc > 0) load_scales(p * kChunk / gsz, snext);
    for (int r = 0; r < nc; ++r) {
      const int c = p + kClasses * r, u = i * nc + r, slot = l * kSlots + u % kSlots;
      const int steps = min(4, (K - c * kChunk) / 32);
      float sc[2][2];
      if (one_group) {
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[j][0] = snext[j][0], sc[j][1] = snext[j][1];
        if (r + 1 < nc) load_scales((c + kClasses) * kChunk / gsz, snext);
      }
      hp::mbar_wait<kWaitHintNs>(full + slot, (u / kSlots) & 1);
      const uint8_t* as = ring + slot * kStage;
      const uint8_t* qs = as + kABytes;
      // B words of this half's n8 tile j: b[j][2 kk], b[j][2 kk + 1] are the fragment's two
      // registers in k32 step kk (channel g8; k 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3
      // of the step). One group a chunk: 64-byte rows, 16-byte chunk kk of row n stored at
      // kk ^ ((n >> 1) & 3); else box kk [32 n][16 bytes] at 512 kk. Lane (g8, t4) gets the
      // packed bytes 4 t4 .. 4 t4 + 3 of row n in step kk, codes 8 t4 .. 8 t4 + 7, widened.
      uint32_t b[2][8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = (2 * half + j) * 8 + (lane & 7);
        uint32_t ph[4];
        ldmatrix_x4(ph, qs + (one_group ? n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4)
                                        : (lane >> 3) * (kBN * 16) + n * 16));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) ovla_i8::widen(ph[kk], b[j][2 * kk], b[j][2 * kk + 1]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < steps) {
          // A: 128-byte rows, 16-byte chunk i of row r stored at chunk i ^ (r % 8)
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int row = mt * 16 + (lane & 15);
            ldmatrix_x4(a[mt], as + row * 128 + (((kk * 2 + (lane >> 4)) ^ (row & 7)) << 4));
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_s8_16832(acc[mt][j], a[mt], b[j][2 * kk], b[j][2 * kk + 1]);
          const int k = c * kChunk + 32 * kk;
          if (!one_group && ((k + 32) % gsz == 0 || kk == steps - 1)) {   // a segment ends
            load_scales(k / gsz, sc);
            fold(sc);
          }
        }
      }
      if (one_group) fold(sc);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(empty + slot);
    }

    // Every class's sums into its slot of rank 1's tiles (element (mt, j, h) of this lane: row
    // mt · 16 + g8 + 8 h, columns (2 half + j) · 8 + 2 t4 and + 1): rank 0's by distributed
    // shared memory once rank 1 has read the last tile's, then an arrival releasing them
    if (rank == 0 && i > 0) cluster_wait(xfree, (i - 1) & 1);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = p * kTile + (mt * 16 + g8 + 8 * h) * kPitch + (2 * half + j) * 8 + 2 * t4;
          const float v0 = facc[mt][j][2 * h], v1 = facc[mt][j][2 * h + 1];
          if (rank == 0)
            store_remote(peer_part + 4 * e, v0, v1);
          else
            *reinterpret_cast<float2*>(part + e) = make_float2(v0, v1);
        }
    if (rank == 0) {
      remote_arrive(peer_xfull);
      continue;
    }
    // rank 1: the 8 classes' sums added in class order, · s_x, stored
    hp::named_barrier(1, kConsumers);   // classes 4-7 in
    cluster_wait(xfull, i & 1);         // classes 0-3 in
    wait_prior_grid();                  // s_x: the pre-pass's
#pragma unroll
    for (int k = 0; k < kBM * kBN / kConsumers; ++k) {
      const int e = tid + kConsumers * k, row = e / kBN, col = e % kBN;
      const int m = m0 + row, n = n0 + col;
      if (m < M && n < N) {
        float sum = part[row * kPitch + col];
#pragma unroll
        for (int cl = 1; cl < kClasses; ++cl)
          sum = __fadd_rn(sum, part[cl * kTile + row * kPitch + col]);
        ovla_i8d::store1(out + (long long)m * N + n, __fmul_rn(sum, __ldg(sx + m)));
      }
    }
    hp::named_barrier(1, kConsumers);   // every read done before the next tile's stores
    // rank 0 may write the next tile's (never after the last tile: rank 0 may have exited)
    if (t + nclusters < tiles) remote_arrive(peer_xfree);
  }
}

// once a device: the shared-memory opt-in, then the clusters the card holds at once (the
// persistent grid's size), or minus the cudaError_t of a failed query. `static`: each library's
// copy keeps its own state (a function-local static of a function with external linkage is one
// object across every loaded library, GNU_UNIQUE, so another build's kernel would skip its
// opt-in)
template <typename T>
static int resident_clusters() {
  static hp::PerDevice n;   // the opt-in, like the count, is the current device's
  return n.get([] {
    auto kernel = grouped_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
    if (err != cudaSuccess) return -int(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kRanks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kRanks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int count = 0;
    err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
    if (err != cudaSuccess) return -int(err);
    return count > 0 ? count : -int(cudaErrorInvalidConfiguration);
  });
}

template <typename T>
int run(const int8_t* xq, const float* sx, const uint8_t* q, const float* s, void* out, int M,
        int N, int G, int gsz, cudaStream_t stream) {
  CUtensorMap tm_a, tm_q;
  const int K = G * gsz;
  if (!hp::encode_2d(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, kBM, kChunk,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::encode_groups(&tm_q, q, G, N, gsz, kBN))
    return int(cudaErrorInvalidValue);
  auto kernel = grouped_kernel<T>;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // the pre-pass's programmatic dependent: launched while it runs (griddepcontrol)
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const int resident = resident_clusters<T>();
  if (resident < 0) return -resident;
  const long long tiles = (long long)((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
  if (tiles > (1 << 30)) return int(cudaErrorInvalidValue);
  cfg.gridDim = dim3(kRanks * int(tiles < resident ? tiles : resident));
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, tm_a, tm_q, sx, s, static_cast<T*>(out), M, N, G, gsz);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace ovla_w4g

namespace ovla_w4g {

// what the launchers refuse (cudaErrorInvalidValue) before any launch
bool refuses(int M, int N, int G, int gsz, const void* xq, const void* q, const void* s,
             const void* out) {
  auto misaligned = [](const void* p, uintptr_t a) {
    return (reinterpret_cast<uintptr_t>(p) & (a - 1)) != 0;
  };
  return M < 1 || N < 8 || N % 8 != 0 || G < 1 || gsz < 32 || gsz % 32 != 0 ||
         (long long)G * gsz > (1 << 30) || !s || !out || misaligned(xq, 16) ||
         misaligned(q, 16) || misaligned(out, 8);
}

int gemm(const void* xq, const void* sx, const void* q, const void* s, void* out, int M, int N,
         int G, int gsz, int is_bf16, cudaStream_t st) {
  const int8_t* codes = static_cast<const int8_t*>(xq);
  const float* scales = static_cast<const float*>(sx);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  if (is_bf16) return run<__nv_bfloat16>(codes, scales, qp, sp, out, M, N, G, gsz, st);
  return run<float>(codes, scales, qp, sp, out, M, N, G, gsz, st);
}

}  // namespace ovla_w4g

// The persistent grid's size: the clusters of two CTAs the card holds at once (bf16 out when
// is_bf16), or minus the cudaError_t of a failed query. Uncounted: chip_smoke.py logs it.
extern "C" int ovla_w4a8_grouped_resident_clusters(int is_bf16) {
  return is_bf16 ? ovla_w4g::resident_clusters<__nv_bfloat16>()
                 : ovla_w4g::resident_clusters<float>();
}

// The pre-pass alone: x [M, K] (bf16 when is_bf16, else fp32, 16-byte aligned) -> codes xq int8
// [M, K] in the stored_offset k order and s_x fp32 [M]. Uncounted: tools/kernel_ab.py and
// chip_smoke.py time it apart from the GEMM. Returns the launch's cudaError_t.
extern "C" int ovla_w4a8_grouped_quant_rows(const void* x, void* xq, void* sx, int M, int K,
                                            int is_bf16, void* stream) {
  if (M < 1 || K < 32 || K % 32 != 0 || !x || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(xq) & 15) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* codes = static_cast<int8_t*>(xq);
  float* scales = static_cast<float*>(sx);
  using ovla_i8::quant_rows;
  constexpr int kThr = 512;   // a decode row's 4096 .. 11008 codes: 2 .. 6 vectors a thread
  using ovla_i8::Ident;
  if (is_bf16)
    return int(quant_rows<__nv_bfloat16, true, false, Ident, kThr>(x, codes, scales, nullptr, M,
                                                                  K, st));
  return int(quant_rows<float, true, false, Ident, kThr>(x, codes, scales, nullptr, M, K, st));
}

// The GEMM alone on the pre-pass's codes xq and s_x; the other arguments as ovla_w4a8_grouped's.
// Uncounted (timed apart, as the pre-pass). Returns the launch's cudaError_t.
extern "C" int ovla_w4a8_grouped_gemm(const void* xq, const void* sx, const void* q,
                                      const void* s, void* out, int M, int N, int G, int gsz,
                                      int is_bf16, void* stream) {
  if (ovla_w4g::refuses(M, N, G, gsz, xq, q, s, out)) return int(cudaErrorInvalidValue);
  return ovla_w4g::gemm(xq, sx, q, s, out, M, N, G, gsz, is_bf16,
                        static_cast<cudaStream_t>(stream));
}

// Returns the launches' cudaError_t (0 on success). x [M, K] (bf16 when is_bf16, else fp32),
// scratch xq int8 [M, K] and sx fp32 [M] (the pre-pass writes the codes in the stored_offset k
// order of the packed fragments), q packed uint8 [G][N][gsz / 2] (group-major), s fp32 [N][G],
// out [M, N] in x's type. All contiguous; x, xq and q 16-byte aligned, out 8-byte aligned; gsz a
// multiple of 32 (each 32-deep k step in one group; the wrapper refuses other group sizes),
// K = G · gsz, N a multiple of 8, any M.
extern "C" int ovla_w4a8_grouped(const void* x, void* xq, void* sx, const void* q, const void* s,
                                 void* out, int M, int N, int G, int gsz, int is_bf16,
                                 void* stream) {
  if (ovla_w4g::refuses(M, N, G, gsz, xq, q, s, out)) return int(cudaErrorInvalidValue);
  const int err = ovla_w4a8_grouped_quant_rows(x, xq, sx, M, G * gsz, is_bf16, stream);
  if (err != 0) return err;
  return ovla_w4g::gemm(xq, sx, q, s, out, M, N, G, gsz, is_bf16,
                        static_cast<cudaStream_t>(stream));
}
