// w4a8_dx: the straight-through backward of the grouped-int4 products,
// dx = g · dequant(W), with the weight dequantized on chip.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/linear.py::_w4a8_dx_kernel
// (reached through _w4a8_dx_pallas from _w4a8_ste_bwd, the backward of both
// w4a8 forwards). Semantics kept exactly:
//   dx[m, gi·gsz + j] = Σ_n bf16(g[m, n] · s[n, gi]) · code[gi, n, j]
// the scaled gradient rounded to bf16 (round to nearest even) even where g is
// fp32, the codes widened to bf16 exactly, bf16 products (exact in fp32)
// summed in fp32 over all N, the sum cast to g's type. Only the order of the
// fp32 sums differs from the TPU kernel (and from w4a8_dx_plain).
//
// Layouts: g [M, N] row-major (bf16 or fp32); q uint8 [G, N, gsz/2], the
// port's packed int4 codes (byte b of a row: code 2b in its low nibble, 2b + 1
// in its high nibble, two's complement); s_t fp32 [G, N], the scales
// transposed by the wrapper (s [N, G] is one small copy away); dx [M, G·gsz]
// in g's type. The kernel takes N and gsz multiples of 128 (the JAX chip
// rule) and 16-byte aligned g, q and s_t; the wrapper sends the rest to the
// bf16-dequant product in PyTorch, and a launch the kernel refuses raises.
//
// Bound on the H100 at the OpenVLA-7B QLoRA shapes (B = 8, T = 320, M = 2560;
// g [2560, 4096] against 32 groups of [4096, 128] codes, g [2560, 11008]
// against 32 of [11008, 128], g [2560, 4096] against 86 of [4096, 128]): 86,
// 231 and 231 GFLOP of bf16 products (0.087 / 0.233 / 0.233 ms at
// 989 TFLOP/s) against 37, 79 and 37 MB of g, codes, scales and dx
// (0.011-0.024 ms at 3.35 TB/s): bound by the tensor cores' operations.
//
// Design: wgmma fed by a TMA ring, warp-specialized. A block owns one
// [128, 128] tile of dx: 128 rows of M and 128 columns of one group (gsz a
// multiple of 128, so the scale is a per-n vector inside the tile). 288
// threads: two consumer warpgroups (64 rows each) and one producer warp.
//   * One producer thread keeps a ring of kStages = 4 stages in flight, each
//     one 64-deep chunk of N: the g tile [128 m][64 n] (a TMA box, 128-byte
//     swizzle, rows past M zero-filled by the TMA unit), the packed codes
//     [64 n][64 bytes] (a TMA box) and the stage's scale vector
//     s_t[gi, n0:n0+64] (a bulk copy), all completing on the stage's "full"
//     mbarrier by their byte count. The consumers release a stage through its
//     "empty" mbarrier. (A ring filled by one warp's cp.async copies ran at
//     1.4 TB/s and bounded the kernel: every copy was one thread's 16 bytes.)
//   * The transform on chip is way (a): A = bf16(g · s) is built in registers
//     from the staged g tile (fp32 product, then RNE: the same rounding per
//     (m, n) as the TPU kernel), as the register-A operand of
//     wgmma.m64n128k16 bf16 x bf16 -> fp32. B = the codes widened to bf16 in
//     shared memory, stored [n][j] and read as an MN-major B (no transpose):
//     8 x 8 core matrices of 8 n-rows of 16 bytes, the 8 n-cores of a column
//     block contiguous (LBO = 128 bytes along n), the 16 column blocks 1024
//     bytes apart (SBO). Each consumer thread widens 32 codes per stage with
//     the magic number (code nibble c: ((c ^ 8) | 0x4300) read as bf16 is
//     128 + (c ^ 8), minus 136 gives the two's complement value, exact for
//     all 16 codes); fence.proxy.async makes the threads' stores visible to
//     wgmma, and a named barrier joins the two warpgroups before either
//     reads the tile.
//   * Each warpgroup issues a stage's 4 wgmma (k = 16 each) and then waits
//     only for the previous stage's, so one stage multiplies while the next
//     is widened and built (two register sets for A, kBBuffers = 3 B tiles).
//   * Blocks walk the column tiles (the groups) fastest, so the blocks in
//     flight share their g rows through L2; G = 86 leaves a partial last wave.
#include <cuda_bf16.h>

#include "hopper.cuh"   // mbarriers, TMA, the tensor-map encoder, wgmma descriptors

namespace ovla_dx {

using namespace ovla_hp;

constexpr int kBM = 128;             // rows of M per block: 2 warpgroups x 64
constexpr int kBJ = 128;             // dx columns per block (one group's slice)
constexpr int kBN = 64;              // n per stage
constexpr int kStages = 4;           // ring depth
constexpr int kBBuffers = 3;         // widened B tiles
constexpr int kWgmmaInFlight = 1;    // stages of wgmma left in flight
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kBBytes = kBN * kBJ * 2;      // one widened B tile, bf16
constexpr int kNCore = 128;          // B tile: bytes between core matrices along n (K)
constexpr int kJCore = 1024;         // and along j (N): the 8 n-cores of a column block
// the descriptor's leading (LBO) and stride (SBO) byte offsets: for an
// unswizzled MN-major operand, LBO steps along K and SBO along M / N
constexpr uint32_t kLBO = kNCore, kSBO = kJCore;
constexpr int kCodeBytes = kBN * 64;        // the stage's codes: [64 n][64 bytes]

template <typename T>
struct Layout {
  static constexpr int G_BYTES = kBM * kBN * int(sizeof(T));   // 128-byte rows, swizzled
  static constexpr int STAGE = (G_BYTES + kCodeBytes + kBN * 4 + 1023) / 1024 * 1024;
  static constexpr int TX_BYTES = G_BYTES + kCodeBytes + kBN * 4;
  // + 1024: the base is rounded up to the 1024 bytes the 128-byte swizzle needs
  static constexpr size_t kSmem =
      1024 + size_t(kBBuffers) * kBBytes + size_t(kStages) * STAGE + 2 * kStages * 8;
};

// 8 packed codes (4 bytes; byte b: code 2b low nibble, 2b + 1 high nibble) ->
// 8 bf16 in order: ((c ^ 8) | 0x4300) is bf16 128 + (c ^ 8); minus 136 it is
// the sign-extended code, exactly
__device__ __forceinline__ uint4 widen8(uint32_t w) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x = __byte_perm(lo, hi, i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12));
    x = ((x & 0x000F000Fu) | 0x43004300u) ^ 0x00080008u;
    __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x), bias);
    r[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}
// g[r, n], g[r, n + 1] (n even) of a staged tile: 128-byte rows under the
// TMA's 128-byte swizzle (16-byte chunk k of row r stored at chunk k ^ (r % 8));
// fp32 rows are two boxes of 32 columns
__device__ __forceinline__ float2 g_pair(const __nv_bfloat16* gs, int r, int n) {
  const int off = r * 64 + ((((n >> 3) ^ r) & 7) << 3) + (n & 7);
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gs + off));
}
__device__ __forceinline__ float2 g_pair(const float* gs, int r, int n) {
  const int off = (n >> 5) * (kBM * 32) + r * 32 + (((((n & 31) >> 2) ^ r) & 7) << 2) + (n & 3);
  return *reinterpret_cast<const float2*>(gs + off);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the MN-major, unswizzled shared-memory descriptor of a B tile at `p`
__device__ __forceinline__ uint64_t b_desc(const void* p) { return desc_plain(p, kLBO, kSBO); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    w4a8_dx_kernel(const __grid_constant__ CUtensorMap tm_g,
                   const __grid_constant__ CUtensorMap tm_q, const float* __restrict__ s_t,
                   T* __restrict__ dx, int M, int N, int G, int gsz) {
  using L = Layout<T>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bbuf = smem;                                     // [kBBuffers][kBBytes]
  uint8_t* ring = smem + kBBuffers * kBBytes;               // [kStages][STAGE]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * L::STAGE);
  uint64_t* empty = full + kStages;

  const int col0 = blockIdx.x * kBJ, m0 = blockIdx.y * kBM;
  const int gi = col0 / gsz, j0 = col0 - gi * gsz;
  const int n_chunks = N / kBN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);    // the producer's arrival, then the stage's bytes
      mbar_init(empty + i, 1);   // one consumer thread, after both warpgroups read it
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread keeps the ring of g, code and scale tiles full ----
    if (tid == kConsumers) {
      for (int c = 0; c < n_chunks; ++c) {
        const int slot = c % kStages, n0 = c * kBN;
        mbar_wait(empty + slot, ((c / kStages) & 1) ^ 1);   // the first round passes
        uint8_t* st = ring + slot * L::STAGE;
        mbar_expect_tx(full + slot, L::TX_BYTES);
#pragma unroll
        for (int b = 0; b < int(sizeof(T)) / 2; ++b)   // fp32 rows: two 32-column boxes
          tma_load_2d(st + b * (kBM * 128), &tm_g, n0 + b * 32, m0, full + slot);
        tma_load_2d(st + L::G_BYTES, &tm_q, j0 / 2, gi * N + n0, full + slot);
        bulk_load(st + L::G_BYTES + kCodeBytes, s_t + (size_t)gi * N + n0, kBN * 4, full + slot);
      }
    }
  } else {
    // ---- two consumer warpgroups: 64 rows each ----
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int gq = lane >> 2, t4 = lane & 3;
    const int row0 = wg * 64 + warp * 16 + gq;   // this thread's rows: row0, row0 + 8
    const int wn = tid % kBN, wq = tid / kBN;    // widening: code row n, 32-code quarter
    float acc[64];   // written first by a wgmma that does not accumulate

    // stage c: widen its codes into B buffer c % 3, build its A fragments in
    // `a`, issue its wgmma, then wait for the stage before's: a buffer is
    // rewritten only after both warpgroups have passed the barrier of the
    // stage after its own, a register set after its wgmma is done
    auto stage = [&](int c, uint32_t (&a)[4][4]) {
      const int slot = c % kStages;
      mbar_wait(full + slot, (c / kStages) & 1);
      const uint8_t* st = ring + slot * L::STAGE;
      const T* gs = reinterpret_cast<const T*>(st);
      const uint8_t* cs = st + L::G_BYTES;
      const float* ss = reinterpret_cast<const float*>(cs + kCodeBytes);
      uint8_t* bt = bbuf + (c % kBBuffers) * kBBytes;

      // B: codes 32 wq .. 32 wq + 31 of row wn, widened into 4 core-matrix rows
      const uint4 w = *reinterpret_cast<const uint4*>(cs + wn * 64 + wq * 16);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cj = 4 * wq + e;   // column block of 8 j
        *reinterpret_cast<uint4*>(bt + cj * kJCore + (wn / 8) * kNCore + (wn % 8) * 16) =
            widen8(words[e]);
      }
      // A: bf16(g · s) for this thread's fragment of each 16-deep step
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + 8 * (i & 1), n = kk * 16 + 2 * t4 + 8 * (i >> 1);
          const float2 gv = g_pair(gs, r, n);
          const float2 sv = *reinterpret_cast<const float2*>(ss + n);
          a[kk][i] = pack_bf16(gv.x * sv.x, gv.y * sv.y);
        }
      }
      fence_proxy_async();
      named_barrier(1, kConsumers);
      if (tid == 0) mbar_arrive(empty + slot);   // both warpgroups are done with the stage

      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_rs_m64n128k16(acc, a[kk], b_desc(bt + kk * 2 * kNCore), c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<kWgmmaInFlight>();
      fence_operands(acc);
    };
    uint32_t a0[4][4], a1[4][4];
    for (int c = 0; c < n_chunks; c += 2) {   // n_chunks is even (N a multiple of 128)
      stage(c, a0);
      stage(c + 1, a1);
    }
    wgmma_wait<0>();
    fence_operands(acc);

    // accumulator block i (columns 8i .. 8i + 7): rows row0 / row0 + 8
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + row0 + 8 * hr;
      if (m >= M) continue;
      T* out = dx + (size_t)m * (size_t(G) * gsz) + col0 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 16; ++i) store2(out + 8 * i, acc[4 * i + 2 * hr], acc[4 * i + 2 * hr + 1]);
    }
  }
}

template <typename T>
int launch(const void* g, const void* q, const float* s_t, void* dx, int M, int N, int G,
           int gsz, cudaStream_t stream) {
  CUtensorMap tm_g, tm_q;
  const bool bf16 = sizeof(T) == 2;
  if (!encode_2d(&tm_g, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                 g, M, N, uint64_t(N) * sizeof(T), kBM, 128 / sizeof(T),
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, uint64_t(G) * N, gsz / 2, gsz / 2,
                 kBN, 64, CU_TENSOR_MAP_SWIZZLE_NONE))
    return int(cudaErrorInvalidValue);
  auto kernel = w4a8_dx_kernel<T>;
  const size_t smem = Layout<T>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(G * gsz / kBJ, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(tm_g, tm_q, s_t, static_cast<T*>(dx), M, N, G, gsz);
  return int(cudaGetLastError());
}

}  // namespace ovla_dx

// s_t: the scales transposed, fp32 [G, N]. Returns the launch's cudaError_t
// (0 on success); cudaErrorInvalidValue for shapes the kernel does not take
// (N or gsz not a multiple of 128, g, q or s_t not 16-byte aligned, M past the
// grid's 65535 row blocks) or when cuTensorMapEncodeTiled cannot be found.
extern "C" int ovla_w4a8_dx(const void* g, const void* q, const float* s_t, void* dx, int M,
                            int N, int G, int gsz, int is_bf16, void* stream) {
  auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (M < 1 || (M + ovla_dx::kBM - 1) / ovla_dx::kBM > 65535 || N < 128 || N % 128 ||
      gsz < 128 || gsz % 128 || G < 1 || misaligned(g) || misaligned(q) || misaligned(s_t))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ovla_dx::launch<__nv_bfloat16>(g, q, s_t, dx, M, N, G, gsz, st)
                 : ovla_dx::launch<float>(g, q, s_t, dx, M, N, G, gsz, st);
}
