// w8a8_matmul: out[M, N] = cast((f32(Σ_k x8[m, k] · q8[n, k]) · s_x[m]) · s[n]), per-row int8
// activation codes times per-channel int8 weight codes.
//
// Replaces the XLA op openvla_probe_tpu/ops/linear.py::_w8a8_dot (the turbo tier's int8 linears,
// the prefill of nibble weights through _nib_matmul, the int4 requant route) and the prequant
// branch of its matmul_t (codes handed over by the fused RMSNorm -> int8 kernel). Semantics kept
// bit for bit:
//   * per-row codes clip(rint(x / s_x), -127, 127) with s_x = max(max|x| / 127, 1e-8) and IEEE
//     divisions (round half to even, as jnp.round), or the given codes and scales;
//   * the exact int32 product (|sum| <= 127² · K < 2³¹ for K < 133,000), so no order of its
//     terms, no split of K and no order of adding the splits changes a bit;
//   * out = cast((f32(acc) · s_x) · s), the conversion and the two products each rounded once
//     (the _rn intrinsics: nvcc would not contract them, but they say so).
// Weight codes come in one of two forms:
//   * int8 [N, K];
//   * two nibble planes hi, lo, packed uint8 [N, K / 2] (byte j: code 2j in its low nibble,
//     2j + 1 in its high nibble, two's complement), whose exact int8 codes 16·hi + lo + 8 the
//     loader rebuilds in registers (openvla_probe_tpu/ops/linear.py::nibble_reconstruct_q8 fused
//     in; int8_mma.cuh rebuild). The same codes give the same output in both forms.
//
// Bound on the H100 at the OpenVLA-7B shapes: prefill and towers (M = 6144-6912) and train
// steps (M = 2560) by int8 tensor-core operations, 0.117 ms for 6912 x 4096 x 4096 at
// 1979 TOP/s; decode (M = 24) by the weight stream, 16.8 MB per 4096 x 4096 launch (5.0 us at
// 3.35 TB/s). The earlier kernels (mma.sync from ldmatrix fragments, every thread's cp.async
// copies, one barrier a chunk) took 0.480 ms (int8) and 0.573 (nibble) at 6912 x 4096 x 4096
// and 0.027 at 24 x 4096 x 4096 on an H100 80GB HBM3 at 700 W (PERF.md §6).
//
// One call makes one or two launches: for float activations the pre-pass (quant_rows,
// int8_mma.cuh) writes the codes [M, K] and s_x [M] (for nibble planes each 32-code block in
// the stored_offset k order the packed fragments take); then one of two GEMM routes.
//
// M > 64 (prefill, towers, train steps): int8 wgmma fed by TMA, warp-specialized, on a
// persistent grid (one block an SM, tiles in turn). A tile is outᵀ: kBN = 128 weight rows (n)
// x kBM rows of activation codes (m, wgmma's N), so one skeleton serves both weight forms:
// int8 weights are wgmma's shared-memory operand A, nibble planes are rebuilt in registers
// straight into its register operand A (widening 4-bit codes into a shared-memory tile first
// cost 0.60-0.62 ms against 0.51 at 6912 x 4096 x 4096 in w4a8_matmul.cu), and the activation
// codes are its shared-memory operand B in their natural k order (or the pre-pass's permuted
// order for planes). 384 threads:
//   * a producer warpgroup that gives its registers to the consumers (setmaxnreg, as
//     wi8_matmul.cu), in which one thread keeps a ring of 128-deep k chunks full with TMA
//     boxes: activation codes [kBM rows][128 bytes] (128-byte swizzle; rows past M and k past
//     K zero-filled: SigLIP's K = 4304), and int8 weights [128 n][128 bytes] (128-byte
//     swizzle) or the hi and lo planes [128 n][64 bytes] each (64-byte swizzle: conflict-free
//     ldmatrix rows), on full / empty mbarriers; it runs on into the block's next tile while
//     the consumers store the last one;
//   * two consumer warpgroups of 64 weight rows x kBM rows, one int32 accumulator over all of
//     K (no group fold): per chunk four wgmma.m64nNk32.s32.s8.s8 committed as one group.
//     int8 leaves keep one group in flight: the consumer waits for the group before
//     (wgmma_wait<1>) and releases its stage, so the next chunk's wait and descriptors are
//     sent under the products (w4a8_matmul.cu waits for every chunk). The nibble loader
//     builds each chunk's fragments (two ldmatrix per plane a warp, `rebuild`) between groups
//     and waits for its group: ptxas serializes a register-A wgmma behind fragments written
//     while a group is in flight (C7513), and a second fragment buffer measured 1.5-2.3 %
//     slower than the wait; the other warpgroup's products run meanwhile;
//   * the epilogue applies s_x and s with the two _rn products and stores bf16 or fp32,
//     columns past N and rows past M masked.
//   int8: kBM = 256 (m64n256, 128 accumulators a thread, 4 stages of 48 KB); nibble: kBM = 192
//   (m64n192, 96 accumulators, 5 stages of 40 KB); 168 registers a thread either way, the
//   most ptxas gives a 384-thread block, no spill.
// What bounds it (knock-out builds timed by tools/kernel_ab.py on an H100 80GB HBM3 at 700 W,
// PERF.md §6): at 6912 x 4096 x 4096 on the prequant codes (0.185 ms) the ring's handoffs, not
// its bytes nor the products: with no products 0.176, with no activation-code loads (2/3 of
// the bytes) 0.178, with half the stages 0.244; then the epilogue's stores (none: 0.148).
// The persistent grid took 0-7 % off a grid of one block a tile at the prefill shapes (and
// added up to 3 % at three of the towers' eight).
// M <= 64 (decode steps, lm_head): the split-K decode route of int8_decode.cuh, int8 codes or
// the two planes rebuilt in registers.
#include "int8_decode.cuh"

namespace ovla_w8 {

namespace hp = ovla_hp;
using ovla_i8::ldmatrix_x4;
using ovla_i8d::store1;

constexpr int kChunk = 128;                 // k per stage
constexpr int kBN = 128;                    // weight rows per block: two warpgroups of 64
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + a producer warpgroup (setmaxnreg)

template <bool NIB>
struct Pre {
  static constexpr int kBM = NIB ? 192 : 256;        // activation rows per block: wgmma's N
  static constexpr int kStages = NIB ? 5 : 4;
  static constexpr int kABytes = kBM * kChunk;       // activation codes of a stage
  static constexpr int kQBytes = kBN * kChunk;       // int8 [128][128], or hi then lo [128][64]
  static constexpr int kStage = kABytes + kQBytes;   // a multiple of 1024
  static constexpr int kAcc = kBM / 2;               // int32 accumulators a thread
  static constexpr size_t kSmem = 1024 + size_t(kStages) * kStage + 2 * kStages * 8;
};

#define OVLA_IACC8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[128] += A (64 x 32 int8 at `da`, K-major) · B (32 x 256 int8 at `db`, K-major)
__device__ __forceinline__ void wgmma_s8_ss_m64n256k32(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : OVLA_IACC8(0), OVLA_IACC8(8), OVLA_IACC8(16), OVLA_IACC8(24), OVLA_IACC8(32),
        OVLA_IACC8(40), OVLA_IACC8(48), OVLA_IACC8(56), OVLA_IACC8(64), OVLA_IACC8(72),
        OVLA_IACC8(80), OVLA_IACC8(88), OVLA_IACC8(96), OVLA_IACC8(104), OVLA_IACC8(112),
        OVLA_IACC8(120)
      : "l"(da), "l"(db), "n"(1));
}

// d[96] += A (4 registers: this thread's 16 x 32 int8 fragment of its warp's rows) ·
// B (32 x 192 int8 at `db`, K-major)
__device__ __forceinline__ void wgmma_s8_rs_m64n192k32(int (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p;\n"
      "}\n"
      : OVLA_IACC8(0), OVLA_IACC8(8), OVLA_IACC8(16), OVLA_IACC8(24), OVLA_IACC8(32),
        OVLA_IACC8(40), OVLA_IACC8(48), OVLA_IACC8(56), OVLA_IACC8(64), OVLA_IACC8(72),
        OVLA_IACC8(80), OVLA_IACC8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}
#undef OVLA_IACC8

template <typename T, bool NIB>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_lo, const float* __restrict__ sx,
                      const float* __restrict__ s, T* __restrict__ out, int M, int N, int K) {
  using P = Pre<NIB>;
  constexpr int S = P::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * P::kStage);
  uint64_t* empty = full + S;
  // tile t: weight rows (t % NT) · 128, activation rows (t / NT) · kBM; block b takes tiles
  // b, b + gridDim.x, ...
  const int NT = (N + kBN - 1) / kBN, tiles = NT * ((M + P::kBM - 1) / P::kBM);
  const int KC = (K + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hp::mbar_init(full + i, 1);    // the producer's arrival, then the stage's bytes
      hp::mbar_init(empty + i, 2);   // one thread of each consumer warpgroup
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // ---- producer: one thread keeps the ring of activation and weight tiles full, running
    // ahead into the block's next tile while the consumers store the last one
    if (tid == kConsumers) {
      int g = 0;   // the block's chunks so far, over its tiles: stage g % S, round g / S
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = (t % NT) * kBN, m0 = (t / NT) * P::kBM;
        for (int c = 0; c < KC; ++c, ++g) {
          const int slot = g % S;
          hp::mbar_wait(empty + slot, ((g / S) & 1) ^ 1);   // the first round passes
          uint8_t* st = ring + slot * P::kStage;
          hp::mbar_expect_tx(full + slot, P::kStage);
          hp::tma_load_2d(st, &tm_a, c * kChunk, m0, full + slot);
          if constexpr (NIB) {
            hp::tma_load_2d(st + P::kABytes, &tm_q, c * (kChunk / 2), n0, full + slot);
            hp::tma_load_2d(st + P::kABytes + kBN * kChunk / 2, &tm_lo, c * (kChunk / 2), n0,
                            full + slot);
          } else {
            hp::tma_load_2d(st + P::kABytes, &tm_q, c * kChunk, n0, full + slot);
          }
        }
      }
    }
    return;
  }

  // ---- two consumer warpgroups: weight rows 64 wg .. 64 wg + 63 of the tile x kBM rows
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g8;   // this thread's weight rows r0, r0 + 8

  int g = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = (t % NT) * kBN, m0 = (t / NT) * P::kBM;
    int d[P::kAcc];
#pragma unroll
    for (int i = 0; i < P::kAcc; ++i) d[i] = 0;
    for (int c = 0; c < KC; ++c, ++g) {
      const int slot = g % S;
      hp::mbar_wait(full + slot, (g / S) & 1);
      const uint8_t* as = ring + slot * P::kStage;   // B: the chunk's activation codes
      const uint8_t* qs = as + P::kABytes;            // A: the weights
      uint32_t f[4][4];   // nibble: the chunk's register fragments
      if constexpr (NIB) {
        // ldmatrix hands lane (g8, t4) the packed bytes 4 t4 .. 4 t4 + 3 of row g8 of the
        // 8-row group in k32 step kk (matrix kk; 16-byte chunk kk of row n stored at
        // kk ^ ((n >> 1) & 3)), i.e. its codes 8 t4 .. 8 t4 + 7 of each plane, rebuilt into
        // the fragment's k 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3 (the pre-pass's order)
        uint32_t ph[2][4], pl[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = wg * 64 + warp * 16 + 8 * h + (lane & 7);
          const int off = n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4);
          ldmatrix_x4(ph[h], qs + off);
          ldmatrix_x4(pl[h], qs + kBN * kChunk / 2 + off);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ovla_i8::rebuild(ph[0][kk], pl[0][kk], f[kk][0], f[kk][2]);   // rows g8
          ovla_i8::rebuild(ph[1][kk], pl[1][kk], f[kk][1], f[kk][3]);   // rows g8 + 8
        }
      }
      hp::fence_operands(d);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // k32 step kk: 32 bytes along each 128-byte row
        if constexpr (NIB)
          wgmma_s8_rs_m64n192k32(d, f[kk], hp::desc_sw128(as + kk * 32));
        else
          wgmma_s8_ss_m64n256k32(d, hp::desc_sw128(qs + wg * 64 * kChunk + kk * 32),
                                 hp::desc_sw128(as + kk * 32));
      }
      hp::wgmma_commit();
      if constexpr (NIB) {
        // ptxas serializes a register-A wgmma behind the next chunk's fragments anyway (C7513):
        // wait for this group and release its stage (1.5-2.3 % faster than a group in flight)
        hp::wgmma_wait<0>();
        hp::fence_operands(d);
        if (wt == 0) hp::mbar_arrive(empty + slot);
      } else {
        hp::wgmma_wait<1>();   // the group before this one is done: release its stage
        hp::fence_operands(d);
        if (c > 0 && wt == 0) hp::mbar_arrive(empty + (g - 1) % S);
      }
    }
    if constexpr (!NIB) {
      hp::wgmma_wait<0>();
      hp::fence_operands(d);
      if (wt == 0) hp::mbar_arrive(empty + (g - 1) % S);   // the tile's last stage
    }

    // accumulator block j (activation rows 8 j .. 8 j + 7): weight rows r0 (e < 2), r0 + 8;
    // activation rows 8 j + 2 t4 + (e & 1)
    const int n = n0 + r0;
    const float s0 = n < N ? s[n] : 0.f, s8 = n + 8 < N ? s[n + 8] : 0.f;
#pragma unroll
    for (int j = 0; j < P::kBM / 8; ++j) {
      const int m = m0 + 8 * j + 2 * t4;
      const float sm0 = m < M ? sx[m] : 0.f, sm1 = m + 1 < M ? sx[m + 1] : 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mm = m + (e & 1), nn = n + 8 * (e >> 1);
        if (mm < M && nn < N)
          store1(out + (long long)mm * N + nn,
                 __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + e]), (e & 1) ? sm1 : sm0),
                           (e >> 1) ? s8 : s0));
      }
    }
  }
}

template <typename T, bool NIB>
int launch_wgmma(const int8_t* xq, const float* sx, const uint8_t* q, const uint8_t* lo,
                 const float* s, T* out, int M, int N, int K, cudaStream_t stream) {
  using P = Pre<NIB>;
  CUtensorMap tm_a, tm_q, tm_lo;
  const uint64_t qcols = NIB ? K / 2 : K;
  const uint32_t qbox = NIB ? kChunk / 2 : kChunk;
  const CUtensorMapSwizzle qsw = NIB ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!hp::encode_2d(&tm_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, M, K, K, P::kBM, kChunk,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::encode_2d(&tm_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, qcols, qcols, kBN, qbox, qsw) ||
      (NIB && !hp::encode_2d(&tm_lo, CU_TENSOR_MAP_DATA_TYPE_UINT8, lo, N, qcols, qcols, kBN,
                             qbox, qsw)))
    return int(cudaErrorInvalidValue);
  if (!NIB) tm_lo = tm_q;   // unused
  auto kernel = w8a8_wgmma_kernel<T, NIB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(P::kSmem));
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)((N + kBN - 1) / kBN) * ((M + P::kBM - 1) / P::kBM);
  const int sms = hp::sm_count();
  const int grid = int(tiles < sms ? tiles : sms);   // one persistent block an SM
  kernel<<<grid, kThreads, P::kSmem, stream>>>(tm_a, tm_q, tm_lo, sx, s, out, M, N, K);
  return int(cudaGetLastError());
}

template <typename T>
int run(const int8_t* xq, const float* sx, const uint8_t* q, const uint8_t* lo, const float* s,
        void* out, int M, int N, int K, cudaStream_t stream) {
  namespace d = ovla_i8d;
  T* o = static_cast<T*>(out);
  if (M <= 64) {
    const d::EpiW8 epi{sx, s};
    return lo ? d::launch<d::W::kNibble>(xq, q, lo, epi, o, M, N, K, stream)
              : d::launch<d::W::kInt8>(xq, q, lo, epi, o, M, N, K, stream);
  }
  return lo ? launch_wgmma<T, true>(xq, sx, q, lo, s, o, M, N, K, stream)
            : launch_wgmma<T, false>(xq, sx, q, lo, s, o, M, N, K, stream);
}

}  // namespace ovla_w8

namespace {
bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }
}  // namespace

// Returns the launches' cudaError_t (0 on success). x_kind: 0 = the codes xq int8 [M, K] and
// scales sx fp32 [M] are given (x unused), 1 = x fp32 [M, K], 2 = x bf16 [M, K], whose codes and
// scales the pre-pass writes into xq and sx. q: int8 codes [N, K] when lo is null, else the hi
// plane, lo the lo plane, both packed uint8 [N, K / 2], with float activations only. s fp32
// [N]; out [M, N], bf16 when out_bf16 else fp32. All contiguous; x, xq, q and lo 16-byte
// aligned (the TMA maps); K a multiple of 16 (of 32 for planes), N a multiple of 8; M up to
// 65535 · 192 (the tile count stays an int).
extern "C" int ovla_w8a8_matmul(const void* x, void* xq, void* sx, const void* q, const void* lo,
                                const void* s, void* out, int M, int N, int K, int x_kind,
                                int out_bf16, void* stream) {
  if (M < 1 || N < 8 || N % 8 != 0 || K < 16 || K % (lo ? 32 : 16) != 0 || x_kind < 0 ||
      x_kind > 2 || (x_kind && !x) || (lo && !x_kind) || (M + 191) / 192 > 65535 ||
      misaligned(x) || misaligned(xq) || misaligned(q) || misaligned(lo))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* codes = static_cast<int8_t*>(xq);
  float* scales = static_cast<float*>(sx);
  if (x_kind) {
    // for nibble planes, the codes in the k order of the packed-code fragments
    using ovla_i8::quant_rows;
    cudaError_t err;
    if (x_kind == 2)
      err = lo ? quant_rows<__nv_bfloat16, true, false>(x, codes, scales, nullptr, M, K, st)
               : quant_rows<__nv_bfloat16, false, false>(x, codes, scales, nullptr, M, K, st);
    else
      err = lo ? quant_rows<float, true, false>(x, codes, scales, nullptr, M, K, st)
               : quant_rows<float, false, false>(x, codes, scales, nullptr, M, K, st);
    if (err != cudaSuccess) return int(err);
  }
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const uint8_t* lp = static_cast<const uint8_t*>(lo);
  const float* sp = static_cast<const float*>(s);
  if (out_bf16) return ovla_w8::run<__nv_bfloat16>(codes, scales, qp, lp, sp, out, M, N, K, st);
  return ovla_w8::run<float>(codes, scales, qp, lp, sp, out, M, N, K, st);
}
