// wi8_matmul: out[M, N] = cast((x[M, K] · bf16(q[N, K])ᵀ in fp32) · s[N]), the
// weight-only int8 matmul of the int8 serving tiers.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/linear.py::_wi8_kernel (reached
// through _wi8_matmul_2d from matmul_t for every per-channel int8 leaf under
// the kernel gate). Semantics kept: the int8 codes widen to bf16 exactly, so
// every product is the TPU's; the sum is fp32 (only its order differs); the
// per-channel scale multiplies the fp32 sum; one cast to x's type at the end.
//
// Bound on the H100 at the OpenVLA-7B shapes:
//   * prefill, M = 6912 (B = 24 x T = 288), (K, N) in {(4096, 4096),
//     (4096, 11008), (11008, 4096)}: 0.23-0.62 TFLOP per launch against
//     57-163 MB, so it is bound by bf16 tensor-core operations (0.23-0.63 ms
//     at 989 TFLOP/s);
//   * decode and lm_head, M = 24: the int8 weight stream (16.8-131 MB per
//     launch, 6.6 GB per decode step) bounds it at 5-39 us per launch, about
//     2 ms per step at 3.35 TB/s.
//
// Design. x and q tiles go global -> shared memory with cp.async (16-byte
// copies, zero-filled past the M, N and K edges) in a multi-stage ring, the
// int8 codes as int8 (half the bytes of bf16).
//   * M > 64 (prefill): Hopper's warpgroup MMA (wgmma m64n128k16 bf16 ->
//     fp32). 128 (n) x 128 (m) x 64 (k) tiles, two warpgroups of 64 weight
//     rows each, 4 stages (three k-tiles of loads in flight); two blocks
//     share an SM, so one block's fragment building overlaps the other's
//     products. The
//     product is taken transposed so the weights are the register-sourced A
//     operand: each warp widens its own codes straight into bf16 fragments,
//     and x (K-major, 128-byte swizzle) is read by the tensor cores from
//     shared memory.
//   * M <= 64 (decode, lm_head): mma.sync m16n8k16; 32 x 32 x 256 tiles, 4
//     warps of 32 x 8, 4 stages: narrow N tiles put 128-1002 blocks on the
//     132 SMs and deep K stages keep ~24 KB of weights in flight per block;
//     the codes widen to bf16 as each warp loads its B fragments (each warp
//     owns its own columns, so no code is widened twice).
// fp32 activations (the tiny test configurations) take a scalar fp32-FMA
// kernel: a bf16 product would round x. TMA, a warp-specialized persistent
// schedule and split-K for the 4096-wide decode products are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace ovla {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes past `src_bytes` (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two neighbouring int8 codes -> packed bf16x2 (exact), lower k in the low half
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  __nv_bfloat162 h = __floats2bfloat162_rn(float(c.x), float(c.y));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* out, int M, int N, int m, int n,
                                           float v0, float v1) {
  if (m >= M) return;
  __nv_bfloat16* o = out + (long long)m * N + n;
  if (n + 1 < N && (N % 2) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (n < N) o[0] = __float2bfloat16(v0);
    if (n + 1 < N) o[1] = __float2bfloat16(v1);
  }
}

// ---------------------------------------------------------------------------
// M > 64: warpgroup MMA

// The product is computed transposed, D'[n, m] = q[n, :] · x[m, :], so that
// the int8 weights are wgmma's A operand, which may come from registers: each
// warp widens its own 16 rows of codes to bf16 fragments in registers (every
// code once, no shared-memory round trip), and x is the B operand, read from
// shared memory through a descriptor.
constexpr int kGBN = 128, kGBM = 128, kGBK = 64, kGStages = 4, kGThreads = 256;
// x tile [128 m][64 k] bf16: one 128-byte row per m, in 8-row atoms of 1024
// bytes with the 128-byte swizzle (16-byte chunk c of row r stored at chunk
// c ^ (r % 8)), the K-major layout wgmma reads without bank conflicts
constexpr int kAtom = 1024;
constexpr int kGXBytes = kGBM * kGBK * 2;    // one x stage (16 KB)
constexpr int kGQP = kGBK + 16;              // int8 q stage row pitch (conflict-free fragments)
constexpr int kGQBytes = kGBN * kGQP;        // one int8 q stage
constexpr size_t kGSmem = kAtom /* alignment slack */ + kGStages * (kGXBytes + kGQBytes);

__device__ __forceinline__ int swizzled(int r, int chunk) {   // chunk = k / 8
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}

// K-major operand, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  return (uint64_t((smem_u32(p) & 0x3FFFF) >> 4)) | (uint64_t(1) << 16) |
         (uint64_t(kAtom >> 4) << 32) | (uint64_t(1) << 62);
}

#define OVLA_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                     "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] += A[64 x 16] (bf16 fragments in registers) · B[16 x 128] (bf16, shared memory)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : OVLA_ACC8(0), OVLA_ACC8(8), OVLA_ACC8(16), OVLA_ACC8(24), OVLA_ACC8(32),
        OVLA_ACC8(40), OVLA_ACC8(48), OVLA_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef OVLA_ACC8

// Pin the accumulators around the k loop: the compiler may not move their
// accesses across this point. Used only where no wgmma is in flight (a
// non-wgmma definition of an in-flight operand makes ptxas serialize wgmma).
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_load_stage(uint8_t* xs, int8_t* qs,
                                                 const __nv_bfloat16* x, const int8_t* q,
                                                 int M, int N, int K, int m0, int n0, int k0) {
  // x: thread i -> row i / 8, chunk i % 8: a warp reads 4 whole 128-byte rows,
  // and the swizzle spreads each 8 threads' chunks over all 32 banks
  for (int i = threadIdx.x; i < kGBM * (kGBK / 8); i += kGThreads) {
    const int r = i >> 3, c = i & 7, m = m0 + r, k = k0 + c * 8;
    const bool ok = m < M && k < K;
    cp_async16(xs + swizzled(r, c), ok ? x + (long long)m * K + k : x, ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < kGBN * (kGBK / 16); i += kGThreads) {
    const int r = i / (kGBK / 16), c = i % (kGBK / 16), n = n0 + r, k = k0 + c * 16;
    const bool ok = n < N && k < K;
    cp_async16(qs + r * kGQP + c * 16, ok ? q + (long long)n * K + k : q, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kGThreads, 2)
    wi8_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                     const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int M, int N,
                     int K) {
  extern __shared__ __align__(128) uint8_t wg_smem_raw[];
  // the swizzle atoms need 1024-byte aligned tiles
  uint8_t* xs = wg_smem_raw + ((kAtom - (smem_u32(wg_smem_raw) & (kAtom - 1))) & (kAtom - 1));
  int8_t* qs = reinterpret_cast<int8_t*>(xs + kGStages * kGXBytes);   // [stages] int8 q tiles
  const int n0 = blockIdx.x * kGBN, m0 = blockIdx.y * kGBM;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int KT = (K + kGBK - 1) / kGBK;
  const int qrow = wg * 64 + warp * 16 + g;   // this thread's fragment rows: qrow, qrow + 8

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_regs(d);   // only wgmma touches d from here to the end of the k loop

#pragma unroll
  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < KT)
      wgmma_load_stage(xs + st * kGXBytes, qs + st * kGQBytes, x, q, M, N, K, m0, n0,
                       st * kGBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kGStages - 2>();   // this thread's copies of stage kt landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // every copy of stage kt landed; every product of k-tile kt - 1 done
    const int nxt = kt + kGStages - 1;   // into k-tile kt - 1's slot
    if (nxt < KT)
      wgmma_load_stage(xs + (nxt % kGStages) * kGXBytes, qs + (nxt % kGStages) * kGQBytes, x,
                       q, M, N, K, m0, n0, nxt * kGBK);
    cp_async_commit();

    // A fragments (rows qrow, qrow + 8) of the stage's four k16 steps, built
    // before the products start: no register of an in-flight wgmma is
    // written by another instruction, so ptxas keeps the four pipelined
    uint32_t af[4][4];
    const int8_t* qst = qs + (kt % kGStages) * kGQBytes;
#pragma unroll
    for (int kk = 0; kk < kGBK / 16; ++kk) {
      const int8_t* r0 = qst + qrow * kGQP + kk * 16 + 2 * t4;
      af[kk][0] = i8x2_to_bf16x2(r0);
      af[kk][1] = i8x2_to_bf16x2(r0 + 8 * kGQP);
      af[kk][2] = i8x2_to_bf16x2(r0 + 8);
      af[kk][3] = i8x2_to_bf16x2(r0 + 8 * kGQP + 8);
    }
    const uint8_t* xb = xs + (kt % kGStages) * kGXBytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kGBK / 16; ++kk)   // k16 step kk: 32 bytes along each x row
      wgmma_m64n128k16_rs(d, af[kk], gmma_desc(xb + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  fence_regs(d);
  cp_async_wait<0>();

  // D' layout: n8 tile j holds D'[rows qrow, qrow + 8][columns 8 j + 2 t4, + 1],
  // i.e. out[m = m0 + 8 j + 2 t4 (+1)][n = n0 + qrow (+8)]
  const int n = n0 + qrow;
  const float s0 = n < N ? s[n] : 0.f, s8 = n + 8 < N ? s[n + 8] : 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int m = m0 + j * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int mm = m + (e & 1), nn = n + (e >> 1) * 8;
      if (mm < M && nn < N)
        out[(long long)mm * N + nn] = __float2bfloat16(d[4 * j + e] * ((e >> 1) ? s8 : s0));
    }
  }
}

// ---------------------------------------------------------------------------
// M <= 64: mma.sync

constexpr int kSBM = 32, kSBN = 32, kSBK = 256, kSStages = 4, kSThreads = 128;
constexpr int kSXP = kSBK + 8;    // x tile pitch (bf16): 16-byte skew
constexpr int kSQP = kSBK + 16;   // q tile pitch (bytes)
constexpr size_t kSSmem = kSStages * (kSBM * kSXP * sizeof(__nv_bfloat16) + kSBN * kSQP);

__global__ void __launch_bounds__(kSThreads)
    wi8_small_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                     const float* __restrict__ s, __nv_bfloat16* __restrict__ out, int M, int N,
                     int K) {
  extern __shared__ __align__(16) uint8_t sm_smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sm_smem);    // [stages][32][kSXP]
  int8_t* qs = reinterpret_cast<int8_t*>(xs + kSStages * kSBM * kSXP);   // [stages][32][kSQP]
  const int n0 = blockIdx.x * kSBN, m0 = blockIdx.y * kSBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int KT = (K + kSBK - 1) / kSBK;

  auto load = [&](int kt) {
    __nv_bfloat16* xd = xs + (kt % kSStages) * kSBM * kSXP;
    int8_t* qd = qs + (kt % kSStages) * kSBN * kSQP;
    const int k0 = kt * kSBK;
    for (int i = threadIdx.x; i < kSBM * (kSBK / 8); i += kSThreads) {
      const int r = i / (kSBK / 8), c = i % (kSBK / 8), m = m0 + r, k = k0 + c * 8;
      const bool ok = m < M && k < K;
      cp_async16(xd + r * kSXP + c * 8, ok ? x + (long long)m * K + k : x, ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < kSBN * (kSBK / 16); i += kSThreads) {
      const int r = i / (kSBK / 16), c = i % (kSBK / 16), n = n0 + r, k = k0 + c * 16;
      const bool ok = n < N && k < K;
      cp_async16(qd + r * kSQP + c * 16, ok ? q + (long long)n * K + k : q, ok ? 16 : 0);
    }
  };

  float acc[2][4] = {};   // m16 tiles 0, 1 x the warp's n8 tile
#pragma unroll
  for (int st = 0; st < kSStages - 1; ++st) {
    if (st < KT) load(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kSStages - 2>();
    __syncthreads();   // stage kt landed for every thread; stage kt - 1 fully consumed
    if (kt + kSStages - 1 < KT) load(kt + kSStages - 1);
    cp_async_commit();
    const __nv_bfloat16* xst = xs + (kt % kSStages) * kSBM * kSXP;
    const int8_t* qst = qs + (kt % kSStages) * kSBN * kSQP;
#pragma unroll
    for (int kk = 0; kk < kSBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], xst + (i * 16 + lane % 16) * kSXP + kk + (lane / 16) * 8);
      const int8_t* qb = qst + (warp * 8 + g) * kSQP + kk + 2 * t4;
      const uint32_t b0 = i8x2_to_bf16x2(qb), b1 = i8x2_to_bf16x2(qb + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_bf16_16816(acc[i], a[i], b0, b1);
    }
  }
  cp_async_wait<0>();

  const int n = n0 + warp * 8 + 2 * t4;
  const float s0 = n < N ? s[n] : 0.f, s1 = n + 1 < N ? s[n + 1] : 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    store_pair(out, M, N, m0 + i * 16 + g, n, acc[i][0] * s0, acc[i][1] * s1);
    store_pair(out, M, N, m0 + i * 16 + g + 8, n, acc[i][2] * s0, acc[i][3] * s1);
  }
}

// ---------------------------------------------------------------------------
// fp32 activations: 16 x 16 outputs per block, one per thread, K staged by 16

constexpr int kF32Tile = 16;

__global__ void __launch_bounds__(kF32Tile* kF32Tile)
    wi8_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, float* __restrict__ out, int M, int N, int K) {
  __shared__ float xs[kF32Tile][kF32Tile + 1];
  __shared__ float qs[kF32Tile][kF32Tile + 1];
  const int tx = threadIdx.x % kF32Tile, ty = threadIdx.x / kF32Tile;
  const int m = blockIdx.y * kF32Tile + ty, n = blockIdx.x * kF32Tile + tx;
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += kF32Tile) {
    const int mr = blockIdx.y * kF32Tile + ty, nr = blockIdx.x * kF32Tile + ty;
    xs[ty][tx] = (mr < M && k0 + tx < K) ? x[(long long)mr * K + k0 + tx] : 0.f;
    qs[ty][tx] = (nr < N && k0 + tx < K) ? float(q[(long long)nr * K + k0 + tx]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32Tile; ++kk) acc = fmaf(xs[ty][kk], qs[tx][kk], acc);
    __syncthreads();
  }
  if (m < M && n < N) out[(long long)m * N + n] = acc * s[n];
}

template <class Kernel>
int launch_tiled(Kernel kernel, size_t smem, int threads, int bm, int bn, const void* x,
                 const int8_t* q, const float* s, void* out, int M, int N, int K,
                 cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const __nv_bfloat16*>(x), q, s,
                                          static_cast<__nv_bfloat16*>(out), M, N, K);
  return int(cudaGetLastError());
}

}  // namespace ovla

// Returns the launch's cudaError_t (0 on success). x, q, s, out contiguous;
// K a multiple of 16 (16-byte rows of q); x, q and out 16-byte aligned.
extern "C" int ovla_wi8_matmul(const void* x, const void* q, const void* s, void* out, int M,
                               int N, int K, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(s);
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0) return int(cudaErrorInvalidValue);
  if (!is_bf16) {
    const dim3 grid((N + ovla::kF32Tile - 1) / ovla::kF32Tile,
                    (M + ovla::kF32Tile - 1) / ovla::kF32Tile);
    ovla::wi8_f32_kernel<<<grid, ovla::kF32Tile * ovla::kF32Tile, 0, st>>>(
        static_cast<const float*>(x), qi, sf, static_cast<float*>(out), M, N, K);
    return int(cudaGetLastError());
  }
  if (M <= 64)
    return ovla::launch_tiled(ovla::wi8_small_kernel, ovla::kSSmem, ovla::kSThreads, ovla::kSBM,
                              ovla::kSBN, x, qi, sf, out, M, N, K, st);
  return ovla::launch_tiled(ovla::wi8_wgmma_kernel, ovla::kGSmem, ovla::kGThreads, ovla::kGBM,
                            ovla::kGBN, x, qi, sf, out, M, N, K, st);
}
