// vit_attention: unmasked bidirectional attention for the ViT towers.
//
// Replaces the TPU kernel openvla_probe_tpu/ops/attention.py::_vit_flash_kernel
// (reached through vit_flash_attention). Semantics kept exactly: q is upcast to
// fp32 and scaled BEFORE the dot; s = q . fp32(k) in fp32; p = expf(s - m)
// stays fp32; pv = p . fp32(v) in fp32; out = pv / max(l, 1e-30) cast to the
// input type. The TPU kernel padded keys to a multiple of 128 in VMEM and
// masked col < N; here the loops simply stop at N, which is the same function.
// Any N: past 1024 tokens (DINOv2-L at its 518 px pretraining size has 1370)
// the keys run in chunks of at most 1024 with an online max / sum rescale
// (attention_common.cuh): the TPU kernel holds every key's score in VMEM at
// once, a block's shared memory holds 1024 of them.
//
// Bound on the H100 at the OpenVLA-7B tower shapes (B=24; DINOv2 [24, 261, 16,
// 64], SigLIP [24, 256, 16, 72], bf16): the dot is full fp32 by definition (no
// TF32), ~6.7 / 7.2 GFLOP per layer against 67 TFLOP/s of fp32 FMA (100 / 108
// us), while q/k/v/out are only ~51 / 57 MB (15 / 17 us at 3.35 TB/s), so it is
// bound by fp32 operations. The design keeps the whole per-(b, h) problem on
// chip (scores never touch device memory) and feeds scalar fp32 FMAs from
// shared memory; Dh = 64 and 72 (not a power of two) are compile-time
// instances with float4 reads and a Dh + 4 staging pitch, N = 261 is a runtime
// loop bound (attention_common.cuh).
#include "attention_common.cuh"

namespace ovla {

// The towers' head dims (DINOv2 64, SigLIP 72) get compile-time instances.
template <typename T>
int launch_vit(const AttnArgs& a, cudaStream_t s) {
  switch (a.Dh) {
    case 64: return launch_attention_rows<T, true, false, 64>(a, s);
    case 72: return launch_attention_rows<T, true, false, 72>(a, s);
    default: return launch_attention_rows<T, true, false>(a, s);
  }
}

}  // namespace ovla

extern "C" int ovla_vit_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int N, int Dh, long long q_sb, long long q_st,
                                  long long k_sb, long long k_st, long long v_sb,
                                  long long v_st, float scale, int is_bf16, void* stream) {
  ovla::AttnArgs a{q, k, v, o, nullptr, B, H, N, N, Dh, q_sb, q_st,
                   k_sb, k_st, v_sb, v_st, scale, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ovla::launch_vit<__nv_bfloat16>(a, s) : ovla::launch_vit<float>(a, s);
}
