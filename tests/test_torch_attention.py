"""Port attention (plain PyTorch versions of the CUDA kernels) vs the JAX
package's Pallas kernels in interpret mode, on the CPU.

Tolerances: fp32 inputs 1e-5 (the same fp32 sums in another order); bf16
inputs 2e-2 compared in fp32 (about 2 bf16 ulps at |x| <= 1: P and the output
are rounded to bf16 at places where the two sums may sit on opposite sides of
a rounding edge).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.ops import attention as jattn
from openvla_probe_tpu_torch.ops import attention as tattn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, Tq, Tk, H, Dh, dtype):
    r = np.random.default_rng(seed)
    arrs = [r.normal(size=(B, t, H, Dh)).astype(np.float32) for t in (Tq, Tk, Tk)]
    jax_in = [jnp.asarray(a, JNP_DT[dtype]) for a in arrs]
    # hand both sides the same (already bf16-rounded) values
    torch_in = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(TORCH_DT[dtype])
                for a in jax_in]
    return jax_in, torch_in


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,offset,causal", [
    (16, 24, 0, True),      # cached-prefill geometry: Tq < Tk, future slots invalid
    (13, 21, 0, True),      # Tq not a multiple of 8
    (13, 21, 8, True),      # causal offset (query 0 sits at position 8)
    (12, 12, 0, False),     # padding-only mask
])
def test_flash_plain_matches_jax_kernel(dtype, tq, tk, offset, causal):
    B, H, Dh = 2, 2, 8
    (jq, jk, jv), (tq_, tk_, tv_) = _qkv(1, B, tq, tk, H, Dh, dtype)
    valid = np.ones((B, tk), np.int32)
    valid[0, tq:] = 0          # slots past the prompt
    valid[1, tq - 3:] = 0      # right-padded prompt
    want = jattn.flash_attention(jq, jk, jv, jnp.asarray(valid), offset=offset,
                                 causal=causal, interpret=True)
    got = tattn.flash_attention(tq_, tk_, tv_, torch.from_numpy(valid), offset=offset,
                                causal=causal)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, tq, H, Dh)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype], rtol=TOL[dtype])


def test_flash_fully_masked_rows():
    """A row with every key masked: the port (and the JAX package's XLA
    attention) gives the mean of V over the Tk keys. The JAX one-shot kernel
    also counts its VMEM pad columns (Tk rounded up to 8, then to 128) in the
    softmax denominator, so it gives sum(V) / 128 here. Rows with a valid key
    agree with the kernel."""
    B, Tq, Tk, H, Dh = 2, 10, 14, 2, 8
    (jq, jk, jv), (tq_, tk_, tv_) = _qkv(2, B, Tq, Tk, H, Dh, "float32")
    valid = np.ones((B, Tk), np.int32)
    valid[1, :3] = 0            # causal: queries 0..2 of row 1 see no valid key
    got = tattn.flash_attention(tq_, tk_, tv_, torch.from_numpy(valid)).numpy()
    kernel = np.asarray(jattn.flash_attention(jq, jk, jv, jnp.asarray(valid), interpret=True))
    mask = jllama.make_causal_mask(jnp.asarray(valid), Tq, Tk)
    xla = np.asarray(jllama.attention(jq, jk, jv, mask))
    v = np.asarray(jv)

    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], kernel[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1, 3:], kernel[1, 3:], atol=1e-5, rtol=1e-5)
    mean_v = v[1].mean(axis=0)                                       # [H, Dh]
    for row in range(3):
        np.testing.assert_allclose(got[1, row], mean_v, atol=1e-6)
        np.testing.assert_allclose(xla[1, row], mean_v, atol=1e-6)
        np.testing.assert_allclose(kernel[1, row], v[1].sum(axis=0) / 128, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 72])
def test_vit_plain_matches_jax_kernel(dtype, dh):
    B, N, H = 2, 13, 2
    (jq, jk, jv), (tq_, tk_, tv_) = _qkv(3, B, N, N, H, dh, dtype)
    want = jattn.vit_flash_attention(jq, jk, jv, interpret=True)
    got = tattn.vit_flash_attention(tq_, tk_, tv_)
    assert got.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax_xla_attention(dtype):
    """One decode query over an S-slot stacked cache: the JAX package's XLA
    attention with the causal mask at the query's slot (llama.py:225-229)."""
    B, S, H, Dh, slot = 2, 23, 3, 16, 19
    (jq, jk, jv), (tq_, tk_, tv_) = _qkv(6, B, 1, S, H, Dh, dtype)
    valid = np.ones((B, S), np.int32)
    valid[1, 9:16] = 0          # right-padded prompt of row 1
    valid[:, slot + 1:] = 0     # decode slots not written yet
    mask = jllama.make_causal_mask(jnp.asarray(valid), 1, S, offset=slot)
    want = jllama.attention(jq, jk, jv, mask)
    got = tattn.decode_attention(tq_, tk_, tv_, torch.from_numpy(valid), slot)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, 1, H, Dh)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype], rtol=TOL[dtype])


def test_vit_reads_strided_qkv_views():
    """The tower passes q/k/v as strided views of one fused qkv product."""
    B, N, H, Dh = 2, 7, 2, 8
    D = H * Dh
    qkv = torch.from_numpy(np.random.default_rng(4).normal(size=(B * N, 3 * D)).astype(np.float32))
    q, k, v = (t.reshape(B, N, H, Dh) for t in qkv.split(D, dim=-1))
    assert not q.is_contiguous()
    got = tattn.vit_flash_attention(q, k, v)
    want = tattn.vit_flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    tattn.reset_launch_counts()
    (_, (q, k, v)) = _qkv(5, 1, 8, 8, 2, 8, "float32")
    valid = torch.ones((1, 8), dtype=torch.int32)
    torch.testing.assert_close(tattn.flash_attention(q, k, v, valid),
                               tattn.flash_attention_plain(q, k, v, valid), atol=0, rtol=0)
    torch.testing.assert_close(tattn.vit_flash_attention(q, k, v),
                               tattn.vit_flash_attention_plain(q, k, v), atol=0, rtol=0)
    torch.testing.assert_close(tattn.decode_attention(q[:, :1], k, v, valid, 3),
                               tattn.decode_attention_plain(q[:, :1], k, v, valid, 3),
                               atol=0, rtol=0)
    assert set(tattn.KERNEL_LAUNCHES.values()) == {0}


def test_flash_long_keys_raise():
    """Past the one-shot kernel's key length the wrapper takes the blockwise
    one: its plain version on the CPU (tests/test_torch_flash_blockwise.py
    holds it to the JAX kernel), and a raise on a device that is neither the
    CPU nor a card."""
    q = torch.zeros((1, 4, 1, 8))
    k = torch.zeros((1, tattn.ONESHOT_MAX_TK + 1, 1, 8))
    valid = torch.ones((1, k.shape[1]))
    assert torch.equal(tattn.flash_attention(q, k, k, valid),
                       tattn.flash_attention_blockwise_plain(q, k, k, valid))
    with pytest.raises(ValueError, match="flash_blockwise"):
        tattn.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"), valid.to("meta"))
