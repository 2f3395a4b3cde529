"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerances: fp32 inputs 1e-5 (the same fp32 sums in another order); bf16
inputs 2e-2 compared in fp32 (about 2 bf16 ulps at |x| <= 1).
"""

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(seed, shape, dtype, device):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,tq,tk,H,dh,offset", [
    (2, 40, 47, 3, 128, 0),     # Tq not a multiple of the 32-row block, Tk past one tile
    (1, 70, 70, 2, 64, 0),
    (1, 33, 1024, 1, 128, 0),   # the longest one-shot key row (largest shared memory)
    (2, 5, 130, 1, 72, 125),    # causal offset; Dh = 72 takes the scalar kernel
])
def test_flash_prefill_kernel_matches_plain(cuda, dtype, tol, B, tq, tk, H, dh, offset):
    q = _rand(0, (B, tq, H, dh), dtype, cuda)
    k = _rand(1, (B, tk, H, dh), dtype, cuda)
    v = _rand(2, (B, tk, H, dh), dtype, cuda)
    valid = torch.ones((B, tk), dtype=torch.int32, device=cuda)
    valid[0, tk - 4:] = 0
    valid[-1, :2] = 0           # with offset 0: query rows 0..1 fully masked
    before = tattn.KERNEL_LAUNCHES["flash_prefill"]
    got = tattn.flash_attention(q, k, v, valid, offset=offset)
    torch.cuda.synchronize()
    assert tattn.KERNEL_LAUNCHES["flash_prefill"] == before + 1
    want = tattn.flash_attention_plain(q, k, v, valid, offset=offset)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,N,H,dh", [(2, 261, 3, 64), (2, 256, 2, 72), (1, 13, 2, 16)])
def test_vit_kernel_matches_plain(cuda, dtype, tol, B, N, H, dh):
    qkv = _rand(3, (B * N, 3 * H * dh), dtype, cuda)
    q, k, v = (t.reshape(B, N, H, dh) for t in qkv.split(H * dh, dim=-1))  # strided views
    before = tattn.KERNEL_LAUNCHES["vit_attention"]
    got = tattn.vit_flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.KERNEL_LAUNCHES["vit_attention"] == before + 1
    want = tattn.vit_flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,dh,slot", [(3, 295, 4, 128, 290), (2, 37, 2, 72, 30)])
def test_decode_kernel_matches_plain(cuda, dtype, tol, B, S, H, dh, slot):
    q = _rand(4, (B, 1, H, dh), dtype, cuda)
    cache_k = _rand(5, (2, B, S, H, dh), dtype, cuda)   # one layer of a stacked cache
    cache_v = _rand(6, (2, B, S, H, dh), dtype, cuda)
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    valid[0, slot - 12:slot - 4] = 0      # a padded prompt
    before = tattn.KERNEL_LAUNCHES["decode_attention"]
    got = tattn.decode_attention(q, cache_k[1], cache_v[1], valid, slot)
    torch.cuda.synchronize()
    assert tattn.KERNEL_LAUNCHES["decode_attention"] == before + 1
    want = tattn.decode_attention_plain(q, cache_k[1], cache_v[1], valid, slot)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        tattn.vit_flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tattn.vit_flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="kv_valid"):
        tattn.flash_attention(q, q, q, torch.ones((1, 9), device=cuda))
