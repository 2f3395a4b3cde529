"""The blockwise flash attention of the port (Tk > 1024) against the JAX
package's blockwise Pallas kernel (`_flash_kernel`, run in interpret mode with
OVLA_FLASH_ONESHOT=0), on the CPU.

Tolerance: the port's `attention.compare_blockwise`, the check the card
holds the CUDA kernel to. fp32 inputs within 1e-5 (the same fp32 function:
an online softmax against a direct one, sums in another order). bf16
inputs: every output element within one bf16 step of the JAX kernel's and at
most max(16, 2 %) of them apart at all; both sides compute in fp32 from the
same bf16 inputs and round once at the output, so only an element whose fp32
values straddle a rounding edge may land on the other neighbour. (The JAX
package's own test holds the kernel to its XLA attention at atol 2e-5 /
rtol 1e-4 in fp32, tests/test_attention_kernel.py.) The same check refuses
the one-shot class, which rounds P to bf16 before PV.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.ops import attention as jattn
from openvla_probe_tpu_torch.ops import attention as tattn

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


def _jax_blockwise(monkeypatch, q, k, v, valid, **kw):
    monkeypatch.setenv("OVLA_FLASH_ONESHOT", "0")
    return jattn.flash_attention(q, k, v, jnp.asarray(valid), interpret=True, **kw)


def _torch_out(x):
    return torch.from_numpy(np.array(x.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,offset,causal", [
    (40, 200, 0, True),      # Tq and Tk not multiples of 128; cached-prefill geometry
    (37, 150, 100, True),    # causal offset: query 0 sits at position 100
    (50, 130, 0, False),     # padding-only mask
])
def test_blockwise_plain_matches_jax_kernel(monkeypatch, dtype, tq, tk, offset, causal):
    B, H, Dh = 2, 2, 16
    (jq, jk, jv), (tq_, tk_, tv_) = _qkv(1, B, tq, tk, H, Dh, dtype)
    valid = np.ones((B, tk), np.int32)
    valid[0, tk - 9:] = 0        # right-padded keys
    valid[1, 3:7] = 0            # holes inside the row
    want = _jax_blockwise(monkeypatch, jq, jk, jv, valid, offset=offset, causal=causal)
    got = tattn.flash_attention_blockwise(tq_, tk_, tv_, torch.from_numpy(valid),
                                          offset=offset, causal=causal)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, tq, H, Dh)
    tattn.compare_blockwise(got, _torch_out(want).to(got.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_rows_dispatch_to_blockwise_and_match_jax(monkeypatch, dtype):
    """Tk = 1100 > 1024 through the dispatching wrappers of both packages
    (the JAX wrapper takes its blockwise branch at its default
    OVLA_FLASH_ONESHOT=1 too), small H and Dh."""
    B, Tq, Tk, H, Dh = 1, 24, 1100, 1, 8
    (jq, jk, jv), (tq_, tk_, tv_) = _qkv(2, B, Tq, Tk, H, Dh, dtype)
    valid = np.ones((B, Tk), np.int32)
    valid[0, 1090:] = 0
    monkeypatch.delenv("OVLA_FLASH_ONESHOT", raising=False)
    want = jattn.flash_attention(jq, jk, jv, jnp.asarray(valid), offset=1070, interpret=True)
    got = tattn.flash_attention(tq_, tk_, tv_, torch.from_numpy(valid), offset=1070)
    tattn.compare_blockwise(got, _torch_out(want).to(got.dtype))
    assert torch.equal(got, tattn.flash_attention_blockwise_plain(
        tq_, tk_, tv_, torch.from_numpy(valid), offset=1070))


@pytest.mark.parametrize("tk,branch", [(1024, "oneshot"), (1025, "blockwise")])
def test_dispatch_boundary_matches_jax(monkeypatch, tk, branch):
    """Tk = 1024 takes the one-shot kernel and Tk = 1025 the blockwise one,
    in the JAX wrapper and in the port alike."""
    B, Tq, H, Dh = 1, 8, 1, 8
    (jq, jk, jv), (tq_, tk_, tv_) = _qkv(3, B, Tq, tk, H, Dh, "bfloat16")
    valid = np.ones((B, tk), np.int32)
    seen = []
    monkeypatch.delenv("OVLA_FLASH_ONESHOT", raising=False)
    real_oneshot = jattn._flash_oneshot
    monkeypatch.setattr(jattn, "_flash_oneshot",
                        lambda *a: seen.append("jax_oneshot") or real_oneshot(*a))
    for name in ("flash_attention_plain", "flash_attention_blockwise_plain"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name,
                            lambda *a, _n=name, _f=real, **kw: seen.append(_n) or _f(*a, **kw))
    want = jattn.flash_attention(jq, jk, jv, jnp.asarray(valid), offset=tk - Tq, interpret=True)
    got = tattn.flash_attention(tq_, tk_, tv_, torch.from_numpy(valid), offset=tk - Tq)
    if branch == "oneshot":
        assert seen == ["jax_oneshot", "flash_attention_plain"]
        # the one-shot class on both sides: P rounded to bf16, 2e-2 as in
        # tests/test_torch_attention.py
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2)
    else:
        assert seen == ["flash_attention_blockwise_plain"]
        tattn.compare_blockwise(got, _torch_out(want).to(got.dtype))


def test_fully_masked_rows():
    """A row with every key masked: the port gives the mean of V over the Tk
    keys (its rule for both flash kernels, and the JAX package's XLA
    attention's). The JAX blockwise kernel pads Tk to a multiple of 128 with
    invalid keys and zero V rows and counts them in the softmax denominator,
    so it gives sum(V) / 1152 at Tk = 1100 (ROADMAP Queue 3). Rows with a
    valid key agree with the kernel."""
    B, Tq, Tk, H, Dh = 2, 6, 1100, 1, 8
    (jq, jk, jv), (tq_, tk_, tv_) = _qkv(4, B, Tq, Tk, H, Dh, "float32")
    valid = np.ones((B, Tk), np.int32)
    valid[1, :3] = 0             # causal, offset 0: queries 0..2 of row 1 see no valid key
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
        np.testing.assert_allclose(kernel[1, row], v[1].sum(axis=0) / 1152, atol=1e-6)


def _kernel_arithmetic(q, k, v, valid, offset):
    """The CUDA kernel's bf16 arithmetic, emulated: the fp32 dot scaled after
    it, p split into bf16 hi and lo halves, both multiplied by V with fp32
    sums."""
    Tq, Tk, Dh = q.shape[1], k.shape[1], q.shape[-1]
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * tattn._scale(Dh)
    ok = (valid > 0)[:, None, None, :] & (
        torch.arange(Tk)[None, :] <= torch.arange(Tq)[:, None] + offset)
    s = s.masked_fill(~ok, tattn.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    out = (torch.matmul(hi, vh) + torch.matmul(lo, vh)) / p.sum(dim=-1, keepdim=True)
    return out.bfloat16().permute(0, 2, 1, 3)


def test_check_refuses_the_one_shot_class():
    """Negative control of `compare_blockwise` on the same bf16 inputs: the
    one-shot function (P rounded to bf16 before PV) fails it, while the
    kernel's own arithmetic (p as two bf16 halves, the scale after the fp32
    dot) passes."""
    B, Tq, Tk, H, Dh = 2, 40, 1100, 2, 64
    _, (q, k, v) = _qkv(5, B, Tq, Tk, H, Dh, "bfloat16")
    valid = torch.ones((B, Tk), dtype=torch.int32)
    valid[0, 1000:] = 0
    want = tattn.flash_attention_blockwise_plain(q, k, v, valid, offset=Tk - Tq)
    oneshot = tattn.flash_attention_plain(q, k, v, valid, offset=Tk - Tq)
    with pytest.raises(AssertionError, match="blockwise"):
        tattn.compare_blockwise(oneshot, want)
    stats = tattn.compare_blockwise(_kernel_arithmetic(q, k, v, valid, Tk - Tq), want)
    assert stats["n_apart"] < stats["n"] // 100   # 22 of 10240


def test_cpu_wrapper_counts_no_launch():
    tattn.reset_launch_counts()
    _, (q, k, v) = _qkv(6, 1, 4, 1030, 1, 8, "float32")
    tattn.flash_attention(q, k, v, torch.ones((1, 1030), dtype=torch.int32))
    assert set(tattn.KERNEL_LAUNCHES.values()) == {0}
