"""The arithmetic the port's tensor-core kernels rely on, rehearsed on the CPU.

The CUDA kernels run only on the card; what they assume of bf16 and fp32 is
checked here in plain torch and numpy:

- vit_attention (``ops/csrc/vit_attention.cu``) at a head dim whose scale
  fp32(1/sqrt(Dh)) is not a power of two splits the fp32 product q * scale
  into three bf16 terms, each the RNE of what the earlier ones leave, and
  runs Q Kᵀ once per term: the split must give back the fp32 value exactly.
- It carries p = exp(s - m) through PV as hi = bf16(p) and lo = bf16(p - hi):
  within 2^-16 of p.
- w4a8_dx (``ops/csrc/w4a8_dx.cu``) widens packed int4 codes with a magic
  number: ((c ^ 8) | 0x4300) read as bf16 is 128 + (c ^ 8), and minus 136 it
  must be the two's complement code, for every code in both nibbles.
- The ViT kernel's algorithm (64-key tiles, the last one masked to NEG_INF,
  an online rescale, the split products summed in fp32) emulated tile by
  tile must meet `attention.compare_blockwise`, the check `chip_smoke.py`
  holds the kernel to.
"""

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import linear as tlin


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to bf16 (RNE) and back to fp32, as cvt.rn.bf16x2.f32 does."""
    return x.to(torch.bfloat16).float()


def _split3(x: torch.Tensor):
    hi = _bf16(x)
    mid = _bf16(x - hi)
    lo = _bf16(x - hi - mid)
    return hi, mid, lo


def _bf16_inputs(seed, shape, scale=1.0):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.normal(size=shape) * scale).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("dh", [72, 8, 24, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_three_term_split_of_the_scaled_q_is_exact(dh, seed):
    """fp32(q) * _scale(Dh) == hi + mid + lo exactly, and the fp32 sum of the
    three terms in the kernel's order gives it back too."""
    scale = tattn._scale(dh)
    assert np.log2(scale) != np.round(np.log2(scale))    # not a power of two
    q = _bf16_inputs(seed, (4096,), scale=10.0 ** (seed * 3 - 1))
    x = q.float() * scale
    hi, mid, lo = _split3(x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert torch.equal((hi + mid) + lo, x)
    assert int((x != hi).sum()) > 0              # bf16 alone cannot hold the scaled q


def test_three_term_split_edge_values():
    """Zero, one, the largest bf16, values with every significand bit set,
    and values far below one; underflow of the low terms near 1e-38 is the
    split's only inexact case and lies outside these."""
    finfo = torch.finfo(torch.bfloat16)
    vals = torch.tensor([0.0, 1.0, -1.0, finfo.max, -finfo.max, 1e-30, -3e-25, 255.0,
                         1.9921875, -1.9921875 * 2 ** 100, 2 ** -100 * 1.5], dtype=torch.float32)
    q = vals.bfloat16()
    for dh in (72, 24):
        x = q.float() * tattn._scale(dh)
        hi, mid, lo = _split3(x)
        assert torch.equal(hi.double() + mid.double() + lo.double(), x.double()), dh


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hi_lo_split_of_p_is_within_2_to_the_minus_16(seed):
    """p in (0, 1]: hi = bf16(p), lo = bf16(p - hi); |p - (hi + lo)| <= 2^-16 p."""
    r = np.random.default_rng(seed)
    s = torch.from_numpy(-r.exponential(scale=4.0, size=100_000).astype(np.float32))
    p = torch.exp(torch.cat([s, torch.tensor([0.0, -69.0, -1e-7])]))   # p = 1 included
    assert float(p.min()) > 0 and float(p.max()) == 1.0
    hi = _bf16(p)
    lo = _bf16(p - hi)
    err = (p.double() - (hi.double() + lo.double())).abs()
    assert bool((err <= p.double() * 2.0 ** -16).all())
    assert int((hi != p).sum()) > 0              # bf16 alone would cut p


def _widen8(words: np.ndarray) -> np.ndarray:
    """ops/csrc/w4a8_dx.cu::widen8 on uint32 words of 8 packed codes: 8 values
    in code order (byte b: code 2b low nibble, 2b + 1 high nibble)."""
    w = words.astype(np.uint32)
    lo, hi = w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F
    out = []
    for i in range(4):
        # __byte_perm(lo, hi, i | i << 4 | (4 + i) << 8 | (4 + i) << 12)
        bl, bh = (lo >> (8 * i)) & 0xFF, (hi >> (8 * i)) & 0xFF
        x = bl | (bl << 8) | (bh << 16) | (bh << 24)
        x = ((x & 0x000F000F) | 0x43004300) ^ 0x00080008
        for half in (x & 0xFFFF, x >> 16):
            as_f32 = (half.astype(np.uint32) << 16).view(np.float32)   # bf16 bits -> fp32
            out.append(as_f32 - np.float32(136.0))                     # __hsub2: exact
    return np.stack(out, axis=-1)


@pytest.mark.parametrize("byte", [0, 1, 2, 3])
def test_magic_widening_is_exact_for_every_code(byte):
    """Every byte value (all 16 codes in the low nibble times all 16 in the
    high) at each byte position of a word widens to its two's complement
    codes -8..7, exactly."""
    v = np.arange(256, dtype=np.uint32)
    got = _widen8(v << (8 * byte))[:, 2 * byte: 2 * byte + 2]
    want = np.stack([((v & 15) ^ 8).astype(np.int32) - 8, (((v >> 4) & 15) ^ 8).astype(np.int32) - 8],
                    axis=-1)
    assert np.array_equal(got, want.astype(np.float32))
    assert set(got.ravel().tolist()) == set(range(-8, 8))


def test_magic_widening_reads_the_ports_packed_layout():
    """Words of `linear.pack_int4` codes widen back to the codes, in order."""
    r = np.random.default_rng(5)
    codes = torch.from_numpy(r.integers(-8, 8, size=(3, 16, 128), dtype=np.int8))
    packed = tlin.pack_int4(codes).numpy()                       # [3, 16, 64] uint8
    words = packed.reshape(3, 16, 16, 4).astype(np.uint32)
    words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    got = _widen8(words).reshape(3, 16, 128)
    assert np.array_equal(got, codes.numpy().astype(np.float32))


def _vit_tiles(q, k, v, tile=64, q_terms=3):
    """The ViT kernel's algorithm, tile by tile, in fp32: q split into bf16
    terms (one where the scale is a power of two, scaled after the dot),
    64-key tiles with the keys past N masked to NEG_INF, an online max / sum
    rescale, p = hi + lo through PV, out = o / max(l, 1e-30) in bf16."""
    B, N, H, Dh = q.shape
    scale = tattn._scale(Dh)
    exact = Dh in (16, 64)
    qh = q.permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    terms = [qh] if exact else list(_split3(qh * scale))[:q_terms]
    m = torch.full((B, H, N, 1), tattn.NEG_INF)
    l = torch.zeros((B, H, N, 1))
    o = torch.zeros((B, H, N, Dh))
    for k0 in range(0, N, tile):
        kt = torch.zeros((B, H, tile, Dh))
        vt = torch.zeros((B, H, tile, Dh))
        kt[:, :, :min(tile, N - k0)] = kh[:, :, k0:k0 + tile]    # zero-filled past N
        vt[:, :, :min(tile, N - k0)] = vh[:, :, k0:k0 + tile]
        s = sum(torch.matmul(t, kt.transpose(-1, -2)) for t in terms)
        if exact:
            s = s * scale
        s[..., max(0, N - k0):] = tattn.NEG_INF
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        hi = _bf16(p)
        lo = _bf16(p - hi)
        o = o * corr + torch.matmul(hi, vt) + torch.matmul(lo, vt)
        m = m_new
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype).permute(0, 2, 1, 3)


@pytest.mark.parametrize("dh", [64, 72])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vit_tile_emulation_meets_the_chip_check(dh, seed):
    """N = 70: two key tiles, the second ragged; held by compare_blockwise
    (every element within one bf16 step of vit_flash_attention_plain, at most
    max(16, 2 %) apart), as chip_smoke.py holds the kernel."""
    B, N, H = 2, 70, 3
    q, k, v = (_bf16_inputs(seed * 3 + i, (B, N, H, dh), scale=2.0 if i == 0 else 1.0)
               for i in range(3))
    got = _vit_tiles(q, k, v)
    want = tattn.vit_flash_attention_plain(q, k, v)
    stats = tattn.compare_blockwise(got, want, kernel="vit_attention")
    assert stats["max_steps"] <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vit_check_refuses_one_bf16_term_of_the_scaled_q(seed):
    """Negative control at Dh = 72: the same tiles with q * scale rounded to
    one bf16 term move outputs by many bf16 steps, which the check refuses."""
    q, k, v = (_bf16_inputs(seed * 3 + i, (2, 70, 3, 72), scale=2.0 if i == 0 else 1.0)
               for i in range(3))
    got = _vit_tiles(q, k, v, q_terms=1)
    with pytest.raises(AssertionError, match="vit_attention"):
        tattn.compare_blockwise(got, tattn.vit_flash_attention_plain(q, k, v),
                                kernel="vit_attention")
