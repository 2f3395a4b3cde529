"""RMSNorm, and RMSNorm fused with the per-row int8 activation quantization
(counterpart of ``openvla_probe_tpu/ops/rmsnorm_quant.py``).

``rms_norm_quant(x, w, eps)`` emits the int8 codes and row scales that a w8a8
product would compute from ``rms_norm(x, w, eps)``, in one pass over x instead
of writing the normed activation and reading it back. The Llama trunk takes it
where every consumer of a norm is a per-channel int8 leaf on the w8a8 route
(``models/llama.py::_norm_maybe_quant``; off unless the config turns it on,
as the JAX package's ``OVLA_PALLAS_RMSQ``).

The wrapper launches the CUDA kernel (``csrc/rmsnorm_quant.cu``: one block a
row, the row in registers) for a CUDA tensor and takes the plain PyTorch
version only for a CPU tensor. The kernel sums each row's squares in another
order than the plain version, so its reciprocal RMS can differ in the last
bits: `compare_rms_norm_quant` states how far its codes and scales may be
from the plain version's. The kernel loads 16-byte vectors where D is a
multiple of 16 / sizeof(x) and the rows are 16-byte aligned, one element at
a time otherwise; it holds up to `RMSQ_MAX_VECS` vectors (or elements) a row.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .linear import quantize_rows

RMSQ_MAX_VECS = 4096   # the kernel's longest row: 512 threads x 8 vectors


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """HF-convention RMSNorm: fp32 variance + scale, cast to the input dtype
    BEFORE the weight multiply."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return xf.to(dt) * weight.to(dt)


def rms_norm_quant_plain(x: torch.Tensor, weight: torch.Tensor,
                         eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's function (``_rmsq_kernel``): `rms_norm`, then the
    per-row int8 codes and fp32 scales of its value (``quantize_rows``)."""
    return quantize_rows(rms_norm(x, weight, eps).float())


def rms_norm_quant(x: torch.Tensor, weight: torch.Tensor,
                   eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] (bf16 or fp32), weight [D] -> (int8 codes [..., D], fp32 row
    scales [..., 1])."""
    _build.no_grad_guard("rms_norm_quant", "the fused norm serves inference: train with "
                         "LlamaConfig.fused_rmsq=False (rms_norm, then the w8a8 STE)", x, weight)
    if x.device.type == "cpu":
        return rms_norm_quant_plain(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_quant: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rms_norm_quant: x must be bf16 or fp32, got {x.dtype}")
    D = x.shape[-1]
    if tuple(weight.shape) != (D,) or weight.device != x.device:
        raise ValueError(f"rms_norm_quant: weight must be [{D}] on {x.device}, "
                         f"got {tuple(weight.shape)} on {weight.device}")
    x2 = x.reshape(-1, D).contiguous()
    w = weight.to(x.dtype).contiguous()
    M = x2.shape[0]
    V = 16 // x.element_size()
    vec = D % V == 0 and x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    if D > RMSQ_MAX_VECS * (V if vec else 1):
        raise ValueError(f"rms_norm_quant: D={D} is longer than the kernel's "
                         f"{RMSQ_MAX_VECS} {'vectors of ' + str(V) if vec else 'elements'}")
    codes = torch.empty((M, D), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    err = _build.launcher("rms_norm_quant")(
        x2.data_ptr(), w.data_ptr(), codes.data_ptr(), sx.data_ptr(), M, D, float(eps),
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "rms_norm_quant")
    _build.KERNEL_LAUNCHES["rms_norm_quant"] += 1
    return codes.reshape(x.shape), sx.reshape(*x.shape[:-1], 1)


def _nudge(t: torch.Tensor, k: int) -> torch.Tensor:
    """`t` moved by k ulps (toward +inf for k > 0)."""
    to = torch.full_like(t, float("inf") if k > 0 else float("-inf"))
    for _ in range(abs(k)):
        t = torch.nextafter(t, to)
    return t


def compare_rms_norm_quant(x: torch.Tensor, weight: torch.Tensor, eps: float,
                           got: Tuple[torch.Tensor, torch.Tensor],
                           want: Tuple[torch.Tensor, torch.Tensor], max_ulps: int = 16) -> dict:
    """Hold the kernel's (codes, scales) for input x to the plain version's.

    The two reach each row's reciprocal RMS r by different fp32 arithmetic
    (the kernel's block-order sum of squares and correctly rounded sqrt and
    division), so r can differ in its last bits. Every later step is the same
    IEEE operation on both sides, so a row differs only where that moves a
    rounding: a code at a tie, or, where the row maximum's bf16 rounding
    sits at a tie, the row's scale and with it many of its codes. So every
    row that differs must be reproduced bit for bit (codes and scale) by the
    plain version's arithmetic with r moved by at most `max_ulps` ulps, and
    every code lies within one step. A fault (another rounding, a missing
    bf16 round trip, a wrong scale) is reproduced by no such r. Raises
    AssertionError otherwise; returns the counts."""
    (codes, sx), (want_codes, want_sx) = got, want
    D = x.shape[-1]
    codes, sx = codes.reshape(-1, D), sx.reshape(-1, 1)
    want_codes, want_sx = want_codes.reshape(-1, D), want_sx.reshape(-1, 1)
    step = (codes.int() - want_codes.int()).abs()
    rows = ((step > 0).any(-1) | (sx != want_sx)[:, 0]).nonzero()[:, 0]
    stats = dict(max_code_step=int(step.max().item()), codes=codes.numel(),
                 codes_one_step_apart=int((step > 0).sum().item()),
                 scales_differing=int((sx != want_sx).sum().item()),
                 max_rel_scale_err=((sx - want_sx).abs() / want_sx).max().item(),
                 rows=codes.shape[0], rows_differing=int(rows.numel()), max_r_ulps=0)
    assert stats["max_code_step"] <= 1, f"rms_norm_quant: a code more than one step apart {stats}"
    if rows.numel():
        xf = x.reshape(-1, D)[rows].float()
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        got_codes, got_sx = codes[rows], sx[rows]
        need = torch.full((rows.numel(),), -1, device=x.device)
        for k in sorted(range(-max_ulps, max_ulps + 1), key=abs):
            hk = (xf * _nudge(r, k)).to(x.dtype) * weight.to(x.dtype)
            qk, sk = quantize_rows(hk.float())
            hit = (qk == got_codes).all(-1) & (sk == got_sx)[:, 0] & (need < 0)
            need[hit] = abs(k)
        stats["max_r_ulps"] = int(need.max().item())
        assert bool((need >= 0).all()), (
            f"rms_norm_quant: {int((need < 0).sum().item())} rows not reproduced by the plain "
            f"arithmetic within {max_ulps} ulps of r {stats}")
    return stats
