"""RMSNorm, and RMSNorm fused with the per-row int8 activation quantization
(counterpart of ``openvla_probe_tpu/ops/rmsnorm_quant.py``).

``rms_norm_quant(x, w, eps)`` emits the int8 codes and row scales that a w8a8
product would compute from ``rms_norm(x, w, eps)``, in one pass over x instead
of writing the normed activation and reading it back. The Llama trunk takes it
where every consumer of a norm is a per-channel int8 leaf on the w8a8 route
(``models/llama.py::_norm_maybe_quant``; off unless the config turns it on,
as the JAX package's ``OVLA_PALLAS_RMSQ``).

The wrapper launches the CUDA kernel (``csrc/rmsnorm_quant.cu``) for a CUDA
tensor and takes the plain PyTorch version only for a CPU tensor. The kernel
sums each row's squares in another order than the plain version, so its
variance can differ in the last bit: `compare_rms_norm_quant` states how far
its codes and scales may be from the plain version's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .linear import quantize_rows


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
    codes = torch.empty((M, D), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    err = _build.launcher("rms_norm_quant")(
        x2.data_ptr(), w.data_ptr(), codes.data_ptr(), sx.data_ptr(), M, D, float(eps),
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "rms_norm_quant")
    _build.KERNEL_LAUNCHES["rms_norm_quant"] += 1
    return codes.reshape(x.shape), sx.reshape(*x.shape[:-1], 1)


def compare_rms_norm_quant(x: torch.Tensor, got: Tuple[torch.Tensor, torch.Tensor],
                           want: Tuple[torch.Tensor, torch.Tensor]) -> dict:
    """Hold the kernel's (codes, scales) for input x to the plain version's.

    A last-bit change of a row's variance moves a code only where its value
    sits at a rounding tie, so every code is within one step of the plain
    version's and at most max(16, 1e-5 · n) of the n codes differ (a fault in
    the rounding or a missing bf16 round trip puts a large share of them one
    step off). For bf16 x the normed value is rounded to bf16 before the
    weight multiply, so the row maxima and hence the scales are bit-equal;
    for fp32 x they are within 2^-8. Raises AssertionError otherwise; returns
    the counts."""
    (codes, sx), (want_codes, want_sx) = got, want
    step = (codes.int() - want_codes.int()).abs()
    stats = dict(max_code_step=int(step.max().item()), codes=codes.numel(),
                 codes_one_step_apart=int((step > 0).sum().item()),
                 scales_differing=int((sx != want_sx).sum().item()),
                 max_rel_scale_err=((sx - want_sx).abs() / want_sx).max().item())
    allowed = max(16, int(1e-5 * codes.numel()))
    assert stats["max_code_step"] <= 1, f"rms_norm_quant: a code more than one step apart {stats}"
    assert stats["codes_one_step_apart"] <= allowed, \
        f"rms_norm_quant: more than {allowed} codes one step apart {stats}"
    if x.dtype == torch.bfloat16:
        assert stats["scales_differing"] == 0, f"rms_norm_quant: scales differ {stats}"
    else:
        assert stats["max_rel_scale_err"] <= 2 ** -8, f"rms_norm_quant: scales differ {stats}"
    return stats
