"""Fused int8 (w8a8) ViT tower kernels (counterpart of ``openvla_probe_tpu/ops/vit_mlp.py``).

* ``fused_ln_w8a8(x, w, b, ln, res, ls)`` = ``[res +] [ls ·] (w8a8(LN?(x)) + b)``:
  the qkv entry (LN1 first) and the proj exit (residual, DINOv2's LayerScale)
  of a quantized tower block.
* ``fused_mlp_residual(x, ...)`` = ``x + ls2 · (fc2_w8a8(act(fc1_w8a8(LN2(x)) + b1)) + b2)``:
  the whole MLP half-block.

w8a8 is the JAX package's turbo-tier arithmetic, cast for cast: LN in fp32
rounded to the input dtype; per-row ``sx = max(max|h| / 127, 1e-8)`` from that
rounded value; codes ``clip(round_half_even(h / sx), -127, 127)``; the int8 ×
int8 product accumulated exactly as an integer; ``(acc · sx) · s`` in fp32,
cast; bias add, LayerScale multiply and residual add in the input dtype; the
activation in fp32, cast back.

Each wrapper launches its CUDA kernels (``csrc/vit_mlp.cu``) for a CUDA tensor
and takes the plain PyTorch version beside it only for a CPU tensor. A call
is a chain of launches on the int8 wgmma core that ``w8a8_matmul`` runs on
(``csrc/int8_wgmma.cuh``), each counted under its own name in
``_build.KERNEL_LAUNCHES``: ``fused_ln_w8a8`` is a pre-pass (LayerNorm and
quantize, or quantize; ``fused_ln_w8a8_quant_rows``) writing the activation
codes to device memory, then the GEMM with the fused epilogue
(``fused_ln_w8a8``); ``fused_mlp_residual`` is the LN2 pre-pass
(``fused_mlp_ln_quant_rows``), fc1 with its bias (``fused_mlp_fc1``)
writing ``y [M, F]``, the pass that applies the activation to y and
quantizes g = act(y) row by row (``fused_mlp_quant_rows``), and fc2 with
bias, LayerScale and the residual (``fused_mlp_residual``). The wrappers
allocate the codes, scales and y that the launches pass on; with a ``probe`` dict, the codes and scales are its
buffers. The plain versions compute the integer accumulators exactly through
float64 products of the codes (``ops.linear.int8_dot``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .linear import int8_dot, quantize_rows

ACTS = ("gelu", "gelu_tanh", "quick_gelu")
_NO_VJP = ("the fused tower kernels have no backward, as the JAX kernels have no VJP: train "
           "bf16 towers, or int8 towers unfused on ViTConfig.int8_matmul='w8a8'")


def _act_f32(xf: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(xf, approximate="none")
    if kind == "gelu_tanh":
        return F.gelu(xf, approximate="tanh")
    if kind == "quick_gelu":
        return xf * torch.sigmoid(1.702 * xf)
    raise ValueError(f"unknown act {kind}")


def _layer_norm_f32(x, scale, bias, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _w8a8_codes(codes, sx, w, b, dt) -> torch.Tensor:
    """bf16((acc · sx) · s) + b from given codes: the integer product and the
    epilogue, which are exact given the codes."""
    return (int8_dot(codes, w["q"]) * sx * w["s"].float()[None, :]).to(dt) + b.to(dt)


# --- plain PyTorch versions ----------------------------------------------------
# Each is split at its activation codes: `*_from_codes` takes codes and row
# scales and finishes the function exactly, so a kernel's own codes (from its
# `probe`) can be checked to give its output bit for bit.


def fused_ln_w8a8_from_codes(codes, sx, w, b, res=None, ls=None, dtype=torch.bfloat16):
    y = _w8a8_codes(codes, sx, w, b, dtype)
    if ls is not None:
        y = y * ls.to(dtype)
    if res is not None:
        y = res + y
    return y


def fused_ln_w8a8_plain(x, w, b, ln: Optional[tuple] = None, res=None, ls=None,
                        eps: float = 1e-6) -> torch.Tensor:
    h = _layer_norm_f32(x, ln[0], ln[1], eps).to(x.dtype) if ln is not None else x
    return fused_ln_w8a8_from_codes(*quantize_rows(h.float()), w, b, res, ls, x.dtype)


def mlp_hidden_from_codes(codes, sx, fc1, fc1_b, act: str, dtype) -> torch.Tensor:
    """g = act(w8a8_fc1 + b1) from the LN2 codes."""
    return _act_f32(_w8a8_codes(codes, sx, fc1, fc1_b, dtype).float(), act).to(dtype)


def mlp_out_from_codes(x, codes, sx, fc2, fc2_b, ls2) -> torch.Tensor:
    """x + ls2 · (w8a8_fc2 + b2) from g's codes."""
    return x + _w8a8_codes(codes, sx, fc2, fc2_b, x.dtype) * ls2.to(x.dtype)


def fused_mlp_residual_plain(x, ln_scale, ln_bias, fc1, fc1_b, fc2, fc2_b, ls2,
                             eps: float = 1e-6, act: str = "gelu_tanh") -> torch.Tensor:
    h = _layer_norm_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    g = mlp_hidden_from_codes(*quantize_rows(h.float()), fc1, fc1_b, act, x.dtype)
    return mlp_out_from_codes(x, *quantize_rows(g.float()), fc2, fc2_b, ls2)


# --- kernel wrappers -------------------------------------------------------------


def _check(kernel: str, x: torch.Tensor, named: Dict[str, Tuple[torch.Tensor, tuple, torch.dtype]],
           aligned: Tuple[str, ...]):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel}: x must be bf16 or fp32, got {x.dtype}")
    for name, (t, shape, dtype) in named.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous on {x.device}")
        # the pre-passes read x and the LayerNorm parameters as 16-byte vectors, and the
        # GEMMs' TMA maps read the weight codes
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _code_buffers(probe: Optional[dict], x, rows: int, **cols):
    """The activation codes ("codes*", int8 [rows, cols]) and row scales
    ("sx*", fp32 [rows, 1]) that a pre-pass writes and a GEMM reads: fresh,
    or stored into `probe` for verification. Returns them in order."""
    out = []
    for name, n in cols.items():
        t = torch.empty((rows, n), dtype=torch.int8 if name.startswith("codes") else torch.float32,
                        device=x.device)
        if probe is not None:
            probe[name] = t
        out.append(t)
    return out


def fused_ln_w8a8(x, w, b, ln: Optional[tuple] = None, res=None, ls=None,
                  eps: float = 1e-6, probe: Optional[dict] = None) -> torch.Tensor:
    """x [M, K]; w = {"q": int8 [N, K], "s": f32 [N]}; b [N]; ln = (scale [K],
    bias [K]) or None; res [M, N] or None; ls [N] or None. -> [M, N] in x's dtype.
    With a `probe` dict, the CUDA kernels' activation codes ("codes" [M, K])
    and row scales ("sx" [M, 1]) are stored there, for verification."""
    _build.no_grad_guard("fused_ln_w8a8", _NO_VJP, x, w["s"], b, *(ln or ()), res, ls)
    if x.device.type == "cpu":
        return fused_ln_w8a8_plain(x, w, b, ln, res, ls, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_w8a8: unsupported device {x.device}")
    M, K = x.shape
    N = w["q"].shape[0]
    dt = x.dtype
    named = {"x": (x, (M, K), dt), "q": (w["q"], (N, K), torch.int8),
             "s": (w["s"], (N,), torch.float32), "b": (b, (N,), dt)}
    if ln is not None:
        named.update(ln_scale=(ln[0], (K,), dt), ln_bias=(ln[1], (K,), dt))
    if res is not None:
        named["res"] = (res, (M, N), dt)
    if ls is not None:
        named["ls"] = (ls, (N,), dt)
    _check("fused_ln_w8a8", x, named, ("x", "q", "ln_scale", "ln_bias"))
    if K < 16 or K % 16:
        raise ValueError(f"fused_ln_w8a8: K={K} must be a positive multiple of 16")
    out = torch.empty((M, N), dtype=dt, device=x.device)
    codes, sx = _code_buffers(probe, x, M, codes=K, sx=1)
    err = _build.launcher("fused_ln_w8a8")(
        x.data_ptr(), _ptr(ln[0] if ln is not None else None),
        _ptr(ln[1] if ln is not None else None), w["q"].data_ptr(), w["s"].data_ptr(),
        b.data_ptr(), _ptr(res), _ptr(ls), out.data_ptr(), M, K, N, float(eps), codes.data_ptr(),
        sx.data_ptr(), int(dt == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "fused_ln_w8a8")
    _build.KERNEL_LAUNCHES["fused_ln_w8a8_quant_rows"] += 1
    _build.KERNEL_LAUNCHES["fused_ln_w8a8"] += 1
    return out


def fused_mlp_residual(x, ln_scale, ln_bias, fc1, fc1_b, fc2, fc2_b, ls2,
                       eps: float = 1e-6, act: str = "gelu_tanh",
                       probe: Optional[dict] = None) -> torch.Tensor:
    """x [M, D]; fc1 = {"q": int8 [F, D], "s": [F]}; fc2 = {"q": int8 [D, F],
    "s": [D]}; biases [F] / [D]; ls2 [D] (ones where the tower has no
    LayerScale). -> [M, D] in x's dtype. With a `probe` dict, the CUDA
    kernels' LN2 codes and scales ("codes1" [M, D], "sx1" [M, 1]) and g's
    ("codes2" [M, F], "sx2" [M, 1]) are stored there, for verification."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act}")
    _build.no_grad_guard("fused_mlp_residual", _NO_VJP, x, ln_scale, ln_bias, fc1["s"], fc1_b,
                         fc2["s"], fc2_b, ls2)
    if x.device.type == "cpu":
        return fused_mlp_residual_plain(x, ln_scale, ln_bias, fc1, fc1_b, fc2, fc2_b, ls2,
                                        eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_residual: unsupported device {x.device}")
    M, D = x.shape
    Fd = fc1["q"].shape[0]
    dt = x.dtype
    _check("fused_mlp_residual", x, {
        "x": (x, (M, D), dt), "ln_scale": (ln_scale, (D,), dt), "ln_bias": (ln_bias, (D,), dt),
        "fc1.q": (fc1["q"], (Fd, D), torch.int8), "fc1.s": (fc1["s"], (Fd,), torch.float32),
        "fc1_b": (fc1_b, (Fd,), dt), "fc2.q": (fc2["q"], (D, Fd), torch.int8),
        "fc2.s": (fc2["s"], (D,), torch.float32), "fc2_b": (fc2_b, (D,), dt),
        "ls2": (ls2, (D,), dt)}, ("x", "ln_scale", "ln_bias", "fc1.q", "fc2.q"))
    if D < 16 or Fd < 16 or D % 16 or Fd % 16:
        raise ValueError(f"fused_mlp_residual: D={D} and F={Fd} must be positive multiples of 16")
    out = torch.empty((M, D), dtype=dt, device=x.device)
    codes1, sx1, sx2 = _code_buffers(probe, x, M, codes1=D, sx1=1, sx2=1)
    # g's codes [M, F], then fc1's output y [M, F] in x's dtype: one buffer
    g8 = torch.empty(M * Fd * (1 + x.element_size()), dtype=torch.int8, device=x.device)
    if probe is not None:
        probe["codes2"] = g8[:M * Fd].view(M, Fd)
    err = _build.launcher("fused_mlp_residual")(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), fc1["q"].data_ptr(),
        fc1["s"].data_ptr(), fc1_b.data_ptr(), fc2["q"].data_ptr(), fc2["s"].data_ptr(),
        fc2_b.data_ptr(), ls2.data_ptr(), out.data_ptr(), M, D, Fd, float(eps),
        ACTS.index(act), codes1.data_ptr(), sx1.data_ptr(), g8.data_ptr(), sx2.data_ptr(),
        int(dt == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "fused_mlp_residual")
    for name in ("fused_mlp_ln_quant_rows", "fused_mlp_fc1", "fused_mlp_quant_rows",
                 "fused_mlp_residual"):
        _build.KERNEL_LAUNCHES[name] += 1
    return out


# --- holding a kernel to its plain version ------------------------------------------


def _codes_within_one_step(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Largest |code difference| must be <= 1; returns the share of codes that differ."""
    diff = (got.int() - want.int()).abs()
    if int(diff.max()) > 1:
        raise AssertionError(f"{what}: activation codes {int(diff.max())} steps apart")
    return float((diff > 0).float().mean())


def _bit_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if not torch.equal(got, want):
        n = int((got != want).sum())
        raise AssertionError(f"{what}: {n} outputs differ from the plain tail on the kernel's codes")


def compare_ln_w8a8(x, w, b, ln: Optional[tuple] = None, res=None, ls=None,
                    eps: float = 1e-6) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Run the CUDA kernel and hold it to the plain version: its activation
    codes within one step of the plain version's (the fp32 LayerNorm sums run
    in another order), and its output bit-equal to the plain function applied
    to its own codes and scales (equal codes give equal int32 sums and the
    same epilogue). Returns the output and the share of codes that differ;
    raises AssertionError."""
    probe: dict = {}
    out = fused_ln_w8a8(x, w, b, ln, res, ls, eps, probe=probe)
    return out, hold_ln_w8a8(out, probe, x, w, b, ln, res, ls, eps)


def hold_ln_w8a8(out, probe: dict, x, w, b, ln: Optional[tuple] = None, res=None, ls=None,
                 eps: float = 1e-6) -> Dict[str, float]:
    """`compare_ln_w8a8`'s rule on an output and the codes and scales ("codes",
    "sx") that came with it."""
    h = _layer_norm_f32(x, ln[0], ln[1], eps).to(x.dtype) if ln is not None else x
    share = _codes_within_one_step(probe["codes"], quantize_rows(h.float())[0], "fused_ln_w8a8")
    _bit_equal(out, fused_ln_w8a8_from_codes(probe["codes"], probe["sx"], w, b, res, ls, x.dtype),
               "fused_ln_w8a8")
    return {"code_diff_share": share}


def compare_mlp_residual(x, ln_scale, ln_bias, fc1, fc1_b, fc2, fc2_b, ls2, eps: float = 1e-6,
                         act: str = "gelu_tanh") -> Tuple[torch.Tensor, Dict[str, float]]:
    """`compare_ln_w8a8` for the MLP half-block: the LN2 codes within one step
    of the plain version's; g's codes within one step of those the plain fc1
    gives from the kernel's own LN2 codes; the output bit-equal to the plain
    fc2 on the kernel's own g codes and scales."""
    probe: dict = {}
    out = fused_mlp_residual(x, ln_scale, ln_bias, fc1, fc1_b, fc2, fc2_b, ls2, eps, act,
                             probe=probe)
    return out, hold_mlp_residual(out, probe, x, ln_scale, ln_bias, fc1, fc1_b, fc2, fc2_b, ls2,
                                  eps, act)


def hold_mlp_residual(out, probe: dict, x, ln_scale, ln_bias, fc1, fc1_b, fc2, fc2_b, ls2,
                      eps: float = 1e-6, act: str = "gelu_tanh") -> Dict[str, float]:
    """`compare_mlp_residual`'s rule on an output and the codes and scales
    ("codes1", "sx1", "codes2", "sx2") that came with it."""
    h = _layer_norm_f32(x, ln_scale, ln_bias, eps).to(x.dtype)
    share1 = _codes_within_one_step(probe["codes1"], quantize_rows(h.float())[0],
                                    "fused_mlp_residual LN2")
    g = mlp_hidden_from_codes(probe["codes1"], probe["sx1"], fc1, fc1_b, act, x.dtype)
    share2 = _codes_within_one_step(probe["codes2"], quantize_rows(g.float())[0],
                                    "fused_mlp_residual g")
    _bit_equal(out, mlp_out_from_codes(x, probe["codes2"], probe["sx2"], fc2, fc2_b, ls2),
               "fused_mlp_residual")
    return {"code_diff_share": share1, "g_code_diff_share": share2}
