"""Frozen-KV decode attention (counterpart of ``openvla_probe_tpu/ops/decode_attention.py::decode_flash_attention``).

One greedy-decode step attends its single query over two segments, the
frozen prefill K/V and the small buffer of generated-token K/V, with one
joint softmax. The wrapper launches the CUDA kernel
(``csrc/decode_split_attention.cu``) for a CUDA tensor and takes the plain
PyTorch version only for a CPU tensor.

Layouts are the JAX package's: q ``[B, 1, H, Dh]``; kp/vp ``[B, T, H, Dh]``;
kd/vd ``[B, A, H, Dh]`` (K/V heads already repeated); pre_valid ``[B, T]`` and
dec_valid ``[B, A]`` with 1 = attend. Each token's ``[H, Dh]`` slab must be
contiguous; batch and token strides are free, so one layer's slice of the
stacked ``[L, B, T, H, Dh]`` buffers is read in place.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import MAX_HEAD_DIM, NEG_INF, _check_cuda_inputs, _check_head_slab, _scale

MAX_KEYS = 4096   # T + A scores per (batch, head) held in shared memory


def decode_flash_attention_plain(q, kp, vp, kd, vd, pre_valid, dec_valid):
    """The TPU kernel's function: q scaled in fp32, fp32 scores with NEG_INF on
    invalid keys, one max over both segments, fp32 exp, fp32 P·V (P is not
    rounded), out / max(denominator, 1e-30) cast to q's dtype."""
    qf = q[:, 0].float() * _scale(q.shape[-1])                          # [B, H, Dh]
    sp = torch.einsum("bhd,bthd->bht", qf, kp.float())
    sd = torch.einsum("bhd,bthd->bht", qf, kd.float())
    sp = sp.masked_fill(~(pre_valid > 0)[:, None, :], NEG_INF)
    sd = sd.masked_fill(~(dec_valid > 0)[:, None, :], NEG_INF)
    m = torch.maximum(sp.amax(-1, keepdim=True), sd.amax(-1, keepdim=True))
    ep, ed = torch.exp(sp - m), torch.exp(sd - m)
    denom = torch.clamp(ep.sum(-1, keepdim=True) + ed.sum(-1, keepdim=True), min=1e-30)
    out = (torch.einsum("bht,bthd->bhd", ep, vp.float())
           + torch.einsum("bht,bthd->bhd", ed, vd.float())) / denom
    return out.to(q.dtype)[:, None]


def decode_flash_attention(q, kp, vp, kd, vd, pre_valid, dec_valid):
    """softmax([q·Kp | q·Kd]) @ [Vp; Vd] for one decode token -> [B, 1, H, Dh]."""
    B, Tq, H, Dh = q.shape
    T, A = kp.shape[1], kd.shape[1]
    if Tq != 1:
        raise ValueError(f"decode_flash_attention takes one query per row, got Tq={Tq}")
    if q.device.type == "cpu":
        return decode_flash_attention_plain(q, kp, vp, kd, vd, pre_valid, dec_valid)
    if q.device.type != "cuda":
        raise ValueError(f"decode_flash_attention: unsupported device {q.device}")
    _check_cuda_inputs("decode_split_attention", q, kp, vp)
    _check_cuda_inputs("decode_split_attention", q, kd, vd)
    if T + A > MAX_KEYS or Dh > MAX_HEAD_DIM:
        raise ValueError(f"decode_split_attention: T + A = {T + A} > {MAX_KEYS} or Dh > {MAX_HEAD_DIM}")
    _check_head_slab("q", q, (B, 1, H, Dh))
    for name, t, n in (("kp", kp, T), ("vp", vp, T), ("kd", kd, A), ("vd", vd, A)):
        _check_head_slab(name, t, (B, n, H, Dh))
    for name, t, n in (("pre_valid", pre_valid, T), ("dec_valid", dec_valid, A)):
        if tuple(t.shape) != (B, n) or t.device != q.device:
            raise ValueError(f"{name} must be [{B}, {n}] on {q.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    pv = pre_valid.to(torch.int32).contiguous()
    dv = dec_valid.to(torch.int32).contiguous()
    out = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    err = _build.launcher("decode_split_attention")(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kd.data_ptr(), vd.data_ptr(),
        pv.data_ptr(), dv.data_ptr(), out.data_ptr(), B, H, T, A, Dh,
        q.stride(0), kp.stride(0), kp.stride(1), vp.stride(0), vp.stride(1),
        kd.stride(0), kd.stride(1), vd.stride(0), vd.stride(1), _scale(Dh),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, "decode_split_attention")
    _build.KERNEL_LAUNCHES["decode_split_attention"] += 1
    return out
