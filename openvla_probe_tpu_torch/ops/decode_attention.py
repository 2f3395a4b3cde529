"""Decode attention over a cache (counterpart of ``openvla_probe_tpu/ops/decode_attention.py``).

Two kernels, each a wrapper that launches its CUDA kernel for a CUDA tensor
and takes the plain PyTorch version beside it only for a CPU tensor:

* ``decode_flash_attention`` (``csrc/decode_split_attention.cu``): one greedy
  decode step attends its single query over two segments, the frozen prefill
  K/V and the small buffer of generated-token K/V, with one joint softmax.
  Layouts are the JAX package's: q ``[B, 1, H, Dh]``; kp/vp ``[B, T, H, Dh]``;
  kd/vd ``[B, A, H, Dh]`` (K/V heads already repeated); pre_valid ``[B, T]``
  and dec_valid ``[B, A]`` with 1 = attend. Each token's ``[H, Dh]`` slab must
  be contiguous; batch and token strides are free, so one layer's slice of
  the stacked ``[L, B, T, H, Dh]`` buffers is read in place.
* ``stacked_decode_attention_i8`` (``csrc/stacked_decode_i8.cu``): one query
  over layer ``li`` of the int8 flat stacked cache of the ``pallas_kv8`` tier,
  the dequantization fused: kq/vq int8 ``[L, B, S, Hkv·Dh]``, ks/vs fp32
  ``[L, B, S, Hkv]`` per-(slot, head) scales, valid ``[B, S]`` (the whole
  cache is one segment, one softmax). GQA heads share their kv head.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import (_DECODE_NO_GRAD, MAX_HEAD_DIM, NEG_INF, _check_cuda_inputs,
                        _check_head_slab, _scale, decode_ring_eligible)

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
    """softmax([q·Kp | q·Kd]) @ [Vp; Vd] for one decode token -> [B, 1, H, Dh].

    On the card, two routes by the declared rule `attention.decode_ring_eligible`,
    counted apart: the ring kernel (``decode_split_attention``) and, for every
    other call (fp32, other head dims, unaligned rows), the scalar kernel
    (``decode_split_attention_scalar``), which computes the same function. A
    launch that fails raises; neither route stands in for the other."""
    _build.no_grad_guard("decode_flash_attention", _DECODE_NO_GRAD, q, kp, vp, kd, vd)
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
    kernel = ("decode_split_attention" if decode_ring_eligible(q, kp, vp, kd, vd)
              else "decode_split_attention_scalar")
    err = _build.launcher(kernel)(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kd.data_ptr(), vd.data_ptr(),
        pv.data_ptr(), dv.data_ptr(), out.data_ptr(), B, H, T, A, Dh,
        q.stride(0), kp.stride(0), kp.stride(1), vp.stride(0), vp.stride(1),
        kd.stride(0), kd.stride(1), vd.stride(0), vd.stride(1), _scale(Dh),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, kernel)
    _build.KERNEL_LAUNCHES[kernel] += 1
    return out


# --- int8 flat stacked cache (the pallas_kv8 tier) -----------------------------------------

STACKED_HEAD_DIMS = (16, 32, 64, 128)
STACKED_REPS = (1, 2, 4, 8)


def stacked_decode_attention_i8_plain(q, kq, ks, vq, vs, valid, li: int):
    """The TPU kernel's function: kf = f32(kq) · ks, vf = f32(vq) · vs; q · scale
    in fp32 before the dot; fp32 scores, NEG_INF on invalid slots; fp32 softmax
    numerator and P·V (P not rounded); pv / max(l, 1e-30) cast to q's dtype."""
    B, _, H, Dh = q.shape
    S = kq.shape[2]
    Hkv = kq.shape[3] // Dh
    kf = kq[li].reshape(B, S, Hkv, Dh).float() * ks[li][..., None]
    vf = vq[li].reshape(B, S, Hkv, Dh).float() * vs[li][..., None]
    if H != Hkv:
        kf, vf = (torch.repeat_interleave(t, H // Hkv, dim=2) for t in (kf, vf))
    qf = q[:, 0].float() * _scale(Dh)                                   # [B, H, Dh]
    s = torch.einsum("bhd,bshd->bhs", qf, kf)
    s = s.masked_fill(~(valid > 0)[:, None, :], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pv = torch.einsum("bhs,bshd->bhd", p, vf)
    return (pv / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)).to(q.dtype)[:, None]


def stacked_decode_attention_i8(q, kq, ks, vq, vs, valid, li: int):
    """softmax(q · K[li]) @ V[li] over the int8 stacked cache -> [B, 1, H, Dh]."""
    _build.no_grad_guard("stacked_decode_attention_i8", _DECODE_NO_GRAD, q, ks, vs)
    B, Tq, H, Dh = q.shape
    L, Bk, S, KDh = kq.shape
    Hkv = KDh // Dh
    if Tq != 1 or Bk != B or Hkv * Dh != KDh or H % Hkv:
        raise ValueError(f"stacked_decode_attention_i8: q {tuple(q.shape)} and kq "
                         f"{tuple(kq.shape)} disagree")
    if not 0 <= li < L:
        raise IndexError(f"stacked_decode_attention_i8: layer {li} of {L}")
    if q.device.type == "cpu":
        return stacked_decode_attention_i8_plain(q, kq, ks, vq, vs, valid, li)
    if q.device.type != "cuda":
        raise ValueError(f"stacked_decode_attention_i8: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"stacked_decode_attention_i8: q must be bf16 or fp32, got {q.dtype}")
    if Dh not in STACKED_HEAD_DIMS or H // Hkv not in STACKED_REPS:
        raise ValueError(f"stacked_decode_attention_i8: head dim {Dh} (of {STACKED_HEAD_DIMS}) "
                         f"and n_rep {H // Hkv} (of {STACKED_REPS})")
    named = {"q": (q, (B, 1, H, Dh), q.dtype), "kq": (kq, (L, B, S, KDh), torch.int8),
             "vq": (vq, (L, B, S, KDh), torch.int8), "ks": (ks, (L, B, S, Hkv), torch.float32),
             "vs": (vs, (L, B, S, Hkv), torch.float32)}
    for name, (t, shape, dtype) in named.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"stacked_decode_attention_i8: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"stacked_decode_attention_i8: {name} must be contiguous and "
                             f"16-byte aligned on {q.device}")
    if tuple(valid.shape) != (B, S) or valid.device != q.device:
        raise ValueError(f"valid must be [{B}, {S}] on {q.device}, got {tuple(valid.shape)} "
                         f"on {valid.device}")
    v32 = valid.to(torch.int32).contiguous()
    out = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    err = _build.launcher("stacked_decode_attention_i8")(
        q.data_ptr(), kq[li].data_ptr(), ks[li].data_ptr(), vq[li].data_ptr(), vs[li].data_ptr(),
        v32.data_ptr(), out.data_ptr(), B, H, Hkv, S, Dh, _scale(Dh),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, "stacked_decode_attention_i8")
    _build.KERNEL_LAUNCHES["stacked_decode_attention_i8"] += 1
    return out
