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
  cache is one segment, one softmax), the slots up to ``n_keys`` read. GQA
  heads share their kv head. bf16 q at Dh = 128 takes the ring route
  (`stacked_ring_eligible`), every other call the scalar route, counted apart.
* ``split_attention_i8`` (``csrc/split_attention_i8.cu``): the ``turbo_kv8``
  tier's decode step, the frozen-KV split attention of the first kernel over
  an int8 prefill segment: kq/vq int8 ``[B, T, Hkv, Dh]`` with fp32 ``[B, T,
  Hkv]`` per-(token, head) scales, the generated-token buffer kd/vd ``[B, A,
  Hkv, Dh]`` in the model's dtype (GQA heads share their kv head in the
  kernel), q row-quantized for an int8 q·K and the probabilities, the V
  scales folded in, row-quantized for an int8 p·V (the JAX package's
  ``models/llama.py::_split_attention_i8``, an XLA function there). bf16 q
  at Dh = 128 with n_rep 1, 2, 4 or 8 takes the ring route
  (`split_ring_eligible`), every other call the scalar route, counted apart.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import (_DECODE_NO_GRAD, MAX_HEAD_DIM, NEG_INF, _check_cuda_inputs,
                        _check_head_slab, _scale, decode_ring_eligible)
from .linear import div127

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
STACKED_RING_HEAD_DIM = 128
STACKED_RING_MAX_KEYS = 1024   # csrc/stacked_decode_i8.cu: kRingMaxKeys


def stacked_decode_attention_i8_plain(q, kq, ks, vq, vs, valid, li: int,
                                      n_keys: Optional[int] = None):
    """The TPU kernel's function: kf = f32(kq) · ks, vf = f32(vq) · vs; q · scale
    in fp32 before the dot; fp32 scores, NEG_INF on invalid slots (and on the
    slots at or past `n_keys`, all S by default); fp32 softmax numerator and
    P·V (P not rounded); pv / max(l, 1e-30) cast to q's dtype. A row with no
    valid slot gets p = 1 at every slot: the mean of V over all S."""
    B, _, H, Dh = q.shape
    S = kq.shape[2]
    Hkv = kq.shape[3] // Dh
    kf = kq[li].reshape(B, S, Hkv, Dh).float() * ks[li][..., None]
    vf = vq[li].reshape(B, S, Hkv, Dh).float() * vs[li][..., None]
    if H != Hkv:
        kf, vf = (torch.repeat_interleave(t, H // Hkv, dim=2) for t in (kf, vf))
    qf = q[:, 0].float() * _scale(Dh)                                   # [B, H, Dh]
    ok = valid > 0
    if n_keys is not None and n_keys < S:
        ok = ok & (torch.arange(S, device=valid.device) < n_keys)
    s = torch.einsum("bhd,bshd->bhs", qf, kf)
    s = s.masked_fill(~ok[:, None, :], NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pv = torch.einsum("bhs,bshd->bhd", p, vf)
    return (pv / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)).to(q.dtype)[:, None]


def stacked_ring_eligible(q, S: int) -> bool:
    """The declared rule of row 5's ring route (``stacked_decode_attention_i8``),
    the whole of what its launcher takes beyond the wrapper's own checks: bf16 q
    at a head dim of 128 and at most STACKED_RING_MAX_KEYS slots. Every serving
    decode step of the pallas_kv8 tier qualifies; fp32 q and head dims 16, 32,
    64 take the scalar route."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] == STACKED_RING_HEAD_DIM
            and S <= STACKED_RING_MAX_KEYS)


def stacked_decode_attention_i8(q, kq, ks, vq, vs, valid, li: int,
                                n_keys: Optional[int] = None):
    """softmax(q · K[li]) @ V[li] over the int8 stacked cache -> [B, 1, H, Dh].

    Slots at or past `n_keys` (all S by default) count as masked and are not
    read: the decode step passes slot + 1, whose later slots are masked anyway.
    On the card, two routes by the declared rule `stacked_ring_eligible`,
    counted apart: the ring kernel (``stacked_decode_attention_i8``) and, for
    every other call, the scalar kernel (``stacked_decode_attention_i8_scalar``),
    which computes the same function. A launch that fails raises; neither route
    stands in for the other."""
    _build.no_grad_guard("stacked_decode_attention_i8", _DECODE_NO_GRAD, q, ks, vs)
    B, Tq, H, Dh = q.shape
    L, Bk, S, KDh = kq.shape
    Hkv = KDh // Dh
    if Tq != 1 or Bk != B or Hkv * Dh != KDh or H % Hkv:
        raise ValueError(f"stacked_decode_attention_i8: q {tuple(q.shape)} and kq "
                         f"{tuple(kq.shape)} disagree")
    if not 0 <= li < L:
        raise IndexError(f"stacked_decode_attention_i8: layer {li} of {L}")
    n = S if n_keys is None else int(n_keys)
    if not 1 <= n <= S:
        raise ValueError(f"stacked_decode_attention_i8: n_keys {n} outside [1, {S}]")
    if q.device.type == "cpu":
        return stacked_decode_attention_i8_plain(q, kq, ks, vq, vs, valid, li, n_keys)
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
    kernel = ("stacked_decode_attention_i8" if stacked_ring_eligible(q, S)
              else "stacked_decode_attention_i8_scalar")
    err = _build.launcher(kernel)(
        q.data_ptr(), kq[li].data_ptr(), ks[li].data_ptr(), vq[li].data_ptr(), vs[li].data_ptr(),
        v32.data_ptr(), out.data_ptr(), B, H, Hkv, S, Dh, n, _scale(Dh),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, kernel)
    _build.KERNEL_LAUNCHES[kernel] += 1
    return out


# --- int8 frozen prefill K/V (the turbo_kv8 tier) -----------------------------------------

SPLIT_I8_MAX_HEAD_DIM = 256    # csrc/split_attention_i8.cu: q held in shared memory
SPLIT_I8_MAX_KEYS = 4096       # T + A scores per (batch, head) in shared memory
SPLIT_RING_HEAD_DIM = 128      # the ring route: bf16 q at this head dim, n_rep of STACKED_REPS


def split_ring_eligible(q, n_rep: int) -> bool:
    """The declared rule of `split_attention_i8`'s two routes: bf16 q (and so
    bf16 kd / vd) at Dh = 128 with n_rep in 1, 2, 4, 8 takes the ring route
    (``split_attention_i8``); every other call the scalar route
    (``split_attention_i8_scalar``), each counted under its own name."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] == SPLIT_RING_HEAD_DIM
            and n_rep in STACKED_REPS)


def _repeat_heads(t: torch.Tensor, n_rep: int) -> torch.Tensor:
    return t if n_rep == 1 else torch.repeat_interleave(t, n_rep, dim=2)


def _split_i8(q, kq, ks, vq, vs, kd, vd, pre_valid, dec_valid, scores_dtype):
    """`split_attention_i8_plain`'s output and each (b, h) row's s_p [B, H]."""
    T = kq.shape[1]
    n_rep = q.shape[2] // kq.shape[2]
    kq, vq, kd, vd, ks, vs = (_repeat_heads(t, n_rep) for t in (kq, vq, kd, vd, ks, vs))
    scale = _scale(q.shape[-1])
    qf = q[:, 0].float()                                                  # [B, H, Dh]
    sq = div127(torch.clamp(qf.abs().amax(-1), min=1e-8))                # [B, H]
    qi = torch.clamp(torch.round(qf / sq[..., None]), -127, 127)
    # float64 products of int8 codes are exact: the int32 dot, converted to fp32 once
    sp = torch.einsum("bhd,bshd->bhs", qi.double(), kq.double()).float()
    sp = sp * sq[..., None] * ks.permute(0, 2, 1)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    add_pre = torch.where(pre_valid > 0, zero, neg)[:, None, :]
    add_dec = torch.where(dec_valid > 0, zero, neg)[:, None, :]
    sp = (sp * scale + add_pre).to(scores_dtype)
    sd = torch.einsum("bhd,bshd->bhs", qf, kd.float()).to(scores_dtype)
    sd = (sd.float() * scale + add_dec).to(scores_dtype)
    s = torch.cat([sp, sd], dim=-1).float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    pf = probs[..., :T] * vs.permute(0, 2, 1)                             # [B, H, T]
    spp = div127(torch.clamp(pf.abs().amax(-1), min=1e-12))               # [B, H]
    pi = torch.clamp(torch.round(pf / spp[..., None]), -127, 127)
    out_pre = torch.einsum("bhs,bshd->bhd", pi.double(), vq.double()).float() * spp[..., None]
    out_dec = torch.einsum("bhs,bshd->bhd", probs[..., T:].to(q.dtype).float(), vd.float())
    return (out_pre + out_dec).to(q.dtype)[:, None], spp


def split_attention_i8_plain(q, kq, ks, vq, vs, kd, vd, pre_valid, dec_valid,
                             scores_dtype=torch.float32):
    """The JAX package's ``_split_attention_i8``: q row-quantized over Dh
    (s_q = max(max|q|, 1e-8) / 127, codes clip(round(q / s_q), -127, 127)); the
    exact int32 q·Kp rescaled as (f32(acc) · s_q) · s_k, then · scale and the
    additive mask, rounded to `scores_dtype`; the decode segment q·Kd summed in
    fp32 and rounded to `scores_dtype`, then · scale + mask, rounded again; one
    fp32 softmax over [prefill | decode] (exp(s - max) / sum, an IEEE
    division); the prefill probabilities times the V scales, row-quantized
    with s_p = max(max|pf|, 1e-12) / 127, the exact int32 p·Vp times s_p; plus
    the decode probabilities cast to q's dtype times Vd summed in fp32; the
    sum cast to q's dtype. q [B, 1, H, Dh]; kq, vq int8 [B, T, Hkv, Dh]; ks, vs
    fp32 [B, T, Hkv]; kd, vd [B, A, Hkv, Dh]; pre_valid [B, T], dec_valid
    [B, A] (1 = attend) -> [B, 1, H, Dh]."""
    return _split_i8(q, kq, ks, vq, vs, kd, vd, pre_valid, dec_valid, scores_dtype)[0]


def compare_split_attention_i8(got, q, kq, ks, vq, vs, kd, vd, pre_valid, dec_valid,
                               scores_dtype=torch.float32, max_flips: int = 2) -> dict:
    """Hold a `split_attention_i8` output `got` to the plain version on the same
    inputs. The two differ only where fp32 sums run in another order (the
    softmax denominator, the decode segment) and in exp's last bits: a
    probability then moves by a few ulps, and where its code pf / s_p sits at
    a rounding tie it lands one step apart, moving the output by s_p · |vq|
    <= s_p · 127 in every element of the row. So every element must lie within
    `max_flips` such steps of its row's s_p, plus one step of the output
    dtype at the larger magnitude (bf16: 2^-7 relative; fp32: 2^-20), of the
    plain value. Raises AssertionError; returns the distances."""
    want, spp = _split_i8(q, kq, ks, vq, vs, kd, vd, pre_valid, dec_valid, scores_dtype)
    g, w = got.float()[:, 0], want.float()[:, 0]
    d = (g - w).abs()
    rel = 2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -20
    limit = max_flips * spp[..., None] * 127 + rel * torch.maximum(g.abs(), w.abs())
    stats = dict(max_abs_err=d.max().item(), n_apart=int((d > 0).sum()), n=d.numel(),
                 max_share_of_limit=(d / limit).max().item())
    assert bool((d <= limit).all()), f"split_attention_i8: outside the stated tolerance {stats}"
    return stats


def split_attention_i8(q, kq, ks, vq, vs, kd, vd, pre_valid, dec_valid,
                       scores_dtype=torch.float32):
    """softmax([q·Kp | q·Kd]) @ [Vp; Vd] for one decode token over an int8
    prefill segment and the generated-token buffer -> [B, 1, H, Dh], the
    function of `split_attention_i8_plain` (held to it by
    `compare_split_attention_i8`). On the card it takes q and kd/vd of one
    dtype, bf16 or fp32, head dims that are multiples of 4 up to 256 (the
    int8 dots take four codes a word), any n_rep, at most 4096 keys, every
    tensor contiguous, and raises on anything else; `split_ring_eligible`
    picks the route: the ring kernel ``split_attention_i8`` (K and V streamed
    per warp, exact integer dots on the fp16 tensor cores, the GQA heads in
    one pass, a cluster of CTAs where there are few (b, kv head) pairs) or
    ``split_attention_i8_scalar``. Neither stands in for the plain version
    or the reverse."""
    _build.no_grad_guard("split_attention_i8", _DECODE_NO_GRAD, q, ks, vs, kd, vd)
    B, Tq, H, Dh = q.shape
    Bk, T, Hkv, Dk = kq.shape
    A = kd.shape[1]
    if Tq != 1 or Bk != B or Dk != Dh or H % Hkv:
        raise ValueError(f"split_attention_i8: q {tuple(q.shape)} and kq {tuple(kq.shape)} "
                         "disagree")
    if q.device.type == "cpu":
        return split_attention_i8_plain(q, kq, ks, vq, vs, kd, vd, pre_valid, dec_valid,
                                        scores_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"split_attention_i8: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"split_attention_i8: q must be bf16 or fp32, got {q.dtype}")
    if scores_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"split_attention_i8: scores must be bf16 or fp32, got {scores_dtype}")
    if Dh % 4 or Dh > SPLIT_I8_MAX_HEAD_DIM or T + A > SPLIT_I8_MAX_KEYS or T < 1 or A < 1:
        raise ValueError(f"split_attention_i8: head dim {Dh} (a multiple of 4 up to "
                         f"{SPLIT_I8_MAX_HEAD_DIM}) and T + A = {T + A} keys (at most "
                         f"{SPLIT_I8_MAX_KEYS})")
    named = {"q": (q, (B, 1, H, Dh), q.dtype), "kq": (kq, (B, T, Hkv, Dh), torch.int8),
             "vq": (vq, (B, T, Hkv, Dh), torch.int8), "ks": (ks, (B, T, Hkv), torch.float32),
             "vs": (vs, (B, T, Hkv), torch.float32), "kd": (kd, (B, A, Hkv, Dh), q.dtype),
             "vd": (vd, (B, A, Hkv, Dh), q.dtype)}
    for name, (t, shape, dtype) in named.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"split_attention_i8: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"split_attention_i8: {name} must be contiguous and 16-byte "
                             f"aligned on {q.device}")
    for name, t, n in (("pre_valid", pre_valid, T), ("dec_valid", dec_valid, A)):
        if tuple(t.shape) != (B, n) or t.device != q.device:
            raise ValueError(f"{name} must be [{B}, {n}] on {q.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    pv = pre_valid.to(torch.int32).contiguous()
    dv = dec_valid.to(torch.int32).contiguous()
    out = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    kernel = ("split_attention_i8" if split_ring_eligible(q, H // Hkv)
              else "split_attention_i8_scalar")
    err = _build.launcher(kernel)(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), kd.data_ptr(),
        vd.data_ptr(), pv.data_ptr(), dv.data_ptr(), out.data_ptr(), B, H, Hkv, T, A, Dh,
        _scale(Dh), int(q.dtype == torch.bfloat16), int(scores_dtype == torch.bfloat16),
        _build.stream_ptr(q))
    _build.check(err, kernel)
    _build.KERNEL_LAUNCHES[kernel] += 1
    return out
