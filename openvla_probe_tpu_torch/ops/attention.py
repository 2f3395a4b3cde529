"""Attention for the Llama prefill, the ViT towers and the decode steps.

Counterpart of ``openvla_probe_tpu/ops/attention.py`` (the one-shot and the
blockwise flash Pallas kernels and the ViT kernel) and of the XLA attention
the JAX package decodes with (``models/llama.py::attention`` at Tq = 1). Each
public function is a wrapper that launches a hand-written CUDA kernel
(``csrc/*.cu``) for a CUDA tensor, and takes the plain PyTorch version beside
it only for a tensor that lies on the CPU. There is no fallback on the card:
a CUDA input the kernel does not take raises. Each wrapper counts its kernel
launches in the package's one registry, ``_build.KERNEL_LAUNCHES``
(re-exported here), so a run can show that the main path went through them.

Layouts are the JAX package's: q/k/v ``[B, T, H, Dh]`` (K/V heads already
repeated), ``kv_valid`` ``[B, Tk]`` with 1 = attend.

The kernels have no backward, as the JAX package's Pallas attention has no
VJP: every wrapper refuses an input that requires grad while autograd
records. Training takes `attention_plain` (``LlamaConfig.flash_attn`` /
``ViTConfig.flash_attn`` off, the JAX package's ``OVLA_PALLAS_ATTN=0``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from ._build import KERNEL_LAUNCHES, reset_launch_counts  # noqa: F401  (re-exported)

NEG_INF = -2.3819763e38
# key length up to which flash_attention takes the one-shot kernel (it holds
# whole fp32 score rows, <= 128 KB / 32 rows); longer rows take the blockwise
# kernel, the JAX wrapper's split (_ONESHOT_MAX_TK)
ONESHOT_MAX_TK = 1024
MAX_HEAD_DIM = 128

def _scale(dh: int) -> float:
    # the JAX kernels multiply by the float32 rounding of 1/sqrt(Dh)
    return float(np.float32(1.0 / np.sqrt(dh)))


# --- plain PyTorch versions ----------------------------------------------------


def flash_attention_plain(q, k, v, kv_valid, offset: int = 0, causal: bool = True):
    """The one-shot prefill kernel's function in plain PyTorch.

    s = (q . k in fp32) * scale; masked scores = NEG_INF; p = exp(s - m);
    P cast to the input dtype for PV with fp32 accumulation;
    out = pv / max(l, 1e-30). A row with every key masked has p = 1 on each
    of the Tk keys, so its output is the mean of V."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    qh = q.permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    s = torch.matmul(qh, kh.transpose(-1, -2)) * _scale(Dh)          # [B, H, Tq, Tk]
    ok = (kv_valid > 0)[:, None, None, :]
    if causal:
        qi = torch.arange(Tq, device=q.device)[:, None] + offset
        ki = torch.arange(Tk, device=q.device)[None, :]
        ok = ok & (ki <= qi)
    s = s.masked_fill(~ok, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), vh)
    out = (pv / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.permute(0, 2, 1, 3)


def flash_attention_blockwise_plain(q, k, v, kv_valid, offset: int = 0, causal: bool = True):
    """The blockwise flash kernel's function in plain PyTorch, computed
    directly in fp32 (its online softmax gives the same function up to fp32
    rounding): q upcast and multiplied by scale before the dot; masked scores
    = NEG_INF; p = exp(s - m) kept in fp32 for PV; out = pv / max(l, 1e-30)
    cast to the input dtype. A row with every key masked has p = 1 on each of
    the Tk keys, so its output is the mean of V (the JAX kernel also counts
    the keys it pads Tk with up to a multiple of 128: ROADMAP Queue 3)."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    qh = q.permute(0, 2, 1, 3).float() * _scale(Dh)
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    s = torch.matmul(qh, kh.transpose(-1, -2))                        # [B, H, Tq, Tk]
    ok = (kv_valid > 0)[:, None, None, :]
    if causal:
        qi = torch.arange(Tq, device=q.device)[:, None] + offset
        ki = torch.arange(Tk, device=q.device)[None, :]
        ok = ok & (ki <= qi)
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p, vh) / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.permute(0, 2, 1, 3)


def _within_one_bf16_step(got, want, max_share: float, kernel: str, slack=None) -> dict:
    """Every element of `got` within one bf16 step of `want` (the step at the
    larger of the two magnitudes, and at no less than 1/64 of the largest
    output: an output near 0 is a sum that cancels, whose fp32 error is that
    of its terms), plus `slack` where given, and at most max(16, max_share of
    the elements) apart at all; fp32 outputs within 1e-5. Raises
    AssertionError; returns the distances (`max_steps`: the largest distance
    in bf16 steps, `n_past_one_step`: the elements more than one step apart)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    stats = dict(max_abs_err=d.max().item(), n_apart=int((d > 0).sum()), n=d.numel())
    if got.dtype == torch.float32:
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
        return stats
    # the bf16 spacing (8 significant bits) at the larger magnitude of the two
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=w.abs().max().item() / 64)
    _, e = torch.frexp(mag)
    step = torch.ldexp(torch.ones_like(w), e - 8)
    stats["max_steps"] = (d / step).max().item()
    stats["n_past_one_step"] = int((d > step).sum())
    allowed = step if slack is None else step + slack.float()
    assert bool((d <= allowed).all()), \
        f"{kernel}: an element more than one bf16 step off {stats}"
    limit = max(16, int(max_share * d.numel()))
    assert stats["n_apart"] <= limit, f"{kernel}: {stats['n_apart']} elements apart > {limit} {stats}"
    return stats


def compare_blockwise(got, want, max_share: float = 2e-2, kernel: str = "blockwise") -> dict:
    """Hold a blockwise flash output `got` to the plain version `want` (also
    the ViT kernel's, ``kernel="vit_attention"``: the same numeric class).

    fp32: within 1e-5 (the same fp32 function, sums in another order). bf16:
    every element within one bf16 step of the plain version, at most
    max(16, max_share of the elements) apart (`_within_one_bf16_step`). The
    kernel carries p to about 2^-16 of its value and differs from the plain
    version by about 1e-6 before the output is rounded, so few elements land
    on the other bf16 neighbour (0.2 % for the kernel's arithmetic emulated
    on the CPU at Tk = 1100); an attention that rounds P to bf16 (the
    one-shot class, `flash_attention_plain`) moves the output by about 1e-3
    of its size and lands one step apart on some 40 % of them, which this
    check refuses (tests/test_torch_flash_blockwise.py). Raises
    AssertionError; returns the distances."""
    return _within_one_bf16_step(got, want, max_share, kernel)


def oneshot_slack(q, k, v, kv_valid, offset: int = 0, causal: bool = True):
    """Per element of the one-shot function's output [B, Tq, H, Dh], the most
    that rounding P to bf16 can move it when the scores are summed in another
    fp32 order than `flash_attention_plain`'s. Two fp32 sums of Dh exact
    products differ by at most 2 (Dh - 1) u sum_i |q_i k_i| (u = 2^-24;
    doubled again here for a tensor core's accumulation); p = exp(s - m)
    then moves by that of its score and of the row's max, and a p that lies
    so near a bf16 rounding point rounds to its other neighbour: the slack of
    an output is the sum of those possible flips of bf16(P) times |v|, over
    l. Zero for a row with every key masked (p = 1 exactly) and small for a
    long row, it is what keeps a correct kernel within reach of
    `compare_oneshot` on the rows with few keys (the first rows of a causal
    prefill, where one P flip moves the output by several bf16 steps)."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    u = 2.0 ** -24
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * _scale(Dh)
    ok = (kv_valid > 0)[:, None, None, :]
    if causal:
        qi = torch.arange(Tq, device=q.device)[:, None] + offset
        ok = ok & (torch.arange(Tk, device=q.device)[None, :] <= qi)
    s = s.masked_fill(~ok, NEG_INF)
    m, arg = s.max(dim=-1, keepdim=True)
    err = (4 * Dh * u * _scale(Dh)) * torch.matmul(qh.abs(), kh.abs().transpose(-1, -2))
    err = (err + 4 * u * s.abs()).masked_fill(~ok, 0.0)
    e = err + err.gather(-1, arg) + 8 * u       # the score, the max, two expf roundings
    p = torch.exp(s - m)
    flips = ((p * torch.exp(e)).to(torch.bfloat16).float()
             - (p * torch.exp(-e)).to(torch.bfloat16).float())
    slack = torch.matmul(flips, vh.abs()) / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return slack.permute(0, 2, 1, 3)


def compare_oneshot(got, want, max_share: float = 2e-2, slack=None) -> dict:
    """Hold a one-shot flash output `got` (the `flash_prefill` kernel) to
    `flash_attention_plain`'s `want`: the same scores, the same whole-row max,
    P rounded to bf16 once, fp32 sums in another order. fp32: within 1e-5.
    bf16: every element within one bf16 step plus `slack` (`oneshot_slack`
    of the inputs: where the kernel's scores, summed in another order, round
    a p to its other bf16 neighbour; None holds it to one step, for an
    emulation with the plain version's scores), at most max(16, max_share of
    the elements) apart (`_within_one_bf16_step`). An attention of another
    numeric class fails it on the same inputs: fp32 P
    (`flash_attention_blockwise_plain`) or a P rounded against a running max
    and rescaled (an online softmax) moves most outputs of the longer rows by
    about a bf16 step of P, 2^-9 of its size, so far more than 2 % of them
    land on another bf16 neighbour (tests/test_torch_kernel_arith_oneshot.py,
    chip_smoke.py). Raises AssertionError; returns the distances."""
    return _within_one_bf16_step(got, want, max_share, "flash_prefill", slack)


def vit_flash_attention_plain(q, k, v):
    """The ViT tower kernel's function in plain PyTorch: q upcast and scaled
    before an fp32 dot, fp32 P, fp32 PV, cast to the input dtype."""
    Dh = q.shape[-1]
    qh = q.permute(0, 2, 1, 3).float() * _scale(Dh)
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    s = torch.matmul(qh, kh.transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (torch.matmul(p, vh) / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.permute(0, 2, 1, 3)


_TRAIN_ATTN = ("train with the plain attention, the JAX package's XLA branch "
               "(LlamaConfig / ViTConfig flash_attn=False: attention_plain)")
_DECODE_NO_GRAD = "decoding runs under torch.no_grad(); differentiate through attention_plain"


def attention_plain(q, k, v, mask, scores_dtype=torch.float32):
    """Masked softmax(q kᵀ) v, the JAX package's XLA branch: scores in
    `scores_dtype` (fp32 = parity, bf16 = turbo) plus the additive mask
    [B, 1, Tq, Tk], fp32 softmax, probs cast to the input dtype, PV with fp32
    accumulation."""
    scale = _scale(q.shape[-1])
    scores = torch.matmul(q.permute(0, 2, 1, 3).float(), k.permute(0, 2, 3, 1).float())
    scores = scores.to(scores_dtype)
    scores = (scores * scale + mask.to(scores_dtype)).to(scores_dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.matmul(probs.float(), v.permute(0, 2, 1, 3).float())   # [B, H, Tq, Dh]
    return out.to(q.dtype).permute(0, 2, 1, 3)


def decode_attention_plain(q, k, v, kv_valid, offset: int, scores_dtype=torch.float32):
    """`attention_plain` for one query at absolute position `offset`: keys c
    with kv_valid[b, c] > 0 and c <= offset are attended. With bf16 scores
    (turbo), q·k, its product with the scale and the masked score are each
    rounded to bf16, as in the JAX package's XLA branch."""
    ok = (kv_valid > 0) & (torch.arange(k.shape[1], device=k.device) <= offset)[None]
    zero = torch.zeros((), dtype=torch.float32, device=k.device)
    return attention_plain(q, k, v, torch.where(ok, zero, NEG_INF)[:, None, None, :], scores_dtype)


def compare_bf16_scores(got, want, want_fp32) -> dict:
    """Hold a bf16-score decode output `got` to the bf16-score plain version
    `want`: within 4e-3 everywhere (a score whose fp32 sum lands at a bf16
    rounding tie may round the other way in the kernel's sum order), and on
    average at most a tenth as far from it as from the fp32-score plain
    version `want_fp32` (whether q·k is rounded to bf16, or the probabilities
    to the activation dtype, moves the output by 1e-4 to 4e-4 on average at
    unit-normal inputs; the kernel's other sum order by about 1e-7). Raises
    AssertionError otherwise; returns the distances."""
    g = got.float()
    d = (g - want.float()).abs()
    stats = dict(max_abs_err=d.max().item(), mean_abs_err=d.mean().item(),
                 mean_abs_to_fp32_scores=(g - want_fp32.float()).abs().mean().item())
    assert stats["max_abs_err"] <= 4e-3, f"bf16 scores: too far from the plain version {stats}"
    assert 10 * stats["mean_abs_err"] <= stats["mean_abs_to_fp32_scores"], \
        f"bf16 scores: not clearly nearer the bf16-score plain version than the fp32 one {stats}"
    return stats


# --- kernel wrappers -------------------------------------------------------------


def _check_head_slab(name: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        raise ValueError(f"{name}: the [H, Dh] slab of each token must be contiguous "
                         f"(strides {t.stride()})")


def _check_cuda_inputs(kernel: str, q, k, v) -> None:
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"{kernel}: q/k/v on different devices")
        if t.dtype != q.dtype:
            raise ValueError(f"{kernel}: q/k/v dtypes differ ({q.dtype}, {t.dtype})")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel}: the CUDA kernel takes bf16 or fp32, got {q.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{kernel}: head dim {q.shape[-1]} > {MAX_HEAD_DIM}")


def _launch_flash(kernel: str, q, k, v, kv_valid, offset: int, causal: bool):
    """Launch one of the two masked flash kernels (the same C interface) on
    CUDA tensors, after checking what the kernel takes."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {q.device}")
    _check_cuda_inputs(kernel, q, k, v)
    _check_head_slab("q", q, (B, Tq, H, Dh))
    _check_head_slab("k", k, (B, Tk, H, Dh))
    _check_head_slab("v", v, (B, Tk, H, Dh))
    if tuple(kv_valid.shape) != (B, Tk) or kv_valid.device != q.device:
        raise ValueError(f"kv_valid must be [{B}, {Tk}] on {q.device}, "
                         f"got {tuple(kv_valid.shape)} on {kv_valid.device}")
    valid = kv_valid.to(torch.int32).contiguous()
    out = torch.empty((B, Tq, H, Dh), dtype=q.dtype, device=q.device)
    err = _build.launcher(kernel)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), valid.data_ptr(),
        B, H, Tq, Tk, Dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), _scale(Dh), int(offset), int(bool(causal)),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, kernel)
    KERNEL_LAUNCHES[kernel] += 1
    return out


def prefill_mma_eligible(q, k, v) -> bool:
    """The declared rule of `flash_attention`'s tensor-core route (the
    one-shot kernel at Tk <= 1024): bf16, a head dim of 64 or 128, and
    16-byte aligned rows (data pointers, batch and token strides: the TMA
    maps' rule). Every serving path and score_short qualify: [B, T, 32, 128]
    bf16, K / V as views of the stacked cache."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128)
            and all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
                    for t in (q, k, v)))


def flash_attention(q, k, v, kv_valid, offset: int = 0, causal: bool = True):
    """Causal + key-validity masked softmax(q kᵀ / sqrt(Dh)) v.

    q [B, Tq, H, Dh]; k/v [B, Tk, H, Dh]; kv_valid [B, Tk]. Returns
    [B, Tq, H, Dh] in q's dtype. Dispatches by key length as the JAX wrapper
    does: Tk <= 1024 takes the one-shot kernel (function of
    `flash_attention_plain`), longer rows the blockwise one
    (`flash_attention_blockwise`). On the card the one-shot kernel has two
    routes by a declared rule (`prefill_mma_eligible`), counted apart: the
    tensor-core kernel (``flash_prefill``) and, for every other call (fp32
    inputs, other head dims, unaligned rows), the scalar fp32-FMA kernel
    (``flash_prefill_scalar``), which computes the same function. A launch
    that fails raises; neither route stands in for the other."""
    _build.no_grad_guard("flash_attention", _TRAIN_ATTN, q, k, v)
    if k.shape[1] > ONESHOT_MAX_TK:
        return flash_attention_blockwise(q, k, v, kv_valid, offset, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid, offset, causal)
    kernel = "flash_prefill" if prefill_mma_eligible(q, k, v) else "flash_prefill_scalar"
    return _launch_flash(kernel, q, k, v, kv_valid, offset, causal)


def flash_attention_blockwise(q, k, v, kv_valid, offset: int = 0, causal: bool = True):
    """The blockwise online-softmax flash attention, any key length (the
    function of `flash_attention_blockwise_plain`; the kernel's own tiles
    take the place of the JAX wrapper's block_q / block_k). Layouts as
    `flash_attention`."""
    _build.no_grad_guard("flash_attention_blockwise", _TRAIN_ATTN, q, k, v)
    if q.device.type == "cpu":
        return flash_attention_blockwise_plain(q, k, v, kv_valid, offset, causal)
    return _launch_flash("flash_blockwise", q, k, v, kv_valid, offset, causal)


def vit_mma_eligible(q, k, v) -> bool:
    """The declared rule of `vit_flash_attention`'s tensor-core route: bf16,
    a head dim that is a multiple of 8 up to 128, and 16-byte aligned rows
    (data pointers, batch and token strides). Both towers qualify: head
    offsets of 128 / 144 bytes inside a qkv row, token strides of 6144 / 6912
    bytes; so do the tiny towers' Dh = 16."""
    Dh = q.shape[-1]
    return (q.dtype == torch.bfloat16 and Dh % 8 == 0 and 8 <= Dh <= MAX_HEAD_DIM
            and all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
                    for t in (q, k, v)))


def vit_flash_attention(q, k, v):
    """Full (unmasked) bidirectional attention for the ViT towers.

    q/k/v [B, N, H, Dh] (each token's [H, Dh] slab contiguous; batch and token
    strides free, so slices of one fused qkv product are read in place).
    Any N. Returns [B, N, H, Dh] in q's dtype, the function of
    `vit_flash_attention_plain`. On the card, two routes by a declared rule
    (`vit_mma_eligible`), counted apart: a call the rule admits takes the
    tensor-core flash kernel (``vit_attention``); every other call (fp32
    inputs, other head dims, unaligned rows) the scalar fp32-FMA kernel
    (``vit_attention_scalar``), which computes the same function. A launch
    that fails raises; neither route stands in for the other."""
    _build.no_grad_guard("vit_flash_attention", _TRAIN_ATTN, q, k, v)
    B, N, H, Dh = q.shape
    if q.device.type == "cpu":
        return vit_flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"vit_flash_attention: unsupported device {q.device}")
    _check_cuda_inputs("vit_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_head_slab(name, t, (B, N, H, Dh))
    out = torch.empty((B, N, H, Dh), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, N, Dh, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), _scale(Dh))
    if vit_mma_eligible(q, k, v):
        kernel = "vit_attention"
        err = _build.launcher(kernel)(*args, _build.stream_ptr(q))
    else:
        kernel = "vit_attention_scalar"
        err = _build.launcher(kernel)(*args, int(q.dtype == torch.bfloat16),
                                      _build.stream_ptr(q))
    _build.check(err, kernel)
    KERNEL_LAUNCHES[kernel] += 1
    return out


DECODE_RING_HEAD_DIM = 128
DECODE_RING_MAX_KEYS = 4096


def decode_ring_eligible(q, *kv) -> bool:
    """The declared rule of the decode attentions' ring route (`decode_attention`
    and `decode_attention.decode_flash_attention`), the whole of what its
    launchers take: bf16 at a head dim of 128; `kv` the K and V of each key
    segment in order ((k, v), or the split decode's (kp, vp, kd, vd)), every
    segment at least one key and all of them at most DECODE_RING_MAX_KEYS;
    every K/V tensor's data pointer, batch and token strides 16-byte aligned
    (the launchers copy whole rows in bulk). Every serving decode and
    generate's qualify: one layer's [B, S, 32, 128] slice of the stacked bf16
    buffers."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] == DECODE_RING_HEAD_DIM
            and all(t.shape[1] >= 1 for t in kv)
            and sum(t.shape[1] for t in kv[::2]) <= DECODE_RING_MAX_KEYS
            and all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
                    for t in kv))


def decode_attention(q, k, v, kv_valid, offset: int, scores_dtype=torch.float32):
    """One decode query per (batch, head) over the stacked cache.

    q [B, 1, H, Dh]; k/v [B, S, H, Dh] (one layer of the cache, heads already
    repeated); kv_valid [B, S]; the query sits at position `offset`; scores in
    fp32 (parity) or bf16 (turbo). Returns [B, 1, H, Dh] in q's dtype, the
    function of `decode_attention_plain`. On the card, two routes by a
    declared rule (`decode_ring_eligible`), counted apart: the ring kernel
    (``decode_attention``) and, for every other call (fp32, other head dims,
    unaligned rows), the scalar kernel (``decode_attention_scalar``), which
    computes the same function. A launch that fails raises; neither route
    stands in for the other."""
    if scores_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: scores in fp32 or bf16, got {scores_dtype}")
    _build.no_grad_guard("decode_attention", _DECODE_NO_GRAD, q, k, v)
    B, Tq, H, Dh = q.shape
    S = k.shape[1]
    if Tq != 1:
        raise ValueError(f"decode_attention takes one query per row, got Tq={Tq}")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_valid, offset, scores_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check_cuda_inputs("decode_attention", q, k, v)
    _check_head_slab("q", q, (B, 1, H, Dh))
    _check_head_slab("k", k, (B, S, H, Dh))
    _check_head_slab("v", v, (B, S, H, Dh))
    if tuple(kv_valid.shape) != (B, S) or kv_valid.device != q.device:
        raise ValueError(f"kv_valid must be [{B}, {S}] on {q.device}, "
                         f"got {tuple(kv_valid.shape)} on {kv_valid.device}")
    valid = kv_valid.to(torch.int32).contiguous()
    out = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    kernel = "decode_attention" if decode_ring_eligible(q, k, v) else "decode_attention_scalar"
    err = _build.launcher(kernel)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), valid.data_ptr(),
        B, H, S, Dh, q.stride(0), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        _scale(Dh), int(offset), int(scores_dtype == torch.bfloat16),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(err, kernel)
    KERNEL_LAUNCHES[kernel] += 1
    return out
