"""Linear layers of the port (counterpart of ``openvla_probe_tpu/ops/linear.py``).

``matmul_t(x, w) = x @ w.T`` with ``w`` in the JAX package's ``[O, K]``
layout, for three kinds of leaf:

* a float tensor: the JAX package leaves this product to XLA outside any
  Pallas kernel, and the port leaves it to ``torch.matmul`` (bf16 products
  with fp32 accumulation, fp32 in full fp32: see the package's numerics
  flags);
* a per-channel int8 leaf ``{"q": int8 [O, K], "s": f32 [O]}``: the
  weight-only int8 kernel ``wi8_matmul`` (``csrc/wi8_matmul.cu``), which is
  the JAX dispatch under its kernel gate (``_wi8_matmul_2d``);
* a grouped-int4 leaf ``{"q": uint8 [G, O, gsz/2], "s": f32 [O, G]}``: the
  w4a8 kernel ``w4a8_matmul`` (``csrc/w4a8_matmul.cu``) where ``O % 128 == 0``
  and ``gsz % 128 == 0``, else the requant route (``w4a8_dot_requant``:
  int8 codes with per-channel scales, then ``w8a8_dot``). That is the JAX
  package's rule under its kernel gate as it runs on the chip
  (``_w4a8_pallas_matmul``; its interpret mode drops the ``gsz`` condition).

**Packed int4 layout.** Codes are stored group-major as in the JAX package
(``[..., G, O, gsz]``, ``quantize_weight_int4``), two per byte: ``uint8
[..., G, O, gsz/2]``, byte ``j`` holding code ``2j`` in its low nibble and
code ``2j + 1`` in its high nibble, each in two's complement. One 16-byte
load gives 32 consecutive k of one output channel. The ``uint8`` type keeps a
packed leaf from ever passing for a per-channel int8 one.

Mix, nibble and LoRA leaves are not ported and raise. ``quantize_weight``,
``quantize_weight_int4`` and ``quantize_params`` give codes and scales
bit-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import _build

_DEFAULT_QUANT_SUFFIXES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    "lm_head",
)
VIT_QUANT_SUFFIXES = ("qkv_w", "proj_w", "fc1_w", "fc2_w")
TURBO_QUANT_SUFFIXES = _DEFAULT_QUANT_SUFFIXES + VIT_QUANT_SUFFIXES
GROUP_SIZE = 128          # the JAX package's default int4 group size
W4A8_TILE = 128           # N and gsz the w4a8 kernel takes (multiples of)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def is_int8_per_channel(w: Any) -> bool:
    """A ``{"q": int8 [..., O, I], "s": f32 [..., O]}`` leaf (not the grouped
    int4 codes form, whose scales carry a group axis, nor a mix leaf)."""
    return (is_quantized(w) and set(w) == {"q", "s"} and w["q"].dtype == torch.int8
            and tuple(w["s"].shape) == tuple(w["q"].shape[:-1]))


def is_grouped_int4(w: Any) -> bool:
    """A packed grouped-int4 leaf ``{"q": uint8 [..., G, O, gsz/2], "s": f32 [..., O, G]}``."""
    if not (is_quantized(w) and set(w) == {"q", "s"} and w["q"].dtype == torch.uint8):
        return False
    q, s = w["q"], w["s"]
    return (q.dim() == s.dim() + 1 and q.shape[-3] == s.shape[-1]
            and q.shape[-2] == s.shape[-2])


def index_layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer `i` of a layer-stacked parameter tree (quantized leaves are
    {q, s} dicts whose tensors all carry the layer axis)."""
    return {k: index_layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as an IEEE division, on every device. (PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, which can round differently
    from the JAX package's division.)"""
    return x / x.new_full((), c)


def div127(x: torch.Tensor) -> torch.Tensor:
    return _div(x, 127.0)


def quantize_rows(hf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activation quantization (the JAX package's
    ``_quantize_activations``): fp32 [M, K] -> (int8 codes [M, K], fp32
    scales [M, 1])."""
    sx = torch.clamp(div127(hf.abs().amax(dim=-1, keepdim=True)), min=1e-8)
    return torch.clamp(torch.round(hf / sx), -127, 127).to(torch.int8), sx


def int8_dot(codes: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact integer accumulators codes [M, K] · q [N, K]ᵀ, as fp32 (the
    int32 -> fp32 conversion's rounding): float64 products of int8 codes are
    exact (|acc| <= 127² · K < 2⁵³), where fp32 would round past 2²⁴."""
    return torch.matmul(codes.double(), q.double().t()).float()


# --- quantization ---------------------------------------------------------------


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of [..., O, I]."""
    wf = w.float()
    s = torch.clamp(div127(wf.abs().amax(dim=-1)), min=1e-8)
    q = torch.clamp(torch.round(wf / s[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], [..., 2n] -> uint8 [..., n] (the packed layout)."""
    if codes.shape[-1] % 2:
        raise ValueError(f"pack_int4: odd last dim {codes.shape[-1]}")
    u = codes.contiguous().view(torch.uint8) & 0xF
    return (u[..., 0::2] | (u[..., 1::2] << 4)).contiguous()


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., n] -> int8 codes [..., 2n] in [-8, 7] (sign-extended nibbles)."""
    nib = torch.stack([packed & 0xF, packed >> 4], dim=-1).to(torch.int8)
    return torch.where(nib >= 8, nib - 16, nib).reshape(*packed.shape[:-1], -1)


def int4_group_size(in_dim: int, group_size: int = GROUP_SIZE) -> int:
    """The group size of an in-dim (tiny dims: one group per row), or 0 where
    the in-dim has no usable group and the leaf stays per-channel int8 (the
    JAX package's bits=4 fallback; SigLIP's mlp dim 4304)."""
    gsz = min(group_size, in_dim)
    return 0 if in_dim % gsz else gsz


def quantize_weight_int4(w: torch.Tensor, group_size: int = GROUP_SIZE) -> Dict[str, torch.Tensor]:
    """Symmetric per-(output-channel, input-group) int4 quantization:
    [..., O, I] -> {"q": packed uint8 [..., G, O, gsz/2], "s": f32 [..., O, G]},
    s = max(max|w| / 7, 1e-8), codes clip(round(w / s), -7, 7)."""
    wf = w.float()
    *lead, O, I = wf.shape
    gsz = int4_group_size(I, group_size)
    if not gsz or gsz % 2:
        raise ValueError(f"in-dim {I} has no even group size <= {group_size}")
    gw = wf.reshape(*lead, O, I // gsz, gsz)
    s = torch.clamp(_div(gw.abs().amax(dim=-1), 7.0), min=1e-8)
    codes = torch.clamp(torch.round(gw / s[..., None]), -7, 7).to(torch.int8)
    return {"q": pack_int4(codes.movedim(-2, -3)), "s": s}


def quantize_leaf(w: torch.Tensor, bits: int = 8, group_size: int = GROUP_SIZE) -> Dict[str, torch.Tensor]:
    """One weight leaf as `quantize_params` quantizes it: grouped int4 where
    bits=4 and the in-dim has a group, else per-channel int8."""
    if bits == 4 and int4_group_size(w.shape[-1], group_size):
        return quantize_weight_int4(w, group_size)
    return quantize_weight(w)


def dequantize_weight(w: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """Per-channel int8 or grouped int4 -> float [..., O, I] (the JAX branches)."""
    if is_grouped_int4(w):
        codes = unpack_int4(w["q"]).float()                       # [..., G, O, gsz]
        wf = codes * w["s"].movedim(-1, -2)[..., None]
        *lead, G, O, gsz = wf.shape
        return wf.movedim(-3, -2).reshape(*lead, O, G * gsz).to(dtype)
    return (w["q"].float() * w["s"][..., None]).to(dtype)


def quantize_params(params: Any, suffixes: tuple = _DEFAULT_QUANT_SUFFIXES, bits: int = 8,
                    group_size: int = GROUP_SIZE) -> Any:
    """Quantize the weight leaves whose name is in `suffixes` (and that have
    at least two dims): bits=8 per-channel int8, bits=4 grouped int4 (an
    in-dim with no usable group falls back to per-channel int8); everything
    else passes through."""
    if bits in ("mix", "nibble"):
        raise NotImplementedError(
            f"quantize_params(bits={bits!r}): mix and nibble weights are not ported yet "
            "(ROADMAP Queue 1 items 7 and 10)")
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4, 8, 'mix' or 'nibble', got {bits!r}")

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in suffixes and tree.dim() >= 2:
            return quantize_leaf(tree, bits, group_size)
        return tree

    return walk(params, "")


# --- weight-only int8 matmul (Queue 2 row 7) ---------------------------------


def wi8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's function: bf16(q) is exact, so x · qᵀ in fp32 (full
    fp32, no TF32), then · s in fp32, cast to x's dtype."""
    return (torch.matmul(x.float(), q.float().t()) * s.float()).to(x.dtype)


def _check_matmul_inputs(kernel: str, x: torch.Tensor, named: Dict[str, Tuple]) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel}: x must be bf16 or fp32, got {x.dtype}")
    for name, (t, shape, dtype) in named.items():
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def wi8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16 or fp32) @ int8 q [N, K].T * s [N] -> [M, N] in x's dtype."""
    M, K = x.shape
    N = q.shape[0]
    if x.device.type == "cpu":
        return wi8_matmul_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"wi8_matmul: unsupported device {x.device}")
    _check_matmul_inputs("wi8_matmul", x, {"x": (x, (M, K), x.dtype), "q": (q, (N, K), torch.int8),
                                           "s": (s, (N,), torch.float32)})
    if K % 16:
        raise ValueError(f"wi8_matmul: K={K} must be a multiple of 16")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.launcher("wi8_matmul")(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "wi8_matmul")
    _build.KERNEL_LAUNCHES["wi8_matmul"] += 1
    return out


# --- w8a8: per-row int8 activations x per-channel int8 weights -------------------


def w8a8_dot_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_w8a8_dot`` forward: per-row int8 activation codes,
    the exact int32 product, ``(acc · s_x) · s`` in fp32, cast to x's dtype."""
    codes, sx = quantize_rows(x.float())
    return (int8_dot(codes, q) * sx * s[None, :]).to(x.dtype)


def w8a8_dot(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ int8 q [N, K].T with int8 activations -> [M, N] in x's dtype.

    The JAX package computes this in XLA, outside any Pallas kernel; on a card
    the int32 product is ``torch._int_mm`` (a library call, counted in
    ``_build.LIBRARY_CALLS``, not a kernel of the port). The hand kernel is
    ROADMAP Queue 2's XLA-op row."""
    if x.device.type == "cpu":
        return w8a8_dot_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_dot: unsupported device {x.device}")
    M, K = x.shape
    N = q.shape[0]
    if K % 8 or N % 8:
        raise ValueError(f"w8a8_dot: K={K} and N={N} must be multiples of 8 (torch._int_mm)")
    codes, sx = quantize_rows(x.float())
    if M <= 16:   # torch._int_mm takes more than 16 rows: zero rows add nothing
        codes = torch.cat([codes, codes.new_zeros((17 - M, K))])
    acc = torch._int_mm(codes, q.t())[:M]
    _build.LIBRARY_CALLS["w8a8_dot"] += 1
    return (acc.float() * sx * s[None, :]).to(x.dtype)


# --- w4a8: grouped int4 weights x int8 activations (Queue 2 row 8) ---------------


def requant_int4_to_int8(q: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped int4 [G, N, gsz/2] packed + [N, G] scales -> per-channel int8
    codes [N, G·gsz] and scales [N] (the JAX package's ``_w4a8_dot_requant``):
    s8 = max_g s · (7/127), codes clip(round(q · s / (s8 + 1e-30)), -127, 127)."""
    G, N, half = q.shape
    s8 = s.amax(dim=-1) * (7.0 / 127.0)
    r = (s / (s8[:, None] + 1e-30)).t()[..., None]                 # [G, N, 1]
    q8 = torch.clamp(torch.round(unpack_int4(q).float() * r), -127, 127).to(torch.int8)
    return q8.movedim(0, 1).reshape(N, G * 2 * half), s8


def w4a8_dot_requant(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The requant route: int8 codes requantized per call (no resident copy),
    then `w8a8_dot`."""
    return w8a8_dot(x, *requant_int4_to_int8(q, s))


def w4a8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's function: per-row int8 activation codes; per group g,
    in order, the exact int32 product of the group's codes, folded as
    ``acc = acc + f32(p) · s[:, g]`` (two fp32 roundings); ``(acc · s_x)``
    cast to x's dtype."""
    M, K = x.shape
    G, N, half = q.shape
    gsz = 2 * half
    codes, sx = quantize_rows(x.float())
    w = unpack_int4(q)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        acc = acc + int8_dot(codes[:, g * gsz:(g + 1) * gsz], w[g]) * s[:, g]
    return (acc * sx).to(x.dtype)


def w4a8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16 or fp32) @ grouped int4 (packed q [G, N, gsz/2], s [N, G])
    -> [M, N] in x's dtype. The CUDA kernel takes N and gsz multiples of 128."""
    M, K = x.shape
    G, N, half = q.shape
    gsz = 2 * half
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"w4a8_matmul: unsupported device {x.device}")
    _check_matmul_inputs("w4a8_matmul", x, {
        "x": (x, (M, G * gsz), x.dtype), "q": (q, (G, N, half), torch.uint8),
        "s": (s, (N, G), torch.float32)})
    if N % W4A8_TILE or gsz % W4A8_TILE or gsz > 4096 or G > W4A8_TILE:
        raise ValueError(f"w4a8_matmul: N={N} and the group size {gsz} (<= 4096) must be "
                         f"multiples of {W4A8_TILE}, with at most {W4A8_TILE} groups (got {G})")
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)   # the activation pre-pass
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.launcher("w4a8_matmul")(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), codes.data_ptr(),
        sx.data_ptr(), M, N, K, gsz, int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "w4a8_matmul")
    _build.KERNEL_LAUNCHES["w4a8_matmul"] += 1
    return out


def takes_w4a8_kernel(w: Dict[str, torch.Tensor]) -> bool:
    """The grouped-int4 dispatch rule: the kernel where N and gsz are
    multiples of 128, the requant route otherwise."""
    _, N, half = w["q"].shape[-3:]
    return N % W4A8_TILE == 0 and (2 * half) % W4A8_TILE == 0


def matmul_t(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [..., K] @ w[O, K].T -> [..., O] for a float weight tensor, a
    per-channel int8 leaf or a grouped-int4 leaf."""
    if isinstance(w, torch.Tensor):
        return torch.matmul(x, w.t())
    lead, K = x.shape[:-1], x.shape[-1]
    if is_int8_per_channel(w):
        out = wi8_matmul(x.reshape(-1, K).contiguous(), w["q"], w["s"])
        return out.reshape(*lead, -1)
    if is_grouped_int4(w):
        mm = w4a8_matmul if takes_w4a8_kernel(w) else w4a8_dot_requant
        return mm(x.reshape(-1, K).contiguous(), w["q"], w["s"]).reshape(*lead, -1)
    if is_quantized(w) or (isinstance(w, dict) and "hi" in w):
        raise NotImplementedError(
            "mix / nibble weight leaves are not ported yet: ROADMAP Queue 1 items 7 and 10")
    if isinstance(w, dict) and "base" in w:
        raise NotImplementedError(
            "LoRA / multi-LoRA weight wrappers are not ported yet: "
            "ROADMAP Queue 1 items 11 and 13")
    raise TypeError(f"matmul_t: unsupported weight {type(w)}")
