"""Linear layers of the port (counterpart of ``openvla_probe_tpu/ops/linear.py``).

``matmul_t(x, w) = x @ w.T`` with ``w`` in the JAX package's ``[O, K]``
layout, for two kinds of leaf:

* a float tensor: the JAX package leaves this product to XLA outside any
  Pallas kernel, and the port leaves it to ``torch.matmul`` (bf16 products
  with fp32 accumulation, fp32 in full fp32: see the package's numerics
  flags);
* a per-channel int8 leaf ``{"q": int8 [O, K], "s": f32 [O]}``: the
  weight-only int8 kernel ``wi8_matmul`` (``csrc/wi8_matmul.cu``), which is
  the JAX dispatch under its kernel gate (``_wi8_matmul_2d``).

Grouped-int4, mix, nibble and LoRA leaves are not ported and raise.
``quantize_weight`` / ``quantize_params`` give codes and scales bit-identical
to the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from . import _build

_DEFAULT_QUANT_SUFFIXES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    "lm_head",
)
VIT_QUANT_SUFFIXES = ("qkv_w", "proj_w", "fc1_w", "fc2_w")
TURBO_QUANT_SUFFIXES = _DEFAULT_QUANT_SUFFIXES + VIT_QUANT_SUFFIXES


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def is_int8_per_channel(w: Any) -> bool:
    """A ``{"q": int8 [..., O, I], "s": f32 [..., O]}`` leaf (not the grouped
    int4 codes form, whose scales carry a group axis, nor a mix leaf)."""
    return (is_quantized(w) and set(w) == {"q", "s"} and w["q"].dtype == torch.int8
            and tuple(w["s"].shape) == tuple(w["q"].shape[:-1]))


def index_layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer `i` of a layer-stacked parameter tree (quantized leaves are
    {q, s} dicts whose tensors all carry the layer axis)."""
    return {k: index_layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 as an IEEE division, on every device. (PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, which can round differently
    from the JAX package's division.)"""
    return x / x.new_full((), 127.0)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of [..., O, I]."""
    wf = w.float()
    s = torch.clamp(div127(wf.abs().amax(dim=-1)), min=1e-8)
    q = torch.clamp(torch.round(wf / s[..., None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_weight(w: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """Per-channel int8 -> float [..., O, I] (the JAX int8 branch)."""
    return (w["q"].float() * w["s"][..., None]).to(dtype)


def quantize_params(params: Any, suffixes: tuple = _DEFAULT_QUANT_SUFFIXES, bits: int = 8) -> Any:
    """Quantize the weight leaves whose name is in `suffixes` (and that have
    at least two dims) to per-channel int8; everything else passes through."""
    if bits != 8:
        raise NotImplementedError(
            f"quantize_params(bits={bits!r}): only per-channel int8 is ported; grouped "
            "int4, mix and nibble are ROADMAP Queue 1 items 7 and 10")

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in suffixes and tree.dim() >= 2:
            return quantize_weight(tree)
        return tree

    return walk(params, "")


# --- weight-only int8 matmul (Queue 2 row 7) ---------------------------------


def wi8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's function: bf16(q) is exact, so x · qᵀ in fp32 (full
    fp32, no TF32), then · s in fp32, cast to x's dtype."""
    return (torch.matmul(x.float(), q.float().t()) * s.float()).to(x.dtype)


def wi8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16 or fp32) @ int8 q [N, K].T * s [N] -> [M, N] in x's dtype."""
    M, K = x.shape
    N = q.shape[0]
    if x.device.type == "cpu":
        return wi8_matmul_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"wi8_matmul: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"wi8_matmul: x must be bf16 or fp32, got {x.dtype}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"wi8_matmul: q must be int8 and s fp32, got {q.dtype}, {s.dtype}")
    if tuple(q.shape) != (N, K) or tuple(s.shape) != (N,):
        raise ValueError(f"wi8_matmul: x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)}")
    if K % 16:
        raise ValueError(f"wi8_matmul: K={K} must be a multiple of 16")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"wi8_matmul: {name} must be contiguous on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"wi8_matmul: {name} must be 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.launcher("wi8_matmul")(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "wi8_matmul")
    _build.KERNEL_LAUNCHES["wi8_matmul"] += 1
    return out


def matmul_t(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [..., K] @ w[O, K].T -> [..., O] for a float weight tensor or a
    per-channel int8 leaf."""
    if isinstance(w, torch.Tensor):
        return torch.matmul(x, w.t())
    if is_int8_per_channel(w):
        lead, K = x.shape[:-1], x.shape[-1]
        out = wi8_matmul(x.reshape(-1, K).contiguous(), w["q"], w["s"])
        return out.reshape(*lead, -1)
    if is_quantized(w) or (isinstance(w, dict) and "hi" in w):
        raise NotImplementedError(
            "grouped-int4 / mix / nibble weight leaves are not ported yet: "
            "ROADMAP Queue 1 items 7 and 10")
    if isinstance(w, dict) and "base" in w:
        raise NotImplementedError(
            "LoRA / multi-LoRA weight wrappers are not ported yet: "
            "ROADMAP Queue 1 items 11 and 13")
    raise TypeError(f"matmul_t: unsupported weight {type(w)}")
