"""Linear layers of the port (counterpart of ``openvla_probe_tpu/ops/linear.py``).

``matmul_t(x, w, int8_matmul) = x @ w.T`` with ``w`` in the JAX package's
``[O, K]`` layout, for four kinds of leaf:

* a float tensor: the JAX package leaves this product to XLA outside any
  Pallas kernel, and the port leaves it to ``torch.matmul`` (bf16 products
  with fp32 accumulation, fp32 in full fp32: see the package's numerics
  flags);
* a per-channel int8 leaf ``{"q": int8 [O, K], "s": f32 [O]}``: the route the
  config names (``int8_matmul``, the JAX package's ``OVLA_PALLAS_MATMUL`` gate
  as a field): ``"wi8"``, the weight-only int8 kernel ``wi8_matmul``
  (``csrc/wi8_matmul.cu``; ``_wi8_matmul_2d`` under the kernel gate, the
  ``pallas*`` tiers), or ``"w8a8"``, per-row int8 activations times the int8
  weights in the kernel ``w8a8_matmul`` (``csrc/w8a8_matmul.cu``; the XLA op
  ``_w8a8_dot``, the ``turbo`` tier). A `PrequantActivation` (codes from the
  fused RMSNorm -> int8 kernel) goes straight into ``w8a8_matmul``;
* a nibble leaf ``{"hi": uint8 [O, K/2], "lo": uint8 [O, K/2], "s": f32 [O]}``
  (``quantize_weight_nibble``): at M <= 32 the hi-plane kernel ``nib_hi_dot``
  (``csrc/nib_hi_dot.cu``), else ``w8a8_matmul`` rebuilding the exact int8
  codes ``16·hi + lo + 8`` in its weight loader (the JAX ``_nib_matmul``);
* a grouped-int4 leaf ``{"q": uint8 [G, O, gsz/2], "s": f32 [O, G]}``: on the
  ``"wi8"`` route (the JAX package's kernel gate) the w4a8 kernel
  ``w4a8_matmul`` (``csrc/w4a8_matmul.cu``) where ``O % 128 == 0`` and
  ``gsz % 128 == 0``, else the requant route (``w4a8_dot_requant``: the
  kernel ``w4a8_requant``, the int8 GEMM with int8 codes and per-channel
  scales requantized from the groups in its weight loader), the JAX
  package's rule as it runs on the chip (``_w4a8_pallas_matmul``; its
  interpret mode drops the ``gsz`` condition); on ``"w8a8"`` (the turbo
  tier, no kernel gate) the grouped decode kernel ``w4a8_grouped``
  (``csrc/w4a8_grouped.cu``, the JAX ``_w4a8_dot_grouped``) at M <= 32 and
  the requant route above;
* a mix leaf ``{"q", "s"`` (per-channel int8) ``, "q4", "s4"`` (grouped int4)
  ``}`` (``quantize_weight_mixed``), whatever the route: the int4 copy through
  ``w4a8_grouped`` at M <= 32, the int8 copy through ``w8a8_matmul`` above.

**Packed int4 layout.** Codes are stored two per byte in ``uint8``: byte
``j`` holds code ``2j`` in its low nibble and code ``2j + 1`` in its high
nibble, each in two's complement. Grouped-int4 codes are group-major as in
the JAX package (``[..., G, O, gsz]`` -> ``uint8 [..., G, O, gsz/2]``); the
two nibble planes keep the ``[..., O, K]`` layout (-> ``[..., O, K/2]``). One
16-byte load gives 32 consecutive k of one output channel. The ``uint8`` type
keeps a packed leaf from ever passing for a per-channel int8 one.

A streamed-LoRA wrapper ``{"base": leaf, "A": [r, K], "B": [O, r]}``
(``training.lora.attach_lora``) computes ``matmul_t(x, base) + (x Aᵀ) Bᵀ``
with the adapters cast to x's dtype, so no merged weight ever exists.

**Gradients.** Every kernel wrapper refuses an input that requires grad while
autograd records (`_build.no_grad_guard`). Under grad, `matmul_t` takes the
straight-through (STE) ``torch.autograd.Function`` of the quantized leaf's
route, the JAX package's custom VJPs: the kernel forward, and ``dx = g ·
dequant(W)`` with bf16 operands and fp32 sums, cast to g's dtype; the frozen
codes and scales get no gradient. ``w8a8_matmul_ste`` (``_w8a8_dot``: int8
leaves on "w8a8", nibble leaves at prefill M; and the int4 requant route
called alone, on the requantized codes), ``nib_hi_dot_ste``
(``_nib_hi_dot``) and ``w4a8_matmul_ste`` (``_w4a8_pallas_dot``: grouped
int4 under the kernel gate, either forward, whose backward is `w4a8_dx`: the
CUDA kernel ``csrc/w4a8_dx.cu`` where N and gsz are multiples of 128, the
bf16-dequant product otherwise, Queue 2 row 9).
``wi8_matmul`` has no backward, as the JAX ``_wi8_matmul_2d`` has no VJP.

``quantize_weight``, ``quantize_weight_int4``, ``quantize_weight_mixed``,
``quantize_weight_nibble`` and ``quantize_params`` give codes and scales
bit-identical to the JAX package's. ``random_params_like`` draws quantized
codes and scales directly (the JAX package's benchmark initializer).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

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
NIB_HI_M_MAX = 32         # nibble leaves: rows up to this take the hi plane
INT8_ROUTES = ("wi8", "w8a8")
_WI8_NO_VJP = ("wi8_matmul has no backward, as the JAX _wi8_matmul_2d has no VJP: train an "
               "int8 base on the w8a8 route (int8_matmul='w8a8'), or call it under "
               "torch.no_grad()")


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


def is_mixed_quant(w: Any) -> bool:
    """A dual-precision leaf ``{"q": int8 [..., O, I], "s": f32 [..., O],
    "q4": uint8 [..., G, O, gsz/2], "s4": f32 [..., O, G]}``."""
    return (isinstance(w, dict) and set(w) == {"q", "s", "q4", "s4"} and w["q"].dtype == torch.int8
            and w["q4"].dtype == torch.uint8)


def is_nibble_quant(w: Any) -> bool:
    """A nibble-plane leaf ``{"hi": uint8 [..., O, K/2], "lo": uint8 [..., O, K/2], "s": f32 [..., O]}``."""
    return isinstance(w, dict) and set(w) == {"hi", "lo", "s"} and w["hi"].dtype == torch.uint8


class PrequantActivation(NamedTuple):
    """Activation rows already RMS-normed and quantized by the fused kernel
    (``ops.rmsnorm_quant``): int8 codes ``q8 [..., K]``, fp32 row scales
    ``sx [..., 1]`` and the dtype the unfused path's activation would have.
    `matmul_t` takes it in place of that activation for a per-channel int8
    leaf: the w8a8 product then skips its own quantization (the JAX
    package's ``PrequantActivation``)."""

    q8: torch.Tensor
    sx: torch.Tensor
    dtype: torch.dtype


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


def quantize_weight_mixed(w: torch.Tensor, group_size: int = GROUP_SIZE) -> Dict[str, torch.Tensor]:
    """Dual-precision serving leaf: per-channel int8 and grouped int4, both
    quantized from the same weights: ``{"q", "s"}`` for prefill M, ``{"q4",
    "s4"}`` (packed) for decode M (`matmul_t` picks by row count). An in-dim
    with no group collapses to the single int8 leaf."""
    w8 = quantize_weight(w)
    if not int4_group_size(w.shape[-1], group_size):
        return w8
    w4 = quantize_weight_int4(w, group_size)
    return {"q": w8["q"], "s": w8["s"], "q4": w4["q"], "s4": w4["s"]}


def quantize_weight_nibble(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The per-channel int8 codes of `quantize_weight` as two 4-bit planes:
    hi = floor(q8 / 16), lo = q8 - 16·hi - 8, both in [-8, 7], so that
    q8 = 16·hi + lo + 8 exactly; {"hi", "lo"} packed ``uint8 [..., O, I/2]``,
    "s" the int8 scales."""
    w8 = quantize_weight(w)
    q8 = w8["q"].to(torch.int32)
    hi = torch.div(q8, 16, rounding_mode="floor")
    lo = q8 - 16 * hi - 8
    return {"hi": pack_int4(hi.to(torch.int8)), "lo": pack_int4(lo.to(torch.int8)), "s": w8["s"]}


def nibble_reconstruct_q8(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The exact int8 codes of a nibble leaf, 16·hi + lo + 8, computed in
    int32 (every intermediate in range)."""
    hi = unpack_int4(w["hi"]).to(torch.int32)
    return (16 * hi + unpack_int4(w["lo"]).to(torch.int32) + 8).to(torch.int8)


def quantize_leaf(w: torch.Tensor, bits=8, group_size: int = GROUP_SIZE) -> Dict[str, torch.Tensor]:
    """One weight leaf at a resolved width: "nibble" planes, "mix" copies,
    grouped int4 where bits=4 and the in-dim has a group, else per-channel
    int8."""
    if bits == "nibble":
        return quantize_weight_nibble(w)
    if bits == "mix":
        return quantize_weight_mixed(w, group_size)
    if bits == 4 and int4_group_size(w.shape[-1], group_size):
        return quantize_weight_int4(w, group_size)
    return quantize_weight(w)


def leaf_bits(name: str, bits):
    """The width `quantize_params(..., bits)` gives leaf `name`: bits="nibble"
    and bits="mix" make nibble planes or mix copies of the Llama trunk and
    lm_head (the decode stream) and int8 elsewhere."""
    if bits in ("nibble", "mix"):
        return bits if name in _DEFAULT_QUANT_SUFFIXES else 8
    return bits


def dequantize_weight(w: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """Per-channel int8, nibble, grouped int4 or mix (its int8 copy) -> float
    [..., O, I] (the JAX branches)."""
    if is_nibble_quant(w):
        return (nibble_reconstruct_q8(w).float() * w["s"][..., None]).to(dtype)
    if is_grouped_int4(w):
        codes = unpack_int4(w["q"]).float()                       # [..., G, O, gsz]
        wf = codes * w["s"].movedim(-1, -2)[..., None]
        *lead, G, O, gsz = wf.shape
        return wf.movedim(-3, -2).reshape(*lead, O, G * gsz).to(dtype)
    return (w["q"].float() * w["s"][..., None]).to(dtype)


def quantize_params(params: Any, suffixes: tuple = _DEFAULT_QUANT_SUFFIXES, bits=8,
                    group_size: int = GROUP_SIZE) -> Any:
    """Quantize the weight leaves whose name is in `suffixes` (and that have
    at least two dims): bits=8 per-channel int8, bits=4 grouped int4 (an
    in-dim with no usable group falls back to per-channel int8),
    bits="nibble" nibble planes and bits="mix" dual int8 + int4 copies for
    the Llama trunk and lm_head and int8 for the rest (the towers, which run
    at prefill M only); everything else passes through."""
    if bits not in (4, 8, "mix", "nibble"):
        raise ValueError(f"bits must be 4, 8, 'mix' or 'nibble', got {bits!r}")

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name in suffixes and tree.dim() >= 2:
            return quantize_leaf(tree, leaf_bits(name, bits), group_size)
        return tree

    return walk(params, "")


def random_params_like(shapes: Any, generator: torch.Generator, weight_scale: float = 0.02,
                       device=None) -> Any:
    """Random parameters for a tree of shape-like leaves (anything with
    ``.shape`` and ``.dtype``: meta tensors, ``convert.vlm_param_spec``'s
    leaves), made directly on `device` from `generator` (which must live
    there), one leaf at a time, never a float twin of a quantized weight (the
    JAX package's benchmark initializer, its ranges and operating points):
    int8 codes uniform in [-127, 127]; packed int4 codes uniform in [-8, 7]
    for nibble planes ("hi", "lo") and [-7, 7] for grouped codes; scales "s"
    at ``weight_scale · 4 / 127 · (1 + U)`` (the absmax of ~4k normal draws
    over 127; a bare grouped-int4 leaf's "s" too, as in the JAX package) and
    mix leaves' "s4" at ``weight_scale · 3.2 / 7 · (1 + U)``; other float
    leaves N(0, weight_scale); anything else zeros.
    The bits are not the JAX package's (a torch generator): values for
    throughput runs, finite but arbitrary."""
    s_lo, s4_lo = weight_scale * 4.0 / 127.0, weight_scale * 3.2 / 7.0

    def leaf(name: str, spec) -> torch.Tensor:
        shape, dtype = tuple(spec.shape), spec.dtype
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=generator, device=device,
                                 dtype=torch.int8)
        if dtype == torch.uint8:   # packed int4: two codes a byte
            lo = -8 if name in ("hi", "lo") else -7
            codes = torch.randint(lo, 8, (*shape[:-1], 2 * shape[-1]), generator=generator,
                                  device=device, dtype=torch.int8)
            return pack_int4(codes)
        if dtype.is_floating_point and name in ("s", "s4"):
            u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
            return ((s4_lo if name == "s4" else s_lo) * (1.0 + u)).to(dtype)
        if dtype.is_floating_point:
            x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            return (x * weight_scale).to(dtype)
        return torch.zeros(shape, dtype=dtype, device=device)

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf(name, tree)

    return walk(shapes, "")


def random_params_like_eager_int4(shapes: Any, generator: torch.Generator,
                                  weight_scale: float = 0.02, device=None) -> Any:
    """The JAX package's variant for trees with int4 leaves, which bounds its
    peak at one leaf's codes: `random_params_like` already makes every leaf
    alone (an int4 leaf's int8 codes are dropped once packed), so the two are
    one function here."""
    return random_params_like(shapes, generator, weight_scale, device)


# --- weight-only int8 matmul (Queue 2 row 7) ---------------------------------


def wi8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's function: bf16(q) is exact, so x · qᵀ in fp32 (full
    fp32, no TF32), then · s in fp32, cast to x's dtype."""
    return (torch.matmul(x.float(), q.float().t()) * s.float()).to(x.dtype)


def _check_tensors(kernel: str, device: torch.device, named: Dict[str, Tuple]) -> None:
    for name, (t, shape, dtype) in named.items():
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous on {device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def _check_matmul_inputs(kernel: str, x: torch.Tensor, named: Dict[str, Tuple]) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel}: x must be bf16 or fp32, got {x.dtype}")
    _check_tensors(kernel, x.device, named)


def wi8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16 or fp32) @ int8 q [N, K].T * s [N] -> [M, N] in x's dtype.

    On the card, two routes by x's dtype, counted apart: bf16 takes the
    tensor-core kernel (``wi8_matmul``: wgmma above M = 64, mma.sync at and
    below), fp32 (the tiny configurations) the scalar fp32-FMA kernel
    (``wi8_matmul_scalar``): a bf16 product would round x."""
    _build.no_grad_guard("wi8_matmul", _WI8_NO_VJP, x, s)
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
    args = (x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, N, K)
    if x.dtype == torch.bfloat16:
        kernel = "wi8_matmul"
        err = _build.launcher(kernel)(*args, 1, _build.stream_ptr(x))
    else:
        kernel = "wi8_matmul_scalar"
        err = _build.launcher(kernel)(*args, _build.stream_ptr(x))
    _build.check(err, kernel)
    _build.KERNEL_LAUNCHES[kernel] += 1
    return out


# --- w8a8: per-row int8 activations x per-channel int8 weights -------------------


def _w8a8_operands(x, w) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.dtype]:
    """(activation codes [M, K], row scales [M, 1], weight codes [N, K], out
    dtype) of a w8a8 product: x a float [M, K] or a 2-D `PrequantActivation`,
    w a per-channel int8 or nibble leaf."""
    if isinstance(x, PrequantActivation):
        codes, sx, dtype = x.q8, x.sx, x.dtype
    else:
        (codes, sx), dtype = quantize_rows(x.float()), x.dtype
    q = nibble_reconstruct_q8(w) if is_nibble_quant(w) else w["q"]
    return codes, sx, q, dtype


def w8a8_matmul_plain(x, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``_w8a8_dot`` forward (and the prequant branch of its
    ``matmul_t``, and ``_nib_matmul`` at prefill M): per-row int8 activation
    codes, the exact int32 product with the weight's int8 codes,
    ``(f32(acc) · s_x) · s`` in fp32, cast to the activation dtype."""
    codes, sx, q, dtype = _w8a8_operands(x, w)
    return (int8_dot(codes, q) * sx * w["s"][None, :]).to(dtype)


def w8a8_matmul(x, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [M, K] (bf16 or fp32, or a 2-D `PrequantActivation`) @ the int8 codes
    of w [N, K]ᵀ with int8 activations -> [M, N] in the activation dtype.

    w is a per-channel int8 leaf or a nibble leaf (with a float x only), whose
    exact int8 codes the kernel rebuilds from the two planes as it loads them:
    both give the same output for the same codes. The kernel
    (``csrc/w8a8_matmul.cu``) is bit-equal to `w8a8_matmul_plain`; for a float
    x the same call first writes the activation codes in a pre-pass, a launch
    of its own, counted as ``w8a8_quant_rows``."""
    pre = isinstance(x, PrequantActivation)
    if pre and is_nibble_quant(w):
        raise TypeError("w8a8_matmul: a nibble leaf takes float activations, not a "
                        "PrequantActivation (the fused norm stands down for nibble leaves)")
    xt = x.q8 if pre else x
    _build.no_grad_guard("w8a8_matmul", "use w8a8_matmul_ste (or matmul_t), its STE",
                         x.sx if pre else x, w["s"])
    if xt.device.type == "cpu":
        return w8a8_matmul_plain(x, w)
    if xt.device.type != "cuda":
        raise ValueError(f"w8a8_matmul: unsupported device {xt.device}")
    M, K = xt.shape
    N = w["s"].shape[0]
    nibble = is_nibble_quant(w)
    named = {"hi": (w["hi"], (N, K // 2), torch.uint8), "lo": (w["lo"], (N, K // 2), torch.uint8)} \
        if nibble else {"q": (w["q"], (N, K), torch.int8)}
    named["s"] = (w["s"], (N,), torch.float32)
    if pre:
        codes, sx, dtype = x
        if dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"w8a8_matmul: the activation dtype must be bf16 or fp32, got {dtype}")
        _check_tensors("w8a8_matmul", xt.device, {
            "x.q8": (codes, (M, K), torch.int8), "x.sx": (sx, (M, 1), torch.float32), **named})
    else:
        dtype = x.dtype
        _check_matmul_inputs("w8a8_matmul", x, {"x": (x, (M, K), dtype), **named})
        # written by the kernel's activation pre-pass
        codes = torch.empty((M, K), dtype=torch.int8, device=x.device)
        sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if K % (32 if nibble else 16) or N % 8:
        raise ValueError(f"w8a8_matmul: K={K} must be a multiple of {32 if nibble else 16} "
                         f"and N={N} of 8")
    out = torch.empty((M, N), dtype=dtype, device=xt.device)
    x_kind = 0 if pre else (2 if x.dtype == torch.bfloat16 else 1)
    err = _build.launcher("w8a8_matmul")(
        0 if pre else x.data_ptr(), codes.data_ptr(), sx.data_ptr(),
        (w["hi"] if nibble else w["q"]).data_ptr(), w["lo"].data_ptr() if nibble else 0,
        w["s"].data_ptr(), out.data_ptr(), M, N, K, x_kind, int(dtype == torch.bfloat16),
        _build.stream_ptr(xt))
    _build.check(err, "w8a8_matmul")
    if not pre:
        _build.KERNEL_LAUNCHES["w8a8_quant_rows"] += 1
    _build.KERNEL_LAUNCHES["w8a8_matmul"] += 1
    return out


# --- nibble planes at decode M: the hi plane alone ------------------------------------


def nib_hi_dot_plain(x: torch.Tensor, hi: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_nib_hi_dot``: w ≈ (16·hi + 7.5)·s, so per-row int8
    activation codes x̂, out = ((f32(Σ x̂·hi)·16 + f32(Σ x̂)·7.5) · s_x) · s in
    fp32 (each product and the sum rounded once), cast to x's dtype."""
    codes, sx = quantize_rows(x.float())
    acc = int8_dot(codes, unpack_int4(hi))
    rowsum = codes.to(torch.int32).sum(dim=-1, keepdim=True).float()
    return ((acc * 16.0 + rowsum * 7.5) * sx * s[None, :]).to(x.dtype)


def nib_hi_dot(x: torch.Tensor, hi: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16 or fp32) @ a nibble leaf's hi plane (packed uint8
    [N, K/2], scales s [N]) -> [M, N] in x's dtype: `nib_hi_dot_plain`, bit for
    bit (``csrc/nib_hi_dot.cu``: an activation pre-pass, counted as
    ``nib_hi_quant_rows``, then the int8 product streaming only the hi
    plane)."""
    _build.no_grad_guard("nib_hi_dot", "use nib_hi_dot_ste (or matmul_t), its STE", x, s)
    M, K = x.shape
    N = hi.shape[0]
    if x.device.type == "cpu":
        return nib_hi_dot_plain(x, hi, s)
    if x.device.type != "cuda":
        raise ValueError(f"nib_hi_dot: unsupported device {x.device}")
    _check_matmul_inputs("nib_hi_dot", x, {"x": (x, (M, K), x.dtype),
                                           "hi": (hi, (N, K // 2), torch.uint8),
                                           "s": (s, (N,), torch.float32)})
    if K % 32 or N % 8:
        raise ValueError(f"nib_hi_dot: K={K} must be a multiple of 32 and N={N} of 8")
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)   # the pre-pass's scratch
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    rowsum = torch.empty((M,), dtype=torch.int32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.launcher("nib_hi_dot")(
        x.data_ptr(), hi.data_ptr(), s.data_ptr(), out.data_ptr(), codes.data_ptr(),
        sx.data_ptr(), rowsum.data_ptr(), M, N, K, int(x.dtype == torch.bfloat16),
        _build.stream_ptr(x))
    _build.check(err, "nib_hi_dot")
    _build.KERNEL_LAUNCHES["nib_hi_quant_rows"] += 1
    _build.KERNEL_LAUNCHES["nib_hi_dot"] += 1
    return out


def nib_matmul(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The JAX package's ``_nib_matmul``: the hi plane at M <= 32 (decode),
    the exact int8 codes through w8a8 above (prefill), each with its STE."""
    if x.shape[0] <= NIB_HI_M_MAX:
        return nib_hi_dot_ste(x, w["hi"], w["s"])
    return w8a8_matmul_ste(x, w)


# --- w4a8: grouped int4 weights x int8 activations (Queue 2 row 8) ---------------


REQUANT_GSZ_STEP = 32     # the requant kernel's group sizes: multiples of this


def requant_int4_to_int8(q: torch.Tensor, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped int4 [G, N, gsz/2] packed + [N, G] scales -> per-channel int8
    codes [N, G·gsz] and scales [N] (the JAX package's ``_w4a8_dot_requant``):
    s8 = max_g s · (7/127), codes clip(round(q · s / (s8 + 1e-30)), -127, 127)."""
    G, N, half = q.shape
    s8 = s.amax(dim=-1) * (7.0 / 127.0)
    r = (s / (s8[:, None] + 1e-30)).t()[..., None]                 # [G, N, 1]
    q8 = torch.clamp(torch.round(unpack_int4(q).float() * r), -127, 127).to(torch.int8)
    return q8.movedim(0, 1).reshape(N, G * 2 * half), s8


def w4a8_requant_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The requant route's function (the JAX ``_w4a8_dot_requant`` forward):
    `w8a8_matmul_plain` over `requant_int4_to_int8`'s codes and scales."""
    q8, s8 = requant_int4_to_int8(q, s)
    return w8a8_matmul_plain(x, {"q": q8, "s": s8})


def w4a8_requant(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16 or fp32) @ grouped int4 (packed q [G, N, gsz/2], s
    [N, G]) requantized to per-channel int8 -> [M, N] in x's dtype:
    `w4a8_requant_plain`, bit for bit. The CUDA kernel (``csrc/w8a8_matmul.cu``
    ``ovla_w4a8_requant``) rebuilds the int8 codes and their row scales from
    the int4 groups in the int8 GEMM's weight loader, in registers: no
    ``[N, K]`` int8 tensor exists. One call is two launches, the activation
    pre-pass (counted as ``w4a8_requant_quant_rows``) and the GEMM. It takes
    group sizes that are multiples of 32 (each 32-deep k step of a fragment
    in one group) and N a multiple of 8, and raises on others: no ported
    configuration has one (``int4_group_size`` gives 128, or an in-dim below
    128: 32 and 64 in the tiny configurations)."""
    _build.no_grad_guard("w4a8_requant", "use w4a8_dot_requant (or matmul_t), its STE", x, s)
    M, K = x.shape
    G, N, half = q.shape
    gsz = 2 * half
    if x.device.type == "cpu":
        return w4a8_requant_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"w4a8_requant: unsupported device {x.device}")
    _check_matmul_inputs("w4a8_requant", x, {
        "x": (x, (M, G * gsz), x.dtype), "q": (q, (G, N, half), torch.uint8),
        "s": (s, (N, G), torch.float32)})
    if gsz % REQUANT_GSZ_STEP or N % 8:
        raise ValueError(f"w4a8_requant: the group size {gsz} must be a multiple of "
                         f"{REQUANT_GSZ_STEP} and N={N} of 8")
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)   # the activation pre-pass
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.launcher("w4a8_requant")(
        x.data_ptr(), codes.data_ptr(), sx.data_ptr(), q.data_ptr(), s.data_ptr(),
        out.data_ptr(), M, N, G, gsz, int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "w4a8_requant")
    _build.KERNEL_LAUNCHES["w4a8_requant_quant_rows"] += 1
    _build.KERNEL_LAUNCHES["w4a8_requant"] += 1
    return out


def w4a8_dot_requant(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The requant route (the JAX ``_w4a8_dot_requant``): `w4a8_requant`, no
    resident int8 copy; called alone under grad it carries the w8a8 STE, whose
    backward dequantizes the requantized codes ``q8 · s8``."""
    if _needs_grad(x):
        return _W4A8RequantSTE.apply(x, q, s)
    return w4a8_requant(x, q, s)


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
    _build.no_grad_guard("w4a8_matmul", "use w4a8_matmul_ste (or matmul_t), its STE", x, s)
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
    _build.KERNEL_LAUNCHES["w4a8_quant_rows"] += 1
    _build.KERNEL_LAUNCHES["w4a8_matmul"] += 1
    return out


# --- w4a8 grouped: the decode-M product of grouped int4 off the kernel gate ---------------


GROUPED_CHUNK, GROUPED_CLASSES = 128, 8   # csrc/w4a8_grouped.cu: k a chunk; chunk c folds into class c % 8


def w4a8_grouped_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_w4a8_dot_grouped`` forward, its fp32 sums in the
    kernel's order: per-row int8 activation codes, s_x = max(max|x| / 127,
    1e-8); K split into 128-deep chunks, chunk c in class c % 8; each class
    folds the exact int32 product of every segment of its chunks (a chunk cut
    at group boundaries) into its fp32 sum as ``acc + f32(p) · s[:, g]`` (two
    roundings), in k order; the 8 classes' sums added in class order (the
    kernel's chain across its two CTAs); ``(total · s_x)`` cast to x's dtype.
    x [M, K], packed q [G, N, gsz/2], s [N, G] -> [M, N]. No term depends on
    M or N."""
    M, K = x.shape
    G, N, half = q.shape
    gsz = 2 * half
    codes, sx = quantize_rows(x.float())
    w = unpack_int4(q)
    acc = [torch.zeros((M, N), dtype=torch.float32, device=x.device)
           for _ in range(GROUPED_CLASSES)]
    for c in range(-(-K // GROUPED_CHUNK)):
        k, end = c * GROUPED_CHUNK, min(K, (c + 1) * GROUPED_CHUNK)
        while k < end:
            g = k // gsz
            seg = min(end, (g + 1) * gsz)
            p = int8_dot(codes[:, k:seg], w[g][:, k - g * gsz:seg - g * gsz])
            acc[c % GROUPED_CLASSES] = acc[c % GROUPED_CLASSES] + p * s[:, g]
            k = seg
    total = acc[0]
    for part in acc[1:]:
        total = total + part
    return (total * sx).to(x.dtype)


def w4a8_grouped(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] (bf16 or fp32) @ grouped int4 (packed q [G, N, gsz/2], s
    [N, G]) with int8 activations, each group's int32 product scaled by its
    own s -> [M, N] in x's dtype: `w4a8_grouped_plain`, bit for bit. The CUDA
    kernel (``csrc/w4a8_grouped.cu``): the activation pre-pass (counted as
    ``w4a8_grouped_quant_rows``), then a persistent grid of two-CTA clusters
    over 32 x 32 output tiles, K split by fold class across the pair, each
    segment's int32 product folded into its class's fp32 sum and the classes
    added in order across the pair. It takes group sizes that are multiples
    of 32 and N a multiple of 8 (lm_head's 32064 included), any M, and raises
    on others."""
    _build.no_grad_guard("w4a8_grouped", "use w4a8_grouped_ste (or matmul_t), its STE", x, s)
    M, K = x.shape
    G, N, half = q.shape
    gsz = 2 * half
    if x.device.type == "cpu":
        return w4a8_grouped_plain(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"w4a8_grouped: unsupported device {x.device}")
    _check_matmul_inputs("w4a8_grouped", x, {
        "x": (x, (M, G * gsz), x.dtype), "q": (q, (G, N, half), torch.uint8),
        "s": (s, (N, G), torch.float32)})
    if gsz % REQUANT_GSZ_STEP or N % 8:
        raise ValueError(f"w4a8_grouped: the group size {gsz} must be a multiple of "
                         f"{REQUANT_GSZ_STEP} and N={N} of 8")
    codes = torch.empty((M, K), dtype=torch.int8, device=x.device)   # the activation pre-pass
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _build.launcher("w4a8_grouped")(
        x.data_ptr(), codes.data_ptr(), sx.data_ptr(), q.data_ptr(), s.data_ptr(),
        out.data_ptr(), M, N, G, gsz, int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(err, "w4a8_grouped")
    _build.KERNEL_LAUNCHES["w4a8_grouped_quant_rows"] += 1
    _build.KERNEL_LAUNCHES["w4a8_grouped"] += 1
    return out


def takes_w4a8_kernel(w: Dict[str, torch.Tensor]) -> bool:
    """The grouped-int4 dispatch rule: the kernel where N and gsz are
    multiples of 128, the requant route otherwise."""
    _, N, half = w["q"].shape[-3:]
    return N % W4A8_TILE == 0 and (2 * half) % W4A8_TILE == 0


# --- the STE backward of grouped int4: dx = g · dequant(W) (Queue 2 row 9) ---------


def w4a8_dx_plain(g: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's function: per group gi, the scaled gradient
    ``bf16(g · s[:, gi])`` (rounded to bf16 even where g is fp32) times the
    group's codes (exact in bf16), summed over N in fp32; cast to g's dtype.
    g [M, N], packed q [G, N, gsz/2], s [N, G] -> dx [M, G·gsz]."""
    codes = unpack_int4(q).float()                                 # [G, N, gsz]
    gf = g.float()
    dx = [torch.matmul((gf * s[:, gi]).to(torch.bfloat16).float(), codes[gi])
          for gi in range(q.shape[0])]
    return torch.cat(dx, dim=1).to(g.dtype)


def _within_one_bf16_step(got: torch.Tensor, want: torch.Tensor, floor: float,
                          max_share: float, kernel: str) -> dict:
    """Every element of `got` within one bf16 step of `want` (the step at the
    larger magnitude of the two, and at no less than `floor` of the largest
    |want|: a sum that cancels keeps the fp32 error of its terms), at most
    max(16, max_share of them) apart at all (a sum at a rounding tie). fp32:
    within 1e-5 of the largest |want| everywhere. Raises AssertionError;
    returns the distances."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    scale = w.abs().max().item()
    stats = dict(max_abs_err=d.max().item(), n_apart=int((d > 0).sum()), n=d.numel(),
                 max_abs_want=scale)
    if got.dtype == torch.float32:
        assert stats["max_abs_err"] <= 1e-5 * scale, f"{kernel}: fp32 sums too far apart {stats}"
        return stats
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=scale * floor)
    _, e = torch.frexp(mag)
    step = torch.ldexp(torch.ones_like(w), e - 8)
    stats["max_steps"] = (d / step).max().item()
    assert bool((d <= step).all()), f"{kernel}: an element more than one bf16 step off {stats}"
    limit = max(16, int(max_share * d.numel()))
    assert stats["n_apart"] <= limit, f"{kernel}: {stats['n_apart']} elements apart > {limit}"
    return stats


def compare_w4a8_dx(got: torch.Tensor, want: torch.Tensor, max_share: float = 2e-2) -> dict:
    """Hold a `w4a8_dx` output `got` to `w4a8_dx_plain`'s `want`: the same
    bf16 products, summed in fp32 in another order. fp32: within 1e-5 of the
    largest |want| everywhere (the sums' rounding, about 2e-6 of it at
    N = 11008). bf16: every element within one bf16 step of want, the step
    floored at 1/1024 of the largest |want|, at most max(16, max_share of
    them) apart (`_within_one_bf16_step`). Raises AssertionError; returns the
    distances."""
    return _within_one_bf16_step(got, want, 1 / 1024, max_share, "w4a8_dx")


def compare_wi8(got: torch.Tensor, want: torch.Tensor, max_share: float = 2e-2) -> dict:
    """Hold a `wi8_matmul` output `got` to `wi8_matmul_plain`'s `want`: the
    same exact products (an int8 code is exact in bf16), summed in fp32 in
    another order, times the same scale, one rounding to x's type. fp32 (the
    scalar route): within 1e-4 + 1e-4 |want|. bf16: every element within one
    bf16 step of want, the step floored at 1/1024 of the largest |want|, at
    most max(16, max_share of them) apart (`_within_one_bf16_step`): a
    product that rounds x, or sums it in TF32, moves most outputs by more.
    Raises AssertionError; returns the distances."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        return dict(max_abs_err=(got - want).abs().max().item())
    return _within_one_bf16_step(got, want, 1 / 1024, max_share, "wi8_matmul")


def _ste_dot(g: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """g [M, N] @ a bf16 dequantized weight wd [N, K] with bf16 operands and
    fp32 sums, cast to g's dtype (the JAX STE backwards' dot; outside any
    Pallas kernel there, a library product here): a bf16 g takes the bf16
    product (fp32 accumulation, one rounding); an fp32 g is rounded to bf16
    and multiplied in fp32, where bf16 products are exact."""
    if g.dtype == torch.bfloat16:
        return torch.matmul(g, wd)
    return torch.matmul(g.to(torch.bfloat16).float(), wd.float()).to(g.dtype)


def w4a8_dx_xla(g: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA form of the STE dx (``_w4a8_dx_xla``): the
    grouped weight dequantized to bf16, then one product."""
    return _ste_dot(g, dequantize_weight({"q": q, "s": s}, torch.bfloat16))


def w4a8_dx(g: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """dx [M, G·gsz] = g [M, N] (bf16 or fp32) · dequant(grouped int4 W) in g's
    dtype: the function of `w4a8_dx_plain`. Where N and gsz are multiples of
    128 (the JAX chip rule, ``_w4a8_dx_pallas``) the CUDA kernel
    (``csrc/w4a8_dx.cu``), else the bf16-dequant product `w4a8_dx_xla`. A
    launch the kernel refuses (unaligned g or q) raises."""
    G, N, half = q.shape
    gsz = 2 * half
    _build.no_grad_guard("w4a8_dx", "it is the backward of w4a8_matmul_ste and has no "
                         "backward of its own", g, s)
    if N % W4A8_TILE or gsz % W4A8_TILE:
        return w4a8_dx_xla(g, q, s)
    if g.device.type == "cpu":
        return w4a8_dx_plain(g, q, s)
    if g.device.type != "cuda":
        raise ValueError(f"w4a8_dx: unsupported device {g.device}")
    M = g.shape[0]
    _check_matmul_inputs("w4a8_dx", g, {"g": (g, (M, N), g.dtype),
                                        "q": (q, (G, N, half), torch.uint8),
                                        "s": (s, (N, G), torch.float32)})
    dx = torch.empty((M, G * gsz), dtype=g.dtype, device=g.device)
    s_t = s.t().contiguous()   # [G, N]: the kernel copies one group's 64 scales per stage
    err = _build.launcher("w4a8_dx")(
        g.data_ptr(), q.data_ptr(), s_t.data_ptr(), dx.data_ptr(), M, N, G, gsz,
        int(g.dtype == torch.bfloat16), _build.stream_ptr(g))
    _build.check(err, "w4a8_dx")
    _build.KERNEL_LAUNCHES["w4a8_dx"] += 1
    return dx


# --- straight-through estimators over the kernel forwards ----------------------------


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _W8A8STE(torch.autograd.Function):
    """``w8a8_matmul`` forward; dx through the bf16 dequantized weight
    (``q8 · s``, a nibble leaf's codes rebuilt exactly), the JAX
    ``_w8a8_dot_bwd``. The weight is frozen: no gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.w = w
        return w8a8_matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        w = ctx.w
        q = nibble_reconstruct_q8(w) if is_nibble_quant(w) else w["q"]
        return _int8_ste_dx(g, q, w["s"]), None


def _int8_ste_dx(g: torch.Tensor, q8: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The w8a8 STE's dx: g times the bf16 dequantized weight ``q8 · s``."""
    return _ste_dot(g, q8.to(torch.bfloat16) * s.to(torch.bfloat16)[:, None])


class _W4A8RequantSTE(torch.autograd.Function):
    """``w4a8_requant`` forward; dx through the bf16 dequantized requantized
    weight ``q8 · s8``, as `_W8A8STE` on `requant_int4_to_int8`'s leaf (the
    JAX ``_w4a8_dot_requant`` carries ``_w8a8_dot``'s VJP)."""

    @staticmethod
    def forward(ctx, x, q, s):
        ctx.q, ctx.s = q, s
        return w4a8_requant(x, q, s)

    @staticmethod
    def backward(ctx, g):
        return _int8_ste_dx(g, *requant_int4_to_int8(ctx.q, ctx.s)), None, None


class _NibHiSTE(torch.autograd.Function):
    """``nib_hi_dot`` forward; dx through the hi-plane weight
    ``(16·hi + 7.5)·s`` in bf16, the JAX ``_nib_hi_dot_bwd``."""

    @staticmethod
    def forward(ctx, x, hi, s):
        ctx.hi, ctx.s = hi, s
        return nib_hi_dot(x, hi, s)

    @staticmethod
    def backward(ctx, g):
        wd = (unpack_int4(ctx.hi).to(torch.bfloat16) * 16 + 7.5) * ctx.s.to(torch.bfloat16)[:, None]
        return _ste_dot(g, wd), None, None


def _w4a8_forward(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Grouped int4 under the kernel gate: `w4a8_matmul` where N and gsz are
    multiples of 128, the requant route otherwise."""
    return w4a8_matmul(x, q, s) if takes_w4a8_kernel({"q": q}) else w4a8_dot_requant(x, q, s)


class _W4A8STE(torch.autograd.Function):
    """Grouped int4 under the kernel gate (the JAX ``_w4a8_pallas_dot``):
    `_w4a8_forward`; dx = `w4a8_dx` on either route (``_w4a8_ste_bwd``)."""

    @staticmethod
    def forward(ctx, x, q, s):
        ctx.q, ctx.s = q, s
        return _w4a8_forward(x, q, s)

    @staticmethod
    def backward(ctx, g):
        return w4a8_dx(g, ctx.q, ctx.s), None, None


class _W4A8GroupedSTE(torch.autograd.Function):
    """Grouped int4 off the kernel gate at decode M (the JAX
    ``_w4a8_dot_grouped``): `w4a8_grouped`; dx = `w4a8_dx` (``_w4a8_ste_bwd``)."""

    @staticmethod
    def forward(ctx, x, q, s):
        ctx.q, ctx.s = q, s
        return w4a8_grouped(x, q, s)

    @staticmethod
    def backward(ctx, g):
        return w4a8_dx(g, ctx.q, ctx.s), None, None


def w8a8_matmul_ste(x, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """`w8a8_matmul`, differentiable in x by the STE where autograd records."""
    if not isinstance(x, PrequantActivation) and _needs_grad(x):
        return _W8A8STE.apply(x, w)
    return w8a8_matmul(x, w)


def nib_hi_dot_ste(x: torch.Tensor, hi: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """`nib_hi_dot`, differentiable in x by the STE where autograd records."""
    if _needs_grad(x):
        return _NibHiSTE.apply(x, hi, s)
    return nib_hi_dot(x, hi, s)


def w4a8_matmul_ste(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """`_w4a8_forward`, differentiable in x by the STE (`w4a8_dx`) where
    autograd records."""
    if _needs_grad(x):
        return _W4A8STE.apply(x, q, s)
    return _w4a8_forward(x, q, s)


def w4a8_grouped_ste(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """`w4a8_grouped`, differentiable in x by the STE (`w4a8_dx`) where
    autograd records."""
    if _needs_grad(x):
        return _W4A8GroupedSTE.apply(x, q, s)
    return w4a8_grouped(x, q, s)


def int8_copy(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The per-channel int8 leaf of an int8 or mix leaf."""
    return {"q": w["q"], "s": w["s"]}


def is_lora_wrapped(w: Any) -> bool:
    """A streamed-LoRA wrapper ``{"base", "A", "B"}`` (``training.lora``)."""
    return isinstance(w, dict) and set(w) == {"base", "A", "B"}


def matmul_t(x, w: Any, int8_matmul: str = "wi8") -> torch.Tensor:
    """x [..., K] @ w[O, K].T -> [..., O] for a float weight tensor, a
    per-channel int8 leaf (on the route `int8_matmul` names: "wi8" or
    "w8a8"), a nibble leaf, a grouped-int4 leaf (by the route too), a mix
    leaf or a streamed-LoRA wrapper over any of them; x may be a
    `PrequantActivation` for a leaf with an int8 copy. Quantized leaves are
    differentiable in x through their STE."""
    if isinstance(x, PrequantActivation):
        if not (is_int8_per_channel(w) or is_mixed_quant(w)):
            raise TypeError("a PrequantActivation takes a per-channel int8 leaf or a mix leaf's "
                            "int8 copy; gate the fused RMSNorm -> int8 kernel on every consumer")
        lead, K = x.q8.shape[:-1], x.q8.shape[-1]
        x2 = PrequantActivation(x.q8.reshape(-1, K), x.sx.reshape(-1, 1), x.dtype)
        return w8a8_matmul(x2, int8_copy(w)).reshape(*lead, -1)
    if isinstance(w, torch.Tensor):
        return torch.matmul(x, w.t())
    if is_lora_wrapped(w):
        # the low-rank side path: two thin products, never a merged weight.
        # Its order is part of the train step's launch count: with the base
        # product issued last, the remat recompute of a layer stops before
        # down_proj's base kernel (its STE saves no activation)
        delta = torch.matmul(torch.matmul(x, w["A"].to(x.dtype).t()), w["B"].to(x.dtype).t())
        return matmul_t(x, w["base"], int8_matmul) + delta
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    if is_int8_per_channel(w):
        if int8_matmul not in INT8_ROUTES:
            raise ValueError(f"int8_matmul must be one of {INT8_ROUTES}, got {int8_matmul!r}")
        out = wi8_matmul(x2, w["q"], w["s"]) if int8_matmul == "wi8" else w8a8_matmul_ste(x2, w)
        return out.reshape(*lead, -1)
    if is_nibble_quant(w):
        return nib_matmul(x2, w).reshape(*lead, -1)
    decode_m = x2.shape[0] <= NIB_HI_M_MAX
    if is_mixed_quant(w):
        # the row count picks the copy, on every route (so the verify trunk and the
        # decode steps of one call read the same grid at the same M)
        out = (w4a8_grouped_ste(x2, w["q4"], w["s4"]) if decode_m
               else w8a8_matmul_ste(x2, int8_copy(w)))
        return out.reshape(*lead, -1)
    if is_grouped_int4(w):
        if int8_matmul == "wi8":
            out = w4a8_matmul_ste(x2, w["q"], w["s"])
        elif int8_matmul == "w8a8":
            out = (w4a8_grouped_ste(x2, w["q"], w["s"]) if decode_m
                   else w4a8_dot_requant(x2, w["q"], w["s"]))
        else:
            raise ValueError(f"int8_matmul must be one of {INT8_ROUTES}, got {int8_matmul!r}")
        return out.reshape(*lead, -1)
    if isinstance(w, dict) and "base" in w:
        raise NotImplementedError(
            "multi-LoRA weight wrappers are not ported yet: ROADMAP Queue 1 item 11")
    raise TypeError(f"matmul_t: unsupported weight {type(w)}")
