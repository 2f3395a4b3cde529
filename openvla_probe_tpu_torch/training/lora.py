"""LoRA fine-tuning over the port's parameter trees (counterpart of
``openvla_probe_tpu/training/lora.py``).

The reference's PEFT path (``LoraConfig(r, alpha=min(r, 16),
target_modules="all-linear", init_lora_weights="gaussian")``): adapters on
every linear weight (Llama projections, ViT qkv/proj/mlp, projector fcs),

    W_eff = W + (alpha / r) · B A,     A ~ N(0, 1) / r,  B = 0.

* **streamed** (`attach_lora`): target leaves become ``{"base": W, "A", "B"}``
  wrappers that ``ops.linear.matmul_t`` computes as ``W(x) + (x Aᵀ) Bᵀ`` per
  use; no merged weight exists, and the base may be a quantized leaf (QLoRA:
  per-channel int8 or grouped int4, through the kernels' STE backwards).
* **merged** (`merge_lora`): ``W + scale · B A`` materialized; a quantized
  base is dequantized, merged in fp32 and quantized again in its own form.

Adapters are fp32 masters (a bf16 adapter swallows small Adam updates) cast
to the activation dtype at use; the alpha / r scale is folded into the
wrapped B, so its gradient reaches the unscaled factor. Nibble-plane bases
are a serving form and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ..ops.linear import (dequantize_weight, is_grouped_int4, is_nibble_quant, is_quantized,
                          quantize_weight, quantize_weight_int4)
from ..parallel import tensor_parallel as tp

# weight-leaf names that count as "linear" (the all-linear target)
_LINEAR_SUFFIXES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj",
    "qkv_w", "proj_w", "fc1_w", "fc2_w", "w",
    # the Phi trunk (models/phi.py layout)
    "q_w", "k_w", "v_w", "dense_w",
)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    r: int = 32
    alpha: Optional[int] = None       # default min(r, 16), the reference's rule
    target_suffixes: Tuple[str, ...] = _LINEAR_SUFFIXES
    include_lm_head: bool = False
    include_embeddings: bool = False

    @property
    def scaling(self) -> float:
        a = self.alpha if self.alpha is not None else min(self.r, 16)
        return a / self.r


def _is_target(path: str, shape, cfg: LoRAConfig) -> bool:
    if len(shape) < 2:
        return False
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "embed_tokens":
        return cfg.include_embeddings
    if leaf in ("lm_head", "lm_head_w"):
        return cfg.include_lm_head
    if leaf == "weight" and "patch_embed" in path:
        return False  # the patch-embed convolution is not a PEFT "linear"
    return leaf in cfg.target_suffixes


def _weight_shape(leaf) -> Tuple[int, ...]:
    """The logical [..., O, I] shape of a weight leaf (grouped int4 codes
    [..., G, O, gsz/2] packed count as [..., O, G·gsz])."""
    if is_grouped_int4(leaf):
        *batch, G, O, half = leaf["q"].shape
        return (*batch, O, G * 2 * half)
    if is_quantized(leaf):
        return tuple(leaf["q"].shape)
    return tuple(leaf.shape)


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or is_quantized(x) or is_nibble_quant(x)


def init_lora_params(params: Any, cfg: LoRAConfig, generator: torch.Generator) -> Any:
    """A tree of ``{"A": fp32 [..., r, I], "B": fp32 zeros [..., O, r]}`` at the
    target leaves and None elsewhere (the params' structure, quantized leaves
    as single weights), made on each weight's device from `generator` (which
    must live there)."""

    def walk(tree, path):
        if is_nibble_quant(tree):
            raise NotImplementedError(
                "QLoRA over a nibble-plane base is unsupported (a serving form): load the "
                "base with bits=8 (the same resident bytes) or bits=4")
        if not _is_leaf(tree):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in tree.items()}
        shape = _weight_shape(tree)
        if not _is_target(path, shape, cfg):
            return None
        *batch, o, i = shape
        dev = (tree["q"] if isinstance(tree, dict) else tree).device
        A = torch.randn((*batch, cfg.r, i), generator=generator, device=dev,
                        dtype=torch.float32) / cfg.r
        return {"A": A, "B": torch.zeros((*batch, o, cfg.r), dtype=torch.float32, device=dev)}

    return walk(params, "")


def _is_ab(x) -> bool:
    return isinstance(x, dict) and set(x) == {"A", "B"}


def _zip_lora(fn: Callable, lora: Any, params: Any) -> Any:
    """fn(adapter or None, base leaf) at each position of the lora tree (whose
    {"A", "B"} / None nodes are its leaves; a quantized base arrives whole)."""
    if lora is None or _is_ab(lora):
        return fn(lora, params)
    return {k: _zip_lora(fn, lora[k], params[k]) for k in params}


def _delta(lw, scale: float) -> torch.Tensor:
    """scale · B A in fp32, batched over stack dims."""
    return scale * torch.matmul(lw["B"].float(), lw["A"].float())


def attach_lora(params: Any, lora: Any, cfg: LoRAConfig) -> Any:
    """Zero-copy streamed LoRA: wrap the target leaves as ``{"base", "A",
    "B"}`` with the scale folded into B; `matmul_t` computes base(x) +
    (x Aᵀ)(Bᵀ) per use. Layer-stacked wrappers slice with ``index_layer``.
    Over a rank's local trees (``parallel.place_params``) a wrapper whose
    base or factors are placed is one placed leaf
    (``parallel.tensor_parallel.lora_wrapper``)."""
    scale = cfg.scaling
    return _zip_lora(lambda lw, w: w if lw is None else tp.lora_wrapper(
        w, lw["A"], tp.map_local(lambda b: b * scale, lw["B"])), lora, params)


def merge_lora(params: Any, lora: Any, cfg: LoRAConfig) -> Any:
    """W + scale · B A at the adapted leaves. A quantized base is
    dequantized, merged in fp32 and quantized again in its own form
    (per-channel int8, or grouped int4 at its group size); a float base is
    merged in fp32 and cast back."""
    scale = cfg.scaling

    def merge(lw, w):
        if lw is None:
            return w
        delta = _delta(lw, scale)
        if is_quantized(w):
            merged = dequantize_weight(w, torch.float32) + delta
            if is_grouped_int4(w):
                return quantize_weight_int4(merged, group_size=2 * w["q"].shape[-1])
            return quantize_weight(merged)
        return (w.float() + delta).to(w.dtype)

    return _zip_lora(merge, lora, params)


def merge_and_unload(params: Any, lora: Any, cfg: LoRAConfig) -> Any:
    """A plain (serving) parameter tree with the adapters folded in."""
    return merge_lora(params, lora, cfg)


def merge_and_unload_host(params: Any, lora: Any, cfg: LoRAConfig) -> Any:
    """The merged export on the host, leaf by leaf: each adapted leaf is
    brought to the CPU, merged in fp32 and cast back or quantized again;
    unadapted leaves are copied to the CPU. Peak host memory is one merged
    tree and one fp32 leaf. Grouped-int4 bases export as per-channel int8 (a
    finer form of the merged weight: the int4 serving tree is made again at
    load time with bits=4)."""
    scale = cfg.scaling
    cpu = lambda t: t.detach().cpu()

    def merge(lw, w):
        if lw is None:
            return {k: cpu(v) for k, v in w.items()} if isinstance(w, dict) else cpu(w)
        delta = _delta({k: cpu(v) for k, v in lw.items()}, scale)
        if is_quantized(w):
            return quantize_weight(dequantize_weight({k: cpu(v) for k, v in w.items()},
                                                     torch.float32) + delta)
        return (cpu(w).float() + delta).to(w.dtype)

    return _zip_lora(merge, lora, params)


def make_lora_loss_with_base(base_loss_fn: Callable, cfg: LoRAConfig,
                             stream: bool = True) -> Callable:
    """``loss(lora_params, base_params, model_cfg, batch)``: `base_loss_fn`
    over the adapted tree (streamed wrappers, or the merged tree with
    ``stream=False``); only the adapters are trained."""

    def loss(lora_params, base_params, model_cfg, batch):
        adapted = (attach_lora if stream else merge_lora)(base_params, lora_params, cfg)
        return base_loss_fn(adapted, model_cfg, batch)

    return loss


def make_lora_loss_fn(base_loss_fn: Callable, base_params: Any, cfg: LoRAConfig,
                      stream: bool = False) -> Callable:
    """``loss(lora_params, model_cfg, batch)`` over a fixed frozen base."""
    with_base = make_lora_loss_with_base(base_loss_fn, cfg, stream=stream)

    def loss(lora_params, model_cfg, batch):
        return with_base(lora_params, base_params, model_cfg, batch)

    return loss
