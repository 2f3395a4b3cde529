"""The bridge for weights and configs between the JAX package and the port.

* `vlm_param_spec(cfg, quant_suffixes, bits)` is the port's parameter layout:
  the JAX package's pytree layout (scan-stacked ``[L, ...]`` layer leaves,
  ``[O, K]`` weights), each leaf with its shape, dtype and initial
  distribution; the weights named in `quant_suffixes` are quantized leaves as
  the JAX package's ``quantize_params(..., bits)`` makes them: bits=8
  per-channel int8 ``{"q": int8 [..., O, K], "s": f32 [..., O]}``; bits=4
  grouped int4 ``{"q": uint8 [..., G, O, gsz/2], "s": f32 [..., O, G]}`` in
  the port's packed layout (``ops/linear.py``), int8 where K has no group;
  bits="nibble" the two packed planes ``{"hi", "lo": uint8 [..., O, K/2],
  "s": f32 [..., O]}`` for the Llama trunk and lm_head, int8 elsewhere;
  bits="mix" both copies ``{"q", "s", "q4", "s4"}`` (int8 and packed grouped
  int4) for the trunk and lm_head, int8 elsewhere and where K has no group.
* `params_from_jax(tree, cfg, quant_suffixes=..., bits=...)` takes the JAX
  package's parameter pytree as numpy arrays (int4 codes, grouped, mix
  copies or nibble planes, as its s4 arrays or its ``emit_codes=True`` int8
  codes, packed here) and returns the port's parameters, raising on any leaf it does not
  consume and on any leaf it is missing.
* `init_params(cfg, generator, device, quant_suffixes=..., bits=...)` makes
  random weights of the same distributions as the JAX package's init
  functions, directly on the device; a quantized weight is made in its float
  dtype one ``[O, K]`` slice at a time and quantized with the port's
  `quantize_leaf`, so the float stack never exists whole.
* `config_from_jax(cfg)` reads a JAX-package config object (its dataclass
  fields, duck-typed) into the port's config class of the same name; a
  serving config's tier sets the kernel routes (`vla.turbo_routes`) that the
  JAX package reads from its environment.
* `lora_from_jax(tree)` and `opt_state_from_jax(state)` bring the JAX
  package's LoRA adapters (its ``{"A", "B"}`` / None tree) and its optax AdamW
  state (``ScaleByAdamState`` mu / nu / count) across as numpy, so that a
  training step on both sides starts from the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models import llama, phi, vit, vla, vlm
from .ops.linear import int4_group_size, leaf_bits, pack_int4, quantize_leaf
from .training.train_state import OptState


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str             # normal | zeros | ones | const | uniform | scale (int8 scales)
    arg: float = 0.0      # normal: std; const: value; uniform: bound


# --- parameter layout ----------------------------------------------------------------

def vit_param_spec(cfg: vit.ViTConfig) -> Dict[str, Any]:
    D, F, L, P, dt = cfg.hidden_size, cfg.mlp_dim, cfg.num_layers, cfg.patch_size, cfg.dtype

    def nrm(*shape):
        return Leaf(shape, dt, "normal", 0.02)

    n_pos = cfg.num_patches + (0 if (cfg.no_embed_class or not cfg.use_cls_token) else 1)
    blocks = {
        "norm1_scale": Leaf((L, D), dt, "ones"),
        "norm1_bias": Leaf((L, D), dt, "zeros"),
        "qkv_w": nrm(L, 3 * D, D),
        "qkv_b": Leaf((L, 3 * D), dt, "zeros"),
        "proj_w": nrm(L, D, D),
        "proj_b": Leaf((L, D), dt, "zeros"),
        "norm2_scale": Leaf((L, D), dt, "ones"),
        "norm2_bias": Leaf((L, D), dt, "zeros"),
        "fc1_w": nrm(L, F, D),
        "fc1_b": Leaf((L, F), dt, "zeros"),
        "fc2_w": nrm(L, D, F),
        "fc2_b": Leaf((L, D), dt, "zeros"),
    }
    if cfg.use_layerscale:
        blocks["ls1"] = Leaf((L, D), dt, "const", 1e-5)
        blocks["ls2"] = Leaf((L, D), dt, "const", 1e-5)
    spec: Dict[str, Any] = {
        "patch_embed": {"weight": nrm(D, 3 * P * P)},
        "pos_embed": nrm(1, n_pos, D),
        "blocks": blocks,
    }
    if cfg.patch_bias:
        spec["patch_embed"]["bias"] = Leaf((D,), dt, "zeros")
    if cfg.use_cls_token:
        spec["cls_token"] = nrm(1, 1, D)
    if cfg.num_register_tokens:
        spec["reg_token"] = nrm(1, cfg.num_register_tokens, D)
    if cfg.pre_norm:
        spec["norm_pre_scale"] = Leaf((D,), dt, "ones")
        spec["norm_pre_bias"] = Leaf((D,), dt, "zeros")
    return spec


def projector_param_spec(arch: str, vision_dim: int, llm_dim: int, dtype: torch.dtype) -> Dict[str, Any]:
    """torch nn.Linear default init: U(-1/sqrt(in), 1/sqrt(in)) for w and b."""

    def lin(out_dim, in_dim):
        bound = 1.0 / np.sqrt(in_dim)
        return {"w": Leaf((out_dim, in_dim), dtype, "uniform", bound),
                "b": Leaf((out_dim,), dtype, "uniform", bound)}

    if arch == "linear":
        return {"fc1": lin(llm_dim, vision_dim)}
    if arch.endswith("fused-gelu-mlp"):
        mid = vision_dim * 4
        return {"fc1": lin(mid, vision_dim), "fc2": lin(llm_dim, mid), "fc3": lin(llm_dim, llm_dim)}
    if arch.endswith("gelu-mlp"):
        return {"fc1": lin(llm_dim, vision_dim), "fc2": lin(llm_dim, llm_dim)}
    raise ValueError(f"Projector arch `{arch}` is not supported!")


def llama_param_spec(cfg: llama.LlamaConfig) -> Dict[str, Any]:
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_hidden_layers
    H, Hkv, Dh, dt = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.dtype

    def nrm(*shape):
        return Leaf(shape, dt, "normal", 0.02)

    layers = {
        "q_proj": nrm(L, H * Dh, D),
        "k_proj": nrm(L, Hkv * Dh, D),
        "v_proj": nrm(L, Hkv * Dh, D),
        "o_proj": nrm(L, D, H * Dh),
        "input_layernorm": Leaf((L, D), dt, "ones"),
        "post_attention_layernorm": Leaf((L, D), dt, "ones"),
    }
    E = cfg.moe_experts
    if E:   # expert stacks [L, E, ...] and the router in place of the dense MLP
        layers.update(router=nrm(L, E, D), gate_proj=nrm(L, E, F, D), up_proj=nrm(L, E, F, D),
                      down_proj=nrm(L, E, D, F))
    else:
        layers.update(gate_proj=nrm(L, F, D), up_proj=nrm(L, F, D), down_proj=nrm(L, D, F))
    return {"embed_tokens": nrm(V, D), "layers": layers, "norm": Leaf((D,), dt, "ones"),
            "lm_head": nrm(V, D)}


def phi_param_spec(cfg: phi.PhiConfig) -> Dict[str, Any]:
    D, F, V, L, dt = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                      cfg.num_hidden_layers, cfg.dtype)

    def nrm(*shape):
        return Leaf(shape, dt, "normal", 0.02)

    def zeros(*shape):
        return Leaf(shape, dt, "zeros")

    layers = {"ln_scale": Leaf((L, D), dt, "ones"), "ln_bias": zeros(L, D)}
    for name, out_dim, in_dim in (("q", D, D), ("k", D, D), ("v", D, D), ("dense", D, D),
                                  ("fc1", F, D), ("fc2", D, F)):
        layers[f"{name}_w"], layers[f"{name}_b"] = nrm(L, out_dim, in_dim), zeros(L, out_dim)
    return {"embed_tokens": nrm(V, D), "layers": layers,
            "final_ln_scale": Leaf((D,), dt, "ones"), "final_ln_bias": zeros(D),
            "lm_head_w": nrm(V, D), "lm_head_b": zeros(V)}


def vlm_param_spec(cfg: vlm.VLMConfig, quant_suffixes: Tuple[str, ...] = (),
                   bits=8) -> Dict[str, Any]:
    spec = {
        "vision": {name: vit_param_spec(v) for name, v in zip(cfg.vision_names, cfg.vision)},
        "projector": projector_param_spec(cfg.projector_arch, cfg.vision_dim,
                                          cfg.llm.hidden_size, cfg.llm.dtype),
        "llm": phi_param_spec(cfg.llm) if vlm.is_phi(cfg) else llama_param_spec(cfg.llm),
    }
    return _quantized_spec(spec, quant_suffixes, bits)


def _quantized(name: str, leaf: Leaf, quant_suffixes: Tuple[str, ...]) -> bool:
    return name in quant_suffixes and len(leaf.shape) >= 2


def _quant_leaf(name: str, leaf: Leaf, bits) -> Dict[str, Leaf]:
    """The layout `quantize_leaf` gives float leaf `name` under
    `quantize_params(..., bits)`."""
    if bits not in (4, 8, "mix", "nibble"):
        raise ValueError(f"bits must be 4, 8, 'mix' or 'nibble', got {bits!r}")
    *lead, O, K = leaf.shape
    width = leaf_bits(name, bits)
    if width == "nibble":
        plane = Leaf((*lead, O, K // 2), torch.uint8, leaf.init, leaf.arg)
        return {"hi": plane, "lo": plane, "s": Leaf((*lead, O), torch.float32, "scale")}
    int8 = {"q": Leaf(leaf.shape, torch.int8, leaf.init, leaf.arg),
            "s": Leaf(leaf.shape[:-1], torch.float32, "scale")}
    gsz = int4_group_size(K)
    if width not in (4, "mix") or not gsz:
        return int8
    int4 = {"q": Leaf((*lead, K // gsz, O, gsz // 2), torch.uint8, leaf.init, leaf.arg),
            "s": Leaf((*lead, O, K // gsz), torch.float32, "scale")}
    return int4 if width == 4 else {**int8, "q4": int4["q"], "s4": int4["s"]}


def _quantized_spec(spec: Dict[str, Any], quant_suffixes: Tuple[str, ...],
                    bits: int) -> Dict[str, Any]:
    out = {}
    for name, leaf in spec.items():
        if isinstance(leaf, dict):
            out[name] = _quantized_spec(leaf, quant_suffixes, bits)
        elif _quantized(name, leaf, quant_suffixes):
            out[name] = _quant_leaf(name, leaf, bits)
        else:
            out[name] = leaf
    return out


# --- JAX pytree (numpy) -> port --------------------------------------------------------

def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")   # own, writable host copy
    if arr.dtype.name == "bfloat16":   # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _packed_int4(arr: np.ndarray, spec: Leaf, path: str, device: torch.device) -> torch.Tensor:
    """The JAX package's int4 codes (grouped [..., G, O, gsz] or a nibble
    plane [..., O, K]; s4, or int8 from emit_codes=True) -> the port's packed
    uint8 (last dim halved)."""
    want = (*spec.shape[:-1], 2 * spec.shape[-1])
    if tuple(arr.shape) != want:
        raise ValueError(f"{path}: shape {arr.shape}, expected int4 codes {want}")
    if arr.dtype.name not in ("int4", "int8"):
        raise TypeError(f"{path}: dtype {arr.dtype}, expected int4 codes (int4 or int8)")
    codes = np.array(arr, dtype=np.int8)   # an own, writable copy
    if codes.size and (codes.min() < -8 or codes.max() > 7):
        raise ValueError(f"{path}: int4 codes outside [-8, 7]")
    return pack_int4(torch.from_numpy(codes)).to(device)


def _convert(tree: Any, spec: Any, path: str, device: torch.device) -> Any:
    if isinstance(spec, Leaf):
        if isinstance(tree, dict):
            raise NotImplementedError(
                f"{path}: a {sorted(tree)} leaf where the layout has a float weight (name it "
                "in quant_suffixes for a quantized leaf; LoRA-wrapped leaves are not "
                "ported yet: ROADMAP Queue 1 item 13)")
        arr = np.asarray(tree)
        if spec.dtype == torch.uint8:
            return _packed_int4(arr, spec, path, device)
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected {spec.shape}")
        if (spec.dtype == torch.int8) != (arr.dtype == np.int8) or arr.dtype.name == "int4":
            raise TypeError(f"{path}: dtype {arr.dtype}, expected {spec.dtype}")
        return _to_tensor(arr, device)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: expected a subtree with keys {sorted(spec)}, got {type(tree)}")
    missing = sorted(set(spec) - set(tree))
    extra = sorted(set(tree) - set(spec))
    if missing:
        raise KeyError(f"{path or '<root>'}: missing leaves {missing}")
    if extra:
        raise KeyError(f"{path or '<root>'}: leaves the port does not consume {extra}")
    return {k: _convert(tree[k], spec[k], f"{path}/{k}", device) for k in spec}


def params_from_jax(tree: Dict[str, Any], cfg: vlm.VLMConfig, device: DeviceLike = "cuda",
                    quant_suffixes: Tuple[str, ...] = (), bits=8) -> Dict[str, Any]:
    """The JAX package's VLM parameter pytree (numpy leaves, scan-stacked
    layers; the weights named in `quant_suffixes` as its `quantize_params(...,
    bits)` leaves) -> the port's parameters on `device`, dtypes kept, int4
    codes packed."""
    return _convert(tree, vlm_param_spec(cfg, quant_suffixes, bits), "", resolve_device(device))


# --- random init on the device ---------------------------------------------------------

def _init_leaf(leaf: Leaf, generator: torch.Generator, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    dt = dtype or leaf.dtype
    if leaf.init == "normal":
        x = torch.randn(leaf.shape, generator=generator, device=device, dtype=torch.float32)
        return (x * leaf.arg).to(dt)
    if leaf.init == "uniform":
        x = torch.rand(leaf.shape, generator=generator, device=device, dtype=torch.float32)
        return (x * (2 * leaf.arg) - leaf.arg).to(dt)
    fill = {"zeros": 0.0, "ones": 1.0, "const": leaf.arg}[leaf.init]
    return torch.full(leaf.shape, fill, dtype=dt, device=device)


def _init_quantized(name: str, leaf: Leaf, generator: torch.Generator, device: torch.device,
                    dtype: Optional[torch.dtype], bits) -> Dict[str, torch.Tensor]:
    """The quantized leaf of random float leaf `name`, made and quantized one
    [O, K] slice at a time (the peak is one float slice, not the stack)."""
    *lead, O, K = leaf.shape
    out = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
           for k, v in _quant_leaf(name, leaf, bits).items()}
    for idx in np.ndindex(*lead):
        w = quantize_leaf(_init_leaf(leaf._replace(shape=(O, K)), generator, device, dtype),
                          leaf_bits(name, bits))
        for k in out:
            out[k][idx] = w[k]
    return out


def init_params(cfg: vlm.VLMConfig, generator: torch.Generator, device: DeviceLike = "cuda",
                dtype: Optional[torch.dtype] = None,
                quant_suffixes: Tuple[str, ...] = (), bits=8) -> Dict[str, Any]:
    """Random VLM weights made on `device` (normal(0.02) weights, zero biases,
    unit norms, 1e-5 LayerScale, nn.Linear-uniform projector), in each
    module's config dtype unless `dtype` is given; the weights named in
    `quant_suffixes` are quantized from that float value (bits=8 per-channel
    int8, bits=4 grouped int4, bits="mix" int8 and int4 copies, bits="nibble"
    nibble planes whose codes span [-8, 7]). `generator` must live on
    `device`."""
    dev = resolve_device(device)

    def walk(spec):
        out = {}
        for name, leaf in spec.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf)
            elif _quantized(name, leaf, quant_suffixes):
                out[name] = _init_quantized(name, leaf, generator, dev, dtype, bits)
            else:
                out[name] = _init_leaf(leaf, generator, dev, dtype)
        return out

    return walk(vlm_param_spec(cfg))


# --- configs ------------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_DTYPE_FIELDS = ("dtype", "attn_scores_dtype", "rope_dtype")
# the port's fields for what the JAX package reads from its environment (the
# kernel gates): left at their defaults here, set by the serving tier or, for
# training, by the caller (flash_attn=False: the JAX OVLA_PALLAS_ATTN=0); and
# tp_heads and row_split, a rank's local config in sharded serving (GSPMD's business in JAX)
_ROUTE_FIELDS = ("int8_matmul", "fused_rmsq", "flash_attn", "tp_heads", "row_split")


def _fields(obj: Any, cls: type, **override) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in _ROUTE_FIELDS:
            continue
        if f.name in override:
            out[f.name] = override[f.name]
        elif f.name in _DTYPE_FIELDS:
            out[f.name] = _DTYPES[np.dtype(getattr(obj, f.name)).name]
        else:
            out[f.name] = getattr(obj, f.name)
    return out


def config_from_jax(cfg: Any) -> Any:
    """A JAX-package VLMConfig / VLAServingConfig -> the port's (the turbo
    numerics' bf16 scores and RoPE included; the kernel routes of the turbo
    and turbo_kv8 tiers), over a Llama (dense or MoE) or Phi-2 trunk."""
    if hasattr(cfg, "vlm"):   # VLAServingConfig
        vlm_cfg = config_from_jax(cfg.vlm)
        if cfg.tier in ("turbo", "turbo_kv8"):
            vlm_cfg = vla.turbo_routes(vlm_cfg)
        return vla.VLAServingConfig(**_fields(cfg, vla.VLAServingConfig, vlm=vlm_cfg))
    trunk = phi.PhiConfig if type(cfg.llm).__name__ == "PhiConfig" else llama.LlamaConfig
    llm = trunk(**_fields(cfg.llm, trunk))
    vision = tuple(vit.ViTConfig(**_fields(v, vit.ViTConfig)) for v in cfg.vision)
    return vlm.VLMConfig(**_fields(cfg, vlm.VLMConfig, llm=llm, vision=vision))


# --- training state ----------------------------------------------------------------------


def _tensors(tree: Any, device: torch.device) -> Any:
    """A tree of dicts with numpy (or None) leaves -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return None if tree is None else _to_tensor(np.asarray(tree), device)


def lora_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    """The JAX package's LoRA tree (``training.lora.init_lora_params``: None,
    or ``{"A": [..., r, I], "B": [..., O, r]}`` at each target leaf; numpy
    leaves) -> the port's, dtypes kept (fp32 masters)."""
    return _tensors(tree, resolve_device(device))


def _named_states(state: Any):
    """Every NamedTuple inside an optax chain state (nested tuples)."""
    if isinstance(state, tuple):
        if hasattr(state, "_fields"):
            yield state
        for s in state:
            yield from _named_states(s)


def opt_state_from_jax(state: Any, device: DeviceLike = "cuda") -> OptState:
    """The JAX package's optax state of ``make_optimizer`` (clip, scale_by_adam,
    masked decay, scale_by_learning_rate; numpy leaves) -> the port's
    `OptState`: the Adam count (which the schedule's count equals), mu, nu."""
    dev = resolve_device(device)
    named = list(_named_states(state))
    adam = [s for s in named if set(s._fields) == {"count", "mu", "nu"}]
    if len(adam) != 1:
        raise ValueError(f"expected one ScaleByAdamState in the optax state, found {len(adam)}")
    count = int(np.asarray(adam[0].count))
    sched = [int(np.asarray(s.count)) for s in named if tuple(s._fields) == ("count",)]
    if any(c != count for c in sched):
        raise ValueError(f"schedule count {sched} differs from the Adam count {count}")
    return OptState(count, _tensors(adam[0].mu, dev), _tensors(adam[0].nu, dev))
