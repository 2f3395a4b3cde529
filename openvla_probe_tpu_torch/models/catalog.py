"""Backbone-id catalog, pretrained-model registry and HF-checkpoint weight
import (counterpart of ``openvla_probe_tpu/models/catalog.py``).

String ids resolve to the port's configs, and an OpenVLA / Prismatic
checkpoint (HF-layout safetensors, or a reference-native ``.pt``) maps onto
the port's layer-stacked trees. Weights stay torch tensors on the way: each
leaf is read from the checkpoint (mmapped safetensors, or an mmapped
``torch.load``), cast to the config's dtype once and moved to `device` one
layer at a time, so no float32 copy of the tree is ever made on the host.

HF key layout (fused dual backbone):
  vision_backbone.featurizer.*        timm DINOv2 (LayerScale gamma renamed
                                      `scale_factor` in the HF export)
  vision_backbone.fused_featurizer.*  timm SigLIP
  projector.fc{1,2,3}.{weight,bias}
  language_model.model.* / language_model.lm_head.weight

Ids whose towers or trunk the port lacks resolve to their names, and
building them raises NotImplementedError citing the ROADMAP item: the CLIP
and ImageNet-21k towers (``clip-vit-l*``, ``in1k-vit-l``, ``dinoclip-*``,
item 3) and the Phi-2 and Mixtral trunks (``phi-2-3b``, ``mixtral-*``,
item 15).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device
from ..ops.image import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    OPENAI_CLIP_MEAN,
    OPENAI_CLIP_STD,
    SIGLIP_MEAN,
    SIGLIP_STD,
    BackboneTransformSpec,
    ImageTransformConfig,
)
from . import llama, vit, vlm
from .prompting import (
    LLaMa2ChatPromptBuilder,
    MistralInstructPromptBuilder,
    PhiPromptBuilder,
    PurePromptBuilder,
    VicunaV15ChatPromptBuilder,
)
from .safetensors_io import read_dir, to_tensor

_TOWERS = "the CLIP and ImageNet-21k ViT-L towers are ROADMAP Queue 1 item 3"
_TRUNKS = "the Phi-2 and Mixtral trunks are ROADMAP Queue 1 item 15"

# --- vision backbone catalog (reference models/materialize.py:19-44) --------


def _spec(size, interp, mean, std):
    return BackboneTransformSpec((size, size), interp, mean, std)


def _missing(reason: str, specs, names=None) -> Dict[str, Any]:
    """An entry whose configs the port lacks: its specs resolve, building raises."""
    entry = {"missing": reason, "specs": specs}
    if names:
        entry["names"] = names
    return entry


VISION_BACKBONES: Dict[str, Dict[str, Any]] = {
    "clip-vit-l": _missing(_TOWERS, [_spec(224, "bicubic", OPENAI_CLIP_MEAN, OPENAI_CLIP_STD)]),
    "clip-vit-l-336px": _missing(_TOWERS,
                                 [_spec(336, "bicubic", OPENAI_CLIP_MEAN, OPENAI_CLIP_STD)]),
    "dinov2-vit-l": {"cfgs": [vit.ViTConfig.dinov2_vit_l()],
                     "specs": [_spec(224, "bicubic", IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD)]},
    "in1k-vit-l": _missing(_TOWERS,
                           [_spec(224, "bicubic", IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD)]),
    "siglip-vit-so400m": {"cfgs": [vit.ViTConfig.siglip_so400m()],
                          "specs": [_spec(224, "bicubic", SIGLIP_MEAN, SIGLIP_STD)]},
    "siglip-vit-so400m-224px": {"cfgs": [vit.ViTConfig.siglip_so400m()],
                                "specs": [_spec(224, "bicubic", SIGLIP_MEAN, SIGLIP_STD)]},
    "siglip-vit-so400m-384px": {"cfgs": [vit.ViTConfig.siglip_so400m(image_size=384)],
                                "specs": [_spec(384, "bicubic", SIGLIP_MEAN, SIGLIP_STD)]},
    "dinoclip-vit-l-336px": _missing(
        _TOWERS, [_spec(336, "bicubic", IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD),
                  _spec(336, "bicubic", OPENAI_CLIP_MEAN, OPENAI_CLIP_STD)], ("dino", "clip")),
    "dinosiglip-vit-so-224px": {
        "cfgs": [vit.ViTConfig.dinov2_vit_l(), vit.ViTConfig.siglip_so400m()],
        "specs": [_spec(224, "bicubic", IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD),
                  _spec(224, "bicubic", SIGLIP_MEAN, SIGLIP_STD)],
        "names": ("dino", "siglip"),
    },
    "dinosiglip-vit-so-384px": {
        "cfgs": [vit.ViTConfig.dinov2_vit_l(image_size=384),
                 vit.ViTConfig.siglip_so400m(image_size=384)],
        "specs": [_spec(384, "bicubic", IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD),
                  _spec(384, "bicubic", SIGLIP_MEAN, SIGLIP_STD)],
        "names": ("dino", "siglip"),
    },
    # test/smoke-scale fused backbone (28px, patch 14 -> 4 patches per tower)
    "dinosiglip-tiny-28px": {
        "cfgs": [vit.ViTConfig.tiny(num_register_tokens=4, no_embed_class=True,
                                    use_layerscale=True),
                 vit.ViTConfig.tiny(use_cls_token=False, act="gelu_tanh")],
        "specs": [_spec(28, "bicubic", IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD),
                  _spec(28, "bicubic", SIGLIP_MEAN, SIGLIP_STD)],
        "names": ("dino", "siglip"),
    },
}

# --- llm backbone catalog (reference models/materialize.py:46-76) -----------

_MISTRAL = dict(vocab_size=32000, num_key_value_heads=8, intermediate_size=14336,
                max_position_embeddings=4096)

LLM_BACKBONES: Dict[str, Dict[str, Any]] = {
    "llama2-7b-pure": {"cfg": llama.LlamaConfig.llama2_7b(), "prompt": PurePromptBuilder},
    "llama2-13b-pure": {"cfg": llama.LlamaConfig.llama2_13b(), "prompt": PurePromptBuilder},
    "llama2-7b-chat": {"cfg": llama.LlamaConfig.llama2_7b(), "prompt": LLaMa2ChatPromptBuilder},
    "llama2-13b-chat": {"cfg": llama.LlamaConfig.llama2_13b(), "prompt": LLaMa2ChatPromptBuilder},
    "vicuna-v15-7b": {"cfg": llama.LlamaConfig.llama2_7b(), "prompt": VicunaV15ChatPromptBuilder},
    "vicuna-v15-13b": {"cfg": llama.LlamaConfig.llama2_13b(),
                       "prompt": VicunaV15ChatPromptBuilder},
    "mistral-v0.1-7b-pure": {"cfg": llama.LlamaConfig(rope_theta=10000.0, **_MISTRAL),
                             "prompt": PurePromptBuilder},
    "mistral-v0.1-7b-instruct": {"cfg": llama.LlamaConfig(**_MISTRAL),
                                 "prompt": MistralInstructPromptBuilder},
    "phi-2-3b": {"missing": _TRUNKS, "prompt": PhiPromptBuilder},
    "mixtral-8x7b-v0.1": {"missing": _TRUNKS, "prompt": PurePromptBuilder},
    "mixtral-8x7b-instruct-v0.1": {"missing": _TRUNKS, "prompt": MistralInstructPromptBuilder},
    # test/smoke-scale LLMs
    "llama-tiny": {"cfg": llama.LlamaConfig.tiny(vocab_size=512), "prompt": PurePromptBuilder},
    "mixtral-tiny": {"missing": _TRUNKS, "prompt": PurePromptBuilder},
}


def get_vision_backbone_and_transform(
    vision_backbone_id: str, image_resize_strategy: str
) -> Tuple[Tuple[vit.ViTConfig, ...], Tuple[str, ...], ImageTransformConfig]:
    entry = VISION_BACKBONES[vision_backbone_id]
    if "missing" in entry:
        raise NotImplementedError(f"vision backbone {vision_backbone_id!r}: {entry['missing']}")
    cfgs = tuple(entry["cfgs"])
    names = tuple(entry.get(
        "names",
        tuple(f"vision_{i}" for i in range(len(cfgs))) if len(cfgs) > 1 else ("vision",),
    ))
    img_cfg = ImageTransformConfig(specs=tuple(entry["specs"]), resize_strategy=image_resize_strategy)
    return cfgs, names, img_cfg


def get_llm_backbone_and_prompt(llm_backbone_id: str) -> Tuple[llama.LlamaConfig, type]:
    entry = LLM_BACKBONES[llm_backbone_id]
    if "missing" in entry:
        raise NotImplementedError(f"LLM backbone {llm_backbone_id!r}: {entry['missing']}")
    return entry["cfg"], entry["prompt"]


def build_vlm_config(
    vision_backbone_id: str = "dinosiglip-vit-so-224px",
    llm_backbone_id: str = "llama2-7b-pure",
    arch_specifier: str = "no-align+fused-gelu-mlp",
    image_resize_strategy: str = "resize-naive",
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[vlm.VLMConfig, ImageTransformConfig, type]:
    """Resolve string ids -> (VLMConfig, image transform config, prompt builder)."""
    vcfgs, names, img_cfg = get_vision_backbone_and_transform(
        vision_backbone_id, image_resize_strategy
    )
    lcfg, prompt_cls = get_llm_backbone_and_prompt(llm_backbone_id)
    vcfgs = tuple(dataclasses.replace(v, dtype=dtype) for v in vcfgs)
    lcfg = dataclasses.replace(lcfg, dtype=dtype)
    cfg = vlm.VLMConfig(llm=lcfg, vision=vcfgs, vision_names=names, arch_specifier=arch_specifier)
    return cfg, img_cfg, prompt_cls


# --- pretrained model registry ----------------------------------------------
# The Prismatic / OpenVLA release's model table (ids, display names,
# descriptions): the port's copy of the JAX package's model_registry.json,
# plus the OpenVLA policy entry.


def _load_model_registry() -> Dict[str, Dict[str, Any]]:
    reg_path = Path(__file__).parent / "model_registry.json"
    registry: Dict[str, Dict[str, Any]] = {}
    if reg_path.exists():
        with open(reg_path) as f:
            registry.update(json.load(f))
    registry.setdefault("openvla-7b", {
        "model_id": "openvla-7b",
        "names": ["OpenVLA 7B"],
        # released policies live in their OWN HF repos (HF-layout), not the
        # TRI-ML prismatic-vlms run-dir repo: loaders route by this field
        "hf_repo": "openvla/openvla-7b",
        "description": {
            "name": "OpenVLA 7B",
            "description": "OpenVLA 7B policy (prism-dinosiglip-224px backbone) "
                           "trained on the Open-X magic-soup++ mixture",
        },
    })
    return registry


MODEL_REGISTRY: Dict[str, Dict[str, Any]] = _load_model_registry()
GLOBAL_REGISTRY: Dict[str, Dict[str, Any]] = {
    name: v for v in MODEL_REGISTRY.values() for name in [v["model_id"], *v.get("names", [])]
}


# --- HF checkpoint import ----------------------------------------------------


class _Prefixed(Mapping):
    """The entries of `state` under `prefix`, the prefix stripped, read only
    when looked up (a lazy state stays lazy)."""

    def __init__(self, state: Mapping, prefix: str) -> None:
        self._state, self._prefix = state, prefix

    def __getitem__(self, key: str):
        return self._state[self._prefix + key]

    def __contains__(self, key) -> bool:
        return self._prefix + key in self._state

    def __iter__(self) -> Iterator[str]:
        n = len(self._prefix)
        return (k[n:] for k in self._state if k.startswith(self._prefix))

    def __len__(self) -> int:
        return sum(1 for _ in self)


def _featurizer_prefixes(cfg: vlm.VLMConfig):
    if len(cfg.vision) == 1:
        return [("featurizer.", cfg.vision_names[0])]
    return [("featurizer.", cfg.vision_names[0]), ("fused_featurizer.", cfg.vision_names[1])]


def params_from_hf_state(state: Mapping, cfg: vlm.VLMConfig, device: DeviceLike = "cuda",
                         llm_bits=None) -> Dict[str, Any]:
    """A full HF-layout state (name -> tensor or numpy array, e.g. a lazy
    `safetensors_io.read_dir` state) -> the port's tree on `device`, each
    leaf in its config's dtype. With `llm_bits`, the LLM leaves that
    `ops.linear.quantize_params(..., bits=llm_bits)` quantizes come out
    quantized, one layer at a time on `device` (`llama.params_from_hf`)."""
    dev = resolve_device(device)
    params: Dict[str, Any] = {"vision": {}}
    for prefix, name in _featurizer_prefixes(cfg):
        sub = _Prefixed(state, f"vision_backbone.{prefix}")
        vcfg = cfg.vision[cfg.vision_names.index(name)]
        params["vision"][name] = vit.params_from_timm(sub, vcfg, device=dev)
    proj = _Prefixed(state, "projector.")
    params["projector"] = {
        fc: {"w": to_tensor(proj[f"{fc}.weight"]).to(device=dev, dtype=cfg.llm.dtype),
             "b": to_tensor(proj[f"{fc}.bias"]).to(device=dev, dtype=cfg.llm.dtype)}
        for fc in ["fc1", "fc2", "fc3"]
        if f"{fc}.weight" in proj
    }
    params["llm"] = llama.params_from_hf(_Prefixed(state, "language_model."), cfg.llm,
                                         device=dev, bits=llm_bits)
    return params


def params_to_hf_state(params: Dict[str, Any], cfg: vlm.VLMConfig) -> Dict[str, torch.Tensor]:
    """Inverse of params_from_hf_state: the port's tree -> the HF-layout flat
    state (the convert_openvla_weights_to_hf.py export schema), each entry a
    view of the tree's tensor (its dtype and device: nothing is copied; a
    writer moves and casts one tensor at a time)."""
    state: Dict[str, torch.Tensor] = {}
    for prefix, name in _featurizer_prefixes(cfg):
        vp = params["vision"][name]
        vcfg = cfg.vision[cfg.vision_names.index(name)]
        base = f"vision_backbone.{prefix}"
        state[f"{base}patch_embed.proj.weight"] = vp["patch_embed"]["weight"].reshape(
            vcfg.hidden_size, 3, vcfg.patch_size, vcfg.patch_size)
        if "bias" in vp["patch_embed"]:
            state[f"{base}patch_embed.proj.bias"] = vp["patch_embed"]["bias"]
        state[f"{base}pos_embed"] = vp["pos_embed"]
        if "cls_token" in vp:
            state[f"{base}cls_token"] = vp["cls_token"]
        if "reg_token" in vp:
            state[f"{base}reg_token"] = vp["reg_token"]
        if "norm_pre_scale" in vp:
            state[f"{base}norm_pre.weight"] = vp["norm_pre_scale"]
            state[f"{base}norm_pre.bias"] = vp["norm_pre_bias"]
        names_map = {
            "norm1_scale": "norm1.weight", "norm1_bias": "norm1.bias",
            "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
            "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
            "norm2_scale": "norm2.weight", "norm2_bias": "norm2.bias",
            "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
            "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
            "ls1": "ls1.scale_factor", "ls2": "ls2.scale_factor",
        }
        for ours, timm_key in names_map.items():
            if ours not in vp["blocks"]:
                continue
            for i in range(vcfg.num_layers):
                state[f"{base}blocks.{i}.{timm_key}"] = vp["blocks"][ours][i]
    for fc in ["fc1", "fc2", "fc3"]:
        if fc in params["projector"]:
            state[f"projector.{fc}.weight"] = params["projector"][fc]["w"]
            state[f"projector.{fc}.bias"] = params["projector"][fc]["b"]
    lp = params["llm"]
    state["language_model.model.embed_tokens.weight"] = lp["embed_tokens"]
    state["language_model.model.norm.weight"] = lp["norm"]
    state["language_model.lm_head.weight"] = lp["lm_head"]
    inv_llm = {v: k for k, v in llama._HF_LAYER_KEYS.items()}
    for ours, hf_key in inv_llm.items():
        for i in range(cfg.llm.num_hidden_layers):
            state[f"language_model.model.layers.{i}.{hf_key}"] = lp["layers"][ours][i]
    return state


def remap_prismatic_state(
    model_state: Dict[str, Dict[str, Any]],
    fused_vision: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """Reference-native component state dicts -> the HF-extern flat key scheme
    `params_from_hf_state` consumes (vla-scripts/extern/
    convert_openvla_weights_to_hf.py:76-117): sequential projector indices ->
    fc{1,2,3}, `llm.` -> `language_model.`, dino/siglip featurizer prefixes ->
    vision_backbone.{featurizer,fused_featurizer}., DINOv2 LayerScale `gamma`
    -> `scale_factor`. Values stay torch tensors, each cast to `dtype` once
    if given (no float32 copy of a bf16 state)."""
    def cast(v):
        t = to_tensor(v)
        return t if dtype is None else t.to(dtype)

    proj_map = {"projector.0": "projector.fc1", "projector.2": "projector.fc2",
                "projector.4": "projector.fc3"}
    out: Dict[str, torch.Tensor] = {}
    for key, v in model_state["projector"].items():
        stem, leaf = key.rsplit(".", 1)
        out[f"{proj_map[stem]}.{leaf}"] = cast(v)
    for key, v in model_state["llm_backbone"].items():
        out[key.replace("llm.", "language_model.", 1)] = cast(v)
    for key, v in model_state["vision_backbone"].items():
        if fused_vision and key.startswith("dino_featurizer."):
            if key.endswith(".gamma"):
                key = key.replace(".gamma", ".scale_factor")
            out[key.replace("dino_featurizer.", "vision_backbone.featurizer.", 1)] = cast(v)
        elif fused_vision and key.startswith("siglip_featurizer."):
            out[key.replace("siglip_featurizer.", "vision_backbone.fused_featurizer.", 1)] = cast(v)
        else:
            out["vision_backbone." + key] = cast(v)
    return out


def load_prismatic_checkpoint(
    config_json: Union[str, Path],
    checkpoint_pt: Union[str, Path],
    dataset_statistics_json: Optional[Union[str, Path]] = None,
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = "cuda",
    llm_bits=None,
) -> Dict[str, Any]:
    """Load a reference-NATIVE training-run checkpoint (`config.json` +
    `checkpoints/*.pt`), the format the hub repos TRI-ML/prismatic-vlms and
    openvla/openvla-dev store (reference prismatic/models/load.py:51-226),
    onto `device`. The ``.pt`` is read mmapped (``torch.load(mmap=True)``).

    config.json carries either {"model": {...}} (VLM run) or
    {"vla": {"base_vlm": <ModelConfig id>}} (VLA run)."""
    with open(config_json) as f:
        raw = json.load(f)
    if "vla" in raw:
        from ..conf.models import ModelConfig

        mc = ModelConfig.get_choice_class(raw["vla"]["base_vlm"])()
        vision_id, llm_id = mc.vision_backbone_id, mc.llm_backbone_id
        arch, resize = mc.arch_specifier, mc.image_resize_strategy
    else:
        m = raw["model"]
        vision_id, llm_id = m["vision_backbone_id"], m["llm_backbone_id"]
        arch = m.get("arch_specifier", "no-align+fused-gelu-mlp")
        resize = m.get("image_resize_strategy", "resize-naive")
    cfg, img_cfg, prompt_cls = build_vlm_config(vision_id, llm_id, arch, resize, dtype=dtype)
    model_state = torch.load(checkpoint_pt, map_location="cpu", weights_only=True,
                             mmap=True)["model"]
    state = remap_prismatic_state(model_state, fused_vision=len(cfg.vision) == 2, dtype=dtype)
    emb = state.get("language_model.model.embed_tokens.weight")
    if emb is not None and emb.shape[0] != cfg.llm.vocab_size:
        # VLA runs resize the vocab for the pad token (32000 -> 32064); the
        # checkpoint is the source of truth
        cfg = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, vocab_size=int(emb.shape[0])))
    params = params_from_hf_state(state, cfg, device=device, llm_bits=llm_bits)
    norm_stats = {}
    if dataset_statistics_json and Path(dataset_statistics_json).exists():
        with open(dataset_statistics_json) as f:
            norm_stats = json.load(f)
    return {"params": params, "cfg": cfg, "image_cfg": img_cfg,
            "prompt_builder": prompt_cls, "norm_stats": norm_stats}


def load_openvla_hf_checkpoint(
    checkpoint_dir: Union[str, Path],
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = "cuda",
    llm_bits=None,
) -> Dict[str, Any]:
    """Load an OpenVLA HF checkpoint directory -> (params on `device`, cfg,
    img_cfg, norm_stats). Reads config.json for the backbone ids and the
    norm stats, and the safetensors files one tensor at a time."""
    path = Path(checkpoint_dir)
    with open(path / "config.json") as f:
        hf_cfg = json.load(f)
    vision_id = hf_cfg.get("vision_backbone_id", "dinosiglip-vit-so-224px")
    resize = hf_cfg.get("image_resize_strategy", "resize-naive")
    llm_id = hf_cfg.get("llm_backbone_id", "llama2-7b-pure")
    cfg, img_cfg, prompt_cls = build_vlm_config(vision_id, llm_id,
                                                hf_cfg.get("arch_specifier", "no-align+fused-gelu-mlp"),
                                                resize, dtype=dtype)
    # the HF text config carries the padded vocab (32064)
    text_vocab = hf_cfg.get("text_config", {}).get("vocab_size")
    if text_vocab:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, vocab_size=text_vocab))
    state = read_dir(path)
    params = params_from_hf_state(state, cfg, device=device, llm_bits=llm_bits)
    norm_stats = hf_cfg.get("norm_stats", {})
    return {"params": params, "cfg": cfg, "image_cfg": img_cfg,
            "prompt_builder": prompt_cls, "norm_stats": norm_stats}
