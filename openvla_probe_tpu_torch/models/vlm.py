"""Prismatic VLM: dual-ViT vision + projector + Llama (counterpart of ``openvla_probe_tpu/models/vlm.py``).

Vision features are each backbone's second-to-last-block patch tokens,
concatenated on the channel axis; projected patches are spliced in after the
BOS token, with IGNORE_INDEX labels. `forward` is the uncached
training / eval forward (multimodal, unimodal or mixed) that the candidate
scorer runs, with the hidden-state probe tap on request. The Llama trunk
only: Phi is not ported (ROADMAP Queue 1, item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from . import llama, projector, vit

Params = Dict[str, Any]
IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    llm: llama.LlamaConfig
    vision: Tuple[vit.ViTConfig, ...]
    vision_names: Tuple[str, ...] = ("dino", "siglip")
    arch_specifier: str = "no-align+fused-gelu-mlp"
    feature_layer_index: int = -2

    @property
    def vision_dim(self) -> int:
        return sum(v.hidden_size for v in self.vision)

    @property
    def num_patches(self) -> int:
        return self.vision[0].num_patches

    @property
    def projector_arch(self) -> str:
        return self.arch_specifier.split("+")[-1]

    @staticmethod
    def openvla_7b() -> "VLMConfig":
        """prism-dinosiglip-224px+7b: DINOv2 ViT-L/14-reg + SigLIP so400m + Llama-2-7B."""
        return VLMConfig(
            llm=llama.LlamaConfig.llama2_7b(),
            vision=(vit.ViTConfig.dinov2_vit_l(dtype=torch.bfloat16),
                    vit.ViTConfig.siglip_so400m(dtype=torch.bfloat16)),
        )

    @staticmethod
    def openvla_13b() -> "VLMConfig":
        """prism-dinosiglip-224px+13b dims: the same dual ViT, a Llama-2-13B trunk."""
        return VLMConfig(
            llm=llama.LlamaConfig.llama2_13b(),
            vision=(vit.ViTConfig.dinov2_vit_l(dtype=torch.bfloat16),
                    vit.ViTConfig.siglip_so400m(dtype=torch.bfloat16)),
        )

    def turbo(self) -> "VLMConfig":
        """The turbo serving numerics: bf16 attention scores in trunk and
        towers, bf16 RoPE, and tanh-approximated GELU where a tower specifies
        exact erf GELU (the JAX package's single definition)."""
        return dataclasses.replace(
            self,
            llm=dataclasses.replace(self.llm, attn_scores_dtype=torch.bfloat16,
                                    rope_dtype=torch.bfloat16),
            vision=tuple(
                dataclasses.replace(v, attn_scores_dtype=torch.bfloat16,
                                    act="gelu_tanh" if v.act == "gelu" else v.act)
                for v in self.vision),
        )

    @staticmethod
    def tiny(**kw) -> "VLMConfig":
        d = dict(
            llm=llama.LlamaConfig.tiny(),
            vision=(vit.ViTConfig.tiny(num_register_tokens=2, no_embed_class=True, use_layerscale=True),
                    vit.ViTConfig.tiny(use_cls_token=False, act="gelu_tanh")),
        )
        d.update(kw)
        return VLMConfig(**d)


def vision_features(params: Params, cfg: VLMConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """Channel-stacked [B, 3*K, S, S] -> concatenated patch features [B, N, sum(D_k)]."""
    feats = []
    for i, (name, vcfg) in enumerate(zip(cfg.vision_names, cfg.vision)):
        px = pixel_values[:, 3 * i:3 * (i + 1)]
        feats.append(vit.forward_features(params["vision"][name], vcfg, px, cfg.feature_layer_index))
    return torch.cat(feats, dim=-1)


def project_patches(params: Params, cfg: VLMConfig, patch_features: torch.Tensor) -> torch.Tensor:
    return projector.forward(params["projector"], cfg.projector_arch, patch_features)


def build_multimodal_inputs(
    params: Params,
    cfg: VLMConfig,
    input_ids: torch.Tensor,        # [B, T]
    attn_mask: torch.Tensor,        # [B, T]
    pixel_values: torch.Tensor,     # [B, 3K, S, S]
    labels: Optional[torch.Tensor] = None,
    multimodal_mask: Optional[torch.Tensor] = None,   # [B] bool; False = text-only row
) -> Dict[str, torch.Tensor]:
    """Splice projected patches after BOS: [BOS | patches | rest].

    The patch block gets IGNORE_INDEX labels. In a mixed batch a text-only
    row keeps the spliced layout with its patch block masked out of
    attention (with the mask-cumsum positions of `forward` it computes the
    unspliced unimodal row)."""
    patches = project_patches(params, cfg, vision_features(params, cfg, pixel_values))
    patches = patches.to(cfg.llm.dtype)
    embeds = llama.embed_tokens(params["llm"], input_ids)   # Llama trunk only (no Phi)
    B, N = patches.shape[:2]
    mm_embeds = torch.cat([embeds[:, :1], patches, embeds[:, 1:]], dim=1)
    if multimodal_mask is None:
        patch_valid = torch.ones((B, N), dtype=attn_mask.dtype, device=attn_mask.device)
    else:
        patch_valid = multimodal_mask.to(attn_mask.dtype)[:, None].expand(B, N)
    mm_mask = torch.cat([attn_mask[:, :1], patch_valid, attn_mask[:, 1:]], dim=1)
    out = {"inputs_embeds": mm_embeds, "attn_mask": mm_mask, "patches": patches}
    if labels is not None:
        patch_labels = torch.full((B, N), IGNORE_INDEX, dtype=labels.dtype, device=labels.device)
        out["labels"] = torch.cat([labels[:, :1], patch_labels, labels[:, 1:]], dim=1)
    return out


def forward(
    params: Params,
    cfg: VLMConfig,
    input_ids: torch.Tensor,                        # [B, T]
    attn_mask: torch.Tensor,                        # [B, T]
    pixel_values: Optional[torch.Tensor] = None,    # [B, 3K, S, S]
    labels: Optional[torch.Tensor] = None,          # [B, T]
    collect_hidden_states: bool = False,
    multimodal_mask: Optional[torch.Tensor] = None,   # [B] bool for mixed batches
) -> Dict[str, Any]:
    """Training / eval forward: multimodal when `pixel_values` is given, else
    unimodal; the uncached `llama.forward` (Tk = T, so prefill-sized rows take
    the flash kernels: one-shot up to 1024 keys, blockwise beyond). For mixed
    batches pass `multimodal_mask` (False rows = text-only): their patch block
    is excluded from attention and RoPE positions count only attended tokens.

    Returns logits [B, T', V] fp32, last_hidden_state, the labels aligned
    with the logits when `labels` is given, and with `collect_hidden_states`
    the probe tap hidden_pooled [B, L+1, D] (`llama.forward`'s, pooled over
    the attention mask)."""
    if not isinstance(cfg.llm, llama.LlamaConfig):
        raise NotImplementedError(
            f"vlm.forward on a {type(cfg.llm).__name__} trunk: the port has the Llama trunk "
            "only (Phi: ROADMAP Queue 1 item 15)")
    if pixel_values is None:
        embeds = llama.embed_tokens(params["llm"], input_ids)
        mask, lbls = attn_mask, labels
    else:
        mm = build_multimodal_inputs(params, cfg, input_ids, attn_mask, pixel_values, labels,
                                     multimodal_mask=multimodal_mask)
        embeds, mask, lbls = mm["inputs_embeds"], mm["attn_mask"], mm.get("labels")
    B, T = embeds.shape[:2]
    if multimodal_mask is not None and pixel_values is not None:
        # position = index among attended tokens (text-only rows skip their
        # masked patch block, as the unspliced row's RoPE positions do)
        positions = torch.clamp(torch.cumsum(mask, dim=1) - 1, min=0)
    else:
        positions = torch.arange(T, device=embeds.device).expand(B, T)
    out = llama.forward(params["llm"], cfg.llm, embeds, mask, positions,
                        collect_hidden_states=collect_hidden_states)
    if lbls is not None:
        out["labels"] = lbls
    return out
