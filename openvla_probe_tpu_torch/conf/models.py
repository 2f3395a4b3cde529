"""VLM model configurations + experiment registry.

Mirrors the reference's ModelConfig choice system (prismatic/conf/models.py:
19-584) with the COMPLETE variant registry: same field surface (backbone ids,
arch specifier, resize strategy, per-stage optimization hyperparameters) and
the same inheritance chains, so every registered id resolves to exactly the
reference's values. The backbone-id strings resolve through models/catalog.py
to JAX configs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .registry import ChoiceRegistry


@dataclass(frozen=True)
class ModelConfig(ChoiceRegistry):
    model_id: str = "prism-dinosiglip-224px+7b"
    arch_specifier: str = "no-align+fused-gelu-mlp"
    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    llm_backbone_id: str = "llama2-7b-pure"
    image_resize_strategy: str = "resize-naive"
    llm_max_length: int = 2048

    # align stage (reference models.py:37-49)
    align_epochs: int = 1
    align_max_steps: Optional[int] = None
    align_global_batch_size: int = 256
    align_per_device_batch_size: int = 16
    align_learning_rate: float = 1e-3
    align_weight_decay: float = 0.0
    align_max_grad_norm: float = 1.0
    align_lr_scheduler_type: str = "linear-warmup+cosine-decay"
    align_warmup_ratio: float = 0.03
    align_train_strategy: str = "fsdp-shard-grad-op"

    # finetune stage (reference models.py:52-66)
    finetune_epochs: int = 1
    finetune_max_steps: Optional[int] = None
    finetune_global_batch_size: int = 128
    finetune_per_device_batch_size: int = 16
    finetune_learning_rate: float = 2e-5
    finetune_weight_decay: float = 0.1
    finetune_max_grad_norm: float = 1.0
    finetune_lr_scheduler_type: str = "linear-warmup+cosine-decay"
    finetune_warmup_ratio: float = 0.03
    finetune_train_strategy: str = "fsdp-full-shard"

    enable_gradient_checkpointing: bool = True
    enable_mixed_precision_training: bool = True
    reduce_in_full_precision: bool = False


# === LLaVa v1.5 Reproductions (reference :77-119) ===

@ModelConfig.register_subclass("reproduction-llava-v15+7b")
@dataclass(frozen=True)
class LLaVa_v15_Reproduction_7B(ModelConfig):
    model_id: str = "reproduction-llava-v15+7b"
    arch_specifier: str = "gelu-mlp"
    vision_backbone_id: str = "clip-vit-l-336px"
    llm_backbone_id: str = "vicuna-v15-7b"
    image_resize_strategy: str = "letterbox"


@ModelConfig.register_subclass("reproduction-llava-v15+13b")
@dataclass(frozen=True)
class LLaVa_v15_Reproduction_13B(LLaVa_v15_Reproduction_7B):
    model_id: str = "reproduction-llava-v15+13b"
    llm_backbone_id: str = "vicuna-v15-13b"


# === Section 4.1 :: Optimization Procedure (reference :126-148) ===

@ModelConfig.register_subclass("one-stage+7b")
@dataclass(frozen=True)
class Exp_7B_One_Stage(LLaVa_v15_Reproduction_7B):
    model_id: str = "one-stage+7b"
    arch_specifier: str = "no-align+gelu-mlp"


@ModelConfig.register_subclass("one-stage+13b")
@dataclass(frozen=True)
class Exp_13B_One_Stage(LLaVa_v15_Reproduction_13B):
    model_id: str = "one-stage+13b"
    arch_specifier: str = "no-align+gelu-mlp"


@ModelConfig.register_subclass("full-ft-multi-stage+7b")
@dataclass(frozen=True)
class Exp_7B_Full_Finetune_Multi_Stage(LLaVa_v15_Reproduction_7B):
    model_id: str = "full-ft-multi-stage+7b"


@ModelConfig.register_subclass("full-ft-one-stage+7b")
@dataclass(frozen=True)
class Exp_7B_Full_Finetune_One_Stage(Exp_7B_One_Stage):
    model_id: str = "full-ft-one-stage+7b"


# === Section 4.2A :: Pretrained Representations (reference :156-175) ===

@ModelConfig.register_subclass("in1k-224px+7b")
@dataclass(frozen=True)
class Exp_7B_IN1K_ViT_L_p16_224px(Exp_7B_One_Stage):
    model_id: str = "in1k-224px+7b"
    vision_backbone_id: str = "in1k-vit-l"


@ModelConfig.register_subclass("dinov2-224px+7b")
@dataclass(frozen=True)
class Exp_7B_DINOv2_ViT_L_p14_224px(Exp_7B_One_Stage):
    model_id: str = "dinov2-224px+7b"
    vision_backbone_id: str = "dinov2-vit-l"


@ModelConfig.register_subclass("clip-224px+7b")
@dataclass(frozen=True)
class Exp_7B_CLIP_ViT_L_p14_224px(Exp_7B_One_Stage):
    model_id: str = "clip-224px+7b"
    vision_backbone_id: str = "clip-vit-l"


@ModelConfig.register_subclass("siglip-224px+7b")
@dataclass(frozen=True)
class Exp_7B_SigLIP_ViT_SO_p14_224px(Exp_7B_One_Stage):
    model_id: str = "siglip-224px+7b"
    vision_backbone_id: str = "siglip-vit-so400m"


# === Section 4.2B :: Image Preprocessing (reference :181-208) ===

@ModelConfig.register_subclass("clip-336px-resize-crop+7b")
@dataclass(frozen=True)
class Exp_7B_CLIP_ViT_L_p14_336px_Resize_Crop(Exp_7B_One_Stage):
    model_id: str = "clip-336px-resize-crop+7b"
    image_resize_strategy: str = "resize-crop"


@ModelConfig.register_subclass("clip-336px-resize-naive+7b")
@dataclass(frozen=True)
class Exp_7B_CLIP_ViT_L_p14_336px_Resize_Naive(Exp_7B_One_Stage):
    model_id: str = "clip-336px-resize-naive+7b"
    image_resize_strategy: str = "resize-naive"


@ModelConfig.register_subclass("siglip-384px-letterbox+7b")
@dataclass(frozen=True)
class Exp_7B_SigLIP_ViT_SO_p14_384px_Letterbox(Exp_7B_One_Stage):
    model_id: str = "siglip-384px-letterbox+7b"
    vision_backbone_id: str = "siglip-vit-so400m-384px"
    image_resize_strategy: str = "letterbox"


@ModelConfig.register_subclass("siglip-384px-resize-crop+7b")
@dataclass(frozen=True)
class Exp_7B_SigLIP_ViT_SO_p14_384px_Resize_Crop(Exp_7B_One_Stage):
    model_id: str = "siglip-384px-resize-crop+7b"
    vision_backbone_id: str = "siglip-vit-so400m-384px"
    image_resize_strategy: str = "resize-crop"


@ModelConfig.register_subclass("siglip-384px-resize-naive+7b")
@dataclass(frozen=True)
class Exp_7B_SigLIP_ViT_SO_p14_384px_Resize_Naive(Exp_7B_One_Stage):
    model_id: str = "siglip-384px-resize-naive+7b"
    vision_backbone_id: str = "siglip-vit-so400m-384px"
    image_resize_strategy: str = "resize-naive"


# === Section 4.2D :: Fused Representations (reference :214-243) ===

@ModelConfig.register_subclass("dinoclip-336px-letterbox+7b")
@dataclass(frozen=True)
class Exp_7B_DINOCLIP_ViT_L_p14_336px_Letterbox(Exp_7B_One_Stage):
    model_id: str = "dinoclip-336px-letterbox+7b"
    vision_backbone_id: str = "dinoclip-vit-l-336px"
    image_resize_strategy: str = "letterbox"
    arch_specifier: str = "no-align+fused-gelu-mlp"


@ModelConfig.register_subclass("dinoclip-336px-resize-naive+7b")
@dataclass(frozen=True)
class Exp_7B_DINOCLIP_ViT_L_p14_336px_Resize_Naive(Exp_7B_One_Stage):
    model_id: str = "dinoclip-336px-resize-naive+7b"
    vision_backbone_id: str = "dinoclip-vit-l-336px"
    image_resize_strategy: str = "resize-naive"
    arch_specifier: str = "no-align+fused-gelu-mlp"


@ModelConfig.register_subclass("dinosiglip-384px-letterbox+7b")
@dataclass(frozen=True)
class Exp_7B_DINOSigLIP_ViT_L_p14_384px_Letterbox(Exp_7B_One_Stage):
    model_id: str = "dinosiglip-384px-letterbox+7b"
    vision_backbone_id: str = "dinosiglip-vit-so-384px"
    image_resize_strategy: str = "letterbox"
    arch_specifier: str = "no-align+fused-gelu-mlp"


@ModelConfig.register_subclass("dinosiglip-384px-resize-naive+7b")
@dataclass(frozen=True)
class Exp_7B_DINOSigLIP_ViT_L_p14_384px_Resize_Naive(Exp_7B_One_Stage):
    model_id: str = "dinosiglip-384px-resize-naive+7b"
    vision_backbone_id: str = "dinosiglip-vit-so-384px"
    image_resize_strategy: str = "resize-naive"
    arch_specifier: str = "no-align+fused-gelu-mlp"


# === Section 4.3 :: Language Models (reference :251-302) ===

@ModelConfig.register_subclass("llama2+7b")
@dataclass(frozen=True)
class Exp_7B_Llama2(Exp_7B_One_Stage):
    model_id: str = "llama2+7b"
    llm_backbone_id: str = "llama2-7b-pure"


@ModelConfig.register_subclass("llama2+13b")
@dataclass(frozen=True)
class Exp_13B_Llama2(Exp_13B_One_Stage):
    model_id: str = "llama2+13b"
    llm_backbone_id: str = "llama2-13b-pure"


@ModelConfig.register_subclass("llama2-chat+7b")
@dataclass(frozen=True)
class Ext_Exp_7B_Llama2_Chat(Exp_7B_One_Stage):
    model_id: str = "llama2-chat+7b"
    llm_backbone_id: str = "llama2-7b-chat"


@ModelConfig.register_subclass("llama2-chat+13b")
@dataclass(frozen=True)
class Ext_Exp_13B_Llama2_Chat(Exp_13B_One_Stage):
    model_id: str = "llama2-chat+13b"
    llm_backbone_id: str = "llama2-13b-chat"


@ModelConfig.register_subclass("mistral-v0.1+7b")
@dataclass(frozen=True)
class Ext_Exp_7B_Mistral_V1(Exp_7B_One_Stage):
    model_id: str = "mistral-v0.1+7b"
    llm_backbone_id: str = "mistral-v0.1-7b-pure"


@ModelConfig.register_subclass("mistral-instruct-v0.1+7b")
@dataclass(frozen=True)
class Ext_Exp_7B_Mistral_Instruct_V1(Exp_7B_One_Stage):
    model_id: str = "mistral-instruct-v0.1+7b"
    llm_backbone_id: str = "mistral-v0.1-7b-instruct"


@ModelConfig.register_subclass("phi-2+3b")
@dataclass(frozen=True)
class Ext_Exp_3B_Phi_2(Exp_7B_One_Stage):
    model_id: str = "phi-2+3b"
    llm_backbone_id: str = "phi-2-3b"


@ModelConfig.register_subclass("vicuna-no-cotraining+7b")
@dataclass(frozen=True)
class Exp_7B_Vicuna_No_Cotraining(Exp_7B_One_Stage):
    model_id: str = "vicuna-no-cotraining+7b"


@ModelConfig.register_subclass("llama2-no-cotraining+7b")
@dataclass(frozen=True)
class Exp_7B_Llama2_No_Cotraining(Exp_7B_One_Stage):
    model_id: str = "llama2-no-cotraining+7b"
    llm_backbone_id: str = "llama2-7b-pure"


# === Section 4.4 :: Scaling Train Time & Data (reference :311-350) ===

@ModelConfig.register_subclass("train-1.25-epochs+7b")
@dataclass(frozen=True)
class Exp_7B_1p25_Epochs(Exp_7B_One_Stage):
    model_id: str = "train-1.25-epochs+7b"
    finetune_max_steps: Optional[int] = 6500


@ModelConfig.register_subclass("train-1.5-epochs+7b")
@dataclass(frozen=True)
class Exp_7B_1p5_Epochs(Exp_7B_One_Stage):
    model_id: str = "train-1.5-epochs+7b"
    finetune_max_steps: Optional[int] = 7800


@ModelConfig.register_subclass("train-2-epochs+7b")
@dataclass(frozen=True)
class Exp_7B_2_Epochs(Exp_7B_One_Stage):
    model_id: str = "train-2-epochs+7b"
    finetune_epochs: int = 2


@ModelConfig.register_subclass("train-3-epochs+7b")
@dataclass(frozen=True)
class Exp_7B_3_Epochs(Exp_7B_One_Stage):
    model_id: str = "train-3-epochs+7b"
    finetune_epochs: int = 3


@ModelConfig.register_subclass("llava-lvis4v+7b")
@dataclass(frozen=True)
class Exp_7B_LLaVa_LVIS4V(Exp_7B_One_Stage):
    model_id: str = "llava-lvis4v+7b"


@ModelConfig.register_subclass("llava-lrv+7b")
@dataclass(frozen=True)
class Exp_7B_LLaVa_LRV(Exp_7B_One_Stage):
    model_id: str = "llava-lrv+7b"


@ModelConfig.register_subclass("llava-lvis4v-lrv+7b")
@dataclass(frozen=True)
class Exp_7B_LLaVa_LVIS4V_LRV(Exp_7B_One_Stage):
    model_id: str = "llava-lvis4v-lrv+7b"


# === Section 5 :: Prisms (reference :358-498) ===

@ModelConfig.register_subclass("prism-clip-controlled+7b")
@dataclass(frozen=True)
class Prism_7B_CLIP_Controlled(Exp_7B_One_Stage):
    model_id: str = "prism-clip-controlled+7b"
    vision_backbone_id: str = "clip-vit-l-336px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-7b-pure"


@ModelConfig.register_subclass("prism-clip-controlled+13b")
@dataclass(frozen=True)
class Prism_13B_CLIP_Controlled(Exp_13B_One_Stage):
    model_id: str = "prism-clip-controlled+13b"
    vision_backbone_id: str = "clip-vit-l-336px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-13b-pure"


@ModelConfig.register_subclass("prism-clip+7b")
@dataclass(frozen=True)
class Prism_7B_CLIP(Exp_7B_One_Stage):
    model_id: str = "prism-clip+7b"
    vision_backbone_id: str = "clip-vit-l-336px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-7b-pure"
    finetune_epochs: int = 2


@ModelConfig.register_subclass("prism-clip+13b")
@dataclass(frozen=True)
class Prism_13B_CLIP(Exp_13B_One_Stage):
    model_id: str = "prism-clip+13b"
    vision_backbone_id: str = "clip-vit-l-336px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-13b-pure"
    finetune_epochs: int = 2


@ModelConfig.register_subclass("prism-siglip-controlled+7b")
@dataclass(frozen=True)
class Prism_7B_SigLIP_Controlled(Exp_7B_One_Stage):
    model_id: str = "prism-siglip-controlled+7b"
    vision_backbone_id: str = "siglip-vit-so400m-384px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-7b-pure"


@ModelConfig.register_subclass("prism-siglip-controlled+13b")
@dataclass(frozen=True)
class Prism_13B_SigLIP_Controlled(Exp_13B_One_Stage):
    model_id: str = "prism-siglip-controlled+13b"
    vision_backbone_id: str = "siglip-vit-so400m-384px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-13b-pure"


@ModelConfig.register_subclass("prism-siglip+7b")
@dataclass(frozen=True)
class Prism_7B_SigLIP(Exp_7B_One_Stage):
    model_id: str = "prism-siglip+7b"
    vision_backbone_id: str = "siglip-vit-so400m-384px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-7b-pure"
    finetune_epochs: int = 2


@ModelConfig.register_subclass("prism-siglip+13b")
@dataclass(frozen=True)
class Prism_13B_SigLIP(Exp_13B_One_Stage):
    # NOTE: vision_backbone_id is clip-vit-l-336px in the reference too
    # (prismatic/conf/models.py:423-427 — an upstream quirk, ported verbatim)
    model_id: str = "prism-siglip+13b"
    vision_backbone_id: str = "clip-vit-l-336px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-13b-pure"
    finetune_epochs: int = 2


@ModelConfig.register_subclass("prism-dinosiglip-controlled+7b")
@dataclass(frozen=True)
class Prism_7B_DINOSigLIP_Controlled(Exp_7B_One_Stage):
    model_id: str = "prism-dinosiglip-controlled+7b"
    vision_backbone_id: str = "dinosiglip-vit-so-384px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-7b-pure"
    arch_specifier: str = "no-align+fused-gelu-mlp"


@ModelConfig.register_subclass("prism-dinosiglip-controlled+13b")
@dataclass(frozen=True)
class Prism_13B_DINOSigLIP_Controlled(Exp_13B_One_Stage):
    model_id: str = "prism-dinosiglip-controlled+13b"
    vision_backbone_id: str = "dinosiglip-vit-so-384px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-13b-pure"
    arch_specifier: str = "no-align+fused-gelu-mlp"


@ModelConfig.register_subclass("prism-dinosiglip+7b")
@dataclass(frozen=True)
class Prism_7B_DINOSigLIP(Exp_7B_One_Stage):
    model_id: str = "prism-dinosiglip+7b"
    vision_backbone_id: str = "dinosiglip-vit-so-384px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-7b-pure"
    arch_specifier: str = "no-align+fused-gelu-mlp"
    finetune_epochs: int = 2


@ModelConfig.register_subclass("prism-dinosiglip+13b")
@dataclass(frozen=True)
class Prism_13B_DINOSigLIP(Exp_13B_One_Stage):
    model_id: str = "prism-dinosiglip+13b"
    vision_backbone_id: str = "dinosiglip-vit-so-384px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-13b-pure"
    arch_specifier: str = "no-align+fused-gelu-mlp"
    finetune_epochs: int = 2


# === Inference-Optimized 224px Prisms (reference :472-498) ===

@ModelConfig.register_subclass("dinosiglip-224px-resize-naive+7b")
@dataclass(frozen=True)
class Opt_7B_DINOSigLIP_ViT_SO_p14_224px_Resize_Naive(Exp_7B_One_Stage):
    model_id: str = "dinosiglip-224px-resize-naive+7b"
    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    image_resize_strategy: str = "resize-naive"
    arch_specifier: str = "no-align+fused-gelu-mlp"


@ModelConfig.register_subclass("prism-dinosiglip-224px-controlled+7b")
@dataclass(frozen=True)
class Prism_7B_DINOSigLIP_224px_Controlled(Exp_7B_One_Stage):
    model_id: str = "prism-dinosiglip-224px-controlled+7b"
    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-7b-pure"
    arch_specifier: str = "no-align+fused-gelu-mlp"


@ModelConfig.register_subclass("prism-dinosiglip-224px+7b")
@dataclass(frozen=True)
class Prism_7B_DINOSigLIP_224px(Exp_7B_One_Stage):
    """The OpenVLA base VLM: DINOv2 + SigLIP @ 224px, Llama-2-7b, fused MLP."""

    model_id: str = "prism-dinosiglip-224px+7b"
    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    image_resize_strategy: str = "resize-naive"
    llm_backbone_id: str = "llama2-7b-pure"
    arch_specifier: str = "no-align+fused-gelu-mlp"
    finetune_epochs: int = 2


# === Convenience alias kept from round 1 (NOT in the reference registry) ===

@ModelConfig.register_subclass("dinosiglip-224px+7b")
@dataclass(frozen=True)
class Exp_DinoSigLIP_224px_7B(ModelConfig):
    model_id: str = "dinosiglip-224px+7b"
    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    llm_backbone_id: str = "vicuna-v15-7b"
