"""VLA training configurations + experiment registry.

Mirrors the reference's VLAConfig choice system (prismatic/conf/vla.py:20-235):
the same field surface (vla_id, base_vlm, freeze flags, data mixture,
optimization + strategy parameters) and the named experiment variants used by
the released OpenVLA runs. `train_strategy` values map onto the TPU mesh
strategies (fsdp-full-shard -> fsdp; + tp for >1-chip models).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .registry import ChoiceRegistry


@dataclass(frozen=True)
class VLAConfig(ChoiceRegistry):
    vla_id: str = "prism-dinosiglip-224px+mx-bridge"
    base_vlm: str = "prism-dinosiglip-224px+7b"
    freeze_vision_backbone: bool = False
    freeze_llm_backbone: bool = False
    unfreeze_last_llm_layer: bool = False

    # data mixture
    data_mix: str = "bridge"
    shuffle_buffer_size: int = 256_000

    # optimization
    epochs: int = 1000
    max_steps: Optional[int] = None
    expected_world_size: int = 8
    global_batch_size: int = 256
    per_device_batch_size: int = 32
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "constant"
    warmup_ratio: float = 0.0
    train_strategy: str = "fsdp-full-shard"

    enable_gradient_checkpointing: bool = True
    enable_mixed_precision_training: bool = True
    reduce_in_full_precision: bool = True
    image_aug: bool = False


@VLAConfig.register_subclass("siglip-224px+mx-bridge")
@dataclass(frozen=True)
class Exp_SigLIP_224px_Bridge(VLAConfig):
    vla_id: str = "siglip-224px+mx-bridge"
    base_vlm: str = "siglip-224px+7b"


@VLAConfig.register_subclass("siglip-224px-icy+mx-bridge")
@dataclass(frozen=True)
class Exp_FreezeVIT_SigLIP_224px_Bridge(Exp_SigLIP_224px_Bridge):
    vla_id: str = "siglip-224px-icy+mx-bridge"
    freeze_vision_backbone: bool = True


@VLAConfig.register_subclass("prism-dinosiglip-224px+mx-bridge")
@dataclass(frozen=True)
class Exp_DinoSigLIP_224px_Bridge(VLAConfig):
    vla_id: str = "prism-dinosiglip-224px+mx-bridge"
    base_vlm: str = "prism-dinosiglip-224px+7b"


@VLAConfig.register_subclass("siglip-224px+mx-oxe-magic-soup")
@dataclass(frozen=True)
class Exp_SigLIP_224px_OXE_Magic_Soup(VLAConfig):
    vla_id: str = "siglip-224px+mx-oxe-magic-soup"
    base_vlm: str = "siglip-224px+7b"
    data_mix: str = "oxe_magic_soup"
    expected_world_size: int = 64
    global_batch_size: int = 2048
    per_device_batch_size: int = 32


@VLAConfig.register_subclass("prism-dinosiglip-224px+mx-oxe-magic-soup-plus")
@dataclass(frozen=True)
class Exp_DinoSigLIP_224px_OXE_Magic_Soup_Plus(VLAConfig):
    """The released openvla-7b training configuration."""

    vla_id: str = "prism-dinosiglip-224px+mx-oxe-magic-soup-plus"
    base_vlm: str = "prism-dinosiglip-224px+7b"
    data_mix: str = "oxe_magic_soup_plus_minus"
    expected_world_size: int = 64
    global_batch_size: int = 2048
    per_device_batch_size: int = 32
    image_aug: bool = True
    shuffle_buffer_size: int = 250_000


# === TDROID fine-tuning configs (reference conf/vla.py:144-190) ===

@VLAConfig.register_subclass("siglip-224px+mx-tdroid_carrot_in_bowl")
@dataclass(frozen=True)
class Exp_SigLIP_224px_TDROID_CarrotInBowl(Exp_SigLIP_224px_Bridge):
    vla_id: str = "siglip-224px+mx-tdroid_carrot_in_bowl"
    base_vlm: str = "siglip-224px+7b"
    data_mix: str = "tdroid_carrot_in_bowl"


@VLAConfig.register_subclass("siglip-224px+mx-tdroid_pour_corn_in_pot")
@dataclass(frozen=True)
class Exp_SigLIP_224px_TDROID_PourCornInPot(Exp_SigLIP_224px_Bridge):
    vla_id: str = "siglip-224px+mx-tdroid_pour_corn_in_pot"
    base_vlm: str = "siglip-224px+7b"
    data_mix: str = "tdroid_pour_corn_in_pot"


@VLAConfig.register_subclass("siglip-224px-icy+mx-tdroid_carrot_in_bowl")
@dataclass(frozen=True)
class Exp_SigLIP_224px_Icy_TDROID_CarrotInBowl(Exp_SigLIP_224px_Bridge):
    vla_id: str = "siglip-224px-icy+mx-tdroid_carrot_in_bowl"
    base_vlm: str = "siglip-224px+7b"
    freeze_vision_backbone: bool = True
    freeze_llm_backbone: bool = False
    data_mix: str = "tdroid_carrot_in_bowl"


@VLAConfig.register_subclass("siglip-224px-last_layer+mx-tdroid_carrot_in_bowl")
@dataclass(frozen=True)
class Exp_SigLIP_224px_LastLayer_TDROID_CarrotInBowl(Exp_SigLIP_224px_Bridge):
    vla_id: str = "siglip-224px-last_layer+mx-tdroid_carrot_in_bowl"
    base_vlm: str = "siglip-224px+7b"
    freeze_vision_backbone: bool = True
    freeze_llm_backbone: bool = True
    unfreeze_last_llm_layer: bool = True
    data_mix: str = "tdroid_carrot_in_bowl"


@VLAConfig.register_subclass("siglip-224px-sandwich+mx-tdroid_carrot_in_bowl")
@dataclass(frozen=True)
class Exp_SigLIP_224px_Sandwich_TDROID_CarrotInBowl(Exp_SigLIP_224px_Bridge):
    vla_id: str = "siglip-224px-sandwich+mx-tdroid_carrot_in_bowl"
    base_vlm: str = "siglip-224px+7b"
    freeze_vision_backbone: bool = False
    freeze_llm_backbone: bool = True
    unfreeze_last_llm_layer: bool = True
    data_mix: str = "tdroid_carrot_in_bowl"


# === DROID fine-tuning configs (reference conf/vla.py:193-199) ===

@VLAConfig.register_subclass("siglip-224px+mx-droid_wipe")
@dataclass(frozen=True)
class Exp_SigLIP_224px_Droid_Wipe(Exp_SigLIP_224px_Bridge):
    vla_id: str = "siglip-224px+mx-droid_wipe"
    base_vlm: str = "siglip-224px+7b"
    data_mix: str = "droid_wipe"


@VLAConfig.register_subclass("prism-qwen25-dinosiglip-224px+0_5b+mx-bridge")
@dataclass(frozen=True)
class Exp_DinoSigLIP_224px_Bridge_Qwen(VLAConfig):
    vla_id: str = "prism-qwen25-dinosiglip-224px+0_5b+mx-bridge"
    base_vlm: str = "prism-qwen25-extra-dinosiglip-224px+0_5b"
    expected_world_size: int = 8


@VLAConfig.register_subclass("prism-dinosiglip-224px+mx-libero-spatial")
@dataclass(frozen=True)
class Exp_DinoSigLIP_224px_LIBERO_Spatial(VLAConfig):
    vla_id: str = "prism-dinosiglip-224px+mx-libero-spatial"
    data_mix: str = "libero_spatial_no_noops"
    expected_world_size: int = 8
    image_aug: bool = True


@VLAConfig.register_subclass("prism-dinosiglip-224px+mx-libero-object")
@dataclass(frozen=True)
class Exp_DinoSigLIP_224px_LIBERO_Object(VLAConfig):
    vla_id: str = "prism-dinosiglip-224px+mx-libero-object"
    data_mix: str = "libero_object_no_noops"
    expected_world_size: int = 8
    image_aug: bool = True


@VLAConfig.register_subclass("prism-dinosiglip-224px+mx-libero-goal")
@dataclass(frozen=True)
class Exp_DinoSigLIP_224px_LIBERO_Goal(VLAConfig):
    vla_id: str = "prism-dinosiglip-224px+mx-libero-goal"
    data_mix: str = "libero_goal_no_noops"
    expected_world_size: int = 8
    image_aug: bool = True


@VLAConfig.register_subclass("prism-dinosiglip-224px+mx-libero-10")
@dataclass(frozen=True)
class Exp_DinoSigLIP_224px_LIBERO_10(VLAConfig):
    vla_id: str = "prism-dinosiglip-224px+mx-libero-10"
    data_mix: str = "libero_10_no_noops"
    expected_world_size: int = 8
    image_aug: bool = True
