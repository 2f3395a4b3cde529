"""VLM pretraining dataset configurations (align/finetune stage components).

Mirrors prismatic/conf/datasets.py:20-120: each variant names the annotation
JSON + image root for both stages, relative to a dataset root.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .registry import ChoiceRegistry


@dataclass(frozen=True)
class DatasetConfig(ChoiceRegistry):
    dataset_id: str = "llava-v15"
    align_stage_components: Tuple[str, str] = (
        "download/llava-laion-cc-sbu-558k/chat.json",
        "download/llava-laion-cc-sbu-558k/",
    )
    finetune_stage_components: Tuple[str, str] = (
        "download/llava-v1.5-instruct/llava_v1_5_mix665k.json",
        "download/llava-v1.5-instruct/",
    )
    dataset_root_dir: str = "data/prismatic-vlms"


@DatasetConfig.register_subclass("llava-v15")
@dataclass(frozen=True)
class LLaVa_V15_Config(DatasetConfig):
    dataset_id: str = "llava-v15"


@DatasetConfig.register_subclass("llava-multimodal")
@dataclass(frozen=True)
class LLaVa_Multimodal_Only_Config(DatasetConfig):
    dataset_id: str = "llava-multimodal"
    finetune_stage_components: Tuple[str, str] = (
        "download/llava-v1.5-instruct/llava_v1_5_stripped625k.json",
        "download/llava-v1.5-instruct/",
    )


@DatasetConfig.register_subclass("llava-lvis4v")
@dataclass(frozen=True)
class LLaVa_LVIS4V_Config(DatasetConfig):
    dataset_id: str = "llava-lvis4v"
    finetune_stage_components: Tuple[str, str] = (
        "download/llava-v1.5-instruct/llava_v1_5_lvis4v_mix888k.json",
        "download/llava-v1.5-instruct/",
    )


@DatasetConfig.register_subclass("llava-lrv")
@dataclass(frozen=True)
class LLaVa_LRV_Config(DatasetConfig):
    dataset_id: str = "llava-lrv"
    finetune_stage_components: Tuple[str, str] = (
        "download/llava-v1.5-instruct/llava_v1_5_lrv_mix1008k.json",
        "download/llava-v1.5-instruct/",
    )


@DatasetConfig.register_subclass("llava-lvis4v-lrv")
@dataclass(frozen=True)
class LLaVa_LVIS4V_LRV_Config(DatasetConfig):
    dataset_id: str = "llava-lvis4v-lrv"
    finetune_stage_components: Tuple[str, str] = (
        "download/llava-v1.5-instruct/llava_v1_5_lvis4v_lrv_mix1231k.json",
        "download/llava-v1.5-instruct/",
    )
