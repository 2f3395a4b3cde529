"""Export a trainer checkpoint of the port to the HF-layout safetensors format.

Counterpart of the JAX package's ``scripts/convert_weights_to_hf.py`` (the
reference's vla-scripts/extern/convert_openvla_weights_to_hf.py): the latest
checkpoint of a port run dir (``training/checkpointing.py``: a TrainState,
``{"params": ...}`` or a bare tree) -> model.safetensors + config.json and
every sidecar, loadable by ``models.load`` here or by the HF AutoClasses of
the reference ecosystem. A checkpoint whose Llama trunk is shallower than the
backbone id's is exported at its own depth (``text_config.num_hidden_layers``).
Runs on the host: no ``--device``.

    python -m openvla_probe_tpu_torch.scripts.convert_weights_to_hf \\
        --run_dir <run> --output_dir hf-export [--tokenizer_path <dir>]
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..overwatch import initialize_overwatch
from . import _cli

overwatch = initialize_overwatch(__name__)


@dataclass(frozen=True)
class HFConvertConfig:
    run_dir: str = ""                       # the port trainer's run dir
    output_dir: str = "hf-export"
    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    llm_backbone_id: str = "llama2-7b-pure"
    arch_specifier: str = "no-align+fused-gelu-mlp"
    image_resize_strategy: str = "resize-naive"
    # local dir holding the base LLM tokenizer files (tokenizer.json /
    # tokenizer.model + configs), copied into the export (the reference
    # converter re-saves the HF tokenizer, convert_openvla_weights_to_hf.py:243-245)
    tokenizer_path: Optional[str] = None


def main(cfg: HFConvertConfig) -> None:
    from ..models import catalog
    from ..models.hf_export import write_export_sidecars
    from ..models.safetensors_io import save_file
    from ..training import checkpointing as ckpt

    assert cfg.run_dir, "--run_dir is required"
    model_cfg, img_cfg, _ = catalog.build_vlm_config(
        cfg.vision_backbone_id, cfg.llm_backbone_id, cfg.arch_specifier,
        cfg.image_resize_strategy,
    )
    path = ckpt.latest_checkpoint(cfg.run_dir)
    assert path is not None, f"No checkpoint under {cfg.run_dir}"
    overwatch.info(f"Converting {path}")
    # the bare param tree (a TrainState and {params: ...} load as dicts)
    restored = ckpt.load_checkpoint(path, None)
    params = restored.get("params", restored) if isinstance(restored, dict) else restored.params
    depth = int(next(iter(params["llm"]["layers"].values())).shape[0])
    if depth != model_cfg.llm.num_hidden_layers:
        overwatch.info(f"The checkpoint's trunk has {depth} layers "
                       f"({cfg.llm_backbone_id}: {model_cfg.llm.num_hidden_layers})")
        model_cfg = dataclasses.replace(
            model_cfg, llm=dataclasses.replace(model_cfg.llm, num_hidden_layers=depth))

    state = catalog.params_to_hf_state(params, model_cfg)
    out = Path(cfg.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_file(state, out / "model.safetensors")

    # every non-weight file of a reference-complete HF dir: the OpenVLAConfig
    # config.json, preprocessor / processor configs, tokenizer files and
    # dataset_statistics.json
    norm_stats = None
    stats_path = Path(cfg.run_dir) / "dataset_statistics.json"
    if stats_path.exists():
        norm_stats = json.loads(stats_path.read_text())
    result = write_export_sidecars(
        out, model_cfg, img_cfg,
        cfg.vision_backbone_id, cfg.llm_backbone_id, cfg.arch_specifier,
        cfg.image_resize_strategy, norm_stats=norm_stats,
        tokenizer_src=Path(cfg.tokenizer_path) if cfg.tokenizer_path else None)
    if not result["copied_tokenizer_files"]:
        overwatch.warning(
            "No tokenizer files copied (pass --tokenizer_path to a local "
            "Llama tokenizer dir); wrote contract-only tokenizer_config.json "
            "— AutoProcessor loading needs the real tokenizer data")
    overwatch.info(f"Wrote HF export to {out}")


if __name__ == "__main__":
    main(_cli.parse(HFConvertConfig, __doc__))
