"""Serve an OpenVLA checkpoint over REST (`POST /act`) on the card.

Counterpart of the JAX package's ``scripts/deploy.py`` (the reference's
vla-scripts/deploy.py:66-145 on the stdlib server): json-numpy payload
{image, instruction, unnorm_key?, adapter?} -> 7-DoF action; ``GET /stats``.

    python -m openvla_probe_tpu_torch.scripts.deploy --openvla_path <hf_dir> \\
        [--quantize_int8 true [--quantize_bits 8|4|mix|nibble]] \\
        [--dynamic_batching true] [--adapters name=run_dir,...] [--device cpu]
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from ..overwatch import initialize_overwatch
from . import _cli

overwatch = initialize_overwatch(__name__)


@dataclass(frozen=True)
class DeployConfig:
    openvla_path: str = "openvla-7b"       # local HF-layout checkpoint dir
    host: str = "0.0.0.0"
    port: int = 8000
    quantize_int8: bool = False            # turbo serving mode (non-bit-parity)
    quantize_bits: str = "8"               # 8 | 4 (grouped int4, half the
                                           # stream) | mix (int8 prefill +
                                           # int4 decode) | nibble
    prompt_pad_len: int = 48
    dynamic_batching: bool = False         # micro-batch concurrent requests
    max_batch: int = 24
    max_wait_ms: float = 8.0
    # multi-LoRA serving (models/multilora.py): comma list "name=adapter_dir"
    # of finetune run dirs (the port trainer's checkpoints). All named adapters
    # stay resident over the ONE (quantized) base; a request picks its adapter
    # via the payload's "adapter" field, and mixed-adapter requests
    # micro-batch together.
    adapters: str = ""
    # concat-fused adapter install: A banks quantize onto the base weight
    # rows; every request rides the fused graph. int8/bf16 bases only.
    fused_adapters: bool = False
    device: str = "cuda"                   # "cpu" runs the plain versions


def main(cfg: DeployConfig) -> None:
    from ..models.load import load_vla
    from ..serving.server import OpenVLAServer

    dev = _cli.ready_device(cfg.device)
    overwatch.info(f"Loading OpenVLA from {cfg.openvla_path}")
    model = load_vla(
        cfg.openvla_path, prompt_pad_len=cfg.prompt_pad_len,
        quantize_int8=cfg.quantize_int8,
        quantize_bits=(int(cfg.quantize_bits) if str(cfg.quantize_bits).isdigit()
                       else cfg.quantize_bits),
        device=dev,
    )
    if cfg.adapters:
        from ..models import multilora

        pairs = [s.split("=", 1) for s in cfg.adapters.split(",") if s]
        if not all(len(p) == 2 for p in pairs):
            raise ValueError("--adapters must be a comma list of name=dir pairs")
        trees = {name: multilora.load_adapter_checkpoint(d) for name, d in pairs}
        lcfg = multilora.infer_lora_config(next(iter(trees.values())))
        model.set_adapters(trees, lcfg, fused=cfg.fused_adapters)
        overwatch.info(
            f"Installed {len(trees)} LoRA adapters over the shared base "
            f"(r={lcfg.r}{', fused' if cfg.fused_adapters else ''}): {list(trees)}")
    server = OpenVLAServer(
        model, base_vlm=Path(cfg.openvla_path).name,
        dynamic_batching=cfg.dynamic_batching,
        max_batch=cfg.max_batch, max_wait_ms=cfg.max_wait_ms,
    )
    overwatch.info(f"Serving POST /act on {cfg.host}:{cfg.port}")
    server.run(cfg.host, cfg.port)


if __name__ == "__main__":
    main(_cli.parse(DeployConfig, __doc__))
