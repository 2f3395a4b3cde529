"""One-card OpenVLA-7B LoRA finetune throughput: QLoRA over a quantized frozen
base (counterpart of the JAX package's ``scripts/bench_finetune.py``).

    python -m openvla_probe_tpu_torch.tools.bench_finetune
        [--quant int4|int8] [--scale full|tiny] [--batch 8] [--steps 10]
        [--rank 32] [--seq 64] [--device cuda]

The JAX script's knobs as flags (its FT_QUANT, FT_SCALE, FT_BATCH, FT_STEPS,
FT_RANK, FT_SEQ), at its defaults but the base: streamed LoRA
(r = 32, alpha 16) on every linear of the towers, projector and trunk; AdamW
at a constant 5e-4 with no weight decay; remat on the trunk and the towers;
B = 8 synthetic RLDS-shaped rows of 64 text tokens (BOS, random ids, 7 action
labels and the stop token; pixels N(0, 1)), so 1 + 256 + 63 = 320 tokens.
The base, random from a seeded generator on the card:

* ``int4`` (default here): the true 4-bit QLoRA base, ``quantize_params(bits=4)``
  over the trunk and lm_head (group 128), the towers and projector bf16; the
  kernel route (the JAX package's ``OVLA_PALLAS=1``, ``OVLA_PALLAS_ATTN=0``):
  every trunk linear runs ``w4a8_matmul`` forward (and again in the remat
  recompute) and ``w4a8_dx`` backward; lm_head (N = 32064, no 128 tile) the
  requant route into ``w8a8_matmul``;
* ``int8`` (the JAX script's default; all ``OVLA_*`` unset): per-channel int8,
  every trunk linear on ``w8a8_matmul`` with its STE, the fused norm off.

Attention takes the plain branch (the kernels have no backward). Prints one
JSON line, the JAX script's fields with ``backend: "cuda"``; ``compile_s`` is
the first step's time, the kernels' build included.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import convert
from ..device import DeviceLike, resolve_device
from ..models import vlm
from ..ops.linear import _DEFAULT_QUANT_SUFFIXES
from ..training.lora import LoRAConfig, init_lora_params, make_lora_loss_fn
from ..training.train_state import OptimizerConfig, TrainState, make_optimizer, tree_leaves
from ..training.train_step import make_train_step, vla_loss_fn
from ..vla.action_tokenizer import ActionCodec

QUANTS = {"int4": 4, "int8": 8}


def train_config(cfg: vlm.VLMConfig, quant: str) -> vlm.VLMConfig:
    """`cfg` as the trainer runs it: remat everywhere, the plain attention,
    the fused norm off, and the int8 route of the base (int4: "wi8", the
    w4a8 kernel gate; int8: "w8a8", the STE route of int8 leaves)."""
    route = "wi8" if quant == "int4" else "w8a8"
    return dataclasses.replace(
        cfg,
        llm=dataclasses.replace(cfg.llm, remat=True, flash_attn=False, fused_rmsq=False,
                                int8_matmul=route),
        vision=tuple(dataclasses.replace(v, remat=True, flash_attn=False, int8_matmul=route)
                     for v in cfg.vision))


def base_params(cfg: vlm.VLMConfig, quant: str, generator: torch.Generator,
                device: DeviceLike) -> Dict[str, Any]:
    """Random frozen weights on `device` (`generator` lives there): the trunk
    and lm_head quantized per `quant`, the towers and projector bf16 (the JAX
    script's default FT_QUANT_VIT=0)."""
    return convert.init_params(cfg, generator, device=device, bits=QUANTS[quant],
                               quant_suffixes=_DEFAULT_QUANT_SUFFIXES)


def synthetic_batch(cfg: vlm.VLMConfig, batch: int, seq: int, seed: int,
                    device: DeviceLike) -> Dict[str, torch.Tensor]:
    """The JAX script's synthetic rows (numpy, seeded): BOS then ids in
    [2, min(V, 32000)), labels IGNORE but for the 7 action tokens and the stop
    token before the last position (ids from the top 256 of the vocab),
    pixels N(0, 1) for both towers in the trunk's dtype."""
    rng = np.random.default_rng(seed)
    V = cfg.llm.vocab_size
    S = cfg.vision[0].image_size
    ids = rng.integers(2, min(V, 32000), (batch, seq)).astype(np.int64)
    ids[:, 0] = 1
    labels = np.full((batch, seq), -100, np.int64)
    labels[:, -9:-1] = rng.integers(V - 256, V, (batch, 8))
    pixels = rng.normal(size=(batch, 3 * len(cfg.vision), S, S)).astype(np.float32)
    dev = resolve_device(device)
    return {"input_ids": torch.from_numpy(ids).to(dev),
            "attention_mask": torch.ones((batch, seq), dtype=torch.int64, device=dev),
            "pixel_values": torch.from_numpy(pixels).to(dev, cfg.llm.dtype),
            "labels": torch.from_numpy(labels).to(dev)}


def tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


class Finetune:
    """Streamed-LoRA training of `base` (frozen) on one fixed `batch`: the
    LoRA tree (made from `seed` on the batch's device unless `lora` is given),
    AdamW at a constant `lr` without weight decay, ``make_train_step``."""

    def __init__(self, cfg: vlm.VLMConfig, base: Dict[str, Any], batch: Dict[str, torch.Tensor],
                 rank: int = 32, lr: float = 5e-4, max_steps: int = 10, seed: int = 1,
                 lora: Optional[Any] = None):
        dev = batch["input_ids"].device
        self.cfg, self.base, self.batch = cfg, base, batch
        self.lcfg = LoRAConfig(r=rank)
        self.codec = ActionCodec(vocab_size=min(cfg.llm.vocab_size, 32000))
        if lora is None:
            lora = init_lora_params(base, self.lcfg, torch.Generator(device=dev).manual_seed(seed))
        self.optimizer = make_optimizer(
            OptimizerConfig(learning_rate=lr, lr_schedule_type="constant",
                            max_steps=max(max_steps, 2), weight_decay=0.0), lora)
        self.state = TrainState.create(lora, self.optimizer)
        self.loss_fn = make_lora_loss_fn(functools.partial(vla_loss_fn, codec=self.codec), base,
                                         self.lcfg, stream=True)
        self.step_fn = make_train_step(cfg, self.optimizer, self.codec, loss_fn=self.loss_fn)

    def step(self) -> Dict[str, Any]:
        self.state, metrics = self.step_fn(self.state, self.batch)
        return metrics


def build(scale: str = "full", quant: str = "int4", batch: int = 8, seq: int = 64,
          rank: int = 32, steps: int = 10, device: DeviceLike = "cuda",
          seed: int = 0) -> Finetune:
    """The JAX script's setting: OpenVLA-7B (``full``) or ``VLMConfig.tiny()``
    with at most 16 text tokens (``tiny``), its base, batch and adapters."""
    dev = resolve_device(device)
    cfg = train_config(vlm.VLMConfig.tiny() if scale == "tiny" else vlm.VLMConfig.openvla_7b(),
                       quant)
    seq = min(seq, 16) if scale == "tiny" else seq
    base = base_params(cfg, quant, torch.Generator(device=dev).manual_seed(seed), dev)
    return Finetune(cfg, base, synthetic_batch(cfg, batch, seq, seed, dev), rank=rank,
                    max_steps=steps, seed=seed + 1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant", choices=tuple(QUANTS), default="int4")
    ap.add_argument("--scale", choices=("full", "tiny"), default="full")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ft = build(args.scale, args.quant, args.batch, args.seq, args.rank, args.steps, args.device)
    dev = ft.batch["input_ids"].device
    t0 = time.perf_counter()
    ft.step()
    _sync(dev)
    first_s = time.perf_counter() - t0
    for _ in range(2):
        ft.step()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = ft.step()
    final_loss = float(metrics["loss"])
    dt = (time.perf_counter() - t0) / args.steps
    T = ft.batch["input_ids"].shape[1]
    seq = 1 + ft.cfg.num_patches + T - 1
    n_llm = {"full": 6.74e9}.get(args.scale, 1e6)
    flops = 3 * 2 * n_llm * seq * args.batch   # forward + 2x backward (remat not counted)
    print(json.dumps({
        "metric": "7B LoRA finetune examples/sec/chip",
        "value": round(args.batch / dt, 3),
        "unit": "examples/s",
        "step_ms": round(dt * 1e3, 1),
        "batch": args.batch,
        "rank": args.rank,
        "seq": int(seq),
        "base_quant": args.quant,
        "loss": round(final_loss, 4),
        "approx_tflops": round(flops / dt / 1e12, 1),
        "compile_s": round(first_s, 1),
        "backend": dev.type,
    }))


if __name__ == "__main__":
    main()
