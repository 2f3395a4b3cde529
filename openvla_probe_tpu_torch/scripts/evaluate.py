"""Evaluate a VLM checkpoint on a closed-set or open-ended JSONL benchmark.

Counterpart of the JAX package's ``scripts/evaluate.py`` (the in-tree harness
over candidate scoring + greedy generation, prismatic/models/vlms/
prismatic.py:520-621), on the card. Images are PNG or .npy files
(utils/image_io.read_image).

Dataset format (one JSON object per line):
  {"question": "...", "choices": ["...", ...], "answer_idx": 0,
   "image": "relative/or/abs.png"}            # closed-set
  {"question": "...", "answers": ["...", ...], "image": "..."}  # open-ended

    python -m openvla_probe_tpu_torch.scripts.evaluate --checkpoint <hf_dir> \\
        --dataset eval.jsonl --task closed --output metrics.json [--device cpu]
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from ..overwatch import initialize_overwatch
from . import _cli

overwatch = initialize_overwatch(__name__)


@dataclass(frozen=True)
class EvalConfig:
    checkpoint: str = ""                 # local HF-layout checkpoint dir
    dataset: str = ""                    # JSONL eval file
    task: str = "closed"                 # closed | open
    output: Optional[str] = None         # metrics JSON out (default: stdout)
    image_root: Optional[str] = None     # base dir for relative image paths
    max_examples: Optional[int] = None
    max_new_tokens: int = 32
    metric: str = "vqa"                  # open-ended grading: vqa | exact
    length_normalize: bool = False       # closed-set: mean (vs sum) logprob
    prompt_style: str = "pure"           # prompting style registered in models/prompting.py
    device: str = "cuda"                 # "cpu" runs the plain versions


def main(cfg: EvalConfig) -> None:
    import functools

    from ..eval import evaluate_closed_set, evaluate_open_ended, load_jsonl_dataset
    from ..models.load import load
    from ..models.prompting import PromptBuilder
    from ..utils.image_io import read_image

    assert cfg.checkpoint and cfg.dataset, "--checkpoint and --dataset are required"
    dev = _cli.ready_device(cfg.device)
    bundle = load(cfg.checkpoint, device=dev)
    examples = load_jsonl_dataset(cfg.dataset, cfg.image_root, cfg.max_examples,
                                  image_loader=read_image)
    overwatch.info(f"Loaded {len(examples)} examples from {cfg.dataset}")

    builder = functools.partial(PromptBuilder, cfg.prompt_style)
    common = dict(
        params=bundle["params"], cfg=bundle["cfg"], tokenizer=bundle["tokenizer"],
        examples=examples, image_cfg=bundle["image_cfg"],
        prompt_builder_factory=builder, device=dev,
    )
    if cfg.task == "closed":
        report = evaluate_closed_set(length_normalize=cfg.length_normalize, **common)
    elif cfg.task == "open":
        report = evaluate_open_ended(
            max_new_tokens=cfg.max_new_tokens, metric=cfg.metric, **common)
    else:
        raise ValueError(f"unknown task {cfg.task!r} (closed | open)")

    report["checkpoint"] = cfg.checkpoint
    report["dataset"] = cfg.dataset
    overwatch.info(f"{cfg.task} accuracy: {report['accuracy']:.4f} over {report['n']}")
    text = json.dumps(report, indent=2)
    if cfg.output:
        Path(cfg.output).write_text(text)
        overwatch.info(f"Wrote {cfg.output}")
    else:
        print(text)


if __name__ == "__main__":
    main(_cli.parse(EvalConfig, __doc__))
