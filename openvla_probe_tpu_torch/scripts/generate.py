"""Interactive REPL for base-VLM generation (image + chat prompt) on the card.

Counterpart of the JAX package's ``scripts/generate.py`` (the reference's
scripts/generate.py:52-133): load a checkpoint, read an image file (PNG or
.npy) and chat turns from stdin, generate greedily (or sample).

    python -m openvla_probe_tpu_torch.scripts.generate --model_path <dir> \\
        --image frame.png [--device cpu]
"""

from __future__ import annotations

from dataclasses import dataclass

from . import _cli


@dataclass(frozen=True)
class GenerateConfig:
    model_path: str = "prism-dinosiglip-224px+7b"
    max_new_tokens: int = 128
    image: str = ""                       # local image path (PNG or .npy)
    # reference REPL sampling flags (scripts/generate.py:44-45)
    do_sample: bool = False
    temperature: float = 1.0
    seed: int = 0
    device: str = "cuda"                  # "cpu" runs the plain versions


def main(cfg: GenerateConfig) -> None:
    import torch

    from ..models import generate as gen
    from ..models.load import load
    from ..ops.image import apply_image_transform
    from ..utils.image_io import read_image

    dev = _cli.ready_device(cfg.device)
    bundle = load(cfg.model_path, device=dev)
    tokenizer = bundle["tokenizer"]
    if tokenizer is None:
        raise ValueError(f"{cfg.model_path} holds no tokenizer.json")
    prompt_cls = bundle["prompt_builder"]

    assert cfg.image, "--image <path> is required"
    image = read_image(cfg.image)
    pixels = apply_image_transform(torch.as_tensor(image, device=dev), bundle["image_cfg"])[None]

    print("|=> Enter prompts (ctrl-D to exit)")
    builder = prompt_cls()
    try:
        while True:
            msg = input("|=> Enter Prompt: ")
            prompt_text = builder.get_potential_prompt(msg)
            ids = tokenizer.encode(prompt_text)
            text = gen.generate_text(
                bundle["params"], bundle["cfg"], tokenizer, ids,
                pixel_values=pixels, max_new_tokens=cfg.max_new_tokens,
                do_sample=cfg.do_sample, temperature=cfg.temperature,
                seed=cfg.seed, device=dev,
            )
            builder.add_turn("human", msg)
            builder.add_turn("gpt", text)
            print(f"|=> {text}")
    except EOFError:
        print()


if __name__ == "__main__":
    main(_cli.parse(GenerateConfig, __doc__))
