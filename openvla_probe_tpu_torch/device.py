"""Device resolution for the port's entry points: the card unless asked otherwise."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and absent.

    The port never continues quietly on the CPU: a caller that wants the CPU
    (the plain PyTorch versions of every kernel) passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU")
    return dev
