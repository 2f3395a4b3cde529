"""OpenVLA-specific eval helpers: train-matched preprocessing and the action
query (the port's copy of ``openvla_probe_tpu/robot/openvla_utils.py``).

`get_vla_action(..., return_embeddings=True)` costs one prefill: the
reference runs a second full forward just for hidden-state capture.
`crop_and_resize` is TensorFlow's ``tf.image.crop_and_resize`` (bilinear, one
centered box) written in PyTorch. Loading (`get_vla`, `get_processor`) waits
for ``models/load.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.vla import OpenVLA

# constants matching the reference
OPENVLA_IMAGE_SIZE = 224

_LOAD = "loading a checkpoint (models/load.py) is ROADMAP Queue 1 item 12"


def get_vla(cfg: Any) -> OpenVLA:
    """Load the serving model from cfg.pretrained_checkpoint: not ported."""
    raise NotImplementedError(_LOAD)


def get_processor(cfg: Any):
    """The fused model owns preprocessing; loading is not ported."""
    raise NotImplementedError(_LOAD)


def _crop_and_resize_bilinear(img: torch.Tensor, box: torch.Tensor, out_hw) -> torch.Tensor:
    """tf.image.crop_and_resize's bilinear sampling, one box [y1, x1, y2, x2]
    (normalized, fp32) for every image of img [N, H, W, C] fp32, in the
    kernel's fp32 order of operations; samples outside the image are 0."""
    _, H, W, _ = img.shape
    ch, cw = out_hw
    y1, x1, y2, x2 = box.unbind()

    def axis(lo, hi, size, n):
        i = torch.arange(n, dtype=torch.float32)
        if n > 1:
            src = lo * (size - 1) + i * ((hi - lo) * (size - 1) / (n - 1))
        else:
            src = (0.5 * (lo + hi) * (size - 1)).expand(n)
        inside = (src >= 0) & (src <= size - 1)
        low = torch.floor(src)
        frac = src - low
        lo_i = low.long().clamp(0, size - 1)
        hi_i = torch.ceil(src).long().clamp(0, size - 1)
        return lo_i, hi_i, frac, inside

    top, bot, y_lerp, y_in = axis(y1, y2, H, ch)
    left, right, x_lerp, x_in = axis(x1, x2, W, cw)
    x_lerp = x_lerp[None, None, :, None]
    rows_t, rows_b = img[:, top], img[:, bot]                      # [N, ch, W, C]
    t = rows_t[:, :, left] + (rows_t[:, :, right] - rows_t[:, :, left]) * x_lerp
    b = rows_b[:, :, left] + (rows_b[:, :, right] - rows_b[:, :, left]) * x_lerp
    out = t + (b - t) * y_lerp[None, :, None, None]
    inside = (y_in[:, None] & x_in[None, :])[None, :, :, None]
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype))


def crop_and_resize(image: np.ndarray, crop_scale: float, batch_size: int = 1) -> np.ndarray:
    """Center crop to `crop_scale` of the AREA, then resize back to 224 x 224:
    the train-time random-crop augmentation, undone at eval.

    image: float32 [..., H, W, 3] in [0, 1]."""
    img = torch.as_tensor(np.array(image, np.float32))
    expanded = img.ndim == 3
    if expanded:
        img = img[None]
    side = torch.sqrt(torch.tensor(crop_scale, dtype=torch.float32))
    y0 = (1.0 - side) / 2.0
    box = torch.stack([y0, y0, y0 + side, y0 + side])
    out = _crop_and_resize_bilinear(img, box, (OPENVLA_IMAGE_SIZE, OPENVLA_IMAGE_SIZE)).numpy()
    return out[0] if expanded else out


def center_crop_image_u8(image: np.ndarray, crop_scale: float = 0.9) -> np.ndarray:
    """uint8 convenience wrapper around crop_and_resize."""
    out = crop_and_resize(image.astype(np.float32) / 255.0, crop_scale)
    return np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)


def pool_tokens(hidden: np.ndarray, mode: str = "mean") -> np.ndarray:
    """[T, D] -> [D] (the fused path already pools on the device; this exists
    for external feature streams)."""
    if mode == "mean":
        return np.asarray(hidden).mean(axis=-2)
    if mode == "final":
        return np.asarray(hidden)[..., -1, :]
    raise ValueError(f"Unknown pooling mode {mode}")


class SpeculativeActionState:
    """Per-episode draft state for verified speculative serving: the previous
    control step's action tokens are the draft for the next step (robot
    actions change slowly, so acceptance is high and decode collapses toward
    a single prefill). Reset at episode boundaries."""

    def __init__(self) -> None:
        self.last_tokens: Optional[np.ndarray] = None
        self.accepted_total = 0
        self.steps = 0

    def reset(self) -> None:
        self.last_tokens = None

    def observe(self, out: Dict[str, np.ndarray]) -> None:
        self.last_tokens = np.asarray(out["action_tokens"])
        if "n_accepted" in out:
            self.accepted_total += int(np.asarray(out["n_accepted"]).sum())
        self.steps += 1

    @property
    def acceptance_rate(self) -> float:
        a = self.last_tokens.shape[-1] if self.last_tokens is not None else 1
        return self.accepted_total / max(self.steps * a, 1)


def get_vla_action(
    vla: OpenVLA,
    obs: Dict[str, Any],
    task_label: str,
    unnorm_key: Optional[str] = None,
    center_crop: bool = False,
    return_embeddings: bool = False,
    base_vlm: str = "openvla-7b",
    spec_state: Optional[SpeculativeActionState] = None,
) -> Dict[str, np.ndarray]:
    """One control step: observation image + instruction -> 7-DoF action
    (+ optional L + 1 pooled hidden states from the same prefill). v01 base
    models use the chat-style prompt.

    Pass a `SpeculativeActionState` to run verified speculative decode across
    the control loop (the greedy tokens up to hairline margins; latency drops
    with acceptance)."""
    image = np.asarray(obs["full_image"])
    if center_crop:
        image = center_crop_image_u8(image, crop_scale=0.9)
    if "v01" in base_vlm:
        prompt = (
            "USER: What action should the robot take to "
            f"{task_label.lower()}? ASSISTANT:"
        )
    else:
        prompt = f"In: What action should the robot take to {task_label.lower()}?\nOut:"
    draft = spec_state.last_tokens if spec_state is not None else None
    out = vla.predict_action(
        image, prompt, unnorm_key=unnorm_key,
        return_hidden_states=return_embeddings,
        draft_tokens=draft,
    )
    if spec_state is not None:
        spec_state.observe(out)
    return out
