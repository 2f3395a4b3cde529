"""Image preprocessing: PIL-parity resample + crop + normalize as two fp32 matmuls.

Counterpart of ``openvla_probe_tpu/ops/image.py``. The resample is two dense
weight matrices (one per spatial axis) that replicate Pillow's resample
(kernel, antialias support scaling, window bounds, fixed-point coefficient
quantization); both products run in full fp32 (no TF32: see the package's
numerics flags), and each pass is rounded to the uint8 grid, as Pillow does.
``pil_resize_exact`` (numpy, float64) is bit-identical with Pillow's uint8
output. The public HWC helpers (``pil_resize``, ``center_crop``,
``letterbox_pad``) wrap the channels-first implementations the transform
runs; ``PrismaticImageTransform`` applies the transform on a device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)  # DINOv2
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_MEAN = (0.5, 0.5, 0.5)
IMAGENET_INCEPTION_STD = (0.5, 0.5, 0.5)


# --- PIL-exact resample kernels (numpy, float64) ---------------------------------

def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """PIL's bicubic kernel (a = -0.5; support 2)."""
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _sinc(x: np.ndarray) -> np.ndarray:
    return np.where(x == 0, 1.0, np.sin(np.pi * x) / np.where(x == 0, 1.0, np.pi * x))


def _lanczos3(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) < 3.0, _sinc(x) * _sinc(x / 3.0), 0.0)


def _box(x: np.ndarray) -> np.ndarray:
    return np.where((x > -0.5) | np.isclose(x, -0.5), (x < 0.5).astype(np.float64), 0.0)


_KERNELS = {
    "bicubic": (_bicubic, 2.0),
    "bilinear": (_bilinear, 1.0),
    "lanczos": (_lanczos3, 3.0),
    "box": (_box, 0.5),
}

_PIL_PRECISION_BITS = 32 - 8 - 2  # Pillow's 8-bit fixed-point coefficient precision


@functools.lru_cache(maxsize=256)
def resample_weights(
    in_size: int, out_size: int, method: str = "bicubic", quantize: bool = True
) -> np.ndarray:
    """[out_size, in_size] PIL-semantics resample matrix (antialias on downscale).

    Per output pixel: window [center - support + 0.5, center + support + 0.5)
    over input pixels, kernel at (x - center + 0.5) / filterscale, normalized to
    sum 1; with ``quantize`` snapped to Pillow's 2^22 fixed-point grid."""
    kernel, base_support = _KERNELS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    W = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        xs = np.arange(xmin, xmax, dtype=np.float64)
        w = kernel((xs - center + 0.5) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        W[o, xmin:xmax] = w
    if quantize:
        q = float(1 << _PIL_PRECISION_BITS)
        W = np.where(W < 0, np.ceil(W * q - 0.5), np.floor(W * q + 0.5)) / q
    return W


def pil_resize_exact(image: np.ndarray, out_hw: Tuple[int, int], method: str = "bicubic") -> np.ndarray:
    """Host-side numpy resample of [..., H, W, C], bit-exact with Pillow's
    uint8 path (float64 accumulation over Pillow-quantized weights, per-pass
    floor(x + 0.5), clip)."""
    h_in, w_in = image.shape[-3], image.shape[-2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return image.astype(np.uint8)
    x = image.astype(np.float64)
    x = np.einsum("ow,...hwc->...hoc", resample_weights(w_in, w_out, method), x)
    x = np.clip(np.floor(x + 0.5), 0, 255)
    x = np.einsum("oh,...hwc->...owc", resample_weights(h_in, h_out, method), x)
    x = np.clip(np.floor(x + 0.5), 0, 255)
    return x.astype(np.uint8)


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """PIL clip8: round half up to the uint8 grid and clamp (kept in float)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def pil_resize_chw(
    image: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str = "bicubic",
    emulate_uint8_rounding: bool = True,
) -> torch.Tensor:
    """[..., C, H, W] -> float32 [..., C, h, w]: horizontal pass, then vertical
    (Pillow's order), each rounded to the uint8 grid."""
    h_in, w_in = image.shape[-2], image.shape[-1]
    h_out, w_out = out_hw
    x = image.to(torch.float32)
    if (h_in, w_in) == (h_out, w_out):
        return x
    Ww = torch.as_tensor(resample_weights(w_in, w_out, method), dtype=torch.float32,
                         device=x.device)
    Wh = torch.as_tensor(resample_weights(h_in, h_out, method), dtype=torch.float32,
                         device=x.device)
    x = torch.matmul(x, Ww.t())                 # [..., H, w_out]
    if emulate_uint8_rounding:
        x = _round_u8(x)
    x = torch.matmul(Wh, x)                     # [..., h_out, w_out]
    if emulate_uint8_rounding:
        x = _round_u8(x)
    return x


def _center_crop_chw(image: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Channels-first center crop (zero-pads first when smaller)."""
    h, w = image.shape[-2], image.shape[-1]
    th, tw = out_hw
    if h < th or w < tw:
        ph, pw = max(th - h, 0), max(tw - w, 0)
        image = torch.nn.functional.pad(image, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        h, w = image.shape[-2], image.shape[-1]
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return image[..., top:top + th, left:left + tw]


def _letterbox_pad_chw(image: torch.Tensor, fill: Tuple[float, float, float]) -> torch.Tensor:
    """Channels-first letterbox pad to square with a per-channel fill."""
    h, w = image.shape[-2], image.shape[-1]
    max_wh = max(h, w)
    hp, vp = int((max_wh - w) / 2), int((max_wh - h) / 2)
    out = torch.nn.functional.pad(image.to(torch.float32), (hp, hp, vp, vp))
    if hp == 0 and vp == 0:
        return out
    mask = torch.ones((out.shape[-2], out.shape[-1]), dtype=torch.bool, device=out.device)
    mask[vp:vp + h, hp:hp + w] = False
    fill_t = torch.tensor(fill, dtype=torch.float32, device=out.device)[:, None, None]
    return torch.where(mask[None], fill_t, out)


def pil_resize(
    image: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str = "bicubic",
    emulate_uint8_rounding: bool = True,
) -> torch.Tensor:
    """Resize a [..., H, W, C] uint8 or float image to `out_hw` with PIL
    semantics (`pil_resize_chw` on the channels-first view): float32 in [0, 255]."""
    x = torch.movedim(torch.as_tensor(image), -1, -3)
    return torch.movedim(pil_resize_chw(x, out_hw, method, emulate_uint8_rounding), -3, -1)


def center_crop(image: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Center crop [..., H, W, C]; zero-pads first where the image is smaller
    (torchvision's functional center_crop)."""
    x = torch.movedim(torch.as_tensor(image), -1, -3)
    return torch.movedim(_center_crop_chw(x, out_hw), -3, -1)


def letterbox_pad(image: torch.Tensor, fill: Tuple[float, float, float]) -> torch.Tensor:
    """Symmetric pad of [..., H, W, C] to square with a constant per-channel
    fill (floor((max side - side) / 2) on each side). Returns float32."""
    x = torch.movedim(torch.as_tensor(image), -1, -3)
    return torch.movedim(_letterbox_pad_chw(x, fill), -3, -1)


@dataclass(frozen=True)
class BackboneTransformSpec:
    """Per-backbone resize/normalize parameters."""

    input_size: Tuple[int, int] = (224, 224)
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = SIGLIP_MEAN
    std: Tuple[float, float, float] = SIGLIP_STD


@dataclass(frozen=True)
class ImageTransformConfig:
    """A resize strategy + one spec per backbone."""

    specs: Tuple[BackboneTransformSpec, ...] = (BackboneTransformSpec(),)
    resize_strategy: str = "resize-naive"  # resize-naive | resize-crop | letterbox

    @staticmethod
    def dinosiglip_224(resize_strategy: str = "resize-naive") -> "ImageTransformConfig":
        """The OpenVLA default: DINOv2 (ImageNet norm) + SigLIP (0.5 norm) @224."""
        return ImageTransformConfig(
            specs=(
                BackboneTransformSpec((224, 224), "bicubic", IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD),
                BackboneTransformSpec((224, 224), "bicubic", SIGLIP_MEAN, SIGLIP_STD),
            ),
            resize_strategy=resize_strategy,
        )


def apply_image_transform(image: torch.Tensor, config: ImageTransformConfig) -> torch.Tensor:
    """uint8 [..., H, W, 3] -> float32 [..., 3*num_backbones, S, S] channel-stacked,
    on the image's device."""
    x = torch.movedim(image.to(torch.float32), -1, -3)   # [..., 3, H, W]
    outs: List[torch.Tensor] = []
    resized_cache: dict = {}   # identical resizes across backbones run once
    for spec in config.specs:
        th, tw = spec.input_size
        if config.resize_strategy == "letterbox":
            fill = tuple(float(int(m * 255)) for m in spec.mean)
            key = ("letterbox", fill, (th, tw), spec.interpolation)
            if key not in resized_cache:
                resized_cache[key] = pil_resize_chw(_letterbox_pad_chw(x, fill), (th, tw),
                                                    spec.interpolation)
            xi = resized_cache[key]
        elif config.resize_strategy == "resize-naive":
            key = ("naive", (th, tw), spec.interpolation)
            if key not in resized_cache:
                resized_cache[key] = pil_resize_chw(x, (th, tw), spec.interpolation)
            xi = resized_cache[key]
        elif config.resize_strategy == "resize-crop":
            h, w = x.shape[-2], x.shape[-1]
            short, long = (h, w) if h <= w else (w, h)
            new_long = max(1, int(th * long / short))
            rhw = (th, new_long) if h <= w else (new_long, th)
            xi = _center_crop_chw(pil_resize_chw(x, rhw, spec.interpolation), (th, tw))
        else:
            raise ValueError(f"Unknown resize strategy: {config.resize_strategy}")
        xi = xi / 255.0
        mean = torch.tensor(spec.mean, dtype=torch.float32, device=x.device)[:, None, None]
        std = torch.tensor(spec.std, dtype=torch.float32, device=x.device)[:, None, None]
        outs.append((xi - mean) / std)
    return torch.cat(outs, dim=-3)


class PrismaticImageTransform:
    """Callable applying `apply_image_transform` with one config on `device`:
    uint8 [..., H, W, 3] (numpy or a tensor) -> float32 [..., 3K, S, S]."""

    def __init__(self, config: Optional[ImageTransformConfig] = None,
                 device: DeviceLike = "cuda") -> None:
        self.config = config or ImageTransformConfig.dinosiglip_224()
        self.device = resolve_device(device)

    def __call__(self, image) -> torch.Tensor:
        return apply_image_transform(torch.as_tensor(image, device=self.device), self.config)
