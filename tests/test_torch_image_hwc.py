"""The port's public HWC image helpers (``pil_resize_exact``, ``pil_resize``,
``center_crop``, ``letterbox_pad``, ``PrismaticImageTransform``) against the
JAX package's ``ops/image.py`` and Pillow, with the cases of
tests/test_image_ops.py, on the CPU.

* ``pil_resize_exact`` (numpy, float64) is bit-identical with Pillow and with
  the JAX package's.
* ``pil_resize`` (two fp32 matmuls, each pass rounded to the uint8 grid)
  within one uint8 level of Pillow on at most 0.1 % of the pixels (bilinear:
  two levels on 2 %, its rational weights land on exact ties), the JAX
  package's bound; and within one level of the JAX package's on the same
  share (both fp32, their sums in another order).
* ``center_crop`` and ``letterbox_pad`` equal to the JAX package's (pure
  data movement); ``PrismaticImageTransform`` on the CPU within 1e-5 of the
  JAX package's for every resize strategy, batched equal to one at a time.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu_torch.ops import image as timage

PIL_MODES = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR, "lanczos": Image.LANCZOS}
IN_HW = [(256, 256), (480, 640), (100, 37), (224, 224)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("method", list(PIL_MODES))
@pytest.mark.parametrize("in_hw", IN_HW)
def test_resize_exact_is_bitexact_with_pil_and_jax(method, in_hw, rng):
    img = rng.integers(0, 256, size=(*in_hw, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((224, 224), PIL_MODES[method]))
    got = timage.pil_resize_exact(img, (224, 224), method)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jimage.pil_resize_exact(img, (224, 224), method))


def _flip_budget(method):
    return (2.0, 2e-2) if method == "bilinear" else (1.0, 1e-3)


@pytest.mark.parametrize("method", list(PIL_MODES))
@pytest.mark.parametrize("in_hw", IN_HW)
def test_resize_matches_pil_and_jax(method, in_hw, rng):
    img = rng.integers(0, 256, size=(*in_hw, 3), dtype=np.uint8)
    got = timage.pil_resize(torch.from_numpy(img), (224, 224), method)
    assert got.dtype == torch.float32 and got.shape == (224, 224, 3)
    got = got.numpy()
    max_diff, share = _flip_budget(method)
    for want in (np.asarray(Image.fromarray(img).resize((224, 224), PIL_MODES[method])),
                 np.asarray(jimage.pil_resize(jnp.asarray(img), (224, 224), method))):
        diff = np.abs(got - want.astype(np.float32))
        assert diff.max() <= max_diff + 1e-5, diff.max()
        assert (diff > 0.5).mean() < share


def test_resize_upscale_and_float_input(rng):
    img = rng.integers(0, 256, size=(17, 23, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((224, 224), Image.BICUBIC)).astype(np.float32)
    got = timage.pil_resize(torch.from_numpy(img), (224, 224), "bicubic").numpy()
    assert np.abs(got - want).max() <= 1.0 + 1e-5
    as_float = timage.pil_resize(torch.from_numpy(img.astype(np.float32)), (224, 224)).numpy()
    np.testing.assert_array_equal(as_float, got)
    same = timage.pil_resize(torch.from_numpy(img), (17, 23)).numpy()
    np.testing.assert_array_equal(same, img.astype(np.float32))


def test_resize_without_uint8_rounding_matches_jax(rng):
    img = rng.integers(0, 256, size=(3, 50, 60, 3), dtype=np.uint8)
    got = timage.pil_resize(torch.from_numpy(img), (28, 28), emulate_uint8_rounding=False)
    want = jimage.pil_resize(jnp.asarray(img), (28, 28), emulate_uint8_rounding=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_center_crop_matches_manual_and_jax(rng):
    img = rng.normal(size=(1, 300, 260, 3)).astype(np.float32)
    got = timage.center_crop(torch.from_numpy(img), (224, 224)).numpy()
    np.testing.assert_array_equal(got, img[:, 38:262, 18:242, :])
    np.testing.assert_array_equal(got, np.asarray(jimage.center_crop(jnp.asarray(img), (224, 224))))


def test_center_crop_pads_small_images(rng):
    img = rng.normal(size=(100, 100, 3)).astype(np.float32)
    got = timage.center_crop(torch.from_numpy(img), (224, 224)).numpy()
    assert got.shape == (224, 224, 3)
    np.testing.assert_array_equal(got[62:162, 62:162], img)
    assert got[0, 0, 0] == 0.0
    np.testing.assert_array_equal(got, np.asarray(jimage.center_crop(jnp.asarray(img), (224, 224))))
    odd = rng.normal(size=(2, 101, 150, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.center_crop(torch.from_numpy(odd), (120, 120)).numpy(),
                                  np.asarray(jimage.center_crop(jnp.asarray(odd), (120, 120))))


@pytest.mark.parametrize("hw", [(100, 224), (224, 100), (224, 224), (37, 50)])
def test_letterbox_pad_matches_jax(hw, rng):
    img = rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)
    fill = (127.0, 10.0, 255.0)
    got = timage.letterbox_pad(torch.from_numpy(img), fill)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jimage.letterbox_pad(jnp.asarray(img), fill)))
    if hw == (100, 224):    # pad = floor((224 - 100) / 2) = 62 on top and bottom
        out = got.numpy()
        np.testing.assert_array_equal(out[:62], np.broadcast_to(fill, (62, 224, 3)))
        np.testing.assert_array_equal(out[62:162], img.astype(np.float32))


@pytest.mark.parametrize("strategy", ["resize-naive", "resize-crop", "letterbox"])
def test_prismatic_transform_matches_jax(strategy, rng):
    img = rng.integers(0, 256, size=(300, 400, 3), dtype=np.uint8)
    cfg_t = timage.ImageTransformConfig.dinosiglip_224(resize_strategy=strategy)
    cfg_j = jimage.ImageTransformConfig.dinosiglip_224(resize_strategy=strategy)
    got = timage.PrismaticImageTransform(cfg_t, device="cpu")(img)
    assert got.shape == (6, 224, 224) and got.device.type == "cpu"
    want = np.asarray(jimage.PrismaticImageTransform(cfg_j)(img))
    # one uint8 level at a rare tie, through the normalization (/ 0.224)
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= (1.0 / 255.0) / 0.224 + 1e-5
    assert (diff > 1e-5).mean() < 1e-3


def test_dinosiglip_stack_semantics(rng):
    img = rng.integers(0, 256, size=(256, 256, 3), dtype=np.uint8)
    out = timage.PrismaticImageTransform(device="cpu")(torch.from_numpy(img)).numpy()
    resized = np.asarray(Image.fromarray(img).resize((224, 224), Image.BICUBIC)).astype(
        np.float32) / 255.0
    dino = (resized - np.array(timage.IMAGENET_DEFAULT_MEAN)) / np.array(timage.IMAGENET_DEFAULT_STD)
    sig = (resized - 0.5) / 0.5
    want = np.concatenate([dino.transpose(2, 0, 1), sig.transpose(2, 0, 1)], axis=0)
    assert np.abs(out - want).max() <= (1.0 / 255.0) / 0.224 + 1e-5


def test_transform_batched_equals_single(rng):
    imgs = rng.integers(0, 256, size=(4, 256, 256, 3), dtype=np.uint8)
    t = timage.PrismaticImageTransform(device="cpu")
    out = t(imgs)
    assert out.shape == (4, 6, 224, 224)
    torch.testing.assert_close(out[0], t(imgs[0]), rtol=0, atol=1e-6)


def test_transform_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timage.PrismaticImageTransform()


def test_constants_match_jax():
    for name in ("IMAGENET_DEFAULT_MEAN", "IMAGENET_DEFAULT_STD", "OPENAI_CLIP_MEAN",
                 "OPENAI_CLIP_STD", "SIGLIP_MEAN", "SIGLIP_STD", "IMAGENET_INCEPTION_MEAN",
                 "IMAGENET_INCEPTION_STD"):
        assert getattr(timage, name) == getattr(jimage, name), name


def test_chw_resize_matches_hwc(rng):
    img = rng.integers(0, 256, (256, 200, 3), dtype=np.uint8)
    hwc = timage.pil_resize(torch.from_numpy(img), (224, 224)).numpy()
    chw = timage.pil_resize_chw(torch.from_numpy(np.moveaxis(img, -1, 0).copy()), (224, 224))
    np.testing.assert_array_equal(hwc, np.moveaxis(chw.numpy(), 0, -1))
