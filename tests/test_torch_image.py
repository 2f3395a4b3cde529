"""Port image transform vs the JAX package's, on random uint8 images.

Both resize in fp32 over the same Pillow-quantized weights, then round each
pass to the uint8 grid. A float32 sum taken in another order can cross a .5
rounding edge, so the resized grids must agree on >= 99.9% of pixels and never
differ by more than one step; where they agree, the normalized outputs agree
within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu_torch.ops import image as timage


@pytest.mark.parametrize("n,m,method", [(256, 224, "bicubic"), (37, 28, "bicubic"),
                                        (20, 28, "bilinear"), (53, 28, "lanczos"),
                                        (9, 4, "box")])
def test_resample_weights_equal(n, m, method):
    np.testing.assert_array_equal(timage.resample_weights(n, m, method),
                                  jimage.resample_weights(n, m, method))


def _grid_check(got, want):
    diff = np.abs(got - want)
    assert diff.max() <= 1.0, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


@pytest.mark.parametrize("hw,out", [((256, 256), (224, 224)), ((37, 53), (28, 28))])
def test_pil_resize_grid(hw, out):
    x = np.random.default_rng(0).integers(0, 256, (2, 3, *hw), dtype=np.uint8)
    want = np.asarray(jimage.pil_resize_chw(jnp.asarray(x), out))
    got = timage.pil_resize_chw(torch.from_numpy(x), out).numpy()
    assert got.shape == want.shape == (2, 3, *out)
    _grid_check(got, want)


def _cfg(m, strategy, size):
    if size == 224:
        return m.ImageTransformConfig.dinosiglip_224(strategy)
    return m.ImageTransformConfig(specs=(
        m.BackboneTransformSpec((size, size), "bicubic", m.IMAGENET_DEFAULT_MEAN, m.IMAGENET_DEFAULT_STD),
        m.BackboneTransformSpec((size, size), "bicubic", m.SIGLIP_MEAN, m.SIGLIP_STD),
    ), resize_strategy=strategy)


@pytest.mark.parametrize("strategy", ["resize-naive", "resize-crop", "letterbox"])
@pytest.mark.parametrize("hw,size", [((256, 256), 224), ((37, 53), 28)])
def test_apply_image_transform_matches_jax(strategy, hw, size):
    img = np.random.default_rng(1).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(jimage.apply_image_transform(jnp.asarray(img), _cfg(jimage, strategy, size)))
    got = timage.apply_image_transform(torch.from_numpy(img), _cfg(timage, strategy, size)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 6, size, size)
    # recover each side's uint8 grid from the normalized output
    mean = np.array(timage.IMAGENET_DEFAULT_MEAN + timage.SIGLIP_MEAN, np.float32)[:, None, None]
    std = np.array(timage.IMAGENET_DEFAULT_STD + timage.SIGLIP_STD, np.float32)[:, None, None]
    g_got = np.round((got * std + mean) * 255)
    g_want = np.round((want * std + mean) * 255)
    _grid_check(g_got, g_want)
    same = g_got == g_want
    np.testing.assert_allclose(got[same], want[same], atol=1e-5)
