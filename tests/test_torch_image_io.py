"""The port's image reader (openvla_probe_tpu_torch/utils/image_io.py)
against PIL, which the JAX scripts decode with: seeded images saved by PIL in
each mode read back bit-equal to ``np.asarray(Image.open(p).convert("RGB"))``
(alpha dropped, a palette with tRNS read through its PLTE, sub-byte gray
scaled); .npy files; the PNG writer; JPEG, 16-bit and interlaced PNG raise."""

import numpy as np
import pytest
from PIL import Image

from openvla_probe_tpu_torch.utils.image_io import UnsupportedImage, read_image, write_png

H, W = 37, 53


def _images():
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    # a smooth image: PIL's encoder picks the Sub, Up, Average and Paeth filters on it
    smooth = np.stack([(xx * 5) % 256, (yy * 7) % 256, (xx + yy) % 256], -1).astype(np.uint8)
    alpha = rng.integers(0, 256, (H, W, 1), dtype=np.uint8)
    return {
        "RGB": (Image.fromarray(noise), {}),
        "RGB_smooth": (Image.fromarray(smooth), {}),
        "RGBA": (Image.fromarray(np.concatenate([noise, alpha], -1), "RGBA"), {}),
        "L": (Image.fromarray(noise[..., 0]), {}),
        "LA": (Image.fromarray(np.stack([noise[..., 0], noise[..., 1]], -1), "LA"), {}),
        "1": (Image.fromarray(noise[..., 0] > 128), {}),
        "P": (Image.fromarray(smooth).quantize(200), {}),
        "P_trns": (Image.fromarray(smooth).quantize(200), {"transparency": bytes(range(200))}),
        "P4_trns": (Image.fromarray(smooth).quantize(16), {"bits": 4, "transparency": 3}),
        "P2": (Image.fromarray(smooth).quantize(4), {"bits": 2}),
    }


@pytest.mark.parametrize("mode", list(_images()))
def test_png_equals_pil(tmp_path, mode):
    img, kw = _images()[mode]
    p = tmp_path / f"{mode}.png"
    img.save(p, **kw)
    got = read_image(p)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, np.asarray(Image.open(p).convert("RGB")))


def test_gray_of_2_and_4_bits_scales_as_pil(tmp_path):
    """Sub-byte gray (which PIL does not write) built by hand: PIL unpacks
    each value scaled to 0..255."""
    import struct
    import zlib

    rng = np.random.default_rng(1)
    for depth in (2, 4):
        vals = rng.integers(0, 1 << depth, (5, 11), dtype=np.uint8)
        per = 8 // depth
        padded = np.zeros((5, -(-11 // per) * per), np.uint8)
        padded[:, :11] = vals
        packed = np.zeros((5, padded.shape[1] // per), np.uint8)
        for j in range(per):
            packed |= padded[:, j::per] << (8 - depth * (j + 1))
        raw = np.concatenate([np.zeros((5, 1), np.uint8), packed], 1).tobytes()

        def chunk(kind, body):
            return struct.pack(">I", len(body)) + kind + body + struct.pack(
                ">I", zlib.crc32(kind + body))

        p = tmp_path / f"g{depth}.png"
        p.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 11, 5, depth,
                                                                           0, 0, 0, 0))
                      + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
        np.testing.assert_array_equal(read_image(p), np.asarray(Image.open(p).convert("RGB")))


def test_npy_and_the_writer(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (19, 23, 3), dtype=np.uint8)
    np.save(tmp_path / "x.npy", img)
    np.testing.assert_array_equal(read_image(tmp_path / "x.npy"), img)
    np.save(tmp_path / "f.npy", img.astype(np.float32))
    with pytest.raises(UnsupportedImage, match="float32"):
        read_image(tmp_path / "f.npy")
    write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(read_image(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png").convert("RGB")), img)


@pytest.mark.parametrize("kind", ["jpeg", "png16", "interlaced"])
def test_unsupported_files_raise(tmp_path, kind):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    p = tmp_path / "x.png"
    if kind == "jpeg":
        p = tmp_path / "x.jpg"
        Image.fromarray(img).save(p)
        match = "JPEG"
    elif kind == "png16":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200, "I;16").save(p)
        match = "16-bit"
    else:
        Image.fromarray(img).save(p)
        data = bytearray(p.read_bytes())
        data[28] = 1     # IHDR's interlace byte (the CRC is not checked)
        p.write_bytes(bytes(data))
        match = "interlaced"
    with pytest.raises(UnsupportedImage, match=match) as e:
        read_image(p)
    assert "PNG" in str(e.value) and ".npy" in str(e.value)
