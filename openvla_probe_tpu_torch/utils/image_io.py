"""Image files to [H, W, 3] uint8 arrays, without PIL.

`read_image(path)` is what the JAX scripts do with
``np.asarray(Image.open(path).convert("RGB"))`` (JAX ``scripts/generate.py:45``,
``eval/harness.py:122``), for the files the port reads:

  * PNG, decoded here with ``zlib`` and numpy: gray and palette images of
    1, 2, 4 or 8 bits, 8-bit gray + alpha, RGB and RGBA, not interlaced,
    with all five row filters. The conversion is PIL's ``convert("RGB")``:
    alpha is dropped (not blended), gray is repeated over the three channels
    (a sub-byte gray scaled to 0..255 as PIL unpacks it), and a palette index
    reads its PLTE entry (a tRNS chunk changes nothing);
  * ``.npy`` files holding an [H, W, 3] uint8 array.

Anything else raises and names what is read: JPEG, 16-bit PNG and interlaced
PNG among them.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
READS = ("PNG (gray and palette of 1/2/4/8 bits; 8-bit gray + alpha, RGB, RGBA; not interlaced)",
         ".npy ([H, W, 3] uint8)")
# PNG color type -> channels a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedImage(ValueError):
    """An image file that `read_image` does not decode."""


def _unsupported(path, what: str) -> UnsupportedImage:
    return UnsupportedImage(f"{path}: {what}; read_image reads " + " and ".join(READS))


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth): the
    image's bytes as a [height, stride] uint8 array."""
    if len(raw) < height * (stride + 1):
        raise _unsupported(path, "truncated image data")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1 and stride % bpp == 0:
            # Sub: a running sum along each byte lane of the pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            # Average and Paeth depend on the bytes just decoded to the left
            cur = line.copy()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + prev[i]) >> 1
                else:
                    b = prev[i]
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise _unsupported(path, f"PNG row filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: Union[str, Path]) -> np.ndarray:
    """A PNG file as [H, W, 3] uint8, converted as PIL's convert("RGB")."""
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise _unsupported(path, "not a PNG file")
    at, header, palette, idat = len(PNG_SIGNATURE), None, None, []
    while at + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + length]
        at += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise _unsupported(path, "PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise _unsupported(path, "interlaced PNG")
    if ctype not in _CHANNELS:
        raise _unsupported(path, f"PNG color type {ctype}")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise _unsupported(path, f"{depth}-bit PNG of color type {ctype}")
    channels = _CHANNELS[ctype]
    stride = (width * channels * depth + 7) // 8
    raw = _unfilter(zlib.decompress(b"".join(idat)), height, stride, max(1, channels * depth // 8),
                    path)
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        raw = ((raw[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, -1)[:, :width]
        if ctype == 0:
            raw = raw * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise _unsupported(path, "palette PNG without PLTE")
        # an index past the palette reads black
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[raw]
    pix = raw.reshape(height, width, channels)
    if ctype in (0, 4):
        return np.repeat(pix[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pix[:, :, :3])


def write_png(path: Union[str, Path], image: np.ndarray) -> Path:
    """Write an [H, W, 3] uint8 array as an 8-bit RGB PNG (every row filter
    None): the files `read_image` reads back bit for bit."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    path = Path(path)
    path.write_bytes(PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))
    return path


def read_image(path: Union[str, Path]) -> np.ndarray:
    """An image file as an [H, W, 3] uint8 array (PNG or .npy); anything else
    raises `UnsupportedImage` naming the formats read."""
    path = Path(path)
    if path.suffix.lower() == ".npy":
        arr = np.load(path, allow_pickle=False)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise _unsupported(path, f"a {arr.dtype} array of shape {arr.shape}")
        return arr
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head != PNG_SIGNATURE:
        kind = "a JPEG file" if head[:3] == b"\xff\xd8\xff" else "not a PNG file"
        raise _unsupported(path, kind)
    return read_png(path)
