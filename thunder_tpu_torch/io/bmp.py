"""8-bit BMP image read/write (ImageFile::readImageBMP,
src/Image/BMP.cpp).

The reference reads only 8-bit (palette) BMPs — legacy single-particle
pickers emitted them — and writes 8-bit grayscale with a linear
palette (BMP::createBMP, BMP.cpp:84-124).  Same scope here, as in
thunder_tpu.io.bmp (host only).
"""

from __future__ import annotations

import struct

import numpy as np


def read_bmp(path: str) -> np.ndarray:
    """Read an 8-bit BMP into a float32 (h, w) array.

    Rows are returned in the reference's order: the file's bottom-up
    storage is kept as-is (IMAGE_READ_CAST streams the pixel data
    straight into the image buffer, ImageFile.cpp:286-288), so row 0 is
    the bottom scanline — consistent with the reference's real-space
    indexing.
    """
    with open(path, "rb") as f:
        head = f.read(14)
        if len(head) != 14 or head[:2] != b"BM":
            raise ValueError(f"{path}: not a BMP file")
        _, data_off = struct.unpack("<IxxxxI", head[2:14])
        info = f.read(40)
        (info_size, width, height, _planes, bit_count, compression) = (
            struct.unpack("<iiiHHI", info[:20]))
        if bit_count != 8:
            raise ValueError(
                f"{path}: only 8-bit BMPs are supported "
                f"(got {bit_count}-bit; matches ImageFile.cpp:286-292)")
        if compression != 0:
            raise ValueError(f"{path}: compressed BMPs are unsupported")
        flip = height < 0
        height = abs(height)
        stride = (width + 3) // 4 * 4
        f.seek(data_off)
        raw = np.frombuffer(f.read(stride * height), dtype=np.uint8)
        img = raw.reshape(height, stride)[:, :width].astype(np.float32)
        if flip:                       # top-down file: normalise to bottom-up
            img = img[::-1]
        return np.ascontiguousarray(img)


def write_bmp(path: str, img: np.ndarray) -> None:
    """Write a 2D array as an 8-bit grayscale BMP with a linear palette
    (BMP::createBMP + setHeader, BMP.cpp:84-160): values are min-max
    scaled to 0..255."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim != 2:
        raise ValueError("write_bmp expects a 2D image")
    h, w = img.shape
    lo, hi = float(img.min()), float(img.max())
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    pix = ((img - lo) * scale).astype(np.uint8)
    stride = (w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w] = pix
    palette = np.zeros((256, 4), np.uint8)
    palette[:, 0] = palette[:, 1] = palette[:, 2] = np.arange(256)
    data_off = 14 + 40 + 256 * 4
    total = data_off + stride * h
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", total, 0, 0, data_off))
        f.write(struct.pack("<iiiHHIIiiII", 40, w, h, 1, 8, 0,
                            stride * h, 2835, 2835, 0, 0))
        f.write(palette.tobytes())
        f.write(rows.tobytes())
