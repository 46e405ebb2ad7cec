"""MRC2014 image/stack/volume I/O (numpy only), as thunder_tpu.io.mrc.

Replaces the reference's ImageFile/MRCHeader (include/Image/MRCHeader.h:33-60,
src/Image/ImageFile.cpp).  Reads modes 0 (int8), 1 (int16), 2 (float32)
and 6 (uint16); writes mode 2.  Stacks are indexed per-slice with mmap so
a reader can pull a chunk of particles without loading the whole file.

Layout note: files store images in the usual corner-origin raster with
the particle centered in the box; the framework's internal real-space
layout is FFT layout (center at index [0, 0]).  Conversion is an
``ifftshift`` on load / ``fftshift`` on save (the reference does the same
remap in IMAGE_READ_CAST via MESH_IMAGE_INDEX, include/Image/ImageFile.h:383).
Use ``to_internal``/``to_file`` or the ``shift=True`` flags.
"""

from __future__ import annotations

import struct

import numpy as np

_MODE_DTYPES = {0: np.int8, 1: np.int16, 2: np.float32, 6: np.uint16}
_HEADER_SIZE = 1024


def to_internal(arr: np.ndarray) -> np.ndarray:
    """File layout (centered particle) -> internal FFT layout."""
    axes = tuple(range(arr.ndim))
    return np.fft.ifftshift(arr, axes=axes[-arr.ndim:]) if arr.ndim <= 3 else arr


def to_file(arr: np.ndarray) -> np.ndarray:
    """Internal FFT layout -> file layout."""
    axes = tuple(range(arr.ndim))
    return np.fft.fftshift(arr, axes=axes[-arr.ndim:]) if arr.ndim <= 3 else arr


class MrcFile:
    """A parsed MRC file backed by an mmap; cheap per-slice access."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            header = f.read(_HEADER_SIZE)
        (self.nx, self.ny, self.nz, self.mode) = struct.unpack("<4i", header[:16])
        (self.mx, self.my, self.mz) = struct.unpack("<3i", header[28:40])
        (self.cella_x, self.cella_y, self.cella_z) = struct.unpack("<3f", header[40:52])
        (self.nsymbt,) = struct.unpack("<i", header[92:96])
        if self.mode not in _MODE_DTYPES:
            raise ValueError(f"unsupported MRC mode {self.mode} in {path}")
        self.dtype = np.dtype(_MODE_DTYPES[self.mode]).newbyteorder("<")
        self._offset = _HEADER_SIZE + self.nsymbt
        self._data = np.memmap(
            path,
            dtype=self.dtype,
            mode="r",
            offset=self._offset,
            shape=(self.nz, self.ny, self.nx),
        )

    @property
    def pixel_size(self) -> float:
        if self.mx > 0 and self.cella_x > 0:
            return self.cella_x / self.mx
        return 1.0

    def read_slices(self, idx, shift: bool = True) -> np.ndarray:
        imgs = np.asarray(self._data[np.asarray(idx)], dtype=np.float32)
        if shift:
            imgs = np.fft.ifftshift(imgs, axes=(-2, -1))
        return imgs

    def read_volume(self, shift: bool = True) -> np.ndarray:
        vol = np.asarray(self._data, dtype=np.float32)
        return to_internal(vol) if shift else vol


def read_mrc(path: str, shift: bool = True) -> tuple[np.ndarray, float]:
    """Read a whole MRC file -> (data, pixel_size).

    2D files (nz == 1) come back squeezed to (ny, nx).
    """
    f = MrcFile(path)
    data = f.read_volume(shift=False)
    if f.nz == 1:
        data = data[0]
    if shift:
        data = to_internal(data)
    return data, f.pixel_size


def write_mrc(path: str, data: np.ndarray, pixel_size: float = 1.0,
              shift: bool = True, is_stack: bool = False) -> None:
    """Write float32 MRC2014 (mode 2).

    data: (ny, nx), (nz, ny, nx) or, with ``is_stack``, (n, ny, nx)
    where each slice is an independent image (class averages etc.).
    """
    data = np.asarray(data, dtype=np.float32)
    if shift:
        if is_stack:
            data = np.fft.fftshift(data, axes=(-2, -1))
        else:
            data = to_file(data)
    if data.ndim == 2:
        data = data[None]
    nz, ny, nx = data.shape
    ispg = 0 if (nz == 1 or is_stack) else 1

    header = bytearray(_HEADER_SIZE)
    struct.pack_into("<4i", header, 0, nx, ny, nz, 2)
    struct.pack_into("<3i", header, 16, 0, 0, 0)              # nxstart
    struct.pack_into("<3i", header, 28, nx, ny, nz)           # mx my mz
    struct.pack_into("<3f", header, 40, nx * pixel_size, ny * pixel_size, nz * pixel_size)
    struct.pack_into("<3f", header, 52, 90.0, 90.0, 90.0)     # cellb
    struct.pack_into("<3i", header, 64, 1, 2, 3)              # mapc mapr maps
    struct.pack_into("<3f", header, 76, float(data.min()), float(data.max()), float(data.mean()))
    struct.pack_into("<i", header, 88, ispg)
    header[208:212] = b"MAP "
    header[212:216] = b"\x44\x44\x00\x00"                     # little-endian machst
    struct.pack_into("<f", header, 216, float(data.std()))
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(data.tobytes())
