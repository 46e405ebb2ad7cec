"""Fourier layout helpers: centered transforms, real-space padding,
packed pixel rings and translation phase ramps.

Layout contract (as in thunder_tpu.ops.fourier):
  * real space: FFT layout, particle center at index [0, 0];
  * Fourier space: centered full-space, index [c + ky, c + kx]
    (and [c + kz, ...] for volumes), c = size // 2.

The JAX package's ``irfftn_safe`` (a per-axis decomposition that dodges
a TPU irfftn fault) has no counterpart: ``torch.fft.irfftn`` is used
directly.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from thunder_tpu_torch.device import COMPLEX, REAL


def _axes(ndim: int) -> tuple:
    return tuple(range(-ndim, 0))


def centered_quad_dev(size: int, ndim: int, device=None) -> torch.Tensor:
    """|k|^2 over the centered grid."""
    k = torch.arange(size, dtype=REAL, device=device) - size // 2
    q = torch.zeros((1,) * ndim, dtype=REAL, device=device)
    for d in range(ndim):
        shape = [1] * ndim
        shape[d] = size
        q = q + k.reshape(shape) ** 2
    return q


def centered_shell_dev(size: int, ndim: int, device=None) -> torch.Tensor:
    """round(|k|) integer shell index over the centered grid."""
    return torch.round(torch.sqrt(centered_quad_dev(size, ndim, device))
                       ).to(torch.int32)


def radial_grid_dev(size: int, ndim: int, device=None) -> torch.Tensor:
    """Wrapped (FFT-layout) distance-from-origin grid."""
    k = torch.arange(size, dtype=REAL, device=device)
    k = torch.minimum(k, size - k)
    q = torch.zeros((1,) * ndim, dtype=REAL, device=device)
    for d in range(ndim):
        shape = [1] * ndim
        shape[d] = size
        q = q + k.reshape(shape) ** 2
    return torch.sqrt(q)


# -- centered transforms ------------------------------------------------

def fft2_centered(x: torch.Tensor) -> torch.Tensor:
    """Real space (FFT layout) -> centered full-space spectrum."""
    return torch.fft.fftshift(torch.fft.fft2(x), dim=(-2, -1))


def ifft2_centered(f: torch.Tensor) -> torch.Tensor:
    """Centered spectrum -> real space (FFT layout); the real part."""
    return torch.fft.ifft2(torch.fft.ifftshift(f, dim=(-2, -1))).real


def fft3_centered(x: torch.Tensor) -> torch.Tensor:
    ax = (-3, -2, -1)
    return torch.fft.fftshift(torch.fft.fftn(x, dim=ax), dim=ax)


def ifft3_centered(f: torch.Tensor) -> torch.Tensor:
    ax = (-3, -2, -1)
    return torch.fft.ifftn(torch.fft.ifftshift(f, dim=ax), dim=ax).real


# -- real-space pad / extract ------------------------------------------

def pad_rl(x: torch.Tensor, pf: int, nd: int | None = None) -> torch.Tensor:
    """Zero-pad an FFT-layout array (the trailing ``nd`` spatial dims,
    all by default) by ``pf`` around the centered object."""
    if pf == 1:
        return x
    nd = x.ndim if nd is None else nd
    size = x.shape[-1]
    big = size * pf
    lo = (big - size) // 2
    ax = _axes(nd)
    centered = torch.fft.fftshift(x, dim=ax)
    pad = []
    for _ in range(nd):
        pad += [lo, big - size - lo]
    padded = torch.nn.functional.pad(centered, pad)
    return torch.fft.ifftshift(padded, dim=ax)


def resize_rl(x: torch.Tensor, new_size: int, nd: int | None = None,
              preserve: str = "coefficients") -> torch.Tensor:
    """Fourier resample an FFT-layout real array (trailing ``nd``
    spatial dims) to a new box size by centered-spectrum crop/pad."""
    nd = x.ndim if nd is None else nd
    size = x.shape[-1]
    if new_size == size:
        return x
    ax = _axes(nd)
    ft = torch.fft.fftshift(torch.fft.fftn(x, dim=ax), dim=ax)
    c, nc = size // 2, new_size // 2
    if new_size < size:
        sl = (Ellipsis,) + tuple(slice(c - nc, c - nc + new_size)
                                 for _ in range(nd))
        ft2 = ft[sl]
    else:
        pad = []
        for _ in range(nd):
            pad += [nc - c, new_size - size - (nc - c)]
        ft2 = torch.nn.functional.pad(ft, pad)
    out = torch.fft.ifftn(torch.fft.ifftshift(ft2, dim=ax), dim=ax).real
    if preserve == "values":
        out = out * (new_size / size) ** nd
    return out


def extract_rl(x: torch.Tensor, factor: int, nd: int | None = None
               ) -> torch.Tensor:
    """Extract the central 1/factor region of the trailing ``nd`` dims."""
    if factor == 1:
        return x
    nd = x.ndim if nd is None else nd
    big = x.shape[-1]
    size = big // factor
    lo = (big - size) // 2
    ax = _axes(nd)
    centered = torch.fft.fftshift(x, dim=ax)
    sl = (Ellipsis,) + tuple(slice(lo, lo + size) for _ in range(nd))
    return torch.fft.ifftshift(centered[sl], dim=ax)


# -- packed pixel rings -------------------------------------------------

class PackedRings(NamedTuple):
    """Per-round pixel packing (tensors on one device).

    i_col, i_row : (p,) int32 logical integer frequencies (half-space)
    i_sig        : (p,) int32 shell index round(|f|)
    mask         : (p,) float32, 1 for real pixels, 0 for lane padding
    """

    i_col: torch.Tensor
    i_row: torch.Tensor
    i_sig: torch.Tensor
    mask: torch.Tensor
    n_valid: int
    r_u: int
    r_l: int
    size: int


@lru_cache(maxsize=64)
def _ring_arrays(size: int, r_u: int, r_l: int, lane: int):
    cols, rows, sigs = [], [], []
    for j in range(-r_u, r_u + 1):
        for i in range(0, r_u + 1):
            if i == 0 and j < 0:
                continue
            q = i * i + j * j
            if not (r_l * r_l <= q < r_u * r_u):
                continue
            v = int(round(np.sqrt(q)))
            if r_l <= v < r_u:
                cols.append(i)
                rows.append(j)
                sigs.append(v)
    n = len(cols)
    p = max(lane, ((n + lane - 1) // lane) * lane)
    pad = p - n
    return (np.asarray(cols + [0] * pad, np.int32),
            np.asarray(rows + [0] * pad, np.int32),
            np.asarray(sigs + [0] * pad, np.int32),
            np.asarray([1.0] * n + [0.0] * pad, np.float32), n)


def pack_rings(size: int, r_u: int, r_l: int = 0, lane: int = 8,
               device=None) -> PackedRings:
    """Half-space frequencies with r_l <= round(|f|) < r_u and
    r_l^2 <= |f|^2 < r_u^2 (Optimiser.cpp:8013-8025), skipping the
    duplicate (i == 0, j < 0) half-column; padded to ``lane``."""
    i_col, i_row, i_sig, mask, n = _ring_arrays(size, r_u, r_l, lane)
    t = lambda a: torch.as_tensor(a, device=device)
    return PackedRings(t(i_col), t(i_row), t(i_sig), t(mask), n, r_u, r_l,
                       size)


def extract_packed(ft: torch.Tensor, rings: PackedRings) -> torch.Tensor:
    """(..., size, size) centered spectrum -> (..., p) packed pixels."""
    c = rings.size // 2
    return ft[..., (c + rings.i_row).long(), (c + rings.i_col).long()]


def translate_phases_view(i_col: torch.Tensor, i_row: torch.Tensor,
                          size: int, trans: torch.Tensor) -> torch.Tensor:
    """exp(-2 pi i (i tx + j ty)/size) at pixels (i_col, i_row);
    trans (..., 2) -> (..., p) complex64 (ImageFunctions.cpp:233-252)."""
    phase = (2 * np.pi / size) * (
        i_col.to(REAL) * trans[..., 0:1] + i_row.to(REAL) * trans[..., 1:2])
    return torch.complex(torch.cos(phase), -torch.sin(phase))


def translate_phases(rings: PackedRings, trans: torch.Tensor) -> torch.Tensor:
    return translate_phases_view(rings.i_col, rings.i_row, rings.size, trans)


def translate_ft(ft: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Translate centered full-space 2D spectra (..., size, size) by
    trans (..., 2) = (tx, ty) pixels each."""
    size = ft.shape[-1]
    k = torch.arange(size, dtype=REAL, device=ft.device) - size // 2
    trans = torch.as_tensor(trans, dtype=REAL, device=ft.device)
    phase = (2 * np.pi / size) * (k * trans[..., 0, None, None]
                                  + k[:, None] * trans[..., 1, None, None])
    return ft * torch.polar(torch.ones_like(phase), -phase).to(COMPLEX)
