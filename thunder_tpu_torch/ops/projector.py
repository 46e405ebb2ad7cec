"""Fourier-slice projection (src/Projector.cpp) — and the host of
kernels HK1 (``project_slices``, 3D) and HK5 (``project_slices_2d``).

Pad the reference by ``pf`` in real space, divide by the interpolation
kernel's FT (grid correction, Projector.cpp:524-606), FFT; per pose,
gather a central slice (3D, trilinear) or an in-plane rotated plane
(2D, bilinear) at rotated padded coordinates (Projector.cpp:337-374).
The padded spectrum is a full complex cube / plane in centered layout,
as in thunder_tpu.ops.projector; the port gathers float32 complex
directly (the JAX package's bf16 corner-row tables are a TPU gather
layout).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import COMPLEX, REAL
from thunder_tpu_torch.ops.fourier import (
    PackedRings,
    centered_quad_dev,
    fft2_centered,
    fft3_centered,
    pad_rl,
    radial_grid_dev,
)
from thunder_tpu_torch.physics.kernels import tik_rl


class Projectee(NamedTuple):
    """A prepared, padded, grid-corrected reference spectrum."""

    ft: torch.Tensor   # (pf*size,)*3 complex64, centered layout
    size: int
    pf: int
    max_radius: int    # size // 2 - 1


def prepare_projectee_2d(ref_rl: torch.Tensor, pf: int = 2) -> Projectee:
    """Real-space 2D reference (FFT layout) -> padded corrected spectrum
    (Projector.cpp:97-121); leading dims batch."""
    size = ref_rl.shape[-1]
    big = size * pf
    padded = pad_rl(ref_rl, pf, nd=2)
    corr = tik_rl(radial_grid_dev(big, 2, ref_rl.device) / (pf * big))
    return Projectee(fft2_centered(padded / corr).to(COMPLEX), size, pf,
                     size // 2 - 1)


def prepare_projectee_2d_cropped(refs: torch.Tensor, pf: int,
                                 crop: int) -> torch.Tensor:
    """Central ``crop`` band of the padded, grid-corrected class spectra
    (optimiser._prepare_projectee_stack in 2D): refs (K, n, n) ->
    (K, crop, crop) complex64."""
    ft = prepare_projectee_2d(refs, pf).ft
    big = ft.shape[-1]
    lo = big // 2 - crop // 2
    return ft[..., lo:lo + crop, lo:lo + crop]


def prepare_projectee_3d(ref_rl: torch.Tensor, pf: int = 2) -> Projectee:
    """Real-space 3D reference (FFT layout) -> padded corrected spectrum
    (Projector.cpp:123-148)."""
    size = ref_rl.shape[-1]
    big = size * pf
    padded = pad_rl(ref_rl, pf)
    corr = tik_rl(radial_grid_dev(big, 3, ref_rl.device) / (pf * big))
    return Projectee(fft3_centered(padded / corr).to(COMPLEX), size, pf,
                     size // 2 - 1)


def _zoom_dft_mat(size: int, big: int, crop: int, device) -> torch.Tensor:
    """E[K, m] = exp(-2 pi i (K - crop//2)(m - size//2) / big): centered
    real-space support -> the centered-spectrum band of the padded FFT."""
    kk = torch.arange(crop, dtype=REAL, device=device) - crop // 2
    mm = torch.arange(size, dtype=REAL, device=device) - size // 2
    ang = (-2.0 * math.pi / big) * kk[:, None] * mm[None, :]
    return torch.complex(torch.cos(ang), torch.sin(ang))


def prepare_projectee_3d_cropped(ref_rl: torch.Tensor, pf: int,
                                 crop: int) -> torch.Tensor:
    """Central ``crop`` band of the padded, grid-corrected spectrum by
    three per-axis zoom-DFT matmuls (never builds the (pf*size)^3 cube).
    ref_rl (..., size, size, size) -> (..., crop, crop, crop) complex64."""
    size = ref_rl.shape[-1]
    big = size * pf
    rc = torch.fft.fftshift(ref_rl, dim=(-3, -2, -1))
    corr = tik_rl(torch.sqrt(centered_quad_dev(size, 3, ref_rl.device)) / (pf * big))
    rc = (rc / corr).to(COMPLEX)
    e = _zoom_dft_mat(size, big, crop, ref_rl.device)
    t = torch.einsum("Km,...zym->...zyK", e, rc)
    t = torch.einsum("Jm,...zmK->...zJK", e, t)
    t = torch.einsum("Im,...mJK->...IJK", e, t)
    return t.to(COMPLEX)


# -- HK1 ----------------------------------------------------------------

# HK1's quad table pays while it stays near the 50 MB L2 cache of an
# H100: with two tables, 256 images x 125 rotations, measured faster than
# the plain cube at 48, 86 and 128 MiB and slower at 214 and 333 MiB
# (micro/hk_candidates.py --big); with the eight tables of a K = 4 round
# faster at 107 MiB (0.37 against 0.47 ms) and still at 190 MiB (0.67
# against 0.75 ms; chip_smoke.py phase 1c)
QUAD_TABLE_MAX_BYTES = 192 * 2 ** 20


def quad_taps(table: torch.Tensor) -> torch.Tensor:
    """HK1's quad table: (K, n, n, n) complex64 -> (K, n, n, n, 8)
    float32 whose cell (z, y, x) holds the four (y, x) taps of a
    trilinear sample in plane z, t[z, y, x], t[z, y, x+], t[z, y+, x],
    t[z, y+, x+] (re, im each; + is the next index clipped to n - 1):
    32 bytes on a 32-byte boundary, so the kernel reads a sample's eight
    taps as two sectors.  (The same layout over 2D planes measured
    slower for HK5, whose planes fit L1: csrc/project_slices_2d.cu.)"""
    nx = lambda t: torch.cat([t[..., 1:], t[..., -1:]], -1)
    ny = lambda t: torch.cat([t[..., 1:, :], t[..., -1:, :]], -2)
    q = torch.stack([table, nx(table), ny(table), nx(ny(table))], -1)
    return torch.view_as_real(q).reshape(table.shape + (8,)).contiguous()


def is_quad_table(table: torch.Tensor) -> bool:
    return table.ndim == 5 and table.shape[-1] == 8 and table.dtype == REAL


def quad_fits(n_cls: int, n: int) -> bool:
    """Whether the quad table of n_cls cubes of n^3 stays near L2."""
    return 32 * n_cls * n ** 3 <= QUAD_TABLE_MAX_BYTES


def project_slices_plain(table: torch.Tensor, rot: torch.Tensor,
                         i_col: torch.Tensor, i_row: torch.Tensor, pf: int,
                         cls: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of HK1 (the JAX package's _gather_trilinear_3d
    arithmetic): table (K, n, n, n) complex64 or its quad table, rot
    (L, R, 3, 3), cls (L,) or None (class 0) -> (L, R, P) complex64."""
    if is_quad_table(table):
        table = torch.view_as_complex(table[..., :2])   # each cell's own tap
    n = table.shape[-1]
    c = n // 2
    fx = (i_col * pf).to(REAL)
    fy = (i_row * pf).to(REAL)
    x = rot[..., 0, 0:1] * fx + rot[..., 0, 1:2] * fy
    y = rot[..., 1, 0:1] * fx + rot[..., 1, 1:2] * fy
    z = rot[..., 2, 0:1] * fx + rot[..., 2, 1:2] * fy
    flx, fly, flz = torch.floor(x), torch.floor(y), torch.floor(z)
    wx, wy, wz = x - flx, y - fly, z - flz
    ix = flx.to(torch.int64) + c
    iy = fly.to(torch.int64) + c
    iz = flz.to(torch.int64) + c
    n_l = rot.shape[0]
    k = (torch.zeros(n_l, dtype=torch.int64, device=table.device)
         if cls is None else cls.to(torch.int64))
    vi = (k * n ** 3).reshape((n_l,) + (1,) * (x.ndim - 1))
    flat = table.reshape(-1)

    def tap(dz, dy, dx, w):
        xi = torch.clamp(ix + dx, 0, n - 1)
        yi = torch.clamp(iy + dy, 0, n - 1)
        zi = torch.clamp(iz + dz, 0, n - 1)
        return flat[vi + (zi * n + yi) * n + xi] * w

    out = tap(0, 0, 0, (1 - wz) * (1 - wy) * (1 - wx))
    out = out + tap(0, 0, 1, (1 - wz) * (1 - wy) * wx)
    out = out + tap(0, 1, 0, (1 - wz) * wy * (1 - wx))
    out = out + tap(0, 1, 1, (1 - wz) * wy * wx)
    out = out + tap(1, 0, 0, wz * (1 - wy) * (1 - wx))
    out = out + tap(1, 0, 1, wz * (1 - wy) * wx)
    out = out + tap(1, 1, 0, wz * wy * (1 - wx))
    out = out + tap(1, 1, 1, wz * wy * wx)
    return out.to(COMPLEX)


def project_slices(table: torch.Tensor, rot: torch.Tensor,
                   i_col: torch.Tensor, i_row: torch.Tensor, pf: int,
                   cls: torch.Tensor | None = None) -> torch.Tensor:
    """Trilinear central-slice gather: out[l, r, p] = sample of cube
    cls[l] at rot[l, r] . (pf i_col[p], pf i_row[p], 0).

    table (K, n, n, n) complex64 centered, or its :func:`quad_taps`
    table (K, n, n, n, 8) float32, which a caller with many launches on
    one table builds once (see :func:`quad_fits`); rot (L, R, 3, 3)
    float32 (an expanded leading dim of stride 0 shares one rotation
    block across images); cls (L,) or None; pixels (P,) int32 ->
    (L, R, P) complex64.  CPU tensors take :func:`project_slices_plain`;
    CUDA tensors launch csrc/project_slices.cu."""
    if not table.is_cuda:
        return project_slices_plain(table, rot, i_col, i_row, pf, cls)
    quad = is_quad_table(table)
    _native.require((quad or (table.ndim == 4 and table.dtype == COMPLEX))
                    and table.is_contiguous() and table.shape[1] ** 3 < 2 ** 31,
                    "project_slices: table must be contiguous (K, n, n, n) complex64 "
                    "or its (K, n, n, n, 8) float32 quad table")
    _native.require(rot.ndim == 4 and rot.shape[-2:] == (3, 3)
                    and rot.dtype == REAL,
                    "project_slices: rot must be (L, R, 3, 3) float32")
    if not rot[0].is_contiguous():
        rot = rot.contiguous()
    n_l, n_r = rot.shape[:2]
    n = table.shape[1]
    i_col = i_col.to(torch.int32).contiguous()
    i_row = i_row.to(torch.int32).contiguous()
    if cls is not None:
        cls = cls.to(torch.int32).contiguous()
        _native.require(cls.shape == (n_l,), "project_slices: cls must be (L,)")
    n_p = i_col.shape[0]
    out = torch.empty((n_l, n_r, n_p), dtype=COMPLEX, device=table.device)
    if out.numel() == 0:
        return out
    lib = _native.library()
    project_slices.launches += 1
    _native.check(lib.thunder_project_slices(
        table.data_ptr(), int(quad), n, None if cls is None else cls.data_ptr(),
        rot.data_ptr(), rot.stride(0), n_l, n_r, i_col.data_ptr(),
        i_row.data_ptr(), n_p, int(pf), out.data_ptr(),
        _native.stream_ptr(table)), "project_slices")
    return out


project_slices.launches = 0


def project_3d(proj: Projectee, rot: torch.Tensor,
               rings: PackedRings) -> torch.Tensor:
    """Central slices at packed pixels for rotations (R, 3, 3) -> (R, p)."""
    return project_slices(proj.ft[None], rot[None], rings.i_col, rings.i_row,
                          proj.pf)[0]


def project_classed(table: torch.Tensor, cls: torch.Tensor, rot: torch.Tensor,
                    rings: PackedRings, pf: int) -> torch.Tensor:
    """Per-image rotations (L, R, 3, 3) from each image's own class
    spectrum (K, n, n, n) -> (L, R, p)."""
    return project_slices(table, rot, rings.i_col, rings.i_row, pf, cls)


def project_full_3d(proj: Projectee, rot: torch.Tensor) -> torch.Tensor:
    """Central-slice projection to full centered 2D spectra:
    rot (B, 3, 3) -> (B, size, size), zero outside max_radius."""
    size = proj.size
    dev = proj.ft.device
    k = torch.arange(size, dtype=torch.int32, device=dev) - size // 2
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    vals = project_slices(proj.ft[None], rot[None], kx.reshape(-1),
                          ky.reshape(-1), proj.pf)[0]
    inside = (kx * kx + ky * ky < proj.max_radius ** 2).reshape(-1)
    vals = torch.where(inside, vals, torch.zeros_like(vals))
    return vals.reshape(rot.shape[:-2] + (size, size))


# -- HK5 ----------------------------------------------------------------

def project_slices_2d_plain(table: torch.Tensor, rot: torch.Tensor,
                            i_col: torch.Tensor, i_row: torch.Tensor, pf: int,
                            cls: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of HK5 (the JAX package's _gather_bilinear_2d_stack
    arithmetic): table (K, n, n) complex64, rot (L, R, 2, 2), cls (L,)
    or None (class 0) -> (L, R, P) complex64."""
    n = table.shape[-1]
    c = n // 2
    fx = (i_col * pf).to(REAL)
    fy = (i_row * pf).to(REAL)
    x = rot[..., 0, 0:1] * fx + rot[..., 0, 1:2] * fy
    y = rot[..., 1, 0:1] * fx + rot[..., 1, 1:2] * fy
    flx, fly = torch.floor(x), torch.floor(y)
    wx, wy = x - flx, y - fly
    ix = flx.to(torch.int64) + c
    iy = fly.to(torch.int64) + c
    n_l = rot.shape[0]
    k = (torch.zeros(n_l, dtype=torch.int64, device=table.device)
         if cls is None else cls.to(torch.int64))
    vi = (k * n * n).reshape((n_l,) + (1,) * (x.ndim - 1))
    flat = table.reshape(-1)

    def tap(dy, dx, w):
        xi = torch.clamp(ix + dx, 0, n - 1)
        yi = torch.clamp(iy + dy, 0, n - 1)
        return flat[vi + yi * n + xi] * w

    out = tap(0, 0, (1 - wy) * (1 - wx))
    out = out + tap(0, 1, (1 - wy) * wx)
    out = out + tap(1, 0, wy * (1 - wx))
    out = out + tap(1, 1, wy * wx)
    return out.to(COMPLEX)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.int32 and x.is_contiguous():
        return x
    return x.to(torch.int32).contiguous()


def project_slices_2d(table: torch.Tensor, rot: torch.Tensor,
                      i_col: torch.Tensor, i_row: torch.Tensor, pf: int,
                      cls: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear in-plane rotated resampling: out[l, r, p] = sample of
    plane cls[l] at rot[l, r] . (pf i_col[p], pf i_row[p]).

    table (K, n, n) complex64 centered; rot (L, R, 2, 2) float32 (an
    expanded leading dim of stride 0 shares one rotation block across
    images); cls (L,) or None; pixels (P,) int32 -> (L, R, P) complex64.
    CPU tensors take :func:`project_slices_2d_plain`; CUDA tensors launch
    csrc/project_slices_2d.cu."""
    if not table.is_cuda:
        return project_slices_2d_plain(table, rot, i_col, i_row, pf, cls)
    _native.require(table.ndim == 3 and table.dtype == COMPLEX
                    and table.is_contiguous() and table.shape[1] ** 2 < 2 ** 31,
                    "project_slices_2d: table must be contiguous (K, n, n) complex64")
    _native.require(rot.ndim == 4 and rot.shape[-2:] == (2, 2)
                    and rot.dtype == REAL,
                    "project_slices_2d: rot must be (L, R, 2, 2) float32")
    if not rot[0].is_contiguous():
        rot = rot.contiguous()
    n_l, n_r = rot.shape[:2]
    n = table.shape[1]
    i_col, i_row = _as_int32(i_col), _as_int32(i_row)
    if cls is not None:
        cls = _as_int32(cls)
        _native.require(cls.shape == (n_l,), "project_slices_2d: cls must be (L,)")
    n_p = i_col.shape[0]
    out = torch.empty((n_l, n_r, n_p), dtype=COMPLEX, device=table.device)
    if out.numel() == 0:
        return out
    lib = _native.library()
    project_slices_2d.launches += 1
    _native.check(lib.thunder_project_slices_2d(
        table.data_ptr(), n, None if cls is None else cls.data_ptr(),
        rot.data_ptr(), rot.stride(0), n_l, n_r, i_col.data_ptr(),
        i_row.data_ptr(), n_p, int(pf), out.data_ptr(),
        _native.stream_ptr(table)), "project_slices_2d")
    return out


project_slices_2d.launches = 0


def project_2d(proj: Projectee, rot: torch.Tensor,
               rings: PackedRings) -> torch.Tensor:
    """In-plane rotated resampling at packed pixels for rotations
    (R, 2, 2) -> (R, p)."""
    return project_slices_2d(proj.ft[None], rot[None], rings.i_col,
                             rings.i_row, proj.pf)[0]


def project_full_2d(proj: Projectee, rot: torch.Tensor) -> torch.Tensor:
    """Projection to full centered spectra: rot (B, 2, 2) ->
    (B, size, size), zero outside max_radius."""
    size = proj.size
    dev = proj.ft.device
    k = torch.arange(size, dtype=torch.int32, device=dev) - size // 2
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    vals = project_slices_2d(proj.ft[None], rot[None], kx.reshape(-1),
                             ky.reshape(-1), proj.pf)[0]
    inside = (kx * kx + ky * ky < proj.max_radius ** 2).reshape(-1)
    vals = torch.where(inside, vals, torch.zeros_like(vals))
    return vals.reshape(rot.shape[:-2] + (size, size))
