"""Weighted Fourier insertion (Reconstructor::insertP,
Reconstructor.cpp:569-866) — and the host of kernel HK3
(``insert_trilinear``).

Insertion accumulates w * ctf * dat into F and w * ctf^2 into T with
trilinear weights at rot . (pf i, pf j, 0) on a full centered grid.
The JAX package's 3D main path uses a scatter-free shear sweep shaped
by the TPU's slow scatter; on Hopper the natural form is the trilinear
atomicAdd scatter of the reference's CUDA backend, held to
``insert_slices_3d`` (the exact trilinear scatter) rather than to the
sweep, whose height hat is not trilinear (thunder_tpu/config.py:55-59).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import COMPLEX, REAL
from thunder_tpu_torch.ops.fourier import translate_phases_view
from thunder_tpu_torch.physics.ctf import CtfParams, ctf_packed, wavelength


def insert_slices_3d(f_grid: torch.Tensor, t_grid: torch.Tensor,
                     vals: torch.Tensor, ctf2w: torch.Tensor,
                     rot: torch.Tensor, i_col: torch.Tensor,
                     i_row: torch.Tensor, pf: int, max_radius_pad: float):
    """Trilinear scatter of slices into (F, T) (thunder_tpu
    ops/insert.py insert_slices_3d, trilinear kernel).

    f_grid (big,)*3 complex64 centered, t_grid float32; vals (..., p)
    complex, ctf2w (..., p), rot (..., 3, 3), pixels (p,).  Out-of-radius
    samples get zero weight.  Returns new (f_grid, t_grid)."""
    big = f_grid.shape[-1]
    c = big // 2
    fx = (i_col * pf).to(REAL)
    fy = (i_row * pf).to(REAL)
    x = rot[..., 0, 0:1] * fx + rot[..., 0, 1:2] * fy
    y = rot[..., 1, 0:1] * fx + rot[..., 1, 1:2] * fy
    z = rot[..., 2, 0:1] * fx + rot[..., 2, 1:2] * fy
    inside = (x * x + y * y + z * z) < max_radius_pad ** 2
    vals = torch.where(inside, vals, torch.zeros_like(vals)).reshape(-1)
    ctf2w = torch.where(inside, ctf2w, torch.zeros_like(ctf2w)).reshape(-1)
    x, y, z = x.reshape(-1), y.reshape(-1), z.reshape(-1)
    flx, fly, flz = torch.floor(x), torch.floor(y), torch.floor(z)
    wx, wy, wz = x - flx, y - fly, z - flz
    ix, iy, iz = (flx.to(torch.int64) + c, fly.to(torch.int64) + c,
                  flz.to(torch.int64) + c)
    g = torch.stack([f_grid.real.reshape(-1), f_grid.imag.reshape(-1),
                     t_grid.reshape(-1)], dim=-1).to(REAL)
    upd = torch.stack([vals.real, vals.imag, ctf2w.to(REAL)], dim=-1)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((wz if dz else 1 - wz) * (wy if dy else 1 - wy)
                     * (wx if dx else 1 - wx))
                xi = torch.clamp(ix + dx, 0, big - 1)
                yi = torch.clamp(iy + dy, 0, big - 1)
                zi = torch.clamp(iz + dz, 0, big - 1)
                g.index_add_(0, (zi * big + yi) * big + xi, upd * w[:, None])
    shape = (big,) * 3
    return (torch.complex(g[:, 0], g[:, 1]).reshape(shape),
            g[:, 2].reshape(shape))


def hermitianize(f_grid: torch.Tensor) -> torch.Tensor:
    """F <- F + conj(F(-k)) over the trailing 3 (centered, even) dims."""
    ax = (-3, -2, -1)
    flipped = torch.roll(torch.flip(f_grid, dims=ax), shifts=(1, 1, 1), dims=ax)
    return f_grid + flipped.conj()


def hermitianize_real(t_grid: torch.Tensor) -> torch.Tensor:
    ax = (-3, -2, -1)
    return t_grid + torch.roll(torch.flip(t_grid, dims=ax), shifts=(1, 1, 1),
                               dims=ax)


# -- HK3 ----------------------------------------------------------------

def ctf_constants(params: CtfParams) -> torch.Tensor:
    """Per-image CTF constants (L, 8): [pi lambda, pi/2 Cs lambda^3, w1,
    w2, defocus_u, defocus_v, defocus_theta, phase_shift] — the factors
    ctf_packed evaluates, computed once per image for the kernel."""
    lam = wavelength(params.voltage)
    w2 = params.amplitude_contrast
    return torch.stack([math.pi * lam, math.pi / 2 * params.cs * lam ** 3,
                        torch.sqrt(1 - w2 * w2), w2, params.defocus_u,
                        params.defocus_v, params.defocus_theta,
                        params.phase_shift], dim=-1).to(REAL).contiguous()


def dense_window(r_u: int, device=None):
    """Dense (vc, vr) pixels of the nk x nk window, nk = 2 r_u - 1, and
    the insertion mask: |k| < r_u - 1 (the padded-radius cut) with the
    DC doubled, as the half-space insertion + Hermitian fold counts it
    (optimiser.py:1441-1452)."""
    nk = 2 * r_u - 1
    kk = torch.arange(nk, dtype=torch.int32, device=device) - (r_u - 1)
    ky, kx = torch.meshgrid(kk, kk, indexing="ij")
    vc, vr = kx.reshape(-1), ky.reshape(-1)
    q2 = (vc * vc + vr * vr).to(REAL)
    mask_d = (q2 < (r_u - 1) ** 2).to(REAL) * torch.where(q2 == 0, 2.0, 1.0)
    return vc, vr, mask_d


def dense_slice_values(ft: torch.Tensor, ctf: CtfParams, img_idx, trans,
                       w, r_u: int, size: int, pixel_size: float):
    """The value formation HK3 fuses: (vals (B, nk^2) complex,
    ctf2w (B, nk^2), vc, vr) for slices of images img_idx with
    translations trans (B, 2) and weights w (B,)."""
    vc, vr, mask_d = dense_window(r_u, ft.device)
    c = size // 2
    idx = img_idx.long()
    dat = ft[idx][:, (c + vr).long(), (c + vc).long()]
    tra = translate_phases_view(vc, vr, size, trans)
    ct = ctf_packed(ctf.map(lambda f: f[idx]), vc, vr, size, pixel_size)
    vals = dat * tra.conj() * (ct * mask_d) * w[:, None]
    ctf2w = ct * ct * mask_d * w[:, None]
    return vals, ctf2w, vc, vr


def insert_trilinear_plain(ft, ctf, img_idx, rot, trans, w, r_u: int,
                           pf: int, size: int, pixel_size: float,
                           f_grid: torch.Tensor, t_grid: torch.Tensor):
    """Plain version of HK3: value formation then the exact trilinear
    scatter, 256 slices at a time (bounds the dense temporaries).
    Returns the new (F, T)."""
    max_rad = float((r_u - 1) * pf)
    for lo in range(0, rot.shape[0], 256):
        sl = slice(lo, lo + 256)
        vals, c2w, vc, vr = dense_slice_values(
            ft, ctf, img_idx[sl], trans[sl], w[sl], r_u, size, pixel_size)
        f_grid, t_grid = insert_slices_3d(f_grid, t_grid, vals, c2w,
                                          rot[sl], vc, vr, pf, max_rad)
    return f_grid, t_grid


def insert_trilinear(ft: torch.Tensor, ctf: CtfParams, img_idx: torch.Tensor,
                     rot: torch.Tensor, trans: torch.Tensor, w: torch.Tensor,
                     r_u: int, pf: int, size: int, pixel_size: float,
                     big: int, f_grid: torch.Tensor | None = None,
                     t_grid: torch.Tensor | None = None):
    """Insert B compacted slices into (F, T) (big^3, centered), forming
    each dense-window value in place (see :func:`dense_slice_values`).

    ft (L, size, size) complex64 image spectra; ctf fields (L,);
    img_idx (B,) image of each slice; rot (B, 3, 3); trans (B, 2)
    against the original images; w (B,) slice weights.  Accumulates into
    the given grids (zeros when None) and returns them.  CPU tensors take
    :func:`insert_trilinear_plain`; CUDA tensors launch
    csrc/insert_trilinear.cu, whose atomics add in a run-dependent
    order."""
    dev = ft.device
    if f_grid is None:
        f_grid = torch.zeros((big,) * 3, dtype=COMPLEX, device=dev)
    if t_grid is None:
        t_grid = torch.zeros((big,) * 3, dtype=REAL, device=dev)
    if not ft.is_cuda:
        return insert_trilinear_plain(ft, ctf, img_idx, rot, trans, w, r_u,
                                      pf, size, pixel_size, f_grid, t_grid)
    _native.require(ft.dtype == COMPLEX and ft.is_contiguous()
                    and ft.shape[-2:] == (size, size),
                    "insert_trilinear: ft must be contiguous (L, size, size) complex64")
    _native.require(f_grid.shape == (big,) * 3 and f_grid.dtype == COMPLEX
                    and f_grid.is_contiguous() and t_grid.is_contiguous()
                    and t_grid.dtype == REAL,
                    "insert_trilinear: grids must be contiguous big^3")
    n_s = rot.shape[0]
    _native.require(2 * r_u - 1 <= size,
                    "insert_trilinear: window exceeds the image box")
    ctfk = ctf_constants(ctf)
    img_idx = img_idx.to(torch.int32).contiguous()
    rot = rot.to(REAL).reshape(n_s, 9).contiguous()
    trans = trans.to(REAL).contiguous()
    w = w.to(REAL).contiguous()
    if n_s == 0:
        return f_grid, t_grid
    lib = _native.library()
    insert_trilinear.launches += 1
    _native.check(lib.thunder_insert_trilinear(
        ft.data_ptr(), size, ctfk.data_ptr(), img_idx.data_ptr(),
        rot.data_ptr(), trans.data_ptr(), w.data_ptr(), n_s, r_u, pf,
        float((r_u - 1) * pf), float(pixel_size * size),
        float(2 * np.pi / size), f_grid.data_ptr(), t_grid.data_ptr(), big,
        _native.stream_ptr(ft)), "insert_trilinear")
    return f_grid, t_grid


insert_trilinear.launches = 0
