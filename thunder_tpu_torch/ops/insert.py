"""Weighted Fourier insertion (Reconstructor::insertP,
Reconstructor.cpp:569-866) — and the host of kernels HK3
(``insert_trilinear``, 3D) and HK6 (``insert_bilinear_2d``, per-class
2D planes).

Insertion accumulates w * ctf * dat into F and w * ctf^2 into T with
trilinear weights at rot . (pf i, pf j, 0) on a full centered grid.
The JAX package's 3D main path uses a scatter-free shear sweep shaped
by the TPU's slow scatter; the port computes the exact trilinear (2D:
bilinear) scatter ``insert_slices_3d`` (``insert_slices_2d``), not the
sweep, whose height hat is not trilinear (thunder_tpu/config.py:55-59).
The insertion option ``reco_kernel="mkb"`` spreads each sample over the
modified Kaiser-Bessel blob instead (``insert_slices_3d(kernel="mkb")``,
Reconstructor.cpp:424-567), HK10 ``insert_mkb`` on the card.
On the card HK3, HK6, HK9 and HK10 compute these as gathers: each grid
cell walks the slices that can reach it in a fixed order and forms its
own sum, so two calls give identical bits.  The ``*_gather_plain``
functions emulate that cell-owned enumeration on the CPU (tests).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.constants import DEFAULT_MKB_A, DEFAULT_MKB_ALPHA
from thunder_tpu_torch.device import COMPLEX, REAL
from thunder_tpu_torch.ops.fourier import translate_phases_view
from thunder_tpu_torch.physics.ctf import (CtfParams, ctf_constants,
                                           ctf_packed, ctf_packed_scaled)
from thunder_tpu_torch.physics.kernels import mkb_ft


def _mkb_taps(x, y, z, a: float, alpha: float):
    """The taps of the MKB blob, (dz, dy, dx, weight) for the 4^3
    neighbourhood floor - 1 ... floor + 2 of each sample: MKB_FT(r) where
    r^2 = |tap - sample|^2 < a^2, else 0 (thunder_tpu ops/insert.py
    _mkb_taps; a <= 2 keeps the blob inside the neighbourhood)."""
    flx, fly, flz = torch.floor(x), torch.floor(y), torch.floor(z)
    for dz in (-1, 0, 1, 2):
        for dy in (-1, 0, 1, 2):
            for dx in (-1, 0, 1, 2):
                r2 = (flx + dx - x) ** 2 + (fly + dy - y) ** 2 + (flz + dz - z) ** 2
                r = torch.sqrt(torch.clamp(r2, min=0.0))
                w = torch.where(r2 < a * a, mkb_ft(r, a, alpha), torch.zeros_like(r))
                yield dz, dy, dx, w


def insert_slices_3d(f_grid: torch.Tensor, t_grid: torch.Tensor,
                     vals: torch.Tensor, ctf2w: torch.Tensor,
                     rot: torch.Tensor, i_col: torch.Tensor,
                     i_row: torch.Tensor, pf: int, max_radius_pad: float,
                     kernel: str = "trilinear", a: float = DEFAULT_MKB_A,
                     alpha: float = DEFAULT_MKB_ALPHA):
    """Scatter of slices into (F, T) (thunder_tpu ops/insert.py
    insert_slices_3d): ``kernel`` "trilinear" (8 taps) or "mkb" (the
    blob's 4^3 taps, :func:`_mkb_taps`), tap indices clipped to the grid.

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
    ix, iy, iz = (flx.to(torch.int64) + c, fly.to(torch.int64) + c,
                  flz.to(torch.int64) + c)
    if kernel == "mkb":
        taps = _mkb_taps(x, y, z, a, alpha)
    else:
        wx, wy, wz = x - flx, y - fly, z - flz
        taps = ((dz, dy, dx, (wz if dz else 1 - wz) * (wy if dy else 1 - wy)
                 * (wx if dx else 1 - wx))
                for dz in (0, 1) for dy in (0, 1) for dx in (0, 1))
    g = torch.stack([f_grid.real.reshape(-1), f_grid.imag.reshape(-1),
                     t_grid.reshape(-1)], dim=-1).to(REAL)
    upd = torch.stack([vals.real, vals.imag, ctf2w.to(REAL)], dim=-1)
    for dz, dy, dx, w in taps:
        xi = torch.clamp(ix + dx, 0, big - 1)
        yi = torch.clamp(iy + dy, 0, big - 1)
        zi = torch.clamp(iz + dz, 0, big - 1)
        g.index_add_(0, (zi * big + yi) * big + xi, upd * w[:, None])
    shape = (big,) * 3
    return (torch.complex(g[:, 0], g[:, 1]).reshape(shape),
            g[:, 2].reshape(shape))


def insert_slices_2d(f_grid: torch.Tensor, t_grid: torch.Tensor,
                     vals: torch.Tensor, ctf2w: torch.Tensor,
                     rot: torch.Tensor, i_col: torch.Tensor,
                     i_row: torch.Tensor, pf: int, max_radius_pad: float,
                     cls: torch.Tensor | None = None):
    """Bilinear scatter of slices into per-class (F, T) planes
    (thunder_tpu ops/insert.py insert_slices_2d, one plane per class).

    f_grid (K, big, big) complex64 centered, t_grid float32; vals
    (B, p) complex, ctf2w (B, p), rot (B, 2, 2), pixels (p,), cls (B,)
    the plane of each slice (None: plane 0).  Out-of-radius samples get
    zero weight.  Returns new (f_grid, t_grid)."""
    n_cls, big = f_grid.shape[0], f_grid.shape[-1]
    c = big // 2
    fx = (i_col * pf).to(REAL)
    fy = (i_row * pf).to(REAL)
    x = rot[..., 0, 0:1] * fx + rot[..., 0, 1:2] * fy
    y = rot[..., 1, 0:1] * fx + rot[..., 1, 1:2] * fy
    inside = (x * x + y * y) < max_radius_pad ** 2
    vals = torch.where(inside, vals, torch.zeros_like(vals)).reshape(-1)
    ctf2w = torch.where(inside, ctf2w, torch.zeros_like(ctf2w)).reshape(-1)
    k = (torch.zeros(rot.shape[0], dtype=torch.int64, device=rot.device)
         if cls is None else cls.to(torch.int64))
    base = (k[:, None] * big * big).expand(x.shape).reshape(-1)
    x, y = x.reshape(-1), y.reshape(-1)
    flx, fly = torch.floor(x), torch.floor(y)
    wx, wy = x - flx, y - fly
    ix, iy = flx.to(torch.int64) + c, fly.to(torch.int64) + c
    g = torch.stack([f_grid.real.reshape(-1), f_grid.imag.reshape(-1),
                     t_grid.reshape(-1)], dim=-1).to(REAL)
    upd = torch.stack([vals.real, vals.imag, ctf2w.to(REAL)], dim=-1)
    for dy in (0, 1):
        for dx in (0, 1):
            w = (wy if dy else 1 - wy) * (wx if dx else 1 - wx)
            xi = torch.clamp(ix + dx, 0, big - 1)
            yi = torch.clamp(iy + dy, 0, big - 1)
            g.index_add_(0, base + yi * big + xi, upd * w[:, None])
    shape = (n_cls, big, big)
    return (torch.complex(g[:, 0], g[:, 1]).reshape(shape),
            g[:, 2].reshape(shape))


def hermitianize(f_grid: torch.Tensor, nd: int = 3) -> torch.Tensor:
    """F <- F + conj(F(-k)) over the trailing ``nd`` (centered, even)
    dims."""
    ax = tuple(range(-nd, 0))
    flipped = torch.roll(torch.flip(f_grid, dims=ax), shifts=(1,) * nd, dims=ax)
    return f_grid + flipped.conj()


def hermitianize_real(t_grid: torch.Tensor, nd: int = 3) -> torch.Tensor:
    ax = tuple(range(-nd, 0))
    return t_grid + torch.roll(torch.flip(t_grid, dims=ax), shifts=(1,) * nd,
                               dims=ax)


# -- HK3 ----------------------------------------------------------------

def tap_range(big: int, max_radius_pad: float, kernel: str = "trilinear") -> tuple:
    """(lowest, highest) index a trilinear or bilinear tap (with
    ``kernel="mkb"``, a blob's tap, floor - 1 ... floor + 2) of a sample
    at |p| < max_radius_pad can take before it is clipped to [0, big -
    1]; outside [0, big - 1] the gathers' face cells also take those
    taps."""
    m = math.ceil(max_radius_pad) + (1 if kernel == "mkb" else 0)
    return big // 2 - m - 1, big // 2 + m + 1

def dense_window(r_u: int, device=None, edge: bool = False):
    """Dense (vc, vr) pixels of the nk x nk window, nk = 2 r_u - 1, and
    the insertion mask: |k| < r_u - 1 (the padded-radius cut) with the
    DC doubled, as the half-space insertion + Hermitian fold counts it
    (optimiser.py:1441-1452).  ``edge`` (the MKB option) also keeps the
    pixels on the circle |k| = r_u - 1: thunder_tpu's MKB path takes
    packed rings (|k| < r_u), and the scatter's float test |p| <
    max_radius_pad keeps or drops each of those as its rotated position
    rounds (optimiser.py:1391, ops/insert.py:110)."""
    nk = 2 * r_u - 1
    kk = torch.arange(nk, dtype=torch.int32, device=device) - (r_u - 1)
    ky, kx = torch.meshgrid(kk, kk, indexing="ij")
    vc, vr = kx.reshape(-1), ky.reshape(-1)
    q2 = (vc * vc + vr * vr).to(REAL)
    keep = q2 <= (r_u - 1) ** 2 if edge else q2 < (r_u - 1) ** 2
    mask_d = keep.to(REAL) * torch.where(q2 == 0, 2.0, 1.0)
    return vc, vr, mask_d


def dense_slice_values(ft: torch.Tensor, ctf: CtfParams, img_idx, trans,
                       w, r_u: int, size: int, pixel_size: float, d=None,
                       edge: bool = False):
    """The value formation HK3 fuses: (vals (B, nk^2) complex,
    ctf2w (B, nk^2), vc, vr) for slices of images img_idx with
    translations trans (B, 2), weights w (B,) and, where given, defocus
    factors d (B,) scaling each slice's CTF (ctf_packed_scaled);
    ``edge``: the window of :func:`dense_window` with its edge (HK10)."""
    vc, vr, mask_d = dense_window(r_u, ft.device, edge)
    c = size // 2
    idx = img_idx.long()
    dat = ft[idx][:, (c + vr).long(), (c + vc).long()]
    tra = translate_phases_view(vc, vr, size, trans)
    ctf_s = ctf.map(lambda f: f[idx])
    ct = (ctf_packed(ctf_s, vc, vr, size, pixel_size) if d is None else
          ctf_packed_scaled(ctf_s, vc, vr, size, pixel_size, d[:, None])[:, 0])
    vals = dat * tra.conj() * (ct * mask_d) * w[:, None]
    ctf2w = ct * ct * mask_d * w[:, None]
    return vals, ctf2w, vc, vr


def insert_trilinear_plain(ft, ctf, img_idx, rot, trans, w, r_u: int,
                           pf: int, size: int, pixel_size: float,
                           f_grid: torch.Tensor, t_grid: torch.Tensor, d=None):
    """Plain version of HK3: value formation then the exact trilinear
    scatter, 256 slices at a time (bounds the dense temporaries).
    Returns the new (F, T)."""
    max_rad = float((r_u - 1) * pf)
    for lo in range(0, rot.shape[0], 256):
        sl = slice(lo, lo + 256)
        vals, c2w, vc, vr = dense_slice_values(
            ft, ctf, img_idx[sl], trans[sl], w[sl], r_u, size, pixel_size,
            None if d is None else d[sl])
        f_grid, t_grid = insert_slices_3d(f_grid, t_grid, vals, c2w,
                                          rot[sl], vc, vr, pf, max_rad)
    return f_grid, t_grid


def insert_trilinear(ft: torch.Tensor, ctf: CtfParams, img_idx: torch.Tensor,
                     rot: torch.Tensor, trans: torch.Tensor, w: torch.Tensor,
                     r_u: int, pf: int, size: int, pixel_size: float,
                     big: int, f_grid: torch.Tensor | None = None,
                     t_grid: torch.Tensor | None = None,
                     d: torch.Tensor | None = None):
    """Insert B compacted slices into (F, T) (big^3, centered), forming
    each dense-window value in place (see :func:`dense_slice_values`).

    ft (L, size, size) complex64 image spectra; ctf fields (L,);
    img_idx (B,) image of each slice; rot (B, 3, 3); trans (B, 2)
    against the original images; w (B,) slice weights; d (B,) defocus
    factors scaling each slice's CTF (None: 1).  Accumulates into
    the given grids (zeros when None) and returns them.  CPU tensors take
    :func:`insert_trilinear_plain`; CUDA tensors launch
    csrc/insert_trilinear.cu, a gather in which each cell forms its sum
    in slice order (two calls give identical bits), after a first pass
    that forms the dense window's values into a (B, nk^2, 4) scratch of
    (Re, Im, c2w, 0) records allocated here."""
    dev = ft.device
    if f_grid is None:
        f_grid = torch.zeros((big,) * 3, dtype=COMPLEX, device=dev)
    if t_grid is None:
        t_grid = torch.zeros((big,) * 3, dtype=REAL, device=dev)
    if not ft.is_cuda:
        f_new, t_new = insert_trilinear_plain(ft, ctf, img_idx, rot, trans, w,
                                              r_u, pf, size, pixel_size,
                                              f_grid, t_grid, d)
        f_grid.copy_(f_new)
        t_grid.copy_(t_new)
        return f_grid, t_grid
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
    if d is not None:
        d = d.to(REAL).contiguous()
        _native.require(d.shape == (n_s,), "insert_trilinear: d must be (B,)")
    if n_s == 0:
        return f_grid, t_grid
    mrp = float((r_u - 1) * pf)
    vlo, vhi = tap_range(big, mrp)
    vals = torch.empty((n_s, (2 * r_u - 1) ** 2, 4), dtype=REAL, device=dev)
    lib = _native.library()
    insert_trilinear.launches += 1
    _native.check(lib.thunder_insert_trilinear(
        ft.data_ptr(), size, ctfk.data_ptr(), img_idx.data_ptr(),
        rot.data_ptr(), trans.data_ptr(), w.data_ptr(),
        None if d is None else d.data_ptr(), n_s, r_u, pf, mrp,
        float(pixel_size * size), float(2 * np.pi / size), f_grid.data_ptr(),
        t_grid.data_ptr(), vals.data_ptr(), big, vlo, vhi,
        _native.stream_ptr(ft)), "insert_trilinear")
    return f_grid, t_grid


insert_trilinear.launches = 0


# -- HK10 ---------------------------------------------------------------

def insert_mkb_plain(ft, ctf, img_idx, rot, trans, w, r_u: int, pf: int, size: int,
                     pixel_size: float, f_grid: torch.Tensor, t_grid: torch.Tensor,
                     d=None, a: float = DEFAULT_MKB_A, alpha: float = DEFAULT_MKB_ALPHA):
    """Plain version of HK10: HK3's value formation then the MKB blob's
    scatter (:func:`insert_slices_3d` with ``kernel="mkb"``), 256 slices
    at a time.  Returns the new (F, T)."""
    max_rad = float((r_u - 1) * pf)
    for lo in range(0, rot.shape[0], 256):
        sl = slice(lo, lo + 256)
        vals, c2w, vc, vr = dense_slice_values(
            ft, ctf, img_idx[sl], trans[sl], w[sl], r_u, size, pixel_size,
            None if d is None else d[sl], edge=True)
        f_grid, t_grid = insert_slices_3d(f_grid, t_grid, vals, c2w, rot[sl], vc, vr, pf,
                                          max_rad, "mkb", a, alpha)
    return f_grid, t_grid


def insert_mkb(ft: torch.Tensor, ctf: CtfParams, img_idx: torch.Tensor,
               rot: torch.Tensor, trans: torch.Tensor, w: torch.Tensor,
               r_u: int, pf: int, size: int, pixel_size: float,
               big: int, f_grid: torch.Tensor | None = None,
               t_grid: torch.Tensor | None = None,
               d: torch.Tensor | None = None, a: float = DEFAULT_MKB_A,
               alpha: float = DEFAULT_MKB_ALPHA):
    """HK10: :func:`insert_trilinear` with the modified Kaiser-Bessel
    blob in place of the trilinear hat (the insertion option
    ``reco_kernel="mkb"``, thunder_tpu ops/insert.py insert_slices_3d
    with kernel="mkb").  A sample at p adds val MKB_FT(|k - p|) to every
    cell k of its 4^3 neighbourhood with |k - p| < a (tap indices
    clipped to the grid); the values are HK3's dense window with its edge
    (:func:`dense_window`: the pixels thunder_tpu's packed half-space
    rings and Hermitian fold insert, the DC doubled).  Same arguments as
    :func:`insert_trilinear` and ``a`` <= 2, ``alpha``.  CPU tensors
    take :func:`insert_mkb_plain`; CUDA tensors launch
    csrc/insert_trilinear.cu's gather with the blob's weight, each cell
    summing in slice order (two calls give identical bits)."""
    dev = ft.device
    if f_grid is None:
        f_grid = torch.zeros((big,) * 3, dtype=COMPLEX, device=dev)
    if t_grid is None:
        t_grid = torch.zeros((big,) * 3, dtype=REAL, device=dev)
    if not ft.is_cuda:
        f_new, t_new = insert_mkb_plain(ft, ctf, img_idx, rot, trans, w, r_u, pf, size,
                                        pixel_size, f_grid, t_grid, d, a, alpha)
        f_grid.copy_(f_new)
        t_grid.copy_(t_new)
        return f_grid, t_grid
    _native.require(ft.dtype == COMPLEX and ft.is_contiguous()
                    and ft.shape[-2:] == (size, size),
                    "insert_mkb: ft must be contiguous (L, size, size) complex64")
    _native.require(f_grid.shape == (big,) * 3 and f_grid.dtype == COMPLEX
                    and f_grid.is_contiguous() and t_grid.is_contiguous()
                    and t_grid.dtype == REAL,
                    "insert_mkb: grids must be contiguous big^3")
    _native.require(2 * r_u - 1 <= size, "insert_mkb: window exceeds the image box")
    _native.require(0 < a <= 2, "insert_mkb: the blob's radius must lie in (0, 2]")
    n_s = rot.shape[0]
    ctfk = ctf_constants(ctf)
    img_idx = img_idx.to(torch.int32).contiguous()
    rot = rot.to(REAL).reshape(n_s, 9).contiguous()
    trans = trans.to(REAL).contiguous()
    w = w.to(REAL).contiguous()
    if d is not None:
        d = d.to(REAL).contiguous()
        _native.require(d.shape == (n_s,), "insert_mkb: d must be (B,)")
    if n_s == 0:
        return f_grid, t_grid
    mrp = float((r_u - 1) * pf)
    vlo, vhi = tap_range(big, mrp, "mkb")
    vals = torch.empty((n_s, (2 * r_u - 1) ** 2, 4), dtype=REAL, device=dev)
    # the blob's constants as the plain version rounds them: a^2 in
    # float32, 1 / I0(alpha) from torch's float32 I0
    a2 = float(np.float32(a * a))
    inv_i0 = float(1.0 / torch.special.i0(torch.tensor(float(alpha), dtype=REAL)))
    lib = _native.library()
    insert_mkb.launches += 1
    _native.check(lib.thunder_insert_mkb(
        ft.data_ptr(), size, ctfk.data_ptr(), img_idx.data_ptr(),
        rot.data_ptr(), trans.data_ptr(), w.data_ptr(),
        None if d is None else d.data_ptr(), n_s, r_u, pf, mrp,
        float(pixel_size * size), float(2 * np.pi / size), f_grid.data_ptr(),
        t_grid.data_ptr(), vals.data_ptr(), big, vlo, vhi, float(a), a2,
        float(alpha), inv_i0, _native.stream_ptr(ft)), "insert_mkb")
    return f_grid, t_grid


insert_mkb.launches = 0


# -- HK6 ----------------------------------------------------------------

# the kernel's compile-time constants, read from its source: a block's
# tile of cells (a thread a cell), slices staged at once
INSERT_2D_TILE_X, INSERT_2D_TILE_Y, INSERT_2D_BATCH = (
    _native.csrc_constant("insert_bilinear_2d.cu", n) for n in ("TILE_X", "TILE_Y", "BATCH"))
INSERT_2D_THREADS = INSERT_2D_TILE_X * INSERT_2D_TILE_Y


def insert_bilinear_2d_plain(ft, ctf, img_idx, cls, rot, trans, w, r_u: int,
                             pf: int, size: int, pixel_size: float,
                             f_grid: torch.Tensor, t_grid: torch.Tensor):
    """Plain version of HK6: the dense-window value formation of HK3
    then the exact bilinear scatter into plane cls[s], 256 slices at a
    time.  Returns the new (F, T)."""
    max_rad = float((r_u - 1) * pf)
    for lo in range(0, rot.shape[0], 256):
        sl = slice(lo, lo + 256)
        vals, c2w, vc, vr = dense_slice_values(
            ft, ctf, img_idx[sl], trans[sl], w[sl], r_u, size, pixel_size)
        f_grid, t_grid = insert_slices_2d(f_grid, t_grid, vals, c2w, rot[sl],
                                          vc, vr, pf, max_rad, cls[sl])
    return f_grid, t_grid


def insert_window(big: int, max_radius_pad: float) -> tuple:
    """(first index, width) of the square of plane cells a bilinear tap
    at |x|, |y| < max_radius_pad can reach (indices clipped to the
    plane)."""
    lo, hi = tap_range(big, max_radius_pad)
    lo = max(0, lo)
    return lo, min(big, hi + 1) - lo


def in_disc_pixels(r_u: int, device=None) -> torch.Tensor:
    """The dense-window pixels HK3 and HK6 insert (|k| < r_u - 1, the
    mask of :func:`dense_window`) as flat window indices (vr + r_u - 1)
    nk + (vc + r_u - 1), int32."""
    return torch.nonzero(dense_window(r_u, device)[2] > 0)[:, 0].to(torch.int32)


def insert_2d_work(img_idx: torch.Tensor, cls: torch.Tensor, n_class: int):
    """HK6's order of work: (order, cls_start).  ``order`` sorts the
    slices by (class, image), stably; class k's slices are
    order[cls_start[k]:cls_start[k + 1]] (cls_start (n_class + 1,)
    int32).  Each plane cell sums its class's slices in that order."""
    img, k = img_idx.long(), cls.long()
    order = torch.argsort(k * (img.max() + 1) + img, stable=True)
    bounds = torch.searchsorted(k[order], torch.arange(n_class + 1, device=k.device))
    return order, bounds.to(torch.int32)


def insert_2d_plan(r_u: int, pf: int, big: int) -> dict:
    """HK6's launch plan: the window of plane cells (first index, width)
    and the tiles that cover it, the range of indices a tap can take
    (faces gather what lies past them), and the shared-memory bytes of
    a staged batch (two ramp tables of nk entries, a rotation, a weight
    and an image a slice)."""
    mrp = float((r_u - 1) * pf)
    win_lo, win = insert_window(big, mrp)
    vlo, vhi = tap_range(big, mrp)
    nk = 2 * r_u - 1
    return dict(win_lo=win_lo, win=win, vlo=vlo, vhi=vhi,
                tiles=-(-win // INSERT_2D_TILE_X) * -(-win // INSERT_2D_TILE_Y),
                smem=INSERT_2D_BATCH * (16 * nk + 24))


def insert_bilinear_2d(ft: torch.Tensor, ctf: CtfParams, img_idx: torch.Tensor,
                       cls: torch.Tensor, rot: torch.Tensor,
                       trans: torch.Tensor, w: torch.Tensor, r_u: int,
                       pf: int, size: int, pixel_size: float, big: int,
                       n_class: int, f_grid: torch.Tensor | None = None,
                       t_grid: torch.Tensor | None = None):
    """Insert B compacted 2D slices into per-class (F, T) planes (K, big,
    big), centered, forming each dense-window value in place (see
    :func:`dense_slice_values`).

    ft (L, size, size) complex64 image spectra; ctf fields (L,);
    img_idx (B,) image of each slice; cls (B,) its class plane; rot
    (B, 2, 2); trans (B, 2) against the original images; w (B,) slice
    weights.  The dense window holds k and -k, so no Hermitian fold
    follows.  Accumulates into the given planes (zeros when None) and
    returns them.  CPU tensors take :func:`insert_bilinear_2d_plain`;
    CUDA tensors launch csrc/insert_bilinear_2d.cu: a first pass forms
    every image's values into an (L, nk^2, 4) scratch allocated here, then
    each plane cell sums its class's slices in the order of
    :func:`insert_2d_work` (two calls give identical bits)."""
    dev = ft.device
    if f_grid is None:
        f_grid = torch.zeros((n_class, big, big), dtype=COMPLEX, device=dev)
    if t_grid is None:
        t_grid = torch.zeros((n_class, big, big), dtype=REAL, device=dev)
    if not ft.is_cuda:
        return insert_bilinear_2d_plain(ft, ctf, img_idx, cls, rot, trans, w,
                                        r_u, pf, size, pixel_size, f_grid,
                                        t_grid)
    _native.require(ft.dtype == COMPLEX and ft.is_contiguous()
                    and ft.shape[-2:] == (size, size),
                    "insert_bilinear_2d: ft must be contiguous (L, size, size) complex64")
    _native.require(f_grid.shape == (n_class, big, big) and f_grid.dtype == COMPLEX
                    and f_grid.is_contiguous() and t_grid.is_contiguous()
                    and t_grid.shape == (n_class, big, big) and t_grid.dtype == REAL,
                    "insert_bilinear_2d: planes must be contiguous (K, big, big)")
    _native.require(2 * r_u - 1 <= size,
                    "insert_bilinear_2d: window exceeds the image box")
    n_s = rot.shape[0]
    if n_s == 0:
        return f_grid, t_grid
    _native.require(0 <= int(cls.min()) and int(cls.max()) < n_class,
                    "insert_bilinear_2d: a class index is past the planes")
    order, cls_start = insert_2d_work(img_idx, cls, n_class)
    plan = insert_2d_plan(r_u, pf, big)
    _native.require(plan["smem"] <= _native.SMEM_MAX,
                    "insert_bilinear_2d: a batch's ramp tables exceed shared memory")
    ctfk = ctf_constants(ctf)
    n_img, nk2 = ft.shape[0], (2 * r_u - 1) ** 2
    recs = torch.empty((n_img, nk2, 4), dtype=REAL, device=dev)
    img_idx = img_idx[order].to(torch.int32).contiguous()
    rot = rot[order].to(REAL).reshape(n_s, 4).contiguous()
    trans = trans[order].to(REAL).contiguous()
    w = w[order].to(REAL).contiguous()
    lib = _native.library()
    insert_bilinear_2d.launches += 1
    _native.check(lib.thunder_insert_bilinear_2d(
        ft.data_ptr(), size, ctfk.data_ptr(), n_img, img_idx.data_ptr(),
        cls_start.data_ptr(), n_class, rot.data_ptr(), trans.data_ptr(), w.data_ptr(), r_u,
        pf, float((r_u - 1) * pf), float(pixel_size * size), float(2 * np.pi / size),
        f_grid.data_ptr(), t_grid.data_ptr(), recs.data_ptr(), big,
        plan["win_lo"], plan["win"], plan["vlo"], plan["vhi"], INSERT_2D_THREADS,
        plan["smem"], _native.stream_ptr(ft)), "insert_bilinear_2d")
    return f_grid, t_grid


insert_bilinear_2d.launches = 0


# -- HK9 ----------------------------------------------------------------

INSERT_SLAB_MAX_SYM = _native.csrc_constant("insert_trilinear.cu", "MAX_SYM")

def insert_trilinear_slab_plain(vals: torch.Tensor, ctf2w: torch.Tensor, rot: torch.Tensor,
                                cls: torch.Tensor, r_u: int, pf: int, sym_mats: torch.Tensor,
                                f_slab: torch.Tensor, t_slab: torch.Tensor, z0: int):
    """Plain version of HK9 (see :func:`insert_trilinear_slab`), 256
    slices at a time.  Returns the new (F, T) slabs."""
    n_cls, bz, big = f_slab.shape[0], f_slab.shape[1], f_slab.shape[-1]
    c = big // 2
    r2 = float((r_u - 1) * pf) ** 2
    vc, vr, _ = dense_window(r_u, vals.device)
    fx, fy = (vc * pf).to(REAL), (vr * pf).to(REAL)
    mats = sym_mats.to(device=vals.device, dtype=REAL)
    g = torch.stack([f_slab.real.reshape(-1), f_slab.imag.reshape(-1),
                     t_slab.reshape(-1)], dim=-1).to(REAL)
    for lo in range(0, rot.shape[0], 256):
        sl = slice(lo, lo + 256)
        v, cw = vals[sl], ctf2w[sl].to(REAL)
        base = cls[sl].long()[:, None] * (bz * big * big)
        upd = torch.stack([v.real, v.imag, cw], dim=-1).reshape(-1, 3)
        pos = rot[sl].to(REAL)[..., :, 0:1] * fx + rot[sl].to(REAL)[..., :, 1:2] * fy
        inside = (pos * pos).sum(-2) < r2                               # (b, p)
        for m, mat in enumerate(mats):
            x, y, z = torch.einsum("ij,bjp->ibp", mat, pos)
            flx, fly, flz = torch.floor(x), torch.floor(y), torch.floor(z)
            wx, wy, wz = x - flx, y - fly, z - flz
            ix, iy, iz = (flx.to(torch.int64) + c, fly.to(torch.int64) + c,
                          flz.to(torch.int64) + c)
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        w = ((wz if dz else 1 - wz) * (wy if dy else 1 - wy)
                             * (wx if dx else 1 - wx))
                        xi = torch.clamp(ix + dx, 0, big - 1)
                        yi = torch.clamp(iy + dy, 0, big - 1)
                        zi = torch.clamp(iz + dz, 0, big - 1)
                        ok = inside & (zi >= z0) & (zi < z0 + bz)
                        if m:       # a mate's taps land only inside the radius (HK7's cut)
                            ok = ok & (((xi - c) ** 2 + (yi - c) ** 2 + (zi - c) ** 2) < r2)
                        idx = base + ((zi - z0) * big + yi) * big + xi
                        keep = ok.reshape(-1)
                        g.index_add_(0, idx.reshape(-1)[keep],
                                     upd[keep] * w.reshape(-1)[keep][:, None])
    shape = f_slab.shape
    return torch.complex(g[:, 0], g[:, 1]).reshape(shape), g[:, 2].reshape(shape)


def insert_trilinear_slab(vals: torch.Tensor, ctf2w: torch.Tensor, rot: torch.Tensor,
                          cls: torch.Tensor, r_u: int, pf: int, sym_mats: torch.Tensor,
                          n_class: int, big: int, z0: int, bz: int,
                          f_slab: torch.Tensor | None = None,
                          t_slab: torch.Tensor | None = None):
    """HK9: insert formed slices into this rank's z-slab of the (F, T)
    grids, every mate of the point group pose-side.

    vals (B, nk^2) complex64 and ctf2w (B, nk^2) float32 are the dense
    window's values with their weights in (:func:`dense_slice_values`,
    nk = 2 r_u - 1), rot (B, 3, 3), cls (B,) each slice's class;
    sym_mats (n_sym, 3, 3), the identity first.  A sample at pos = rot .
    (pf vc, pf vr, 0) with |pos| < (r_u - 1) pf adds its 8 trilinear taps
    at M pos for every mate M, those whose z lies in [z0, z0 + bz); a
    mate other than the identity adds only taps inside the radius, which
    is HK7's cut, so that for a group of signed permutations (C2, C4, D2,
    ...) the slabs equal HK3 followed by HK7 up to float order.  Returns
    the slabs (K, bz, big, big), accumulated into those given (zeros
    when None).  CPU tensors take :func:`insert_trilinear_slab_plain`;
    CUDA tensors launch csrc/insert_trilinear.cu, whose cells sum the
    (slice, mate) planes of their class in order (two calls give
    identical bits)."""
    dev = vals.device
    if f_slab is None:
        f_slab = torch.zeros((n_class, bz, big, big), dtype=COMPLEX, device=dev)
    if t_slab is None:
        t_slab = torch.zeros((n_class, bz, big, big), dtype=REAL, device=dev)
    if not vals.is_cuda:
        f_new, t_new = insert_trilinear_slab_plain(vals, ctf2w, rot, cls, r_u, pf, sym_mats,
                                                   f_slab, t_slab, z0)
        f_slab.copy_(f_new)
        t_slab.copy_(t_new)
        return f_slab, t_slab
    nk2 = (2 * r_u - 1) ** 2
    n_s = rot.shape[0]
    _native.require(vals.dtype == COMPLEX and vals.shape == (n_s, nk2)
                    and ctf2w.shape == (n_s, nk2) and cls.shape == (n_s,),
                    "insert_trilinear_slab: vals complex64 (B, nk^2), ctf2w (B, nk^2), cls (B,)")
    _native.require(f_slab.shape == (n_class, bz, big, big) and f_slab.dtype == COMPLEX
                    and t_slab.shape == f_slab.shape and t_slab.dtype == REAL
                    and f_slab.is_contiguous() and t_slab.is_contiguous(),
                    "insert_trilinear_slab: slabs must be contiguous (K, bz, big, big)")
    if n_s == 0:
        return f_slab, t_slab
    # one 16-byte record a sample: (Re val, Im val, ctf2w, 0)
    recs = torch.empty((n_s, nk2, 4), dtype=REAL, device=dev)
    recs[..., :2].copy_(torch.view_as_real(vals))
    recs[..., 2].copy_(ctf2w)
    recs[..., 3].zero_()
    rot = rot.to(REAL).reshape(n_s, 9).contiguous()
    cls = cls.to(torch.int32).contiguous()
    mats = sym_mats.to(device=dev, dtype=REAL).reshape(-1, 9).contiguous()
    _native.require(1 <= mats.shape[0] <= INSERT_SLAB_MAX_SYM,
                    f"insert_trilinear_slab: at most {INSERT_SLAB_MAX_SYM} mates a launch")
    mrp = float((r_u - 1) * pf)
    vlo, vhi = tap_range(big, mrp)
    lib = _native.library()
    insert_trilinear_slab.launches += 1
    _native.check(lib.thunder_insert_trilinear_slab(
        recs.data_ptr(), rot.data_ptr(), cls.data_ptr(), n_s, r_u, pf, mrp, mats.data_ptr(),
        mats.shape[0], f_slab.data_ptr(), t_slab.data_ptr(), n_class, big, z0, bz, vlo, vhi,
        _native.stream_ptr(vals)), "insert_trilinear_slab")
    return f_slab, t_slab


insert_trilinear_slab.launches = 0


# -- the gathers' enumeration on the CPU --------------------------------
#
# HK3, HK6 and HK9 cannot run here; these plain versions enumerate
# (cell, sample) pairs as the kernels do, vectorised over cells, so the
# tests can hold that enumeration (candidate range, cuts, weights, the
# faces' virtual cells) to the scatters above.  Their sums run in
# another order than the kernels'.

# sqrt 3 (sqrt 2) and the kernels' margin, as float32
GATHER_REACH_3D = float(np.float32(np.float32(math.sqrt(3)) + np.float32(1e-2)))
GATHER_REACH_2D = float(np.float32(np.float32(math.sqrt(2)) + np.float32(1e-2)))
# the kernels' prefilter: a candidate's position within a cell's half-width
# (and the margin) of the cell on every axis
GATHER_STRIP = float(np.float32(1 + np.float32(1e-2)))


def _virtual_axis(first: int, last: int, big: int, vlo: int, vhi: int) -> torch.Tensor:
    """Indices [first, last] of one axis and, where the range holds a face,
    the virtual ones past it down to vlo or up to vhi."""
    lo = min(vlo, 0) if first == 0 else first
    hi = max(vhi, big - 1) if last == big - 1 else last
    return torch.arange(lo, hi + 1)


def _axis_weight(t: torch.Tensor, v: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Weight of the tap with floor index t on (virtual) cell v: 1 - frac,
    frac, or -1 when neither tap lands there."""
    return torch.where(t == v, 1 - frac, torch.where(t + 1 == v, frac, torch.full_like(frac, -1)))


def gather_reach_mkb(a: float) -> float:
    """HK10's reach (and per-axis prefilter): the blob's radius and the
    kernels' margin, as float32."""
    return float(np.float32(np.float32(a) + np.float32(1e-2)))


def _gather_plain(vals, c2w, rot, cls, r_u: int, pf: int, mats, f_grid, t_grid,
                  z0: int, disc: bool, wsl=None, kernel: str = "trilinear",
                  blob_a: float = DEFAULT_MKB_A, blob_alpha: float = DEFAULT_MKB_ALPHA):
    """The gather of HK3 / HK9 / HK10 (3D: rot (B, 3, 3), mats (n_sym, 3,
    3), grids (K, bz, big, big) from plane z0) or HK6 (2D: rot (B, 2, 2),
    mats None, grids (K, big, big)) on CPU tensors: every virtual cell
    within max_radius_pad + REACH takes, for each (slice, mate) in order,
    the candidates (vc, vr) of the kernels' range and prefilter (Q g
    within GATHER_STRIP of the cell on every axis), the exact position
    and cuts of the scatter, and the taps that land on it; face cells then add their virtual cells.  ``disc``: only pixels
    with vc^2 + vr^2 < (r_u - 1)^2 (HK3, HK6; HK9 takes the window);
    ``wsl``: slices of weight zero are skipped.  ``kernel="mkb"`` (HK10,
    3D): the reach and the prefilter are the blob's radius ``blob_a`` and the
    margin, the disc keeps its edge, and a candidate's weight is
    MKB_FT(|k - p|) where the cell is one of its 4^3 taps and |k - p| <
    blob_a.  Returns the new grids."""
    nd = rot.shape[-1]
    n_cls, big = f_grid.shape[0], f_grid.shape[-1]
    bz = f_grid.shape[1] if nd == 3 else 1
    cb, rr, nk = big // 2, r_u - 1, 2 * r_u - 1
    mrp2 = float((rr * pf) ** 2)
    blob = kernel == "mkb"
    vlo, vhi = tap_range(big, float(rr * pf), kernel)
    reach = (gather_reach_mkb(blob_a) if blob
             else GATHER_REACH_3D if nd == 3 else GATHER_REACH_2D)
    strip = reach if blob else GATHER_STRIP
    axes = [_virtual_axis(0, big - 1, big, vlo, vhi)] * 2
    if nd == 3:
        axes = [_virtual_axis(z0, z0 + bz - 1, big, vlo, vhi)] + axes
    v = torch.stack([g.reshape(-1) for g in torch.meshgrid(*axes, indexing="ij")], -1)
    real = torch.clamp(v, 0, big - 1)
    kr2 = ((real - cb) ** 2).sum(-1).to(REAL)
    keep = kr2 < (rr * pf + reach) ** 2
    v, real, kr2 = v[keep], real[keep], kr2[keep]
    inside_r = kr2 < mrp2
    k = (v - cb).to(REAL).flip(-1)                    # (x, y[, z]) of each virtual cell
    vx = [v[:, -1 - i] for i in range(nd)]            # virtual index by axis x, y[, z]
    vals = vals.reshape(vals.shape[0], -1)
    c2w = c2w.reshape(c2w.shape[0], -1).to(REAL)
    mats = (torch.eye(nd, dtype=REAL)[None] if mats is None else mats.to(REAL))
    n_cand = int(2 * reach / pf) + 1
    acc = torch.zeros((n_cls, k.shape[0], 3), dtype=REAL)
    for s in range(rot.shape[0]):
        if wsl is not None and float(wsl[s]) == 0.0:
            continue
        c = 0 if cls is None else int(cls[s])
        rs = rot[s].to(REAL)
        for m, mat in enumerate(mats):
            q = mat @ rs
            a = [sum(q[i, j] * k[:, i] for i in range(nd)) for j in range(nd)]
            ok = torch.ones(k.shape[0], dtype=torch.bool) if m == 0 else inside_r
            if nd == 3:
                ok = ok & (a[2].abs() < reach)
            # the box of candidates within reach starts here, n_cand wide
            lo = [torch.ceil((a[j] - reach) / pf).to(torch.int64) for j in range(2)]
            for dr in range(n_cand):
                vr = lo[1] + dr
                for dc in range(n_cand):
                    vc = lo[0] + dc
                    gx, gy = (vc * pf).to(REAL), (vr * pf).to(REAL)
                    hit = ok & (vr.abs() <= rr) & (vc.abs() <= rr)
                    for i in range(nd):     # Q g within a cell (and the margin) on each axis
                        hit = hit & ((q[i, 0] * gx + q[i, 1] * gy - k[:, i]).abs() < strip)
                    if disc:
                        q2 = vc * vc + vr * vr
                        hit = hit & ((q2 <= rr * rr) if blob else (q2 < rr * rr))
                    p = [rs[i, 0] * gx + rs[i, 1] * gy for i in range(nd)]
                    r2 = p[0] * p[0] + p[1] * p[1]
                    if nd == 3:
                        r2 = r2 + p[2] * p[2]
                        if m:
                            p = [mat[i, 0] * p[0] + mat[i, 1] * p[1] + mat[i, 2] * p[2]
                                 for i in range(3)]
                    hit = hit & (r2 < mrp2)
                    if blob:
                        # one of the sample's 4^3 taps, within the blob
                        d2 = torch.zeros_like(gx)
                        for i in range(nd):
                            t = torch.floor(p[i]).to(torch.int64) + cb
                            hit = hit & (vx[i] >= t - 1) & (vx[i] <= t + 2)
                            d2 = d2 + ((vx[i] - cb).to(REAL) - p[i]) ** 2
                        hit = hit & (d2 < blob_a * blob_a)
                        wt = mkb_ft(torch.sqrt(torch.clamp(d2, min=0.0)), blob_a, blob_alpha)
                    else:
                        wt = torch.ones_like(gx)
                        for i in reversed(range(nd)):              # (wz * wy) * wx
                            fl = torch.floor(p[i])
                            wi = _axis_weight(fl.to(torch.int64) + cb, vx[i], p[i] - fl)
                            hit = hit & (wi >= 0)
                            wt = wt * wi
                    if not bool(hit.any()):
                        continue
                    idx = ((torch.clamp(vr, -rr, rr) + rr) * nk
                           + torch.clamp(vc, -rr, rr) + rr)[hit]
                    val = vals[s, idx]
                    w = wt[hit]
                    acc[c, hit] += torch.stack([val.real * w, val.imag * w, c2w[s, idx] * w], -1)
    flat = real[:, -1] + big * real[:, -2]
    if nd == 3:
        flat = flat + big * big * (real[:, 0] - z0)
    g = torch.stack([f_grid.real.reshape(n_cls, -1), f_grid.imag.reshape(n_cls, -1),
                     t_grid.reshape(n_cls, -1)], -1).to(REAL)
    for c in range(n_cls):
        g[c].index_add_(0, flat, acc[c])
    shape = f_grid.shape
    return torch.complex(g[..., 0], g[..., 1]).reshape(shape), g[..., 2].reshape(shape)


def insert_trilinear_gather_plain(ft, ctf, img_idx, rot, trans, w, r_u: int, pf: int,
                                  size: int, pixel_size: float, f_grid, t_grid, d=None):
    """HK3's gather on the CPU (same arguments and result as
    :func:`insert_trilinear_plain`)."""
    vals, c2w, _, _ = dense_slice_values(ft, ctf, img_idx, trans, w, r_u, size, pixel_size, d)
    f, t = _gather_plain(vals, c2w, rot, None, r_u, pf, None, f_grid[None], t_grid[None], 0,
                         True, w)
    return f[0], t[0]


def insert_mkb_gather_plain(ft, ctf, img_idx, rot, trans, w, r_u: int, pf: int,
                            size: int, pixel_size: float, f_grid, t_grid, d=None,
                            a: float = DEFAULT_MKB_A, alpha: float = DEFAULT_MKB_ALPHA):
    """HK10's gather on the CPU (same arguments and result as
    :func:`insert_mkb_plain`)."""
    vals, c2w, _, _ = dense_slice_values(ft, ctf, img_idx, trans, w, r_u, size, pixel_size, d,
                                         edge=True)
    f, t = _gather_plain(vals, c2w, rot, None, r_u, pf, None, f_grid[None], t_grid[None], 0,
                         True, w, "mkb", a, alpha)
    return f[0], t[0]


def insert_trilinear_slab_gather_plain(vals, ctf2w, rot, cls, r_u: int, pf: int, sym_mats,
                                       f_slab, t_slab, z0: int):
    """HK9's gather on the CPU (same arguments and result as
    :func:`insert_trilinear_slab_plain`)."""
    return _gather_plain(vals, ctf2w, rot, cls, r_u, pf, sym_mats, f_slab, t_slab, z0, False)


def insert_bilinear_2d_gather_plain(ft, ctf, img_idx, cls, rot, trans, w, r_u: int, pf: int,
                                    size: int, pixel_size: float, f_grid, t_grid):
    """HK6's gather on the CPU (same arguments and result as
    :func:`insert_bilinear_2d_plain`), the slices taken in the order of
    :func:`insert_2d_work`."""
    order, _ = insert_2d_work(img_idx, cls, f_grid.shape[0])
    vals, c2w, _, _ = dense_slice_values(ft, ctf, img_idx[order], trans[order], w[order], r_u,
                                         size, pixel_size)
    return _gather_plain(vals, c2w, rot[order], cls[order], r_u, pf, None, f_grid, t_grid, 0,
                         True, w[order])
