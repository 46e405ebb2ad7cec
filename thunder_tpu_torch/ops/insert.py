"""Weighted Fourier insertion (Reconstructor::insertP,
Reconstructor.cpp:569-866) — and the host of kernels HK3
(``insert_trilinear``), HK6 (``insert_bilinear_2d``), HK10
(``insert_mkb``), HK11 (``insert_sweep``, ``insert_sweep_slab``) and HK12
(``insert_sweep_2d``).

Insertion accumulates w * ctf * dat into F and w * ctf^2 into T over a
full centered grid.  The rounds insert as the JAX package's rounds do,
with its scatter-free shear sweep (``insert_sweep_3d``, its z-slab form,
``insert_sweep_2d``): a fixed linear map whose height hat is two cells
wide (thunder_tpu/config.py:55-59), HK11 and HK12 on the card.
``cli/reconstruct.py`` takes the exact trilinear scatter
``insert_slices_3d`` (HK3), and the insertion option
``reco_kernel="mkb"`` the modified Kaiser-Bessel blob
(``insert_slices_3d(kernel="mkb")``, Reconstructor.cpp:424-567; HK10) in
3D and the bilinear scatter ``insert_slices_2d`` (HK6) in 2D.  On the
card HK3 and HK6 are gathers: each grid cell walks the slices that can
reach it in a fixed order and forms its own sum; HK10, HK11 and HK12 are
scatters into bricks (tiles) of cells that a block owns in shared memory,
HK10's summed in a fixed order by the warp that owns each cell, HK11's
and HK12's as 128-bit fixed-point integers.  Either way two calls give
identical bits.  The ``*_gather_plain`` functions and
:func:`insert_mkb_brick_plain` emulate the kernels' enumerations on the
CPU (tests), the ``*_fixed_plain`` ones the sweeps' fixed-point sums on
any device, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math

import numpy as np
import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.constants import DEFAULT_MKB_A, DEFAULT_MKB_ALPHA
from thunder_tpu_torch.device import COMPLEX, REAL
from thunder_tpu_torch.ops.fourier import translate_phases_view
from thunder_tpu_torch.physics.ctf import (CtfParams, ctf_constants,
                                           ctf_packed, ctf_packed_scaled)

# HK10's compile-time constants, read from its source: the degree of the
# blob's series; a brick's edge in x and y and its depth; its warps and
# the planes a block lists at once; the margin on every reach
MKB_DEG, MKB_BXY, MKB_BZ, MKB_THREADS, MKB_CAP, MKB_MARGIN = (
    _native.csrc_constant("insert_mkb.cu", n)
    for n in ("MKB_DEG", "MKB_BXY", "MKB_BZ", "MKB_THREADS", "MKB_CAP", "MKB_MARGIN"))


def mkb_constants(a: float, alpha: float) -> tuple:
    """The blob's constants as the kernel and the plain versions take
    them: a^2 and 1 / a^2 in float32, and the float32 coefficients c_0 ...
    c_MKB_DEG of MKB_FT(r) = I0(alpha sqrt(s)) / I0(alpha) = sum_k c_k
    s^k, s = 1 - r^2 / a^2, c_k = (alpha^2 / 4)^k / (k!)^2 / I0(alpha)
    (the power series of I0).  Raises where the series' remainder past
    MKB_DEG could reach 1e-7 (alpha above ~20)."""
    q = alpha * alpha / 4.0
    c = np.array([q ** k / math.factorial(k) ** 2 for k in range(MKB_DEG + 1)]) / np.i0(alpha)
    nxt = q ** (MKB_DEG + 1) / math.factorial(MKB_DEG + 1) ** 2 / np.i0(alpha)
    ratio = q / (MKB_DEG + 2) ** 2
    if not (ratio < 1 and nxt / (1 - ratio) < 1e-7):
        raise ValueError(f"the MKB blob's series to degree {MKB_DEG} does not hold "
                         f"alpha = {alpha}")
    a2 = np.float32(a * a)
    return a2, np.float32(1.0 / float(a2)), c.astype(np.float32)


def mkb_reach(a: float) -> float:
    """How far HK10 looks past a cell for a sample: the blob's radius and
    the margin, float32."""
    return float(np.float32(np.float32(a) + np.float32(MKB_MARGIN)))


@functools.lru_cache(maxsize=16)
def _mkb_bricks(big: int, bz: int, mrp: float, a: float) -> np.ndarray:
    f32 = np.float32
    cb = big // 2
    nb, nbz = -(-big // MKB_BXY), -(-big // bz)
    idx = np.arange(nb * nb * nbz)
    first = [idx % nb * MKB_BXY, idx // nb % nb * MKB_BXY, idx // (nb * nb) * bz]
    edge = (MKB_BXY, MKB_BXY, bz)
    near = [np.where(f > cb, f - cb,
                     np.where(np.minimum(f + e, big) - 1 < cb, cb - (np.minimum(f + e, big) - 1),
                              0)).astype(f32) for f, e in zip(first, edge)]
    r2 = (near[0] * near[0] + near[1] * near[1]) + near[2] * near[2]
    lim = f32(f32(mrp) + f32(mkb_reach(a)))
    keep = idx[r2 < lim * lim]
    return keep[np.argsort(r2[keep], kind="stable")].astype(np.int32)


def mkb_bricks(big: int, mrp: float, a: float, device) -> torch.Tensor:
    """The bricks of 8^3 cells HK10 fills, a block each: those a sample
    within max_radius_pad ``mrp`` can reach, by index (x fastest),
    nearest the centre first.  The planes of a launch pass nearest the
    centre, so those bricks take the longest; launched first, they run
    beside the others."""
    return torch.as_tensor(_mkb_bricks(big, MKB_BZ, float(mrp), float(a)), device=device)


def mkb_weight(r2: torch.Tensor, inv_a2, coef) -> torch.Tensor:
    """MKB_FT at squared distances r2 (float32), as HK10 forms it: the
    series of :func:`mkb_constants` in s = 1 - r2 / a^2 by Horner's rule
    (the kernel fuses each step's multiply and add)."""
    s = 1 - r2 * torch.as_tensor(inv_a2, device=r2.device)
    coef = torch.as_tensor(coef, device=r2.device)
    p = torch.full_like(s, float(coef[-1]))
    for k in range(coef.numel() - 2, -1, -1):
        p = p * s + coef[k]
    return p


def _mkb_taps(x, y, z, a: float, alpha: float):
    """The taps of the MKB blob, (dz, dy, dx, weight) for the 4^3
    neighbourhood floor - 1 ... floor + 2 of each sample: MKB_FT(r) where
    r^2 = |tap - sample|^2 < a^2, else 0 (thunder_tpu ops/insert.py
    _mkb_taps; a <= 2 keeps the blob inside the neighbourhood), the
    weight from r^2 as :func:`mkb_weight` forms it."""
    a2, inv_a2, coef = mkb_constants(a, alpha)
    flx, fly, flz = torch.floor(x), torch.floor(y), torch.floor(z)
    for dz in (-1, 0, 1, 2):
        for dy in (-1, 0, 1, 2):
            for dx in (-1, 0, 1, 2):
                r2 = (flx + dx - x) ** 2 + (fly + dy - y) ** 2 + (flz + dz - z) ** 2
                w = torch.where(r2 < a2, mkb_weight(r2, inv_a2, coef), torch.zeros_like(r2))
                yield dz, dy, dx, w


def insert_slices_3d(f_grid: torch.Tensor, t_grid: torch.Tensor,
                     vals: torch.Tensor, ctf2w: torch.Tensor,
                     rot: torch.Tensor, i_col: torch.Tensor,
                     i_row: torch.Tensor, pf: int, max_radius_pad: float,
                     kernel: str = "trilinear", a: float = DEFAULT_MKB_A,
                     alpha: float = DEFAULT_MKB_ALPHA, sum_dtype=REAL):
    """Scatter of slices into (F, T) (thunder_tpu ops/insert.py
    insert_slices_3d): ``kernel`` "trilinear" (8 taps) or "mkb" (the
    blob's 4^3 taps, :func:`_mkb_taps`), tap indices clipped to the grid.

    f_grid (big,)*3 complex64 centered, t_grid float32; vals (..., p)
    complex, ctf2w (..., p), rot (..., 3, 3), pixels (p,).  Out-of-radius
    samples get zero weight.  ``sum_dtype``: the type the float32 taps are
    summed in (float64: the grids come back as complex128 and float64).
    Returns new (f_grid, t_grid)."""
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
                     t_grid.reshape(-1)], dim=-1).to(sum_dtype)
    upd = torch.stack([vals.real, vals.imag, ctf2w.to(REAL)], dim=-1)
    for dz, dy, dx, w in taps:
        xi = torch.clamp(ix + dx, 0, big - 1)
        yi = torch.clamp(iy + dy, 0, big - 1)
        zi = torch.clamp(iz + dz, 0, big - 1)
        g.index_add_(0, (zi * big + yi) * big + xi, (upd * w[:, None]).to(sum_dtype))
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
                     d=None, a: float = DEFAULT_MKB_A, alpha: float = DEFAULT_MKB_ALPHA,
                     f64_sums: bool = False):
    """Plain version of HK10: HK3's value formation then the MKB blob's
    scatter (:func:`insert_slices_3d` with ``kernel="mkb"``), 256 slices
    at a time.  ``f64_sums``: the float32 taps summed in float64, then
    rounded (the reference the kernel is held to on the card, where
    float32 sums of ~1e5 taps a cell part from each other by up to 1e-5
    of max |F|).  Returns the new (F, T)."""
    max_rad = float((r_u - 1) * pf)
    dtype = torch.float64 if f64_sums else REAL
    for lo in range(0, rot.shape[0], 256):
        sl = slice(lo, lo + 256)
        vals, c2w, vc, vr = dense_slice_values(
            ft, ctf, img_idx[sl], trans[sl], w[sl], r_u, size, pixel_size,
            None if d is None else d[sl], edge=True)
        f_grid, t_grid = insert_slices_3d(f_grid, t_grid, vals, c2w, rot[sl], vc, vr, pf,
                                          max_rad, "mkb", a, alpha, dtype)
    return f_grid.to(COMPLEX), t_grid.to(REAL)


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
    rings and Hermitian fold insert, the DC doubled) and the weight
    :func:`mkb_weight`.  Same arguments as :func:`insert_trilinear` and
    ``a`` <= 2, ``alpha``.  CPU tensors take :func:`insert_mkb_plain`;
    CUDA tensors launch csrc/insert_mkb.cu: a block owns a brick of
    cells, each of its warps takes an eighth of the brick's planes into
    sums of its own for every cell of the brick in shared memory, and
    each cell sums its taps in one order (plane, sample, tap, then
    warp), so two calls give identical bits."""
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
    a2, inv_a2, coef = mkb_constants(a, alpha)    # coef: read on the host at the launch
    bricks = mkb_bricks(big, mrp, a, dev)
    lib = _native.library()
    insert_mkb.launches += 1
    _native.check(lib.thunder_insert_mkb(
        ft.data_ptr(), size, ctfk.data_ptr(), img_idx.data_ptr(),
        rot.data_ptr(), trans.data_ptr(), w.data_ptr(),
        None if d is None else d.data_ptr(), n_s, r_u, pf, mrp,
        float(pixel_size * size), float(2 * np.pi / size), f_grid.data_ptr(),
        t_grid.data_ptr(), vals.data_ptr(), big, vlo, vhi, bricks.data_ptr(), bricks.numel(),
        float(a), float(a2), float(inv_a2), coef.ctypes.data, _native.stream_ptr(ft)),
        "insert_mkb")
    return f_grid, t_grid


def insert_mkb_attrs() -> tuple:
    """(registers, local bytes) a thread of HK10's kernel takes on the
    card (cudaFuncGetAttributes: numRegs, localSizeBytes)."""
    out = (ctypes.c_int * 2)()
    _native.check(_native.library().thunder_insert_mkb_attrs(ctypes.addressof(out)),
                  "insert_mkb_attrs")
    return int(out[0]), int(out[1])


insert_mkb.launches = 0


# -- HK6 ----------------------------------------------------------------

# the kernel's compile-time constants, read from its source: a block's
# tile of cells (a thread a cell), slices staged at once
INSERT_2D_TILE_X, INSERT_2D_TILE_Y, INSERT_2D_BATCH = (
    _native.csrc_constant("insert_bilinear_2d.cu", n) for n in ("TILE_X", "TILE_Y", "BATCH"))
INSERT_2D_THREADS = INSERT_2D_TILE_X * INSERT_2D_TILE_Y
# HK12's: a block's tile edge and threads
SWEEP_2D_TILE, SWEEP_2D_THREADS = (
    _native.csrc_constant("insert_bilinear_2d.cu", n) for n in ("SWEEP_TILE", "SWEEP_THREADS"))


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
    and the tiles that cover it, the range of indices a tap can take (the
    faces gather what lies past them), and the shared-memory bytes of a
    staged batch (two ramp tables of nk entries, a rotation, a weight and
    an image a slice)."""
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


# -- HK11, HK12: the rounds' insertion, thunder_tpu's shear sweep ------

INSERT_SLAB_MAX_SYM = _native.csrc_constant("insert_trilinear.cu", "MAX_SYM")
#
# thunder_tpu inserts every trilinear round with its scatter-free shear
# sweep (ops/insert.py insert_sweep_3d, insert_sweep_2d), a fixed linear
# map from a slice's dense samples to grid cells.  In the sweep's
# canonical axes (a, m, l) of each plane (a the axis most aligned with
# its normal), sample (h, k) adds to cell (a, m, l) with the weight
#     hat(m' - em1 h - em2 k) * hat(l' - p_h h - q_m m')
#       * hat((a - alpha l - beta m) / 2) / 2,
# hat(t) = max(0, 1 - |t|), (m', l') the cell's (m, l) or (l, m) after
# the plane's m/l swap; 2D keeps the first two hats, with y for m' and x
# for l'.  Cells past the grid's faces are dropped, not clipped.  The
# port evaluates the map in float32 (thunder_tpu's 3D sweep streams its
# hat fields as bf16); each (cell, sample) weight is formed by the same
# float expressions in the plain versions, the kernels and their
# fixed-point emulation below.

SWEEP_Z_WIDTH = 2.0                 # the height hat's width (thunder_tpu _Z_KERNEL_WIDTH)
SWEEP_SWAP_HK, SWEEP_SWAP_ML = 4, 8   # a record's flags beside the case (0 x, 1 y, 2 z)


def _hat(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - t.abs(), min=0.0)


def sweep_coeffs(rot: torch.Tensor, pf: int) -> torch.Tensor:
    """The sweep's coefficients of each plane (thunder_tpu ops/insert.py
    _sweep_coeffs), (B, 8) float32 records [em1, em2, p_h, q_m, alpha,
    beta, flags, 0]: the height axis ``case`` (0 x, 1 y, 2 z) of the
    normal rot[:, :, 2] and the h/k and m/l swaps as flags (case +
    SWEEP_SWAP_HK + SWEEP_SWAP_ML); alpha = -n_l / n_a and beta = -n_m /
    n_a in canonical axes.  The slice's row (h) pairs with rot's column
    1, its column (k) with column 0, both scaled by pf.  The kernels read
    these records; they form no coefficient themselves."""
    rot = rot.to(REAL)
    e1, e2, nrm = rot[:, :, 1] * pf, rot[:, :, 0] * pf, rot[:, :, 2]
    case = torch.argmax(nrm.abs(), dim=1)
    m_i = torch.where(case == 2, 1, 2)
    l_i = torch.where(case == 0, 1, 0)

    def comp(v, i):
        return torch.gather(v, 1, i[:, None])[:, 0]

    em1, el1, em2, el2 = comp(e1, m_i), comp(e1, l_i), comp(e2, m_i), comp(e2, l_i)
    n_a, n_m, n_l = comp(nrm, case), comp(nrm, m_i), comp(nrm, l_i)
    # h/k swap: k, contracted first, has the stronger in-plane footprint
    swap_hk = torch.maximum(em1.abs(), el1.abs()) > torch.maximum(em2.abs(), el2.abs())
    em1, em2 = torch.where(swap_hk, em2, em1), torch.where(swap_hk, em1, em2)
    el1, el2 = torch.where(swap_hk, el2, el1), torch.where(swap_hk, el1, el2)
    # m/l swap: the pivot |em2| dominates
    swap_ml = el2.abs() > em2.abs()
    em1, el1 = torch.where(swap_ml, el1, em1), torch.where(swap_ml, em1, el1)
    em2, el2 = torch.where(swap_ml, el2, em2), torch.where(swap_ml, em2, el2)
    det2 = el1 * em2 - el2 * em1
    n_a = torch.where(n_a.abs() < 1e-12, torch.full_like(n_a, 1e-12), n_a)
    flags = case + SWEEP_SWAP_HK * swap_hk.long() + SWEEP_SWAP_ML * swap_ml.long()
    return torch.stack([em1, em2, det2 / em2, el2 / em2, -n_l / n_a, -n_m / n_a,
                        flags.to(REAL), torch.zeros_like(em1)], -1)


def sweep_coeffs_2d(rot: torch.Tensor, pf: int) -> torch.Tensor:
    """The 2D sweep's coefficients of each slice (thunder_tpu
    ops/insert.py insert_sweep_2d), (B, 8) float32 records [ey1, ey2, p_h,
    q_y, 0, 0, flags, 0], flags SWEEP_SWAP_HK where h and k swap (k pivots
    on the larger |y| component)."""
    rot = rot.to(REAL)
    e1, e2 = rot[:, :, 1] * pf, rot[:, :, 0] * pf
    swap_hk = e2[:, 1].abs() < e1[:, 1].abs()
    ey1 = torch.where(swap_hk, e2[:, 1], e1[:, 1])
    ey2 = torch.where(swap_hk, e1[:, 1], e2[:, 1])
    ex1 = torch.where(swap_hk, e2[:, 0], e1[:, 0])
    ex2 = torch.where(swap_hk, e1[:, 0], e2[:, 0])
    det2 = ex1 * ey2 - ex2 * ey1
    z = torch.zeros_like(ey1)
    return torch.stack([ey1, ey2, det2 / ey2, ex2 / ey2, z, z,
                        (SWEEP_SWAP_HK * swap_hk.long()).to(REAL), z], -1)


def sweep_planes_rot(rot: torch.Tensor, mats: torch.Tensor | None) -> torch.Tensor:
    """The rotation M_m R_s of every plane (slice s, mate m), in slice
    order then mate order (mats None: the slices alone), (B n_sym, 3, 3)."""
    rot = rot.to(REAL)
    if mats is None:
        return rot
    return torch.einsum("mij,bjk->bmik", mats.to(device=rot.device, dtype=REAL),
                        rot).reshape(-1, 3, 3)


def sweep_planes(rot: torch.Tensor, mats: torch.Tensor | None, pf: int) -> torch.Tensor:
    """The records of :func:`sweep_coeffs` of every plane of
    :func:`sweep_planes_rot`, (B n_sym, 8)."""
    return sweep_coeffs(sweep_planes_rot(rot, mats), pf)


def _pass_coords(co: torch.Tensor, nk: int, px: torch.Tensor):
    """(h, k) of the window pixels px (flat indices (vr + rr) nk + vc +
    rr) in each plane's pass order: (vr, vc), or (vc, vr) where h and k
    swap; (P, n) float32 each."""
    rr = nk // 2
    vr = (px // nk - rr).to(REAL)[None]
    vc = (px % nk - rr).to(REAL)[None]
    swap = (co[:, 6].long() & SWEEP_SWAP_HK != 0)[:, None]
    return torch.where(swap, vc, vr), torch.where(swap, vr, vc)


def _sweep_taps(co: torch.Tensor, nk: int, px: torch.Tensor, nd: int):
    """The cells the sweep's samples px reach in each plane of records co
    (P, 8): yields the centered (x, y[, z]) coordinates (P, n) and the
    weight (P, n), 2 x 2 (2D) or 2 x 2 x 4 (3D) a sample, weights zero
    included."""
    h, k = _pass_coords(co, nk, px)
    c1, c2, p_h, q = co[:, 0:1], co[:, 1:2], co[:, 2:3], co[:, 3:4]
    ctr_m = c1 * h + c2 * k                      # 2D: along y
    for dm in (0, 1):
        mp = torch.floor(ctr_m) + dm
        w3 = _hat(mp - ctr_m)
        ctr_l = p_h * h + q * mp                 # 2D: along x
        for dl in (0, 1):
            lp = torch.floor(ctr_l) + dl
            w32 = w3 * _hat(lp - ctr_l)
            if nd == 2:
                yield (lp, mp), w32
                continue
            flags = co[:, 6:7].long()
            case = flags & 3
            swap_ml = flags & SWEEP_SWAP_ML != 0
            m, l = torch.where(swap_ml, lp, mp), torch.where(swap_ml, mp, lp)
            zeta = co[:, 4:5] * l + co[:, 5:6] * m
            for da in (-1, 0, 1, 2):
                a = torch.floor(zeta) + da
                w = w32 * (_hat((a - zeta) / SWEEP_Z_WIDTH) / SWEEP_Z_WIDTH)
                x = torch.where(case == 0, a, l)
                y = torch.where(case == 1, a, torch.where(case == 0, l, m))
                z = torch.where(case == 2, a, m)
                yield (x, y, z), w


def _sweep_cells(co: torch.Tensor, nk: int, px: torch.Tensor, big: int, row: torch.Tensor,
                 nd: int, z0: int = 0, bz: int | None = None, cut: torch.Tensor | None = None,
                 cut_r2: float = 0.0):
    """The taps of :func:`_sweep_taps` that land: yields (ok, idx, w),
    ok (P, n) the taps of weight above zero inside the grid (the slab from
    plane z0, bz planes; 2D: a (big, big) plane) and, where cut[p], at
    |k|^2 < cut_r2 (a mate's cells, HK7's cut), idx their rows (row[p] +
    the cell's offset) and w (P, n) the weights."""
    cb = big // 2
    bz = big if bz is None else bz
    for cell, w in _sweep_taps(co, nk, px, nd):
        ix = [(v + cb).long() for v in cell]
        ok = w > 0
        for i in ix[:2]:
            ok = ok & (i >= 0) & (i < big)
        off = ix[1] * big + ix[0]
        if nd == 3:
            ok = ok & (ix[2] >= z0) & (ix[2] < z0 + bz)
            off = off + (ix[2] - z0) * big * big
        if cut is not None:
            r2 = sum(v * v for v in cell)
            ok = ok & ~(cut[:, None] & (r2 >= cut_r2))
        yield ok, (row[:, None] + off)[ok], w


def _sweep_add(g: torch.Tensor, vals: torch.Tensor, c2w: torch.Tensor, co: torch.Tensor,
               nk: int, big: int, row: torch.Tensor, nd: int, z0: int = 0,
               bz: int | None = None, cut: torch.Tensor | None = None,
               cut_r2: float = 0.0) -> None:
    """Adds the sweep of planes co (P, 8) into g (rows, 3) of (Re F, Im
    F, T): plane p's values vals (P, nk^2) complex and c2w (P, nk^2) at
    its in-disc samples go to row row[p] + the cell's offset in a (bz,
    big, big) slab from plane z0 (2D: a (big, big) plane).  Cells past
    the grid (or the slab) are dropped; where cut[p], so are those with
    |k|^2 >= cut_r2 (a mate's cells, HK7's cut)."""
    px = in_disc_pixels(nk // 2 + 1, vals.device).long()
    upd = torch.stack([vals[:, px].real, vals[:, px].imag, c2w[:, px].to(REAL)], -1)
    for ok, idx, w in _sweep_cells(co, nk, px, big, row, nd, z0, bz, cut, cut_r2):
        g.index_add_(0, idx, (upd[ok] * w[ok][:, None]).to(g.dtype))


def _grid_rows(f_grid: torch.Tensor, t_grid: torch.Tensor, dtype=REAL) -> torch.Tensor:
    return torch.stack([f_grid.real.reshape(-1), f_grid.imag.reshape(-1),
                        t_grid.reshape(-1)], -1).to(dtype)


def _from_rows(g: torch.Tensor, shape) -> tuple:
    g = g.to(REAL)
    return torch.complex(g[:, 0], g[:, 1]).reshape(shape), g[:, 2].reshape(shape)


# -- the kernels' fixed-point sums (csrc/sweep_fixed.cuh) -----------------
#
# HK11 and HK12 sum each cell's taps as 128-bit integers: a tap adds
# rint(float64(v * w) * 2^s), v * w the float32 product, 2^s a power of
# two a component (Re F, Im F, T) with 2^s * bound < 2^126 (bound: the
# samples the launch may add times the largest |value|, times the largest
# |w| and 2 in 2D, where the values are formed per slice in the kernel);
# a cell adds float32(((w3 2^96 + w2 2^64) + (w1 2^32 + w0)) * 2^-s) of
# its sum's 32-bit words (w3 signed) to its grid where the sum is not
# zero.  Integer sums do not depend on the order of the adds, so the
# emulation below, given the values the kernels formed, gives their bits.
# It sums each of a tap's four words apart in int64 (a cell takes far
# fewer than 2^31 taps, so no partial sum wraps) and carries at the end.

FIXED_BITS = 126
_WORD = 1 << 32


def sweep_fixed_scales(maxima, count: float, w_max: float | None = None) -> list:
    """The kernels' 2^s of each component: the largest with 2^s * bound
    < 2^FIXED_BITS, bound = count * max (3D) or count * max * w_max * 2
    (2D), formed in float64 in that order."""
    out = []
    for m in maxima:
        b = count * float(m) if w_max is None else count * float(m) * float(w_max) * 2.0
        out.append(math.ldexp(1.0, FIXED_BITS - math.frexp(b)[1]))
    return out


def sweep_fixed_count(n_planes: int, r_u: int) -> float:
    """The samples a launch of ``n_planes`` planes may add, each plane's
    in-disc pixels (:func:`in_disc_pixels`): the count of the scale's
    bound, as the kernels take it."""
    return float(n_planes * in_disc_pixels(r_u).numel())


def _fixed_words(x: torch.Tensor) -> torch.Tensor:
    """The four 32-bit words (lowest first, as int64 in [0, 2^32)) of the
    two's complement of rint(x), x float64 with |x| < 2^126: (..., 4)."""
    x = torch.round(x)
    a = x.abs()
    words = []
    for shift in (96, 64, 32):
        h = torch.floor(a * 2.0 ** -shift)
        a = a - h * 2.0 ** shift
        words.append(h)
    words = [a] + words[::-1]
    words = [w.long() for w in words]
    neg = x < 0
    carry = torch.ones_like(words[0])
    for i in range(4):
        t = (_WORD - 1 - words[i]) + carry
        words[i] = torch.where(neg, t & (_WORD - 1), words[i])
        carry = t >> 32
    return torch.stack(words, -1)


def _sweep_add_fixed(acc: torch.Tensor, upd: torch.Tensor, co: torch.Tensor, nk: int, big: int,
                     row: torch.Tensor, nd: int, scales, **cells) -> None:
    """:func:`_sweep_add` into the word sums acc (rows, 3, 4) int64: upd
    (P, n, 3) float32 the planes' values at the in-disc pixels; each tap
    adds the words of rint(float64(v * w) * scale) (ties to even, as the
    kernels' ``rint``)."""
    px = in_disc_pixels(nk // 2 + 1, upd.device).long()
    sc = torch.tensor(scales, dtype=torch.float64, device=upd.device)
    for ok, idx, w in _sweep_cells(co, nk, px, big, row, nd, **cells):
        acc.index_add_(0, idx, _fixed_words((upd[ok] * w[ok][:, None]).double() * sc))


def _fixed_into(f_grid: torch.Tensor, t_grid: torch.Tensor, acc: torch.Tensor, scales) -> tuple:
    """(F, T) with the word sums acc (rows, 3, 4) carried into 128-bit
    sums and added where they are not zero, as the kernels add them."""
    w = [acc[..., i] for i in range(4)]
    for i in range(3):
        w[i + 1] = w[i + 1] + (w[i] >> 32)
        w[i] = w[i] & (_WORD - 1)
    w[3] = w[3] & (_WORD - 1)
    w[3] = torch.where(w[3] >= _WORD // 2, w[3] - _WORD, w[3])
    hi = w[3].double() * 2.0 ** 96 + w[2].double() * 2.0 ** 64
    lo = w[1].double() * 2.0 ** 32 + w[0].double()
    inv = torch.tensor([1.0 / x for x in scales], dtype=torch.float64, device=acc.device)
    g = _grid_rows(f_grid, t_grid)
    nonzero = (w[0] | w[1] | w[2] | w[3]) != 0
    g = torch.where(nonzero, g + ((hi + lo) * inv).to(REAL), g)
    return _from_rows(g, f_grid.shape)


def _abs_max(x: torch.Tensor) -> float:
    return float(x.abs().max()) if x.numel() else 0.0


def sweep_value_records(ft, ctf, img_idx, trans, w, r_u: int, size: int, pixel_size: float,
                        d=None) -> torch.Tensor:
    """HK11's values as records (B, nk^2, 4) float32 (Re, Im, c2w, 0),
    formed by :func:`dense_slice_values` (the kernel's first pass forms
    the same values in its own rounding)."""
    vals, c2w, _, _ = dense_slice_values(ft, ctf, img_idx, trans, w, r_u, size, pixel_size, d)
    return torch.stack([vals.real, vals.imag, c2w.to(REAL), torch.zeros_like(c2w, dtype=REAL)],
                       -1)


def _sweep_3d_fixed(recs, rot, cls, r_u: int, pf: int, mats, f_grid, t_grid, z0: int,
                    chunk: int):
    """HK11's sums (one grid: mats None, cls None; the slab form: the
    point group's mates, each slice's class) emulated from the value
    records recs (B, nk^2, 4)."""
    n_s, nk = recs.shape[0], 2 * r_u - 1
    n_sym = 1 if mats is None else mats.shape[0]
    bz, big = f_grid.shape[-3], f_grid.shape[-1]
    count = sweep_fixed_count(n_s * n_sym, r_u)
    scales = sweep_fixed_scales([_abs_max(recs[..., c]) for c in range(3)], count)
    px = in_disc_pixels(r_u, recs.device).long()
    acc = torch.zeros((f_grid.numel(), 3, 4), dtype=torch.int64, device=recs.device)
    mate = torch.arange(n_sym, device=recs.device)
    for lo in range(0, n_s, chunk):
        sl = slice(lo, lo + chunk)
        n = recs[sl].shape[0]
        upd = recs[sl][:, px, :3].repeat_interleave(n_sym, 0)
        rows = torch.zeros(n * n_sym, dtype=torch.int64, device=recs.device)
        if cls is not None:
            rows = (cls[sl].long() * (bz * big * big))[:, None].expand(n, n_sym).reshape(-1)
        cut = None if mats is None else (mate > 0).repeat(n)
        _sweep_add_fixed(acc, upd, sweep_planes(rot[sl], mats, pf), nk, big, rows, 3, scales,
                         z0=z0, bz=bz, cut=cut, cut_r2=float((r_u - 1) * pf) ** 2)
    return _fixed_into(f_grid, t_grid, acc, scales)


def insert_sweep_fixed_plain(ft, ctf, img_idx, rot, trans, w, r_u: int, pf: int, size: int,
                             pixel_size: float, f_grid, t_grid, d=None, recs=None,
                             chunk: int = 256):
    """HK11's arithmetic in PyTorch on any device: the sweep of
    :func:`insert_sweep` summed in fixed point as the kernel sums it.
    ``recs`` (B, nk^2, 4): the values the kernel formed (its ``recs``
    after a call), then the result equals the kernel's bit for bit; None:
    :func:`sweep_value_records`.  Returns the new (F, T)."""
    if recs is None:
        recs = sweep_value_records(ft, ctf, img_idx, trans, w, r_u, size, pixel_size, d)
    f, t = _sweep_3d_fixed(recs, rot, None, r_u, pf, None, f_grid[None], t_grid[None], 0,
                           chunk)
    return f[0], t[0]


def insert_sweep_slab_fixed_plain(vals, ctf2w, rot, cls, r_u: int, pf: int, sym_mats,
                                  f_slab, t_slab, z0: int, chunk: int = 256):
    """HK11's slab form's arithmetic in PyTorch on any device (same
    arguments as :func:`insert_sweep_slab_plain`): the kernel's bits."""
    recs = torch.stack([vals.real, vals.imag, ctf2w.to(REAL)], -1)
    return _sweep_3d_fixed(recs, rot, cls, r_u, pf, sym_mats.to(device=vals.device, dtype=REAL),
                           f_slab, t_slab, z0, chunk)


def sweep_2d_image_records(ft, ctf, r_u: int, size: int, pixel_size: float) -> torch.Tensor:
    """HK12's first pass in PyTorch: each image's records (L, nk^2, 4)
    float32 (Re, Im of ft * ctf * mask_d, ctf^2 * mask_d, 0), zero
    outside the disc."""
    vc, vr, mask_d = dense_window(r_u, ft.device)
    c = size // 2
    dat = ft[:, (c + vr).long(), (c + vc).long()]
    ct = ctf_packed(ctf, vc, vr, size, pixel_size)
    cm = ct * mask_d
    v = dat * cm
    return torch.stack([v.real, v.imag, ct * cm, torch.zeros_like(cm)], -1).to(REAL)


def sweep_2d_values(recs, img_idx, trans, w, r_u: int, size: int) -> torch.Tensor:
    """Each slice's values at the in-disc pixels (B, n, 3) float32 as
    HK12 forms them: the image's record times the translation ramp
    exp(i tpos vc tx) exp(i tpos vr ty) (float32 sin and cos), times the
    slice's weight, every product rounded."""
    nk, rr = 2 * r_u - 1, r_u - 1
    dev = recs.device
    px = in_disc_pixels(r_u, dev).long()
    vr, vc = px // nk, px % nk
    tpos = torch.tensor(float(np.float32(2 * np.pi / size)), dtype=REAL, device=dev)
    v = torch.arange(-rr, rr + 1, device=dev).to(REAL)
    trans, w = trans.to(REAL), w.to(REAL)[:, None]
    phx, phy = tpos * (v[None] * trans[:, :1]), tpos * (v[None] * trans[:, 1:])
    ac, as_ = torch.cos(phx)[:, vc], torch.sin(phx)[:, vc]
    ec, es = torch.cos(phy)[:, vr], torch.sin(phy)[:, vr]
    er = ac * ec - as_ * es
    ei = ac * es + as_ * ec
    d = recs[img_idx.long()][:, px]
    return torch.stack([(d[..., 0] * er - d[..., 1] * ei) * w,
                        (d[..., 0] * ei + d[..., 1] * er) * w, d[..., 2] * w], -1)


def _sweep_2d_fixed(values, n_s: int, rot, cls, r_u: int, pf: int, f_grid, t_grid, scales,
                    chunk: int):
    """HK12's sums from values(sl) (n, n_px, 3), the values of slices sl
    at the in-disc pixels, into the class planes cls[s]."""
    nk, big = 2 * r_u - 1, f_grid.shape[-1]
    acc = torch.zeros((f_grid.numel(), 3, 4), dtype=torch.int64, device=f_grid.device)
    for lo in range(0, n_s, chunk):
        sl = slice(lo, lo + chunk)
        _sweep_add_fixed(acc, values(sl), sweep_coeffs_2d(rot[sl], pf), nk, big,
                         cls[sl].long() * (big * big), 2, scales)
    return _fixed_into(f_grid, t_grid, acc, scales)


def insert_sweep_2d_fixed_plain(ft, ctf, img_idx, cls, rot, trans, w, r_u: int, pf: int,
                                size: int, pixel_size: float, f_grid, t_grid, recs=None,
                                chunk: int = 256):
    """HK12's arithmetic in PyTorch on any device: the 2D sweep of
    :func:`insert_sweep_2d` summed in fixed point as the kernel sums it.
    ``recs`` (L, nk^2, 4): the images' records the kernel formed (its
    ``recs`` after a call), then the result equals the kernel's bit for
    bit; None: :func:`sweep_2d_image_records`.  Returns the new (F, T)."""
    if recs is None:
        recs = sweep_2d_image_records(ft, ctf, r_u, size, pixel_size)
    m_xy = _abs_max(recs[..., 0].abs() + recs[..., 1].abs())
    n_s = rot.shape[0]
    scales = sweep_fixed_scales([m_xy, m_xy, _abs_max(recs[..., 2])],
                                sweep_fixed_count(n_s, r_u), _abs_max(w.to(REAL)))
    return _sweep_2d_fixed(lambda sl: sweep_2d_values(recs, img_idx[sl], trans[sl], w[sl], r_u,
                                                      size),
                           n_s, rot, cls, r_u, pf, f_grid, t_grid, scales, chunk)


def insert_sweep_3d_plain(vals: torch.Tensor, ctf2w: torch.Tensor, rot: torch.Tensor,
                          w_cls: torch.Tensor, big: int, pf: int):
    """thunder_tpu's insert_sweep_3d in float32 on formed dense slices:
    vals (B, nk, nk) complex64 (full plane, masked, the DC doubled),
    ctf2w (B, nk, nk), rot (B, 3, 3), w_cls (K, B) each class's weight of
    each slice.  Returns f (K, big^3) complex64 and t (K, big^3)."""
    n_b, nk = vals.shape[0], vals.shape[-1]
    n_cls = w_cls.shape[0]
    co = sweep_coeffs(rot, pf)
    g = torch.zeros((n_cls * big ** 3, 3), dtype=REAL, device=vals.device)
    for k in range(n_cls):
        wk = w_cls[k].to(REAL)[:, None]
        _sweep_add(g, vals.reshape(n_b, -1) * wk, ctf2w.reshape(n_b, -1) * wk, co, nk, big,
                   torch.full((n_b,), k * big ** 3, device=vals.device), 3)
    return _from_rows(g, (n_cls,) + (big,) * 3)


def insert_sweep_2d_plain(vals: torch.Tensor, ctf2w: torch.Tensor, rot: torch.Tensor,
                          w_cls: torch.Tensor, big: int, pf: int):
    """thunder_tpu's insert_sweep_2d on formed dense slices: vals (B, nk,
    nk) complex64, ctf2w (B, nk, nk), rot (B, 2, 2), w_cls (K, B).
    Returns f (K, big, big) complex64 and t (K, big, big)."""
    n_b, nk = vals.shape[0], vals.shape[-1]
    n_cls = w_cls.shape[0]
    co = sweep_coeffs_2d(rot, pf)
    g = torch.zeros((n_cls * big * big, 3), dtype=REAL, device=vals.device)
    for k in range(n_cls):
        wk = w_cls[k].to(REAL)[:, None]
        _sweep_add(g, vals.reshape(n_b, -1) * wk, ctf2w.reshape(n_b, -1) * wk, co, nk, big,
                   torch.full((n_b,), k * big * big, device=vals.device), 2)
    return _from_rows(g, (n_cls, big, big))


def insert_sweep_plain(ft, ctf, img_idx, rot, trans, w, r_u: int, pf: int, size: int,
                       pixel_size: float, f_grid: torch.Tensor, t_grid: torch.Tensor, d=None,
                       f64_sums: bool = False):
    """Plain version of HK11: HK3's value formation then the sweep, 256
    slices at a time.  ``f64_sums``: the float32 taps summed in float64,
    then rounded (the reference the kernel's exact sums are held to on the
    card, where float32 sums of ~1e5 taps a cell part from them by ~3e-5).
    Returns the new (F, T)."""
    big = f_grid.shape[-1]
    g = _grid_rows(f_grid, t_grid, torch.float64 if f64_sums else REAL)
    for lo in range(0, rot.shape[0], 256):
        sl = slice(lo, lo + 256)
        vals, c2w, _, _ = dense_slice_values(
            ft, ctf, img_idx[sl], trans[sl], w[sl], r_u, size, pixel_size,
            None if d is None else d[sl])
        _sweep_add(g, vals, c2w, sweep_coeffs(rot[sl], pf), 2 * r_u - 1, big,
                   torch.zeros(vals.shape[0], dtype=torch.int64, device=g.device), 3)
    return _from_rows(g, f_grid.shape)


def _check_grids(name: str, ft, size: int, r_u: int, f_grid, t_grid, shape) -> None:
    _native.require(ft.dtype == COMPLEX and ft.is_contiguous()
                    and ft.shape[-2:] == (size, size),
                    f"{name}: ft must be contiguous (L, size, size) complex64")
    _native.require(f_grid.shape == shape and f_grid.dtype == COMPLEX
                    and t_grid.shape == shape and t_grid.dtype == REAL
                    and f_grid.is_contiguous() and t_grid.is_contiguous(),
                    f"{name}: grids must be contiguous {tuple(shape)}")
    _native.require(2 * r_u - 1 <= size, f"{name}: window exceeds the image box")


def insert_sweep(ft: torch.Tensor, ctf: CtfParams, img_idx: torch.Tensor, rot: torch.Tensor,
                 trans: torch.Tensor, w: torch.Tensor, r_u: int, pf: int, size: int,
                 pixel_size: float, big: int, f_grid: torch.Tensor | None = None,
                 t_grid: torch.Tensor | None = None, d: torch.Tensor | None = None,
                 recs: torch.Tensor | None = None):
    """HK11: insert B compacted slices into (F, T) (big^3, centered) with
    thunder_tpu's shear-sweep map (the rounds' insertion, thunder_tpu
    optimiser.py _insert_flat3d_h), forming each dense-window value as
    HK3 does (:func:`dense_slice_values`).  Same arguments as
    :func:`insert_trilinear`.  CPU tensors take
    :func:`insert_sweep_plain`; CUDA tensors launch
    csrc/insert_trilinear.cu's brick-owned sweep, reading the planes'
    :func:`sweep_coeffs` formed here: fixed-point sums, so two calls give
    identical bits (:func:`insert_sweep_fixed_plain` gives them too).
    ``recs`` (B, nk^2, 4) float32, CUDA: the first pass's scratch
    (allocated when None); it holds the formed values after the call."""
    dev = ft.device
    if f_grid is None:
        f_grid = torch.zeros((big,) * 3, dtype=COMPLEX, device=dev)
    if t_grid is None:
        t_grid = torch.zeros((big,) * 3, dtype=REAL, device=dev)
    if not ft.is_cuda:
        f_new, t_new = insert_sweep_plain(ft, ctf, img_idx, rot, trans, w, r_u, pf, size,
                                          pixel_size, f_grid, t_grid, d)
        f_grid.copy_(f_new)
        t_grid.copy_(t_new)
        return f_grid, t_grid
    _check_grids("insert_sweep", ft, size, r_u, f_grid, t_grid, (big,) * 3)
    n_s = rot.shape[0]
    if d is not None:
        _native.require(d.shape == (n_s,), "insert_sweep: d must be (B,)")
        d = d.to(REAL).contiguous()
    if n_s == 0:
        return f_grid, t_grid
    ctfk = ctf_constants(ctf)
    co = sweep_coeffs(rot, pf).contiguous()
    img_idx = img_idx.to(torch.int32).contiguous()
    rot = rot.to(REAL).reshape(n_s, 9).contiguous()
    trans = trans.to(REAL).contiguous()
    w = w.to(REAL).contiguous()
    nk2 = (2 * r_u - 1) ** 2
    if recs is None:
        recs = torch.empty((n_s, nk2, 4), dtype=REAL, device=dev)
    _native.require(recs.shape == (n_s, nk2, 4) and recs.dtype == REAL and recs.is_contiguous(),
                    "insert_sweep: recs must be contiguous (B, nk^2, 4) float32")
    vmax = torch.empty(4, dtype=torch.int32, device=dev)
    lib = _native.library()
    insert_sweep.launches += 1
    _native.check(lib.thunder_insert_sweep(
        ft.data_ptr(), size, ctfk.data_ptr(), img_idx.data_ptr(), rot.data_ptr(),
        co.data_ptr(), trans.data_ptr(), w.data_ptr(), None if d is None else d.data_ptr(),
        n_s, r_u, pf, float((r_u - 1) * pf), float(pixel_size * size),
        float(2 * np.pi / size), f_grid.data_ptr(), t_grid.data_ptr(), recs.data_ptr(), big,
        vmax.data_ptr(), sweep_fixed_count(n_s, r_u), _native.stream_ptr(ft)),
        "insert_sweep")
    return f_grid, t_grid


insert_sweep.launches = 0


def insert_sweep_slab_plain(vals: torch.Tensor, ctf2w: torch.Tensor, rot: torch.Tensor,
                            cls: torch.Tensor, r_u: int, pf: int, sym_mats: torch.Tensor,
                            f_slab: torch.Tensor, t_slab: torch.Tensor, z0: int,
                            f64_sums: bool = False):
    """Plain version of HK11's slab form (see :func:`insert_sweep_slab`),
    256 slices at a time (``f64_sums``: as :func:`insert_sweep_plain`).
    Returns the new (F, T) slabs."""
    bz, big = f_slab.shape[1], f_slab.shape[-1]
    n_sym = sym_mats.shape[0]
    g = _grid_rows(f_slab, t_slab, torch.float64 if f64_sums else REAL)
    mate = torch.arange(n_sym, device=vals.device)
    for lo in range(0, rot.shape[0], 256):
        sl = slice(lo, lo + 256)
        n = vals[sl].shape[0]
        co = sweep_planes(rot[sl], sym_mats, pf)
        rows = (cls[sl].long() * (bz * big * big))[:, None].expand(n, n_sym).reshape(-1)
        _sweep_add(g, vals[sl].repeat_interleave(n_sym, 0),
                   ctf2w[sl].repeat_interleave(n_sym, 0), co, 2 * r_u - 1, big, rows, 3, z0,
                   bz, (mate > 0).repeat(n), float((r_u - 1) * pf) ** 2)
    return _from_rows(g, f_slab.shape)


def insert_sweep_slab(vals: torch.Tensor, ctf2w: torch.Tensor, rot: torch.Tensor,
                      cls: torch.Tensor, r_u: int, pf: int, sym_mats: torch.Tensor,
                      n_class: int, big: int, z0: int, bz: int,
                      f_slab: torch.Tensor | None = None, t_slab: torch.Tensor | None = None):
    """HK11's slab form: insert formed slices into this rank's z-slab of
    the (F, T) grids with the shear sweep, every mate of the point group
    pose-side (thunder_tpu recon/sharded.py insert_sweep_3d_sharded).

    vals (B, nk^2) complex64 and ctf2w (B, nk^2) float32 are the dense
    window's values with their weights in (:func:`dense_slice_values`,
    nk = 2 r_u - 1), rot (B, 3, 3), cls (B,) each slice's class;
    sym_mats (n_sym, 3, 3), the identity first; the slabs (K, bz, big,
    big) hold planes [z0, z0 + bz) and are accumulated into (zeros when
    None).  Each (slice s, mate M) is the plane M R_s; a mate other than
    the identity adds only to cells inside the radius (HK7's cut), so that
    for a group of signed permutations the slabs equal HK11 then HK7 up to
    float order.  CPU tensors take :func:`insert_sweep_slab_plain`; CUDA
    tensors launch csrc/insert_trilinear.cu's brick-owned sweep over the
    planes' :func:`sweep_planes` formed here: fixed-point sums, so two
    calls give identical bits (:func:`insert_sweep_slab_fixed_plain`
    gives them too)."""
    dev = vals.device
    if f_slab is None:
        f_slab = torch.zeros((n_class, bz, big, big), dtype=COMPLEX, device=dev)
    if t_slab is None:
        t_slab = torch.zeros((n_class, bz, big, big), dtype=REAL, device=dev)
    if not vals.is_cuda:
        f_new, t_new = insert_sweep_slab_plain(vals, ctf2w, rot, cls, r_u, pf, sym_mats,
                                               f_slab, t_slab, z0)
        f_slab.copy_(f_new)
        t_slab.copy_(t_new)
        return f_slab, t_slab
    nk2 = (2 * r_u - 1) ** 2
    n_s = rot.shape[0]
    _native.require(vals.dtype == COMPLEX and vals.shape == (n_s, nk2)
                    and ctf2w.shape == (n_s, nk2) and cls.shape == (n_s,),
                    "insert_sweep_slab: vals complex64 (B, nk^2), ctf2w (B, nk^2), cls (B,)")
    _native.require(f_slab.shape == (n_class, bz, big, big) and f_slab.dtype == COMPLEX
                    and t_slab.shape == f_slab.shape and t_slab.dtype == REAL
                    and f_slab.is_contiguous() and t_slab.is_contiguous(),
                    "insert_sweep_slab: slabs must be contiguous (K, bz, big, big)")
    mats = sym_mats.to(device=dev, dtype=REAL)
    _native.require(1 <= mats.shape[0] <= INSERT_SLAB_MAX_SYM,
                    f"insert_sweep_slab: at most {INSERT_SLAB_MAX_SYM} mates a launch")
    if n_s == 0:
        return f_slab, t_slab
    recs = torch.empty((n_s, nk2, 4), dtype=REAL, device=dev)
    recs[..., :2].copy_(torch.view_as_real(vals))
    recs[..., 2].copy_(ctf2w)
    recs[..., 3].zero_()
    co = sweep_planes(rot, mats, pf).contiguous()
    rot = rot.to(REAL).reshape(n_s, 9).contiguous()
    cls = cls.to(torch.int32).contiguous()
    n_sym = mats.shape[0]
    mats = mats.reshape(-1, 9).contiguous()
    vmax = torch.empty(4, dtype=torch.int32, device=dev)
    lib = _native.library()
    insert_sweep_slab.launches += 1
    _native.check(lib.thunder_insert_sweep_slab(
        recs.data_ptr(), rot.data_ptr(), co.data_ptr(), cls.data_ptr(), n_s, r_u, pf,
        float((r_u - 1) * pf), mats.data_ptr(), n_sym, f_slab.data_ptr(),
        t_slab.data_ptr(), n_class, big, z0, bz, vmax.data_ptr(),
        sweep_fixed_count(n_s * n_sym, r_u), _native.stream_ptr(vals)),
        "insert_sweep_slab")
    return f_slab, t_slab


insert_sweep_slab.launches = 0


def insert_sweep_2d_plain_values(ft, ctf, img_idx, cls, rot, trans, w, r_u: int, pf: int,
                                 size: int, pixel_size: float, f_grid: torch.Tensor,
                                 t_grid: torch.Tensor, f64_sums: bool = False):
    """Plain version of HK12: HK6's value formation then the 2D sweep
    into plane cls[s], 256 slices at a time (``f64_sums``: as
    :func:`insert_sweep_plain`).  Returns the new (F, T)."""
    big = f_grid.shape[-1]
    g = _grid_rows(f_grid, t_grid, torch.float64 if f64_sums else REAL)
    for lo in range(0, rot.shape[0], 256):
        sl = slice(lo, lo + 256)
        vals, c2w, _, _ = dense_slice_values(ft, ctf, img_idx[sl], trans[sl], w[sl], r_u,
                                             size, pixel_size)
        _sweep_add(g, vals, c2w, sweep_coeffs_2d(rot[sl], pf), 2 * r_u - 1, big,
                   cls[sl].long() * (big * big), 2)
    return _from_rows(g, f_grid.shape)


def sweep_window_2d(big: int, max_radius_pad: float) -> tuple:
    """(first index, width) of the square of plane cells the 2D sweep
    of samples at |p| < max_radius_pad can reach (within
    SWEEP_REACH_2D), clipped to the plane."""
    m = math.ceil(max_radius_pad + SWEEP_REACH_2D)
    lo = max(0, big // 2 - m)
    return lo, min(big, big // 2 + m + 1) - lo


def sweep_2d_plan(r_u: int, pf: int, big: int) -> dict:
    """HK12's launch plan: the window of plane cells the sweep can reach
    (first index, width, :func:`sweep_window_2d`), the tiles that cover
    it, and the shared-memory bytes of a block (three 128-bit sums a tile
    cell, two ramp tables of nk entries a warp)."""
    win_lo, win = sweep_window_2d(big, float((r_u - 1) * pf))
    n_t = -(-win // SWEEP_2D_TILE)
    return dict(win_lo=win_lo, win=win, tiles=n_t * n_t,
                smem=3 * 16 * SWEEP_2D_TILE ** 2 + SWEEP_2D_THREADS // 32 * 16 * (2 * r_u - 1))


def insert_sweep_2d(ft: torch.Tensor, ctf: CtfParams, img_idx: torch.Tensor,
                    cls: torch.Tensor, rot: torch.Tensor, trans: torch.Tensor, w: torch.Tensor,
                    r_u: int, pf: int, size: int, pixel_size: float, big: int, n_class: int,
                    f_grid: torch.Tensor | None = None, t_grid: torch.Tensor | None = None,
                    recs: torch.Tensor | None = None):
    """HK12: insert B compacted 2D slices into per-class (F, T) planes
    with thunder_tpu's 2D shear-sweep map (optimiser.py one_2d_sweep,
    ops/insert.py insert_sweep_2d).  Same arguments as
    :func:`insert_bilinear_2d`.  CPU tensors take
    :func:`insert_sweep_2d_plain_values`; CUDA tensors launch
    csrc/insert_bilinear_2d.cu's tile-owned sweep over the slices sorted
    by :func:`insert_2d_work`, reading their :func:`sweep_coeffs_2d`
    formed here: fixed-point sums, so two calls give identical bits
    (:func:`insert_sweep_2d_fixed_plain` gives them too).  ``recs`` (L,
    nk^2, 4) float32, CUDA: the first pass's scratch (allocated when
    None); it holds the images' records after the call."""
    dev = ft.device
    if f_grid is None:
        f_grid = torch.zeros((n_class, big, big), dtype=COMPLEX, device=dev)
    if t_grid is None:
        t_grid = torch.zeros((n_class, big, big), dtype=REAL, device=dev)
    if not ft.is_cuda:
        return insert_sweep_2d_plain_values(ft, ctf, img_idx, cls, rot, trans, w, r_u, pf,
                                            size, pixel_size, f_grid, t_grid)
    _check_grids("insert_sweep_2d", ft, size, r_u, f_grid, t_grid, (n_class, big, big))
    n_s = rot.shape[0]
    if n_s == 0:
        return f_grid, t_grid
    _native.require(0 <= int(cls.min()) and int(cls.max()) < n_class,
                    "insert_sweep_2d: a class index is past the planes")
    order, cls_start = insert_2d_work(img_idx, cls, n_class)
    plan = sweep_2d_plan(r_u, pf, big)
    _native.require(plan["smem"] <= _native.SMEM_MAX,
                    "insert_sweep_2d: a block's tile and ramp tables exceed shared memory")
    ctfk = ctf_constants(ctf)
    n_img, nk2 = ft.shape[0], (2 * r_u - 1) ** 2
    if recs is None:
        recs = torch.empty((n_img, nk2, 4), dtype=REAL, device=dev)
    _native.require(recs.shape == (n_img, nk2, 4) and recs.dtype == REAL
                    and recs.is_contiguous(),
                    "insert_sweep_2d: recs must be contiguous (L, nk^2, 4) float32")
    rec = sweep_coeffs_2d(rot[order], pf)
    co, flags = rec[:, :4].contiguous(), rec[:, 6].to(torch.int32).contiguous()
    img_idx = img_idx[order].to(torch.int32).contiguous()
    trans = trans[order].to(REAL).contiguous()
    w = w[order].to(REAL).contiguous()
    vmax = torch.empty(4, dtype=torch.int32, device=dev)
    lib = _native.library()
    insert_sweep_2d.launches += 1
    _native.check(lib.thunder_insert_sweep_2d(
        ft.data_ptr(), size, ctfk.data_ptr(), n_img, img_idx.data_ptr(),
        cls_start.data_ptr(), n_class, co.data_ptr(), flags.data_ptr(), trans.data_ptr(),
        w.data_ptr(), n_s, r_u, float((r_u - 1) * pf), float(pixel_size * size),
        float(2 * np.pi / size), f_grid.data_ptr(), t_grid.data_ptr(), recs.data_ptr(), big,
        plan["win_lo"], plan["win"], SWEEP_2D_THREADS, plan["smem"], vmax.data_ptr(),
        sweep_fixed_count(n_s, r_u), _native.stream_ptr(ft)), "insert_sweep_2d")
    return f_grid, t_grid


insert_sweep_2d.launches = 0


# -- the gathers' enumeration on the CPU --------------------------------
#
# The gathers cannot run here; these plain versions enumerate
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


# the sweep's reach, as the kernels state it (float32, and the margin):
# 3D, a cell within sqrt 30 of a sample (|m - P_m| < 1, |l - P_l| < 1 +
# |q_m| <= 2, |a - P_a| < 2 + 2 |alpha| + |beta| <= 5 in canonical axes)
# and within 2 of the plane along its normal (n . k = n_a (a - zeta),
# |n_a| <= 1); 2D, within sqrt 5 (|y - P_y| < 1, |x - P_x| < 1 + |q_y| <=
# 2)
SWEEP_REACH_3D = float(np.float32(np.float32(math.sqrt(30)) + np.float32(1e-2)))
SWEEP_BAND = float(np.float32(2 + np.float32(1e-2)))
SWEEP_REACH_2D = float(np.float32(np.float32(math.sqrt(5)) + np.float32(1e-2)))


def _gather_plain(vals, c2w, rot, cls, r_u: int, pf: int, f_grid, t_grid,
                  z0: int, wsl=None):
    """The gather of HK3 (3D: rot (B, 3, 3), grids (K, bz, big, big) from
    plane z0) or HK6 (2D: rot (B, 2, 2), grids (K, big, big)) on CPU
    tensors: every virtual cell within max_radius_pad + REACH takes, for
    each slice in order, the candidates (vc, vr) of the kernels' range and
    prefilter (R g within GATHER_STRIP of the cell on every axis), the
    exact position and cuts of the scatter, and the taps that land on it;
    face cells then add their virtual cells.  Only pixels with vc^2 + vr^2
    < (r_u - 1)^2 enter; ``wsl``: slices of weight zero are skipped.
    Returns the new grids."""
    nd = rot.shape[-1]
    n_cls, big = f_grid.shape[0], f_grid.shape[-1]
    bz = f_grid.shape[1] if nd == 3 else 1
    cb, rr, nk = big // 2, r_u - 1, 2 * r_u - 1
    mrp2 = float((rr * pf) ** 2)
    vlo, vhi = tap_range(big, float(rr * pf))
    reach = GATHER_REACH_3D if nd == 3 else GATHER_REACH_2D
    axes = [_virtual_axis(0, big - 1, big, vlo, vhi)] * 2
    if nd == 3:
        axes = [_virtual_axis(z0, z0 + bz - 1, big, vlo, vhi)] + axes
    v = torch.stack([g.reshape(-1) for g in torch.meshgrid(*axes, indexing="ij")], -1)
    real = torch.clamp(v, 0, big - 1)
    kr2 = ((real - cb) ** 2).sum(-1).to(REAL)
    keep = kr2 < (rr * pf + reach) ** 2
    v, real, kr2 = v[keep], real[keep], kr2[keep]
    k = (v - cb).to(REAL).flip(-1)                    # (x, y[, z]) of each virtual cell
    vx = [v[:, -1 - i] for i in range(nd)]            # virtual index by axis x, y[, z]
    vals = vals.reshape(vals.shape[0], -1)
    c2w = c2w.reshape(c2w.shape[0], -1).to(REAL)
    n_cand = int(2 * reach / pf) + 1
    acc = torch.zeros((n_cls, k.shape[0], 3), dtype=REAL)
    for s in range(rot.shape[0]):
        if wsl is not None and float(wsl[s]) == 0.0:
            continue
        c = 0 if cls is None else int(cls[s])
        rs = rot[s].to(REAL)
        a = [sum(rs[i, j] * k[:, i] for i in range(nd)) for j in range(nd)]
        ok = torch.ones(k.shape[0], dtype=torch.bool)
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
                p = [rs[i, 0] * gx + rs[i, 1] * gy for i in range(nd)]
                for i in range(nd):     # R g within a cell (and the margin) on each axis
                    hit = hit & ((p[i] - k[:, i]).abs() < GATHER_STRIP)
                hit = hit & (vc * vc + vr * vr < rr * rr)
                r2 = p[0] * p[0] + p[1] * p[1]
                if nd == 3:
                    r2 = r2 + p[2] * p[2]
                hit = hit & (r2 < mrp2)
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
    f, t = _gather_plain(vals, c2w, rot, None, r_u, pf, f_grid[None], t_grid[None], 0,
                         w)
    return f[0], t[0]


def insert_bilinear_2d_gather_plain(ft, ctf, img_idx, cls, rot, trans, w, r_u: int, pf: int,
                                    size: int, pixel_size: float, f_grid, t_grid):
    """HK6's gather on the CPU (same arguments and result as
    :func:`insert_bilinear_2d_plain`), the slices taken in the order of
    :func:`insert_2d_work`."""
    order, _ = insert_2d_work(img_idx, cls, f_grid.shape[0])
    vals, c2w, _, _ = dense_slice_values(ft, ctf, img_idx[order], trans[order], w[order], r_u,
                                         size, pixel_size)
    return _gather_plain(vals, c2w, rot[order], cls[order], r_u, pf, f_grid, t_grid, 0,
                         w[order])


def _mkb_candidates(c0, c1, elo, ehi, rr: int, pf: int) -> list:
    """HK10's samples (vc, vr) of a plane (R's first two columns c0, c1)
    that can reach a part whose box widened by the reach is [elo, ehi], in
    the order its warp queues them: by row vr, then vc.  float32 as the
    kernel forms them (the margins cover the contraction of its sums and
    its reciprocal)."""
    f32 = np.float32
    fpf = f32(pf)
    margin = f32(MKB_MARGIN)
    mid, half = f32(0), f32(0)
    for i in range(3):
        mid = f32(mid + f32(f32(c1[i] * f32(0.5)) * f32(elo[i] + ehi[i])))
        half = f32(half + f32(f32(abs(c1[i]) * f32(0.5)) * f32(ehi[i] - elo[i])))
    vr_lo = max(-rr, math.ceil(f32(f32(mid - half) / fpf)))
    vr_hi = min(rr, math.floor(f32(f32(mid + half) / fpf)))
    out = []
    for vr in range(vr_lo, vr_hi + 1):
        m = math.isqrt(rr * rr - vr * vr)
        lo, hi = -m, m
        for i in range(3):
            base, stp = f32(f32(fpf * f32(vr)) * c1[i]), f32(fpf * c0[i])
            if abs(stp) > f32(1e-6):
                inv = f32(f32(1) / stp)
                t0, t1 = f32(f32(elo[i] - base) * inv), f32(f32(ehi[i] - base) * inv)
                lo = max(lo, math.ceil(f32(min(t0, t1) - margin)))
                hi = min(hi, math.floor(f32(max(t0, t1) + margin)))
            elif base < elo[i] or base > ehi[i]:
                hi = lo - 1
        out.extend((vc, vr) for vc in range(lo, hi + 1))
    return out


def _mkb_listed(normal_ok: np.ndarray) -> list:
    """The chunks of planes an HK10 block lists at once, in slice order:
    it scans MKB_THREADS slices a step and stops a chunk before it could
    pass MKB_CAP (``normal_ok``: the slices that pass its tests)."""
    chunks, base, n = [], 0, normal_ok.shape[0]
    while base < n:
        chunk = []
        while base < n and len(chunk) + MKB_THREADS <= MKB_CAP:
            chunk.extend(np.nonzero(normal_ok[base:base + MKB_THREADS])[0] + base)
            base += MKB_THREADS
        chunks.append(chunk)
    return chunks


def _mkb_brick_plain(vals, c2w, rot, wsl, r_u: int, pf: int, f_grid, t_grid, a: float,
                     alpha: float):
    """HK10's enumeration (csrc/insert_mkb.cu) on CPU tensors, grids
    (big^3): each brick of 8^3 cells lists the slices of nonzero
    weight whose normal passes within its half-diagonal + the reach of its
    centre (:func:`_mkb_listed`); each of its eight warps takes an eighth
    of each list, in order, queues those planes' samples that can reach
    the brick (:func:`_mkb_candidates`) and adds their taps that land in
    it to sums of its own in the order (queued sample, tap j = 16 z + 4 y
    + x), taps that meet in a cell one after another; the warps' sums are
    added in warp order.  Returns the new grids."""
    f32 = np.float32
    big = f_grid.shape[-1]
    cb, rr, nk = big // 2, r_u - 1, 2 * r_u - 1
    mrp = f32(rr * pf)
    mrp2 = f32(mrp * mrp)
    a2, inv_a2, coef = mkb_constants(a, alpha)
    reach = f32(mkb_reach(a))
    vlo, vhi = tap_range(big, float(mrp), "mkb")
    brick = (MKB_BXY, MKB_BXY, MKB_BZ)
    warps = MKB_THREADS // 32
    rot = rot.to(REAL).reshape(-1, 3, 3)
    rn = rot.numpy()
    upd = torch.stack([vals.real, vals.imag, c2w.to(REAL)], -1).reshape(vals.shape[0], -1, 3)
    total = torch.zeros((big ** 3, 3), dtype=REAL)
    d = torch.arange(4)
    weighted = np.array([float(x) != 0.0 for x in wsl])
    for b0 in itertools.product(*(range(0, big, e) for e in brick)):
        b1 = [min(b0[i] + brick[i], big) - 1 for i in range(3)]
        near = [f32(b0[i] - cb if b0[i] > cb else (cb - b1[i] if b1[i] < cb else 0))
                for i in range(3)]
        lim = f32(mrp + reach)
        if sum(x * x for x in near) >= lim * lim:
            continue
        lo = np.array([(min(vlo, 0) if b0[i] == 0 else b0[i]) - cb for i in range(3)], f32)
        hi = np.array([(max(vhi, big - 1) if b1[i] == big - 1 else b1[i]) - cb
                       for i in range(3)], f32)
        bc = f32(0.5) * (lo + hi)
        half = f32(0.5) * (hi - lo)
        be = f32(np.sqrt(np.sum(half * half, dtype=f32)))
        elo, ehi = lo - reach, hi + reach
        ok = weighted & (np.abs(np.float32(rn[:, 0, 2] * bc[0] + rn[:, 1, 2] * bc[1]
                                           + rn[:, 2, 2] * bc[2])) < f32(be + reach))
        planes = [[] for _ in range(warps)]
        for chunk in _mkb_listed(ok):
            for w in range(warps):
                planes[w].extend(chunk[len(chunk) * w // warps:len(chunk) * (w + 1) // warps])
        for w in range(warps):
            queue = [(s, vc, vr) for s in planes[w]
                     for vc, vr in _mkb_candidates(rn[s][:, 0], rn[s][:, 1], elo, ehi, rr, pf)]
            if not queue:
                continue
            sl, vc, vr = torch.tensor(queue).T
            gx, gy = (vc * pf).to(REAL), (vr * pf).to(REAL)
            p = [rot[sl, i, 0] * gx + rot[sl, i, 1] * gy for i in range(3)]
            keep = (p[0] * p[0] + p[1] * p[1]) + p[2] * p[2] < float(mrp2)
            axes = []
            for i in range(3):
                v = torch.floor(p[i]).to(torch.int64)[:, None] - 1 + cb + d
                real = torch.clamp(v, 0, big - 1)
                dx = (v - cb).to(REAL) - p[i][:, None]
                axes.append((real, (real >= b0[i]) & (real <= b1[i]), dx * dx))
            (rx, ix, sx), (ry, iy, sy), (rz, iz, sz) = axes
            # (sample, z, y, x) of every tap: the order of the adds
            cell = (rz[:, :, None, None] * big + ry[:, None, :, None]) * big + rx[:, None, None, :]
            inside = iz[:, :, None, None] & iy[:, None, :, None] & ix[:, None, None, :]
            d2 = (sx[:, None, None, :] + sy[:, None, :, None]) + sz[:, :, None, None]
            sel = torch.nonzero((keep[:, None, None, None] & inside & (d2 < a2)).reshape(-1))[:, 0]
            n = sel // 64
            src = upd[sl[n], (vr[n] + rr) * nk + vc[n] + rr]
            acc = torch.zeros((big ** 3, 3), dtype=REAL)
            acc.index_add_(0, cell.reshape(-1)[sel],
                           src * mkb_weight(d2.reshape(-1)[sel], inv_a2, coef)[:, None])
            total += acc
    g = torch.stack([f_grid.real.reshape(-1), f_grid.imag.reshape(-1), t_grid.reshape(-1)], -1)
    hit = (total != 0).any(-1)
    g[hit] = g[hit] + total[hit]
    shape = f_grid.shape
    return torch.complex(g[:, 0], g[:, 1]).reshape(shape), g[:, 2].reshape(shape)


def insert_mkb_brick_plain(ft, ctf, img_idx, rot, trans, w, r_u: int, pf: int, size: int,
                           pixel_size: float, f_grid, t_grid, d=None, a: float = DEFAULT_MKB_A,
                           alpha: float = DEFAULT_MKB_ALPHA):
    """HK10's enumeration on the CPU (same arguments and result as
    :func:`insert_mkb_plain`)."""
    vals, c2w, _, _ = dense_slice_values(ft, ctf, img_idx, trans, w, r_u, size, pixel_size, d,
                                         edge=True)
    return _mkb_brick_plain(vals, c2w, rot, w, r_u, pf, f_grid, t_grid, a, alpha)
