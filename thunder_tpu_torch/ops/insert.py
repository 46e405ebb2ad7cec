"""Weighted Fourier insertion (Reconstructor::insertP,
Reconstructor.cpp:569-866) — and the host of kernels HK3
(``insert_trilinear``, 3D) and HK6 (``insert_bilinear_2d``, per-class
2D planes).

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
from thunder_tpu_torch.physics.ctf import (CtfParams, ctf_constants,
                                           ctf_packed, ctf_packed_scaled)


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
                       w, r_u: int, size: int, pixel_size: float, d=None):
    """The value formation HK3 fuses: (vals (B, nk^2) complex,
    ctf2w (B, nk^2), vc, vr) for slices of images img_idx with
    translations trans (B, 2), weights w (B,) and, where given, defocus
    factors d (B,) scaling each slice's CTF (ctf_packed_scaled)."""
    vc, vr, mask_d = dense_window(r_u, ft.device)
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
    csrc/insert_trilinear.cu, which scatters into an interleaved
    (re, im, T, 0) scratch grid of big^3 x 16 bytes (allocated here) with
    one 16-byte atomic a tap, in a run-dependent order, and adds it into
    (F, T)."""
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
    scratch = torch.zeros((big ** 3, 4), dtype=REAL, device=dev)
    lib = _native.library()
    insert_trilinear.launches += 1
    _native.check(lib.thunder_insert_trilinear(
        ft.data_ptr(), size, ctfk.data_ptr(), img_idx.data_ptr(),
        rot.data_ptr(), trans.data_ptr(), w.data_ptr(),
        None if d is None else d.data_ptr(), n_s, r_u, pf,
        float((r_u - 1) * pf), float(pixel_size * size),
        float(2 * np.pi / size), f_grid.data_ptr(), t_grid.data_ptr(),
        scratch.data_ptr(), big, _native.stream_ptr(ft)), "insert_trilinear")
    return f_grid, t_grid


insert_trilinear.launches = 0


# -- HK6 ----------------------------------------------------------------

INSERT_2D_SLICES = 512     # slices a work item gathers (whole images of one class)
# the kernel's compile-time constants, read from its source: slices
# whose ramp tables a block stages at once, threads a block, in-disc
# pixels a thread holds at a time
INSERT_2D_BATCH, INSERT_2D_THREADS, INSERT_2D_PX_MAX = (
    _native.csrc_constant("insert_bilinear_2d.cu", n) for n in ("BATCH", "THREADS", "PX_MAX"))


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
    m = math.ceil(max_radius_pad)
    lo = max(0, big // 2 - m - 1)
    return lo, min(big, big // 2 + m + 2) - lo


def in_disc_pixels(r_u: int, device=None) -> torch.Tensor:
    """The dense-window pixels HK6 inserts (|k| < r_u - 1, the mask of
    :func:`dense_window`) as flat window indices (vr + r_u - 1) nk +
    (vc + r_u - 1), int32."""
    return torch.nonzero(dense_window(r_u, device)[2] > 0)[:, 0].to(torch.int32)


def insert_2d_work(img_idx: torch.Tensor, cls: torch.Tensor,
                   chunk: int = INSERT_2D_SLICES):
    """HK6's work: (order, runs, work).  ``order`` sorts the slices by
    (class, image); ``runs`` (n_run, 2) int32 holds [first, end) of each
    image's slices in that order; ``work`` (n_work, 3) int32 holds
    (class, first run, end run): a class's runs cut, at image
    boundaries, into items whose first runs start within one ``chunk``
    of slices (an item holds at most chunk + one image's slices)."""
    img, k = img_idx.long(), cls.long()
    order = torch.argsort(k * (img.max() + 1) + img, stable=True)
    k_s = k[order]
    _, counts = torch.unique_consecutive(k_s * (img.max() + 1) + img[order],
                                         return_counts=True)
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    run_cls = k_s[starts]
    bucket = (starts - torch.searchsorted(k_s, run_cls)) // chunk
    _, n_runs = torch.unique_consecutive(run_cls * (k_s.numel() + 1) + bucket,
                                         return_counts=True)
    last = torch.cumsum(n_runs, 0)
    first = last - n_runs
    runs = torch.stack([starts, ends], 1).to(torch.int32)
    work = torch.stack([run_cls[first], first, last], 1).to(torch.int32)
    return order, runs, work


def insert_2d_plan(r_u: int, pf: int, big: int) -> dict:
    """HK6's launch plan: the window of plane cells (first index, width),
    the rows a block holds (one band where the window and a batch's ramp
    tables fit in Hopper's 227 KB, else bands), the shared-memory bytes,
    the in-disc pixel count and the pixels a thread holds at a time."""
    mrp = float((r_u - 1) * pf)
    win_lo, win = insert_window(big, mrp)
    nk = 2 * r_u - 1
    tables = INSERT_2D_BATCH * (16 * nk + 20)
    band_h = max(1, min(win, (_native.SMEM_MAX - tables) // (12 * win)))
    npx = int((dense_window(r_u)[2] > 0).sum())
    pxt = max(1, min(INSERT_2D_PX_MAX, -(-npx // INSERT_2D_THREADS)))
    return dict(win_lo=win_lo, win=win, band_h=band_h, n_band=-(-win // band_h),
                smem=tables + 12 * band_h * win, npx=npx, pxt=pxt)


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
    CUDA tensors launch csrc/insert_bilinear_2d.cu over the work of
    :func:`insert_2d_work`, whose atomics add in a run-dependent order."""
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
    order, runs, work = insert_2d_work(img_idx, cls)
    _native.require(0 <= int(work[:, 0].min()) and int(work[-1, 0]) < n_class,
                    "insert_bilinear_2d: a class index is past the planes")
    plan = insert_2d_plan(r_u, pf, big)
    px = in_disc_pixels(r_u, dev)
    ctfk = ctf_constants(ctf)
    img_idx = img_idx[order].to(torch.int32).contiguous()
    rot = rot[order].to(REAL).reshape(n_s, 4).contiguous()
    trans = trans[order].to(REAL).contiguous()
    w = w[order].to(REAL).contiguous()
    lib = _native.library()
    insert_bilinear_2d.launches += 1
    _native.check(lib.thunder_insert_bilinear_2d(
        ft.data_ptr(), size, ctfk.data_ptr(), img_idx.data_ptr(), runs.data_ptr(),
        work.data_ptr(), work.shape[0], rot.data_ptr(), trans.data_ptr(),
        w.data_ptr(), px.data_ptr(), plan["npx"], plan["pxt"], r_u, pf,
        float((r_u - 1) * pf), float(pixel_size * size), float(2 * np.pi / size),
        f_grid.data_ptr(), t_grid.data_ptr(), big, plan["win_lo"], plan["win"],
        plan["band_h"], INSERT_2D_THREADS, plan["smem"], _native.stream_ptr(ft)),
        "insert_bilinear_2d")
    return f_grid, t_grid


insert_bilinear_2d.launches = 0


# -- HK9 ----------------------------------------------------------------

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
    CUDA tensors launch csrc/insert_trilinear_slab.cu."""
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
    vals = vals.contiguous()
    ctf2w = ctf2w.to(REAL).contiguous()
    rot = rot.to(REAL).reshape(n_s, 9).contiguous()
    cls = cls.to(torch.int32).contiguous()
    mats = sym_mats.to(device=dev, dtype=REAL).reshape(-1, 9).contiguous()
    scratch = torch.zeros((n_class * bz * big * big, 4), dtype=REAL, device=dev)
    lib = _native.library()
    insert_trilinear_slab.launches += 1
    _native.check(lib.thunder_insert_trilinear_slab(
        vals.data_ptr(), ctf2w.data_ptr(), rot.data_ptr(), cls.data_ptr(), n_s, r_u, pf,
        float((r_u - 1) * pf), mats.data_ptr(), mats.shape[0], f_slab.data_ptr(),
        t_slab.data_ptr(), scratch.data_ptr(), n_class, big, z0, bz,
        _native.stream_ptr(vals)), "insert_trilinear_slab")
    return f_slab, t_slab


insert_trilinear_slab.launches = 0
