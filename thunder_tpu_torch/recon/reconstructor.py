"""Gridding reconstruction: Wiener filter, iterative weight balancing,
final inverse transform + kernel correction (Reconstructor::reconstruct,
Reconstructor.cpp:1129-1831), as in thunder_tpu.recon.reconstructor.

Every function takes leading batch dims (hemisphere, class, pass) in
front of the centered grids, (big, big, big) in 3D or (big, big) in 2D
(``nd``; the 2D path is the 3D one with plane FFTs).  The balance loop runs in
rfft half-space; batched lanes are independent loops — a lane that has
stopped is frozen while the others go on (what the JAX package's vmapped
while_loop does), with one host check per iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.constants import (
    C_ABS_MIN,
    DEFAULT_MKB_A,
    DEFAULT_MKB_ALPHA,
    DIFF_C_DECREASE_THRES,
    DIFF_C_THRES,
    FSC_BASE_H,
    FSC_BASE_L,
    MAX_N_ITER_BALANCE,
    MIN_N_ITER_BALANCE,
    N_DIFF_C_NO_DECREASE,
    T_MIN,
    WIENER_FACTOR_MIN_R,
)
from thunder_tpu_torch.device import COMPLEX, REAL
from thunder_tpu_torch.ops.fourier import (
    centered_quad_dev,
    centered_shell_dev,
    extract_rl,
    radial_grid_dev,
)
from thunder_tpu_torch.physics.kernels import mkb_rl, tik_rl


def _ax(nd: int) -> tuple:
    return tuple(range(-nd, 0))


def _mkb_rl_nf(a: float, alpha: float) -> float:
    """MKB_RL(0) normalisation."""
    v = float(alpha)
    i0a = float(torch.special.i0(torch.tensor(v, dtype=torch.float64)))
    i32 = np.sqrt(2 / (np.pi * v)) * (np.cosh(v) - np.sinh(v) / v)
    return float((2 * np.pi) ** 1.5 * a ** 3 / i0a / v ** 1.5 * i32)


def _mkb_window(big: int, a: float, alpha: float, device,
                nd: int = 3) -> torch.Tensor:
    """Real-space MKB window over the padded FFT-layout grid, 1 at the
    origin (convoluteC, Reconstructor.cpp:2595-2674)."""
    r = radial_grid_dev(big, nd, device) / big
    return (mkb_rl(r, a, alpha) / _mkb_rl_nf(a, alpha)).to(REAL)


def _tik_correction(size: int, pf: int, device, nd: int = 3) -> torch.Tensor:
    r = radial_grid_dev(size, nd, device) / (pf * size)
    return tik_rl(r).to(REAL)


def _quad_inside(big: int, radius: float, device, nd: int = 3) -> torch.Tensor:
    return centered_quad_dev(big, nd, device) < radius ** 2


def wiener_filter_t(t_grid: torch.Tensor, fsc_curve: torch.Tensor, pf: int,
                    max_radius: int, join_half: bool,
                    nd: int = 3) -> torch.Tensor:
    """T /= clamp(FSC) on shells in [WIENER_FACTOR_MIN_R*pf, maxR*pf);
    fsc_curve (..., n_fsc) broadcasts against t_grid's leading dims."""
    big = t_grid.shape[-1]
    u = centered_shell_dev(big, nd, t_grid.device).long()
    n_fsc = fsc_curve.shape[-1]
    up = u // pf
    shell = torch.clamp(up, max=n_fsc - 1)
    fsc = fsc_curve[..., shell.reshape(-1)].reshape(
        fsc_curve.shape[:-1] + (big,) * nd)
    fsc = torch.where(up >= n_fsc, torch.zeros_like(fsc), fsc)
    fsc = torch.clamp(fsc, FSC_BASE_L, FSC_BASE_H)
    if join_half:
        fsc = torch.sqrt(2 * fsc / (1 + fsc))
    active = (u >= WIENER_FACTOR_MIN_R * pf) & (u < max_radius * pf)
    return torch.where(active, t_grid / fsc, t_grid)


def balance_weights(t_grid: torch.Tensor, pf: int, max_radius: int,
                    a: float = DEFAULT_MKB_A,
                    alpha: float = DEFAULT_MKB_ALPHA,
                    nd: int = 3) -> torch.Tensor:
    """W such that (T.W) convolved with the gridding window ~ 1
    (Reconstructor.cpp:1288-1551); t_grid (..., big^nd) real.

    Unlike thunder_tpu, only cells that received insertions (T above
    the 1e-25 floor) are updated and enter the convergence test.  In an
    empty cell C ~ 0, so W grows by 1e6 per iteration until T.W leaks
    into its neighbours' C; with exact trilinear insertion of a few
    hundred slices per hemisphere such holes exist between the planes at
    high radius and the MAP-free pass turned chaotic (maps decorrelated
    from the truth within 3 rounds).  Where every cell is reached the
    iteration is thunder_tpu's exactly."""
    big = t_grid.shape[-1]
    c = big // 2
    dev = t_grid.device
    ax = _ax(nd)
    window = _mkb_window(big, a, alpha, dev, nd)
    shape = (big,) * nd

    def to_half(x):
        return torch.fft.ifftshift(x, dim=ax)[..., :c + 1]

    inside = to_half(_quad_inside(big, max_radius * pf, dev, nd))
    t_half = to_half(torch.clamp(t_grid, min=T_MIN))
    # cells no slice reached keep W = 1 (see the docstring)
    inside_h = inside & (t_half > T_MIN)
    lanes = t_grid.shape[:-nd]
    w = torch.where(inside, 1.0, 0.0).to(REAL).expand(t_half.shape).clone()

    def convolute_c(c_half):
        c_rl = torch.fft.irfftn(c_half.to(torch.complex64), s=shape, dim=ax)
        return torch.fft.rfftn(c_rl * window, dim=ax)

    fmax = float(np.finfo(np.float32).max)
    diff_prev = torch.full(lanes, fmax, dtype=REAL, device=dev)
    n_no_dec = torch.zeros(lanes, dtype=torch.int64, device=dev)
    it = torch.zeros(lanes, dtype=torch.int64, device=dev)
    active = torch.ones(lanes, dtype=torch.bool, device=dev)
    for _ in range(MAX_N_ITER_BALANCE):
        c_abs = convolute_c(t_half * w).abs()
        w_new = torch.where(inside_h, w / torch.clamp(c_abs, min=C_ABS_MIN), w)
        diff = torch.amax(torch.where(inside_h, (c_abs - 1.0).abs(),
                                      torch.zeros_like(c_abs)), dim=ax)
        nnd = torch.where(diff > diff_prev * DIFF_C_DECREASE_THRES,
                          n_no_dec + 1, torch.zeros_like(n_no_dec))
        act = active.reshape(lanes + (1,) * nd)
        w = torch.where(act, w_new, w)
        diff_prev = torch.where(active, diff, diff_prev)
        n_no_dec = torch.where(active, nnd, n_no_dec)
        it = it + active.long()
        not_stalled = (it < MIN_N_ITER_BALANCE) | (n_no_dec < N_DIFF_C_NO_DECREASE)
        active = (active & (it < MAX_N_ITER_BALANCE)
                  & (diff_prev >= DIFF_C_THRES) & not_stalled)
        if not bool(active.any()):
            break

    # expand the real, even W back to the full centered grid by mirror
    idx = torch.arange(big, device=dev)
    mirror = (big - idx) % big
    take_mirror = idx > c
    gx = torch.clamp(torch.where(take_mirror, mirror, idx), max=c)
    if nd == 3:
        gz = torch.where(take_mirror[None, None, :], mirror[:, None, None],
                         idx[:, None, None])
        gy = torch.where(take_mirror[None, None, :], mirror[None, :, None],
                         idx[None, :, None])
        w_full = w[..., gz, gy, gx[None, None, :].expand(big, big, big)]
    else:
        gy = torch.where(take_mirror[None, :], mirror[:, None], idx[:, None])
        w_full = w[..., gy, gx[None, :].expand(big, big)]
    return torch.fft.fftshift(w_full, dim=ax)


def finalize_reconstruction(f_grid: torch.Tensor, w: torch.Tensor, size: int,
                            pf: int, max_radius: int,
                            nd: int = 3) -> torch.Tensor:
    """F.W -> c2r transform -> extract 1/pf -> trilinear kernel
    correction; (..., big^nd) -> (..., size^nd) real FFT layout."""
    big = f_grid.shape[-1]
    c = big // 2
    ax = _ax(nd)
    inside = _quad_inside(big, max_radius * pf, f_grid.device, nd)
    pad_dst = torch.where(inside, f_grid * w, torch.zeros_like(f_grid))
    half = torch.fft.ifftshift(pad_dst, dim=ax)[..., :c + 1]
    rl = torch.fft.irfftn(half, s=(big,) * nd, dim=ax)
    out = extract_rl(rl, pf, nd=nd)
    return out / _tik_correction(size, pf, f_grid.device, nd)


def reconstruct(f_grid, t_grid, size: int, pf: int,
                max_radius: int, nd: int = 3) -> torch.Tensor:
    """One MAP-free gridding reconstruction per batch entry (grid
    correction on)."""
    t_real = t_grid.real if t_grid.is_complex() else t_grid
    return finalize_reconstruction(
        f_grid, balance_weights(t_real, pf, max_radius, nd=nd), size, pf,
        max_radius, nd)


def reconstruct_two_pass(f_grid, t_grid, fsc_curve, size: int, pf: int,
                         max_radius: int, nd: int = 3):
    """The reference's per-round double reconstruction
    (Optimiser.cpp:7310-7755): the MAP-free FSC pass and the Wiener (MAP)
    pass from the same (F, T).  Both balance loops run cold (warm-
    starting the MAP pass is a trap, see the JAX package) and as batched
    independent lanes.  Returns (rec_fsc, rec_map)."""
    t_real = t_grid.real if t_grid.is_complex() else t_grid
    t_w = wiener_filter_t(t_real, fsc_curve, pf, max_radius, join_half=True,
                          nd=nd)
    w12 = balance_weights(torch.stack([t_real, t_w.expand_as(t_real)]), pf,
                          max_radius, nd=nd)
    rec = finalize_reconstruction(f_grid.unsqueeze(0), w12, size, pf,
                                  max_radius, nd)
    return rec[0], rec[1]


# -- HK7 ----------------------------------------------------------------

def symmetrize_ft_plain(f_grid: torch.Tensor, t_grid: torch.Tensor,
                        sym_mats: torch.Tensor, max_radius_pad: float):
    """Plain version of HK7 (thunder_tpu's symmetrize_ft arithmetic, on F
    and on T): see :func:`symmetrize_ft`."""
    big = f_grid.shape[-1]
    c = big // 2
    k = torch.arange(big, dtype=REAL, device=f_grid.device) - c
    kz, ky, kx = torch.meshgrid(k, k, k, indexing="ij")
    inside = (kx * kx + ky * ky + kz * kz) < max_radius_pad ** 2
    lead = f_grid.shape[:-3]
    ff = f_grid.reshape((-1, big ** 3))
    tf = t_grid.reshape((-1, big ** 3))
    f_out, t_out = f_grid.clone(), t_grid.clone()
    for rot in sym_mats[1:].to(REAL):
        x = rot[0, 0] * kx + rot[0, 1] * ky + rot[0, 2] * kz
        y = rot[1, 0] * kx + rot[1, 1] * ky + rot[1, 2] * kz
        z = rot[2, 0] * kx + rot[2, 1] * ky + rot[2, 2] * kz
        flx, fly, flz = torch.floor(x), torch.floor(y), torch.floor(z)
        wx, wy, wz = x - flx, y - fly, z - flz
        ix, iy, iz = flx.long() + c, fly.long() + c, flz.long() + c
        gf = gt = None
        for dz, dy, dx in ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
                           (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)):
            w = ((wz if dz else 1 - wz) * (wy if dy else 1 - wy)
                 * (wx if dx else 1 - wx))
            lin = ((torch.clamp(iz + dz, 0, big - 1) * big
                    + torch.clamp(iy + dy, 0, big - 1)) * big
                   + torch.clamp(ix + dx, 0, big - 1)).reshape(-1)
            w = w.reshape(-1)
            gf = ff[:, lin] * w if gf is None else gf + ff[:, lin] * w
            gt = tf[:, lin] * w if gt is None else gt + tf[:, lin] * w
        f_out = f_out + torch.where(inside, gf.reshape(lead + (big,) * 3), 0)
        t_out = t_out + torch.where(inside, gt.reshape(lead + (big,) * 3), 0)
    return f_out, t_out


def symmetrize_ft(f_grid: torch.Tensor, t_grid: torch.Tensor,
                  sym_mats: torch.Tensor, max_radius_pad: float):
    """Sum F and T over the symmetry group (SYMMETRIZE_FT,
    include/Geometry/Transformation.h:170-195):

        out(f) = grid(f) + sum_{s >= 1} [|f| < max_radius_pad]
                 trilinear(grid, R_s f)

    f_grid (..., big, big, big) complex64 and t_grid float32 of the same
    shape, centered; sym_mats (order, 3, 3), the identity first.  Returns
    new (F, T).  CPU tensors take :func:`symmetrize_ft_plain`; CUDA
    tensors launch csrc/symmetrize_ft.cu, one launch for every leading
    grid and for F and T together."""
    if sym_mats.shape[0] <= 1:
        return f_grid, t_grid
    if not f_grid.is_cuda:
        return symmetrize_ft_plain(f_grid, t_grid, sym_mats, max_radius_pad)
    big = f_grid.shape[-1]
    _native.require(f_grid.dtype == COMPLEX and t_grid.dtype == REAL
                    and t_grid.is_cuda and f_grid.shape == t_grid.shape
                    and f_grid.ndim >= 3 and f_grid.shape[-3:] == (big,) * 3
                    and f_grid.is_contiguous() and t_grid.is_contiguous(),
                    "symmetrize_ft: F complex64 and T float32, contiguous "
                    "(..., big, big, big) on the card")
    n_grids = f_grid.numel() // big ** 3
    _native.require(n_grids <= 65535, "symmetrize_ft: more than 65535 grids")
    mats = sym_mats.to(device=f_grid.device, dtype=REAL).contiguous()
    f_out, t_out = torch.empty_like(f_grid), torch.empty_like(t_grid)
    if n_grids == 0:
        return f_out, t_out
    lib = _native.library()
    symmetrize_ft.launches += 1
    symmetrize_ft.last_grids = n_grids
    _native.check(lib.thunder_symmetrize_ft(
        f_grid.data_ptr(), t_grid.data_ptr(), f_out.data_ptr(), t_out.data_ptr(),
        mats.data_ptr(), mats.shape[0] - 1, n_grids, big, float(max_radius_pad),
        _native.stream_ptr(f_grid)), "symmetrize_ft")
    return f_out, t_out


symmetrize_ft.launches = 0
symmetrize_ft.last_grids = 0    # the grids of the last launch
