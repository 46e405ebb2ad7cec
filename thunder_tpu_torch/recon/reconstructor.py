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

import ctypes

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


def _mkb_correction(size: int, pf: int, device, nd: int = 3,
                    a: float = DEFAULT_MKB_A,
                    alpha: float = DEFAULT_MKB_ALPHA) -> torch.Tensor:
    """Real-space MKB envelope of the blob-kernel option over the
    unpadded FFT-layout grid, 1 at the origin (Reconstructor.cpp:
    1785-1793: divide by MKB_RL(r / (pf N), a pf, alpha) and multiply by
    MKB_RL(0, ...))."""
    r = radial_grid_dev(size, nd, device) / (pf * size)
    return (mkb_rl(r, a * pf, alpha) / _mkb_rl_nf(a * pf, alpha)).to(REAL)


def grid_correction(size: int, pf: int, device, nd: int = 3,
                    kernel: str = "trilinear") -> torch.Tensor:
    """The real-space envelope the final map is divided by: the
    trilinear kernel's (TIK_RL) or, with ``kernel="mkb"``, the blob's."""
    if kernel == "mkb":
        return _mkb_correction(size, pf, device, nd)
    return _tik_correction(size, pf, device, nd)


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
                    nd: int = 3, kernel: str = "trilinear") -> torch.Tensor:
    """W such that (T.W) convolved with the gridding window ~ 1
    (Reconstructor.cpp:1288-1551); t_grid (..., big^nd) real.

    Unlike thunder_tpu, with trilinear insertion only cells that
    received insertions (T above the 1e-25 floor) are updated and enter
    the convergence test.  In an empty cell C ~ 0, so W grows by 1e6 per
    iteration until T.W leaks into its neighbours' C; with exact
    trilinear insertion of a few hundred slices per hemisphere such
    holes exist between the planes at high radius and the MAP-free pass
    turned chaotic (maps decorrelated from the truth within 3 rounds).
    Where every cell is reached the iteration is thunder_tpu's exactly.
    With the blob's insertion (``kernel="mkb"``, reach 1.9 cells) every
    cell inside the radius is updated, as thunder_tpu does: the only
    empty cells are the ring between insertion's reach and the radius,
    and there the two packages' maps agree only when W grows alike."""
    return _balance(t_grid, pf, max_radius, a, alpha, nd, kernel)[0]


def _balance(t_grid: torch.Tensor, pf: int, max_radius: int,
             a: float = DEFAULT_MKB_A, alpha: float = DEFAULT_MKB_ALPHA,
             nd: int = 3, kernel: str = "trilinear", n_iter: int | None = None,
             each=None) -> tuple:
    """The balance loop of :func:`balance_weights`: (W, each lane's count
    of iterations as a tensor).  ``n_iter`` runs every lane that many
    iterations with the stopping rule off; ``each(n, W)`` is called with
    the full W after iteration n.  The stop is a threshold, so two sums
    of one (F, T) in another order can stop iterations apart; the slab
    path's check in chip_smoke.py reads maps at several counts so."""
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
    # with trilinear taps cells no slice reached keep W = 1 (see
    # balance_weights)
    inside_h = inside if kernel == "mkb" else inside & (t_half > T_MIN)
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
    for _ in range(MAX_N_ITER_BALANCE if n_iter is None else n_iter):
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
        if each is not None:
            each(int(it.max()), _mirror_full(w, big, nd))
        if n_iter is not None:
            continue
        not_stalled = (it < MIN_N_ITER_BALANCE) | (n_no_dec < N_DIFF_C_NO_DECREASE)
        active = (active & (it < MAX_N_ITER_BALANCE)
                  & (diff_prev >= DIFF_C_THRES) & not_stalled)
        if not bool(active.any()):
            break
    return _mirror_full(w, big, nd), it


def _mirror_full(w: torch.Tensor, big: int, nd: int) -> torch.Tensor:
    """The real, even W of rfft half space expanded back to the full
    centered grid by mirror."""
    c = big // 2
    dev = w.device
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
    return torch.fft.fftshift(w_full, dim=_ax(nd))


def finalize_reconstruction(f_grid: torch.Tensor, w: torch.Tensor, size: int,
                            pf: int, max_radius: int, nd: int = 3,
                            grid_corr: bool = True,
                            kernel: str = "trilinear") -> torch.Tensor:
    """F.W -> c2r transform -> extract 1/pf -> the kernel's correction
    (:func:`grid_correction`; none without ``grid_corr``);
    (..., big^nd) -> (..., size^nd) real FFT layout."""
    big = f_grid.shape[-1]
    c = big // 2
    ax = _ax(nd)
    inside = _quad_inside(big, max_radius * pf, f_grid.device, nd)
    pad_dst = torch.where(inside, f_grid * w, torch.zeros_like(f_grid))
    half = torch.fft.ifftshift(pad_dst, dim=ax)[..., :c + 1]
    rl = torch.fft.irfftn(half, s=(big,) * nd, dim=ax)
    out = extract_rl(rl, pf, nd=nd)
    if grid_corr:
        out = out / grid_correction(size, pf, f_grid.device, nd, kernel)
    return out


def _weights(t_real: torch.Tensor, pf: int, max_radius: int, nd: int,
             grid_corr: bool, kernel: str) -> torch.Tensor:
    """W of the balance loop, or without grid correction W = 1 / T
    inside the radius and 0 outside (Reconstructor.cpp:1553-...)."""
    if grid_corr:
        return balance_weights(t_real, pf, max_radius, nd=nd, kernel=kernel)
    inside = _quad_inside(t_real.shape[-1], max_radius * pf, t_real.device, nd)
    return torch.where(inside, 1.0 / torch.clamp(t_real, min=T_MIN),
                       torch.zeros_like(t_real))


def reconstruct(f_grid, t_grid, size: int, pf: int,
                max_radius: int, nd: int = 3, grid_corr: bool = True,
                kernel: str = "trilinear") -> torch.Tensor:
    """One MAP-free gridding reconstruction per batch entry: the balance
    loop and the kernel's correction, or without ``grid_corr`` W = 1 / T
    and no correction."""
    t_real = t_grid.real if t_grid.is_complex() else t_grid
    return finalize_reconstruction(
        f_grid, _weights(t_real, pf, max_radius, nd, grid_corr, kernel), size, pf,
        max_radius, nd, grid_corr, kernel)


def reconstruct_two_pass(f_grid, t_grid, fsc_curve, size: int, pf: int,
                         max_radius: int, nd: int = 3,
                         kernel: str = "trilinear"):
    """The reference's per-round double reconstruction
    (Optimiser.cpp:7310-7755): the MAP-free FSC pass and the Wiener (MAP)
    pass from the same (F, T), both divided by ``kernel``'s correction.
    Both balance loops run cold (warm-starting the MAP pass is a trap,
    see the JAX package) and as batched independent lanes.  Returns
    (rec_fsc, rec_map)."""
    t_real = t_grid.real if t_grid.is_complex() else t_grid
    t_w = wiener_filter_t(t_real, fsc_curve, pf, max_radius, join_half=True,
                          nd=nd)
    w12 = balance_weights(torch.stack([t_real, t_w.expand_as(t_real)]), pf,
                          max_radius, nd=nd, kernel=kernel)
    rec = finalize_reconstruction(f_grid.unsqueeze(0), w12, size, pf,
                                  max_radius, nd, kernel=kernel)
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


SYM_BOX_BRICK, SYM_BOX_MAX, SYM_ORBIT_THREADS, SYM_MAX_ORBIT = (
    _native.csrc_constant("symmetrize_ft.cu", n)
    for n in ("BOX_BRICK", "BOX_MAX", "ORBIT_THREADS", "MAX_ORBIT"))
SYM_ORBIT_SMEM = 56 * 1024      # the orbit form's bricks: four blocks of 512 threads an SM


class SymForm(str):
    """HK7's form for a group, a str ("orbit", "orbit-cube" or "box"; see
    :func:`symmetrize_form`), carrying the group's signed permutations
    (orbit forms) and the tables of orbit representatives it has built,
    one a plan and device, so that a call reads nothing back from the
    card."""

    perms: np.ndarray | None = None

    def reps(self, plan: dict, device) -> torch.Tensor:
        """The least brick index of each orbit of ``plan``'s bricks under
        the group, int32 on ``device`` (built on first use)."""
        key = (plan["edges"], tuple(plan["n"]), str(device))
        cache = self.__dict__.setdefault("_reps", {})
        if key not in cache:
            n = np.asarray(plan["n"])
            half = n // 2
            idx = np.arange(int(n.prod()))
            m = np.stack([idx % n[0], idx // n[0] % n[1], idx // (n[0] * n[1])], -1) - half
            least = idx.copy()
            for p in self.perms[1:]:
                q = m @ p.T + half
                least = np.minimum(least, (q[:, 2] * n[1] + q[:, 1]) * n[0] + q[:, 0])
            cache[key] = torch.as_tensor(idx[least == idx].astype(np.int32), device=device)
        return cache[key]


def symmetrize_form(sym_mats) -> SymForm:
    """HK7's form for a group's matrices (order, 3, 3): "orbit" where every
    mate is a signed permutation (each entry within 1e-6 of 0 or +-1, one
    +-1 a row) that keeps z on its axis (C2, C4, D2, D4), "orbit-cube"
    where signed permutations move z onto x or y (O), else "box".  Reads
    the matrices on the host: form it once a group."""
    m = np.asarray(torch.as_tensor(sym_mats).detach().cpu(), np.float64)
    r = np.round(m)
    signed = (np.abs(m - r).max() < 1e-6 and np.all(np.abs(r).sum(-1) == 1)
              and np.all(np.abs(r).sum(-2) == 1))
    if not signed or m.shape[0] > SYM_MAX_ORBIT:
        return SymForm("box")
    form = SymForm("orbit" if np.all(np.abs(r[:, 2, 2]) == 1) else "orbit-cube")
    form.perms = r.astype(np.int64)
    return form


def symmetrize_plan(form: str, order: int, big: int, brick: tuple | None = None) -> dict:
    """Launch plan of HK7 (see csrc/symmetrize_ft.cu).  Orbit forms: odd
    bricks centered on multiples of their edges, indices -M..M an axis
    covering the centered grid, an orbit a block.  Where z stays on its
    axis ("orbit") the bricks are flat, b x b x 1 cells (long rows), b
    of 31, 29, 27, 25, 23 the edge whose bricks cover the grid's side
    most tightly (the larger on a tie), or 15 where those orbits of
    ``order`` bricks (F and T, 12 bytes a cell) pass SYM_ORBIT_SMEM;
    else ("orbit-cube") the largest cube of 11, 9, 7, 5 cells that fits.
    Box form: an 8^3 brick a block, two BOX_MAX^3 buffers and each
    mate's box.  ``brick``: other (xy, z) edges for an orbit form."""
    c = big // 2
    side = lambda b: 2 * max(-(((b - 1) // 2 - c) // b), (big - 1 - c + (b - 1) // 2) // b) + 1
    if form.startswith("orbit"):
        fits = lambda b, z: order * b * b * z * 12 <= SYM_ORBIT_SMEM
        if brick is not None:
            bxy, bz = brick
        elif form == "orbit":
            flat = [b for b in (31, 29, 27, 25, 23) if fits(b, 1)]
            bxy, bz = (min(flat, key=lambda b: (side(b) * b, -b)) if flat else 15), 1
        else:
            bxy = bz = next(b for b in (11, 9, 7, 5) if fits(b, b))
        edges = (bxy, bxy, bz)
        n = [side(b) for b in edges]
        return dict(orbit=1, edges=edges, n=n, threads=SYM_ORBIT_THREADS,
                    smem=order * bxy * bxy * bz * 12)
    nb = -(-big // SYM_BOX_BRICK)
    return dict(orbit=0, edges=(SYM_BOX_BRICK,) * 3, n=[nb] * 3, threads=SYM_BOX_BRICK ** 3,
                smem=2 * SYM_BOX_MAX ** 3 * 12 + 24 * (order - 1))


class _SymArgs(ctypes.Structure):
    """csrc/symmetrize_ft.cu's SymArgs."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("f_in", "t_in", "f_out", "t_out", "mats",
                                                "reps")] + [
        (n, ctypes.c_int) for n in ("n_mates", "big", "orbit", "bx", "by", "bz", "nx", "ny",
                                    "nz", "blocks")] + [
        ("r2max", ctypes.c_float)]


def symmetrize_ft(f_grid: torch.Tensor, t_grid: torch.Tensor,
                  sym_mats: torch.Tensor, max_radius_pad: float, form: SymForm | None = None):
    """Sum F and T over the symmetry group (SYMMETRIZE_FT,
    include/Geometry/Transformation.h:170-195):

        out(f) = grid(f) + sum_{s >= 1} [|f| < max_radius_pad]
                 trilinear(grid, R_s f)

    f_grid (..., big, big, big) complex64 and t_grid float32 of the same
    shape, centered; sym_mats (order, 3, 3), the identity first; ``form``
    the group's :func:`symmetrize_form` (formed here, reading the matrices
    on the host, where not given; a new grid size builds its table of
    orbits once).  Returns new (F, T).  CPU tensors take
    :func:`symmetrize_ft_plain`; CUDA tensors launch csrc/symmetrize_ft.cu,
    one launch for every leading grid and for F and T together."""
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
    form = form or symmetrize_form(sym_mats)
    _native.require(form == "box" or (form in ("orbit", "orbit-cube")
                                      and getattr(form, "perms", None) is not None
                                      and len(form.perms) == mats.shape[0]),
                    f"symmetrize_ft: no form {form!r} for a group of {mats.shape[0]}")
    plan = symmetrize_plan(form, mats.shape[0], big)
    reps = form.reps(plan, f_grid.device) if plan["orbit"] else None
    blocks = len(reps) if plan["orbit"] else int(np.prod(plan["n"]))
    f_out, t_out = torch.empty_like(f_grid), torch.empty_like(t_grid)
    if n_grids == 0:
        return f_out, t_out
    args = _SymArgs(f_grid.data_ptr(), t_grid.data_ptr(), f_out.data_ptr(), t_out.data_ptr(),
                    mats.data_ptr(), None if reps is None else reps.data_ptr(),
                    mats.shape[0] - 1, big, plan["orbit"], *plan["edges"], *plan["n"], blocks,
                    float(max_radius_pad) * float(max_radius_pad))
    lib = _native.library()
    symmetrize_ft.launches += 1
    symmetrize_ft.last_grids = n_grids
    _native.check(lib.thunder_symmetrize_ft(
        ctypes.addressof(args), n_grids, plan["threads"], plan["smem"],
        _native.stream_ptr(f_grid)), "symmetrize_ft")
    return f_out, t_out


symmetrize_ft.launches = 0
symmetrize_ft.last_grids = 0    # the grids of the last launch
