"""Volume-sharded ("z-slab") gridding reconstruction for padded grids
too big for one device (thunder_tpu.recon.sharded on torch.distributed).

THUNDER keeps whole padded F / T / W / C volumes on every rank, and
boxes of ~1000 px were a known failure (README.md:58-59).  Here the
padded grids of a hemisphere lie as contiguous z-slabs over its data
group: rank j of the group holds global z [j big/d, (j+1) big/d).  The
balance loop's 3D FFTs run as distributed FFTs (a local 2D FFT, one
``all_to_all_z`` slab transpose, a local 1D FFT), the stop reads each
lane's largest change, MAX over the group, every iteration, and no rank
ever holds a whole padded volume.  ``torch.fft`` is cuFFT on the card,
as XLA's FFT stood outside any Pallas kernel in thunder_tpu.

The arithmetic is recon/reconstructor.py's (the port's one-grid path)
step for step, lanes included: the balance loop runs in rfft half space
(x cut to big/2 + 1, ``_rfft3_dist`` / ``_irfft3_dist``), each (pass,
class) stops on its own, and cells no slice reached keep W = 1.
(thunder_tpu iterates in full complex space, whose real part drifts from
the half-space iteration by float rounding from one iteration to the
next; with few slices the stopping rule then parts the two paths.)  The
masks of the FFT layout are formed from wrapped coordinates on each
rank, so only F and T cross the half-box roll (``_centered_to_fft``: a
whole-slab swap, which is why the data extent must be even).  The
insertion into slabs is HK9 (ops/insert.py ``insert_trilinear_slab``).
"""

from __future__ import annotations

import numpy as np
import torch

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
from thunder_tpu_torch.ops.fourier import resize_rl
from thunder_tpu_torch.parallel import comm
from thunder_tpu_torch.parallel.mesh import Layout
from thunder_tpu_torch.physics.kernels import mkb_rl
from thunder_tpu_torch.recon.reconstructor import _mkb_rl_nf, _tik_correction


def sharded_grid_specs(layout: Layout, big: int) -> tuple:
    """(z0, bz): the first global z and the depth of this rank's slab of
    a big^3 grid."""
    if big % layout.data:
        raise ValueError(f"a {big}^3 grid does not split into {layout.data} slabs")
    bz = big // layout.data
    return layout.j * bz, bz


def _local_z(big: int, layout: Layout, device) -> torch.Tensor:
    """Global z indices of this rank's slab."""
    z0, bz = sharded_grid_specs(layout, big)
    return z0 + torch.arange(bz, device=device)


def _fft3_dist(x: torch.Tensor, layout: Layout, inverse: bool) -> torch.Tensor:
    """Distributed 3D (i)FFT of z-slabs (..., bz, big, big), returned in
    the same slab layout: local (y, x) FFT, slab transpose, local z
    FFT, transpose back (two all_to_alls a call)."""
    nd = x.ndim
    x = (torch.fft.ifft2 if inverse else torch.fft.fft2)(x, dim=(-2, -1))
    x = comm.all_to_all_z(layout, x, split_axis=nd - 2, concat_axis=nd - 3)
    x = (torch.fft.ifft if inverse else torch.fft.fft)(x, dim=nd - 3)
    return comm.all_to_all_z(layout, x, split_axis=nd - 3, concat_axis=nd - 2)


def _rfft3_dist(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """rfftn of real z-slabs (..., bz, big, big) -> half-space slabs
    (..., bz, big, big // 2 + 1): local rfft over x and FFT over y, slab
    transpose, local FFT over z, transpose back."""
    nd = x.ndim
    x = torch.fft.rfft2(x, dim=(-2, -1))
    x = comm.all_to_all_z(layout, x, split_axis=nd - 2, concat_axis=nd - 3)
    x = torch.fft.fft(x, dim=nd - 3)
    return comm.all_to_all_z(layout, x, split_axis=nd - 3, concat_axis=nd - 2)


def _irfft3_dist(x: torch.Tensor, layout: Layout, big: int) -> torch.Tensor:
    """irfftn of half-space slabs (..., bz, big, big // 2 + 1) -> real
    z-slabs (..., bz, big, big)."""
    nd = x.ndim
    x = comm.all_to_all_z(layout, x, split_axis=nd - 2, concat_axis=nd - 3)
    x = torch.fft.ifft(x, dim=nd - 3)
    x = comm.all_to_all_z(layout, x, split_axis=nd - 3, concat_axis=nd - 2)
    return torch.fft.irfft2(x, s=(big, big), dim=(-2, -1))


def _shift_z_sharded(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """Roll by big/2 along the sharded z axis (-3): on d ranks a swap of
    whole slabs with data rank j + d/2 (d even)."""
    d = layout.data
    if d == 1:
        return torch.roll(x, x.shape[-3] // 2, dims=-3)
    if d % 2:
        raise ValueError("volume sharding needs an even data extent")
    return comm.swap_data(layout, x, (layout.j + d // 2) % d)


def _centered_to_fft(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """Centered layout -> FFT layout (ifftshift) of z-slabs."""
    big = x.shape[-1]
    x = torch.roll(x, (big // 2, big // 2), dims=(-2, -1))
    return _shift_z_sharded(x, layout)


def _local_grids(big: int, layout: Layout, device) -> tuple:
    """Squared wrapped (FFT-layout) coordinates (kz2, ky2, kx2) of this
    rank's slab, broadcastable over (bz, big, big)."""
    z = _local_z(big, layout, device).to(REAL)
    k = torch.arange(big, dtype=REAL, device=device)
    zw = torch.minimum(z, big - z)
    kw = torch.minimum(k, big - k)
    return (zw * zw)[:, None, None], (kw * kw)[None, :, None], (kw * kw)[None, None, :]


def _mkb_window_local(big: int, layout: Layout, a: float, alpha: float,
                      device) -> torch.Tensor:
    """This rank's slab of the real-space MKB window, FFT layout, 1 at
    the origin (recon/reconstructor.py _mkb_window)."""
    kz2, ky2, kx2 = _local_grids(big, layout, device)
    r = torch.sqrt(kz2 + ky2 + kx2) / big
    return (mkb_rl(r, a, alpha) / _mkb_rl_nf(a, alpha)).to(REAL)


def _wiener_slab(t: torch.Tensor, fsc_all: torch.Tensor, u: torch.Tensor, pf: int,
                 max_radius: int, join_half: bool) -> torch.Tensor:
    """wiener_filter_t on an FFT-layout slab t (K, bz, big, big) with the
    shells u (bz, big, big) of its cells; fsc_all (K, n_fsc)."""
    n_fsc = fsc_all.shape[-1]
    up = u // pf
    fsc = fsc_all[:, torch.clamp(up, max=n_fsc - 1).reshape(-1)].reshape(
        fsc_all.shape[:1] + u.shape)
    fsc = torch.where(up >= n_fsc, torch.zeros_like(fsc), fsc)
    fsc = torch.clamp(fsc, FSC_BASE_L, FSC_BASE_H)
    if join_half:
        fsc = torch.sqrt(2 * fsc / (1 + fsc))
    active = (u >= WIENER_FACTOR_MIN_R * pf) & (u < max_radius * pf)
    return torch.where(active, t / fsc, t)


def _balance_sharded(t_half: torch.Tensor, inside: torch.Tensor, layout: Layout,
                     big: int) -> torch.Tensor:
    """W of balance_weights on half-space slabs t_half (lanes..., bz, big,
    big // 2 + 1), T floored at T_MIN: each lane stops on its own, its
    change the MAX over the data group; cells no slice reached keep
    W = 1."""
    window = _mkb_window_local(big, layout, DEFAULT_MKB_A, DEFAULT_MKB_ALPHA, t_half.device)
    inside_h = inside & (t_half > T_MIN)
    lanes = t_half.shape[:-3]
    w = torch.where(inside, 1.0, 0.0).to(REAL).expand(t_half.shape).clone()
    dev = t_half.device

    def convolute(c):
        c_rl = _irfft3_dist(c.to(COMPLEX), layout, big)
        return _rfft3_dist(c_rl * window, layout)

    fmax = float(np.finfo(np.float32).max)
    diff_prev = torch.full(lanes, fmax, dtype=REAL, device=dev)
    n_no_dec = torch.zeros(lanes, dtype=torch.int64, device=dev)
    it = torch.zeros(lanes, dtype=torch.int64, device=dev)
    active = torch.ones(lanes, dtype=torch.bool, device=dev)
    for _ in range(MAX_N_ITER_BALANCE):
        c_abs = convolute(t_half * w).abs()
        w_new = torch.where(inside_h, w / torch.clamp(c_abs, min=C_ABS_MIN), w)
        diff = torch.amax(torch.where(inside_h, (c_abs - 1.0).abs(),
                                      torch.zeros_like(c_abs)), dim=(-3, -2, -1))
        diff = comm.max_data(layout, diff.contiguous())
        nnd = torch.where(diff > diff_prev * DIFF_C_DECREASE_THRES,
                          n_no_dec + 1, torch.zeros_like(n_no_dec))
        act = active.reshape(lanes + (1, 1, 1))
        w = torch.where(act, w_new, w)
        diff_prev = torch.where(active, diff, diff_prev)
        n_no_dec = torch.where(active, nnd, n_no_dec)
        it = it + active.long()
        not_stalled = (it < MIN_N_ITER_BALANCE) | (n_no_dec < N_DIFF_C_NO_DECREASE)
        active = (active & (it < MAX_N_ITER_BALANCE)
                  & (diff_prev >= DIFF_C_THRES) & not_stalled)
        if not bool(active.any()):
            break
    return w


def _extract_rows(big: int, size: int) -> np.ndarray:
    """FFT-layout indices of the padded axis that extract_rl keeps."""
    lo = (big - size) // 2
    return np.fft.ifftshift(np.fft.fftshift(np.arange(big))[lo:lo + size])


def _reconstruct_sharded_body(f_slab: torch.Tensor, t_lanes: torch.Tensor,
                              layout: Layout, size: int, pf: int,
                              max_radius: int) -> torch.Tensor:
    """F slabs (K, bz, big, big) and T lanes (P, K, bz, big, big), both
    FFT layout -> the (P, K, size^3) volumes, FFT layout, on every rank
    of the data group: the balance loop in half space, F W inside the
    radius, the distributed inverse rFFT, extraction of the central 1/pf
    and the trilinear kernel correction (grid correction, the only form
    the port's one-grid path has)."""
    big = f_slab.shape[-1]
    dev = f_slab.device
    half = big // 2 + 1
    kz2, ky2, kx2 = _local_grids(big, layout, dev)
    inside = (kz2 + ky2 + kx2[..., :half]) < float(max_radius * pf) ** 2
    t_half = torch.clamp(t_lanes[..., :half], min=T_MIN)
    w = _balance_sharded(t_half, inside, layout, big)
    pad_dst = torch.where(inside, f_slab[..., :half] * w,
                          torch.zeros((), dtype=COMPLEX, device=dev))
    rl = _irfft3_dist(pad_dst, layout, big)
    del pad_dst, w
    rows = _extract_rows(big, size)
    z0, bz = sharded_grid_specs(layout, big)
    mine = [(i, int(z) - z0) for i, z in enumerate(rows) if z0 <= z < z0 + bz]
    keep = torch.as_tensor(rows, device=dev)
    vol = torch.zeros(rl.shape[:-3] + (size,) * 3, dtype=REAL, device=dev)
    if mine:
        dst = torch.as_tensor([i for i, _ in mine], device=dev)
        src = torch.as_tensor([z for _, z in mine], device=dev)
        vol[..., dst, :, :] = rl[..., src, :, :][..., keep, :][..., keep]
    vol = comm.sum_data(layout, vol)
    return vol / _tik_correction(size, pf, dev)


def _upsample_slab_body(v: torch.Tensor, g: int, out: int, layout: Layout) -> torch.Tensor:
    """v (..., g, g, g) real, FFT layout, alike on the data group -> this
    rank's z-slab (..., out/d, out, out) of the Fourier-upsampled volume
    (resize_rl, coefficients preserved): each rank builds its slab of
    the zero-padded wrapped spectrum and the distributed iFFT runs at
    ``out``."""
    z0, bz = sharded_grid_specs(layout, out)
    ft = torch.fft.fftn(v, dim=(-3, -2, -1))

    def axis_map(w):
        idx = torch.where(w < g // 2, w, w - out + g)
        valid = (w < g // 2) | (w >= out - g // 2)
        return torch.clamp(idx, 0, g - 1), valid

    iz, vz = axis_map(z0 + torch.arange(bz, device=v.device))
    iy, vy = axis_map(torch.arange(out, device=v.device))
    sel = ft[..., iz, :, :][..., iy, :][..., iy]
    mask = vz[:, None, None] & vy[None, :, None] & vy[None, None, :]
    x = torch.where(mask, sel, torch.zeros((), dtype=sel.dtype, device=v.device))
    return _fft3_dist(x, layout, inverse=True).real


def _finish(vol: torch.Tensor, grid_size: int, out_size: int, layout: Layout) -> torch.Tensor:
    """Resize (P, K, g^3) volumes to out_size: distributed over the data
    group where out_size splits into its slabs, then made whole."""
    if grid_size == out_size:
        return vol
    if out_size % layout.data:
        return resize_rl(vol, out_size, nd=3)
    return comm.gather_slabs(layout, _upsample_slab_body(vol, grid_size, out_size, layout))


def reconstruct_all_sharded(layout: Layout, f_slab: torch.Tensor, t_slab: torch.Tensor,
                            fsc_all: torch.Tensor, grid_size: int, pf: int,
                            max_radius: int, map_wiener: bool, join_half: bool,
                            out_size: int) -> torch.Tensor:
    """One reconstruction from this rank's centered slabs f_slab (K, bz,
    big, big) complex64 and t_slab (K, ...) float32 of its hemisphere
    (thunder_tpu's reconstruct_all_sharded with grid correction, a rank's
    part of it); with ``map_wiener`` T is Wiener-filtered by fsc_all (K,
    shells) first.
    Returns the hemisphere's (K, out_size^3) volumes, FFT layout, on
    every rank of its data group."""
    big = f_slab.shape[-1]
    f_fft = _centered_to_fft(f_slab, layout)
    t_fft = _centered_to_fft(t_slab, layout)
    if map_wiener:
        kz2, ky2, kx2 = _local_grids(big, layout, f_slab.device)
        u = torch.round(torch.sqrt(kz2 + ky2 + kx2)).long()
        t_fft = _wiener_slab(t_fft, fsc_all, u, pf, max_radius, join_half)
    vol = _reconstruct_sharded_body(f_fft, t_fft[None], layout, grid_size, pf, max_radius)
    return _finish(vol, grid_size, out_size, layout)[0]


def reconstruct_two_pass_sharded(layout: Layout, f_slab: torch.Tensor, t_slab: torch.Tensor,
                                 fsc_curve: torch.Tensor, grid_size: int, pf: int,
                                 max_radius: int, out_size: int) -> tuple:
    """The two passes of a round (recon/reconstructor.py
    reconstruct_two_pass) on slabs: the MAP-free FSC pass and the Wiener
    MAP pass (join_half) as two lanes of one balance loop.  Returns
    (rec_fsc, rec_map), each (K, out_size^3), FFT layout."""
    big = f_slab.shape[-1]
    f_fft = _centered_to_fft(f_slab, layout)
    t_fft = _centered_to_fft(t_slab, layout)
    kz2, ky2, kx2 = _local_grids(big, layout, f_slab.device)
    u = torch.round(torch.sqrt(kz2 + ky2 + kx2)).long()
    t_w = _wiener_slab(t_fft, fsc_curve, u, pf, max_radius, join_half=True)
    vol = _reconstruct_sharded_body(f_fft, torch.stack([t_fft, t_w]), layout, grid_size,
                                    pf, max_radius)
    vol = _finish(vol, grid_size, out_size, layout)
    return vol[0], vol[1]
