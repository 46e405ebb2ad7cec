"""Spectral statistics: shell sums and averages, power spectra, FSC,
resolution conversion, B-factor estimation, phase randomisation — and
the host of kernel HK4 (``shell_sums``).

Layout: centered full-space Fourier arrays; shell sums mask to the
half-space kx >= 0 (plus the kx = -c Nyquist column), matching the
reference's half-storage loops (src/Functions/Spectrum.cpp) and
thunder_tpu.physics.spectrum.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import COMPLEX, REAL


def nyquist(pixel_size: float) -> float:
    return 2.0 / pixel_size


def res_p2a(res_p, image_size: int, pixel_size: float):
    """Shell index -> spatial frequency [1/A] (Spectrum.cpp:19)."""
    return res_p / image_size / pixel_size


def res_a2p(res_a, image_size: int, pixel_size: float):
    return res_a * image_size * pixel_size


@lru_cache(maxsize=64)
def _shell_geometry_np(size: int, ndim: int):
    c = size // 2
    k = np.arange(size) - c
    if ndim == 2:
        ky, kx = np.meshgrid(k, k, indexing="ij")
        r = np.sqrt(kx * kx + ky * ky)
    else:
        kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
        r = np.sqrt(kx * kx + ky * ky + kz * kz)
    u = np.rint(r).astype(np.int32)
    half = ((kx >= 0) | (kx == -c)).astype(np.float32)
    return u, half


_GEOM_CACHE: dict = {}


def shell_geometry(size: int, ndim: int, device) -> tuple:
    """(shell index int32, half-space float32 mask), both flattened, on
    ``device`` (cached per device)."""
    key = (size, ndim, str(device))
    if key not in _GEOM_CACHE:
        u, half = _shell_geometry_np(size, ndim)
        _GEOM_CACHE[key] = (torch.as_tensor(u.reshape(-1), device=device),
                            torch.as_tensor(half.reshape(-1), device=device))
    return _GEOM_CACHE[key]


# -- HK4 ----------------------------------------------------------------

# warps wanted in flight before an image is left to one warp: the row
# form splits the images of a small batch into pieces (132 SMs x 32),
# of 256 cells at least (measured on an H100: 512 images of 2,048 cells
# in 8 pieces 0.014 ms, in 4 0.019, whole 0.047; micro/hk_candidates.py)
ROWS_TARGET_WARPS = 4224
ROWS_MIN_CHUNK = 256


def shell_sums_plan(n_batch: int, n: int) -> int:
    """Pieces the row form of HK4 cuts each image's N cells into.  1:
    a warp owns an image and stores its sums (the output needs no zero
    fill); more when the batch alone would leave the card idle."""
    by_len = -(-n // ROWS_MIN_CHUNK)
    by_batch = -(-ROWS_TARGET_WARPS // max(n_batch, 1))
    return max(1, min(by_len, by_batch))


def shell_sums_plain(values: torch.Tensor, shell: torch.Tensor,
                     n_shells: int, weight: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Plain version of HK4: values (B, C, N) float32, shell (N,) int,
    weight (N,) or None -> (B, C, n_shells); shells >= n_shells fall in
    a dropped overflow bin."""
    b, c, n = values.shape
    v = values if weight is None else values * weight
    idx = torch.clamp(shell.long(), max=n_shells)
    out = torch.zeros((b, c, n_shells + 1), dtype=REAL, device=values.device)
    out.index_add_(2, idx, v.to(REAL))
    return out[..., :n_shells]


MAX_FIELDS, GRID_BLOCKS = (_native.csrc_constant("shell_sums.cu", n)
                           for n in ("MAX_C", "GRID_BLOCKS"))


def _count_launch(form: str, b: int, c: int, n: int) -> None:
    shell_sums.launches += 1
    key = (form, b, c, n)
    shell_sums.shapes[key] = shell_sums.shapes.get(key, 0) + 1


def _require_fields(values: torch.Tensor, who: str) -> None:
    _native.require(values.ndim == 3 and values.dtype == REAL,
                    f"{who}: values must be (B, C, N) float32")
    _native.require(values.stride(2) == 1 and values.stride(1) == values.shape[2],
                    f"{who}: each (C, N) block must be contiguous")


def _require_grid(n_b: int, n: int, size: int, ndim: int, who: str) -> None:
    _native.require(ndim in (2, 3) and n == size ** ndim and n < 2 ** 31 and n_b <= 65535,
                    f"{who}: needs size^ndim cells (ndim 2 or 3) under 2^31 and at most "
                    "65535 batch entries")


def shell_sums(values: torch.Tensor, shell: torch.Tensor, n_shells: int,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """Fourier-shell sums of C real fields, (B, C, N) -> (B, C, n_shells).

    CPU tensors take :func:`shell_sums_plain`; CUDA tensors launch the
    hand-written kernel (csrc/shell_sums.cu, the row form).  Kernel sums
    are added in another order than the plain version's, so they match
    it to float32 rounding, not bitwise; that order is fixed by the
    inputs, so two calls give identical bits."""
    if not values.is_cuda:
        return shell_sums_plain(values, shell, n_shells, weight)
    _require_fields(values, "shell_sums")
    b, c, n = values.shape
    shell = shell.to(torch.int32).contiguous()
    _native.require(shell.shape == (n,), "shell_sums: shell must be (N,)")
    if weight is not None:
        weight = weight.to(REAL).contiguous()
        _native.require(weight.shape == (n,), "shell_sums: weight must be (N,)")
    chunks = shell_sums_plan(b, n)
    out = torch.empty((b, c, n_shells), dtype=REAL, device=values.device)
    if out.numel() == 0 or n == 0:
        return out.zero_()
    work = (None if chunks == 1 else
            torch.empty(b * chunks * min(c, MAX_FIELDS) * n_shells, dtype=torch.float64,
                        device=values.device))
    lib = _native.library()
    _count_launch("rows", b, c, n)
    _native.check(lib.thunder_shell_sums(
        values.data_ptr(), values.stride(0), b, c, n, shell.data_ptr(),
        None if weight is None else weight.data_ptr(), n_shells, chunks,
        out.data_ptr(), None if work is None else work.data_ptr(),
        _native.stream_ptr(values)), "shell_sums")
    return out


shell_sums.launches = 0
shell_sums.shapes = {}    # (form, B, C, N) -> launches, all three entries; form "rows",
                          # "grid" (half space), "full" (every cell) or "pair"


def shell_sums_grid_plain(values: torch.Tensor, size: int, ndim: int,
                          n_shells: int, halfspace: bool = True
                          ) -> torch.Tensor:
    """Plain version of HK4's coordinate form: :func:`shell_sums_plain`
    over :func:`shell_geometry`'s arrays."""
    u, half = shell_geometry(size, ndim, values.device)
    return shell_sums_plain(values, u, n_shells, half if halfspace else None)


def _grid_work(n_b: int, n_c: int, n_shells: int, device) -> torch.Tensor:
    """The coordinate form's partials (double): at most
    ceil(GRID_BLOCKS / B) blocks an image (csrc/shell_sums.cu
    grid_blocks), n_shells bins a field."""
    return torch.empty((GRID_BLOCKS + n_b) * n_c * n_shells, dtype=torch.float64,
                       device=device)


def shell_sums_grid(values: torch.Tensor, size: int, ndim: int,
                    n_shells: int, halfspace: bool = True) -> torch.Tensor:
    """Shell sums of C real fields on centered full grids, (B, C,
    size^ndim) -> (B, C, n_shells), over the half space kx >= 0 (plus
    the kx = -c column) or every cell.  On the card the kernel forms the
    shell index and the half-space choice from each cell's coordinates
    and reads neither array; its launches count as ``shell_sums``'s."""
    if not values.is_cuda:
        return shell_sums_grid_plain(values, size, ndim, n_shells, halfspace)
    _require_fields(values, "shell_sums_grid")
    b, c, n = values.shape
    _require_grid(b, n, size, ndim, "shell_sums_grid")
    out = torch.empty((b, c, n_shells), dtype=REAL, device=values.device)
    if out.numel() == 0 or n == 0:
        return out.zero_()
    work = _grid_work(b, min(c, MAX_FIELDS), n_shells, values.device)
    lib = _native.library()
    _count_launch("grid" if halfspace else "full", b, c, n)
    _native.check(lib.thunder_shell_sums_grid(
        values.data_ptr(), values.stride(0), b, c, size, ndim, int(halfspace),
        n_shells, out.data_ptr(), work.data_ptr(), _native.stream_ptr(values)),
        "shell_sums_grid")
    return out


def fsc_sums_plain(a: torch.Tensor, b: torch.Tensor, size: int, ndim: int,
                   n_shells: int) -> torch.Tensor:
    """Plain version of HK4's spectrum-pair entry: a, b (B, size^ndim)
    complex -> (B, 3, n_shells) half-space shell sums of Re(a conj b),
    |a|^2, |b|^2."""
    vals = torch.stack([(a * b.conj()).real, a.abs() ** 2, b.abs() ** 2], dim=1)
    return shell_sums_grid_plain(vals.to(REAL), size, ndim, n_shells)


def fsc_sums(a: torch.Tensor, b: torch.Tensor, size: int, ndim: int,
             n_shells: int) -> torch.Tensor:
    """The FSC's three half-space shell sums, (B, 3, n_shells), from the
    centered spectra a, b (B, size^ndim) themselves: on the card HK4
    forms the three products in the kernel, so no stacked copy of the
    fields is written and read back."""
    if not a.is_cuda:
        return fsc_sums_plain(a, b, size, ndim, n_shells)
    _native.require(a.shape == b.shape and a.ndim == 2,
                    "fsc_sums: a and b must both be (B, size^ndim)")
    a = a.to(COMPLEX).contiguous()
    b = b.to(COMPLEX).contiguous()
    n_b, n = a.shape
    _require_grid(n_b, n, size, ndim, "fsc_sums")
    out = torch.empty((n_b, 3, n_shells), dtype=REAL, device=a.device)
    if out.numel() == 0 or n == 0:
        return out.zero_()
    work = _grid_work(n_b, 3, n_shells, a.device)
    lib = _native.library()
    _count_launch("pair", n_b, 3, n)
    _native.check(lib.thunder_fsc_sums_grid(
        a.data_ptr(), b.data_ptr(), n_b, size, ndim, n_shells, out.data_ptr(),
        work.data_ptr(), _native.stream_ptr(a)), "fsc_sums")
    return out


# -- shell statistics on centered spectra ------------------------------

def shell_sum(values: torch.Tensor, size: int, ndim: int, n_shells: int,
              halfspace: bool = True) -> torch.Tensor:
    """Sum a centered full-space real array (..., size^ndim) over integer
    shells -> (..., n_shells)."""
    lead = values.shape[:values.ndim - ndim]
    v = values.reshape((-1, 1, size ** ndim))
    out = shell_sums_grid(v.contiguous().to(REAL), size, ndim, n_shells, halfspace)
    return out.reshape(lead + (n_shells,))


def shell_count(size: int, ndim: int, n_shells: int, device=None,
                halfspace: bool = True) -> torch.Tensor:
    """Cells per shell, (n_shells,), over the half space (see
    :func:`shell_sum`) or every cell."""
    u, half = _shell_geometry_np(size, ndim)
    cnt = np.bincount(np.minimum(u.reshape(-1), n_shells),
                      weights=half.reshape(-1) if halfspace else None,
                      minlength=n_shells + 1)
    return torch.as_tensor(cnt[:n_shells].astype(np.float32), device=device)


def shell_average(values: torch.Tensor, n_shells: int) -> torch.Tensor:
    """Radial average of a real centered array (Spectrum.cpp:129-159)."""
    size, ndim = values.shape[-1], values.ndim
    s = shell_sum(values, size, ndim, n_shells)
    return s / torch.clamp(shell_count(size, ndim, n_shells, values.device), min=1.0)


def power_spectrum(ft: torch.Tensor, n_shells: int) -> torch.Tensor:
    """Mean |F|^2 per shell (Spectrum.cpp:161-221)."""
    return shell_average(ft.abs() ** 2, n_shells)


def fsc(a: torch.Tensor, b: torch.Tensor, n_shells: int,
        ndim: int | None = None) -> torch.Tensor:
    """Fourier shell (3D) / ring (2D) correlation of centered spectra
    (Spectrum.cpp:223-337); leading dims batch."""
    ndim = a.ndim if ndim is None else ndim
    size = a.shape[-1]
    lead = a.shape[:a.ndim - ndim]
    s = fsc_sums(a.reshape((-1, size ** ndim)), b.reshape((-1, size ** ndim)),
                 size, ndim, n_shells)
    num, pa, pb = s[:, 0], s[:, 1], s[:, 2]
    den = torch.sqrt(pa * pb)
    out = torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                      torch.zeros_like(num))
    return out.reshape(lead + (n_shells,))


def res_p(fsc_curve, thres: float, pf: int = 1, r_l: int = 1) -> int:
    """First shell (from r_l up) where FSC drops below ``thres``, minus
    one, divided by pf (Spectrum.cpp:339-363).  Host-side."""
    fsc_curve = np.asarray(fsc_curve)
    result = len(fsc_curve)
    for i in range(r_l, len(fsc_curve)):
        if fsc_curve[i] < thres:
            result = i
            break
    return (result - 1) // pf


def random_phase(ft: torch.Tensor, r, gen: torch.Generator,
                 ndim: int | None = None, phase: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Randomise the phases of shells above radius ``r`` (per leading
    batch entry when ``r`` is a tensor) (Spectrum.cpp:365-386).
    ``phase`` injects the uniform [0, 2 pi) draws (tests)."""
    ndim = ft.ndim if ndim is None else ndim
    size = ft.shape[-1]
    u, _ = shell_geometry(size, ndim, ft.device)
    u = u.reshape((size,) * ndim)
    if phase is None:
        phase = torch.rand(ft.shape, generator=gen, device=ft.device,
                           dtype=REAL) * (2 * np.pi)
    rot = torch.polar(torch.ones_like(phase), phase)
    r = torch.as_tensor(r, device=ft.device)
    r = r.reshape(r.shape + (1,) * ndim)
    return torch.where(u > r, ft * rot, ft)


def b_factor_est(ft: torch.Tensor, r_u: int, r_l: int) -> float:
    """Guinier-fit B factor: fit log(mean |F|) against (u / N)^2 over
    shells [r_l, r_u); B = 2 slope (Spectrum.cpp:414-453).  The mean is
    over full shells: HK4's coordinate form with the half space off."""
    size, ndim = ft.shape[-1], ft.ndim
    n = int(r_u)
    amp = shell_sum(ft.abs(), size, ndim, n, halfspace=False)
    cnt = shell_count(size, ndim, n, ft.device, halfspace=False)
    u = torch.arange(n, dtype=REAL, device=ft.device)
    y = torch.log(torch.clamp(amp / torch.clamp(cnt, min=1.0), min=1e-30))
    x = (u / size) ** 2
    w = (u >= r_l).to(REAL)        # weighted least squares over selected shells
    sw = torch.sum(w)
    mx = torch.sum(w * x) / sw
    my = torch.sum(w * y) / sw
    slope = (torch.sum(w * (x - mx) * (y - my))
             / torch.clamp(torch.sum(w * (x - mx) ** 2), min=1e-30))
    return float(2.0 * slope)
