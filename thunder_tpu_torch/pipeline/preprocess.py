"""Image preprocessing and noise-sigma initialisation
(Optimiser::initImg .. normaliseImg, Optimiser.cpp:4608-5035, and
initSigma, :5145-5243), as in thunder_tpu.pipeline.preprocess.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from thunder_tpu_torch.constants import EDGE_WIDTH_RL
from thunder_tpu_torch.device import COMPLEX, REAL
from thunder_tpu_torch.ops.fourier import fft2_centered
from thunder_tpu_torch.physics.mask import radial_grid, soft_mask_weight
from thunder_tpu_torch.physics.spectrum import shell_count, shell_sum


class PreparedImages(NamedTuple):
    ft_masked: torch.Tensor    # (L, size, size) complex64 centered spectra
    ft_ori: torch.Tensor       # (L, size, size) unmasked spectra
    bg_mean: torch.Tensor      # (L,)
    bg_std: torch.Tensor       # (L,)


def preprocess_images(imgs: torch.Tensor, mask_radius_px: float,
                      zero_mask: bool = True,
                      gen: torch.Generator | None = None) -> PreparedImages:
    """imgs: (L, size, size) float32 real-space FFT-layout images."""
    size = imgs.shape[-1]
    u = torch.as_tensor(radial_grid(size, 2), device=imgs.device)
    outside = (u > mask_radius_px).to(REAL)
    n_out = torch.sum(outside)
    bg_mean = torch.sum(imgs * outside, dim=(-2, -1)) / n_out
    bg_var = (torch.sum((imgs - bg_mean[:, None, None]) ** 2 * outside,
                        dim=(-2, -1)) / torch.clamp(n_out - 1, min=1))
    bg_std = torch.sqrt(torch.clamp(bg_var, min=1e-12))
    normed = (imgs - bg_mean[:, None, None]) / bg_std[:, None, None]

    w = soft_mask_weight(size, 2, mask_radius_px, EDGE_WIDTH_RL, imgs.device)
    if zero_mask or gen is None:
        masked = normed * w
    else:
        noise = torch.randn(normed.shape, generator=gen, device=imgs.device,
                            dtype=REAL)
        masked = normed * w + noise * (1 - w)
    return PreparedImages(fft2_centered(masked).to(COMPLEX),
                          fft2_centered(normed).to(COMPLEX), bg_mean, bg_std)


def init_sigma_from_moments(avg: torch.Tensor, p2_mean: torch.Tensor,
                            max_r: int) -> torch.Tensor:
    """Initial noise spectrum from the mean spectrum and mean power."""
    size = avg.shape[-1]
    cnt = torch.clamp(shell_count(size, 2, max_r, device=avg.device), min=1.0)
    mean_ps = shell_sum(p2_mean, size, 2, max_r) / cnt
    # the reference ring-averages (re + im) of the mean image, squared
    ps_of_avg = (shell_sum(avg.real + avg.imag, size, 2, max_r) / cnt) ** 2
    return torch.clamp((mean_ps - ps_of_avg) / 2, min=1e-6)


def init_sigma(ft_ori: torch.Tensor, max_r: int) -> torch.Tensor:
    """(E|X|^2 - |E X|^2)/2 per ring over (L, size, size) spectra."""
    avg = torch.mean(ft_ori, dim=0)
    p2 = torch.mean(ft_ori.abs() ** 2, dim=0)
    return init_sigma_from_moments(avg, p2, max_r)


def sigma_to_sig_rcp(sigma: torch.Tensor) -> torch.Tensor:
    """sigRcp = -0.5 / sigma (Optimiser.cpp:5242)."""
    return -0.5 / torch.clamp(sigma, min=1e-10)
