"""Fourier filters on centered full-space arrays (src/Functions/Filter.cpp),
as thunder_tpu.physics.filters: elementwise torch on the spectrum's
device.

``f`` below is spatial frequency in cycles/pixel (integer shell / size).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from thunder_tpu_torch.device import REAL


@lru_cache(maxsize=64)
def _freq_norm_np(size: int, ndim: int) -> np.ndarray:
    c = size // 2
    k = (np.arange(size) - c) / size
    if ndim == 2:
        ky, kx = np.meshgrid(k, k, indexing="ij")
        return np.sqrt(kx * kx + ky * ky).astype(np.float32)
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    return np.sqrt(kx * kx + ky * ky + kz * kz).astype(np.float32)


def freq_norm(size: int, ndim: int, device=None) -> torch.Tensor:
    """|f| in cycles/pixel over a centered grid."""
    return torch.as_tensor(_freq_norm_np(size, ndim), device=device)


def _f(ft: torch.Tensor) -> torch.Tensor:
    return freq_norm(ft.shape[-1], ft.ndim, ft.device)


def b_factor_filter(ft: torch.Tensor, b_factor) -> torch.Tensor:
    """dst = src * exp(-b/2 * |f|^2) (Filter.cpp:13-44)."""
    f = _f(ft)
    return ft * torch.exp(-0.5 * float(b_factor) * f * f)


def low_pass_filter(ft: torch.Tensor, thres: float, ew: float) -> torch.Tensor:
    """Cosine-edge low-pass (Filter.cpp:46-95)."""
    f = _f(ft)
    edge = torch.cos((f - thres) * np.pi / ew) / 2 + 0.5
    w = torch.where(f < thres, torch.ones_like(f),
                    torch.where(f > thres + ew, torch.zeros_like(f), edge))
    return ft * w


def high_pass_filter(ft: torch.Tensor, thres: float, ew: float) -> torch.Tensor:
    """Cosine-edge high-pass (Filter.cpp:97-146)."""
    f = _f(ft)
    edge = torch.cos((thres - f) * np.pi / ew) / 2 + 0.5
    w = torch.where(f > thres, torch.ones_like(f),
                    torch.where(f < thres - ew, torch.zeros_like(f), edge))
    return ft * w


def fsc_weighting_filter(ft: torch.Tensor, fsc_curve) -> torch.Tensor:
    """Cref weighting sqrt(2 FSC / (1 + FSC)) per shell (Filter.cpp:148-176)."""
    size = ft.shape[-1]
    fsc_curve = torch.as_tensor(fsc_curve, dtype=REAL, device=ft.device)
    idx = torch.round(_f(ft) * size).to(torch.int64)
    n = fsc_curve.shape[0]
    fsc_v = fsc_curve[torch.clamp(idx, max=n - 1)]
    w = torch.sqrt(torch.clamp(2 * fsc_v / (1 + fsc_v), min=0.0))
    return ft * torch.where(idx < n, w, torch.zeros_like(w))


def sharpen(ft: torch.Tensor, thres: float, ew: float, b_factor) -> torch.Tensor:
    """B-factor sharpening followed by low-pass (Spectrum.cpp:402-412)."""
    return low_pass_filter(b_factor_filter(ft, b_factor), thres, ew)
