"""Real-space soft masks and background estimation
(src/Functions/Mask.cpp), as in thunder_tpu.physics.mask.

Internal real-space layout is FFT layout (center at index [0, 0]);
radial grids use wrapped coordinates.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from thunder_tpu_torch.device import REAL


@lru_cache(maxsize=64)
def radial_grid(size: int, ndim: int) -> np.ndarray:
    """Distance-from-origin over an FFT-layout grid (wrapped coords)."""
    k = np.minimum(np.arange(size), size - np.arange(size)).astype(np.float32)
    if ndim == 2:
        ky, kx = np.meshgrid(k, k, indexing="ij")
        return np.sqrt(kx * kx + ky * ky)
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    return np.sqrt(kx * kx + ky * ky + kz * kz)


def soft_mask_weight(size: int, ndim: int, r: float, ew: float,
                     device=None) -> torch.Tensor:
    """Cosine-edged spherical window: 1 inside r, 0 outside r + ew
    (Mask.cpp:333-351)."""
    u = torch.as_tensor(radial_grid(size, ndim), device=device)
    edge = 0.5 + 0.5 * torch.cos((u - r) / ew * np.pi)
    w = torch.where(u >= r, edge, torch.ones_like(u))
    return torch.where(u > r + ew, torch.zeros_like(u), w).to(REAL)


def background(img: torch.Tensor, r: float, ew: float,
               sp_ndim: int = 2) -> torch.Tensor:
    """Edge-weighted mean outside radius r (Mask.cpp:156-189)."""
    u = torch.as_tensor(radial_grid(img.shape[-1], sp_ndim), device=img.device)
    edge = 0.5 - 0.5 * torch.cos((u - r) / ew * np.pi)
    w = torch.where(u >= r, edge, torch.zeros_like(u))
    w = torch.where(u > r + ew, torch.ones_like(u), w)
    dims = tuple(range(img.ndim - sp_ndim, img.ndim))
    return torch.sum(img * w, dim=dims) / torch.sum(w)


def soft_mask(img: torch.Tensor, r: float, ew: float, bg=None,
              sp_ndim: int = 2) -> torch.Tensor:
    """Blend toward the background outside radius r (Mask.cpp:352-385)."""
    w = soft_mask_weight(img.shape[-1], sp_ndim, r, ew, img.device)
    if bg is None:
        bg = background(img, r, ew, sp_ndim=sp_ndim)
    bg = torch.as_tensor(bg, dtype=img.dtype, device=img.device)
    bg_b = bg[(...,) + (None,) * sp_ndim]
    return img * w + bg_b * (1 - w)
