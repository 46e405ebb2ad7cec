"""Real-space soft masks, background estimation and auto-masking
(src/Functions/Mask.cpp), as in thunder_tpu.physics.mask.

Internal real-space layout is FFT layout (center at index [0, 0]);
radial grids use wrapped coordinates.  Auto-mask generation stays host
numpy / scipy, as in thunder_tpu: it runs once on one volume, and its
morphology (connected components, distance transforms) has no torch
counterpart.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from thunder_tpu_torch.device import REAL

GEN_MASK_INIT_STEP = 0.2   # include/Functions/Mask.h:31
GEN_MASK_GAP = 0.05        # include/Functions/Mask.h:33


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


def soft_mask_noise(gen: torch.Generator, img: torch.Tensor, r: float, ew: float,
                    bg_mean: torch.Tensor, bg_std: torch.Tensor) -> torch.Tensor:
    """Blend toward Gaussian noise of the background statistics
    (Mask.cpp:387-417), used when masking data images for alignment:
    img (..., size, size), bg_mean and bg_std (...); the noise is drawn
    from ``gen`` on the image's device."""
    w = soft_mask_weight(img.shape[-1], 2, r, ew, img.device)
    e = (Ellipsis, None, None)
    draw = torch.randn(img.shape, generator=gen, device=img.device, dtype=REAL)
    noise = (torch.as_tensor(bg_mean, dtype=REAL, device=img.device)[e]
             + draw * torch.as_tensor(bg_std, dtype=REAL, device=img.device)[e])
    return img * w + noise * (1 - w)


def _auto_mask_threshold(vol: np.ndarray, r: float) -> float:
    """Density-sorted partial-sum threshold search (Mask.cpp:733-800)."""
    u = radial_grid(vol.shape[-1], 3)
    data = np.maximum(0.0, vol[u < r]).astype(np.float64)
    data.sort()
    data = data[::-1]
    partial = np.cumsum(data)
    total = partial[-1]
    if total <= 0:
        return 0.0
    start = int(np.searchsorted(partial, total * GEN_MASK_INIT_STEP))
    thres = 0.0
    step = GEN_MASK_INIT_STEP + GEN_MASK_GAP
    n_prev_bin = 0
    prev = 0
    bin_ = 0
    for i in range(start, data.size):
        if partial[i] < total * step:
            bin_ += 1
        else:
            if n_prev_bin != 0 and prev * 2 < bin_ * n_prev_bin:
                break
            step += GEN_MASK_GAP
            n_prev_bin += 1
            prev += bin_
            bin_ = 0
            thres = data[i]
    return float(thres)


def _remove_isolated_points(mask: np.ndarray) -> np.ndarray:
    """Drop connected components except the largest (genMask's
    removeIsolatedPoint)."""
    from scipy import ndimage

    labels, n = ndimage.label(mask)
    if n <= 1:
        return mask
    sizes = ndimage.sum(mask, labels, range(1, n + 1))
    keep = int(np.argmax(sizes)) + 1
    return (labels == keep).astype(mask.dtype)


def extend_soft_edge(mask_c: np.ndarray, ext: float, ew: float) -> np.ndarray:
    """Grow (ext > 0) or shrink (ext < 0) a centered binary mask by |ext|
    voxels, then give it a cosine edge falling 1 -> 0 over ``ew`` voxels
    outside it (Mask.cpp softEdge:642-...)."""
    from scipy import ndimage

    if ext > 0:
        dist = ndimage.distance_transform_edt(mask_c == 0)
        mask_c = np.where(dist < ext, 1.0, mask_c).astype(np.float32)
    elif ext < 0:
        dist = ndimage.distance_transform_edt(mask_c == 1)
        mask_c = np.where(dist < -ext, 0.0, mask_c).astype(np.float32)
    if ew > 0:
        dist = ndimage.distance_transform_edt(mask_c == 0)
        edge = (dist != 0) & (dist < ew)
        soft = 0.5 + 0.5 * np.cos(dist / ew * np.pi)
        mask_c = np.where(edge, soft, mask_c).astype(np.float32)
    return mask_c


def auto_mask(vol: np.ndarray, r: float, ext: float = 0.0, ew: float = 0.0) -> np.ndarray:
    """Soft auto-mask from a volume (host; Mask.cpp:733-824): threshold
    -> largest component -> extend by ``ext`` voxels -> cosine edge of
    width ``ew``.  vol (size,)^3 float in FFT layout; returns float32 in
    the same layout."""
    thres = _auto_mask_threshold(vol, r)
    mask = (vol > thres).astype(np.float32)
    # morphology wants contiguous objects: go to the centered layout
    mask_c = _remove_isolated_points(np.fft.fftshift(mask))
    return np.fft.ifftshift(extend_soft_edge(mask_c, ext, ew))
