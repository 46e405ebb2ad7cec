"""Contrast transfer function (src/CTF.cpp:11-151), as in
thunder_tpu.physics.ctf:

    lambda = 12.2643247 / sqrt(V (1 + V * 0.978466e-6))
    chi    = pi lambda d f^2 + (pi/2) Cs lambda^3 f^4 - phaseShift
    CTF(f) = -w1 sin(chi) + w2 cos(chi)

CTF attributes are tensors of shape (...,); frequency grids broadcast
against them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from thunder_tpu_torch.constants import CTF_LAMBDA_A, CTF_LAMBDA_B
from thunder_tpu_torch.device import REAL


class CtfParams(NamedTuple):
    """Per-image CTF attributes (reference CTFAttr)."""

    voltage: torch.Tensor            # volts
    defocus_u: torch.Tensor          # angstrom
    defocus_v: torch.Tensor          # angstrom
    defocus_theta: torch.Tensor      # radians
    cs: torch.Tensor                 # angstrom
    amplitude_contrast: torch.Tensor
    phase_shift: torch.Tensor        # radians

    def map(self, fn) -> "CtfParams":
        return CtfParams(*[fn(f) for f in self])


def ctf_params(voltage, defocus_u, defocus_v, defocus_theta, cs,
               amplitude_contrast, phase_shift, device=None) -> CtfParams:
    as_f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32)
                                       if not torch.is_tensor(v) else v,
                                       dtype=REAL, device=device)
    return CtfParams(as_f32(voltage), as_f32(defocus_u), as_f32(defocus_v),
                     as_f32(defocus_theta), as_f32(cs),
                     as_f32(amplitude_contrast), as_f32(phase_shift))


def wavelength(voltage: torch.Tensor) -> torch.Tensor:
    """Electron wavelength in angstrom (CTF.cpp:18)."""
    return CTF_LAMBDA_A / torch.sqrt(voltage * (1 + voltage * CTF_LAMBDA_B))


def ctf_constants(params: CtfParams) -> torch.Tensor:
    """Per-image CTF constants (L, 8): [pi lambda, pi/2 Cs lambda^3, w1,
    w2, defocus_u, defocus_v, defocus_theta, phase_shift], the factors
    ctf_packed evaluates, formed once an image for the kernels that
    evaluate the CTF themselves."""
    lam = wavelength(params.voltage)
    w2 = params.amplitude_contrast
    return torch.stack([np.pi * lam, np.pi / 2 * params.cs * lam ** 3,
                        torch.sqrt(1 - w2 * w2), w2, params.defocus_u,
                        params.defocus_v, params.defocus_theta,
                        params.phase_shift], dim=-1).to(REAL).contiguous()


def ctf_packed(params: CtfParams, i_col: torch.Tensor, i_row: torch.Tensor,
               size: int, pixel_size: float) -> torch.Tensor:
    """CTF at packed integer frequencies; params (...,), pixels (p,)
    -> (..., p)."""
    fcol = i_col.to(REAL)
    frow = i_row.to(REAL)
    fx = fcol / (pixel_size * size)
    fy = frow / (pixel_size * size)
    f = torch.sqrt(fx * fx + fy * fy)
    angle = torch.atan2(frow, fcol)

    lam = wavelength(params.voltage)
    w2 = params.amplitude_contrast
    w1 = torch.sqrt(1 - w2 * w2)
    k1 = (np.pi * lam)[..., None]
    k2 = (np.pi / 2 * params.cs * lam ** 3)[..., None]

    rel = angle - params.defocus_theta[..., None]
    du = params.defocus_u[..., None]
    dv = params.defocus_v[..., None]
    defocus = -(du + dv + (du - dv) * torch.cos(2 * rel)) / 2
    chi = k1 * defocus * f ** 2 + k2 * f ** 4 - params.phase_shift[..., None]
    return -w1[..., None] * torch.sin(chi) + w2[..., None] * torch.cos(chi)


def ctf_packed_scaled(params: CtfParams, i_col: torch.Tensor, i_row: torch.Tensor,
                      size: int, pixel_size: float,
                      defocus_factor: torch.Tensor) -> torch.Tensor:
    """CTF with a multiplicative defocus factor d (the particle filter's
    fifth latent axis, CTF search): params (...,), defocus_factor
    (..., nd), pixels (p,) -> (..., nd, p)."""
    fcol = i_col.to(REAL)
    frow = i_row.to(REAL)
    fx = fcol / (pixel_size * size)
    fy = frow / (pixel_size * size)
    f2 = fx * fx + fy * fy
    angle = torch.atan2(frow, fcol)

    lam = wavelength(params.voltage)
    w2 = params.amplitude_contrast
    w1 = torch.sqrt(1 - w2 * w2)
    k1 = np.pi * lam
    k2 = np.pi / 2 * params.cs * lam ** 3

    rel = angle - params.defocus_theta[..., None]
    du = params.defocus_u[..., None]
    dv = params.defocus_v[..., None]
    defocus = -(du + dv + (du - dv) * torch.cos(2 * rel)) / 2   # (..., p)
    e = (Ellipsis, None, None)
    chi = (k1[e] * defocus[..., None, :] * defocus_factor[..., :, None] * f2
           + k2[e] * f2 * f2 - params.phase_shift[e])
    return -w1[e] * torch.sin(chi) + w2[e] * torch.cos(chi)


def ctf_image(params: CtfParams, size: int, pixel_size: float) -> torch.Tensor:
    """Full CTF image over the centered frequency grid, (..., size, size);
    entry [..., c + ky, c + kx] holds frequency (kx, ky)."""
    dev = params.voltage.device
    k = torch.arange(size, dtype=REAL, device=dev) - size // 2
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    f = torch.sqrt(kx * kx + ky * ky) / (pixel_size * size)
    angle = torch.atan2(ky, kx)

    lam = wavelength(params.voltage)
    w2 = params.amplitude_contrast
    w1 = torch.sqrt(1 - w2 * w2)
    k1 = np.pi * lam
    k2 = np.pi / 2 * params.cs * lam ** 3

    e = (Ellipsis, None, None)
    rel = angle - params.defocus_theta[e]
    du = params.defocus_u[e]
    dv = params.defocus_v[e]
    defocus = -(du + dv + (du - dv) * torch.cos(2 * rel)) / 2
    chi = k1[e] * defocus * f ** 2 + k2[e] * f ** 4 - params.phase_shift[e]
    return -w1[e] * torch.sin(chi) + w2[e] * torch.cos(chi)
