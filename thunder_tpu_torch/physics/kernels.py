"""Gridding interpolation kernels (src/Functions/Functions.cpp), as in
thunder_tpu.physics.kernels:

  * TIK_RL(r) = sinc(pi r)^2, NIK_RL(r) = sinc(pi r)
  * MKB_FT(r; a, alpha) = I0(alpha sqrt(1-(r/a)^2)) / I0(alpha)
  * MKB_RL(r; a, alpha) = (2 pi)^{3/2} a^3 / I0(alpha) / v^{3/2} * B(v)
      with u = 2 pi a r, v = sqrt(|alpha^2 - u^2|),
      B = I_{3/2} inside (u <= alpha), J_{3/2} outside

Half-integer Bessels use their closed forms.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from thunder_tpu_torch.device import REAL


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), dtype=REAL)


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x, 1 at 0 (GSL's spherical bessel j0)."""
    return torch.sinc(x / math.pi)


def tik_rl(r) -> torch.Tensor:
    """FT of the trilinear interpolation kernel (TIK_RL)."""
    return _sinc(math.pi * _t(r)) ** 2


def nik_rl(r) -> torch.Tensor:
    """FT of the nearest-neighbour interpolation kernel (NIK_RL)."""
    return _sinc(math.pi * _t(r))


def _i_three_half(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, min=1e-12)
    return torch.sqrt(2 / (math.pi * x)) * (torch.cosh(x) - torch.sinh(x) / x)


def _j_three_half(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, min=1e-12)
    return torch.sqrt(2 / (math.pi * x)) * (torch.sin(x) / x - torch.cos(x))


def mkb_ft(r, a: float, alpha: float) -> torch.Tensor:
    """Fourier-space MKB blob profile (order 0), zero outside r > a."""
    r = _t(r)
    u2 = (r / a) ** 2
    val = (torch.special.i0(alpha * torch.sqrt(torch.clamp(1 - u2, min=0.0)))
           / torch.special.i0(torch.tensor(alpha, dtype=r.dtype,
                                           device=r.device)))
    return torch.where(u2 <= 1.0, val, torch.zeros_like(val))


def mkb_rl(r, a: float, alpha: float) -> torch.Tensor:
    """Real-space transform of the MKB blob (Functions.cpp:168-178)."""
    r = _t(r)
    u = 2 * math.pi * a * r
    v = torch.sqrt(torch.abs(alpha * alpha - u * u))
    i0a = float(torch.special.i0(torch.tensor(alpha, dtype=torch.float64)))
    w = (2 * math.pi) ** 1.5 * a ** 3 / i0a / torch.clamp(v, min=1e-12) ** 1.5
    return w * torch.where(u <= alpha, _i_three_half(v), _j_three_half(v))


def mkb_rl_r2(r2, a: float, alpha: float) -> torch.Tensor:
    """:func:`mkb_rl` on the squared radius (Functions.cpp:181-216)."""
    return mkb_rl(torch.sqrt(torch.clamp(_t(r2), min=0.0)), a, alpha)


def mkb_blob_vol(a: float, alpha: float) -> float:
    """Volume (integral) of the MKB blob (Functions.cpp:218-233)."""
    i0a = float(torch.special.i0(torch.tensor(alpha, dtype=torch.float64)))
    i32 = float(np.sqrt(2 / (np.pi * alpha))
                * (np.cosh(alpha) - np.sinh(alpha) / alpha))
    return float((2 * np.pi / alpha) ** 1.5 * i32 / i0a * a ** 3)
