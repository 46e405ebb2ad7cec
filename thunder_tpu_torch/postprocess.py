"""Final-map postprocessing: true-FSC estimation, half-map merging,
B-factor sharpening (reference src/Postprocess.cpp:50-183), as
thunder_tpu.postprocess, on one device.

  1. mask the half-maps; FSC(unmasked), FSC(masked)
  2. randomise phases above the shell where the unmasked FSC crosses 0.8
  3. mask the phase-randomised maps; FSCRF
  4. true FSC = (FSCmask - FSCRF) / (1 - FSCRF) above that shell + 2
  5. merge the halves, Cref = sqrt(2 FSC / (1 + FSC)) weighting
  6. Guinier B-factor fit over [10 A shell, resolution shell], sharpen,
     low-pass at the resolution, soft-mask.

The transforms, the three FSCs (HK4's pair form), the phase draws and
the filters run on the device; each FSC curve comes back to the host,
where the resolution shells are read off it as in thunder_tpu.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from thunder_tpu_torch.constants import EDGE_WIDTH_FT
from thunder_tpu_torch.device import REAL, as_device, generator
from thunder_tpu_torch.ops.fourier import fft3_centered, ifft3_centered
from thunder_tpu_torch.physics import spectrum
from thunder_tpu_torch.physics.filters import fsc_weighting_filter, sharpen

B_FACTOR_EST_LOW_RES = 10.0  # angstrom (include/Postprocess.h:28)


@dataclass
class PostprocessResult:
    map_sharp: np.ndarray      # real space FFT layout
    map_avg: np.ndarray
    fsc_true: np.ndarray
    fsc_unmask: np.ndarray
    fsc_mask: np.ndarray
    b_factor: float
    res_shell: int
    res_angstrom: float


def postprocess(map_a, map_b, mask, pixel_size: float,
                gen: torch.Generator | None = None, fsc_thres: float = 0.143,
                device=None, phases=None) -> PostprocessResult:
    """map_a, map_b, mask: (size,)^3 real-space FFT-layout arrays (numpy
    or tensors).  Runs on ``device`` (the first CUDA device unless the
    caller asks for the CPU); ``gen`` draws the random phases (seed 0 on
    the device when None); ``phases`` injects the two uniform [0, 2 pi)
    draws (tests)."""
    dev = as_device(device)
    gen = generator(0, dev) if gen is None else gen
    a, b, m = (torch.as_tensor(x, dtype=REAL, device=dev) for x in (map_a, map_b, mask))
    size = a.shape[-1]
    max_r = size // 2 - 1

    fa, fb = fft3_centered(a), fft3_centered(b)
    fam, fbm = fft3_centered(a * m), fft3_centered(b * m)
    fsc_unmask = spectrum.fsc(fa, fb, max_r).cpu().numpy()
    fsc_mask = spectrum.fsc(fam, fbm, max_r).cpu().numpy()

    thres_shell = spectrum.res_p(fsc_unmask, 0.8, pf=1, r_l=1)
    pa, pb = (None, None) if phases is None else phases
    fa_rf = spectrum.random_phase(fa, thres_shell, gen, phase=pa)
    fb_rf = spectrum.random_phase(fb, thres_shell, gen, phase=pb)
    fam_rf = fft3_centered(ifft3_centered(fa_rf) * m)
    fbm_rf = fft3_centered(ifft3_centered(fb_rf) * m)
    fsc_rf = spectrum.fsc(fam_rf, fbm_rf, max_r).cpu().numpy()

    fsc_true = np.array(fsc_mask)
    hi = np.arange(max_r) >= thres_shell + 2
    denom = np.maximum(1 - fsc_rf, 1e-6)
    fsc_true[hi] = ((fsc_mask - fsc_rf) / denom)[hi]

    res_shell = spectrum.res_p(fsc_true, fsc_thres, pf=1, r_l=1)
    res_angstrom = 1.0 / spectrum.res_p2a(max(res_shell, 1), size, pixel_size)

    merged = (fa + fb) / 2
    avg_rl = ifft3_centered(merged)

    weighted = fsc_weighting_filter(merged, torch.as_tensor(fsc_true, dtype=REAL))
    b_low_shell = int(round(spectrum.res_a2p(1.0 / B_FACTOR_EST_LOW_RES, size, pixel_size)))
    b_factor = spectrum.b_factor_est(weighted, max(res_shell, b_low_shell + 2), b_low_shell)
    sharp = sharpen(weighted, res_shell / size, EDGE_WIDTH_FT / size, b_factor)
    sharp_rl = ifft3_centered(sharp) * m
    return PostprocessResult(
        map_sharp=sharp_rl.cpu().numpy(),
        map_avg=avg_rl.cpu().numpy(),
        fsc_true=fsc_true,
        fsc_unmask=fsc_unmask,
        fsc_mask=fsc_mask,
        b_factor=b_factor,
        res_shell=res_shell,
        res_angstrom=res_angstrom,
    )
