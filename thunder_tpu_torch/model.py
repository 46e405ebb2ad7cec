"""Per-class model state and the resolution / search-type state machine
(src/Model.cpp, Model.cpp:1147-1516), as in thunder_tpu.model — plus
the randomised-phase "true FSC" (Model.cpp:411-567).

The state machine is host logic on scalars and spectra; it is copied
rather than imported because thunder_tpu.model reaches jax.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from thunder_tpu_torch.ops.fourier import fft3_centered, ifft3_centered
from thunder_tpu_torch.physics import spectrum

SEARCH_TYPE_STOP = -1
SEARCH_TYPE_GLOBAL = 0
SEARCH_TYPE_LOCAL = 1
SEARCH_TYPE_CTF = 2

MAX_ITER_R_CHANGE_NO_DECREASE_GLOBAL = 2
MAX_ITER_R_CHANGE_NO_DECREASE_LOCAL = 0
MAX_ITER_R_CHANGE_NO_DECREASE_CTF = 0
MAX_ITER_RES_NO_IMPROVE = 2
T_VARI_DECREASE = 0.02
CUTOFF_BEYOND_RES = 0


@dataclass
class ModelState:
    """Host-side scalar state of the E-M loop."""

    n_class: int
    size: int
    pixel_size: float
    r_init: int
    r_global: int
    max_r: int
    l_search: bool = True
    c_search: bool = False

    r: int = 0
    res: int = 1
    res_top: int = 1
    search_type: int = SEARCH_TYPE_GLOBAL
    search_type_prev: int = SEARCH_TYPE_GLOBAL
    increase_r: bool = False
    n_r_change_no_decrease: int = 0
    n_top_res_no_improve: int = 0
    t_vari_s0: float = math.inf
    t_vari_s1: float = math.inf
    t_vari_s0_prev: float = math.inf
    t_vari_s1_prev: float = math.inf
    fsc: np.ndarray = field(default=None)    # (n_class, max_r)

    def __post_init__(self):
        if self.r == 0:
            self.r = min(self.r_init, self.r_global)
        if self.fsc is None:
            self.fsc = np.ones((self.n_class, self.max_r))

    @property
    def r_u(self) -> int:
        """Reconstruction / FSC band: rU = min(r + AROUND(maxR/3), maxR)
        (Model::updateRU, Model.cpp:1543)."""
        return min(self.r + round(self.max_r / 3), self.max_r)

    def set_fsc(self, fsc: np.ndarray) -> None:
        self.fsc = np.atleast_2d(np.asarray(fsc))

    def resolution_p(self, thres: float) -> int:
        """Best class resolution at the given FSC threshold (shells)."""
        best = 1
        for t in range(self.fsc.shape[0]):
            best = max(best, spectrum.res_p(self.fsc[t], thres, pf=1, r_l=1))
        return best

    def update_res(self, thres_report: float) -> None:
        self.res = self.resolution_p(thres_report)

    def set_t_vari(self, s0: float, s1: float) -> None:
        self.t_vari_s0_prev = self.t_vari_s0
        self.t_vari_s1_prev = self.t_vari_s1
        self.t_vari_s0 = float(s0)
        self.t_vari_s1 = float(s1)

    def _determine_increase_r(self) -> bool:
        no_shrink = (
            self.t_vari_s0 > (1 - T_VARI_DECREASE) * self.t_vari_s0_prev
            and self.t_vari_s1 > (1 - T_VARI_DECREASE) * self.t_vari_s1_prev)
        self.n_r_change_no_decrease = (self.n_r_change_no_decrease + 1
                                       if no_shrink else 0)
        limit = {SEARCH_TYPE_GLOBAL: MAX_ITER_R_CHANGE_NO_DECREASE_GLOBAL,
                 SEARCH_TYPE_LOCAL: MAX_ITER_R_CHANGE_NO_DECREASE_LOCAL}.get(
                     self.search_type, MAX_ITER_R_CHANGE_NO_DECREASE_CTF)
        self.increase_r = (self.search_type != SEARCH_TYPE_STOP
                           and self.n_r_change_no_decrease >= limit)
        return self.increase_r

    def update_r(self, thres_cutoff: float) -> None:
        """Model::updateR + elevateR (Model.cpp:1147-1246)."""
        if self._determine_increase_r():
            res_fsc = self.resolution_p(thres_cutoff) + 1 + CUTOFF_BEYOND_RES
            if self.search_type == SEARCH_TYPE_GLOBAL:
                step = math.ceil((self.r_global - self.r_init) / 2)
                self.r = max(self.r, min(res_fsc, self.r + step))
                self.r = min(self.r, self.r_global)
            else:
                grown = min(math.ceil(self.r * math.sqrt(1.5)),
                            math.ceil(self.r + (self.max_r - self.r_global) / 8))
                self.r = max(self.r, min(res_fsc, grown))
            self.r = min(self.r, self.max_r)
            self.n_r_change_no_decrease = 0
            self.t_vari_s0 = self.t_vari_s1 = math.inf
            self.t_vari_s0_prev = self.t_vari_s1_prev = math.inf

    def update_search_type(self) -> int:
        """Model::searchType (Model.cpp:1417-1516)."""
        self.search_type_prev = self.search_type
        if self.search_type == SEARCH_TYPE_STOP:
            return self.search_type
        if self.search_type in (SEARCH_TYPE_LOCAL, SEARCH_TYPE_CTF):
            if self.increase_r:
                if self.res > self.res_top:
                    self.res_top = self.res
                    self.n_top_res_no_improve = 0
                else:
                    self.n_top_res_no_improve += 1
                if self.n_top_res_no_improve >= MAX_ITER_RES_NO_IMPROVE:
                    if self.search_type == SEARCH_TYPE_LOCAL and self.c_search:
                        self.search_type = SEARCH_TYPE_CTF
                        self._reset_after_transition()
                    else:
                        self.search_type = SEARCH_TYPE_STOP
        elif self.increase_r and self.r == self.r_global:
            if self.l_search:
                self.search_type = SEARCH_TYPE_LOCAL
                self._reset_after_transition()
            else:
                self.search_type = SEARCH_TYPE_STOP
        return self.search_type

    def _reset_after_transition(self):
        self.n_top_res_no_improve = 0
        self.n_r_change_no_decrease = 0
        self.increase_r = False
        self.t_vari_s0 = self.t_vari_s1 = math.inf
        self.t_vari_s0_prev = self.t_vari_s1_prev = math.inf

    def res_angstrom(self, thres: float) -> float:
        p = self.resolution_p(thres)
        if p <= 0:
            return math.inf
        return 1.0 / spectrum.res_p2a(p, self.size, self.pixel_size)


def _true_fsc_dev(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor,
                  gen: torch.Generator, n_shells: int,
                  phases: tuple | None = None) -> torch.Tensor:
    """True FSC of real-space FFT-layout volumes a, b (B, n, n, n) with
    mask m: the plain FSC's 0.8 crossing, phases randomised above it,
    then (FSC_mask - FSC_rf) / (1 - FSC_rf) beyond crossing + 2.
    ``phases`` injects the two uniform [0, 2 pi) phase fields."""
    fa, fb = fft3_centered(a), fft3_centered(b)
    fsc_unmask = spectrum.fsc(fa, fb, n_shells, ndim=3)
    idx = torch.arange(n_shells, device=a.device)
    below = (fsc_unmask < 0.8) & (idx >= 1)
    first = torch.where(below.any(-1), torch.argmax(below.to(torch.int32), -1),
                        torch.full(below.shape[:-1], n_shells, device=a.device))
    thres_shell = first - 1
    pa, pb = phases if phases is not None else (None, None)
    fa_rf = spectrum.random_phase(fa, thres_shell, gen, 3, pa)
    fb_rf = spectrum.random_phase(fb, thres_shell, gen, 3, pb)
    fsc_rf = spectrum.fsc(fft3_centered(ifft3_centered(fa_rf) * m),
                          fft3_centered(ifft3_centered(fb_rf) * m), n_shells, 3)
    fsc_mask = spectrum.fsc(fft3_centered(a * m), fft3_centered(b * m),
                            n_shells, 3)
    hi = idx >= (thres_shell + 2)[..., None]
    corrected = (fsc_mask - fsc_rf) / torch.clamp(1 - fsc_rf, min=1e-6)
    return torch.where(hi, corrected, fsc_mask)


def true_fsc_batch(refs_a, refs_b, mask, gen, n_shells: int) -> torch.Tensor:
    """All classes' true FSC, (K, n, n, n) pairs -> (K, n_shells)."""
    return _true_fsc_dev(refs_a, refs_b, mask, gen, n_shells)
