"""The particle filter over (rotation, translation, defocus), batched
over leading dims (src/Particle.cpp), as in thunder_tpu.particle: 3D
(ACG over quaternions) and 2D (von Mises over in-plane angles, the pose
kept as the quaternion (cos phi, sin phi, 0, 0)); ``mode`` selects.

State tensors carry any leading batch shape B — the optimiser uses
(hemisphere, image) = (2, L):
    r (*B, nR, 4), t (*B, nT, 2), d (*B, nD)
    w_r/w_t/w_d prior weights, u_r/u_t/u_d likelihoods
    top_r (*B, 4), top_t (*B, 2), top_d (*B,), k1/k2/k3, s0/s1, s_d, score
Randomness comes from an explicit ``torch.Generator``; the functions
whose draws tests must control take them as optional arguments.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from thunder_tpu_torch.constants import (
    PEAK_FACTOR_BASE,
    PEAK_FACTOR_C,
    PEAK_FACTOR_MAX,
    PEAK_FACTOR_MIN,
    PERTURB_K_MAX,
)
from thunder_tpu_torch.device import REAL, draw
from thunder_tpu_torch.geometry.directional import (
    infer_acg_k123,
    infer_acg_matrix,
    infer_acg_mean,
    infer_vms,
    inv_det4_spd,
    sample_acg,
    sample_vms,
    vms_kappa,
)
from thunder_tpu_torch.geometry.quaternion import (quat_conj, quat_mul,
                                                   quat_normalize)

_CHI2_PPF_TRANSQ_2 = 5.991464547107981  # chisq Qinv(0.05, 2)
_CHI2_CDF_1_2 = 0.3934693402873666      # chisq P(1, 2)

MODE_2D = 2
MODE_3D = 3

MIN_STD_T = 0.1
MIN_K_R = 1e-5
MIN_STD_D = 1e-4


class ParticleState(NamedTuple):
    r: torch.Tensor
    t: torch.Tensor
    d: torch.Tensor
    w_r: torch.Tensor
    w_t: torch.Tensor
    w_d: torch.Tensor
    u_r: torch.Tensor
    u_t: torch.Tensor
    u_d: torch.Tensor
    top_r: torch.Tensor
    top_t: torch.Tensor
    top_d: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor
    s_d: torch.Tensor
    score: torch.Tensor

    def map(self, fn) -> "ParticleState":
        return ParticleState(*[fn(f) for f in self])

    @property
    def n_images(self) -> int:
        """Images along the last batch axis (a hemisphere's, in a (2, L)
        state)."""
        return self.r.shape[-3]

    @property
    def n_r(self) -> int:
        return self.r.shape[-2]

    @property
    def n_t(self) -> int:
        return self.t.shape[-2]

    @property
    def n_d(self) -> int:
        return self.d.shape[-1]


def _randn(gen, shape, device):
    return draw(gen, "randn", shape, device)


def _uniform(n: int, batch: tuple, device):
    return torch.full(batch + (n,), 1.0 / n, dtype=REAL, device=device)


def _quat_2d(v: torch.Tensor) -> torch.Tensor:
    """Unit 2-vectors (..., 2) -> in-plane quaternions (v0, v1, 0, 0)."""
    return torch.cat([v, torch.zeros_like(v)], dim=-1)


def init_particles(gen: torch.Generator, batch: tuple, n_r: int, n_t: int,
                   n_d: int, trans_s: float, device=None,
                   mode: int = MODE_3D) -> ParticleState:
    """Fresh support for global search (Particle::reset): uniform
    rotations (2D: uniform angles), Gaussian(trans_s) translations,
    defocus 1."""
    batch = tuple(batch)
    if mode == MODE_2D:
        phi = draw(gen, "rand", batch + (n_r,), device) * (2 * np.pi)
        r = _quat_2d(torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1))
    else:
        r = quat_normalize(_randn(gen, batch + (n_r, 4), device))
    t = _randn(gen, batch + (n_t, 2), device) * trans_s
    d = torch.ones(batch + (n_d,), dtype=REAL, device=device)
    zeros = torch.zeros(batch, dtype=REAL, device=device)
    return ParticleState(
        r=r, t=t, d=d, w_r=_uniform(n_r, batch, device),
        w_t=_uniform(n_t, batch, device), w_d=_uniform(n_d, batch, device),
        u_r=_uniform(n_r, batch, device), u_t=_uniform(n_t, batch, device),
        u_d=_uniform(n_d, batch, device),
        top_r=r[..., 0, :].clone(), top_t=t[..., 0, :].clone(),
        top_d=d[..., 0].clone(), k1=zeros + 1.0, k2=zeros + 1.0,
        k3=zeros + 1.0, s0=zeros + trans_s, s1=zeros + trans_s,
        s_d=zeros.clone(), score=zeros.clone())


def from_thu(quat, trans, std_trans, k123, defocus, std_d, n_r: int,
             n_t: int, n_d: int, gen: torch.Generator,
             device=None, mode: int = MODE_3D) -> ParticleState:
    """Resume support from .thu columns (Particle::load): each image's
    cloud is redrawn around its saved pose with the saved
    concentrations (2D: von Mises with k = min(k1, 1)), and the saved
    pose is rank-1."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    quat, t0, std_t, d0, sd = f(quat), f(trans), f(std_trans), f(defocus), f(std_d)
    k123 = f(k123)
    k1, k2, k3 = k123[:, 0], k123[:, 1], k123[:, 2]
    n = quat.shape[0]
    kk = torch.clamp(k1, min=1e-5)
    if mode == MODE_2D:
        v = sample_vms(gen, torch.tensor([1.0, 0.0], device=device),
                       torch.clamp(kk, max=1.0), n_r)
        r = quat_mul(quat[:, None, :].expand(n, n_r, 4), _quat_2d(v)).clone()
    else:
        pert = sample_acg(gen, kk, kk, kk, n_r)             # (n, n_r, 4)
        r = quat_mul(pert, quat[:, None, :].expand(n, n_r, 4)).clone()
    r[:, 0] = quat
    t = t0[:, None, :] + _randn(gen, (n, n_t, 2), device) * std_t[:, None, :]
    t[:, 0] = t0
    d = d0[:, None] + _randn(gen, (n, n_d), device) * sd[:, None]
    d[:, 0] = d0
    b = (n,)
    return ParticleState(
        r=r, t=t, d=d, w_r=_uniform(n_r, b, device),
        w_t=_uniform(n_t, b, device), w_d=_uniform(n_d, b, device),
        u_r=_uniform(n_r, b, device), u_t=_uniform(n_t, b, device),
        u_d=_uniform(n_d, b, device), top_r=quat.clone(), top_t=t0.clone(),
        top_d=d0.clone(), k1=k1, k2=k2, k3=k3, s0=std_t[:, 0].clone(),
        s1=std_t[:, 1].clone(), s_d=sd,
        score=torch.zeros(b, dtype=REAL, device=device))


def init_d_round(gen: torch.Generator, state: ParticleState, s_d: float,
                 noise: torch.Tensor | None = None) -> ParticleState:
    """Particle::initD at the start of every CTF-search round
    (Optimiser.cpp:1195-1196): the defocus support is scattered anew
    around 1 with std ``s_d`` (ctfRefineS), its weights made uniform (as
    thunder_tpu.particle.init_d_round has them) and s_d measured from the
    fresh sample; top_d keeps the running estimate.  ``noise`` injects
    the normals, of d's shape."""
    if noise is None:
        noise = _randn(gen, state.d.shape, state.d.device)
    uni = _uniform(state.d.shape[-1], tuple(state.d.shape[:-1]), state.d.device)
    return cal_vari_d(state._replace(d=(1.0 + noise * s_d).to(REAL), w_d=uni,
                                     u_d=uni.clone()))


# -- variance inference (Particle::calVari, Particle.cpp:1004-1142) -----

def cal_vari_r(state: ParticleState, mode: int = MODE_3D) -> ParticleState:
    if mode == MODE_2D:
        _, k = infer_vms(state.r[..., :2])
        k = torch.clamp(k, min=MIN_K_R)
        return state._replace(k1=k, k2=k, k3=k)
    mean = infer_acg_mean(state.r)
    centered = quat_mul(quat_conj(mean)[..., None, :].expand_as(state.r),
                        state.r)
    k1, k2, k3 = infer_acg_k123(centered)
    return state._replace(k1=torch.clamp(k1, min=MIN_K_R),
                          k2=torch.clamp(k2, min=MIN_K_R),
                          k3=torch.clamp(k3, min=MIN_K_R))


def cal_vari_t(state: ParticleState) -> ParticleState:
    s0 = torch.clamp(torch.std(state.t[..., 0], dim=-1), min=MIN_STD_T)
    s1 = torch.clamp(torch.std(state.t[..., 1], dim=-1), min=MIN_STD_T)
    return state._replace(s0=s0, s1=s1)


def cal_vari_d(state: ParticleState) -> ParticleState:
    if state.d.shape[-1] == 1:
        return state._replace(s_d=torch.zeros_like(state.s_d))
    return state._replace(s_d=torch.clamp(torch.std(state.d, dim=-1),
                                          min=MIN_STD_D))


def cal_score(state: ParticleState, mode: int = MODE_3D) -> ParticleState:
    """score = compressR (Particle.cpp:647-678)."""
    if mode == MODE_2D:
        return state._replace(score=1.0 / torch.clamp(state.k1, min=1e-12))
    return state._replace(score=torch.pow(
        torch.clamp(state.k1 * state.k2 * state.k3, min=1e-30), -1.0 / 6))


# -- perturbation (Particle::perturb, Particle.cpp:1149-1289) -----------

def perturb_r(gen: torch.Generator, state: ParticleState, pf: float,
              noise: torch.Tensor | None = None,
              mode: int = MODE_3D) -> ParticleState:
    """Kick every cloud with an ACG draw around its own mean, scaled by
    pf^2 times the (capped) concentrations; in 2D, turn every support
    point by a von Mises draw with k = min(PERTURB_K_MAX, pf k1).
    ``noise`` injects the ACG normals (3D) or the unit 2-vectors (2D)."""
    n_r = state.r.shape[-2]
    if mode == MODE_2D:
        if noise is None:
            noise = sample_vms(gen, torch.tensor([1.0, 0.0], device=state.r.device),
                               torch.clamp(state.k1 * pf, max=PERTURB_K_MAX), n_r)
        r = quat_mul(state.r, _quat_2d(noise))
        return balance_weight_r(state._replace(r=r), mode)
    s = lambda k: pf * pf * torch.clamp(k, max=PERTURB_K_MAX)
    pert = sample_acg(gen, s(state.k1), s(state.k2), s(state.k3), n_r, noise)
    mean = infer_acg_mean(state.r)[..., None, :].expand_as(state.r)
    centered = quat_mul(quat_conj(mean), state.r)
    r = quat_mul(mean, quat_mul(pert, centered))
    return balance_weight_r(state._replace(r=r))


def perturb_t(gen: torch.Generator, state: ParticleState, pf: float,
              trans_s: float, noise: torch.Tensor | None = None,
              fresh: torch.Tensor | None = None) -> ParticleState:
    """Gaussian kick scaled by the current std; outliers beyond
    trans_s * chi2Qinv(0.05, 2) are redrawn from the prior (reCentre)."""
    if noise is None:
        noise = _randn(gen, state.t.shape, state.t.device)
    if fresh is None:
        fresh = _randn(gen, state.t.shape, state.t.device)
    sd = torch.stack([state.s0, state.s1], dim=-1)[..., None, :]
    t = state.t + noise * sd * pf
    norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    t = torch.where(norm > trans_s * _CHI2_PPF_TRANSQ_2, fresh * trans_s, t)
    return balance_weight_t(state._replace(t=t))


def perturb_d(gen: torch.Generator, state: ParticleState, pf: float,
              noise: torch.Tensor | None = None) -> ParticleState:
    """Gaussian kick of the defocus support scaled by its current std."""
    if noise is None:
        noise = _randn(gen, state.d.shape, state.d.device)
    return state._replace(d=state.d + noise * state.s_d[..., None] * pf)


# -- proposal balancing (Particle::balanceWeight) -----------------------

def _inv_pdf_weights(pdf: torch.Tensor) -> torch.Tensor:
    """Normalised 1/pdf weights; non-finite weights drop to 0 and an
    all-zero row degrades to uniform (the point-mass limit)."""
    w = 1.0 / torch.clamp(pdf, min=1e-30)
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    tot = torch.sum(w, dim=-1, keepdim=True)
    uniform = torch.ones_like(w) / w.shape[-1]
    return torch.where(tot > 0, w / torch.clamp(tot, min=1e-30), uniform)


def balance_weight_r(state: ParticleState, mode: int = MODE_3D) -> ParticleState:
    """w_r = 1 / pdf of the fitted ACG proposal; a rank-collapsed cloud
    (det <= 1e-30, or any quad <= 1e-3, or a non-finite pdf) gets
    uniform weights.  2D: the fitted von Mises pdf (DirectionalStat.cpp:
    252-262), its Gaussian limit from kappa 5 on."""
    r = state.r
    if mode == MODE_2D:
        v = r[..., :2]
        mu, k = infer_vms(v)
        kappa = vms_kappa(k)[..., None]
        dot = torch.sum(v * mu[..., None, :], dim=-1)
        small = torch.exp(kappa * dot) / (
            2 * np.pi * torch.special.i0(torch.clamp(kappa, max=50.0)))
        dist = torch.linalg.vector_norm(v - mu[..., None, :], dim=-1)
        sig = torch.sqrt(1.0 / torch.clamp(kappa, min=1e-6))
        large = torch.exp(-0.5 * (dist / sig) ** 2) / (sig * np.sqrt(2 * np.pi))
        pdf = torch.where(kappa < 5.0, small, large)
        return state._replace(w_r=_inv_pdf_weights(pdf))
    a = infer_acg_matrix(r)
    a_inv, det = inv_det4_spd(a)
    quad = torch.sum((r @ a_inv) * r, dim=-1)
    pdf = (torch.pow(torch.clamp(det, min=1e-30), -0.5)[..., None]
           * torch.pow(torch.clamp(quad, min=1e-12), -2.0))
    ok = ((det > 1e-30) & torch.all(quad > 1e-3, dim=-1)
          & torch.all(torch.isfinite(pdf), dim=-1))
    pdf = torch.where(ok[..., None], pdf, torch.ones_like(pdf))
    return state._replace(w_r=_inv_pdf_weights(pdf))


def balance_weight_t(state: ParticleState) -> ParticleState:
    """w_t = 1 / bivariate-gaussian pdf fit of the current cloud."""
    t = state.t
    m = torch.mean(t, dim=-2, keepdim=True)
    s0 = torch.clamp(torch.std(t[..., 0], dim=-1, correction=0), min=1e-6)
    s1 = torch.clamp(torch.std(t[..., 1], dim=-1, correction=0), min=1e-6)
    z = (t - m) / torch.stack([s0, s1], dim=-1)[..., None, :]
    pdf = (torch.exp(-0.5 * torch.sum(z * z, dim=-1))
           / (2 * np.pi * (s0 * s1)[..., None]))
    return state._replace(w_t=_inv_pdf_weights(pdf))


def balance_weight_d(state: ParticleState) -> ParticleState:
    """w_d = 1 / gaussian pdf fit of the current defocus cloud."""
    d = state.d
    m = torch.mean(d, dim=-1, keepdim=True)
    s = torch.clamp(torch.std(d, dim=-1, correction=0), min=1e-6)[..., None]
    z = (d - m) / s
    pdf = torch.exp(-0.5 * z * z) / (s * np.sqrt(2 * np.pi))
    return state._replace(w_d=_inv_pdf_weights(pdf))


# -- peak clipping (Particle.cpp:1893-2002) -----------------------------

def peak_factor(u: torch.Tensor, base_div: int) -> torch.Tensor:
    n = u.shape[-1]
    srt = torch.sort(u, dim=-1, descending=True).values
    ref = srt[..., min(n // base_div, n - 1)]
    top = torch.clamp(srt[..., 0], min=1e-30)
    return torch.clamp(ref / top, PEAK_FACTOR_MIN, PEAK_FACTOR_MAX)


def keep_half_height_peak(u: torch.Tensor, pk: torch.Tensor) -> torch.Tensor:
    """u <- max(u - max(u) pk, 0) (keepHalfHeightPeak)."""
    hh = torch.amax(u, dim=-1, keepdim=True) * pk[..., None]
    return torch.where(u < hh, torch.zeros_like(u), u - hh)


def clip_u_r(state: ParticleState, mode: int = MODE_3D) -> ParticleState:
    base = PEAK_FACTOR_BASE if mode == MODE_2D else PEAK_FACTOR_BASE ** 3
    pk = peak_factor(state.u_r, base)
    return state._replace(u_r=keep_half_height_peak(state.u_r, pk))


def clip_u_t(state: ParticleState) -> ParticleState:
    n_t = state.t.shape[-2]
    idx = int(np.floor(n_t * _CHI2_CDF_1_2))
    srt = torch.sort(state.u_t, dim=-1, descending=True).values
    pk = torch.clamp(srt[..., min(idx, n_t - 1)]
                     / torch.clamp(srt[..., 0], min=1e-30),
                     PEAK_FACTOR_MIN, PEAK_FACTOR_MAX)
    return state._replace(u_t=keep_half_height_peak(state.u_t, pk))


def clip_u_class(w_c: torch.Tensor) -> torch.Tensor:
    """Class peak clipping with the constant PEAK_FACTOR_C."""
    return keep_half_height_peak(
        w_c, torch.full(w_c.shape[:-1], PEAK_FACTOR_C, dtype=REAL,
                        device=w_c.device))


# -- systematic resampling (Particle::resample, Particle.cpp:1291-1478) --

def systematic_resample(gen: torch.Generator, support_w: torch.Tensor,
                        u: torch.Tensor, n_new: int,
                        u0: torch.Tensor | None = None):
    """Resample indices by w * u; returns (idx, new_w) with
    new_w = 1 / u[idx] normalised (PARTICLE_PRIOR_ONE).  ``u0`` injects
    the (..., 1) uniform offsets in [0, 1)."""
    w = support_w * u
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    tot = torch.sum(w, dim=-1, keepdim=True)
    w = torch.where(tot > 0, w / torch.clamp(tot, min=1e-30),
                    torch.full_like(w, 1.0 / w.shape[-1]))
    cdf = torch.cumsum(w, dim=-1)
    cdf = (cdf / cdf[..., -1:]).contiguous()
    if u0 is None:
        u0 = draw(gen, "rand", w.shape[:-1] + (1,), w.device)
    pts = (u0 / n_new + torch.arange(n_new, dtype=REAL, device=w.device)
           / n_new).contiguous()
    n = w.shape[-1]
    idx = torch.clamp(torch.searchsorted(cdf, pts), max=n - 1)
    u_sel = torch.gather(u, -1, idx)
    new_w = 1.0 / torch.clamp(u_sel, min=1e-30)
    return idx, new_w / torch.sum(new_w, dim=-1, keepdim=True)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*B, n, C), idx (*B, m) -> (*B, m, C)."""
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def _argmax_row(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    top = torch.argmax(w, dim=-1)
    return _take_rows(x, top[..., None])[..., 0, :]


def resample_r(gen, state: ParticleState, n_new: int,
               u0: torch.Tensor | None = None) -> ParticleState:
    top_r = _argmax_row(state.r, state.w_r * state.u_r)
    idx, new_w = systematic_resample(gen, state.w_r, state.u_r, n_new, u0)
    return state._replace(r=_take_rows(state.r, idx), w_r=new_w,
                          u_r=torch.ones_like(new_w), top_r=top_r)


def resample_t(gen, state: ParticleState, n_new: int,
               u0: torch.Tensor | None = None) -> ParticleState:
    top_t = _argmax_row(state.t, state.w_t * state.u_t)
    idx, new_w = systematic_resample(gen, state.w_t, state.u_t, n_new, u0)
    return state._replace(t=_take_rows(state.t, idx), w_t=new_w,
                          u_t=torch.ones_like(new_w), top_t=top_t)


def resample_d(gen, state: ParticleState, n_new: int,
               u0: torch.Tensor | None = None) -> ParticleState:
    top_d = torch.gather(state.d, -1, torch.argmax(state.w_d * state.u_d, dim=-1,
                                                   keepdim=True))[..., 0]
    idx, new_w = systematic_resample(gen, state.w_d, state.u_d, n_new, u0)
    return state._replace(d=torch.gather(state.d, -1, idx), w_d=new_w,
                          u_d=torch.ones_like(new_w), top_d=top_d)


# -- insertion draws (Particle::rand, Particle.cpp:2109-2191) ----------

def _run_ids(v: torch.Tensor) -> torch.Tensor:
    """(*B, N, C) -> (*B, N) ids of contiguous equal-value runs (after
    systematic resampling, run identity is value identity)."""
    diff = torch.any(v[..., 1:, :] != v[..., :-1, :], dim=-1)
    zero = torch.zeros(diff.shape[:-1] + (1,), dtype=torch.int64,
                       device=v.device)
    return torch.cat([zero, torch.cumsum(diff.to(torch.int64), dim=-1)], dim=-1)


def draw_indices(gen: torch.Generator, state: ParticleState, n_draw: int):
    """Uniform support indices (ir, it, id), each (*B, n_draw)."""
    batch = state.r.shape[:-2]
    dev = state.r.device
    ri = lambda n: draw(gen, "randint", batch + (n_draw,), dev, n)
    return ri(state.r.shape[-2]), ri(state.t.shape[-2]), ri(state.d.shape[-1])


def draw_poses(gen: torch.Generator, state: ParticleState, n_draw: int, draws=None):
    """``n_draw`` uniform draws from the resampled support for
    reconstruction insertion (Particle::rand, Particle.cpp:2109-2191),
    each kept as drawn (draw_poses_compact merges equal ones).
    ``draws`` injects (ir, it, id).

    Returns quat (*B, n_draw, 4), trans (*B, n_draw, 2), d (*B, n_draw)."""
    ir, it, idd = draws if draws is not None else draw_indices(gen, state, n_draw)
    return (_take_rows(state.r, ir.long()), _take_rows(state.t, it.long()),
            torch.gather(state.d, -1, idd.long()))


def draw_poses_compact(gen: torch.Generator, state: ParticleState,
                       n_draw: int, n_slots: int, draws=None):
    """``n_draw`` uniform draws from the resampled support, with
    value-identical draws merged into one weighted slice (exact while an
    image has at most ``n_slots`` distinct draws; beyond, the top counts
    are kept and renormalised).  ``draws`` injects (ir, it, id).

    Returns quat (*B, S, 4), trans (*B, S, 2), d (*B, S), w (*B, S) with
    w summing to 1 per image; empty slots carry weight 0."""
    ir, it, idd = draws if draws is not None else draw_indices(gen, state, n_draw)
    ir, it, idd = ir.long(), it.long(), idd.long()
    rid_r = torch.gather(_run_ids(state.r), -1, ir)
    rid_t = torch.gather(_run_ids(state.t), -1, it)
    rid_d = torch.gather(_run_ids(state.d[..., None]), -1, idd)
    n_rt = state.t.shape[-2]
    n_rd = state.d.shape[-1]
    g = (rid_r * n_rt + rid_t) * n_rd + rid_d

    order = torch.argsort(g, dim=-1, stable=True)
    gs = torch.gather(g, -1, order)
    first = torch.cat([torch.ones(g.shape[:-1] + (1,), dtype=torch.bool,
                                  device=g.device),
                       gs[..., 1:] != gs[..., :-1]], dim=-1)
    uid = torch.cumsum(first.to(torch.int64), dim=-1) - 1
    # counts of ones: whole numbers, exact in any order of adds
    counts = torch.zeros(g.shape, dtype=REAL, device=g.device).scatter_add_(
        -1, uid, torch.ones_like(g, dtype=REAL))
    rep = torch.full(g.shape, n_draw, dtype=torch.int64, device=g.device
                     ).scatter_reduce_(-1, uid, order, reduce="amin")
    # top counts, ties to the lower slot (lax.top_k's order)
    pos_k = torch.argsort(-counts, dim=-1, stable=True)[..., :n_slots]
    cnt_k = torch.gather(counts, -1, pos_k)
    rep_k = torch.clamp(torch.gather(rep, -1, pos_k), max=n_draw - 1)
    q = _take_rows(state.r, torch.gather(ir, -1, rep_k))
    t = _take_rows(state.t, torch.gather(it, -1, rep_k))
    d = torch.gather(state.d, -1, torch.gather(idd, -1, rep_k))
    w = cnt_k / torch.clamp(torch.sum(cnt_k, dim=-1, keepdim=True), min=1.0)
    return q, t, d, w


def symmetrise_top(state: ParticleState, sym) -> ParticleState:
    """Fold top_r into the asymmetric unit (Particle::symmetrise)."""
    if sym is None or sym.order == 1:
        return state
    return state._replace(top_r=sym.counterpart(state.top_r))


def draw_classes(gen, w_c: torch.Tensor) -> torch.Tensor:
    """One class a row from the weights w_c (*B, K): argmax(w / q) with
    q ~ Exp(1) of w's shape, which is what torch.multinomial(w, 1)
    computes (its one-sample path), drawn through :func:`draw` so that a
    rank draws its rows of the global shape."""
    q = draw(gen, "exponential", w_c.shape, w_c.device)
    return torch.argmax(w_c / q, dim=-1)


class RowDraws:
    """Random draws at the global (hemisphere, image) shape, cut to one
    rank's rows, so that every rank of a layout draws what the
    one-process run draws for those rows (the generator, seeded alike
    on every rank, advances by the global shape).

    A draw covers the hemispheres of ``running``, (0, 1) unless a phase
    loop runs one of them alone: its global shape is (len(running),
    n_img, ...), and a rank's part (the hemispheres of ``running`` it
    holds, its images, ...).  Or, once :meth:`select` has set one, a
    selection of global rows (a routed round's running groups): its
    global shape is (1, len(selection), ...), as the one-process routed
    round draws, and a rank's part (1, the selected rows it holds, ...)
    in the selection's order.  ``log`` (a list, when set) records each
    draw's kind and trailing shape, and :meth:`replay` draws such a
    record again at the current cover and discards it: a rank that holds
    none of the rows a phase steps keeps its generator in step with the
    others'."""

    def __init__(self, gen: torch.Generator, hemis: tuple, n_img: int, l_sl: slice):
        self.gen = gen
        self.hemis = tuple(hemis)
        self.n_img = n_img
        self.l_sl = l_sl
        self.running = (0, 1)
        self.log = None
        self._sel = None          # (selection's length, this rank's positions in it)

    @property
    def device(self):
        return self.gen.device

    def select(self, rows: np.ndarray | None) -> np.ndarray | None:
        """Draw for the global rows ``rows`` (flat indices h n_img + l of
        the (2, n_img) grid) from now on, or for ``running`` again
        (None).  Returns a boolean mask over ``rows``, the rows this rank
        holds."""
        if rows is None:
            self._sel = None
            return None
        h, l = np.divmod(np.asarray(rows, np.int64), self.n_img)
        held = np.isin(h, self.hemis) & (l >= self.l_sl.start) & (l < self.l_sl.stop)
        self._sel = (len(h), torch.as_tensor(np.nonzero(held)[0], device=self.device))
        return held

    def local_rows(self, rows: np.ndarray) -> np.ndarray:
        """Global rows this rank holds -> flat indices into its own
        (hemispheres, images) grid."""
        h, l = np.divmod(np.asarray(rows, np.int64), self.n_img)
        h_loc = np.searchsorted(np.asarray(self.hemis), h)
        return h_loc * (self.l_sl.stop - self.l_sl.start) + l - self.l_sl.start

    def _full(self, kind: str, tail: tuple, high):
        lead = ((1, self._sel[0]) if self._sel is not None
                else (len(self.running), self.n_img))
        return draw(self.gen, kind, lead + tail, self.device, high)

    def draw(self, kind: str, shape: tuple, high: int | None = None) -> torch.Tensor:
        if self._sel is not None:
            want = (1, len(self._sel[1]))
        else:
            rows = [i for i, h in enumerate(self.running) if h in self.hemis]
            want = (len(rows), self.l_sl.stop - self.l_sl.start)
        if tuple(shape[:2]) != want:
            raise ValueError(f"a draw of shape {shape} is not this rank's rows {want}")
        if self.log is not None:
            self.log.append((kind, tuple(shape[2:]), high))
        full = self._full(kind, tuple(shape[2:]), high)
        if self._sel is not None:
            return full[:, self._sel[1]].contiguous()
        return full[rows, self.l_sl].contiguous()

    def replay(self, log: list) -> None:
        for kind, tail, high in log:
            self._full(kind, tail, high)
