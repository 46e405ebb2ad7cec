"""Directional statistics: Angular Central Gaussian (quaternions) and
von Mises (2D in-plane rotations) — src/Geometry/DirectionalStat.cpp,
as in thunder_tpu.geometry.directional.  Every function batches over
leading dims; each batch entry is its own cloud.
"""

from __future__ import annotations

import math

import torch

from thunder_tpu_torch.device import REAL, draw
from thunder_tpu_torch.geometry.quaternion import quat_normalize

_ACG_TOL = 1e-3
_ACG_MAX_ITER = 64
_ACG_CHECK_EVERY = 8   # host convergence checks (one sync each)


def sample_acg(gen: torch.Generator, k1, k2, k3, n: int,
               noise: torch.Tensor | None = None) -> torch.Tensor:
    """``n`` quaternions per batch entry from ACG with covariance
    diag(1, k1, k2, k3) (DirectionalStat.cpp:78-91).  k* (...,) ->
    (..., n, 4).  ``noise`` injects the standard normals (tests)."""
    k1 = torch.as_tensor(k1, dtype=REAL)
    scale = torch.sqrt(torch.stack([torch.ones_like(k1), k1,
                                    torch.as_tensor(k2, dtype=REAL).expand_as(k1),
                                    torch.as_tensor(k3, dtype=REAL).expand_as(k1)],
                                   dim=-1))
    if noise is None:
        noise = draw(gen, "randn", k1.shape + (n, 4), k1.device)
    return quat_normalize(noise * scale[..., None, :])


def _det2(m):
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def inv_det4_spd(a: torch.Tensor):
    """Closed-form (inverse, determinant) of batched symmetric positive-
    definite 4x4 matrices by 2x2 block Schur complement."""

    def inv2(m, det):
        det = torch.where(torch.abs(det) > 1e-30, det,
                          torch.full_like(det, 1e-30))
        row0 = torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1)
        row1 = torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1)
        return torch.stack([row0, row1], dim=-2) / det[..., None, None]

    p = a[..., :2, :2]
    qb = a[..., :2, 2:]
    s = a[..., 2:, 2:]
    det_p = _det2(p)
    p_inv = inv2(p, det_p)
    pq = p_inv @ qb
    schur = s - qb.transpose(-1, -2) @ pq
    det_s = _det2(schur)
    s_inv = inv2(schur, det_s)
    tl = p_inv + pq @ s_inv @ pq.transpose(-1, -2)
    tr = -pq @ s_inv
    bl = tr.transpose(-1, -2)
    top = torch.cat([tl, tr], dim=-1)
    bot = torch.cat([bl, s_inv], dim=-1)
    return torch.cat([top, bot], dim=-2), det_p * det_s


def _dominant_eigvec_4(a: torch.Tensor, n_iter: int = 32) -> torch.Tensor:
    """Dominant eigenvector of batched symmetric PSD 4x4 by power
    iteration (same start vector and count as the JAX package)."""
    v = a[..., 0, :] + 0.05 * torch.sum(a, dim=-2) + 1e-6
    for _ in range(n_iter):
        v = (a @ v[..., None])[..., 0]
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=1e-30)
    return v


def infer_acg_matrix(q: torch.Tensor) -> torch.Tensor:
    """ML estimate of the 4x4 ACG matrix from quaternions (..., n, 4):
    B = 4/nf sum_i q_i q_i^T / (q_i^T A^-1 q_i), nf = sum_i 1/u_i,
    iterated per batch entry until sum|A - B| < 1e-3 or 64 steps
    (DirectionalStat.cpp:93-145).  Converged entries are frozen, so each
    returns exactly its own fixed-point iterate."""

    q_t = q.transpose(-1, -2)

    def step(a):
        u = torch.sum((q @ inv_det4_spd(a)[0]) * q, dim=-1)
        inv_u = 1.0 / torch.clamp(u, min=1e-12)
        b = 4.0 * ((q_t * inv_u[..., None, :]) @ q)
        return b / torch.sum(inv_u, dim=-1)[..., None, None]

    batch = q.shape[:-2]
    a = torch.eye(4, dtype=q.dtype, device=q.device).expand(batch + (4, 4))
    b = step(a)
    for it in range(_ACG_MAX_ITER):
        active = torch.sum(torch.abs(a - b), dim=(-2, -1)) > _ACG_TOL
        if it % _ACG_CHECK_EVERY == 0 and not bool(active.any()):
            break
        act = active[..., None, None]
        a, b = torch.where(act, b, a), torch.where(act, step(b), b)
    return a


def infer_acg_k123(q: torch.Tensor):
    """(k1, k2, k3) = (A11, A22, A33) / A00 (DirectionalStat.cpp:184-208)."""
    a = infer_acg_matrix(q)
    a00 = torch.clamp(a[..., 0, 0], min=1e-12)
    return a[..., 1, 1] / a00, a[..., 2, 2] / a00, a[..., 3, 3] / a00


def infer_acg_mean(q: torch.Tensor) -> torch.Tensor:
    """Dominant eigenvector of the ACG matrix (DirectionalStat.cpp:224-249)."""
    return quat_normalize(_dominant_eigvec_4(infer_acg_matrix(q)))


def vms_kappa(k: torch.Tensor) -> torch.Tensor:
    """Compression parameter k in (0, 1] -> von Mises concentration
    (DirectionalStat.cpp:256)."""
    k = torch.clamp(k, 1e-6, 1.0)
    return (1 - k) * (1 + 2 * k - k * k) / k / (2 - k)


def sample_vms(gen: torch.Generator, mu: torch.Tensor, k: torch.Tensor,
               n: int, n_rounds: int = 8) -> torch.Tensor:
    """``n`` unit 2-vectors per batch entry from von Mises around ``mu``
    ((2,) or (..., 2)) with compression ``k`` (...,): the Best-Fisher
    rejection sampler with a fixed number of proposal rounds
    (DirectionalStat.cpp:264-318); uniform on the circle for tiny kappa.
    Returns (..., n, 2)."""
    dev = mu.device
    kappa = vms_kappa(torch.as_tensor(k, dtype=REAL, device=dev))
    batch = kappa.shape
    kap = torch.clamp(kappa, min=1e-6)[..., None, None]
    a = 1 + torch.sqrt(1 + 4 * kap * kap)
    b = (a - torch.sqrt(2 * a)) / (2 * kap)
    r = (1 + b * b) / (2 * b)
    uz = draw(gen, "rand", batch + (n_rounds, n), dev)
    z = torch.cos(math.pi * uz)
    f = (1 + r * z) / (r + z)
    c = kap * (r - f)
    u2 = torch.clamp(draw(gen, "rand", batch + (n_rounds, n), dev), min=1e-12)
    accept = (c * (2 - c) > u2) | (torch.log(c / u2) + 1 - c >= 0)
    first = torch.argmax(accept.to(torch.int32), dim=-2, keepdim=True)
    f_sel = torch.where(accept.any(dim=-2),
                        torch.gather(f, -2, first)[..., 0, :],
                        torch.ones_like(f[..., 0, :]))
    delta = torch.sqrt(torch.clamp((1 - f_sel) * (1 + f_sel), min=0.0))
    flip = draw(gen, "rand", batch + (n,), dev)
    sign = torch.where(flip > 0.5, 1.0, -1.0)
    mu = mu.to(REAL).expand(batch + (2,))
    m0, m1 = mu[..., 0:1], mu[..., 1:2]
    out = torch.stack([m0 * f_sel + sign * delta * m1,
                       m1 * f_sel - sign * delta * m0], dim=-1)
    phi = uz[..., 0, :] * (2 * math.pi)
    uniform = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    return torch.where((kappa < 1e-1)[..., None, None], uniform, out)


def infer_vms(v: torch.Tensor):
    """Mean direction and compression k = 1 - R from unit 2-vectors
    (..., n, 2) (DirectionalStat.cpp:334-357)."""
    s = torch.sum(v, dim=-2)
    norm = torch.linalg.vector_norm(s, dim=-1)
    mu = s / torch.clamp(norm, min=1e-12)[..., None]
    return mu, 1 - norm / v.shape[-2]
