"""Quaternion / rotation algebra, batched over leading dims
(src/Geometry/Euler.cpp), as in thunder_tpu.geometry.quaternion:
quaternions are (w, x, y, z); ``rotate3d(q)`` is I + 2w[A] + 2[A]^2.
"""

from __future__ import annotations

import math

import torch

from thunder_tpu_torch.device import REAL


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b; inputs (..., 4) (Euler.cpp:13-26)."""
    aw, ax, ay, az = torch.unbind(a, -1)
    bw, bx, by, bz = torch.unbind(b, -1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def rotate2d(phi: torch.Tensor) -> torch.Tensor:
    """(...,) angle -> (..., 2, 2) CCW rotation matrix (Euler.cpp:133-143)."""
    c, s = torch.cos(phi), torch.sin(phi)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def rotate2d_from_unit(v: torch.Tensor) -> torch.Tensor:
    """(..., 2) unit vector (cos, sin) -> (..., 2, 2) in-plane rotation
    (Euler.cpp:125).  A 2D pose is the quaternion (cos phi, sin phi, 0,
    0); its first two components give the rotation."""
    c, s = v[..., 0], v[..., 1]
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def rotate3d(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion -> (..., 3, 3) rotation matrix."""
    w, x, y, z = torch.unbind(q, -1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ]
    return torch.stack(rows, dim=-2)


def quat_from_axis_angle(axis: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3) + angle (...,) -> quaternion (Euler.cpp:102-109)."""
    half = phi / 2
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1)


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> quaternion (Euler.cpp:112-122)."""
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    w = 0.5 * torch.sqrt(torch.clamp(1 + t, min=0.0))
    x = 0.5 * torch.sqrt(torch.clamp(
        1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2], min=0.0))
    y = 0.5 * torch.sqrt(torch.clamp(
        1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2], min=0.0))
    z = 0.5 * torch.sqrt(torch.clamp(
        1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2], min=0.0))
    x = torch.copysign(x, m[..., 2, 1] - m[..., 1, 2])
    y = torch.copysign(y, m[..., 0, 2] - m[..., 2, 0])
    z = torch.copysign(z, m[..., 1, 0] - m[..., 0, 1])
    return torch.stack([w, x, y, z], dim=-1)


def quat_from_euler(phi, theta, psi) -> torch.Tensor:
    """ZYZ Euler -> quaternion (Euler.cpp:91-100)."""
    return torch.stack([
        torch.cos((phi + psi) / 2) * torch.cos(theta / 2),
        torch.cos((phi - psi) / 2) * torch.sin(theta / 2),
        torch.sin((phi - psi) / 2) * torch.sin(theta / 2),
        torch.sin((phi + psi) / 2) * torch.cos(theta / 2),
    ], dim=-1)


def euler_from_quat(q: torch.Tensor):
    """Quaternion -> (phi, theta, psi) in [0, 2 pi) (Euler.cpp:70-88)."""
    w, x, y, z = torch.unbind(q, -1)
    phi = torch.atan2(x * z + w * y, w * x - y * z)
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    theta = torch.arccos(torch.clamp(w * w - x * x - y * y + z * z, -1.0, 1.0))
    psi = torch.atan2(x * z - w * y, w * x + y * z)
    psi = torch.where(psi < 0, psi + 2 * math.pi, psi)
    return phi, theta, psi


def random_quat(gen: torch.Generator, shape: tuple, device=None
                ) -> torch.Tensor:
    """Uniform random rotations: normalised 4D Gaussians."""
    v = torch.randn(tuple(shape) + (4,), generator=gen, device=device,
                    dtype=REAL)
    return quat_normalize(v)


def random_unit2d(gen: torch.Generator, shape: tuple = (), device=None) -> torch.Tensor:
    """Uniform random points on the unit circle, as (cos, sin) pairs."""
    phi = torch.rand(tuple(shape), generator=gen, device=device, dtype=REAL) * (2 * math.pi)
    return torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)


def swing_twist(q: torch.Tensor, axis: torch.Tensor) -> tuple:
    """Decompose q = swing * twist with twist a rotation about ``axis``
    (Euler.cpp swingTwist): twist = normalize((w, projection of (x, y, z)
    on axis)), swing = q * conj(twist)."""
    proj = torch.sum(q[..., 1:] * axis, dim=-1, keepdim=True) * axis
    twist = quat_normalize(torch.cat([q[..., :1], proj], dim=-1))
    return quat_mul(q, quat_conj(twist)), twist


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by quaternions (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)
