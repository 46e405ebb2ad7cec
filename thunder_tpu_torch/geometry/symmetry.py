"""Point-group symmetry: Cn, Dn, T, O, I1-I4 (Symmetry.cpp,
SymmetryFunctions.cpp:65-151), as in thunder_tpu.geometry.symmetry:
the group is completed by closure on the host with numpy and exposed as
torch tensors.  ``n_elements`` counts non-identity elements
(``Symmetry::nSymmetryElement``).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from thunder_tpu_torch.device import REAL
from thunder_tpu_torch.geometry.quaternion import (quat_conj,
                                                   quat_from_matrix, quat_mul)

_ICO = {
    "I1": [(2, (1, 0, 0)), (5, (0.8506508, 0, -0.5257311)), (3, (0.9341724, 0.3568221, 0))],
    "I2": [(2, (0, 0, 1)), (5, (0.5257311, 0, 0.8506508)), (3, (0, 0.3568221, 0.9341724))],
    "I3": [(2, (-0.5257311, 0, 0.8506508)), (5, (0, 0, 1)), (3, (-0.4911235, 0.3568221, 0.7946545))],
    "I4": [(2, (0.5257311, 0, 0.8506508)), (5, (0.8944272, 0, 0.4472136)), (3, (0.4911235, 0.3568221, 0.7946545))],
}


def _axis_angle_matrix(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    a = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + np.sin(angle) * a + (1 - np.cos(angle)) * (a @ a)


def _generators(sym: str) -> list:
    sym = sym.strip().upper()
    if re.fullmatch(r"C\d+", sym):
        return [_axis_angle_matrix((0, 0, 1), 2 * np.pi / int(sym[1:]))]
    if re.fullmatch(r"D\d+", sym):
        return [_axis_angle_matrix((0, 0, 1), 2 * np.pi / int(sym[1:])),
                _axis_angle_matrix((1, 0, 0), np.pi)]
    if sym == "T":
        return [_axis_angle_matrix((0, 0, 1), 2 * np.pi / 3),
                _axis_angle_matrix((0, 0.816496, 0.577350), np.pi)]
    if sym == "O":
        return [_axis_angle_matrix((0.5773502, 0.5773502, 0.5773502), 2 * np.pi / 3),
                _axis_angle_matrix((0, 0, 1), np.pi / 2)]
    if sym in _ICO:
        return [_axis_angle_matrix(ax, 2 * np.pi / fold) for fold, ax in _ICO[sym]]
    raise ValueError(f"invalid symmetry group: {sym!r}")


def _closure(gens: list, max_order: int = 120) -> np.ndarray:
    """Complete the rotation group generated by ``gens`` (identity first)."""
    elems = [np.eye(3)]

    def find(m):
        return any(np.abs(e - m).max() < 1e-6 for e in elems)

    frontier = list(elems)
    while frontier:
        new = []
        for f in frontier:
            for g in gens:
                for m in (f @ g, g @ f):
                    if not find(m):
                        elems.append(m)
                        new.append(m)
                        if len(elems) > max_order:
                            raise RuntimeError("symmetry closure exceeded max order")
        frontier = new
    return np.stack(elems)


class Symmetry:
    """A point group: ``matrices`` (order, 3, 3) and ``quats`` (order, 4)
    float32 tensors (identity first) on ``device``."""

    def __init__(self, sym: str = "C1", device=None):
        self.name = (sym or "C1").strip().upper() or "C1"
        mats = np.eye(3)[None] if self.name == "C1" else _closure(_generators(self.name))
        self._mats = mats.astype(np.float64)
        self.matrices = torch.as_tensor(mats, dtype=REAL, device=device)
        self.quats = quat_from_matrix(self.matrices)
        self.order = int(mats.shape[0])
        self.n_elements = self.order - 1

    def counterpart(self, q: torch.Tensor, anchor=(1.0, 0.0, 0.0, 0.0)
                    ) -> torch.Tensor:
        """Fold quaternions (..., 4) into the asymmetric unit: among
        p_i = conj(s_i) * q, the one with the largest |p_i . anchor|."""
        if self.order == 1:
            return q
        anchor = torch.as_tensor(anchor, dtype=q.dtype, device=q.device)
        sq = self.quats.to(q.dtype).to(q.device)
        sq = sq.reshape((self.order,) + (1,) * (q.ndim - 1) + (4,))
        cand = quat_mul(quat_conj(sq), q.unsqueeze(0))
        best = torch.argmax(torch.abs(cand @ anchor), dim=0)
        return torch.take_along_dim(cand, best[None, ..., None], dim=0)[0]

    def __repr__(self):
        return f"Symmetry({self.name}, order={self.order})"
