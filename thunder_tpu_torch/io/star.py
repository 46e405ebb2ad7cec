"""RELION STAR interop (reference script/STAR_2_THU.py, THU_2_STAR.py).

``read_star`` parses loop_ blocks into {label: list}; ``star_to_thu``
builds a ThuTable from CTF columns (+ optional pose columns);
``thu_to_star`` exports CTF + pose (quaternion -> RELION ZYZ Euler
angles in degrees, translation sign flipped per RELION's origin
convention, as in THU_2_STAR.py).  Host only, as in thunder_tpu.io.star.
"""

from __future__ import annotations

import math

import numpy as np

from thunder_tpu_torch.io.thu import ThuTable


def read_star(path: str) -> dict[str, list[str]]:
    """Parse the first data loop of a STAR file into columns by label."""
    labels: list[str] = []
    rows: list[list[str]] = []
    in_loop = False
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            if s.startswith("data_"):
                continue
            if s == "loop_":
                if labels:       # second loop: stop at the first
                    break
                in_loop = True
                continue
            if s.startswith("_"):
                if in_loop:
                    labels.append(s.split()[0].lstrip("_"))
                continue
            if in_loop and labels:
                parts = s.split()
                if len(parts) == len(labels):
                    rows.append(parts)
    return {lab: [r[i] for r in rows] for i, lab in enumerate(labels)}


def _get(cols, *names, default=None, n=None):
    for name in names:
        if name in cols:
            return np.asarray(cols[name], dtype=np.float64)
    if default is None:
        raise KeyError(f"STAR file missing required column(s) {names}")
    return np.full(n, default, dtype=np.float64)


def star_to_thu(path: str) -> ThuTable:
    cols = read_star(path)
    img = cols.get("rlnImageName") or cols.get("rlnParticleName")
    if img is None:
        raise KeyError("STAR file missing rlnImageName")
    n = len(img)
    voltage = _get(cols, "rlnVoltage", n=n) * 1000.0  # kV -> V
    t = ThuTable.blank(n)
    t.voltage = voltage
    t.defocus_u = _get(cols, "rlnDefocusU", n=n)
    t.defocus_v = _get(cols, "rlnDefocusV", n=n)
    t.defocus_theta = np.deg2rad(_get(cols, "rlnDefocusAngle", default=0.0, n=n))
    t.cs = _get(cols, "rlnSphericalAberration", n=n) * 1e7  # mm -> A
    t.amplitude_contrast = _get(cols, "rlnAmplitudeContrast", default=0.1, n=n)
    t.phase_shift = np.deg2rad(_get(cols, "rlnPhaseShift", default=0.0, n=n))
    t.particle_path = list(img)
    t.micrograph_path = list(cols.get("rlnMicrographName", [""] * n))
    t.coord_x = _get(cols, "rlnCoordinateX", default=0.0, n=n)
    t.coord_y = _get(cols, "rlnCoordinateY", default=0.0, n=n)
    if "rlnGroupNumber" in cols:
        t.group_id = np.asarray(cols["rlnGroupNumber"], dtype=np.float64).astype(np.int64)
    if "rlnClassNumber" in cols:
        t.class_id = np.asarray(cols["rlnClassNumber"], dtype=np.float64).astype(np.int64)
    # optional prior pose
    if "rlnAngleRot" in cols:
        phi = np.deg2rad(_get(cols, "rlnAngleRot", n=n))
        theta = np.deg2rad(_get(cols, "rlnAngleTilt", default=0.0, n=n))
        psi = np.deg2rad(_get(cols, "rlnAnglePsi", default=0.0, n=n))
        t.quat = np.stack(
            [
                np.cos((phi + psi) / 2) * np.cos(theta / 2),
                np.cos((phi - psi) / 2) * np.sin(theta / 2),
                np.sin((phi - psi) / 2) * np.sin(theta / 2),
                np.sin((phi + psi) / 2) * np.cos(theta / 2),
            ],
            axis=1,
        )
    if "rlnOriginX" in cols:
        # RELION origins are subtracted from coordinates; THUNDER
        # translations shift the reference, hence the sign flip
        t.trans = np.stack(
            [-_get(cols, "rlnOriginX", n=n), -_get(cols, "rlnOriginY", n=n)],
            axis=1,
        )
    return t


def _euler_from_quat_np(q: np.ndarray):
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    phi = np.arctan2(x * z + w * y, w * x - y * z)
    phi = np.where(phi < 0, phi + 2 * math.pi, phi)
    theta = np.arccos(np.clip(w * w - x * x - y * y + z * z, -1, 1))
    psi = np.arctan2(x * z - w * y, w * x + y * z)
    psi = np.where(psi < 0, psi + 2 * math.pi, psi)
    return phi, theta, psi


def thu_to_star(path: str, t: ThuTable, pixel_size: float = 1.0) -> None:
    phi, theta, psi = _euler_from_quat_np(t.quat)
    labels = [
        "rlnVoltage", "rlnDefocusU", "rlnDefocusV", "rlnDefocusAngle",
        "rlnSphericalAberration", "rlnAmplitudeContrast", "rlnPhaseShift",
        "rlnImageName", "rlnMicrographName", "rlnCoordinateX",
        "rlnCoordinateY", "rlnGroupNumber", "rlnClassNumber",
        "rlnAngleRot", "rlnAngleTilt", "rlnAnglePsi",
        "rlnOriginX", "rlnOriginY",
    ]
    with open(path, "w") as f:
        f.write("\ndata_\n\nloop_\n")
        for i, lab in enumerate(labels):
            f.write(f"_{lab} #{i + 1}\n")
        for i in range(len(t)):
            row = [
                f"{t.voltage[i] / 1000.0:.6f}",
                f"{t.defocus_u[i]:.6f}", f"{t.defocus_v[i]:.6f}",
                f"{np.rad2deg(t.defocus_theta[i]):.6f}",
                f"{t.cs[i] / 1e7:.6f}", f"{t.amplitude_contrast[i]:.6f}",
                f"{np.rad2deg(t.phase_shift[i]):.6f}",
                t.particle_path[i], t.micrograph_path[i],
                f"{t.coord_x[i]:.6f}", f"{t.coord_y[i]:.6f}",
                f"{t.group_id[i]:d}", f"{t.class_id[i]:d}",
                f"{np.rad2deg(phi[i]):.6f}", f"{np.rad2deg(theta[i]):.6f}",
                f"{np.rad2deg(psi[i]):.6f}",
                f"{-t.trans[i, 0]:.6f}", f"{-t.trans[i, 1]:.6f}",
            ]
            f.write(" ".join(row) + "\n")
