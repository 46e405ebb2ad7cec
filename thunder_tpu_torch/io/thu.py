""".thu particle metadata table (numpy only), as thunder_tpu.io.thu.

27 whitespace-separated columns per line (reference include/Database.h:22-287):

  0  voltage [V]             1  defocusU [A]        2  defocusV [A]
  3  defocusTheta [rad]      4  Cs [A]              5  amplitudeContrast
  6  phaseShift [rad]        7  particlePath        8  micrographPath
  9  coordX                 10  coordY             11  groupID (1-based)
 12  classID                13-16  quaternion (w,x,y,z)
 17-19  k1,k2,k3 (rotation concentration)          20-21  transX, transY
 22-23  stdTransX, stdTransY                       24  defocusFactor
 25  stdDefocusFactor       26  score

The .thu file doubles as the checkpoint: every round the optimiser
rewrites it with the current particle-filter compression
(Optimiser.cpp saveDatabase:8250-8416); resume loads it back
(Particle::load, Particle.cpp:401).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

N_COLUMNS = 27

_FLOAT_COLS = [0, 1, 2, 3, 4, 5, 6, 9, 10] + list(range(13, 27))
_INT_COLS = [11, 12]
_STR_COLS = [7, 8]


@dataclass
class ThuTable:
    """Columnar particle metadata; numpy arrays over n particles."""

    voltage: np.ndarray
    defocus_u: np.ndarray
    defocus_v: np.ndarray
    defocus_theta: np.ndarray
    cs: np.ndarray
    amplitude_contrast: np.ndarray
    phase_shift: np.ndarray
    particle_path: list = field(default_factory=list)
    micrograph_path: list = field(default_factory=list)
    coord_x: np.ndarray = None
    coord_y: np.ndarray = None
    group_id: np.ndarray = None
    class_id: np.ndarray = None
    quat: np.ndarray = None          # (n, 4)
    k1: np.ndarray = None
    k2: np.ndarray = None
    k3: np.ndarray = None
    trans: np.ndarray = None         # (n, 2)
    std_trans: np.ndarray = None     # (n, 2)
    defocus_factor: np.ndarray = None
    std_defocus_factor: np.ndarray = None
    score: np.ndarray = None

    def __len__(self):
        return len(self.voltage)

    @property
    def n_groups(self) -> int:
        return int(self.group_id.max()) if len(self) else 0

    def select(self, idx) -> "ThuTable":
        idx = np.asarray(idx)
        return ThuTable(
            voltage=self.voltage[idx],
            defocus_u=self.defocus_u[idx],
            defocus_v=self.defocus_v[idx],
            defocus_theta=self.defocus_theta[idx],
            cs=self.cs[idx],
            amplitude_contrast=self.amplitude_contrast[idx],
            phase_shift=self.phase_shift[idx],
            particle_path=[self.particle_path[i] for i in idx],
            micrograph_path=[self.micrograph_path[i] for i in idx],
            coord_x=self.coord_x[idx],
            coord_y=self.coord_y[idx],
            group_id=self.group_id[idx],
            class_id=self.class_id[idx],
            quat=self.quat[idx],
            k1=self.k1[idx],
            k2=self.k2[idx],
            k3=self.k3[idx],
            trans=self.trans[idx],
            std_trans=self.std_trans[idx],
            defocus_factor=self.defocus_factor[idx],
            std_defocus_factor=self.std_defocus_factor[idx],
            score=self.score[idx],
        )

    @staticmethod
    def blank(n: int, voltage=300e3, pixel_size=1.0) -> "ThuTable":
        z = lambda: np.zeros(n, dtype=np.float64)
        t = ThuTable(
            voltage=np.full(n, voltage), defocus_u=z(), defocus_v=z(),
            defocus_theta=z(), cs=z(), amplitude_contrast=z(), phase_shift=z(),
            particle_path=["-"] * n, micrograph_path=["-"] * n,
            coord_x=z(), coord_y=z(), group_id=np.ones(n, np.int64),
            class_id=np.zeros(n, np.int64),
            quat=np.tile(np.array([1.0, 0, 0, 0]), (n, 1)),
            k1=z(), k2=z(), k3=z(), trans=np.zeros((n, 2)),
            std_trans=np.zeros((n, 2)), defocus_factor=np.ones(n),
            std_defocus_factor=z(), score=z(),
        )
        return t


def read_thu(path: str) -> ThuTable:
    """Parse a .thu file (Database.cpp:109-138 + per-field getters)."""
    cols = [[] for _ in range(N_COLUMNS)]
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            # comment lines (first non-space char '#'): the reference
            # both writes them (saveDatabase column headers) and strips
            # them on read (Database.cpp:66-85) — resuming from a
            # reference-written Meta_Round_xxx.thu must work here too
            if parts[0].startswith("#"):
                continue
            if len(parts) != N_COLUMNS:
                raise ValueError(
                    f"{path}: expected {N_COLUMNS} columns, got {len(parts)}"
                )
            for i, p in enumerate(parts):
                cols[i].append(p)

    def farr(i):
        return np.asarray(cols[i], dtype=np.float64)

    def iarr(i):
        return np.asarray(cols[i], dtype=np.float64).astype(np.int64)

    return ThuTable(
        voltage=farr(0), defocus_u=farr(1), defocus_v=farr(2),
        defocus_theta=farr(3), cs=farr(4), amplitude_contrast=farr(5),
        phase_shift=farr(6), particle_path=cols[7], micrograph_path=cols[8],
        coord_x=farr(9), coord_y=farr(10), group_id=iarr(11),
        class_id=iarr(12),
        quat=np.stack([farr(13), farr(14), farr(15), farr(16)], axis=1),
        k1=farr(17), k2=farr(18), k3=farr(19),
        trans=np.stack([farr(20), farr(21)], axis=1),
        std_trans=np.stack([farr(22), farr(23)], axis=1),
        defocus_factor=farr(24), std_defocus_factor=farr(25), score=farr(26),
    )


def write_thu(path: str, t: ThuTable) -> None:
    """Write a .thu file with the reference's %18.9f / %6d formats."""
    with open(path, "w") as f:
        for i in range(len(t)):
            fields = [
                f"{t.voltage[i]:18.9f}", f"{t.defocus_u[i]:18.9f}",
                f"{t.defocus_v[i]:18.9f}", f"{t.defocus_theta[i]:18.9f}",
                f"{t.cs[i]:18.9f}", f"{t.amplitude_contrast[i]:18.9f}",
                f"{t.phase_shift[i]:18.9f}",
                t.particle_path[i] or "-", t.micrograph_path[i] or "-",
                f"{t.coord_x[i]:18.9f}", f"{t.coord_y[i]:18.9f}",
                f"{t.group_id[i]:6d}", f"{t.class_id[i]:6d}",
                f"{t.quat[i, 0]:18.9f}", f"{t.quat[i, 1]:18.9f}",
                f"{t.quat[i, 2]:18.9f}", f"{t.quat[i, 3]:18.9f}",
                f"{t.k1[i]:18.9f}", f"{t.k2[i]:18.9f}", f"{t.k3[i]:18.9f}",
                f"{t.trans[i, 0]:18.9f}", f"{t.trans[i, 1]:18.9f}",
                f"{t.std_trans[i, 0]:18.9f}", f"{t.std_trans[i, 1]:18.9f}",
                f"{t.defocus_factor[i]:18.9f}",
                f"{t.std_defocus_factor[i]:18.9f}", f"{t.score[i]:18.9f}",
            ]
            f.write(" ".join(fields) + "\n")


def parse_stack_ref(path: str) -> tuple[str, int | None]:
    """Split 'NNNN@stack.mrcs' into (file, slice) (Optimiser.cpp:4646)."""
    if "@" in path:
        idx, fname = path.split("@", 1)
        return fname, int(idx)
    return path, None
