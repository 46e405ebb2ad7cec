"""The (hemi, data) rank layout: thunder_tpu's device mesh on
``torch.distributed``.

THUNDER's topology (src/Parallel.cpp:17-67) is MPI ranks split into
hemisphere A and B, plus NCCL reductions inside a node.  thunder_tpu
maps it onto one jax mesh with axes ("hemi", "data"); the port maps it
onto processes, one a device: rank i plays jax device i of
``devices.reshape(hemi, -1)``.

  * hemi extent 2: ranks 0 .. d-1 hold hemisphere A, ranks d .. 2d-1
    hemisphere B (d = world / 2, the data extent).  Rank h d + j holds
    images [j L/d, (j+1) L/d) of hemisphere h, what
    ``NamedSharding(mesh, P("hemi", "data"))`` gives jax device h d + j.
  * hemi extent 1 (a data-only layout): every rank holds both
    hemispheres and images [j L/N, (j+1) L/N).

A rank's groups: its *data group* (the ranks holding the same
hemispheres: sums of images, F and T), the *pair* of ranks with the
same data index in the two hemispheres (the references meet there) and
the world.  The collectives live in :mod:`thunder_tpu_torch.parallel.comm`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Layout:
    """One rank's place in the (hemi, data) grid of ``world`` ranks.
    ``groups`` holds the process groups (None on one process or where
    no process group was set up): ``data`` this rank's data group,
    ``pair`` its hemisphere pair (hemi extent 2 only)."""

    world: int
    rank: int
    hemi: int                 # extent of the hemi axis: 2, or 1 (data-only)
    data: int                 # extent of the data axis
    backend: str = "none"
    device: object = None
    groups: dict = field(default_factory=dict, repr=False)

    @property
    def h(self) -> int | None:
        """This rank's hemisphere on the hemi axis (None: data-only)."""
        return self.rank // self.data if self.hemi == 2 else None

    @property
    def j(self) -> int:
        """This rank's index on the data axis."""
        return self.rank % self.data

    @property
    def hemis(self) -> tuple:
        """The hemispheres whose images and state this rank holds."""
        return (0, 1) if self.hemi == 1 else (self.h,)

    def data_ranks(self, h: int | None = None) -> list:
        """The world ranks of a data group (hemisphere ``h``'s; the
        whole world in a data-only layout)."""
        if self.hemi == 1:
            return list(range(self.world))
        h = self.h if h is None else h
        return list(range(h * self.data, (h + 1) * self.data))

    def pair_ranks(self, j: int | None = None) -> list:
        """The two ranks of hemisphere pair ``j`` (hemi extent 2)."""
        j = self.j if j is None else j
        return [j, self.data + j]

    def rows(self, n_img: int) -> tuple:
        """(hemisphere slice, image slice) of the global (2, n_img)
        rows this rank holds; n_img must be a multiple of the data
        extent (the optimiser rounds L up to one)."""
        if n_img % self.data:
            raise ValueError(f"{n_img} images a hemisphere do not split over "
                             f"a data extent of {self.data}")
        b = n_img // self.data
        h_sl = slice(0, 2) if self.hemi == 1 else slice(self.h, self.h + 1)
        return h_sl, slice(self.j * b, (self.j + 1) * b)

    def take(self, x):
        """This rank's rows of a global (2, L, ...) array or tensor."""
        h_sl, l_sl = self.rows(x.shape[1])
        return x[h_sl, l_sl]

    def describe(self) -> str:
        shape = (f"hemi {self.hemi} x data {self.data}" if self.hemi == 2
                 else f"data {self.data}")
        return (f"rank {self.rank}/{self.world} ({shape}) hemispheres {self.hemis} "
                f"data index {self.j} backend {self.backend} device {self.device}")


def single(device=None) -> Layout:
    """The one-process layout: both hemispheres, every image."""
    return Layout(world=1, rank=0, hemi=1, data=1, device=device)


def make_mesh(n: int, hemi: int = 2, rank: int = 0, device=None,
              backend: str = "none") -> Layout:
    """Rank ``rank``'s place in a (hemi, data) layout of ``n`` ranks
    (thunder_tpu.parallel.mesh.make_mesh): hemi 2 for gold standard, the
    rest forms the data axis."""
    if n % hemi:
        raise ValueError(f"{n} ranks not divisible by hemi={hemi}")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a world of {n}")
    return Layout(world=n, rank=rank, hemi=hemi, data=n // hemi,
                  backend=backend, device=device)


def hemi_data_rows(layout: Layout, n_img: int) -> np.ndarray:
    """(2, n_img) bool mask of the rows ``layout``'s rank holds (the
    counterpart of ``hemi_data_sharding``)."""
    mask = np.zeros((2, n_img), bool)
    h_sl, l_sl = layout.rows(n_img)
    mask[h_sl, l_sl] = True
    return mask


def replicated_per_hemi(layout: Layout, x):
    """This rank's hemispheres of a per-hemisphere state (2, ...), which
    is replicated over the data axis (``replicated_per_hemi``)."""
    return x[list(layout.hemis)]
