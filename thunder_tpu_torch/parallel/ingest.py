"""Per-rank ingest (thunder_tpu.parallel.ingest).

THUNDER's master byte-indexes the .thu and gives each rank a
contiguous chunk of particles, and every rank reads only its own images
(src/Database.cpp:207-254, :621).  Here every rank parses the (small,
text) .thu, derives the same global (hemi, L) layout from the seed,
asks its layout which rows it holds, and loads only those images.
thunder_tpu's ``assemble_global`` has no counterpart: a rank simply
keeps its block.
"""

from __future__ import annotations

import numpy as np

from thunder_tpu_torch.parallel.mesh import Layout, hemi_data_rows


def process_local_rows(layout: Layout, n_img: int) -> np.ndarray:
    """(2, n_img) bool mask of the global (hemi, L) rows this rank
    holds under the (hemi, data) layout."""
    return hemi_data_rows(layout, n_img)


def local_block(mask: np.ndarray):
    """The rank's row set as a rectangular (h_slice, l_slice) block
    (asserted, as thunder_tpu asserts it)."""
    hs = np.nonzero(mask.any(axis=1))[0]
    ls = np.nonzero(mask.any(axis=0))[0]
    h_sl = slice(hs.min(), hs.max() + 1)
    l_sl = slice(ls.min(), ls.max() + 1)
    sub = mask[h_sl, l_sl]
    if not sub.all() or mask.sum() != sub.size:
        raise ValueError("rank rows are not one rectangle of the (hemi, L) grid")
    return h_sl, l_sl
