"""Particle image loading: .thu table -> (n, size, size) stack, as
thunder_tpu.io.loader (Optimiser::initImg's reads, Optimiser.cpp:4608-4680).

Paths are 'NNNN@stack.mrcs' (1-based slice) or plain per-particle
files; each file is opened once.  MRC stacks go through the native
multithreaded reader (io/native.py) when a C++ compiler is found, else
through the numpy reader (io/mrc.py, an mmap), with the same bits;
8-bit BMP files through io/bmp.py.  Host only.
"""

from __future__ import annotations

import logging

import numpy as np

from thunder_tpu_torch.io import native
from thunder_tpu_torch.io.mrc import MrcFile
from thunder_tpu_torch.io.thu import ThuTable, parse_stack_ref

log = logging.getLogger("thunder")

# MRC stacks read, by reader: "native" (io/native.py) or "numpy"
# (io/mrc.py); incremented where a stack is read and nowhere else
READS = {"native": 0, "numpy": 0}


def load_images(thu: ThuTable, prefix: str = "", indices=None) -> np.ndarray:
    """Load (a subset of) the particles named in a ThuTable, in the
    order of ``indices`` (all, in .thu order, when None).

    Returns (n, size, size) float32, MRC slices in internal FFT layout,
    BMP images as the file stores them (as thunder_tpu does).  A BMP file
    holds one image: a .thu that addresses another slice of one raises
    (ImageFile.cpp:122-130), as it would otherwise train on duplicated
    data."""
    indices = range(len(thu)) if indices is None else indices
    per_file: dict[str, list[tuple[int, int]]] = {}
    for pos, i in enumerate(indices):
        fname, slc = parse_stack_ref(thu.particle_path[i])
        per_file.setdefault(prefix + fname, []).append(
            (pos, 0 if slc is None else slc - 1))      # @-indexing is 1-based
    out = [None] * sum(len(e) for e in per_file.values())
    reader = "native" if native.available() else "numpy"
    for path, entries in per_file.items():
        slices = [s for _, s in entries]
        if path.lower().endswith(".bmp"):
            from thunder_tpu_torch.io.bmp import read_bmp

            bad = [s for s in slices if s != 0]
            if bad:
                raise ValueError(
                    f"BMP stacks have a single image; {path} addressed "
                    f"with non-zero slice indices {bad[:5]}")
            img = read_bmp(path)
            imgs = [img] * len(slices)
        else:
            if READS[reader] == 0:
                log.info("MRC stacks read by the %s reader", reader)
            imgs = (native.read_mrc_slices_native(path, slices) if reader == "native"
                    else MrcFile(path).read_slices(slices))
            READS[reader] += 1
        for (pos, _), img in zip(entries, imgs):
            out[pos] = img
    return np.stack(out)
