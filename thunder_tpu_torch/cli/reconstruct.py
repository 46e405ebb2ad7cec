"""thunder_reconstruct (appsrc/thunder_reconstruct.cpp), as
thunder_tpu.cli.reconstruct: a map from a .thu whose poses are known
(IO, CTF, insertion and gridding without the particle filter), on one
device:

    python -m thunder_tpu_torch.cli.reconstruct --thu meta.thu -o map.mrc \
        --size 160 --pixelsize 1.32 [--prefix ../Data/] [--sym C4] [--device cpu]

Every image is inserted once, at its pose, with weight 1/n, into
(size pf)^3 grids by HK3 (ops/insert.py: insert_trilinear), in chunks of
images; HK3 forms each slice's values from the image's spectrum, its
translation and its CTF (or a CTF of 1 with ``--no-ctf``) over the dense
window |k| < r_u - 1, both halves of it with the DC counted twice, so
the grids need no Hermitian fold afterwards (thunder_tpu inserts the
half space and folds).  With ``--sym`` HK7 sums F and T over the point
group in one launch; then the MAP-free gridding reconstruction.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# images whose spectra are on the device at once
CHUNK_IMAGES = 4096


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thunder_reconstruct")
    p.add_argument("--thu", required=True)
    p.add_argument("-o", required=True)
    p.add_argument("--size", type=int, required=True)
    p.add_argument("--pixelsize", type=float, required=True)
    p.add_argument("--prefix", default="")
    p.add_argument("--sym", default="C1")
    p.add_argument("--pf", type=int, default=2)
    p.add_argument("--no-ctf", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda': the first CUDA device; 'cpu' runs "
                        "on the CPU)")
    a = p.parse_args(argv)

    import torch

    from thunder_tpu_torch.device import COMPLEX, REAL, as_device
    from thunder_tpu_torch.geometry.quaternion import rotate3d
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.io.loader import load_images
    from thunder_tpu_torch.io.mrc import write_mrc
    from thunder_tpu_torch.io.thu import read_thu
    from thunder_tpu_torch.ops.fourier import fft2_centered
    from thunder_tpu_torch.ops.insert import insert_trilinear
    from thunder_tpu_torch.physics.ctf import CtfParams
    from thunder_tpu_torch.recon.reconstructor import reconstruct, symmetrize_ft

    dev = as_device(a.device)           # no card and no --device cpu: raise now
    thu = read_thu(a.thu)
    size, pf = a.size, a.pf
    n = len(thu)
    r_u = size // 2 - 2
    big = size * pf
    if a.no_ctf:
        # amplitude contrast 1, no defocus, no Cs: -0 sin(0) + 1 cos(0) = 1
        one, zero = np.ones(n), np.zeros(n)
        cols = (np.full(n, 300e3), zero, zero, zero, zero, one, zero)
    else:
        cols = (thu.voltage, thu.defocus_u, thu.defocus_v, thu.defocus_theta, thu.cs,
                thu.amplitude_contrast, thu.phase_shift)
    ctf_all = CtfParams(*[torch.as_tensor(np.asarray(c, np.float32), device=dev)
                          for c in cols])
    rot_all = rotate3d(torch.as_tensor(np.asarray(thu.quat, np.float32), device=dev))
    trans_all = torch.as_tensor(np.asarray(thu.trans, np.float32), device=dev)

    f_grid = torch.zeros((big,) * 3, dtype=COMPLEX, device=dev)
    t_grid = torch.zeros((big,) * 3, dtype=REAL, device=dev)
    for lo in range(0, n, CHUNK_IMAGES):
        sl = slice(lo, min(n, lo + CHUNK_IMAGES))
        imgs = load_images(thu, a.prefix, range(sl.start, sl.stop))
        ft = fft2_centered(torch.as_tensor(imgs, device=dev)).to(COMPLEX).contiguous()
        m = ft.shape[0]
        insert_trilinear(ft, ctf_all.map(lambda c: c[sl]),
                         torch.arange(m, device=dev), rot_all[sl], trans_all[sl],
                         torch.full((m,), 1.0 / n, dtype=REAL, device=dev), r_u, pf,
                         size, a.pixelsize, big, f_grid, t_grid)

    sym = Symmetry(a.sym, dev)
    if sym.order > 1:
        f_grid, t_grid = symmetrize_ft(f_grid, t_grid, sym.matrices, float((r_u - 1) * pf))
    vol = reconstruct(f_grid, t_grid, size, pf, r_u, guard_empty=True)
    write_mrc(a.o, vol.cpu().numpy(), a.pixelsize)
    return 0


if __name__ == "__main__":
    sys.exit(main())
