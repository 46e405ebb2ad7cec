"""thunder_project (appsrc/thunder_project.cpp), as
thunder_tpu.cli.project: projections of a volume at given or random
poses, on one device:

    python -m thunder_tpu_torch.cli.project -i map.mrc -o projs.mrcs -n 100 [--device cpu]
    python -m thunder_tpu_torch.cli.project -i map.mrc -o projs.mrcs --thu meta.thu

Each image is the central slice of the padded, grid-corrected spectrum
over every pixel of the box (HK1, ops/projector.py: project_full_3d, a
batch of images a launch), zero past the box's half width, shifted by
the pose's translation and transformed back.  Random poses come from a
``torch.Generator`` seeded with ``--seed``, so they differ from
thunder_tpu's (JAX keys).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# images projected a launch
BATCH = 512


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thunder_project")
    p.add_argument("-i", required=True, help="input volume MRC")
    p.add_argument("-o", required=True, help="output stack .mrcs")
    p.add_argument("-n", type=int, default=100, help="number of random poses")
    p.add_argument("--thu", help=".thu with poses to use instead of random")
    p.add_argument("--pf", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-thu", help="write the drawn poses to a .thu")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda': the first CUDA device; 'cpu' runs "
                        "on the CPU)")
    a = p.parse_args(argv)

    import torch

    from thunder_tpu_torch.device import REAL, as_device, generator
    from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
    from thunder_tpu_torch.io.mrc import read_mrc, write_mrc
    from thunder_tpu_torch.io.thu import ThuTable, read_thu, write_thu
    from thunder_tpu_torch.ops.fourier import ifft2_centered, translate_ft
    from thunder_tpu_torch.ops.projector import prepare_projectee_3d, project_full_3d

    dev = as_device(a.device)           # no card and no --device cpu: raise now
    vol, ps = read_mrc(a.i)
    proj = prepare_projectee_3d(torch.as_tensor(vol, dtype=REAL, device=dev), a.pf)
    if a.thu:
        t = read_thu(a.thu)
        quats = torch.as_tensor(np.asarray(t.quat, np.float32), device=dev)
        trans = torch.as_tensor(np.asarray(t.trans, np.float32), device=dev)
    else:
        quats = random_quat(generator(a.seed, dev), (a.n,), dev)
        trans = torch.zeros((a.n, 2), dtype=REAL, device=dev)
    n = quats.shape[0]

    rots = rotate3d(quats)
    imgs = []
    for lo in range(0, n, BATCH):
        ft = project_full_3d(proj, rots[lo:lo + BATCH])
        imgs.append(ifft2_centered(translate_ft(ft, trans[lo:lo + BATCH])).cpu().numpy())
    write_mrc(a.o, np.concatenate(imgs), ps, is_stack=True)

    if a.save_thu:
        t = ThuTable.blank(n)
        t.quat = quats.cpu().numpy().astype(np.float64)
        t.trans = trans.cpu().numpy().astype(np.float64)
        t.particle_path = [f"{i + 1}@{a.o}" for i in range(n)]
        write_thu(a.save_thu, t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
