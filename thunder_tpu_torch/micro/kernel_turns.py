"""HK1 ``project_slices``, HK3 ``insert_trilinear``, HK4 ``shell_sums``,
HK5 ``project_slices_2d``, HK6 ``insert_bilinear_2d``, HK7
``symmetrize_ft``, HK8 ``likelihood_local_ctf``, HK9
``insert_trilinear_slab`` and HK10 ``insert_mkb`` (at HK3's shapes, on
HK3's slices, in a tree that has it) of two checkouts timed in turns on
one card, at the shapes ``chip_smoke.py`` times.

    python thunder_tpu_torch/micro/kernel_turns.py PARENT_TREE [THIS_TREE]

Runs one process per turn, in the order parent, this, this, parent, each
with its own tree first on the module path (so each builds and loads its
own kernels), and prints each turn's times and a last JSON line.  A turn
calls only the kernels' public functions, with the table as that tree's
``Optimiser.proj_table`` would hand it over (the quad table where the
tree has one and it fits), the shell sums of a centered grid through
the entry that tree's ``spectrum.fsc`` takes, and HK7 and HK8 with the
arguments that tree's wrappers take (HK7's form and HK8's round terms
where it has them), so the same file measures both trees.  HK7 and HK8
are also timed alone (``... alone``: the calls replayed as a CUDA graph,
``micro/launch_floor.py``).  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def one_turn() -> dict:
    import numpy as np
    import torch

    from thunder_tpu_torch.device import generator
    from thunder_tpu_torch.geometry.quaternion import (random_quat, rotate2d_from_unit,
                                                       rotate3d)
    from thunder_tpu_torch.ops import insert, projector
    from thunder_tpu_torch.ops.fourier import pack_rings
    from thunder_tpu_torch.optimiser import proj_crop_size, reco_grid_size
    from thunder_tpu_torch.physics import spectrum
    from thunder_tpu_torch.physics.ctf import ctf_params

    dev = torch.device("cuda:0")
    gen = generator(0, dev)
    rng = np.random.default_rng(0)

    def timed(fn, reps, warm=2):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def as_handed_over(table):
        fits = getattr(projector, "quad_fits", None)
        if fits is not None and fits(2, table.shape[-1]):
            return projector.quad_taps(table)
        return table

    out = {}
    n_l = 128
    for size, r in ((128, 22), (256, 43)):
        rings = pack_rings(size, r, 1, device=dev)
        crop = proj_crop_size(size, 2, r)
        table = torch.randn(2, crop, crop, crop, dtype=torch.complex64, device=dev)
        handed = as_handed_over(table)
        rot = rotate3d(random_quat(gen, (2 * n_l, 125), dev))
        cls = torch.arange(2 * n_l, device=dev) // n_l
        out[f"HK1 phase {size} px"] = timed(lambda: projector.project_slices(
            handed, rot, rings.i_col, rings.i_row, 2, cls), 20 if size == 128 else 5)
        if handed is not table:
            out[f"HK1 phase {size} px, plain cube"] = timed(lambda: projector.project_slices(
                table, rot, rings.i_col, rings.i_row, 2, cls), 20)
        rot_g = rotate3d(random_quat(gen, (1, 256), dev))
        out[f"HK1 global {size} px"] = timed(lambda: projector.project_slices(
            handed[:1], rot_g, rings.i_col, rings.i_row, 2, None), 50)
        del table, handed
    defocus = rng.uniform(8000, 20000, n_l)
    ctf = ctf_params(np.full(n_l, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, n_l),
                     np.full(n_l, 2e7), np.full(n_l, 0.1), np.zeros(n_l), device=dev)
    n_s = n_l * 48
    img_idx = torch.arange(n_s, device=dev) // 48
    rot = rotate3d(random_quat(gen, (n_s,), dev))
    trans = 3 * torch.randn(n_s, 2, device=dev)
    w = torch.rand(n_s, device=dev) / 48
    mkb = getattr(insert, "insert_mkb", None)

    def hk3(name, *args, reps, d=None):
        out[name] = timed(lambda: insert.insert_trilinear(*args, d=d), reps)
        if mkb is not None:
            # HK10 (the MKB option) on the same slices, where the tree has it
            out[name.replace("HK3", "HK10")] = timed(lambda: mkb(*args, d=d), reps)

    for size, r_u in ((128, 36), (256, 85)):
        big = reco_grid_size(size, r_u) * 2
        ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_l, size, size, device=dev)),
                                dim=(-2, -1)).to(torch.complex64).contiguous()
        hk3(f"HK3 {size} px", ft, ctf, img_idx, rot, trans, w, r_u, 2, size, 1.32, big,
            reps=5 if size == 128 else 2)
    del ft
    # the 160 px paths: a class and hemisphere of a K = 4 round (r_u 31), a
    # CTF round's hemisphere with a defocus factor a slice (r_u 74), and
    # thunder_reconstruct's 1,024 images, one slice each (r_u 78)
    for name, n_i, per, r_u, use_d in (("HK3 K=4 132^3", 32, 48, 31, False),
                                       ("HK3 CTF round 304^3", 128, 48, 74, True),
                                       ("HK3 reconstruct 320^3", 1024, 1, 78, False)):
        big = reco_grid_size(160, r_u) * 2
        ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_i, 160, 160, device=dev)),
                                dim=(-2, -1)).to(torch.complex64).contiguous()
        defocus = rng.uniform(8000, 20000, n_i)
        ctf_i = ctf_params(np.full(n_i, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, n_i),
                           np.full(n_i, 2e7), np.full(n_i, 0.1), np.zeros(n_i), device=dev)
        n_s = n_i * per
        d = 1 + 0.03 * torch.randn(n_s, device=dev) if use_d else None
        hk3(name, ft, ctf_i, torch.arange(n_s, device=dev) // per,
            rotate3d(random_quat(gen, (n_s,), dev)), 3 * torch.randn(n_s, 2, device=dev),
            torch.rand(n_s, device=dev) / per, r_u, 2, 160, 1.32, big, reps=3, d=d)
        del ft
    out.update(turn_69(dev, gen, rng, timed))

    # HK4: the hemisphere FSC and the ring FRC (three stacked fields of a
    # centered grid, and spectrum.fsc on the spectra themselves), then the
    # sigma stage's packed-ring sums (both halves' images: 256 in the 3D
    # run, 10,000 in the 2D run)
    grid = getattr(spectrum, "shell_sums_grid", None)
    for name, size, nd, n_b in (("FSC 128 px", 128, 3, 1), ("FRC 160 px", 160, 2, 30)):
        u, half = spectrum.shell_geometry(size, nd, dev)
        n_sh = size // 2 - 2
        vals = torch.randn(n_b, 3, size ** nd, device=dev) ** 2
        sums = ((lambda: grid(vals, size, nd, n_sh)) if grid is not None
                else (lambda: spectrum.shell_sums(vals, u, n_sh, half)))
        out[f"HK4 {name}"] = timed(sums, 50)
        a, b = (torch.randn((n_b,) + (size,) * nd, dtype=torch.complex64, device=dev)
                for _ in range(2))
        out[f"spectrum.fsc {name}"] = timed(lambda: spectrum.fsc(a, b, n_sh, ndim=nd), 50)
    for name, size, r_u, r_l, n_b, n_c in (("sigma 3D C=3", 128, 36, 0, 256, 3),
                                           ("sigma 3D C=1 above r_u", 128, 62, 36, 256, 1),
                                           ("sigma 2D C=3", 160, 31, 0, 10000, 3),
                                           ("sigma 2D C=1 above r_u", 160, 78, 31, 10000, 1)):
        rings = pack_rings(size, r_u, r_l, lane=512, device=dev)
        n_sh = size // 2 - 1
        pv = torch.randn(n_b, n_c, rings.i_col.numel(), device=dev) ** 2
        sh = torch.clamp(rings.i_sig, max=n_sh - 1)
        out[f"HK4 {name}"] = timed(lambda: spectrum.shell_sums(pv, sh, n_sh), 20)
        del pv

    # HK5: the phase loop at r = 5 and 15, one global-search block, the
    # sigma pass (160 px, 2K = 60 planes)
    def rot2d(shape):
        phi = torch.rand(shape, generator=gen, device=dev) * (2 * np.pi)
        return rotate2d_from_unit(torch.stack([torch.cos(phi), torch.sin(phi)], -1))

    for name, r, r_l, lane, n_l, n_r, shared in (("phase r=5", 5, 1, 8, 10000, 9, False),
                                                 ("phase r=15", 15, 1, 8, 10000, 9, False),
                                                 ("global r=5", 5, 1, 8, 30, 100, True),
                                                 ("global r=15", 15, 1, 8, 30, 100, True),
                                                 ("sigma r_u=31", 31, 0, 512, 10000, 1, False)):
        rings = pack_rings(160, r, r_l, lane=lane, device=dev)
        crop = proj_crop_size(160, 2, r)
        table = torch.randn(60, crop, crop, dtype=torch.complex64, device=dev)
        if shared:
            rot = rot2d((1, n_r)).expand(n_l, n_r, 2, 2)
            cls = torch.arange(n_l, device=dev)
        else:
            rot, cls = rot2d((n_l, n_r)), torch.randint(0, 60, (n_l,), device=dev)
        out[f"HK5 {name}"] = timed(lambda: projector.project_slices_2d(
            table, rot, rings.i_col, rings.i_row, 2, cls), 50 if n_l * n_r < 50000 else 20)
    del table
    out.update(turn_78(dev, gen, rng, timed))
    return out


def turn_69(dev, gen, rng, timed) -> dict:
    """HK6 (the 2D round's 480,000 slices of 10,000 images into 60 planes
    at r_u 31, a tenth at r_u 12 and 40) and HK9 (C4, the first slab: 8b's
    24,576 slices at r_u 44 into 92 x 184^2, 8c's 256 slices at r_u 150
    into 320 x 640^2)."""
    import numpy as np
    import torch

    from thunder_tpu_torch.geometry.quaternion import random_quat, rotate2d_from_unit, rotate3d
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.ops import insert
    from thunder_tpu_torch.optimiser import reco_grid_size
    from thunder_tpu_torch.physics.ctf import ctf_params

    out = {}

    def ctf_of(n):
        defocus = rng.uniform(8000, 20000, n)
        return ctf_params(np.full(n, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, n),
                          np.full(n, 2e7), np.full(n, 0.1), np.zeros(n), device=dev)

    def spectra(n, size):
        return torch.fft.fftshift(torch.fft.fft2(torch.randn(n, size, size, device=dev)),
                                  dim=(-2, -1)).to(torch.complex64).contiguous()

    n_l, n_s = 10000, 480000
    ft, ctf = spectra(n_l, 160), ctf_of(n_l)
    img = torch.arange(n_s, device=dev) // 48
    cls_img = torch.randint(0, 30, (n_l,), generator=gen, device=dev) + 30 * (
        torch.arange(n_l, device=dev) // (n_l // 2))
    phi = torch.rand(n_s, generator=gen, device=dev) * (2 * np.pi)
    rot = rotate2d_from_unit(torch.stack([torch.cos(phi), torch.sin(phi)], -1))
    trans, w = 3 * torch.randn(n_s, 2, device=dev), torch.rand(n_s, device=dev) / 48
    for r_u, n_r in ((31, n_s), (12, n_s // 10), (40, n_s // 10)):
        big = reco_grid_size(160, r_u) * 2
        out[f"HK6 r_u={r_u} slices={n_r}"] = timed(lambda: insert.insert_bilinear_2d(
            ft, ctf, img[:n_r], cls_img[img[:n_r]], rot[:n_r], trans[:n_r], w[:n_r], r_u, 2,
            160, 1.32, big, 60), 5 if r_u == 31 else 2)
    del ft, rot, trans, w
    mats = Symmetry("C4", dev).matrices
    for name, n_i, per, size, r_u, big in (("HK9 8b", 512, 48, 160, 44, 184),
                                          ("HK9 8c", 256, 1, 320, 150, 640)):
        n_s = n_i * per
        vals, c2w, _, _ = insert.dense_slice_values(
            spectra(n_i, size), ctf_of(n_i), torch.arange(n_s, device=dev) // per,
            3 * torch.randn(n_s, 2, device=dev), torch.rand(n_s, device=dev) / per, r_u, size,
            1.32)
        rot = rotate3d(random_quat(gen, (n_s,), dev))
        cls = torch.zeros(n_s, dtype=torch.int32, device=dev)
        out[name] = timed(lambda: insert.insert_trilinear_slab(
            vals, c2w, rot, cls, r_u, 2, mats, 1, big, 0, big // 2), 3)
        del vals, c2w
    return out


def turn_78(dev, gen, rng, timed) -> dict:
    """HK7 (C4: the K = 1 pair of 152^3, the eight 132^3 grids of a K = 4
    round, one 320^3 grid) and HK8 (256 images, D 9, R 125, T 9 at P =
    728 and 9,448), each by CUDA events and alone."""
    import numpy as np
    import torch

    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.micro.launch_floor import graph_ms
    from thunder_tpu_torch.ops import likelihood
    from thunder_tpu_torch.ops.fourier import pack_rings, translate_phases
    from thunder_tpu_torch.physics.ctf import ctf_params
    from thunder_tpu_torch.recon import reconstructor

    out = {}
    mats = Symmetry("C4", dev).matrices
    form = getattr(reconstructor, "symmetrize_form", None)
    extra = () if form is None else (form(mats),)
    for n_g, big in ((2, 152), (8, 132), (1, 320)):
        f = torch.complex(torch.randn(n_g, big, big, big, generator=gen, device=dev),
                          torch.randn(n_g, big, big, big, generator=gen, device=dev))
        t = torch.rand(n_g, big, big, big, generator=gen, device=dev)
        call = lambda: reconstructor.symmetrize_ft(f, t, mats, float(big // 2 - 6), *extra)
        name = f"HK7 C4 {n_g} x {big}^3"
        out[name] = timed(call, 10 if big < 300 else 3)
        out[f"{name} alone"] = graph_ms(call, calls=10 if big < 300 else 3)
        del f, t
    n_l, n_d, n_r, n_t, size = 256, 9, 125, 9, 160
    defocus = rng.uniform(8000, 20000, n_l)
    ctf = ctf_params(np.full(n_l, 300e3), defocus, defocus * rng.uniform(0.9, 1.1, n_l),
                     rng.uniform(0, 3, n_l), np.full(n_l, 2e7), np.full(n_l, 0.1),
                     np.zeros(n_l), device=dev)
    for r in (22, 78):
        rings = pack_rings(size, r, 1, device=dev)
        n_p = rings.i_col.numel()
        rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
        s_pack = -0.5 * rings.mask * (0.5 + torch.rand(n_l, n_p, generator=gen, device=dev))
        dat = torch.complex(rnd(n_l, n_p), rnd(n_l, n_p))
        pri = ((0.3 / n_p ** 0.5) * torch.complex(rnd(n_l, n_r, n_p), rnd(n_l, n_r, n_p))
               + 0.05 * dat[:, None, :]).to(torch.complex64)
        head = ((s_pack * dat).to(torch.complex64), s_pack)
        tail = (pri, translate_phases(rings, rnd(n_l, n_t, 2)), (s_pack * dat.abs() ** 2).sum(-1),
                torch.rand(n_l, n_r, generator=gen, device=dev),
                torch.rand(n_l, n_t, generator=gen, device=dev),
                torch.rand(n_l, n_d, generator=gen, device=dev))
        d = 1 + 0.01 * rnd(n_l, n_d)
        if hasattr(likelihood, "ctf_terms"):
            terms = likelihood.ctf_terms(ctf, rings.i_col, rings.i_row, size, 1.32)
            args = head + (terms, d) + tail
        else:
            args = head + (ctf, d, rings.i_col, rings.i_row, size, 1.32) + tail
        call = lambda: likelihood.likelihood_local_ctf(*args)
        name = f"HK8 P={n_p}"
        out[name] = timed(call, 10 if r < 50 else 3)
        out[f"{name} alone"] = graph_ms(call, calls=10 if r < 50 else 3)
        del args, pri
    return out


def main(argv) -> int:
    if argv[1:] == ["--one"]:
        print(json.dumps(one_turn()))
        return 0
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    trees = {"parent": os.path.abspath(argv[1]),
             "this": os.path.abspath(argv[2]) if len(argv) == 3 else here}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable"
    print(card, flush=True)
    turns = []
    for who in ("parent", "this", "this", "parent"):
        env = dict(os.environ, PYTHONPATH=trees[who])
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one"],
                             cwd=trees[who], env=env, capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append(dict(tree=who, ms=ms))
        print(f"{who:<7s} " + "  ".join(f"{k}: {v:.4f}" for k, v in ms.items()), flush=True)
    print(json.dumps({"card": card, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
