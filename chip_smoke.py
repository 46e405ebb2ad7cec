#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and fail
loudly.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA device and exits
non-zero, printing no result, without one (or without the package).

Phase 0 builds the eleven hand-written Hopper kernels (one nvcc per
source, sm_90a).  Phase 1 holds the 3D kernels (HK1-HK4) against their
plain PyTorch versions at the 3D path's 128 px shapes, phase 1b the 2D
path's at 160 px (HK5 at r = 5 and 15, HK6 with the 480,000 slices of
a round into 2K = 60 planes, HK2 at R = 100 x T = 151, HK4 at the ring
FRC and sigma shapes), timing both with CUDA events.  Phase 2 writes a 128 px, 256-image synthetic dataset
with the port's generator and runs three rounds of the demo-grid K=1 3D
refinement through ``thunder_tpu_torch.cli.thunder.main`` from the
phantom low-passed to 40 A.  It checks that the maps and FSC curves are
finite, that the output files exist, that the resolution ends finer
than the 40 A start, that the final map agrees with the phantom
(FSC 0.5) to a finer resolution than the start model does, and that
every kernel was launched by that run.  Phase 3 runs the gather
microbenchmark (``thunder_tpu_torch.micro.gather``: G1-G5 on the eight
cases of the repo's Pallas gathers, exact against plain PyTorch).
Phase 4 runs 2D classification on ``configs/demo_2D.json`` (K = 30,
160 px) for six rounds through the CLI on 10,000 synthetic images of
30 templates: FRC curves and class averages finite, the .mrcs and
Class_Info files written, ``res_A`` finer than the 60 A start (a gate
this data cannot fail: see phase_slice_2d), class purity at least 5/K,
and HK5, HK6, HK2 and HK4 launched.  Phase 5 reruns each path with
torch.profiler around one round (3D round 1, 2D round 4) and prints its
device time, idle share and heaviest kernels.  The last three lines are
JSON objects: the profiles, the kernels, and ``{"ok": true, "device":
{...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

SIZE = 128
N_IMAGES = 256
SNR = 3.0          # bench.py's make_dataset
PIXEL_SIZE = 1.32
ROUNDS = 3
# The run starts from the phantom low-passed to 40 A.  The phantom's
# blobs carry almost no signal past ~15 A at 128 px, so a run started
# from the phantom itself has nothing to improve; from a low-resolution
# start the refinement has to earn every shell past 40 A.
INIT_MODEL_RES_A = 40.0
# main-path shapes of the 128 px demo grid: global-search band r = 22,
# first-round reconstruction band r_u = 36, 128 images per hemisphere
R_GLOBAL, R_U, N_HEMI = 22, 36, 128
# the 2D path (configs/demo_2D.json): 160 px, K = 30, mS(2D) = 100
# rotations, T = 151 global translations, 10,000 images; search band
# r = 5 at the start and 15 at most in global rounds, reconstruction
# band r_u = 31 in the first rounds.  Six rounds: from random classes
# the K = 30 run collapses onto a few classes in round 1 and rebirth
# reseeds the starved ones, so class purity stays near chance for three
# rounds (0.055, 0.123, 0.120 on an H100) and passes 5/K from round 3 on
# (thunder_tpu shows the same collapse and rebirth on the CPU)
SIZE_2D, K_2D, N_2D, ROUNDS_2D = 160, 30, 10000, 6
R_2D, R_GLOBAL_2D, R_U_2D, N_ROT_2D, N_TRANS_2D = 5, 15, 31, 100, 151
INIT_RES_2D = 60.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls
    after ``warm`` warm-up calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare(name, shape, got, ref, rel_tol, reason):
    """max |got - ref| against rel_tol * max |ref|; returns the record."""
    import torch

    got = torch.as_tensor(got)
    ref = torch.as_tensor(ref)
    if got.shape != ref.shape:
        fail(f"{name} {shape}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name} {shape}: non-finite output")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / max(scale, 1e-30)
    say(f"  {name} {shape}: max_abs_err {err:.3e}  rel {rel:.3e}  "
        f"(tolerance rel {rel_tol:g}: {reason})")
    if not rel <= rel_tol:
        fail(f"{name} {shape}: relative error {rel:.3e} > {rel_tol:g}")
    return err


def low_pass(vol, shell: float, edge: float = 2.0):
    """Raised-cosine low-pass of a real FFT-layout volume: 1 below
    ``shell``, 0 beyond ``shell + edge`` (in Fourier shells)."""
    import numpy as np

    from thunder_tpu_torch.physics.mask import radial_grid

    r = radial_grid(vol.shape[-1], 3)          # |k| in np.fft.fftn's layout
    w =0.5 * (1 + np.cos(np.pi * np.clip((r - shell) / edge, 0, 1)))
    return np.real(np.fft.ifftn(np.fft.fftn(vol) * w)).astype(np.float32)


def agreement_res(vol, truth) -> float:
    """Resolution (A) at which the FSC of ``vol`` against ``truth`` first
    drops below 0.5."""
    import torch

    from thunder_tpu_torch.ops.fourier import fft3_centered
    from thunder_tpu_torch.physics import spectrum

    a, b = (fft3_centered(torch.as_tensor(v)) for v in (vol, truth))
    curve = spectrum.fsc(a, b, SIZE // 2 - 2).numpy()
    return SIZE * PIXEL_SIZE / max(spectrum.res_p(curve, 0.5), 1)


def lk_inputs(dev, n_img: int, n_r: int, n_t: int, n_cols: int):
    """HK2 inputs of one block (a, b, c) and fresh accumulators (base,
    w_c, w_r over ``n_cols`` columns, w_t)."""
    import torch

    a = -1e4 + 10 * torch.randn(n_img, device=dev)
    b = 40 * torch.randn(n_img, n_r, device=dev)
    c = 40 * torch.randn(n_img, n_t, n_r, device=dev).permute(0, 2, 1)
    acc = (torch.full((n_img,), float("-inf"), device=dev),
           torch.zeros(n_img, device=dev), torch.zeros(n_img, n_cols, device=dev),
           torch.zeros(n_img, n_t, device=dev))
    return a, b, c, acc


def run_blocks(fn, a, b, c, w_r, w_t, acc, blocks: int):
    """``blocks`` consecutive HK2 blocks (or its plain version ``fn``)
    into copies of ``acc``."""
    acc = [x.clone() for x in acc]
    for k in range(blocks):
        fn(a, b + k, c, w_r, w_t, *acc, col0=k * b.shape[1])
    return acc


def phase_kernels(dev):
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
    from thunder_tpu_torch.ops import insert, likelihood, projector
    from thunder_tpu_torch.ops.fourier import pack_rings
    from thunder_tpu_torch.optimiser import proj_crop_size, reco_grid_size
    from thunder_tpu_torch.physics import spectrum
    from thunder_tpu_torch.physics.ctf import ctf_params
    from thunder_tpu_torch.pipeline.synthetic import phantom
    from thunder_tpu_torch.device import generator

    gen = generator(0, dev)
    rng = np.random.default_rng(0)
    results = {}
    r_glob, r_u, n_l = R_GLOBAL, R_U, N_HEMI
    vol = torch.as_tensor(phantom(SIZE, rng), device=dev)

    # HK1 project_slices: phase loop (2 x 128 images x 125 rotations,
    # per-image) and global search (one 256-rotation block, shared)
    rings = pack_rings(SIZE, r_glob, 1, device=dev)
    crop = proj_crop_size(SIZE, 2, r_glob)
    table = projector.prepare_projectee_3d_cropped(
        torch.stack([vol, vol * 0.5]), 2, crop).contiguous()
    rot_l = rotate3d(random_quat(gen, (2 * n_l, 125), dev))
    cls = torch.arange(2 * n_l, device=dev) // n_l
    args_l = (table, rot_l, rings.i_col, rings.i_row, 2, cls)
    e_l = compare("project_slices", f"phases L={2 * n_l} R=125 P={rings.i_col.numel()} crop={crop}",
                  projector.project_slices(*args_l), projector.project_slices_plain(*args_l),
                  1e-5, "same arithmetic; FMA contraction moves coordinates by an ulp")
    rot_g = rotate3d(random_quat(gen, (1, 256), dev))
    args_g = (table[:1], rot_g, rings.i_col, rings.i_row, 2, None)
    e_g = compare("project_slices", "global R=256 shared",
                  projector.project_slices(*args_g), projector.project_slices_plain(*args_g),
                  1e-5, "as above")
    results["project_slices"] = dict(
        max_abs_err=max(e_l, e_g),
        ms=timed(lambda: projector.project_slices(*args_l), 20),
        plain_ms=timed(lambda: projector.project_slices_plain(*args_l), 5),
        shape=f"L={2 * n_l} R=125 P={rings.i_col.numel()} crop={crop}^3")

    # HK2 likelihood_block: global (128 images x 256 rotations x 30
    # translations, two consecutive blocks) and local (256 x 125 x 9)
    a, b, c, acc = lk_inputs(dev, n_l, 256, 30, 512)
    ones_r = torch.ones(1, 1, device=dev).expand(n_l, 256)
    ones_t = torch.ones(1, 1, device=dev).expand(n_l, 30)
    got = run_blocks(likelihood.likelihood_block, a, b, c, ones_r, ones_t, acc, 2)
    ref = run_blocks(likelihood.likelihood_block_plain, a, b, c, ones_r, ones_t, acc, 2)
    errs = [compare("likelihood_block", f"global L={n_l} R=256 T=30 {nm}", g, r, 1e-5,
                    "exp sums taken in another order")
            for nm, g, r in zip(("base", "w_c", "w_r", "w_t"), got, ref)]
    one = lambda fn: run_blocks(fn, a, b, c, ones_r, ones_t, acc, 1)
    ms_g = timed(lambda: one(likelihood.likelihood_block), 20)
    plain_g = timed(lambda: one(likelihood.likelihood_block_plain), 5)
    a, b, c, acc = lk_inputs(dev, 2 * n_l, 125, 9, 125)
    w_r = torch.rand(2 * n_l, 125, device=dev)
    w_t = torch.rand(2 * n_l, 9, device=dev)
    got = run_blocks(likelihood.likelihood_block, a, b, c, w_r, w_t, acc, 1)
    ref = run_blocks(likelihood.likelihood_block_plain, a, b, c, w_r, w_t, acc, 1)
    errs += [compare("likelihood_block", f"local L={2 * n_l} R=125 T=9 {nm}", g, r, 1e-5,
                     "exp sums taken in another order")
             for nm, g, r in zip(("u_r", "u_t"), got[2:], ref[2:])]
    results["likelihood_block"] = dict(max_abs_err=max(errs), ms=ms_g, plain_ms=plain_g,
                                       shape=f"L={n_l} R=256 T=30 (one global block)")

    # HK3 insert_trilinear: one hemisphere's compacted slices of a global
    # round (128 images x 48 slots) into the r_u = 36 grid
    big = reco_grid_size(SIZE, r_u) * 2
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_l, SIZE, SIZE, device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    defocus = rng.uniform(8000, 20000, n_l)
    ctf = ctf_params(np.full(n_l, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, n_l),
                     np.full(n_l, 2e7), np.full(n_l, 0.1), np.zeros(n_l), device=dev)
    n_s = n_l * 48
    img_idx = torch.arange(n_s, device=dev) // 48
    rot = rotate3d(random_quat(gen, (n_s,), dev))
    trans = 3 * torch.randn(n_s, 2, device=dev)
    w = torch.rand(n_s, device=dev) / 48
    ins = lambda: insert.insert_trilinear(ft, ctf, img_idx, rot, trans, w, r_u, 2,
                                          SIZE, PIXEL_SIZE, big)
    ins_p = lambda: insert.insert_trilinear_plain(
        ft, ctf, img_idx, rot, trans, w, r_u, 2, SIZE, PIXEL_SIZE,
        torch.zeros((big,) * 3, dtype=torch.complex64, device=dev),
        torch.zeros((big,) * 3, device=dev))
    (fk, tk), (fp, tp) = ins(), ins_p()
    e1 = compare("insert_trilinear", f"F slices={n_s} r_u={r_u} big={big}",
                 torch.view_as_real(fk), torch.view_as_real(fp), 1e-4,
                 "atomicAdd order varies from run to run")
    e2 = compare("insert_trilinear", "T", tk, tp, 1e-4, "atomicAdd order")
    results["insert_trilinear"] = dict(
        max_abs_err=max(e1, e2), ms=timed(ins, 5), plain_ms=timed(ins_p, 2),
        shape=f"slices={n_s} r_u={r_u} big={big}^3")

    # HK4 shell_sums: the hemisphere FSC (3 fields over the 128^3 box,
    # 62 shells) and the sigma stage's per-image sums (256 images)
    u, half = spectrum.shell_geometry(SIZE, 3, dev)
    vals = torch.randn(1, 3, SIZE ** 3, device=dev) ** 2
    n_sh = SIZE // 2 - 2
    e1 = compare("shell_sums", f"fsc B=1 C=3 N={SIZE}^3 shells={n_sh}",
                 spectrum.shell_sums(vals, u, n_sh, half),
                 spectrum.shell_sums_plain(vals, u, n_sh, half), 1e-4,
                 "float32 sums in a run-dependent order (atomics)")
    rings_u = pack_rings(SIZE, r_u, 0, lane=512, device=dev)
    pv = torch.randn(2 * n_l, 3, rings_u.i_col.numel(), device=dev) ** 2
    sh = torch.clamp(rings_u.i_sig, max=n_sh)
    e2 = compare("shell_sums", f"sigma B={2 * n_l} C=3 P={rings_u.i_col.numel()} shells={n_sh + 1}",
                 spectrum.shell_sums(pv, sh, n_sh + 1), spectrum.shell_sums_plain(pv, sh, n_sh + 1),
                 1e-4, "atomics order")
    results["shell_sums"] = dict(
        max_abs_err=max(e1, e2), ms=timed(lambda: spectrum.shell_sums(vals, u, n_sh, half), 20),
        plain_ms=timed(lambda: spectrum.shell_sums_plain(vals, u, n_sh, half), 5),
        shape=f"B=1 C=3 N={SIZE}^3 shells={n_sh}")
    for name, r in results.items():
        say(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return results


def phase_kernels_2d(dev):
    """HK5, HK6, HK2 and HK4 against their plain versions at the 2D
    path's shapes."""
    import numpy as np
    import torch

    from thunder_tpu_torch.device import generator
    from thunder_tpu_torch.geometry.quaternion import rotate2d_from_unit
    from thunder_tpu_torch.ops import insert, likelihood, projector
    from thunder_tpu_torch.ops.fourier import pack_rings
    from thunder_tpu_torch.optimiser import proj_crop_size, reco_grid_size
    from thunder_tpu_torch.physics import spectrum
    from thunder_tpu_torch.physics.ctf import ctf_params

    gen = generator(1, dev)
    rng = np.random.default_rng(1)
    results = {}

    def rot2d(shape):
        phi = torch.rand(shape, generator=gen, device=dev) * (2 * np.pi)
        return rotate2d_from_unit(torch.stack([torch.cos(phi), torch.sin(phi)], -1))

    # HK5: the phase loop (both halves' images, 9 rotations each, own
    # class of 2K planes) and one global-search block (all classes, 100
    # shared rotations), at the band every round on the card ran at
    # (r = 5) and at the widest global band (r = 15); timed at r = 5
    errs, times = [], {}
    for r in (R_2D, R_GLOBAL_2D):
        rings = pack_rings(SIZE_2D, r, 1, device=dev)
        crop = proj_crop_size(SIZE_2D, 2, r)
        table = torch.randn(2 * K_2D, crop, crop, dtype=torch.complex64, device=dev)
        cls = torch.randint(0, 2 * K_2D, (N_2D,), generator=gen, device=dev)
        args_l = (table, rot2d((N_2D, 9)), rings.i_col, rings.i_row, 2, cls)
        shape = f"L={N_2D} R=9 r={r} P={rings.i_col.numel()} crop={crop}^2"
        errs.append(compare("project_slices_2d", f"phases {shape}",
                            projector.project_slices_2d(*args_l),
                            projector.project_slices_2d_plain(*args_l), 1e-5,
                            "same coordinates (no FMA); tap sums may contract"))
        args_g = (table[:K_2D], rot2d((1, N_ROT_2D)).expand(K_2D, N_ROT_2D, 2, 2),
                  rings.i_col, rings.i_row, 2, torch.arange(K_2D, device=dev))
        errs.append(compare("project_slices_2d", f"global K={K_2D} R={N_ROT_2D} r={r} shared",
                            projector.project_slices_2d(*args_g),
                            projector.project_slices_2d_plain(*args_g), 1e-5, "as above"))
        times[r] = (timed(lambda: projector.project_slices_2d(*args_l), 20),
                    timed(lambda: projector.project_slices_2d_plain(*args_l), 5), shape)
    results["project_slices_2d"] = dict(
        max_abs_err=max(errs), ms=times[R_2D][0], plain_ms=times[R_2D][1],
        shape=times[R_2D][2], ms_r15=times[R_GLOBAL_2D][0],
        plain_ms_r15=times[R_GLOBAL_2D][1], shape_r15=times[R_GLOBAL_2D][2])

    # HK6 as Optimiser._insert_2d launches it once a round: both halves'
    # 10,000 images x 48 compacted slots into 2K class planes (image l of
    # half h goes to plane h K + its class) at r_u = 31
    big = reco_grid_size(SIZE_2D, R_U_2D) * 2
    n_s = N_2D * 48
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(N_2D, SIZE_2D, SIZE_2D, device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    defocus = rng.uniform(8000, 20000, N_2D)
    ctf = ctf_params(np.full(N_2D, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, N_2D),
                     np.full(N_2D, 2e7), np.full(N_2D, 0.1), np.zeros(N_2D), device=dev)
    img_idx = torch.arange(n_s, device=dev) // 48
    cls_img = (torch.randint(0, K_2D, (N_2D,), generator=gen, device=dev)
               + K_2D * (torch.arange(N_2D, device=dev) // (N_2D // 2)))
    args = (ft, ctf, img_idx, cls_img[img_idx], rot2d((n_s,)),
            3 * torch.randn(n_s, 2, device=dev), torch.rand(n_s, device=dev) / 48,
            R_U_2D, 2, SIZE_2D, PIXEL_SIZE)
    ins = lambda: insert.insert_bilinear_2d(*args, big, 2 * K_2D)
    ins_p = lambda: insert.insert_bilinear_2d_plain(
        *args, torch.zeros((2 * K_2D, big, big), dtype=torch.complex64, device=dev),
        torch.zeros((2 * K_2D, big, big), device=dev))
    (fk, tk), (fp, tp) = ins(), ins_p()
    shape = f"slices={n_s} planes={2 * K_2D} r_u={R_U_2D} big={big}"
    e1 = compare("insert_bilinear_2d", f"F {shape}", torch.view_as_real(fk),
                 torch.view_as_real(fp), 1e-4, "atomicAdd order varies from run to run")
    e2 = compare("insert_bilinear_2d", "T", tk, tp, 1e-4, "atomicAdd order")
    del fk, tk, fp, tp
    # the plain version takes seconds a call here: one timed call after
    # the comparison's
    results["insert_bilinear_2d"] = dict(
        max_abs_err=max(e1, e2), ms=timed(ins, 5), plain_ms=timed(ins_p, 1, warm=0),
        shape=shape + "^2")
    del ft, args

    # HK2 at the 2D global block: one class of a hemisphere, 100 x 151
    n_l = N_2D // 2
    a, b, c, acc = lk_inputs(dev, n_l, N_ROT_2D, N_TRANS_2D, N_ROT_2D)
    ones_r = torch.ones(1, 1, device=dev).expand(n_l, N_ROT_2D)
    ones_t = torch.ones(1, 1, device=dev).expand(n_l, N_TRANS_2D)
    run = lambda fn: run_blocks(fn, a, b, c, ones_r, ones_t, acc, 1)
    got, ref = run(likelihood.likelihood_block), run(likelihood.likelihood_block_plain)
    errs = [compare("likelihood_block", f"2D global L={n_l} R={N_ROT_2D} T={N_TRANS_2D} {nm}",
                    g, r, 1e-5, "exp sums taken in another order")
            for nm, g, r in zip(("base", "w_c", "w_r", "w_t"), got, ref)]
    results["likelihood_block_2d"] = dict(
        max_abs_err=max(errs), ms=timed(lambda: run(likelihood.likelihood_block), 20),
        plain_ms=timed(lambda: run(likelihood.likelihood_block_plain), 5),
        shape=f"L={n_l} R={N_ROT_2D} T={N_TRANS_2D} (60 KB shared memory)")

    # HK4 at the 2D shapes: the ring FRC of compare_refs (K class maps of
    # 160^2, 3 fields, max_r rings, half-plane weight) and the sigma
    # stage's per-image sums (both halves' images over the r_u band)
    n_sh = SIZE_2D // 2 - 2
    u, half = spectrum.shell_geometry(SIZE_2D, 2, dev)
    vals = torch.randn(K_2D, 3, SIZE_2D ** 2, device=dev) ** 2
    e1 = compare("shell_sums", f"2D FRC B={K_2D} C=3 N={SIZE_2D}^2 shells={n_sh}",
                 spectrum.shell_sums(vals, u, n_sh, half),
                 spectrum.shell_sums_plain(vals, u, n_sh, half), 1e-4, "atomics order")
    rings_u = pack_rings(SIZE_2D, R_U_2D, 0, lane=512, device=dev)
    pv = torch.randn(N_2D, 3, rings_u.i_col.numel(), device=dev) ** 2
    sh = torch.clamp(rings_u.i_sig, max=n_sh)
    e2 = compare("shell_sums", f"2D sigma B={N_2D} C=3 P={rings_u.i_col.numel()} "
                 f"shells={n_sh + 1}", spectrum.shell_sums(pv, sh, n_sh + 1),
                 spectrum.shell_sums_plain(pv, sh, n_sh + 1), 1e-4, "atomics order")
    results["shell_sums_2d"] = dict(
        max_abs_err=max(e1, e2), ms=timed(lambda: spectrum.shell_sums(vals, u, n_sh, half), 20),
        plain_ms=timed(lambda: spectrum.shell_sums_plain(vals, u, n_sh, half), 5),
        shape=f"2D FRC B={K_2D} C=3 N={SIZE_2D}^2 shells={n_sh}")
    for name, r in results.items():
        say(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return results


def phase_gather(dev, kernels):
    """The gather microbenchmark, counts read around its run."""
    import torch

    from thunder_tpu_torch.micro import gather as micro

    for k in kernels:
        k.launches = 0
    recs, refs = micro.run(dev, say=lambda m: say("  " + m))
    torch.cuda.synchronize()
    return recs, {k.__name__: k.launches for k in kernels}


def purity(cls, truth, k: int) -> float:
    """Share of images whose class's most common true template is their
    own."""
    import numpy as np

    good = sum(int(np.bincount(truth[cls == c], minlength=k).max())
               for c in range(k) if np.any(cls == c))
    return good / len(cls)


def demo_2d(tmp: str, dev) -> tuple:
    """The 2D dataset (N_2D synthetic 160 px images of K_2D templates)
    and configs/demo_2D.json pointed at it, under ``tmp``; returns
    (config path, each image's template)."""
    import numpy as np

    from thunder_tpu_torch.pipeline.synthetic import write_demo

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    write_demo(tmp, n=N_2D, size=SIZE_2D, snr=SNR, seed=0, device=dev, mode="2D", k=K_2D)
    say(f"  2D dataset {N_2D} x {SIZE_2D} px, {K_2D} templates, written in "
        f"{time.time() - t0:.1f} s")
    with open(os.path.join(here, "configs", "demo_2D.json")) as f:
        cfg = json.load(f)
    # the box and the class count are the config's own (160 px, 30)
    cfg["Basic"].update({
        "Size of Image": SIZE_2D, "Number of Classes": K_2D,
        "Number of Threads Per Process": 1,
        "Initial Model": "",
        ".thu File Storing Paths and CTFs of Images": os.path.join(tmp, "particles.thu"),
        "Path of Particles": tmp + "/",
        "Path of Output": os.path.join(tmp, "output") + "/"})
    cfg["Advanced"]["Max Number of Iteration"] = ROUNDS_2D
    cfg_path = os.path.join(tmp, "demo_2D.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    return cfg_path, np.load(os.path.join(tmp, "truth.npy"))


def phase_slice_2d(dev, wrappers):
    """ROUNDS_2D rounds of 2D classification on configs/demo_2D.json
    through the CLI, on 10,000 synthetic 160 px images of 30 templates."""
    import numpy as np
    import torch

    from thunder_tpu.io.mrc import read_mrc
    from thunder_tpu.io.thu import read_thu
    from thunder_tpu_torch.cli import thunder

    with tempfile.TemporaryDirectory(prefix="chip_smoke_2d_") as tmp:
        cfg_path, truth = demo_2d(tmp, dev)
        os.environ["THUNDER_STAGE_TIMING"] = "1"
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        rc = thunder.main([cfg_path, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        if rc != 0:
            fail(f"2D: thunder main returned {rc}")

        out = os.path.join(tmp, "output")
        with open(os.path.join(out, "round_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if len(recs) != ROUNDS_2D:
            fail(f"2D: {len(recs)} round records, expected {ROUNDS_2D}")
        need = (["Reference_Final.mrcs"]
                + [f"{p}_Round_{i:03d}{x}" for i in range(ROUNDS_2D)
                   for p, x in (("FSC", ".txt"), ("Meta", ".thu"), ("Class_Info", ".txt"),
                                ("Reference", ".mrcs"))])
        missing = [n for n in need if not os.path.exists(os.path.join(out, n))]
        if missing:
            fail(f"2D: missing outputs {missing}")
        purities = []
        for i, rec in enumerate(recs):
            meta = read_thu(os.path.join(out, f"Meta_Round_{i:03d}.thu"))
            idx = np.array([int(p.split("@")[0]) - 1 for p in meta.particle_path])
            purities.append(purity(np.asarray(meta.class_id), truth[idx], K_2D))
            rec["purity"] = purities[-1]
            say(f"  round {i}: r={rec['r']} phases={rec['n_phases']} res={rec['res_A']:.3f} A  "
                f"purity {purities[-1]:.4f}  {rec['elapsed_s']:.3f} s  "
                f"{N_2D / rec['elapsed_s']:.2f} img/s  reborn={rec.get('reborn_classes', [])}  "
                f"stage_ms={json.dumps(rec['stage_ms'])}")
            fsc = np.loadtxt(os.path.join(out, f"FSC_Round_{i:03d}.txt"))
            if fsc.size == 0 or not np.isfinite(fsc).all():
                fail(f"2D round {i}: FRC not finite")
            avgs, _ = read_mrc(os.path.join(out, f"Reference_Round_{i:03d}.mrcs"))
            if avgs.shape != (K_2D, SIZE_2D, SIZE_2D) or not np.isfinite(avgs).all():
                fail(f"2D round {i}: class averages of shape {avgs.shape} or non-finite")
            info = np.loadtxt(os.path.join(out, f"Class_Info_Round_{i:03d}.txt"))
            if info.shape != (K_2D, 3):
                fail(f"2D round {i}: Class_Info has shape {info.shape}")
        final, _ = read_mrc(os.path.join(out, "Reference_Final.mrcs"))
        if final.shape != (K_2D, SIZE_2D, SIZE_2D) or not np.isfinite(final).all():
            fail("2D: final class averages bad shape or non-finite")
        say(f"  2D main path wall {wall:.1f} s, launches {launches}")
        res = [r["res_A"] for r in recs]
        # On this data the gate cannot fail: res_A reads the band edge
        # (7.04 A) from round 0, in thunder_tpu as in the port.  The
        # FSC-pass maps are cut from the padded reconstruction box in real
        # space, and the low frequencies both halves share carry past the
        # cut, so the cut's edge lifts the FRC above 0.143 at every ring
        # (the FRC of F.W on the padded grid is at noise level there).
        # Purity is the quality gate of this phase.
        if not res[-1] < INIT_RES_2D:
            fail(f"2D: resolution {res} did not improve on the {INIT_RES_2D} A start")
        if not purities[-1] >= 5 / K_2D:
            fail(f"2D: class purity {purities[-1]:.4f} below 5/K = {5 / K_2D:.4f}")
        zero = [n for n, c in launches.items() if c <= 0]
        if zero:
            fail(f"2D: kernels never launched by the 2D path: {zero}")
    return launches, recs


def demo_3d(tmp: str, dev) -> tuple:
    """The 3D dataset (N_IMAGES synthetic 128 px images of the phantom),
    the start model (the phantom low-passed to 40 A) and the demo-grid
    config, under ``tmp``; returns (config path, phantom, start model)."""
    from thunder_tpu.io.mrc import read_mrc, write_mrc
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    t0 = time.time()
    cfg_path = write_demo(tmp, n=N_IMAGES, size=SIZE, snr=SNR, seed=0, device=dev)
    say(f"  3D dataset {N_IMAGES} x {SIZE} px written in {time.time() - t0:.1f} s")
    truth, _ = read_mrc(os.path.join(tmp, "init_model.mrc"))
    start = low_pass(truth, SIZE * PIXEL_SIZE / INIT_MODEL_RES_A)
    write_mrc(os.path.join(tmp, "init_model.mrc"), start, PIXEL_SIZE)
    with open(cfg_path) as f:
        cfg = json.load(f)
    basic, adv, prof = cfg["Basic"], cfg["Advanced"], cfg["Professional"]
    basic.update({"Estimated Translation (Pixel)": 3,
                  "Initial Resolution (Angstrom)": 12.0,
                  "Perform Global Search Under (Angstrom)": 8.0,
                  "Radius of Mask on Images (Angstrom)": SIZE * PIXEL_SIZE / 2 * 0.9})
    adv.update({"Max Number of Iteration": ROUNDS, "Padding Factor": 2,
                "Number of Sampling Points for Scanning in Global Search (3D)": 10000,
                "Number of Sampling Points of Rotation in Local Search (3D)": 125,
                "Number of Sampling Points of Translation in Local Search": 9,
                "Number of Sampling Points Used in Reconstruction": 100})
    prof["Translation Search Factor"] = 0.1
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    return cfg_path, truth, start


def profile_round(dev, cfg_path: str, target: int, label: str) -> dict:
    """Run the CLI on ``cfg_path`` up to round ``target`` with
    torch.profiler (CUDA activity) around that round alone.  Device time
    is the sum of the CUDA kernel events; the idle share is 1 - device
    time / the round's wall time under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from thunder_tpu_torch.cli import thunder
    from thunder_tpu_torch.optimiser import Optimiser

    run_round = Optimiser.run_round
    got = {}

    def profiled(self, i_round):
        if i_round != target:
            return run_round(self, i_round)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rec = run_round(self, i_round)
            torch.cuda.synchronize()
            got["wall"] = time.perf_counter() - t0
        got["events"] = prof.events()
        return rec

    os.environ.pop("THUNDER_STAGE_TIMING", None)
    Optimiser.run_round = profiled
    try:
        rc = thunder.main([cfg_path, "--device", str(dev), "--max-rounds", str(target + 1)])
    finally:
        Optimiser.run_round = run_round
    if rc != 0 or "events" not in got:
        fail(f"profile {label}: the CLI returned {rc} before round {target} was profiled")
    by_name, launches = {}, 0
    for e in got["events"]:
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        elif "LaunchKernel" in e.name:
            launches += 1
    if not by_name:
        fail(f"profile {label}: no CUDA kernel events in the profiled round")
    device_ms = sum(ms for ms, _ in by_name.values())
    rec = dict(path=label, round=target, wall_s=got["wall"], device_ms=device_ms,
               idle_share=1 - device_ms / 1e3 / got["wall"],
               kernels=sum(n for _, n in by_name.values()), launch_calls=launches)
    say(f"  profile {label} round {target}: wall {rec['wall_s']:.4f} s, device "
        f"{device_ms:.3f} ms in {rec['kernels']} kernels, idle share "
        f"{rec['idle_share']:.4f}, {launches} launch calls")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        say(f"    {ms:10.3f} ms x{n:<6d} {name[:90]}")
    return rec


def phase_profile(dev) -> list:
    """One profiled round of each path: 3D round 1 and 2D round 4 (the
    collapse and rebirth of rounds 1-3 are over by then)."""
    recs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_") as tmp:
        recs.append(profile_round(dev, demo_3d(tmp, dev)[0], 1, "3D"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prof_2d_") as tmp:
        recs.append(profile_round(dev, demo_2d(tmp, dev)[0], 4, "2D"))
    return recs


def phase_slice(dev, wrappers):
    """Three demo-grid rounds through the CLI on a synthetic dataset."""
    import numpy as np
    import torch

    from thunder_tpu.io.mrc import read_mrc
    from thunder_tpu_torch.cli import thunder

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path, truth, start = demo_3d(tmp, dev)
        os.environ["THUNDER_STAGE_TIMING"] = "1"
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        rc = thunder.main([cfg_path, "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        if rc != 0:
            fail(f"thunder main returned {rc}")

        out = os.path.join(tmp, "output")
        with open(os.path.join(out, "round_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if len(recs) != ROUNDS:
            fail(f"{len(recs)} round records, expected {ROUNDS}")
        for rec in recs:
            say(f"  round {rec['round']}: r={rec['r']} phases={rec['n_phases']} "
                f"res={rec['res_A']:.3f} A  {rec['elapsed_s']:.3f} s  "
                f"{N_IMAGES / rec['elapsed_s']:.2f} img/s  stage_ms={json.dumps(rec['stage_ms'])}")
        say(f"  main path wall {wall:.1f} s, launches {launches}")
        need = (["Reference_000_Final.mrc", "Reference_000_A_Final.mrc",
                 "Reference_000_B_Final.mrc"]
                + [f"{p}_Round_{i:03d}{s}" for i in range(ROUNDS)
                   for p, s in (("FSC", ".txt"), ("Meta", ".thu"), ("Class_Info", ".txt"),
                                ("Reference_000_A", ".mrc"), ("Reference_000_B", ".mrc"))])
        missing = [n for n in need if not os.path.exists(os.path.join(out, n))]
        if missing:
            fail(f"missing outputs {missing}")
        for i in range(ROUNDS):
            fsc = np.loadtxt(os.path.join(out, f"FSC_Round_{i:03d}.txt"))
            if fsc.size == 0 or not np.isfinite(fsc).all():
                fail(f"round {i}: FSC not finite")
            for tag in "AB":
                m, _ = read_mrc(os.path.join(out, f"Reference_000_{tag}_Round_{i:03d}.mrc"))
                if m.shape != (SIZE,) * 3 or not np.isfinite(m).all():
                    fail(f"round {i}: map {tag} bad shape or non-finite")
        res = [r["res_A"] for r in recs]
        if not res[-1] < INIT_MODEL_RES_A:
            fail(f"resolution {res} did not improve on the {INIT_MODEL_RES_A} A start")
        final, _ = read_mrc(os.path.join(out, "Reference_000_Final.mrc"))
        start_a, final_a = (agreement_res(m, truth) for m in (start, final))
        say(f"  FSC-0.5 against the phantom: start model {start_a:.2f} A, "
            f"final map {final_a:.2f} A (required: final finer than start)")
        if not final_a < start_a:
            fail(f"final map agrees with the phantom to {final_a:.2f} A, "
                 f"no finer than the start model's {start_a:.2f} A")
        zero = [n for n, c in launches.items() if c <= 0]
        if zero:
            fail(f"kernels never launched by the main path: {zero}")
    return launches, recs


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device visible")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from thunder_tpu_torch import _native
        from thunder_tpu_torch.ops import gather
        from thunder_tpu_torch.ops.insert import insert_bilinear_2d, insert_trilinear
        from thunder_tpu_torch.ops.likelihood import likelihood_block
        from thunder_tpu_torch.ops.projector import project_slices, project_slices_2d
        from thunder_tpu_torch.physics.spectrum import shell_sums
    except ImportError as e:
        fail(f"thunder_tpu_torch not importable ({e}); run from a checkout of the repo")

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    say(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
        else f"nvidia-smi unavailable: {smi.stderr.strip()}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    lib_path = _native.build()
    say(f"phase 0: kernels built in {time.time() - t0:.1f} s -> {os.path.relpath(lib_path, here)}")
    with open(os.path.join(_native.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("  ptxas: " + line.strip())
    _native.library()

    say("phase 1: 3D kernels against their plain versions")
    results = phase_kernels(dev)
    torch.cuda.synchronize()
    say("phase 1b: 2D kernels against their plain versions")
    results_2d = phase_kernels_2d(dev)
    torch.cuda.synchronize()

    wrappers = {"project_slices": project_slices, "likelihood_block": likelihood_block,
                "insert_trilinear": insert_trilinear, "shell_sums": shell_sums}
    say("phase 2: 3D refinement")
    launches, _ = phase_slice(dev, wrappers)
    torch.cuda.synchronize()

    say("phase 3: gather microbenchmark (G1-G5, exact against plain)")
    g_recs, g_launches = phase_gather(dev, gather.KERNELS)
    zero = [n for n, c in g_launches.items() if c <= 0]
    if zero:
        fail(f"gather kernels never launched by the microbenchmark: {zero}")

    wrappers_2d = {"project_slices_2d": project_slices_2d,
                   "insert_bilinear_2d": insert_bilinear_2d,
                   "likelihood_block": likelihood_block, "shell_sums": shell_sums}
    say("phase 4: 2D classification")
    launches_2d, _ = phase_slice_2d(dev, wrappers_2d)
    torch.cuda.synchronize()

    say("phase 5: one profiled round of each path")
    profiles = phase_profile(dev)
    torch.cuda.synchronize()

    meta = {
        "project_slices": ("HK1", "thunder_tpu_torch/csrc/project_slices.cu",
                           "thunder_tpu/ops/projector.py:478"),
        "likelihood_block": ("HK2", "thunder_tpu_torch/csrc/likelihood_block.cu",
                             "thunder_tpu/optimiser.py:275"),
        "insert_trilinear": ("HK3", "thunder_tpu_torch/csrc/insert_trilinear.cu",
                             "thunder_tpu/optimiser.py:1400"),
        "shell_sums": ("HK4", "thunder_tpu_torch/csrc/shell_sums.cu",
                       "thunder_tpu/optimiser.py:379"),
        "project_slices_2d": ("HK5", "thunder_tpu_torch/csrc/project_slices_2d.cu",
                              "thunder_tpu/ops/projector.py:372"),
        "insert_bilinear_2d": ("HK6", "thunder_tpu_torch/csrc/insert_bilinear_2d.cu",
                               "thunder_tpu/ops/insert.py:721"),
    }
    by_path = {name: {"3d": launches.get(name, 0), "2d": launches_2d.get(name, 0)}
               for name in meta}
    results["project_slices_2d"] = results_2d["project_slices_2d"]
    results["insert_bilinear_2d"] = results_2d["insert_bilinear_2d"]
    kernels = []
    for name, r in results.items():
        k = dict(name=name, id=meta[name][0], route="cuda", source=meta[name][1],
                 replaces=meta[name][2], launches=sum(by_path[name].values()),
                 launches_by_path=by_path[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], shape=r["shape"])
        k.update({key: v for key, v in r.items() if key.endswith("_r15")})
        # HK2 and HK4 serve both paths: their 2D-shape records ride along
        r2 = results_2d.get({"likelihood_block": "likelihood_block_2d",
                             "shell_sums": "shell_sums_2d"}.get(name, ""))
        if r2:
            k["max_abs_err"] = max(r["max_abs_err"], r2["max_abs_err"])
            k["ms_2d"], k["plain_ms_2d"], k["shape_2d"] = r2["ms"], r2["plain_ms"], r2["shape"]
        kernels.append(k)
    for fn in gather.KERNELS:
        cases = [c for c in g_recs if c["fn"] == fn.__name__]
        first = cases[0]
        kernels.append(dict(
            name=fn.__name__, id=first["kernel"], route="cuda",
            source="thunder_tpu_torch/csrc/gather.cu", replaces=first["replaces"],
            also_replaces=[c["replaces"] for c in cases[1:]],
            launches=g_launches[fn.__name__],
            max_abs_err=max(c["max_abs_err"] for c in cases), ms=first["ms"],
            plain_ms=first["plain_ms"], gbps=first["gbps"],
            cases={c["case"]: dict(ms=c["ms"], plain_ms=c["plain_ms"], rate=c["rate"],
                                   unit=c["unit"], gbps=c["gbps"]) for c in cases}))
    say(json.dumps({"profiles": profiles}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
