#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and fail
loudly.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA device and exits
non-zero, printing no result, without one (or without the package).

Phase 1 builds the four hand-written Hopper kernels (nvcc, sm_90a) and
holds each against its plain PyTorch version at the main path's 128 px
shapes, timing both with CUDA events.  Phase 2 writes a 128 px,
256-image synthetic dataset with the port's generator and runs three
rounds of the demo-grid K=1 3D refinement through
``thunder_tpu_torch.cli.thunder.main`` from the phantom low-passed to
40 A.  It checks that the maps and FSC curves are finite, that the
output files exist, that the resolution ends finer than the 40 A start,
that the final map agrees with the phantom (FSC 0.5) to a finer
resolution than the start model does, and that every kernel was
launched by that run.  The second-to-last line is a JSON object
describing the kernels; the last is ``{"ok": true, "device": {...}}``.
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls
    after two warm-up calls."""
    import torch

    for _ in range(2):
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
    def lk_inputs(n_img, n_r, n_t, n_cols):
        a = -1e4 + 10 * torch.randn(n_img, device=dev)
        b = 40 * torch.randn(n_img, n_r, device=dev)
        c = 40 * torch.randn(n_img, n_t, n_r, device=dev).permute(0, 2, 1)
        acc = (torch.full((n_img,), float("-inf"), device=dev),
               torch.zeros(n_img, device=dev), torch.zeros(n_img, n_cols, device=dev),
               torch.zeros(n_img, n_t, device=dev))
        return a, b, c, acc

    def run_blocks(fn, a, b, c, w_r, w_t, acc, blocks):
        acc = [x.clone() for x in acc]
        for k in range(blocks):
            fn(a, b + k, c, w_r, w_t, *acc, col0=k * b.shape[1])
        return acc

    a, b, c, acc = lk_inputs(n_l, 256, 30, 512)
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
    a, b, c, acc = lk_inputs(2 * n_l, 125, 9, 125)
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


def phase_slice(dev, wrappers):
    """Three demo-grid rounds through the CLI on a synthetic dataset."""
    import numpy as np
    import torch

    from thunder_tpu.io.mrc import read_mrc, write_mrc
    from thunder_tpu_torch.cli import thunder
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.time()
        cfg_path = write_demo(tmp, n=N_IMAGES, size=SIZE, snr=SNR, seed=0, device=dev)
        say(f"phase 2: dataset {N_IMAGES} x {SIZE} px written in {time.time() - t0:.1f} s")
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
        from thunder_tpu_torch.ops.insert import insert_trilinear
        from thunder_tpu_torch.ops.likelihood import likelihood_block
        from thunder_tpu_torch.ops.projector import project_slices
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

    say("phase 1: kernels against their plain versions")
    results = phase_kernels(dev)
    torch.cuda.synchronize()

    wrappers = {"project_slices": project_slices, "likelihood_block": likelihood_block,
                "insert_trilinear": insert_trilinear, "shell_sums": shell_sums}
    launches, _ = phase_slice(dev, wrappers)
    torch.cuda.synchronize()

    meta = {
        "project_slices": ("thunder_tpu_torch/csrc/project_slices.cu",
                           "thunder_tpu/ops/projector.py:478"),
        "likelihood_block": ("thunder_tpu_torch/csrc/likelihood_block.cu",
                             "thunder_tpu/optimiser.py:275"),
        "insert_trilinear": ("thunder_tpu_torch/csrc/insert_trilinear.cu",
                             "thunder_tpu/optimiser.py:1400"),
        "shell_sums": ("thunder_tpu_torch/csrc/shell_sums.cu",
                       "thunder_tpu/optimiser.py:379"),
    }
    kernels = [dict(name=name, route="cuda", source=meta[name][0], replaces=meta[name][1],
                    launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], shape=r["shape"])
               for name, r in results.items()]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
