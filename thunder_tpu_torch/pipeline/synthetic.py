"""Synthetic 3D-refinement data made with the port's own projector and
CTF — the forward model of bench.make_dataset and
examples/make_synthetic_demo.py (3D, one class, symmetry C1):
a multi-blob phantom, CTF-modulated central-slice projections at random
poses and shifts, Gaussian noise at a given SNR, and the .mrcs / .thu /
JSON files the CLI reads.

    python -m thunder_tpu_torch.pipeline.synthetic outdir [--n 1024]
        [--size 64] [--snr 3.0] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from thunder_tpu_torch.device import as_device, generator
from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
from thunder_tpu_torch.ops.fourier import ifft2_centered, translate_ft
from thunder_tpu_torch.ops.projector import prepare_projectee_3d, project_full_3d
from thunder_tpu_torch.physics.ctf import ctf_image, ctf_params

PIXEL_SIZE = 1.32


def phantom(size: int, rng: np.random.Generator) -> np.ndarray:
    """Six Gaussian blobs (FFT layout, float32)."""
    k = np.arange(size) - size // 2
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    vol = np.zeros((size,) * 3, np.float32)
    for _ in range(6):
        o = rng.uniform(-size / 6, size / 6, 3)
        s = rng.uniform(size / 24, size / 10)
        vol += np.exp(-(((kx - o[0]) ** 2 + (ky - o[1]) ** 2
                         + (kz - o[2]) ** 2) / (2 * s * s)))
    return np.fft.ifftshift(vol).astype(np.float32)


def project_images(vol: np.ndarray, quats: torch.Tensor, trans: np.ndarray,
                   ctf: np.ndarray, snr: float, rng: np.random.Generator,
                   device) -> np.ndarray:
    """CTF-modulated, shifted projections plus unit Gaussian noise, the
    signal scaled to ``snr`` times the noise std per image."""
    size = vol.shape[-1]
    proj = prepare_projectee_3d(torch.as_tensor(vol, device=device), 2)
    ft = translate_ft(project_full_3d(proj, rotate3d(quats)), trans)
    ft = ft * ctf_image(ctf_params(*ctf, device=device), size, PIXEL_SIZE)
    im = ifft2_centered(ft).cpu().numpy()
    std = np.maximum(im.std(axis=(1, 2), keepdims=True), 1e-9)
    noise = rng.standard_normal(im.shape)
    return (im * snr / std + noise).astype(np.float32)


def _ctf_columns(n: int, rng: np.random.Generator) -> np.ndarray:
    defocus = rng.uniform(8000, 20000, n)
    return np.stack([np.full(n, 300e3), defocus,
                     defocus * rng.uniform(0.9, 1.1, n),
                     rng.uniform(0, np.pi, n), np.full(n, 2.0e7),
                     np.full(n, 0.1), np.zeros(n)])


def make_dataset(size: int, n: int, seed: int = 0, snr: float = 3.0,
                 device=None):
    """bench.make_dataset's workload: returns (vol, imgs, ctf (7, n),
    quats (n, 4), trans (n, 2)) as numpy arrays."""
    dev = as_device(device)
    rng = np.random.default_rng(seed)
    vol = phantom(size, rng)
    ctf = _ctf_columns(n, rng)
    quats = random_quat(generator(seed + 7, dev), (n,), dev)
    trans = rng.uniform(-3, 3, (n, 2))
    imgs = project_images(vol, quats, trans, ctf, snr, rng, dev)
    return vol, imgs, ctf, quats.cpu().numpy(), trans


def write_demo(outdir: str, n: int = 1024, size: int = 64, snr: float = 3.0,
               seed: int = 0, device=None) -> str:
    """examples/make_synthetic_demo.py --mode 3D --k 1: writes
    particles.mrcs, particles.thu, init_model.mrc (the phantom), truth.npy
    and demo.json under ``outdir``; returns the config path."""
    from thunder_tpu.io.mrc import write_mrc
    from thunder_tpu.io.thu import ThuTable, write_thu

    os.makedirs(outdir, exist_ok=True)
    dev = as_device(device)
    rng = np.random.default_rng(seed)
    ctf = _ctf_columns(n, rng)
    trans = rng.uniform(-3, 3, (n, 2))
    vol = phantom(size, rng)
    write_mrc(os.path.join(outdir, "init_model.mrc"), vol, PIXEL_SIZE)
    quats = random_quat(generator(seed, dev), (n,), dev)
    imgs = project_images(vol, quats, trans, ctf, snr, rng, dev)
    write_mrc(os.path.join(outdir, "particles.mrcs"), imgs, PIXEL_SIZE,
              is_stack=True)

    t = ThuTable.blank(n, voltage=300e3)
    t.defocus_u, t.defocus_v, t.defocus_theta = ctf[1], ctf[2], ctf[3]
    t.cs, t.amplitude_contrast = ctf[4], ctf[5]
    t.particle_path = [f"{i + 1:06d}@particles.mrcs" for i in range(n)]
    t.class_id = np.zeros(n, np.int64)
    write_thu(os.path.join(outdir, "particles.thu"), t)
    np.save(os.path.join(outdir, "truth.npy"), np.zeros(n, np.int64))

    config = {
        "Basic": {
            "Number of Threads Per Process": os.cpu_count() or 4,
            "2D or 3D Mode": "3D",
            "Global Search": True,
            "Local Search": True,
            "CTF Search": False,
            "Number of Classes": 1,
            "Size of Image": size,
            "Pixel Size (Angstrom)": PIXEL_SIZE,
            "Radius of Mask on Images (Angstrom)": size * PIXEL_SIZE / 2 * 0.85,
            "Estimated Translation (Pixel)": 4,
            "Initial Resolution (Angstrom)": size * PIXEL_SIZE / 6,
            "Perform Global Search Under (Angstrom)": size * PIXEL_SIZE / 12,
            "Symmetry": "C1",
            "Initial Model": os.path.join(outdir, "init_model.mrc"),
            ".thu File Storing Paths and CTFs of Images":
                os.path.join(outdir, "particles.thu"),
            "Path of Particles": outdir + "/",
            "Path of Output": os.path.join(outdir, "output") + "/",
            "Prefix of Output": "",
            "Calculate FSC Using Core Region": False,
            "Calculate FSC Using Masked Region": False,
            "Particle Grading": False,
            "Auto-Recentre Reference": True,
        },
        "Reference Mask": {
            "Perform Reference Mask": False,
            "Perform Reference Mask During Global Search": False,
            "Provided Mask": "",
        },
        "Subtract": {
            "Subtract Masked Region Reference From Images": False,
            "Region Need to Be Centred": "",
        },
        "Advanced": {
            "Max Number of Iteration": 20,
            "Using Golden Standard FSC": True,
            "Padding Factor": 2,
            "MKB Kernel Radius": 1.9,
            "MKB Kernel Smooth Factor": 15.0,
            "Number of Sampling Points for Scanning in Global Search (2D)": 100,
            "Number of Sampling Points for Scanning in Global Search (3D)": 4096,
            "Number of Sampling Points of Rotation in Local Search (2D)": 9,
            "Number of Sampling Points of Rotation in Local Search (3D)": 64,
            "Number of Sampling Points of Translation in Local Search": 9,
            "Number of Sampling Points of Defocus in Local Search": 9,
            "Number of Sampling Points Used in Reconstruction": 50,
            "Ignore Signal Under (Angstrom)": size * PIXEL_SIZE,
            "Correct Intensity Scale Using Signal Under (Angstrom)": 40.0,
            "FSC Threshold for Cutoff Frequency": 0.143,
            "FSC Threshold for Reporting Resolution": 0.143,
            "FSC Threshold for Scale Correction": 0.75,
            "Grouping when Calculating Sigma": True,
            "Grouping when Correcting Intensity Scale": False,
            "Mask Images with Zero Noise": True,
            "CTF Refine Standard Deviation": 0.01,
            "Save Reference(s) Each Iteration": True,
            "Save .thu File Each Iteration": True,
        },
        "Professional": {
            "Translation Search Factor": 0.25,
            "Perturbation Factor (Large)": 0.8,
            "Perturbation Factor (Small, Global)": 0.8,
            "Perturbation Factor (Small, Local)": 0.8,
            "Perturbation Factor (Small, CTF)": 0.8,
            "Skip Expectation": False,
            "Skip Maximization": False,
            "Skip Reconstruction": False,
        },
    }
    path = os.path.join(outdir, "demo.json")
    with open(path, "w") as f:
        json.dump(config, f, indent=2)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="synthetic")
    p.add_argument("outdir", nargs="?", default="./synthetic_demo")
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--snr", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    path = write_demo(a.outdir, a.n, a.size, a.snr, a.seed)
    print(f"wrote {a.outdir}: particles.mrcs, particles.thu, {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
