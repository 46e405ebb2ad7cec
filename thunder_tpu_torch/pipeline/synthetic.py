"""Synthetic data made on the device with the port's own projector and
CTF — the forward models of bench.make_dataset and
examples/make_synthetic_demo.py, and the .mrcs / .thu / JSON files the
CLI reads:

* 3D: a phantom (``kind="blobs"``: six wide Gaussian blobs, band-limited
  to ~15 A at 128 px; ``kind="sharp"``: many blobs of about a pixel and a
  few hard-edged balls, with signal out to the band's edge), optionally
  symmetric under a point group (one asymmetric unit summed over the
  group's images of it) and in K species (``truth.npy`` holds each
  image's), CTF-modulated central-slice projections at random poses and
  shifts; the CTFs may be made with every defocus scaled by a factor the
  .thu does not carry (CTF search's target), and a second .thu,
  ``particles_local.thu``, carries the true poses blurred by a standard
  deviation of 2 degrees an axis and 0.5 px (``POSE_BLUR_DEG``,
  ``TRANS_BLUR``), for a run that resumes in local search;
* 2D, K classes (make_synthetic_demo.py:71-113): K templates (bar,
  annulus or disc, each with three texture blobs), each image one
  template at a random in-plane angle and a +-3 px shift, CTF with
  defocus 8000-20000 A; ``truth.npy`` holds each image's template;
  ``kind="sharp"`` gives the templates hard edges and pixel-sized blobs.

Both add unit Gaussian noise with the signal scaled to ``snr`` times its
std per image.

    python -m thunder_tpu_torch.pipeline.synthetic outdir [--mode 3D]
        [--n 1024] [--size 64] [--k 3] [--snr 3.0] [--seed 0] [--device cpu]
        [--kind blobs|sharp] [--sym C4] [--defocus-factor 1.0]
        [--defocus 8000 20000]

The data are made on the card unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from thunder_tpu_torch.device import REAL, as_device, generator
from thunder_tpu_torch.geometry.quaternion import (quat_mul, quat_normalize,
                                                   random_quat, rotate3d)
from thunder_tpu_torch.geometry.symmetry import Symmetry
from thunder_tpu_torch.ops.fourier import fft2_centered, ifft2_centered, translate_ft
from thunder_tpu_torch.ops.projector import prepare_projectee_3d, project_full_3d
from thunder_tpu_torch.physics.ctf import ctf_image, ctf_params

PIXEL_SIZE = 1.32
# standard deviation of the blur of particles_local.thu's poses: degrees
# an axis of the rotation vector, px of each shift
POSE_BLUR_DEG, TRANS_BLUR = 2.0, 0.5


def phantom(size: int, rng: np.random.Generator, kind: str = "blobs",
            sym: str = "C1") -> np.ndarray:
    """A test volume (FFT layout, float32).  ``kind="blobs"``: six
    Gaussian blobs of width size/24 to size/10.  ``kind="sharp"``: 40
    blobs of 0.7 to 1.5 px and three hard-edged balls within 0.3 size of
    the centre, with signal out to the band's edge.  With a point group
    the drawn shapes are one asymmetric unit and the volume is the sum of
    its images under the group's matrices (the centres are turned, so the
    sum is exact)."""
    k = np.arange(size) - size // 2
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    vol = np.zeros((size,) * 3, np.float32)
    mats = Symmetry(sym)._mats
    if kind == "blobs":
        shapes = [(rng.uniform(-size / 6, size / 6, 3),
                   rng.uniform(size / 24, size / 10), 1.0, False) for _ in range(6)]
    elif kind == "sharp":
        def centre():
            o = rng.standard_normal(3)
            return o / np.linalg.norm(o) * size * 0.3 * rng.uniform(0, 1) ** (1 / 3)
        shapes = [(centre(), rng.uniform(0.7, 1.5), rng.uniform(0.5, 1.5), False)
                  for _ in range(40)]
        shapes += [(0.6 * centre(), rng.uniform(size / 16, size / 10), 0.4, True)
                   for _ in range(3)]
    else:
        raise ValueError(f"unknown phantom kind {kind!r}")
    c = size // 2
    for o, s, amp, ball in shapes:
        reach = int(np.ceil(s + 1 if ball else 6 * s + 1))   # exp(-18) beyond: below float32
        for m in mats:
            ox, oy, oz = m @ o
            # the shape's own window of the box
            sl = tuple(slice(max(0, int(np.floor(v)) + c - reach),
                             min(size, int(np.floor(v)) + c + reach + 2)) for v in (oz, oy, ox))
            q = (kx[sl] - ox) ** 2 + (ky[sl] - oy) ** 2 + (kz[sl] - oz) ** 2
            vol[sl] += amp * ((q < s * s) if ball else np.exp(-q / (2 * s * s)))
    return np.fft.ifftshift(vol / len(mats)).astype(np.float32)


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


DEFOCUS_RANGE = (8000.0, 20000.0)


def _ctf_columns(n: int, rng: np.random.Generator,
                 defocus_range: tuple = DEFOCUS_RANGE) -> np.ndarray:
    """CTF columns (7, n) with defocus uniform in ``defocus_range``
    (angstrom; a box of a few tens of pixels needs a few hundred, or its
    CTF turns several periods a shell)."""
    defocus = rng.uniform(*defocus_range, n)
    return np.stack([np.full(n, 300e3), defocus,
                     defocus * rng.uniform(0.9, 1.1, n),
                     rng.uniform(0, np.pi, n), np.full(n, 2.0e7),
                     np.full(n, 0.1), np.zeros(n)])


def templates_2d(size: int, k: int, rng: np.random.Generator,
                 kind: str = "blobs") -> np.ndarray:
    """K class templates, centered layout (make_synthetic_demo.py:71-96):
    a bar of five blobs, an annulus or a disc (by t mod 3), each with
    three texture blobs on top.  ``kind="sharp"``: the base shape cut to
    a hard edge at half its height and twelve more blobs of 0.7 to 1.5
    px, so that the templates carry signal out to the band's edge."""
    if kind not in ("blobs", "sharp"):
        raise ValueError(f"unknown template kind {kind!r}")
    c = size // 2
    kv = np.arange(size) - c
    ky, kx = np.meshgrid(kv, kv, indexing="ij")
    rr = np.hypot(kx, ky)
    out = []
    for t in range(k):
        img = np.zeros((size, size), np.float32)
        if t % 3 == 0:
            for ox in np.linspace(-size / 4, size / 4, 5):
                img += np.exp(-((kx - ox) ** 2 + ky ** 2) / (2 * (size / 16) ** 2))
        elif t % 3 == 1:
            img = np.exp(-((rr - size / 4) ** 2) / (2 * (size / 20) ** 2))
        else:
            img = np.exp(-(rr ** 2) / (2 * (size / 10) ** 2))
        for _ in range(3):
            ox, oy = rng.uniform(-size / 5, size / 5, 2)
            sg = rng.uniform(size / 28, size / 16)
            img = img + 0.6 * np.exp(-((kx - ox) ** 2 + (ky - oy) ** 2) / (2 * sg * sg))
        if kind == "sharp":
            img = img + 0.5 * (img > 0.5 * img.max())
            for _ in range(12):
                ox, oy = rng.uniform(-size / 4, size / 4, 2)
                sg = rng.uniform(0.7, 1.5)
                img = img + rng.uniform(0.5, 1.5) * np.exp(
                    -((kx - ox) ** 2 + (ky - oy) ** 2) / (2 * sg * sg))
        out.append(img.astype(np.float32))
    return np.stack(out)


def rotate_shift(imgs: torch.Tensor, angle_deg: torch.Tensor,
                 shift: torch.Tensor) -> torch.Tensor:
    """Bilinear in-plane rotation about the image centre, then a shift
    (dy, dx) in pixels, zeros outside — scipy.ndimage's rotate(order=1,
    reshape=False) then shift(order=1) on centered images (B, n, n)."""
    b, n = imgs.shape[0], imgs.shape[-1]
    half = (n - 1) / 2
    k = torch.arange(n, dtype=REAL, device=imgs.device) - half
    gy, gx = torch.meshgrid(k, k, indexing="ij")
    th = torch.deg2rad(angle_deg.to(REAL))[:, None, None]
    py = gy - shift[:, 0, None, None]
    px = gx - shift[:, 1, None, None]
    # source of output pixel p: the (row, col) plane turned by theta as
    # scipy turns it, applied to p - shift
    sx = torch.cos(th) * px - torch.sin(th) * py
    sy = torch.sin(th) * px + torch.cos(th) * py
    grid = torch.stack([sx, sy], dim=-1) / half
    return torch.nn.functional.grid_sample(imgs[:, None], grid, mode="bilinear",
                                           padding_mode="zeros",
                                           align_corners=True)[:, 0]


def make_dataset_2d(size: int, n: int, k: int, seed: int = 0,
                    snr: float = 3.0, device=None, chunk: int = 1024,
                    kind: str = "blobs"):
    """The 2D workload: returns (templates (K, n, n) centered, imgs
    (n, size, size) FFT layout, ctf (7, n), truth (n,), angles (n,) in
    degrees, shifts (n, 2) as (dy, dx) pixels) as numpy."""
    dev = as_device(device)
    rng = np.random.default_rng(seed)
    ctf = _ctf_columns(n, rng)
    truth = rng.integers(0, k, n)
    trans = rng.uniform(-3, 3, (n, 2))
    temps = templates_2d(size, k, rng, kind)
    angles = rng.uniform(0, 360, n)
    gen = generator(seed + 11, dev)
    tab = torch.as_tensor(temps, device=dev)
    imgs = np.empty((n, size, size), np.float32)
    for lo in range(0, n, chunk):
        sl = slice(lo, min(n, lo + chunk))
        im = rotate_shift(tab[torch.as_tensor(truth[sl], device=dev)],
                          torch.as_tensor(angles[sl], device=dev),
                          torch.as_tensor(trans[sl], dtype=REAL, device=dev))
        ft = fft2_centered(torch.fft.ifftshift(im, dim=(-2, -1))) * ctf_image(
            ctf_params(*ctf[:, sl], device=dev), size, PIXEL_SIZE)
        im = ifft2_centered(ft)
        std = torch.clamp(im.std(dim=(1, 2), keepdim=True), min=1e-9)
        noise = torch.randn(im.shape, generator=gen, device=dev, dtype=REAL)
        imgs[sl] = (im * snr / std + noise).cpu().numpy()
    return temps, imgs, ctf, truth, angles, trans


def scaled_defocus(ctf: np.ndarray, factor: float) -> np.ndarray:
    """CTF columns with both defocus values scaled by ``factor``."""
    out = np.array(ctf, dtype=np.float64)
    out[1:3] *= factor
    return out


def make_dataset(size: int, n: int, seed: int = 0, snr: float = 3.0,
                 device=None, kind: str = "blobs", sym: str = "C1",
                 defocus_factor: float = 1.0, defocus_range: tuple = DEFOCUS_RANGE,
                 shift: float = 3.0):
    """bench.make_dataset's workload: returns (vol, imgs, ctf (7, n),
    quats (n, 4), trans (n, 2)) as numpy arrays.  The images' CTFs are
    made with the returned defocus values times ``defocus_factor``; the
    shifts are uniform in +-``shift`` px."""
    dev = as_device(device)
    rng = np.random.default_rng(seed)
    vol = phantom(size, rng, kind, sym)
    ctf = _ctf_columns(n, rng, defocus_range)
    quats = random_quat(generator(seed + 7, dev), (n,), dev)
    trans = rng.uniform(-shift, shift, (n, 2))
    imgs = project_images(vol, quats, trans, scaled_defocus(ctf, defocus_factor),
                          snr, rng, dev)
    return vol, imgs, ctf, quats.cpu().numpy(), trans


def blur_poses(quats: np.ndarray, trans: np.ndarray, rot_std_deg: float,
               trans_std: float, rng: np.random.Generator):
    """The poses a run resumed in local search starts from: each rotation
    turned by a small random rotation (a Gaussian rotation vector of
    ``rot_std_deg`` degrees an axis, applied on the left) and each shift
    moved by a Gaussian of ``trans_std`` px.  Returns (quats, trans, k),
    k the ACG concentration of that blur, (std in radians / 2)^2."""
    half = np.radians(rot_std_deg) / 2
    kick = np.concatenate([np.ones((len(quats), 1)),
                           rng.standard_normal((len(quats), 3)) * half], axis=1)
    q = quat_normalize(quat_mul(torch.as_tensor(kick, dtype=REAL),
                                torch.as_tensor(np.asarray(quats), dtype=REAL))).numpy()
    return q, trans + rng.standard_normal(trans.shape) * trans_std, max(half * half, 1e-8)


def write_demo(outdir: str, n: int = 1024, size: int = 64, snr: float = 3.0,
               seed: int = 0, device=None, mode: str = "3D", k: int = 1,
               kind: str = "blobs", sym: str = "C1", defocus_factor: float = 1.0,
               defocus_range: tuple = DEFOCUS_RANGE) -> str:
    """examples/make_synthetic_demo.py (--mode 3D, or --mode 2D with K
    classes): writes particles.mrcs, particles.thu, truth.npy, demo.json
    and, in 3D, init_model.mrc (the phantom; the mean of the K species'
    phantoms) and particles_local.thu (the true poses blurred by
    ``POSE_BLUR_DEG`` degrees an axis and ``TRANS_BLUR`` px, with the
    matching concentrations: what a run with "Global Search" off resumes
    from) under ``outdir``; returns the config path.  ``kind`` and
    ``sym`` choose the phantom (see :func:`phantom`); the images' CTFs are
    made with the .thu's defocus values times ``defocus_factor``."""
    from thunder_tpu_torch.io.mrc import write_mrc
    from thunder_tpu_torch.io.thu import ThuTable, write_thu

    os.makedirs(outdir, exist_ok=True)
    dev = as_device(device)
    mode_2d = mode.upper() == "2D"
    if mode_2d:
        _, imgs, ctf, truth, _, _ = make_dataset_2d(size, n, k, seed, snr, dev,
                                                    kind=kind)
    else:
        rng = np.random.default_rng(seed)
        ctf = _ctf_columns(n, rng, defocus_range)
        trans = rng.uniform(-3, 3, (n, 2))
        vols = [phantom(size, rng, kind, sym) for _ in range(k)]
        truth = rng.integers(0, k, n) if k > 1 else np.zeros(n, np.int64)
        write_mrc(os.path.join(outdir, "init_model.mrc"),
                  np.mean(vols, axis=0).astype(np.float32), PIXEL_SIZE)
        quats = random_quat(generator(seed, dev), (n,), dev)
        ctf_true = scaled_defocus(ctf, defocus_factor)
        imgs = np.empty((n, size, size), np.float32)
        for t_id, vol in enumerate(vols):
            sel = np.nonzero(truth == t_id)[0]
            if len(sel):
                imgs[sel] = project_images(vol, quats[torch.as_tensor(sel, device=dev)],
                                           trans[sel], ctf_true[:, sel], snr, rng, dev)
    write_mrc(os.path.join(outdir, "particles.mrcs"), imgs, PIXEL_SIZE,
              is_stack=True)

    t = ThuTable.blank(n, voltage=300e3)
    t.defocus_u, t.defocus_v, t.defocus_theta = ctf[1], ctf[2], ctf[3]
    t.cs, t.amplitude_contrast = ctf[4], ctf[5]
    t.particle_path = [f"{i + 1:06d}@particles.mrcs" for i in range(n)]
    t.class_id = np.asarray(truth, np.int64)
    write_thu(os.path.join(outdir, "particles.thu"), t)
    if not mode_2d:
        t.quat, t.trans, conc = blur_poses(quats.cpu().numpy(), trans, POSE_BLUR_DEG,
                                           TRANS_BLUR, rng)
        t.k1 = t.k2 = t.k3 = np.full(n, conc)
        t.std_trans = np.full((n, 2), max(TRANS_BLUR, 0.1))
        write_thu(os.path.join(outdir, "particles_local.thu"), t)
    np.save(os.path.join(outdir, "truth.npy"), np.asarray(truth, np.int64))

    config = {
        "Basic": {
            "Number of Threads Per Process": os.cpu_count() or 4,
            "2D or 3D Mode": "2D" if mode_2d else "3D",
            "Global Search": True,
            "Local Search": True,
            "CTF Search": False,
            "Number of Classes": k,
            "Size of Image": size,
            "Pixel Size (Angstrom)": PIXEL_SIZE,
            "Radius of Mask on Images (Angstrom)": size * PIXEL_SIZE / 2 * 0.85,
            "Estimated Translation (Pixel)": 4,
            "Initial Resolution (Angstrom)": size * PIXEL_SIZE / 6,
            "Perform Global Search Under (Angstrom)": size * PIXEL_SIZE / 12,
            "Symmetry": "C1" if mode_2d else sym,
            "Initial Model": ("" if mode_2d
                              else os.path.join(outdir, "init_model.mrc")),
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
    p.add_argument("--mode", default="3D", choices=["2D", "3D"])
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--k", type=int, default=None,
                   help="classes (default 3 in 2D, 1 in 3D: the species of phantoms)")
    p.add_argument("--kind", default="blobs", choices=["blobs", "sharp"],
                   help="phantom / templates: wide blobs, or signal out to the band's edge")
    p.add_argument("--sym", default="C1", help="point group of the 3D phantom")
    p.add_argument("--defocus-factor", type=float, default=1.0,
                   help="the images' defocus over the .thu's (CTF search's target)")
    p.add_argument("--defocus", type=float, nargs=2, default=list(DEFOCUS_RANGE),
                   metavar=("LO", "HI"), help="defocus range of the 3D data, angstrom")
    p.add_argument("--snr", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda'; 'cpu' without a card)")
    a = p.parse_args(argv)
    k = a.k if a.k is not None else (3 if a.mode == "2D" else 1)
    path = write_demo(a.outdir, a.n, a.size, a.snr, a.seed, a.device, mode=a.mode, k=k,
                      kind=a.kind, sym=a.sym, defocus_factor=a.defocus_factor,
                      defocus_range=tuple(a.defocus))
    print(f"wrote {a.outdir}: particles.mrcs, particles.thu, {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
