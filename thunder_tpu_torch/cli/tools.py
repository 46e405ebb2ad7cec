"""Volume and image tools — the reference's small CLI binaries
(appsrc/thunder_{average,minus,lowpass,bfactor,mask,resize,alignZ,view,
genmask,genmask_shell}.cpp), as thunder_tpu.cli.tools.

Each function is importable and takes the device its arithmetic runs
on; the transforms, filters and masks run there.  ``alignz``,
``genmask`` and ``view`` stay host numpy / scipy, as in thunder_tpu
(resampling, morphology, printing).  ``main`` dispatches subcommands:

    python -m thunder_tpu_torch.cli.tools average -i a.mrc b.mrc -o out.mrc [--device cpu]
    python -m thunder_tpu_torch.cli.tools lowpass -i in.mrc -o out.mrc --res 10 --pixelsize 1.32
    ...
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from thunder_tpu_torch.constants import EDGE_WIDTH_FT, EDGE_WIDTH_RL
from thunder_tpu_torch.device import REAL, as_device
from thunder_tpu_torch.io.mrc import read_mrc, write_mrc
from thunder_tpu_torch.ops.fourier import fft3_centered, ifft3_centered, resize_rl
from thunder_tpu_torch.physics.filters import b_factor_filter, low_pass_filter
from thunder_tpu_torch.physics.mask import (_remove_isolated_points, auto_mask,
                                            extend_soft_edge, soft_mask_weight)


def _read(path: str, device) -> tuple:
    v, ps = read_mrc(path)
    return torch.as_tensor(v, dtype=REAL, device=device), ps


def _write(path: str, vol: torch.Tensor, ps: float) -> None:
    write_mrc(path, vol.cpu().numpy(), ps)


def vol_average(paths: list[str], out: str, device=None):
    """thunder_average: mean of volumes."""
    acc, ps = None, 1.0
    for p in paths:
        v, ps = _read(p, device)
        acc = v if acc is None else acc + v
    _write(out, acc / len(paths), ps)


def vol_minus(a: str, b: str, out: str, device=None):
    """thunder_minus: difference of two volumes."""
    va, ps = _read(a, device)
    vb, _ = _read(b, device)
    _write(out, va - vb, ps)


def vol_lowpass(path: str, out: str, res_a: float, pixel_size: float | None = None,
                ew: float = EDGE_WIDTH_FT, device=None):
    """thunder_lowpass: cosine-edge low-pass at a resolution [A]."""
    v, ps = _read(path, device)
    ps = pixel_size or ps
    size = v.shape[-1]
    thres = ps / res_a                          # cycles per pixel
    _write(out, ifft3_centered(low_pass_filter(fft3_centered(v), thres, ew / size)), ps)


def vol_bfactor(path: str, out: str, b_factor: float, device=None):
    """thunder_bfactor: apply a B factor."""
    v, ps = _read(path, device)
    _write(out, ifft3_centered(b_factor_filter(fft3_centered(v), b_factor)), ps)


def vol_mask(path: str, out: str, mask_path: str | None = None,
             radius: float | None = None, ew: float = EDGE_WIDTH_RL, device=None):
    """thunder_mask: multiply by a provided mask or a soft spherical one."""
    v, ps = _read(path, device)
    size = v.shape[-1]
    if mask_path:
        m, _ = _read(mask_path, device)
    else:
        r = radius if radius is not None else size // 2 - ew
        m = soft_mask_weight(size, v.ndim, r, ew, v.device)
    _write(out, v * m, ps)


def vol_resize(path: str, out: str, new_size: int, device=None):
    """thunder_resize: Fourier crop or zero-pad to a new box size."""
    v, ps = _read(path, device)
    size = v.shape[-1]
    _write(out, resize_rl(v, new_size, preserve="values"), ps * size / new_size)


def vol_align_z(path: str, out: str):
    """thunder_alignZ: rotate so that the principal axis of the density
    lies along z (the inertia tensor's dominant eigenvector; host)."""
    from scipy.ndimage import affine_transform

    v, ps = read_mrc(path)
    size = v.shape[-1]
    vc = np.fft.fftshift(v)
    c = size // 2
    k = np.arange(size) - c
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    w = np.maximum(vc, 0)
    tot = w.sum() or 1.0
    coords = [kx, ky, kz]
    cov = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            cov[i, j] = (w * coords[i] * coords[j]).sum() / tot
    _, evecs = np.linalg.eigh(cov)
    axis = evecs[:, -1]
    if axis[2] < 0:
        axis = -axis
    z = np.array([0.0, 0.0, 1.0])
    vv = np.cross(axis, z)
    s = np.linalg.norm(vv)
    if s < 1e-8:
        rot = np.eye(3)
    else:
        cth = float(np.dot(axis, z))
        vx = np.array([[0, -vv[2], vv[1]], [vv[2], 0, -vv[0]], [-vv[1], vv[0], 0]])
        rot = np.eye(3) + vx + vx @ vx * ((1 - cth) / s ** 2)
    # resample: output voxel (x, y, z) pulls from rot^T (x, y, z)
    mat = rot.T[::-1, ::-1]                     # (z, y, x) index convention
    off = np.array([c, c, c]) - mat @ np.array([c, c, c])
    out_v = affine_transform(vc, mat, offset=off, order=1)
    write_mrc(out, np.fft.ifftshift(out_v), ps)


def vol_view(path: str):
    """thunder_view: header statistics and an ASCII preview of the
    central slice."""
    v, ps = read_mrc(path)
    print(f"{path}: shape={v.shape} pixel_size={ps:.4f}")
    print(f"min={v.min():.4g} max={v.max():.4g} mean={v.mean():.4g} std={v.std():.4g}")
    vc = np.fft.fftshift(v)
    sl = vc[vc.shape[0] // 2] if v.ndim == 3 else vc
    step = max(1, sl.shape[0] // 32)
    small = sl[::step, ::step]
    lo, hi = small.min(), small.max()
    chars = " .:-=+*#%@"
    for row in small:
        print("".join(chars[int((x - lo) / (hi - lo + 1e-12) * 9)] for x in row))


def gen_mask(path: str, out: str, thres: float | None = None,
             ext: float = 2.0, ew: float = 4.0, radius: float | None = None):
    """thunder_genmask: mask from a volume, at a given threshold or the
    auto-mask's (host)."""
    v, ps = read_mrc(path)
    size = v.shape[-1]
    r = radius if radius is not None else size // 2 - 2
    if thres is not None:
        m = _remove_isolated_points(np.fft.fftshift((v > thres).astype(np.float32)))
        m = np.fft.ifftshift(extend_soft_edge(m, max(ext, 0.0), ew))
    else:
        m = auto_mask(v, r, ext, ew)
    write_mrc(out, m, ps)


def gen_mask_shell(out: str, size: int, r_in: float, r_out: float,
                   ew: float = EDGE_WIDTH_RL, pixel_size: float = 1.0, device=None):
    """thunder_genmask_shell: soft spherical-shell mask."""
    outer = soft_mask_weight(size, 3, r_out, ew, device)
    inner = soft_mask_weight(size, 3, max(r_in - ew, 0), ew, device)
    _write(out, (outer - inner).clamp(0, 1), pixel_size)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thunder_tools")
    dev_arg = argparse.ArgumentParser(add_help=False)
    dev_arg.add_argument("--device", default="cuda",
                         help="torch device (default 'cuda': the first CUDA device; 'cpu' "
                              "runs on the CPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name):
        return sub.add_parser(name, parents=[dev_arg])

    s = add("average"); s.add_argument("-i", nargs="+", required=True); s.add_argument("-o", required=True)
    s = add("minus"); s.add_argument("-a", required=True); s.add_argument("-b", required=True); s.add_argument("-o", required=True)
    s = add("lowpass"); s.add_argument("-i", required=True); s.add_argument("-o", required=True); s.add_argument("--res", type=float, required=True); s.add_argument("--pixelsize", type=float)
    s = add("bfactor"); s.add_argument("-i", required=True); s.add_argument("-o", required=True); s.add_argument("--bfactor", type=float, required=True)
    s = add("mask"); s.add_argument("-i", required=True); s.add_argument("-o", required=True); s.add_argument("--mask"); s.add_argument("--radius", type=float)
    s = add("resize"); s.add_argument("-i", required=True); s.add_argument("-o", required=True); s.add_argument("--size", type=int, required=True)
    s = add("alignz"); s.add_argument("-i", required=True); s.add_argument("-o", required=True)
    s = add("view"); s.add_argument("-i", required=True)
    s = add("genmask"); s.add_argument("-i", required=True); s.add_argument("-o", required=True); s.add_argument("--thres", type=float); s.add_argument("--ext", type=float, default=2.0); s.add_argument("--ew", type=float, default=4.0); s.add_argument("--radius", type=float)
    s = add("genmask_shell"); s.add_argument("-o", required=True); s.add_argument("--size", type=int, required=True); s.add_argument("--rin", type=float, required=True); s.add_argument("--rout", type=float, required=True); s.add_argument("--pixelsize", type=float, default=1.0)

    a = p.parse_args(argv)
    dev = as_device(a.device)           # no card and no --device cpu: raise now
    if a.cmd == "average":
        vol_average(a.i, a.o, device=dev)
    elif a.cmd == "minus":
        vol_minus(a.a, a.b, a.o, device=dev)
    elif a.cmd == "lowpass":
        vol_lowpass(a.i, a.o, a.res, a.pixelsize, device=dev)
    elif a.cmd == "bfactor":
        vol_bfactor(a.i, a.o, a.bfactor, device=dev)
    elif a.cmd == "mask":
        vol_mask(a.i, a.o, a.mask, a.radius, device=dev)
    elif a.cmd == "resize":
        vol_resize(a.i, a.o, a.size, device=dev)
    elif a.cmd == "alignz":
        vol_align_z(a.i, a.o)
    elif a.cmd == "view":
        vol_view(a.i)
    elif a.cmd == "genmask":
        gen_mask(a.i, a.o, a.thres, a.ext, a.ew, a.radius)
    elif a.cmd == "genmask_shell":
        gen_mask_shell(a.o, a.size, a.rin, a.rout, pixel_size=a.pixelsize, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
