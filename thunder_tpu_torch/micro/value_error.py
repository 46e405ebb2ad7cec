"""How far HK3 ``insert_trilinear`` and HK10 ``insert_mkb`` lie from their
plain twins on a few slices, and where: with a defocused CTF, with a flat
one (no defocus, no Cs), at r_u 130 (a 260 px window) and r_u 36 (72 px),
pf 1.  Past ~0.3 per angstrom the float32 phase of a defocused CTF runs to
hundreds of radians, and the kernels' shared value pass
(csrc/slice_values.cuh) and the twins' ``ctf_packed`` round it apart; a
flat CTF leaves the scatters' own error.  Prints a line a case and
kernel: the largest error relative to max |plain| of F and T, the cell's
radius, and whether two calls give the same bits.

    python -m thunder_tpu_torch.micro.value_error

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import numpy as np
import torch

from thunder_tpu_torch.device import generator
from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
from thunder_tpu_torch.ops import insert
from thunder_tpu_torch.physics.ctf import ctf_params


def _ctf(n: int, flat: bool, dev):
    rng = np.random.default_rng(5)
    defocus = np.zeros(n) if flat else rng.uniform(8000, 20000, n)
    return ctf_params(np.full(n, 300e3), defocus, defocus * rng.uniform(0.9, 1.1, n),
                      rng.uniform(0, 3, n), np.full(n, 0.0 if flat else 2e7), np.full(n, 0.1),
                      np.zeros(n), device=dev)


def case(name: str, r_u: int, size: int, big: int, flat: bool, dev, n_s: int = 6) -> None:
    g = generator(37, dev)
    n_img = 2
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_img, size, size, generator=g,
                                                       device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    img = torch.randint(0, n_img, (n_s,), generator=g, device=dev)
    trans = torch.randn(n_s, 2, generator=g, device=dev)
    w = torch.rand(n_s, generator=g, device=dev)
    rot = rotate3d(random_quat(g, (n_s,), dev))
    args = (ft, _ctf(n_img, flat, dev), img, rot, trans, w, r_u, 1, size, 1.32)
    ax = (torch.arange(big, device=dev) - big // 2).double()
    rad = torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2)
    for kname, kern, plain in (("HK10", insert.insert_mkb, insert.insert_mkb_plain),
                               ("HK3", insert.insert_trilinear, insert.insert_trilinear_plain)):
        fk, tk = kern(*args, big)
        fp, tp = plain(*args, torch.zeros((big,) * 3, dtype=torch.complex64, device=dev),
                       torch.zeros((big,) * 3, device=dev))
        df = (torch.view_as_real(fk) - torch.view_as_real(fp)).abs().amax(-1)
        dt = (tk - tp).abs()
        i, j = int(df.argmax()), int(dt.argmax())
        same = torch.equal(fk, kern(*args, big)[0])
        print(f"{name}: {kname}: F {float(df.max() / torch.view_as_real(fp).abs().max()):.3e} "
              f"of max at radius {float(rad.flatten()[i]):.1f}; T "
              f"{float(dt.max() / tp.abs().max()):.3e} at radius {float(rad.flatten()[j]):.1f}; "
              f"two calls the same bits: {same}", flush=True)


def main() -> None:
    dev = torch.device("cuda:0")
    for flat in (False, True):
        ctf = "flat CTF" if flat else "defocused CTF"
        case(f"r_u 130, 260 px, pf 1, {ctf}", 130, 260, 268, flat, dev)
        case(f"r_u 36, 72 px, pf 1, {ctf}", 36, 72, 80, flat, dev)


if __name__ == "__main__":
    main()
