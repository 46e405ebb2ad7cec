"""thunder_postprocess (appsrc/thunder_postprocess.cpp), as
thunder_tpu.cli.postprocess, on one device:

    python -m thunder_tpu_torch.cli.postprocess -a half_A.mrc -b half_B.mrc \
        -m mask.mrc --pixelsize 1.32 [--device cpu]

Writes Postprocess_FSC.txt (shell, resolution, unmasked, masked and true
FSC), Reference_Average.mrc and Reference_Sharp.mrc, and prints the
resolution and the B factor.  Without ``-m`` the mask is generated from
the mean of the halves (physics/mask.py: auto_mask).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thunder_postprocess")
    p.add_argument("-a", required=True, help="half map A")
    p.add_argument("-b", required=True, help="half map B")
    p.add_argument("-m", help="mask MRC (auto-generated if absent)")
    p.add_argument("--pixelsize", type=float, required=True)
    p.add_argument("--out-prefix", default="")
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda': the first CUDA device; 'cpu' runs "
                        "on the CPU)")
    a = p.parse_args(argv)

    from thunder_tpu_torch.device import as_device
    from thunder_tpu_torch.io.mrc import read_mrc, write_mrc
    from thunder_tpu_torch.physics.mask import auto_mask
    from thunder_tpu_torch.postprocess import postprocess

    device = as_device(a.device)        # no card and no --device cpu: raise now
    map_a, _ = read_mrc(a.a)
    map_b, _ = read_mrc(a.b)
    size = map_a.shape[-1]
    if a.m:
        mask, _ = read_mrc(a.m)
    else:
        mask = auto_mask((map_a + map_b) / 2, size // 2 - 2, ext=3.0, ew=6.0)

    res = postprocess(map_a, map_b, mask, a.pixelsize, device=device)

    pre = a.out_prefix
    with open(pre + "Postprocess_FSC.txt", "w") as f:
        for i in range(1, len(res.fsc_true)):
            res_a = size * a.pixelsize / i
            f.write(f"{i:05d} {res_a:10.6f} {res.fsc_unmask[i]:10.6f} "
                    f"{res.fsc_mask[i]:10.6f} {res.fsc_true[i]:10.6f}\n")
    write_mrc(pre + "Reference_Average.mrc", res.map_avg, a.pixelsize)
    write_mrc(pre + "Reference_Sharp.mrc", res.map_sharp, a.pixelsize)
    print(f"resolution: {res.res_angstrom:.2f} A (shell {res.res_shell}), "
          f"B factor: {res.b_factor:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
