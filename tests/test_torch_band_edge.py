"""The band edge of MAP-free gridding, in both packages: thunder_tpu's
``reconstruct`` CLI and the port's on the same stack and the same poses
(the sharp C4 phantom of ``pipeline/synthetic.write_demo``, C4 with the
CTF), at the true poses and at true poses blurred by 0.5 degrees an axis
with a few seeds.  For each pose set: each map's FSC-0.5 crossing
against the phantom, its curve over the top shells, and the mean T and
W (``balance_weights``) by padded shell near the edge, where insertion
fills |k| < (r_u - 1) pf and the balance treats |k| < r_u pf.

The test holds the two packages' crossings to one another at a small
size.  Run as a script for the numbers at a larger one:

    python tests/test_torch_band_edge.py [--size 128] [--n 1024] [--snr 8]
"""

import argparse
import contextlib
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from thunder_tpu.cli import reconstruct as jreconstruct  # noqa: E402
from thunder_tpu.recon import reconstructor as jrc  # noqa: E402
from thunder_tpu_torch.cli import reconstruct as treconstruct  # noqa: E402
from thunder_tpu_torch.device import generator  # noqa: E402
from thunder_tpu_torch.geometry.quaternion import random_quat  # noqa: E402
from thunder_tpu_torch.io.mrc import read_mrc  # noqa: E402
from thunder_tpu_torch.io.thu import read_thu, write_thu  # noqa: E402
from thunder_tpu_torch.ops.fourier import fft3_centered  # noqa: E402
from thunder_tpu_torch.physics import spectrum  # noqa: E402
from thunder_tpu_torch.pipeline import synthetic  # noqa: E402
from thunder_tpu_torch.recon import reconstructor as trc  # noqa: E402

PIXEL_SIZE, SEED = 1.32, 0


@contextlib.contextmanager
def captured_grids(module, store: dict):
    """Keep the (F, T) grids that ``module.reconstruct`` is called with."""
    original = module.reconstruct

    def keep(f_grid, t_grid, *args, **kwargs):
        store["f"], store["t"] = f_grid, t_grid
        return original(f_grid, t_grid, *args, **kwargs)

    module.reconstruct = keep
    try:
        yield
    finally:
        module.reconstruct = original


def padded_shell_means(grid: np.ndarray, first: int) -> np.ndarray:
    """Mean of a centered grid over each padded shell from ``first`` to
    big / 2 - 1 (shell = |k| rounded)."""
    big = grid.shape[-1]
    k = np.arange(big) - big // 2
    r = np.sqrt(k[:, None, None] ** 2 + k[None, :, None] ** 2 + k[None, None, :] ** 2)
    u = np.rint(r).astype(np.int64).ravel()
    s = np.bincount(u, np.asarray(grid, np.float64).ravel(), minlength=big)
    n = np.bincount(u, minlength=big)
    return (s / np.maximum(n, 1))[first:big // 2]


def pose_sets(tmp: str, n: int, blurs: int) -> list:
    """(name, quats, trans): the generator's true poses, then ``blurs``
    draws of them blurred by 0.5 degrees an axis and 0.1 px."""
    quats = random_quat(generator(SEED, "cpu"), (n,), "cpu").numpy()
    rng = np.random.default_rng(SEED)        # write_demo's draws, in its order
    synthetic._ctf_columns(n, rng, synthetic.DEFOCUS_RANGE)
    trans = rng.uniform(-3, 3, (n, 2))
    sets = [("true poses", quats, trans)]
    for s in range(blurs):
        q, t, _ = synthetic.blur_poses(quats, trans, 0.5, 0.1, np.random.default_rng(100 + s))
        sets.append((f"blurred 0.5 deg, draw {s}", q, t))
    return sets


def witness(tmp: str, size: int, n: int, snr: float, blurs: int) -> list:
    """Both packages' reconstruct on each pose set; a dict a set."""
    synthetic.write_demo(tmp, n=n, size=size, snr=snr, seed=SEED, device="cpu",
                         kind="sharp", sym="C4")
    truth = torch.as_tensor(read_mrc(os.path.join(tmp, "init_model.mrc"))[0])
    thu = read_thu(os.path.join(tmp, "particles_local.thu"))
    pf, r_u = 2, size // 2 - 2
    out = []
    for name, q, t in pose_sets(tmp, n, blurs):
        thu.quat, thu.trans = np.asarray(q, np.float64), np.asarray(t, np.float64)
        thu_path = os.path.join(tmp, "poses.thu")
        write_thu(thu_path, thu)
        argv = ["--thu", thu_path, "--size", str(size), "--pixelsize", str(PIXEL_SIZE),
                "--prefix", tmp + "/", "--sym", "C4"]
        rec = {"name": name}
        for tag, cli, module, extra in (("thunder_tpu", jreconstruct, jrc, []),
                                        ("port", treconstruct, trc, ["--device", "cpu"])):
            grids, path = {}, os.path.join(tmp, f"{tag}.mrc")
            with captured_grids(module, grids):
                cli.main(argv + ["-o", path] + extra)
            vol = torch.as_tensor(read_mrc(path)[0])
            curve = spectrum.fsc(fft3_centered(vol), fft3_centered(truth), size // 2 - 2).numpy()
            t_grid = np.real(np.asarray(grids["t"]))
            if tag == "port":
                w = trc.balance_weights(torch.as_tensor(t_grid), pf, r_u,
                                        guard_empty=True).numpy()
            else:
                w = np.asarray(jrc.balance_weights(jax.numpy.asarray(t_grid), pf, r_u))
            first = 2 * (r_u - 4)
            rec[tag] = {"crossing": spectrum.res_p(curve, 0.5), "curve": curve,
                        "t": padded_shell_means(t_grid, first),
                        "w": padded_shell_means(w, first), "first": first}
        out.append(rec)
    return out


def report(recs: list, size: int) -> None:
    r_u = size // 2 - 2
    print(f"{size} px, r_u {r_u}: insertion fills padded |k| < {2 * (r_u - 1)}, the balance "
          f"treats |k| < {2 * r_u}")
    for rec in recs:
        print(rec["name"])
        for tag in ("thunder_tpu", "port"):
            m, top = rec[tag], max(1, size // 2 - 18)
            print(f"  {tag:11s} FSC-0.5 crossing against the phantom: shell {m['crossing']}; "
                  f"FSC at shells {top}-{len(m['curve']) - 1}:",
                  " ".join(f"{x:.2f}" for x in m["curve"][top:]))
            print(f"  {tag:11s} mean T by padded shell {m['first']}-{2 * r_u + 3}:",
                  " ".join(f"{x:.3g}" for x in m["t"][:2 * r_u + 4 - m["first"]]))
            print(f"  {tag:11s} mean W by padded shell {m['first']}-{2 * r_u + 3}:",
                  " ".join(f"{x:.3g}" for x in m["w"][:2 * r_u + 4 - m["first"]]))


def test_reconstruct_band_edge_matches_thunder_tpu(tmp_path):
    """At 48 px (512 images, SNR 8), at the true poses and at two
    blurred pose sets: the port's reconstruct crosses FSC 0.5 against the
    phantom within one shell of thunder_tpu's; W agrees within 1e-2
    relative inside insertion's radius; and in both packages W in the
    ring between insertion's and the balance's radius is more than 100
    times the largest W inside (measured: 620 to 1.9e6 times)."""
    size = 48
    recs = witness(str(tmp_path), size, 512, 8.0, 2)
    report(recs, size)
    r_u = size // 2 - 2
    for rec in recs:
        j, t = rec["thunder_tpu"], rec["port"]
        assert abs(j["crossing"] - t["crossing"]) <= 1, rec["name"]
        ring = 2 * (r_u - 1) - j["first"]          # the first padded shell of the ring
        np.testing.assert_allclose(t["w"][:ring], j["w"][:ring], rtol=1e-2,
                                   err_msg=rec["name"])
        for m in (j, t):
            assert m["w"][ring:ring + 2].min() > 100 * m["w"][:ring].max(), rec["name"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--snr", type=float, default=8.0)
    p.add_argument("--blurs", type=int, default=3)
    a = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="band_edge_") as tmp:
        report(witness(tmp, a.size, a.n, a.snr, a.blurs), a.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
