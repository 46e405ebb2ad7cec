"""Local search inside whole rounds, in both packages on the same
images: on the sharp phantom at 32 px (signal out to the band's edge) the
resolution band r grows to r_global, the state machine
(update_search_type) enters SEARCH_TYPE_LOCAL, and local rounds (image
re-centring, re-masking, norm correction) push r past r_global, within
ten rounds.  The blob phantom, whose spectrum ends near a third of the
band, is the generator's default and is what the earlier cells keep.

Run as a script for whole runs, each package's shells and search types
a round and whether it reached local search:

    python tests/test_torch_local_search.py [--seeds 0 1 2] [--jax]

(without ``--seeds``: the config's seed, the tests' run).  ``--balance``
runs the port's balance loop as it is (``float64``, the default) or
another way, and prints its stop counts a call: ``float32`` (thunder_tpu's
precision), ``float32-at-float64-count`` (float32, for the count the
float64 loop stops at) or ``float32-reached-stop`` (float32, the stop's
change read only over cells with T above the floor).
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402
from thunder_tpu_torch.model import SEARCH_TYPE_GLOBAL, SEARCH_TYPE_LOCAL  # noqa: E402
from thunder_tpu_torch.physics.mask import radial_grid  # noqa: E402
from thunder_tpu_torch.pipeline.synthetic import make_dataset, phantom  # noqa: E402

SIZE, N, MAX_ROUNDS = 32, 128, 10


def shell_power(vol):
    """Mean |F|^2 of each Fourier shell of an FFT-layout volume."""
    u = np.round(radial_grid(vol.shape[-1], 3)).astype(int).ravel()
    p = np.abs(np.fft.fftn(vol)).ravel() ** 2
    return np.bincount(u, p) / np.bincount(u)


def test_sharp_phantom_carries_signal_to_the_band_edge():
    """At the last shell of the band the sharp phantom keeps over a
    thousand times the blob phantom's share of its power, and the
    generator's default (the blobs) is the volume it always was."""
    blobs = shell_power(phantom(SIZE, np.random.default_rng(0)))
    sharp = shell_power(phantom(SIZE, np.random.default_rng(0), "sharp"))
    edge = SIZE // 2 - 2
    assert sharp[edge] / sharp[0] > 1e3 * blobs[edge] / blobs[0]
    k = np.arange(SIZE) - SIZE // 2
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    rng = np.random.default_rng(5)
    vol = np.zeros((SIZE,) * 3, np.float32)
    for _ in range(6):
        o = rng.uniform(-SIZE / 6, SIZE / 6, 3)
        s = rng.uniform(SIZE / 24, SIZE / 10)
        vol += np.exp(-(((kx - o[0]) ** 2 + (ky - o[1]) ** 2 + (kz - o[2]) ** 2) / (2 * s * s)))
    np.testing.assert_allclose(phantom(SIZE, np.random.default_rng(5)),
                               np.fft.ifftshift(vol), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sym", ["C1", "C4", "D2"])
def test_symmetric_phantom_is_invariant_under_its_group(sym):
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.recon.reconstructor import symmetrize_ft_plain

    vol = phantom(24, np.random.default_rng(1), "sharp", sym)
    mats = Symmetry(sym).matrices
    f = torch.fft.fftshift(torch.fft.fftn(torch.as_tensor(vol))).to(torch.complex64)
    summed, _ = symmetrize_ft_plain(f, f.abs(), mats, 9.0)
    k = np.arange(24) - 12
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    inside = kx ** 2 + ky ** 2 + kz ** 2 < 81
    a, b = (summed / mats.shape[0]).numpy()[inside], f.numpy()[inside]
    # Cn and D2 about the axes map the grid onto itself: the sum over the
    # group returns the spectrum itself
    assert np.abs(a - b).max() <= 2e-4 * np.abs(b).max()


def optimisers(names=("jax", "port"), **extra):
    """Each named package's Optimiser from the same start on the same 128
    images (``extra``: further ThunderConfig fields, as a config seed)."""
    vol, imgs, ctf, _, _ = make_dataset(SIZE, N, seed=1, snr=6.0, device="cpu", kind="sharp",
                                        defocus_range=(400.0, 800.0), shift=1.0)
    kw = dict(mode="3D", k=1, size=SIZE, pixel_size=1.32, mask_radius=SIZE * 1.32 * 0.42,
              trans_s=1.0, init_res=SIZE * 1.32 / 9, global_search_res=SIZE * 1.32 / 7,
              sym="C1", m_s=1024, m_l_r=24, m_l_t=9, m_reco=12, ignore_res=SIZE * 1.32,
              trans_search_factor=1.0, **extra)
    make = {"jax": lambda: jo.Optimiser(JConfig(**kw), imgs, jctf_params(*ctf),
                                        np.zeros(N, np.int64), init_refs=vol),
            "port": lambda: to.Optimiser(TConfig(**kw), imgs, tuple(ctf), np.zeros(N, np.int64),
                                         init_refs=vol, device="cpu")}
    return {name: make[name]() for name in names}


def run_until_past_r_global(opt) -> list:
    """Rounds until r passes r_global, at most MAX_ROUNDS; the records."""
    recs = []
    for i in range(MAX_ROUNDS):
        recs.append(opt.run_round(i))
        if recs[-1]["r"] > opt.model.r_global:
            break
    return recs


@pytest.fixture(scope="module")
def runs():
    """Both packages from the same start on the same 128 images until
    each has raised r past r_global, at most MAX_ROUNDS rounds."""
    return {name: (opt, run_until_past_r_global(opt))
            for name, opt in optimisers().items()}


@pytest.mark.parametrize("name", ["jax", "port"])
def test_both_packages_reach_local_search(runs, name):
    opt, recs = runs[name]
    r_global = opt.model.r_global
    assert recs[0]["search_type"] == SEARCH_TYPE_GLOBAL and recs[0]["r"] < r_global
    local = [r for r in recs if r["search_type"] == SEARCH_TYPE_LOCAL]
    assert local, [(r["r"], r["search_type"]) for r in recs]
    assert max(r["r"] for r in recs) > r_global
    assert all(np.isfinite(r["res_A"]) for r in recs)
    # a local round runs fewer phases than a global one
    # (MIN_N_PHASE_PER_ITER_LOCAL 3 against 10)
    assert min(min(r["n_phases"]) for r in local) < 10


def test_local_rounds_recentre_and_rescale_the_images(runs):
    """What runs for the first time inside a port round: re_centre_img
    folds the rank-1 shifts into the offsets, _refresh_masked rebuilds
    the masked spectra from them, and norm correction rescales images;
    the port's offsets and norms end near thunder_tpu's."""
    (jopt, _), (topt, _) = runs["jax"], runs["port"]
    off_t = topt.offset.numpy()[topt.valid]
    off_j = np.asarray(jopt.offset)[jopt.valid]
    assert np.abs(off_t).max() > 0.1 and np.isfinite(off_t).all()
    # the data's shifts are uniform in +-1 px: both packages' offsets are
    # minus those shifts up to the pose noise
    assert abs(np.std(off_t) - np.std(off_j)) < 0.15
    assert np.isfinite(topt.data.ft_masked.abs().numpy()).all()
    assert np.allclose(topt.state.par.top_t.numpy(), 0.0)
    # the port's final map agrees with thunder_tpu's over the masked ball
    m = radial_grid(SIZE, 3) < SIZE * 0.3
    a = topt.state.refs.numpy().mean(0)[0][m]
    b = np.asarray(jopt.state.refs).mean(0)[0][m]
    assert np.corrcoef(a, b)[0, 1] > 0.9


def balance_variant(kind: str, counts: list):
    """A stand-in for the port's balance loop ``_balance`` (see the
    module's docstring) that appends each call's stop counts to
    ``counts``."""
    from thunder_tpu_torch.constants import (C_ABS_MIN, DIFF_C_DECREASE_THRES, DIFF_C_THRES,
                                             MAX_N_ITER_BALANCE, MIN_N_ITER_BALANCE,
                                             N_DIFF_C_NO_DECREASE, T_MIN)
    from thunder_tpu_torch.recon import reconstructor as rc

    loop, double = rc._balance, (rc.BALANCE_REAL, rc.BALANCE_COMPLEX)

    def in_float32(*args):
        rc.BALANCE_REAL, rc.BALANCE_COMPLEX = torch.float32, torch.complex64
        try:
            return loop(*args)
        finally:
            rc.BALANCE_REAL, rc.BALANCE_COMPLEX = double

    def reached_stop(t_grid, pf, max_radius, a, alpha, nd):
        # the port's loop in float32, its change read only where T > T_MIN
        big, ax = t_grid.shape[-1], rc._ax(nd)
        window = rc._mkb_window(big, a, alpha, t_grid.device, nd)
        half = lambda x: torch.fft.ifftshift(x, dim=ax)[..., :big // 2 + 1]
        inside = half(rc._quad_inside(big, max_radius * pf, t_grid.device, nd))
        t_half = half(torch.clamp(t_grid, min=T_MIN))
        read = inside & (t_half > T_MIN)
        lanes = t_grid.shape[:-nd]
        w = torch.where(inside, 1.0, 0.0).expand(t_half.shape).clone()
        diff_prev = torch.full(lanes, float(np.finfo(np.float32).max))
        n_no_dec = torch.zeros(lanes, dtype=torch.int64)
        it = torch.zeros(lanes, dtype=torch.int64)
        active = torch.ones(lanes, dtype=torch.bool)
        while bool(active.any()):
            c_rl = torch.fft.irfftn((t_half * w).to(torch.complex64), s=(big,) * nd, dim=ax)
            c_abs = torch.fft.rfftn(c_rl * window, dim=ax).abs()
            w_new = torch.where(inside, w / torch.clamp(c_abs, min=C_ABS_MIN), w)
            diff = torch.amax(torch.where(read, (c_abs - 1.0).abs(), 0.0), dim=ax)
            nnd = torch.where(diff > diff_prev * DIFF_C_DECREASE_THRES, n_no_dec + 1, 0)
            w = torch.where(active.reshape(lanes + (1,) * nd), w_new, w)
            diff_prev = torch.where(active, diff, diff_prev)
            n_no_dec = torch.where(active, nnd, n_no_dec)
            it = it + active.long()
            active = (active & (it < MAX_N_ITER_BALANCE) & (diff_prev >= DIFF_C_THRES)
                      & ((it < MIN_N_ITER_BALANCE) | (n_no_dec < N_DIFF_C_NO_DECREASE)))
        return rc._mirror_full(w, big, nd), it

    def balance(t_grid, pf, max_radius, a, alpha, nd, guard_empty=False, n_iter=None,
                each=None):
        args = (pf, max_radius, a, alpha, nd, guard_empty)
        if kind == "float64":
            w, it = loop(t_grid, *args, n_iter, each)
        elif kind == "float32":
            w, it = in_float32(t_grid, *args, n_iter, each)
        elif kind == "float32-at-float64-count":
            it = loop(t_grid, *args)[1]
            lanes = t_grid.reshape((-1,) + t_grid.shape[-nd:])
            w = torch.stack([in_float32(g, *args, int(n))[0]
                             for g, n in zip(lanes, it.reshape(-1))]).reshape(t_grid.shape)
        else:
            w, it = reached_stop(t_grid, pf, max_radius, a, alpha, nd)
        counts.append(it.reshape(-1).tolist())
        return w, it
    return balance


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[None],
                   help="config seeds (default: the config's, the tests' run)")
    p.add_argument("--jax", action="store_true", help="thunder_tpu's runs too")
    p.add_argument("--balance", choices=("float64", "float32", "float32-at-float64-count",
                                         "float32-reached-stop"), default="float64")
    a = p.parse_args(argv)
    names = ("jax", "port") if a.jax else ("port",)
    counts = []
    from thunder_tpu_torch.recon import reconstructor as rc

    rc._balance = balance_variant(a.balance, counts)
    for seed in a.seeds:
        for name, opt in optimisers(names, **({} if seed is None else dict(seed=seed))).items():
            recs = run_until_past_r_global(opt)
            local = any(r["search_type"] == SEARCH_TYPE_LOCAL for r in recs)
            print(f"seed {seed} {name:4s}: {'reaches' if local else 'misses'} local search; "
                  "r / shell / search type a round: "
                  + " ".join(f"{r['r']}/{r['res_shell']}/{r['search_type']}" for r in recs)
                  + (f"; balance ({a.balance}) stop counts a call: {counts}"
                     if name == "port" else ""), flush=True)
            counts.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
