"""Local search inside whole rounds, in both packages on the same
images: on the sharp phantom at 32 px (signal out to the band's edge) the
resolution band r grows to r_global, the state machine
(update_search_type) enters SEARCH_TYPE_LOCAL, and local rounds (image
re-centring, re-masking, norm correction) push r past r_global, within
ten rounds.  The blob phantom, whose spectrum ends near a third of the
band, is the generator's default and is what the earlier cells keep."""

import numpy as np
import pytest
import torch

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


@pytest.fixture(scope="module")
def runs():
    """Both packages from the same start on the same 128 images until
    each has raised r past r_global, at most MAX_ROUNDS rounds."""
    vol, imgs, ctf, _, _ = make_dataset(SIZE, N, seed=1, snr=6.0, device="cpu", kind="sharp",
                                        defocus_range=(400.0, 800.0), shift=1.0)
    kw = dict(mode="3D", k=1, size=SIZE, pixel_size=1.32, mask_radius=SIZE * 1.32 * 0.42,
              trans_s=1.0, init_res=SIZE * 1.32 / 9, global_search_res=SIZE * 1.32 / 7,
              sym="C1", m_s=1024, m_l_r=24, m_l_t=9, m_reco=12, ignore_res=SIZE * 1.32,
              trans_search_factor=1.0)
    jopt = jo.Optimiser(JConfig(**kw), imgs, jctf_params(*ctf), np.zeros(N, np.int64),
                        init_refs=vol)
    topt = to.Optimiser(TConfig(**kw), imgs, tuple(ctf), np.zeros(N, np.int64),
                        init_refs=vol, device="cpu")
    out = {}
    for name, opt in (("jax", jopt), ("port", topt)):
        recs = []
        for i in range(MAX_ROUNDS):
            recs.append(opt.run_round(i))
            if recs[-1]["r"] > opt.model.r_global:
                break
        out[name] = (opt, recs)
    return out


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
