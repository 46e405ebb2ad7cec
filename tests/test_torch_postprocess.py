"""The port's postprocessing (postprocess.py, physics/filters.py, the
B-factor fit, power spectra and shell averages of physics/spectrum.py,
auto_mask and soft_mask_noise of physics/mask.py) against thunder_tpu on
the CPU, on the same numpy inputs made from a seed, and against the
THUNDER library's own postprocess goldens (tests/goldens/postprocess/).

Random draws (the random phases of the true FSC, the noise of
soft_mask_noise) come from JAX keys in thunder_tpu and from a
torch.Generator in the port: the parts that do not depend on them are
held to thunder_tpu value by value, the others by their statistics, or
with thunder_tpu's own draws injected into the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu import postprocess as jpost
from thunder_tpu.physics import filters as jfil
from thunder_tpu.physics import mask as jmask
from thunder_tpu.physics import spectrum as jspec
from thunder_tpu_torch import postprocess as tpost
from thunder_tpu_torch.io.mrc import read_mrc
from thunder_tpu_torch.physics import filters as tfil
from thunder_tpu_torch.physics import mask as tmask
from thunder_tpu_torch.physics import spectrum as tspec

torch.set_num_threads(2)

G = os.path.join(os.path.dirname(__file__), "goldens", "postprocess")


def rel_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def spectrum_pair(size: int, ndim: int, seed: int):
    """A centered spectrum that falls off with |k| (numpy complex64)."""
    rng = np.random.default_rng(seed)
    shape = (size,) * ndim
    raw = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    f = np.asarray(jfil.freq_norm(size, ndim))
    return (raw * np.exp(-8.0 * f) * 100).astype(np.complex64)


def half_maps(size: int, seed: int, noise: float = 0.3):
    """Two noisy half-maps of one smooth blob volume and a soft mask,
    float32 FFT layout."""
    rng = np.random.default_rng(seed)
    u = np.asarray(jmask.radial_grid(size, 3))
    raw = rng.standard_normal((size,) * 3)
    f = np.asarray(jfil.freq_norm(size, 3))
    smooth = np.real(np.fft.ifftn(np.fft.fftn(raw) * np.fft.ifftshift(
        np.exp(-(f / 0.18) ** 2))))
    signal = (smooth * np.exp(-(u / (size / 5)) ** 2) * 20).astype(np.float32)
    a = signal + noise * rng.standard_normal(signal.shape).astype(np.float32)
    b = signal + noise * rng.standard_normal(signal.shape).astype(np.float32)
    mask = np.asarray(jmask.soft_mask_weight(size, 3, size * 0.3, 3.0), np.float32)
    return a.astype(np.float32), b.astype(np.float32), mask, signal


FILTERS = {
    "b_factor": (lambda m, ft: m.b_factor_filter(ft, 35.0)),
    "b_factor_negative": (lambda m, ft: m.b_factor_filter(ft, -60.0)),
    "low_pass": (lambda m, ft: m.low_pass_filter(ft, 0.21, 0.08)),
    "high_pass": (lambda m, ft: m.high_pass_filter(ft, 0.12, 0.05)),
    "sharpen": (lambda m, ft: m.sharpen(ft, 0.3, 4 / 32, -40.0)),
}


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("name", sorted(FILTERS) + ["fsc_weighting"])
def test_filters_match_thunder_tpu(name, ndim):
    """Every filter, elementwise, on a 2D and a 3D spectrum: within 1e-5
    of the largest output value."""
    ft = spectrum_pair(32 if ndim == 3 else 48, ndim, seed=ndim)
    if name == "fsc_weighting":
        curve = np.linspace(1.0, -0.1, 14).astype(np.float32)   # shorter than the box
        got = tfil.fsc_weighting_filter(torch.as_tensor(ft), curve)
        want = jfil.fsc_weighting_filter(jnp.asarray(ft), jnp.asarray(curve))
    else:
        got = FILTERS[name](tfil, torch.as_tensor(ft))
        want = FILTERS[name](jfil, jnp.asarray(ft))
    assert rel_err(got.numpy(), np.asarray(want)) <= 1e-5


@pytest.mark.parametrize("ndim,size", [(2, 40), (3, 32), (3, 31)])
def test_shell_statistics_match_thunder_tpu(ndim, size):
    """shell_count (half space and full), shell_average, power_spectrum and
    nyquist equal thunder_tpu's."""
    ft = spectrum_pair(size, ndim, seed=size)
    n = size // 2
    for half in (True, False):
        np.testing.assert_array_equal(
            tspec.shell_count(size, ndim, n, halfspace=half).numpy(),
            np.asarray(jspec.shell_count(size, ndim, n, halfspace=half)))
    v = np.abs(ft).astype(np.float32)
    assert rel_err(tspec.shell_average(torch.as_tensor(v), n).numpy(),
                   np.asarray(jspec.shell_average(jnp.asarray(v), n))) <= 1e-5
    assert rel_err(tspec.power_spectrum(torch.as_tensor(ft), n).numpy(),
                   np.asarray(jspec.power_spectrum(jnp.asarray(ft), n))) <= 1e-5
    assert tspec.nyquist(1.32) == jspec.nyquist(1.32)


@pytest.mark.parametrize("r_u,r_l", [(15, 3), (11, 5), (16, 1)])
def test_b_factor_est_matches_thunder_tpu(r_u, r_l):
    """The Guinier fit over full-space shells, within 1e-4 relative."""
    ft = spectrum_pair(32, 3, seed=r_u)
    got = tspec.b_factor_est(torch.as_tensor(ft), r_u, r_l)
    want = float(jspec.b_factor_est(jnp.asarray(ft), r_u, r_l))
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


@pytest.mark.parametrize("ext,ew", [(0.0, 0.0), (2.0, 3.0), (-1.0, 2.0)])
def test_auto_mask_matches_thunder_tpu(ext, ew):
    """The same mask (within 1e-6) from a volume with two separate
    objects, so that the largest-component step has work to do."""
    a, _, _, _ = half_maps(32, seed=4)
    u = np.asarray(jmask.radial_grid(32, 3))
    vol = a * (u < 12) + 3.0 * (np.roll(u, 14, axis=0) < 2)
    got = tmask.auto_mask(vol, 14, ext, ew)
    want = jmask.auto_mask(vol, 14, ext, ew)
    assert got.dtype == np.float32 and got.max() == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_soft_mask_noise_matches_thunder_tpu():
    """With bg_std = 0 the noise blend equals thunder_tpu's within 1e-6;
    with bg_std > 0 the pixels past the edge (weight 0) have the mean and
    std of the requested noise within three standard errors, as thunder_tpu's."""
    rng = np.random.default_rng(7)
    img = rng.standard_normal((6, 32, 32)).astype(np.float32)
    mean = rng.uniform(-1, 1, 6).astype(np.float32)
    r, ew = 9.0, 3.0
    gen = torch.Generator().manual_seed(0)
    got = tmask.soft_mask_noise(gen, torch.as_tensor(img), r, ew, torch.as_tensor(mean),
                                torch.zeros(6))
    want = jmask.soft_mask_noise(jax.random.PRNGKey(0), jnp.asarray(img), r, ew,
                                 jnp.asarray(mean), jnp.zeros(6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    std = np.float32(2.5)
    got = tmask.soft_mask_noise(gen, torch.as_tensor(img), r, ew, torch.as_tensor(mean),
                                torch.full((6,), float(std))).numpy()
    want = np.asarray(jmask.soft_mask_noise(jax.random.PRNGKey(1), jnp.asarray(img), r, ew,
                                            jnp.asarray(mean), jnp.full(6, std)))
    out = np.asarray(jmask.radial_grid(32, 2)) > r + ew
    n = int(out.sum())
    for res in (got, want):
        noise = res[:, out] - mean[:, None]
        assert abs(noise.mean()) < 3 * std / np.sqrt(noise.size)
        # std of a sample std: sigma / sqrt(2 (n - 1))
        assert abs(noise.std() - std) < 3 * std / np.sqrt(2 * (noise.size - 1))
        assert n > 100


@pytest.fixture(scope="module")
def both_postprocessed():
    a, b, m, signal = half_maps(40, seed=11)
    want = jpost.postprocess(a, b, m, 1.32)
    got = tpost.postprocess(a, b, m, 1.32, device="cpu",
                            gen=torch.Generator().manual_seed(5))
    return a, b, m, signal, got, want


def test_postprocess_matches_thunder_tpu(both_postprocessed):
    """The FSCs that need no draw within 1e-4, the true FSC within 1e-4
    below the random-phase threshold, the resolution shell within 2, the
    merged map within 1e-5 relative; the sharpened map correlates with
    thunder_tpu's inside the mask."""
    a, b, m, signal, got, want = both_postprocessed
    np.testing.assert_allclose(got.fsc_unmask, want.fsc_unmask, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.fsc_mask, want.fsc_mask, rtol=0, atol=1e-4)
    thres = jspec.res_p(want.fsc_unmask, 0.8, 1, 1)
    lo = slice(0, thres + 2)
    np.testing.assert_allclose(got.fsc_true[lo], want.fsc_true[lo], rtol=0, atol=1e-4)
    assert thres + 2 < len(want.fsc_true) - 3, "the data left no shell to randomise"
    assert abs(got.res_shell - want.res_shell) <= 2, (got.res_shell, want.res_shell)
    assert rel_err(got.map_avg, want.map_avg) <= 1e-5
    assert np.isfinite(got.b_factor) and np.isfinite(got.map_sharp).all()
    sel = m > 0.5
    corr = np.corrcoef(got.map_sharp[sel], want.map_sharp[sel])[0, 1]
    assert corr > 0.95, corr


def test_postprocess_with_thunder_tpus_phases(both_postprocessed):
    """With thunder_tpu's own random phases injected, the whole true FSC,
    the resolution, the B factor and the sharpened map agree too."""
    a, b, m, signal, _, want = both_postprocessed
    size = a.shape[-1]
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    draw = lambda k: torch.as_tensor(np.asarray(jax.random.uniform(
        k, (size,) * 3, minval=0.0, maxval=2 * np.pi)))
    got = tpost.postprocess(a, b, m, 1.32, device="cpu", phases=(draw(ka), draw(kb)))
    np.testing.assert_allclose(got.fsc_true, want.fsc_true, rtol=0, atol=1e-4)
    assert got.res_shell == want.res_shell
    assert abs(got.b_factor - want.b_factor) <= 1e-3 * max(abs(want.b_factor), 1.0)
    assert rel_err(got.map_sharp, want.map_sharp) <= 1e-4


def test_postprocess_matches_reference_goldens():
    """The port's postprocess against the THUNDER library's artifacts on
    the same half-maps, by thunder_tpu's criteria
    (tests/test_reference_goldens.py::test_postprocess_matches_reference):
    the true FSC below the random-phase threshold within 5e-3, the
    resolution shell within 2, the sharpened map's correlation inside the
    mask above 0.95."""
    a, _ = read_mrc(os.path.join(G, "half_a.mrc"))
    b, _ = read_mrc(os.path.join(G, "half_b.mrc"))
    m, _ = read_mrc(os.path.join(G, "mask.mrc"))
    gold_sharp, _ = read_mrc(os.path.join(G, "Reference_Sharp.mrc"))
    rows = np.loadtxt(os.path.join(G, "Postprocess_FSC.txt"))
    gold_fsc = np.zeros(a.shape[-1] // 2 - 1)
    gold_fsc[rows[:, 0].astype(int) - 1] = rows[:, 2]

    res = tpost.postprocess(a, b, m, 1.32, device="cpu")

    thres = int(np.argmax(gold_fsc < 0.8)) or len(gold_fsc)
    lo = slice(1, max(2, thres - 3))
    np.testing.assert_allclose(res.fsc_true[lo], gold_fsc[lo], rtol=5e-3, atol=5e-3)
    g_res = int(np.argmax(gold_fsc < 0.143))
    assert abs(res.res_shell - g_res) <= 2, (res.res_shell, g_res)
    sel = m > 0.5
    corr = np.corrcoef(res.map_sharp[sel], gold_sharp[sel])[0, 1]
    assert corr > 0.95, f"sharpened map corr {corr}"


def test_postprocess_cli_matches_thunder_tpu(tmp_path, monkeypatch):
    """Both CLIs on the same half-maps, with a mask and with the
    auto-mask: the same files, the same FSC table below the random-phase
    threshold, the same merged map."""
    from thunder_tpu.cli import postprocess as jcli
    from thunder_tpu.io.mrc import write_mrc
    from thunder_tpu_torch.cli import postprocess as tcli

    a, b, m, _ = half_maps(32, seed=3)
    for name, arr in (("a.mrc", a), ("b.mrc", b), ("m.mrc", m)):
        write_mrc(str(tmp_path / name), arr, 1.32)
    monkeypatch.chdir(tmp_path)
    for masked in (True, False):
        extra = ["-m", "m.mrc"] if masked else []
        jcli.main(["-a", "a.mrc", "-b", "b.mrc", "--pixelsize", "1.32",
                   "--out-prefix", "j_"] + extra)
        tcli.main(["-a", "a.mrc", "-b", "b.mrc", "--pixelsize", "1.32",
                   "--out-prefix", "t_", "--device", "cpu"] + extra)
        jt, tt = np.loadtxt("j_Postprocess_FSC.txt"), np.loadtxt("t_Postprocess_FSC.txt")
        assert tt.shape == jt.shape == (32 // 2 - 2, 5)
        np.testing.assert_allclose(tt[:, :4], jt[:, :4], rtol=0, atol=1e-4 + 1e-6)
        thres = jspec.res_p(np.concatenate([[1.0], jt[:, 2]]), 0.8, 1, 1)
        np.testing.assert_allclose(tt[:thres + 1, 4], jt[:thres + 1, 4], atol=1e-4)
        avg_t, _ = read_mrc("t_Reference_Average.mrc")
        avg_j, _ = read_mrc("j_Reference_Average.mrc")
        assert rel_err(avg_t, avg_j) <= 1e-5
        assert np.isfinite(read_mrc("t_Reference_Sharp.mrc")[0]).all()
