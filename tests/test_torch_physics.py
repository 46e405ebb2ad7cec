"""Parity of the port's Fourier helpers, CTF, gridding kernels, spectrum
statistics, masks and preprocessing with thunder_tpu, on the CPU (the
kernels' plain versions), plus the reference-library goldens for CTF,
gridding kernels and FSC with the assertions of
test_reference_goldens.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu.ops import fourier as jf  # noqa: E402
from thunder_tpu.physics import ctf as jctf  # noqa: E402
from thunder_tpu.physics import kernels as jk  # noqa: E402
from thunder_tpu.physics import mask as jm  # noqa: E402
from thunder_tpu.physics import spectrum as js  # noqa: E402
from thunder_tpu.pipeline import preprocess as jpp  # noqa: E402
from thunder_tpu_torch.ops import fourier as tf  # noqa: E402
from thunder_tpu_torch.physics import ctf as tctf  # noqa: E402
from thunder_tpu_torch.physics import kernels as tk  # noqa: E402
from thunder_tpu_torch.physics import mask as tm  # noqa: E402
from thunder_tpu_torch.physics import spectrum as ts  # noqa: E402
from thunder_tpu_torch.pipeline import preprocess as tpp  # noqa: E402

G = os.path.join(os.path.dirname(__file__), "goldens")
N = 32
# float32 transforms and reductions in another order than XLA's:
# relative tolerance on the largest magnitude
RTOL = 2e-5


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= rtol * scale, np.abs(a - b).max() / scale


def t(x):
    return torch.as_tensor(np.array(x))


def _phantom_centered():
    c = N // 2
    k = np.arange(N) - c
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    return (np.exp(-((kx - 3) ** 2 + ky ** 2 + kz ** 2) / (2 * 6.25))
            + np.exp(-((kx + 2) ** 2 + (ky - 2) ** 2 + kz ** 2) / 8.0)
            + np.exp(-(kx ** 2 + (ky + 3) ** 2 + (kz - 2) ** 2) / 4.5)
            ).astype(np.float32)


@pytest.mark.parametrize("r_u,r_l,lane", [(6, 0, 8), (7, 2, 512)])
def test_pack_rings_and_phases(r_u, r_l, lane):
    jr = jf.pack_rings(16, r_u, r_l, lane)
    tr = tf.pack_rings(16, r_u, r_l, lane)
    for a, b in zip(jr[:4], tr[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jr.n_valid == tr.n_valid
    rng = np.random.default_rng(0)
    trans = rng.uniform(-3, 3, (5, 2)).astype(np.float32)
    close(tf.translate_phases(tr, t(trans)),
          jf.translate_phases(jr, jnp.asarray(trans)))
    ft = (rng.standard_normal((3, 16, 16))
          + 1j * rng.standard_normal((3, 16, 16))).astype(np.complex64)
    np.testing.assert_array_equal(tf.extract_packed(t(ft), tr).numpy(),
                                  np.asarray(jf.extract_packed(jnp.asarray(ft), jr)))
    # whole-spectrum shifts, one (tx, ty) per image
    close(tf.translate_ft(t(ft), t(trans[:3])),
          np.stack([jf.translate_ft(jnp.asarray(ft[i]), *trans[i]) for i in range(3)]))


def test_real_space_resampling():
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((16, 16, 16)).astype(np.float32)
    close(tf.pad_rl(t(vol), 2), jf.pad_rl(jnp.asarray(vol), 2))
    close(tf.extract_rl(t(vol), 2), jf.extract_rl(jnp.asarray(vol), 2))
    for n in (12, 20):
        close(tf.resize_rl(t(vol), n), jf.resize_rl(jnp.asarray(vol), n))
    close(tf.fft3_centered(t(vol)), jf.fft3_centered(jnp.asarray(vol)))
    img = vol[0]
    close(tf.ifft2_centered(tf.fft2_centered(t(img))), img, 1e-5)
    np.testing.assert_array_equal(tf.centered_shell_dev(15, 3).numpy(),
                                  np.asarray(jf.centered_shell_dev(15, 3)))


def _ctf_cols(n, rng):
    d = rng.uniform(8000, 20000, n)
    return (np.full(n, 300e3), d, d * rng.uniform(0.9, 1.1, n),
            rng.uniform(0, np.pi, n), np.full(n, 2e7), np.full(n, 0.1),
            rng.uniform(0, 0.3, n))


def test_ctf_matches_jax():
    rng = np.random.default_rng(2)
    cols = _ctf_cols(4, rng)
    jp, tp = jctf.ctf_params(*cols), tctf.ctf_params(*cols)
    rings = jf.pack_rings(64, 30, 1)
    # chi reaches ~1e2 rad at these defoci: float32 phase error ~1e-7 chi
    close(tctf.ctf_packed(tp, t(rings.i_col), t(rings.i_row), 64, 1.32),
          jctf.ctf_packed(jp, rings.i_col, rings.i_row, 64, 1.32), 2e-4)
    close(tctf.ctf_image(tp, 64, 1.32), jctf.ctf_image(jp, 64, 1.32), 2e-4)


def test_ctf_golden():
    gold = np.fromfile(os.path.join(G, "ctf_32.bin"), np.float32)
    gold = (gold[0::2]).reshape(N, N)
    p = tctf.ctf_params([300000.0], [20000.0], [18000.0], [0.3], [2e7], [0.1], [0.2])
    mine = tctf.ctf_image(p, N, 1.32)[0].numpy()
    np.testing.assert_allclose(gold[1:, 1:], mine[1:, 1:], rtol=3e-3, atol=5e-5)


def test_gridding_kernels_match_jax_and_golden():
    r = np.arange(65) / 64.0
    gold = np.fromfile(os.path.join(G, "kernels.bin"), np.float32).reshape(65, 4)
    pairs = [(tk.mkb_ft(r * 1.9, 1.9, 15.0), jk.mkb_ft(r * 1.9, 1.9, 15.0), 0),
             (tk.mkb_rl(r * 0.5, 1.9, 15.0), jk.mkb_rl(r * 0.5, 1.9, 15.0), 1),
             (tk.tik_rl(r * 0.5), jk.tik_rl(r * 0.5), 2),
             (tk.nik_rl(r * 0.5), jk.nik_rl(r * 0.5), 3)]
    for mine, ref, col in pairs:
        close(mine.numpy(), np.asarray(ref), 1e-5)
        np.testing.assert_allclose(mine.numpy(), gold[:, col], rtol=1e-4, atol=1e-7)
    assert abs(tk.mkb_blob_vol(1.9, 15.0) - jk.mkb_blob_vol(1.9, 15.0)) < 1e-6


@pytest.mark.parametrize("ndim,size,n_shells", [(2, 16, 8), (3, 16, 8), (3, 15, 9)])
def test_shell_sum_and_fsc_match_jax(ndim, size, n_shells):
    rng = np.random.default_rng(3)
    shape = (size,) * ndim
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    b = (a + 0.5 * rng.standard_normal(shape)).astype(np.complex64)
    v = rng.standard_normal(shape).astype(np.float32)
    for half in (True, False):
        close(ts.shell_sum(t(v), size, ndim, n_shells, half),
              js.shell_sum(jnp.asarray(v), size, ndim, n_shells, half))
    close(ts.fsc(t(a), t(b), n_shells), js.fsc(jnp.asarray(a), jnp.asarray(b), n_shells))
    np.testing.assert_array_equal(ts.shell_count(size, ndim, n_shells).numpy(),
                                  np.asarray(js.shell_count(size, ndim, n_shells)))


def test_shell_sums_plain_semantics():
    """HK4's plain version: per-row, per-field sums with the overflow
    bin dropped and an optional weight (the half-space mask)."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((3, 2, 50)).astype(np.float32)
    shell = rng.integers(0, 9, 50).astype(np.int32)
    w = (rng.random(50) > 0.3).astype(np.float32)
    out = ts.shell_sums(t(v), t(shell), 7, t(w)).numpy()
    ref = np.zeros((3, 2, 8))
    np.add.at(ref, (slice(None), slice(None), np.minimum(shell, 7)), v * w)
    np.testing.assert_allclose(out, ref[..., :7], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ndim,size,n_b", [(2, 16, 3), (3, 12, 1), (3, 15, 2)])
def test_fsc_sums_are_the_stacked_half_space_sums(ndim, size, n_b):
    """HK4's spectrum-pair entry: its plain version gives the sums of
    the three stacked fields Re(a conj b), |a|^2, |b|^2 through the
    array form exactly, batched, and the FSC of thunder_tpu from them
    (1e-5 relative: float32 sums in another order)."""
    rng = np.random.default_rng(11)
    shape = (n_b,) + (size,) * ndim
    a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    b = (a + 0.5 * rng.standard_normal(shape)).astype(np.complex64)
    n_sh = size // 2 - 1
    ta, tb = (t(x).reshape(n_b, -1) for x in (a, b))
    got = ts.fsc_sums(ta, tb, size, ndim, n_sh)
    assert got.shape == (n_b, 3, n_sh)
    u, half = ts.shell_geometry(size, ndim, "cpu")
    vals = torch.stack([(ta * tb.conj()).real, ta.abs() ** 2, tb.abs() ** 2], dim=1)
    np.testing.assert_array_equal(got.numpy(), ts.shell_sums(vals, u, n_sh, half).numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  ts.shell_sums_grid(vals, size, ndim, n_sh).numpy())
    curve = got[:, 0] / torch.sqrt(got[:, 1] * got[:, 2])
    for i in range(n_b):
        close(curve[i], js.fsc(jnp.asarray(a[i]), jnp.asarray(b[i]), n_sh), 1e-5)


@pytest.mark.parametrize("ndim,size,half", [(2, 16, True), (2, 15, False), (3, 12, True),
                                            (3, 9, False)])
def test_shell_sums_grid_plain_matches_jax(ndim, size, half):
    """The coordinate form's plain version, several fields at once,
    against thunder_tpu's shell_sum field by field (1e-5 relative)."""
    rng = np.random.default_rng(12)
    v = rng.standard_normal((2, 3, size ** ndim)).astype(np.float32)
    n_sh = size // 2
    got = ts.shell_sums_grid(t(v), size, ndim, n_sh, half)
    for i in range(2):
        for c in range(3):
            close(got[i, c], js.shell_sum(jnp.asarray(v[i, c].reshape((size,) * ndim)), size,
                                          ndim, n_sh, half), 1e-5)


@pytest.mark.parametrize("ndim,size", [(3, 128), (2, 160), (3, 33), (2, 45)])
def test_coordinate_form_shell_index_is_exact(ndim, size):
    """HK4's coordinate form takes a cell's shell as rint(sqrt(k^2)) in
    float32 and its half-space weight as kx >= 0 or kx == -c: both are
    shell_geometry's, cell for cell (and thunder_tpu's)."""
    c = size // 2
    k = np.arange(size, dtype=np.int32) - c
    grids = np.meshgrid(*([k] * ndim), indexing="ij")
    k2 = sum(g * g for g in grids)
    shell = np.rint(np.sqrt(k2.astype(np.float32))).astype(np.int32)
    weight = ((grids[-1] >= 0) | (grids[-1] == -c)).astype(np.float32)
    u, half = ts._shell_geometry_np(size, ndim)
    np.testing.assert_array_equal(shell, u)
    np.testing.assert_array_equal(weight, half)
    if size <= 45:
        ju, jhalf = js._shell_geometry(size, ndim)
        np.testing.assert_array_equal(u, np.asarray(ju))
        np.testing.assert_array_equal(half, np.asarray(jhalf))


def test_coordinate_form_shell_index_is_exact_for_every_k2():
    """The float32 square root never rounds across a half-integer: for
    every integer k^2 a box of up to 1024 px can hold, rint(sqrt) in
    float32 is rint(sqrt) in float64."""
    k2 = np.arange(3 * 512 ** 2 + 1)
    np.testing.assert_array_equal(np.rint(np.sqrt(k2.astype(np.float32))),
                                  np.rint(np.sqrt(k2.astype(np.float64))))


@pytest.mark.parametrize("n_b,n,pieces", [(10000, 1536, 1), (10000, 8192, 1), (256, 2048, 8),
                                          (256, 4096, 16), (1, 1536, 6), (1, 100, 1),
                                          (30, 25600, 100), (5000, 64, 1)])
def test_shell_sums_plan(n_b, n, pieces):
    """The row form's launch plan: a warp an image once the batch fills
    the card (and then no zero-filled output), else pieces of at least
    256 cells, enough of them for ~4,224 warps."""
    assert ts.shell_sums_plan(n_b, n) == pieces


def test_chip_smoke_splits_hk4_launches_by_caller():
    """chip_smoke.py's split of HK4's launch count, from the wrapper's
    count by (form, B, C, N); the full-space coordinate form is the
    B-factor fit's."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    shapes = {("pair", 1, 3, 128 ** 3): 7, ("pair", 30, 3, 160 ** 2): 2,
              ("grid", 1, 1, 160 ** 2): 4, ("rows", 256, 3, 2048): 3,
              ("rows", 256, 1, 4096): 3, ("rows", 1, 1, 2048): 5, ("rows", 1, 1, 4096): 1,
              ("full", 1, 1, 160 ** 3): 2}
    assert smoke.hk4_by_caller(shapes) == {"fsc_frc": 9, "preprocess": 4, "sigma_c3": 3,
                                           "sigma_c1": 3, "count": 6, "b_factor": 2}


def test_fsc_golden_and_res_p():
    gold = np.fromfile(os.path.join(G, "fsc_32.bin"), np.float32)
    a = _phantom_centered()
    c = N // 2
    k = np.arange(N) - c
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    b = a + 0.1 * np.sin(0.7 * kx + 1.3 * ky - 0.4 * kz).astype(np.float32)
    fa = np.fft.fftshift(np.fft.fftn(np.fft.ifftshift(a))).astype(np.complex64)
    fb = np.fft.fftshift(np.fft.fftn(np.fft.ifftshift(b))).astype(np.complex64)
    curve = ts.fsc(t(fa), t(fb), N // 2).numpy()
    np.testing.assert_allclose(curve, gold, rtol=5e-3, atol=5e-4)
    for thres in (0.143, 0.5, 0.95):
        assert ts.res_p(curve, thres) == js.res_p(curve, thres)


def test_random_phase_above_radius():
    rng = np.random.default_rng(5)
    ft = (rng.standard_normal((8, 8, 8)) + 1j * rng.standard_normal((8, 8, 8))
          ).astype(np.complex64)
    phase = rng.uniform(0, 2 * np.pi, ft.shape).astype(np.float32)
    out = ts.random_phase(t(ft), 2, None, phase=t(phase)).numpy()
    u, _ = js._shell_geometry(8, 3)
    ref = np.where(u > 2, ft * np.exp(1j * phase), ft)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_masks_match_jax():
    rng = np.random.default_rng(6)
    for nd in (2, 3):
        close(tm.soft_mask_weight(16, nd, 5.0, 3.0), jm.soft_mask_weight(16, nd, 5.0, 3.0))
    img = rng.standard_normal((3, 16, 16)).astype(np.float32)
    close(tm.background(t(img), 5.0, 3.0), jm.background(jnp.asarray(img), 5.0, 3.0))
    close(tm.soft_mask(t(img), 5.0, 3.0), jm.soft_mask(jnp.asarray(img), 5.0, 3.0))


def test_preprocess_and_init_sigma_match_jax():
    rng = np.random.default_rng(7)
    imgs = (rng.standard_normal((6, 16, 16)) * 2 + 0.5).astype(np.float32)
    jp = jpp.preprocess_images(jnp.asarray(imgs), 6.0)
    tp = tpp.preprocess_images(t(imgs), 6.0)
    for a, b in zip(tp, jp):
        close(a, b, 1e-5)
    close(tpp.init_sigma(tp.ft_ori, 6), jpp.init_sigma(jp.ft_ori, 6), 1e-5)
    s = np.abs(rng.standard_normal(8)).astype(np.float32)
    close(tpp.sigma_to_sig_rcp(t(s)), jpp.sigma_to_sig_rcp(jnp.asarray(s)))
