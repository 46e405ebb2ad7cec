"""The MKB insertion option (``reco_kernel="mkb"``, the modified
Kaiser-Bessel blob of Reconstructor.cpp:424-567) in the port on the CPU,
against thunder_tpu: the config fields, the blob's scatter twin, the
series of its weight and the emulation of HK10's brick scatter, its grid
correction, the reconstruction without grid correction, one 3D and one
2D round's insertion and maps from one state, the refusal of a sharding
layout, and a few rounds of each mode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.geometry.quaternion import random_quat, rotate3d  # noqa: E402
from thunder_tpu.ops import insert as ji  # noqa: E402
from thunder_tpu.ops.fourier import pack_rings as jpack_rings  # noqa: E402
from thunder_tpu.ops.projector import prepare_projectee_3d, project_3d  # noqa: E402
from thunder_tpu.physics import kernels as jk  # noqa: E402
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu.recon import reconstructor as jr  # noqa: E402
from thunder_tpu_torch import interop  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402
from thunder_tpu_torch.ops import insert as ti  # noqa: E402
from thunder_tpu_torch.parallel.mesh import Layout  # noqa: E402
from thunder_tpu_torch.physics import kernels as tk  # noqa: E402
from thunder_tpu_torch.pipeline.synthetic import make_dataset_2d  # noqa: E402
from thunder_tpu_torch.recon import reconstructor as tr  # noqa: E402

from test_e2e_3d import make_3d_dataset  # noqa: E402
from test_torch_insert_gather import (SIZE, PIX, close as close6, images,  # noqa: E402
                                      rotations)
from test_torch_slice import close, config, ctf_cols, t  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_config_reads_the_mkb_fields_as_thunder_tpu():
    """Both packages read "MKB Kernel Radius" and "MKB Kernel Smooth
    Factor" from configs/demo.json's Advanced section; reco_kernel is an
    API field, trilinear unless set."""
    path = os.path.join(REPO, "configs", "demo.json")
    jc, tc = JConfig.from_json(path), TConfig.from_json(path)
    assert (tc.mkb_a, tc.mkb_alpha) == (jc.mkb_a, jc.mkb_alpha) == (1.9, 15)
    assert tc.reco_kernel == jc.reco_kernel == "trilinear"
    assert TConfig(reco_kernel="mkb").reco_kernel == "mkb"


def test_mkb_rl_r2_matches_jax():
    r2 = np.linspace(0.0, 0.2, 41, dtype=np.float32)
    close(tk.mkb_rl_r2(t(r2), 1.9, 15.0), jk.mkb_rl_r2(jnp.asarray(r2), 1.9, 15.0), 1e-5)


def test_mkb_scatter_matches_jax():
    """insert_slices_3d(kernel="mkb") on tests/test_ops.py:342's setup
    (a 24 px phantom's slices at 128 random poses, packed rings, then the
    Hermitian fold), F and T within 1e-5 of max |thunder_tpu's|."""
    size, pf = 24, 2
    r_u = size // 2 - 1
    c = size // 2
    k = np.arange(size) - c
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    phantom = np.fft.ifftshift(
        np.exp(-((kx - 2) ** 2 + ky ** 2 + kz ** 2) / 6.0)
        + np.exp(-(kx ** 2 + (ky + 2) ** 2 + kz ** 2) / 4.0)).astype(np.float32)
    proj = prepare_projectee_3d(jnp.asarray(phantom), pf)
    rings = jpack_rings(size, r_u, 0)
    rots = rotate3d(random_quat(jax.random.PRNGKey(3), (128,)))
    slices = np.asarray(project_3d(proj, rots, rings) * rings.mask)
    c2w = np.broadcast_to(np.asarray(rings.mask), slices.shape).astype(np.float32)
    big = size * pf
    f0, t0 = np.zeros((big,) * 3, np.complex64), np.zeros((big,) * 3, np.float32)
    args = (slices, c2w, np.asarray(rots), np.asarray(rings.i_col), np.asarray(rings.i_row))
    jf, jt = ji.insert_slices_3d(jnp.asarray(f0), jnp.asarray(t0), *args, pf,
                                 (r_u - 1) * pf, kernel="mkb")
    tf_, tt_ = ti.insert_slices_3d(t(f0), t(t0), *(t(a) for a in args), pf,
                                   float((r_u - 1) * pf), kernel="mkb")
    close(tf_, jf, 1e-5)
    close(tt_, jt, 1e-5)
    close(ti.hermitianize(tf_), ji.hermitianize(jf), 1e-5)
    close(ti.hermitianize_real(tt_), ji.hermitianize_real(jt), 1e-5)
    # the blob's taps are not the trilinear ones
    tl, _ = ti.insert_slices_3d(t(f0), t(t0), *(t(a) for a in args), pf,
                                float((r_u - 1) * pf))
    assert rel_l2(tl, tf_) > 0.1


# (label, r_u, pf, big, rotations, defocus factors, zero-weight slices):
# HK10 on HK3's gather cases (tests/test_torch_insert_gather.py), its faces
# two cells past the radius
MKB_CASES = [("pf 2", 6, 2, 32, "random", False, False),
             ("pf 1", 6, 1, 16, "random", False, False),
             ("quarter turns, DC on a cell", 6, 2, 32, "quarter", False, False),
             ("taps past the faces", 6, 2, 18, "random", False, False),
             ("pf 1, taps past the faces", 7, 1, 12, "random", False, False),
             ("defocus factor, weight zero", 5, 2, 28, "random", True, True)]


@pytest.mark.parametrize("label,r_u,pf,big,kind,use_d,zero_w", MKB_CASES,
                         ids=[c[0] for c in MKB_CASES])
def test_hk10_gather_matches_scatter(label, r_u, pf, big, kind, use_d, zero_w):
    """HK10's enumeration (ops/insert.py insert_mkb_brick_plain: parts of
    bricks, their planes' samples by row, pf 1 by parity class, taps in
    one order, faces lane after lane) against the blob's scatter twin and
    thunder_tpu's insert_slices_3d(kernel="mkb") on the same values,
    within 1e-6 of max |F| and max |T|."""
    rng = np.random.default_rng(len(label) + 7)
    n_img, n_s = 3, 9
    ft, ctf = images(rng, n_img)
    img = torch.as_tensor(rng.integers(0, n_img, n_s))
    rot = rotations(rng, n_s, kind)
    trans = torch.as_tensor(rng.uniform(-2, 2, (n_s, 2)).astype(np.float32))
    w = torch.as_tensor(rng.random(n_s).astype(np.float32))
    if zero_w:
        w[::3] = 0
    d = torch.as_tensor(rng.uniform(0.95, 1.05, n_s).astype(np.float32)) if use_d else None
    args = (ft, ctf, img, rot, trans, w, r_u, pf, SIZE, PIX)
    f0 = torch.as_tensor((rng.standard_normal((big,) * 3) * 0.1).astype(np.complex64))
    t0 = torch.as_tensor(rng.random((big,) * 3).astype(np.float32) * 0.1)
    fg, tg = ti.insert_mkb_brick_plain(*args, f0.clone(), t0.clone(), d)
    fs, ts = ti.insert_mkb(*args, big, f0.clone(), t0.clone(), d)
    close6(fg, fs)
    close6(tg, ts)
    vals, c2w, vc, vr = ti.dense_slice_values(ft, ctf, img, trans, w, r_u, SIZE, PIX, d,
                                              edge=True)
    jf, jt = ji.insert_slices_3d(jnp.asarray(f0.numpy()), jnp.asarray(t0.numpy()),
                                 vals.numpy(), c2w.numpy(), rot.numpy(), vc.numpy(),
                                 vr.numpy(), pf, float((r_u - 1) * pf), kernel="mkb")
    close6(fg, jf)
    close6(tg, jt)
    assert ("past the faces" in label) == blob_taps_pass_faces(rot, r_u, pf, big)


def blob_taps_pass_faces(rot, r_u, pf, big) -> bool:
    """Whether a blob tap (floor - 1 ... floor + 2) of an in-disc sample
    lands past the grid's faces (clipped onto them by the scatter)."""
    vc, vr, mask = ti.dense_window(r_u)
    g = torch.stack([vc * pf, vr * pf, vc * 0], -1).float()
    p = torch.einsum("bij,pj->bpi", rot, g)[:, mask > 0]
    lo = torch.floor(p).long() + big // 2
    return bool(((lo - 1 < 0) | (lo + 2 > big - 1)).any())


def test_hk10_reach_and_tap_range():
    """The blob's reach and its taps' index range, as HK10 takes them
    (the margin MKB_MARGIN read from csrc/insert_mkb.cu)."""
    assert ti.mkb_reach(1.9) == pytest.approx(1.95, abs=1e-6)
    assert ti.tap_range(32, 10.0, "mkb") == (4, 28)
    assert ti.tap_range(32, 10.0) == (5, 27)


@pytest.mark.parametrize("alpha", [15.0, 10.0, 19.0])
def test_mkb_series_matches_jax_mkb_ft(alpha):
    """HK10's weight, the series of I0 in s = 1 - r^2 / a^2 by Horner's
    rule in float32 (ops/insert.py mkb_weight), at r^2 = t a^2 over t in
    [0, 1]: within 6e-7 of the float64 value, and within 2e-6 of
    thunder_tpu's mkb_ft (physics/kernels.py:52), whose float32 quotient of
    I0s lies up to 1.6e-6 from the float64 value at alpha 19 (0.99e-6 at
    15)."""
    a = 1.9
    a2, inv_a2, coef = ti.mkb_constants(a, alpha)
    r2 = torch.linspace(0.0, 1.0, 20001) * float(a2)
    mine = ti.mkb_weight(r2, inv_a2, coef).double().numpy()
    t64 = r2.double().numpy() / float(a2)
    exact = np.i0(alpha * np.sqrt(np.clip(1 - t64, 0, None))) / np.i0(alpha)
    assert np.abs(mine - exact).max() < 6e-7
    theirs = np.asarray(jk.mkb_ft(jnp.sqrt(jnp.asarray(r2.numpy())), a, alpha))
    assert np.abs(mine - theirs).max() < 2e-6


def test_mkb_series_refuses_an_alpha_it_does_not_hold():
    with pytest.raises(ValueError, match="alpha"):
        ti.mkb_constants(1.9, 40.0)


@pytest.mark.parametrize("nd", [3, 2])
def test_mkb_correction_and_finalize_match_jax(nd):
    """_mkb_correction (3D and 2D) and finalize_reconstruction with the
    blob's correction, and without any, against thunder_tpu."""
    size, pf, r = 16, 2, 6
    big = size * pf
    rng = np.random.default_rng(nd)
    # float32 Bessel functions of two libraries
    close(tr._mkb_correction(size, pf, None, nd), jr._mkb_correction(size, nd, pf), 1e-5)
    f = (rng.standard_normal((big,) * nd) + 1j * rng.standard_normal((big,) * nd)
         ).astype(np.complex64)
    f = np.asarray(ji.hermitianize(jnp.asarray(f)))
    w = rng.uniform(0.5, 1.5, (big,) * nd).astype(np.float32)
    w = (w + np.roll(np.flip(w), 1, axis=tuple(range(nd)))) / 2      # real, even
    for kernel, corr in (("mkb", True), ("trilinear", True), ("trilinear", False)):
        a = tr.finalize_reconstruction(t(f), t(w), size, pf, r, nd, corr, kernel)
        b = jr.finalize_reconstruction(jnp.asarray(f), jnp.asarray(w), size, pf, r, corr,
                                       kernel)
        close(a, b, 2e-5)


@pytest.mark.parametrize("nd", [3, 2])
def test_reconstruct_without_grid_correction_matches_jax(nd):
    """reconstruct(grid_corr=False): W = 1 / T inside the radius, no
    kernel correction (thunder_tpu recon/reconstructor.py:223-246)."""
    size, pf, r = 16, 2, 6
    big = size * pf
    rng = np.random.default_rng(10 + nd)
    f = (rng.standard_normal((big,) * nd) + 1j * rng.standard_normal((big,) * nd)
         ).astype(np.complex64)
    f = np.asarray(ji.hermitianize(jnp.asarray(f)))
    tg = rng.uniform(0.5, 1.5, (big,) * nd).astype(np.float32)
    tg = tg + np.roll(np.flip(tg), 1, axis=tuple(range(nd)))
    a = tr.reconstruct(t(f), t(tg), size, pf, r, nd, grid_corr=False)
    b = jr.reconstruct(jnp.asarray(f), jnp.asarray(tg), jnp.ones(size // 2), size, pf, r,
                       map_wiener=False, grid_corr=False)
    close(a, b, 2e-5)
    # the blob's balance and correction, on a T that every cell receives
    a = tr.reconstruct(t(f), t(tg), size, pf, r, nd, kernel="mkb")
    b = jr.reconstruct(jnp.asarray(f), jnp.asarray(tg), jnp.ones(size // 2), size, pf, r,
                       map_wiener=False, kernel="mkb")
    assert rel_l2(a, b) < 1e-4


def covered(t2, r_u, nd, pf=2):
    """Whether every cell inside the balance loop's radius r_u pf holds
    T above the 1e-25 floor."""
    big = t2.shape[-1]
    k = torch.arange(big) - big // 2
    q = sum(g ** 2 for g in torch.meshgrid(*([k] * nd), indexing="ij"))
    return bool((t2[..., q < (r_u * pf) ** 2] > 1e-25).all())


def _mkb_pair(size, n, **kw):
    """A JAX and a port Optimiser with reco_kernel "mkb" on the same
    images, the port started from the JAX state, the poses near the
    truth."""
    phantom, imgs, quats, trans = make_3d_dataset(size, n, seed=3)
    jopt = jo.Optimiser(config(size, reco_kernel="mkb", **kw), imgs,
                        jctf_params(*ctf_cols(n)), np.zeros(n, np.int64), init_refs=phantom)
    topt = to.Optimiser(config(size, TConfig, reco_kernel="mkb", **kw), imgs, ctf_cols(n),
                        np.zeros(n, np.int64), init_refs=phantom, device="cpu")
    jopt.state.par = jopt.state.par._replace(
        top_r=jnp.asarray(np.asarray(quats)[jopt.index], jnp.float32),
        top_t=jnp.asarray(np.asarray(trans)[jopt.index], jnp.float32))
    interop.restore(topt, interop.snapshot(jopt))
    return jopt, topt


def _draws(jopt, topt, n_s, seed):
    rng = np.random.default_rng(seed)
    n_l = topt.n_img
    q = np.repeat(np.asarray(jopt.state.par.top_r)[:, :, None], n_s, 2)
    q = q + 0.3 * rng.standard_normal(q.shape)
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr_ = rng.normal(0, 0.5, (2, n_l, n_s, 2)).astype(np.float32)
    w = np.full((2, n_l, n_s), 1.0 / n_s, np.float32) * np.asarray(topt.valid)[..., None]
    return q, tr_, w.astype(np.float32)


@pytest.mark.parametrize("sym", ["C1", "C4"])
def test_mkb_round_insertion_and_maps_match_jax(sym):
    """One MKB 3D round from one state: the port's reconstruct_round
    (HK10's plain twin on the dense window, then HK7 with mates) against
    thunder_tpu's _insert_all_h(kernel="mkb") (packed half-space rings,
    the Hermitian fold, symmetrize_ft) on the same draws, held to
    test_torch_slice's relative L2 of 2e-2: one slice's grids agree
    within 1e-6 of their maximum, but the pixels on the circle |k| = r_u
    - 1 fall on either side of the float test |p| < max_radius_pad as
    each compiled expression rounds (measured 3.7e-3 / 2.7e-3 for F / T
    at C1); then the maps (:func:`assert_maps_match`)."""
    size, n = 24, 32
    jopt, topt = _mkb_pair(size, n, sym=sym)
    q, tr_, w = _draws(jopt, topt, 32, 5)
    f2, t2, r_u, gs = topt.reconstruct_round(draws=(t(q), t(tr_), None, t(w)))
    rings = jpack_rings(size, r_u, 0)
    trans = jnp.asarray(tr_) - jopt.offset[:, :, None, :]
    jf, jt = jo._insert_all_h(
        jopt.data.ft_ori, jopt.data.ctf_params, rings.mask, rings.i_col, rings.i_row,
        jnp.asarray(q), trans, jnp.ones(w.shape, jnp.float32), jnp.asarray(w)[:, None],
        jopt.sym.matrices, jnp.asarray((r_u - 1) * 2, jnp.float32), size, 2, False,
        jopt.sym.order, gs, 1.0, False, r_u, "mkb")
    assert rel_l2(f2, jf) < 2e-2 and rel_l2(t2, jt) < 2e-2, (rel_l2(f2, jf), rel_l2(t2, jt))
    # and not the trilinear round's grids
    topt.cfg.reco_kernel = "trilinear"
    fl, _, _, _ = topt.reconstruct_round(draws=(t(q), t(tr_), None, t(w)))
    topt.cfg.reco_kernel = "mkb"
    assert rel_l2(fl, f2) > 0.1
    assert_maps_match(f2, t2, r_u, gs, size, 3)


def assert_maps_match(f2, t2, r_u, gs, size, nd):
    """Both packages' two-pass reconstruction with the blob's correction
    from the same grids: at the round's r_u within test_torch_slice's
    relative L2 of 2e-2, and within 1e-4 where every cell the balance
    loop treats received slices (max_radius r_u - 1).  At r_u the ring
    between insertion's reach, (r_u - 1) pf + a, and the balance's r_u
    pf holds empty cells, where W grows in both packages (the port keeps
    W = 1 there only with trilinear taps): measured 8.4e-5 at C1, 1.5e-2
    at C4 and 9e-7 in 2D at r_u, 2e-6 / 8e-7 at r_u - 1."""
    from thunder_tpu_torch.ops.fourier import resize_rl

    k = f2.shape[1]
    assert covered(t2, r_u - 1, nd) and not covered(t2, r_u, nd)
    for radius, tol in ((r_u, 2e-2), (r_u - 1, 1e-4)):
        ja, jb = jo._reconstruct_two_h(jnp.asarray(f2.numpy()), jnp.asarray(t2.numpy()),
                                       jnp.ones((k, 10), jnp.float32), gs, 2, radius, size,
                                       "mkb")
        ta, tb = tr.reconstruct_two_pass(f2, t2, torch.ones(k, 10), gs, 2, radius, nd=nd,
                                         kernel="mkb")
        if gs != size:
            ta, tb = resize_rl(ta, size, nd=nd), resize_rl(tb, size, nd=nd)
        assert rel_l2(ta, ja) < tol and rel_l2(tb, jb) < tol, (radius, rel_l2(ta, ja),
                                                               rel_l2(tb, jb))


def test_mkb_2d_round_insertion_and_maps_match_jax():
    """2D with reco_kernel "mkb", as thunder_tpu runs it: the exact
    bilinear insertion (HK6's plain twin against thunder_tpu's packed
    scatter and Hermitian fold) and the blob's 2D correction."""
    from test_torch_2d import K as k, N as n, SIZE as size, config as cfg_2d

    _, imgs, ctf, _, _, _ = make_dataset_2d(size, n, k, seed=3, snr=8.0, device="cpu")
    jopt = jo.Optimiser(cfg_2d(JConfig, reco_kernel="mkb"), imgs, jctf_params(*ctf),
                        np.zeros(n, np.int64))
    topt = to.Optimiser(cfg_2d(TConfig, reco_kernel="mkb"), imgs, tuple(ctf),
                        np.zeros(n, np.int64), device="cpu")
    interop.restore(topt, interop.snapshot(jopt))
    rng = np.random.default_rng(4)
    n_l, n_s = topt.n_img, 48
    phi = rng.uniform(0, 2 * np.pi, (2, n_l, n_s))
    q = np.stack([np.cos(phi), np.sin(phi), 0 * phi, 0 * phi], -1).astype(np.float32)
    tr_ = rng.normal(0, 0.5, (2, n_l, n_s, 2)).astype(np.float32)
    w = (np.full((2, n_l, n_s), 1.0 / n_s) * np.asarray(topt.valid)[..., None]).astype(np.float32)
    f2, t2, r_u, gs = topt.reconstruct_round(draws=(t(q), t(tr_), None, t(w)))
    rings = jpack_rings(size, r_u, 0)
    cls = np.asarray(jopt.state.cls)
    w_l = (cls[:, None, :, None] == np.arange(k)[None, :, None, None]) * w[:, None]
    jf, jt = jo._insert_all_h(
        jopt.data.ft_ori, jopt.data.ctf_params, rings.mask, rings.i_col, rings.i_row,
        jnp.asarray(q), jnp.asarray(tr_) - jopt.offset[:, :, None, :],
        jnp.ones(w.shape, jnp.float32), jnp.asarray(w_l, jnp.float32),
        jopt.sym.matrices, jnp.asarray((r_u - 1) * 2, jnp.float32), size, 2, True, 1, gs,
        float(topt.cfg.pixel_size), False, r_u, "mkb")
    assert rel_l2(f2, jf) < 2e-2 and rel_l2(t2, jt) < 2e-2, (rel_l2(f2, jf), rel_l2(t2, jt))
    assert_maps_match(f2, t2, r_u, gs, size, 2)


def test_mkb_refuses_a_layout_whose_grids_shard():
    """thunder_tpu's ValueError at configuration time (optimiser.py:
    1859-1878): 3D, a data extent over 1 and grids of vol_shard_min_mb
    or more; trilinear insertion, 2D, one data rank or smaller grids
    pass."""
    size, n = 16, 8
    imgs = np.random.default_rng(0).standard_normal((n, size, size)).astype(np.float32)
    lay = Layout(world=4, rank=0, hemi=2, data=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="mkb"):
        to.Optimiser(config(size, TConfig, reco_kernel="mkb", vol_shard_min_mb=0), imgs,
                     ctf_cols(n), np.zeros(n, np.int64), device="cpu", layout=lay)
    for cfg, data in ((config(size, TConfig, vol_shard_min_mb=0), 2),
                      (config(size, TConfig, mode="2D", reco_kernel="mkb",
                              vol_shard_min_mb=0), 2),
                      (config(size, TConfig, reco_kernel="mkb", vol_shard_min_mb=0), 1),
                      (config(size, TConfig, reco_kernel="mkb"), 2)):
        to.check_kernel_layout(cfg, Layout(world=2 * data, rank=0, hemi=2, data=data))


def test_mkb_rounds_run_in_the_port():
    """Three 3D rounds with reco_kernel "mkb" (global search, then the
    state machine) and two 2D rounds: finite maps, the records of a
    trilinear run's shape."""
    from test_torch_2d import K, N, SIZE, config as cfg_2d

    size, n = 24, 32
    phantom, imgs, _, _ = make_3d_dataset(size, n, seed=3)
    opt = to.Optimiser(config(size, TConfig, reco_kernel="mkb", m_s=256, m_l_r=12),
                       imgs, ctf_cols(n), np.zeros(n, np.int64), init_refs=phantom,
                       device="cpu")
    for i in range(3):
        rec = opt.run_round(i)
        assert np.isfinite(rec["res_A"]) and np.isfinite(opt.state.refs.numpy()).all()
    _, imgs2, ctf2, _, _, _ = make_dataset_2d(SIZE, N, K, seed=3, snr=8.0, device="cpu")
    opt2 = to.Optimiser(cfg_2d(TConfig, reco_kernel="mkb"), imgs2, tuple(ctf2),
                        np.zeros(N, np.int64), device="cpu")
    for i in range(2):
        opt2.run_round(i)
        assert np.isfinite(opt2.class_averages()).all()
