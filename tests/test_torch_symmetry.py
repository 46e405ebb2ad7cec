"""Point-group symmetry in the port's 3D path, against thunder_tpu on the
CPU: the plain version of HK7 (symmetrize_ft on F and on T) on seeded
grids, the global band and grid with a group, the fold of the rank-1
rotation into the asymmetric unit, the stages of a C4 round (the same
draws inserted and symmetrised by both packages), and both THUNDER 3D
demo configs accepted as they stand."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu import particle as jpt  # noqa: E402
from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.geometry.symmetry import Symmetry as JSymmetry  # noqa: E402
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu.recon.reconstructor import symmetrize_ft as jsymmetrize  # noqa: E402
from thunder_tpu_torch import interop  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch import particle as tpt  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402
from thunder_tpu_torch.geometry.symmetry import Symmetry as TSymmetry  # noqa: E402
from thunder_tpu_torch.recon import reconstructor as trec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_e2e_3d import make_3d_dataset  # noqa: E402
from test_torch_slice import close, config, ctf_cols, t  # noqa: E402


@pytest.mark.parametrize("sym", ["C4", "D2"])
@pytest.mark.parametrize("big", [24, 32])
def test_symmetrize_ft_plain_matches_jax(sym, big):
    """The cases of tests/test_symmetrize.py (seeded complex grids, the
    cut three cells inside the face) and a cut past the faces, F and T of
    two grids at once; 1e-5 of the largest value: the same coordinates,
    weights and tap order in float32."""
    rng = np.random.default_rng(0)
    f = (rng.normal(size=(2, big, big, big))
         + 1j * rng.normal(size=(2, big, big, big))).astype(np.complex64)
    tt = rng.random((2, big, big, big)).astype(np.float32)
    jmats = JSymmetry(sym).matrices
    tmats = TSymmetry(sym).matrices
    np.testing.assert_allclose(tmats.numpy(), np.asarray(jmats), atol=1e-7)
    for radius in (big // 2 - 3, big):
        fo, to_ = trec.symmetrize_ft(t(f), t(tt), tmats, float(radius))
        for g in range(2):
            close(fo[g], jsymmetrize(jnp.asarray(f[g]), jmats, radius), 1e-5)
            close(to_[g], jnp.real(jsymmetrize(jnp.asarray(tt[g]).astype(jnp.complex64),
                                               jmats, radius)), 1e-5)
    # the symmetrised grid is invariant under the group's generator, up to
    # the blur of one more trilinear resampling (test_symmetrize.py)
    fo, _ = trec.symmetrize_ft(t(f[:1]), t(tt[:1]), tmats, float(big // 2 - 3))
    again, _ = trec.symmetrize_ft_plain(fo, t(tt[:1]), tmats[:2], float(big // 2 - 5))
    k = np.arange(big) - big // 2
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    inside = kx ** 2 + ky ** 2 + kz ** 2 < (big // 2 - 5) ** 2
    a, b = fo[0].numpy()[inside], (again - fo)[0].numpy()[inside]
    corr = np.corrcoef(np.concatenate([a.real, a.imag]), np.concatenate([b.real, b.imag]))[0, 1]
    assert corr > 0.9, corr


def test_symmetrize_ft_is_the_identity_for_c1():
    f = torch.randn(8, 8, 8, dtype=torch.complex64)
    tt = torch.rand(8, 8, 8)
    fo, to_ = trec.symmetrize_ft(f, tt, TSymmetry("C1").matrices, 3.0)
    assert fo is f and to_ is tt
    assert trec.symmetrize_ft.launches == 0


@pytest.mark.parametrize("sym,n_rot", [("C4", 2560), ("D2", 2560), ("C1", 10240)])
def test_global_band_and_grid_with_symmetry(monkeypatch, sym, n_rot):
    """configs/demo_3D.json as it stands (160 px, K = 4) but for the
    group: r_global shrinks with (1 + n_sym)^(1/3) and the global grid
    draws mS / (1 + n_sym) rotations, rounded up to blocks of 256, in both
    packages; the port's Optimiser takes K = 4 and the group."""
    path = os.path.join(REPO, "configs", "demo_3D.json")
    jc = dataclasses.replace(JConfig.from_json(path), sym=sym)
    tc = dataclasses.replace(TConfig.from_json(path), sym=sym)
    assert (tc.k, tc.size) == (4, 160)
    assert tc.r_global == jc.r_global and tc.r_init == jc.r_init
    n = 4
    imgs = np.random.default_rng(1).standard_normal((n, 160, 160)).astype(np.float32)
    topt = to.Optimiser(tc, imgs, ctf_cols(n), np.zeros(n, np.int64), device="cpu")
    assert topt.state.refs.shape == (2, 4, 160, 160, 160)
    assert topt.sym.order == JSymmetry(sym).order
    seen = {}

    class Drawn(Exception):
        pass

    def grid_of(table, rot, rings, dw, s2, a, tra, pf):
        seen["port"] = (rot.shape[0] * rot.shape[1], tra.shape[-2])
        raise Drawn

    monkeypatch.setattr(to, "global_search", grid_of)
    monkeypatch.setattr(topt, "proj_table", lambda r_u: [None, None])
    with pytest.raises(Drawn):
        topt.expectation_global(topt._rings())
    n_jax = max(1, jc.n_rot_global // (1 + JSymmetry(sym).n_elements))
    assert seen["port"] == (jo._round_up(n_jax, 256), 151) == (n_rot, 151)


def test_demo_config_is_accepted_as_it_stands():
    """configs/demo.json (K = 1, C4, CTF search, core FSC, grading): the
    defocus support takes mLD points and the guards are gone."""
    tc = TConfig.from_json(os.path.join(REPO, "configs", "demo.json"))
    assert tc.c_search and tc.sym == "C4" and tc.core_fsc and tc.par_gra
    assert (tc.m_l_d, tc.ctf_refine_s, tc.perturb_factor_s_ctf) == (9, 0.01, 0.5)
    n = 4
    imgs = np.random.default_rng(2).standard_normal((n, 160, 160)).astype(np.float32)
    topt = to.Optimiser(tc, imgs, ctf_cols(n), np.zeros(n, np.int64), device="cpu")
    assert topt.state.par.d.shape == (2, 2, 9) and topt.sym.order == 4


@pytest.mark.parametrize("sym", ["C4", "D2"])
def test_symmetrise_top_matches_jax(sym):
    """The rank-1 rotation folded into the asymmetric unit after the
    phase loop (thunder_tpu's _finish_phases with fold_sym)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    b = (2, 16)
    one = np.ones(b, np.float32)
    fields = dict(r=q[:, :, None], t=np.zeros(b + (1, 2), np.float32), d=one[..., None],
                  w_r=one[..., None], w_t=one[..., None], w_d=one[..., None],
                  u_r=one[..., None], u_t=one[..., None], u_d=one[..., None], top_r=q,
                  top_t=np.zeros(b + (2,), np.float32), top_d=one,
                  k1=rng.random(b).astype(np.float32) + 0.1, k2=one * 0.3, k3=one * 0.2,
                  s0=one, s1=one, s_d=one * 0, score=one * 0)
    jpar = jpt.ParticleState(**{k: jnp.asarray(v) for k, v in fields.items()})
    tpar = tpt.ParticleState(**{k: t(v) for k, v in fields.items()})
    jout = jo._finish_phases_h(jpar, JSymmetry(sym).quats, jpt.MODE_3D, True)
    tout = tpt.symmetrise_top(tpt.cal_score(tpar), TSymmetry(sym))
    # a quaternion and its negative are one rotation
    jq, tq = np.asarray(jout.top_r), tout.top_r.numpy()
    sign = np.sign(np.sum(jq * tq, -1, keepdims=True))
    np.testing.assert_allclose(tq * sign, jq, atol=1e-5)
    np.testing.assert_allclose(tout.score.numpy(), np.asarray(jout.score), rtol=1e-5)
    assert not np.allclose(np.abs(np.sum(tq * q, -1)), 1.0, atol=1e-3)


@pytest.fixture(scope="module")
def c4_pair():
    """A JAX and a port Optimiser with symmetry C4 on the same 24 px
    data, the port started from the JAX state."""
    size, n = 24, 32
    phantom, imgs, quats, trans = make_3d_dataset(size, n, seed=3)
    jopt = jo.Optimiser(config(size, sym="C4"), imgs, jctf_params(*ctf_cols(n)),
                        np.zeros(n, np.int64), init_refs=phantom)
    topt = to.Optimiser(config(size, TConfig, sym="C4"), imgs, ctf_cols(n),
                        np.zeros(n, np.int64), init_refs=phantom, device="cpu")
    par = jopt.state.par
    jopt.state.par = par._replace(
        top_r=jnp.asarray(np.asarray(quats)[jopt.index], jnp.float32),
        top_t=jnp.asarray(np.asarray(trans)[jopt.index], jnp.float32))
    interop.restore(topt, interop.snapshot(jopt))
    return jopt, topt


def test_c4_round_insertion_and_symmetrisation(c4_pair):
    """The same draws through the port's reconstruct_round (HK11's and
    HK7's plain versions) and through thunder_tpu's shear sweep
    (insert_sweep_3d, the rounds' insertion) followed by its
    symmetrize_ft on F and on T, within twice the distance of thunder_tpu's
    bf16 sweep from the float64 map (test_torch_insert_sweep.py); then the
    two-pass reconstruction of both from the port's grids."""
    jopt, topt = c4_pair
    assert topt.model.r_global == jopt.model.r_global and topt.sym.order == 4
    rng = np.random.default_rng(5)
    n_l, n_s = topt.n_img, 10
    q = np.repeat(np.asarray(jopt.state.par.top_r)[:, :, None], n_s, 2)
    q = q + 0.3 * rng.standard_normal(q.shape)
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr = rng.normal(0, 0.5, (2, n_l, n_s, 2)).astype(np.float32)
    w = np.full((2, n_l, n_s), 1.0 / n_s, np.float32)
    f2, t2, r_u, gs = topt.reconstruct_round(draws=(t(q), t(tr), None, t(w)))
    from test_torch_insert_sweep import thunder_sweep
    from thunder_tpu_torch.ops.insert import dense_slice_values
    big = gs * 2
    mats = JSymmetry("C4").matrices
    rad = float((r_u - 1) * 2)
    sym = lambda f, t_: (jsymmetrize(f, mats, rad),
                         jnp.real(jsymmetrize(t_.astype(jnp.complex64), mats, rad)))
    for h in (0, 1):
        valid = np.asarray(topt.valid[h], np.float32)
        vals, c2w, _, _ = dense_slice_values(
            topt.data.ft_ori[h], topt.data.ctf_params.map(lambda a: a[h]),
            t(np.repeat(np.arange(n_l), n_s)),
            t((tr[h] - np.asarray(topt.offset[h])[:, None]).reshape(-1, 2)),
            t((w[h] * valid[:, None]).reshape(-1)), r_u, 24, 1.0)
        fj, tj, tol = thunder_sweep(vals.numpy(), c2w.numpy(),
                                    jo.rotate3d(jnp.asarray(q[h].reshape(-1, 4))), big, 2, sym)
        close(f2[h, 0], fj, tol[0])
        close(t2[h, 0], tj, tol[1])
    ja, _ = jo._reconstruct_two_h(jnp.asarray(f2.numpy()), jnp.asarray(t2.numpy()),
                                  jnp.ones((1, 10), jnp.float32), gs, 2, r_u, 24)
    ta, _ = trec.reconstruct_two_pass(f2, t2, torch.ones(1, 10), gs, 2, r_u)
    if gs != 24:
        from thunder_tpu_torch.ops.fourier import resize_rl
        ta = resize_rl(ta, 24, nd=3)
    # the tolerance of test_torch_slice's reconstruction parity (cells of
    # T left empty between slices; fewer with three mates filling them)
    a, b = ta.numpy(), np.asarray(ja)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2
    # the reconstructed map has the group's symmetry: a quarter turn about
    # z (FFT layout, axes z, y, x) leaves it nearly unchanged (32 noisy
    # images, and a trilinear resampling between the mates)
    m = np.fft.fftshift(a[0, 0])[1:, 1:, 1:]
    assert np.corrcoef(m.ravel(), np.rot90(m, 1, axes=(1, 2)).ravel())[0, 1] > 0.85


def test_recentre_acts_for_cn_groups_only(c4_pair):
    """_recentre shifts the references for Cn groups and leaves them for
    the others (thunder_tpu optimiser.py:3336-3337), by the same shift."""
    jopt, topt = c4_pair
    refs = topt.state.refs
    shifted = topt._recentre(refs)
    close(shifted, jopt._recentre(jopt.state.refs), 1e-4)
    assert float((shifted - refs).abs().max()) > 0
    for opt, sym_cls in ((topt, TSymmetry), (jopt, JSymmetry)):
        keep = opt.sym
        opt.sym = sym_cls("D2")
        try:
            same = opt._recentre(opt.state.refs)
        finally:
            opt.sym = keep
        assert same is opt.state.refs


def test_c4_rounds_run_in_the_port():
    """Two whole C4 rounds at 24 px on the CPU: finite symmetric maps."""
    from thunder_tpu_torch.pipeline.synthetic import make_dataset

    size, n = 24, 32
    vol, imgs, ctf, _, _ = make_dataset(size, n, seed=2, device="cpu", kind="sharp", sym="C4")
    opt = to.Optimiser(config(size, TConfig, sym="C4", m_s=256, m_l_r=12, m_reco=8,
                              pixel_size=1.32), imgs, tuple(ctf), np.zeros(n, np.int64),
                       init_refs=vol, device="cpu")
    for i in range(2):
        rec = opt.run_round(i)
        assert np.isfinite(rec["res_A"])
    refs = opt.state.refs.numpy()
    assert np.isfinite(refs).all()
    m = np.fft.fftshift(refs[0, 0])[1:, 1:, 1:]
    assert np.corrcoef(m.ravel(), np.rot90(m, 1, axes=(1, 2)).ravel())[0, 1] > 0.9


def test_mask_covering_the_whole_box_raises():
    """A mask radius past the box's corners leaves no background pixel
    (preprocess_images would divide by a zero count): the port says so
    at construction."""
    size, n = 16, 4
    imgs = np.zeros((n, size, size), np.float32)
    ok = config(size, TConfig, mask_radius=size * 0.42)
    to.Optimiser(ok, imgs, ctf_cols(n), np.zeros(n, np.int64), device="cpu")
    bad = config(size, TConfig, mask_radius=size * 0.75)
    with pytest.raises(ValueError, match="Radius of Mask"):
        to.Optimiser(bad, imgs, ctf_cols(n), np.zeros(n, np.int64), device="cpu")
