"""3D classification (K > 1) in the port on the CPU: the workload of
tests/test_e2e_3d_classify.py (24 px, 64 images of two species, K = 2)
with its separation criterion, one grid a class and hemisphere out of
the insertion, the stages of a K = 2, C4 round against thunder_tpu from
the same state (per-class global search, insertion and symmetrisation,
the two-pass reconstruction with per-class FSC and re-centring, class
rebirth), and the per-class files of the CLI."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu.geometry.quaternion import random_quat  # noqa: E402
from thunder_tpu.geometry.symmetry import Symmetry as JSymmetry  # noqa: E402
from thunder_tpu.ops.projector import ri_split  # noqa: E402
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu.recon.reconstructor import symmetrize_ft as jsymmetrize  # noqa: E402
from thunder_tpu_torch import interop  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402
from thunder_tpu_torch.physics.mask import radial_grid  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_e2e_3d_classify import make_two_phantom_dataset  # noqa: E402
from test_torch_slice import close, config, ctf_cols, t  # noqa: E402


def test_3d_classification_separates_species():
    """Six rounds from blank references and random classes: the classes
    agree with the species for at least 0.8 of the images in some round,
    and each class average matches its own phantom better than the other
    (the thresholds of thunder_tpu's own test, 0.8 and 1.35)."""
    size, n = 24, 64
    phantoms, imgs, truth = make_two_phantom_dataset(size, n)
    cfg = TConfig(mode="3D", k=2, size=size, pixel_size=1.0, mask_radius=10.0, trans_s=1.0,
                  init_res=3.0, global_search_res=2.4, sym="C1", m_s=1024, m_l_r=16, m_l_t=9,
                  m_reco=12, ignore_res=size * 1.0, trans_search_factor=0.25, seed=0,
                  ref_auto_recentre=False)
    ctf = (np.full(n, 300e3), np.full(n, 500.0), np.full(n, 500.0), np.zeros(n),
           np.full(n, 2e7), np.full(n, 0.1), np.zeros(n))
    opt = to.Optimiser(cfg, imgs, ctf, np.zeros(n, np.int64), device="cpu")
    best = 0.0
    for i in range(6):
        rec = opt.run_round(i)
        assert np.isfinite(rec["res_A"])
        cls = opt.class_assignments()
        best = max(best, float(max((cls == truth).mean(), (cls != truth).mean())))
    assert best >= 0.8, f"3D class agreement {best}"
    m = radial_grid(size, 3) < size // 2 - 4
    avgs = opt.class_averages()
    assert avgs.shape == (2, size, size, size)
    corr = np.array([[np.corrcoef(avgs[a][m], phantoms[b][m])[0, 1] for b in range(2)]
                     for a in range(2)])
    assert max(corr[0, 0] + corr[1, 1], corr[0, 1] + corr[1, 0]) > 1.35, corr
    assert opt.model.fsc.shape[0] == 2


def test_insertion_fills_one_grid_a_class_and_hemisphere():
    """reconstruct_round with K = 3: the slices of a class land in that
    class's grid only (an empty class leaves zeros), and the grids sum to
    the one grid a K = 1 insertion of the same draws fills."""
    from thunder_tpu_torch.pipeline.synthetic import make_dataset

    size, n = 16, 24
    vol, imgs, ctf, _, _ = make_dataset(size, n, seed=3, device="cpu")
    kw = dict(mode="3D", size=size, pixel_size=1.32, mask_radius=size * 1.32 * 0.42,
              trans_s=1.5, init_res=size * 1.32 / 4, global_search_res=size * 1.32 / 6,
              sym="C1", m_s=128, m_l_r=8, m_l_t=4, m_reco=6, ignore_res=size * 1.32)
    opt3 = to.Optimiser(TConfig(k=3, **kw), imgs, tuple(ctf), np.zeros(n, np.int64),
                        init_refs=vol, device="cpu", seed=1)
    opt1 = to.Optimiser(TConfig(k=1, **kw), imgs, tuple(ctf), np.zeros(n, np.int64),
                        init_refs=vol, device="cpu", seed=1)
    n_l = opt3.n_img
    opt3.state.cls = torch.as_tensor(np.arange(2 * n_l).reshape(2, n_l) % 2 * 2)  # 0 or 2
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, n_l, 5, 4, generator=g)
    q = q / q.norm(dim=-1, keepdim=True)
    draws = (q, torch.randn(2, n_l, 5, 2, generator=g), None, torch.full((2, n_l, 5), 0.2))
    f3, t3, r_u, gs = opt3.reconstruct_round(draws=draws)
    f1, t1, _, _ = opt1.reconstruct_round(draws=draws)
    assert f3.shape == (2, 3) + (gs * 2,) * 3 and f1.shape[1] == 1
    assert float(f3[:, 1].abs().max()) == 0 and float(t3[:, 1].abs().max()) == 0
    assert float(t3[:, 0].max()) > 0 and float(t3[:, 2].max()) > 0
    torch.testing.assert_close(f3.sum(1), f1[:, 0], rtol=1e-4, atol=1e-4 * float(f1.abs().max()))
    torch.testing.assert_close(t3.sum(1), t1[:, 0], rtol=1e-4, atol=1e-4 * float(t1.max()))


@pytest.fixture(scope="module")
def k2_pair():
    """A JAX and a port Optimiser with K = 2 and symmetry C4 on the same
    24 px images of two species, one reference a species, every image in
    its species' class with a small rank-1 shift; the port started from
    the JAX state."""
    size, n = 24, 32
    phantoms, imgs, truth = make_two_phantom_dataset(size, n)
    refs = np.stack(phantoms)
    kw = dict(k=2, sym="C4")
    jopt = jo.Optimiser(config(size, **kw), imgs, jctf_params(*ctf_cols(n)),
                        np.zeros(n, np.int64), init_refs=refs)
    topt = to.Optimiser(config(size, TConfig, **kw), imgs, ctf_cols(n),
                        np.zeros(n, np.int64), init_refs=refs, device="cpu")
    shifts = np.random.default_rng(7).normal(0.3, 0.5, (n, 2))
    jopt.state.cls = jnp.asarray(truth[np.asarray(jopt.index)], jopt.state.cls.dtype)
    jopt.state.par = jopt.state.par._replace(
        top_t=jnp.asarray(shifts[np.asarray(jopt.index)], jnp.float32))
    interop.restore(topt, interop.snapshot(jopt))
    assert set(topt.state.cls.numpy().ravel()) == {0, 1}
    return jopt, topt


def test_k2_global_search_matches_jax(k2_pair):
    """The class, rotation and translation weights of a global search
    over two classes' tables, on an injected grid, against thunder_tpu's
    _global_search_h on float32 tables; 2e-4 as for one class."""
    from thunder_tpu.ops.projector import prepare_projectee_3d_cropped as jcrop

    jopt, topt = k2_pair
    rings = jopt._rings()
    quats = np.asarray(random_quat(jax.random.PRNGKey(1), (2, 64)))
    trans = np.random.default_rng(2).normal(0, 1.5, (2, 30, 2)).astype(np.float32)
    dat_w, sctf2, a_term = jopt._pack_inputs(rings)
    tra = jax.vmap(lambda tr: jo.translate_phases(rings, tr))(jnp.asarray(trans))
    crop = jo._proj_crop_size(24, 2, rings.r_u)
    f32 = jnp.stack([ri_split(jnp.stack([jcrop(jopt.state.refs[h, k], 2, crop)
                                         for k in (0, 1)]), pack_bf16=False)
                     for h in (0, 1)])
    rot = jax.vmap(jax.vmap(lambda q: jo.rotate3d(q)))(jnp.asarray(quats))
    jw = jo._global_search_h(f32, rot.reshape(2, 1, 64, 3, 3), rings.i_col, rings.i_row,
                             dat_w, sctf2, a_term, tra, 24, 2, False, seq=True)
    g = topt.expectation_global(topt._rings(), t(quats), t(trans))
    assert g["w_c"].shape[-1] == 2
    for a, b in zip((g["w_c"], g["w_r"], g["w_t"]), jw):
        close(a, b, 2e-4)
    # the two classes' tables differ, so the class weights tell them apart
    w_c = g["w_c"].numpy()
    assert np.abs(w_c[..., 0] - w_c[..., 1]).max() > 0.1 * w_c.max()


def k2_draws(topt):
    rng = np.random.default_rng(5)
    n_l, n_s = topt.n_img, 10
    q = rng.standard_normal((2, n_l, n_s, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr = rng.normal(0, 0.5, (2, n_l, n_s, 2)).astype(np.float32)
    return q, tr, np.full((2, n_l, n_s), 1.0 / n_s, np.float32)


def test_k2_insertion_and_symmetrisation_match_jax(k2_pair):
    """reconstruct_round at K = 2, C4: the port's grid of hemisphere h
    and class k against thunder_tpu's insert_slices_3d of that class's
    slices of the same draws followed by its symmetrize_ft, F and T, at
    1e-5 (the tolerance of the one-class round)."""
    from thunder_tpu.ops.insert import insert_slices_3d
    from thunder_tpu_torch.ops.insert import dense_slice_values

    jopt, topt = k2_pair
    q, tr, w = k2_draws(topt)
    n_l, n_s = w.shape[1:]
    f2, t2, r_u, gs = topt.reconstruct_round(draws=(t(q), t(tr), None, t(w)))
    big, rad = gs * 2, float((r_u - 1) * 2)
    mats = JSymmetry("C4").matrices
    cls = np.asarray(jopt.state.cls)
    for h in (0, 1):
        valid = np.asarray(topt.valid[h], np.float32)
        for k in (0, 1):
            mine = valid * (cls[h] == k)
            assert mine.sum() > 0
            vals, c2w, vc, vr = dense_slice_values(
                topt.data.ft_ori[h], topt.data.ctf_params.map(lambda a: a[h]),
                t(np.repeat(np.arange(n_l), n_s)),
                t((tr[h] - np.asarray(topt.offset[h])[:, None]).reshape(-1, 2)),
                t((w[h] * mine[:, None]).reshape(-1)), r_u, 24, 1.0)
            fj, tj = insert_slices_3d(
                jnp.zeros((big,) * 3, jnp.complex64), jnp.zeros((big,) * 3, jnp.float32),
                vals.numpy(), c2w.numpy(), jo.rotate3d(jnp.asarray(q[h].reshape(-1, 4))),
                vc.numpy(), vr.numpy(), 2, rad)
            close(f2[h, k], jsymmetrize(fj, mats, rad), 1e-5)
            close(t2[h, k], jnp.real(jsymmetrize(tj.astype(jnp.complex64), mats, rad)), 1e-5)


def test_k2_reconstruction_fsc_and_rebirth_match_jax(k2_pair, monkeypatch):
    """_reconstruct_and_compare of both packages on the same (F, T) grids
    of two classes: the two-pass reconstruction, the re-centring of each
    class by its own images' mean shift, one FSC curve a class and the
    full average of the halves; then class rebirth on the same
    distribution."""
    jopt, topt = k2_pair
    q, tr, w = k2_draws(topt)
    f2, t2, r_u, gs = topt.reconstruct_round(draws=(t(q), t(tr), None, t(w)))
    monkeypatch.setattr(topt, "reconstruct_round", lambda: (f2, t2, r_u, gs))
    monkeypatch.setattr(jopt, "reconstruct_round",
                        lambda: (jnp.asarray(f2.numpy()), jnp.asarray(t2.numpy()), r_u, gs))
    jopt._reconstruct_and_compare({})
    with to._Stages() as stage:
        topt._reconstruct_and_compare({}, stage)
    jf, tf_ = np.asarray(jopt.model.fsc), np.asarray(topt.model.fsc)
    assert jf.shape == tf_.shape and jf.shape[0] == 2
    # the curves come from maps that agree to 2e-2 (below): hold them to
    # 1e-2, and the two classes' curves are not one curve
    assert np.abs(jf - tf_).max() < 1e-2, np.abs(jf - tf_).max()
    assert np.abs(tf_[0] - tf_[1]).max() > 0.05
    assert topt.model.res == jopt.model.res
    a, b = topt.state.refs.numpy(), np.asarray(jopt.state.refs)
    # cells of T left empty between slices (test_torch_slice's tolerance)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2
    np.testing.assert_array_equal(a[0], a[1])          # K > 1: the halves are averaged
    distr = np.array([0.99, 0.01])
    assert topt.balance_classes(distr) == jopt.balance_classes(distr) == [1]
    for refs in (topt.state.refs.numpy(), np.asarray(jopt.state.refs)):
        np.testing.assert_array_equal(refs[:, 1], refs[:, 0])
    assert topt.balance_classes(np.array([0.5, 0.5])) == jopt.balance_classes(
        np.array([0.5, 0.5])) == []


def test_cli_writes_per_class_3d_files(tmp_path):
    """Two rounds of K = 2, C4 at 20 px through the CLI from the
    generator's two sharp species: Reference_NNN_<tag>_Round_NNN.mrc,
    Reference_NNN_Final.mrc and Class_Info_Round_NNN.txt for each class,
    as thunder_tpu's CLI names them."""
    from thunder_tpu_torch.cli.thunder import main
    from thunder_tpu_torch.io.mrc import read_mrc
    from thunder_tpu_torch.io.thu import read_thu
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    size, n = 20, 32
    cfg_path = write_demo(str(tmp_path), n=n, size=size, seed=2, device="cpu", k=2,
                          kind="sharp", sym="C4", defocus_range=(300.0, 700.0))
    with open(cfg_path) as f:
        c = json.load(f)
    assert c["Basic"]["Number of Classes"] == 2 and c["Basic"]["Symmetry"] == "C4"
    c["Advanced"].update({
        "Max Number of Iteration": 2,
        "Number of Sampling Points for Scanning in Global Search (3D)": 256,
        "Number of Sampling Points of Rotation in Local Search (3D)": 12,
        "Number of Sampling Points Used in Reconstruction": 8})
    with open(cfg_path, "w") as f:
        json.dump(c, f)
    truth = np.load(tmp_path / "truth.npy")
    assert set(truth) == {0, 1}
    assert main([cfg_path, "--device", "cpu"]) == 0
    out = tmp_path / "output"
    for i in range(2):
        info = np.loadtxt(out / f"Class_Info_Round_{i:03d}.txt")
        assert info.shape == (2, 3) and abs(info[:, 1].sum() - 1) < 1e-4
        fsc = np.loadtxt(out / f"FSC_Round_{i:03d}.txt")
        assert fsc.shape[1] == 4 and np.isfinite(fsc).all()     # shell, A, one column a class
        for k in range(2):
            for tag in "AB":
                m, _ = read_mrc(str(out / f"Reference_{k:03d}_{tag}_Round_{i:03d}.mrc"))
                assert m.shape == (size,) * 3 and np.isfinite(m).all()
    for k in range(2):
        for name in (f"Reference_{k:03d}_Final.mrc", f"Reference_{k:03d}_A_Final.mrc",
                     f"Reference_{k:03d}_B_Final.mrc"):
            m, _ = read_mrc(str(out / name))
            assert m.shape == (size,) * 3 and np.isfinite(m).all()
    meta = read_thu(str(out / "Meta_Round_001.thu"))
    assert set(np.asarray(meta.class_id)) <= {0, 1}
    local = read_thu(str(tmp_path / "particles_local.thu"))
    assert len(local) == n and float(np.abs(local.quat).sum()) > 0
    assert np.allclose(local.k1, (np.radians(2.0) / 2) ** 2)
