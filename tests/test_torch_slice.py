"""The port's 3D-refinement round as a whole, against thunder_tpu on the
CPU: stage parity from state injected with thunder_tpu_torch.interop,
the global grid's sizes on configs/demo_3D.json, a 3-round 32 px run of both packages on the same data (FSC-0.143
shells within one per round), the port's CLI writing its files, and the
whole port importing and running with jax blocked."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.geometry.quaternion import random_quat  # noqa: E402
from thunder_tpu.ops.fourier import pack_rings  # noqa: E402
from thunder_tpu.ops.projector import ri_split  # noqa: E402
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu_torch import interop  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402
from thunder_tpu_torch.model import SEARCH_TYPE_LOCAL  # noqa: E402
from thunder_tpu_torch.ops import fourier as tf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_e2e_3d import make_3d_dataset  # noqa: E402


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= rtol, err


def config(size, cls=JConfig, **kw):
    """A 3D config of thunder_tpu's (or, with ``cls=TConfig``, the
    port's) ThunderConfig; both from the same arguments."""
    base = dict(mode="3D", k=1, size=size, pixel_size=1.0, mask_radius=size * 0.42,
                trans_s=1.5, init_res=size / 6, global_search_res=size / 10,
                sym="C1", m_s=512, m_l_r=24, m_l_t=9, m_reco=12,
                ignore_res=float(size), trans_search_factor=0.25)
    base.update(kw)
    return cls(**base)


def ctf_cols(n, defocus=500.0):
    return (np.full(n, 300e3), np.full(n, defocus), np.full(n, defocus), np.zeros(n),
            np.full(n, 2e7), np.full(n, 0.1), np.zeros(n))


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port Optimiser on the same 24 px data, the port
    started from the JAX state through interop."""
    size, n = 24, 32
    phantom, imgs, quats, trans = make_3d_dataset(size, n, seed=3)
    cfg = config(size)
    jopt = jo.Optimiser(cfg, imgs, jctf_params(*ctf_cols(n)), np.zeros(n, np.int64),
                        init_refs=phantom)
    topt = to.Optimiser(config(size, TConfig), imgs, ctf_cols(n), np.zeros(n, np.int64),
                        init_refs=phantom, device="cpu")
    # poses near the truth, so the statistics stages see real signal
    par = jopt.state.par
    q = np.asarray(quats)[jopt.index]
    jopt.state.par = par._replace(top_r=jnp.asarray(q, jnp.float32),
                                  top_t=jnp.asarray(np.asarray(trans)[jopt.index],
                                                    jnp.float32))
    interop.restore(topt, interop.snapshot(jopt))
    return jopt, topt


def test_interop_carries_state(pair):
    jopt, topt = pair
    snap = interop.snapshot(topt)
    np.testing.assert_array_equal(snap["refs"], np.asarray(jopt.state.refs))
    np.testing.assert_array_equal(snap["par_top_r"], np.asarray(jopt.state.par.top_r))
    np.testing.assert_array_equal(snap["sigma"], np.asarray(jopt.state.sigma))
    assert topt.model.r == jopt.model.r and topt.model.r_u == jopt.model.r_u


def test_stage_parity_global_search(pair):
    jopt, topt = pair
    rings = jopt._rings()
    quats = np.asarray(random_quat(jax.random.PRNGKey(1), (2, 64)))
    trans = np.random.default_rng(2).normal(0, 1.5, (2, 30, 2)).astype(np.float32)
    dat_w, sctf2, a_term = jopt._pack_inputs(rings)
    tra = jax.vmap(lambda tr: jo.translate_phases(rings, tr))(jnp.asarray(trans))
    crop = jo._proj_crop_size(24, 2, rings.r_u)
    stack = jo._prepare_projectee_stack_h(jopt.state.refs, 24, 2, False, crop)
    # the same band evaluated as float32 ri tables (not bf16 corner rows)
    from thunder_tpu.ops.projector import prepare_projectee_3d_cropped as jcrop
    f32 = jnp.stack([ri_split(jnp.stack([jcrop(jopt.state.refs[h, 0], 2, crop)]),
                              pack_bf16=False) for h in (0, 1)])
    del stack
    rot = jax.vmap(jax.vmap(lambda q: jo.rotate3d(q)))(jnp.asarray(quats))
    jw = jo._global_search_h(f32, rot.reshape(2, 1, 64, 3, 3), rings.i_col, rings.i_row,
                             dat_w, sctf2, a_term, tra, 24, 2, False, seq=True)
    g = topt.expectation_global(topt._rings(), t(quats), t(trans))
    for a, b in zip((g["w_c"], g["w_r"], g["w_t"]), jw):
        close(a, b, 2e-4)


class _Drawn(Exception):
    """Raised by the stand-ins below once the global grid is drawn."""


def test_global_grid_sizes_match_jax(monkeypatch):
    """configs/demo_3D.json's global grid (mS = 10000, trans 10 px,
    factor 0.25: T = 151) at the symmetry and class count the port runs
    (C1, K = 1), on 24 px data: both packages draw 10,240 rotations (mS
    rounded up to blocks of 256) in 40 blocks of 256 and 151
    translations.  The search itself is stubbed out once the grid is
    drawn."""
    path = os.path.join(REPO, "configs", "demo_3D.json")
    size, n = 24, 8
    kw = dict(sym="C1", k=1, size=size, pixel_size=1.0, mask_radius=size * 0.42,
              init_res=size / 6, global_search_res=size / 10)
    phantom, imgs, _, _ = make_3d_dataset(size, n, seed=3)
    jopt = jo.Optimiser(dataclasses.replace(JConfig.from_json(path), **kw), imgs,
                        jctf_params(*ctf_cols(n)), np.zeros(n, np.int64), init_refs=phantom)
    topt = to.Optimiser(dataclasses.replace(TConfig.from_json(path), **kw), imgs,
                        ctf_cols(n), np.zeros(n, np.int64), init_refs=phantom, device="cpu")
    seen = {}

    def grid_of(name, rot_blocks, tra):
        seen[name] = (tuple(rot_blocks.shape[-4:-2]), tra.shape[-2])
        raise _Drawn

    monkeypatch.setattr(jo, "_global_search_h",
                        lambda stack, rot, ic, ir, dw, s2, a, tra, *r, **k:
                        grid_of("jax", rot, tra))
    monkeypatch.setattr(to, "global_search",
                        lambda table, rot, rings, dw, s2, a, tra, pf: grid_of("port", rot, tra))
    for opt in (jopt, topt):
        with pytest.raises(_Drawn):
            opt.expectation_global(opt._rings())
    assert seen["port"] == seen["jax"] == ((40, 256), 151)


def test_stage_parity_maximization(pair):
    """Sigma and the norm-corrected images (closed-form rescale) against
    _max_stats_h on a float32 table, in a local round (norm on)."""
    jopt, topt = pair
    cfg = jopt.cfg
    r_lo = int(jopt.model.r_u)
    rings = pack_rings(24, r_lo, 0, lane=512)
    rings_hi = pack_rings(24, cfg.max_r, r_lo, lane=512)
    crop = jo._proj_crop_size(24, 2, r_lo)
    from thunder_tpu.ops.projector import prepare_projectee_3d_cropped as jcrop
    f32 = jnp.stack([ri_split(jnp.stack([jcrop(jopt.state.refs[h, 0], 2, crop)]),
                              pack_bf16=False) for h in (0, 1)])
    s = jopt.state
    r_norm = max(min(int(jopt.model.r), jopt.model.resolution_p(0.75)), cfg.r_low + 2)
    r_s = max(2, min(int(jopt.model.r), cfg.res_a2p(cfg.sclCor_res)))
    sigma, s_norm, _ = jo._max_stats_h(
        jopt.data.ft_ori, jopt.data.ctf_params, rings.mask, rings.i_col, rings.i_row,
        rings.i_sig, rings_hi.i_col, rings_hi.i_row, rings_hi.i_sig, rings_hi.mask,
        f32, s.cls, s.par.top_r, s.par.top_t - jopt.offset, jopt.data.group_id,
        jopt.valid_dev, s.sigma, jnp.asarray(cfg.r_low), jnp.asarray(r_norm),
        jnp.asarray(r_s), 24, 2, False, cfg.max_r, 1, float(cfg.pixel_size),
        True, False)
    ft_before = topt.data.ft_ori.clone()
    topt.model.search_type = SEARCH_TYPE_LOCAL
    try:
        topt.maximization_stats(1)
    finally:
        topt.model.search_type = jopt.model.search_type
    close(topt.state.sigma, sigma, 1e-4)
    close((topt.data.ft_ori / ft_before)[..., 1, 1].real, s_norm, 1e-4)
    interop.restore(topt, interop.snapshot(jopt))


def test_stage_parity_reconstruction_and_fsc(pair):
    """Same draws inserted by the port's round (HK11's plain version)
    and by thunder_tpu's shear sweep (insert_sweep_3d), within twice the
    distance of thunder_tpu's bf16 sweep from the float64 map
    (test_torch_insert_sweep.py), then the two-pass reconstruction and
    the hemisphere FSC."""
    jopt, topt = pair
    rng = np.random.default_rng(5)
    n_l, n_s = topt.n_img, 12
    q = np.repeat(np.asarray(jopt.state.par.top_r)[:, :, None], n_s, 2)
    q = q + 0.3 * rng.standard_normal(q.shape)
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr = rng.normal(0, 0.5, (2, n_l, n_s, 2)).astype(np.float32)
    w = np.full((2, n_l, n_s), 1.0 / n_s, np.float32)
    f2, t2, r_u, gs = topt.reconstruct_round(draws=(t(q), t(tr), None, t(w)))
    # JAX side: its sweep over the same dense values
    from test_torch_insert_sweep import thunder_sweep
    from thunder_tpu_torch.ops.insert import dense_slice_values
    big = gs * 2
    for h in (0, 1):
        valid = np.asarray(topt.valid[h], np.float32)
        ww = (w[h] * valid[:, None]).reshape(-1)
        img = np.repeat(np.arange(n_l), n_s)
        vals, c2w, _, _ = dense_slice_values(
            topt.data.ft_ori[h], topt.data.ctf_params.map(lambda a: a[h]), t(img),
            t((tr[h] - np.asarray(topt.offset[h])[:, None]).reshape(-1, 2)), t(ww),
            r_u, 24, 1.0)
        rot = jo.rotate3d(jnp.asarray(q[h].reshape(-1, 4)))
        fj, tj, tol = thunder_sweep(vals.numpy(), c2w.numpy(), rot, big, 2)
        close(f2[h, 0], fj, tol[0])
        close(t2[h, 0], tj, tol[1])
    fsc_prev = jnp.ones((1, 10), jnp.float32)
    ja, jb = jo._reconstruct_two_h(jnp.asarray(f2.numpy()), jnp.asarray(t2.numpy()),
                                   fsc_prev, gs, 2, r_u, 24)
    from thunder_tpu_torch.recon.reconstructor import reconstruct_two_pass
    ta, tb = reconstruct_two_pass(f2, t2, torch.ones(1, 10), gs, 2, r_u)
    if gs != 24:
        ta, tb = tf.resize_rl(ta, 24, nd=3), tf.resize_rl(tb, 24, nd=3)
    # cells of T left empty between slices: W grows there in both packages
    # after the sweep, and near them the balance loop amplifies float32
    # rounding of the FFTs: hold the maps to a relative L2 error and the
    # FSC curve to 5e-3
    for a, b in ((ta, ja), (tb, jb)):
        a, b = a.numpy(), np.asarray(b)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2
    from thunder_tpu.physics.spectrum import fsc as jfsc
    fa = jnp.fft.fftshift(jnp.fft.fftn(ja[0, 0]))
    fb = jnp.fft.fftshift(jnp.fft.fftn(ja[1, 0]))
    curve, _, _ = to.compare_refs(ta[0], ta[1], 10, want_avg=False)
    close(curve[0], jfsc(fa, fb, 10), 5e-3)


def test_three_rounds_track_jax_fsc_shells():
    """3 rounds of both packages on the same 32 px data, resumed from the
    true poses with the same init model: the FSC-0.143 shell of each
    round within one shell.  The RNG streams differ, so the data are
    clean and plentiful enough (96 images, SNR 12) that the crossing is
    set by the data rather than by the poses each run happened to draw."""
    from thunder_tpu.io.thu import ThuTable

    size, n = 32, 96
    phantom, imgs, quats, trans = make_3d_dataset(size, n, seed=0, snr=12.0)
    thu = ThuTable.blank(n, voltage=300e3)
    thu.quat, thu.trans = np.asarray(quats), np.asarray(trans)
    thu.std_trans = np.full((n, 2), 0.3)
    thu.k1 = thu.k2 = thu.k3 = np.full(n, 3e-6)
    kw = dict(g_search=False, m_s=256, m_l_r=16, m_reco=8)
    jopt = jo.Optimiser(config(size, **kw), imgs, jctf_params(*ctf_cols(n)),
                        np.zeros(n, np.int64), init_refs=phantom, resume_thu=thu)
    topt = to.Optimiser(config(size, TConfig, **kw), imgs, ctf_cols(n), np.zeros(n, np.int64),
                        init_refs=phantom, resume_thu=thu, device="cpu")
    for i in range(3):
        rj, rt = jopt.run_round(i), topt.run_round(i)
        assert (rj["r"], rj["search_type_after"]) == (rt["r"], rt["search_type_after"])
        assert abs(rj["res_shell"] - rt["res_shell"]) <= 1, (i, rj, rt)
        assert np.isfinite(topt.state.refs.numpy()).all()


def test_checkpoint_resumes_the_same_round(tmp_path):
    """A run restored from save_checkpoint after round 0 repeats round 1
    of the uninterrupted run exactly (same state, same generator)."""
    from thunder_tpu_torch.pipeline.synthetic import make_dataset

    size, n = 16, 16
    vol, imgs, ctf, _, _ = make_dataset(size, n, seed=4, device="cpu")
    kw = dict(m_s=256, m_l_r=12, m_reco=8, pixel_size=1.32)

    def fresh():
        return to.Optimiser(config(size, TConfig, **kw), imgs, tuple(ctf), np.zeros(n, np.int64),
                            init_refs=vol, device="cpu")

    a = fresh()
    a.run_round(0)
    path = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(path)
    ra = a.run_round(1)
    b = fresh()
    b.load_checkpoint(path)
    rb = b.run_round(1)
    for key in ("r", "n_phases", "res_shell", "search_type_after"):
        assert ra[key] == rb[key], key
    np.testing.assert_array_equal(a.state.refs.numpy(), b.state.refs.numpy())
    np.testing.assert_array_equal(a.model.fsc, b.model.fsc)


def _write_tiny_demo(tmp_path, size=20, n=24, rounds=2):
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    cfg_path = write_demo(str(tmp_path), n=n, size=size, seed=1, device="cpu")
    with open(cfg_path) as f:
        c = json.load(f)
    c["Advanced"].update({
        "Max Number of Iteration": rounds,
        "Number of Sampling Points for Scanning in Global Search (3D)": 256,
        "Number of Sampling Points of Rotation in Local Search (3D)": 12,
        "Number of Sampling Points Used in Reconstruction": 8})
    with open(cfg_path, "w") as f:
        json.dump(c, f)
    return cfg_path


def test_cli_writes_round_files(tmp_path):
    from thunder_tpu.io.mrc import read_mrc
    from thunder_tpu.io.thu import read_thu
    from thunder_tpu_torch.cli.thunder import main

    cfg_path = _write_tiny_demo(tmp_path)
    assert main([cfg_path, "--device", "cpu"]) == 0
    out = tmp_path / "output"
    for i in range(2):
        for name in (f"FSC_Round_{i:03d}.txt", f"Class_Info_Round_{i:03d}.txt",
                     f"Meta_Round_{i:03d}.thu", f"Reference_000_A_Round_{i:03d}.mrc",
                     f"Reference_000_B_Round_{i:03d}.mrc"):
            assert (out / name).exists(), name
        assert np.isfinite(np.loadtxt(out / f"FSC_Round_{i:03d}.txt")).all()
    final, _ = read_mrc(str(out / "Reference_000_Final.mrc"))
    assert final.shape == (20, 20, 20) and np.isfinite(final).all()
    assert len(read_thu(str(out / "Meta_Round_001.thu"))) == 24
    recs = [json.loads(x) for x in open(out / "round_metrics.jsonl")]
    assert [r["round"] for r in recs] == [0, 1]


_BLOCKED = r"""
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["thunder_tpu"] = None  # and so does any import of the JAX package
import importlib, pkgutil, torch
torch.set_num_threads(2)
import thunder_tpu_torch
for m in pkgutil.walk_packages(thunder_tpu_torch.__path__, "thunder_tpu_torch."):
    importlib.import_module(m.name)
from thunder_tpu_torch.cli.thunder import main
rc = main([sys.argv[1], "--device", "cpu", "--max-rounds", "1"])
assert rc == 0
assert sys.modules["jax"] is None and sys.modules["thunder_tpu"] is None
print("OK")
"""


def test_port_runs_with_jax_blocked(tmp_path):
    cfg_path = _write_tiny_demo(tmp_path, size=16, n=16, rounds=1)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _BLOCKED, cfg_path], env=env,
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")
