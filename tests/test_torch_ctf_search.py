"""CTF search in the port against thunder_tpu on the CPU: the CTF with a
defocus factor, the defocus axis of the particle filter (random numbers
made by the JAX keys and handed to the port), the likelihood with a
defocus axis and its three marginals (the plain version of HK8),
insertion with a defocus factor a slice (the plain version of HK3), and
the workload of tests/test_ctf_search.py (24 px, 32 images generated
with every defocus scaled by 1.10, true poses injected) run in the port.
thunder_tpu's einsums run in float32 on the CPU whatever
THUNDER_MXU_PRECISION says."""

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
from thunder_tpu.ops import likelihood as jlk  # noqa: E402
from thunder_tpu.ops.fourier import pack_rings as jpack_rings  # noqa: E402
from thunder_tpu.physics import ctf as jctf  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch import particle as tpt  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402
from thunder_tpu_torch.model import SEARCH_TYPE_CTF  # noqa: E402
from thunder_tpu_torch.ops import insert as tinsert  # noqa: E402
from thunder_tpu_torch.ops import likelihood as tlk  # noqa: E402
from thunder_tpu_torch.physics import ctf as tctf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_e2e_3d import make_3d_dataset  # noqa: E402
from test_torch_particle import both, check, make_state  # noqa: E402
from test_torch_slice import close, t  # noqa: E402

L, ND = 6, 9


def ctf_cols(n, seed, lo=8000.0, hi=20000.0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(lo, hi, n)
    return (np.full(n, 300e3), d, d * rng.uniform(0.9, 1.1, n), rng.uniform(0, 3, n),
            np.full(n, 2e7), np.full(n, 0.1), rng.uniform(0, 0.2, n))


def test_ctf_packed_scaled_matches_jax():
    """160 px geometry, astigmatic CTFs, nine factors around 1; 5e-4 of
    the CTF's unit range: chi reaches ~50 rad at r = 40, where one float32
    rounding of it moves the CTF by 4e-6 and the two packages' sin / cos
    differ in the last bits."""
    rings = jpack_rings(160, 40, 1)
    cols = ctf_cols(L, 0)
    d = 1 + 0.05 * np.random.default_rng(1).standard_normal((L, ND)).astype(np.float32)
    ref = jctf.ctf_packed_scaled(jctf.ctf_params(*cols), rings.i_col, rings.i_row, 160, 1.32,
                                 jnp.asarray(d))
    got = tctf.ctf_packed_scaled(tctf.ctf_params(*cols), t(rings.i_col), t(rings.i_row),
                                 160, 1.32, t(d))
    assert got.shape == (L, ND, rings.i_col.shape[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-4)
    # a factor of 1 is ctf_packed
    one = tctf.ctf_packed_scaled(tctf.ctf_params(*cols), t(rings.i_col), t(rings.i_row),
                                 160, 1.32, torch.ones(L, 1))[:, 0]
    np.testing.assert_allclose(
        one.numpy(), tctf.ctf_packed(tctf.ctf_params(*cols), t(rings.i_col), t(rings.i_row),
                                     160, 1.32).numpy(), atol=5e-4)


def d_state(seed):
    s = make_state(seed)
    rng = np.random.default_rng(seed + 100)
    s["d"] = (1 + 0.02 * rng.standard_normal((L, ND))).astype(np.float32)
    s["w_d"] = (rng.random((L, ND)).astype(np.float32) + 0.01) / ND
    s["u_d"] = rng.random((L, ND)).astype(np.float32) + 0.01
    s["s_d"] = np.full(L, 0.02, np.float32)
    return s


def ctf_float64(cols, i_col, i_row, size: int, pixel_size: float) -> np.ndarray:
    """ctf_packed's formula in float64 on the float32 parameters and the
    integer frequencies: (L, p)."""
    from thunder_tpu_torch.constants import CTF_LAMBDA_A, CTF_LAMBDA_B

    v, du, dv, th, cs, w2, ps = (np.float64(np.float32(c))[:, None] for c in cols)
    fx, fy = i_col / (pixel_size * size), i_row / (pixel_size * size)
    f2 = fx * fx + fy * fy
    lam = CTF_LAMBDA_A / np.sqrt(v * (1 + v * CTF_LAMBDA_B))
    defocus = -(du + dv + (du - dv) * np.cos(2 * (np.arctan2(i_row, i_col) - th))) / 2
    chi = np.pi * lam * defocus * f2 + np.pi / 2 * cs * lam ** 3 * f2 ** 2 - ps
    return -np.sqrt(1 - w2 * w2) * np.sin(chi) + w2 * np.cos(chi)


def test_ctf_packed_float32_past_0_3_per_angstrom():
    """The float32 CTF of the port's ctf_packed and thunder_tpu's, 160 px
    at 1.32 A, defocus 8,000-20,000 A, every ring to the band's edge
    (0.376 per angstrom), held to a float64 evaluation of the same
    formula past 0.3 per angstrom, where chi reaches ~185 rad: the
    port's largest and root-mean-square distances are thunder_tpu's or
    smaller, within one float32 ulp of the CTF's unit range (2^-23).
    Both are ~9e-5 at most (the float32 rounding of chi's products), and
    the two packages part by up to ~5e-5 (their sin / cos)."""
    size, px = 160, 1.32
    rings = jpack_rings(size, size // 2, 1)
    i_col, i_row = np.asarray(rings.i_col), np.asarray(rings.i_row)
    cols = ctf_cols(64, 3)
    want = ctf_float64(cols, i_col.astype(np.float64), i_row.astype(np.float64), size, px)
    j = np.asarray(jctf.ctf_packed(jctf.ctf_params(*cols), jnp.asarray(i_col),
                                   jnp.asarray(i_row), size, px))
    p = tctf.ctf_packed(tctf.ctf_params(*cols), torch.as_tensor(i_col.copy()),
                        torch.as_tensor(i_row.copy()), size, px).numpy()
    past = np.hypot(i_col, i_row) / (px * size) > 0.3
    assert past.sum() > 3000
    dist = {name: np.abs(x[:, past] - want[:, past]) for name, x in
            (("thunder_tpu", j), ("port", p))}
    worst = {k: float(e.max()) for k, e in dist.items()}
    rms = {k: float(np.sqrt((e ** 2).mean())) for k, e in dist.items()}
    print(f"past 0.3 / A: max |CTF - float64| {worst}, rms {rms}")
    assert worst["port"] <= worst["thunder_tpu"] + 2.0 ** -23, worst
    assert rms["port"] <= rms["thunder_tpu"] + 2.0 ** -23, rms


def test_init_d_round_given_normals():
    js, ts = both(d_state(1))
    key = jax.random.PRNGKey(3)
    jr = jpt.init_d_round(key, js, 0.01)
    noise = np.asarray(jax.random.normal(key, (L, ND)))
    tr = tpt.init_d_round(None, ts, 0.01, noise=t(noise))
    check(tr, jr, ["d", "w_d", "u_d", "s_d", "top_d"], 1e-6)
    np.testing.assert_allclose(tr.w_d.numpy(), 1.0 / ND, rtol=1e-6)


def test_perturb_and_balance_d_given_normals():
    js, ts = both(d_state(2))
    key = jax.random.PRNGKey(4)
    jr = jpt.perturb_d(key, js, 0.5)
    tr = tpt.perturb_d(None, ts, 0.5, noise=t(np.asarray(jax.random.normal(key, (L, ND)))))
    check(tr, jr, ["d", "w_d"], 1e-6)
    check(tpt.balance_weight_d(tr), jpt.balance_weight_d(jr), ["w_d"], 1e-4)


def test_resample_d_given_uniforms():
    js, ts = both(d_state(3))
    key = jax.random.PRNGKey(5)
    jr = jpt.resample_d(key, js, ND)
    tr = tpt.resample_d(None, ts, ND, u0=t(np.asarray(jax.random.uniform(key, (L, 1)))))
    check(tr, jr, ["d", "w_d", "u_d", "top_d"], 1e-5)
    check(tpt.cal_vari_d(tr), jpt.cal_vari_d(jr), ["s_d"], 1e-5)


def lk_inputs(seed, n_r=12, n_t=5, size=32, band=8):
    rng = np.random.default_rng(seed)
    rings = jpack_rings(size, band, 1)
    p = rings.i_col.shape[0]
    c = lambda *s: (rng.standard_normal(s) + 1j * rng.standard_normal(s)).astype(np.complex64)
    f = lambda a: np.asarray(a, np.float32)
    s_pack = f(-0.5 * np.asarray(rings.mask) * (0.5 + rng.random((L, p))))
    dat = c(L, p)
    ph = 0.3 * rng.standard_normal((L, n_t, p))
    return dict(rings=rings, dat_s=(s_pack * dat).astype(np.complex64), s_pack=s_pack,
                cols=ctf_cols(L, seed, 300.0, 900.0),
                d=f(1 + 0.05 * rng.standard_normal((L, ND))), pri=0.3 * c(L, n_r, p),
                tra=np.exp(1j * ph).astype(np.complex64),
                a=f((s_pack * np.abs(dat) ** 2).sum(-1)), w_r=f(rng.random((L, n_r))),
                w_t=f(rng.random((L, n_t))), w_d=f(rng.random((L, ND))), size=size)


def test_log_dvp_local_ctf_and_marginals_match_jax():
    """dvp (L, D, R, T) and u_r, u_t, u_d as _phase_body_ctf forms them;
    1e-4 of the largest value: float32 sums over P in another order,
    amplified by exp."""
    x = lk_inputs(7)
    rings = x["rings"]
    j = lambda k: jnp.asarray(x[k])
    ctf_j = jctf.ctf_packed_scaled(jctf.ctf_params(*x["cols"]), rings.i_col, rings.i_row,
                                   x["size"], 1.32, j("d"))
    dvp_j = jlk.log_dvp_local_ctf(j("dat_s"), j("s_pack"), ctf_j, j("pri"), j("tra"), j("a"))
    w = jnp.exp(dvp_j - jnp.max(dvp_j, axis=(1, 2, 3), keepdims=True))
    ref = (jnp.einsum("ldrt,lt,ld->lr", w, j("w_t"), j("w_d")),
           jnp.einsum("ldrt,lr,ld->lt", w, j("w_r"), j("w_d")),
           jnp.einsum("ldrt,lr,lt->ld", w, j("w_r"), j("w_t")))
    tt = lambda k: t(x[k])
    ctf_t = tctf.ctf_packed_scaled(tctf.ctf_params(*x["cols"]), t(rings.i_col), t(rings.i_row),
                                   x["size"], 1.32, tt("d"))
    dvp_t = tlk.log_dvp_local_ctf(tt("dat_s"), tt("s_pack"), ctf_t, tt("pri"), tt("tra"), tt("a"))
    close(dvp_t, dvp_j, 1e-5)
    terms = tlk.ctf_terms(tctf.ctf_params(*x["cols"]), t(rings.i_col), t(rings.i_row),
                          x["size"], 1.32)
    got = tlk.likelihood_local_ctf(tt("dat_s"), tt("s_pack"), terms, tt("d"), tt("pri"),
                                   tt("tra"), tt("a"), tt("w_r"), tt("w_t"), tt("w_d"))
    assert tlk.likelihood_local_ctf.launches == 0       # CPU tensors: the plain version
    for a, b in zip(got, ref):
        close(a, b, 1e-4)


def test_likelihood_ctf_plan():
    """HK8's launch plan at the path's block (D 9, R 125, T 9): register
    tiles of 4 x 3 x 9, one warp of 32 rotation tiles a translation tile,
    three warps a pixel group, four groups (384 threads), 77,904 bytes."""
    plan = tlk.likelihood_ctf_plan(9, 125, 9)
    assert plan == dict(n_rg=1, n_tt=3, n_dt=1, groups=4, threads=384, smem=77904)
    assert tlk.likelihood_ctf_plan(1, 1, 1)["threads"] == 384
    with pytest.raises(ValueError, match="shared memory"):
        tlk.likelihood_ctf_plan(30, 256, 30)


@pytest.mark.parametrize("kernel", ["sweep", "trilinear"])
def test_insertion_with_defocus_factor_matches_jax(kernel):
    """The plain versions of HK11 (the rounds' insertion) and HK3 with a
    defocus factor a slice against thunder_tpu's use_d value formation
    (_insert_flat3d_h's step: ctf_packed_scaled on the dense window) and,
    for HK11, its shear sweep, within twice the distance of thunder_tpu's
    bf16 sweep from the float64 map (test_torch_insert_sweep.py); for HK3
    its exact trilinear scatter, 1e-4."""
    from test_torch_insert_sweep import bf16_bound, err, sweep_map_3d
    from thunder_tpu.ops.insert import insert_slices_3d, insert_sweep_3d

    rng = np.random.default_rng(9)
    n_l, size, r_u, big, n_s = 5, 24, 8, 40, 30
    ft = np.fft.fftshift(np.fft.fft2(rng.standard_normal((n_l, size, size))),
                         axes=(-2, -1)).astype(np.complex64)
    cols = ctf_cols(n_l, 2, 300.0, 900.0)
    img = rng.integers(0, n_l, n_s)
    q = rng.standard_normal((n_s, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tr = rng.normal(0, 1.0, (n_s, 2)).astype(np.float32)
    w = rng.random(n_s).astype(np.float32)
    d = (1 + 0.1 * rng.standard_normal(n_s)).astype(np.float32)
    rot = np.asarray(jo.rotate3d(jnp.asarray(q)))
    insert = tinsert.insert_sweep if kernel == "sweep" else tinsert.insert_trilinear
    fk, tk = insert(t(ft), tctf.ctf_params(*cols), t(img), t(rot), t(tr), t(w), r_u, 2, size,
                    1.0, big, d=t(d))
    vc, vr, mask_d = (np.asarray(a) for a in tinsert.dense_window(r_u))
    c = size // 2
    cp = jctf.ctf_params(*[np.asarray(col)[img] for col in cols])
    ctf = jctf.ctf_packed_scaled(cp, jnp.asarray(vc), jnp.asarray(vr), size, 1.0,
                                 jnp.asarray(d)[:, None])[:, 0]
    tra = jo.translate_phases_view(jnp.asarray(vc), jnp.asarray(vr), size, jnp.asarray(tr))
    vals = jnp.asarray(ft[img][:, c + vr, c + vc]) * jnp.conj(tra) * (ctf * mask_d) * w[:, None]
    c2w = ctf * ctf * mask_d * w[:, None]
    if kernel == "trilinear":
        fj, tj = insert_slices_3d(jnp.zeros((big,) * 3, jnp.complex64),
                                  jnp.zeros((big,) * 3, jnp.float32), vals, c2w,
                                  jnp.asarray(rot), jnp.asarray(vc), jnp.asarray(vr), 2,
                                  float((r_u - 1) * 2))
        close(fk, fj, 1e-4)
        close(tk, tj, 1e-4)
        return
    nk = 2 * r_u - 1
    v, cw = np.asarray(vals).reshape(n_s, nk, nk), np.asarray(c2w).reshape(n_s, nk, nk)
    fj, tj = insert_sweep_3d(jnp.asarray(v), jnp.asarray(cw), jnp.asarray(rot),
                             jnp.ones((1, n_s)), big, 2, chunk=8)
    rf, rt = sweep_map_3d(v, cw, rot, np.ones((1, n_s)), big, 2)
    tol = bf16_bound(np.asarray(fj[0]), np.asarray(tj[0]), (rf[0], rt[0]))
    e = err(fk, tk, np.asarray(fj[0]), np.asarray(tj[0]))
    assert e[0] < tol[0] and e[1] < tol[1], (e, tol)
    f0, _ = tinsert.insert_trilinear(t(ft), tctf.ctf_params(*cols), t(img), t(rot), t(tr), t(w),
                                     r_u, 2, size, 1.0, big)
    assert float((f0 - fk).abs().max()) > 1e-3 * float(fk.abs().max())


def test_ctf_search_recovers_defocus_factor():
    """tests/test_ctf_search.py's workload in the port: images made with
    every defocus scaled by 1.10, the table carrying the unscaled value,
    true poses injected, search type set to CTF, eight rounds of the
    phase loop: the median rank-1 factor lands within 0.04 of 1.10."""
    size, n = 24, 32
    true_factor = 1.10
    phantom, imgs, true_q, true_t = make_3d_dataset(size, n, snr=8.0,
                                                    defocus=1200.0 * true_factor)
    cfg = TConfig(mode="3D", k=1, size=size, pixel_size=1.0, mask_radius=10.0, trans_s=1.5,
                  init_res=3.0, global_search_res=2.4, sym="C1", m_s=256, m_l_r=16, m_l_t=9,
                  m_l_d=9, m_reco=8, c_search=True, ignore_res=size * 1.0,
                  trans_search_factor=0.25, ctf_refine_s=0.1)
    ctf = (np.full(n, 300e3), np.full(n, 1200.0), np.full(n, 1200.0), np.zeros(n),
           np.full(n, 2e7), np.full(n, 0.1), np.zeros(n))
    opt = to.Optimiser(cfg, imgs, ctf, np.zeros(n, np.int64), init_refs=phantom, device="cpu")
    n_l = opt.n_img
    par = opt.state.par
    assert par.d.shape == (2, n_l, 9)
    tq = t(np.asarray(true_q, np.float32)[opt.index])
    tt = t(np.asarray(true_t, np.float32)[opt.index])
    full = lambda v: torch.full((2, n_l), v)
    opt.state.par = par._replace(
        r=tq[:, :, None, :].expand(2, n_l, par.r.shape[2], 4).contiguous(),
        t=tt[:, :, None, :].expand(2, n_l, par.t.shape[2], 2).contiguous(),
        top_r=tq, top_t=tt, k1=full(0.001), k2=full(0.001), k3=full(0.001),
        s0=full(0.05), s1=full(0.05))
    opt.model.search_type = SEARCH_TYPE_CTF
    opt.model.r = size // 2 - 2
    opt.correct_scale()
    rings = opt._rings()
    for _ in range(8):
        phases = opt.local_phases(rings)
        assert min(phases) >= 3
    top_d = opt.state.par.top_d.numpy()[opt.valid]
    med = float(np.median(top_d))
    assert abs(med - true_factor) < 0.04, f"median defocus factor {med}"
    assert med > 1.04
    assert float(opt.state.par.s_d.min()) > 0
    # the drawn factor scales the inserted slices' CTF in a CTF round, and
    # export_thu carries the rank-1 factor and its spread
    opt.model.r = 6
    f_d, _, _, _ = opt.reconstruct_round()
    opt.model.search_type = 1
    f_1, _, _, _ = opt.reconstruct_round()
    assert torch.isfinite(f_d.abs()).all() and f_d.shape == f_1.shape
    from thunder_tpu_torch.io.thu import ThuTable
    out = opt.export_thu(ThuTable.blank(n, voltage=300e3))
    np.testing.assert_allclose(np.median(out.defocus_factor), med, atol=1e-6)
    assert (out.std_defocus_factor > 0).all()


def test_correct_scale_matches_jax():
    """The port's correct_scale against thunder_tpu's on the same state."""
    from thunder_tpu.config import ThunderConfig as JConfig
    from thunder_tpu_torch import interop

    size, n = 24, 16
    phantom, imgs, true_q, true_t = make_3d_dataset(size, n, snr=8.0)
    kw = dict(mode="3D", k=1, size=size, pixel_size=1.0, mask_radius=10.0, trans_s=1.5,
              init_res=3.0, global_search_res=2.4, sym="C1", m_s=256, m_l_r=16, m_l_t=9,
              m_reco=8, ignore_res=size * 1.0, trans_search_factor=0.25)
    cols = (np.full(n, 300e3), np.full(n, 500.0), np.full(n, 500.0), np.zeros(n),
            np.full(n, 2e7), np.full(n, 0.1), np.zeros(n))
    jopt = jo.Optimiser(JConfig(**kw), imgs, jctf.ctf_params(*cols), np.zeros(n, np.int64),
                        init_refs=phantom * 1.7)
    topt = to.Optimiser(TConfig(**kw), imgs, cols, np.zeros(n, np.int64),
                        init_refs=phantom * 1.7, device="cpu")
    jopt.state.par = jopt.state.par._replace(
        top_r=jnp.asarray(np.asarray(true_q)[jopt.index], jnp.float32),
        top_t=jnp.asarray(np.asarray(true_t)[jopt.index], jnp.float32))
    interop.restore(topt, interop.snapshot(jopt))
    before = topt.state.sigma.clone()
    jopt.correct_scale(init=False)
    topt.correct_scale()
    # the JAX table is bf16 by default: 1e-2
    close(topt.state.sigma, jopt.state.sigma, 1e-2)
    close(topt.data.ft_ori[..., 1, 2].abs(), jnp.abs(jopt.data.ft_ori[..., 1, 2]), 1e-2)
    assert float((topt.state.sigma / before).mean()) != pytest.approx(1.0, abs=1e-3)
