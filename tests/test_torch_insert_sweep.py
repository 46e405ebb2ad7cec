"""The rounds' insertion: thunder_tpu's shear-sweep map (ops/insert.py
insert_sweep_3d, insert_sweep_2d) and its port, HK11 ``insert_sweep`` (one
grid and the slab form) and HK12 ``insert_sweep_2d``.

The sweep is a fixed linear map from a slice's dense samples to grid
cells.  ``sweep_map_3d`` / ``sweep_map_2d`` below evaluate it in float64
numpy, independently of both packages: per plane, thunder_tpu's
coefficients and, per sample, the 2 x 2 x 4 (2D: 2 x 2) cells its hats
reach.  The port's plain versions and the emulation of the kernels'
fixed-point sums (``*_fixed_plain``, csrc/sweep_fixed.cuh) are held to
that map within 1e-5 of max |T| (float32 coefficients and weights);
the emulation also to the float64 sum of its own float32 taps within
1e-6 of max |T|, at every cell and in the ring's tiny-T cells, and its
scale to the worst case a cell can reach.  thunder_tpu's 3D sweep
streams its hat fields as bf16, so it is held to the port within twice
the distance measured here between it and the float64 map; its 2D sweep
is float32, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
from thunder_tpu_torch.geometry.symmetry import Symmetry
from thunder_tpu_torch.ops import insert as ti
from thunder_tpu_torch.physics.ctf import ctf_params

TOL = 1e-5      # the port against the float64 map, of max |T| (F: of max |F|)
TOL_SUM = 1e-6  # the fixed-point sums against the float64 sum of the same taps


def _hat(t):
    return np.maximum(0.0, 1.0 - np.abs(t))


def sweep_coeffs_np(rot, pf):
    """thunder_tpu's _sweep_coeffs in float64: the canonical case, the
    swaps and the coefficients of each plane."""
    e1, e2, n = rot[:, :, 1] * pf, rot[:, :, 0] * pf, rot[:, :, 2]
    case = np.argmax(np.abs(n), 1)
    b = np.arange(len(rot))
    m_i, l_i = np.where(case == 2, 1, 2), np.where(case == 0, 1, 0)
    em1, el1, em2, el2 = e1[b, m_i], e1[b, l_i], e2[b, m_i], e2[b, l_i]
    swap_hk = np.maximum(abs(em1), abs(el1)) > np.maximum(abs(em2), abs(el2))
    em1, em2 = np.where(swap_hk, em2, em1), np.where(swap_hk, em1, em2)
    el1, el2 = np.where(swap_hk, el2, el1), np.where(swap_hk, el1, el2)
    swap_ml = abs(el2) > abs(em2)
    em1, el1 = np.where(swap_ml, el1, em1), np.where(swap_ml, em1, el1)
    em2, el2 = np.where(swap_ml, el2, em2), np.where(swap_ml, em2, el2)
    return dict(case=case, swap_hk=swap_hk, swap_ml=swap_ml, em1=em1, em2=em2,
                p_h=(el1 * em2 - el2 * em1) / em2, q_m=el2 / em2,
                alpha=-n[b, l_i] / n[b, case], beta=-n[b, m_i] / n[b, case])


def _samples(vals, c2w):
    nk = vals.shape[-1]
    hh = np.arange(nk) - nk // 2
    h, k = (g.ravel() for g in np.meshgrid(hh, hh, indexing="ij"))
    u = np.stack([vals.real, vals.imag, c2w]).reshape(3, len(vals), nk, nk)
    return h, k, u


def sweep_map_3d(vals, c2w, rot, w_cls, big, pf, cut=None, cut_r2=0.0):
    """The 3D sweep in float64: vals (B, nk, nk) complex, c2w, rot (B, 3,
    3), w_cls (K, B) -> f (K, big^3) complex128, t.  ``cut`` (B,): planes
    whose cells at |k|^2 >= cut_r2 are dropped (a mate's, HK7's cut)."""
    rot = np.asarray(rot, np.float64)
    co = sweep_coeffs_np(rot, pf)
    c = big // 2
    h0, k0, u = _samples(np.asarray(vals), np.asarray(c2w))
    out = np.zeros((w_cls.shape[0], 3, big, big, big))
    for b in range(len(rot)):
        ub = u[:, b].swapaxes(-1, -2) if co["swap_hk"][b] else u[:, b]
        ub = ub.reshape(3, -1)
        ctr_m = co["em1"][b] * h0 + co["em2"][b] * k0
        for dm in (0, 1):
            mp = np.floor(ctr_m) + dm
            ctr_l = co["p_h"][b] * h0 + co["q_m"][b] * mp
            for dl in (0, 1):
                lp = np.floor(ctr_l) + dl
                w2 = _hat(mp - ctr_m) * _hat(lp - ctr_l)
                m, l = (lp, mp) if co["swap_ml"][b] else (mp, lp)
                zeta = co["alpha"][b] * l + co["beta"][b] * m
                for da in (-1, 0, 1, 2):
                    a = np.floor(zeta) + da
                    w = w2 * _hat((a - zeta) / 2) / 2
                    x, y, z = ((a, l, m), (l, a, m), (l, m, a))[co["case"][b]]
                    idx = np.stack([z, y, x]).astype(int) + c
                    ok = np.all((idx >= 0) & (idx < big), 0) & (w > 0)
                    if cut is not None and cut[b]:
                        ok &= x * x + y * y + z * z < cut_r2
                    for kk in range(w_cls.shape[0]):
                        for ch in range(3):
                            np.add.at(out[kk, ch], tuple(idx[:, ok]),
                                      ub[ch, ok] * w[ok] * w_cls[kk, b])
    return out[:, 0] + 1j * out[:, 1], out[:, 2]


def sweep_map_2d(vals, c2w, rot, w_cls, big, pf):
    """The 2D sweep in float64: vals (B, nk, nk), rot (B, 2, 2), w_cls (K,
    B) -> f (K, big, big) complex128, t."""
    rot = np.asarray(rot, np.float64)
    e1, e2 = rot[:, :, 1] * pf, rot[:, :, 0] * pf
    swap = np.abs(e2[:, 1]) < np.abs(e1[:, 1])
    ey1, ey2 = np.where(swap, e2[:, 1], e1[:, 1]), np.where(swap, e1[:, 1], e2[:, 1])
    ex1, ex2 = np.where(swap, e2[:, 0], e1[:, 0]), np.where(swap, e1[:, 0], e2[:, 0])
    p_h, q_y = (ex1 * ey2 - ex2 * ey1) / ey2, ex2 / ey2
    c = big // 2
    h0, k0, u = _samples(np.asarray(vals), np.asarray(c2w))
    out = np.zeros((w_cls.shape[0], 3, big, big))
    for b in range(len(rot)):
        ub = (u[:, b].swapaxes(-1, -2) if swap[b] else u[:, b]).reshape(3, -1)
        cy = ey1[b] * h0 + ey2[b] * k0
        for dy in (0, 1):
            y = np.floor(cy) + dy
            cx = p_h[b] * h0 + q_y[b] * y
            for dx in (0, 1):
                x = np.floor(cx) + dx
                w = _hat(y - cy) * _hat(x - cx)
                idx = np.stack([y, x]).astype(int) + c
                ok = np.all((idx >= 0) & (idx < big), 0) & (w > 0)
                for kk in range(w_cls.shape[0]):
                    for ch in range(3):
                        np.add.at(out[kk, ch], tuple(idx[:, ok]), ub[ch, ok] * w[ok] * w_cls[kk, b])
    return out[:, 0] + 1j * out[:, 1], out[:, 2]


def err(got_f, got_t, ref_f, ref_t):
    """(F's, T's) largest difference over max |F|, max |T|."""
    got_f, got_t = np.asarray(got_f), np.asarray(got_t)
    return (np.abs(got_f - ref_f).max() / np.abs(ref_f).max(),
            np.abs(got_t - ref_t).max() / np.abs(ref_t).max())


def dense_inputs(rng, n_b, r_u, nd=3, n_cls=2):
    """Formed dense slices (the window's mask and doubled DC), rotations
    from a seed and class weights."""
    nk = 2 * r_u - 1
    mask = ti.dense_window(r_u)[2].reshape(nk, nk).numpy()
    vals = ((rng.standard_normal((n_b, nk, nk)) + 1j * rng.standard_normal((n_b, nk, nk)))
            * mask).astype(np.complex64)
    c2w = (rng.uniform(0.1, 1.0, (n_b, nk, nk)) * mask).astype(np.float32)
    if nd == 3:
        q = rng.standard_normal((n_b, 4))
        rot = rotate3d(torch.as_tensor(q / np.linalg.norm(q, axis=1, keepdims=True),
                                       dtype=torch.float32)).numpy()
    else:
        ang = rng.uniform(0, 2 * np.pi, n_b)
        rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                        np.stack([np.sin(ang), np.cos(ang)], -1)], 1).astype(np.float32)
    return vals, c2w, rot, rng.uniform(0.2, 1.0, (n_cls, n_b)).astype(np.float32)


def image_inputs(rng, n_img, per, size, nd=3, n_cls=3):
    """Images, their CTFs and per-slice image, rotation, translation,
    weight (a third of weight zero), class and defocus factor."""
    ft = torch.fft.fftshift(torch.fft.fft2(torch.as_tensor(
        rng.standard_normal((n_img, size, size)), dtype=torch.float32)),
        dim=(-2, -1)).to(torch.complex64).contiguous()
    df = rng.uniform(300, 800, n_img)
    ctf = ctf_params(np.full(n_img, 300e3), df, df * 1.05, rng.uniform(0, 3, n_img),
                     np.full(n_img, 2e7), np.full(n_img, 0.1), np.zeros(n_img), device="cpu")
    n_s = n_img * per
    img = torch.as_tensor(rng.permutation(np.arange(n_s) // per))
    _, _, rot, _ = dense_inputs(rng, n_s, 3, nd)
    w = torch.as_tensor(rng.uniform(0.1, 1, n_s) * (np.arange(n_s) % 3 > 0), dtype=torch.float32)
    return dict(ft=ft, ctf=ctf, img=img, rot=torch.as_tensor(rot),
                trans=torch.as_tensor(rng.normal(0, 1.5, (n_s, 2)), dtype=torch.float32), w=w,
                cls=torch.as_tensor(rng.integers(0, n_cls, n_s)),
                d=torch.as_tensor(1 + 0.05 * rng.standard_normal(n_s), dtype=torch.float32))


@pytest.mark.parametrize("pf, r_u, big", [(2, 8, 40), (1, 10, 26)])
def test_plain_3d_matches_the_float64_map(pf, r_u, big):
    """insert_sweep_3d_plain against the float64 map, classes weighted;
    the planes cover the three height-axis cases and both swaps."""
    vals, c2w, rot, w_cls = dense_inputs(np.random.default_rng(pf), 24, r_u)
    co = ti.sweep_coeffs(torch.as_tensor(rot), pf)
    flags = co[:, 6].long()
    assert set((flags & 3).tolist()) == {0, 1, 2}
    for bit in (ti.SWEEP_SWAP_HK, ti.SWEEP_SWAP_ML):
        assert set(((flags & bit) != 0).tolist()) == {False, True}
    ref = sweep_map_3d(vals, c2w, rot, w_cls, big, pf)
    got = ti.insert_sweep_3d_plain(torch.as_tensor(vals), torch.as_tensor(c2w),
                                   torch.as_tensor(rot), torch.as_tensor(w_cls), big, pf)
    assert max(err(*got, *ref)) < TOL


@pytest.mark.parametrize("pf, r_u, big", [(2, 8, 40), (1, 10, 24)])
def test_plain_2d_matches_the_float64_map_and_thunder_tpu(pf, r_u, big):
    """insert_sweep_2d_plain against the float64 map and thunder_tpu's
    float32 insert_sweep_2d, both within 1e-5."""
    from thunder_tpu.ops.insert import insert_sweep_2d

    vals, c2w, rot, w_cls = dense_inputs(np.random.default_rng(10 + pf), 30, r_u, nd=2,
                                         n_cls=3)
    co = ti.sweep_coeffs_2d(torch.as_tensor(rot), pf)
    assert set(((co[:, 6].long() & ti.SWEEP_SWAP_HK) != 0).tolist()) == {False, True}
    ref = sweep_map_2d(vals, c2w, rot, w_cls, big, pf)
    got = ti.insert_sweep_2d_plain(torch.as_tensor(vals), torch.as_tensor(c2w),
                                   torch.as_tensor(rot), torch.as_tensor(w_cls), big, pf)
    assert max(err(*got, *ref)) < TOL
    jf, jt = insert_sweep_2d(jnp.asarray(vals), jnp.asarray(c2w), jnp.asarray(rot),
                             jnp.asarray(w_cls), big, pf, chunk=8)
    assert max(err(got[0], got[1], np.asarray(jf), np.asarray(jt))) < TOL


def _records(vals, c2w, wk):
    """Value records (B, nk^2, 4) float32 of formed values times a
    class's weights wk (B,)."""
    wk = torch.as_tensor(wk, dtype=torch.float32)[:, None]
    v = torch.as_tensor(vals).reshape(len(vals), -1) * wk
    c = torch.as_tensor(c2w).reshape(len(vals), -1) * wk
    return torch.stack([v.real, v.imag, c, torch.zeros_like(c)], -1)


def fixed_3d(vals, c2w, rot, w_cls, big, pf):
    """HK11's fixed-point sums of formed values, class by class: (f, t)
    (K, big^3)."""
    r_u = (vals.shape[-1] + 1) // 2
    out = [ti._sweep_3d_fixed(_records(vals, c2w, wk), torch.as_tensor(rot), None, r_u, pf, None,
                              torch.zeros((1,) + (big,) * 3, dtype=torch.complex64),
                              torch.zeros((1,) + (big,) * 3), 0, 256) for wk in w_cls]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def fixed_2d(vals, c2w, rot, w_cls, big, pf):
    """HK12's fixed-point sums of formed values into class planes, the
    scale bounded by the values' maxima: (f, t) (K, big, big)."""
    r_u = (vals.shape[-1] + 1) // 2
    px = ti.in_disc_pixels(r_u).long()
    n_b, n_cls = len(vals), len(w_cls)
    recs = torch.cat([_records(vals, c2w, wk) for wk in w_cls])
    upd = recs[:, px, :3]
    scales = ti.sweep_fixed_scales([float(recs[..., c].abs().max()) for c in range(3)],
                                   float(len(recs) * len(px)))
    cls = torch.arange(n_cls).repeat_interleave(n_b)
    rot = torch.as_tensor(rot).repeat(n_cls, 1, 1)
    return ti._sweep_2d_fixed(lambda sl: upd[sl], len(recs), rot, cls, r_u, pf,
                              torch.zeros((n_cls, big, big), dtype=torch.complex64),
                              torch.zeros((n_cls, big, big)), scales, 256)


def float64_taps(vals, c2w, rot, w_cls, big, pf, nd):
    """The float64 sum of the sweep's float32 taps (v * w, each product
    formed as the kernels and the plain versions form it): what the
    fixed-point sums approximate, free of their rounding."""
    nk = vals.shape[-1]
    r_u = (nk + 1) // 2
    px = ti.in_disc_pixels(r_u).long()
    rot = torch.as_tensor(rot)
    co = ti.sweep_coeffs(rot, pf) if nd == 3 else ti.sweep_coeffs_2d(rot, pf)
    n_cells = big ** nd
    g = torch.zeros((len(w_cls) * n_cells, 3), dtype=torch.float64)
    for k, wk in enumerate(w_cls):
        upd = _records(vals, c2w, wk)[:, px, :3]
        row = torch.full((len(vals),), k * n_cells)
        for ok, idx, w in ti._sweep_cells(co, nk, px, big, row, nd):
            g.index_add_(0, idx, (upd[ok] * w[ok][:, None]).double())
    shape = (len(w_cls),) + (big,) * nd
    return (torch.complex(g[:, 0], g[:, 1]).reshape(shape).numpy(),
            g[:, 2].reshape(shape).numpy())


@pytest.mark.parametrize("nd, pf, r_u, big", [(3, 2, 8, 40), (3, 1, 10, 26), (2, 2, 8, 40),
                                              (2, 1, 10, 24)])
def test_fixed_sums_match_the_float64_map_and_their_taps(nd, pf, r_u, big):
    """The kernels' fixed-point sums (HK11 3D, HK12 2D) on the inputs of
    the plain versions' tests above: within TOL of the float64 map (the
    float32 coefficients and weights part from it as the plain versions
    do), and within TOL_SUM of max |T| (and |F|) of the float64 sum of
    the same float32 taps: the sums' own rounding."""
    vals, c2w, rot, w_cls = dense_inputs(np.random.default_rng(pf if nd == 3 else 10 + pf),
                                         24 if nd == 3 else 30, r_u, nd=nd,
                                         n_cls=2 if nd == 3 else 3)
    fixed = fixed_3d if nd == 3 else fixed_2d
    got = fixed(vals, c2w, rot, w_cls, big, pf)
    ref = (sweep_map_3d if nd == 3 else sweep_map_2d)(vals, c2w, rot, w_cls, big, pf)
    assert max(err(*got, *ref)) < TOL
    assert max(err(*got, *float64_taps(vals, c2w, rot, w_cls, big, pf, nd))) < TOL_SUM


@pytest.mark.parametrize("count, vmax", [(480_000 * 2_917, 3.0e3), (23_600_000, 1.0e-30),
                                         (1, 3.4e38), (7, 1.4e-45)])
def test_fixed_scale_bounds_the_worst_cell(count, vmax):
    """The scale's bound at an adversarial input: every one of ``count``
    samples at the largest value with all its weight in one cell (the
    sweep's weights of a sample sum to at most one).  That cell's 128-bit
    sum stays below 2^126 (2^127 is the sign), a scale twice as large
    would reach 2^125: the scale is the largest the bound allows; the
    emulation's words carry to that sum exactly and give back count *
    vmax in float32.  The first case is the 2D rounds' 480,000 slices of
    2,917 in-disc samples (r_u 31), the second 152^3's 23.6 million
    samples; then the float32 extremes."""
    v32 = float(np.float32(vmax))
    s = ti.sweep_fixed_scales([v32], float(count))[0]
    q = round(v32 * s)    # one tap of weight one
    assert 0 < count * q < 2 ** 126
    assert count * round(v32 * 2 * s) >= 2 ** 125
    words = ti._fixed_words(torch.tensor([v32 * s], dtype=torch.float64))[0]
    assert sum(int(w) << (32 * i) for i, w in enumerate(words)) == q
    acc = (words * count).reshape(1, 1, 4).expand(1, 3, 4).contiguous()
    total = sum(int(acc[0, 0, i]) << (32 * i) for i in range(4))
    assert total == count * q
    f, t = ti._fixed_into(torch.zeros(1, dtype=torch.complex64), torch.zeros(1), acc, [s] * 3)
    want = np.float32(count * v32)
    assert float(t[0]) == pytest.approx(float(want), rel=1e-6) and float(f[0].real) == float(t[0])


def test_fixed_sums_in_the_rings_tiny_t_cells():
    """The ring's tiny-T cells, where the rounds' balance loop amplifies
    what T holds (ROADMAP Q3): cells inside the radius whose T is below
    1e-3 of max |T| (the window's edge, few samples): there the
    fixed-point sums stay within 1e-6 of each cell's own T of the float64
    sum of the same taps; the plain version's float32 sums are shown
    beside them."""
    pf, r_u, big = 2, 12, 56
    rng = np.random.default_rng(70)
    vals, c2w, rot, _ = dense_inputs(rng, 40, r_u)
    w_cls = np.ones((1, 40))
    got_f, got_t = fixed_3d(vals, c2w, rot, w_cls, big, pf)
    ref_f, ref_t = float64_taps(vals, c2w, rot, w_cls, big, pf, 3)
    c = big // 2
    k = np.indices((big,) * 3) - c
    r = np.sqrt((k ** 2).sum(0))
    tiny = (ref_t[0] > 0) & (ref_t[0] < 1e-3 * ref_t.max()) & (r < (r_u - 1) * pf)
    assert tiny.sum() > 20, tiny.sum()
    rel = np.abs(got_t[0].numpy() - ref_t[0])[tiny] / ref_t[0][tiny]
    assert rel.max() < 1e-6, rel.max()
    plain_t = ti.insert_sweep_3d_plain(torch.as_tensor(vals), torch.as_tensor(c2w),
                                       torch.as_tensor(rot), torch.as_tensor(w_cls), big, pf)[1]
    rel_p = np.abs(plain_t[0].numpy() - ref_t[0])[tiny] / ref_t[0][tiny]
    print(f"tiny-T cells {int(tiny.sum())}: fixed-point {rel.max():.3g}, float32 {rel_p.max():.3g}"
          f" of the cell's T")


@pytest.mark.parametrize("pf, r_u, big, use_d", [(2, 7, 36, False), (2, 7, 36, True),
                                                  (1, 9, 24, False)])
def test_hk11_gather_matches_the_map(pf, r_u, big, use_d):
    """HK11's fixed-point sums (insert_sweep_fixed_plain) and its plain
    version against the float64 map of the same formed values: slices in
    no order of image, a third of weight zero, a defocus factor a slice."""
    rng = np.random.default_rng(20 + pf + use_d)
    x = image_inputs(rng, 6, 4, 24)
    d = x["d"] if use_d else None
    args = (x["ft"], x["ctf"], x["img"], x["rot"], x["trans"], x["w"], r_u, pf, 24, 1.3)
    vals, c2w, _, _ = ti.dense_slice_values(x["ft"], x["ctf"], x["img"], x["trans"], x["w"], r_u,
                                            24, 1.3, d)
    nk = 2 * r_u - 1
    ref = sweep_map_3d(vals.reshape(-1, nk, nk).numpy(), c2w.reshape(-1, nk, nk).numpy(),
                       x["rot"].numpy(), np.ones((1, len(vals))), big, pf)
    ref = (ref[0][0], ref[1][0])
    zeros = lambda: (torch.zeros((big,) * 3, dtype=torch.complex64), torch.zeros((big,) * 3))
    assert max(err(*ti.insert_sweep_fixed_plain(*args, *zeros(), d), *ref)) < TOL
    assert max(err(*ti.insert_sweep(*args, big, d=d), *ref)) < TOL


@pytest.mark.parametrize("sym", ["C1", "C4", "D2"])
def test_hk11_slab_gather_matches_the_map(sym):
    """HK11's slab form: every (slice, mate) plane M R pose-side, a mate's
    cells only inside the radius, two slabs of a grid with two classes;
    the fixed-point sums and the plain version against the float64 map, and
    for C4 and D2 (signed permutations) the slabs equal HK11 then HK7
    within float32 rounding."""
    pf, r_u, big = 2, 7, 36
    rng = np.random.default_rng(30)
    n_s = 10
    vals, c2w, rot, _ = dense_inputs(rng, n_s, r_u)
    cls = torch.as_tensor(rng.integers(0, 2, n_s))
    mats = Symmetry(sym).matrices
    n_sym = mats.shape[0]
    planes = ti.sweep_planes_rot(torch.as_tensor(rot), mats).numpy()
    mrp2 = float(((r_u - 1) * pf) ** 2)
    w_cls = np.stack([np.repeat((cls.numpy() == k).astype(np.float64), n_sym) for k in (0, 1)])
    ref = sweep_map_3d(np.repeat(vals, n_sym, 0), np.repeat(c2w, n_sym, 0), planes, w_cls, big,
                       pf, np.tile(np.arange(n_sym) > 0, n_s), mrp2)
    tv, tc = torch.as_tensor(vals).reshape(n_s, -1), torch.as_tensor(c2w).reshape(n_s, -1)
    for z0, bz in ((0, big // 2), (big // 2, big // 2)):
        ref_s = (ref[0][:, z0:z0 + bz], ref[1][:, z0:z0 + bz])
        zeros = (torch.zeros((2, bz, big, big), dtype=torch.complex64),
                 torch.zeros((2, bz, big, big)))
        got_g = ti.insert_sweep_slab_fixed_plain(tv, tc, torch.as_tensor(rot), cls, r_u, pf,
                                                 mats, *zeros, z0)
        got_p = ti.insert_sweep_slab(tv, tc, torch.as_tensor(rot), cls, r_u, pf, mats, 2, big,
                                     z0, bz)
        assert max(err(*got_g, *ref_s)) < TOL and max(err(*got_p, *ref_s)) < TOL
    if sym != "C1":
        from thunder_tpu_torch.recon.reconstructor import symmetrize_ft_plain

        one = ti.insert_sweep_3d_plain(torch.as_tensor(vals), torch.as_tensor(c2w),
                                       torch.as_tensor(rot), torch.as_tensor(w_cls[:, ::n_sym]),
                                       big, pf)
        f7, t7 = symmetrize_ft_plain(*one, mats, float((r_u - 1) * pf))
        assert max(err(f7, t7, *ref)) < TOL


def farthest(t, mask, rot, pf) -> float:
    """The largest distance from a cell of t with weight to the nearest
    sample of ``mask`` (nk, nk) on the planes ``rot``."""
    nk = mask.shape[0]
    vr, vc = (x - nk // 2 for x in np.nonzero(mask))
    pos = np.einsum("bij,jp->bpi", rot[..., :, :2].astype(np.float64),
                    pf * np.stack([vc, vr]).astype(np.float64)).reshape(-1, rot.shape[-1])
    cells = np.stack(np.nonzero(t > 0)[::-1], -1) - t.shape[0] // 2
    return float(np.sqrt(((cells[:, None] - pos[None]) ** 2).sum(-1)).min(1).max())


@pytest.mark.parametrize("pf", [1, 2])
def test_the_reach_holds_samples_at_its_edge(pf):
    """Planes tilted so that the sweep reaches farthest (the normal near
    (1, 1, 1) / sqrt 3: |alpha|, |beta|, |q_m| near 1) and samples only at
    the window's edge: the fixed-point sums keep every weight the map
    gives, cells more than 2.5 from every sample among them (2D: 1.6; the
    trilinear and bilinear taps reach sqrt 3 and sqrt 2).  On the card
    the kernels' culls (the radial reach, the plane's band, the bricks'
    candidate boxes) are held to these sums bit for bit
    (test_torch_kernels.py)."""
    r_u = 8
    big = 2 * ((r_u - 1) * pf + 8)
    nk = 2 * r_u - 1
    rng = np.random.default_rng(40 + pf)
    n = np.array([1.0, 1.0, 1.0]) / np.sqrt(3)
    rots = []
    for _ in range(12):
        nn = n + 0.02 * rng.standard_normal(3)
        nn *= rng.choice([-1, 1], 3)
        nn /= np.linalg.norm(nn)
        a = np.cross(nn, rng.standard_normal(3))
        a /= np.linalg.norm(a)
        rots.append(np.stack([a, np.cross(nn, a), nn], 1))
    rot = np.asarray(rots, np.float32)
    kk = np.arange(nk) - (r_u - 1)
    q2 = kk[:, None] ** 2 + kk[None, :] ** 2
    edge = ((q2 < (r_u - 1) ** 2) & (q2 >= (r_u - 2) ** 2)).astype(np.float32)
    vals = ((rng.standard_normal((12, nk, nk)) + 1j) * edge).astype(np.complex64)
    c2w = (rng.uniform(0.5, 1.0, (12, nk, nk)) * edge).astype(np.float32)
    ref_f, ref_t = sweep_map_3d(vals, c2w, rot, np.ones((1, 12)), big, pf)
    assert farthest(ref_t[0], edge, rot, pf) > 2.5
    got = fixed_3d(vals, c2w, rot, np.ones((1, 12)), big, pf)
    assert max(err(got[0][0], got[1][0], ref_f[0], ref_t[0])) < TOL
    # 2D: the slices' rotations at 45 degrees (|q_y| = 1)
    ang = np.pi / 4 + 0.01 * rng.standard_normal(12) + np.pi / 2 * rng.integers(0, 4, 12)
    rot2 = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                     np.stack([np.sin(ang), np.cos(ang)], -1)], 1).astype(np.float32)
    ref2 = sweep_map_2d(vals, c2w, rot2, np.ones((1, 12)), big, pf)
    assert farthest(ref2[1][0], edge, rot2, pf) > 1.6
    got2 = fixed_2d(vals, c2w, rot2, np.ones((1, 12)), big, pf)
    assert max(err(got2[0][0], got2[1][0], ref2[0][0], ref2[1][0])) < TOL


def test_hk12_gather_matches_the_map():
    """HK12's fixed-point sums (insert_sweep_2d_fixed_plain) and its
    plain version against the float64 map of the same formed values,
    three class planes."""
    pf, r_u, big = 2, 8, 40
    rng = np.random.default_rng(50)
    x = image_inputs(rng, 8, 4, 24, nd=2)
    args = (x["ft"], x["ctf"], x["img"], x["cls"], x["rot"], x["trans"], x["w"], r_u, pf, 24,
            1.3)
    vals, c2w, _, _ = ti.dense_slice_values(x["ft"], x["ctf"], x["img"], x["trans"], x["w"], r_u,
                                            24, 1.3)
    nk = 2 * r_u - 1
    w_cls = np.stack([(x["cls"].numpy() == k).astype(np.float64) for k in range(3)])
    ref = sweep_map_2d(vals.reshape(-1, nk, nk).numpy(), c2w.reshape(-1, nk, nk).numpy(),
                       x["rot"].numpy(), w_cls, big, pf)
    zeros = (torch.zeros((3, big, big), dtype=torch.complex64), torch.zeros((3, big, big)))
    assert max(err(*ti.insert_sweep_2d_fixed_plain(*args, *zeros), *ref)) < TOL
    assert max(err(*ti.insert_sweep_2d(*args, big, 3), *ref)) < TOL


def thunder_sweep(vals, c2w, rot, big, pf, post=None):
    """thunder_tpu's insert_sweep_3d of formed slices of one class (vals,
    c2w (B, nk^2), weights in the values; rot (B, 3, 3)), then ``post``
    (f, t) -> (f, t) where given, and the tolerance (F, T) to hold the
    port's grids to it: twice its distance from the float64 map through
    the same ``post``.  Returns (f, t, tol) as numpy."""
    from thunder_tpu.ops.insert import insert_sweep_3d

    n_b = vals.shape[0]
    nk = int(round(vals.shape[-1] ** 0.5))
    v = np.asarray(vals).reshape(n_b, nk, nk)
    c = np.asarray(c2w).reshape(n_b, nk, nk)
    jf, jt = insert_sweep_3d(jnp.asarray(v), jnp.asarray(c), jnp.asarray(np.asarray(rot)),
                             jnp.ones((1, n_b)), big, pf, chunk=16)
    rf, rt = sweep_map_3d(v, c, np.asarray(rot), np.ones((1, n_b)), big, pf)
    jf, jt, rf, rt = jf[0], jt[0], rf[0], rt[0]
    if post is not None:
        jf, jt = post(jf, jt)
        rf, rt = post(jnp.asarray(rf, jnp.complex64), jnp.asarray(rt, jnp.float32))
    jf, jt = np.asarray(jf), np.asarray(jt)
    return jf, jt, bf16_bound(jf, jt, (np.asarray(rf), np.asarray(rt)))


def bf16_bound(jf, jt, ref):
    """Twice the distance of thunder_tpu's bf16 sweep from the float64
    map (F over max |F|, T over max |T|): the tolerance the port is held
    to against it."""
    d = err(jf, jt, *ref)
    assert 0 < max(d) < 2e-2, d
    return 2 * d[0], 2 * d[1]


def test_plain_3d_against_thunder_tpus_sweeps():
    """insert_sweep_3d_plain against thunder_tpu's insert_sweep_3d and
    its z-slab form insert_sweep_3d_sharded (on a virtual 8-device mesh,
    2 hemispheres x 4 slabs) on the same formed slices; the port's
    insert_sweep against _insert_flat3d_h, the rounds' one-grid path, on
    the same images, poses, translations and weights.  Each within twice
    the distance this test measures between thunder_tpu's bf16 sweep and
    the float64 map."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from thunder_tpu import optimiser as jo
    from thunder_tpu.ops.insert import insert_sweep_3d
    from thunder_tpu.parallel.mesh import make_mesh
    from thunder_tpu.physics.ctf import ctf_params as jctf_params
    from thunder_tpu.recon.sharded import insert_sweep_3d_sharded

    pf, r_u, big = 2, 8, 40
    rng = np.random.default_rng(60)
    vals, c2w, rot, w_cls = dense_inputs(rng, 2 * 16, r_u)
    vals, c2w, rot = (x.reshape((2, 16) + x.shape[1:]) for x in (vals, c2w, rot))
    w_cls = rng.uniform(0.2, 1.0, (2, 2, 16)).astype(np.float32)
    mesh = make_mesh(8, hemi=2)
    with mesh:
        sh = lambda a, spec: jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))
        fs, ts = insert_sweep_3d_sharded(mesh, sh(vals, P("hemi", "data")),
                                         sh(c2w, P("hemi", "data")), sh(rot, P("hemi", "data")),
                                         sh(w_cls, P("hemi", None, "data")), big, pf, chunk=4)
    for h in (0, 1):
        ref = sweep_map_3d(vals[h], c2w[h], rot[h], w_cls[h], big, pf)
        jf, jt = insert_sweep_3d(jnp.asarray(vals[h]), jnp.asarray(c2w[h]), jnp.asarray(rot[h]),
                                 jnp.asarray(w_cls[h]), big, pf, chunk=8)
        tol = bf16_bound(jf, jt, ref)
        got = ti.insert_sweep_3d_plain(torch.as_tensor(vals[h]), torch.as_tensor(c2w[h]),
                                       torch.as_tensor(rot[h]), torch.as_tensor(w_cls[h]), big,
                                       pf)
        e = err(*got, np.asarray(jf), np.asarray(jt))
        assert e[0] < tol[0] and e[1] < tol[1], (e, tol)
        tol_s = bf16_bound(np.asarray(fs[h]), np.asarray(ts[h]), ref)
        e = err(*got, np.asarray(fs[h]), np.asarray(ts[h]))
        assert e[0] < tol_s[0] and e[1] < tol_s[1], (e, tol_s)

    # the rounds' path: images, CTF, poses, translations and weights
    x = image_inputs(rng, 8, 3, 24)
    n_s = len(x["img"])
    quats = random_quat(torch.Generator().manual_seed(61), (n_s,), "cpu")
    rot = rotate3d(quats)
    df = rng.uniform(300, 800, 8)
    cp = (np.full(8, 300e3), df, df * 1.05, rng.uniform(0, 3, 8), np.full(8, 2e7),
          np.full(8, 0.1), np.zeros(8))
    ctf = ctf_params(*cp, device="cpu")
    w = x["w"]
    f_p, t_p = ti.insert_sweep(x["ft"], ctf, x["img"], rot, x["trans"], w, r_u, pf, 24, 1.3,
                               big)
    jf, jt = jo._insert_flat3d_h(jnp.asarray(x["ft"].numpy()), jctf_params(*cp),
                                 jnp.asarray(quats.numpy()), jnp.asarray(x["trans"].numpy()),
                                 jnp.ones(n_s), jnp.asarray(w.numpy())[None],
                                 jnp.asarray(x["img"].numpy()), jnp.eye(3)[None],
                                 jnp.asarray(float((r_u - 1) * pf)), 24, pf, 1, big // pf, 1.3,
                                 False, r_u)
    vals, c2w, _, _ = ti.dense_slice_values(x["ft"], ctf, x["img"], x["trans"], w, r_u, 24, 1.3)
    nk = 2 * r_u - 1
    ref = sweep_map_3d(vals.reshape(-1, nk, nk).numpy(), c2w.reshape(-1, nk, nk).numpy(),
                       rot.numpy(), np.ones((1, n_s)), big, pf)
    tol = bf16_bound(np.asarray(jf)[0], np.asarray(jt)[0], (ref[0][0], ref[1][0]))
    e = err(f_p, t_p, np.asarray(jf)[0], np.asarray(jt)[0])
    assert e[0] < tol[0] and e[1] < tol[1], (e, tol)
