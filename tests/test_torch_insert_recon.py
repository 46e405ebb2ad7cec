"""Parity of the port's insertion (host of HK3, insert_trilinear; its
plain version on the CPU) and gridding reconstruction with thunder_tpu,
and the reference reconstruction golden.  HK3 is held to
insert_slices_3d (the exact trilinear scatter, ``cli/reconstruct.py``'s
insertion) fed with the same slice values; the rounds' shear sweep (HK11)
is held in test_torch_insert_sweep.py."""

import os

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from thunder_tpu.geometry.quaternion import random_quat, rotate3d  # noqa: E402
from thunder_tpu.ops import insert as ji  # noqa: E402
from thunder_tpu.recon import reconstructor as jr  # noqa: E402
from thunder_tpu_torch.geometry.quaternion import rotate3d as trot  # noqa: E402
from thunder_tpu_torch.ops import insert as ti  # noqa: E402
from thunder_tpu_torch.ops import projector as tp  # noqa: E402
from thunder_tpu_torch.physics.ctf import ctf_params  # noqa: E402
from thunder_tpu_torch.recon import reconstructor as tr  # noqa: E402

G = os.path.join(os.path.dirname(__file__), "goldens")


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= rtol, err


def rots(n, seed):
    import jax
    return np.asarray(rotate3d(random_quat(jax.random.PRNGKey(seed), (n,))))


def test_insert_slices_3d_matches_jax():
    rng = np.random.default_rng(0)
    big, p, n = 24, 40, 6
    i_col = rng.integers(0, 8, p).astype(np.int32)
    i_row = rng.integers(-8, 8, p).astype(np.int32)
    vals = (rng.standard_normal((n, p)) + 1j * rng.standard_normal((n, p))).astype(np.complex64)
    c2w = rng.random((n, p)).astype(np.float32)
    r = rots(n, 1)
    f0 = np.zeros((big,) * 3, np.complex64)
    t0 = np.zeros((big,) * 3, np.float32)
    jf_, jt_ = ji.insert_slices_3d(jnp.asarray(f0), jnp.asarray(t0), vals, c2w, r,
                                   i_col, i_row, 2, 16.0)
    tf_, tt_ = ti.insert_slices_3d(t(f0), t(t0), t(vals), t(c2w), t(r), t(i_col),
                                   t(i_row), 2, 16.0)
    # scatter-adds in another order: float32 rounding of the sums
    close(tf_, jf_, 1e-5)
    close(tt_, jt_, 1e-5)
    close(ti.hermitianize(tf_), ji.hermitianize(jf_), 1e-5)
    close(ti.hermitianize_real(tt_), ji.hermitianize_real(jt_), 1e-5)


def test_insert_trilinear_matches_insert_slices_3d():
    """HK3's plain version == JAX insert_slices_3d over the dense window
    with the values HK3 forms (phase ramp, CTF, |k| < r_u - 1 cut, DC
    doubled, slice weight)."""
    rng = np.random.default_rng(2)
    size, n_img, n_s, r_u, pf = 16, 3, 7, 6, 2
    big = 2 * (r_u + 2) * pf
    ft = (rng.standard_normal((n_img, size, size))
          + 1j * rng.standard_normal((n_img, size, size))).astype(np.complex64)
    d = rng.uniform(1000, 3000, n_img)
    ctf = ctf_params(np.full(n_img, 300e3), d, d * 1.05, rng.uniform(0, 3, n_img),
                     np.full(n_img, 2e7), np.full(n_img, 0.1), np.zeros(n_img))
    img_idx = t(rng.integers(0, n_img, n_s))
    r = t(rots(n_s, 3))
    trans = t(rng.uniform(-2, 2, (n_s, 2)).astype(np.float32))
    w = t(rng.random(n_s).astype(np.float32))
    f_t, t_t = ti.insert_trilinear(t(ft), ctf, img_idx, r, trans, w, r_u, pf, size,
                                   1.32, big)
    vals, c2w, vc, vr = ti.dense_slice_values(t(ft), ctf, img_idx, trans, w, r_u,
                                              size, 1.32)
    zf = jnp.zeros((big,) * 3, jnp.complex64)
    zt = jnp.zeros((big,) * 3, jnp.float32)
    f_j, t_j = ji.insert_slices_3d(zf, zt, vals.numpy(), c2w.numpy(), r.numpy(),
                                   vc.numpy(), vr.numpy(), pf, float((r_u - 1) * pf))
    close(f_t, f_j, 1e-5)
    close(t_t, t_j, 1e-5)


def test_insert_trilinear_unsorted_zero_weight_and_cut():
    """HK3's function on the inputs its card test uses: img_idx in no
    order, some slices of weight zero, and a band whose corner pixels
    fall beyond the padded-radius cut; against JAX insert_slices_3d."""
    rng = np.random.default_rng(5)
    size, n_img, n_s, r_u, pf = 16, 4, 12, 7, 2
    big = 2 * (r_u + 2) * pf
    ft = (rng.standard_normal((n_img, size, size))
          + 1j * rng.standard_normal((n_img, size, size))).astype(np.complex64)
    d = rng.uniform(1000, 3000, n_img)
    ctf = ctf_params(np.full(n_img, 300e3), d, d * 1.05, rng.uniform(0, 3, n_img),
                     np.full(n_img, 2e7), np.full(n_img, 0.1), np.zeros(n_img))
    img_idx = t(np.asarray([3, 0, 2, 2, 1, 3, 0, 0, 1, 2, 3, 1]))
    r = t(rots(n_s, 6))
    trans = t(rng.uniform(-2, 2, (n_s, 2)).astype(np.float32))
    w = rng.random(n_s).astype(np.float32)
    w[[1, 5, 6]] = 0.0
    w = t(w)
    f_t, t_t = ti.insert_trilinear(t(ft), ctf, img_idx, r, trans, w, r_u, pf, size,
                                   1.32, big)
    vals, c2w, vc, vr = ti.dense_slice_values(t(ft), ctf, img_idx, trans, w, r_u,
                                              size, 1.32)
    # the window's corners lie beyond the cut, and are masked out
    assert int((vc * vc + vr * vr >= (r_u - 1) ** 2).sum()) > 0
    assert float(c2w[1].abs().max()) == 0.0
    zf = jnp.zeros((big,) * 3, jnp.complex64)
    zt = jnp.zeros((big,) * 3, jnp.float32)
    f_j, t_j = ji.insert_slices_3d(zf, zt, vals.numpy(), c2w.numpy(), r.numpy(),
                                   vc.numpy(), vr.numpy(), pf, float((r_u - 1) * pf))
    close(f_t, f_j, 1e-5)
    close(t_t, t_j, 1e-5)
    # accumulation into given grids: inserting twice doubles the sums
    f_2, t_2 = ti.insert_trilinear(t(ft), ctf, img_idx, r, trans, w, r_u, pf, size,
                                   1.32, big, f_t.clone(), t_t.clone())
    close(f_2, 2 * np.asarray(f_j), 1e-5)
    close(t_2, 2 * np.asarray(t_j), 1e-5)


def _grids(big, seed):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((big,) * 3) + 1j * rng.standard_normal((big,) * 3))
    tt = np.abs(rng.standard_normal((big,) * 3)) + 0.5
    f = np.asarray(ji.hermitianize(jnp.asarray(f.astype(np.complex64))))
    tt = np.asarray(ji.hermitianize_real(jnp.asarray(tt.astype(np.float32))))
    return f, tt


def test_reconstruction_stages_match_jax():
    big, size, pf, max_r = 32, 16, 2, 7
    f, tt = _grids(big, 4)
    fsc = np.linspace(0.99, 0.05, 8).astype(np.float32)
    for join in (False, True):
        close(tr.wiener_filter_t(t(tt), t(fsc), pf, max_r, join),
              jr.wiener_filter_t(jnp.asarray(tt), jnp.asarray(fsc), pf, max_r, join), 1e-6)
    # the balance loop's FFTs run in another order: W drifts by float32
    # rounding per iteration
    w_t = tr.balance_weights(t(tt), pf, max_r)
    w_j = jr.balance_weights(jnp.asarray(tt), pf, max_r)
    close(w_t, w_j, 1e-4)
    close(tr.finalize_reconstruction(t(f), w_t, size, pf, max_r),
          jr.finalize_reconstruction(jnp.asarray(f), jnp.asarray(w_t.numpy()),
                                     size, pf, max_r), 1e-5)
    a_t, b_t = tr.reconstruct_two_pass(t(f), t(tt), t(fsc), size, pf, max_r)
    a_j, b_j = jr.reconstruct_two_pass(jnp.asarray(f), jnp.asarray(tt),
                                       jnp.asarray(fsc), size, pf, max_r)
    close(a_t, a_j, 1e-4)
    close(b_t, b_j, 1e-4)


def test_batched_lanes_equal_single_lanes():
    """Hemisphere lanes of the balance loop are independent loops."""
    big, pf, max_r = 24, 2, 5
    t1 = _grids(big, 5)[1]
    t2 = _grids(big, 6)[1] * 3.0
    both = tr.balance_weights(t(np.stack([t1, t2])), pf, max_r)
    for i, x in enumerate((t1, t2)):
        np.testing.assert_allclose(both[i].numpy(),
                                   tr.balance_weights(t(x), pf, max_r).numpy(), rtol=1e-6)


def test_reconstruction_golden():
    """Insert the reference harness's 60 slices at its poses with the
    port's trilinear insertion and reconstruct: the map agrees with the
    reference library's (the assertions of test_reference_goldens)."""
    n, pf = 32, 2
    gold = np.fromfile(os.path.join(G, "recon_32.bin"), np.float32).reshape(n, n, n)
    quats = np.fromfile(os.path.join(G, "recon_32_quats.bin"), np.float32).reshape(60, 4)
    c = n // 2
    k = np.arange(n) - c
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    phantom = (np.exp(-((kx - 3) ** 2 + ky ** 2 + kz ** 2) / (2 * 6.25))
               + np.exp(-((kx + 2) ** 2 + (ky - 2) ** 2 + kz ** 2) / 8.0)
               + np.exp(-(kx ** 2 + (ky + 3) ** 2 + (kz - 2) ** 2) / 4.5)
               ).astype(np.float32)
    proj = tp.prepare_projectee_3d(t(np.fft.ifftshift(phantom)), pf)
    r = trot(t(quats))
    slices = tp.project_full_3d(proj, r)                      # (60, n, n)
    r_u = n // 2
    vc = t(np.broadcast_to(k[None, :], (n, n)).reshape(-1).astype(np.int32))
    vr = t(np.broadcast_to(k[:, None], (n, n)).reshape(-1).astype(np.int32))
    q2 = (vc * vc + vr * vr).float()
    mask = (q2 < (r_u - 1) ** 2).float() * torch.where(q2 == 0, 2.0, 1.0)
    big = n * pf
    f, tt = ti.insert_slices_3d(torch.zeros((big,) * 3, dtype=torch.complex64),
                                torch.zeros((big,) * 3), slices.reshape(60, -1) * mask,
                                mask.expand(60, -1), r, vc, vr, pf,
                                float((r_u - 1) * pf))
    vol = tr.reconstruct(f, tt, n, pf, r_u)
    mine = np.fft.fftshift(vol.numpy())
    u = np.sqrt(kx ** 2 + ky ** 2 + kz ** 2)
    m = u < n // 2 - 3
    corr = np.corrcoef(gold[m], mine[m])[0, 1]
    assert corr > 0.99, corr
    scale = np.dot(gold[m], mine[m]) / np.dot(mine[m], mine[m])
    assert 0.8 < scale < 1.25, scale
    fg = np.fft.fftshift(np.fft.fftn(np.fft.ifftshift(gold)))
    fm = np.fft.fftshift(np.fft.fftn(np.fft.ifftshift(mine)))
    shell = np.rint(u).astype(int)
    sel = shell < n // 2
    num, pa, pb = (np.bincount(shell[sel], x[sel], n // 2) for x in
                   (np.real(fg * np.conj(fm)), np.abs(fg) ** 2, np.abs(fm) ** 2))
    fsc = num / np.maximum(np.sqrt(pa * pb), 1e-30)
    below = np.nonzero(fsc[1:] < 0.143)[0]
    crossing = int(below[0]) + 1 if below.size else n // 2
    assert crossing >= r_u - 2, fsc


def test_balance_loop_counts_and_runs_a_given_count():
    """The balance loop's helper gives balance_weights' W with each
    lane's count of iterations, and with n_iter runs that many with the
    stopping rule off, handing each count's W to ``each``: the free
    run's count gives its W again, one more iteration another W (the
    slab path's check in chip_smoke.py reads maps at several counts).
    Both runs take the same batch of lanes: an FFT of one lane and of two
    need not round alike (up to 8.3e-7 apart on an Intel Xeon CPU)."""
    rng = np.random.default_rng(3)
    big, pf, r = 24, 2, 5
    tg = rng.uniform(0.2, 2.0, (2,) + (big,) * 3).astype(np.float32)
    tg = t(tg + np.roll(np.flip(tg, axis=(1, 2, 3)), 1, axis=(1, 2, 3)))
    w, counts = tr._balance(tg, pf, r)
    assert torch.equal(w, tr.balance_weights(tg, pf, r))
    counts = counts.tolist()
    assert len(counts) == 2 and all(1 <= c <= 30 for c in counts)
    seen = {}
    n_run = max(counts) + 1
    again, n = tr._balance(tg, pf, r, n_iter=n_run,
                           each=lambda i, x: seen.__setitem__(i, x.clone()))
    assert n.tolist() == [n_run, n_run] and sorted(seen) == list(range(1, n_run + 1))
    for lane, count in enumerate(counts):
        assert torch.equal(seen[count][lane], w[lane])
    assert torch.equal(seen[n_run], again)
    assert not torch.equal(again[counts.index(max(counts))], w[counts.index(max(counts))])
