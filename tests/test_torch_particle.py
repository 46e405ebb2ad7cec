"""Parity of the port's particle filter with thunder_tpu.particle on the
CPU: the deterministic functions exactly (up to float32 rounding), and
the randomised ones given the same draws — the JAX keys make the
uniforms / normals, which are handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu import particle as jpt  # noqa: E402
from thunder_tpu_torch import particle as tpt  # noqa: E402

L, NR, NT, ND = 6, 32, 9, 1


def t(x):
    return torch.as_tensor(np.array(x))


def make_state(seed=0, dup=False):
    """A random cloud state as numpy; ``dup`` repeats support points in
    contiguous runs, as systematic resampling leaves them."""
    rng = np.random.default_rng(seed)
    k = np.asarray([1.0, 0.04, 0.1, 0.02], np.float32)
    r = rng.standard_normal((L, NR, 4)) * np.sqrt(k)
    r = r + np.asarray([1.0, 0, 0, 0])
    r /= np.linalg.norm(r, axis=-1, keepdims=True)
    tr = rng.standard_normal((L, NT, 2)) * 1.5
    if dup:
        ir = np.sort(rng.integers(0, NR, (L, NR)), axis=1)
        it = np.sort(rng.integers(0, NT, (L, NT)), axis=1)
        r = np.take_along_axis(r, ir[..., None], 1)
        tr = np.take_along_axis(tr, it[..., None], 1)
    u = lambda *s: rng.random(s).astype(np.float32) + 0.01
    f = lambda a: np.asarray(a, np.float32)
    return dict(
        r=f(r), t=f(tr), d=np.ones((L, ND), np.float32),
        w_r=f(u(L, NR) / NR), w_t=f(u(L, NT) / NT), w_d=np.ones((L, ND), np.float32),
        u_r=u(L, NR), u_t=u(L, NT), u_d=np.ones((L, ND), np.float32),
        top_r=f(r[:, 0]), top_t=f(tr[:, 0]), top_d=np.ones(L, np.float32),
        k1=u(L), k2=u(L), k3=u(L), s0=u(L), s1=u(L), s_d=np.zeros(L, np.float32),
        score=np.zeros(L, np.float32))


def both(d):
    return (jpt.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()}),
            tpt.ParticleState(**{k: t(v) for k, v in d.items()}))


def check(ts, js, fields, rtol=1e-4, atol=1e-6):
    for f in fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


def test_variance_inference():
    js, ts = both(make_state(1))
    check(tpt.cal_vari_r(ts), jpt.cal_vari_r(js, jpt.MODE_3D), ["k1", "k2", "k3"])
    check(tpt.cal_vari_t(ts), jpt.cal_vari_t(js), ["s0", "s1"])
    check(tpt.cal_vari_d(ts), jpt.cal_vari_d(js), ["s_d"])
    check(tpt.cal_score(ts), jpt.cal_score(js, jpt.MODE_3D), ["score"])


def test_balance_weights_and_clipping():
    js, ts = both(make_state(2))
    check(tpt.balance_weight_r(ts), jpt.balance_weight_r(js, jpt.MODE_3D), ["w_r"], 1e-3)
    check(tpt.balance_weight_t(ts), jpt.balance_weight_t(js), ["w_t"])
    check(tpt.clip_u_r(ts), jpt.clip_u_r(js, jpt.MODE_3D), ["u_r"])
    check(tpt.clip_u_t(ts), jpt.clip_u_t(js), ["u_t"])
    for base in (2, 8):
        np.testing.assert_allclose(tpt.peak_factor(ts.u_r, base).numpy(),
                                   np.asarray(jpt.peak_factor(js.u_r, base)), rtol=1e-6)
    w_c = np.random.default_rng(3).random((L, 3)).astype(np.float32)
    np.testing.assert_allclose(tpt.clip_u_class(t(w_c)).numpy(),
                               np.asarray(jpt.clip_u_class(jnp.asarray(w_c))), rtol=1e-6)


def test_balance_weight_r_collapsed_cloud_is_uniform():
    d = make_state(4)
    d["r"][:] = d["r"][:, :1]
    _, ts = both(d)
    w = tpt.balance_weight_r(ts).w_r.numpy()
    np.testing.assert_allclose(w, 1.0 / NR, rtol=1e-6)


@pytest.mark.parametrize("n_new", [NR, 12])
def test_systematic_resample_given_uniforms(n_new):
    js, ts = both(make_state(5))
    key = jax.random.PRNGKey(7)
    idx_j, w_j = jpt.systematic_resample(key, js.w_r, js.u_r, n_new)
    u0 = np.asarray(jax.random.uniform(key, (L, 1)))
    idx_t, w_t = tpt.systematic_resample(None, ts.w_r, ts.u_r, n_new, u0=t(u0))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-5)


def test_resample_given_uniforms():
    js, ts = both(make_state(6))
    kr, kt = jax.random.PRNGKey(8), jax.random.PRNGKey(9)
    jr = jpt.resample_t(kt, jpt.resample_r(kr, js, NR), NT)
    u_r = t(np.asarray(jax.random.uniform(kr, (L, 1))))
    u_t = t(np.asarray(jax.random.uniform(kt, (L, 1))))
    tr = tpt.resample_t(None, tpt.resample_r(None, ts, NR, u0=u_r), NT, u0=u_t)
    check(tr, jr, ["r", "t", "w_r", "w_t", "u_r", "u_t", "top_r", "top_t"], 1e-5)


def test_perturbation_given_noise():
    js, ts = both(make_state(10))
    key = jax.random.PRNGKey(11)
    jr = jpt.perturb_r(key, js, 0.5, jpt.MODE_3D)
    keys = jax.random.split(key, L)
    noise = np.stack([np.asarray(jax.random.normal(k, (NR, 4))) for k in keys])
    tr = tpt.perturb_r(None, ts, 0.5, noise=t(noise))
    # the perturbed clouds go through the ACG fit again (w_r): its
    # fixed-point iteration amplifies float32 rounding
    check(tr, jr, ["r"], 1e-4, 1e-5)
    check(tr, jr, ["w_r"], 1e-2, 1e-6)
    jt = jpt.perturb_t(key, js, 0.5, 2.0)
    noise = np.asarray(jax.random.normal(key, (L, NT, 2)))
    fresh = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (L, NT, 2)))
    tt = tpt.perturb_t(None, ts, 0.5, 2.0, noise=t(noise), fresh=t(fresh))
    check(tt, jt, ["t", "w_t"], 1e-5)


def test_draw_poses_compact_given_draws():
    js, ts = both(make_state(12, dup=True))
    key = jax.random.PRNGKey(13)
    n_draw, n_slots = 20, 6
    qj, tj, dj, wj = jpt.draw_poses_compact(key, js, n_draw, n_slots)
    kr, kt, kd = jax.random.split(key, 3)
    draws = tuple(t(np.asarray(jax.random.randint(k, (L, n_draw), 0, n)))
                  for k, n in ((kr, NR), (kt, NT), (kd, ND)))
    qt, tt, dt, wt = tpt.draw_poses_compact(None, ts, n_draw, n_slots, draws=draws)
    for a, b in ((qt, qj), (tt, tj), (dt, dj), (wt, wj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(wt.sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(tpt._run_ids(ts.r).numpy(),
                                  np.asarray(jpt._run_ids(js.r)))


def test_from_thu_keeps_saved_pose_as_rank_one():
    rng = np.random.default_rng(14)
    q = rng.standard_normal((L, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tr = rng.standard_normal((L, 2))
    st = np.full((L, 2), 0.3)
    k123 = np.full((L, 3), 1e-4)
    g = torch.Generator().manual_seed(0)
    s = tpt.from_thu(q, tr, st, k123, np.ones(L), np.zeros(L), NR, NT, ND, g)
    np.testing.assert_allclose(s.r[:, 0].numpy(), q, rtol=1e-6)
    np.testing.assert_allclose(s.top_t.numpy(), tr, rtol=1e-6)
    dots = np.abs(np.sum(s.r.numpy() * q[:, None], -1))
    assert np.median(dots) > 0.99
    np.testing.assert_allclose(s.s0.numpy(), 0.3, rtol=1e-6)
