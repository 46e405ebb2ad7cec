"""Parity of the port's likelihood (host of HK2, likelihood_block; its
plain version on the CPU) with thunder_tpu: the global search's w_c /
w_r / w_t against optimiser._global_search on a float32 table, and the
phase loop's u_r / u_t against the deterministic part of
optimiser._phase_body given the same particle state."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu.geometry.quaternion import random_quat, rotate3d  # noqa: E402
from thunder_tpu.ops import fourier as jf  # noqa: E402
from thunder_tpu.ops import likelihood as jl  # noqa: E402
from thunder_tpu.ops import projector as jp  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch.ops import fourier as tf  # noqa: E402
from thunder_tpu_torch.ops import likelihood as tl  # noqa: E402
from thunder_tpu_torch.ops import projector as tp  # noqa: E402

SIZE, PF = 16, 2


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= rtol, err


def operands(n_img, seed=0, r_u=6):
    """Likelihood operands of realistic scale from a random reference:
    images are noisy slices, sigRcp ~ -0.5 / noise power."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((SIZE,) * 3).astype(np.float32)
    crop = jo._proj_crop_size(SIZE, PF, r_u)
    tab = np.asarray(jp.prepare_projectee_3d_cropped(jnp.asarray(v), PF, crop))
    rings = jf.pack_rings(SIZE, r_u, 1)
    p = rings.i_col.shape[0]
    rot = np.asarray(rotate3d(random_quat(jax.random.PRNGKey(seed), (n_img,))))
    sl = np.asarray(jp.project_3d(jp.Projectee(jnp.asarray(tab), SIZE, PF, 7),
                                  jnp.asarray(rot), rings))
    sl = sl / np.abs(sl).std()
    dat = (sl + rng.standard_normal((n_img, p)) + 1j * rng.standard_normal((n_img, p)))
    ctf = rng.uniform(0.3, 1.0, (n_img, p)).astype(np.float32)
    s = -0.5 / 2.0 * np.asarray(rings.mask)
    dat_w = (s * ctf * dat).astype(np.complex64)
    sctf2 = (s * ctf * ctf).astype(np.float32)
    a_term = np.sum(s * np.abs(dat) ** 2, -1).astype(np.float32)
    return tab, rings, dat_w, sctf2, a_term


def test_log_dvp_matches_jax():
    tab, rings, dat_w, sctf2, a_term = operands(4, 1)
    rng = np.random.default_rng(2)
    pri = (rng.standard_normal((6, dat_w.shape[1]))
           + 1j * rng.standard_normal((6, dat_w.shape[1]))).astype(np.complex64)
    tra = np.asarray(jf.translate_phases(rings, jnp.asarray(rng.uniform(-2, 2, (5, 2)),
                                                            jnp.float32)))
    ref = jl.log_dvp_block(dat_w, sctf2, pri, tra, a_term)
    close(tl.log_dvp_block(t(dat_w), t(sctf2), t(pri), t(tra), t(a_term)), ref, 1e-5)
    pri_l = np.stack([pri] * 4) * (1 + 0.1 * np.arange(4))[:, None, None]
    tra_l = np.stack([tra] * 4)
    ref = jl.log_dvp_local(dat_w, sctf2, pri_l.astype(np.complex64), tra_l, a_term)
    close(tl.log_dvp_local(t(dat_w), t(sctf2), t(pri_l.astype(np.complex64)),
                           t(tra_l), t(a_term)), ref, 1e-5)


def test_global_search_matches_jax():
    """Streaming log-sum-exp over 3 rotation blocks == JAX scan (w_c,
    w_r, w_t), both on a float32 table."""
    n_img, block, n_blocks, n_t = 5, 16, 3, 7
    tab, rings, dat_w, sctf2, a_term = operands(n_img, 3)
    rot = np.asarray(rotate3d(random_quat(jax.random.PRNGKey(4), (n_blocks, block))))
    trans = np.random.default_rng(5).uniform(-2, 2, (n_t, 2)).astype(np.float32)
    tra = np.asarray(jf.translate_phases(rings, jnp.asarray(trans)))
    ri = jp.ri_split(jnp.asarray(tab)[None], pack_bf16=False)
    jwc, jwr, jwt = jo._global_search(ri, jnp.asarray(rot), rings.i_col, rings.i_row,
                                      dat_w, sctf2, a_term, tra, SIZE, PF, False)
    trings = tf.pack_rings(SIZE, 6, 1)
    wc, wr, wt = to.global_search(t(tab)[None], t(rot), trings, t(dat_w), t(sctf2),
                                  t(a_term), t(tra), PF)
    # exp(dvp - max) with |dvp| ~ 1e3: float32 rounding of the baseline
    for a, b in ((wc, jwc), (wr, jwr), (wt, jwt)):
        close(a, b, 1e-4)


def test_phase_marginals_match_jax_phase_body():
    """u_r / u_t of _phase_body's deterministic part (rotate, project,
    likelihood, max, exp, prior-weighted marginals) given one state."""
    n_img, n_r, n_t = 4, 10, 9
    tab, rings, dat_w, sctf2, a_term = operands(n_img, 6)
    rng = np.random.default_rng(7)
    q = np.asarray(random_quat(jax.random.PRNGKey(8), (n_img, n_r)))
    trans = rng.uniform(-2, 2, (n_img, n_t, 2)).astype(np.float32)
    w_r = rng.random((n_img, n_r)).astype(np.float32)
    w_t = rng.random((n_img, n_t)).astype(np.float32)
    cls = np.zeros(n_img, np.int32)
    # JAX: optimiser._phase_body lines 487-502, float32 table
    ri = jp.ri_split(jnp.asarray(tab)[None], pack_bf16=False)
    tra = jo.translate_phases_view(rings.i_col, rings.i_row, SIZE, jnp.asarray(trans))
    pri = jp.project_classed(ri, jnp.asarray(cls), rotate3d(jnp.asarray(q)), rings, PF, False)
    dvp = jl.log_dvp_local(dat_w, sctf2, pri, tra, a_term)
    w = jnp.exp(dvp - jnp.max(dvp, axis=(1, 2), keepdims=True))
    ju_r = jnp.einsum("lrt,lt->lr", w, w_t)
    ju_t = jnp.einsum("lrt,lr->lt", w, w_r)
    # port: HK1 -> matmuls -> HK2
    trings = tf.pack_rings(SIZE, 6, 1)
    from thunder_tpu_torch.geometry.quaternion import rotate3d as trot
    ttra = tf.translate_phases_view(trings.i_col, trings.i_row, SIZE, t(trans))
    tpri = tp.project_slices(t(tab)[None], trot(t(q)), trings.i_col, trings.i_row, PF,
                             t(cls))
    b, c = tl.local_terms(tl.modulate(t(dat_w), ttra), t(sctf2), tpri)
    u_r, u_t = tl.local_marginals(t(a_term), b, c, t(w_r), t(w_t))
    close(u_r, ju_r, 1e-4)
    close(u_t, ju_t, 1e-4)


def test_streaming_blocks_equal_one_softmax():
    """likelihood_block over two column blocks == one block over all
    columns (the rescale of earlier blocks and of w_c / w_t)."""
    rng = np.random.default_rng(9)
    n_img, n_r, n_t = 3, 8, 5
    a = t(rng.standard_normal(n_img).astype(np.float32) * 3)
    b = t(rng.standard_normal((n_img, 2 * n_r)).astype(np.float32) * 5)
    c = t(rng.standard_normal((n_img, 2 * n_r, n_t)).astype(np.float32) * 5)
    w_r = t(rng.random((n_img, 2 * n_r)).astype(np.float32))
    w_t = t(rng.random((n_img, n_t)).astype(np.float32))

    def fresh(cols):
        # columns of blocks not seen yet hold zero running sums
        return (torch.full((n_img,), float("-inf")), torch.empty(n_img),
                torch.zeros(n_img, cols), torch.empty(n_img, n_t))

    one = fresh(2 * n_r)
    tl.likelihood_block(a, b, c, w_r, w_t, *one)
    two = fresh(2 * n_r)
    for k in range(2):
        sl = slice(k * n_r, (k + 1) * n_r)
        tl.likelihood_block(a, b[:, sl], c[:, sl], w_r[:, sl], w_t, *two, col0=k * n_r)
    for x, y in zip(one, two):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5)
