"""Parity of the port's likelihood (host of HK2, likelihood_block; its
plain version on the CPU) with thunder_tpu: the global search's w_c /
w_r / w_t against optimiser._global_search on float32 tables (one and
three classes), the phase loop's u_r / u_t against the deterministic
part of optimiser._phase_body given the same particle state (one and
two classes of per-image supports in one call), and HK2's launch plan
at the main path's block shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def _jax_phase_marginals(tab, cls, q, trans, dat_w, sctf2, a_term, w_r, w_t, rings):
    """u_r / u_t of optimiser._phase_body lines 487-502 (rotate,
    project, likelihood, max, exp, prior-weighted marginals), float32
    table."""
    ri = jp.ri_split(jnp.asarray(tab), pack_bf16=False)
    tra = jo.translate_phases_view(rings.i_col, rings.i_row, SIZE, jnp.asarray(trans))
    pri = jp.project_classed(ri, jnp.asarray(cls), rotate3d(jnp.asarray(q)), rings, PF, False)
    dvp = jl.log_dvp_local(dat_w, sctf2, pri, tra, a_term)
    w = jnp.exp(dvp - jnp.max(dvp, axis=(1, 2), keepdims=True))
    return jnp.einsum("lrt,lt->lr", w, w_t), jnp.einsum("lrt,lr->lt", w, w_r)


def test_phase_marginals_match_jax_phase_body():
    """u_r / u_t of _phase_body's deterministic part given one state,
    against the port's HK1 -> HK2 (per-image supports, one call)."""
    n_img, n_r, n_t = 4, 10, 9
    tab, rings, dat_w, sctf2, a_term = operands(n_img, 6)
    rng = np.random.default_rng(7)
    q = np.asarray(random_quat(jax.random.PRNGKey(8), (n_img, n_r)))
    trans = rng.uniform(-2, 2, (n_img, n_t, 2)).astype(np.float32)
    w_r = rng.random((n_img, n_r)).astype(np.float32)
    w_t = rng.random((n_img, n_t)).astype(np.float32)
    cls = np.zeros(n_img, np.int32)
    ju_r, ju_t = _jax_phase_marginals(tab[None], cls, q, trans, dat_w, sctf2, a_term,
                                      w_r, w_t, rings)
    trings = tf.pack_rings(SIZE, 6, 1)
    from thunder_tpu_torch.geometry.quaternion import rotate3d as trot
    ttra = tf.translate_phases_view(trings.i_col, trings.i_row, SIZE, t(trans))
    tpri = tp.project_slices(t(tab)[None], trot(t(q)), trings.i_col, trings.i_row, PF,
                             t(cls))
    u_r, u_t = tl.local_marginals(t(dat_w), t(sctf2), t(a_term), tpri, ttra, t(w_r), t(w_t))
    close(u_r, ju_r, 1e-4)
    close(u_t, ju_t, 1e-4)


def test_per_image_supports_of_several_classes_in_one_call():
    """One likelihood_block call over K = 2 classes of per-image supports
    (pri (K, L, R, P), tra (L, T, P)): each class's marginals, brought
    to its own baseline, equal _phase_body's for that class."""
    n_img, n_r, n_t = 3, 7, 5
    tab, rings, dat_w, sctf2, a_term = operands(n_img, 11)
    tab2 = np.stack([tab, 0.7 * np.roll(tab, 1, axis=0)])
    rng = np.random.default_rng(12)
    q = np.asarray(random_quat(jax.random.PRNGKey(13), (n_img, n_r)))
    trans = rng.uniform(-2, 2, (n_img, n_t, 2)).astype(np.float32)
    w_r = rng.random((n_img, n_r)).astype(np.float32)
    w_t = rng.random((n_img, n_t)).astype(np.float32)
    trings = tf.pack_rings(SIZE, 6, 1)
    from thunder_tpu_torch.geometry.quaternion import rotate3d as trot
    ttra = tf.translate_phases_view(trings.i_col, trings.i_row, SIZE, t(trans))
    tpri = torch.stack([tp.project_slices(t(tab2), trot(t(q)), trings.i_col, trings.i_row,
                                          PF, torch.full((n_img,), k)) for k in range(2)])
    base = torch.full((2, n_img), float("-inf"))
    acc = (torch.empty(2, n_img), torch.zeros(2, n_img, n_r), torch.empty(2, n_img, n_t))
    tl.likelihood_block(t(dat_w), t(sctf2), t(a_term), tpri, ttra, t(w_r), t(w_t), base,
                        *acc)
    for k in range(2):
        ju_r, ju_t = _jax_phase_marginals(tab2, np.full(n_img, k, np.int32), q, trans,
                                          dat_w, sctf2, a_term, w_r, w_t, rings)
        close(acc[1][k], ju_r, 1e-4)
        close(acc[2][k], ju_t, 1e-4)


def test_global_search_of_several_classes_matches_jax():
    """K = 3 classes' rotation blocks shared by all images (pri image
    stride 0, shared translations), one likelihood_block call per block:
    w_c, w_r, w_t of the port's global_search against _global_search's
    scan over (class x block) on float32 tables."""
    n_img, block, n_blocks, n_t = 4, 8, 2, 6
    tab, rings, dat_w, sctf2, a_term = operands(n_img, 14)
    tabs = np.stack([tab, 0.8 * tab.conj(), np.roll(tab, 2, axis=1)]).astype(np.complex64)
    rot = np.asarray(rotate3d(random_quat(jax.random.PRNGKey(15), (n_blocks, block))))
    trans = np.random.default_rng(16).uniform(-2, 2, (n_t, 2)).astype(np.float32)
    tra = np.asarray(jf.translate_phases(rings, jnp.asarray(trans)))
    ri = jp.ri_split(jnp.asarray(tabs), pack_bf16=False)
    jw = jo._global_search(ri, jnp.asarray(rot), rings.i_col, rings.i_row, dat_w, sctf2,
                           a_term, tra, SIZE, PF, False)
    tw = to.global_search(t(tabs), t(rot), tf.pack_rings(SIZE, 6, 1), t(dat_w), t(sctf2),
                          t(a_term), t(tra), PF)
    for a, b in zip(tw, jw):
        close(a, b, 1e-4)


def _plan_cover(plan, n_r: int, n_t: int) -> np.ndarray:
    """How often the kernel's sub-block loop and thread tiles visit each
    (t, r) of an R x T block under ``plan``."""
    tm, tn, n_tt, n_rt, rb = (plan[k] for k in ("tm", "tn", "n_tt", "n_rt", "rb"))
    assert rb == n_rt * tn and plan["n_sub"] == -(-n_r // rb)
    seen = np.zeros((n_t, n_r), np.int64)
    for r0 in range(0, n_r, rb):
        for tile in range(n_tt * n_rt):
            tt, rt = divmod(tile, n_rt)
            for i in range(tm):
                for j in range(tn):
                    t_, r_ = tt + i * n_tt, rt + j * n_rt
                    if t_ < n_t and r_ < min(rb, n_r - r0):
                        seen[t_, r0 + r_] += 1
    return seen


@pytest.mark.parametrize("n_r,n_t", [(256, 30), (125, 9), (100, 151), (9, 9), (104, 151),
                                     (256, 64), (256, 151)])
def test_likelihood_plan_fits_shared_memory(n_r, n_t):
    """HK2's launch plan at the main-path blocks (3D global 256 x 30,
    3D phase 125 x 9, 2D global 100 x 151, 2D phase 9 x 9), at 104 x 151
    and 256 x 64, and at 256 x 151 (the 3D global block of
    configs/demo_3D.json's translations, taken in rotation sub-blocks):
    every (t, r) of the block in exactly one thread's tile of one
    sub-block, at most 256 threads, and the shared memory within
    Hopper's 227 KB."""
    plan = tl.likelihood_plan(n_r, n_t)
    assert plan["smem"] <= 227 * 1024
    assert plan["threads"] <= 256 and plan["threads"] % 32 == 0
    assert plan["n_tt"] * plan["n_rt"] <= plan["threads"]
    assert (_plan_cover(plan, n_r, n_t) == 1).all()


@pytest.mark.parametrize("n_t", [9, 30, 151, 600])
def test_rotation_block_fits_the_plan(n_t):
    """The global search's 256-rotation block (thunder_tpu's _ROT_BLOCK)
    takes a plan at T translations: one pass where 256 tiles of 8 x 8
    cover it, else the fewest sub-blocks that do, each within 256
    threads and Hopper's shared memory."""
    plan = tl.likelihood_plan(to.ROT_BLOCK, n_t)
    assert to.ROT_BLOCK == jo._ROT_BLOCK == 256
    assert (_plan_cover(plan, to.ROT_BLOCK, n_t) == 1).all()
    assert plan["smem"] <= 227 * 1024 and plan["threads"] <= 256
    n_sub, n_tt = plan["n_sub"], -(-n_t // 8)
    assert (n_sub == 1) == (n_t <= 64)
    # one sub-block fewer would need more than 256 tiles of 8 x 8
    assert n_sub == 1 or n_tt * -(-(-(-256 // (n_sub - 1))) // 8) > 256
    with pytest.raises(ValueError):
        tl.likelihood_plan(to.ROT_BLOCK, 8 * 256 + 1)


def test_streaming_blocks_equal_one_softmax():
    """likelihood_block over two rotation blocks == one block over all
    rotations (the rescale of earlier blocks and of w_c / w_t), for two
    classes with shared translations."""
    n_img, n_r, n_t = 3, 8, 5
    tab, rings, dat_w, sctf2, a_term = operands(n_img, 9)
    rng = np.random.default_rng(9)
    pri = t((rng.standard_normal((2, n_img, 2 * n_r, dat_w.shape[1]))
             + 1j * rng.standard_normal((2, n_img, 2 * n_r, dat_w.shape[1])))
            .astype(np.complex64))
    tra = t(np.asarray(jf.translate_phases(rings, jnp.asarray(
        rng.uniform(-2, 2, (n_t, 2)), jnp.float32))))[None].expand(n_img, -1, -1)
    w_r = t(rng.random((n_img, 2 * n_r)).astype(np.float32))
    w_t = t(rng.random((n_img, n_t)).astype(np.float32))
    # sigRcp scaled so that dvp spans a few units, as in a block of
    # close poses: the comparison is of the streaming rescale, not of
    # exp's amplification of rounding in large dvp
    ops = (t(0.02 * dat_w), t(0.02 * sctf2), t(0.02 * a_term))

    def fresh(cols):
        # columns of blocks not seen yet hold zero running sums
        return (torch.full((2, n_img), float("-inf")), torch.empty(2, n_img),
                torch.zeros(2, n_img, cols), torch.empty(2, n_img, n_t))

    one = fresh(2 * n_r)
    tl.likelihood_block(*ops, pri, tra, w_r, w_t, *one)
    two = fresh(2 * n_r)
    for k in range(2):
        sl = slice(k * n_r, (k + 1) * n_r)
        tl.likelihood_block(*ops, pri[:, :, sl], tra, w_r[:, sl], w_t, *two, col0=k * n_r)
    for x, y in zip(one, two):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5)
