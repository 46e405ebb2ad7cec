"""Parity of the port's projector (host of HK1, project_slices; its plain
version on the CPU) with thunder_tpu's float32 paths — project_3d on a
Projectee and project_classed on ri-split float32 tables, not the
default bf16 corner-row tables — and the reference projector golden."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu.geometry.quaternion import random_quat, rotate3d  # noqa: E402
from thunder_tpu.ops import fourier as jf  # noqa: E402
from thunder_tpu.ops import projector as jp  # noqa: E402
from thunder_tpu_torch.ops import fourier as tf  # noqa: E402
from thunder_tpu_torch.ops import projector as tp  # noqa: E402

G = os.path.join(os.path.dirname(__file__), "goldens")
# trilinear sums of 8 float32 taps in the same order; spectra from FFTs
# in another order than XLA's
RTOL = 2e-5


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= rtol, err


def vol(size=16, seed=0):
    return np.random.default_rng(seed).standard_normal((size,) * 3).astype(np.float32)


def rots(shape, seed):
    return np.asarray(rotate3d(random_quat(jax.random.PRNGKey(seed), shape)))


def test_prepare_projectee_matches_jax():
    v = vol()
    close(tp.prepare_projectee_3d(t(v), 2).ft, jp.prepare_projectee_3d(jnp.asarray(v), 2).ft)
    for crop in (20, 32):
        close(tp.prepare_projectee_3d_cropped(t(v), 2, crop),
              jp.prepare_projectee_3d_cropped(jnp.asarray(v), 2, crop))


def test_project_3d_matches_jax():
    v = vol(seed=1)
    jproj = jp.prepare_projectee_3d(jnp.asarray(v), 2)
    tproj = tp.prepare_projectee_3d(t(v), 2)
    r = rots((12,), 2)
    for r_u in (5, 7):
        jr, tr = jf.pack_rings(16, r_u, 0), tf.pack_rings(16, r_u, 0)
        close(tp.project_3d(tproj, t(r), tr), jp.project_3d(jproj, jnp.asarray(r), jr))


@pytest.mark.parametrize("crop", [14, 32])
def test_project_classed_matches_jax_f32_table(crop):
    """Per-image rotations from each image's own class; crop 14 puts
    taps beyond the table so the index clipping is exercised."""
    vs = np.stack([vol(seed=3), vol(seed=4)])
    tab = np.asarray(jnp.stack([jp.prepare_projectee_3d_cropped(jnp.asarray(v), 2, crop)
                                for v in vs]))
    ri = jp.ri_split(jnp.asarray(tab), pack_bf16=False)
    cls = np.asarray([0, 1, 1, 0, 1], np.int32)
    r = rots((5, 7), 5)
    jr, tr = jf.pack_rings(16, 7, 0), tf.pack_rings(16, 7, 0)
    ref = jp.project_classed(ri, jnp.asarray(cls), jnp.asarray(r), jr, 2, False)
    got = tp.project_classed(t(tab), t(cls), t(r), tr, 2)
    close(got, ref)


def test_shared_rotation_block_broadcasts():
    """A rotation block expanded over images (stride 0) gives the same
    slices as a materialised copy."""
    tab = tp.prepare_projectee_3d_cropped(t(vol(seed=6))[None], 2, 24)
    r = t(rots((1, 9), 7))
    rings = tf.pack_rings(16, 5, 0)
    a = tp.project_slices(tab, r.expand(3, 9, 3, 3), rings.i_col, rings.i_row, 2)
    b = tp.project_slices(tab, r.repeat(3, 1, 1, 1), rings.i_col, rings.i_row, 2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _cplx_table(k, n, seed):
    rng = np.random.default_rng(seed)
    return t((rng.standard_normal((k, n, n, n))
              + 1j * rng.standard_normal((k, n, n, n))).astype(np.complex64))


def test_quad_taps_hold_the_plain_taps():
    """HK1's quad table, tap for tap: cell (z, y, x) holds t[z, y, x],
    t[z, y, x+], t[z, y+, x], t[z, y+, x+] with + clipped to n - 1
    (tolerance 0: a copy)."""
    n = 6
    tab = _cplx_table(2, n, 10)
    q = torch.view_as_complex(tp.quad_taps(tab).reshape(2, n, n, n, 4, 2))
    assert tp.is_quad_table(tp.quad_taps(tab)) and not tp.is_quad_table(tab)
    nxt = np.minimum(np.arange(n) + 1, n - 1)
    ref = tab.numpy()
    np.testing.assert_array_equal(q[..., 0].numpy(), ref)
    np.testing.assert_array_equal(q[..., 1].numpy(), ref[..., nxt])
    np.testing.assert_array_equal(q[..., 2].numpy(), ref[..., nxt, :])
    np.testing.assert_array_equal(q[..., 3].numpy(), ref[..., nxt, :][..., nxt])


@pytest.mark.parametrize("crop", [14, 32])
def test_project_slices_from_quad_table_is_exact(crop):
    """The quad table gives the plain table's slices exactly (tolerance
    0), and thunder_tpu's; crop 14 is smaller than the band reaches, so
    taps clip at every face of the cube."""
    vs = np.stack([vol(seed=3), vol(seed=4)])
    tab = np.asarray(jnp.stack([jp.prepare_projectee_3d_cropped(jnp.asarray(v), 2, crop)
                                for v in vs]))
    cls = np.asarray([0, 1, 1, 0, 1], np.int32)
    r = rots((5, 7), 5)
    jr, tr = jf.pack_rings(16, 7, 0), tf.pack_rings(16, 7, 0)
    plain = tp.project_classed(t(tab), t(cls), t(r), tr, 2)
    quad = tp.project_classed(tp.quad_taps(t(tab)), t(cls), t(r), tr, 2)
    np.testing.assert_array_equal(quad.numpy(), plain.numpy())
    ri = jp.ri_split(jnp.asarray(tab), pack_bf16=False)
    close(quad, jp.project_classed(ri, jnp.asarray(cls), jnp.asarray(r), jr, 2, False))


def test_project_slices_clips_at_the_full_box():
    """crop = the full padded box with coordinates pushed to and past
    its faces (pf 3 on a band the box does not hold): every tap index
    clips as _gather_trilinear_3d clips it, from either layout."""
    v = vol(size=8, seed=8)
    proj = jp.prepare_projectee_3d(jnp.asarray(v), 2)
    tab = t(np.asarray(proj.ft))[None]                       # (1, 16, 16, 16)
    r = rots((1, 9), 9)
    jr, tr = jf.pack_rings(16, 7, 0), tf.pack_rings(16, 7, 0)
    x = np.abs(np.asarray(r)[0, :, :, :2] @ np.stack([jr.i_col, jr.i_row]) * 3)
    assert x.max() > 8 + 1                                   # beyond the last cell
    ref = jp.project_3d(proj._replace(pf=3), jnp.asarray(r[0]), jr)   # _gather_trilinear_3d
    for table in (tab, tp.quad_taps(tab)):
        got = tp.project_slices(table, t(r), tr.i_col, tr.i_row, 3)[0]
        close(got, ref)


def test_quad_fits_near_l2():
    """The quad layout is kept while 32 bytes a cell stay near the 50 MB
    L2: two 92^3 cubes (128 px, r = 22) do, two 176^3 (256 px) do not."""
    assert tp.quad_fits(2, 92) and not tp.quad_fits(2, 176)


def test_projector_slices_golden():
    n = 32
    gold = np.fromfile(os.path.join(G, "proj_slices_32.bin"), np.float32)
    gold = (gold[0::2] + 1j * gold[1::2]).reshape(3, n, n)
    c = n // 2
    k = np.arange(n) - c
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    phantom = (np.exp(-((kx - 3) ** 2 + ky ** 2 + kz ** 2) / (2 * 6.25))
               + np.exp(-((kx + 2) ** 2 + (ky - 2) ** 2 + kz ** 2) / 8.0)
               + np.exp(-(kx ** 2 + (ky + 3) ** 2 + (kz - 2) ** 2) / 4.5)
               ).astype(np.float32)
    q = np.asarray([[1.0, 0.0, 0.0, 0.0],
                    [0.96592583, 0.14644661, 0.14644661, 0.17677670],
                    [0.81, -0.31, 0.41, 0.29]])
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    proj = tp.prepare_projectee_3d(t(np.fft.ifftshift(phantom)), 2)
    from thunder_tpu_torch.geometry.quaternion import rotate3d as trot
    mine = tp.project_full_3d(proj, trot(t(q))).numpy()
    ky2, kx2 = np.meshgrid(k, k, indexing="ij")
    inside = kx2 ** 2 + ky2 ** 2 < (n // 2 - 1) ** 2
    for i in range(3):
        g, m = gold[i][inside], mine[i][inside]
        assert np.abs(g - m).max() / np.abs(g).max() < 2e-3
