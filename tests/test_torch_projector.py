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
