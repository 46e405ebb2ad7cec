"""The cell-owned enumeration of HK3 and HK6 (the gathers of
csrc/insert_trilinear.cu and csrc/insert_bilinear_2d.cu), and the
fixed-point sums of HK11's slab form, on the CPU.

The kernels cannot run here, so ``ops/insert.py``'s ``*_gather_plain``
emulate the gathers, vectorised over cells: the same candidate range and
prefilter, float expressions, cuts, tap weights and face cells;
``insert_sweep_slab_fixed_plain`` emulates the slab form's 128-bit sums.
Each case holds the emulation to the port's scatter twin and, through
the same inputs, to thunder_tpu's insert_slices_3d / insert_slices_2d
(HK11's slab form: to its plain version), within 1e-6 of max |F| and max
|T|: the same (sample, tap, weight) triples summed in another order (or
in fixed point)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu.ops import insert as ji  # noqa: E402
from thunder_tpu_torch.geometry.quaternion import rotate2d_from_unit, rotate3d  # noqa: E402
from thunder_tpu_torch.geometry.symmetry import Symmetry  # noqa: E402
from thunder_tpu_torch.ops import insert as ti  # noqa: E402
from thunder_tpu_torch.physics.ctf import ctf_params  # noqa: E402

TOL = 1e-6
SIZE, PIX = 16, 1.32


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, err


def images(rng, n_img, size=SIZE):
    ft = torch.fft.fftshift(torch.fft.fft2(torch.as_tensor(
        rng.standard_normal((n_img, size, size)).astype(np.float32))), dim=(-2, -1))
    defocus = rng.uniform(8000, 20000, n_img)
    ctf = ctf_params(np.full(n_img, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, n_img),
                     np.full(n_img, 2e7), np.full(n_img, 0.1), np.zeros(n_img))
    return ft.to(torch.complex64).contiguous(), ctf


def rotations(rng, n, kind):
    """Random rotations, or quarter turns about the axes (positions on
    whole cells: floors at their boundaries, weights 0 and 1)."""
    if kind == "random":
        q = rng.standard_normal((n, 4)).astype(np.float32)
        return rotate3d(torch.as_tensor(q / np.linalg.norm(q, axis=1, keepdims=True)))
    mats = Symmetry("O").matrices
    return mats[torch.as_tensor(rng.integers(0, mats.shape[0], n))]


def taps_pass_faces(rot, r_u, pf, big) -> bool:
    """Whether a tap of an in-disc sample lands past the grid's faces
    (clipped onto them by the scatter)."""
    vc, vr, mask = ti.dense_window(r_u)
    g = torch.stack([vc * pf, vr * pf] + [vc * 0] * (rot.shape[-1] - 2), -1).float()
    p = torch.einsum("bij,pj->bpi", rot, g)[:, mask > 0]
    lo = torch.floor(p).long() + big // 2
    return bool(((lo < 0) | (lo + 1 > big - 1)).any())


def zeros3(big, k=None, bz=None):
    shape = (big,) * 3 if k is None else (k, bz, big, big)
    return torch.zeros(shape, dtype=torch.complex64), torch.zeros(shape)


# (label, r_u, pf, big, rotations, defocus factors, zero-weight slices):
# pf 2 at the path's grid (reco_grid_size 16 at r_u 6), pf 1, quarter
# turns (the DC and every sample on whole cells), a grid whose faces the
# taps pass (r_u 6 at pf 2 reaches indices -1 and 19 of an 18-cell grid), and the
# CTF rounds' defocus factor with slices of weight zero
HK3_CASES = [("pf 2", 6, 2, 32, "random", False, False),
             ("pf 1", 6, 1, 16, "random", False, False),
             ("quarter turns, DC on a cell", 6, 2, 32, "quarter", False, False),
             ("taps past the faces", 6, 2, 18, "random", False, False),
             ("pf 1, taps past the faces", 7, 1, 12, "random", False, False),
             ("defocus factor, weight zero", 5, 2, 28, "random", True, True)]


@pytest.mark.parametrize("label,r_u,pf,big,kind,use_d,zero_w", HK3_CASES,
                         ids=[c[0] for c in HK3_CASES])
def test_hk3_gather_matches_scatter(label, r_u, pf, big, kind, use_d, zero_w):
    rng = np.random.default_rng(len(label))
    n_img, n_s = 3, 9
    ft, ctf = images(rng, n_img)
    img = torch.as_tensor(rng.integers(0, n_img, n_s))
    rot = rotations(rng, n_s, kind)
    trans = torch.as_tensor(rng.uniform(-2, 2, (n_s, 2)).astype(np.float32))
    w = torch.as_tensor(rng.random(n_s).astype(np.float32))
    if zero_w:
        w[::3] = 0
    d = torch.as_tensor(rng.uniform(0.95, 1.05, n_s).astype(np.float32)) if use_d else None
    args = (ft, ctf, img, rot, trans, w, r_u, pf, SIZE, PIX)
    f0 = torch.as_tensor((rng.standard_normal((big,) * 3) * 0.1).astype(np.complex64))
    t0 = torch.as_tensor(rng.random((big,) * 3).astype(np.float32) * 0.1)
    fg, tg = ti.insert_trilinear_gather_plain(*args, f0.clone(), t0.clone(), d)
    fs, ts = ti.insert_trilinear_plain(*args, f0.clone(), t0.clone(), d)
    close(fg, fs)
    close(tg, ts)
    vals, c2w, vc, vr = ti.dense_slice_values(ft, ctf, img, trans, w, r_u, SIZE, PIX, d)
    jf, jt = ji.insert_slices_3d(jnp.asarray(f0.numpy()), jnp.asarray(t0.numpy()),
                                 vals.numpy(), c2w.numpy(), rot.numpy(), vc.numpy(),
                                 vr.numpy(), pf, float((r_u - 1) * pf))
    close(fg, jf)
    close(tg, jt)
    assert ("past the faces" in label) == taps_pass_faces(rot, r_u, pf, big)


# (label, group, r_u, pf, big, slab planes [z0, z0 + bz), classes)
SLAB_CASES = [("C1, slab through the centre", "C1", 6, 2, 32, (10, 13), 1),
              ("C4, a slab splitting samples' z planes", "C4", 6, 2, 32, (15, 17), 2),
              ("C4, every plane in two slabs", "C4", 5, 2, 28, (0, 14), 2),
              ("D2, slab at the face the samples pass", "D2", 6, 2, 18, (0, 7), 1),
              ("C4, pf 1", "C4", 6, 1, 16, (5, 11), 2)]


@pytest.mark.parametrize("label,sym,r_u,pf,big,slab,n_cls", SLAB_CASES,
                         ids=[c[0] for c in SLAB_CASES])
def test_hk11_slab_gather_matches_scatter(label, sym, r_u, pf, big, slab, n_cls):
    """HK11's slab form: its fixed-point sums against its plain version
    (the same sweep weights summed in float32, TOL); C1's slab against
    the one-grid sweep HK11's plain version forms from the images,
    within 1e-5 of max |F| and max |T| (the dense passes sum in another
    order again)."""
    rng = np.random.default_rng(len(label) + 100)
    n_img, n_s = 4, 10
    ft, ctf = images(rng, n_img)
    img = torch.as_tensor(rng.integers(0, n_img, n_s))
    rot = rotations(rng, n_s, "random")
    trans = torch.as_tensor(rng.uniform(-2, 2, (n_s, 2)).astype(np.float32))
    w = torch.as_tensor(rng.random(n_s).astype(np.float32))
    cls = torch.as_tensor(rng.integers(0, n_cls, n_s)).to(torch.int32)
    vals, c2w, _, _ = ti.dense_slice_values(ft, ctf, img, trans, w, r_u, SIZE, PIX)
    mats = Symmetry(sym).matrices
    z0, z1 = slab
    bz = z1 - z0
    f0, t0 = zeros3(big, n_cls, bz)
    fg, tg = ti.insert_sweep_slab_fixed_plain(vals, c2w, rot, cls, r_u, pf, mats,
                                              f0.clone(), t0.clone(), z0)
    fs, ts = ti.insert_sweep_slab_plain(vals, c2w, rot, cls, r_u, pf, mats,
                                        f0.clone(), t0.clone(), z0)
    close(fg, fs)
    close(tg, ts)
    assert ("face" in label) == taps_pass_faces((mats[:, None] @ rot[None]).reshape(-1, 3, 3), r_u,
                                                    pf, big)
    if sym == "C1":   # one class, the identity alone: HK11's whole grid, cut
        f1, t1 = ti.insert_sweep_plain(ft, ctf, img, rot, trans, w, r_u, pf, SIZE, PIX,
                                       *zeros3(big))
        close(fg[0], f1[z0:z1], 1e-5)
        close(tg[0], t1[z0:z1], 1e-5)


# (label, r_u, pf, big, classes)
HK6_CASES = [("pf 2, three classes", 6, 2, 32, 3),
             ("pf 1", 7, 1, 16, 2),
             ("taps past the faces", 6, 2, 18, 2)]


@pytest.mark.parametrize("label,r_u,pf,big,n_cls", HK6_CASES, ids=[c[0] for c in HK6_CASES])
def test_hk6_gather_matches_scatter(label, r_u, pf, big, n_cls):
    rng = np.random.default_rng(len(label) + 200)
    n_img, per = 5, 4
    ft, ctf = images(rng, n_img)
    img = torch.as_tensor(np.repeat(rng.permutation(n_img), per))
    cls_img = torch.as_tensor(rng.integers(0, n_cls, n_img))
    cls = cls_img[img]
    n_s = img.numel()
    phi = torch.as_tensor(rng.uniform(0, 2 * np.pi, n_s).astype(np.float32))
    rot = rotate2d_from_unit(torch.stack([torch.cos(phi), torch.sin(phi)], -1))
    trans = torch.as_tensor(rng.uniform(-2, 2, (n_s, 2)).astype(np.float32))
    w = torch.as_tensor(rng.random(n_s).astype(np.float32))
    args = (ft, ctf, img, cls, rot, trans, w, r_u, pf, SIZE, PIX)
    f0 = torch.zeros((n_cls, big, big), dtype=torch.complex64)
    t0 = torch.zeros((n_cls, big, big))
    assert ("past the faces" in label) == taps_pass_faces(rot, r_u, pf, big)
    fg, tg = ti.insert_bilinear_2d_gather_plain(*args, f0.clone(), t0.clone())
    fs, ts = ti.insert_bilinear_2d_plain(*args, f0.clone(), t0.clone())
    close(fg, fs)
    close(tg, ts)
    vals, c2w, vc, vr = ti.dense_slice_values(ft, ctf, img, trans, w, r_u, SIZE, PIX)
    for k in range(n_cls):
        sel = (cls == k).numpy()
        jf, jt = ji.insert_slices_2d(jnp.zeros((big, big), jnp.complex64),
                                     jnp.zeros((big, big), jnp.float32), vals.numpy()[sel],
                                     c2w.numpy()[sel], rot.numpy()[sel], vc.numpy(), vr.numpy(),
                                     pf, float((r_u - 1) * pf))
        close(fg[k], jf, TOL * float(fg.abs().max() / max(float(np.abs(jf).max()), 1e-30)))
        close(tg[k], jt, TOL * float(tg.abs().max() / max(float(np.abs(jt).max()), 1e-30)))
