"""Each hand-written Hopper kernel against its plain PyTorch version on
the card.  These tests need a CUDA device and nvcc; without them they
skip (the plain versions are held to thunder_tpu by the other
test_torch_*.py files).  This file imports no jax, so on a GPU host
without jax run it past the repo's jax-importing conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from thunder_tpu_torch.device import generator
from thunder_tpu_torch.geometry.quaternion import (random_quat, rotate2d_from_unit,
                                                   rotate3d)
from thunder_tpu_torch.ops import gather, insert, likelihood, projector
from thunder_tpu_torch.ops.fourier import pack_rings
from thunder_tpu_torch.physics import spectrum
from thunder_tpu_torch.physics.ctf import ctf_params

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from thunder_tpu_torch import _native

    try:
        _native.library()
    except RuntimeError as e:
        pytest.skip(f"kernels cannot be built here: {e}")
    return torch.device("cuda:0")


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("quad", [False, True])
def test_project_slices(dev, quad):
    """Per-image classes and the single-class path, from the plain cube
    and from the quad table; 1e-5: the same coordinates and tap order,
    the sums may contract into FMAs."""
    g = generator(0, dev)
    tab = torch.randn(2, 40, 40, 40, dtype=torch.complex64, device=dev)
    table = projector.quad_taps(tab) if quad else tab
    rot = rotate3d(random_quat(g, (6, 11), dev))
    rings = pack_rings(32, 12, 1, device=dev)
    cls = torch.tensor([0, 1, 1, 0, 1, 0], device=dev)
    for c in (cls, None):
        got = projector.project_slices(table, rot, rings.i_col, rings.i_row, 2, c)
        ref = projector.project_slices_plain(tab, rot, rings.i_col, rings.i_row, 2, c)
        assert rel_err(got, ref) < 1e-5


@pytest.mark.parametrize("quad", [False, True])
def test_project_slices_clipped_taps(dev, quad):
    """A full-box table with coordinates at and past its faces (pf 3 on
    a band of 12 reaches 36 cells from the centre of a 40-cell cube):
    every tap index clips as the plain version clips it."""
    g = generator(5, dev)
    tab = torch.randn(2, 40, 40, 40, dtype=torch.complex64, device=dev)
    table = projector.quad_taps(tab) if quad else tab
    rot = rotate3d(random_quat(g, (4, 32), dev))
    rings = pack_rings(32, 12, 1, device=dev)
    cls = torch.tensor([1, 0, 0, 1], device=dev)
    args = (rot, rings.i_col, rings.i_row, 3, cls)
    x = (rot[..., :2] @ torch.stack([rings.i_col, rings.i_row]).float() * 3).abs()
    assert float(x.max()) > 21
    assert rel_err(projector.project_slices(table, *args),
                   projector.project_slices_plain(tab, *args)) < 1e-5


@pytest.mark.parametrize("quad", [False, True])
def test_project_slices_global_shape(dev, quad):
    """The global search's launch: one block of 256 rotations shared by
    all images (image stride 0), one class, P = 728 (r = 22 at 128 px)."""
    g = generator(6, dev)
    tab = torch.randn(1, 92, 92, 92, dtype=torch.complex64, device=dev)
    table = projector.quad_taps(tab) if quad else tab
    rings = pack_rings(128, 22, 1, device=dev)
    assert rings.i_col.numel() == 728
    rot = rotate3d(random_quat(g, (1, 256), dev))
    for r in (rot, rot.expand(3, 256, 3, 3)):
        cls = None if r.shape[0] == 1 else torch.zeros(3, dtype=torch.int64, device=dev)
        args = (r, rings.i_col, rings.i_row, 2, cls)
        assert rel_err(projector.project_slices(table, *args),
                       projector.project_slices_plain(tab, *args)) < 1e-5


def _lk_operands(dev, n, k, r, tt, per_image, seed, size=32, band=6):
    """HK2 inputs: n noisy images (sigRcp -1/2, CTF in [0.3, 1)) on the
    rings to ``band`` of a ``size`` px box; pri (k, n, r, P) per image or
    one block per class shared by all images; tra (n, tt, P) per image
    or shared."""
    g = generator(seed, dev)
    rings = pack_rings(size, band, 1, device=dev)
    p = rings.i_col.numel()
    cplx = lambda *sh: torch.complex(torch.randn(sh, generator=g, device=dev),
                                     torch.randn(sh, generator=g, device=dev))
    s = -0.5 * rings.mask
    dat = cplx(n, p)
    ctf = 0.3 + 0.7 * torch.rand(n, p, generator=g, device=dev)
    ops = [(s * ctf) * dat, s * ctf * ctf, (s * dat.abs() ** 2).sum(-1)]
    if per_image:
        pri = 0.5 * cplx(k, n, r, p)
        ph = 0.3 * torch.randn(n, tt, p, generator=g, device=dev)
    else:
        pri = (0.5 * cplx(k, 1, r, p)).expand(k, n, r, p)
        ph = (0.3 * torch.randn(tt, p, generator=g, device=dev))[None].expand(n, tt, p)
    tra = torch.polar(torch.ones_like(ph), ph)
    return ops + [pri, tra, torch.rand(n, r, generator=g, device=dev),
                  torch.rand(n, tt, generator=g, device=dev)]


def _lk_both(ops, blocks):
    """HK2 and its plain version over ``blocks`` consecutive rotation
    blocks of pri (split along R) into fresh accumulators."""
    pri, w_r = ops[3], ops[5]
    k, n, r = pri.shape[:3]
    step = r // blocks
    outs = []
    for fn in (likelihood.likelihood_block, likelihood.likelihood_block_plain):
        dev = pri.device
        acc = (torch.full((k, n), float("-inf"), device=dev), torch.zeros(k, n, device=dev),
               torch.zeros(k, n, r, device=dev), torch.zeros(k, n, ops[4].shape[1], device=dev))
        for b in range(blocks):
            sl = slice(b * step, (b + 1) * step)
            fn(*ops[:3], pri[:, :, sl], ops[4], w_r[:, sl], ops[6], *acc, col0=b * step)
        outs.append(acc)
    return outs


@pytest.mark.parametrize("per_image", [False, True])
def test_likelihood_block(dev, per_image):
    """Two consecutive rotation blocks of two classes, shared (global
    search) or per-image (phase loop) supports.  Held to 1e-4 relative:
    the 2P-long dot products are summed in another order than cuBLAS's
    and exp amplifies it."""
    ops = _lk_operands(dev, 5, 2, 80, 7, per_image, 5)
    for x, y in zip(*_lk_both(ops, 2)):
        assert rel_err(x, y) < 1e-4


@pytest.mark.parametrize("given_grids", [False, True])
def test_insert_trilinear(dev, given_grids):
    """Slices of images in no order, some of weight zero, the window's
    corner pixels beyond the padded-radius cut; into fresh grids or
    accumulated into given ones."""
    rng = np.random.default_rng(0)
    size, n_img, n_s, r_u, pf = 32, 4, 30, 12, 2
    big = 2 * (r_u + 2) * pf
    ft = torch.randn(n_img, size, size, dtype=torch.complex64, device=dev)
    d = rng.uniform(1000, 3000, n_img)
    ctf = ctf_params(np.full(n_img, 300e3), d, d, np.zeros(n_img), np.full(n_img, 2e7),
                     np.full(n_img, 0.1), np.zeros(n_img), device=dev)
    g = generator(1, dev)
    img_idx = torch.randint(0, n_img, (n_s,), device=dev)
    assert bool((img_idx[1:] < img_idx[:-1]).any())
    w = torch.rand(n_s, device=dev)
    w[::7] = 0.0
    args = (ft, ctf, img_idx, rotate3d(random_quat(g, (n_s,), dev)),
            torch.randn(n_s, 2, device=dev), w, r_u, pf, size, 1.32)
    mask = insert.dense_window(r_u)[2]
    assert int((mask == 0).sum()) > 0
    if given_grids:
        f0 = torch.randn((big,) * 3, dtype=torch.complex64, device=dev)
        t0 = torch.rand((big,) * 3, device=dev)
    else:
        f0 = torch.zeros((big,) * 3, dtype=torch.complex64, device=dev)
        t0 = torch.zeros((big,) * 3, device=dev)
    fp, tp = insert.insert_trilinear_plain(*args, f0.clone(), t0.clone())
    fk, tk = (insert.insert_trilinear(*args, big, f0.clone(), t0.clone()) if given_grids
              else insert.insert_trilinear(*args, big))
    # each cell sums its slices in another order than the twin's scatter
    assert rel_err(torch.view_as_real(fk), torch.view_as_real(fp)) < 1e-5
    assert rel_err(tk, tp) < 1e-5


@pytest.mark.parametrize("case", ["fsc 3D", "frc 2D", "sigma 3D", "sigma 2D", "one field",
                                  "overflow dropped", "pieces", "five fields"])
def test_shell_sums(dev, case):
    """HK4 at small sizes of its four main-path shapes and at its edges;
    1e-5: float32 sums added in another order than the plain version's."""
    g = generator(7, dev)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev)
    if case in ("fsc 3D", "frc 2D", "overflow dropped"):
        size, nd, b = (24, 3, 1) if case != "frc 2D" else (40, 2, 5)
        n_sh = 4 if case == "overflow dropped" else size // 2 - 2
        u, half = spectrum.shell_geometry(size, nd, dev)
        assert int(u.max()) > n_sh
        v = rnd(b, 3, size ** nd)
        for w in (half, None):
            ref = spectrum.shell_sums_plain(v, u, n_sh, w)
            assert rel_err(spectrum.shell_sums(v, u, n_sh, w), ref) < 1e-5
            assert rel_err(spectrum.shell_sums_grid(v, size, nd, n_sh, w is not None), ref) < 1e-5
        a = torch.complex(rnd(b, size ** nd), rnd(b, size ** nd))
        c = a + 0.5 * torch.complex(rnd(b, size ** nd), rnd(b, size ** nd))
        assert rel_err(spectrum.fsc_sums(a, c, size, nd, n_sh),
                       spectrum.fsc_sums_plain(a, c, size, nd, n_sh)) < 1e-5
        return
    rings = pack_rings(64, 20, 0, lane=512, device=dev)
    n = rings.i_col.numel()
    b, c = {"sigma 3D": (64, 3), "sigma 2D": (5000, 3), "one field": (5000, 1),
            "pieces": (1, 1), "five fields": (7, 5)}[case]
    assert (spectrum.shell_sums_plan(b, n) == 1) == (b == 5000)
    v = rnd(b, c, n) * rings.mask
    sh = torch.clamp(rings.i_sig, max=20)
    for w in (None, rings.mask):
        assert rel_err(spectrum.shell_sums(v, sh, 21, w),
                       spectrum.shell_sums_plain(v, sh, 21, w)) < 1e-5


@pytest.mark.parametrize("size,nd", [(128, 3), (160, 2), (33, 3), (45, 2)])
def test_shell_sums_grid_geometry_is_exact(dev, size, nd):
    """The coordinate form's shell index and half-space choice are
    shell_geometry's, cell for cell: with a field that is 1 in one cell
    and a second that numbers the shells, the sums are exact integers."""
    u, half = spectrum.shell_geometry(size, nd, dev)
    n_sh = int(u.max()) + 1
    ones = torch.ones(1, 1, size ** nd, device=dev)
    cnt = spectrum.shell_sums_grid(ones, size, nd, n_sh)
    assert torch.equal(cnt, spectrum.shell_sums_plain(ones, u, n_sh, half))
    assert torch.equal(spectrum.shell_sums_grid(ones, size, nd, n_sh, False),
                       spectrum.shell_sums_plain(ones, u, n_sh))
    # a cell in the wrong shell would move its index into another bin
    idx = u.to(torch.float32)[None, None]
    got = spectrum.shell_sums_grid(idx, size, nd, n_sh)
    assert torch.equal(got, cnt * torch.arange(n_sh, device=dev))


def _rot2d(g, shape, dev):
    phi = torch.rand(shape, generator=g, device=dev) * 6.2831853
    return rotate2d_from_unit(torch.stack([torch.cos(phi), torch.sin(phi)], -1))


def test_project_slices_2d(dev):
    """Per-image rotations and classes, cls=None, one rotation block
    shared by all classes (stride 0, as in global search), an odd pixel
    count, and launches large enough for two pixels a thread, with the
    rotations walked or split between threads."""
    g = generator(2, dev)
    table = tab = torch.randn(3, 36, 36, dtype=torch.complex64, device=dev)
    rings = pack_rings(32, 12, 1, device=dev)
    assert rings.i_col.numel() % 2 == 0
    cls = torch.tensor([0, 2, 1, 2, 0, 1], device=dev)
    rot = _rot2d(g, (6, 11), dev)
    for c in (cls, None):
        args = (rot, rings.i_col, rings.i_row, 2, c)
        assert rel_err(projector.project_slices_2d(table, *args),
                       projector.project_slices_2d_plain(tab, *args)) < 1e-5
    odd = (rot, rings.i_col[:31], rings.i_row[:31], 2, cls)
    assert rel_err(projector.project_slices_2d(table, *odd),
                   projector.project_slices_2d_plain(tab, *odd)) < 1e-5
    shared = _rot2d(g, (1, 100), dev).expand(3, 100, 2, 2)
    args = (shared, rings.i_col, rings.i_row, 2, torch.arange(3, device=dev))
    assert rel_err(projector.project_slices_2d(table, *args),
                   projector.project_slices_2d_plain(tab, *args)) < 1e-5
    n_p = rings.i_col.numel()
    for n_l, n_r in ((2 ** 23 // (9 * n_p) + 1, 9), (40, 2 ** 23 // (40 * n_p) + 1)):
        many = _rot2d(g, (n_l, n_r), dev)
        args = (many, rings.i_col, rings.i_row, 2, torch.randint(0, 3, (n_l,), device=dev))
        assert n_l * n_r * n_p >= 2 ** 23    # csrc/project_slices_2d.cu: PAIR_FROM
        assert rel_err(projector.project_slices_2d(table, *args),
                       projector.project_slices_2d_plain(tab, *args)) < 1e-5


@pytest.mark.parametrize("n_rot", [32, 12000])
def test_project_slices_2d_clipped_taps(dev, n_rot):
    """Coordinates at and past the plane's edges (pf 3 on a band of 12
    reaches 36 cells from the centre of a 40-cell plane): every tap index
    clips as the plain version clips it, one pixel a thread and two."""
    g = generator(8, dev)
    table = tab = torch.randn(2, 40, 40, dtype=torch.complex64, device=dev)
    rings = pack_rings(32, 12, 1, device=dev)
    rot = _rot2d(g, (4, n_rot), dev)
    args = (rot, rings.i_col, rings.i_row, 3, torch.tensor([1, 0, 0, 1], device=dev))
    x = (rot @ torch.stack([rings.i_col, rings.i_row]).float() * 3).abs()
    assert float(x.max()) > 21
    assert (4 * n_rot * rings.i_col.numel() >= 2 ** 23) == (n_rot > 32)
    assert rel_err(projector.project_slices_2d(table, *args),
                   projector.project_slices_2d_plain(tab, *args)) < 1e-5


@pytest.mark.parametrize("r_u", [12, 40])
def test_insert_bilinear_2d(dev, r_u):
    """Several classes, at the 2D path's band r_u 12 and at r_u 40."""
    rng = np.random.default_rng(1)
    size, n_img, n_s, pf, k = 2 * r_u + 8, 6, 300, 2, 4
    big = 2 * (r_u + 2) * pf
    ft = torch.randn(n_img, size, size, dtype=torch.complex64, device=dev)
    d = rng.uniform(8000, 20000, n_img)
    ctf = ctf_params(np.full(n_img, 300e3), d, d, np.zeros(n_img), np.full(n_img, 2e7),
                     np.full(n_img, 0.1), np.zeros(n_img), device=dev)
    g = generator(3, dev)
    args = (ft, ctf, torch.randint(0, n_img, (n_s,), device=dev),
            torch.randint(0, k, (n_s,), device=dev), _rot2d(g, (n_s,), dev),
            torch.randn(n_s, 2, device=dev), torch.rand(n_s, device=dev), r_u, pf, size, 1.32)
    fk, tk = insert.insert_bilinear_2d(*args, big, k)
    zero = lambda dt: torch.zeros((k, big, big), dtype=dt, device=dev)
    fp, tp = insert.insert_bilinear_2d_plain(*args, zero(torch.complex64),
                                             zero(torch.float32))
    # ~75 slices a class summed in float32 in the gather's order against
    # the twin's index_add order; random-signed values cancel, so the
    # error is taken against max |F|
    assert rel_err(torch.view_as_real(fk), torch.view_as_real(fp)) < 1e-4
    assert rel_err(tk, tp) < 1e-4


def test_likelihood_block_2d_shapes(dev):
    """The 2D global search's block: R = 100 rotations x T = 151
    translations of three classes in one launch (8 x 8 tiles, shared
    memory past the 48 KB default); 1e-4 as above."""
    ops = _lk_operands(dev, 64, 3, 100, 151, False, 6)
    for x, y in zip(*_lk_both(ops, 1)):
        assert rel_err(x, y) < 1e-4


@pytest.mark.parametrize("per_image", [False, True])
def test_likelihood_block_rotation_sub_blocks(dev, per_image):
    """A 3D global-search block of 256 rotations x 151 translations
    (configs/demo_3D.json's T) at P = 728 (r = 22 at 128 px), which the
    CTA takes in three rotation sub-blocks; two classes; 1e-4 as above."""
    assert likelihood.likelihood_plan(256, 151)["n_sub"] == 3
    ops = _lk_operands(dev, 16, 2, 256, 151, per_image, 7, size=128, band=22)
    assert ops[0].shape[1] == 728
    for x, y in zip(*_lk_both(ops, 1)):
        assert rel_err(x, y) < 1e-4


def test_gathers(dev):
    """G1-G5 against their plain versions, exactly."""
    gen = generator(4, dev)
    ri = lambda hi, shape: torch.randint(0, hi, shape, generator=gen, device=dev,
                                         dtype=torch.int32)
    tab = torch.randn(512, 128, device=dev)
    src = torch.randn(1024, 128, device=dev)
    ridx, lidx = ri(600, (1024, 128)) - 40, ri(140, (1024, 128)) - 6
    flat = torch.randn(70000, device=dev)
    rows = ri(520, (3000,)) - 4
    cases = [(gather.take_flat, gather.take_flat_plain, (flat, ri(70100, (5000,)) - 50)),
             (gather.take_along_rows, gather.take_along_rows_plain, (tab, ridx)),
             (gather.take_along_lanes, gather.take_along_lanes_plain, (src, lidx)),
             (gather.take_along_both, gather.take_along_both_plain, (tab, ridx, lidx)),
             (gather.take_rows, gather.take_rows_plain, (tab, rows))]
    for fn, plain, args in cases:
        assert torch.equal(fn(*args), plain(*args)), fn.__name__


def _ctf_fields(dev, n, seed):
    rng = np.random.default_rng(seed)
    defocus = rng.uniform(8000, 20000, n)
    return ctf_params(np.full(n, 300e3), defocus, defocus * rng.uniform(0.9, 1.1, n),
                      rng.uniform(0, 3, n), np.full(n, 2e7), np.full(n, 0.1), np.zeros(n),
                      device=dev)


@pytest.mark.parametrize("sym,big", [("C4", 40), ("D2", 40), ("C4", 37), ("I1", 24),
                                     ("O", 26), ("D2", 33), ("C3", 31), ("O", 21)])
def test_symmetrize_ft(dev, sym, big):
    """HK7 against its plain version on 2K = 4 grids (F and T in one
    launch), in the form the group takes (flat orbit bricks for C4 and
    D2, cubic ones for O, the staged box for C3 and I1), even and odd
    boxes, the cut inside and
    past the box's faces (clipped taps); 1e-5: the same coordinates,
    weights and tap order, the sums may contract into FMAs.  Two calls
    give identical bits."""
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.recon import reconstructor

    g = generator(11, dev)
    shape = (2, 2, big, big, big)
    f = torch.complex(torch.randn(shape, generator=g, device=dev),
                      torch.randn(shape, generator=g, device=dev))
    t = torch.rand(shape, generator=g, device=dev)
    mats = Symmetry(sym, dev).matrices
    form = reconstructor.symmetrize_form(mats)
    assert form == {"C3": "box", "I1": "box", "O": "orbit-cube"}.get(sym, "orbit")
    for radius in (big // 2 - 3.0, big * 0.9):
        n0 = reconstructor.symmetrize_ft.launches
        got = reconstructor.symmetrize_ft(f, t, mats, radius, form)
        assert reconstructor.symmetrize_ft.launches == n0 + 1
        ref = reconstructor.symmetrize_ft_plain(f, t, mats, radius)
        assert rel_err(torch.view_as_real(got[0]), torch.view_as_real(ref[0])) < 1e-5
        assert rel_err(got[1], ref[1]) < 1e-5
        again = reconstructor.symmetrize_ft(f, t, mats, radius, form)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    with pytest.raises(ValueError):
        reconstructor.symmetrize_ft(f, t.double(), mats, 5.0)


@pytest.mark.parametrize("n_d,n_r,n_t,band", [(9, 125, 9, 12), (4, 7, 5, 6), (1, 64, 9, 6),
                                              (10, 33, 13, 9), (13, 7, 13, 7),
                                              (9, 200, 2, 5), (2, 129, 1, 10)])
def test_likelihood_local_ctf(dev, n_d, n_r, n_t, band):
    """HK8 against its plain version (ctf_packed_scaled, the einsums of
    log_dvp_local_ctf, max / exp / marginals) at the path's tile counts
    and at ragged ones (D of 1, 2, 13, R of 7 and past one warp of
    rotation tiles, T of 1 and 13; P = 210, 48, 112, 68, 34, 146, no
    multiple of the 32-pixel chunk or, in the last chunk, of the pixel
    groups); 1e-4:
    P-long sums in another order and CTFs formed in the kernel,
    amplified by exp.  One launch a call; two calls give identical
    bits."""
    g = generator(12, dev)
    size, n_l = 64, 6
    rings = pack_rings(size, band, 1, lane=1, device=dev)
    p = rings.i_col.numel()
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev)
    cplx = lambda *sh: torch.complex(rnd(*sh), rnd(*sh))
    s_pack = -0.5 * rings.mask * (0.5 + torch.rand(n_l, p, generator=g, device=dev))
    dat = cplx(n_l, p)
    ph = 0.3 * rnd(n_l, n_t, p)
    terms = likelihood.ctf_terms(_ctf_fields(dev, n_l, 3), rings.i_col, rings.i_row, size, 1.32)
    args = ((s_pack * dat).to(torch.complex64), s_pack, terms, 1 + 0.02 * rnd(n_l, n_d),
            0.3 * cplx(n_l, n_r, p), torch.polar(torch.ones_like(ph), ph),
            (s_pack * dat.abs() ** 2).sum(-1),
            torch.rand(n_l, n_r, generator=g, device=dev),
            torch.rand(n_l, n_t, generator=g, device=dev),
            torch.rand(n_l, n_d, generator=g, device=dev))
    n0 = likelihood.likelihood_local_ctf.launches
    got = likelihood.likelihood_local_ctf(*args)
    assert likelihood.likelihood_local_ctf.launches == n0 + 1
    ref = likelihood.likelihood_local_ctf_plain(*args)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and rel_err(a, b) < 1e-4
    again = likelihood.likelihood_local_ctf(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_insert_trilinear_defocus_factor(dev):
    """HK3 with a defocus factor a slice against its plain version, and
    with factors of 1 against the call without them."""
    g = generator(13, dev)
    n_l, size, r_u, big = 5, 32, 9, 44
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_l, size, size, generator=g, device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    ctf = _ctf_fields(dev, n_l, 4)
    n_s = 40
    img = torch.randint(0, n_l, (n_s,), generator=g, device=dev)
    some = (ft, ctf, img, rotate3d(random_quat(g, (n_s,), dev)),
            2 * torch.randn(n_s, 2, generator=g, device=dev),
            torch.rand(n_s, generator=g, device=dev), r_u, 2, size, 1.32)
    d = 1 + 0.1 * torch.randn(n_s, generator=g, device=dev)
    zeros = lambda: (torch.zeros((big,) * 3, dtype=torch.complex64, device=dev),
                     torch.zeros((big,) * 3, device=dev))
    fk, tk = insert.insert_trilinear(*some, big, d=d)
    fp, tp = insert.insert_trilinear_plain(*some, *zeros(), d)
    assert rel_err(torch.view_as_real(fk), torch.view_as_real(fp)) < 1e-4
    assert rel_err(tk, tp) < 1e-4
    f1, t1 = insert.insert_trilinear(*some, big, d=torch.ones_like(d))
    f0, t0 = insert.insert_trilinear(*some, big)
    assert rel_err(torch.view_as_real(f1), torch.view_as_real(f0)) < 1e-4
    assert rel_err(torch.view_as_real(f0), torch.view_as_real(fp)) > 1e-3


def test_post_refinement_paths(dev):
    """The post-refinement paths' kernel calls against the same calls on
    the CPU: signal subtraction (HK1 over every pixel of the box from the
    whole padded cube, taps clipped at its faces at the image corners,
    zeroed past the radius) and the B-factor fit (HK4's coordinate form
    over every cell) of a spectrum with a Gaussian fall-off, B ~ -40 (on
    white noise the fitted slope is ~0, and the float32 reductions of the
    fit alone move it by 1e-3 of itself); 1e-4: float32 sums in another
    order."""
    from thunder_tpu_torch.optimiser import subtract_batch, subtract_table

    g = generator(17, dev)
    size, n_b = 40, 12
    refs = torch.randn(2, size, size, size, generator=g, device=dev)
    ft = torch.complex(torch.randn(n_b, size, size, generator=g, device=dev),
                       torch.randn(n_b, size, size, generator=g, device=dev))
    args = (_ctf_fields(dev, n_b, 5), torch.randint(0, 2, (n_b,), generator=g, device=dev),
            random_quat(g, (n_b,), dev), 2 * torch.randn(n_b, 2, generator=g, device=dev))
    cpu = lambda t: t.cpu() if torch.is_tensor(t) else t.map(lambda f: f.cpu())
    got = subtract_batch(ft, args[0], subtract_table(refs, 2, 3), *args[1:], size, 2, 1.32)
    ref = subtract_batch(ft.cpu(), cpu(args[0]), subtract_table(refs.cpu(), 2, 3),
                         *map(cpu, args[1:]), size, 2, 1.32)
    assert rel_err(got.cpu(), ref) < 1e-4
    k = (torch.arange(size, device=dev) - size // 2).float() / size
    r2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + k[None, None, :] ** 2
    spec = torch.fft.fftshift(torch.fft.fftn(refs[0])) * torch.exp(-20.0 * r2)
    b_dev, b_cpu = (spectrum.b_factor_est(s, 17, 4) for s in (spec, spec.cpu()))
    assert b_cpu < -30
    assert abs(b_dev - b_cpu) <= 1e-4 * abs(b_cpu)


@pytest.mark.parametrize("sym,slabs", [("C4", 2), ("C1", 4), ("D2", 3)])
def test_insert_trilinear_slab(dev, sym, slabs):
    """HK9 against its plain twin slab by slab (zero-weight slices, two
    classes, the mates' radius cut); the slabs together against HK3 then
    HK7 for the signed-permutation groups; 1e-5: sums in another order."""
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.recon.reconstructor import symmetrize_ft

    g = generator(19, dev)
    n_l, size, r_u, pf, n_s = 6, 32, 9, 2, 24
    big = 2 * (r_u + 2) * pf + (slabs - 2 * (r_u + 2) * pf % slabs) % slabs
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_l, size, size, generator=g, device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    ctf = _ctf_fields(dev, n_l, 5)
    img = torch.randint(0, n_l, (n_s,), generator=g, device=dev)
    rot = rotate3d(random_quat(g, (n_s,), dev))
    trans = torch.randn(n_s, 2, generator=g, device=dev)
    w = torch.rand(n_s, generator=g, device=dev)
    w[::5] = 0.0
    vals, c2w, _, _ = insert.dense_slice_values(ft, ctf, img, trans, w, r_u, size, 1.32)
    cls = torch.randint(0, 2, (n_s,), generator=g, device=dev)
    mats = Symmetry(sym, dev).matrices
    bz = big // slabs
    fk, tk = [], []
    for j in range(slabs):
        f, t = insert.insert_trilinear_slab(vals, c2w, rot, cls, r_u, pf, mats, 2, big,
                                            j * bz, bz)
        zeros = (torch.zeros_like(f), torch.zeros_like(t))
        fp, tp = insert.insert_trilinear_slab_plain(vals, c2w, rot, cls, r_u, pf, mats,
                                                    *zeros, j * bz)
        assert rel_err(torch.view_as_real(f), torch.view_as_real(fp)) < 1e-5
        assert rel_err(t, tp) < 1e-5
        fk.append(f)
        tk.append(t)
    f9, t9 = torch.cat(fk, dim=1), torch.cat(tk, dim=1)
    if sym == "C1":
        return
    f3 = torch.zeros((2,) + (big,) * 3, dtype=torch.complex64, device=dev)
    t3 = torch.zeros((2,) + (big,) * 3, device=dev)
    for k in range(2):
        sel = torch.nonzero(cls == k)[:, 0]
        insert.insert_trilinear(ft, ctf, img[sel], rot[sel], trans[sel], w[sel], r_u, pf, size,
                                1.32, big, f3[k], t3[k])
    f7, t7 = symmetrize_ft(f3, t3, mats, float((r_u - 1) * pf))
    assert rel_err(torch.view_as_real(f9), torch.view_as_real(f7)) < 1e-5
    assert rel_err(t9, t7) < 1e-5


def _insert_case(dev, kind, big_3d=None):
    """(kernel call, plain call) of HK3, HK6 or HK9 on random slices (HK3
    with a defocus factor a slice, HK9 with C4's mates into a slab);
    ``big_3d`` a grid small enough that taps pass its faces."""
    g = generator(23, dev)
    size, n_img, n_s, r_u, pf = 32, 5, 40, 12, 2
    big = big_3d or 2 * (r_u + 2) * pf
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_img, size, size, generator=g,
                                                       device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    ctf = _ctf_fields(dev, n_img, 5)
    img = torch.randint(0, n_img, (n_s,), generator=g, device=dev)
    trans = torch.randn(n_s, 2, generator=g, device=dev)
    w = torch.rand(n_s, generator=g, device=dev)
    w[::9] = 0.0
    cls = torch.randint(0, 3, (n_s,), generator=g, device=dev)
    zeros = lambda shape: (torch.zeros(shape, dtype=torch.complex64, device=dev),
                           torch.zeros(shape, device=dev))
    if kind == "insert_bilinear_2d":
        args = (ft, ctf, img, cls, _rot2d(g, (n_s,), dev), trans, w, r_u, pf, size, 1.32)
        return (lambda: insert.insert_bilinear_2d(*args, big, 3),
                lambda: insert.insert_bilinear_2d_plain(*args, *zeros((3, big, big))))
    rot = rotate3d(random_quat(g, (n_s,), dev))
    if kind == "insert_trilinear_slab":
        from thunder_tpu_torch.geometry.symmetry import Symmetry

        vals, c2w, _, _ = insert.dense_slice_values(ft, ctf, img, trans, w, r_u, size, 1.32)
        mats = Symmetry("C4", dev).matrices
        z0, bz = 0, big // 2
        return (lambda: insert.insert_trilinear_slab(vals, c2w, rot, cls, r_u, pf, mats, 3, big,
                                                     z0, bz),
                lambda: insert.insert_trilinear_slab_plain(vals, c2w, rot, cls, r_u, pf, mats,
                                                           *zeros((3, bz, big, big)), z0))
    d = 1 + 0.03 * torch.randn(n_s, generator=g, device=dev)
    args = (ft, ctf, img, rot, trans, w, r_u, pf, size, 1.32)
    if kind == "insert_mkb":
        return (lambda: insert.insert_mkb(*args, big, d=d),
                lambda: insert.insert_mkb_plain(*args, *zeros((big,) * 3), d))
    return (lambda: insert.insert_trilinear(*args, big, d=d),
            lambda: insert.insert_trilinear_plain(*args, *zeros((big,) * 3), d))


@pytest.mark.parametrize("kind", ["insert_trilinear", "insert_bilinear_2d",
                                  "insert_trilinear_slab", "insert_mkb"])
def test_insert_gathers_repeat_bitwise(dev, kind):
    """HK3, HK6, HK9 and HK10: each cell sums its slices in a fixed
    order, so two calls give identical bits; each still matches its twin
    (1e-5)."""
    call, plain = _insert_case(dev, kind)
    (f1, t1), (f2, t2) = call(), call()
    assert torch.equal(f1, f2) and torch.equal(t1, t2)
    fp, tp = plain()
    assert rel_err(torch.view_as_real(f1), torch.view_as_real(fp)) < 1e-5
    assert rel_err(t1, tp) < 1e-5


@pytest.mark.parametrize("kind", ["insert_trilinear", "insert_bilinear_2d",
                                  "insert_trilinear_slab", "insert_mkb"])
def test_insert_gathers_taps_past_the_faces(dev, kind):
    """A grid of 40 cells at r_u 12, pf 2: taps reach indices -3 and 43
    (the blob's -4 and 44), which the scatter clips onto the faces and
    the gathers' face cells take from their virtual cells."""
    lo, hi = insert.tap_range(40, 22.0)
    assert lo < 0 and hi > 39
    call, plain = _insert_case(dev, kind, big_3d=40)
    (fk, tk), (fp, tp) = call(), plain()
    assert rel_err(torch.view_as_real(fk), torch.view_as_real(fp)) < 1e-5
    assert rel_err(tk, tp) < 1e-5


@pytest.mark.parametrize("form", ["rows", "rows in pieces", "grid", "grid, every cell", "pair"])
def test_shell_sums_repeat_bitwise(dev, form):
    """HK4 adds its run heads in lane order and its blocks' and pieces'
    partials in their order: two calls give identical bits, at a
    main-path shape of each form."""
    g = generator(29, dev)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev)
    if form.startswith("rows"):
        rings = pack_rings(128, 36, 0, lane=512, device=dev)
        n_b = 256 if form == "rows in pieces" else 5000
        assert (spectrum.shell_sums_plan(n_b, rings.i_col.numel()) > 1) == (n_b == 256)
        v = rnd(n_b, 3, rings.i_col.numel()) ** 2
        sh = torch.clamp(rings.i_sig, max=62)
        call = lambda: spectrum.shell_sums(v, sh, 63, rings.mask)
        ref = spectrum.shell_sums_plain(v, sh, 63, rings.mask)
    elif form == "pair":
        a = torch.complex(rnd(2, 96 ** 3), rnd(2, 96 ** 3))
        b = a + 0.5 * torch.complex(rnd(2, 96 ** 3), rnd(2, 96 ** 3))
        call = lambda: spectrum.fsc_sums(a, b, 96, 3, 46)
        ref = spectrum.fsc_sums_plain(a, b, 96, 3, 46)
    else:
        v = rnd(3, 3, 96 ** 3) ** 2
        half = form == "grid"
        call = lambda: spectrum.shell_sums_grid(v, 96, 3, 46, half)
        ref = spectrum.shell_sums_grid_plain(v, 96, 3, 46, half)
    got = call()
    assert torch.equal(got, call())
    assert rel_err(got, ref) < 1e-5
