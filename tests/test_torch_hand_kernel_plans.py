"""CPU: the launch plans of HK8 (``likelihood_ctf_plan``) and HK7
(``symmetrize_form`` / ``symmetrize_plan``), and HK8's CTF operands
formed once a round (``ctf_terms``).  The plans are plain Python read
from the kernels' sources, so they are checked here; the kernels
themselves run in tests/test_torch_kernels.py on the card."""

import numpy as np
import pytest
import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.geometry.symmetry import Symmetry
from thunder_tpu_torch.ops import likelihood as tlk
from thunder_tpu_torch.ops.fourier import pack_rings
from thunder_tpu_torch.physics.ctf import ctf_constants, ctf_params
from thunder_tpu_torch.recon import reconstructor as trec


def hk8_smem(n_rg, n_tt, n_dt):
    """csrc/likelihood_local_ctf.cu's shared-memory layout, counted in
    floats: constants and d factors, two staging buffers (pri rows of
    2 R4 + 4, tra, dat, s, f2, angle), x, CTF and s ctf^2 rows; after
    the loop the (D, T, R) block, B, row sums and a scratch."""
    pc, r4, t3, d9 = 32, n_rg * 128, n_tt * 3, n_dt * 9
    stage = pc * (2 * r4 + 4) + pc * t3 * 2 + pc * 2 + 3 * pc
    loop = 2 * stage + pc * t3 * 2 + 2 * pc * n_dt * 12
    epilogue = d9 * t3 * r4 + d9 * r4 + d9 * t3 + 32
    head = -(-(8 + d9) // 4) * 4
    return 4 * (head + max(loop, epilogue))


@pytest.mark.parametrize("n_d,n_r,n_t,want", [
    (9, 125, 9, (1, 3, 1, 4)),      # the path's block: 12 warps, 4 pixel groups
    (1, 125, 9, (1, 3, 1, 4)),      # D = 1: one d tile, 8 of 9 factors padded
    (13, 125, 9, (1, 3, 2, 2)),     # D = 13: two d tiles
    (9, 7, 9, (1, 3, 1, 4)),        # R = 7: two rotation tiles of a warp's 32
    (9, 125, 13, (1, 5, 1, 2)),     # T = 13: five translation tiles
    (9, 129, 2, (2, 3, 1, 2)),      # R past one warp of rotation tiles; T = 2 -> 3 tiles
    (1, 1, 1, (1, 3, 1, 4)),
])
def test_likelihood_ctf_plan_shapes(n_d, n_r, n_t, want):
    """HK8's plan: 4 x 3 x 9 register tiles cover the block (at least
    three translation tiles, so that every factor's B has one to sum
    it), warps times pixel groups fill at most 384 threads, and the
    shared memory is the kernel's layout."""
    plan = tlk.likelihood_ctf_plan(n_d, n_r, n_t)
    assert (plan["n_rg"], plan["n_tt"], plan["n_dt"], plan["groups"]) == want
    n_rg, n_tt, n_dt, groups = want
    assert n_rg * 128 >= n_r and n_tt * 3 >= n_t and n_tt >= 3 and n_dt * 9 >= n_d
    warps = n_rg * n_tt * n_dt
    assert plan["threads"] == 32 * warps * groups <= tlk.LC_THREADS < 32 * warps * (groups + 1)
    assert plan["smem"] == hk8_smem(n_rg, n_tt, n_dt) <= _native.SMEM_MAX


def test_likelihood_ctf_plan_raises():
    """Blocks that do not fit raise: past the shared memory (the (D, T, R)
    block of 36 x 30 x 256), past 384 threads of register tiles (13
    translation tiles, 13 warps)."""
    with pytest.raises(ValueError, match="shared memory"):
        tlk.likelihood_ctf_plan(30, 256, 30)
    with pytest.raises(ValueError, match="warps"):
        tlk.likelihood_ctf_plan(9, 16, 39)


GROUPS = ["C2", "C3", "C4", "C5", "C6", "C8", "D2", "D3", "D4", "D5", "D6", "T", "O",
          "I1", "I2", "I3", "I4"]


@pytest.mark.parametrize("sym", GROUPS)
def test_symmetrize_form(sym):
    """HK7 takes an orbit form exactly for the groups whose mates are all
    signed permutations: flat bricks ("orbit") where z stays on its axis
    (C2, C4, D2, D4), cubes ("orbit-cube") where it does not (O); the
    staged box for the rest.  An orbit of bricks fits the shared memory,
    a mate maps the bricks onto themselves (equal odd edges on the axes
    it exchanges), and the bricks, indices -M..M, cover even and odd
    grids."""
    s = Symmetry(sym)
    m = s._mats
    signed = all(np.allclose(np.abs(r), np.eye(3)[np.argmax(np.abs(r), 1)], atol=1e-9)
                 for r in m)
    assert signed == (sym in ("C2", "C4", "D2", "D4", "O"))
    form = trec.symmetrize_form(s.matrices)
    assert form == ("box" if not signed else "orbit-cube" if sym == "O" else "orbit")
    for big in (24, 37, 152, 320):
        plan = trec.symmetrize_plan(form, s.order, big)
        edges, n = plan["edges"], plan["n"]
        assert plan["smem"] <= _native.SMEM_MAX
        if form == "box":
            assert n == [-(-big // 8)] * 3 and plan["threads"] == 512
            continue
        c = big // 2
        assert plan["smem"] == s.order * edges[0] * edges[1] * edges[2] * 12 <= trec.SYM_ORBIT_SMEM
        for r in np.round(m).astype(int):
            assert all(edges[a] == edges[int(np.argmax(np.abs(r[a])))] for a in range(3))
        for b, k in zip(edges, n):
            h, m_ = (b - 1) // 2, k // 2
            assert b % 2 == 1 and b * -m_ - h <= -c and b * m_ + h >= big - 1 - c
        if form == "orbit-cube":
            assert edges == (5, 5, 5)
            continue
        cover = lambda b: b * (2 * max(-(((b - 1) // 2 - c) // b),
                                       (big - 1 - c + (b - 1) // 2) // b) + 1)
        fits = [b for b in (31, 29, 27, 25, 23) if s.order * b * b * 12 <= trec.SYM_ORBIT_SMEM]
        assert edges[2] == 1 and edges[0] in fits
        assert all(cover(b) > cover(edges[0]) or (cover(b) == cover(edges[0]) and b <= edges[0])
                   for b in fits)


@pytest.mark.parametrize("sym,big", [("C4", 152), ("D2", 37), ("D4", 40), ("O", 24),
                                     ("C2", 33)])
def test_symmetrize_orbit_representatives(sym, big):
    """The orbit form's blocks: one for each orbit of bricks under the
    group, named by the orbit's least brick index; together the orbits
    hold every brick once."""
    s = Symmetry(sym)
    form = trec.symmetrize_form(s.matrices)
    plan = trec.symmetrize_plan(form, s.order, big)
    reps = form.reps(plan, "cpu").numpy()
    assert form.reps(plan, "cpu") is form.reps(plan, "cpu")      # built once
    n = np.asarray(plan["n"])
    seen = np.zeros(int(n.prod()), int)
    for rep in reps:
        m = np.array([rep % n[0], rep // n[0] % n[1], rep // (n[0] * n[1])]) - n // 2
        orbit = {int(((q[2] * n[1] + q[1]) * n[0] + q[0]))
                 for q in (p @ m + n // 2 for p in form.perms)}
        assert min(orbit) == rep
        seen[list(orbit)] += 1
    assert (seen == 1).all()


def test_symmetrize_form_of_c1_and_of_one_turned_mate():
    """C1 is a signed permutation group; a C4 whose quarter turn is off by
    1e-4 is not."""
    assert trec.symmetrize_form(Symmetry("C1").matrices) == "orbit"
    m = Symmetry("C4").matrices.clone()
    m[1, 0, 0] += 1e-4
    assert trec.symmetrize_form(m) == "box"


def test_ctf_terms_equal_the_per_call_forms():
    """The CTF constants and the pixels' geometry formed once a round
    equal what HK8's wrapper formed on every call before (fx, fy, f^2,
    atan2 of the packed pixels; ctf_constants of the images), and
    ``images`` selects the per-image fields only."""
    rng = np.random.default_rng(3)
    n_l, size, px = 5, 64, 1.32
    rings = pack_rings(size, 20, 1)
    defocus = rng.uniform(8000, 20000, (2, n_l))
    ctf = ctf_params(np.full((2, n_l), 300e3), defocus, defocus * 1.05,
                     rng.uniform(0, 3, (2, n_l)), np.full((2, n_l), 2e7),
                     np.full((2, n_l), 0.1), np.zeros((2, n_l)))
    terms = tlk.ctf_terms(ctf, rings.i_col, rings.i_row, size, px)
    fcol, frow = rings.i_col.to(torch.float32), rings.i_row.to(torch.float32)
    fx, fy = fcol / (px * size), frow / (px * size)
    assert torch.equal(terms.f2, fx * fx + fy * fy)
    assert torch.equal(terms.ang, torch.atan2(frow, fcol))
    assert torch.equal(terms.consts, ctf_constants(ctf)) and terms.consts.shape == (2, n_l, 8)
    one = terms.images(lambda a: a[1])
    assert torch.equal(one.consts, ctf_constants(ctf)[1])
    assert torch.equal(one.params.defocus_u, ctf.defocus_u[1])
    assert one.f2 is terms.f2 and one.size == size and one.pixel_size == px
