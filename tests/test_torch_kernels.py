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


def test_project_slices(dev):
    g = generator(0, dev)
    tab = torch.randn(2, 40, 40, 40, dtype=torch.complex64, device=dev)
    rot = rotate3d(random_quat(g, (6, 11), dev))
    rings = pack_rings(32, 12, 1, device=dev)
    cls = torch.tensor([0, 1, 1, 0, 1, 0], device=dev)
    for c in (cls, None):
        args = (tab, rot, rings.i_col, rings.i_row, 2, c)
        assert rel_err(projector.project_slices(*args),
                       projector.project_slices_plain(*args)) < 1e-5


def test_likelihood_block(dev):
    n, r, tt = 5, 40, 7
    a = torch.randn(n, device=dev)
    b = 5 * torch.randn(n, 2 * r, device=dev)
    c = 5 * torch.randn(n, 2 * r, tt, device=dev)
    w_r = torch.rand(n, 2 * r, device=dev)
    w_t = torch.rand(n, tt, device=dev)
    outs = []
    for fn in (likelihood.likelihood_block, likelihood.likelihood_block_plain):
        acc = (torch.full((n,), float("-inf"), device=dev), torch.zeros(n, device=dev),
               torch.zeros(n, 2 * r, device=dev), torch.zeros(n, tt, device=dev))
        for k in range(2):
            sl = slice(k * r, (k + 1) * r)
            fn(a, b[:, sl], c[:, sl], w_r[:, sl], w_t, *acc, col0=k * r)
        outs.append(acc)
    for x, y in zip(*outs):
        assert rel_err(x, y) < 1e-5


def test_insert_trilinear(dev):
    rng = np.random.default_rng(0)
    size, n_img, n_s, r_u, pf = 32, 4, 30, 12, 2
    big = 2 * (r_u + 2) * pf
    ft = torch.randn(n_img, size, size, dtype=torch.complex64, device=dev)
    d = rng.uniform(1000, 3000, n_img)
    ctf = ctf_params(np.full(n_img, 300e3), d, d, np.zeros(n_img), np.full(n_img, 2e7),
                     np.full(n_img, 0.1), np.zeros(n_img), device=dev)
    g = generator(1, dev)
    args = (ft, ctf, torch.randint(0, n_img, (n_s,), device=dev),
            rotate3d(random_quat(g, (n_s,), dev)), torch.randn(n_s, 2, device=dev),
            torch.rand(n_s, device=dev), r_u, pf, size, 1.32)
    fk, tk = insert.insert_trilinear(*args, big)
    zero = lambda dt: torch.zeros((big,) * 3, dtype=dt, device=dev)
    fp, tp = insert.insert_trilinear_plain(*args, zero(torch.complex64), zero(torch.float32))
    # atomicAdd order varies from run to run
    assert rel_err(torch.view_as_real(fk), torch.view_as_real(fp)) < 1e-5
    assert rel_err(tk, tp) < 1e-5


def test_shell_sums(dev):
    u, half = spectrum.shell_geometry(24, 3, dev)
    v = torch.randn(3, 3, 24 ** 3, device=dev)
    for w in (half, None):
        # float32 sums added in a run-dependent order
        assert rel_err(spectrum.shell_sums(v, u, 10, w),
                       spectrum.shell_sums_plain(v, u, 10, w)) < 1e-5


def _rot2d(g, shape, dev):
    phi = torch.rand(shape, generator=g, device=dev) * 6.2831853
    return rotate2d_from_unit(torch.stack([torch.cos(phi), torch.sin(phi)], -1))


def test_project_slices_2d(dev):
    g = generator(2, dev)
    tab = torch.randn(3, 36, 36, dtype=torch.complex64, device=dev)
    rings = pack_rings(32, 12, 1, device=dev)
    cls = torch.tensor([0, 2, 1, 2, 0, 1], device=dev)
    rot = _rot2d(g, (6, 11), dev)
    for c in (cls, None):
        args = (tab, rot, rings.i_col, rings.i_row, 2, c)
        assert rel_err(projector.project_slices_2d(*args),
                       projector.project_slices_2d_plain(*args)) < 1e-5
    # one rotation block shared by all classes (stride 0), as in global search
    shared = _rot2d(g, (1, 9), dev).expand(3, 9, 2, 2)
    args = (tab, shared, rings.i_col, rings.i_row, 2, torch.arange(3, device=dev))
    assert rel_err(projector.project_slices_2d(*args),
                   projector.project_slices_2d_plain(*args)) < 1e-5


@pytest.mark.parametrize("r_u", [12, 40])
def test_insert_bilinear_2d(dev, r_u):
    """Several classes; r_u 40 at 160 px takes more than one band of the
    shared-memory window."""
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
    # ~75 slices a class summed in float32 in a run-dependent order
    # (shared then global atomics) against the twin's index_add order;
    # random-signed values cancel, so the error is taken against max |F|
    assert rel_err(torch.view_as_real(fk), torch.view_as_real(fp)) < 1e-4
    assert rel_err(tk, tp) < 1e-4


def test_likelihood_block_2d_shapes(dev):
    """The 2D global search's block: R = 100 rotations x T = 151
    translations = 60 KB of shared memory, past the 48 KB default."""
    n, r, tt = 64, 100, 151
    a = -1e4 + 10 * torch.randn(n, device=dev)
    b = 40 * torch.randn(n, r, device=dev)
    c = 40 * torch.randn(n, tt, r, device=dev).permute(0, 2, 1)
    ones_r = torch.ones(1, 1, device=dev).expand(n, r)
    ones_t = torch.ones(1, 1, device=dev).expand(n, tt)
    outs = []
    for fn in (likelihood.likelihood_block, likelihood.likelihood_block_plain):
        acc = (torch.full((n,), float("-inf"), device=dev), torch.zeros(n, device=dev),
               torch.zeros(n, r, device=dev), torch.zeros(n, tt, device=dev))
        fn(a, b, c, ones_r, ones_t, *acc)
        outs.append(acc)
    for x, y in zip(*outs):
        assert rel_err(x, y) < 1e-5


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
