"""The port's z-slab reconstruction (recon/sharded.py) and HK9's plain
twin on the CPU, four gloo ranks (hemi 2 x data 2) where ranks are
needed.

* ``_fft3_dist`` and the half-box roll on slabs against torch.fft.fftn
  and ifftshift of the whole volume;
* ``reconstruct_all_sharded`` against thunder_tpu's
  ``reconstruct_all_sharded`` on a (2, 2) mesh of the conftest's devices
  from the same F / T, and ``reconstruct_two_pass_sharded`` against the
  port's one-grid ``reconstruct_two_pass``;
* ``insert_trilinear_slab_plain`` summed over slabs against HK3's plain
  version then HK7's (grid-side C4) and, inside the radius, against HK3's
  with the mates expanded pose-side;
* a C2 round through the slab path (``vol_shard_min_mb = 0``) against the
  one-process round, held to thunder_tpu's own bound (corr > 0.985,
  tests/test_volume_sharding.py:195-236).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

K, G, PF, R_U, OUT = 1, 12, 2, 5, 16
BIG = G * PF


def _grids():
    """Hermitian-symmetric centered F (2, K, BIG^3), even T > 0 and an FSC
    curve, from a seed."""
    from thunder_tpu_torch.ops.insert import hermitianize, hermitianize_real

    rng = np.random.default_rng(7)
    shape = (2, K) + (BIG,) * 3
    f = torch.as_tensor((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                        .astype(np.complex64))
    t = torch.as_tensor(rng.uniform(0.5, 1.5, shape).astype(np.float32))
    fsc = np.clip(np.linspace(1.0, -0.1, 20), 0, 1)[None].repeat(K, 0).astype(np.float32)
    return (hermitianize(f) / 2).numpy(), (hermitianize_real(t) / 2).numpy(), fsc


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _sharded_rank(rank, world, tmp):
    from thunder_tpu_torch.parallel.distributed import default_mesh
    from thunder_tpu_torch.recon import sharded as sh

    lay = default_mesh(device="cpu")
    f2, t2, fsc = _grids()
    z0, bz = sh.sharded_grid_specs(lay, BIG)
    h = lay.h
    f_slab = torch.as_tensor(f2[h, :, z0:z0 + bz]).contiguous()
    t_slab = torch.as_tensor(t2[h, :, z0:z0 + bz]).contiguous()
    fsc_t = torch.as_tensor(fsc)
    out = dict(
        fft=sh._fft3_dist(f_slab, lay, inverse=False),
        ifft=sh._fft3_dist(f_slab, lay, inverse=True),
        shift=sh._centered_to_fft(f_slab, lay),
        rfft=sh._rfft3_dist(t_slab, lay),
        irfft=sh._irfft3_dist(sh._rfft3_dist(t_slab, lay), lay, BIG),
        one=sh.reconstruct_all_sharded(lay, f_slab, t_slab, fsc_t, G, PF, R_U,
                                       True, True, OUT),
        two=torch.stack(sh.reconstruct_two_pass_sharded(lay, f_slab, t_slab, fsc_t, G, PF,
                                                        R_U, OUT)))
    torch.save(out, os.path.join(tmp, f"sh{rank}.pt"))


@pytest.fixture(scope="module")
def sharded_outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    run_ranks(_sharded_rank, 4, str(tmp), tmp=tmp)
    return [torch.load(tmp / f"sh{r}.pt") for r in range(4)]


def test_fft3_dist_and_shift_match_whole_volume(sharded_outputs):
    f2, t2, _ = _grids()
    bz = BIG // 2
    for r, got in enumerate(sharded_outputs):
        h, j = r // 2, r % 2
        x = torch.as_tensor(f2[h])
        sl = slice(j * bz, (j + 1) * bz)
        torch.testing.assert_close(got["fft"], torch.fft.fftn(x, dim=(-3, -2, -1))[:, sl],
                                   rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got["ifft"], torch.fft.ifftn(x, dim=(-3, -2, -1))[:, sl],
                                   rtol=1e-4, atol=1e-6)
        t = torch.as_tensor(t2[h])
        torch.testing.assert_close(got["rfft"], torch.fft.rfftn(t, dim=(-3, -2, -1))[:, sl],
                                   rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got["irfft"], t[:, sl], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got["shift"],
                                   torch.fft.ifftshift(x, dim=(-3, -2, -1))[:, sl],
                                   rtol=0, atol=0)


def test_reconstruct_all_sharded_matches_thunder_tpu(sharded_outputs):
    # jax here, not at the top: the spawned ranks import this module
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from thunder_tpu.recon.sharded import reconstruct_all_sharded

    f2, t2, fsc = _grids()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("hemi", "data"))
    with mesh:
        want = np.asarray(reconstruct_all_sharded(
            mesh, jnp.asarray(f2), jnp.asarray(t2), jnp.asarray(fsc), G, PF, R_U,
            True, True, True, OUT))
    for r, got in enumerate(sharded_outputs):
        h = r // 2
        # the same balance iterations in another FFT library's float order
        assert _rel(got["one"].numpy(), want[h]) < 1e-4


def test_two_pass_sharded_matches_one_grid(sharded_outputs):
    from thunder_tpu_torch.ops.fourier import resize_rl
    from thunder_tpu_torch.recon.reconstructor import reconstruct_two_pass

    f2, t2, fsc = _grids()
    rec_fsc, rec_map = reconstruct_two_pass(torch.as_tensor(f2), torch.as_tensor(t2),
                                            torch.as_tensor(fsc), G, PF, R_U)
    want = torch.stack([resize_rl(rec_fsc, OUT, nd=3), resize_rl(rec_map, OUT, nd=3)])
    for r, got in enumerate(sharded_outputs):
        h = r // 2
        # the same half-space iteration, on slabs and on one grid
        assert _rel(got["two"].numpy(), want[:, h].numpy()) < 1e-4


def _slices(size: int, r_u: int, n: int):
    from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
    from thunder_tpu_torch.ops.insert import dense_slice_values
    from thunder_tpu_torch.physics.ctf import ctf_params

    rng = np.random.default_rng(3)
    ft = torch.as_tensor((rng.standard_normal((n, size, size))
                          + 1j * rng.standard_normal((n, size, size))).astype(np.complex64))
    ctf = ctf_params(*[np.full(n, v) for v in (300e3, 500.0, 500.0, 0.0, 2e7, 0.1, 0.0)],
                     device="cpu")
    rot = rotate3d(random_quat(torch.Generator().manual_seed(5), (n,), "cpu"))
    idx = torch.arange(n)
    trans = torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
    w = torch.as_tensor(rng.uniform(0.5, 1, n).astype(np.float32))
    vals, c2w, _, _ = dense_slice_values(ft, ctf, idx, trans, w, r_u, size, 1.0)
    return ft, ctf, idx, rot, trans, w, vals, c2w


def test_slab_insertion_plain_matches_hk3_then_hk7():
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.ops.insert import (insert_trilinear_plain,
                                              insert_trilinear_slab_plain)
    from thunder_tpu_torch.recon.reconstructor import symmetrize_ft_plain

    size, r_u, pf, n, big, d = 16, 6, 2, 6, 24, 4
    ft, ctf, idx, rot, trans, w, vals, c2w = _slices(size, r_u, n)
    mats = Symmetry("C4", "cpu").matrices
    zeros = lambda dt: torch.zeros((big,) * 3, dtype=dt)
    f3, t3 = insert_trilinear_plain(ft, ctf, idx, rot, trans, w, r_u, pf, size, 1.0,
                                    zeros(torch.complex64), zeros(torch.float32))
    r_pad = float((r_u - 1) * pf)
    f7, t7 = symmetrize_ft_plain(f3, t3, mats, r_pad)
    bz = big // d
    cls = torch.zeros(n, dtype=torch.int64)
    slabs = [insert_trilinear_slab_plain(
        vals, c2w, rot, cls, r_u, pf, mats, torch.zeros((1, bz, big, big), dtype=torch.complex64),
        torch.zeros((1, bz, big, big)), j * bz) for j in range(d)]
    f9 = torch.cat([s[0][0] for s in slabs])
    t9 = torch.cat([s[1][0] for s in slabs])
    assert _rel(f9.numpy(), f7.numpy()) < 1e-5 and _rel(t9.numpy(), t7.numpy()) < 1e-5
    # inside the radius HK9 is HK3 with every mate's poses inserted
    fe, te = zeros(torch.complex64), zeros(torch.float32)
    for m in mats:
        fe, te = insert_trilinear_plain(ft, ctf, idx, m @ rot, trans, w, r_u, pf, size, 1.0,
                                        fe, te)
    k = torch.arange(big) - big // 2
    inside = (k[:, None, None] ** 2 + k[None, :, None] ** 2 + k[None, None, :] ** 2) < r_pad ** 2
    assert _rel(f9[inside].numpy(), fe[inside].numpy()) < 1e-5
    assert _rel(t9[inside].numpy(), te[inside].numpy()) < 1e-5
    # the identity alone is HK3
    one = insert_trilinear_slab_plain(vals, c2w, rot, cls, r_u, pf, mats[:1],
                                      torch.zeros((1, big, big, big), dtype=torch.complex64),
                                      torch.zeros((1, big, big, big)), 0)
    assert _rel(one[0][0].numpy(), f3.numpy()) < 1e-5


def _c2_round_rank(rank, world, tmp):
    from thunder_tpu_torch.parallel.distributed import default_mesh

    opt = _c2_optimiser(0, default_mesh(device="cpu"))
    assert opt._vol_sharded(12)
    opt.run_round(0)
    refs = opt.refs_both()
    if rank == 0:
        np.save(os.path.join(tmp, "refs.npy"), refs)


def _c2_optimiser(min_mb: int, layout=None):
    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.optimiser import Optimiser
    from thunder_tpu_torch.pipeline.synthetic import make_dataset

    size, n = 24, 16
    vol, imgs, _, _, _ = make_dataset(size, n, seed=0, snr=2.0, device="cpu",
                                      defocus_range=(500.0, 500.0), shift=1.5)
    cfg = ThunderConfig(
        mode="3D", k=1, size=size, pixel_size=1.0, mask_radius=10.0, trans_s=1.5,
        init_res=4.0, global_search_res=3.0, sym="C2", m_s=128, m_l_r=8, m_l_t=6,
        m_reco=6, ignore_res=size * 1.0, trans_search_factor=0.25,
        ref_auto_recentre=False, vol_shard_min_mb=min_mb)
    ctf = [np.full(n, v) for v in (300e3, 500.0, 500.0, 0.0, 2e7, 0.1, 0.0)]
    return Optimiser(cfg, imgs, ctf, np.zeros(n, np.int64), init_refs=vol, device="cpu",
                     layout=layout)


def test_c2_round_through_the_slab_path(tmp_path):
    run_ranks(_c2_round_rank, 4, str(tmp_path), tmp=tmp_path)
    got = np.load(tmp_path / "refs.npy")
    opt = _c2_optimiser(512)
    opt.run_round(0)
    want = opt.refs_both()
    assert np.all(np.isfinite(got))
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.985
