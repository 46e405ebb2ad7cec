"""Signal subtraction in the port (optimiser.subtract_batch,
Optimiser.save_subtract, the CLI's Subtract.mrcs and Subtract.thu)
against thunder_tpu on the CPU.

thunder_tpu projects from bf16 corner-row tables by default
(optimiser._prepare_projectee_stack); the port from float32 spectra.
The batch stage is held to thunder_tpu's _subtract_batch fed a float32
table (ri_split(..., pack_bf16=False)), the whole save_subtract to
thunder_tpu's default with a looser tolerance."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.ops.projector import (prepare_projectee_2d,  # noqa: E402
                                       prepare_projectee_3d, ri_split)
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu.physics.mask import soft_mask_weight as jsoft_mask  # noqa: E402
from thunder_tpu_torch import interop  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402
from thunder_tpu_torch.io.mrc import MrcFile, read_mrc, write_mrc  # noqa: E402
from thunder_tpu_torch.io.thu import read_thu  # noqa: E402
from thunder_tpu_torch.physics.ctf import CtfParams  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_e2e_3d import make_3d_dataset  # noqa: E402


def ctf_cols(n, rng):
    du = rng.uniform(800, 1500, n)
    return (np.full(n, 300e3), du, du * 1.05, rng.uniform(0, 3, n), np.full(n, 2e7),
            np.full(n, 0.1), np.zeros(n))


@pytest.mark.parametrize("mode_2d", [False, True])
def test_subtract_batch_matches_thunder_tpu(mode_2d):
    """The batch stage on random spectra, two classes, random poses and
    shifts: within 1e-4 of the largest image value."""
    rng = np.random.default_rng(3 + mode_2d)
    size, pf, n_b, k = 24, 2, 10, 2
    nd = 2 if mode_2d else 3
    refs = np.stack([np.fft.ifftn(np.fft.fftn(rng.standard_normal((size,) * nd))
                                  * np.exp(-np.abs(np.fft.fftfreq(size)) * 8)).real
                     for _ in range(k)]).astype(np.float32)
    ft_ori = (rng.standard_normal((n_b, size, size))
              + 1j * rng.standard_normal((n_b, size, size))).astype(np.complex64) * 5
    cols = ctf_cols(n_b, rng)
    cls = rng.integers(0, k, n_b)
    if mode_2d:
        phi = rng.uniform(0, 2 * np.pi, n_b)
        top_r = np.stack([np.cos(phi), np.sin(phi), 0 * phi, 0 * phi], 1)
        prep = prepare_projectee_2d
    else:
        q = rng.standard_normal((n_b, 4))
        top_r = q / np.linalg.norm(q, axis=1, keepdims=True)
        prep = prepare_projectee_3d
    top_r = top_r.astype(np.float32)
    eff_t = rng.normal(0, 2, (n_b, 2)).astype(np.float32)

    f32 = ri_split(jnp.stack([prep(jnp.asarray(r), pf).ft for r in refs]), pack_bf16=False)
    want = np.asarray(jo._subtract_batch(
        jnp.asarray(ft_ori), jctf_params(*cols), f32, jnp.asarray(cls), jnp.asarray(top_r),
        jnp.asarray(eff_t), size, pf, mode_2d, 1.32))
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt)
    got = to.subtract_batch(
        t(ft_ori), CtfParams(*[t(c, torch.float32) for c in cols]),
        to.subtract_table(t(refs), pf, nd), t(cls), t(top_r), t(eff_t), size, pf, 1.32)
    assert got.shape == (n_b, size, size)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-4, err


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port Optimiser on the same 24 px images, the port
    carrying the JAX state (poses near the truth) through interop."""
    size, n = 24, 32
    phantom, imgs, quats, trans = make_3d_dataset(size, n, seed=5)
    rng = np.random.default_rng(5)
    cols = ctf_cols(n, rng)
    kw = dict(mode="3D", k=1, size=size, pixel_size=1.0, mask_radius=size * 0.42,
              trans_s=1.5, init_res=size / 6, global_search_res=size / 10, sym="C1",
              m_s=512, m_l_r=24, m_l_t=9, m_reco=12, ignore_res=float(size))
    jopt = jo.Optimiser(JConfig(**kw), imgs, jctf_params(*cols), np.zeros(n, np.int64),
                        init_refs=phantom)
    topt = to.Optimiser(TConfig(**kw), imgs, cols, np.zeros(n, np.int64),
                        init_refs=phantom, device="cpu")
    par = jopt.state.par
    jopt.state.par = par._replace(
        top_r=jnp.asarray(np.asarray(quats)[jopt.index], jnp.float32),
        top_t=jnp.asarray(np.asarray(trans)[jopt.index] + 0.3, jnp.float32))
    interop.restore(topt, interop.snapshot(jopt))
    mask = np.asarray(jsoft_mask(size, 3, 6.0, 3.0), np.float32)
    return jopt, topt, mask


def test_save_subtract_matches_thunder_tpu_default(pair):
    """save_subtract on the same state against thunder_tpu's default
    (bf16 corner-row tables): relative L2 within 2e-2 (3.8e-4 measured
    on the CPU), every particle in its original place."""
    jopt, topt, mask = pair
    want = jopt.save_subtract(mask)
    got = topt.save_subtract(mask, chunk=7)          # chunks that end mid-hemisphere
    assert got.shape == want.shape == (32, 24, 24) and got.dtype == np.float32
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"save_subtract relative L2 against thunder_tpu's default: {rel:.3e}")
    assert rel <= 2e-2, rel
    assert all(np.abs(got[i]).max() > 0 for i in range(32))


def _demo(tmp_path, with_mask: bool) -> tuple:
    """A 32 px 3D demo resumed in local search for one round, with
    subtraction on and, if asked, a provided reference mask."""
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    size, n = 32, 24
    cfg_path = write_demo(str(tmp_path), n=n, size=size, seed=2, snr=8.0, device="cpu")
    with open(cfg_path) as f:
        c = json.load(f)
    c["Basic"].update({"Global Search": False,
                       ".thu File Storing Paths and CTFs of Images":
                           str(tmp_path / "particles_local.thu")})
    c["Advanced"].update({"Max Number of Iteration": 1,
                          "Number of Sampling Points of Rotation in Local Search (3D)": 12,
                          "Number of Sampling Points Used in Reconstruction": 8})
    c["Subtract"]["Subtract Masked Region Reference From Images"] = True
    if with_mask:
        write_mrc(str(tmp_path / "mask.mrc"),
                  np.asarray(jsoft_mask(size, 3, 10.0, 3.0), np.float32), 1.32)
        c["Reference Mask"].update({"Perform Reference Mask": True,
                                    "Provided Mask": str(tmp_path / "mask.mrc")})
    with open(cfg_path, "w") as f:
        json.dump(c, f)
    return cfg_path, size, n


def test_cli_writes_subtracted_stack_and_thu(tmp_path):
    """With a mask the CLI writes Subtract.mrcs (one finite image a
    particle) and Subtract.thu, whose entry i names slice i and carries
    the pose and CTF of the particle of that entry in the last round's
    .thu; the subtraction takes most of the power inside the mask."""
    from thunder_tpu_torch.cli.thunder import main

    cfg_path, size, n = _demo(tmp_path, with_mask=True)
    assert main([cfg_path, "--device", "cpu"]) == 0
    out = tmp_path / "output"
    stack = str(out / "Subtract.mrcs")
    sub = MrcFile(stack).read_slices(list(range(n)))
    assert sub.shape == (n, size, size) and np.isfinite(sub).all()
    s_thu = read_thu(str(out / "Subtract.thu"))
    meta = read_thu(str(out / "Meta_Round_000.thu"))
    assert s_thu.particle_path == [f"{i + 1}@{stack}" for i in range(n)]
    np.testing.assert_array_equal(s_thu.quat, meta.quat)
    np.testing.assert_array_equal(s_thu.trans, meta.trans)
    np.testing.assert_array_equal(s_thu.defocus_u, meta.defocus_u)
    orig = MrcFile(str(tmp_path / "particles.mrcs")).read_slices(
        [int(p.split("@")[0]) - 1 for p in meta.particle_path])
    m = read_mrc(str(tmp_path / "mask.mrc"))[0][0] > 0.5     # the central section's disc
    ratio = (sub[:, m] ** 2).mean() / (orig[:, m] ** 2).mean()
    print(f"subtracted / original power inside the mask: {ratio:.4f}")
    assert ratio < 0.1, ratio


def test_cli_without_mask_writes_no_subtraction(tmp_path):
    """Subtraction asked for with no mask loaded: a warning, and neither
    file."""
    from thunder_tpu_torch.cli.thunder import main

    cfg_path, _, _ = _demo(tmp_path, with_mask=False)
    assert main([cfg_path, "--device", "cpu"]) == 0
    out = tmp_path / "output"
    assert (out / "Reference_000_Final.mrc").exists()
    assert not (out / "Subtract.mrcs").exists() and not (out / "Subtract.thu").exists()
