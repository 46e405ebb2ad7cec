"""The plain twins of G1-G5 (thunder_tpu_torch/ops/gather.py) against
the jnp expressions in the kernel bodies of the repo's eight
``pl.pallas_call`` gathers (scripts/micro_pallas_gather.py,
micro_mosaic_gather.py, micro_rowgather.py), reproduced here on the same
numpy inputs — the scripts' closures are not importable.  Gathers copy
values, so equality is exact (tolerance 0).  Shapes are the scripts'
defaults, with fewer samples for the two big cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu_torch.micro import gather as micro
from thunder_tpu_torch.ops import gather as g

ROWS, LANES, B = 512, 128, 1024          # micro_mosaic_gather.py:22-23


def t(x):
    return torch.as_tensor(np.asarray(x))


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return dict(
        t=rng.standard_normal(2 ** 20 // 4).astype(np.float32),
        idx=rng.integers(0, 2 ** 20 // 4, 2 ** 16).astype(np.int32),
        tab=rng.standard_normal((ROWS, LANES)).astype(np.float32),
        src=rng.standard_normal((B, LANES)).astype(np.float32),
        ridx=rng.integers(0, ROWS, (B, LANES)).astype(np.int32),
        lidx=rng.integers(0, LANES, (B, LANES)).astype(np.int32),
        rvec=rng.integers(0, ROWS, B).astype(np.int32),
        tab_h=rng.standard_normal((3600, LANES)).astype(np.float32),
        zy=rng.integers(0, 3600 - 60 - 1, 2 * 3600).astype(np.int32),
    )


def test_g1_f_pallas(inputs):
    # kernel: out_ref[:] = jnp.take(tab_ref[:], idx_ref[:], axis=0)
    tab, idx = inputs["t"], inputs["idx"]
    same(g.take_flat(t(tab), t(idx)), jnp.take(tab, idx, axis=0))


def test_g1_f_pallas2(inputs):
    # kernel2: picked_rows = take(tab, r, axis=0); take_along_axis(picked, c)
    tab, idx = inputs["t"], inputs["idx"]
    t2 = tab.reshape(-1, 128)
    r = (idx // 128).reshape(-1, 128)
    c = (idx % 128).reshape(-1, 128)
    picked = jnp.take(t2, r.reshape(-1), axis=0).reshape(r.shape + (128,))
    ref = jnp.take_along_axis(picked, c[..., None], axis=-1)[..., 0]
    same(g.take_flat(t(tab), t(r * 128 + c)), ref)


def test_g2_case_a(inputs):
    tab, ridx = inputs["tab"], inputs["ridx"]
    ref = jnp.take_along_axis(tab, jnp.clip(ridx, 0, ROWS - 1), axis=0)
    same(g.take_along_rows(t(tab), t(ridx)), ref)


def test_g3_case_b(inputs):
    src, lidx = inputs["src"], inputs["lidx"]
    ref = jnp.take_along_axis(src, jnp.clip(lidx, 0, LANES - 1), axis=1)
    same(g.take_along_lanes(t(src), t(lidx)), ref)


def test_g4_case_c(inputs):
    tab, ridx, lidx = inputs["tab"], inputs["ridx"], inputs["lidx"]
    rows = jnp.take_along_axis(tab, jnp.clip(ridx, 0, ROWS - 1), axis=0)
    ref = jnp.take_along_axis(rows, jnp.clip(lidx, 0, LANES - 1), axis=1)
    same(g.take_along_both(t(tab), t(ridx), t(lidx)), ref)
    # a row take then a lane take is not the 2D gather tab[ridx, lidx]
    assert not np.array_equal(np.asarray(ref), tab[ridx, lidx])


def test_g1_case_d(inputs):
    tab1 = inputs["tab"].reshape(-1)
    idx1 = inputs["ridx"] * LANES + inputs["lidx"]
    ref = jnp.take(tab1, jnp.clip(idx1, 0, ROWS * LANES - 1).reshape(-1),
                   axis=0).reshape(B, LANES)
    same(g.take_flat(t(tab1), t(idx1)), ref)


def test_g5_case_e(inputs):
    tab, rvec = inputs["tab"], inputs["rvec"]
    ref = jnp.take(tab, jnp.clip(rvec, 0, ROWS - 1), axis=0)
    same(g.take_rows(t(tab), t(rvec)), ref)


def test_g5_fh(inputs):
    # fH: the row index broadcast over lanes, take_along_axis(axis=0)
    tab, zy = inputs["tab_h"], inputs["zy"]
    zy_b = np.broadcast_to(zy[:, None], (zy.shape[0], LANES))
    ref = jnp.take_along_axis(tab, jnp.clip(zy_b, 0, 3600 - 1), axis=0)
    same(g.take_rows(t(tab), t(zy)), ref)


def test_indices_are_clamped_like_the_scripts():
    tab = np.arange(12, dtype=np.float32).reshape(3, 4)
    same(g.take_flat(t(tab.reshape(-1)), t(np.int32([-3, 5, 40]))), np.float32([0, 5, 11]))
    same(g.take_rows(t(tab), t(np.int32([7, -1]))), tab[[2, 0]])


def test_micro_cases_shapes_and_twins():
    """The microbenchmark's eight cases (here at a small flat table)
    build the scripts' default shapes, and each kernel wrapper agrees
    with its plain version on them (on the CPU both are the plain one;
    the card holds the kernels to them)."""
    cases = micro.build_cases(torch.device("cpu"), table_mb=0.25, n_samples_m=0.0625)
    assert [c.name for c in cases] == ["f_pallas", "f_pallas2", "case_a", "case_b",
                                       "case_c", "case_d", "case_e", "fH"]
    assert [micro.KERNEL_ID[c.kernel] for c in cases] == ["G1", "G1", "G2", "G3", "G4",
                                                         "G1", "G5", "G5"]
    assert cases[-1].args[0][1].shape == (337 * 3600,)
    for c in cases[:-1]:
        assert len(c.args) == micro.N_VARY
        same(c.kernel(*c.args[1]), micro.PLAIN[c.kernel](*c.args[1]))
    with pytest.raises(RuntimeError, match="CUDA"):
        micro.run(torch.device("cpu"))
