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
    cases = micro.build_cases(torch.device("cpu"), table_mb=0.25, n_samples_m=0.0625,
                              scaled_b=2048)
    assert [c.name for c in cases] == ["f_pallas", "f_pallas2", "case_a", "case_b",
                                       "case_c", "case_d", "case_e", "fH", "case_a_scaled",
                                       "case_b_scaled", "case_c_scaled"]
    assert [micro.KERNEL_ID[c.kernel] for c in cases] == ["G1", "G1", "G2", "G3", "G4",
                                                         "G1", "G5", "G5", "G2", "G3", "G4"]
    assert cases[7].args[0][1].shape == (337 * 3600,)
    for c, base in zip(cases[8:], cases[2:5]):
        assert c.args[0][-1].shape == (2048, LANES) and c.count == 2048 * LANES
        assert c.name == base.name + "_scaled" and c.replaces == base.replaces
    assert micro.SCALED_B == 1 << 17
    for c in cases[:7] + cases[8:]:
        assert len(c.args) == micro.N_VARY
        same(c.kernel(*c.args[1]), micro.PLAIN[c.kernel](*c.args[1]))
        # the library call on int64 indices (in range here) gives the same values
        wide = [x.long() if x.dtype == torch.int32 else x for x in c.args[1]]
        same(micro.LIBRARY[c.kernel](*wide), micro.PLAIN[c.kernel](*c.args[1]))
    with pytest.raises(RuntimeError, match="CUDA"):
        micro.run(torch.device("cpu"))


def test_along_form_at_its_edges():
    """G2-G4's form rule at its edges: alignment and width % 4 (scalar),
    ROW_WIDTH (G3, G4: row, else scalar), a block's shared memory
    (64-column strips: 908 rows fill 232,448 bytes; 16-column strips:
    3,632), STRIP_MAX_ROWS and STRIP_MIN_OUTPUTS."""
    lo, hi = g.STRIP_MIN_OUTPUTS[16], g.STRIP_MIN_OUTPUTS[64]
    top = g.STRIP_MAX_ROWS
    assert lo < hi and top == 512
    assert g.along_form(0, 512, 128, hi, (0, 0, 0)) == "strip64"
    assert g.along_form(0, 512, 128, hi - 1, (0, 0, 0)) == "strip16"
    assert g.along_form(0, 512, 128, lo, (0, 0, 0)) == "strip16"
    assert g.along_form(0, 512, 128, lo - 1, (0, 0, 0)) == "scalar"
    assert g.along_form(0, 64, 128, hi) == "strip64"
    assert g.along_form(0, top + 1, 128, hi) == "scalar"
    assert g.along_form(0, top + 1, 128, lo) == "scalar"
    assert g.along_form(0, 909, 128, hi) == "scalar"
    assert g.along_forms(0, 908, 128) == ("scalar", "strip16", "strip64")
    assert g.along_forms(0, 909, 128) == ("scalar", "strip16")
    assert g.along_forms(0, 3632, 128) == ("scalar", "strip16")
    assert g.along_forms(0, 3633, 128) == ("scalar",)
    assert g.along_form(0, 512, 192, hi) == "strip64"
    assert g.along_form(0, 512, 96, hi) == "strip16"
    assert g.along_form(0, 512, 104, hi) == "scalar"
    for mode in (1, 2):
        assert g.along_form(mode, 512, 128, 1 << 30, (0, 0, 0, 0)) == "row"
        assert g.along_form(mode, 909, 124, 1) == "row"
        assert g.along_form(mode, 512, 132, 1 << 30) == "scalar"
    for mode in (0, 1, 2):
        assert g.along_form(mode, 512, 126, hi) == "scalar"
        for off in (4, 8, 12):
            for k in range(3):
                offs = [0, 0, 0]
                offs[k] = off
                assert g.along_form(mode, 512, 128, 1 << 30, offs) == "scalar"
        assert g.along_forms(mode, 512, 128, (4,)) == ("scalar",)
    assert g.along_forms(0, 512, 128) == ("scalar", "strip16", "strip64")
    assert g.along_forms(1, 512, 128) == ("scalar", "row")
    assert g.along_forms(2, 512, 128) == ("scalar", "row")
    assert set(g.FORMS) == {f for m in (0, 1, 2) for f in g.along_forms(m, 512, 128)}


def test_outputs_written_in_place_at_any_offset():
    """G1-G4 write into a given ``out``, here 4 bytes off 16-byte
    alignment, with an index view likewise off (the card launches the
    scalar path for such offsets: micro/gather.py edge_cases)."""
    rng = np.random.default_rng(2)
    tab = t(rng.standard_normal((ROWS, LANES)).astype(np.float32))
    ridx = t(rng.integers(-9, ROWS + 9, B * LANES + 1).astype(np.int32))[1:].view(B, LANES)
    lidx = t(rng.integers(-9, LANES + 9, B * LANES).astype(np.int32)).view(B, LANES)
    buf = torch.zeros(B * LANES + 1)
    out = buf[1:].view(B, LANES)
    for fn, args in ((g.take_along_rows, (tab, ridx)), (g.take_along_lanes, (tab[:1].expand(
            B, LANES).contiguous(), lidx)), (g.take_along_both, (tab, ridx, lidx))):
        got = fn(*args, out=out)
        assert got.data_ptr() == out.data_ptr()
        same(out, micro.PLAIN[fn](*args))
    flat = buf[1:]
    got = g.take_flat(tab.reshape(-1), ridx.reshape(-1), out=flat)
    assert got.data_ptr() == flat.data_ptr()
    same(flat, g.take_flat_plain(tab.reshape(-1), ridx.reshape(-1)))


def test_edge_cases_build_and_agree():
    """micro/gather.py's edge cases (held on the card, where each reports
    the form it launched, by tests/test_torch_kernels.py and chip_smoke.py
    phase 3) sit where the form rule gives every form and both sides of
    each of its edges; on the CPU each wrapper gives its plain version's
    values and launches nothing."""
    cases = micro.edge_cases(torch.device("cpu"))
    seen = micro.check_edges(torch.device("cpu"), say=lambda m: None)
    assert [lab for lab, _ in seen] == [c[0] for c in cases]
    assert all(form == "" for _, form in seen)
    assert any("2^21 + 3" in lab for lab, _ in seen)
    modes = {g.take_along_rows: 0, g.take_along_lanes: 1, g.take_along_both: 2}
    forms = {}
    for label, fn, args, kwargs in cases:
        if fn is g.take_flat:
            continue
        out = kwargs.get("out")
        offs = [x.data_ptr() % 16 for x in (*args, *([] if out is None else [out]))]
        forms[label] = g.along_form(modes[fn], args[0].shape[0], args[0].shape[1],
                                    args[-1].numel(), offs)
    assert set(forms.values()) == set(g.FORMS)
    top = g.STRIP_MAX_ROWS
    expect = {"G2 767 rows of a 512-row table": "scalar",
              "G2 768 rows of a 512-row table": "strip16",
              "G2 8191 rows of a 512-row table": "strip16",
              "G2 8192 rows of a 512-row table": "strip64",
              f"G2 1024 rows of a {top}-row table": "strip16",
              f"G2 1024 rows of a {top + 1}-row table": "scalar",
              "G4 lane indices 0 and 127": "row",
              "G4 lane indices 0 and 127, output +4 B": "scalar"}
    assert {k: forms[k] for k in expect} == expect
