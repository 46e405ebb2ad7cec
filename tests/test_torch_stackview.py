"""The port's stack viewer (thunder_tpu_torch/cli/stackview.py) against
thunder_tpu's on the same stack: the contact sheet and its PNG bytes,
the .thu that class selection writes, the info lines; and the selector's
cursor after a terminal resize, which raised IndexError in thunder_tpu
(thunder_tpu/cli/stackview.py:141)."""

import contextlib
import curses
import io

import numpy as np
import pytest


@pytest.fixture()
def fixtures(tmp_path):
    from thunder_tpu_torch.io.mrc import write_mrc
    from thunder_tpu_torch.io.thu import ThuTable, write_thu

    rng = np.random.default_rng(0)
    stack = np.zeros((12, 40, 40), np.float32)
    y, x = np.mgrid[:40, :40]
    for i in range(12):
        stack[i] = (np.exp(-((x - 20) ** 2 + (y - 20) ** 2) / (2 * (3 + i) ** 2))
                    + rng.normal(0, 0.05, (40, 40)))
    write_mrc(str(tmp_path / "classes.mrcs"), stack, is_stack=True)
    t = ThuTable.blank(100, voltage=300e3)
    t.class_id = rng.integers(0, 12, 100)
    write_thu(str(tmp_path / "meta.thu"), t)
    return tmp_path


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_contact_sheet_and_png_equal_thunder_tpu(fixtures):
    from thunder_tpu.cli import stackview as jsv
    from thunder_tpu_torch.cli import stackview as tsv

    stack = tsv._read_stack(str(fixtures / "classes.mrcs"))
    np.testing.assert_array_equal(tsv._contact_sheet(stack, 5), jsv._contact_sheet(stack, 5))
    for mod, name in ((jsv, "jax.png"), (tsv, "torch.png")):
        _run(mod.main, ["show", "-i", str(fixtures / "classes.mrcs"), "-o",
                        str(fixtures / name), "--cols", "5"])
    assert (fixtures / "jax.png").read_bytes() == (fixtures / "torch.png").read_bytes()
    info = [_run(m.main, ["info", "-i", str(fixtures / "classes.mrcs"), "--thu",
                          str(fixtures / "meta.thu")]) for m in (jsv, tsv)]
    assert info[0] == info[1]


def test_class_selection_writes_the_same_thu(fixtures):
    from thunder_tpu.cli import stackview as jsv
    from thunder_tpu.io.thu import read_thu as jread
    from thunder_tpu_torch.cli import stackview as tsv
    from thunder_tpu_torch.io.thu import read_thu

    for mod, name in ((jsv, "jax.thu"), (tsv, "torch.thu")):
        _run(mod.main, ["select", "-i", str(fixtures / "meta.thu"), "-o",
                        str(fixtures / name), "--classes", "0", "3", "7"])
    a, b = jread(str(fixtures / "jax.thu")), read_thu(str(fixtures / "torch.thu"))
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(a.class_id, b.class_id)
    assert list(a.particle_path) == list(b.particle_path)
    assert set(b.class_id) <= {0, 3, 7}


def test_selector_keys_and_resize(fixtures):
    from thunder_tpu_torch.cli.stackview import Selector
    from thunder_tpu_torch.io.thu import read_thu

    out = str(fixtures / "sel.thu")
    occ = np.linspace(0.1, 0.01, 12)
    sel = Selector(12, occ, None, out, str(fixtures / "meta.thu"))
    sel.fit(30, 100)                    # 4 columns x 2 rows: 8 a page
    assert sel.per_page == 8
    sel.key(curses.KEY_NPAGE)           # page 2 holds classes 8-11
    for _ in range(5):
        sel.key(curses.KEY_RIGHT)
    assert sel.cursor == 3
    sel.fit(30, 120)                    # wider: 10 a page, page 2 holds 10-11
    assert sel.start == 10 and sel.cursor == 1
    sel.key(ord(" "))                   # thunder_tpu indexed order[13] here
    assert np.nonzero(sel.selected)[0].tolist() == [11]
    sel.key(ord("s"))
    assert sel.sort == "occ-desc" and sel.order[0] == 0
    sel.key(ord("S"))
    assert sel.msg == "no res data loaded"
    sel.key(ord("w"))
    assert set(read_thu(out).class_id) == {11}
    assert sel.key(ord("q")) is False
