"""The port stands alone: no module of thunder_tpu_torch (nor
chip_smoke.py) imports thunder_tpu or jax; its own copies of the config,
MRC and .thu readers agree with thunder_tpu's; and its entry points run
on the card unless the caller asks for the CPU."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from thunder_tpu.config import ThunderConfig as JConfig
from thunder_tpu.io import mrc as jmrc
from thunder_tpu.io import thu as jthu
from thunder_tpu_torch import device as tdevice
from thunder_tpu_torch.config import ThunderConfig as TConfig
from thunder_tpu_torch.io import mrc as tmrc
from thunder_tpu_torch.io import thu as tthu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(
    [os.path.relpath(os.path.join(d, f), REPO)
     for d, _, fs in os.walk(os.path.join(REPO, "thunder_tpu_torch"))
     if "_build" not in os.path.relpath(d, REPO).split(os.sep)
     for f in fs if f.endswith(".py")] + ["chip_smoke.py"])


def _imported(tree) -> list:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_jax_nor_thunder_tpu(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [n for n in _imported(tree)
           if n.split(".")[0] in ("jax", "jaxlib", "thunder_tpu")]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("name", ["demo_2D.json", "demo_3D.json", "demo.json"])
def test_config_from_json_matches_thunder_tpu(name):
    """Every field of the port's config, and the derived bands (r_global
    included), equal thunder_tpu's on the repo's reference configs."""
    path = os.path.join(REPO, "configs", name)
    tc, jc = TConfig.from_json(path), JConfig.from_json(path)
    for f in dataclasses.fields(TConfig):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for prop in ("mode_2d", "n_rot_global", "n_rot_local", "max_r", "r_init",
                 "r_global", "r_low"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert tc.res_a2p(12.5) == jc.res_a2p(12.5)


def test_mrc_round_trip_across_packages(tmp_path):
    """Each package reads what the other writes (a volume, a 2D image and
    a stack, with the pixel size and the internal FFT layout), and both
    write the same bytes."""
    rng = np.random.default_rng(0)
    files = {"v.mrc": (rng.standard_normal((6, 8, 10)).astype(np.float32), 1.32, False),
             "i.mrc": (rng.standard_normal((12, 12)).astype(np.float32), 0.9, False),
             "s.mrcs": (rng.standard_normal((3, 10, 10)).astype(np.float32), 1.1, True)}
    for (wname, write), (_, read) in ((("t", tmrc), ("j", jmrc)),
                                          (("j", jmrc), ("t", tmrc))):
        for name, (arr, px, stack) in files.items():
            path = str(tmp_path / f"{wname}_{name}")
            write.write_mrc(path, arr, px, is_stack=stack)
            if stack:
                np.testing.assert_array_equal(read.MrcFile(path).read_slices([2, 0]),
                                              arr[[2, 0]])
            else:
                got, got_px = read.read_mrc(path)
                np.testing.assert_array_equal(got, arr)
                assert abs(got_px - px) < 1e-6
    for name in files:
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()


def test_thu_round_trip_across_packages(tmp_path):
    """A .thu written by either package reads back field by field in the
    other, and both write the same bytes."""
    rng = np.random.default_rng(1)
    n = 7
    t = tthu.ThuTable.blank(n, voltage=300e3)
    t.defocus_u = rng.uniform(8000, 20000, n)
    t.defocus_v = t.defocus_u * 1.02
    t.defocus_theta = rng.uniform(0, 3, n)
    t.quat = rng.standard_normal((n, 4))
    t.trans = rng.normal(0, 2, (n, 2))
    t.class_id = rng.integers(0, 4, n)
    t.particle_path = [f"{i + 1:06d}@particles.mrcs" for i in range(n)]
    tthu.write_thu(str(tmp_path / "a.thu"), t)
    j = jthu.read_thu(str(tmp_path / "a.thu"))
    jthu.write_thu(str(tmp_path / "b.thu"), j)
    back = tthu.read_thu(str(tmp_path / "b.thu"))
    assert open(tmp_path / "a.thu").read() == open(tmp_path / "b.thu").read()
    for f in dataclasses.fields(tthu.ThuTable):
        a, b, c = getattr(back, f.name), getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, list):
            assert a == b == list(c)
        else:
            np.testing.assert_allclose(a, b)
            np.testing.assert_allclose(a, c, atol=1e-8)
    sel = back.select([4, 1])
    assert sel.particle_path == [t.particle_path[4], t.particle_path[1]]
    assert tthu.parse_stack_ref("000012@s.mrcs") == jthu.parse_stack_ref("000012@s.mrcs")


@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_as_device_raises_without_a_card(no_card):
    for dev in (None, "auto", "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            tdevice.as_device(dev)
    assert tdevice.as_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    """With no card and no explicit CPU, the synthetic generators, the
    Optimiser and the CLI raise instead of running on the CPU."""
    from thunder_tpu_torch.cli.thunder import main
    from thunder_tpu_torch.optimiser import Optimiser
    from thunder_tpu_torch.pipeline import synthetic

    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.make_dataset_2d(16, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.write_demo(str(tmp_path / "d"), n=4, size=16)
    cfg_path = synthetic.write_demo(str(tmp_path / "demo"), n=8, size=16, device="cpu")
    cfg = TConfig.from_json(cfg_path)
    imgs = np.zeros((8, 16, 16), np.float32)
    ctf = tuple(np.full(8, v) for v in (300e3, 1e4, 1e4, 0.0, 2e7, 0.1, 0.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Optimiser(cfg, imgs, ctf, np.zeros(8, np.int64))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([cfg_path])
