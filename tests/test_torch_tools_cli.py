"""The port's small CLIs and host I/O against thunder_tpu on the CPU, on
the same files: every ``tools`` subcommand, ``project`` with given poses,
``reconstruct`` (C1 without CTF, C4 with it), the project -> reconstruct
round trip, ``star_convert``, the BMP reader and writer, and the
loader's BMP branch."""


import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu.cli import project as jproject  # noqa: E402
from thunder_tpu.cli import reconstruct as jreconstruct  # noqa: E402
from thunder_tpu.cli import star_convert as jstar_convert  # noqa: E402
from thunder_tpu.cli import tools as jtools  # noqa: E402
from thunder_tpu.io import bmp as jbmp  # noqa: E402
from thunder_tpu.io.loader import load_images as jload_images  # noqa: E402
from thunder_tpu_torch.cli import project as tproject  # noqa: E402
from thunder_tpu_torch.cli import reconstruct as treconstruct  # noqa: E402
from thunder_tpu_torch.cli import star_convert as tstar_convert  # noqa: E402
from thunder_tpu_torch.cli import tools as ttools  # noqa: E402
from thunder_tpu_torch.io import bmp as tbmp  # noqa: E402
from thunder_tpu_torch.io.loader import load_images  # noqa: E402
from thunder_tpu_torch.io.mrc import MrcFile, read_mrc, write_mrc  # noqa: E402
from thunder_tpu_torch.io.thu import ThuTable, read_thu, write_thu  # noqa: E402
from thunder_tpu_torch.physics.mask import radial_grid  # noqa: E402

SIZE = 24


def phantom(size: int = SIZE, c4: bool = False) -> np.ndarray:
    """Gaussian blobs (FFT layout); with ``c4`` four copies around z."""
    k = np.arange(size) - size // 2
    kz, ky, kx = np.meshgrid(k, k, k, indexing="ij")
    vol = np.exp(-(kx ** 2 + ky ** 2 + kz ** 2) / (2 * 2.0 ** 2))
    centres = [(3, 0, 1), (-3, 2, -2)]
    if c4:
        centres = [(4, 1, 2), (-1, 4, 2), (-4, -1, 2), (1, -4, 2), (0, 0, -3)]
    for x, y, z in centres:
        vol = vol + np.exp(-((kx - x) ** 2 + (ky - y) ** 2 + (kz - z) ** 2) / (2 * 1.6 ** 2))
    return np.fft.ifftshift(vol).astype(np.float32)


def rel_err(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def vols(tmp_path_factory):
    """Two 24^3 volumes and a mask, written once."""
    d = tmp_path_factory.mktemp("vols")
    rng = np.random.default_rng(0)
    a = phantom()
    b = (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
    paths = {}
    for name, arr, ps in (("a", a, 1.32), ("b", b, 1.32),
                          ("m", (radial_grid(SIZE, 3) < 8).astype(np.float32), 1.32)):
        paths[name] = str(d / f"{name}.mrc")
        write_mrc(paths[name], arr, ps)
    return paths


# subcommand -> (arguments after the subcommand, with {a}, {b}, {m}, {o}
# for the files; the output's file name or None)
TOOLS = {
    "average": (["-i", "{a}", "{b}", "-o", "{o}"], "o"),
    "minus": (["-a", "{a}", "-b", "{b}", "-o", "{o}"], "o"),
    "lowpass": (["-i", "{b}", "-o", "{o}", "--res", "6", "--pixelsize", "1.32"], "o"),
    "bfactor": (["-i", "{b}", "-o", "{o}", "--bfactor", "80"], "o"),
    "mask": (["-i", "{b}", "-o", "{o}", "--mask", "{m}"], "o"),
    "mask_radius": (["-i", "{b}", "-o", "{o}", "--radius", "7"], "o"),
    "mask_default": (["-i", "{b}", "-o", "{o}"], "o"),
    "resize_down": (["-i", "{b}", "-o", "{o}", "--size", "16"], "o"),
    "resize_up": (["-i", "{b}", "-o", "{o}", "--size", "30"], "o"),
    "alignz": (["-i", "{b}", "-o", "{o}"], "o"),
    "genmask": (["-i", "{a}", "-o", "{o}"], "o"),
    "genmask_thres": (["-i", "{a}", "-o", "{o}", "--thres", "0.5", "--ext", "1.5",
                       "--ew", "2"], "o"),
    "genmask_shell": (["-o", "{o}", "--size", "24", "--rin", "4", "--rout", "9",
                       "--pixelsize", "1.32"], "o"),
    "view": (["-i", "{b}"], None),
}


@pytest.mark.parametrize("case", sorted(TOOLS))
def test_tools_match_thunder_tpu(case, vols, tmp_path, capsys):
    """Each subcommand on the same files: the output volume within 1e-5
    of its largest value and the same pixel size (``view``: the same
    printout)."""
    args, out = TOOLS[case]
    cmd = case.split("_")[0] if case != "genmask_shell" else case
    outs = {}
    for tag, mod, extra in (("j", jtools, []), ("t", ttools, ["--device", "cpu"])):
        path = str(tmp_path / f"{tag}.mrc")
        argv = [cmd] + [x.format(o=path, **vols) for x in args] + extra
        capsys.readouterr()
        mod.main(argv)
        outs[tag] = read_mrc(path) if out else capsys.readouterr().out
    if out is None:
        assert outs["t"] == outs["j"] and "pixel_size=1.3200" in outs["t"]
        return
    (got, ps_t), (want, ps_j) = outs["t"], outs["j"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert abs(ps_t - ps_j) < 1e-6
    assert rel_err(got, want) <= 1e-5


def _stack(tmp_path, n: int, c4: bool = False, ctf: bool = False, seed: int = 1):
    """Projections of a phantom at n random poses (thunder_tpu's project
    CLI) and their .thu, with CTF columns if asked; the images carry no
    CTF, which neither package's reconstruct needs for parity."""
    vol_path = str(tmp_path / "vol.mrc")
    write_mrc(vol_path, phantom(c4=c4), 1.32)
    stack, thu_path = str(tmp_path / "projs.mrcs"), str(tmp_path / "poses.thu")
    jproject.main(["-i", vol_path, "-o", stack, "-n", str(n), "--seed", str(seed),
                   "--save-thu", thu_path])
    t = read_thu(thu_path)
    rng = np.random.default_rng(seed)
    t.trans = rng.normal(0, 1.0, (n, 2))
    if ctf:
        t.voltage = np.full(n, 300e3)
        t.defocus_u = rng.uniform(600, 1200, n)
        t.defocus_v = t.defocus_u * 1.03
        t.defocus_theta = rng.uniform(0, np.pi, n)
        t.cs = np.full(n, 2e7)
        t.amplitude_contrast = np.full(n, 0.1)
    write_thu(thu_path, t)
    return vol_path, stack, thu_path


def test_project_with_given_poses_matches_thunder_tpu(tmp_path, monkeypatch):
    """project --thu: the same stack within 1e-4 of its largest value
    (HK1's plain version, a batch a call, against thunder_tpu's loop)."""
    monkeypatch.chdir(tmp_path)
    vol_path, _, thu_path = _stack(tmp_path, 12)
    jproject.main(["-i", vol_path, "-o", "j.mrcs", "--thu", thu_path])
    tproject.main(["-i", vol_path, "-o", "t.mrcs", "--thu", thu_path, "--device", "cpu"])
    got = MrcFile("t.mrcs").read_slices(list(range(12)))
    want = MrcFile("j.mrcs").read_slices(list(range(12)))
    assert rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("sym,ctf", [("C1", False), ("C4", True)])
def test_reconstruct_matches_thunder_tpu(sym, ctf, tmp_path, monkeypatch):
    """reconstruct from the same stack and poses: relative L2 within 2e-2
    (5.8e-4 C1 and 1.45e-2 C4 measured on the CPU).  F agrees to 7e-6;
    T differs at the band's edge, where thunder_tpu's float test of the
    rotated radius lets some of the pixels with |k| = r_u - 1 exactly
    in, and HK3's integer cut (q < (r_u - 1)^2) none; the port's
    gridding balance also keeps W = 1 in cells no slice reached (see
    recon/reconstructor.py: balance_weights)."""
    monkeypatch.chdir(tmp_path)
    _, stack, thu_path = _stack(tmp_path, 240, c4=sym == "C4", ctf=ctf)
    argv = ["--thu", thu_path, "--size", str(SIZE), "--pixelsize", "1.32", "--sym", sym]
    argv += [] if ctf else ["--no-ctf"]
    jreconstruct.main(argv + ["-o", "j.mrc"])
    treconstruct.main(argv + ["-o", "t.mrc", "--device", "cpu"])
    got, want = read_mrc("t.mrc")[0], read_mrc("j.mrc")[0]
    assert got.shape == (SIZE,) * 3 and np.isfinite(got).all()
    err = rel_l2(got, want)
    print(f"reconstruct {sym} ctf={ctf}: relative L2 against thunder_tpu {err:.3e}")
    assert err <= 2e-2, err


def test_project_reconstruct_round_trip(tmp_path, monkeypatch):
    """The port's project (200 random poses) then reconstruct recovers
    the phantom: correlation above 0.95 inside r < size/2 - 4
    (tests/test_io_cli.py::test_project_reconstruct_roundtrip's
    criterion)."""
    monkeypatch.chdir(tmp_path)
    vol = phantom()
    write_mrc("vol.mrc", vol, 1.0)
    tproject.main(["-i", "vol.mrc", "-o", "projs.mrcs", "-n", "200", "--save-thu",
                   "poses.thu", "--device", "cpu"])
    t = read_thu("poses.thu")
    assert t.particle_path[7] == "8@projs.mrcs" and len(t) == 200
    treconstruct.main(["--thu", "poses.thu", "-o", "rec.mrc", "--size", str(SIZE),
                       "--pixelsize", "1.0", "--no-ctf", "--device", "cpu"])
    recon, _ = read_mrc("rec.mrc")
    m = radial_grid(SIZE, 3) < SIZE // 2 - 4
    corr = np.corrcoef(recon[m], vol[m])[0, 1]
    assert corr > 0.95, corr


STAR = ("\ndata_\n\nloop_\n"
        "_rlnVoltage #1\n_rlnDefocusU #2\n_rlnDefocusV #3\n_rlnDefocusAngle #4\n"
        "_rlnSphericalAberration #5\n_rlnAmplitudeContrast #6\n_rlnImageName #7\n"
        "_rlnAngleRot #8\n_rlnAngleTilt #9\n_rlnAnglePsi #10\n_rlnOriginX #11\n"
        "_rlnOriginY #12\n_rlnGroupNumber #13\n"
        "300.0 20000 19000 45.0 2.0 0.1 0001@stack.mrcs 10.0 80.0 200.0 1.5 -2.0 1\n"
        "300.0 21000 20000 30.0 2.0 0.1 0002@stack.mrcs 250.0 30.0 15.0 -0.5 0.25 2\n"
        "200.0 15000 15500 -10.0 2.7 0.07 0003@stack.mrcs 0.0 170.0 359.0 0 0 1\n")


def test_star_convert_matches_thunder_tpu(tmp_path):
    """star2thu and thu2star write the same bytes as thunder_tpu's; a
    round trip gives back the poses and CTFs."""
    (tmp_path / "in.star").write_text(STAR)
    d = str(tmp_path)
    for tag, mod in (("j", jstar_convert), ("t", tstar_convert)):
        mod.main(["star2thu", "-i", f"{d}/in.star", "-o", f"{d}/{tag}.thu"])
        mod.main(["thu2star", "-i", f"{d}/{tag}.thu", "-o", f"{d}/{tag}.star",
                  "--pixelsize", "1.32"])
        mod.main(["star2thu", "-i", f"{d}/{tag}.star", "-o", f"{d}/{tag}2.thu"])
    for name in ("{}.thu", "{}.star", "{}2.thu"):
        assert ((tmp_path / name.format("t")).read_bytes()
                == (tmp_path / name.format("j")).read_bytes()), name
    a, b = read_thu(f"{d}/t.thu"), read_thu(f"{d}/t2.thu")
    assert a.particle_path == b.particle_path
    for f in ("voltage", "defocus_u", "defocus_v", "defocus_theta", "cs",
              "amplitude_contrast", "trans", "group_id"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=1e-6, atol=1e-5)
    # q and -q are one rotation
    dots = np.abs(np.sum(a.quat * b.quat, axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-6)


def test_bmp_matches_thunder_tpu(tmp_path):
    """write_bmp writes thunder_tpu's bytes (odd widths pad their rows),
    read_bmp reads the same pixels, top-down files included."""
    rng = np.random.default_rng(2)
    for h, w in ((16, 16), (37, 45)):
        img = rng.standard_normal((h, w)).astype(np.float32)
        tbmp.write_bmp(str(tmp_path / "t.bmp"), img)
        jbmp.write_bmp(str(tmp_path / "j.bmp"), img)
        assert (tmp_path / "t.bmp").read_bytes() == (tmp_path / "j.bmp").read_bytes()
        np.testing.assert_array_equal(tbmp.read_bmp(str(tmp_path / "j.bmp")),
                                      jbmp.read_bmp(str(tmp_path / "j.bmp")))
    raw = bytearray((tmp_path / "j.bmp").read_bytes())
    raw[22:26] = (-37).to_bytes(4, "little", signed=True)     # a top-down file
    (tmp_path / "down.bmp").write_bytes(bytes(raw))
    np.testing.assert_array_equal(tbmp.read_bmp(str(tmp_path / "down.bmp")),
                                  jbmp.read_bmp(str(tmp_path / "down.bmp")))
    with pytest.raises(ValueError, match="not a BMP"):
        (tmp_path / "x.bmp").write_bytes(b"XX" + bytes(60))
        tbmp.read_bmp(str(tmp_path / "x.bmp"))


def test_loader_reads_bmp_and_mrc_as_thunder_tpu(tmp_path):
    """The loader reads BMP particles and MRC slices as thunder_tpu's
    does, in .thu order (indices too), and refuses a BMP addressed at a
    slice other than the first."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((16, 16)).astype(np.float32)
    bmp = str(tmp_path / "p.bmp")
    tbmp.write_bmp(bmp, img)
    stack = rng.standard_normal((3, 16, 16)).astype(np.float32)
    write_mrc(str(tmp_path / "s.mrcs"), stack, 1.0, is_stack=True)
    t = ThuTable.blank(5, voltage=300e3)
    t.particle_path = ["p.bmp", "3@s.mrcs", "1@p.bmp", "1@s.mrcs", "2@s.mrcs"]
    prefix = str(tmp_path) + "/"
    got = load_images(t, prefix)
    np.testing.assert_array_equal(got, jload_images(t, prefix))
    assert got.shape == (5, 16, 16)
    np.testing.assert_array_equal(got[0], tbmp.read_bmp(bmp))
    np.testing.assert_array_equal(got[1], stack[2])
    np.testing.assert_array_equal(load_images(t, prefix, [4, 0]),
                                  jload_images(t, prefix, [4, 0]))
    t.particle_path[2] = "2@p.bmp"
    for fn in (load_images, jload_images):
        with pytest.raises(ValueError, match="non-zero slice"):
            fn(t, prefix)
