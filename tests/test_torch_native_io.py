"""The port's native IO library (thunder_tpu_torch/io/thunder_io.cpp,
bound by io/native.py) against thunder_tpu's native reader and both
packages' numpy readers, bit for bit: MRC modes 0, 1, 2 and 6, even and
odd sizes, ny != nx, an extended header, unordered and repeated indices,
shift on and off, one and eight threads, an offset past 2 GiB; the .thu
parse column for column; the loader on two stacks; and what happens with
no compiler or a broken source.  Built here by the host's C++ compiler."""

import dataclasses
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from thunder_tpu.io import loader as jloader
from thunder_tpu.io import mrc as jmrc
from thunder_tpu.io import native as jnative
from thunder_tpu.io import thu as jthu
from thunder_tpu_torch.io import loader as tloader
from thunder_tpu_torch.io import mrc as tmrc
from thunder_tpu_torch.io import native
from thunder_tpu_torch.io import thu as tthu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {0: np.int8, 1: np.int16, 2: np.float32, 6: np.uint16}
INDICES = [5, 0, 3, 3, 1, 5, 2]       # unordered, repeated


def mrc_header(nz: int, ny: int, nx: int, mode: int, nsymbt: int = 0) -> bytes:
    header = bytearray(1024)
    struct.pack_into("<4i", header, 0, nx, ny, nz, mode)
    struct.pack_into("<3i", header, 28, nx, ny, nz)
    struct.pack_into("<3f", header, 40, float(nx), float(ny), float(nz))
    struct.pack_into("<i", header, 92, nsymbt)
    header[208:212] = b"MAP "
    return bytes(header)


def write_stack(path, data: np.ndarray, mode: int, nsymbt: int = 0) -> None:
    """An MRC2014 stack of ``data`` stored in ``mode``, behind an extended
    header of ``nsymbt`` bytes."""
    with open(path, "wb") as f:
        f.write(mrc_header(*data.shape, mode, nsymbt))
        f.write(bytes(np.arange(nsymbt, dtype=np.uint8)))
        f.write(np.ascontiguousarray(data, DTYPES[mode]).astype(
            np.dtype(DTYPES[mode]).newbyteorder("<")).tobytes())


def stack_data(rng, mode: int, shape: tuple) -> np.ndarray:
    if mode == 2:
        return (100 * rng.standard_normal(shape)).astype(np.float32)
    info = np.iinfo(DTYPES[mode])
    return rng.integers(info.min, info.max, shape, endpoint=True, dtype=DTYPES[mode])


def same_bits(a, b) -> None:
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.fixture(scope="module")
def both_native():
    assert native.available(), "the port's native reader needs a C++ compiler (c++ or g++)"
    # thunder_tpu builds its library with make in place, and caches a failed load: another
    # test process may be writing that file just now, so look again for a while
    for _ in range(60):
        if jnative.available():
            return
        jnative._tried = False
        time.sleep(1)
    pytest.fail("thunder_tpu's native reader did not build")


@pytest.mark.parametrize("nsymbt", [0, 37])
@pytest.mark.parametrize("ny,nx", [(8, 8), (9, 9), (6, 11)])
@pytest.mark.parametrize("mode", [0, 1, 2, 6])
def test_native_stack_read_equals_every_reader(tmp_path, both_native, mode, ny, nx, nsymbt):
    """Every reader gives the same bits: the port's native one at one
    and eight threads, thunder_tpu's native one, both packages' MrcFile;
    mode 0 is signed and mode 6 unsigned; the remap is numpy's ifftshift
    at odd sizes too."""
    rng = np.random.default_rng(mode * 100 + ny * 10 + nx + nsymbt)
    data = stack_data(rng, mode, (6, ny, nx))
    path = str(tmp_path / "s.mrcs")
    write_stack(path, data, mode, nsymbt)
    raw = data[INDICES].astype(np.float32)
    for shift in (True, False):
        want = np.fft.ifftshift(raw, axes=(-2, -1)) if shift else raw
        same_bits(tmrc.MrcFile(path).read_slices(INDICES, shift=shift), want)
        same_bits(jmrc.MrcFile(path).read_slices(INDICES, shift=shift), want)
        same_bits(jnative.read_mrc_slices_native(path, INDICES, shift=shift), want)
        for n_threads in (1, 8):
            same_bits(native.read_mrc_slices_native(path, INDICES, shift, n_threads), want)


def test_native_read_past_2_gib(tmp_path, both_native):
    """A sparse stack (its header, then truncate) whose last slice starts
    past 2^31 bytes: that slice, written there, reads back exactly in
    every reader, and the holes read as zeros."""
    probe = tmp_path / "probe"
    with open(probe, "wb") as f:
        f.truncate(64 << 20)
    if os.stat(probe).st_blocks * 512 >= 32 << 20:
        pytest.skip(f"the filesystem under {tmp_path} keeps no sparse files: a 2 GiB stack "
                    "would be written out whole")
    os.remove(probe)
    ny, nx = 64, 48
    sb = ny * nx * 4
    nz = 2 ** 31 // sb + 3
    offset = 1024 + (nz - 1) * sb
    assert offset > 2 ** 31
    path = str(tmp_path / "big.mrcs")
    last = np.random.default_rng(5).standard_normal((ny, nx)).astype(np.float32)
    with open(path, "wb") as f:
        f.write(mrc_header(nz, ny, nx, 2))
        f.seek(offset)
        f.write(last.tobytes())
        f.truncate(1024 + nz * sb)
    idx = [nz - 1, 0, nz - 1]
    want = np.stack([last, np.zeros_like(last), last])
    for shift in (True, False):
        w = np.fft.ifftshift(want, axes=(-2, -1)) if shift else want
        same_bits(native.read_mrc_slices_native(path, idx, shift), w)
        same_bits(jnative.read_mrc_slices_native(path, idx, shift), w)
        same_bits(tmrc.MrcFile(path).read_slices(idx, shift), w)
        same_bits(jmrc.MrcFile(path).read_slices(idx, shift), w)


def test_native_read_errors_raise_ioerror(tmp_path, both_native):
    """An index outside the stack and a file shorter than a header raise
    IOError in both packages' native readers."""
    path = str(tmp_path / "s.mrcs")
    write_stack(path, np.ones((3, 4, 4), np.float32), 2)
    for bad in ([3], [0, -1]):
        with pytest.raises(IOError, match="-5"):
            native.read_mrc_slices_native(path, bad)
        with pytest.raises(IOError, match="-5"):
            jnative.read_mrc_slices_native(path, bad)
    short = tmp_path / "short.mrc"
    short.write_bytes(b"\0" * 100)
    for reader in (native, jnative):
        with pytest.raises(IOError, match="-2"):
            reader.read_mrc_slices_native(str(short), [0])


def thu_table(n: int, seed: int) -> tthu.ThuTable:
    rng = np.random.default_rng(seed)
    t = tthu.ThuTable.blank(n)
    t.defocus_u = rng.uniform(8e3, 3e4, n)
    t.defocus_v = t.defocus_u * rng.uniform(0.95, 1.05, n)
    t.defocus_theta = rng.uniform(0, np.pi, n)
    t.cs = np.full(n, 2.7e7)
    t.amplitude_contrast = np.full(n, 0.07)
    t.coord_x, t.coord_y = rng.uniform(0, 4096, n), rng.uniform(0, 4096, n)
    t.group_id = rng.integers(1, 4, n)
    t.class_id = rng.integers(0, 3, n)
    t.quat = rng.standard_normal((n, 4))
    t.k1, t.k2, t.k3 = rng.exponential(1e-3, (3, n))
    t.trans = rng.normal(0, 3, (n, 2))
    t.std_trans = rng.uniform(0.1, 2, (n, 2))
    t.defocus_factor = rng.uniform(0.95, 1.05, n)
    t.score = rng.normal(size=n)
    t.particle_path = [f"{i + 1:06d}@stacks/p_{i % 3}.mrcs" for i in range(n)]
    t.micrograph_path = [f"mics/m_{i % 2}.mrc" for i in range(n)]
    return t


def thu_variant(text: str, variant: str) -> str:
    if variant == "comments and blank lines":
        lines = text.splitlines(keepends=True)
        return ("#0:VOLTAGE\tFLOAT\t18.9f\n  # indented comment\n\n" + "".join(lines[:2])
                + " \t \n\n#27 columns follow\n" + "".join(lines[2:]) + "#trailing, no newline")
    if variant == "CRLF, no final newline":
        return text.replace("\n", "\r\n").rstrip("\r\n")
    if variant == "empty":
        return "# a header and nothing else\n\n"
    return text


@pytest.mark.parametrize("variant", ["plain", "comments and blank lines",
                                     "CRLF, no final newline", "empty"])
def test_native_thu_parse_equals_read_thu(tmp_path, both_native, variant):
    """The port's read_thu_native equals thunder_tpu's and the port's
    read_thu column for column: the same values and dtypes, the same
    paths."""
    src = str(tmp_path / "src.thu")
    tthu.write_thu(src, thu_table(9, 3))
    path = str(tmp_path / "t.thu")
    with open(src) as f, open(path, "w", newline="") as g:
        g.write(thu_variant(f.read(), variant))
    got = native.read_thu_native(path)
    assert isinstance(got, tthu.ThuTable)
    assert len(got) == (0 if variant == "empty" else 9)
    for other in (jnative.read_thu_native(path), tthu.read_thu(path), jthu.read_thu(path)):
        for f in dataclasses.fields(tthu.ThuTable):
            a, b = getattr(got, f.name), getattr(other, f.name)
            if isinstance(a, list):
                assert a == list(b), f.name
            else:
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)


def two_stacks(tmp_path) -> tuple:
    """A .thu over two stacks (5 and 4 images, 13 x 13) and a shuffled
    subset of its rows."""
    rng = np.random.default_rng(7)
    os.makedirs(tmp_path / "st")
    stacks = {"st/a.mrcs": stack_data(rng, 2, (5, 13, 13)),
              "st/b.mrcs": stack_data(rng, 1, (4, 13, 13))}
    for name, data in stacks.items():
        write_stack(str(tmp_path / name), data, 2 if data.dtype == np.float32 else 1)
    t = thu_table(9, 4)
    t.particle_path = ([f"{i + 1:06d}@st/a.mrcs" for i in (4, 0, 2, 1, 3)]
                       + [f"{i + 1:06d}@st/b.mrcs" for i in (3, 1, 2, 0)])
    path = str(tmp_path / "two.thu")
    tthu.write_thu(path, t)
    return path, rng.permutation(9)[:6], str(tmp_path) + "/"


def test_load_images_native_equals_thunder_tpu_and_numpy(tmp_path, both_native, monkeypatch):
    """load_images on a .thu that addresses two stacks, in a shuffled
    subset: the port's native path equals thunder_tpu's load_images and
    the port's numpy path, and the loader counts each stack under the
    reader that read it."""
    path, subset, prefix = two_stacks(tmp_path)
    before = dict(tloader.READS)
    got = tloader.load_images(tthu.read_thu(path), prefix, subset)
    assert tloader.READS["native"] - before["native"] == 2
    same_bits(got, jloader.load_images(jthu.read_thu(path), prefix, subset))
    monkeypatch.setattr(native, "available", lambda: False)
    before = dict(tloader.READS)
    same_bits(tloader.load_images(tthu.read_thu(path), prefix, subset), got)
    assert tloader.READS == dict(before, numpy=before["numpy"] + 2)


def test_no_compiler_reads_with_numpy_and_broken_source_raises(tmp_path, both_native,
                                                               monkeypatch):
    """With no C++ compiler found, available() is False, the native
    readers return None and the loader reads the same bits with numpy;
    a source that does not compile raises with the compiler's message
    and leaves no file behind."""
    path, subset, prefix = two_stacks(tmp_path)
    want = tloader.load_images(tthu.read_thu(path), prefix, subset)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert not native.available()
    assert native.read_mrc_slices_native(str(tmp_path / "st/a.mrcs"), [0]) is None
    assert native.read_thu_native(path) is None
    numpy_before = tloader.READS["numpy"]
    same_bits(tloader.load_images(tthu.read_thu(path), prefix, subset), want)
    assert tloader.READS["numpy"] == numpy_before + 2

    monkeypatch.undo()
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" int mrc_open(const char* path {\n')
    build = tmp_path / "build"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.available()
    assert os.listdir(build) == []


def test_concurrent_builds_leave_one_library(tmp_path):
    """Four processes building into one empty directory at once all load
    a library, and one file is left there: each compiles to a name of
    its own and renames it into place."""
    build = str(tmp_path / "build")
    code = ("import sys; from thunder_tpu_torch.io import native as n; "
            "n.BUILD_DIR = sys.argv[1]; assert n.available(); "
            "print(n.read_mrc_slices_native(sys.argv[2], [1, 0], True, 8).sum())")
    stack = str(tmp_path / "s.mrcs")
    write_stack(stack, np.arange(2 * 4 * 4, dtype=np.float32).reshape(2, 4, 4), 2)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, build, stack], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    assert {out.strip() for out, _ in outs} == {str(np.float32(sum(range(32))))}
    assert len(os.listdir(build)) == 1 and os.listdir(build)[0].endswith(".so")
