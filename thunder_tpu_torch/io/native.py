"""ctypes bridge to the port's host IO library (io/thunder_io.cpp), with
thunder_tpu.io.native's API: a multithreaded MRC stack reader with the
ifftshift remap, and a .thu parser.

* The library is built at first use, never at import, by ``$CXX`` or
  else ``c++`` / ``g++``, into ``thunder_tpu_torch/_build/`` (git-ignored).
  Its file name carries a hash of the source, the flags and the
  compiler's ``--version``; each build writes a name of its own and
  renames it into place (``os.replace``), so processes that build at
  once never load a half-written file.  No ``-march=native``: a library
  built on one host must run on another, and these reads are bound by
  the disk and memory.
* :func:`available` is False only when no compiler is found; the callers
  then read with numpy (io/mrc.py, io/thu.py), as thunder_tpu does.  A
  failed compile or load raises with the compiler's message: a broken
  source does not pass for a missing toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess

import numpy as np

from thunder_tpu_torch.io.thu import ThuTable

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "thunder_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpthread",)

_lib = None


class _MrcInfo(ctypes.Structure):
    _fields_ = [
        ("nx", ctypes.c_int32), ("ny", ctypes.c_int32),
        ("nz", ctypes.c_int32), ("mode", ctypes.c_int32),
        ("mx", ctypes.c_int32), ("my", ctypes.c_int32),
        ("mz", ctypes.c_int32),
        ("cella_x", ctypes.c_float), ("cella_y", ctypes.c_float),
        ("cella_z", ctypes.c_float), ("nsymbt", ctypes.c_int32),
    ]


_SIGNATURES = {
    "thu_count": (ctypes.c_long, [ctypes.c_char_p]),
    "thu_parse": (ctypes.c_long, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_char_p, ctypes.c_long]),
    "mrc_open": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_MrcInfo)]),
    "mrc_read_slices": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                       ctypes.c_long, ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int, ctypes.c_int]),
}


def compiler() -> list | None:
    """The C++ compiler's command (``$CXX`` when set, else ``c++``, else
    ``g++``), or None when none is found."""
    env = os.environ.get("CXX")
    for cand in [env] if env else ["c++", "g++"]:
        argv = shlex.split(cand)
        exe = shutil.which(argv[0]) if argv else None
        if exe:
            return [exe] + argv[1:]
    return None


def library_path(cxx: list) -> str:
    version = subprocess.run(cxx + ["--version"], capture_output=True, text=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + b"\0" + version.encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libthunder_io_{h.hexdigest()[:16]}.so")


def build(cxx: list) -> str:
    """Compile the library with ``cxx`` if the one for the current source,
    flags and compiler is missing; returns its path."""
    path = library_path(cxx)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run(cxx + list(CXX_FLAGS) + ["-o", tmp, SOURCE] + list(LIBS),
                         capture_output=True, text=True)
    if res.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{' '.join(cxx)} failed ({res.returncode}) on {SOURCE}:\n"
                           f"{res.stderr}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL | None:
    """The loaded library (built on first call), or None when no C++
    compiler is found."""
    global _lib
    if _lib is None:
        cxx = compiler()
        if cxx is None:
            return None
        lib = ctypes.CDLL(build(cxx))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def available() -> bool:
    return library() is not None


def read_thu_native(path: str) -> ThuTable | None:
    """The .thu table at ``path`` (as io/thu.py's read_thu), or None when
    the library is unavailable."""
    lib = library()
    if lib is None:
        return None
    n = lib.thu_count(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    if n == 0:
        return ThuTable.blank(0)
    numeric = np.zeros((n, 25), dtype=np.float64)
    paths_cap = os.path.getsize(path) + 2 * n + 16
    paths_buf = ctypes.create_string_buffer(paths_cap)
    rows = lib.thu_parse(path.encode(),
                         numeric.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                         paths_buf, paths_cap)
    if rows != n:
        raise ValueError(f"{path}: native parse failed (rows={rows})")
    # the packed path strings: particle, micrograph a row
    strs = paths_buf.raw.split(b"\x00")[:2 * n]
    c = numeric       # the file's columns without the two paths
    return ThuTable(
        voltage=c[:, 0], defocus_u=c[:, 1], defocus_v=c[:, 2],
        defocus_theta=c[:, 3], cs=c[:, 4], amplitude_contrast=c[:, 5],
        phase_shift=c[:, 6], particle_path=[s.decode() for s in strs[0::2]],
        micrograph_path=[s.decode() for s in strs[1::2]],
        coord_x=c[:, 7], coord_y=c[:, 8],
        group_id=c[:, 9].astype(np.int64), class_id=c[:, 10].astype(np.int64),
        quat=c[:, 11:15].copy(), k1=c[:, 15], k2=c[:, 16], k3=c[:, 17],
        trans=c[:, 18:20].copy(), std_trans=c[:, 20:22].copy(),
        defocus_factor=c[:, 22], std_defocus_factor=c[:, 23], score=c[:, 24],
    )


def read_mrc_slices_native(path: str, indices, shift: bool = True,
                           n_threads: int = 8) -> np.ndarray | None:
    """Slices ``indices`` (0-based, any order) of the MRC stack at
    ``path`` as (n, ny, nx) float32, in internal FFT layout when
    ``shift`` (as io/mrc.py's MrcFile.read_slices), read by ``n_threads``
    threads; None when the library is unavailable.  Raises IOError on a
    bad header, an index outside the stack or a short read."""
    lib = library()
    if lib is None:
        return None
    info = _MrcInfo()
    rc = lib.mrc_open(path.encode(), ctypes.byref(info))
    if rc != 0:
        raise IOError(f"mrc_open({path}) failed: {rc}")
    idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64).reshape(-1))
    out = np.empty((len(idx), info.ny, info.nx), dtype=np.float32)
    rc = lib.mrc_read_slices(path.encode(),
                             idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(idx),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             1 if shift else 0, n_threads)
    if rc != 0:
        raise IOError(f"mrc_read_slices({path}) failed: {rc}")
    return out
