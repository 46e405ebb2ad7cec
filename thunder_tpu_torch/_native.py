"""Build and load the port's hand-written Hopper kernels.

The CUDA sources under ``csrc/`` expose a plain C interface; each is
compiled by its own ``nvcc`` for ``sm_90a`` (all started together), the
objects are linked into ONE shared library, and it is bound with
``ctypes`` (no PyTorch headers, so a build takes seconds).

* The build runs at first use, never at import, into
  ``thunder_tpu_torch/_build/`` (git-ignored).  The library's file name
  carries a hash of the sources and flags, so an edited source is
  rebuilt and a stale library is never loaded.
* Every C entry point launches on the stream it is given (PyTorch's
  current stream), does not synchronise, allocates nothing, and returns
  ``cudaGetLastError()``; :func:`check` raises on a non-zero code.
* Each wrapper counts its launches in a plain int attribute,
  ``wrapper.launches``, incremented where the kernel is launched and
  nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("project_slices.cu", "likelihood_block.cu",
           "insert_trilinear.cu", "shell_sums.cu", "project_slices_2d.cu",
           "insert_bilinear_2d.cu", "symmetrize_ft.cu",
           "likelihood_local_ctf.cu", "gather.cu", "launch_floor.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SMEM_MAX = 227 * 1024   # shared memory one block can use on Hopper (232,448 B)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "thunder_project_slices": [_P, _I, _I, _P, _P, _L, _I, _I, _P, _P, _I,
                               _I, _P, _P],
    "thunder_likelihood_block": [_P, _I, _I, _I, _I, _P],
    "thunder_insert_trilinear": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                                 _F, _F, _P, _P, _P, _I, _I, _I, _P],
    "thunder_shell_sums": [_P, _L, _I, _I, _L, _P, _P, _I, _I, _P, _P, _P],
    "thunder_shell_sums_grid": [_P, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "thunder_fsc_sums_grid": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "thunder_project_slices_2d": [_P, _I, _P, _P, _L, _I, _I, _P, _P, _I,
                                  _I, _P, _P],
    "thunder_insert_bilinear_2d": [_P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I,
                                   _F, _F, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _P],
    "thunder_symmetrize_ft": [_P, _I, _I, _I, _P],
    "thunder_likelihood_local_ctf": [_P, _I, _I, _P],
    "thunder_take_flat": [_P, _L, _P, _L, _P, _P],
    "thunder_take_along": [_P, _I, _P, _P, _L, _I, _I, _P, _P],
    "thunder_take_rows": [_P, _I, _I, _P, _L, _P, _P],
    "thunder_empty_launch": [_P],
    "thunder_insert_trilinear_slab": [_P, _P, _P, _I, _I, _I, _F, _P, _I, _P, _P, _I,
                                      _I, _I, _I, _I, _I, _P],
    "thunder_insert_mkb": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P,
                           _P, _I, _I, _I, _F, _F, _F, _F, _P],
}

_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Hopper kernels are built with "
                       "the CUDA toolkit's nvcc (set NVCC or CUDA_HOME)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libthunder_kernels_{source_hash()}.so")


def build() -> str:
    """Compile the kernels if the library for the current sources is
    missing; returns its path.  One ``nvcc -c`` per source, all running
    at once, then one link.  The compiler's report (registers, shared
    memory, spills from ``-Xptxas -v``) is kept in ``_build/build.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}.{tag}.o")
            for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(SRC_DIR, s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    results = [(c, p.returncode, out, err)
               for c, p, (out, err) in zip(cmds, procs, outs)]
    tmp = f"{path}.{tag}"
    link = [nvcc, "-shared", "-o", tmp, *objs]
    if all(rc == 0 for _, rc, _, _ in results):
        res = subprocess.run(link, capture_output=True, text=True)
        results.append((link, res.returncode, res.stdout, res.stderr))
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        for cmd, _, out, err in results:
            f.write(" ".join(cmd) + "\n" + out + err)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [(c, rc, err) for c, rc, _, err in results if rc != 0]
    if failed:
        c, rc, err = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}) on {c[-1]}:\n{err}")
    os.replace(tmp, path)
    return path


def csrc_constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in ``csrc/<source>``:
    the launch plans size shared memory from the kernels' compile-time
    constants as the source they are built from states them."""
    with open(os.path.join(SRC_DIR, source)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    if m is None:
        raise RuntimeError(f"csrc/{source} defines no constexpr int {name}")
    return int(m.group(1))


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
