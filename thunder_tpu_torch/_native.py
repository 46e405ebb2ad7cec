"""Build and load the port's hand-written Hopper kernels.

The CUDA sources under ``csrc/`` expose a plain C interface; they are
compiled with ``nvcc`` for ``sm_90a`` into ONE shared library and bound
with ``ctypes`` (no PyTorch headers, so a build takes seconds).

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
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("project_slices.cu", "likelihood_block.cu",
           "insert_trilinear.cu", "shell_sums.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "thunder_project_slices": [_P, _I, _P, _P, _L, _I, _I, _P, _P, _I, _I,
                               _P, _P],
    "thunder_likelihood_block": [_P, _P, _L, _L, _P, _L, _L, _L, _P, _L, _L,
                                 _P, _L, _L, _I, _I, _I, _P, _P, _P, _L, _I,
                                 _P, _P],
    "thunder_insert_trilinear": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                                 _F, _F, _P, _P, _I, _P],
    "thunder_shell_sums": [_P, _L, _I, _I, _L, _P, _P, _I, _P, _P],
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
    missing; returns its path.  The compiler's report (registers, shared
    memory, spills from ``-Xptxas -v``) is kept in ``_build/build.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[os.path.join(SRC_DIR, s) for s in SOURCES]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    return path


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
