"""Candidate designs of HK1 ``project_slices``, HK3 ``insert_trilinear``,
HK4 ``shell_sums`` and HK5 ``project_slices_2d`` timed in turns on the
card, at the main paths' shapes.

    python -m thunder_tpu_torch.micro.hk_candidates [--kernels hk4,hk5] [--big] [--reps N]

Builds ``micro/cand/hk1_cand.cu`` and ``hk3_cand.cu``, or ``hk4_cand.cu``
and ``hk5_cand.cu`` (the designs that were measured before the kernels
in ``csrc/`` were chosen; they are not part of the kernel library),
checks every variant against the plain version, and times the variants
one after another, forwards then backwards, with CUDA events.  ``--big``
adds HK1's and HK3's shapes of a 256 px box at its global radius, where
the tables no longer fit the L2 cache.  Prints one line per variant and
shape and a last JSON line; needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import generator
from thunder_tpu_torch.geometry.quaternion import random_quat, rotate2d_from_unit, rotate3d
from thunder_tpu_torch.ops import insert, projector
from thunder_tpu_torch.ops.fourier import pack_rings
from thunder_tpu_torch.optimiser import proj_crop_size, reco_grid_size
from thunder_tpu_torch.physics import spectrum
from thunder_tpu_torch.physics.ctf import ctf_params

CAND_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cand")
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

HK1_VARIANTS = {0: "flat, 8 loads (first design)", 1: "flat, paired loads",
                2: "block a slice, 8 loads", 3: "block a slice, paired loads",
                4: "flat, (y, x) quads"}
HK3_VARIANTS = {0: "dense, scalar atomics (first design)", 1: "dense, float2 atomics",
                2: "dense, float4 scratch", 3: "image, tables, scalar",
                4: "image, tables, float2", 5: "image, tables, float4 scratch",
                6: "image, sincosf, float2", 7: "image, sincosf, float4 scratch",
                8: "dense over the in-disc list, float4 scratch",
                9: "dense, a lane pair a sample (x0 | x1), float4 scratch"}
HK4_VARIANTS = {0: "block histogram, an atomic a cell (first design)",
                1: "warp histograms, an atomic a cell",
                2: "row form: runs summed in registers, warp histograms",
                3: "row form, 16-byte loads (a lane on 4 cells)",
                4: "coordinate form, 4 load steps in flight",
                5: "coordinate form, 1 load step", 6: "coordinate form, 2 load steps",
                7: "row form, 16-byte loads, a lane's own runs summed first",
                8: "as 7, 2 load steps in flight", 9: "as 3, 2 load steps in flight"}
HK5_VARIANTS = {0: "flat, 64-bit index, 4 taps, 8-byte store (first design)",
                1: "walk the rotations, plain plane, 1 pixel a thread",
                2: "walk, plain plane, 2 pixels, 16-byte store",
                3: "walk, quads, 1 pixel", 4: "walk, quads, 2 pixels",
                5: "quads, 2 pixels, one rotation a thread",
                6: "walk, plain plane, 4 pixels", 7: "walk, quads, 4 pixels",
                8: "as 2, streaming stores", 9: "as 4, streaming stores",
                10: "as 1, streaming stores"}


def say(msg: str) -> None:
    print(msg, flush=True)


def build() -> ctypes.CDLL:
    """nvcc both candidate sources into one library; the vector atomics
    of hk3_cand.cu are tried as the CUDA intrinsic first, then as two
    spellings of the PTX instruction."""
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    nvcc = _native._nvcc()
    out = os.path.join(_native.BUILD_DIR, "libhk_candidates.so")
    srcs = [os.path.join(CAND_DIR, s) for s in ("hk1_cand.cu", "hk3_cand.cu")]
    for vec in (0, 1, 2):
        cmd = [nvcc, *_native.NVCC_FLAGS, f"-DVEC_PTX={vec}", "-shared", "-o", out, *srcs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        say(f"build VEC_PTX={vec}: rc {res.returncode}")
        for line in (res.stdout + res.stderr).splitlines():
            if res.returncode != 0 or "registers" in line or "spill" in line:
                say("  " + line.strip()[:200])
        if res.returncode == 0:
            break
    else:
        raise RuntimeError("the candidates did not build")
    lib = ctypes.CDLL(out)
    lib.cand_project_slices.argtypes = [_I, _P, _I, _P, _P, _L, _I, _I, _P, _P, _I, _I, _P, _P]
    lib.cand_project_slices_tex.argtypes = [_P, _I, _I, _P, _P, _L, _I, _I, _P, _P, _I, _I, _P,
                                            _I, _P, _P]
    lib.cand_insert_trilinear.argtypes = [_I, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I,
                                          _I, _F, _F, _F, _P, _P, _P, _I, _P]
    return lib


def build_45() -> ctypes.CDLL:
    """nvcc the HK4 and HK5 candidate sources into one library."""
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, "libhk45_candidates.so")
    srcs = [os.path.join(CAND_DIR, s) for s in ("hk4_cand.cu", "hk5_cand.cu")]
    res = subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", out, *srcs],
                         capture_output=True, text=True)
    say(f"build hk4_cand.cu hk5_cand.cu: rc {res.returncode}")
    for line in (res.stdout + res.stderr).splitlines():
        if res.returncode != 0 or "registers" in line or "spill" in line:
            say("  " + line.strip()[:200])
    if res.returncode != 0:
        raise RuntimeError("the HK4 / HK5 candidates did not build")
    lib = ctypes.CDLL(out)
    lib.cand_shell_sums.argtypes = [_I, _P, _L, _I, _I, _L, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    lib.cand_project_slices_2d.argtypes = [_I, _P, _I, _P, _P, _L, _I, _I, _P, _P, _I, _I, _P, _P]
    return lib


def timed(fn, reps: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def turns(fns: dict, reps: int) -> dict:
    """Each function timed forwards then backwards: name -> [ms, ms]."""
    out = {k: [] for k in fns}
    for keys in (list(fns), list(fns)[::-1]):
        for k in keys:
            out[k].append(timed(fns[k], reps))
    return out


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def pair_taps(table: torch.Tensor) -> torch.Tensor:
    """(K, n, n, n) complex64 -> (K, n, n, n, 4) float32 with cell x
    holding (t[x], t[min(x + 1, n - 1)])."""
    nxt = torch.cat([table[..., 1:], table[..., -1:]], -1)
    return torch.view_as_real(torch.stack([table, nxt], -1)).reshape(table.shape + (4,)).contiguous()


def hk1_shape(lib, dev, gen, name, size, r, n_l, n_r, shared, reps, results, spread=None):
    rings = pack_rings(size, r, 1, device=dev)
    n_p = rings.i_col.numel()
    crop = proj_crop_size(size, 2, r)
    n_k = 1 if shared else 2
    table = torch.randn(n_k, crop, crop, crop, dtype=torch.complex64, device=dev)
    paired, quads = pair_taps(table), projector.quad_taps(table)
    quats = random_quat(gen, (n_l, n_r), dev)
    if spread is not None:   # each image's rotations a cloud around one pose
        quats = quats[:, :1] + spread * torch.randn(n_l, n_r, 4, generator=gen, device=dev)
        quats = quats / quats.norm(dim=-1, keepdim=True)
    rot = rotate3d(quats).contiguous()
    cls = None if shared else (torch.arange(n_l, device=dev) // (n_l // n_k)).to(torch.int32)
    ref = projector.project_slices_plain(table, rot, rings.i_col, rings.i_row, 2, cls)
    out = torch.empty((n_l, n_r, n_p), dtype=torch.complex64, device=dev)
    st = _native.stream_ptr(table)
    cp = None if cls is None else cls.data_ptr()

    def run(v):
        tab = paired if v in (1, 3) else quads if v == 4 else table
        _native.check(lib.cand_project_slices(
            v, tab.data_ptr(), crop, cp, rot.data_ptr(), rot.stride(0), n_l, n_r,
            rings.i_col.data_ptr(), rings.i_row.data_ptr(), n_p, 2, out.data_ptr(), st),
            f"hk1 variant {v}")

    shape = f"{name}: L={n_l} R={n_r} P={n_p} crop={crop}^3 K={n_k}"
    errs = {}
    for v in HK1_VARIANTS:
        out.zero_()
        run(v)
        errs[v] = rel_err(out, ref)
    fns = {"csrc plain": lambda: projector.project_slices(table, rot, rings.i_col, rings.i_row,
                                                          2, cls),
           "csrc quad": lambda: projector.project_slices(quads, rot, rings.i_col,
                                                         rings.i_row, 2, cls)}
    raw = _native.library().thunder_project_slices    # the same kernels, no wrapper
    for key, tab, quad in (("raw plain", table, 0), ("raw quad", quads, 1)):
        fns[key] = lambda tab=tab, quad=quad: _native.check(raw(
            tab.data_ptr(), quad, crop, cp, rot.data_ptr(), rot.stride(0), n_l, n_r,
            rings.i_col.data_ptr(), rings.i_row.data_ptr(), n_p, 2, out.data_ptr(), st), "raw")
    fns.update({f"v{v}": (lambda v=v: run(v)) for v in HK1_VARIANTS})
    fns["pair_taps"] = lambda: pair_taps(table)
    fns["quad_taps"] = lambda: projector.quad_taps(table)
    ms = turns(fns, reps)
    tex_ms = (ctypes.c_float * 2)()
    out.zero_()
    _native.check(lib.cand_project_slices_tex(
        table.data_ptr(), crop, n_k, cp, rot.data_ptr(), rot.stride(0), n_l, n_r,
        rings.i_col.data_ptr(), rings.i_row.data_ptr(), n_p, 2, out.data_ptr(), reps, tex_ms,
        st), "hk1 texture")
    torch.cuda.synchronize()
    errs["tex"] = rel_err(out, ref)
    say(f"HK1 {shape}")
    for k, v in ms.items():
        label = HK1_VARIANTS.get(int(k[1:])) if k[0] == "v" else ""
        err = errs.get(int(k[1:])) if k[0] == "v" else None
        say(f"  {k:<11s} {v[0]:.4f} {v[1]:.4f} ms  rel_err {err}  {label}")
    say(f"  texture     {tex_ms[1]:.4f} ms a launch, {tex_ms[0]:.4f} ms the copy into the "
        f"array  rel_err {errs['tex']}")
    bad = {k: e for k, e in errs.items() if not e <= 1e-5}
    results.append(dict(kernel="HK1", shape=shape, ms=ms, rel_err={str(k): e for k, e in
                                                                   errs.items()},
                        texture_ms=tex_ms[1], texture_copy_ms=tex_ms[0]))
    if bad:
        raise SystemExit(f"HK1 {shape}: variants disagree with the plain version: {bad}")


def hk1_sweep(dev, gen, reps, results):
    """csrc/project_slices.cu from the plain cube and from the quad
    table over growing tables (two classes, 256 images x 125 rotations):
    where the quad table stops paying."""
    say("HK1 plain cube against quad table, K=2 L=256 R=125:")
    for r in (22, 27, 31, 37, 43):
        rings = pack_rings(256, r, 1, device=dev)
        crop = proj_crop_size(256, 2, r)
        table = torch.randn(2, crop, crop, crop, dtype=torch.complex64, device=dev)
        quads = projector.quad_taps(table)
        rot = rotate3d(random_quat(gen, (256, 125), dev))
        cls = torch.arange(256, device=dev) // 128
        args = (rot, rings.i_col, rings.i_row, 2, cls)
        ms = turns({"plain": lambda: projector.project_slices(table, *args),
                    "quad": lambda: projector.project_slices(quads, *args)}, reps)
        mb = quads.numel() * 4 / 2 ** 20
        say(f"  r={r} crop={crop} P={rings.i_col.numel()} quad table {mb:.0f} MiB: plain "
            f"{ms['plain'][0]:.4f} {ms['plain'][1]:.4f} ms, quad {ms['quad'][0]:.4f} "
            f"{ms['quad'][1]:.4f} ms")
        results.append(dict(kernel="HK1", shape=f"sweep r={r} crop={crop}", quad_mib=mb, ms=ms))
        del table, quads


def hk3_shape(lib, dev, gen, rng, name, size, r_u, n_l, slots, reps, results, variants):
    big = reco_grid_size(size, r_u) * 2
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_l, size, size, device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    defocus = rng.uniform(8000, 20000, n_l)
    ctf = ctf_params(np.full(n_l, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, n_l),
                     np.full(n_l, 2e7), np.full(n_l, 0.1), np.zeros(n_l), device=dev)
    n_s = n_l * slots
    img_idx = (torch.arange(n_s, device=dev) // slots).to(torch.int32)
    rot = rotate3d(random_quat(gen, (n_s,), dev)).reshape(n_s, 9).contiguous()
    trans = (3 * torch.randn(n_s, 2, device=dev)).contiguous()
    w = (torch.rand(n_s, device=dev) / slots).contiguous()
    ctfk = insert.ctf_constants(ctf)
    px = insert.in_disc_pixels(r_u, dev)
    st = _native.stream_ptr(ft)
    zero = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)

    def run(v):
        f, t = zero(big, big, big, dt=torch.complex64), zero(big, big, big)
        g = zero(big ** 3, 4) if v in (2, 5, 7, 8, 9) else None
        if 3 <= v <= 7:   # the work plan is part of the call
            idx = torch.sort(img_idx, stable=True)
            order = idx.indices.to(torch.int32)
            starts = torch.searchsorted(idx.values, torch.arange(
                n_l + 1, device=dev, dtype=torch.int32)).to(torch.int32)
        else:
            order, starts = img_idx, img_idx
        _native.check(lib.cand_insert_trilinear(
            v, ft.data_ptr(), size, ctfk.data_ptr(), order.data_ptr(), starts.data_ptr(), n_l,
            rot.data_ptr(), trans.data_ptr(), w.data_ptr(), n_s, px.data_ptr(), px.numel(),
            r_u, 2, float((r_u - 1) * 2), float(1.32 * size), float(2 * np.pi / size),
            f.data_ptr(), t.data_ptr(), None if g is None else g.data_ptr(), big, st),
            f"hk3 variant {v}")
        return f, t

    fp, tp = insert.insert_trilinear_plain(
        ft, ctf, img_idx, rot.reshape(n_s, 3, 3), trans, w, r_u, 2, size, 1.32,
        zero(big, big, big, dt=torch.complex64), zero(big, big, big))
    shape = f"{name}: slices={n_s} r_u={r_u} big={big}^3 npx={px.numel()}"
    errs = {}
    for v in variants:
        f, t = run(v)
        errs[v] = max(rel_err(torch.view_as_real(f), torch.view_as_real(fp)), rel_err(t, tp))
    del fp, tp, f, t
    fns = {"csrc": lambda: insert.insert_trilinear(
        ft, ctf, img_idx, rot.reshape(n_s, 3, 3), trans, w, r_u, 2, size, 1.32, big)}
    fns.update({f"v{v}": (lambda v=v: run(v)) for v in variants})
    ms = turns(fns, reps)
    say(f"HK3 {shape}")
    for k, v in ms.items():
        label = HK3_VARIANTS.get(int(k[1:])) if k[0] == "v" else ""
        err = errs.get(int(k[1:])) if k[0] == "v" else None
        say(f"  {k:<11s} {v[0]:.4f} {v[1]:.4f} ms  rel_err {err}  {label}")
    results.append(dict(kernel="HK3", shape=shape, ms=ms,
                        rel_err={str(k): e for k, e in errs.items()}))
    bad = {k: e for k, e in errs.items() if not e <= 1e-4}
    if bad:
        raise SystemExit(f"HK3 {shape}: variants disagree with the plain version: {bad}")


def report(kernel, shape, ms, errs, labels, tol, results, **extra):
    say(f"{kernel} {shape}")
    for k, v in ms.items():
        say(f"  {k:<18s} {v[0]:.4f} {v[1]:.4f} ms  rel_err {errs.get(k)}  {labels.get(k, '')}")
    results.append(dict(kernel=kernel, shape=shape, ms=ms, rel_err=errs, **extra))
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        raise SystemExit(f"{kernel} {shape}: variants disagree with the plain version: {bad}")


def hk4_shape(lib, dev, name, n_b, n_c, n_sh, reps, results, grid=None, rings=None):
    """HK4 at one shape: a centered full grid (``grid`` = (size, nd),
    half-space weight) or packed rings (``rings``, no weight)."""
    if grid is not None:
        size, nd = grid
        shell, weight = spectrum.shell_geometry(size, nd, dev)
    else:
        size, nd = 0, 0
        shell, weight = torch.clamp(rings.i_sig, max=n_sh - 1), None
    n = shell.numel()
    v = torch.randn(n_b, n_c, n, device=dev) ** 2
    ref = spectrum.shell_sums_plain(v, shell, n_sh, weight)
    st = _native.stream_ptr(v)
    plan = spectrum.shell_sums_plan(n_b, n)
    out = torch.empty(n_b, n_c, n_sh, device=dev)

    def run(variant, chunks=plan):
        out.zero_()
        _native.check(lib.cand_shell_sums(
            variant, v.data_ptr(), v.stride(0), n_b, n_c, n, shell.data_ptr(),
            None if weight is None else weight.data_ptr(), n_sh, chunks, size, nd, 1,
            out.data_ptr(), st), f"hk4 variant {variant}")
        return out

    fns, labels = {}, {}
    for k in (0, 1, 2, 3, 7, 8, 9) + ((4, 5, 6) if grid is not None else ()):
        fns[f"v{k}"], labels[f"v{k}"] = (lambda k=k: run(k)), HK4_VARIANTS[k]
    if grid is None:
        for ch in (1, 2, 4, 8):
            fns[f"v7 chunks={ch}"] = lambda ch=ch: run(7, ch)
            labels[f"v7 chunks={ch}"] = f"v7, {ch} pieces an image (the plan says {plan})"
        fns["csrc"] = lambda: spectrum.shell_sums(v, shell, n_sh)
        labels["csrc"] = "spectrum.shell_sums, the wrapper"
    else:
        fns["csrc arrays"] = lambda: spectrum.shell_sums(v, shell, n_sh, weight)
        fns["csrc grid"] = lambda: spectrum.shell_sums_grid(v, size, nd, n_sh)
        labels["csrc arrays"] = "spectrum.shell_sums (row form on the whole grid)"
        labels["csrc grid"] = "spectrum.shell_sums_grid, the wrapper"
    errs = {k: rel_err(fn().clone(), ref) for k, fn in fns.items()}
    fns["zero_"] = lambda: out.zero_()
    labels["zero_"] = "the zero fill every variant above includes"
    if grid is not None and n_c == 3:
        a = torch.randn(n_b, n, dtype=torch.complex64, device=dev)
        b = a + 0.5 * torch.randn(n_b, n, dtype=torch.complex64, device=dev)
        stack = lambda: torch.stack([(a * b.conj()).real, a.abs() ** 2, b.abs() ** 2], dim=1)
        fns["stack + grid"] = lambda: spectrum.shell_sums_grid(stack(), size, nd, n_sh)
        fns["pair"] = lambda: spectrum.fsc_sums(a, b, size, nd, n_sh)
        labels["stack + grid"] = "three fields stacked in torch, then the coordinate form"
        labels["pair"] = "spectrum.fsc_sums: the products formed in the kernel"
        errs["pair"] = rel_err(fns["pair"](), spectrum.fsc_sums_plain(a, b, size, nd, n_sh))
    shape = f"{name}: B={n_b} C={n_c} N={n} shells={n_sh}"
    report("HK4", shape, turns(fns, reps), errs, labels, 1e-4, results, plan=plan)


def hk5_shape(lib, dev, gen, name, r, n_l, n_r, shared, reps, results, lane=8, r_l=1, n_k=60):
    size = 160
    rings = pack_rings(size, r, r_l, lane=lane, device=dev)
    n_p = rings.i_col.numel()
    crop = proj_crop_size(size, 2, r)
    table = torch.randn(n_k, crop, crop, dtype=torch.complex64, device=dev)
    quads = projector.quad_taps(table)
    phi = torch.rand((1 if shared else n_l, n_r), generator=gen, device=dev) * (2 * np.pi)
    rot = rotate2d_from_unit(torch.stack([torch.cos(phi), torch.sin(phi)], -1)).contiguous()
    if shared:
        rot = rot.expand(n_l, n_r, 2, 2)
        cls = torch.arange(n_l, device=dev, dtype=torch.int32)
    else:
        cls = torch.randint(0, n_k, (n_l,), generator=gen, device=dev).to(torch.int32)
    args = (rot, rings.i_col, rings.i_row, 2, cls)
    ref = projector.project_slices_2d_plain(table, *args)
    out = torch.empty((n_l, n_r, n_p), dtype=torch.complex64, device=dev)
    st = _native.stream_ptr(table)

    def run(variant):
        tab = quads if variant in (3, 4, 5, 7, 9) else table
        _native.check(lib.cand_project_slices_2d(
            variant, tab.data_ptr(), crop, cls.data_ptr(), rot.data_ptr(), rot.stride(0), n_l,
            n_r, rings.i_col.data_ptr(), rings.i_row.data_ptr(), n_p, 2, out.data_ptr(), st),
            f"hk5 variant {variant}")
        return out

    fns = {f"v{k}": (lambda k=k: run(k)) for k in HK5_VARIANTS}
    labels = {f"v{k}": label for k, label in HK5_VARIANTS.items()}
    fns["csrc"] = lambda: projector.project_slices_2d(table, *args)
    labels["csrc"] = "projector.project_slices_2d, the wrapper"
    errs = {}
    for k, fn in fns.items():
        out.zero_()
        errs[k] = rel_err(fn(), ref)
    fns["quad_taps"] = lambda: projector.quad_taps(table)
    labels["quad_taps"] = "building the quad table (once a table a round)"
    shape = (f"{name}: L={n_l} R={n_r}{' shared' if shared else ''} r={r} P={n_p} "
             f"crop={crop}^2 K={n_k}")
    report("HK5", shape, turns(fns, reps), errs, labels, 1e-5, results)


def main_45(dev, gen, reps, results):
    lib = build_45()
    _native.library()
    hk4_shape(lib, dev, "FSC 128 px", 1, 3, 62, reps, results, grid=(128, 3))
    hk4_shape(lib, dev, "FRC 160 px", 30, 3, 78, reps, results, grid=(160, 2))
    hk4_shape(lib, dev, "preprocess spectrum 160 px", 1, 1, 78, reps, results, grid=(160, 2))
    for n_c in (3, 1):
        hk4_shape(lib, dev, "sigma 3D, r_u 36", 512, n_c, 63, reps, results,
                  rings=pack_rings(128, 36, 0, lane=512, device=dev))
        hk4_shape(lib, dev, "sigma 2D, r_u 31", 20000, n_c, 79, reps, results,
                  rings=pack_rings(160, 31, 0, lane=512, device=dev))
    hk4_shape(lib, dev, "sigma 2D, the band above r_u", 20000, 1, 79, reps, results,
              rings=pack_rings(160, 78, 31, lane=512, device=dev))
    hk4_shape(lib, dev, "sigma count", 1, 1, 79, reps, results,
              rings=pack_rings(160, 31, 0, lane=512, device=dev))
    hk5_shape(lib, dev, gen, "phase", 5, 10000, 9, False, reps, results)
    hk5_shape(lib, dev, gen, "phase", 15, 10000, 9, False, reps, results)
    hk5_shape(lib, dev, gen, "global", 5, 30, 100, True, reps, results)
    hk5_shape(lib, dev, gen, "global", 15, 30, 100, True, reps, results)
    hk5_shape(lib, dev, gen, "sigma", 31, 20000, 1, False, reps, results, lane=512, r_l=0)
    # what the taps cost: the same launches with every image on one plane
    hk5_shape(lib, dev, gen, "sigma, one class", 31, 20000, 1, False, reps, results, lane=512,
              r_l=0, n_k=1)
    hk5_shape(lib, dev, gen, "phase, one class", 15, 10000, 9, False, reps, results, n_k=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--big", action="store_true", help="add the 256 px shapes")
    ap.add_argument("--kernels", default="hk1,hk3",
                    help="hk1,hk3 (the default) and / or hk4,hk5")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hk_candidates: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi unavailable"
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    say(subprocess.run([_native._nvcc(), "--version"], capture_output=True,
                       text=True).stdout.strip().splitlines()[-2])
    gen = generator(0, dev)
    rng = np.random.default_rng(0)
    results = []
    if "hk4" in args.kernels or "hk5" in args.kernels:
        main_45(dev, gen, args.reps, results)
    if "hk1" in args.kernels or "hk3" in args.kernels:
        main_13(dev, gen, rng, args, results)
    line = json.dumps({"card": card, "results": results})
    say(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


def main_13(dev, gen, rng, args, results):
    lib = build()
    hk1_shape(lib, dev, gen, "phase 128 px", 128, 22, 256, 125, False, args.reps, results)
    hk1_shape(lib, dev, gen, "phase 128 px, each image's rotations within ~3 degrees", 128, 22,
              256, 125, False, args.reps, results, spread=0.03)
    hk1_shape(lib, dev, gen, "global 128 px", 128, 22, 1, 256, True, 50, results)
    hk3_shape(lib, dev, gen, rng, "128 px", 128, 36, 128, 48, args.reps, results,
              list(HK3_VARIANTS))
    if args.big:
        hk1_sweep(dev, gen, args.reps, results)
        hk1_shape(lib, dev, gen, "phase 256 px", 256, 43, 256, 125, False, args.reps, results)
        hk3_shape(lib, dev, gen, rng, "256 px", 256, 85, 128, 48, max(2, args.reps // 3),
                  results, list(HK3_VARIANTS))


if __name__ == "__main__":
    sys.exit(main())
