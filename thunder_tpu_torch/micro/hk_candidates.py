"""Candidate designs of HK1 ``project_slices``, HK3 ``insert_trilinear``,
HK4 ``shell_sums``, HK5 ``project_slices_2d``, HK7 ``symmetrize_ft``, HK8
``likelihood_local_ctf``, HK10 ``insert_mkb``, HK13 ``project_brick`` and
the gathers G1-G4 timed in turns on the card, at the main paths' shapes.

    python -m thunder_tpu_torch.micro.hk_candidates [--kernels hk4,hk5|hk7,hk8|hk10|hk13|gather] [--big] [--reps N]
    python -m thunder_tpu_torch.micro.hk_candidates --lanes [--bricks N]

Builds ``micro/cand/hk1_cand.cu`` and ``hk3_cand.cu``, ``hk4_cand.cu``
and ``hk5_cand.cu``, ``hk7_cand.cu`` and ``hk8_cand.cu``,
``hk10_cand.cu``, ``hk13_cand.cu`` or ``gather_cand.cu`` (the designs that
were measured before the kernels in
``csrc/`` were chosen, and instances of those kernels; they are not part
of the kernel library),
checks every variant against the plain version, and times the variants
one after another, forwards then backwards, with CUDA events.  ``--big``
adds HK1's and HK3's shapes of a 256 px box at its global radius, where
the tables no longer fit the L2 cache.  HK10's instances print their
registers and local (spilled) bytes a thread.  Prints one line per
variant and shape and a last JSON line; needs a CUDA device and nvcc.
``gather`` times G1-G4's first designs (``gather_cand.cu``) beside each
form of csrc/gather.cu at micro/gather.py's cases, alone (replayed CUDA
graphs) in turns, and G2's and G4's forms across batches (G2 also on a
table of 128 rows) around ``ops/gather.py STRIP_MIN_OUTPUTS``.
``--lanes`` needs neither: it counts, from the shapes alone, how busy
HK10's lanes are and how many samples its warps take at its two shapes
(random rotations, ``--bricks`` bricks inside the radius and the
central one).
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import generator
from thunder_tpu_torch.geometry.quaternion import random_quat, rotate2d_from_unit, rotate3d
from thunder_tpu_torch.ops import brick, insert, projector
from thunder_tpu_torch.ops.fourier import pack_rings
from thunder_tpu_torch.optimiser import BRICK_LADDER, proj_crop_size, reco_grid_size
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
HK10_VARIANTS = {0: "the gather (HK10's earlier design), closed-form weight",
                 1: "the gather, weight 1 inside the ball",
                 2: "the gather, __launch_bounds__(512, 1)",
                 3: "the gather, the weight's series",
                 4: "brick scatter, series, 8^3 bricks, three blocks an SM (the path)",
                 5: "brick scatter, closed-form weight",
                 6: "brick scatter, series, 8 x 8 x 4 bricks",
                 7: "brick scatter, weight 1 inside the ball",
                 8: "brick scatter, series, __launch_bounds__(256, 2)"}
HK5_VARIANTS = {0: "flat, 64-bit index, 4 taps, 8-byte store (first design)",
                1: "walk the rotations, plain plane, 1 pixel a thread",
                2: "walk, plain plane, 2 pixels, 16-byte store",
                3: "walk, quads, 1 pixel", 4: "walk, quads, 2 pixels",
                5: "quads, 2 pixels, one rotation a thread",
                6: "walk, plain plane, 4 pixels", 7: "walk, quads, 4 pixels",
                8: "as 2, streaming stores", 9: "as 4, streaming stores",
                10: "as 1, streaming stores"}
HK13_VARIANTS = {0: "walk, 128 px a block, a tap a cell (first design)",
                 1: "as 0, no load", 2: "walk, 128 px a block, quads",
                 3: "as 2, two samples in flight", 4: "32 px x 4 warps, quads (csrc)",
                 5: "32 px x 4 warps, quads, two samples in flight",
                 6: "32 px x 8 warps, quads", 7: "32 px x 2 warps, quads, two in flight",
                 8: "as 4, no load", 9: "as 4, plain cube",
                 10: "one thread a sample, quads",
                 11: "windows staged in shared memory (cp.async), plain cube"}
# the variants that read the plain cube, and those that load nothing
HK13_PLAIN, HK13_NO_LOAD = (9, 11), (1, 8)


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
        say(f"  {k:<18s} {' '.join(f'{x:.4f}' for x in v)} ms  rel_err {errs.get(k)}  "
            f"{labels.get(k, '')}")
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


def build_10() -> ctypes.CDLL:
    """nvcc the HK10 instances (micro/cand/hk10_cand.cu, which includes
    csrc/insert_mkb.cu)."""
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, "libhk10_candidates.so")
    src = os.path.join(CAND_DIR, "hk10_cand.cu")
    res = subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", out, src],
                         capture_output=True, text=True)
    say(f"build hk10_cand.cu: rc {res.returncode}")
    for line in (res.stdout + res.stderr).splitlines():
        if res.returncode != 0 or "registers" in line or "spill" in line or "error" in line:
            say("  " + line.strip()[:200])
    if res.returncode != 0:
        raise RuntimeError("the HK10 candidates did not build")
    lib = ctypes.CDLL(out)
    lib.cand_insert_mkb.argtypes = [_I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                                    _P, _P, _P, _I, _I, _I, _P, _I, _F, _F, _F, _P, _F, _F, _P]
    lib.cand_mkb_attrs.argtypes = [_I, _I, _F, _P]
    return lib


def build_13() -> ctypes.CDLL:
    """nvcc micro/cand/hk13_cand.cu (HK13's designs) into its own
    library."""
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, "libhk13_candidates.so")
    src = os.path.join(CAND_DIR, "hk13_cand.cu")
    res = subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", out, src],
                         capture_output=True, text=True)
    say(f"build hk13_cand.cu: rc {res.returncode}")
    for line in (res.stdout + res.stderr).splitlines():
        if res.returncode != 0 or "registers" in line or "spill" in line or "error" in line:
            say("  " + line.strip()[:200])
    if res.returncode != 0:
        raise RuntimeError("the HK13 candidates did not build")
    lib = ctypes.CDLL(out)
    lib.cand_project_brick.argtypes = [_I] + _native._SIGNATURES["thunder_project_brick"]
    return lib


def hk13_launch(lib, v: int, table, rot, mrot, i_col, i_row, pf: int, span: int, stride: int,
                cls, out) -> None:
    """HK13's variant ``v`` (HK13_VARIANTS) on the wrapper's operands
    (int32 pixels and classes, contiguous) into ``out``."""
    quad = projector.is_quad_table(table)
    n = table.shape[1]
    _, g, nz, nx = brick.brick_grid(span, stride, n)
    _native.check(lib.cand_project_brick(
        v, table.data_ptr(), 4 if quad else 1, n, None if cls is None else cls.data_ptr(),
        rot.data_ptr(), mrot.data_ptr(), rot.shape[0], rot.shape[1], i_col.data_ptr(),
        i_row.data_ptr(), i_col.numel(), pf, span, stride, g, nz, nx, out.data_ptr(),
        _native.stream_ptr(out)), f"hk13 variant {v}")


def hk13_inputs(dev, gen, span: int, stride: int, n_l: int = 256, n_r: int = 125,
                size: int = 160, r: int = 18, pushed: int = 4):
    """The 160 px local rounds' phase shape (chip_smoke.py phase 5d): two
    random classes of crop^3, each image's rotations a cloud within 0.4
    of the rung's margin, every ``pushed``-th rotation twelve times that
    (out of its window).  Returns (cube, quads, rot, mrot, i_col, i_row,
    cls), the pixels and classes int32."""
    rings = pack_rings(size, r, 1, device=dev)
    crop = proj_crop_size(size, 2, r)
    table = torch.randn(2, crop, crop, crop, dtype=torch.complex64, device=dev, generator=gen)
    dq = torch.full((1, n_r, 1), 0.4 * brick.spread_margin(span, stride) / (2 * 2 * r),
                    device=dev)
    dq[:, ::pushed] *= 12
    q = random_quat(gen, (n_l,), dev)[:, None] + dq * random_quat(gen, (n_l, n_r), dev)
    rot = rotate3d(q / q.norm(dim=-1, keepdim=True)).contiguous()
    cls = (torch.arange(n_l, device=dev) // (n_l // 2)).to(torch.int32)
    return (table, projector.quad_taps(table), rot, rot.mean(1).contiguous(),
            rings.i_col.to(torch.int32).contiguous(), rings.i_row.to(torch.int32).contiguous(),
            cls)


def main_hk13(dev, gen, reps, results):
    """HK13's designs in turns at the 5d shape on every rung, beside the
    library's HK13 (quad table and plain cube) and HK1 on the same (L, R,
    P) and quad table; each checked against the plain version (the
    load-free variants excepted)."""
    lib = build_13()
    for span, stride in BRICK_LADDER:
        table, quads, rot, mrot, i_col, i_row, cls = hk13_inputs(dev, gen, span, stride)
        tail = (rot, mrot, i_col, i_row, 2, span, stride, cls)
        ref = brick.project_brick_plain(table, *tail)
        out = torch.empty_like(ref)
        fns = {"csrc quad": lambda: brick.project_brick(quads, *tail),
               "csrc plain": lambda: brick.project_brick(table, *tail),
               "HK1 quad": lambda: projector.project_slices(quads, rot, i_col, i_row, 2, cls)}
        labels = {"csrc quad": "the library's HK13, quad table",
                  "csrc plain": "the library's HK13, plain cube",
                  "HK1 quad": "HK1 on the same (L, R, P) and quad table"}
        errs = {"csrc quad": rel_err(fns["csrc quad"](), ref),
                "csrc plain": rel_err(fns["csrc plain"](), ref)}
        for v, label in HK13_VARIANTS.items():
            tab = table if v in HK13_PLAIN else quads
            key = f"v{v}"
            fns[key] = lambda v=v, tab=tab: hk13_launch(lib, v, tab, *tail, out)
            labels[key] = label
            out.zero_()
            fns[key]()
            if v not in HK13_NO_LOAD:
                errs[key] = rel_err(out, ref)
        zero = float((ref == 0).float().mean())
        shape = (f"({span}, {stride}) L={rot.shape[0]} R={rot.shape[1]} P={i_col.numel()} "
                 f"crop={table.shape[1]}^3 K=2, {zero:.3f} of the samples outside their windows")
        report("HK13", shape, turns(fns, reps), errs, labels, 1e-5, results)
        del table, quads, ref, out


def hk10_shape(lib, dev, gen, rng, name, size, r_u, n_l, slots, reps, results, use_d=False):
    """HK10's instances on one hemisphere's compacted slices (n_l images x
    slots) at r_u: each against the plain version with float64 sums (1e-5
    of max |plain|, weight 1 not held), two calls' bits, registers and
    spills, then all in turns beside the kernel on the path (``csrc``)."""
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
    d = (1 + 0.03 * torch.randn(n_s, device=dev)).contiguous() if use_d else None
    ctfk = insert.ctf_constants(ctf)
    a, alpha = 1.9, 15.0
    a2, inv_a2, coef = insert.mkb_constants(a, alpha)
    inv_i0 = float(1.0 / np.i0(alpha))
    mrp = float((r_u - 1) * 2)
    vlo, vhi = insert.tap_range(big, mrp, "mkb")
    vals = torch.empty((n_s, (2 * r_u - 1) ** 2, 4), device=dev)
    st = _native.stream_ptr(ft)
    zero = lambda: (torch.zeros((big,) * 3, dtype=torch.complex64, device=dev),
                    torch.zeros((big,) * 3, device=dev))

    bricks = {bz: torch.as_tensor(insert._mkb_bricks(big, bz, mrp, a), device=dev)
              for bz in (8, 4)}

    def run(v):
        f, t = zero()
        order = bricks[4 if v == 6 else 8]
        _native.check(lib.cand_insert_mkb(
            v, ft.data_ptr(), size, ctfk.data_ptr(), img_idx.data_ptr(), rot.data_ptr(),
            trans.data_ptr(), w.data_ptr(), None if d is None else d.data_ptr(), n_s, r_u, 2,
            mrp, float(1.32 * size), float(2 * np.pi / size), f.data_ptr(), t.data_ptr(),
            vals.data_ptr(), big, vlo, vhi, order.data_ptr(), order.numel(), a, float(a2),
            float(inv_a2), coef.ctypes.data, alpha, inv_i0, st), f"hk10 variant {v}")
        return f, t

    args = (ft, ctf, img_idx, rot.reshape(n_s, 3, 3), trans, w, r_u, 2, size, 1.32)
    fp, tp = insert.insert_mkb_plain(*args, *zero(), d, f64_sums=True)
    shape = f"{name}: slices={n_s} r_u={r_u} big={big}^3"
    errs, same, attrs = {}, {}, {}
    out = (ctypes.c_int * 2)()
    for v in HK10_VARIANTS:
        f1, t1 = run(v)
        f2, t2 = run(v)
        same[f"v{v}"] = bool(torch.equal(f1, f2) and torch.equal(t1, t2))
        if v not in (1, 7):  # weight 1: not the function
            errs[f"v{v}"] = max(rel_err(torch.view_as_real(f1), torch.view_as_real(fp)),
                                rel_err(t1, tp))
        _native.check(lib.cand_mkb_attrs(v, 2, a, ctypes.addressof(out)), "cand_mkb_attrs")
        attrs[f"v{v}"] = dict(regs=int(out[0]), local_bytes=int(out[1]))
    del fp, tp, f1, t1, f2, t2
    regs, local = insert.insert_mkb_attrs()
    attrs["csrc"] = dict(regs=regs, local_bytes=local)
    fns = {"csrc": lambda: insert.insert_mkb(*args, big, d=d)}
    fns.update({f"v{v}": (lambda v=v: run(v)) for v in HK10_VARIANTS})
    ms = turns(fns, reps)
    labels = {f"v{v}": f"{lab}; {attrs[f'v{v}']['regs']} registers, "
                       f"{attrs[f'v{v}']['local_bytes']} local bytes"
              for v, lab in HK10_VARIANTS.items()}
    labels["csrc"] = f"the path's (csrc/insert_mkb.cu); {regs} registers, {local} local bytes"
    report("HK10", shape, ms, errs, labels, 1e-5, results, same_bits=same, attrs=attrs,
           share_of_v0={k: [x / y for x, y in zip(m, ms["v0"])] for k, m in ms.items()})
    if not all(same.values()):
        raise SystemExit(f"HK10 {shape}: two calls differ: {same}")


def hk10_lanes(n_bricks: int, seed: int = 0) -> list:
    """How busy HK10's lanes are and how its work spreads, counted from the
    shapes with ops/insert.py's emulation of its enumeration
    (_mkb_listed, _mkb_candidates): ``n_bricks`` bricks inside the radius,
    chosen at random, and the brick at the grid's centre, against 6144
    random planes, at both of chip_smoke.py's shapes, for bricks 8 (the
    path's) and 4 cells deep.  A warp queues the samples of its eighth of
    the brick's planes and takes them 32 a round (a lane a sample), then
    the taps that land, 32 a batch (a lane a tap)."""
    from thunder_tpu_torch.geometry.quaternion import random_quat as rq

    f32 = np.float32
    g = torch.Generator().manual_seed(seed)
    pick = np.random.default_rng(seed)
    a2 = f32(1.9 * 1.9)
    warps = insert.MKB_THREADS // 32
    out = []
    for (name, size, r_u), bz in itertools.product((("152^3", 128, 36), ("304^3", 160, 74)),
                                                  (insert.MKB_BZ, 4)):
        big = reco_grid_size(size, r_u) * 2
        cb, rr = big // 2, r_u - 1
        reach = f32(insert.mkb_reach(1.9))
        rot = rotate3d(rq(g, (6144,), torch.device("cpu"))).numpy().astype(np.float32)
        edge = np.array([insert.MKB_BXY, insert.MKB_BXY, bz])
        stats = dict(samples=0, rounds=0, taps=0, batches=0)
        centre_warp = 0
        for k in range(n_bricks + 1):
            if k == 0:
                lo = (cb - edge // 2) // edge * edge        # the brick holding the centre
            else:
                while True:
                    lo = pick.integers(0, big // edge) * edge
                    c = f32(0.5) * (2 * lo + edge - 1) - cb
                    if np.sqrt((c * c).sum()) < rr * 2 - 4:
                        break
            hi = lo + edge - 1
            c = (f32(0.5) * (lo + hi) - cb).astype(f32)
            e = f32(np.sqrt(((f32(0.5) * (hi - lo)) ** 2).sum()))
            elo, ehi = (lo - cb - reach).astype(f32), (hi - cb + reach).astype(f32)
            chunks = insert._mkb_listed(np.abs(rot[:, :, 2] @ c) < e + reach)
            for w in range(warps):
                mine = [s for ch in chunks for s in ch[len(ch) * w // warps:len(ch) * (w + 1) // warps]]
                queue = [(s, vc, vr) for s in mine for vc, vr in insert._mkb_candidates(
                    rot[s][:, 0], rot[s][:, 1], elo, ehi, rr, 2)]
                if k == 0:
                    centre_warp = max(centre_warp, len(queue))
                    continue
                stats["samples"] += len(queue)
                if not queue:
                    continue
                q = np.array(queue)
                pos = np.einsum("nij,nj->ni", rot[q[:, 0]][:, :, :2],
                                2 * q[:, 1:].astype(np.float32))
                t = np.floor(pos)[:, :, None] - 1 + np.arange(4)
                inp = (t + cb >= lo[None, :, None]) & (t + cb <= hi[None, :, None])
                sq = (t - pos[:, :, None]) ** 2
                d2 = sq[:, 0, None, None, :] + sq[:, 1, None, :, None] + sq[:, 2, :, None, None]
                land = (inp[:, 2, :, None, None] & inp[:, 1, None, :, None]
                        & inp[:, 0, None, None, :] & (d2 < a2)
                        & ((pos ** 2).sum(1) < (2 * rr) ** 2)[:, None, None, None])
                per = land.reshape(len(q), -1).sum(1)
                for r0 in range(0, len(q), 32):
                    n_t = int(per[r0:r0 + 32].sum())
                    stats["rounds"] += 1
                    stats["taps"] += n_t
                    stats["batches"] += -(-n_t // 32)
        n_s = stats["samples"]
        out.append(dict(shape=name, brick_depth=bz, bricks=n_bricks, **stats,
                        lanes_busy_samples=n_s / max(stats["rounds"], 1),
                        lanes_busy_taps=stats["taps"] / max(stats["batches"], 1),
                        centre_brick_samples_a_warp=centre_warp,
                        mean_samples_a_warp=n_s / (n_bricks * warps)))
        say(f"HK10 at {name}, 8 x 8 x {bz} bricks: {n_s / max(stats['rounds'], 1):.1f} of 32 "
            f"lanes busy a sample round, {stats['taps'] / max(stats['batches'], 1):.1f} a tap "
            f"batch, {stats['taps'] / max(n_s, 1):.1f} taps land a sample formed; samples a "
            f"warp {n_s / (n_bricks * warps):.0f} on average, {centre_warp} at the centre")
    return out


def build_78() -> ctypes.CDLL:
    """nvcc the first designs of HK7 and HK8 into one library."""
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, "libhk78_candidates.so")
    srcs = [os.path.join(CAND_DIR, s) for s in ("hk7_cand.cu", "hk7_plan_cand.cu",
                                                 "hk8_cand.cu", "hk8_plan_cand.cu")]
    res = subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", out, *srcs],
                         capture_output=True, text=True)
    say(f"build {' '.join(os.path.basename(x) for x in srcs)}: rc {res.returncode}")
    for line in (res.stdout + res.stderr).splitlines():
        if res.returncode != 0 or "registers" in line or "spill" in line:
            say("  " + line.strip()[:200])
    if res.returncode != 0:
        raise RuntimeError("the HK7 / HK8 candidates did not build")
    lib = ctypes.CDLL(out)
    lib.cand_symmetrize_ft_first.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P]
    lib.cand_likelihood_local_ctf_first.argtypes = [_P, _I, _I, _P]
    lib.cand_likelihood_local_ctf_tf32.argtypes = [_P, _I, _P]
    lib.cand_likelihood_local_ctf_variant.argtypes = [_P, _I, _I, _I, _P]
    lib.cand_symmetrize_ft_variant.argtypes = [_P, _I, _I, _I, _I, _P]
    return lib


# hk7_plan_cand.cu's instances of csrc/symmetrize_ft.cu: (blocks an SM the
# registers allow, the orbit form's (xy, z) brick edges or None for the plan's)
HK7_VARIANTS = {"m1": (1, None), "m3": (3, None), "31x31x1": (2, (31, 1)),
                "27x27x1": (2, (27, 1)), "25x25x1": (2, (25, 1)), "23x23x1": (2, (23, 1)),
                "11^3": (2, (11, 11)), "9^3": (2, (9, 9))}


# hk8_plan_cand.cu's instances of csrc/likelihood_local_ctf.cu: (pixels a
# chunk, threads, blocks an SM)
HK8_VARIANTS = {0: (32, 384, 1), 1: (64, 384, 1), 2: (32, 192, 1), 3: (64, 192, 1),
                4: (32, 192, 2), 5: (16, 384, 1)}


def cur_stream() -> int:
    """The current stream at the call (a capture's, inside a CUDA graph)."""
    return torch.cuda.current_stream().cuda_stream


class _LcArgsFirst(ctypes.Structure):
    """hk8_cand.cu's LcArgs (the first design)."""
    _fields_ = [(n, _P) for n in ("dat_s", "s_pack", "ctfk", "f2", "ang", "dfac", "pri", "tra",
                                  "a", "w_r", "w_t", "w_d", "u_r", "u_t", "u_d")] + [
        (n, _I) for n in ("L", "D", "R", "T", "P")]


def hk8_first_plan(n_d: int, n_r: int, n_t: int) -> dict:
    """The first design's launch plan of HK8: 2 x 3 x 3 tiles walked by 64-256
    threads, the image's (D, R, T) block in shared memory."""
    up = lambda n, m: -(-n // m) * m
    d3, t3, r2 = up(n_d, 3), up(n_t, 3), up(n_r, 2)
    items = (d3 // 3) * (t3 // 3) * (r2 // 2)
    threads = min(range(256, 32, -32), key=lambda n: up(items, n))
    smem = 4 * (2 * 32 * r2 + 2 * t3 * 32 + d3 * 32 + 32 + d3 * t3 * r2 + d3 * r2 + d3 * t3
                + 32)
    return dict(threads=threads, smem=smem)


def alone(fn) -> float:
    from thunder_tpu_torch.micro.launch_floor import graph_ms

    return graph_ms(fn)


def hk7_shape(lib, dev, gen, label, sym, n_g, big, reps, results):
    """HK7 at one shape: the first design, the kernel in csrc/ (the form its
    group takes), the plain version; errors against the plain version."""
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.recon import reconstructor

    f = torch.complex(torch.randn(n_g, big, big, big, generator=gen, device=dev),
                      torch.randn(n_g, big, big, big, generator=gen, device=dev))
    t = torch.rand(n_g, big, big, big, generator=gen, device=dev)
    mats = Symmetry(sym, dev).matrices
    form = reconstructor.symmetrize_form(mats)
    rad = float(big // 2 - 6)
    fo, to = torch.empty_like(f), torch.empty_like(t)

    def first():
        _native.check(lib.cand_symmetrize_ft_first(
            f.data_ptr(), t.data_ptr(), fo.data_ptr(), to.data_ptr(), mats.data_ptr(),
            mats.shape[0] - 1, n_g, big, rad, cur_stream()), "hk7 first")
        return fo, to

    new = lambda: reconstructor.symmetrize_ft(f, t, mats, rad, form)
    variants = {k: v for k, v in HK7_VARIANTS.items() if form != "box" or v[1] is None}
    v_args = {}
    for k, (mb, b) in variants.items():
        plan = reconstructor.symmetrize_plan(form, mats.shape[0], big, b)
        table = form.reps(plan, dev) if plan["orbit"] else None
        v_args[k] = (mb, plan, reconstructor._SymArgs(
            f.data_ptr(), t.data_ptr(), fo.data_ptr(), to.data_ptr(), mats.data_ptr(),
            None if table is None else table.data_ptr(), mats.shape[0] - 1, big, plan["orbit"],
            *plan["edges"], *plan["n"], len(table) if plan["orbit"] else int(np.prod(plan["n"])),
            rad * rad))

    def variant(k):
        mb, plan, args = v_args[k]
        _native.check(lib.cand_symmetrize_ft_variant(ctypes.addressof(args), mb, n_g,
                                                     plan["threads"], plan["smem"],
                                                     cur_stream()), f"hk7 variant {k}")
        return fo, to

    ref, plain_ms = timed_once(lambda: reconstructor.symmetrize_ft_plain(f, t, mats, rad))
    err = lambda o: max(rel_err(torch.view_as_real(o[0]), torch.view_as_real(ref[0])),
                        rel_err(o[1], ref[1]))
    errs = {"first": err(first()), "csrc": err(new())}
    errs.update({f"v {k}": err(variant(k)) for k in variants})
    del ref
    fns = {"first": first, "csrc": new}
    fns.update({f"v {k}": (lambda k=k: variant(k)) for k in variants})
    ms = turns(fns, reps)
    ms_alone = {k: alone(fn) for k, fn in fns.items()}
    ms["plain"] = [plain_ms]
    bound = 2 * n_g * big ** 3 * 12 / 3.35e12 * 1e3
    labels = {"first": "the first design: a thread a cell, taps from device memory",
              "csrc": f"csrc/symmetrize_ft.cu, {form} form", "plain": "symmetrize_ft_plain, once"}
    say("  alone ms: " + "  ".join(f"{k} {v:.4f}" for k, v in ms_alone.items())
        + f"; bytes bound {bound:.4f} ms (share of csrc alone {bound / ms_alone['csrc']:.3f})")
    report("HK7", f"{label}: {sym} G={n_g} big={big}^3 band {rad:.0f}", ms, errs, labels, 1e-5,
           results, alone_ms=ms_alone, bound_ms=bound, form=form)


def timed_once(fn):
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def hk8_shape(lib, dev, gen, r, reps, results, n_l=256, n_d=9, n_r=125, n_t=9):
    """HK8 at one CTF phase (both halves' images, r's band of the 160 px
    box): the first design, the kernel in csrc/, the plain version (32
    images at a time) and the yardstick of its dominant product,
    torch.bmm of (L, R, 2P) by (L, 2P, D T) in full fp32."""
    from thunder_tpu_torch.ops import likelihood
    from thunder_tpu_torch.ops.fourier import pack_rings, translate_phases
    from thunder_tpu_torch.physics.ctf import ctf_params

    size = 160
    rings = pack_rings(size, r, 1, device=dev)
    n_p = rings.i_col.numel()
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    cplx = lambda *s: torch.complex(rnd(*s), rnd(*s))
    s_pack = -0.5 * rings.mask * (0.5 + rand(n_l, n_p))
    dat = cplx(n_l, n_p)
    rng = np.random.default_rng(8)
    defocus = rng.uniform(8000, 20000, n_l)
    ctf = ctf_params(np.full(n_l, 300e3), defocus, defocus * rng.uniform(0.9, 1.1, n_l),
                     rng.uniform(0, 3, n_l), np.full(n_l, 2e7), np.full(n_l, 0.1),
                     np.zeros(n_l), device=dev)
    terms = likelihood.ctf_terms(ctf, rings.i_col, rings.i_row, size, 1.32)
    pri = ((0.3 / n_p ** 0.5) * cplx(n_l, n_r, n_p) + 0.05 * dat[:, None, :]).to(torch.complex64)
    ops = ((s_pack * dat).to(torch.complex64), s_pack, terms, 1 + 0.01 * rnd(n_l, n_d), pri,
           translate_phases(rings, rnd(n_l, n_t, 2)), (s_pack * dat.abs() ** 2).sum(-1),
           rand(n_l, n_r), rand(n_l, n_t), rand(n_l, n_d))
    new = lambda: likelihood.likelihood_local_ctf(*ops)
    outs = [torch.empty(n_l, k, device=dev) for k in (n_r, n_t, n_d)]
    t_ops = [o for o in ops if torch.is_tensor(o)]
    old_args = _LcArgsFirst(t_ops[0].data_ptr(), t_ops[1].data_ptr(), terms.consts.data_ptr(),
                          terms.f2.data_ptr(), terms.ang.data_ptr(),
                          *[o.data_ptr() for o in t_ops[2:]], *[o.data_ptr() for o in outs],
                          n_l, n_d, n_r, n_t, n_p)
    plan_first = hk8_first_plan(n_d, n_r, n_t)

    def first():
        _native.check(lib.cand_likelihood_local_ctf_first(
            ctypes.addressof(old_args), plan_first["threads"], plan_first["smem"], cur_stream()),
            "hk8 first")
        return outs

    v_args = {}
    for v, (pc, thr, _) in HK8_VARIANTS.items():
        plan = likelihood.likelihood_ctf_plan(n_d, n_r, n_t, pc, thr)
        v_args[v] = (plan, likelihood._LcArgs(
            t_ops[0].data_ptr(), t_ops[1].data_ptr(), terms.consts.data_ptr(), terms.f2.data_ptr(),
            terms.ang.data_ptr(), *[o.data_ptr() for o in t_ops[2:]],
            *[o.data_ptr() for o in outs], n_l, n_d, n_r, n_t, n_p, plan["n_rg"], plan["n_tt"],
            plan["n_dt"], plan["groups"]))

    def variant(v):
        plan, args = v_args[v]
        _native.check(lib.cand_likelihood_local_ctf_variant(
            ctypes.addressof(args), v, plan["threads"], plan["smem"], cur_stream()),
            f"hk8 variant {v}")
        return outs

    def plain():
        parts = []
        for lo in range(0, n_l, 32):
            sl = slice(lo, lo + 32)
            part = [o[sl] if torch.is_tensor(o) else o for o in ops]
            part[2] = terms.images(lambda a: a[sl])
            parts.append(likelihood.likelihood_local_ctf_plain(*part))
        return [torch.cat(x) for x in zip(*parts)]

    def tf32(split):
        _native.check(lib.cand_likelihood_local_ctf_tf32(ctypes.addressof(old_args), split,
                                                         cur_stream()), "hk8 tf32")
        return outs

    ref, plain_ms = timed_once(plain)
    tol = max(1e-4, 4 * 1.1920929e-07 * float(ops[6].abs().max()))
    err = lambda got: max(rel_err(g, rr) for g, rr in zip(got, ref))
    errs = {"first": err(first()), "csrc": err(new())}
    errs.update({f"v{v}": err(variant(v)) for v in HK8_VARIANTS})
    # the tensor-core candidates are reported, not held to the tolerance
    tf32_errs = {"tf32x3": err(tf32(3)), "tf32": err(tf32(1))}
    say(f"  mma.sync candidates' rel_err: 3xTF32 {tf32_errs['tf32x3']:.3e}, plain TF32 "
        f"{tf32_errs['tf32']:.3e} (tolerance {tol:.3e})")
    # the dominant product's yardstick: C's (L, R, 2P) x (L, 2P, D T) in fp32
    a_mat = torch.randn(n_l, n_r, 2 * n_p, generator=gen, device=dev)
    b_mat = torch.randn(n_l, 2 * n_p, n_d * n_t, generator=gen, device=dev)
    fns = {"first": first, "csrc": new, "tf32x3": lambda: tf32(3), "tf32": lambda: tf32(1),
           "bmm": lambda: torch.bmm(a_mat, b_mat)}
    fns.update({f"v{v}": (lambda v=v: variant(v)) for v in HK8_VARIANTS})
    ms = turns(fns, reps)
    ms_alone = {k: alone(fn) for k, fn in fns.items()}
    ms["plain"] = [plain_ms]
    n_flops = n_l * (n_r * n_t * n_p * (4 + 2 * n_d) + n_d * n_r * n_p * 2 + n_r * n_p * 4
                     + n_d * n_p * 2 + n_t * n_p * 6 + n_d * n_p * 30 + 12 * n_d * n_r * n_t)
    bound = n_flops / 67e12 * 1e3
    labels = {"first": "the first design: 2 x 3 x 3 tiles, (D, R, T) block in shared memory",
              "csrc": "csrc/likelihood_local_ctf.cu: 4 x 3 x 9 register tiles, pixel groups",
              "tf32x3": "hk8_cand.cu: C by mma.sync m16n8k8, 3xTF32",
              "tf32": "hk8_cand.cu: C by mma.sync m16n8k8, plain TF32",
              "bmm": "torch.bmm (L, R, 2P) x (L, 2P, D T) fp32: the dominant product alone",
              **{f"v{v}": f"csrc's template: {pc} pixels a chunk, {thr} threads, {mb} "
                           f"block(s) an SM" for v, (pc, thr, mb) in HK8_VARIANTS.items()},
              "plain": "likelihood_local_ctf_plain, once, 32 images at a time"}
    say("  alone ms: " + "  ".join(f"{k} {v:.4f}" for k, v in ms_alone.items())
        + f"; operations bound {bound:.4f} ms (share of csrc alone "
        f"{bound / ms_alone['csrc']:.3f})")
    report("HK8", f"L={n_l} D={n_d} R={n_r} T={n_t} P={n_p} (r={r})", ms, errs, labels, tol,
           results, alone_ms=ms_alone, bound_ms=bound, candidate_rel_err=tf32_errs)


def main_78(dev, gen, reps, results):
    lib = build_78()
    _native.library()
    for label, sym, n_g, big in (("C4 K=1 pair", "C4", 2, 152), ("D2 K=1 pair", "D2", 2, 152),
                                 ("C4 K=4, 2K grids", "C4", 8, 132),
                                 ("C4 one grid, full band", "C4", 1, 320),
                                 ("C3 K=1 pair (box form)", "C3", 2, 152),
                                 ("I1, the kernel test's grids", "I1", 4, 24)):
        hk7_shape(lib, dev, gen, label, sym, n_g, big, reps if big < 300 else 3, results)
    hk8_shape(lib, dev, gen, 22, reps, results)
    hk8_shape(lib, dev, gen, 78, max(2, reps // 3), results)


def build_gather() -> ctypes.CDLL:
    """nvcc micro/cand/gather_cand.cu (G1-G4's first designs)."""
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    out = os.path.join(_native.BUILD_DIR, "libgather_candidates.so")
    src = os.path.join(CAND_DIR, "gather_cand.cu")
    res = subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-shared", "-o", out, src],
                         capture_output=True, text=True)
    say(f"build gather_cand.cu: rc {res.returncode}")
    for line in (res.stdout + res.stderr).splitlines():
        if res.returncode != 0 or "registers" in line or "spill" in line:
            say("  " + line.strip()[:200])
    if res.returncode != 0:
        raise RuntimeError("the gather candidates did not build")
    lib = ctypes.CDLL(out)
    lib.cand_take_flat.argtypes = [_P, _L, _P, _L, _P, _P]
    lib.cand_take_along.argtypes = [_P, _I, _P, _P, _L, _I, _I, _P, _P]
    lib.cand_take_flat_variant.argtypes = [_I, _P, _L, _P, _L, _P, _P]
    lib.cand_take_rows_strip.argtypes = [_I, _I, _I, _P, _I, _P, _L, _I, _P, _P]
    lib.cand_take_both_cluster.argtypes = [_P, _I, _P, _P, _L, _I, _P, _P]
    lib.cand_take_flat_cluster.argtypes = [_I, _P, _L, _P, _L, _P, _P]
    lib.cand_flat_cluster_count.argtypes = [_I]
    for c in (8, 16):
        say(f"  G1 clusters of {c} blocks the card holds at once: {lib.cand_flat_cluster_count(c)}")
    return lib


# gather_cand.cu's G1 variants: (tap load, vectors a thread, streaming hints,
# grid); "policy" = ld.global.nc with an evict-last L2 policy
FLAT_VARIANTS = {0: "policy, 2 vectors, hints, persistent", 1: "__ldg, 2, hints, persistent",
                 2: "policy + L1 no_allocate, 2, hints, persistent",
                 3: "ld.global.cg, 2, hints, persistent", 4: "policy, 1, hints, persistent",
                 5: "policy, 4, hints, persistent", 6: "policy, 1, hints, a vector a thread",
                 7: "__ldg, 1, no hints, a vector a thread",
                 8: "L1 no_allocate, 1, hints, a vector a thread",
                 9: "policy, 2, no hints, persistent",
                 10: "policy + L1 no_allocate, 1, hints, a vector a thread",
                 11: "__ldg, 4, no hints, persistent"}
# gather_cand.cu's G2 strips: (columns, threads, rows a block)
STRIP_VARIANTS = ((8, 256, 128), (32, 256, 128), (8, 256, 64), (8, 512, 256))


def gather_first(lib, fn):
    """A call of G1-G4's first design with ``fn``'s arguments."""
    from thunder_tpu_torch.ops import gather as g

    def flat(t, idx):
        out = torch.empty(idx.shape, device=t.device)
        _native.check(lib.cand_take_flat(t.data_ptr(), t.numel(), idx.data_ptr(), idx.numel(),
                                         out.data_ptr(), _native.stream_ptr(t)), "cand_take_flat")
        return out

    def along(mode):
        def call(tab, *idx):
            ridx = None if mode == 1 else idx[0]
            lidx = None if mode == 0 else idx[-1]
            out = torch.empty(idx[0].shape, device=tab.device)
            _native.check(lib.cand_take_along(
                tab.data_ptr(), tab.shape[0], None if ridx is None else ridx.data_ptr(),
                None if lidx is None else lidx.data_ptr(), out.numel(), tab.shape[1], mode,
                out.data_ptr(), _native.stream_ptr(tab)), "cand_take_along")
            return out
        return call

    return {g.take_flat: flat, g.take_along_rows: along(0), g.take_along_lanes: along(1),
            g.take_along_both: along(2)}[fn]


def gather_others(lib, fn) -> dict:
    """The designs measured beside the redesign (gather_cand.cu), by
    label, for ``fn``'s arguments."""
    from thunder_tpu_torch.ops import gather as g

    def flat(v):
        def call(t, idx):
            out = torch.empty(idx.shape, device=t.device)
            _native.check(lib.cand_take_flat_variant(v, t.data_ptr(), t.numel(), idx.data_ptr(),
                                                     idx.numel(), out.data_ptr(),
                                                     _native.stream_ptr(t)), "cand_flat")
            return out
        return call

    def strip(sw, threads, rows):
        def call(tab, idx):
            out = torch.empty(idx.shape, device=tab.device)
            _native.check(lib.cand_take_rows_strip(
                sw, threads, rows, tab.data_ptr(), tab.shape[0], idx.data_ptr(), idx.numel(),
                tab.shape[1], out.data_ptr(), _native.stream_ptr(tab)), "cand_strip")
            return out
        return call

    def cluster(tab, ridx, lidx):
        out = torch.empty(ridx.shape, device=tab.device)
        _native.check(lib.cand_take_both_cluster(
            tab.data_ptr(), tab.shape[0], ridx.data_ptr(), lidx.data_ptr(), out.numel(),
            tab.shape[1], out.data_ptr(), _native.stream_ptr(tab)), "cand_cluster")
        return out

    def flat_cluster(csize):
        def call(t, idx):
            out = torch.empty(idx.shape, device=t.device)
            _native.check(lib.cand_take_flat_cluster(csize, t.data_ptr(), t.numel(),
                                                     idx.data_ptr(), idx.numel(), out.data_ptr(),
                                                     _native.stream_ptr(t)), "cand_flat_cluster")
            return out
        return call

    if fn is g.take_flat:
        return dict({f"v{v}: {d}": flat(v) for v, d in FLAT_VARIANTS.items()},
                    **{f"clusters of {c}, 128 KiB a block": flat_cluster(c) for c in (8, 16)})
    if fn is g.take_along_rows:
        return {f"strip {sw} x {th} threads x {rows} rows": strip(sw, th, rows)
                for sw, th, rows in STRIP_VARIANTS}
    if fn is g.take_along_both:
        return {"cluster of 2, the table in shared memory": cluster}
    return {}


def forced(fn, form: str):
    """G2-G4's ``fn`` launched in ``form``, in place of along_form's choice."""
    from thunder_tpu_torch.ops import gather as g

    mode = (g.take_along_rows, g.take_along_lanes, g.take_along_both).index(fn)

    def call(tab, *idx):
        return g._take_along(fn, mode, tab, None if mode == 1 else idx[0],
                             None if mode == 0 else idx[-1], form=form)
    return call


def alone_turns(fns: dict, args: list) -> dict:
    """Each function alone (a replayed CUDA graph of its calls, cycling
    ``args``), forwards then backwards: name -> [ms, ms]."""
    from thunder_tpu_torch.micro.launch_floor import graph_ms

    out = {k: [] for k in fns}
    for keys in (list(fns), list(fns)[::-1]):
        for k in keys:
            out[k].append(graph_ms(fns[k], args=args))
    return out


def main_gather(dev, reps, results):
    """G1-G4: the first designs beside csrc/gather.cu's forms at
    micro/gather.py's cases (exact against the plain versions; alone and
    by events, in turns), then G2's and G4's forms across batches."""
    from thunder_tpu_torch.micro import gather as micro
    from thunder_tpu_torch.micro.launch_floor import empty_launch_ms
    from thunder_tpu_torch.ops import gather as g

    lib = build_gather()
    _native.library()
    say(f"empty kernel alone {empty_launch_ms():.4f} ms")
    modes = {g.take_along_rows: 0, g.take_along_lanes: 1, g.take_along_both: 2}
    for c in micro.build_cases(dev):
        if c.kernel is g.take_rows:
            continue
        fns = {"first design": gather_first(lib, c.kernel)}
        fns.update(gather_others(lib, c.kernel))
        if c.kernel is g.take_flat:
            fns["csrc"] = c.kernel
        else:
            tab = c.args[0][0]
            chosen = g.along_form(modes[c.kernel], tab.shape[0], tab.shape[1],
                                  c.args[0][-1].numel())
            for form in g.along_forms(modes[c.kernel], tab.shape[0], tab.shape[1]):
                fns[form + (" (chosen)" if form == chosen else "")] = forced(c.kernel, form)
        ref = micro.PLAIN[c.kernel](*c.args[0])
        for name, fn in fns.items():
            if not micro.same_bits(fn(*c.args[0]), ref):
                raise RuntimeError(f"{c.name} {name}: differs from the plain version")
        del ref
        bound = sum(x.numel() * x.element_size() for x in c.args[0]) + c.count * 4
        bound_ms = bound / micro.HBM_BYTES_S * 1e3
        ms = alone_turns(fns, c.args)
        ev = turns({k: (lambda f=f: f(*c.args[0])) for k, f in fns.items()}, reps)
        say(f"{c.name} ({micro.KERNEL_ID[c.kernel]}), bound {bound_ms:.4f} ms: "
            + "  ".join(f"{k} alone {v[0]:.4f}, {v[1]:.4f} / events {ev[k][0]:.4f}, "
                        f"{ev[k][1]:.4f}" for k, v in ms.items()))
        results.append(dict(kernel=micro.KERNEL_ID[c.kernel], shape=c.name, bound_ms=bound_ms,
                            alone_ms=ms, ms=ev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for rows in (micro.MOSAIC_ROWS, 128):
        tab = torch.randn(rows, micro.LANES, generator=gen, device=dev)
        for b in (1 << 8, 1 << 9, 3 << 8, 1 << 10, 1 << 11, 3 << 10, 1 << 12, 1 << 13, 1 << 14,
                  1 << 15, 1 << 16, 1 << 17):
            ri = lambda hi: [micro._ri(gen, 0, hi, (b, micro.LANES), dev) for _ in range(2)]
            r, l = ri(rows), ri(micro.LANES)
            sweeps = [(0, g.take_along_rows, [(tab, x) for x in r],
                       ("scalar", "strip16", "strip64"))]
            if rows == micro.MOSAIC_ROWS:     # the candidates' shape; G4 has one form
                sweeps.append((2, g.take_along_both, [(tab, x, y) for x, y in zip(r, l)],
                               ("row",)))
            for mode, fn, args, forms in sweeps:
                fns = {f: forced(fn, f) for f in forms}
                if rows == micro.MOSAIC_ROWS:
                    fns.update(gather_others(lib, fn))
                ref = micro.PLAIN[fn](*args[0])
                for name, f in fns.items():
                    if not micro.same_bits(f(*args[0]), ref):
                        raise RuntimeError(f"G{mode + 2} B={b} {name}: differs from the plain "
                                           "version")
                ms = alone_turns(fns, args)
                say(f"G{mode + 2} {rows} table rows, B={b}: "
                    + "  ".join(f"{k} alone {v[0]:.4f}, {v[1]:.4f}" for k, v in ms.items()))
                results.append(dict(kernel=f"G{mode + 2}", shape=f"{rows} rows, B={b}",
                                    alone_ms=ms))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--big", action="store_true", help="add the 256 px shapes")
    ap.add_argument("--kernels", default="hk1,hk3",
                    help="hk1,hk3 (the default) and / or hk4,hk5, hk7,hk8, hk10, hk13, gather")
    ap.add_argument("--lanes", action="store_true",
                    help="count HK10's busy lanes from the shapes (no device)")
    ap.add_argument("--bricks", type=int, default=40)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    if args.lanes:
        say(json.dumps({"hk10_lanes": hk10_lanes(args.bricks)}))
        return 0
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
    kernels = set(args.kernels.split(","))
    if kernels & {"hk4", "hk5"}:
        main_45(dev, gen, args.reps, results)
    if kernels & {"hk7", "hk8"}:
        main_78(dev, gen, args.reps, results)
    if "hk10" in kernels:
        lib = build_10()
        hk10_shape(lib, dev, gen, rng, "128 px", 128, 36, 128, 48, args.reps, results)
        hk10_shape(lib, dev, gen, rng, "CTF round 160 px", 160, 74, 128, 48, args.reps, results,
                   use_d=True)
    if "hk13" in kernels:
        main_hk13(dev, gen, args.reps, results)
    if "gather" in kernels:
        main_gather(dev, args.reps, results)
    if kernels & {"hk1", "hk3"}:
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
