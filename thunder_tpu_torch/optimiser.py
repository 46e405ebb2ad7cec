"""The E-M loop of 3D auto-refinement and 2D classification:
expectation (pose and class search), maximization (noise / norm
statistics, reconstruction) and round-level control — the main paths of
thunder_tpu.optimiser on one GPU.

  round:
    build the projection tables                       [refreshProj]
    GLOBAL: rotation-block pose grid -> marginals      [expectation :633-1136]
    particle-filter phases: perturb -> evaluate -> resample
                                                       [expectation :1138-1681]
    sigma / norm / scale from the rank-1 residuals     [maximization]
    draw poses -> insertion -> two-pass gridding       [reconstructRef]
    hemisphere FSC, averaging, masking, state machine  [Model, run :3561]

Hemispheres A and B (gold standard) are a leading axis of size 2 on
every state tensor; both run batched on one device.  The hot spots are
the hand-written kernels: HK1 project_slices / HK5 project_slices_2d
(global search, phases, statistics), HK13 project_brick (the phases of
images whose clouds fit a brick window), HK2 likelihood_block (global
search, phases), HK8 likelihood_local_ctf (the phases of CTF search),
HK11 insert_sweep / HK12 insert_sweep_2d (insertion: thunder_tpu's
shear-sweep map; HK10 insert_mkb in 3D and HK6 insert_bilinear_2d in 2D
with the insertion option reco_kernel="mkb"), HK7
symmetrize_ft (point-group symmetrisation of the 3D grids) and HK4
shell_sums (FSC, sigma).

Supported here: 3D refinement and 3D classification (any K, any point
group, global, local and CTF search), 2D classification (any K; the
config's symmetry is ignored in 2D, as in thunder_tpu) and, once the
search stops, signal subtraction (``save_subtract``: HK1 / HK5 over
every pixel of the box).  The JAX
package's pose-side symmetry expansion belongs to its sharded inserter
and has no counterpart, nor has its TPU-only machinery
(hemisphere sequencing, the brick table's storage, static insert
buckets, the sweep's TPU layouts and THUNDER_INSERT_V2): the port
computes the sweep's map with HK11 and HK12.

A stack whose two spectra do not fit the card keeps its originals in
host memory (``HostFt``, thunder_tpu's host path): the residency plan
(``_plan_residency``) turns ``host_ft_ori`` on where the projected
device bytes exceed the budget, preprocessing runs a chunk at a time,
and every reader of the originals takes ``host_ft_chunk`` images at a
time (``_ft_chunks``), the statistics in two passes where there are
several chunks (``norm_correction``, ``refresh_sigma``,
``correct_scale``).  The compute stays on the device.

3D phase loops follow thunder_tpu's projection-table plan
(``_table_plan``: the rung ladder, its byte rules and hysteresis, routing
of images by cloud spread, chunk boundaries that re-plan; environment
THUNDER_BRICK, THUNDER_SPLIT, THUNDER_PHASE_CHUNK): images whose rotation
clouds fit a rung project through brick windows (HK13, ops/brick.py),
where a sample outside its window scores 0, so the plan changes
results.  The plan's constants are the reference's rules, kept for
parity.  Routing works on every layout as thunder_tpu's works on its
mesh: the plan reads every rank's spreads, and each routed group's
images step on the ranks that hold them (``_phases_routed``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from thunder_tpu_torch.config import ThunderConfig
from thunder_tpu_torch.constants import (
    EDGE_WIDTH_RL,
    MAX_N_PHASE_PER_ITER,
    MIN_N_PHASE_PER_ITER_GLOBAL,
    MIN_N_PHASE_PER_ITER_LOCAL,
    MIN_N_TRANSLATION_GLOBAL,
    N_PHASE_WITH_NO_VARI_DECREASE,
)
from thunder_tpu_torch import particle as pt
from thunder_tpu_torch.device import COMPLEX, REAL, as_device, generator, synchronize
from thunder_tpu_torch.geometry.quaternion import (random_quat,
                                                   rotate2d_from_unit, rotate3d)
from thunder_tpu_torch.geometry.symmetry import Symmetry
from thunder_tpu_torch.model import (
    SEARCH_TYPE_CTF,
    SEARCH_TYPE_GLOBAL,
    SEARCH_TYPE_LOCAL,
    SEARCH_TYPE_STOP,
    ModelState,
    true_fsc_batch,
)
from thunder_tpu_torch.ops.brick import project_brick, spread_margin, table_bytes
from thunder_tpu_torch.ops.fourier import (
    PackedRings,
    centered_shell_dev,
    extract_packed,
    fft2_centered,
    ifft2_centered,
    pack_rings,
    resize_rl,
    translate_ft,
    translate_phases,
    translate_phases_view,
)
from thunder_tpu_torch.ops.insert import (dense_slice_values, insert_bilinear_2d, insert_mkb,
                                          insert_sweep, insert_sweep_2d, insert_sweep_slab)
from thunder_tpu_torch.ops.likelihood import (CtfTerms, ctf_terms,
                                              likelihood_block,
                                              likelihood_local_ctf,
                                              local_marginals)
from thunder_tpu_torch.parallel import comm
from thunder_tpu_torch.parallel.ingest import local_block, process_local_rows
from thunder_tpu_torch.parallel.mesh import Layout, replicated_per_hemi, single
from thunder_tpu_torch.ops.projector import (
    prepare_projectee_2d,
    prepare_projectee_2d_cropped,
    prepare_projectee_3d,
    prepare_projectee_3d_cropped,
    project_slices,
    project_slices_2d,
    quad_fits,
    quad_taps,
)
from thunder_tpu_torch.physics.ctf import CtfParams, ctf_image, ctf_packed
from thunder_tpu_torch.physics.mask import radial_grid, soft_mask_weight
from thunder_tpu_torch.physics import spectrum
from thunder_tpu_torch.physics.spectrum import shell_sums
from thunder_tpu_torch.pipeline.preprocess import (
    init_sigma,
    init_sigma_from_moments,
    preprocess_images,
    sigma_to_sig_rcp,
)
from thunder_tpu_torch.recon.sharded import (reconstruct_all_sharded,
                                             reconstruct_two_pass_sharded,
                                             sharded_grid_specs)
from thunder_tpu_torch.recon.reconstructor import (reconstruct,
                                                   reconstruct_two_pass,
                                                   symmetrize_form, symmetrize_ft)

PARTICLE_FILTER_DECREASE_FACTOR = 0.95  # include/Optimiser.h:60
CLASS_BALANCE_FACTOR = 0.05             # include/Optimiser.h:71
ROT_BLOCK = 256        # rotations per global-search block (thunder_tpu's _ROT_BLOCK)
RECO_COMPACT_SLOTS = 48

# The projection-table plan of local rounds (thunder_tpu optimiser.py
# _brick_choice, _route_bounds, _table_plan), kept as the reference's
# rules: they decide which images project through brick windows (HK13),
# and that changes results (a sample outside its window scores 0).
# The rungs (span, stride), in the reference's order of preference.
BRICK_LADDER = ((4, 1), (5, 2), (6, 2), (7, 3), (8, 2))
# a rung is admitted only while thunder_tpu's brick table for it would
# fit this many bytes (table_bytes; the port builds no such table)
BRICK_TABLE_BUDGET = 2 << 30
# span 8 only where the corner-row table (crop^3 x 16 bytes a class)
# reaches this many bytes
BRICK_WIDE_MIN_BYTES = 48e6
# routing and mid-round re-planning only where the table (crop^3 x 16
# bytes) exceeds this many bytes (THUNDER_SPLIT=force drops it for routing)
PLAN_TABLE_MIN_BYTES = 24e6

# The residency plan (thunder_tpu optimiser.py _plan_residency): the
# counted bytes times this headroom for a round's transient tensors
RESIDENCY_HEADROOM = 1.25
# the float64 balance loop's live tensors a cell of a lane's grid, in
# the full grid's cells: T and W (8 bytes a half-space cell each), the
# complex128 half-space field its FFT pair takes and returns (16), and
# the real-space field and its windowed product (8 each a cell)
BALANCE_BYTES_PER_CELL = 4 + 4 + 8 + 8 + 8
# the budget where the device is no card (thunder_tpu's fallback)
NO_CARD_BUDGET_GB = 16.0
# a phase projects and scores its images in blocks whose (R + T) x P
# complex supports stay within this many bytes (one block where they fit)
PHASE_BLOCK_BYTES = 2 << 30


def proj_crop_size(size: int, pf: int, r_u: int) -> int:
    """Crop of the padded spectrum a search at radius r_u can reach:
    slice coordinates stay within pf * r_u of the origin."""
    return min(size * pf, 2 * (pf * r_u + 2))


def reco_grid_size(size: int, r_u: int) -> int:
    """Cropped reconstructor box (Model::resetReco, Model.cpp:1113)."""
    size_r = min(size, 2 * (r_u + 2))
    return max(16, size_r + (size_r % 2))


def _range(name: str):
    """A named torch.profiler range, ``thunder:<name>`` (a no-op outside
    a profile)."""
    return record_function("thunder:" + name)


class _Stages:
    """The consecutive stages of a round.  begin(name) closes the open
    stage and opens the next: a profiler range ``thunder:round/<name>``
    and, when ``sync`` is given (per-stage timing asked for), its host
    milliseconds up to a device sync, kept in ``ms``.  Leaving the
    ``with`` block closes the last stage."""

    def __init__(self, sync=None):
        self.ms = None if sync is None else {}
        self._sync = sync
        self._open = None

    def __enter__(self):
        if self._sync is not None:
            self._sync()
        return self

    def begin(self, name: str) -> None:
        self.end()
        self._open = (name, _range("round/" + name), time.time())
        self._open[1].__enter__()

    def end(self) -> None:
        if self._open is None:
            return
        name, rng, t0 = self._open
        rng.__exit__(None, None, None)
        if self._sync is not None:
            self._sync()
            self.ms[name] = round((time.time() - t0) * 1e3, 1)
        self._open = None

    def __exit__(self, *exc) -> None:
        self.end()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _median(x: torch.Tensor, valid: torch.Tensor) -> float:
    """Median over the valid entries, the two middle values averaged
    (jnp.nanmedian's convention)."""
    return float(torch.nanquantile(torch.where(valid > 0, x, float("nan")).reshape(-1), 0.5))


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile along the last axis, interpolated linearly between
    the order statistics (numpy's and jnp.quantile's default)."""
    x = torch.sort(x, dim=-1).values
    pos = q * (x.shape[-1] - 1)
    lo = math.floor(pos)
    w = pos - lo
    return x[..., lo] * (1 - w) + x[..., min(lo + 1, x.shape[-1] - 1)] * w


def spread_dev(q: torch.Tensor) -> torch.Tensor:
    """Angular deviation (radians) of each rotation support point q
    (..., R, 4) from its image's mean quaternion (signs aligned to the
    first point): (..., R)."""
    q = q * torch.sign(torch.sum(q * q[..., :1, :], -1, keepdim=True) + 1e-30)
    qm = q.mean(-2)
    qm = qm / torch.clamp(torch.linalg.norm(qm, dim=-1, keepdim=True), min=1e-9)
    dot = torch.clamp(torch.abs(torch.sum(q * qm[..., None, :], -1)), 0, 1)
    return 2.0 * torch.arccos(dot)


def pooled_q98(dev: torch.Tensor, valid: torch.Tensor) -> float:
    """The 98th percentile of the deviations dev (2, L, R) over the valid
    images' support points (thunder_tpu _spread_q98_h): the statistic a
    whole-batch rung is chosen by."""
    return float(_quantile(dev[valid > 0].reshape(-1), 0.98))


def per_image_q98(dev: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
    """Each image's 98th-percentile deviation (thunder_tpu
    _spread_per_image_h), 0 for invalid images (they sort into the first
    segment): (2, L) on the host."""
    return torch.where(valid > 0, _quantile(dev, 0.98), 0.0).cpu().numpy()


def merge_segment_states(states: list) -> list:
    """A hemisphere's stall state [phase, n_no_dec, previous (k1, s0, s1,
    s_d)] from its routed segments' (thunder_tpu run_routed): phase by
    max, n_no_dec by min, each previous variance by max."""
    return [max(st[0] for st in states), min(st[1] for st in states),
            [max(v) for v in zip(*(st[2] for st in states))]]


# -- stages (module level: plain functions on tensors) -----------------

def pack_inputs(ft_masked: torch.Tensor, ctf: CtfParams, sigma: torch.Tensor,
                group_id: torch.Tensor, rings: PackedRings, size: int,
                pixel_size: float):
    """allocPreCal analogue: ring pixels, CTF, per-group sigma lookup and
    the likelihood operands, for (2, L) images.  Returns dat_w (2, L, P)
    complex, sctf2 (2, L, P), a_term (2, L)."""
    dat = extract_packed(ft_masked, rings)
    ctf_p = ctf_packed(ctf, rings.i_col, rings.i_row, size, pixel_size)
    h = torch.arange(sigma.shape[0], device=sigma.device)[:, None, None]
    sig = sigma[h, group_id[..., None], rings.i_sig.long()[None, None, :]]
    sig_rcp = sigma_to_sig_rcp(sig) * rings.mask
    dat_w = (sig_rcp * ctf_p).to(COMPLEX) * dat
    sctf2 = sig_rcp * ctf_p * ctf_p
    a_term = torch.sum(sig_rcp * dat.abs() ** 2, dim=-1)
    return dat_w, sctf2, a_term


def pack_inputs_ctf(ft_masked: torch.Tensor, sigma: torch.Tensor,
                    group_id: torch.Tensor, rings: PackedRings):
    """The CTF-search phases' operands, which carry no CTF
    (optimiser._phase_loop_ctf_h): dat_s = sigRcp dat (2, L, P) complex,
    s_pack = sigRcp (2, L, P), a_term (2, L)."""
    dat = extract_packed(ft_masked, rings)
    h = torch.arange(sigma.shape[0], device=sigma.device)[:, None, None]
    sig = sigma[h, group_id[..., None], rings.i_sig.long()[None, None, :]]
    s_rcp = sigma_to_sig_rcp(sig) * rings.mask
    return (s_rcp.to(COMPLEX) * dat, s_rcp,
            torch.sum(s_rcp * dat.abs() ** 2, dim=-1))


def rotations(quats: torch.Tensor, nd: int) -> torch.Tensor:
    """Poses (..., 4) -> rotation matrices (..., nd, nd); a 2D pose is
    the quaternion (cos phi, sin phi, 0, 0)."""
    return rotate2d_from_unit(quats[..., :2]) if nd == 2 else rotate3d(quats)


def project_any(table: torch.Tensor, rot: torch.Tensor, i_col, i_row,
                pf: int, cls=None) -> torch.Tensor:
    """HK1 on a (K, n, n, n) table, HK5 on a (K, n, n) one."""
    fn = project_slices_2d if table.ndim == 3 else project_slices
    return fn(table, rot, i_col, i_row, pf, cls)


def project_phase(table: torch.Tensor, rot: torch.Tensor, cls: torch.Tensor,
                  rings: PackedRings, pf: int, runs) -> torch.Tensor:
    """The phase loop's projection of images (L, R, nd, nd) from a (K,
    ...) table: ``runs`` [(rung, count)] covers the images in order, a
    run of rung None through HK1 / HK5, a brick rung (span, stride)
    through HK13 (each image's mean rotation formed here, once)."""
    outs, lo = [], 0
    for rung, n in runs:
        r, k = rot[lo:lo + n], cls[lo:lo + n]
        lo += n
        if rung is None:
            outs.append(project_any(table, r, rings.i_col, rings.i_row, pf, k))
        else:
            outs.append(project_brick(table, r, r.mean(1), rings.i_col, rings.i_row, pf,
                                      rung[0], rung[1], k))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _cut_runs(runs, b: slice) -> list:
    """The (rung, count) runs of :func:`project_phase` that cover images
    [b.start, b.stop) of the images ``runs`` cover."""
    out, lo = [], 0
    for rung, n in runs:
        a, z = max(lo, b.start), min(lo + n, b.stop)
        if z > a:
            out.append((rung, z - a))
        lo += n
    return out


def global_search(table: torch.Tensor, rot_blocks: torch.Tensor,
                  rings: PackedRings, dat_w: torch.Tensor, sctf2: torch.Tensor,
                  a_term: torch.Tensor, tra: torch.Tensor, pf: int):
    """Streaming log-sum-exp over every (class, rotation) of a grid for
    one hemisphere (optimiser._global_search): table (K, n, n, n) or
    (K, n, n), rot_blocks (n_blocks, B, d, d), dat_w/sctf2 (L, P),
    a_term (L,), tra (N, P).  Returns w_c (L, K), w_r (K, L,
    n_blocks*B), w_t (K, L, N).

    Each class carries its own running baseline through HK2 (the CTA
    of an (image, class) rescales only that class's columns); at the end
    every class is brought to the common baseline b* = max_k b_k by
    exp(b_k - b*) — the JAX scan's single baseline across (class x
    block) steps.  A rotation block costs two launches for all K
    classes: one projection (HK1 / HK5) and one likelihood (HK2)."""
    n_cls = table.shape[0]
    n_blocks, block = rot_blocks.shape[:2]
    n_l, n_t = dat_w.shape[0], tra.shape[0]
    dev = dat_w.device
    tra_l = tra[None].expand(n_l, -1, -1)
    base = torch.full((n_cls, n_l), float("-inf"), dtype=REAL, device=dev)
    w_c = torch.zeros((n_cls, n_l), dtype=REAL, device=dev)
    w_r = torch.zeros((n_cls, n_l, n_blocks * block), dtype=REAL, device=dev)
    w_t = torch.zeros((n_cls, n_l, n_t), dtype=REAL, device=dev)
    ones_r = torch.ones((1, 1), dtype=REAL, device=dev).expand(n_l, block)
    ones_t = torch.ones((1, 1), dtype=REAL, device=dev).expand(n_l, n_t)
    classes = torch.arange(n_cls, device=dev)
    for b_idx in range(n_blocks):
        rot = rot_blocks[b_idx][None].expand((n_cls,) + rot_blocks.shape[1:])
        pri = project_any(table, rot, rings.i_col, rings.i_row, pf, classes)
        likelihood_block(dat_w, sctf2, a_term, pri[:, None].expand(n_cls, n_l, -1, -1),
                         tra_l, ones_r, ones_t, base, w_c, w_r, w_t,
                         col0=b_idx * block)
    top = torch.amax(base, dim=0)
    scale = torch.where(torch.isfinite(base), torch.exp(base - top),
                        torch.zeros_like(base))
    return ((w_c * scale).T.contiguous(), w_r * scale[..., None],
            w_t * scale[..., None])


def compare_refs(ref_a: torch.Tensor, ref_b: torch.Tensor, n_shells: int,
                 fsc: torch.Tensor | None = None, want_avg: bool = True,
                 nd: int = 3):
    """FSC between hemisphere references (K, n^nd) and averaging below
    the 0.95 crossing (Model::compareTwoHemispheres, Model.cpp:307-851).
    ``fsc`` given: the averaging shell comes from it.  Returns
    (fsc (K, n_shells), averaged a, averaged b)."""
    ax = tuple(range(-nd, 0))
    fa = torch.fft.fftshift(torch.fft.fftn(ref_a, dim=ax), dim=ax)
    fb = torch.fft.fftshift(torch.fft.fftn(ref_b, dim=ax), dim=ax)
    size = ref_a.shape[-1]
    if fsc is None:
        fsc = spectrum.fsc(fa, fb, n_shells, ndim=nd)
    else:
        fsc = torch.as_tensor(fsc, dtype=REAL, device=ref_a.device)[:, :n_shells]
    if not want_avg:
        return fsc, None, None
    below = fsc < 0.95
    below[:, 0] = False
    first = torch.argmax(below.to(torch.int32), dim=1)
    r_avg = torch.where(below.any(dim=1), first - 1,
                        torch.full_like(first, n_shells - 1))
    u = centered_shell_dev(size, nd, ref_a.device)
    sel = u[None] <= r_avg.reshape((-1,) + (1,) * nd)
    avg = (fa + fb) / 2
    back = lambda f: torch.fft.ifftn(torch.fft.ifftshift(f, dim=ax), dim=ax).real
    return fsc, back(torch.where(sel, avg, fa)), back(torch.where(sel, avg, fb))


def recentre_refs(refs: torch.Tensor, o_class: torch.Tensor,
                  nd: int = 3) -> torch.Tensor:
    """Translate references (..., n^nd) by -o (x/y only) with a phase
    ramp on the centered spectrum; o_class (..., 2)."""
    ax = tuple(range(-nd, 0))
    size = refs.shape[-1]
    k = torch.arange(size, dtype=REAL, device=refs.device) - size // 2
    ft = torch.fft.fftshift(torch.fft.fftn(refs, dim=ax), dim=ax)
    e = (Ellipsis,) + (None,) * nd
    ox, oy = o_class[..., 0][e], o_class[..., 1][e]
    phase = (2 * math.pi / size) * (k * ox + k[:, None] * oy)
    ft = ft * torch.polar(torch.ones_like(phase), phase)
    return torch.fft.ifftn(torch.fft.ifftshift(ft, dim=ax), dim=ax).real


def subtract_table(refs: torch.Tensor, pf: int, nd: int) -> torch.Tensor:
    """The padded, grid-corrected spectra of K references (K, n^nd), the
    whole (pf n)^nd box that projection over every pixel of an image
    reaches: (K, pf n, ...) complex64."""
    if nd == 2:
        return prepare_projectee_2d(refs, pf).ft.contiguous()
    return torch.stack([prepare_projectee_3d(r, pf).ft for r in refs]).contiguous()


def subtract_batch(ft_ori: torch.Tensor, ctf: CtfParams, table: torch.Tensor,
                   cls: torch.Tensor, top_r: torch.Tensor, eff_t: torch.Tensor,
                   size: int, pf: int, pixel_size: float) -> torch.Tensor:
    """Signal subtraction for a batch of images (saveSubtract,
    Optimiser.cpp:8418; thunder_tpu optimiser._subtract_batch): each
    image's class reference in ``table`` (:func:`subtract_table`),
    projected at its rank-1 pose over all size^2 pixels (HK1 in 3D, HK5
    in 2D; one launch for the batch), zero from radius size/2 - 1 on,
    shifted by ``eff_t`` (top_t - offset), times the full-image CTF, is
    taken from the original spectrum ``ft_ori`` (B, size, size); returns
    the real-space differences (B, size, size)."""
    nd = table.ndim - 1
    k = torch.arange(size, dtype=torch.int32, device=ft_ori.device) - size // 2
    ky, kx = torch.meshgrid(k, k, indexing="ij")
    i_col, i_row = kx.reshape(-1), ky.reshape(-1)
    pri = project_any(table, rotations(top_r, nd)[:, None], i_col, i_row, pf, cls)[:, 0]
    inside = (kx * kx + ky * ky < (size // 2 - 1) ** 2).reshape(-1)
    pri = torch.where(inside, pri, torch.zeros_like(pri))
    pri = pri * translate_phases_view(i_col, i_row, size, eff_t)
    return ifft2_centered(ft_ori - ctf_image(ctf, size, pixel_size)
                          * pri.reshape(-1, size, size))


# -- orchestration ------------------------------------------------------

def check_kernel_layout(cfg: ThunderConfig, lay: Layout) -> None:
    """Refuse the MKB insertion option on a layout whose 3D grids of the
    full box would shard over the data axis, at configuration time as
    thunder_tpu does (optimiser.py:1859-1878): the slab path inserts
    trilinearly only."""
    mb = (cfg.size * cfg.pf) ** 3 * 8 / 2 ** 20
    if (cfg.reco_kernel == "mkb" and not cfg.mode_2d and lay.data > 1
            and mb >= cfg.vol_shard_min_mb):
        raise ValueError(
            "reco_kernel='mkb' is incompatible with volume-sharded reconstruction "
            "(grids this size shard over the data axis, and the slab path has no "
            "MKB insertion).  Use reco_kernel='trilinear' (the reference default, "
            f"Config.h:97), or raise vol_shard_min_mb above {int(mb)} to keep "
            "whole-volume grids a rank.")


class HostFt:
    """The original spectra of a rank's images in host memory, with a
    per-image intensity scale applied on the device after each copy
    (thunder_tpu optimiser.HostFt; the reference's host-resident image
    store, Optimiser::allocPreCal).  ``data`` (nh, L, size, size)
    complex64 lies on the host, ``scale`` (nh, L) float32 on the device:
    the norm and scale corrections fold into the scale instead of
    rewriting the stack, and a copy times its scale is the resident
    stack's product (a complex64 value times a float32 scale).

    On a card the store is pinned (cudaHostRegister of the tensor as it
    is, not rounded up to a power of two as the caching host allocator
    would) and each copy runs with non_blocking=True on a side stream;
    a reader that names the next chunk (``ahead``) has that copy queued
    while it reads this one, and an event orders each copy before its
    reader.  On the CPU the store is a plain tensor: the caller's device
    decides, as everywhere in the port."""

    def __init__(self, shape: tuple, device: torch.device):
        self.device = device
        self.data = torch.empty(shape, dtype=COMPLEX)
        self.scale = torch.ones(tuple(shape[:2]), dtype=REAL, device=device)
        self._stream = None
        self._queued = None           # (key, raw copy, its event)
        self.copies = None            # (start, end event, bytes) since reset_copies
        if device.type == "cuda":
            import weakref

            rt = torch.cuda.cudart()
            n_bytes = self.data.numel() * self.data.element_size()
            err = rt.cudaHostRegister(self.data.data_ptr(), n_bytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"HostFt: cudaHostRegister of {n_bytes} bytes failed "
                                   f"({err})")
            self._stream = torch.cuda.Stream(device)
            weakref.finalize(self, _unpin, rt, self.data.data_ptr(), self._stream)

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)

    def put(self, sl: slice, ft: torch.Tensor) -> None:
        """Store the spectra ft (nh, n, size, size) of images ``sl``."""
        for h in range(ft.shape[0]):
            self.data[h, sl].copy_(ft[h])

    def fold(self, s: torch.Tensor, divide: bool = False) -> None:
        """Multiply (``divide``: divide) every image's scale by s (nh, L)."""
        if divide:
            self.scale.div_(s)
        else:
            self.scale.mul_(s)

    def _copy(self, h, sl: slice):
        """The raw spectra of images ``sl`` (of hemisphere h, or all) on
        the device, and the event its copy records (None on the CPU)."""
        src = self.data[:, sl] if h is None else self.data[h, sl]
        if self._stream is None:
            return src, None
        timed = self.copies is not None
        with torch.cuda.stream(self._stream):
            dst = torch.empty(src.shape, dtype=COMPLEX, device=self.device)
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            if h is None:
                for i in range(src.shape[0]):
                    dst[i].copy_(src[i], non_blocking=True)
            else:
                dst.copy_(src, non_blocking=True)
            done = torch.cuda.Event(enable_timing=timed)
            done.record()
        if timed:
            self.copies.append((start, done, src.numel() * src.element_size()))
        return dst, done

    def _fetch(self, h, sl: slice, ahead: slice | None) -> torch.Tensor:
        key = (h, sl.start, sl.stop)
        queued, self._queued = self._queued, None
        raw, done = (queued[1:] if queued is not None and queued[0] == key
                     else self._copy(h, sl))
        if ahead is not None and self._stream is not None:
            self._queued = ((h, ahead.start, ahead.stop),) + self._copy(h, ahead)
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            raw.record_stream(cur)
        return raw

    def chunk(self, sl: slice, ahead: slice | None = None) -> torch.Tensor:
        """Both hemispheres' spectra of images ``sl`` times their scale,
        (nh, n, size, size) on the device; ``ahead``: the chunk the
        caller reads next, whose copy is queued now."""
        return self._fetch(None, sl, ahead) * self.scale[:, sl, None, None]

    def get(self, h: int, sl: slice, ahead: slice | None = None) -> torch.Tensor:
        """Hemisphere h's spectra of images ``sl`` times their scale."""
        return self._fetch(h, sl, ahead) * self.scale[h, sl, None, None]

    def reset_copies(self) -> None:
        """Time the copies from now on (none is timed before a first call),
        for :meth:`copy_stats`."""
        self.copies = []

    def copy_stats(self) -> dict:
        """The copies since :meth:`reset_copies`: their count, bytes and
        milliseconds on the side stream (waits for them; zeros on the
        CPU)."""
        copies = self.copies or []
        ms = 0.0
        for start, done, _ in copies:
            done.synchronize()
            ms += start.elapsed_time(done)
        return dict(copies=len(copies), bytes=sum(c[2] for c in copies), ms=ms)


def _unpin(rt, ptr: int, stream) -> None:
    """Unregister a HostFt's store once its side stream's copies are done."""
    stream.synchronize()
    rt.cudaHostUnregister(ptr)


def ranks_on_card(device: torch.device, lay: Layout) -> int:
    """How many ranks of ``lay`` share this rank's device: those whose
    card is cuda:(rank % cards) as ours (parallel/distributed.py
    rank_device); every rank where the device is no card."""
    if lay.world == 1:
        return 1
    if device.type != "cuda":
        return lay.world
    n = torch.cuda.device_count()
    return sum(1 for r in range(lay.world) if r % n == lay.rank % n)


class StackedData(NamedTuple):
    """The images of a rank's hemispheres on a leading axis (2 on one
    process), padded to a common L (pads repeat real images and carry no
    insertion weight).  ``ft_ori`` is a :class:`HostFt` on the host path."""

    ft_masked: torch.Tensor    # (nh, L, size, size) complex64
    ft_ori: torch.Tensor       # (nh, L, size, size) complex64, or a HostFt
    ctf_params: CtfParams      # fields (nh, L)
    group_id: torch.Tensor     # (nh, L) int64


@dataclass
class StackedState:
    refs: torch.Tensor         # (nh, K, size^nd) real space
    sigma: torch.Tensor        # (nh, n_group, max_r)
    par: pt.ParticleState      # fields (nh, L, ...)
    cls: torch.Tensor          # (nh, L) int64


class Optimiser:
    """Host orchestration of one 3D refinement or 2D classification on
    one device, or on one rank of a (hemi, data) layout.

    With ``layout`` (parallel.mesh.Layout) the rank holds only its rows
    of the global (2, L) image grid (L rounded up to a multiple of the
    data extent, pads invalid) and its hemispheres' references, noise
    spectra and F / T: every state tensor's leading axes are
    (``self.nh`` hemispheres, ``self.n_img`` images).  The sums, maxima,
    medians and cross-hemisphere meetings that thunder_tpu's partitioner
    inserted are explicit calls of parallel.comm, each the identity on
    one process.  Random draws are made at the global shape and cut to
    the rank's rows (particle.RowDraws), and every host decision reads
    reduced values, so that every rank takes the same branch.
    ``image_loader(ids)`` reads the images of global ids (the rank's
    own only) where ``images`` is None."""

    def __init__(self, cfg: ThunderConfig, images: np.ndarray | None, ctf,
                 group_id: np.ndarray, init_refs: np.ndarray | None = None,
                 hemi_of: np.ndarray | None = None, resume_thu=None,
                 device=None, seed: int | None = None, layout: Layout | None = None,
                 image_loader=None):
        mask_px = cfg.mask_radius / cfg.pixel_size
        if not np.any(radial_grid(cfg.size, 2) > mask_px):
            raise ValueError(
                f"the image mask of {cfg.mask_radius} A ({mask_px:.1f} px) covers the "
                f"whole {cfg.size} px box: no pixel is left outside it to estimate the "
                "background from (Radius of Mask on Images)")
        self.cfg = cfg
        self.nd = nd = 2 if cfg.mode_2d else 3
        self.mode = pt.MODE_2D if cfg.mode_2d else pt.MODE_3D
        self.device = dev = as_device(device)
        self.gen = generator(cfg.seed if seed is None else seed, dev)
        self.sym = Symmetry("C1" if cfg.mode_2d else cfg.sym, dev)
        self.sym_form = symmetrize_form(self.sym.matrices)   # HK7's form, read once
        self.layout = lay = layout if layout is not None else single(dev)
        check_kernel_layout(cfg, lay)
        n = np.asarray(group_id).shape[0]
        if n < 2:
            raise ValueError("need at least one image per hemisphere")
        hemi_of = np.arange(n) % 2 if hemi_of is None else np.asarray(hemi_of)
        self.hemi_of = hemi_of
        self.n_total = n
        self.n_group = int(np.max(group_id)) + 1
        self.model = ModelState(
            n_class=cfg.k, size=cfg.size, pixel_size=cfg.pixel_size,
            r_init=cfg.r_init, r_global=cfg.r_global, max_r=cfg.max_r,
            l_search=cfg.l_search, c_search=cfg.c_search)
        if not cfg.g_search:
            self.model.search_type = SEARCH_TYPE_LOCAL
            self.model.r = min(cfg.max_r, max(self.model.r, self.model.r_global))

        sel = [np.nonzero(hemi_of == h)[0] for h in (0, 1)]
        if min(len(s) for s in sel) == 0:
            raise ValueError("a hemisphere is empty; both halves need images")
        # pads repeat real images and carry no weight; L splits over the
        # data axis (thunder_tpu optimiser.py:1905-1910)
        L = _round_up(max(len(s) for s in sel), lay.data)
        self.index = np.stack([np.resize(s, L) for s in sel])
        self.valid = np.stack([np.arange(L) < len(s) for s in sel])
        self.n_img_all = L
        # the rank's rows: thunder_tpu's per-process ingest
        # (optimiser.py:1919-1960), a rectangle of the (2, L) grid
        self.local_rows = h_sl, l_sl = local_block(process_local_rows(lay, L))
        self.hemis = lay.hemis
        self.nh = len(self.hemis)
        ids = self.index[h_sl, l_sl]
        self.n_img = ids.shape[1]
        self.n_local_loaded = ids.size
        # the residency plan, before any stack is built: it may turn the
        # host path (host_ft_ori) on
        self.residency_plan = self._plan_residency()
        flat = ids.reshape(-1)
        nh, n_l = self.nh, self.n_img
        s2 = (nh, n_l, cfg.size, cfg.size)
        ctf = CtfParams(*[torch.as_tensor(np.asarray(f, np.float32)[flat],
                                          device=dev).reshape(nh, n_l)
                          for f in ctf])
        group_id = torch.as_tensor(np.asarray(group_id)[flat].astype(np.int64),
                                   device=dev).reshape(nh, n_l)
        if cfg.host_ft_ori:
            ft_masked, ft_ori, sigma = self._preprocess_chunked(ids, images, image_loader)
            self.data = StackedData(ft_masked, ft_ori, ctf, group_id)
        else:
            imgs = (np.asarray(image_loader(flat), np.float32) if image_loader is not None
                    else np.asarray(images, np.float32)[flat])
            prep = preprocess_images(
                torch.as_tensor(imgs, device=dev),
                cfg.mask_radius / cfg.pixel_size, zero_mask=cfg.zero_mask)
            del imgs
            self.data = StackedData(
                ft_masked=prep.ft_masked.reshape(s2).contiguous(),
                ft_ori=prep.ft_ori.reshape(s2).contiguous(), ctf_params=ctf,
                group_id=group_id)
            sigma = [self._init_sigma(self.data.ft_ori[h]) for h in range(nh)]
        sigma = torch.stack([sg.expand(self.n_group, cfg.max_r) for sg in sigma]).contiguous()
        # draws at the global (2, L) shape, cut to this rank's rows
        self.draws = (self.gen if lay.world == 1
                      else pt.RowDraws(self.gen, self.hemis, L, l_sl))

        refs = (self._blank_refs() if init_refs is None
                else np.asarray(init_refs, np.float32))
        if refs.ndim == nd:
            refs = np.repeat(refs[None], cfg.k, axis=0)
        refs2 = torch.as_tensor(np.stack([refs] * nh), device=dev)

        n_d = cfg.m_l_d if cfg.c_search else 1
        flat = self.index.reshape(-1)       # every rank draws the global clouds
        if resume_thu is not None and not cfg.g_search:
            t = resume_thu
            par = pt.from_thu(
                t.quat[flat], t.trans[flat], t.std_trans[flat],
                np.stack([t.k1[flat], t.k2[flat], t.k3[flat]], axis=1),
                t.defocus_factor[flat], t.std_defocus_factor[flat],
                cfg.n_rot_local, cfg.m_l_t, n_d, self.gen, dev, self.mode)
            par = par.map(lambda a: lay.take(a.reshape((2, L) + a.shape[1:])).contiguous())
            cls = torch.as_tensor(lay.take(np.clip(t.class_id[flat], 0, cfg.k - 1)
                                           .astype(np.int64).reshape(2, L)), device=dev)
        else:
            par = pt.init_particles(self.gen, (2, L), cfg.n_rot_local,
                                    cfg.m_l_t, n_d, cfg.trans_s, dev, self.mode)
            # random initial classes (thunder_tpu optimiser.py:2013-2014)
            cls = (torch.randint(0, cfg.k, (2, L), generator=self.gen, device=dev)
                   if cfg.k > 1 else
                   torch.zeros((2, L), dtype=torch.int64, device=dev))
            if lay.world > 1:
                par, cls = par.map(lambda a: lay.take(a).contiguous()), lay.take(cls)
        self.state = StackedState(refs=refs2, sigma=sigma, par=par, cls=cls)
        self.offset = torch.zeros((nh, n_l, 2), dtype=REAL, device=dev)
        self.valid_all = torch.as_tensor(self.valid.astype(np.float32), device=dev)
        self.valid_dev = lay.take(self.valid_all).contiguous()
        self.round_records: list[dict] = []
        self._tables: dict = {}
        self._refs_report = None
        self._fsc_band = cfg.max_r
        self._ref_mask = None
        if cfg.perform_mask and cfg.mask_path:
            from thunder_tpu_torch.io.mrc import read_mrc

            self._ref_mask = torch.as_tensor(read_mrc(cfg.mask_path)[0], device=dev)
        self._soft_mask = soft_mask_weight(
            cfg.size, nd, cfg.mask_radius / cfg.pixel_size, EDGE_WIDTH_RL, dev)
        # the phase loop's table plan (_table_plan): the rung of the whole
        # batch, or the routing order (2, L) and its (count, rung) segments;
        # the rungs engaged so far (the plan's hysteresis)
        self._round_brick = None
        self._round_order = None
        self._round_segs = ()
        self._brick_used: set = set()

    # ------------------------------------------------------------------

    def _blank_refs(self) -> np.ndarray:
        cfg = self.cfg
        u = radial_grid(cfg.size, self.nd)
        blob = np.where(u < cfg.mask_radius / cfg.pixel_size, 1.0, 0.0
                        ).astype(np.float32)
        refs = np.repeat(blob[None], cfg.k, axis=0)
        rng = np.random.default_rng(cfg.seed)
        return refs * (1 + 0.01 * rng.standard_normal(refs.shape).astype(np.float32))

    def _init_sigma(self, ft: torch.Tensor) -> torch.Tensor:
        """Initial noise spectrum of one hemisphere from this rank's
        rows ft (n_img, size, size), its moments summed over the data
        group."""
        lay = self.layout
        if lay.data == 1:
            return init_sigma(ft, self.cfg.max_r)
        m = torch.stack([ft.sum(0), (ft.abs() ** 2).sum(0).to(COMPLEX)])
        m = comm.sum_data(lay, m) / self.n_img_all
        return init_sigma_from_moments(m[0], m[1].real, self.cfg.max_r)

    # -- residency ------------------------------------------------------

    def _plan_residency(self) -> dict:
        """The projected device bytes of this rank's resident state, and
        the host path turned on where they exceed the budget (thunder_tpu
        optimiser.py _plan_residency; the reference kept its original
        images in host memory always, Optimiser::allocPreCal).  Counted:
        both image stacks, the projection table ``proj_table`` keeps at
        the full band (the quad table or the plain cube), the (F, T)
        grids at the full band (this rank's slab on the slab path) and
        the float64 balance loop's live tensors over them, times
        RESIDENCY_HEADROOM for a round's transient tensors.  The budget
        is ``hbm_gb``, else THUNDER_HBM_GB, else the card's memory
        (NO_CARD_BUDGET_GB where the device is no card), shared by the
        ranks on one card.  With ``auto_residency`` the originals go to
        the host when the total exceeds it; a total still over it warns.
        The ranks then agree: every rank takes the host path where any
        rank takes it (a rank's share of a card and its budget may differ
        from another's, and the host path's stages issue other
        collectives than the resident path's).  Returns the plan, printed
        where it turns the host path on or warns."""
        cfg, lay, nd = self.cfg, self.layout, self.nd
        gib = 2 ** 30
        stack = self.nh * self.n_img * cfg.size ** 2 * 8
        crop = proj_crop_size(cfg.size, cfg.pf, cfg.max_r)
        quad = nd == 3 and quad_fits(2 * cfg.k, crop)
        table = self.nh * cfg.k * crop ** nd * (32 if quad else 8)
        grid_size = reco_grid_size(cfg.size, cfg.max_r)
        cells = self.nh * cfg.k * (grid_size * cfg.pf) ** nd
        if self._vol_sharded(grid_size):
            cells //= lay.data
        reco, balance = cells * 12, cells * BALANCE_BYTES_PER_CELL
        share = ranks_on_card(self.device, lay)
        budget = (cfg.hbm_gb or float(os.environ.get("THUNDER_HBM_GB", 0))
                  or self._device_hbm_gb()) / share
        plan = {
            "per_device_gb": {"ft_masked": stack / gib, "ft_ori": stack / gib,
                              "proj_table": table / gib, "reco_grids": reco / gib,
                              "balance_loop": balance / gib},
            "headroom_factor": RESIDENCY_HEADROOM,
            "budget_gb": budget,
            "layout": {"hemi": lay.hemi, "data": lay.data, "ranks_on_card": share},
        }
        total = RESIDENCY_HEADROOM * (2 * stack + table + reco + balance)
        over = cfg.auto_residency and total > budget * gib
        host = cfg.host_ft_ori or over
        if lay.world > 1:
            host = bool(comm.max_world(lay, torch.tensor([float(host)], device=self.device)))
        if host and not cfg.host_ft_ori:
            cfg.host_ft_ori = True
            plan["auto"] = "host_ft_ori" if over else "host_ft_ori (another rank's plan)"
        if cfg.host_ft_ori:
            total -= RESIDENCY_HEADROOM * stack
        plan["total_gb"] = total / gib
        if total > budget * gib:
            plan["warning"] = (
                f"projected {total / gib:.1f} GB a rank exceeds the {budget:.1f} GB "
                "budget even with host-resident originals; spread the images over more "
                "data ranks")
        if plan.get("auto") or plan.get("warning"):
            print(f"[residency] {plan}", flush=True)
        return plan

    def _device_hbm_gb(self) -> float:
        """The card's memory in GiB, or NO_CARD_BUDGET_GB where the device
        is no card."""
        if self.device.type == "cuda":
            return torch.cuda.get_device_properties(self.device).total_memory / 2 ** 30
        return NO_CARD_BUDGET_GB

    def _chunk_slices(self) -> list:
        step = self.cfg.host_ft_chunk
        return [slice(lo, min(self.n_img, lo + step)) for lo in range(0, self.n_img, step)]

    def _ft_chunks(self) -> list:
        """The image slices a reader of the original spectra takes: one
        over every image on the resident path, ``host_ft_chunk`` images
        at a time on the host path (thunder_tpu _ft_chunks)."""
        if not isinstance(self.data.ft_ori, HostFt):
            return [slice(0, self.n_img)]
        return self._chunk_slices()

    def _ft_ori_chunk(self, sl: slice, ahead: slice | None = None,
                      h: int | None = None) -> torch.Tensor:
        """The original spectra of images ``sl`` on the device, both
        hemispheres' or hemisphere h's (the resident stack's view, or a
        HostFt copy times its scale; ``ahead``: the next chunk, its copy
        queued now)."""
        ft = self.data.ft_ori
        if isinstance(ft, HostFt):
            return ft.chunk(sl, ahead) if h is None else ft.get(h, sl, ahead)
        return ft[:, sl] if h is None else ft[h, sl]

    def _ori_chunks(self):
        """(slice, spectra) over :meth:`_ft_chunks`, each chunk's copy
        queued while the caller reads the one before."""
        chunks = self._ft_chunks()
        for i, sl in enumerate(chunks):
            yield sl, self._ft_ori_chunk(sl, chunks[i + 1] if i + 1 < len(chunks) else None)

    def _preprocess_chunked(self, ids: np.ndarray, images, image_loader) -> tuple:
        """The host path's preprocessing, ``host_ft_chunk`` images of each
        hemisphere at a time (images read a chunk at a time too): the
        masked spectra assembled on the device, the originals written to
        a :class:`HostFt`, and each hemisphere's initial noise spectrum
        from the chunks' moments (thunder_tpu optimiser.py:1964-1980),
        so that no moment holds every image on the device in float32.
        With one chunk the sigma is the resident path's.  Returns
        (ft_masked, HostFt, [sigma of each hemisphere])."""
        cfg, dev, lay = self.cfg, self.device, self.layout
        nh, n_l, size = self.nh, self.n_img, cfg.size
        ft_masked = torch.empty((nh, n_l, size, size), dtype=COMPLEX, device=dev)
        store = HostFt((nh, n_l, size, size), dev)
        chunks = self._chunk_slices()
        m1 = torch.zeros((nh, size, size), dtype=COMPLEX, device=dev)
        m2 = torch.zeros((nh, size, size), dtype=REAL, device=dev)
        src = None if image_loader is not None else np.asarray(images)
        for sl in chunks:
            ids_c = ids[:, sl].reshape(-1)
            imgs = image_loader(ids_c) if src is None else src[ids_c]
            prep = preprocess_images(torch.as_tensor(np.asarray(imgs, np.float32), device=dev),
                                     cfg.mask_radius / cfg.pixel_size, zero_mask=cfg.zero_mask)
            shape = (nh, sl.stop - sl.start, size, size)
            ori = prep.ft_ori.reshape(shape)
            ft_masked[:, sl] = prep.ft_masked.reshape(shape)
            store.put(sl, ori)
            if len(chunks) > 1:
                m1 += ori.sum(1)
                m2 += (ori.abs() ** 2).sum(1)
        if len(chunks) == 1:
            return ft_masked, store, [self._init_sigma(ori[h]) for h in range(nh)]
        m = comm.sum_data(lay, torch.stack([m1, m2.to(COMPLEX)], 1)) / self.n_img_all
        return ft_masked, store, [init_sigma_from_moments(m[h, 0], m[h, 1].real, cfg.max_r)
                                  for h in range(nh)]

    def _rescale(self, s: torch.Tensor, divide: bool = False) -> None:
        """Multiply (``divide``: divide) every image's spectra by s (nh,
        L), in place: the masked stack, and the originals where they are
        resident; a HostFt folds s into its scale instead (the stack on
        the host is never rewritten)."""
        d = self.data
        apply = torch.Tensor.div_ if divide else torch.Tensor.mul_
        apply(d.ft_masked, s[..., None, None])
        if isinstance(d.ft_ori, HostFt):
            d.ft_ori.fold(s, divide)
        else:
            apply(d.ft_ori, s[..., None, None])

    def _median(self, x: torch.Tensor) -> float:
        """Median of a per-image quantity (nh, n_img) over every valid
        image of the run (all ranks' rows gathered)."""
        return _median(comm.all_gather_rows(self.layout, x), self.valid_all)

    def set_refs(self, refs: torch.Tensor) -> None:
        """Rebind the references; cached projection tables are dropped."""
        self.state.refs = refs
        self._tables = {}

    def _sync(self) -> None:
        synchronize(self.device)

    def _rings(self) -> PackedRings:
        return pack_rings(self.cfg.size, int(self.model.r), self.cfg.r_low,
                          device=self.device)

    def _pack_inputs(self, rings: PackedRings):
        cfg = self.cfg
        d = self.data
        return pack_inputs(d.ft_masked, d.ctf_params, self.state.sigma,
                           d.group_id, rings, cfg.size, float(cfg.pixel_size))

    def proj_table(self, r_u: int) -> torch.Tensor:
        """Padded, grid-corrected spectra (2, K, crop^nd) of the current
        references, cropped to what radius r_u reaches (cached until the
        references change).  A 3D table that stays near the L2 cache as
        HK1's quad table is kept in that layout, (2, K, crop^3, 8)
        float32 (ops/projector.py quad_taps): a round's ~90 projections
        read it; 2D planes stay as they are (HK5 finds them in L1)."""
        cfg = self.cfg
        crop = proj_crop_size(cfg.size, cfg.pf, r_u)
        if crop not in self._tables:
            prep = (prepare_projectee_2d_cropped if self.nd == 2
                    else prepare_projectee_3d_cropped)
            table = prep(self.state.refs, cfg.pf, crop).contiguous()
            if self.nd == 3 and quad_fits(2 * cfg.k, crop):
                table = quad_taps(table)
            self._tables[crop] = table
        return self._tables[crop]

    def _n_trans_global(self) -> int:
        cfg = self.cfg
        chi2q = 1.3862943611198906  # chisq Qinv(0.5, 2) = 2 ln 2
        n = int(round(math.pi * (cfg.trans_s * chi2q) ** 2
                      * cfg.trans_search_factor))
        return max(MIN_N_TRANSLATION_GLOBAL, n)

    # -- the projection-table plan -------------------------------------

    def _spread_devs(self, q: torch.Tensor | None = None) -> torch.Tensor:
        """The support deviations (2, L, R) of every image of the run
        (all ranks' rows), from clouds q (this rank's rows; default the
        state's)."""
        return comm.all_gather_rows(self.layout,
                                    spread_dev(self.state.par.r if q is None else q))

    def _brick_choice(self, r_u: int, mid_round: bool = False,
                      spread_q98: float | None = None):
        """The rung (span, stride) whose window holds the clouds at the
        phase band r_u, or None (thunder_tpu _brick_choice): the first
        rung of BRICK_LADDER admitted by the byte rules whose margin
        covers spread_q98 (radians; default the pooled 98th percentile of
        the support deviations) x kick x pf r_u cells, the kick 1.3 at a
        round's start and 1.15 at a chunk boundary (where the spread
        already holds a phase's perturbation).  A rung neither in use nor
        engaged before needs 0.8 of its margin (0.95 for span 8): the
        reference's hysteresis.  THUNDER_BRICK: "off", or "span,stride"
        to force a rung at a round's start.  2D never takes a rung; nor
        does a global round before its adoption."""
        cfg = self.cfg
        force = os.environ.get("THUNDER_BRICK", "")
        if cfg.mode_2d or force == "off":
            return None
        if force and not mid_round:
            span, stride = (int(v) for v in force.split(","))
            return (span, stride)
        if self.model.search_type == SEARCH_TYPE_GLOBAL and not mid_round:
            return None
        if spread_q98 is None:
            spread_q98 = pooled_q98(self._spread_devs(), self.valid_all)
        if not np.isfinite(spread_q98):
            return None
        kick = 1.15 if mid_round else 1.3
        spread_cells = spread_q98 * kick * cfg.pf * max(r_u, 1)
        crop = proj_crop_size(cfg.size, cfg.pf, r_u)
        for span, stride in BRICK_LADDER:
            if span >= 8 and crop ** 3 * 16 * cfg.k < BRICK_WIDE_MIN_BYTES:
                continue
            if table_bytes(span, stride, crop, cfg.k) > BRICK_TABLE_BUDGET:
                continue
            margin = spread_margin(span, stride)
            known = (self._round_brick == (span, stride)
                     or (span, stride) in self._brick_used)
            entry = 0.95 if span >= 8 else 0.8
            if spread_cells <= (margin if known else entry * margin):
                return (span, stride)
        return None

    def _route_bounds(self) -> tuple:
        """Each hemisphere's segment ends for routing, L/2, 3L/4, 7L/8 and
        L of its images over every rank (thunder_tpu _route_bounds); none
        under 32 images a hemisphere or with THUNDER_SPLIT=0."""
        n = self.n_img_all
        if os.environ.get("THUNDER_SPLIT", "1") == "0" or n < 32:
            return ()
        return tuple(b for b in sorted({n // 2, 3 * n // 4, 7 * n // 8, n}) if b > 0)

    def _table_plan(self, r_u: int, mid_round: bool = False, spread_img=None):
        """The phase loop's table plan at the phase band r_u (thunder_tpu
        _table_plan) -> (rung, order, segs):

        * (rung, None, ()): every image projects through ``rung`` (None:
          HK1), the rung of the largest per-image spread;
        * (rung, order, segs): routing; ``order`` (2, L) sorts each
          hemisphere's images by spread, ``segs`` ((count, rung), ...)
          covers them tightest first, each segment on the first rung
          that holds its widest cloud, segments of equal rung and count
          merged from the tail (counts stay L/8, L/4, L/2); ``rung`` is
          the first segment's.

        Routing needs the bounds of :meth:`_route_bounds` and a table
        past PLAN_TABLE_MIN_BYTES (THUNDER_SPLIT=force drops the latter).
        ``spread_img`` (2, L): the per-image spreads, where the caller
        has them."""
        cfg = self.cfg
        if os.environ.get("THUNDER_BRICK", "") or cfg.mode_2d or (
                self.model.search_type == SEARCH_TYPE_GLOBAL and not mid_round):
            return (self._brick_choice(r_u, mid_round), None, ())
        if spread_img is None:
            spread_img = per_image_q98(self._spread_devs(), self.valid_all)
        spread_img = np.nan_to_num(np.asarray(spread_img))
        sp = np.sort(spread_img, axis=1)
        bounds = self._route_bounds()
        crop = proj_crop_size(cfg.size, cfg.pf, r_u)
        forced = os.environ.get("THUNDER_SPLIT") == "force"
        if not bounds or (crop ** 3 * 16 <= PLAN_TABLE_MIN_BYTES and not forced):
            return (self._brick_choice(r_u, mid_round, spread_q98=float(sp[:, -1].max())),
                    None, ())
        segs, lo = [], 0
        for b in bounds:
            segs.append([b - lo, self._brick_choice(r_u, mid_round,
                                                    spread_q98=float(sp[:, b - 1].max()))])
            lo = b
        while len(segs) > 1 and segs[-1][1] == segs[-2][1] and segs[-1][0] == segs[-2][0]:
            segs[-2][0] += segs.pop()[0]
        if len(segs) == 1:
            return (segs[0][1], None, ())
        order = np.argsort(spread_img, axis=1).astype(np.int32)
        return (segs[0][1], order, tuple((n, r) for n, r in segs))

    def _plan_tag(self) -> str:
        """The record's ``proj_table``: "brick(span, stride)", with
        "+route[count:rung,...]" in a routed round (thunder_tpu's tag)."""
        tag = "brick%s" % (self._round_brick,)
        if self._round_order is not None:
            tag += "+route[%s]" % ",".join(f"{n}:{r or 'oct'}" for n, r in self._round_segs)
        return tag

    # -- expectation ----------------------------------------------------

    def expectation_global(self, rings: PackedRings, quats=None, trans=None):
        """Global search over a fresh random rotation grid per hemisphere,
        every class (``quats`` (2, n_rot, 4) / ``trans`` (2, N, 2) inject
        the grid); 2D draws uniform in-plane angles, mS(2D) of them."""
        cfg = self.cfg
        dev = self.device
        if quats is None:
            n_rot = (cfg.n_rot_global if cfg.mode_2d else
                     max(1, cfg.n_rot_global // (1 + self.sym.n_elements)))
            if n_rot > ROT_BLOCK:
                n_rot = _round_up(n_rot, ROT_BLOCK)
            if cfg.mode_2d:
                phi = torch.rand((2, n_rot), generator=self.gen, device=dev,
                                 dtype=REAL) * (2 * math.pi)
                quats = torch.stack([torch.cos(phi), torch.sin(phi),
                                     torch.zeros_like(phi), torch.zeros_like(phi)],
                                    dim=-1)
            else:
                quats = random_quat(self.gen, (2, n_rot), dev)
        if trans is None:
            trans = torch.randn((2, self._n_trans_global(), 2), generator=self.gen,
                                device=dev, dtype=REAL) * cfg.trans_s
        # one grid a hemisphere, drawn alike on every rank
        quats, trans = (replicated_per_hemi(self.layout, x) for x in (quats, trans))
        n_rot = quats.shape[1]
        block = min(ROT_BLOCK, n_rot)
        if n_rot % block:
            raise ValueError("the rotation grid must fill whole blocks")
        nd = self.nd
        rot = rotations(quats, nd).reshape(self.nh, n_rot // block, block, nd, nd)
        dat_w, sctf2, a_term = self._pack_inputs(rings)
        tra = translate_phases(rings, trans)
        table = self.proj_table(rings.r_u)
        outs = [global_search(table[h], rot[h], rings, dat_w[h], sctf2[h],
                              a_term[h], tra[h], cfg.pf) for h in range(self.nh)]
        w_c, w_r, w_t = (torch.stack([o[i] for o in outs]) for i in range(3))
        return dict(w_c=w_c, w_r=w_r, w_t=w_t, quats=quats, trans=trans)

    def adopt_global(self, g: dict) -> None:
        """Class draw, adoption of the grid as each image's support, peak
        clipping and resampling to the local support sizes
        (Optimiser.cpp:925-1118)."""
        cfg = self.cfg
        s = self.state
        mode = self.mode
        w_c = pt.clip_u_class(g["w_c"])                       # (2, L, K)
        w_c = w_c / torch.clamp(w_c.sum(-1, keepdim=True), min=1e-30)
        cls = pt.draw_classes(self.draws, w_c + 1e-30)
        n_rot, n_t = g["w_r"].shape[-1], g["w_t"].shape[-1]
        take = lambda w: torch.gather(
            w.permute(0, 2, 1, 3), 2,
            cls[:, :, None, None].expand(-1, -1, 1, w.shape[-1]))[:, :, 0]
        u_r, u_t = take(g["w_r"]), take(g["w_t"])              # (2, L, .)
        n_l = u_r.shape[1]
        dev = self.device
        b = (self.nh, n_l)
        ones = torch.ones(b, dtype=REAL, device=dev)
        par = pt.ParticleState(
            r=g["quats"][:, None].expand(self.nh, n_l, n_rot, 4),
            t=g["trans"][:, None].expand(self.nh, n_l, n_t, 2),
            d=s.par.d, w_r=torch.full(b + (n_rot,), 1.0 / n_rot, device=dev),
            w_t=torch.full(b + (n_t,), 1.0 / n_t, device=dev),
            w_d=s.par.w_d, u_r=u_r, u_t=u_t, u_d=s.par.u_d,
            top_r=torch.tensor([1.0, 0, 0, 0], device=dev).expand(b + (4,)),
            top_t=torch.zeros(b + (2,), device=dev), top_d=s.par.d[..., 0],
            k1=ones, k2=ones, k3=ones, s0=ones, s1=ones,
            s_d=torch.zeros(b, device=dev), score=torch.zeros(b, device=dev))
        par = pt.clip_u_t(pt.clip_u_r(par, mode))
        par = pt.resample_r(self.draws, par, cfg.n_rot_local)
        par = pt.resample_t(self.draws, par, cfg.m_l_t)
        s.par = pt.cal_vari_t(pt.cal_vari_r(par, mode))
        s.cls = cls

    def phase_step(self, par: pt.ParticleState, hemis: list, rings,
                   table, dat_w, sctf2, a_term, pf_small: float,
                   ctf: CtfTerms | None = None, sel: torch.Tensor | None = None,
                   runs=None, sizes=None):
        """One particle-filter phase for hemispheres ``hemis``: perturb ->
        project (HK1 / HK5, or HK13 through the round's brick rung) ->
        likelihood (HK2) -> clip -> resample -> variance inference
        (Optimiser.cpp:1183-1614).  With ``ctf``, the round's
        :func:`likelihood.ctf_terms` in CTF search, the defocus axis is
        perturbed, evaluated (HK8 in place of HK2, the CTF of every
        defocus support point formed there) and resampled too, and
        ``dat_w`` / ``sctf2`` are the CTF-free operands of
        :func:`pack_inputs_ctf` (dat_s, s_pack).  ``par`` holds the
        selected hemispheres (indices into this rank's hemispheres; their
        draws cover ``self.draws.running``); returns (par, vari
        (len(hemis), 4), the means over this rank's images).

        A routed round passes instead ``sel``, the images' flat indices
        into this rank's (nh L) grid, ``par`` (1, len(sel), ...),
        ``runs`` [(rung, count)] covering them (see
        :func:`project_phase`) and ``sizes``, the counts of its groups in
        order; vari is then (len(sizes), 4), each group's means over
        those images."""
        cfg = self.cfg
        mode, nd = self.mode, self.nd
        is_ctf = ctf is not None
        with _range("phase/perturb_r"):
            par = pt.perturb_r(self.draws, par, pf_small, mode=mode)
        with _range("phase/perturb_t"):
            par = pt.perturb_t(self.draws, par, pf_small, float(cfg.trans_s))
        if is_ctf:
            with _range("phase/perturb_d"):
                par = pt.perturb_d(self.draws, par, pf_small)
        nh, n_l, n_r = par.r.shape[:3]
        k_cls = table.shape[1]
        with _range("phase/translate_rotate"):
            rot = rotations(par.r, nd).reshape(nh * n_l, n_r, nd, nd)
            if sel is None:
                hs = torch.as_tensor(hemis, device=self.device)
                cls = (self.state.cls[hs] + hs[:, None] * k_cls).reshape(-1)
            else:
                hs = torch.arange(self.nh, device=self.device)
                cls = (self.state.cls + hs[:, None] * k_cls).reshape(-1)[sel]
        fold = lambda x: x.reshape((nh * n_l,) + x.shape[2:])
        # the selected images of a round's (2, L, ...) operand: views of
        # whole hemispheres, gathers of a routed selection
        if sel is not None:
            flat = lambda x: x.reshape((-1,) + x.shape[2:])[sel]
        else:
            flat = fold if nh == self.nh else (lambda x: x[hemis[0]])
        runs = runs or [(self._round_brick, nh * n_l)]
        # the images' (R + T) x P supports a block at a time: one block
        # where they fit PHASE_BLOCK_BYTES
        n_all = nh * n_l
        per_img = (n_r + par.t.shape[2]) * rings.i_col.numel() * 8
        step = max(1, min(n_all, PHASE_BLOCK_BYTES // per_img))
        outs = []
        for lo in range(0, n_all, step):
            b = slice(lo, min(n_all, lo + step))
            one = step == n_all
            blk = (lambda x: x) if one else (lambda x: x[b])
            # the round's operands of the block's images (views; a routed
            # block gathers only its own)
            if one:
                img = flat
            elif sel is not None:
                img = lambda x: x.reshape((-1,) + x.shape[2:])[sel[b]]
            else:
                img = lambda x: flat(x)[b]
            with _range("phase/translate_rotate"):
                tra = translate_phases_view(rings.i_col, rings.i_row, cfg.size,
                                            blk(fold(par.t)))
            with _range("phase/project"):
                pri = project_phase(table.reshape((-1,) + table.shape[2:]), blk(rot),
                                    blk(cls), rings, cfg.pf, _cut_runs(runs, b))
            with _range("phase/local_marginals"):
                if is_ctf:
                    outs.append(likelihood_local_ctf(
                        img(dat_w), img(sctf2), ctf.images(img), blk(fold(par.d)), pri, tra,
                        img(a_term), blk(fold(par.w_r)), blk(fold(par.w_t)),
                        blk(fold(par.w_d))))
                else:
                    outs.append(local_marginals(img(dat_w), img(sctf2), img(a_term), pri, tra,
                                                blk(fold(par.w_r)), blk(fold(par.w_t))))
            del tra, pri
        u = outs[0] if len(outs) == 1 else [torch.cat(us) for us in zip(*outs)]
        if is_ctf:
            par = par._replace(u_d=u[2].reshape(nh, n_l, -1))
        par = par._replace(u_r=u[0].reshape(nh, n_l, -1), u_t=u[1].reshape(nh, n_l, -1))
        with _range("phase/clip_u_r"):
            par = pt.clip_u_r(par, mode)
        with _range("phase/resample_r"):
            par = pt.resample_r(self.draws, par, n_r)
        with _range("phase/resample_t"):
            par = pt.resample_t(self.draws, par, par.t.shape[-2])
        if is_ctf:
            with _range("phase/resample_d"):
                par = pt.resample_d(self.draws, par, par.d.shape[-1])
        with _range("phase/cal_vari_r"):
            par = pt.cal_vari_r(par, mode)
        with _range("phase/cal_vari_t"):
            par = pt.cal_vari_t(par)
            if is_ctf:
                par = pt.cal_vari_d(par)
            if sel is None:
                vari = torch.stack([par.k1.mean(-1), par.s0.mean(-1), par.s1.mean(-1),
                                    par.s_d.mean(-1)], dim=-1)
            else:
                v = torch.stack([par.k1[0], par.s0[0], par.s1[0], par.s_d[0]], dim=-1)
                vari = torch.stack([g.mean(0) for g in torch.split(v, sizes)])
        return par, vari

    def local_phases(self, rings: PackedRings) -> list:
        """The adaptive phase loop with the variance-stall rule checked on
        the host after every phase, per hemisphere
        (PARTICLE_FILTER_DECREASE_FACTOR 0.95, N_PHASE_WITH_NO_VARI_DECREASE
        1, stalls counted from the minimum phase count on; the defocus
        variance is the rule's fourth term, constant outside CTF search).
        A CTF-search round scatters the defocus support anew around 1 at
        its start (Particle::initD, Optimiser.cpp:1195-1196).

        The phases project through the round's table plan
        (``_table_plan``, set by run_round): a brick rung for the whole
        batch, or routed segments of images, each (hemisphere, segment)
        group running the stall rule over its own images.  Where the
        table is large (crop^3 x 16 bytes past PLAN_TABLE_MIN_BYTES) and
        the plan has a corner-row part, the loop stops at chunk
        boundaries (THUNDER_PHASE_CHUNK phases, 4 in global rounds and 2
        in others, then 2, 4, 8... times that), merges each hemisphere's
        groups (phase by max, stall count by min, previous variances by
        max) and adopts the plan of the tightened clouds, as
        thunder_tpu's driver does (optimiser.py:2651-2727).  Returns the
        phase count of each hemisphere."""
        cfg = self.cfg
        s = self.state
        is_global = self.model.search_type == SEARCH_TYPE_GLOBAL
        is_ctf = self.model.search_type == SEARCH_TYPE_CTF and cfg.c_search
        min_phase = (MIN_N_PHASE_PER_ITER_GLOBAL if is_global
                     else MIN_N_PHASE_PER_ITER_LOCAL)
        pf_small = float(cfg.perturb_factor_s_global if is_global
                         else (cfg.perturb_factor_s_ctf if is_ctf
                               else cfg.perturb_factor_s_local))
        if is_ctf:
            s.par = pt.init_d_round(self.draws, s.par, float(cfg.ctf_refine_s))
            d = self.data
            dat_w, sctf2, a_term = pack_inputs_ctf(d.ft_masked, s.sigma,
                                                   d.group_id, rings)
            ctf = ctf_terms(d.ctf_params, rings.i_col, rings.i_row, cfg.size,
                            float(cfg.pixel_size))
        else:
            dat_w, sctf2, a_term = self._pack_inputs(rings)
            ctf = None
        ops = (rings, self.proj_table(rings.r_u), dat_w, sctf2, a_term, pf_small, ctf,
               min_phase)
        big = float(np.finfo(np.float32).max)
        # each hemisphere's stall state: [phase, n_no_dec, previous variances]
        state = [[0, 0, [big] * 4] for _ in (0, 1)]
        # the draws of a phase this rank stepped (several ranks): a phase
        # that steps none of its images replays them
        self._step_log = None
        par = s.par.map(lambda a: a.contiguous())
        chunk = int(os.environ.get("THUNDER_PHASE_CHUNK", 4 if is_global else 2))
        crop = proj_crop_size(cfg.size, cfg.pf, rings.r_u)
        chunking = chunk > 0 and not cfg.mode_2d and crop ** 3 * 16 > PLAN_TABLE_MIN_BYTES
        phases_done = n_boundary = 0
        while True:
            routed = self._round_order is not None
            # a boundary can engage a rung for the corner-row part: none
            # where every image already projects through one
            boundary = chunking and (
                (self._round_brick is None and not routed)
                or (routed and any(r is None for _, r in self._round_segs)))
            nxt = (min(phases_done + chunk * 2 ** n_boundary, MAX_N_PHASE_PER_ITER)
                   if boundary else MAX_N_PHASE_PER_ITER)
            run = self._phases_routed if routed else self._phases_batch
            par, state = run(par, state, nxt, *ops)
            if nxt >= MAX_N_PHASE_PER_ITER or all(
                    ph >= MAX_N_PHASE_PER_ITER
                    or (ph >= min_phase and nnd >= N_PHASE_WITH_NO_VARI_DECREASE)
                    for ph, nnd, _ in state):
                break
            n_boundary += 1
            phases_done = max(st[0] for st in state)
            (self._round_brick, self._round_order,
             self._round_segs) = self._table_plan(
                rings.r_u, mid_round=True,
                spread_img=per_image_q98(self._spread_devs(par.r), self.valid_all))
            if self._round_brick is not None:
                self._brick_used.add(self._round_brick)
        par = pt.cal_score(par, self.mode)
        # the rank-1 rotation folds into the asymmetric unit in 3D only
        # (thunder_tpu's _finish_phases: sym.order > 1 and not 2D)
        s.par = par if cfg.mode_2d else pt.symmetrise_top(par, self.sym)
        return [st[0] for st in state]

    @staticmethod
    def _running(st: list, max_phase: int, min_phase: int) -> bool:
        return st[0] < max_phase and (st[0] < min_phase
                                      or st[1] < N_PHASE_WITH_NO_VARI_DECREASE)

    @staticmethod
    def _stall(st: list, vari, min_phase: int) -> None:
        """One phase of the variance-stall rule on a group's state
        [phase, n_no_dec, previous variances], given the group's mean
        (k1, s0, s1, s_d)."""
        f = PARTICLE_FILTER_DECREASE_FACTOR
        k1, s0, s1, sd = (float(v) for v in vari)
        pk1, ps0, ps1, psd = st[2]
        dec = k1 < pk1 * f or s0 < ps0 * f or s1 < ps1 * f or sd < psd * f
        st[1] = (0 if dec else st[1] + 1) if st[0] + 1 >= min_phase else 0
        st[0] += 1
        st[2] = [k1, s0, s1, sd]

    def _phases_batch(self, par, state, max_phase, rings, table, dat_w, sctf2, a_term,
                      pf_small, ctf, min_phase):
        """Phases of every running hemisphere, its images together,
        until each stalls or reaches ``max_phase``: the phase loop of
        rounds that do not route.  On several ranks a rank holds a block
        of every hemisphere's rows and draws at the global shape, so the
        stall means meet over the world a hemisphere at a time
        (:meth:`_group_means`) and a rank whose hemispheres have stopped
        replays the draws of a phase it stepped.  On one rank
        :meth:`_phases_routed` with one group a hemisphere gives this
        loop's bits (tests/test_torch_routed_round.py); this one works on
        views of whole hemispheres where that one gathers and scatters
        every operand a phase."""
        multi = self.layout.world > 1
        while True:
            run = [h for h in (0, 1) if self._running(state[h], max_phase, min_phase)]
            if not run:
                break
            # this rank's hemispheres among those still running
            mine = [i for i, h in enumerate(self.hemis) if h in run]
            if multi:
                self.draws.running = tuple(run)
                self.draws.log = [] if mine else None
            if mine:
                sub = par if len(mine) == self.nh else par.map(lambda a: a[mine])
                sub, vari = self.phase_step(sub, mine, rings, table, dat_w,
                                            sctf2, a_term, pf_small, ctf)
                if len(mine) == self.nh:
                    par = sub
                else:
                    par = par.map(lambda a: a.clone())
                    for fld, new in zip(par, sub):
                        fld[mine] = new
                if multi:
                    self._step_log = self.draws.log
            else:
                # this hemisphere has stopped, the other runs on: draw what
                # its phase draws, so that the generator stays in step
                self.draws.replay(self._step_log)
                vari = None
            vari = self._group_means(vari, [self.n_img if h in self.hemis else 0 for h in run],
                                     [self.n_img_all] * len(run))
            for i, h in enumerate(run):
                self._stall(state[h], vari[i], min_phase)
        if multi:
            self.draws.running, self.draws.log = (0, 1), None
        return par, state

    def _phases_routed(self, par, state, max_phase, rings, table, dat_w, sctf2, a_term,
                       pf_small, ctf, min_phase):
        """Phases of a routed round: each (hemisphere, segment) group of
        the routing order (global rows, the same on every rank) runs the
        stall rule over its own images from its hemisphere's state, until
        it stalls or reaches ``max_phase``; a phase steps every running
        group's images at once, projecting them rung by rung.  The images
        are independent (the reference's loop is per image,
        Optimiser.cpp:1183), so the groups meet only here, where each
        hemisphere's state becomes its groups' merge
        (:func:`merge_segment_states`: a tight group's small variances
        must not fake a stall in a wide one).

        On several ranks (thunder_tpu routes on its mesh, run_routed) a
        rank steps the members it holds: the phase's draws are made at
        the running groups' global selection and cut to them
        (particle.RowDraws.select), a rank holding none replays a phase
        it stepped, and each group's stall means are its members' sums
        over the world over its size (:meth:`_group_means`), so every
        rank runs the same phases."""
        n_all, order = self.n_img_all, self._round_order
        multi = self.layout.world > 1
        groups = []
        for h in (0, 1):
            lo = 0
            for n, rung in self._round_segs:
                groups.append((h, rung, h * n_all + order[h, lo:lo + n].astype(np.int64),
                               [state[h][0], state[h][1], list(state[h][2])]))
                lo += n
        same_rung_together = lambda g: (g[1] is None, g[1] or ())
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        while True:
            run = sorted((g for g in groups if self._running(g[3], max_phase, min_phase)),
                         key=same_rung_together)
            if not run:
                break
            rows = np.concatenate([g[2] for g in run])
            sizes = [len(g[2]) for g in run]
            if multi:
                held = self.draws.select(rows)
                counts = [int(m.sum()) for m in np.split(held, np.cumsum(sizes)[:-1])]
                mine = self.draws.local_rows(rows[held])
                self.draws.log = [] if len(mine) else None
            else:
                counts, mine = sizes, rows
            vari = None
            if len(mine):
                sel = torch.as_tensor(mine, device=self.device)
                runs = []
                for g, c in zip(run, counts):
                    if not c:
                        continue
                    if runs and runs[-1][0] == g[1]:
                        runs[-1][1] += c
                    else:
                        runs.append([g[1], c])
                sub, vari = self.phase_step(
                    par.map(lambda a: flat(a)[sel][None]), None, rings, table, dat_w, sctf2,
                    a_term, pf_small, ctf, sel=sel, runs=runs, sizes=[c for c in counts if c])
                par = pt.ParticleState(*[flat(a).index_copy(0, sel, b[0]).reshape(a.shape)
                                         for a, b in zip(par, sub)])
                if multi:
                    self._step_log = self.draws.log
            else:
                self.draws.replay(self._step_log)
            vari = self._group_means(vari, counts, sizes)
            for g, v in zip(run, vari):
                self._stall(g[3], v, min_phase)
        if multi:
            self.draws.select(None)
            self.draws.log = None
        return par, [merge_segment_states([g[3] for g in groups if g[0] == h]) for h in (0, 1)]

    def _group_means(self, vari, counts: list, sizes: list) -> np.ndarray:
        """The stall rule's variances (len(sizes), 4) of each running
        group (a hemisphere, or a routed round's (hemisphere, segment)
        group) over all its images: ``vari`` holds this rank's means over
        its members, one row a group of non-zero ``counts`` (None where it
        holds none); on several ranks the float64 sums meet over the
        world and are divided by the groups' ``sizes``, so every rank
        reads the same values and runs the same phases."""
        if self.layout.world == 1:
            return vari.cpu().numpy()
        sums = torch.zeros((len(sizes), 4), dtype=torch.float64, device=self.device)
        if vari is not None:
            have = [i for i, c in enumerate(counts) if c]
            sums[have] = vari.double() * torch.as_tensor(
                [counts[i] for i in have], dtype=torch.float64, device=self.device)[:, None]
        sums = comm.sum_world(self.layout, sums) / torch.as_tensor(
            sizes, dtype=torch.float64, device=self.device)[:, None]
        return sums.cpu().numpy()

    # -- maximization ---------------------------------------------------

    def maximization_stats(self, i_round: int) -> None:
        """normCorrection + allReduceSigma (+ scale correction) over one
        rank-1 projection pass (optimiser._max_stats_h): per-image shell
        sums d2 = sum |dat|^2, xa = sum Re(dat conj(m)), aa = sum |m|^2
        (m = ctf tra pri; HK4), the norm-band median rescale s, and the
        closed-form sigma of the rescaled residual s^2 d2 - 2 s xa + aa.
        Where one chunk holds every image: the resident stack, or a
        HostFt whose scale takes the rescale (thunder_tpu multiplies its
        HostFt there and raises, optimiser.py:2819-2828); run_round
        takes the two-pass form (:meth:`norm_correction`,
        :meth:`refresh_sigma`, :meth:`correct_scale`) over several."""
        cfg = self.cfg
        s = self.state
        d = self.data
        dev = self.device
        is_global = self.model.search_type == SEARCH_TYPE_GLOBAL
        do_norm = i_round != 0 and not is_global
        do_scale = is_global and cfg.group_scl and i_round != 0
        r_lo = int(self.model.r_u)
        max_r = cfg.max_r
        rings = pack_rings(cfg.size, r_lo, 0, lane=512, device=dev)
        rings_hi = pack_rings(cfg.size, max_r, r_lo, lane=512, device=dev)
        r_norm = max(min(int(self.model.r), self.model.resolution_p(0.75)),
                     cfg.r_low + 2)
        r_s = max(2, min(int(self.model.r), cfg.res_a2p(cfg.sclCor_res)))

        n_l, nh, lay = self.n_img, self.nh, self.layout
        sl = slice(0, n_l)
        ft = self._ft_ori_chunk(sl)          # one chunk: the stack, or all of a HostFt
        dat, ctf, pri, tra = self._rank1(ft, sl, rings, self.proj_table(r_lo))
        dat_hi = extract_packed(ft, rings_hi)
        del ft
        m = ctf * tra * pri
        mask = rings.mask
        d2px = dat.abs() ** 2 * mask
        xapx = (dat * m.conj()).real * mask
        aapx = m.abs() ** 2 * mask
        n_sh = max_r + 1
        shell = torch.clamp(rings.i_sig, max=max_r)
        shell_hi = torch.clamp(rings_hi.i_sig, max=max_r)
        per_px = torch.stack([d2px, xapx, aapx], dim=2).reshape(nh * n_l, 3, -1)
        sums = shell_sums(per_px.contiguous(), shell, n_sh).reshape(nh, n_l, 3, n_sh)
        hi = (dat_hi.abs() ** 2 * rings_hi.mask).reshape(nh * n_l, 1, -1)
        d2 = sums[:, :, 0] + shell_sums(hi.contiguous(), shell_hi, n_sh
                                        ).reshape(nh, n_l, n_sh)
        xa, aa = sums[:, :, 1], sums[:, :, 2]

        fi = rings.i_sig.to(REAL)
        q = (rings.i_col * rings.i_col + rings.i_row * rings.i_row).to(REAL)
        lo, hi_r = float(cfg.r_low), float(r_norm)
        norm_band = mask * (fi >= lo) * (fi < hi_r) * (q >= lo * lo) * (q < hi_r * hi_r)
        scl_band = mask * (fi < r_s) * (q < r_s * r_s)
        norm_l = torch.sum((d2px - 2 * xapx + aapx) * norm_band, dim=-1)
        xa_l = torch.sum(xapx * scl_band, dim=-1)
        aa_l = torch.sum(aapx * scl_band, dim=-1)

        valid = self.valid_dev
        if do_norm:
            # the median over every valid image of the run
            norm_all = comm.all_gather_rows(lay, norm_l)
            med = torch.nanquantile(torch.where(self.valid_all > 0, norm_all, float("nan")
                                                ).reshape(-1), 0.5)
            s_norm = torch.sqrt(med / torch.clamp(norm_l, min=1e-30))
        else:
            s_norm = torch.ones_like(norm_l)
        s1 = s_norm[..., None]
        sig = s1 * s1 * d2 - 2 * s1 * xa + aa                   # (nh, L, S)
        g_onehot = ((d.group_id[..., None]
                     == torch.arange(self.n_group, device=dev)).to(REAL)
                    * valid[..., None])                          # (nh, L, G)
        # each group's sums over the hemisphere's images (psum over data)
        sig_sum = comm.sum_data(lay, torch.einsum("hlg,hls->hgs", g_onehot, sig)) / 2
        cnt_shell = (shell_sums(mask[None, None].contiguous(), shell, n_sh)[0, 0]
                     + shell_sums(rings_hi.mask[None, None].contiguous(),
                                  shell_hi, n_sh)[0, 0])
        cnt_sum = comm.sum_data(lay, g_onehot.sum(1))[..., None] * cnt_shell
        sigma = sig_sum[..., :max_r] / torch.clamp(cnt_sum[..., :max_r], min=1.0)
        s.sigma = torch.clamp(sigma, min=1e-6).contiguous()

        if do_norm:
            self._rescale(s_norm)
        elif do_scale:
            # per-group scale (refreshScale with group_scl, as
            # thunder_tpu._max_stats_h's group branch)
            scale_g = (comm.sum_data(lay, torch.einsum("hlg,hl->hg", g_onehot, xa_l))
                       / torch.clamp(comm.sum_data(lay, torch.einsum("hlg,hl->hg",
                                                                     g_onehot, aa_l)),
                                     min=1e-30))
            self._rescale(torch.gather(scale_g, 1, d.group_id), divide=True)
            s.sigma = s.sigma / scale_g[..., None] ** 2

    def _rank1(self, ft: torch.Tensor, sl: slice, rings: PackedRings, table: torch.Tensor):
        """Images ``sl`` at their rank-1 pose, from their spectra ft (nh,
        n, size, size): (dat, ctf, pri, tra), each (nh, n, P) at the
        rings' pixels: the packed spectra, their CTF, the projection of
        their class's reference (HK1 / HK5, one launch) and the phases of
        their shift less the offset."""
        cfg, s, nd, nh = self.cfg, self.state, self.nd, self.nh
        n = sl.stop - sl.start
        hs = torch.arange(nh, device=self.device)[:, None]
        ctf = ctf_packed(self.data.ctf_params.map(lambda a: a[:, sl]), rings.i_col,
                         rings.i_row, cfg.size, float(cfg.pixel_size))
        pri = project_any(table.reshape((-1,) + table.shape[2:]),
                          rotations(s.par.top_r[:, sl], nd).reshape(nh * n, 1, nd, nd),
                          rings.i_col, rings.i_row, cfg.pf,
                          (s.cls[:, sl] + hs * table.shape[1]).reshape(-1)).reshape(nh, n, -1)
        tra = translate_phases_view(rings.i_col, rings.i_row, cfg.size,
                                    (s.par.top_t - self.offset)[:, sl, None, :])[..., 0, :]
        return extract_packed(ft, rings), ctf, pri, tra

    def _resid_stats(self, rings: PackedRings, table: torch.Tensor) -> tuple:
        """Each image's rank-1 residual norm sum |dat - ctf pri|^2 and the
        scale's sums xa = sum Re(dat conj(pri)) ctf, aa = sum |pri|^2
        ctf^2 over the rings' pixels (pri with its shift's phases), a
        chunk of the originals at a time (thunder_tpu _resid_stats):
        (norm, xa, aa), each (nh, L)."""
        outs = []
        for sl, ft in self._ori_chunks():
            dat, ctf, pri, tra = self._rank1(ft, sl, rings, table)
            prit = pri * tra
            mask = rings.mask
            outs.append(torch.stack([
                torch.sum((dat - ctf * prit).abs() ** 2 * mask, -1),
                torch.sum((dat * prit.conj()).real * ctf * mask, -1),
                torch.sum(prit.abs() ** 2 * ctf * ctf * mask, -1)]))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
        return out[0], out[1], out[2]

    def norm_correction(self) -> None:
        """Scale each image so that its residual noise power in the norm
        band [r_low, r_norm) is the median's (normCorrection,
        Optimiser.cpp:6201-6394; thunder_tpu norm_correction): images *=
        sqrt(median / norm_l), the median over every valid image of the
        run taken before sigma accumulates (the two-pass form of the host
        path; folded into the HostFt's scale there)."""
        cfg = self.cfg
        r_norm = max(min(int(self.model.r), self.model.resolution_p(0.75)), cfg.r_low + 2)
        rings = pack_rings(cfg.size, r_norm, cfg.r_low, lane=512, device=self.device)
        norms, _, _ = self._resid_stats(rings, self.proj_table(int(self.model.r_u)))
        norm_all = comm.all_gather_rows(self.layout, norms)
        med = torch.nanquantile(torch.where(self.valid_all > 0, norm_all, float("nan")
                                            ).reshape(-1), 0.5)
        self._rescale(torch.sqrt(med / torch.clamp(norms, min=1e-30)))

    def refresh_sigma(self) -> None:
        """Each group's noise spectrum from the rank-1 residual over every
        shell, a chunk of the originals at a time (allReduceSigma,
        Optimiser.cpp:6397-6709; thunder_tpu refresh_sigma): below the
        reconstruction radius r_u the residual of the projected
        reference, above it the plain data power; the chunks' shell sums
        (HK4's row form) add in chunk order, then over the data group."""
        cfg, s, d, dev = self.cfg, self.state, self.data, self.device
        r_lo, max_r, lay = int(self.model.r_u), cfg.max_r, self.layout
        rings = pack_rings(cfg.size, r_lo, 0, lane=512, device=dev)
        rings_hi = pack_rings(cfg.size, max_r, r_lo, lane=512, device=dev)
        table = self.proj_table(r_lo)
        n_sh = max_r + 1
        shell = torch.clamp(rings.i_sig, max=max_r)
        shell_hi = torch.clamp(rings_hi.i_sig, max=max_r)
        g_onehot = ((d.group_id[..., None] == torch.arange(self.n_group, device=dev)).to(REAL)
                    * self.valid_dev[..., None])                # (nh, L, G)
        sig_sum = 0
        for sl, ft in self._ori_chunks():
            dat, ctf, pri, tra = self._rank1(ft, sl, rings, table)
            n_c = sl.stop - sl.start
            power = ((dat - ctf * tra * pri).abs() ** 2 * rings.mask).reshape(
                self.nh * n_c, 1, -1)
            power_hi = (extract_packed(ft, rings_hi).abs() ** 2 * rings_hi.mask).reshape(
                self.nh * n_c, 1, -1)
            sums = (shell_sums(power.contiguous(), shell, n_sh)
                    + shell_sums(power_hi.contiguous(), shell_hi, n_sh)).reshape(
                self.nh, n_c, n_sh)
            sig_sum = sig_sum + torch.einsum("hlg,hls->hgs", g_onehot[:, sl], sums)
        sig_sum = comm.sum_data(lay, sig_sum) / 2
        cnt_shell = (shell_sums(rings.mask[None, None].contiguous(), shell, n_sh)[0, 0]
                     + shell_sums(rings_hi.mask[None, None].contiguous(), shell_hi, n_sh)[0, 0])
        cnt_sum = comm.sum_data(lay, g_onehot.sum(1))[..., None] * cnt_shell
        s.sigma = torch.clamp(sig_sum[..., :max_r] / torch.clamp(cnt_sum[..., :max_r], min=1.0),
                              min=1e-6).contiguous()

    def refresh_scale(self, r_s: int | None = None, group: bool | None = None) -> torch.Tensor:
        """The intensity scale of the data against the references, sum
        Re(dat conj(ctf pri)) / sum ctf^2 |pri|^2 below shell ``r_s`` at
        the rank-1 pose, per group with ``group`` (default
        ``group_scl``), else one a hemisphere (refreshScale,
        Optimiser.cpp:5749-6063; thunder_tpu refresh_scale): (nh,
        n_group)."""
        cfg, d, lay, dev = self.cfg, self.data, self.layout, self.device
        group = cfg.group_scl if group is None else group
        if r_s is None:
            r_s = max(2, min(int(self.model.r), cfg.res_a2p(cfg.sclCor_res)))
        rings = pack_rings(cfg.size, r_s, 0, lane=512, device=dev)
        _, xa, aa = self._resid_stats(rings, self.proj_table(r_s))
        xa, aa = xa * self.valid_dev, aa * self.valid_dev
        if group:
            # each group's sums as a one-hot product (a float scatter_add
            # on the card adds in a run-dependent order)
            g_onehot = (d.group_id[..., None]
                        == torch.arange(self.n_group, device=dev)).to(REAL)
            return (comm.sum_data(lay, torch.einsum("hlg,hl->hg", g_onehot, xa))
                    / torch.clamp(comm.sum_data(lay, torch.einsum("hlg,hl->hg", g_onehot, aa)),
                                  min=1e-30))
        return (comm.sum_data(lay, xa.sum(1))
                / torch.clamp(comm.sum_data(lay, aa.sum(1)), min=1e-30))[:, None].expand(
            self.nh, self.n_group)

    def correct_scale(self, init: bool = False) -> None:
        """Apply :meth:`refresh_scale` (correctScale, Optimiser.cpp:5103-5143):
        ``init`` scales the references by each hemisphere's first group's
        scale; else the images are divided by their group's scale (folded
        into the HostFt's scale on the host path) and the noise spectra
        by its square (thunder_tpu correct_scale).  run_round calls it
        in a global round with ``group_scl`` on the host path's two-pass
        form; it is also the entry for a caller who starts from images on
        another scale than the references (a run set straight into local
        or CTF search on a given model)."""
        scale = self.refresh_scale()
        s = self.state
        if init:
            self.set_refs(s.refs * scale[:, 0].reshape((-1,) + (1,) * (s.refs.ndim - 1)))
            return
        self._rescale(torch.gather(scale, 1, self.data.group_id), divide=True)
        s.sigma = s.sigma / scale[..., None] ** 2

    # -- reconstruction -------------------------------------------------

    def reconstruct_round(self, draws=None):
        """Draw poses, compact them, and insert both hemispheres' slices
        into per-class (F, T) grids with thunder_tpu's shear-sweep map
        — in 3D HK11 (HK10 with reco_kernel "mkb") once a hemisphere and
        class on that class's slices, then HK7 over the 2K grids where
        the point group has mates; in 2D HK12 (HK6 with "mkb"; one
        launch for both hemispheres' 2K planes) (reconstructRef,
        Optimiser.cpp:6711-7233; thunder_tpu optimiser.py:1273, :1305,
        :1400).  On the host path each launch takes a chunk of the
        originals (thunder_tpu optimiser.py:3095-3114, :3078).
        In a CTF-search round each slice's CTF takes its drawn defocus
        factor.  ``draws`` injects (quats, trans, d, w) of shape (nh, L,
        S, ...), this rank's rows.  On several ranks F and T are summed
        over the data group before HK7; where :meth:`_vol_sharded` holds,
        the slices go to this rank's z-slab instead (HK11's slab form,
        symmetry pose-side).  Returns (F (nh, K, big^nd) or the slab (1, K, big /
        d, big, big), T, r_u, grid_size)."""
        cfg = self.cfg
        s = self.state
        r_u = int(self.model.r_u)
        grid_size = reco_grid_size(cfg.size, r_u)
        big = grid_size * cfg.pf
        self._tables = {}
        if draws is None:
            n_draw = min(cfg.m_reco, s.par.r.shape[2] * s.par.t.shape[2])
            n_slots = min(n_draw, RECO_COMPACT_SLOTS)
            draws = pt.draw_poses_compact(self.draws, s.par, n_draw, n_slots)
        quats, trans, d_draw, w_draw = draws
        trans = trans - self.offset[:, :, None, :]
        use_d = cfg.c_search and self.model.search_type == SEARCH_TYPE_CTF
        # grading only in refinement (parGra && k == 1,
        # Optimiser.cpp:6726-6761)
        if cfg.par_gra and cfg.k == 1:
            top = comm.max_world(self.layout, torch.max(s.par.score * self.valid_dev))
            w_img = s.par.score / torch.clamp(top, min=1e-12)
        else:
            w_img = torch.ones_like(s.par.score)
        w = (w_img * self.valid_dev)[..., None] * w_draw        # (2, L, S)
        n_slots = w.shape[-1]
        if self.nd == 2:
            f2, t2 = self._insert_2d(quats, trans, w, r_u, big)
            return (comm.sum_data(self.layout, f2), comm.sum_data(self.layout, t2),
                    r_u, grid_size)
        if self._vol_sharded(grid_size):
            return self._insert_slabs(quats, trans, d_draw, w, r_u, big, use_d) + (
                r_u, grid_size)
        f2 = torch.zeros((self.nh, cfg.k) + (big,) * 3, dtype=COMPLEX, device=self.device)
        t2 = torch.zeros((self.nh, cfg.k) + (big,) * 3, dtype=REAL, device=self.device)
        insert = insert_mkb if cfg.reco_kernel == "mkb" else insert_sweep
        # a launch a (chunk, hemisphere, class) on the chunk's images, by
        # their index in the chunk; each adds its sums to the grids, so
        # the chunks' (F, T) add in chunk order
        for sl, ft in self._ori_chunks():
            for h in range(self.nh):
                w_h = w[h, sl].reshape(-1)
                cls_s = s.cls[h, sl][:, None].expand(-1, n_slots).reshape(-1)
                ctf_h = self.data.ctf_params.map(lambda a: a[h, sl])
                for k in range(cfg.k):
                    sel = torch.nonzero((w_h > 0) & (cls_s == k))[:, 0]
                    insert(
                        ft[h], ctf_h, sel // n_slots,
                        rotate3d(quats[h, sl].reshape(-1, 4)[sel]),
                        trans[h, sl].reshape(-1, 2)[sel], w_h[sel], r_u, cfg.pf,
                        cfg.size, float(cfg.pixel_size), big, f2[h, k], t2[h, k],
                        d_draw[h, sl].reshape(-1)[sel] if use_d else None)
            del ft
        comm.sum_data(self.layout, f2)
        comm.sum_data(self.layout, t2)
        if self.sym.order > 1:
            f2, t2 = symmetrize_ft(f2, t2, self.sym.matrices,
                                   float((r_u - 1) * cfg.pf), self.sym_form)
        return f2, t2, r_u, grid_size

    def _vol_sharded(self, grid_size: int) -> bool:
        """True where a 3D round's padded grids lie as z-slabs over the
        data axis (thunder_tpu optimiser.py:3172-3189): hemi extent 2, an
        even data extent over 1 that splits the padded box, and grids of
        at least ``vol_shard_min_mb``; never with the MKB insertion option."""
        cfg, lay = self.cfg, self.layout
        big = grid_size * cfg.pf
        return (not cfg.mode_2d and cfg.reco_kernel != "mkb" and lay.hemi == 2
                and lay.data > 1
                and lay.data % 2 == 0 and big % lay.data == 0
                and big ** 3 * 8 // 2 ** 20 >= cfg.vol_shard_min_mb)

    def _insert_slabs(self, quats, trans, d_draw, w, r_u: int, big: int, use_d: bool):
        """The slab path's insertion: this rank forms the dense-window
        values of its slices with non-zero weight, the data group
        gathers them (padded to the group's largest count with
        zero-weight slices), and HK11's slab form adds every slice of
        the hemisphere, with every mate of the group, into this rank's
        slab (thunder_tpu optimiser.py:3087, recon/sharded.py
        insert_sweep_3d_sharded)."""
        cfg, lay = self.cfg, self.layout
        n_slots = w.shape[-1]
        z0, bz = sharded_grid_specs(lay, big)
        f = t = None
        # a gather and a launch a chunk of the originals (every rank of
        # the group holds as many), each adding its sums to the slabs
        for sl, ft in self._ori_chunks():
            w_h = w[0, sl].reshape(-1)
            sel = torch.nonzero(w_h > 0)[:, 0]
            vals, c2w, _, _ = dense_slice_values(
                ft[0], self.data.ctf_params.map(lambda a: a[0, sl]), sel // n_slots,
                trans[0, sl].reshape(-1, 2)[sel], w_h[sel], r_u, cfg.size,
                float(cfg.pixel_size), d_draw[0, sl].reshape(-1)[sel] if use_d else None)
            del ft
            rot = rotate3d(quats[0, sl].reshape(-1, 4)[sel]).reshape(-1, 9)
            cls = self.state.cls[0, sl][:, None].expand(-1, n_slots).reshape(-1)[sel]
            pad = int(comm.max_data(lay, torch.tensor([sel.numel()], device=self.device))) \
                - sel.numel()

            def pack(x):
                if pad:
                    x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                return comm.gather_slabs(lay, x.contiguous(), axis=0)

            vals, c2w, rot, cls = pack(vals), pack(c2w), pack(rot), pack(cls.to(torch.int32))
            f, t = insert_sweep_slab(vals, c2w, rot.reshape(-1, 3, 3), cls, r_u, cfg.pf,
                                     self.sym.matrices, cfg.k, big, z0, bz, f, t)
        return f[None], t[None]

    def _insert_2d(self, quats, trans, w, r_u: int, big: int):
        """This rank's hemispheres' slices with non-zero weight into nh K
        class planes, one HK12 launch (HK6 with reco_kernel "mkb") a chunk
        of the originals: image l of hemisphere h in a chunk of n is row
        h n + l of the flattened chunk, its class plane h K + cls."""
        cfg = self.cfg
        n_slots = w.shape[2]
        k = cfg.k
        d = self.data
        insert = insert_bilinear_2d if cfg.reco_kernel == "mkb" else insert_sweep_2d
        f2 = t2 = None
        # a launch a chunk of the originals, adding its sums to the planes
        for sl, ft in self._ori_chunks():
            n_c = sl.stop - sl.start
            w_c = w[:, sl]
            sel = torch.nonzero(w_c.reshape(-1) > 0)[:, 0]      # over (2, n_c, S)
            img = sel // n_slots                                 # h n_c + l
            hemi = img // n_c
            cls = self.state.cls[:, sl].reshape(-1)[img] + hemi * k
            f2, t2 = insert(
                ft.reshape((-1,) + ft.shape[2:]),
                d.ctf_params.map(lambda a: a[:, sl].reshape(-1)), img, cls,
                rotations(quats[:, sl].reshape(-1, 4)[sel], 2),
                trans[:, sl].reshape(-1, 2)[sel], w_c.reshape(-1)[sel], r_u, cfg.pf,
                cfg.size, float(cfg.pixel_size), big, self.nh * k, f2, t2)
            del ft
        return (f2.reshape(self.nh, k, big, big).contiguous(),
                t2.reshape(self.nh, k, big, big).contiguous())

    def _recentre(self, refs: torch.Tensor) -> torch.Tensor:
        """Shift each class reference by minus the mean rank-1 translation
        of its images (Optimiser.cpp:7382-7427)."""
        cfg = self.cfg
        if not (cfg.ref_auto_recentre and self._ref_mask is None
                and (cfg.mode_2d or self.sym.name.startswith("C"))):
            return refs
        s = self.state
        eff_t = s.par.top_t - self.offset
        one_hot = ((s.cls[:, None, :] == torch.arange(cfg.k, device=self.device
                                                       )[None, :, None]).to(REAL)
                   * self.valid_dev[:, None, :])
        lay = self.layout
        cnt = torch.clamp(comm.sum_data(lay, one_hot.sum(2)), min=1.0)
        o_class = (comm.sum_data(lay, torch.einsum("hkl,hlc->hkc", one_hot, eff_t))
                   / cnt[..., None])
        return recentre_refs(refs, o_class, self.nd)

    def reconstruct_maps(self, draws=None, stage: _Stages | None = None):
        """A round's maps from its (F, T): :meth:`reconstruct_round`
        (``draws`` injected where given), then the MAP-free FSC pass and
        the Wiener MAP pass with the previous round's FSC, on one grid or
        on this rank's slabs, resized to the box.  Returns (refs_fsc,
        refs_map, r_u), this rank's hemispheres (nh, K, size^nd)."""
        cfg, nd = self.cfg, self.nd
        if stage is not None:
            stage.begin("reco_insert")
        f2, t2, r_u, grid_size = (self.reconstruct_round() if draws is None
                                  else self.reconstruct_round(draws))
        if stage is not None:
            stage.begin("reco_fsc")
        # the previous round's per-class curves (one curve broadcast
        # until the first reconstruction)
        fsc_prev = np.asarray(self.model.fsc, np.float32)
        if fsc_prev.shape[0] < cfg.k:
            fsc_prev = np.broadcast_to(fsc_prev[:1], (cfg.k,) + fsc_prev.shape[1:])
        fsc_prev = torch.as_tensor(np.ascontiguousarray(fsc_prev), device=self.device)
        if self._vol_sharded(grid_size):
            return tuple(r[None] for r in reconstruct_two_pass_sharded(
                self.layout, f2[0], t2[0], fsc_prev, grid_size, cfg.pf, r_u, cfg.size)
                ) + (r_u,)
        refs_fsc, refs_map = reconstruct_two_pass(f2, t2, fsc_prev, grid_size, cfg.pf, r_u, nd,
                                                  kernel=cfg.reco_kernel)
        del f2, t2
        if grid_size != cfg.size:
            refs_fsc = resize_rl(refs_fsc, cfg.size, nd=nd)
            refs_map = resize_rl(refs_map, cfg.size, nd=nd)
        return refs_fsc, refs_map, r_u

    def _reconstruct_and_compare(self, record: dict, stage: _Stages):
        """Two-pass reconstruction (MAP-free FSC pass + Wiener MAP pass
        with the previous round's FSC), hemisphere FSC (HK4) and
        averaging below the 0.95 crossing (Optimiser.cpp:7310-7755)."""
        cfg = self.cfg
        nd = self.nd
        lay = self.layout
        n_shells = cfg.max_r
        refs_fsc, refs_map, r_u = self.reconstruct_maps(stage=stage)
        refs_fsc = self._recentre(refs_fsc)
        self._refs_report = refs_fsc
        # the hemispheres meet here (every rank of a pair gets both)
        both = comm.exchange_hemi(lay, refs_fsc)
        if nd == 3 and (cfg.core_fsc or cfg.mask_fsc):
            # core / masked true FSC in place of the plain curve
            # (Model.cpp:411-567)
            m = (self._ref_mask if cfg.mask_fsc and self._ref_mask is not None
                 else self._soft_mask)
            fsc_dev = true_fsc_batch(both[0], both[1], m, self.gen, n_shells)
        else:
            fsc_dev, _, _ = compare_refs(both[0], both[1], n_shells,
                                         want_avg=False, nd=nd)
        del both
        fsc_all = fsc_dev.cpu().numpy().astype(np.float64)
        fsc_all[:, r_u:] = 0.0
        self._fsc_band = int(r_u)
        stage.begin("reco_wiener")
        refs = comm.exchange_hemi(lay, self._recentre(refs_map))
        stage.begin("reco_compare")
        if cfg.gold_standard and cfg.k == 1:
            _, ref_a, ref_b = compare_refs(refs[0], refs[1], n_shells,
                                           fsc=fsc_all, nd=nd)
            refs = torch.stack([ref_a, ref_b])
        else:
            # K > 1 (or no gold standard): the halves are fully averaged
            # every round (Model.cpp:679-690)
            refs = ((refs[0] + refs[1]) / 2)[None].expand(2, *refs.shape[1:])
        self.set_refs(replicated_per_hemi(lay, refs).contiguous())
        self.model.set_fsc(fsc_all)
        self.model.update_res(cfg.thres_report_fsc)

    def class_distribution(self) -> torch.Tensor:
        """Share of the valid images in each class, (K,)
        (refreshClassDistr, Optimiser.cpp:5484)."""
        one_hot = (self.state.cls[..., None]
                   == torch.arange(self.cfg.k, device=self.device)).to(REAL)
        cnt = comm.sum_world(self.layout, torch.sum(one_hot * self.valid_dev[..., None],
                                                    dim=(0, 1)))
        return cnt / torch.clamp(torch.sum(self.valid_all), min=1.0)

    def balance_classes(self, distr: np.ndarray | None = None) -> list:
        """Class rebirth: every class holding less than
        CLASS_BALANCE_FACTOR / K of the images takes the references of
        the most populated class (refreshClassDistr + balanceClass,
        Optimiser.cpp:5484-5592).  Returns the reborn classes."""
        cfg = self.cfg
        if cfg.k <= 1:
            return []
        if distr is None:
            distr = self.class_distribution().cpu().numpy()
        distr = np.asarray(distr)
        heavy = int(np.argmax(distr))
        reborn = [t for t in range(cfg.k) if distr[t] < CLASS_BALANCE_FACTOR / cfg.k]
        if reborn:
            refs = self.state.refs.clone()
            refs[:, reborn] = refs[:, heavy][:, None]
            self.set_refs(refs)
        return reborn

    def solvent_flatten(self, apply_mask: bool) -> None:
        """Reference masking with zero background (solventFlatten)."""
        w = self._ref_mask if (apply_mask and self._ref_mask is not None) \
            else self._soft_mask
        self.set_refs(self.state.refs * w)

    def re_centre_img(self) -> None:
        """Fold the rank-1 shift into the per-image offsets and shift the
        clouds back (reCentreImg, Optimiser.cpp:6065-6090)."""
        s = self.state
        tran = s.par.top_t
        self.offset = self.offset - tran
        s.par = s.par._replace(t=s.par.t - tran[..., None, :],
                               top_t=s.par.top_t - tran)

    def _refresh_masked(self) -> None:
        """Soft-masked spectra rebuilt from offset-translated originals
        (reMaskImg, Optimiser.cpp:6093-6149), in place over
        :meth:`_ori_chunks`."""
        cfg, d = self.cfg, self.data
        w = soft_mask_weight(cfg.size, 2, cfg.mask_radius / cfg.pixel_size,
                             EDGE_WIDTH_RL, self.device)
        for sl, ft in self._ori_chunks():
            shifted = translate_ft(ft, self.offset[:, sl])
            d.ft_masked[:, sl] = fft2_centered(ifft2_centered(shifted) * w).to(COMPLEX)

    # -- one round ------------------------------------------------------

    def run_round(self, i_round: int) -> dict:
        """One E-M round; each stage runs in a named profiler range
        (``thunder:round/<stage>``) and, with THUNDER_STAGE_TIMING set,
        is timed up to a device sync into the record's ``stage_ms``."""
        timing = bool(os.environ.get("THUNDER_STAGE_TIMING"))
        with _Stages(self._sync if timing else None) as stage:
            return self._run_round(i_round, stage)

    def _run_round(self, i_round: int, stage: _Stages) -> dict:
        cfg = self.cfg
        t0 = time.time()
        rings = self._rings()
        record = dict(round=i_round, r=int(self.model.r),
                      search_type=int(self.model.search_type))
        if stage.ms is not None:
            record["stage_ms"] = stage.ms

        stage.begin("build_table")
        self.proj_table(int(self.model.r))
        self.proj_table(int(self.model.r_u))
        # the phase loop's table plan, keyed on the phase band r
        r_phase = int(self.model.r)
        (self._round_brick, self._round_order,
         self._round_segs) = self._table_plan(r_phase)
        if self._round_brick is not None:
            record["proj_table"] = "brick%s" % (self._round_brick,)
            self._brick_used.add(self._round_brick)

        s = self.state
        prev_top_r = s.par.top_r
        if i_round == 0 or not cfg.skip_e:
            if self.model.search_type == SEARCH_TYPE_GLOBAL and cfg.g_search:
                stage.begin("global_search")
                g = self.expectation_global(rings)
                stage.begin("adopt_global")
                self.adopt_global(g)
                # the adopted clouds may already fit a rung: the whole
                # phase loop then projects through it
                if self._round_brick is None:
                    self._round_brick = self._brick_choice(r_phase, mid_round=True)
                    if self._round_brick is not None:
                        self._brick_used.add(self._round_brick)
            stage.begin("phases")
            record["n_phases"] = self.local_phases(rings)
            if self._round_brick is not None:
                # a chunk boundary may have engaged it
                record["proj_table"] = self._plan_tag()
        else:
            record["n_phases"] = [0, 0]

        stage.begin("host_stats")
        dot = torch.abs(torch.sum(prev_top_r * s.par.top_r, dim=-1))
        rot_med = self._median(dot)
        record["rot_change_median_deg"] = float(
            np.degrees(2.0 * np.arccos(np.clip(rot_med, -1.0, 1.0))))
        self.model.set_t_vari(self._median(s.par.s0), self._median(s.par.s1))
        # what update_r's 2 % stagnation test reads
        record["t_vari"] = [self.model.t_vari_s0, self.model.t_vari_s1]
        # the class distribution after expectation drives rebirth
        distr = self.class_distribution().cpu().numpy() if cfg.k > 1 else None

        if not cfg.skip_m:
            if len(self._ft_chunks()) == 1:
                stage.begin("max_stats")
                self.maximization_stats(i_round)
            else:
                # the originals stream in chunks: the norm median must be
                # global before sigma accumulates (thunder_tpu
                # optimiser.py:3465-3480)
                is_global = self.model.search_type == SEARCH_TYPE_GLOBAL
                if i_round != 0 and not is_global:
                    stage.begin("norm_correction")
                    self.norm_correction()
                stage.begin("sigma")
                self.refresh_sigma()
                if is_global and cfg.group_scl and i_round != 0:
                    stage.begin("scale")
                    self.correct_scale()
            if not cfg.skip_r:
                self._reconstruct_and_compare(record, stage)
        else:
            self.model.set_fsc(np.ones((cfg.k, cfg.max_r), np.float32))

        stage.begin("mask_recentre")
        reborn = self.balance_classes(distr)
        if reborn:
            record["reborn_classes"] = reborn
        self.solvent_flatten(cfg.perform_mask and (
            cfg.global_mask or self.model.search_type != SEARCH_TYPE_GLOBAL))
        if self.model.search_type != SEARCH_TYPE_GLOBAL:
            self.re_centre_img()
            self._refresh_masked()
        stage.end()

        self.model.update_r(cfg.thres_cutoff_fsc)
        self.model.update_search_type()
        record["res_shell"] = int(self.model.res)
        record["res_A"] = float(self.model.res_angstrom(cfg.thres_report_fsc))
        self._sync()
        record["elapsed_s"] = time.time() - t0
        record["search_type_after"] = int(self.model.search_type)
        self.round_records.append(record)
        return record

    def run(self, max_rounds: int | None = None) -> list:
        n = max_rounds if max_rounds is not None else self.cfg.iter_max
        for i in range(n):
            self.run_round(i)
            if self.model.search_type == SEARCH_TYPE_STOP:
                break
        return self.round_records

    def final_reconstruction(self) -> np.ndarray:
        """Joint reconstruction at the full band after the search stops
        (Optimiser.cpp:4078-4129), MAP-free.  Returns (K, n^nd) maps
        averaged over hemispheres (on every rank); per-hemisphere maps stay
        in the state."""
        cfg = self.cfg
        saved_r = self.model.r
        self.model.r = cfg.max_r - 3
        f2, t2, r_u, grid_size = self.reconstruct_round()
        self.model.r = saved_r
        if self._vol_sharded(grid_size):
            refs = reconstruct_all_sharded(
                self.layout, f2[0], t2[0], None, grid_size, cfg.pf, r_u, False, False,
                cfg.size)[None]
        else:
            refs = reconstruct(f2, t2, grid_size, cfg.pf, r_u, self.nd,
                               kernel=cfg.reco_kernel)
        del f2, t2
        if refs.shape[-1] != cfg.size:
            refs = resize_rl(refs, cfg.size, nd=self.nd)
        self.set_refs(refs.contiguous())
        self._refs_report = None
        both = comm.exchange_hemi(self.layout, refs)
        return ((both[0] + both[1]) / 2).cpu().numpy()

    def save_subtract(self, mask, chunk: int = 512) -> np.ndarray:
        """Signal subtraction (saveSubtract, Optimiser.cpp:8418-...): from
        each original image, the CTF times the projection of its class's
        masked reference at its rank-1 pose (:func:`subtract_batch`, one
        launch a chunk of a hemisphere's images).  ``mask`` (n^nd), real
        space, FFT layout.  Returns (n, size, size) float32 real-space
        images in the original particle order (on rank 0; None on the
        other ranks, which send their rows there).  Each chunk's rows go
        to the host as they are made and reach rank 0 a chunk at a time,
        so that no stack of rows lies on a device."""
        cfg = self.cfg
        w = torch.as_tensor(mask, dtype=REAL, device=self.device)
        s = self.state
        mine = torch.empty((self.nh, self.n_img, cfg.size, cfg.size), dtype=REAL)
        slices = [slice(lo, min(self.n_img, lo + chunk)) for lo in range(0, self.n_img, chunk)]
        for h in range(self.nh):
            table = subtract_table(s.refs[h] * w, cfg.pf, self.nd)
            eff_t = s.par.top_t[h] - self.offset[h]
            for i, sl in enumerate(slices):
                ft = self._ft_ori_chunk(sl, slices[i + 1] if i + 1 < len(slices) else None, h)
                mine[h, sl] = subtract_batch(
                    ft, self.data.ctf_params.map(lambda a: a[h, sl]),
                    table, s.cls[h, sl], s.par.top_r[h, sl], eff_t[sl], cfg.size, cfg.pf,
                    float(cfg.pixel_size))
        rows = comm.gather_host_rows_to_lead(self.layout, mine, chunk, self.device)
        if rows is None:
            return None
        rows = rows.numpy()
        out = np.zeros((self.n_total, cfg.size, cfg.size), np.float32)
        for h in (0, 1):
            ok = self.valid[h]
            out[self.index[h][ok]] = rows[h][ok]
        return out

    # -- checkpoints and exports ---------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Full state (references, sigma, clouds, offsets, model state),
        every rank's rows gathered to rank 0, which alone writes."""
        s, lay = self.state, self.layout
        rows = {name: comm.gather_rows_to_lead(lay, arr)
                for name, arr in [("cls", s.cls), ("offset", self.offset)]
                + [(f"par_{n}", a) for n, a in zip(s.par._fields, s.par)]}
        refs, sigma = comm.exchange_hemi(lay, s.refs), comm.exchange_hemi(lay, s.sigma)
        if lay.rank != 0:
            return
        blobs = dict(refs=refs.cpu().numpy(), sigma=sigma.cpu().numpy(),
                     index=self.index, valid=self.valid,
                     fsc=np.asarray(self.model.fsc))
        blobs.update({name: a.cpu().numpy() for name, a in rows.items()})
        model = {f.name: getattr(self.model, f.name)
                 for f in dataclasses.fields(self.model) if f.name != "fsc"}
        blobs["model_json"] = np.frombuffer(json.dumps(model).encode(), np.uint8)
        blobs["rng"] = self.gen.get_state().numpy()
        np.savez_compressed(path, **blobs)

    def load_checkpoint(self, path: str) -> None:
        """Restore :meth:`save_checkpoint`'s state; each rank keeps its
        rows and hemispheres (the layout must split the saved L)."""
        z = np.load(path, allow_pickle=False)
        dev, lay = self.device, self.layout
        t = lambda a: torch.as_tensor(a, device=dev)
        rows = lambda a: t(np.ascontiguousarray(lay.take(a)))
        hem = lambda a: t(np.ascontiguousarray(replicated_per_hemi(lay, a)))
        s = self.state
        self.set_refs(hem(z["refs"]))
        s.sigma, s.cls, self.offset = hem(z["sigma"]), rows(z["cls"]), rows(z["offset"])
        self.index, self.valid = z["index"], z["valid"]
        self.n_img_all = self.index.shape[1]
        self.local_rows = lay.rows(self.n_img_all)
        self.valid_all = t(self.valid.astype(np.float32))
        self.valid_dev = lay.take(self.valid_all).contiguous()
        self.n_img = self.valid_dev.shape[1]
        s.par = pt.ParticleState(**{f: rows(z[f"par_{f}"]) for f in s.par._fields})
        model = json.loads(bytes(z["model_json"]).decode())
        for f in dataclasses.fields(self.model):
            if f.name in model:
                setattr(self.model, f.name, model[f.name])
        self.model.fsc = z["fsc"]
        self.gen.set_state(torch.as_tensor(z["rng"]))

    def class_assignments(self) -> np.ndarray:
        """Each image's class in particle order (on every rank)."""
        out = np.zeros(self.n_total, dtype=np.int64)
        cls = comm.all_gather_rows(self.layout, self.state.cls).cpu().numpy()
        for h in (0, 1):
            v = self.valid[h]
            out[self.index[h][v]] = cls[h][v]
        return out

    def class_averages(self) -> np.ndarray:
        """Mean of the hemisphere references per class, (K, n^nd): from
        the MAP-free pass of the last round when there is one (the
        reference saves those maps), else the current references (both
        hemispheres meet: every rank of a pair calls it)."""
        refs = self._refs_report if self._refs_report is not None else self.state.refs
        refs = comm.exchange_hemi(self.layout, refs)
        return ((refs[0] + refs[1]) / 2).cpu().numpy()

    def refs_both(self, report: bool = False) -> np.ndarray:
        """Both hemispheres' references (2, K, n^nd) on every rank of a
        pair; ``report``: the last MAP-free pass's where there is one."""
        refs = (self._refs_report if report and self._refs_report is not None
                else self.state.refs)
        return comm.exchange_hemi(self.layout, refs).cpu().numpy()

    def export_thu(self, thu):
        """Write the particle-filter state back into a ThuTable
        (saveDatabase, Optimiser.cpp:8250-8416); every rank's rows are
        gathered to rank 0, which returns the table (None elsewhere)."""
        s = self.state
        host = {k: comm.gather_rows_to_lead(self.layout, v) for k, v in dict(
            cls=s.cls, top_r=s.par.top_r, k1=s.par.k1, k2=s.par.k2,
            k3=s.par.k3, top_t=s.par.top_t, offset=self.offset, s0=s.par.s0,
            s1=s.par.s1, top_d=s.par.top_d, s_d=s.par.s_d,
            score=s.par.score).items()}
        if self.layout.rank != 0:
            return None
        host = {k: v.cpu().numpy() for k, v in host.items()}
        out = copy.deepcopy(thu)
        for h in (0, 1):
            v = self.valid[h]
            idx = self.index[h][v]
            get = lambda name: host[name][h][v]
            out.class_id[idx] = get("cls")
            out.quat[idx] = get("top_r")
            out.k1[idx] = get("k1")
            out.k2[idx] = get("k2")
            out.k3[idx] = get("k3")
            out.trans[idx] = get("top_t") - get("offset")
            out.std_trans[idx] = np.stack([get("s0"), get("s1")], axis=1)
            out.defocus_factor[idx] = get("top_d")
            out.std_defocus_factor[idx] = get("s_d")
            out.score[idx] = get("score")
        return out
