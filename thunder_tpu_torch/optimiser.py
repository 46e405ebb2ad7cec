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
(global search, phases, statistics), HK2 likelihood_block (global
search, phases), HK8 likelihood_local_ctf (the phases of CTF search),
HK3 insert_trilinear / HK6 insert_bilinear_2d (insertion; HK10
insert_mkb in 3D with the insertion option reco_kernel="mkb"), HK7
symmetrize_ft (point-group symmetrisation of the 3D grids) and HK4
shell_sums (FSC, sigma).

Supported here: 3D refinement and 3D classification (any K, any point
group, global, local and CTF search), 2D classification (any K; the
config's symmetry is ignored in 2D, as in thunder_tpu) and, once the
search stops, signal subtraction (``save_subtract``: HK1 / HK5 over
every pixel of the box).  The JAX
package's pose-side symmetry expansion belongs to its sharded inserter
and has no counterpart, nor has its TPU-only machinery
(residency planning, hemisphere sequencing, brick tables and routing,
static insert buckets, the sweep inserters).
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
                                          insert_trilinear, insert_trilinear_slab)
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


class StackedData(NamedTuple):
    """The images of a rank's hemispheres on a leading axis (2 on one
    process), padded to a common L (pads repeat real images and carry no
    insertion weight)."""

    ft_masked: torch.Tensor    # (nh, L, size, size) complex64
    ft_ori: torch.Tensor       # (nh, L, size, size) complex64
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
        flat = ids.reshape(-1)
        imgs = (np.asarray(image_loader(flat), np.float32) if image_loader is not None
                else np.asarray(images, np.float32)[flat])

        prep = preprocess_images(
            torch.as_tensor(imgs, device=dev),
            cfg.mask_radius / cfg.pixel_size, zero_mask=cfg.zero_mask)
        del imgs
        nh, n_l = self.nh, self.n_img
        s2 = (nh, n_l, cfg.size, cfg.size)
        ctf = CtfParams(*[torch.as_tensor(np.asarray(f, np.float32)[flat],
                                          device=dev).reshape(nh, n_l)
                          for f in ctf])
        self.data = StackedData(
            ft_masked=prep.ft_masked.reshape(s2).contiguous(),
            ft_ori=prep.ft_ori.reshape(s2).contiguous(), ctf_params=ctf,
            group_id=torch.as_tensor(np.asarray(group_id)[flat].astype(np.int64),
                                     device=dev).reshape(nh, n_l))
        sigma = torch.stack([
            self._init_sigma(self.data.ft_ori[h]).expand(self.n_group, cfg.max_r)
            for h in range(nh)]).contiguous()
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
                   ctf: CtfTerms | None = None):
        """One particle-filter phase for hemispheres ``hemis``: perturb ->
        project (HK1 / HK5) -> likelihood (HK2) -> clip -> resample ->
        variance inference (Optimiser.cpp:1183-1614).  With ``ctf``, the
        round's :func:`likelihood.ctf_terms` in CTF search, the defocus
        axis is perturbed, evaluated (HK8 in place of HK2, the CTF of
        every defocus support point formed there) and resampled too, and
        ``dat_w`` / ``sctf2`` are the CTF-free operands of
        :func:`pack_inputs_ctf` (dat_s, s_pack).  ``par`` holds the
        selected hemispheres (indices into this rank's hemispheres; their
        draws cover ``self.draws.running``); returns (par, vari
        (len(hemis), 4), the means over this rank's images)."""
        cfg = self.cfg
        mode, nd = self.mode, self.nd
        is_ctf = ctf is not None
        hs = torch.as_tensor(hemis, device=self.device)
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
            tra = translate_phases_view(rings.i_col, rings.i_row, cfg.size, par.t)
            rot = rotations(par.r, nd).reshape(nh * n_l, n_r, nd, nd)
            cls = (self.state.cls[hs] + hs[:, None] * k_cls).reshape(-1)
        with _range("phase/project"):
            pri = project_any(table.reshape((-1,) + table.shape[2:]), rot,
                              rings.i_col, rings.i_row, cfg.pf, cls)
        fold = lambda x: x.reshape((nh * n_l,) + x.shape[2:])
        # the selected hemispheres of a round's (2, L, ...) operand: views,
        # not gathers
        flat = fold if nh == self.nh else (lambda x: x[hemis[0]])
        with _range("phase/local_marginals"):
            if is_ctf:
                u_r, u_t, u_d = likelihood_local_ctf(
                    flat(dat_w), flat(sctf2), ctf.images(flat), fold(par.d), pri,
                    fold(tra), flat(a_term), fold(par.w_r), fold(par.w_t),
                    fold(par.w_d))
                par = par._replace(u_d=u_d.reshape(nh, n_l, -1))
            else:
                u_r, u_t = local_marginals(flat(dat_w), flat(sctf2), flat(a_term),
                                           pri, fold(tra), fold(par.w_r),
                                           fold(par.w_t))
            par = par._replace(u_r=u_r.reshape(nh, n_l, -1),
                               u_t=u_t.reshape(nh, n_l, -1))
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
            vari = torch.stack([par.k1.mean(-1), par.s0.mean(-1), par.s1.mean(-1),
                                par.s_d.mean(-1)], dim=-1)
        return par, vari

    def local_phases(self, rings: PackedRings) -> list:
        """The adaptive phase loop with the variance-stall rule checked on
        the host after every phase, per hemisphere
        (PARTICLE_FILTER_DECREASE_FACTOR 0.95, N_PHASE_WITH_NO_VARI_DECREASE
        1, stalls counted from the minimum phase count on; the defocus
        variance is the rule's fourth term, constant outside CTF search).
        A CTF-search round scatters the defocus support anew around 1 at
        its start (Particle::initD, Optimiser.cpp:1195-1196).  Returns
        the phase count of each hemisphere."""
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
        table = self.proj_table(rings.r_u)
        f = PARTICLE_FILTER_DECREASE_FACTOR
        big = float(np.finfo(np.float32).max)
        phase, n_no_dec = [0, 0], [0, 0]
        prev = [[big] * 4, [big] * 4]
        par = s.par.map(lambda a: a.contiguous())

        multi = self.layout.world > 1
        step_log = None

        def running(h):
            return phase[h] < MAX_N_PHASE_PER_ITER and (
                phase[h] < min_phase or n_no_dec[h] < N_PHASE_WITH_NO_VARI_DECREASE)

        while True:
            run = [h for h in (0, 1) if running(h)]
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
                step_log = self.draws.log if multi else None
            else:
                # this hemisphere has stopped, the other runs on: draw what
                # its phase draws, so that the generator stays in step
                self.draws.replay(step_log)
                vari = None
            vari = self._vari_means(vari, mine, run)
            for i, h in enumerate(run):
                k1, s0, s1, sd = (float(v) for v in vari[i])
                pk1, ps0, ps1, psd = prev[h]
                dec = k1 < pk1 * f or s0 < ps0 * f or s1 < ps1 * f or sd < psd * f
                n_no_dec[h] = (0 if dec else n_no_dec[h] + 1) \
                    if phase[h] + 1 >= min_phase else 0
                phase[h] += 1
                prev[h] = [k1, s0, s1, sd]
        if multi:
            self.draws.running, self.draws.log = (0, 1), None
        par = pt.cal_score(par, self.mode)
        # the rank-1 rotation folds into the asymmetric unit in 3D only
        # (thunder_tpu's _finish_phases: sym.order > 1 and not 2D)
        s.par = par if cfg.mode_2d else pt.symmetrise_top(par, self.sym)
        return phase

    def _vari_means(self, vari, mine: list, run: list) -> np.ndarray:
        """The stall rule's variances (len(run), 4) of each running
        hemisphere, averaged over all its images: ``vari`` holds this
        rank's means (len(mine), 4) over its images (None when none of
        its hemispheres runs); on several ranks the sums meet over the
        world, so every rank reads the same values and runs the same
        phases."""
        if self.layout.world == 1:
            return vari.cpu().numpy()
        sums = torch.zeros((2, 4), dtype=torch.float64, device=self.device)
        for i, li in enumerate(mine):
            sums[self.hemis[li]] = vari[i].double() * self.n_img
        sums = comm.sum_world(self.layout, sums) / self.n_img_all
        return sums.cpu().numpy()[run]

    # -- maximization ---------------------------------------------------

    def maximization_stats(self, i_round: int) -> None:
        """normCorrection + allReduceSigma (+ scale correction) over one
        rank-1 projection pass (optimiser._max_stats_h): per-image shell
        sums d2 = sum |dat|^2, xa = sum Re(dat conj(m)), aa = sum |m|^2
        (m = ctf tra pri; HK4), the norm-band median rescale s, and the
        closed-form sigma of the rescaled residual s^2 d2 - 2 s xa + aa."""
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
        table = self.proj_table(r_lo)
        top_t = s.par.top_t - self.offset
        r_norm = max(min(int(self.model.r), self.model.resolution_p(0.75)),
                     cfg.r_low + 2)
        r_s = max(2, min(int(self.model.r), cfg.res_a2p(cfg.sclCor_res)))

        n_l, nh, lay = self.n_img, self.nh, self.layout
        k_cls = table.shape[1]
        dat = extract_packed(d.ft_ori, rings)                   # (nh, L, P)
        dat_hi = extract_packed(d.ft_ori, rings_hi)
        ctf = ctf_packed(d.ctf_params, rings.i_col, rings.i_row, cfg.size,
                         float(cfg.pixel_size))
        nd = self.nd
        rot = rotations(s.par.top_r, nd).reshape(nh * n_l, 1, nd, nd)
        hs = torch.arange(nh, device=dev)[:, None]
        cls = (s.cls + hs * k_cls).reshape(-1)
        pri = project_any(table.reshape((-1,) + table.shape[2:]), rot,
                          rings.i_col, rings.i_row, cfg.pf, cls)
        pri = pri.reshape(nh, n_l, -1)
        tra = translate_phases_view(rings.i_col, rings.i_row, cfg.size,
                                    top_t[..., None, :])[..., 0, :]
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
            self.data = d._replace(ft_masked=d.ft_masked * s_norm[..., None, None],
                                   ft_ori=d.ft_ori * s_norm[..., None, None])
        elif do_scale:
            # per-group scale (refreshScale with group_scl, as
            # thunder_tpu._max_stats_h's group branch)
            scale_g = (comm.sum_data(lay, torch.einsum("hlg,hl->hg", g_onehot, xa_l))
                       / torch.clamp(comm.sum_data(lay, torch.einsum("hlg,hl->hg",
                                                                     g_onehot, aa_l)),
                                     min=1e-30))
            per_img = torch.gather(scale_g, 1, d.group_id)
            self.data = d._replace(ft_masked=d.ft_masked / per_img[..., None, None],
                                   ft_ori=d.ft_ori / per_img[..., None, None])
            s.sigma = s.sigma / scale_g[..., None] ** 2

    def correct_scale(self) -> None:
        """Divide the images and the noise spectra by the intensity scale
        of the data against the references, sum Re(dat conj(ctf pri)) /
        sum ctf^2 |pri|^2 below the scale-correction shell at the rank-1
        pose, per group with ``group_scl`` (refreshScale + correctScale,
        Optimiser.cpp:5749-6063, 5103-5143).  No round calls it: a
        round's own rescale is ``maximization_stats``'s, which knows only
        the per-group form.  This is the entry for a caller who starts
        from images on another scale than the references (a run set
        straight into local or CTF search on a given model), as
        thunder_tpu's ``correct_scale(init=False)`` is."""
        cfg = self.cfg
        s, d = self.state, self.data
        r_s = max(2, min(int(self.model.r), cfg.res_a2p(cfg.sclCor_res)))
        rings = pack_rings(cfg.size, r_s, 0, lane=512, device=self.device)
        table = self.proj_table(r_s)
        n_l, nd, nh, lay = self.n_img, self.nd, self.nh, self.layout
        dat = extract_packed(d.ft_ori, rings)
        ctf = ctf_packed(d.ctf_params, rings.i_col, rings.i_row, cfg.size,
                         float(cfg.pixel_size))
        hs = torch.arange(nh, device=self.device)[:, None]
        pri = project_any(table.reshape((-1,) + table.shape[2:]),
                          rotations(s.par.top_r, nd).reshape(nh * n_l, 1, nd, nd),
                          rings.i_col, rings.i_row, cfg.pf,
                          (s.cls + hs * table.shape[1]).reshape(-1)).reshape(nh, n_l, -1)
        prit = pri * translate_phases_view(
            rings.i_col, rings.i_row, cfg.size,
            (s.par.top_t - self.offset)[..., None, :])[..., 0, :]
        xa = torch.sum((dat * prit.conj()).real * ctf * rings.mask, -1) * self.valid_dev
        aa = torch.sum(prit.abs() ** 2 * ctf * ctf * rings.mask, -1) * self.valid_dev
        if cfg.group_scl:
            # each group's sums as a one-hot product (a float scatter_add
            # on the card adds in a run-dependent order)
            g_onehot = (d.group_id[..., None]
                        == torch.arange(self.n_group, device=self.device)).to(REAL)
            scale = (comm.sum_data(lay, torch.einsum("hlg,hl->hg", g_onehot, xa))
                     / torch.clamp(comm.sum_data(lay, torch.einsum("hlg,hl->hg", g_onehot, aa)),
                                   min=1e-30))
        else:
            scale = (comm.sum_data(lay, xa.sum(1))
                     / torch.clamp(comm.sum_data(lay, aa.sum(1)), min=1e-30))[:, None].expand(
                nh, self.n_group)
        per_img = torch.gather(scale, 1, d.group_id)[..., None, None]
        self.data = d._replace(ft_masked=d.ft_masked / per_img, ft_ori=d.ft_ori / per_img)
        s.sigma = s.sigma / scale[..., None] ** 2

    # -- reconstruction -------------------------------------------------

    def reconstruct_round(self, draws=None):
        """Draw poses, compact them, and insert both hemispheres' slices
        into per-class (F, T) grids — in 3D HK3 (HK10 with reco_kernel
        "mkb") once a hemisphere and class on that class's slices, then
        HK7 over the 2K grids where
        the point group has mates; in 2D HK6 (one launch for both
        hemispheres' 2K planes) (reconstructRef, Optimiser.cpp:6711-7233).
        In a CTF-search round each slice's CTF takes its drawn defocus
        factor.  ``draws`` injects (quats, trans, d, w) of shape (nh, L,
        S, ...), this rank's rows.  On several ranks F and T are summed
        over the data group before HK7; where :meth:`_vol_sharded` holds,
        the slices go to this rank's z-slab instead (HK9, symmetry
        pose-side).  Returns (F (nh, K, big^nd) or the slab (1, K, big /
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
        insert = insert_mkb if cfg.reco_kernel == "mkb" else insert_trilinear
        for h in range(self.nh):
            w_h = w[h].reshape(-1)
            cls_s = s.cls[h][:, None].expand(-1, n_slots).reshape(-1)
            ctf_h = self.data.ctf_params.map(lambda a: a[h])
            for k in range(cfg.k):
                sel = torch.nonzero((w_h > 0) & (cls_s == k))[:, 0]
                insert(
                    self.data.ft_ori[h], ctf_h, sel // n_slots,
                    rotate3d(quats[h].reshape(-1, 4)[sel]),
                    trans[h].reshape(-1, 2)[sel], w_h[sel], r_u, cfg.pf,
                    cfg.size, float(cfg.pixel_size), big, f2[h, k], t2[h, k],
                    d_draw[h].reshape(-1)[sel] if use_d else None)
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
        zero-weight slices), and HK9 adds every slice of the hemisphere,
        with every mate of the group, into this rank's slab."""
        cfg, lay = self.cfg, self.layout
        n_slots = w.shape[-1]
        w_h = w[0].reshape(-1)
        sel = torch.nonzero(w_h > 0)[:, 0]
        vals, c2w, _, _ = dense_slice_values(
            self.data.ft_ori[0], self.data.ctf_params.map(lambda a: a[0]), sel // n_slots,
            trans[0].reshape(-1, 2)[sel], w_h[sel], r_u, cfg.size, float(cfg.pixel_size),
            d_draw[0].reshape(-1)[sel] if use_d else None)
        rot = rotate3d(quats[0].reshape(-1, 4)[sel]).reshape(-1, 9)
        cls = self.state.cls[0][:, None].expand(-1, n_slots).reshape(-1)[sel]
        pad = int(comm.max_data(lay, torch.tensor([sel.numel()], device=self.device))) \
            - sel.numel()

        def pack(x):
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            return comm.gather_slabs(lay, x.contiguous(), axis=0)

        vals, c2w, rot, cls = pack(vals), pack(c2w), pack(rot), pack(cls.to(torch.int32))
        z0, bz = sharded_grid_specs(lay, big)
        f, t = insert_trilinear_slab(vals, c2w, rot.reshape(-1, 3, 3), cls, r_u, cfg.pf,
                                     self.sym.matrices, cfg.k, big, z0, bz)
        return f[None], t[None]

    def _insert_2d(self, quats, trans, w, r_u: int, big: int):
        """This rank's hemispheres' slices with non-zero weight into nh K
        class planes in one HK6 launch: image l of hemisphere h is row
        h L + l of the flattened stack, its class plane h K + cls."""
        cfg = self.cfg
        n_l, n_slots = w.shape[1], w.shape[2]
        k = cfg.k
        sel = torch.nonzero(w.reshape(-1) > 0)[:, 0]            # over (2, L, S)
        img = sel // n_slots                                     # h L + l
        hemi = img // n_l
        cls = self.state.cls.reshape(-1)[img] + hemi * k
        d = self.data
        f2, t2 = insert_bilinear_2d(
            d.ft_ori.reshape((-1,) + d.ft_ori.shape[2:]),
            d.ctf_params.map(lambda a: a.reshape(-1)), img, cls,
            rotations(quats.reshape(-1, 4)[sel], 2),
            trans.reshape(-1, 2)[sel], w.reshape(-1)[sel], r_u, cfg.pf,
            cfg.size, float(cfg.pixel_size), big, self.nh * k)
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
        (reMaskImg, Optimiser.cpp:6093-6149)."""
        cfg = self.cfg
        shifted = translate_ft(self.data.ft_ori, self.offset)
        w = soft_mask_weight(cfg.size, 2, cfg.mask_radius / cfg.pixel_size,
                             EDGE_WIDTH_RL, self.device)
        self.data = self.data._replace(
            ft_masked=fft2_centered(ifft2_centered(shifted) * w).to(COMPLEX))

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

        s = self.state
        prev_top_r = s.par.top_r
        if i_round == 0 or not cfg.skip_e:
            if self.model.search_type == SEARCH_TYPE_GLOBAL and cfg.g_search:
                stage.begin("global_search")
                g = self.expectation_global(rings)
                stage.begin("adopt_global")
                self.adopt_global(g)
            stage.begin("phases")
            record["n_phases"] = self.local_phases(rings)
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
            stage.begin("max_stats")
            self.maximization_stats(i_round)
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
        other ranks, which send their rows there)."""
        cfg = self.cfg
        w = torch.as_tensor(mask, dtype=REAL, device=self.device)
        s = self.state
        mine = torch.empty((self.nh, self.n_img, cfg.size, cfg.size), dtype=REAL,
                           device=self.device)
        for h in range(self.nh):
            table = subtract_table(s.refs[h] * w, cfg.pf, self.nd)
            eff_t = s.par.top_t[h] - self.offset[h]
            for lo in range(0, self.n_img, chunk):
                sl = slice(lo, min(self.n_img, lo + chunk))
                mine[h, sl] = subtract_batch(
                    self.data.ft_ori[h, sl], self.data.ctf_params.map(lambda a: a[h, sl]),
                    table, s.cls[h, sl], s.par.top_r[h, sl], eff_t[sl], cfg.size, cfg.pf,
                    float(cfg.pixel_size))
        rows = comm.gather_rows_to_lead(self.layout, mine)
        if rows is None:
            return None
        rows = rows.cpu().numpy()
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
