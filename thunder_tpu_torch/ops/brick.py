"""Brick-window slice projection for concentrated rotation clouds
(thunder_tpu ops/brick.py) — the host of hand kernel HK13
(``project_brick``).

In local and CTF rounds the R rotations of an image are perturbations
of one pose, so for a pixel p all R sample points lie in a small ball
around the mean sample point.  thunder_tpu stores its projection table
in overlapping SPAN^3 bricks anchored every STRIDE cells
(``brick_pack_half``), fetches one brick per (image, pixel) and
interpolates every rotation inside it.  A sample whose window offset
leaves [0, SPAN - 1] on any axis gets zero weight (``_axis_hat``): it
scores as missing signal, not as the value of a closer pose.

The port computes the same function from its own table, the centered
float32 cube of size ``crop`` (or HK1's quad table of it, whose cell
holds its (y, x) quad, its own tap first): the brick table is the TPU's storage layout
and is not built.  Per (image, pixel): the mean rotation's sample point
folds into kx >= 0 (sgn = -1 where its x is negative; the value returned
is (re, sgn im)), and each axis' anchor is round((sgn v + lo - (SPAN -
1) / 2) / STRIDE), half to even, clipped to the brick grid (lo = c, n =
ceil(crop / STRIDE) for z and y; lo = g = guard_planes, n = ceil((g +
c) / STRIDE) for x), c = crop // 2.  Per sample: the offsets sgn v -
(anchor STRIDE - c) (x: - g) inside the window give the trilinear value
of the window's cells, a cell past the cube reading 0 as the brick
table's zero padding does; outside the window the value is 0.

c is the cube's own half size.  thunder_tpu's optimiser passes b = nz
STRIDE for the cube's size (``Optimiser._brick_statics``), which
differs from crop where crop is not a multiple of STRIDE and can move
c, and with it every window, by one cell (crop = 52 on rung (7, 3)); the
port does not copy that.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import COMPLEX, REAL
from thunder_tpu_torch.ops.projector import is_quad_table


def _row_width(span: int) -> int:
    n = span ** 3
    w = 1
    while w < n:
        w *= 2
    return w


def guard_planes(span: int, stride: int) -> int:
    """Brick planes below kx = 0, a multiple of the stride so that the
    anchor grid aligns (folded anchors near the kx = 0 plane stay in
    range)."""
    return ((span + stride - 1) // stride) * stride


def spread_margin(span: int, stride: int) -> float:
    """The deviation (cells) around the mean sample point a window is
    sure to hold: SPAN - 1 usable cells (a trilinear stencil needs its
    base + 1), less half a stride of anchor quantisation."""
    return (span - 1) / 2.0 - stride / 2.0


def table_bytes(span: int, stride: int, b: int, k_cls: int = 1) -> int:
    """Bytes of thunder_tpu's brick table for K cubes of b^3 (rows of
    next_pow2(SPAN^3) 4-byte words): what its plan admits a rung by.
    The port reads its own table and builds none; the plan keeps the
    reference's rule."""
    g = guard_planes(span, stride)
    c = b // 2
    nz = ny = (b + stride - 1) // stride
    nx = (g + c + stride - 1) // stride
    return k_cls * nz * ny * nx * _row_width(span) * 4


def brick_grid(span: int, stride: int, crop: int) -> tuple:
    """(c, g, nz, nx): the cube's half size, the guard planes and the
    anchor grid's extent in z (and y) and x, for a cube of ``crop``."""
    c = crop // 2
    g = guard_planes(span, stride)
    return c, g, (crop + stride - 1) // stride, (g + c + stride - 1) // stride


def _coords(m: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> list:
    """Sample points m . (fx, fy, 0) of rotations m (..., 3, 3) at the
    pixels: [x, y, z], each (..., P)."""
    return [m[..., a, 0:1] * fx + m[..., a, 1:2] * fy for a in range(3)]


def project_brick_plain(table: torch.Tensor, rot: torch.Tensor, mrot: torch.Tensor,
                        i_col: torch.Tensor, i_row: torch.Tensor, pf: int, span: int,
                        stride: int, cls: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of HK13: table (K, n, n, n) complex64 centered or
    its quad table, rot (L, R, 3, 3), mrot (L, 3, 3) the mean of rot over
    R, cls (L,) or None -> (L, R, P) complex64 (see the module's
    docstring)."""
    if is_quad_table(table):
        table = torch.view_as_complex(table[..., :2])
    n = table.shape[-1]
    c, g, nz, nx = brick_grid(span, stride, n)
    fx = (i_col * pf).to(REAL)
    fy = (i_row * pf).to(REAL)
    pos = _coords(rot, fx, fy)                          # (L, R, P) each
    mean = _coords(mrot, fx, fy)                        # (L, P) each
    sgn = torch.where(mean[0] < 0, -1.0, 1.0).to(REAL)
    half = (span - 1) / 2.0
    n_l = rot.shape[0]
    k = (torch.zeros(n_l, dtype=torch.int64, device=table.device)
         if cls is None else cls.to(torch.int64))
    index = (k * n ** 3).reshape(n_l, 1, 1)
    weights = []
    ok = torch.ones(pos[0].shape, dtype=torch.bool, device=table.device)
    # z, y, x: the anchor's grid extent, its low planes, the cube's
    # index of window cell 0 less the anchor's
    for v, m, n_a, lo, shift, scale in ((pos[2], mean[2], nz, c, 0, n * n),
                                        (pos[1], mean[1], nz, c, 0, n),
                                        (pos[0], mean[0], nx, g, c - g, 1)):
        # divided by a tensor: on CUDA tensors PyTorch divides by a Python
        # scalar as a product with its reciprocal, which at stride 3 moves
        # the anchors of quotients near a half from the kernel's rint
        q = m * sgn + lo - half
        a = torch.clamp(torch.round(q / torch.full_like(q, stride)), 0, n_a - 1)
        off = v * sgn[:, None] - (a * stride - lo)[:, None]
        ok = ok & (off >= 0) & (off <= span - 1)
        j0 = torch.floor(off)
        w0 = torch.clamp(1 - torch.abs(off - j0), min=0)
        w1 = torch.where(j0 + 1 <= span - 1, torch.clamp(1 - torch.abs(off - (j0 + 1)), min=0),
                         torch.zeros_like(off))
        cell = (a * stride + shift)[:, None] + j0
        taps = []
        for w, i in ((w0, cell), (w1, cell + 1)):
            inside = (i >= 0) & (i < n)
            taps.append((torch.where(inside, w, torch.zeros_like(w)),
                         torch.clamp(i, 0, n - 1).to(torch.int64) * scale))
        weights.append(taps)
    flat = torch.view_as_real(table).reshape(-1, 2)
    (wz0, iz0), (wz1, iz1) = weights[0]
    (wy0, iy0), (wy1, iy1) = weights[1]
    (wx0, ix0), (wx1, ix1) = weights[2]
    zy = [(wz0 * wy0, iz0 + iy0), (wz0 * wy1, iz0 + iy1),
          (wz1 * wy0, iz1 + iy0), (wz1 * wy1, iz1 + iy1)]
    out = None
    for wx, ix in ((wx0, ix0), (wx1, ix1)):
        t = None
        for wzy, izy in zy:
            v = flat[index + izy + ix] * wzy[..., None]
            t = v if t is None else t + v
        t = t * wx[..., None]
        out = t if out is None else out + t
    out = torch.where(ok[..., None], out, torch.zeros_like(out))
    return torch.complex(out[..., 0], out[..., 1] * sgn[:, None]).to(COMPLEX)


def project_brick(table: torch.Tensor, rot: torch.Tensor, mrot: torch.Tensor,
                  i_col: torch.Tensor, i_row: torch.Tensor, pf: int, span: int, stride: int,
                  cls: torch.Tensor | None = None) -> torch.Tensor:
    """Brick-window slice projection (thunder_tpu ops/brick.py
    project_classed_brick): out[l, r, p] = the value of cube cls[l] at
    rot[l, r] . (pf i_col[p], pf i_row[p], 0) through the (SPAN, STRIDE)
    window its mean point mrot[l] . (...) anchors, 0 outside the window.

    table (K, n, n, n) complex64 centered, or HK1's (K, n, n, n, 8)
    float32 quad table (a sample reads a quad of each of its two z
    planes); rot (L, R, 3, 3) float32;
    mrot (L, 3, 3) float32, rot.mean(1) formed once by the caller; cls
    (L,) or None; pixels (P,) int32 -> (L, R, P) complex64.  CPU tensors
    take :func:`project_brick_plain`; CUDA tensors launch
    csrc/project_brick.cu."""
    if not table.is_cuda:
        return project_brick_plain(table, rot, mrot, i_col, i_row, pf, span, stride, cls)
    quad = is_quad_table(table)
    _native.require((quad or (table.ndim == 4 and table.dtype == COMPLEX))
                    and table.is_contiguous() and table.shape[1] ** 3 < 2 ** 31,
                    "project_brick: table must be contiguous (K, n, n, n) complex64 "
                    "or its (K, n, n, n, 8) float32 quad table")
    _native.require(rot.ndim == 4 and rot.shape[-2:] == (3, 3) and rot.dtype == REAL,
                    "project_brick: rot must be (L, R, 3, 3) float32")
    n_l, n_r = rot.shape[:2]
    _native.require(mrot.shape == (n_l, 3, 3) and mrot.dtype == REAL,
                    "project_brick: mrot must be (L, 3, 3) float32")
    _native.require(span >= 2 and stride >= 1, "project_brick: span >= 2, stride >= 1")
    rot, mrot = rot.contiguous(), mrot.contiguous()
    n = table.shape[1]
    _, g, nz, nx = brick_grid(span, stride, n)
    i_col = i_col.to(torch.int32).contiguous()
    i_row = i_row.to(torch.int32).contiguous()
    if cls is not None:
        cls = cls.to(torch.int32).contiguous()
        _native.require(cls.shape == (n_l,), "project_brick: cls must be (L,)")
    n_p = i_col.shape[0]
    out = torch.empty((n_l, n_r, n_p), dtype=COMPLEX, device=table.device)
    if out.numel() == 0:
        return out
    lib = _native.library()
    project_brick.launches += 1
    _native.check(lib.thunder_project_brick(
        table.data_ptr(), 4 if quad else 1, n, None if cls is None else cls.data_ptr(),
        rot.data_ptr(), mrot.data_ptr(), n_l, n_r, i_col.data_ptr(), i_row.data_ptr(), n_p,
        int(pf), span, stride, g, nz, nx, out.data_ptr(), _native.stream_ptr(table)),
        "project_brick")
    return out


project_brick.launches = 0
