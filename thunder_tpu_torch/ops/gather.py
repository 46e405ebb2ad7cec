"""The gathers of the repo's Pallas TPU microbenchmarks — and the host
of kernels G1-G5 (csrc/gather.cu).

  G1 take_flat         out[i]    = t[idx[i]]
  G2 take_along_rows   out[b, l] = tab[idx[b, l], l]
  G3 take_along_lanes  out[b, l] = src[b, idx[b, l]]
  G4 take_along_both   out[b, l] = tab[ridx[b, m], m],  m = lidx[b, l]
  G5 take_rows         out[s, :] = tab[rows[s], :]

Indices are clamped into their axis, as the microbenchmarks jnp.clip
theirs before each kernel.  Tables are float32, indices int32.  Each
function takes its plain version (``torch.take``, ``torch.gather``,
``index_select``) for CPU tensors and launches its kernel for CUDA
tensors; gathers are exact, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import REAL


def _check(name: str, tab: torch.Tensor, *idx: torch.Tensor) -> None:
    _native.require(tab.dtype == REAL and tab.is_contiguous(),
                    f"{name}: the table must be contiguous float32")
    for i in idx:
        _native.require(i.dtype == torch.int32 and i.is_contiguous()
                        and i.device == tab.device,
                        f"{name}: indices must be contiguous int32 on the table's device")


def _clamp(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(idx.long(), 0, n - 1)


# -- G1 -----------------------------------------------------------------

def take_flat_plain(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take(t, _clamp(idx, t.numel()))


def take_flat(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = t.flat[idx[i]], any index shape."""
    if not t.is_cuda:
        return take_flat_plain(t, idx)
    _check("take_flat", t, idx)
    out = torch.empty(idx.shape, dtype=REAL, device=t.device)
    lib = _native.library()
    take_flat.launches += 1
    _native.check(lib.thunder_take_flat(
        t.data_ptr(), t.numel(), idx.data_ptr(), idx.numel(), out.data_ptr(),
        _native.stream_ptr(t)), "take_flat")
    return out


take_flat.launches = 0


# -- G2-G4 --------------------------------------------------------------

def take_along_rows_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """jnp.take_along_axis(tab, idx, axis=0) for idx (B, W) over tab
    (R, W) with any B."""
    return torch.gather(tab, 0, _clamp(idx, tab.shape[0]))


def take_along_lanes_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(src, 1, _clamp(idx, src.shape[1]))


def take_along_both_plain(tab: torch.Tensor, ridx: torch.Tensor,
                          lidx: torch.Tensor) -> torch.Tensor:
    rows = take_along_rows_plain(tab, ridx)      # rows[b, l] = tab[ridx[b, l], l]
    return take_along_lanes_plain(rows, lidx)


def _take_along(name, fn, mode: int, tab, ridx, lidx, out_shape):
    _check(name, tab, *[i for i in (ridx, lidx) if i is not None])
    width = tab.shape[1]
    _native.require(tab.ndim == 2 and out_shape[1] == width,
                    f"{name}: table and indices must share the lane width")
    out = torch.empty(out_shape, dtype=REAL, device=tab.device)
    lib = _native.library()
    fn.launches += 1
    _native.check(lib.thunder_take_along(
        tab.data_ptr(), tab.shape[0], None if ridx is None else ridx.data_ptr(),
        None if lidx is None else lidx.data_ptr(), out.numel(), width, mode,
        out.data_ptr(), _native.stream_ptr(tab)), name)
    return out


def take_along_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, l] = tab[idx[b, l], l]: tab (R, W), idx (B, W)."""
    if not tab.is_cuda:
        return take_along_rows_plain(tab, idx)
    return _take_along("take_along_rows", take_along_rows, 0, tab, idx, None,
                       idx.shape)


def take_along_lanes(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[b, l] = src[b, idx[b, l]]: src and idx (B, W)."""
    if not src.is_cuda:
        return take_along_lanes_plain(src, idx)
    _native.require(src.shape == idx.shape,
                    "take_along_lanes: src and idx must have one shape")
    return _take_along("take_along_lanes", take_along_lanes, 1, src, None, idx,
                       idx.shape)


def take_along_both(tab: torch.Tensor, ridx: torch.Tensor,
                    lidx: torch.Tensor) -> torch.Tensor:
    """out[b, l] = tab[ridx[b, m], m] with m = lidx[b, l] — a row take
    then a lane shuffle (not tab[ridx, lidx]): tab (R, W), ridx and
    lidx (B, W)."""
    if not tab.is_cuda:
        return take_along_both_plain(tab, ridx, lidx)
    _native.require(ridx.shape == lidx.shape,
                    "take_along_both: ridx and lidx must have one shape")
    return _take_along("take_along_both", take_along_both, 2, tab, ridx, lidx,
                       lidx.shape)


take_along_rows.launches = 0
take_along_lanes.launches = 0
take_along_both.launches = 0


# -- G5 -----------------------------------------------------------------

def take_rows_plain(tab: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return torch.index_select(tab, 0, _clamp(rows, tab.shape[0]))


def take_rows(tab: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[s, :] = tab[rows[s], :]: tab (R, W) with W a multiple of 4,
    rows (S,) -> (S, W)."""
    if not tab.is_cuda:
        return take_rows_plain(tab, rows)
    _check("take_rows", tab, rows)
    _native.require(tab.ndim == 2 and tab.shape[1] % 4 == 0
                    and tab.data_ptr() % 16 == 0,
                    "take_rows: rows must be whole float4s, 16-byte aligned")
    out = torch.empty((rows.numel(), tab.shape[1]), dtype=REAL, device=tab.device)
    lib = _native.library()
    take_rows.launches += 1
    _native.check(lib.thunder_take_rows(
        tab.data_ptr(), tab.shape[0], tab.shape[1], rows.data_ptr(), rows.numel(),
        out.data_ptr(), _native.stream_ptr(tab)), "take_rows")
    return out


take_rows.launches = 0

KERNELS = (take_flat, take_along_rows, take_along_lanes, take_along_both,
           take_rows)
