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
tensors; gathers are exact, so the two agree bit for bit.  G1-G4 also
write into a given ``out`` (contiguous, at any offset).

:func:`along_form` chooses G2-G4's form from the shapes and the
tensors' byte offsets (the forms: csrc/gather.cu), in plain Python, so
the CPU tests reach it; each of the three wrappers records the form of
its last launch in ``last_form``.
"""

from __future__ import annotations

import functools

import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import REAL

# G2-G4's forms (csrc/gather.cu FORM_*)
FORMS = ("scalar", "row", "strip16", "strip64")
# outputs (B x W) from which G2 stages the table in shared memory, in
# strips of 16 and of 64 columns: below them a block's staging costs more
# than the gather it serves.  Measured alone at W = 128 on tables of 128
# and 512 rows, B = 256-131,072 (micro/hk_candidates.py --kernels gather;
# PERF.md section 6): 16-column strips beat the scalar form at both heights
# from B = 768 (at 512 rows a tie at 512), 64-column strips beat them from
# B = 8,192 (at 4,096 the 16-column strips are ahead at both heights)
STRIP_MIN_OUTPUTS = {16: 3 << 15, 64: 1 << 20}
# the tallest table G2 stages: a block's staging grows with the table's
# rows, and the thresholds above hold up to the heights they were measured at
STRIP_MAX_ROWS = 512


@functools.lru_cache(maxsize=None)
def _const(name: str) -> int:
    return _native.csrc_constant("gather.cu", name)


def _check(name: str, tab: torch.Tensor, *idx: torch.Tensor) -> None:
    _native.require(tab.dtype == REAL and tab.is_contiguous(),
                    f"{name}: the table must be contiguous float32")
    for i in idx:
        _native.require(i.dtype == torch.int32 and i.is_contiguous()
                        and i.device == tab.device,
                        f"{name}: indices must be contiguous int32 on the table's device")


def _clamp(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(idx.long(), 0, n - 1)


def _out(name: str, out, shape, tab: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=REAL, device=tab.device)
    _native.require(out.dtype == REAL and out.is_contiguous() and out.device == tab.device
                    and tuple(out.shape) == tuple(shape),
                    f"{name}: out must be contiguous float32 of shape {tuple(shape)} on the "
                    "table's device")
    return out


def _into(out, res: torch.Tensor) -> torch.Tensor:
    """The plain result, written into ``out`` where one was given."""
    return res if out is None else out.copy_(res)


def _offset(x: torch.Tensor) -> int:
    return x.data_ptr() % 16


# -- G1 -----------------------------------------------------------------

def take_flat_plain(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take(t, _clamp(idx, t.numel()))


def take_flat(t: torch.Tensor, idx: torch.Tensor, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """out[i] = t.flat[idx[i]], any index shape."""
    if not t.is_cuda:
        return _into(out, take_flat_plain(t, idx))
    _check("take_flat", t, idx)
    out = _out("take_flat", out, idx.shape, t)
    lib = _native.library()
    take_flat.launches += 1
    _native.check(lib.thunder_take_flat(
        t.data_ptr(), t.numel(), idx.data_ptr(), idx.numel(), out.data_ptr(),
        _native.stream_ptr(t)), "take_flat")
    return out


take_flat.launches = 0


# -- G2-G4 --------------------------------------------------------------

def along_forms(mode: int, n_rows: int, width: int, offsets=()) -> tuple:
    """The forms csrc/gather.cu can launch for mode 0 (G2), 1 (G3) or 2
    (G4) on a table of ``n_rows`` x ``width`` (G3: src's width), given the
    tensors' byte offsets mod 16.  "scalar" takes anything; the others
    need width % 4 == 0 and every tensor 16-byte aligned: "strip16" and
    "strip64" (G2) a width of whole strips and n_rows x strip floats
    within a block's shared memory, "row" (G3, G4) width <= ROW_WIDTH."""
    if width % 4 or any(o % 16 for o in offsets):
        return ("scalar",)
    if mode != 0:
        return ("scalar", "row") if width <= _const("ROW_WIDTH") else ("scalar",)
    return ("scalar",) + tuple(
        f"strip{sw}" for sw in STRIP_MIN_OUTPUTS
        if width % sw == 0 and n_rows * sw * 4 <= _native.SMEM_MAX)


def along_form(mode: int, n_rows: int, width: int, n_out: int, offsets=()) -> str:
    """The form a take_along launch takes: G2 on a table of at most
    STRIP_MAX_ROWS rows the widest strip it can whose STRIP_MIN_OUTPUTS
    the launch reaches; G3 and G4 "row"; else "scalar"."""
    forms = along_forms(mode, n_rows, width, offsets)
    if mode != 0:
        return forms[-1]
    for sw in sorted(STRIP_MIN_OUTPUTS, reverse=True):
        if (f"strip{sw}" in forms and n_rows <= STRIP_MAX_ROWS
                and n_out >= STRIP_MIN_OUTPUTS[sw]):
            return f"strip{sw}"
    return "scalar"


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


def _take_along(fn, mode: int, tab, ridx, lidx, out=None, form: str | None = None):
    """Launch G2-G4 (``fn``, mode 0-2) in :func:`along_form`'s choice, or
    in ``form`` (micro/hk_candidates.py times each); ``fn.last_form`` is
    the form of its last launch."""
    name = fn.__name__
    idx = [i for i in (ridx, lidx) if i is not None]
    _check(name, tab, *idx)
    width = tab.shape[1]
    _native.require(tab.ndim == 2 and idx[0].ndim == 2 and idx[0].shape[1] == width,
                    f"{name}: table and indices must share the lane width")
    out = _out(name, out, idx[0].shape, tab)
    offsets = [_offset(x) for x in (tab, *idx, out)]
    if form is None:
        form = along_form(mode, tab.shape[0], width, out.numel(), offsets)
    _native.require(form in along_forms(mode, tab.shape[0], width, offsets),
                    f"{name}: form {form!r} cannot take these shapes and offsets")
    lib = _native.library()
    fn.launches += 1
    fn.last_form = form
    _native.check(lib.thunder_take_along(
        tab.data_ptr(), tab.shape[0], None if ridx is None else ridx.data_ptr(),
        None if lidx is None else lidx.data_ptr(), out.numel(), width, mode,
        _const(f"FORM_{form.upper()}"), out.data_ptr(), _native.stream_ptr(tab)), name)
    return out


def take_along_rows(tab: torch.Tensor, idx: torch.Tensor, out: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """out[b, l] = tab[idx[b, l], l]: tab (R, W), idx (B, W)."""
    if not tab.is_cuda:
        return _into(out, take_along_rows_plain(tab, idx))
    return _take_along(take_along_rows, 0, tab, idx, None, out)


def take_along_lanes(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """out[b, l] = src[b, idx[b, l]]: src and idx (B, W)."""
    if not src.is_cuda:
        return _into(out, take_along_lanes_plain(src, idx))
    _native.require(src.shape == idx.shape,
                    "take_along_lanes: src and idx must have one shape")
    return _take_along(take_along_lanes, 1, src, None, idx, out)


def take_along_both(tab: torch.Tensor, ridx: torch.Tensor, lidx: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """out[b, l] = tab[ridx[b, m], m] with m = lidx[b, l] — a row take
    then a lane shuffle (not tab[ridx, lidx]): tab (R, W), ridx and
    lidx (B, W)."""
    if not tab.is_cuda:
        return _into(out, take_along_both_plain(tab, ridx, lidx))
    _native.require(ridx.shape == lidx.shape,
                    "take_along_both: ridx and lidx must have one shape")
    return _take_along(take_along_both, 2, tab, ridx, lidx, out)


for _fn in (take_along_rows, take_along_lanes, take_along_both):
    _fn.launches = 0
    _fn.last_form = None


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
