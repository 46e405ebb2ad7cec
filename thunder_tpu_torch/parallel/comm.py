"""The collectives of a multi-rank run, written out where thunder_tpu's
partitioner inserted them implicitly (psum over "data", pmax, the
cross-hemisphere meeting, process gathers, the z-slab all_to_all).

Every function takes the rank's :class:`~thunder_tpu_torch.parallel.mesh.Layout`
and is the identity where its group has one rank, so the one-process
path runs exactly the operations it ran before ranks existed.

Transports: NCCL takes every collective on CUDA tensors.  Gloo takes
``all_reduce`` and ``broadcast`` on CUDA tensors and everything on CPU
tensors; every other collective on a CUDA tensor under gloo is staged
here through pinned host buffers (``staged_bytes`` counts them).
Complex tensors travel as their (re, im) float view.

``STATS[name]`` counts each collective's calls, the bytes this rank put
in (``bytes``) and the bytes staged through the host.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch.parallel.mesh import Layout, make_mesh

STATS: dict = {}
_PINNED: dict = {}


def reset_stats() -> None:
    STATS.clear()


def _count(name: str, t: torch.Tensor, staged: bool) -> None:
    s = STATS.setdefault(name, {"calls": 0, "bytes": 0, "staged_bytes": 0})
    n = t.numel() * t.element_size()
    s["calls"] += 1
    s["bytes"] += n
    if staged:
        s["staged_bytes"] += n


def _real(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _staged(layout: Layout, t: torch.Tensor) -> bool:
    return layout.backend == "gloo" and t.is_cuda


def _pinned(tag: str, like: torch.Tensor) -> torch.Tensor:
    """A pinned host buffer shaped like ``like`` (kept for the next call
    of the same tag and shape)."""
    key = (tag, like.dtype, tuple(like.shape))
    if key not in _PINNED:
        _PINNED[key] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return _PINNED[key]


def _to_host(tag: str, t: torch.Tensor) -> torch.Tensor:
    h = _pinned(tag, t)
    h.copy_(t)
    return h


def _all_reduce(layout: Layout, name: str, t: torch.Tensor, op, group) -> torch.Tensor:
    import torch.distributed as dist

    _count(name, t, False)
    dist.all_reduce(_real(t) if t.is_complex() else t, op=op, group=group)
    return t


def sum_data(layout: Layout, t: torch.Tensor) -> torch.Tensor:
    """SUM over the rank's data group (thunder_tpu's psum over "data"),
    in place on a contiguous ``t``; returns it."""
    import torch.distributed as dist

    if layout.data == 1:
        return t
    return _all_reduce(layout, "sum_data", t, dist.ReduceOp.SUM, layout.groups["data"])


def sum_world(layout: Layout, t: torch.Tensor) -> torch.Tensor:
    """SUM over every rank, in place; returns it."""
    import torch.distributed as dist

    if layout.world == 1:
        return t
    return _all_reduce(layout, "sum_world", t, dist.ReduceOp.SUM, None)


def max_world(layout: Layout, t: torch.Tensor) -> torch.Tensor:
    """MAX over every rank, in place; returns it."""
    import torch.distributed as dist

    if layout.world == 1:
        return t
    return _all_reduce(layout, "max_world", t, dist.ReduceOp.MAX, None)


def max_data(layout: Layout, t: torch.Tensor) -> torch.Tensor:
    """MAX over the data group (the balance loop's pmax), in place."""
    import torch.distributed as dist

    if layout.data == 1:
        return t
    return _all_reduce(layout, "max_data", t, dist.ReduceOp.MAX, layout.groups["data"])


def _all_gather(layout: Layout, name: str, t: torch.Tensor, n: int, group) -> list:
    """``n`` equal blocks, one a rank of ``group`` in group order."""
    import torch.distributed as dist

    staged = _staged(layout, t)
    _count(name, t, staged)
    src = _real(t)
    if staged:
        src = _to_host(name, src)
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    fix = (lambda x: torch.view_as_complex(x)) if t.is_complex() else (lambda x: x)
    return [fix(x.to(t.device) if staged else x) for x in out]


def _assemble(layout: Layout, blocks: list, n_img: int) -> torch.Tensor:
    """Per-rank row blocks, world order -> the global (2, n_img, ...)."""
    out = torch.empty((2, n_img) + blocks[0].shape[2:], dtype=blocks[0].dtype,
                      device=blocks[0].device)
    for r, b in enumerate(blocks):
        h_sl, l_sl = make_mesh(layout.world, layout.hemi, r).rows(n_img)
        out[h_sl, l_sl] = b
    return out


def all_gather_rows(layout: Layout, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of a (2, L, ...) quantity on every rank, in
    global order: x is this rank's (hemispheres, L / data, ...) block.
    What a median over all images needs (a median is not a sum)."""
    if layout.world == 1:
        return x
    blocks = _all_gather(layout, "all_gather_rows", x, layout.world, None)
    return _assemble(layout, blocks, x.shape[1] * layout.data)


def gather_rows_to_lead(layout: Layout, x: torch.Tensor) -> torch.Tensor | None:
    """The global (2, L, ...) rows on rank 0, None elsewhere (the
    outputs rank 0 alone writes)."""
    import torch.distributed as dist

    if layout.world == 1:
        return x
    staged = _staged(layout, x)
    _count("gather_rows_to_lead", x, staged)
    src = _real(x)
    if staged:
        src = _to_host("gather_rows_to_lead", src)
    out = ([torch.empty_like(src) for _ in range(layout.world)]
           if layout.rank == 0 else None)
    dist.gather(src, out, dst=0)
    if out is None:
        return None
    fix = (lambda b: torch.view_as_complex(b)) if x.is_complex() else (lambda b: b)
    blocks = [fix(b.to(x.device) if staged else b) for b in out]
    return _assemble(layout, blocks, x.shape[1] * layout.data)


def gather_host_rows_to_lead(layout: Layout, x: torch.Tensor, step: int,
                             device) -> torch.Tensor | None:
    """:func:`gather_rows_to_lead` of a host tensor x (hemispheres, n,
    ...), ``step`` rows of every rank at a time, into a host tensor on
    rank 0 (None elsewhere): no rank's whole block lies on a device.
    Under NCCL each step travels from ``device``."""
    if layout.world == 1:
        return x
    n = x.shape[1]
    out = (torch.empty((2, n * layout.data) + x.shape[2:], dtype=x.dtype)
           if layout.rank == 0 else None)
    for lo in range(0, n, step):
        sl = slice(lo, min(n, lo + step))
        part = x[:, sl].to(device) if layout.backend == "nccl" else x[:, sl]
        got = gather_rows_to_lead(layout, part)
        if got is not None:
            # rank j of the data axis sent its rows sl: global rows j n + sl
            m = sl.stop - sl.start
            for j in range(layout.data):
                out[:, j * n + sl.start:j * n + sl.stop] = got[:, j * m:(j + 1) * m].cpu()
    return out


def exchange_hemi(layout: Layout, x: torch.Tensor) -> torch.Tensor:
    """Both hemispheres of a per-hemisphere quantity: x is this rank's
    (hemispheres, ...) block; returns (2, ...) from the hemisphere pair
    (thunder_tpu's cross-half meeting in _reconstruct_and_compare)."""
    if layout.hemi == 1:
        return x
    a, b = _all_gather(layout, "exchange_hemi", x, 2, layout.groups["pair"])
    return torch.cat([a, b])


def gather_slabs(layout: Layout, x: torch.Tensor, axis: int = -3) -> torch.Tensor:
    """The data group's z-slabs joined along ``axis`` in data-rank order
    (a sharded volume made whole on every rank of its hemisphere)."""
    if layout.data == 1:
        return x
    return torch.cat(_all_gather(layout, "gather_slabs", x, layout.data,
                                 layout.groups["data"]), dim=axis)


def _all_to_all(layout: Layout, name: str, chunks: torch.Tensor, splits=None) -> torch.Tensor:
    """all_to_all_single over the data group on a (d, ...) stack of
    contiguous chunks (chunk k to data rank k) or, with ``splits``, a
    flat tensor cut by those sizes; returns what arrived, in the same
    form."""
    import torch.distributed as dist

    staged = _staged(layout, chunks)
    _count(name, chunks, staged)
    src = _real(chunks)
    if staged:
        src = _to_host(name + ".in", src)
    out = torch.empty_like(src) if not staged else _pinned(name + ".out", src)
    dist.all_to_all_single(out, src, output_split_sizes=splits, input_split_sizes=splits,
                           group=layout.groups["data"])
    if staged:
        out = out.to(chunks.device)
    return torch.view_as_complex(out) if chunks.is_complex() else out


def all_to_all_z(layout: Layout, x: torch.Tensor, split_axis: int,
                 concat_axis: int) -> torch.Tensor:
    """jax.lax.all_to_all(x, "data", split_axis, concat_axis, tiled=True)
    over the data group: x is cut into d blocks along ``split_axis``,
    block k goes to data rank k, and the blocks that arrive are joined
    along ``concat_axis`` in data-rank order (the slab transpose of a
    distributed FFT)."""
    d = layout.data
    if d == 1:
        return x
    chunks = torch.stack(torch.chunk(x, d, dim=split_axis)).contiguous()
    got = _all_to_all(layout, "all_to_all_z", chunks)
    return torch.cat(list(got), dim=concat_axis)


def swap_data(layout: Layout, x: torch.Tensor, peer: int) -> torch.Tensor:
    """Send x to data rank ``peer`` and receive the peer's x (the
    whole-slab ppermute of a half-box roll along the sharded axis)."""
    if peer == layout.j:
        return x
    splits = [x.numel() if k == peer else 0 for k in range(layout.data)]
    got = _all_to_all(layout, "swap_data", x.contiguous().reshape(-1), splits)
    return got.reshape(x.shape)
