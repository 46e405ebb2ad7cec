"""A wrapper's device time apart from the host's call rate.

CUDA events around a loop of calls measure how fast the host can make
them once the kernel takes only microseconds.  Here the calls are
captured into one CUDA graph and the graph is replayed: the card runs
them back to back with no host in between, so the time per call is the
kernel's own (plus the card's gap between two nodes of a graph, which
:func:`empty_launch_ms` measures with an empty kernel launched the same
way).
"""

from __future__ import annotations

import torch

from thunder_tpu_torch import _native


def graph_ms(fn, calls: int = 20, replays: int = 5, args: list | None = None) -> float:
    """Mean device milliseconds of one ``fn()`` (``fn(*args[k])``, cycling,
    when ``args`` is given) inside a replayed CUDA graph of ``calls``
    calls.  Whatever device work the call enqueues besides its kernel (a
    zero fill of its output, a copy) is part of the time."""
    call = (lambda k: fn()) if args is None else (lambda k: fn(*args[k % len(args)]))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # first calls (builds, allocations) outside the capture
        call(0)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(calls):
            call(k)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * calls)


def empty_launch_ms(calls: int = 20, replays: int = 5) -> float:
    """:func:`graph_ms` of an empty kernel (csrc/launch_floor.cu): the
    least a launch costs the card."""
    lib = _native.library()

    def launch():
        _native.check(lib.thunder_empty_launch(torch.cuda.current_stream().cuda_stream),
                      "empty_launch")

    return graph_ms(launch, calls, replays)
