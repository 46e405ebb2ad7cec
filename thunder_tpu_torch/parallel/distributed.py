"""Process-group set-up: one process a rank, one device a rank
(thunder_tpu.parallel.distributed on ``torch.distributed``).

THUNDER launches MPI ranks (src/Parallel.cpp); thunder_tpu initialises
``jax.distributed`` and builds a mesh over every device.  Here each rank
is a process given its address, world size and rank
(``--coordinator H:P --num-processes N --process-id i``); rank i takes
``cuda:(i % cards)``, or the CPU where the caller asks for it.

The transport follows the topology, never a caught error: NCCL where
every rank owns a card, gloo where ranks share one (NCCL refuses two
ranks on one GPU) or run on the CPU.  Every collective carries the
group's timeout, so a rank that never arrives fails the others instead
of hanging them.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch

from thunder_tpu_torch.parallel.mesh import Layout, make_mesh, single

log = logging.getLogger("thunder.SYS")

TIMEOUT_S = 900


def rank_device(rank: int, device: str = "cuda") -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank % cards)``, or the CPU."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible: pass --device cpu to run the "
                           "ranks on the CPU")
    return torch.device("cuda", rank % n)


def choose_backend(world: int, device: str = "cuda") -> str:
    """NCCL where every rank owns a card, else gloo (ranks that share a
    card, or the CPU)."""
    if torch.device(device).type == "cpu" or world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device: str = "cuda",
                   timeout_s: float = TIMEOUT_S) -> int:
    """Join the process group of ``num_processes`` ranks at
    ``tcp://coordinator_address`` as rank ``process_id``; a no-op for one
    process.  Returns the world size."""
    import torch.distributed as dist

    if num_processes is None or num_processes <= 1:
        return 1
    if coordinator_address is None or process_id is None:
        raise ValueError("--num-processes > 1 needs --coordinator and --process-id")
    if dist.is_initialized():
        return dist.get_world_size()
    backend = choose_backend(num_processes, device)
    dev = rank_device(process_id, device)
    # the ranks share the host's cores: threads a rank that do not
    # oversubscribe them (several ranks' spinning thread pools on the
    # same cores slow a CPU round many times over)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_processes))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log.info("process group: rank %d of %d over %s at %s, device %s", process_id,
             num_processes, backend, coordinator_address, dev)
    return num_processes


def build_groups(layout: Layout) -> Layout:
    """Create the layout's process groups, on every rank in the same
    order: one data group a hemisphere, then one pair a data index."""
    import torch.distributed as dist

    if layout.world == 1:
        return layout
    groups = {}
    if layout.hemi == 2:
        for h in (0, 1):
            g = dist.new_group(layout.data_ranks(h))
            if h == layout.h:
                groups["data"] = g
        for j in range(layout.data):
            g = dist.new_group(layout.pair_ranks(j))
            if j == layout.j:
                groups["pair"] = g
    else:
        groups["data"] = dist.group.WORLD
    layout.groups = groups
    return layout


def default_mesh(hemi: int = 2, device: str = "cuda") -> Layout:
    """The standard layout over the process group (thunder_tpu's
    default_mesh): (hemi, data) where the world splits into ``hemi``
    equal parts, else data-only; groups built.  One process: the
    one-process layout."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return single()
    world, rank = dist.get_world_size(), dist.get_rank()
    h = hemi if world >= hemi and world % hemi == 0 else 1
    layout = make_mesh(world, h, rank, rank_device(rank, device), dist.get_backend())
    return build_groups(layout)
