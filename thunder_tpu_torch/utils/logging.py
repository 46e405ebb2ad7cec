"""Observability, as thunder_tpu.utils.logging: named loggers, memory
reporting, structured per-round metrics, timed blocks and profiler traces.

Replaces the reference's easylogging++ setup (src/Logging.cpp): nine
named loggers with per-process files, VmRSS memory checks
(Logging.cpp:113-141, CHECK_MEMORY_USAGE), and adds what the reference
never had (SURVEY §5): structured per-round metrics and on-demand
profiler traces (torch.profiler here, the JAX profiler there).
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager

LOGGER_NAMES = (
    "SYS", "INIT", "ROUND", "COMPARE", "RECO", "MEM", "FFT", "TPU", "IO",
)


def init_loggers(log_file: str | None = None,
                 level: int = logging.INFO) -> dict[str, logging.Logger]:
    """Create the named logger family; optional shared file sink."""
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    fmt = logging.Formatter("%(asctime)s [%(name)s] %(levelname)s %(message)s")
    loggers = {}
    for name in LOGGER_NAMES:
        lg = logging.getLogger(f"thunder.{name}")
        lg.setLevel(level)
        if not lg.handlers:
            for h in handlers:
                h.setFormatter(fmt)
                lg.addHandler(h)
        loggers[name] = lg
    return loggers


def memory_rss_gb() -> float:
    """Resident set size in GB from /proc (Logging.cpp:113-141); NaN where
    the host has no /proc."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024**2
    except OSError:
        pass
    return float("nan")


def device_memory_gb() -> dict:
    """Each CUDA device's memory in GB: what this process's tensors hold
    (``memory_allocated``) and the card's size (``mem_get_info``); empty
    without a card."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {"bytes_in_use_gb": torch.cuda.memory_allocated(i) / 1024**3,
                            "bytes_limit_gb": torch.cuda.mem_get_info(i)[1] / 1024**3}
    return out


def check_memory(tag: str, logger: logging.Logger | None = None) -> None:
    lg = logger or logging.getLogger("thunder.MEM")
    lg.info("%s: host RSS %.2f GB", tag, memory_rss_gb())


class RoundMetrics:
    """JSONL per-round metrics sink (a structured upgrade over the
    reference's Class_Info/FSC text files)."""

    def __init__(self, path: str):
        self.path = path

    def write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


@contextmanager
def profiler_trace(log_dir: str | None):
    """torch.profiler around a block (CPU, and CUDA where a card is
    visible), its Chrome trace written into ``log_dir`` (view with
    chrome://tracing or Perfetto).  No-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextmanager
def timed(name: str, sink: dict | None = None,
          logger: logging.Logger | None = None):
    t0 = time.time()
    yield
    dt = time.time() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    (logger or logging.getLogger("thunder.ROUND")).debug("%s: %.3fs", name, dt)
