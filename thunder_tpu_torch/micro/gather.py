"""Hopper gather microbenchmark: the eight ``pl.pallas_call`` gathers of
the repo's TPU microbenchmarks (scripts/micro_pallas_gather.py,
micro_mosaic_gather.py, micro_rowgather.py) as kernels G1-G5
(ops/gather.py), each against its plain PyTorch version, at the
scripts' default shapes, plus the scripts' XLA reference lines as plain
PyTorch — one run gives the whole shoot-out on the card.

    python -m thunder_tpu_torch.micro.gather [table_mb] [n_samples_m]

``table_mb`` (MiB, default 4) and ``n_samples_m`` (x 2^20, default 2)
size the flat-table cases of micro_pallas_gather.py; the other cases
keep their scripts' fixed shapes.  Needs a CUDA device.  Indices vary
from call to call (a few index sets, cycled), as in the scripts.
Times are CUDA events over repeated calls; GB/s counts the index bytes
read, the table bytes gathered and the output bytes written.  A case
whose call takes under 0.05 ms is also timed as a replayed CUDA graph of
its launches ("kernel alone": the events' time of so short a call is the
host's call rate).
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable

import torch

from thunder_tpu_torch.micro.launch_floor import graph_ms
from thunder_tpu_torch.ops import gather as g

LANES = 128
MOSAIC_ROWS, MOSAIC_B = 512, 1024          # micro_mosaic_gather.py:22-23
ROW_Z = ROW_Y = 60                          # micro_rowgather.py:25-27
ROW_S = 128 * 32 * 296 // 128 * 128
N_VARY = 4


@dataclass
class Case:
    name: str
    replaces: str
    kernel: Callable            # the G wrapper
    args: list                  # one argument tuple per index set
    unit: str                   # "taps" or "rows"
    count: int                  # taps or rows per call
    bytes: int                  # bytes moved per call


def _ri(gen, lo, hi, shape, dev):
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32)


def build_cases(dev, table_mb: float = 4.0, n_samples_m: float = 2.0,
                seed: int = 0) -> list:
    """The eight cases with N_VARY index sets each, made on ``dev``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_elem = int(table_mb * 2 ** 20) // 4 // LANES * LANES
    n_samp = int(n_samples_m * 2 ** 20) // LANES * LANES
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    t = randn(n_elem)
    idx = [_ri(gen, 0, n_elem, (n_samp,), dev) for _ in range(N_VARY)]
    # f_pallas2's (rows, 128) view: the row take then the lane take
    # pick t[(i // 128) * 128 + i % 128]
    idx2 = [((i // LANES) * LANES + i % LANES).reshape(-1, LANES) for i in idx]
    tab = randn(MOSAIC_ROWS, LANES)
    src = randn(MOSAIC_B, LANES)
    ridx = [_ri(gen, 0, MOSAIC_ROWS, (MOSAIC_B, LANES), dev) for _ in range(N_VARY)]
    lidx = [_ri(gen, 0, LANES, (MOSAIC_B, LANES), dev) for _ in range(N_VARY)]
    rvec = [_ri(gen, 0, MOSAIC_ROWS, (MOSAIC_B,), dev) for _ in range(N_VARY)]
    tab_h = randn(ROW_Z * ROW_Y, LANES)
    blk = ROW_Z * ROW_Y
    s_pad = -(-ROW_S // blk) * blk
    zy = [torch.nn.functional.pad(_ri(gen, 0, blk - ROW_Y - 1, (ROW_S,), dev),
                                  (0, s_pad - ROW_S)) for _ in range(N_VARY)]
    el = MOSAIC_B * LANES
    row_b = LANES * 4
    return [
        Case("f_pallas", "scripts/micro_pallas_gather.py:59", g.take_flat,
             [(t, i) for i in idx], "taps", n_samp, 12 * n_samp),
        Case("f_pallas2", "scripts/micro_pallas_gather.py:104", g.take_flat,
             [(t, i) for i in idx2], "taps", n_samp, 12 * n_samp),
        Case("case_a", "scripts/micro_mosaic_gather.py:62", g.take_along_rows,
             [(tab, r) for r in ridx], "taps", el, 12 * el),
        Case("case_b", "scripts/micro_mosaic_gather.py:77", g.take_along_lanes,
             [(src, l) for l in lidx], "taps", el, 12 * el),
        Case("case_c", "scripts/micro_mosaic_gather.py:91", g.take_along_both,
             [(tab, r, l) for r, l in zip(ridx, lidx)], "taps", el, 16 * el),
        Case("case_d", "scripts/micro_mosaic_gather.py:107", g.take_flat,
             [(tab.reshape(-1), r * LANES + l) for r, l in zip(ridx, lidx)],
             "taps", el, 12 * el),
        Case("case_e", "scripts/micro_mosaic_gather.py:122", g.take_rows,
             [(tab, r) for r in rvec], "rows", MOSAIC_B, MOSAIC_B * (4 + 2 * row_b)),
        Case("fH", "scripts/micro_rowgather.py:97", g.take_rows,
             [(tab_h, z) for z in zy], "rows", s_pad, s_pad * (4 + 2 * row_b)),
    ]


PLAIN = {g.take_flat: g.take_flat_plain, g.take_along_rows: g.take_along_rows_plain,
         g.take_along_lanes: g.take_along_lanes_plain,
         g.take_along_both: g.take_along_both_plain, g.take_rows: g.take_rows_plain}
KERNEL_ID = {g.take_flat: "G1", g.take_along_rows: "G2", g.take_along_lanes: "G3",
             g.take_along_both: "G4", g.take_rows: "G5"}


def timed(fn, args: list, reps: int) -> float:
    """Mean ms per call by CUDA events, cycling the index sets, after a
    warm-up call on each."""
    for a in args:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for k in range(reps):
        fn(*args[k % len(args)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _rate(case: Case, ms: float) -> tuple:
    return case.count / ms / 1e6, case.bytes / ms / 1e6      # G/s, GB/s


def reference_lines(dev, cases: list, reps: int) -> list:
    """The scripts' XLA reference lines as plain PyTorch: (a) flat take
    (micro_pallas_gather.py), F row take, G 4 corner rows + 2-hot lane
    dot, I 8-tap flat take (micro_rowgather.py)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    case1, case_h = cases[0], cases[-1]
    tab = case_h.args[0][0]
    zys = [z[:ROW_S] for _, z in case_h.args]
    xfs = [torch.rand(ROW_S, generator=gen, device=dev) * 58.0 for _ in zys]
    lane = torch.arange(LANES, device=dev)
    flat = tab.reshape(-1)
    n_zy = tab.shape[0]

    def trilin(zy, xf, ch=1 << 17):
        outs = []
        for lo in range(0, zy.numel(), ch):
            z, x = zy[lo:lo + ch].long(), xf[lo:lo + ch]
            ix = torch.floor(x).long()
            wx = (x - ix)[:, None]
            two_hot = ((lane == ix[:, None]) * (1 - wx)
                       + (lane == ix[:, None] + 1) * wx)
            acc = 0.0
            for d in (0, 1, ROW_Y, ROW_Y + 1):
                rows = torch.index_select(tab, 0, torch.clamp(z + d, 0, n_zy - 1))
                acc = acc + torch.sum(rows * two_hot, dim=-1)
            outs.append(acc)
        return torch.cat(outs)

    def f8(zy, xf):
        lin = zy.long() * LANES + torch.floor(xf).long()
        out = 0.0
        for d in (0, 1, LANES, LANES + 1, ROW_Y * LANES, ROW_Y * LANES + 1,
                  (ROW_Y + 1) * LANES, (ROW_Y + 1) * LANES + 1):
            out = out + torch.take(flat, torch.clamp(lin + d, 0, flat.numel() - 1))
        return out

    n1 = case1.count
    lines = [
        ("a) flat take", lambda t, i: torch.take(t, i.long()), case1.args,
         n1, 12 * n1, "taps"),
        ("F row take", lambda z, x: torch.index_select(tab, 0, z), list(zip(zys, xfs)),
         ROW_S, ROW_S * LANES * 4, "rows"),
        ("G 4 rows + 2-hot dot", trilin, list(zip(zys, xfs)), 4 * ROW_S,
         4 * ROW_S * LANES * 4, "taps"),
        ("I 8-tap flat take", f8, list(zip(zys, xfs)), 8 * ROW_S,
         8 * ROW_S * 12, "taps"),
    ]
    out = []
    for name, fn, args, count, nbytes, unit in lines:
        ms = timed(fn, args, reps)
        out.append(dict(name=name, ms=ms, rate=count / ms / 1e6,
                        gbps=nbytes / ms / 1e6, unit=unit))
    return out


def run(dev, table_mb: float = 4.0, n_samples_m: float = 2.0, reps: int = 20,
        say=print, alone_under_ms: float = 0.05) -> tuple:
    """Each case's kernel against its plain version (exact), both timed;
    a case under ``alone_under_ms`` also by a CUDA-graph replay of its
    launches (``alone_ms``: the kernel apart from the host's call rate).
    Returns (case records, reference-line records)."""
    if dev.type != "cuda":
        raise RuntimeError("the gather microbenchmark measures the card: "
                           "it needs a CUDA device")
    cases = build_cases(dev, table_mb, n_samples_m)
    recs = []
    for c in cases:
        plain = PLAIN[c.kernel]
        got, ref = c.kernel(*c.args[0]), plain(*c.args[0])
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        # each input read once, the output written once
        io_bytes = sum(t.numel() * t.element_size() for t in (*c.args[0], got))
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise RuntimeError(f"{c.name}: kernel and plain gather differ "
                               f"(max abs err {err})")
        del got, ref
        ms = timed(c.kernel, c.args, reps)
        plain_ms = timed(plain, c.args, max(2, reps // 4))
        alone_ms = graph_ms(c.kernel, args=c.args) if ms < alone_under_ms else None
        rate, gbps = _rate(c, ms)
        p_rate, p_gbps = _rate(c, plain_ms)
        unit = "Gtaps/s" if c.unit == "taps" else "Grows/s"
        say(f"{c.name:10s} {KERNEL_ID[c.kernel]} {c.kernel.__name__:17s} "
            f"kernel {ms:9.4f} ms {rate:8.3f} {unit} {gbps:8.1f} GB/s | "
            f"plain {plain_ms:9.4f} ms {p_rate:8.3f} {unit} {p_gbps:8.1f} GB/s"
            + ("" if alone_ms is None else f" | kernel alone {alone_ms:.4f} ms"))
        recs.append(dict(case=c.name, replaces=c.replaces,
                         kernel=KERNEL_ID[c.kernel], fn=c.kernel.__name__,
                         unit=c.unit, count=c.count, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, rate=rate, gbps=gbps,
                         io_bytes=io_bytes, alone_ms=alone_ms))
    refs = reference_lines(dev, cases, max(2, reps // 4))
    for r in refs:
        unit = "Gtaps/s" if r["unit"] == "taps" else "Grows/s"
        say(f"ref {r['name']:22s} {r['ms']:9.4f} ms {r['rate']:8.3f} {unit} "
            f"{r['gbps']:8.1f} GB/s")
    return recs, refs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="micro.gather")
    p.add_argument("table_mb", nargs="?", type=float, default=4.0)
    p.add_argument("n_samples_m", nargs="?", type=float, default=2.0)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("micro.gather: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(f"device {torch.cuda.get_device_name(0)}")
    run(dev, a.table_mb, a.n_samples_m)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
