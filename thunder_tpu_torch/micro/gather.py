"""Hopper gather microbenchmark: the eight ``pl.pallas_call`` gathers of
the repo's TPU microbenchmarks (scripts/micro_pallas_gather.py,
micro_mosaic_gather.py, micro_rowgather.py) as kernels G1-G5
(ops/gather.py), each against its plain PyTorch version, at the
scripts' default shapes and G2-G4 also at a scaled batch of SCALED_B
rows, plus the scripts' XLA reference lines as plain PyTorch — one run
gives the whole shoot-out on the card.

    python -m thunder_tpu_torch.micro.gather [table_mb] [n_samples_m]

``table_mb`` (MiB, default 4) and ``n_samples_m`` (x 2^20, default 2)
size the flat-table cases of micro_pallas_gather.py; the other cases
keep their scripts' fixed shapes.  Needs a CUDA device.  Indices vary
from call to call (a few index sets, cycled), as in the scripts.
Each case's kernel must give its plain version's bits, twice.  Times:
CUDA events over repeated calls (``ms``), and each case's launches
replayed as a CUDA graph (``alone_ms``: at the scripts' shapes the
events' time is the host's call rate), and so is the one library call
(``library_alone_ms``: ``torch.take``, ``torch.gather`` — two for G4 —
or ``index_select``, on int64 copies of the indices made beforehand).
GB/s counts the index bytes read, the table bytes gathered and the
output bytes written; ``bound_ms`` each input read once and the output
written once at 3.35 TB/s.  :func:`check_edges` holds the kernels to
their plain versions on the cases that break a vectorised gather.
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
SCALED_B = 1 << 17                          # G2-G4 where staging pays: 64 MiB an index array
HBM_BYTES_S = 3.35e12                       # H100 SXM, NVIDIA's data sheet


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
                seed: int = 0, scaled_b: int = SCALED_B) -> list:
    """The eight cases with N_VARY index sets each, then G2-G4 at
    ``scaled_b`` rows (case_a_scaled, case_b_scaled, case_c_scaled),
    made on ``dev``."""
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
    src_s = randn(scaled_b, LANES)
    ridx_s = [_ri(gen, 0, MOSAIC_ROWS, (scaled_b, LANES), dev) for _ in range(N_VARY)]
    lidx_s = [_ri(gen, 0, LANES, (scaled_b, LANES), dev) for _ in range(N_VARY)]
    el_s = scaled_b * LANES
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
        Case("case_a_scaled", "scripts/micro_mosaic_gather.py:62", g.take_along_rows,
             [(tab, r) for r in ridx_s], "taps", el_s, 12 * el_s),
        Case("case_b_scaled", "scripts/micro_mosaic_gather.py:77", g.take_along_lanes,
             [(src_s, l) for l in lidx_s], "taps", el_s, 12 * el_s),
        Case("case_c_scaled", "scripts/micro_mosaic_gather.py:91", g.take_along_both,
             [(tab, r, l) for r, l in zip(ridx_s, lidx_s)], "taps", el_s, 16 * el_s),
    ]


PLAIN = {g.take_flat: g.take_flat_plain, g.take_along_rows: g.take_along_rows_plain,
         g.take_along_lanes: g.take_along_lanes_plain,
         g.take_along_both: g.take_along_both_plain, g.take_rows: g.take_rows_plain}
KERNEL_ID = {g.take_flat: "G1", g.take_along_rows: "G2", g.take_along_lanes: "G3",
             g.take_along_both: "G4", g.take_rows: "G5"}
# the one library call of each (two for G4), on int64 indices in range
LIBRARY = {g.take_flat: torch.take,
           g.take_along_rows: lambda tab, r: torch.gather(tab, 0, r),
           g.take_along_lanes: lambda src, l: torch.gather(src, 1, l),
           g.take_along_both: lambda tab, r, l: torch.gather(torch.gather(tab, 0, r), 1, l),
           g.take_rows: lambda tab, r: torch.index_select(tab, 0, r)}


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
    case1, case_h = cases[0], next(c for c in cases if c.name == "fH")
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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def run(dev, table_mb: float = 4.0, n_samples_m: float = 2.0, reps: int = 20,
        say=print) -> tuple:
    """Each case's kernel against its plain version (the same bits, in two
    calls), timed by CUDA events and alone (a replayed CUDA graph of its
    launches), beside its library call alone and its bound.  Returns
    (case records, reference-line records)."""
    if dev.type != "cuda":
        raise RuntimeError("the gather microbenchmark measures the card: "
                           "it needs a CUDA device")
    cases = build_cases(dev, table_mb, n_samples_m)
    recs = []
    for c in cases:
        plain = PLAIN[c.kernel]
        got, again, ref = c.kernel(*c.args[0]), c.kernel(*c.args[0]), plain(*c.args[0])
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        # each input read once, the output written once
        io_bytes = sum(t.numel() * t.element_size() for t in (*c.args[0], got))
        if not same_bits(got, ref):
            raise RuntimeError(f"{c.name}: kernel and plain gather differ "
                               f"(max abs err {err})")
        if not same_bits(got, again):
            raise RuntimeError(f"{c.name}: two calls of the kernel differ")
        del got, again, ref
        ms = timed(c.kernel, c.args, reps)
        plain_ms = timed(plain, c.args, max(2, reps // 4))
        alone_ms = graph_ms(c.kernel, args=c.args)
        wide = [tuple(x.long() if x.dtype == torch.int32 else x for x in a) for a in c.args]
        library_alone_ms = graph_ms(LIBRARY[c.kernel], args=wide)
        del wide
        bound_ms = io_bytes / HBM_BYTES_S * 1e3
        rate, gbps = _rate(c, ms)
        p_rate, p_gbps = _rate(c, plain_ms)
        unit = "Gtaps/s" if c.unit == "taps" else "Grows/s"
        say(f"{c.name:13s} {KERNEL_ID[c.kernel]} {c.kernel.__name__:17s} "
            f"kernel_ms {ms:.4f} ({rate:.3f} {unit}, {gbps:.1f} GB/s)  "
            f"kernel_alone_ms {alone_ms:.4f}  plain_ms {plain_ms:.4f} ({p_gbps:.1f} GB/s)  "
            f"library_alone_ms {library_alone_ms:.4f}  bound_ms {bound_ms:.4f}  "
            f"share {bound_ms / alone_ms:.3f} alone, {bound_ms / ms:.3f} by events")
        recs.append(dict(case=c.name, replaces=c.replaces,
                         kernel=KERNEL_ID[c.kernel], fn=c.kernel.__name__,
                         unit=c.unit, count=c.count, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, rate=rate, gbps=gbps, p_rate=p_rate,
                         io_bytes=io_bytes, alone_ms=alone_ms,
                         library_alone_ms=library_alone_ms, bound_ms=bound_ms,
                         share=bound_ms / alone_ms, share_events=bound_ms / ms))
    refs = reference_lines(dev, cases, max(2, reps // 4))
    for r in refs:
        unit = "Gtaps/s" if r["unit"] == "taps" else "Grows/s"
        say(f"ref {r['name']:22s} {r['ms']:9.4f} ms {r['rate']:8.3f} {unit} "
            f"{r['gbps']:8.1f} GB/s")
    return recs, refs


def edge_cases(dev, seed: int = 3) -> list:
    """The cases that break a vectorised gather, as (label, kernel, args,
    keyword args): G1 on 2^21 + 3 taps (a tail), an index view and an
    output at offsets that are not 16-byte aligned (alike and not), and
    indices out of range at both ends; G2-G4 with indices out of range at
    the scripts' shape (G2 strip16, G3 and G4 row), index views and outputs
    4 bytes off (scalar), G4's lane indices all 0, all 127 and both (row,
    and scalar through an output 4 bytes off), widths of 126 and 256 and
    909 table rows (outside the row and strip forms), and G2 on both sides
    of each STRIP_MIN_OUTPUTS (scalar, strip16, strip64) and of
    STRIP_MAX_ROWS."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    n_t, n = 1 << 20, (1 << 21) + 3
    t = randn(n_t)
    idx = _ri(gen, -1000, n_t + 1000, (n + 8,), dev)
    buf = torch.empty(n + 8, device=dev)
    cases = [("G1 2^21 + 3 taps, out of range", g.take_flat, (t, idx[:n]), {}),
             ("G1 index view +4 B", g.take_flat, (t, idx[1:n + 1]), {}),
             ("G1 index view and output +4 B", g.take_flat, (t, idx[1:n + 1]),
              {"out": buf[1:n + 1]}),
             ("G1 output +8 B", g.take_flat, (t, idx[:n]), {"out": buf[2:n + 2]}),
             ("G1 7 taps, index view +12 B", g.take_flat, (t, idx[3:10]), {})]

    def along(rows: int, width: int, b: int, lo: int = 40):
        tab = randn(rows, width)
        flat = lambda hi: _ri(gen, -lo, hi + lo, (b * width + 4,), dev)
        r, l = flat(rows), flat(width)
        return tab, randn(b, width), r, l

    mode_fn = ((0, g.take_along_rows), (1, g.take_along_lanes), (2, g.take_along_both))

    def args_of(mode, tab, src, r, l, b, width, off=0):
        r2, l2 = (x[off:off + b * width].view(b, width) for x in (r, l))
        return ((tab, r2), (src, l2), (tab, r2, l2))[mode]

    def off_out(b, width):
        return torch.empty(b * width + 4, device=dev)[1:1 + b * width].view(b, width)

    tab, src, r, l = along(MOSAIC_ROWS, LANES, MOSAIC_B)
    for mode, fn in mode_fn:
        a = args_of(mode, tab, src, r, l, MOSAIC_B, LANES)
        cases.append((f"G{mode + 2} scripts' shape, out of range", fn, a, {}))
        cases.append((f"G{mode + 2} index view +4 B", fn,
                       args_of(mode, tab, src, r, l, MOSAIC_B, LANES, off=1), {}))
        cases.append((f"G{mode + 2} output +4 B", fn, a, {"out": off_out(MOSAIC_B, LANES)}))
    r_in = _ri(gen, -40, MOSAIC_ROWS + 40, (MOSAIC_B, LANES), dev)
    for label, lane in (("0", torch.zeros_like(r_in)), ("127", torch.full_like(r_in, 127)),
                        ("0 and 127", (torch.arange(LANES, device=dev) % 2 * 127).expand(
                            MOSAIC_B, LANES).to(torch.int32).contiguous())):
        cases.append((f"G4 lane indices {label}", g.take_along_both, (tab, r_in, lane), {}))
        cases.append((f"G4 lane indices {label}, output +4 B", g.take_along_both,
                      (tab, r_in, lane), {"out": off_out(MOSAIC_B, LANES)}))
    for rows, width, b, what in ((64, 126, 96, "width 126"), (64, 256, 96, "width 256"),
                                 (909, 128, 64, "909 table rows")):
        tab_w, src_w, r_w, l_w = along(rows, width, b)
        for mode, fn in mode_fn:
            cases.append((f"G{mode + 2} {what}", fn, args_of(mode, tab_w, src_w, r_w, l_w, b,
                                                             width), {}))
    edges = [(MOSAIC_ROWS, -(-least // LANES) + d) for least in g.STRIP_MIN_OUTPUTS.values()
             for d in (-1, 0)]
    edges += [(g.STRIP_MAX_ROWS + d, MOSAIC_B) for d in (0, 1)]
    for rows, b in edges:
        tab_b, _, r_b, _ = along(rows, LANES, b)
        cases.append((f"G2 {b} rows of a {rows}-row table", g.take_along_rows,
                      (tab_b, r_b[:b * LANES].view(b, LANES)), {}))
    return cases


def check_edges(dev, say=print) -> list:
    """Each of :func:`edge_cases` twice through its kernel: both calls
    must give the plain version's bits.  Returns (label, form) pairs, the
    form G2-G4 launched ("" for G1, and where nothing was launched: CPU
    tensors take the plain version)."""
    seen = []
    for label, fn, args, kwargs in edge_cases(dev):
        ref = PLAIN[fn](*args)
        if fn is not g.take_flat:
            fn.last_form = None
        first = fn(*args, **kwargs).clone()
        again = fn(*args, **kwargs)
        form = getattr(fn, "last_form", None) or ""
        if not same_bits(first, ref):
            err = float((first - ref).abs().max())
            raise RuntimeError(f"{label} ({form}): kernel and plain gather differ "
                               f"(max abs err {err})")
        if not same_bits(first, again):
            raise RuntimeError(f"{label} ({form}): two calls of the kernel differ")
        say(f"{label}{' (' + form + ')' if form else ''}: the plain version's bits, twice")
        seen.append((label, form))
    return seen


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
