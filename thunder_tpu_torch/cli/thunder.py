"""Main E-M CLI of the port — the counterpart of
thunder_tpu.cli.thunder:

    python -m thunder_tpu_torch.cli.thunder config.json [--device cuda]
    python -m thunder_tpu_torch.cli.thunder config.json --coordinator H:P \
        --num-processes N --process-id i [--device cpu]

Reads the reference-compatible JSON config, the .thu metadata and the
particle stacks, runs the E-M loop, and writes the
reference's per-round artifacts (FSC_Round_xxx.txt,
Class_Info_Round_xxx.txt with each class's occupancy and resolution,
Meta_Round_xxx.thu, and the references: Reference_xxx_{A,B}_Round_xxx.mrc
in 3D, the stack of K class averages Reference_Round_xxx.mrcs in 2D)
and the final maps (Reference_Final.mrcs in 2D); in 3D with "Subtract
Masked Region Reference From Images" and a provided mask, the
signal-subtracted images Subtract.mrcs and their .thu, Subtract.thu.
Particles are read by io/loader.py (MRC stacks with the numpy reader,
8-bit BMP files), so no native library is needed.

Ranks (thunder_tpu's mesh on torch.distributed, parallel/): with
``--num-processes N`` this process is rank ``--process-id`` of N joined
at ``tcp://--coordinator``, on ``cuda:(i % cards)`` or the CPU with
``--device cpu``; the ranks form the (hemi, data) layout of
parallel/mesh.py and each reads only its own images.  With several
cards visible and none of these flags the CLI starts one rank a card
itself (``--no-mesh``: one process).  Every rank logs; rank 0 alone
writes files.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

log = logging.getLogger("thunder")


def save_round_artifacts(opt, thu, out_dir: str, i_round: int) -> None:
    """A round's files.  Every rank calls it (what it writes is gathered
    from the ranks first); rank 0 writes."""
    from thunder_tpu_torch.io.mrc import write_mrc
    from thunder_tpu_torch.io.thu import write_thu
    from thunder_tpu_torch.physics import spectrum

    cfg = opt.cfg
    cls = opt.class_assignments()
    meta = (opt.export_thu(thu) if cfg.save_thu_each_iter and thu is not None
            else None)
    refs = None
    if cfg.save_refs_each_iter:
        refs = opt.class_averages() if cfg.mode_2d else opt.refs_both(report=True)
    if opt.layout.rank != 0:
        return
    fsc = opt.model.fsc
    band = int(opt._fsc_band)
    with open(os.path.join(out_dir, f"FSC_Round_{i_round:03d}.txt"), "w") as f:
        for i in range(1, min(fsc.shape[1], band)):
            res_a = cfg.size * cfg.pixel_size / i
            f.write(f"{i:05d} {res_a:10.6f} "
                    + " ".join(f"{fsc[t, i]:10.6f}" for t in range(cfg.k))
                    + "\n")
    with open(os.path.join(out_dir, f"Class_Info_Round_{i_round:03d}.txt"), "w") as f:
        for t in range(cfg.k):
            occ = float((cls == t).mean()) if len(cls) else 0.0
            res_shell = spectrum.res_p(fsc[t], cfg.thres_report_fsc, 1, 1)
            res_a = (cfg.size * cfg.pixel_size / res_shell
                     if res_shell > 0 else float("inf"))
            f.write(f"{t:6d} {occ:10.6f} {res_a:10.6f}\n")
    if meta is not None:
        write_thu(os.path.join(out_dir, f"Meta_Round_{i_round:03d}.thu"), meta)
    if cfg.save_refs_each_iter and cfg.mode_2d:
        write_mrc(os.path.join(out_dir, f"Reference_Round_{i_round:03d}.mrcs"),
                  refs, cfg.pixel_size, is_stack=True)
    elif cfg.save_refs_each_iter:
        for t in range(cfg.k):
            for h, tag in ((0, "A"), (1, "B")):
                write_mrc(os.path.join(
                    out_dir, f"Reference_{t:03d}_{tag}_Round_{i_round:03d}.mrc"),
                    refs[h, t], cfg.pixel_size)


def build_optimiser(cfg, device, layout=None):
    """(Optimiser, ThuTable) for a config as the CLI runs it: the .thu
    shuffled by the seed (Database::shuffle decorrelates the hemisphere
    split from acquisition order), the start model, the particles: all
    of them on one process, only the rank's own rows under ``layout``
    (the reference's per-rank chunks, Database.cpp:207-254)."""
    from thunder_tpu_torch.io.loader import load_images
    from thunder_tpu_torch.io.mrc import read_mrc
    from thunder_tpu_torch.io.thu import read_thu
    from thunder_tpu_torch.optimiser import Optimiser

    log.info("reading %s", cfg.db)
    thu = read_thu(cfg.db)
    thu = thu.select(np.random.default_rng(cfg.seed).permutation(len(thu)))
    ctf = (thu.voltage, thu.defocus_u, thu.defocus_v, thu.defocus_theta,
           thu.cs, thu.amplitude_contrast, thu.phase_shift)
    init_refs = read_mrc(cfg.init_model)[0] if cfg.init_model else None
    resume = thu if not cfg.g_search else None
    if layout is None:
        log.info("loading %d particles", len(thu))
        opt = Optimiser(cfg, load_images(thu, cfg.par_prefix), ctf, thu.group_id - 1,
                        init_refs=init_refs, resume_thu=resume, device=device)
    else:
        log.info("%s", layout.describe())
        opt = Optimiser(cfg, None, ctf, thu.group_id - 1, init_refs=init_refs,
                        resume_thu=resume, device=device, layout=layout,
                        image_loader=lambda ids: load_images(thu, cfg.par_prefix, indices=ids))
        log.info("rank %d loaded %d of %d particles", layout.rank, opt.n_local_loaded,
                 len(thu))
    return opt, thu


def free_port() -> int:
    """A TCP port free on this host now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv: list, n: int, timeout_s: float | None = None) -> int:
    """Run this CLI as ``n`` ranks on this host (``--coordinator`` a free
    local port); the first rank that fails stops the others.  Returns 0
    or the failing rank's exit code (124 on the timeout)."""
    import subprocess
    import time

    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "thunder_tpu_torch.cli.thunder", *argv,
                               "--coordinator", f"127.0.0.1:{port}",
                               "--num-processes", str(n), "--process-id", str(i)])
             for i in range(n)]
    t0, rc = time.time(), 0
    while rc == 0 and any(q.poll() is None for q in procs):
        rc = next((q.returncode for q in procs if q.returncode not in (None, 0)), 0)
        if timeout_s is not None and time.time() - t0 > timeout_s:
            rc = 124
        time.sleep(0.2)
    for q in procs:
        if q.poll() is None:
            q.kill()
        q.wait()
    return rc or next((q.returncode for q in procs if q.returncode), 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thunder")
    p.add_argument("config", help="JSON config (reference-compatible)")
    p.add_argument("--max-rounds", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda': the first CUDA device, or rank i's "
                        "cuda:(i %% cards); 'cpu' runs on the CPU, as a machine without a "
                        "card must)")
    p.add_argument("--no-mesh", action="store_true",
                   help="one process even when several cards are visible")
    p.add_argument("--coordinator", default=None,
                   help="host:port where the ranks' process group meets")
    p.add_argument("--num-processes", type=int, default=None, help="number of ranks")
    p.add_argument("--process-id", type=int, default=None, help="this process's rank")
    argv = sys.argv[1:] if argv is None else list(argv)
    a = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s " + (f"rank{a.process_id} " if a.num_processes else "")
        + "%(name)s %(levelname)s %(message)s")

    import torch

    if (a.num_processes is None and not a.no_mesh and a.device.startswith("cuda")
            and torch.cuda.device_count() > 1):
        # one rank a visible card, as thunder_tpu meshes every local device
        return spawn_ranks(argv, torch.cuda.device_count())

    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.device import as_device
    from thunder_tpu_torch.io.mrc import write_mrc
    from thunder_tpu_torch.io.thu import write_thu
    from thunder_tpu_torch.model import SEARCH_TYPE_STOP
    from thunder_tpu_torch.parallel import comm
    from thunder_tpu_torch.parallel.distributed import default_mesh, init_multihost
    from thunder_tpu_torch.utils.logging import RoundMetrics

    world = init_multihost(a.coordinator, a.num_processes, a.process_id, a.device)
    layout = default_mesh(device=a.device) if world > 1 else None
    # no card and no --device cpu: raise now
    device = layout.device if layout is not None else as_device(a.device)
    lead = layout is None or layout.rank == 0
    cfg = ThunderConfig.from_json(a.config)
    if cfg.par_gra and cfg.k != 1:
        # the reference warns and ignores grading outside refinement
        # (Optimiser.cpp:6726-6734)
        log.warning("particle grading is only recommended in refinement,"
                    " not classification; ignored with k=%d", cfg.k)
    out_dir = cfg.dst_prefix or "./"
    if lead:
        os.makedirs(out_dir, exist_ok=True)
    opt, thu = build_optimiser(cfg, device, layout)
    log.info("device %s", opt.device)

    metrics = RoundMetrics(os.path.join(out_dir, "round_metrics.jsonl")) if lead else None
    n_rounds = a.max_rounds if a.max_rounds is not None else cfg.iter_max
    for i in range(n_rounds):
        rec = opt.run_round(i)
        log.info("round %d: r=%d searchType=%d->%d phases=%s res=%.2fA (%.1fs)",
                 i, rec["r"], rec["search_type"], rec["search_type_after"],
                 rec["n_phases"], rec["res_A"], rec["elapsed_s"])
        if lead:
            metrics.write(rec)
        save_round_artifacts(opt, thu, out_dir, i)
        if opt.model.search_type == SEARCH_TYPE_STOP:
            log.info("search finished at round %d", i)
            break

    log.info("final full-resolution reconstruction")
    final = opt.final_reconstruction()
    refs = opt.refs_both()
    subtracted = sub_thu = None
    if cfg.subtract and not cfg.mode_2d and opt._ref_mask is not None:
        log.info("signal subtraction")
        subtracted, sub_thu = opt.save_subtract(opt._ref_mask), opt.export_thu(thu)
    if layout is not None:
        log.info("rank %d collectives %s", layout.rank, comm.STATS)
        import torch.distributed as dist

        dist.destroy_process_group()
    if not lead:
        return 0
    if cfg.mode_2d:
        write_mrc(os.path.join(out_dir, "Reference_Final.mrcs"), final,
                  cfg.pixel_size, is_stack=True)
    else:
        for t in range(cfg.k):
            write_mrc(os.path.join(out_dir, f"Reference_{t:03d}_Final.mrc"),
                      final[t], cfg.pixel_size)
            for h, tag in ((0, "A"), (1, "B")):
                write_mrc(os.path.join(out_dir, f"Reference_{t:03d}_{tag}_Final.mrc"),
                          refs[h, t], cfg.pixel_size)
    if cfg.subtract and not cfg.mode_2d:
        if subtracted is None:
            log.warning("subtraction requested but no mask provided; skipped")
        else:
            stack_path = os.path.join(out_dir, "Subtract.mrcs")
            write_mrc(stack_path, subtracted, cfg.pixel_size, is_stack=True)
            sub_thu.particle_path = [f"{i + 1}@{stack_path}" for i in range(len(sub_thu))]
            write_thu(os.path.join(out_dir, "Subtract.thu"), sub_thu)
    log.info("final resolution: %.2f A",
             opt.model.res_angstrom(cfg.thres_report_fsc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
