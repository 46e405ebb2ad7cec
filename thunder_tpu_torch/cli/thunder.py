"""Main E-M CLI of the port — the counterpart of
thunder_tpu.cli.thunder:

    python -m thunder_tpu_torch.cli.thunder config.json [--device cuda]

Reads the reference-compatible JSON config, the .thu metadata and the
particle stacks, runs the E-M loop on one device, and writes the
reference's per-round artifacts (FSC_Round_xxx.txt,
Class_Info_Round_xxx.txt with each class's occupancy and resolution,
Meta_Round_xxx.thu, and the references: Reference_xxx_{A,B}_Round_xxx.mrc
in 3D, the stack of K class averages Reference_Round_xxx.mrcs in 2D)
and the final maps (Reference_Final.mrcs in 2D); in 3D with "Subtract
Masked Region Reference From Images" and a provided mask, the
signal-subtracted images Subtract.mrcs and their .thu, Subtract.thu.
Particles are read by io/loader.py (MRC stacks with the numpy reader,
8-bit BMP files), so no native library is needed.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

log = logging.getLogger("thunder")


def save_round_artifacts(opt, thu, out_dir: str, i_round: int) -> None:
    from thunder_tpu_torch.io.mrc import write_mrc
    from thunder_tpu_torch.io.thu import write_thu
    from thunder_tpu_torch.physics import spectrum

    cfg = opt.cfg
    fsc = opt.model.fsc
    band = int(opt._fsc_band)
    with open(os.path.join(out_dir, f"FSC_Round_{i_round:03d}.txt"), "w") as f:
        for i in range(1, min(fsc.shape[1], band)):
            res_a = cfg.size * cfg.pixel_size / i
            f.write(f"{i:05d} {res_a:10.6f} "
                    + " ".join(f"{fsc[t, i]:10.6f}" for t in range(cfg.k))
                    + "\n")
    cls = opt.class_assignments()
    with open(os.path.join(out_dir, f"Class_Info_Round_{i_round:03d}.txt"), "w") as f:
        for t in range(cfg.k):
            occ = float((cls == t).mean()) if len(cls) else 0.0
            res_shell = spectrum.res_p(fsc[t], cfg.thres_report_fsc, 1, 1)
            res_a = (cfg.size * cfg.pixel_size / res_shell
                     if res_shell > 0 else float("inf"))
            f.write(f"{t:6d} {occ:10.6f} {res_a:10.6f}\n")
    if cfg.save_thu_each_iter and thu is not None:
        write_thu(os.path.join(out_dir, f"Meta_Round_{i_round:03d}.thu"),
                  opt.export_thu(thu))
    if cfg.save_refs_each_iter and cfg.mode_2d:
        write_mrc(os.path.join(out_dir, f"Reference_Round_{i_round:03d}.mrcs"),
                  opt.class_averages(), cfg.pixel_size, is_stack=True)
    elif cfg.save_refs_each_iter:
        refs = opt._refs_report if opt._refs_report is not None else opt.state.refs
        refs = refs.cpu().numpy()
        for t in range(cfg.k):
            for h, tag in ((0, "A"), (1, "B")):
                write_mrc(os.path.join(
                    out_dir, f"Reference_{t:03d}_{tag}_Round_{i_round:03d}.mrc"),
                    refs[h, t], cfg.pixel_size)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="thunder")
    p.add_argument("config", help="JSON config (reference-compatible)")
    p.add_argument("--max-rounds", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default 'cuda': the first CUDA device; "
                        "'cpu' runs on the CPU, as a machine without a card must)")
    a = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.device import as_device
    from thunder_tpu_torch.io.loader import load_images
    from thunder_tpu_torch.io.mrc import read_mrc, write_mrc
    from thunder_tpu_torch.io.thu import read_thu, write_thu
    from thunder_tpu_torch.model import SEARCH_TYPE_STOP
    from thunder_tpu_torch.optimiser import Optimiser
    from thunder_tpu_torch.utils.logging import RoundMetrics

    device = as_device(a.device)        # no card and no --device cpu: raise now
    cfg = ThunderConfig.from_json(a.config)
    if cfg.par_gra and cfg.k != 1:
        # the reference warns and ignores grading outside refinement
        # (Optimiser.cpp:6726-6734)
        log.warning("particle grading is only recommended in refinement,"
                    " not classification; ignored with k=%d", cfg.k)
    out_dir = cfg.dst_prefix or "./"
    os.makedirs(out_dir, exist_ok=True)
    log.info("reading %s", cfg.db)
    thu = read_thu(cfg.db)
    # Database::shuffle: a seeded permutation decorrelates the hemisphere
    # split from acquisition order
    thu = thu.select(np.random.default_rng(cfg.seed).permutation(len(thu)))
    ctf = (thu.voltage, thu.defocus_u, thu.defocus_v, thu.defocus_theta,
           thu.cs, thu.amplitude_contrast, thu.phase_shift)
    init_refs = read_mrc(cfg.init_model)[0] if cfg.init_model else None
    log.info("loading %d particles", len(thu))
    images = load_images(thu, cfg.par_prefix)
    opt = Optimiser(cfg, images, ctf, thu.group_id - 1, init_refs=init_refs,
                    resume_thu=thu if not cfg.g_search else None,
                    device=device)
    log.info("device %s", opt.device)

    metrics = RoundMetrics(os.path.join(out_dir, "round_metrics.jsonl"))
    n_rounds = a.max_rounds if a.max_rounds is not None else cfg.iter_max
    for i in range(n_rounds):
        rec = opt.run_round(i)
        log.info("round %d: r=%d searchType=%d->%d phases=%s res=%.2fA (%.1fs)",
                 i, rec["r"], rec["search_type"], rec["search_type_after"],
                 rec["n_phases"], rec["res_A"], rec["elapsed_s"])
        metrics.write(rec)
        save_round_artifacts(opt, thu, out_dir, i)
        if opt.model.search_type == SEARCH_TYPE_STOP:
            log.info("search finished at round %d", i)
            break

    log.info("final full-resolution reconstruction")
    final = opt.final_reconstruction()
    refs = opt.state.refs.cpu().numpy()
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
        log.info("signal subtraction")
        if opt._ref_mask is None:
            log.warning("subtraction requested but no mask provided; skipped")
        else:
            stack_path = os.path.join(out_dir, "Subtract.mrcs")
            write_mrc(stack_path, opt.save_subtract(opt._ref_mask), cfg.pixel_size,
                      is_stack=True)
            sub_thu = opt.export_thu(thu)
            sub_thu.particle_path = [f"{i + 1}@{stack_path}" for i in range(len(sub_thu))]
            write_thu(os.path.join(out_dir, "Subtract.thu"), sub_thu)
    log.info("final resolution: %.2f A",
             opt.model.res_angstrom(cfg.thres_report_fsc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
