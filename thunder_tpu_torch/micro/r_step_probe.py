"""When does r take its first step?  configs/demo.json's refinement on the
generator's sharp C4 phantom at 160 px, printing for every round the band
r, the search type and the two medians of the translation spread that
Model.update_r's stagnation rule reads (r grows after two rounds running
in which neither median shrank by 2 %).

    python -m thunder_tpu_torch.micro.r_step_probe [--snr 1.5] [--init-res 60]
        [--n 256] [--rounds 24] [--device cuda]

At the shipped "Initial Resolution" of 60 A (r = 5) the medians wander
above their 0.1 px floor from round to round and the first step is a
matter of chance; at 20 A (r = 12) they sit on the floor from round 2 on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from thunder_tpu_torch.cli import thunder


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="r_step_probe")
    p.add_argument("--snr", type=float, default=1.5)
    p.add_argument("--init-res", type=float, default=60.0,
                   help='"Initial Resolution (Angstrom)": 60 as shipped')
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--rounds", type=int, default=24)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    # the dataset, start model and config are chip_smoke.py's phase 5a's
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import chip_smoke

    chip_smoke.N_REFINE = a.n
    with tempfile.TemporaryDirectory(prefix="r_step_probe_") as tmp:
        cfg_path, _ = chip_smoke.demo_160(
            tmp, a.device, "demo.json", 1, a.rounds, chip_smoke.INIT_MODEL_RES_A,
            defocus_factor=chip_smoke.DEFOCUS_FACTOR, snr=a.snr, init_res_a=a.init_res)
        rc = thunder.main([cfg_path, "--device", a.device])
        print(f"snr {a.snr} init_res {a.init_res} n {a.n}: round, r, search type -> after, "
              "phases, res_A, median translation spread (s0, s1), seconds")
        with open(os.path.join(tmp, "output", "round_metrics.jsonl")) as f:
            for line in f:
                r = json.loads(line)
                print(r["round"], r["r"], r["search_type"], "->", r["search_type_after"],
                      r["n_phases"], round(r["res_A"], 3), [round(v, 4) for v in r["t_vari"]],
                      round(r["elapsed_s"], 2), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
