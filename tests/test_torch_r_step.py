"""The first step of r at configs/demo.json's shipped r_init (60 A: r = 5),
in both packages on the same 160 px images: chip_smoke.py's phase 5a
dataset (256 images of the sharp C4 phantom at SNR 1.5, defocus 1.03 times
the .thu's, a 40 A start model) with every value of the config as shipped.

Model.update_r raises r after two rounds running in which neither median
of the translation spread shrank by 2 %.  At r = 5 both packages' medians
settle at 0.10-0.15 px, just above the 0.1 px floor, and jitter by a tenth
from round to round (every global search draws a new random grid), so the
round of the first step is a matter of chance in thunder_tpu as in the
port; from r = 12 on both sit on the floor and r steps every third round.

    JAX_PLATFORMS=cpu python tests/test_torch_r_step.py [--seed 1] [--rounds 16]
        [--packages jax port]

prints, for each package and round: r, the search type, the phases, res_A
and the two medians (about 25 s a round and package on eight CPU cores).
The test holds the medians' level; it is marked slow (both packages run
eight rounds at 160 px)."""

import argparse
import os
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROUNDS, SETTLED = 8, 3      # the medians are compared from round SETTLED on


def make_data(tmp: str, rounds: int) -> str:
    """chip_smoke.py's phase 5a dataset and config (r_init as shipped),
    made on the CPU under ``tmp``; returns the config's path."""
    import chip_smoke

    chip_smoke.N_REFINE = 256
    cfg_path, _ = chip_smoke.demo_160(tmp, "cpu", "demo.json", 1, rounds,
                                      chip_smoke.INIT_MODEL_RES_A,
                                      defocus_factor=chip_smoke.DEFOCUS_FACTOR,
                                      snr=chip_smoke.SNR_A)
    return cfg_path


def run_rounds(package: str, cfg_path: str, rounds: int, seed: int):
    """``rounds`` rounds of ``package`` ("jax" or "port") on the CPU, as
    its CLI sets them up; yields (round, r, search type, phases, res_A,
    (median s0, median s1)) and stops once r has left r_init."""
    if package == "jax":
        from thunder_tpu.config import ThunderConfig
        from thunder_tpu.io.loader import load_images
        from thunder_tpu.io.mrc import read_mrc
        from thunder_tpu.io.thu import read_thu
        from thunder_tpu.optimiser import Optimiser
        from thunder_tpu.physics.ctf import ctf_params
        kw = {}
    else:
        from thunder_tpu_torch.cli.thunder import load_images
        from thunder_tpu_torch.config import ThunderConfig
        from thunder_tpu_torch.io.mrc import read_mrc
        from thunder_tpu_torch.io.thu import read_thu
        from thunder_tpu_torch.optimiser import Optimiser
        ctf_params = lambda *cols: cols
        kw = dict(device="cpu")
    cfg = ThunderConfig.from_json(cfg_path)
    cfg.seed = seed
    thu = read_thu(cfg.db)
    thu = thu.select(np.random.default_rng(cfg.seed).permutation(len(thu)))
    ctf = ctf_params(thu.voltage, thu.defocus_u, thu.defocus_v, thu.defocus_theta, thu.cs,
                     thu.amplitude_contrast, thu.phase_shift)
    opt = Optimiser(cfg, load_images(thu, cfg.par_prefix), ctf, thu.group_id - 1,
                    init_refs=read_mrc(cfg.init_model)[0], **kw)
    for i in range(rounds):
        rec = opt.run_round(i)
        # read before update_r's reset: the port's record keeps them,
        # thunder_tpu's model holds inf once r has stepped
        spread = rec.get("t_vari") or (opt.model.t_vari_s0, opt.model.t_vari_s1)
        yield i, rec["r"], rec["search_type"], rec["n_phases"], rec["res_A"], tuple(spread)
        if rec["r"] > cfg.r_init:
            return


@pytest.mark.slow
def test_translation_spread_at_r_init_sits_at_the_same_level_in_both_packages(tmp_path):
    """From round SETTLED on, while r = r_init, both packages' medians lie
    between the 0.1 px floor and 0.3 px, and their means over those rounds
    agree within 0.03 px."""
    cfg_path = make_data(str(tmp_path), ROUNDS)
    level = {}
    for package in ("jax", "port"):
        meds = [s for i, r, _, _, _, s in run_rounds(package, cfg_path, ROUNDS, 1)
                if i >= SETTLED and np.isfinite(s).all()]
        assert len(meds) >= 2, (package, meds)
        assert all(0.1 <= v <= 0.3 for s in meds for v in s), (package, meds)
        level[package] = float(np.mean(meds))
    assert abs(level["jax"] - level["port"]) < 0.03, level


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="test_torch_r_step")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rounds", type=int, default=16)
    p.add_argument("--packages", nargs="+", default=["jax", "port"], choices=["jax", "port"])
    a = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="r_step_") as tmp:
        cfg_path = make_data(tmp, a.rounds)
        print("package seed round r search phases res_A medians", flush=True)
        for package in a.packages:
            for i, r, search, phases, res, s in run_rounds(package, cfg_path, a.rounds, a.seed):
                print(package, a.seed, i, r, search, phases, round(res, 3),
                      [round(v, 4) for v in s], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
