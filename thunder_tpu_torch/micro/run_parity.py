"""Whole runs of the port held round by round to thunder_tpu's records:
the round's third "done" criterion, each round's FSC-0.143 shell within
one of thunder_tpu's on the same data.

    python -m thunder_tpu_torch.micro.run_parity CASE [--device cpu] [--rounds N]
        [--ref tests/goldens/run_parity/CASE.json] [--out DIR]

A case writes one synthetic dataset (``.mrcs``, ``.thu``, the start
model and its JSON config) with ``pipeline/synthetic.py`` on the CPU from
its seed, so a run on the card reads the bits a CPU run reads, runs the
port's CLI (``thunder_tpu_torch.cli.thunder``) on it, and reads back each
round: the FSC-0.143 shell and ``res_A`` (``round_metrics.jsonl``), r,
the search type, the phase counts and the medians over the images of the
translation spreads s0 and s1 (the round's ``Meta_Round_NNN.thu``).  It
prints them beside a thunder_tpu record file (``--ref``; thunder_tpu's
CLI on the same files, on the CPU: ``python
tests/test_torch_run_parity.py --write CASE`` regenerates one), the
difference of the shells, and a last JSON line.  Exit code 1 when a
round's shell lies more than one from the record's.

The cases (``CASES``):

* ``a``: configs/demo.json's settings (K = 1, C4, CTF search, core FSC,
  grading, mLR 125, mLT 9, mLD 9) at 32 px on 128 images of the sharp C4
  phantom, from the phantom low-passed to shell 5 (8.4 A); the values a
  32 px box forces (mask radius and estimated translation) are the
  generator's, "Initial Resolution" gives r_init 9 (past the r step's
  chance regime, ROADMAP Q3) and r_global is the box's max_r 14 (the
  mask's bound on it at C4); mS cut to 1,024; global, local and CTF
  rounds until the state machine stops, at most ``rounds``.
* ``b``: the K = 2 classification of tests/test_torch_3d_classify.py
  (24 px, 64 images of two species, C1, mS 1,024, mLR 16, mReco 12) on
  the generator's two sharp species, six rounds from blank references.
* ``c``: case ``a`` with ``reco_kernel="mkb"`` (the MKB insertion
  option, set through the API: neither package's CLI names it), local
  and CTF rounds resumed from the generator's blurred poses and the
  low-passed phantom.

This module imports no jax; ``tests/test_torch_run_parity.py`` holds the
port to the committed records on the CPU, ``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(_HERE))
GOLDENS = os.path.join(REPO, "tests", "goldens", "run_parity")

# each case: the generator's dataset (size, images, species, phantom,
# group, seed, SNR, defocus range), the base config and what changes in
# it, the rounds of a whole run and the insertion kernel
CASES = {
    "a": dict(size=32, n=128, k=1, kind="sharp", sym="C4", seed=1, snr=6.0,
              defocus_range=(400.0, 800.0), base="demo.json", rounds=16, start_shell=5,
              reco_kernel="trilinear", local=False,
              basic={"Initial Resolution (Angstrom)": 32 * 1.32 / 8,
                     "Perform Global Search Under (Angstrom)": 32 * 1.32 / 7},
              advanced={"Number of Sampling Points for Scanning in Global Search (3D)": 1024}),
    "b": dict(size=24, n=64, k=2, kind="sharp", sym="C1", seed=2, snr=4.0,
              defocus_range=(400.0, 800.0), base=None, rounds=6,
              reco_kernel="trilinear", local=False,
              basic={"Radius of Mask on Images (Angstrom)": 10 * 1.32,
                     "Estimated Translation (Pixel)": 1.0,
                     "Initial Resolution (Angstrom)": 3.0 * 1.32,
                     "Perform Global Search Under (Angstrom)": 2.4 * 1.32,
                     "Auto-Recentre Reference": False},
              advanced={"Number of Sampling Points for Scanning in Global Search (3D)": 1024,
                        "Number of Sampling Points of Rotation in Local Search (3D)": 16,
                        "Number of Sampling Points Used in Reconstruction": 12,
                        "Ignore Signal Under (Angstrom)": 24 * 1.32},
              professional={"Translation Search Factor": 0.25}),
    "c": dict(size=32, n=128, k=1, kind="sharp", sym="C4", seed=1, snr=6.0,
              defocus_range=(400.0, 800.0), base="demo.json", rounds=8, start_shell=5,
              reco_kernel="mkb", local=True,
              basic={"Initial Resolution (Angstrom)": 32 * 1.32 / 8,
                     "Perform Global Search Under (Angstrom)": 32 * 1.32 / 7},
              advanced={"Number of Sampling Points for Scanning in Global Search (3D)": 1024}),
}


def write_case(name: str, outdir: str, rounds: int | None = None) -> str:
    """The case's dataset and config under ``outdir`` (the generator on
    the CPU, from the case's seed); returns the config's path."""
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    case = CASES[name]
    path = write_demo(outdir, n=case["n"], size=case["size"], snr=case["snr"],
                      seed=case["seed"], device="cpu", k=case["k"], kind=case["kind"],
                      sym=case["sym"], defocus_range=case["defocus_range"])
    with open(path) as f:
        gen = json.load(f)
    if case["base"] is not None:
        with open(os.path.join(REPO, "configs", case["base"])) as f:
            cfg = json.load(f)
        # what the box forces: the generator's paths, box, mask, shifts
        for key in ("Size of Image", "Pixel Size (Angstrom)", "Initial Model",
                    ".thu File Storing Paths and CTFs of Images", "Path of Particles",
                    "Path of Output", "Radius of Mask on Images (Angstrom)",
                    "Estimated Translation (Pixel)", "Number of Threads Per Process"):
            cfg["Basic"][key] = gen["Basic"][key]
    else:
        cfg = gen
        cfg["Basic"]["Number of Classes"] = case["k"]
    cfg["Basic"].update(case.get("basic", {}))
    cfg["Advanced"].update(case.get("advanced", {}))
    cfg.setdefault("Professional", {}).update(case.get("professional", {}))
    if case["local"]:
        cfg["Basic"]["Global Search"] = False
        cfg["Basic"][".thu File Storing Paths and CTFs of Images"] = os.path.join(
            outdir, "particles_local.thu")
    if case["k"] > 1:
        # classification starts from blank references
        cfg["Basic"]["Initial Model"] = ""
    elif case.get("start_shell"):
        cfg["Basic"]["Initial Model"] = start_model(outdir, case["start_shell"])
    cfg["Advanced"]["Max Number of Iteration"] = case["rounds"] if rounds is None else rounds
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return path


def start_model(outdir: str, shell: float, edge: float = 2.0) -> str:
    """The generator's phantom low-passed (a raised cosine from Fourier
    shell ``shell`` to ``shell + edge``), written as start_model.mrc
    beside it; returns its path."""
    from thunder_tpu_torch.io.mrc import read_mrc, write_mrc
    from thunder_tpu_torch.physics.mask import radial_grid

    vol, _ = read_mrc(os.path.join(outdir, "init_model.mrc"))
    r = radial_grid(vol.shape[-1], 3)
    w = 0.5 * (1 + np.cos(np.pi * np.clip((r - shell) / edge, 0, 1)))
    path = os.path.join(outdir, "start_model.mrc")
    write_mrc(path, np.real(np.fft.ifftn(np.fft.fftn(vol) * w)).astype(np.float32), 1.32)
    return path


@contextlib.contextmanager
def reco_kernel(config_cls, kernel: str):
    """``config_cls.from_json`` setting ``reco_kernel``: the option is an
    API field that no CLI names."""
    plain = config_cls.__dict__["from_json"]

    def from_json(path):
        cfg = plain.__func__(path)
        cfg.reco_kernel = kernel
        return cfg

    config_cls.from_json = staticmethod(from_json)
    try:
        yield
    finally:
        config_cls.from_json = plain


def run_port(cfg_path: str, device: str, reco: str = "trilinear") -> str:
    """The port's CLI on ``cfg_path``; returns its output directory."""
    from thunder_tpu_torch.cli.thunder import main
    from thunder_tpu_torch.config import ThunderConfig

    with reco_kernel(ThunderConfig, reco):
        rc = main([cfg_path, "--device", device, "--no-mesh"])
    if rc != 0:
        raise RuntimeError(f"the port's CLI returned {rc} on {cfg_path}")
    with open(cfg_path) as f:
        return json.load(f)["Basic"]["Path of Output"]


def read_rounds(out_dir: str) -> list:
    """Each round of a CLI run's output directory: round, r, search type
    before and after, phase counts, FSC-0.143 shell and res_A, and the
    medians of the images' translation spreads s0 and s1."""
    from thunder_tpu_torch.io.thu import read_thu

    rows = []
    with open(os.path.join(out_dir, "round_metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            meta = read_thu(os.path.join(out_dir, f"Meta_Round_{rec['round']:03d}.thu"))
            s = np.asarray(meta.std_trans, np.float64)
            rows.append(dict(round=rec["round"], r=rec["r"], search_type=rec["search_type"],
                             search_type_after=rec["search_type_after"],
                             n_phases=list(rec["n_phases"]), res_shell=rec["res_shell"],
                             res_A=rec["res_A"], spread=[float(np.median(s[:, 0])),
                                                         float(np.median(s[:, 1]))]))
    return rows


def compare(port: list, ref: list) -> tuple:
    """(lines, held rounds, failing rounds): each round beside the
    record's, the shells' difference, and the rounds that part: shells
    more than one apart, another r or search type, or a round that only
    one of the two runs has."""
    lines = [f"{'round':>5} {'r':>7} {'search':>7} {'phases':>15} {'shell':>7} "
             f"{'d':>3} {'res_A':>17} {'spread s0 / s1 (port; thunder_tpu)':>38}"]
    held, bad = [], []
    for p, q in zip(port, ref):
        d = p["res_shell"] - q["res_shell"]
        i = p["round"]
        held.append(i)
        if abs(d) > 1 or (p["r"], p["search_type"]) != (q["r"], q["search_type"]):
            bad.append(i)
        lines.append(
            f"{i:5d} {p['r']:>3}/{q['r']:<3} {p['search_type']:>3}/{q['search_type']:<3} "
            f"{str(p['n_phases']):>7}/{str(q['n_phases']):<7} "
            f"{p['res_shell']:>3}/{q['res_shell']:<3} {d:+3d} "
            f"{p['res_A']:8.3f}/{q['res_A']:<8.3f} "
            f"{p['spread'][0]:.3f} {p['spread'][1]:.3f}; {q['spread'][0]:.3f} "
            f"{q['spread'][1]:.3f}")
    only = "the port" if len(port) > len(ref) else "thunder_tpu"
    for x in port[len(ref):] or ref[len(port):]:
        bad.append(x["round"])
        lines.append(f"{x['round']:5d} only in {only}'s run")
    return lines, held, bad


def load_ref(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def run_case(name: str, device: str = "cpu", rounds: int | None = None,
             ref_path: str | None = None, out: str | None = None) -> dict:
    """Write the case, run the port, compare with the record; returns
    {"case", "device", "rounds", "held", "bad", "lines"}."""
    ref = load_ref(ref_path or os.path.join(GOLDENS, f"{name}.json"))
    n = len(ref["rounds"]) if rounds is None else min(rounds, len(ref["rounds"]))
    with contextlib.ExitStack() as stack:
        tmp = out or stack.enter_context(tempfile.TemporaryDirectory(prefix=f"parity_{name}_"))
        cfg_path = write_case(name, tmp, n)
        port = read_rounds(run_port(cfg_path, device, CASES[name]["reco_kernel"]))
    lines, held, bad = compare(port, ref["rounds"][:n])
    return dict(case=name, device=device, rounds=port, held=held, bad=bad, lines=lines,
                ref_cpu=ref.get("cpu"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="run_parity")
    p.add_argument("case", choices=sorted(CASES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--ref", default=None, help="thunder_tpu's record (JSON)")
    p.add_argument("--out", default=None, help="keep the run's files here")
    a = p.parse_args(argv)
    got = run_case(a.case, a.device, a.rounds, a.ref, a.out)
    print(f"case {a.case} on {a.device}, thunder_tpu's record from {got['ref_cpu']}:")
    for line in got["lines"]:
        print("  " + line)
    print(json.dumps({k: got[k] for k in ("case", "device", "held", "bad")}))
    return 1 if got["bad"] else 0


if __name__ == "__main__":
    sys.exit(main())
