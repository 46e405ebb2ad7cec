"""Whole runs of the port held round by round to thunder_tpu
(thunder_tpu_torch/micro/run_parity.py): each round's FSC-0.143 shell
within one of the committed thunder_tpu record's, on the same files
written by the port's generator on the CPU.

Tier-1 holds the first rounds of cases ``a`` (configs/demo.json's
settings at 32 px: C4, global search) and ``b`` (K = 2, 24 px); the
whole runs of ``a``, ``b`` and ``c`` (case ``a`` resumed in local search
with the MKB insertion option) are marked slow.

The records under tests/goldens/run_parity/ come from thunder_tpu's CLI
on the CPU; regenerate one with

    JAX_PLATFORMS=cpu python tests/test_torch_run_parity.py --write CASE

(case ``c`` sets reco_kernel="mkb" through the API, as run_parity does
for the port)."""

import json
import os
import platform
import sys

import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu_torch.micro import run_parity as rp  # noqa: E402

TIER1_ROUNDS = {"a": 3, "b": 3}


def _check(name, rounds):
    got = rp.run_case(name, "cpu", rounds)
    print("\n".join(got["lines"]))
    assert len(got["rounds"]) == (rounds or len(rp.load_ref(
        os.path.join(rp.GOLDENS, f"{name}.json"))["rounds"]))
    assert got["held"] and not got["bad"], got["lines"]
    return got


@pytest.mark.parametrize("name", sorted(TIER1_ROUNDS))
def test_first_rounds_track_thunder_tpu(name):
    """The first rounds of cases a and b: each shell within one of
    thunder_tpu's, r and the search type as thunder_tpu's."""
    got = _check(name, TIER1_ROUNDS[name])
    ref = rp.load_ref(os.path.join(rp.GOLDENS, f"{name}.json"))["rounds"]
    for p, q in zip(got["rounds"], ref):
        assert (p["r"], p["search_type"]) == (q["r"], q["search_type"])


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(rp.CASES))
def test_whole_runs_track_thunder_tpu(name):
    _check(name, None)


def test_records_name_their_command_and_cases():
    """Each committed record names the command that wrote it and holds
    every round of the case's whole run."""
    for name, case in rp.CASES.items():
        ref = rp.load_ref(os.path.join(rp.GOLDENS, f"{name}.json"))
        assert ref["case"] == name and "test_torch_run_parity.py --write" in ref["command"]
        assert 0 < len(ref["rounds"]) <= case["rounds"]
        assert {"res_shell", "r", "search_type", "n_phases", "spread"} <= set(ref["rounds"][0])


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def write_record(name: str) -> str:
    """thunder_tpu's CLI on the case's files, on the CPU; writes
    tests/goldens/run_parity/<name>.json and returns its path."""
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    from thunder_tpu.cli.thunder import main
    from thunder_tpu.config import ThunderConfig

    with tempfile.TemporaryDirectory(prefix=f"parity_ref_{name}_") as tmp:
        cfg_path = rp.write_case(name, tmp)
        with rp.reco_kernel(ThunderConfig, rp.CASES[name]["reco_kernel"]):
            main([cfg_path])
        with open(cfg_path) as f:
            rounds = rp.read_rounds(json.load(f)["Basic"]["Path of Output"])
    os.makedirs(rp.GOLDENS, exist_ok=True)
    path = os.path.join(rp.GOLDENS, f"{name}.json")
    with open(path, "w") as f:
        json.dump({"case": name,
                   "command": f"JAX_PLATFORMS=cpu python tests/test_torch_run_parity.py "
                              f"--write {name}",
                   "cpu": cpu_name(),
                   "rounds": rounds}, f, indent=1)
    return path


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--write":
        print(write_record(sys.argv[2]))
    else:
        sys.exit("usage: python tests/test_torch_run_parity.py --write CASE")
