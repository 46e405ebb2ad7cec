"""The port's optimiser and CLI on several ranks (gloo on the CPU)
against the one-process port.

* A 2D round 0 on 2 ranks (hemi 2 x data 1), 3 ranks (data-only) and 4
  ranks (hemi 2 x data 2) against one process, by
  tests/test_optimiser_mesh.py's criteria: references within rtol 5e-2 /
  atol 1e-4, classes exactly equal, FSC within 2e-2 where |FSC| > 0.5.
  Every rank draws at the global shape, so the runs take the same draws.
* Two 3D rounds on 4 ranks, held statistically as thunder_tpu holds its
  mesh run (test_optimiser_mesh.py:66-): the stall rule reads sums over
  the data group, whose float order differs, so phase counts may too.
* Two 3D rounds on 4 ranks on the host path (HostFt, two chunks a
  rank, a local round: the two-pass statistics' sums and median over
  the ranks), held as the resident 4-rank run is.
* Two data ranks whose budgets differ agree on the host path and run
  a global round, a local round and subtraction on it.
* The CLI through --coordinator / --num-processes / --process-id
  --device cpu on 2, 3 and 4 processes writes the files one process
  writes, from rank 0 alone.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_parallel import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTF_2D = (300e3, 2000.0, 2000.0, 0.0, 0.0, 0.1, 0.0)


def _build(kind: str, n: int, layout=None, **cfg_kw):
    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.optimiser import Optimiser
    from thunder_tpu_torch.pipeline.synthetic import make_dataset, make_dataset_2d

    if kind == "2d":
        size = 32
        _, imgs, _, _, _, _ = make_dataset_2d(size, n, 2, seed=0, device="cpu")
        cfg = ThunderConfig(
            mode="2D", k=2, size=size, pixel_size=1.0, mask_radius=12.0, trans_s=2.0,
            init_res=8.0, global_search_res=4.0, sym="C1", m_s_2d=32, m_l_r_2d=9,
            m_l_t=9, m_reco=8, ignore_res=size * 1.0, trans_search_factor=0.25)
        ctf = [np.full(n, v) for v in CTF_2D]
        return Optimiser(cfg, imgs, ctf, np.zeros(n, np.int64), device="cpu",
                         layout=layout), None
    size = 24
    vol, imgs, _, quats, _ = make_dataset(size, n, seed=0, snr=2.0, device="cpu",
                                          defocus_range=(500.0, 500.0), shift=1.5)
    cfg = ThunderConfig(
        mode="3D", k=1, size=size, pixel_size=1.0, mask_radius=10.0, trans_s=1.5,
        init_res=4.0, global_search_res=3.0, sym="C1", m_s=128, m_l_r=12, m_l_t=9,
        m_reco=8, ignore_res=size * 1.0, trans_search_factor=0.25,
        ref_auto_recentre=False, **cfg_kw)
    ctf = [np.full(n, v) for v in (300e3, 500.0, 500.0, 0.0, 2e7, 0.1, 0.0)]
    return Optimiser(cfg, imgs, ctf, np.zeros(n, np.int64), init_refs=vol, device="cpu",
                     layout=layout), (vol, quats)


def _result(opt) -> dict:
    """Both hemispheres' references, the classes and rank-1 poses in
    particle order, and the FSC (collectives: every rank calls it)."""
    from thunder_tpu_torch.parallel import comm

    top = comm.all_gather_rows(opt.layout, opt.state.par.top_r).numpy()
    q = np.zeros((opt.n_total, 4), np.float32)
    for h in (0, 1):
        v = opt.valid[h]
        q[opt.index[h][v]] = top[h][v]
    return dict(refs=opt.refs_both(), cls=opt.class_assignments(), quats=q,
                fsc=np.asarray(opt.model.fsc), phases=[r["n_phases"] for r in opt.round_records])


def _round_rank(rank, world, kind, n, rounds, tmp):
    from thunder_tpu_torch.parallel.distributed import default_mesh

    opt, _ = _build(kind, n, default_mesh(device="cpu"))
    for i in range(rounds):
        opt.run_round(i)
    res = _result(opt)
    if rank == 0:
        np.savez(os.path.join(tmp, "ranks.npz"), **{k: np.asarray(v) for k, v in res.items()})


def _host_round_rank(rank, world, n, rounds, tmp):
    from thunder_tpu_torch.model import SEARCH_TYPE_LOCAL
    from thunder_tpu_torch.optimiser import HostFt
    from thunder_tpu_torch.parallel.distributed import default_mesh

    opt, _ = _build("3d", n, default_mesh(device="cpu"), host_ft_ori=True, host_ft_chunk=2)
    assert isinstance(opt.data.ft_ori, HostFt) and len(opt._ft_chunks()) == 2
    for i in range(rounds):
        if i == rounds - 1:
            opt.model.search_type = SEARCH_TYPE_LOCAL
        opt.run_round(i)
    res = _result(opt)
    if rank == 0:
        np.savez(os.path.join(tmp, "ranks.npz"), **{k: np.asarray(v) for k, v in res.items()})


def _budget_rank(rank, world, n, tmp):
    import torch

    from thunder_tpu_torch.model import SEARCH_TYPE_LOCAL
    from thunder_tpu_torch.optimiser import HostFt
    from thunder_tpu_torch.parallel import comm
    from thunder_tpu_torch.parallel.distributed import default_mesh

    # rank 0 reads a budget its stacks exceed, the others one they fit
    opt, _ = _build("3d", n, default_mesh(hemi=1, device="cpu"), host_ft_chunk=2,
                    hbm_gb=1e-4 if rank == 0 else 80.0)
    plan = opt.residency_plan
    assert plan["auto"] == ("host_ft_ori" if rank == 0 else "host_ft_ori (another rank's plan)")
    assert isinstance(opt.data.ft_ori, HostFt) and len(opt._ft_chunks()) == 2, plan
    for i in range(2):
        if i == 1:
            opt.model.search_type = SEARCH_TYPE_LOCAL
        opt.run_round(i)
    size = opt.cfg.size
    rows = opt.save_subtract(np.ones((size,) * 3, np.float32), chunk=3)
    # a chunk at a time (3 and 1 rows of each rank) against one gather
    x = torch.arange(opt.nh * opt.n_img * 2, dtype=torch.float32).reshape(opt.nh, opt.n_img, 2)
    x = x + 100 * rank
    steps = comm.gather_host_rows_to_lead(opt.layout, x, 3, opt.device)
    whole = comm.gather_rows_to_lead(opt.layout, x)
    if rank == 0:
        assert torch.equal(steps, whole)
        assert rows.shape == (n, size, size) and np.all(np.isfinite(rows))
        np.savez(os.path.join(tmp, "ranks.npz"), rows=rows)
    else:
        assert rows is None and steps is None


@functools.lru_cache(maxsize=None)
def _one_process(kind: str, n: int, rounds: int):
    opt, truth = _build(kind, n)
    for i in range(rounds):
        opt.run_round(i)
    return {k: np.asarray(v) for k, v in _result(opt).items()}, truth


@pytest.mark.parametrize("world,n", [(2, 32), (3, 36), (4, 32)])
def test_2d_round0_matches_one_process(tmp_path, world, n):
    """n keeps L (images a hemisphere) a multiple of the data extent, so
    the global draw shapes are the one-process run's."""
    run_ranks(_round_rank, world, "2d", n, 1, str(tmp_path), tmp=tmp_path)
    got = np.load(tmp_path / "ranks.npz")
    want, _ = _one_process("2d", n, 1)
    np.testing.assert_array_equal(got["cls"], want["cls"])
    np.testing.assert_allclose(got["refs"], want["refs"], rtol=5e-2, atol=1e-4)
    # shells near zero correlation are sensitive to the order of sums
    strong = np.abs(want["fsc"]) > 0.5
    np.testing.assert_allclose(got["fsc"][strong], want["fsc"][strong], rtol=5e-2, atol=2e-2)


def _pose_err_deg(q, truth) -> np.ndarray:
    dot = np.abs(np.sum(q * truth, axis=-1)).clip(0, 1)
    return np.degrees(2 * np.arccos(dot))


def test_3d_two_rounds_on_four_ranks(tmp_path):
    """Both runs recover the generating orientations and the phantom
    alike; the rank run may take other phase counts (sums in another
    order meet the stall rule's 0.95 threshold)."""
    n = 16          # 4 images a rank
    run_ranks(_round_rank, 4, "3d", n, 2, str(tmp_path), tmp=tmp_path)
    got = np.load(tmp_path / "ranks.npz")
    want, (vol, quats) = _one_process("3d", n, 2)
    err_1, err_4 = _pose_err_deg(want["quats"], quats), _pose_err_deg(got["quats"], quats)
    corr = lambda r: np.corrcoef(r.mean(axis=(0, 1)).ravel(), vol.ravel())[0, 1]
    assert np.median(err_4) <= np.median(err_1) + 5.0, (np.median(err_4), np.median(err_1))
    assert corr(got["refs"]) >= corr(want["refs"]) - 0.05
    assert np.all(np.isfinite(got["refs"]))


def _demo(tmp_path, n: int) -> str:
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    out = str(tmp_path / "demo")
    write_demo(out, n=n, size=32, snr=3.0, seed=0, device="cpu", mode="2D", k=2)
    cfg_path = os.path.join(out, "demo.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["Advanced"]["Max Number of Iteration"] = 1
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return cfg_path


def _point_output(cfg_path: str, name: str) -> str:
    with open(cfg_path) as f:
        cfg = json.load(f)
    out = os.path.join(os.path.dirname(cfg_path), name) + "/"
    cfg["Basic"]["Path of Output"] = out
    path = cfg_path.replace(".json", f"_{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def one_process_cli(tmp_path_factory):
    """The demo's config and the directory one process wrote it to."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg_path = _demo(tmp, 48)        # 24 a hemisphere: splits over data extents 1, 2 and 3
    res = subprocess.run([sys.executable, "-m", "thunder_tpu_torch.cli.thunder",
                          _point_output(cfg_path, "one"), "--device", "cpu"], env=ENV,
                         capture_output=True, text=True, timeout=300, cwd=str(tmp))
    assert res.returncode == 0, res.stderr[-3000:]
    return cfg_path, os.path.join(os.path.dirname(cfg_path), "one")


@pytest.mark.parametrize("world", [2, 3, 4])
def test_cli_on_ranks_writes_what_one_process_writes(one_process_cli, world):
    from thunder_tpu_torch.cli.thunder import spawn_ranks
    from thunder_tpu_torch.io.mrc import read_mrc
    from thunder_tpu_torch.io.thu import read_thu

    cfg_path, d1 = one_process_cli
    name = f"ranks{world}"
    many = _point_output(cfg_path, name)
    env = ENV
    old = dict(os.environ)
    os.environ.update(env)
    try:
        rc = spawn_ranks([many, "--device", "cpu"], world, timeout_s=300)
    finally:
        os.environ.clear()
        os.environ.update(old)
    assert rc == 0
    dn = os.path.join(os.path.dirname(cfg_path), name)
    assert sorted(os.listdir(d1)) == sorted(os.listdir(dn))
    t1, tn = read_thu(os.path.join(d1, "Meta_Round_000.thu")), read_thu(
        os.path.join(dn, "Meta_Round_000.thu"))
    np.testing.assert_array_equal(t1.class_id, tn.class_id)
    np.testing.assert_allclose(tn.quat, t1.quat, atol=1e-4)
    a, _ = read_mrc(os.path.join(d1, "Reference_Final.mrcs"))
    b, _ = read_mrc(os.path.join(dn, "Reference_Final.mrcs"))
    np.testing.assert_allclose(b, a, rtol=5e-2, atol=1e-3)


def test_3d_host_path_on_four_ranks(tmp_path):
    """The host path on 4 ranks (hemi 2 x data 2, 4 images a rank, two
    a chunk): a global round, then a local round (norm
    correction's median over every rank, sigma's sums over the data
    group, chunked insertion summed over it), held to the one-process
    resident run as the resident 4-rank run is."""
    n = 16
    run_ranks(_host_round_rank, 4, n, 2, str(tmp_path), tmp=tmp_path)
    got = np.load(tmp_path / "ranks.npz")
    want, (vol, quats) = _one_process("3d", n, 2)
    err_1, err_4 = _pose_err_deg(want["quats"], quats), _pose_err_deg(got["quats"], quats)
    corr = lambda r: np.corrcoef(r.mean(axis=(0, 1)).ravel(), vol.ravel())[0, 1]
    assert np.median(err_4) <= np.median(err_1) + 5.0, (np.median(err_4), np.median(err_1))
    assert corr(got["refs"]) >= corr(want["refs"]) - 0.05
    assert np.all(np.isfinite(got["refs"]))


def test_ranks_with_other_budgets_take_one_path(tmp_path):
    """Two data ranks whose budgets differ (hbm_gb set per rank: one
    rank's stacks exceed its budget, the other's fit) agree on the host
    path, and a global round, a local round (the two-pass statistics'
    collectives over both ranks) and subtraction (its rows gathered a
    chunk at a time) run on both."""
    n = 16
    run_ranks(_budget_rank, 2, n, str(tmp_path), tmp=tmp_path)
    assert np.load(tmp_path / "ranks.npz")["rows"].shape[0] == n
