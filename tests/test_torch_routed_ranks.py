"""Routed local and CTF rounds of the port on several ranks (gloo on the
CPU) against the one-process port: thunder_tpu routes its rounds on its
mesh (optimiser.py run_routed), and so does the port.

The state: 64 images of 32 px (32 a hemisphere: segment bounds 16, 24,
28, 32), a local (CTF) round at r 14 under THUNDER_SPLIT=force with
chunk boundaries on (the port's PLAN_TABLE_MIN_BYTES lowered to 0, as
tests/test_torch_routed_round.py does), each image's supports a cloud
around its true pose, three quarters within 0.01 rad, an eighth within
0.028 and an eighth within 0.2 (tests/test_torch_table_plan.py
routed_angles), so the plan routes, the widest segment on no rung.

* Every rank's plan (rung, order, segments) from one state equals the
  one-process plan, on 2 and 4 ranks: the plan reads every rank's
  spreads.
* On 2 ranks (hemi 2 x data 1) a routed round gives the one-process
  routed round's phase counts, tag and particle state bit for bit: the
  draws are made at the running groups' global selection and cut to a
  rank's members, and a group's stall means, its members' float32 mean
  times its size summed in float64 over the world, divided by its size,
  are the one-process mean exactly (every group lies on one rank).
* On 4 ranks (hemi 2 x data 2) a group's members lie on two ranks, so
  its stall means sum in another order and phase counts may differ, as
  tests/test_torch_multirank.py holds the unrouted mesh: the round
  routes (its tag), stays finite, and its FSC-0.143 shell lies within
  three of the one process's.
Ranks and the one-process reference run one thread each.
"""

import functools
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks
from thunder_tpu_torch.optimiser import PLAN_TABLE_MIN_BYTES

SIZE, N, R_PHASE = 32, 64, 14
TIGHT, MID, WIDE = 0.01, 0.028, 0.2
SHELL_GATE = 3


def routed_angles(n_l: int) -> np.ndarray:
    """Per hemisphere: 3/4 of the images TIGHT, an eighth MID, an eighth
    WIDE, in a seeded order (tests/test_torch_table_plan.py)."""
    rng = np.random.default_rng(3)
    per = np.array([TIGHT] * (3 * n_l // 4) + [MID] * (n_l // 8) + [WIDE] * (n_l // 8))
    return np.stack([rng.permutation(per), rng.permutation(per)])


def clouds(q_top: np.ndarray, dev_rad: np.ndarray, n_r: int) -> np.ndarray:
    """Each image's n_r supports at angles dev_rad (2, L) x linspace(0.2,
    0.98) about seeded axes around its pose q_top (2, L, 4), the pose
    first (tests/test_torch_table_plan.py clouds)."""
    rng = np.random.default_rng(7)
    axes = rng.standard_normal(q_top.shape[:2] + (n_r, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    ang = dev_rad[..., None] * np.linspace(0.2, 0.98, n_r)
    pert = np.concatenate([np.cos(ang / 2)[..., None], np.sin(ang / 2)[..., None] * axes], -1)
    w1, x1, y1, z1 = (pert[..., i] for i in range(4))
    w2, x2, y2, z2 = (q_top[..., i, None] for i in range(4))
    cloud = np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1).astype(np.float32)
    cloud[:, :, 0] = q_top
    return cloud


@functools.lru_cache(maxsize=None)
def dataset():
    from thunder_tpu_torch.pipeline.synthetic import make_dataset

    vol, imgs, ctf, quats, _ = make_dataset(SIZE, N, seed=0, snr=2.5, device="cpu",
                                            defocus_range=(500.0, 500.0), shift=1.0)
    return vol, imgs, ctf, quats


def build(ctf: bool, layout=None):
    """The port's Optimiser in a local (CTF) round at R_PHASE, every
    image's supports a cloud around its true pose (this rank's rows of
    the global clouds)."""
    from thunder_tpu_torch import optimiser as to
    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.model import SEARCH_TYPE_CTF, SEARCH_TYPE_LOCAL

    vol, imgs, ctf_cols, quats = dataset()
    cfg = ThunderConfig(
        mode="3D", k=1, size=SIZE, pixel_size=1.0, mask_radius=SIZE * 0.42, trans_s=1.0,
        init_res=3.0, global_search_res=2.4, sym="C1", m_s=256, m_l_r=16, m_l_t=5,
        m_reco=8, ignore_res=SIZE * 1.0, trans_search_factor=0.25, ref_auto_recentre=False,
        g_search=False, c_search=ctf)
    opt = to.Optimiser(cfg, imgs, list(ctf_cols), np.zeros(N, np.int64),
                       init_refs=vol, device="cpu", seed=3, layout=layout)
    opt.model.search_type = SEARCH_TYPE_CTF if ctf else SEARCH_TYPE_LOCAL
    opt.model.r = R_PHASE
    n_r = opt.state.par.r.shape[2]
    cloud = clouds(quats[opt.index], routed_angles(opt.n_img_all), n_r)
    opt.state.par = opt.state.par._replace(
        r=torch.as_tensor(opt.layout.take(cloud)).contiguous())
    return opt


def plan_and_round(opt) -> dict:
    """The plan from the state, then round 0: the plan's parts, the
    record's phases, tag and FSC-0.143 shell, and every particle field
    over all ranks (a collective: every rank calls it)."""
    from thunder_tpu_torch.parallel import comm

    rung, order, segs = opt._table_plan(R_PHASE)
    rec = opt.run_round(0)
    out = dict(rung=np.asarray(rung if rung is not None else (0, 0)),
               order=np.asarray(order), segs=np.asarray([(n, *(r or (0, 0))) for n, r in segs]),
               phases=np.asarray(rec["n_phases"]), tag=np.asarray(rec.get("proj_table", "")),
               shell=np.asarray(rec["res_shell"]))
    for name, field in zip(opt.state.par._fields, opt.state.par):
        out["par_" + name] = comm.all_gather_rows(opt.layout, field).numpy()
    return out


# round kinds: search type, and whether chunk boundaries re-plan (at
# 32 px the first boundary finds no rung for any segment, so such a
# round routes its first chunk only and its tag reads the last plan)
MODES = {"local": (False, True), "ctf": (True, True), "local_whole": (False, False)}


def force_routing(boundaries: bool) -> None:
    """THUNDER_SPLIT=force, and chunk boundaries at 32 px or none."""
    from thunder_tpu_torch import optimiser as to

    os.environ["THUNDER_SPLIT"] = "force"
    to.PLAN_TABLE_MIN_BYTES = 0 if boundaries else PLAN_TABLE_MIN_BYTES


def _rank(rank, world, modes, tmp):
    from thunder_tpu_torch.parallel.distributed import default_mesh

    for mode in modes:
        ctf, boundaries = MODES[mode]
        force_routing(boundaries)
        res = plan_and_round(build(ctf, default_mesh(device="cpu")))
        np.savez(os.path.join(tmp, f"rank{rank}_of{world}_{mode}.npz"), **res)


@functools.lru_cache(maxsize=None)
def one_process(mode: str) -> dict:
    ctf, boundaries = MODES[mode]
    threads, split = torch.get_num_threads(), os.environ.get("THUNDER_SPLIT")
    torch.set_num_threads(1)
    force_routing(boundaries)
    try:
        return plan_and_round(build(ctf))
    finally:
        torch.set_num_threads(threads)
        force_routing(False)
        if split is None:
            os.environ.pop("THUNDER_SPLIT")
        else:
            os.environ["THUNDER_SPLIT"] = split


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> mode -> each rank's results."""
    tmp = tmp_path_factory.mktemp("routed_ranks")
    got = {}
    for world, modes in ((2, tuple(MODES)), (4, ("local", "local_whole"))):
        run_ranks(_rank, world, modes, str(tmp), tmp=tmp)
        got[world] = {m: [dict(np.load(tmp / f"rank{r}_of{world}_{m}.npz"))
                          for r in range(world)] for m in modes}
    return got


@pytest.mark.parametrize("world", [2, 4])
def test_plan_on_ranks_is_the_one_process_plan(ranks, world):
    """The plan at the round's start routes, the widest segment on no
    rung, and every rank's equals the one process's."""
    want = one_process("local")
    assert want["segs"].shape[0] > 1 and (want["segs"][-1, 1:] == 0).all(), want["segs"]
    for r, got in enumerate(ranks[world]["local"]):
        for key in ("rung", "order", "segs"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("mode", list(MODES))
def test_routed_round_on_two_ranks_bit_for_bit(ranks, mode):
    """Each rank's plan, phase counts, tag and every particle field over
    all images equal the one-process round's bit for bit."""
    want = one_process(mode)
    if mode == "local_whole":
        assert "+route[" in str(want["tag"]), want["tag"]
    for r, got in enumerate(ranks[2][mode]):
        assert str(got["tag"]) == str(want["tag"]), (r, got["tag"], want["tag"])
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("mode", ["local", "local_whole"])
def test_routed_round_on_four_ranks(ranks, mode):
    """hemi 2 x data 2: every rank reads the same state; it is finite,
    the round routed (without boundaries its tag says so to the end),
    and its FSC-0.143 shell lies within SHELL_GATE of the one
    process's."""
    want = one_process(mode)
    got = ranks[4][mode]
    for r in range(1, 4):
        for key in got[0]:
            np.testing.assert_array_equal(got[r][key], got[0][key], err_msg=f"rank {r}: {key}")
    assert got[0]["order"].ndim == 2 and got[0]["segs"].shape[0] > 1
    if mode == "local_whole":
        tag = str(got[0]["tag"])
        assert tag.startswith("brick") and "+route[" in tag, tag
    assert abs(int(got[0]["shell"]) - int(want["shell"])) <= SHELL_GATE, (got[0]["shell"],
                                                                          want["shell"])
    for key in got[0]:
        if key.startswith("par_"):
            assert np.isfinite(got[0][key]).all(), key
