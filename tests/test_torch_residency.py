"""The port's residency plan (Optimiser._plan_residency) on the CPU,
against thunder_tpu's (tests/test_residency.py): a small run stays
resident; 100,000 images at 256 px on an 80 GB budget turn the host path
on and fit, 200,000 warn, in both packages, whose stack entries agree;
two data ranks sharing one card halve its budget; the plan counts the
projection table the port keeps; and a plan over its budget turns the
host path on in a run by itself (hbm_gb, THUNDER_HBM_GB)."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402
from thunder_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

SIZE, N = 24, 16


def ctf_cols(n):
    return (np.full(n, 300e3), np.full(n, 500.0), np.full(n, 500.0), np.zeros(n),
            np.full(n, 2e7), np.full(n, 0.1), np.zeros(n))


def config(cls, **kw):
    """tests/test_residency.py's config in thunder_tpu's or the port's class."""
    return cls(mode="3D", k=1, size=SIZE, pixel_size=1.0, mask_radius=10.0, trans_s=1.5,
               m_s=64, m_l_r=8, m_l_t=5, m_reco=4, ignore_res=SIZE * 1.0, **kw)


def images():
    return np.random.default_rng(0).standard_normal((N, SIZE, SIZE)).astype(np.float32)


def port(**kw):
    return to.Optimiser(config(TConfig, **kw), images(), ctf_cols(N), np.zeros(N, np.int64),
                        device="cpu")


def thunder(**kw):
    return jo.Optimiser(config(JConfig, **kw), images(), jctf_params(*ctf_cols(N)),
                        np.zeros(N, np.int64))


def replan(opt, n_images: int, size: int = 256, hbm_gb: float = 80.0) -> dict:
    """Either package's plan at another scale, without building its
    stacks: ``n_images`` at ``size`` px over one process's two
    hemispheres."""
    opt.cfg.size = size
    opt.cfg.host_ft_ori = False
    opt.cfg.hbm_gb = hbm_gb
    opt.n_img = n_images // 2
    return opt._plan_residency()


def test_small_run_stays_resident():
    opt = port()
    assert "auto" not in opt.residency_plan and "warning" not in opt.residency_plan
    assert not opt.cfg.host_ft_ori
    assert not isinstance(opt.data.ft_ori, to.HostFt)
    assert opt.residency_plan["total_gb"] < 1.0


@pytest.mark.parametrize("n_images, fits", [(100_000, True), (200_000, False)])
def test_reference_scale_plan_matches_thunder_tpus(n_images, fits, capsys):
    """100,000 x 256 px on an 80 GB card: both packages turn the host path
    on by themselves and the port's total fits (one stack, 48.8 GiB, and
    what the port holds besides, times the headroom); 200,000 warn in
    both.  The stack entries are thunder_tpu's for the same (L, size)."""
    t, j = replan(port(), n_images), replan(thunder(), n_images)
    for plan, opt in ((t, "port"), (j, "thunder_tpu")):
        assert plan["auto"] == "host_ft_ori", (opt, plan)
        assert ("warning" not in plan) == fits, (opt, plan)
    for key in ("ft_masked", "ft_ori"):
        assert t["per_device_gb"][key] == j["per_device_gb"][key]
    assert t["per_device_gb"]["ft_ori"] == pytest.approx(n_images * 256 ** 2 * 8 / 2 ** 30)
    assert (t["total_gb"] < 80.0) == fits
    assert "[residency]" in capsys.readouterr().out


def test_ranks_sharing_a_card_share_its_budget(monkeypatch):
    """Two data ranks on one device each count their own rows against
    half its budget; on cards, ranks share a card where there are more
    ranks than cards (cuda:(rank % cards)).  The plan alone, without a
    process group: the ranks' agreement (comm.max_world) is the
    identity here; tests/test_torch_multirank.py runs it on ranks."""
    monkeypatch.setattr(to.comm, "max_world", lambda lay, t: t)
    opt = port()
    one = replan(opt, 100_000)
    opt.layout = make_mesh(2, hemi=1, rank=0, device=torch.device("cpu"))
    two = replan(opt, 50_000)        # each rank's rows: 25,000 a hemisphere
    assert two["budget_gb"] == one["budget_gb"] / 2 == 40.0
    assert two["layout"]["ranks_on_card"] == 2
    assert two["per_device_gb"]["ft_ori"] == one["per_device_gb"]["ft_ori"] / 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda", 0)
    assert [to.ranks_on_card(cuda, make_mesh(4, 2, r)) for r in range(4)] == [2] * 4
    assert to.ranks_on_card(cuda, make_mesh(2, 2, 1)) == 1
    assert to.ranks_on_card(cuda, make_mesh(1, 1, 0)) == 1


def test_plan_counts_the_table_the_port_keeps():
    """The plan's projection table is the bytes proj_table keeps at the
    full band (here HK1's quad table, 32 bytes a cell)."""
    opt = port()
    table = opt.proj_table(opt.cfg.max_r)
    assert table.dtype == torch.float32 and table.shape[-1] == 8
    got = opt.residency_plan["per_device_gb"]["proj_table"] * 2 ** 30
    assert got == table.numel() * table.element_size()


@pytest.mark.parametrize("how", ["hbm_gb", "env"])
def test_a_plan_over_budget_turns_the_host_path_on(how, monkeypatch):
    """A budget below the small run's total: the plan turns host_ft_ori
    on, the originals go to a HostFt, and a round runs."""
    if how == "env":
        monkeypatch.setenv("THUNDER_HBM_GB", "0.0001")
        opt = port()
    else:
        opt = port(hbm_gb=1e-4)
    assert opt.residency_plan["auto"] == "host_ft_ori" and "warning" in opt.residency_plan
    assert opt.residency_plan["budget_gb"] == pytest.approx(1e-4)
    assert isinstance(opt.data.ft_ori, to.HostFt)
    rec = opt.run_round(0)
    assert np.isfinite(rec["res_A"])
