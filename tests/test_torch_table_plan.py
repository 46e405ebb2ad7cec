"""The port's table plan of local rounds (optimiser._table_plan and its
parts: the spread statistics, _brick_choice, _route_bounds, the chunked
phase driver and the routed segments' merge) held to thunder_tpu's on
thunder_tpu's own particle states, and local rounds of both packages
through the plan.

Given thunder_tpu's clouds, the port's plan takes thunder_tpu's rung,
order and segments: the clouds are thunder_tpu's (tests/test_routing.py
_tight_cloud_optimiser's construction, each image's supports at a chosen
angle around its top pose), carried into the port with interop.  The
spreads are float32 arccos of |dot| near 1 in both packages, so they
agree to ~1e-4 rad (a rounding of the dot moves the arccos by up to
sqrt(2 ulp)); the plan is compared on spreads chosen away from every
threshold, and also on thunder_tpu's own spreads handed to both.
"""

import functools
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.io.thu import ThuTable  # noqa: E402
from thunder_tpu.model import SEARCH_TYPE_LOCAL  # noqa: E402
from thunder_tpu.ops.brick import table_bytes  # noqa: E402
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu_torch import interop  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402

from test_e2e_3d import make_3d_dataset  # noqa: E402

SIZE, N, R_PHASE = 32, 64, 14
# per-image support angles (radians) for the routed state: at r 14 and pf
# 2 a round start reads 1.3 x 28 = 36.4 cells a radian, so 0.01 rad fits
# (4, 1) (0.8 cells), 0.028 fits only (6, 2) (1.2 cells), 0.2 nothing
TIGHT, MID, WIDE = 0.01, 0.028, 0.2


def ctf_cols(n: int, defocus: float = 500.0):
    return (np.full(n, 300e3), np.full(n, defocus), np.full(n, defocus), np.zeros(n),
            np.full(n, 2e7), np.full(n, 0.1), np.zeros(n))


def config(cls, size: int, **kw):
    base = dict(mode="3D", k=1, size=size, pixel_size=1.0, mask_radius=size * 0.42,
                trans_s=1.0, init_res=3.0, global_search_res=2.4, sym="C1", m_s=256,
                m_l_r=16, m_l_t=5, m_reco=8, ignore_res=size * 1.0,
                trans_search_factor=0.25, ref_auto_recentre=False, g_search=False)
    base.update(kw)
    return cls(**base)


def clouds(q_top: np.ndarray, dev_rad: np.ndarray, n_r: int) -> np.ndarray:
    """Each image's n_r supports at angles dev_rad (2, L) x linspace(0.2,
    0.98) about seeded axes around its top pose q_top (2, L, 4), the top
    pose first (tests/test_routing.py _tight_cloud_optimiser)."""
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
    return make_3d_dataset(SIZE, N, snr=2.5)


@pytest.fixture(scope="module")
def pair():
    """Both packages' Optimisers on the same 64 images of 32 px, in a
    local round at r 14, the port holding thunder_tpu's state."""
    phantom, imgs, _, _ = dataset()
    jopt = jo.Optimiser(config(JConfig, SIZE), imgs, jctf_params(*ctf_cols(N)),
                        np.zeros(N, np.int64), init_refs=phantom)
    topt = to.Optimiser(config(TConfig, SIZE), imgs, ctf_cols(N), np.zeros(N, np.int64),
                        init_refs=phantom, device="cpu")
    return jopt, topt


def set_clouds(pair, dev_rad: np.ndarray):
    """thunder_tpu's state with clouds of the given per-image angles,
    carried into the port; both at the local round r = R_PHASE."""
    jopt, topt = pair
    jopt.model.search_type = SEARCH_TYPE_LOCAL
    jopt.model.r = R_PHASE
    par = jopt.state.par
    q_top = np.asarray(par.r[:, :, 0])
    jopt.state.par = par._replace(r=jnp.asarray(clouds(q_top, dev_rad, par.r.shape[2])))
    interop.restore(topt, interop.snapshot(jopt))
    for opt in pair:
        opt._round_brick, opt._round_order, opt._round_segs = None, None, ()
        opt._brick_used = set()


def routed_angles(n_l: int) -> np.ndarray:
    """Per hemisphere: 3/4 of the images TIGHT, an eighth MID, an eighth
    WIDE, in a seeded order."""
    rng = np.random.default_rng(3)
    per = np.array([TIGHT] * (3 * n_l // 4) + [MID] * (n_l // 8) + [WIDE] * (n_l // 8))
    return np.stack([rng.permutation(per), rng.permutation(per)])


def spreads(pair):
    jopt, topt = pair
    j_img = np.asarray(jo._spread_per_image_h(jopt.state.par.r, jopt.valid_dev))
    j_all = float(jo._spread_q98_h(jopt.state.par.r, jopt.valid_dev))
    t_img = to.per_image_q98(topt._spread_devs(), topt.valid_all)
    t_all = to.pooled_q98(topt._spread_devs(), topt.valid_all)
    return j_img, j_all, t_img, t_all


def plans(pair, r_u: int = R_PHASE, mid_round: bool = False, spread_img=None):
    jopt, topt = pair
    return (jopt._table_plan(r_u, mid_round=mid_round, spread_img=spread_img),
            topt._table_plan(r_u, mid_round=mid_round, spread_img=spread_img))


def same_plan(a, b, order: bool = True):
    """The same rung and segments, and routing in both or neither; with
    ``order``, the same routing order (images of equal angle sort by
    rounding: compared where both read the same spreads)."""
    assert a[0] == b[0] and tuple(a[2]) == tuple(b[2]), (a[0], a[2], b[0], b[2])
    assert (a[1] is None) == (b[1] is None)
    if order and a[1] is not None:
        np.testing.assert_array_equal(np.asarray(a[1]), b[1])


def test_spreads_and_routed_plan_match(pair, monkeypatch):
    """The spread statistics, and under THUNDER_SPLIT=force the routed
    plan: rung, order and segments, from each package's own spreads and
    from thunder_tpu's spreads handed to both."""
    monkeypatch.setenv("THUNDER_SPLIT", "force")
    set_clouds(pair, routed_angles(pair[1].n_img_all))
    j_img, j_all, t_img, t_all = spreads(pair)
    assert np.abs(t_img - j_img).max() < 2e-4, np.abs(t_img - j_img).max()
    assert abs(t_all - j_all) < 2e-4, (t_all, j_all)
    for mid in (False, True):
        j, t = plans(pair, mid_round=mid)
        assert j[1] is not None, j
        assert [r for _, r in j[2]] == [(4, 1), (4, 1), (6, 2), None], j[2]
        assert j[0] == t[0] and tuple(j[2]) == tuple(t[2])
        same_plan(*plans(pair, mid_round=mid, spread_img=j_img))
    assert pair[0]._route_bounds() == pair[1]._route_bounds() == (16, 24, 28, 32)


@pytest.mark.parametrize("angle, r_u", [(TIGHT, R_PHASE), (MID, R_PHASE), (WIDE, R_PHASE),
                                        (TIGHT, 30), (0.003, 40)])
def test_uniform_clouds_take_one_rung(pair, angle, r_u):
    """Clouds alike: no routing (one rung for all, or none), at the phase
    band and at wider bands (the 8-span rung needs a corner-row table
    of 48 MB: crop 164 at r 40 with a 64 px crop limit stays out)."""
    set_clouds(pair, np.full((2, pair[1].n_img_all), angle))
    for mid in (False, True):
        j, t = plans(pair, r_u, mid)
        assert j[1] is None
        same_plan(j, t)


def test_budget_squeeze(pair, monkeypatch):
    """tests/test_brick.py:133's squeeze: with the byte budget under
    (4, 1)'s table both packages fall to (5, 2); with no budget, to
    none."""
    set_clouds(pair, np.full((2, pair[1].n_img_all), 0.002))
    crop = to.proj_crop_size(SIZE, 2, 8)
    assert [o._brick_choice(8, mid_round=True) for o in pair] == [(4, 1), (4, 1)]
    for budget, want in ((table_bytes(4, 1, crop) - 1, (5, 2)), (0, None)):
        monkeypatch.setattr(jo, "BRICK_TABLE_BUDGET", budget)
        monkeypatch.setattr(to, "BRICK_TABLE_BUDGET", budget)
        assert [o._brick_choice(8, mid_round=True) for o in pair] == [want, want]


def test_hysteresis(pair):
    """A spread between 0.8 and 1 of (4, 1)'s margin: a rung neither in
    use nor engaged before is passed over for (6, 2); in use, or engaged
    earlier in the run, it is taken, in both packages."""
    set_clouds(pair, np.full((2, pair[1].n_img_all), TIGHT))
    j_img = spreads(pair)[0]
    q98 = float(np.sort(j_img, axis=1)[:, -1].max())
    # spread_cells = q98 x 1.15 x 2 r_u at a boundary: place it at 0.9 cells
    r_u = int(round(0.9 / (q98 * 1.15 * 2)))
    cells = q98 * 1.15 * 2 * r_u
    assert 0.8 < cells <= 1.0, cells
    for opt in pair:
        assert opt._brick_choice(r_u, True, spread_q98=q98) == (6, 2)
        opt._round_brick = (4, 1)
        assert opt._brick_choice(r_u, True, spread_q98=q98) == (4, 1)
        opt._round_brick, opt._brick_used = None, {(4, 1)}
        assert opt._brick_choice(r_u, True, spread_q98=q98) == (4, 1)
        opt._brick_used = set()


def test_environment_variables(pair, monkeypatch):
    """THUNDER_BRICK off and span,stride, THUNDER_SPLIT 0 and force:
    the same plan in both packages."""
    set_clouds(pair, routed_angles(pair[1].n_img_all))
    cases = [({"THUNDER_BRICK": "off"}, None, False),
             ({"THUNDER_BRICK": "6,2"}, (6, 2), False),
             ({"THUNDER_SPLIT": "0"}, None, False),
             ({"THUNDER_SPLIT": "force"}, (4, 1), True)]
    for env, rung, routed in cases:
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            j, t = plans(pair)
            same_plan(j, t, order=False)
            same_plan(*plans(pair, spread_img=spreads(pair)[0]))
            assert j[0] == rung and (j[1] is not None) == routed, (env, j[0], j[2])
    # without the variables the routing needs a table past 24 MB
    j, t = plans(pair)
    same_plan(j, t)
    assert j[1] is None and j[0] is None


@pytest.mark.parametrize("chunk", ["1", "2"])
def test_chunked_driver_and_merge_match(pair, monkeypatch, chunk):
    """thunder_tpu's chunked driver on a routed plan, its loops replaced
    by injected per-segment states (THUNDER_PHASE_CHUNK = chunk): the
    port's driver asks for the same chunk ends, replans at the same
    boundaries, and merges each hemisphere's segment states as
    run_routed does (phase by max, n_no_dec by min, variances by max)."""
    jopt, topt = pair
    monkeypatch.setenv("THUNDER_PHASE_CHUNK", chunk)
    set_clouds(pair, routed_angles(topt.n_img_all))
    n_l = topt.n_img_all
    order = np.stack([np.random.default_rng(h).permutation(n_l) for h in (0, 1)]).astype(
        np.int32)
    segs = ((n_l // 2, (4, 1)), (n_l // 4, (5, 2)), (n_l // 4, None))
    rng = np.random.default_rng(int(chunk))

    def seg_state(chunk_i, seg):
        """A segment's loop result: phases run, stall counts, variances
        (2 hemispheres); the first segment keeps both hemispheres
        running until the last chunk, which ends every segment."""
        ph = rng.integers(1, 4, 2) + 4 * chunk_i
        nnd = (np.ones(2) if chunk_i == 2 else
               np.zeros(2) if seg == 0 else rng.integers(0, 2, 2))
        return ph.astype(np.int32), nnd.astype(np.int32), rng.uniform(0.5, 2, (2, 4))

    script = [[seg_state(c, j) for j in range(len(segs))] for c in range(3)]
    seen = {"jax": [], "port": []}

    def fake_loop(keys, par, cls, stack, i_col, i_row, dat_w, sctf2, a_term, mn, mx, init,
                  *a, **kw):
        i = len(seen["jax"])
        seen["jax"].append((int(mx), [np.asarray(x) for x in init]))
        ph, nnd, prev = script[i // len(segs)][i % len(segs)]
        return par, jnp.asarray(ph), jnp.asarray(nnd), jnp.asarray(prev, jnp.float32)

    plan = ((4, 1), order, segs)
    monkeypatch.setattr(jo, "_phase_loop_h", fake_loop)
    monkeypatch.setattr(jo, "_proj_crop_size", lambda *a: 120)   # a table past 24 MB
    monkeypatch.setattr(jopt, "_proj_stack", lambda *a, **kw: jnp.zeros((1, 1, 1)))
    monkeypatch.setattr(jopt, "_table_plan", lambda *a, **kw: plan)
    jopt._round_brick, jopt._round_order, jopt._round_segs = plan
    j_phase = np.asarray(jopt.local_phases(jopt._rings()))

    def fake_routed(par, state, max_phase, *a):
        i = len(seen["port"])
        seen["port"].append((max_phase, [st[0] for st in state], [st[1] for st in state],
                             [st[2] for st in state]))
        outs = script[i]
        merged = [to.merge_segment_states([[int(o[0][h]), int(o[1][h]), list(o[2][h])]
                                           for o in outs]) for h in (0, 1)]
        return par, merged

    monkeypatch.setattr(to, "PLAN_TABLE_MIN_BYTES", 0)
    monkeypatch.setattr(topt, "_phases_routed", fake_routed)
    monkeypatch.setattr(topt, "_table_plan", lambda *a, **kw: plan)
    topt._round_brick, topt._round_order, topt._round_segs = plan
    t_phase = topt.local_phases(topt._rings())

    np.testing.assert_array_equal(j_phase, t_phase)
    j_calls = seen["jax"][::len(segs)]        # one call a segment, the same state each
    assert [c[0] for c in j_calls] == [c[0] for c in seen["port"]]
    for (_, (ph, nnd, prev)), (_, t_ph, t_nnd, t_prev) in zip(j_calls, seen["port"]):
        np.testing.assert_array_equal(ph, t_ph)
        np.testing.assert_array_equal(nnd, t_nnd)
        np.testing.assert_allclose(prev, np.asarray(t_prev, np.float32))
    assert len(seen["port"]) == 3


def truth_error_deg(opt, true_q) -> float:
    """Median angle of the rank-1 poses from the truth (tests/test_brick.py
    _truth_error_deg)."""
    t = np.asarray(opt.state.par.top_r.cpu() if torch.is_tensor(opt.state.par.top_r)
                   else opt.state.par.top_r)
    top = np.zeros((opt.n_total, 4), np.float32)
    for h in (0, 1):
        v = opt.valid[h]
        top[opt.index[h][v]] = t[h][v]
    dot = np.abs(np.sum(top * np.asarray(true_q), axis=-1))
    return float(np.median(np.degrees(2 * np.arccos(np.clip(dot, -1, 1)))))


def tight_pair(seed: int = 0):
    """tests/test_brick.py's tight-cloud setup (24 px, 32 images of
    dataset ``seed`` resumed at the truth with k = 1e-6) in both
    packages, each image's supports injected within 0.01 rad of its true
    pose in thunder_tpu and carried into the port (the resumed ACG
    clouds of k = 1e-6 carry tails of tenths of a radian, which no rung
    holds).  Returns (thunder_tpu's Optimiser, the port's, true poses)."""
    size, n = 24, 32
    phantom, imgs, true_q, true_t = make_3d_dataset(size, n, seed=seed, snr=4.0)
    thu = ThuTable.blank(n, voltage=300e3)
    thu.quat, thu.trans = np.asarray(true_q), np.asarray(true_t)
    thu.std_trans = np.full((n, 2), 0.2)
    thu.k1 = thu.k2 = thu.k3 = np.full(n, 1e-6)
    kw = dict(mode="3D", k=1, size=size, pixel_size=1.0, mask_radius=10.0, trans_s=1.0,
              init_res=3.0, global_search_res=3.0, sym="C1", m_s=64, m_l_r=16, m_l_t=5,
              m_reco=8, ignore_res=24.0, trans_search_factor=0.1, g_search=False)
    jopt = jo.Optimiser(JConfig(**kw), imgs, jctf_params(*ctf_cols(n)),
                        np.zeros(n, np.int64), init_refs=phantom, resume_thu=thu)
    topt = to.Optimiser(TConfig(**kw), imgs, ctf_cols(n), np.zeros(n, np.int64),
                        init_refs=phantom, resume_thu=thu, device="cpu")
    par = jopt.state.par
    jopt.state.par = par._replace(r=jnp.asarray(clouds(
        np.asarray(par.r[:, :, 0]), np.full((2, jopt.n_img), 0.01), par.r.shape[2])))
    interop.restore(topt, interop.snapshot(jopt))
    return jopt, topt, true_q


def test_tight_cloud_round_in_both_packages():
    """A tight-cloud local round (tight_pair) in both packages: the plan
    engages the same rung at the round's start, the state stays finite,
    the FSC-0.143 shells lie within one, and both alignment errors stay
    under tests/test_brick.py's 11 degrees."""
    jopt, topt, true_q = tight_pair()
    j_plan, t_plan = jopt._table_plan(int(jopt.model.r)), topt._table_plan(int(topt.model.r))
    assert j_plan[0] is not None and j_plan[0] == t_plan[0], (j_plan, t_plan)
    rj, rt = jopt.run_round(0), topt.run_round(0)
    assert rj["proj_table"] == rt["proj_table"] == "brick%s" % (j_plan[0],)
    for leaf in topt.state.par:
        assert torch.isfinite(leaf).all()
    assert abs(rj["res_shell"] - rt["res_shell"]) <= 1, (rj["res_shell"], rt["res_shell"])
    errs = truth_error_deg(jopt, true_q), truth_error_deg(topt, true_q)
    print(f"tight-cloud round: {rj['proj_table']}, res shells {rj['res_shell']} / "
          f"{rt['res_shell']}, alignment errors {errs[0]:.2f} / {errs[1]:.2f} deg")
    assert max(errs) < 11.0, errs


def test_routed_round_keeps_shapes(monkeypatch):
    """A local round of the port routed under THUNDER_SPLIT=force (32
    images a hemisphere, an eighth of them with wide clouds): the state
    keeps its shapes and stays finite, and the record carries the
    routed tag."""
    monkeypatch.setenv("THUNDER_SPLIT", "force")
    phantom, imgs, _, _ = dataset()
    topt = to.Optimiser(config(TConfig, SIZE), imgs, ctf_cols(N), np.zeros(N, np.int64),
                        init_refs=phantom, device="cpu")
    topt.model.search_type = SEARCH_TYPE_LOCAL
    topt.model.r = R_PHASE
    par = topt.state.par
    q_top = par.r[:, :, 0].numpy()
    topt.state.par = par._replace(r=torch.as_tensor(
        clouds(q_top, routed_angles(topt.n_img_all), par.r.shape[2])))
    shapes = [a.shape for a in topt.state.par]
    rec = topt.run_round(0)
    assert "+route[" in rec["proj_table"], rec.get("proj_table")
    assert [a.shape for a in topt.state.par] == shapes
    for leaf in topt.state.par:
        assert torch.isfinite(leaf).all()
    assert np.isfinite(rec["res_A"])


def test_routing_on_several_ranks(pair, monkeypatch):
    """Routing works on several ranks, as thunder_tpu's on its mesh: the
    bounds are over every rank's images, so on a layout of several ranks
    they are the one rank's, (16, 24, 28, 32), and the plan routes
    (tests/test_torch_routed_ranks.py runs it on gloo ranks)."""
    from types import SimpleNamespace

    monkeypatch.setenv("THUNDER_SPLIT", "force")
    topt = pair[1]
    assert topt._route_bounds() == (16, 24, 28, 32)
    ranks = SimpleNamespace(layout=SimpleNamespace(world=2), n_img_all=topt.n_img_all)
    assert to.Optimiser._route_bounds(ranks) == (16, 24, 28, 32)
    set_clouds(pair, routed_angles(topt.n_img_all))
    monkeypatch.setattr(topt, "_route_bounds", lambda: to.Optimiser._route_bounds(ranks))
    rung, order, segs = topt._table_plan(R_PHASE)
    assert order is not None and len(segs) > 1 and rung is not None, (rung, segs)


def main(argv=None) -> int:
    """What the plan changes in both packages: tight_pair's rounds with
    the plan and with THUNDER_BRICK=off, each round's phases, FSC-0.143
    shell and table, and the alignment error at the end.

        JAX_PLATFORMS=cpu python tests/test_torch_table_plan.py --seeds 3 --rounds 3
    """
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    for seed in range(args.seeds):
        for mode in ("plan", "off"):
            if mode == "off":
                os.environ["THUNDER_BRICK"] = "off"
            try:
                jopt, topt, true_q = tight_pair(seed)
                for name, opt in (("thunder_tpu", jopt), ("port", topt)):
                    recs = [opt.run_round(i) for i in range(args.rounds)]
                    print(f"seed {seed} {mode:4s} {name:11s} phases "
                          f"{[r['n_phases'] for r in recs]} (sum "
                          f"{sum(sum(r['n_phases']) for r in recs)}) shells "
                          f"{[r['res_shell'] for r in recs]} tables "
                          f"{[r.get('proj_table', '-') for r in recs]} alignment "
                          f"{truth_error_deg(opt, true_q):.2f} deg", flush=True)
            finally:
                os.environ.pop("THUNDER_BRICK", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
