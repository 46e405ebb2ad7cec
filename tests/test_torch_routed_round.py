"""Routed rounds of the port (optimiser._phases_routed, phase_step over
(hemisphere, segment) groups, project_phase rung by rung) held to
thunder_tpu's run_routed on the same state.

Both packages start from thunder_tpu's particle state with clouds of
three widths (tests/test_torch_table_plan.py routed_angles, 64 images of
32 px at r 14) under THUNDER_SPLIT=force, with chunk boundaries on: at
32 px no table reaches the 24 MB past which the drivers stop at
boundaries, so the test lowers that size in both (thunder_tpu's driver
compares a literal, so the crop its driver reads is raised instead).

* Whole rounds replayed, local and CTF search: the port's phase loop
  is given thunder_tpu's perturbed clouds (and defocus), marginals,
  resampling uniforms and k1 (rounding on these clouds) of every
  (hemisphere, segment) group and phase; its clouds stay thunder_tpu's
  bit for bit, at the first boundary each group's phase, stall count
  and statistics are thunder_tpu's, and so are the merges, the plan at
  every boundary and the phase counts; its own marginals of the same
  clouds, from its table rounded to bf16 as thunder_tpu's, are
  thunder_tpu's within 1e-3.
* Whole routed rounds, local and CTF search, SEEDS seeds in each
  package: the same plan at the round's start and at every boundary
  both reach, each seed's FSC-0.143 shells within one, and the mean
  phase count within three standard errors of thunder_tpu's (a seed's
  count is chance: tests/test_torch_phase_stall.py, one ulp flips a
  stall decision).
* On one rank a round whose groups are the two hemispheres (one
  segment each) gives the whole-batch driver's bits.

    JAX_PLATFORMS=cpu python tests/test_torch_routed_round.py --seeds 8

prints both packages' phase counts, routed and not.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu import particle as jpt  # noqa: E402
from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.model import SEARCH_TYPE_CTF, SEARCH_TYPE_LOCAL  # noqa: E402
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu_torch import interop  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch import particle as tpt  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402

import test_torch_table_plan as tp  # noqa: E402
from test_torch_phase_stall import (FIELDS, Replay, fit_exists, jax_k1, log_ratio,  # noqa: E402
                                    port_k1)

SEEDS = 3


class _Stop(Exception):
    pass


def force_chunking(monkeypatch):
    """Chunk boundaries at 32 px in both drivers (see the module's
    docstring)."""
    real = jo._proj_crop_size

    def crop(size, pf, r_u):
        if sys._getframe(1).f_code.co_name == "local_phases":
            return 120      # 120^3 x 16 bytes, past the 24 MB
        return real(size, pf, r_u)

    monkeypatch.setattr(jo, "_proj_crop_size", crop)
    monkeypatch.setattr(to, "PLAN_TABLE_MIN_BYTES", 0)


def make_pair(ctf: bool = False, seed: int = 0):
    """Both packages' Optimisers on tp.dataset(), the port seeded with
    ``seed`` and thunder_tpu keyed with it, the port holding
    thunder_tpu's state with routed_angles' clouds at r 14, in local
    (or CTF) search.  Returns (jopt, topt, snapshot of the state)."""
    phantom, imgs, _, _ = tp.dataset()
    jopt = jo.Optimiser(tp.config(JConfig, tp.SIZE, c_search=ctf), imgs,
                        jctf_params(*tp.ctf_cols(tp.N)), np.zeros(tp.N, np.int64),
                        init_refs=phantom)
    topt = to.Optimiser(tp.config(TConfig, tp.SIZE, c_search=ctf), imgs, tp.ctf_cols(tp.N),
                        np.zeros(tp.N, np.int64), init_refs=phantom, device="cpu", seed=seed)
    jopt.key = jax.random.PRNGKey(seed)
    tp.set_clouds((jopt, topt), tp.routed_angles(topt.n_img_all))
    for opt in (jopt, topt):
        opt.model.search_type = SEARCH_TYPE_CTF if ctf else SEARCH_TYPE_LOCAL
    return jopt, topt, interop.snapshot(jopt)


def thunder_tpu_round(jopt, ctf: bool = False) -> tuple:
    """thunder_tpu's round 0 with every call of its per-segment loop
    recorded: (the round's record, the plans in order (start, then each
    boundary) as (rung, order, segs), the calls in order, each with its
    image count, the stall state it started from and returned, and per
    hemisphere one record a phase: its key, the state before, the
    perturbed state, the marginals, the state after, the statistics)."""
    recs, calls, plans = [], [], []
    grab = lambda tag: lambda *a: recs.append((tag, [np.asarray(x) for x in a]))
    # the last perturbation of a phase: of the defocus in CTF search
    last = "perturb_d" if ctf else "perturb_t"
    loop, perturb, clip_u_r = jo._adaptive_phase_loop, getattr(jpt, last), jpt.clip_u_r
    loop_h = jo._phase_loop_ctf_h if ctf else jo._phase_loop_h
    plan = jopt._table_plan

    def loop_(key, par, body_fn, min_phase, max_phase, init=None):
        def body(sub, p):
            jax.debug.callback(grab("before"), sub, *p)
            p2, v = body_fn(sub, p)
            jax.debug.callback(grab("after"), *p2, *v)
            return p2, v
        return loop(key, par, body, min_phase, max_phase, init)

    def perturb_(key, state, *a):
        out = perturb(key, state, *a)
        jax.debug.callback(grab("perturbed"), *out)
        return out

    def clip_u_r_(state, mode):
        jax.debug.callback(grab("marginals"), state.u_r, state.u_t, state.u_d)
        return clip_u_r(state, mode)

    def loop_h_(*a, **kw):
        out = loop_h(*a, **kw)
        init = a[14] if ctf else a[11]
        calls.append(dict(n=int(a[1].r.shape[1]), init=[np.asarray(x) for x in init],
                          out=[np.asarray(x) for x in out[1:]]))
        return out

    def table_plan(*a, **kw):
        out = plan(*a, **kw)
        plans.append((out[0], None if out[1] is None else np.asarray(out[1]), tuple(out[2])))
        return out

    jo._adaptive_phase_loop, jpt.clip_u_r = loop_, clip_u_r_
    setattr(jpt, last, perturb_)
    setattr(jo, "_phase_loop_ctf_h" if ctf else "_phase_loop_h", loop_h_)
    jopt._table_plan = table_plan
    jax.clear_caches()
    try:
        rec = jopt.run_round(0)
    finally:
        jo._adaptive_phase_loop, jpt.clip_u_r = loop, clip_u_r
        setattr(jpt, last, perturb)
        setattr(jo, "_phase_loop_ctf_h" if ctf else "_phase_loop_h", loop_h)
        del jopt._table_plan
        jax.clear_caches()
    i, n_f = 0, len(FIELDS)
    for c in calls:
        c["phases"] = [[], []]
        for h in (0, 1):
            for _ in range(int(c["out"][0][h] - c["init"][0][h])):
                (t0, before), (t1, pert), (t2, marg), (t3, after) = recs[i:i + 4]
                assert (t0, t1, t2, t3) == ("before", "perturbed", "marginals", "after")
                c["phases"][h].append(dict(
                    key=before[0], before=dict(zip(FIELDS, before[1:])),
                    perturbed=dict(zip(FIELDS, pert)), u_r=marg[0], u_t=marg[1], u_d=marg[2],
                    after=dict(zip(FIELDS, after[:n_f])), vari=np.array(after[n_f:])))
                i += 4
    assert i == len(recs), (i, len(recs))
    return rec, plans, calls


def chunks(plans: list, calls: list, n_l: int) -> list:
    """thunder_tpu's chunks: [(plan, its calls, its segments as (count,
    rung) and order)], a whole-batch chunk as one segment of every image
    in order."""
    out, i = [], 0
    for plan in plans:
        routed = plan[1] is not None
        segs = plan[2] if routed else ((n_l, plan[0]),)
        order = plan[1] if routed else np.tile(np.arange(n_l), (2, 1))
        out.append((plan, calls[i:i + len(segs)], segs, order))
        i += len(segs)
    assert i == len(calls), (i, len(calls))
    return out


def by_image(chunk_list: list, n_l: int, ctf: bool = False) -> dict:
    """thunder_tpu's phases by (flat image h L + i, phase): what the
    port's phase step is handed for that image (perturbed clouds,
    marginals, the resampling uniforms, k1) and what thunder_tpu's
    state was before and after."""
    out = {}
    for _, calls, segs, order in chunk_list:
        lo = 0
        for (n, _), c in zip(segs, calls):
            assert c["n"] == n
            for h in (0, 1):
                for j, ph in enumerate(c["phases"][h]):
                    keys = jax.random.split(jnp.asarray(ph["key"]), 6 if ctf else 4)
                    u_r, u_t, u_d = (np.asarray(jax.random.uniform(k, (n, 1)))
                                     for k in (keys[-3:] if ctf else (*keys[2:], keys[3])))
                    fit = fit_exists(ph["after"]["r"])
                    for m, img in enumerate(order[h, lo:lo + n]):
                        pick = lambda d: {f: d[f][m] for f in FIELDS}
                        out[(h * n_l + int(img), int(c["init"][0][h]) + j)] = dict(
                            before=pick(ph["before"]), perturbed=pick(ph["perturbed"]),
                            after=pick(ph["after"]), u_r=ph["u_r"][m], u_t=ph["u_t"][m],
                            u_d=ph["u_d"][m], uni_r=u_r[m], uni_t=u_t[m], uni_d=u_d[m],
                            fit=bool(fit[m]))
            lo += n
    return out


def same_state(par, rows: list, key: str) -> None:
    """The port's clouds (B, n, ...) against thunder_tpu's of the same
    images: r, t and d bit for bit, their weights and s0, s1, s_d within 1e-6
    (the weights are normalised sums)."""
    want = lambda f: np.stack([r[key][f] for r in rows])
    got = lambda f: getattr(par, f).reshape((len(rows),) + getattr(par, f).shape[2:]).numpy()
    for f in ("r", "t", "d"):
        np.testing.assert_array_equal(got(f), want(f), err_msg=f)
    for f in ("w_r", "w_t", "w_d", "s0", "s1", "s_d"):
        np.testing.assert_allclose(got(f), want(f), rtol=1e-6, atol=1e-12, err_msg=f)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """A float32 (or complex64) table rounded to bfloat16 and back."""
    r = lambda x: x.to(torch.bfloat16).to(torch.float32)
    return torch.complex(r(t.real), r(t.imag)) if t.is_complex() else r(t)


def port_replay(topt, snap, j_plans: list, data: dict, monkeypatch) -> dict:
    """The port's phase loop (local_phases) from ``snap`` on thunder_tpu's
    plans, each phase handed thunder_tpu's perturbed clouds, marginals,
    uniforms and k1 of its images (``data``; k1 of a cloud without an
    ACG fit is rounding in both packages, tests/test_torch_phase_stall.py).
    Returns the groups' states as each merge read them, the merged
    states, the port's own plan at each boundary, the phase counts, the
    k1 pairs (the port's own, thunder_tpu's) of clouds with a fit and,
    a phase and marginal, how far the port's own marginals of the same
    clouds lie from thunder_tpu's (tests/test_torch_phase_stall.py
    log_ratio)."""
    interop.restore(topt, snap)
    topt._round_brick, topt._round_order, topt._round_segs = j_plans[0]
    # thunder_tpu projects from bf16 tables (ops/projector.py ri_split):
    # the port's table rounded alike, so that marginals compare at float32
    table = topt.proj_table
    monkeypatch.setattr(topt, "proj_table", lambda r_u: bf16(table(r_u)))
    seen = dict(groups=[], merged=[], plans=[], k1=[], marginals=[])
    count = {}
    step, merge = topt.phase_step, to.merge_segment_states
    own = dict(local=to.local_marginals, ctf=to.likelihood_local_ctf)
    table_plan, cal_vari_r = topt._table_plan, tpt.cal_vari_r
    n_l = topt.n_img

    def phase_step(par, hemis, *a, sel=None, **kw):
        idx = (sel.tolist() if sel is not None else
               [h * n_l + i for h in hemis for i in range(n_l)])
        rows = []
        for i in idx:
            rows.append(data[(i, count.get(i, 0))])
            count[i] = count.get(i, 0) + 1
        same_state(par, rows, "before")
        like = lambda key, f: torch.as_tensor(np.stack([r[key][f] for r in rows])).reshape(
            getattr(par, f).shape)
        monkeypatch.setattr(tpt, "perturb_r", lambda gen, s, pf, mode=3: s._replace(
            r=like("perturbed", "r"), w_r=like("perturbed", "w_r")))
        monkeypatch.setattr(tpt, "perturb_t", lambda gen, s, pf, trans_s: s._replace(
            t=like("perturbed", "t"), w_t=like("perturbed", "w_t")))
        monkeypatch.setattr(tpt, "perturb_d", lambda gen, s, pf: s._replace(
            d=like("perturbed", "d"), w_d=like("perturbed", "w_d")))
        names = ("u_r", "u_t", "u_d")

        def marginals(kind):
            """The port's own marginals of thunder_tpu's perturbed clouds,
            kept beside thunder_tpu's, which the phase goes on with."""
            def f(*x):
                for k, u in zip(names, own[kind](*x)):
                    seen["marginals"].append(log_ratio(u.numpy(), np.stack([r[k] for r in rows])))
                return tuple(torch.as_tensor(np.stack([r[k] for r in rows]))
                             for k in names[:3 if kind == "ctf" else 2])
            return f

        monkeypatch.setattr(to, "local_marginals", marginals("local"))
        monkeypatch.setattr(to, "likelihood_local_ctf", marginals("ctf"))

        def k1_of_thunder_tpu(s, mode=3):
            s = cal_vari_r(s, mode)
            fit = np.array([r["fit"] for r in rows])
            k1 = np.stack([r["after"]["k1"] for r in rows])
            seen["k1"].append((s.k1.reshape(-1).numpy()[fit], k1[fit]))
            return s._replace(k1=torch.as_tensor(k1).reshape(s.k1.shape))

        monkeypatch.setattr(tpt, "cal_vari_r", k1_of_thunder_tpu)
        uni = lambda k: torch.as_tensor(np.stack([r[k] for r in rows])).reshape(
            par.r.shape[:2] + (1,))
        topt.draws = Replay([("rand", uni(k)) for k in ("uni_r", "uni_t", "uni_d")][
            :3 if a[-1] is not None else 2])
        out = step(par, hemis, *a, sel=sel, **kw)
        same_state(out[0], rows, "after")
        return out

    def merge_(states):
        seen["groups"].append([[s[0], s[1], list(s[2])] for s in states])
        out = merge(states)
        seen["merged"].append([out[0], out[1], list(out[2])])
        return out

    def boundary_plan(*a, **kw):
        seen["plans"].append(table_plan(*a, **kw))
        return j_plans[len(seen["plans"])]

    def init_d_round(gen, s, s_d):
        """thunder_tpu's scatter of the defocus support at a CTF round's
        start: its state before each image's first phase."""
        first = lambda f: torch.as_tensor(np.stack([
            data[(i, 0)]["before"][f] for i in range(2 * n_l)])).reshape(getattr(s, f).shape)
        return s._replace(d=first("d"), w_d=first("w_d"), u_d=first("u_d"), s_d=first("s_d"))

    monkeypatch.setattr(tpt, "init_d_round", init_d_round)
    monkeypatch.setattr(topt, "phase_step", phase_step)
    monkeypatch.setattr(to, "merge_segment_states", merge_)
    monkeypatch.setattr(topt, "_table_plan", boundary_plan)
    seen["phases"] = topt.local_phases(topt._rings())
    monkeypatch.undo()
    topt.draws = topt.gen
    return seen


@pytest.mark.parametrize("ctf", [False, True], ids=["local", "ctf"])
def test_routed_round_replayed_on_thunder_tpus_draws(monkeypatch, ctf):
    """The port's phase loop replays thunder_tpu's routed local (CTF)
    round (THUNDER_SPLIT=force, chunk 2, boundaries on) given its
    perturbed clouds and defocus, marginals, uniforms, its CTF round's
    defocus scatter and k1: the clouds stay thunder_tpu's bit
    for bit at every phase of every group; at the first boundary each
    group's phase and stall count are thunder_tpu's and its s0, s1
    within 1e-6 (k1 is thunder_tpu's); the merged states are
    run_routed's merge of thunder_tpu's segment states; the port's own
    plan at every boundary is thunder_tpu's; and the round ends at
    thunder_tpu's phase counts.  The port's own likelihood marginals of
    thunder_tpu's perturbed clouds, each group's images gathered and
    projected rung by rung (HK13's twin, HK1's) from the port's table
    rounded to bf16 as thunder_tpu's tables are, lie within 1e-3 of
    thunder_tpu's (log_ratio; 1e-4 to 2.5e-4 here, the float32 sums'
    rounding; from the float32 table, 2-8 %).  k1 of the same clouds is held in
    float64 within 1e-5 where they have an ACG fit (as
    tests/test_torch_phase_stall.py holds it); the replay prints how
    many have none, and how far apart the two loops' float32 k1 lie
    on those that have one (these clouds are tight: the fit is near
    singular in float32)."""
    monkeypatch.setenv("THUNDER_SPLIT", "force")
    force_chunking(monkeypatch)
    jopt, topt, snap = make_pair(ctf)
    j_rec, j_plans, calls = thunder_tpu_round(jopt, ctf)
    assert len(j_plans) >= 2 and j_plans[0][1] is not None, [p[2] for p in j_plans]
    chunk_list = chunks(j_plans, calls, topt.n_img)
    with monkeypatch.context() as m:
        seen = port_replay(topt, snap, j_plans, by_image(chunk_list, topt.n_img, ctf), m)
    assert list(seen["phases"]) == list(np.asarray(j_rec["n_phases"])), (seen["phases"], j_rec)
    # the first boundary: each (hemisphere, segment) group, then the merge
    first_calls = chunk_list[0][1]
    for h in (0, 1):
        outs = [c["out"] for c in first_calls]
        for (ph, nnd, prev), o in zip(seen["groups"][h], outs):
            assert (ph, nnd) == (int(o[0][h]), int(o[1][h])), (h, ph, nnd, o[0], o[1])
            np.testing.assert_allclose(prev, o[2][h], rtol=1e-6)
        assert seen["merged"][h][:2] == [max(int(o[0][h]) for o in outs),
                                         min(int(o[1][h]) for o in outs)]
        np.testing.assert_allclose(seen["merged"][h][2], np.max([o[2][h] for o in outs], 0),
                                   rtol=1e-6)
    for t, j in zip(seen["plans"], j_plans[1:]):
        assert (t[0], tuple(t[2])) == (j[0], j[2]), (t, j)
        if j[1] is not None:
            np.testing.assert_array_equal(t[1], j[1])
    assert len(seen["plans"]) == len(j_plans) - 1
    assert max(seen["marginals"]) < 1e-3, max(seen["marginals"])
    # k1: the same function of the same clouds in float64 where they have
    # a fit; these fits are near singular (k1 near its floor of 1e-5), and
    # the two evaluations part there by up to 1.4e-6 (case c's, 1e-9)
    after = np.concatenate([ph["after"]["r"] for c in calls for h in (0, 1)
                            for ph in c["phases"][h]])
    fit = fit_exists(after)
    np.testing.assert_allclose(port_k1(after[fit], np.float64), jax_k1(after[fit], np.float64),
                               rtol=1e-5)
    got = np.concatenate([a for a, _ in seen["k1"]])
    want = np.concatenate([b for _, b in seen["k1"]])
    print(f"replayed {len(calls)} loops, plans {[p[2] or p[0] for p in j_plans]}, phases "
          f"{seen['phases']}; marginals within {max(seen['marginals']):.3g}; clouds with an ACG fit {int(fit.sum())} of {len(fit)}; their "
          f"float32 k1 in the two loops up to {np.max(np.abs(got / want - 1)):.3g} apart")


def round_with_plans(opt) -> tuple:
    """One round of either package: (its record, its plans at the start
    and at each boundary as (rung, segs))."""
    plans, plan = [], opt._table_plan

    def table_plan(*a, **kw):
        out = plan(*a, **kw)
        plans.append((out[0], tuple(out[2])))
        return out

    opt._table_plan = table_plan
    try:
        rec = opt.run_round(0)
    finally:
        del opt._table_plan
    return rec, plans


@pytest.mark.parametrize("ctf", [False, True], ids=["local", "ctf"])
def test_routed_rounds_of_both_packages(monkeypatch, ctf):
    """A routed local (CTF) round in both packages from the same state,
    SEEDS seeds each (THUNDER_SPLIT=force, chunk 2, boundaries on): the
    same plan at the start and at every boundary both reach; each
    seed's FSC-0.143 shells within one; the phase counts' mean within
    three standard errors of thunder_tpu's (a seed's count is chance:
    its stall rule reads k1, rounding on these clouds, see
    test_routed_round_replayed_on_thunder_tpus_draws)."""
    monkeypatch.setenv("THUNDER_SPLIT", "force")
    force_chunking(monkeypatch)
    phases = {"jax": [], "port": []}
    for seed in range(SEEDS):
        jopt, topt, _ = make_pair(ctf, seed)
        (j_rec, j_plans), (t_rec, t_plans) = round_with_plans(jopt), round_with_plans(topt)
        assert j_plans[0][1] and len(j_plans[0][1]) > 1, j_plans[0]
        for j, t in zip(j_plans, t_plans):
            assert j == t, (seed, j_plans, t_plans)
        assert j_rec["proj_table"] == t_rec["proj_table"]
        assert abs(j_rec["res_shell"] - t_rec["res_shell"]) <= 1, (seed, j_rec, t_rec)
        for leaf in topt.state.par:
            assert torch.isfinite(leaf).all()
        phases["jax"].append(np.asarray(j_rec["n_phases"]))
        phases["port"].append(np.asarray(t_rec["n_phases"]))
        print(f"seed {seed}: thunder_tpu {j_rec['n_phases']} shell {j_rec['res_shell']} plans "
              f"{j_plans}; port {t_rec['n_phases']} shell {t_rec['res_shell']} plans {t_plans}")
    j, t = (np.concatenate(phases[k]).astype(float) for k in ("jax", "port"))
    err = np.sqrt(j.var(ddof=1) / j.size + t.var(ddof=1) / t.size)
    assert abs(t.mean() - j.mean()) <= 3 * err, (j, t, err)


@pytest.mark.parametrize("ctf", [False, True], ids=["local", "ctf"])
def test_one_group_a_hemisphere_gives_the_batch_bits(ctf):
    """On one rank the routed driver (_phases_routed) with one group a
    hemisphere, every image in order on the corner-row table, runs the
    phases of the whole-batch driver (_phases_batch) bit for bit: the
    same phase counts and the same particle state from the same seed."""
    phantom, imgs, _, _ = tp.dataset()
    outs = []
    for groups in (False, True):
        topt = to.Optimiser(tp.config(TConfig, tp.SIZE, c_search=ctf), imgs, tp.ctf_cols(tp.N),
                            np.zeros(tp.N, np.int64), init_refs=phantom, device="cpu", seed=5)
        topt.model.search_type = SEARCH_TYPE_CTF if ctf else SEARCH_TYPE_LOCAL
        topt.model.r = tp.R_PHASE
        n_l, par = topt.n_img, topt.state.par
        topt.state.par = par._replace(r=torch.as_tensor(tp.clouds(
            par.r[:, :, 0].numpy(), tp.routed_angles(n_l), par.r.shape[2])))
        topt._round_brick = None
        topt._round_order = np.tile(np.arange(n_l, dtype=np.int32), (2, 1)) if groups else None
        topt._round_segs = ((n_l, None),) if groups else ()
        outs.append((topt.local_phases(topt._rings()), topt.state.par))
    assert outs[0][0] == outs[1][0], (outs[0][0], outs[1][0])
    for f, a, b in zip(FIELDS, outs[0][1], outs[1][1]):
        assert torch.equal(a, b), f


def main(argv=None) -> int:
    """The phase counts of both packages' rounds from make_pair's state
    (boundaries on), routed (THUNDER_SPLIT=force) and not (0), local and
    CTF search, a round a seed:

        JAX_PLATFORMS=cpu python tests/test_torch_routed_round.py --seeds 8
    """
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    mp = pytest.MonkeyPatch()
    force_chunking(mp)
    for ctf in (False, True):
        for split in ("force", "0"):
            mp.setenv("THUNDER_SPLIT", split)
            counts = {"thunder_tpu": [], "port": []}
            for seed in range(args.seeds):
                jopt, topt, _ = make_pair(ctf, seed)
                for name, opt in (("thunder_tpu", jopt), ("port", topt)):
                    rec = opt.run_round(0)
                    counts[name].append(rec["n_phases"])
                    print(f"{'ctf' if ctf else 'local'} split {split} seed {seed} {name:11s} "
                          f"phases {rec['n_phases']} shell {rec['res_shell']} "
                          f"table {rec.get('proj_table')}", flush=True)
            for name, c in counts.items():
                c = np.asarray(c, float)
                print(f"{'ctf' if ctf else 'local'} split {split} {name:11s} phases a "
                      f"hemisphere: mean {c.mean():.3f}, sd {c.std(ddof=1):.3f}, "
                      f"{c.size} counts", flush=True)
    mp.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
