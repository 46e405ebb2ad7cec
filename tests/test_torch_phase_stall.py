"""Where round 0 of run_parity's case c (tests/goldens/run_parity/c.json)
parts from thunder_tpu: the phase loop's stall rule on hemisphere 1.

The loop stops a hemisphere once no hemisphere mean of k1, s0, s1 (and
s_d) has fallen below 0.95 times its value a phase before
(PARTICLE_FILTER_DECREASE_FACTOR, N_PHASE_WITH_NO_VARI_DECREASE 1).  k1
is each image's ACG fit of its rotation cloud (Tyler's fixed point,
DirectionalStat.cpp:93-145).  Where resampling collapses a cloud onto a
few distinct quaternions (the largest share of one point at or above a
quarter: Tyler's condition fails), the fit has no maximum and the
iteration returns a value set by rounding; one such image moves the
hemisphere mean by orders of magnitude, and that decides the stop.

The tests take thunder_tpu's round 0 on case c's files, its particle
state, draws and perturbed clouds at each phase of hemisphere 1, and
hold the port's phase step to it: the likelihood marginals, the
resampled clouds and s0, s1 at rounding level, k1 in float64 on every
cloud that has a fit; and they show that thunder_tpu's own stall
decision flips when its clouds move by one ulp (ROADMAP Q3).

    JAX_PLATFORMS=cpu python tests/test_torch_phase_stall.py

prints the phases, statistics and decisions of both packages' round 0
and the one-ulp probe (~1 min).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu import particle as jpt  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch import particle as tpt  # noqa: E402
from thunder_tpu_torch.micro import run_parity as rp  # noqa: E402

FIELDS = jpt.ParticleState._fields
N_ULP = 20   # one-ulp moves of the clouds a phase


class _Stop(Exception):
    pass


def jax_optimiser(cfg_path: str):
    """thunder_tpu's Optimiser on a config as its CLI builds it (the .thu
    shuffled by the seed, the start model, resumed from the .thu)."""
    from thunder_tpu.config import ThunderConfig
    from thunder_tpu.io.loader import load_images
    from thunder_tpu.io.mrc import read_mrc
    from thunder_tpu.io.thu import read_thu
    from thunder_tpu.physics.ctf import ctf_params

    cfg = ThunderConfig.from_json(cfg_path)
    cfg.reco_kernel = "mkb"
    thu = read_thu(cfg.db)
    thu = thu.select(np.random.default_rng(cfg.seed).permutation(len(thu)))
    ctf = ctf_params(thu.voltage, thu.defocus_u, thu.defocus_v, thu.defocus_theta, thu.cs,
                     thu.amplitude_contrast, thu.phase_shift)
    return jo.Optimiser(cfg, load_images(thu, cfg.par_prefix), ctf, thu.group_id - 1,
                        init_refs=read_mrc(cfg.init_model)[0], resume_thu=thu)


def port_optimiser(cfg_path: str):
    from thunder_tpu_torch.cli.thunder import build_optimiser
    from thunder_tpu_torch.config import ThunderConfig

    cfg = ThunderConfig.from_json(cfg_path)
    cfg.reco_kernel = "mkb"
    return build_optimiser(cfg, "cpu")[0]


def thunder_tpu_round0(jopt) -> tuple:
    """thunder_tpu's round 0 up to the end of its phase loop: (phase
    counts, one record a phase in loop order: its key, the state before,
    the perturbed state, the likelihood marginals, the state after and
    the stall statistics), read from inside the compiled loop."""
    recs, counts = [], []
    grab = lambda tag: lambda *a: recs.append((tag, [np.asarray(x) for x in a]))
    loop, perturb_t, clip_u_r = jo._adaptive_phase_loop, jpt.perturb_t, jpt.clip_u_r
    phases = type(jopt).local_phases

    def loop_(key, par, body_fn, min_phase, max_phase, init=None):
        def body(sub, p):
            jax.debug.callback(grab("before"), sub, *p)
            p2, v = body_fn(sub, p)
            jax.debug.callback(grab("after"), *p2, *v)
            return p2, v
        return loop(key, par, body, min_phase, max_phase, init)

    def perturb_t_(key, state, *a):
        out = perturb_t(key, state, *a)
        jax.debug.callback(grab("perturbed"), *out)
        return out

    def clip_u_r_(state, mode):
        jax.debug.callback(grab("marginals"), state.u_r, state.u_t)
        return clip_u_r(state, mode)

    def local_phases(self, rings):
        counts.extend(int(n) for n in np.asarray(phases(self, rings)))
        raise _Stop

    jo._adaptive_phase_loop, jpt.perturb_t, jpt.clip_u_r = loop_, perturb_t_, clip_u_r_
    type(jopt).local_phases = local_phases
    jax.clear_caches()
    try:
        jopt.run_round(0)
    except _Stop:
        pass
    finally:
        jo._adaptive_phase_loop, jpt.perturb_t, jpt.clip_u_r = loop, perturb_t, clip_u_r
        type(jopt).local_phases = phases
        jax.clear_caches()
    assert len(recs) == 4 * sum(counts), (len(recs), counts)
    out = []
    for i in range(0, len(recs), 4):
        (t0, before), (t1, pert), (t2, marg), (t3, after) = recs[i:i + 4]
        assert (t0, t1, t2, t3) == ("before", "perturbed", "marginals", "after")
        n = len(FIELDS)
        out.append(dict(key=before[0], before=dict(zip(FIELDS, before[1:])),
                        perturbed=dict(zip(FIELDS, pert)), u_r=marg[0], u_t=marg[1],
                        after=dict(zip(FIELDS, after[:n])), vari=np.array(after[n:])))
    hemis = [0] * counts[0] + [1] * counts[1]
    for rec, h in zip(out, hemis):
        rec["hemi"] = h
    return counts, out


def decisions(varis: list) -> list:
    """The stall rule's 'decreased' a phase of one hemisphere's run."""
    f = to.PARTICLE_FILTER_DECREASE_FACTOR
    prev = [float(np.finfo(np.float32).max)] * 4
    out = []
    for v in varis:
        out.append(any(float(a) < float(np.float32(b * f)) for a, b in zip(v, prev)))
        prev = [float(x) for x in v]
    return out


def fit_exists(r: np.ndarray) -> np.ndarray:
    """Clouds (L, n, 4) whose ACG fit has a maximum by the quarter test
    of Tyler's condition: no quaternion holds a quarter of the cloud or
    more, and at least five distinct ones (the other subspaces' shares
    are not tested)."""
    ok = []
    for cloud in r:
        _, cnt = np.unique(cloud, axis=0, return_counts=True)
        ok.append(cnt.size >= 5 and cnt.max() < cloud.shape[0] / 4)
    return np.array(ok)


def jax_k1(r: np.ndarray, dtype) -> np.ndarray:
    """thunder_tpu's cal_vari_r k1 of clouds (L, n, 4) in ``dtype``."""
    import jax.numpy as jnp

    with jax.enable_x64(dtype == np.float64):
        return np.asarray(_jax_k1(jnp.asarray(r.astype(dtype))))


def _jax_k1_one(r):
    import jax.numpy as jnp

    from thunder_tpu.geometry.directional import infer_acg_k123, infer_acg_mean
    from thunder_tpu.geometry.quaternion import quat_conj, quat_mul

    mean = infer_acg_mean(r)
    k1 = infer_acg_k123(quat_mul(jnp.broadcast_to(quat_conj(mean), r.shape), r))[0]
    return jnp.maximum(k1, tpt.MIN_K_R)


_jax_k1 = jax.jit(jax.vmap(_jax_k1_one))


def port_k1(r: np.ndarray, dtype) -> np.ndarray:
    from thunder_tpu_torch.geometry.directional import infer_acg_k123, infer_acg_mean
    from thunder_tpu_torch.geometry.quaternion import quat_conj, quat_mul

    q = torch.as_tensor(r.astype(dtype))
    mean = infer_acg_mean(q)
    k1 = infer_acg_k123(quat_mul(quat_conj(mean)[..., None, :].expand_as(q), q))[0]
    return torch.clamp(k1, min=tpt.MIN_K_R).numpy()


class Replay:
    """The port's draws replaced by given tensors, in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def draw(self, kind, shape, high=None):
        want, x = self.draws.pop(0)
        assert want == kind and tuple(x.shape) == tuple(shape), (want, kind, x.shape, shape)
        return x


def port_phase(topt, inputs: tuple, rec: dict, monkeypatch, marginals: bool = False):
    """The port's phase step on hemisphere rec["hemi"] from thunder_tpu's
    state before the phase, with thunder_tpu's perturbed clouds in place
    of its perturbation, thunder_tpu's resampling uniforms and, with
    ``marginals``, thunder_tpu's likelihood marginals in place of its
    own; returns (u_r, u_t before clipping, the state after, the stall
    statistics)."""
    import jax.numpy as jnp

    h = rec["hemi"]
    one = lambda d: tpt.ParticleState(*[torch.as_tensor(np.array(d[f]))[None] for f in FIELDS])
    pert = one(rec["perturbed"])
    monkeypatch.setattr(tpt, "perturb_r", lambda gen, s, pf, mode=3: s._replace(
        r=pert.r, w_r=pert.w_r))
    monkeypatch.setattr(tpt, "perturb_t", lambda gen, s, pf, trans_s: s._replace(
        t=pert.t, w_t=pert.w_t))
    if marginals:
        monkeypatch.setattr(to, "local_marginals", lambda *a: (
            torch.as_tensor(np.array(rec["u_r"])), torch.as_tensor(np.array(rec["u_t"]))))
    seen = {}
    clip = tpt.clip_u_r

    def clip_u_r(s, mode=3):
        seen["u_r"], seen["u_t"] = s.u_r[0].numpy().copy(), s.u_t[0].numpy().copy()
        return clip(s, mode)

    monkeypatch.setattr(tpt, "clip_u_r", clip_u_r)
    _, _, krs, kts = jax.random.split(jnp.asarray(rec["key"]), 4)
    n_l = pert.r.shape[1]
    uni = lambda k: torch.as_tensor(np.array(jax.random.uniform(k, (n_l, 1))))[None]
    topt.draws = Replay([("rand", uni(krs)), ("rand", uni(kts))])
    rings, table, dat_w, sctf2, a_term, pf_small = inputs
    par, vari = topt.phase_step(one(rec["before"]), [h], rings, table, dat_w, sctf2, a_term,
                                pf_small, None)
    monkeypatch.undo()
    return seen["u_r"], seen["u_t"], par, vari[0].numpy()


@pytest.fixture(scope="module")
def round0(tmp_path_factory):
    """Case c's files; thunder_tpu's round-0 phase records on them; the
    port's Optimiser and its phase inputs on the same files."""
    tmp = str(tmp_path_factory.mktemp("case_c"))
    cfg_path = rp.write_case("c", tmp, 1)
    counts, recs = thunder_tpu_round0(jax_optimiser(cfg_path))
    topt = port_optimiser(cfg_path)
    rings = topt._rings()
    inputs = (rings, topt.proj_table(rings.r_u), *topt._pack_inputs(rings),
              float(topt.cfg.perturb_factor_s_local))
    return counts, recs, topt, inputs


def hemi1(recs) -> list:
    return [r for r in recs if r["hemi"] == 1]


def test_thunder_tpu_round0_runs_its_local_phase_loop(round0):
    """thunder_tpu's round 0 of case c: local search, the records of each
    phase read back in loop order, statistics as its loop read them."""
    counts, recs, _, _ = round0
    assert len(counts) == 2 and min(counts) >= 3 and max(counts) <= 10
    for rec in recs:
        after = rec["after"]
        np.testing.assert_allclose(rec["vari"][:3], [after["k1"].mean(), after["s0"].mean(),
                                                     after["s1"].mean()], rtol=1e-5)


def log_ratio(a: np.ndarray, b: np.ndarray) -> float:
    """The largest |log(a / b)| over the cells of b above 1e-3 of its
    row's largest."""
    big = b > 1e-3 * b.max(axis=-1, keepdims=True)
    return float(np.abs(np.log(np.maximum(a, 1e-30) / b))[big].max())


def test_port_likelihood_on_thunder_tpus_clouds(round0, monkeypatch):
    """Each phase of hemisphere 1 from thunder_tpu's state and perturbed
    clouds: the port's likelihood marginals u_r and u_t (projection,
    log-likelihood, the exponent over rotations and translations) within
    2 % of thunder_tpu's.  Both packages sum each image's log-likelihood
    over its pixels in float32; the rounding of those sums reaches a few
    thousandths in the exponent (largest 0.008 on case c, Intel Xeon)."""
    _, recs, topt, inputs = round0
    for i, rec in enumerate(hemi1(recs)):
        u_r, u_t, _, _ = port_phase(topt, inputs, rec, monkeypatch)
        assert log_ratio(u_r, rec["u_r"]) < 0.02, f"phase {i + 1}"
        assert log_ratio(u_t, rec["u_t"]) < 0.02, f"phase {i + 1}"


def test_port_phase_on_thunder_tpus_marginals(round0, monkeypatch):
    """Each phase of hemisphere 1 from thunder_tpu's state, perturbed
    clouds, uniforms and likelihood marginals: the port's clipped and
    resampled clouds are thunder_tpu's, bit for bit, s0 and s1 its
    within 1e-6, and k1 in float64 thunder_tpu's in float64 within 1e-9
    on every cloud that has a fit.  (Its own marginals, within rounding
    of thunder_tpu's, resample other support points: systematic
    resampling moves a point across a step of the cdf for a change of a
    thousandth.)"""
    _, recs, topt, inputs = round0
    for i, rec in enumerate(hemi1(recs)):
        _, _, par, vari = port_phase(topt, inputs, rec, monkeypatch, marginals=True)
        after = rec["after"]
        np.testing.assert_array_equal(par.r[0].numpy(), after["r"], err_msg=f"phase {i + 1}")
        np.testing.assert_array_equal(par.t[0].numpy(), after["t"], err_msg=f"phase {i + 1}")
        np.testing.assert_allclose(vari[1:3], rec["vari"][1:3], rtol=1e-6)
        fit = fit_exists(after["r"])
        k64_p, k64_j = port_k1(after["r"], np.float64), jax_k1(after["r"], np.float64)
        np.testing.assert_allclose(k64_p[fit], k64_j[fit], rtol=1e-9)


def test_the_stall_statistic_reads_clouds_without_a_fit(round0):
    """In hemisphere 1 some phase's mean k1 is set by clouds without an
    ACG fit: on them thunder_tpu's own float32 k1 as its loop read it,
    thunder_tpu's k1 evaluated alone and both packages' float64 k1
    disagree by more than the stall rule's 5 %, while on the clouds with
    a fit the float64 values agree."""
    _, recs, _, _ = round0
    found = False
    for rec in hemi1(recs):
        r = rec["after"]["r"]
        fit = fit_exists(r)
        if fit.all():
            continue
        means = [rec["after"]["k1"].mean(), jax_k1(r, np.float32).mean(),
                 jax_k1(r, np.float64).mean(), port_k1(r, np.float64).mean()]
        found = found or max(means) > min(means) / to.PARTICLE_FILTER_DECREASE_FACTOR
    assert found


def one_ulp(r: np.ndarray, seed: int) -> np.ndarray:
    up = np.random.default_rng(seed).random(r.shape) < 0.5
    return np.where(up, np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf)))


def ulp_decisions(recs: list, h: int) -> list:
    """For each phase of hemisphere h from the third on (where a stall
    counts): the stall decision as thunder_tpu's loop took it; the one
    its float32 k1 evaluated alone gives on the same clouds (the
    baseline of the moves); and the ones it gives when every component
    of its resampled clouds moves by one ulp, N_ULP seeds.  The other
    statistics, and the previous phase's, as its loop read them."""
    runs = [r for r in recs if r["hemi"] == h]
    out = []
    for i in range(2, len(runs)):
        prev, rec = runs[i - 1]["vari"], runs[i]["vari"]
        r = runs[i]["after"]["r"]
        alone = decisions([prev, [jax_k1(r, np.float32).mean(), *rec[1:]]])[1]
        got = []
        for seed in range(N_ULP):
            k1 = jax_k1(one_ulp(r, seed + 1), np.float32).mean()
            got.append(decisions([prev, [k1, *rec[1:]]])[1])
        out.append((i + 1, decisions([prev, rec])[1], alone, got))
    return out


def test_thunder_tpus_stall_decision_flips_under_one_ulp(round0):
    """thunder_tpu's own phase count is chance at rounding level: at some
    phase of round 0 its stall decision (and so its phase count) flips
    when its rotation clouds move by one ulp."""
    _, recs, _, _ = round0
    flips = [(phase, got) for h in (0, 1) for phase, _, _, got in ulp_decisions(recs, h)
             if len(set(got)) > 1]
    assert flips


def main() -> int:
    import tempfile

    with tempfile.TemporaryDirectory(prefix="phase_stall_") as tmp:
        cfg_path = rp.write_case("c", tmp, 1)
        counts, recs = thunder_tpu_round0(jax_optimiser(cfg_path))
        print(f"thunder_tpu round 0 phases {counts}")
        for h in (0, 1):
            runs = [r for r in recs if r["hemi"] == h]
            dec = decisions([r["vari"] for r in runs])
            for i, (rec, d) in enumerate(zip(runs, dec)):
                r = rec["after"]["r"]
                fit = fit_exists(r)
                k64 = jax_k1(r, np.float64)
                print(f"  hemisphere {h} phase {i + 1}: k1 s0 s1 {np.round(rec['vari'][:3], 6)} "
                      f"decreased {d}; clouds without a fit {int((~fit).sum())}, "
                      f"k1 mean alone {jax_k1(r, np.float32).mean():.6g}, float64 "
                      f"{k64.mean():.6g} (with a fit {k64[fit].mean():.6g}), port float64 "
                      f"{port_k1(r, np.float64).mean():.6g}")
            for phase, d, alone, got in ulp_decisions(recs, h):
                print(f"  hemisphere {h} phase {phase}: decreased {d} in the loop, {alone} "
                      f"with k1 evaluated alone; under one-ulp moves {sum(got)} of {len(got)} "
                      f"decreased, {sum(g != alone for g in got)} differ from the decision "
                      f"alone")
    return 0


if __name__ == "__main__":
    sys.exit(main())
