"""The port's model.py against thunder_tpu.model on the CPU: the
resolution / search-type state machine step by step, and the true FSC
given the same random phases.  Tolerances: the state machine is host
logic on the same floats, so every field must be equal; the true FSC
sums float32 spectra in another order, 1e-4 absolute on the curve."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu import model as jm  # noqa: E402
from thunder_tpu.physics.mask import soft_mask_weight as j_soft_mask  # noqa: E402
from thunder_tpu_torch import model as tm  # noqa: E402


def _fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m) if f.name != "fsc"}


@pytest.mark.parametrize("l_search,c_search", [(True, False), (True, True), (False, False)])
def test_state_machine_matches_jax(l_search, c_search):
    rng = np.random.default_rng(int(l_search) * 2 + int(c_search))
    kw = dict(n_class=2, size=64, pixel_size=1.5, r_init=8, r_global=14, max_r=30,
              l_search=l_search, c_search=c_search)
    a, b = jm.ModelState(**kw), tm.ModelState(**kw)
    s0 = s1 = 2.0
    for _ in range(40):
        # variances that stall as often as they shrink
        s0 *= rng.choice([1.0, 0.9, 1.01])
        s1 *= rng.choice([1.0, 0.9, 1.01])
        cross = rng.integers(3, 30, size=2)
        fsc = np.where(np.arange(30)[None, :] < cross[:, None], 0.9, 0.05)
        for m in (a, b):
            m.set_t_vari(s0, s1)
            m.set_fsc(fsc)
            m.update_res(0.143)
            m.update_r(0.143)
            m.update_search_type()
        assert _fields(a) == _fields(b)
        assert a.r_u == b.r_u
        assert a.res_angstrom(0.143) == b.res_angstrom(0.143)


def test_true_fsc_matches_jax_given_phases():
    size, n_shells = 16, 7
    rng = np.random.default_rng(0)
    a = rng.standard_normal((size,) * 3).astype(np.float32)
    b = (a + 0.7 * rng.standard_normal((size,) * 3)).astype(np.float32)
    m = np.array(j_soft_mask(size, 3, 5.0, 2.0), np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jm._true_fsc_dev(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m),
                                       key, n_shells))
    ka, kb = jax.random.split(key)
    phases = tuple(torch.as_tensor(np.array(
        jax.random.uniform(k, (size,) * 3, minval=0.0, maxval=2 * np.pi)))
        for k in (ka, kb))
    got = tm._true_fsc_dev(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(m),
                           None, n_shells, phases).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_optimiser_uses_true_fsc_when_configured(monkeypatch):
    """With 'Calculate FSC Using Core Region' on, the round's FSC is the
    true FSC of the MAP-free maps under the soft mask."""
    from thunder_tpu_torch import optimiser as to
    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.pipeline.synthetic import make_dataset

    size, n = 16, 16
    vol, imgs, ctf, _, _ = make_dataset(size, n, seed=2, device="cpu")
    cfg = ThunderConfig(mode="3D", k=1, size=size, pixel_size=1.32,
                        mask_radius=size * 0.55, trans_s=1.5, init_res=size * 1.32 / 4,
                        global_search_res=size * 1.32 / 6, sym="C1", m_s=256, m_l_r=12,
                        m_l_t=9, m_reco=8, ignore_res=size * 1.32, core_fsc=True)
    opt = to.Optimiser(cfg, imgs, tuple(ctf), np.zeros(n, np.int64), init_refs=vol,
                       device="cpu")
    calls = []
    real = to.true_fsc_batch

    def spy(ra, rb, mask, gen, n_shells):
        out = real(ra, rb, mask, gen, n_shells)
        calls.append((mask, out))
        return out

    monkeypatch.setattr(to, "true_fsc_batch", spy)
    opt.run_round(0)
    assert len(calls) == 1
    mask, curve = calls[0]
    assert torch.equal(mask, opt._soft_mask)
    band = opt._fsc_band
    np.testing.assert_allclose(opt.model.fsc[:, :band], curve.numpy()[:, :band], rtol=1e-6)
    assert np.isfinite(opt.model.fsc).all()
