"""Parity of the port's quaternion algebra, point-group symmetry and
directional statistics with thunder_tpu on the CPU.  Random draws are
made on the JAX side (or with numpy) and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.geometry import directional as jd  # noqa: E402
from thunder_tpu.geometry import quaternion as jq  # noqa: E402
from thunder_tpu.geometry.symmetry import Symmetry as JSym  # noqa: E402
from thunder_tpu_torch.geometry import directional as td  # noqa: E402
from thunder_tpu_torch.geometry import quaternion as tq  # noqa: E402
from thunder_tpu_torch.geometry.symmetry import Symmetry as TSym  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402

# float32 products in another order than XLA's
ATOL = 2e-6


def t(x):
    return torch.as_tensor(np.array(x))


def quats(n, seed=0):
    return np.asarray(jq.random_quat(jax.random.PRNGKey(seed), (n,)))


def test_quaternion_algebra():
    a, b = quats(7, 0), quats(7, 1)
    for jfn, tfn in ((jq.quat_mul, tq.quat_mul),):
        np.testing.assert_allclose(tfn(t(a), t(b)).numpy(),
                                   np.asarray(jfn(a, b)), atol=ATOL)
    np.testing.assert_allclose(tq.rotate3d(t(a)).numpy(),
                               np.asarray(jq.rotate3d(a)), atol=ATOL)
    np.testing.assert_allclose(tq.quat_conj(t(a)).numpy(), np.asarray(jq.quat_conj(a)))
    m = np.asarray(jq.rotate3d(a))
    np.testing.assert_allclose(tq.quat_from_matrix(t(m)).numpy(),
                               np.asarray(jq.quat_from_matrix(m)), atol=1e-5)
    for x, y in zip(tq.euler_from_quat(t(a)), jq.euler_from_quat(a)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4)
    e = [np.float32(v) for v in (0.3, 1.1, 2.0)]
    np.testing.assert_allclose(tq.quat_from_euler(*map(torch.tensor, e)).numpy(),
                               np.asarray(jq.quat_from_euler(*e)), atol=ATOL)
    v = np.random.default_rng(0).standard_normal((7, 3)).astype(np.float32)
    np.testing.assert_allclose(tq.quat_rotate(t(a), t(v)).numpy(),
                               np.asarray(jq.quat_rotate(a, v)), atol=1e-5)


@pytest.mark.parametrize("name", ["C1", "C4", "D7", "T", "O", "I3"])
def test_symmetry_group_and_counterpart(name):
    js, ts = JSym(name), TSym(name)
    assert (ts.order, ts.n_elements) == (js.order, js.n_elements)
    np.testing.assert_allclose(ts.matrices.numpy(), np.asarray(js.matrices), atol=1e-6)
    np.testing.assert_allclose(ts.quats.numpy(), np.asarray(js.quats), atol=1e-6)
    q = quats(9, 3)
    np.testing.assert_allclose(ts.counterpart(t(q)).numpy(),
                               np.asarray(js.counterpart(jnp.asarray(q))), atol=1e-5)


@pytest.mark.parametrize("sym", ["C1", "D7", "I3", "O"])
def test_r_global_uses_the_port_symmetry(sym):
    """The port's ThunderConfig computes the global-search band with its
    own symmetry module and agrees with thunder_tpu's config (which uses
    the JAX package's symmetry here, where jax is installed)."""
    kw = dict(mode="3D", size=128, pixel_size=1.32, sym=sym, mask_radius=76.0,
              global_search_res=8.0)
    n_sym = TSym(sym).n_elements
    assert TConfig(**kw).r_global == JConfig(**kw).r_global
    assert TConfig(**kw).r_global == min(
        TConfig(**kw).max_r, round(128 * 1.32 / min(8.0, 19.0 / (1 + n_sym) ** (1 / 3))) + 1)


def test_acg_inference_matches_jax():
    rng = np.random.default_rng(4)
    k = np.asarray([0.05, 0.2, 0.01], np.float32)
    noise = rng.standard_normal((5, 48, 4)).astype(np.float32)
    scale = np.sqrt(np.concatenate([[1.0], k]))
    q = (noise * scale) / np.linalg.norm(noise * scale, axis=-1, keepdims=True)
    q = q.astype(np.float32)
    jm = np.asarray(jax.vmap(jd.infer_acg_matrix)(jnp.asarray(q)))
    np.testing.assert_allclose(td.infer_acg_matrix(t(q)).numpy(), jm, rtol=1e-4, atol=1e-6)
    for a, b in zip(td.infer_acg_k123(t(q)), jax.vmap(jd.infer_acg_k123)(jnp.asarray(q))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)
    mean_t = td.infer_acg_mean(t(q)).numpy()
    mean_j = np.asarray(jax.vmap(jd.infer_acg_mean)(jnp.asarray(q)))
    np.testing.assert_allclose(np.abs(np.sum(mean_t * mean_j, -1)), 1.0, atol=1e-5)
    inv_t, det_t = td.inv_det4_spd(t(jm))
    inv_j, det_j = jd.inv_det4_spd(jnp.asarray(jm))
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-4)
    np.testing.assert_allclose(det_t.numpy(), np.asarray(det_j), rtol=1e-4)


def test_sample_acg_given_noise():
    key = jax.random.PRNGKey(5)
    n = 16
    ref = np.asarray(jd.sample_acg(key, 0.1, 0.2, 0.3, n))
    noise = np.asarray(jax.random.normal(key, (n, 4)))
    got = td.sample_acg(None, torch.tensor(0.1), 0.2, 0.3, n, noise=t(noise))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_von_mises_statistics():
    v = np.random.default_rng(6).standard_normal((3, 20, 2)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    for a, b in zip(td.infer_vms(t(v)), jd.infer_vms(jnp.asarray(v))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    k = np.linspace(0.01, 1.0, 7).astype(np.float32)
    np.testing.assert_allclose(td.vms_kappa(t(k)).numpy(), np.asarray(jd.vms_kappa(k)),
                               rtol=1e-5)
    g = torch.Generator().manual_seed(0)
    s = td.sample_vms(g, torch.tensor([1.0, 0.0]), torch.tensor(0.05), 4000)
    mu, kk = td.infer_vms(s)
    assert abs(float(mu[0]) - 1.0) < 1e-3 and abs(float(kk) - 0.05) < 0.01
