"""Parity of the port's brick-window projection (ops/brick.py, host of
HK13 project_brick; its plain version on the CPU) with thunder_tpu's
project_classed_brick on brick_pack_half of the same bf16-rounded
spectra, at every rung of the ladder.

thunder_tpu reads bf16 (re, im) words from its brick table; the port
reads float32 from its cube, so the port's cube here holds the same
bf16-rounded values and both interpolate the same numbers.  Tolerance:
2e-5 of max, as tests/test_brick.py holds the brick gather to the
corner-row gather (float32 weights and sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from thunder_tpu.geometry.quaternion import random_quat, rotate3d  # noqa: E402
from thunder_tpu.ops import brick as jb  # noqa: E402
from thunder_tpu.ops.fourier import pack_rings  # noqa: E402
from thunder_tpu.ops.projector import ri_split  # noqa: E402
from thunder_tpu_torch.ops import brick as tb  # noqa: E402
from thunder_tpu_torch.ops.projector import quad_taps  # noqa: E402

RUNGS = [(4, 1), (5, 2), (6, 2), (7, 3), (8, 2)]
TOL = 2e-5


def spectra(rng, k: int, crop: int):
    """K centered spectra of random real cubes, rounded to bf16: the
    packed words thunder_tpu's table holds and the port's complex64
    cube of the same values."""
    real = rng.standard_normal((k, crop, crop, crop)).astype(np.float32)
    spec = np.fft.fftshift(np.fft.fftn(real, axes=(1, 2, 3)), axes=(1, 2, 3))
    packed = ri_split(jnp.asarray(spec.astype(np.complex64)), pack_bf16=True)
    w = np.asarray(packed)
    re = (w & 0xFFFF).astype(np.uint32) << 16
    im = (w >> 16).astype(np.uint32) << 16
    cube = re.view(np.float32) + 1j * im.view(np.float32)
    return packed, torch.as_tensor(cube.astype(np.complex64))


def clouds(seed: int, n_l: int, n_r: int, dq: float, pushed: float = 0.0):
    """(L, R, 3, 3) rotations within dq (quaternion units) of a random
    pose per image; with ``pushed``, every fourth rotation lies that
    far instead."""
    base = random_quat(jax.random.PRNGKey(seed), (n_l,))
    small = random_quat(jax.random.PRNGKey(seed + 1), (n_l, n_r))
    scale = np.full((1, n_r, 1), dq, np.float32)
    if pushed:
        scale[:, ::4] = pushed
    q = base[:, None] + jnp.asarray(scale) * small
    return np.asarray(rotate3d(q / jnp.linalg.norm(q, axis=-1, keepdims=True)))


@jax.jit(static_argnames=("r_u", "pf", "span", "stride", "b"))
def thunder_tpu_brick(packed, cls, rot, r_u: int, pf: int, span: int, stride: int, b: int):
    """thunder_tpu's projection from brick_pack_half, called with cube
    size b (one program: eager, its table build dispatches span^2
    slices)."""
    tab = jb.brick_pack_half(packed, span, stride)
    return jb.project_classed_brick(tab, cls, rot, pack_rings(2 * r_u + 4, r_u, 0), pf, b,
                                    span, stride)


def both(packed, cube, rot, cls, r_u: int, pf: int, span: int, stride: int, b: int):
    """(the port's twin, thunder_tpu's projection called with cube size
    b)."""
    rings = pack_rings(2 * r_u + 4, r_u, 0)
    ref = thunder_tpu_brick(packed, jnp.asarray(cls), jnp.asarray(rot), r_u=r_u, pf=pf,
                            span=span, stride=stride, b=b)
    rot_t = torch.as_tensor(rot)
    got = tb.project_brick(cube, rot_t, rot_t.mean(1), torch.as_tensor(np.asarray(rings.i_col)),
                           torch.as_tensor(np.asarray(rings.i_row)), pf, span, stride,
                           torch.as_tensor(cls))
    return got.numpy(), np.asarray(ref)


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("span,stride", RUNGS)
@pytest.mark.parametrize("pushed", [False, True], ids=["in margin", "a quarter pushed"])
def test_twin_matches_thunder_tpu(span, stride, pushed):
    """Samples within 0.4 of the rung's margin, and with every fourth
    rotation pushed far past it: the values agree, and where
    thunder_tpu's window gives zero the port's gives exactly zero."""
    rng = np.random.default_rng(span * 10 + stride)
    crop, r_u, pf, n_l, n_r = 36, 8, 2, 6, 16
    packed, cube = spectra(rng, 2, crop)
    dq = 0.4 * tb.spread_margin(span, stride) / (2 * pf * r_u)
    rot = clouds(span, n_l, n_r, dq, pushed=12 * dq if pushed else 0.0)
    cls = rng.integers(0, 2, n_l).astype(np.int32)
    got, ref = both(packed, cube, rot, cls, r_u, pf, span, stride, crop)
    assert rel(got, ref) <= TOL, rel(got, ref)
    zero = ref == 0
    if pushed:
        assert 0.05 < zero.mean() < 0.3, zero.mean()    # the pushed samples left the window
    else:
        assert not zero.any()
    assert (got[zero] == 0).all()


def test_quad_table_and_pf_1():
    """HK1's quad table gives the cube's values bit for bit (its cell's
    own tap is read), and pf 1 agrees with thunder_tpu."""
    rng = np.random.default_rng(3)
    span, stride, crop, r_u = 5, 2, 20, 8
    packed, cube = spectra(rng, 1, crop)
    rot = clouds(7, 4, 8, 0.4 * tb.spread_margin(span, stride) / (2 * r_u))
    cls = np.zeros(4, np.int32)
    got, ref = both(packed, cube, rot, cls, r_u, 1, span, stride, crop)
    assert rel(got, ref) <= TOL, rel(got, ref)
    rings = pack_rings(2 * r_u + 4, r_u, 0)
    args = (torch.as_tensor(rot), torch.as_tensor(rot).mean(1),
            torch.as_tensor(np.asarray(rings.i_col)), torch.as_tensor(np.asarray(rings.i_row)),
            1, span, stride)
    np.testing.assert_array_equal(tb.project_brick(quad_taps(cube), *args).numpy(), got)


def test_true_cube_size_on_rung_7_3():
    """crop = 52 on rung (7, 3), crop = 1 mod 3 (r = 12 at pf 2): the port
    agrees with thunder_tpu called with the cube's own size b = 52.
    thunder_tpu's optimiser passes b = nz stride = 54 (_brick_statics),
    which moves c = b // 2 by one cell: that call reads every window one
    cell off in z and y."""
    rng = np.random.default_rng(52)
    span, stride, crop, r_u, pf = 7, 3, 52, 12, 2
    packed, cube = spectra(rng, 1, crop)
    rot = clouds(11, 6, 16, 0.4 * tb.spread_margin(span, stride) / (2 * pf * r_u))
    cls = np.zeros(6, np.int32)
    got, ref = both(packed, cube, rot, cls, r_u, pf, span, stride, crop)
    assert rel(got, ref) <= TOL, rel(got, ref)
    nz = tb.brick_grid(span, stride, crop)[2]
    _, off = both(packed, cube, rot, cls, r_u, pf, span, stride, nz * stride)
    print(f"crop {crop} on (7, 3): the port against thunder_tpu with b = {crop}: "
          f"{rel(got, ref):.3g} of max; with b = nz stride = {nz * stride}: "
          f"{rel(got, off):.3g} of max")
    assert rel(got, off) > 0.1


@pytest.mark.parametrize("span,stride", RUNGS)
def test_plan_arithmetic_matches_thunder_tpu(span, stride):
    """guard_planes, spread_margin and table_bytes, the plan's
    arithmetic, as thunder_tpu counts it."""
    assert tb.guard_planes(span, stride) == jb.guard_planes(span, stride)
    assert tb.spread_margin(span, stride) == jb.spread_margin(span, stride)
    for b, k in ((36, 1), (52, 2), (76, 4), (164, 1)):
        assert tb.table_bytes(span, stride, b, k) == jb.table_bytes(span, stride, b, k)
