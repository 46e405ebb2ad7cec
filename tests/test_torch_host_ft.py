"""The port's host path (HostFt: the original spectra in host memory,
host_ft_chunk images at a time to the device) on the CPU, on the data
and config of tests/test_host_ft.py (24 px, 32 images): one chunk is the
resident path bit for bit over global rounds, and through the round of
the first rescale of local rounds, where thunder_tpu raises (its fused
statistics multiply its HostFt, optimiser.py:2819-2828); four chunks
hold stage by stage to thunder_tpu's four-chunk host path given its
state (norm_correction, refresh_sigma, refresh_scale, correct_scale,
the chunked insertion's (F, T), _refresh_masked), and a run of both
holds its shell within one a round; HostFt's scale gives thunder_tpu's
HostFt.chunk bits, and chunked preprocessing the one call's."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from test_e2e_3d import make_3d_dataset  # noqa: E402
from thunder_tpu import optimiser as jo  # noqa: E402
from thunder_tpu.config import ThunderConfig as JConfig  # noqa: E402
from thunder_tpu.ops.projector import prepare_projectee_3d_cropped as jcrop  # noqa: E402
from thunder_tpu.ops.projector import ri_split  # noqa: E402
from thunder_tpu.physics.ctf import ctf_params as jctf_params  # noqa: E402
from thunder_tpu_torch import interop  # noqa: E402
from thunder_tpu_torch import optimiser as to  # noqa: E402
from thunder_tpu_torch.config import ThunderConfig as TConfig  # noqa: E402
from thunder_tpu_torch.model import SEARCH_TYPE_LOCAL  # noqa: E402

SIZE, N = 24, 32
# float32 stage tolerance against thunder_tpu on its f32 tables: its
# products and sums run in another order (jnp, XLA) than the port's
STAGE_TOL = 1e-4
RECORD_KEYS = ("round", "r", "search_type", "n_phases", "res_shell", "res_A",
               "rot_change_median_deg", "t_vari", "search_type_after")


def bits(a, b) -> bool:
    return np.array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= rtol, err
    return err


def ctf_cols(n):
    return (np.full(n, 300e3), np.full(n, 500.0), np.full(n, 500.0), np.zeros(n),
            np.full(n, 2e7), np.full(n, 0.1), np.zeros(n))


def config(cls, host: bool, chunk: int):
    """tests/test_host_ft.py's config in thunder_tpu's or the port's class."""
    return cls(mode="3D", k=1, size=SIZE, pixel_size=1.0, mask_radius=10.0, trans_s=1.5,
               init_res=4.0, global_search_res=3.0, sym="C1", m_s=128, m_l_r=12, m_l_t=6,
               m_reco=8, ignore_res=24.0, trans_search_factor=0.25, host_ft_ori=host,
               host_ft_chunk=chunk)


@pytest.fixture(scope="module")
def data():
    phantom, imgs, _, _ = make_3d_dataset(SIZE, N, snr=3.0)
    return np.asarray(phantom), np.asarray(imgs)


def port(data, host: bool, chunk: int = 9999):
    phantom, imgs = data
    return to.Optimiser(config(TConfig, host, chunk), imgs, ctf_cols(N), np.zeros(N, np.int64),
                        init_refs=phantom, device="cpu")


def thunder(data, host: bool, chunk: int = 9999):
    phantom, imgs = data
    return jo.Optimiser(config(JConfig, host, chunk), imgs, jctf_params(*ctf_cols(N)),
                        np.zeros(N, np.int64), init_refs=phantom)


def rounds(opt, first: int, last: int, local_from: int | None = None) -> list:
    out = []
    for i in range(first, last):
        if local_from is not None and i == local_from:
            opt.model.search_type = SEARCH_TYPE_LOCAL
        rec = opt.run_round(i)
        out.append({k: rec[k] for k in RECORD_KEYS if k in rec})
    return out


def same_state(a, b) -> None:
    for x, y in ((a.state.sigma, b.state.sigma), (a.state.refs, b.state.refs),
                 (a.state.par.top_r, b.state.par.top_r), (a.state.par.top_t, b.state.par.top_t),
                 (a.data.ft_masked, b.data.ft_masked)):
        assert torch.equal(x, y)


def test_one_chunk_host_path_is_the_resident_path_over_global_rounds(data):
    """host_ft_ori with one chunk over 3 global rounds: the same records,
    state and signal subtraction bit for bit (thunder_tpu's own
    criterion, test_host_ft_single_chunk_bitwise), the originals on the
    host."""
    a, b = port(data, False), port(data, True)
    assert isinstance(b.data.ft_ori, to.HostFt) and not isinstance(a.data.ft_ori, to.HostFt)
    assert b.data.ft_ori.data.device.type == "cpu"
    assert rounds(a, 0, 3) == rounds(b, 0, 3)
    same_state(a, b)
    assert torch.equal(b.data.ft_ori.chunk(slice(0, b.n_img)), a.data.ft_ori)
    # signal subtraction reads the originals a batch at a time, its rows
    # going to the host a batch at a time on the host path
    mask = a._soft_mask.numpy()
    np.testing.assert_array_equal(b.save_subtract(mask, chunk=5),
                                  a.save_subtract(mask, chunk=5))


def test_one_chunk_local_rounds_run_and_fold_the_rescale(data):
    """A global round, then local rounds with one chunk: thunder_tpu's
    fused statistics multiply its HostFt and raise there; the port folds
    each rescale into the HostFt's scale.  Through the round of the
    first rescale the host path is the resident path bit for bit (x (1
    s1) is x s1); after the second its originals are x (s1 s2) against
    the resident (x s1) s2, apart by rounding only, and the stack on the
    host was never rewritten."""
    a, b = port(data, False), port(data, True)
    stored = b.data.ft_ori.data.clone()
    assert rounds(a, 0, 2, local_from=1) == rounds(b, 0, 2, local_from=1)
    same_state(a, b)
    assert torch.equal(b.data.ft_ori.chunk(slice(0, b.n_img)), a.data.ft_ori)
    s1 = b.data.ft_ori.scale.clone()
    assert not torch.equal(s1, torch.ones_like(s1))            # round 1 rescaled
    rec_a, rec_b = rounds(a, 2, 3), rounds(b, 2, 3)
    assert [r["search_type"] for r in rec_b] == [SEARCH_TYPE_LOCAL]
    s12 = b.data.ft_ori.scale
    ratio = s12 / s1                                            # s2 as folded
    folded = b.data.ft_ori.chunk(slice(0, b.n_img))
    # the resident stack took two products, the HostFt one of a product
    err = close(folded, a.data.ft_ori, 2.0 ** -22)
    assert torch.equal(b.data.ft_ori.data, stored)
    assert not torch.equal(ratio, torch.ones_like(ratio))       # round 2 rescaled
    close(b.state.sigma, a.state.sigma, 1e-3)
    print("second rescale: originals apart by", err, "of max |F|")


def test_host_ft_scale_gives_thunder_tpus_chunk_bits():
    """The port's HostFt copy times its scale, after a norm-like product
    and a scale-like division folded in, is thunder_tpu's HostFt.chunk
    (numpy's complex64 times float32) bit for bit, for both hemispheres
    and for one."""
    rng = np.random.default_rng(1)
    raw = (rng.standard_normal((2, 20, 8, 8)) + 1j * rng.standard_normal((2, 20, 8, 8))
           ).astype(np.complex64)
    s1 = rng.uniform(0.5, 2.0, (2, 20)).astype(np.float32)
    p = rng.uniform(0.5, 2.0, (2, 20)).astype(np.float32)
    j = jo.HostFt(raw.copy())
    j.scale *= s1
    j.scale /= p
    t = to.HostFt((2, 20, 8, 8), torch.device("cpu"))
    t.put(slice(0, 20), torch.as_tensor(raw))
    t.fold(torch.as_tensor(s1))
    t.fold(torch.as_tensor(p), divide=True)
    assert bits(t.scale, j.scale)
    for sl in (slice(0, 8), slice(8, 16), slice(16, 20)):
        assert bits(t.chunk(sl), j.chunk(sl))
        assert bits(t.get(1, sl), j.get(1, sl))


def test_chunked_preprocessing_equals_the_one_call(data, four):
    """Two chunks of 8 images a hemisphere: the masked stack and the
    originals are the one call's bit for bit, and the initial noise
    spectrum from the chunks' moments is the one call's, and thunder_tpu's
    from its chunks (optimiser.py:1964-1980), within float32 rounding of
    the sums."""
    a, b = port(data, False), port(data, True, 8)
    assert len(b._ft_chunks()) == 2 and len(a._ft_chunks()) == 1      # L = 16
    assert torch.equal(a.data.ft_masked, b.data.ft_masked)
    assert torch.equal(a.data.ft_ori, b.data.ft_ori.data)
    assert torch.equal(b.data.ft_ori.scale, torch.ones_like(b.data.ft_ori.scale))
    close(b.state.sigma, a.state.sigma, 1e-5)
    close(b.state.sigma, four["sigma0"], 1e-5)


def f32_table(jopt):
    """thunder_tpu's corner-row table in float32 (its default is bf16)
    at the round's reconstruction radius, for every stage that projects."""
    crop = jo._proj_crop_size(SIZE, 2, int(jopt.model.r_u))
    tab = jnp.stack([ri_split(jnp.stack([jcrop(jopt.state.refs[h, k], 2, crop)
                                         for k in range(jopt.cfg.k)]), pack_bf16=False)
                     for h in (0, 1)])
    return lambda rings=None, refs=None, kind=None: tab


@pytest.fixture(scope="module")
def four(data):
    """Both packages' four-chunk host runs (two chunks a hemisphere):
    two global rounds, then a forced local round (norm correction,
    re-centring, re-masking), each round's record; then thunder_tpu's
    state on a float32 table, from which the stage tests start."""
    j, t = thunder(data, True, 8), port(data, True, 8)
    sigma0 = np.asarray(j.state.sigma)
    rj = rounds(j, 0, 3, local_from=2)
    rt = rounds(t, 0, 3, local_from=2)
    assert isinstance(j.data.ft_ori, jo.HostFt) and isinstance(t.data.ft_ori, to.HostFt)
    j._proj_stack = f32_table(j)
    return dict(jopt=j, topt=t, rj=rj, rt=rt, sigma0=sigma0,
                sums=(float(t.state.sigma.sum()), float(np.asarray(j.state.sigma).sum())))


def test_four_chunk_run_holds_its_shell_to_thunder_tpus(four):
    """Both packages' four-chunk host runs (the two-pass statistics,
    chunked insertion and re-masking): each round's resolution shell
    within one.  (On this data the two packages' resident runs part by
    two shells from the second of several forced local rounds: each
    draws its own random clouds.)"""
    rt, rj = four["rt"], four["rj"]
    assert [r["search_type"] for r in rt] == [0, 0, SEARCH_TYPE_LOCAL]
    for a, b in zip(rt, rj):
        assert abs(a["res_shell"] - b["res_shell"]) <= 1, (rt, rj)
    print("port", [r["res_shell"] for r in rt], "thunder_tpu", [r["res_shell"] for r in rj],
          "sigma sums", four["sums"])


def test_four_chunk_statistics_stages_hold_to_thunder_tpu(four):
    """Given thunder_tpu's state each stage of the two-pass statistics:
    norm_correction (the scale folded into HostFt, the masked stack),
    refresh_sigma, refresh_scale (one a hemisphere and per group) and
    correct_scale (the fold, the masked stack, sigma divided by the
    scale's square), within STAGE_TOL."""
    jopt, topt = four["jopt"], four["topt"]
    interop.restore(topt, interop.snapshot(jopt))
    assert len(topt._ft_chunks()) == 2
    jopt.norm_correction()
    topt.norm_correction()
    close(topt.data.ft_ori.scale, jopt.data.ft_ori.scale, STAGE_TOL)
    close(topt.data.ft_masked, jopt.data.ft_masked, STAGE_TOL)
    assert not np.allclose(jopt.data.ft_ori.scale, 1.0)

    interop.restore(topt, interop.snapshot(jopt))
    jopt.refresh_sigma()
    topt.refresh_sigma()
    close(topt.state.sigma, jopt.state.sigma, STAGE_TOL)

    interop.restore(topt, interop.snapshot(jopt))
    for group in (False, True):
        close(topt.refresh_scale(group=group), jopt.refresh_scale(group=group), STAGE_TOL)
    jopt.correct_scale()
    topt.correct_scale()
    close(topt.data.ft_ori.scale, jopt.data.ft_ori.scale, STAGE_TOL)
    close(topt.data.ft_masked, jopt.data.ft_masked, STAGE_TOL)
    close(topt.state.sigma, jopt.state.sigma, STAGE_TOL)


def test_four_chunk_insertion_and_remask_hold_to_thunder_tpu(four):
    """The chunked insertion's (F, T): the same draws into the port's
    grids (a launch a chunk, hemisphere and class, added in chunk order)
    and through thunder_tpu's chunked _insert_all_h (its shear sweep,
    bf16 hat fields: within 1e-2 of max |F| and |T|); the port's four
    chunks against its one chunk within float32 order, with the sweep
    and with the MKB option's blob (HK10); then the masked
    stack rebuilt from the re-centred originals, a chunk at a time."""
    jopt, topt = four["jopt"], four["topt"]
    interop.restore(topt, interop.snapshot(jopt))
    rng = np.random.default_rng(5)
    n_l, n_s = topt.n_img, 6
    q = np.repeat(np.asarray(jopt.state.par.top_r)[:, :, None], n_s, 2)
    q = q + 0.2 * rng.standard_normal(q.shape)
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr = rng.normal(0, 0.5, (2, n_l, n_s, 2)).astype(np.float32)
    w = np.full((2, n_l, n_s), 1.0 / n_s, np.float32)
    tt = lambda x: torch.as_tensor(x)
    f4, t4, r_u, gs = topt.reconstruct_round(draws=(tt(q), tt(tr), None, tt(w)))
    one = to.Optimiser.__new__(to.Optimiser)
    one.__dict__.update(topt.__dict__)
    one.data = one.data._replace(ft_ori=topt.data.ft_ori.chunk(slice(0, n_l)))
    f1, t1, _, _ = one.reconstruct_round(draws=(tt(q), tt(tr), None, tt(w)))
    close(f4, f1, 1e-6)
    close(t4, t1, 1e-6)
    # the MKB option's insertion (HK10) a chunk at a time too
    topt.cfg.reco_kernel = "mkb"
    try:
        fm4, tm4, _, _ = topt.reconstruct_round(draws=(tt(q), tt(tr), None, tt(w)))
        fm1, tm1, _, _ = one.reconstruct_round(draws=(tt(q), tt(tr), None, tt(w)))
    finally:
        topt.cfg.reco_kernel = "trilinear"
    close(fm4, fm1, 1e-6)
    close(tm4, tm1, 1e-6)

    cfg = jopt.cfg
    valid = np.asarray(jopt.valid, np.float32)
    score = np.asarray(jopt.state.par.score)
    w_img = score / max((score * valid).max(), 1e-12) if cfg.par_gra else np.ones_like(score)
    w_l = (w_img * valid)[:, None, :, None] * w[:, None]                 # (2, K, L, S)
    rings = jo.pack_rings(SIZE, r_u, 0)
    trans = tr - np.asarray(jopt.offset)[:, :, None, :]
    fj = tj = 0
    for sl in jopt._ft_chunks():
        f_c, t_c = jo._insert_all_h(
            jopt._ft_ori_chunk(sl), jo._slice_l(jopt.data.ctf_params, sl), rings.mask,
            rings.i_col, rings.i_row, jnp.asarray(q[:, sl]), jnp.asarray(trans[:, sl]),
            jnp.ones((2, sl.stop - sl.start, n_s), jnp.float32), jnp.asarray(w_l[:, :, sl]),
            jopt.sym.matrices, jnp.asarray((r_u - 1) * 2, jnp.float32), SIZE, 2, False,
            jopt.sym.order, gs, float(cfg.pixel_size), False, r_u, cfg.reco_kernel)
        fj, tj = fj + np.asarray(f_c), tj + np.asarray(t_c)
    close(f4.numpy().reshape(fj.shape), fj, 1e-2)
    close(t4.numpy().reshape(tj.shape), tj, 1e-2)

    jopt._refresh_masked()
    topt._refresh_masked()
    close(topt.data.ft_masked, jopt.data.ft_masked, STAGE_TOL)


def test_phase_blocks_give_the_one_block_round(data, monkeypatch):
    """A phase projects and scores its images in blocks of
    PHASE_BLOCK_BYTES of supports (what 100,000 images need on one card):
    blocks of a few images give the one-block run's records and state bit
    for bit, through a global and a local round on the host path; a
    block's runs of rungs are cut from the batch's."""
    one = port(data, True, 8)
    rec_one = rounds(one, 0, 2, local_from=1)
    monkeypatch.setattr(to, "PHASE_BLOCK_BYTES", 200_000)
    many = port(data, True, 8)
    assert rounds(many, 0, 2, local_from=1) == rec_one
    same_state(one, many)
    assert to._cut_runs([(None, 5), ((4, 1), 7)], slice(3, 9)) == [(None, 2), ((4, 1), 4)]
    assert to._cut_runs([(None, 5), ((4, 1), 7)], slice(0, 12)) == [(None, 5), ((4, 1), 7)]


def config_2d(host: bool, chunk: int):
    """tests/test_torch_2d.py's 2D config (24 px, K = 3)."""
    return TConfig(mode="2D", k=3, size=SIZE, pixel_size=1.32, mask_radius=SIZE * 1.32 * 0.42,
                   trans_s=2.0, init_res=SIZE * 1.32 / 6, global_search_res=SIZE * 1.32 / 10,
                   sym="C1", m_s_2d=40, m_l_r_2d=9, m_l_t=9, m_reco=12,
                   ignore_res=SIZE * 1.32, trans_search_factor=0.25, host_ft_ori=host,
                   host_ft_chunk=chunk)


def test_2d_host_path(data):
    """2D classification on the host path: one chunk is the resident run
    bit for bit over two rounds; with 6 images a chunk (four a
    hemisphere) the same draws insert into the same class planes (HK12's
    plain version, a launch a chunk) within float32 order, and with the
    MKB option's insertion (HK6) too, and two rounds run."""
    from thunder_tpu_torch.pipeline.synthetic import make_dataset_2d

    n = 48
    _, imgs, ctf, _, _, _ = make_dataset_2d(SIZE, n, 3, seed=3, snr=8.0, device="cpu")
    mk = lambda host, chunk: to.Optimiser(config_2d(host, chunk), imgs, tuple(ctf),
                                          np.zeros(n, np.int64), device="cpu")
    a, b, c = mk(False, 9999), mk(True, 9999), mk(True, 6)
    assert len(c._ft_chunks()) == 4
    assert rounds(a, 0, 2) == rounds(b, 0, 2)
    same_state(a, b)
    interop.restore(c, interop.snapshot(b))
    rng = np.random.default_rng(2)
    n_l, n_s = c.n_img, 4
    phi = rng.uniform(0, 2 * np.pi, (2, n_l, n_s))
    q = np.stack([np.cos(phi), np.sin(phi), 0 * phi, 0 * phi], -1).astype(np.float32)
    tr = rng.normal(0, 0.5, (2, n_l, n_s, 2)).astype(np.float32)
    w = np.full((2, n_l, n_s), 1.0 / n_s, np.float32)
    draws = tuple(torch.as_tensor(x) for x in (q, tr)) + (None, torch.as_tensor(w))
    for kernel in ("trilinear", "mkb"):
        b.cfg.reco_kernel = c.cfg.reco_kernel = kernel
        fb, tb, _, _ = b.reconstruct_round(draws=draws)
        fc, tc, _, _ = c.reconstruct_round(draws=draws)
        close(fc, fb, 1e-6)
        close(tc, tb, 1e-6)
    c.cfg.reco_kernel = "trilinear"
    assert [r["search_type"] for r in rounds(c, 2, 4)] == [0, 0]
    assert torch.isfinite(c.state.refs).all()
