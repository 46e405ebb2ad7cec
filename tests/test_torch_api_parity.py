"""Every public name of thunder_tpu has a twin in the port or a stated
reason why not, and the twins added last hold to thunder_tpu on the CPU.

The guard walks the AST of every module of thunder_tpu: each public
top-level function and class, and each public method of a public class,
has a twin of the same name in the port's module of the same path, or
stands in LEFT_BEHIND with the port's counterpart or the reason there is
none."""

import ast
import dataclasses
import json
import logging
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu import model as jmodel
from thunder_tpu import particle as jpt
from thunder_tpu.config import ThunderConfig as JConfig
from thunder_tpu.geometry import quaternion as jq
from thunder_tpu.io import mrc as jmrc
from thunder_tpu.io import thu as jthu
from thunder_tpu.physics import ctf as jctf
from thunder_tpu.physics.mask import soft_mask_weight as j_soft_mask
from thunder_tpu.utils import logging as jlog
from thunder_tpu_torch import model as tmodel
from thunder_tpu_torch import particle as tpt
from thunder_tpu_torch.config import ThunderConfig as TConfig
from thunder_tpu_torch.geometry import quaternion as tq
from thunder_tpu_torch.io import mrc as tmrc
from thunder_tpu_torch.io import thu as tthu
from thunder_tpu_torch.physics import ctf as tctf
from thunder_tpu_torch.utils import logging as tlog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(REPO, "thunder_tpu"), os.path.join(REPO, "thunder_tpu_torch")
MODULES = sorted(os.path.relpath(os.path.join(d, f), REF)
                 for d, _, fs in os.walk(REF) for f in fs if f.endswith(".py"))

_MESH = ("the JAX mesh's sharding; the port's ranks hold their rows by parallel/mesh.py's "
         "Layout (hemi_data_rows, parallel/ingest.py process_local_rows)")
_SWEEP = ("HK11, thunder_tpu's TPU shear-sweep insertion and its chunking; the port's "
          "counterpart is ops/insert.py insert_sweep (its slab form insert_sweep_slab)")
# "module:Name" (a class's entry covers its methods) -> the port's
# counterpart, or why the port has none
LEFT_BEHIND = {
    "optimiser.py:compile_seconds": "JAX jit compile time; the port compiles nothing at run "
                                    "time (its kernels are built once by _native.build)",
    "optimiser.py:json_dumps_bytes": "the checkpoint's model encoder; the port's "
                                     "Optimiser.save_checkpoint encodes its model with json",
    "optimiser.py:translate_phases_view": "thunder_tpu's optimiser keeps its own copy; the "
                                          "port's is ops/fourier.py translate_phases_view",
    "ops/projector.py:oct_pack": "a TPU table layout; the port projects from its quad table "
                                 "or the plain cube (Optimiser.proj_table, HK1 project_slices)",
    "ops/projector.py:oct_pack_half": "a TPU table layout; see oct_pack",
    "ops/projector.py:project_ri": "projection from the TPU's split real / imaginary "
                                   "tables; counterpart ops/projector.py project_slices (HK1)",
    "ops/projector.py:ri_split": "the TPU's split real / imaginary table layout; see project_ri",
    "ops/fourier.py:irfftn_safe": "a workaround for the TPU's fused 3D irfftn; the port calls "
                                  "torch.fft.irfftn",
    "ops/fourier.py:scatter_packed": "no caller in thunder_tpu",
    "ops/brick.py:brick_pack_half": "the TPU's brick layout (ROADMAP Q2); HK13 reads the "
                                    "round's quad table or cube",
    "ops/brick.py:project_classed_brick": "counterpart ops/brick.py project_brick (HK13)",
    "ops/insert.py:insert_sweep_3d": _SWEEP,
    "ops/insert.py:insert_sweep_flat3d": _SWEEP,
    "ops/insert.py:flat_chunk_budget": _SWEEP,
    "ops/insert.py:sweep_chunk_budget": _SWEEP,
    "recon/sharded.py:insert_sweep_3d_sharded": "HK11's slab form on the JAX mesh; "
                                                "counterpart ops/insert.py insert_sweep_slab",
    "parallel/ingest.py:assemble_global": _MESH,
    "parallel/ingest.py:mesh_axis_names": _MESH,
    "parallel/mesh.py:hemi_data_sharding": _MESH,
}
# thunder_tpu's config fields the port's ThunderConfig does not have
CONFIG_LEFT_BEHIND = {
    "group_sig": "read from the JSON, used by no code of thunder_tpu",
    "perturb_factor_l": "read from the JSON, used by no code of thunder_tpu",
    "thres_sclCor_fsc": "read from the JSON, used by no code of thunder_tpu",
    "n_threads": "read from the JSON, used by no code of thunder_tpu",
}


def public_names(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                and not node.name.startswith("_")):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
    return out


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_twin_or_a_reason(module):
    port = os.path.join(PORT, module)
    assert os.path.exists(port), f"thunder_tpu/{module} has no twin in thunder_tpu_torch/"
    want, have = public_names(os.path.join(REF, module)), public_names(port)
    left = {k.split(":")[1] for k in LEFT_BEHIND if k.split(":")[0] == module}
    missing = sorted(n for n in want - have if n not in left and n.split(".")[0] not in left)
    assert not missing, f"thunder_tpu/{module}: no twin and no reason for {missing}"
    stale = sorted(n for n in left if n not in want or n in have)
    assert not stale, (f"LEFT_BEHIND names {stale} of {module}, which thunder_tpu lacks or "
                       "the port has")
    assert all(len(LEFT_BEHIND[f"{module}:{n}"]) > 10 for n in left)


def _quat(rng, shape):
    q = rng.standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _unit(rng, shape):
    v = rng.standard_normal(shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# name -> (inputs from a seeded rng, thunder_tpu's function, the port's)
HELPERS = {
    "ctf_1d": (lambda rng: (np.linspace(0, 1 / (2 * 1.32), 97, dtype=np.float32), 300e3,
                            rng.uniform(8e3, 3e4), 2.7e7, 0.07, rng.uniform(0, 0.5)),
               jctf.ctf_1d, tctf.ctf_1d),
    "quat_from_axis_angle": (lambda rng: (_unit(rng, (5, 3)),
                                          rng.uniform(-np.pi, np.pi, (5, 3)).astype(np.float32)),
                             jq.quat_from_axis_angle, tq.quat_from_axis_angle),
    "rotate2d": (lambda rng: (rng.uniform(-7, 7, (4, 6)).astype(np.float32),),
                 jq.rotate2d, tq.rotate2d),
    "swing_twist": (lambda rng: (_quat(rng, (7, 5)), _unit(rng, (7, 5))),
                    jq.swing_twist, tq.swing_twist),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_helper_matches_thunder_tpu(name):
    make, jfn, tfn = HELPERS[name]
    args = make(np.random.default_rng(len(name)))
    as_j = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    as_t = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    want, got = jfn(*as_j), tfn(*as_t)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_random_unit2d_gives_unit_pairs():
    """The generators differ: the shape and the unit norm hold, and the
    angles cover the circle."""
    gen = torch.Generator().manual_seed(0)
    got = tq.random_unit2d(gen, (300, 2))
    want = jq.random_unit2d(jax.random.PRNGKey(0), (300, 2))
    assert tuple(got.shape) == want.shape == (300, 2, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0, atol=1e-6)
    angles = torch.atan2(got[..., 1], got[..., 0]).flatten()
    assert (torch.histc(angles, 4, -math.pi, math.pi) > 100).all()


def test_draw_poses_given_thunder_tpus_draws():
    """draw_poses gathers the draws it is given, each kept as drawn: the
    poses thunder_tpu draws with its key, and the support's sizes."""
    n_img, n_r, n_t, n_d, n_draw = 6, 12, 5, 3, 40
    key = jax.random.PRNGKey(4)
    js = jpt.init_particles(jax.random.PRNGKey(1), n_img, n_r, n_t, n_d, 2.0, 0)
    js = js._replace(d=jax.random.uniform(jax.random.PRNGKey(2), (n_img, n_d)) + 0.5)
    ts = tpt.ParticleState(*[torch.as_tensor(np.array(f)) for f in js])
    kr, kt, kd = jax.random.split(key, 3)
    draws = tuple(torch.as_tensor(np.array(jax.random.randint(k, (n_img, n_draw), 0, n)))
                  for k, n in ((kr, n_r), (kt, n_t), (kd, n_d)))
    got = tpt.draw_poses(None, ts, n_draw, draws)
    for w, g in zip(jpt.draw_poses(key, js, n_draw), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for name in ("n_images", "n_r", "n_t", "n_d"):
        assert getattr(ts, name) == getattr(js, name)
    gen = torch.Generator().manual_seed(3)
    q, t, d = tpt.draw_poses(gen, ts, n_draw)
    assert q.shape == (n_img, n_draw, 4) and t.shape == (n_img, n_draw, 2)
    assert d.shape == (n_img, n_draw)


def test_true_fsc_matches_jax_given_phases(monkeypatch):
    """true_fsc on one pair, thunder_tpu's random phases injected (as
    test_torch_model.py holds true_fsc_batch's body)."""
    size, n_shells = 16, 8
    rng = np.random.default_rng(0)
    a = rng.standard_normal((size,) * 3).astype(np.float32)
    b = (a + 0.7 * rng.standard_normal((size,) * 3)).astype(np.float32)
    m = np.array(j_soft_mask(size, 3, 5.0, 2.0), np.float32)
    key = jax.random.PRNGKey(3)
    want = jmodel.true_fsc(a, b, m, n_shells, key)
    phases = [torch.as_tensor(np.array(jax.random.uniform(k, (size,) * 3, minval=0.0,
                                                          maxval=2 * np.pi)))
              for k in jax.random.split(key)]
    real = tmodel.spectrum.random_phase
    monkeypatch.setattr(tmodel.spectrum, "random_phase",
                        lambda ft, r, gen, ndim=None, phase=None:
                        real(ft, r, gen, ndim, phases.pop(0)))
    got = tmodel.true_fsc(a, b, m, n_shells, torch.Generator().manual_seed(0))
    assert not phases and isinstance(got, np.ndarray) and got.shape == (n_shells,)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_mrc_slice_access_and_thu_groups_match_thunder_tpu(tmp_path):
    """MrcFile.n_slices and read_slice (shifted and not) give
    thunder_tpu's bits; ThuTable.n_groups its count, empty tables too."""
    stack = np.random.default_rng(2).standard_normal((5, 9, 7)).astype(np.float32)
    path = str(tmp_path / "s.mrcs")
    tmrc.write_mrc(path, stack, 1.1, is_stack=True)
    tf, jf = tmrc.MrcFile(path), jmrc.MrcFile(path)
    assert tf.n_slices == jf.n_slices == 5
    for i in (4, 0, 2):
        for shift in (True, False):
            got, want = tf.read_slice(i, shift), jf.read_slice(i, shift)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for n, groups in ((6, [3, 1, 2, 3, 1, 1]), (0, [])):
        t = tthu.ThuTable.blank(n)
        t.group_id = np.asarray(groups, np.int64)
        tthu.write_thu(str(tmp_path / "g.thu"), t)
        assert tthu.read_thu(str(tmp_path / "g.thu")).n_groups == \
            jthu.read_thu(str(tmp_path / "g.thu")).n_groups == (3 if n else 0)


@pytest.mark.parametrize("name", ["demo.json", "demo_2D.json", "demo_3D.json"])
def test_config_to_json_matches_thunder_tpu(name, tmp_path):
    """On the same config both write the same JSON object, but for the
    fields of thunder_tpu's that the port does not have
    (CONFIG_LEFT_BEHIND); the key order follows each dataclass."""
    path = os.path.join(REPO, "configs", name)
    TConfig.from_json(path).to_json(str(tmp_path / "t.json"))
    JConfig.from_json(path).to_json(str(tmp_path / "j.json"))
    got, want = (json.load(open(tmp_path / f"{p}.json")) for p in "tj")
    assert sorted(set(want) - set(got)) == sorted(CONFIG_LEFT_BEHIND)
    assert set(got) <= set(want)
    assert got == {k: v for k, v in want.items() if k not in CONFIG_LEFT_BEHIND}
    assert [f.name for f in dataclasses.fields(TConfig)] == list(got)


@pytest.fixture()
def thunder_loggers():
    """Restore the thunder.* loggers' handlers and levels after a test
    that sets them up."""
    names = [f"thunder.{n}" for n in jlog.LOGGER_NAMES]
    saved = {n: (logging.getLogger(n).level, list(logging.getLogger(n).handlers))
             for n in names}
    yield
    for n, (level, handlers) in saved.items():
        lg = logging.getLogger(n)
        lg.setLevel(level)
        lg.handlers[:] = handlers


def test_logging_utilities_match_thunder_tpu(tmp_path, thunder_loggers, caplog):
    """memory_rss_gb is finite and positive; check_memory logs thunder_tpu's
    line; init_loggers makes its named family with a file sink; timed adds
    to its sink; device_memory_gb is empty without a card; profiler_trace
    is a no-op without a directory and writes a trace into one."""
    rss = tlog.memory_rss_gb()
    assert math.isfinite(rss) and rss > 0
    assert abs(rss - jlog.memory_rss_gb()) < 0.5
    caplog.set_level(logging.INFO, logger="thunder.MEM")
    tlog.check_memory("round 3")
    jlog.check_memory("round 3")
    lines = [r.getMessage() for r in caplog.records if r.name == "thunder.MEM"]
    assert len(lines) == 2 and all(m.startswith("round 3: host RSS ") and m.endswith(" GB")
                                   for m in lines)
    got = tlog.init_loggers(str(tmp_path / "t.log"), logging.DEBUG)
    assert tlog.LOGGER_NAMES == jlog.LOGGER_NAMES and list(got) == list(jlog.LOGGER_NAMES)
    assert all(lg.name == f"thunder.{n}" and lg.level == logging.DEBUG for n, lg in got.items())
    got["IO"].info("written")
    for h in got["IO"].handlers:
        h.flush()
    assert "[thunder.IO] INFO written" in (tmp_path / "t.log").read_text()
    sinks = ({}, {})
    for mod, sink in zip((tlog, jlog), sinks):
        for _ in range(2):
            with mod.timed("stage", sink):
                pass
    assert set(sinks[0]) == set(sinks[1]) == {"stage"} and sinks[0]["stage"] >= 0
    if not torch.cuda.is_available():
        assert tlog.device_memory_gb() == {}
    with tlog.profiler_trace(None), jlog.profiler_trace(None):
        pass
    with tlog.profiler_trace(str(tmp_path / "trace")):
        torch.ones(64).sum()
    (trace,) = os.listdir(tmp_path / "trace")
    assert trace.endswith(".json") and json.load(open(tmp_path / "trace" / trace))


def test_cli_logs_host_rss_after_every_round(tmp_path, caplog):
    """The port's CLI logs check_memory's line after each round, as
    thunder_tpu's does."""
    from thunder_tpu_torch.cli.thunder import main
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    cfg_path = write_demo(str(tmp_path / "demo"), n=16, size=16, seed=1, device="cpu")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["Basic"]["Path of Output"] = str(tmp_path / "out") + "/"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    caplog.set_level(logging.INFO)
    assert main([cfg_path, "--device", "cpu", "--max-rounds", "2"]) == 0
    rounds = [r.getMessage() for r in caplog.records if r.name == "thunder"
              and r.getMessage().startswith("round ") and "searchType" in r.getMessage()]
    mem = [r.getMessage() for r in caplog.records if r.name == "thunder.MEM"]
    assert len(rounds) == 2
    assert [m.split(":")[0] for m in mem] == ["round 0", "round 1"]
    assert all(math.isfinite(float(m.split("host RSS ")[1].split()[0])) for m in mem)
