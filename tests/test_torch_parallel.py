"""The port's rank layout, per-rank ingest and collectives
(thunder_tpu_torch/parallel) on the CPU over gloo.

* rank i's rows equal the rows NamedSharding(mesh, P("hemi", "data"))
  gives jax device i of thunder_tpu's make_mesh / default_mesh, for 2,
  3, 4 and 8 ranks, on the conftest's eight virtual CPU devices;
* two ranks each load only their own images (tests/test_sharded_ingest.py
  for the port);
* every collective of parallel/comm.py on CPU tensors over gloo against
  the one-process result.

``run_ranks`` is the harness the other multi-rank tests import: it
starts one spawned process a rank on a free local port, with a timeout,
and fails if any rank fails.
"""

import multiprocessing as mp
import os
import socket
import traceback

import numpy as np
import pytest
import torch

RANK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, args, err_path):
    torch.set_num_threads(1)
    try:
        from thunder_tpu_torch.parallel.distributed import init_multihost

        init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=120)
        torch.set_num_threads(1)        # the test workers share the cores too
        fn(rank, world, *args)
        import torch.distributed as dist

        dist.destroy_process_group()
    except BaseException:
        with open(err_path, "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, *args, tmp=None, timeout: float = RANK_TIMEOUT_S) -> None:
    """Run fn(rank, world, *args) in ``world`` spawned processes joined
    in one gloo process group; fail on any rank's error or the timeout."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    errs = [os.path.join(str(tmp), f"rank{r}.err") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, args, errs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    msgs = [open(e).read() for e in errs if os.path.exists(e)]
    assert not alive, f"{len(alive)} ranks still running after {timeout} s"
    assert not msgs and all(p.exitcode == 0 for p in procs), "\n".join(msgs)


# -- layout against thunder_tpu's mesh ---------------------------------

def _jax_rows(mesh, n_img: int) -> list:
    """Per jax device (in jax.devices() order of the mesh), its (2, n_img) mask."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = mesh.axis_names
    spec = P("hemi" if "hemi" in axes else None, "data" if "data" in axes else None)
    idx = NamedSharding(mesh, spec).devices_indices_map((2, n_img))
    out = []
    for dev in mesh.devices.reshape(-1):
        m = np.zeros((2, n_img), bool)
        m[idx[dev][0], idx[dev][1]] = True
        out.append(m)
    return out


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_layout_equals_thunder_tpu_mesh(n):
    # jax is imported here, not at the top: the spawned ranks import this
    # module for run_ranks and need no jax
    import jax
    from jax.sharding import Mesh
    from thunder_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from thunder_tpu_torch.parallel.distributed import default_mesh
    from thunder_tpu_torch.parallel.mesh import hemi_data_rows, make_mesh

    devices = np.asarray(jax.devices()[:n])
    # default_mesh's rule (thunder_tpu/parallel/distributed.py:39-49)
    jmesh = (Mesh(devices.reshape(2, -1), ("hemi", "data")) if n % 2 == 0
             else Mesh(devices, ("data",)))
    n_img = 24
    want = _jax_rows(jmesh, n_img)
    for r in range(n):
        lay = make_mesh(n, 2 if n % 2 == 0 else 1, r)
        np.testing.assert_array_equal(hemi_data_rows(lay, n_img), want[r])
    if n % 2 == 0:
        want = _jax_rows(jax_make_mesh(n, hemi=2), n_img)
        for r in range(n):
            np.testing.assert_array_equal(hemi_data_rows(make_mesh(n, 2, r), n_img),
                                          want[r])
    assert default_mesh().world == 1        # no process group: one process


# -- per-rank ingest ----------------------------------------------------

def _ingest_rank(rank, world, n, size, tmp):
    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.optimiser import Optimiser
    from thunder_tpu_torch.parallel.distributed import default_mesh

    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((n, size, size)).astype(np.float32)
    ctf = [np.full(n, v) for v in (300e3, 500.0, 500.0, 0.0, 2e7, 0.1, 0.0)]
    cfg = ThunderConfig(mode="2D", k=1, size=size, pixel_size=1.0, mask_radius=6.0)
    asked = []

    def loader(ids):
        asked.append(np.asarray(ids).copy())
        return imgs[ids]

    opt = Optimiser(cfg, None, ctf, np.zeros(n, np.int64), device="cpu",
                    layout=default_mesh(device="cpu"), image_loader=loader)
    rows = opt.local_rows
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), asked=np.concatenate(asked),
             mine=opt.index[rows].reshape(-1), valid=opt.valid[rows].reshape(-1),
             sizes=[opt.n_img_all, opt.n_img, opt.n_local_loaded])


def _four_rank(rank, world, tmp):
    """The four-rank cases of both tests below in one set of processes."""
    _ingest_rank(rank, world, 10, 16, tmp)
    _comm_rank(rank, world, 2, tmp)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("four")
    run_ranks(_four_rank, 4, str(tmp), tmp=tmp)
    return tmp


def _ranks_dir(request, tmp_path, world, fn, *args):
    """The directory of ``world`` ranks' outputs: the shared four-rank
    run, or a run of ``fn`` here."""
    if world == 4:
        return request.getfixturevalue("four_ranks")
    run_ranks(fn, world, *args, str(tmp_path), tmp=tmp_path)
    return tmp_path


@pytest.mark.parametrize("world,n", [(2, 16), (4, 10)])
def test_rank_ingest_reads_only_own_rows(request, tmp_path, world, n):
    """Each rank reads only its rows; L is rounded up to a multiple of
    the data extent with the pads invalid (thunder_tpu
    optimiser.py:1905-1910), and the valid rows hold every image once."""
    tmp_path = _ranks_dir(request, tmp_path, world, _ingest_rank, n, 16)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    d = world // 2
    L = -(-(n // 2) // d) * d
    for g in got:
        np.testing.assert_array_equal(g["asked"], g["mine"])
        assert list(g["sizes"]) == [L, L // d, L // d]
    valid = np.concatenate([g["mine"][g["valid"]] for g in got])
    np.testing.assert_array_equal(np.sort(valid), np.arange(n))
    # the hemispheres: the first half of the ranks reads A, the rest B
    a = np.concatenate([g["asked"] for g in got[:d]])
    b = np.concatenate([g["asked"] for g in got[d:]])
    assert not set(a) & set(b)


# -- collectives ---------------------------------------------------------

def _global(shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    if dtype == torch.complex64:
        return torch.complex(x, torch.randn(shape, generator=g, dtype=torch.float64)).to(dtype)
    return x.to(dtype)


def _comm_rank(rank, world, hemi, tmp):
    from thunder_tpu_torch.parallel import comm
    from thunder_tpu_torch.parallel.distributed import build_groups
    from thunder_tpu_torch.parallel.mesh import make_mesh

    lay = build_groups(make_mesh(world, hemi, rank, backend="gloo"))
    L = 4 * lay.data
    x = _global((2, L, 3), 1)
    mine = lay.take(x).contiguous()
    out = {}
    # rows: to every rank, and to rank 0
    out["all_gather_rows"] = comm.all_gather_rows(lay, mine)
    lead = comm.gather_rows_to_lead(lay, mine.to(torch.complex64))
    assert (lead is None) == (rank != 0)
    if lead is not None:
        out["gather_rows_to_lead"] = lead
    # per-hemisphere sums over the data group, and over the world
    out["sum_data"] = comm.sum_data(lay, mine.sum(1).contiguous())
    out["sum_world"] = comm.sum_world(lay, mine.sum((0, 1)).contiguous())
    out["max_world"] = comm.max_world(lay, mine.amax((0, 1)).contiguous())
    out["max_data"] = comm.max_data(lay, mine.amax(1).contiguous())
    # the hemisphere pair: a per-hemisphere quantity meets its mate
    per_h = _global((2, 5), 2, torch.complex64)
    out["exchange_hemi"] = comm.exchange_hemi(lay, per_h[list(lay.hemis)].contiguous())
    # slabs of a (K, big, big, big) volume over the data group
    big, d = 12, lay.data
    vol = _global((2, big, big, big), 3, torch.complex64)
    z0 = lay.j * (big // d)
    slab = vol[:, z0:z0 + big // d].contiguous()
    out["gather_slabs"] = comm.gather_slabs(lay, slab, axis=-3)
    out["all_to_all_z"] = comm.all_to_all_z(lay, slab, split_axis=-2, concat_axis=-3)
    if d % 2 == 0:      # the half-box roll's partners (an even data extent)
        out["swap_data"] = comm.swap_data(lay, slab, (lay.j + d // 2) % d)
    torch.save(out, os.path.join(tmp, f"comm{rank}.pt"))


@pytest.mark.parametrize("world,hemi", [(4, 2), (3, 1)])
def test_collectives_against_one_process(request, tmp_path, world, hemi):
    from thunder_tpu_torch.parallel.mesh import make_mesh

    tmp_path = _ranks_dir(request, tmp_path, world, _comm_rank, hemi)
    d = world // hemi
    L = 4 * d
    x = _global((2, L, 3), 1)
    per_h = _global((2, 5), 2, torch.complex64)
    big = 12
    vol = _global((2, big, big, big), 3, torch.complex64)
    bz = big // d
    for r in range(world):
        lay = make_mesh(world, hemi, r)
        got = torch.load(tmp_path / f"comm{r}.pt")
        hs = list(lay.hemis)
        torch.testing.assert_close(got["all_gather_rows"], x, rtol=0, atol=0)
        if r == 0:
            torch.testing.assert_close(got["gather_rows_to_lead"], x.to(torch.complex64),
                                       rtol=0, atol=0)
        torch.testing.assert_close(got["sum_data"], x.sum(1)[hs], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got["sum_world"], x.sum((0, 1)), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got["max_world"], x.amax((0, 1)), rtol=0, atol=0)
        torch.testing.assert_close(got["max_data"], x.amax(1)[hs], rtol=0, atol=0)
        torch.testing.assert_close(got["exchange_hemi"], per_h, rtol=0, atol=0)
        torch.testing.assert_close(got["gather_slabs"], vol, rtol=0, atol=0)
        j = lay.j
        # the transpose: z whole, y cut into the data extent's blocks
        torch.testing.assert_close(got["all_to_all_z"],
                                   vol[:, :, j * bz:(j + 1) * bz], rtol=0, atol=0)
        if d % 2 == 0:
            p = (j + d // 2) % d
            torch.testing.assert_close(got["swap_data"], vol[:, p * bz:(p + 1) * bz],
                                       rtol=0, atol=0)
