"""The port's multi-device engine (pangulu_tpu_torch.parallel) against
the JAX package's (pangulu_tpu.parallel), on the CPU.

- The host tables are bit-equal: the block-cyclic layout, every segment
  table of ``DistributedLU._prepare_levels`` and the solve tables of
  ``DistributedTriangularSolver``, on grids 1x2, 2x1, 2x2 and 2x4, rcm
  and nd, nb 8 and 16; ``waste_aware_runs`` (vectorised in the port)
  gives the JAX function's runs on random signature lists.
- A 1 x 1 grid delegates to the single-device engines, as JAX's
  ``DistributedLU`` does; ``force_collective`` runs the collective step
  in-process against JAX's.
- Real multi-process runs: ``pangulu_tpu_torch/tools/run_multiprocess.py``
  starts 4 ranks on a 2 x 2 grid and 2 ranks on a 1 x 2 grid, joined by
  gloo on the CPU (two jobs, started together at the first test of this
  module and read by the tests; a subprocess, so no rank imports JAX).
  The factors, assembled from the ranks' shards, match the JAX
  package's mesh factors (r64 1e-12, as tests/test_distributed.py:51-53;
  r32 1e-5, 2e-4 grouped); solves of 1 and 3 right-hand sides,
  ``factor_check_vector``, an ``update_values`` -> ``gstrf`` cycle on
  the kept tables, cr64 through the embedding, r64 at nb = 288 (K1 for
  wide tiles as the diagonal step on the card) on the 2 x 2 grid, cr64
  with native complex tiles on the 1 x 2 grid (complex shards,
  all-reduces of complex tensors, complex partial x), two
  factorizations on a rank bit-identical, every rank the same x.  The
  native complex gstrf check is taken in complex128 (the JAX package's
  takes it in float64 and drops the imaginary parts: ~0.7 on exact
  factors; an intended divergence).
- The refusals: a mesh without a process group, a world size other than
  p·q, nccl with two ranks on one card, compressed tiles with a mesh,
  and (from the ranks) ``gstrs(trans=True)``, ``gstrs_device``,
  ``save_factor`` and ``factor_diagnostics`` on a sharded handle; the CLI
  under a launcher, and ``--mesh`` outside one.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st
from jax.sharding import Mesh

import pangulu_tpu.models as pjm
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as ptm
from pangulu_tpu.api import InitOptions as JOpts
from pangulu_tpu.api import gstrf as jgstrf
from pangulu_tpu.api import gstrs as jgstrs
from pangulu_tpu.api import init as jinit
from pangulu_tpu.parallel import dist_numeric as jdn
from pangulu_tpu.parallel.dist_sptrsv import \
    DistributedTriangularSolver as JDistTS
from pangulu_tpu.parallel.mesh import grid_shape as jgrid_shape
from pangulu_tpu.schedule import waste_aware_runs as jwaste
from pangulu_tpu_torch.blocks import gather_factor
from pangulu_tpu_torch.io.mmio import write_matrix
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.parallel import dist_numeric as pdn
from pangulu_tpu_torch.parallel import mesh as pmesh
from pangulu_tpu_torch.parallel import multihost
from pangulu_tpu_torch.parallel.dist_sptrsv import (
    DistributedTriangularSolver, solve_tables)
from pangulu_tpu_torch.schedule import waste_aware_runs
from pangulu_tpu_torch.utils.perf import PerfCounters, residual_norm

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOOL = ROOT / "pangulu_tpu_torch" / "tools" / "run_multiprocess.py"

# the two jobs: (ranks, grid, cases
# LABEL:MATRIX:SIZE:DTYPE:ORDERING:NB[:COMPLEX_MODE])
JOBS = {
    "2x2": (4, (2, 2), ["r64_nd:poisson2d:10:r64:nd:8",
                        "r32_rcm:poisson2d:12:r32:rcm:16",
                        "cr64_rcm:poisson2d:7:cr64:rcm:8",
                        "r64_nb288:poisson2d:30:r64:rcm:288"]),
    "1x2": (2, (1, 2), ["r64_rcm:poisson2d:10:r64:rcm:8",
                        "r32_nd:poisson2d:12:r32:nd:16",
                        "cr64n_rcm:poisson2d:7:cr64:rcm:8:native"]),
}
# (rtol, atol) of the factors against JAX's (tests/test_distributed.py:
# 51-53; the mega tolerances for f32, grouped 2e-4)
FACTOR_TOL = {"r64_nd": 1e-12, "r64_rcm": 1e-12, "cr64_rcm": 1e-12,
              "r32_rcm": 1e-5, "r32_nd": 2e-4, "r64_nb288": 1e-12,
              "cr64n_rcm": 1e-12}


def _host(nx, nb, ordering, dtype="r64"):
    """The port's and the JAX package's handles of poisson2d(nx)."""
    hp = pt.init(ptm.poisson2d(nx), pt.InitOptions(
        nb=nb, dtype=dtype, ordering=ordering, device="cpu"))
    hj = jinit(pjm.poisson2d(nx), JOpts(nb=nb, dtype=dtype,
                                        ordering=ordering))
    return hp, hj


def _eq(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape,
                                                       b.shape, a.dtype,
                                                       b.dtype)
    assert np.array_equal(a, b), name


def _jax_mesh(p, q):
    return Mesh(np.array(jax.devices()[: p * q]).reshape(p, q),
                axis_names=("gp", "gq"))


# ---- the multi-process jobs (started once, read by many tests) ---------

class _Job:
    def __init__(self, name, tmp: pathlib.Path):
        self.np, self.grid, self.cases = JOBS[name]
        self.out = tmp / name
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        cmd = [sys.executable, str(TOOL), "-np", str(self.np), "--mesh",
               ",".join(map(str, self.grid)), "--device", "cpu",
               "--backend", "gloo", "--out", str(self.out), "--timeout",
               "240", "--reps", "1"]
        for c in self.cases:
            cmd += ["--case", c]
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self.res = None

    def ranks(self, label):
        """The ranks' records of one case, in rank order."""
        if self.res is None:
            out, err = self.proc.communicate(timeout=300)
            self.res = (self.proc.returncode, out, err)
        rc, out, err = self.res
        assert rc == 0, out + err
        assert "MULTIPROC OK" in out
        return [dict(np.load(self.out / f"{label}_rank{r}.npz"))
                for r in range(self.np)]


@pytest.fixture(scope="module", autouse=True)
def jobs(tmp_path_factory):
    # started by the module's first test: the ranks run beside the
    # in-process tests
    tmp = tmp_path_factory.mktemp("dist_jobs")
    started = {name: _Job(name, tmp) for name in JOBS}
    yield started
    for job in started.values():
        if job.proc.poll() is None:
            job.proc.kill()
        job.proc.communicate()


def _case(label):
    for name, (_n, grid, cases) in JOBS.items():
        for c in cases:
            if c.split(":")[0] == label:
                _, matrix, size, dtype, ordering, nb, *mode = c.split(":")
                return name, grid, dict(matrix=matrix, size=int(size),
                                        dtype=dtype, ordering=ordering,
                                        nb=int(nb),
                                        complex_mode=(mode or ["embed"])[0])
    raise KeyError(label)


_JAX_REFS = {}


def _matrix(c):
    """A case's matrix as the ranks build it (scipy, float64 or, with
    imaginary parts, complex128)."""
    a = getattr(ptm, c["matrix"])(c["size"])
    if c["dtype"].startswith("c"):
        from pangulu_tpu_torch.testing import with_imaginary_parts

        a = with_imaginary_parts(a, seed=0)
    return a.to_scipy().astype(np.complex128 if c["dtype"].startswith("c")
                               else np.float64)


def _jax_ref(label):
    """The JAX package's mesh run of a case: its gathered factors, x for
    b = A·1, gstrf residual, and the matrix."""
    if label in _JAX_REFS:
        return _JAX_REFS[label]
    _, grid, c = _case(label)
    a = _matrix(c)
    h = jinit(a, JOpts(nb=c["nb"], dtype=c["dtype"], ordering=c["ordering"],
                       mesh_shape=grid, check=True,
                       complex_mode=c["complex_mode"]))
    jgstrf(h)
    x = jgstrs(h, a @ np.ones(a.shape[0]))
    ref = dict(tiles=np.asarray(h.factor_tiles), x=x, a=a,
               gstrf_residual=h.perf.kernels["gstrf_residual"],
               groups=h.perf.kernels.get("dist_groups"))
    _JAX_REFS[label] = ref
    return ref


def _assemble(ranks, q):
    """The global [num_tiles + 1, nb, nb] store from the ranks' shards
    (rank r·q + c holds grid coordinate (r, c))."""
    r0 = ranks[0]
    nt = int(r0["num_tiles"])
    sh = np.stack([r["shard"] for r in ranks])
    out = np.zeros((nt + 1,) + sh.shape[2:], sh.dtype)
    out[:nt] = sh[r0["tile_owner_r"].astype(np.int64) * q
                  + r0["tile_owner_c"], r0["tile_slot"]]
    return out


ALL_CASES = [c.split(":")[0] for _, _, cases in JOBS.values() for c in cases]


# ---- host tables --------------------------------------------------------

def test_grid_shape_and_owner_match_jax():
    for n in range(1, 17):
        assert pmesh.grid_shape(n) == jgrid_shape(n)
    assert pmesh.owner(5, 7, 2, 4) == (1, 3)


@pytest.mark.parametrize("nb", [8, 16])
@pytest.mark.parametrize("ordering", ["rcm", "nd"])
@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2), (2, 4)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_dist_tables_match_jax(grid, ordering, nb):
    """build_layout, _prepare_levels (every segment: kmat, the member
    tables, the signature, all 15 [p, q, ...] tables), the exchange
    counters and the solve tables, bit for bit."""
    p, q = grid
    hp, hj = _host(12, nb, ordering)
    lp = pdn.build_layout(hp.blocked, p, q)
    lj = jdn.build_layout(hj.blocked, p, q)
    assert lp.lmax == lj.lmax
    for f in ("tile_owner_r", "tile_owner_c", "tile_slot"):
        _eq(f, getattr(lp, f), getattr(lj, f))
    perf = PerfCounters()
    sp_ = pdn.level_tables(hp.schedule, lp, perf)
    bare = jdn.DistributedLU.__new__(jdn.DistributedLU)
    bare.layout, bare.p, bare.q = lj, p, q
    bare.schedule, bare.perf = hj.schedule, hj.perf
    sj = bare._prepare_levels()
    assert len(sp_) == len(sj)
    for i, (a, b) in enumerate(zip(sp_, sj)):
        _eq(f"seg{i}.kmat", a[0], b[0])
        for k in range(2):
            _eq(f"seg{i}.mems{k}", a[1][k], b[1][k])
        assert a[2] == b[2]
        assert a[3].keys() == b[3].keys()
        for k in a[3]:
            _eq(f"seg{i}.{k}", a[3][k], b[3][k])
    for k in ("dist_panel_mib", "dist_groups"):
        assert perf.kernels.get(k) == hj.perf.kernels.get(k), k
    tp = solve_tables(hp.schedule, lp)
    ts = JDistTS(hj.blocked, hj.schedule, lj, _jax_mesh(p, q))
    for k, v in tp.items():
        _eq(f"solve.{k}", v, np.asarray(ts._tables[k]))
    # shards from the scatter plan, and back
    shards = np.stack([pdn.scatter_tiles_shard(hp.blocked, lp, r, c)
                       for r in range(p) for c in range(q)])
    full = shards.reshape((p, q) + shards.shape[1:])
    _eq("scatter_tiles", full, jdn.scatter_tiles(hj.blocked, lj))
    _eq("gather_tiles", pdn.gather_tiles(hp.blocked, lp, full),
        jdn.gather_tiles(hj.blocked, lj, full))


@settings(max_examples=60, deadline=None)
@given(sig=st.lists(st.tuples(*[st.sampled_from([0, 1, 2, 4, 8, 16, 32])
                                for _ in range(4)]), max_size=40),
       weights=st.tuples(*[st.sampled_from([0.5, 1.0, 2.0, 12.0])
                           for _ in range(4)]),
       lam=st.sampled_from([0.0, 3.0, 50.0, 400.0]))
def test_waste_aware_runs_matches_jax(sig, weights, lam):
    assert waste_aware_runs(sig, weights, lam) == jwaste(sig, weights, lam)


# ---- one rank, in this process -------------------------------------------

@pytest.mark.parametrize("ordering", ["rcm", "nd"])
def test_dist_1x1_delegates_to_single_chip(ordering):
    """p·q == 1: DistributedLU is the single-device engine (K2 or K4 by
    the dispatch rule) with its bits; force_collective runs the
    collective step (every all-reduce the identity) and matches JAX's
    force_collective engine on one device: factors, the distributed
    solve and factor_check_vector at 1e-12, two runs the same bits."""
    hp, hj = _host(10, 8, ordering)
    grid = pmesh.Grid.single("cpu")
    one = pdn.DistributedLU(hp.blocked, hp.schedule, grid)
    assert isinstance(one.single, LUFactorizer)
    single = LUFactorizer(hp.blocked, hp.schedule, device="cpu")
    assert torch.equal(one.factorize(), single.factorize())

    coll = pdn.DistributedLU(hp.blocked, hp.schedule, grid,
                             force_collective=True)
    assert coll.single is None
    tiles = coll.factorize().clone()
    assert torch.equal(coll.factorize(), tiles)
    assert coll.comm == {"all_reduces": 0, "bytes": 0}
    jd = jdn.DistributedLU(hj.blocked, hj.schedule, (1, 1),
                           mesh=_jax_mesh(1, 1), force_collective=True)
    jt = jd.factorize()
    got = pdn.gather_tiles(hp.blocked, coll.layout, tiles.numpy()[None, None])
    nt = hp.blocked.num_tiles
    np.testing.assert_allclose(got[:nt], jt[:nt], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(coll.factor_check_vector(),
                               jd.factor_check_vector(), rtol=1e-12,
                               atol=1e-12)
    bt = hp.reordering.transform_b(np.arange(1.0, hp.blocked.n + 1))
    w = DistributedTriangularSolver(hp.blocked, hp.schedule, coll.layout,
                                    grid, coll.diag).solve(coll.tiles, bt)
    wj = JDistTS(hj.blocked, hj.schedule, jd.layout, jd.mesh).solve(
        jd.dist_tiles, bt)
    np.testing.assert_allclose(w, wj, rtol=1e-12, atol=1e-12)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of world size 1 in this process, destroyed
    after the test (other tests in this worker expect none)."""
    assert multihost.distributed_init(
        "gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
        world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_mesh_without_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        pt.init(ptm.poisson2d(4), pt.InitOptions(nb=4, device="cpu",
                                                 mesh_shape=(2, 2)))


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (3, 1)])
def test_mesh_world_size_mismatch_raises(one_rank_group, shape):
    with pytest.raises(ValueError, match="world size is 1"):
        pt.init(ptm.poisson2d(4), pt.InitOptions(nb=4, device="cpu",
                                                 mesh_shape=shape))


def test_nccl_two_ranks_one_card_raises(one_rank_group, monkeypatch):
    """With backend nccl, ranks sharing a card raise before the group
    carries data (no switch to gloo)."""
    ident = ("host", "GPU-0")
    with pytest.raises(ValueError, match="ranks 0 and 1 share the card"):
        pmesh.check_one_rank_per_card([ident, ident, ("host", "GPU-1")])
    pmesh.check_one_rank_per_card([ident, ("host", "GPU-1"),
                                   ("other", "GPU-0")])
    # make_grid asks for the check under nccl
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(pmesh, "rank_device",
                        lambda device, rank: torch.device("cuda", 0))
    monkeypatch.setattr(pmesh, "card_identities", lambda dev: [ident, ident])
    with pytest.raises(ValueError, match="share the card"):
        pmesh.make_grid((1, 1), "cuda")


def test_compressed_mesh_raises():
    with pytest.raises(ValueError, match="single-device"):
        pt.init(ptm.poisson2d(4), pt.InitOptions(
            nb=4, device="cpu", mesh_shape=(1, 1),
            tile_storage="compressed"))


@pytest.mark.parametrize("mesh_shape", [(1, 1), "auto"])
def test_mesh_1x1_matches_single_device(one_rank_group, mesh_shape):
    """A grid of one rank: the API runs the single-device engines (their
    bits), and the handle keeps the whole store (trans solves work)."""
    a = ptm.poisson2d(10)
    b = a.to_scipy() @ np.ones(a.n)
    hs = pt.init(a, pt.InitOptions(nb=8, dtype="r64", device="cpu"))
    pt.gstrf(hs)
    hm = pt.init(a, pt.InitOptions(nb=8, dtype="r64", device="cpu",
                                   mesh_shape=mesh_shape, check=True))
    assert hm.opts.mesh_shape == (1, 1) and hm.grid.size == 1
    pt.gstrf(hm)
    assert torch.equal(hm.factor_tiles, hs.factor_tiles)
    assert hm.perf.kernels["gstrf_residual"] < 1e-14
    np.testing.assert_array_equal(pt.gstrs(hm, b), pt.gstrs(hs, b))
    assert residual_norm(a.to_scipy().T, pt.gstrs(hm, b, trans=True),
                         b) < 1e-12


def test_distributed_init_strict(monkeypatch):
    """Without a launcher's environment, no arguments: no group, no
    error; an explicit env:// (strict) raises."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not multihost.distributed_init("gloo")
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        multihost.distributed_init("gloo", init_method="env://")
    with pytest.raises(ValueError, match="backend"):
        multihost.distributed_init("mpi")
    assert multihost.is_primary()


# ---- many ranks, in processes ---------------------------------------------

@pytest.mark.parametrize("label", ALL_CASES)
def test_multiprocess_factors_match_jax(jobs, label):
    """The ranks' shards, assembled, are the JAX package's mesh factors;
    both gstrf checks (the port's distributed factor_check_vector) are
    tiny; the ranks agree on the tables' digest and made the same
    all-reduces (K1 one launch a group: the counts are the CUDA
    wrapper's, 0 on the CPU)."""
    name, grid, c = _case(label)
    ranks = jobs[name].ranks(label)
    ref = _jax_ref(label)
    got = _assemble(ranks, grid[1])
    nt = int(ranks[0]["num_tiles"])
    tol = FACTOR_TOL[label]
    np.testing.assert_allclose(got[:nt], ref["tiles"][:nt], rtol=tol,
                               atol=tol)
    limit = 1e-5 if "r32" in label else 1e-13
    for r in ranks:
        assert float(r["gstrf_residual"]) < limit
        assert float(r["gstrf_residual2"]) < limit
        _eq("digest", r["digest"], ranks[0]["digest"])
        assert int(r["comm_all_reduces"]) == int(ranks[0]["comm_all_reduces"])
        assert int(r["groups"]) == ref["groups"]
        assert int(r["k1_launches"]) == 0   # CPU: the plain version
    if c["complex_mode"] == "native":
        # the JAX package takes this check's w as float64
        # (pangulu_tpu/api.py:400-405) and drops its imaginary part: ~0.7
        # on these exact factors; the port's, in complex128, is above
        assert got.dtype == np.complex128
        assert float(ref["gstrf_residual"]) > 0.1
    else:
        assert float(ref["gstrf_residual"]) < limit


@pytest.mark.parametrize("label", ALL_CASES)
def test_multiprocess_solves(jobs, label):
    """gstrs of 1 and 3 right-hand sides: every rank returns the same x,
    x agrees with the JAX package's and with the true solutions; the
    refactorization after update_values reused the tables and solves."""
    name, grid, c = _case(label)
    ranks = jobs[name].ranks(label)
    ref = _jax_ref(label)
    r0 = ranks[0]
    for r in ranks[1:]:
        for k in ("x1", "x3", "x2"):
            _eq(k, r[k], r0[k])
    tol = 1e-12 if "64" in label else 1e-8
    np.testing.assert_allclose(r0["x1"], ref["x"], rtol=tol, atol=tol)
    np.testing.assert_allclose(r0["x3"], r0["x3_true"], rtol=1e-8,
                               atol=1e-8)
    limit = 1e-10 if "r32" in label else 1e-12
    for k in ("res1", "res3", "res2"):
        assert float(r0[k]) < limit, k
    assert int(r0["dist_reuse"]) == 1


@pytest.mark.parametrize("label", ["r64_nd", "r64_rcm", "r64_nb288",
                                   "cr64n_rcm"])
def test_multiprocess_check_vector(jobs, label):
    """factor_check_vector, summed over the shards without a gather,
    equals L(U·1) of the assembled factors (complex for native complex
    tiles)."""
    name, grid, c = _case(label)
    ranks = jobs[name].ranks(label)
    hp = pt.init(_matrix(c), pt.InitOptions(
        nb=c["nb"], dtype=c["dtype"], ordering=c["ordering"], device="cpu",
        complex_mode=c["complex_mode"]))
    lmat, umat = gather_factor(hp.blocked, _assemble(ranks, grid[1]))
    want = lmat @ (umat @ np.ones(hp.blocked.n))
    for r in ranks:
        np.testing.assert_allclose(r["check_w"], want, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("label", ALL_CASES)
def test_multiprocess_same_bits_and_refusals(jobs, label):
    """Two factorizations on one rank give the same bits; a sharded
    handle refuses the transpose solve, gstrs_device, save_factor and
    factor_diagnostics, naming why."""
    name, grid, c = _case(label)
    for r in jobs[name].ranks(label):
        assert bool(r["same_bits"])
        assert "NotImplementedError" in str(r["refused_trans"])
        assert "NotImplementedError" in str(r["refused_gstrs_device"])
        assert "shard" in str(r["refused_save_factor"])
        assert "shard" in str(r["refused_factor_diagnostics"])


def test_cli_mesh_under_launcher(tmp_path):
    """--mesh under torch.distributed.run: two ranks on a 1 x 2 grid,
    rank 0 alone prints the perf table and the residual; outside a
    launcher --mesh exits 2 naming it."""
    a = ptm.poisson2d(9)
    write_matrix(tmp_path / "m.mtx", a)
    env = dict(os.environ, PYTHONPATH=str(ROOT), GLOO_SOCKET_IFNAME="lo")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    args = ["-m", "pangulu_tpu_torch", "-f", str(tmp_path / "m.mtx"),
            "-nb", "8", "--dtype", "r64", "--check", "--device", "cpu",
            "--mesh", "1,2"]
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", "2"] + args,
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines() if "solve residual" in ln]
    assert len(lines) == 1, res.stdout
    assert float(lines[0].split("=")[1]) < 1e-12
    assert "engine=dist" in res.stdout and "dist_grid=1x2" in res.stdout
    res = subprocess.run([sys.executable] + args, cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2
    assert "torch.distributed.run" in res.stderr
