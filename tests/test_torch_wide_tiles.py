"""Tiles wider than 256 through the port on the CPU (device="cpu")
against the JAX package on the same matrices: the plain twin of K1 for
wide tiles (kernels_torch.getrf_with_inverses_wide), the fused and
levels engines and their solves (numeric.py, sptrsv.py), the rest of the
surface on such a store, and checkpoints both ways.

Matrices: poisson3d(11) (n = 1,331) at nb = 288 with rcm (5 levels, a
chain) and at nb = 300 with nd, and poisson2d(40) (n = 1,600) at nb =
384 with nd; r32 and r64.  The JAX side factors with its "fused" XLA
engine (what gstrf takes off the TPU at any nb).

Tolerances (ROADMAP.md "Tolerances", tests/test_mega.py:31,82): f32
tiles rtol/atol 1e-5, f64 1e-12 (both packages run the same recursion of
the diagonal step on the CPU; the products sum in another order); f32
solutions without refinement rtol 1e-4 / atol 1e-5; refined residuals
below 1e-10 (r32) and 1e-12 (r64).  The wide twin against the JAX
recursion (which recurses to 32 and takes Newton inverses there) and
against the rank-1 scan: the f32 contract 1e-5 on all three outputs,
f64 1e-12; against the Pallas K1 (interpret mode, its whole-tile scan):
the JAX package's bound for a blocked LU against the scan
(testing.BLOCKED_TOL: f32 factor 3e-5, inverses 2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pangulu_tpu.models as jm
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as tm
from pangulu_tpu.api import InitOptions as JOpts
from pangulu_tpu.api import gstrf as jgstrf
from pangulu_tpu.api import gstrs as jgstrs
from pangulu_tpu.api import init as jinit
from pangulu_tpu.io.checkpoint import load_factor as jload
from pangulu_tpu.io.checkpoint import save_factor as jsave
from pangulu_tpu.numeric import LUFactorizer as JFactorizer
from pangulu_tpu.ops import kernels_jax as kj
from pangulu_tpu.ops import kernels_pallas as kp
from pangulu_tpu_torch.io.checkpoint import load_factor, save_factor
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.sptrsv import TriangularSolver
from pangulu_tpu_torch.testing import BLOCKED_TOL, wide_tiny_pivot_tile
from pangulu_tpu_torch.utils.perf import residual_norm

CASES = {"p3d11_rcm_288": ("poisson3d", dict(nx=11), "rcm", 288),
         "p3d11_nd_300": ("poisson3d", dict(nx=11), "nd", 300),
         "p2d40_nd_384": ("poisson2d", dict(nx=40), "nd", 384)}
TOL = {"r32": dict(rtol=1e-5, atol=1e-5), "r64": dict(rtol=1e-12,
                                                        atol=1e-12)}
TTOL = {torch.float32: TOL["r32"], torch.float64: TOL["r64"]}
SOLVE_TOL = {"r32": dict(rtol=1e-4, atol=1e-5),
             "r64": dict(rtol=1e-10, atol=1e-10)}
RESIDUAL = {"r32": 1e-10, "r64": 1e-12}


def _matrices(case):
    gen, kw, ordering, nb = CASES[case]
    return getattr(tm, gen)(**kw), getattr(jm, gen)(**kw), ordering, nb


@pytest.fixture(scope="module",
                params=[(c, d) for c in CASES for d in ("r32", "r64")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def factored(request):
    """(case, dtype, port matrix, port handle, JAX handle), both
    factored with the residual check on."""
    case, dtype = request.param
    ta, ja, ordering, nb = _matrices(case)
    hp = pt.init(ta, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                    device="cpu", check=True))
    pt.gstrf(hp)
    hj = jinit(ja, JOpts(nb=nb, dtype=dtype, ordering=ordering, check=True))
    jgstrf(hj)
    assert hj._factorizer.dispatch == "fused"
    return case, dtype, ta, hp, hj


# ---- K1's plain twin for wide tiles ----------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [288, 300, 384])
@pytest.mark.parametrize("tile", ["random", "zero pivots"])
def test_wide_twin_matches_jax_and_rank1(nb, dtype, tile):
    """The recursion with the rank-1 leaves and with K1's own leaves
    (k1_leaf: the blocked step above 128) against the JAX package's
    recursive diagonal step and against the rank-1 scan of the whole
    tile, on a random tile (the contract) and on a tile with a zero pivot
    in each half of the split, which the rule replaces by +tol in both.
    That tile's inverses hold entries of 1/tol (1e8 in f32), whose
    products round apart by up to 7e-5 between the three algorithms in
    f32: BLOCKED_TOL, the JAX package's bound for a blocked LU against
    the scan."""
    rng = np.random.default_rng(nb)
    a = (rng.standard_normal((nb, nb)) + nb * np.eye(nb) if tile == "random"
         else wide_tiny_pivot_tile(nb, rng))
    at = torch.as_tensor(a, dtype=dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    want_jax = kj.getrf_with_inverses(jnp.asarray(a, jdt))
    rank1 = kt.getrf_with_inverses(at)
    tols = ((TTOL[dtype],) * 3 if tile == "random" else
            [dict(rtol=r, atol=t) for r, t in BLOCKED_TOL[dtype]])
    for leaf in (kt.getrf_with_inverses, kt.k1_leaf):
        got = kt.getrf_with_inverses_wide(at, leaf=leaf)
        for n, g, wj, wr, tol in zip(("f", "linv", "uinv"), got, want_jax,
                                     rank1, tols):
            torch.testing.assert_close(g, torch.as_tensor(np.asarray(wj)),
                                       **tol, msg=f"{n} vs JAX")
            torch.testing.assert_close(g, wr, **tol, msg=f"{n} vs rank-1")
    if tile != "random":
        tol = float(torch.tensor(kt.DEFAULT_TOL[dtype], dtype=dtype))
        m1 = kt.wide_split(nb)
        f = kt.getrf_with_inverses_wide(at)[0]
        assert float(f[0, 0]) == tol and float(f[m1, m1]) == tol


def test_wide_twin_matches_pallas_k1():
    """The JAX package's K1 (the Pallas kernel in interpret mode, a scan
    of the whole tile) at nb = 288 in f32."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((288, 288)) + 288 * np.eye(288)
    want = kp.getrf_with_inverses(jnp.asarray(a, jnp.float32))
    got = kt.getrf_with_inverses_wide(torch.as_tensor(a, dtype=torch.float32))
    for g, w, (rtol, atol) in zip(got, want, BLOCKED_TOL[torch.float32]):
        torch.testing.assert_close(g, torch.as_tensor(np.asarray(w)),
                                   rtol=rtol, atol=atol)


def test_cpu_wrapper_takes_the_wide_twin():
    """On a CPU tensor the K1 wrapper takes the wide twin above 256."""
    a = torch.as_tensor(np.random.default_rng(5).standard_normal((300, 300))
                        + 300 * np.eye(300), dtype=torch.float32)
    for g, r in zip(kernels_cuda.getrf_with_inverses(a),
                    kt.getrf_with_inverses_wide(a)):
        assert torch.equal(g, r)


# ---- the engines -------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_structure_bit_equal(case):
    """Permutations, block structure and the fused engine's tables; the
    port's engine is fused, and its per-level entries are the JAX
    tables' rows without their padding."""
    ta, ja, ordering, nb = _matrices(case)
    hp = pt.init(ta, pt.InitOptions(nb=nb, dtype="r32", ordering=ordering,
                                    device="cpu"))
    hj = jinit(ja, JOpts(nb=nb, dtype="r32", ordering=ordering))
    for f in ("row_scale", "col_scale", "colperm", "perm"):
        np.testing.assert_array_equal(getattr(hp.reordering, f),
                                      getattr(hj.reordering, f))
    bp, bj = hp.blocked, hj.blocked
    for f in ("bcolptr", "browidx", "brownnzptr", "bcolidx", "tile_of_csr"):
        np.testing.assert_array_equal(getattr(bp, f), getattr(bj, f))
    nt, bl = bp.num_tiles, bp.block_length
    sp_, sj = hp.schedule, hj.schedule
    for tp, tj in ((sp_.fused_tables(nt), sj.fused_tables(nt)),
                   (sp_.fused_solve_tables(nt, bl),
                    sj.fused_solve_tables(nt, bl))):
        for a, b in zip(tp, tj):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sp_.fused_overhead() == sj.fused_overhead()
    fac = LUFactorizer(bp, sp_, device="cpu")
    assert fac.dispatch == "fused" and fac.backend.name == "torch"
    diag, l_ids, u_ids, dst, ul, uu = sj.fused_tables(nt)
    for i, lev in enumerate(sp_.levels):
        assert fac.levels.diag[i] == diag[i]
        for field, tab in (("lpanel", l_ids), ("upanel", u_ids),
                           ("upd_dst", dst), ("upd_l", ul),
                           ("upd_u", uu)):
            n = fac.levels.count(field, i)
            np.testing.assert_array_equal(fac.levels.of(field, i).numpy(),
                                          tab[i, :n])


def test_factor_matches_jax(factored):
    """The factored tiles against the JAX fused engine's (the scratch
    tile is not compared: the JAX tables' padding writes to it)."""
    case, dtype, _, hp, hj = factored
    nt = hp.blocked.num_tiles
    assert hp.perf.kernels["engine"] == "fused"
    assert hp.perf.kernels["backend"] == "torch"
    assert hp._factorizer.inv_tiles is None
    np.testing.assert_allclose(hp.factor_tiles[:nt].numpy(),
                               np.asarray(hj.factor_tiles)[:nt], **TOL[dtype])
    assert hp.perf.kernels["gstrf_residual"] < (1e-5 if dtype == "r32"
                                                else 1e-12)


def test_cuda_backend_twin_matches_jax(factored):
    """backend="cuda" on the CPU: the fused engine with K1's plain
    version (the wide twin, rank-1 leaves) for the diagonal step."""
    case, dtype, ta, hp, hj = factored
    fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                       backend="cuda")
    assert fac.dispatch == "fused" and fac.backend.name == "cuda"
    nt = hp.blocked.num_tiles
    np.testing.assert_allclose(fac.factorize()[:nt].numpy(),
                               np.asarray(hj.factor_tiles)[:nt], **TOL[dtype])


def test_solve_matches_jax(factored):
    """Two right-hand sides: unrefined solutions agree, and both
    packages' refined ones meet the residual bound."""
    _, dtype, ta, hp, hj = factored
    s = ta.to_scipy()
    b = np.stack([s @ np.arange(1.0, ta.n + 1),
                  s @ np.random.default_rng(1).standard_normal(ta.n)], 1)
    np.testing.assert_allclose(pt.gstrs(hp, b, refine=0),
                               jgstrs(hj, b, refine=0), **SOLVE_TOL[dtype])
    assert hp._trisolver.dispatch == "fused"
    x, xj = pt.gstrs(hp, b), jgstrs(hj, b)
    for c in range(2):
        assert residual_norm(hp.a_origin, x[:, c], b[:, c]) < RESIDUAL[dtype]
        assert residual_norm(hp.a_origin, xj[:, c], b[:, c]) < \
            RESIDUAL[dtype]


def test_transpose_solve(factored):
    _, dtype, ta, hp, hj = factored
    bt = np.asarray(ta.to_scipy().T @ np.random.default_rng(2)
                    .standard_normal(ta.n))
    np.testing.assert_allclose(pt.gstrs(hp, bt, refine=0, trans=True),
                               jgstrs(hj, bt, refine=0, trans=True),
                               **SOLVE_TOL[dtype])
    x = pt.gstrs(hp, bt, trans=True)
    assert residual_norm(hp.a_origin.T.tocsc(), x, bt) < RESIDUAL[dtype]


@pytest.mark.parametrize("dtype", ["r32", "r64"])
@pytest.mark.parametrize("case", ["p3d11_rcm_288", "p2d40_nd_384"])
def test_levels_trsm_matches_jax(case, dtype):
    """The levels engine with triangular panel solves against the JAX
    package's LUFactorizer(panel_solve="trsm") on the same blocked
    matrix (tests/test_end_to_end.py:111-130), and its solves."""
    ta, ja, ordering, nb = _matrices(case)
    hp = pt.init(ta, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                    device="cpu"))
    hj = jinit(ja, JOpts(nb=nb, dtype=dtype, ordering=ordering))
    fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                       panel_solve="trsm")
    assert fac.dispatch == "levels"
    jfac = JFactorizer(hj.blocked, hj.schedule, panel_solve="trsm")
    assert jfac.dispatch == "levels"
    nt = hp.blocked.num_tiles
    tiles = fac.factorize()
    np.testing.assert_allclose(tiles[:nt].numpy(),
                               np.asarray(jfac.factorize())[:nt],
                               **TOL[dtype])
    ts = TriangularSolver(hp.blocked, hp.schedule, device="cpu",
                          dispatch="levels")
    b = ta.to_scipy() @ np.ones(ta.n)
    w = ts.solve(tiles, hp.reordering.transform_b(b))
    x = hp.reordering.transform_x(w)
    assert residual_norm(ta.to_scipy(), x, b) < (1e-5 if dtype == "r32"
                                                 else 1e-12)


@pytest.mark.parametrize("case", ["p3d11_rcm_288", "p3d11_nd_300"])
def test_update_values_and_gstrs_device(case):
    """update_values + gstrf refactor a wide store; gstrs_device on a
    CPU tensor matches the host path, unrefined and refined once."""
    ta, _, ordering, nb = _matrices(case)
    h = pt.init(ta, pt.InitOptions(nb=nb, dtype="r32", ordering=ordering,
                                   device="cpu", check=True))
    pt.gstrf(h)
    s2 = ta.to_scipy().copy()
    s2.data = s2.data * (1.0 + 0.1 * np.random.default_rng(3).random(
        s2.nnz))
    pt.update_values(h, s2)
    pt.gstrf(h)
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    b64 = s2 @ np.random.default_rng(4).standard_normal((ta.n, 3))
    assert residual_norm(h.a_origin, pt.gstrs(h, b64[:, 0]),
                         b64[:, 0]) < 1e-10
    b = b64.astype(np.float32)
    x0 = pt.gstrs_device(h, torch.as_tensor(b))
    assert x0.dtype == torch.float32 and tuple(x0.shape) == (ta.n, 3)
    np.testing.assert_allclose(x0.numpy(), pt.gstrs(h, b, refine=0),
                               **SOLVE_TOL["r32"])
    x1 = pt.gstrs_device(h, torch.as_tensor(b), refine=1).numpy()
    for c in range(3):
        assert residual_norm(h.a_origin, x1[:, c], b[:, c]) < 5e-5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_both_ways(tmp_path, writer):
    """A JAX nb=288 checkpoint solved by the port, and the reverse."""
    ta, ja, ordering, nb = _matrices("p3d11_rcm_288")
    path = str(tmp_path / "f.npz")
    b = ta.to_scipy() @ np.arange(1.0, ta.n + 1)
    if writer == "jax":
        hj = jinit(ja, JOpts(nb=nb, dtype="r64", ordering=ordering))
        jgstrf(hj)
        jsave(hj, path)
        h = load_factor(path, device="cpu")
        assert h.blocked.nb == nb
        x = pt.gstrs(h, b)
        np.testing.assert_allclose(x, jgstrs(hj, b), rtol=1e-10, atol=1e-10)
    else:
        hp = pt.init(ta, pt.InitOptions(nb=nb, dtype="r64",
                                        ordering=ordering, device="cpu"))
        pt.gstrf(hp)
        save_factor(hp, path)
        x = jgstrs(jload(path), b)
        np.testing.assert_allclose(x, pt.gstrs(hp, b), rtol=1e-10,
                                   atol=1e-10)
    assert residual_norm(ta.to_scipy(), x, b) < 1e-12
