"""nb=256, the C reference's default block size, through the port on the
CPU (device="cpu", the plain kernel versions) against the JAX package on
the same matrices: the host structure at nb=256 bit for bit (its Schur
chunk width mega_uch(256) = 16 included), the factored tiles and
inverses, the solves, the rest of the surface on an nb=256 store, and
the plain twin of K1's blocked step for 128 < nb <= 256 against the
rank-1 reference semantics.

One rcm and one nd matrix: poisson3d(12) (n = 1,728, 7 levels, a chain)
and poisson2d(48) (n = 2,304, whose nd schedule packs 9 levels into 4
groups).  The JAX side factors with its "fused" XLA engine (what gstrf
takes off the TPU).  Tolerances (ROADMAP.md "Tolerances",
tests/test_mega.py:31,82, tests/test_mega_group.py:66,140): f32 tiles
and inverses rtol/atol 1e-5, the grouped engine's 2e-4 (a group's
updates are summed in another order), f64 1e-12; the inverses against
JAX's Newton-Schulz ones from the same factors (an equally exact other
algorithm); f32 solutions without refinement rtol 1e-4 / atol 1e-5,
residuals after refinement below 1e-10 (r32) and 1e-12 (r64).  The
blocked step against the rank-1 scan: f32 factor 3e-5, inverses 2e-4,
the JAX package's bound for its own blocked LU (tests/test_pallas.py:
79-99), f64 1e-12.
"""

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
from pangulu_tpu.ops.kernels_pallas import mega_uch as jmega_uch
from pangulu_tpu.sptrsv import TriangularSolver as JSolver
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.testing import BLOCKED_TOL, blocked_tiny_pivot_tile
from pangulu_tpu_torch.utils.perf import residual_norm

NB = 256
CASES = {"p3d12_rcm": ("poisson3d", dict(nx=12), "rcm"),
         "p2d48_nd": ("poisson2d", dict(nx=48), "nd")}
FACTOR_TOL = {("rcm", "r32"): dict(rtol=1e-5, atol=1e-5),
              ("nd", "r32"): dict(rtol=2e-4, atol=2e-4),
              ("rcm", "r64"): dict(rtol=1e-12, atol=1e-12),
              ("nd", "r64"): dict(rtol=1e-12, atol=1e-12)}
SOLVE_TOL = {"r32": dict(rtol=1e-4, atol=1e-5),
             "r64": dict(rtol=1e-10, atol=1e-10)}
RESIDUAL = {"r32": 1e-10, "r64": 1e-12}


def _matrices(case):
    gen, kw, ordering = CASES[case]
    return getattr(tm, gen)(**kw), getattr(jm, gen)(**kw), ordering


@pytest.fixture(scope="module",
                params=[(c, d) for c in CASES for d in ("r32", "r64")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def factored(request):
    """(case, dtype, port matrix, port handle, JAX handle), both
    factored at nb=256 with the residual check on."""
    case, dtype = request.param
    ta, ja, ordering = _matrices(case)
    hp = pt.init(ta, pt.InitOptions(nb=NB, dtype=dtype, ordering=ordering,
                                    device="cpu", check=True))
    pt.gstrf(hp)
    hj = jinit(ja, JOpts(nb=NB, dtype=dtype, ordering=ordering, check=True))
    jgstrf(hj)
    assert hj._factorizer.dispatch == "fused"
    return case, dtype, ta, hp, hj


@pytest.mark.parametrize("nb", [16, 128, 129, 200, 256, 512])
def test_mega_uch_matches_jax(nb):
    assert kt.mega_uch(nb) == jmega_uch(nb)


@pytest.mark.parametrize("case", list(CASES))
def test_structure_bit_equal(case):
    """Permutations, block structure, tile ids and every kernel table at
    nb=256, with the factorizer's own tables at uch = 16."""
    ta, ja, ordering = _matrices(case)
    hp = pt.init(ta, pt.InitOptions(nb=NB, dtype="r32", ordering=ordering,
                                    device="cpu"))
    hj = jinit(ja, JOpts(nb=NB, dtype="r32", ordering=ordering))
    for f in ("row_scale", "col_scale", "colperm", "perm"):
        np.testing.assert_array_equal(getattr(hp.reordering, f),
                                      getattr(hj.reordering, f))
    bp, bj = hp.blocked, hj.blocked
    assert (bp.nb, bp.block_length, bp.num_tiles) == (
        bj.nb, bj.block_length, bj.num_tiles)
    for f in ("bcolptr", "browidx", "brownnzptr", "bcolidx", "tile_of_csr"):
        np.testing.assert_array_equal(getattr(bp, f), getattr(bj, f))
    nt, uch = bp.num_tiles, kt.mega_uch(NB)
    assert uch == 16
    sp_, sj = hp.schedule, hj.schedule
    for name, tp, tj in (
            ("mega_tables", sp_.mega_tables(nt, uch=uch),
             sj.mega_tables(nt, uch=uch)),
            ("group_mega_tables", sp_.group_mega_tables(nt, uch=uch),
             sj.group_mega_tables(nt, uch=uch)),
            ("mega_solve_tables", sp_.mega_solve_tables(nt),
             sj.mega_solve_tables(nt)),
            ("group_solve_tables", sp_.group_solve_tables(nt),
             sj.group_solve_tables(nt))):
        assert tp.keys() == tj.keys(), name
        for k in tp:
            a, b = np.asarray(tp[k]), np.asarray(tj[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (name, k)
            assert np.array_equal(a, b), (name, k)
    fac = LUFactorizer(bp, sp_, device="cpu")
    grouped = ordering == "nd"
    assert fac.dispatch == ("mega_group" if grouped else "mega")
    if grouped:
        assert fac.tables.host["ngroups"] < sp_.block_length
        want = sj.group_mega_tables(nt, uch=uch, gmax=fac.GROUP_GMAX)
    else:
        want = sj.mega_tables(nt, uch=uch)
    for k, v in want.items():
        assert np.array_equal(np.asarray(fac.tables.host[k]), np.asarray(v))


def test_factor_matches_jax(factored):
    """The factored tiles against the fused engine's, the persisted
    inverses against JAX's Newton inverses of the same diagonal tiles."""
    case, dtype, _, hp, hj = factored
    ordering = CASES[case][2]
    nt = hp.blocked.num_tiles
    tol = FACTOR_TOL[(ordering, dtype)]
    np.testing.assert_allclose(hp.factor_tiles[:nt].numpy(),
                               np.asarray(hj.factor_tiles)[:nt], **tol)
    jinv = JSolver(hj.blocked, hj.schedule)._ensure_inverses(
        hj.factor_tiles)
    np.testing.assert_allclose(hp._factorizer.inv_tiles.numpy(),
                               np.asarray(jinv), **tol)
    assert hp.perf.kernels["gstrf_residual"] < (1e-5 if dtype == "r32"
                                                else 1e-12)


def test_solve_matches_jax(factored):
    """Two right-hand sides: unrefined solutions agree, and both
    packages' refined ones meet the residual bound."""
    _, dtype, ta, hp, hj = factored
    s = ta.to_scipy()
    b = np.stack([s @ np.arange(1.0, ta.n + 1),
                  s @ np.random.default_rng(1).standard_normal(ta.n)], 1)
    np.testing.assert_allclose(pt.gstrs(hp, b, refine=0),
                               jgstrs(hj, b, refine=0), **SOLVE_TOL[dtype])
    x, xj = pt.gstrs(hp, b), jgstrs(hj, b)
    for c in range(2):
        assert residual_norm(hp.a_origin, x[:, c], b[:, c]) < RESIDUAL[dtype]
        assert residual_norm(hp.a_origin, xj[:, c], b[:, c]) < \
            RESIDUAL[dtype]


def test_transpose_solve_nb256(factored):
    """gstrs(trans=True) on an nb=256 store: the unrefined solution is
    JAX's, the refined one solves A^T x = b."""
    _, dtype, ta, hp, hj = factored
    bt = np.asarray(ta.to_scipy().T @ np.random.default_rng(2)
                    .standard_normal(ta.n))
    np.testing.assert_allclose(pt.gstrs(hp, bt, refine=0, trans=True),
                               jgstrs(hj, bt, refine=0, trans=True),
                               **SOLVE_TOL[dtype])
    x = pt.gstrs(hp, bt, trans=True)
    assert residual_norm(hp.a_origin.T.tocsc(), x, bt) < RESIDUAL[dtype]


@pytest.mark.parametrize("case", list(CASES))
def test_update_values_nb256(case):
    """update_values + gstrf refactor an nb=256 store: the new factor
    solves the new matrix."""
    ta, _, ordering = _matrices(case)
    h = pt.init(ta, pt.InitOptions(nb=NB, dtype="r32", ordering=ordering,
                                   device="cpu", check=True))
    pt.gstrf(h)
    s2 = ta.to_scipy().copy()
    s2.data = s2.data * (1.0 + 0.1 * np.random.default_rng(3).random(
        s2.nnz))
    pt.update_values(h, s2)
    pt.gstrf(h)
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    b = s2 @ np.ones(ta.n)
    assert residual_norm(h.a_origin, pt.gstrs(h, b), b) < 1e-10


@pytest.mark.parametrize("case", list(CASES))
def test_gstrs_device_nb256(case):
    """gstrs_device on a tensor of the handle's device (the CPU here) at
    nb=256 matches the host path, unrefined and refined once."""
    ta, _, ordering = _matrices(case)
    h = pt.init(ta, pt.InitOptions(nb=NB, dtype="r32", ordering=ordering,
                                   device="cpu"))
    pt.gstrf(h)
    b = (ta.to_scipy() @ np.random.default_rng(4).standard_normal(
        (ta.n, 3))).astype(np.float32)
    x0 = pt.gstrs_device(h, torch.as_tensor(b))
    assert x0.dtype == torch.float32 and tuple(x0.shape) == (ta.n, 3)
    np.testing.assert_allclose(x0.numpy(), pt.gstrs(h, b, refine=0),
                               **SOLVE_TOL["r32"])
    x1 = pt.gstrs_device(h, torch.as_tensor(b), refine=1).numpy()
    for c in range(3):
        assert residual_norm(h.a_origin, x1[:, c], b[:, c]) < 5e-5


# ---- K1's blocked step (the plain twin of the kernel for nb > 128) ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [129, 200, 256])
def test_getrf_blocked_matches_rank1(nb, dtype):
    """A batch of a random tile and two tiles with two zero pivots each,
    reached by elimination, one at k1 (at a panel's start, 64, or inside
    the first panel, 5) and one past the first 128 steps: the blocked
    step's (f, L^-1, U^-1) are the rank-1 scan's, and the tiny-pivot
    rule fires at the same steps."""
    rng = np.random.default_rng(nb)
    k1s, k2 = (64, 5), (nb - kt.LU_SPLIT) // 2
    a = torch.as_tensor(np.stack(
        [rng.standard_normal((nb, nb)) + nb * np.eye(nb)]
        + [blocked_tiny_pivot_tile(nb, k1, k2, rng) for k1 in k1s]),
        dtype=dtype)
    got = kt.getrf_with_inverses_blocked(a)
    ref = kt.getrf_with_inverses(a)
    for g, r, (rtol, atol) in zip(got, ref, BLOCKED_TOL[dtype]):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)
    tol = float(torch.tensor(kt.DEFAULT_TOL[dtype], dtype=dtype))
    k = kt.LU_SPLIT + k2
    for m, k1 in enumerate(k1s, 1):
        assert float(got[0][m, k1, k1]) == tol
        assert float(got[0][m, k, k]) == tol
    # the packed factor reconstructs A, and L^-1 inverts L
    f = got[0].double()
    eye = torch.eye(nb, dtype=torch.float64)
    lo = torch.tril(f, -1) + eye
    torch.testing.assert_close(lo[0] @ torch.triu(f)[0], a[0].double(),
                               rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got[1][0].double() @ lo[0], eye,
                               rtol=0, atol=1e-4)


def test_blocked_split_must_lie_inside():
    with pytest.raises(ValueError, match="split"):
        kt.getrf_with_inverses_blocked(torch.eye(128), r=128)


def test_cpu_wrapper_takes_the_plain_version_at_nb256():
    """On a CPU tensor the K1 wrapper is the rank-1 plain version, at
    nb=256 as below it (the card runs the blocked step)."""
    a = torch.as_tensor(np.random.default_rng(5).standard_normal((256, 256))
                        + 256 * np.eye(256), dtype=torch.float32)
    for g, r in zip(kernels_cuda.getrf_with_inverses(a),
                    kt.getrf_with_inverses(a)):
        assert torch.equal(g, r)
