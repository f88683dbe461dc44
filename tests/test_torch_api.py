"""The rest of the port's public surface (device="cpu", the plain kernel
versions) against the JAX package's on the same matrices: the transpose
solve, the refactorization fast path (update_values), the
device-resident solve (gstrs_device), analyze and factor_diagnostics,
and the reordering helpers they stand on.

Tolerances (tests/test_trans_solve.py, tests/test_device_solve.py,
ROADMAP.md "Tolerances"): r32 solutions without refinement rtol 1e-4 /
atol 1e-5 against JAX's, r64 1e-10, residuals after refinement below
1e-10; structural outputs (the transformed matrix's pattern, the
transformed right-hand sides) bit-equal.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pangulu_tpu.api as japi
import pangulu_tpu.models as jm
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as tm
from pangulu_tpu_torch.sparse import CscMatrix, add_diagonal_elements
from pangulu_tpu_torch.utils.perf import residual_norm

TOL = {"r32": dict(rtol=1e-4, atol=1e-5), "r64": dict(rtol=1e-10,
                                                       atol=1e-10)}


def _pair(gen, kw, nb, dtype, ordering="auto", factor=True):
    """The same matrix through both packages: (matrix, port handle, JAX
    handle), factored unless ``factor`` is False."""
    a = getattr(tm, gen)(**kw)
    hp = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                   device="cpu"))
    hj = japi.init(getattr(jm, gen)(**kw),
                   japi.InitOptions(nb=nb, dtype=dtype, ordering=ordering))
    if factor:
        pt.gstrf(hp)
        japi.gstrf(hj)
    return a, hp, hj


@pytest.mark.parametrize("gen,kw,ordering", [
    ("random_unsymmetric", dict(n=120, density=0.05, seed=4), "auto"),
    ("circuit", dict(n=300, seed=6), "nd"),
])
def test_reordering_helpers_bit_equal(gen, kw, ordering):
    """transform_b_trans, transform_x_trans and transform_matrix give
    the JAX package's bits on its own reordering."""
    a, hp, hj = _pair(gen, kw, 16, "r64", ordering, factor=False)
    rp, rj = hp.reordering, hj.reordering
    rng = np.random.default_rng(3)
    for b in (rng.standard_normal(a.n), rng.standard_normal((a.n, 3))):
        np.testing.assert_array_equal(rp.transform_b_trans(b),
                                      rj.transform_b_trans(b))
        np.testing.assert_array_equal(rp.transform_x_trans(b),
                                      rj.transform_x_trans(b))
    s2 = a.to_scipy().copy()
    s2.data = s2.data * (1.0 + 0.1 * rng.standard_normal(s2.nnz))
    # init stores the diagonal explicitly before it reorders
    m2 = add_diagonal_elements(CscMatrix.from_scipy(s2))
    got, want = rp.transform_matrix(m2), rj.transform_matrix(m2)
    for f in ("colptr", "rowidx", "values"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.colptr, rp.reordered.colptr)
    np.testing.assert_array_equal(got.rowidx, rp.reordered.rowidx)


# tests/test_trans_solve.py:13-18, plus the grouped (nd) schedule.  The
# circuit's 1-norm condition number is ~3e14, so two right f64 solutions
# differ by up to cond * eps there: it is held by its residual only.
@pytest.mark.parametrize("gen,kw,dtype,ordering,same_x", [
    ("poisson2d", dict(nx=9), "r64", "auto", True),
    ("random_unsymmetric", dict(n=150, density=0.05, seed=3), "r64", "auto",
     True),
    ("circuit", dict(n=400, seed=6), "r64", "auto", False),
    ("random_unsymmetric", dict(n=120, density=0.05, seed=4), "r32", "auto",
     True),
    ("poisson2d", dict(nx=12), "r32", "nd", True),
])
def test_transpose_solve_matches_jax(gen, kw, dtype, ordering, same_x):
    a, hp, hj = _pair(gen, kw, 16, dtype, ordering)
    s = a.to_scipy()
    # the refinement's residuals are those of the matrix in working
    # precision (for r32, A rounded to float32), in both packages
    at = hp.a_origin.T.tocsc()
    xt = np.random.default_rng(0).standard_normal(a.n)
    bt = np.asarray(s.T @ xt)
    x0 = pt.gstrs(hp, bt, refine=0, trans=True)
    x0j = japi.gstrs(hj, bt, refine=0, trans=True)
    x = pt.gstrs(hp, bt, trans=True)
    xj = japi.gstrs(hj, bt, trans=True)
    assert residual_norm(at, x, bt) < 1e-10
    if same_x:
        np.testing.assert_allclose(x0, x0j, **TOL[dtype])
        np.testing.assert_allclose(x, xj, **TOL["r64"])
    else:
        assert residual_norm(at, x0, bt) < 2 * residual_norm(at, x0j, bt)
    # the forward solve still works on the same handle
    b = np.asarray(s @ xt)
    assert residual_norm(hp.a_origin, pt.gstrs(hp, b), b) < 1e-10


def test_transpose_solve_multi_rhs():
    """tests/test_trans_solve.py:38, and Solver.solve(trans=True)."""
    a = tm.random_unsymmetric(120, 0.06, seed=9)
    s = a.to_scipy()
    xs = np.random.default_rng(1).standard_normal((a.n, 3))
    bs = np.asarray(s.T @ xs)
    solver = pt.Solver(a, pt.InitOptions(nb=16, dtype="r64", device="cpu"))
    xg = solver.solve(bs, trans=True)
    np.testing.assert_allclose(xg, xs, rtol=1e-8, atol=1e-8)
    hj = japi.init(jm.random_unsymmetric(120, 0.06, seed=9),
                   japi.InitOptions(nb=16, dtype="r64"))
    japi.gstrf(hj)
    np.testing.assert_allclose(xg, japi.gstrs(hj, bs, trans=True),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(solver.solve(s @ xs), xs, rtol=1e-8,
                               atol=1e-8)


def test_transpose_solve_of_loaded_factor(tmp_path):
    """A checkpoint-loaded handle has no persisted inverses: the
    transpose solve recomputes them from the packed factors."""
    from pangulu_tpu_torch.io import load_factor, save_factor

    a = tm.random_unsymmetric(90, 0.06, seed=2)
    h = pt.init(a, pt.InitOptions(nb=16, dtype="r64", device="cpu"))
    pt.gstrf(h)
    save_factor(h, tmp_path / "f.npz")
    h2 = load_factor(tmp_path / "f.npz", device="cpu")
    b = np.linspace(-1.0, 1.0, a.n)
    np.testing.assert_allclose(pt.gstrs(h2, b, trans=True),
                               pt.gstrs(h, b, trans=True), rtol=1e-12,
                               atol=1e-12)


def test_transpose_solve_unsupported_paths_raise():
    """tests/test_trans_solve.py:66: compressed factors have no transpose
    solve, and nothing is solved before gstrf."""
    a = tm.poisson2d(8)
    hc = pt.init(a, pt.InitOptions(nb=8, tile_storage="compressed",
                                   device="cpu"))
    pt.gstrf(hc)
    with pytest.raises(NotImplementedError):
        pt.gstrs(hc, np.ones(a.n), trans=True)
    h = pt.init(a, pt.InitOptions(nb=8, dtype="r64", device="cpu"))
    with pytest.raises(RuntimeError, match="before gstrf"):
        pt.gstrs(h, np.ones(a.n), trans=True)


def _same_pattern_values(a, seed):
    """New values on a's pattern, kept well conditioned
    (tests/test_reuse.py:21-29)."""
    s2 = a.to_scipy().copy()
    rng = np.random.default_rng(seed)
    s2.data = s2.data + 0.3 * rng.standard_normal(s2.nnz)
    s2 = s2 + sp.identity(a.n, format="csc") * 3.0
    mask = sp.csc_matrix((np.ones(a.nnz), a.rowidx, a.colptr),
                         shape=(a.n, a.n))
    return s2.multiply(mask).tocsc()


@pytest.mark.parametrize("dtype,ordering", [("r64", "auto"),
                                            ("r32", "nd")])
def test_update_values_matches_jax(dtype, ordering):
    """tests/test_reuse.py:13: same pattern, new values, refactor."""
    a, hp, hj = _pair("random_unsymmetric", dict(n=90, density=0.06, seed=3),
                      16, dtype, ordering)
    s2 = _same_pattern_values(a, 7)
    pt.update_values(hp, s2)
    japi.update_values(hj, s2)
    for f in ("colptr", "rowidx", "values"):
        np.testing.assert_array_equal(getattr(hp.reordering.reordered, f),
                                      getattr(hj.reordering.reordered, f))
    np.testing.assert_array_equal(hp.blocked.tiles,
                                  np.asarray(hj.blocked.tiles))
    pt.gstrf(hp)
    japi.gstrf(hj)
    b2 = s2 @ np.ones(a.n)
    x = pt.gstrs(hp, b2)
    # a_origin holds the new values in working precision
    assert residual_norm(hp.a_origin, x, b2) < 1e-10
    np.testing.assert_allclose(x, japi.gstrs(hj, b2), **TOL["r64"])
    np.testing.assert_allclose(pt.gstrs(hp, b2, refine=0),
                               japi.gstrs(hj, b2, refine=0), **TOL[dtype])


def test_update_values_rejects_new_pattern():
    """tests/test_reuse.py:37; the handle is left as it was."""
    a = tm.poisson2d(8)
    h = pt.init(a, pt.InitOptions(nb=8, dtype="r64", device="cpu"))
    pt.gstrf(h)
    tiles, origin = h.factor_tiles, h.a_origin
    s2 = a.to_scipy().copy().tolil()
    s2[0, a.n - 1] = 5.0
    with pytest.raises(ValueError, match="same sparsity pattern"):
        pt.update_values(h, s2.tocsc())
    assert h.factor_tiles is tiles and h.a_origin is origin
    b = a.to_scipy() @ np.ones(a.n)
    assert residual_norm(a.to_scipy(), pt.gstrs(h, b), b) < 1e-12


def test_refactorize_drops_stale_solver_state():
    """tests/test_reuse.py:75: update_values drops the factor, the
    factorizer, the cached solver and gstrs_device's residual tables;
    the next gstrf and solves use the new values only."""
    a = tm.random_unsymmetric(60, 0.08, seed=21)
    h = pt.init(a, pt.InitOptions(nb=16, dtype="r64", device="cpu"))
    pt.gstrf(h)
    b = a.to_scipy() @ np.ones(a.n)
    pt.gstrs(h, b)
    pt.gstrs_device(h, torch.as_tensor(b), refine=1)
    assert h._trisolver is not None and h._a3_rows_dev is not None
    s2 = a.to_scipy().copy()
    s2.data = s2.data * 1.7
    pt.update_values(h, s2)
    assert (h.factor_tiles, h._factorizer, h._trisolver,
            h._a3_rows_dev) == (None, None, None, None)
    with pytest.raises(RuntimeError, match="before gstrf"):
        pt.gstrs(h, b)
    pt.gstrf(h)
    b2 = s2 @ np.ones(a.n)
    assert residual_norm(s2, pt.gstrs(h, b2), b2) < 1e-10
    x = pt.gstrs_device(h, torch.as_tensor(b2), refine=1).numpy()
    assert residual_norm(s2, x, b2) < 1e-12


def test_solver_update_values():
    a = tm.random_unsymmetric(70, 0.08, seed=5)
    solver = pt.Solver(a, nb=16, dtype="r64", device="cpu")
    b = a.to_scipy() @ np.ones(a.n)
    assert residual_norm(a.to_scipy(), solver.solve(b), b) < 1e-12
    s2 = a.to_scipy() * 2.0
    assert solver.update_values(s2) is solver
    assert residual_norm(s2, solver.solve(b), b) < 1e-12


def _device_pair(gen="poisson2d", dtype="r32", **kw):
    return _pair(gen, kw or dict(nx=12), 16, dtype)


def test_gstrs_device_matches_host_path_and_jax():
    """tests/test_device_solve.py:26: the device chain equals the host
    path; and it equals JAX's gstrs_device."""
    a, hp, hj = _device_pair()
    b = (a.to_scipy() @ np.arange(1.0, a.n + 1)).astype(np.float32)
    x = pt.gstrs_device(hp, torch.as_tensor(b))
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), pt.gstrs(hp, b, refine=0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(japi.gstrs_device(
        hj, b)), **TOL["r32"])


def test_gstrs_device_multi_rhs_and_chain():
    """tests/test_device_solve.py:34: several right-hand sides, and a
    result fed straight back in."""
    a, hp, _ = _device_pair()
    b = np.random.default_rng(3).standard_normal((a.n, 3)).astype(
        np.float32)
    x = pt.gstrs_device(hp, torch.as_tensor(b))
    assert tuple(x.shape) == (a.n, 3)
    y = pt.gstrs_device(hp, x)
    xs, ys = x.numpy(), y.numpy()
    for c in range(3):
        assert residual_norm(a.to_scipy(), xs[:, c], b[:, c]) < 5e-5
        assert residual_norm(a.to_scipy(), ys[:, c], xs[:, c]) < 5e-5


def test_gstrs_device_refine_tightens():
    """tests/test_device_solve.py:50, against JAX's refined result."""
    a, hp, hj = _device_pair(gen="trefethen", n=60)
    b = (a.to_scipy() @ np.ones(a.n)).astype(np.float32)
    x0 = pt.gstrs_device(hp, torch.as_tensor(b), refine=0).numpy()
    x2 = pt.gstrs_device(hp, torch.as_tensor(b), refine=2).numpy()
    r0 = residual_norm(a.to_scipy(), x0, b)
    r2 = residual_norm(a.to_scipy(), x2, b)
    assert r2 <= r0 * 2 and r2 < 5e-6
    np.testing.assert_allclose(x2, np.asarray(japi.gstrs_device(
        hj, b, refine=2)), **TOL["r32"])


def test_gstrs_device_after_update_values():
    """tests/test_device_solve.py:61."""
    a, hp, _ = _device_pair()
    s2 = a.to_scipy().copy()
    s2.data = s2.data * 1.5
    pt.update_values(hp, s2)
    pt.gstrf(hp)
    b = (s2 @ np.ones(a.n)).astype(np.float32)
    x = pt.gstrs_device(hp, torch.as_tensor(b), refine=1).numpy()
    assert residual_norm(s2, x, b) < 5e-5


def test_gstrs_device_r64_and_input_checks():
    """tests/test_device_solve.py:72 at r64; a host array or a tensor
    elsewhere than the handle's device is refused."""
    a, hp, _ = _device_pair(dtype="r64")
    b = a.to_scipy() @ np.arange(1.0, a.n + 1)
    x = pt.gstrs_device(hp, torch.as_tensor(b))
    assert x.dtype == torch.float64
    assert residual_norm(a.to_scipy(), x.numpy(), b) < 1e-12
    with pytest.raises(ValueError, match="tensor on cpu"):
        pt.gstrs_device(hp, b)
    with pytest.raises(ValueError, match="on meta"):
        pt.gstrs_device(hp, torch.empty(a.n, device="meta"))


def test_solve_blocked_roundtrip():
    """tests/test_device_solve.py:111: blocked in, blocked out."""
    a, hp, _ = _device_pair()
    b = (a.to_scipy() @ np.ones(a.n)).astype(np.float32)
    pt.gstrs(hp, b)
    solver = hp._trisolver
    xb = solver.blockify_rhs(hp.reordering.transform_b(b))
    w = solver.solve_blocked(hp.factor_tiles, xb)
    x = hp.reordering.transform_x(solver.unblockify(w)[:, 0])
    assert residual_norm(a.to_scipy(), x, b) < 5e-5


@pytest.mark.parametrize("dtype,ordering", [("r32", "auto"), ("r64", "nd")])
def test_analyze_matches_jax(dtype, ordering):
    """tests/test_end_to_end.py:178: the same report as JAX's, but for
    the phase times."""
    a = tm.poisson2d(12)
    opts = dict(nb=16, dtype=dtype, ordering=ordering)
    got = pt.analyze(a, pt.InitOptions(device="cpu", **opts))
    want = japi.analyze(jm.poisson2d(12), japi.InitOptions(**opts))
    assert set(got) == set(want)
    assert "reorder" in got.pop("phase_time_s")
    want.pop("phase_time_s")
    assert got == want
    item = 4 if dtype == "r32" else 8
    assert got["factor_hbm_bytes"] == (got["tiles"] + 1) * 16 * 16 * item


@pytest.mark.parametrize("gen,kw,nb,ordering", [
    # tests/test_trans_solve.py:76
    ("random_unsymmetric", dict(n=120, density=0.08, seed=5), 16, "auto"),
    # tests/test_trans_solve.py:95-113, the seeds that are not slow
    *[("random_unsymmetric", dict(n=60, density=0.12, seed=100 + s), 8, o)
      for o in ("rcm", "mindeg") for s in range(3)],
])
def test_factor_diagnostics_matches_jax(gen, kw, nb, ordering):
    """logabsdet and sign equal JAX's (rtol 1e-10) and slogdet's; with
    np.random seeded alike, the condition estimate equals JAX's and lies
    in the Hager band of the true one."""
    a, hp, hj = _pair(gen, kw, nb, "r64", ordering)
    np.random.seed(11)
    got = pt.factor_diagnostics(hp)
    np.random.seed(11)
    want = japi.factor_diagnostics(hj)
    assert got["sign"] == want["sign"]
    np.testing.assert_allclose(got["logabsdet"], want["logabsdet"],
                               rtol=1e-10)
    np.testing.assert_allclose(got["cond1_est"], want["cond1_est"],
                               rtol=1e-8)
    dense = a.to_scipy().toarray()
    sign, logdet = np.linalg.slogdet(dense)
    assert got["sign"] == sign
    assert abs(got["logabsdet"] - logdet) < 1e-6 * max(abs(logdet), 1.0)
    true_cond = (np.linalg.norm(dense, 1)
                 * np.linalg.norm(np.linalg.inv(dense), 1))
    assert 0.1 * true_cond <= got["cond1_est"] <= 3.0 * true_cond


def test_factor_diagnostics_requires_gstrf():
    h = pt.init(tm.poisson2d(4), pt.InitOptions(nb=4, device="cpu"))
    with pytest.raises(RuntimeError, match="gstrf"):
        pt.factor_diagnostics(h)
