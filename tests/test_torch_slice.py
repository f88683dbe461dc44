"""The whole slice, init -> gstrf -> gstrs, of the port (device="cpu",
plain kernel versions) against the JAX package on the same matrices,
and factors carried across the two packages through the checkpoint
format.

Tolerances: the JAX CPU path factors with its "fused" XLA engine, so
f32 factored tiles agree to the f32 contract rtol/atol 1e-5
(tests/test_mega.py:31); f32 solutions after the default two rounds of
f64 refinement, and all f64 results, agree to 1e-10 / 1e-12 (both sides
reach the f64 residual floor); residuals are the reference's acceptance
bounds (ROADMAP.md "Tolerances").
"""

import numpy as np
import pytest

import pangulu_tpu_torch as pt
from pangulu_tpu.api import InitOptions as JOpts
from pangulu_tpu.api import gstrf as jgstrf
from pangulu_tpu.api import gstrs as jgstrs
from pangulu_tpu.api import init as jinit
from pangulu_tpu.io.checkpoint import load_factor as jload_factor
from pangulu_tpu.io.checkpoint import save_factor as jsave_factor
import pangulu_tpu.models as jm
import pangulu_tpu_torch.models as tm
from pangulu_tpu_torch.io import load_factor, save_factor
from pangulu_tpu_torch.utils.perf import residual_norm

CASES = [
    # id, generator name, kwargs, nb, dtype, ordering, solve tol
    ("poisson2d8_r32", "poisson2d", dict(nx=8), 16, "r32", "rcm", 1e-10),
    ("trefethen20_r64", "trefethen", dict(n=20), 10, "r64", "auto", 1e-12),
]


def _pair(gen, kw):
    return getattr(tm, gen)(**kw), getattr(jm, gen)(**kw)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_slice_matches_jax(case):
    _, gen, kw, nb, dtype, ordering, tol = case
    ta, ja = _pair(gen, kw)
    b = ta.to_scipy() @ np.arange(1.0, ta.n + 1)
    hp = pt.init(ta, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                    device="cpu", check=True))
    pt.gstrf(hp)
    xp = pt.gstrs(hp, b)
    hj = jinit(ja, JOpts(nb=nb, dtype=dtype, ordering=ordering,
                         check=True))
    jgstrf(hj)
    xj = jgstrs(hj, b)
    nt = hp.blocked.num_tiles
    ftol = (dict(rtol=1e-5, atol=1e-5) if dtype == "r32"
            else dict(rtol=1e-12, atol=1e-12))
    np.testing.assert_allclose(hp.factor_tiles[:nt].numpy(),
                               np.asarray(hj.factor_tiles)[:nt], **ftol)
    gres = 1e-5 if dtype == "r32" else 1e-12
    assert hp.perf.kernels["gstrf_residual"] < gres
    assert residual_norm(ta.to_scipy(), xp, b) < tol
    np.testing.assert_allclose(xp, xj, rtol=tol * 10, atol=0)
    # multi-RHS through the same handle
    B = np.stack([b, -2 * b, b + 1], axis=1)
    X = pt.gstrs(hp, B)
    assert X.shape == B.shape
    for j in range(3):
        assert residual_norm(ta.to_scipy(), X[:, j], B[:, j]) < tol


def test_r64_reference_config_1():
    """The reference's config 1: trefethen(20), nb=10, r64."""
    a = tm.trefethen(20)
    b = a.to_scipy() @ np.ones(a.n)
    x = pt.Solver(a, pt.InitOptions(nb=10, dtype="r64",
                                    device="cpu")).solve(b)
    assert residual_norm(a.to_scipy(), x, b) < 1e-12
    np.testing.assert_allclose(x, np.ones(a.n), rtol=1e-10)


def test_spsolve_and_gssv():
    a = tm.poisson2d(6)
    b = a.to_scipy() @ np.ones(a.n)
    x = pt.spsolve(a, b, nb=8, dtype="r64", device="cpu")
    assert residual_norm(a.to_scipy(), x, b) < 1e-12
    h = pt.init(a, pt.InitOptions(nb=8, dtype="r32", device="cpu"))
    x = pt.gssv(h, b)
    assert residual_norm(a.to_scipy(), x, b) < 1e-10
    pt.finalize(h)
    with pytest.raises(RuntimeError, match="before gstrf"):
        pt.gstrs(h, b)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_jax_factor_solved_by_port(case, tmp_path):
    """JAX save_factor -> port load_factor -> gstrs equals JAX gstrs on
    the same b.  The port recomputes the triangle inverses from the
    loaded packed factors."""
    _, gen, kw, nb, dtype, ordering, tol = case
    _, ja = _pair(gen, kw)
    hj = jinit(ja, JOpts(nb=nb, dtype=dtype, ordering=ordering))
    jgstrf(hj)
    path = tmp_path / "f.npz"
    jsave_factor(hj, path)
    b = ja.to_scipy() @ np.linspace(-1.0, 2.0, ja.n)
    xj = jgstrs(hj, b)
    hp = load_factor(path, device="cpu")
    np.testing.assert_array_equal(hp.factor_tiles.numpy(),
                                  np.asarray(hj.factor_tiles))
    xp = pt.gstrs(hp, b)
    assert residual_norm(ja.to_scipy(), xp, b) < tol
    np.testing.assert_allclose(xp, xj, rtol=tol * 10, atol=tol)


def test_port_factor_read_by_jax(tmp_path):
    """The port writes the same format: JAX load_factor solves it."""
    a = tm.trefethen(20)
    h = pt.init(a, pt.InitOptions(nb=10, dtype="r64", device="cpu"))
    pt.gstrf(h)
    path = tmp_path / "p.npz"
    save_factor(h, path)
    b = a.to_scipy() @ np.ones(a.n)
    xj = jgstrs(jload_factor(path), b)
    xp = pt.gstrs(load_factor(path, device="cpu"), b)
    np.testing.assert_allclose(xj, np.ones(a.n), rtol=1e-10)
    np.testing.assert_allclose(xp, xj, rtol=1e-12)
