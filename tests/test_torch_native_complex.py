"""complex_mode="native" in the port, device="cpu": complex tiles on the
fused engine with the "torch" backend, held against the JAX package's
native complex path (its fused engine with complex tiles) on the same
matrices, right-hand sides and nb.

Contract (tests/test_torch_complex.py's test_matches_jax_native,
tests/test_end_to_end.py:145-160): the structure (permutations,
scalings, the complex values of the reordered matrix, the fused tables)
bit-equal; the factored tiles within 1e-5 (cr32) and 1e-12 (cr64); the
solutions within 1e-6 (cr32, refined) and 1e-9 (cr64) of the JAX
package's native solve; native against the real 2x2 embedding within
1e-9 at cr64.
"""

import numpy as np
import pytest
import torch

import pangulu_tpu.api as japi
import pangulu_tpu_torch as pt
from pangulu_tpu.io.checkpoint import load_factor as jload
from pangulu_tpu.io.checkpoint import save_factor as jsave
from pangulu_tpu_torch import cli
from pangulu_tpu_torch.io import load_factor, save_factor
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.utils.perf import residual_norm
from test_torch_complex import _pair, _rhs

SOLVE_TOL = {"cr32": 1e-6, "cr64": 1e-9}
FACTOR_TOL = {"cr32": 1e-5, "cr64": 1e-12}
CASES = [("rand80", 16, "auto"), ("poisson2d8", 16, "nd")]


def _native(name, dtype, nb, ordering):
    a, aj = _pair(name)
    hp = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                   device="cpu", complex_mode="native"))
    hj = japi.init(aj, japi.InitOptions(nb=nb, dtype=dtype,
                                        ordering=ordering,
                                        complex_mode="native"))
    pt.gstrf(hp)
    japi.gstrf(hj)
    return a, hp, hj


@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
@pytest.mark.parametrize("name,nb,ordering", CASES)
def test_native_matches_jax(name, nb, ordering, dtype):
    a, hp, hj = _native(name, dtype, nb, ordering)
    assert hp.complex_embed is None and hj.complex_embed is None
    assert hp.blocked.dtype == hj.blocked.dtype == np.dtype(
        {"cr32": np.complex64, "cr64": np.complex128}[dtype])
    assert hp.perf.kernels["engine"] == "fused"
    assert hp.perf.kernels["backend"] == "torch"
    assert hj._factorizer.dispatch == "fused"
    for f in ("row_scale", "col_scale", "colperm", "perm"):
        np.testing.assert_array_equal(getattr(hp.reordering, f),
                                      getattr(hj.reordering, f))
    np.testing.assert_array_equal(hp.reordering.reordered.values,
                                  hj.reordering.reordered.values)
    nt, bl = hp.blocked.num_tiles, hp.blocked.block_length
    for tp, tj in zip(hp.schedule.fused_tables(nt),
                      hj.schedule.fused_tables(nt)):
        np.testing.assert_array_equal(tp, tj)
    np.testing.assert_allclose(hp.factor_tiles[:nt].numpy(),
                               np.asarray(hj.factor_tiles)[:nt],
                               rtol=FACTOR_TOL[dtype], atol=FACTOR_TOL[dtype])
    b = np.asarray(a.to_scipy() @ (np.ones(a.n) + 0.5j))
    x, xj = pt.gstrs(hp, b), japi.gstrs(hj, b)
    assert x.dtype == np.complex128    # b's precision
    np.testing.assert_allclose(x, xj, rtol=SOLVE_TOL[dtype],
                               atol=SOLVE_TOL[dtype])
    # refined against A in the working precision (cr32: its complex64
    # values), as the refinement's residuals are
    aw = hp.a_origin.astype(np.complex128)
    assert residual_norm(aw, x, b) < 1e-10
    # many right-hand sides and the transpose solve
    b3 = _rhs(a, 3, seed=1)
    np.testing.assert_allclose(pt.gstrs(hp, b3), japi.gstrs(hj, b3),
                               rtol=SOLVE_TOL[dtype], atol=SOLVE_TOL[dtype])
    bt = _rhs(a, seed=2)
    np.testing.assert_allclose(pt.gstrs(hp, bt, trans=True),
                               japi.gstrs(hj, bt, trans=True),
                               rtol=SOLVE_TOL[dtype], atol=SOLVE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
def test_native_matches_embed(dtype):
    """The same matrix and rhs through both modes of the port: cr64
    within 1e-9 (tests/test_end_to_end.py:160), cr32 within 1e-6 after
    the default refinement of each."""
    a, _ = _pair("rand100")
    b = _rhs(a, seed=3)
    xs = [pt.Solver(a, pt.InitOptions(nb=16, dtype=dtype, device="cpu",
                                      complex_mode=mode)).solve(b)
          for mode in ("native", "embed")]
    np.testing.assert_allclose(xs[0], xs[1], rtol=SOLVE_TOL[dtype],
                               atol=SOLVE_TOL[dtype])


def test_native_refinement_default():
    """cr32 refines twice by default (complex128 residuals of A), cr64
    not at all, as the JAX package (pangulu_tpu/api.py:510-539); a
    complex64 rhs on cr32 comes back complex64."""
    a, hp, _ = _native("rand80", "cr32", 16, "auto")
    b = np.asarray(a.to_scipy() @ (np.ones(a.n) + 0.5j))
    aw = hp.a_origin.astype(np.complex128)
    assert residual_norm(aw, pt.gstrs(hp, b), b) < 1e-10 < \
        residual_norm(aw, pt.gstrs(hp, b, refine=0), b)
    assert pt.gstrs(hp, b.astype(np.complex64)).dtype == np.complex64
    _, h64, _ = _native("rand80", "cr64", 16, "auto")
    np.testing.assert_array_equal(pt.gstrs(h64, b), pt.gstrs(h64, b,
                                                             refine=0))


@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
def test_native_levels_trsm(dtype):
    """The levels engine with triangular panel solves on complex tiles
    against the fused one."""
    a, hp, _ = _native("poisson2d8", dtype, 16, "nd")
    fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                       panel_solve="trsm")
    assert fac.dispatch == "levels" and fac.backend.name == "torch"
    nt = hp.blocked.num_tiles
    np.testing.assert_allclose(fac.factorize()[:nt].numpy(),
                               hp.factor_tiles[:nt].numpy(),
                               rtol=FACTOR_TOL[dtype], atol=FACTOR_TOL[dtype])


def test_native_wide_tiles():
    """Native complex at nb = 288 (poisson3d(9) with imaginary parts)."""
    a, hp, hj = _native("poisson3d9", "cr64", 288, "rcm")
    nt = hp.blocked.num_tiles
    np.testing.assert_allclose(hp.factor_tiles[:nt].numpy(),
                               np.asarray(hj.factor_tiles)[:nt],
                               rtol=1e-12, atol=1e-12)
    b = _rhs(a, seed=4)
    np.testing.assert_allclose(pt.gstrs(hp, b), japi.gstrs(hj, b),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
def test_native_checkpoint_both_ways(tmp_path, writer, dtype):
    """Native complex factors saved by either package solve in the
    other; the loaded handle keeps complex tiles."""
    a, hp, hj = _native("rand80", dtype, 16, "auto")
    path = str(tmp_path / "f.npz")
    b = _rhs(a, seed=5)
    if writer == "jax":
        jsave(hj, path)
        h = load_factor(path, device="cpu")
        assert h.opts.complex_mode == "native" and h.complex_embed is None
        np.testing.assert_allclose(pt.gstrs(h, b), japi.gstrs(hj, b),
                                   rtol=SOLVE_TOL[dtype],
                                   atol=SOLVE_TOL[dtype])
    else:
        save_factor(hp, path)
        hl = jload(path)
        assert hl.complex_embed is None
        np.testing.assert_allclose(japi.gstrs(hl, b), pt.gstrs(hp, b),
                                   rtol=SOLVE_TOL[dtype],
                                   atol=SOLVE_TOL[dtype])


def test_native_refusals():
    """gstrs_device and factor_diagnostics refuse a native complex
    handle, as the JAX package does.  The compressed store takes native
    complex tiles since ROADMAP Queue 1 item 6 closed (its factors
    within the contract of the dense engine's, the same solution), and a
    mesh raises here only for want of a process group."""
    a, hp, _ = _native("rand80", "cr64", 16, "auto")
    with pytest.raises(NotImplementedError, match="native complex"):
        pt.gstrs_device(hp, torch.ones(a.n, dtype=torch.complex128))
    with pytest.raises(NotImplementedError, match="real dtypes"):
        pt.factor_diagnostics(hp)
    hc = pt.init(a, pt.InitOptions(nb=16, dtype="cr64", device="cpu",
                                   complex_mode="native",
                                   tile_storage="compressed"))
    pt.gstrf(hc)
    nt = hp.blocked.num_tiles
    np.testing.assert_allclose(hc.factor_tiles.to_dense()[:nt],
                               hp.factor_tiles[:nt].numpy(),
                               rtol=FACTOR_TOL["cr64"],
                               atol=FACTOR_TOL["cr64"])
    b = np.asarray(a.to_scipy() @ (np.ones(a.n) + 0.5j))
    np.testing.assert_allclose(pt.gstrs(hc, b), pt.gstrs(hp, b),
                               rtol=SOLVE_TOL["cr64"],
                               atol=SOLVE_TOL["cr64"])
    with pytest.raises(ValueError, match="process group"):
        pt.init(a, pt.InitOptions(nb=16, dtype="cr64", device="cpu",
                                  complex_mode="native", mesh_shape=(1, 2)))


def test_cli_native(tmp_path, capsys):
    """--complex-mode native through the CLI, with --save-factor and a
    --load-factor of that checkpoint."""
    from pangulu_tpu_torch.io.mmio import write_matrix

    a, _ = _pair("rand80")
    mtx = tmp_path / "c.mtx"
    write_matrix(mtx, a)
    f = str(tmp_path / "f.npz")
    assert cli.main(["-f", str(mtx), "-nb", "16", "--dtype", "cr64",
                     "--complex-mode", "native", "--device", "cpu",
                     "--save-factor", f]) == 0
    assert cli.main(["--load-factor", f, "--device", "cpu"]) == 0
    for out in capsys.readouterr().out.split("solve residual")[1:]:
        assert float(out.split("=")[1].split()[0]) < 1e-12
