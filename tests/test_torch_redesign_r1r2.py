"""The plain twins of the two redesigned hand kernels, on the CPU,
against the JAX package:

  * P2, the triangle inverses of a reloaded compressed factor, now
    Gauss–Jordan sweeps in float64 (``kernels_torch.triangle_inverses``,
    which the CPU wrapper ``kernels_cuda.newton_inverses`` runs): f64
    against the JAX ``unit_lower_inv_newton`` / ``upper_inv_newton`` at
    1e-12 (relative to the largest entry: a substituted tiny pivot puts
    1/tol in U^-1), f32 against the TPU probe
    ``tools/exp_batched_scan.batched_newton`` (interpret mode) at rtol /
    atol 1e-5, as tests/test_torch_compressed.py holds the doubling;
  * K1's blocked step at nb > 128, now in panels of 32
    (``kernels_torch.getrf_with_inverses_blocked``): against the JAX
    Pallas ``getrf_with_inverses(inv="blocked32")`` (interpret mode) in
    f32 at factor 3e-5, inverses 2e-4 (tests/test_pallas.py:79-99), and
    against the rank-1 plain version in f64 at 1e-12;
  * a compressed save -> load -> gstrs round trip (the reload runs P2's
    twin) against the JAX package's solve at rtol 1e-4 / atol 1e-5.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pangulu_tpu.api as japi
import pangulu_tpu.models as jm
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as tm
from pangulu_tpu.ops import kernels_pallas
from pangulu_tpu.ops.kernels_jax import (unit_lower_inv_newton,
                                         upper_inv_newton)
from pangulu_tpu_torch.io.mmio import generated_rhs
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.testing import (BLOCKED_TOL, blocked_tiny_pivot_tile,
                                       diag_step)


def _factored(nb, seed, batch=3):
    """Factored diagonal tiles (f64), the second with a zero pivot at nb
    // 2 that the tiny-pivot rule substitutes."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((batch, nb, nb)) / nb + 2 * np.eye(nb)
    f[1, nb // 2, nb // 2] = 0.0
    return f


# ---- P2 ---------------------------------------------------------------

@pytest.mark.parametrize("nb", [16, 128, 200])
def test_triangle_inverses_f64_matches_jax(nb):
    """The sweeps against the JAX package's doubling, a tiny pivot
    included; above 128 through the split and its two products."""
    f = _factored(nb, nb)
    tol = kt.DEFAULT_TOL[torch.float64]
    linv, uinv = kt.triangle_inverses(torch.from_numpy(f), tol)
    jl = np.asarray(jax.vmap(unit_lower_inv_newton)(jnp.asarray(f)))
    ju = np.asarray(jax.vmap(lambda x: upper_inv_newton(x, tol))(
        jnp.asarray(f)))
    np.testing.assert_allclose(linv.numpy(), jl, rtol=1e-12,
                               atol=1e-12 * np.abs(jl).max())
    np.testing.assert_allclose(uinv.numpy(), ju, rtol=1e-12,
                               atol=1e-12 * np.abs(ju).max())
    assert float(uinv[1, nb // 2, nb // 2]) == 1.0 / tol


def test_triangle_inverses_f32_matches_tpu_probe(monkeypatch):
    """The f32 sweep against the TPU probe's batched Newton inverse of
    unit-lower tiles, in interpret mode."""
    import tools.exp_batched_scan as probe

    real = probe.pl.pallas_call
    monkeypatch.setattr(probe.pl, "pallas_call", lambda *a, **kw: real(
        *a, **{**kw, "interpret": True}))
    rng = np.random.default_rng(1)
    g, nb = 4, 16
    lm = (np.tril(rng.standard_normal((g, nb, nb)), -1) / nb
          + np.eye(nb)).astype(np.float32)
    want = np.asarray(probe.batched_newton(
        jnp.asarray(lm), g=g, nb=nb, steps=kt.newton_steps(nb)))
    got = kt.triangle_inverses(torch.from_numpy(lm))[0]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nb", [16, 128, 256])
def test_cpu_wrapper_runs_the_sweeps(nb):
    """On a CPU tensor P2's wrapper is the sweep twin, bit for bit, and
    agrees with the doubling it replaces at f64."""
    f = torch.from_numpy(_factored(nb, 7 * nb))
    got = kernels_cuda.newton_inverses(f)
    for g, s, n in zip(got, kt.triangle_inverses(f), kt.newton_inverses(f)):
        assert torch.equal(g, s)
        torch.testing.assert_close(g, n, rtol=1e-12,
                                   atol=1e-12 * float(n.abs().max()))


def test_triangle_inverses_invert():
    """L^-1 L = I and U^-1 U = I in f32 (computed in f64, rounded once),
    with the tiny pivot's substitute on U's diagonal."""
    f = torch.from_numpy(_factored(64, 3)).float()
    tol = kt.DEFAULT_TOL[torch.float32]
    linv, uinv = kt.triangle_inverses(f)
    eye = torch.eye(64, dtype=torch.float64)
    lo = torch.tril(f.double(), -1) + eye
    up = torch.triu(f.double())
    up[1, 32, 32] = tol
    torch.testing.assert_close(linv.double() @ lo, eye.expand_as(lo),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(up[0] @ uinv[0].double(), eye, rtol=0,
                               atol=1e-6)


def test_triangle_inverses_rejects_bad_shape():
    with pytest.raises(ValueError, match=r"\[B, nb, nb\]"):
        kt.triangle_inverses(torch.eye(4))


# ---- K1's blocked step in panels of 32 ---------------------------------

# the Pallas mode takes whole panels only (nb a multiple of 32)
@pytest.mark.parametrize("nb", [160, 256])
def test_blocked32_matches_pallas(nb):
    """The panel-32 twin against the JAX Pallas blocked32 mode (interpret
    mode): the same blocking, so the JAX package's own bound for its
    blocked LU against the scan holds between them."""
    rng = np.random.default_rng(nb)
    a = (rng.standard_normal((nb, nb)) + nb * np.eye(nb)).astype(np.float32)
    want = kernels_pallas.getrf_with_inverses(jnp.asarray(a),
                                              inv="blocked32")
    got = kt.getrf_with_inverses_blocked(torch.from_numpy(a))
    for g, w, tol in zip(got, want, (3e-5, 2e-4, 2e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("nb", [129, 200, 256])
def test_blocked32_matches_rank1_f64(nb):
    rng = np.random.default_rng(3 * nb)
    a = torch.as_tensor(rng.standard_normal((2, nb, nb)) + nb * np.eye(nb))
    for g, r in zip(kt.getrf_with_inverses_blocked(a),
                    kt.getrf_with_inverses(a)):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k1", [0, 5, 64])
def test_blocked32_tiny_pivots(dtype, k1):
    """Zero pivots in the first panel (a copy of row 0, or a zero row)
    and in later panels become +tol at the same steps as in the rank-1
    scan, and the results agree at the blocked-LU bound."""
    nb, k2 = 256, 99
    a = torch.as_tensor(blocked_tiny_pivot_tile(
        nb, k1, k2, np.random.default_rng(k1)), dtype=dtype)
    got = kt.getrf_with_inverses_blocked(a)
    tol = float(torch.tensor(kt.DEFAULT_TOL[dtype], dtype=dtype))
    k = kt.LU_SPLIT + k2
    assert float(got[0][k1, k1]) == tol and float(got[0][k, k]) == tol
    for g, r, (rtol, atol) in zip(got, kt.getrf_with_inverses(a),
                                  BLOCKED_TOL[dtype]):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("r", [8, 32, 64])
def test_blocked_any_panel_width(r):
    """The twin at other panel widths is the same function."""
    rng = np.random.default_rng(r)
    a = torch.as_tensor(rng.standard_normal((160, 160)) + 160 * np.eye(160))
    for g, w in zip(kt.getrf_with_inverses_blocked(a, r=r),
                    kt.getrf_with_inverses(a)):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


# ---- the slice: a reloaded compressed factor ---------------------------

@pytest.mark.parametrize("nx,nb", [(12, 16), (20, 32)])
def test_compressed_reload_solve_matches_jax(tmp_path, nx, nb):
    """save_factor -> load_factor -> gstrs of a compressed r32 factor:
    the reload forms its inverses with P2's twin (one launch counted on
    the card, none here), and its solution agrees with the JAX
    package's solve of the same matrix."""
    from pangulu_tpu_torch.io import load_factor, save_factor

    a, aj = tm.poisson2d(nx), jm.poisson2d(nx)
    b = generated_rhs(a)
    opts = dict(nb=nb, dtype="r32", ordering="rcm",
                tile_storage="compressed")
    h = pt.init(a, pt.InitOptions(device="cpu", **opts))
    pt.gstrf(h)
    save_factor(h, tmp_path / "f.npz")
    h2 = load_factor(tmp_path / "f.npz", device="cpu")
    assert h2._factorizer.inv_tiles is None
    x = pt.gstrs(h2, b)
    assert h2._factorizer.inv_tiles is not None
    hj = japi.init(aj, japi.InitOptions(**opts))
    xj = japi.gssv(hj, b)
    np.testing.assert_allclose(x, xj, rtol=1e-4, atol=1e-5)


def test_diag_step_cpu_is_the_plain_k1():
    """K4's diagonal step alone on the CPU: the tiles ids factored in
    place by the rank-1 plain version, inverses at inv_ids, the other
    tiles and slots untouched."""
    rng = np.random.default_rng(4)
    tiles = torch.as_tensor(rng.standard_normal((6, 40, 40))
                            + 40 * np.eye(40))
    before = tiles.clone()
    invs = torch.zeros((4, 2, 40, 40), dtype=torch.float64)
    ids = torch.tensor([4, 1], dtype=torch.int32)
    slots = torch.tensor([3, 0], dtype=torch.int32)
    diag_step(tiles, ids, invs, slots)
    f, linv, uinv = kt.getrf_with_inverses(before[[4, 1]])
    assert torch.equal(tiles[[4, 1]], f)
    assert torch.equal(invs[[3, 0], 0], linv)
    assert torch.equal(invs[[3, 0], 1], uinv)
    assert torch.equal(tiles[[0, 2, 3, 5]], before[[0, 2, 3, 5]])
    assert not invs[[1, 2]].any()
