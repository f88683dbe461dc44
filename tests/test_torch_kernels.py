"""The plain PyTorch versions of the three kernels on the main path
against the JAX package's kernels, on the same inputs.

The JAX Pallas kernels run as tests/test_mega.py runs them: in Pallas
interpret mode off the TPU.  Inputs are made with numpy from a seed and
handed to both.  Tolerances are the JAX package's own contract
(ROADMAP.md "Tolerances", tests/test_mega.py:31,82): f32 tiles and
inverses rtol/atol 1e-5 (different but equally exact inverse
algorithms: Newton-Schulz there, triangular solves here), f32 solves
rtol 1e-4 / atol 1e-5, f64 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pangulu_tpu_torch as pt
from pangulu_tpu.api import InitOptions as JOpts, init as jinit
from pangulu_tpu.models import poisson2d as jpoisson2d
from pangulu_tpu.models import random_unsymmetric as jrandom
from pangulu_tpu.numeric import LUFactorizer as JFactorizer
from pangulu_tpu.ops import kernels_jax, kernels_pallas
from pangulu_tpu.ops.interface import get_backend
from pangulu_tpu_torch.models import poisson2d, random_unsymmetric
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.ops import kernels_torch as kt

F32 = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)
SOLVE_F32 = dict(rtol=1e-4, atol=1e-5)


def _tile(nb, seed, dtype):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nb, nb)) + nb * np.eye(nb)).astype(dtype)


@pytest.mark.parametrize("nb", [8, 16, 32])
def test_getrf_with_inverses_f32_vs_pallas(nb):
    a = _tile(nb, nb, np.float32)
    ref = kernels_pallas.getrf_with_inverses(jnp.asarray(a))
    got = kt.getrf_with_inverses(torch.from_numpy(a))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32)


@pytest.mark.parametrize("nb", [10, 64])
def test_getrf_with_inverses_f64_vs_jax(nb):
    a = _tile(nb, nb + 1, np.float64)
    ref = kernels_jax.getrf_with_inverses(jnp.asarray(a))
    got = kt.getrf_with_inverses(torch.from_numpy(a))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F64)


def test_getrf_batched_equals_single():
    a = np.stack([_tile(16, s, np.float32) for s in range(3)])
    f, li, ui = kt.getrf_with_inverses(torch.from_numpy(a))
    for i in range(3):
        for g, r in zip((f[i], li[i], ui[i]),
                        kt.getrf_with_inverses(torch.from_numpy(a[i]))):
            assert torch.equal(g, r)


def test_getrf_tiny_pivot_rule():
    """|pivot| < tol -> +tol on U's diagonal (kernels_jax.py:43-44), as
    the Pallas kernel does."""
    a = np.eye(8, dtype=np.float32)
    a[2, 2] = 0.0
    a[5, 5] = -1e-12
    ref = kernels_pallas.getrf_with_inverses(jnp.asarray(a))
    got = kt.getrf_with_inverses(torch.from_numpy(a))
    assert float(got[0][2, 2]) == pytest.approx(1e-8)
    assert float(got[0][5, 5]) == pytest.approx(1e-8)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32)


def _jax_mega(h, uch):
    t = {k: (v if isinstance(v, int) else jnp.asarray(v))
         for k, v in h.schedule.mega_tables(h.blocked.num_tiles,
                                            uch=uch).items()}
    return kernels_pallas.mega_factorize(
        h.blocked.device_tiles(), t["diag_tab"], t["nl_tab"], t["nu_tab"],
        t["nup_tab"], t["lid_tab"], t["uid_tab"], t["udst_tab"],
        t["udl_tab"], t["udu_tab"], nb=h.blocked.nb,
        tol=float(kernels_jax.DEFAULT_TOL[jnp.dtype(np.float32)]),
        bl=h.schedule.block_length, pch=t["pch"], uch=t["uch"])


@pytest.mark.parametrize("uch", [kt.MEGA_UCH, 4])
def test_mega_factorize_vs_pallas(uch):
    """The test_mega.py:18 case (random_unsymmetric(96), nb=16, rcm,
    r32); uch=4 splits levels into several update chunks."""
    hj = jinit(jrandom(96, 0.06, seed=5),
               JOpts(nb=16, dtype="r32", ordering="rcm"))
    tj, ij = _jax_mega(hj, uch)
    hp = pt.init(random_unsymmetric(96, 0.06, seed=5),
                 pt.InitOptions(nb=16, dtype="r32", ordering="rcm",
                                device="cpu"))
    nt, bl = hp.blocked.num_tiles, hp.schedule.block_length
    if uch == kt.MEGA_UCH:
        fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu")
        tp, ip = fac.factorize(), fac.inv_tiles
    else:
        tables = kt.KernelTables.build(hp.schedule.mega_tables(nt, uch=uch),
                                       "cpu")
        assert tables.host["udst_tab"].shape[1] > 1
        tp, ip = kt.mega_factorize(hp.blocked.device_tiles("cpu"), tables,
                                   nb=16, tol=1e-8, bl=bl)
    np.testing.assert_allclose(tp[:nt].numpy(), np.asarray(tj)[:nt], **F32)
    np.testing.assert_allclose(ip.numpy(), np.asarray(ij), **F32)
    assert ip.shape == (bl, 2, 16, 16)


@pytest.mark.parametrize("nrhs", [1, 2])
def test_mega_solve_vs_pallas(nrhs):
    """The test_mega.py:65 case (poisson2d(8), nb=16): both solves take
    the SAME factors (the JAX mega factorization) and the same rhs."""
    hj = jinit(jpoisson2d(8), JOpts(nb=16, dtype="r32", ordering="rcm"))
    bk = get_backend("pallas", nb=16, dtype=hj.blocked.dtype)
    fac = JFactorizer(hj.blocked, hj.schedule, backend=bk, dispatch="mega")
    tiles = fac.factorize()
    invs = fac.inv_tiles
    nt, bl, n = hj.blocked.num_tiles, hj.schedule.block_length, hj.blocked.n
    rng = np.random.default_rng(nrhs)
    x = np.zeros((nrhs, bl + 1, 16), np.float32)
    x[:, :bl].reshape(nrhs, -1)[:, :n] = rng.standard_normal((nrhs, n))
    t = hj.schedule.mega_solve_tables(nt)
    npan = max(int(t["nl_tab"].max()), int(t["nuc_tab"].max()), 1)
    ref = kernels_pallas.mega_solve(
        jnp.asarray(x), tiles, invs,
        *(jnp.asarray(t[k]) for k in ("nl_tab", "nuc_tab", "lid_tab",
                                      "lrow_tab", "ucid_tab", "ucrow_tab")),
        nb=16, bl=bl, npan=npan)
    hp = pt.init(poisson2d(8), pt.InitOptions(nb=16, dtype="r32",
                                              ordering="rcm", device="cpu"))
    tables = kt.KernelTables.build(hp.schedule.mega_solve_tables(nt), "cpu")
    got = kt.mega_solve(torch.from_numpy(x),
                        torch.from_numpy(np.array(tiles)),
                        torch.from_numpy(np.array(invs)), tables,
                        nb=16, bl=bl)
    np.testing.assert_allclose(got[:, :bl].numpy(),
                               np.asarray(ref)[:, :bl], **SOLVE_F32)


def test_mega_factorize_f64_vs_dd_mega():
    """The TPU's r64 chain kernel (kernels_pallas_dd.mega_factorize_dd,
    through dispatch="dd_mega" as tests/test_dd.py:336-361 runs it)
    computes in hi/lo f32 pairs what the port's K2 computes in double:
    the port's f64 factors and inverses against hi + lo, at the dd
    tests' 1e-13 (inverses 1e-12: Newton-Schulz there, triangular
    solves here)."""
    hj = jinit(jpoisson2d(12), JOpts(nb=16, dtype="r64", ordering="rcm"))
    fac = JFactorizer(hj.blocked, hj.schedule, dispatch="dd_mega")
    t_dd = np.asarray(fac.factorize())
    i_dd = sum(np.asarray(p, np.float64) for p in fac.inv_tiles)
    hp = pt.init(poisson2d(12), pt.InitOptions(nb=16, dtype="r64",
                                               ordering="rcm", device="cpu"))
    fp = LUFactorizer(hp.blocked, hp.schedule, device="cpu", dispatch="mega")
    tp = fp.factorize()
    nt = hp.blocked.num_tiles
    np.testing.assert_allclose(tp[:nt].numpy(), t_dd[:nt],
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(fp.inv_tiles.numpy(), i_dd, **F64)


def test_getrf_f64_vs_dd_lu_scan_pallas():
    """The TPU's dd tile LU (ops/dd.py dd_lu_scan_pallas, interpret
    mode, the tests/test_dd.py:196-211 case) against the port's f64 K1
    packed factor, hi + lo combined, at 1e-13."""
    from pangulu_tpu.ops import dd

    rng = np.random.default_rng(7)
    nb = 16
    a = rng.standard_normal((nb, nb)) + np.eye(nb) * 5
    fh, fl = dd.dd_lu_scan_pallas(*dd.dd(a), nb=nb, tol=1e-30)
    f, _, _ = kt.getrf_with_inverses(torch.from_numpy(a), tol=1e-30)
    np.testing.assert_allclose(f.numpy(), dd.dd_to_f64(fh, fl),
                               rtol=1e-13, atol=1e-13)
