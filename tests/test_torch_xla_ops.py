"""The block kernels of the port's "torch" backend
(pangulu_tpu_torch/ops/kernels_xla.py) against their JAX twins
(pangulu_tpu/ops/kernels_jax.py) on the same inputs, and the backend
registry (pangulu_tpu_torch/ops/interface.py).

Inputs are seeded numpy arrays, diagonally dominant tiles of m = 16, 40
and 72 (the recursion's base, and splits 32 + 8 and 64 + 8, the odd
ones), in float32, float64, complex64 and complex128.  Tolerances: f32
rtol/atol 1e-5 (the contract of ROADMAP.md "Tolerances",
tests/test_mega.py:31), f64 1e-12; both packages run the same
recursion and the same base cases in another summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangulu_tpu.ops import kernels_jax as kj
from pangulu_tpu_torch.ops import interface
from pangulu_tpu_torch.ops import kernels_cuda as kc
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.ops import kernels_xla as kx

SIZES = [16, 40, 72]
TOL = {np.float32: 1e-5, np.float64: 1e-12, np.complex64: 1e-5,
       np.complex128: 1e-12}
REAL = [np.float32, np.float64]
ALL = REAL + [np.complex64, np.complex128]


def _tile(m, dtype, seed=0, batch=()):
    rng = np.random.default_rng(seed + m)
    a = rng.standard_normal((*batch, m, m)) + m * np.eye(m)
    if np.dtype(dtype).kind == "c":
        a = a + 0.3j * rng.standard_normal((*batch, m, m))
    return a.astype(dtype)


def _close(got, want, dtype, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL[dtype], atol=TOL[dtype],
                               err_msg=name)


def _jx(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("dtype", REAL)
@pytest.mark.parametrize("m", SIZES)
def test_getrf(m, dtype):
    a = _tile(m, dtype)
    _close(kx.getrf(torch.from_numpy(a)), kj.getrf(_jx(a)), dtype)


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("m", SIZES)
def test_getrf_with_inverses(m, dtype):
    a = _tile(m, dtype)
    for n, g, w in zip(("f", "linv", "uinv"),
                       kx.getrf_with_inverses(torch.from_numpy(a)),
                       kj.getrf_with_inverses(_jx(a))):
        _close(g, w, dtype, n)


@pytest.mark.parametrize("dtype", REAL)
def test_getrf_with_inverses_batched(dtype):
    """A batch [3, m, m] gives what each tile gives alone."""
    a = _tile(40, dtype, batch=(3,))
    got = kx.getrf_with_inverses(torch.from_numpy(a))
    for i in range(3):
        for g, w in zip(got, kj.getrf_with_inverses(_jx(a[i]))):
            _close(g[i], w, dtype)


@pytest.mark.parametrize("dtype", ALL)
def test_tiny_pivot_rule(dtype):
    """A zero first row and column: the pivot becomes +tol (real for a
    complex tile), as kernels_jax._safe_pivot makes it."""
    a = _tile(40, dtype)
    a[0, :] = 0
    a[:, 0] = 0
    f, _, _ = kx.getrf_with_inverses(torch.from_numpy(a))
    fj, _, _ = kj.getrf_with_inverses(_jx(a))
    tol = complex(np.asarray(kt.DEFAULT_TOL[f.dtype], dtype))
    assert complex(f[0, 0]) == complex(np.asarray(fj)[0, 0]) == tol
    _close(kx.getrf(torch.from_numpy(a)), kj.getrf(_jx(a)), dtype)


@pytest.mark.parametrize("dtype", ALL)
@pytest.mark.parametrize("m", SIZES)
def test_panel_solves_and_schur(m, dtype):
    """tstrf, gessm, ssssm, diag_inverses, trsv_* on one factored tile
    and a batch of panels."""
    f = np.asarray(kj.getrf(_jx(_tile(m, dtype))))
    b = _tile(m, dtype, seed=1, batch=(3,))
    c = _tile(m, dtype, seed=2, batch=(3,))
    ft, bt, ct = (torch.from_numpy(np.ascontiguousarray(v))
                  for v in (f, b, c))
    fb = jnp.broadcast_to(_jx(f), b.shape)
    _close(kx.tstrf(ft, bt), kj.tstrf(fb, _jx(b)), dtype, "tstrf")
    _close(kx.gessm(ft, bt), kj.gessm(fb, _jx(b)), dtype, "gessm")
    _close(kx.ssssm(ct, bt, bt), kj.ssssm(_jx(c), _jx(b), _jx(b)), dtype,
           "ssssm")
    for n, g, w in zip(("linv", "uinv"), kx.diag_inverses(ft),
                       kj.diag_inverses(_jx(f))):
        _close(g, w, dtype, n)
    x = b[0, :, :2]
    _close(kx.trsv_lower_unit(ft, torch.from_numpy(x.copy())),
           kj.trsv_lower_unit(_jx(f), _jx(x)), dtype, "trsv_lower_unit")
    _close(kx.trsv_upper(ft, torch.from_numpy(x.copy())),
           kj.trsv_upper(_jx(f), _jx(x)), dtype, "trsv_upper")
    _close(kx.spmv_sub(torch.from_numpy(x.copy()), ft,
                       torch.from_numpy(x.copy())),
           kj.spmv_sub(_jx(x), _jx(f), _jx(x)), dtype, "spmv_sub")
    _close(kx.vecadd(torch.from_numpy(x.copy()), torch.from_numpy(x.copy())),
           kj.vecadd(_jx(x), _jx(x)), dtype, "vecadd")


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_getrf_with_inverses_inverts(dtype):
    """The inverses of a complex tile are those of its factors."""
    f, li, ui = kx.getrf_with_inverses(torch.from_numpy(_tile(72, dtype)))
    eye = torch.eye(72, dtype=f.dtype)
    lmat = torch.tril(f, -1) + eye
    umat = torch.triu(f)
    _close(li @ lmat, eye, dtype)
    _close(umat @ ui, eye, dtype)


def test_split_is_jax_split():
    for m in range(33, 1100):
        assert kx._split(m) == kj._split(m), m


@pytest.mark.parametrize("device,dtype,want", [
    ("cpu", torch.float32, "torch"), ("cpu", torch.float64, "torch"),
    ("cpu", torch.complex64, "torch"), ("cuda", torch.float32, "cuda"),
    ("cuda", torch.float64, "cuda"), ("cuda", torch.complex64, "torch"),
    ("cuda", torch.complex128, "torch"), ("cuda", np.float32, "cuda"),
    ("cuda", np.complex128, "torch"), ("cuda", None, "cuda")])
@pytest.mark.parametrize("nb", [128, 300, 512])
def test_auto_backend(device, dtype, want, nb):
    """'auto' resolves by device and dtype at every nb: the hand K1 for
    real tiles on a CUDA device, PyTorch ops elsewhere (resolving a
    device needs no card)."""
    be = interface.get_backend("auto", nb=nb, dtype=dtype, device=device)
    assert be.name == want
    assert be.diag_factor_invert is (kc.getrf_with_inverses
                                     if want == "cuda"
                                     else kx.getrf_with_inverses)
    for field in ("tstrf", "gessm", "ssssm", "trsv_lower_unit",
                  "trsv_upper", "spmv_sub", "vecadd", "getrf"):
        assert getattr(be, field) is getattr(kx, field)


def test_backend_tol_and_names():
    be = interface.get_backend("torch", tol=1e-3)
    assert be.tol == 1e-3 and be.name == "torch"
    assert interface.get_backend("torch").tol is None
    assert interface.get_backend("cuda", dtype=torch.float64).tol is None
    with pytest.raises(ValueError, match="unknown kernel backend"):
        interface.get_backend("pallas")
    with pytest.raises(ValueError, match="complex tiles"):
        interface.get_backend("cuda", dtype=torch.complex64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_backend_on_cpu_runs_the_plain_k1(dtype):
    """The "cuda" backend's diagonal step on a CPU tensor is K1's plain
    version: the rank-1 scan up to nb = 256, the wide recursion above."""
    be = interface.get_backend("cuda", dtype=dtype)
    for nb, plain in ((40, kt.getrf_with_inverses),
                      (288, kt.getrf_with_inverses_wide)):
        a = torch.from_numpy(_tile(nb, np.float64)).to(dtype)
        for g, w in zip(be.diag_factor_invert(a, None), plain(a)):
            assert torch.equal(g, w)
