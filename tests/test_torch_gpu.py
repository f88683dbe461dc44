"""The hand-written CUDA kernels against their plain PyTorch versions,
on the card.  Marked ``gpu``: each test skips (with its reason) where
no CUDA device is present.  This file imports neither JAX nor the JAX
package, so on the GPU machine, which has no JAX, it runs without the
suite's conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances are the JAX package's own contract (ROADMAP.md
"Tolerances", tests/test_mega.py:31,82): f32 tiles and inverses
rtol/atol 1e-5, f32 solves rtol 1e-4 / atol 1e-5, f64 1e-12; grouped
f32 factors 2e-4 (tests/test_mega_group.py:66,140: a group's updates
are summed in another order).  K1's blocked step (128 < nb <= 256)
against the rank-1 plain version: f32 factor 3e-5, inverses 2e-4, the
JAX package's bound for its blocked LU (tests/test_pallas.py:79-99);
against its plain twin (getrf_with_inverses_blocked) the f32 contract.
The probes P5, P4 and P3 (csrc/probes.cuh) in float32: true f32, the
kernel's error against the plain float64 version (relative to its
largest entry; for P3 to each row's, since its inverses span ~1e17) at
most 2x the plain float32 version's, or one f32 eps where both are that
close; P3 in float64 within 1e-12 of each row's largest entry.  With b =
0 the products stay 0, so every P4/P5 instance with products must return
the bits of the one without: that holds their scan part, which the
products' values would hide.  The 3xTF32 instances (timed only) within
1e-4 of the largest f64 entry.
"""

import ctypes
import dataclasses
import json

import numpy as np
import pytest
import torch

import pangulu_tpu_torch as pt
import pangulu_tpu_torch.numeric
import pangulu_tpu_torch.ops.interface
from pangulu_tpu_torch.models import (poisson2d, poisson3d,
                                      random_unsymmetric, smallworld,
                                      trefethen)
from pangulu_tpu_torch.ops import kernels_cuda as kc
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.testing import (BLOCKED_TOL, blocked_tiny_pivot_tile,
                                       diag_step, newton_inputs,
                                       newton_mixed_inputs, probe_inputs,
                                       tiny_pivot_tile, wide_tiny_pivot_tile,
                                       with_imaginary_parts,
                                       zero_pivot_uinv_errors)
from pangulu_tpu_torch.utils.perf import residual_norm

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.float64: dict(rtol=1e-12, atol=1e-12)}


def _counts(**launched) -> dict:
    """kernels_cuda.LAUNCHES as it must read: the given counts, 0 for
    every other kernel."""
    return {k: launched.get(k, 0) for k in kc.LAUNCHES}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 3])
# each register-tile instance (nb <= 32, 64, 128), full and ragged
@pytest.mark.parametrize("nb", [10, 16, 32, 64, 100, 128])
def test_getrf_with_inverses_kernel(cuda, dtype, nb, batch):
    rng = np.random.default_rng(nb)
    a = torch.as_tensor(rng.standard_normal((batch, nb, nb))
                        + nb * np.eye(nb), dtype=dtype, device=cuda)
    for g, r in zip(kc.getrf_with_inverses(a), kt.getrf_with_inverses(a)):
        torch.testing.assert_close(g, r, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [16, 128])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_getrf_tiny_pivot_kernel(cuda, dtype, nb, where):
    """A zero pivot becomes +tol on U's diagonal, at the first, a middle
    and the last step, and the whole result matches the plain version."""
    k = {"first": 0, "middle": nb // 2, "last": nb - 1}[where]
    a = torch.as_tensor(tiny_pivot_tile(nb, k, np.random.default_rng(k)),
                        dtype=dtype, device=cuda)
    got = kc.getrf_with_inverses(a)
    tol = torch.tensor(kt.DEFAULT_TOL[dtype], dtype=dtype)
    assert float(got[0][k, k]) == float(tol)
    for g, r in zip(got, kt.getrf_with_inverses(a)):
        torch.testing.assert_close(g, r, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 3])
# one panel of 1 column past the first 128, a ragged last panel, the
# full tile
@pytest.mark.parametrize("nb", [129, 200, 256])
def test_getrf_blocked_kernel(cuda, dtype, nb, batch):
    """K1 at 128 < nb <= 256 (the blocked step): its plain twin at the
    f32 contract, the rank-1 plain version at the blocked-LU bound."""
    rng = np.random.default_rng(nb)
    a = torch.as_tensor(rng.standard_normal((batch, nb, nb))
                        + nb * np.eye(nb), dtype=dtype, device=cuda)
    kc.reset_launch_counts()
    got = kc.getrf_with_inverses(a)
    # one K1 launch, one device launch (the cluster kernel)
    assert kc.LAUNCHES["getrf_with_inverses"] == 1
    assert kc.DEVICE_LAUNCHES == {"getrf_with_inverses": 1}
    for g, r in zip(got, kt.getrf_with_inverses_blocked(a)):
        torch.testing.assert_close(g, r, **TOL[dtype])
    for g, r, (rtol, atol) in zip(got, kt.getrf_with_inverses(a),
                                  BLOCKED_TOL[dtype]):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("nb", [129, 200, 255, 256])
def test_cluster_kernel_on_store_ids(cuda, dtype, nb, batch):
    """K1's cluster kernel as K4's diagonal step runs it: members at
    non-contiguous ids of a store, factored in place, their inverses to
    non-contiguous slots; the other tiles untouched; its plain twin at
    the f32 contract; one device launch."""
    rng = np.random.default_rng(nb + batch)
    tiles = torch.as_tensor(rng.standard_normal((12, nb, nb))
                            + nb * np.eye(nb), dtype=dtype, device=cuda)
    before = tiles.clone()
    ids = [7, 2, 10, 0, 5][:batch]
    slots = [3, 0, 4, 1, 2][:batch]
    invs = torch.zeros((5, 2, nb, nb), dtype=dtype, device=cuda)
    kc.reset_launch_counts()
    diag_step(tiles, torch.tensor(ids, dtype=torch.int32, device=cuda), invs,
              torch.tensor(slots, dtype=torch.int32, device=cuda))
    assert kc.LAUNCHES["getrf_with_inverses"] == 1
    assert kc.DEVICE_LAUNCHES == {"getrf_with_inverses": 1}
    want = kt.getrf_with_inverses_blocked(before[ids])
    for g, r in zip((tiles[ids], invs[slots, 0], invs[slots, 1]), want):
        torch.testing.assert_close(g, r, **TOL[dtype])
    rest = [i for i in range(12) if i not in ids]
    assert torch.equal(tiles[rest], before[rest])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
# zero pivots reached inside a panel (127, 129, 168, 255) and at a
# panel's start (64), at step 0, and twice in the first two panels
@pytest.mark.parametrize("nb,k1,k2", [(256, 0, 127), (256, 64, 1),
                                      (200, 127, 40), (256, 5, 1)])
def test_getrf_blocked_tiny_pivot_kernel(cuda, dtype, nb, k1, k2):
    """A zero pivot in each diagonal block becomes +tol at the same step
    as in the rank-1 scan, and the result matches both plain versions."""
    a = torch.as_tensor(blocked_tiny_pivot_tile(
        nb, k1, k2, np.random.default_rng(k1)), dtype=dtype, device=cuda)
    got = kc.getrf_with_inverses(a)
    tol = float(torch.tensor(kt.DEFAULT_TOL[dtype], dtype=dtype))
    k = kt.LU_SPLIT + k2
    assert float(got[0][k1, k1]) == tol and float(got[0][k, k]) == tol
    for g, r in zip(got, kt.getrf_with_inverses_blocked(a)):
        torch.testing.assert_close(g, r, **TOL[dtype])
    for g, r, (rtol, atol) in zip(got, kt.getrf_with_inverses(a),
                                  BLOCKED_TOL[dtype]):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 3])
# clusters of 9, 10, 12 and 16 CTAs; 640 on the flow kernel's
# cooperative launch
@pytest.mark.parametrize("nb", [288, 300, 384, 512, 640])
def test_getrf_wide_kernel(cuda, dtype, nb, batch):
    """K1 above nb = 256 (csrc/wide_lu.cuh): its plain twin
    (kernels_torch.k1_wide: the blocked step over the whole tile up to
    W_T) at the f32 contract, the rank-1 scan at the blocked-LU bound;
    one K1 launch of one device launch (the cluster kernel up to 512,
    the flow kernel at 640)."""
    rng = np.random.default_rng(nb)
    a = torch.as_tensor(rng.standard_normal((batch, nb, nb))
                        + nb * np.eye(nb), dtype=dtype, device=cuda)
    kc.reset_launch_counts()
    got = kc.getrf_with_inverses(a)
    assert kc.LAUNCHES["getrf_with_inverses"] == 1
    assert kc.DEVICE_LAUNCHES == {"getrf_with_inverses": 1}
    for g, r in zip(got, kt.k1_wide(a)):
        torch.testing.assert_close(g, r, **TOL[dtype])
    for g, r, (rtol, atol) in zip(got, kt.getrf_with_inverses(a),
                                  BLOCKED_TOL[dtype]):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [288, 384, 512, 640])
def test_getrf_wide_tiny_pivot_kernel(cuda, dtype, nb):
    """Zero pivots at step 0 and at wide_split(nb) become +tol, and the
    result matches the twin."""
    a = torch.as_tensor(wide_tiny_pivot_tile(nb, np.random.default_rng(nb)),
                        dtype=dtype, device=cuda)
    got = kc.getrf_with_inverses(a)
    tol = float(torch.tensor(kt.DEFAULT_TOL[dtype], dtype=dtype))
    m1 = kt.wide_split(nb)
    assert float(got[0][0, 0]) == tol and float(got[0][m1, m1]) == tol
    for g, r in zip(got, kt.k1_wide(a)):
        torch.testing.assert_close(g, r, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_plan_matches_the_c_side(cuda, dtype):
    """kernels_cuda.wide_plan is the C side's plan (plu_wide_plan) at
    every nb up to 512, and a cluster of its shape fits on the card."""
    lib = kc.library().lib
    size = torch.empty((), dtype=dtype).element_size()
    out = (ctypes.c_int * 4)()
    for nb in range(1, kt.WIDE_LEAF + 1):
        assert lib.plu_wide_plan(nb, size, out) == 0
        pl = kc.wide_plan(nb, dtype)
        assert tuple(out) == (pl["ctas"], pl["rows"], pl["smem"],
                              pl["stripe"])
    fit = ctypes.c_int()
    s = "f32" if dtype == torch.float32 else "f64"
    assert getattr(lib, f"plu_wide_fit_{s}")(cuda.index, 512,
                                               ctypes.byref(fit)) == 0
    assert fit.value >= 1


# the flow kernel's widths: 512 < nb <= W_T (kc.FLOW_MAX_NB, by type),
# and W_T + 32, the recursion on two flow leaves
FLOW_NBS = (544, 640, 768, 1024, 1088, "W_T", "W_T+32")


def _flow_nb(nb, dtype) -> int:
    wt = kc.FLOW_MAX_NB[dtype]
    return {"W_T": wt, "W_T+32": wt + 32}.get(nb, nb)


@pytest.mark.parametrize("kind", ["random", "zero pivots"])
@pytest.mark.parametrize("batch", [1, 3, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", FLOW_NBS)
def test_flow_kernel(cuda, nb, dtype, batch, kind):
    """K1 from 512 to W_T on the flow kernel (one cooperative launch a
    call where the batch's tiles all fit on the card at once; else, as
    above W_T, the recursion on leaves of kernels_torch.k1_leaf_width,
    kernels_cuda.k1_device_launches device launches): its plain twin
    (kernels_torch.k1_wide) at the f32 contract; with zero pivots at 0
    and wide_split(nb) made +tol, float U^-1 by
    testing.zero_pivot_uinv_errors (its column at the second pivot holds
    entries scaled by 1/tol, which 3xTF32 and the twin's FP32 products
    round apart, while the f32 twin is 100% off the f64 one there: that
    column by its residual in U·U^-1, the others at the contract); two
    calls give the same bits."""
    nb = _flow_nb(nb, dtype)
    rng = np.random.default_rng(nb + batch)
    if kind == "random":
        x = rng.standard_normal((batch, nb, nb)) + nb * np.eye(nb)
    else:
        x = np.stack([wide_tiny_pivot_tile(nb, rng) for _ in range(batch)])
    a = torch.as_tensor(x, dtype=dtype, device=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    kc.reset_launch_counts()
    got = kc.getrf_with_inverses(a)
    assert kc.LAUNCHES["getrf_with_inverses"] == 1
    assert kc.DEVICE_LAUNCHES == {"getrf_with_inverses":
                                  kc.k1_device_launches(nb, batch, dtype,
                                                        sms)}
    assert (kc.DEVICE_LAUNCHES["getrf_with_inverses"] == 1) == (
        batch * kc.flow_plan(min(nb, kc.FLOW_MAX_NB[dtype]), dtype,
                             sms)["ctas"] <= sms and
        nb <= kc.FLOW_MAX_NB[dtype])
    twin = kt.k1_wide(a)
    split = kind != "random" and dtype == torch.float32
    for g, r in zip(got[:2] if split else got, twin):
        torch.testing.assert_close(g, r, **TOL[dtype])
    if split:
        zp = zero_pivot_uinv_errors(got[0], got[2], twin[2],
                                    (TOL[dtype]["rtol"], TOL[dtype]["atol"]))
        assert zp["rest"] <= 1 and zp["residual"] <= 1, zp
    if kind != "random":
        tol = float(torch.tensor(kt.DEFAULT_TOL[dtype], dtype=dtype))
        m1 = kt.wide_split(nb)
        assert float(got[0][0, 0, 0]) == tol
        assert float(got[0][0, m1, m1]) == tol
    for g, r in zip(got, kc.getrf_with_inverses(a)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("kind", ["random", "zero pivots"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [288, 300, 512])
def test_flow_kernel_is_the_cluster_kernel(cuda, nb, dtype, kind):
    """The flow kernel alone at nb <= 512 (on no path there) gives the
    cluster kernel's bits: the same arithmetic, panel by panel."""
    rng = np.random.default_rng(nb)
    x = (rng.standard_normal((3, nb, nb)) + nb * np.eye(nb)
         if kind == "random" else
         np.stack([wide_tiny_pivot_tile(nb, rng) for _ in range(3)]))
    a = torch.as_tensor(x, dtype=dtype, device=cuda)
    for g, r in zip(kc.flow_kernel(a)[:3], kc.getrf_with_inverses(a)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flow_plan_matches_the_c_side(cuda, dtype):
    """kernels_cuda.flow_plan, FLOW_MAX_NB and FLOW_FLAGS are the C
    side's (plu_flow_plan, plu_flow_max_nb, plu_flow_flag_slots) at
    every nb up to W_T, kernels_torch.k1_leaf_width is plu_flow_leaf at
    batches 1 to 64, and the flow kernel alone takes each of a few
    widths up to W_T in one launch, as many tiles at once as the plan
    says fit (the tiles beyond in rounds)."""
    lib = kc.library().lib
    size = torch.empty((), dtype=dtype).element_size()
    assert lib.plu_flow_max_nb(size) == kc.FLOW_MAX_NB[dtype]
    assert lib.plu_flow_flag_slots() == kc.FLOW_FLAGS
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    out = (ctypes.c_int * 4)()
    for nb in range(1, kc.FLOW_MAX_NB[dtype] + 1):
        assert lib.plu_flow_plan(nb, size, sms, out) == 0
        pl = kc.flow_plan(nb, dtype, sms)
        assert tuple(out) == (pl["ctas"], pl["rows"], pl["smem"],
                              pl["sets"])
    for batch in range(1, 65):
        assert lib.plu_flow_leaf(batch, size, sms) == kt.k1_leaf_width(
            batch, dtype, sms)
    rng = np.random.default_rng(1)
    for nb in (33, 512, kc.FLOW_MAX_NB[dtype]):
        pl = kc.flow_plan(nb, dtype, sms)
        a = torch.as_tensor(rng.standard_normal((pl["sets"] + 1, nb, nb))
                            + nb * np.eye(nb), dtype=dtype, device=cuda)
        *got, sets = kc.flow_kernel(a)
        assert sets == pl["sets"]
        for g, r in zip(got, kt.getrf_with_inverses_blocked(a)):
            torch.testing.assert_close(g, r, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["r32", "r64"])
@pytest.mark.parametrize("ordering", ["rcm", "nd"])
@pytest.mark.parametrize("nb", [384, 512])
def test_wide_slice_on_cuda(cuda, nb, ordering, dtype):
    """init -> gstrf -> gstrs at nb > 256 on the card: the fused engine on
    backend cuda, one K1 launch (one device launch) a level and no
    other kernel; the factor within the f32 contract of the same engine
    with K1's plain twin on the same store (1e-12 in f64), and the
    refined solve's residual."""
    a = poisson3d(14)
    h = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                  device="cuda"))
    kc.reset_launch_counts()
    pt.gstrf(h)
    b = a.to_scipy() @ np.ones(a.n)
    x = pt.gstrs(h, b)
    bl = h.schedule.block_length
    assert kc.LAUNCHES == _counts(getrf_with_inverses=bl)
    assert kc.DEVICE_LAUNCHES == {"getrf_with_inverses": bl}
    assert (h.perf.kernels["engine"], h.perf.kernels["backend"]) == (
        "fused", "cuda")
    assert residual_norm(a.to_scipy(), x, b) < 1e-10
    plain = pt.numeric.LUFactorizer(
        h.blocked, h.schedule, device="cuda",
        backend=dataclasses.replace(
            pt.ops.interface.get_backend("cuda"),
            diag_factor_invert=kt.k1_wide))
    nt = h.blocked.num_tiles
    torch.testing.assert_close(h.factor_tiles[:nt], plain.factorize()[:nt],
                               **TOL[h.blocked.torch_dtype])


@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
def test_native_complex_on_cuda(cuda, dtype):
    """complex_mode="native" on the card: the fused engine on backend
    torch (no hand kernel takes complex tiles), its solution within
    1e-6 (cr32) / 1e-9 (cr64) of the embedding's."""
    from pangulu_tpu_torch.testing import with_imaginary_parts

    a = with_imaginary_parts(poisson2d(16))
    b = a.to_scipy() @ (np.ones(a.n) + 1j)
    xs = []
    for mode in ("native", "embed"):
        h = pt.init(a, pt.InitOptions(nb=32, dtype=dtype, ordering="nd",
                                      device="cuda", complex_mode=mode))
        kc.reset_launch_counts()
        pt.gstrf(h)
        xs.append(pt.gstrs(h, b))
        if mode == "native":
            assert not any(kc.LAUNCHES.values())
            assert (h.perf.kernels["engine"], h.perf.kernels["backend"]) \
                == ("fused", "torch")
    tol = 1e-6 if dtype == "cr32" else 1e-9
    np.testing.assert_allclose(xs[0], xs[1], rtol=tol, atol=tol)


@pytest.mark.parametrize("gen,nb,dtype,uch", [
    (lambda: poisson2d(8), 16, "r32", kt.MEGA_UCH),
    (lambda: random_unsymmetric(96, 0.06, seed=5), 16, "r32", kt.MEGA_UCH),
    # uch=4: levels span several update chunks (chunk indexing of K2)
    (lambda: random_unsymmetric(96, 0.06, seed=5), 16, "r32", 4),
    (lambda: trefethen(20), 10, "r64", kt.MEGA_UCH),
    # the tensor-core products' copy paths: f32 nb=10 rows are not
    # 16-byte aligned (4-byte copies), f64 nb=9 neither (8-byte copies);
    # nb=100 is ragged against the 32-wide bands and 64-wide quadrants
    (lambda: poisson2d(24), 10, "r32", kt.MEGA_UCH),
    (lambda: poisson2d(24), 9, "r64", kt.MEGA_UCH),
    (lambda: poisson2d(24), 16, "r64", kt.MEGA_UCH),
    (lambda: poisson3d(12), 100, "r32", kt.MEGA_UCH),
    (lambda: poisson3d(12), 100, "r64", kt.MEGA_UCH),
    (lambda: poisson3d(12), 128, "r32", kt.MEGA_UCH),
    (lambda: poisson3d(12), 128, "r64", kt.MEGA_UCH),
    # 256-wide panel bands and the blocked K1: full and ragged
    (lambda: poisson3d(12), 256, "r32", kt.mega_uch(256)),
    (lambda: poisson3d(12), 256, "r64", kt.mega_uch(256)),
    (lambda: poisson3d(12), 200, "r32", kt.mega_uch(200)),
    (lambda: poisson3d(12), 200, "r64", kt.mega_uch(200)),
])
def test_mega_kernels(cuda, gen, nb, dtype, uch):
    a = gen()
    h = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, ordering="rcm",
                                  device="cuda"))
    nt, bl = h.blocked.num_tiles, h.schedule.block_length
    ftab = kt.KernelTables.build(h.schedule.mega_tables(nt, uch=uch), cuda)
    stab = kt.KernelTables.build(h.schedule.mega_solve_tables(nt), cuda)
    t0 = h.blocked.device_tiles(cuda)
    tol = kt.DEFAULT_TOL[t0.dtype]
    tk, ik = kc.mega_factorize(t0.clone(), ftab, nb=nb, tol=tol, bl=bl)
    tp, ip = kt.mega_factorize(t0.clone(), ftab, nb=nb, tol=tol, bl=bl)
    torch.testing.assert_close(tk[:nt], tp[:nt], **TOL[t0.dtype])
    torch.testing.assert_close(ik, ip, **TOL[t0.dtype])
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, bl + 1, nb)), dtype=t0.dtype, device=cuda)
    x[:, bl] = 0
    stol = (dict(rtol=1e-4, atol=1e-5) if t0.dtype == torch.float32
            else TOL[t0.dtype])
    torch.testing.assert_close(
        kc.mega_solve(x, tk, ik, stab, nb=nb, bl=bl),
        kt.mega_solve(x, tk, ik, stab, nb=nb, bl=bl), **stol)


@pytest.mark.parametrize("dtype", ["r32", "r64"])
# 600 right-hand sides: a level's (panel tile, RHS) items outnumber the
# blocks a cooperative grid can hold, so blocks loop over items
@pytest.mark.parametrize("nrhs", [64, 600])
def test_mega_solve_many_rhs(cuda, dtype, nrhs):
    h = pt.init(poisson2d(16), pt.InitOptions(nb=16, dtype=dtype,
                                              ordering="rcm", device="cuda"))
    nt, bl = h.blocked.num_tiles, h.schedule.block_length
    ftab = kt.KernelTables.build(h.schedule.mega_tables(nt), cuda)
    stab = kt.KernelTables.build(h.schedule.mega_solve_tables(nt), cuda)
    t0 = h.blocked.device_tiles(cuda)
    tk, ik = kc.mega_factorize(t0, ftab, nb=16, tol=kt.DEFAULT_TOL[t0.dtype],
                               bl=bl)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (nrhs, bl + 1, 16)), dtype=t0.dtype, device=cuda)
    got = kc.mega_solve(x, tk, ik, stab, nb=16, bl=bl)
    stol = (dict(rtol=1e-4, atol=1e-5) if t0.dtype == torch.float32
            else TOL[t0.dtype])
    torch.testing.assert_close(
        got, kt.mega_solve(x, tk, ik, stab, nb=16, bl=bl), **stol)
    # no atomics, one sum order: a second solve is bit-identical
    assert torch.equal(got, kc.mega_solve(x, tk, ik, stab, nb=16, bl=bl))
    assert torch.equal(got[:, bl], x[:, bl])   # scratch segment untouched


def test_grid_sync_probe(cuda):
    """The barrier probe runs and reports a grid that fits the card."""
    blocks = kc.grid_sync_probe(cuda, 10 ** 6, 8)
    torch.cuda.synchronize()
    props = torch.cuda.get_device_properties(cuda)
    assert 1 <= blocks <= 2 * props.multi_processor_count


def test_slice_on_cuda_counts_launches(cuda):
    a = poisson2d(8)
    b = a.to_scipy() @ np.ones(a.n)
    kc.reset_launch_counts()
    h = pt.init(a, pt.InitOptions(nb=16, dtype="r32", ordering="rcm",
                                  device="cuda", check=True))
    pt.gstrf(h)
    x = pt.gstrs(h, b)
    # one factorization, whose every level launched K1's kernel on its
    # diagonal tile; one solve plus the default two refinement solves
    assert kc.LAUNCHES == _counts(
        getrf_with_inverses=h.schedule.block_length, mega_factorize=1,
        mega_solve=3)
    assert kc.DEVICE_LAUNCHES == {
        "getrf_with_inverses": h.schedule.block_length}
    assert h.factor_tiles.is_cuda
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    assert residual_norm(a.to_scipy(), x, b) < 1e-10


@pytest.mark.parametrize("gen,dtype,uch,nb", [
    # nd: members of a group share Schur destinations and solve rows
    (lambda: poisson2d(12), "r32", kt.MEGA_UCH, 16),
    # uch=8: groups span several update chunks
    (lambda: poisson2d(12), "r32", 8, 16),
    (lambda: smallworld(14), "r32", kt.MEGA_UCH, 16),
    (lambda: poisson2d(24), "r64", kt.MEGA_UCH, 16),
    (lambda: poisson2d(24), "r64", 8, 16),
    # the product windows at ragged and full nb (see test_mega_kernels)
    (lambda: poisson2d(24), "r32", kt.MEGA_UCH, 10),
    (lambda: poisson2d(24), "r64", kt.MEGA_UCH, 10),
    (lambda: poisson3d(12), "r32", kt.MEGA_UCH, 100),
    (lambda: poisson3d(12), "r64", kt.MEGA_UCH, 100),
    (lambda: poisson3d(12), "r32", kt.MEGA_UCH, 128),
    (lambda: poisson3d(12), "r64", kt.MEGA_UCH, 128),
    # the blocked K1 on a batch of members, 256-wide panel bands
    (lambda: poisson3d(12), "r32", kt.mega_uch(256), 256),
    (lambda: poisson3d(12), "r64", kt.mega_uch(256), 256),
    (lambda: poisson3d(12), "r32", kt.mega_uch(200), 200),
])
def test_group_kernels(cuda, gen, dtype, uch, nb):
    h = pt.init(gen(), pt.InitOptions(nb=nb, dtype=dtype, ordering="nd",
                                      device="cuda"))
    nt, bl = h.blocked.num_tiles, h.schedule.block_length
    ftab = kt.KernelTables.build(
        h.schedule.group_mega_tables(nt, uch=uch), cuda)
    stab = kt.KernelTables.build(h.schedule.group_solve_tables(nt), cuda)
    assert ftab.host["ngroups"] < bl
    t0 = h.blocked.device_tiles(cuda)
    f32 = t0.dtype == torch.float32
    tol = kt.DEFAULT_TOL[t0.dtype]
    kw = dict(nb=nb, tol=tol, bl=bl)
    tk, ik = kc.mega_factorize_groups(t0.clone(), ftab, **kw)
    tp, ip = kt.mega_factorize_groups(t0.clone(), ftab, **kw)
    ftol = dict(rtol=2e-4, atol=2e-4) if f32 else TOL[t0.dtype]
    torch.testing.assert_close(tk[:nt], tp[:nt], **ftol)
    torch.testing.assert_close(ik, ip, **ftol)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (3, bl + 1, nb)), dtype=t0.dtype, device=cuda)
    stol = dict(rtol=1e-4, atol=1e-5) if f32 else TOL[t0.dtype]
    got = kc.mega_solve_groups(x, tk, ik, stab, nb=nb, bl=bl)
    torch.testing.assert_close(
        got, kt.mega_solve_groups(x, tk, ik, stab, nb=nb, bl=bl), **stol)
    assert torch.equal(got[:, bl], x[:, bl])   # scratch segment untouched


@pytest.mark.parametrize("dtype", ["r32", "r64"])
# 600 right-hand sides: a step's (item, RHS) pairs outnumber the blocks
# a cooperative grid can hold, so blocks loop over items
@pytest.mark.parametrize("nrhs", [64, 600])
def test_mega_solve_groups_many_rhs(cuda, dtype, nrhs):
    """K5 on an nd schedule whose groups share rows (poisson2d(24)
    nb=16): the plain version's result, bit-identical repeated solves,
    the scratch segment untouched."""
    h = pt.init(poisson2d(24), pt.InitOptions(nb=16, dtype=dtype,
                                              ordering="nd", device="cuda"))
    nt, bl = h.blocked.num_tiles, h.schedule.block_length
    ftab = kt.KernelTables.build(h.schedule.group_mega_tables(nt), cuda)
    stab = kt.KernelTables.build(h.schedule.group_solve_tables(nt), cuda)
    t0 = h.blocked.device_tiles(cuda)
    tk, ik = kc.mega_factorize_groups(t0, ftab, nb=16, bl=bl,
                                      tol=kt.DEFAULT_TOL[t0.dtype])
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (nrhs, bl + 1, 16)), dtype=t0.dtype, device=cuda)
    got = kc.mega_solve_groups(x, tk, ik, stab, nb=16, bl=bl)
    grid = kc.GRID["mega_solve_groups"]
    props = torch.cuda.get_device_properties(cuda)
    assert 1 <= grid["forward"] <= (grid["blocks_per_sm"]
                                    * props.multi_processor_count)
    stol = (dict(rtol=1e-4, atol=1e-5) if t0.dtype == torch.float32
            else TOL[t0.dtype])
    torch.testing.assert_close(
        got, kt.mega_solve_groups(x, tk, ik, stab, nb=16, bl=bl), **stol)
    # no atomics, one sum order: a second solve is bit-identical
    assert torch.equal(got, kc.mega_solve_groups(x, tk, ik, stab, nb=16,
                                                 bl=bl))
    assert torch.equal(got[:, bl], x[:, bl])   # scratch segment untouched


def _cluster_sweep_case(cuda, gen, nb, dtype, ordering, nrhs):
    """A factored store at 128 < nb <= 256, its solve tables and
    right-hand sides (scratch segment 0), for K3's or K5's cluster
    sweeps."""
    h = pt.init(gen(), pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                      device="cuda"))
    nt, bl, sch = h.blocked.num_tiles, h.schedule.block_length, h.schedule
    t0 = h.blocked.device_tiles(cuda)
    kw = dict(nb=nb, bl=bl, tol=kt.DEFAULT_TOL[t0.dtype])
    if ordering == "nd":
        ftab = kt.KernelTables.build(
            sch.group_mega_tables(nt, uch=kt.mega_uch(nb)), cuda)
        stab = kt.KernelTables.build(sch.group_solve_tables(nt), cuda)
        tk, ik = kc.mega_factorize_groups(t0, ftab, **kw)
    else:
        ftab = kt.KernelTables.build(sch.mega_tables(nt, uch=kt.mega_uch(nb)),
                                     cuda)
        stab = kt.KernelTables.build(sch.mega_solve_tables(nt), cuda)
        tk, ik = kc.mega_factorize(t0, ftab, **kw)
    x = torch.as_tensor(np.random.default_rng(nb).standard_normal(
        (nrhs, bl + 1, nb)), dtype=t0.dtype, device=cuda)
    x[:, bl] = 0
    return tk, ik, stab, x, dict(nb=nb, bl=bl)


@pytest.mark.parametrize("nrhs", [1, 4])
@pytest.mark.parametrize("dtype", ["r32", "r64"])
@pytest.mark.parametrize("nb", [129, 200, 256])
# poisson3d(20): levels of up to 2 panel tiles (nb=200 rcm: 40 levels);
# random_unsymmetric: up to 7 (nb=129), past what a stage holds
@pytest.mark.parametrize("gen", [lambda: poisson3d(20),
                                 lambda: random_unsymmetric(1200, 0.004,
                                                            seed=5)],
                         ids=["poisson3d", "random"])
def test_cluster_solve_sweeps(cuda, gen, nb, dtype, nrhs):
    """K3 above nb = 128 on thread block clusters: the plain version's
    result at the solve tolerances; every row summed in one order, so a
    second run gives the same bits; the scratch segment untouched; 2
    device launches of clusters of 16 CTAs."""
    tk, ik, stab, x, kw = _cluster_sweep_case(cuda, gen, nb, dtype, "rcm",
                                              nrhs)
    ref = kt.mega_solve(x, tk, ik, stab, **kw)
    stol = (dict(rtol=1e-4, atol=1e-5) if dtype == "r32"
            else TOL[torch.float64])
    got = kc.mega_solve(x, tk, ik, stab, **kw)
    grid = kc.GRID["mega_solve"]
    assert grid["cluster"] == 16
    assert grid["forward"] == grid["backward"] == 16 * min(
        nrhs, grid["clusters_fit"])
    torch.testing.assert_close(got, ref, **stol)
    assert torch.equal(got[:, kw["bl"]], x[:, kw["bl"]])
    assert torch.equal(got, kc.mega_solve(x, tk, ik, stab, **kw))


@pytest.mark.parametrize("nrhs", [1, 4, 64])
@pytest.mark.parametrize("dtype", ["r32", "r64"])
@pytest.mark.parametrize("nb", [129, 200, 256])
def test_cluster_group_sweeps(cuda, nb, dtype, nrhs):
    """K5 above nb = 128 on thread block clusters (poisson3d(20) nd,
    items of up to 7 entries): the plain version's result at the solve
    tolerances, the same bits on a second run, the scratch segment
    untouched; clusters of 4 CTAs while the widest step holds fewer
    than two (item, RHS) pairs an SM, else of 2 (64 RHS: always 2)."""
    tk, ik, stab, x, kw = _cluster_sweep_case(
        cuda, lambda: poisson3d(20), nb, dtype, "nd", nrhs)
    ref = kt.mega_solve_groups(x, tk, ik, stab, **kw)
    stol = (dict(rtol=1e-4, atol=1e-5) if dtype == "r32"
            else TOL[torch.float64])
    got = kc.mega_solve_groups(x, tk, ik, stab, **kw)
    grid = kc.GRID["mega_solve_groups"]
    host, _ = kc.solve_steps_view(stab, kw["bl"], tk.shape[0] - 1, cuda)
    width = max(host["l_width"], host["uc_width"])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert grid["cluster"] == (4 if width * nrhs < 2 * sms else 2)
    if nrhs == 64:
        assert grid["cluster"] == 2
    assert 0 < grid["forward"] <= grid["cluster"] * grid["clusters_fit"]
    torch.testing.assert_close(got, ref, **stol)
    assert torch.equal(got[:, kw["bl"]], x[:, kw["bl"]])
    assert torch.equal(got, kc.mega_solve_groups(x, tk, ik, stab, **kw))


@pytest.mark.parametrize("gen,nb,dtype", [
    (lambda: poisson2d(12), 16, "r32"),
    (lambda: smallworld(30), 16, "r32"),
    (lambda: poisson3d(16), 128, "r32"),
    # K1's cluster kernel on the second stream
    (lambda: poisson3d(24), 256, "r32"),
    # the C entry takes double as well (LUFactorizer asks for float only)
    (lambda: poisson3d(16), 128, "r64"),
])
def test_chain_ahead_kernel(cuda, monkeypatch, gen, nb, dtype):
    """K2 on chain-ahead tables (PANGULU_TPU_SUPERLEVEL=1, nd): the
    diagonal steps run ahead on the second stream give the bits of the
    same tables on one stream, in factors and inverses, run after run;
    K1 launches bl times on either (those run ahead counted in
    kernels_cuda.AHEAD), K2 once; the result agrees with the plain
    version on the same tables, and its inverses serve K3."""
    monkeypatch.setenv("PANGULU_TPU_SUPERLEVEL", "1")
    h = pt.init(gen(), pt.InitOptions(nb=nb, dtype=dtype, ordering="nd",
                                      device="cuda"))
    nt, bl = h.blocked.num_tiles, h.schedule.block_length
    ftab = kt.KernelTables.build(h.schedule.mega_tables(
        nt, uch=kt.mega_uch(nb), superlevel=True), cuda)
    flagged = int(ftab.host["flag_tab"].sum())
    assert flagged > 0
    t0 = h.blocked.device_tiles(cuda)
    kw = dict(nb=nb, tol=kt.DEFAULT_TOL[t0.dtype], bl=bl)
    kc.reset_launch_counts()
    ts, is_ = kc.mega_factorize(t0.clone(), ftab, ahead=False, **kw)
    torch.cuda.synchronize()
    assert kc.LAUNCHES == _counts(getrf_with_inverses=bl, mega_factorize=1)
    assert kc.AHEAD["mega_factorize"] == 0
    for _ in range(5):
        kc.reset_launch_counts()
        ta, ia = kc.mega_factorize(t0.clone(), ftab, **kw)
        torch.cuda.synchronize()
        assert kc.LAUNCHES == _counts(getrf_with_inverses=bl,
                                      mega_factorize=1)
        assert kc.DEVICE_LAUNCHES["getrf_with_inverses"] == bl
        assert kc.AHEAD["mega_factorize"] == flagged
        assert torch.equal(ta, ts) and torch.equal(ia, is_)
    tp, ip = kt.mega_factorize(t0.clone(), ftab, **kw)
    torch.testing.assert_close(ta[:nt], tp[:nt], **TOL[t0.dtype])
    torch.testing.assert_close(ia, ip, **TOL[t0.dtype])
    # the public route: LUFactorizer(dispatch="mega") takes the tables
    # on float32, and its inverses serve the solve
    fac = pangulu_tpu_torch.numeric.LUFactorizer(
        h.blocked, h.schedule, device=cuda, dispatch="mega")
    assert ("flag_tab" in fac.tables.host) is (dtype == "r32")
    h._factorizer, h.factor_tiles = fac, fac.factorize()
    if dtype == "r32":
        assert torch.equal(h.factor_tiles, ta)
    b = h.a_origin @ np.ones(h.a_origin.shape[0])
    x = pt.gstrs(h, b)
    assert residual_norm(h.a_origin, x, b) < (1e-10 if dtype == "r32"
                                              else 1e-12)


@pytest.mark.parametrize("ordering", ["rcm", "nd"])
def test_cluster_sweeps_on_two_streams(cuda, ordering):
    """Two nb=256 solves of other right-hand sides on two streams at
    once: K5's grid barrier has counters of its own a stream, so each
    gives the bits it gives alone."""
    tk, ik, stab, x, kw = _cluster_sweep_case(
        cuda, lambda: poisson3d(20), 256, "r32", ordering, 1)
    solve = kc.mega_solve if ordering == "rcm" else kc.mega_solve_groups
    xs = [x, x.flip(2).contiguous()]
    alone = [solve(v, tk, ik, stab, **kw) for v in xs]
    streams = [torch.cuda.Stream(cuda) for _ in xs]
    for _ in range(20):
        torch.cuda.synchronize(cuda)
        got = []
        for st, v in zip(streams, xs):
            with torch.cuda.stream(st):
                got.append(solve(v, tk, ik, stab, **kw))
        torch.cuda.synchronize(cuda)
        for g, a in zip(got, alone):
            assert torch.equal(g, a)


def test_nd_slice_on_cuda_counts_launches(cuda):
    a = poisson2d(12)
    b = a.to_scipy() @ np.ones(a.n)
    kc.reset_launch_counts()
    h = pt.init(a, pt.InitOptions(nb=16, dtype="r32", ordering="nd",
                                  device="cuda", check=True))
    pt.gstrf(h)
    x = pt.gstrs(h, b)
    ng = h._factorizer.tables.host["ngroups"]
    assert ng < h.schedule.block_length
    # one grouped factorization, whose every group launched K1's kernel
    # once for its diagonal tiles; one grouped solve plus two refinement
    # solves; no chain kernel
    assert kc.LAUNCHES == _counts(getrf_with_inverses=ng,
                                  mega_factorize_groups=1,
                                  mega_solve_groups=3)
    assert h.perf.kernels["engine"] == "mega_group"
    assert h.perf.kernels["solve_engine"] == "mega_group"
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    assert residual_norm(a.to_scipy(), x, b) < 1e-10


@pytest.mark.parametrize("ordering", ["rcm", "nd"])
def test_nb256_slice_on_cuda_counts_launches(cuda, ordering):
    """init -> gstrf -> gstrs at nb=256: K1 once a level (chain) or a
    group, each call one K1 launch of one device launch, and the
    residual bounds of nb=128."""
    a = poisson3d(12)
    b = a.to_scipy() @ np.ones(a.n)
    kc.reset_launch_counts()
    h = pt.init(a, pt.InitOptions(nb=256, dtype="r32", ordering=ordering,
                                  device="cuda", check=True))
    pt.gstrf(h)
    x = pt.gstrs(h, b)
    grouped = ordering == "nd"
    steps = (h._factorizer.tables.host["ngroups"] if grouped
             else h.schedule.block_length)
    assert kc.LAUNCHES == _counts(getrf_with_inverses=steps,
                                  mega_factorize=int(not grouped),
                                  mega_solve=3 * int(not grouped),
                                  mega_factorize_groups=int(grouped),
                                  mega_solve_groups=3 * int(grouped))
    assert kc.DEVICE_LAUNCHES == {"getrf_with_inverses": steps}
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    assert residual_norm(a.to_scipy(), x, b) < 1e-10


def _factor(grouped):
    return kc.mega_factorize_groups if grouped else kc.mega_factorize


def _store_and_tables(cuda, ordering, gen=lambda: poisson3d(12), nb=128):
    h = pt.init(gen(), pt.InitOptions(nb=nb, dtype="r32", ordering=ordering,
                                      device="cuda"))
    nt, bl = h.blocked.num_tiles, h.schedule.block_length
    sch = h.schedule
    uch = kt.mega_uch(nb)
    tab = (sch.group_mega_tables(nt, uch=uch) if ordering == "nd"
           else sch.mega_tables(nt, uch=uch))
    return h.blocked.device_tiles(cuda), kt.KernelTables.build(tab, cuda), \
        dict(nb=nb, bl=bl), nt


def rel_err(got, ref64):
    """The largest error relative to the result's scale:
    max |got - ref| / max |ref|, in float64."""
    return float((got.double() - ref64).abs().max() / ref64.abs().max())


@pytest.mark.parametrize("nb", [128, 256])
@pytest.mark.parametrize("ordering", ["rcm", "nd"])
def test_true_f32_products(cuda, ordering, nb):
    """The f32 kernel (3xTF32 products on tensor cores) is as accurate as
    true f32: against the plain f64 factorization of the same store
    (torch.matmul, no code shared with the kernels), its error is at
    most 2x the f32 plain version's (torch.matmul in full f32).  The
    f64 kernel (DMMA products) agrees with that reference to 1e-12."""
    t0, tab, kw, nt = _store_and_tables(cuda, ordering, nb=nb)
    grouped = ordering == "nd"
    tol32, tol64 = kt.DEFAULT_TOL[torch.float32], kt.DEFAULT_TOL[
        torch.float64]
    tk, ik = _factor(grouped)(t0.clone(), tab, tol=tol32, **kw)
    plain = kt.mega_factorize_groups if grouped else kt.mega_factorize
    tp, ip = plain(t0.clone(), tab, tol=tol32, **kw)
    t64, i64 = plain(t0.double(), tab, tol=tol64, **kw)
    tk64, ik64 = _factor(grouped)(t0.double(), tab, tol=tol64, **kw)
    torch.testing.assert_close(tk64[:nt], t64[:nt], **TOL[torch.float64])
    torch.testing.assert_close(ik64, i64, **TOL[torch.float64])
    for got, ref, r64 in ((tk[:nt], tp[:nt], t64[:nt]), (ik, ip, i64)):
        assert rel_err(got, r64) <= 2 * rel_err(ref, r64)


@pytest.mark.parametrize("nb", [128, 256])
@pytest.mark.parametrize("ordering", ["rcm", "nd"])
def test_factorization_deterministic(cuda, ordering, nb):
    """No atomics, one sum order: two kernel factorizations of the same
    store are bit-identical, chain and grouped."""
    t0, tab, kw, _ = _store_and_tables(cuda, ordering, nb=nb)
    f = _factor(ordering == "nd")
    tol = kt.DEFAULT_TOL[torch.float32]
    ta, ia = f(t0.clone(), tab, tol=tol, **kw)
    tb, ib = f(t0.clone(), tab, tol=tol, **kw)
    assert torch.equal(ta, tb) and torch.equal(ia, ib)


def _factored_pair(cuda, gen, dtype, ordering):
    """The same matrix factored on the card and on the CPU."""
    a = gen()
    hs = []
    for dev in ("cuda", "cpu"):
        h = pt.init(a, pt.InitOptions(nb=16, dtype=dtype, ordering=ordering,
                                      device=dev))
        pt.gstrf(h)
        hs.append(h)
    return a, *hs


@pytest.mark.parametrize("dtype,ordering", [("r32", "rcm"), ("r32", "nd"),
                                            ("r64", "nd")])
def test_transpose_solve_on_cuda(cuda, dtype, ordering):
    """gstrs(trans=True) on the card equals the CPU path's, and the
    refined solution meets the residual bound."""
    a, hc, hh = _factored_pair(cuda, lambda: poisson2d(12), dtype, ordering)
    s = a.to_scipy()
    b = s.T @ np.random.default_rng(4).standard_normal((a.n, 2))
    x0 = pt.gstrs(hc, b, refine=0, trans=True)
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "r32"
           else dict(rtol=1e-10, atol=1e-10))
    np.testing.assert_allclose(x0, pt.gstrs(hh, b, refine=0, trans=True),
                               **tol)
    x = pt.gstrs(hc, b, trans=True)
    for c in range(2):
        assert residual_norm(s.T.tocsc(), x[:, c], b[:, c]) < 1e-10


@pytest.mark.parametrize("ordering", ["rcm", "nd"])
def test_gstrs_device_on_cuda(cuda, ordering):
    """gstrs_device takes and returns CUDA tensors, makes two K3 or K5
    launches with refine=1, and matches the host path."""
    a, hc, hh = _factored_pair(cuda, lambda: poisson2d(12), "r32", ordering)
    b = (a.to_scipy() @ np.random.default_rng(5).standard_normal((a.n, 4))
         ).astype(np.float32)
    kc.reset_launch_counts()
    x = pt.gstrs_device(hc, torch.as_tensor(b, device=cuda), refine=1)
    engine = {"mega": "mega_solve", "mega_group": "mega_solve_groups"}[
        hc._trisolver.dispatch]
    assert kc.LAUNCHES[engine] == 2
    assert sum(kc.LAUNCHES.values()) == 2
    assert x.is_cuda and tuple(x.shape) == (a.n, 4)
    xh = pt.gstrs_device(hh, torch.as_tensor(b), refine=1).numpy()
    np.testing.assert_allclose(x.cpu().numpy(), xh, rtol=1e-4, atol=1e-5)
    for c in range(4):
        assert residual_norm(a.to_scipy(), x[:, c].cpu().numpy(),
                             b[:, c]) < 5e-5


def test_update_values_then_gstrf_on_cuda(cuda):
    """update_values + gstrf on the card: the kernels run again (K1 per
    group, one K4), and the new factor solves the new matrix."""
    a = poisson2d(12)
    h = pt.init(a, pt.InitOptions(nb=16, dtype="r32", ordering="nd",
                                  device="cuda", check=True))
    pt.gstrf(h)
    s2 = a.to_scipy().copy()
    s2.data = s2.data * (1.0 + 0.1 * np.random.default_rng(6).random(
        s2.nnz))
    pt.update_values(h, s2)
    kc.reset_launch_counts()
    pt.gstrf(h)
    ng = h._factorizer.tables.host["ngroups"]
    assert kc.LAUNCHES == _counts(getrf_with_inverses=ng,
                                  mega_factorize_groups=1)
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    b = s2 @ np.ones(a.n)
    assert residual_norm(h.a_origin, pt.gstrs(h, b), b) < 1e-10


# ---- complex types, through the real 2x2 embedding

@pytest.mark.parametrize("storage", ["dense", "compressed"])
@pytest.mark.parametrize("ordering", ["rcm", "nd"])
@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
def test_complex_on_cuda(cuda, dtype, ordering, storage):
    """cr32 and cr64 on the card: the embedded store factored by the
    kernels (K1 with K2 or K4; P6 in the compressed store) equals the
    CPU twins' factorization of the same store at the kernels'
    tolerances, with exact launch counts; the unrefined solves (K3, K5
    or the compressed engine's) equal the CPU path's; the refined
    residual, against A in the working precision, meets the slice's
    bound (cr32 1e-10 after 2 rounds, cr64 1e-12)."""
    from pangulu_tpu_torch.testing import (compressed_launches,
                                           with_imaginary_parts)

    a = with_imaginary_parts(poisson2d(12))
    opts = dict(nb=16, dtype=dtype, ordering=ordering, tile_storage=storage)
    kc.reset_launch_counts()
    hc = pt.init(a, pt.InitOptions(device="cuda", **opts))
    pt.gstrf(hc)
    b = a.to_scipy() @ (np.ones(a.n) + 1j * np.arange(a.n))
    x = pt.gstrs(hc, b)
    f32 = dtype == "cr32"
    solves = 3 if f32 else 1
    sch = hc.schedule
    if storage == "compressed":
        want = compressed_launches(sch, factorizations=1, solves=solves)
    elif hc._factorizer.dispatch == "mega":
        want = dict(getrf_with_inverses=sch.block_length, mega_factorize=1,
                    mega_solve=solves)
    else:
        want = dict(getrf_with_inverses=hc._factorizer.tables.host["ngroups"],
                    mega_factorize_groups=1, mega_solve_groups=solves)
    assert kc.LAUNCHES == _counts(**want)
    hh = pt.init(a, pt.InitOptions(device="cpu", **opts))
    pt.gstrf(hh)
    if storage == "compressed":
        got, ref = (torch.as_tensor(h.factor_tiles.to_dense())
                    for h in (hc, hh))
    else:
        got, ref = hc.factor_tiles.cpu(), hh.factor_tiles
    grouped = storage == "compressed" or hc._factorizer.dispatch != "mega"
    tol = (TOL[torch.float64] if not f32 else
           dict(rtol=2e-4, atol=2e-4) if grouped else TOL[torch.float32])
    torch.testing.assert_close(got, ref, **tol)
    stol = (dict(rtol=1e-4, atol=1e-5) if f32
            else dict(rtol=1e-10, atol=1e-10))
    np.testing.assert_allclose(pt.gstrs(hc, b, refine=0),
                               pt.gstrs(hh, b, refine=0), **stol)
    assert x.dtype == np.complex128 and np.isfinite(x).all()
    aw = a.to_scipy().astype(hc.complex_embed)
    assert residual_norm(aw, x, b) < (1e-10 if f32 else 1e-12)


# ---- the compressed store: P6 (slot kernels) and P2 (Newton inverses)

def _compressed_store(nb, dtype, device, gen=None):
    from pangulu_tpu_torch.testing import compressed_store

    a = gen() if gen else poisson2d(12 if nb <= 128 else 20)
    if dtype.startswith("c"):
        a = with_imaginary_parts(a)
    return compressed_store(a, nb, dtype, ordering="nd", device=device)[1]


def _slot_batch(st, batch, sms):
    """The tile ids of a P6 batch: every tile with the scratch tile at
    both ends ("ends") or also mid-batch ("mid"), the tile of the largest
    cap alone ("largest"), or every tile and the scratch tile repeated
    until the batch holds more than ``sms`` x the blocks a tile gets
    ("wide"), or, where the plain version's [batch, largest cap]
    positions would pass 2 GiB first (nb = 512), more than ``sms``
    tiles."""
    nt = st.num_tiles
    tiles = np.arange(nt)[::-1]
    if batch == "ends":
        return np.r_[nt, tiles, nt]
    if batch == "mid":
        return np.r_[tiles[:nt // 2], nt, nt, tiles[nt // 2:], nt]
    if batch == "largest":
        return np.array([int(np.argmax(st.host_cap))])
    ids = np.r_[tiles, nt]
    esz = st.values.element_size()
    while True:
        cap = np.append(st.host_cap, 0)[ids]
        chunks = kc.stage_geometry(st.nb, esz, cap, sms).chunks
        if len(ids) > sms * chunks or (
                len(ids) > sms and 2 * len(ids) * cap.max() * 8 > 2 ** 31):
            return ids
        ids = np.r_[ids, np.full(len(ids), nt)]


@pytest.mark.parametrize("batch", ["ends", "mid", "largest", "wide"])
# slot words of 4 (r32), 8 (r64, cr32) and 16 bytes (cr64)
@pytest.mark.parametrize("dtype", ["r32", "r64", "cr32", "cr64"])
# u16 slots (odd nb = 5 and 10 take the unaligned dense stores), u32 from
# 256; at 512 poisson3d(16)'s largest tile holds more than 65,536 slots,
# so that slot_range's second round takes several passes
@pytest.mark.parametrize("nb", [5, 10, 16, 100, 128, 256, 288, 512])
def test_slot_kernels_bit_exact(cuda, dtype, nb, batch):
    """P6 against its plain version bit for bit, both directions, on
    random slot values (complex: random real and imaginary parts): every
    tile of the store with the scratch tile (cap 0) at both ends or also
    mid-batch, the tile of the largest cap alone (at nb=128
    poisson3d(16)'s, a full 16,384-slot tile), and a batch wider than
    the card's SMs times the blocks a tile gets."""
    gen = (lambda: poisson3d(16)) if nb in (128, 512) else None
    st = _compressed_store(nb, dtype, cuda, gen)
    assert st.idx.dtype == (torch.uint32 if nb >= 256 else torch.uint16)
    if nb == 512:
        assert st.host_cap.max() > 256 * 256
    rng = np.random.default_rng(nb)
    v = rng.standard_normal(st.values.numel())
    if st.values.is_complex():
        v = v + 1j * rng.standard_normal(st.values.numel())
    st.values = torch.as_tensor(v, dtype=st.values.dtype, device=cuda)
    nt = st.num_tiles
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    host = _slot_batch(st, batch, sms)
    ids = kt.Indices.build(host, cuda)
    args = (st.values, st.idx, st.off, st.cap, ids)
    got = kc.decompress_tiles(*args, nb)
    assert torch.equal(got, kt.decompress_tiles(*args, nb))
    assert not got[torch.as_tensor(host == nt, device=cuda)].any()
    back = {f: torch.full_like(st.values, 5.0) for f in ("k", "p")}
    kc.compress_tiles(back["k"], st.idx, st.off, st.cap, ids, got)
    kt.compress_tiles(back["p"], st.idx, st.off, st.cap, ids, got)
    torch.cuda.synchronize()
    assert torch.equal(back["k"], back["p"])
    named = np.zeros(st.values.numel(), dtype=bool)
    for t in host[host != nt]:
        named[st.host_off[t]:st.host_off[t] + st.host_cap[t]] = True
    named = torch.as_tensor(named, device=cuda)
    assert torch.equal(back["k"][named], st.values[named])
    assert (back["k"][~named] == 5.0).all()   # other slots untouched


# nb > 256: the sweeps on each 128-wide diagonal block, then one
# products launch a level of the tree (2 at 288 to 512, 3 at 640)
@pytest.mark.parametrize("nb", [8, 100, 128, 256, 288, 384, 512, 640])
def test_newton_kernel(cuda, nb):
    """P2 against its plain twin (triangle_inverses, the sweeps), a tiny
    pivot included: f64 within 1e-12 and f32 within the f32 contract's
    1e-5, both relative to the largest entry.  True f32 at every nb and
    on the tiny-pivot tile too, against the JAX package's method (the
    plain Newton doubling, newton_inverses):
    the f32 kernel's error against the plain f64 inverse (relative to its
    largest entry) is at most 2x the plain f32 version's, or one f32 eps
    where both sit within an ulp or two (at nb=8 the kernel read 8.5e-8
    against 2 x 3.1e-8 on an H100)."""
    rng = np.random.default_rng(nb)
    a = rng.standard_normal((16, nb, nb)) + nb * np.eye(nb)
    a[1] = tiny_pivot_tile(nb, nb // 2, rng)
    f64 = kt.getrf_with_inverses(torch.as_tensor(a, device=cuda))[0]
    for f, rel in ((f64, 1e-12), (f64.float(), 1e-5)):
        for g, r in zip(kc.newton_inverses(f), kt.triangle_inverses(f)):
            torch.testing.assert_close(g, r, rtol=rel,
                                       atol=rel * float(r.abs().max()))
    f32 = f64.float()
    tol = kt.DEFAULT_TOL[torch.float32]
    eps = torch.finfo(torch.float32).eps
    for g, p, r in zip(kc.newton_inverses(f32), kt.newton_inverses(f32),
                       kt.newton_inverses(f32.double(), tol)):
        ek = float((g.double() - r).abs().max() / r.abs().max())
        ep = float((p.double() - r).abs().max() / r.abs().max())
        assert ek <= max(2 * ep, eps), (ek, ep)


# (dtype, nb): K1's register tile at 16, its cluster kernel for wide
# tiles and P2's tree at 288; native complex tiles (P6's 16-byte slots,
# kernels_xla's diagonal step, the plain doubling on reload)
@pytest.mark.parametrize("dtype,nb", [("r32", 16), ("r64", 16),
                                      ("r32", 288), ("r64", 288),
                                      ("cr32", 16), ("cr64", 16)])
def test_compressed_path_on_cuda_counts_launches(cuda, dtype, nb):
    """init -> gstrf -> gstrs with tile_storage="compressed" on the card:
    exact launch counts, the factors of the plain version on the CPU
    (real tiles: K1's plain version, backend "cuda"; complex: the same
    kernels_xla step), and then a checkpoint reloaded on the card (P6,
    then P2 for real tiles).  Complex tiles are native
    (complex_mode="native"), the residual in complex128."""
    import tempfile

    from pangulu_tpu_torch.io import load_factor, save_factor
    from pangulu_tpu_torch.testing import compressed_launches

    cplx = dtype.startswith("c")
    a = poisson2d(16 if nb <= 128 else 30)
    if cplx:
        a = with_imaginary_parts(a)
    aw = a.to_scipy().astype(np.complex64 if dtype == "cr32" else
                             np.complex128 if cplx else np.float64)
    b = aw @ np.ones(a.n)
    opts = dict(nb=nb, dtype=dtype, ordering="nd",
                tile_storage="compressed", complex_mode="native")
    kc.reset_launch_counts()
    h = pt.init(a, pt.InitOptions(device="cuda", **opts))
    pt.gstrf(h)
    x = pt.gstrs(h, b, refine=0)
    assert kc.LAUNCHES == _counts(**compressed_launches(
        h.schedule, factorizations=1, solves=1, complex_tiles=cplx))
    hc = pt.init(a, pt.InitOptions(device="cpu", backend="auto" if cplx
                                   else "cuda", **opts))
    pt.gstrf(hc)
    f32 = dtype in ("r32", "cr32")
    tol = TOL[torch.float32 if f32 else torch.float64]
    np.testing.assert_allclose(h.factor_tiles.to_dense(),
                               hc.factor_tiles.to_dense(), **tol)
    assert residual_norm(aw.astype(np.complex128 if cplx else np.float64),
                         pt.gstrs(h, b), b) < (1e-10 if f32 else 1e-12)
    with tempfile.TemporaryDirectory() as tmp:
        save_factor(h, f"{tmp}/f.npz")
        h2 = load_factor(f"{tmp}/f.npz", device="cuda")
    kc.reset_launch_counts()
    x2 = pt.gstrs(h2, b, refine=0)
    assert kc.LAUNCHES == _counts(**compressed_launches(
        h.schedule, solves=1, reloads=1, complex_tiles=cplx))
    np.testing.assert_allclose(x2, x, rtol=1e-4 if f32 else 1e-10,
                               atol=1e-5 if f32 else 1e-10)


# ---- the out-of-core panel driver: K2 a panel cross, P6 staging

PANEL_CASES = {
    # poisson2d(24) nb=16 rcm in panels of 5, chunks of 8 updates
    "poisson2d24_nb16": (lambda: poisson2d(24), 16, "rcm", 5, 8),
    # poisson3d(16) nb=128 nd in panels of 8 (4 panels)
    "poisson3d16_nb128_nd": (lambda: poisson3d(16), 128, "nd", 8, 2048),
}


@pytest.mark.parametrize("case", sorted(PANEL_CASES))
def test_panel_lu_on_cuda_matches_cpu(cuda, case):
    """PanelLU on the card (K2 once a panel cross, P6 for the cross and
    each out-update chunk) against its CPU twins on the same store and
    panels: the factored store and the inverses at the f32 contract,
    the launches exactly testing.panel_launches, two factorizations of
    one store the same bits, and the solve (CompressedLU's on the
    store) against the CPU's."""
    from pangulu_tpu_torch.outofcore import PanelLU
    from pangulu_tpu_torch.testing import panel_launches

    gen, nb, ordering, w, out_chunk = PANEL_CASES[case]
    a = gen()
    h = pt.init(a, pt.InitOptions(nb=nb, dtype="r32", ordering=ordering,
                                  device="cpu"))
    args = (h.blocked, h.schedule, h.reordering.reordered)
    kw = dict(panel_width=w, out_chunk=out_chunk)
    ref = PanelLU(*args, device="cpu", **kw)
    ref.factorize()
    plu = PanelLU(*args, device="cuda", **kw)
    v0 = plu.store.values.clone()
    kc.reset_launch_counts()
    plu.factorize()
    torch.cuda.synchronize()
    assert plu.panel_cols == ref.panel_cols and len(plu.panel_cols) > 1
    assert kc.LAUNCHES == _counts(**panel_launches(plu))
    assert sum(len(plu._pass(*c).chunks) for c in plu.panel_cols) > 0
    np.testing.assert_allclose(plu.store.to_dense(), ref.store.to_dense(),
                               **TOL[torch.float32])
    torch.testing.assert_close(plu.inv_tiles.cpu(), ref.inv_tiles,
                               **TOL[torch.float32])
    first = plu.store.values.clone()
    plu.store.values.copy_(v0)
    plu.factorize()
    assert torch.equal(plu.store.values, first)
    b = a.to_scipy() @ np.ones(a.n)
    bt = h.reordering.transform_b(b.astype(np.float32))
    np.testing.assert_allclose(plu.solve(bt), ref.solve(bt), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("nb", [128, 256])
def test_panel_route_on_cuda_counts_launches(cuda, nb):
    """init -> gstrf -> gstrs with tile_storage="compressed" at r32 and
    nb 128 or 256 on the card takes PanelLU (one panel at the default
    budget): exact launches, the repo's r32 residual limits; a
    checkpoint of its store reloads on the card (P6, then P2)."""
    import tempfile

    from pangulu_tpu_torch.io import load_factor, save_factor
    from pangulu_tpu_torch.outofcore import PanelLU
    from pangulu_tpu_torch.testing import compressed_launches, panel_launches

    a = poisson3d(12)
    b = a.to_scipy() @ np.ones(a.n)
    kc.reset_launch_counts()
    h = pt.init(a, pt.InitOptions(nb=nb, dtype="r32", ordering="nd",
                                  device="cuda", tile_storage="compressed",
                                  check=True))
    pt.gstrf(h)
    x = pt.gstrs(h, b)
    assert isinstance(h._factorizer, PanelLU)
    assert h.perf.kernels["engine"] == "panel"
    assert h._factorizer.panel_cols == [(0, h.schedule.block_length)]
    assert kc.LAUNCHES == _counts(**panel_launches(h._factorizer, solves=3))
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    assert residual_norm(a.to_scipy(), x, b) < 1e-10
    with tempfile.TemporaryDirectory() as tmp:
        save_factor(h, f"{tmp}/f.npz")
        h2 = load_factor(f"{tmp}/f.npz", device="cuda")
    kc.reset_launch_counts()
    x2 = pt.gstrs(h2, b)
    assert kc.LAUNCHES == _counts(**compressed_launches(
        h.schedule, solves=3, reloads=1))
    np.testing.assert_allclose(x2, x, rtol=1e-4, atol=1e-5)


def _rel(got, p64, per_row=False) -> float:
    """max |got - p64| over max |p64|, or over each row's max |p64|."""
    scale = (p64.abs().amax(-1, keepdim=True) if per_row
             else p64.abs().max())
    return float(((got.double() - p64).abs() / scale).max())


def _true_f32(got, p32, p64, per_row=False) -> None:
    """The kernel's error against the plain f64 version at most 2x the
    plain f32 version's (both relative to max |f64|, or to each row's),
    or one f32 eps."""
    ek, ep = _rel(got, p64, per_row), _rel(p32, p64, per_row)
    assert torch.isfinite(got).all()
    assert ek <= max(2 * ep, torch.finfo(torch.float32).eps), (ek, ep)


def _probe_tensors(cuda, seed, nb=128):
    return (torch.as_tensor(x, device=cuda)
            for x in probe_inputs(seed=seed, nb=nb))


@pytest.mark.parametrize("steps", [0, 37, 128, 256])
@pytest.mark.parametrize("mode", ["scan", "dots", "both", "split"])
def test_scan_overlap_kernel(cuda, mode, steps):
    """P5 in each mode; 37 steps stop inside a pass."""
    a, b = _probe_tensors(cuda, steps)
    kc.reset_launch_counts()
    got = kc.scan_overlap(a, b, mode, steps)
    assert kc.LAUNCHES == _counts(scan_overlap=1)
    _true_f32(got, kt.scan_overlap(a, b, mode, steps),
              kt.scan_overlap(a.double(), b.double(), mode, steps))


@pytest.mark.parametrize("nb,steps", [(48, 300), (128, 300), (128, 4096)])
def test_scan_overlap_scan_parts_agree(cuda, nb, steps):
    """With b = 0 the products stay 0, so "both" and "split", with either
    products, return their scan alone: the same bits as "scan", which is
    the plain f32 scan to within true f32 (at 300 steps); copies repeat
    the problem.  4096 steps: the probe's own count."""
    a, _ = _probe_tensors(cuda, nb, nb)
    zero = torch.zeros_like(a)
    scan = kc.scan_overlap(a, zero, "scan", steps)
    assert torch.isfinite(scan).all()
    for mode in ("both", "split"):
        for products in kc.PROBE_PRODUCTS:
            assert torch.equal(kc.scan_overlap(a, zero, mode, steps,
                                               products=products), scan)
    if steps == 300:
        _true_f32(scan, kt.scan_overlap(a, zero, "scan", steps),
                  kt.scan_overlap(a.double(), zero.double(), "scan", steps))
    many = kc.scan_overlap(a, zero, "split", steps, copies=3)
    assert many.shape == (3, nb, nb) and all(torch.equal(m, scan)
                                             for m in many)


@pytest.mark.parametrize("products", ["f64", "tf32x3"])
def test_scan_overlap_two_streams_at_once(cuda, products):
    """Two P5 "split" calls in flight at once on two streams, each held
    to its plain version: each call sums its copies behind completion
    counters of its own, so neither sees the other's arrivals."""
    runs = [tuple(_probe_tensors(cuda, seed, nb))
            for seed, nb in ((21, 128), (22, 100))]
    streams = [torch.cuda.Stream(cuda) for _ in runs]
    got = []
    for (a, b), s in zip(runs, streams):
        s.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s):
            torch.cuda._sleep(2_000_000)  # both launches queue first
            got.append(kc.scan_overlap(a, b, "split", 256, copies=4,
                                       products=products))
    torch.cuda.synchronize()
    for (a, b), g in zip(runs, got):
        assert all(torch.equal(m, g[0]) for m in g)
        p64 = kt.scan_overlap(a.double(), b.double(), "split", 256)
        if products == "f64":
            _true_f32(g[0], kt.scan_overlap(a, b, "split", 256), p64)
        else:
            assert torch.isfinite(g[0]).all() and _rel(g[0], p64) <= 1e-4


@pytest.mark.parametrize("mode", ["dots", "both", "split"])
def test_scan_overlap_many_copies(cuda, mode):
    """copies = 10: 160 product CTAs, more than the card holds at once
    (one an SM), so later CTAs start after earlier ones end; every copy
    is the first, which is the plain version's to within true f32."""
    a, b = _probe_tensors(cuda, 10)
    kc.reset_launch_counts()
    many = kc.scan_overlap(a, b, mode, 128, copies=10)
    assert kc.LAUNCHES == _counts(scan_overlap=1)
    assert many.shape == (10, 128, 128)
    assert all(torch.equal(m, many[0]) for m in many)
    _true_f32(many[0], kt.scan_overlap(a, b, mode, 128),
              kt.scan_overlap(a.double(), b.double(), mode, 128))


@pytest.mark.parametrize("steps", [128, 256])
@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("q", [1, 2, 4, 8])
def test_scan_multi_kernel(cuda, q, with_dot, steps):
    """P4: each chain on a CTA of its own, the products on a cluster."""
    a, b = _probe_tensors(cuda, q)
    kc.reset_launch_counts()
    got = kc.scan_multi(a, b, q, with_dot, steps)
    assert kc.LAUNCHES == _counts(scan_multi=1)
    _true_f32(got, kt.scan_multi(a, b, q, with_dot, steps),
              kt.scan_multi(a.double(), b.double(), q, with_dot, steps))


@pytest.mark.parametrize("steps", [300, 2048])
@pytest.mark.parametrize("q", [1, 2, 4, 8])
def test_scan_multi_scan_parts_agree(cuda, q, steps):
    """With b = 0 the products stay 0, so P4 with products, of either
    type, returns the bits of its chains alone: this holds the chains and
    the final sum of the instances with products at the probe's own 2048
    steps, which the products' values would hide."""
    a, _ = _probe_tensors(cuda, q)
    zero = torch.zeros_like(a)
    alone = kc.scan_multi(a, zero, q, False, steps)
    assert torch.isfinite(alone).all()
    for products in kc.PROBE_PRODUCTS:
        assert torch.equal(kc.scan_multi(a, zero, q, True, steps,
                                         products=products), alone)


@pytest.mark.parametrize("case", ["dots", "both", "split", 1, 2, 4, 8])
def test_probe_tf32x3_products(cuda, case):
    """The 3xTF32 instances (the solver's float products, timed beside
    the f64 ones) at 128 steps: within 1e-4 of max |plain f64| (they
    drift on the chain a^s b, ~7e-6 on an H100, against plain f32's
    ~2e-6, so not true f32)."""
    a, b = _probe_tensors(cuda, 128)
    if isinstance(case, str):
        got = kc.scan_overlap(a, b, case, 128, products="tf32x3")
        p64 = kt.scan_overlap(a.double(), b.double(), case, 128)
    else:
        got = kc.scan_multi(a, b, case, True, 128, products="tf32x3")
        p64 = kt.scan_multi(a.double(), b.double(), case, True, 128)
    assert torch.isfinite(got).all()
    assert _rel(got, p64) <= 1e-4


def test_scan_multi_kernel_small_tile_copies(cuda):
    """nb = 40 (zero padding in the chains' registers and in the
    products' blocks), 3 copies (each its own chains and cluster), a step
    count inside a pass."""
    a, b = _probe_tensors(cuda, 40, 40)
    got = kc.scan_multi(a, b, 8, True, 100, copies=3)
    assert got.shape == (3, 40, 40)
    assert all(torch.equal(g, got[0]) for g in got)
    _true_f32(got[0], kt.scan_multi(a, b, 8, True, 100),
              kt.scan_multi(a.double(), b.double(), 8, True, 100))


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("steps", [None, 0, 1, 2])
@pytest.mark.parametrize("blocks", [4, 8, 16])
@pytest.mark.parametrize("g,nb", [(4, 16), (16, 128), (5, 100)])
def test_newton_loop_kernel(cuda, g, nb, blocks, steps, mixed):
    """P3, a thread block cluster of ``blocks`` CTAs a member, on the
    probe's unit lower triangles (mixed: member 1 a general matrix, which
    takes full products beside the triangles' skip) at the probe's steps
    (None) and truncated counts: f32 true f32, f64 within 1e-12 of the
    plain f64 version, both relative to each row's largest entry (the
    inverses span ~1e17, so the rows of small entries count too)."""
    inputs = newton_mixed_inputs if mixed else newton_inputs
    lm = torch.as_tensor(inputs(g, nb, seed=nb), device=cuda)
    steps = kt.newton_steps(nb) if steps is None else steps
    kc.reset_launch_counts()
    got = kc.newton_loop(lm, steps, blocks=blocks)
    assert kc.LAUNCHES == _counts(newton_loop=1)
    p64 = kt.newton_loop(lm.double(), steps)
    _true_f32(got, kt.newton_loop(lm, steps), p64, per_row=True)
    g64 = kc.newton_loop(lm.double(), steps, blocks=blocks)
    assert _rel(g64, p64, per_row=True) <= 1e-12


def test_newton_loop_refused_cluster(cuda):
    """Cluster sizes the kernel does not take (2: not 4 row blocks; 32:
    above the card's 16) raise before a launch, and count none."""
    lm = torch.as_tensor(newton_inputs(2, 128), device=cuda)
    kc.reset_launch_counts()
    with pytest.raises(ValueError, match="cluster size must be one of"):
        kc.newton_loop(lm, 2, blocks=2)
    with pytest.raises(ValueError, match="must be <= 16"):
        kc.newton_loop(lm, 2, blocks=32)
    assert kc.LAUNCHES == _counts()


def test_scan_multi_refused_cluster(cuda):
    """P4's float64 products on a cluster of 4 CTAs need 236,544 bytes of
    shared memory a CTA: refused, no launch counted; their 3xTF32
    instance (121,344 bytes) runs there, and the next launch is
    unaffected."""
    a, b = _probe_tensors(cuda, 4)
    kc.reset_launch_counts()
    with pytest.raises(RuntimeError, match="plu_scan_multi_f32"):
        kc.scan_multi(a, b, 2, True, 16, cluster=4)
    assert kc.LAUNCHES == _counts()
    got = kc.scan_multi(a, b, 2, True, 128, products="tf32x3", cluster=4)
    assert _rel(got, kt.scan_multi(a.double(), b.double(), 2, True,
                                   128)) <= 1e-4
    _true_f32(kc.scan_multi(a, b, 2, True, 128),
              kt.scan_multi(a, b, 2, True, 128),
              kt.scan_multi(a.double(), b.double(), 2, True, 128))


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_cluster_sync_probe(cuda, cluster):
    """The cluster barrier of P4's and P3's kernels launches and ends on
    clusters of 2 to 16 CTAs."""
    kc.cluster_sync_probe(cuda, cluster, 100)
    torch.cuda.synchronize()


def test_newton_kernel_on_unit_triangles(cuda):
    """P2 (newton_inverses) in float32 on P3's unit lower triangles at
    nb = 128, whose inverses reach ~1e13-1e17: true f32, relative to the
    largest entry and to each row's.  The doubling P2 ran until its
    redesign failed here on an H100 (8.018e-06 of max |f64| against the
    plain f32 version's 2.918e-06, G = 4: the 3xTF32 errors of its chain
    of products added up); the sweeps, in float64 and rounded once,
    leave only the rounding of the store."""
    lm = torch.as_tensor(newton_inputs(4, 128, seed=128), device=cuda)
    tol = kt.DEFAULT_TOL[torch.float32]
    got = kc.newton_inverses(lm)[0]
    p32 = kt.newton_inverses(lm)[0]
    p64 = kt.newton_inverses(lm.double(), tol)[0]
    assert torch.isfinite(got).all()
    eps = torch.finfo(torch.float32).eps
    readings = {scale: (_rel(got, p64, row), _rel(p32, p64, row))
                for scale, row in (("max", False), ("row", True))}
    assert all(ek <= max(2 * ep, eps) for ek, ep in readings.values()), \
        readings


# ---- profile_dir and the panel driver under an allocator cap


def test_profile_dir_on_cuda(cuda, tmp_path):
    """gstrf with profile_dir on the card (poisson3d(12), nb=128, nd,
    r32: K1 and K4) writes exactly one Chrome trace that parses and holds
    device kernels of K1 or K4 (the profiler may lose some, so their
    launch counts are not read from it), and the factors are the bits of
    a run without profile_dir."""
    a = poisson3d(12)
    opts = dict(nb=128, dtype="r32", ordering="nd", device="cuda")
    plain = pt.init(a, pt.InitOptions(**opts))
    pt.gstrf(plain)
    h = pt.init(a, pt.InitOptions(profile_dir=str(tmp_path), **opts))
    pt.gstrf(h)
    files = sorted(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    assert any("getrf_inv_kernel" in n or "group_schur_kernel" in n
               for n in kernels), sorted(kernels)[:20]
    assert torch.equal(h.factor_tiles, plain.factor_tiles)


def test_panel_lu_cross_budget_reads_the_allocator_cap(cuda, monkeypatch):
    """PanelLU's cross budget is the card's memory times the process's
    allocator fraction less the store and 4 GiB: under a cap that leaves
    a third of the matrix's tiles it makes more panels than without one,
    and the bits of an uncapped run given the same budget through
    PANGULU_OOC_CROSS_GB.  The fraction is reset afterwards."""
    from pangulu_tpu_torch.outofcore import PanelLU

    monkeypatch.delenv("PANGULU_OOC_CROSS_GB", raising=False)
    h = pt.init(poisson3d(16), pt.InitOptions(nb=128, dtype="r32",
                                              ordering="nd", device="cpu"))
    args = (h.blocked, h.schedule, h.reordering.reordered)
    free = PanelLU(*args, device="cuda")
    free.factorize()
    tile_b = 128 * 128 * 4
    total = torch.cuda.mem_get_info(cuda)[1]
    want = h.blocked.num_tiles // 3
    cap = 4 * 2 ** 30 + free.store.compressed_bytes + want * tile_b
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(cap / total, cuda)
    try:
        capped = PanelLU(*args, device="cuda")
        budget = capped._dense_budget_tiles()
        capped.factorize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, cuda)
    assert torch.cuda.get_per_process_memory_fraction(cuda) == 1.0
    assert abs(budget - want) <= 1
    assert len(capped.panel_cols) > len(free.panel_cols)
    monkeypatch.setenv("PANGULU_OOC_CROSS_GB", repr(budget * tile_b / 2 ** 30))
    same = PanelLU(*args, device="cuda")
    assert same._dense_budget_tiles() == budget
    same.factorize()
    assert same.panel_cols == capped.panel_cols
    assert torch.equal(same.store.values, capped.store.values)


@pytest.mark.parametrize("nb,dtype", [(128, "r32"), (128, "r64"),
                                      (256, "r32"), (384, "r32")])
def test_superfused_on_cuda(cuda, nb, dtype):
    """dispatch="superfused" on the card: one K1 launch (one device
    launch) a super-level on the batch of its diagonals and no other
    kernel; the factor within 1e-5 (f64 1e-12) of the fused engine's on
    the same store, relative to its largest entry (the updates of one
    super-level sum in member order, not level order); gstrs through the
    handle takes the solve auto picks (K5 on rebuilt inverses at nb <=
    256, the fused level solve above), residual < 1e-10."""
    a = poisson3d(14)
    h = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, ordering="nd",
                                  device="cuda"))
    ngroups = len(h.schedule.superlevels())
    assert ngroups < h.schedule.block_length
    kc.reset_launch_counts()
    fac = pt.numeric.LUFactorizer(h.blocked, h.schedule, device="cuda",
                                  dispatch="superfused")
    tiles = fac.factorize()
    assert kc.LAUNCHES == _counts(getrf_with_inverses=ngroups)
    assert kc.DEVICE_LAUNCHES == {"getrf_with_inverses": ngroups}
    assert fac.backend.name == "cuda"
    fused = pt.numeric.LUFactorizer(h.blocked, h.schedule, device="cuda",
                                    dispatch="fused").factorize()
    nt = h.blocked.num_tiles
    err = float((tiles[:nt] - fused[:nt]).abs().max()
                / fused[:nt].abs().max())
    assert err < (1e-5 if dtype == "r32" else 1e-12)
    assert torch.equal(fac.factorize(), tiles)
    h._factorizer, h.factor_tiles = fac, tiles
    b = a.to_scipy() @ np.ones(a.n)
    x = pt.gstrs(h, b)
    assert h._trisolver.dispatch == ("mega_group" if nb <= 256
                                     else "fused")
    assert residual_norm(a.to_scipy(), x, b) < 1e-10


def test_segmented_on_cuda(cuda):
    """dispatch="segmented" on the card runs the fused engine: one K1
    launch a level, the fused engine's bits."""
    h = pt.init(poisson3d(14), pt.InitOptions(nb=64, dtype="r32",
                                              ordering="nd", device="cuda"))
    kc.reset_launch_counts()
    fac = pt.numeric.LUFactorizer(h.blocked, h.schedule, device="cuda",
                                  dispatch="segmented")
    tiles = fac.factorize()
    bl = h.schedule.block_length
    assert kc.LAUNCHES == _counts(getrf_with_inverses=bl)
    assert fac.dispatch == "fused"
    assert torch.equal(tiles, pt.numeric.LUFactorizer(
        h.blocked, h.schedule, device="cuda", dispatch="fused").factorize())
