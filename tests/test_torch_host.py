"""Host pipeline parity: the port's init (MC64, ordering, symbolic,
tiling, level schedule and kernel tables) against the JAX package's, on
the same matrices.  Everything compared here is integer structure or
values computed by the same numpy code, so the tolerance is zero: the
arrays must be bit-equal."""

import os

import numpy as np
import pytest
import scipy.sparse as sp

import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as ptm
import pangulu_tpu.models as pjm
from pangulu_tpu.api import InitOptions as JOpts, init as jinit
from pangulu_tpu.ops.kernels_pallas import mega_uch
from pangulu_tpu_torch.ops.kernels_torch import mega_uch as port_uch
from pangulu_tpu_torch.sparse import CscMatrix as TCsc
from pangulu_tpu.sparse import CscMatrix as JCsc

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _fixture(name):
    z = np.load(os.path.join(FIXDIR, name + ".npz"))
    return sp.csc_matrix((z["data"], z["indices"], z["indptr"]),
                         shape=tuple(z["shape"]))


# (id, factory returning (port matrix, jax matrix), nb)
CASES = [
    ("trefethen20", lambda: (ptm.trefethen(20), pjm.trefethen(20)), 10),
    ("poisson2d8", lambda: (ptm.poisson2d(8), pjm.poisson2d(8)), 16),
    ("randunsym96",
     lambda: (ptm.random_unsymmetric(96, 0.06, seed=5),
              pjm.random_unsymmetric(96, 0.06, seed=5)), 16),
] + [
    (f, (lambda f=f: (TCsc.from_scipy(_fixture(f)),
                      JCsc.from_scipy(_fixture(f)))), 32)
    for f in ("circuit_mna_2000", "powergrid_2025", "stiff_transport_1444")
]


def _eq(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert np.array_equal(a, b), name


def _tables_eq(prefix, ta, tb):
    assert ta.keys() == tb.keys(), prefix
    for k in ta:
        _eq(f"{prefix}.{k}", ta[k], tb[k])


def _compare(pa, ja, nb, ordering, dtype):
    hp = pt.init(pa, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                    device="cpu"))
    # complex types: the JAX package's real 2x2 embedding, the port's
    # only complex mode (real types ignore complex_mode)
    hj = jinit(ja, JOpts(nb=nb, dtype=dtype, ordering=ordering,
                         complex_mode="embed"))
    # generators, MC64 permutation + scalings, fill-reducing ordering
    _eq("a_origin", hp.a_origin.toarray(), hj.a_origin.toarray())
    for f in ("row_scale", "col_scale", "colperm", "perm"):
        _eq(f, getattr(hp.reordering, f), getattr(hj.reordering, f))
    for f in ("colptr", "rowidx", "values"):
        _eq(f"reordered.{f}", getattr(hp.reordering.reordered, f),
            getattr(hj.reordering.reordered, f))
    # symbolic analysis
    sp_, sj = hp.symbolic_result, hj.symbolic_result
    assert sp_.symbolic_nnz == sj.symbolic_nnz
    assert sp_.mode == sj.mode
    _eq("parent", sp_.parent, sj.parent)
    _eq("block_full", sp_.block_full.toarray(), sj.block_full.toarray())
    # block pattern and scatter plan
    bp, bj = hp.blocked, hj.blocked
    assert (bp.n, bp.nb, bp.block_length, bp.num_tiles) == (
        bj.n, bj.nb, bj.block_length, bj.num_tiles)
    for f in ("bcolptr", "browidx", "brownnzptr", "bcolidx", "tile_of_csr"):
        _eq(f, getattr(bp, f), getattr(bj, f))
    for i, (x, y) in enumerate(zip(bp.scatter_plan, bj.scatter_plan)):
        _eq(f"scatter_plan[{i}]", x, y)
    # level schedule
    cp, cj = hp.schedule, hj.schedule
    assert (cp.block_length, cp.n_tstrf, cp.n_gessm, cp.n_ssssm) == (
        cj.block_length, cj.n_tstrf, cj.n_gessm, cj.n_ssssm)
    assert cp.flop_estimate() == cj.flop_estimate()
    for lp, lj in zip(cp.levels, cj.levels):
        for f in ("k", "diag", "lpanel", "lrows", "upanel", "ucols",
                  "upd_dst", "upd_l", "upd_u", "ucolpanel", "ucolrows"):
            _eq(f"level.{f}", getattr(lp, f), getattr(lj, f))
    # kernel tables, padding included
    nt = bp.num_tiles
    assert port_uch(nb) == mega_uch(nb)
    _tables_eq("mega_tables", cp.mega_tables(nt, uch=port_uch(nb)),
               cj.mega_tables(nt, uch=mega_uch(nb)))
    _tables_eq("mega_solve_tables", cp.mega_solve_tables(nt),
               cj.mega_solve_tables(nt))
    for i, (x, y) in enumerate(zip(cp.fused_tables(nt),
                                   cj.fused_tables(nt))):
        _eq(f"fused_tables[{i}]", x, y)
    bl = cp.block_length
    for i, (x, y) in enumerate(zip(cp.fused_solve_tables(nt, bl),
                                   cj.fused_solve_tables(nt, bl))):
        _eq(f"fused_solve_tables[{i}]", x, y)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_host_pipeline_auto_ordering(case):
    _, build, nb = case
    pa, ja = build()
    _compare(pa, ja, nb, "auto", "r64")


@pytest.mark.parametrize("ordering", ["rcm", "nd", "mindeg", "natural"])
@pytest.mark.parametrize("case", CASES[1:3], ids=[c[0] for c in CASES[1:3]])
def test_host_pipeline_each_ordering(case, ordering):
    _, build, nb = case
    pa, ja = build()
    _compare(pa, ja, nb, ordering, "r32")


def test_host_pipeline_no_mc64():
    pa, ja = ptm.random_unsymmetric(96, 0.06, seed=5), \
        pjm.random_unsymmetric(96, 0.06, seed=5)
    hp = pt.init(pa, pt.InitOptions(nb=16, mc64=False, ordering="rcm",
                                    device="cpu"))
    hj = jinit(ja, JOpts(nb=16, mc64=False, ordering="rcm"))
    for f in ("row_scale", "col_scale", "colperm", "perm"):
        _eq(f, getattr(hp.reordering, f), getattr(hj.reordering, f))
