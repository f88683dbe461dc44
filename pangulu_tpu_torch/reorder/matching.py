"""Maximum-weight matching + equilibration ("MC64" phase).

Functional counterpart of the reference's Duff–Koster MC64 job-5
implementation (pangulu_reordering.c:149-681): find a column permutation
placing large entries on the diagonal, plus row/column scalings that
bring the matrix close to an I-dominant one, so the unpivoted numeric
factorization is stable.

Primary path: the native C++ sparse Jonker–Volgenant solver
(native/pangulu_host.cpp pangulu_mc64) on the MC64 job-5 cost
``c_ij = log(max_i |a_ij|) - log |a_ij|`` — the same optimization
problem as the reference's Dijkstra augmenting-path search — with
EXACT dual-variable scalings (unit matched diagonal, all scaled
|entries| <= 1, like the reference's exp() factors,
pangulu_reordering.c:655-663).  Fallback when the native lib is
unavailable: scipy's min-weight full bipartite matching plus Ruiz
equilibration (same stabilization role, inexact duals).

Failure semantics match the reference: a structurally singular matrix
degrades to the identity permutation with a warning
(pangulu_reordering.c:1152-1171).
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import min_weight_full_bipartite_matching

from pangulu_tpu_torch.sparse import CscMatrix

log = logging.getLogger("pangulu_tpu_torch")


def mc64_match(a: CscMatrix) -> np.ndarray:
    """Column permutation ``colperm`` s.t. ``A[:, colperm]`` has the
    max-product diagonal.  Returns identity on failure."""
    s = a.to_scipy().copy()
    s.data = np.abs(s.data)
    s.eliminate_zeros()
    n = a.n
    # Job-5 cost: log(col_max) - log|a_ij|, per *column* maximum
    # (the reference computes per-column logs at
    # pangulu_reordering.c:225-259).
    c = s.tocsc()
    cost = c.copy().astype(np.float64)
    if c.nnz:
        reps = np.diff(c.indptr)
        colmax = np.ones(n)
        nonempty = reps > 0
        colmax[nonempty] = np.maximum.reduceat(
            c.data, c.indptr[:-1][nonempty])
        cost.data = np.log(np.repeat(colmax, reps)) - np.log(c.data)
        # min_weight_full_bipartite_matching treats explicit zeros as
        # edges of weight 0; shift to keep all weights positive.
        cost.data = cost.data + 1.0
    try:
        rows, cols = min_weight_full_bipartite_matching(cost.T.tocsr())
        # cost.T rows = original columns; rows[k] is a column matched to
        # original row cols[k].
        colperm = np.empty(n, dtype=np.int64)
        colperm[cols] = rows  # column colperm[i] pairs with row i
        return colperm
    except ValueError:
        log.warning(
            "MC64 matching failed (structurally singular?) — falling back "
            "to identity column permutation (reference: "
            "pangulu_reordering.c:1152-1171)")
        return np.arange(n, dtype=np.int64)


def ruiz_scale(a_abs: sp.csc_matrix, iters: int = 10):
    """Ruiz equilibration: returns (row_scale, col_scale) with
    D_r A D_c having row/col inf-norms ~1."""
    n = a_abs.shape[0]
    dr = np.ones(n)
    dc = np.ones(n)
    m = a_abs.copy().astype(np.float64)
    for _ in range(iters):
        rmax = np.asarray(m.max(axis=1).todense()).ravel()
        cmax = np.asarray(m.max(axis=0).todense()).ravel()
        rmax[rmax == 0] = 1.0
        cmax[cmax == 0] = 1.0
        sr = 1.0 / np.sqrt(rmax)
        sc = 1.0 / np.sqrt(cmax)
        dr *= sr
        dc *= sc
        m = sp.diags(sr) @ m @ sp.diags(sc)
        if np.max(np.abs(1.0 - rmax)) < 1e-2 and np.max(np.abs(1.0 - cmax)) < 1e-2:
            break
    return dr, dc


def mc64_scale_and_match(a: CscMatrix, enable: bool = True):
    """Full MC64 phase: (row_scale, col_scale, colperm).

    ``A_scaled_permuted[:, j] = (Dr A Dc)[:, colperm[j]]`` has its
    largest entries on the diagonal.  The reference disables MC64 for
    complex value types (README.md:61); we support complex by matching
    on magnitudes, but honor ``enable=False`` for parity testing.
    """
    n = a.n
    if not enable:
        return np.ones(n), np.ones(n), np.arange(n, dtype=np.int64)
    s = a.to_scipy().copy()
    s.data = np.abs(s.data).astype(np.float64)
    s.eliminate_zeros()
    # Native path: exact Duff–Koster job-5 duals -> scalings with unit
    # matched diagonal and all |entries| <= 1 (native/pangulu_host.cpp
    # pangulu_mc64), like the reference's exp() factors
    # (pangulu_reordering.c:655-663).
    from pangulu_tpu_torch import native

    if s.nnz:
        res = native.mc64(n, s.indptr, s.indices, s.data)
        if res is not None:
            colperm, dr, dc = res
            return dr, dc, np.asarray(colperm, dtype=np.int64)
    # Fallback: scipy matching + Ruiz equilibration.
    dr, dc = ruiz_scale(s)
    scaled = sp.diags(dr) @ s @ sp.diags(dc)
    colperm = mc64_match(CscMatrix.from_scipy(scaled))
    return dr, dc, colperm
