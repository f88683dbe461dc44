"""Reordering driver: scaling + column matching + fill-reducing perm.

Counterpart of ``pangulu_reordering`` (pangulu_reordering.c:1130) and
the rhs/solution permutation helpers
(``pangulu_reorder_vector_b_tran``/``x_tran``,
pangulu_reordering.c:683-714).

Transform chain (matching the reference's pipeline):

    A1 = Dr @ A @ Dc                (MC64 scaling)
    A2[:, j] = A1[:, colperm[j]]    (MC64 column permutation)
    A3 = A2[p][:, p]                (fill-reducing symmetric perm)

Solving ``A x = b`` then becomes ``A3 w = (Dr*b)[p]`` with
``x = Dc * unpermute(w)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from pangulu_tpu_torch.reorder.fill_reducing import fill_reducing_order
from pangulu_tpu_torch.reorder.matching import mc64_scale_and_match
from pangulu_tpu_torch.sparse import CscMatrix

_REAL = (np.float32, np.float64)


def _scale_csc(s: sp.csc_matrix, dr: np.ndarray,
               dc: np.ndarray) -> sp.csc_matrix:
    """Dr @ s @ Dc with the stored pattern PRESERVED.  ``sp.diags(...)
    @ s`` prunes explicitly-stored zeros from the product, making the
    reordered pattern value-dependent — update_values on a matrix whose
    zero-structure changed (e.g. a complex embed gaining imaginary
    parts) would then see a spurious pattern mismatch."""
    s = sp.csc_matrix(s, copy=True)
    s.data = (s.data * dr.astype(s.dtype)[s.indices]
              * np.repeat(dc.astype(s.dtype), np.diff(s.indptr)))
    return s


@dataclasses.dataclass
class Reordering:
    row_scale: np.ndarray   # Dr
    col_scale: np.ndarray   # Dc
    colperm: np.ndarray     # MC64 column permutation
    perm: np.ndarray        # fill-reducing symmetric permutation p
    reordered: CscMatrix    # A3

    def transform_b(self, b: np.ndarray) -> np.ndarray:
        """b -> rhs of the reordered system (reference:
        pangulu_reorder_vector_b_tran)."""
        b = np.asarray(b)
        scale = self.row_scale.astype(b.real.dtype)
        if b.ndim == 1:
            return (scale * b)[self.perm]
        return (scale[:, None] * b)[self.perm]

    def transform_matrix(self, a: CscMatrix) -> CscMatrix:
        """Apply the SAME scaling + permutations to a new matrix:
        A3 = P((Dr A Dc)[:, colperm])P^T.  Used by the refactorization
        fast path (api.update_values) — for a same-pattern matrix the
        result has the same pattern as :attr:`reordered`."""
        s = a.to_scipy()
        a1 = _scale_csc(s, self.row_scale, self.col_scale)
        a2 = sp.csc_matrix(a1)[:, self.colperm]
        a3 = sp.csc_matrix(a2)[self.perm][:, self.perm]
        a3.sort_indices()
        return CscMatrix.from_scipy(a3)

    def transform_b_trans(self, b: np.ndarray) -> np.ndarray:
        """b -> rhs of the TRANSPOSED reordered system: solving
        A^T x = b with A = Dr^-1 A1 Dc^-1, A2 = A1 Q, A3 = P A2 P^T
        gives A3^T (P Dr^-1 x) = P Q^T Dc b."""
        b = np.asarray(b)
        scale = self.col_scale.astype(b.real.dtype)
        v = scale * b if b.ndim == 1 else scale[:, None] * b
        v = v[self.colperm]
        return v[self.perm]

    def transform_x_trans(self, w: np.ndarray) -> np.ndarray:
        """solution of the transposed reordered system -> solution of
        the original A^T x = b (x = Dr P^T w; no column permutation)."""
        w = np.asarray(w)
        z = np.empty_like(w)
        z[self.perm] = w
        scale = self.row_scale.astype(w.real.dtype)
        return scale * z if w.ndim == 1 else scale[:, None] * z

    def transform_x(self, w: np.ndarray) -> np.ndarray:
        """solution of reordered system -> solution of original system
        (reference: pangulu_reorder_vector_x_tran)."""
        w = np.asarray(w)
        z = np.empty_like(w)
        z[self.perm] = w
        x1 = np.empty_like(w)
        x1[self.colperm] = z
        scale = self.col_scale.astype(w.real.dtype)
        if w.ndim == 1:
            return scale * x1
        return scale[:, None] * x1


def reorder(a: CscMatrix, *, mc64: bool = True,
            ordering: str = "auto", match=None,
            nb: int = 0) -> Reordering:
    """``match``: optional precomputed ``(dr, dc, colperm)`` from
    :func:`mc64_scale_and_match` — lets callers trying several
    fill-reducing orderings (api.init ordering='auto') pay for the
    matching once instead of once per candidate.  ``nb``: tile-size
    hint for tile-aligned nested dissection."""
    n = a.n
    s = a.to_scipy()
    dr, dc, colperm = (match if match is not None
                       else mc64_scale_and_match(a, enable=mc64))
    a1 = _scale_csc(s, dr, dc)
    a2 = sp.csc_matrix(a1)[:, colperm]
    perm = fill_reducing_order(CscMatrix.from_scipy(a2), method=ordering,
                               nb=nb)
    a3 = sp.csc_matrix(a2)[perm][:, perm]
    a3.sort_indices()
    return Reordering(
        row_scale=dr,
        col_scale=dc,
        colperm=np.asarray(colperm, dtype=np.int64),
        perm=np.asarray(perm, dtype=np.int64),
        reordered=CscMatrix.from_scipy(a3),
    )
