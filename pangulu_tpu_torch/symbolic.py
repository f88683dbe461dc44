"""Symbolic factorization: elimination tree + LU fill pattern.

Counterpart of the reference's ``pangulu_symbolic`` component
(pangulu_symbolic.c:132-271): symmetrize the pattern (A+A^T, SuperLU
style, pangulu_symbolic.c:3) and run an up-looking *symmetric* symbolic
factorization, so U's pattern is L's transpose and
``symbolic_nnz = 2|L| - n`` (pangulu_symbolic.c:242).

Downstream, present blocks are stored as **dense nb x nb
tiles**, so the device only needs the *block-level* pattern.  Two modes:

  * ``"scalar"`` — exact scalar fill via elimination tree + row-subtree
    traversal (Liu).  Produces the exact ``symbolic_nnz`` and the tight
    block pattern implied by scalar fill.  O(|L|) time, Python loops —
    the designated native-C++ upgrade point.
  * ``"block"``  — run the same symbolic algorithm on the block_length^2
    block-presence graph.  A superset pattern (a block is treated full
    once present), orders of magnitude cheaper; numerically identical
    results since the extra tiles are structural zeros.

Structural zeros stay exact zeros through IEEE arithmetic (0*x = 0,
y - 0 = y), so a superset pattern never changes the computed factors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from pangulu_tpu_torch.sparse import CscMatrix, symmetrize_pattern


@dataclasses.dataclass
class SymbolicResult:
    n: int
    nb: int
    block_length: int
    symbolic_nnz: int            # scalar |L|+|U|-n (exact in scalar mode,
                                 # upper bound in block mode)
    parent: np.ndarray           # elimination tree (scalar or block level)
    block_lower: sp.csc_matrix   # bl x bl boolean: L block pattern (incl diag)
    block_full: sp.csc_matrix    # bl x bl boolean: L+U block pattern
    mode: str
    lower_colcnt: np.ndarray | None = None  # |{i>j: L(i,j)}| per column
                                            # (scalar mode only)

    def block_flop_score(self) -> float:
        """Cheap upper-bound estimate of the DENSE-TILE flops a
        factorization of this block pattern executes: per level k,
        the Schur stage costs <= nl_k * nu_k tile-GEMMs plus nl_k+nu_k
        panel solves (each 2nb^3-class).  Used by the ordering auto-
        pick — tile count alone misrepresents orderings whose tiles
        concentrate in few levels."""
        full = self.block_full
        bl = self.block_length
        colptr, rows = full.indptr, full.indices
        cols = np.repeat(np.arange(bl), np.diff(colptr))
        nl = np.bincount(cols[rows > cols], minlength=bl)
        nu = np.bincount(rows[rows < cols], minlength=bl)
        return float(np.sum(nl * nu) + np.sum(nl) + np.sum(nu) + bl)

    def sparse_flops(self) -> float | None:
        """EXACT sparse LU flop count for the (symmetrized) fill
        pattern — the number the reference reports as GFLOPS
        (pangulu_kernel_interface.c:4-178 counts the same sparsity
        intersections at run time; we count them once from the
        symbolic column counts).  With lk = |L(:,k)| strictly below
        the diagonal and uk = |U(k,:)| strictly right (= lk for the
        symmetrized pattern): flops = sum_k lk + 2*lk*uk
        (divisions + multiply-add updates).  None in block mode."""
        if self.lower_colcnt is None:
            return None
        lk = self.lower_colcnt.astype(np.float64)
        return float(np.sum(lk + 2.0 * lk * lk))


def elimination_tree(sym: sp.csc_matrix) -> np.ndarray:
    """Liu's elimination-tree algorithm on a symmetric pattern.

    Uses the native C++ runtime when available (pangulu_etree,
    native/pangulu_host.cpp); pure-Python fallback below."""
    n = sym.shape[0]
    csr = sym.tocsr()
    indptr, indices = csr.indptr, csr.indices
    from pangulu_tpu_torch import native

    parent = native.etree(n, indptr, indices)
    if parent is not None:
        return parent
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        for k in indices[indptr[i]:indptr[i + 1]]:
            if k >= i:
                continue
            j = k
            while ancestor[j] != -1 and ancestor[j] != i:
                t = ancestor[j]
                ancestor[j] = i
                j = t
            if ancestor[j] == -1:
                ancestor[j] = i
                parent[j] = i
    return parent


def _fill_walk(sym: sp.csc_matrix, parent: np.ndarray, nb: int,
               block_mark: np.ndarray | None,
               colcnt: np.ndarray | None = None):
    """Row-subtree traversal enumerating L's fill entries.

    For each row i, walk from every a[i,k] (k<i) up the etree until a
    node already visited for this row; every node j touched is a fill
    entry L[i,j].  Returns |strictly-lower L| and (optionally) marks
    block (i//nb, j//nb) and counts per-column entries for each entry.
    """
    n = sym.shape[0]
    csr = sym.tocsr()
    indptr, indices = csr.indptr, csr.indices
    if block_mark is not None:
        from pangulu_tpu_torch import native

        if colcnt is not None:
            res = native.fill_walk_counts(n, indptr, indices, parent, nb,
                                          block_mark.shape[0])
            if res is not None:
                count, mark, cc = res
                block_mark |= mark
                colcnt += cc
                return count
        else:
            res = native.fill_walk(n, indptr, indices, parent, nb,
                                   block_mark.shape[0])
            if res is not None:
                count, mark = res
                block_mark |= mark
                return count
    visited = np.full(n, -1, dtype=np.int64)
    count = 0
    for i in range(n):
        visited[i] = i
        bi = i // nb
        for k in indices[indptr[i]:indptr[i + 1]]:
            if k >= i:
                continue
            j = k
            while visited[j] != i:
                visited[j] = i
                count += 1
                if block_mark is not None:
                    block_mark[bi, j // nb] = True
                if colcnt is not None:
                    colcnt[j] += 1
                j = parent[j]
                if j == -1 or j >= i:
                    break
    return count


def symbolic(a: CscMatrix, nb: int, mode: str = "scalar") -> SymbolicResult:
    """Compute the LU fill pattern of ``a`` at block granularity ``nb``."""
    n = a.n
    bl = -(-n // nb)
    sym = symmetrize_pattern(a)

    if mode == "block":
        # Coalesce the scalar pattern to the block grid, then run the
        # identical symbolic algorithm at block granularity.
        coo = sym.tocoo()
        bp = sp.csc_matrix(
            (np.ones(len(coo.data), dtype=np.int8),
             (coo.row // nb, coo.col // nb)),
            shape=(bl, bl),
        )
        bp.sum_duplicates()
        bp.data[:] = 1
        parent = elimination_tree(bp)
        mark = np.zeros((bl, bl), dtype=bool)
        _fill_walk(bp, parent, 1, mark)
        np.fill_diagonal(mark, True)
        lower = sp.csc_matrix(mark)
        # Upper-bound scalar nnz: full tiles (diag tiles count once).
        nlow = int(mark.sum())
        symbolic_nnz = (2 * nlow - bl) * nb * nb
    else:
        parent = elimination_tree(sym)
        mark = np.zeros((bl, bl), dtype=bool)
        colcnt = np.zeros(n, dtype=np.int64)
        strict_lower = _fill_walk(sym, parent, nb, mark, colcnt)
        # Block diagonal is always present (explicit diagonal entries).
        np.fill_diagonal(mark, True)
        lower = sp.csc_matrix(mark)
        symbolic_nnz = 2 * (strict_lower + n) - n

    full = sp.csc_matrix(((lower + lower.T) > 0).astype(np.int8))
    full.sort_indices()
    lower = sp.csc_matrix(lower.astype(np.int8))
    lower.sort_indices()
    return SymbolicResult(
        n=n, nb=nb, block_length=bl, symbolic_nnz=int(symbolic_nnz),
        parent=parent, block_lower=lower, block_full=full, mode=mode,
        lower_colcnt=colcnt if mode != "block" else None,
    )
