"""Host-side sparse matrix containers and format conversion.

Counterpart of the reference's format-conversion component
(``pangulu_conversion.c``) and origin-matrix helpers
(``pangulu_memory.c:34-84``, ``pangulu_utils.c:23-105``).  Everything
here is host-side numpy: the device never sees scalar CSC — it sees
dense block tiles produced by :mod:`pangulu_tpu_torch.blocks`.  The
complex value types are solved through their real 2x2 embedding
(:func:`complex_embed_matrix`): the kernels see real tiles only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

# Index dtypes.  The reference uses u64 outer pointers / u32 indices
# (pangulu_common.h:54-65); we use int64 pointers and int32 indices,
# which covers symbolic nnz > 2^31 while keeping XLA-friendly int32
# block indices on device.
PTR_DTYPE = np.int64
IDX_DTYPE = np.int32

# Value types — the reference's R32/R64/CR32/CR64
# (pangulu_common.h:11-33, README.md:58).
VALUE_DTYPES = {
    "r32": np.float32,
    "r64": np.float64,
    "cr32": np.complex64,
    "cr64": np.complex128,
}


@dataclasses.dataclass
class CscMatrix:
    """Square sparse matrix in compressed-sparse-column form.

    Mirrors the reference's ``pangulu_origin_smatrix`` role.  Columns
    are expected sorted by row index (use :meth:`sort_indices`).
    """

    n: int
    colptr: np.ndarray  # (n+1,) PTR_DTYPE
    rowidx: np.ndarray  # (nnz,) IDX_DTYPE
    values: np.ndarray  # (nnz,) value dtype

    @property
    def nnz(self) -> int:
        return int(self.colptr[-1])

    @property
    def dtype(self):
        return self.values.dtype

    @classmethod
    def from_scipy(cls, a) -> "CscMatrix":
        a = sp.csc_matrix(a)
        a.sort_indices()
        if a.shape[0] != a.shape[1]:
            raise ValueError(f"matrix must be square, got {a.shape}")
        return cls(
            n=a.shape[0],
            colptr=np.asarray(a.indptr, dtype=PTR_DTYPE),
            rowidx=np.asarray(a.indices, dtype=IDX_DTYPE),
            values=np.asarray(a.data),
        )

    def to_scipy(self) -> sp.csc_matrix:
        return sp.csc_matrix(
            (self.values, self.rowidx, self.colptr), shape=(self.n, self.n)
        )

    def copy(self) -> "CscMatrix":
        return CscMatrix(
            self.n, self.colptr.copy(), self.rowidx.copy(), self.values.copy()
        )

    def sort_indices(self) -> "CscMatrix":
        """Sort row indices within each column (reference sorts after
        reordering, pangulu_reordering.c:1257)."""
        s = self.to_scipy()
        s.sort_indices()
        self.rowidx = np.asarray(s.indices, dtype=IDX_DTYPE)
        self.values = np.asarray(s.data)
        return self

    def astype(self, dtype) -> "CscMatrix":
        return CscMatrix(self.n, self.colptr.copy(), self.rowidx.copy(),
                         self.values.astype(dtype))


def add_diagonal_elements(a: CscMatrix, fill_value=1e-8) -> CscMatrix:
    """Ensure an explicit diagonal entry in every column.

    The reference inserts 1e-8 placeholder diagonals so the unpivoted
    factorization always has a pivot slot
    (pangulu_utils.c:23-105, pangulu_reordering.c:715).
    """
    # An explicit stored zero also counts as a pivot slot: the
    # reference only adds *structurally* missing diagonals.  One O(nnz)
    # vectorized pass (a per-column membership scan is O(n*col) worst
    # case on circuit-class matrices at n~1e6).
    cols = np.repeat(np.arange(a.n), np.diff(a.colptr))
    has_struct = np.zeros(a.n, dtype=bool)
    has_struct[cols[a.rowidx == cols]] = True
    need = np.flatnonzero(~has_struct)
    if len(need) == 0:
        return a
    # Insert via COO concatenation, NOT scipy 's + d': sparse addition
    # prunes ALL explicit zeros from the result, which would make the
    # stored pattern value-dependent.  The COO->CSC constructor keeps
    # explicit zeros (it only sums duplicates, and `need` is disjoint
    # from the stored pattern by construction).
    coo = a.to_scipy().tocoo()
    rows2 = np.concatenate([coo.row, need])
    cols2 = np.concatenate([coo.col, need])
    data2 = np.concatenate(
        [coo.data, np.full(len(need), fill_value, dtype=a.values.dtype)])
    return CscMatrix.from_scipy(
        sp.csc_matrix((data2, (rows2, cols2)), shape=(a.n, a.n)))


def complex_embed_matrix(a: CscMatrix) -> CscMatrix:
    """Real 2x2 embedding of a complex matrix, INTERLEAVED so structure
    and bandwidth are preserved (row/col 2i = Re_i, 2i+1 = Im_i):

        each entry a_ij -> [[Re, -Im], [Im, Re]]

    Solving the embedded real system is the complex solve; it is how
    cr32/cr64 reach the real kernels (the tensor cores have no complex
    datapath; pangulu_tpu/sparse.py:134-171)."""
    s = a.to_scipy().tocoo()
    rdt = s.data.real.dtype
    re, im = s.data.real, s.data.imag
    # All 4 real components of every stored entry, exact zeros included:
    # the embedded pattern must not depend on the values, or a
    # pure-real complex matrix would embed to fewer entries and a later
    # update_values with imaginary parts would see another pattern.
    row2 = np.concatenate([2 * s.row, 2 * s.row + 1,
                           2 * s.row, 2 * s.row + 1])
    col2 = np.concatenate([2 * s.col, 2 * s.col,
                           2 * s.col + 1, 2 * s.col + 1])
    dat2 = np.concatenate([re, im, -im, re]).astype(rdt)
    emb = sp.csc_matrix((dat2, (row2, col2)),
                        shape=(2 * s.shape[0], 2 * s.shape[1]))
    if emb.nnz != 4 * s.nnz:
        # not an assert (it must survive `python -O`): the COO->CSC
        # constructor sums duplicates, so a matrix carrying duplicate
        # (row, col) entries shrinks here
        raise ValueError(
            "complex embed changed the stored-entry count "
            f"({emb.nnz} != 4*{s.nnz}); the input matrix likely carries "
            "duplicate (row, col) entries — canonicalize it first "
            "(e.g. sum_duplicates on the scipy matrix)")
    return CscMatrix.from_scipy(emb)


def complex_embed_rhs(b: np.ndarray) -> np.ndarray:
    """[n(,k)] complex -> [2n(,k)] real interleaved (Re_i, Im_i)."""
    b = np.asarray(b)
    out = np.empty((2 * b.shape[0],) + b.shape[1:], dtype=b.real.dtype)
    out[0::2] = b.real
    out[1::2] = b.imag
    return out


def complex_unembed_x(x: np.ndarray, cdtype) -> np.ndarray:
    """Inverse of :func:`complex_embed_rhs`."""
    x = np.asarray(x)
    return (x[0::2] + 1j * x[1::2]).astype(cdtype)


def complex_unembed_matrix(emb, cdtype) -> sp.csc_matrix:
    """Inverse of :func:`complex_embed_matrix`: the n x n complex matrix
    of a 2n x 2n interleaved real embedding (entry (i, j) = emb[2i, 2j]
    + 1j * emb[2i+1, 2j])."""
    s = sp.csc_matrix(emb)
    re = sp.csc_matrix(s[0::2, 0::2])
    im = sp.csc_matrix(s[1::2, 0::2])
    return sp.csc_matrix((re + 1j * im).astype(cdtype))


def symmetrize_pattern(a: CscMatrix) -> sp.csc_matrix:
    """Structural A + A^T with explicit diagonal, values all ones.

    Reference: pangulu_a_plus_at (pangulu_symbolic.c:3) /
    pangulu_get_graph_struct_csc (pangulu_reordering.c:957).
    """
    s = a.to_scipy()
    pattern = sp.csc_matrix(
        (np.ones_like(s.data, dtype=np.int8), s.indices, s.indptr),
        shape=s.shape,
    )
    sym = pattern + pattern.T + sp.identity(a.n, dtype=np.int8, format="csc")
    sym.data[:] = 1
    sym.sort_indices()
    return sym
