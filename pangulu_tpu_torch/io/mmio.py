"""Matrix IO: MatrixMarket and simple binary-vector formats.

Counterpart of ``pangulu_tpu.io.mmio`` and of the reference's vendored
MatrixMarket reader (``examples/mmio_highlevel.h``): coordinate ``.mtx``
files go through the native reader (``native/pangulu_host.cpp``), gz,
dense and array files through ``scipy.io``, plus the reference example
program's binary ``.lid`` CSR and right-hand-side conventions
(``examples/example.c:100-164,252-266``).  Files written by either
package read back bit-equal in the other.

The ``.lid`` reader differs from the JAX package's on purpose: it takes
an empty matrix (nnz = 0), rejects a non-square header up front, and
does not guess the value type of an 8-byte payload (float64 or
complex64: the format does not say) when no ``dtype`` is given.
"""

from __future__ import annotations

import numpy as np
import scipy.io
import scipy.sparse as sp

from pangulu_tpu_torch import native
from pangulu_tpu_torch.sparse import CscMatrix


def _read_mtx_native(path):
    """Coordinate ``.mtx`` through the native reader; a scipy matrix, or
    None for what it does not read (gz, dense/array files, no native
    library), which the caller reads with scipy."""
    if str(path).endswith(".gz"):
        return None
    out = native.mmio_read(path)
    if out is None:
        return None
    nrows, ncols, rows, cols, vals, symmetry = out
    a = sp.coo_matrix((vals, (rows, cols)), shape=(nrows, ncols))
    if symmetry:  # expand symmetric / skew / hermitian storage
        off = rows != cols
        v = vals[off]
        if symmetry == 2:
            v = -v
        elif symmetry == 3:
            v = np.conj(v)
        a = a + sp.coo_matrix((v, (cols[off], rows[off])),
                              shape=(nrows, ncols))
    return sp.csc_matrix(a)


def _lid_value_dtype(path, itemsize: int, dtype):
    """The value type of a ``.lid`` payload of ``itemsize`` bytes an
    entry.  The format does not record it (the reference fixes it at
    compile time, pangulu_common.h:11-33): 4 bytes is float32; 16 bytes
    is complex128; 8 bytes is float64 or complex64, so ``dtype`` must
    say which."""
    if itemsize == 4:
        return np.dtype(np.float32)
    if itemsize == 16:
        return np.dtype(np.complex128)
    if dtype is None:
        raise ValueError(
            f"{path}: 8-byte .lid values are float64 or complex64 and the "
            "format does not say which; pass dtype (e.g. np.float64)")
    return np.dtype(np.complex64 if np.dtype(dtype).kind == "c"
                    else np.float64)


def _read_lid(path, dtype=None) -> sp.csc_matrix:
    """Binary ``.lid`` CSR reader, the reference example's format
    (examples/example.c:100-164): header ``m:u32 n:u32 nnz:u64``, then
    ``rowptr[n+1]:u64``, ``colidx[nnz]:u32`` (0-based) and
    ``values[nnz]`` of the build's value type, whose width is taken from
    the file size (see :func:`_lid_value_dtype`)."""
    with open(path, "rb") as f:
        head = np.fromfile(f, dtype=np.uint32, count=2)
        if len(head) != 2:
            raise ValueError(f"{path}: truncated .lid header")
        m, n = int(head[0]), int(head[1])
        nnz_arr = np.fromfile(f, dtype=np.uint64, count=1)
        if len(nnz_arr) != 1:
            raise ValueError(f"{path}: truncated .lid header")
        if m != n:
            raise ValueError(f"{path}: .lid matrix is {m} x {n}; the "
                             "solver takes square matrices only")
        nnz = int(nnz_arr[0])
        rowptr = np.fromfile(f, dtype=np.uint64, count=n + 1)
        colidx = np.fromfile(f, dtype=np.uint32, count=nnz)
        if len(rowptr) != n + 1 or len(colidx) != nnz:
            raise ValueError(f"{path}: truncated .lid index data")
        payload = f.read()
    if nnz == 0:
        if payload:
            raise ValueError(f"{path}: {len(payload)} value bytes for an "
                             "empty matrix")
        vdt = np.dtype(np.float64 if dtype is None else dtype)
    elif len(payload) % nnz == 0 and len(payload) // nnz in (4, 8, 16):
        vdt = _lid_value_dtype(path, len(payload) // nnz, dtype)
    else:
        raise ValueError(
            f"{path}: .lid value payload is {len(payload)} bytes for "
            f"{nnz} entries — not a 4/8/16-byte value type")
    values = np.frombuffer(payload, dtype=vdt)
    if int(rowptr[-1]) != nnz:
        raise ValueError(f"{path}: rowptr[-1]={int(rowptr[-1])} != "
                         f"nnz={nnz}")
    return sp.csr_matrix(
        (values, colidx.astype(np.int64), rowptr.astype(np.int64)),
        shape=(m, n)).tocsc()


def write_lid(path, a: CscMatrix) -> None:
    """Write the binary ``.lid`` CSR format (see :func:`_read_lid`)."""
    s = a.to_scipy().tocsr()
    s.sort_indices()
    with open(path, "wb") as f:
        np.asarray(s.shape, dtype=np.uint32).tofile(f)
        np.asarray([s.nnz], dtype=np.uint64).tofile(f)
        s.indptr.astype(np.uint64).tofile(f)
        s.indices.astype(np.uint32).tofile(f)
        s.data.tofile(f)


def read_matrix(path, dtype=None) -> CscMatrix:
    """Read a sparse matrix into CSC.

    Formats: MatrixMarket ``.mtx`` (also ``.mtx.gz``; symmetric / skew
    / hermitian storage expanded to the full pattern, like the
    reference reader), the reference's binary ``.lid`` CSR format, and
    the binary ``.npz`` written by :func:`write_matrix`.  ``dtype``
    optionally casts values (pattern matrices get ones).
    """
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            a = sp.csc_matrix((z["data"], z["indices"], z["indptr"]),
                              shape=tuple(int(d) for d in z["shape"]))
    elif path.endswith(".lid"):
        a = _read_lid(path, dtype)
    else:
        a = _read_mtx_native(path)
        if a is None:
            a = sp.csc_matrix(scipy.io.mmread(path))
    if dtype is not None:
        a = a.astype(dtype)
    a.sum_duplicates()
    a.sort_indices()
    return CscMatrix.from_scipy(a)


def write_matrix(path, a: CscMatrix) -> None:
    """Write ``.mtx`` (text), ``.lid`` (the reference's binary CSR) or
    ``.npz`` (binary CSC — loads orders of magnitude faster for large
    matrices)."""
    path = str(path)
    s = a.to_scipy()
    if path.endswith(".npz"):
        np.savez_compressed(path, indptr=s.indptr, indices=s.indices,
                            data=s.data, shape=np.asarray(s.shape))
    elif path.endswith(".lid"):
        write_lid(path, a)
    else:
        scipy.io.mmwrite(path, s)


def read_rhs(path, n: int, dtype) -> np.ndarray:
    """Read a right-hand side: one value per line (the reference
    example's ``-r rhs`` file), a MatrixMarket dense vector, or binary
    ``.npy``/``.npz`` (key ``b``).  With a complex ``dtype`` a text
    file may hold complex values (``1+2j``)."""
    path = str(path)
    if path.endswith(".mtx"):
        b = np.asarray(scipy.io.mmread(path)).reshape(-1)
    elif path.endswith(".npy"):
        b = np.load(path).reshape(-1)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            b = z["b"].reshape(-1)
    else:
        b = np.loadtxt(path, dtype=(np.complex128 if np.dtype(dtype).kind
                                    == "c" else np.float64)).reshape(-1)
    if b.shape[0] != n:
        raise ValueError(f"rhs length {b.shape[0]} != n {n}")
    return b.astype(dtype)


def generated_rhs(a: CscMatrix) -> np.ndarray:
    """Default rhs ``b = A @ 1`` so the exact solution is the ones
    vector (reference: examples/example.c:252-266)."""
    return np.asarray(a.to_scipy() @ np.ones(a.n, dtype=a.values.dtype))
