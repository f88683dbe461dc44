"""ctypes loader for the native host runtime (native/pangulu_host.cpp).

The sequential host pipeline — elimination tree, symbolic fill
enumeration, minimum-degree and nested-dissection orderings, MC64
matching with exact dual scalings, the MatrixMarket reader — is C++
shared with the JAX package
(the reference implements these in C: pangulu_symbolic.c,
pangulu_reordering.c).  Python fallbacks exist for every function; the
library is an accelerator, not a dependency.

The shipped ``native/libpangulu_host.so`` is loaded first.  If it is
missing, does not load on this machine, or carries another ABI stamp,
the source is rebuilt into the port's build directory (never into
``native/``), under a name that carries a hash of the source, so an
edited source is rebuilt and a stale build is never loaded.  Each of
those events is logged at WARNING: a silent fall back to the Python
paths changes orderings' cost by orders of magnitude and has misled a
measurement before.
"""

from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess

import numpy as np

from pangulu_tpu_torch.ops.build import BUILD_DIR
from pangulu_tpu_torch.utils.log import get_logger

log = get_logger()

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native"
_SHIPPED = _SRC / "libpangulu_host.so"
_SOURCE = _SRC / "pangulu_host.cpp"
_ABI_VERSION = 5
_lib = None
_tried = False


def _load_checked(path: pathlib.Path):
    """dlopen + ABI stamp check; None (with a WARNING) on failure."""
    try:
        lib = ctypes.CDLL(str(path))
        lib.pangulu_abi_version.restype = ctypes.c_int64
        lib.pangulu_abi_version.argtypes = []
        abi = lib.pangulu_abi_version()
    except (OSError, AttributeError) as e:
        log.warning("native library %s does not load: %s", path, e)
        return None
    if abi != _ABI_VERSION:
        log.warning("native library %s has ABI %d, expected %d", path,
                    abi, _ABI_VERSION)
        return None
    return lib


def _rebuilt_path() -> pathlib.Path | None:
    """Where the rebuild of the current source goes; None without a
    source."""
    if not _SOURCE.exists():
        log.warning("native source %s missing", _SOURCE)
        return None
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpangulu_host_{digest}.so"


def _build(out: pathlib.Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".so.tmp")
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", str(tmp), str(_SOURCE)],
            check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native rebuild failed: %s", e)
        return False
    tmp.replace(out)
    return True


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _load_checked(_SHIPPED) if _SHIPPED.exists() else None
    rebuilt = _rebuilt_path() if lib is None else None
    if rebuilt is not None and rebuilt.exists():
        lib = _load_checked(rebuilt)
    if lib is None and rebuilt is not None:
        log.warning("rebuilding the native host library into %s", rebuilt)
        lib = _load_checked(rebuilt) if _build(rebuilt) else None
    if lib is None:
        log.warning("native host library unavailable: using the Python "
                    "fallbacks (much slower orderings and symbolic)")
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.pangulu_etree.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
    lib.pangulu_etree.restype = None
    lib.pangulu_fill_walk.argtypes = [ctypes.c_int64, i64p, i32p, i64p,
                                      ctypes.c_int64, u8p, ctypes.c_int64]
    lib.pangulu_fill_walk.restype = ctypes.c_int64
    lib.pangulu_fill_walk_counts.argtypes = [
        ctypes.c_int64, i64p, i32p, i64p, ctypes.c_int64, u8p,
        ctypes.c_int64, i64p]
    lib.pangulu_fill_walk_counts.restype = ctypes.c_int64
    lib.pangulu_fill_entries.argtypes = [ctypes.c_int64, i64p, i32p, i64p,
                                         i32p, i32p]
    lib.pangulu_fill_entries.restype = ctypes.c_int64
    lib.pangulu_mindeg.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
    lib.pangulu_mindeg.restype = None
    lib.pangulu_ndorder_aligned.argtypes = [
        ctypes.c_int64, i64p, i32p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.pangulu_ndorder_aligned.restype = None
    lib.pangulu_mc64.argtypes = [ctypes.c_int64, i64p, i32p, f64p, i64p,
                                 f64p, f64p]
    lib.pangulu_mc64.restype = ctypes.c_int
    lib.pangulu_mmio_probe.argtypes = [ctypes.c_char_p, i64p]
    lib.pangulu_mmio_probe.restype = ctypes.c_int
    lib.pangulu_mmio_read.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      i32p, i32p, f64p, f64p]
    lib.pangulu_mmio_read.restype = ctypes.c_int64
    _lib = lib
    return _lib


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def etree(n, indptr, indices):
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices = _i64(indptr), _i32(indices)
    parent = np.empty(n, dtype=np.int64)
    lib.pangulu_etree(n, _ptr(indptr, ctypes.c_int64),
                      _ptr(indices, ctypes.c_int32),
                      _ptr(parent, ctypes.c_int64))
    return parent


def fill_walk(n, indptr, indices, parent, nb, bl):
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices, parent = _i64(indptr), _i32(indices), _i64(parent)
    mark = np.zeros(bl * bl, dtype=np.uint8)
    count = lib.pangulu_fill_walk(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(parent, ctypes.c_int64), nb, _ptr(mark, ctypes.c_uint8), bl)
    return int(count), mark.reshape(bl, bl).astype(bool)


def fill_walk_counts(n, indptr, indices, parent, nb, bl):
    """fill_walk + per-column strictly-lower L counts (exact sparse
    flop accounting).  Returns (count, mark, colcnt) or None."""
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices, parent = _i64(indptr), _i32(indices), _i64(parent)
    mark = np.zeros(bl * bl, dtype=np.uint8)
    colcnt = np.zeros(n, dtype=np.int64)
    count = lib.pangulu_fill_walk_counts(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(parent, ctypes.c_int64), nb, _ptr(mark, ctypes.c_uint8), bl,
        _ptr(colcnt, ctypes.c_int64))
    return int(count), mark.reshape(bl, bl).astype(bool), colcnt


def fill_entries(n, indptr, indices, parent, count):
    """All strictly-lower fill entries (i, j) of L, or None
    (pangulu_tpu/native.py:161-176)."""
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices, parent = _i64(indptr), _i32(indices), _i64(parent)
    out_i = np.empty(count, dtype=np.int32)
    out_j = np.empty(count, dtype=np.int32)
    got = lib.pangulu_fill_entries(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(parent, ctypes.c_int64), _ptr(out_i, ctypes.c_int32),
        _ptr(out_j, ctypes.c_int32))
    if got != count:
        return None
    return out_i, out_j


def mindeg(n, indptr, indices):
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices = _i64(indptr), _i32(indices)
    order = np.empty(n, dtype=np.int64)
    lib.pangulu_mindeg(n, _ptr(indptr, ctypes.c_int64),
                       _ptr(indices, ctypes.c_int32),
                       _ptr(order, ctypes.c_int64))
    return order


def ndorder(n, indptr, indices, leaf_size=128, align_nb=0):
    """Multilevel nested dissection ordering (METIS_NodeND role), or
    None when the native lib is unavailable.  ``align_nb > 1`` aligns
    part sizes to multiples of the tile size."""
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices = _i64(indptr), _i32(indices)
    order = np.empty(n, dtype=np.int64)
    lib.pangulu_ndorder_aligned(n, _ptr(indptr, ctypes.c_int64),
                                _ptr(indices, ctypes.c_int32), leaf_size,
                                align_nb, _ptr(order, ctypes.c_int64))
    return order


def mc64(n, colptr, rowidx, absval):
    """Returns (colperm, row_scale, col_scale) or None (no lib /
    structurally singular)."""
    lib = get_lib()
    if lib is None:
        return None
    colptr, rowidx = _i64(colptr), _i32(rowidx)
    absval = np.ascontiguousarray(absval, dtype=np.float64)
    colperm = np.empty(n, dtype=np.int64)
    rs = np.empty(n, dtype=np.float64)
    cs = np.empty(n, dtype=np.float64)
    rc = lib.pangulu_mc64(n, _ptr(colptr, ctypes.c_int64),
                          _ptr(rowidx, ctypes.c_int32),
                          _ptr(absval, ctypes.c_double),
                          _ptr(colperm, ctypes.c_int64),
                          _ptr(rs, ctypes.c_double),
                          _ptr(cs, ctypes.c_double))
    if rc != 0:
        return None
    return colperm, rs, cs


def mmio_read(path):
    """Fast MatrixMarket coordinate read: (nrows, ncols, rows, cols,
    values, symmetry) or None (no lib / unsupported variant — the caller
    falls back to scipy).  symmetry: 0 general, 1 symmetric,
    2 skew-symmetric, 3 hermitian.  Symmetry is NOT expanded here."""
    lib = get_lib()
    if lib is None:
        return None
    hdr = np.zeros(5, dtype=np.int64)
    pathb = str(path).encode()
    if lib.pangulu_mmio_probe(pathb, _ptr(hdr, ctypes.c_int64)) != 0:
        return None
    nrows, ncols, nnz, field, symmetry = (int(x) for x in hdr)
    rows = np.empty(nnz, dtype=np.int32)
    cols = np.empty(nnz, dtype=np.int32)
    re = np.empty(nnz, dtype=np.float64)
    im = np.empty(nnz, dtype=np.float64) if field == 3 else None
    got = lib.pangulu_mmio_read(
        pathb, nnz, _ptr(rows, ctypes.c_int32),
        _ptr(cols, ctypes.c_int32), _ptr(re, ctypes.c_double),
        _ptr(im, ctypes.c_double) if im is not None else None)
    if got != nnz:
        return None
    vals = re + 1j * im if field == 3 else re
    return nrows, ncols, rows, cols, vals, symmetry
