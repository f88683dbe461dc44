"""The port's matrix and right-hand-side IO (pangulu_tpu_torch.io.mmio)
against the JAX package's (pangulu_tpu.io.mmio).

Structural outputs must match bit for bit (ROADMAP.md): a file written
by either package reads back in the other with the same CSC (pointers,
indices, values and value type).  The port's ``.lid`` reader differs on
purpose in three ways, each tested here: it takes an empty matrix, it
rejects a non-square header, and it does not guess the value type of
an 8-byte payload.
"""

import gzip
import pathlib
import shutil

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

import pangulu_tpu.io.mmio as jio
import pangulu_tpu_torch.io.mmio as tio
from pangulu_tpu_torch import native
from pangulu_tpu_torch.models import poisson2d, random_unsymmetric
from pangulu_tpu_torch.sparse import CscMatrix

FIXDIR = pathlib.Path(__file__).resolve().parent / "fixtures"
PKG = {"jax": jio, "port": tio}


def assert_same_csc(got, want):
    """Bit-equal CSC: the same n, pointers, indices, values and dtype."""
    assert got.n == want.n
    np.testing.assert_array_equal(got.colptr, want.colptr)
    np.testing.assert_array_equal(got.rowidx, want.rowidx)
    assert got.values.dtype == want.values.dtype
    np.testing.assert_array_equal(got.values, want.values)


def _matrix():
    # unsymmetric, so MatrixMarket keeps it "general"; values not exact
    # in few digits, so the text format's precision is exercised
    return random_unsymmetric(60, 0.08, seed=2)


@pytest.mark.parametrize("fmt", ["mtx", "mtx.gz", "lid", "npz"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_files_cross_packages(tmp_path, writer, reader, fmt):
    """What one package writes, the other reads bit-equal, and both
    read the same CSC from it."""
    a = _matrix()
    path = tmp_path / f"m.{fmt}"
    if fmt == "mtx.gz":
        PKG[writer].write_matrix(tmp_path / "m.mtx", a)
        with open(tmp_path / "m.mtx", "rb") as fin, \
                gzip.open(path, "wb") as fout:
            shutil.copyfileobj(fin, fout)
    else:
        PKG[writer].write_matrix(path, a)
    kw = dict(dtype=np.float64) if fmt == "lid" else {}
    got = PKG[reader].read_matrix(path, **kw)
    assert_same_csc(got, PKG[writer].read_matrix(path, **kw))
    if fmt in ("lid", "npz"):   # binary formats carry the values exactly
        assert_same_csc(got, a)
    else:
        assert (got.to_scipy() != a.to_scipy()).nnz == 0


@pytest.mark.parametrize("kind", ["symmetric", "skew-symmetric", "pattern",
                                  "integer"])
def test_mtx_storage_variants(tmp_path, kind):
    """Symmetric and skew storage are expanded to the full pattern, a
    pattern file reads as ones, integer values as floats — by the
    native reader of both packages, to the same CSC as scipy's."""
    s = poisson2d(5).to_scipy()
    if kind == "skew-symmetric":
        s = sp.csc_matrix(sp.triu(s, 1) - sp.triu(s, 1).T)
        args = dict(symmetry="skew-symmetric")
    elif kind == "pattern":
        args = dict(field="pattern")
    elif kind == "integer":
        args = dict(field="integer")
    else:
        args = dict(symmetry="symmetric")
    path = tmp_path / "m.mtx"
    scipy.io.mmwrite(path, s, **args)
    assert kind in path.read_text().splitlines()[0]
    got = tio.read_matrix(path, dtype=np.float64)
    assert_same_csc(got, jio.read_matrix(path, dtype=np.float64))
    want = sp.csc_matrix(scipy.io.mmread(path)).astype(np.float64)
    assert (got.to_scipy() != want).nnz == 0


def test_native_reader_is_used(tmp_path):
    """A coordinate file goes through the native reader (the C++ of
    native/pangulu_host.cpp), which returns the triplets unexpanded."""
    a = _matrix()
    path = tmp_path / "m.mtx"
    tio.write_matrix(path, a)
    out = native.mmio_read(path)
    assert out is not None
    nrows, ncols, rows, cols, vals, symmetry = out
    assert (nrows, ncols, symmetry) == (a.n, a.n, 0)
    got = sp.csc_matrix((vals, (rows, cols)), shape=(a.n, a.n))
    assert (got != a.to_scipy()).nnz == 0
    assert native.mmio_read(tmp_path / "missing.mtx") is None


@pytest.mark.parametrize("name", sorted(p.stem for p in
                                        FIXDIR.glob("*.npz")))
def test_fixtures_read_like_jax(name):
    path = FIXDIR / f"{name}.npz"
    assert_same_csc(tio.read_matrix(path), jio.read_matrix(path))


def test_lid_bytes_equal_jax(tmp_path):
    """write_lid writes the same bytes as the JAX package's, f64 and
    f32, and a 4-byte payload reads as float32 without a dtype."""
    a = poisson2d(9)
    a32 = CscMatrix.from_scipy(a.to_scipy().astype(np.float32))
    for m, name in ((a, "m64"), (a32, "m32")):
        tio.write_lid(tmp_path / f"{name}.lid", m)
        jio.write_lid(tmp_path / f"{name}_j.lid", m)
        assert ((tmp_path / f"{name}.lid").read_bytes()
                == (tmp_path / f"{name}_j.lid").read_bytes())
    b32 = tio.read_matrix(tmp_path / "m32.lid")
    assert_same_csc(b32, a32)


def _lid_bytes(m, n, indptr, indices, data) -> bytes:
    return (np.asarray([m, n], np.uint32).tobytes()
            + np.asarray([len(indices)], np.uint64).tobytes()
            + np.asarray(indptr, np.uint64).tobytes()
            + np.asarray(indices, np.uint32).tobytes()
            + np.asarray(data).tobytes())


def test_lid_empty_matrix_is_read(tmp_path):
    """nnz = 0 is a valid file (the JAX reader rejects it)."""
    path = tmp_path / "empty.lid"
    path.write_bytes(_lid_bytes(3, 3, [0, 0, 0, 0], [], np.empty(0)))
    with pytest.raises(ValueError):
        jio.read_matrix(path)
    got = tio.read_matrix(path)
    assert got.n == 3 and got.nnz == 0
    assert tio.read_matrix(path, dtype=np.float32).values.dtype == np.float32


def test_lid_non_square_is_rejected(tmp_path):
    """m != n is refused from the header (the JAX reader reads n + 1 row
    pointers for m rows)."""
    path = tmp_path / "rect.lid"
    s = sp.random(4, 6, density=0.5, format="csr", random_state=1)
    path.write_bytes(_lid_bytes(4, 6, s.indptr, s.indices, s.data))
    with pytest.raises(ValueError, match="4 x 6"):
        tio.read_matrix(path, dtype=np.float64)


@pytest.mark.parametrize("dtype,want", [
    (None, "pass dtype"),
    (np.float64, np.float64),
    (np.float32, np.float32),     # read as float64, then cast
    (np.complex64, np.complex64),
])
def test_lid_eight_byte_payload(tmp_path, dtype, want):
    """An 8-byte payload is float64 or complex64; without a dtype the
    port refuses to guess (the JAX reader reads float64)."""
    a = poisson2d(4)
    path = tmp_path / "m.lid"
    tio.write_matrix(path, a)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tio.read_matrix(path, dtype=dtype)
        assert jio.read_matrix(path).values.dtype == np.float64
        return
    got = tio.read_matrix(path, dtype=dtype)
    assert got.values.dtype == want
    assert_same_csc(got, jio.read_matrix(path, dtype=dtype))


def test_lid_sixteen_byte_payload_reads_complex128(tmp_path):
    """A 16-byte payload is complex128, read as the JAX reader reads it."""
    s = poisson2d(4).to_scipy().tocsr().astype(np.complex128)
    s.data = s.data * (1.0 - 0.5j)
    path = tmp_path / "c.lid"
    path.write_bytes(_lid_bytes(s.shape[0], s.shape[1], s.indptr,
                                s.indices, s.data))
    got = tio.read_matrix(path)
    assert got.values.dtype == np.complex128
    assert_same_csc(got, jio.read_matrix(path))
    assert_same_csc(got, CscMatrix.from_scipy(s))


@pytest.mark.parametrize("cut", [10, 30])
def test_lid_truncated(tmp_path, cut):
    a = poisson2d(4)
    tio.write_matrix(tmp_path / "m.lid", a)
    (tmp_path / "bad.lid").write_bytes(
        (tmp_path / "m.lid").read_bytes()[:cut])
    with pytest.raises(ValueError, match="truncated"):
        tio.read_matrix(tmp_path / "bad.lid", dtype=np.float64)


@pytest.mark.parametrize("fmt", ["txt", "npy", "npz", "mtx"])
def test_read_rhs_like_jax(tmp_path, fmt):
    b = np.random.default_rng(4).standard_normal(9)
    path = tmp_path / f"b.{fmt}"
    if fmt == "txt":
        np.savetxt(path, b)
    elif fmt == "npy":
        np.save(path, b)
    elif fmt == "npz":
        np.savez(path, b=b)
    else:
        scipy.io.mmwrite(path, b[:, None])
    for dtype in (np.float64, np.float32):
        got = tio.read_rhs(path, 9, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, jio.read_rhs(path, 9, dtype))
    with pytest.raises(ValueError, match="rhs length"):
        tio.read_rhs(path, 7, np.float64)


def test_generated_rhs_like_jax():
    a = _matrix()
    b = tio.generated_rhs(a)
    np.testing.assert_array_equal(b, jio.generated_rhs(a))
    np.testing.assert_allclose(
        b, np.asarray(a.to_scipy().sum(axis=1)).ravel(), rtol=1e-14)
