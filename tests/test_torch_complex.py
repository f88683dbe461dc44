"""Complex value types (cr32/cr64) in the port, device="cpu": solved
through the real 2x2 embedding on the real engines' plain versions, held
against the JAX package run with complex_mode="embed" on the same
matrices and seeds.

Contract (ROADMAP.md "Tolerances", tests/test_end_to_end.py:12,
tests/test_property.py:12): the embedding and every structural output
of init (embedded CSC, permutations, scalings, block pattern, level
schedule, kernel tables) bit-equal; unrefined solutions within 5e-4
(cr32) and 1e-10 (cr64) of the JAX package's, relative to max |x|;
cr32 refined to a residual below 1e-6; cr64 within 1e-9 of the JAX
package's native complex solve (tests/test_end_to_end.py:145-160).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import pangulu_tpu.api as japi
import pangulu_tpu.io.mmio as jio
import pangulu_tpu.sparse as jsp
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.io.mmio as tio
import pangulu_tpu_torch.models as tm
import pangulu_tpu_torch.sparse as tsp
from pangulu_tpu import cli as jcli
from pangulu_tpu.io.checkpoint import load_factor as jload
from pangulu_tpu.io.checkpoint import save_factor as jsave
from pangulu_tpu_torch import cli
from pangulu_tpu_torch.io import load_factor, save_factor
from pangulu_tpu_torch.testing import with_imaginary_parts
from pangulu_tpu_torch.utils.perf import residual_norm
from test_torch_host import _compare, _eq, _tables_eq

SOLVE_TOL = {"cr32": 5e-4, "cr64": 1e-10}


def _pair(name):
    """The same complex matrix as (port CscMatrix, JAX CscMatrix)."""
    if name.startswith("rand"):
        n, density, seed = {"rand80": (80, 0.06, 3), "rand100": (100, 0.05, 6),
                            "rand120": (120, 0.05, 5)}[name]
        a = tm.random_unsymmetric(n, density, seed=seed, dtype=np.complex128)
    elif name == "imag_diag":
        # Re(a_ii) = 0 on every third row: the embedded diagonal is 0
        # there, and the matching must take the Im entries (row 2i+1,
        # column 2i); every other entry keeps an exact-zero imaginary part
        s = tm.random_unsymmetric(90, 0.06, seed=8).to_scipy().astype(
            np.complex128).tolil()
        for i in range(0, 90, 3):
            s[i, i] = 1j * s[i, i].real
        a = tsp.CscMatrix.from_scipy(s.tocsc())
    else:  # poisson2d(k) / poisson3d(k) with imaginary parts
        gen, k = name[:9], int(name[9:])
        a = with_imaginary_parts(getattr(tm, gen)(k))
    return a, jsp.CscMatrix.from_scipy(a.to_scipy())


def _handles(name, dtype, nb, ordering, factor=True, **kw):
    a, aj = _pair(name)
    hp = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                   device="cpu", **kw))
    hj = japi.init(aj, japi.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                        complex_mode="embed", **kw))
    if factor:
        pt.gstrf(hp)
        japi.gstrf(hj)
    return a, hp, hj


def _rhs(a, k=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = (a.n,) if k is None else (a.n, k)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return np.asarray(a.to_scipy() @ x)


def _rel(x, y):
    return float(np.abs(x - y).max() / np.abs(y).max())


@pytest.mark.parametrize("name", ["rand80", "imag_diag", "poisson2d6"])
def test_embedding_bit_equal_jax(name):
    """complex_embed_matrix, complex_embed_rhs, complex_unembed_x and
    complex_unembed_matrix give the JAX package's bits; all 4 components
    of every stored entry are kept, exact zeros included."""
    a, aj = _pair(name)
    for f in ("n", "colptr", "rowidx", "values"):
        _eq(f, getattr(a, f), getattr(aj, f))
    ep, ej = tsp.complex_embed_matrix(a), jsp.complex_embed_matrix(aj)
    assert ep.nnz == 4 * a.nnz
    for f in ("colptr", "rowidx", "values"):
        _eq(f"embedded {f}", getattr(ep, f), getattr(ej, f))
    for cdt in (np.complex64, np.complex128):
        _eq("unembedded", tsp.complex_unembed_matrix(ep.to_scipy(),
                                                     cdt).toarray(),
            jsp.complex_unembed_matrix(ej.to_scipy(), cdt).toarray())
    for b in (_rhs(a), _rhs(a, 3)):
        br = tsp.complex_embed_rhs(b)
        _eq("embedded rhs", br, jsp.complex_embed_rhs(b))
        _eq("unembedded x", tsp.complex_unembed_x(br, np.complex128),
            jsp.complex_unembed_x(br, np.complex128))
        _eq("round trip", tsp.complex_unembed_x(br, np.complex128), b)


def test_embedding_rejects_duplicates():
    """A matrix carrying duplicate (row, col) entries embeds to fewer
    than 4 entries each: ValueError with the JAX package's message."""
    dup = tsp.CscMatrix(2, np.array([0, 2, 3]), np.array([0, 0, 1],
                                                         np.int32),
                        np.array([1 + 1j, 2.0, 3j]))
    jdup = jsp.CscMatrix(dup.n, dup.colptr, dup.rowidx, dup.values)
    with pytest.raises(ValueError) as ep:
        tsp.complex_embed_matrix(dup)
    with pytest.raises(ValueError) as ej:
        jsp.complex_embed_matrix(jdup)
    assert str(ep.value) == str(ej.value)
    assert "duplicate" in str(ep.value)


def test_pure_real_complex_keeps_zeros():
    """add_diagonal_elements and CscMatrix.astype keep complex values
    and explicit zeros, as the JAX package's do."""
    s = tm.random_unsymmetric(60, 0.06, seed=2).to_scipy().tolil()
    for i in (3, 17, 40):
        s[i, i] = 0.0        # structurally absent after lil
    s = s.tocsc().astype(np.complex128)
    s.eliminate_zeros()
    a = tsp.CscMatrix.from_scipy(s)
    for dt in (np.complex64, np.complex128):
        got = tsp.add_diagonal_elements(a.astype(dt))
        want = jsp.add_diagonal_elements(
            jsp.CscMatrix.from_scipy(s).astype(dt))
        for f in ("colptr", "rowidx", "values"):
            _eq(f, getattr(got, f), getattr(want, f))
        assert got.nnz == a.nnz + 3
        assert tsp.complex_embed_matrix(got).nnz == 4 * got.nnz


@pytest.mark.parametrize("name,dtype,nb,ordering", [
    ("rand120", "cr32", 16, "rcm"),
    ("rand120", "cr64", 16, "nd"),
    ("imag_diag", "cr64", 16, "auto"),
    ("poisson2d10", "cr32", 32, "nd"),
    ("poisson3d8", "cr32", 200, "rcm"),
])
def test_structure_bit_equal_jax(name, dtype, nb, ordering):
    """The embedded system's host pipeline (MC64 matching and scalings
    on the embedding, the ordering, the symbolic analysis, tiles, the
    level schedule and kernel tables, the grouped tables) is the JAX
    package's, bit for bit."""
    a, aj = _pair(name)
    _compare(a, aj, nb, ordering, dtype)
    _, hp, hj = _handles(name, dtype, nb, ordering, factor=False)
    assert hp.complex_embed == hj.complex_embed == np.dtype(
        tsp.VALUE_DTYPES[dtype])
    assert hp.blocked.n == 2 * a.n and hp.blocked.dtype == hj.blocked.dtype
    nt = hp.blocked.num_tiles
    _tables_eq("group_mega_tables", hp.schedule.group_mega_tables(nt),
               hj.schedule.group_mega_tables(nt))
    _tables_eq("group_solve_tables", hp.schedule.group_solve_tables(nt),
               hj.schedule.group_solve_tables(nt))


@pytest.mark.parametrize("name,dtype,nb,ordering", [
    ("rand80", "cr32", 16, "rcm"),
    ("rand100", "cr64", 32, "nd"),
    ("poisson2d12", "cr64", 16, "nd"),
    ("poisson3d8", "cr32", 256, "rcm"),
])
def test_solution_matches_jax(name, dtype, nb, ordering):
    """Unrefined solutions within the JAX package's tolerance of its
    own; cr32 refined to a residual below 1e-6 in both packages.  The
    rhs is given in the working type, as the JAX package takes it."""
    a, hp, hj = _handles(name, dtype, nb, ordering)
    b = _rhs(a).astype(hp.complex_embed)
    x0, x0j = pt.gstrs(hp, b, refine=0), japi.gstrs(hj, b, refine=0)
    assert x0.dtype == x0j.dtype == hp.complex_embed
    assert _rel(x0, x0j) < SOLVE_TOL[dtype]
    s = a.to_scipy()
    if dtype == "cr32":
        x, xj = pt.gstrs(hp, b), japi.gstrs(hj, b)
        assert residual_norm(s, x, b) < 1e-6
        assert residual_norm(s, xj, b) < 1e-6
        assert _rel(x, xj) < 1e-6
    else:
        assert residual_norm(s, x0, b) < 1e-10


@pytest.mark.parametrize("dtype,tol", [("cr32", 1e-6), ("cr64", 1e-9)])
def test_matches_jax_native(dtype, tol):
    """The port's embedded solve against the JAX package's native complex
    solve (tests/test_end_to_end.py:145-160)."""
    a, aj = _pair("rand80")
    b = np.asarray(a.to_scipy() @ (np.ones(a.n) + 0.5j))
    xn = japi.Solver(aj, japi.InitOptions(nb=16, dtype=dtype,
                                          complex_mode="native")).solve(b)
    x = pt.Solver(a, pt.InitOptions(nb=16, dtype=dtype,
                                    device="cpu")).solve(b)
    assert x.dtype == np.complex128    # b's precision
    np.testing.assert_allclose(x, xn, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
def test_transpose_against_scipy(dtype):
    """gstrs(trans=True) solves A^T x = b (not A^H x = b) as scipy does,
    on A in the working precision; a missing conjugation fails it."""
    a, hp, hj = _handles("rand100", dtype, 16, "auto")
    aw = a.to_scipy().astype(hp.complex_embed).astype(np.complex128)
    b = _rhs(a, seed=4)
    want = spla.spsolve(aw.T.tocsc(), b)
    x = pt.gstrs(hp, b, trans=True)
    assert residual_norm(aw.T.tocsc(), x, b) < 1e-10
    np.testing.assert_allclose(x, want, rtol=1e-8, atol=1e-8)
    assert _rel(spla.spsolve(aw.conj().T.tocsc(), b), want) > 1e-3
    bw = b.astype(hp.complex_embed)
    np.testing.assert_allclose(
        pt.gstrs(hp, bw, refine=0, trans=True),
        japi.gstrs(hj, bw, refine=0, trans=True),
        rtol=0, atol=SOLVE_TOL[dtype] * np.abs(want).max())


def test_multi_rhs_and_result_types():
    """[n, k] right-hand sides; a real b is taken as complex; x comes
    back in the wider of b's precision and the handle's."""
    a, hp, hj = _handles("poisson2d10", "cr32", 16, "nd")
    s = a.to_scipy().astype(np.complex64)   # the system cr32 solves
    bs = _rhs(a, 3, seed=1)
    xs = pt.gstrs(hp, bs)
    assert xs.shape == (a.n, 3) and xs.dtype == np.complex128
    assert residual_norm(s, xs, bs) < 1e-10
    for j in range(3):
        np.testing.assert_allclose(xs[:, j], pt.gstrs(hp, bs[:, j]),
                                   rtol=1e-12, atol=1e-12)
    b64 = bs[:, 0].astype(np.complex64)
    x64 = pt.gstrs(hp, b64)
    assert x64.dtype == np.complex64
    np.testing.assert_allclose(x64, japi.gstrs(hj, b64), rtol=1e-6,
                               atol=1e-6 * np.abs(x64).max())
    br = np.asarray(s.real @ np.ones(a.n))
    xr = pt.gstrs(hp, br)
    assert xr.dtype == np.complex128
    assert residual_norm(s, xr, br) < 1e-10
    assert pt.gstrs(hp, br.astype(np.float32)).dtype == np.complex64


@pytest.mark.parametrize("zero_imag", [True, False])
def test_update_values_matches_jax(zero_imag):
    """update_values embeds the new values before its pattern check
    (tests/test_reuse.py:96-150): a pure-real complex matrix, explicit
    zero imaginary parts and missing diagonals included, refactors with
    new imaginary parts; the solutions follow the JAX package's."""
    s = tm.random_unsymmetric(100, 0.05, seed=9,
                              dtype=np.complex128).to_scipy().tolil()
    for i in (3, 41, 77):
        s[i, i] = 0.0
    s = s.tocsc()
    s.eliminate_zeros()
    if zero_imag:
        s.data = s.data.real.astype(np.complex128)
    hp = pt.init(tsp.CscMatrix.from_scipy(s),
                 pt.InitOptions(nb=16, dtype="cr64", device="cpu"))
    hj = japi.init(jsp.CscMatrix.from_scipy(s),
                   japi.InitOptions(nb=16, dtype="cr64",
                                    complex_mode="embed"))
    pt.gstrf(hp)
    rng = np.random.default_rng(13)
    s2 = s.copy()
    s2.data = s2.data * (1.0 + 0.01 * rng.standard_normal(s.nnz)
                         + 0.01j * rng.standard_normal(s.nnz))
    pt.update_values(hp, s2)
    japi.update_values(hj, s2)
    _eq("a_origin", hp.a_origin.toarray(), hj.a_origin.toarray())
    pt.gstrf(hp)
    japi.gstrf(hj)
    b = s2 @ (rng.standard_normal(s.shape[0])
              + 1j * rng.standard_normal(s.shape[0]))
    x = pt.gstrs(hp, b)
    assert residual_norm(s2, x, b) < 1e-8
    assert _rel(x, japi.gstrs(hj, b)) < 1e-10
    with pytest.raises(ValueError, match="same sparsity"):
        pt.update_values(hp, s2 + sp.eye(s.shape[0], k=5,
                                         dtype=np.complex128))


def test_unsupported_raise():
    """As in the JAX package (pangulu_tpu/api.py:568-573, 788-791):
    gstrs_device and factor_diagnostics refuse a complex-embedded handle;
    complex_mode="native" solves (tests/test_torch_native_complex.py),
    on the compressed store too since ROADMAP Queue 1 item 6 closed (a
    mesh raises here only for want of a process group); a bogus mode
    raises naming complex_mode (tests/test_api_misc.py:39)."""
    a, hp, _ = _handles("poisson2d6", "cr64", 8, "auto")
    with pytest.raises(NotImplementedError, match="complex-embedded"):
        pt.gstrs_device(hp, torch.ones(a.n, dtype=torch.complex128))
    with pytest.raises(NotImplementedError, match="real dtypes"):
        pt.factor_diagnostics(hp)
    for dtype in ("cr32", "cr64"):
        h = pt.init(a, pt.InitOptions(nb=8, dtype=dtype, device="cpu",
                                      complex_mode="native"))
        pt.gstrf(h)
        b = _rhs(a)
        assert residual_norm(a.to_scipy(), pt.gstrs(h, b), b) < 1e-6
        hc = pt.init(a, pt.InitOptions(nb=8, dtype=dtype, device="cpu",
                                       complex_mode="native",
                                       tile_storage="compressed"))
        pt.gstrf(hc)
        assert hc.perf.kernels["engine"] == "compressed"
        assert residual_norm(a.to_scipy(), pt.gstrs(hc, b), b) < 1e-6
        with pytest.raises(ValueError, match="process group"):
            pt.init(a, pt.InitOptions(nb=8, dtype=dtype, device="cpu",
                                      complex_mode="native",
                                      mesh_shape=(1, 2)))
    with pytest.raises(ValueError, match="complex_mode"):
        pt.init(a, pt.InitOptions(nb=8, dtype="cr64", device="cpu",
                                  complex_mode="bogus"))
    # a real dtype ignores complex_mode="native", as the JAX package does
    pt.init(tm.poisson2d(4), pt.InitOptions(nb=8, device="cpu",
                                            complex_mode="native"))


def test_entry_points_take_complex():
    """analyze, gssv, spsolve and Solver take complex input; analyze
    reports the embedded system as the JAX package does."""
    a, aj = _pair("poisson2d8")
    got = pt.analyze(a, pt.InitOptions(nb=16, dtype="cr32", device="cpu"))
    want = japi.analyze(aj, japi.InitOptions(nb=16, dtype="cr32",
                                             complex_mode="embed"))
    for k in ("n", "nnz", "nb", "block_length", "tiles", "fill_nnz",
              "flops", "factor_hbm_bytes", "dtype"):
        assert got[k] == want[k], k
    b = _rhs(a, seed=2)
    h = pt.init(a, pt.InitOptions(nb=16, dtype="cr64", device="cpu"))
    x = pt.gssv(h, b)
    s = a.to_scipy()
    assert residual_norm(s, x, b) < 1e-12
    np.testing.assert_allclose(
        pt.spsolve(s, b, nb=16, dtype="cr64", device="cpu"), x, rtol=1e-12,
        atol=1e-12)
    sol = pt.Solver(s, nb=16, dtype="cr64", device="cpu")
    np.testing.assert_allclose(sol.solve(b), x, rtol=1e-12, atol=1e-12)
    sol.update_values(s * (1 + 0.5j))
    np.testing.assert_allclose(sol.solve(b), x / (1 + 0.5j), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dtype,limit", [("cr32", 1e-10), ("cr64", 1e-12)])
def test_compressed_store(tmp_path, dtype, limit):
    """tile_storage="compressed" factors the embedding (CompressedLU, P6's
    plain version) to the dense store's factors; save_factor ->
    load_factor -> gstrs (P2's plain twin) keeps the complex type."""
    a, hp, hj = _handles("poisson2d12", dtype, 16, "nd",
                         tile_storage="compressed")
    _, hd, _ = _handles("poisson2d12", dtype, 16, "nd")
    np.testing.assert_allclose(hp.factor_tiles.to_dense()[:-1],
                               hd.factor_tiles.numpy()[:-1],
                               rtol=1e-5, atol=1e-5)
    b = _rhs(a, seed=3)
    s = a.to_scipy()
    x = pt.gstrs(hp, b)
    assert residual_norm(s.astype(hp.complex_embed), x, b) < limit
    np.testing.assert_allclose(x, pt.gstrs(hd, b), rtol=1e-8, atol=1e-8)
    bw = b.astype(hp.complex_embed)
    assert _rel(pt.gstrs(hp, bw, refine=0),
                japi.gstrs(hj, bw, refine=0)) < SOLVE_TOL[dtype]
    save_factor(hp, tmp_path / "c.npz")
    h2 = load_factor(tmp_path / "c.npz", device="cpu")
    assert h2.complex_embed == hp.complex_embed
    np.testing.assert_allclose(pt.gstrs(h2, b), x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("storage", ["dense", "compressed"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross(tmp_path, writer, storage):
    """A complex checkpoint (its embedding, complex_embed named) saved by
    either package is solved by the other, to the writer's solution."""
    a, hp, hj = _handles("poisson2d10", "cr64", 16, "auto",
                         tile_storage=storage)
    b = _rhs(a, seed=5)
    path = tmp_path / "f.npz"
    def tiles(h):
        return (h.factor_tiles.to_dense() if storage == "compressed"
                and hasattr(h.factor_tiles, "to_dense")
                else np.asarray(h.factor_tiles))

    if writer == "jax":
        jsave(hj, path)
        h = load_factor(path, device="cpu")
        x, want = pt.gstrs(h, b), japi.gstrs(hj, b)
        _eq("factors", tiles(h), tiles(hj))
    else:
        save_factor(hp, path)
        h = jload(path)
        x, want = japi.gstrs(h, b), pt.gstrs(hp, b)
        _eq("factors", tiles(h), tiles(hp))
    assert h.complex_embed == np.complex128
    assert x.dtype == np.complex128
    np.testing.assert_allclose(x, want, rtol=1e-10, atol=1e-10)
    assert residual_norm(a.to_scipy(), x, b) < 1e-12


@pytest.mark.parametrize("fmt", ["mtx", "lid"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("cdt", [np.complex64, np.complex128])
def test_files_cross(tmp_path, writer, reader, fmt, cdt):
    """Complex .mtx and .lid files cross between the packages bit-equal;
    a .lid of complex64 (8 bytes an entry) is read when dtype says so."""
    a, _ = _pair("rand80")
    a = a.astype(cdt)
    wm = {"jax": jio, "port": tio}
    path = tmp_path / f"c.{fmt}"
    wm[writer].write_matrix(path, a)
    dtype = cdt if fmt == "lid" and cdt == np.complex64 else None
    got = {"jax": jio, "port": tio}[reader].read_matrix(path, dtype=dtype)
    want = jio.read_matrix(path, dtype=dtype)
    for f in ("colptr", "rowidx", "values"):
        _eq(f, getattr(got, f), getattr(want, f))
    if fmt == "lid":
        _eq("values", got.values, a.values)


@pytest.mark.parametrize("native_reader", [True, False])
def test_hermitian_mtx(tmp_path, monkeypatch, native_reader):
    """Hermitian .mtx storage expands to the full pattern (the lower
    triangle's conjugates), with the native reader and with scipy's."""
    from pangulu_tpu_torch import native

    if not native_reader:
        monkeypatch.setattr(native, "mmio_read", lambda path: None)
    s = tm.random_unsymmetric(40, 0.1, seed=1,
                              dtype=np.complex128).to_scipy()
    h = sp.tril(s, -1) + sp.tril(s, -1).conj().T + sp.diags(
        s.diagonal().real)
    import scipy.io

    scipy.io.mmwrite(tmp_path / "h.mtx", sp.coo_matrix(h),
                     symmetry="hermitian")
    assert "hermitian" in (tmp_path / "h.mtx").read_text().splitlines()[0]
    got = tio.read_matrix(tmp_path / "h.mtx")
    np.testing.assert_array_equal(got.to_scipy().toarray(), h.toarray())
    want = jio.read_matrix(tmp_path / "h.mtx")
    for f in ("colptr", "rowidx", "values"):
        _eq(f, getattr(got, f), getattr(want, f))


def test_rhs_files_and_generated_rhs(tmp_path):
    """read_rhs takes complex right-hand sides (.npy as the JAX package,
    and text files of complex values); generated_rhs of a complex
    matrix is A @ 1 in its type."""
    a, aj = _pair("rand80")
    b = _rhs(a, seed=6)
    np.save(tmp_path / "b.npy", b)
    np.savetxt(tmp_path / "b.txt", b)
    for cdt in (np.complex64, np.complex128):
        want = jio.read_rhs(tmp_path / "b.npy", a.n, cdt)
        _eq("npy", tio.read_rhs(tmp_path / "b.npy", a.n, cdt), want)
        _eq("txt", tio.read_rhs(tmp_path / "b.txt", a.n, cdt), want)
        _eq("generated", tio.generated_rhs(a.astype(cdt)),
            jio.generated_rhs(aj.astype(cdt)))


@pytest.mark.parametrize("writer", ["jax", "port", "jax native"])
def test_cli_load_factor_complex(tmp_path, capsys, writer):
    """--load-factor of a complex checkpoint builds the rhs and the
    residual for the complex system, not its embedding (cli.py; JAX
    cli.py:97-104), whichever package saved it; the JAX CLI's own cr64
    checkpoint on the CPU holds native complex factors, which the port
    solves with complex tiles."""
    a, aj = _pair("poisson2d8")
    mtx = tmp_path / "c.mtx"
    tio.write_matrix(mtx, a)
    fpath = str(tmp_path / "f.npz")
    args = ["-f", str(mtx), "-nb", "16", "--dtype", "cr64", "--save-factor",
            fpath]
    if writer == "jax":
        hj = japi.init(aj, japi.InitOptions(nb=16, dtype="cr64",
                                            complex_mode="embed"))
        japi.gstrf(hj)
        jsave(hj, fpath)
    elif writer == "port":
        assert cli.main(args + ["--device", "cpu"]) == 0
    else:
        assert jcli.main(args + ["--platform", "cpu"]) == 0
    capsys.readouterr()
    rc = cli.main(["--load-factor", fpath, "--device", "cpu"])
    out = capsys.readouterr()
    assert rc == 0
    line = [ln for ln in out.out.splitlines() if "solve residual" in ln][-1]
    assert float(line.split("=")[1]) < 1e-12
