"""The compressed store at nb > 256 and with native complex tiles
(``tile_storage="compressed"``, ``complex_mode="native"``) and the
checkpoints of both, on the CPU, against the JAX package on the same
matrices.

Tolerances, each with its source:
  * the store's arrays and P6's plain versions (decompress of every
    tile, compress back): bit-equal to the JAX store and its dense view
    (``CompressedTiles.__array__``): P6 moves values, it computes
    nothing;
  * factors and solutions against JAX's ``CompressedLU``: r64 and cr64
    1e-12, r32 and cr32 1e-5 (the repo's contract, ROADMAP.md
    "Tolerances"; tests/test_compressed.py:48);
  * P2's plain twin (``kernels_torch.triangle_inverses``, its tree of
    halves above 128) against ``torch.linalg.solve_triangular`` and the
    JAX package's ``unit_lower_inv_newton`` / ``upper_inv_newton`` on
    diagonally dominant tiles: float64 1e-12 and float32 1e-5, relative
    to the largest entry;
  * checkpoints: the store read by the other package bit-equal, its
    solution within the factor tolerance of the writer's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pangulu_tpu.api as japi
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as tm
from pangulu_tpu.compressed import CompressedLU as JCompressedLU
from pangulu_tpu.compressed import CompressedTiles as JCompressedTiles
from pangulu_tpu.io.checkpoint import load_factor as jload
from pangulu_tpu.io.checkpoint import save_factor as jsave
from pangulu_tpu.ops.kernels_jax import unit_lower_inv_newton as j_linv
from pangulu_tpu.ops.kernels_jax import upper_inv_newton as j_uinv
from pangulu_tpu_torch.compressed import CompressedLU, CompressedTiles
from pangulu_tpu_torch.io import load_factor, save_factor
from pangulu_tpu_torch.ops import kernels_cuda as kc
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.ops.kernels_torch import Indices
from pangulu_tpu_torch.outofcore import PanelLU
from pangulu_tpu_torch.testing import (compressed_launches, compressed_store,
                                       with_imaginary_parts)
from pangulu_tpu_torch.utils.perf import residual_norm

TOL = {"r32": 1e-5, "r64": 1e-12, "cr32": 1e-5, "cr64": 1e-12}
NP_DTYPE = {"r32": np.float32, "r64": np.float64, "cr32": np.complex64,
            "cr64": np.complex128}


def _matrix(dtype, nx=30):
    a = tm.poisson2d(nx)
    return with_imaginary_parts(a) if dtype.startswith("c") else a


def _jax_init(a, **opts):
    return japi.init(a.to_scipy(), japi.InitOptions(complex_mode="native",
                                                    **opts))


def _rhs(a, dtype):
    """(A in the working precision, widened, and b = A·x for x = 1 (+
    0.5i)): the refinement's residuals are those of A's values as the
    working type holds them (cr32: complex64)."""
    s = a.to_scipy().astype(NP_DTYPE[dtype]).astype(
        np.complex128 if dtype.startswith("c") else np.float64)
    x = np.ones(a.n) + (0.5j if dtype.startswith("c") else 0)
    return s, s @ x


# ---- P6's plain versions on wide and complex stores -----------------------

@pytest.mark.parametrize("dtype", ["r32", "r64", "cr32", "cr64"])
@pytest.mark.parametrize("nb", [288, 512])
def test_p6_twins_bit_equal_jax_store(nb, dtype):
    """Both packages build the same store (values, positions, offsets,
    capacities) from the same matrix; P6's plain decompress of every
    tile and the scratch tile is the JAX store's dense view bit for bit,
    and compressing it back leaves every slot as it was."""
    a = _matrix(dtype)
    hp, sp_ = compressed_store(a, nb, dtype, ordering="nd")
    hj = _jax_init(a, nb=nb, dtype=dtype, ordering="nd")
    sj = JCompressedTiles(hj.blocked, hj.reordering.reordered)
    assert sp_.idx.dtype == torch.uint32
    assert sp_.values.numpy().dtype == NP_DTYPE[dtype]
    for name, p, j in (("values", sp_.values.numpy(), sj.values),
                       ("idx", sp_.idx.numpy(), sj.idx),
                       ("off", sp_.off.host, sj.off),
                       ("cap", sp_.cap.host, sj.cap)):
        j = np.asarray(j)
        assert p.dtype == j.dtype and np.array_equal(p, j), name
    nt = sp_.num_tiles
    ids = Indices.build(np.r_[np.arange(nt), nt], "cpu")
    dense = kc.decompress_tiles(sp_.values, sp_.idx, sp_.off, sp_.cap, ids,
                                nb)
    want = np.asarray(sj)
    assert dense.numpy().dtype == want.dtype
    assert np.array_equal(dense.numpy(), want)
    before = sp_.values.clone()
    kc.compress_tiles(sp_.values, sp_.idx, sp_.off, sp_.cap, ids, dense)
    assert torch.equal(sp_.values, before)


@pytest.mark.parametrize("elem", [4, 8, 16])
def test_stage_geometry_refuses_a_row_past_the_chunk_limit(elem):
    """A decompress block holds whole rows in at most kSlotChunkBytes of
    shared memory: the widest nb whose row fits gets one-row blocks, one
    more raises naming the limit (the wrapper never launches a block of
    zero rows)."""
    nb = kc.SLOT_CHUNK_LIMIT // elem
    g = kc.stage_geometry(nb, elem, [nb * nb], 132)
    assert g.rows == 1 and g.chunks == nb
    with pytest.raises(ValueError, match="kSlotChunkBytes"):
        kc.stage_geometry(nb + 1, elem, [nb * nb], 132)


def test_store_refuses_nb_past_uint32_positions():
    """The JAX package's rule (pangulu_tpu/compressed.py:94-100): in-tile
    positions are uint32 at most, nb <= 65535."""
    with pytest.raises(ValueError, match="nb <= 65535"):
        kt.check_store_nb(65536)
    kt.check_store_nb(65535)


# ---- P2's plain twin above nb = 256 ----------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [384, 512])
def test_triangle_inverses_wide(nb, dtype):
    """The twin's tree of halves (triangle_split: 256 then 128 at both
    widths) against solve_triangular and the JAX package's doubling, on
    factored diagonally dominant tiles, a tiny pivot at a leaf's start
    included (the +tol rule on U's diagonal)."""
    assert kt.triangle_split(nb) == 256 and kt.triangle_split(256) == 128
    rng = np.random.default_rng(nb)
    a = rng.standard_normal((3, nb, nb)) + nb * np.eye(nb)
    a[2, 128, :] = a[2, :, 128] = 0.0          # pivot 128 exactly zero
    f = kt.getrf_with_inverses(torch.as_tensor(a))[0].to(dtype)
    tol = kt.DEFAULT_TOL[dtype]
    linv, uinv = kt.triangle_inverses(f, tol)
    eye = torch.eye(nb, dtype=torch.float64).expand(3, nb, nb)
    f64 = f.double()
    d = torch.diagonal(f64, dim1=-2, dim2=-1)
    safe = torch.where(d.abs() < tol, torch.full_like(d, tol), d)
    l_ref = torch.linalg.solve_triangular(f64, eye, upper=False,
                                          unitriangular=True)
    u_ref = torch.linalg.solve_triangular(
        f64 + torch.diag_embed(safe - d), eye, upper=True)
    rel = 1e-12 if dtype == torch.float64 else 1e-5
    for got, ref in ((linv, l_ref), (uinv, u_ref)):
        assert got.dtype == dtype
        np.testing.assert_allclose(got.double().numpy(), ref.numpy(),
                                   rtol=rel,
                                   atol=rel * float(ref.abs().max()))
    # the JAX package's Newton–Schulz doubling, on the two tiles without
    # the tiny pivot (its 1/tol entries sit past a doubling's f64 reach)
    fj = jnp.asarray(f64[:2].numpy())
    for got, ref in ((linv[:2], np.stack([np.asarray(j_linv(t))
                                          for t in fj])),
                     (uinv[:2], np.stack([np.asarray(j_uinv(t, tol))
                                          for t in fj]))):
        np.testing.assert_allclose(got.double().numpy(), ref, rtol=rel,
                                   atol=rel * float(np.abs(ref).max()))


def test_triangle_tree_below_257_is_the_128_split():
    """Up to nb = 256 the tree is the one split at 128 that P2 had:
    diagonal blocks of 128 and nb - 128."""
    for nb in (129, 200, 255, 256):
        assert kt.triangle_split(nb) == 128
    assert [kt.triangle_split(m) for m in (288, 384, 512, 640)] == \
        [256, 256, 256, 512]


# ---- CompressedLU at nb > 256 and with native complex tiles ----------------

@pytest.mark.parametrize("ordering", ["rcm", "nd"])
@pytest.mark.parametrize("dtype", ["r32", "r64"])
@pytest.mark.parametrize("nb", [288, 384])
def test_wide_compressed_matches_jax(nb, dtype, ordering):
    """CompressedLU at nb > 256 (the backend's diagonal step: kernels_xla
    on the CPU, as the JAX package's "jax" backend there; K1 for wide
    tiles on the card) against JAX's CompressedLU: factors, the
    persisted inverses and the solution."""
    a = tm.poisson2d(30)
    s, b = _rhs(a, dtype)
    hp = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                   device="cpu"))
    hj = _jax_init(a, nb=nb, dtype=dtype, ordering=ordering)
    clu = CompressedLU(hp.blocked, hp.schedule, hp.reordering.reordered,
                       device="cpu")
    assert clu.backend.name == "torch" and clu.store.idx.dtype == \
        torch.uint32
    got = clu.factorize().to_dense()
    jlu = JCompressedLU(hj.blocked, hj.schedule, hj.reordering.reordered)
    want = np.asarray(jlu.factorize())
    nt, tol = hp.blocked.num_tiles, TOL[dtype]
    np.testing.assert_allclose(got[:nt], want[:nt], rtol=tol, atol=tol)
    np.testing.assert_allclose(clu.inv_tiles.numpy(),
                               np.asarray(jlu.inv_tiles), rtol=tol, atol=tol)
    # the public route, refined as the repo's r32 runs are
    h = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                  device="cpu", tile_storage="compressed",
                                  check=True))
    x = pt.gssv(h, b)
    assert h.perf.kernels["engine"] == "compressed"
    assert h.perf.kernels["gstrf_residual"] < (1e-5 if dtype == "r32"
                                               else 1e-12)
    hj2 = _jax_init(a, nb=nb, dtype=dtype, ordering=ordering,
                    tile_storage="compressed")
    np.testing.assert_allclose(x, japi.gssv(hj2, b), rtol=tol, atol=tol)
    assert residual_norm(s, x, b) < (1e-10 if dtype == "r32" else 1e-12)


@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
@pytest.mark.parametrize("nb", [16, 32])
def test_native_complex_compressed_matches_jax(nb, dtype):
    """complex_mode="native" on the compressed store: complex slots, the
    diagonal step kernels_xla's (no hand kernel takes complex tiles, as
    no Pallas kernel does), against the JAX package's native complex
    compressed store; a reload inverts the diagonal tiles by the plain
    doubling, the JAX reload's function."""
    a = _matrix(dtype, nx=12)
    s, b = _rhs(a, dtype)
    opts = dict(nb=nb, dtype=dtype, ordering="rcm",
                tile_storage="compressed")
    h = pt.init(a, pt.InitOptions(device="cpu", complex_mode="native",
                                  check=True, **opts))
    x = pt.gssv(h, b)
    hj = _jax_init(a, **opts)
    xj = japi.gssv(hj, b)
    st = h.factor_tiles
    assert isinstance(st, CompressedTiles) and h.complex_embed is None
    assert st.values.dtype == {"cr32": torch.complex64,
                               "cr64": torch.complex128}[dtype]
    assert h.perf.kernels["backend"] == "torch"
    tol = TOL[dtype]
    nt = h.blocked.num_tiles
    np.testing.assert_allclose(st.to_dense()[:nt],
                               np.asarray(hj.factor_tiles)[:nt], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(x, xj, rtol=tol, atol=tol)
    assert h.perf.kernels["gstrf_residual"] < (1e-5 if dtype == "cr32"
                                               else 1e-12)
    assert residual_norm(s, x, b) < (1e-10 if dtype == "cr32" else 1e-12)
    # a reloaded store's inverses, by the doubling, solve the same way
    re = CompressedLU.from_store(h.blocked, h.schedule, st)
    np.testing.assert_allclose(re._ensure_inverses().numpy(),
                               h._factorizer.inv_tiles.numpy(),
                               rtol=10 * tol, atol=10 * tol)


def test_compressed_launch_counts_of_complex_tiles():
    """testing.compressed_launches: complex tiles launch P6 as real ones
    do, and neither K1 nor P2."""
    h = pt.init(tm.poisson2d(8), pt.InitOptions(nb=8, device="cpu"))
    real = compressed_launches(h.schedule, 1, 1, 1)
    cplx = compressed_launches(h.schedule, 1, 1, 1, complex_tiles=True)
    assert real["getrf_with_inverses"] > 0 and real["newton_inverses"] == 1
    assert cplx["getrf_with_inverses"] == cplx["newton_inverses"] == 0
    for k in ("decompress_tiles", "compress_tiles"):
        assert cplx[k] == real[k] > 0


@pytest.mark.parametrize("nb,dtype", [(288, "r32"), (16, "cr32")])
def test_panel_lu_refuses_wide_and_complex_tiles(nb, dtype):
    """The panel driver factors each cross with K2 (real, nb <= 256), and
    the JAX package takes it only at float32 and nb 128 or 256: built
    directly at nb > 256 or with complex tiles, it raises; the public
    route takes CompressedLU there."""
    a = _matrix(dtype, nx=20)
    h = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, device="cpu",
                                  complex_mode="native"))
    with pytest.raises(ValueError, match="K2.*nb <= 256.*128 or 256"):
        PanelLU(h.blocked, h.schedule, h.reordering.reordered, device="cpu")


# ---- checkpoints across the packages ---------------------------------------

# (id, dtype, nb, ordering)
CKPT = [("r64_nb288", "r64", 288, "nd"), ("cr64_native_nb16", "cr64", 16,
                                          "rcm")]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", CKPT, ids=[c[0] for c in CKPT])
def test_compressed_checkpoints_cross(tmp_path, case, writer):
    """A compressed factor of nb > 256 and one of native complex tiles,
    saved by one package and loaded by the other: the store read back
    bit-equal, the solutions agree, the port's reload solves through
    P6 and P2's twin (real) or the doubling (complex)."""
    _, dtype, nb, ordering = case
    a = _matrix(dtype, nx=30 if nb > 256 else 12)
    s, b = _rhs(a, dtype)
    opts = dict(nb=nb, dtype=dtype, ordering=ordering,
                tile_storage="compressed")
    hp = pt.init(a, pt.InitOptions(device="cpu", complex_mode="native",
                                   **opts))
    hj = _jax_init(a, **opts)
    xp, xj = pt.gssv(hp, b), japi.gssv(hj, b)
    path = tmp_path / "f.npz"
    tol = TOL[dtype]
    if writer == "jax":
        jsave(hj, path)
        h = load_factor(path, device="cpu")
        assert isinstance(h.factor_tiles, CompressedTiles)
        assert h.complex_embed is None
        assert np.array_equal(h.factor_tiles.to_dense(),
                              np.asarray(hj.factor_tiles))
        x = pt.gstrs(h, b)
        np.testing.assert_allclose(x, xj, rtol=tol, atol=tol)
    else:
        save_factor(hp, path)
        h = jload(path)
        assert isinstance(h.factor_tiles, JCompressedTiles)
        assert np.array_equal(np.asarray(h.factor_tiles),
                              hp.factor_tiles.to_dense())
        x = japi.gstrs(h, b)
        np.testing.assert_allclose(x, xp, rtol=tol, atol=tol)
        x = pt.gstrs(load_factor(path, device="cpu"), b)
        np.testing.assert_allclose(x, xp, rtol=tol, atol=tol)
    assert residual_norm(s, x, b) < 1e-12


@pytest.mark.parametrize("args", [["-nb", "288", "--dtype", "r64"],
                                  ["-nb", "16", "--dtype", "cr64",
                                   "--complex-mode", "native"]],
                         ids=["nb288", "native_cr64"])
def test_cli_compressed_wide_and_native(tmp_path, capsys, args):
    """``--tile-storage compressed`` with ``-nb`` above 256 and with
    ``--complex-mode native`` (both exited 2 before): the gstrf check
    and the solve."""
    from pangulu_tpu_torch import cli
    from pangulu_tpu_torch.io.mmio import write_matrix

    a = _matrix(args[3], nx=30 if args[1] == "288" else 12)
    write_matrix(tmp_path / "a.mtx", a)
    rc = cli.main(["-f", str(tmp_path / "a.mtx"), *args, "--tile-storage",
                   "compressed", "--device", "cpu", "--check"])
    out = capsys.readouterr().out
    assert rc == 0
    line = [ln for ln in out.splitlines() if "solve residual" in ln][-1]
    assert float(line.split("=")[1]) < 1e-12
