"""The compressed tile store (``tile_storage="compressed"``) of the port,
on the CPU (device="cpu": the plain versions of P6 and P2), against the
JAX package's ``pangulu_tpu.compressed`` on the same matrices.

Tolerances, each with its source:
  * host tables of the store (off, cap, capmax, idx and its dtype, the
    slot maps of A and of the padded tail) and its densified values:
    bit-equal (the same numpy construction);
  * P6 against the TPU probe ``tools/exp_scatter.run`` (interpret mode):
    bit-equal (a scatter moves values, it computes nothing);
  * P2 f32 against the probe ``tools/exp_batched_scan.batched_newton``
    (interpret mode): rtol/atol 1e-5 on well-conditioned unit-lower
    tiles (sums of products in another order); f64 against
    ``unit_lower_inv_newton`` / ``upper_inv_newton``: 1e-12;
  * factors against JAX ``CompressedLU`` and the port's dense engine:
    f64 rtol 1e-12 / atol 1e-14 (tests/test_compressed.py:48), f32 1e-5
    (tests/test_mega.py's), 2e-4 against the grouped dense engine (its
    sums run in another order, tests/test_mega_group.py:66);
  * end to end: residual < 1e-6 on the circuit matrices
    (tests/test_compressed.py:57, 200) and x against JAX's at 1e-8 on
    well-conditioned matrices.  The circuits are near singular (2-norm
    condition ~1e16): there the JAX package's own dense and compressed
    engines give solutions 5e-5 apart, so no two implementations agree
    to 1e-8 in x; the port is held to JAX there by its factors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pangulu_tpu.api as japi
import pangulu_tpu.models as jm
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as tm
from pangulu_tpu.compressed import CompressedLU as JCompressedLU
from pangulu_tpu.compressed import CompressedTiles as JCompressedTiles
from pangulu_tpu_torch import cli
from pangulu_tpu_torch.compressed import CompressedLU, CompressedTiles
from pangulu_tpu_torch.io.mmio import generated_rhs, write_matrix
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.ops.kernels_torch import Indices
from pangulu_tpu_torch.utils.perf import residual_norm

# (id, generator, kwargs, nb, ordering)
CASES = [
    ("poisson2d9_nb8", "poisson2d", dict(nx=9), 8, "rcm"),
    ("smallworld14_nb16", "smallworld", dict(nx=14), 16, "rcm"),
    ("circuit500_nb16", "circuit", dict(n=500, seed=4), 16, "mindeg"),
    ("circuit600_nb32", "circuit", dict(n=600, seed=2), 32, "auto"),
    ("poisson2d20_nb256", "poisson2d", dict(nx=20), 256, "rcm"),
]


def _pair(gen, kw, nb, ordering, dtype="r64"):
    """The same matrix through both packages' init: (port handle, JAX
    handle)."""
    hp = pt.init(getattr(tm, gen)(**kw),
                 pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                device="cpu"))
    hj = japi.init(getattr(jm, gen)(**kw),
                   japi.InitOptions(nb=nb, dtype=dtype, ordering=ordering))
    return hp, hj


def _stores(case, dtype="r64"):
    _, gen, kw, nb, ordering = case
    hp, hj = _pair(gen, kw, nb, ordering, dtype)
    sp_ = CompressedTiles(hp.blocked, hp.reordering.reordered, device="cpu")
    sj = JCompressedTiles(hj.blocked, hj.reordering.reordered)
    return hp, hj, sp_, sj


def _eq(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.array_equal(a, b), name


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_store_tables_bit_equal_jax(case):
    """Every host table of the store, its slot positions with their dtype
    (uint16 up to nb = 255, uint32 at nb = 256) and its values are the
    JAX store's; the densified store is the dense tile store."""
    hp, _, sp_, sj = _stores(case)
    assert sp_.idx.dtype == (torch.uint32 if case[3] == 256
                             else torch.uint16)
    _eq("off", sp_.off.host, sj.off)
    _eq("cap", sp_.cap.host, sj.cap)
    _eq("idx", sp_.idx.numpy(), sj.idx)
    _eq("values", sp_.values.numpy(), sj.values)
    _eq("host_off", sp_.host_off, sj.host_off)
    _eq("host_cap", sp_.host_cap, sj.host_cap)
    _eq("_a_slots", sp_._a_slots, sj._a_slots)
    _eq("_tail_slots", sp_._tail_slots, sj._tail_slots)
    assert (sp_.capmax, sp_.nnz_pattern, sp_.scratch_slot) == \
        (sj.capmax, sj.nnz_pattern, sj.scratch_slot)
    assert (sp_.compressed_bytes, sp_.dense_bytes) == \
        (sj.compressed_bytes, sj.dense_bytes)
    nt = hp.blocked.num_tiles
    _eq("to_dense", sp_.to_dense()[:nt], hp.blocked.tiles[:nt])
    _eq("to_dense vs JAX", sp_.to_dense(), np.asarray(sj))


def test_fill_entries_native_matches_python_fallback(monkeypatch):
    """The native fill walk (pangulu_fill_entries) and the Python
    row-subtree walk emit the same entries in the same order."""
    from pangulu_tpu_torch import compressed, native

    a3 = pt.init(tm.circuit(500, seed=4),
                 pt.InitOptions(nb=16, device="cpu")).reordering.reordered
    fast = compressed._scalar_fill_entries(a3)
    monkeypatch.setattr(native, "fill_walk", lambda *a, **k: None)
    slow = compressed._scalar_fill_entries(a3)
    for f, s in zip(fast, slow):
        _eq("fill entries", f, s)


def _probe_interpret(monkeypatch, module):
    """Run a TPU probe's pallas_call in interpret mode (the probes pin
    interpret=False, which needs a TPU)."""
    real = module.pl.pallas_call

    def pallas_call(*args, **kw):
        return real(*args, **{**kw, "interpret": True})

    monkeypatch.setattr(module.pl, "pallas_call", pallas_call)


def test_decompress_bit_equal_tpu_probe(monkeypatch):
    """P6's plain decompress against tools/exp_scatter.run(..., "scatter")
    on the probe's own case: 1024 u16 slots into a 128 x 128 f32 tile."""
    import tools.exp_scatter as probe

    _probe_interpret(monkeypatch, probe)
    rng = np.random.default_rng(0)
    perm = np.sort(rng.permutation(probe.NN)[:probe.CAP]).astype(np.int32)
    vals = rng.standard_normal(probe.CAP).astype(np.float32)
    want = np.asarray(probe.run(jnp.asarray(vals[None]),
                                jnp.asarray(perm[None]), "scatter"))
    off = Indices.build([0, probe.CAP], "cpu")
    cap = Indices.build([probe.CAP, 0], "cpu")
    got = kt.decompress_tiles(torch.from_numpy(vals),
                              torch.from_numpy(perm.astype(np.uint16)), off,
                              cap, Indices.build([0], "cpu"), probe.NB)
    _eq("P6 decompress", got[0].numpy(), want)


@pytest.mark.parametrize("case", [CASES[1], CASES[4]],
                         ids=[CASES[1][0], CASES[4][0]])
def test_compress_decompress_round_trip(case):
    """Decompress every tile (the scratch tile too), compress into a
    cleared store: every real slot comes back bit-equal, the sentinel
    slots past the last tile are not written, and the scratch tile is
    zero."""
    hp, _, st, _ = _stores(case)
    nt = hp.blocked.num_tiles
    ids = Indices.build(np.arange(nt + 1)[::-1], "cpu")
    dense = kt.decompress_tiles(st.values, st.idx, st.off, st.cap, ids,
                                st.nb)
    _eq("decompress = to_dense", dense.flip(0).numpy(), st.to_dense())
    assert not dense[0].any()
    back = torch.full_like(st.values, 7.0)
    kt.compress_tiles(back, st.idx, st.off, st.cap, ids, dense)
    s = st.scratch_slot
    _eq("round trip", back[:s].numpy(), st.values[:s].numpy())
    assert (back[s:] == 7.0).all()


def test_newton_f32_matches_tpu_probe(monkeypatch):
    """P2's plain unit-lower Newton inverse against
    tools/exp_batched_scan.batched_newton in interpret mode."""
    import tools.exp_batched_scan as probe

    _probe_interpret(monkeypatch, probe)
    rng = np.random.default_rng(1)
    g, nb = 4, 16
    lm = (np.tril(rng.standard_normal((g, nb, nb)), -1) / nb
          + np.eye(nb)).astype(np.float32)
    want = np.asarray(probe.batched_newton(
        jnp.asarray(lm), g=g, nb=nb, steps=kt.newton_steps(nb)))
    got = kt.unit_lower_inv_newton(torch.from_numpy(lm)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got @ lm, np.broadcast_to(np.eye(nb), lm.shape),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nb", [8, 16, 33])
def test_newton_f64_matches_jax(nb):
    """P2's plain versions at f64 against the JAX package's
    unit_lower_inv_newton / upper_inv_newton, a tiny pivot included."""
    from pangulu_tpu.ops.kernels_jax import (unit_lower_inv_newton,
                                             upper_inv_newton)

    rng = np.random.default_rng(nb)
    f = rng.standard_normal((3, nb, nb)) / nb + 2 * np.eye(nb)
    f[1, nb // 2, nb // 2] = 0.0          # tiny pivot: substituted
    tol = kt.DEFAULT_TOL[torch.float64]
    linv, uinv = kt.newton_inverses(torch.from_numpy(f), tol)
    jl = jax.vmap(unit_lower_inv_newton)(jnp.asarray(f))
    ju = jax.vmap(lambda x: upper_inv_newton(x, tol))(jnp.asarray(f))
    np.testing.assert_allclose(linv.numpy(), np.asarray(jl), rtol=1e-12,
                               atol=1e-12)
    # U^-1 holds entries up to 1/tol on the substituted row: relative
    np.testing.assert_allclose(uinv.numpy(), np.asarray(ju), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(ju)).max())


@pytest.mark.parametrize("dtype", ["r64", "r32"])
@pytest.mark.parametrize("case", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_factorize_matches_jax_and_dense(case, dtype):
    """CompressedLU.factorize against JAX CompressedLU and the port's own
    dense engine on the same store (tests/test_compressed.py:38-49)."""
    _, gen, kw, nb, ordering = case
    hp, hj = _pair(gen, kw, nb, ordering, dtype)
    clu = CompressedLU(hp.blocked, hp.schedule, hp.reordering.reordered,
                       device="cpu")
    got = clu.factorize().to_dense()
    jlu = JCompressedLU(hj.blocked, hj.schedule, hj.reordering.reordered)
    want = np.asarray(jlu.factorize())
    fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu")
    dense = fac.factorize().numpy()
    nt = hp.blocked.num_tiles
    tol = (dict(rtol=1e-12, atol=1e-14) if dtype == "r64"
           else dict(rtol=1e-5, atol=1e-5))
    np.testing.assert_allclose(got[:nt], want[:nt], **tol)
    np.testing.assert_allclose(clu.inv_tiles.numpy(),
                               np.asarray(jlu.inv_tiles), **tol)
    if dtype == "r32" and fac.dispatch == "mega_group":
        tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[:nt], dense[:nt], **tol)


def test_end_to_end_matches_jax():
    """tests/test_compressed.py:52-64: circuit(600) nb=32 r64 compressed,
    factor once and solve twice.  The matrix is near singular (2-norm
    condition ~4.5e16): the JAX package's own dense and compressed
    engines give solutions 5e-5 apart on it, so the port is held to JAX
    here by its factors (1e-12 / 1e-14) and its residuals, and by its
    solutions on the well-conditioned matrices of
    test_solution_matches_jax."""
    a, aj = tm.circuit(600, seed=2), jm.circuit(600, seed=2)
    b = generated_rhs(a)
    h = pt.init(a, pt.InitOptions(nb=32, dtype="r64",
                                  tile_storage="compressed", device="cpu"))
    hj = japi.init(aj, japi.InitOptions(nb=32, dtype="r64",
                                        tile_storage="compressed"))
    x = pt.gssv(h, b)
    japi.gstrf(hj)
    assert isinstance(h.factor_tiles, CompressedTiles)
    assert h.perf.kernels["engine"] == "compressed"
    np.testing.assert_allclose(h.factor_tiles.to_dense(),
                               np.asarray(hj.factor_tiles), rtol=1e-12,
                               atol=1e-14)
    assert residual_norm(a.to_scipy(), x, b) < 1e-6
    b2 = np.asarray(a.to_scipy() @ np.arange(1.0, a.n + 1))
    assert residual_norm(a.to_scipy(), pt.gstrs(h, b2), b2) < 1e-6
    pt.finalize(h)


SOLVE_CASES = [("poisson2d16_nb16_nd", "poisson2d", (16,), 16, "nd"),
               ("smallworld14_nb16_rcm", "smallworld", (14,), 16, "rcm")]


@pytest.mark.parametrize("case", SOLVE_CASES, ids=[c[0] for c in SOLVE_CASES])
def test_solution_matches_jax(case):
    """Solutions of one and of three right-hand sides against JAX
    compressed at 1e-8, on well-conditioned matrices."""
    _, gen, args, nb, ordering = case
    a, aj = getattr(tm, gen)(*args), getattr(jm, gen)(*args)
    opts = dict(nb=nb, dtype="r64", ordering=ordering,
                tile_storage="compressed")
    h = pt.init(a, pt.InitOptions(device="cpu", **opts))
    hj = japi.init(aj, japi.InitOptions(**opts))
    b = np.random.default_rng(3).standard_normal((a.n, 3))
    np.testing.assert_allclose(pt.gssv(h, b[:, 0]), japi.gssv(hj, b[:, 0]),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(pt.gstrs(h, b), japi.gstrs(hj, b), rtol=1e-8,
                               atol=1e-8)


def test_r32_refined_and_checked():
    """r32 compressed with the gstrf check and the default 2 refinement
    rounds: the r32 limits of the repo (gstrf < 1e-5, solve < 1e-10)."""
    a = tm.poisson2d(12)
    b = generated_rhs(a)
    h = pt.init(a, pt.InitOptions(nb=16, dtype="r32", ordering="nd",
                                  tile_storage="compressed", device="cpu",
                                  check=True))
    x = pt.gssv(h, b)
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    assert residual_norm(a.to_scipy(), x, b) < 1e-10


def test_refactorize_reuses_store():
    """tests/test_compressed.py:81-105: update_values + gstrf refills the
    same store object (O(nnz)) and solves the new matrix."""
    a = tm.circuit(500, seed=4)
    s = a.to_scipy()
    h = pt.init(a, pt.InitOptions(nb=16, dtype="r64",
                                  tile_storage="compressed", device="cpu"))
    b = generated_rhs(a)
    assert residual_norm(s, pt.gssv(h, b), b) < 1e-9
    store1 = h._comp_store
    assert store1 is h.factor_tiles
    s2 = s.copy()
    s2.data = s2.data * (1.0 + 0.05 * np.sin(np.arange(s2.nnz)))
    pt.update_values(h, s2)
    pt.gstrf(h)
    assert h._comp_store is store1
    b2 = np.asarray(s2 @ np.ones(a.n))
    assert residual_norm(s2.tocsc(), pt.gstrs(h, b2), b2) < 1e-9
    pt.finalize(h)


# circuit(700) as tests/test_compressed.py:180 (near singular: held by
# its residual and the bytes), poisson2d(16) nd for the solutions
CKPT_CASES = [("circuit700_nb32", "circuit", (700, 8), 32, "auto", 1e-6),
              ("poisson2d16_nb16_nd", "poisson2d", (16,), 16, "nd", 1e-10)]


def _factored_both(case):
    _, gen, args, nb, ordering, _ = case
    a, aj = getattr(tm, gen)(*args), getattr(jm, gen)(*args)
    b = generated_rhs(a)
    opts = dict(nb=nb, dtype="r64", ordering=ordering,
                tile_storage="compressed")
    h = pt.init(a, pt.InitOptions(device="cpu", **opts))
    hj = japi.init(aj, japi.InitOptions(**opts))
    return a, b, h, hj, pt.gssv(h, b), japi.gssv(hj, b)


@pytest.mark.parametrize("case", CKPT_CASES, ids=[c[0] for c in CKPT_CASES])
def test_checkpoint_jax_to_port(tmp_path, case):
    """A compressed factor saved by the JAX package is loaded as the
    O(fill) store and solved by the port (tests/test_compressed.py:
    180-201)."""
    from pangulu_tpu.io.checkpoint import save_factor as jsave
    from pangulu_tpu_torch.io import load_factor

    a, b, _, hj, _, xj = _factored_both(case)
    jsave(hj, tmp_path / "j.npz")
    h = load_factor(tmp_path / "j.npz", device="cpu")
    assert isinstance(h.factor_tiles, CompressedTiles)
    assert h.factor_tiles.compressed_bytes < h.factor_tiles.dense_bytes
    _eq("loaded store", h.factor_tiles.to_dense(),
        np.asarray(hj.factor_tiles))
    x = pt.gstrs(h, b)
    assert residual_norm(a.to_scipy(), x, b) < case[-1]
    if case[1] == "poisson2d":
        np.testing.assert_allclose(x, xj, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("case", CKPT_CASES, ids=[c[0] for c in CKPT_CASES])
def test_checkpoint_port_to_jax_and_back(tmp_path, case):
    """A compressed factor saved by the port is solved by the JAX package
    and by the port (P6 on the diagonal tiles, then P2); the reloaded
    inverses are the factorization's own."""
    from pangulu_tpu.compressed import CompressedTiles as JTiles
    from pangulu_tpu.io.checkpoint import load_factor as jload
    from pangulu_tpu_torch.io import load_factor, save_factor

    a, b, h, _, x_ref, _ = _factored_both(case)
    save_factor(h, tmp_path / "p.npz")
    hj = jload(tmp_path / "p.npz")
    assert isinstance(hj.factor_tiles, JTiles)
    _eq("store read by JAX", np.asarray(hj.factor_tiles),
        h.factor_tiles.to_dense())
    h2 = load_factor(tmp_path / "p.npz", device="cpu")
    for x in (japi.gstrs(hj, b), pt.gstrs(h2, b)):
        assert residual_norm(a.to_scipy(), x, b) < case[-1]
        if case[1] == "poisson2d":
            np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-8)
    if case[1] == "poisson2d":
        np.testing.assert_allclose(h2._factorizer.inv_tiles.numpy(),
                                   h._factorizer.inv_tiles.numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_init_accepts_compressed():
    """The positive side of what init refused before the store was
    ported: tile_storage='compressed' factors into the compressed
    store."""
    a = tm.poisson2d(4)
    h = pt.init(a, pt.InitOptions(nb=4, device="cpu",
                                  tile_storage="compressed"))
    pt.gstrf(h)
    assert isinstance(h.factor_tiles, CompressedTiles)
    b = generated_rhs(a)
    assert residual_norm(a.to_scipy(), pt.gstrs(h, b), b) < 1e-12


def test_cli_tile_storage_compressed(tmp_path, capsys):
    """``--tile-storage compressed --check`` runs and solves (it exited 2
    before the store was ported)."""
    a = tm.poisson2d(7)
    write_matrix(tmp_path / "a.mtx", a)
    rc = cli.main(["-f", str(tmp_path / "a.mtx"), "-nb", "16", "--dtype",
                   "r64", "--tile-storage", "compressed", "--device",
                   "cpu", "--check"])
    out = capsys.readouterr().out
    assert rc == 0
    line = [ln for ln in out.splitlines() if "solve residual" in ln][-1]
    assert float(line.split("=")[1]) < 1e-12


def test_cli_save_and_load_compressed(tmp_path, capsys):
    """The CLI saves a compressed factor and solves from it again."""
    a = tm.poisson2d(7)
    write_matrix(tmp_path / "a.mtx", a)
    f = str(tmp_path / "f.npz")
    assert cli.main(["-f", str(tmp_path / "a.mtx"), "-nb", "16",
                     "--tile-storage", "compressed", "--device", "cpu",
                     "--save-factor", f]) == 0
    assert cli.main(["--load-factor", f, "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if "solve residual" in ln][-1]
    assert float(line.split("=")[1]) < 1e-12


def test_unsupported_on_compressed_raise():
    """As in the JAX package (pangulu_tpu/api.py:454-463, 562-573): the
    transpose solve, gstrs_device (and factor_diagnostics, which needs
    the transpose solve) take the dense store only."""
    a = tm.poisson2d(6)
    h = pt.init(a, pt.InitOptions(nb=8, device="cpu",
                                  tile_storage="compressed"))
    pt.gstrf(h)
    with pytest.raises(NotImplementedError, match="compressed"):
        pt.gstrs(h, np.ones(a.n), trans=True)
    with pytest.raises(NotImplementedError, match="compressed"):
        pt.gstrs_device(h, torch.ones(a.n, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="dense tile store"):
        pt.factor_diagnostics(h)


def _store(nb=16):
    h = pt.init(tm.poisson2d(12), pt.InitOptions(nb=nb, device="cpu"))
    return CompressedTiles(h.blocked, h.reordering.reordered, device="cpu")


def test_slot_wrappers_reject_bad_input(monkeypatch):
    """On the card's path (here forced, the launch never reached), P6's
    wrappers refuse repeated real ids, ids out of range, slot ranges
    outside the store and a uint16 store above nb = 255."""
    monkeypatch.setattr(kernels_cuda, "_on_cuda", lambda t: True)
    monkeypatch.setattr(kernels_cuda, "library",
                        lambda: pytest.fail("reached the kernel launch"))
    st = _store()
    nt = st.num_tiles
    args = (st.values, st.idx, st.off, st.cap)
    with pytest.raises(ValueError, match="repeat"):
        kernels_cuda.decompress_tiles(*args, Indices.build([1, 1], "cpu"),
                                      16)
    with pytest.raises(ValueError, match="outside"):
        kernels_cuda.decompress_tiles(*args, Indices.build([nt + 1], "cpu"),
                                      16)
    with pytest.raises(ValueError, match="uint16"):
        kernels_cuda.decompress_tiles(*args, Indices.build([0], "cpu"), 256)
    bad = Indices.build(st.cap.host.copy(), "cpu")
    bad.host[0] = st.values.numel() + 1
    with pytest.raises(ValueError, match="slot ranges"):
        kernels_cuda.compress_tiles(st.values, st.idx, st.off, bad,
                                    Indices.build([0], "cpu"),
                                    torch.zeros(1, 16, 16,
                                                dtype=st.values.dtype))
    with pytest.raises(TypeError, match="uint16 or uint32"):
        kernels_cuda.decompress_tiles(st.values, st.idx.to(torch.int32),
                                      st.off, st.cap,
                                      Indices.build([0], "cpu"), 16)


def test_scratch_ids_may_repeat_and_read_nothing():
    """The scratch tile nt (cap 0) pads a batch: it may repeat, comes
    out zero and writes nothing back; only tile 0's slots change."""
    st = _store()
    nt = st.num_tiles
    ids = Indices.build([nt, 0, nt], "cpu")
    dense = kt.decompress_tiles(st.values, st.idx, st.off, st.cap, ids, 16)
    assert not dense[0].any() and not dense[2].any()
    dense += 3.0
    before = st.values.clone()
    kt.compress_tiles(st.values, st.idx, st.off, st.cap, ids, dense)
    o, c = int(st.host_off[0]), int(st.host_cap[0])
    changed = (st.values != before).nonzero().flatten()
    assert len(changed) == c and changed.min() == o
    assert torch.equal(st.values[o:o + c], before[o:o + c] + 3.0)


def test_newton_wrapper_rejects_bad_input(monkeypatch):
    monkeypatch.setattr(kernels_cuda, "_on_cuda", lambda t: True)
    monkeypatch.setattr(kernels_cuda, "library",
                        lambda: pytest.fail("reached the kernel launch"))
    with pytest.raises(ValueError, match=r"\[B, nb, nb\]"):
        kernels_cuda.newton_inverses(torch.eye(4))
    with pytest.raises(TypeError, match="float32 or float64"):
        kernels_cuda.newton_inverses(torch.eye(4, dtype=torch.float16)[None])
    with pytest.raises(TypeError, match="float32 or float64"):
        kernels_cuda.newton_inverses(torch.eye(4, dtype=torch.complex64)[None])
    # P2 takes any nb of the store (its tree above 128): the limit is the
    # store's uint32 positions, beyond stage_geometry's for P6 (checked
    # on a meta tensor: nothing is allocated)
    with pytest.raises(ValueError, match="nb <= 65535"):
        kernels_cuda.newton_inverses(torch.empty((1, 65536, 65536),
                                                 device="meta"))
