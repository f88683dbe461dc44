"""The superfused and segmented engines of the port (numeric.py,
``dispatch="superfused"`` / ``"segmented"``) and their host tables
(schedule.py), device="cpu", against the JAX package on the same
matrices (tests/test_superlevel.py, tests/test_segmented.py).

Contract: the tables are integer structure, bit-equal to the JAX
package's, padding included.  Factors: the port's superfused against the
JAX package's within 1e-9 at r64 (tests/test_superlevel.py:74) and 1e-5
at r32 (ROADMAP.md "Tolerances"); against the port's fused engine the
same; native complex superfused (the torch backend's batched diagonal
step) against the JAX package's native superfused and the port's fused
within 1e-12 at cr64 and 1e-5 at cr32 (tests/test_torch_native_
complex.py's tolerances); ``dispatch="segmented"``, taken as the fused
engine, against the JAX package's segmented engine within 1e-13
(tests/test_segmented.py:28) and the port's fused bit for bit; the
end-to-end gstrf residual < 1e-12 at r64.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pangulu_tpu.models as jm
import pangulu_tpu.schedule as jsched
import pangulu_tpu.sparse as jsp
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as tm
from pangulu_tpu.api import InitOptions as JOpts
from pangulu_tpu.api import init as jinit
from pangulu_tpu.numeric import LUFactorizer as JFactorizer
from pangulu_tpu_torch import schedule as tsched
from pangulu_tpu_torch.blocks import gather_factor
from pangulu_tpu_torch.io import load_factor, save_factor
from pangulu_tpu_torch.numeric import LUFactorizer, pick_engine
from pangulu_tpu_torch.ops import interface
from pangulu_tpu_torch.sptrsv import TriangularSolver
from pangulu_tpu_torch.testing import with_imaginary_parts
from pangulu_tpu_torch.utils.perf import factorization_residual, residual_norm

TOL = {"r32": dict(rtol=1e-5, atol=1e-5), "r64": dict(rtol=1e-9, atol=1e-9),
       "cr32": dict(rtol=1e-5, atol=1e-5),
       "cr64": dict(rtol=1e-12, atol=1e-12)}
SEG_TOL = dict(rtol=1e-13, atol=1e-13)
# (generator, argument, ordering, nb): the JAX tests' matrices (the
# first three, whose tables are compared), and two smaller ones whose
# factors are (the JAX engines compile once a segment's shape: a rcm
# chain of 2 superfused segments, and 2 segments of levels)
PROBLEMS = {"smallworld20_nd": ("smallworld", 20, "nd", 16),
            "smallworld20_rcm": ("smallworld", 20, "rcm", 16),
            "poisson2d12_mindeg": ("poisson2d", 12, "mindeg", 16),
            "smallworld10_rcm": ("smallworld", 10, "rcm", 8),
            "smallworld12_nd": ("smallworld", 12, "nd", 8),
            "poisson2d10_complex_nd": ("poisson2d", 10, "nd", 8)}
NB = 16


def _pair(name, dtype="r64"):
    """(port handle, JAX handle) after init of PROBLEMS[name]; a
    ``*_complex_*`` problem carries imaginary parts (with_imaginary_parts)
    and runs with complex_mode="native"."""
    gen, arg, ordering, nb = PROBLEMS[name]
    kw = {}
    a, aj = getattr(tm, gen)(arg), getattr(jm, gen)(arg)
    if "_complex_" in name:
        a = with_imaginary_parts(a)
        aj = jsp.CscMatrix.from_scipy(a.to_scipy())
        kw = dict(complex_mode="native")
    hp = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                   device="cpu", **kw))
    hj = jinit(aj, JOpts(nb=nb, dtype=dtype, ordering=ordering, **kw))
    return hp, hj


@pytest.fixture(scope="module")
def jax_factors():
    """Per (problem, dtype, engine), the JAX package's factored tiles
    (cached: its engines compile once a segment shape)."""
    cache = {}

    def get(name, dtype, engine):
        key = (name, dtype, engine)
        if key not in cache:
            _, hj = _pair(name, dtype)
            cache[key] = np.asarray(JFactorizer(
                hj.blocked, hj.schedule, dispatch=engine).factorize())
        return cache[key]
    return get


def _factor(h, dispatch, **kw) -> torch.Tensor:
    return LUFactorizer(h.blocked, h.schedule, device="cpu",
                        dispatch=dispatch, **kw).factorize()


# ---- the host tables -------------------------------------------------

def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("table,args", [
    ("segmented_tables", ()), ("segmented_tables", (2,)),
    ("superfused_tables", ()), ("superfused_tables", (3,)),
    ("superfused_wave_tables", ()), ("superfused_wave_tables", (4,)),
    ("superfused_wave_tables", (1000,))])
@pytest.mark.parametrize("name", list(PROBLEMS)[:3])
def test_tables_bit_equal(name, table, args):
    """Each table gives the JAX package's segments, arrays, dtypes and
    padding (args: min_run, min_run, gmax)."""
    hp, hj = _pair(name)
    nt = hp.blocked.num_tiles
    got = getattr(hp.schedule, table)(nt, *args)
    want = getattr(hj.schedule, table)(nt, *args)
    assert len(got) == len(want)
    for s, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            _eq(a, b, f"{table} segment {s} array {i}")


@pytest.mark.parametrize("min_run", [1, 2, 4, 16])
def test_group_runs_bit_equal(min_run):
    """group_runs on seeded signature sequences (runs of every length,
    short runs at the start, the middle and the end)."""
    rng = np.random.default_rng(min_run)
    for n in (0, 1, 2, 7, 40):
        sig = [tuple(int(v) for v in 2 ** rng.integers(0, 3, 3))
               for _ in range(n)]
        sig = [s for s in sig for _ in range(int(rng.integers(1, 4)))]
        assert tsched.group_runs(sig, min_run) == jsched.group_runs(
            sig, min_run)


@pytest.mark.parametrize("case", ["cover", "depths", "disjoint",
                                  "compression", "waves"])
def test_table_properties(case):
    """The JAX package's table tests, carried over (tests/test_segmented.
    py:56 cover, tests/test_superlevel.py:25-60 depths, disjoint members,
    compression), and the waves: every update once, a destination at
    most once a wave, in member order."""
    if case == "cover":
        h = pt.init(tm.poisson2d(10), pt.InitOptions(
            nb=8, dtype="r64", ordering="mindeg", device="cpu"))
        nt = h.blocked.num_tiles
        seen = np.concatenate([s[0] for s in
                               h.schedule.segmented_tables(nt)])
        np.testing.assert_array_equal(
            seen[seen != nt], [lev.diag for lev in h.schedule.levels])
        return
    h = pt.init(tm.smallworld(24 if case == "compression" else 20),
                pt.InitOptions(nb=NB, dtype="r64", ordering="nd",
                               device="cpu"))
    s = h.schedule
    if case == "depths":
        depth = s.block_depths()
        for lev in s.levels:
            assert all(depth[j] < depth[lev.k] for j in lev.ucolrows)
            assert all(depth[lev.k] < depth[i] for i in lev.lrows)
    elif case == "disjoint":
        for group in s.superlevels():
            touched = set()
            for k in group:
                lev = s.levels[k]
                mine = {lev.diag} | set(lev.lpanel) | set(lev.upanel)
                assert not mine & touched
                touched |= mine
            for k in group:
                assert not set(s.levels[k].upd_dst) & touched
    elif case == "compression":
        assert len(s.superlevels()) < 0.7 * s.block_length
    else:
        nt = h.blocked.num_tiles
        shared = False
        for seg in s.superfused_wave_tables(nt, gmax=s.block_length):
            lev, _, _, _, _, _, dst, ul, uu = seg
            for t in range(len(lev)):
                mem = lev[t][lev[t] != s.block_length]
                want = np.concatenate([s.levels[k].upd_dst for k in mem])
                got = []
                for w in range(dst.shape[1]):
                    d = dst[t, w][dst[t, w] != nt]
                    assert len(np.unique(d)) == len(d)
                    got.append(d)
                np.testing.assert_array_equal(np.sort(np.concatenate(got)),
                                              np.sort(want))
                shared |= len(np.unique(want)) < len(want)
                # a destination's occurrences go to waves 0, 1, ... in
                # member order
                for dval in np.unique(want):
                    hits = [w for w, d in enumerate(got) if dval in d]
                    assert hits == list(range(len(hits)))
        assert shared, "no super-level shares a destination"


# ---- the engines against the JAX package and the fused engine -------

@pytest.mark.parametrize("dtype", ["r32", "r64"])
@pytest.mark.parametrize("name", ["smallworld20_nd", "smallworld10_rcm"])
def test_superfused_matches_jax_and_fused(name, dtype, jax_factors):
    """One diagonal step a super-level; the JAX engine's factors and the
    port's fused ones (on rcm, one member a super-level, fused's bits)."""
    hp, _ = _pair(name, dtype)
    nt = hp.blocked.num_tiles
    fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                       dispatch="superfused")
    got = fac.factorize()
    assert fac.perf.kernels["engine"] == "superfused"
    assert len(fac.supers.diag_ids) == len(hp.schedule.superlevels())
    want = jax_factors(name, dtype, "superfused")
    np.testing.assert_allclose(got[:nt].numpy(), want[:nt], **TOL[dtype])
    fused = _factor(hp, "fused")
    np.testing.assert_allclose(got[:nt].numpy(), fused[:nt].numpy(),
                               **TOL[dtype])
    if name.endswith("rcm"):
        assert torch.equal(got, fused)


@pytest.mark.parametrize("name", ["poisson2d12_mindeg", "smallworld12_nd"])
def test_segmented_matches_jax_and_fused(name, jax_factors):
    """The JAX test's case (one segment) and one of 2 segments."""
    hp, _ = _pair(name)
    nt = hp.blocked.num_tiles
    fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                       dispatch="segmented")
    got = fac.factorize()
    assert fac.perf.kernels["engine"] == "fused"
    np.testing.assert_allclose(got[:nt].numpy(),
                               jax_factors(name, "r64", "segmented")[:nt],
                               **SEG_TOL)
    assert torch.equal(got, _factor(hp, "fused"))


def test_segmented_matches_levels_unsymmetric():
    """tests/test_segmented.py:34's case: segmented against levels."""
    h = pt.init(tm.random_unsymmetric(200, 0.03, seed=5), pt.InitOptions(
        nb=32, dtype="r64", ordering="mindeg", device="cpu"))
    nt = h.blocked.num_tiles
    np.testing.assert_allclose(_factor(h, "segmented")[:nt].numpy(),
                               _factor(h, "levels")[:nt].numpy(),
                               rtol=1e-12, atol=1e-12)


def test_superfused_end_to_end_residual():
    """||L(U 1) - A 1|| / ||A 1|| of the gathered factors, r64 nd."""
    h = pt.init(tm.smallworld(22), pt.InitOptions(
        nb=NB, dtype="r64", ordering="nd", device="cpu"))
    tiles = _factor(h, "superfused")
    lmat, umat = gather_factor(h.blocked, tiles.numpy())
    assert factorization_residual(h.reordering.reordered.to_scipy(), lmat,
                                  umat) < 1e-12


@pytest.mark.parametrize("dtype", ["cr32", "cr64"])
def test_superfused_native_complex(dtype, jax_factors):
    """Native complex tiles on the torch backend (kernels_xla's batched
    diagonal step) against the JAX package's native superfused engine
    (its diagonal step vmapped over the group) and the port's fused."""
    name = "poisson2d10_complex_nd"
    h, _ = _pair(name, dtype)
    fac = LUFactorizer(h.blocked, h.schedule, device="cpu",
                       dispatch="superfused")
    got = fac.factorize()
    assert got.dtype == {"cr32": torch.complex64,
                         "cr64": torch.complex128}[dtype]
    assert fac.backend.name == "torch"
    assert len(h.schedule.superlevels()) < h.schedule.block_length
    nt = h.blocked.num_tiles
    want = jax_factors(name, dtype, "superfused")
    assert want.dtype == got.numpy().dtype
    np.testing.assert_allclose(got[:nt].numpy(), want[:nt], **TOL[dtype])
    np.testing.assert_allclose(got[:nt].numpy(),
                               _factor(h, "fused")[:nt].numpy(),
                               **TOL[dtype])


@pytest.mark.parametrize("nb,gen,arg", [(16, "smallworld", 20),
                                        (288, "poisson2d", 32)])
def test_one_diagonal_step_per_superlevel(nb, gen, arg):
    """On the cuda backend (K1's plain version on the CPU, the wide twin
    above 256) one diagonal step a super-level, on the batch of its
    diagonals; the factors those of fused on the same backend."""
    h = pt.init(getattr(tm, gen)(arg), pt.InitOptions(
        nb=nb, dtype="r32", ordering="nd", device="cpu"))
    cuda = interface.get_backend("cuda")
    batches = []

    def step(a, tol):
        batches.append(tuple(a.shape))
        return cuda.diag_factor_invert(a, tol)

    counted = dataclasses.replace(cuda, diag_factor_invert=step)
    got = _factor(h, "superfused", backend=counted)
    sizes = [len(m) for m in h.schedule.superlevels()]
    assert batches == [(g, nb, nb) if g > 1 else (nb, nb) for g in sizes]
    nt = h.blocked.num_tiles
    np.testing.assert_allclose(got[:nt].numpy(),
                               _factor(h, "fused", backend="cuda")[:nt]
                               .numpy(), **TOL["r32"])


def test_same_bits_twice():
    """Two runs of one store give the same bits; panel_solve="trsm" is
    ignored, as the JAX package ignores it for these engines (their
    panels are products with the inverses)."""
    h = pt.init(tm.smallworld(20), pt.InitOptions(
        nb=NB, dtype="r32", ordering="nd", device="cpu"))
    for d in ("superfused", "segmented"):
        fac = LUFactorizer(h.blocked, h.schedule, device="cpu", dispatch=d)
        tiles = fac.factorize()
        assert torch.equal(fac.factorize(), tiles)
        assert torch.equal(_factor(h, d, panel_solve="trsm"), tiles)


def test_auto_never_picks_superfused(monkeypatch):
    """auto keeps its rule: never superfused (tests/test_superlevel.py:
    85), and fused, with its reason logged, where the JAX package takes
    segmented (a schedule whose fused_overhead exceeds 6)."""
    hp, hj = _pair("smallworld20_nd")
    for backend in ("auto", "torch"):
        fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                           backend=backend)
        assert fac.dispatch not in ("superfused", "segmented")
    assert JFactorizer(hj.blocked, hj.schedule).dispatch != "superfused"
    for mod in (tsched, jsched):
        monkeypatch.setattr(mod.Schedule, "fused_overhead", lambda _: 7.0)
    assert JFactorizer(hj.blocked, hj.schedule).dispatch == "segmented"
    engine, why = pick_engine("auto", hp.schedule, 16, backend="torch")
    assert engine == "fused" and "would take segmented" in why


@pytest.mark.parametrize("engine", ["superfused", "segmented"])
def test_handle_solves_refines_checkpoints(engine, tmp_path):
    """A handle factored by either engine solves through gstrs with the
    solve auto picks (the mega solves on inverses rebuilt from the
    factor, as for any factor without persisted ones), refines, and its
    checkpoint reloads to the same answers; the solver refuses
    "superfused" and takes "segmented" as fused."""
    a = tm.poisson2d(16)
    h = pt.init(a, pt.InitOptions(nb=NB, dtype="r32", ordering="nd",
                                  device="cpu"))
    h._factorizer = LUFactorizer(h.blocked, h.schedule, device="cpu",
                                 dispatch=engine)
    h.factor_tiles = h._factorizer.factorize()
    b = a.to_scipy() @ np.ones(a.n)
    x = pt.gstrs(h, b)
    auto = TriangularSolver(h.blocked, h.schedule, device="cpu").dispatch
    assert h._trisolver.dispatch == auto == "mega_group"
    assert h._trisolver.inv_tiles is not None
    assert residual_norm(a.to_scipy(), x, b) < 1e-10
    save_factor(h, tmp_path / "f.npz")
    h2 = load_factor(tmp_path / "f.npz", device="cpu")
    np.testing.assert_allclose(pt.gstrs(h2, b), x, rtol=1e-10, atol=1e-10)
    if engine == "superfused":
        with pytest.raises(ValueError, match="only factors"):
            TriangularSolver(h.blocked, h.schedule, device="cpu",
                             dispatch=engine)
    else:
        assert TriangularSolver(h.blocked, h.schedule, device="cpu",
                                dispatch=engine).dispatch == "fused"
