"""K2's chain-ahead (``PANGULU_TPU_SUPERLEVEL=1``) and the JAX package's
last engine switches in the port, against the JAX package on the same
inputs, on the CPU.

- Chain-ahead tables (``Schedule.mega_tables(superlevel=True)``: the
  levels in dependency-depth order, ``flag_tab``, ``lev_tab``) are
  integer structure: bit-equal to the JAX package's.
- The depth-ordered factor sums its Schur updates in another order than
  the level order, so it is held to the JAX fused engine at the JAX
  test's 2e-4 (tests/test_mega.py:296-298); the solve off its inverse
  store (slots by original level) to the port's level solve at rtol
  1e-4 (tests/test_mega.py:309).
- The switch is taken only by ``dispatch="mega"`` on float32 working
  values where the schedule has levels of equal depth, and by the panel
  driver; elsewhere the tables are the original ones.
- ``PANGULU_TPU_GROUP``, ``PANGULU_TPU_SOLVE_GROUP``, ``dispatch="dd*"``
  and ``InitOptions(nthread=, compile_cache=)`` behave as the JAX
  package's.

The run ahead on the card's second stream is checked there
(tests/test_torch_gpu.py): the same tables with the side stream on and
off give the same bits.
"""

import contextlib
import logging

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pangulu_tpu.models as jm
import pangulu_tpu.outofcore as joc
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as tm
from pangulu_tpu.api import InitOptions as JOpts
from pangulu_tpu.api import init as jinit
from pangulu_tpu.numeric import LUFactorizer as JFactorizer
from pangulu_tpu.ops.interface import get_backend
from pangulu_tpu.sparse import CscMatrix as JCsc
from pangulu_tpu.sptrsv import TriangularSolver as JSolver
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.outofcore import PanelLU
from pangulu_tpu_torch.schedule import check_ahead
from pangulu_tpu_torch.sparse import CscMatrix as TCsc
from pangulu_tpu_torch.sptrsv import TriangularSolver

ENV = "PANGULU_TPU_SUPERLEVEL"
GROUP_F32 = dict(rtol=2e-4, atol=2e-4)
SOLVE_F32 = dict(rtol=1e-4, atol=1e-4)
NB = 16


def _decoupled(pkg):
    """tests/test_mega.py:256-268: two independent nb-aligned
    subsystems, so that block columns of equal depth are certain."""
    a1 = pkg.poisson2d(8).to_scipy()
    a2 = pkg.random_unsymmetric(64, 0.08, seed=4).to_scipy()
    csc = JCsc if pkg is jm else TCsc
    return csc.from_scipy(sp.csc_matrix(sp.block_diag([a1, a2])))


CASES = {
    "poisson2d12_nd": (lambda pkg: pkg.poisson2d(12), "nd"),
    "decoupled_natural": (_decoupled, "natural"),
    "smallworld30_nd": (lambda pkg: pkg.smallworld(30), "nd"),
}


def _pair(case, dtype="r32"):
    gen, ordering = CASES[case]
    hp = pt.init(gen(tm), pt.InitOptions(nb=NB, dtype=dtype,
                                         ordering=ordering, device="cpu"))
    hj = jinit(gen(jm), JOpts(nb=NB, dtype=dtype, ordering=ordering))
    return hp, hj


@contextlib.contextmanager
def _logged(caplog):
    """The port's log at INFO into caplog (its logger does not
    propagate)."""
    log = logging.getLogger("pangulu_tpu_torch")
    level = log.level
    log.addHandler(caplog.handler)
    log.setLevel(logging.INFO)
    try:
        yield
    finally:
        log.removeHandler(caplog.handler)
        log.setLevel(level)


def _eq_tables(ta, tb):
    assert ta.keys() == tb.keys()
    for k in ta:
        a, b = np.asarray(ta[k]), np.asarray(tb[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_superlevel_tables_bit_equal_jax(case):
    hp, hj = _pair(case)
    nt = hp.blocked.num_tiles
    uch = kt.mega_uch(NB)
    tp = hp.schedule.mega_tables(nt, uch=uch, superlevel=True)
    tj = hj.schedule.mega_tables(nt, uch=uch, superlevel=True)
    _eq_tables(tp, tj)
    assert tp["flag_tab"].sum() > 0, "no level runs ahead"
    # the reordering is a permutation of the original tables
    plain = hp.schedule.mega_tables(nt, uch=uch)
    for k in ("diag_tab", "nl_tab", "lid_tab", "udst_tab"):
        assert np.array_equal(tp[k], plain[k][tp["lev_tab"]])


def test_check_ahead_refuses_a_racing_table():
    """A flagged level whose diagonal the level before it updates would
    race on the card: the host check refuses it."""
    hp, _ = _pair("poisson2d12_nd")
    t = hp.schedule.mega_tables(hp.blocked.num_tiles, superlevel=True)
    check_ahead(t)
    k = int(np.flatnonzero(t["flag_tab"])[0])
    bad = dict(t, lid_tab=t["lid_tab"].copy(), nl_tab=t["nl_tab"].copy())
    bad["lid_tab"][k - 1, bad["nl_tab"][k - 1]] = t["diag_tab"][k]
    bad["nl_tab"][k - 1] += 1
    with pytest.raises(ValueError, match="runs beside its diagonal step"):
        check_ahead(bad)


@pytest.fixture(scope="module")
def chain_ahead_runs():
    """Per case, the port's chain-ahead factorization (tiles, inverses,
    its factorizer) and the JAX fused engine's tiles, made once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ENV, "1")
        for case in ("poisson2d12_nd", "decoupled_natural"):
            hp, hj = _pair(case)
            fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                               dispatch="mega")
            tiles = fac.factorize()
            fused = JFactorizer(hj.blocked, hj.schedule,
                                backend=get_backend("jax"),
                                dispatch="fused")
            out[case] = hp, fac, tiles, np.asarray(fused.factorize())
    return out


@pytest.mark.parametrize("case", ["poisson2d12_nd", "decoupled_natural"])
def test_chain_ahead_factor_matches_jax_fused(case, chain_ahead_runs):
    hp, fac, tiles, ref = chain_ahead_runs[case]
    assert "flag_tab" in fac.tables.host
    assert fac.tables.host["flag_tab"].sum() > 0
    nt = hp.blocked.num_tiles
    np.testing.assert_allclose(tiles[:nt].numpy(), ref[:nt], **GROUP_F32)


@pytest.mark.parametrize("case", ["poisson2d12_nd", "decoupled_natural"])
def test_chain_ahead_inverses_serve_the_solve(case, chain_ahead_runs):
    """Inverses sit at the original level ids: the whole-solve engine
    reads them as it reads the chain's, and agrees with the level solve
    (no inverses) on the same factor."""
    hp, fac, tiles, _ = chain_ahead_runs[case]
    a = hp.reordering.reordered.to_scipy()
    b = (a @ np.ones(a.shape[0])).astype(np.float32)
    x = TriangularSolver(hp.blocked, hp.schedule, device="cpu",
                         inv_tiles=fac.inv_tiles,
                         dispatch="mega").solve(tiles, b)
    x_ref = TriangularSolver(hp.blocked, hp.schedule, device="cpu",
                             dispatch="fused").solve(tiles, b)
    np.testing.assert_allclose(x, x_ref, **SOLVE_F32)
    # and they are the inverses of the factored diagonal tiles
    for k, lev in enumerate(hp.schedule.levels):
        f = tiles[lev.diag]
        lower = torch.tril(f, -1) + torch.eye(NB)
        upper = torch.triu(f)
        np.testing.assert_allclose(
            (fac.inv_tiles[k, 0] @ lower).numpy(), np.eye(NB), atol=1e-3)
        np.testing.assert_allclose(
            (upper @ fac.inv_tiles[k, 1]).numpy(), np.eye(NB), atol=1e-3)


@pytest.mark.parametrize("ordering,env,expect", [
    ("nd", None, False),        # the switch unset
    ("rcm", "1", False),        # a chain: no level of equal depth
    ("nd", "1", True),
    ("nd", "0", False),
])
def test_switch_takes_chain_ahead_only_where_asked(ordering, env, expect,
                                                   monkeypatch):
    if env is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, env)
    h = pt.init(tm.poisson2d(12), pt.InitOptions(
        nb=NB, dtype="r32", ordering=ordering, device="cpu"))
    fac = LUFactorizer(h.blocked, h.schedule, device="cpu", dispatch="mega")
    assert ("flag_tab" in fac.tables.host) is expect
    if not expect:
        _eq_tables(fac.tables.host, h.schedule.mega_tables(
            h.blocked.num_tiles, uch=kt.mega_uch(NB)))
    if ordering == "rcm":
        # depth order on a chain is the level order, nothing flagged
        t = h.schedule.mega_tables(h.blocked.num_tiles, superlevel=True)
        assert not t["flag_tab"].any()
        assert np.array_equal(t["lev_tab"], np.arange(len(t["lev_tab"])))


def test_float64_does_not_take_it(monkeypatch, caplog):
    """The JAX package's chain-ahead is in its f32 K2 alone: r64 logs
    the switch and keeps the level order; mega_group ignores it."""
    monkeypatch.setenv(ENV, "1")
    h = pt.init(tm.poisson2d(12), pt.InitOptions(
        nb=NB, dtype="r64", ordering="nd", device="cpu"))
    with _logged(caplog):
        fac = LUFactorizer(h.blocked, h.schedule, device="cpu",
                           dispatch="mega")
    assert "flag_tab" not in fac.tables.host
    assert "PANGULU_TPU_SUPERLEVEL=1 not taken" in caplog.text
    h32 = pt.init(tm.poisson2d(12), pt.InitOptions(
        nb=NB, dtype="r32", ordering="nd", device="cpu"))
    grp = LUFactorizer(h32.blocked, h32.schedule, device="cpu",
                       dispatch="mega_group")
    assert "flag_tab" not in grp.tables.host


def test_panel_tables_match_jax(monkeypatch):
    """Each panel's sub-schedule tables under the switch are the JAX
    package's (pangulu_tpu/outofcore.py:343-355) built on the same
    cross: the JAX driver pads its cross to a gather slab and puts the
    scratch tile after the padding, the port right after the cross, so
    both are built here with the port's scratch id.  The panels factored
    in depth order agree with the level order's within 2e-4, their
    inverses as well."""
    monkeypatch.setenv(ENV, "1")
    case = "poisson2d12_nd"
    hp, hj = _pair(case)
    w = 8
    pp = PanelLU(hp.blocked, hp.schedule, hp.reordering.reordered,
                 device="cpu", panel_width=w)
    jp = joc.PanelLU(hj.blocked, hj.schedule, hj.reordering.reordered,
                     backend=get_backend("jax"), panel_width=w)
    pp.factorize()
    flagged = 0
    for c0, c1 in pp.panel_cols:
        cross = jp._cross_ids(c0, c1)
        local_of = np.full(hj.blocked.num_tiles + 1, -1, dtype=np.int64)
        local_of[cross] = np.arange(len(cross))
        sub, _ = jp._sub_schedule(c0, c1, local_of)
        tj = sub.mega_tables(len(cross), uch=kt.mega_uch(NB),
                             superlevel=True)
        mine = pp._pass(c0, c1)
        assert np.array_equal(mine.cross, cross)
        _eq_tables(mine.tables.host, tj)
        flagged += int(tj["flag_tab"].sum())
    assert len(pp.panel_cols) > 1 and flagged > 0
    monkeypatch.delenv(ENV)
    ref = PanelLU(hp.blocked, hp.schedule, hp.reordering.reordered,
                  device="cpu", panel_width=w)
    ref.factorize()
    nt = hp.blocked.num_tiles
    np.testing.assert_allclose(pp.store.to_dense()[:nt],
                               ref.store.to_dense()[:nt], **GROUP_F32)
    np.testing.assert_allclose(pp.inv_tiles.numpy(), ref.inv_tiles.numpy(),
                               **GROUP_F32)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["poisson2d12_nd", "decoupled_natural"])
def test_chain_ahead_matches_jax_pallas_superlevel(case, monkeypatch):
    """The JAX Pallas K2 with its chain-ahead (interpret mode off the
    TPU, as tests/test_mega.py:270-310 runs it) against the port's, on
    the same depth-ordered tables: factors and inverses by level."""
    monkeypatch.setenv(ENV, "1")
    hp, hj = _pair(case)
    bk = get_backend("pallas", nb=NB, dtype=hj.blocked.dtype)
    jf = JFactorizer(hj.blocked, hj.schedule, backend=bk, dispatch="mega")
    assert "flag_tab" in jf._mega
    tj = np.asarray(jf.factorize())
    fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                       dispatch="mega")
    _eq_tables({k: v for k, v in fac.tables.host.items()},
               {k: (v if isinstance(v, int) else np.asarray(v))
                for k, v in jf._mega.items()})
    tiles = fac.factorize()
    nt = hp.blocked.num_tiles
    np.testing.assert_allclose(tiles[:nt].numpy(), tj[:nt], **GROUP_F32)
    np.testing.assert_allclose(fac.inv_tiles.numpy(),
                               np.asarray(jf.inv_tiles), **GROUP_F32)


# ---- the JAX package's engine switches ---------------------------------

@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("ordering", ["nd", "rcm"])
def test_group_switches_match_jax(ordering, env, monkeypatch):
    """PANGULU_TPU_GROUP decides the factorization's group rule and
    PANGULU_TPU_SOLVE_GROUP the solve's, as in the JAX package
    (pangulu_tpu/numeric.py:484-495, pangulu_tpu/sptrsv.py:370-379);
    each leaves the other alone."""
    gen = CASES["poisson2d12_nd"][0]
    hp = pt.init(gen(tm), pt.InitOptions(nb=NB, dtype="r32",
                                         ordering=ordering, device="cpu"))
    hj = jinit(gen(jm), JOpts(nb=NB, dtype="r32", ordering=ordering))
    for var in ("PANGULU_TPU_GROUP", "PANGULU_TPU_SOLVE_GROUP"):
        monkeypatch.delenv(var, raising=False)
    rule = (LUFactorizer(hp.blocked, hp.schedule, device="cpu")
            ._group_worthwhile())
    for var, other in (("PANGULU_TPU_GROUP", "PANGULU_TPU_SOLVE_GROUP"),
                       ("PANGULU_TPU_SOLVE_GROUP", "PANGULU_TPU_GROUP")):
        if env is not None:
            monkeypatch.setenv(var, env)
        fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu")
        ts = TriangularSolver(hp.blocked, hp.schedule, device="cpu")
        jf = JFactorizer(hj.blocked, hj.schedule, dispatch="fused")
        js = JSolver(hj.blocked, hj.schedule)
        assert fac._group_worthwhile() == jf._group_worthwhile()
        assert ts._solve_group_worthwhile() == js._solve_group_worthwhile()
        want = {var: rule if env is None else env == "1", other: rule}
        assert (fac.dispatch == "mega_group") is want["PANGULU_TPU_GROUP"]
        assert (ts.dispatch == "mega_group") is want[
            "PANGULU_TPU_SOLVE_GROUP"]
        monkeypatch.delenv(var, raising=False)


def test_dd_dispatches_on_float64(caplog):
    """dispatch="dd_mega" | "dd_group" | "dd" (the JAX package's
    double-float engines, pangulu_tpu/numeric.py:385-404) run as mega /
    superfused / fused on a float64 store, with the reason logged: the
    same bits as those engines, within 1e-12 of the JAX fused engine.
    On float32 they raise; the solver takes dd_mega and dd, and refuses
    dd_group (superfused only factors)."""
    hp, hj = _pair("poisson2d12_nd", dtype="r64")
    ref = np.asarray(JFactorizer(hj.blocked, hj.schedule,
                                 backend=get_backend("jax"),
                                 dispatch="fused").factorize())
    nt = hp.blocked.num_tiles
    for dd, engine in (("dd_mega", "mega"), ("dd_group", "superfused"),
                       ("dd", "fused")):
        caplog.clear()
        with _logged(caplog):
            fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                               dispatch=dd)
        assert fac.dispatch == engine
        assert f"{dd} asked for" in caplog.text
        tiles = fac.factorize()
        same = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                            dispatch=engine).factorize()
        assert torch.equal(tiles, same)
        np.testing.assert_allclose(tiles[:nt].numpy(), ref[:nt],
                                   rtol=1e-12, atol=1e-12)
    assert TriangularSolver(hp.blocked, hp.schedule, device="cpu",
                            dispatch="dd_mega").dispatch == "mega"
    assert TriangularSolver(hp.blocked, hp.schedule, device="cpu",
                            dispatch="dd").dispatch == "fused"
    with pytest.raises(ValueError, match="only factors"):
        TriangularSolver(hp.blocked, hp.schedule, device="cpu",
                         dispatch="dd_group")
    h32, _ = _pair("poisson2d12_nd")
    for dd in ("dd_mega", "dd_group", "dd"):
        with pytest.raises(ValueError, match="dispatch"):
            LUFactorizer(h32.blocked, h32.schedule, device="cpu",
                         dispatch=dd)


def test_init_options_parity_fields():
    """InitOptions takes the JAX package's nthread and compile_cache
    (pangulu_tpu/api.py:56,60) with its defaults; neither changes a
    result."""
    for f in ("nthread", "compile_cache"):
        assert getattr(pt.InitOptions(), f) == getattr(JOpts(), f)
    a = tm.poisson2d(8)
    b = a.to_scipy() @ np.ones(a.n)
    x = {}
    for opts in (dict(), dict(nthread=4, compile_cache=False)):
        h = pt.init(a, pt.InitOptions(nb=NB, dtype="r64", device="cpu",
                                      **opts))
        pt.gstrf(h)
        x[len(opts)] = pt.gstrs(h, b)
    assert np.array_equal(x[0], x[2])
