"""The nested-dissection path of the port: super-level group tables,
the plain versions of the grouped kernels (K4 mega_factorize_groups, K5
mega_solve_groups), their dispatch rule and the whole slice with
``ordering="nd"``, against the JAX package on the same inputs.

The JAX Pallas kernels run in interpret mode off the TPU, as
tests/test_mega_group.py runs them.  Tolerances: the tables are integer
structure, bit-equal; grouped f32 factors rtol/atol 2e-4, the grouped
bound of the JAX package's contract (tests/test_mega_group.py:66,140:
a group's updates are summed in another order than the chain's); f32
solves rtol 1e-4 / atol 1e-5 (tests/test_mega_group.py:188); the whole
slice as tests/test_torch_slice.py, except r32 factored tiles at the
grouped bound 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pangulu_tpu.models as jm
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as tm
from pangulu_tpu.api import InitOptions as JOpts
from pangulu_tpu.api import gstrf as jgstrf
from pangulu_tpu.api import gstrs as jgstrs
from pangulu_tpu.api import init as jinit
from pangulu_tpu.io.checkpoint import save_factor as jsave_factor
from pangulu_tpu.ops import kernels_pallas
from pangulu_tpu_torch.io import load_factor
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.schedule import (group_dst_csr, group_row_csr,
                                        group_solve_steps,
                                        group_update_lists)
from pangulu_tpu_torch.sptrsv import TriangularSolver
from pangulu_tpu_torch.utils.perf import residual_norm

GROUP_F32 = dict(rtol=2e-4, atol=2e-4)
SOLVE_F32 = dict(rtol=1e-4, atol=1e-5)
NB = 16


def _pair(gen, ordering, dtype="r32", **kw):
    """(port handle, JAX handle) after init on the same matrix."""
    hp = pt.init(getattr(tm, gen)(**kw),
                 pt.InitOptions(nb=NB, dtype=dtype, ordering=ordering,
                                device="cpu"))
    hj = jinit(getattr(jm, gen)(**kw),
               JOpts(nb=NB, dtype=dtype, ordering=ordering))
    return hp, hj


@pytest.fixture(scope="module")
def p2d_nd():
    return _pair("poisson2d", "nd", nx=12)


def _shared_dsts(t) -> bool:
    """Some group sends two updates to one destination tile."""
    return any(len(np.unique(dst)) < len(dst)
               for dst, _, _ in group_update_lists(t))


def _eq_tables(ta, tb):
    assert ta.keys() == tb.keys()
    for k in ta:
        a, b = np.asarray(ta[k]), np.asarray(tb[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("gen,kw,ordering", [
    ("poisson2d", dict(nx=12), "nd"),
    ("smallworld", dict(nx=14), "nd"),
    ("poisson2d", dict(nx=8), "rcm"),
])
def test_group_tables_bit_equal(gen, kw, ordering):
    hp, hj = _pair(gen, ordering, **kw)
    sp_, sj = hp.schedule, hj.schedule
    np.testing.assert_array_equal(sp_.block_depths(), sj.block_depths())
    assert sp_.superlevels() == sj.superlevels()
    nt = hp.blocked.num_tiles
    for kw2 in (dict(), dict(uch=8), dict(gmax=2)):
        _eq_tables(sp_.group_mega_tables(nt, **kw2),
                   sj.group_mega_tables(nt, **kw2))
    _eq_tables(sp_.group_solve_tables(nt), sj.group_solve_tables(nt))
    if ordering == "nd":
        t = sp_.group_mega_tables(nt)
        assert t["ngroups"] < sp_.block_length
        assert _shared_dsts(t), "no shared destination in this fixture"
    else:
        # a chain: every group is one level
        assert sp_.group_mega_tables(nt)["ngroups"] == sp_.block_length


@pytest.mark.parametrize("uch", [64, 8])
def test_dst_csr_lists_every_update_once(p2d_nd, uch):
    hp, _ = p2d_nd
    t = hp.schedule.group_mega_tables(hp.blocked.num_tiles, uch=uch)
    c = group_dst_csr(t)
    for g, (dst, _, _) in enumerate(group_update_lists(t)):
        lo, n = c["off"][g], c["cnt"][g]
        ents = [c["ent"][c["ptr"][d]:c["ptr"][d + 1]]
                for d in range(lo, lo + n)]
        # every update once, each under its own destination, in order
        assert sorted(np.concatenate(ents + [[]])) == list(range(len(dst)))
        for d, e in zip(range(lo, lo + n), ents):
            assert (dst[e] == c["key"][d]).all()
            assert (np.diff(e) > 0).all()
        assert len(set(c["key"][lo:lo + n])) == n


@pytest.mark.parametrize("sweep", ["l", "uc"])
def test_row_csr_lists_every_panel_tile_once(p2d_nd, sweep):
    hp, _ = p2d_nd
    t = hp.schedule.group_solve_tables(hp.blocked.num_tiles)
    tab, cnt = ((t["ltab"], t["nl_tab"]) if sweep == "l"
                else (t["uctab"], t["nuc_tab"]))
    c = group_row_csr(t, sweep)
    for g, n in enumerate(cnt):
        lo, m = c["off"][g], c["cnt"][g]
        ents = np.concatenate([c["ent"][c["ptr"][d]:c["ptr"][d + 1]]
                               for d in range(lo, lo + m)] + [[]])
        assert sorted(ents) == list(range(n))
        for d in range(lo, lo + m):
            e = c["ent"][c["ptr"][d]:c["ptr"][d + 1]]
            assert (tab[g, 1, e] == c["key"][d]).all()


def _row_updates(t, sweep):
    """Every panel entry of every group as (x row, tile id, source
    segment), from ``group_row_csr``."""
    tab = t["ltab"] if sweep == "l" else t["uctab"]
    c = group_row_csr(t, sweep)
    out = []
    for g in range(int(t["ngroups"])):
        for d in range(c["off"][g], c["off"][g] + c["cnt"][g]):
            e = c["ent"][c["ptr"][d]:c["ptr"][d + 1]]
            out += [(int(c["key"][d]), tid, k) for tid, k in zip(
                tab[g, 0, e].tolist(), t["kseg_tab"][g, tab[g, 2, e]].tolist())]
    return out


@pytest.fixture(scope="module")
def p3d_nd():
    """poisson3d(12) nb=16 nd: 26 solve groups over 25 super-levels, so
    two groups are chunks of one super-level."""
    return pt.init(tm.poisson3d(12), pt.InitOptions(
        nb=NB, dtype="r32", ordering="nd", device="cpu"))


@pytest.mark.parametrize("fixture", ["p2d_nd", "p3d_nd"])
@pytest.mark.parametrize("sweep", ["l", "uc"])
def test_solve_steps_list_every_row_and_member_once(request, fixture,
                                                    sweep):
    """The CUDA K5's step tables: every member of every group is one
    inverse item, every panel entry of every group sits once under its
    row, each step has one item a segment, and the offsets rise.  The
    schedule takes one step a super-level (and one more): chunks of one
    super-level, as in poisson3d(12), share their steps."""
    hp = request.getfixturevalue(fixture)
    hp = hp[0] if fixture == "p2d_nd" else hp
    bl = hp.schedule.block_length
    t = hp.schedule.group_solve_tables(hp.blocked.num_tiles)
    s = group_solve_steps(t, sweep, bl)
    step, item, ent = s["step"], s["item"], s["ent"]
    assert step[0].tolist() == [0, 0]
    assert (np.diff(step[:, 0]) > 0).all() and (np.diff(step[:, 1]) >= 0).all()
    assert step[-1].tolist() == [len(item), len(ent)]
    assert (item[:, 2] <= item[:, 3]).all()
    assert (item[1:, 2] == item[:-1, 3]).all() and item[0, 2] == 0
    assert s["width"] == np.diff(step[:, 0]).max()
    for a, b in zip(step[:-1, 0], step[1:, 0]):
        assert len(set(item[a:b, 0])) == b - a
    assert sorted(item[item[:, 1] == 1, 0]) == list(range(bl))
    got = [(int(k), tid, src) for k, _, e0, e1 in item
           for tid, src in ent[e0:e1].tolist()]
    assert sorted(got) == sorted(_row_updates(t, sweep))
    ng, nsl = int(t["ngroups"]), len(hp.schedule.superlevels())
    assert nsl < ng or fixture == "p2d_nd"
    assert len(step) - 1 <= nsl + 1


def _walk_steps(x, tiles, invs, t, bl):
    """The CUDA K5's schedule run in numpy: per sweep, each step's items
    as the kernel computes them, with what each item reads and writes
    recorded.  No item reads or writes a value that another item of its
    step writes, and every level's segment of the sweep's destination is
    written once (the destination starts as NaN: a read of an unwritten
    value would show).  Returns the solution."""
    bufs = {"x": x.copy(), "y": np.full_like(x, np.nan)}
    for slot, (src, dst), sweep in ((0, ("x", "y"), "l"),
                                    (1, ("y", "x"), "uc")):
        s = group_solve_steps(t, sweep, bl)
        written = []
        for a, b in zip(s["step"][:-1, 0], s["step"][1:, 0]):
            reads, writes = [], []
            for k, inv, e0, e1 in s["item"][a:b]:
                seg = (dst if inv else src, k)
                reads.append({(src, k)} | {(dst, int(kk)) for _, kk
                                           in s["ent"][e0:e1]})
                writes.append(seg)
                tid, kk = s["ent"][e0:e1].T
                v = bufs[src][:, k] - np.einsum(
                    "tij,rtj->ri", tiles[tid], bufs[dst][:, kk])
                if inv:
                    v = np.einsum("ij,rj->ri", invs[k, slot], v)
                bufs[seg[0]][:, k] = v
            assert len(set(writes)) == len(writes)
            for i, r in enumerate(reads):
                assert not (r & (set(writes) - {writes[i]}))
            written += [w for w in writes if w[0] == dst]
        assert sorted(k for _, k in written) == list(range(bl))
    assert np.array_equal(bufs["x"][:, bl], x[:, bl])
    return bufs["x"]


@pytest.mark.parametrize("dtype", ["r32", "r64"])
@pytest.mark.parametrize("gen,kw", [("poisson2d", dict(nx=12)),
                                    ("poisson3d", dict(nx=12))])
def test_solve_steps_walk_matches_plain_and_pallas(gen, kw, dtype):
    """The step schedule of the CUDA K5, walked on the host, solves as
    the plain version and the JAX Pallas K5 (interpret mode) do, on the
    same factors and right-hand sides."""
    hp, hj = _pair(gen, "nd", dtype=dtype, **kw)
    nt, bl = hp.blocked.num_tiles, hp.schedule.block_length
    t = hp.schedule.group_solve_tables(nt)
    fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu")
    tiles, invs = fac.factorize(), fac.inv_tiles
    rng = np.random.default_rng(bl)
    x = np.zeros((2, bl + 1, NB), tiles.numpy().dtype)
    x[:, :bl] = rng.standard_normal((2, bl, NB))
    x[:, bl] = 7.0     # the scratch segment must come back untouched
    walked = _walk_steps(x, tiles.numpy(), invs.numpy(), t, bl)
    plain = kt.mega_solve_groups(
        torch.from_numpy(x), tiles, invs, kt.KernelTables.build(t, "cpu"),
        nb=NB, bl=bl).numpy()
    tj = hj.schedule.group_solve_tables(nt)
    pallas = np.asarray(kernels_pallas.mega_solve_groups(
        jnp.asarray(x), jnp.asarray(tiles.numpy()),
        jnp.asarray(invs.numpy()),
        *(jnp.asarray(tj[k]) for k in ("nl_tab", "nuc_tab", "kseg_tab",
                                       "ltab", "uctab")),
        nb=NB, bl=bl, ngr=tj["ngroups"], gmax=tj["gmax"], npan=tj["row_w"]))
    tol = SOLVE_F32 if dtype == "r32" else dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(walked, plain, **tol)
    np.testing.assert_allclose(walked[:, :bl], pallas[:, :bl], **tol)


def _jax_group_factorize(hj, uch):
    t = {k: (v if isinstance(v, int) else jnp.asarray(v))
         for k, v in hj.schedule.group_mega_tables(
             hj.blocked.num_tiles, uch=uch, gmax=16).items()}
    return kernels_pallas.mega_factorize_groups(
        hj.blocked.device_tiles(), t["gs_tab"], t["nup_tab"],
        t["gdiag_tab"], t["glev_tab"], t["gloff_tab"], t["guoff_tab"],
        t["lid_tab"], t["uid_tab"], t["udst_tab"], t["udl_tab"],
        t["udu_tab"], nb=NB, tol=1e-8, ng=t["ngroups"], gmax=t["gmax"],
        pch=t["pch"], uch=t["uch"], bl=hj.schedule.block_length)


def _port_group_factorize(hp, uch):
    t = kt.KernelTables.build(
        hp.schedule.group_mega_tables(hp.blocked.num_tiles, uch=uch),
        "cpu")
    return kt.mega_factorize_groups(
        hp.blocked.device_tiles("cpu"), t, nb=NB, tol=1e-8,
        bl=hp.schedule.block_length)


@pytest.mark.parametrize("uch", [kt.MEGA_UCH, 8])
def test_mega_factorize_groups_vs_pallas(p2d_nd, uch):
    """poisson2d(12) nb=16 nd; uch=8 splits groups into several update
    chunks, with the same destination in more than one chunk."""
    hp, hj = p2d_nd
    nt = hp.blocked.num_tiles
    if uch == 8:
        t = hp.schedule.group_mega_tables(nt, uch=8)
        assert t["nup_tab"].max() > 8
    tj, ij = _jax_group_factorize(hj, uch)
    tp, ip = _port_group_factorize(hp, uch)
    np.testing.assert_allclose(tp[:nt].numpy(), np.asarray(tj)[:nt],
                               **GROUP_F32)
    np.testing.assert_allclose(ip.numpy(), np.asarray(ij), **GROUP_F32)


@pytest.mark.parametrize("nrhs", [1, 3])
def test_mega_solve_groups_vs_pallas(p2d_nd, nrhs):
    """Both solves take the same factors (the port's grouped ones) and
    the same right-hand sides."""
    hp, hj = p2d_nd
    nt, bl = hp.blocked.num_tiles, hp.schedule.block_length
    tiles, invs = _port_group_factorize(hp, kt.MEGA_UCH)
    rng = np.random.default_rng(nrhs)
    x = np.zeros((nrhs, bl + 1, NB), np.float32)
    x[:, :bl].reshape(nrhs, -1)[:, :hp.blocked.n] = rng.standard_normal(
        (nrhs, hp.blocked.n))
    t = hj.schedule.group_solve_tables(nt)
    ref = kernels_pallas.mega_solve_groups(
        jnp.asarray(x), jnp.asarray(tiles.numpy()),
        jnp.asarray(invs.numpy()),
        *(jnp.asarray(t[k]) for k in ("nl_tab", "nuc_tab", "kseg_tab",
                                      "ltab", "uctab")),
        nb=NB, bl=bl, ngr=t["ngroups"], gmax=t["gmax"], npan=t["row_w"])
    tables = kt.KernelTables.build(hp.schedule.group_solve_tables(nt),
                                   "cpu")
    got = kt.mega_solve_groups(torch.from_numpy(x), tiles, invs, tables,
                               nb=NB, bl=bl)
    np.testing.assert_allclose(got[:, :bl].numpy(),
                               np.asarray(ref)[:, :bl], **SOLVE_F32)
    # the scratch segment is left as it was
    assert torch.equal(got[:, bl], torch.from_numpy(x[:, bl]))


def test_dispatch_rules(p2d_nd):
    """nd picks the grouped engines, rcm the chain, as
    test_group_auto_dispatch_rule and test_group_solve_worthwhile_rule
    hold the JAX package's rule."""
    hp, _ = p2d_nd
    fac = LUFactorizer(hp.blocked, hp.schedule, device="cpu")
    assert fac._group_worthwhile() and fac.dispatch == "mega_group"
    ts = TriangularSolver(hp.blocked, hp.schedule, device="cpu")
    assert ts._solve_group_worthwhile() and ts.dispatch == "mega_group"
    for nx in (8, 12):
        hr = pt.init(tm.poisson2d(nx), pt.InitOptions(
            nb=NB, dtype="r32", ordering="rcm", device="cpu"))
        fr = LUFactorizer(hr.blocked, hr.schedule, device="cpu")
        assert not fr._group_worthwhile() and fr.dispatch == "mega"
        tr = TriangularSolver(hr.blocked, hr.schedule, device="cpu")
        assert not tr._solve_group_worthwhile() and tr.dispatch == "mega"
    forced = LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                          dispatch="mega")
    assert forced.dispatch == "mega"
    # the JAX package's double-float engines are not ported (TPU
    # artefacts: the card has float64)
    with pytest.raises(ValueError, match="dispatch"):
        LUFactorizer(hp.blocked, hp.schedule, device="cpu", dispatch="dd")


def test_chain_and_groups_agree(p2d_nd):
    """The two engines on one nd schedule give the same factors, and
    either's inverses serve either solve."""
    hp, _ = p2d_nd
    facs = {d: LUFactorizer(hp.blocked, hp.schedule, device="cpu",
                            dispatch=d) for d in ("mega", "mega_group")}
    out = {d: (f.factorize(), f.inv_tiles) for d, f in facs.items()}
    np.testing.assert_allclose(out["mega_group"][0].numpy(),
                               out["mega"][0].numpy(), **GROUP_F32)
    np.testing.assert_allclose(out["mega_group"][1].numpy(),
                               out["mega"][1].numpy(), **GROUP_F32)
    b = np.arange(1.0, hp.blocked.n + 1, dtype=np.float32)
    tiles, invs = out["mega_group"]
    x = {d: TriangularSolver(hp.blocked, hp.schedule, device="cpu",
                             inv_tiles=invs, dispatch=d).solve(tiles, b)
         for d in ("mega", "mega_group")}
    np.testing.assert_allclose(x["mega_group"], x["mega"], **SOLVE_F32)


@pytest.mark.parametrize("dtype,tol", [("r32", 1e-10), ("r64", 1e-12)])
def test_nd_slice_matches_jax(dtype, tol):
    ta, ja = tm.poisson2d(12), jm.poisson2d(12)
    b = ta.to_scipy() @ np.arange(1.0, ta.n + 1)
    hp = pt.init(ta, pt.InitOptions(nb=NB, dtype=dtype, ordering="nd",
                                    device="cpu", check=True))
    pt.gstrf(hp)
    xp = pt.gstrs(hp, b)
    assert hp.perf.kernels["engine"] == "mega_group"
    assert hp.perf.kernels["solve_engine"] == "mega_group"
    hj = jinit(ja, JOpts(nb=NB, dtype=dtype, ordering="nd", check=True))
    jgstrf(hj)
    xj = jgstrs(hj, b)
    nt = hp.blocked.num_tiles
    ftol = GROUP_F32 if dtype == "r32" else dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(hp.factor_tiles[:nt].numpy(),
                               np.asarray(hj.factor_tiles)[:nt], **ftol)
    assert hp.perf.kernels["gstrf_residual"] < (1e-5 if dtype == "r32"
                                                else 1e-12)
    assert residual_norm(ta.to_scipy(), xp, b) < tol
    np.testing.assert_allclose(xp, xj, rtol=tol * 10, atol=0)
    B = np.stack([b, -2 * b, b + 1], axis=1)
    X = pt.gstrs(hp, B)
    for j in range(3):
        assert residual_norm(ta.to_scipy(), X[:, j], B[:, j]) < tol


@pytest.mark.parametrize("dtype,tol", [("r32", 1e-10), ("r64", 1e-12)])
def test_jax_nd_factor_solved_by_port(dtype, tol, tmp_path):
    """JAX save_factor of an nd factor -> port load_factor -> gstrs
    through the grouped solve, with inverses from _ensure_inverses."""
    ja = jm.poisson2d(12)
    hj = jinit(ja, JOpts(nb=NB, dtype=dtype, ordering="nd"))
    jgstrf(hj)
    path = tmp_path / "f.npz"
    jsave_factor(hj, path)
    b = ja.to_scipy() @ np.linspace(-1.0, 2.0, ja.n)
    xj = jgstrs(hj, b)
    hp = load_factor(path, device="cpu")
    xp = pt.gstrs(hp, b)
    assert hp._trisolver.dispatch == "mega_group"
    assert residual_norm(ja.to_scipy(), xp, b) < tol
    np.testing.assert_allclose(xp, xj, rtol=tol * 10, atol=tol)
