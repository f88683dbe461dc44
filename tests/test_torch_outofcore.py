"""The out-of-core panel driver of the port
(``pangulu_tpu_torch.outofcore.PanelLU``) on the CPU (device="cpu": the
plain versions of K2 and P6), against the JAX package's
``pangulu_tpu.outofcore.PanelLU`` with the Pallas backend in interpret
mode, as tests/test_outofcore.py runs it, on the same matrices through
both packages' init.

Tolerances, each with its source:
  * ``panel_cols`` and every out-update chunk's (l_sel, u_sel, acc_sel,
    dst_ids, capw, nacc): bit-equal (the same numpy construction; the
    JAX chunks recorded by wrapping ``_apply_out_updates`` in the test);
  * the factored store and ``inv_tiles`` against the JAX PanelLU on the
    same panels: f32 rtol/atol 1e-5 (the header of
    tests/test_torch_compressed.py: factors against JAX at f32 1e-5,
    tests/test_mega.py's);
  * a single panel against the port's CompressedLU: the same f32 1e-5,
    f64 rtol 1e-12 / atol 1e-14 (tests/test_compressed.py:48);
  * a panel split against the dense fused engine or another split:
    2e-4 (tests/test_outofcore.py:49: the sums run in another order
    across panels);
  * end to end: the r32 limits of the repo (gstrf residual < 1e-5,
    solve residual < 1e-10 after the default 2 refinement rounds, A in
    the working precision), the JAX package's solve of the saved factor
    against the port's: r32 at 1e-8 (both refined in f64 to ~1e-15),
    cr32 on a complex64 b at 1e-6 of max |x|
    (tests/test_torch_complex.py:240).
"""

import contextlib

import numpy as np
import pytest
import torch

import pangulu_tpu.api as japi
import pangulu_tpu.models as jm
import pangulu_tpu.outofcore as joc
import pangulu_tpu_torch as pt
import pangulu_tpu_torch.api as tapi
import pangulu_tpu_torch.models as tm
from pangulu_tpu.ops.interface import get_backend
from pangulu_tpu_torch.compressed import CompressedLU
from pangulu_tpu_torch.io.mmio import generated_rhs
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.outofcore import PanelLU
from pangulu_tpu_torch.testing import panel_launches, with_imaginary_parts
from pangulu_tpu_torch.utils.perf import residual_norm

TOL32 = dict(rtol=1e-5, atol=1e-5)
TOL64 = dict(rtol=1e-12, atol=1e-14)
TOL_SPLIT = dict(rtol=2e-4, atol=2e-4)

# (id, generator, kwargs, nb, panel_width (None: the block length),
#  out_chunk, PANGULU_OOC_CROSS_GB)
JAX_CASES = [
    # several panels and a remainder (tests/test_outofcore.py:27)
    ("poisson2d9_w3", "poisson2d", dict(nx=9), 8, 3, 2048, None),
    # the halving split (tests/test_outofcore.py:79), chunks of 2
    ("poisson2d16_halving_oc2", "poisson2d", dict(nx=16), 8, None, 2,
     "1e-9"),
    # an unsymmetric pattern
    ("random120_w4", "random_unsymmetric",
     dict(n=120, density=0.03, seed=5), 8, 4, 2048, None),
]
_IDS = [c[0] for c in JAX_CASES]


@contextlib.contextmanager
def _env(name, value):
    with pytest.MonkeyPatch.context() as mp:
        if value is not None:
            mp.setenv(name, value)
        yield


def _pair(gen, kw, nb, dtype="r32", ordering="rcm"):
    hp = pt.init(getattr(tm, gen)(**kw),
                 pt.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                device="cpu"))
    hj = japi.init(getattr(jm, gen)(**kw),
                   japi.InitOptions(nb=nb, dtype=dtype, ordering=ordering))
    return hp, hj


_RUNS: dict = {}


def _runs(case):
    """Both packages' PanelLU on the case, factored once per session:
    (port PanelLU, JAX PanelLU, the JAX out-update chunks as recorded,
    the reordered matrix)."""
    if case[0] in _RUNS:
        return _RUNS[case[0]]
    _, gen, kw, nb, w, out_chunk, cross_gb = case
    hp, hj = _pair(gen, kw, nb)
    w = w or hp.schedule.block_length
    rec = []
    real = joc._apply_out_updates

    def spy(values, idx, off, cap, cross, l_sel, u_sel, acc_sel, dst_ids,
            *, nb, capw, nacc):
        rec.append((np.asarray(l_sel), np.asarray(u_sel),
                    np.asarray(acc_sel), np.asarray(dst_ids), int(capw),
                    int(nacc)))
        return real(values, idx, off, cap, cross, l_sel, u_sel, acc_sel,
                    dst_ids, nb=nb, capw=capw, nacc=nacc)

    with _env("PANGULU_OOC_CROSS_GB", cross_gb), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(joc, "_apply_out_updates", spy)
        jp = joc.PanelLU(hj.blocked, hj.schedule, hj.reordering.reordered,
                         backend=get_backend("pallas", nb=nb,
                                             dtype=hj.blocked.dtype),
                         panel_width=w, out_chunk=out_chunk)
        jp.factorize()
        pp = PanelLU(hp.blocked, hp.schedule, hp.reordering.reordered,
                     device="cpu", panel_width=w, out_chunk=out_chunk)
        pp.factorize()
    _RUNS[case[0]] = pp, jp, rec, hp.reordering.reordered
    return _RUNS[case[0]]


@pytest.mark.parametrize("case", JAX_CASES, ids=_IDS)
def test_panel_cols_bit_equal_jax(case):
    """The panels the port factors are the JAX package's: the width from
    the budget, the halving against the measured cross."""
    pp, jp, _, _ = _runs(case)
    assert pp.panel_cols == jp.panel_cols
    assert pp.panel_width == jp.panel_width
    assert len(pp.panel_cols) > 1
    bl = pp.schedule.block_length
    assert pp.panel_cols[0][0] == 0 and pp.panel_cols[-1][1] == bl
    if case[-1] is not None:
        # the halving split: every cross within the 64-tile floor
        assert max(c1 - c0 for c0, c1 in pp.panel_cols) < bl
        assert all(len(pp._cross_ids(c0, c1)) <= 64 or c1 - c0 == 1
                   for c0, c1 in pp.panel_cols)


@pytest.mark.parametrize("cross_gb", [None, "1e-9", "0.5"])
@pytest.mark.parametrize("case", JAX_CASES, ids=_IDS)
def test_dense_budget_equals_jax(case, cross_gb):
    """The cross budget is the JAX package's at its default staging
    budget (the port's 4 GiB reserve is its 2 GiB spare plus 2 GiB of
    staging) on the CPU's 15 GiB, and under PANGULU_OOC_CROSS_GB."""
    pp, jp, _, _ = _runs(case)
    assert pp.store.compressed_bytes == jp.store.compressed_bytes
    with _env("PANGULU_OOC_CROSS_GB", cross_gb), \
            pytest.MonkeyPatch.context() as mp:
        mp.delenv("PANGULU_OOC_STAGE_GB", raising=False)
        if cross_gb is None:
            mp.delenv("PANGULU_OOC_CROSS_GB", raising=False)
        assert pp._dense_budget_tiles() == jp._dense_budget_tiles()


@pytest.mark.parametrize("case", JAX_CASES, ids=_IDS)
def test_out_chunks_bit_equal_jax(case):
    """Every out-update chunk's index arrays, class width and padding
    are the JAX package's, in the same order."""
    pp, _, rec, _ = _runs(case)
    mine = [(c.l_sel, c.u_sel, c.acc_sel, c.dst_ids, c.capw, c.nacc)
            for c0, c1 in pp.panel_cols for c in pp._pass(c0, c1).chunks]
    assert len(mine) == len(rec) > 0
    for m, r in zip(mine, rec):
        for a, b in zip(m[:4], r[:4]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert m[4:] == r[4:]
    if case[5] == 2:
        # chunks of 2 updates: some panel's updates take several chunks
        assert max(len(pp._pass(c0, c1).chunks)
                   for c0, c1 in pp.panel_cols) > 1


@pytest.mark.parametrize("case", JAX_CASES, ids=_IDS)
def test_factored_store_matches_jax(case):
    pp, jp, _, _ = _runs(case)
    nt = pp.blocked.num_tiles
    np.testing.assert_allclose(pp.store.to_dense()[:nt],
                               np.asarray(jp.store)[:nt], **TOL32)


@pytest.mark.parametrize("case", JAX_CASES, ids=_IDS)
def test_inverses_match_jax(case):
    """inv_tiles [bl, 2, nb, nb], by level, concatenated over the
    panels."""
    pp, jp, _, _ = _runs(case)
    got = pp.inv_tiles.numpy()
    assert got.shape == (pp.schedule.block_length, 2, pp.blocked.nb,
                         pp.blocked.nb)
    np.testing.assert_allclose(got, np.asarray(jp.inv_tiles), **TOL32)


@pytest.mark.parametrize("case", JAX_CASES, ids=_IDS)
def test_panel_store_matches_dense_fused(case):
    """tests/test_outofcore.py:40-50 for the port: the panel split
    against the port's dense engine on the same matrix, and the gstrf
    residual."""
    from pangulu_tpu_torch.blocks import gather_factor
    from pangulu_tpu_torch.utils.perf import factorization_residual

    pp, _, _, a3 = _runs(case)
    ref = LUFactorizer(pp.blocked, pp.schedule, device="cpu").factorize()
    nt = pp.blocked.num_tiles
    got = pp.store.to_dense()
    np.testing.assert_allclose(got[:nt], ref[:nt].numpy(), **TOL_SPLIT)
    lm, um = gather_factor(pp.blocked, got)
    res = factorization_residual(a3.to_scipy(), lm, um)
    assert res < 1e-5, res


SINGLE = [("poisson2d9_nb8", "poisson2d", dict(nx=9), 8),
          ("smallworld10_nb16", "smallworld", dict(nx=10, seed=2), 16)]


@pytest.mark.parametrize("dtype", ["r32", "r64"])
@pytest.mark.parametrize("case", SINGLE, ids=[c[0] for c in SINGLE])
def test_single_panel_equals_compressed(case, dtype):
    """panel_width = block_length: one cross is the whole matrix, no
    out-of-cross update; the store is CompressedLU's (the same staging
    math, tests/test_outofcore.py:62-80) and one factorization is one
    K2 call, one decompress and one compress."""
    _, gen, kw, nb = case
    h = pt.init(getattr(tm, gen)(**kw),
                pt.InitOptions(nb=nb, dtype=dtype, device="cpu"))
    bl = h.schedule.block_length
    plu = PanelLU(h.blocked, h.schedule, h.reordering.reordered,
                  device="cpu", panel_width=bl)
    st = plu.factorize()
    assert plu.panel_cols == [(0, bl)]
    assert plu._pass(0, bl).chunks == []
    clu = CompressedLU(h.blocked, h.schedule, h.reordering.reordered,
                       device="cpu")
    st2 = clu.factorize()
    tol = TOL32 if dtype == "r32" else TOL64
    np.testing.assert_allclose(st.to_dense(), st2.to_dense(), **tol)
    np.testing.assert_allclose(plu.inv_tiles.numpy(),
                               clu.inv_tiles.numpy(), **tol)
    assert panel_launches(plu, solves=2, reloads=1) == dict(
        mega_factorize=1, getrf_with_inverses=bl,
        decompress_tiles=1 + 2 * sum(
            (len(v.lpanel) > 0) + (len(v.ucolpanel) > 0)
            for v in h.schedule.levels) + 1,
        compress_tiles=1, newton_inverses=1)


def test_tiny_out_chunk_matches_dense_fused():
    """tests/test_outofcore.py:108-121 for the port: many small
    out-update chunks (destination groups split) on an irregular
    pattern, against the dense engine; two factorizations of one store
    are the same bits (the fixed-order per-destination sum)."""
    h = pt.init(tm.smallworld(12, seed=7),
                pt.InitOptions(nb=8, dtype="r32", device="cpu"))
    plu = PanelLU(h.blocked, h.schedule, h.reordering.reordered,
                  device="cpu", panel_width=3, out_chunk=2)
    v0 = plu.store.values.clone()
    first = plu.factorize().values.clone()
    chunks = [len(plu._pass(c0, c1).chunks) for c0, c1 in plu.panel_cols]
    assert max(chunks) > 1
    # some destination takes several updates in one chunk
    assert any(c.ranks for c0, c1 in plu.panel_cols
               for c in plu._pass(c0, c1).chunks)
    ref = LUFactorizer(h.blocked, h.schedule, device="cpu").factorize()
    nt = h.blocked.num_tiles
    np.testing.assert_allclose(plu.store.to_dense()[:nt], ref[:nt].numpy(),
                               **TOL_SPLIT)
    plu.store.values.copy_(v0)
    assert torch.equal(plu.factorize().values, first)


@pytest.mark.parametrize("dtype", ["r32", "cr32"])
def test_end_to_end_through_the_route(monkeypatch, tmp_path, dtype):
    """init -> gstrf -> gstrs with tile_storage="compressed", the route
    predicate taken on the CPU (several panels by PANGULU_OOC_PANEL_GB):
    the panel engine, the residuals, update_values -> gstrf refilling
    the same store, and save_factor -> the JAX package's load_factor ->
    its solve."""
    from pangulu_tpu.io.checkpoint import load_factor as jload
    from pangulu_tpu_torch.io import save_factor

    monkeypatch.setattr(tapi, "_takes_panel_lu", lambda h: True)
    monkeypatch.setenv("PANGULU_OOC_PANEL_GB", "1e-5")
    a = tm.poisson2d(12)
    if dtype == "cr32":
        a = with_imaginary_parts(a)
        b = a.to_scipy() @ (np.ones(a.n) + 1j * np.arange(a.n))
        aw = a.to_scipy().astype(np.complex64)
    else:
        b = generated_rhs(a)
        aw = a.to_scipy()
    h = pt.init(a, pt.InitOptions(nb=8, dtype=dtype, device="cpu",
                                  tile_storage="compressed", check=True))
    pt.gstrf(h)
    plu = h._factorizer
    assert isinstance(plu, PanelLU)
    assert h.perf.kernels["engine"] == "panel"
    assert h.perf.kernels["panels"] == len(plu.panel_cols) > 1
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    x = pt.gstrs(h, b)
    assert residual_norm(aw, x, b) < 1e-10
    # the refactorization refills the same store
    store = h._comp_store
    assert store is h.factor_tiles is plu.store
    s2 = a.to_scipy().copy()
    s2.data = s2.data * (1.0 + 0.05 * np.sin(np.arange(s2.nnz)))
    pt.update_values(h, s2)
    pt.gstrf(h)
    assert h._factorizer is not plu and h._comp_store is store
    assert h.perf.kernels["gstrf_residual"] < 1e-5
    b2 = s2 @ np.ones(a.n)
    x2 = pt.gstrs(h, b2)
    # update_values keeps A in the working precision (the residual's A)
    aw2 = s2.astype(np.complex64 if dtype == "cr32" else np.float32)
    assert residual_norm(aw2, x2, b2) < 1e-10
    # the factor saved by the port, solved by the JAX package
    save_factor(h, tmp_path / "p.npz")
    hj = jload(tmp_path / "p.npz")
    np.testing.assert_allclose(np.asarray(hj.factor_tiles),
                               h.factor_tiles.to_dense(), rtol=0, atol=0)
    if dtype == "r32":
        np.testing.assert_allclose(japi.gstrs(hj, b2), x2, rtol=1e-8,
                                   atol=1e-8)
    else:
        # the JAX package rounds a complex b to cr32's complex64 first:
        # both given that b
        b64 = b2.astype(np.complex64)
        x64 = pt.gstrs(h, b64)
        np.testing.assert_allclose(japi.gstrs(hj, b64), x64, rtol=1e-6,
                                   atol=1e-6 * np.abs(x64).max())


def test_gstrf_off_the_card_takes_compressed_lu():
    """On the CPU the route is CompressedLU's, at nb=128 and f32 too."""
    h = pt.init(tm.poisson2d(12),
                pt.InitOptions(nb=128, dtype="r32", device="cpu",
                               tile_storage="compressed"))
    pt.gstrf(h)
    assert type(h._factorizer) is CompressedLU
    assert h.perf.kernels["engine"] == "compressed"


@pytest.mark.parametrize("nb", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["r32", "r64", "cr32", "cr64"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_route_predicate(device, dtype, nb):
    """PanelLU where the JAX package takes it on a TPU: a CUDA handle,
    float32 working values (r32, and cr32's embedded system), nb 128 or
    256; CompressedLU everywhere else."""
    a = tm.poisson2d(4)
    if dtype.startswith("c"):
        a = with_imaginary_parts(a)
    h = pt.init(a, pt.InitOptions(nb=nb, dtype=dtype, device="cpu",
                                  tile_storage="compressed"))
    h.device = torch.device(device)
    want = device == "cuda" and dtype in ("r32", "cr32") and nb in (128,
                                                                    256)
    assert tapi._takes_panel_lu(h) is want

