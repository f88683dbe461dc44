"""K1 for tiles wider than 256 (csrc/wide_lu.cuh: lu_wide_kernel on a
thread block cluster up to 512, lu_flow_kernel, one cooperative launch,
up to W_T, the recursion above), on the CPU (device="cpu") against the
JAX package:

  * its plain twin up to W_T, the blocked step in panels of 32 over the
    whole tile (``kernels_torch.getrf_with_inverses_blocked``), at
    nb = 288, 300, 384 and 512, float32 and float64, on random tiles and
    on tiles with a zero pivot at step 0 and at ``wide_split(nb)``
    (``testing.wide_tiny_pivot_tile``), against the JAX package's
    diagonal step (``kernels_jax.getrf_with_inverses``, its recursion to
    32 with Newton inverses); at nb = 288 against the Pallas K1's
    blocked32 mode (interpret mode); at nb = 768 and 1088 (the flow
    kernel's) against the JAX package on random tiles, and at 1088 with
    zero pivots against the rank-1 reference semantics
    (``kernels_torch.getrf_with_inverses_wide``);
  * the twin above W_T (``kernels_torch.k1_wide``: the recursion on
    leaves of at most ``width``) at nb = 640 with leaves of 320 against
    the JAX package;
  * the launch plans (``kernels_cuda.wide_plan`` up to 512,
    ``kernels_cuda.flow_plan`` up to W_T: CTAs, rows a CTA, shared
    memory, tiles in flight, the flags they need) within the card's
    limits at every nb, which chip_smoke.py holds to the C side's; the
    recursion's leaf width a batch (``kernels_torch.k1_leaf_width``:
    the widest at which the whole batch runs at once) and the device
    launches it gives (``kernels_cuda.k1_device_launches``), and the
    twin's default leaf following the batch;
  * numpy emulations of the kernels' schedules, held to the twin: the
    cluster kernel's (its rows a CTA, stripes a warp in the kernel's
    order, lookahead, staging rows written as their stripes finish and
    read after the panel's cluster barrier), and the flow kernel's
    (every warp a task, their order of progress drawn from a seeded
    generator; staging rows and rows of R NaN until written, each read
    checked against the flag that covers it and against the final
    store; barriers, named barriers and ready flags as the kernel has
    them).

Tolerances (ROADMAP.md "Tolerances"): random tiles f32 rtol/atol 1e-5,
f64 1e-12 (the two sides sum their products in other orders); zero-pivot
tiles and the Pallas kernel: the JAX package's bound for a blocked LU
against the scan (testing.BLOCKED_TOL: f32 factor 3e-5, inverses 2e-4;
f64 1e-12), because those inverses hold entries of 1/tol; the
emulations, the same sums in float64 grouped by stripes, 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangulu_tpu.ops import kernels_jax as kj
from pangulu_tpu.ops import kernels_pallas as kp
from pangulu_tpu_torch.ops import kernels_cuda as kc
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.testing import BLOCKED_TOL, wide_tiny_pivot_tile

TTOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.float64: dict(rtol=1e-12, atol=1e-12)}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _tile(nb, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((nb, nb)) + nb * np.eye(nb)
    return wide_tiny_pivot_tile(nb, rng)


def _against_jax(got, a, dtype, kind):
    want = kj.getrf_with_inverses(jnp.asarray(a, JDT[dtype]))
    tols = ((TTOL[dtype],) * 3 if kind == "random" else
            [dict(rtol=r, atol=t) for r, t in BLOCKED_TOL[dtype]])
    for n, g, w, tol in zip(("f", "linv", "uinv"), got, want, tols):
        torch.testing.assert_close(g, torch.as_tensor(np.asarray(w)), **tol,
                                   msg=f"{n} vs JAX")


@pytest.mark.parametrize("kind", ["random", "zero pivots"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [288, 300, 384, 512])
def test_cluster_twin_matches_jax(nb, dtype, kind):
    """The blocked step over the whole tile (the cluster kernel's twin)
    against the JAX diagonal step; the zero pivots at 0 and at
    wide_split(nb), a panel's start, become +tol."""
    a = _tile(nb, kind, nb)
    got = kt.getrf_with_inverses_blocked(torch.as_tensor(a, dtype=dtype))
    assert all(g.shape == (nb, nb) for g in got)
    _against_jax(got, a, dtype, kind)
    if kind != "random":
        tol = float(torch.tensor(kt.DEFAULT_TOL[dtype], dtype=dtype))
        m1 = kt.wide_split(nb)
        assert m1 % kt.LU_PANEL == 0
        assert float(got[0][0, 0]) == tol and float(got[0][m1, m1]) == tol


def test_cluster_twin_matches_pallas_blocked32():
    """The JAX package's K1 in its MXU mode (blocked32: panels of 32, the
    Pallas kernel in interpret mode) at nb = 288 in float32."""
    rng = np.random.default_rng(288)
    a = (rng.standard_normal((288, 288)) + 288 * np.eye(288)).astype(
        np.float32)
    want = kp.getrf_with_inverses(jnp.asarray(a), inv="blocked32")
    got = kt.getrf_with_inverses_blocked(torch.from_numpy(a))
    for g, w, (rtol, atol) in zip(got, want, BLOCKED_TOL[torch.float32]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


@pytest.fixture(scope="module")
def jax_wide():
    """The JAX package's diagonal step on one random tile a (nb, dtype)
    of the flow kernel's widths, computed once (15-23 s each)."""
    out = {}

    def get(nb, dtype):
        if (nb, dtype) not in out:
            a = _tile(nb, "random", nb)
            w = kj.getrf_with_inverses(jnp.asarray(a, JDT[dtype]))
            out[nb, dtype] = a, [np.asarray(x) for x in w]
        return out[nb, dtype]
    return get


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [768, 1088])
def test_flow_twin_matches_jax(jax_wide, nb, dtype):
    """The flow kernel's twin, the blocked step over the whole tile, at
    widths only it takes (up to W_T; 1088 in both types)."""
    assert nb <= kt.FLOW_LEAF[dtype]
    a, want = jax_wide(nb, dtype)
    at = torch.as_tensor(a, dtype=dtype)
    got = kt.getrf_with_inverses_blocked(at)
    for n, g, w in zip(("f", "linv", "uinv"), got, want):
        torch.testing.assert_close(g, torch.as_tensor(w), **TTOL[dtype],
                                   msg=f"{n} vs JAX")
    for g, w in zip(kt.k1_wide(at), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flow_twin_zero_pivots_at_1088(dtype):
    """Zero pivots at step 0 and at wide_split(1088) = 544 become +tol in
    the twin, as in the reference semantics (the recursion on rank-1
    leaves of 256), at the blocked-LU bound."""
    a = torch.as_tensor(_tile(1088, "zero pivots", 1088), dtype=dtype)
    got = kt.getrf_with_inverses_blocked(a)
    ref = kt.getrf_with_inverses_wide(a)
    for n, g, r, (rtol, atol) in zip(("f", "linv", "uinv"), got, ref,
                                     BLOCKED_TOL[dtype]):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol, msg=n)
    tol = float(torch.tensor(kt.DEFAULT_TOL[dtype], dtype=dtype))
    assert float(got[0][0, 0]) == tol and float(got[0][544, 544]) == tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_recursion_on_512_leaves_matches_jax(dtype):
    """Above the leaf width the twin recurses: at 640 with leaves of at
    most 512 (the recursion above W_T, at a width the CPU can check
    against JAX) it splits once, 640 -> 320 + 320, and runs the blocked
    step on each leaf; at the default width, W_T, 640 is one leaf."""
    a = _tile(640, "random", 640)
    at = torch.as_tensor(a, dtype=dtype)
    got = kt.k1_wide(at, width=512)
    _against_jax(got, a, dtype, "random")
    assert kt.wide_split(640) == 320
    for g, w in zip(got, kt.getrf_with_inverses_wide(
            at, leaf=kt.getrf_with_inverses_blocked, width=320)):
        assert torch.equal(g, w)
    for g, w in zip(kt.k1_wide(at), kt.getrf_with_inverses_blocked(at)):
        assert torch.equal(g, w)


def test_cpu_wrapper_keeps_the_reference_twin():
    """On a CPU tensor the K1 wrapper at nb > 256 stays the recursion
    with rank-1 leaves (the reference semantics)."""
    a = torch.as_tensor(_tile(384, "random", 1), dtype=torch.float32)
    for g, r in zip(kc.getrf_with_inverses(a),
                    kt.getrf_with_inverses_wide(a)):
        assert torch.equal(g, r)


# ---- the launch's plan ---------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_plan_fits_the_card(dtype):
    """Every nb up to 512 fits one block's shared memory and one cluster
    of at most 16 CTAs; a CTA holds whole panels and the cluster covers
    the tile."""
    for nb in range(1, kt.WIDE_LEAF + 1):
        pl = kc.wide_plan(nb, dtype)
        assert pl["smem"] <= kc.SMEM_PER_BLOCK
        assert 1 <= pl["ctas"] <= 16
        assert pl["rows"] % kt.LU_PANEL == 0
        assert (pl["ctas"] - 1) * pl["rows"] < nb <= pl["ctas"] * pl["rows"]
        assert pl["stripe"] == kt.LU_PANEL


def test_wide_plan_values():
    """The shared memory spelt out at 512: W 32 x 516, L11^-1 and a_i 32
    x 36 each, 8 stripes of R of 32 x 40 (f32) or 32 x 36 (f64), two rows
    of 40 for the diagonal warp."""
    f32 = kc.wide_plan(512, torch.float32)
    f64 = kc.wide_plan(512, torch.float64)
    assert f32 == dict(ctas=16, rows=32, stripe=32, smem=4 * (
        32 * 516 + 64 * 36 + 8 * 32 * 40 + 80))
    assert f64 == dict(ctas=16, rows=32, stripe=32, smem=8 * (
        32 * 516 + 64 * 36 + 8 * 32 * 36 + 80))
    assert f64["smem"] == 224_896 and f32["smem"] == 116_544
    assert kc.wide_plan(288, torch.float32)["ctas"] == 9
    assert kc.wide_plan(300, torch.float64)["ctas"] == 10
    with pytest.raises(ValueError, match="nb <= 512"):
        kc.wide_plan(513, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flow_plan_fits_the_card(dtype):
    """Every nb up to W_T: one block's shared memory, at most one CTA an
    SM of the 132, whole panels (32 rows a CTA in f32, 16 in f64: two
    CTAs a panel), and the flags of the tiles in flight within the
    stream's; W_T + 32 does not fit."""
    wt = kc.FLOW_MAX_NB[dtype]
    assert wt == kt.FLOW_LEAF[dtype] and wt % kt.LU_PANEL == 0
    assert (wt, kc.FLOW_ROWS[dtype]) == (
        (1408, 32) if dtype == torch.float32 else (1120, 16))
    for nb in range(1, wt + 1):
        pl = kc.flow_plan(nb, dtype)
        npan = -(-nb // kt.LU_PANEL)
        assert pl["smem"] <= kc.SMEM_PER_BLOCK
        assert pl["rows"] == kc.FLOW_ROWS[dtype]
        assert pl["ctas"] * pl["rows"] == npan * kt.LU_PANEL
        assert 1 <= pl["ctas"] <= kc.H100_SMS
        assert pl["sets"] == kc.H100_SMS // pl["ctas"] >= 1
        assert kc.flow_flags_needed(nb, dtype, pl["sets"]) <= kc.FLOW_FLAGS
    assert kc._flow_elems(wt + kt.LU_PANEL, dtype) * torch.empty(
        (), dtype=dtype).element_size() > kc.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match=f"nb <= {wt}"):
        kc.flow_plan(wt + 1, dtype)
    assert kc.flow_plan(1088, dtype)["ctas"] == 34 * (
        1 if dtype == torch.float32 else 2)


def test_flow_plan_values():
    """The shared memory spelt out at W_T: W 32 x 1412 floats (16 x 1124
    doubles), L11^-1 and the a_i 32 + 32 (32 + 16) rows of 36, 8 stripes
    of R 32 x 40 (32 x 36), two rows of 40; tiles in flight at 1088."""
    f32 = kc.flow_plan(1408, torch.float32)
    f64 = kc.flow_plan(1120, torch.float64)
    assert f32 == dict(ctas=44, rows=32, sets=3, smem=4 * (
        32 * 1412 + 64 * 36 + 8 * 32 * 40 + 80)) and f32["smem"] == 231_232
    assert f64 == dict(ctas=70, rows=16, sets=1, smem=8 * (
        16 * 1124 + 48 * 36 + 8 * 32 * 36 + 80)) and f64["smem"] == 232_064
    assert kc.flow_plan(1088, torch.float32)["sets"] == 3
    assert kc.flow_plan(640, torch.float32)["sets"] == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_leaf_width_fits_the_batch(dtype):
    """The recursion's leaf a batch (kernels_torch.k1_leaf_width, csrc/
    wide_lu.cuh flow_leaf): above 512, the widest width at which every
    tile of the batch runs on the flow kernel at once, one CTA an SM of
    the 132, with the flags they take within the stream's; 512, the
    cluster kernel's, where no wider width fits."""
    wt = kc.FLOW_MAX_NB[dtype]
    for batch in range(1, 65):
        w = kt.k1_leaf_width(batch, dtype)
        assert w % kt.LU_PANEL == 0 and kt.WIDE_LEAF <= w <= wt
        fits = [v for v in range(kt.WIDE_LEAF + kt.LU_PANEL, wt + 1,
                                 kt.LU_PANEL)
                if batch * kc.flow_plan(v, dtype)["ctas"] <= kc.H100_SMS]
        assert w == max(fits, default=kt.WIDE_LEAF)
        if w > kt.WIDE_LEAF:
            assert kc.flow_flags_needed(w, dtype, batch) <= kc.FLOW_FLAGS
    assert [kt.k1_leaf_width(b, dtype) for b in (1, 2, 3, 4, 8)] == (
        [1408, 1408, 1408, 1056, 512] if dtype == torch.float32
        else [1120, 1056, 704, 512, 512])


def test_device_launches_values():
    """K1's device launches a call (kernels_cuda.k1_device_launches): one
    up to the leaf width, each split's five products and copies beside
    its halves' above it."""
    f32, f64 = torch.float32, torch.float64
    cases = {(640, 4, f32): 1, (640, 4, f64): 7, (1024, 4, f32): 1,
             (1088, 1, f32): 1, (1088, 3, f32): 1, (1088, 4, f32): 7,
             (1088, 4, f64): 19, (1088, 2, f64): 7, (1408, 1, f32): 1,
             (1120, 1, f64): 1, (1152, 1, f64): 7, (1440, 1, f32): 7,
             (1024, 27, f32): 7, (384, 27, f64): 1, (200, 5, f32): 1}
    for (nb, batch, dtype), want in cases.items():
        assert kc.k1_device_launches(nb, batch, dtype) == want, (nb, batch,
                                                                 dtype)


def test_twin_takes_the_batch_leaf():
    """kernels_torch.k1_wide's default leaf follows the batch as the CUDA
    K1's does: four float64 tiles of 640 do not fit the card at once on
    the flow kernel (160 CTAs), so they split 320 + 320 as the cluster
    kernel's leaves; one tile is one leaf."""
    a = torch.as_tensor(np.stack([_tile(640, "random", s)
                                  for s in range(4)]), dtype=torch.float64)
    for g, w in zip(kt.k1_wide(a), kt.getrf_with_inverses_wide(
            a, leaf=kt.k1_leaf, width=kt.WIDE_LEAF)):
        assert torch.equal(g, w)
    for g, w in zip(kt.k1_wide(a[:1]),
                    kt.getrf_with_inverses_blocked(a[:1])):
        assert torch.equal(g, w)


# ---- the kernel's schedule, emulated ---------------------------------------

def _diag_block(blk, tol):
    """diag_panel: (F11, the block with L11^-1 below the diagonal and
    U11^-1 on and above it)."""
    f, li, ui = kt.getrf_with_inverses(torch.as_tensor(blk), tol)
    return f.numpy(), np.triu(ui.numpy()) + np.tril(li.numpy(), -1)


def _emulate(a, rows=32, lookahead=True, tol=1e-16):
    """lu_wide_kernel's steps in float64, one CTA and one warp after
    another: W per CTA (padded with the identity); the staging rows
    (NaN until written), read only as they stood at the panel's cluster
    barrier; each warp's stripes in the kernel's order, each forming its
    stripe of R from the staging rows; the next panel's rows staged as
    their stripes finish."""
    r = kt.LU_PANEL
    n = a.shape[0]
    cl = -(-n // rows)
    npan = -(-n // r)
    w = [np.zeros((rows, cl * rows)) for _ in range(cl)]
    for c in range(cl):
        for i in range(rows):
            gi = c * rows + i
            if gi < n:
                w[c][i, :n] = a[gi]
            else:
                w[c][i, gi] = 1.0
    f = np.full((n, n), np.nan)
    staged = np.full((n, n), np.nan)  # UI's rows, the staging rows

    def diag(c, lr, k0):
        fb, blk = _diag_block(w[c][lr:lr + r, k0:k0 + r], tol)
        w[c][lr:lr + r, k0:k0 + r] = blk
        m = min(r, n - k0)
        f[k0:k0 + m, k0:k0 + m] = fb[:m, :m]

    def stage(c, lr, k0, j0):
        m, k = min(r, n - k0), min(r, n - j0)
        if k > 0:
            staged[k0:k0 + m, j0:j0 + k] = w[c][lr:lr + m, j0:j0 + k]

    def read(seen, k0, j0):
        """The staging rows of panel k0, columns [j0, j0 + 32), as the
        kernel reads them: the padding's identity outside the tile."""
        blk = np.zeros((r, r))
        for i in range(r):
            for j in range(r):
                if k0 + i < n and j0 + j < n:
                    blk[i, j] = seen[k0 + i, j0 + j]
                else:
                    blk[i, j] = 1.0 if k0 + i == j0 + j else 0.0
        assert not np.isnan(blk).any(), "read before written"
        return blk

    diag(0, 0, 0)
    for s in range(npan):
        stage(0, 0, 0, s * r)
    for p in range(npan):
        k0, kb = p * r, p * r + r
        seen = staged.copy()  # the cluster barrier of panel p
        blk = read(seen, k0, k0)
        lb, ub = np.tril(blk, -1) + np.eye(r), np.triu(blk)
        for c in range(cl):
            r0 = c * rows
            mine = k0 // rows == c
            nxt = p + 1 < npan and kb // rows == c
            lr, lr1 = k0 - r0, kb - r0
            ab = np.zeros((rows, r))
            for i in range(rows):
                gi = r0 + i
                ab[i] = ub[gi - k0] if k0 <= gi < kb else w[c][i, k0:kb] @ ub
            for i in range(rows):
                gi = r0 + i
                if gi >= kb:
                    w[c][i, k0:kb] = 0.0
                    if gi < n:
                        m = min(r, n - k0)
                        f[gi, k0:k0 + m] = ab[i, :m]
                elif gi < k0:
                    w[c][i, k0:kb] = ab[i]
            s_lo = 0 if r0 + rows > kb or mine else p + 1
            cnt = npan - s_lo
            la = lookahead and nxt
            for warp in range(8):
                dq = 8 if not la else cnt if warp == 0 else 7
                for q in range(warp, cnt, dq):
                    s = p + 1 + q
                    if s >= npan:
                        s = s_lo + s - npan
                    j0 = s * r
                    if s == p:
                        rs = lb
                    else:
                        rs = lb @ read(seen, k0, j0)
                        if mine:
                            w[c][lr:lr + r, j0:j0 + r] = rs if s < p else 0.0
                            if s > p:
                                m, k = min(r, n - k0), min(r, n - j0)
                                f[k0:k0 + m, j0:j0 + k] = rs[:m, :k]
                    for i0 in range(0, rows, 16):
                        if r0 + i0 >= kb or s > p:
                            w[c][i0:i0 + 16, j0:j0 + r] -= ab[i0:i0 + 16] @ rs
                    if nxt and s != p + 1:
                        stage(c, lr1, kb, j0)
                    if la and warp == 0:
                        diag(c, lr1, kb)
                        stage(c, lr1, kb, kb)
            if not lookahead and nxt:
                diag(c, lr1, kb)
                stage(c, lr1, kb, kb)
    full = np.concatenate(w)[:n, :n]
    linv = np.tril(full, -1) + np.eye(n)
    return f, linv, np.triu(full)


@pytest.mark.parametrize("nb,rows,lookahead", [
    (64, 32, True), (100, 32, True), (100, 32, False), (288, 32, True),
    (300, 32, False), (130, 64, True), (160, 64, False)])
def test_schedule_emulation_matches_twin(nb, rows, lookahead):
    """The kernel's schedule computes the blocked step: every staging row
    is written before the barrier that precedes its reads, and the
    factor and both inverses agree with the twin in float64."""
    rng = np.random.default_rng(nb + rows)
    a = rng.standard_normal((nb, nb)) + nb * np.eye(nb)
    got = _emulate(a, rows, lookahead)
    assert not any(np.isnan(g).any() for g in got)
    for g, w in zip(got, kt.getrf_with_inverses_blocked(torch.as_tensor(a))):
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-12, atol=1e-12)


# ---- the flow kernel's schedule, emulated -----------------------------------

class _Barrier:
    """A CTA's barrier (or named barrier) of ``n`` warps."""

    def __init__(self, n):
        self.n, self.waiting = n, []


def _emulate_flow(a, rows, seed, tiles=1, tol=1e-16):
    """lu_flow_kernel on ``tiles`` tiles of ``a`` (one set of CTAs, so
    the tiles run as rounds of the launch, round r publishing r + 1) in
    float64: each of the 8 warps of each CTA is a task, and a generator
    seeded with ``seed`` picks which runnable task takes its next step.
    A task blocks at its CTA's barrier, at the named barrier of warps 0-3
    and on a flag below its round's value.  The staging rows (UI's),
    the rows of R (LI's) and the factor start as NaN; each read of them
    checks the flag that covers it (its panel, stripe and half of the
    rows), that the final store has not overwritten it and that it was
    written.  Returns, a tile, (f, L^-1, U^-1)."""
    r = kt.LU_PANEL
    a = a if a.ndim == 3 else np.broadcast_to(a, (tiles,) + a.shape)
    n = a.shape[-1]
    npan = -(-n // r)
    h_ = r // rows if rows < r else 1
    ctas, np_ = npan * h_, npan * r
    rng = np.random.default_rng(seed)
    flags, waiters, ready = {}, {}, []
    out = [dict(f=np.full((n, n), np.nan), ui=np.full((n, n), np.nan),
                li=np.full((n, n), np.nan), final=np.zeros((n, n), bool))
           for _ in range(tiles)]
    cta = [dict(bar=_Barrier(8), la=_Barrier(4), pieces={})
           for _ in range(ctas)]

    def up(key, ep):
        return flags.get(key, 0) >= ep

    def publish(key, ep):
        flags[key] = ep
        ready.extend(waiters.pop(key, []))

    def block(o, buf, k0, c0, check, i0=0):
        """rows [k0, k0 + 32), columns [c0, c0 + 32) of o[buf] (from row
        k0 + i0; the rows above 0), the padding's identity outside the
        tile; check(i) asserts the flag of the panel's row i."""
        m, k = min(r, n - k0), max(0, min(r, n - c0))
        blk = (np.empty((r, r)) if m == r and k == r and not i0
               else np.eye(r, k=k0 - c0))
        blk[:i0] = 0.0
        for i in range(i0, m, rows):
            check(i)
        got = o[buf][k0 + i0:k0 + m, c0:c0 + k]
        assert not np.isnan(got).any(), f"{buf} read before written"
        assert not o["final"][k0 + i0:k0 + m, c0:c0 + k].any(), \
            f"{buf} read after the final store"
        blk[i0:m, :k] = got
        return blk

    def warp_task(rank, warp):
        st = cta[rank]
        r0, half = rank * rows, rank % h_
        for b in range(tiles):
            ep, o = b + 1, out[b]
            yield ("bar", st["bar"])
            if warp == 0:
                w = np.zeros((rows, np_))
                for i in range(rows):
                    gi = r0 + i
                    if gi < n:
                        w[i, :n] = a[b, gi]
                    else:
                        w[i, gi] = 1.0
                st["W"] = w
            yield ("bar", st["bar"])
            W = st["W"]

            def wait(key):
                while not up(key, ep):
                    yield ("flag", key)

            def stage(kq, lq, c, i0, i1):
                m, k = min(i1, n - kq), max(0, min(r, n - c))
                if m > i0 and k:
                    o["ui"][kq + i0:kq + m, c:c + k] = \
                        W[lq + i0:lq + m, c:c + k]

            def raw(p, s, i0=0):
                return block(o, "ui", p * r, s * r, lambda i: (
                    None if up((p, s, i // rows if h_ > 1 else 0), ep)
                    else pytest.fail(f"staging {p, s} read before its "
                                     "flag")), i0)

            def diag_step(q, lq):
                kq = q * r
                m = min(r, n - kq)
                if h_ == 1 or half == 0:
                    if h_ == 1:
                        buf = W[lq:lq + r, kq:kq + r].copy()
                    else:
                        for h in range(1, h_):
                            yield from wait((q, q, h))
                        buf = raw(q, q, rows)  # the others' rows
                        buf[:rows] = W[lq:lq + rows, kq:kq + r]
                    fb, blk = _diag_block(buf, tol)
                    if h_ == 1:
                        W[lq:lq + r, kq:kq + r] = blk
                    o["f"][kq:kq + m, kq:kq + m] = fb[:m, :m]
                    o["ui"][kq:kq + m, kq:kq + m] = blk[:m, :m]
                    publish((q, q, 0), ep)
                else:
                    stage(kq, lq, kq, -lq, r)
                    publish((q, q, half), ep)

            def apply(p, s, c0, c1, rs, lr, mine, ab):
                k0, kb = p * r, p * r + r
                if mine and s != p:
                    for i in range(r):
                        if 0 <= lr + i < rows:
                            W[lr + i, c0:c1] = rs[i] if s < p else 0.0
                            if s > p and k0 + i < n and c0 < n:
                                e = min(c1, n)
                                o["f"][k0 + i, c0:e] = rs[i, :e - c0]
                if not (r0 < kb and s <= p):
                    W[:, c0:c1] -= ab @ rs

            if rank // h_ == 0:
                if warp == 0:
                    yield from diag_step(0, -r0)
                else:
                    for s in range(warp, npan, 7):
                        stage(0, -r0, s * r, r0, min(r0 + rows, r))
                        publish((0, s, half), ep)
            for p in range(npan):
                k0, kb = p * r, p * r + r
                mine = rank // h_ == p
                nxt = p + 1 < npan and rank // h_ == p + 1
                lr, lr1 = k0 - r0, kb - r0
                s_lo = 0 if r0 + rows > kb or mine else p + 1
                cnt = npan - s_lo
                lead = nxt and warp == 0
                # warp 4 of the next owner idle beside the diagonal block
                # up to FlowDiagAlone's panels (rows 32: float's 28)
                alone = npan <= (28 if rows == r else 64)
                idle = alone and nxt and warp == 4
                q0 = warp if not nxt or not alone or warp < 4 else warp - 1
                dq = 8 if not nxt else (cnt if warp == 0 else 7 - alone)
                yield ("bar", st["bar"])
                yield from wait((p, p, 0))
                yield ("bar", st["bar"])
                if warp == 0:  # L11^-1, U11^-1, the a_i
                    blk = raw(p, p)
                    lb, ub = np.tril(blk, -1) + np.eye(r), np.triu(blk)
                    ab = np.zeros((rows, r))
                    for i in range(rows):
                        gi = r0 + i
                        if k0 <= gi < kb:
                            ab[i] = ub[gi - k0]
                            if h_ > 1:
                                W[i, k0:kb] = blk[gi - k0]
                        else:
                            ab[i] = W[i, k0:kb] @ ub
                            if gi >= kb:
                                W[i, k0:kb] = 0.0
                                if gi < n:
                                    m = min(r, n - k0)
                                    o["f"][gi, k0:k0 + m] = ab[i, :m]
                            else:
                                W[i, k0:kb] = ab[i]
                    st.update(lb=lb, ab=ab)
                yield ("bar", st["bar"])
                lb, ab = st["lb"], st["ab"]
                sr = rank // h_
                if warp == 0 and half == 0 and sr not in (p, p + 1):
                    for h in range(h_):
                        yield from wait((p, sr, h))
                    rb = lb @ raw(p, sr)
                    m, k = min(r, n - k0), min(r, n - sr * r)
                    o["li"][k0:k0 + m, sr * r:sr * r + k] = rb[:m, :k]
                    publish(("R", p, sr), ep)
                if nxt and warp < 4:
                    for h in range(h_):
                        yield from wait((p, p + 1, h))
                    c0 = kb + 8 * warp
                    piece = (lb @ raw(p, p + 1))[:, 8 * warp:8 * warp + 8]
                    apply(p, p + 1, c0, c0 + 8, piece, lr, mine, ab)
                    st["pieces"][warp] = piece
                    yield ("bar", st["la"])
                    if half == 0 and warp == 1:
                        m = min(r, n - k0)
                        for wq in range(4):
                            c = kb + 8 * wq
                            k = max(0, min(8, n - c))
                            o["li"][k0:k0 + m, c:c + k] = \
                                st["pieces"][wq][:m, :k]
                        publish(("R", p, p + 1), ep)
                for q in range(cnt if idle else q0, cnt, dq):
                    s = p + 1 + q
                    if s >= npan:
                        s = s_lo + s - npan
                    c = s * r
                    if not lead:
                        if s == p:
                            rs = lb
                        else:
                            yield from wait(("R", p, s))
                            rs = block(o, "li", k0, c, lambda i: (
                                None if up(("R", p, s), ep) else
                                pytest.fail(f"R {p, s} read before its "
                                            "flag")))
                        apply(p, s, c, c + r, rs, lr, mine, ab)
                    if nxt and s != p + 1:
                        stage(kb, lr1, c, half * rows,
                              half * rows + rows if h_ > 1 else r)
                        publish((p + 1, s, half), ep)
                    if lead:
                        yield from diag_step(p + 1, lr1)
                    yield ("step",)
            # the final stores once every CTA of the set is done
            yield ("bar", st["bar"])
            if warp == 0:
                publish(("done", rank), ep)
                for c in range(ctas):
                    yield from wait(("done", c))
            yield ("bar", st["bar"])
            if warp == 0:
                for i in range(rows):
                    gi = r0 + i
                    if gi < n:
                        row = W[i, :n]
                        o["li"][gi] = np.where(np.arange(n) < gi, row,
                                               np.arange(n) == gi)
                        o["ui"][gi] = np.where(np.arange(n) >= gi, row, 0.0)
                        o["final"][gi] = True
            yield ("bar", st["bar"])

    ready.extend(warp_task(c, w) for c in range(ctas) for w in range(8))
    live = len(ready)
    while ready:
        k = int(rng.integers(len(ready)))
        t = ready[k]
        ready[k] = ready[-1]
        ready.pop()
        ev = next(t, None)
        if ev is None:
            live -= 1
        elif ev[0] == "flag":
            waiters.setdefault(ev[1], []).append(t)
        elif ev[0] == "bar":
            bar = ev[1]
            bar.waiting.append(t)
            if len(bar.waiting) == bar.n:
                ready.extend(bar.waiting)
                bar.waiting = []
        else:
            ready.append(t)
    assert live == 0, f"deadlock: {live} warps blocked"
    return [(o["f"], o["li"], o["ui"]) for o in out]


@pytest.mark.parametrize("nb,rows,seed,tiles", [
    (640, 32, 0, 1), (640, 32, 1, 1), (640, 16, 2, 1), (640, 16, 3, 1),
    (1088, 32, 4, 1), (1088, 16, 5, 1), (100, 32, 6, 2), (150, 16, 7, 2)])
def test_flow_schedule_emulation_matches_twin(nb, rows, seed, tiles):
    """The flow kernel's schedule computes the blocked step under any
    order of its warps' progress: no read before its flag or after the
    final store, no deadlock, and the factor and both inverses equal the
    twin's in float64; two tiles run as two rounds of one set of CTAs
    (flags of the second round at 2)."""
    rng = np.random.default_rng(nb + rows)
    a = rng.standard_normal((tiles, nb, nb)) + nb * np.eye(nb)
    for t, got in enumerate(_emulate_flow(a, rows, seed, tiles)):
        assert not any(np.isnan(g).any() for g in got)
        for g, w in zip(got, kt.getrf_with_inverses_blocked(
                torch.as_tensor(a[t]))):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-12, atol=1e-12)
