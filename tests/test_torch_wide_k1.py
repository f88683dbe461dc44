"""K1 for tiles wider than 256 on its thread block cluster
(csrc/wide_lu.cuh lu_wide_kernel), on the CPU (device="cpu") against the
JAX package:

  * its plain twin up to nb = 512, the blocked step in panels of 32 over
    the whole tile (``kernels_torch.getrf_with_inverses_blocked``), at
    nb = 288, 300, 384 and 512, float32 and float64, on random tiles and
    on tiles with a zero pivot at step 0 and at ``wide_split(nb)``
    (``testing.wide_tiny_pivot_tile``), against the JAX package's
    diagonal step (``kernels_jax.getrf_with_inverses``, its recursion to
    32 with Newton inverses); at nb = 288 against the Pallas K1's
    blocked32 mode (interpret mode);
  * the twin above 512 (``kernels_torch.k1_wide``: the recursion on
    leaves of at most 512) at nb = 640 against the JAX package;
  * the launch's plan (``kernels_cuda.wide_plan``: CTAs, rows a CTA,
    shared memory, stripe width) within the card's limits at every nb,
    which chip_smoke.py holds to the C side's;
  * a numpy emulation of the kernel's schedule (its rows a CTA, stripes
    a warp in the kernel's order, lookahead, staging rows written as
    their stripes finish and read after the panel's cluster barrier),
    held to the twin.

Tolerances (ROADMAP.md "Tolerances"): random tiles f32 rtol/atol 1e-5,
f64 1e-12 (the two sides sum their products in other orders); zero-pivot
tiles and the Pallas kernel: the JAX package's bound for a blocked LU
against the scan (testing.BLOCKED_TOL: f32 factor 3e-5, inverses 2e-4;
f64 1e-12), because those inverses hold entries of 1/tol; the emulation,
the same sums in float64 grouped by stripes, 1e-12.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_recursion_on_512_leaves_matches_jax(dtype):
    """Above 512 the twin splits once, 640 -> 320 + 320, and runs the
    blocked step on each leaf (the kernel's launches there)."""
    a = _tile(640, "random", 640)
    at = torch.as_tensor(a, dtype=dtype)
    got = kt.k1_wide(at)
    _against_jax(got, a, dtype, "random")
    assert kt.wide_split(640) == 320
    for g, w in zip(got, kt.getrf_with_inverses_wide(
            at, leaf=kt.getrf_with_inverses_blocked, width=320)):
        assert torch.equal(g, w)
    for g, w in zip(kt.k1_wide(at[:512, :512]),
                    kt.getrf_with_inverses_blocked(at[:512, :512])):
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
