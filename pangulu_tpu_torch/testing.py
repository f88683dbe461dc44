"""Inputs, tolerances and counts that the port's tests and
``chip_smoke.py`` share: for K1 (the diagonal step), tiles whose pivots
are exactly zero at a chosen step, the bound that holds K1's blocked
step (128 < nb <= 256) against the rank-1 plain version, and K4's
diagonal step alone on tiles of a store (``diag_step``); for the
compressed store, a store of a matrix at any nb and value type
(``compressed_store``), the launches its engines make
(``CompressedLU``, ``PanelLU``) and copies of its arrays off their
alignment (``offset_copy``); for the TPU probes P3, P4 and P5, their
inputs; for the complex types, a damped operator with imaginary
parts."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pangulu_tpu_torch.ops import kernels_cuda as kc
from pangulu_tpu_torch.ops import kernels_torch as kt

# K1's blocked step against the rank-1 plain version: (rtol, atol) of
# the factor, L^-1 and U^-1.  In f32 the JAX package's bound for its
# blocked LU against the scan (tests/test_pallas.py:79-99); in f64 the
# contract's 1e-12.
BLOCKED_TOL = {torch.float32: ((3e-5, 3e-5), (2e-4, 2e-4), (2e-4, 2e-4)),
               torch.float64: ((1e-12, 1e-12),) * 3}


def tiny_pivot_tile(nb: int, k: int, rng) -> np.ndarray:
    """A diagonally dominant tile whose pivot at step k is exactly 0, so
    the tiny-pivot rule fires there: for k > 0 row k and column k copy
    row 0 and column 0 around a00 = 1, which step 0 zeroes exactly; for
    k = 0 the first row and column are zero.  Either way the huge
    entries 1/tol of the inverses are exact products, not sums that a
    different order could round apart."""
    a = rng.standard_normal((nb, nb)) + nb * np.eye(nb)
    if k == 0:
        a[0, :] = 0.0
        a[:, 0] = 0.0
    else:
        a[0, 0] = 1.0
        a[k, :] = a[0, :]
        a[:, k] = a[:, 0]
    return a


def blocked_tiny_pivot_tile(nb: int, k1: int, k2: int, rng) -> np.ndarray:
    """A tile of nb > LU_SPLIT whose pivots at steps k1 and LU_SPLIT + k2
    reach exactly 0 by elimination (or, at step 0, start there) in the
    rank-1 scan and in K1's blocked step (panels of LU_PANEL) alike, so
    that the tiny-pivot rule fires at the same steps.  The tile is
    diagonally dominant.  Every product that meets row or column k of
    such a step meets exact values, so no order of summation rounds the
    pivot away from 0:

    - k = 0: row and column 0 are zero (tiny_pivot_tile);
    - k inside its panel (k0 < k < k0 + LU_PANEL, k0 = k - k % LU_PANEL):
      that panel's rows and columns are zero left of and above it, so
      the earlier panels leave it as it is; then, as tiny_pivot_tile
      does at step 0, row k and column k copy row k0 and column k0
      around a[k0, k0] = 1 and step k0 zeroes the pivot; columns k0 and
      k are zero below the panel (they would meet U11^-1's 1/tol
      entries);
    - k at a panel's start: row and column j = k - LU_PANEL (the
      previous panel's start) and k are zero but for a[j, j] = a[j, k] =
      a[k, j] = a[k, k] = 1, so that step j zeroes the pivot as exact
      products of 0 and 1 in either blocking.

    The two steps must lie in different panels, not next to each
    other."""
    r = kt.LU_PANEL
    ks = (k1, kt.LU_SPLIT + k2)
    panels = [{k // r - 1, k // r} if k and k % r == 0 else {k // r}
              for k in ks]
    if panels[0] & panels[1]:
        raise ValueError(f"steps {ks} are too close")
    a = rng.standard_normal((nb, nb)) + nb * np.eye(nb)
    for k in ks:
        k0 = k - k % r
        if k % r:
            a[k0:k0 + r, :k0] = 0.0
            a[:k0, k0:k0 + r] = 0.0
    for k in ks:
        k0 = k - k % r
        if k == 0:
            a[0, :] = 0.0
            a[:, 0] = 0.0
        elif k % r:
            a[k0, k0] = 1.0
            a[k, :] = a[k0, :]
            a[:, k] = a[:, k0]
            a[k0 + r:, [k0, k]] = 0.0
        else:
            j = k - r
            a[[j, k], :] = 0.0
            a[:, [j, k]] = 0.0
            a[j, j] = a[j, k] = a[k, j] = a[k, k] = 1.0
    return a


def wide_tiny_pivot_tile(nb: int, rng) -> np.ndarray:
    """A diagonally dominant tile of nb > MAX_NB whose pivots at step 0
    and at step ``kernels_torch.wide_split(nb)`` (the first of the second
    half of the recursion's split, a panel's start) are exactly 0, in the
    rank-1 scan, the recursion and the blocked step alike: A21 is zero,
    so S22 = A22 - L21·U12 and every panel's update of A22 are exact,
    and row and column 0 of A11 and of A22 are zero."""
    a = rng.standard_normal((nb, nb)) + nb * np.eye(nb)
    m1 = kt.wide_split(nb)
    a[m1:, :m1] = 0.0
    for k in (0, m1):
        a[k, k:] = 0.0
        a[k:, k] = 0.0
    return a


def zero_pivot_uinv_errors(f: torch.Tensor, uinv: torch.Tensor,
                           twin_uinv: torch.Tensor, contract) -> dict:
    """K1's U^-1 on a :func:`wide_tiny_pivot_tile` (or a batch of them)
    against its twin's.  Its column k = wide_split(nb) holds entries
    scaled by 1/tol and is ill-conditioned: in float32 the twin itself
    is 100% off the float64 twin there, so no comparison with the twin
    tests that column, and it is held by its residual instead.  The
    ratios ``rest`` and ``residual`` pass at <= 1:

      - ``rest``: every other column against the twin at ``contract``
        (rtol, atol): the largest |kernel - twin| / (atol + rtol |twin|);
      - ``residual``: column k of U·U^-1 - I, with U the upper triangle
        of the kernel's own ``f``, in float64: its largest entry over
        nb·u·(the largest of |U|·|U^-1|'s column k), u the unit
        roundoff of the type; a column that is off by a share of its
        size leaves a residual of that share of |U|·|U^-1|;
      - ``column`` (a measurement, no bound): column k against the twin,
        the ratio of ``rest`` at BLOCKED_TOL's U^-1 bound."""
    nb = f.shape[-1]
    k = kt.wide_split(nb)
    rtol, atol = contract
    g, r = uinv.double(), twin_uinv.double()
    over = (g - r).abs() / (atol + rtol * r.abs())
    brt, bat = BLOCKED_TOL[f.dtype][2]
    col = ((g[..., :, k] - r[..., :, k]).abs()
           / (bat + brt * r[..., :, k].abs()))
    over[..., :, k] = 0.0
    u = torch.triu(f.double())
    x = g[..., :, k:k + 1]
    res = u @ x
    res[..., k, 0] -= 1.0
    scale = (u.abs() @ x.abs()).amax()
    unit = torch.finfo(f.dtype).eps / 2
    return dict(rest=float(over.max()), column=float(col.max()),
                residual=float(res.abs().amax() / (nb * unit * scale)))


def diag_step(tiles: torch.Tensor, ids, invs: torch.Tensor, inv_ids,
              tol: float | None = None) -> None:
    """K1 as K4's diagonal step runs it, alone (the C entry
    ``plu_diag_step``), for tests of members at ids that are not
    contiguous: the tiles ``ids`` of the store ``tiles`` [nt, nb, nb]
    factored IN PLACE, their (L^-1, U^-1) into ``invs[inv_ids]``
    ([levels, 2, nb, nb]).  ``ids`` and ``inv_ids`` are distinct int32
    tensors on the store's device.  A launch counts as a K1 launch.  On
    the CPU the plain version, :func:`kernels_torch.getrf_with_inverses`."""
    if tol is None:
        tol = kt.DEFAULT_TOL[tiles.dtype]
    if not kc._on_cuda(tiles):
        i, j = ids.long(), inv_ids.long()
        f, linv, uinv = kt.getrf_with_inverses(tiles[i], tol)
        tiles[i] = f
        invs[j, 0], invs[j, 1] = linv, uinv
        return
    s = kc._dtype_of(tiles)
    dev = tiles.device
    nt, nb = tiles.shape[0], tiles.shape[-1]
    kt.check_nb(nb)
    kc._check_tensor("tiles", tiles, tiles.dtype, (nt, nb, nb), dev)
    kc._check_tensor("invs", invs, tiles.dtype, (invs.shape[0], 2, nb, nb),
                     dev)
    batch = len(ids)
    for name, t, hi in (("ids", ids, nt - 1),
                        ("inv_ids", inv_ids, invs.shape[0] - 1)):
        kc._check_tensor(name, t, torch.int32, (batch,), dev)
        host = t.cpu().numpy()
        kc._check_table(name, host, 0, hi)
        if len(np.unique(host)) != batch:
            raise ValueError(f"{name} repeat")
    if batch:
        k1 = (ctypes.c_int * 2)()
        kc._call(getattr(kc.library().lib, f"plu_diag_step_{s}"), dev.index,
                 tiles.data_ptr(), invs.data_ptr(), ids.data_ptr(),
                 inv_ids.data_ptr(), batch, nb, float(tol), k1,
                 kc._stream(dev))
        kc._count_k1(k1)


def compressed_launches(schedule, factorizations: int = 0, solves: int = 0,
                        reloads: int = 0, complex_tiles: bool = False) -> dict:
    """The kernel launches of ``CompressedLU`` only (the keys of
    ``kernels_cuda.LAUNCHES`` it uses) for that many factorizations,
    solves (one ``solve_blocked`` call each) and first solves of a
    reloaded store, from the level structure: a factorization launches
    K1 once a level (at every nb; none for complex tiles, whose
    diagonal step is ``kernels_xla``'s) and decompresses and compresses
    the diagonal tile and each non-empty L panel, U panel and update
    batch; a solve decompresses each non-empty L panel (forward) and U
    column panel (backward); a reloaded store first decompresses its
    diagonal tiles in one batch and forms their inverses in one P2
    launch (complex tiles: by the plain doubling, no launch).  The
    public route on the card factors at float32 and nb 128 or 256 with
    ``PanelLU``, whose launches :func:`panel_launches` gives."""
    lv = schedule.levels
    stage = sum(1 + (len(v.lpanel) > 0) + (len(v.upanel) > 0)
                + (len(v.upd_dst) > 0) for v in lv)
    panels = sum((len(v.lpanel) > 0) + (len(v.ucolpanel) > 0) for v in lv)
    real = not complex_tiles
    return {"getrf_with_inverses": factorizations * len(lv) * real,
            "decompress_tiles": (factorizations * stage + solves * panels
                                 + reloads),
            "compress_tiles": factorizations * stage,
            "newton_inverses": reloads * real}


def compressed_store(a, nb: int, dtype: str = "r64", ordering: str = "rcm",
                     device="cpu"):
    """(handle, store): ``a`` through ``init`` on the CPU at ``nb`` and
    ``dtype`` (a complex dtype keeps complex tiles, complex_mode
    "native"), and the :class:`~pangulu_tpu_torch.compressed.
    CompressedTiles` store of its reordered matrix on ``device`` (at nb
    > 256 its positions are uint32)."""
    from pangulu_tpu_torch import api
    from pangulu_tpu_torch.compressed import CompressedTiles

    h = api.init(a, api.InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                    device="cpu", complex_mode="native"))
    return h, CompressedTiles(h.blocked, h.reordering.reordered,
                              device=device)


def panel_launches(plu, solves: int = 0, reloads: int = 0) -> dict:
    """The kernel launches of ``PanelLU``'s last factorization
    (``plu.panel_cols`` and each panel's out-update chunks), then that
    many solves and first solves of a reloaded store
    (:func:`compressed_launches`, whose solve the store's solve is): K2
    once a panel, K1 once a level (inside K2), P6 decompress once a panel
    (its cross) and once an out-update chunk (its destinations), P6
    compress the same."""
    steps = sum(1 + len(plu._pass(c0, c1).chunks)
                for c0, c1 in plu.panel_cols)
    out = compressed_launches(plu.schedule, solves=solves, reloads=reloads)
    out.update(mega_factorize=len(plu.panel_cols),
               getrf_with_inverses=sum(c1 - c0 for c0, c1 in plu.panel_cols),
               decompress_tiles=out["decompress_tiles"] + steps,
               compress_tiles=steps)
    return out


def offset_copy(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of ``t`` on its device whose data starts
    ``nbytes`` past a 64-byte boundary (a view into a byte buffer, as
    memory from outside PyTorch may be): P6's slot arrays off the
    alignment of their vector loads."""
    n = t.numel() * t.element_size()
    raw = torch.empty(n + 128, dtype=torch.uint8, device=t.device)
    at = (-raw.data_ptr()) % 64 + nbytes
    out = torch.empty(0, dtype=t.dtype, device=t.device).set_(
        raw.untyped_storage()[at:at + n], 0, t.shape,
        torch.empty(t.shape, device="meta").stride())
    # byte for byte: PyTorch's own kernels may load a word whole
    out.reshape(-1).view(torch.uint8).copy_(
        t.contiguous().reshape(-1).view(torch.uint8))
    assert out.data_ptr() % 64 == nbytes and out.is_contiguous()
    return out


def with_imaginary_parts(a, seed: int = 0):
    """``a`` (a real CscMatrix) as a complex128 CscMatrix of the same
    pattern: imaginary part +1 on the diagonal and 0.1 U(-1, 1) on every
    stored off-diagonal entry, drawn from ``np.random.default_rng(seed)``
    in storage order.  On a Poisson stencil this is a damped
    frequency-domain (Helmholtz-type) operator, strictly diagonally
    dominant in modulus (|6 + 1i| = 6.08 against at most 6 x 1.005 in
    3D), so the unpivoted factorization is stable."""
    from pangulu_tpu_torch.sparse import IDX_DTYPE, CscMatrix

    cols = np.repeat(np.arange(a.n, dtype=IDX_DTYPE), np.diff(a.colptr))
    off = a.rowidx != cols
    im = np.ones(len(a.values))
    im[off] = 0.1 * np.random.default_rng(seed).uniform(-1.0, 1.0,
                                                        int(off.sum()))
    return CscMatrix(a.n, a.colptr.copy(), a.rowidx.copy(),
                     a.values.astype(np.float64) + 1j * im)


def probe_inputs(seed: int = 0, nb: int = 128):
    """The inputs of the TPU probes P4 and P5 (tools/exp_scan_multi.py
    and tools/exp_overlap.py main), drawn with numpy: a = I + 0.01 z and
    b = 0.01 z, float32 [nb, nb], one standard normal z for both (the
    probes draw a and b from one key).  a's spectral radius is ~1.1 at
    nb = 128 (1.104 for seed 0), so the chain of products a^s b reaches
    ~5e9 at s = 256 and leaves float32's range long before the probes'
    2048 and 4096 steps."""
    z = np.random.default_rng(seed).standard_normal((nb, nb))
    z = z.astype(np.float32)
    a = np.eye(nb, dtype=np.float32) + np.float32(0.01) * z
    return a, np.float32(0.01) * z


def newton_inputs(g: int, nb: int, seed: int = 0) -> np.ndarray:
    """P3's input (tools/exp_batched_scan.py main): g unit lower
    triangles I + tril(z, -1), float32 [g, nb, nb], z standard normal."""
    z = np.random.default_rng(seed).standard_normal((g, nb, nb))
    return (np.tril(z, -1) + np.eye(nb)).astype(np.float32)


def newton_mixed_inputs(g: int, nb: int, seed: int = 0) -> np.ndarray:
    """newton_inputs with member 1 (g >= 2) a general matrix I + E, E
    dense with ||E|| ~ 0.6 (0.3 z / sqrt(nb)): no triangle, so P3's
    kernel takes full products for it and the triangles' skip for the
    others, in one launch; X <- X (2I - L X) converges on it (the
    spectral radius of (I - L)^2 is below 1)."""
    lm = newton_inputs(g, nb, seed)
    z = np.random.default_rng(seed + 1).standard_normal((nb, nb))
    lm[1] = (np.eye(nb) + 0.3 / np.sqrt(nb) * z).astype(np.float32)
    return lm
