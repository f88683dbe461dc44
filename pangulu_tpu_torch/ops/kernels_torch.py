"""Plain PyTorch versions of the port's kernels.

Counterpart of ``pangulu_tpu.ops.kernels_jax`` plus the reference
semantics of the JAX package's Pallas kernels
(``pangulu_tpu/ops/kernels_pallas.py``):

  * :func:`getrf_with_inverses` — unpivoted LU of a diagonal tile with
    the tiny-pivot rule, plus L^-1 (unit lower) and U^-1;
  * :func:`mega_factorize` — the whole numeric factorization over the
    level schedule (``Schedule.mega_tables``);
  * :func:`mega_solve` — the forward then backward block solve against
    the persisted triangle inverses (``Schedule.mega_solve_tables``);
  * :func:`mega_factorize_groups` / :func:`mega_solve_groups` — the same
    two over super-level groups of independent columns
    (``Schedule.group_mega_tables`` / ``group_solve_tables``), the
    engines of nested-dissection schedules;
  * :func:`decompress_tiles` / :func:`compress_tiles` — a batch of tiles
    of the compressed tile store to dense and back (the TPU probe
    ``tools/exp_scatter.py``'s scatter and gather modes);
  * :func:`triangle_inverses` — L^-1 and U^-1 of a batch of factored
    diagonal tiles by Gauss–Jordan sweeps, P2's kernel step for step;
    :func:`newton_inverses` — the same function by Newton–Schulz
    doubling, the JAX package's method (``tools/exp_batched_scan.py``
    batched_newton, and ``pangulu_tpu/ops/kernels_jax.py``
    unit_lower_inv_newton / upper_inv_newton);
  * :func:`trsv_lower_unit` / :func:`trsv_upper` — the diagonal-tile
    solves of the distributed solve (``pangulu_tpu/ops/kernels_jax.py:
    116-140``, XLA there, no Pallas kernel), as
    ``torch.linalg.solve_triangular``; :func:`true_f32_matmul` keeps
    ``torch.matmul`` in full float32 around the distributed engines;
  * the TPU probes that lie on no path of the solver, each the function
    its probe computes: :func:`scan_overlap` (``tools/exp_overlap.py``
    run, P5: a scan chain beside a chain of products),
    :func:`scan_multi` (``tools/exp_scan_multi.py`` run, P4: Q scan
    chains, optionally beside one chain of products) and
    :func:`newton_loop` (``tools/exp_batched_scan.py`` newton_loop, P3).

These run on any device.  The CPU tests hold them against the JAX
package; ``chip_smoke.py`` holds the CUDA kernels
(``ops.kernels_cuda``) against them on the card.  Matrix products here
go to ``torch.matmul``, which must stay in full float32 on a CUDA
device: ``torch.backends.cuda.matmul.allow_tf32`` is False by default,
and the entry points that compare against these versions on the card
(``chip_smoke.py``, ``tests/test_torch_gpu.py``) set it so.  TF32
truncates the inputs to 10 mantissa bits, which the JAX package
measured as a 1e4-fold worse backward error
(``pangulu_tpu/numeric.py:309-314``).  The CUDA kernels' f32 products
use three TF32 terms instead (3xTF32, ``csrc/tile_gemm.cuh``), which
:func:`tf32x3_matmul` emulates for the CPU tests.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from pangulu_tpu_torch.schedule import group_update_lists

# The reference substitutes a tolerance for tiny diagonal pivots
# (pangulu_common.h:133 PANGULU_TOL), scaled here by dtype as in
# pangulu_tpu/ops/kernels_jax.py:33-38: |piv| < tol -> +tol (for a
# complex pivot, |piv| is its modulus and +tol is real).
DEFAULT_TOL = {torch.float32: 1e-8, torch.float64: 1e-16,
               torch.complex64: 1e-8, torch.complex128: 1e-16}

# Largest tile of the CUDA kernels that keep a limit: K2-K5.
# K1 keeps a tile of nb <= 128 in registers (instances for nb <= 32, 64
# and 128, csrc/tile_lu.cuh) and factors 128 < nb <= 256 on a thread
# block cluster that holds the tile in shared memory, in panels of
# LU_PANEL columns (getrf_with_inverses_blocked is its plain twin); the
# products of K2 and K4 have shared-memory windows for nb <= 128 and for
# nb <= 256 (csrc/lu_kernels.cu).  K1 takes wider tiles: up to
# WIDE_LEAF on one thread block cluster a tile, in the same panels
# (getrf_with_inverses_blocked is its plain twin too), and above by a
# recursion on halves of at most WIDE_LEAF (k1_wide, csrc/wide_lu.cuh);
# the engines that run it there are the fused and levels engines
# (numeric.py), the compressed store and the multi-device engine.  The
# compressed store's kernels P6 and P2 take any nb up to STORE_MAX_NB.
MAX_NB = 256

# Widest tile of the compressed store: its in-tile positions are uint32
# at most, with the sentinel nb*nb, and the JAX package takes nb <= 65535
# there (pangulu_tpu/compressed.py:94-100), the reference's u16 block
# indices' range (pangulu_common.h:54-65).
STORE_MAX_NB = 65535

# The widest tile K1's cluster kernel for wide tiles takes in one launch
# (csrc/wide_lu.cuh kWideLeaf).
WIDE_LEAF = 512

# K1's largest register tile: the blocked step takes the tiles above it,
# and P2 (triangle_inverses) splits them into blocks of this width.
LU_SPLIT = 128

# Panel width of K1's blocked step: the TPU kernel's MXU mode
# (pangulu_tpu/ops/kernels_pallas.py _lu_blocked, r = 32).
LU_PANEL = 32

# Schur-update chunk width of Schedule.mega_tables at nb <= 128.  It
# sized the TPU kernel's VMEM buffer (pangulu_tpu/ops/kernels_pallas.py:
# 643); the port keeps it so its tables stay bit-identical to the JAX
# package's.  mega_uch gives it for every nb.
MEGA_UCH = 64


def mega_uch(nb: int) -> int:
    """Schur-update chunk width for tiles of ``nb``: 64 up to nb=128,
    else as many tiles as fill 4 MiB of f32, at least 8 (16 at nb=256).
    A copy of pangulu_tpu/ops/kernels_pallas.py:646-649 (mega_uch), so
    that the tables stay bit-identical to the JAX package's at every
    nb; the port's kernels take any chunk width."""
    if nb <= 128:
        return MEGA_UCH
    return max(4 * 1024 * 1024 // (nb * nb * 4), 8)


@dataclasses.dataclass
class KernelTables:
    """Index tables of one schedule, on the host and on the device.

    ``host`` is the numpy dict the schedule built (the per-level counts
    are read from it, so no level loop reads the device); ``dev`` holds
    the same int32 arrays as tensors on the device, shipped once.
    ``views`` caches what a CUDA wrapper derives from them once (the
    grouped kernels' per-destination and per-row lists)."""

    host: dict
    dev: dict
    views: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, tables: dict, device) -> "KernelTables":
        dev = {k: torch.as_tensor(np.ascontiguousarray(v, np.int32),
                                  device=device)
               for k, v in tables.items() if isinstance(v, np.ndarray)}
        return cls(host=tables, dev=dev)


def check_nb(nb: int) -> None:
    """The limit of K2-K5."""
    if nb > MAX_NB:
        raise ValueError(
            f"nb={nb} exceeds this kernel's limit nb <= {MAX_NB} (the "
            "products' and sweeps' shared-memory windows stop at nb=256; "
            "tiles wider than that run on the fused and levels engines)")


def check_store_nb(nb: int) -> None:
    """The limit of the compressed store and its kernels P6 and P2."""
    if not 1 <= nb <= STORE_MAX_NB:
        raise ValueError(
            f"the compressed store takes 1 <= nb <= {STORE_MAX_NB} (its "
            f"in-tile positions are uint32 with the sentinel nb*nb, as in "
            f"the JAX package), got nb={nb}")


def getrf_with_inverses(a: torch.Tensor, tol: float | None = None):
    """(f, L^-1, U^-1) of ``a`` ([nb, nb] or batched [B, nb, nb]).

    ``f`` packs the unit-lower L strictly below the diagonal and U on
    and above it.  Right-looking rank-1 elimination without pivoting; a
    pivot with |p| < tol is replaced by +tol and kept on U's diagonal
    (pangulu_tpu/ops/kernels_pallas.py:124-154, 444-461)."""
    if tol is None:
        tol = DEFAULT_TOL[a.dtype]
    single = a.dim() == 2
    f = (a[None] if single else a).clone()
    nb = f.shape[-1]
    for k in range(nb):
        piv = f[:, k, k]
        safe = torch.where(piv.abs() < tol, torch.full_like(piv, tol), piv)
        f[:, k, k] = safe
        lcol = f[:, k + 1:, k] / safe[:, None]
        f[:, k + 1:, k] = lcol
        f[:, k + 1:, k + 1:] -= lcol[:, :, None] * f[:, k:k + 1, k + 1:]
    eye = torch.eye(nb, dtype=f.dtype, device=f.device).expand_as(f)
    linv = torch.linalg.solve_triangular(f, eye, upper=False,
                                         unitriangular=True)
    uinv = torch.linalg.solve_triangular(f, eye, upper=True)
    if single:
        return f[0], linv[0], uinv[0]
    return f, linv, uinv


def getrf_with_inverses_blocked(a: torch.Tensor, tol: float | None = None,
                                r: int = LU_PANEL):
    """(f, L^-1, U^-1) of ``a`` ([nb, nb] or [B, nb, nb]) by the blocked
    right-looking step of the CUDA kernel for nb > 128 (the cluster
    kernel of csrc/lu_kernels.cu), in panels of ``r`` columns.  At the
    panel P = [k0, k1), with D the columns before it and B those after:

      1. ``(F11, L11^-1, U11^-1)`` of the trailing block's A11
         (:func:`getrf_with_inverses`);
      2. ``X[P, D] = L11^-1·X[P, D]`` and ``U12 = L11^-1·A12`` (the
         panel's rows);
      3. ``Y[D, P] = Y[D, P]·U11^-1`` and ``L21 = A21·U11^-1``;
      4. ``X[B, :k1] -= L21·X[P, :k1]`` (X[B, P] starts at 0), ``A22 -=
         L21·U12`` and ``Y[:k1, B] -= Y[:k1, P]·U12`` (Y[P, B] starts at
         0),

    where X becomes L^-1 and Y U^-1: the blocked form of K1's in-place
    Gauss–Jordan, which forms L^-1's columns and U^-1's rows as the LU
    advances.  In exact arithmetic it is :func:`getrf_with_inverses`,
    the reference semantics: the same pivots, and the tiny-pivot rule at
    the same step.  In floating point the products' sums run in another
    order (the JAX package's blocked LU at r = 32,
    pangulu_tpu/ops/kernels_pallas.py:261-300, is held to the scan at
    factor 3e-5 and inverses 2e-4 in f32, tests/test_pallas.py:79-99).
    The kernel forms the products on tensor cores (3xTF32 for float,
    DMMA for double) in this order."""
    if tol is None:
        tol = DEFAULT_TOL[a.dtype]
    nb = a.shape[-1]
    if not 0 < r < nb:
        raise ValueError(f"panel width r={r} must split nb={nb}")
    f = a.clone()
    x, y = torch.zeros_like(f), torch.zeros_like(f)
    for k0 in range(0, nb, r):
        k1 = min(k0 + r, nb)
        f11, l11i, u11i = getrf_with_inverses(f[..., k0:k1, k0:k1], tol)
        xpd = l11i @ x[..., k0:k1, :k0]
        u12 = l11i @ f[..., k0:k1, k1:]
        ydp = y[..., :k0, k0:k1] @ u11i
        l21 = f[..., k1:, k0:k1] @ u11i
        f[..., k0:k1, k0:k1] = f11
        f[..., k0:k1, k1:] = u12
        f[..., k1:, k0:k1] = l21
        x[..., k0:k1, :k0] = xpd
        x[..., k0:k1, k0:k1] = l11i
        y[..., :k0, k0:k1] = ydp
        y[..., k0:k1, k0:k1] = u11i
        x[..., k1:, :k1] -= l21 @ x[..., k0:k1, :k1]
        f[..., k1:, k1:] -= l21 @ u12
        y[..., :k1, k1:] -= y[..., :k1, k0:k1] @ u12
    return f, x, y


def wide_split(m: int) -> int:
    """Rows of the first half when a tile of ``m`` splits: the JAX
    package's ``_split`` (pangulu_tpu/ops/kernels_jax.py:54-57, base 32),
    about half, rounded up to a multiple of 32, and at most m - 32."""
    base = 32
    h = ((m + 1) // 2 + base - 1) // base * base
    return min(h, m - base) if m - h < base and m > base else h


def k1_leaf(a: torch.Tensor, tol: float):
    """K1's own step on a tile in floating point: the rank-1 scan up to
    LU_SPLIT, the blocked step of panels of LU_PANEL above (the plain
    twins of the register and the cluster kernels)."""
    if a.shape[-1] <= LU_SPLIT:
        return getrf_with_inverses(a, tol)
    return getrf_with_inverses_blocked(a, tol)


def k1_wide(a: torch.Tensor, tol: float | None = None):
    """The plain twin of the CUDA K1 for nb > MAX_NB (csrc/wide_lu.cuh):
    the blocked step over the whole tile up to WIDE_LEAF, the recursion
    of :func:`getrf_with_inverses_wide` on such leaves above (at least
    224 wide, so :func:`k1_leaf` takes the blocked step on each)."""
    return getrf_with_inverses_wide(a, tol, leaf=k1_leaf, width=WIDE_LEAF)


def getrf_with_inverses_wide(a: torch.Tensor, tol: float | None = None,
                             leaf=getrf_with_inverses, width: int = MAX_NB):
    """(f, L^-1, U^-1) of ``a`` ([nb, nb] or [B, nb, nb]) for any nb, by
    the recursive block step of the JAX package's XLA diagonal step
    (pangulu_tpu/ops/kernels_jax.py:200-248): split at
    ``wide_split(nb)``,

      1. ``(F11, L11^-1, U11^-1)`` of A11 (recursively);
      2. ``U12 = L11^-1·A12`` and ``L21 = A21·U11^-1``;
      3. ``S22 = A22 - L21·U12``, and ``(F22, L22^-1, U22^-1)`` of it;
      4. ``L^-1[2, 1] = -L22^-1·(L21·L11^-1)`` and ``U^-1[1, 2] =
         -U11^-1·(U12·U22^-1)``,

    with ``leaf(a, tol)`` on the blocks of at most ``width`` (the JAX
    package recurses to 32 and takes the Newton inverses there).  The
    CUDA K1 for nb > MAX_NB runs these steps above WIDE_LEAF
    (csrc/wide_lu.cuh), on leaves of at most WIDE_LEAF
    (:func:`k1_wide`); the default leaf, the rank-1 scan, is the
    reference semantics.  The tiny-pivot rule holds in every leaf."""
    if tol is None:
        tol = DEFAULT_TOL[a.dtype]
    m = a.shape[-1]
    if m <= width:
        return leaf(a, tol)
    m1 = wide_split(m)
    a11, a12 = a[..., :m1, :m1], a[..., :m1, m1:]
    a21, a22 = a[..., m1:, :m1], a[..., m1:, m1:]
    f11, li11, ui11 = getrf_with_inverses_wide(a11, tol, leaf, width)
    u12 = li11 @ a12
    l21 = a21 @ ui11
    f22, li22, ui22 = getrf_with_inverses_wide(a22 - l21 @ u12, tol, leaf,
                                               width)
    f = torch.cat([torch.cat([f11, u12], -1), torch.cat([l21, f22], -1)],
                  -2)
    z12 = torch.zeros_like(a12)
    z21 = torch.zeros_like(a21)
    linv = torch.cat([torch.cat([li11, z12], -1),
                      torch.cat([-(li22 @ (l21 @ li11)), li22], -1)], -2)
    uinv = torch.cat([torch.cat([ui11, -(ui11 @ (u12 @ ui22))], -1),
                      torch.cat([z21, ui22], -1)], -2)
    return f, linv, uinv


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds:
    to nearest with ties away from zero, keeping 10 mantissa bits (the
    low 13 bits zero); inf and NaN pass through."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    # adding half of the dropped range to the magnitude bits and masking
    # rounds the magnitude half away from zero; the sign bit is kept
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (float32) as the CUDA kernels' tensor-core products form
    it: each operand splits into ``big = tf32(x)`` and ``small =
    tf32(x - big)``, and the product is ``small·big + big·small +
    big·big`` (small terms first; small·small dropped), each term an
    f32 matmul of TF32 values.  It emulates the split, not the tensor
    core's own rounding of its sums."""
    ab, bb = tf32_round(a), tf32_round(b)
    asm, bsm = tf32_round(a - ab), tf32_round(b - bb)
    return (torch.matmul(asm, bb) + torch.matmul(ab, bsm)) + torch.matmul(ab,
                                                                          bb)


def mega_factorize(tiles: torch.Tensor, tables: KernelTables, *, nb: int,
                   tol: float, bl: int, mm=torch.matmul):
    """Whole numeric factorization; returns ``(tiles, invs)``.

    ``tiles`` [num_tiles+1, nb, nb] is factored IN PLACE (the JAX
    package donated it, ``input_output_aliases={10: 0}``); ``invs``
    [bl, 2, nb, nb] holds each level's (L^-1, U^-1), indexed by level.
    Per level k: LU + inverses of the diagonal tile, L panels <- L·U^-1,
    U panels <- L^-1·U, then ``dst -= L_i·U_j`` for each Schur update
    (destinations are unique within a level).  ``mm`` forms the panel
    and Schur products (:func:`tf32x3_matmul` emulates the kernel's
    tensor-core scheme).  Chain-ahead tables
    (``Schedule.mega_tables(superlevel=True)``) list the levels in
    depth order; position k's inverses go to slot ``lev_tab[k]``, its
    original level, so the solves read them as they read the chain's.
    Nothing runs ahead here: in depth order one step after the other
    computes what the card computes with the diagonal steps ahead."""
    h, d = tables.host, tables.dev
    uch = h["uch"]
    slot = h["lev_tab"] if "lev_tab" in h else range(bl)
    invs = tiles.new_empty((bl, 2, nb, nb))
    for k in range(bl):
        dix = int(h["diag_tab"][k])
        f, linv, uinv = getrf_with_inverses(tiles[dix], tol)
        tiles[dix] = f
        invs[int(slot[k]), 0] = linv
        invs[int(slot[k]), 1] = uinv
        nl, nu, nup = (int(h[t][k]) for t in ("nl_tab", "nu_tab",
                                               "nup_tab"))
        lids = d["lid_tab"][k, :nl].long()
        uids = d["uid_tab"][k, :nu].long()
        if nl:
            tiles[lids] = mm(tiles[lids], uinv)
        if nu:
            tiles[uids] = mm(linv, tiles[uids])
        if nup:
            dst, ul, uu = (d[t][k, :, :uch].reshape(-1)[:nup].long()
                           for t in ("udst_tab", "udl_tab", "udu_tab"))
            tiles[dst] -= mm(tiles[lids[ul]], tiles[uids[uu]])
    return tiles, invs


def _members(off: np.ndarray, gs: int) -> np.ndarray:
    """Member index of each tile of a group's concatenated panel, from
    its offsets ``off[:gs+1]``."""
    return np.repeat(np.arange(gs), np.diff(off[:gs + 1]))


def mega_factorize_groups(tiles: torch.Tensor, tables: KernelTables, *,
                          nb: int, tol: float, bl: int, mm=torch.matmul):
    """Whole numeric factorization over super-level groups
    (``Schedule.group_mega_tables``); returns ``(tiles, invs)``.

    ``tiles`` is factored IN PLACE; ``invs`` [bl, 2, nb, nb] is indexed
    by the ORIGINAL level id (``glev_tab``), so the solves read it as
    they read the chain's.  Per group: LU + inverses of its members'
    diagonal tiles as one batch, each panel tile times ITS member's
    inverse, then ``dst -= L·U`` over the group's updates.  Members'
    updates may share a destination, so they are summed into it
    (``index_add_``), never assigned.  ``mm`` forms the products, as in
    :func:`mega_factorize`."""
    h, d = tables.host, tables.dev
    invs = tiles.new_empty((bl, 2, nb, nb))
    updates = group_update_lists(h)
    for g in range(int(h["ngroups"])):
        gs = int(h["gs_tab"][g])
        diag = d["gdiag_tab"][g, :gs].long()
        lev = d["glev_tab"][g, :gs].long()
        f, linv, uinv = getrf_with_inverses(tiles[diag], tol)
        tiles[diag] = f
        invs[lev, 0] = linv
        invs[lev, 1] = uinv
        lm = _members(h["gloff_tab"][g], gs)
        um = _members(h["guoff_tab"][g], gs)
        lids = d["lid_tab"][g, :len(lm)].long()
        uids = d["uid_tab"][g, :len(um)].long()
        if len(lm):
            tiles[lids] = mm(tiles[lids], uinv[lm])
        if len(um):
            tiles[uids] = mm(linv[um], tiles[uids])
        dst, ul, uu = (torch.as_tensor(a.astype(np.int64),
                                       device=tiles.device)
                       for a in updates[g])
        if len(dst):
            tiles.index_add_(0, dst, mm(tiles[lids[ul]], tiles[uids[uu]]),
                             alpha=-1)
    return tiles, invs


def mega_solve_groups(x: torch.Tensor, tiles: torch.Tensor,
                      invs: torch.Tensor, tables: KernelTables, *,
                      nb: int, bl: int) -> torch.Tensor:
    """Solve LU x = b for ``x`` [nrhs, bl+1, nb] over super-level groups
    (``Schedule.group_solve_tables``).  Forward over the groups in
    ascending order with ``invs[:, 0]``, backward in descending order
    with ``invs[:, 1]``.  Per group: each real member's segment
    ``x_k <- inv_k · x_k``, then ``x_r -= T · x_k(T)`` over the group's
    panel tiles, where rows shared by several members sum all their
    updates.  Returns a new tensor; the scratch segment ``bl`` is not
    touched."""
    h, d = tables.host, tables.dev
    x = x.clone()
    ng = int(h["ngroups"])
    for key, ntab, slot, groups in (("ltab", "nl_tab", 0, range(ng)),
                                    ("uctab", "nuc_tab", 1,
                                     reversed(range(ng)))):
        for g in groups:
            kseg = h["kseg_tab"][g]
            ks = torch.as_tensor(kseg[kseg != bl].astype(np.int64),
                                 device=x.device)
            xk = torch.einsum("rmj,mij->rmi", x[:, ks], invs[ks, slot])
            x[:, ks] = xk
            n = int(h[ntab][g])
            if n:
                ids, rows, mem = (d[key][g, i, :n].long() for i in range(3))
                upd = torch.einsum("rtj,tij->rti", xk[:, mem], tiles[ids])
                x.index_add_(1, rows, upd, alpha=-1)
    return x


def _solve_level(x, tiles, inv, k, n, ids, rows):
    """x_k <- x_k·inv^T, then x_r -= x_k·T^T for the level's n panel
    tiles T (pangulu_tpu/ops/kernels_pallas.py:2074-2108)."""
    xk = x[:, k] @ inv.T
    x[:, k] = xk
    if n:
        t = tiles[ids[k, :n].long()]
        x[:, rows[k, :n].long()] -= torch.einsum("rj,tij->rti", xk, t)


def mega_solve(x: torch.Tensor, tiles: torch.Tensor, invs: torch.Tensor,
               tables: KernelTables, *, nb: int, bl: int) -> torch.Tensor:
    """Solve LU x = b for ``x`` [nrhs, bl+1, nb] (segment ``bl`` is the
    scratch segment that padded table entries point to).  Forward sweep
    over the L panels with ``invs[:, 0]`` in ascending level order, then
    backward over the U column panels with ``invs[:, 1]`` descending.
    Returns a new tensor."""
    h, d = tables.host, tables.dev
    x = x.clone()
    for k in range(bl):
        _solve_level(x, tiles, invs[k, 0], k, int(h["nl_tab"][k]),
                     d["lid_tab"], d["lrow_tab"])
    for k in reversed(range(bl)):
        _solve_level(x, tiles, invs[k, 1], k, int(h["nuc_tab"][k]),
                     d["ucid_tab"], d["ucrow_tab"])
    return x


@dataclasses.dataclass(eq=False)
class Indices:
    """int32 indices on the host and the same on a device, shipped once.
    The plain versions read ``dev``; the CUDA wrappers check ``host``
    once for each store they index (``checked`` holds what was) and
    keep the launch geometry they derive from it in ``geometry``."""

    host: np.ndarray
    dev: torch.Tensor
    checked: set = dataclasses.field(default_factory=set)
    geometry: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, a, device) -> "Indices":
        host = np.ascontiguousarray(a, dtype=np.int32)
        return cls(host=host, dev=torch.as_tensor(host, device=device))

    def __len__(self) -> int:
        return len(self.host)


def slot_positions(idx: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``idx[pos]`` widened to int64.  torch's uint16 and uint32 take
    little arithmetic, so the slots are read through their signed view
    and masked back to the unsigned value."""
    view = {torch.uint16: (torch.int16, 0xFFFF),
            torch.uint32: (torch.int32, 0xFFFFFFFF)}
    if idx.dtype not in view:
        raise TypeError(f"slot indices are uint16 or uint32, got {idx.dtype}")
    signed, mask = view[idx.dtype]
    return idx.view(signed)[pos].to(torch.int64) & mask


def slot_ranges(off: Indices, cap: Indices, ids: Indices):
    """(slot position, in-range mask) [B, max cap] of the tiles ``ids``."""
    t = ids.dev.long()
    o, c = off.dev.long()[t], cap.dev.long()[t]
    width = int(cap.host[ids.host].max(initial=0))
    ar = torch.arange(width, device=o.device)
    return o[:, None] + ar[None, :], ar[None, :] < c[:, None]


def decompress_tiles(values: torch.Tensor, idx: torch.Tensor, off: Indices,
                     cap: Indices, ids: Indices, nb: int) -> torch.Tensor:
    """Dense [B, nb, nb] tiles ``ids`` of the compressed store
    (``pangulu_tpu/compressed.py:240-248`` gather): zeros, then
    ``dense[idx[s]] = values[s]`` for the tile's slots ``s`` in
    ``[off[t], off[t] + cap[t])``; a sentinel position (>= nb*nb) is
    dropped.  The scratch tile (cap 0) comes out zero."""
    nn = nb * nb
    pos, live = slot_ranges(off, cap, ids)
    p = torch.where(live, pos, 0)
    ix = torch.where(live, slot_positions(idx, p), nn).clamp_max(nn)
    dense = values.new_zeros((len(ids), nn + 1))
    dense.scatter_(1, ix, torch.where(live, values[p], 0))
    return dense[:, :nn].reshape(len(ids), nb, nb)


def compress_tiles(values: torch.Tensor, idx: torch.Tensor, off: Indices,
                   cap: Indices, ids: Indices, dense: torch.Tensor) -> None:
    """Write the dense tiles ``dense`` [B, nb, nb] back into the slots of
    tiles ``ids`` IN PLACE (``pangulu_tpu/compressed.py:250-258``
    scatter): ``values[s] = dense[idx[s]]`` for every real slot; sentinel
    slots and every slot of another tile are left as they are."""
    nb = dense.shape[-1]
    nn = nb * nb
    pos, live = slot_ranges(off, cap, ids)
    ix = slot_positions(idx, torch.where(live, pos, 0))
    live = live & (ix < nn)
    v = dense.reshape(len(ids), nn).gather(1, ix.clamp_max(nn - 1))
    values[pos[live]] = v[live]


def newton_steps(nb: int) -> int:
    """Doubling steps that make the Newton–Schulz inverse of a unit
    triangular nb x nb matrix exact: ceil(log2 nb) - 1."""
    return max((nb - 1).bit_length() - 1, 0)


def newton_loop(t: torch.Tensor, steps: int) -> torch.Tensor:
    """X <- X (2I - T X) from X = 2I - T, ``steps`` times, on each
    matrix of ``t`` [..., nb, nb] as given (P3,
    ``tools/exp_batched_scan.py`` newton_loop): for T = I + N with N
    nilpotent, T X_k = I - N^(2^(k+1))."""
    two = 2 * torch.eye(t.shape[-1], dtype=t.dtype, device=t.device)
    x = two - t
    for _ in range(steps):
        x = torch.matmul(x, two - torch.matmul(t, x))
    return x


def unit_lower_inv_newton(f: torch.Tensor) -> torch.Tensor:
    """Inverse of unit_tril(f) ([..., nb, nb]) by Newton–Schulz doubling
    (pangulu_tpu/ops/kernels_jax.py:158-177): exact after
    :func:`newton_steps` steps, not an approximation."""
    nb = f.shape[-1]
    eye = torch.eye(nb, dtype=f.dtype, device=f.device)
    return newton_loop(torch.tril(f, -1) + eye, newton_steps(nb))


def upper_inv_newton(f: torch.Tensor, tol: float) -> torch.Tensor:
    """Inverse of triu(f) with the tiny-pivot substitution (|d| < tol ->
    +tol) by the same doubling on U = D (I + M), M = D^-1 R strictly
    upper: U^-1 = (I + M)^-1 D^-1 (pangulu_tpu/ops/kernels_jax.py:
    180-197)."""
    nb = f.shape[-1]
    d = torch.diagonal(f, dim1=-2, dim2=-1)
    d = torch.where(d.abs() < tol, torch.full_like(d, tol), d)
    dinv = 1.0 / d
    eye = torch.eye(nb, dtype=f.dtype, device=f.device)
    x = newton_loop(eye + torch.triu(f, 1) * dinv[..., :, None],
                    newton_steps(nb))
    return x * dinv[..., None, :]


def newton_inverses(f: torch.Tensor, tol: float | None = None):
    """(L^-1, U^-1) of a batch [B, nb, nb] of factored diagonal tiles (L
    unit lower below the diagonal, U on and above it) by
    :func:`unit_lower_inv_newton` and :func:`upper_inv_newton`: the JAX
    package's method, kept as the parity anchor and as the yardstick of
    f32 accuracy (the CUDA kernel computes :func:`triangle_inverses`)."""
    if tol is None:
        tol = DEFAULT_TOL[f.dtype]
    return unit_lower_inv_newton(f), upper_inv_newton(f, tol)


def _triangle_sweeps(f: torch.Tensor, tol: float):
    """(L^-1, U^-1) of ``f`` [B, n, n] by the sweeps of P2's kernel, in
    f's dtype: L^-1 by forward Gauss–Jordan with the multipliers
    strict_lower(f) (step k: rows i > k, columns <= k, x_i -= l_ik x_k),
    U^-1 by backward Gauss–Jordan on triu(f) with its diagonal by the
    tiny-pivot rule (step k: row k divided by d_k, then eliminated from
    the rows above)."""
    n = f.shape[-1]
    eye = torch.eye(n, dtype=f.dtype, device=f.device).expand_as(f)
    x = eye.clone()
    for k in range(n - 1):
        x[:, k + 1:, :k + 1] -= f[:, k + 1:, k:k + 1] * x[:, k:k + 1, :k + 1]
    d = torch.diagonal(f, dim1=-2, dim2=-1)
    d = torch.where(d.abs() < tol, torch.full_like(d, tol), d)
    h = eye.clone()
    for k in reversed(range(n)):
        h[:, k, k:] = h[:, k, k:] / d[:, k, None]
        h[:, :k, k:] -= f[:, :k, k:k + 1] * h[:, k:k + 1, k:]
    return x, h


def triangle_split(m: int) -> int:
    """Rows of the first half where P2's tree splits a block of m >
    LU_SPLIT rows: half of its LU_SPLIT-wide blocks rounded up to a
    power of two (128 for m <= 256, 256 for 256 < m <= 512), so that
    every leaf is a LU_SPLIT-wide diagonal block (the last narrower) and
    each level of the tree is one launch of the kernel's products."""
    blocks = -(-m // LU_SPLIT)
    return LU_SPLIT << ((blocks - 1).bit_length() - 1)


def triangle_inverses(f: torch.Tensor, tol: float | None = None):
    """(L^-1, U^-1) of a batch [B, nb, nb] of factored diagonal tiles,
    the function of :func:`newton_inverses`, as P2's CUDA kernel
    computes it step for step: the sweeps of :func:`_triangle_sweeps` in
    float64, rounded once to f's dtype, on each LU_SPLIT-wide diagonal
    block, and above LU_SPLIT the off-diagonal blocks over the halves of
    :func:`triangle_split`, bottom-up, by two products in f's dtype, as
    the JAX package's recursion forms its parent inverses
    (``kernels_xla.getrf_with_inverses``):
    ``L^-1[2, 1] = L22^-1·(-L21·L11^-1)`` and ``U^-1[1, 2] =
    (-U11^-1·U12)·U22^-1``."""
    if tol is None:
        tol = DEFAULT_TOL[f.dtype]
    if f.dim() != 3 or f.shape[-1] != f.shape[-2]:
        raise ValueError(f"expected [B, nb, nb], got {tuple(f.shape)}")

    def inverses(a):
        m = a.shape[-1]
        if m <= LU_SPLIT:
            return [t.to(f.dtype) for t in _triangle_sweeps(a.double(),
                                                            tol)]
        h = triangle_split(m)
        l11, u11 = inverses(a[:, :h, :h])
        l22, u22 = inverses(a[:, h:, h:])
        linv, uinv = torch.zeros_like(a), torch.zeros_like(a)
        linv[:, :h, :h], linv[:, h:, h:] = l11, l22
        uinv[:, :h, :h], uinv[:, h:, h:] = u11, u22
        linv[:, h:, :h] = l22 @ -(a[:, h:, :h] @ l11)
        uinv[:, :h, h:] = -(u11 @ a[:, :h, h:]) @ u22
        return linv, uinv

    return tuple(inverses(f))


# ------------------------------------- the distributed engines' helpers


def trsv_lower_unit(diag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Forward substitution with the unit lower triangle of ``diag``
    ([..., nb, nb]; ``x`` [..., nb, nrhs]).  Reference in-block sptrsv:
    pangulu_platform_0100000.c:466-486."""
    return torch.linalg.solve_triangular(diag, x, upper=False,
                                         unitriangular=True)


def trsv_upper(diag: torch.Tensor, x: torch.Tensor,
               tol: float | None = None) -> torch.Tensor:
    """Backward substitution with the upper triangle of ``diag``, a
    diagonal entry with |d| < tol taken as +tol (the tiny-pivot rule,
    pangulu_platform_0100000.c:488-506)."""
    if tol is None:
        tol = DEFAULT_TOL[diag.dtype]
    d = torch.diagonal(diag, dim1=-2, dim2=-1)
    safe = torch.where(d.abs() < tol, torch.full_like(d, tol), d)
    return torch.linalg.solve_triangular(diag + torch.diag_embed(safe - d),
                                         x, upper=True)


@contextlib.contextmanager
def true_f32_matmul():
    """``torch.matmul`` in full float32 on a CUDA device inside the
    block (TF32 off, and restored after), as the JAX package runs its
    distributed engines under ``default_matmul_precision("highest")``."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# ------------------------------------------------ the TPU probes P4, P5

# The probes' tiny-pivot tolerance (tools/exp_overlap.py:27,
# tools/exp_scan_multi.py:24), whatever the dtype.
PROBE_TOL = 1e-8

# P5's modes: the probe's three, and "split", the same function as
# "both", which the CUDA kernel runs on warp-specialized warps.
OVERLAP_MODES = ("scan", "dots", "both", "split")

# P4's chain counts (tools/exp_scan_multi.py main).
SCAN_CHAINS = (1, 2, 4, 8)


def fma_f32(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """c + a * b for float32 tensors rounded once, as a fused
    multiply-add rounds.  The product is exact in float64; the sum is
    rounded to odd there (to nearest, then one step toward the exact sum
    when that lands on an even mantissa), and rounding that to float32
    is the correct rounding of the exact sum (53 bits >= 24 + 2)."""
    c, p = c.double(), a.double() * b.double()
    s = c + p
    bb = s - c
    err = (c - (s - bb)) + (p - bb)            # s + err == c + p exactly
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


def probe_scan_step(f: torch.Tensor, k: int, tol: float = PROBE_TOL):
    """One step of the TPU probes' masked rank-1 scan
    (``tools/exp_overlap.py:27-43``, ``tools/exp_scan_multi.py:24-39``)
    on ``f`` [nb, nb] at pivot ``k``: f[i, j] -= (f[i, k] / p) f[k, j]
    for i > k and j > k, p = f[k, k] with |p| < tol -> +tol.  The
    multipliers are not stored: row k, column k and everything above or
    left of them stay.  In float32 the update is one fused multiply-add
    (:func:`fma_f32`), as the JAX probe computes it on the CPU (XLA
    contracts it) and the CUDA kernels do; in float64 the product and
    the difference round apart."""
    nb = f.shape[-1]
    after = torch.arange(nb, device=f.device) > k
    piv = f[k, k]
    safe = torch.where(piv.abs() < tol, torch.full_like(piv, tol), piv)
    lcol = torch.where(after, f[:, k] / safe, 0)[:, None]
    urow = torch.where(after, f[k, :], 0)[None, :]
    if f.dtype == torch.float32:
        return fma_f32(f, -lcol, urow)
    return f - lcol * urow


def check_probe_inputs(a: torch.Tensor, b: torch.Tensor,
                       steps: int) -> None:
    """a and b of one shape [nb, nb], and steps >= 0."""
    if a.dim() != 2 or a.shape[0] != a.shape[1] or b.shape != a.shape:
        raise ValueError(f"expected a and b of one shape [nb, nb], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")


def scan_multi(a: torch.Tensor, b: torch.Tensor, q: int, with_dot: bool,
               steps: int) -> torch.Tensor:
    """P4 (``tools/exp_scan_multi.py`` run): the chains f_i = a + i, i <
    q, each through ``steps`` steps of :func:`probe_scan_step` at k =
    step mod nb, and, with ``with_dot``, acc <- a · acc from acc = b in
    the same steps; returns ((f_0 + f_1) + ...) + acc."""
    check_probe_inputs(a, b, steps)
    if q not in SCAN_CHAINS:
        raise ValueError(f"q must be one of {SCAN_CHAINS}, got {q}")
    nb = a.shape[-1]
    fs = [a + float(i) for i in range(q)]
    acc = b
    for s in range(steps):
        fs = [probe_scan_step(f, s % nb) for f in fs]
        if with_dot:
            acc = torch.matmul(a, acc)
    r = fs[0]
    for f in fs[1:]:
        r = r + f
    return r + acc


def scan_overlap(a: torch.Tensor, b: torch.Tensor, mode: str,
                 steps: int) -> torch.Tensor:
    """P5 (``tools/exp_overlap.py`` run): f = a through ``steps`` steps
    of :func:`probe_scan_step` (modes "scan", "both", "split") and acc
    <- a · acc from acc = b (modes "dots", "both", "split"); returns f +
    acc.  "split" is "both": only the CUDA kernel runs it differently."""
    if mode not in OVERLAP_MODES:
        raise ValueError(f"mode must be one of {OVERLAP_MODES}, got "
                         f"{mode!r}")
    check_probe_inputs(a, b, steps)
    if mode == "dots":
        acc = b
        for _ in range(steps):
            acc = torch.matmul(a, acc)
        return a + acc
    return scan_multi(a, b, 1, mode != "scan", steps)
