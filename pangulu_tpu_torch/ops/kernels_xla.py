"""The block kernels the JAX package runs in XLA, as PyTorch ops.

Counterpart of ``pangulu_tpu.ops.kernels_jax`` (the reference's four
block kernels, pangulu_platform_0100000.c:57-397, on dense nb x nb
tiles), the kernels of the ``"torch"`` backend
(:mod:`pangulu_tpu_torch.ops.interface`):

  * :func:`getrf` — unpivoted LU of a diagonal tile, recursive on
    halves down to :data:`_BASE`, the tiny-pivot rule at each step;
  * :func:`tstrf` / :func:`gessm` — the panel solves ``X·U = B`` and
    ``L·X = B`` (``torch.linalg.solve_triangular``);
  * :func:`ssssm` — the Schur update ``C - A·B``;
  * :func:`diag_inverses` — (L^-1, U^-1) of a factored tile;
  * :func:`getrf_with_inverses` — (f, L^-1, U^-1) by the same recursion,
    the parent inverses assembled from the halves' by products, with
    rank-1 LU and Newton-Schulz inverses at the base;
  * :func:`spmv_sub` / :func:`vecadd`.

The triangular solves of one tile (:func:`trsv_lower_unit`,
:func:`trsv_upper`) and the Newton-Schulz inverses are those of
:mod:`pangulu_tpu_torch.ops.kernels_torch`.  Every function takes
real or complex tiles, one ``[m, m]`` or a batch ``[..., m, m]``.  On a
CUDA device they run as PyTorch's own kernels: the JAX package runs
them in XLA, behind no Pallas kernel, so no hand kernel replaces them.
"""

from __future__ import annotations

import torch

from pangulu_tpu_torch.ops.kernels_torch import (DEFAULT_TOL,
                                                 trsv_lower_unit, trsv_upper,
                                                 unit_lower_inv_newton,
                                                 upper_inv_newton)
from pangulu_tpu_torch.ops.kernels_torch import wide_split as _split

__all__ = ["DEFAULT_TOL", "getrf", "getrf_batched", "tstrf", "gessm",
           "ssssm", "trsv_lower_unit", "trsv_upper", "diag_inverses",
           "getrf_with_inverses", "spmv_sub", "vecadd"]

_BASE = 32  # the recursion's base case (pangulu_tpu/ops/kernels_jax.py:40)


def _safe_pivot(d: torch.Tensor, tol: float) -> torch.Tensor:
    """|d| < tol -> +tol (the reference's PANGULU_TOL substitution)."""
    return torch.where(d.abs() < tol, torch.full_like(d, tol), d)


def _getrf_unblocked(a: torch.Tensor, tol: float) -> torch.Tensor:
    """Doolittle LU of a small tile by rank-1 updates."""
    f = a.clone()
    for k in range(f.shape[-1]):
        piv = _safe_pivot(f[..., k, k], tol)
        f[..., k, k] = piv
        lcol = f[..., k + 1:, k] / piv[..., None]
        f[..., k + 1:, k] = lcol
        f[..., k + 1:, k + 1:] -= lcol[..., :, None] * f[..., k:k + 1, k + 1:]
    return f


def getrf(a: torch.Tensor, tol: float | None = None) -> torch.Tensor:
    """Unpivoted LU of a tile: L\\U packed (unit-diagonal L strictly
    below, U on and above the diagonal)."""
    if tol is None:
        tol = DEFAULT_TOL[a.dtype]
    m = a.shape[-1]
    if m <= _BASE:
        return _getrf_unblocked(a, tol)
    m1 = _split(m)
    f11 = getrf(a[..., :m1, :m1], tol)
    u12 = gessm(f11, a[..., :m1, m1:])
    l21 = tstrf(f11, a[..., m1:, :m1])
    f22 = getrf(a[..., m1:, m1:] - l21 @ u12, tol)
    return torch.cat([torch.cat([f11, u12], -1), torch.cat([l21, f22], -1)],
                     -2)


def getrf_batched(tiles: torch.Tensor, tol: float | None = None):
    """:func:`getrf` of each tile of ``tiles`` [B, m, m]."""
    return getrf(tiles, tol)


def tstrf(diag: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L-panel solve X·U = B, U = triu(diag) (pangulu_platform_0100000.c:
    137-175); batched over the leading dims."""
    return torch.linalg.solve_triangular(diag, b, upper=True, left=False)


def gessm(diag: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """U-panel solve L·X = B, L = unit_tril(diag)
    (pangulu_platform_0100000.c:178-209)."""
    return torch.linalg.solve_triangular(diag, b, upper=False,
                                         unitriangular=True)


def ssssm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Schur update C - A·B (pangulu_platform_0100000.c:211-397)."""
    return c - a @ b


def diag_inverses(diag: torch.Tensor):
    """(L^-1, U^-1) of a factored tile by triangular solves against I."""
    eye = torch.eye(diag.shape[-1], dtype=diag.dtype,
                    device=diag.device).expand_as(diag)
    linv = torch.linalg.solve_triangular(diag, eye, upper=False,
                                         unitriangular=True)
    uinv = torch.linalg.solve_triangular(diag, eye, upper=True)
    return linv, uinv


def getrf_with_inverses(a: torch.Tensor, tol: float | None = None):
    """(f, L^-1, U^-1) of a tile (pangulu_tpu/ops/kernels_jax.py:
    200-248): the recursion of :func:`getrf` with the panel solves as
    products against the first half's inverses, and the parent inverses

        L^-1 = [[L11^-1, 0], [-L22^-1 L21 L11^-1, L22^-1]]
        U^-1 = [[U11^-1, -U11^-1 U12 U22^-1], [0, U22^-1]]

    with the rank-1 LU and the Newton-Schulz inverses at the base."""
    if tol is None:
        tol = DEFAULT_TOL[a.dtype]
    m = a.shape[-1]
    if m <= _BASE:
        f = _getrf_unblocked(a, tol)
        return f, unit_lower_inv_newton(f), upper_inv_newton(f, tol)
    m1 = _split(m)
    f11, li11, ui11 = getrf_with_inverses(a[..., :m1, :m1], tol)
    u12 = li11 @ a[..., :m1, m1:]
    l21 = a[..., m1:, :m1] @ ui11
    f22, li22, ui22 = getrf_with_inverses(a[..., m1:, m1:] - l21 @ u12, tol)
    z12 = torch.zeros_like(u12)
    z21 = torch.zeros_like(l21)
    f = torch.cat([torch.cat([f11, u12], -1), torch.cat([l21, f22], -1)], -2)
    linv = torch.cat([torch.cat([li11, z12], -1),
                      torch.cat([-(li22 @ (l21 @ li11)), li22], -1)], -2)
    uinv = torch.cat([torch.cat([ui11, -(ui11 @ (u12 @ ui22))], -1),
                      torch.cat([z21, ui22], -1)], -2)
    return f, linv, uinv


def spmv_sub(y: torch.Tensor, a: torch.Tensor, x: torch.Tensor):
    """y - A·x (pangulu_platform_0100000.c:435-453)."""
    return y - a @ x


def vecadd(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y + x (pangulu_platform_0100000.c:455-464)."""
    return y + x
