"""Blocked sparse triangular solves (SpTRSV) — the gstrs path.

Counterpart of ``pangulu_sptrsv.c`` and of
``pangulu_tpu.sptrsv.TriangularSolver._solve_mega``: the forward sweep
on L (unit diagonal), then the backward sweep on U, both as products
with the per-level triangle inverses that the factorization persisted,
in one call of an engine in :mod:`ops.kernels_cuda` (the hand-written
CUDA kernel on a CUDA device, the plain version on the CPU):
:func:`~ops.kernels_cuda.mega_solve` level by level (``"mega"``), or
:func:`~ops.kernels_cuda.mega_solve_groups` over super-level groups
(``"mega_group"``), picked by the factorizer's rule
(``pangulu_tpu/sptrsv.py:371-386``) when ``dispatch="auto"``.  The
inverses are indexed by level, so either factorization engine feeds
either solve.

Multi-RHS is first-class: the kernel carries ``x`` as
``[nrhs, bl+1, nb]`` (the +1 segment is the scratch segment that padded
table entries point to).  The JAX package capped the batch by the TPU's
VMEM; the port has no such cap.
"""

from __future__ import annotations

import numpy as np
import torch

from pangulu_tpu_torch.blocks import BlockedMatrix
from pangulu_tpu_torch.numeric import (LUFactorizer, groups_worthwhile,
                                       pick_engine)
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops.kernels_torch import DEFAULT_TOL, KernelTables
from pangulu_tpu_torch.schedule import Schedule
from pangulu_tpu_torch.utils.log import get_logger
from pangulu_tpu_torch.utils.perf import PerfCounters, device_sync

log = get_logger()


class TriangularSolver:
    """gstrs executor over factored tiles on ``device``."""

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule,
                 perf: PerfCounters | None = None, device="cpu",
                 inv_tiles: torch.Tensor | None = None,
                 dispatch: str = "auto"):
        self.blocked = blocked
        self.schedule = schedule
        self.perf = perf or PerfCounters()
        self.device = torch.device(device)
        # triangle inverses persisted by the factorization; recomputed
        # by _ensure_inverses for checkpoint-loaded factors
        self.inv_tiles = inv_tiles
        self.dispatch, why = pick_engine(dispatch, schedule,
                                         LUFactorizer.GROUP_GMAX)
        nt = blocked.num_tiles
        if self.dispatch == "mega_group":
            tables = schedule.group_solve_tables(
                nt, gmax=LUFactorizer.GROUP_GMAX)
            why += (f"; {schedule.block_length} levels -> "
                    f"{tables['ngroups']} groups")
        else:
            tables = schedule.mega_solve_tables(nt)
        log.info("solve engine: %s (%s)", self.dispatch, why)
        self.tables = KernelTables.build(tables, self.device)
        self.perf.kernels["solve_engine"] = self.dispatch

    def _solve_group_worthwhile(self) -> bool:
        return groups_worthwhile(self.schedule, LUFactorizer.GROUP_GMAX)

    def blockify_rhs(self, b: np.ndarray) -> torch.Tensor:
        """[n] or [n, nrhs] -> [bl+1, nb, nrhs] padded segments."""
        bl, nb = self.schedule.block_length, self.schedule.nb
        b = np.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        nrhs = b.shape[1]
        xb = np.zeros((bl + 1, nb, nrhs), dtype=self.blocked.dtype)
        flat = xb[:bl].reshape(bl * nb, nrhs)
        flat[: b.shape[0]] = b
        return torch.from_numpy(xb).to(self.device)

    def unblockify(self, xb: torch.Tensor) -> np.ndarray:
        """[bl+1, nb, nrhs] -> [n, nrhs] on the host."""
        bl, nb = self.schedule.block_length, self.schedule.nb
        return xb[:bl].reshape(bl * nb, -1)[: self.blocked.n].cpu().numpy()

    def _ensure_inverses(self, tiles: torch.Tensor) -> torch.Tensor:
        """Triangle inverses for every level, computed from the packed
        factors when the factorization did not persist them (e.g. a
        checkpoint-loaded handle).  They have no cross-level dependency:
        one batched triangular solve against I over all diagonal tiles
        (plain PyTorch, as the JAX package computes them outside its
        kernels, ``pangulu_tpu/sptrsv.py:294-320``)."""
        if self.inv_tiles is not None:
            return self.inv_tiles
        diag_ids = torch.as_tensor(
            np.array([lev.diag for lev in self.schedule.levels]),
            device=tiles.device)
        f = tiles[diag_ids]
        tol = DEFAULT_TOL[f.dtype]
        d = torch.diagonal(f, dim1=-2, dim2=-1)
        safe = torch.where(d.abs() < tol, torch.full_like(d, tol), d)
        f = f + torch.diag_embed(safe - d)
        eye = torch.eye(f.shape[-1], dtype=f.dtype,
                        device=f.device).expand_as(f)
        linv = torch.linalg.solve_triangular(f, eye, upper=False,
                                             unitriangular=True)
        uinv = torch.linalg.solve_triangular(f, eye, upper=True)
        self.inv_tiles = torch.stack([linv, uinv], dim=1).contiguous()
        return self.inv_tiles

    def solve_blocked(self, tiles: torch.Tensor,
                      xb: torch.Tensor) -> torch.Tensor:
        """Device-resident solve of an already blocked rhs
        ``[bl+1, nb, nrhs]`` (see :meth:`blockify_rhs`); returns the
        solution in the same layout without synchronising."""
        invs = self._ensure_inverses(tiles)
        xt = xb.permute(2, 0, 1).contiguous()      # [nrhs, bl+1, nb]
        engine = (kernels_cuda.mega_solve_groups
                  if self.dispatch == "mega_group"
                  else kernels_cuda.mega_solve)
        xt = engine(xt, tiles, invs, self.tables, nb=self.schedule.nb,
                    bl=self.schedule.block_length)
        return xt.permute(1, 2, 0)

    def solve(self, tiles: torch.Tensor, b: np.ndarray) -> np.ndarray:
        """Solve LU x = b on the factored tiles.  Returns x with the
        same leading shape as b (pangulu_solve, pangulu_sptrsv.c:176)."""
        squeeze = np.asarray(b).ndim == 1
        xb = self.blockify_rhs(b)
        with self.perf.phase("sptrsv"):
            x = self.solve_blocked(tiles, xb)
            device_sync(self.device)
        out = self.unblockify(x)
        return out[:, 0] if squeeze else out
