"""Blocked sparse triangular solves (SpTRSV) — the gstrs path.

Counterpart of ``pangulu_sptrsv.c`` and of ``pangulu_tpu.sptrsv``: the
forward sweep on L (unit diagonal), then the backward sweep on U.  For
real tiles of nb <= 256 (the mega engines) both run as products with the
per-level triangle inverses that the factorization persisted, in one
call of an engine in :mod:`ops.kernels_cuda` (the hand-written CUDA
kernel on a CUDA device, the plain version on the CPU):
:func:`~ops.kernels_cuda.mega_solve` level by level (``"mega"``), or
:func:`~ops.kernels_cuda.mega_solve_groups` over super-level groups
(``"mega_group"``), picked by the factorizer's rule
(``pangulu_tpu/sptrsv.py:371-386``) when ``dispatch="auto"``.  The
inverses are indexed by level, so either factorization engine feeds
either solve.  Elsewhere (nb > 256, complex tiles, ``backend="torch"``)
the ``"fused"`` and ``"levels"`` solves walk the levels on the host
(``pangulu_tpu/sptrsv.py:35-78``): per level a triangular solve of the
diagonal tile's segment (the backend's ``trsv_lower_unit`` /
``trsv_upper``), then ``x[rows] -= tiles[ids]·x[k]`` for the column's
panel, PyTorch ops as they are XLA in the JAX package.  A factor with
no persisted inverses (the level engines', ``"superfused"``'s, a
reloaded one) takes the solve ``auto`` picks too: where the mega solves
apply, on inverses that :meth:`TriangularSolver._ensure_inverses`
rebuilds, as the JAX package's solver does
(``pangulu_tpu/sptrsv.py:294-320, 347-360``).  The transpose solve
(:meth:`TriangularSolver.solve_trans`) runs as PyTorch ops too.

Multi-RHS is first-class: the kernel carries ``x`` as
``[nrhs, bl+1, nb]`` (the +1 segment is the scratch segment that padded
table entries point to).  The JAX package capped the batch by the TPU's
VMEM; the port has no such cap.
"""

from __future__ import annotations

import numpy as np
import torch

from pangulu_tpu_torch.blocks import BlockedMatrix
from pangulu_tpu_torch.numeric import (LEVEL_ENGINES, LevelTables,
                                       LUFactorizer, groups_worthwhile,
                                       pick_engine, resolve_backend)
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops.interface import KernelBackend
from pangulu_tpu_torch.ops.kernels_torch import (DEFAULT_TOL, KernelTables,
                                                 true_f32_matmul)
from pangulu_tpu_torch.schedule import Schedule
from pangulu_tpu_torch.utils.log import get_logger
from pangulu_tpu_torch.utils.perf import (PerfCounters, device_sync,
                                          resolve_device)

log = get_logger()


class TriangularSolver:
    """gstrs executor over factored tiles on ``device`` (``"cuda"``, the
    default, or ``"cpu"``, as :class:`~numeric.LUFactorizer`)."""

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule,
                 perf: PerfCounters | None = None, device="cuda",
                 inv_tiles: torch.Tensor | None = None,
                 dispatch: str = "auto", backend="auto"):
        self.blocked = blocked
        self.schedule = schedule
        self.perf = perf or PerfCounters()
        self.device = resolve_device(device)
        # triangle inverses persisted by the factorization; recomputed
        # by _ensure_inverses for checkpoint-loaded factors
        self.inv_tiles = inv_tiles
        dtype = blocked.torch_dtype
        if dispatch == "superfused":
            raise ValueError("dispatch='superfused' only factors (the JAX "
                             "package has no such solve)")
        self.backend = resolve_backend(backend, blocked.nb, dtype, None,
                                       self.device)
        self.dispatch, why = pick_engine(
            dispatch, schedule, LUFactorizer.GROUP_GMAX, dtype=dtype,
            backend=self.backend.name if isinstance(
                backend, KernelBackend) else backend)
        nt = blocked.num_tiles
        self.tables = self.levels = None
        if self.dispatch in LEVEL_ENGINES:
            why += f"; backend {self.backend.name}"
            self.levels = LevelTables(
                schedule, ("lpanel", "lrows", "ucolpanel", "ucolrows"),
                self.device)
        else:
            if self.dispatch == "mega_group":
                tables = schedule.group_solve_tables(
                    nt, gmax=LUFactorizer.GROUP_GMAX)
                why += (f"; {schedule.block_length} levels -> "
                        f"{tables['ngroups']} groups")
            else:
                tables = schedule.mega_solve_tables(nt)
            self.tables = KernelTables.build(tables, self.device)
        log.info("solve engine: %s (%s)", self.dispatch, why)
        self.perf.kernels["solve_engine"] = self.dispatch
        self._trans = None  # the transpose solve's tables, at first use

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

    def _solve_levels(self, tiles: torch.Tensor,
                      xb: torch.Tensor) -> torch.Tensor:
        """The fused and levels solves (pangulu_tpu/sptrsv.py:35-78): per
        level, forward, x_k = L_kk^-1 x_k by substitution, then x[rows]
        -= L[rows, k]·x_k over column k's panel below the diagonal;
        backward, in reverse, the same with U_kk (the tiny-pivot rule on
        its diagonal) and column k's tiles above it.  A level's rows are
        distinct.  Returns a new tensor."""
        be, t = self.backend, self.levels
        x = xb.clone()
        with true_f32_matmul():
            for sweep, ids, rows, order in (
                    (be.trsv_lower_unit, "lpanel", "lrows",
                     range(len(t.k))),
                    (be.trsv_upper, "ucolpanel", "ucolrows",
                     reversed(range(len(t.k))))):
                for i in order:
                    k = t.k[i]
                    xk = sweep(tiles[t.diag[i]], x[k])
                    x[k] = xk
                    if t.count(ids, i):
                        r = t.of(rows, i)
                        x[r] = be.spmv_sub(x[r], tiles[t.of(ids, i)], xk)
        return x

    def solve_blocked(self, tiles: torch.Tensor,
                      xb: torch.Tensor) -> torch.Tensor:
        """Device-resident solve of an already blocked rhs
        ``[bl+1, nb, nrhs]`` (see :meth:`blockify_rhs`); returns the
        solution in the same layout without synchronising."""
        if self.dispatch in LEVEL_ENGINES:
            return self._solve_levels(tiles, xb)
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

    def _trans_tables(self) -> dict:
        """Per sweep of the transpose solve, the tiles that each level
        reads and their block rows, flat on the device, with the level
        offsets on the host: the forward sweep on U^T reads column k's
        tiles above the diagonal (``Level.ucolpanel``), the backward
        sweep on L^T those below it (``Level.lpanel``)."""
        if self._trans is None:
            self._trans = {}
            for sweep, ids, rows in (("uc", "ucolpanel", "ucolrows"),
                                     ("l", "lpanel", "lrows")):
                per = [(getattr(lev, ids), getattr(lev, rows))
                       for lev in self.schedule.levels]
                off = np.cumsum([0] + [len(i) for i, _ in per])
                flat = (torch.as_tensor(
                    np.concatenate([p[j] for p in per]).astype(np.int64),
                    device=self.device) for j in (0, 1))
                self._trans[sweep] = (*flat, off)
        return self._trans

    def solve_blocked_trans(self, tiles: torch.Tensor,
                            xb: torch.Tensor) -> torch.Tensor:
        """Device-resident TRANSPOSE solve, (LU)^T x = b from the same
        factors (A^T = U^T L^T), of a blocked rhs ``[bl+1, nb, nrhs]``;
        returns a new tensor in that layout without synchronising.

        The counterpart of the JAX package's ``_fused_solve_trans``
        (``pangulu_tpu/sptrsv.py:82-110``), an XLA function that no
        Pallas kernel backs: PyTorch ops on the tiles' device, one level
        after the other.  Left-looking, so the column panels serve both
        sweeps: forward on U^T, level k gathers column k's tiles above
        the diagonal and their solved segments; backward on L^T, those
        below it.  A diagonal step is a product with the transposed
        persisted inverse ((U^-1)^T = (U^T)^-1).  Only each level's real
        panel entries are read, not the padded table rows."""
        invs = self._ensure_inverses(tiles)
        tabs = self._trans_tables()
        nb = self.schedule.nb
        x = xb.clone()
        nrhs = x.shape[-1]

        def level(k, slot, sweep):
            ids, rows, off = tabs[sweep]
            acc = x[k]
            if off[k + 1] > off[k]:
                s, e = int(off[k]), int(off[k + 1])
                t = tiles[ids[s:e]].reshape(-1, nb)      # [(b, j), i]
                acc = acc - t.T @ x[rows[s:e]].reshape(-1, nrhs)
            x[k] = invs[k, slot].T @ acc

        for k in range(self.schedule.block_length):       # U^T y = b
            level(k, 1, "uc")
        for k in reversed(range(self.schedule.block_length)):  # L^T x = y
            level(k, 0, "l")
        return x

    def solve_trans(self, tiles: torch.Tensor, b: np.ndarray) -> np.ndarray:
        """Solve (LU)^T x = b on the factored tiles (transpose solve — no
        reference equivalent; SuperLU-style trans surface)."""
        squeeze = np.asarray(b).ndim == 1
        xb = self.blockify_rhs(b)
        with self.perf.phase("sptrsv"):
            x = self.solve_blocked_trans(tiles, xb)
            device_sync(self.device)
        out = self.unblockify(x)
        return out[:, 0] if squeeze else out
