"""Distributed blocked triangular solves over a grid of ranks.

Counterpart of ``pangulu_tpu.parallel.dist_sptrsv`` (its f32/f64 solve,
pangulu_tpu/parallel/dist_sptrsv.py:45-188,336-377) and of the
reference's SpTRSV (pangulu_sptrsv.c:24-174), which reduces per-rank
partial sums onto the diagonal owner, solves the nb triangle there and
broadcasts the solved segment.  Here every rank holds every factored
diagonal tile (``DistributedLU.diag``), so every rank solves the
triangles itself and no broadcast follows: one all-reduce a group, as
the JAX package's double-float solve does with its replicated inverses
(pangulu_tpu/parallel/dist_sptrsv.py:190-279), where its f32/f64 solve
takes two.

The solution is additively sharded: every rank holds a partial x
``[bl+1, nb, nrhs]`` whose sum over the ranks is the true x (rank 0
starts with b, the others with zeros).  Per super-level group (the
factorization's groups of independent columns), on every rank:

  1. an all-reduce over the world of the group's segments (the
     reduce-to-owner);
  2. every rank solves the group's triangles
     (:func:`~pangulu_tpu_torch.ops.kernels_torch.trsv_lower_unit`
     forward, :func:`~pangulu_tpu_torch.ops.kernels_torch.trsv_upper`
     with the tiny-pivot rule backward); each diagonal tile's owner
     keeps the solved segment in its partial x, the others zero;
  3. the owners of the column's panel tiles subtract ``T(i,k)·x_k`` from
     their partial segments, one member (wave) at a time, so that each
     ``index_add_`` adds once a segment.

The backward sweep walks the groups in reverse; a final all-reduce over
the world makes x whole on every rank.  With complex tiles x is complex,
and its all-reduces sum the real views.  The double-float half of the JAX
solver is not ported (f64 is native on the H100).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pangulu_tpu_torch.blocks import BlockedMatrix
from pangulu_tpu_torch.ops.kernels_torch import (trsv_lower_unit, trsv_upper,
                                                 true_f32_matmul)
from pangulu_tpu_torch.parallel.dist_numeric import (DistLayout, Waves,
                                                     _index_putter,
                                                     dist_groups,
                                                     tables_digest)
from pangulu_tpu_torch.parallel.mesh import Grid
from pangulu_tpu_torch.schedule import Schedule
from pangulu_tpu_torch.utils.perf import PerfCounters, device_sync


def solve_tables(schedule: Schedule, layout: DistLayout) -> dict:
    """The JAX package's solve tables (pangulu_tpu/parallel/
    dist_sptrsv.py:75-134), bit for bit: the ``[p, q, ngr, ...]``
    tables diag_slot, l_slot, l_rows, uc_slot, uc_rows and the
    replicated kmat, kseg, l_msel, uc_msel."""
    lay, p, q = layout, layout.p, layout.q
    bl = schedule.block_length
    scratch_tile = lay.lmax - 1
    scratch_seg = bl  # x carries bl+1 segments
    groups = dist_groups(schedule)
    ngr = len(groups)
    G = max((len(g) for g in groups), default=1)
    NL = max(max((sum(len(schedule.levels[k].lpanel) for k in g)
                  for g in groups), default=0), 1)
    NUC = max(max((sum(len(schedule.levels[k].ucolpanel) for k in g)
                   for g in groups), default=0), 1)
    kmat = np.full((ngr, G), -1, dtype=np.int32)
    kseg = np.full((ngr, G), scratch_seg, dtype=np.int32)
    l_msel = np.zeros((ngr, NL), dtype=np.int32)
    uc_msel = np.zeros((ngr, NUC), dtype=np.int32)
    diag_slot = np.full((p, q, ngr, G), scratch_tile, dtype=np.int32)
    l_slot = np.full((p, q, ngr, NL), scratch_tile, dtype=np.int32)
    l_rows = np.full((p, q, ngr, NL), scratch_seg, dtype=np.int32)
    uc_slot = np.full((p, q, ngr, NUC), scratch_tile, dtype=np.int32)
    uc_rows = np.full((p, q, ngr, NUC), scratch_seg, dtype=np.int32)
    for gi, g in enumerate(groups):
        ol = ou = 0
        for mi, k in enumerate(g):
            lev = schedule.levels[k]
            kmat[gi, mi] = k
            kseg[gi, mi] = k
            diag_slot[k % p, k % q, gi, mi] = lay.tile_slot[lev.diag]
            for panel, rows, msel, slot_t, rows_t, off in (
                    (lev.lpanel, lev.lrows, l_msel, l_slot, l_rows, ol),
                    (lev.ucolpanel, lev.ucolrows, uc_msel, uc_slot,
                     uc_rows, ou)):
                tid = np.asarray(panel, dtype=np.int64)
                at = off + np.arange(len(tid))
                r, c = lay.tile_owner_r[tid], lay.tile_owner_c[tid]
                slot_t[r, c, gi, at] = lay.tile_slot[tid]
                rows_t[r, c, gi, at] = rows
                msel[gi, at] = mi
            ol += len(lev.lpanel)
            ou += len(lev.ucolpanel)
    return dict(diag_slot=diag_slot, l_slot=l_slot, l_rows=l_rows,
                uc_slot=uc_slot, uc_rows=uc_rows, kmat=kmat, kseg=kseg,
                l_msel=l_msel, uc_msel=uc_msel)


@dataclasses.dataclass
class _SolveStep:
    """One group of one sweep on this rank: the members' segments (their
    levels), the diagonal tiles it owns (member index, segment), and its
    panel tiles (local slot, target segment, member) by wave."""

    ks: torch.Tensor
    own_m: torch.Tensor
    own_seg: torch.Tensor
    panel: Waves


class DistributedTriangularSolver:
    """gstrs over the block-cyclic factored shards of
    :class:`~pangulu_tpu_torch.parallel.dist_numeric.DistributedLU`
    (every rank builds one with the same arguments and calls
    :meth:`solve` with the same b; each gets the same x).  ``diag`` is
    the factorization's replicated ``[bl, nb, nb]`` store of diagonal
    factors (``DistributedLU.diag``, read at each solve)."""

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule,
                 layout: DistLayout, grid: Grid, diag: torch.Tensor,
                 perf: PerfCounters | None = None):
        self.blocked = blocked
        self.schedule = schedule
        self.layout = layout
        self.grid = grid
        self.diag = diag
        self.perf = perf or PerfCounters()
        t = solve_tables(schedule, layout)
        grid.check_same(tables_digest(*(t[k] for k in sorted(t))),
                        "the distributed solve's tables")
        self._fwd = self._rank_steps(t, "l_slot", "l_rows", "l_msel")
        self._bwd = self._rank_steps(t, "uc_slot", "uc_rows", "uc_msel")
        self.perf.kernels["solve_engine"] = "dist"

    def _rank_steps(self, t: dict, slot_key, rows_key, msel_key) -> list:
        g, bl = self.grid, self.schedule.block_length
        p, q, r, c = g.p, g.q, g.r, g.c
        put = _index_putter(g)
        slot, rows = t[slot_key][r, c], t[rows_key][r, c]
        steps = []
        for gi in range(t["kmat"].shape[0]):
            km = t["kmat"][gi].astype(np.int64)
            km = km[km >= 0]
            ks = t["kseg"][gi, : len(km)]
            own = np.flatnonzero((km % p == r) & (km % q == c))
            steps.append(_SolveStep(
                ks=put(ks), own_m=put(own), own_seg=put(ks[own]),
                panel=Waves.build(rows[gi] != bl, t[msel_key][gi],
                                  rows[gi], slot[gi], t[msel_key][gi],
                                  put)))
        return steps

    def _group(self, tiles, x, st: _SolveStep, lower: bool) -> None:
        xk = x[st.ks]
        self.grid.all_reduce(xk, "world")
        d = self.diag[st.ks]
        solved = trsv_lower_unit(d, xk) if lower else trsv_upper(d, xk)
        x[st.ks] = 0
        if len(st.own_m):
            x[st.own_seg] = solved[st.own_m]
        pw = st.panel
        for s, e in pw.spans():
            upd = torch.matmul(tiles[pw.a[s:e]], solved[pw.b[s:e]])
            x.index_add_(0, pw.dst[s:e], upd, alpha=-1)

    def solve_blocked(self, tiles: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
        """Solve in place on this rank's additive part ``x``
        ``[bl+1, nb, nrhs]`` (the ranks' parts sum to the blocked b) and
        return x, whole on every rank."""
        with true_f32_matmul():
            for st in self._fwd:
                self._group(tiles, x, st, lower=True)
            for st in reversed(self._bwd):
                self._group(tiles, x, st, lower=False)
            self.grid.all_reduce(x, "world")
        return x

    def solve(self, tiles: torch.Tensor, b: np.ndarray) -> np.ndarray:
        """b: [n] or [n, nrhs] on the host (the same on every rank) ->
        x on the host."""
        bl, nb = self.schedule.block_length, self.schedule.nb
        n = self.blocked.n
        b = np.asarray(b)
        squeeze = b.ndim == 1
        if squeeze:
            b = b[:, None]
        x = torch.zeros((bl + 1, nb, b.shape[1]),
                        dtype=self.blocked.torch_dtype,
                        device=self.grid.device)
        if self.grid.rank == 0:
            x[:bl].reshape(bl * nb, -1)[:n] = torch.as_tensor(
                b.astype(self.blocked.dtype), device=x.device)
        with self.perf.phase("sptrsv"):
            x = self.solve_blocked(tiles, x)
            device_sync(x.device)
        out = x[:bl].reshape(bl * nb, -1)[:n].cpu().numpy()
        return out[:, 0] if squeeze else out
