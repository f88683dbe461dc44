"""Out-of-core panel factorization: O(fill) memory at mega-kernel speed.

Counterpart of ``pangulu_tpu.outofcore``.  The factor lives in the
compressed store (:class:`~pangulu_tpu_torch.compressed.CompressedTiles`,
O(fill-nnz)); the block columns are processed in PANELS of
``panel_width`` columns, RIGHT-LOOKING:

  * the panel's CROSS (the tiles with block row or block column in the
    panel) is staged dense by one P6 decompress
    (:func:`~ops.kernels_cuda.decompress_tiles`), factored by K2
    (:func:`~ops.kernels_cuda.mega_factorize`) on the panel's
    sub-schedule with cross-local tile ids, and written back by one P6
    compress;
  * the panel's Schur updates to tiles OUTSIDE the cross are products of
    the factored cross (``torch.matmul`` in true f32), summed per
    destination and subtracted from the store in bounded chunks: each
    chunk's destinations staged dense, updated and written back by P6.

Only the cross and one update chunk are ever dense, so the dense working
set is O(cross) whatever the problem size, while the factorization runs
through K2.  Where the whole matrix is one panel (the default budget
covers it), a factorization is one decompress, one K2 launch and one
compress.  Under ``PANGULU_TPU_SUPERLEVEL=1`` each panel's K2 takes
chain-ahead tables (``pangulu_tpu/outofcore.py:343-355``,
:func:`~numeric.chain_ahead_asked`); its inverses then sit at the
panel's local level ids, which the collected inverse store keeps.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from pangulu_tpu_torch.blocks import BlockedMatrix
from pangulu_tpu_torch.compressed import (CompressedLU, CompressedTiles,
                                          true_f32)
from pangulu_tpu_torch.numeric import chain_ahead_asked
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops.kernels_torch import (DEFAULT_TOL, MAX_NB,
                                                 Indices, KernelTables,
                                                 mega_uch)
from pangulu_tpu_torch.schedule import Level, Schedule, bucket, build_schedule
from pangulu_tpu_torch.sparse import CscMatrix
from pangulu_tpu_torch.utils.log import get_logger
from pangulu_tpu_torch.utils.perf import (PerfCounters, device_sync,
                                          resolve_device)

log = get_logger()


@dataclasses.dataclass
class OutChunk:
    """One chunk of out-of-cross Schur updates, as the JAX package forms
    it (pangulu_tpu/outofcore.py:364-410): ``l_sel``/``u_sel`` [NU]
    cross-local tile indices (padding: the cross's zero scratch tile),
    ``acc_sel`` [NU] each update's destination within the chunk
    (padding: ``nacc - 1``), ``dst_ids`` [nacc] global tile ids
    (padding: the store's scratch tile), ``capw`` the capacity class.

    The device side: the real updates' operands (``l``, ``u``), the
    destinations (``dst``, for P6), and the fixed-order sum: the first
    update of each destination (``first``), then for each further rank
    r the updates of rank r (``ranks[r-1][0]``) and their destinations
    (``ranks[r-1][1]``), distinct within a rank."""

    l_sel: np.ndarray
    u_sel: np.ndarray
    acc_sel: np.ndarray
    dst_ids: np.ndarray
    capw: int
    nacc: int
    l: torch.Tensor
    u: torch.Tensor
    dst: Indices
    first: torch.Tensor
    ranks: list


@dataclasses.dataclass
class PanelPass:
    """What one panel pass needs, built once for a (c0, c1) and kept:
    the cross's tile ids followed by the scratch id (P6), K2's tables
    over the sub-schedule, the out-of-cross update chunks."""

    cross: np.ndarray
    ids: Indices
    tables: KernelTables
    chunks: list


def _hbm_note(device) -> str:
    """Device-memory annotation for the panel progress lines."""
    if device.type != "cuda":
        return ""
    return (f"; device {torch.cuda.memory_allocated(device) / 2 ** 30:.2f} "
            f"GiB (peak "
            f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f})")


class PanelLU:
    """gstrf/gstrs executor: compressed at rest, K2 per panel cross, on
    ``device`` (``"cuda"``, the default: the hand kernels; ``"cpu"``:
    their plain versions).

    ``panel_width``: block columns per panel (None: from a 2 GiB
    dense-cross budget, ``PANGULU_OOC_PANEL_GB``).  ``out_chunk``: the
    most Schur updates staged dense at once."""

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule | None,
                 a3: CscMatrix, perf: PerfCounters | None = None,
                 panel_width: int | None = None, out_chunk: int = 2048,
                 store=None, device="cuda", tol: float | None = None):
        if blocked.nb > MAX_NB or blocked.torch_dtype.is_complex:
            # api._takes_panel_lu never routes these here
            raise ValueError(
                f"PanelLU factors each panel cross with K2, which takes "
                f"real tiles of nb <= {MAX_NB}; got nb={blocked.nb}, "
                f"{blocked.torch_dtype}.  The JAX package takes this route "
                "only at float32 and nb 128 or 256 (pangulu_tpu/api.py:"
                "297-313); CompressedLU factors the compressed store at "
                "every nb and for complex tiles")
        self.blocked = blocked
        self.schedule = schedule or build_schedule(blocked)
        self.perf = perf or PerfCounters()
        self.device = resolve_device(device)
        self.tol = (tol if tol is not None
                    else DEFAULT_TOL[blocked.torch_dtype])
        self.out_chunk = out_chunk
        # K2's chain-ahead tables for each panel cross (the switch read
        # once, as LUFactorizer reads it)
        self.ahead = chain_ahead_asked(blocked.torch_dtype)
        with self.perf.phase("preprocess"):
            if store is not None:      # refactorize: same pattern,
                store.refill(a3)       # new values, O(nnz)
                self.store = store
            else:
                self.store = CompressedTiles(blocked, a3, self.device)
        bl, nb = self.schedule.block_length, blocked.nb
        if panel_width is None:
            budget = int(float(os.environ.get(
                "PANGULU_OOC_PANEL_GB", "2")) * 2 ** 30)
            per_col = (max(1, blocked.num_tiles // max(bl, 1))
                       * 2 * nb * nb * np.dtype(blocked.dtype).itemsize)
            panel_width = int(min(max(budget // max(per_col, 1), 4), bl))
        self.panel_width = panel_width
        # [bl, 2, nb, nb] by level, for the solve: each panel's K2
        # inverses, concatenated after the last panel
        self.inv_tiles = None
        self._inv_parts: list = []
        self.panel_cols: list = []   # [(c0, c1)] of the last factorize
        self._passes: dict = {}
        self._clu = None
        # per-tile block coordinates
        nt = blocked.num_tiles
        self._rows = np.asarray(blocked.browidx, dtype=np.int64)
        self._cols = np.repeat(np.arange(bl, dtype=np.int64),
                               np.diff(blocked.bcolptr))
        assert len(self._rows) == len(self._cols) == nt

    # -- panel pass --------------------------------------------------------

    def _cross_ids(self, c0, c1):
        in_col = (self._cols >= c0) & (self._cols < c1)
        in_row = (self._rows >= c0) & (self._rows < c1)
        return np.flatnonzero(in_col | in_row)

    def _dense_budget_tiles(self) -> int:
        """The most tiles one dense panel cross may occupy
        (pangulu_tpu/outofcore.py:227-254): the device's memory less the
        compressed store and 4 GiB for the inverses, the two gathered
        operands of an update chunk and the allocator (the JAX package's
        2 GiB spare and its default 2 GiB of gather/scatter staging,
        which P6 does not need: the same ``panel_cols`` at the same
        memory limit); ``PANGULU_OOC_CROSS_GB`` sets it outright.  The
        device's memory is ``torch.cuda.mem_get_info``'s total on the
        card times the process's allocator cap
        (``torch.cuda.set_per_process_memory_fraction``, 1.0 unless a
        caller sets it), and the JAX package's 15 GiB on the CPU."""
        nb = self.blocked.nb
        tile_b = nb * nb * np.dtype(self.blocked.dtype).itemsize
        env = os.environ.get("PANGULU_OOC_CROSS_GB")
        if env is not None:
            return max(int(float(env) * 2 ** 30 // tile_b), 64)
        hbm = 15.0 * 2 ** 30
        if self.device.type == "cuda":
            hbm = (float(torch.cuda.mem_get_info(self.device)[1])
                   * torch.cuda.get_per_process_memory_fraction(
                       self.device))
        free = hbm - self.store.compressed_bytes - 4 * 2 ** 30
        return max(int(free // tile_b), 64)

    def _sub_schedule(self, c0, c1, local_of):
        """Mini Schedule over the panel's levels with CROSS-local tile
        ids; returns (schedule, out_updates) where out_updates is
        (dst_global, l_local_cross, u_local_cross)."""
        levels = []
        out_dst, out_l, out_u = [], [], []
        for k in range(c0, c1):
            lev = self.schedule.levels[k]
            dst_loc = local_of[lev.upd_dst]
            keep = dst_loc >= 0
            lpan_loc = local_of[lev.lpanel]
            upan_loc = local_of[lev.upanel]
            # an out-of-cross panel id would be a wrong answer, not a
            # crash: K2 reads the cross's local ids only
            assert (lpan_loc >= 0).all() and (upan_loc >= 0).all()
            # out-of-cross updates: applied AFTER the panel factors, from
            # the factored cross
            if (~keep).any():
                out_dst.append(lev.upd_dst[~keep])
                out_l.append(lpan_loc[lev.upd_l[~keep]])
                out_u.append(upan_loc[lev.upd_u[~keep]])
            above = lev.ucolrows >= c0
            levels.append(Level(
                k=k - c0, diag=int(local_of[lev.diag]),
                lpanel=lpan_loc, lrows=lev.lrows,
                upanel=upan_loc, ucols=lev.ucols,
                upd_dst=dst_loc[keep],
                upd_l=lev.upd_l[keep], upd_u=lev.upd_u[keep],
                ucolpanel=local_of[lev.ucolpanel[above]],
                ucolrows=lev.ucolrows[above] - c0,
            ))
        sub = Schedule(block_length=c1 - c0, nb=self.schedule.nb,
                       levels=levels,
                       n_tstrf=sum(len(v.lpanel) for v in levels),
                       n_gessm=sum(len(v.upanel) for v in levels),
                       n_ssssm=sum(len(v.upd_dst) for v in levels))

        def _cat(arrs):
            return (np.concatenate(arrs) if arrs
                    else np.empty(0, dtype=np.int64))

        return sub, (_cat(out_dst), _cat(out_l), _cat(out_u))

    def _chunk(self, l_sel, u_sel, acc_sel, dst_ids, capw, n, ng):
        """An OutChunk from the JAX package's padded arrays, with ``n``
        real updates into ``ng`` real destinations."""
        dev = self.device
        acc = acc_sel[:n].astype(np.int64)
        # acc_sel ascends over the real updates (destinations in sorted
        # order, each group contiguous): an update's rank in its group
        starts = np.flatnonzero(np.r_[True, acc[1:] != acc[:-1]])
        assert len(starts) == ng and (np.diff(acc) >= 0).all()
        rank = np.arange(n) - np.repeat(starts, np.diff(np.r_[starts, n]))
        ranks = []
        for r in range(1, int(rank.max(initial=0)) + 1):
            pos = np.flatnonzero(rank == r)
            ranks.append((torch.as_tensor(pos, device=dev),
                          torch.as_tensor(acc[pos], device=dev)))

        def t(a):
            return torch.as_tensor(a.astype(np.int64), device=dev)

        return OutChunk(l_sel=l_sel, u_sel=u_sel, acc_sel=acc_sel,
                        dst_ids=dst_ids, capw=int(capw), nacc=len(dst_ids),
                        l=t(l_sel[:n]), u=t(u_sel[:n]),
                        dst=Indices.build(dst_ids, dev),
                        first=torch.as_tensor(starts, device=dev),
                        ranks=ranks)

    def _out_chunks(self, ncross, odst, olsel, ousel) -> list:
        """The out-of-cross updates in chunks, formed as the JAX package
        forms them (pangulu_tpu/outofcore.py:364-410): sorted by
        destination, destination groups in power-of-two capacity classes
        (floor 1024, at most capmax), each chunk at most ``out_chunk``
        updates unless one group is larger, paddings by ``bucket``.  The
        class width ``capw`` only sets the chunk boundaries here: P6
        finds each tile's slots itself."""
        st = self.store
        chunks = []
        if not len(odst):
            return chunks
        order = np.argsort(odst, kind="stable")
        odst, olsel, ousel = odst[order], olsel[order], ousel[order]
        starts = np.flatnonzero(np.r_[True, odst[1:] != odst[:-1]])
        bounds = np.r_[starts, len(odst)]
        gcap = st.host_cap[odst[starts]]
        gcls = np.maximum(
            2 ** np.ceil(np.log2(np.maximum(gcap, 1))).astype(np.int64),
            1024)
        gcls = np.minimum(gcls, st.capmax)
        for capw in np.unique(gcls):
            sel_g = np.flatnonzero(gcls == capw)
            i = 0
            while i < len(sel_g):
                j, tot = i, 0
                while j < len(sel_g) and (
                        j == i
                        or tot + bounds[sel_g[j] + 1]
                        - bounds[sel_g[j]] <= self.out_chunk):
                    tot += bounds[sel_g[j] + 1] - bounds[sel_g[j]]
                    j += 1
                gs = sel_g[i:j]
                upd = np.concatenate(
                    [np.arange(bounds[g], bounds[g + 1]) for g in gs])
                nupd = bucket(len(upd))
                nacc = bucket(len(gs))
                l_sel = np.full(nupd, ncross, dtype=np.int32)
                u_sel = np.full(nupd, ncross, dtype=np.int32)
                acc_sel = np.full(nupd, nacc - 1, dtype=np.int32)
                l_sel[: len(upd)] = olsel[upd]
                u_sel[: len(upd)] = ousel[upd]
                acc_sel[: len(upd)] = np.searchsorted(
                    odst[starts[gs]], odst[upd])
                dst_ids = np.full(nacc, st.num_tiles, dtype=np.int32)
                dst_ids[: len(gs)] = odst[starts[gs]]
                chunks.append(self._chunk(l_sel, u_sel, acc_sel, dst_ids,
                                          capw, len(upd), len(gs)))
                i = j
        return chunks

    def _pass(self, c0, c1) -> PanelPass:
        """The panel pass's plan for columns [c0, c1), built at its first
        use and kept: a refactorization of the same store reuses it."""
        key = (c0, c1)
        if key not in self._passes:
            st = self.store
            cross = self._cross_ids(c0, c1)
            local_of = np.full(self.blocked.num_tiles + 1, -1, dtype=np.int64)
            local_of[cross] = np.arange(len(cross))
            sub, out = self._sub_schedule(c0, c1, local_of)
            # the kernel's convention: the scratch tile last (cap 0, so
            # P6 stages it as a zero tile)
            tables = KernelTables.build(
                sub.mega_tables(len(cross), uch=mega_uch(st.nb),
                                superlevel=self.ahead),
                self.device)
            self._passes[key] = PanelPass(
                cross=cross,
                ids=Indices.build(np.r_[cross, st.num_tiles], self.device),
                tables=tables, chunks=self._out_chunks(len(cross), *out))
        return self._passes[key]

    def _apply_out_updates(self, dense: torch.Tensor, ch: OutChunk) -> None:
        """One chunk of out-of-cross Schur updates (pangulu_tpu/
        outofcore.py:104-137): the products from the factored cross,
        summed per destination in a fixed order (the first update, then
        each further rank's, whose destinations are distinct, so the
        sums are the same bits in every run), then the destinations
        staged dense, the sums subtracted, written back."""
        st = self.store
        prod = torch.matmul(dense[ch.l], dense[ch.u])
        acc = prod[ch.first]
        for pos, tgt in ch.ranks:
            acc.index_add_(0, tgt, prod[pos])
        del prod
        cur = kernels_cuda.decompress_tiles(st.values, st.idx, st.off,
                                            st.cap, ch.dst, st.nb)
        cur[: len(acc)] -= acc
        kernels_cuda.compress_tiles(st.values, st.idx, st.off, st.cap,
                                    ch.dst, cur)

    def _panel_pass(self, c0, c1):
        st = self.store
        nb = st.nb
        p = self._pass(c0, c1)
        log.info("panel cols [%d,%d): cross %d tiles (%.2f GiB dense)",
                 c0, c1, len(p.cross),
                 len(p.cross) * nb * nb
                 * np.dtype(self.blocked.dtype).itemsize / 2 ** 30)
        # 1. densify the cross (and the scratch tile, last)
        dense = kernels_cuda.decompress_tiles(st.values, st.idx, st.off,
                                              st.cap, p.ids, nb)
        # 2. K2 on the cross's sub-schedule
        dense, invs = kernels_cuda.mega_factorize(
            dense, p.tables, nb=nb, tol=self.tol, bl=c1 - c0)
        self._inv_parts.append(invs)
        # 3. out-of-cross Schur updates, chunked by destination groups
        for ch in p.chunks:
            self._apply_out_updates(dense, ch)
        # 4. the factored cross back into the store
        kernels_cuda.compress_tiles(st.values, st.idx, st.off, st.cap,
                                    p.ids, dense)

    def factorize(self) -> CompressedTiles:
        """Factor the store IN PLACE, panel by panel (pangulu_tpu/
        outofcore.py:421-471); a panel is halved until its cross fits
        the dense budget.  Persists the inverses."""
        bl = self.schedule.block_length
        w = self.panel_width
        budget = self._dense_budget_tiles()
        self._inv_parts = []
        self.panel_cols = []
        self._clu = None
        t0 = time.perf_counter()
        with self.perf.phase("numeric"), true_f32():
            c0 = 0
            while c0 < bl:
                # halving, not arbitrary shrinking, keeps the set of
                # panel lengths small
                wc = min(w, bl - c0)
                while (wc > 1
                       and len(self._cross_ids(c0, c0 + wc)) > budget):
                    wc = (wc + 1) // 2
                if wc == 1 and len(self._cross_ids(c0, c0 + 1)) > budget:
                    log.warning(
                        "panel col %d: single-column cross exceeds the "
                        "%d-tile dense budget; proceeding (may run out of "
                        "memory)", c0, budget)
                self._panel_pass(c0, c0 + wc)
                self.panel_cols.append((c0, c0 + wc))
                log.info("panel %d (cols %d-%d of %d) dispatched "
                         "(%.1fs elapsed)%s", len(self.panel_cols), c0,
                         c0 + wc, bl, time.perf_counter() - t0,
                         _hbm_note(self.device))
                c0 += wc
            device_sync(self.device)
        self.inv_tiles = (torch.cat(self._inv_parts)
                          if len(self._inv_parts) > 1
                          else self._inv_parts[0])
        self._inv_parts = []
        self.perf.add_flops(self.schedule.flop_estimate())
        self.perf.kernel_counts(
            getrf=bl, tstrf=self.schedule.n_tstrf,
            gessm=self.schedule.n_gessm, ssssm=self.schedule.n_ssssm)
        self.perf.kernels["engine"] = "panel"
        self.perf.kernels["panels"] = len(self.panel_cols)
        st = self.store
        log.info("panel out-of-core: %d panels (width <= %d, cross budget "
                 "%d tiles); compressed store %.1f MiB vs %.1f MiB dense "
                 "(%.1fx)", len(self.panel_cols), w, budget,
                 st.compressed_bytes / 2 ** 20, st.dense_bytes / 2 ** 20,
                 st.dense_bytes / max(st.compressed_bytes, 1))
        return st

    # -- solve -------------------------------------------------------------

    def _solver(self) -> CompressedLU:
        """The compressed-store solve on the collected inverses
        (rebuilt after each factorization, which replaces them)."""
        if self._clu is None:
            self._clu = CompressedLU.from_store(
                self.blocked, self.schedule, self.store, perf=self.perf,
                tol=self.tol)
            self._clu.inv_tiles = self.inv_tiles
        return self._clu

    def solve_blocked(self, xb: torch.Tensor) -> torch.Tensor:
        """:meth:`CompressedLU.solve_blocked` on this store."""
        return self._solver().solve_blocked(xb)

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve LU x = b for b [n] or [n, nrhs] on the host."""
        return self._solver().solve(b)
