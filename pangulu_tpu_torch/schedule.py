"""Elimination-level schedule: the block task DAG as a level sequence.

The reference executes the factorization as a synchronisation-free task
DAG driven by precomputed dependency counters, a mutex-protected binary
heap and per-tile SSSSM aggregation (pangulu_preprocessing.c:132-207,
pangulu_task.c, pangulu_numeric.c:655-930).  The heap's level-first
priority (compare strategy 0, pangulu_task.c:268-281) already makes
execution approximately level-ordered, so the level schedule is
precomputed outright on the host:

  level k:  GETRF(k,k)
            TSTRF batch  { (i,k) : i>k in pattern }   (L-panel)
            GESSM batch  { (k,j) : j>k in pattern }   (U-panel)
            SSSSM batch  { (i,j) <- (i,k)x(k,j) : (i,j) in pattern }

Everything level k reads was produced by levels < k, and within a level
each SSSSM destination is unique, so a level lowers to three batched
kernels with no synchronization beyond stream order.

The kernel tables are kept bit-identical to the JAX package's
(``pangulu_tpu.schedule``), padding included, so the two packages'
tables can be compared exactly.  The 128-lane row widths are a TPU
layout rule the CUDA kernels do not need; they only read the first
``count`` entries of each row.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pangulu_tpu_torch.blocks import BlockedMatrix


@dataclasses.dataclass
class Level:
    k: int
    diag: int                 # tile id of (k,k)
    lpanel: np.ndarray        # tile ids of (i,k), i>k  (col-k lower panel)
    lrows: np.ndarray         # their block rows i
    upanel: np.ndarray        # tile ids of (k,j), j>k  (row-k upper panel)
    ucols: np.ndarray         # their block cols j
    upd_dst: np.ndarray       # SSSSM destinations (tile ids)
    upd_l: np.ndarray         # index into lpanel for each update
    upd_u: np.ndarray         # index into upanel for each update
    # SpTRSV (backward pass) needs column-k blocks ABOVE the diagonal:
    ucolpanel: np.ndarray     # tile ids of (i,k), i<k
    ucolrows: np.ndarray      # their block rows i


@dataclasses.dataclass
class Schedule:
    block_length: int
    nb: int
    levels: list
    n_tstrf: int
    n_gessm: int
    n_ssssm: int

    @property
    def max_lpanel(self):
        return max((len(l.lpanel) for l in self.levels), default=0)

    @property
    def max_upanel(self):
        return max((len(l.upanel) for l in self.levels), default=0)

    @property
    def max_updates(self):
        return max((len(l.upd_dst) for l in self.levels), default=0)

    def fused_tables(self, scratch_tile: int):
        """Fully padded [bl, N] index tables: every level padded to the
        schedule-wide maxima.  Returns (diag_idx, l_ids, u_ids, upd_dst,
        upd_l, upd_u)."""
        bl = self.block_length
        nl = max(self.max_lpanel, 1)
        nu = max(self.max_upanel, 1)
        np_ = max(self.max_updates, 1)
        diag_idx = np.zeros(bl, dtype=np.int32)
        l_ids = np.full((bl, nl), scratch_tile, dtype=np.int32)
        u_ids = np.full((bl, nu), scratch_tile, dtype=np.int32)
        upd_dst = np.full((bl, np_), scratch_tile, dtype=np.int32)
        upd_l = np.zeros((bl, np_), dtype=np.int32)
        upd_u = np.zeros((bl, np_), dtype=np.int32)
        for i, lev in enumerate(self.levels):
            diag_idx[i] = lev.diag
            l_ids[i, : len(lev.lpanel)] = lev.lpanel
            u_ids[i, : len(lev.upanel)] = lev.upanel
            upd_dst[i, : len(lev.upd_dst)] = lev.upd_dst
            upd_l[i, : len(lev.upd_l)] = lev.upd_l
            upd_u[i, : len(lev.upd_u)] = lev.upd_u
        return diag_idx, l_ids, u_ids, upd_dst, upd_l, upd_u

    def fused_solve_tables(self, scratch_tile: int, scratch_seg: int):
        """Padded tables for a level-loop SpTRSV: per level the forward
        pass needs the L-panel (column k below diag) and the backward
        pass the U-column panel (column k above diag)."""
        bl = self.block_length
        nl = max(self.max_lpanel, 1)
        nuc = max((len(l.ucolpanel) for l in self.levels), default=0)
        nuc = max(nuc, 1)
        diag_idx = np.zeros(bl, dtype=np.int32)
        l_ids = np.full((bl, nl), scratch_tile, dtype=np.int32)
        l_rows = np.full((bl, nl), scratch_seg, dtype=np.int32)
        uc_ids = np.full((bl, nuc), scratch_tile, dtype=np.int32)
        uc_rows = np.full((bl, nuc), scratch_seg, dtype=np.int32)
        for i, lev in enumerate(self.levels):
            diag_idx[i] = lev.diag
            l_ids[i, : len(lev.lpanel)] = lev.lpanel
            l_rows[i, : len(lev.lrows)] = lev.lrows
            uc_ids[i, : len(lev.ucolpanel)] = lev.ucolpanel
            uc_rows[i, : len(lev.ucolrows)] = lev.ucolrows
        return diag_idx, l_ids, l_rows, uc_ids, uc_rows

    def mega_tables(self, scratch_tile: int, uch: int = 64,
                    max_pch: int = 32):
        """Index tables for the whole-factorization engine
        (``ops.kernels_torch.mega_factorize`` and its CUDA kernel): per
        level the diag tile, the REAL task counts, the panel tile ids,
        and [dst, l, u] Schur-update rows in chunks of ``uch``.

        Updates are sorted per level by (u-chunk, l-chunk, l) as in the
        JAX package, where the TPU kernel re-forms a panel chunk only
        when its key changes.  Each destination is updated once per
        level, so the order does not change any result here."""
        bl = self.block_length
        nl_pan = max(bucket(max(self.max_lpanel, 1)), 1)
        nu_pan = max(bucket(max(self.max_upanel, 1)), 1)
        pch = min(max(nl_pan, nu_pan), max_pch)
        # kept at the JAX package's 128-lane row widths (bit parity)
        nl_pan = -(-nl_pan // 128) * 128
        nu_pan = -(-nu_pan // 128) * 128
        nchunks = max(1, -(-max(self.max_updates, 1) // uch))
        # rows are 128 wide; only the first ``uch`` entries are used
        row_w = max(uch, 128)
        diag = np.zeros(bl, dtype=np.int32)
        nl = np.zeros(bl, dtype=np.int32)
        nu = np.zeros(bl, dtype=np.int32)
        nup = np.zeros(bl, dtype=np.int32)
        lid = np.full((bl, nl_pan), scratch_tile, dtype=np.int32)
        uid = np.full((bl, nu_pan), scratch_tile, dtype=np.int32)
        udst = np.full((bl, nchunks, row_w), scratch_tile, dtype=np.int32)
        udl = np.zeros((bl, nchunks, row_w), dtype=np.int32)
        udu = np.zeros((bl, nchunks, row_w), dtype=np.int32)
        for i, lev in enumerate(self.levels):
            diag[i] = lev.diag
            nl[i] = len(lev.lpanel)
            nu[i] = len(lev.upanel)
            nup[i] = len(lev.upd_dst)
            lid[i, : nl[i]] = lev.lpanel
            uid[i, : nu[i]] = lev.upanel
            order = np.lexsort((lev.upd_u, lev.upd_l,
                                lev.upd_l // pch, lev.upd_u // pch))
            s_dst = lev.upd_dst[order]
            s_l = lev.upd_l[order]
            s_u = lev.upd_u[order]
            for c in range(0, nup[i], uch):
                cc = c // uch
                cnt = min(uch, nup[i] - c)
                udst[i, cc, :cnt] = s_dst[c:c + cnt]
                udl[i, cc, :cnt] = s_l[c:c + cnt]
                udu[i, cc, :cnt] = s_u[c:c + cnt]
        return dict(diag_tab=diag, nl_tab=nl, nu_tab=nu, nup_tab=nup,
                    lid_tab=lid, uid_tab=uid,
                    udst_tab=udst, udl_tab=udl, udu_tab=udu,
                    npan_l=nl_pan, npan_u=nu_pan, pch=pch, uch=uch)

    def mega_solve_tables(self, scratch_tile: int):
        """Index tables for the whole-solve engine
        (``ops.kernels_torch.mega_solve`` and its CUDA kernel): per
        level, the L panel (column k below the diagonal, forward pass)
        and the U column panel (column k above the diagonal, backward
        pass) with their block rows, plus REAL counts."""
        bl = self.block_length
        nuc_max = max((len(l.ucolpanel) for l in self.levels), default=0)
        w = -(-max(bucket(max(self.max_lpanel, nuc_max, 1)), 1) // 128) * 128
        nl_pan = nuc_pan = w
        scratch_seg = bl  # x carries bl+1 segments
        nl = np.zeros(bl, dtype=np.int32)
        nuc = np.zeros(bl, dtype=np.int32)
        lid = np.full((bl, nl_pan), scratch_tile, dtype=np.int32)
        lrow = np.full((bl, nl_pan), scratch_seg, dtype=np.int32)
        ucid = np.full((bl, nuc_pan), scratch_tile, dtype=np.int32)
        ucrow = np.full((bl, nuc_pan), scratch_seg, dtype=np.int32)
        for i, lev in enumerate(self.levels):
            nl[i] = len(lev.lpanel)
            nuc[i] = len(lev.ucolpanel)
            lid[i, : nl[i]] = lev.lpanel
            lrow[i, : nl[i]] = lev.lrows
            ucid[i, : nuc[i]] = lev.ucolpanel
            ucrow[i, : nuc[i]] = lev.ucolrows
        return dict(nl_tab=nl, nuc_tab=nuc, lid_tab=lid, lrow_tab=lrow,
                    ucid_tab=ucid, ucrow_tab=ucrow)

    def flop_estimate(self) -> float:
        """Dense-tile flop model (counterpart of the reference's exact
        sparse flop counters, pangulu_kernel_interface.c:4-178 — this
        counts the dense tile flops actually executed)."""
        nb = float(self.nb)
        getrf = 2.0 / 3.0 * nb ** 3 * self.block_length
        trsm = nb ** 3 * (self.n_tstrf + self.n_gessm)
        gemm = 2.0 * nb ** 3 * self.n_ssssm
        return getrf + trsm + gemm


def build_schedule(blocked: BlockedMatrix) -> Schedule:
    bl = blocked.block_length
    bcolptr, browidx = blocked.bcolptr, blocked.browidx
    brptr, bcolidx = blocked.brownnzptr, blocked.bcolidx
    tile_of_csr = blocked.tile_of_csr

    levels = []
    n_tstrf = n_gessm = n_ssssm = 0
    for k in range(bl):
        lo, hi = bcolptr[k], bcolptr[k + 1]
        col_rows = browidx[lo:hi]
        col_ids = np.arange(lo, hi)
        below = col_rows > k
        above = col_rows < k
        at = col_rows == k
        if not at.any():
            raise AssertionError(f"missing diagonal block at level {k}")
        diag = int(col_ids[at][0])
        lpanel = col_ids[below].astype(np.int64)
        lrows = col_rows[below].astype(np.int64)
        ucolpanel = col_ids[above].astype(np.int64)
        ucolrows = col_rows[above].astype(np.int64)

        rlo, rhi = brptr[k], brptr[k + 1]
        row_cols = bcolidx[rlo:rhi]
        right = row_cols > k
        upanel = tile_of_csr[rlo:rhi][right].astype(np.int64)
        ucols = row_cols[right].astype(np.int64)

        # Updates: (i,j) for i in lrows x j in ucols present in pattern.
        if len(lrows) and len(ucols):
            ii = np.repeat(np.arange(len(lrows)), len(ucols))
            jj = np.tile(np.arange(len(ucols)), len(lrows))
            dst = blocked.tile_ids(lrows[ii], ucols[jj])
            present = dst >= 0
            upd_dst = dst[present].astype(np.int64)
            upd_l = ii[present].astype(np.int64)
            upd_u = jj[present].astype(np.int64)
        else:
            upd_dst = np.empty(0, dtype=np.int64)
            upd_l = np.empty(0, dtype=np.int64)
            upd_u = np.empty(0, dtype=np.int64)

        n_tstrf += len(lpanel)
        n_gessm += len(upanel)
        n_ssssm += len(upd_dst)
        levels.append(Level(
            k=k, diag=diag, lpanel=lpanel, lrows=lrows,
            upanel=upanel, ucols=ucols,
            upd_dst=upd_dst, upd_l=upd_l, upd_u=upd_u,
            ucolpanel=ucolpanel, ucolrows=ucolrows,
        ))

    return Schedule(
        block_length=bl, nb=blocked.nb, levels=levels,
        n_tstrf=n_tstrf, n_gessm=n_gessm, n_ssssm=n_ssssm,
    )


def bucket(n: int) -> int:
    """Pad a batch size to the next power of two (the static-shape
    analogue of the reference's 7 geometric storage-bin capacity
    classes, pangulu_preprocessing.c:325-332)."""
    if n <= 0:
        return 0
    return 1 << (n - 1).bit_length()
