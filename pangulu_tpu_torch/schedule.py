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
    # block_depths(), computed once
    _depths: np.ndarray | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

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
                    max_pch: int = 32, superlevel: bool = False):
        """Index tables for the whole-factorization engine
        (``ops.kernels_torch.mega_factorize`` and its CUDA kernel): per
        level the diag tile, the REAL task counts, the panel tile ids,
        and [dst, l, u] Schur-update rows in chunks of ``uch``.

        Updates are sorted per level by (u-chunk, l-chunk, l) as in the
        JAX package, where the TPU kernel re-forms a panel chunk only
        when its key changes.  Each destination is updated once per
        level, so the order does not change any result here.

        ``superlevel=True`` (the JAX package's chain-ahead tables,
        ``pangulu_tpu/schedule.py:216-228``): the levels in dependency-
        depth order (``block_depths``, a valid elimination order), with
        ``flag_tab`` (1 where a level has the depth of the one before
        it, so that its diagonal step may run while the one before it
        still runs) and ``lev_tab`` (position -> original level id, the
        slot of its inverses).  Raises if a flagged level's diagonal
        tile is written by the level before it (:func:`check_ahead`)."""
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
        out = dict(diag_tab=diag, nl_tab=nl, nu_tab=nu, nup_tab=nup,
                   lid_tab=lid, uid_tab=uid,
                   udst_tab=udst, udl_tab=udl, udu_tab=udu,
                   npan_l=nl_pan, npan_u=nu_pan, pch=pch, uch=uch)
        if superlevel:
            depth = self.block_depths()
            order = np.lexsort((np.arange(bl), depth)).astype(np.int32)
            flag = np.zeros(bl, dtype=np.int32)
            flag[1:] = (depth[order[1:]] == depth[order[:-1]])
            for key in ("diag_tab", "nl_tab", "nu_tab", "nup_tab",
                        "lid_tab", "uid_tab", "udst_tab", "udl_tab",
                        "udu_tab"):
                out[key] = out[key][order]
            out["flag_tab"] = flag
            out["lev_tab"] = order
            check_ahead(out)
        return out

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

    def block_depths(self) -> np.ndarray:
        """Exact block-column dependency depths: level j must precede
        level k (j < k) iff tile (j,k) or (k,j) is present.  Distinct
        columns at equal depth touch disjoint diagonal and panel tiles;
        their Schur updates may share destinations, which commute
        (addition).  The reference's concurrent ready-GETRF seeding
        (pangulu_numeric.c:1054-1068) made static."""
        if self._depths is not None:
            return self._depths
        depth = np.zeros(self.block_length, dtype=np.int64)
        for lev in self.levels:
            # the block pattern is structurally symmetric (block_full),
            # so the column above the diagonal covers (j,k) and (k,j)
            if len(lev.ucolrows):
                depth[lev.k] = int(depth[lev.ucolrows].max()) + 1
        self._depths = depth
        return depth

    def superlevels(self) -> list:
        """Level indices grouped by equal dependency depth, in depth
        order: each group's diagonals and panels factor concurrently."""
        depth = self.block_depths()
        groups: dict[int, list] = {}
        for k, d in enumerate(depth):
            groups.setdefault(int(d), []).append(k)
        return [groups[d] for d in sorted(groups)]

    def segmented_tables(self, scratch_tile: int, min_run: int = 4):
        """Per run of consecutive levels that share one bucketed (nl, nu,
        nup) signature (runs shorter than ``min_run`` merged into their
        neighbour, :func:`group_runs`), fused tables padded to the
        run's signature (pangulu_tpu/schedule.py:118-155): the JAX
        package's segmented engine, which bounds the fused engine's
        padding to 2x a dimension within a run.  The run length is
        padded to a power of two too, the extra levels pointing at the
        scratch tile.  Returns a list of (diag_idx, l_ids, u_ids,
        upd_dst, upd_l, upd_u), each [bucket(run length), ...]."""
        sig = [(bucket(max(len(l.lpanel), 1)),
                bucket(max(len(l.upanel), 1)),
                bucket(max(len(l.upd_dst), 1))) for l in self.levels]
        out = []
        for start, end, (nl, nu, np_) in group_runs(sig, min_run):
            seg_p = bucket(end - start)
            diag_idx = np.full(seg_p, scratch_tile, dtype=np.int32)
            l_ids = np.full((seg_p, nl), scratch_tile, dtype=np.int32)
            u_ids = np.full((seg_p, nu), scratch_tile, dtype=np.int32)
            upd_dst = np.full((seg_p, np_), scratch_tile, dtype=np.int32)
            upd_l = np.zeros((seg_p, np_), dtype=np.int32)
            upd_u = np.zeros((seg_p, np_), dtype=np.int32)
            for t, lev in enumerate(self.levels[start:end]):
                diag_idx[t] = lev.diag
                l_ids[t, : len(lev.lpanel)] = lev.lpanel
                u_ids[t, : len(lev.upanel)] = lev.upanel
                upd_dst[t, : len(lev.upd_dst)] = lev.upd_dst
                upd_l[t, : len(lev.upd_l)] = lev.upd_l
                upd_u[t, : len(lev.upd_u)] = lev.upd_u
            out.append((diag_idx, l_ids, u_ids, upd_dst, upd_l, upd_u))
        return out

    def superfused_tables(self, scratch_tile: int, min_run: int = 1):
        """Per segment, padded tables of the JAX package's super-level
        fused engine (pangulu_tpu/schedule.py:524-583): a super-level
        batches its G diagonals, the union of its members' panels and
        their Schur updates; ``l_dsel``/``u_dsel`` give each panel tile
        its member, and ``upd_l``/``upd_u`` index the concatenated
        panels.  Segments are runs of one bucketed (G, NL, NU, NUP)
        signature (``min_run=1``: no merging).  Returns a list of
        (diag_idx[S,G], l_ids[S,NL], l_dsel[S,NL], u_ids[S,NU],
        u_dsel[S,NU], upd_dst[S,NUP], upd_l[S,NUP], upd_u[S,NUP])."""
        supers = self.superlevels()
        sig = []
        for mem in supers:
            levs = [self.levels[k] for k in mem]
            sig.append((bucket(max(len(mem), 1)),
                        *(bucket(max(sum(len(getattr(lev, f))
                                         for lev in levs), 1))
                          for f in ("lpanel", "upanel", "upd_dst"))))
        out = []
        for s0, s1, (G, NL, NU, NUP) in group_runs(sig, min_run):
            seg = s1 - s0
            diag_idx = np.full((seg, G), scratch_tile, dtype=np.int32)
            l_ids = np.full((seg, NL), scratch_tile, dtype=np.int32)
            l_dsel = np.zeros((seg, NL), dtype=np.int32)
            u_ids = np.full((seg, NU), scratch_tile, dtype=np.int32)
            u_dsel = np.zeros((seg, NU), dtype=np.int32)
            upd_dst = np.full((seg, NUP), scratch_tile, dtype=np.int32)
            upd_l = np.zeros((seg, NUP), dtype=np.int32)
            upd_u = np.zeros((seg, NUP), dtype=np.int32)
            for t, mem in enumerate(supers[s0:s1]):
                ol = ou = op = 0
                for g, k in enumerate(mem):
                    lev = self.levels[k]
                    nlk, nuk = len(lev.lpanel), len(lev.upanel)
                    nupk = len(lev.upd_dst)
                    diag_idx[t, g] = lev.diag
                    l_ids[t, ol:ol + nlk] = lev.lpanel
                    l_dsel[t, ol:ol + nlk] = g
                    u_ids[t, ou:ou + nuk] = lev.upanel
                    u_dsel[t, ou:ou + nuk] = g
                    upd_dst[t, op:op + nupk] = lev.upd_dst
                    upd_l[t, op:op + nupk] = lev.upd_l + ol
                    upd_u[t, op:op + nupk] = lev.upd_u + ou
                    ol, ou, op = ol + nlk, ou + nuk, op + nupk
            out.append((diag_idx, l_ids, l_dsel, u_ids, u_dsel,
                        upd_dst, upd_l, upd_u))
        return out

    def superfused_wave_tables(self, scratch_tile: int, gmax: int = 16,
                               min_run: int = 1):
        """Per segment, padded tables of super-level groups whose Schur
        updates apply in waves (pangulu_tpu/schedule.py:585-683): the
        super-levels split at ``gmax`` members, and each group's
        updates split so that wave w holds every destination's w-th
        occurrence, in member order; a destination occurs at most once
        a wave, so a wave is a gather, a subtraction and a store.
        Returns a list of (lev_ids[S,G], diag_idx[S,G], l_ids[S,NL],
        l_dsel[S,NL], u_ids[S,NU], u_dsel[S,NU], upd_dst[S,W,NW],
        upd_l[S,W,NW], upd_u[S,W,NW]); ``lev_ids`` pads with
        ``block_length``, tile ids with ``scratch_tile``."""
        supers = [mem[s:s + gmax] for mem in self.superlevels()
                  for s in range(0, len(mem), gmax)]
        gdata, sig = [], []
        for mem in supers:
            nl = nu = 0
            dsts, uls, uus = [], [], []
            for k in mem:
                lev = self.levels[k]
                dsts.append(np.asarray(lev.upd_dst, dtype=np.int64))
                uls.append(np.asarray(lev.upd_l, dtype=np.int64) + nl)
                uus.append(np.asarray(lev.upd_u, dtype=np.int64) + nu)
                nl += len(lev.lpanel)
                nu += len(lev.upanel)
            dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
            if len(dst):
                ul, uu = np.concatenate(uls), np.concatenate(uus)
                occ = occurrence(dst)        # the wave of each update
                wpos = occurrence(occ)       # its place in the wave
                wcnt = np.bincount(occ)
                W, NW = len(wcnt), int(wcnt.max())
            else:
                ul = uu = dst
                occ = wpos = np.zeros(0, dtype=np.int64)
                W = NW = 1
            gdata.append((mem, dst, ul, uu, occ, wpos))
            sig.append((bucket(max(len(mem), 1)), bucket(max(nl, 1)),
                        bucket(max(nu, 1)), W, bucket(max(NW, 1))))
        out = []
        for s0, s1, (G, NL, NU, W, NW) in group_runs(sig, min_run):
            seg = s1 - s0
            lev_ids = np.full((seg, G), self.block_length, dtype=np.int32)
            diag_idx = np.full((seg, G), scratch_tile, dtype=np.int32)
            l_ids = np.full((seg, NL), scratch_tile, dtype=np.int32)
            l_dsel = np.zeros((seg, NL), dtype=np.int32)
            u_ids = np.full((seg, NU), scratch_tile, dtype=np.int32)
            u_dsel = np.zeros((seg, NU), dtype=np.int32)
            upd_dst = np.full((seg, W, NW), scratch_tile, dtype=np.int32)
            upd_l = np.zeros((seg, W, NW), dtype=np.int32)
            upd_u = np.zeros((seg, W, NW), dtype=np.int32)
            for t in range(seg):
                mem, dst, ul, uu, occ, wpos = gdata[s0 + t]
                ol = ou = 0
                for g, k in enumerate(mem):
                    lev = self.levels[k]
                    nlk, nuk = len(lev.lpanel), len(lev.upanel)
                    lev_ids[t, g] = k
                    diag_idx[t, g] = lev.diag
                    l_ids[t, ol:ol + nlk] = lev.lpanel
                    l_dsel[t, ol:ol + nlk] = g
                    u_ids[t, ou:ou + nuk] = lev.upanel
                    u_dsel[t, ou:ou + nuk] = g
                    ol, ou = ol + nlk, ou + nuk
                upd_dst[t, occ, wpos] = dst
                upd_l[t, occ, wpos] = ul
                upd_u[t, occ, wpos] = uu
            out.append((lev_ids, diag_idx, l_ids, l_dsel, u_ids,
                        u_dsel, upd_dst, upd_l, upd_u))
        return out

    def group_mega_tables(self, scratch_tile: int, uch: int = 64,
                          max_pch: int = 32, gmax: int = 16):
        """Index tables for the batched-group factorization
        (``ops.kernels_torch.mega_factorize_groups`` and its CUDA
        kernel): one step per group of ``G <= gmax`` same-depth columns
        of one super-level, packed under a panel budget (the group's
        concatenated L and U panels each hold at most ``max_pch``
        tiles; a singleton group may exceed it).

        Member panels are concatenated per group (offsets
        ``gloff/guoff [ngroups, gmax+1]``), and ``udl/udu`` index the
        concatenated lists.  Updates from different members may hit the
        same destination tile.  The words are packed as in the JAX
        package, whose TPU kernel keeps each destination in a VMEM slot:
        ``udl = l | slot<<20 | load<<28 | write<<29`` and
        ``udu = u | u0c<<12 | tier<<19`` (a VMEM window tier).  Only
        ``l = udl & 0xFFFFF`` and ``u = udu & 0xFFF`` change a result;
        the rest is TPU buffer management, kept for bit parity.

        Returns a dict of tables plus geometry (pch, uch, ngroups,
        gmax, widths)."""
        supers = self.superlevels()
        groups: list[list[int]] = []
        for mem in supers:
            cur: list[int] = []
            nl_c = nu_c = 0
            for k in mem:
                nlk = len(self.levels[k].lpanel)
                nuk = len(self.levels[k].upanel)
                if cur and (len(cur) >= gmax
                            or nl_c + nlk > max_pch
                            or nu_c + nuk > max_pch):
                    groups.append(cur)
                    cur, nl_c, nu_c = [], 0, 0
                cur.append(k)
                nl_c += nlk
                nu_c += nuk
            if cur:
                groups.append(cur)
        gmax = max((len(g) for g in groups), default=1)
        ng = len(groups)
        nl_tot = max(max((sum(len(self.levels[k].lpanel) for k in g)
                          for g in groups), default=1), 1)
        nu_tot = max(max((sum(len(self.levels[k].upanel) for k in g)
                          for g in groups), default=1), 1)
        nup_tot = max(max((sum(len(self.levels[k].upd_dst) for k in g)
                           for g in groups), default=1), 1)
        pch = min(max(bucket(nl_tot), bucket(nu_tot)), max_pch)
        nl_pan = -(-max(bucket(nl_tot), 1) // 128) * 128
        nu_pan = -(-max(bucket(nu_tot), 1) // 128) * 128
        nchunks = max(1, -(-nup_tot // uch))
        row_w = max(uch, 128)

        gs = np.zeros(ng, np.int32)
        gdiag = np.full((ng, gmax), scratch_tile, np.int32)
        glev = np.zeros((ng, gmax), np.int32)
        gloff = np.zeros((ng, gmax + 1), np.int32)
        guoff = np.zeros((ng, gmax + 1), np.int32)
        nup_tab = np.zeros(ng, np.int32)
        lid = np.full((ng, nl_pan), scratch_tile, np.int32)
        uid = np.full((ng, nu_pan), scratch_tile, np.int32)
        udst = np.full((ng, nchunks, row_w), scratch_tile, np.int32)
        udl = np.zeros((ng, nchunks, row_w), np.int32)
        udu = np.zeros((ng, nchunks, row_w), np.int32)
        tiers = prodrow_tiers(pch)
        if nl_pan >= (1 << 12) or nu_pan >= (1 << 12):
            raise ValueError("group panel space exceeds 12-bit udu "
                             "packing")

        def _uword(uj, gu0, gu1):
            ucj = uj // pch
            if gu0 // pch != max(gu1 - 1, gu0) // pch:
                return uj  # member window crosses chunks: full chunk
            width = gu1 - gu0
            ti = 0
            for i, w in enumerate(tiers):
                if w >= width:
                    ti = i
            w = tiers[ti]
            u0c = max(0, min(gu0 - ucj * pch, pch - w))
            return uj | (u0c << 12) | (ti << 19)

        for gi, mem in enumerate(groups):
            gs[gi] = len(mem)
            ol = ou = 0
            dsts, uls, uus, uws = [], [], [], []
            for m, k in enumerate(mem):
                lev = self.levels[k]
                gdiag[gi, m] = lev.diag
                glev[gi, m] = k
                gloff[gi, m] = ol
                guoff[gi, m] = ou
                nlk, nuk = len(lev.lpanel), len(lev.upanel)
                lid[gi, ol:ol + nlk] = lev.lpanel
                uid[gi, ou:ou + nuk] = lev.upanel
                dsts.append(lev.upd_dst)
                uls.append(lev.upd_l + ol)
                uus.append(lev.upd_u + ou)
                uws.append(np.asarray(
                    [_uword(int(u) + ou, ou, ou + nuk)
                     for u in lev.upd_u], np.int64))
                ol += nlk
                ou += nuk
            gloff[gi, len(mem):] = ol
            guoff[gi, len(mem):] = ou
            dsts = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
            uls = np.concatenate(uls) if uls else np.empty(0, np.int64)
            uus = np.concatenate(uus) if uus else np.empty(0, np.int64)
            uws = np.concatenate(uws) if uws else np.empty(0, np.int64)
            nup_tab[gi] = len(dsts)
            order = np.lexsort((uus, uls, uls // pch, uus // pch))
            s_dst, s_l, s_u = dsts[order], uls[order], uws[order]
            for c in range(0, int(nup_tab[gi]), uch):
                cc = c // uch
                cnt = min(uch, int(nup_tab[gi]) - c)
                cd = s_dst[c:c + cnt]
                # TPU slot bits: duplicates of a destination within the
                # chunk share one slot, loaded first and written last
                slot = np.zeros(cnt, np.int64)
                load = np.zeros(cnt, np.int64)
                write = np.zeros(cnt, np.int64)
                seen: dict[int, int] = {}
                last: dict[int, int] = {}
                nxt = 0
                for j, d in enumerate(cd):
                    d = int(d)
                    if d in seen:
                        slot[j] = seen[d]
                    else:
                        seen[d] = nxt
                        slot[j] = nxt
                        load[j] = 1
                        nxt += 1
                    last[d] = j
                for j in last.values():
                    write[j] = 1
                udst[gi, cc, :cnt] = cd
                udl[gi, cc, :cnt] = (s_l[c:c + cnt] | (slot << 20)
                                     | (load << 28) | (write << 29))
                udu[gi, cc, :cnt] = s_u[c:c + cnt]
        return dict(gs_tab=gs, gdiag_tab=gdiag, glev_tab=glev,
                    gloff_tab=gloff, guoff_tab=guoff, nup_tab=nup_tab,
                    lid_tab=lid, uid_tab=uid,
                    udst_tab=udst, udl_tab=udl, udu_tab=udu,
                    npan_l=nl_pan, npan_u=nu_pan, pch=pch, uch=uch,
                    ngroups=ng, gmax=gmax)

    def group_solve_tables(self, scratch_tile: int, gmax: int = 16):
        """Index tables for the batched-group solve
        (``ops.kernels_torch.mega_solve_groups`` and its CUDA kernel):
        one step per super-level chunk of ``G <= gmax`` columns, for
        both sweeps (equal-depth columns share no tile in either
        triangle; the backward sweep walks the groups in reverse).

        Panel rows are packed ``[ngroups, 3, W]``: row 0 tile ids, row 1
        x-segment rows, row 2 the member each tile belongs to.  ``kseg``
        pads with ``block_length`` (the scratch x segment)."""
        bl = self.block_length
        groups = [mem[s:s + gmax] for mem in self.superlevels()
                  for s in range(0, len(mem), gmax)]
        ngr = len(groups)
        nl_tot = max((sum(len(self.levels[k].lpanel) for k in g)
                      for g in groups), default=0)
        nuc_tot = max((sum(len(self.levels[k].ucolpanel) for k in g)
                       for g in groups), default=0)
        w = -(-max(bucket(max(nl_tot, nuc_tot, 1)), 1) // 128) * 128
        kseg = np.full((ngr, gmax), bl, dtype=np.int32)
        nl_g = np.zeros(ngr, dtype=np.int32)
        nuc_g = np.zeros(ngr, dtype=np.int32)
        ltab = np.zeros((ngr, 3, w), dtype=np.int32)
        uctab = np.zeros((ngr, 3, w), dtype=np.int32)
        ltab[:, 0] = scratch_tile
        ltab[:, 1] = bl
        uctab[:, 0] = scratch_tile
        uctab[:, 1] = bl
        for gi, g in enumerate(groups):
            ol = ou = 0
            for mi, k in enumerate(g):
                lev = self.levels[k]
                kseg[gi, mi] = k
                nlk = len(lev.lpanel)
                nuk = len(lev.ucolpanel)
                ltab[gi, 0, ol:ol + nlk] = lev.lpanel
                ltab[gi, 1, ol:ol + nlk] = lev.lrows
                ltab[gi, 2, ol:ol + nlk] = mi
                uctab[gi, 0, ou:ou + nuk] = lev.ucolpanel
                uctab[gi, 1, ou:ou + nuk] = lev.ucolrows
                uctab[gi, 2, ou:ou + nuk] = mi
                ol += nlk
                ou += nuk
            nl_g[gi] = ol
            nuc_g[gi] = ou
        return dict(kseg_tab=kseg, nl_tab=nl_g, nuc_tab=nuc_g,
                    ltab=ltab, uctab=uctab, ngroups=ngr, gmax=gmax,
                    row_w=w)

    def fused_overhead(self) -> float:
        """Padded / real work of the JAX package's fused engine's Schur
        stage (pangulu_tpu/schedule.py:685-692), which pads every level
        to the most updates of any; above 6 the JAX package takes its
        segmented engine.  The port's engines pad nothing and log it."""
        real = max(self.n_ssssm, 1)
        padded = self.block_length * max(self.max_updates, 1)
        return padded / real

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


def prodrow_tiers(pch: int) -> tuple:
    """The TPU kernel's product-row width tiers (pch, pch/2, ... down
    to 4 tiles, at most 4), whose index ``group_mega_tables`` packs into
    each ``udu`` word.  Kept for bit parity of the tables."""
    tiers = [pch]
    while tiers[-1] > 4 and len(tiers) < 4:
        tiers.append(tiers[-1] // 2)
    return tuple(tiers)


def check_ahead(tables: dict) -> None:
    """Raise unless every flagged level of chain-ahead tables
    (``Schedule.mega_tables(superlevel=True)``) has a diagonal tile that
    the level before it neither holds in its panels nor updates: the
    card runs that diagonal step while the level before it still runs.
    Equal depth means no pattern adjacency (``block_depths``), so this
    holds by construction; the check keeps a wrong table from racing."""
    uch = int(tables["uch"])
    for k in np.flatnonzero(tables["flag_tab"]):
        p = k - 1
        written = np.concatenate([
            tables["lid_tab"][p, :tables["nl_tab"][p]],
            tables["uid_tab"][p, :tables["nu_tab"][p]],
            tables["udst_tab"][p, :, :uch].reshape(-1)[
                :tables["nup_tab"][p]]])
        if tables["diag_tab"][k] in written:
            raise ValueError(
                f"chain-ahead tables: level {int(tables['lev_tab'][k])}'s "
                f"diagonal tile {int(tables['diag_tab'][k])} is a panel or "
                f"Schur destination of level {int(tables['lev_tab'][p])}, "
                "which runs beside its diagonal step")


def group_update_lists(tables: dict) -> list:
    """Per group of ``group_mega_tables``, its Schur updates as arrays
    ``(dst, l, u)`` in table order: chunks read in order, the first
    ``uch`` entries of each row, ``nup`` in all, with ``l``/``u``
    decoded from the packed words (indices into the group's
    concatenated panels)."""
    uch = int(tables["uch"])
    out = []
    for g, nup in enumerate(tables["nup_tab"]):
        nup = int(nup)
        dst, l, u = (tables[k][g, :, :uch].reshape(-1)[:nup]
                     for k in ("udst_tab", "udl_tab", "udu_tab"))
        out.append((dst, l & 0xFFFFF, u & 0xFFF))
    return out


def _csr_by_key(keys: list) -> dict:
    """Per group, the distinct values of its key array in order of
    first appearance, each with the positions where it occurs, in
    order.  Flat over all groups: ``key[d]`` is distinct value d and
    ``ent[ptr[d]:ptr[d+1]]`` its positions; group g owns
    ``off[g] : off[g] + cnt[g]``."""
    key_all, ptr, ent, off, cnt = [], [0], [], [], []
    for key in keys:
        uniq, first, inv = np.unique(np.asarray(key), return_index=True,
                                     return_inverse=True)
        by_first = np.argsort(first)
        rank = np.empty(len(uniq), np.int64)
        rank[by_first] = np.arange(len(uniq))
        r = rank[inv.reshape(-1)]
        off.append(len(key_all))
        cnt.append(len(uniq))
        key_all.extend(uniq[by_first])
        ptr.extend(len(ent) + np.cumsum(np.bincount(r,
                                                    minlength=len(uniq))))
        ent.extend(np.argsort(r, kind="stable"))
    return {k: np.asarray(v, np.int32) for k, v in
            dict(key=key_all, ptr=ptr, ent=ent, off=off, cnt=cnt).items()}


def group_dst_csr(tables: dict) -> dict:
    """A view of ``group_mega_tables`` for the CUDA kernel: per group,
    its distinct Schur destinations (``key``, tile ids), each with its
    updates (``ent``: indices into the group's update list of
    :func:`group_update_lists`, in table order).  Layout of
    :func:`_csr_by_key`."""
    return _csr_by_key([dst for dst, _, _ in group_update_lists(tables)])


def group_row_csr(tables: dict, sweep: str) -> dict:
    """A view of ``group_solve_tables`` for the CUDA kernel: per group,
    the distinct x rows (``key``) that its panel tiles update in one
    sweep (``"l"`` forward, ``"uc"`` backward), each with its panel
    entries (``ent``: columns of the group's ``ltab``/``uctab`` row, in
    table order).  Layout of :func:`_csr_by_key`."""
    tab, cnt = ((tables["ltab"], tables["nl_tab"]) if sweep == "l"
                else (tables["uctab"], tables["nuc_tab"]))
    return _csr_by_key([tab[g, 1, :n] for g, n in enumerate(cnt)])


def group_solve_steps(tables: dict, sweep: str, bl: int) -> dict:
    """The step schedule of one sweep of ``group_solve_tables`` that the
    CUDA kernel walks, one grid barrier between two steps.

    An item ``(seg, inv, e0, e1)`` of a step computes ``v = src[seg] -
    sum T_t · dst[k_t]`` over its entries ``t`` (``ent[e0:e1]``, rows
    ``(tile id, source segment k_t)`` in table order) and writes ``inv_seg
    · v`` to ``dst[seg]`` when ``inv`` is 1, else ``v`` back to
    ``src[seg]``.  The sweep walks the groups forward (``"l"``) or
    backward (``"uc"``); a group's x rows (``group_row_csr``) are never
    its members.

    Consecutive groups (in sweep order) join one bundle while none of a
    group's members is a row of the bundle and none of its rows a member
    (chunks of one super-level do); step p holds the row updates of the
    p-th bundle, a row that several of its groups update summing their
    entries in group order, and the members of the next bundle, a row
    that is also such a member being one item (the update, then its
    inverse): one barrier a bundle.  Empty steps are dropped.  Every item of a step has its own segment,
    every ``dst[k_t]`` it reads was written in an earlier step, and every
    member is written to ``dst`` once.

    Returns ``step`` [nsteps+1, 2] (first item, first entry of each
    step), ``item`` [nitems, 4], ``ent`` [nent, 2] and ``width``, the
    most items of one step."""
    tab = tables["ltab"] if sweep == "l" else tables["uctab"]
    csr = group_row_csr(tables, sweep)
    kseg = tables["kseg_tab"]
    ng = int(tables["ngroups"])

    def rows(g):
        """(segment, entries) of each distinct row of group g."""
        out = []
        for d in range(csr["off"][g], csr["off"][g] + csr["cnt"][g]):
            t = csr["ent"][csr["ptr"][d]:csr["ptr"][d + 1]]
            out.append((int(csr["key"][d]),
                        np.stack([tab[g, 0, t], kseg[g, tab[g, 2, t]]], 1)))
        return out

    def members(g):
        return [int(k) for k in kseg[g][kseg[g] != bl]]

    order = list(range(ng)) if sweep == "l" else list(range(ng))[::-1]
    bundles = []   # (members, {row: [entries of each group]})
    for g in order:
        mem, upd = members(g), rows(g)
        if not (bundles and bundles[-1][1].keys().isdisjoint(mem)
                and {k for k, _ in upd}.isdisjoint(bundles[-1][0])):
            bundles.append(([], {}))
        bundles[-1][0].extend(mem)
        for k, e in upd:
            bundles[-1][1].setdefault(k, []).append(e)
    steps = []
    for p in range(len(bundles) + 1):
        upd = bundles[p - 1][1] if p else {}
        mem = bundles[p][0] if p < len(bundles) else []
        steps.append([(k, k in mem, np.concatenate(e))
                      for k, e in upd.items()]
                     + [(k, True, None) for k in mem if k not in upd])
    step, item, ent = [[0, 0]], [], []
    for s in steps:
        if not s:
            continue
        for k, inv, e in s:
            n = 0 if e is None else len(e)
            item.append([k, int(inv), len(ent), len(ent) + n])
            if n:
                ent.extend(e.tolist())
        step.append([len(item), len(ent)])
    step = np.asarray(step, np.int32)
    item = np.asarray(item, np.int32).reshape(-1, 4)
    ent = np.asarray(ent, np.int32).reshape(-1, 2)
    return dict(step=step, item=item, ent=ent,
                width=int(np.diff(step[:, 0]).max(initial=0)))


def occurrence(keys: np.ndarray) -> np.ndarray:
    """Per entry of ``keys``, how many earlier entries hold the same
    key (0 at a key's first appearance)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    idx = np.arange(len(ks))
    start = np.maximum.accumulate(
        np.where(np.r_[True, ks[1:] != ks[:-1]], idx, 0))
    occ = np.empty_like(idx)
    occ[order] = idx - start
    return occ


def group_runs(sig: list, min_run: int) -> list:
    """Runs of consecutive equal signatures, each run shorter than
    ``min_run`` merged into its predecessor (or its predecessor into it,
    when the predecessor is short) under the elementwise-max signature
    (pangulu_tpu/schedule.py:824-844).  Returns ``[[start,
    end_exclusive, sig], ...]``."""
    runs = []
    s = 0
    for i in range(1, len(sig) + 1):
        if i == len(sig) or sig[i] != sig[s]:
            runs.append([s, i, sig[s]])
            s = i
    merged = []
    for run in runs:
        if merged and (run[1] - run[0] < min_run
                       or merged[-1][1] - merged[-1][0] < min_run):
            prev = merged[-1]
            prev[1] = run[1]
            prev[2] = tuple(max(a, b) for a, b in zip(prev[2], run[2]))
        else:
            merged.append(run)
    return merged


def bucket(n: int) -> int:
    """Pad a batch size to the next power of two (the static-shape
    analogue of the reference's 7 geometric storage-bin capacity
    classes, pangulu_preprocessing.c:325-332)."""
    if n <= 0:
        return 0
    return 1 << (n - 1).bit_length()


def waste_aware_runs(sig: list, weights: tuple, lam: float) -> list:
    """Split a per-group signature sequence into contiguous runs
    minimizing the total padded cost: each run is padded to its
    elementwise-max signature, costing ``len(run) * dot(weights,
    max_sig)``, plus ``lam`` per run.  Returns ``[[start,
    end_exclusive, max_sig], ...]``, the runs of
    ``pangulu_tpu.schedule.waste_aware_runs`` (pangulu_tpu/schedule.py:
    774) exactly.

    The same dynamic programme, with its inner loop over the run's
    start ``j`` in numpy: the run maxima over ``sig[j:i]`` for every
    ``j`` are one ``np.maximum.accumulate`` over the reversed prefix,
    and the costs are summed in the reference's order, so ties resolve
    alike (the first strict minimum from ``j = i - 1`` down)."""
    n = len(sig)
    if n == 0:
        return []
    s = np.asarray(sig, dtype=np.int64).reshape(n, -1)
    w = [float(x) for x in weights]
    best = np.full(n + 1, np.inf)
    best[0] = 0.0
    cut = np.zeros(n + 1, dtype=np.int64)
    for i in range(1, n + 1):
        # mx[t]: the maxima of sig[i - 1 - t : i], run start j = i - 1 - t
        mx = np.maximum.accumulate(s[i - 1::-1], axis=0).astype(np.float64)
        vol = 0.0
        for d, wd in enumerate(w):
            vol = vol + wd * mx[:, d]
        j = np.arange(i - 1, -1, -1)
        c = best[j] + (i - j) * vol + lam
        t = int(np.argmin(c))
        best[i], cut[i] = c[t], j[t]
    runs = []
    i = n
    while i > 0:
        j = int(cut[i])
        runs.append([j, i, tuple(max(vals) for vals in zip(*sig[j:i]))])
        i = j
    runs.reverse()
    return runs
