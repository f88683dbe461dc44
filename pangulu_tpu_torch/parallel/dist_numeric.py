"""Distributed 2D block-cyclic numeric factorization over a grid of ranks.

Counterpart of ``pangulu_tpu.parallel.dist_numeric`` (its f32/f64
collective engine, pangulu_tpu/parallel/dist_numeric.py:55-608,773-902)
and through it of the reference's distributed numeric engine
(pangulu_numeric.c + pangulu_communication.c): rank (r, c) of a p x q
:class:`~pangulu_tpu_torch.parallel.mesh.Grid` holds the tiles of the
blocks (i, j) with (i % p, j % q) = (r, c) in a local store of
``layout.lmax`` slots (the last a scratch slot), and every rank walks
the same super-level groups (independent same-depth columns, at most
:data:`DIST_GROUP_GMAX` a group).  For each group, on every rank:

  1. the backend's diagonal step once on the group's diagonal tiles:
     for real tiles on the card one batched launch of K1,
     :func:`~pangulu_tpu_torch.ops.kernels_cuda.getrf_with_inverses`, at
     every nb (its cluster kernel up to 512, the recursion above), for
     complex tiles and on the CPU ``kernels_xla`` (the ``"torch"``
     backend, :mod:`~pangulu_tpu_torch.ops.interface`), as the JAX
     package's engine takes ``backend.diag_factor_invert``
     (the tiles came in by an all-reduce over the world to which only
     each tile's owner contributed; every rank factors them all,
     cheaper than a second broadcast); the owners keep the factors in
     their shard, and every rank keeps them in ``diag`` (``[bl, nb,
     nb]`` by level), which lets the distributed solve take one
     all-reduce a group where the JAX package's takes two;
  2. the L-panel products ``T·U^-1`` on the ranks owning the panel
     tiles, then an all-reduce over each grid row;
  3. the U-panel products ``L^-1·T``, then an all-reduce over each grid
     column: each rank now holds the panel tiles its updates read;
  4. the critical Schur updates, those that feed the next group's
     diagonal tiles;
  5. the next group's diagonal all-reduce, issued asynchronously
     (lookahead, pangulu_tpu/parallel/dist_numeric.py:571-591; waited
     on at the top of the next group);
  6. the bulk Schur updates, beside it.

The host tables (:func:`level_tables`) are the JAX package's
``_prepare_levels`` bit for bit, full ``[p, q, ...]`` tables built on
every rank; each rank keeps its own ``[r, c]`` row as index lists on its
device (:class:`_Step`).  Products are ``torch.matmul`` in true f32
(:func:`~pangulu_tpu_torch.ops.kernels_torch.true_f32_matmul`).  The
Schur updates subtract wave by wave, a wave being the updates of one
group member: within a level the destinations are unique, so each
wave's ``index_add_`` adds once a destination and two factorizations
give the same bits.

A 1 x 1 grid delegates to the single-device
:class:`~pangulu_tpu_torch.numeric.LUFactorizer` (K2 or K4; the fused
engine above nb = 256 and for complex tiles) unless
``force_collective``.  Complex tiles cross the all-reduces as their real
views (:meth:`~pangulu_tpu_torch.parallel.mesh.Grid.all_reduce`).  The double-float engine of the JAX package is not
ported: f64 is native on the H100, and r64 runs K1's ``double`` instance
and f64 products here.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from pangulu_tpu_torch.blocks import BlockedMatrix
from pangulu_tpu_torch.numeric import LUFactorizer, resolve_backend
from pangulu_tpu_torch.ops.kernels_torch import DEFAULT_TOL, true_f32_matmul
from pangulu_tpu_torch.parallel.mesh import Grid
from pangulu_tpu_torch.parallel.multihost import (put_grid_sharded,
                                                  put_replicated)
from pangulu_tpu_torch.schedule import (Schedule, bucket, build_schedule,
                                        waste_aware_runs)
from pangulu_tpu_torch.utils.log import get_logger
from pangulu_tpu_torch.utils.perf import PerfCounters, device_sync

log = get_logger()

# Super-level group width cap (pangulu_tpu/parallel/dist_numeric.py:230):
# bounds the group-concatenated panel tables and the [G, nb, nb] batch
# of K1.  Chain schedules give groups of one.
DIST_GROUP_GMAX = 16


@dataclasses.dataclass
class DistLayout:
    """Host-side block-cyclic placement of tiles onto the grid."""

    p: int
    q: int
    lmax: int                 # local slots per rank (incl. scratch)
    tile_owner_r: np.ndarray  # (num_tiles,)
    tile_owner_c: np.ndarray
    tile_slot: np.ndarray     # (num_tiles,) local slot on the owner


def tile_coords(blocked: BlockedMatrix) -> tuple:
    """Block row and block column of every tile id."""
    rows = np.asarray(blocked.browidx, dtype=np.int64)
    cols = np.repeat(np.arange(blocked.block_length, dtype=np.int64),
                     np.diff(blocked.bcolptr))
    return rows, cols


def build_layout(blocked: BlockedMatrix, p: int, q: int) -> DistLayout:
    """The JAX package's layout (pangulu_tpu/parallel/dist_numeric.py:
    66-84): a tile's local slot is its rank among its owner's tiles in
    tile-id order; one scratch slot a rank after them."""
    rows, cols = tile_coords(blocked)
    owner_r = (rows % p).astype(np.int32)
    owner_c = (cols % q).astype(np.int32)
    key = owner_r.astype(np.int64) * q + owner_c
    order = np.argsort(key, kind="stable")
    ks = key[order]
    idx = np.arange(len(ks))
    start = np.maximum.accumulate(
        np.where(np.r_[True, ks[1:] != ks[:-1]], idx, 0)) if len(ks) else idx
    slot = np.empty(len(key), dtype=np.int32)
    slot[order] = idx - start
    counts = np.bincount(key, minlength=p * q)
    lmax = int(counts.max(initial=0)) + 1  # +1 scratch slot per rank
    return DistLayout(p=p, q=q, lmax=lmax, tile_owner_r=owner_r,
                      tile_owner_c=owner_c, tile_slot=slot)


def scatter_tiles(blocked: BlockedMatrix, layout: DistLayout) -> np.ndarray:
    """[p, q, lmax, nb, nb] host array in block-cyclic layout."""
    out = np.zeros((layout.p, layout.q, layout.lmax, blocked.nb, blocked.nb),
                   dtype=blocked.dtype)
    out[layout.tile_owner_r, layout.tile_owner_c, layout.tile_slot] = \
        blocked.tiles[: blocked.num_tiles]
    return out


def _shard_plan(blocked: BlockedMatrix, layout: DistLayout, r: int, c: int):
    """The scatter plan's entries of rank (r, c), with local slots."""
    tid, ri, cj, vals = blocked.scatter_plan
    tid = np.asarray(tid, dtype=np.int64)
    sel = (layout.tile_owner_r[tid] == r) & (layout.tile_owner_c[tid] == c)
    return (layout.tile_slot[tid[sel]].astype(np.int64), ri[sel], cj[sel],
            vals[sel])


def scatter_tiles_shard(blocked: BlockedMatrix, layout: DistLayout,
                        r: int, c: int) -> np.ndarray:
    """Rank (r, c)'s [lmax, nb, nb] shard on the host, from the O(nnz)
    scatter plan (no other rank's tiles are built: the counterpart of
    the reference's rank-0 scatter, pangulu_communication.c:227-761)."""
    slot, ri, cj, vals = _shard_plan(blocked, layout, r, c)
    out = np.zeros((layout.lmax, blocked.nb, blocked.nb), dtype=blocked.dtype)
    np.add.at(out, (slot, ri, cj), vals)
    return out


def shard_tiles(blocked: BlockedMatrix, layout: DistLayout, r: int, c: int,
                device) -> torch.Tensor:
    """Rank (r, c)'s [lmax, nb, nb] shard built on ``device`` (only the
    O(nnz) plan crosses to it), as ``BlockedMatrix.device_tiles``
    builds the whole store."""
    slot, ri, cj, vals = _shard_plan(blocked, layout, r, c)
    t = torch.zeros((layout.lmax, blocked.nb, blocked.nb),
                    dtype=blocked.torch_dtype, device=device)
    idx = tuple(torch.as_tensor(np.asarray(v, dtype=np.int64), device=device)
                for v in (slot, ri, cj))
    return t.index_put_(idx, torch.as_tensor(vals, device=device),
                        accumulate=True)


def gather_tiles(blocked: BlockedMatrix, layout: DistLayout,
                 dist_tiles: np.ndarray) -> np.ndarray:
    """[p, q, lmax, nb, nb] shards -> the global [num_tiles+1, nb, nb]
    store (the tests assemble the ranks' shards; no rank gathers)."""
    host = np.asarray(dist_tiles)
    nb = blocked.nb
    out = np.zeros((blocked.num_tiles + 1, nb, nb), dtype=host.dtype)
    out[: blocked.num_tiles] = host[
        layout.tile_owner_r, layout.tile_owner_c, layout.tile_slot]
    return out


def dist_groups(schedule: Schedule) -> list:
    """The engines' groups: each super-level (independent same-depth
    columns) cut into runs of at most :data:`DIST_GROUP_GMAX` levels."""
    g = DIST_GROUP_GMAX
    return [mem[s:s + g] for mem in schedule.superlevels()
            for s in range(0, len(mem), g)]


def level_tables(schedule: Schedule, layout: DistLayout,
                 perf: PerfCounters | None = None) -> list:
    """The segment tables of the JAX package's
    ``DistributedLU._prepare_levels`` (pangulu_tpu/parallel/
    dist_numeric.py:232-480), bit for bit: per segment (a run of groups
    from :func:`~pangulu_tpu_torch.schedule.waste_aware_runs`),
    ``(kmat, (l_mem, u_mem), (G, NL, NU, NUP, NCRIT), tables)`` with
    the ``[p, q, seg, ...]`` tables diag_slot, l_slot, l_mask, u_slot,
    u_mask, upd_dst, upd_l, upd_u, upd_mask, upd_wave, crit_dst,
    crit_l, crit_u, crit_mask, crit_wave.  An update is critical when it
    feeds a diagonal tile of the next group of its segment; a wave is
    the member of the group whose level made the update.  Sets
    ``perf.kernels["dist_panel_mib"]`` (the panel bytes the JAX engine
    ships, padded to each segment's widths, f32 items) and
    ``["dist_groups"]``."""
    lay, p, q = layout, layout.p, layout.q
    scratch = lay.lmax - 1
    bl = schedule.block_length
    levels = schedule.levels
    slot = lay.tile_slot

    nl_k = np.array([len(l.lpanel) for l in levels], dtype=np.int64)
    nu_k = np.array([len(l.upanel) for l in levels], dtype=np.int64)
    nup_k = np.array([len(l.upd_dst) for l in levels], dtype=np.int64)

    groups = dist_groups(schedule)
    ngr = len(groups)
    gsize = np.array([len(g) for g in groups], dtype=np.int64)
    lev_grp = np.zeros(bl, dtype=np.int64)
    lev_mem = np.zeros(bl, dtype=np.int64)
    l_woff = np.zeros(bl, dtype=np.int64)  # panel offset in group
    u_woff = np.zeros(bl, dtype=np.int64)
    gnl = np.zeros(ngr, dtype=np.int64)    # group panel totals
    gnu = np.zeros(ngr, dtype=np.int64)
    for gi, g in enumerate(groups):
        ol = ou = 0
        for mi, k in enumerate(g):
            lev_grp[k] = gi
            lev_mem[k] = mi
            l_woff[k] = ol
            u_woff[k] = ou
            ol += int(nl_k[k])
            ou += int(nu_k[k])
        gnl[gi], gnu[gi] = ol, ou

    def _cat(arrs, dtype=np.int64):
        arrs = [np.asarray(a, dtype=dtype) for a in arrs if len(a)]
        return (np.concatenate(arrs) if arrs
                else np.empty(0, dtype=dtype))

    def _pos_in_key(key):
        # index of each entry within its run of equal keys, in entry
        # order (a stable sort by key, then the index within the run)
        order = np.argsort(key, kind="stable")
        ks = key[order]
        idx = np.arange(len(ks))
        start = np.maximum.accumulate(
            np.where(np.r_[True, ks[1:] != ks[:-1]], idx, 0))
        pos = np.empty_like(idx)
        pos[order] = idx - start
        return pos

    # updates over every level; panel indices become positions in the
    # group-concatenated panel lists
    u_lev = np.repeat(np.arange(bl), nup_k)
    u_dst = _cat([l.upd_dst for l in levels])
    u_l = _cat([l.upd_l for l in levels])
    u_u = _cat([l.upd_u for l in levels])
    u_r = lay.tile_owner_r[u_dst] if len(u_dst) else u_dst
    u_c = lay.tile_owner_c[u_dst] if len(u_dst) else u_dst
    if len(u_dst):
        u_grp = lev_grp[u_lev]
        u_lg = u_l + l_woff[u_lev]
        u_ug = u_u + u_woff[u_lev]
        key = (u_grp * p + u_r) * q + u_c
        pos = _pos_in_key(key)
        counts = np.bincount(key, minlength=ngr * p * q)
        dev_nupd_g = counts.reshape(ngr, p, q).max(axis=(1, 2))
    else:
        u_grp = u_lg = u_ug = pos = u_dst
        dev_nupd_g = np.zeros(ngr, dtype=np.int64)

    l_lev = np.repeat(np.arange(bl), nl_k)
    l_tid = _cat([l.lpanel for l in levels])
    l_bi = _cat([l.lrows for l in levels])
    l_pos = (np.arange(len(l_lev))
             - np.repeat(np.r_[0, np.cumsum(nl_k)[:-1]], nl_k))
    l_grp = lev_grp[l_lev]
    l_gpos = l_pos + l_woff[l_lev]
    g_lev = np.repeat(np.arange(bl), nu_k)
    g_tid = _cat([l.upanel for l in levels])
    g_bj = _cat([l.ucols for l in levels])
    g_pos = (np.arange(len(g_lev))
             - np.repeat(np.r_[0, np.cumsum(nu_k)[:-1]], nu_k))
    g_grp = lev_grp[g_lev]
    g_gpos = g_pos + u_woff[g_lev]

    diag_gid = np.full(len(lay.tile_slot) + 1, -1, dtype=np.int64)
    for k in range(bl):
        diag_gid[levels[k].diag] = lev_grp[k]

    sig = [(bucket(int(gsize[gi])),
            bucket(max(int(gnl[gi]), 1)),
            bucket(max(int(gnu[gi]), 1)),
            bucket(max(int(dev_nupd_g[gi]), 1)))
           for gi in range(ngr)]
    # the JAX package's weights and per-run cost (measured on its chip)
    runs = waste_aware_runs(sig, weights=(12.0, 1.0, 1.0, 2.0), lam=400.0)
    nb = schedule.nb
    item = 4
    real_b = padded_b = 0
    for s0, s1, _sig in runs:
        w_nl = max(int(gnl[s0:s1].max(initial=0)), 1)
        w_nu = max(int(gnu[s0:s1].max(initial=0)), 1)
        real_b += int((gnl[s0:s1].sum() + gnu[s0:s1].sum())
                      * nb * nb * item)
        padded_b += (s1 - s0) * (w_nl + w_nu) * nb * nb * item
    if real_b:
        log.info("dist panel exchange (JAX padding): %.1f MiB real, %.1f "
                 "MiB padded over %d segments, %d level groups (%d levels)",
                 real_b / 2 ** 20, padded_b / 2 ** 20, len(runs), ngr, bl)
        if perf is not None:
            perf.kernels["dist_panel_mib"] = round(padded_b / 2 ** 20, 2)
            perf.kernels["dist_groups"] = ngr
    out = []
    for s0, s1, _sig in runs:
        G = max(int(gsize[s0:s1].max(initial=0)), 1)
        NL = max(int(gnl[s0:s1].max(initial=0)), 1)
        NU = max(int(gnu[s0:s1].max(initial=0)), 1)
        NUP = max(int(dev_nupd_g[s0:s1].max(initial=0)), 1)
        seg = s1 - s0
        kmat = np.full((seg, G), -1, dtype=np.int32)
        diag_slot = np.full((p, q, seg, G), scratch, dtype=np.int32)
        for gi in range(s0, s1):
            for mi, k in enumerate(groups[gi]):
                kmat[gi - s0, mi] = k
                diag_slot[k % p, k % q, gi - s0, mi] = slot[levels[k].diag]

        l_mem = np.zeros((seg, NL), dtype=np.int32)
        u_mem = np.zeros((seg, NU), dtype=np.int32)
        l_slot = np.full((p, q, seg, NL), scratch, dtype=np.int32)
        l_mask = np.zeros((p, q, seg, NL), dtype=bool)
        m = (l_grp >= s0) & (l_grp < s1)
        l_slot[l_bi[m] % p, l_lev[m] % q, l_grp[m] - s0,
               l_gpos[m]] = slot[l_tid[m]]
        l_mask[l_bi[m] % p, l_lev[m] % q, l_grp[m] - s0, l_gpos[m]] = True
        l_mem[l_grp[m] - s0, l_gpos[m]] = lev_mem[l_lev[m]]

        u_slot = np.full((p, q, seg, NU), scratch, dtype=np.int32)
        u_mask = np.zeros((p, q, seg, NU), dtype=bool)
        m = (g_grp >= s0) & (g_grp < s1)
        u_slot[g_lev[m] % p, g_bj[m] % q, g_grp[m] - s0,
               g_gpos[m]] = slot[g_tid[m]]
        u_mask[g_lev[m] % p, g_bj[m] % q, g_grp[m] - s0, g_gpos[m]] = True
        u_mem[g_grp[m] - s0, g_gpos[m]] = lev_mem[g_lev[m]]

        m = (u_grp >= s0) & (u_grp < s1)
        crit = m & (diag_gid[u_dst] == u_grp + 1) & (u_grp + 1 < s1)
        if crit.any():
            ckey = (u_grp[crit] * p + u_r[crit]) * q + u_c[crit]
            cpos = _pos_in_key(ckey)
            NCRIT = int(np.bincount(ckey).max())
        else:
            cpos = np.zeros(0, dtype=np.int64)
            NCRIT = 1

        upd_dst = np.full((p, q, seg, NUP), scratch, dtype=np.int32)
        upd_l = np.zeros((p, q, seg, NUP), dtype=np.int32)
        upd_u = np.zeros((p, q, seg, NUP), dtype=np.int32)
        upd_mask = np.zeros((p, q, seg, NUP), dtype=bool)
        upd_wave = np.zeros((p, q, seg, NUP), dtype=np.int32)
        at = (u_r[m], u_c[m], u_grp[m] - s0, pos[m])
        upd_dst[at] = slot[u_dst[m]]
        upd_l[at] = u_lg[m]
        upd_u[at] = u_ug[m]
        upd_mask[at] = ~crit[m]
        upd_wave[at] = lev_mem[u_lev[m]]

        crit_dst = np.full((p, q, seg, NCRIT), scratch, dtype=np.int32)
        crit_l = np.zeros((p, q, seg, NCRIT), dtype=np.int32)
        crit_u = np.zeros((p, q, seg, NCRIT), dtype=np.int32)
        crit_mask = np.zeros((p, q, seg, NCRIT), dtype=bool)
        crit_wave = np.zeros((p, q, seg, NCRIT), dtype=np.int32)
        if crit.any():
            at = (u_r[crit], u_c[crit], u_grp[crit] - s0, cpos)
            crit_dst[at] = slot[u_dst[crit]]
            crit_l[at] = u_lg[crit]
            crit_u[at] = u_ug[crit]
            crit_mask[at] = True
            crit_wave[at] = lev_mem[u_lev[crit]]

        out.append((kmat, (l_mem, u_mem), (G, NL, NU, NUP, NCRIT), dict(
            diag_slot=diag_slot, l_slot=l_slot, l_mask=l_mask,
            u_slot=u_slot, u_mask=u_mask, upd_dst=upd_dst, upd_l=upd_l,
            upd_u=upd_u, upd_mask=upd_mask, upd_wave=upd_wave,
            crit_dst=crit_dst, crit_l=crit_l, crit_u=crit_u,
            crit_mask=crit_mask, crit_wave=crit_wave)))
    return out


def tables_digest(*arrays) -> bytes:
    """A digest of index tables (shape, dtype and bytes of each)."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.shape}{a.dtype}".encode())
        h.update(a.tobytes())
    return h.digest()


@dataclasses.dataclass
class Waves:
    """Index lists of one rank's updates in a group, sorted by wave
    (the member whose level made them); ``bounds[w]:bounds[w+1]`` is a
    wave, within which the destinations are unique."""

    dst: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    bounds: list

    @classmethod
    def build(cls, mask, wave, dst, a, b, put) -> "Waves":
        e = np.flatnonzero(mask)
        e = e[np.argsort(wave[e], kind="stable")]
        w = wave[e]
        cuts = np.flatnonzero(np.r_[True, w[1:] != w[:-1]]) if len(e) else []
        return cls(dst=put(dst[e]), a=put(a[e]), b=put(b[e]),
                   bounds=[int(v) for v in cuts] + [len(e)])

    def spans(self):
        return zip(self.bounds[:-1], self.bounds[1:])


@dataclasses.dataclass
class _Step:
    """One group on this rank: its members, the diagonal tiles it owns
    (member index, local slot), the L and U panel tiles it owns (their
    positions in the group's panel lists, local slots, members), and
    its critical and bulk updates."""

    size: int
    km: torch.Tensor
    own_m: torch.Tensor
    own_slot: torch.Tensor
    nl: int
    l_pos: torch.Tensor
    l_slot: torch.Tensor
    l_mem: torch.Tensor
    nu: int
    u_pos: torch.Tensor
    u_slot: torch.Tensor
    u_mem: torch.Tensor
    crit: Waves
    bulk: Waves


def _index_putter(grid: Grid):
    """Host index lists -> int64 tensors on the rank's device."""
    def put(a):
        return put_replicated(grid, np.asarray(a, dtype=np.int64))
    return put


def rank_steps(segment, grid: Grid) -> list:
    """This rank's :class:`_Step` list for one segment of
    :func:`level_tables`: row ``[r, c]`` of its tables, as index lists
    on the rank's device."""
    kmat, (l_mem, u_mem), _sig, t = segment
    p, q, r, c = grid.p, grid.q, grid.r, grid.c
    put = _index_putter(grid)
    gsize = (kmat >= 0).sum(axis=1)
    # the group's panel list lengths: every position has one owner
    gnl = t["l_mask"].any(axis=(0, 1)).sum(axis=1)
    gnu = t["u_mask"].any(axis=(0, 1)).sum(axis=1)
    row = {k: v[r, c] for k, v in t.items()}
    steps = []
    for i in range(kmat.shape[0]):
        km = kmat[i, : gsize[i]].astype(np.int64)
        own = np.flatnonzero((km % p == r) & (km % q == c))
        lp = np.flatnonzero(row["l_mask"][i])
        up = np.flatnonzero(row["u_mask"][i])
        steps.append(_Step(
            size=int(gsize[i]), km=put(km), own_m=put(own),
            own_slot=put(row["diag_slot"][i, own]),
            nl=int(gnl[i]), l_pos=put(lp), l_slot=put(row["l_slot"][i, lp]),
            l_mem=put(l_mem[i, lp]),
            nu=int(gnu[i]), u_pos=put(up), u_slot=put(row["u_slot"][i, up]),
            u_mem=put(u_mem[i, up]),
            crit=Waves.build(row["crit_mask"][i], row["crit_wave"][i],
                             row["crit_dst"][i], row["crit_l"][i],
                             row["crit_u"][i], put),
            bulk=Waves.build(row["upd_mask"][i], row["upd_wave"][i],
                             row["upd_dst"][i], row["upd_l"][i],
                             row["upd_u"][i], put)))
    return steps


def subtract_updates(tiles: torch.Tensor, upd: Waves, lpanel: torch.Tensor,
                     upanel: torch.Tensor) -> None:
    """``tiles[dst] -= lpanel[l] @ upanel[u]``, one wave at a time."""
    for s, e in upd.spans():
        prod = torch.matmul(lpanel[upd.a[s:e]], upanel[upd.b[s:e]])
        tiles.index_add_(0, upd.dst[s:e], prod, alpha=-1)


class DistributedLU:
    """gstrf over the ranks of ``grid`` (each rank builds one with the
    same arguments).  ``factorize()`` returns this rank's factored shard
    ``[lmax, nb, nb]`` on ``grid.device``; no rank gathers the factors.
    ``diag`` holds every level's factored diagonal tile on every rank
    (``[bl, nb, nb]``, rewritten in place by each factorization).
    ``comm`` holds the all-reduces of the last factorization and the
    bytes they carried, this rank's.  ``backend`` ("auto", "cuda",
    "torch" or a :class:`~pangulu_tpu_torch.ops.interface.KernelBackend`)
    gives the diagonal step, and the 1 x 1 delegate's."""

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule | None,
                 grid: Grid, perf: PerfCounters | None = None,
                 tol: float | None = None, force_collective: bool = False,
                 backend="auto"):
        self.blocked = blocked
        self.schedule = schedule or build_schedule(blocked)
        self.grid = grid
        self.p, self.q = grid.p, grid.q
        self.device = grid.device
        self.perf = perf or PerfCounters()
        self.tol = (tol if tol is not None
                    else DEFAULT_TOL[blocked.torch_dtype])
        self.backend = resolve_backend(backend, blocked.nb,
                                       blocked.torch_dtype, tol, self.device)
        self.layout = build_layout(blocked, self.p, self.q)
        self.single = None
        self.tiles = None       # this rank's factored shard
        self.diag = None        # every level's diagonal factor, replicated
        self.comm = {}
        if self.p * self.q == 1 and not force_collective:
            # no communication exists: the single-device engines (K2 or
            # K4), as the reference with mpirun -np 1 runs its kernels
            self.single = LUFactorizer(blocked, self.schedule,
                                       perf=self.perf, device=self.device,
                                       tol=tol, backend=backend)
            self._segments = None
            return
        segments = level_tables(self.schedule, self.layout, self.perf)
        lay = self.layout
        # every rank built these on its own: rank 0's must be everyone's
        self.digest = tables_digest(
            lay.tile_owner_r, lay.tile_owner_c, lay.tile_slot,
            *(a for s in segments
              for a in (s[0], *s[1], *(s[3][k] for k in sorted(s[3])))))
        grid.check_same(self.digest, "the distributed factorization's "
                        "tables")
        self.groups = sum(s[0].shape[0] for s in segments)
        self._segments = [rank_steps(s, grid) for s in segments]
        nb = blocked.nb
        self.diag = torch.zeros((self.schedule.block_length, nb, nb),
                                dtype=blocked.torch_dtype,
                                device=self.device)
        log.info("engine: dist (%d x %d grid, rank %d, %d groups in %d "
                 "segments)", self.p, self.q, grid.rank, self.groups,
                 len(segments))

    # ---- the step ----------------------------------------------------

    def _diag_all_reduce(self, st: _Step, tiles: torch.Tensor):
        nb = self.blocked.nb
        buf = tiles.new_zeros((st.size, nb, nb))
        if len(st.own_m):
            buf[st.own_m] = tiles[st.own_slot]
        return buf, self.grid.all_reduce(buf, "world", async_op=True)

    def _panel(self, tiles, n, pos, slot, inv, mem, over, left: bool):
        """The group's panel tiles owned here, solved against the
        member's inverse and written back; then all-reduced over
        ``over`` into the group's panel list of ``n`` tiles."""
        if n == 0:
            return None
        nb = self.blocked.nb
        buf = tiles.new_zeros((n, nb, nb))
        if len(pos):
            blk = (torch.matmul(inv[mem], tiles[slot]) if left
                   else torch.matmul(tiles[slot], inv[mem]))
            tiles[slot] = blk
            buf[pos] = blk
        self.grid.all_reduce(buf, over)
        return buf

    def _run_segment(self, tiles: torch.Tensor, steps: list) -> None:
        pending = self._diag_all_reduce(steps[0], tiles)
        for i, st in enumerate(steps):
            diag, work = pending
            work.wait()
            f, linv, uinv = self.backend.diag_factor_invert(diag, self.tol)
            self.diag[st.km] = f
            if len(st.own_m):
                tiles[st.own_slot] = f[st.own_m]
            lpanel = self._panel(tiles, st.nl, st.l_pos, st.l_slot, uinv,
                                 st.l_mem, "row", left=False)
            upanel = self._panel(tiles, st.nu, st.u_pos, st.u_slot, linv,
                                 st.u_mem, "col", left=True)
            subtract_updates(tiles, st.crit, lpanel, upanel)
            if i + 1 < len(steps):
                # lookahead: the next group's diagonal tiles are final
                # now (its critical updates landed); its all-reduce runs
                # beside the bulk updates
                pending = self._diag_all_reduce(steps[i + 1], tiles)
            subtract_updates(tiles, st.bulk, lpanel, upanel)

    # ---- driver --------------------------------------------------------

    def factorize(self) -> torch.Tensor:
        """Factor this rank's shard, built afresh from the blocked
        matrix's scatter plan (a refactorization after
        ``update_values`` re-scatters and reuses every table), and
        return it once the device is done."""
        if self.single is not None:
            self.tiles = self.single.factorize()
            return self.tiles
        with self.perf.phase("preprocess"):
            tiles = shard_tiles(self.blocked, self.layout, self.grid.r,
                                self.grid.c, self.device)
            device_sync(self.device)
        before = dict(self.grid.counts)
        with self.perf.phase("numeric"), true_f32_matmul():
            for steps in self._segments:
                self._run_segment(tiles, steps)
            device_sync(self.device)
        self.comm = {k: self.grid.counts[k] - before[k] for k in before}
        self.perf.add_flops(self.schedule.flop_estimate())
        self.perf.kernels.update(
            engine="dist", backend=self.backend.name,
            dist_grid=f"{self.p}x{self.q}",
            dist_all_reduces=self.comm["all_reduces"],
            dist_mib=round(self.comm["bytes"] / 2 ** 20, 3))
        self.tiles = tiles
        return tiles

    # ---- distributed factorization check -------------------------------

    def factor_check_vector(self) -> np.ndarray:
        """``w = L @ (U @ 1)`` over the sharded factors, without a
        gather (the reference's -DPANGULU_PERF check,
        pangulu_numeric.c:1082-1341, distributed as the JAX package's,
        pangulu_tpu/parallel/dist_numeric.py:773-853): each rank sums its
        tiles' contributions and two all-reduces over the world make
        the intermediate and the final vector whole on every rank.
        Returns w[:n], complex for complex tiles (the sums by block row
        use ``index_add_``, whose order on a CUDA device varies in the
        last bits)."""
        if self.single is not None:
            raise RuntimeError("single-device path: use gather_factor")
        if self.tiles is None:
            raise RuntimeError("factor_check_vector requires factorize()")
        lay, grid = self.layout, self.grid
        bl, nb = self.schedule.block_length, self.blocked.nb
        rows = np.full((lay.p, lay.q, lay.lmax), bl, dtype=np.int64)
        cols = np.full((lay.p, lay.q, lay.lmax), bl, dtype=np.int64)
        t_rows, t_cols = tile_coords(self.blocked)
        rows[lay.tile_owner_r, lay.tile_owner_c, lay.tile_slot] = t_rows
        cols[lay.tile_owner_r, lay.tile_owner_c, lay.tile_slot] = t_cols
        r = put_grid_sharded(grid, rows)
        c = put_grid_sharded(grid, cols)
        t = self.tiles
        ri, ci = r[:, None, None], c[:, None, None]
        ones = torch.ones((nb, nb), dtype=torch.bool, device=t.device)
        tri_u, tri_l = ones.triu(), ones.tril(-1)
        eye = torch.eye(nb, dtype=t.dtype, device=t.device)
        zero = torch.zeros((), dtype=t.dtype, device=t.device)
        with true_f32_matmul():
            # v = U @ 1 (strictly-upper tiles whole; the diagonal tile's
            # upper triangle)
            upart = torch.where(ri < ci, t, torch.where(
                (ri == ci) & tri_u, t, zero))
            v = t.new_zeros((bl + 1, nb)).index_add_(0, r, upart.sum(2))
            grid.all_reduce(v, "world")
            # w = L @ v (strictly-lower tiles whole; the diagonal tile's
            # unit lower triangle)
            lpart = torch.where(ri > ci, t, torch.where(
                ri == ci, torch.where(tri_l, t, zero) + eye, zero))
            wv = torch.einsum("sij,sj->si", lpart, v[c])
            w = t.new_zeros((bl + 1, nb)).index_add_(0, r, wv)
            grid.all_reduce(w, "world")
        return w.reshape(-1)[: self.blocked.n].cpu().numpy()
