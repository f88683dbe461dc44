"""Compressed (sparse-in-tile) factor storage: ``tile_storage="compressed"``.

Counterpart of ``pangulu_tpu.compressed`` and of the reference's
nnz-capacity block storage (pangulu_storage.c:83-293, u16 in-block
indices pangulu_common.h:54-65): device memory is O(fill-nnz), not
O(tiles * nb^2).  Each tile stores only its exact scalar fill pattern
(from the scalar symbolic analysis) as a list of in-tile positions
(uint16 up to nb = 255, uint32 above, to nb = 65535 as in the JAX
package) beside a list of values, real or complex.

The products want dense operands, so :class:`CompressedLU` stages each
elimination level's working set dense (the diagonal tile, the panels,
the update destinations) with :func:`~ops.kernels_cuda.decompress_tiles`,
runs the level's math on them (the diagonal step from its
:class:`~ops.interface.KernelBackend`: K1 for real tiles on the card, at
every nb, and ``kernels_xla`` for complex tiles and on the CPU;
``torch.matmul`` in true f32 for the panels and the Schur updates, as
the JAX package left them to XLA) and writes them back with
:func:`~ops.kernels_cuda.compress_tiles`.  Dropping the positions outside
the symbolic pattern loses nothing: such a position has a structurally
zero factor in every product that could touch it, so its value is
exactly 0.0 (the superset-pattern invariant of the symbolic analysis).

Each level runs at its own widths, not the schedule-wide padded ones of
``Schedule.fused_tables`` (padding would triple the Schur work on
poisson3d(32) nd); the answer is the same, as a padded entry is the
zero scratch tile.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from pangulu_tpu_torch.blocks import BlockedMatrix
from pangulu_tpu_torch.numeric import resolve_backend
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.ops.kernels_torch import DEFAULT_TOL, Indices
from pangulu_tpu_torch.schedule import Schedule, bucket, build_schedule
from pangulu_tpu_torch.sparse import CscMatrix, symmetrize_pattern
from pangulu_tpu_torch.symbolic import elimination_tree
from pangulu_tpu_torch.utils.perf import (PerfCounters, device_sync,
                                          resolve_device)


def _scalar_fill_entries(a3: CscMatrix):
    """All strictly-lower scalar fill entries (i, j) of L for the
    symmetrized pattern of ``a3`` (native fast path; Python fallback)."""
    sym = symmetrize_pattern(a3)
    parent = elimination_tree(sym)
    csr = sym.tocsr()
    from pangulu_tpu_torch import native

    # count pass: one n-sized block so the 1x1 block_mark is in range
    count = native.fill_walk(a3.n, csr.indptr, csr.indices, parent,
                             a3.n, 1)
    if count is not None:
        got = native.fill_entries(a3.n, csr.indptr, csr.indices, parent,
                                  count[0])
        if got is not None:
            return got
    # Python fallback (row-subtree walk)
    n = a3.n
    indptr, indices = csr.indptr, csr.indices
    visited = np.full(n, -1, dtype=np.int64)
    oi, oj = [], []
    for i in range(n):
        visited[i] = i
        for k in indices[indptr[i]:indptr[i + 1]]:
            if k >= i:
                continue
            j = k
            while visited[j] != i:
                visited[j] = i
                oi.append(i)
                oj.append(j)
                j = parent[j]
                if j == -1 or j >= i:
                    break
    return (np.asarray(oi, dtype=np.int32),
            np.asarray(oj, dtype=np.int32))


class CompressedTiles:
    """Compressed tile store on ``device``: ``values[s]`` holds the value
    of in-tile position ``idx[s]`` (row-major r*nb+c) of the tile owning
    slot range [off[t], off[t]+cap[t]).  ``off`` and ``cap`` ([nt+1],
    int32, on the host and the device) give the scratch tile nt zero
    capacity at the scratch slot; ``values`` and ``idx`` carry ``capmax``
    slots past the last tile's (sentinel positions nb*nb), as the JAX
    store does."""

    def __init__(self, blocked: BlockedMatrix, a3: CscMatrix, device="cuda"):
        nb, nt = blocked.nb, blocked.num_tiles
        bl = blocked.block_length
        nn = nb * nb
        # in-tile positions (sentinel nb*nb): uint16 up to nb = 255,
        # uint32 above, to nb = 65535 (pangulu_tpu/compressed.py:94-100)
        kt.check_store_nb(nb)
        idx_dtype = np.uint16 if nn <= np.iinfo(np.uint16).max \
            else np.uint32
        li, lj = _scalar_fill_entries(a3)
        n = a3.n
        nf = len(li)
        total = 2 * nf + bl * nb
        # every entry's sort key tid*nn + pos, in three segments (L, U,
        # the diagonal with the padded tail), sorted in place: slot space
        # is then dense in sorted order, the slot of sorted position p is
        # p (pangulu_tpu/compressed.py:108-121)
        key = np.empty(total, dtype=np.int64)
        count = np.zeros(nt, dtype=np.int64)

        def seg_key(out, i, j):
            tid = blocked.tile_ids(i // nb, j // nb)
            assert len(tid) == 0 or tid.min() >= 0, \
                "scalar fill outside the block pattern"
            count[:] += np.bincount(tid, minlength=nt)
            np.multiply(tid, nn, out=out, casting="unsafe")
            out += (i % nb).astype(np.int64) * nb
            out += j % nb

        seg_key(key[:nf], li, lj)
        seg_key(key[nf:2 * nf], lj, li)
        diag = np.arange(bl * nb, dtype=np.int64)  # incl. padded tail
        seg_key(key[2 * nf:], diag, diag)
        key.sort()
        # capacities are exact counts; only the gather width (capmax) is
        # a power of two, as in the JAX store
        cap = count.copy()
        off = np.zeros(nt + 1, dtype=np.int64)
        off[1:] = np.cumsum(cap)
        s_total = int(off[-1])
        assert s_total == total
        capmax = int(max(bucket(int(count.max(initial=1))), 1))
        idx = np.full(s_total + capmax, nn, dtype=idx_dtype)
        np.mod(key, nn, out=idx[:s_total], casting="unsafe")
        values = np.zeros(s_total + capmax, dtype=blocked.dtype)
        # A's entries into their slots (the slot of a key is its sorted
        # position)
        acols = np.repeat(np.arange(n), np.diff(a3.colptr))
        arows = a3.rowidx
        akey = (blocked.tile_ids(arows // nb, acols // nb) * nn
                + (arows % nb) * nb + (acols % nb))
        r = np.searchsorted(key, akey)
        assert (key[r] == akey).all(), "A entry outside fill pattern"
        np.add.at(values, r, a3.values)
        # padded diagonal tail = 1.0 (identity; matches blocks.py)
        tail = np.arange(n, bl * nb, dtype=np.int64)
        tail_slots = np.empty(0, dtype=np.int64)
        if len(tail):
            tkey = (blocked.tile_ids(tail // nb, tail // nb) * nn
                    + (tail % nb) * nb + (tail % nb))
            tail_slots = np.searchsorted(key, tkey)
            values[tail_slots] = 1.0
        # kept for the O(nnz) refactorization path (refill)
        self._a_slots = r
        self._tail_slots = tail_slots
        self._setup(blocked, values, idx, off, cap, capmax, len(key), device)

    def _setup(self, blocked, values, idx, off, cap, capmax, nnz_pattern,
               device) -> None:
        """Ship the host arrays to ``device`` (``off`` [nt+1] ending at
        the scratch slot, ``cap`` [nt])."""
        self.blocked = blocked
        self.device = resolve_device(device)
        self.nb, self.num_tiles = blocked.nb, blocked.num_tiles
        self.nnz_pattern = int(nnz_pattern)
        self.capmax = int(capmax)
        self.host_off = np.asarray(off, dtype=np.int64)
        self.host_cap = np.asarray(cap, dtype=np.int64)
        self.scratch_slot = int(self.host_off[-1])
        # the device indexes slots with int32 (as the JAX store's off)
        if self.scratch_slot + self.capmax >= 2 ** 31:
            raise ValueError(
                f"the compressed store holds {self.scratch_slot} slots; "
                "int32 slot offsets take fewer than 2^31 - capmax")
        if len(values) != self.scratch_slot + self.capmax \
                or len(idx) != len(values):
            raise ValueError("values and idx must hold the tiles' slots "
                             "and capmax more")
        # scratch tile id nt: zero capacity at the scratch slot
        self.off = Indices.build(self.host_off, self.device)
        self.cap = Indices.build(np.append(self.host_cap, 0), self.device)
        self.idx = torch.as_tensor(np.ascontiguousarray(idx),
                                   device=self.device)
        self.values = torch.as_tensor(np.ascontiguousarray(values),
                                      device=self.device)

    @classmethod
    def from_arrays(cls, blocked: BlockedMatrix, values, idx, off, cap,
                    capmax: int, nnz_pattern: int,
                    device="cuda") -> "CompressedTiles":
        """A store from saved arrays (``io.checkpoint``); it has no
        :meth:`refill` (a refactorization builds a new store)."""
        self = cls.__new__(cls)
        self._a_slots = self._tail_slots = None
        self._setup(blocked, np.asarray(values), np.asarray(idx), off, cap,
                    capmax, nnz_pattern, device)
        return self

    def refill(self, a3: CscMatrix) -> None:
        """Refactorization fast path: replace the store's values from a
        matrix of the same pattern, O(nnz), no fill walk."""
        if self._a_slots is None:
            raise ValueError("a store loaded from a checkpoint cannot be "
                             "refilled; build a new one")
        values = np.zeros(self.scratch_slot + self.capmax,
                          dtype=self.blocked.dtype)
        np.add.at(values, self._a_slots, a3.values)
        values[self._tail_slots] = 1.0
        self.values = torch.as_tensor(values, device=self.device)

    # -- memory accounting -------------------------------------------------
    @property
    def compressed_bytes(self) -> int:
        return int(self.values.numel() * (self.values.element_size()
                                          + self.idx.element_size()))

    @property
    def dense_bytes(self) -> int:
        return int((self.num_tiles + 1) * self.nb * self.nb
                   * self.values.element_size())

    def to_dense(self) -> np.ndarray:
        """The dense tile store [nt+1, nb, nb] on the host (residual
        checks, diagnostics): one vectorized scatter over all slots."""
        nb, nn = self.nb, self.nb * self.nb
        vals = self.values.cpu().numpy()
        idx = self.idx.cpu().numpy()
        out = np.zeros((self.num_tiles + 1, nn), dtype=self.blocked.dtype)
        tid = np.repeat(np.arange(self.num_tiles, dtype=np.int64),
                        self.host_cap)
        s = np.arange(tid.size)
        keep = idx[s] < nn
        out[tid[keep], idx[s[keep]].astype(np.int64)] = vals[s[keep]]
        return out.reshape(self.num_tiles + 1, nb, nb)


@contextlib.contextmanager
def true_f32():
    """The panel and Schur products in full f32: TF32 off for the
    duration (it keeps 10 mantissa bits, ROADMAP "f32 precision")."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _rows(tab: np.ndarray, counts: np.ndarray, device, as_indices=True):
    """Each level's first counts[k] entries of the padded table ``tab``,
    shipped to ``device`` in one copy: Indices (for the slot kernels) or
    int64 tensors (for PyTorch indexing)."""
    off = np.concatenate([[0], np.cumsum(counts)])
    flat = np.concatenate([tab[k, :c] for k, c in enumerate(counts)]
                          + [np.zeros(0, tab.dtype)])
    if as_indices:
        whole = Indices.build(flat, device)
        return [Indices(host=whole.host[s:e], dev=whole.dev[s:e])
                for s, e in zip(off[:-1], off[1:])]
    whole = torch.as_tensor(flat.astype(np.int64), device=device)
    return [whole[s:e] for s, e in zip(off[:-1], off[1:])]


class CompressedLU:
    """gstrf/gstrs executor over a :class:`CompressedTiles` store on
    ``device`` (``"cuda"``, the default: the hand kernels; ``"cpu"``: their
    plain versions).  ``backend`` ("auto", "cuda", "torch" or a
    :class:`~ops.interface.KernelBackend`) gives the diagonal step, as
    the JAX package's engine takes ``backend.diag_factor_invert``
    (pangulu_tpu/compressed.py:264): "auto" is K1 for real tiles on a
    CUDA device and ``kernels_xla`` for complex tiles and on the CPU."""

    def __init__(self, blocked: BlockedMatrix, schedule: Schedule | None,
                 a3: CscMatrix, perf: PerfCounters | None = None,
                 device="cuda", tol: float | None = None, store=None,
                 backend="auto"):
        self._bind(blocked, schedule, perf, device, tol, backend)
        with self.perf.phase("preprocess"):
            if store is not None:      # refactorize: same pattern,
                store.refill(a3)       # new values, O(nnz)
                self.store = store
            else:
                self.store = CompressedTiles(blocked, a3, self.device)

    def _bind(self, blocked, schedule, perf, device, tol, backend) -> None:
        self.blocked = blocked
        self.schedule = schedule or build_schedule(blocked)
        self.perf = perf or PerfCounters()
        self.device = resolve_device(device)
        self.tol = (tol if tol is not None
                    else DEFAULT_TOL[blocked.torch_dtype])
        self.backend = resolve_backend(backend, blocked.nb,
                                       blocked.torch_dtype, tol, self.device)
        self._levels = None
        self._solve_levels = None
        self.inv_tiles = None   # [bl, 2, nb, nb] by level

    @classmethod
    def from_store(cls, blocked, schedule, store: CompressedTiles,
                   perf=None, tol=None, backend="auto") -> "CompressedLU":
        """A solve-ready executor over a saved, factored store
        (checkpoint load): the inverses are recomputed from its factored
        diagonal tiles at the first solve (:meth:`_ensure_inverses`)."""
        self = cls.__new__(cls)
        self._bind(blocked, schedule, perf, store.device, tol, backend)
        self.store = store
        return self

    def _level_tables(self):
        """Per level: the diagonal tile, the L and U panels and the
        update destinations (Indices), and each update's L and U panel
        positions (int64), from ``Schedule.fused_tables`` cut to the
        level's real widths."""
        if self._levels is None:
            nt = self.blocked.num_tiles
            diag, l_ids, u_ids, dst, upd_l, upd_u = \
                self.schedule.fused_tables(nt)
            nl, nu, nup = ((t != nt).sum(axis=1) for t in (l_ids, u_ids, dst))
            dev = self.device
            self._levels = list(zip(
                _rows(diag[:, None], np.ones(len(diag), np.int64), dev),
                _rows(l_ids, nl, dev), _rows(u_ids, nu, dev),
                _rows(dst, nup, dev),
                _rows(upd_l, nup, dev, as_indices=False),
                _rows(upd_u, nup, dev, as_indices=False)))
        return self._levels

    def _solve_tables(self):
        """Per sweep and level: the panel tiles (Indices) and their block
        rows (int64), from ``Schedule.fused_solve_tables`` cut to the
        level's real widths."""
        if self._solve_levels is None:
            nt, bl = self.blocked.num_tiles, self.schedule.block_length
            _, l_ids, l_rows, uc_ids, uc_rows = \
                self.schedule.fused_solve_tables(nt, bl)
            dev = self.device
            self._solve_levels = {}
            for sweep, ids, rows in (("l", l_ids, l_rows),
                                     ("uc", uc_ids, uc_rows)):
                n = (ids != nt).sum(axis=1)
                self._solve_levels[sweep] = list(zip(
                    _rows(ids, n, dev), _rows(rows, n, dev,
                                              as_indices=False)))
        return self._solve_levels

    def _gather(self, ids: Indices) -> torch.Tensor:
        st = self.store
        return kernels_cuda.decompress_tiles(st.values, st.idx, st.off,
                                             st.cap, ids, st.nb)

    def _scatter(self, ids: Indices, dense: torch.Tensor) -> None:
        st = self.store
        kernels_cuda.compress_tiles(st.values, st.idx, st.off, st.cap, ids,
                                    dense)

    def factorize(self) -> CompressedTiles:
        """Factor the store IN PLACE, level by level (pangulu_tpu/
        compressed.py:227-283): the diagonal tile through the backend's
        diagonal step (K1 on the card for real tiles), then the L panel
        times U^-1, L^-1 times the U panel and the Schur updates, each
        staged dense and written back.  Persists the inverses."""
        st = self.store
        bl, nb = self.schedule.block_length, st.nb
        levels = self._level_tables()
        invs = torch.empty((bl, 2, nb, nb), dtype=st.values.dtype,
                           device=self.device)
        with self.perf.phase("numeric"), true_f32():
            for k, (dg, lids, uids, dst, ul, uu) in enumerate(levels):
                f, linv, uinv = self.backend.diag_factor_invert(
                    self._gather(dg), self.tol)
                self._scatter(dg, f)
                invs[k, 0], invs[k, 1] = linv[0], uinv[0]
                lblk = ublk = None
                if len(lids):
                    lblk = torch.matmul(self._gather(lids), uinv[0])
                    self._scatter(lids, lblk)
                if len(uids):
                    ublk = torch.matmul(linv[0], self._gather(uids))
                    self._scatter(uids, ublk)
                if len(dst):
                    upd = self._gather(dst) - torch.matmul(lblk[ul],
                                                           ublk[uu])
                    self._scatter(dst, upd)
            device_sync(self.device)
        self.inv_tiles = invs
        self.perf.add_flops(self.schedule.flop_estimate())
        self.perf.kernel_counts(
            getrf=self.schedule.block_length,
            tstrf=self.schedule.n_tstrf,
            gessm=self.schedule.n_gessm,
            ssssm=self.schedule.n_ssssm,
        )
        self.perf.kernels["engine"] = "compressed"
        self.perf.kernels["backend"] = self.backend.name
        return st

    def _ensure_inverses(self) -> torch.Tensor:
        """The triangle inverses of every factored diagonal tile, from
        the store (a checkpoint-loaded executor; the factorization
        persists its own): the diagonal tiles staged dense in one batch,
        then both inverses.  Real tiles take one call of P2
        (``kernels_cuda.newton_inverses``, at every nb), the counterpart
        of the JAX package's Newton–Schulz doubling
        (pangulu_tpu/compressed.py:367-401), which computes the same
        function by Gauss–Jordan sweeps in float64
        (``kernels_torch.triangle_inverses``, also on the CPU), with no
        workspace.  Complex tiles take that doubling itself
        (``kernels_torch.unit_lower_inv_newton`` and
        ``upper_inv_newton`` over the batch), which the JAX package
        computes in XLA behind no Pallas kernel."""
        if self.inv_tiles is None:
            diag = Indices.build([lev.diag for lev in self.schedule.levels],
                                 self.device)
            with true_f32():
                d = self._gather(diag)
                if d.is_complex():
                    linv = kt.unit_lower_inv_newton(d)
                    uinv = kt.upper_inv_newton(d, self.tol)
                else:
                    linv, uinv = kernels_cuda.newton_inverses(d, self.tol)
            self.inv_tiles = torch.stack([linv, uinv], dim=1)
        return self.inv_tiles

    def solve_blocked(self, xb: torch.Tensor) -> torch.Tensor:
        """Forward then backward block solve of a blocked rhs
        ``[bl+1, nb, nrhs]`` on the device; returns a new tensor
        (pangulu_tpu/compressed.py:285-320): the diagonal step is a
        product with the persisted inverse, each panel is staged dense
        and its update subtracted from its block rows."""
        invs = self._ensure_inverses()
        tabs = self._solve_tables()
        bl = self.schedule.block_length
        x = xb.clone()
        with true_f32():
            for sweep, slot, order in (("l", 0, range(bl)),
                                       ("uc", 1, reversed(range(bl)))):
                for k in order:
                    ids, rows = tabs[sweep][k]
                    xk = torch.matmul(invs[k, slot], x[k])
                    x[k] = xk
                    if len(ids):
                        x.index_add_(0, rows,
                                     torch.matmul(self._gather(ids), xk),
                                     alpha=-1)
        return x

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve LU x = b for b [n] or [n, nrhs] on the host."""
        bl, nb = self.schedule.block_length, self.schedule.nb
        b2 = np.asarray(b)
        squeeze = b2.ndim == 1
        if squeeze:
            b2 = b2[:, None]
        nrhs = b2.shape[1]
        xb = np.zeros((bl + 1, nb, nrhs), dtype=self.blocked.dtype)
        xb[:bl].reshape(bl * nb, nrhs)[: b2.shape[0]] = b2
        with self.perf.phase("sptrsv"):
            x = self.solve_blocked(torch.as_tensor(xb, device=self.device))
            device_sync(self.device)
        out = x[:bl].reshape(bl * nb, nrhs)[: self.blocked.n].cpu().numpy()
        return out[:, 0] if squeeze else out
