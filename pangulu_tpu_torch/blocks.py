"""Block tiling: scalar CSC -> dense nb x nb tiles.

Counterpart of the reference's distribution/storage pipeline
(``pangulu_cm_distribute_csc_to_distbcsc``,
pangulu_communication.c:227-761, and the slot/bin block store,
``pangulu_storage.c``), redesigned around dense tiles:

  * every block present in the symbolic pattern is ONE dense nb x nb
    tile in a single ``[num_tiles + 1, nb, nb]`` device array (the last
    tile is a scratch slot that absorbs padded scatter/gather traffic —
    the static-shape replacement for the reference's recyclable recv
    bins);
  * tile ids are the CSC order of the block pattern, so a column's
    L-panel and a row's U-panel are contiguous id ranges where possible;
  * there is no host<->device block traffic during factorization: tiles
    live in HBM for the whole solve (the reference's GPU mirror +
    download-after-kernel dance, pangulu_storage.c:295-422 /
    0201000.cu:639-714, has no TPU analogue by design).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from pangulu_tpu_torch.sparse import CscMatrix
from pangulu_tpu_torch.symbolic import SymbolicResult

# Above this block_length a dense (bl, bl) lookup table would dominate
# memory; fall back to per-column binary search.
_DENSE_LOOKUP_MAX_BL = 6000


@dataclasses.dataclass
class BlockedMatrix:
    n: int
    nb: int
    block_length: int
    num_tiles: int
    # Block pattern in BCSC (block compressed sparse column):
    bcolptr: np.ndarray   # (bl+1,)
    browidx: np.ndarray   # (num_tiles,)
    # and BCSR for row-wise traversal:
    brownnzptr: np.ndarray  # (bl+1,)
    bcolidx: np.ndarray     # (num_tiles,) column index per row-ordered block
    tile_of_csr: np.ndarray  # (num_tiles,) tile id per BCSR position
    # Scatter plan (tid, ri, cj, values): the dense tile store is built
    # lazily from this — on device directly (O(nnz) transfer) or on
    # host for tests/export.
    scatter_plan: tuple = None
    dtype: object = None
    _lookup: np.ndarray | None = None  # dense (bl, bl) -> tile id or -1
    _host_tiles: np.ndarray | None = None
    # lazy sorted (col*bl + row) pattern keys for the vectorized
    # tile_ids fallback above _DENSE_LOOKUP_MAX_BL
    _pat_keys: np.ndarray | None = None

    @property
    def tiles(self) -> np.ndarray:
        """Host-side dense tile store [num_tiles+1, nb, nb] (lazy)."""
        if self._host_tiles is None:
            tid, ri, cj, vals = self.scatter_plan
            t = np.zeros((self.num_tiles + 1, self.nb, self.nb),
                         dtype=self.dtype)
            np.add.at(t, (tid, ri, cj), vals)
            self._host_tiles = t
        return self._host_tiles

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.from_numpy(np.empty(0, self.dtype)).dtype

    def device_tiles(self, device) -> torch.Tensor:
        """Build the tile store ON ``device`` from the O(nnz) scatter
        plan (only O(nnz) bytes cross to the device, not the dense
        store)."""
        tid, ri, cj, vals = self.scatter_plan
        t = torch.zeros((self.num_tiles + 1, self.nb, self.nb),
                        dtype=self.torch_dtype, device=device)
        idx = tuple(torch.as_tensor(np.asarray(v, dtype=np.int64),
                                    device=device) for v in (tid, ri, cj))
        return t.index_put_(idx, torch.as_tensor(vals, device=device),
                            accumulate=True)

    def tile_id(self, bi, bj):
        """Tile id of block (bi, bj), or -1 if not in the pattern."""
        if self._lookup is not None:
            return int(self._lookup[bi, bj])
        lo, hi = self.bcolptr[bj], self.bcolptr[bj + 1]
        pos = np.searchsorted(self.browidx[lo:hi], bi)
        if pos < hi - lo and self.browidx[lo + pos] == bi:
            return int(lo + pos)
        return -1

    def tile_ids(self, bi_arr, bj_arr):
        """Vectorized tile_id over arrays: dense-lookup gather when the
        [bl, bl] table exists, else a batched searchsorted against the
        column-major pattern keys (the per-element Python fallback was
        catastrophic at scale: the >16 GB out-of-core demo called this
        over ~9e8 fill entries — hours of interpreter loop and tens of
        GB of boxed ints)."""
        if self._lookup is not None:
            return self._lookup[bi_arr, bj_arr].astype(np.int64)
        if self._pat_keys is None:
            cols = np.repeat(np.arange(self.block_length),
                             np.diff(self.bcolptr))
            # CSC order with sorted row indices per column == sorted
            # by (col, row): the keys are already ascending
            self._pat_keys = cols * self.block_length + self.browidx
        q = (np.asarray(bj_arr, dtype=np.int64) * self.block_length
             + np.asarray(bi_arr, dtype=np.int64))
        r = np.searchsorted(self._pat_keys, q)
        r_c = np.minimum(r, len(self._pat_keys) - 1)
        return np.where(self._pat_keys[r_c] == q, r_c, -1)


def tile_matrix(a: CscMatrix, symb: SymbolicResult) -> BlockedMatrix:
    """Scatter A's values into dense tiles over the symbolic block
    pattern (reference: pangulu_convert_block_fill_value_to_struct,
    pangulu_conversion.c:241-350)."""
    n, nb, bl = symb.n, symb.nb, symb.block_length
    pat = symb.block_full.tocsc()
    pat.sort_indices()
    bcolptr = pat.indptr.astype(np.int64)
    browidx = pat.indices.astype(np.int64)
    num_tiles = len(browidx)

    lookup = None
    if bl <= _DENSE_LOOKUP_MAX_BL:
        # int32 halves the gather bytes of the hottest preprocess pass
        # (bl and num_tiles are far below 2^31)
        lookup = np.full((bl, bl), -1, dtype=np.int32)
        cols = np.repeat(np.arange(bl), np.diff(bcolptr))
        lookup[browidx, cols] = np.arange(num_tiles)

    # BCSR view with tile-id map (reference keeps CSR mirrors with
    # value-index maps, pangulu_utils.c:479-544).
    csr = pat.tocsr()
    csr.sort_indices()
    cols = np.repeat(np.arange(bl), np.diff(bcolptr))
    # row-major permutation of the csc entries = tile id per BCSR slot
    tile_of_csr = np.lexsort((cols, browidx))

    # Scatter plan for all nnz (host-side indices only — the dense tile
    # store itself is built ON DEVICE from these, so only O(nnz) bytes
    # cross the host->device link, not O(num_tiles * nb^2); the
    # reference ships packed sparse payloads over MPI for the same
    # reason, pangulu_communication.c:404-661).
    coo = a.to_scipy().tocoo()
    bi = coo.row // nb
    bj = coo.col // nb
    ri = (coo.row % nb).astype(np.int32)
    cj = (coo.col % nb).astype(np.int32)
    if lookup is not None:
        tid = lookup[bi, bj]
    else:
        # Batched searchsorted against the sorted (col*bl + row) keys —
        # same scheme as BlockedMatrix.tile_ids.  The previous
        # per-element Python loop here ran on EVERY tile_matrix at
        # ooc-demo scale (bl=6912, ~6M nnz) and could silently
        # mis-scatter out-of-pattern entries (searchsorted position
        # without the equality check never yields -1).
        keys = cols.astype(np.int64) * bl + browidx
        q = bj.astype(np.int64) * bl + bi.astype(np.int64)
        r = np.searchsorted(keys, q)
        r_c = np.minimum(r, len(keys) - 1)
        tid = np.where(keys[r_c] == q, r_c, -1)
    if np.any(tid < 0):
        raise AssertionError("A entry outside symbolic pattern")
    tid = tid.astype(np.int32)
    vals = np.asarray(coo.data)

    # Last diagonal block may pad past n: put ones on the padded
    # diagonal so its GETRF is exact (padding never contaminates the
    # valid region — its L column and U row stay zero).  Appended to
    # the scatter plan so both host and device builds agree.
    rem = n % nb
    if rem:
        last_diag = lookup[bl - 1, bl - 1] if lookup is not None else None
        if last_diag is None:
            lo, hi = bcolptr[bl - 1], bcolptr[bl]
            pos = np.searchsorted(browidx[lo:hi], bl - 1)
            last_diag = lo + pos
        pad = np.arange(rem, nb, dtype=np.int32)
        tid = np.concatenate([tid, np.full(len(pad), last_diag,
                                           dtype=np.int32)])
        ri = np.concatenate([ri, pad])
        cj = np.concatenate([cj, pad])
        vals = np.concatenate([vals, np.ones(len(pad), dtype=vals.dtype)])

    return BlockedMatrix(
        n=n, nb=nb, block_length=bl, num_tiles=num_tiles,
        bcolptr=bcolptr, browidx=browidx,
        brownnzptr=csr.indptr.astype(np.int64),
        bcolidx=csr.indices.astype(np.int64),
        tile_of_csr=tile_of_csr,
        scatter_plan=(tid, ri, cj, vals),
        dtype=a.values.dtype,
        _lookup=lookup,
    )


def refill_values(blocked: BlockedMatrix, a: CscMatrix) -> None:
    """Replace the numeric values of a tiled matrix IN PLACE with those
    of a same-pattern matrix ``a`` (already reordered).  This is the
    refactorization fast path: symbolic pattern, schedule and index
    maps are all reused; only the O(nnz) value vector changes.

    The reference has no equivalent — it requires finalize+init for a
    new matrix (README.md:125); factor-many with one symbolic analysis
    is the standard direct-solver feature this adds.
    """
    tid, ri, cj, vals = blocked.scatter_plan
    coo = a.to_scipy().tocoo()
    new_vals = np.asarray(coo.data)
    n_pad = len(vals) - len(new_vals)
    if n_pad < 0:
        raise ValueError("matrix pattern differs from the tiled pattern")
    if n_pad:
        new_vals = np.concatenate(
            [new_vals, np.ones(n_pad, dtype=new_vals.dtype)])
    blocked.scatter_plan = (tid, ri, cj, new_vals.astype(blocked.dtype))
    blocked._host_tiles = None


def gather_factor(blocked: BlockedMatrix, tiles_np: np.ndarray,
                  batch: int = 2048):
    """Reassemble (L, U) scipy matrices from factored tiles (testing /
    export / residual checks).  L has unit diagonal; U includes the
    diagonal.  Vectorized in tile batches — the per-tile Python loop
    took minutes at 10^5 tiles."""
    n, nb, bl = blocked.n, blocked.nb, blocked.block_length
    nt = blocked.num_tiles
    tile_bi = blocked.browidx
    tile_bj = np.repeat(np.arange(bl), np.diff(blocked.bcolptr))
    rows_l, cols_l, vals_l = [], [], []
    rows_u, cols_u, vals_u = [], [], []
    for s in range(0, nt, batch):
        e = min(s + batch, nt)
        t = tiles_np[s:e]
        tb, rr, cc = np.nonzero(t)
        tid = tb + s
        gr = tile_bi[tid] * nb + rr
        gc = tile_bj[tid] * nb + cc
        keep = (gr < n) & (gc < n)
        gr, gc = gr[keep], gc[keep]
        v = t[tb[keep], rr[keep], cc[keep]]
        # elementwise gr > gc splits exactly like the tilewise rule:
        # any element of an off-diagonal L tile has gr > gc and v.v.
        low = gr > gc
        rows_l.append(gr[low]); cols_l.append(gc[low]); vals_l.append(v[low])
        rows_u.append(gr[~low]); cols_u.append(gc[~low])
        vals_u.append(v[~low])
    dtype = tiles_np.dtype

    def _build(rows, cols, vals, add_unit_diag):
        r = np.concatenate(rows) if rows else np.empty(0, np.int64)
        c = np.concatenate(cols) if cols else np.empty(0, np.int64)
        v = np.concatenate(vals) if vals else np.empty(0, dtype)
        m = sp.csc_matrix((v, (r, c)), shape=(n, n))
        if add_unit_diag:
            m = m + sp.identity(n, dtype=dtype, format="csc")
        return m

    lmat = _build(rows_l, cols_l, vals_l, True)
    umat = _build(rows_u, cols_u, vals_u, False)
    return lmat, umat
