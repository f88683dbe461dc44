"""Factor checkpoint / resume, in the JAX package's ``.npz`` format.

``pangulu_tpu.io.checkpoint.save_factor`` (format_version 2) stores
everything ``gstrs`` needs in one ``.npz``: the factored tiles, the
block pattern and scatter plan, the permutations and scalings and the
original matrix.  :func:`load_factor` reads such a file into a port
:class:`~pangulu_tpu_torch.api.Handle`, so factors made by either
package are solved by the port; :func:`save_factor` writes the same
format.  Both stores cross: dense tiles (``factor_tiles``) and the
compressed store's slot lists (``comp_values``, ``comp_idx``,
``comp_off``, ``comp_cap``, ``comp_capmax``, ``comp_nnz``;
pangulu_tpu/io/checkpoint.py:32-46, 123-153).  A complex handle's
checkpoint holds its real embedding and names the complex type in
``complex_embed`` (pangulu_tpu/io/checkpoint.py:56-57, 119, 149), or,
with native complex tiles (``complex_mode="native"``), complex tiles of
the complex system.  Factors of any nb cross, dense or compressed,
real or native complex.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

_FORMAT_VERSION = 2


def save_factor(handle, path) -> None:
    """Serialize a factorized handle (after :func:`gstrf`) to ``path``
    (.npz)."""
    if handle.factor_tiles is None:
        raise RuntimeError("save_factor requires a factorized handle "
                           "(call gstrf first)")
    dist = getattr(handle, "_dist", None)
    if dist is not None and dist.single is None:
        raise NotImplementedError(
            "save_factor needs the whole factor, and a handle on a grid of "
            f"{dist.p} x {dist.q} ranks holds only its rank's shard")
    b = handle.blocked
    ro = handle.reordering
    rr = ro.reordered
    ao = sp.csc_matrix(handle.a_origin)
    tid, ri, cj, vals = b.scatter_plan
    from pangulu_tpu_torch.compressed import CompressedTiles

    ft = handle.factor_tiles
    if isinstance(ft, CompressedTiles):
        # O(fill): values and slot positions, not dense tiles
        factor_fields = dict(
            factor_storage="compressed",
            comp_values=ft.values.cpu().numpy(),
            comp_idx=ft.idx.cpu().numpy(),
            comp_off=ft.host_off, comp_cap=ft.host_cap,
            comp_capmax=ft.capmax, comp_nnz=ft.nnz_pattern)
    else:
        factor_fields = dict(factor_storage="dense",
                             factor_tiles=ft.cpu().numpy())
    np.savez_compressed(
        path,
        format_version=_FORMAT_VERSION,
        **factor_fields,
        nb=b.nb, n=b.n, block_length=b.block_length, num_tiles=b.num_tiles,
        dtype=str(np.dtype(b.dtype)),
        opts_dtype=handle.opts.dtype,
        opts_backend="auto",
        opts_refine=handle.opts.refine,
        complex_embed=(str(np.dtype(handle.complex_embed))
                       if handle.complex_embed is not None else ""),
        bcolptr=b.bcolptr, browidx=b.browidx,
        brownnzptr=b.brownnzptr, bcolidx=b.bcolidx,
        tile_of_csr=b.tile_of_csr,
        plan_tid=tid, plan_ri=ri, plan_cj=cj, plan_vals=vals,
        row_scale=ro.row_scale, col_scale=ro.col_scale,
        colperm=ro.colperm, perm=ro.perm,
        reordered_colptr=rr.colptr, reordered_rowidx=rr.rowidx,
        reordered_values=rr.values,
        origin_indptr=ao.indptr, origin_indices=ao.indices,
        origin_data=ao.data,
    )


def handle_from_arrays(z, device="cuda"):
    """A solve-ready Handle from the arrays of a saved factor (a dict
    of numpy arrays, or an open ``.npz``), its tiles on ``device``."""
    from pangulu_tpu_torch.api import Handle, InitOptions
    from pangulu_tpu_torch.blocks import BlockedMatrix, _DENSE_LOOKUP_MAX_BL
    from pangulu_tpu_torch.reorder import Reordering
    from pangulu_tpu_torch.schedule import build_schedule
    from pangulu_tpu_torch.sparse import CscMatrix
    from pangulu_tpu_torch.utils.perf import PerfCounters

    ver = int(z["format_version"])
    if ver > _FORMAT_VERSION:
        raise ValueError(f"checkpoint format {ver} is newer than this "
                         f"library supports ({_FORMAT_VERSION})")
    storage = (str(z["factor_storage"]) if "factor_storage" in z
               else "dense")
    if storage not in ("dense", "compressed"):
        raise ValueError(f"unknown factor_storage {storage!r}")
    emb = str(z["complex_embed"]) if "complex_embed" in z else ""
    native = np.dtype(str(z["dtype"])).kind == "c"
    n = int(z["n"])
    nb = int(z["nb"])
    bl = int(z["block_length"])
    num_tiles = int(z["num_tiles"])
    bcolptr, browidx = z["bcolptr"], z["browidx"]
    lookup = None
    if bl <= _DENSE_LOOKUP_MAX_BL:
        lookup = np.full((bl, bl), -1, dtype=np.int64)
        cols = np.repeat(np.arange(bl), np.diff(bcolptr))
        lookup[browidx, cols] = np.arange(num_tiles)
    blocked = BlockedMatrix(
        n=n, nb=nb, block_length=bl, num_tiles=num_tiles,
        bcolptr=bcolptr, browidx=browidx,
        brownnzptr=z["brownnzptr"], bcolidx=z["bcolidx"],
        tile_of_csr=z["tile_of_csr"],
        scatter_plan=(z["plan_tid"], z["plan_ri"], z["plan_cj"],
                      z["plan_vals"]),
        dtype=np.dtype(str(z["dtype"])),
        _lookup=lookup,
    )
    reordering = Reordering(
        row_scale=z["row_scale"], col_scale=z["col_scale"],
        colperm=z["colperm"], perm=z["perm"],
        reordered=CscMatrix(n, z["reordered_colptr"],
                            z["reordered_rowidx"], z["reordered_values"]),
    )
    a_origin = sp.csc_matrix(
        (z["origin_data"], z["origin_indices"], z["origin_indptr"]),
        shape=(n, n))
    opts = InitOptions(nb=nb, dtype=str(z["opts_dtype"]),
                       refine=int(z["opts_refine"]), device=str(device),
                       tile_storage=storage,
                       complex_mode="native" if native else "auto")
    dev = opts.resolve_device()
    schedule = build_schedule(blocked)
    perf = PerfCounters()
    factorizer = None
    if storage == "compressed":
        from pangulu_tpu_torch.compressed import CompressedLU, CompressedTiles

        factor_tiles = CompressedTiles.from_arrays(
            blocked, z["comp_values"], z["comp_idx"], z["comp_off"],
            z["comp_cap"], int(z["comp_capmax"]), int(z["comp_nnz"]), dev)
        # solve-ready: the inverses come from the factored diagonal
        # tiles at the first solve
        factorizer = CompressedLU.from_store(blocked, schedule,
                                             factor_tiles, perf=perf)
    else:
        factor_tiles = torch.as_tensor(np.asarray(z["factor_tiles"]),
                                       device=dev)
    return Handle(
        opts=opts, a_origin=a_origin, reordering=reordering,
        symbolic_result=None, blocked=blocked, schedule=schedule, perf=perf,
        device=dev, factor_tiles=factor_tiles, _factorizer=factorizer,
        complex_embed=np.dtype(emb) if emb else None,
    )


def load_factor(path, device="cuda"):
    """Reload a saved factor into a solve-ready Handle on ``device``
    (``gstrs`` works at once; the triangle inverses are recomputed from
    the packed factors on first solve)."""
    with np.load(path, allow_pickle=False) as z:
        return handle_from_arrays({k: z[k] for k in z.files}, device)
