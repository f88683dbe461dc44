"""Public API: init / gstrf / gstrs / gssv / finalize, and the rest of
the JAX package's single-device surface (analyze, update_values,
gstrs_device, factor_diagnostics, the transpose solve).

Mirrors the reference's five exported entry points and options struct
(include/pangulu.h:11-15, include/pangulu_interface_common.h:3-20,
src/pangulu.c:11-345), with a :class:`Solver` wrapper on top, as
``pangulu_tpu.api`` does:

    opts   = InitOptions(nb=128, dtype="r32", device="cuda")
    handle = init(A, opts)                     # reorder+symbolic+tile
    gstrf(handle)                              # numeric factorization
    x = gstrs(handle, b)                       # triangular solves
    finalize(handle)

Or simply ``x = Solver(A, device="cuda").solve(b)``.

The device is explicit: ``device="cuda"`` (the default) runs the
hand-written CUDA kernels and raises when there is no GPU;
``device="cpu"`` runs their plain PyTorch versions and must be asked
for.  ``tile_storage="compressed"`` keeps the factors in O(fill) slot
lists (:mod:`pangulu_tpu_torch.compressed`).  ``profile_dir`` writes a
``torch.profiler`` trace of each gstrf's numeric phase there.

``mesh_shape=(p, q)`` (or ``"auto"``) runs gstrf and gstrs over a p x q
grid of ranks of a ``torch.distributed`` job, one process a rank, every
rank making the same calls (:mod:`pangulu_tpu_torch.parallel`, which
says how to start one): the factors stay sharded block-cyclically, and
a handle of p·q > 1 holds its rank's shard only.

The complex types (``dtype="cr32"|"cr64"``) are solved through their
real 2x2 embedding (:func:`pangulu_tpu_torch.sparse.complex_embed_matrix`)
on the real engines, float32 for cr32 and float64 for cr64, on every
device: ``init`` embeds the matrix, ``gstrs`` embeds the right-hand side
and folds the solution back.  ``complex_mode="native"`` keeps complex
tiles instead: on the fused engine with the ``"torch"`` backend, on the
compressed store (P6 moves complex slots) and on a grid of ranks.

Tiles of nb > 256 run on the fused engine on dense tiles, on the
compressed store and on a grid of ranks, each with K1 for wide tiles as
its diagonal step on the card (``backend``: "auto", "cuda" or "torch",
:mod:`pangulu_tpu_torch.ops.interface`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from pangulu_tpu_torch.blocks import (BlockedMatrix, gather_factor,
                                      refill_values, tile_matrix)
from pangulu_tpu_torch.compressed import CompressedLU, CompressedTiles
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.ops.interface import BACKENDS
from pangulu_tpu_torch.outofcore import PanelLU
from pangulu_tpu_torch.parallel.dist_numeric import DistributedLU
from pangulu_tpu_torch.parallel.dist_sptrsv import DistributedTriangularSolver
from pangulu_tpu_torch.parallel.mesh import make_grid
from pangulu_tpu_torch.reorder import Reordering, reorder
from pangulu_tpu_torch.schedule import Schedule, build_schedule
from pangulu_tpu_torch.sparse import (VALUE_DTYPES, CscMatrix,
                                      add_diagonal_elements,
                                      complex_embed_matrix,
                                      complex_embed_rhs, complex_unembed_x)
from pangulu_tpu_torch.sptrsv import TriangularSolver
from pangulu_tpu_torch.symbolic import SymbolicResult, symbolic
from pangulu_tpu_torch.utils.log import config_banner, get_logger
from pangulu_tpu_torch.utils.perf import (PerfCounters,
                                          factorization_residual,
                                          profile_trace, resolve_device)

log = get_logger()


@dataclasses.dataclass
class InitOptions:
    """Runtime options (reference: pangulu_init_options,
    include/pangulu_interface_common.h:3-12, plus the compile-time
    PANGULU_FLAGS promoted to runtime options)."""

    nb: int = 128                # block size (above 256 the dense tiles
                                 # take the fused engine)
    dtype: str = "r64"           # r32 | r64 | cr32 | cr64
    mc64: bool = True            # -DPANGULU_MC64
    ordering: str = "auto"       # METIS analogue: mindeg|rcm|nd|natural|auto
    symbolic_mode: str = "auto"  # scalar | block | auto
    backend: str = "auto"        # kernel backend of the fused/levels
                                 # engines: cuda | torch | auto
    tol: Optional[float] = None  # tiny-pivot substitution threshold
    check: bool = False          # -DPANGULU_PERF residual check
    refine: int = -1             # iterative-refinement rounds in gstrs;
                                 # -1 = auto (2 for r32, 0 for r64)
    device: str = "cuda"         # "cuda" (hand kernels) or "cpu" (plain)
    mesh_shape: Optional[tuple] = None  # (p, q) or "auto": a grid of the
                                        # ranks of a torch.distributed job
    tile_storage: str = "dense"  # "dense" tiles, or "compressed": O(fill)
                                 # slot lists (compressed.py)
    profile_dir: Optional[str] = None  # a torch.profiler trace of gstrf's
                                       # numeric phase (Chrome JSON) here
    complex_mode: str = "auto"   # cr32/cr64: "embed" (real 2x2
                                 # embedding), "native" (complex tiles:
                                 # the fused engine on dense tiles) or
                                 # "auto" (= embed on every device)

    def resolve_dtype(self):
        if self.dtype not in VALUE_DTYPES:
            raise ValueError(
                f"dtype must be one of {sorted(VALUE_DTYPES)}, got "
                f"{self.dtype!r} (reference value types, "
                "pangulu_common.h:11-33)")
        return VALUE_DTYPES[self.dtype]

    def resolve_device(self) -> torch.device:
        return resolve_device(self.device)

    def check_supported(self) -> None:
        if self.tile_storage not in ("dense", "compressed"):
            raise ValueError(f"tile_storage must be 'dense' or "
                             f"'compressed', got {self.tile_storage!r}")
        if self.mesh_shape is not None:
            if self.mesh_shape != "auto" and not (
                    len(tuple(self.mesh_shape)) == 2
                    and all(int(v) >= 1 for v in self.mesh_shape)):
                raise ValueError("mesh_shape must be (p, q) or 'auto', got "
                                 f"{self.mesh_shape!r}")
            if self.tile_storage == "compressed":
                # as the JAX package (pangulu_tpu/api.py:292-296)
                raise ValueError("tile_storage='compressed' is single-device "
                                 "(use dense tiles on a grid of ranks)")
        if self.complex_mode not in ("auto", "embed", "native"):
            raise ValueError("complex_mode must be native|embed|auto, got "
                             f"{self.complex_mode!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {list(BACKENDS)}, "
                             f"got {self.backend!r}")

    def native_complex(self) -> bool:
        """A complex dtype solved with complex tiles (not embedded)."""
        return self.complex_mode == "native" and self.dtype in ("cr32",
                                                                "cr64")


@dataclasses.dataclass
class Handle:
    """Solver handle (reference: pangulu_handle_t,
    src/pangulu_common.h:374-379)."""

    opts: InitOptions
    a_origin: sp.csc_matrix            # working matrix (residual checks;
                                       # the real embedding of a complex one)
    reordering: Reordering
    symbolic_result: SymbolicResult
    blocked: BlockedMatrix
    schedule: Schedule
    perf: PerfCounters
    device: torch.device = torch.device("cpu")
    grid: object = None                # parallel.mesh.Grid with mesh_shape
    # after gstrf: the device tiles, or the CompressedTiles store
    factor_tiles: object = None
    complex_embed: object = None       # the complex dtype when the handle
                                       # solves its real 2x2 embedding
    _factorizer: object = None
    _trisolver: object = None
    _device_transforms: object = None  # gstrs_device permutation state
    _a3_rows_dev: object = None        # gstrs_device residual state
    _comp_store: object = None         # compressed store, reused by
                                       # update_values + gstrf
    _dist: object = None               # DistributedLU: its tables are kept
                                       # by update_values + gstrf


def _multi_rank(handle: Handle) -> bool:
    """A handle factored over a grid of more than one rank: it holds
    only its rank's shard of the factors."""
    return handle._dist is not None and handle._dist.single is None


def init(a, opts: InitOptions | None = None) -> Handle:
    """Reorder -> symbolic -> tile (reference: pangulu_init,
    pangulu.c:11-208)."""
    opts = opts or InitOptions()
    opts.check_supported()
    dtype = opts.resolve_dtype()
    grid = None
    if opts.mesh_shape is not None:
        # a collective: every rank builds its grid here, in step
        grid = make_grid(opts.mesh_shape, opts.device)
        opts.mesh_shape = (grid.p, grid.q)
        device = grid.device
    else:
        device = opts.resolve_device()
    if opts.nb <= 0:
        opts.nb = 128
    if not isinstance(a, CscMatrix):
        a = CscMatrix.from_scipy(sp.csc_matrix(a))
    a = a.astype(dtype)
    complex_embed = None
    if np.dtype(dtype).kind == "c" and not opts.native_complex():
        # solve the interleaved real system (2n x 2n); gstrs embeds the
        # rhs and folds the solution back (pangulu_tpu/api.py:144-150)
        complex_embed = np.dtype(dtype)
        a = complex_embed_matrix(a)
        dtype = a.values.dtype
    a_origin = a.to_scipy().copy()
    perf = PerfCounters()

    a = add_diagonal_elements(a)
    symb_mode = opts.symbolic_mode
    if symb_mode == "auto":
        from pangulu_tpu_torch import native as _native

        # native fill-walk handles millions of rows; pure-Python caps out
        symb_mode = ("scalar" if _native.get_lib() is not None
                     or a.n <= 50_000 else "block")
    if opts.ordering == "auto":
        # Data-driven pick: with dense tiles the cost metric is
        # BLOCK-level work, so measure each candidate's block-flop score
        # and keep the best (pangulu_tpu/api.py:162-194).
        from pangulu_tpu_torch import native as _nat
        from pangulu_tpu_torch.reorder.matching import mc64_scale_and_match

        candidates = (["rcm"]
                      + (["nd"] if _nat.get_lib() is not None
                         or a.n <= 200_000 else [])
                      + (["mindeg"] if a.n <= 100_000 else []))
        # the MC64 matching/scaling is the same for every candidate
        with perf.phase("reorder"):
            match = mc64_scale_and_match(a, enable=opts.mc64)
        best = None
        for cand in candidates:
            with perf.phase("reorder"):
                ro_c = reorder(a, mc64=opts.mc64, ordering=cand,
                               match=match, nb=opts.nb)
            with perf.phase("symbolic"):
                symb_c = symbolic(ro_c.reordered, opts.nb, mode=symb_mode)
            score = symb_c.block_flop_score()
            if best is None or score < best[2]:
                best = (ro_c, symb_c, score, cand)
        ro, symb, _, chosen = best
        log.info("auto ordering picked %s (block-flop score %.3e, "
                 "%d tiles)", chosen, best[2], symb.block_full.nnz)
    else:
        with perf.phase("reorder"):
            ro = reorder(a, mc64=opts.mc64, ordering=opts.ordering,
                         nb=opts.nb)
        with perf.phase("symbolic"):
            symb = symbolic(ro.reordered, opts.nb, mode=symb_mode)
    with perf.phase("preprocess"):
        blocked = tile_matrix(ro.reordered, symb)
        schedule = build_schedule(blocked)
    if symb.mode != "block":
        # exact sparse accounting; block mode has no scalar pattern
        perf.set_useful(symb.sparse_flops(), symb.symbolic_nnz)
    log.info(config_banner(opts, a.n, a.nnz))
    log.info("symbolic nnz = %d (%s mode), block_length = %d, tiles = %d",
             symb.symbolic_nnz, symb_mode, symb.block_length,
             blocked.num_tiles)
    return Handle(
        opts=opts, a_origin=a_origin, reordering=ro, symbolic_result=symb,
        blocked=blocked, schedule=schedule, perf=perf, device=device,
        grid=grid, complex_embed=complex_embed,
    )


def analyze(a, opts: InitOptions | None = None) -> dict:
    """Symbolic-only analysis: run reorder + symbolic + tiling and
    report what a factorization would cost, allocating nothing on the
    device (pangulu_tpu/api.py:247-274).

    Returns: n, nnz, nb, block_length, tiles, fill_nnz (dense-tile
    entries), flops (dense-tile model), factor_hbm_bytes (the tile
    store's device bytes), dtype, and per-phase analysis times.
    """
    h = init(a, opts)
    nb = h.blocked.nb
    tiles = h.blocked.num_tiles
    itemsize = np.dtype(h.blocked.dtype).itemsize
    out = {
        "n": h.blocked.n,
        "nnz": int(h.reordering.reordered.nnz),
        "nb": nb,
        "block_length": h.schedule.block_length,
        "tiles": tiles,
        "fill_nnz": tiles * nb * nb,
        "flops": h.schedule.flop_estimate(),
        "factor_hbm_bytes": (tiles + 1) * nb * nb * itemsize,
        "dtype": str(np.dtype(h.blocked.dtype)),
        "phase_time_s": dict(h.perf.phase_time),
    }
    finalize(h)
    return out


def _compressed(handle: Handle) -> bool:
    return isinstance(handle.factor_tiles, CompressedTiles)


def _complex(handle: Handle) -> bool:
    """A complex handle: embedded, or with native complex tiles."""
    return (handle.complex_embed is not None
            or np.dtype(handle.blocked.dtype).kind == "c")


def _takes_panel_lu(handle: Handle) -> bool:
    """The JAX package's rule for the out-of-core panel driver
    (pangulu_tpu/api.py:297-313, there a TPU with the Pallas backend):
    the handle on a CUDA device, its working type float32 (cr32's
    embedded real system included) and nb 128 or 256."""
    return (handle.device.type == "cuda"
            and np.dtype(handle.blocked.dtype) == np.float32
            and handle.opts.nb in (128, 256))


def gstrf(handle: Handle) -> None:
    """Numeric factorization (reference: pangulu_gstrf, pangulu.c:211).

    With ``tile_storage="compressed"`` the factors stay in the O(fill)
    store.  On a CUDA device at float32 (r32, or cr32's embedded system)
    and nb 128 or 256, :class:`~pangulu_tpu_torch.outofcore.PanelLU`
    factors it panel by panel, K2 on each panel's cross (the JAX
    package's route on a TPU); everywhere else
    :class:`~pangulu_tpu_torch.compressed.CompressedLU` runs its level
    loop over the store.  A later ``gstrf`` of the same pattern
    (``update_values``) refills the same store.

    On a grid of ranks (``mesh_shape``),
    :class:`~pangulu_tpu_torch.parallel.dist_numeric.DistributedLU`
    factors the block-cyclic shards (a 1 x 1 grid: the single-device
    engines); a refactorization after ``update_values`` keeps its tables
    and re-scatters the shards (pangulu_tpu/api.py:334-363,764).  With
    ``check`` the residual comes from the distributed
    ``factor_check_vector``, without a gather.

    With ``profile_dir`` the numeric phase, on every route, runs under
    :func:`~pangulu_tpu_torch.utils.perf.profile_trace`: one Chrome trace
    JSON file a call (and a rank) in that directory, with the card's
    kernels, where the JAX package writes an XPlane trace with
    ``jax.profiler.trace`` (pangulu_tpu/api.py:287-292,372-374).  The
    trace closes before the ``check`` residual, and also when the
    factorization raises."""
    trace = (profile_trace(handle.opts.profile_dir, handle.device,
                           None if handle.grid is None else handle.grid.rank)
             if handle.opts.profile_dir else contextlib.nullcontext())
    with trace:
        if handle.grid is not None:
            dist = handle._dist
            if dist is not None and dist.blocked is handle.blocked:
                handle.perf.kernels["dist_reuse"] = (
                    handle.perf.kernels.get("dist_reuse", 0) + 1)
                log.info("distributed refactorize: reusing the tables")
            else:
                dist = DistributedLU(handle.blocked, handle.schedule,
                                     handle.grid, perf=handle.perf,
                                     tol=handle.opts.tol,
                                     backend=handle.opts.backend)
                handle._dist = dist
            handle.factor_tiles = dist.factorize()
            handle._factorizer = dist.single
        elif handle.opts.tile_storage == "compressed":
            if _takes_panel_lu(handle):
                log.info("engine: panel out-of-core (compressed store, K2 "
                         "on each panel cross)")
                handle._factorizer = PanelLU(
                    handle.blocked, handle.schedule,
                    handle.reordering.reordered, perf=handle.perf,
                    device=handle.device, tol=handle.opts.tol,
                    store=handle._comp_store)
            else:
                log.info("engine: compressed (each level staged dense, "
                         "then written back)")
                handle._factorizer = CompressedLU(
                    handle.blocked, handle.schedule,
                    handle.reordering.reordered, perf=handle.perf,
                    device=handle.device, tol=handle.opts.tol,
                    store=handle._comp_store, backend=handle.opts.backend)
            handle.factor_tiles = handle._factorizer.factorize()
            # the store's structure serves a same-pattern refactorization
            # (update_values + gstrf): O(nnz) refill, no fill walk
            handle._comp_store = handle.factor_tiles
            st = handle.factor_tiles
            log.info("compressed tile store: %.1f MiB vs %.1f MiB dense "
                     "(%.1fx)", st.compressed_bytes / 2 ** 20,
                     st.dense_bytes / 2 ** 20,
                     st.dense_bytes / max(st.compressed_bytes, 1))
        else:
            handle._factorizer = LUFactorizer(
                handle.blocked, handle.schedule, perf=handle.perf,
                device=handle.device, tol=handle.opts.tol,
                backend=handle.opts.backend)
            handle.factor_tiles = handle._factorizer.factorize()
        # drop any cached solver: it holds the previous factorization's
        # triangle inverses
        handle._trisolver = None
    if handle.opts.profile_dir:
        log.info("profiler trace written to %s", handle.opts.profile_dir)
    log.info(handle.perf.summary())
    if handle.opts.check:
        a3 = handle.reordering.reordered.to_scipy()
        if _multi_rank(handle):
            # complex tiles keep their imaginary parts (the JAX package
            # takes w as float64 here, pangulu_tpu/api.py:400-405, which
            # drops them: its check then reads ~0.7 on exact factors)
            w = handle._dist.factor_check_vector()
            a1 = np.asarray(a3 @ np.ones(handle.blocked.n))
            acc = np.complex128 if np.iscomplexobj(w) else np.float64
            res = float(np.linalg.norm(w.astype(acc) - a1)
                        / (float(np.linalg.norm(a1)) or 1.0))
        else:
            tiles = (handle.factor_tiles.to_dense() if _compressed(handle)
                     else handle.factor_tiles.cpu().numpy())
            lmat, umat = gather_factor(handle.blocked, tiles)
            res = factorization_residual(a3, lmat, umat)
        log.info("gstrf check ||L(U*1)-A*1||/||A*1|| = %.3e", res)
        handle.perf.kernels["gstrf_residual"] = res


def _ensure_trisolver(handle: Handle) -> TriangularSolver:
    """The handle's cached solver, built at first use on the inverses
    the factorization persisted (recomputed from the packed factors when
    there are none, e.g. a checkpoint-loaded handle); on a grid of
    ranks, the distributed solver."""
    if handle._trisolver is None and _multi_rank(handle):
        handle._trisolver = DistributedTriangularSolver(
            handle.blocked, handle.schedule, handle._dist.layout,
            handle.grid, handle._dist.diag, perf=handle.perf)
    elif handle._trisolver is None:
        inv_tiles = getattr(handle._factorizer, "inv_tiles", None)
        handle._trisolver = TriangularSolver(
            handle.blocked, handle.schedule, perf=handle.perf,
            device=handle.device, inv_tiles=inv_tiles,
            backend=handle.opts.backend)
    return handle._trisolver


def _solve_once(handle: Handle, b: np.ndarray,
                trans: bool = False) -> np.ndarray:
    ro, ts = handle.reordering, handle._trisolver
    if trans:
        w = ts.solve_trans(handle.factor_tiles, ro.transform_b_trans(b))
        return ro.transform_x_trans(w)
    if _compressed(handle):
        w = handle._factorizer.solve(ro.transform_b(b))
    else:
        w = ts.solve(handle.factor_tiles, ro.transform_b(b))
    return ro.transform_x(w)


def gstrs(handle: Handle, b: np.ndarray, refine: int | None = None,
          trans: bool = False) -> np.ndarray:
    """Triangular solves for one or many rhs (reference: pangulu_gstrs,
    pangulu.c:271): reorder b, solve, un-reorder x.

    ``refine``: rounds of mixed-precision iterative refinement: factor
    once in working precision, then correct with float64 host residuals
    ``r = b - A x`` and extra triangular solves (pangulu_tpu/api.py:
    510-539).  Default: the value from InitOptions (-1 = 2 for r32,
    0 for r64).

    ``trans``: solve ``A^T x = b`` from the SAME factors (A^T = U^T L^T;
    no reference equivalent — SuperLU-style surface), refined against
    A^T.

    On a complex handle ``b`` is taken as complex, and x comes back in
    the complex type of ``b``'s precision and the handle's, whichever is
    wider (complex64 for a complex64 ``b`` on cr32); the refinement's
    residuals are those of the embedded system against ``b`` at that
    precision, or, with native complex tiles, complex128 residuals of A
    (pangulu_tpu/api.py:510-539), 2 rounds by default for cr32."""
    if handle.factor_tiles is None:
        raise RuntimeError("gstrs called before gstrf (reference aborts "
                           "the same way)")
    if trans and _multi_rank(handle):
        raise NotImplementedError(
            "transpose solve requires the single-device dense-tile path "
            "(not factors distributed over a grid of ranks), as in the JAX "
            "package")
    if handle.complex_embed is not None:
        # complex rhs -> interleaved real rhs; solve the embedded real
        # system; fold back (pangulu_tpu/api.py:463-477).  Transpose:
        # emb(A)^T = emb(A^H), so A^T x = b is solved as
        # A^H conj(x) = conj(b).
        emb = handle.complex_embed
        b_in = np.asarray(b)
        cdt = np.result_type(b_in.dtype, emb)
        bc = b_in.astype(cdt)
        br = complex_embed_rhs(np.conj(bc) if trans else bc)
        handle.complex_embed = None
        try:
            xr = gstrs(handle, br, refine=refine, trans=trans)
        finally:
            handle.complex_embed = emb
        x = complex_unembed_x(xr, cdt)
        return np.conj(x) if trans else x
    if _compressed(handle):
        if trans:
            raise NotImplementedError(
                "transpose solve requires the dense tile store (not "
                "compressed factors), as in the JAX package")
    else:
        _ensure_trisolver(handle)
    work_dtype = np.dtype(handle.blocked.dtype)
    b_in = np.asarray(b)
    native = work_dtype.kind == "c"
    if native:
        b_in = b_in.astype(np.result_type(b_in.dtype, work_dtype))
    b = b_in.astype(work_dtype)
    if refine is None:
        refine = handle.opts.refine
    if refine is None or refine < 0:  # auto: 2 for r32 and cr32
        refine = 2 if work_dtype in (np.float32, np.complex64) else 0
    x = _solve_once(handle, b, trans=trans)
    if refine:
        acc = np.complex128 if native else np.float64
        a64 = handle.a_origin.astype(acc)
        if trans:
            a64 = a64.T.tocsc()
        x64 = x.astype(acc)
        b64 = b_in.astype(acc)
        prev = None
        for _ in range(refine):
            r = b64 - a64 @ x64
            rn = float(np.linalg.norm(np.atleast_2d(r)))
            if prev is not None and rn >= prev * 0.5:
                log.info("iterative refinement stagnated at residual "
                         "%.2e — the factor quality (conditioning / "
                         "f32 pivoting) limits further gains", rn)
                break
            prev = rn
            dx = _solve_once(handle, r.astype(work_dtype), trans=trans)
            x64 = x64 + dx.astype(acc)
        return (x64.astype(b_in.dtype) if native or b_in.dtype.kind == "f"
                else x64)
    return x.astype(b_in.dtype) if native or b_in.dtype.kind == "f" else x


def gstrs_device(handle: Handle, b: torch.Tensor,
                 refine: int = 0) -> torch.Tensor:
    """Device-resident gstrs (pangulu_tpu/api.py:542-625): ``b`` is a
    tensor ``[n]`` or ``[n, nrhs]`` already on the handle's device; the
    scaling, permutations, solve (K3 or K5 on a CUDA device, through
    :meth:`TriangularSolver.solve_blocked`) and back-permutation all run
    there, and the result returns as a tensor on that device WITHOUT a
    host synchronisation, so back-to-back solves chain on the device.

    ``refine``: rounds of device-side iterative refinement with the
    ORIGINAL A3 tiles (residual in working precision — for f64-class
    accuracy use the host-residual path of :func:`gstrs`)."""
    if handle.factor_tiles is None:
        raise RuntimeError("gstrs called before gstrf (reference aborts "
                           "the same way)")
    if (_compressed(handle) or _complex(handle) or _multi_rank(handle)):
        raise NotImplementedError(
            "gstrs_device supports the single-device dense tile store (not "
            "compressed/complex-embedded/native complex factors or factors "
            "distributed over a grid of ranks), as in the JAX package")
    if not isinstance(b, torch.Tensor) or b.device != handle.device:
        raise ValueError(f"gstrs_device takes a tensor on {handle.device}, "
                         f"got {type(b).__name__}"
                         + (f" on {b.device}" if isinstance(b, torch.Tensor)
                            else ""))
    solver = _ensure_trisolver(handle)
    bl, nb = handle.schedule.block_length, handle.schedule.nb
    n = handle.blocked.n
    dt = handle.blocked.torch_dtype
    if handle._device_transforms is None:
        ro = handle.reordering
        pad = bl * nb - n  # blocked slots beyond n read b[0] * 0
        in_idx = np.concatenate([ro.perm, np.zeros(pad, np.int64)])
        in_scale = np.concatenate([ro.row_scale[ro.perm], np.zeros(pad)])
        cpinv = np.empty(n, np.int64)
        cpinv[ro.colperm] = np.arange(n)
        invperm = np.empty(n, np.int64)
        invperm[ro.perm] = np.arange(n)
        handle._device_transforms = tuple(
            torch.as_tensor(v, device=handle.device)
            for v in (in_idx, in_scale.astype(handle.blocked.dtype),
                      invperm[cpinv],
                      ro.col_scale.astype(handle.blocked.dtype)))
    in_idx, in_scale, out_idx, out_scale = handle._device_transforms
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    nrhs = b2.shape[1]
    bt = (b2[in_idx] * in_scale[:, None]).to(dt)
    xb = torch.zeros((bl + 1, nb, nrhs), dtype=dt, device=handle.device)
    xb[:bl] = bt.reshape(bl, nb, nrhs)
    w = solver.solve_blocked(handle.factor_tiles, xb)
    for _ in range(refine):
        # device-side refinement: r = bt - A3 w (working precision)
        w = w + solver.solve_blocked(handle.factor_tiles,
                                     _a3_residual_device(handle, w, xb))
    xflat = w[:bl].reshape(bl * nb, nrhs)[:n]
    out = xflat[out_idx] * out_scale[:, None]
    return out[:, 0] if squeeze else out


def _a3_residual_device(handle: Handle, w: torch.Tensor,
                        xb: torch.Tensor) -> torch.Tensor:
    """Blocked working-precision residual ``xb - A3 w`` on the device
    (A3 tiles gathered block-row-wise; pad slots hit the all-zero
    scratch tile and segment, so they are exact no-ops;
    pangulu_tpu/api.py:704-728)."""
    if handle._a3_rows_dev is None:
        blocked, bl = handle.blocked, handle.schedule.block_length
        wmax = max(int(np.diff(blocked.brownnzptr).max()), 1)
        row_ids = np.full((bl, wmax), blocked.num_tiles, np.int64)
        row_cols = np.full((bl, wmax), bl, np.int64)
        for k in range(bl):
            s, e = blocked.brownnzptr[k], blocked.brownnzptr[k + 1]
            row_ids[k, : e - s] = blocked.tile_of_csr[s:e]
            row_cols[k, : e - s] = blocked.bcolidx[s:e]
        handle._a3_rows_dev = (
            blocked.device_tiles(handle.device),
            torch.as_tensor(row_ids, device=handle.device),
            torch.as_tensor(row_cols, device=handle.device))
    a3, row_ids, row_cols = handle._a3_rows_dev
    bl = row_ids.shape[0]
    r = xb.clone()
    for i in range(row_ids.shape[1]):
        r[:bl] -= torch.bmm(a3[row_ids[:, i]], w[row_cols[:, i]])
    return r


def update_values(handle: Handle, a_new) -> None:
    """Refactorization fast path (pangulu_tpu/api.py:731-771): replace
    the matrix VALUES while keeping its sparsity pattern, reusing the
    reordering, symbolic analysis, tiling and schedule; call
    :func:`gstrf` afterwards to factor the new values.

    The reference has no equivalent — a new matrix requires
    finalize+init (README.md:125), repeating the entire O(fill) setup.
    Here the update is O(nnz).  The MC64 scaling and permutations are
    those of the ORIGINAL matrix (standard refactorize semantics:
    fastest, and stable while the new values are not wildly different;
    re-run :func:`init` when they are).  A matrix of another pattern
    raises ``ValueError`` and leaves the handle as it was.
    """
    dtype = handle.opts.resolve_dtype()
    if not isinstance(a_new, CscMatrix):
        a_new = CscMatrix.from_scipy(sp.csc_matrix(a_new))
    a_new = a_new.astype(dtype)
    if handle.complex_embed is not None:
        a_new = complex_embed_matrix(a_new)
    a_origin = a_new.to_scipy().copy()
    a_new = add_diagonal_elements(a_new)
    with handle.perf.phase("update_values"):
        a3 = handle.reordering.transform_matrix(a_new)
        ref = handle.reordering.reordered
        if a3.nnz != ref.nnz or not (
                np.array_equal(a3.colptr, ref.colptr)
                and np.array_equal(a3.rowidx, ref.rowidx)):
            raise ValueError(
                "update_values requires the same sparsity pattern; "
                "call init() for a structurally different matrix")
        handle.reordering.reordered = a3
        refill_values(handle.blocked, a3)
    handle.a_origin = a_origin
    # numeric state goes; the analysis is reused (the permutation state
    # of gstrs_device depends on the pattern and the scalings only), and
    # so are the distributed tables (handle._dist), which depend on the
    # pattern only
    handle.factor_tiles = None
    handle._factorizer = None
    handle._trisolver = None
    handle._a3_rows_dev = None   # gstrs_device's residual reads A3 values


def _parity(p: np.ndarray) -> int:
    """Sign of the permutation ``p``, from its cycle lengths."""
    seen = np.zeros(len(p), dtype=bool)
    sign = 1
    for i in range(len(p)):
        if seen[i]:
            continue
        j, clen = i, 0
        while not seen[j]:
            seen[j] = True
            j = p[j]
            clen += 1
        if clen % 2 == 0:
            sign = -sign
    return sign


def factor_diagnostics(handle: Handle) -> dict:
    """Post-gstrf diagnostics from the factors (pangulu_tpu/api.py:
    774-841; beyond the reference's API):

    * ``logabsdet`` / ``sign``: log|det A| and its sign, from U's
      diagonal and the reordering permutation parities (det A =
      sign(P) sign(Q) det(Dr)^-1 det(Dc)^-1 prod(diag U) for the
      scaled, permuted factorization).
    * ``cond1_est``: Hager/Higham 1-norm condition estimate —
      ||A||_1 * est(||A^-1||_1) by ``scipy.sparse.linalg.onenormest``,
      the A^-1 applications being gstrs solves (the transpose solve
      powers the adjoint applications).  It draws from ``np.random``.
    """
    import scipy.sparse.linalg as spla

    if handle.factor_tiles is None:
        raise RuntimeError("factor_diagnostics requires gstrf first")
    if _multi_rank(handle):
        raise NotImplementedError(
            "factor_diagnostics needs the whole factor, and a handle on a "
            "grid of ranks holds only its rank's shard")
    if _complex(handle):
        raise NotImplementedError(
            "factor_diagnostics currently supports real dtypes")
    if _compressed(handle):
        # its condition estimate needs the transpose solve
        raise NotImplementedError(
            "factor_diagnostics requires the dense tile store (its "
            "condition estimate takes the transpose solve)")
    ro = handle.reordering
    nb, n = handle.blocked.nb, handle.blocked.n
    diag_ids = torch.as_tensor(
        np.array([lev.diag for lev in handle.schedule.levels]),
        device=handle.device)
    diag = torch.diagonal(handle.factor_tiles[diag_ids], dim1=-2, dim2=-1)
    diag = diag.reshape(-1).cpu().numpy().astype(np.float64)[:n]
    # undo the MC64 scalings' determinant contribution
    logabsdet = (float(np.sum(np.log(np.abs(diag))))
                 - float(np.sum(np.log(ro.row_scale)))
                 - float(np.sum(np.log(ro.col_scale))))
    # Only the MC64 COLUMN permutation contributes a sign: the
    # fill-reducing permutation is applied symmetrically
    # (A3 = A2[p][:, p], det(P) det(P^T) = +1) and the scalings are
    # positive diagonals.
    sign = float(np.prod(np.sign(diag))) * _parity(np.asarray(ro.colperm))
    op = spla.LinearOperator(
        (n, n),
        matvec=lambda v: gstrs(handle, v.astype(np.float64)),
        rmatvec=lambda v: gstrs(handle, v.astype(np.float64), trans=True),
        dtype=np.float64)
    inv_norm = float(spla.onenormest(op))
    a_norm = float(spla.norm(handle.a_origin.tocsc(), 1))
    return {"logabsdet": logabsdet, "sign": sign,
            "cond1_est": a_norm * inv_norm}


def gssv(handle: Handle, b: np.ndarray) -> np.ndarray:
    """Factor + solve (reference: pangulu_gssv, pangulu.c:327)."""
    gstrf(handle)
    return gstrs(handle, b)


def finalize(handle: Handle) -> None:
    """Release device buffers (reference: pangulu_finalize,
    pangulu.c:333)."""
    handle.factor_tiles = None
    handle._factorizer = None
    handle._trisolver = None
    handle._device_transforms = None
    handle._a3_rows_dev = None
    handle._comp_store = None
    handle._dist = None


def spsolve(a, b, **options):
    """scipy-style one-shot solve: ``x = spsolve(A, b, device="cuda")``.

    ``options`` are :class:`InitOptions` fields (nb, dtype, ordering,
    device, ...)."""
    h = init(a, InitOptions(**options) if options else None)
    try:
        return gssv(h, b)
    finally:
        finalize(h)


class Solver:
    """Convenience wrapper: ``x = Solver(A, device="cuda").solve(b)``."""

    def __init__(self, a, opts: InitOptions | None = None, **kw):
        if opts is None and kw:
            opts = InitOptions(**kw)
        self.handle = init(a, opts)
        self._factored = False

    def factor(self) -> "Solver":
        gstrf(self.handle)
        self._factored = True
        return self

    def solve(self, b: np.ndarray, trans: bool = False) -> np.ndarray:
        if not self._factored:
            self.factor()
        return gstrs(self.handle, b, trans=trans)

    def update_values(self, a_new) -> "Solver":
        """Same-pattern refactorization fast path (see
        :func:`update_values`); the next solve refactors."""
        update_values(self.handle, a_new)
        self._factored = False
        return self

    @property
    def perf(self) -> PerfCounters:
        return self.handle.perf

    def close(self):
        finalize(self.handle)
