"""Public API: init / gstrf / gstrs / gssv / finalize.

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
for.  Options this port does not implement yet raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from pangulu_tpu_torch.blocks import BlockedMatrix, gather_factor, tile_matrix
from pangulu_tpu_torch.numeric import LUFactorizer
from pangulu_tpu_torch.ops.kernels_torch import check_nb
from pangulu_tpu_torch.reorder import Reordering, reorder
from pangulu_tpu_torch.schedule import Schedule, build_schedule
from pangulu_tpu_torch.sparse import (VALUE_DTYPES, CscMatrix,
                                      add_diagonal_elements)
from pangulu_tpu_torch.sptrsv import TriangularSolver
from pangulu_tpu_torch.symbolic import SymbolicResult, symbolic
from pangulu_tpu_torch.utils.log import config_banner, get_logger
from pangulu_tpu_torch.utils.perf import PerfCounters, factorization_residual

log = get_logger()


@dataclasses.dataclass
class InitOptions:
    """Runtime options (reference: pangulu_init_options,
    include/pangulu_interface_common.h:3-12, plus the compile-time
    PANGULU_FLAGS promoted to runtime options)."""

    nb: int = 128                # block size (<= 128 in this port)
    dtype: str = "r64"           # r32 | r64 (cr32/cr64: ROADMAP M8)
    mc64: bool = True            # -DPANGULU_MC64
    ordering: str = "auto"       # METIS analogue: mindeg|rcm|nd|natural|auto
    symbolic_mode: str = "auto"  # scalar | block | auto
    tol: Optional[float] = None  # tiny-pivot substitution threshold
    check: bool = False          # -DPANGULU_PERF residual check
    refine: int = -1             # iterative-refinement rounds in gstrs;
                                 # -1 = auto (2 for r32, 0 for r64)
    device: str = "cuda"         # "cuda" (hand kernels) or "cpu" (plain)
    mesh_shape: Optional[tuple] = None  # multi-device: ROADMAP M11
    tile_storage: str = "dense"  # "compressed": ROADMAP M9
    profile_dir: Optional[str] = None  # profiler traces: not ported

    def resolve_dtype(self):
        if self.dtype in ("cr32", "cr64"):
            raise NotImplementedError(
                f"dtype={self.dtype!r}: complex types are ROADMAP M8 "
                "(not ported yet)")
        if self.dtype not in VALUE_DTYPES:
            raise ValueError(
                f"dtype must be one of {sorted(VALUE_DTYPES)}, got "
                f"{self.dtype!r} (reference value types, "
                "pangulu_common.h:11-33)")
        return VALUE_DTYPES[self.dtype]

    def resolve_device(self) -> torch.device:
        dev = torch.device(self.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device='cuda' but no CUDA device is available; ask "
                    "for device='cpu' explicitly to run the plain "
                    "PyTorch versions")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{self.device!r}")
        return dev

    def check_supported(self) -> None:
        if self.mesh_shape is not None:
            raise NotImplementedError(
                "mesh_shape: multi-device execution is ROADMAP M11 (not "
                "ported yet)")
        if self.tile_storage == "compressed":
            raise NotImplementedError(
                "tile_storage='compressed' is ROADMAP M9 (not ported yet)")
        if self.tile_storage != "dense":
            raise ValueError(f"tile_storage must be 'dense', got "
                             f"{self.tile_storage!r}")
        if self.profile_dir is not None:
            raise NotImplementedError(
                "profile_dir: profiler traces of the numeric phase are "
                "not ported yet (ROADMAP M6)")


@dataclasses.dataclass
class Handle:
    """Solver handle (reference: pangulu_handle_t,
    src/pangulu_common.h:374-379)."""

    opts: InitOptions
    a_origin: sp.csc_matrix            # working matrix (residual checks)
    reordering: Reordering
    symbolic_result: SymbolicResult
    blocked: BlockedMatrix
    schedule: Schedule
    perf: PerfCounters
    device: torch.device = torch.device("cpu")
    factor_tiles: Optional[torch.Tensor] = None  # device tiles after gstrf
    _factorizer: object = None
    _trisolver: object = None


def init(a, opts: InitOptions | None = None) -> Handle:
    """Reorder -> symbolic -> tile (reference: pangulu_init,
    pangulu.c:11-208)."""
    opts = opts or InitOptions()
    opts.check_supported()
    dtype = opts.resolve_dtype()
    device = opts.resolve_device()
    if opts.nb <= 0:
        opts.nb = 128
    check_nb(opts.nb)
    if not isinstance(a, CscMatrix):
        a = CscMatrix.from_scipy(sp.csc_matrix(a))
    a = a.astype(dtype)
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
    )


def gstrf(handle: Handle) -> None:
    """Numeric factorization (reference: pangulu_gstrf, pangulu.c:211)."""
    handle._factorizer = LUFactorizer(
        handle.blocked, handle.schedule, perf=handle.perf,
        device=handle.device, tol=handle.opts.tol)
    handle.factor_tiles = handle._factorizer.factorize()
    # drop any cached solver: it holds the previous factorization's
    # triangle inverses
    handle._trisolver = None
    log.info(handle.perf.summary())
    if handle.opts.check:
        lmat, umat = gather_factor(handle.blocked,
                                   handle.factor_tiles.cpu().numpy())
        res = factorization_residual(
            handle.reordering.reordered.to_scipy(), lmat, umat)
        log.info("gstrf check ||L(U*1)-A*1||/||A*1|| = %.3e", res)
        handle.perf.kernels["gstrf_residual"] = res


def _solve_once(handle: Handle, b: np.ndarray) -> np.ndarray:
    bt = handle.reordering.transform_b(b)
    w = handle._trisolver.solve(handle.factor_tiles, bt)
    return handle.reordering.transform_x(w)


def gstrs(handle: Handle, b: np.ndarray,
          refine: int | None = None) -> np.ndarray:
    """Triangular solves for one or many rhs (reference: pangulu_gstrs,
    pangulu.c:271): reorder b, solve, un-reorder x.

    ``refine``: rounds of mixed-precision iterative refinement: factor
    once in working precision, then correct with float64 host residuals
    ``r = b - A x`` and extra triangular solves (pangulu_tpu/api.py:
    510-539).  Default: the value from InitOptions (-1 = 2 for r32,
    0 for r64)."""
    if handle.factor_tiles is None:
        raise RuntimeError("gstrs called before gstrf (reference aborts "
                           "the same way)")
    work_dtype = handle.blocked.dtype
    b_in = np.asarray(b)
    b = b_in.astype(work_dtype)
    if handle._trisolver is None:
        inv_tiles = getattr(handle._factorizer, "inv_tiles", None)
        handle._trisolver = TriangularSolver(
            handle.blocked, handle.schedule, perf=handle.perf,
            device=handle.device, inv_tiles=inv_tiles)
    if refine is None:
        refine = handle.opts.refine
    if refine is None or refine < 0:  # auto
        refine = 2 if np.dtype(work_dtype) == np.float32 else 0
    x = _solve_once(handle, b)
    if refine:
        a64 = handle.a_origin.astype(np.float64)
        x64 = x.astype(np.float64)
        b64 = b_in.astype(np.float64)
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
            dx = _solve_once(handle, r.astype(work_dtype))
            x64 = x64 + dx.astype(np.float64)
        return (x64.astype(b_in.dtype) if b_in.dtype.kind == "f"
                else x64)
    return x.astype(b_in.dtype) if b_in.dtype.kind == "f" else x


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

    def solve(self, b: np.ndarray) -> np.ndarray:
        if not self._factored:
            self.factor()
        return gstrs(self.handle, b)

    @property
    def perf(self) -> PerfCounters:
        return self.handle.perf

    def close(self):
        finalize(self.handle)
