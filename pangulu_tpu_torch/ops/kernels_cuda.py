"""Wrappers of the hand-written CUDA kernels (``csrc/lu_kernels.cu``,
with the compressed store's in ``csrc/compressed.cuh`` and the TPU
probes' in ``csrc/probes.cuh``).

Each wrapper takes the same arguments as its plain version in
:mod:`pangulu_tpu_torch.ops.kernels_torch`:

  * a tensor on the CPU goes to the plain version;
  * a tensor on a CUDA device goes to the kernel, or the wrapper raises
    (no library, no ``nvcc``, an input the kernel does not take, a
    launch error).  There is no fallback from the card to anything else.

On the card a wrapper checks device, dtype, shape, contiguity and the
index tables, allocates outputs with ``torch.empty``, launches on the
current stream without synchronising, raises if the C entry returns a
CUDA error, and adds to :data:`LAUNCHES` the launches it made.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pangulu_tpu_torch.ops import build
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.ops.kernels_torch import (Indices, KernelTables,
                                                 check_nb, check_store_nb)
from pangulu_tpu_torch.schedule import (check_ahead, group_dst_csr,
                                        group_solve_steps)

_ABI = 19
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# Per kernel, the number of times it was launched on the card: one per
# wrapper call of K1, K2, K3, K4, K5, P6 (decompress_tiles,
# compress_tiles), P2 (newton_inverses) or the probes P5 (scan_overlap),
# P4 (scan_multi) and P3 (newton_loop) that launched, plus, for K1,
# every diagonal step that K2's level loop or K4's group loop launches
# (K1's kernel; the C entries count them), and each call of
# testing.diag_step.  An empty batch launches nothing and counts
# nothing.  chip_smoke.py zeroes the counts before it drives a path and
# reads them after.
LAUNCHES = {"getrf_with_inverses": 0, "mega_factorize": 0, "mega_solve": 0,
            "mega_factorize_groups": 0, "mega_solve_groups": 0,
            "decompress_tiles": 0, "compress_tiles": 0,
            "newton_inverses": 0, "scan_overlap": 0, "scan_multi": 0,
            "newton_loop": 0}

# K1's device launches, as the C entries report them: one a K1 launch,
# the register-tile kernel up to nb = 128, a cluster kernel above, up to
# nb = 512 (csrc/lu_kernels.cu lu_cluster_kernel to 256, csrc/
# wide_lu.cuh lu_wide_kernel above), and the flow kernel up to W_T
# (FLOW_MAX_NB: 1408 in float32, 1120 in float64) where the batch's
# tiles all fit on the card at once; beyond, each of the recursion's
# launches (k1_device_launches: 7 for one split).  Zeroed with
# LAUNCHES.
DEVICE_LAUNCHES = {"getrf_with_inverses": 0}

# K2's diagonal steps run ahead on its second stream (chain-ahead
# tables, PANGULU_TPU_SUPERLEVEL=1), as the C entry reports them; they
# are among K1's launches above.  Zeroed with LAUNCHES.
AHEAD = {"mega_factorize": 0}

# The grid of the last K3 and K5 call ("mega_solve",
# "mega_solve_groups"): blocks (CTAs) of its forward and backward
# launch, the cluster size (1: the one-block kernels of nb <= 128; above,
# thread block clusters, csrc/solve_clusters.cuh), and what the
# occupancy query said fits: blocks an SM (nb <= 128) or clusters
# (above).
GRID: dict = {}

_library: build.KernelLibrary | None = None


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, DEVICE_LAUNCHES, AHEAD):
        for k in counts:
            counts[k] = 0


def _count_k1(k1) -> None:
    """Add a C entry's K1 counts (K1 launches, device launches)."""
    LAUNCHES["getrf_with_inverses"] += k1[0]
    DEVICE_LAUNCHES["getrf_with_inverses"] += k1[1]


def library() -> build.KernelLibrary:
    """The kernel library, built from ``csrc/`` at first use."""
    global _library
    if _library is not None:
        return _library
    kl = build.load()
    lib = kl.lib
    lib.plu_kernels_abi.restype = ctypes.c_int
    lib.plu_kernels_abi.argtypes = []
    if lib.plu_kernels_abi() != _ABI:
        raise RuntimeError(f"kernel library {kl.path} has ABI "
                           f"{lib.plu_kernels_abi()}, expected {_ABI}")
    lib.plu_error_string.restype = ctypes.c_char_p
    lib.plu_error_string.argtypes = [ctypes.c_int]
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for s in _SUFFIX.values():
        fn = getattr(lib, f"plu_getrf_inv_{s}")
        fn.restype = i
        fn.argtypes = [i, p, p, p, p, i, i, d, p, p]
        fn = getattr(lib, f"plu_mega_factorize_{s}")
        fn.restype = i
        fn.argtypes = ([i, p, p] + [p] * 6 + [p] * 5
                       + [i] * 7 + [d, p, p, p])
        fn = getattr(lib, f"plu_mega_solve_{s}")
        fn.restype = i
        fn.argtypes = ([i, p, p, i, p, p] + [p] * 4 + [p] * 4
                       + [i] * 3 + [p, p])
        fn = getattr(lib, f"plu_mega_factorize_groups_{s}")
        fn.restype = i
        fn.argtypes = ([i, p, p] + [p] * 8 + [p] * 3 + [p] * 5
                       + [i] * 8 + [d, p, p])
        fn = getattr(lib, f"plu_mega_solve_groups_{s}")
        fn.restype = i
        fn.argtypes = [i, p, p, i, p, p] + [p] * 6 + [i] * 6 + [p, p, p]
        fn = getattr(lib, f"plu_triangle_inverses_{s}")
        fn.restype = i
        fn.argtypes = [i, p, p, p, i, i, d, p]
        fn = getattr(lib, f"plu_getrf_inv_wide_{s}")
        fn.restype = i
        fn.argtypes = [i, p, p, p, p, p, p, p, i, i, d, p, p]
        fn = getattr(lib, f"plu_flow_probe_{s}")
        fn.restype = i
        fn.argtypes = [i, p, p, p, p, p, p, i, i, d, p, p, p]
        fn = getattr(lib, f"plu_diag_step_{s}")
        fn.restype = i
        fn.argtypes = [i, p, p, p, p, i, i, d, p, p]
        fn = getattr(lib, f"plu_newton_loop_{s}")
        fn.restype = i
        fn.argtypes = [i, p, p, p, i, i, i, i, p]
    for w in sorted(set(_SLOT_WORDS.values())):
        fn = getattr(lib, f"plu_stage_slots_{w}")
        fn.restype = i
        fn.argtypes = [i, i, p, p, i, p, p, p] + [i] * 6 + [p, p]
    lib.plu_wide_work_elems.restype = ctypes.c_longlong
    lib.plu_wide_work_elems.argtypes = [i]
    lib.plu_flow_leaf.restype = i
    lib.plu_flow_leaf.argtypes = [i, i, i]
    lib.plu_flow_max_nb.restype = i
    lib.plu_flow_max_nb.argtypes = [i]
    lib.plu_flow_plan.restype = i
    lib.plu_flow_plan.argtypes = [i, i, i, p]
    for name in ("plu_flow_flag_slots", "plu_flow_clk_slots"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
    lib.plu_wide_plan.restype = i
    lib.plu_wide_plan.argtypes = [i, i, p]
    lib.plu_wide_clk_slots.restype = i
    lib.plu_wide_clk_slots.argtypes = []
    for s in _SUFFIX.values():
        fn = getattr(lib, f"plu_wide_probe_{s}")
        fn.restype = i
        fn.argtypes = [i, p, p, p, p, i, i, d, i, p, p]
        fn = getattr(lib, f"plu_wide_fit_{s}")
        fn.restype = i
        fn.argtypes = [i, i, p]
    lib.plu_scan_overlap_f32.restype = i
    lib.plu_scan_overlap_f32.argtypes = [i, i, i, p, p, p, p, p, i, i, i,
                                         p]
    lib.plu_scan_multi_f32.restype = i
    lib.plu_scan_multi_f32.argtypes = [i, i, i, i, i, p, p, p, p, p, i, i,
                                       i, p]
    lib.plu_cluster_sync_probe.restype = i
    lib.plu_cluster_sync_probe.argtypes = [i, i, i, p]
    lib.plu_grid_sync_probe.restype = i
    lib.plu_grid_sync_probe.argtypes = [i, i, i, p, p]
    _library = kl
    return kl


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor, else raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensor on {t.device}: the port runs on cpu "
                     "(plain versions) or cuda (hand kernels) only")


def _check_tensor(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_table(name, arr, lo, hi):
    """Every entry of the host table within [lo, hi]: an index out of
    range would read or write outside the tile store on the card."""
    if arr.size and (arr.min() < lo or arr.max() > hi):
        raise ValueError(f"{name} has entries outside [{lo}, {hi}]")


def _dev_tables(tables: KernelTables, keys, device):
    out = []
    for k in keys:
        t = tables.dev[k]
        _check_tensor(k, t, torch.int32, tables.host[k].shape, device)
        out.append(t)
    return out


def _call(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = library().lib.plu_error_string(rc).decode()
        raise RuntimeError(f"{fn.__name__}: CUDA error {rc} ({msg})")


def _host_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _dtype_of(t: torch.Tensor) -> str:
    if t.dtype not in _SUFFIX:
        raise TypeError(f"the CUDA kernels take float32 or float64, got "
                        f"{t.dtype}")
    return _SUFFIX[t.dtype]


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def getrf_with_inverses(a: torch.Tensor, tol: float | None = None):
    """K1: (f, L^-1, U^-1) of ``a`` ([nb, nb] or [B, nb, nb]); see
    :func:`kernels_torch.getrf_with_inverses`.  Above nb = 128 the card
    runs the blocked step of
    :func:`kernels_torch.getrf_with_inverses_blocked`, one launch for
    the batch: up to nb = 256 on a thread block cluster of 2 (f32) or 4
    (f64) CTAs a tile; up to nb = 512 on a cluster of one CTA a panel's
    32 rows (csrc/wide_lu.cuh, :func:`wide_plan`); up to W_T
    (:data:`FLOW_MAX_NB`) on one cooperative launch of the flow kernel,
    ceil(nb / 32) CTAs of 32 rows (f32) or twice as many of 16 (f64) a
    tile, passing the panels by ready flags in global memory, every tile
    of the batch at once, one CTA an SM (:func:`flow_plan`).  Its bound
    there is the chain of the diagonal warp's panels, not bytes or
    operations (PERF.md).  Wider tiles, and batches whose tiles do not
    all fit on the card at once, take the recursion of
    :func:`kernels_torch.k1_wide` on leaves of at most
    :func:`kernels_torch.k1_leaf_width`, counted as one launch, its
    device launches in :data:`DEVICE_LAUNCHES`
    (:func:`k1_device_launches`).  If the
    cluster or the cooperative grid does not fit on the card, the call
    raises.  On the CPU a tile above nb = 256 goes to
    :func:`kernels_torch.getrf_with_inverses_wide` with the rank-1 scan
    at its leaves (the reference semantics)."""
    wide = a.shape[-1] > kt.MAX_NB
    if not _on_cuda(a):
        return (kt.getrf_with_inverses_wide(a, tol) if wide
                else kt.getrf_with_inverses(a, tol))
    s = _dtype_of(a)
    if tol is None:
        tol = kt.DEFAULT_TOL[a.dtype]
    single = a.dim() == 2
    a3 = a[None] if single else a
    if a3.dim() != 3 or a3.shape[-1] != a3.shape[-2]:
        raise ValueError(f"expected [nb, nb] or [B, nb, nb], got "
                         f"{tuple(a.shape)}")
    nb = a3.shape[-1]
    _check_tensor("a", a3, a.dtype, a3.shape, a.device)
    f, linv, uinv = (torch.empty_like(a3) for _ in range(3))
    if a3.shape[0]:
        lib = library().lib
        k1 = (ctypes.c_int * 2)()
        if wide:
            work = torch.empty(a3.shape[0] * lib.plu_wide_work_elems(nb),
                               dtype=a.dtype, device=a.device)
            flags, epoch = _flow_sync(a.device)
            _call(getattr(lib, f"plu_getrf_inv_wide_{s}"), a.device.index,
                  a3.data_ptr(), f.data_ptr(), linv.data_ptr(),
                  uinv.data_ptr(), work.data_ptr(), flags.data_ptr(),
                  epoch, a3.shape[0], nb, float(tol), k1,
                  _stream(a.device))
        else:
            _call(getattr(lib, f"plu_getrf_inv_{s}"), a.device.index,
                  a3.data_ptr(), f.data_ptr(), linv.data_ptr(),
                  uinv.data_ptr(), a3.shape[0], nb, float(tol), k1,
                  _stream(a.device))
        _count_k1(k1)
    if single:
        return f[0], linv[0], uinv[0]
    return f, linv, uinv


# Rows a CTA of K1's cluster kernel for wide tiles holds, in both types
# (csrc/wide_lu.cuh WideRows), and the shapes that size its shared
# memory: the MMA atoms' row pads (csrc/tile_gemm.cuh Mma<T>::PAD_A,
# PAD_B), its warps and the diagonal warp's broadcast rows.
WIDE_ROWS = 32
_WIDE_PADS = {torch.float32: (4, 8), torch.float64: (4, 4)}
_WIDE_WARPS = 8
_ROW_BUF = kt.LU_PANEL + 8
# Dynamic shared memory a block may have on an H100
SMEM_PER_BLOCK = 232_448


def wide_plan(nb: int, dtype) -> dict:
    """The launch of K1's cluster kernel for a tile of 1 <= nb <= 512
    (csrc/wide_lu.cuh wide_plan, which chip_smoke.py holds it to):
    ``ctas`` a cluster (one a panel's rows), ``rows`` a CTA, ``smem``
    bytes of dynamic shared memory a CTA (W's rows of the padded tile,
    L11^-1, the rows' a_i, a 32-column stripe of R a warp, two broadcast
    rows) and ``stripe``, the columns of R a warp forms at once."""
    if not 1 <= nb <= kt.WIDE_LEAF:
        raise ValueError(f"the cluster kernel takes 1 <= nb <= "
                         f"{kt.WIDE_LEAF}, got nb={nb}")
    rows, r = WIDE_ROWS, kt.LU_PANEL
    ctas = -(-nb // rows)
    pad_a, pad_b = _WIDE_PADS[dtype]
    elems = (rows * (ctas * rows + 4) + (r + rows) * (r + pad_a)
             + _WIDE_WARPS * r * (r + pad_b) + 2 * _ROW_BUF)
    return dict(ctas=ctas, rows=rows,
                smem=elems * torch.empty((), dtype=dtype).element_size(),
                stripe=r)


# The flow kernel (csrc/wide_lu.cuh lu_flow_kernel): rows a CTA, by type
# (FlowRows), and W_T, the widest tile it takes (flow_max_nb).
FLOW_ROWS = {torch.float32: 32, torch.float64: 16}
FLOW_MAX_NB = kt.FLOW_LEAF
# SMs of an H100 SXM: the plan's tiles in flight by default
H100_SMS = kt.H100_SMS
# The flow kernel's ready flags a (device, stream) (kFlowFlags)
FLOW_FLAGS = 16384


def _flow_elems(nb: int, dtype) -> int:
    """Elements of a CTA's shared memory at a tile of nb: wide_plan's
    layout with FLOW_ROWS[dtype] rows of the tile padded to whole
    panels."""
    rows, r = FLOW_ROWS[dtype], kt.LU_PANEL
    pad_a, pad_b = _WIDE_PADS[dtype]
    np_ = -(-nb // r) * r
    return (rows * (np_ + 4) + (r + rows) * (r + pad_a)
            + _WIDE_WARPS * r * (r + pad_b) + 2 * _ROW_BUF)


def flow_plan(nb: int, dtype, sms: int = H100_SMS) -> dict:
    """The launch of the flow kernel for a tile of 1 <= nb <= W_T
    (csrc/wide_lu.cuh flow_plan, which chip_smoke.py holds it to):
    ``ctas`` a tile (ceil(nb / 32) panels of 32 / ``rows`` CTAs each),
    ``rows`` a CTA, ``smem`` bytes of dynamic shared memory a CTA (as
    :func:`wide_plan`'s) and ``sets``, the tiles in flight on ``sms``
    SMs at one CTA an SM; the path gives it no more (the recursion
    takes narrower leaves, :func:`kernels_torch.k1_leaf_width`), and
    :func:`flow_kernel` runs a larger batch in rounds of ``sets``
    tiles."""
    if not 1 <= nb <= FLOW_MAX_NB[dtype]:
        raise ValueError(f"the flow kernel takes 1 <= nb <= "
                         f"{FLOW_MAX_NB[dtype]} in {dtype}, got nb={nb}")
    rows = FLOW_ROWS[dtype]
    ctas = -(-nb // kt.LU_PANEL) * (kt.LU_PANEL // rows)
    smem = (_flow_elems(nb, dtype)
            * torch.empty((), dtype=dtype).element_size())
    return dict(ctas=ctas, rows=rows, smem=smem, sets=sms // ctas)


def k1_device_launches(nb: int, batch: int, dtype,
                       sms: int = H100_SMS) -> int:
    """K1's device launches a call on ``batch`` tiles of nb (csrc/
    wide_lu.cuh WideLu::run): one up to the leaf width
    (:func:`kernels_torch.k1_leaf_width`), above it each split's five
    launches of products and copies beside its halves'."""
    leaf = kt.k1_leaf_width(batch, dtype, sms)

    def count(m: int) -> int:
        if m <= leaf:
            return 1
        h = kt.wide_split(m)
        return count(h) + count(m - h) + 5
    return count(nb)


def flow_flags_needed(nb: int, dtype, sets: int) -> int:
    """Flags a launch of ``sets`` tiles in flight at nb takes (csrc/
    wide_lu.cuh FlowSync): per tile npan x npan stripe flags for each of
    the CTAs of a panel, npan x npan flags of R and a done flag a CTA;
    the launch refuses more than FLOW_FLAGS."""
    npan = -(-nb // kt.LU_PANEL)
    ctas = npan * (kt.LU_PANEL // FLOW_ROWS[dtype])
    return sets * (npan * (ctas + npan) + ctas)


# The flow kernel's ready flags and epoch, a pair a (device, stream):
# plu_flow_flag_slots() 32-bit flags, zeroed when made on the stream,
# and a 32-bit host counter that each launch advances by its rounds, so
# that launches on one stream take them in turn with no clearing between
# (csrc/wide_lu.cuh FlowSync).
_FLOW: dict = {}


def _flow_sync(dev):
    """(flags tensor, epoch counter) of ``dev``'s current stream."""
    key = (dev.index, _stream(dev))
    got = _FLOW.get(key)
    if got is None:
        n = library().lib.plu_flow_flag_slots()
        got = _FLOW[key] = (torch.zeros(n, dtype=torch.int32, device=dev),
                            (ctypes.c_uint32 * 1)())
    return got


def flow_kernel(a: torch.Tensor, tol: float | None = None,
                clk: torch.Tensor | None = None):
    """The flow kernel alone on ``a`` ([B, nb, nb] on the card, 1 <= nb
    <= W_T), at any nb: a measurement (the path takes it for 512 < nb
    <= W_T through :func:`getrf_with_inverses`), counted nowhere.
    ``clk``, an int64 tensor of ctas * plu_flow_clk_slots() entries,
    receives the clock64 phases of the first tile's CTAs.  Returns (f,
    L^-1, U^-1, the tiles in flight)."""
    s = _dtype_of(a)
    if a.device.type != "cuda" or a.dim() != 3:
        raise ValueError("flow_kernel takes a [B, nb, nb] CUDA tensor")
    nb = a.shape[-1]
    flow_plan(nb, a.dtype)
    if tol is None:
        tol = kt.DEFAULT_TOL[a.dtype]
    _check_tensor("a", a, a.dtype, a.shape, a.device)
    f, linv, uinv = (torch.empty_like(a) for _ in range(3))
    flags, epoch = _flow_sync(a.device)
    sets = ctypes.c_int()
    _call(getattr(library().lib, f"plu_flow_probe_{s}"), a.device.index,
          a.data_ptr(), f.data_ptr(), linv.data_ptr(), uinv.data_ptr(),
          flags.data_ptr(), epoch, a.shape[0], nb, float(tol),
          None if clk is None else clk.data_ptr(), ctypes.byref(sets),
          _stream(a.device))
    return f, linv, uinv, sets.value


# K2's second stream, one per device, for the diagonal steps that
# chain-ahead tables run ahead: a torch.cuda.Stream, so that PyTorch
# knows every stream the tiles are used on.  The C entry joins it to the
# caller's stream before it returns, so no tensor outlives work on it.
_SIDE: dict = {}


def side_stream(dev) -> torch.cuda.Stream:
    """K2's second stream on ``dev``, made at first use."""
    s = _SIDE.get(dev.index)
    if s is None:
        s = _SIDE[dev.index] = torch.cuda.Stream(dev)
    return s


def _ahead_tables(tables: KernelTables, bl: int):
    """The host ``flag_tab`` and ``lev_tab`` of chain-ahead tables,
    checked once per tables (``schedule.check_ahead``; the first level
    unflagged; ``lev_tab`` a permutation of the levels), or (None,
    None)."""
    h = tables.host
    if "flag_tab" not in h:
        return None, None
    if "ahead" not in tables.views:
        flag, lev = _host_i32(h["flag_tab"]), _host_i32(h["lev_tab"])
        if (flag.shape != (bl,) or lev.shape != (bl,)
                or not np.isin(flag, (0, 1)).all()
                or (bl and flag[0])
                or not np.array_equal(np.sort(lev), np.arange(bl))):
            raise ValueError("flag_tab/lev_tab are not chain-ahead tables "
                             f"of {bl} levels")
        check_ahead(h)
        tables.views["ahead"] = (flag, lev)
    return tables.views["ahead"]


def mega_factorize(tiles: torch.Tensor, tables: KernelTables, *, nb: int,
                   tol: float, bl: int, ahead: bool = True):
    """K2: the whole factorization, ``tiles`` updated IN PLACE; returns
    ``(tiles, invs[bl, 2, nb, nb])``.  See
    :func:`kernels_torch.mega_factorize`.  With chain-ahead tables
    (``flag_tab``, ``lev_tab``) the diagonal step of each flagged level
    runs on K2's second stream (:func:`side_stream`) beside the level
    before it, counted in :data:`AHEAD`; ``ahead=False`` runs the same
    tables on the current stream alone, the same arithmetic and so the
    same bits."""
    if not _on_cuda(tiles):
        return kt.mega_factorize(tiles, tables, nb=nb, tol=tol, bl=bl)
    s = _dtype_of(tiles)
    check_nb(nb)
    dev = tiles.device
    nt = tiles.shape[0] - 1
    _check_tensor("tiles", tiles, tiles.dtype, (nt + 1, nb, nb), dev)
    h = tables.host
    if len(h["diag_tab"]) != bl:
        raise ValueError(f"tables hold {len(h['diag_tab'])} levels, "
                         f"expected bl={bl}")
    lw, uw = h["lid_tab"].shape[1], h["uid_tab"].shape[1]
    _, nchunks, row_w = h["udst_tab"].shape
    uch = int(h["uch"])
    if uch > row_w:
        raise ValueError(f"uch={uch} exceeds the update row width {row_w}")
    nl, nu, nup = (_host_i32(h[k]) for k in ("nl_tab", "nu_tab", "nup_tab"))
    if (nl.max(initial=0) > lw or nu.max(initial=0) > uw
            or nup.max(initial=0) > nchunks * uch):
        raise ValueError("a level count exceeds its table width")
    _check_table("diag_tab", h["diag_tab"], 0, nt - 1)
    for k in ("lid_tab", "uid_tab", "udst_tab"):
        _check_table(k, h[k], 0, nt)
    _check_table("udl_tab", h["udl_tab"], 0, lw - 1)
    _check_table("udu_tab", h["udu_tab"], 0, uw - 1)
    flag, lev = _ahead_tables(tables, bl)
    side = (side_stream(dev).cuda_stream
            if ahead and flag is not None and flag.any() else None)
    tabs = _dev_tables(tables, ("diag_tab", "lid_tab", "uid_tab",
                                "udst_tab", "udl_tab", "udu_tab"), dev)
    invs = torch.empty((bl, 2, nb, nb), dtype=tiles.dtype, device=dev)
    lib = library().lib
    counts = (ctypes.c_int * 3)()
    _call(getattr(lib, f"plu_mega_factorize_{s}"), dev.index,
          tiles.data_ptr(), invs.data_ptr(), *(t.data_ptr() for t in tabs),
          _ptr(nl), _ptr(nu), _ptr(nup),
          None if flag is None else _ptr(flag),
          None if lev is None else _ptr(lev), bl, lw, uw, nchunks, row_w,
          uch, nb, float(tol), counts, _stream(dev), side)
    _count_k1(counts)
    AHEAD["mega_factorize"] += counts[2]
    LAUNCHES["mega_factorize"] += 1
    return tiles, invs


# K5's grid barrier counters above nb = 128 (csrc/solve_clusters.cuh
# grid_barrier), a pair a (device, stream): zeroed when made, on the
# stream, and left at 0 arrivals by every launch, so that launches on one
# stream take them in turn and two streams share nothing.
_BARRIER: dict = {}


def _barrier(dev) -> torch.Tensor:
    key = (dev.index, _stream(dev))
    bar = _BARRIER.get(key)
    if bar is None:
        bar = _BARRIER[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return bar


def _grid(grid) -> dict:
    """GRID's entry from a C entry's grid array."""
    return dict(forward=grid[0], backward=grid[1], cluster=grid[3],
                **{"clusters_fit" if grid[3] > 1 else "blocks_per_sm":
                   grid[2]})


def mega_solve(x: torch.Tensor, tiles: torch.Tensor, invs: torch.Tensor,
               tables: KernelTables, *, nb: int, bl: int) -> torch.Tensor:
    """K3: solve LU x = b for ``x`` [nrhs, bl+1, nb]; returns a new
    tensor.  Two launches, one per sweep, counted as one launch of K3:
    up to nb = 128 cooperative ones, above on thread block clusters; the
    grid of the last call is in ``GRID["mega_solve"]``.  See
    :func:`kernels_torch.mega_solve`."""
    if not _on_cuda(x):
        return kt.mega_solve(x, tiles, invs, tables, nb=nb, bl=bl)
    s = _dtype_of(x)
    check_nb(nb)
    dev = x.device
    nrhs = x.shape[0]
    nt = tiles.shape[0] - 1
    _check_tensor("x", x, x.dtype, (nrhs, bl + 1, nb), dev)
    _check_tensor("tiles", tiles, x.dtype, (nt + 1, nb, nb), dev)
    _check_tensor("invs", invs, x.dtype, (bl, 2, nb, nb), dev)
    h = tables.host
    w = h["lid_tab"].shape[1]
    nl, nuc = _host_i32(h["nl_tab"]), _host_i32(h["nuc_tab"])
    if (len(nl) != bl or len(nuc) != bl or min(nl.min(initial=0),
                                              nuc.min(initial=0)) < 0
            or nl.max(initial=0) > w or nuc.max(initial=0) > w):
        raise ValueError("solve tables do not match bl or their width")
    for k in ("lid_tab", "ucid_tab"):
        _check_table(k, h[k], 0, nt)
    for k in ("lrow_tab", "ucrow_tab"):
        _check_table(k, h[k], 0, bl)
    tabs = _dev_tables(tables, ("lid_tab", "lrow_tab", "ucid_tab",
                                "ucrow_tab", "nl_tab", "nuc_tab"), dev)
    out = x.clone()
    if nrhs:
        lib = library().lib
        fwd = torch.empty_like(out)   # the forward sweep's result
        grid = (ctypes.c_int * 4)()
        _call(getattr(lib, f"plu_mega_solve_{s}"), dev.index,
              out.data_ptr(), fwd.data_ptr(), nrhs, tiles.data_ptr(),
              invs.data_ptr(), *(t.data_ptr() for t in tabs), _ptr(nl),
              _ptr(nuc), bl, w, nb, grid, _stream(dev))
        GRID["mega_solve"] = _grid(grid)
        LAUNCHES["mega_solve"] += 1
    return out


def grid_sync_probe(device, blocks: int, iters: int) -> int:
    """Launch ``iters`` grid barriers on at most ``blocks`` cooperative
    blocks of K3's size, on the current stream; returns the number of
    blocks launched.  It measures the barrier K3 takes once a level and
    runs on no path of the solver."""
    device = torch.device(device)
    got = ctypes.c_int(0)
    _call(library().lib.plu_grid_sync_probe, device.index, blocks, iters,
          ctypes.byref(got), _stream(device))
    return got.value


def _view(tables: KernelTables, name: str, derive, device,
          ship=("key", "ptr", "ent")) -> tuple:
    """(host arrays, device tensors of the ``ship`` keys) of a view
    derived from the tables once and cached on them."""
    if name not in tables.views:
        host = derive(tables.host)
        tables.views[name] = (host, {
            k: torch.as_tensor(v, device=device) for k, v in host.items()
            if k in ship})
    return tables.views[name]


def _check_group_offsets(name, off, gs, width):
    """Each group's panel offsets rise from 0 to at most ``width``."""
    rows = np.arange(len(gs))
    if (off[:, 0] != 0).any() or (np.diff(off, axis=1) < 0).any() \
            or (off[rows, gs] > width).any():
        raise ValueError(f"{name}: offsets must rise from 0 to at most "
                         f"the panel width {width}")


def mega_factorize_groups(tiles: torch.Tensor, tables: KernelTables, *,
                          nb: int, tol: float, bl: int):
    """K4: the whole factorization over super-level groups, ``tiles``
    updated IN PLACE; returns ``(tiles, invs[bl, 2, nb, nb])`` with
    ``invs`` indexed by level.  See
    :func:`kernels_torch.mega_factorize_groups`."""
    if not _on_cuda(tiles):
        return kt.mega_factorize_groups(tiles, tables, nb=nb, tol=tol,
                                        bl=bl)
    s = _dtype_of(tiles)
    check_nb(nb)
    dev = tiles.device
    nt = tiles.shape[0] - 1
    _check_tensor("tiles", tiles, tiles.dtype, (nt + 1, nb, nb), dev)
    h = tables.host
    ng = int(h["ngroups"])
    gw = h["gdiag_tab"].shape[1]
    lw, uw = h["lid_tab"].shape[1], h["uid_tab"].shape[1]
    _, nchunks, row_w = h["udst_tab"].shape
    uch = int(h["uch"])
    if uch > row_w:
        raise ValueError(f"uch={uch} exceeds the update row width {row_w}")
    gs, nup = _host_i32(h["gs_tab"]), _host_i32(h["nup_tab"])
    if len(gs) != ng or gs.min(initial=1) < 1 or gs.max(initial=1) > gw:
        raise ValueError(f"gs_tab must hold {ng} group sizes in [1, {gw}]")
    if nup.max(initial=0) > nchunks * uch:
        raise ValueError("a group's update count exceeds its table width")
    gloff, guoff = _host_i32(h["gloff_tab"]), _host_i32(h["guoff_tab"])
    _check_group_offsets("gloff_tab", gloff, gs, lw)
    _check_group_offsets("guoff_tab", guoff, gs, uw)
    glev = _host_i32(h["glev_tab"])
    levels = np.concatenate([glev[g, :gs[g]] for g in range(ng)])
    if not np.array_equal(np.sort(levels), np.arange(bl)):
        raise ValueError(f"glev_tab must hold each of the {bl} levels "
                         "once (every inverse slot is written)")
    _check_table("gdiag_tab", h["gdiag_tab"], 0, nt)
    for k in ("lid_tab", "uid_tab", "udst_tab"):
        _check_table(k, h[k], 0, nt)
    # the decoded indices; the other bits are the TPU's slot bookkeeping
    _check_table("udl_tab & 0xFFFFF", h["udl_tab"] & 0xFFFFF, 0, lw - 1)
    _check_table("udu_tab & 0xFFF", h["udu_tab"] & 0xFFF, 0, uw - 1)
    csr, csr_dev = _view(tables, "dst_csr", group_dst_csr, dev)
    tabs = _dev_tables(tables, ("gdiag_tab", "glev_tab", "gloff_tab",
                                "guoff_tab", "lid_tab", "uid_tab",
                                "udl_tab", "udu_tab"), dev)
    rows = np.arange(ng)
    npl, npu = _host_i32(gloff[rows, gs]), _host_i32(guoff[rows, gs])
    invs = torch.empty((bl, 2, nb, nb), dtype=tiles.dtype, device=dev)
    lib = library().lib
    k1 = (ctypes.c_int * 2)()
    _call(getattr(lib, f"plu_mega_factorize_groups_{s}"), dev.index,
          tiles.data_ptr(), invs.data_ptr(), *(t.data_ptr() for t in tabs),
          *(csr_dev[k].data_ptr() for k in ("key", "ptr", "ent")),
          _ptr(gs), _ptr(npl), _ptr(npu), _ptr(csr["cnt"]),
          _ptr(csr["off"]), ng, gw, lw, uw, nchunks, row_w, uch, nb,
          float(tol), k1, _stream(dev))
    _count_k1(k1)
    LAUNCHES["mega_factorize_groups"] += 1
    return tiles, invs


_STEP_KEYS = ("step", "item", "ent")


def _group_solve_steps(h: dict, bl: int, nt: int) -> dict:
    """Both sweeps' step tables of :func:`schedule.group_solve_steps`
    (keys ``l_step``, ``uc_item``, ...), after the checks that keep K5
    inside x and the tile store and its steps free of races."""
    ng = int(h["ngroups"])
    kseg = _host_i32(h["kseg_tab"])
    gw, w = kseg.shape[1], h["ltab"].shape[-1]
    nmem = _host_i32((kseg != bl).sum(axis=1))
    real = np.arange(gw)[None, :] < nmem[:, None]
    if (len(kseg) != ng or nmem.min(initial=1) < 1
            or (kseg[real] > bl - 1).any() or (kseg[real] < 0).any()
            or (kseg[~real] != bl).any()):
        raise ValueError("kseg_tab must hold each group's levels first, "
                         f"then the pad {bl}")
    if not np.array_equal(np.sort(kseg[real]), np.arange(bl)):
        raise ValueError(f"kseg_tab must hold each of the {bl} levels once "
                         "(every segment of the result is written)")
    out = {}
    for tab, cnt, sweep in (("ltab", "nl_tab", "l"), ("uctab", "nuc_tab",
                                                      "uc")):
        n = _host_i32(h[cnt])
        if len(n) != ng or n.max(initial=0) > w:
            raise ValueError(f"{cnt} does not match the groups or {tab}'s "
                             "width")
        _check_table(f"{tab}[:, 0]", h[tab][:, 0], 0, nt)
        _check_table(f"{tab}[:, 1]", h[tab][:, 1], 0, bl)
        used = np.arange(w)[None, :] < n[:, None]
        if ((h[tab][:, 2] < 0) | (h[tab][:, 2] >= nmem[:, None]))[used].any():
            raise ValueError(f"{tab}: a panel tile names no real member")
        # a member updated by its own group would race with its inverse
        if any(np.isin(h[tab][g, 1, :n[g]], kseg[g, :nmem[g]]).any()
               for g in range(ng)):
            raise ValueError(f"{tab}: a group's panel row is one of its "
                             "own members")
        for k, v in group_solve_steps(h, sweep, bl).items():
            out[f"{sweep}_{k}"] = v
    return out


def solve_steps_view(tables: KernelTables, bl: int, nt: int,
                     device) -> tuple:
    """K5's step tables of a table set, checked and shipped once and
    cached on it."""
    return _view(tables, f"solve_steps_{bl}_{nt}",
                 lambda h: _group_solve_steps(h, bl, nt), device,
                 [f"{sw}_{k}" for sw in ("l", "uc") for k in _STEP_KEYS])


def mega_solve_groups(x: torch.Tensor, tiles: torch.Tensor,
                      invs: torch.Tensor, tables: KernelTables, *,
                      nb: int, bl: int) -> torch.Tensor:
    """K5: solve LU x = b over super-level groups for ``x``
    [nrhs, bl+1, nb]; returns a new tensor.  Two launches, one per
    sweep, counted as one launch of K5: up to nb = 128 cooperative ones,
    above on thread block clusters with a grid barrier between steps,
    whose counters are the stream's own (two calls on two streams share
    nothing); the grid of the last call is in
    ``GRID["mega_solve_groups"]``.  See
    :func:`kernels_torch.mega_solve_groups`."""
    if not _on_cuda(x):
        return kt.mega_solve_groups(x, tiles, invs, tables, nb=nb, bl=bl)
    s = _dtype_of(x)
    check_nb(nb)
    dev = x.device
    nrhs = x.shape[0]
    nt = tiles.shape[0] - 1
    _check_tensor("x", x, x.dtype, (nrhs, bl + 1, nb), dev)
    _check_tensor("tiles", tiles, x.dtype, (nt + 1, nb, nb), dev)
    _check_tensor("invs", invs, x.dtype, (bl, 2, nb, nb), dev)
    host, steps = solve_steps_view(tables, bl, nt, dev)
    out = x.clone()
    if nrhs:
        lib = library().lib
        fwd = torch.empty_like(out)   # the forward sweep's result
        grid = (ctypes.c_int * 4)()
        _call(getattr(lib, f"plu_mega_solve_groups_{s}"), dev.index,
              out.data_ptr(), fwd.data_ptr(), nrhs, tiles.data_ptr(),
              invs.data_ptr(),
              *(steps[f"{sw}_{k}"].data_ptr() for sw in ("l", "uc")
                for k in _STEP_KEYS),
              *(v for sw in ("l", "uc")
                for v in (len(host[f"{sw}_step"]) - 1, host[f"{sw}_width"])),
              bl, nb, _barrier(dev).data_ptr(), grid, _stream(dev))
        GRID["mega_solve_groups"] = _grid(grid)
        LAUNCHES["mega_solve_groups"] += 1
    return out


# ------------------------------------------------ the compressed store

_IDX_BYTES = {torch.uint16: 2, torch.uint32: 4}
# P6's instances by the bytes of a slot's value (csrc/compressed.cuh
# SlotWord: it moves values and computes nothing): the value types of
# the store and the C entry of each.
_SLOT_WORDS = {torch.float32: 4, torch.float64: 8, torch.complex64: 8,
               torch.complex128: 16}

# P6's launch geometry (csrc/compressed.cuh): threads a block; slots a
# thread takes in one pass of a kernel's loop (kSlotPass), as groups of
# SLOT_GROUP[w] slots, the one 16-byte vector of values of w-byte words
# (SlotWord<w>::kGroup), lane after lane; the largest tile a decompress
# block reads whole (larger ones it searches); the shared memory a
# decompress block should use for its rows and the most it may
# (kSlotChunkBytes: at least one row of the tile must fit); the blocks
# an SM a decompress and a compress grid should hold where the batch
# allows (chosen by probe_p6.py --sweep on an H100: fewer, larger blocks
# for decompress, whose rows each block writes from shared memory; on
# 8- and 16-byte words no other compress grid was faster by more than
# the runs' spread, so every width takes the same); the largest slot
# span of a compress block in passes of a block (SLOT_PASS *
# SLOT_THREADS slots); and the largest second grid dimension.
SLOT_THREADS = 256
SLOT_PASS = 4
SLOT_GROUP = {4: 4, 8: 2, 16: 1}
SLOT_DIRECT = 2 * SLOT_PASS * SLOT_THREADS
SLOT_CHUNK_BYTES = 32768
SLOT_CHUNK_LIMIT = 48 * 1024
SLOT_DECOMPRESS_PER_SM = 4
SLOT_COMPRESS_PER_SM = 6
SLOT_SPAN_UNITS = 16
SLOT_GRID_Y = 65535
# pairs of neighbouring slots the order check holds at once
_ORDER_CHUNK = 1 << 20


@dataclasses.dataclass(frozen=True)
class StageGeometry:
    """P6's grid for one batch: decompress takes (batch, chunks) blocks
    of ``rows`` rows of a tile, compress (batch, spans) blocks of
    ``span`` slots of a tile.  Both kernels walk further chunks or spans
    grid-stride, so any grid is right; this one only sets the speed."""

    rows: int
    chunks: int
    span: int
    spans: int


def stage_geometry(nb: int, elem_bytes: int, caps, sms: int
                   ) -> StageGeometry:
    """P6's grid for a batch of tiles with slot counts ``caps`` (the
    scratch tile's 0 included) at tile width ``nb``, values of
    ``elem_bytes`` bytes, on a card of ``sms`` SMs: rows and slot spans
    as few as keep the grid near SLOT_DECOMPRESS_PER_SM and
    SLOT_COMPRESS_PER_SM blocks an SM, so a small batch spreads each
    tile over many blocks and a large one gives each block more work.
    A batch whose tiles decompress reads whole (at most SLOT_DIRECT
    slots) gets half the decompress blocks: each of a tile's blocks
    reads all its slots.  A decompress block's rows fit
    SLOT_CHUNK_BYTES (one row at least, which must fit the kernel's
    SLOT_CHUNK_LIMIT: else this raises), chunks of one tile are as even
    as may be.  A span is a whole number of a block's passes
    (SLOT_PASS * SLOT_THREADS slots at every width: a thread takes
    SLOT_PASS slots a pass, in groups of SLOT_GROUP[elem_bytes]), at
    most SLOT_SPAN_UNITS of them."""
    if nb * elem_bytes > SLOT_CHUNK_LIMIT:
        raise ValueError(
            f"P6 decompresses a tile in blocks of whole rows held in "
            f"shared memory, at most {SLOT_CHUNK_LIMIT} bytes "
            f"(kSlotChunkBytes); a row of nb={nb} values of {elem_bytes} "
            f"bytes is {nb * elem_bytes} (nb <= "
            f"{SLOT_CHUNK_LIMIT // elem_bytes} at this value size)")
    caps = np.asarray(caps, dtype=np.int64)
    batch = len(caps)
    target = SLOT_DECOMPRESS_PER_SM * sms
    if caps.max(initial=0) <= SLOT_DIRECT:
        target = max(1, target // 2)
    rows = max(1, min(nb, SLOT_CHUNK_BYTES // (nb * elem_bytes),
                      -(-nb * batch // target)))
    chunks = -(-nb // rows)
    rows = -(-nb // chunks)
    unit = SLOT_PASS * SLOT_THREADS
    span = unit * max(1, min(SLOT_SPAN_UNITS, -(-int(caps.sum()) // (
        unit * SLOT_COMPRESS_PER_SM * sms))))
    spans = min(max(1, -(-int(caps.max(initial=0)) // span)), SLOT_GRID_Y)
    return StageGeometry(rows=rows, chunks=chunks, span=span, spans=spans)


def check_slot_order(idx: torch.Tensor, off: Indices, cap: Indices,
                     nb: int) -> None:
    """Raise ValueError naming the first tile whose slot positions do not
    ascend strictly: decompress finds a block's slots by searching them.
    A sentinel position (>= nb^2) may only follow the tile's real ones.
    The neighbouring pairs are compared where ``idx`` lies, _ORDER_CHUNK
    at a time, with one read back at the end."""
    nn = nb * nb
    o = off.host[:-1].astype(np.int64)
    pairs = np.maximum(cap.host[:-1].astype(np.int64) - 1, 0)
    first = np.cumsum(pairs) - pairs        # each tile's first pair
    total = int(pairs.sum())
    cuts = np.unique(np.r_[0, np.searchsorted(
        first, np.arange(_ORDER_CHUNK, total, _ORDER_CHUNK), "right") - 1,
        len(o)])
    dev = idx.device
    found = []
    for t0, t1 in zip(cuts[:-1], cuts[1:]):
        n = int(pairs[t0:t1].sum())
        if n == 0:
            continue
        base = torch.as_tensor(o[t0:t1] - (first[t0:t1] - first[t0]),
                               device=dev)
        s = torch.repeat_interleave(
            base, torch.as_tensor(pairs[t0:t1], device=dev),
            output_size=n) + torch.arange(n, device=dev)
        p, q = kt.slot_positions(idx, s), kt.slot_positions(idx, s + 1)
        bad = ~((q > p) & (p < nn) | (p >= nn) & (q >= nn))
        found.append((t0, t1, bad.any(), bad.int().argmax()))
    if not found:
        return
    flags = torch.stack([f[2] for f in found]).cpu().numpy()
    if not flags.any():
        return
    t0, t1, _, k = found[int(flags.argmax())]
    tile = t0 + int(np.searchsorted(first[t0:t1] - first[t0], int(k),
                                    "right")) - 1
    raise ValueError(f"tile {tile}: its slot positions do not ascend "
                     "strictly (the compressed store keeps each tile's "
                     "positions in ascending order)")


def _check_word_alignment(name: str, t: torch.Tensor) -> None:
    """P6 reads and writes a tensor's words whole, at their own alignment
    (16 bytes for complex128): a view into foreign memory off it is
    refused."""
    need = t.element_size()
    if t.data_ptr() % need:
        raise ValueError(f"{name} starts {t.data_ptr() % need} bytes off "
                         f"the {need}-byte boundary P6 moves its "
                         f"{t.dtype} words at")


def _check_slots(values, idx, off: Indices, cap: Indices, nb: int):
    """The store's arrays, and (once a store) its host tables and slot
    order: every tile's slot range inside ``values``, the scratch tile
    empty, the slot offsets within int32, each tile's positions
    ascending (:func:`check_slot_order`).  Returns the number of tiles
    nt."""
    dev = values.device
    if values.dim() != 1 or not values.is_contiguous():
        raise ValueError("values must be a contiguous 1-D tensor")
    if values.dtype not in _SLOT_WORDS:
        raise TypeError(f"P6 takes float32, float64, complex64 or "
                        f"complex128 values, got {values.dtype}")
    check_store_nb(nb)
    if idx.dtype not in _IDX_BYTES:
        raise TypeError(f"slot positions are uint16 or uint32, got "
                        f"{idx.dtype}")
    if idx.dtype == torch.uint16 and nb * nb > 0xFFFF:
        raise ValueError(f"uint16 slot positions hold nb <= 255 (sentinel "
                         f"nb*nb), got nb={nb}")
    _check_tensor("idx", idx, idx.dtype, values.shape, dev)
    _check_word_alignment("values", values)
    _check_word_alignment("idx", idx)
    nt = len(off) - 1
    for name, ix in (("off", off), ("cap", cap)):
        _check_tensor(name, ix.dev, torch.int32, (nt + 1,), dev)
    key = ("store", values.numel(), id(cap), id(idx), nb)
    if key not in off.checked:
        o, c = off.host.astype(np.int64), cap.host.astype(np.int64)
        if len(c) != nt + 1 or c[nt] != 0 or (c < 0).any() or (o < 0).any() \
                or (o + c > values.numel()).any() \
                or values.numel() >= 2 ** 31:
            raise ValueError("off/cap name slot ranges outside values, or "
                             "the scratch tile has slots")
        check_slot_order(idx, off, cap, nb)
        off.checked.add(key)
    return nt


def _check_ids(ids: Indices, nt: int, device) -> None:
    """The batch's tile ids: in [0, nt] (nt the scratch tile), the real
    ones distinct (compress would write a slot twice)."""
    _check_tensor("ids", ids.dev, torch.int32, (len(ids),), device)
    key = ("ids", nt)
    if key not in ids.checked:
        _check_table("ids", ids.host, 0, nt)
        real = ids.host[ids.host != nt]
        if len(np.unique(real)) != len(real):
            raise ValueError("a batch's real tile ids repeat")
        ids.checked.add(key)


_SMS: dict = {}


def _sm_count(device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _stage_slots(to_dense, values, idx, off, cap, ids, nb, dense):
    dev = values.device
    key = (id(cap), nb, values.element_size())
    geo = ids.geometry.get(key)
    if geo is None:
        geo = ids.geometry[key] = stage_geometry(
            nb, values.element_size(), cap.host[ids.host], _sm_count(dev))
    lib = library().lib
    _call(getattr(lib, f"plu_stage_slots_{_SLOT_WORDS[values.dtype]}"),
          dev.index,
          int(to_dense), values.data_ptr(), idx.data_ptr(),
          _IDX_BYTES[idx.dtype], off.dev.data_ptr(), cap.dev.data_ptr(),
          ids.dev.data_ptr(), len(ids), nb, geo.rows, geo.chunks, geo.span,
          geo.spans, dense.data_ptr(), _stream(dev))


def decompress_tiles(values: torch.Tensor, idx: torch.Tensor, off: Indices,
                     cap: Indices, ids: Indices, nb: int) -> torch.Tensor:
    """P6: the dense [B, nb, nb] tiles ``ids`` of the compressed store
    (real or complex values, any nb up to STORE_MAX_NB whose rows fit
    :func:`stage_geometry`); see :func:`kernels_torch.decompress_tiles`."""
    if not _on_cuda(values):
        return kt.decompress_tiles(values, idx, off, cap, ids, nb)
    nt = _check_slots(values, idx, off, cap, nb)
    _check_ids(ids, nt, values.device)
    dense = torch.empty((len(ids), nb, nb), dtype=values.dtype,
                        device=values.device)
    if len(ids):
        _stage_slots(True, values, idx, off, cap, ids, nb, dense)
        LAUNCHES["decompress_tiles"] += 1
    return dense


def compress_tiles(values: torch.Tensor, idx: torch.Tensor, off: Indices,
                   cap: Indices, ids: Indices, dense: torch.Tensor) -> None:
    """P6, the compress direction: the slots of tiles ``ids`` from the
    dense tiles ``dense`` [B, nb, nb], ``values`` updated IN PLACE; see
    :func:`kernels_torch.compress_tiles`."""
    if not _on_cuda(values):
        return kt.compress_tiles(values, idx, off, cap, ids, dense)
    nb = dense.shape[-1]
    nt = _check_slots(values, idx, off, cap, nb)
    _check_ids(ids, nt, values.device)
    _check_tensor("dense", dense, values.dtype, (len(ids), nb, nb),
                  values.device)
    _check_word_alignment("dense", dense)
    if len(ids):
        _stage_slots(False, values, idx, off, cap, ids, nb, dense)
        LAUNCHES["compress_tiles"] += 1
    return None


def newton_inverses(f: torch.Tensor, tol: float | None = None):
    """P2: (L^-1, U^-1) of a batch [B, nb, nb] of factored diagonal tiles,
    the counterpart of the JAX package's batched Newton–Schulz inverses
    (``tools/exp_batched_scan.py`` batched_newton, the reload path of
    ``pangulu_tpu/compressed.py``) for float32 and float64 tiles of any
    nb up to STORE_MAX_NB.  It computes the same function by Gauss–Jordan
    sweeps, as :func:`kernels_torch.triangle_inverses` does (the plain
    version a CPU tensor goes to): one launch of the sweeps, a block per
    tile, triangle and 128-wide diagonal block, then above nb = 128 one
    launch of the products a level of its tree
    (:func:`kernels_torch.triangle_split`), counted as one launch; no
    workspace.  Complex tiles are not P2's: the compressed store inverts
    them with :func:`kernels_torch.unit_lower_inv_newton` and
    :func:`kernels_torch.upper_inv_newton`, as the JAX package does in
    XLA."""
    if not _on_cuda(f):
        return kt.triangle_inverses(f, tol)
    s = _dtype_of(f)
    if tol is None:
        tol = kt.DEFAULT_TOL[f.dtype]
    if f.dim() != 3 or f.shape[-1] != f.shape[-2]:
        raise ValueError(f"expected [B, nb, nb], got {tuple(f.shape)}")
    batch, nb = f.shape[0], f.shape[-1]
    check_store_nb(nb)
    _check_tensor("f", f, f.dtype, f.shape, f.device)
    linv, uinv = torch.empty_like(f), torch.empty_like(f)
    if batch:
        _call(getattr(library().lib, f"plu_triangle_inverses_{s}"),
              f.device.index, f.data_ptr(), linv.data_ptr(),
              uinv.data_ptr(), batch, nb, float(tol), _stream(f.device))
        LAUNCHES["newton_inverses"] += 1
    return linv, uinv


# ------------------------------------------------ the TPU probes P3-P5

# P4's and P5's kernels hold a 128 x 128 register tile a chain, P3's
# kernel a member padded to 128 x 128 (csrc/probes.cuh).
PROBE_MAX_NB = 128
# The thread block clusters of P4's products and P3's members
# (csrc/probes.cuh ClusterBlocks): C CTAs hold a 128 x 128 matrix in
# 4 x (C / 4) blocks.  The defaults: P4's products on 16, P3's members
# on 4 (PERF.md).  The card refuses P4's float64 products on 4.
CLUSTER_SIZES = (4, 8, 16)
SCAN_CLUSTER = 16
NEWTON_CLUSTER = 4
# the largest grid.y of a launch (P5's and P4's copies, P3's members)
MAX_GRID_Y = 65535
_OVERLAP_MODE = {m: i for i, m in enumerate(kt.OVERLAP_MODES)}
# P4's and P5's product types (csrc/probes.cuh ProbeProducts): "f64",
# DMMA on float64 copies, true f32 on the probes' chains; "tf32x3", the
# solver's float products, which drift on them (timed only)
PROBE_PRODUCTS = {"f64": 0, "tf32x3": 1}


def _probe_nb(a, b, steps) -> int:
    """Check P4's and P5's inputs on the card; returns nb."""
    kt.check_probe_inputs(a, b, steps)
    if a.dtype != torch.float32:
        raise TypeError(f"the probe kernels take float32, got {a.dtype}")
    nb = a.shape[-1]
    if not 1 <= nb <= PROBE_MAX_NB:
        raise ValueError(f"the probe kernels take 1 <= nb <= "
                         f"{PROBE_MAX_NB}, got nb={nb}")
    for name, t in (("a", a), ("b", b)):
        _check_tensor(name, t, torch.float32, a.shape, a.device)
    return nb


def _check_probe_options(copies: int, products: str, with_dot: bool):
    """Check copies and products; returns the products' code."""
    if copies < 1:
        raise ValueError(f"copies must be >= 1, got {copies}")
    if products not in PROBE_PRODUCTS:
        raise ValueError(f"products must be one of "
                         f"{tuple(PROBE_PRODUCTS)}, got {products!r}")
    if products != "f64" and not with_dot:
        raise ValueError("products other than 'f64' need the products "
                         "(mode scan, or with_dot=False, has none)")
    return PROBE_PRODUCTS[products]


def _copies_of(r: torch.Tensor, copies: int) -> torch.Tensor:
    return r if copies == 1 else r.expand(copies, *r.shape).clone()


def scan_overlap(a: torch.Tensor, b: torch.Tensor, mode: str, steps: int,
                 copies: int = 1, products: str = "f64") -> torch.Tensor:
    """P5: :func:`kernels_torch.scan_overlap` of ``a``, ``b`` [nb, nb]
    float32, nb <= 128; with ``copies`` > 1, that many identical copies
    [copies, nb, nb] in one launch.  acc's 8-column strips over CTAs,
    ceil(nb / 8) a copy, each holding all of ``a``; the scan on CTA 0
    beside strip 0's products.  Mode "split" runs "both" with the
    scan and the products on separate warps.  The products run in
    float64 and are rounded to float32 once, or with
    ``products="tf32x3"`` as the solver's float products (less accurate
    than float32 on this chain: for timing)."""
    if mode not in _OVERLAP_MODE:
        raise ValueError(f"mode must be one of {kt.OVERLAP_MODES}, got "
                         f"{mode!r}")
    code = _check_probe_options(copies, products, mode != "scan")
    if not _on_cuda(a):
        return _copies_of(kt.scan_overlap(a, b, mode, steps), copies)
    nb = _probe_nb(a, b, steps)
    if copies > MAX_GRID_Y:
        raise ValueError(f"copies must be <= {MAX_GRID_Y}, got {copies}")
    dev = a.device
    out = torch.empty((copies, nb, nb), dtype=a.dtype, device=dev)
    part = done = None
    if mode in ("both", "split"):
        # acc rounded to float32, and a completion counter, a copy; the
        # counters are the call's own, so that launches on two streams
        # share nothing
        part = torch.empty((copies, nb, nb), dtype=a.dtype, device=dev)
        done = torch.zeros(copies, dtype=torch.int32, device=dev)
    _call(library().lib.plu_scan_overlap_f32, dev.index,
          _OVERLAP_MODE[mode], code, a.data_ptr(), b.data_ptr(),
          out.data_ptr(), None if part is None else part.data_ptr(),
          None if done is None else done.data_ptr(), copies, nb, steps,
          _stream(dev))
    LAUNCHES["scan_overlap"] += 1
    return out[0] if copies == 1 else out


def _check_cluster(cluster: int) -> int:
    """Check a cluster size of P4's or P3's kernel; returns it."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"the cluster size must be one of "
                         f"{CLUSTER_SIZES}, got {cluster}")
    return cluster


def scan_multi(a: torch.Tensor, b: torch.Tensor, q: int, with_dot: bool,
               steps: int, copies: int = 1, products: str = "f64",
               cluster: int = SCAN_CLUSTER) -> torch.Tensor:
    """P4: :func:`kernels_torch.scan_multi` of ``a``, ``b`` [nb, nb]
    float32, nb <= 128, q in (1, 2, 4, 8); copies and products as for
    :func:`scan_overlap`.  One launch: each chain on a CTA of its own (in
    registers), the chain of products on a thread block cluster of
    ``cluster`` CTAs (acc in their shared memory), the parts summed in
    the plain version's order by the CTA that finishes last."""
    if q not in kt.SCAN_CHAINS:
        raise ValueError(f"q must be one of {kt.SCAN_CHAINS}, got {q}")
    code = _check_probe_options(copies, products, with_dot)
    _check_cluster(cluster)
    if not _on_cuda(a):
        return _copies_of(kt.scan_multi(a, b, q, with_dot, steps), copies)
    nb = _probe_nb(a, b, steps)
    dev = a.device
    if copies > MAX_GRID_Y:
        raise ValueError(f"copies must be <= {MAX_GRID_Y}, got {copies}")
    out = torch.empty((copies, nb, nb), dtype=a.dtype, device=dev)
    # the chains, then acc rounded to float32, a copy
    work = torch.empty((copies, q + 1, nb, nb), dtype=a.dtype, device=dev)
    _call(library().lib.plu_scan_multi_f32, dev.index, q, int(with_dot),
          code, cluster, a.data_ptr(), b.data_ptr(), out.data_ptr(),
          work.data_ptr(), _done_counters(dev, copies).data_ptr(), copies,
          nb, steps, _stream(dev))
    LAUNCHES["scan_multi"] += 1
    return out[0] if copies == 1 else out


# P4's completion counters by device, one a copy: zeroed when made, and
# left at 0 by every launch (the CTA that finishes a copy last resets
# its counter), so a call allocates and clears nothing.  Launches on one
# stream take them in turn.
_DONE: dict = {}


def _done_counters(dev, copies: int) -> torch.Tensor:
    done = _DONE.get(dev)
    if done is None or done.numel() < copies:
        done = torch.zeros(max(copies, 64), dtype=torch.int32, device=dev)
        _DONE[dev] = done
    return done


def newton_loop(lm: torch.Tensor, steps: int, blocks: int = NEWTON_CLUSTER):
    """P3: :func:`kernels_torch.newton_loop` of ``lm`` [G, nb, nb] as
    given; float32 or float64 members, products in float64.  One launch:
    each member on a thread block cluster of ``blocks`` CTAs (one of
    CLUSTER_SIZES on the card), nb <= 128."""
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    if blocks > max(CLUSTER_SIZES):
        raise ValueError(f"blocks (a cluster size) must be <= "
                         f"{max(CLUSTER_SIZES)}, got {blocks}")
    if not _on_cuda(lm):
        return kt.newton_loop(lm, steps)
    s = _dtype_of(lm)
    if lm.dim() != 3 or lm.shape[-1] != lm.shape[-2]:
        raise ValueError(f"expected [G, nb, nb], got {tuple(lm.shape)}")
    g, nb = lm.shape[0], lm.shape[-1]
    check_nb(nb)
    if nb > PROBE_MAX_NB:
        raise ValueError(f"newton_loop's kernel takes nb <= {PROBE_MAX_NB} "
                         f"(the probe's 128), got nb={nb}")
    if g > MAX_GRID_Y:
        raise ValueError(f"newton_loop's kernel takes G <= {MAX_GRID_Y}, "
                         f"got {g}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    _check_cluster(blocks)
    _check_tensor("lm", lm, lm.dtype, lm.shape, lm.device)
    out = torch.empty_like(lm)
    if g:
        # X (by step parity) and Y of each member in float64, through
        # which a cluster's CTAs pass their blocks (L2-resident)
        ws = torch.empty((g, 3, PROBE_MAX_NB, PROBE_MAX_NB),
                         dtype=torch.float64, device=lm.device)
        _call(getattr(library().lib, f"plu_newton_loop_{s}"),
              lm.device.index, lm.data_ptr(), out.data_ptr(), ws.data_ptr(),
              g, nb, steps, blocks, _stream(lm.device))
        LAUNCHES["newton_loop"] += 1
    return out


def cluster_sync_probe(device, cluster: int, iters: int) -> None:
    """Launch ``iters`` cluster barriers on one cluster of ``cluster``
    CTAs (2 to 16) of P4's and P3's size, on the current stream: the
    floor of a dependent step of their kernels.  On no path."""
    device = torch.device(device)
    _call(library().lib.plu_cluster_sync_probe, device.index, cluster,
          iters, _stream(device))
