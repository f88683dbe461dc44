"""Wrappers of the hand-written CUDA kernels (``csrc/lu_kernels.cu``).

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

import numpy as np
import torch

from pangulu_tpu_torch.ops import build
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.ops.kernels_torch import KernelTables, check_nb

_ABI = 2
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# Per kernel, the number of times it was launched on the card: one per
# K1 or K3 wrapper call and per K2 wrapper call, plus, for K1, every
# diagonal step that K2's level loop launches (K1's kernel on one tile;
# the C entry counts them).  chip_smoke.py zeroes the counts before it
# drives the main path and reads them after.
LAUNCHES = {"getrf_with_inverses": 0, "mega_factorize": 0, "mega_solve": 0}

_library: build.KernelLibrary | None = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
        fn.argtypes = [i, p, p, p, p, i, i, d, p]
        fn = getattr(lib, f"plu_mega_factorize_{s}")
        fn.restype = i
        fn.argtypes = ([i, p, p] + [p] * 6 + [p] * 3
                       + [i] * 7 + [d, p, p])
        fn = getattr(lib, f"plu_mega_solve_{s}")
        fn.restype = i
        fn.argtypes = ([i, p, i, p, p] + [p] * 4 + [p] * 2
                       + [i] * 3 + [p])
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
    :func:`kernels_torch.getrf_with_inverses`."""
    if not _on_cuda(a):
        return kt.getrf_with_inverses(a, tol)
    s = _dtype_of(a)
    if tol is None:
        tol = kt.DEFAULT_TOL[a.dtype]
    single = a.dim() == 2
    a3 = a[None] if single else a
    if a3.dim() != 3 or a3.shape[-1] != a3.shape[-2]:
        raise ValueError(f"expected [nb, nb] or [B, nb, nb], got "
                         f"{tuple(a.shape)}")
    nb = a3.shape[-1]
    check_nb(nb)
    _check_tensor("a", a3, a.dtype, a3.shape, a.device)
    f, linv, uinv = (torch.empty_like(a3) for _ in range(3))
    if a3.shape[0]:
        lib = library().lib
        _call(getattr(lib, f"plu_getrf_inv_{s}"), a.device.index,
              a3.data_ptr(), f.data_ptr(), linv.data_ptr(),
              uinv.data_ptr(), a3.shape[0], nb, float(tol),
              _stream(a.device))
        LAUNCHES["getrf_with_inverses"] += 1
    if single:
        return f[0], linv[0], uinv[0]
    return f, linv, uinv


def mega_factorize(tiles: torch.Tensor, tables: KernelTables, *, nb: int,
                   tol: float, bl: int):
    """K2: the whole factorization, ``tiles`` updated IN PLACE; returns
    ``(tiles, invs[bl, 2, nb, nb])``.  See
    :func:`kernels_torch.mega_factorize`."""
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
    tabs = _dev_tables(tables, ("diag_tab", "lid_tab", "uid_tab",
                                "udst_tab", "udl_tab", "udu_tab"), dev)
    invs = torch.empty((bl, 2, nb, nb), dtype=tiles.dtype, device=dev)
    lib = library().lib
    diag_launches = ctypes.c_int(0)
    _call(getattr(lib, f"plu_mega_factorize_{s}"), dev.index,
          tiles.data_ptr(), invs.data_ptr(), *(t.data_ptr() for t in tabs),
          _ptr(nl), _ptr(nu), _ptr(nup), bl, lw, uw, nchunks, row_w, uch,
          nb, float(tol), ctypes.byref(diag_launches), _stream(dev))
    LAUNCHES["getrf_with_inverses"] += diag_launches.value
    LAUNCHES["mega_factorize"] += 1
    return tiles, invs


def mega_solve(x: torch.Tensor, tiles: torch.Tensor, invs: torch.Tensor,
               tables: KernelTables, *, nb: int, bl: int) -> torch.Tensor:
    """K3: solve LU x = b for ``x`` [nrhs, bl+1, nb]; returns a new
    tensor.  See :func:`kernels_torch.mega_solve`."""
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
    if len(nl) != bl or nl.max(initial=0) > w or nuc.max(initial=0) > w:
        raise ValueError("solve tables do not match bl or their width")
    for k in ("lid_tab", "ucid_tab"):
        _check_table(k, h[k], 0, nt)
    for k in ("lrow_tab", "ucrow_tab"):
        _check_table(k, h[k], 0, bl)
    tabs = _dev_tables(tables, ("lid_tab", "lrow_tab", "ucid_tab",
                                "ucrow_tab"), dev)
    out = x.clone()
    if nrhs:
        lib = library().lib
        _call(getattr(lib, f"plu_mega_solve_{s}"), dev.index,
              out.data_ptr(), nrhs, tiles.data_ptr(), invs.data_ptr(),
              *(t.data_ptr() for t in tabs), _ptr(nl), _ptr(nuc), bl, w,
              nb, _stream(dev))
        LAUNCHES["mega_solve"] += 1
    return out
