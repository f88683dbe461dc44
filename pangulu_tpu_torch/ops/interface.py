"""Kernel backends of the fused and levels engines.

Counterpart of ``pangulu_tpu.ops.interface`` (the reference's platform
layer, ``pangulu_kernel_interface.c``): the engines of
:mod:`pangulu_tpu_torch.numeric` and :mod:`pangulu_tpu_torch.sptrsv`
take their block kernels from a :class:`KernelBackend`.  Two are
registered:

  * ``"torch"``: every kernel from :mod:`~pangulu_tpu_torch.ops.kernels_xla`,
    PyTorch ops on any device and value type (the JAX package's
    ``"jax"``);
  * ``"cuda"``: the diagonal step ``diag_factor_invert`` is the hand K1
    (:func:`~pangulu_tpu_torch.ops.kernels_cuda.getrf_with_inverses`, any
    nb; its plain version on a CPU tensor), the rest the same PyTorch ops
    (the JAX package's ``"pallas"``, whose only kernel there is K1,
    pangulu_tpu/ops/kernels_pallas.py:2394-2412).

:func:`get_backend` with ``"auto"`` picks ``"cuda"`` for float32 and
float64 tiles on a CUDA device, at every nb, and ``"torch"`` on the CPU
and for complex tiles (no hand kernel takes complex values, as no Pallas
kernel does).  The JAX package needs nb % 128 == 0 and float32 for
Pallas (pangulu_tpu/ops/interface.py:80-87): its Pallas K1 was float32
only, and float64 went to its double-float engines.  The port's K1 has
float and double instances at every nb.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from pangulu_tpu_torch.ops import kernels_cuda, kernels_xla

BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    name: str
    getrf: Callable          # (tile, tol) -> tile (L\U packed)
    getrf_batched: Callable  # (tiles, tol) -> tiles
    tstrf: Callable          # (diag, b) -> X·U = B solve
    gessm: Callable          # (diag, b) -> L·X = B solve
    ssssm: Callable          # (c, a, b) -> c - a·b
    diag_inverses: Callable  # factored diag -> (L^-1, U^-1)
    diag_factor_invert: Callable  # raw diag, tol -> (f, L^-1, U^-1)
    trsv_lower_unit: Callable
    trsv_upper: Callable
    spmv_sub: Callable
    vecadd: Callable
    # the tiny-pivot threshold (None: kernels_torch.DEFAULT_TOL by
    # dtype); InitOptions.tol
    tol: float | None = None


def _torch_backend() -> KernelBackend:
    k = kernels_xla
    return KernelBackend(
        name="torch", getrf=k.getrf, getrf_batched=k.getrf_batched,
        tstrf=k.tstrf, gessm=k.gessm, ssssm=k.ssssm,
        diag_inverses=k.diag_inverses,
        diag_factor_invert=k.getrf_with_inverses,
        trsv_lower_unit=k.trsv_lower_unit, trsv_upper=k.trsv_upper,
        spmv_sub=k.spmv_sub, vecadd=k.vecadd)


_REGISTRY: dict[str, KernelBackend] = {
    "torch": _torch_backend(),
    "cuda": dataclasses.replace(
        _torch_backend(), name="cuda",
        diag_factor_invert=kernels_cuda.getrf_with_inverses),
}


def get_backend(name: str = "auto", nb: int = 128, dtype=None,
                tol: float | None = None, device="cpu") -> KernelBackend:
    """The backend ``name`` ("auto", "cuda" or "torch") for tiles of
    ``nb`` and ``dtype`` (a torch or numpy dtype; None: real) on
    ``device``, with ``tol`` set when given.  Every nb takes the same
    backend (K1 takes any nb).  ``"cuda"`` for complex tiles raises: its
    K1 takes float32 and float64."""
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; have "
                         f"{list(BACKENDS)}")
    complex_tiles = dtype is not None and torch.empty(
        0, dtype=_torch_dtype(dtype)).is_complex()
    if name == "auto":
        name = ("cuda" if torch.device(device).type == "cuda"
                and not complex_tiles else "torch")
    elif name == "cuda" and complex_tiles:
        raise ValueError("backend='cuda' runs K1, which takes float32 and "
                         "float64 tiles; complex tiles run on the 'torch' "
                         "backend")
    backend = _REGISTRY[name]
    return (dataclasses.replace(backend, tol=tol) if tol is not None
            else backend)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
