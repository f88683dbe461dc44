"""pangulu_tpu_torch — the sparse direct LU solver in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

A port of ``pangulu_tpu`` (the JAX package beside it, which stays the
reference).  This package imports ``torch``, ``numpy`` and ``scipy`` and
never JAX.  Public API mirrors the reference's entry points
(``pangulu.h:11-15``): :func:`init`, :func:`gstrf`, :func:`gstrs`,
:func:`gssv`, :func:`finalize`, plus :class:`Solver`, :func:`spsolve`
and the JAX package's single-device surface for real types:
:func:`analyze`, :func:`update_values`, :func:`gstrs_device`,
:func:`factor_diagnostics` and ``gstrs(..., trans=True)``.  The CLI is
``python -m pangulu_tpu_torch`` (:mod:`pangulu_tpu_torch.cli`).

The main path is ported: MC64 + fill-reducing ordering, symbolic
analysis, the dense tile store (or, with ``tile_storage="compressed"``,
the O(fill) compressed store of :mod:`pangulu_tpu_torch.compressed`),
the factorization engines and the matmul-only block triangular solve,
on one device or, with ``mesh_shape``, over a grid of
``torch.distributed`` ranks (:mod:`pangulu_tpu_torch.parallel`).
On ``device="cuda"`` their kernels are CUDA C++ built at first use
(``ops/build.py``); on ``device="cpu"`` their plain PyTorch versions
run.
"""

from pangulu_tpu_torch.api import (
    Handle,
    InitOptions,
    Solver,
    analyze,
    factor_diagnostics,
    finalize,
    gssv,
    gstrf,
    gstrs,
    gstrs_device,
    init,
    spsolve,
    update_values,
)
from pangulu_tpu_torch.version import __version__

__all__ = [
    "Handle",
    "InitOptions",
    "analyze",
    "factor_diagnostics",
    "Solver",
    "init",
    "gstrf",
    "gstrs",
    "gstrs_device",
    "gssv",
    "spsolve",
    "update_values",
    "finalize",
    "__version__",
]
