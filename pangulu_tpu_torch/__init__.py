"""pangulu_tpu_torch — the sparse direct LU solver in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

A port of ``pangulu_tpu`` (the JAX package beside it, which stays the
reference).  This package imports ``torch``, ``numpy`` and ``scipy`` and
never JAX.  Public API mirrors the reference's entry points
(``pangulu.h:11-15``): :func:`init`, :func:`gstrf`, :func:`gstrs`,
:func:`gssv`, :func:`finalize`, plus :class:`Solver` and
:func:`spsolve`.

The main path is ported: MC64 + fill-reducing ordering, symbolic
analysis, the dense tile store, the single-call factorization engine
and the matmul-only block triangular solve.  On ``device="cuda"`` its
three kernels are CUDA C++ built at first use
(``ops/build.py``); on ``device="cpu"`` their plain PyTorch versions
run.
"""

from pangulu_tpu_torch.api import (
    Handle,
    InitOptions,
    Solver,
    finalize,
    gssv,
    gstrf,
    gstrs,
    init,
    spsolve,
)
from pangulu_tpu_torch.version import __version__

__all__ = [
    "Handle",
    "InitOptions",
    "Solver",
    "init",
    "gstrf",
    "gstrs",
    "gssv",
    "spsolve",
    "finalize",
    "__version__",
]
