"""Logging / message catalog.

Counterpart of the reference's printf macro catalog with three
compile-time levels (``pangulu_strings.h:1-69``, ``-DPANGULU_LOG_*``).
Here: a standard :mod:`logging` logger with the same level tiers and a
config-banner helper (pangulu_strings.h:91-147).
"""

from __future__ import annotations

import logging
import os

_LEVELS = {"error": logging.ERROR, "warning": logging.WARNING,
           "info": logging.INFO, "debug": logging.DEBUG}


def get_logger() -> logging.Logger:
    log = logging.getLogger("pangulu_tpu_torch")
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[pangulu_tpu_torch %(levelname)s] %(message)s"))
        log.addHandler(h)
        log.setLevel(_LEVELS.get(
            os.environ.get("PANGULU_TPU_TORCH_LOG", "warning").lower(),
            logging.WARNING))
        log.propagate = False
    return log


def config_banner(opts, n: int, nnz: int) -> str:
    """Config table printed at init (reference: pangulu_strings.h:91-147)."""
    rows = [
        ("n", n),
        ("nnz", nnz),
        ("nb", opts.nb),
        ("value type", opts.dtype),
        ("mc64", opts.mc64),
        ("ordering", opts.ordering),
        ("symbolic", opts.symbolic_mode),
        ("device", opts.device),
    ]
    width = max(len(str(k)) for k, _ in rows)
    lines = ["pangulu_tpu_torch configuration:"]
    lines += [f"  {k:<{width}} : {v}" for k, v in rows]
    return "\n".join(lines)
