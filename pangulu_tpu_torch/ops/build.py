"""Build of the hand-written CUDA kernels (``pangulu_tpu_torch/csrc``).

``nvcc`` compiles ``csrc/lu_kernels.cu`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ctypes by
:mod:`pangulu_tpu_torch.ops.kernels_cuda`.  The build runs at first use,
from the repository's sources only, into :data:`BUILD_DIR` (listed in
``.gitignore``); the file name carries a hash of the sources, so an
edited source builds anew and a stale library is never loaded.

Nothing here runs at import: the CPU tests import every module, and the
machine they run on has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
_MAIN_SOURCE = "lu_kernels.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def source_hash() -> str:
    """Hash of every file under ``csrc/`` (names and bytes)."""
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.iterdir()):
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """Path of ``nvcc``, or RuntimeError when the toolkit is absent."""
    cand = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand.append(str(pathlib.Path(cuda_home) / "bin" / "nvcc"))
    for c in cand:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built, and a "
        "CUDA tensor has no other path")


class KernelLibrary:
    """The built library: its path, the ctypes handle, and how long the
    build took in this process (0.0 when it was already built)."""

    def __init__(self, path: pathlib.Path, build_seconds: float,
                 log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))


def build() -> tuple[pathlib.Path, float, str]:
    """Compile the kernels if their library for the current sources is
    missing.  Returns (library path, seconds spent, compiler output:
    that of the earlier build when the library was there)."""
    out = BUILD_DIR / f"liblu_kernels_{source_hash()}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / _MAIN_SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
    log_path.write_text(log)
    tmp.replace(out)
    return out, secs, log


def load() -> KernelLibrary:
    """Build if needed and load the kernel library."""
    path, secs, log = build()
    return KernelLibrary(path, secs, log)
