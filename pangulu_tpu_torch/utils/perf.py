"""Performance counters, timers and flop accounting.

Counterpart of the reference's ``-DPANGULU_PERF`` observability:
``pangulu_stat_t global_stat`` (pangulu_common.h:139-163), per-kernel
flop models (pangulu_kernel_interface.c:4-178), phase wall-times
(pangulu.c:160,184,196,246,315) and the GFLOPS summary line
(pangulu_strings.h:84).  Always on (the counters are host-side).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import numpy as np
import torch


class PerfCounters:
    def __init__(self):
        self.phase_time: dict[str, float] = {}
        self.flops: float = 0.0
        # Dual flop accounting: ``flops`` is the dense-tile model (the
        # tile flops actually executed — a utilization metric);
        # ``useful_flops`` is the EXACT sparse LU count for the fill
        # pattern — the number the reference reports
        # (pangulu_kernel_interface.c:4-178).
        self.useful_flops: float | None = None
        self.factor_nnz: int | None = None   # |L|+|U| scalar nnz
        self.kernels: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phase_time[name] = self.phase_time.get(name, 0.0) + dt

    def add_flops(self, f: float):
        self.flops += f

    def kernel_counts(self, **counts: int):
        for k, v in counts.items():
            self.kernels[k] = self.kernels.get(k, 0) + int(v)

    def set_useful(self, sparse_flops, factor_nnz):
        """Record the exact-sparse-flop / factor-nnz accounting (from
        the scalar symbolic analysis); either may be None."""
        if sparse_flops is not None:
            self.useful_flops = float(sparse_flops)
        if factor_nnz is not None:
            self.factor_nnz = int(factor_nnz)

    def gflops(self, phase: str = "numeric") -> float:
        t = self.phase_time.get(phase, 0.0)
        return self.flops / t / 1e9 if t > 0 else 0.0

    def useful_gflops(self, phase: str = "numeric") -> float | None:
        if self.useful_flops is None:
            return None
        t = self.phase_time.get(phase, 0.0)
        return self.useful_flops / t / 1e9 if t > 0 else 0.0

    def nnz_per_s(self, phase: str = "numeric") -> float | None:
        """Factor nnz / numeric time — the reference's derivable
        scaling metric."""
        if self.factor_nnz is None:
            return None
        t = self.phase_time.get(phase, 0.0)
        return self.factor_nnz / t if t > 0 else 0.0

    def to_dict(self) -> dict:
        """JSON-ready snapshot (the machine-readable counterpart of the
        reference's printed summary)."""
        return {
            "phase_time_s": dict(self.phase_time),
            "flops": self.flops,
            "gflops_numeric": self.gflops(),
            "useful_flops": self.useful_flops,
            "useful_gflops_numeric": self.useful_gflops(),
            "factor_nnz": self.factor_nnz,
            "nnz_per_s": self.nnz_per_s(),
            "kernels": dict(self.kernels),
        }

    def summary(self) -> str:
        lines = ["[pangulu_tpu_torch perf]"]
        for name, t in self.phase_time.items():
            lines.append(f"  {name:>12s} : {t:9.4f} s")
        if self.flops:
            lines.append(f"  {'flops':>12s} : {self.flops:.3e}"
                         f"  ({self.gflops():.2f} GFLOPS numeric, "
                         f"dense-tile model)")
        if self.useful_flops is not None and self.useful_gflops():
            lines.append(f"  {'useful':>12s} : {self.useful_flops:.3e}"
                         f"  ({self.useful_gflops():.2f} GFLOPS, exact "
                         f"sparse count)")
        if self.factor_nnz is not None and self.nnz_per_s():
            lines.append(f"  {'factor nnz':>12s} : {self.factor_nnz}"
                         f"  ({self.nnz_per_s():.3e} nnz/s)")
        if self.kernels:
            ks = ", ".join(f"{k}={v}" for k, v in self.kernels.items())
            lines.append(f"  {'kernels':>12s} : {ks}")
        return "\n".join(lines)


def resolve_device(device) -> torch.device:
    """``device`` ("cuda", "cuda:i" or "cpu") as a torch.device with its
    index.  "cuda" raises when there is no GPU: the plain versions run
    only where ``device="cpu"`` is asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; ask for "
                "device='cpu' explicitly to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


@contextlib.contextmanager
def profile_trace(profile_dir, device, rank: int | None = None):
    """A ``torch.profiler`` trace of the enclosed work, written to
    ``profile_dir`` as Chrome trace JSON (``<worker>.<time_ns>.pt.trace.
    json``, chrome://tracing or Perfetto; the JAX package writes XPlane
    with ``jax.profiler.trace``): host activity, and the card's kernels
    when ``device`` is a CUDA device.  The worker name carries the host,
    the pid and, on a grid of ranks, ``rank``, and the file name the
    time in ns, so ranks and repeated calls never overwrite each other's
    files.  The device's queued work is waited for before the trace
    closes, so that it holds the kernels still running.  The trace
    closes, and its file is written, also when the enclosed work
    raises."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    worker = f"{socket.gethostname()}_{os.getpid()}"
    if rank is not None:
        worker += f"_rank{rank}"
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     str(profile_dir), worker_name=worker)):
        yield
        device_sync(device)


def device_sync(device) -> None:
    """Wait for the queued work on ``device`` (a no-op for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_memory_stats() -> dict:
    """Device memory usage (counterpart of the reference's RSS/GPU
    memory report, pangulu_utils.c:428-451): free/total bytes and the
    peak allocated by this process, per visible CUDA device."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "free_bytes": int(free),
            "total_bytes": int(total),
            "peak_bytes_allocated": int(torch.cuda.max_memory_allocated(i)),
        }
    return out


def host_rss_bytes() -> int:
    """Peak resident set size of this process in bytes (Linux reports
    ``ru_maxrss`` in KiB)."""
    import resource

    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024


def residual_norm(a_scipy, x: np.ndarray, b: np.ndarray) -> float:
    """Relative residual ||Ax - b||_2 / ||b||_2, accumulated in float64,
    complex128 for a complex system (reference: examples/example.c:
    304-364 uses Kahan summation)."""
    x = np.asarray(x)
    b = np.asarray(b)
    acc = (np.complex128 if any(np.iscomplexobj(v) for v in (a_scipy, x, b))
           else np.float64)
    r = a_scipy.astype(acc) @ x.astype(acc) - b.astype(acc)
    denom = np.linalg.norm(b.astype(acc))
    return float(np.linalg.norm(r) / (denom if denom else 1.0))


def factorization_residual(a_scipy, lmat, umat) -> float:
    """||L(U 1) - A 1||_2 / ||A 1||_2 — the reference's gstrf-only
    check (pangulu_numeric_check, pangulu_numeric.c:1082-1341)."""
    n = a_scipy.shape[0]
    ones = np.ones(n, dtype=np.float64)
    a1 = a_scipy @ ones
    lu1 = lmat @ (umat @ ones)
    denom = np.linalg.norm(a1)
    return float(np.linalg.norm(lu1 - a1) / (denom if denom else 1.0))
