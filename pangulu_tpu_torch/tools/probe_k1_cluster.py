#!/usr/bin/env python3
"""Where the time of K1's cluster kernel at nb=256 goes, on one NVIDIA
GPU.  From the root of the repository:

    python3 pangulu_tpu_torch/tools/probe_k1_cluster.py [--out F]

Each variant is the shipped ``csrc/`` with textual edits (VARIANTS
below; an edit that no longer matches the sources raises): ``shipped``;
``diag_noinline``, the diagonal block compiled as a function apart
from the kernel around it (its code and register use unchanged by
edits elsewhere); ``diag_unroll2``, ``diag_unroll4`` and ``diag_unrolled``, the
diagonal warp's forward steps unrolled 2 and 4 times and whole;
``diag_nostore`` and ``diag_noinv``, without its stores of the factor
and without its U^-1 by columns (wrong outputs, timing only); ``nodiag``
without the diagonal warp's block (step 1) and ``noupd`` without the
trailing update (step 5), whose outputs are wrong and whose times bound
what those steps cost; and ``timed``, the shipped kernel with a
clock64 reading at each phase boundary of thread 0 of the first CTA
of the first cluster, read back through a C entry of its own.  All are
built at once, one nvcc each, into ``pangulu_tpu_torch/_build/probe_k1/``.

For each variant it prints the device ms of one K1 call (back-to-back
calls between CUDA events, median of 5) at nb = 256, batch 1 and 132,
float32 and float64; for ``timed`` also the cycles of each phase of
each panel at batch 1: the diagonal block (the owner's warp 0), the
owner's copy of the panel's rows into its R and the staging rows, the
cluster barrier, the others' load of the staging rows, the split and
the row product, the owner's rows with the column product, and the
update.  It prints the card's name
and power limit first and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC = "lu_kernels.cu"
TIMED_DEFS = """__device__ long long g_plu_t[128];
#define PLU_T(i) do { if (threadIdx.x == 0 && blockIdx.x == 0 && \\
                          blockIdx.y == 0) g_plu_t[i] = clock64(); } while (0)
template <typename T>
__global__ void __launch_bounds__(kClThreads, 1)
    lu_cluster_kernel("""
# slots: 0 start, 1 tile loaded, per panel p 2 + 8 p .. 9 + 8 p, 66 end
PHASES = ("diag", "stage rows", "barrier", "load rows",
          "split, row product", "owner rows, column product", "update")
VARIANTS = {
    "shipped": [],
    "nodiag": [("      if (warp == 0)  // 1. the diagonal block\n",
                "      if (false)\n")],
    "noupd": [("      for (int c0 = below ? 0 : kb / 64 * 64; c0 < kMaxNb; "
               "c0 += 64) {",
               "      for (int c0 = kMaxNb; c0 < kMaxNb; c0 += 64) {")],
    # the diagonal warp's forward steps unrolled 2 and 4 times, whole
    "diag_unroll2": [
        ("#pragma unroll 1\n  for (int k = 0; k < kPanel; ++k) {",
         "#pragma unroll 2\n  for (int k = 0; k < kPanel; ++k) {")],
    "diag_unroll4": [
        ("#pragma unroll 1\n  for (int k = 0; k < kPanel; ++k) {",
         "#pragma unroll 4\n  for (int k = 0; k < kPanel; ++k) {")],
    "diag_unrolled": [
        ("#pragma unroll 1\n  for (int k = 0; k < kPanel; ++k) {",
         "#pragma unroll\n  for (int k = 0; k < kPanel; ++k) {")],
    # timing only (wrong outputs): without the diagonal warp's stores of
    # the factor, without its U^-1 by columns
    "diag_nostore": [
        ("    if (lane > k && in && k0 + k < nb) frow[k] = l;\n", ""),
        ("    if (j >= lane && in && k0 + j < nb) frow[j] = x[j];\n",
         "    if (false) frow[j] = x[j];\n")],
    "diag_noinv": [
        ("  for (int m = kPanel - 1; m >= 0; --m) {\n    y[m] = quot(",
         "  for (int m = -1; m >= 0; --m) {\n    y[m] = quot(")],
    # the diagonal block compiled apart from the kernel around it
    "diag_noinline": [(
        "__device__ __forceinline__ void diag_panel(",
        "__device__ __noinline__ void diag_panel(")],
    "timed": [
        ("template <typename T>\n__global__ void __launch_bounds__"
         "(kClThreads, 1)\n    lu_cluster_kernel(", TIMED_DEFS),
        ("  const int rank = (int)cg::this_cluster().block_rank();\n",
         "  const int rank = (int)cg::this_cluster().block_rank();\n"
         "  PLU_T(0);\n"),
        ("  const int lw = warp * C::MW, gw = r0 + lw;  // the warp's first "
         "row\n",
         "  PLU_T(1);\n  const int lw = warp * C::MW, gw = r0 + lw;\n"),
        ("    T* S = UI + (size_t)k0 * nb;\n",
         "    T* S = UI + (size_t)k0 * nb;\n    PLU_T(2 + k0 / 4);\n"),
        ("                   nb, tol);\n      __syncthreads();\n",
         "                   nb, tol);\n      PLU_T(3 + k0 / 4);\n"
         "      __syncthreads();\n"),
        ("    cluster_arrive();\n    cluster_wait();  // S holds the owner's "
         "rows P\n",
         "    if (!mine) PLU_T(3 + k0 / 4);\n    PLU_T(4 + k0 / 4);\n"
         "    cluster_arrive();\n    cluster_wait();\n    PLU_T(5 + k0 / 4);"
         "\n"),
        ("      cp_async_wait_all();\n    }\n    __syncthreads();\n",
         "      cp_async_wait_all();\n    }\n    __syncthreads();\n"
         "    PLU_T(6 + k0 / 4);\n"),
        ("    if (mine) {  // 3. the owner's rows P",
         "    PLU_T(7 + k0 / 4);\n    if (mine) {  // 3. the owner's rows P"),
        ("    // 5. W[i, j] -= a_i", "    PLU_T(8 + k0 / 4);\n    // 5. W"),
        ("    __syncthreads();\n  }\n  // L^-1 below W's diagonal",
         "    __syncthreads();\n    PLU_T(9 + k0 / 4);\n  }\n  PLU_T(66);\n"
         "  // L^-1 below W's diagonal"),
        ("}  // extern \"C\"",
         "int plu_debug_times(long long* out) {\n  return (int)"
         "cudaMemcpyFromSymbol(out, plu::g_plu_t, sizeof(plu::g_plu_t));\n"
         "}\n}  // extern \"C\""),
    ],
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def device_ms(fn, n: int, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k1_cluster: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pangulu_tpu_torch.ops import build
    from pangulu_tpu_torch.ops import kernels_cuda as kc

    print(card_line())
    base = ROOT / "pangulu_tpu_torch" / "_build" / "probe_k1"
    shipped = build.CSRC_DIR
    src = (shipped / SRC).read_text()
    dirs, jobs = {}, {}
    t0 = time.perf_counter()
    for name, edits in VARIANTS.items():
        d = base / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(shipped, d / "csrc")
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: edit does not match "
                                   f"once: {old[:60]!r}")
            text = text.replace(old, new)
        (d / "csrc" / SRC).write_text(text)
        build.CSRC_DIR, build.BUILD_DIR = d / "csrc", d / "_build"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = build.BUILD_DIR / f"liblu_kernels_{build.source_hash()}.so"
        dirs[name] = (build.CSRC_DIR, build.BUILD_DIR)
        jobs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
             str(d / "csrc" / SRC)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, p in jobs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
    print(f"built {len(jobs)} variants in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    tiles = {(dt, b): torch.as_tensor(
        rng.standard_normal((b, 256, 256)) + 256 * np.eye(256), dtype=dt,
        device=dev) for dt in (torch.float32, torch.float64)
        for b in (1, 132)}
    result = {"card": card_line(), "ms": {}, "cycles": {}}
    for name in VARIANTS:
        build.CSRC_DIR, build.BUILD_DIR = dirs[name]
        kc._library = None
        lib = kc.library().lib
        row = {}
        for (dt, b), a in tiles.items():
            row[f"{str(dt)[6:]} batch {b}"] = device_ms(
                lambda: kc.getrf_with_inverses(a), 50 if b == 1 else 10)
        result["ms"][name] = row
        print(f"{name:8s} " + "  ".join(f"{k} {v:.4f} ms"
                                        for k, v in row.items()))
        if name != "timed":
            continue
        for dt in (torch.float32, torch.float64):
            kc.getrf_with_inverses(tiles[(dt, 1)])
            torch.cuda.synchronize()
            t = (ctypes.c_longlong * 128)()
            if lib.plu_debug_times(t) != 0:
                raise RuntimeError("plu_debug_times failed")
            panels = [{ph: t[2 + 8 * p + q + 1] - t[2 + 8 * p + q]
                       for q, ph in enumerate(PHASES)} for p in range(8)]
            result["cycles"][str(dt)[6:]] = dict(
                load=t[1] - t[0], loop=t[66] - t[1], panels=panels)
            print(f"  {dt} cycles of CTA 0: tile load {t[1] - t[0]}, "
                  f"panels {t[66] - t[1]}")
            for p, ph in enumerate(panels):
                print(f"    panel {p}: " + ", ".join(
                    f"{k} {v}" for k, v in ph.items()))
    line = json.dumps({"probe_k1_cluster": result})
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
