#!/usr/bin/env python3
"""Where the time of P4's and P3's cluster kernels goes, on one NVIDIA
GPU.  From the root of the repository:

    python3 pangulu_tpu_torch/tools/probe_clusters.py [--out F]

Each variant is the shipped ``csrc/`` with textual edits to
``csrc/probes.cuh`` (VARIANTS below; an edit that no longer matches the
sources raises): ``shipped``; ``p3_skip_unread``, P3's loads skipping
the pieces no product reads, a test a piece (a design measured slower,
PERF.md PR 12); ``timed``, the shipped kernels with a
clock64 reading at each phase boundary of thread 0 of one CTA (P4: CTA
0 of copy 0's products cluster, summed over the steps: the column
strip's copy from the peers' shared memory, the CTA barrier, the block
product, its store, the cluster barrier; P3: CTA 0 of member 0, the
heaviest at C = 4: the staging and the product L·X, the store of Y, the
cluster barrier, the staging and the product X·Y, the store of X', the
cluster barrier), read back through a C entry of its own;
``p3_noproduct``, P3 without its products, and ``p4_nocopy`` and
``p4_noproduct``, P4 without the copy or the product (wrong outputs,
timing only: what those phases cost).  All are built at once, one nvcc
each, into ``pangulu_tpu_torch/_build/probe_clusters/``.

For each variant it prints P4 at Q = 8, 2048 steps (CUDA events, median
of 3; float64 products on clusters of 8 and 16, 3xTF32 on 4, 8 and 16)
and P3 at G = 1 and 16, nb = 128, 6 steps (device us per call over 10
back-to-back calls, median of 5) on clusters of 4, 8 and 16, with
torch.linalg.solve_triangular on the 16 members beside it; for
``timed`` also the cycles of each phase a step; ``shipped`` and
``p3_skip_unread`` are timed once more after the others, in reverse
order, so that drift over the call shows.  It prints the card's name
and power limit first and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
SRC = "probes.cuh"
TIMED_DEFS = ("template <int C, typename P>\n__device__ __forceinline__ "
              "void scan_products(")
P4_TIMED = [
    (TIMED_DEFS, "__device__ long long g_plu_t[64];\n" + TIMED_DEFS),
    ("  cluster_sync_all();\n  for (int s = 0; s < steps; ++s) {\n"
     "    P* cur = own[s & 1];\n",
     "  cluster_sync_all();\n  long long tt[5] = {0, 0, 0, 0, 0}, t0, t1;\n"
     "  for (int s = 0; s < steps; ++s) {\n    t0 = clock64();\n"
     "    P* cur = own[s & 1];\n"),
    ("    __syncthreads();\n    A acc;\n    acc.zero();\n"
     "    acc.product(As, Sb, 0, kProbeNb);\n",
     "    t1 = clock64(); tt[0] += t1 - t0; t0 = t1;\n    __syncthreads();\n"
     "    t1 = clock64(); tt[1] += t1 - t0; t0 = t1;\n    A acc;\n"
     "    acc.zero();\n    acc.product(As, Sb, 0, kProbeNb);\n"
     "    t1 = clock64(); tt[2] += t1 - t0; t0 = t1;\n"),
    ("    cluster_sync_all();  // the block is stored; every read of cur is "
     "done\n  }\n",
     "    t1 = clock64(); tt[3] += t1 - t0; t0 = t1;\n    cluster_sync_all();\n"
     "    t1 = clock64(); tt[4] += t1 - t0; t0 = t1;\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)\n"
     "    for (int k = 0; k < 5; ++k) g_plu_t[k] = tt[k];\n"),
]
P3_TIMED = [
    ("  for (int s = 0; s < steps; ++s) {\n"
     "    const double* x = wx[s & 1];\n",
     "  long long tt[6] = {0}, t0, t1;\n"
     "#define TT(k) t1 = clock64(); tt[k] += t1 - t0; t0 = t1;\n"
     "  for (int s = 0; s < steps; ++s) {\n    t0 = clock64();\n"
     "    const double* x = wx[s & 1];\n"),
    ("    acc.product(Ls, Sb);\n", "    acc.product(Ls, Sb);\n    TT(0)\n"),
    ("    cluster_sync_all();  // Y is whole; every read of the strip is "
     "done\n",
     "    TT(1)\n    cluster_sync_all();\n    TT(2)\n"),
    ("    acc.product(Xa, Sb);\n", "    acc.product(Xa, Sb);\n    TT(3)\n"),
    ("    cluster_sync_all();  // X' is whole; every read of X and Y is "
     "done\n",
     "    TT(4)\n    cluster_sync_all();\n    TT(5)\n"),
    ("  if (steps == 0) {\n    // X = 2I - L; peers may still read",
     "  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x == 0)\n"
     "    for (int k = 0; k < 6; ++k) g_plu_t[8 + k] = tt[k];\n"
     "  if (steps == 0) {\n    // X = 2I - L; peers may still read"),
]
# P3 skipping the pieces no product reads (a tile reads B[k][c] only for
# c - k < 32 and A[r][k] only for k - r < 16), a test a piece
SKIP_UNREAD = [("    const int r = r0 + e / w, c = c0 + 2 * (e % w);\n",
                "    const int r = r0 + e / w, c = c0 + 2 * (e % w);\n"
                "    if (tri && c >= r + 32) continue;\n")]
VARIANTS = {
    "shipped": [],
    "p3_skip_unread": SKIP_UNREAD,
    "timed": P4_TIMED + P3_TIMED,
    "p3_noproduct": [("    acc.product(Ls, Sb);\n", "\n"),
                     ("    acc.product(Xa, Sb);\n", "\n")],
    "p4_nocopy": [("    copy_blocks<P, G>(G::PR, [&](int ib) {",
                   "    copy_blocks<P, G>(0, [&](int ib) {")],
    "p4_noproduct": [("    acc.product(As, Sb, 0, kProbeNb);",
                      "    acc.product(As, Sb, 0, 0);")],
}
# the C entry that reads the clock64 readings back (timed only)
DEBUG_ENTRY = ("}  // extern \"C\"",
               "int plu_debug_times(long long* out) {\n  return (int)"
               "cudaMemcpyFromSymbol(out, plu::g_plu_t, sizeof(plu::g_plu_t))"
               ";\n}\n}  // extern \"C\"")
P4_PHASES = ("copy", "sync", "product", "store", "barrier")
P3_PHASES = ("stage+L·X", "store Y", "barrier A", "stage+X·Y", "store X'",
             "barrier C")
CLUSTERS = (4, 8, 16)
# timed once more after the others, in reverse order (drift shows)
REPEAT = ("shipped", "p3_skip_unread")
STEPS4, STEPS3 = 2048, 6


def build_all(build) -> dict:
    """Every variant's csrc/ and build directory, all built at once."""
    base = ROOT / "pangulu_tpu_torch" / "_build" / "probe_clusters"
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
        if name == "timed":
            lk = d / "csrc" / "lu_kernels.cu"
            lk.write_text(lk.read_text().replace(*DEBUG_ENTRY))
        build.CSRC_DIR, build.BUILD_DIR = d / "csrc", d / "_build"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = build.BUILD_DIR / f"liblu_kernels_{build.source_hash()}.so"
        out.with_suffix(".log").write_text("")
        dirs[name] = (build.CSRC_DIR, build.BUILD_DIR)
        jobs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
             str(d / "csrc" / "lu_kernels.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for name, p in jobs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log[-3000:]}")
    print(f"built {len(jobs)} variants in {time.perf_counter() - t0:.1f} s")
    return dirs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_clusters: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch.ops import build
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.testing import newton_inputs, probe_inputs

    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dirs = build_all(build)
    dev = torch.device("cuda", 0)
    a, b = (torch.as_tensor(x, device=dev) for x in probe_inputs(seed=0))
    lm16 = torch.as_tensor(newton_inputs(16, 128, seed=16), device=dev)
    members = {1: lm16[:1].contiguous(), 16: lm16}
    eye = torch.eye(128, device=dev).expand(16, 128, 128)
    result = {"card": card, "ms": {}, "cycles": {}}
    order = list(VARIANTS) + [n for n in VARIANTS if n in REPEAT][::-1]
    for run, name in enumerate(order):
        build.CSRC_DIR, build.BUILD_DIR = dirs[name]
        kc._library = None
        lib = kc.library().lib
        row = {}
        for c in CLUSTERS:
            for pr in ("f64", "tf32x3"):
                if pr == "f64" and c == 4:
                    continue  # the card refuses it (csrc/probes.cuh)
                row[f"P4 q=8 {pr} C={c} ms"] = cs.cuda_ms(
                    lambda _: kc.scan_multi(a, b, 8, True, STEPS4,
                                            products=pr, cluster=c), reps=3)
            for g, lm in members.items():
                row[f"P3 G={g} C={c} us"] = cs.device_ms(
                    lambda: kc.newton_loop(lm, STEPS3, blocks=c), n=10,
                    reps=5) * 1e3
        row["solve_triangular G=16 us"] = cs.device_ms(
            lambda: torch.linalg.solve_triangular(
                lm16, eye, upper=False, unitriangular=True),
            n=10, reps=5) * 1e3
        result["ms"].setdefault(name, []).append(row)
        print(f"{name}: " + ", ".join(f"{k} {v:.3f}" for k, v in row.items()),
              flush=True)
        if name != "timed" or run >= len(VARIANTS):
            continue
        for c in CLUSTERS:
            runs = [("P3", lambda: kc.newton_loop(members[1], STEPS3,
                                                  blocks=c),
                     8, P3_PHASES, STEPS3)]
            if c > 4:
                runs.insert(0, ("P4 f64", lambda: kc.scan_multi(
                    a, b, 8, True, STEPS4, cluster=c), 0, P4_PHASES, STEPS4))
            for what, fn, at, phases, steps in runs:
                fn()
                torch.cuda.synchronize()
                t = (ctypes.c_longlong * 64)()
                if lib.plu_debug_times(t) != 0:
                    raise RuntimeError("plu_debug_times failed")
                cyc = {ph: t[at + k] / steps for k, ph in enumerate(phases)}
                result["cycles"][f"{what} C={c}"] = cyc
                print(f"  {what} C={c}, cycles a step: " + ", ".join(
                    f"{ph} {v:.0f}" for ph, v in cyc.items()))
    line = json.dumps({"probe_clusters": result})
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
