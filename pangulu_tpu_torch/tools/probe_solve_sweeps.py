#!/usr/bin/env python3
"""Probe of K3's and K5's sweeps (``mega_solve``, ``mega_solve_groups``)
on one NVIDIA GPU.  From the root of the repository:

    python3 pangulu_tpu_torch/tools/probe_solve_sweeps.py [--root DIR]
        [--edits] [--reps N] [--out F]

Without ``--edits`` it times the solves of CELLS with the package of
DIR (default: this checkout; an older tree unpacked with ``git archive``
is measured the same way, through the wrappers' arguments that every
tree takes): per cell the solve's call ms (CUDA events around one call
from an idle card, as chip_smoke.py times it, median of N), its device
ms a call over back-to-back calls queued behind a device sleep, and a
sha256 of the factors' and of the solution's bytes (inputs from a
seed), so that two trees' results can be compared bit for bit.

With ``--edits`` (this tree) it builds the source variants of EDITS
(textual edits of ``csrc/solve_clusters.cuh``, each of which must match
once; all built at once, as ``probe_products.py`` builds its own) and
times K3 (rcm) and K5 (nd) with each on poisson3d(32) nb=256 r32 at 1,
2 and 4 right-hand sides: other cluster sizes (DESIGNS: their
results must be the shipped kernels' bits, or the probe fails), and
timing-only edits that leave a phase out (what a phase costs is the
shipped time less the time without it), and clock64 phases (``timed``).
With each, ptxas's registers and spill bytes of the sweep kernels.

It prints the card's name and power limit, a line a measurement, then
one JSON line (also written to F).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]

# (n of poisson3d, nb, dtype, ordering, right-hand sides)
CELLS = [(32, 256, "r32", "rcm", 1), (32, 256, "r32", "rcm", 4),
         (32, 256, "r32", "nd", 1), (32, 256, "r32", "nd", 2),
         (32, 256, "r32", "nd", 4),
         (32, 256, "r64", "rcm", 1), (32, 256, "r64", "nd", 1),
         (16, 256, "r64", "rcm", 1), (16, 256, "r64", "nd", 1),
         (32, 128, "r32", "rcm", 1), (32, 128, "r32", "rcm", 4),
         (32, 128, "r32", "nd", 1), (32, 128, "r32", "nd", 4)]
CALLS = 20   # back-to-back calls a device timing

# name -> (what the edit changes or leaves out, [(file in csrc/, old,
# new)]); DESIGNS give the shipped bits (each row summed in one order),
# the rest are timing only: their results are wrong
_F = "solve_clusters.cuh"
_K5_PICK = "  return width * nrhs < 2 * sms ? 4 : 2;"
_K5_LAUNCH = "  e = cudaLaunchKernelEx(&cfg, kern, a, bar);\n"
EDITS = {
    "shipped": ("nothing", []),
    "k3_c8": ("K3 on clusters of 8 CTAs",
              [(_F, "kSolveCluster = 16;", "kSolveCluster = 8;")]),
    "k3_c4": ("K3 on clusters of 4 CTAs (f64: nothing staged)",
              [(_F, "kSolveCluster = 16;", "kSolveCluster = 4;")]),
    "k5_c2": ("K5 on clusters of 2 CTAs at any number of RHS",
              [(_F, _K5_PICK, "  return 2;")]),
    "k5_c4": ("K5 on clusters of 4 CTAs at any number of RHS",
              [(_F, _K5_PICK, "  return 4;")]),
    "k5_c4_memset": (
        "K5 on clusters of 4, its counters cleared by cudaMemsetAsync "
        "before each sweep",
        [(_F, _K5_PICK, "  return 4;"),
         (_F, _K5_LAUNCH, "  e = cudaMemsetAsync(bar, 0, 8, st);\n"
                          "  if (e == cudaSuccess)\n  " + _K5_LAUNCH)]),
    "k5_c4_not_cooperative": (
        "K5 on clusters of 4, a cluster launch only (not cooperative)",
        [(_F, _K5_PICK, "  return 4;"),
         (_F, "  cfg.numAttrs = 2;\n", "")]),
    "k3_no_updates": (
        "K3's panel products (T_t x_k off the targets)",
        [(_F, "const int nj = nm * nrh * S::R;", "const int nj = 0;")]),
    "k3_no_x": (
        "K3's inverse products (x_k's rows), and the gather of x_k",
        [(_F, "for (int p = warp; p < nrh * S::R; p += S::kWarps) {",
          "for (int p = warp; p < 0; p += S::kWarps) {"),
         (_F, "for (int e = threadIdx.x; e < nrh * nb; e += S::kThreads) {",
          "for (int e = threadIdx.x; e < 0; e += S::kThreads) {")]),
    "k3_barriers": (
        "K3's products and gather: left are the barriers, the staging and "
        "the tables",
        [(_F, "const int nj = nm * nrh * S::R;", "const int nj = 0;"),
         (_F, "for (int p = warp; p < nrh * S::R; p += S::kWarps) {",
          "for (int p = warp; p < 0; p += S::kWarps) {"),
         (_F, "for (int e = threadIdx.x; e < nrh * nb; e += S::kThreads) {",
          "for (int e = threadIdx.x; e < 0; e += S::kThreads) {")]),
    "k5_no_entries": (
        "K5's entry products",
        [(_F, "for (int e = d.z; e < d.w; ++e) {\n"
              "        const int2 te = __ldg(a.ent + e);",
          "for (int e = d.z; e < d.z; ++e) {\n"
          "        const int2 te = __ldg(a.ent + e);")]),
    "k5_no_inverse": (
        "K5's inverse products",
        [(_F, "        split_rows_dot<T, S::kWarps, S::kRows, false>(\n"
              "            a.invs + (2 * (size_t)d.x + a.slot) * nn, v, nb, i0, "
              "r1, sum);\n", "")]),
    "k5_no_exchange": (
        "K5's cluster barrier and gather of v before an inverse",
        [(_F, "        cluster_sync_all();  // v's rows are published\n"
              "        for (int j = threadIdx.x; j < nb; j += S::kThreads)",
          "        for (int j = threadIdx.x; j < 0; j += S::kThreads)")]),
}
DESIGNS = ("k3_c8", "k3_c4", "k5_c2", "k5_c4", "k5_c4_memset",
           "k5_c4_not_cooperative")
# "timed": the shipped kernels with a clock64 reading of thread 0 of CTA 0
# at each phase boundary, summed over a sweep (the backward one, the
# last launch), read back by a C entry of its own; K3's phases a level,
# K5's an item (those CTA 0 took; its last two phases a step, summed)
_T = "  long long tt[8] = {0, 0, 0, 0, 0, 0, 0, 0}, c0 = clock64(), c1;\n"
EDITS["timed"] = ("nothing (clock64 readings)", [
    (_F, "namespace plu {\n\n// The cluster size of K3",
     "namespace plu {\n__device__ long long g_plu_t[32];\n"
     "#define PLU_TT(k) c1 = clock64(); tt[k] += c1 - c0; c0 = c1;\n\n"
     "// The cluster size of K3"),
    (_F, "  for (int rb = q; rb < nrhs; rb += nq * M::kRhs) {\n",
     _T + "  for (int rb = q; rb < nrhs; rb += nq * M::kRhs) {\n"),
    (_F, "      const T* sm = stage + (s & 1) * M::kStageElems;\n",
     "      c0 = clock64();\n"
     "      const T* sm = stage + (s & 1) * M::kStageElems;\n"),
    (_F, "      cp_async_wait_all();\n      // x_k's source rows are whole",
     "      cp_async_wait_all();\n      PLU_TT(0)\n"
     "      // x_k's source rows are whole"),
    (_F, "      cluster_sync_all();\n      // the old values of this CTA's",
     "      cluster_sync_all();\n      PLU_TT(1)\n"
     "      // the old values of this CTA's"),
    (_F, "      issue_tabs(s + 2);\n      const T* inv",
     "      issue_tabs(s + 2);\n      PLU_TT(2)\n      const T* inv"),
    (_F, "      cluster_sync_all();  // x_k's rows are published\n",
     "      PLU_TT(3)\n      cluster_sync_all();\n      PLU_TT(4)\n"),
    (_F, "      asm volatile(\"cp.async.wait_group 2;\\n\" ::: \"memory\");\n"
         "      __syncthreads();\n",
     "      asm volatile(\"cp.async.wait_group 2;\\n\" ::: \"memory\");\n"
     "      __syncthreads();\n      PLU_TT(5)\n"),
    (_F, "          if (vb) *ob = oldb - rb2;\n        }\n      }\n    }\n  }\n",
     "          if (vb) *ob = oldb - rb2;\n        }\n      }\n"
     "      PLU_TT(6)\n    }\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
     "    for (int k = 0; k < 7; ++k) g_plu_t[k] = tt[k];\n"),
    (_F, "  int par = 0;\n  int2 cur = __ldg(a.step), nxt = __ldg(a.step + 1);",
     _T + "  int nitems = 0;\n  int par = 0;\n"
     "  int2 cur = __ldg(a.step), nxt = __ldg(a.step + 1);"),
    (_F, "      const int r = it / n;\n      const int4 d = __ldg(a.item + cur.x",
     "      const int r = it / n;\n      c0 = clock64();\n      ++nitems;\n"
     "      const int4 d = __ldg(a.item + cur.x"),
    (_F, "      if (d.y) {  // uniform across the cluster\n"
         "        cluster_sync_all();  // v's rows are published\n",
     "      PLU_TT(0)\n      if (d.y) {\n        cluster_sync_all();\n"
     "        PLU_TT(1)\n"),
    (_F, "        __syncthreads();\n        T sum[S::kRows];",
     "        __syncthreads();\n        PLU_TT(2)\n        T sum[S::kRows];"),
    (_F, "        par ^= 1;\n      }\n    }\n    if (s + 1 == a.nsteps) break;\n",
     "        par ^= 1;\n        PLU_TT(3)\n      }\n    }\n    c0 = clock64();\n"
     "    if (s + 1 == a.nsteps) break;\n"),
    (_F, "    cur = nxt;\n    nxt = after;\n    grid_barrier(bar, gridDim.x);\n  }\n",
     "    cur = nxt;\n    nxt = after;\n    PLU_TT(4)\n"
     "    grid_barrier(bar, gridDim.x);\n    PLU_TT(5)\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
     "    for (int k = 0; k < 6; ++k) g_plu_t[16 + k] = tt[k];\n"
     "    g_plu_t[31] = nitems;\n  }\n"),
    ("lu_kernels.cu", "}  // extern \"C\"",
     "int plu_debug_times(long long* out) {\n  return (int)"
     "cudaMemcpyFromSymbol(out, plu::g_plu_t, sizeof(plu::g_plu_t));\n}\n"
     "}  // extern \"C\""),
])
K3_PHASES = ("stage wait", "barrier A", "issue (old values, stage, tables)",
             "x_k rows", "barrier B", "gather + wait", "updates")
K5_PHASES = ("entries", "barrier", "gather", "inverse", "prefetch",
             "grid barrier")


def call_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of one call of fn from an idle card."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int) -> float:
    """Median device ms a call over CALLS back-to-back calls queued
    behind a device sleep (the card runs them without waiting on the
    host while the host enqueues faster than the card runs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def factored(size, nb, dtype, ordering, dev):
    """(tiles, invs, solve tables, kw, solve kernel, plain solve) of
    poisson3d(size), factored by the tree's own kernels."""
    from pangulu_tpu_torch import InitOptions, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    h = init(poisson3d(size), InitOptions(nb=nb, dtype=dtype,
                                          ordering=ordering, device="cuda"))
    nt, bl, sch = h.blocked.num_tiles, h.schedule.block_length, h.schedule
    uch = kt.mega_uch(nb)
    t0 = h.blocked.device_tiles(dev)
    kw = dict(nb=nb, bl=bl)
    if ordering == "nd":
        ftab = kt.KernelTables.build(sch.group_mega_tables(nt, uch=uch), dev)
        stab = kt.KernelTables.build(sch.group_solve_tables(nt), dev)
        tk, ik = kc.mega_factorize_groups(t0, ftab, tol=kt.DEFAULT_TOL[
            t0.dtype], **kw)
        return tk, ik, stab, kw, kc.mega_solve_groups, kt.mega_solve_groups
    ftab = kt.KernelTables.build(sch.mega_tables(nt, uch=uch), dev)
    stab = kt.KernelTables.build(sch.mega_solve_tables(nt), dev)
    tk, ik = kc.mega_factorize(t0, ftab, tol=kt.DEFAULT_TOL[t0.dtype], **kw)
    return tk, ik, stab, kw, kc.mega_solve, kt.mega_solve


def rhs(nrhs, kw, dtype, dev):
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (nrhs, kw["bl"] + 1, kw["nb"])), dtype=dtype, device=dev)
    x[:, kw["bl"]] = 0
    return x


def cells(dev, reps) -> dict:
    out = {}
    cache = {}
    for size, nb, dtype, ordering, nrhs in CELLS:
        key = (size, nb, dtype, ordering)
        if key not in cache:
            cache.clear()
            torch.cuda.empty_cache()
            cache[key] = factored(size, nb, dtype, ordering, dev)
        tk, ik, stab, kw, solve, _ = cache[key]
        x = rhs(nrhs, kw, tk.dtype, dev)
        got = solve(x, tk, ik, stab, **kw)
        label = (f"{'K5' if ordering == 'nd' else 'K3'} poisson3d({size}) "
                 f"nb={nb} {dtype} {ordering} {nrhs} rhs")
        res = dict(call_ms=call_ms(lambda: solve(x, tk, ik, stab, **kw),
                                   reps),
                   device_ms=device_ms(lambda: solve(x, tk, ik, stab, **kw),
                                       reps),
                   factors_sha=digest(tk, ik), solution_sha=digest(got))
        out[label] = res
        print(f"{label}: {json.dumps(res)}")
    return out


def sweep_ptxas(bdir) -> dict:
    """ptxas's registers and spill bytes of the sweep kernels of a
    variant's build (its log)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    log = "".join(f.read_text() for f in pathlib.Path(bdir).glob("*.log"))
    out = {}
    for name, info in cs.ptxas_by_kernel(log).items():
        lab = cs.sweep_label(name)
        if lab:
            out[f"{lab[0]}<{lab[1]}, {lab[2]}>"] = (info.get("registers"),
                                                    info.get("spill_bytes"))
    return out


def edits(dev, reps) -> dict:
    from pangulu_tpu_torch.ops import build
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.tools.probe_products import build_all, use_variant
    for name, (_, eds) in EDITS.items():
        for fname, old, _ in eds:
            if (build.CSRC_DIR / fname).read_text().count(old) != 1:
                raise RuntimeError(f"{name}: edit does not match once in "
                                   f"{fname}: {old!r}")
    dirs = build_all(EDITS)
    out = {name: dict(what=what, ptxas=sweep_ptxas(dirs[name][1]))
           for name, (what, _) in EDITS.items()}
    for name in EDITS:
        print(f"{name}: ptxas {out[name]['ptxas']}")
    use_variant(*dirs["shipped"])
    for ordering in ("rcm", "nd"):
        tk, ik, stab, kw, solve, plain = factored(32, 256, "r32", ordering,
                                                  dev)
        kern = "K3" if ordering == "rcm" else "K5"
        grid_key = "mega_solve" if ordering == "rcm" else "mega_solve_groups"
        for nrhs in (1, 2, 4):
            x = rhs(nrhs, kw, tk.dtype, dev)
            ref = plain(x, tk, ik, stab, **kw).double()
            use_variant(*dirs["shipped"])
            shipped = solve(x, tk, ik, stab, **kw)
            for name in EDITS:
                if name.startswith("k5" if ordering == "rcm" else "k3"):
                    continue
                lib = use_variant(*dirs[name]).lib
                got = solve(x, tk, ik, stab, **kw)
                res = dict(device_ms=device_ms(
                    lambda: solve(x, tk, ik, stab, **kw), reps),
                           cluster=kc.GRID[grid_key]["cluster"],
                           clusters_fit=kc.GRID[grid_key]["clusters_fit"])
                if name == "shipped" or name in DESIGNS:
                    res.update(max_abs_err=float((got.double() - ref).abs()
                                                 .max()),
                               same_bits_as_shipped=bool(torch.equal(
                                   got, shipped)))
                    if not res["same_bits_as_shipped"]:
                        raise AssertionError(f"{name}: {kern} at {nrhs} rhs "
                                             "differs from the shipped bits")
                if name == "timed":
                    import ctypes
                    solve(x, tk, ik, stab, **kw)
                    torch.cuda.synchronize()
                    t = (ctypes.c_longlong * 32)()
                    lib.plu_debug_times.argtypes = [ctypes.c_void_p]
                    if lib.plu_debug_times(t):
                        raise RuntimeError("plu_debug_times failed")
                    if ordering == "rcm":
                        per, names, off = kw["bl"], K3_PHASES, 0
                    else:
                        per, names, off = max(t[31], 1), K5_PHASES, 16
                    res["cycles"] = {n: t[off + k] / per
                                     for k, n in enumerate(names)}
                    res["cycles_per"] = ("level" if ordering == "rcm"
                                         else f"item ({t[31]} items)")
                out[name][f"{kern} {nrhs} rhs"] = res
                print(f"{name} {kern} {nrhs} rhs: {json.dumps(res)}")
        use_variant(*dirs["shipped"])
        del tk, ik, stab
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the tree whose pangulu_tpu_torch is measured")
    ap.add_argument("--edits", action="store_true",
                    help="time this tree's source variants of EDITS")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_solve_sweeps: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = edits(dev, args.reps) if args.edits else cells(dev, args.reps)
    mode = "edits" if args.edits else "cells"
    out = {"probe_solve_sweeps": {"root": str(root), "card": card,
                                  "mode": mode, "results": res}}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
