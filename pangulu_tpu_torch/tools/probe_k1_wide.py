#!/usr/bin/env python3
"""K1 for tiles wider than 256 (csrc/wide_lu.cuh) on one NVIDIA GPU.
From the root of the repository:

    python3 pangulu_tpu_torch/tools/probe_k1_wide.py [--root DIR] [--out F]
    python3 pangulu_tpu_torch/tools/probe_k1_wide.py --variants [--out F]

Without ``--variants`` it times K1 (``kernels_cuda.getrf_with_inverses``)
of the tree at DIR (default: this one) at nb = 288, 384 and 512, float32
and float64, batch 1 and 4: device ms a call over back-to-back calls
between CUDA events, median of 7, and the K1 and device launches a call.
Run it on two trees in one call, in turns (parent, change, change,
parent), to compare them on one card; ``git archive`` the other tree
into a directory that ``.gitignore`` lists (``.proof/``).

With ``--variants`` it builds this tree's ``csrc/`` as shipped and with
textual edits (VARIANTS; an edit that no longer matches raises), one
nvcc each, all at once, into ``pangulu_tpu_torch/_build/probe_k1_wide/``,
and for each: ptxas's registers and spills of ``lu_wide_kernel``; the
kernel alone (the C entry ``plu_wide_probe``) against its plain twin
(``kernels_torch.k1_wide``) at f32 1e-5 / f64 1e-12; its ms (shipped:
with lookahead 2, 1 and 0 (warps 0-3 update the next panel's stripe, 8
columns each, before warp 0 factors its block; warp 0 alone; none), at
the nbs and batches above; the others with lookahead 2 at nb = 512);
and at nb = 512, batch 1, the clock64 phases of every CTA of the
cluster (cycles a panel, median over the CTAs, and those of the next
panel's owner: the cluster barrier, L11^-1 and U11^-1 loaded, the a_i,
warp 0's stripes (with lookahead, in the next panel's owner, its
diagonal block too), the rest of the panel; and the diagonal block in
its owner).  ``rows64`` runs float tiles on clusters of 64-row CTAs (8
at 512) in place of 32-row ones; ``warp4_idle`` gives no stripe to warp
4, on the diagonal warp's sub-partition, in the next panel's owner;
``nosync_split`` leaves out the named barrier before warp 0 factors
the block (wrong results, timing only).

It prints the card's name and power limit first and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
NBS = (288, 384, 512)
SRC = "wide_lu.cuh"
VARIANTS = {
    "shipped": [],
    "rows64": [("struct WideRows {\n  static constexpr int value = 32;",
                "struct WideRows {\n  static constexpr int value = "
                "sizeof(T) == 4 ? 64 : 32;")],
    # with lookahead, warp 4 (on the diagonal warp's sub-partition) takes
    # no stripe in the next panel's owner
    "warp4_idle": [
        ("    const int q0 = warp;\n"
         "    const int dq = !la ? kWideWarps : warp == 0 ? cnt : "
         "kWideWarps - 1;\n",
         "    const int q0 = !la || warp == 0 ? warp\n"
         "                   : warp == 4      ? cnt\n"
         "                                    : 1 + warp - (warp < 4 ? 1 : "
         "2);\n"
         "    const int dq = !la ? kWideWarps : warp == 0 ? cnt : 6;\n")],
    # the named barrier of warps 0-3 (lookahead 2) skipped: warp 0 factors
    # the block without waiting for warps 1-3's columns (wrong results;
    # the cost of the wait, timing only)
    "nosync_split": [("      asm volatile(\"bar.sync 1, 128;\\n\" ::: "
                      "\"memory\");\n", "")],
}
# variants whose results are wrong by design, timed only
TIMING_ONLY = ("nosync_split",)
PHASES = ("barrier", "diag block loaded", "a_i", "warp 0 stripes",
          "panel end")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def device_ms(fn, n: int = 20, reps: int = 7) -> float:
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


def tiles(dev) -> dict:
    rng = np.random.default_rng(19)
    return {(nb, dt, b): torch.as_tensor(
        rng.standard_normal((b, nb, nb)) + nb * np.eye(nb), dtype=dt,
        device=dev) for nb in NBS for dt in (torch.float32, torch.float64)
        for b in (1, 4)}


def times(dev) -> dict:
    """K1 of the imported tree through its public wrapper."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc

    kc.library()
    out = {}
    for (nb, dt, b), a in tiles(dev).items():
        kc.reset_launch_counts()
        kc.getrf_with_inverses(a)
        counts = (kc.LAUNCHES["getrf_with_inverses"],
                  kc.DEVICE_LAUNCHES["getrf_with_inverses"])
        ms = device_ms(lambda: kc.getrf_with_inverses(a))
        key = f"nb={nb} {str(dt)[6:]} batch {b}"
        out[key] = dict(ms=ms, launches=counts[0], device_launches=counts[1])
        print(f"  {key}: {ms:.4f} ms, {counts[0]} K1 launch(es), "
              f"{counts[1]} device launch(es)")
    return out


def ptxas_wide(log: str) -> dict:
    """Registers and spill bytes of each lu_wide_kernel instance."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m[1] if "lu_wide_kernel" in m[1] else None
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(cur, {})["spill_bytes"] = int(m[1]) + int(m[2])
    return out


def variants(dev) -> dict:
    from pangulu_tpu_torch.ops import build
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt

    base = ROOT / "pangulu_tpu_torch" / "_build" / "probe_k1_wide"
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
        bdir = d / "_build"
        bdir.mkdir(parents=True, exist_ok=True)
        build.CSRC_DIR = d / "csrc"
        out = bdir / f"liblu_kernels_{build.source_hash()}.so"
        dirs[name] = (d / "csrc", bdir, out)
        jobs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
             str(d / "csrc" / "lu_kernels.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in jobs.items():
        logs[name] = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n"
                               f"{logs[name][-3000:]}")
        dirs[name][2].with_suffix(".log").write_text(logs[name])
    print(f"built {len(jobs)} variants in {time.perf_counter() - t0:.1f} s")
    data = tiles(dev)
    result, bad = {}, []
    for name in VARIANTS:
        build.CSRC_DIR, build.BUILD_DIR, _ = dirs[name]
        kc._library = None
        lib = kc.library().lib
        row = {"ptxas": ptxas_wide(logs[name]), "ms": {}, "max_err": {},
               "cycles": {}}
        print(f"{name}: ptxas {row['ptxas']}")
        nslot = lib.plu_wide_clk_slots()

        def run(a, la, clk=None):
            f, li, ui = (torch.empty_like(a) for _ in range(3))
            s = "f32" if a.dtype == torch.float32 else "f64"
            rc = getattr(lib, f"plu_wide_probe_{s}")(
                dev.index, a.data_ptr(), f.data_ptr(), li.data_ptr(),
                ui.data_ptr(), a.shape[0], a.shape[-1],
                float(kt.DEFAULT_TOL[a.dtype]), la,
                clk.data_ptr() if clk is not None else None,
                torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"plu_wide_probe: CUDA error {rc}")
            return f, li, ui

        for (nb, dt, b), a in data.items():
            if name == "rows64" and dt == torch.float64:
                continue
            if name != "shipped" and nb != 512:
                continue
            for la in ((2, 1, 0) if name == "shipped" else (2,)):
                got = run(a, la)
                ref = kt.k1_wide(a)
                err = [float((g - r).abs().max()) for g, r in zip(got, ref)]
                tol = 1e-5 if dt == torch.float32 else 1e-12
                ok = all(torch.allclose(g, r, rtol=tol, atol=tol)
                         for g, r in zip(got, ref))
                key = f"nb={nb} {str(dt)[6:]} batch {b} lookahead {la}"
                row["max_err"][key] = max(err)
                row["ms"][key] = device_ms(lambda: run(a, la))
                print(f"  {key}: {row['ms'][key]:.4f} ms, max |err| of f, "
                      f"L^-1, U^-1 against the twin {err[0]:.2e} "
                      f"{err[1]:.2e} {err[2]:.2e} {'ok' if ok else 'FAIL'}")
                if not ok and name not in TIMING_ONLY:
                    bad.append(f"{name} {key}")
        for dt in (torch.float32, torch.float64):
            if name == "rows64" and dt == torch.float64:
                continue
            a = data[(512, dt, 1)]
            for la in ((2, 1, 0) if name == "shipped" else (2,)):
                clk = torch.zeros(16 * nslot, dtype=torch.int64, device=dev)
                run(a, la, clk)
                torch.cuda.synchronize()
                c = clk.view(16, nslot).cpu().numpy()
                plan = (ctypes.c_int * 4)()
                lib.plu_wide_plan(512, a.element_size(), plan)
                ctas, rows = plan[0], plan[1]
                panels = []
                for p in range(16):
                    o = p * 32 // rows  # the panel's owner
                    t = c[:ctas, 2 + 8 * p:2 + 8 * p + 8].astype(np.int64)
                    ph = {ph: int(np.median(t[:, q + 1] - t[:, q]))
                          for q, ph in enumerate(PHASES)}
                    ph["diag (owner)"] = int(c[o, 2 + 8 * p + 7]
                                             - c[o, 2 + 8 * p + 6])
                    if p < 15:  # the phases of the next panel's owner
                        o1 = (p + 1) * 32 // rows
                        ph["next owner"] = {
                            ph: int(t[o1, q + 1] - t[o1, q])
                            for q, ph in enumerate(PHASES)}
                    ph["panel"] = int(np.median(
                        (c[:ctas, 2 + 8 * (p + 1)] if p < 15
                         else c[:ctas, nslot - 2]) - t[:, 0]))
                    panels.append(ph)
                key = f"{str(dt)[6:]} lookahead {la}"
                row["cycles"][key] = dict(
                    load=int(np.median(c[:ctas, 1] - c[:ctas, 0])),
                    loop=int(np.median(c[:ctas, nslot - 2] - c[:ctas, 1])),
                    store=int(np.median(c[:ctas, nslot - 1]
                                        - c[:ctas, nslot - 2])),
                    panels=panels)
                cy = row["cycles"][key]
                print(f"  cycles at nb=512 batch 1, {key}: load {cy['load']}"
                      f", panels {cy['loop']}, store {cy['store']}; a panel "
                      f"(median over CTAs): " + "; ".join(
                          f"{i}: " + ", ".join(f"{k} {v}" for k, v in
                                               ph.items())
                          for i, ph in enumerate(panels) if i in (1, 8, 14)))
        result[name] = row
    if bad:
        raise RuntimeError(f"disagree with the twin: {bad}")
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the tree whose K1 to time (default: this one)")
    ap.add_argument("--variants", action="store_true",
                    help="this tree's design variants and clock64 phases")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k1_wide: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root if not args.variants else ROOT))
    print(card_line())
    dev = torch.device("cuda", 0)
    result = {"root": str(root), "card": card_line()}
    if args.variants:
        result["variants"] = variants(dev)
    else:
        print(f"K1 of {root}")
        result["times"] = times(dev)
    line = json.dumps({"probe_k1_wide": result})
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
