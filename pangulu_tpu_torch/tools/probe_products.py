#!/usr/bin/env python3
"""Probe of the tensor-core products of K2 and K4 (csrc/tile_gemm.cuh)
on one NVIDIA GPU.  From the root of the repository:

    python3 pangulu_tpu_torch/tools/probe_products.py variants [--out F]
    python3 pangulu_tpu_torch/tools/probe_products.py k6 [--root DIR]

``variants``: each variant is the shipped ``csrc/`` with one textual
edit (VARIANTS below; an edit that no longer matches the sources
raises).  All are built at once, one nvcc each, into
``pangulu_tpu_torch/_build/probe/``.  Then, for each, on poisson3d(32)
nb=128 r32 with rcm and with nd: the f32 kernel factorization's error
against the plain f64 factorization of the same store (max |err| / max
|ref|, beside the f32 plain version's), ms per factorization (CUDA
events, median), the panel and Schur stages' device ms (torch.profiler;
median of TRACES traced factorizations, each one listed too), and
ptxas's registers and spill bytes of the four float product kernels.

``k6``: K6, the f64 chain factorization (K2's double instance), at
poisson2d(16) nb=16 rcm, with the package imported from DIR (default:
this checkout; give an unpacked older tree to compare).  It prints the
CUDA-event ms of one call (median), the host ms to enqueue one call
(no synchronisation), and from one traced call the device busy ms, each
kernel's device ms and each CUDA runtime call's count and host ms: a
call whose enqueue time is about its event time is launch-bound.

Each mode prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]

# name -> (what the edit does, [(file in csrc/, old text, new text)])
VARIANTS = {
    "shipped": ("the shipped sources", []),
    "one_accumulator": (
        "3xTF32 with the three MMAs of every step into the running "
        "accumulator (no per-step zeroed sum and f32 add)",
        [("tile_gemm.cuh",
          "    float d[4] = {0.f, 0.f, 0.f, 0.f};\n"
          "    mma_tf32(d, a.small, b.big);\n"
          "    mma_tf32(d, a.big, b.small);\n"
          "    mma_tf32(d, a.big, b.big);\n"
          "#pragma unroll\n"
          "    for (int i = 0; i < 4; ++i) c[i] += d[i];\n",
          "    mma_tf32(c, a.small, b.big);\n"
          "    mma_tf32(c, a.big, b.small);\n"
          "    mma_tf32(c, a.big, b.big);\n")]),
    "cvt_rna": (
        "the TF32 split rounds with the cvt.rna.tf32.f32 instruction",
        [("tile_gemm.cuh",
          "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n",
          "  uint32_t r;\n"
          "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
          "  return r;\n")]),
    "no_mma": (
        "timing only, results wrong: no MMAs, so the compiler drops the "
        "fragment loads and splits too; left are the indices, the "
        "cp.async staging, the barriers and the stores",
        [("tile_gemm.cuh",
          "    mma_tf32(d, a.small, b.big);\n"
          "    mma_tf32(d, a.big, b.small);\n"
          "    mma_tf32(d, a.big, b.big);\n", "")]),
    "warps8": (
        "8 warps (256 threads) of 32 x 16 warp tiles in place of 4 of "
        "32 x 32",
        [("tile_gemm.cuh", "constexpr int kGemmWarps = 4;",
          "constexpr int kGemmWarps = 8;"),
         ("lu_kernels.cu", "Window<T, kBand, NB, 1, 4>",
          "Window<T, kBand, NB, 1, 8>"),
         ("lu_kernels.cu", "Window<T, NB, kBand, 4, 1>",
          "Window<T, NB, kBand, 4, 2>"),
         ("lu_kernels.cu", "Window<T, kQuad, kQuad, 2, 2>",
          "Window<T, kQuad, kQuad, 2, 4>")]),
    "ring4": (
        "a ring of 4 cp.async slices (3 in flight) in place of 2",
        [("tile_gemm.cuh", "kSmemBytes = 2 * STAGE",
          "kSmemBytes = 4 * STAGE"),
         ("tile_gemm.cuh",
          "    T* sa = smem + (s & 1) * W::STAGE;\n    stage<",
          "    if (s >= nk) {\n      cp_async_commit();\n      return;\n"
          "    }\n    T* sa = smem + (s % 4) * W::STAGE;\n    stage<"),
         ("tile_gemm.cuh",
          "  load(0);\n  for (int s = 0; s < nk; ++s) {\n",
          "  for (int s = 0; s < 3; ++s) load(s);\n"
          "  for (int s = 0; s < nk; ++s) {\n"),
         ("tile_gemm.cuh",
          "    cp_async_wait_all();\n    __syncthreads();\n"
          "    if (s + 1 < nk) load(s + 1);\n"
          "    const T* sa = smem + (s & 1) * W::STAGE;\n",
          "    asm volatile(\"cp.async.wait_group 2;\\n\" ::: \"memory\");\n"
          "    __syncthreads();\n"
          "    load(s + 3);\n"
          "    const T* sa = smem + (s % 4) * W::STAGE;\n"),
         ("tile_gemm.cuh",
          "  __syncthreads();  // the last slice's reads are done\n",
          "  cp_async_wait_all();\n  __syncthreads();\n")]),
    "min_blocks3": (
        "__launch_bounds__(128, 3) on the product kernels: ptxas must "
        "fit 3 blocks an SM",
        [("lu_kernels.cu", "__launch_bounds__(kGemmThreads)",
          "__launch_bounds__(kGemmThreads, 3)")]),
}

PRODUCT_KERNELS = ("panel_kernel", "schur_kernel", "group_panel_kernel",
                   "group_schur_kernel")
# traced factorizations per variant and path; a stage's ms is the median
TRACES = 3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def make_sources(src: pathlib.Path, dst: pathlib.Path, edits) -> None:
    """A copy of csrc/ in dst with the edits applied; every old text must
    occur in its file."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for fname, old, new in edits:
        p = dst / fname
        text = p.read_text()
        if old not in text:
            raise RuntimeError(f"{fname}: edit does not match: {old!r}")
        p.write_text(text.replace(old, new))


def build_all(variants: dict) -> dict:
    """Build every variant's library (``variants``: name -> (what the
    edit does, edits)) at once, one nvcc each, where the build module
    will look for it; returns per variant its csrc and build
    directories."""
    from pangulu_tpu_torch.ops import build

    base = build.BUILD_DIR / "probe"
    dirs, procs = {}, []
    shipped = build.CSRC_DIR
    nvcc = build.find_nvcc()
    for name, (_, edits) in variants.items():
        csrc, bdir = base / name / "csrc", base / name / "build"
        make_sources(shipped, csrc, edits)
        bdir.mkdir(parents=True, exist_ok=True)
        build.CSRC_DIR = csrc
        out = bdir / f"liblu_kernels_{build.source_hash()}.so"
        dirs[name] = (csrc, bdir)
        if not out.exists():
            cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(out),
                   str(csrc / "lu_kernels.cu")]
            procs.append((name, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    build.CSRC_DIR = shipped
    for name, out, p in procs:
        log = p.communicate(timeout=900)[0]
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{log}")
        out.with_suffix(".log").write_text(log)
    return dirs


def use_variant(csrc, bdir):
    """Point the kernel wrappers at a variant's library."""
    from pangulu_tpu_torch.ops import build
    from pangulu_tpu_torch.ops import kernels_cuda as kc

    build.CSRC_DIR, build.BUILD_DIR = csrc, bdir
    kc._library = None
    return kc.library()


def variants(out_path: str | None) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch import InitOptions, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    dirs = build_all(VARIANTS)
    print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s")
    a = poisson3d(32)
    cases = {}
    for ordering in ("rcm", "nd"):
        h = init(a, InitOptions(nb=128, dtype="r32", ordering=ordering,
                                device="cuda"))
        nt, sch = h.blocked.num_tiles, h.schedule
        grouped = ordering == "nd"
        tab = kt.KernelTables.build(
            sch.group_mega_tables(nt) if grouped else sch.mega_tables(nt),
            dev)
        kw = dict(nb=128, bl=sch.block_length)
        store = h.blocked.device_tiles(dev)
        plain = kt.mega_factorize_groups if grouped else kt.mega_factorize
        r64 = plain(store.double(), tab, tol=kt.DEFAULT_TOL[torch.float64],
                    **kw)
        p32 = plain(store.clone(), tab, tol=kt.DEFAULT_TOL[torch.float32],
                    **kw)
        cases[ordering] = dict(
            store=store, tab=tab, nt=nt, grouped=grouped, r64=r64,
            kw=dict(kw, tol=kt.DEFAULT_TOL[torch.float32]),
            plain_err=[cs.rel_err(p32[0][:nt], r64[0][:nt]),
                       cs.rel_err(p32[1], r64[1])])
        del h, p32
    res = {}
    for name, (csrc, bdir) in dirs.items():
        lib = use_variant(csrc, bdir)
        # the float instances these nb=128 runs take (panels: width 128)
        ptx = {}
        for k, v in cs.ptxas_by_kernel(lib.log).items():
            lab = cs.kernel_label(k)
            if lab and lab[0] in PRODUCT_KERNELS and lab[1:] in (
                    ("float", None), ("float", 128)):
                ptx[lab[0]] = [v.get("registers"), v.get("spill_bytes")]
        row = dict(edit=VARIANTS[name][0], ptxas=ptx)
        for ordering, c in cases.items():
            fk = kc.mega_factorize_groups if c["grouped"] else \
                kc.mega_factorize
            tk, ik = fk(c["store"].clone(), c["tab"], **c["kw"])
            nt, r64 = c["nt"], c["r64"]
            ms = cs.cuda_ms(lambda t: fk(t, c["tab"], **c["kw"]),
                            setup=c["store"].clone, reps=7)
            profs = [cs.profile(lambda t: fk(t, c["tab"], **c["kw"]),
                                setup=c["store"].clone)
                     for _ in range(TRACES)]
            stage = {}
            for s in ("panel", "schur"):
                each = [sum(k["device_ms"] for n, k in p["kernels"].items()
                            if n.split("<")[0].endswith(f"{s}_kernel"))
                        for p in profs]
                stage[f"{s}_ms"] = statistics.median(each)
                stage[f"{s}_ms_each"] = each
            row[ordering] = dict(
                kernel_err=[cs.rel_err(tk[:nt], r64[0][:nt]),
                            cs.rel_err(ik, r64[1])],
                plain_err=c["plain_err"], ms=ms, **stage)
            del tk, ik
        res[name] = row
        print(name, json.dumps(row))
    if out_path:
        pathlib.Path(out_path).write_text(json.dumps(res, indent=1))
    return res


def k6(root: str) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from pangulu_tpu_torch import InitOptions, init
    from pangulu_tpu_torch.models import poisson2d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt

    dev = torch.device("cuda", 0)
    h = init(poisson2d(16), InitOptions(nb=16, dtype="r64", ordering="rcm",
                                        device="cuda"))
    nt, sch = h.blocked.num_tiles, h.schedule
    tab = kt.KernelTables.build(sch.mega_tables(nt), dev)
    kw = dict(nb=16, bl=sch.block_length, tol=kt.DEFAULT_TOL[torch.float64])
    store = h.blocked.device_tiles(dev)

    def call(t):
        return kc.mega_factorize(t, tab, **kw)

    ms = [cs.cuda_ms(call, setup=store.clone, reps=20) for _ in range(3)]
    host = []
    for _ in range(20):
        t = store.clone()
        torch.cuda.synchronize()
        s = time.perf_counter()
        call(t)
        host.append((time.perf_counter() - s) * 1e3)
        torch.cuda.synchronize()
    call(store.clone())
    t = store.clone()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        call(t)
        torch.cuda.synchronize()
    spans, kernels, runtime = [], {}, {}
    for e in prof.events():
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            spans.append((lo, hi))
            name = e.name.split("(")[0].removeprefix("void ").split("<")[0]
            k = kernels.setdefault(name, [0, 0.0])
        elif e.name.startswith("cuda"):
            k = runtime.setdefault(e.name, [0, 0.0])
        else:
            continue
        k[0] += 1
        k[1] += (hi - lo) * 1e-3
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return dict(root=str(root), bl=sch.block_length, ms=ms,
                host_enqueue_ms=statistics.median(host),
                device_busy_ms=busy * 1e-3, kernels=kernels,
                runtime=runtime)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("variants", "k6"))
    ap.add_argument("--out", help="variants: also write the results here")
    ap.add_argument("--root", default=str(ROOT),
                    help="k6: the tree whose package to import")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_products: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line())
    res = variants(args.out) if args.mode == "variants" else k6(args.root)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
