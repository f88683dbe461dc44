#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pangulu_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

From the root of the repository, on a machine with a CUDA card and the
CUDA toolkit (nvcc).  It

  1. prints the card's name and power limit and builds the three CUDA
     kernels from pangulu_tpu_torch/csrc (timed);
  2. holds each kernel against its plain PyTorch version on the same
     CUDA tensors: K1 getrf_with_inverses at nb=128 (f32, f64); K2
     mega_factorize and K3 mega_solve on poisson2d(16) nb=16 and
     poisson3d(32) nb=128 (r32, rcm), printing max errors and CUDA-event
     times beside the plain version's;
  3. drives the main path, init -> gstrf -> gstrs on poisson3d(32) with
     nb=128, r32, rcm, device="cuda", with every launch count zeroed
     before and read after (each must be > 0), then times the
     factorization and the solve (median of several, CUDA events);
  4. solves the reference's config 1, trefethen(20) nb=10 r64;
  5. with --profile, traces one factorization and one solve of step 3
     with torch.profiler and prints, per phase, each kernel's launches
     and device time, the host wall time and the device's idle share;
  6. prints one JSON line of per-kernel results, then the last line
     {"ok": true, "device": {...}}.

Any failure raises and exits non-zero.  Without a CUDA device, or
without the package beside this file, it prints no result and exits 2.
Details go to pangulu_tpu_torch/_build/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
SRC = "pangulu_tpu_torch/csrc/lu_kernels.cu"
REPLACES = {
    "getrf_with_inverses": "pangulu_tpu/ops/kernels_pallas.py:599",
    "mega_factorize": "pangulu_tpu/ops/kernels_pallas.py:1187",
    "mega_solve": "pangulu_tpu/ops/kernels_pallas.py:2155",
}
# Tolerances (the JAX package's own contract, ROADMAP.md "Tolerances",
# tests/test_mega.py:31,82): rtol, atol.
TOL_F32 = (1e-5, 1e-5)
TOL_SOLVE_F32 = (1e-4, 1e-5)
TOL_F64 = (1e-12, 1e-12)


def fail(msg: str) -> None:
    raise AssertionError(msg)


def compare(name, got, ref, rtol, atol):
    """max |got - ref| and max relative error; raise unless
    |got - ref| <= atol + rtol |ref| everywhere and all is finite."""
    got64, ref64 = got.double(), ref.double()
    if not torch.isfinite(got64).all():
        fail(f"{name}: non-finite values")
    diff = (got64 - ref64).abs()
    bound = atol + rtol * ref64.abs()
    abs_err = float(diff.max())
    rel_err = float((diff / ref64.abs().clamp_min(1e-30)).max())
    ok = bool((diff <= bound).all())
    print(f"  {name}: max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
          f"(rtol={rtol:g}, atol={atol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with the plain version")
    return abs_err


def cuda_ms(fn, setup=lambda: None, reps=5, warmup=1) -> float:
    """Median CUDA-event time of fn(setup()) in ms; setup runs outside
    the timed region."""
    for _ in range(warmup):
        fn(setup())
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        arg = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile(fn, setup=lambda: None) -> dict:
    """Trace one call of fn(setup()) after a warm-up: per kernel name its
    launches and device ms, the host wall ms of the call (launch to
    synchronise), the device's busy ms (union of kernel intervals) and
    its idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn(setup())
    arg = setup()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        spans.append((lo, hi))
        name = e.name.split("(")[0].removeprefix("void ")
        k = kernels.setdefault(name, {"launches": 0, "device_ms": 0.0})
        k["launches"] += 1
        k["device_ms"] += (hi - lo) * 1e-3
    if not spans:
        fail("the profiler saw no device activity")
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy_ms = busy * 1e-3
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, kernels=kernels)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one factorization and one solve of the "
                         "slice with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "pangulu_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: package pangulu_tpu_torch not found beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
    from pangulu_tpu_torch.models import poisson2d, poisson3d, trefethen
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.utils.perf import residual_norm

    # true fp32 everywhere on the f32 path (no TF32 in plain matmuls)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    lib = kc.library()
    print(f"kernel build: {lib.build_seconds:.1f} s -> {lib.path.name}")
    detail = {"card": card, "build_seconds": lib.build_seconds,
              "ptxas": [ln for ln in lib.log.splitlines()
                        if "registers" in ln or "spill" in ln]}
    kernels = {}

    # ---- K1 ------------------------------------------------------------
    print("K1 getrf_with_inverses (nb=128, one tile as on the main path)")
    rng = np.random.default_rng(0)
    base = rng.standard_normal((128, 128)) + 128 * np.eye(128)
    for dt, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        a = torch.as_tensor(base, dtype=dt, device=dev)
        got = kc.getrf_with_inverses(a)
        ref = kt.getrf_with_inverses(a)
        err = max(compare(f"{dt} {n}", g, r, *tol)
                  for n, g, r in zip(("f", "linv", "uinv"), got, ref))
        ms = cuda_ms(lambda _: kc.getrf_with_inverses(a), reps=20)
        pms = cuda_ms(lambda _: kt.getrf_with_inverses(a), reps=5)
        print(f"  {dt}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
        detail[f"K1_{dt}"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms}
        if dt == torch.float32:
            kernels["getrf_with_inverses"] = dict(max_abs_err=err, ms=ms,
                                                  plain_ms=pms)

    # ---- K2, K3 ----------------------------------------------------------
    for label, gen, nb in (("poisson2d(16)", lambda: poisson2d(16), 16),
                           ("poisson3d(32)", lambda: poisson3d(32), 128)):
        print(f"K2/K3 on {label}, nb={nb}, r32, rcm")
        a = gen()
        h = init(a, InitOptions(nb=nb, dtype="r32", ordering="rcm",
                                device="cuda"))
        blk, sch = h.blocked, h.schedule
        nt, bl = blk.num_tiles, sch.block_length
        ftab = kt.KernelTables.build(
            sch.mega_tables(nt, uch=kt.MEGA_UCH), dev)
        stab = kt.KernelTables.build(sch.mega_solve_tables(nt), dev)
        tol = kt.DEFAULT_TOL[torch.float32]
        t0 = blk.device_tiles(dev)
        kw = dict(nb=nb, tol=tol, bl=bl)
        tk, ik = kc.mega_factorize(t0.clone(), ftab, **kw)
        tp, ip = kt.mega_factorize(t0.clone(), ftab, **kw)
        e2 = max(compare("tiles", tk[:nt], tp[:nt], *TOL_F32),
                 compare("invs", ik, ip, *TOL_F32))
        b = a.to_scipy() @ np.ones(a.n)
        x = torch.zeros((2, bl + 1, nb), dtype=torch.float32, device=dev)
        x[0, :bl].view(-1)[:a.n] = torch.as_tensor(b, device=dev)
        x[1] = 2 * x[0]
        skw = dict(nb=nb, bl=bl)
        e3 = max(compare(f"solve nrhs={r}", kc.mega_solve(
                     x[:r].contiguous(), tk, ik, stab, **skw),
                     kt.mega_solve(x[:r].contiguous(), tk, ik, stab, **skw),
                     *TOL_SOLVE_F32) for r in (1, 2))
        fms = cuda_ms(lambda t: kc.mega_factorize(t, ftab, **kw),
                      setup=t0.clone)
        fpms = cuda_ms(lambda t: kt.mega_factorize(t, ftab, **kw),
                       setup=t0.clone, reps=2)
        x1 = x[:1].contiguous()
        sms = cuda_ms(lambda _: kc.mega_solve(x1, tk, ik, stab, **skw),
                      reps=10)
        spms = cuda_ms(lambda _: kt.mega_solve(x1, tk, ik, stab, **skw),
                       reps=3)
        print(f"  mega_factorize: kernel {fms:.3f} ms, plain {fpms:.3f} ms")
        print(f"  mega_solve (1 rhs): kernel {sms:.3f} ms, plain "
              f"{spms:.3f} ms")
        detail[f"K2K3_{label}"] = dict(
            nb=nb, bl=bl, tiles=nt, k2_max_abs_err=e2, k3_max_abs_err=e3,
            k2_ms=fms, k2_plain_ms=fpms, k3_ms=sms, k3_plain_ms=spms)
        if nb == 128:
            kernels["mega_factorize"] = dict(max_abs_err=e2, ms=fms,
                                             plain_ms=fpms)
            kernels["mega_solve"] = dict(max_abs_err=e3, ms=sms,
                                         plain_ms=spms)
        del h, t0, tk, tp, ik, ip
        torch.cuda.empty_cache()

    # ---- the main path ---------------------------------------------------
    print("slice: init -> gstrf -> gstrs, poisson3d(32), nb=128, r32, rcm, "
          "cuda")
    a = poisson3d(32)
    b = a.to_scipy() @ np.ones(a.n)
    kc.reset_launch_counts()
    h = init(a, InitOptions(nb=128, dtype="r32", ordering="rcm",
                            device="cuda", check=True))
    gstrf(h)
    x = gstrs(h, b)
    launches = dict(kc.LAUNCHES)
    print(f"  launches: {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was not launched: {launches}")
    fres = h.perf.kernels["gstrf_residual"]
    sres = residual_norm(a.to_scipy(), x, b)
    print(f"  gstrf residual ||L(U1)-A1||/||A1|| = {fres:.3e} (< 1e-5)")
    print(f"  solve residual after refine = {sres:.3e} (< 1e-10)")
    if x.shape != (a.n,) or not np.isfinite(x).all():
        fail("solution has the wrong shape or non-finite values")
    if not fres < 1e-5:
        fail("gstrf residual too large")
    if not sres < 1e-10:
        fail("solve residual too large")
    fac, ts = h._factorizer, h._trisolver
    fms = cuda_ms(lambda t: fac.factorize(t, sync=False),
                  setup=lambda: h.blocked.device_tiles(dev), reps=7)
    xb = ts.blockify_rhs(h.reordering.transform_b(b.astype(np.float32)))
    sms = cuda_ms(lambda _: ts.solve_blocked(h.factor_tiles, xb), reps=7)
    flops = h.schedule.flop_estimate()
    gflops = flops / (fms * 1e-3) / 1e9
    print(f"  {fms:.3f} ms per factorization, {sms:.3f} ms per solve, "
          f"{gflops:.1f} GFLOPS (dense-tile model, {flops:.3e} flop)")
    detail["slice"] = dict(launches=launches, gstrf_residual=fres,
                           solve_residual=sres, ms_per_factorization=fms,
                           ms_per_solve=sms, gflops_dense=gflops,
                           flops=flops, tiles=h.blocked.num_tiles,
                           bl=h.schedule.block_length)
    if args.profile:
        prof = {"gstrf": profile(lambda t: fac.factorize(t, sync=False),
                                 setup=lambda: h.blocked.device_tiles(dev)),
                "gstrs": profile(
                    lambda _: ts.solve_blocked(h.factor_tiles, xb))}
        for phase, p in prof.items():
            print(f"  profile {phase}: wall {p['wall_ms']:.3f} ms, device "
                  f"busy {p['busy_ms']:.3f} ms, idle share "
                  f"{p['idle_share']:.3f}")
            for name, k in sorted(p["kernels"].items(),
                                  key=lambda kv: -kv[1]["device_ms"]):
                print(f"    {name}: {k['launches']} launches, "
                      f"{k['device_ms']:.3f} device ms")
        detail["profile"] = prof
    del h, fac, ts
    torch.cuda.empty_cache()

    # ---- r64: the reference's config 1 ------------------------------------
    print("r64: trefethen(20), nb=10, cuda")
    a = trefethen(20)
    b = a.to_scipy() @ np.ones(a.n)
    h = init(a, InitOptions(nb=10, dtype="r64", device="cuda"))
    gstrf(h)
    x = gstrs(h, b)
    rres = residual_norm(a.to_scipy(), x, b)
    print(f"  solve residual = {rres:.3e} (< 1e-12)")
    if not rres < 1e-12:
        fail("r64 residual too large")
    detail["r64_trefethen20_residual"] = rres

    out = {"kernels": [
        dict(name=n, route="cuda", source=SRC, replaces=REPLACES[n],
             launches=launches[n], **kernels[n])
        for n in ("getrf_with_inverses", "mega_factorize", "mega_solve")]}
    detail["kernels"] = out["kernels"]
    od = ROOT / "pangulu_tpu_torch" / "_build"
    od.mkdir(parents=True, exist_ok=True)
    (od / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(json.dumps(out))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
