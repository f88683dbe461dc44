#!/usr/bin/env python3
"""K1 above nb = 512 (csrc/wide_lu.cuh: the flow kernel up to W_T, the
recursion above) on one NVIDIA GPU.  From the root of the repository:

    python3 pangulu_tpu_torch/tools/probe_k1_wide.py [--root DIR] [--out F]
    python3 pangulu_tpu_torch/tools/probe_k1_wide.py --paths [--root DIR]
    python3 pangulu_tpu_torch/tools/probe_k1_wide.py --variants [--out F]
    python3 pangulu_tpu_torch/tools/probe_k1_wide.py --zero-pivots [--out F]

Without ``--variants`` it times K1 (``kernels_cuda.getrf_with_inverses``)
of the tree at DIR (default: this one) at nb = 640, 768, 1024, 1088,
1120 and 1408 (ROOT_NBS), float32 and float64, batch 1 and 4: device ms
a call over back-to-back calls between CUDA events, median of 7, and
the K1 and device launches a call.  Run it on two trees in one call,
in turns (parent, change, change, parent), to compare them on one card;
``git archive`` the other tree into a directory that ``.gitignore``
lists (``.proof/``).

With ``--paths`` it drives poisson3d(32) at nb = 1024 (ALL_PATHS: the
fused engine at r32 and r64, rcm, and superfused at r32 and r64, nd;
chip_smoke.py takes PATHS, all but the last) with the tree at DIR
(:func:`paths`): K1 launches and device launches a factorization (and
this tree's ``kernels_cuda.k1_device_launches`` for the batches the
schedule gives K1, where DIR has it),
the refined solve's residual, the factor against the same engine with
K1's plain twin, ms per factorization (CUDA events, median of 5) and one
traced factorization (K1's device ms and share, busy, wall, idle).

With ``--zero-pivots`` it holds K1 (this tree) on float32 tiles with
zero pivots at 0 and wide_split(nb) (``testing.wide_tiny_pivot_tile``,
three seeds, nb = 640, 768, 1024, 1088, W_T and W_T + 32) to its plain
twin and to the float64 twin (:func:`zero_pivots`): per output, the
largest |kernel - twin| over the 1e-5 contract's bound and over
``BLOCKED_TOL``'s, for U^-1 also ``testing.zero_pivot_uinv_errors`` (the
column at the second pivot apart, its residual in U·U^-1), and the
kernel's and the f32 twin's largest error against the f64 twin relative
to its largest entry (true f32).

With ``--variants`` it builds this tree's ``csrc/`` as shipped and with
textual edits of the flow kernel's design (VARIANTS; an edit that no
longer matches the source once raises), one nvcc each, all at once, into
``pangulu_tpu_torch/_build/probe_k1_wide/``, and for each: ptxas's
registers and spills of ``lu_flow_kernel``; the flow kernel alone (the C
entry ``plu_flow_probe``) against its plain twin
(``kernels_torch.getrf_with_inverses_blocked``) at f32 1e-5 / f64 1e-12
at each nb it takes of 512, 640, 768, 1024, 1088; its ms there, batch 1;
and at the widest of those, batch 1, the clock64 phases of every CTA of
the tile (cycles a panel, median over the CTAs, and the chain of the
next panel's owner: the diagonal block's flag, L11^-1 and U11^-1 loaded,
the a_i, the lookahead stripe, the diagonal block).  The variants:
``panel_flags`` (a reader waits for all of a panel's stripes at once, as
one flag a panel would), ``warp_r`` (each warp forms its stripes of R
from the staging rows, lu_wide_kernel's way, in place of one CTA a
stripe), ``rows32_f64`` (double tiles on CTAs of 32 rows: W_T falls to
512, so timed at 512 only), ``diag_shared`` / ``diag_alone`` (warp 4
of the next panel's owner, on the diagonal warp's sub-partition, takes
its share of stripes at every width, or none at every width; shipped:
none up to 28 panels in float, at every width in double).

It prints the card's name and power limit first and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
NBS = (640, 768, 1024, 1088)
# --root: NBS, 1120 (W_T in float64) and 1408 (W_T in float32)
ROOT_NBS = (*NBS, 1120, 1408)
VARIANT_NBS = (512, *NBS)
SRC = "wide_lu.cuh"

# The designs the flow kernel did not keep, as edits of lu_flow_kernel
# (old text, new text): a reader that waits for all of a panel's
# stripes (and, before its first stripe, all of its R) at once, as one
# flag a panel would; R formed by each warp from the staging rows, as
# lu_wide_kernel does, in place of one CTA a stripe.
_STRIPE_BODY = """          T rv[C::KS][4][C::BE];
          if (s == p) {
            lb_stripe<T, RPC, 4>(rv, Lb, k0, c);
          } else {
            flow_wait(rflag(p, s), ep);
            flow_load_stripe<T, RPC, 4>(rv, LI + (size_t)k0 * ld, ld, k0, c,
                                        n);
          }
          flow_apply<T, RPC, 4>(W, ldw, Ab, rv, F, ld, r0, k0, lr, mine, s, p,
                                c, n);
"""
PANEL_FLAGS = [
    ("""      flow_wait(flag(p, p, 0), ep);
      tick(tk + 1);
""", """      flow_wait(flag(p, p, 0), ep);
      for (int s = 0; s < npan; ++s)
        for (int h = 0; h < H; ++h) flow_wait(flag(p, s, h), ep);
      tick(tk + 1);
"""),
    ("""      // The stripes, each once its flag is set:""",
     """      for (int s = 0; s < npan; ++s)
        if (s != p && !(next && s == p + 1)) flow_wait(rflag(p, s), ep);
      // The stripes, each once its flag is set:"""),
]
WARP_R = [
    ("if (warp == 0 && half == 0 && sr != p && sr != p + 1) {",
     "if (false) {"),
    ("const bool form = half == 0;", "const bool form = false;"),
    (_STRIPE_BODY, """          if (s != p)
            for (int h = 0; h < H; ++h) flow_wait(flag(p, s, h), ep);
          wide_stripe<T, RPC, 4>(W, ldw, Lb, Ab, Rw, F, S, ld, r0, k0, lr,
                                 mine, s, p, c, n);
"""),
]
VARIANTS = {
    "shipped": [],
    "panel_flags": PANEL_FLAGS,
    "warp_r": WARP_R,
    "rows32_f64": [("static constexpr int value = sizeof(T) == 4 ? 32 : 16;",
                    "static constexpr int value = 32;")],
}
PHASES = ("LU", "a_i", "lookahead", "diag")


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


def tile(nb: int, dt, batch: int, dev, seed: int = 24) -> torch.Tensor:
    rng = np.random.default_rng(seed + nb)
    return torch.as_tensor(rng.standard_normal((batch, nb, nb))
                           + nb * np.eye(nb), dtype=dt, device=dev)


def times(dev) -> dict:
    """K1 of the imported tree through its public wrapper."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc

    kc.library()
    out = {}
    for nb in ROOT_NBS:
        for dt in (torch.float32, torch.float64):
            for b in (1, 4):
                a = tile(nb, dt, b, dev)
                kc.reset_launch_counts()
                kc.getrf_with_inverses(a)
                counts = (kc.LAUNCHES["getrf_with_inverses"],
                          kc.DEVICE_LAUNCHES["getrf_with_inverses"])
                ms = device_ms(lambda: kc.getrf_with_inverses(a))
                key = f"nb={nb} {str(dt)[6:]} batch {b}"
                out[key] = dict(ms=ms, launches=counts[0],
                                device_launches=counts[1])
                print(f"  {key}: {ms:.4f} ms, {counts[0]} K1 launch(es), "
                      f"{counts[1]} device launch(es)")
    return out


# (label, dtype, ordering, dispatch) of the paths at PATH_NB
PATHS = (("fused_r32_rcm", "r32", "rcm", "fused"),
         ("fused_r64_rcm", "r64", "rcm", "fused"),
         ("superfused_r32_nd", "r32", "nd", "superfused"))
ALL_PATHS = (*PATHS, ("superfused_r64_nd", "r64", "nd", "superfused"))
PATH_NB = 1024
# K1's kernels in a trace (every tree: the register-tile, cluster, wide
# cluster and flow kernels and the recursion's products and copies)
K1_KERNELS = ("getrf_inv_kernel", "lu_cluster_kernel", "lu_wide_kernel",
              "lu_flow_kernel", "wide_gemm_kernel", "wide_copy_kernel")


def k1_in_trace(kernels: dict) -> dict:
    """K1's launches and device ms among a trace's kernels."""
    k1 = [k for n, k in kernels.items() if any(x in n for x in K1_KERNELS)]
    return dict(launches=sum(k["launches"] for k in k1),
                device_ms=sum(k["device_ms"] for k in k1))


def paths(dev, nx: int = 32, nb: int = PATH_NB, trace=None,
          factor_residual=None, which=PATHS) -> dict:
    """poisson3d(nx) at nb through each of ``which`` with the imported
    tree: init, then the factorization with the launch counts zeroed
    before and read after (and the K1 device launches that
    ``kernels_cuda.k1_device_launches`` gives the schedule's batches, a
    level's one tile or a super-level's members, where the tree has it),
    gstrs (the default refinement) and its residual, the
    factor against the same engine with kernels_torch.k1_wide as its
    diagonal step on the same store (the largest difference relative to
    the largest entry), ms per factorization (CUDA events, median of 5);
    with ``trace`` (a function of (fn, setup) returning a dict with
    "kernels", "busy_ms", "wall_ms", "idle_share", as chip_smoke.profile
    does) one traced factorization, K1's device ms and share of it; with
    ``factor_residual`` (of the handle and its factor tiles) the gstrf
    residual."""
    import dataclasses

    from pangulu_tpu_torch import InitOptions, gstrs, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.ops import interface
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.utils.perf import residual_norm

    a = poisson3d(nx)
    s = a.to_scipy()
    b = s @ np.ones(a.n)
    cuda = interface.get_backend("cuda")
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    mirror = getattr(kc, "k1_device_launches", None)
    out = {}
    for label, dtype, ordering, dispatch in which:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        h = init(a, InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                device=str(dev)))
        init_s = time.perf_counter() - t0
        fac = LUFactorizer(h.blocked, h.schedule, device=dev,
                           dispatch=dispatch, backend="cuda")
        kc.reset_launch_counts()
        tiles = fac.factorize()
        torch.cuda.synchronize()
        launched = dict(kc.LAUNCHES)
        dev_k1 = kc.DEVICE_LAUNCHES["getrf_with_inverses"]
        batches = ([len(m) for m in h.schedule.superlevels()]
                   if dispatch == "superfused"
                   else [1] * h.schedule.block_length)
        want = None if mirror is None else sum(
            mirror(nb, b, h.blocked.torch_dtype, sms) for b in batches)
        plain = LUFactorizer(h.blocked, h.schedule, device=dev,
                             dispatch=dispatch,
                             backend=dataclasses.replace(
                                 cuda, diag_factor_invert=kt.k1_wide))
        nt = h.blocked.num_tiles
        ref = plain.factorize()[:nt].double()
        diff = (tiles[:nt].double() - ref).abs()
        row = dict(bl=h.schedule.block_length, tiles=nt, init_s=init_s,
                   engine=fac.dispatch, launches=launched,
                   k1_device_launches=dev_k1,
                   k1_expected_device_launches=want,
                   largest_batch=max(batches),
                   superlevels=len(h.schedule.superlevels()),
                   max_abs_err_vs_twin=float(diff.max()),
                   rel_err_vs_twin=float(diff.max() / ref.abs().max()))
        del ref, diff, plain
        if factor_residual is not None:
            row["gstrf_residual"] = factor_residual(h, tiles)
        h._factorizer, h.factor_tiles, h._trisolver = fac, tiles, None
        x = gstrs(h, b)
        row["residual"] = residual_norm(s, x, b)
        row["finite"] = bool(np.isfinite(x).all())

        def setup():
            return h.blocked.device_tiles(dev)

        def factor(t):
            return fac.factorize(t, sync=False)

        factor(setup())
        torch.cuda.synchronize()
        ms = []
        for _ in range(5):
            t = setup()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            factor(t)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        row["ms_per_factorization"] = statistics.median(ms)
        if trace is not None:
            tr = trace(factor, setup)
            k1 = k1_in_trace(tr["kernels"])
            row.update(trace_wall_ms=tr["wall_ms"],
                       trace_busy_ms=tr["busy_ms"],
                       idle_share=tr["idle_share"],
                       k1_traced_launches=k1["launches"],
                       k1_device_ms=k1["device_ms"],
                       k1_share=k1["device_ms"] / tr["busy_ms"])
        out[label] = row
        print(f"  {label}: {row['engine']}, {launched['getrf_with_inverses']}"
              f" K1 launch(es), {dev_k1} device launch(es), "
              f"{row['superlevels']} super-levels, {nt} tiles; against "
              f"the twin {row['rel_err_vs_twin']:.2e}; residual "
              f"{row['residual']:.2e}; {row['ms_per_factorization']:.3f} "
              "ms per factorization" + (
                  f"; traced: K1 {row['k1_device_ms']:.3f} of "
                  f"{row['trace_busy_ms']:.3f} busy ms "
                  f"({row['k1_share']:.1%}), wall {row['trace_wall_ms']:.3f},"
                  f" idle {row['idle_share']:.3f}" if trace else ""))
        del h, fac, tiles
    return out


def profile(fn, setup) -> dict:
    """One traced call fn(setup()) after a warm-up: per kernel its
    launches and device ms, the host wall ms (launch to synchronise),
    busy ms (the union of kernel intervals) and the idle share."""
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
        wall = (time.perf_counter() - t0) * 1e3
    spans, kernels = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = kernels.setdefault(e.name.split("(")[0], {"launches": 0,
                                                      "device_ms": 0.0})
        k["launches"] += 1
        k["device_ms"] += (e.time_range.end - e.time_range.start) * 1e-3
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy *= 1e-3
    return dict(kernels=kernels, wall_ms=wall, busy_ms=busy,
                idle_share=1.0 - busy / wall)


def zero_pivots(dev, seeds=(18, 5, 7)) -> dict:
    """K1 on float32 zero-pivot tiles against its twin and the f64 twin
    (the module docstring's ``--zero-pivots``)."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.testing import (BLOCKED_TOL, wide_tiny_pivot_tile,
                                           zero_pivot_uinv_errors)

    def ratio(g, r, rtol, atol):
        d = (g.double() - r.double()).abs()
        return float((d / (atol + rtol * r.double().abs())).max())

    wt = kc.FLOW_MAX_NB[torch.float32]
    out = {}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        for nb in (*NBS, 1120, wt, wt + 32):
            x = wide_tiny_pivot_tile(nb, rng)
            a = torch.as_tensor(x, dtype=torch.float32, device=dev)
            ref = kt.k1_wide(torch.as_tensor(x, device=dev))
            got, twin = kc.getrf_with_inverses(a), kt.k1_wide(a)
            row = {"uinv_split": zero_pivot_uinv_errors(
                got[0], got[2], twin[2], (1e-5, 1e-5))}
            for n, g, t, r, bt in zip(("f", "linv", "uinv"), got, twin, ref,
                                      BLOCKED_TOL[torch.float32]):
                scale = r.abs().max()
                row[n] = dict(
                    over_contract=ratio(g, t, 1e-5, 1e-5),
                    over_blocked_tol=ratio(g, t, *bt),
                    kernel_vs_f64=float((g.double() - r).abs().max() / scale),
                    twin_vs_f64=float((t.double() - r).abs().max() / scale))
            out[f"seed {seed} nb={nb}"] = row
            print(f"  seed {seed} nb={nb}: " + "; ".join(
                f"{n} {v['over_contract']:.2f} / {v['over_blocked_tol']:.2f} "
                f"of the bounds, against f64 kernel {v['kernel_vs_f64']:.1e} "
                f"twin {v['twin_vs_f64']:.1e}" for n, v in row.items()
                if n != "uinv_split") + "; uinv split: " + ", ".join(
                f"{k} {v:.3g}" for k, v in row["uinv_split"].items()))
    return out


def ptxas_flow(log: str) -> dict:
    """Registers and spill bytes of each lu_flow_kernel instance."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = m[1] if "lu_flow_kernel" in m[1] else None
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


def variant_edits(src: str) -> dict:
    """VARIANTS, and the widths up to which warp 4 of the next panel's
    owner leaves the diagonal block alone (FlowDiagAlone, read from
    ``src``) set to none and to all."""
    old = re.search(r"static constexpr int panels = sizeof\(T\) == 4 \? "
                    r"\d+ : \d+;", src)
    if not old:
        raise RuntimeError(f"FlowDiagAlone not found in {SRC}")
    out = dict(VARIANTS)
    for label, v in (("diag_shared", 0), ("diag_alone", 64)):
        out[label] = [(old[0], f"static constexpr int panels = {v};")]
    return out


def phases(c: np.ndarray, npan: int, h: int) -> dict:
    """Cycles a panel (median over CTAs) and the next owner's chain from
    the clock64 readings ``c`` [ctas, slots] of one tile."""
    slots = c.shape[1]
    per = c[:, 2 + 8 * np.arange(1, npan)] - c[:, 2 + 8 * np.arange(npan - 1)]
    out = dict(panel=int(np.median(per)),
               tile=int(np.median(c[:, slots - 1] - c[:, 0])))
    chain = {k: [] for k in PHASES}
    for p in range(1, npan - 1):
        t = c[(p + 1) * h, 2 + 8 * p:2 + 8 * p + 8]
        d = c[(p + 1) * h, 2 + 8 * (p + 1):2 + 8 * (p + 1) + 8]
        for k, v in zip(PHASES, (t[2] - t[1], t[3] - t[2], d[6] - t[3],
                                 d[7] - d[6])):
            chain[k].append(int(v))
    out["next_owner"] = {k: int(np.median(v)) for k, v in chain.items()}
    return out


def variants(dev) -> dict:
    from pangulu_tpu_torch.ops import build
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.tools.variants import build_variants

    shipped_src = (build.CSRC_DIR / SRC).read_text()
    edits = variant_edits(shipped_src)
    dirs, logs = build_variants(edits, SRC, "probe_k1_wide")
    data = {(nb, dt): tile(nb, dt, 1, dev) for nb in VARIANT_NBS
            for dt in (torch.float32, torch.float64)}
    refs = {k: kt.getrf_with_inverses_blocked(a) for k, a in data.items()}
    result, bad = {}, []
    for name in edits:
        build.CSRC_DIR, build.BUILD_DIR = dirs[name]
        kc._library = None
        lib = kc.library().lib
        row = {"ptxas": ptxas_flow(logs[name]), "ms": {}, "max_err": {},
               "cycles": {}}
        print(f"{name}: ptxas {row['ptxas']}")
        nslot = lib.plu_flow_clk_slots()
        flags = torch.zeros(lib.plu_flow_flag_slots(), dtype=torch.int32,
                            device=dev)
        epoch = (ctypes.c_uint32 * 1)()

        def run(a, clk=None):
            f, li, ui = (torch.empty_like(a) for _ in range(3))
            s = "f32" if a.dtype == torch.float32 else "f64"
            rc = getattr(lib, f"plu_flow_probe_{s}")(
                dev.index, a.data_ptr(), f.data_ptr(), li.data_ptr(),
                ui.data_ptr(), flags.data_ptr(), epoch, a.shape[0],
                a.shape[-1], float(kt.DEFAULT_TOL[a.dtype]),
                clk.data_ptr() if clk is not None else None, None,
                torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"plu_flow_probe: CUDA error {rc}")
            return f, li, ui

        widest = {}
        for (nb, dt), a in data.items():
            if nb > lib.plu_flow_max_nb(a.element_size()):
                continue
            widest[dt] = max(widest.get(dt, 0), nb)
            got = run(a)
            err = max(float((g - r).abs().max())
                      for g, r in zip(got, refs[(nb, dt)]))
            tol = 1e-5 if dt == torch.float32 else 1e-12
            ok = all(torch.allclose(g, r, rtol=tol, atol=tol)
                     for g, r in zip(got, refs[(nb, dt)]))
            key = f"nb={nb} {str(dt)[6:]}"
            row["max_err"][key] = err
            row["ms"][key] = device_ms(lambda: run(a))
            print(f"  {key}: {row['ms'][key]:.4f} ms, max |err| against the "
                  f"twin {err:.2e} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{name} {key}")
        for dt, nb in widest.items():
            a = data[(nb, dt)]
            plan = (ctypes.c_int * 4)()
            lib.plu_flow_plan(nb, a.element_size(), 132, plan)
            ctas, rows = plan[0], plan[1]
            clk = torch.zeros(ctas * nslot, dtype=torch.int64, device=dev)
            run(a)
            run(a, clk)
            torch.cuda.synchronize()
            c = clk.view(ctas, nslot).cpu().numpy().astype(np.int64)
            key = f"nb={nb} {str(dt)[6:]}"
            row["cycles"][key] = cy = phases(c, -(-nb // 32),
                                             max(1, 32 // rows))
            print(f"  cycles {key}: a panel {cy['panel']}, the tile "
                  f"{cy['tile']}; the next owner's chain {cy['next_owner']}")
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
    ap.add_argument("--paths", action="store_true",
                    help="poisson3d(32) at nb=1024 through the engines")
    ap.add_argument("--zero-pivots", action="store_true",
                    help="K1 on f32 zero-pivot tiles against its twins")
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
    elif args.zero_pivots:
        from pangulu_tpu_torch.ops import kernels_cuda as kc

        kc.library()
        print("K1 on float32 zero-pivot tiles: over the 1e-5 / BLOCKED_TOL "
              "bounds against the twin; against the f64 twin")
        result["zero_pivots"] = zero_pivots(dev)
    elif args.paths:
        print(f"poisson3d(32) at nb={PATH_NB} with {root}")
        result["paths"] = paths(dev, trace=profile, which=ALL_PATHS)
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
