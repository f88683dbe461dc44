#!/usr/bin/env python3
"""P5 on one NVIDIA GPU: does scan work hide under matrix products?  The
H100 form of the TPU probe tools/exp_overlap.py.  From the root of the
repository:

    python3 pangulu_tpu_torch/tools/probe_overlap.py [--steps 4096]
        [--reps 5] [--edits] [--out F]

It prints the card's name and power limit, then

  (a) the probe's table: the kernel overlap_kernel (csrc/probes.cuh,
      acc's column strips over 16 CTAs, the scan on CTA 0) in modes
      scan, dots and both, and split (both, with the scan and the
      products on separate warps of CTA 0), STEPS steps on the probe's
      inputs (testing.probe_inputs, seed 0), in ms per call and ns per
      step (CUDA events, median of --reps); the modes with products
      twice: DMMA on float64 copies (the instance held to true f32) and
      3xTF32 (the solver's float products).  The chain of products
      leaves float32's range long before 4096 steps: the times are of
      the same instructions, the values are not checked here
      (chip_smoke.py checks the kernel at 128 and 256 steps, and the
      scan part of the modes with products at 4096 with b = 0);
  (b) the same question across SMs, the one W1 (K1 beside the products
      of the level before) asks: mode scan on one CTA on one stream,
      mode dots on floor((SMs - 1) / 16) copies (16 CTAs each) on a
      second stream, each alone and both at once (each stream's time
      from one common start; both at once 3 --reps times, each run
      kept: the scan's time there is bimodal), and the SM clock under
      each load (nvidia-smi, sampled while it runs back to back);
  (c) the solver's own kernels: K1 (getrf_with_inverses, one tile,
      nb=128) launched back to back on one stream while K2's chain
      factorization (mega_factorize, poisson3d(32) nb=128 r32 rcm) runs
      on another; each alone and both at once;

and last one JSON line {"probe_overlap": ...}.

With --edits it times, instead, the source variants of EDITS (textual
edits of csrc/probes.cuh, each of which must match once; all built at
once, as probe_products.py builds its own): (i) scan_apart, the scan on
a CTA of its own (CTA 16) in the same launch, the 16 product CTAs
beside it (W1's layout across SMs in one launch; its sum is not waited
for, so its values are wrong: timing only); (ii) warps8, 8 product
warps of 16 rows in place of 4 of 32; (iii) cluster2, mode dots on 2
CTAs a strip in a cluster of 2, each forming 64 rows and storing them
in both CTAs' copy of the strip (distributed shared memory), a cluster
barrier a step; regs0, every A fragment read from shared memory every
step (the first design), and regs_more, more of them in registers than
ship (12 chunks in dots, 5 beside the scan); kchains2, regs0 with 2
accumulators an atom over k's chunks in turn (other bits); wide_loads,
regs0 with 16-byte fragment loads (k's pairs t, t + 4 side by side,
the strip transposed; other bits); dmma_only, regs0's MMAs on
fragments loaded once, and lds_only, regs0's loads with each float64
MMA replaced by a sum (both timing only); and timed, the
shipped kernel with clock64 readings of thread 0 of CTAs 0 and 1 of
copy 0 a step: the wait at the step's barriers and the product.  The
variants of SAME_BITS must give the shipped kernel's bits (modes dots,
both and split at 256 steps; cluster2 dots), or the probe fails.  Each
variant's modes at STEPS steps (cluster2: dots only), ptxas's
registers and spills of its P5 instances, and the ratios the probe
answers: split / max(scan, dots) on CTA 0's SM and, for scan_apart,
across SMs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
STEPS = 128 * 32  # tools/exp_overlap.py STEPS
K1_LAUNCHES = 300
# acc's column strips a copy at nb = 128 (kernels_cuda.overlap_grid)
STRIPS = 16

# name -> [(file in csrc/, old, new)], each old text matching once
_F = "probes.cuh"
_KERNEL = ("template <int MODE, typename P>\n__global__ void "
           "__launch_bounds__(probe_threads<MODE>(), 1)\n    overlap_kernel(")
_GRID = "dim3(MODE == kProbeScan ? 1 : strips, copies)"
_LOOP = ("    strip_sync(whole);\n"
         "    if (MODE == kProbeBoth && whole) strip_sync(whole);\n"
         "    strip_product(ar, As, acc[s & 1], acc[(s + 1) & 1]);\n")
# (iii): rows [64 h, 64 h + 64) of a · cur, stored in this CTA's and the
# peer's copy of the strip
_HALF = """template <typename P>
__device__ __forceinline__ void strip_half(const P* As, const P* cur,
                                           P* nxt, int h) {
  using L = StripLayout<P>;
  using Mt = typename L::Mt;
  constexpr int TM = kProbeNb / 2 / kStripWarps, MF = TM / Mt::M;
  const int m0 = kProbeNb / 2 * h + (threadIdx.x >> 5) * TM;
  P* peer = cooperative_groups::this_cluster().map_shared_rank(nxt, h ^ 1);
  P v[MF][Mt::NC];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int i = 0; i < Mt::NC; ++i) v[m][i] = P(0);
#pragma unroll 4
  for (int k = 0; k < kProbeNb; k += Mt::K) {
    typename Mt::AFrag fa[MF];
    typename Mt::BFrag fb;
#pragma unroll
    for (int m = 0; m < MF; ++m)
      Mt::load_a(fa[m], As, L::LDA, m0 + m * Mt::M, k);
    Mt::load_b(fb, cur, L::LDB, k, 0);
#pragma unroll
    for (int m = 0; m < MF; ++m) Mt::step(v[m], fa[m], fb);
  }
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int i = 0; i < Mt::NC; i += 2) {
      const int o = (m0 + m * Mt::M + Mt::row(i)) * L::LDB + Mt::col(i);
      store_pair(nxt + o, v[m][i], v[m][i + 1]);
      store_pair(peer + o, v[m][i], v[m][i + 1]);
    }
}

"""
EDITS = {
    "shipped": [],
    "scan_apart": [
        (_F, "const bool scan_cta = SCAN && j == 0;",
         "const bool scan_cta = SCAN && j == (DOT ? strips : 0);"),
        (_F, "const bool whole = SCAN && DOT && scan_cta;",
         "const bool whole = false;"),
        (_F, "  // the products of strip j:",
         "  if (j >= strips) return;\n  // the products of strip j:"),
        (_F, _GRID, "dim3(MODE == kProbeScan ? 1 : strips + (MODE != "
                    "kProbeDots), copies)")],
    "warps8": [(_F, "constexpr int kStripWarps = kGemmWarps;",
                "constexpr int kStripWarps = 8;")],
    "cluster2": [
        (_F, "// The product warps' barrier:", _HALF
         + "// The product warps' barrier:"),
        (_F, _KERNEL, _KERNEL.replace("__global__ void",
                                      "__global__ void __cluster_dims__(2)")),
        (_F, _GRID, "dim3(2 * (MODE == kProbeScan ? 1 : strips), copies)"),
        (_F, "const int j = blockIdx.x;", "const int j = blockIdx.x / 2;"),
        (_F, _LOOP, "    cluster_sync_all();\n    strip_half<P>(As, acc[s & "
                    "1], acc[(s + 1) & 1], blockIdx.x & 1);\n"),
        (_F, "  strip_sync(whole);  // the last step is stored",
         "  cluster_sync_all();")],
    "timed": [
        (_F, _KERNEL, "__device__ long long g_plu_t[64];\n" + _KERNEL),
        (_F, "  for (int s = 0; s < steps; ++s) {\n" + _LOOP,
         "  long long tt[2] = {0, 0}, t0, t1;\n"
         "  for (int s = 0; s < steps; ++s) {\n    t0 = clock64();\n"
         + _LOOP.replace("    strip_product", "    t1 = clock64();\n"
                         "    tt[0] += t1 - t0;\n    strip_product")
         + "    tt[1] += clock64() - t1;\n"),
        (_F, "  strip_sync(whole);  // the last step is stored",
         "  strip_sync(whole);  // the last step is stored\n"
         "  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < 2)\n"
         "    for (int k = 0; k < 2; ++k) g_plu_t[2 * blockIdx.x + k] = "
         "tt[k];"),
        ("lu_kernels.cu", "}  // extern \"C\"",
         "int plu_debug_times(long long* out) {\n  return (int)"
         "cudaMemcpyFromSymbol(out, plu::g_plu_t, sizeof(plu::g_plu_t));"
         "\n}\n}  // extern \"C\"")],
}


_REGS = ("  return MODE == kProbeDots ? 8 : 4;", "  return {};")
_PRODUCT_HEAD = ("template <typename P, int RK>\n__device__ __forceinline__ "
                 "void strip_product(")
# the register chunks' loop, dropped with the registers (wide_loads)
_PRODUCT_BODY = """  if constexpr (RK > 0) {
#pragma unroll
    for (int q = 0; q < RK; ++q) {
      typename Mt::BFrag fb;
      Mt::load_b(fb, cur, L::LDB, q * Mt::K, 0);
#pragma unroll
      for (int m = 0; m < L::MF; ++m) Mt::step(v[m], ar.f[q][m], fb);
    }
  }
#pragma unroll 4
  for (int k = RK * Mt::K; k < kProbeNb; k += Mt::K) {
    typename Mt::AFrag fa[L::MF];
    typename Mt::BFrag fb;
#pragma unroll
    for (int m = 0; m < L::MF; ++m)
      Mt::load_a(fa[m], As, L::LDA, m0 + m * Mt::M, k);
    Mt::load_b(fb, cur, L::LDB, k, 0);
#pragma unroll
    for (int m = 0; m < L::MF; ++m) Mt::step(v[m], fa[m], fb);
  }
#pragma unroll
  for (int m = 0; m < L::MF; ++m)
#pragma unroll
    for (int i = 0; i < Mt::NC; i += 2)
      store_pair(nxt + (m0 + m * Mt::M + Mt::row(i)) * L::LDB + Mt::col(i),
                 v[m][i], v[m][i + 1]);
"""
_WIDE = """__host__ __device__ constexpr int strip_k(int k) {
  return (k & ~7) | (k & 3) << 1 | (k >> 2 & 1);
}
__device__ __forceinline__ void frag_set(MmaF64::BFrag& f, int i, double x) {
  f.v[i] = x;
}
__device__ __forceinline__ void frag_set(Mma<float>::BFrag& f, int i,
                                         float x) {
  split_tf32(x, f.big[i], f.small[i]);
}
template <typename P, int RK>
__device__ __forceinline__ void strip_product(const StripRegs<P, RK>&,
                                              const P* As, const P* cur,
                                              P* nxt) {
  using L = StripLayout<P>;
  using Mt = typename L::Mt;
  using V = typename L::V;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int m0 = (threadIdx.x >> 5) * L::TM;
  const P* pa = As + (m0 + g) * L::LD + 2 * t;
  const P* pb = cur + g * L::LD + 2 * t;
  P v[L::MF][Mt::NC];
#pragma unroll
  for (int m = 0; m < L::MF; ++m)
#pragma unroll
    for (int i = 0; i < Mt::NC; ++i) v[m][i] = P(0);
#pragma unroll 4
  for (int k = 0; k < kProbeNb; k += Mt::K) {
    typename Mt::AFrag fa[L::MF];
    typename Mt::BFrag fb;
#pragma unroll
    for (int m = 0; m < L::MF; ++m) {
      const P* q = pa + m * Mt::M * L::LD + k;
      const V x = *reinterpret_cast<const V*>(q);
      const V y = *reinterpret_cast<const V*>(q + 8 * L::LD);
      frag_set(fa[m], 0, x.x);
      frag_set(fa[m], 1, y.x);
      frag_set(fa[m], 2, x.y);
      frag_set(fa[m], 3, y.y);
    }
    const V z = *reinterpret_cast<const V*>(pb + k);
    frag_set(fb, 0, z.x);
    frag_set(fb, 1, z.y);
#pragma unroll
    for (int m = 0; m < L::MF; ++m) Mt::step(v[m], fa[m], fb);
  }
#pragma unroll
  for (int m = 0; m < L::MF; ++m)
#pragma unroll
    for (int i = 0; i < Mt::NC; ++i)
      nxt[Mt::col(i) * L::LD + strip_k(m0 + m * Mt::M + Mt::row(i))] =
          v[m][i];
}

"""
EDITS.update({
    # a's fragments all from shared memory every step (the first design)
    "regs0": [(_F, _REGS[0], _REGS[1].format(0))],
    # more of them in registers: 12 chunks (dots), 5 (beside the scan)
    "regs_more": [(_F, _REGS[0], _REGS[1].format(
        "MODE == kProbeDots ? 12 : 5"))],
    # timing only, on regs0: the MMAs on fragments loaded once (the k
    # loop's loads hoisted), or the loads with each float64 MMA replaced
    # by a sum
    "dmma_only": [
        (_F, _REGS[0], _REGS[1].format(0)),
        (_F, "Mt::load_a(fa[m], As, L::LDA, m0 + m * Mt::M, k);",
         "Mt::load_a(fa[m], As, L::LDA, m0 + m * Mt::M, 0);"),
        (_F, "Mt::load_b(fb, cur, L::LDB, k, 0);",
         "Mt::load_b(fb, cur, L::LDB, 0, 0);")],
    # 2 accumulators an atom, k's chunks dealt to them in turn (2
    # independent chains of MMAs a warp; other bits)
    "kchains2": [
        (_F, _REGS[0], _REGS[1].format(0)),
        (_F, "  P v[L::MF][Mt::NC];\n",
         "  P v[L::MF][Mt::NC], w[L::MF][Mt::NC];\n"),
        (_F, "    for (int i = 0; i < Mt::NC; ++i) v[m][i] = P(0);\n"
             "  if constexpr",
         "    for (int i = 0; i < Mt::NC; ++i) v[m][i] = w[m][i] = P(0);\n"
         "  if constexpr"),
        (_F, "#pragma unroll 4\n"
             "  for (int k = RK * Mt::K; k < kProbeNb; k += Mt::K) {\n",
         "#pragma unroll 2\n"
         "  for (int kk = RK * Mt::K; kk < kProbeNb; kk += 2 * Mt::K)\n"
         "#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n"
         "    const int k = kk + h * Mt::K;\n"),
        (_F, "    for (int m = 0; m < L::MF; ++m) Mt::step(v[m], fa[m], fb);"
             "\n  }\n",
         "    for (int m = 0; m < L::MF; ++m)\n"
         "      Mt::step(h ? w[m] : v[m], fa[m], fb);\n  }\n"
         "#pragma unroll\n  for (int m = 0; m < L::MF; ++m)\n"
         "#pragma unroll\n    for (int i = 0; i < Mt::NC; ++i) "
         "v[m][i] += w[m][i];\n")],
    # 16-byte fragment loads (8-byte in float): k's pairs t, t + 4 side
    # by side in a's rows and the strip's, the strip transposed, rows of
    # 136; no fragments in registers
    "wide_loads": [
        (_F, _REGS[0], _REGS[1].format(0)),
        (_F, "  static constexpr int LDA = kProbeNb + Mt::PAD_A;\n"
             "  static constexpr int LDB = kStripCols + (sizeof(P) == 8 ? 4 "
             ": 0);\n"
             "  static constexpr size_t kA = (size_t)kProbeNb * LDA;\n"
             "  static constexpr size_t kB = (size_t)kProbeNb * LDB;\n",
         "  using V = typename Pair<P>::V;\n"
         "  static constexpr int LD = kProbeNb + 8;\n"
         "  static constexpr size_t kA = (size_t)kProbeNb * LD;\n"
         "  static constexpr size_t kB = (size_t)kStripCols * LD;\n"),
        (_F, _PRODUCT_HEAD, _WIDE + _PRODUCT_HEAD.replace(
            "strip_product(", "strip_product_unused(")),
        (_F, "As[r * L::LDA + c] =", "As[r * L::LD + strip_k(c)] ="),
        (_F, "acc[0][r * L::LDB + c - c0] =",
         "acc[0][(c - c0) * L::LD + strip_k(r)] ="),
        (_F, "fin[r * L::LDB + c - c0]", "fin[(c - c0) * L::LD + strip_k(r)]"),
        (_F, _PRODUCT_BODY, "")],
    "lds_only": [
        (_F, _REGS[0], _REGS[1].format(0)),
        (_F, "    for (int m = 0; m < L::MF; ++m) Mt::step(v[m], fa[m], fb);",
         "    for (int m = 0; m < L::MF; ++m)\n"
         "      if constexpr (sizeof(P) == 8)\n"
         "        v[m][0] += ((fa[m].v[0] + fa[m].v[1]) + (fa[m].v[2] + "
         "fa[m].v[3])) + (fb.v[0] + fb.v[1]);\n"
         "      else\n        Mt::step(v[m], fa[m], fb);")],
})
# the variants whose results must be the shipped kernel's bits
SAME_BITS = ("warps8", "cluster2", "regs0", "regs_more")
PHASES = ("barrier wait", "product")


def streams_ms(work, reps: int, runs: list | None = None) -> list:
    """Run each (stream, fn) of ``work`` on its stream from one common
    start, queued behind a device sleep so that the host's launches do
    not show; returns, per entry, the median over ``reps`` of the ms
    from the start to that stream's end (each rep's ms appended to
    ``runs`` when given)."""
    cur = torch.cuda.current_stream()
    times = []
    for _ in range(reps + 1):           # the first is a warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        ends = [torch.cuda.Event(enable_timing=True) for _ in work]
        torch.cuda._sleep(100_000_000)
        start.record(cur)
        for (s, fn), e in zip(work, ends):
            s.wait_event(start)
            with torch.cuda.stream(s):
                fn()
                e.record(s)
        torch.cuda.synchronize()
        times.append([start.elapsed_time(e) for e in ends])
    if runs is not None:
        runs += times[1:]
    return [statistics.median(t[i] for t in times[1:])
            for i in range(len(work))]


def sm_clocks(work, seconds: float = 1.5) -> dict:
    """The SM clock (MHz, nvidia-smi, sampled every 20 ms) while each
    (stream, fn) of ``work`` runs back to back on its stream for about
    ``seconds``: the card lowers its clock under some loads, and a
    latency-bound chain slows with it."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits", "-lms", "20"],
                           stdout=subprocess.PIPE, text=True)
    time.sleep(0.5)                     # nvidia-smi's own start
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for s, fn in work:
            with torch.cuda.stream(s):
                fn()
        torch.cuda.synchronize()
    smi.terminate()
    mhz = sorted(int(x) for x in smi.communicate()[0].split()
                 if x.isdigit())
    return dict(samples=len(mhz), min=mhz[0], median=mhz[len(mhz) // 2],
                max=mhz[-1]) if mhz else {}


def modes_table(cs, a, b, steps: int, products: str, reps: int,
                modes=None) -> dict:
    """ms per call and ns per step of P5 in each mode (scan only with
    f64: it has no products), printed as measured."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    table = {}
    for mode in modes or kt.OVERLAP_MODES:
        if mode == "scan" and products != "f64":
            continue                    # no products to choose
        ms = cs.cuda_ms(lambda _: kc.scan_overlap(
            a, b, mode, steps, products=products), reps=reps)
        table[mode] = dict(ms=ms, ns_per_step=ms / steps * 1e6)
        print(f"  {mode:5s} {products:6s}: {ms:8.3f} ms/call "
              f"({ms / steps * 1e6:7.1f} ns/step)", flush=True)
    return table


def ratios(t: dict) -> dict:
    """The probe's answers from a table of modes: split / max(scan,
    dots) (1: the scan hides wholly under the products) and both /
    (scan + dots)."""
    s, d = t["scan"]["ms"], t["dots"]["ms"]
    return dict(split_over_max=t["split"]["ms"] / max(s, d),
                both_over_sum=t["both"]["ms"] / (s + d))


def edits(steps: int, reps: int) -> dict:
    """Build EDITS' variants at once and time each (module note)."""
    import ctypes
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch.ops import build
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.testing import probe_inputs
    from pangulu_tpu_torch.tools.probe_products import build_all, use_variant

    for name, eds in EDITS.items():
        texts = {}
        for fname, old, new in eds:
            text = texts.get(fname) or (build.CSRC_DIR / fname).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: edit does not match once in "
                                   f"{fname}: {old!r}")
            texts[fname] = text.replace(old, new)
    dirs = build_all({n: (n, e) for n, e in EDITS.items()})
    dev = torch.device("cuda", 0)
    a, b = (torch.as_tensor(x, device=dev) for x in probe_inputs(seed=0))
    use_variant(*dirs["shipped"])
    ref = {m: kc.scan_overlap(a, b, m, 256) for m in ("dots", "both",
                                                      "split")}
    out = {}
    for name in EDITS:
        log = "".join(f.read_text() for f in dirs[name][1].glob("*.log"))
        lib = use_variant(*dirs[name]).lib
        res = out[name] = dict(ptxas={
            n: (i.get("registers"), i.get("spill_bytes"))
            for n, i in cs.ptxas_by_kernel(log).items()
            if "overlap_kernel" in n})
        print(f"{name}: ptxas {res['ptxas']}", flush=True)
        if name in SAME_BITS:
            for m in (("dots",) if name == "cluster2" else ref):
                if not torch.equal(kc.scan_overlap(a, b, m, 256), ref[m]):
                    raise AssertionError(f"{name} {m}: not the shipped bits")
            res["same_bits_as_shipped"] = True
        for products in kc.PROBE_PRODUCTS:
            res[products] = modes_table(
                cs, a, b, steps, products, reps,
                ("dots",) if name == "cluster2" else None)
        if name != "cluster2":
            res["ratios"] = ratios(res["f64"])
            print(f"  {name} f64: {res['ratios']}")
        if name == "timed":
            lib.plu_debug_times.argtypes = [ctypes.c_void_p]
            res["cycles_a_step"] = {}
            for m in ("dots", "both", "split"):
                kc.scan_overlap(a, b, m, steps)
                torch.cuda.synchronize()
                t = (ctypes.c_longlong * 64)()
                if lib.plu_debug_times(t):
                    raise RuntimeError("plu_debug_times failed")
                cyc = {f"CTA {c} {ph}": t[2 * c + k] / steps
                       for c in (0, 1) for k, ph in enumerate(PHASES)}
                res["cycles_a_step"][m] = cyc
                print(f"  timed {m}, cycles a step: " + ", ".join(
                    f"{k} {v:.0f}" for k, v in cyc.items()))
    use_variant(*dirs["shipped"])
    return out


def run(steps: int = STEPS, reps: int = 5) -> dict:
    """Measure (a)-(c) on cuda:0, print the tables, return the results."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch import InitOptions, gstrf, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.testing import probe_inputs

    dev = torch.device("cuda", 0)
    a, b = (torch.as_tensor(x, device=dev) for x in probe_inputs(seed=0))
    res = {"steps": steps}

    print(f"P5 (a) acc's column strips over {STRIPS} CTAs, the scan on "
          f"CTA 0, {steps} steps (CUDA events, median of {reps})")
    for products, key in (("f64", "column_strips"),
                          ("tf32x3", "column_strips_tf32x3")):
        res[key] = modes_table(cs, a, b, steps, products, reps)
    res["ratios"] = ratios(res["column_strips"])
    print(f"  f64: {res['ratios']}")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    scan = (s1, lambda: kc.scan_overlap(a, b, "scan", steps))
    copies = (sms - 1) // STRIPS        # the SMs the scan leaves
    dots = (s2, lambda: kc.scan_overlap(a, b, "dots", steps,
                                        copies=copies))
    alone = [streams_ms([w], reps)[0] for w in (scan, dots)]
    # beside each other, each rep apart: the scan's time beside the
    # products is bimodal (PERF.md PR 14)
    runs = []
    both = streams_ms([scan, dots], 3 * reps, runs)
    clocks = {k: sm_clocks(w) for k, w in (
        ("scan_alone", [scan]), ("dots_alone", [dots]),
        ("beside", [scan, dots]))}
    res["across_sms"] = dict(sms=sms, dots_copies=copies,
                             scan_alone_ms=alone[0], dots_alone_ms=alone[1],
                             scan_beside_ms=both[0], dots_beside_ms=both[1],
                             beside_runs_ms=runs, sm_clock_mhz=clocks)
    print(f"P5 (b) across SMs: scan on 1 CTA, dots on {copies} copies "
          f"({copies * STRIPS} CTAs), two streams: scan {alone[0]:.3f} ms "
          f"alone, {both[0]:.3f} beside; dots {alone[1]:.3f} ms alone, "
          f"{both[1]:.3f} beside (median of {len(runs)}; the scan's "
          f"runs {sorted(round(r[0], 3) for r in runs)}); SM clock MHz "
          f"(median, min) "
          + ", ".join(f"{k} {c.get('median')}, {c.get('min')}"
                      for k, c in clocks.items()))

    h = init(poisson3d(32), InitOptions(nb=128, dtype="r32",
                                        ordering="rcm", device="cuda"))
    gstrf(h)                            # builds the factorizer
    fac = h._factorizer
    # a fresh store for each factorization (K2 factors in place): two
    # rounds of reps + 1
    k2_runs = iter([h.blocked.device_tiles(dev)
                    for _ in range(2 * (reps + 1))])
    tile = a + 128 * torch.eye(128, device=dev)

    def k1_loop():
        for _ in range(K1_LAUNCHES):
            kc.getrf_with_inverses(tile)

    def k2():
        fac.factorize(next(k2_runs), sync=False)

    k1 = (s1, k1_loop)
    k2w = (s2, k2)
    alone = [streams_ms([w], reps)[0] for w in (k1, k2w)]
    both = streams_ms([k1, k2w], reps)
    res["k1_beside_k2"] = dict(
        k1_launches=K1_LAUNCHES, k1_alone_ms=alone[0] / K1_LAUNCHES,
        k1_beside_ms=both[0] / K1_LAUNCHES, k2_alone_ms=alone[1],
        k2_beside_ms=both[1])
    print(f"P5 (c) K1 (one nb=128 tile, {K1_LAUNCHES} launches) beside K2 "
          f"(poisson3d(32) nb=128 rcm): K1 {alone[0] / K1_LAUNCHES:.4f} ms "
          f"a launch alone, {both[0] / K1_LAUNCHES:.4f} beside; K2 "
          f"{alone[1]:.3f} ms alone, {both[1]:.3f} beside")
    del h, fac, k2_runs
    torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--edits", action="store_true",
                    help="time the source variants of EDITS instead")
    ap.add_argument("--out", help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_overlap: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    res = dict(card=card, **(edits if args.edits else run)(args.steps,
                                                            args.reps))
    line = json.dumps({"probe_overlap": res})
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
