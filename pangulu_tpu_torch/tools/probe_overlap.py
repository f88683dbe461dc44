#!/usr/bin/env python3
"""P5 on one NVIDIA GPU: does scan work hide under matrix products?  The
H100 form of the TPU probe tools/exp_overlap.py.  From the root of the
repository:

    python3 pangulu_tpu_torch/tools/probe_overlap.py [--steps 4096]
        [--reps 5] [--out F]

It prints the card's name and power limit, then

  (a) the probe's table: the kernel overlap_kernel (csrc/probes.cuh) in
      modes scan, dots and both, and split (both, with the scan and the
      products on separate warps of one CTA), one CTA, STEPS steps on
      the probe's inputs (testing.probe_inputs, seed 0), in ms per call
      and ns per step (CUDA events, median of --reps); the modes with
      products twice: DMMA on float64 copies (the instance held to true
      f32) and 3xTF32 (the solver's float products).  The chain of
      products leaves float32's range long before 4096 steps: the times
      are of the same instructions, the values are not checked here
      (chip_smoke.py checks the kernel at 128 and 256 steps, and the
      scan part of the modes with products at 4096 with b = 0);
  (b) the same question across SMs, the one W1 (K1 beside the products
      of the level before) asks: mode scan on one CTA on one stream,
      mode dots on SMs - 1 CTAs (copies) on a second stream, each alone
      and both at once (each stream's time from one common start);
  (c) the solver's own kernels: K1 (getrf_with_inverses, one tile,
      nb=128) launched back to back on one stream while K2's chain
      factorization (mega_factorize, poisson3d(32) nb=128 r32 rcm) runs
      on another; each alone and both at once;

and last one JSON line {"probe_overlap": ...}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
STEPS = 128 * 32  # tools/exp_overlap.py STEPS
K1_LAUNCHES = 300


def streams_ms(work, reps: int) -> list:
    """Run each (stream, fn) of ``work`` on its stream from one common
    start, queued behind a device sleep so that the host's launches do
    not show; returns, per entry, the median over ``reps`` of the ms
    from the start to that stream's end."""
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
    return [statistics.median(t[i] for t in times[1:])
            for i in range(len(work))]


def run(steps: int = STEPS, reps: int = 5) -> dict:
    """Measure (a)-(c) on cuda:0, print the tables, return the results."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch import InitOptions, gstrf, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.testing import probe_inputs

    dev = torch.device("cuda", 0)
    a, b = (torch.as_tensor(x, device=dev) for x in probe_inputs(seed=0))
    res = {"steps": steps}

    print(f"P5 (a) one CTA, {steps} steps (CUDA events, median of {reps})")
    for products, key in (("f64", "one_cta"), ("tf32x3", "one_cta_tf32x3")):
        table = {}
        for mode in kt.OVERLAP_MODES:
            if mode == "scan" and products != "f64":
                continue                # no products to choose
            ms = cs.cuda_ms(lambda _: kc.scan_overlap(
                a, b, mode, steps, products=products), reps=reps)
            table[mode] = dict(ms=ms, ns_per_step=ms / steps * 1e6)
            print(f"  {mode:5s} {products:6s}: {ms:8.3f} ms/call "
                  f"({ms / steps * 1e6:7.1f} ns/step)")
        res[key] = table

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    scan = (s1, lambda: kc.scan_overlap(a, b, "scan", steps))
    dots = (s2, lambda: kc.scan_overlap(a, b, "dots", steps,
                                        copies=sms - 1))
    alone = [streams_ms([w], reps)[0] for w in (scan, dots)]
    both = streams_ms([scan, dots], reps)
    res["across_sms"] = dict(sms=sms, dots_copies=sms - 1,
                             scan_alone_ms=alone[0], dots_alone_ms=alone[1],
                             scan_beside_ms=both[0], dots_beside_ms=both[1])
    print(f"P5 (b) across SMs: scan on 1 CTA, dots on {sms - 1} CTAs, two "
          f"streams: scan {alone[0]:.3f} ms alone, {both[0]:.3f} beside; "
          f"dots {alone[1]:.3f} ms alone, {both[1]:.3f} beside")

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
    res = dict(card=card, **run(args.steps, args.reps))
    line = json.dumps({"probe_overlap": res})
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
