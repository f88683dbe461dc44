#!/usr/bin/env python3
"""P4 on one NVIDIA GPU: do independent scan chains pipeline, and what
does a dependent chain of products cost on a thread block cluster?  The
H100 form of the TPU probe tools/exp_scan_multi.py.  From the root of the
repository:

    python3 pangulu_tpu_torch/tools/probe_scan_multi.py [--steps 2048]
        [--reps 5] [--out F]

It prints the card's name and power limit, then for Q = 1, 2, 4, 8
chains, without and with the chain of products beside them (DMMA on
float64 copies, the instance held to true f32, and 3xTF32, the solver's
float products), the kernel scan_multi_kernel (csrc/probes.cuh: each
chain on a CTA of its own, the products on a cluster of C CTAs, C = 8
and 16) at STEPS steps on the probe's inputs (testing.probe_inputs,
seed 0): ms per call, ns per step and ns per step and chain, as the TPU
probe prints them (CUDA events, median of --reps); then one cluster
barrier at C = 8 and 16 (the floor of a step of the products) beside one
grid barrier of 132 blocks, in us.  The products leave float32's range
before 2048 steps: these are times, not values (chip_smoke.py checks the
kernel at 128 and 256 steps, and the chains of the instances with
products at 2048 with b = 0).  Last, one JSON line
{"probe_scan_multi": ...}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
STEPS = 128 * 16  # tools/exp_scan_multi.py STEPS
# the products' cluster sizes timed (the card refuses float64 products
# on 4: csrc/probes.cuh)
CLUSTERS = (8, 16)


def run(steps: int = STEPS, reps: int = 5) -> dict:
    """Measure on cuda:0, print the table; returns its rows and the
    barriers."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.testing import probe_inputs
    from pangulu_tpu_torch.tools.probe_newton_loop import barrier_us

    dev = torch.device("cuda", 0)
    a, b = (torch.as_tensor(x, device=dev) for x in probe_inputs(seed=0))
    print(f"P4: {steps} steps, CUDA events, median of {reps}")
    rows = []
    cases = [(False, "f64", kc.SCAN_CLUSTER)] + [
        (True, pr, c) for pr in kc.PROBE_PRODUCTS for c in CLUSTERS]
    for q in kt.SCAN_CHAINS:
        for wd, products, c in cases:
            ms = cs.cuda_ms(lambda _: kc.scan_multi(
                a, b, q, wd, steps, products=products, cluster=c),
                reps=reps)
            ns = ms / steps * 1e6
            rows.append(dict(q=q, dot=wd, products=products,
                             cluster=c if wd else None, ms=ms,
                             ns_per_step=ns, ns_per_step_chain=ns / q))
            label = f"dot={int(wd)}" + (f" {products} C={c}" if wd else "")
            print(f"  q={q} {label:18s}: {ms:8.3f} ms/call "
                  f"({ns:7.1f} ns/step, {ns / q:7.1f} ns/step/chain)")
    return dict(rows=rows, barrier_us=barrier_us(dev, CLUSTERS))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_scan_multi: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    line = json.dumps({"probe_scan_multi": dict(
        card=card, steps=args.steps, **run(args.steps, args.reps))})
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
