#!/usr/bin/env python3
"""P4 on one NVIDIA GPU: do independent scan chains pipeline?  The H100
form of the TPU probe tools/exp_scan_multi.py.  From the root of the
repository:

    python3 pangulu_tpu_torch/tools/probe_scan_multi.py [--steps 2048]
        [--reps 5] [--out F]

It prints the card's name and power limit, then for Q = 1, 2, 4, 8
chains, without and with the chain of products beside them (DMMA on
float64 copies, the instance held to true f32, and 3xTF32, the solver's
float products), the kernel scan_multi_kernel (csrc/probes.cuh: Q
chains in one CTA's loop body, chain 0 in registers, chain 1 in shared
memory, the rest in global memory) at STEPS steps on the probe's inputs
(testing.probe_inputs, seed 0): ms per call, ns per step and ns per step
and chain, as the TPU probe prints them; and beside each, the same Q
chains as Q one-chain CTAs in one launch (copies = Q, the way K1 takes a
batch, which answers P1).  CUDA events, median of --reps.  The products leave float32's range before 2048
steps: these are times, not values (chip_smoke.py checks the kernel at
128 and 256 steps, and the chains of the instances with products at
2048 with b = 0).  Last, one JSON line {"probe_scan_multi": ...}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
STEPS = 128 * 16  # tools/exp_scan_multi.py STEPS


def run(steps: int = STEPS, reps: int = 5) -> list:
    """Measure on cuda:0, print the table, return its rows."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.testing import probe_inputs

    dev = torch.device("cuda", 0)
    a, b = (torch.as_tensor(x, device=dev) for x in probe_inputs(seed=0))
    print(f"P4: {steps} steps, CUDA events, median of {reps}; beside: the "
          "same chains as one-chain CTAs in one launch")
    rows = []
    for q in kt.SCAN_CHAINS:
        for wd, products in ((False, "f64"), (True, "f64"),
                             (True, "tf32x3")):
            one = cs.cuda_ms(lambda _: kc.scan_multi(
                a, b, q, wd, steps, products=products), reps=reps)
            many = cs.cuda_ms(lambda _: kc.scan_multi(
                a, b, 1, wd, steps, copies=q, products=products), reps=reps)
            ns = one / steps * 1e6
            rows.append(dict(q=q, dot=wd, products=products, ms=one,
                             ns_per_step=ns, ns_per_step_chain=ns / q,
                             ctas_ms=many,
                             ctas_ns_per_step_chain=many / steps * 1e6 / q))
            label = f"dot={int(wd)}" + (f" {products}" if wd else "")
            print(f"  q={q} {label:12s}: {one:8.3f} ms/call "
                  f"({ns:7.1f} ns/step, {ns / q:7.1f} ns/step/chain); "
                  f"{q} CTAs: {many:8.3f} ms/call "
                  f"({many / steps * 1e6 / q:7.1f} ns/step/chain)")
    return rows


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
        card=card, steps=args.steps, rows=run(args.steps, args.reps))})
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
