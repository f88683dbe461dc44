#!/usr/bin/env python3
"""P3 on one NVIDIA GPU: G members of a batch of Newton–Schulz steps, a
thread block cluster a member, beside the other ways to the same
inverses.  The H100 form of the TPU probe tools/exp_batched_scan.py
newton_loop.  From the root of the repository:

    python3 pangulu_tpu_torch/tools/probe_newton_loop.py [--reps 5]
        [--out F]

It prints the card's name and power limit, then for G = 1, 4, 8, 16
unit lower triangles at nb = 128 (testing.newton_inputs, the probe's
inputs) and its steps = 6, the device time per call (back-to-back calls
between CUDA events, median of --reps) of

  * newton_loop_kernel (csrc/probes.cuh) on clusters of C = 4, 8 and 16
    CTAs, one a member (float32 members, float64 products on DMMA,
    the blocks passed through L2, the triangles' zero blocks skipped);
  * P2, newton_inverses (csrc/compressed.cuh), on the same tiles in
    float64: a CTA a member and triangle, a Gauss–Jordan sweep on a
    register tile; its L^-1 is P3's result, its U^-1 CTAs run beside
    them;
  * P2 on the float32 tiles (the same sweep in float64, rounded once);
  * torch.linalg.solve_triangular(unitriangular=True) on the G members,

in us per call and per member; then one cluster barrier at C = 4, 8
and 16 (cluster_sync_probe: the floor of each of the kernel's 2 steps
dependent products) beside one grid barrier of 132 blocks
(grid_sync_probe, the barrier K3 takes a level), in us; last one JSON
line {"probe_newton_loop": ...}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
NB = 128
GROUPS = (1, 4, 8, 16)
# the cluster sizes timed
CLUSTERS = (4, 8, 16)


def barrier_us(dev, clusters=CLUSTERS, iters: int = 2000) -> dict:
    """us a barrier: one launch of ``iters`` cluster barriers on one
    cluster of each size, and of ``iters`` grid barriers on 132 blocks,
    each between CUDA events after a warm-up launch."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc

    def per_barrier(fn) -> float:
        fn(10)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(iters)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / iters

    out = {f"cluster{c}": per_barrier(
        lambda it, c=c: kc.cluster_sync_probe(dev, c, it)) for c in clusters}
    out["grid132"] = per_barrier(lambda it: kc.grid_sync_probe(dev, 132, it))
    print("  one barrier: " + ", ".join(f"{k} {v:.3f} us"
                                        for k, v in out.items()))
    return out


def run(reps: int = 5) -> dict:
    """Measure on cuda:0, print the table; returns its rows and the
    barriers."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.testing import newton_inputs

    dev = torch.device("cuda", 0)
    steps = kt.newton_steps(NB)
    print(f"P3: nb={NB}, steps={steps}; device us per call (per member)")
    rows = []
    for g in GROUPS:
        lm = torch.as_tensor(newton_inputs(g, NB, seed=g), device=dev)
        eye = torch.eye(NB, device=dev).expand(g, NB, NB)
        lm64 = lm.double()
        calls = {f"cluster{c}": (lambda c=c: kc.newton_loop(lm, steps,
                                                            blocks=c))
                 for c in CLUSTERS}
        calls.update({
            "p2_f64": lambda: kc.newton_inverses(lm64),
            "p2_f32": lambda: kc.newton_inverses(lm),
            "solve_triangular": lambda: torch.linalg.solve_triangular(
                lm, eye, upper=False, unitriangular=True),
        })
        row = {"g": g}
        for name, fn in calls.items():
            row[f"{name}_us"] = cs.device_ms(fn, n=10, reps=reps) * 1e3
        rows.append(row)
        print(f"  G={g:3d}: " + ", ".join(
            f"{n} {row[f'{n}_us']:9.2f} ({row[f'{n}_us'] / g:8.2f})"
            for n in calls))
    return dict(rows=rows, barrier_us=barrier_us(dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_newton_loop: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    line = json.dumps({"probe_newton_loop": dict(card=card, nb=NB,
                                                 **run(args.reps))})
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
