#!/usr/bin/env python3
"""How often torch.profiler loses device activity on one NVIDIA GPU, with
and without a pause of PAUSE_S between the start of a trace and the
first launch (``chip_smoke.trace_once``).  It tests one suspect: kineto
keeps only the device activity inside its capture window, which opens
on the host's clock when the trace starts, so a kernel launched at once
might fall before it.  From the root of the repository:

    python3 pangulu_tpu_torch/tools/probe_profiler.py [--reps N] [--out F]

On poisson3d(32) nb=256 r32 it traces, ``reps`` times for each pause (0
and PAUSE_S, taken in turns), one nd solve (K5: two
launches of ``group_sweep_kernel``) and one rcm factorization (K1's body,
``getrf_inv_kernel``, twice a level: 256 launches).  Per case and pause
it prints the traces with no device activity and those that saw fewer
launches of the kernel than the call made, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
PAUSE_S = 0.05


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", help="also write the results here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_profiler: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
    from pangulu_tpu_torch.models import poisson3d

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    a = poisson3d(32)
    b = a.to_scipy() @ np.ones(a.n)
    cases = {}
    for ordering, what, kernel in (("nd", "gstrs", "group_sweep_kernel"),
                                   ("rcm", "gstrf", "getrf_inv_kernel")):
        h = init(a, InitOptions(nb=256, dtype="r32", ordering=ordering,
                                device="cuda"))
        gstrf(h)
        gstrs(h, b)
        if what == "gstrs":
            ts = h._trisolver
            xb = ts.blockify_rhs(
                h.reordering.transform_b(b.astype(np.float32)))
            call, setup = (lambda _, ts=ts, h=h, xb=xb:
                           ts.solve_blocked(h.factor_tiles, xb)), None
            want = 2
        else:
            fac = h._factorizer
            call = lambda t, fac=fac: fac.factorize(t, sync=False)
            setup = lambda h=h: h.blocked.device_tiles("cuda")
            want = 2 * h.schedule.block_length
        call(setup() if setup else None)
        seen = {0.0: [], PAUSE_S: []}
        for _ in range(args.reps):
            for pause, got in seen.items():
                _, _, kernels = cs.trace_once(
                    call, setup() if setup else None, pause)
                got.append(sum(k["launches"] for n, k in kernels.items()
                               if n.split("<")[0].endswith("::" + kernel)))
        label = f"nb=256 {ordering} {what}"
        cases[label] = {
            str(pause): dict(traces=len(got), empty=sum(g == 0 for g in got),
                             short=sum(g < want for g in got),
                             launches_made=want, launches_seen=got)
            for pause, got in seen.items()}
        for pause, r in cases[label].items():
            print(f"{label}, pause {pause} s: {r['traces']} traces, "
                  f"{r['empty']} without {kernel}, {r['short']} with fewer "
                  f"than the {want} launches made")
        del h
        torch.cuda.empty_cache()
    out = {"card": cs.card_line(), "cases": cases}
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
