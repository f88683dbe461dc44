#!/usr/bin/env python3
"""Device ms of one numeric factorization (K2 for rcm, K4 for nd) on
one NVIDIA GPU, for the package of this checkout or of another tree:

    python3 pangulu_tpu_torch/tools/probe_gstrf_times.py [--root DIR]
        [--match TEXT]

For each configuration below it builds the handle and the kernel tables
as chip_smoke.py's K2/K4 phases do and times the factorization kernel
on a fresh copy of the tile store between CUDA events, median of
``--reps``: poisson3d(32) at nb=256 in r32 and r64 and at nb=128 in r32,
and poisson3d(16) at nb=256 in r64 (chip_smoke.py's r64 nb=256 case),
each rcm and nd (``--match`` keeps those whose label holds TEXT, e.g.
``r64``).  At nb=256 every diagonal step is K1's kernel for
128 < nb <= 256, so these are the paths that show it end to end.  The
package is imported from DIR (default: this checkout), so an unpacked
older tree is measured the same way.  It prints the card's name and
power limit, a line a configuration, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]

# (matrix, n of the generator, nb, dtype, ordering)
CONFIGS = [("poisson3d", 32, 256, "r32", "rcm"),
           ("poisson3d", 32, 256, "r32", "nd"),
           ("poisson3d", 32, 256, "r64", "rcm"),
           ("poisson3d", 32, 256, "r64", "nd"),
           ("poisson3d", 16, 256, "r64", "rcm"),
           ("poisson3d", 16, 256, "r64", "nd"),
           ("poisson3d", 32, 128, "r32", "rcm"),
           ("poisson3d", 32, 128, "r32", "nd")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the tree whose pangulu_tpu_torch is measured")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--match", default="",
                    help="only the configurations whose label holds this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_gstrf_times: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from pangulu_tpu_torch import InitOptions, init, models
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {}
    for gen, size, nb, dtype, ordering in CONFIGS:
        key = f"{gen}({size}) nb={nb} {dtype} {ordering}"
        if args.match not in key:
            continue
        a = getattr(models, gen)(size)
        h = init(a, InitOptions(nb=nb, dtype=dtype, ordering=ordering,
                                device="cuda"))
        blk, sch = h.blocked, h.schedule
        nt, bl, uch = blk.num_tiles, sch.block_length, kt.mega_uch(nb)
        if ordering == "nd":
            tab = kt.KernelTables.build(sch.group_mega_tables(nt, uch=uch),
                                        dev)
            fk = kc.mega_factorize_groups
        else:
            tab = kt.KernelTables.build(sch.mega_tables(nt, uch=uch), dev)
            fk = kc.mega_factorize
        t0 = blk.device_tiles(dev)
        kw = dict(nb=nb, tol=kt.DEFAULT_TOL[t0.dtype], bl=bl)
        fk(t0.clone(), tab, **kw)
        times = []
        for _ in range(args.reps):
            t = t0.clone()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fk(t, tab, **kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[key] = dict(ms=statistics.median(times), times=times,
                        tiles=nt, levels=bl)
        print(f"{key}: {out[key]['ms']:.3f} ms (median of {args.reps}), "
              f"{nt} tiles")
        del h, t0, t, tab
        torch.cuda.empty_cache()
    print(json.dumps({"probe_gstrf_times": {"root": str(root), "card": card,
                                            "ms": out}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
