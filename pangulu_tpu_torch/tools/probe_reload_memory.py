#!/usr/bin/env python3
"""Peak device bytes of a reloaded compressed factor's first solve, on
one NVIDIA GPU, for the package of this checkout or of another tree:

    python3 pangulu_tpu_torch/tools/probe_reload_memory.py [--root DIR]

It factors poisson3d(32) at nb=128, nd, r32 with
``tile_storage="compressed"`` (the compressed phase of chip_smoke.py),
saves the factor, then measures ``torch.cuda.max_memory_allocated``
above what was allocated before around ``load_factor`` -> ``gstrs``:
the store, the diagonal tiles staged dense, their inverses (P2, and
whatever workspace it takes) and the solve.  The package is imported
from DIR (default: this checkout), so an unpacked older tree can be
measured the same way.  It prints the card's name and power limit, then
one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the tree whose pangulu_tpu_torch is measured")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_reload_memory: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
    from pangulu_tpu_torch.io import load_factor, save_factor
    from pangulu_tpu_torch.models import poisson3d

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    a = poisson3d(32)
    b = a.to_scipy() @ np.ones(a.n)
    h = init(a, InitOptions(nb=128, dtype="r32", ordering="nd",
                            tile_storage="compressed", device="cuda"))
    gstrf(h)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f.npz")
        save_factor(h, path)
        del h
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        h2 = load_factor(path, device="cuda")
        x = gstrs(h2, b)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    res = float(np.linalg.norm(a.to_scipy() @ x - b) / np.linalg.norm(b))
    out = {"root": str(root), "reload_peak_bytes": peak,
           "reload_peak_mib": peak / 2 ** 20, "solve_residual": res}
    print(json.dumps({"probe_reload_memory": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
