#!/usr/bin/env python3
"""P2, the triangle inverses of a reloaded compressed factor, on one
NVIDIA GPU, for the package of this checkout or of another tree:

    python3 pangulu_tpu_torch/tools/probe_p2.py [--root DIR] [--out F]

Times ``kernels_cuda.newton_inverses`` per launch (device ms over
back-to-back launches between CUDA events, median of 3) on 64 factored
diagonally dominant tiles at each nb of NBS, float32 and float64, with
the same inputs (drawn with numpy from one seed) for every tree.  A
tree whose P2 refuses an nb records the refusal.  The package is
imported from DIR (default: this checkout), so that an older tree
unpacked with ``git archive`` is measured the same way; the timing
helper is this checkout's chip_smoke.py.  Prints the card's name and
power limit, a line a measurement, then one JSON line {"probe_p2": ...}
(also written to F).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
NBS = (128, 256, 384, 512)
BATCH = 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the tree whose pangulu_tpu_torch is measured")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_p2: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(f"probe_p2 ({root}): {BATCH} tiles a launch, both triangles")
    dev = torch.device("cuda", 0)
    out = {"root": str(root), "card": card}
    for nb in NBS:
        rng = np.random.default_rng(nb)
        f64 = kt.getrf_with_inverses(torch.as_tensor(
            rng.standard_normal((BATCH, nb, nb)) + nb * np.eye(nb),
            device=dev))[0]
        for f in (f64.float(), f64):
            key = f"nb{nb}_{str(f.dtype).split('.')[-1]}"
            try:
                ms = cs.device_ms(lambda: kc.newton_inverses(f), n=10)
            except (ValueError, RuntimeError) as e:
                out[key] = f"refused: {e}"
                print(f"  nb={nb} {f.dtype}: refused ({e})")
                continue
            out[key] = ms
            print(f"  nb={nb} {f.dtype}: {ms:.4f} ms")
    line = json.dumps({"probe_p2": out})
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
