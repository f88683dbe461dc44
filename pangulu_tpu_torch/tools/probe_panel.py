#!/usr/bin/env python3
"""The compressed store's two engines side by side on one NVIDIA GPU:

    python3 pangulu_tpu_torch/tools/probe_panel.py [--nx 32] [--nb 128]
        [--reps 7] [--out F]

On poisson3d(nx), nd, r32 with ``tile_storage="compressed"`` it builds
one store and, in the turns panel, level, level, panel, times on it the
out-of-core panel driver (``outofcore.PanelLU``, the card's route) and
the level loop (``compressed.CompressedLU``): ms per factorization (the
store refilled before each) and ms per solve of the factors that
engine made (CUDA events, median of --reps), after a garbage
collection.  Then it traces one solve of each with torch.profiler:
launches and device ms by kernel, busy and wall ms.  Both solves run
``CompressedLU.solve_blocked`` on the same store; the panel driver's
goes through ``PanelLU.solve_blocked``.  It prints the card's name and
power limit, a line a measurement, then one JSON line
{"probe_panel": ...} (also written to F).  The timing helpers are
this checkout's chip_smoke.py.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nb", type=int, default=128)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_panel: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pangulu_tpu_torch import InitOptions, init
    from pangulu_tpu_torch.compressed import CompressedLU
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.outofcore import PanelLU

    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    a = poisson3d(args.nx)
    b = a.to_scipy() @ np.ones(a.n)
    h = init(a, InitOptions(nb=args.nb, dtype="r32", ordering="nd",
                            tile_storage="compressed", device="cuda"))
    a3 = h.reordering.reordered
    plu = PanelLU(h.blocked, h.schedule, a3, device=dev)
    clu = CompressedLU(h.blocked, h.schedule, a3, device=dev,
                       store=plu.store)
    st = plu.store
    st.refill(a3)
    v0 = st.values.clone()
    bl, nb = h.schedule.block_length, args.nb
    xb = torch.zeros((bl + 1, nb, 1), dtype=torch.float32, device=dev)
    xb[:bl].view(-1)[:a.n] = torch.as_tensor(
        h.reordering.transform_b(b.astype(np.float32)), device=dev)
    engines = {"panel": plu, "level": clu}
    out = {k: {"factor_ms": [], "solve_ms": []} for k in engines}
    for name in ("panel", "level", "level", "panel"):
        eng = engines[name]
        gc.collect()
        fms = cs.cuda_ms(lambda _: eng.factorize(),
                         setup=lambda: st.values.copy_(v0), reps=args.reps)
        gc.collect()
        sms = cs.cuda_ms(lambda _: eng.solve_blocked(xb), reps=args.reps)
        out[name]["factor_ms"].append(fms)
        out[name]["solve_ms"].append(sms)
        print(f"{name}: {fms:.3f} ms per factorization, {sms:.3f} ms per "
              f"solve (CUDA events, median of {args.reps})")
    for name, eng in engines.items():
        st.values.copy_(v0)
        eng.factorize()
        prof = cs.profile(lambda _: eng.solve_blocked(xb))
        out[name]["solve_trace"] = prof
        cs.print_profile({f"{name} solve": prof})
    res = {"card": card, "nx": args.nx, "nb": nb, "levels": bl,
           "tiles": h.blocked.num_tiles, **out}
    line = json.dumps({"probe_panel": res})
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
