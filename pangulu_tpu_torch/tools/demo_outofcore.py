#!/usr/bin/env python3
"""Out-of-core demo: factor, on one device, a matrix whose dense tile
store is larger than the device memory the process may allocate.

    python3 pangulu_tpu_torch/tools/demo_outofcore.py [--nx 96] [--nb 128]
        [--ordering nd] [--device cuda|cpu] [--device-gib G] [--analyze]

The counterpart of the JAX package's ``tools/demo_outofcore.py``
(``OOC_NX``/``OOC_NB`` there are ``--nx``/``--nb`` here).  It factors
poisson3d(nx), r32, with ``tile_storage="compressed"``: on the card
gstrf takes the out-of-core panel driver (``outofcore.PanelLU``: the
store compressed at rest, K2 on each panel's cross, P6 staging), which
sizes each panel's dense cross from the device memory the process may
allocate.

``--device-gib G`` caps the CUDA caching allocator at G GiB
(``torch.cuda.set_per_process_memory_fraction``) before anything is
allocated: every allocation beyond it raises, and nothing here catches
it.  Without it the demo runs under the card's own memory.  On the card
the allocator takes expandable segments
(``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` unless the
environment sets that variable), so that the cap is not spent on
fragments of fixed-size segments.  ``--device
cpu`` runs the plain versions (the level loop of ``CompressedLU``; the
panel route is the card's) and takes no cap.  ``--analyze`` stops after
``analyze`` (reorder, symbolic analysis and tiling; nothing on the
device): the size study.

It prints the card's name and power limit, n and nnz, the init time,
the tiles and the dense store's GiB (EXCEEDS or fits the cap, or the
card's memory without one), the compressed store's host build time,
the number of panels, the peak ``torch.cuda.max_memory_allocated`` of
gstrf beside the dense store's bytes, gstrf's time and dense-tile
GFLOPS, the engine, the compressed store's GiB, the factor's fill nnz/s,
gstrs's time and the residual against the JAX demo's gate of 1e-4,
and last one JSON line {"demo_outofcore": {...}} of those numbers.
Exit 1 when the residual misses the gate.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pangulu_tpu_torch.api import (InitOptions, analyze,  # noqa: E402
                                   finalize, gstrf, gstrs, init)
from pangulu_tpu_torch.models import poisson3d  # noqa: E402
from pangulu_tpu_torch.utils.perf import (host_rss_bytes,  # noqa: E402
                                          residual_norm, resolve_device)

GATE = 1e-4          # the JAX demo's residual gate
GIB = 2 ** 30


def host_memory() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo, in bytes (empty where
    the file is missing)."""
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, val = line.split(":", 1)
                if key in ("MemTotal", "MemAvailable"):
                    out[key] = int(val.split()[0]) * 1024
    except OSError:
        pass
    return out


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=96,
                    help="grid size of poisson3d (n = nx^3)")
    ap.add_argument("--nb", type=int, default=128, help="block size")
    ap.add_argument("--ordering", default="nd",
                    choices=["nd", "rcm", "mindeg", "natural", "auto"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--device-gib", type=float, default=None, metavar="G",
                    help="cap the CUDA allocator at G GiB")
    ap.add_argument("--analyze", action="store_true",
                    help="stop after analyze (no factorization)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        # before CUDA starts: the cap counts the allocator's reserved
        # bytes, and fixed-size segments fragment them (poisson3d(96)
        # under a 16 GiB cap on an H100: 3.8 GiB reserved but free when
        # a 1.5 GiB cross was refused); expandable segments map pages
        # as needed
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    dev = resolve_device(args.device)
    out = {"nx": args.nx, "nb": args.nb, "ordering": args.ordering,
           "device": str(dev), "card": card_line(dev),
           "host_memory": host_memory(),
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    print(f"card: {out['card']}", flush=True)
    print("host: " + ", ".join(f"{k} {v / GIB:.1f} GiB"
                               for k, v in out["host_memory"].items()),
          flush=True)
    cap, limit, limit_name = None, None, None
    if args.device_gib is not None:
        if dev.type != "cuda":
            raise ValueError("--device-gib caps the CUDA caching allocator; "
                             "--device cpu has none")
        total = torch.cuda.mem_get_info(dev)[1]
        cap = int(args.device_gib * GIB)
        if not 0 < cap <= total:
            raise ValueError(f"--device-gib {args.device_gib} is not within "
                             f"the card's {total / GIB:.2f} GiB")
        torch.cuda.set_per_process_memory_fraction(cap / total, dev)
        out["cap_bytes"] = cap
        limit, limit_name = cap, f"the {args.device_gib:g} GiB cap"
    elif dev.type == "cuda":
        limit = torch.cuda.mem_get_info(dev)[1]
        limit_name = f"the card's {limit / GIB:.2f} GiB"

    t0 = time.perf_counter()
    a = poisson3d(args.nx)
    print(f"matrix n={a.n} nnz={a.nnz} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    out.update(n=a.n, nnz=a.nnz)
    opts = InitOptions(nb=args.nb, dtype="r32", ordering=args.ordering,
                       tile_storage="compressed", device=args.device)

    def sizes(tiles, dense_bytes, init_s, phases):
        out.update(tiles=tiles, dense_bytes=dense_bytes, init_s=init_s,
                   init_phase_s=phases)
        verdict = ("" if limit is None else
                   f" ({'EXCEEDS' if dense_bytes > limit else 'fits'} "
                   f"{limit_name})")
        print(f"init {init_s:.1f}s: {tiles} tiles, dense store "
              f"{dense_bytes / GIB:.2f} GiB{verdict}", flush=True)

    t0 = time.perf_counter()
    if args.analyze:
        info = analyze(a, opts)
        sizes(info["tiles"], info["factor_hbm_bytes"],
              time.perf_counter() - t0, info["phase_time_s"])
        out.update(block_length=info["block_length"], flops=info["flops"],
                   host_peak_rss_bytes=host_rss_bytes())
        print(json.dumps({"demo_outofcore": out}), flush=True)
        return out
    h = init(a, opts)
    nb = h.blocked.nb
    tiles = h.blocked.num_tiles
    # the dense store as analyze counts it: the tiles and the scratch tile
    sizes(tiles, (tiles + 1) * nb * nb * np.dtype(h.blocked.dtype).itemsize,
          time.perf_counter() - t0, dict(h.perf.phase_time))
    pre0 = h.perf.phase_time.get("preprocess", 0.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    gstrf(h)
    dt = time.perf_counter() - t0
    st = h.factor_tiles
    out.update(
        store_build_s=h.perf.phase_time["preprocess"] - pre0,
        numeric_s=h.perf.phase_time["numeric"], gstrf_s=dt,
        panels=h.perf.kernels.get("panels"),
        engine=type(h._factorizer).__name__,
        compressed_bytes=st.compressed_bytes,
        peak_allocated_bytes=(torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        gflops=h.schedule.flop_estimate() / dt / 1e9,
        fill_nnz_per_s=(h.perf.factor_nnz or 0) / max(dt, 1e-9))
    print(f"store host build {out['store_build_s']:.1f}s; "
          f"panels {out['panels']}", flush=True)
    if out["peak_allocated_bytes"] is not None:
        print(f"gstrf peak allocated {out['peak_allocated_bytes'] / GIB:.2f} "
              f"GiB vs dense store {out['dense_bytes'] / GIB:.2f} GiB",
              flush=True)
    print(f"gstrf {dt:.1f}s = {out['gflops']:.0f} GFLOPS (dense-tile "
          f"model) engine={out['engine']} compressed "
          f"{st.compressed_bytes / GIB:.2f} GiB", flush=True)
    print(f"factor fill {out['fill_nnz_per_s'] / 1e6:.2f} Mnnz/s over the "
          "full gstrf wall", flush=True)
    s = a.to_scipy()
    b = np.asarray(s @ np.ones(a.n), dtype=np.float32)
    t0 = time.perf_counter()
    x = gstrs(h, b)
    out["gstrs_s"] = time.perf_counter() - t0
    out["residual"] = residual_norm(s, x, b)
    out["ok"] = out["residual"] < GATE
    print(f"gstrs {out['gstrs_s']:.1f}s residual {out['residual']:.3e} "
          f"{'OK' if out['ok'] else 'FAIL'}", flush=True)
    finalize(h)
    out["host_peak_rss_bytes"] = host_rss_bytes()
    print(json.dumps({"demo_outofcore": out}), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(0 if main().get("ok", True) else 1)
