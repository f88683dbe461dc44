#!/usr/bin/env python3
"""Digests of the factors that the main paths give on one NVIDIA GPU,
for the package of this checkout or of another tree, so that two trees
can be compared bit for bit:

    python3 pangulu_tpu_torch/tools/probe_factor_bits.py [--root DIR]

With PANGULU_TPU_SUPERLEVEL unset, init -> gstrf -> gstrs on
poisson3d(32), r32: rcm and nd at nb = 128 and 256 on the dense store
(the engine ``auto`` picks), the chain engine forced on each nd
schedule (``dispatch="mega"``, with a digest of its tables), and nd at
nb=128 on the compressed store (the panel route).  For each: the
engine, the kernel launches (kernels_cuda.LAUNCHES), the first 16 hex
digits of the SHA-256 of the factored tiles (the store's slots on the
panel route) and the inverses, and of the solution.  The package is
imported from DIR (default: this checkout), which must be where it
lies.  It prints one JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]

# (label, nb, ordering, tile storage), r32
PATHS = (("rcm128", 128, "rcm", "dense"), ("nd128", 128, "nd", "dense"),
         ("rcm256", 256, "rcm", "dense"), ("nd256", 256, "nd", "dense"),
         ("nd128_panel", 128, "nd", "compressed"))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.environ.pop("PANGULU_TPU_SUPERLEVEL", None)
    import pangulu_tpu_torch as pt
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.numeric import LUFactorizer
    from pangulu_tpu_torch.ops import kernels_cuda as kc

    if not pt.__file__.startswith(root):
        raise RuntimeError(f"imported {pt.__file__}, not from {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    kc.library()
    dev = torch.device("cuda", 0)
    a = poisson3d(32)
    b = a.to_scipy() @ np.ones(a.n)
    out = {}
    for label, nb, ordering, storage in PATHS:
        kc.reset_launch_counts()
        h = pt.init(a, pt.InitOptions(nb=nb, dtype="r32", ordering=ordering,
                                      device="cuda", tile_storage=storage))
        pt.gstrf(h)
        x = pt.gstrs(h, b)
        f = h._factorizer
        tiles = f.store.values if storage == "compressed" else h.factor_tiles
        out[label] = dict(engine=h.perf.kernels["engine"],
                          launches={k: v for k, v in kc.LAUNCHES.items()
                                    if v},
                          bits=digest(tiles, f.inv_tiles),
                          x=digest(torch.as_tensor(x)))
        if ordering == "nd" and storage == "dense":
            m = LUFactorizer(h.blocked, h.schedule, device=dev,
                             dispatch="mega")
            t = m.factorize()
            tables = hashlib.sha256(b"".join(
                np.ascontiguousarray(v).tobytes()
                for _, v in sorted(m.tables.host.items())
                if isinstance(v, np.ndarray))).hexdigest()[:16]
            out[label + "_mega"] = dict(bits=digest(t, m.inv_tiles),
                                        tables=tables)
    print(json.dumps({"bits": out}))
    return out


if __name__ == "__main__":
    main()
