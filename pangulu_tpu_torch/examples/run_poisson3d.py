"""Single-card performance demo: factor a 3D Poisson problem with the
chain engine (K1, K2) and solve it with the whole-solve kernel (K3); the
counterpart of the JAX package's ``examples/run_tpu_bench.py``, with
its options (r32, rcm, nb=128, the block symbolic phase).

    python -m pangulu_tpu_torch.examples.run_poisson3d [nx] [--device cpu]

The gstrf time is the host clock around ``gstrf``, which waits for the
card; its GFLOPS count the dense-tile flops of the schedule.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init
from pangulu_tpu_torch.models import poisson3d
from pangulu_tpu_torch.utils.perf import residual_norm

NX = 32
LIMIT = 1e-10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nx", type=int, nargs="?", default=NX)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    a = poisson3d(args.nx)
    print(f"poisson3d({args.nx}): n={a.n}, nnz={a.nnz}")
    h = init(a, InitOptions(nb=128, dtype="r32", ordering="rcm",
                            symbolic_mode="block", device=args.device))
    t0 = time.perf_counter()
    gstrf(h)
    gstrf_s = time.perf_counter() - t0
    print(f"gstrf: {gstrf_s:.3f} s ({h.perf.gflops('numeric'):.1f} GFLOPS "
          f"incl. sync), engine {h.perf.kernels['engine']}")
    b = np.asarray(a.to_scipy() @ np.ones(a.n, dtype=np.float32))
    x = gstrs(h, b)
    res = residual_norm(a.to_scipy(), x, b)
    print(h.perf.summary())
    print(f"solve residual ||Ax-b||/||b|| = {res:.3e}")
    if not res < LIMIT:
        raise AssertionError(f"residual {res:.3e} is not below {LIMIT}")
    return {"x": x, "residual": res, "handle": h, "gstrf_s": gstrf_s,
            "gflops": h.perf.gflops("numeric")}


if __name__ == "__main__":
    main()
