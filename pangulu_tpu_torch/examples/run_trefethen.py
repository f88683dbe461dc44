"""Smoke example: the reference's documented smoke test (README.md:145-
153: Trefethen_20b.mtx, nb=10) on a generated fixture, r64; the
counterpart of the JAX package's ``examples/run_trefethen.py``.

    python -m pangulu_tpu_torch.examples.run_trefethen [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from pangulu_tpu_torch import InitOptions, Solver
from pangulu_tpu_torch.io.mmio import generated_rhs
from pangulu_tpu_torch.models import trefethen
from pangulu_tpu_torch.utils.perf import residual_norm

LIMIT = 1e-12


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    a = trefethen(20)           # 19x19, 147 nnz == Trefethen_20b
    b = generated_rhs(a)        # b = A @ 1
    solver = Solver(a, InitOptions(nb=10, dtype="r64", check=True,
                                   device=args.device))
    x = solver.solve(b)
    res = residual_norm(a.to_scipy(), x, b)
    print(solver.perf.summary())
    print(f"||Ax-b||/||b|| = {res:.3e}  (exact solution is ones; "
          f"max |x-1| = {np.abs(x - 1).max():.3e})")
    if not res < LIMIT:
        raise AssertionError(f"residual {res:.3e} is not below {LIMIT}")
    return {"x": x, "residual": res, "handle": solver.handle}


if __name__ == "__main__":
    main()
