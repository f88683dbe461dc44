"""Factor-many workflow: one symbolic analysis, many numeric
factorizations (time-stepping / Newton-type outer loops); the
counterpart of the JAX package's ``examples/run_refactorize.py``.

    python -m pangulu_tpu_torch.examples.run_refactorize [--device cpu]

``update_values`` swaps in a same-pattern matrix in O(nnz) and reuses
the reordering, symbolic pattern, tiling and schedule; ``gstrf``
refactors.  The reference requires finalize+init for every new matrix
(README.md:125).
"""

from __future__ import annotations

import argparse

import numpy as np

from pangulu_tpu_torch import InitOptions, gstrf, gstrs, init, update_values
from pangulu_tpu_torch.models import poisson2d
from pangulu_tpu_torch.utils.perf import residual_norm

STEPS = 4
LIMIT = 1e-10


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    a = poisson2d(40)
    s = a.to_scipy()
    h = init(a, InitOptions(nb=32, dtype="r64", device=args.device))
    rng = np.random.default_rng(0)
    xs, residuals = [], []
    for step in range(STEPS):
        b = np.asarray(s @ np.ones(a.n))
        gstrf(h)
        x = gstrs(h, b)
        res = residual_norm(s, x, b)
        print(f"step {step}: residual {res:.3e}")
        if not res < LIMIT:
            raise AssertionError(f"step {step}: residual {res:.3e} is not "
                                 f"below {LIMIT}")
        xs.append(x)
        residuals.append(res)
        # perturb values (same pattern) like a time step would
        s = s.copy()
        s.data = s.data * (1.0 + 0.05 * rng.standard_normal(s.nnz))
        update_values(h, s)
    return {"x": xs, "residual": residuals, "handle": h}


if __name__ == "__main__":
    main()
