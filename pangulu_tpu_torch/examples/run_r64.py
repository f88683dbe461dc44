"""r64 at speed on the card: the counterpart of the JAX package's
``examples/run_r64_tpu.py``.  The TPU has no float64 datapath, so the
JAX package runs r64 there through its double-float engine; the H100
has one, so r64 runs natively on the ``double`` instances of K1 and of
the engine ``auto`` picks (K2/K3 or K4/K5).

    python -m pangulu_tpu_torch.examples.run_r64 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from pangulu_tpu_torch import InitOptions, finalize, gssv, init
from pangulu_tpu_torch.models import poisson3d
from pangulu_tpu_torch.utils.perf import residual_norm

NX = 12
LIMIT = 1e-12


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    a = poisson3d(NX)
    b = np.asarray(a.to_scipy() @ np.ones(a.n))
    h = init(a, InitOptions(nb=128, dtype="r64", device=args.device))
    x = gssv(h, b)
    res = residual_norm(a.to_scipy(), x, b)
    print(h.perf.summary())
    print(f"engine: {h.perf.kernels['engine']}, solve engine: "
          f"{h.perf.kernels['solve_engine']}")
    print(f"residual ||Ax-b||/||b|| = {res:.3e}")
    if not res < LIMIT:
        raise AssertionError(f"residual {res:.3e} is not below {LIMIT}")
    out = {"x": x, "residual": res, "handle": h}
    finalize(h)
    return out


if __name__ == "__main__":
    main()
