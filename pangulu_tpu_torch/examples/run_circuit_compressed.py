"""Circuit-class matrix (MC64-requiring) with compressed tile storage,
r64; the counterpart of the JAX package's
``examples/run_circuit_compressed.py``.

    python -m pangulu_tpu_torch.examples.run_circuit_compressed [--device cpu]

It prints the store's bytes against the dense tile store's, and the
residual (the circuit matrices are near singular, cond ~1e16).
"""

from __future__ import annotations

import argparse

import numpy as np

from pangulu_tpu_torch.api import InitOptions, finalize, gssv, init
from pangulu_tpu_torch.models import circuit
from pangulu_tpu_torch.utils.perf import residual_norm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    a = circuit(3000, seed=4)
    b = np.asarray(a.to_scipy() @ np.ones(a.n))
    h = init(a, InitOptions(nb=32, dtype="r64", ordering="mindeg",
                            tile_storage="compressed", device=args.device))
    x = gssv(h, b)
    st = h.factor_tiles
    print(f"device store: {st.compressed_bytes / 2**20:.1f} MiB compressed "
          f"vs {st.dense_bytes / 2**20:.1f} MiB dense "
          f"({st.dense_bytes / st.compressed_bytes:.1f}x)")
    res = residual_norm(a.to_scipy(), x, b)
    print("residual:", res)
    out = {"x": x, "residual": res, "compressed_bytes": st.compressed_bytes,
           "dense_bytes": st.dense_bytes, "handle": h}
    finalize(h)
    return out


if __name__ == "__main__":
    main()
