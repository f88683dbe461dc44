"""Inputs, tolerances and counts that the port's tests and
``chip_smoke.py`` share: for K1 (the diagonal step), tiles whose pivots
are exactly zero at a chosen step, and the bound that holds K1's blocked
step (128 < nb <= 256) against the rank-1 plain version; for the
compressed store, the launches its engine makes; for the TPU probes P3,
P4 and P5, their inputs."""

from __future__ import annotations

import numpy as np
import torch

from pangulu_tpu_torch.ops.kernels_torch import LU_SPLIT

# K1's blocked step against the rank-1 plain version: (rtol, atol) of
# the factor, L^-1 and U^-1.  In f32 the JAX package's bound for its
# blocked LU against the scan (tests/test_pallas.py:79-99); in f64 the
# contract's 1e-12.
BLOCKED_TOL = {torch.float32: ((3e-5, 3e-5), (2e-4, 2e-4), (2e-4, 2e-4)),
               torch.float64: ((1e-12, 1e-12),) * 3}


def tiny_pivot_tile(nb: int, k: int, rng) -> np.ndarray:
    """A diagonally dominant tile whose pivot at step k is exactly 0, so
    the tiny-pivot rule fires there: for k > 0 row k and column k copy
    row 0 and column 0 around a00 = 1, which step 0 zeroes exactly; for
    k = 0 the first row and column are zero.  Either way the huge
    entries 1/tol of the inverses are exact products, not sums that a
    different order could round apart."""
    a = rng.standard_normal((nb, nb)) + nb * np.eye(nb)
    if k == 0:
        a[0, :] = 0.0
        a[:, 0] = 0.0
    else:
        a[0, 0] = 1.0
        a[k, :] = a[0, :]
        a[:, k] = a[:, 0]
    return a


def blocked_tiny_pivot_tile(nb: int, k1: int, k2: int, rng) -> np.ndarray:
    """A tile of nb > LU_SPLIT whose pivots at step k1 of A11 and step
    k2 of A22 (split at LU_SPLIT) are exactly 0 in the rank-1 scan and
    in the blocked step alike: each diagonal block is a tiny_pivot_tile,
    A12 = 0 (so A22 is never updated), and A21 is random except its
    columns 0 and k1, which would meet U11^-1's 1/tol entries."""
    h = LU_SPLIT
    a = np.zeros((nb, nb))
    a[:h, :h] = tiny_pivot_tile(h, k1, rng)
    a[h:, h:] = tiny_pivot_tile(nb - h, k2, rng)
    a[h:, :h] = rng.standard_normal((nb - h, h))
    a[h:, [0, k1]] = 0.0
    return a


def compressed_launches(schedule, factorizations: int = 0, solves: int = 0,
                        reloads: int = 0) -> dict:
    """The kernel launches of ``CompressedLU`` (the keys of
    ``kernels_cuda.LAUNCHES`` it uses) for that many factorizations,
    solves (one ``solve_blocked`` call each) and first solves of a
    reloaded store, from the level structure: a factorization launches
    K1 once a level and decompresses and compresses the diagonal tile
    and each non-empty L panel, U panel and update batch; a solve
    decompresses each non-empty L panel (forward) and U column panel
    (backward); a reloaded store first decompresses its diagonal tiles
    in one batch and forms their inverses in one P2 launch."""
    lv = schedule.levels
    stage = sum(1 + (len(v.lpanel) > 0) + (len(v.upanel) > 0)
                + (len(v.upd_dst) > 0) for v in lv)
    panels = sum((len(v.lpanel) > 0) + (len(v.ucolpanel) > 0) for v in lv)
    return {"getrf_with_inverses": factorizations * len(lv),
            "decompress_tiles": (factorizations * stage + solves * panels
                                 + reloads),
            "compress_tiles": factorizations * stage,
            "newton_inverses": reloads}


def probe_inputs(seed: int = 0, nb: int = 128):
    """The inputs of the TPU probes P4 and P5 (tools/exp_scan_multi.py
    and tools/exp_overlap.py main), drawn with numpy: a = I + 0.01 z and
    b = 0.01 z, float32 [nb, nb], one standard normal z for both (the
    probes draw a and b from one key).  a's spectral radius is ~1.1 at
    nb = 128 (1.104 for seed 0), so the chain of products a^s b reaches
    ~5e9 at s = 256 and leaves float32's range long before the probes'
    2048 and 4096 steps."""
    z = np.random.default_rng(seed).standard_normal((nb, nb))
    z = z.astype(np.float32)
    a = np.eye(nb, dtype=np.float32) + np.float32(0.01) * z
    return a, np.float32(0.01) * z


def newton_inputs(g: int, nb: int, seed: int = 0) -> np.ndarray:
    """P3's input (tools/exp_batched_scan.py main): g unit lower
    triangles I + tril(z, -1), float32 [g, nb, nb], z standard normal."""
    z = np.random.default_rng(seed).standard_normal((g, nb, nb))
    return (np.tril(z, -1) + np.eye(nb)).astype(np.float32)
