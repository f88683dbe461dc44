"""Model-problem matrix generators used as test fixtures and benchmarks.

The reference ships a single fixture (``examples/Trefethen_20b.mtx``,
README.md:145-153).  We generate the same family programmatically plus
standard model problems so tests and benches need no external files.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from pangulu_tpu_torch.sparse import CscMatrix


def _primes(count: int) -> np.ndarray:
    out, cand = [], 2
    while len(out) < count:
        if all(cand % p for p in out):
            out.append(cand)
        cand += 1
    return np.array(out, dtype=np.float64)


def trefethen(n: int = 20, drop_first: bool = True, dtype=np.float64) -> CscMatrix:
    """Trefethen's prime-diagonal matrix (SuiteSparse ``Trefethen_*``).

    ``T[i,i] = i-th prime``; ``T[i,j] = 1`` when ``|i-j|`` is a power of
    two.  ``drop_first=True`` deletes row/col 0, producing the ``_b``
    variant — ``trefethen(20)`` matches the reference's
    ``Trefethen_20b`` fixture (19x19, 147 nnz).
    """
    d = _primes(n)
    a = sp.diags(d, format="lil")
    k = 1
    while k < n:
        a += sp.diags(np.ones(n - k), k, format="lil")
        a += sp.diags(np.ones(n - k), -k, format="lil")
        k *= 2
    a = sp.csc_matrix(a)
    if drop_first:
        a = a[1:, 1:]
    return CscMatrix.from_scipy(a.astype(dtype))


def poisson2d(nx: int, dtype=np.float64) -> CscMatrix:
    """5-point 2D Laplacian on an nx*nx grid (SPD)."""
    one = np.ones(nx)
    t = sp.diags([-one[:-1], 2 * one, -one[:-1]], [-1, 0, 1], format="csc")
    eye = sp.identity(nx, format="csc")
    a = sp.kron(t, eye) + sp.kron(eye, t)
    return CscMatrix.from_scipy(sp.csc_matrix(a).astype(dtype))


def poisson3d(nx: int, dtype=np.float64) -> CscMatrix:
    """7-point 3D Laplacian on an nx^3 grid (SPD, nlpkkt-class fill)."""
    one = np.ones(nx)
    t = sp.diags([-one[:-1], 2 * one, -one[:-1]], [-1, 0, 1], format="csc")
    eye = sp.identity(nx, format="csc")
    a = (
        sp.kron(sp.kron(t, eye), eye)
        + sp.kron(sp.kron(eye, t), eye)
        + sp.kron(sp.kron(eye, eye), t)
    )
    return CscMatrix.from_scipy(sp.csc_matrix(a).astype(dtype))


def random_unsymmetric(
    n: int, density: float = 0.01, seed: int = 0, dtype=np.float64
) -> CscMatrix:
    """Random diagonally-dominated unsymmetric matrix (well-conditioned
    enough for unpivoted LU after MC64-style scaling)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, random_state=rng, format="csc",
                  data_rvs=lambda k: rng.standard_normal(k))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        b = sp.random(n, n, density=density, random_state=rng, format="csc",
                      data_rvs=lambda k: rng.standard_normal(k))
        a = a.astype(np.complex128) + 1j * b
    a = a + sp.diags(
        (np.abs(a).sum(axis=1).A1 if hasattr(np.abs(a).sum(axis=1), "A1")
         else np.asarray(np.abs(a).sum(axis=1)).ravel()) + 1.0
    )
    return CscMatrix.from_scipy(sp.csc_matrix(a).astype(dtype))


def smallworld(nx: int, long_range: float = 0.05, seed: int = 0,
               dtype=np.float64) -> CscMatrix:
    """2D grid + random long-range couplings — a stand-in for the
    irregular circuit/power-network matrices PanguLU targets: mostly
    local structure, but enough scattered entries that bandwidth
    orderings alone cannot contain the fill."""
    rng = np.random.default_rng(seed)
    base = poisson2d(nx, dtype=np.float64).to_scipy()
    n = base.shape[0]
    m = max(int(long_range * n), 1)
    r = rng.integers(0, n, size=m)
    c = rng.integers(0, n, size=m)
    v = rng.standard_normal(m) * 0.1
    extra = sp.csc_matrix((v, (r, c)), shape=(n, n))
    a = base + extra + extra.T.multiply(0.5)  # unsymmetric values
    return CscMatrix.from_scipy(sp.csc_matrix(a).astype(dtype))


def arrowhead(n: int, dtype=np.float64) -> CscMatrix:
    """Arrowhead matrix — worst case for natural ordering, best case for
    fill-reducing ordering; exercises the reorder path."""
    a = sp.lil_matrix((n, n))
    a.setdiag(np.arange(2, n + 2, dtype=np.float64))
    a[0, :] = 1.0
    a[:, 0] = 1.0
    a[0, 0] = float(n)
    return CscMatrix.from_scipy(sp.csc_matrix(a).astype(dtype))


def circuit(n: int, seed: int = 0, dtype=np.float64) -> CscMatrix:
    """Synthetic circuit-simulation (modified-nodal-analysis-like)
    matrix — the reference's target class (README.md:131-153 validates
    on SuiteSparse circuit matrices, which cannot be downloaded in
    this environment): pattern-unsymmetric, wildly scaled values
    (conductances spanning ~8 decades),
    a fraction of STRUCTURALLY ZERO diagonal entries (voltage-source
    rows), and a few dense rows/columns (supply rails).  Unpivoted LU
    fails outright on it without MC64 matching+scaling."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r)
        cols.append(c)
        vals.append(v)

    # sparse irregular conductance couplings (unsymmetric pattern)
    m = 4 * n
    r = rng.integers(0, n, size=m)
    c = rng.integers(0, n, size=m)
    scale = 10.0 ** rng.uniform(-6, 2, size=m)
    for i in range(m):
        if r[i] != c[i]:
            add(int(r[i]), int(c[i]), float(scale[i]
                                            * rng.choice([-1.0, 1.0])))
    # a few dense "supply rail" rows and columns
    for rail in rng.integers(0, n, size=max(n // 200, 2)):
        js = rng.integers(0, n, size=n // 10)
        for j in js:
            add(int(rail), int(j), float(10.0 ** rng.uniform(-6, 0)))
            add(int(j), int(rail), float(10.0 ** rng.uniform(-6, 0)))
    # diagonals: most present (dominant-ish), ~10% structurally zero
    # (their pivots must come from MC64 row matching)
    zero_diag = set(rng.choice(n, size=n // 10, replace=False).tolist())
    for j in range(n):
        if j not in zero_diag:
            add(j, j, float(10.0 ** rng.uniform(-5, 2)))
        else:
            # give the matched row somewhere to pivot from: a strong
            # off-diagonal pair
            k = int((j + 1 + rng.integers(0, n - 1)) % n)
            if k != j:
                add(j, k, float(10.0 ** rng.uniform(0, 2)))
                add(k, j, float(10.0 ** rng.uniform(0, 2)))
    a = sp.csc_matrix(
        (np.array(vals), (np.array(rows), np.array(cols))), shape=(n, n))
    a.sum_duplicates()
    return CscMatrix.from_scipy(sp.csc_matrix(a).astype(dtype))
