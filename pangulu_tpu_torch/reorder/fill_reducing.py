"""Fill-reducing symmetric ordering.

Counterpart of the reference's METIS nested-dissection path
(pangulu_reordering.c:683-1272: build A+A^T graph, METIS_NodeND,
identity fallback).  METIS is not available in this environment, so we
provide:

  * ``"mindeg"`` — a quotient-graph minimum-degree ordering (pure
    Python; the classic fill-reduction heuristic behind AMD),
  * ``"rcm"``    — reverse Cuthill–McKee via scipy (C speed, good for
    banded problems),
  * ``"natural"``— identity (the reference's no-METIS fallback,
    pangulu_reordering.c:1237-1240),
  * ``"auto"``   — mindeg for small/medium n, rcm beyond.

All operate on the structural symmetrization A+A^T without self loops,
exactly like pangulu_get_graph_struct_csc (pangulu_reordering.c:957).
"""

from __future__ import annotations

import heapq

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from pangulu_tpu_torch.sparse import CscMatrix, symmetrize_pattern

_MINDEG_MAX_N = 15000


def fill_reducing_order(a: CscMatrix, method: str = "auto",
                        nb: int = 0) -> np.ndarray:
    """Return permutation ``p`` so that ``A[p][:, p]`` has low fill.

    ``nb``: tile size hint for the "nd" method — part sizes align to
    nb multiples so disjoint subtrees occupy disjoint tile columns
    (enables super-level batching, schedule.Schedule.superlevels)."""
    if method == "natural":
        return np.arange(a.n, dtype=np.int64)
    if method == "auto":
        method = "mindeg" if a.n <= _MINDEG_MAX_N else "rcm"
    sym = symmetrize_pattern(a)
    if method == "rcm":
        return np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True),
                          dtype=np.int64)
    if method == "nd":
        from pangulu_tpu_torch import native

        csr = sym.tocsr()
        leaf = max(128, nb) if nb else 128
        order = native.ndorder(sym.shape[0], csr.indptr, csr.indices,
                               leaf_size=leaf, align_nb=nb)
        if order is not None:
            return order
        return _nested_dissection(sym)
    if method == "mindeg":
        from pangulu_tpu_torch import native

        csr = sym.tocsr()
        order = native.mindeg(sym.shape[0], csr.indptr, csr.indices)
        if order is not None:
            return order
        return _minimum_degree(sym)
    raise ValueError(f"unknown ordering method {method!r}")


def _bfs_levels(adj: sp.csr_matrix, start: int) -> np.ndarray:
    """Vectorized BFS level numbers (-1 = unreached)."""
    n = adj.shape[0]
    level = np.full(n, -1, dtype=np.int64)
    frontier = np.zeros(n, dtype=bool)
    frontier[start] = True
    lvl = 0
    while frontier.any():
        level[frontier] = lvl
        nxt = np.asarray(adj @ frontier) != 0
        frontier = nxt & (level == -1)
        lvl += 1
    return level


def _nested_dissection(sym: sp.csc_matrix, min_part: int = 96) -> np.ndarray:
    """Simple BFS-separator nested dissection (the reference's METIS
    role, pangulu_reordering.c:1080: order two halves first, the vertex
    separator last, recurse).  Separators are median BFS level sets
    from a pseudo-peripheral start — far from METIS quality, but the
    classic asymptotics for mesh-like graphs; the auto policy in
    :func:`pangulu_tpu_torch.api.init` only picks it when it measurably
    yields the smallest block pattern."""
    n = sym.shape[0]
    order: list = []

    def leaf(nodes: np.ndarray):
        sub = sym[nodes][:, nodes]
        r = reverse_cuthill_mckee(sub.tocsr(), symmetric_mode=True)
        order.extend(nodes[np.asarray(r)])

    stack = [(np.arange(n, dtype=np.int64), False)]
    # iterative post-order: (nodes, expanded); separators appended after
    # both parts via the 'sep' marker entries
    while stack:
        nodes, is_sep = stack.pop()
        if is_sep:
            order.extend(nodes)
            continue
        if len(nodes) <= min_part:
            leaf(nodes)
            continue
        sub = sym[nodes][:, nodes].tocsr()
        deg = np.diff(sub.indptr)
        start = int(np.argmin(deg))
        lev = _bfs_levels(sub, start)
        # pseudo-peripheral refinement: restart from a farthest node
        far = int(np.argmax(np.where(lev >= 0, lev, -1)))
        lev = _bfs_levels(sub, far)
        unreached = lev < 0
        maxl = int(lev.max())
        if maxl < 2:
            leaf(nodes)  # (near-)complete or tiny-diameter graph
            continue
        # separator = the level set balancing the two sides
        counts = np.bincount(lev[~unreached], minlength=maxl + 1)
        below = np.cumsum(counts) - counts
        above = len(nodes) - np.cumsum(counts) - unreached.sum()
        m = int(np.argmin(np.abs(below - above)[1:maxl])) + 1
        a_part = nodes[(lev < m) & ~unreached]
        b_part = nodes[((lev > m) & ~unreached) | unreached]
        s_part = nodes[lev == m]
        if len(a_part) == 0 or len(b_part) == 0:
            leaf(nodes)
            continue
        stack.append((s_part, True))       # eliminated last
        stack.append((b_part, False))
        stack.append((a_part, False))

    p = np.asarray(order, dtype=np.int64)
    assert len(p) == n and len(np.unique(p)) == n
    return p


def _minimum_degree(sym: sp.csc_matrix) -> np.ndarray:
    """Minimum-degree ordering on a symmetric pattern.

    Quotient-graph formulation: eliminated vertices become "elements";
    a live vertex's adjacency is (its uneliminated original neighbours)
    union (members of adjacent elements).  Lazy heap with stale-entry
    skipping; element absorption keeps reach computations shallow.
    """
    n = sym.shape[0]
    indptr, indices = sym.indptr, sym.indices
    # Adjacency sets without self loops.
    adj = [set(indices[indptr[i]:indptr[i + 1]]) - {i} for i in range(n)]
    elem_members: dict[int, set] = {}   # element id -> absorbed vertices
    vert_elems = [set() for _ in range(n)]  # vertex -> adjacent element ids
    alive = np.ones(n, dtype=bool)
    degree = np.array([len(s) for s in adj], dtype=np.int64)
    heap = [(int(degree[i]), i) for i in range(n)]
    heapq.heapify(heap)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    while heap:
        d, v = heapq.heappop(heap)
        if not alive[v] or d != degree[v]:
            continue
        # Reach(v) = adj(v) ∪ members of v's adjacent elements, alive only.
        reach = set(u for u in adj[v] if alive[u])
        for e in vert_elems[v]:
            reach |= elem_members[e]
        reach.discard(v)
        reach = {u for u in reach if alive[u]}
        order[pos] = v
        pos += 1
        alive[v] = False
        # v becomes a new element absorbing its adjacent elements.
        eid = v
        elem_members[eid] = reach
        absorbed = vert_elems[v]
        for u in reach:
            adj[u].discard(v)
            vert_elems[u] -= absorbed
            vert_elems[u].add(eid)
            # Approximate degree: |adj alive| + |union of element members|
            # approximated by sum (AMD-style overcount, cheap).
            deg = sum(1 for w in adj[u] if alive[w])
            seen = 0
            for e in vert_elems[u]:
                seen += len(elem_members[e])
            degree[u] = deg + max(seen - 1, 0)
            heapq.heappush(heap, (int(degree[u]), u))
        for e in absorbed:
            if e in elem_members and e != eid:
                del elem_members[e]
    return order
