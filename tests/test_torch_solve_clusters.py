"""A numpy emulation of K3's and K5's sweeps at tile width 256 on thread
block clusters (``csrc/solve_clusters.cuh`` solve_cluster_kernel,
group_cluster_kernel), which run only on the card: which CTA owns which
rows (CTA c of a cluster of C the rows [c R, c R + R), R = 256 / C,
rows past nb owned by nobody), each CTA's shared memory (K3's two
stages of staged rows, the x_k rows it publishes, the x_k it gathers;
K5's v rows and v), the gather of x_k or v from the peers' shared memory
after a cluster barrier, the staging of the next level by cp.async
before the barrier, and where the cluster and grid barriers fall.

Every buffer starts as NaN and every access is logged with the clocks
of the barriers: a CTA barrier orders a CTA's threads and its cp.async
copies (an agent of their own, ordered with the CTA by the wait and the
barrier after it), a cluster barrier the CTAs of one cluster, a grid
barrier all of them.
The checks:

  * no CTA reads or writes a cell that another agent wrote, and no
    agent writes a cell that another read, unless a barrier lies
    between them (the kernels take no other ordering between CTAs);
  * nothing reads a cell that was never written or staged (a NaN);
  * the result is the plain twins' (``kernels_torch.mega_solve``,
    ``mega_solve_groups``) bit for bit, on integer-valued tiles,
    inverses and right-hand sides, whose sums are exact in float64 in
    any order.

The port's solves against the JAX package at nb=256 are held by
``tests/test_torch_nb256.py::test_solve_matches_jax``.
"""

import functools

import numpy as np
import pytest
import torch

import pangulu_tpu_torch as pt
from pangulu_tpu_torch.models import poisson3d, random_unsymmetric
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.schedule import group_solve_steps

MAX_NB = 256   # csrc kMaxNb: the rows a cluster splits
RHS_CHUNK = 4  # csrc SweepSmem::kRhs: the RHS a K3 cluster takes at once
OLD_TILES = 8  # csrc SweepSmem::kOldTiles: tiles whose old rows K3 stages
# the cluster sizes emulated: the kernels' (csrc kSolveCluster = 16,
# kGroupCluster = 4) and those tools/probe_solve_sweeps.py edits in
SOLVE_CLUSTERS = (4, 8, 16)
GROUP_CLUSTERS = (2, 4, 8, 16)


def stage_mats(c: int, elt: int) -> int:
    """csrc SweepSmem<T, C>::kMats: the matrices' rows of a level
    (the inverse, then kMats - 1 panel tiles) a stage holds, for
    elements of elt bytes."""
    return 200 * 1024 // (2 * (MAX_NB // c) * MAX_NB * elt)


class Grid:
    """The agents of a grid of q clusters of c CTAs (ids 0 .. q c - 1)
    and of their cp.async copies (ids q c .. 2 q c - 1), with the
    barrier clocks that order them."""

    def __init__(self, q: int, c: int):
        self.q, self.c, self.n = q, c, q * c
        self.ct = np.zeros(q * c, np.int64)  # CTA barriers, per CTA
        self.cl = np.zeros(q, np.int64)      # cluster barriers
        self.gr = 0                          # grid barriers

    def cluster_of(self, agent):
        return agent % self.n // self.c

    def cta_barrier(self, a: int):
        """__syncthreads of CTA a (after a cp.async wait: its copies)."""
        self.ct[a] += 1

    def cluster_barrier(self, q: int):
        self.ct[q * self.c:(q + 1) * self.c] += 1
        self.cl[q] += 1

    def grid_barrier(self):
        self.ct += 1
        self.cl += 1
        self.gr += 1


class Buf:
    """One array (x in global memory, or a buffer of one CTA's shared
    memory) whose every access is checked against the grid's clocks."""

    def __init__(self, name: str, shape, grid: Grid, init=None):
        self.name, self.g = name, grid
        self.val = (np.full(shape, np.nan) if init is None
                    else np.array(init, dtype=np.float64))
        n = self.val.size
        self.w_ag = np.full(n, -1)
        self.w_ct = np.zeros(n, np.int64)
        self.w_cl = np.zeros(n, np.int64)
        self.w_gr = np.zeros(n, np.int64)
        # per agent that read it: the clocks of its last read of each
        # cell since the cell's last write (-1: none)
        self.reads: dict = {}

    def _ordered(self, then_ag, then, agent):
        """Is an access of then_ag at clocks then = (CTA, cluster, grid)
        ordered before one of agent now?  Vectorised over cells."""
        g = self.g
        a, q = agent % g.n, g.cluster_of(agent)
        then_ct, then_cl, then_gr = then
        same_cta = then_ag % g.n == a
        same_cl = g.cluster_of(then_ag) == q
        return ((then_ag == agent) | (same_cta & (g.ct[a] > then_ct))
                | (same_cl & (g.cl[q] > then_cl)) | (g.gr > then_gr))

    def _clocks(self, agent):
        g = self.g
        return g.ct[agent % g.n], g.cl[g.cluster_of(agent)], g.gr

    def _flat(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        return np.ravel_multi_index(idx, self.val.shape).ravel()

    def read(self, agent: int, idx):
        f = self._flat(idx)
        w = self.w_ag[f]
        ok = (w < 0) | self._ordered(
            w, (self.w_ct[f], self.w_cl[f], self.w_gr[f]), agent)
        assert ok.all(), f"{self.name}: agent {agent} reads a cell written " \
                         "by another without a barrier between"
        v = self.val.ravel()[f]
        assert not np.isnan(v).any(), f"{self.name}: agent {agent} reads " \
                                      "a cell never written or staged"
        if agent not in self.reads:
            self.reads[agent] = np.full((3, self.val.size), -1)
        self.reads[agent][:, f] = np.array(self._clocks(agent))[:, None]
        return v.reshape(np.shape(self.val[idx]))

    def write(self, agent: int, idx, vals):
        f = self._flat(idx)
        w = self.w_ag[f]
        ok = (w < 0) | self._ordered(
            w, (self.w_ct[f], self.w_cl[f], self.w_gr[f]), agent)
        assert ok.all(), f"{self.name}: agent {agent} writes a cell " \
                         "another wrote without a barrier between"
        for b, rd in self.reads.items():
            seen = rd[0, f] >= 0
            if b != agent and seen.any():
                ok = self._ordered(np.full(seen.sum(), b),
                                   tuple(rd[:, f][:, seen]), agent)
                assert ok.all(), f"{self.name}: agent {agent} writes a " \
                                 f"cell agent {b} read without a barrier " \
                                 "between"
        self.val.ravel()[f] = np.broadcast_to(vals, np.shape(
            self.val[idx])).ravel()
        self.w_ag[f] = agent
        self.w_ct[f], self.w_cl[f], self.w_gr[f] = self._clocks(agent)
        for rd in self.reads.values():
            rd[0, f] = -1


def own_rows(c: int, rank: int, nb: int) -> np.ndarray:
    """csrc RowSplit: the rows CTA rank of a cluster of c owns."""
    r = MAX_NB // c
    return np.arange(rank * r, min(nb, rank * r + r))


def gather(a: int, pubs, c: int, nb: int, at) -> np.ndarray:
    """CTA a's gather of a vector of nb rows from the shared memory of
    its cluster's CTAs (pubs, by rank), each holding its own rows at
    pubs[rank][at + (:rows,)] (at: an index or a tuple of them)."""
    at = at if isinstance(at, tuple) else (at,)
    out = np.empty(nb)
    for rank, pb in enumerate(pubs):
        own = own_rows(c, rank, nb)
        if len(own):
            out[own] = pb.read(a, np.ix_(*[[i] for i in at],
                                         np.arange(len(own)))).ravel()
    return out


def k3_sweep(x, y, tiles, invs, slot, tab, bl, nb, descending, c, q, mats):
    """One sweep of solve_cluster_kernel on q clusters of c CTAs (RHS r
    on cluster r mod q): x (Buf, [nrhs, bl + 1, nb]) the source, y (Buf)
    the destination; mats: the matrices a stage holds (0: none)."""
    ids, rows, cnt = (np.asarray(tab[k]) for k in ("ids", "rows", "cnt"))
    g, nrhs, r = x.g, x.val.shape[0], MAX_NB // c
    ntile = max(mats - 1, 0)
    stage = [Buf(f"stage{a}", (2, max(mats, 1), r, nb), g)
             for a in range(g.n)]
    olds = [Buf(f"olds{a}", (OLD_TILES, RHS_CHUNK, r), g)
            for a in range(g.n)]
    pub = [Buf(f"pub{a}", (RHS_CHUNK, r), g) for a in range(g.n)]
    xk = [Buf(f"xk{a}", (RHS_CHUNK, nb), g) for a in range(g.n)]

    def level(s):
        return bl - 1 - s if descending else s

    def issue(a, s):
        """CTA a's copies of level s's rows into stage buffer s % 2."""
        k = level(s)
        own = own_rows(c, a % c, nb)
        if not len(own):
            return
        mats_k = [invs[k, slot]] + [tiles[ids[k, t]] for t in
                                    range(cnt[k])[:ntile]]
        for m, mat in enumerate(mats_k):
            stage[a].write(g.n + a, np.ix_([s % 2], [m], range(len(own)),
                                           range(nb)), mat[own])

    passes = {qq: list(range(qq, nrhs, q * RHS_CHUNK)) for qq in range(q)}
    npass = max(len(p) for p in passes.values())
    for pi in range(npass):
        for a in range(g.n):
            if pi < len(passes[a // c]) and mats:
                issue(a, 0)
        for s in range(bl):
            k = level(s)
            # barrier A: the copies have landed (wait), x's source rows
            # are whole
            for qq in range(q):
                g.cluster_barrier(qq)
            for qq in range(q):
                if pi >= len(passes[qq]):
                    continue
                rb = passes[qq][pi]
                hs = list(range(rb, nrhs, q))[:RHS_CHUNK]
                tl = range(cnt[k])
                for a in range(qq * c, qq * c + c):   # the old values
                    own = own_rows(c, a % c, nb)
                    for m, t in enumerate(tl[:OLD_TILES]):
                        for h, rr in enumerate(hs):
                            if len(own):
                                olds[a].write(g.n + a, np.ix_(
                                    [m], [h], range(len(own))), x.read(
                                        g.n + a,
                                        np.ix_([rr], [rows[k, t]], own))[0, 0])
            for a in range(g.n):
                if pi < len(passes[a // c]) and mats and s + 1 < bl:
                    issue(a, s + 1)
            for qq in range(q):
                if pi >= len(passes[qq]):
                    continue
                rb = passes[qq][pi]
                hs = list(range(rb, nrhs, q))[:RHS_CHUNK]
                tl = range(cnt[k])
                for a in range(qq * c, qq * c + c):
                    own = own_rows(c, a % c, nb)
                    if not len(own):
                        continue
                    loc = np.arange(len(own))
                    inv = (stage[a].read(a, np.ix_([s % 2], [0], loc,
                                                   range(nb)))[0, 0]
                           if mats else invs[k, slot][own])
                    for h, rr in enumerate(hs):
                        src = x.read(a, np.ix_([rr], [k], range(nb)))[0, 0]
                        xs = inv @ src
                        pub[a].write(a, np.ix_([h], loc), xs)
                        y.write(a, np.ix_([rr], [k], own), xs)
                g.cluster_barrier(qq)    # x_k's rows are published
                for a in range(qq * c, qq * c + c):
                    for h in range(len(hs)):
                        xk[a].write(a, np.ix_([h], range(nb)),
                                    gather(a, pub[qq * c:qq * c + c], c, nb,
                                           h))
                    g.cta_barrier(a)   # the wait for the old values
                for a in range(qq * c, qq * c + c):
                    own = own_rows(c, a % c, nb)
                    if not len(own):
                        continue
                    loc = np.arange(len(own))
                    for m, t in enumerate(tl):
                        tile = (stage[a].read(a, np.ix_([s % 2], [1 + m], loc,
                                                        range(nb)))[0, 0]
                                if m < ntile else tiles[ids[k, t]][own])
                        for h, rr in enumerate(hs):
                            xv = xk[a].read(a, np.ix_([h], range(nb)))[0]
                            at = np.ix_([rr], [rows[k, t]], own)
                            old = (olds[a].read(a, np.ix_([m], [h], loc))[0, 0]
                                   if m < OLD_TILES else x.read(a, at)[0, 0])
                            x.write(a, at, old - tile @ xv)
    # the end: every CTA's last barrier (no CTA leaves early)
    for qq in range(q):
        g.cluster_barrier(qq)


def k5_sweep(x, y, tiles, invs, slot, steps, bl, nb, c, q):
    """One sweep of group_cluster_kernel on q clusters of c CTAs: item it
    of a step (its RHS it // n) on cluster it mod q, each CTA reading its
    rows of each entry from global memory."""
    step, item, ent = steps["step"], steps["item"], steps["ent"]
    g, nrhs, r = x.g, x.val.shape[0], MAX_NB // c
    nsteps = len(step) - 1
    pub = [Buf(f"pub{a}", (2, r), g) for a in range(g.n)]
    v = [Buf(f"v{a}", (nb,), g) for a in range(g.n)]
    par = np.zeros(q, np.int64)
    for s in range(nsteps):
        n = step[s + 1, 0] - step[s, 0]
        for qq in range(q):
            for it in range(qq, n * nrhs, q):
                rr = it // n
                seg, inv, e0, e1 = item[step[s, 0] + it % n]
                for a in range(qq * c, qq * c + c):
                    own = own_rows(c, a % c, nb)
                    if not len(own):
                        continue
                    acc = np.zeros(len(own))
                    for tid, kseg in ent[e0:e1]:
                        acc += tiles[tid][own] @ y.read(
                            a, np.ix_([rr], [kseg], range(nb)))[0, 0]
                    at = np.ix_([rr], [seg], own)
                    val = x.read(a, at)[0, 0] - acc
                    if inv:
                        pub[a].write(a, np.ix_([par[qq]], range(len(own))),
                                     val)
                    else:
                        x.write(a, at, val)
                if not inv:
                    continue
                g.cluster_barrier(qq)    # v's rows are published
                for a in range(qq * c, qq * c + c):
                    v[a].write(a, np.arange(nb), gather(
                        a, pub[qq * c:qq * c + c], c, nb, par[qq]))
                    g.cta_barrier(a)
                for a in range(qq * c, qq * c + c):
                    own = own_rows(c, a % c, nb)
                    if len(own):
                        y.write(a, np.ix_([rr], [seg], own),
                                invs[seg, slot][own] @ v[a].read(
                                    a, np.arange(nb)))
                par[qq] ^= 1
        if s + 1 < nsteps:
            g.grid_barrier()
    for qq in range(q):
        g.cluster_barrier(qq)


@functools.lru_cache(maxsize=None)
def case(name: str, nb: int, ordering: str):
    """The schedule tables of a small matrix, and integer-valued tiles,
    inverses and right-hand sides with few nonzeros (so that x stays
    small: every sum is exact in float64)."""
    a = {"poisson3d": lambda: poisson3d(12),
         "random": lambda: random_unsymmetric(1200, 0.004, seed=5)}[name]()
    h = pt.init(a, pt.InitOptions(nb=nb, dtype="r64", ordering=ordering,
                                  device="cpu"))
    nt, bl, sch = h.blocked.num_tiles, h.schedule.block_length, h.schedule
    rng = np.random.default_rng(nb)
    tiles = np.zeros((nt + 1, nb, nb))
    for t in range(nt):   # about two nonzeros a row in {-1, 1}
        i = rng.integers(0, nb, 2 * nb)
        j = rng.integers(0, nb, 2 * nb)
        tiles[t, i, j] = rng.choice([-1.0, 1.0], 2 * nb)
    tiles *= rng.random((nt + 1, nb, nb)) < 0.5
    invs = np.zeros((bl, 2, nb, nb))
    invs[:, :, np.arange(nb), np.arange(nb)] = rng.choice([-1.0, 1.0],
                                                          (bl, 2, nb))
    k = rng.integers(0, nb, (bl, 2, nb))
    invs[np.arange(bl)[:, None, None], np.arange(2)[None, :, None],
         np.arange(nb)[None, None, :], k] += rng.integers(-1, 2, (bl, 2, nb))
    x = rng.integers(-3, 4, (RHS_CHUNK, bl + 1, nb)).astype(np.float64)
    x[:, bl] = 0
    tab = (sch.group_solve_tables(nt) if ordering == "nd"
           else sch.mega_solve_tables(nt))
    return tab, tiles, invs, x, bl


# K3 on its cluster sizes for the rcm schedules, K5 on its for nd
CASES = ([(c, m, nb, "rcm") for c in SOLVE_CLUSTERS
          for m, nb in (("poisson3d", 256), ("poisson3d", 200),
                        ("random", 200))]
         + [(c, "poisson3d", nb, "nd") for c in GROUP_CLUSTERS
            for nb in (256, 200)])


@pytest.mark.parametrize("nrhs", [1, 4])
@pytest.mark.parametrize("c,name,nb,ordering", CASES)
def test_cluster_sweeps_emulated(c, name, nb, ordering, nrhs):
    tab, tiles, invs, x0, bl = case(name, nb, ordering)
    x0 = x0[:nrhs]
    tables = kt.KernelTables.build(tab, "cpu")
    t = torch.as_tensor
    if ordering == "nd":
        ref = kt.mega_solve_groups(t(x0), t(tiles), t(invs), tables, nb=nb,
                                   bl=bl).numpy()
        # q clusters by what the card holds (one, or several taking
        # items in turn)
        layouts = [dict(q=1), dict(q=3)]
    else:
        ref = kt.mega_solve(t(x0), t(tiles), t(invs), tables, nb=nb,
                            bl=bl).numpy()
        w = tab["lid_tab"].shape[1]
        # one cluster, or one a RHS, with f32's stage and f64's (none at
        # C = 4)
        layouts = [dict(q=q, mats=m) for q in sorted({1, nrhs})
                   for m in sorted({stage_mats(c, 4), stage_mats(c, 8)})]
        tab = {sw: dict(ids=tab[f"{p}id_tab"].reshape(bl, w),
                        rows=tab[f"{p}row_tab"].reshape(bl, w),
                        cnt=tab[f"n{p}_tab"])
               for sw, p in (("l", "l"), ("uc", "uc"))}
    assert np.abs(ref).max() < 2.0 ** 40   # every sum exact in float64
    for lay in layouts:
        g = Grid(lay["q"], c)
        xs = Buf("x", x0.shape, g, init=x0)
        ys = Buf("y", x0.shape, g)
        if ordering == "nd":
            for sw, slot, src, dst in (("l", 0, xs, ys), ("uc", 1, ys, xs)):
                steps = group_solve_steps(tables.host, sw, bl)
                k5_sweep(src, dst, tiles, invs, slot, steps, bl, nb, c,
                         lay["q"])
                g.grid_barrier()   # the next launch
        else:
            for sw, slot, src, dst, desc in (("l", 0, xs, ys, False),
                                             ("uc", 1, ys, xs, True)):
                k3_sweep(src, dst, tiles, invs, slot, tab[sw], bl, nb, desc,
                         c, lay["q"], lay["mats"])
                g.grid_barrier()   # the next launch
        got = xs.val
        assert np.array_equal(got, ref), lay
