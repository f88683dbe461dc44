"""A numpy emulation of the thread block clusters of P3's and P4's CUDA
kernels (``csrc/probes.cuh`` newton_loop_kernel, scan_multi_kernel),
which run only on the card: which CTA owns which block of a 128 x 128
matrix (``cluster_blocks`` below), which peers' blocks each
product copies (P4 from their shared memory, P3 through the workspace
in global memory), which k each warp sums (a triangular member skips
the blocks above the diagonal), which buffer each step writes, and
where the cluster barriers fall.

The emulation keeps each CTA's shared memory and the global workspace
(P3's X and Y) as named buffers filled with NaN, performs the kernel's
copies and block products in its order, and logs, between two cluster
barriers, every write and every read.  The checks:

  * no CTA reads cells that another CTA writes between the same two
    barriers (the kernel takes no other ordering between CTAs);
  * nothing reads a cell that was never staged (a NaN would reach the
    result);
  * the result is the plain version's bit for bit, on integer-valued
    members whose sums are exact in float64 in any order
    (``kernels_torch.newton_loop``, and a^s b for P4's products).

P4's final sum: the CTA that finishes a copy last (a completion counter)
sums the parts in the plain twin's order, whatever the order of
arrival, and leaves the counter at 0.
"""

import numpy as np
import pytest
import torch

from pangulu_tpu_torch.ops import kernels_cuda as kc
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.testing import probe_inputs

N = kc.PROBE_MAX_NB
WM, WN = 2, 4  # csrc/probes.cuh ClusterBlocks: 8 warps over a block


def cluster_blocks(c: int) -> tuple[int, int, int, int]:
    """(PR, PC, BR, BC) of csrc/probes.cuh ClusterBlocks<C>: a 128 x 128
    matrix in PR x PC blocks of BR x BC over a cluster of c CTAs, CTA
    rank r owning block (r // PC, r % PC)."""
    assert c in kc.CLUSTER_SIZES
    return 4, c // 4, N // 4, N // (c // 4)


def warp_tiles(c: int):
    """(row, column, rows, columns) of each warp's tile in a block, warp
    w = 0..7 in order (ClusterBlocks warp_row, warp_col)."""
    _, _, br, bc = cluster_blocks(c)
    tm, tn = br // WM, bc // WN
    return [(w // WN * tm, w % WN * tn, tm, tn) for w in range(WM * WN)]


class Cluster:
    """The memory of a cluster's kernel: each CTA's shared memory (slots
    0 to C - 1) and the global workspace (slot C), and a log of the
    accesses between cluster barriers."""

    def __init__(self, c: int):
        self.c = c
        self.pr, self.pc, self.br, self.bc = cluster_blocks(c)
        self.mem = [{} for _ in range(c + 1)]
        self.writes, self.reads = [], []
        self.peers = [set() for _ in range(c)]  # CTAs whose blocks each read
        self.barriers = 0

    def owner(self, rank: int):
        """(i, j, first row, first column) of the block rank owns."""
        i, j = divmod(rank, self.pc)
        return i, j, i * self.br, j * self.bc

    def write(self, cta, slot, buf, r0, c0, vals):
        r1, c1 = r0 + vals.shape[0], c0 + vals.shape[1]
        self.mem[slot][buf][r0:r1, c0:c1] = vals
        self.writes.append((cta, slot, buf, r0, r1, c0, c1))

    def read(self, cta, slot, buf, r0, r1, c0, c1):
        self.reads.append((cta, slot, buf, r0, r1, c0, c1))
        if slot == self.c:  # the workspace: the blocks' owners
            self.peers[cta] |= {
                ib * self.pc + jb
                for ib in range(r0 // self.br, -(-r1 // self.br))
                for jb in range(c0 // self.bc, -(-c1 // self.bc))} - {cta}
        elif slot != cta:
            self.peers[cta].add(slot)
        return self.mem[slot][buf][r0:r1, c0:c1].copy()

    def barrier(self):
        """No CTA read, between the last barrier and this one, cells that
        another CTA wrote in the same interval."""
        for (rd, slot, b, r0, r1, c0, c1) in self.reads:
            for (wr, ws, wb, s0, s1, d0, d1) in self.writes:
                assert not (wr != rd and ws == slot and wb == b and r0 < s1
                            and s0 < r1 and c0 < d1 and d0 < c1), (
                    "race", (rd, slot, b, r0, r1, c0, c1),
                    (wr, s0, s1, d0, d1))
        self.writes, self.reads = [], []
        self.barriers += 1

    def product(self, a, b, ranges, tiles=None):
        """The CTA's block of a (BR x N) times b (N x BC), each tile
        (warp_tiles, or the given ones) summing k in its range (kb, ke);
        nothing outside them.  The tiles cover the block once."""
        acc = np.full((self.br, self.bc), np.nan)
        for (m0, n0, tm, tn, *_), (kb, ke) in zip(
                tiles or warp_tiles(self.c), ranges):
            acc[m0:m0 + tm, n0:n0 + tn] = 0.0
            if kb < ke:
                acc[m0:m0 + tm, n0:n0 + tn] = (a[m0:m0 + tm, kb:ke]
                                               @ b[kb:ke, n0:n0 + tn])
        return acc


def stage(cl, cta, buf, r0, r1, c0, c1, tri):
    """The kernel's stage_from_l2: rows [r0, r1) x columns [c0, c1) of a
    workspace matrix, in pieces of 2 columns; with tri, a piece above
    the diagonal is zero, not read."""
    out = np.zeros((r1 - r0, c1 - c0))
    for r in range(r0, r1):
        for c in range(c0, c1, 2):
            if not tri or c <= r:
                out[r - r0, c - c0:c - c0 + 2] = cl.read(
                    cta, cl.c, buf, r, r + 1, c, c + 2)[0]
    return out


def newton_tiles(c: int):
    """(local row, column, rows, columns, warp) of each tile of a P3
    block (NewtonTiles.init): 16-row groups (local rows 16-31 are group
    7 - i), 4 NT column tiles a group, NT tiles a warp."""
    _, _, _, bc = cluster_blocks(c)
    nt = 2 if bc >= 64 else 1
    tn = bc // (4 * nt)
    out = []
    for w in range(8):
        p = w % 4
        if nt == 2:
            m0 = 16 if w < 4 else 0
            ts = (p, 7 - p) if w < 4 else (3 - p, 4 + p)
        else:
            m0 = (w + w // 4) % 2 * 16
            ts = ((p // 2) if w < 4 else 3 - p // 2,)
        out += [(m0, t * tn, 16, tn, w) for t in ts]
    return out


def newton_rows(c: int, rank: int) -> np.ndarray:
    """The 32 rows of P3's CTA rank: the 16-row groups i and 7 - i of its
    row block i (newton_loop_kernel's grow)."""
    i = rank // (c // 4)
    return np.r_[16 * i:16 * i + 16, 16 * (7 - i):16 * (7 - i) + 16]


def newton_cluster(lm: np.ndarray, steps: int, c: int):
    """newton_loop_kernel on one member (nb x nb, float64): each CTA's
    L rows (L), X rows (Xa) and column strip (S) in shared memory, X
    (X0, X1 by step parity) and Y in the workspace; returns X, the
    cluster, each CTA's multiply-adds a product (its warps' tiles times
    their k), and the flag."""
    nb = lm.shape[0]
    cl = Cluster(c)
    br, bc = cl.br, cl.bc
    for r in range(c):
        cl.mem[r] = dict(L=np.full((br, N), np.nan),
                         Xa=np.full((br, N), np.nan),
                         S=np.full((N, bc), np.nan), F=np.zeros((1, 1)))
    cl.mem[c] = {k: np.full((N, N), np.nan) for k in ("X0", "X1", "Y")}
    lp = np.eye(N)
    lp[:nb, :nb] = lm
    upper_mask = np.triu(np.ones((N, N), bool), 1)
    geo = []
    for r in range(c):
        _, _, _, c0 = cl.owner(r)
        rows = newton_rows(c, r)
        cl.write(r, r, "L", 0, 0, lp[rows])
        cl.write(r, r, "F", 0, 0, np.array(
            [[float((lp[rows][upper_mask[rows]] != 0).any())]]))
        x0 = (2 * np.eye(N) - lp)[rows, c0:c0 + bc]
        for h in (0, 16):
            cl.write(r, c, "X0", rows[h], c0, x0[h:h + 16])
        geo.append((rows, c0))
    cl.barrier()
    general = [any(cl.read(r, q, "F", 0, 1, 0, 1)[0, 0] for q in range(c))
               for r in range(c)]
    assert len(set(general)) == 1
    general = general[0]
    tri = not general
    cl.peers = [set() for _ in range(c)]  # from here on, the blocks' reads
    work = []
    tiles = newton_tiles(c)
    for r, (rows, c0) in enumerate(geo):
        kb, ke = (0, N) if general else (c0, rows.max() + 1)
        ranges = [(0, N) if general else (c0 + n0, rows[m0] + tm)
                  for m0, n0, tm, _, _ in tiles]
        geo[r] = (rows, c0, kb, ke, ranges)
        # multiply-adds of each SM sub-partition (warp w on w % 4)
        sp = [0] * 4
        for (_, _, tm, tn, w), (b, e) in zip(tiles, ranges):
            sp[w % 4] += tm * tn * max(e - b, 0)
        work.append(sp)
    acc = [None] * c

    def put(r, buf, rows, c0, vals):
        for h in (0, 16):
            cl.write(r, c, buf, rows[h], c0, vals[h:h + 16])

    for s in range(steps):
        x, nxt = f"X{s & 1}", f"X{(s + 1) & 1}"
        # X's column strip j and X's rows; Y = 2I - L·X to the workspace
        for r, (rows, c0, kb, ke, ranges) in enumerate(geo):
            if kb < ke:
                cl.write(r, r, "S", kb, 0,
                         stage(cl, r, x, kb, ke, c0, c0 + bc, tri))
                for h in (0, 16):
                    cl.write(r, r, "Xa", h, kb, stage(
                        cl, r, x, rows[h], rows[h] + 16, kb, ke, tri))
            y = cl.product(cl.mem[r]["L"], cl.mem[r]["S"], ranges, tiles)
            diag = rows[:, None] == np.arange(c0, c0 + bc)[None, :]
            put(r, "Y", rows, c0, np.where(diag, 2.0, 0.0) - y)
        cl.barrier()
        # Y's column strip j; X' = X·Y to the workspace
        for r, (rows, c0, kb, ke, ranges) in enumerate(geo):
            if kb < ke:
                cl.write(r, r, "S", kb, 0,
                         stage(cl, r, "Y", kb, ke, c0, c0 + bc, tri))
            acc[r] = cl.product(cl.mem[r]["Xa"], cl.mem[r]["S"], ranges,
                                tiles)
            put(r, nxt, rows, c0, acc[r])
        cl.barrier()
    if steps == 0:
        cl.barrier()
    out = np.empty((N, N))
    for r, (rows, c0, *_) in enumerate(geo):
        out[rows, c0:c0 + bc] = (acc[r] if steps else
                                 (2 * np.eye(N) - lp)[rows, c0:c0 + bc])
    return out[:nb, :nb], cl, work, general


def integer_members(nb: int, seed: int, general: bool) -> np.ndarray:
    """A unit lower triangle (general: a full matrix with a unit
    diagonal) with sparse entries in {-1, 0, 1}: its Newton steps stay
    integers below 2^53, so any order of sums is exact."""
    rng = np.random.default_rng(seed)
    z = rng.choice([-1.0, 0.0, 0.0, 0.0, 1.0], size=(nb, nb))
    return np.eye(nb) + (np.where(np.eye(nb, dtype=bool), 0, z) if general
                         else np.tril(z, -1))


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("steps", [0, 1, 2])
@pytest.mark.parametrize("nb", [100, 128])
@pytest.mark.parametrize("c", [4, 8, 16])
def test_newton_cluster_reproduces_the_plain_loop(c, nb, steps, general):
    """P3's partition, copies and triangle skip give the plain version's
    X exactly, with no race between CTAs and no unstaged cell read."""
    lm = integer_members(nb, seed=nb + steps, general=general)
    got, cl, _, flagged = newton_cluster(lm, steps, c)
    assert flagged == general
    want = kt.newton_loop(torch.from_numpy(lm), steps).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert cl.barriers == 1 + 2 * steps + (steps == 0)


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("c", [4, 8, 16])
def test_newton_cluster_reads_its_rows_and_column(c, general):
    """After the flags (read from every CTA at the first barrier), CTA
    (i, j) loads from the workspace only X's and Y's column strip j and
    X's rows of its own row block; a general member all of them."""
    lm = integer_members(128, seed=1, general=general)
    cl = newton_cluster(lm, 2, c)[1]
    for r in range(c):
        i, j, *_ = cl.owner(r)
        # the workspace's 32 x BC blocks (by the Cluster's contiguous
        # rows) that hold column strip j or the rows of row block i
        rows = newton_rows(c, r)
        near = {q for q in range(c) if q % cl.pc == j
                or q // cl.pc in {rows[0] // 32, rows[-1] // 32}}
        assert cl.peers[r] <= near - {r}


def test_newton_cluster_balances_the_triangle():
    """A triangular member's products sum only the k below each tile's
    last row: less work than a general member's.  At C = 4, with each
    row block the 16-row groups i and 7 - i and each warp a pair of
    tiles that cost alike (NewtonTiles), the heaviest SM sub-partition
    sums 40,960 multiply-adds a product, 1.33x the cluster's mean,
    against the 65,536 of the one 16 x 32 tile that sums all 128 k with
    contiguous rows and a tile a warp; at C = 8 and 16 the column blocks
    on the left still sum more (1.9x and 2.3x the mean)."""
    tri = integer_members(128, seed=3, general=False)
    gen = integer_members(128, seed=3, general=True)
    for c in kc.CLUSTER_SIZES:
        w_tri = np.array(newton_cluster(tri, 1, c)[2])
        w_gen = np.array(newton_cluster(gen, 1, c)[2])
        assert (w_gen == 32 * 128 * 128 // (c // 4) // 4).all()
        assert w_tri.sum() < 0.6 * w_gen.sum()
        if c == 4:
            assert w_tri.max() == 40960
            assert w_tri.max() <= 1.4 * w_tri.mean()


def scan_products_cluster(a: np.ndarray, b: np.ndarray, steps: int, c: int):
    """scan_multi_kernel's products on one cluster: acc <- a · acc from
    acc = b (n x n, float64), acc's own block in buffers B0/B1 by step
    parity, the column strip copied from the owners' shared memory;
    returns acc and the cluster."""
    n = a.shape[0]
    cl = Cluster(c)
    br, bc, pc = cl.br, cl.bc, cl.pc
    for r in range(c):
        cl.mem[r] = dict(A=np.full((br, N), np.nan),
                         S=np.full((N, bc), np.nan),
                         B0=np.full((br, bc), np.nan),
                         B1=np.full((br, bc), np.nan))
    ap, bp = np.zeros((N, N)), np.zeros((N, N))
    ap[:n, :n], bp[:n, :n] = a, b
    for r in range(c):
        _, _, r0, c0 = cl.owner(r)
        cl.write(r, r, "A", 0, 0, ap[r0:r0 + br])
        cl.write(r, r, "B0", 0, 0, bp[r0:r0 + br, c0:c0 + bc])
    cl.barrier()
    full = [(0, N)] * (WM * WN)
    for s in range(steps):
        cur, nxt = f"B{s & 1}", f"B{(s + 1) & 1}"
        for r in range(c):
            _, j, _, _ = cl.owner(r)
            for ib in range(cl.pr):
                blk = cl.read(r, ib * pc + j, cur, 0, br, 0, bc)
                cl.write(r, r, "S", ib * br, 0, blk)
            cl.write(r, r, nxt, 0, 0,
                     cl.product(cl.mem[r]["A"], cl.mem[r]["S"], full))
        cl.barrier()
    out = np.empty((N, N))
    for r in range(c):
        _, _, r0, c0 = cl.owner(r)
        out[r0:r0 + br, c0:c0 + bc] = cl.mem[r][f"B{steps & 1}"]
    return out[:n, :n], cl


@pytest.mark.parametrize("n", [40, 128])
@pytest.mark.parametrize("c", [4, 8, 16])
def test_scan_products_cluster_reproduces_the_chain(c, n):
    """P4's chain of products over the cluster is a^s b exactly
    (integer-valued a and b), with one cluster barrier a step, no race,
    and each CTA reading only its column of the cluster grid."""
    rng = np.random.default_rng(n + c)
    a = np.eye(n) + rng.choice([-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
                               size=(n, n))
    b = rng.integers(-2, 3, size=(n, n)).astype(np.float64)
    steps = 3
    got, cl = scan_products_cluster(a, b, steps, c)
    np.testing.assert_array_equal(got, np.linalg.matrix_power(a, steps) @ b)
    assert cl.barriers == 1 + steps
    for r in range(c):
        j = r % cl.pc
        assert cl.peers[r] == {q for q in range(c) if q % cl.pc == j} - {r}


def final_sum(parts, q: int, with_dot: bool, b, arrivals):
    """The kernel's end: each CTA of a copy (q chains, then, with the
    products, the cluster's CTAs) adds one to the counter; the one that
    finds q + C - 1 sums the parts and resets it."""
    done, out = 0, None
    for _ in arrivals:
        last = done == len(arrivals) - 1
        done += 1
        if last:
            v = parts[0]
            for i in range(1, q):
                v = v + parts[i]
            out = v + (parts[q] if with_dot else b)
            done = 0
    assert done == 0
    return out


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("q", [1, 2, 4, 8])
def test_scan_multi_final_sum_in_twin_order(q, with_dot):
    """The last CTA's sum ((f_0 + f_1) + ...) + acc, over the parts the
    CTAs leave (each chain; acc), is the plain twin's result bit for bit,
    whichever CTA arrives last; summed in another order it is not (at q
    >= 4 on these inputs), so the order is what the test holds."""
    n, steps = 48, 60
    a, b = (torch.from_numpy(x) for x in probe_inputs(seed=q, nb=n))
    parts = []
    for i in range(q):
        f = a + float(i)
        for s in range(steps):
            f = kt.probe_scan_step(f, s % n)
        parts.append(f)
    acc = b
    for _ in range(steps):
        acc = torch.matmul(a, acc)
    parts.append(acc)
    want = kt.scan_multi(a, b, q, with_dot, steps)
    rng = np.random.default_rng(q)
    c = kc.SCAN_CLUSTER if with_dot else 0
    for _ in range(3):
        arrivals = rng.permutation(q + c)
        got = final_sum(parts, q, with_dot, b, arrivals)
        assert torch.equal(got, want)
    if q >= 4:
        other = sum_right_to_left(parts[:q]) + (parts[q] if with_dot
                                                 else b)
        assert not torch.equal(other, want)


def sum_right_to_left(chains):
    """f_0 + (f_1 + (... + f_{q-1})): the other association."""
    v = chains[-1]
    for f in reversed(chains[:-1]):
        v = f + v
    return v


def test_cluster_blocks_tile_the_matrix():
    """Every CTA owns one block, the blocks tile the 128 x 128 matrix,
    and the warp tiles tile each block."""
    for c in kc.CLUSTER_SIZES:
        pr, pc, br, bc = cluster_blocks(c)
        assert pr * pc == c and pr * br == N and pc * bc == N
        cover = np.zeros((N, N), int)
        for r in range(c):
            i, j = divmod(r, pc)
            cover[i * br:(i + 1) * br, j * bc:(j + 1) * bc] += 1
        assert (cover == 1).all()
        tiles = np.zeros((br, bc), int)
        for m0, n0, tm, tn in warp_tiles(c):
            tiles[m0:m0 + tm, n0:n0 + tn] += 1
        assert (tiles == 1).all()
        # whole MMA atoms a warp tile: 16 x 8 (3xTF32), 8 x 8 (DMMA)
        assert all(tm % 16 == 0 and tn % 8 == 0
                   for _, _, tm, tn in warp_tiles(c))
