"""A numpy emulation of P5's CUDA kernel (``csrc/probes.cuh``
overlap_kernel), which runs only on the card: acc's column strips over
CTAs, each CTA holding all of ``a`` and its own strip of acc (twice, by
step parity) in shared memory, the scan on CTA 0 beside strip 0's
products, and the final sum by the CTA that arrives last.

The emulation keeps each CTA's shared memory as named buffers filled
with NaN, performs the kernel's loads, warp products and stores in its
order, and logs, between two barriers, every write and every read, and
every read of global memory.  The checks:

  * a product CTA reads only ``a`` and its own columns of ``b`` from
    global memory, and nothing of another CTA;
  * no warp reads cells that another warp writes between the same two
    barriers, and nothing reads a cell that was never staged (a NaN
    would reach the result);
  * on integer-valued inputs, whose sums are exact in float64 in any
    order, acc is a^s b bit for bit;
  * the final sum, in any order of arrival, gives the plain version's
    bits and leaves every counter at 0;
  * the grid (``overlap_grid``, the launch's geometry) maps copies to
    CTAs and roles: one scan CTA a copy, each column in one strip.
"""

import numpy as np
import pytest
import torch

from pangulu_tpu_torch.ops import kernels_cuda as kc
from pangulu_tpu_torch.ops import kernels_torch as kt

N = kc.PROBE_MAX_NB
# csrc/probes.cuh kStripCols, kStripWarps, kScanWarps: acc's columns a
# product CTA, its product warps, the scan's warps
COLS, WARPS, SCAN_WARPS = 8, 4, 8
TM = N // WARPS                 # rows of the strip a product warp forms
SMEM_MAX = 232_448              # bytes of shared memory a CTA may have


def overlap_grid(mode: str, n: int, copies: int) -> tuple:
    """(grid x, grid y, threads a CTA) of P5's launch (csrc/probes.cuh
    launch_overlap and probe_threads): mode scan one CTA of the scan's
    warps a copy; the others a CTA a strip of COLS columns of acc,
    ceil(n / COLS) a copy, of the product warps and, in modes both and
    split, the scan's warps, which run on CTA 0 only."""
    if mode == "scan":
        return 1, copies, 32 * SCAN_WARPS
    strips = -(-n // COLS)
    return strips, copies, 32 * (WARPS + (SCAN_WARPS if mode != "dots"
                                          else 0))


def strip_layout(itemsize: int) -> dict:
    """csrc/probes.cuh StripLayout<P>: a's row stride (k along a row,
    the atoms' PAD_A of 4), the strip's (12 doubles or 8 floats), and
    the bytes of a and the strip twice."""
    lda, ldb = N + 4, COLS + (4 if itemsize == 8 else 0)
    return dict(lda=lda, ldb=ldb,
                smem=(N * lda + 2 * N * ldb) * itemsize)


class StripCTA:
    """The shared memory of one product CTA (strip j) and its access
    log between barriers."""

    def __init__(self, j: int):
        self.j, self.c0 = j, j * COLS
        self.As = np.full((N, N), np.nan)
        self.acc = [np.full((N, COLS), np.nan) for _ in range(2)]
        self.reads, self.writes = [], []   # (warp, buffer, rows)
        self.global_reads = []             # (array, columns read)

    def barrier(self):
        for (w, buf, rows) in self.reads:
            for (v, wbuf, wrows) in self.writes:
                assert not (w != v and buf == wbuf and rows & wrows), (
                    "race", w, v, buf)
        self.reads, self.writes = [], []

    def load(self, a: np.ndarray, b: np.ndarray, n: int):
        """a, and b's columns c0 ... c0 + 7, zero outside n x n."""
        self.As[:] = 0
        self.As[:n, :n] = a
        cols = range(self.c0, min(self.c0 + COLS, n))
        self.global_reads += [("a", frozenset(range(n))),
                              ("b", frozenset(cols))]
        self.acc[0][:] = 0
        self.acc[0][:n, :len(cols)] = b[:, list(cols)]
        self.writes.append((-1, 0, frozenset(range(N))))

    def step(self, s: int):
        """One product: warp w forms rows [w TM, (w + 1) TM) of acc[(s +
        1) % 2] = a · acc[s % 2]."""
        cur, nxt = s % 2, (s + 1) % 2
        for w in range(WARPS):
            rows = range(w * TM, (w + 1) * TM)
            self.reads.append((w, cur, frozenset(range(N))))
            self.writes.append((w, nxt, frozenset(rows)))
            self.acc[nxt][rows.start:rows.stop] = (
                self.As[rows.start:rows.stop] @ self.acc[cur])


def products_copy(a: np.ndarray, b: np.ndarray, steps: int) -> list:
    """Every product CTA of one copy through ``steps`` steps; returns
    the CTAs (their strips, after the last barrier, in acc[steps % 2])."""
    n = a.shape[0]
    strips = overlap_grid("dots", n, 1)[0]
    ctas = [StripCTA(j) for j in range(strips)]
    for cta in ctas:
        cta.load(a, b, n)
        for s in range(steps):
            cta.barrier()
            cta.step(s)
        cta.barrier()
    return ctas


def integer_inputs(n: int, seed: int) -> tuple:
    """a with ~6 entries of +-1 a row, b of small integers: a^s b stays
    below 2^24 for the steps used here, so every sum is exact in float32
    and float64 in any order."""
    rng = np.random.default_rng(seed)
    a = rng.choice([-1.0, 0.0, 1.0], size=(n, n), p=[0.025, 0.95, 0.025])
    b = rng.integers(-3, 4, size=(n, n)).astype(np.float64)
    return a, b


@pytest.mark.parametrize("n", [48, 100, 128])
@pytest.mark.parametrize("steps", [0, 1, 5])
def test_strips_reproduce_the_chain_of_products(n, steps):
    """Each CTA reads a and its own columns of b only, the warps never
    race, every cell of the strip is staged, and the strips together are
    a^s b bit for bit."""
    a, b = integer_inputs(n, seed=n + steps)
    ctas = products_copy(a, b, steps)
    want = b.astype(np.int64)
    for _ in range(steps):
        want = a.astype(np.int64) @ want
    got = np.concatenate([c.acc[steps % 2] for c in ctas], axis=1)
    assert not np.isnan(got).any()
    assert np.array_equal(got[:n, :n], want.astype(np.float64))
    assert not got[n:].any() and not got[:, n:].any()  # padding stays 0
    for cta in ctas:
        assert cta.global_reads == [
            ("a", frozenset(range(n))),
            ("b", frozenset(range(cta.c0, min(cta.c0 + COLS, n))))]


def final_sum(f, parts, strips, arrivals, done):
    """The kernel's end for the copies of ``arrivals`` (a list of (copy,
    CTA) in order of arrival): CTA 0 of a copy has written f to out and
    every CTA its strip of part before it arrives; the CTA whose arrival
    finds strips - 1 earlier ones adds out = f + part and resets the
    counter."""
    out = {y: np.full_like(f, np.nan) for y in parts}
    written = {y: np.zeros(f.shape, bool) for y in parts}
    summed = []
    for y, x in arrivals:
        if x == 0:
            out[y][:] = f
        cols = slice(x * COLS, (x + 1) * COLS)
        written[y][:, cols] = True
        old = done[y]
        done[y] += 1
        if old == strips - 1:
            assert written[y].all()  # every part is in before the sum
            out[y] = out[y] + parts[y]
            done[y] = 0
            summed.append((y, x))
    return out, summed


@pytest.mark.parametrize("n", [48, 100, 128])
def test_final_sum_in_every_order_of_arrival(n):
    """out = f + float(acc), one float32 addition an element, as the
    plain version sums; whatever the order in which the CTAs of 3
    copies arrive (interleaved), each copy is summed once, by its last
    CTA, to the plain version's bits, and the counters end at 0."""
    steps = 4
    a, b = integer_inputs(n, seed=n)
    at, bt = (torch.from_numpy(x).float() for x in (a, b))
    want = kt.scan_overlap(at, bt, "both", steps).numpy()
    f = at.clone()
    for s in range(steps):
        f = kt.probe_scan_step(f, s % n)
    acc = np.concatenate([c.acc[steps % 2] for c in products_copy(
        a, b, steps)], axis=1)[:n, :n].astype(np.float32)
    strips = overlap_grid("both", n, 3)[0]
    ctas = [(y, x) for y in range(3) for x in range(strips)]
    rng = np.random.default_rng(n)
    orders = [ctas, ctas[::-1]] + [[ctas[i] for i in rng.permutation(
        len(ctas))] for _ in range(6)]
    for arrivals in orders:
        done = [0, 0, 0]
        out, summed = final_sum(f.numpy(), {y: acc for y in range(3)},
                                strips, arrivals, done)
        assert done == [0, 0, 0]
        assert sorted(y for y, _ in summed) == [0, 1, 2]
        for y in range(3):
            assert np.array_equal(out[y].view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("copies", [1, 3, 10])
@pytest.mark.parametrize("mode", kt.OVERLAP_MODES)
def test_grid_maps_copies_to_ctas_and_roles(mode, copies):
    """Each CTA (x, y) of the launch works on copy y; a copy has one scan
    CTA (x = 0) unless mode dots, and, unless mode scan, a CTA a strip
    of 8 columns covering the columns once, which all arrive on the
    copy's counter (modes both and split) before its sum."""
    for n in (8, 48, 100, 128):
        gx, gy, threads = overlap_grid(mode, n, copies)
        assert gy == copies
        strips = -(-n // COLS)
        scan, dot = mode != "dots", mode != "scan"
        assert gx == (strips if dot else 1)
        assert threads == 32 * ((WARPS if dot else 0) + (8 if scan else 0))
        for y in range(copies):
            roles = [(x == 0 and scan, x if dot else None)
                     for x in range(gx)]
            assert sum(s for s, _ in roles) == (1 if scan else 0)
            cols = [c for _, j in roles if j is not None
                    for c in range(j * COLS, min(j * COLS + COLS, n))]
            assert cols == (list(range(n)) if dot else [])


@pytest.mark.parametrize("chunks", [4, 8, 16])
def test_register_fragments_cover_their_chunks(chunks):
    """strip_regs_load: the A fragments a warp keeps in registers, element
    i of atom m at row m0 + 16 m + g + 8 (i % 2) and column 8 q + t + 4
    (i / 2) for lane 4 g + t, are the ones Mt::load_a reads (rows g and g
    + 8, columns t and t + 4), and cover the warp's rows of k's first
    `chunks` chunks once."""
    for w in range(WARPS):
        m0 = w * TM
        cells = [(m0 + 16 * m + lane // 4 + 8 * (i % 2),
                  8 * q + lane % 4 + 4 * (i // 2))
                 for q in range(chunks) for m in range(TM // 16)
                 for lane in range(32) for i in range(4)]
        assert len(set(cells)) == len(cells)
        assert set(cells) == {(r, c) for r in range(m0, m0 + TM)
                              for c in range(8 * chunks)}


@pytest.mark.parametrize("itemsize", [4, 8])
def test_strip_layout_fits_a_cta(itemsize):
    """a in P with padded rows, the strip twice and the scan's two row
    buffers fit one CTA's shared memory (the issue's 135,168 + 24,576
    bytes in float64), and the strip's rows keep the B fragment loads
    (k = t, column g; lane 4 g + t) on distinct banks: each half-warp's
    in float64 (two banks a double), the whole warp's in float32."""
    lay = strip_layout(itemsize)
    assert lay["smem"] + 2 * N * 4 <= SMEM_MAX
    if itemsize == 8:
        assert lay["smem"] == 135_168 + 24_576
    words = itemsize // 4
    lanes = range(16) if itemsize == 8 else range(32)
    banks = [((lane % 4) * lay["ldb"] + lane // 4) * words % 32
             for lane in lanes]
    assert len(set(banks)) == len(banks)


@pytest.mark.parametrize("mode", ["both", "split"])
@pytest.mark.parametrize("n,steps", [(48, 37), (100, 300), (128, 0),
                                     (128, 256)])
def test_cta0_warps_take_the_same_barriers(mode, n, steps):
    """On CTA 0 the scan's warps (scan_loop's nest: passes of n pivots
    until `steps` steps) and strip 0's product warps take the same
    number of CTA barriers: a step's one (split) or two (both), one
    after the last step, one after their parts are out."""
    per = 2 if mode == "both" else 1
    scan = 0
    for s0 in range(0, steps, n):
        for k in range(n):
            if s0 + k >= steps:
                break
            scan += per
    scan += 2
    products = steps * per + 1 + 1
    assert scan == products == steps * per + 2

