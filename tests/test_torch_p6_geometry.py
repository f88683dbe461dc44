"""P6's launch geometry and index arithmetic, on the CPU.

The CUDA kernels of the compressed store's staging
(``pangulu_tpu_torch/csrc/compressed.cuh``: ``decompress_kernel``,
``compress_kernel``, ``slot_range``) run only on the card.  What decides
which block touches which dense value and which slot is index
arithmetic: the wrapper's grid (``kernels_cuda.stage_geometry``), the
block-wide two-round search for a chunk's slot range, the grid-stride
walk over chunks and spans, and the groups of ``SLOT_GROUP`` slots a
thread takes (whole groups by vector loads, a range's ragged head and
tail slot by slot).  Here a numpy emulation of exactly that arithmetic
runs on real stores (poisson2d(12-20), poisson3d(8) and poisson3d(16),
nd, at nb 5, 16, 100, 128, 256, 288 and 512; at 512 a tile holds more
than 65,536 slots, so that the search's second round takes several
passes), with values of each slot width (float32, float64, complex64,
complex128), with batches that repeat the scratch tile (cap 0),
and checks that every dense position of every tile falls in exactly one
block's chunk, every real slot is written by exactly one block (a
searched range holds exactly its rows' slots), and that the emulated
decompress and compress equal the plain versions (``kernels_torch``)
bit for bit: P6 moves values, it computes nothing.  The store's slot order, which the search relies on,
is checked by ``kernels_cuda.check_slot_order``; a store whose positions
do not ascend inside one tile is refused with ValueError.
"""

import numpy as np
import pytest
import torch

import pangulu_tpu_torch as pt
import pangulu_tpu_torch.models as tm
from pangulu_tpu_torch.compressed import CompressedTiles
from pangulu_tpu_torch.ops import kernels_cuda as kc
from pangulu_tpu_torch.ops import kernels_torch as kt
from pangulu_tpu_torch.ops.kernels_torch import Indices

# (id, generator, its argument, nb): u16 positions below nb = 256, u32
# from 256
STORES = [("poisson2d12_nb5", "poisson2d", 12, 5),
          ("poisson2d16_nb16", "poisson2d", 16, 16),
          ("poisson2d20_nb100", "poisson2d", 20, 100),
          ("poisson3d8_nb128", "poisson3d", 8, 128),
          ("poisson3d8_nb256", "poisson3d", 8, 256),
          ("poisson2d30_nb288", "poisson2d", 30, 288),
          ("poisson3d16_nb512", "poisson3d", 16, 512)]
SMS = 132       # an H100's SMs: the grid the card would get


def _store(gen, size, nb, dtype=torch.float64):
    """The store of the matrix (nd) with random slot values, so that
    every slot's value is its own."""
    h = pt.init(getattr(tm, gen)(size),
                pt.InitOptions(nb=nb, ordering="nd", device="cpu"))
    st = CompressedTiles(h.blocked, h.reordering.reordered, device="cpu")
    rng = np.random.default_rng(nb)
    st.values = torch.as_tensor(rng.standard_normal(st.values.numel()),
                                dtype=dtype)
    return st


def _batches(st):
    """A whole batch with the scratch tile at both ends and mid-batch,
    the one tile of the largest cap alone, and 8 tiles with the scratch
    tile among them."""
    nt = st.num_tiles
    tiles = np.arange(nt)[::-1]
    whole = np.r_[nt, tiles[:nt // 2], nt, tiles[nt // 2:], nt]
    eight = np.r_[np.arange(min(nt, 4)), nt, np.arange(4, min(nt, 7)), nt]
    return {"whole": whole, "largest": [int(np.argmax(st.host_cap))],
            "eight": eight}


def slot_range(pos, c, p0, p1, threads=kc.SLOT_THREADS):
    """compressed.cuh slot_range, round by round: the first slots at or
    above p0 and p1 of the c ascending positions pos."""
    step = -(-c // threads)
    s = np.arange(threads) * step
    inside = s < c
    v = np.where(inside, pos[np.minimum(s, max(c - 1, 0))] if c else 0, 0)
    k0 = int((inside & (v < p0)).sum())
    k1 = int((inside & (v < p1)).sum())
    a0, e0 = ((k0 - 1) * step + 1, min(k0 * step, c)) if k0 else (0, 0)
    a1, e1 = ((k1 - 1) * step + 1, min(k1 * step, c)) if k1 else (0, 0)
    s0, s1 = a0, a1
    for r in range(0, max(e0 - a0, e1 - a1), threads):
        i = r + np.arange(threads)
        for a, e, p, acc in ((a0, e0, p0, 0), (a1, e1, p1, 1)):
            live = a + i < e
            below = live & (pos[np.minimum(a + i, max(c - 1, 0))] < p)
            if acc == 0:
                s0 += int(below.sum())
            else:
                s1 += int(below.sum())
    return s0, s1


def thread_groups(lo, hi, vec=True, group=kc.SLOT_GROUP,
                  threads=kc.SLOT_THREADS):
    """The slots of [lo, hi) as the kernels' loop takes them: thread i
    from the aligned group (lo & ~(group-1)) + group i, every group *
    threads slots.  Returns (slots taken, thread of each, whether its
    group went by vector loads)."""
    g0 = lo & ~(group - 1)
    gs = np.arange(g0, max(hi, g0), group)
    thread = (np.arange(len(gs)) % threads)
    whole = vec & (gs >= lo) & (gs + group <= hi)
    sl = gs[:, None] + np.arange(group)
    take = (sl >= lo) & (sl < hi)
    return (sl[take], np.broadcast_to(thread[:, None], sl.shape)[take],
            np.broadcast_to(whole[:, None], sl.shape)[take])


def _host(st):
    pos = st.idx.view({torch.uint16: torch.int16,
                       torch.uint32: torch.int32}[st.idx.dtype])
    mask = 0xFFFF if st.idx.dtype == torch.uint16 else 0xFFFFFFFF
    return (st.values.numpy(), pos.numpy().astype(np.int64) & mask,
            st.host_off, np.append(st.host_cap, 0))


def emulate_decompress(st, ids, geo, vec=True, direct=kc.SLOT_DIRECT):
    """decompress_kernel on the host: block (b, j) and every chunks-th
    chunk after it, a tile of at most SLOT_DIRECT slots read whole, a
    larger one searched.  Also checks each searched range against the
    exact one and counts what each position received and how many
    times each slot was written."""
    values, idx, off, cap = _host(st)
    nb, nn = st.nb, st.nb * st.nb
    out = np.full((len(ids), nn), np.nan, dtype=values.dtype)
    pos_hits = np.zeros((len(ids), nn), dtype=np.int64)
    slot_hits = np.zeros(len(values), dtype=np.int64)
    for b, t in enumerate(ids):
        o, c = int(off[t]), int(cap[t])
        pos = idx[o:o + c]
        for j in range(geo.chunks):
            for r0 in range(j * geo.rows, nb, geo.chunks * geo.rows):
                n = (min(r0 + geo.rows, nb) - r0) * nb
                p0, p1 = r0 * nb, r0 * nb + n
                s0, s1 = 0, c             # a small tile, read whole
                if c > direct:
                    s0, s1 = slot_range(pos, c, p0, p1)
                    assert (s0, s1) == tuple(np.searchsorted(pos,
                                                             [p0, p1])), \
                        (t, r0)
                chunk = np.zeros(n, dtype=values.dtype)
                sl, _, whole = thread_groups(o + s0, o + s1, vec)
                assert not vec or len(np.unique(
                    sl[~whole] // kc.SLOT_GROUP)) <= 2
                keep = (idx[sl] >= p0) & (idx[sl] < p1)
                assert keep.all() or c <= direct  # searched: its rows'
                chunk[idx[sl[keep]] - p0] = values[sl[keep]]
                np.add.at(slot_hits, sl[keep], 1)
                out[b, p0:p1] = chunk
                pos_hits[b, p0:p1] += 1
    return out.reshape(len(ids), nb, nb), pos_hits, slot_hits


def emulate_compress(st, ids, geo, dense, vec=True):
    """compress_kernel on the host: block (b, j) and every spans-th span
    after it; returns the new values and what each slot received."""
    values, idx, off, cap = _host(st)
    values = values.copy()
    nn = st.nb * st.nb
    flat = dense.reshape(len(ids), nn)
    slot_hits = np.zeros(len(values), dtype=np.int64)
    for b, t in enumerate(ids):
        o, c = int(off[t]), int(cap[t])
        for j in range(geo.spans):
            for s0 in range(j * geo.span, c, geo.spans * geo.span):
                sl, thread, whole = thread_groups(
                    o + s0, o + min(s0 + geo.span, c), vec)
                # only a range's first and last group go slot by slot
                assert not vec or len(np.unique(
                    sl[~whole] // kc.SLOT_GROUP)) <= 2
                real = idx[sl] < nn
                values[sl[real]] = flat[b, idx[sl[real]]]
                np.add.at(slot_hits, sl, 1)
    return values, slot_hits


def _named_slots(st, ids):
    """Per slot, how many times the batch names it (the slot ranges of
    its tiles), and how many times as a real slot (position < nb^2)."""
    values, idx, off, cap = _host(st)
    named = np.zeros(len(values), dtype=np.int64)
    for t in ids:
        o, c = int(off[t]), int(cap[t])
        named[o:o + c] += 1
    return named, np.where(idx < st.nb * st.nb, named, 0)


@pytest.fixture(scope="module", params=STORES, ids=[s[0] for s in STORES])
def store(request):
    _, gen, size, nb = request.param
    return _store(gen, size, nb)


@pytest.mark.parametrize("sms", [SMS, 2])
@pytest.mark.parametrize("batch", ["whole", "largest", "eight"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_emulated_kernels_partition_and_match_plain(store, batch, dtype,
                                                    sms):
    """At the grid an H100 gets and at that of a 2-SM card (larger rows
    and spans a block), for each slot width (a complex slot's imaginary
    part is its value's negative)."""
    st = store
    values64 = st.values
    st.values = (values64.to(dtype) if not dtype.is_complex
                 else torch.complex(values64, -values64).to(dtype))
    try:
        ids = np.asarray(_batches(st)[batch], dtype=np.int64)
        ind = Indices.build(ids, "cpu")
        cap = np.append(st.host_cap, 0)
        geo = kc.stage_geometry(st.nb, st.values.element_size(), cap[ids],
                                sms)
        dense, pos_hits, slot_hits = emulate_decompress(st, ids, geo)
        assert (pos_hits == 1).all()          # every position, once
        want, real = _named_slots(st, ids)
        assert np.array_equal(slot_hits, real)  # every real slot, once
        ref = kt.decompress_tiles(st.values, st.idx, st.off, st.cap, ind,
                                  st.nb)
        assert np.array_equal(dense, ref.numpy())
        assert not dense[ids == st.num_tiles].any()   # scratch: zeros
        # compress back what decompress gave, plus a mark, into the store
        moved = ref + 1.0
        got, hits = emulate_compress(st, ids, geo, moved.numpy())
        assert np.array_equal(hits, want)
        plain = st.values.clone()
        kt.compress_tiles(plain, st.idx, st.off, st.cap, ind, moved)
        assert np.array_equal(got, plain.numpy())
        assert not np.array_equal(got, st.values.numpy()) or not want.any()
    finally:
        st.values = values64


@pytest.mark.parametrize("direct", [kc.SLOT_DIRECT, 0])
def test_emulation_right_for_any_grid(direct):
    """The kernels walk chunks and spans grid-stride, so a grid smaller
    than the batch needs (and scalar groups only, as for an unaligned
    store) still covers everything once and matches the plain versions;
    sentinel positions closing a tile's range are taken and dropped;
    also with every tile searched (direct = 0), as the large tiles of
    the card's paths are."""
    st = _store("poisson2d", 16, 16)
    nt = st.num_tiles
    t = int(np.argmax(st.host_cap))
    end = int(st.host_off[t] + st.host_cap[t])
    st.idx[end - 3:end] = 16 * 16
    kc.check_slot_order(st.idx, st.off, st.cap, 16)
    ids = np.r_[nt, np.arange(nt), nt]
    ind = Indices.build(ids, "cpu")
    named, real = _named_slots(st, ids)
    assert (named != real).sum() == 3
    for geo in (kc.StageGeometry(rows=3, chunks=2, span=4, spans=3),
                kc.StageGeometry(rows=16, chunks=1, span=kc.SLOT_GROUP,
                                 spans=1)):
        for vec in (True, False):
            dense, pos_hits, slot_hits = emulate_decompress(st, ids, geo,
                                                            vec, direct)
            assert (pos_hits == 1).all()
            assert np.array_equal(slot_hits, real)
            ref = kt.decompress_tiles(st.values, st.idx, st.off, st.cap,
                                      ind, 16)
            assert np.array_equal(dense, ref.numpy())
            got, hits = emulate_compress(st, ids, geo, 2 * dense, vec)
            assert np.array_equal(hits, named)
            plain = st.values.clone()
            kt.compress_tiles(plain, st.idx, st.off, st.cap, ind,
                              2 * ref)
            assert np.array_equal(got, plain.numpy())


# above 65,536 slots (a tile of nb > 256) the second round takes
# several passes of the block
@pytest.mark.parametrize("c", [0, 1, 5, 255, 256, 257, 1000, 16384, 65536,
                               65537, 100000, 262144])
def test_slot_range_finds_lower_bounds(c):
    """The two-round search against searchsorted on ascending positions
    of every density, for targets below, inside and above them."""
    rng = np.random.default_rng(c)
    nn = max(65536, c)
    pos = np.sort(rng.choice(nn, size=c, replace=False)).astype(np.int64)
    for p0 in (0, 1, 100, 4096, 30000, nn - 256, nn):
        for p1 in (p0, p0 + 1, p0 + 256, p0 + 7000, nn):
            if p1 < p0:
                continue
            assert slot_range(pos, c, p0, p1) == \
                tuple(np.searchsorted(pos, [p0, p1])), (p0, p1)


@pytest.mark.parametrize("elem", [4, 8, 16])
@pytest.mark.parametrize("nb", [1, 5, 16, 100, 128, 255, 256, 288, 512])
@pytest.mark.parametrize("batch", [1, 8, 256, 5000])
def test_stage_geometry_bounds(nb, batch, elem):
    """The grid the C entry takes: a decompress block's rows fit its
    shared memory and the chunks cover the tile with none empty; a
    compress span is whole thread groups and its blocks cover the
    largest cap; both grid dimensions within the card's limit; and no
    more blocks than about SLOT_DECOMPRESS_PER_SM (half that for a batch
    of tiles read whole) and SLOT_COMPRESS_PER_SM an SM unless the rows
    or spans are at their largest."""
    caps = np.full(batch, min(nb * nb, 16384))
    caps[0] = 0                                   # a scratch tile
    g = kc.stage_geometry(nb, elem, caps, SMS)
    assert 1 <= g.rows <= nb and g.rows * nb * elem <= kc.SLOT_CHUNK_BYTES \
        or g.rows == 1
    assert g.chunks * g.rows >= nb and (g.chunks - 1) * g.rows < nb
    assert g.chunks <= kc.SLOT_GRID_Y and 1 <= g.spans <= kc.SLOT_GRID_Y
    unit = kc.SLOT_GROUP * kc.SLOT_THREADS
    assert g.span % unit == 0 and g.span <= kc.SLOT_SPAN_UNITS * unit
    assert g.spans * g.span >= caps.max()
    target = kc.SLOT_DECOMPRESS_PER_SM * SMS
    if caps.max() <= kc.SLOT_DIRECT:
        target //= 2
    rmax = min(nb, max(1, kc.SLOT_CHUNK_BYTES // (nb * elem)))
    assert batch * g.chunks < target + batch or g.chunks == -(-nb // rmax)
    assert caps.sum() / g.span <= kc.SLOT_COMPRESS_PER_SM * SMS \
        or g.span == kc.SLOT_SPAN_UNITS * unit


def test_stage_geometry_spreads_small_batches():
    """A one-tile launch at the path's largest cap (16,384 slots, nb=128,
    f32) spreads over 128 decompress blocks of one row and 16 compress
    blocks; a batch of 8 small tiles (read whole) gets fewer, larger
    decompress blocks than one of 8 large tiles; the widest level's
    batch keeps rows and spans larger."""
    one = kc.stage_geometry(128, 4, [16384], SMS)
    assert (one.rows, one.chunks, one.span, one.spans) == (1, 128, 1024, 16)
    small = kc.stage_geometry(128, 4, np.full(8, 1000), SMS)
    large = kc.stage_geometry(128, 4, np.full(8, 16384), SMS)
    assert small.chunks < large.chunks
    wide = kc.stage_geometry(128, 4, np.full(256, 11559), SMS)
    assert wide.rows > 1 and 256 * wide.chunks >= SMS and wide.span > 1024


def _swap(st, tile, a, b):
    idx = st.idx.clone()
    o = int(st.host_off[tile])
    va, vb = idx[o + a].clone(), idx[o + b].clone()
    idx[o + a], idx[o + b] = vb, va
    return idx


def test_slot_order_checked_once_per_store(monkeypatch):
    """On the card's path (forced here, the launch never reached) a
    store whose positions do not ascend inside one tile is refused with
    ValueError naming the tile, before any launch; the real store
    passes, once (its check is cached on its offsets)."""
    monkeypatch.setattr(kc, "_on_cuda", lambda t: True)
    monkeypatch.setattr(kc, "library",
                        lambda: pytest.fail("reached the kernel launch"))
    st = _store("poisson2d", 12, 16)
    nt = st.num_tiles
    t = int(np.argmax(st.host_cap))
    ids = Indices.build([t], "cpu")
    idx = _swap(st, t, 3, 4)
    with pytest.raises(ValueError, match=f"tile {t}:.*ascend"):
        kc.decompress_tiles(st.values, idx, st.off, st.cap, ids, 16)
    with pytest.raises(ValueError, match=f"tile {t}:.*ascend"):
        kc.compress_tiles(st.values, idx, st.off, st.cap, ids,
                          torch.zeros(1, 16, 16, dtype=st.values.dtype))
    assert kc._check_slots(st.values, st.idx, st.off, st.cap, 16) == nt
    monkeypatch.setattr(kc, "check_slot_order",
                        lambda *a: pytest.fail("checked twice"))
    for _ in range(2):
        assert kc._check_slots(st.values, st.idx, st.off, st.cap, 16) == nt


@pytest.mark.parametrize("chunk", [3, 1 << 20])
def test_slot_order_rules(chunk, monkeypatch):
    """Ascending strictly: a repeated position or a swap is refused, in
    the last tile and in the first; sentinels (>= nb^2) may close a
    tile's range but not precede a real position.  The pairs go in
    chunks of any size (here 3 and the default)."""
    monkeypatch.setattr(kc, "_ORDER_CHUNK", chunk)
    st = _store("poisson2d", 12, 16)
    nn = 16 * 16
    kc.check_slot_order(st.idx, st.off, st.cap, 16)
    last = st.num_tiles - 1
    for t in (0, last):
        c = int(st.host_cap[t])
        o = int(st.host_off[t])
        for bad in (_swap(st, t, c - 2, c - 1), st.idx.clone()):
            if torch.equal(bad, st.idx):
                bad[o + 1] = bad[o]           # a repeated position
            with pytest.raises(ValueError, match=f"tile {t}:"):
                kc.check_slot_order(bad, st.off, st.cap, 16)
        tail = st.idx.clone()
        tail[o + c - 2:o + c] = nn            # sentinels close the range
        kc.check_slot_order(tail, st.off, st.cap, 16)
        mid = st.idx.clone()
        mid[o + c - 2] = nn                   # a sentinel, then a real one
        with pytest.raises(ValueError, match=f"tile {t}:"):
            kc.check_slot_order(mid, st.off, st.cap, 16)


def test_slot_order_u32_store():
    """The nb=256 store (uint32 positions) passes, and a swap in it is
    found."""
    st = _store("poisson2d", 20, 256)
    assert st.idx.dtype == torch.uint32
    kc.check_slot_order(st.idx, st.off, st.cap, 256)
    t = int(np.argmax(st.host_cap))
    with pytest.raises(ValueError, match=f"tile {t}:"):
        kc.check_slot_order(_swap(st, t, 10, 11), st.off, st.cap, 256)
