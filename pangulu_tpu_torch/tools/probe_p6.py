#!/usr/bin/env python3
"""P6, the compressed store's slot decompress and compress, on one
NVIDIA GPU, for the package of this checkout or of another tree:

    python3 pangulu_tpu_torch/tools/probe_p6.py [--root DIR] [--reps 7]
        [--out F] [--sweep] [--wide]
    python3 pangulu_tpu_torch/tools/probe_p6.py --variants [--out F]

On poisson3d(32), nb=128, nd, r32 with ``tile_storage="compressed"``
(the compressed phase of chip_smoke.py) it

  * times P6 per launch in each direction at three batches of the
    factorization's own level tables (:func:`p6_batches`): (a) the
    one-tile launch of the largest cap, (b) a launch of the median
    size, (c) the widest level's update tiles; device
    ms per launch over back-to-back launches between CUDA events
    (median), beside the byte bound, the plain version's time and one
    PyTorch call's (``zero_`` + ``scatter_`` for decompress, ``gather``
    for compress);
  * with --sweep, times (a)-(c) again under each launch geometry of
    SWEEP (blocks an SM, shared memory of a decompress block), for
    choosing kernels_cuda's SLOT_DECOMPRESS_PER_SM,
    SLOT_COMPRESS_PER_SM and SLOT_CHUNK_BYTES, and compress on 8- and
    16-byte words (the nb=512 batch of --wide in float64 and
    complex128, and the nb=128 complex128 batch) under each of
    WORD_SWEEP (blocks an SM, a span's largest number of a block's
    passes), to see whether those words want SLOT_COMPRESS_PER_SM and
    SLOT_SPAN_UNITS of their own;
  * traces one factorization with torch.profiler: P6's device ms and
    launches, the trace's busy and wall ms;
  * times a factorization and a solve (CUDA events, median of --reps)
    and traces one solve (P6's device ms and launches, busy, wall);
  * with --wide, times P6 at nb=512 on the widest rcm level's update
    tiles of poisson3d(32) (:func:`wide_batch`) for each slot word:
    float32, float64, complex64 and complex128 values drawn at random;
    and at nb=128 on the widest rcm level of the native complex128
    compressed store of poisson3d(16) with imaginary parts, factored
    (:func:`native_batch`, the batch of chip_smoke.py's
    wide_native_stores_phase (d)); and traces one factorization of that
    store of poisson3d(24) at nb=512 (:func:`native_trace`, the path of
    its step (f)).

With --variants it builds this tree's ``csrc/`` as shipped and with the
textual edits of VARIANTS (the designs of 8- and 16-byte words that
were not kept), one nvcc each, all at once, into
``pangulu_tpu_torch/_build/probe_p6/``, and for each times P6 both ways
on the --wide batches, each held bit for bit to the plain versions (the
shipped bits).

The package is imported from DIR (default: this checkout), so an older
tree unpacked with ``git archive`` is measured the same way; the timing
helpers are this checkout's chip_smoke.py.  It prints the card's name
and power limit, a line a measurement, then one JSON line
{"probe_p6": ...} (also written to F).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
NB = 128


def p6_batches(clu) -> dict:
    """Three P6 batches of a CompressedLU's factorization, as Indices:
    "a", the one-tile launch of the largest cap; "b", a launch of the
    median size of all the factorization's stage launches (the diagonal
    tile, the L and U panels, the update tiles of each level), of median
    slots among those; "c", the widest level's update batch."""
    cap = np.append(clu.store.host_cap, 0)
    levels = clu._level_tables()
    stages = [ids for lev in levels for ids in lev[:4] if len(ids)]
    alone = [ids for ids in stages if len(ids) == 1]
    a = max(alone, key=lambda ids: int(cap[ids.host[0]]))
    median = int(np.median([len(ids) for ids in stages]))
    same = sorted((ids for ids in stages if len(ids) == median),
                  key=lambda ids: int(cap[ids.host].sum()))
    dst = [lev[3] for lev in levels if len(lev[3])]
    return {"a": a, "b": same[len(same) // 2], "c": max(dst, key=len)}


# slot types of P6's words: 4, 8, 8 and 16 bytes
SLOT_TYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def wide_batch(nx: int, nb: int, dev):
    """(CompressedLU, its store, the widest level's update tiles) of
    poisson3d(nx) at nb, rcm, built as r64 on the card: the batch P6
    takes at nb > 256 with every slot type."""
    from pangulu_tpu_torch import InitOptions, init
    from pangulu_tpu_torch.compressed import CompressedLU
    from pangulu_tpu_torch.models import poisson3d

    h = init(poisson3d(nx), InitOptions(nb=nb, dtype="r64", ordering="rcm",
                                        device="cpu"))
    clu = CompressedLU(h.blocked, h.schedule, h.reordering.reordered,
                       device=dev)
    return clu, clu.store, p6_batches(clu)["c"]


def native_batch(nx: int, nb: int, dev):
    """(handle, its store, the widest level's update tiles) of
    poisson3d(nx) with imaginary parts at nb, cr64, rcm,
    ``complex_mode="native"``, ``tile_storage="compressed"``, factored
    on the card: P6's complex128 batch on the path of chip_smoke.py's
    wide_native_stores_phase (d)."""
    from pangulu_tpu_torch import InitOptions, gstrf, init
    from pangulu_tpu_torch.models import poisson3d
    from pangulu_tpu_torch.testing import with_imaginary_parts

    h = init(with_imaginary_parts(poisson3d(nx)), InitOptions(
        nb=nb, dtype="cr64", ordering="rcm", tile_storage="compressed",
        complex_mode="native", device=str(dev)))
    gstrf(h)
    return h, h.factor_tiles, p6_batches(h._factorizer)["c"]


def native_trace(cs, dev, nx: int = 24, nb: int = 512) -> dict:
    """One traced factorization (``cs.profile``) of :func:`native_batch`'s
    store of poisson3d(nx) at nb, the path of chip_smoke.py's
    native_store_step: wall and busy ms, idle share, P6's launches and
    device ms."""
    h, st, _ = native_batch(nx, nb, dev)
    clu = h._factorizer
    st.refill(h.reordering.reordered)
    v0 = st.values.clone()
    prof = cs.profile(lambda _: clu.factorize(),
                      setup=lambda: st.values.copy_(v0))
    out = dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
               idle_share=prof["idle_share"],
               p6=p6_in_trace(prof["kernels"]))
    p6 = out["p6"]
    print(f"  trace of one factorization, poisson3d({nx}) cr64 native "
          f"compressed, nb={nb}: wall {out['wall_ms']:.3f} ms, busy "
          f"{out['busy_ms']:.3f} ms; P6 {p6['device_ms']:.3f} device ms "
          f"(decompress {p6['decompress']['launches']} launches "
          f"{p6['decompress']['device_ms']:.3f} ms, compress "
          f"{p6['compress']['launches']} launches "
          f"{p6['compress']['device_ms']:.3f} ms)")
    return out


def random_slots(st, dtype, rng) -> None:
    """Give store st standard normal slot values of dtype (and imaginary
    parts for a complex dtype), on its device."""
    v = rng.standard_normal(st.values.numel())
    if dtype.is_complex:
        v = v + 1j * rng.standard_normal(st.values.numel())
    st.values = torch.as_tensor(v, dtype=dtype, device=st.values.device)


def slot_library_inputs(st, ids):
    """For the tiles ``ids`` of store ``st``: the flat positions (tile of
    the batch * nb^2 + in-tile position) and slot values of their real
    slots, for the library yardsticks of P6."""
    from pangulu_tpu_torch.ops import kernels_torch as kt

    pos, live = kt.slot_ranges(st.off, st.cap, ids)
    p = pos[live]
    ix = kt.slot_positions(st.idx, p)
    keep = ix < st.nb * st.nb
    row = torch.arange(len(ids), device=p.device)[:, None].expand_as(pos)
    flat = (row[live] * st.nb * st.nb + ix)[keep]
    return flat, st.values[p[keep]]


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of fn takes to enqueue, over n calls
    queued behind a device sleep (so the queue never waits on the
    card)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def measure_batch(cs, st, ids, n: int = 50) -> dict:
    """P6 per launch on the batch ``ids`` of store ``st``, both
    directions: device ms (``cs.device_ms`` over n back-to-back
    launches), the plain version's ms (``cs.cuda_ms``), one PyTorch
    call's ms, the byte bound (``cs.bound``: each slot's value and
    position and each dense value once, and the ids, offsets and caps
    read), and the host microseconds a wrapper call takes to enqueue.
    ``cs`` is chip_smoke.py's module.  The store's values are left as
    they were."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt

    nb = st.nb
    nbt = len(ids)
    esz, isz = st.values.element_size(), st.idx.element_size()
    slots = int(st.cap.host[ids.host].sum())
    args = (st.values, st.idx, st.off, st.cap, ids)
    dense = kc.decompress_tiles(*args, nb)
    flat, svals = slot_library_inputs(st, ids)
    buf = dense.new_empty(dense.numel())
    meta = 3 * 4 * nbt
    out = dict(tiles=nbt, slots=slots)
    out["decompress_ms"] = cs.device_ms(lambda: kc.decompress_tiles(
        *args, nb), n=n)
    out["decompress_plain_ms"] = cs.cuda_ms(
        lambda _: kt.decompress_tiles(*args, nb), reps=5)
    out["decompress_library_ms"] = cs.device_ms(
        lambda: buf.zero_().scatter_(0, flat, svals), n=n)
    out["decompress_bound"] = cs.bound(
        slots * (esz + isz) + nbt * nb * nb * esz + meta, 0)
    out["compress_ms"] = cs.device_ms(lambda: kc.compress_tiles(
        *args, dense), n=n)
    out["compress_plain_ms"] = cs.cuda_ms(
        lambda _: kt.compress_tiles(*args, dense), reps=5)
    out["compress_library_ms"] = cs.device_ms(
        lambda: torch.gather(dense.reshape(-1), 0, flat), n=n)
    out["compress_bound"] = cs.bound(slots * (isz + 2 * esz) + meta, 0)
    out["decompress_host_us"] = host_us(lambda: kc.decompress_tiles(
        *args, nb))
    out["compress_host_us"] = host_us(lambda: kc.compress_tiles(
        *args, dense))
    return out


def print_batch(label: str, m: dict) -> None:
    for d, lib in (("decompress", "zero_ + scatter_"),
                   ("compress", "gather")):
        print(f"  P6 {d}, {label} ({m['tiles']} tiles, {m['slots']} slots): "
              f"{m[d + '_ms']:.5f} ms (bound "
              f"{m[d + '_bound']['bound_ms']:.5f}, plain "
              f"{m[d + '_plain_ms']:.4f}, {lib} "
              f"{m[d + '_library_ms']:.5f}); host {m[d + '_host_us']:.2f} "
              "us a call")


def p6_in_trace(kernels: dict) -> dict:
    """P6's launches and device ms in a trace's kernels (names as
    chip_smoke.py's trace_once gives them)."""
    out = {d: {"launches": 0, "device_ms": 0.0}
           for d in ("decompress", "compress")}
    for name, k in kernels.items():
        d = ("decompress" if "decompress_kernel" in name else
             "compress" if "compress_kernel" in name else None)
        if d:
            out[d]["launches"] += k["launches"]
            out[d]["device_ms"] += k["device_ms"]
    out["device_ms"] = sum(out[d]["device_ms"]
                           for d in ("decompress", "compress"))
    return out


# (blocks an SM, shared memory of a decompress block) that --sweep tries
# on the 4-byte batches (a)-(c)
SWEEP = [dict(SLOT_DECOMPRESS_PER_SM=bps, SLOT_COMPRESS_PER_SM=bps,
              SLOT_CHUNK_BYTES=chunk)
         for bps in (2, 4, 6, 8, 16) for chunk in (8192, 16384, 32768)]
# (compress blocks an SM, a span's largest number of a block's passes)
# that --sweep tries on the 8- and 16-byte words' batches
WORD_SWEEP = [(bps, units) for bps in (2, 4, 6, 8, 12, 16)
              for units in (1, 4, 16)]


def sweep(cs, cases, grids, decompress: bool = True) -> list:
    """P6's device ms per launch on each case (label, store, ids) under
    each grid of ``grids`` (kernels_cuda's constants by name), the
    cases' cached grids dropped; compress only where not
    ``decompress``.  The constants are restored after."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc

    names = {n for g in grids for n in g}
    keep = {n: getattr(kc, n) for n in names}
    rows = []
    try:
        for grid in grids:
            for n, v in grid.items():
                setattr(kc, n, v)
            row = dict(grid)
            for label, st, ids in cases:
                args = (st.values, st.idx, st.off, st.cap, ids)
                ids.geometry.clear()
                dense = kc.decompress_tiles(*args, st.nb)
                if decompress:
                    row[f"{label}_decompress_ms"] = cs.device_ms(
                        lambda: kc.decompress_tiles(*args, st.nb), n=50)
                row[f"{label}_compress_ms"] = cs.device_ms(
                    lambda: kc.compress_tiles(*args, dense), n=50)
                ids.geometry.clear()
            rows.append(row)
            print("  sweep " + ", ".join(
                f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()))
    finally:
        for n, v in keep.items():
            setattr(kc, n, v)
    return rows


# The designs of 8- and 16-byte words that P6 did not keep, as edits of
# csrc/compressed.cuh (old text, new text), measured against the shipped
# one (a group is one 16-byte vector, SLOT_PASS slots a thread a pass):
# "one_vector", a thread takes one group a pass (a pass of
# SLOT_THREADS groups; 1 slot a thread of 16-byte words, 2 of 8-byte);
# "strided", 8-byte words in groups of one slot, a thread's 4 slots of
# a pass SLOT_THREADS apart (block-strided lanes, as 16-byte words
# take them in the shipped design).
VARIANTS = {
    "shipped": [],
    "one_vector": [(
        "constexpr int kSlotVectors = kSlotPass / SlotWord<sizeof(T)>::"
        "kGroup;", "constexpr int kSlotVectors = 1;")],
    "strided": [("  using T = uint2;\n  static constexpr int kGroup = 2;",
                 "  using T = uint2;\n  static constexpr int kGroup = 1;")],
}


def variants(cs, dev) -> dict:
    """Each design of VARIANTS, its own build: P6 both ways on the
    nb=512 batch of every slot type and the nb=128 complex128 batch,
    bit-equal to the plain versions (else RuntimeError after all ran),
    device ms per launch."""
    from pangulu_tpu_torch.ops import build
    from pangulu_tpu_torch.ops import kernels_cuda as kc
    from pangulu_tpu_torch.ops import kernels_torch as kt
    from pangulu_tpu_torch.tools.variants import build_variants

    dirs, _ = build_variants(VARIANTS, "compressed.cuh", "probe_p6")
    build.CSRC_DIR, build.BUILD_DIR = dirs["shipped"]
    kc._library = None
    _, wst, wids = wide_batch(32, 512, dev)
    _, nst, nids = native_batch(16, NB, dev)
    rng = np.random.default_rng(20)
    cases = []
    for dt in SLOT_TYPES:
        random_slots(wst, dt, rng)
        cases.append((f"nb=512 {str(dt)[6:]}", wst.values, wst, wids))
    cases.append((f"nb={NB} complex128 native", nst.values, nst, nids))
    result, bad = {}, []
    for name in VARIANTS:
        build.CSRC_DIR, build.BUILD_DIR = dirs[name]
        kc._library = None
        kc.library()
        row = result[name] = {}
        for label, values, st, ids in cases:
            st.values = values
            args = (values, st.idx, st.off, st.cap, ids)
            got = kc.decompress_tiles(*args, st.nb)
            back = torch.full_like(values, 5.0)
            plain = torch.full_like(values, 5.0)
            kc.compress_tiles(back, st.idx, st.off, st.cap, ids, got)
            kt.compress_tiles(plain, st.idx, st.off, st.cap, ids, got)
            ok = torch.equal(got, kt.decompress_tiles(*args, st.nb)) and \
                torch.equal(back, plain)
            row[label] = dict(
                bit_equal=ok,
                decompress_ms=cs.device_ms(
                    lambda: kc.decompress_tiles(*args, st.nb), n=50),
                compress_ms=cs.device_ms(
                    lambda: kc.compress_tiles(*args, got), n=50))
            print(f"  {name}, {label}: decompress "
                  f"{row[label]['decompress_ms']:.5f} ms, compress "
                  f"{row[label]['compress_ms']:.5f} ms, "
                  f"{'bit-equal' if ok else 'DIFFER'} to the plain versions")
            if not ok:
                bad.append(f"{name} {label}")
            del got, back, plain
    if bad:
        raise RuntimeError(f"disagree with the plain versions: {bad}")
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the tree whose pangulu_tpu_torch is measured")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default="")
    ap.add_argument("--sweep", action="store_true",
                    help="also time P6 under each geometry of SWEEP (this "
                         "checkout's wrappers only)")
    ap.add_argument("--wide", action="store_true",
                    help="also time P6 at nb=512 for every slot type and "
                         "at nb=128 on native complex128 slots")
    ap.add_argument("--variants", action="store_true",
                    help="only this tree's design variants (VARIANTS)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_p6: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root if not args.variants else ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pangulu_tpu_torch import InitOptions, init
    from pangulu_tpu_torch.compressed import CompressedLU
    from pangulu_tpu_torch.models import poisson3d

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.variants:
        return emit({"root": str(ROOT), "card": card,
                     "variants": variants(cs, dev)}, args.out)
    a = poisson3d(32)
    h = init(a, InitOptions(nb=NB, dtype="r32", ordering="nd",
                            tile_storage="compressed", device="cuda"))
    # gstrf takes PanelLU at r32 and nb=128 on the card: the level loop
    # whose batches these are is CompressedLU's, built as gstrf builds it
    # elsewhere (chip_smoke.py's compressed phase does the same)
    clu = CompressedLU(h.blocked, h.schedule, h.reordering.reordered,
                       device=dev)
    st = clu.factorize()
    st.refill(h.reordering.reordered)       # the store before factoring
    v0 = st.values.clone()
    out = {"root": str(root), "card": card}
    print(f"probe_p6 ({root}): poisson3d(32), nb={NB}, nd, r32, "
          "compressed")
    batches = {}
    for key, ids in p6_batches(clu).items():
        batches[key] = measure_batch(cs, st, ids)
        print_batch(f"({key})", batches[key])
    out["batches"] = batches
    if args.sweep:
        out["sweep"] = sweep(cs, [(k, st, ids) for k, ids in
                                  p6_batches(clu).items()], SWEEP)
    if args.wide or args.sweep:
        wclu, wst, wids = wide_batch(32, 512, dev)
        nh, nst, nids = native_batch(16, NB, dev)
        rng = np.random.default_rng(20)
    if args.wide:
        out["wide"] = {}
        print(f"probe_p6: nb=512, poisson3d(32) rcm, the widest level's "
              f"{len(wids)} update tiles")
        for dt in SLOT_TYPES:
            random_slots(wst, dt, rng)
            out["wide"][str(dt)] = measure_batch(cs, wst, wids)
            print_batch(f"nb=512 {dt}", out["wide"][str(dt)])
        print(f"probe_p6: nb={NB}, poisson3d(16) with imaginary parts, "
              f"cr64 native compressed, rcm, the widest level's "
              f"{len(nids)} update tiles")
        out["wide"][f"nb={NB} {torch.complex128} native"] = m = \
            measure_batch(cs, nst, nids)
        print_batch(f"nb={NB} {torch.complex128} native", m)
        out["wide"]["nb=512 complex128 native trace"] = native_trace(cs,
                                                                     dev)
    if args.sweep:
        out["word_sweep"] = []
        for dt in (torch.float64, torch.complex128):
            random_slots(wst, dt, rng)
            w = wst.values.element_size()
            cases = [(f"nb=512 {str(dt)[6:]}", wst, wids)]
            if w == 16:
                cases.append((f"nb={NB} complex128 native", nst, nids))
            out["word_sweep"] += sweep(cs, cases, [
                dict(SLOT_COMPRESS_PER_SM=bps, SLOT_SPAN_UNITS=units)
                for bps, units in WORD_SWEEP], decompress=False)
    if args.wide or args.sweep:
        del wclu, wst, wids, nh, nst, nids
        torch.cuda.empty_cache()
    prof = cs.profile(lambda _: clu.factorize(),
                      setup=lambda: st.values.copy_(v0))
    out["trace"] = dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                        idle_share=prof["idle_share"],
                        p6=p6_in_trace(prof["kernels"]))
    p6 = out["trace"]["p6"]
    print(f"  trace of one factorization: wall {prof['wall_ms']:.3f} ms, "
          f"busy {prof['busy_ms']:.3f} ms; P6 {p6['device_ms']:.3f} device "
          f"ms (decompress {p6['decompress']['launches']} launches "
          f"{p6['decompress']['device_ms']:.3f} ms, compress "
          f"{p6['compress']['launches']} launches "
          f"{p6['compress']['device_ms']:.3f} ms)")
    out["ms_per_factorization"] = cs.cuda_ms(
        lambda _: clu.factorize(), setup=lambda: st.values.copy_(v0),
        reps=args.reps)
    sch = h.schedule
    xb = torch.zeros((sch.block_length + 1, NB, 1), device=dev)
    xb[:sch.block_length].view(-1)[:a.n] = torch.as_tensor(
        h.reordering.transform_b(
            (a.to_scipy() @ np.ones(a.n)).astype(np.float32)), device=dev)
    out["ms_per_solve"] = cs.cuda_ms(lambda _: clu.solve_blocked(xb),
                                     reps=args.reps)
    prof = cs.profile(lambda _: clu.solve_blocked(xb))
    out["solve_trace"] = dict(wall_ms=prof["wall_ms"],
                              busy_ms=prof["busy_ms"],
                              idle_share=prof["idle_share"],
                              p6=p6_in_trace(prof["kernels"]))
    p6 = out["solve_trace"]["p6"]
    print(f"  trace of one solve: wall {prof['wall_ms']:.3f} ms, busy "
          f"{prof['busy_ms']:.3f} ms; P6 {p6['device_ms']:.3f} device ms "
          f"({p6['decompress']['launches']} decompress launches)")
    print(f"  {out['ms_per_factorization']:.3f} ms per factorization, "
          f"{out['ms_per_solve']:.3f} ms per solve (CUDA events, median "
          f"of {args.reps})")
    return emit(out, args.out)


def emit(out: dict, path: str) -> int:
    """Print the JSON line {"probe_p6": out}, and write it to ``path``
    where one is given."""
    line = json.dumps({"probe_p6": out})
    if path:
        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(path).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
