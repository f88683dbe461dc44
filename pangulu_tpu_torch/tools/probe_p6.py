#!/usr/bin/env python3
"""P6, the compressed store's slot decompress and compress, on one
NVIDIA GPU, for the package of this checkout or of another tree:

    python3 pangulu_tpu_torch/tools/probe_p6.py [--root DIR] [--reps 7]
        [--out F] [--sweep] [--wide]

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
    SLOT_COMPRESS_PER_SM and SLOT_CHUNK_BYTES;
  * traces one factorization with torch.profiler: P6's device ms and
    launches, the trace's busy and wall ms;
  * times a factorization and a solve (CUDA events, median of --reps)
    and traces one solve (P6's device ms and launches, busy, wall);
  * with --wide, times P6 at nb=512 on the widest rcm level's update
    tiles of poisson3d(32) (:func:`wide_batch`) for each slot word:
    float32, float64, complex64 and complex128 values drawn at random.

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
SWEEP = [(bps, chunk) for bps in (2, 4, 6, 8, 16)
         for chunk in (8192, 16384, 32768)]


def sweep(cs, st, batches: dict) -> list:
    """P6's device ms per launch at each batch and direction under each
    geometry of SWEEP (kernels_cuda.SLOT_DECOMPRESS_PER_SM and
    SLOT_COMPRESS_PER_SM both set to its blocks an SM, SLOT_CHUNK_BYTES
    to its bytes, the batches' cached grids dropped); the constants are
    restored after."""
    from pangulu_tpu_torch.ops import kernels_cuda as kc

    names = ("SLOT_DECOMPRESS_PER_SM", "SLOT_COMPRESS_PER_SM",
             "SLOT_CHUNK_BYTES")
    args = (st.values, st.idx, st.off, st.cap)
    keep = {n: getattr(kc, n) for n in names}
    rows = []
    try:
        for bps, chunk in SWEEP:
            for n, v in zip(names, (bps, bps, chunk)):
                setattr(kc, n, v)
            row = dict(blocks_per_sm=bps, chunk_bytes=chunk)
            for key, ids in batches.items():
                ids.geometry.clear()
                dense = kc.decompress_tiles(*args, ids, st.nb)
                row[f"{key}_decompress_ms"] = cs.device_ms(
                    lambda: kc.decompress_tiles(*args, ids, st.nb), n=50)
                row[f"{key}_compress_ms"] = cs.device_ms(
                    lambda: kc.compress_tiles(*args, ids, dense), n=50)
                ids.geometry.clear()
            rows.append(row)
            print("  sweep " + ", ".join(
                f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()))
    finally:
        for n, v in keep.items():
            setattr(kc, n, v)
    return rows


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
                    help="also time P6 at nb=512 for every slot type")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_p6: no CUDA device", file=sys.stderr)
        return 2
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
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
        out["sweep"] = sweep(cs, st, p6_batches(clu))
    if args.wide:
        wclu, wst, wids = wide_batch(32, 512, dev)
        rng = np.random.default_rng(20)
        out["wide"] = {}
        print(f"probe_p6: nb=512, poisson3d(32) rcm, the widest level's "
              f"{len(wids)} update tiles")
        for dt in SLOT_TYPES:
            random_slots(wst, dt, rng)
            out["wide"][str(dt)] = measure_batch(cs, wst, wids)
            print_batch(f"nb=512 {dt}", out["wide"][str(dt)])
        del wclu, wst, wids
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
    line = json.dumps({"probe_p6": out})
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
