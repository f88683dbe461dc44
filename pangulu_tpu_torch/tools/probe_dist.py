#!/usr/bin/env python3
"""The multi-device engine under each torch.distributed backend, side by
side: the same cases through ``run_multiprocess.py`` once a backend, in
one call, then each case's factors (assembled from the ranks' shards)
compared between the backends, with the times, all-reduces and
residuals of each.

    python3 pangulu_tpu_torch/tools/probe_dist.py --backends nccl,gloo \\
        [-np 4] [--mesh 2,2] [--device cuda] [--reps 3] [--out F.json] \\
        [--case LABEL:MATRIX:SIZE:DTYPE:ORDERING:NB[:COMPLEX_MODE] ...]

With as many cards as ranks, each rank takes its own card
(``cuda:{rank % device_count}``): nccl needs that and raises otherwise;
gloo runs either way.  The default cases are ``chip_smoke.py``'s
multi-device cases (poisson3d(32) nb=128 r32 rcm and nd, poisson3d(16)
nb=128 r64 nd).  Prints a table and one JSON line; exits 1 if a run
fails or a case's factors differ between backends by more than the f32
tile tolerance (1e-5 rcm, 2e-4 nd; 1e-12 for r64 and cr64; complex
factors compared as complex128).

    python3 pangulu_tpu_torch/tools/probe_dist.py allreduce -np 4 \\
        [--backend gloo] [--device cuda] [--out F.json]

times one all-reduce over N ranks on this host, ms a call (the median
of 5 runs of 100 calls, each waited on), at the sizes the engine sends
(16 KiB: a solve group's segments; 256 KiB and 4 MiB: panels), in three
ways: a tensor on the rank's device, the same tensor staged through the
host by hand (``.cpu()``, all-reduce, ``copy_`` back), and a host
tensor.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
TOOL = ROOT / "pangulu_tpu_torch" / "tools" / "run_multiprocess.py"
CASES = ("p3d32_rcm:poisson3d:32:r32:rcm:128",
         "p3d32_nd:poisson3d:32:r32:nd:128",
         "p3d16_r64_nd:poisson3d:16:r64:nd:128")


def assemble(ranks: list, q: int) -> np.ndarray:
    """The factored tiles in tile-id order from the ranks' shards (rank
    r·q + c holds grid coordinate (r, c))."""
    r0 = ranks[0]
    sh = np.stack([r["shard"] for r in ranks])
    return sh[r0["tile_owner_r"].astype(np.int64) * q + r0["tile_owner_c"],
              r0["tile_slot"]]


def summary(ranks: list) -> dict:
    """A case's numbers: medians over the ranks of each rank's median."""
    r0 = ranks[0]

    def med(key):
        return float(np.median([np.median(r[key]) for r in ranks]))

    return dict(groups=int(r0["groups"]),
                k1_launches_per_rank=int(r0["k1_launches"]),
                all_reduces_per_factorization=int(r0["comm_all_reduces"]),
                mib_per_factorization=int(r0["comm_bytes"]) / 2 ** 20,
                ms_per_factorization=med("factor_ms"),
                numeric_ms=med("numeric_ms"), ms_per_solve=med("solve_ms"),
                gstrf_residual=float(r0["gstrf_residual"]),
                solve_residual=float(r0["res1"]),
                same_bits=all(bool(r["same_bits"]) for r in ranks))


SIZES = (16 << 10, 256 << 10, 4 << 20)


def allreduce_worker(args) -> None:
    import statistics

    import torch
    import torch.distributed as dist

    from pangulu_tpu_torch.parallel import multihost
    from pangulu_tpu_torch.parallel.mesh import rank_device

    multihost.distributed_init(args.backend,
                               init_method=f"file://{args.rendezvous}",
                               world_size=args.np, rank=args.worker)
    dev = rank_device(args.device, args.worker)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def staged(t):
        h = t.cpu()
        dist.all_reduce(h)
        t.copy_(h)

    ways = {"device": lambda t: dist.all_reduce(t), "staged": staged}
    out = {}
    for size in SIZES:
        t = torch.ones(size // 4, dtype=torch.float32, device=dev)
        host = torch.ones(size // 4, dtype=torch.float32)
        for way, fn in list(ways.items()) + [("host", None)]:
            x = host if way == "host" else t
            call = (lambda: dist.all_reduce(x)) if fn is None else (
                lambda: fn(x))
            for _ in range(10):
                call()
            sync()
            runs = []
            for _ in range(5):
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(100):
                    call()
                sync()
                runs.append((time.perf_counter() - t0) * 1e3 / 100)
            out[f"{way}_{size >> 10}KiB_ms"] = statistics.median(runs)
    if args.worker == 0:
        line = json.dumps({"probe_allreduce": dict(
            ranks=args.np, backend=args.backend, device=args.device, **out)})
        if args.out:
            pathlib.Path(args.out).write_text(line + "\n")
        print(line, flush=True)
    dist.destroy_process_group()


def allreduce_main(argv) -> int:
    ap = argparse.ArgumentParser(prog="probe_dist.py allreduce")
    ap.add_argument("-np", type=int, default=4, dest="np")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--rendezvous", default=None)
    args = ap.parse_args(argv)
    if args.worker is not None:
        allreduce_worker(args)
        return 0
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, __file__, "allreduce"] + argv
            + ["--worker", str(i), "--rendezvous",
               os.path.join(tmp, "rendezvous")], env=env)
            for i in range(args.np)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return 0 if all(rc == 0 for rc in rcs) else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["allreduce"]:
        return allreduce_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backends", default="nccl,gloo")
    ap.add_argument("-np", type=int, default=4, dest="np")
    ap.add_argument("--mesh", default="2,2")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--case", action="append", default=None)
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    cases = args.case or list(CASES)
    q = int(args.mesh.split(",")[1])
    res = {"ranks": args.np, "mesh": args.mesh, "device": args.device}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in args.backends.split(","):
            out = pathlib.Path(tmp) / backend
            cmd = [sys.executable, str(TOOL), "-np", str(args.np), "--mesh",
                   args.mesh, "--device", args.device, "--backend", backend,
                   "--out", str(out), "--reps", str(args.reps)]
            for c in cases:
                cmd += ["--case", c]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            print(f"{backend}: exit {p.returncode}, {wall:.1f} s: "
                  f"{p.stdout.strip()}", flush=True)
            if p.returncode != 0:
                print(p.stderr[-8000:], file=sys.stderr)
                return 1
            runs[backend] = {c.split(":")[0]: [
                dict(np.load(out / f"{c.split(':')[0]}_rank{r}.npz"))
                for r in range(args.np)] for c in cases}
            res[f"{backend}_wall_s"] = wall
    ok = True
    backends = list(runs)
    for spec in cases:
        label, dtype, ordering = (spec.split(":")[i] for i in (0, 3, 4))
        row = {b: summary(runs[b][label]) for b in backends}
        tol = 1e-12 if dtype in ("r64", "cr64") else (
            2e-4 if ordering == "nd" else 1e-5)
        wide = np.complex128 if dtype.startswith("c") else np.float64
        ref = assemble(runs[backends[0]][label], q).astype(wide)
        for b in backends[1:]:
            got = assemble(runs[b][label], q).astype(wide)
            diff = np.abs(got - ref)
            row[f"{b}_vs_{backends[0]}"] = dict(
                max_abs_diff=float(diff.max()),
                bit_identical=bool(np.array_equal(got, ref)))
            if not (diff <= tol + tol * np.abs(ref)).all():
                ok = False
        res[label] = row
        for b in backends:
            s = row[b]
            print(f"{label} {b}: {s['ms_per_factorization']:.1f} ms per "
                  f"factorization (numeric {s['numeric_ms']:.1f}), "
                  f"{s['ms_per_solve']:.1f} ms per solve, "
                  f"{s['all_reduces_per_factorization']} all-reduces, "
                  f"{s['mib_per_factorization']:.2f} MiB a rank; K1 "
                  f"{s['k1_launches_per_rank']} a rank; residuals "
                  f"{s['gstrf_residual']:.2e} / {s['solve_residual']:.2e}")
        for b in backends[1:]:
            print(f"{label} {b} against {backends[0]}: "
                  f"{row[f'{b}_vs_{backends[0]}']}")
    line = json.dumps({"probe_dist": res})
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
