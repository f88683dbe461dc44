#!/usr/bin/env python3
"""Run the port's distributed gstrf and gstrs as N processes on this
host, one rank each (the reference's ``mpirun -np P`` smoke,
README.md:145-153; the counterpart of the JAX package's
``tools/run_multiprocess.py``).

    python3 pangulu_tpu_torch/tools/run_multiprocess.py -np 4 --mesh 2,2 \\
        --device cpu --backend gloo --out DIR \\
        --case p2d:poisson2d:10:r64:nd:8 [--case ...] [--reps 3]

The parent spawns N ranks joined by a ``file://`` rendezvous in a
temporary directory (no port to clash with other jobs) and waits for
them; it stops all of them as soon as one fails, prints the failed
ranks' logs and exits 1.  A case
``LABEL:MATRIX:SIZE:DTYPE:ORDERING:NB[:COMPLEX_MODE]`` generates
``MATRIX(SIZE)`` (``pangulu_tpu_torch.models``; a complex DTYPE adds
imaginary parts, ``testing.with_imaginary_parts``, and takes the real
2x2 embedding unless COMPLEX_MODE is ``native``), and every rank runs,
through the public API with ``mesh_shape``:

  1. ``init`` -> ``gstrf`` (``check=True``: the distributed residual),
     with its K1 launches counted (``kernels_cuda.LAUNCHES``, the CUDA
     wrapper's: 0 on the CPU), then ``gstrs`` of b = A·1 and of three
     right-hand sides from a seed, and ``factor_check_vector``;
  2. ``--reps`` more factorizations and solves, timed (wall ms from the
     call to the device's synchronise, with an all-reduce aligning the
     ranks before each), the first also compared with the first
     factorization bit for bit;
  3. on more than one rank, the calls a sharded handle refuses
     (``gstrs(trans=True)``, ``gstrs_device``, ``save_factor``,
     ``factor_diagnostics``), recording what each raised;
  4. ``update_values`` with the values scaled by 1 + 0.1·u (rounded to
     the working precision), ``gstrf`` on the kept tables, ``gstrs``;

and writes ``DIR/LABEL_rank{r}.npz``: its factored shard, the tables'
digest, the solutions, residuals, check vector, launch and all-reduce
counts, times and refusals; rank 0 adds the layout (owner and slot of
every tile), so that a test can assemble the factors.  Each rank's log
is ``DIR/rank{r}.log``.  On the CPU each rank runs one thread.  Ranks
find each other over the loopback device (``GLOO_SOCKET_IFNAME`` and
``NCCL_SOCKET_IFNAME`` = ``lo`` unless set).
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def parse_case(spec: str) -> dict:
    label, matrix, size, dtype, ordering, nb, *mode = spec.split(":")
    if len(mode) > 1 or mode and mode[0] not in ("auto", "embed", "native"):
        raise ValueError(f"case {spec!r}: LABEL:MATRIX:SIZE:DTYPE:ORDERING:"
                         "NB[:auto|embed|native]")
    return dict(label=label, matrix=matrix, size=int(size), dtype=dtype,
                ordering=ordering, nb=int(nb),
                complex_mode=mode[0] if mode else "auto")


def _refusal(fn) -> str:
    """The type and message of what ``fn()`` raised ("" if nothing)."""
    try:
        fn()
    except (NotImplementedError, ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def run_case(case: dict, args, grid_shape, out: pathlib.Path) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from pangulu_tpu_torch import api, models
    from pangulu_tpu_torch.io.checkpoint import save_factor
    from pangulu_tpu_torch.ops import kernels_cuda
    from pangulu_tpu_torch.testing import with_imaginary_parts
    from pangulu_tpu_torch.utils.perf import device_sync, residual_norm

    rank = dist.get_rank()
    a = getattr(models, case["matrix"])(case["size"])
    if case["dtype"].startswith("c"):
        a = with_imaginary_parts(a, seed=0)
    a = a.to_scipy()
    acc = np.complex128 if case["dtype"].startswith("c") else np.float64
    a = a.astype(acc)
    n = a.shape[0]
    b = a @ np.ones(n)
    rng = np.random.default_rng(7)
    x3_true = rng.standard_normal((n, 3)).astype(acc)
    b3 = a @ x3_true
    opts = api.InitOptions(nb=case["nb"], dtype=case["dtype"],
                           ordering=case["ordering"], device=args.device,
                           mesh_shape=grid_shape, check=True,
                           complex_mode=case["complex_mode"])
    h = api.init(a, opts)
    dev = h.device
    rec = {}
    kernels_cuda.reset_launch_counts()
    api.gstrf(h)
    rec["k1_launches"] = kernels_cuda.LAUNCHES["getrf_with_inverses"]
    rec["k1_device_launches"] = kernels_cuda.DEVICE_LAUNCHES[
        "getrf_with_inverses"]
    dist_lu = h._dist
    multi = dist_lu.single is None
    rec["gstrf_residual"] = h.perf.kernels["gstrf_residual"]
    shard = h.factor_tiles.clone()
    x1 = api.gstrs(h, b)
    x3 = api.gstrs(h, b3)
    rec.update(x1=x1, x3=x3, x3_true=x3_true,
               res1=residual_norm(a, x1, b), res3=residual_norm(a, x3, b3))
    if multi:
        rec["check_w"] = dist_lu.factor_check_vector()
        rec["comm_all_reduces"] = dist_lu.comm["all_reduces"]
        rec["comm_bytes"] = dist_lu.comm["bytes"]
        rec["groups"] = dist_lu.groups
        rec["digest"] = np.frombuffer(dist_lu.digest, np.uint8)
        rec["lmax"] = dist_lu.layout.lmax
        if rank == 0:
            lay = dist_lu.layout
            rec.update(tile_owner_r=lay.tile_owner_r,
                       tile_owner_c=lay.tile_owner_c, tile_slot=lay.tile_slot)
    rec["shard"] = shard.cpu().numpy()
    rec["num_tiles"] = h.blocked.num_tiles
    rec["block_length"] = h.schedule.block_length
    align = torch.zeros(1, device=dev)

    def aligned(fn):
        # start every rank's timed call together, end at its synchronise
        if dist.get_world_size() > 1:
            dist.all_reduce(align)
        device_sync(dev)
        t0 = time.perf_counter()
        fn()
        device_sync(dev)
        return (time.perf_counter() - t0) * 1e3

    fms, sms, nms = [], [], []
    for rep in range(args.reps):
        numeric0 = h.perf.phase_time.get("numeric", 0.0)
        fms.append(aligned(lambda: dist_lu.factorize()))
        nms.append((h.perf.phase_time["numeric"] - numeric0) * 1e3)
        if rep == 0:
            rec["same_bits"] = bool(torch.equal(dist_lu.tiles, shard))
        h.factor_tiles = dist_lu.tiles
        sms.append(aligned(lambda: api.gstrs(h, b, refine=0)))
    rec.update(factor_ms=np.array(fms), numeric_ms=np.array(nms),
               solve_ms=np.array(sms))
    if multi:
        rec["refused_trans"] = _refusal(lambda: api.gstrs(h, b, trans=True))
        rec["refused_gstrs_device"] = _refusal(lambda: api.gstrs_device(
            h, torch.zeros(n, dtype=h.blocked.torch_dtype, device=dev)))
        rec["refused_save_factor"] = _refusal(
            lambda: save_factor(h, out / f"never_{rank}.npz"))
        rec["refused_factor_diagnostics"] = _refusal(
            lambda: api.factor_diagnostics(h))
    # refactorization on the kept tables
    coo = a.tocoo()
    scale = 1 + 0.1 * np.random.default_rng(3).uniform(size=coo.nnz)
    data = coo.data * scale
    if case["dtype"] in ("r32", "cr32"):
        # values the working precision holds exactly, so that the
        # refined residual is the solver's, not the rounding of A
        data = data.astype(np.complex64 if case["dtype"] == "cr32"
                           else np.float32).astype(acc)
    a2 = type(coo)((data, (coo.row, coo.col)), shape=coo.shape).tocsc()
    b2 = a2 @ np.ones(n)
    api.update_values(h, a2)
    api.gstrf(h)
    x2 = api.gstrs(h, b2)
    rec.update(x2=x2, res2=residual_norm(a2, x2, b2),
               gstrf_residual2=h.perf.kernels["gstrf_residual"],
               dist_reuse=h.perf.kernels.get("dist_reuse", 0))
    api.finalize(h)
    np.savez(out / f"{case['label']}_rank{rank}.npz", **rec)


def worker(args) -> int:
    import torch

    from pangulu_tpu_torch.parallel import multihost

    if args.device == "cpu":
        torch.set_num_threads(1)
    multihost.distributed_init(args.backend,
                               init_method=f"file://{args.rendezvous}",
                               world_size=args.np, rank=args.worker)
    grid_shape = ("auto" if args.mesh == "auto"
                  else tuple(int(v) for v in args.mesh.split(",")))
    out = pathlib.Path(args.out)
    try:
        for spec in args.case:
            case = parse_case(spec)
            t0 = time.perf_counter()
            run_case(case, args, grid_shape, out)
            print(f"rank {args.worker}: {case['label']} done in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def launch(args) -> int:
    """Spawn the ranks; wait; stop them all when one fails."""
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(ROOT) + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else str(ROOT))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for i in range(args.np):
            log = open(out / f"rank{i}.log", "w")
            logs.append(log)
            cmd = [sys.executable, os.path.abspath(__file__),
                   "-np", str(args.np), "--mesh", args.mesh,
                   "--device", args.device, "--backend", args.backend,
                   "--out", str(out), "--reps", str(args.reps),
                   "--worker", str(i),
                   "--rendezvous", os.path.join(tmp, "rendezvous")]
            for c in args.case:
                cmd += ["--case", c]
            procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + args.timeout
        failed = []
        try:
            while any(p.poll() is None for p in procs):
                failed = [i for i, p in enumerate(procs)
                          if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            failed = [i for i, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            timed_out = any(p.poll() is None for p in procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()
    if failed or timed_out:
        for i in failed or range(args.np):
            text = (out / f"rank{i}.log").read_text()
            sys.stderr.write(f"--- rank {i} (exit {procs[i].returncode}) "
                             f"---\n{text[-6000:]}\n")
        if timed_out:
            sys.stderr.write(f"run_multiprocess: timed out after "
                             f"{args.timeout:.0f} s\n")
        return 1
    print(f"MULTIPROC OK ranks={args.np} mesh={args.mesh} "
          f"device={args.device} backend={args.backend} "
          f"cases={','.join(parse_case(c)['label'] for c in args.case)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-np", type=int, default=4, dest="np")
    ap.add_argument("--mesh", default="auto", help="p,q or auto")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--case", action="append", required=True,
                    help="LABEL:MATRIX:SIZE:DTYPE:ORDERING:NB"
                         "[:COMPLEX_MODE]")
    ap.add_argument("--reps", type=int, default=1,
                    help="timed factorizations and solves after the first")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--rendezvous", default=None)
    args = ap.parse_args(argv)
    for c in args.case:
        parse_case(c)
    return worker(args) if args.worker is not None else launch(args)


if __name__ == "__main__":
    sys.exit(main())
