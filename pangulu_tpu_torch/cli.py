"""Command-line interface — counterpart of the reference example program
(examples/example.c) and of ``pangulu_tpu.cli``: read a matrix file
(and an optional rhs), run init/gstrf/gstrs, report residual and perf.

    python -m pangulu_tpu_torch -f matrix.mtx -nb 128 [-r rhs.txt]
                                [--dtype r32] [--check] [--device cpu]

``--device cuda`` (the default) runs the hand-written CUDA kernels,
``--device cpu`` their plain PyTorch versions.  ``-nb`` above 256 runs
the fused engine (K1 for wide tiles on the card); ``--backend`` picks
its block kernels (``cuda``: K1 for the diagonal step, ``torch``:
PyTorch ops throughout), ``--complex-mode native`` complex tiles for
cr32/cr64.  ``--profile-dir DIR`` writes a
``torch.profiler`` trace of gstrf's numeric phase into DIR as Chrome
trace JSON.

``--mesh p,q|auto`` factors and solves over a grid of ranks, one
process a rank, and needs a launcher that starts them (outside one it
exits 2)::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m pangulu_tpu_torch -f matrix.mtx --mesh 2,2 --dist-backend gloo

Every rank runs the same program; only rank 0 prints.  The backend
defaults to ``nccl`` with ``--device cuda`` (one rank a card) and
``gloo`` with ``--device cpu``; several ranks on one card take
``--dist-backend gloo``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

LAUNCHER = ("python -m torch.distributed.run --standalone --nproc-per-node "
            "N -m pangulu_tpu_torch ... --mesh p,q")


def _under_launcher() -> bool:
    """True when a launcher (torchrun) gave this process its rank."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pangulu_tpu_torch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("-f", "--file", default=None,
                    help=".mtx / .mtx.gz / .lid (binary CSR) / .npz matrix "
                         "file (required unless --load-factor)")
    ap.add_argument("-nb", type=int, default=128, help="block size")
    ap.add_argument("-r", "--rhs", default=None,
                    help="rhs file (default: b = A @ ones)")
    ap.add_argument("--dtype", default="r64",
                    choices=["r32", "r64", "cr32", "cr64"])
    ap.add_argument("--ordering", default="auto",
                    choices=["auto", "mindeg", "rcm", "nd", "natural"])
    ap.add_argument("--symbolic", default="auto",
                    choices=["auto", "scalar", "block"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="block kernels of the fused/levels engines (nb > "
                         "256, native complex): cuda = K1 for the diagonal "
                         "step, torch = PyTorch ops; auto = cuda for real "
                         "tiles on a CUDA device")
    ap.add_argument("--complex-mode", default="auto",
                    choices=["auto", "embed", "native"],
                    help="cr32/cr64: the real 2x2 embedding (embed, and "
                         "auto) or complex tiles (native)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (the default); "
                         "cpu: their plain PyTorch versions")
    ap.add_argument("--no-mc64", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="run the gstrf residual check (reference "
                         "-DPANGULU_PERF)")
    ap.add_argument("--mesh", default=None,
                    help="p,q grid of ranks (or auto) for a run under a "
                         "launcher: " + LAUNCHER)
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend with --mesh (default: "
                         "nccl with --device cuda, gloo with --device cpu)")
    ap.add_argument("--refine", type=int, default=-1,
                    help="iterative-refinement rounds in gstrs "
                         "(-1 = auto: 2 for r32)")
    ap.add_argument("--save-factor", default=None, metavar="PATH",
                    help="write the factorization to PATH (.npz) after "
                         "gstrf for later solve-only reuse")
    ap.add_argument("--load-factor", default=None, metavar="PATH",
                    help="skip init+gstrf; load a factor saved with "
                         "--save-factor (by either package) and go "
                         "straight to gstrs")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler trace of gstrf's numeric "
                         "phase into DIR: one Chrome trace JSON file "
                         "(<host>_<pid>[_rank<r>].<ns>.pt.trace.json) for "
                         "chrome://tracing or Perfetto, with the card's "
                         "kernels on --device cuda")
    ap.add_argument("--tile-storage", default="dense",
                    choices=["dense", "compressed"],
                    help="factor storage: dense tiles, or O(fill) "
                         "compressed slots (low memory)")
    args = ap.parse_args(argv)
    if not args.file and not args.load_factor:
        ap.error("either -f/--file or --load-factor is required")
    if args.mesh and not _under_launcher():
        print("pangulu_tpu_torch: --mesh runs one process a rank and needs "
              f"a launcher to start them: {LAUNCHER}", file=sys.stderr)
        return 2
    if args.mesh and args.load_factor:
        print("pangulu_tpu_torch: --load-factor reads a whole factor, and "
              "--mesh factors over a grid of ranks: give one of them",
              file=sys.stderr)
        return 2
    if not args.mesh:
        return _run(args, primary=True)
    from pangulu_tpu_torch.parallel import multihost

    backend = args.dist_backend or ("nccl" if args.device == "cuda"
                                    else "gloo")
    multihost.distributed_init(backend, strict=True)
    try:
        return _run(args, primary=multihost.is_primary())
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _run(args, primary: bool) -> int:
    """The run itself, on every rank; only ``primary`` prints and
    writes."""
    if primary:
        return _solve(args, primary)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return _solve(args, primary)


def _solve(args, primary: bool) -> int:
    from pangulu_tpu_torch.api import InitOptions, finalize, gstrf, gstrs, init
    from pangulu_tpu_torch.io.checkpoint import load_factor, save_factor
    from pangulu_tpu_torch.io.mmio import generated_rhs, read_matrix, read_rhs
    from pangulu_tpu_torch.sparse import (VALUE_DTYPES, CscMatrix,
                                          complex_unembed_matrix)
    from pangulu_tpu_torch.utils.perf import (device_memory_stats,
                                              host_rss_bytes, residual_norm)

    if args.load_factor:
        try:
            handle = load_factor(args.load_factor, device=args.device)
        except NotImplementedError as e:
            print(f"pangulu_tpu_torch: {e}", file=sys.stderr)
            return 2
        # the checkpoint records its own value type: the --dtype default
        # must not override it (a saved r32 factor would otherwise read
        # the rhs as r64)
        dtype = VALUE_DTYPES[handle.opts.dtype]
        # a complex handle's a_origin is its 2n x 2n real embedding: the
        # rhs and the residual belong to the complex system
        a = CscMatrix.from_scipy(
            handle.a_origin if handle.complex_embed is None else
            complex_unembed_matrix(handle.a_origin, handle.complex_embed))
    else:
        dtype = VALUE_DTYPES[args.dtype]
        try:
            a = read_matrix(args.file, dtype=dtype)
        except (OSError, ValueError) as e:
            print(f"error reading matrix {args.file!r}: {e}",
                  file=sys.stderr)
            return 2
        mesh = None
        if args.mesh:
            mesh = ("auto" if args.mesh == "auto"
                    else tuple(int(v) for v in args.mesh.split(",")))
        opts = InitOptions(nb=args.nb, dtype=args.dtype,
                           mc64=not args.no_mc64, ordering=args.ordering,
                           symbolic_mode=args.symbolic, check=args.check,
                           refine=args.refine, device=args.device,
                           tile_storage=args.tile_storage, mesh_shape=mesh,
                           backend=args.backend,
                           complex_mode=args.complex_mode,
                           profile_dir=args.profile_dir)
        try:
            handle = init(a, opts)
        except NotImplementedError as e:
            print(f"pangulu_tpu_torch: {e}", file=sys.stderr)
            return 2
        gstrf(handle)
        if args.save_factor and primary:
            try:
                save_factor(handle, args.save_factor)
            except NotImplementedError as e:
                print(f"pangulu_tpu_torch: {e}", file=sys.stderr)
                return 2
    b = (read_rhs(args.rhs, a.n, dtype) if args.rhs
         else generated_rhs(a))
    x = gstrs(handle, b)
    res = residual_norm(a.to_scipy(), x, b)
    print(handle.perf.summary())
    print(f"solve residual ||Ax-b||/||b|| = {res:.6e}")
    print(f"host RSS: {host_rss_bytes() / 2**20:.1f} MiB")
    for dev, st in device_memory_stats().items():
        print(f"{dev}: peak {st['peak_bytes_allocated'] / 2**20:.1f} MiB "
              f"allocated, {st['free_bytes'] / 2**20:.1f} of "
              f"{st['total_bytes'] / 2**20:.1f} MiB free")
    finalize(handle)
    return 0 if res < 1e-4 else 1


if __name__ == "__main__":
    sys.exit(main())
