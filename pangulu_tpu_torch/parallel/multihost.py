"""Multi-process set-up and the shard helpers.

Counterpart of ``pangulu_tpu.parallel.multihost`` (pangulu_tpu/parallel/
multihost.py:31-102), and through it of the reference's MPI bootstrap
(``mpirun -np P`` + ``MPI_COMM_WORLD``, examples/example.c:82): each
process runs the same program as one rank of a ``torch.distributed``
job, and the p x q grid spans the ranks.  Usage (the same script on
every rank)::

    from pangulu_tpu_torch.parallel import multihost
    multihost.distributed_init("nccl")        # env:// as torchrun sets it
    opts = InitOptions(mesh_shape="auto")     # the grid over all ranks

Nothing in a process tells it of a cluster: ``torchrun`` (or the
caller) gives the rendezvous, the world size and the rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def distributed_init(backend: str, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     strict: bool | None = None) -> bool:
    """Initialise the default process group (idempotent: an existing
    group is kept).  Returns whether a group exists afterwards.

    ``backend``: ``"nccl"`` for one rank a card, ``"gloo"`` otherwise
    (the CPU, or several ranks on one card).  ``init_method`` defaults to
    ``"env://"`` (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as torchrun
    sets them).  ``strict``: raise when the initialisation fails, instead
    of returning False and leaving a single-process run; it defaults to
    True whenever an argument other than ``backend`` was passed, so a
    misconfigured job fails loudly rather than running as N independent
    copies of world size 1."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if dist.is_initialized():
        return True
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    if strict is None:
        strict = explicit
    try:
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=-1 if world_size is None else world_size,
            rank=-1 if rank is None else rank)
    except (ValueError, RuntimeError):
        if strict:
            raise
        return False
    return True


def is_primary() -> bool:
    """True on the rank that does the host-side output (rank 0, or a
    process outside any group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def put_replicated(grid, host_array: np.ndarray) -> torch.Tensor:
    """The whole host table on this rank's device (the tables every
    rank reads)."""
    return torch.as_tensor(np.ascontiguousarray(host_array),
                           device=grid.device)


def put_grid_sharded(grid, host_table: np.ndarray) -> torch.Tensor:
    """Row ``[r, c]`` of a ``[p, q, ...]`` host table, this rank's
    shard, on this rank's device."""
    if host_table.shape[:2] != (grid.p, grid.q):
        raise ValueError(f"expected a [{grid.p}, {grid.q}, ...] table, got "
                         f"shape {host_table.shape}")
    return torch.as_tensor(np.ascontiguousarray(host_table[grid.r, grid.c]),
                           device=grid.device)
