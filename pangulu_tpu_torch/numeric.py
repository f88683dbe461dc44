"""Numeric LU factorization engine (single device).

Counterpart of the reference's DAG scheduler + compute threads
(``pangulu_numeric.c:256-1080``) and of ``pangulu_tpu.numeric``'s
``"mega"`` dispatch: the whole elimination loop over the level schedule
runs as one call of :func:`ops.kernels_cuda.mega_factorize` — the
hand-written CUDA kernel on a CUDA device, its plain PyTorch version on
the CPU.  The factorization persists each level's triangle inverses
(``inv_tiles [bl, 2, nb, nb]``) for the matmul-only solve.

The other engines of the JAX package (``fused``, ``levels``,
``segmented``, ``mega_group``, the dd engines) are not ported; see
ROADMAP.md.
"""

from __future__ import annotations

import torch

from pangulu_tpu_torch.blocks import BlockedMatrix
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops.kernels_torch import (DEFAULT_TOL, MEGA_UCH,
                                                 KernelTables)
from pangulu_tpu_torch.schedule import Schedule, build_schedule
from pangulu_tpu_torch.utils.perf import PerfCounters, device_sync


class LUFactorizer:
    """Runs gstrf on a blocked matrix (reference: pangulu_gstrf,
    pangulu.c:211) on ``device``."""

    def __init__(self, blocked: BlockedMatrix,
                 schedule: Schedule | None = None,
                 perf: PerfCounters | None = None, device="cpu",
                 tol: float | None = None):
        self.blocked = blocked
        self.schedule = schedule or build_schedule(blocked)
        self.perf = perf or PerfCounters()
        self.device = torch.device(device)
        self.tol = (tol if tol is not None
                    else DEFAULT_TOL[blocked.torch_dtype])
        # ship the tables to the device once; the level loop reads its
        # counts from the host copies
        self.tables = KernelTables.build(
            self.schedule.mega_tables(blocked.num_tiles, uch=MEGA_UCH),
            self.device)
        self.inv_tiles = None  # [bl, 2, nb, nb] after factorize()

    def factorize(self, tiles: torch.Tensor | None = None,
                  sync: bool = True) -> torch.Tensor:
        """Factor ``tiles`` (default: a fresh device copy of A's tile
        store, built from the scatter plan; the host store keeps A) IN
        PLACE and return it, L\\U packed per tile.  ``sync=False``
        returns without waiting for the device."""
        if tiles is None:
            # building the store counts as preprocessing (the reference
            # scatters blocks in pangulu_preprocessing)
            with self.perf.phase("preprocess"):
                tiles = self.blocked.device_tiles(self.device)
                device_sync(self.device)
        with self.perf.phase("numeric"):
            tiles, self.inv_tiles = kernels_cuda.mega_factorize(
                tiles, self.tables, nb=self.blocked.nb, tol=self.tol,
                bl=self.schedule.block_length)
            if sync:
                device_sync(self.device)
        self.perf.add_flops(self.schedule.flop_estimate())
        self.perf.kernel_counts(
            getrf=self.schedule.block_length,
            tstrf=self.schedule.n_tstrf,
            gessm=self.schedule.n_gessm,
            ssssm=self.schedule.n_ssssm,
        )
        return tiles
