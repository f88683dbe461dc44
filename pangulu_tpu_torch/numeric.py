"""Numeric LU factorization engine (single device).

Counterpart of the reference's DAG scheduler + compute threads
(``pangulu_numeric.c:256-1080``) and of ``pangulu_tpu.numeric``'s
``"mega"`` and ``"mega_group"`` dispatches: the whole elimination runs
as one call of an engine in :mod:`ops.kernels_cuda` — the hand-written
CUDA kernel on a CUDA device, its plain PyTorch version on the CPU:

  * ``"mega"``: :func:`~ops.kernels_cuda.mega_factorize`, one level
    after the other (the chain; what RCM bands need);
  * ``"mega_group"``: :func:`~ops.kernels_cuda.mega_factorize_groups`,
    one super-level group of independent columns per step (what
    nested-dissection schedules compress to).

``dispatch="auto"`` picks by the JAX package's rule
(``pangulu_tpu/numeric.py:485-501``), for f32 and f64 alike.  Both
engines persist each level's triangle inverses (``inv_tiles
[bl, 2, nb, nb]``, indexed by level) for the matmul-only solve.

The other engines of the JAX package (``fused``, ``levels``,
``segmented``, the dd engines) are not ported; see ROADMAP.md.
"""

from __future__ import annotations

import torch

from pangulu_tpu_torch.blocks import BlockedMatrix
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops.kernels_torch import (DEFAULT_TOL, KernelTables,
                                                 mega_uch)
from pangulu_tpu_torch.schedule import Schedule, build_schedule
from pangulu_tpu_torch.utils.log import get_logger
from pangulu_tpu_torch.utils.perf import (PerfCounters, device_sync,
                                          resolve_device)

log = get_logger()

DISPATCHES = ("auto", "mega", "mega_group")


def groups_worthwhile(schedule: Schedule, gmax: int) -> bool:
    """Batched super-level groups pay when they shorten the dependent
    chain enough: ``bl >= 1.5 * sum(ceil(len(superlevel) / gmax))``.
    Chain schedules (RCM bands: every level depends on the previous
    one) compress nothing and keep the chain engine."""
    ng = sum(-(-len(m) // gmax) for m in schedule.superlevels())
    return schedule.block_length >= 1.5 * ng


def pick_engine(dispatch: str, schedule: Schedule, gmax: int):
    """(engine, reason) for ``dispatch`` in :data:`DISPATCHES`."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, got "
                         f"{dispatch!r}")
    if dispatch != "auto":
        return dispatch, "asked for"
    if groups_worthwhile(schedule, gmax):
        return "mega_group", "the schedule compresses into super-level groups"
    return "mega", "chain schedule (super-level groups would not pay)"


class LUFactorizer:
    """Runs gstrf on a blocked matrix (reference: pangulu_gstrf,
    pangulu.c:211) on ``device`` with the engine ``dispatch`` picks.
    ``device="cuda"`` (the default) runs the hand kernels and raises
    without a GPU; ``device="cpu"`` the plain versions."""

    # Most members of one group; wider super-levels split (members stay
    # independent).  The JAX package's value, kept for table parity.
    GROUP_GMAX = 16

    def __init__(self, blocked: BlockedMatrix,
                 schedule: Schedule | None = None,
                 perf: PerfCounters | None = None, device="cuda",
                 tol: float | None = None, dispatch: str = "auto"):
        self.blocked = blocked
        self.schedule = schedule or build_schedule(blocked)
        self.perf = perf or PerfCounters()
        self.device = resolve_device(device)
        self.tol = (tol if tol is not None
                    else DEFAULT_TOL[blocked.torch_dtype])
        self.dispatch, why = pick_engine(dispatch, self.schedule,
                                         self.GROUP_GMAX)
        nt = blocked.num_tiles
        uch = mega_uch(blocked.nb)
        # ship the tables to the device once; the engines read their
        # loop counts from the host copies
        if self.dispatch == "mega_group":
            tables = self.schedule.group_mega_tables(
                nt, uch=uch, gmax=self.GROUP_GMAX)
            why += (f"; {self.schedule.block_length} levels -> "
                    f"{tables['ngroups']} groups (gmax={tables['gmax']})")
        else:
            tables = self.schedule.mega_tables(nt, uch=uch)
        log.info("engine: %s (%s)", self.dispatch, why)
        self.tables = KernelTables.build(tables, self.device)
        self.inv_tiles = None  # [bl, 2, nb, nb] after factorize()

    def _group_worthwhile(self) -> bool:
        return groups_worthwhile(self.schedule, self.GROUP_GMAX)

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
        engine = (kernels_cuda.mega_factorize_groups
                  if self.dispatch == "mega_group"
                  else kernels_cuda.mega_factorize)
        with self.perf.phase("numeric"):
            tiles, self.inv_tiles = engine(
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
        self.perf.kernels["engine"] = self.dispatch
        return tiles
