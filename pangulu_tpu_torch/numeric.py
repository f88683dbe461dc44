"""Numeric LU factorization engine (single device).

Counterpart of the reference's DAG scheduler + compute threads
(``pangulu_numeric.c:256-1080``) and of ``pangulu_tpu.numeric``'s
engines.  Two run as one call of an engine in :mod:`ops.kernels_cuda`
(the hand-written CUDA kernel on a CUDA device, its plain PyTorch
version on the CPU), for real tiles of nb <= 256:

  * ``"mega"``: :func:`~ops.kernels_cuda.mega_factorize`, one level
    after the other (the chain; what RCM bands need);
  * ``"mega_group"``: :func:`~ops.kernels_cuda.mega_factorize_groups`,
    one super-level group of independent columns per step (what
    nested-dissection schedules compress to).

Both persist each level's triangle inverses (``inv_tiles [bl, 2, nb,
nb]``, indexed by level) for the matmul-only solve.  Two more walk the
levels on the host, as the JAX package's XLA engines do
(``pangulu_tpu/numeric.py:47-96, 252-283``), with the block kernels of a
:class:`~ops.interface.KernelBackend` (K1 on the card for the diagonal
step, PyTorch ops for the rest), for any nb and value type:

  * ``"fused"``: per level, (f, L^-1, U^-1) of the diagonal tile, the
    panels as products with the inverses, ``L = A·U^-1`` and ``U =
    L^-1·A``, and the Schur update ``dst -= L·U``;
  * ``"levels"``: the same, or with ``panel_solve="trsm"`` the panels
    as triangular solves (``tstrf`` / ``gessm``).

They run each level's real entries, which the host tables count: the
JAX package pads every level to one shape so that one XLA trace serves
them all, which eager PyTorch does not need, so its ``"segmented"``
engine (bounded padding, ``pangulu_tpu/numeric.py:456-460``) runs as
``fused``: a ``dispatch="segmented"`` is taken as ``fused``, with the
reason logged.  They persist no inverses, as in the JAX package.  One
more engine of the JAX package runs only when asked for:

  * ``"superfused"`` (``pangulu_tpu/numeric.py:217-250``): per
    super-level (``Schedule.superlevels``, the columns of one
    dependency depth) one diagonal step on the batch of its G
    diagonals (one K1 launch on the card), the union of its members'
    panels as one product each way, and the Schur updates in waves in
    which a destination occurs once (the JAX package's scatter-add
    sums duplicates in no fixed order on a GPU, the waves in member
    order on every run).  It persists no inverses either.

``dispatch="auto"`` picks by the JAX package's rule
(``pangulu_tpu/numeric.py:324-369``): ``levels`` for
``panel_solve="trsm"``; the mega engines for real tiles of nb <= 256
unless ``backend="torch"`` is asked for (the JAX package's mega engines
need its Pallas backend), ``mega_group`` when super-level groups pay
(``PANGULU_TPU_GROUP=0/1`` decides instead, as in the JAX package);
else ``fused``.  It never takes ``superfused`` (nor does the JAX
package's), and takes ``fused`` where the JAX package takes
``segmented`` (skewed schedules).

The JAX package's double-float engines for float64 on the TPU,
``dispatch="dd_mega" | "dd_group" | "dd"``
(``pangulu_tpu/numeric.py:385-404``), are taken on float64 stores as
``mega`` / ``superfused`` / ``fused``, with the reason logged: the card
has float64, so the same tables run at native precision.  On another
type they raise.

``"mega"`` under ``PANGULU_TPU_SUPERLEVEL=1`` (the JAX package's switch,
``pangulu_tpu/numeric.py:405-433``) takes K2's chain-ahead tables on
float32 working values where the schedule has levels of equal depth:
the levels in depth order, each same-depth level's diagonal step run
ahead on a second stream (:func:`chain_ahead_asked`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pangulu_tpu_torch.blocks import BlockedMatrix
from pangulu_tpu_torch.ops import kernels_cuda
from pangulu_tpu_torch.ops.interface import KernelBackend, get_backend
from pangulu_tpu_torch.ops.kernels_torch import (DEFAULT_TOL, MAX_NB,
                                                 KernelTables, mega_uch,
                                                 true_f32_matmul)
from pangulu_tpu_torch.schedule import Schedule, build_schedule, occurrence
from pangulu_tpu_torch.utils.log import get_logger
from pangulu_tpu_torch.utils.perf import (PerfCounters, device_sync,
                                          resolve_device)

log = get_logger()

MEGA_ENGINES = ("mega", "mega_group")
LEVEL_ENGINES = ("fused", "levels")
# the JAX package's double-float engines (float64 on the TPU) and the
# engines that run them here, on float64 stores
DD_ENGINES = {"dd_mega": "mega", "dd_group": "superfused", "dd": "fused"}
DISPATCHES = (("auto",) + MEGA_ENGINES + LEVEL_ENGINES
              + ("segmented", "superfused") + tuple(DD_ENGINES))

# Padded / real Schur work above which the JAX package leaves its fused
# engine for the segmented one (pangulu_tpu/numeric.py:301).
FUSED_OVERHEAD_LIMIT = 6.0


def groups_worthwhile(schedule: Schedule, gmax: int,
                      env: str = "PANGULU_TPU_GROUP") -> bool:
    """Batched super-level groups pay when they shorten the dependent
    chain enough: ``bl >= 1.5 * sum(ceil(len(superlevel) / gmax))``.
    Chain schedules (RCM bands: every level depends on the previous
    one) compress nothing and keep the chain engine.  The environment
    variable ``env`` set to 0 or 1 decides instead, as in the JAX
    package: ``PANGULU_TPU_GROUP`` for the factorization
    (``pangulu_tpu/numeric.py:484-495``), ``PANGULU_TPU_SOLVE_GROUP``
    for the solve (``pangulu_tpu/sptrsv.py:370-379``)."""
    val = os.environ.get(env)
    if val is not None:
        return val == "1"
    ng = sum(-(-len(m) // gmax) for m in schedule.superlevels())
    return schedule.block_length >= 1.5 * ng


def chain_ahead_asked(dtype: torch.dtype) -> bool:
    """``PANGULU_TPU_SUPERLEVEL=1`` asks for K2's chain-ahead tables
    (``Schedule.mega_tables(superlevel=True)``).  Only float32 working
    values take them: the JAX package's chain-ahead exists in its f32
    K2 alone.  On another type the switch is logged and not taken."""
    if os.environ.get("PANGULU_TPU_SUPERLEVEL") != "1":
        return False
    if dtype != torch.float32:
        log.info("PANGULU_TPU_SUPERLEVEL=1 not taken: K2's chain-ahead "
                 "runs on float32 working values only, got %s", dtype)
        return False
    return True


def mega_ineligible(nb: int, dtype: torch.dtype, backend: str) -> str:
    """Why the mega engines do not apply to tiles of ``nb`` and
    ``dtype`` with the backend asked for ("" when they do)."""
    why = []
    if dtype.is_complex:
        why.append(f"dtype={dtype} is complex (K2-K5 take float32 and "
                   "float64)")
    if nb > MAX_NB:
        why.append(f"nb={nb} > {MAX_NB} (K2-K5 stop there)")
    if backend == "torch":
        why.append("backend='torch' asked for")
    return ", ".join(why)


def pick_engine(dispatch: str, schedule: Schedule, gmax: int, *,
                dtype: torch.dtype = torch.float32, backend: str = "auto",
                panel_solve: str = "inv",
                group_env: str = "PANGULU_TPU_GROUP"):
    """(engine, reason) for ``dispatch`` in :data:`DISPATCHES`;
    ``group_env`` names the variable that overrides the group rule
    (:func:`groups_worthwhile`)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, got "
                         f"{dispatch!r}")
    nb = schedule.nb
    dd_why = ""
    if dispatch in DD_ENGINES:
        if dtype != torch.float64:
            raise ValueError(f"dispatch={dispatch!r} is the JAX package's "
                             "double-float engine for float64; got "
                             f"{dtype}")
        dispatch, dd_why = DD_ENGINES[dispatch], (
            f"{dispatch} asked for: the JAX package's double-float engine "
            f"for float64 on the TPU, its tables run by {DD_ENGINES[dispatch]}"
            " in native float64")
    if dispatch in MEGA_ENGINES and (dtype.is_complex or nb > MAX_NB):
        raise ValueError(f"dispatch={dispatch!r} runs K2-K5, which take "
                         f"real tiles of nb <= {MAX_NB}; got nb={nb}, "
                         f"{dtype}")
    if dispatch == "segmented":
        return "fused", ("segmented asked for: unpadded, its segments run "
                         "the fused engine's steps")
    if dispatch != "auto":
        return dispatch, dd_why or "asked for"
    if panel_solve == "trsm":
        return "levels", "trsm panel solves need per-level dispatch"
    why_not = mega_ineligible(nb, dtype, backend)
    if not why_not:
        if groups_worthwhile(schedule, gmax, group_env):
            return ("mega_group",
                    "the schedule compresses into super-level groups")
        return "mega", "chain schedule (super-level groups would not pay)"
    reason = f"mega ineligible: {why_not}"
    overhead = schedule.fused_overhead()
    if overhead > FUSED_OVERHEAD_LIMIT:
        reason += (f"; the JAX package would take segmented (fused_overhead "
                   f"{overhead:.2f} > {FUSED_OVERHEAD_LIMIT}), the port pads "
                   "nothing")
    return "fused", reason


def resolve_backend(backend, nb: int, dtype: torch.dtype, tol, device):
    """A :class:`KernelBackend` from a name or a backend."""
    if isinstance(backend, KernelBackend):
        return backend
    return get_backend(backend, nb=nb, dtype=dtype, tol=tol, device=device)


class FlatTables:
    """Named lists of index arrays as flat int64 tensors on the device
    (shipped once), with the offsets on the host: ``of(field, i)`` is
    entry i's slice."""

    def __init__(self, parts: dict, device):
        self.off, self.dev = {}, {}
        for f, arrs in parts.items():
            arrs = [np.asarray(a, np.int64) for a in arrs]
            self.off[f] = np.cumsum([0] + [len(a) for a in arrs])
            self.dev[f] = torch.as_tensor(
                np.concatenate(arrs) if arrs else np.zeros(0, np.int64),
                device=device)

    def of(self, field: str, i: int) -> torch.Tensor:
        """Entry i's indices of ``field``."""
        off = self.off[field]
        return self.dev[field][int(off[i]):int(off[i + 1])]

    def count(self, field: str, i: int) -> int:
        off = self.off[field]
        return int(off[i + 1] - off[i])


class LevelTables(FlatTables):
    """Per level of a schedule, the ``fields`` of its
    :class:`~schedule.Level`: what the fused and levels engines and
    solves read."""

    def __init__(self, schedule: Schedule, fields, device):
        levels = schedule.levels
        self.diag = [int(lev.diag) for lev in levels]
        self.k = [int(lev.k) for lev in levels]
        super().__init__({f: [getattr(lev, f) for lev in levels]
                          for f in fields}, device)


class SuperLevelTables(FlatTables):
    """Per super-level of a schedule (``Schedule.superlevels``), its
    members' real entries concatenated: ``diag``; ``lpanel``/``ldsel``
    and ``upanel``/``udsel`` (each panel tile's member); and by wave
    ``upd_dst``, ``upd_l``, ``upd_u`` (indices into the concatenated
    panels), wave w holding every destination's w-th occurrence in
    member order (the split of ``Schedule.superfused_wave_tables``),
    the waves of super-level i being ``waves[i]``.  ``diag_ids[i]``
    holds its diagonal tile ids on the host."""

    def __init__(self, schedule: Schedule, device):
        parts = {f: [] for f in ("diag", "lpanel", "ldsel", "upanel",
                                 "udsel", "upd_dst", "upd_l", "upd_u")}
        self.diag_ids, self.waves = [], []
        for mem in schedule.superlevels():
            levs = [schedule.levels[k] for k in mem]
            self.diag_ids.append(np.array([lev.diag for lev in levs]))
            parts["diag"].append(self.diag_ids[-1])
            upd = {}
            for f, fsel, fu in (("lpanel", "ldsel", "upd_l"),
                                ("upanel", "udsel", "upd_u")):
                n = [len(getattr(lev, f)) for lev in levs]
                parts[f].append(np.concatenate([getattr(lev, f)
                                                for lev in levs]))
                parts[fsel].append(np.repeat(np.arange(len(levs)), n))
                upd[fu] = np.concatenate([
                    np.asarray(getattr(lev, fu), np.int64) + o
                    for lev, o in zip(levs, np.cumsum([0] + n))])
            upd["upd_dst"] = np.concatenate([lev.upd_dst for lev in levs])
            occ = occurrence(np.asarray(upd["upd_dst"], np.int64))
            w0 = len(parts["upd_dst"])
            for w in range(int(occ.max(initial=-1)) + 1):
                for f, v in upd.items():
                    parts[f].append(v[occ == w])
            self.waves.append(range(w0, len(parts["upd_dst"])))
        super().__init__(parts, device)


class LUFactorizer:
    """Runs gstrf on a blocked matrix (reference: pangulu_gstrf,
    pangulu.c:211) on ``device`` with the engine ``dispatch`` picks.
    ``device="cuda"`` (the default) runs the hand kernels and raises
    without a GPU; ``device="cpu"`` the plain versions.  ``backend``
    ("auto", "cuda", "torch" or a :class:`KernelBackend`) gives the
    fused and levels engines their block kernels; ``panel_solve`` is
    "inv" (products with the inverses) or "trsm" (triangular solves, the
    levels engine)."""

    # Most members of one group; wider super-levels split (members stay
    # independent).  The JAX package's value, kept for table parity.
    GROUP_GMAX = 16

    def __init__(self, blocked: BlockedMatrix,
                 schedule: Schedule | None = None,
                 perf: PerfCounters | None = None, device="cuda",
                 tol: float | None = None, dispatch: str = "auto",
                 backend="auto", panel_solve: str = "inv"):
        self.blocked = blocked
        self.schedule = schedule or build_schedule(blocked)
        self.perf = perf or PerfCounters()
        self.device = resolve_device(device)
        dtype = blocked.torch_dtype
        self.tol = tol if tol is not None else DEFAULT_TOL[dtype]
        if panel_solve not in ("inv", "trsm"):
            raise ValueError("panel_solve must be 'inv' or 'trsm'")
        self.panel_solve = panel_solve
        self.backend = resolve_backend(backend, blocked.nb, dtype, tol,
                                       self.device)
        self.dispatch, why = pick_engine(
            dispatch, self.schedule, self.GROUP_GMAX, dtype=dtype,
            backend=self.backend.name if isinstance(
                backend, KernelBackend) else backend,
            panel_solve=panel_solve)
        nt = blocked.num_tiles
        self.tables = self.levels = self.supers = None
        if self.dispatch == "superfused":
            self.supers = SuperLevelTables(self.schedule, self.device)
            why += (f"; backend {self.backend.name}; "
                    f"{self.schedule.block_length} levels -> "
                    f"{len(self.supers.diag_ids)} super-levels")
        elif self.dispatch in LEVEL_ENGINES:
            why += f"; backend {self.backend.name}"
            self.levels = LevelTables(
                self.schedule, ("lpanel", "upanel", "upd_dst", "upd_l",
                                "upd_u"), self.device)
        else:
            # ship the tables to the device once; the engines read their
            # loop counts from the host copies
            uch = mega_uch(blocked.nb)
            if self.dispatch == "mega_group":
                tables = self.schedule.group_mega_tables(
                    nt, uch=uch, gmax=self.GROUP_GMAX)
                why += (f"; {self.schedule.block_length} levels -> "
                        f"{tables['ngroups']} groups (gmax={tables['gmax']})")
            else:
                depth = self.schedule.block_depths()
                ahead = (chain_ahead_asked(dtype)
                         and self.schedule.block_length
                         - int(depth.max(initial=0)) - 1 > 0)
                tables = self.schedule.mega_tables(nt, uch=uch,
                                                   superlevel=ahead)
                if ahead:
                    log.info("mega super-level pipeline: %d levels, %d "
                             "depths, %d chains run ahead",
                             self.schedule.block_length,
                             int(depth.max(initial=0)) + 1,
                             int(tables["flag_tab"].sum()))
            self.tables = KernelTables.build(tables, self.device)
        log.info("engine: %s (%s)", self.dispatch, why)
        self.inv_tiles = None  # [bl, 2, nb, nb] after a mega factorize()

    def _group_worthwhile(self) -> bool:
        return groups_worthwhile(self.schedule, self.GROUP_GMAX)

    def _factorize_levels(self, tiles: torch.Tensor) -> None:
        """The fused and levels engines on ``tiles``, in place: per
        level the diagonal step (``backend.diag_factor_invert``), the
        panels, the Schur update (pangulu_tpu/numeric.py:47-96,
        252-283).  A level's update destinations are distinct, so the
        scatter is a gather, a subtraction and a store."""
        be, t = self.backend, self.levels
        trsm = self.dispatch == "levels" and self.panel_solve == "trsm"
        with true_f32_matmul():
            for i, d in enumerate(t.diag):
                f, linv, uinv = be.diag_factor_invert(tiles[d], self.tol)
                tiles[d] = f
                nl, nu = t.count("lpanel", i), t.count("upanel", i)
                if nl:
                    lids = t.of("lpanel", i)
                    lblk = (be.tstrf(f, tiles[lids]) if trsm
                            else tiles[lids] @ uinv)
                    tiles[lids] = lblk
                if nu:
                    uids = t.of("upanel", i)
                    ublk = (be.gessm(f, tiles[uids]) if trsm
                            else linv @ tiles[uids])
                    tiles[uids] = ublk
                if nl and nu and t.count("upd_dst", i):
                    dst = t.of("upd_dst", i)
                    tiles[dst] = be.ssssm(tiles[dst],
                                          lblk[t.of("upd_l", i)],
                                          ublk[t.of("upd_u", i)])

    def _factorize_superlevels(self, tiles: torch.Tensor) -> None:
        """The superfused engine on ``tiles``, in place: per
        super-level the diagonal step on its G diagonals at once, the
        union of its L panels as ``tiles[l] @ U^-1[member]``, of its U
        panels as ``L^-1[member] @ tiles[u]``, then the Schur updates
        wave by wave, each a gather, a subtraction and a store
        (pangulu_tpu/numeric.py:217-250).  A super-level of one member
        runs the fused engine's step on it, bit for bit."""
        be, t = self.backend, self.supers
        with true_f32_matmul():
            for i, ids in enumerate(t.diag_ids):
                one = len(ids) == 1
                d = int(ids[0]) if one else t.of("diag", i)
                f, linv, uinv = be.diag_factor_invert(tiles[d], self.tol)
                tiles[d] = f
                if t.count("lpanel", i):
                    lids = t.of("lpanel", i)
                    lblk = tiles[lids] @ (uinv if one
                                          else uinv[t.of("ldsel", i)])
                    tiles[lids] = lblk
                if t.count("upanel", i):
                    uids = t.of("upanel", i)
                    ublk = (linv if one
                            else linv[t.of("udsel", i)]) @ tiles[uids]
                    tiles[uids] = ublk
                for w in t.waves[i]:
                    dst = t.of("upd_dst", w)
                    tiles[dst] = be.ssssm(tiles[dst],
                                          lblk[t.of("upd_l", w)],
                                          ublk[t.of("upd_u", w)])

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
            if self.dispatch == "superfused":
                self._factorize_superlevels(tiles)
            elif self.dispatch in LEVEL_ENGINES:
                self._factorize_levels(tiles)
            else:
                engine = (kernels_cuda.mega_factorize_groups
                          if self.dispatch == "mega_group"
                          else kernels_cuda.mega_factorize)
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
        self.perf.kernels["backend"] = self.backend.name
        return tiles
