"""The process grid and 2D block-cyclic ownership.

Counterpart of ``pangulu_tpu.parallel.mesh`` (pangulu_tpu/parallel/
mesh.py:17-38) and of the reference's process grid: ``p`` = the largest
divisor of the rank count not above its square root, ``q`` = ranks / p,
block (i, j) owned by rank ``(i % p)·q + j % q`` (pangulu_common.h:135,
pangulu.c:83-90).  A :class:`Grid` takes the place of the JAX package's
``Mesh(('gp', 'gq'))``: its all-reduces over ``"world"``, ``"row"`` and
``"col"`` are that package's psums over ``('gp', 'gq')``, ``'gq'`` and
``'gp'``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import socket

import numpy as np
import torch
import torch.distributed as dist

from pangulu_tpu_torch.utils.perf import resolve_device


def grid_shape(n_devices: int) -> tuple[int, int]:
    """Reference grid rule (pangulu.c:83-90)."""
    p = 1
    for d in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % d == 0:
            p = d
    return p, n_devices // p


def owner(bi, bj, p, q):
    """Grid coordinates (r, c) owning block (bi, bj)."""
    return bi % p, bj % q


class _Done:
    """A collective that has completed (or had nothing to do)."""

    def wait(self) -> bool:
        return True


_DONE = _Done()


@dataclasses.dataclass(eq=False)
class Grid:
    """This rank's place in a p x q grid.

    ``groups`` maps ``"world"``, ``"row"`` (the ranks of this rank's
    grid row: a psum over ``'gq'``) and ``"col"`` (its grid column:
    ``'gp'``) to a process group (``None``: the default group); an axis
    of one rank has no entry, and its all-reduce is the identity, as a
    psum over one device is.  ``counts`` adds up the all-reduces made and
    the bytes they carried."""

    p: int
    q: int
    r: int
    c: int
    device: torch.device
    groups: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(
        default_factory=lambda: {"all_reduces": 0, "bytes": 0})

    @classmethod
    def single(cls, device="cuda") -> "Grid":
        """A 1 x 1 grid: one rank, no process group."""
        return cls(p=1, q=1, r=0, c=0, device=resolve_device(device))

    @property
    def rank(self) -> int:
        return self.r * self.q + self.c

    @property
    def size(self) -> int:
        return self.p * self.q

    def all_reduce(self, t: torch.Tensor, over: str,
                   async_op: bool = False):
        """Sum ``t`` in place over ``over`` (``"world"``, ``"row"`` or
        ``"col"``).  Returns something to ``wait()`` on before ``t`` is
        read (with ``async_op`` the collective may still be running;
        ``t`` must not be written until then).  A complex ``t`` is summed
        as its real view (``torch.view_as_real``: the real and imaginary
        parts side by side, each summed alone, which is the complex sum),
        so that no backend has to take complex types; it must be
        contiguous, as every tensor of a collective must."""
        if over not in ("world", "row", "col"):
            raise ValueError(f"over must be world, row or col, got {over!r}")
        if over not in self.groups:
            return _DONE
        if t.is_complex():
            if not t.is_contiguous():
                raise ValueError("a complex tensor is all-reduced as its "
                                 "real view, which needs it contiguous")
            t = torch.view_as_real(t)
        self.counts["all_reduces"] += 1
        self.counts["bytes"] += t.numel() * t.element_size()
        work = dist.all_reduce(t, group=self.groups[over],
                               async_op=async_op)
        return work if async_op else _DONE

    def check_same(self, digest: bytes, what: str) -> None:
        """Raise on every rank unless every rank passed rank 0's
        ``digest`` (a broadcast from rank 0, then an all-reduce of the
        mismatches, so that no rank is left waiting in a collective)."""
        if "world" not in self.groups:
            return
        mine = torch.as_tensor(
            np.frombuffer(hashlib.sha256(digest).digest(), np.int64).copy(),
            device=self.device)
        theirs = mine.clone()
        dist.broadcast(theirs, src=0, group=self.groups["world"])
        bad = (theirs != mine).any().to(torch.int64).reshape(1)
        dist.all_reduce(bad, group=self.groups["world"])
        if int(bad.item()):
            raise RuntimeError(
                f"{what} differ between ranks ({int(bad.item())} of "
                f"{self.size} differ from rank 0): every rank must run the "
                "same host preprocessing on the same matrix and options")


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``"cuda"`` without an index is card
    ``rank % torch.cuda.device_count()``; ``"cuda:i"`` and ``"cpu"`` are
    taken as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)   # raises without a GPU
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(dev)


def card_identities(dev: torch.device) -> list:
    """(host name, card) of every rank, gathered over a gloo group of
    its own (the NCCL group carries nothing before the check)."""
    card = (str(torch.cuda.get_device_properties(dev).uuid)
            if dev.type == "cuda" else "cpu")
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (socket.gethostname(), card),
                           group=dist.new_group(backend="gloo"))
    return out


def check_one_rank_per_card(identities: list) -> None:
    """NCCL takes one rank a card: raise if two ranks share one."""
    first = {}
    for rank, ident in enumerate(identities):
        if ident in first:
            raise ValueError(
                f"ranks {first[ident]} and {rank} share the card {ident[1]} "
                f"on {ident[0]}: backend 'nccl' takes one rank a card (run "
                "more ranks than cards with backend 'gloo')")
        first[ident] = rank


def make_grid(mesh_shape, device="cuda") -> Grid:
    """The grid of this rank in the initialised default process group:
    ``mesh_shape`` is ``(p, q)`` with p·q = the world size, or
    ``"auto"`` (:func:`grid_shape` of the world size).  Every rank must
    call it, in the same order as its other collectives: it creates the
    p row groups and q column groups (``dist.new_group`` is a collective
    of the whole world)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "mesh_shape needs an initialised torch.distributed process "
            "group (pangulu_tpu_torch.parallel.multihost.distributed_init, "
            "or a launcher such as torchrun); none exists in this process")
    world, rank = dist.get_world_size(), dist.get_rank()
    if mesh_shape == "auto":
        p, q = grid_shape(world)
    else:
        p, q = (int(v) for v in mesh_shape)
    if p < 1 or q < 1 or p * q != world:
        raise ValueError(f"mesh_shape {mesh_shape!r} needs p*q ranks, and "
                         f"the world size is {world}")
    dev = rank_device(device, rank)
    if dist.get_backend() == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' needs device='cuda'")
        check_one_rank_per_card(card_identities(dev))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    r, c = divmod(rank, q)
    groups = {"world": None} if world > 1 else {}
    for rr in range(p):
        if q > 1:
            g = dist.new_group([rr * q + cc for cc in range(q)])
            if rr == r:
                groups["row"] = g
    for cc in range(q):
        if p > 1:
            g = dist.new_group([rr * q + cc for rr in range(p)])
            if cc == c:
                groups["col"] = g
    return Grid(p=p, q=q, r=r, c=c, device=dev, groups=groups)
