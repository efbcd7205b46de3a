"""The device mesh: named axes over ``torch.distributed`` ranks.

The reference drives every device from one controller through a JAX
``Mesh``; the port runs one process per rank (SPMD).  ``Mesh`` names the
axes, holds this rank's coordinates, and builds one process group for every
tuple of axes: the ranks that share every other coordinate.

Ranks are numbered row-major over the axes in their order (``("data",
"model")`` or ``("pod", "data", "model")``).  ``torch.distributed.new_group``
sorts its ranks, so a rank's place in the group of ``axes`` is the row-major
linearisation of its coordinates on those axes, which is what the
reference's ``_axis_index`` computes: chunk ``i`` of an all-to-all reaches
the rank JAX would call ``i``.

    init_ranks(rank, world, init_method)        # every process
    mesh = make_host_mesh(data=2, model=2)      # (data=2, model=2)
    mesh = make_production_mesh()               # (data=16, model=16)

``init_method`` is a ``file://`` path or ``tcp://localhost:<port>`` on a
free port (never a fixed one: several runs may share the host).
"""

from __future__ import annotations

import datetime
import itertools
import math
from typing import Optional

import torch
import torch.distributed as dist

PG_TIMEOUT_S = 600.0


def pick_backend(local_world: int, device: str = "cuda") -> str:
    """NCCL when each of the host's ``local_world`` ranks has a card of
    its own, gloo otherwise (the CPU, or several ranks sharing one card:
    NCCL refuses two ranks on one GPU)."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def rank_device(local_rank: int, device: str = "cuda") -> torch.device:
    """The device the host's rank ``local_rank`` computes on:
    ``cuda:(local_rank mod cards)`` for CUDA (every rank on ``cuda:0``
    when there is one card), else the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def rank_layout(rank: int, world: int, device: str = "cuda", *,
                local_rank: Optional[int] = None,
                local_world: Optional[int] = None) -> tuple:
    """(backend, device) of rank ``rank`` of ``world``: by its place on
    its host (``local_rank`` of ``local_world``, as ``torchrun`` sets
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; one host by default)."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    return (pick_backend(local_world, device),
            rank_device(local_rank, device))


def torchrun_ranks(env) -> dict:
    """``init_ranks``' rank arguments from the environment ``torchrun``
    gives each process: ``RANK`` of ``WORLD_SIZE``, and ``LOCAL_RANK`` of
    ``LOCAL_WORLD_SIZE`` on its host where set."""
    out = {"rank": int(env["RANK"]), "world": int(env["WORLD_SIZE"])}
    for key, name in (("local_rank", "LOCAL_RANK"),
                      ("local_world", "LOCAL_WORLD_SIZE")):
        if name in env:
            out[key] = int(env[name])
    return out


def init_ranks(rank: int, world: int, init_method: str, *,
               device: str = "cuda", local_rank: Optional[int] = None,
               local_world: Optional[int] = None) -> str:
    """Join the process group as ``rank`` of ``world``; returns the
    backend.  On CUDA it also makes the rank's device current
    (``rank_layout``).  A collective that waits longer than
    ``PG_TIMEOUT_S`` fails."""
    backend, dev = rank_layout(rank, world, device, local_rank=local_rank,
                               local_world=local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return backend


class Mesh:
    """Named axes over the ranks, row-major, plus this rank's coordinates.

    ``shape`` maps axis name to size (as a JAX mesh's does).  ``group``
    returns the process group of an axis tuple; a mesh built without a
    process group (``connect=False``) describes a layout and has none."""

    def __init__(self, axis_names, sizes, rank: int = 0, *,
                 connect: bool = False):
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in sizes)
        if len(sizes) != len(self.axis_names) or min(sizes) < 1:
            raise ValueError(f"mesh axes {self.axis_names} need one size "
                             f">= 1 each, got {sizes}")
        self.shape = dict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        coords, r = [], rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        self.coords = dict(zip(self.axis_names, reversed(coords)))
        self.backend: Optional[str] = None
        self._groups: dict = {}
        if connect:
            self._connect()

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({dims}; rank {self.rank} at {self.coords})"

    # -- axes ------------------------------------------------------------
    def axes(self, axes) -> tuple:
        """Normalise an axis name or tuple; the tuple must follow the mesh
        order (a group's rank is the row-major index in that order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [self.axis_names.index(a) for a in axes]
        if pos != sorted(set(pos)):
            raise ValueError(f"axes {axes} must be distinct and in the mesh "
                             f"order {self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (its group rank)."""
        idx = 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_ranks(self, axes, coords: Optional[dict] = None) -> list:
        """Global ranks of the group over ``axes`` through ``coords``
        (default: this rank's), in group-rank order."""
        axes = self.axes(axes)
        coords = dict(self.coords if coords is None else coords)
        out = []
        for vals in itertools.product(*(range(self.shape[a]) for a in axes)):
            coords.update(zip(axes, vals))
            r = 0
            for a in self.axis_names:
                r = r * self.shape[a] + coords[a]
            out.append(r)
        return out

    # -- process groups ----------------------------------------------------
    def _connect(self) -> None:
        """Create every axis tuple's groups.  ``new_group`` is collective
        over the whole world, so every rank creates every group, in one
        order."""
        if not dist.is_initialized():
            raise RuntimeError("Mesh(connect=True) needs an initialised "
                               "process group (init_ranks)")
        if dist.get_world_size() != self.size:
            raise ValueError(f"world of {dist.get_world_size()} ranks, mesh "
                             f"of {self.size}")
        self.backend = dist.get_backend()
        names = self.axis_names
        for n_ax in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n_ax):
                rest = [a for a in names if a not in axes]
                for vals in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = self.group_ranks(axes, dict(zip(rest, vals)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def group(self, axes):
        axes = self.axes(axes)
        if axes not in self._groups:
            raise RuntimeError(f"{self!r} has no process group for {axes} "
                               "(built without connect=True?)")
        return self._groups[axes]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh over the initialised process group
    (``torchrun`` starts one process a rank): (data=16, model=16) on 256
    ranks, or (pod=2, data=16, model=16) on 512.  Any other world size
    raises ``ValueError`` naming the one it needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} "
            f"needs a world of {need} ranks; this one has {world}")
    return Mesh(names, shape, dist.get_rank(), connect=True)


def production_layout(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The production mesh's layout seen from ``rank``, with no process
    group (``connect=False``): what the dry run (``launch/dryrun.py``)
    plans and prices on without the 256 or 512 ranks."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16), rank)
    return Mesh(("data", "model"), (16, 16), rank)


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """The mesh ``(data, model)``, or ``(pod, data, model)`` when ``pod``,
    over the initialised process group; this process is its rank."""
    if pod:
        return Mesh(("pod", "data", "model"), (pod, data, model),
                    dist.get_rank(), connect=True)
    return Mesh(("data", "model"), (data, model), dist.get_rank(),
                connect=True)


__all__ = ["Mesh", "make_host_mesh", "make_production_mesh",
           "production_layout", "init_ranks",
           "pick_backend", "rank_device", "rank_layout", "torchrun_ranks"]
