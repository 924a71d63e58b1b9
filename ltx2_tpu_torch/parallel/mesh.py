"""A grid of ranks with one process group per axis line (counterpart of
ltx2_tpu/parallel/mesh.py).

The JAX package runs one controller over a device mesh; the port runs one
process per rank, and a `Mesh` is this process's view of a grid of ranks
laid out (data, pipe, seq, model), model innermost, as the JAX mesh lays out
devices. Each axis of size above 1 gets one `torch.distributed` group for
every line of ranks along it (`dist.new_group`, which every rank of the
world calls for every line, in the same order); this rank's line on each
axis is an `Axis`: its size, this rank's index on it, the line's global
ranks and its group. Collectives over an axis are `parallel/collectives.py`.

A mesh may cover the first n ranks of a larger world (the VAE's meshes); a
rank outside it is not a `member`, and its axes have size 1. Without a
process group, or with every size 1, every axis has size 1 and no group:
the single-device path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ltx2_tpu_torch.parallel.runtime import world

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
AXIS_ORDER = (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, MODEL_AXIS)  # outermost first


@dataclass(frozen=True, eq=False)
class Axis:
    """This rank's line of ranks along one mesh axis. `backend` is the
    world's ("gloo", "nccl"; None without a process group); collectives
    over the axis pick their route from it and the tensor's device."""

    name: str
    size: int = 1
    index: int = 0
    ranks: Tuple[int, ...] = (0,)
    group: Optional[object] = None
    backend: Optional[str] = None

    def rank_at(self, offset: int) -> int:
        """The global rank `offset` places on along the ring of this line."""
        return self.ranks[(self.index + offset) % self.size]

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"


def _world() -> Tuple[int, int, Optional[str]]:
    """(rank, world size, backend): (0, 1, None) without a process group."""
    rank, size = world()
    return rank, size, dist.get_backend() if dist.is_initialized() else None


class Mesh:
    """This rank's view of a (data, pipe, seq, model) grid of ranks.
    `shape` gives each axis's size, as the JAX Mesh's does."""

    def __init__(self, sizes: Dict[str, int], axes: Dict[str, Axis], rank: int, ranks: Sequence[int],
                 member: bool):
        self.sizes = dict(sizes)
        self._axes = axes
        self.rank = rank
        self.ranks = tuple(ranks)
        self.member = member

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.sizes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.sizes)

    def axis(self, name: str) -> Axis:
        """This rank's line along `name`; size 1 for an axis the mesh lacks."""
        return self._axes.get(name) or Axis(name, ranks=(self.rank,))

    def __repr__(self) -> str:
        return f"Mesh({self.sizes}, rank={self.rank}, member={self.member})"


def create_mesh(
    data: int = 1,
    model: Optional[int] = None,
    seq: int = 1,
    pipe: int = 1,
    ranks: Optional[Sequence[int]] = None,
) -> Mesh:
    """A (data[, pipe][, seq], model) grid over `ranks` (default: the whole
    world), laid out as the JAX package's `create_mesh` lays out devices:
    model innermost, pipe outermost after data. model=None takes every
    remaining rank. Every rank of the world must call it with the same
    arguments (group creation is collective); a rank outside `ranks` gets a
    mesh that is not a `member`. The JAX package drops singleton pipe and
    seq axes and keeps data and model; so does `shape` here."""
    rank, world, backend = _world()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    n = len(ranks)
    if model is None:
        model = n // (data * seq * pipe)
    if data * model * seq * pipe != n:
        raise ValueError(
            f"mesh data={data} x pipe={pipe} x seq={seq} x model={model} "
            f"= {data * pipe * seq * model} does not match {n} ranks"
        )
    if any(r < 0 or r >= world for r in ranks):
        raise ValueError(f"mesh ranks {ranks} outside the world of {world}")
    dims = {DATA_AXIS: data, PIPE_AXIS: pipe, SEQ_AXIS: seq, MODEL_AXIS: model}
    grid = torch.tensor(ranks).reshape(data, pipe, seq, model)
    member = rank in ranks
    axes = {}
    for i, name in enumerate(AXIS_ORDER):
        if dims[name] == 1:
            continue
        # Every line along axis i: the grid moved so the axis is last.
        lines = grid.movedim(i, -1).reshape(-1, dims[name]).tolist()
        for line in lines:
            group = dist.new_group(line)
            if member and rank in line:
                axes[name] = Axis(name, dims[name], line.index(rank), tuple(line), group, backend)
    keep = {name: dims[name] for name in AXIS_ORDER if name in (DATA_AXIS, MODEL_AXIS) or dims[name] > 1}
    return Mesh(keep, axes, rank, ranks, member)


def single_device_mesh() -> Mesh:
    """The one-rank mesh: every axis of size 1, no group."""
    rank, _, _ = _world()
    return Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, {}, rank, (rank,), True)


def axis_of(mesh: Optional[Mesh], name: str) -> Optional[Axis]:
    """`mesh`'s line along `name` when it has more than one rank, else None
    (no mesh, a singleton axis, or a rank outside the mesh)."""
    if mesh is None or not mesh.member:
        return None
    axis = mesh.axis(name)
    return axis if axis.size > 1 else None
