"""A mesh of ranks with named axes, over torch.distributed process groups.

thunder_tpu/parallel/mesh.py for the port. thunder_tpu's substrate is a
``jax.sharding.Mesh`` whose named axes the collectives of a ``shard_map``
program name. Here a rank is one process and one card, and a ``Mesh``
lays the ranks of the process group out over the named axes (row-major,
the first axis outermost, as jax reshapes its device list) and holds one
process group for every axis and every tuple of axes, so a collective over
``("dp", "sp")`` reduces over both. The collective prims (parallel/
prims.py) resolve axis names on the active mesh: ``make_mesh`` makes its
mesh the active one, and a distributed ``TrainStep`` activates its plan's
mesh around each call.

A mesh whose axes all have size 1 needs no process group: its collectives
are identities. A larger one needs a process group (multiprocess.
initialize) of exactly its size.

thunder_tpu's ``NamedSharding`` helpers (``param_sharding``,
``replicated``, ``shard_leading``) place jax arrays for the compiler; the
port has no counterpart on this road: each rank holds its parameters
whole, and the batch block it takes is cut by TrainStep."""
from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence, Union

# canonical axis names (reference analog: process-group kinds)
DP_AXIS = "dp"        # replicated data parallel (DDP)
FSDP_AXIS = "fsdp"    # sharded data parallel (ZeRO)
TP_AXIS = "tp"        # tensor parallel
SP_AXIS = "sp"        # sequence/context parallel
EP_AXIS = "ep"        # expert parallel
PP_AXIS = "pp"        # pipeline parallel

Axes = Union[str, Sequence[str]]


def _axes(axis: Axes) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class Mesh:
    """Named axes over the ranks of the process group (or over the one
    process when every axis has size 1)."""

    def __init__(self, axis_sizes: dict):
        import torch.distributed as dist

        self.shape = dict(axis_sizes)
        self.axis_names = tuple(self.shape)
        n = math.prod(self.shape.values())
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n != world and (n > 1 or dist.is_initialized()):
            raise ValueError(f"mesh wants {n} devices, have {world}"
                             + ("" if dist.is_initialized() else " (no process group)"))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        sizes = tuple(self.shape.values())
        self.coords = dict(zip(self.axis_names, _unravel(self.rank, sizes)))
        # one group per axis tuple: every rank creates every group, in one
        # order, as new_group requires; each keeps the one it belongs to
        self._groups: dict = {}
        self._ranks: dict = {}
        if not dist.is_initialized():
            return
        for r in range(1, len(sizes) + 1):
            for sub in itertools.combinations(self.axis_names, r):
                rest = [a for a in self.axis_names if a not in sub]
                for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
                    where = dict(zip(rest, fixed))
                    ranks = [_ravel({**where, **dict(zip(sub, c))}, self.axis_names, sizes)
                             for c in itertools.product(*(range(self.shape[a]) for a in sub))]
                    g = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[sub] = g
                        self._ranks[sub] = ranks

    def _key(self, axis: Axes) -> tuple:
        axes = _axes(axis)
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise KeyError(f"mesh axes {self.axis_names} have no {unknown}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axis: Axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axis))

    def coordinate(self, axis: Axes) -> int:
        """This rank's index along the axis (or the axes, row-major)."""
        key = self._key(axis)
        return _ravel(self.coords, key, tuple(self.shape[a] for a in key))

    def group(self, axis: Axes):
        """The process group of this rank's ranks along the axis, or None
        without a process group."""
        return self._groups.get(self._key(axis))

    def ranks(self, axis: Axes) -> list:
        """The global ranks of this rank's group along the axis, in
        coordinate order."""
        return self._ranks.get(self._key(axis), [self.rank])

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _unravel(i: int, sizes: tuple) -> tuple:
    out = []
    for s in reversed(sizes):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


def _ravel(coords: dict, names: tuple, sizes: tuple) -> int:
    i = 0
    for a, s in zip(names, sizes):
        i = i * s + coords[a]
    return i


_active: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _active
    _active = mesh


def active_mesh() -> Mesh:
    if _active is None:
        raise RuntimeError("no active mesh: build one with make_mesh")
    return _active


def make_mesh(axis_sizes: dict) -> Mesh:
    """Build a named mesh over the process group and make it the active one:
    make_mesh({'sp': 4}) or {'dp': 2, 'sp': 2}. Axis order follows dict
    order, the first axis outermost (rank = dp_index * 2 + sp_index)."""
    mesh = Mesh(axis_sizes)
    set_active_mesh(mesh)
    return mesh


def single_device_mesh() -> Mesh:
    return make_mesh({DP_AXIS: 1})


def axis_size(mesh: Mesh, axis: Axes) -> int:
    return mesh.size(axis)
