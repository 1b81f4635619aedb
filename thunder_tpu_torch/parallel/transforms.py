"""Distributed strategy transforms: replicated data parallelism (DDP).

thunder_tpu/parallel/transforms.py for the port. Each rank runs the whole
training step on its block of the batch (training.TrainStep cuts it), all
traced shapes are rank-local, and parameter synchronization is collective
prims recorded in the trace:

  DDP: params replicated; a `synchronize` marker (fwd identity / bwd
       all-reduce) inserted per param — the gradient all-reduce.

thunder_tpu places replicated parameters as one array by construction;
here every rank holds its own copy, so ``ddp`` (and ``context_parallel``)
broadcast each parameter and buffer from the first rank of the axis when
the module is wrapped, and the ranks start equal.

Not ported yet (ROADMAP A3b): ``fsdp`` (ZeRO-2/3: all_gather,
reduce_scatter, padding), tensor parallelism (``DistPlan.tp_axis``), the
GSPMD road's ``activation_specs``, and gradient bucketing
(``ddp(bucket_mb=...)``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..core.transform_common import Transform
from ..nn.module import ThunderModule
from . import prims as dist_prims
from .mesh import DP_AXIS, Mesh, axis_size


@dataclass
class ParamStrategy:
    kind: str  # 'replicate' (the only kind ported: 'shard0', 'column', 'row' wait)
    axis: str


@dataclass
class DistPlan:
    mesh: Mesh
    # per-param chain of strategies, applied in order at trace time
    param_strategies: dict = field(default_factory=dict)
    data_axes: tuple = ()  # axes the batch dim (dim 0) is split over
    seq_axes: tuple = ()  # axes the sequence dim (dim 1) is split over (context parallel)

    def world_size(self, axis: str) -> int:
        return axis_size(self.mesh, axis)

    @property
    def loss_axes(self) -> tuple:
        return tuple(self.data_axes) + tuple(a for a in self.seq_axes if a not in self.data_axes)

    @property
    def loss_world_size(self) -> int:
        n = 1
        for a in self.loss_axes:
            n *= self.world_size(a)
        return n

    def merge(self, other: "DistPlan") -> "DistPlan":
        merged = DistPlan(self.mesh, dict(self.param_strategies), tuple(self.data_axes),
                          tuple(self.seq_axes))
        for k, v in other.param_strategies.items():
            merged.param_strategies[k] = list(merged.param_strategies.get(k, [])) + list(v)
        for a in other.data_axes:
            if a not in merged.data_axes:
                merged.data_axes = merged.data_axes + (a,)
        for a in other.seq_axes:
            if a not in merged.seq_axes:
                merged.seq_axes = merged.seq_axes + (a,)
        return merged


class DistributedTransform(Transform):
    """The plan's marker in the module's transform list; the collectives
    themselves are inserted by TrainStep (apply_param_collectives)."""

    def __init__(self, plan: DistPlan):
        self.plan = plan


class DDPTransform(DistributedTransform):
    """Reference thunder/distributed/transforms/ddp_v2.py:25."""


def _get_plan(tmodule: ThunderModule) -> Optional[DistPlan]:
    return getattr(tmodule, "_dist_plan", None)


def _set_plan(tmodule: ThunderModule, plan: DistPlan) -> None:
    tmodule._dist_plan = plan


def add_transform(tmodule: ThunderModule, tf: Transform) -> None:
    """Append a transform to the module's compile pipeline (later traces
    apply it)."""
    cd = tmodule._cd
    cd.transforms = tuple(cd.transforms) + (tf,)


def broadcast_replicated(tmodule: ThunderModule, mesh: Mesh, axis: str) -> None:
    """Make every rank's parameters and buffers equal to those of the first
    rank along ``axis`` (in place, outside any trace)."""
    import torch
    import torch.distributed as dist

    group = mesh.group(axis)
    if group is None:
        return
    src = mesh.ranks(axis)[0]
    with torch.no_grad():
        for t in list(tmodule.get_parameters().values()) + list(tmodule.get_buffers().values()):
            dist.broadcast(t.data, src=src, group=group)


def ddp(tmodule: ThunderModule, mesh: Mesh, *, axis: str = DP_AXIS,
        bucket_mb: Optional[float] = None) -> ThunderModule:
    """Replicated data parallel (reference thunder.distributed.ddp,
    thunder/distributed/__init__.py:203): params replicated over `axis`,
    batch split over it, grads all-reduced (pre-averaged via the loss
    all-reduce's division by the world size)."""
    if bucket_mb is not None:
        raise NotImplementedError("ddp(bucket_mb=...) (gradient bucketing) is not ported yet "
                                  "(ROADMAP A3b)")
    plan = _get_plan(tmodule) or DistPlan(mesh)
    new = DistPlan(mesh, {}, (axis,))
    for name in tmodule.get_parameters():
        new.param_strategies[name] = [ParamStrategy("replicate", axis)]
    plan = plan.merge(new)
    _set_plan(tmodule, plan)
    broadcast_replicated(tmodule, mesh, axis)
    add_transform(tmodule, DDPTransform(plan))
    return tmodule


def apply_param_collectives(params: dict, plan: DistPlan) -> dict:
    """Trace-time: insert each parameter's collective chain at its use (the
    analog of the reference's `synchronize` insertion, ddp_v2.py:25)."""
    full = {}
    for k, v in params.items():
        for st in plan.param_strategies.get(k, ()):
            if st.kind != "replicate":
                raise NotImplementedError(f"parameter strategy {st.kind!r} is not ported yet "
                                          f"(ROADMAP A3b)")
            v = dist_prims.synchronize(v, st.axis)
        full[k] = v
    return full
