"""Distributed strategy transforms: DDP, FSDP (ZeRO-2/3), hybrid meshes.

thunder_tpu/parallel/transforms.py for the port. Each rank runs the whole
training step on its block of the batch (training.TrainStep cuts it), all
traced shapes are rank-local, and parameter (un)sharding is collective
prims recorded in the trace:

  DDP:   params replicated; a `synchronize` marker (fwd identity / bwd
         all-reduce) inserted per param — the gradient all-reduce.
  FSDP:  params dim-0 sharded; `all_gather` (and the unpad slice) before
         use, the gradient reduce-scattered (all_gather's grad rule).
  Mixed: a dp × fsdp mesh stacks both (ddp over dp, then fsdp over fsdp).

thunder_tpu places each parameter as one jax array that its mesh shards;
here every rank holds its own tensors. ``ddp``, ``fsdp`` and the tensor-
parallel transforms first broadcast every parameter and buffer from the
first rank of their axis, so the ranks start equal, then keep only the
rank's block of each sharded parameter: its storage and its optimizer
state are per rank (ZeRO). A dim-0 size that the axis does not divide is
zero-padded first (thunder_tpu's ``_place_params``), and the step slices
the gathered tensor back to its size. ``full_parameter`` and
``local_parameter`` gather and re-split these tensors outside any trace
(ThunderModule.state_dict / load_state_dict call them).

Not ported yet (ROADMAP A3c): the GSPMD road's ``activation_specs``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..core.symbol import OpTags
from ..core.transform_common import Transform
from ..nn.module import ThunderModule
from . import prims as dist_prims
from .mesh import DP_AXIS, FSDP_AXIS, Mesh, axis_size

_KINDS = ("replicate", "shard0", "column", "row")


@dataclass
class ParamStrategy:
    kind: str  # 'replicate' | 'shard0' | 'column' | 'row'
    axis: str
    # FSDP extras: orig_dim0 set when dim 0 was padded to divide the axis;
    # zero selects the re-gather policy (3: the backward re-gathers, 2: the
    # gathered parameter is saved for it)
    orig_dim0: Optional[int] = None
    zero: int = 3

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"parameter strategy {self.kind!r} is not one of {_KINDS}")


@dataclass
class DistPlan:
    mesh: Mesh
    # per-param chain of strategies, applied in order at trace time
    param_strategies: dict = field(default_factory=dict)
    data_axes: tuple = ()  # axes the batch dim (dim 0) is split over
    tp_axis: Optional[str] = None
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

    def param_spec(self, name: str, ndim: int) -> tuple:
        """The axis each dim of the parameter is split over (None: whole),
        thunder_tpu's PartitionSpec as a tuple."""
        parts = [None] * max(1, ndim)
        for st in self.param_strategies.get(name, ()):
            if st.kind in ("shard0", "column"):
                parts[0] = st.axis  # weight (out, in): column-parallel splits out
            elif st.kind == "row":
                parts[1 if ndim >= 2 else 0] = st.axis  # row-parallel splits in
        return tuple(parts[:ndim])

    def merge(self, other: "DistPlan") -> "DistPlan":
        merged = DistPlan(self.mesh, dict(self.param_strategies), tuple(self.data_axes),
                          tp_axis=self.tp_axis or other.tp_axis, seq_axes=tuple(self.seq_axes))
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


class FSDPTransform(DistributedTransform):
    """Reference thunder/distributed/transforms/fsdp_v2.py:87.

    Under ZeRO-3 the gather and the unpad slice are tagged
    RECOMPUTE_IN_BACKWARD at trace time (apply_param_collectives). A dtype
    conversion of a gathered parameter (autocast's bf16 copy of a weight)
    is a full-size tensor too, and the backward reads it: this pass tags it
    as well, so that under ZeRO-3 the backward re-gathers and re-casts and
    the forward saves no full-size form of a sharded parameter."""

    def transform_traces_pre_autodiff(self, prologue_trc, computation_trc, *, compile_data=None):
        from ..core.prims import PrimIDs

        gathered = {o.name for b in computation_trc.bound_symbols
                    if OpTags.RECOMPUTE_IN_BACKWARD in b.tags and b.sym.id in (
                        dist_prims.all_gather.id, PrimIDs.SLICE)
                    for o in b.flat_proxy_outs()}
        if not gathered:
            return prologue_trc, computation_trc
        for b in computation_trc.bound_symbols:
            if b.sym.id != PrimIDs.CONVERT_ELEMENT_TYPE:
                continue
            ins = [p.name for p in b.flat_proxy_args()]
            if ins and all(n in gathered for n in ins):
                b.tags.add(OpTags.RECOMPUTE_IN_BACKWARD)
                gathered.update(o.name for o in b.flat_proxy_outs())
        return prologue_trc, computation_trc


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
    import torch.distributed as dist

    group = mesh.group(axis)
    if group is None:
        return
    src = mesh.ranks(axis)[0]
    with torch.no_grad():
        for t in list(tmodule.get_parameters().values()) + list(tmodule.get_buffers().values()):
            dist.broadcast(t.data, src=src, group=group)


def _split_dim(st: ParamStrategy, ndim: int) -> int:
    """The dim a strategy splits: row-parallel weights (out, in) on in, the
    rest on dim 0."""
    return 1 if st.kind == "row" and ndim >= 2 else 0


def pad_rows(t: torch.Tensor, st: ParamStrategy, n: int) -> torch.Tensor:
    """``t`` with dim 0 zero-padded to the next multiple of ``n`` where the
    FSDP strategy ``st`` records an indivisible size (thunder_tpu's
    _place_params)."""
    if st.orig_dim0 is None:
        return t
    return torch.cat([t, t.new_zeros((-(-st.orig_dim0 // n) * n - st.orig_dim0,) + tuple(t.shape[1:]))])


def local_parameter(name: str, full: torch.Tensor, plan: DistPlan) -> torch.Tensor:
    """This rank's stored block of parameter ``name`` from its whole
    tensor: each strategy's split in order, FSDP's indivisible dim 0
    zero-padded first (no communication)."""
    mesh = plan.mesh
    t = full
    for st in plan.param_strategies.get(name, ()):
        if st.kind == "replicate":
            continue
        n = mesh.size(st.axis)
        if st.kind == "shard0":
            t = pad_rows(t, st, n)
        dim = _split_dim(st, t.ndim)
        if t.shape[dim] % n:
            raise ValueError(f"{st.kind}-parallel {name}: dim {dim} ({t.shape[dim]}) is not "
                             f"divisible by the {st.axis!r} world size {n}")
        b = t.shape[dim] // n
        t = t.narrow(dim, mesh.coordinate(st.axis) * b, b)
    return t


def _place_params(tmodule: ThunderModule, plan: DistPlan) -> None:
    """Keep this rank's block of every parameter ``plan`` splits
    (thunder_tpu's _place_params, thunder/distributed/__init__.py:462-546)."""
    with torch.no_grad():
        for name, p in tmodule.get_parameters().items():
            t = local_parameter(name, p.data, plan)
            if t is not p.data:
                p.data = t.clone(memory_format=torch.contiguous_format)


def full_parameter(name: str, t: torch.Tensor, plan: DistPlan) -> torch.Tensor:
    """The whole (unpadded) tensor of parameter ``name`` from this rank's
    block: its strategies undone in reverse order, each split gathered over
    its axis (collective: every rank of the axis calls it)."""
    import torch.distributed as dist

    mesh = plan.mesh
    for st in reversed(plan.param_strategies.get(name, ())):
        group = mesh.group(st.axis)
        if st.kind == "replicate" or group is None:
            continue
        t = t.contiguous()
        blocks = [torch.empty_like(t) for _ in range(mesh.size(st.axis))]
        dist.all_gather(blocks, t, group=group)
        t = torch.cat(blocks, _split_dim(st, t.ndim))
        if st.orig_dim0 is not None:
            t = t[:st.orig_dim0]
    return t


def ddp(tmodule: ThunderModule, mesh: Mesh, *, axis: str = DP_AXIS,
        bucket_mb: Optional[float] = None) -> ThunderModule:
    """Replicated data parallel (reference thunder.distributed.ddp,
    thunder/distributed/__init__.py:203): params replicated over `axis`,
    batch split over it, grads all-reduced (pre-averaged via the loss
    all-reduce's division by the world size).

    ``bucket_mb`` appends GradBucketingTransform: the backward's gradient
    all-reduces become pack -> one all_reduce -> unpack per bucket of that
    many MiB (parallel/bucketing.py), the same sums."""
    plan = _get_plan(tmodule) or DistPlan(mesh)
    new = DistPlan(mesh, {}, (axis,))
    for name in tmodule.get_parameters():
        new.param_strategies[name] = [ParamStrategy("replicate", axis)]
    plan = plan.merge(new)
    _set_plan(tmodule, plan)
    broadcast_replicated(tmodule, mesh, axis)
    add_transform(tmodule, DDPTransform(plan))
    if bucket_mb is not None:
        from .bucketing import GradBucketingTransform

        add_transform(tmodule, GradBucketingTransform(bucket_mb))
    return tmodule


def fsdp(tmodule: ThunderModule, mesh: Mesh, *, axis: str = FSDP_AXIS, min_shard_numel: int = 128,
         zero: int = 3) -> ThunderModule:
    """ZeRO-sharded data parallel (reference thunder.distributed.fsdp,
    thunder/distributed/__init__.py:382): every parameter of at least
    ``min_shard_numel`` elements is split along dim 0 over `axis`, an
    indivisible dim 0 zero-padded to the next multiple first; smaller ones
    stay replicated. After the broadcast from the axis's first rank each
    rank keeps only its block: parameter storage and optimizer state are
    per rank. ``zero=3`` re-gathers the parameters in the backward (the
    forward saves only the shards); ``zero=2`` saves the gathered ones for
    it. Gradients are reduce-scattered either way."""
    if zero not in (2, 3):
        raise ValueError(f"zero must be 2 or 3, got {zero!r}")
    plan = _get_plan(tmodule) or DistPlan(mesh)
    n = axis_size(mesh, axis)
    new = DistPlan(mesh, {}, (axis,))
    for name, p in tmodule.get_parameters().items():
        if p.ndim >= 1 and p.numel() >= min_shard_numel:
            orig = None if p.shape[0] % n == 0 else int(p.shape[0])
            new.param_strategies[name] = [ParamStrategy("shard0", axis, orig_dim0=orig, zero=zero)]
        else:
            new.param_strategies[name] = [ParamStrategy("replicate", axis)]
    plan = plan.merge(new)
    _set_plan(tmodule, plan)
    broadcast_replicated(tmodule, mesh, axis)
    _place_params(tmodule, new)
    add_transform(tmodule, FSDPTransform(plan))
    return tmodule


def apply_param_collectives(params: dict, plan: DistPlan) -> dict:
    """Trace-time: turn rank-local parameter proxies into the whole
    parameters the model computes with, through each one's chain of
    strategies (the analog of the reference's `synchronize` insertion at
    param-use sites, ddp_v2.py:25 / fsdp_v2.py:87). Column and row
    parameters stay local: the tensor-parallel layers consume their shards."""
    from ..core.trace import get_tracectx
    from ..ops import clang

    full = {}
    for k, v in params.items():
        for st in plan.param_strategies.get(k, ()):
            if st.kind == "shard0":
                # ZeRO-3 tags the gather and the unpad slice
                # RECOMPUTE_IN_BACKWARD: the backward re-gathers instead of
                # the forward saving the whole parameter
                trc = get_tracectx()
                scope = trc.scopes[-1] if trc is not None else None
                start = len(scope) if scope is not None else 0
                v = dist_prims.all_gather(v, st.axis, world_size=plan.world_size(st.axis))
                if st.orig_dim0 is not None:
                    v = clang.slice_in_dim(v, 0, st.orig_dim0, 0)
                if st.zero == 3 and scope is not None:
                    for b in scope[start:]:
                        b.tags.add(OpTags.RECOMPUTE_IN_BACKWARD)
            elif st.kind == "replicate":
                v = dist_prims.synchronize(v, st.axis)
        full[k] = v
    return full
