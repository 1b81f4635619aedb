"""Tensor parallelism: Megatron-style column/row parallel layers.

thunder_tpu/parallel/tensor_parallel.py for the port (reference
thunder/distributed/tensor_parallel/column_wise.py:154, row_wise.py:159):
target Linear/Embedding modules are replaced with parallel variants whose
forwards record the tensor-parallel sync prims, so the trace holds local
matmuls and the boundary collectives over the `tp` axis.

  column: weight (out, in) split on out; input synced (bwd all-reduce);
          output stays column-split.
  row:    weight (out, in) split on in; consumes column-split input;
          output all-reduced (fwd all-reduce / bwd identity); bias added after.

Each rank keeps only its block of a column or row weight (and of a column
bias): the parameters of the replaced module, re-split in place after the
broadcast from the axis's first rank. Tensor parallelism does not split the
batch: every rank of the axis takes the whole of it."""
from __future__ import annotations

from typing import Sequence

from .. import nn
from ..nn.module import Module, ThunderModule
from ..ops import ltorch
from . import prims as dist_prims
from .mesh import TP_AXIS, Mesh, axis_size
from .transforms import (DistPlan, ParamStrategy, _get_plan, _place_params, _set_plan,
                         broadcast_replicated)


class ColumnParallelLinear(Module):
    def __init__(self, orig: nn.Linear, axis: str, tp_size: int):
        super().__init__()
        if orig.out_features % tp_size:
            raise ValueError(f"column-parallel out_features {orig.out_features} % tp={tp_size}")
        self.in_features, self.out_features = orig.in_features, orig.out_features
        self.weight = orig.weight
        self.bias = orig.bias
        self.axis = axis

    def forward(self, x):
        x = dist_prims.synchronize_tensor_parallel_input(x, self.axis)
        return ltorch.linear(x, self.weight, self.bias)


class RowParallelLinear(Module):
    def __init__(self, orig: nn.Linear, axis: str, tp_size: int):
        super().__init__()
        if orig.in_features % tp_size:
            raise ValueError(f"row-parallel in_features {orig.in_features} % tp={tp_size}")
        self.in_features, self.out_features = orig.in_features, orig.out_features
        self.weight = orig.weight
        self.bias = orig.bias
        self.axis = axis

    def forward(self, x):
        y = ltorch.linear(x, self.weight, None)
        y = dist_prims.synchronize_tensor_parallel_output(y, self.axis)
        if self.bias is not None:
            y = y + self.bias
        return y


class VocabParallelEmbedding(Module):
    """Embedding split on the embedding (feature) dim: its output is
    column-split. The weight (V, D) is split on dim 1, which the plan
    records as the kind 'row' (the kind that splits dim 1)."""

    def __init__(self, orig: nn.Embedding, axis: str, tp_size: int):
        super().__init__()
        if orig.embedding_dim % tp_size:
            raise ValueError(f"embedding_dim {orig.embedding_dim} % tp={tp_size}")
        self.num_embeddings, self.embedding_dim = orig.num_embeddings, orig.embedding_dim
        self.weight = orig.weight
        self.axis = axis

    def forward(self, idx):
        return ltorch.embedding(idx, self.weight)


def _submodule(root: Module, qualname: str) -> Module:
    mod = root
    for p in qualname.split("."):
        mod = mod._modules[p]
    return mod


def _replace_module(root: Module, qualname: str, new: Module) -> None:
    parent, _, leaf = qualname.rpartition(".")
    (_submodule(root, parent) if parent else root)._modules[leaf] = new


def column_parallel(tmodule: ThunderModule, mesh: Mesh, target_modules: Sequence[str],
                    *, axis: str = TP_AXIS) -> ThunderModule:
    """Reference thunder/distributed/tensor_parallel/column_wise.py:154."""
    return _tp_apply(tmodule, mesh, target_modules, axis, "column")


def row_parallel(tmodule: ThunderModule, mesh: Mesh, target_modules: Sequence[str],
                 *, axis: str = TP_AXIS) -> ThunderModule:
    """Reference thunder/distributed/tensor_parallel/row_wise.py:159."""
    return _tp_apply(tmodule, mesh, target_modules, axis, "row")


def _tp_apply(tmodule: ThunderModule, mesh: Mesh, targets: Sequence[str], axis: str,
              kind: str) -> ThunderModule:
    n = axis_size(mesh, axis)
    root = tmodule.module
    plan = _get_plan(tmodule) or DistPlan(mesh)
    new_plan = DistPlan(mesh, {}, (), tp_axis=axis)
    if plan.tp_axis is None:
        broadcast_replicated(tmodule, mesh, axis)
    for qual in targets:
        mod = _submodule(root, qual)
        if isinstance(mod, (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)):
            raise ValueError(f"{qual} already tensor-parallel")
        if isinstance(mod, nn.Linear):
            new = ColumnParallelLinear(mod, axis, n) if kind == "column" else RowParallelLinear(mod, axis, n)
        elif isinstance(mod, nn.Embedding) and kind == "column":
            new = VocabParallelEmbedding(mod, axis, n)
        else:
            raise TypeError(f"cannot {kind}-parallelize {type(mod).__name__} at {qual}")
        _replace_module(root, qual, new)
        wkind = "row" if isinstance(new, VocabParallelEmbedding) else kind
        new_plan.param_strategies[f"{qual}.weight"] = [ParamStrategy(wkind, axis)]
        if kind == "column" and getattr(new, "bias", None) is not None:
            new_plan.param_strategies[f"{qual}.bias"] = [ParamStrategy("column", axis)]
        # a row-parallel bias stays whole: it is added after the all-reduce
    _set_plan(tmodule, plan.merge(new_plan))
    _place_params(tmodule, new_plan)
    return tmodule
