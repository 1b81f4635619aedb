"""Activation checkpointing: recompute a segment in the backward instead of
saving its activations.

thunder_tpu/transforms/remat.py:checkpoint for the port. ``checkpoint(fn)``
traces the segment inline and tags every bound symbol it records
RECOMPUTE_IN_BACKWARD; the autodiff split (transforms/autodiff.py:
_plan_recompute) then saves the segment's external inputs in place of its
tagged residuals and replays the forward subgraph that re-derives them in
the backward, right before the first grad rule that reads one.

thunder_tpu's ``RematTransform`` applies ``jax.checkpoint`` policies to
compiled XLA fusion regions. The port runs every prim as its own torch
call and has no fusion regions yet, so it has no counterpart here: it
comes with CUDA graphs and fusion."""
from __future__ import annotations

from typing import Callable

from ..core.symbol import OpTags
from ..core.trace import get_tracectx


def checkpoint(fn: Callable) -> Callable:
    """Wrap a model segment for recompute-in-backward.

    Usage inside a module's forward: ``h = remat.checkpoint(self.block)(x)``.
    Outside a trace the segment runs as it is."""

    def wrapped(*args, **kwargs):
        trc = get_tracectx()
        if trc is None:
            return fn(*args, **kwargs)
        with trc.push_scope() as scope:
            out = fn(*args, **kwargs)
        for bsym in scope:
            bsym.tags.add(OpTags.RECOMPUTE_IN_BACKWARD)
            trc.add_bound_symbol(bsym)
        return out

    return wrapped
