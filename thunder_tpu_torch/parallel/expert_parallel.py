"""Expert parallelism: Mixtral-style MoE dispatch over a mesh axis.

thunder_tpu/parallel/expert_parallel.py for the port (capability slot of
reference thunder/tests/distributed/test_moe.py:29-144):

- tokens are split over the ``ep`` axis (and, with ``dp_axis``, over a
  data-parallel axis too); each rank holds the experts of its ``ep``
  coordinate, the expert-stacked panels (E, ...) split on dim 0;
- dispatch packs the rank's tokens into per-expert capacity bins and
  exchanges them with one ``all_to_all`` over the axis (NCCL's
  ``all_to_all_single``);
- each rank runs its local experts as one ``ltorch.grouped_mlp`` over
  their received rows, which the cuda executor claims with the grouped
  expert kernel (csrc/grouped_mlp.cu), its ``group_sizes`` the rows that
  hold tokens, so the kernel skips the empty capacity slots. Over more
  than one rank a third, small ``all_to_all`` carries each sender's live
  counts, and the received rows are compacted so that each expert's live
  rows come first (thunder_tpu's bins run every slot through its experts);
- a second ``all_to_all`` returns the expert outputs, and the weighted
  combine runs where the tokens live.

The function is written in ltorch and the collective prims, so it traces
under ``jit`` and differentiates through ``value_and_grad``: the grad rule
of ``all_to_all`` is the inverse exchange. Every shape is static (capacity
bins).

Per rank, as thunder_tpu's shard_map body sees it: ``x`` is the rank's
(n_loc, D) tokens, ``params["gate_w"]`` the whole (D, E) router,
``params["w_gate"]``/``["w_up"]`` the rank's (E/n, D, H) panels and
``params["w_down"]`` its (E/n, H, D) ones. The router's gradient comes
back summed over every token axis and the panels' over ``dp_axis`` (a
``synchronize`` marker on each), as thunder_tpu's shard_map transposes
its replicated inputs."""
from __future__ import annotations

import math
from typing import Optional

from ..core import dtypes
from ..ops import ltorch
from . import prims as dist_prims


def _dispatch_bins(x, topk_idx, n_expert: int, cap: int):
    """Pack the tokens into per-expert capacity bins (thunder_tpu's
    _dispatch_bins): the k-th choice of token t takes the next free slot of
    its expert in (token, k) order; one past the capacity it is dropped.
    -> (bins (E, cap, D), flat_e, keep, idx, live): ``idx`` (N*K, D) is
    each assignment's row in the flattened bins (E*cap for a dropped one:
    the zero row the combine reads), ``live`` (E,) the rows each bin
    fills."""
    N, D = x.shape
    K = topk_idx.shape[1]
    flat_e = ltorch.reshape(topk_idx, (N * K,))
    oh = ltorch.one_hot(flat_e, n_expert)  # (N*K, E)
    rank = ltorch.squeeze(ltorch.take_along_dim(ltorch.cumsum(oh, 0), ltorch.unsqueeze(flat_e, 1), 1), 1) - 1
    keep = rank < cap
    live = ltorch.clamp(ltorch.sum(oh, 0), max=cap)
    trash = n_expert * cap
    slot = ltorch.where(keep, flat_e * cap + rank, trash)
    xk = ltorch.reshape(ltorch.expand(ltorch.unsqueeze(x, 1), (N, K, D)), (N * K, D))
    idx = ltorch.expand(ltorch.unsqueeze(slot, 1), (N * K, D))
    bins = ltorch.scatter_add(ltorch.full((trash + 1, D), 0.0, dtype=x.dtype, device=x.device), 0, idx, xk)
    return ltorch.reshape(bins[:trash], (n_expert, cap, D)), flat_e, keep, idx, live


def _compact(rows, live_recv, cap: int):
    """Bring each local expert's live rows to the front: rows (e_loc, n*cap,
    D) hold, sender by sender, ``cap`` slots of which the first
    live_recv[j, e] hold tokens. -> (compacted rows, the permutation's
    index (e_loc, n*cap, D) for take_along_dim back, live rows (e_loc,))."""
    e_loc, nc, D = rows.shape
    n = nc // cap
    c = ltorch.unsqueeze(ltorch.permute(live_recv, (1, 0)), 2)  # (e_loc, n, 1)
    prefix = ltorch.cumsum(c, 1) - c  # live rows of the senders before j
    total = ltorch.sum(c, 1, keepdim=True)  # (e_loc, 1, 1)
    s = ltorch.reshape(ltorch.arange(cap, device=rows.device, dtype=c.dtype), (1, 1, cap))
    r = ltorch.reshape(ltorch.arange(nc, device=rows.device, dtype=c.dtype), (1, n, cap))
    is_live = s < c
    # live rows go to prefix + s; dead ones after every live row, in order
    pos = ltorch.where(is_live, prefix + s, total + r - prefix - ltorch.minimum(s, c))
    pidx = ltorch.expand(ltorch.unsqueeze(ltorch.reshape(pos, (e_loc, nc)), 2), (e_loc, nc, D))
    compact = ltorch.scatter_add(ltorch.full((e_loc, nc, D), 0.0, dtype=rows.dtype, device=rows.device),
                                 1, pidx, rows)
    return compact, pidx, ltorch.reshape(total, (e_loc,))


def moe_ep_forward(params: dict, x, *, mesh, axis: str = "ep", dp_axis: Optional[str] = None,
                   n_expert_per_token: int = 2, capacity_factor: Optional[float] = None,
                   return_stats: bool = False):
    """A Mixtral-style MoE layer with its experts and tokens split over
    ``axis`` (thunder_tpu's moe_ep_forward, one rank's view: see the module
    docstring). Returns the rank's (n_loc, D) outputs.

    Capacity: drop-free by default, ``n_loc·K`` slots a bin (every local
    assignment fits even if all pick one expert, so the result equals the
    one-rank run); ``capacity_factor`` gives ``ceil(n_loc·K/E·cf)`` slots,
    and assignments past them are dropped (their combine weight is 0).

    With ``return_stats`` the routing-health gauges ride along, summed over
    every token axis: ``expert_load`` (E,) as fractions, ``dropped_tokens``
    and ``router_entropy`` (the mean over all tokens)."""
    n = mesh.size(axis)
    token_axes = (axis,) if dp_axis is None else (dp_axis, axis)
    gate_w = params["gate_w"]
    E = gate_w.shape[1]
    e_loc = params["w_gate"].shape[0]
    if e_loc * n != E:
        raise ValueError(f"experts {E} must divide over {axis}={n}: this rank holds {e_loc}")
    K = n_expert_per_token
    n_loc, D = x.shape
    cap = n_loc * K if capacity_factor is None else int(math.ceil(n_loc * K / E * capacity_factor))
    # gradients of replicated inputs are summed over the axes they are
    # replicated on
    gate_w = dist_prims.synchronize(gate_w, token_axes)
    panels = [params[k] for k in ("w_gate", "w_up", "w_down")]
    if dp_axis is not None:
        panels = [dist_prims.synchronize(w, dp_axis) for w in panels]

    probs = ltorch.softmax(ltorch.matmul(x, gate_w), -1)  # (n_loc, E)
    topk_probs, topk_idx = ltorch.topk(probs, K, -1)
    topk_probs = topk_probs / ltorch.sum(topk_probs, -1, keepdim=True)
    bins, flat_e, keep, idx, live = _dispatch_bins(x, topk_idx, E, cap)
    # exchange: bins split by their experts' owner; every rank receives
    # (n, e_loc, cap, D), each sender's bins for its own experts
    recv = dist_prims.all_to_all(ltorch.reshape(bins, (n, e_loc, cap, D)), axis, 0, 0, world_size=n)
    if n == 1:
        y = ltorch.grouped_mlp(ltorch.reshape(recv, (e_loc, cap, D)), *panels, live)
        back = ltorch.reshape(y, (1, e_loc, cap, D))
    else:
        live_recv = dist_prims.all_to_all(ltorch.reshape(live, (n, e_loc)), axis, 0, 0, world_size=n)
        rows = ltorch.reshape(ltorch.permute(recv, (1, 0, 2, 3)), (e_loc, n * cap, D))
        compact, pidx, total = _compact(rows, live_recv, cap)
        y = ltorch.take_along_dim(ltorch.grouped_mlp(compact, *panels, total), pidx, 1)
        back = ltorch.permute(ltorch.reshape(y, (e_loc, n, cap, D)), (1, 0, 2, 3))
    # return trip: each sender's rows back home, in the bins' layout
    expert_out = ltorch.reshape(dist_prims.all_to_all(back, axis, 0, 0, world_size=n), (E * cap, D))
    y_flat = ltorch.cat([expert_out, ltorch.full((1, D), 0.0, dtype=x.dtype, device=x.device)], 0)
    picked = ltorch.take_along_dim(y_flat, idx, 0)  # (n_loc*K, D)
    w = ltorch.reshape(topk_probs, (n_loc * K,)) * keep.to(probs.dtype)
    out = ltorch.sum(ltorch.reshape(picked * ltorch.unsqueeze(w, 1), (n_loc, K, D)), 1)
    if not return_stats:
        return out
    load = ltorch.sum(ltorch.to(ltorch.one_hot(flat_e, E), dtype=dtypes.float32), 0)
    dropped = ltorch.sum(1.0 - ltorch.to(keep, dtype=dtypes.float32))
    ent = -ltorch.sum(probs * ltorch.log(ltorch.clamp(probs, min=1e-30)))
    load, dropped, ent = (dist_prims.all_reduce(t, token_axes) for t in (load, dropped, ent))
    n_tokens = n_loc * mesh.size(token_axes)
    return out, {"expert_load": load / ltorch.sum(load), "dropped_tokens": dropped,
                 "router_entropy": ent / n_tokens}
