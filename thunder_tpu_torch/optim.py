"""Optimizers over dicts of tensors: global_norm, SGD, AdamW, Adam.

thunder_tpu/optim.py for the port, with the same math and the same state
(AdamW's moments in f32 whatever the parameter dtype). One difference:
thunder_tpu's ``update`` returns new arrays, because jax arrays are
immutable; here ``update`` writes the parameters and the state in place
under ``torch.no_grad()`` (no second copy of the model or its moments) and
returns the same dicts. The step counter is a 0-d int32 tensor on the
parameters' device, as thunder_tpu keeps it: an update increments it there
and AdamW takes its bias corrections from it in f32, so no update reads a
value back from the card and a captured CUDA graph (TrainStep) replays
every step with its own corrections. SGD issues ``torch._foreach_*`` calls;
AdamW's update is executors/cudaex.py's ``adamw_update``: one launch of the
hand-written csrc/adamw.cu on a card, its plain version (the
``torch._foreach_*`` chain) on the CPU.

A guarded step (TrainStep(guard=...)) passes ``update`` a skip flag,
``finite``: a 0-d int32 tensor on the parameters' device, 1 when the step's
loss and gradient norm are finite. thunder_tpu gates its functional update
with ``where(finite, new, old)`` over parameters and state; here the writes
are in place, so the gate is inside them: the step counter advances by
``finite`` (so later bias corrections match thunder_tpu's), AdamW's kernel
reads the flag and writes nothing at 0, and SGD writes ``where(finite, new,
old)`` into its parameters and momentum. No update reads the flag on the
host."""
from __future__ import annotations

import torch

from .executors import cudaex


def _step0(params: dict) -> torch.Tensor:
    """A step counter at 0 on the parameters' device."""
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def global_norm(grads: dict) -> torch.Tensor:
    """L2 norm over every tensor of a gradient dict, accumulated in f32: one
    ``torch._foreach_norm`` pass over the gradients (no squared copies), then
    the norm of the per-tensor norms."""
    leaves = [g if g.dtype == torch.float32 else g.float() for g in grads.values() if g is not None]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))


def _advance(state: dict, finite) -> None:
    """The step counter moves by one, or by the skip flag of a guarded step."""
    state["step"].add_(1 if finite is None else finite)


class SGD:
    def __init__(self, lr: float = 0.01, momentum: float = 0.0, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        if self.momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params), "momentum_buf": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict, finite=None):
        _advance(state, finite)
        keys = [k for k in params if grads.get(k) is not None]
        if not keys:
            return params, state
        ps = [params[k] for k in keys]
        gs = [grads[k] for k in keys]
        if self.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        if finite is None:
            if self.momentum != 0.0:
                bufs = [state["momentum_buf"][k] for k in keys]
                torch._foreach_mul_(bufs, self.momentum)
                torch._foreach_add_(bufs, gs)
                gs = bufs
            torch._foreach_add_(ps, gs, alpha=-self.lr)
            return params, state
        # guarded: the same values into scratch, written where finite
        keep = finite.bool()
        if self.momentum != 0.0:
            bufs = [state["momentum_buf"][k] for k in keys]
            new = torch._foreach_mul(bufs, self.momentum)
            torch._foreach_add_(new, gs)
            for b, n in zip(bufs, new):
                b.copy_(torch.where(keep, n, b))
            gs = new
        for p, n in zip(ps, torch._foreach_add(ps, gs, alpha=-self.lr)):
            p.copy_(torch.where(keep, n, p))
        return params, state


class AdamW:
    """Decoupled weight decay Adam; state in f32 regardless of param dtype."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        return {
            "step": _step0(params),
            "m": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in params.items()},
            "v": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in params.items()},
        }

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict, finite=None):
        _advance(state, finite)
        keys = [k for k in params if grads.get(k) is not None]
        cudaex.adamw_update([params[k] for k in keys], [grads[k] for k in keys],
                            [state["m"][k] for k in keys], [state["v"][k] for k in keys],
                            lr=self.lr, beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                            weight_decay=self.weight_decay, step=state["step"], finite=finite)
        return params, state


class Adam(AdamW):
    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(lr, betas, eps, weight_decay=0.0)
