"""Optimizers over dicts of tensors: global_norm, SGD, AdamW, Adam.

thunder_tpu/optim.py for the port, with the same math and the same state
(AdamW's moments in f32 whatever the parameter dtype). One difference:
thunder_tpu's ``update`` returns new arrays, because jax arrays are
immutable; here ``update`` writes the parameters and the state in place
under ``torch.no_grad()`` (no second copy of the model or its moments) and
returns the same dicts. The step counter is a Python int, so no update reads
a value back from the card. The per-tensor arithmetic is issued as
``torch._foreach_*`` calls: a handful of launches a step instead of several
per parameter."""
from __future__ import annotations

import torch


def global_norm(grads: dict) -> torch.Tensor:
    """L2 norm over every tensor of a gradient dict, accumulated in f32."""
    leaves = [g for g in grads.values() if g is not None]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def _f32(ts: list) -> list:
    return [t if t.dtype == torch.float32 else t.float() for t in ts]


class SGD:
    def __init__(self, lr: float = 0.01, momentum: float = 0.0, weight_decay: float = 0.0):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        if self.momentum == 0.0:
            return {"step": 0}
        return {"step": 0, "momentum_buf": {k: torch.zeros_like(v) for k, v in params.items()}}

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict):
        state["step"] += 1
        keys = [k for k in params if grads.get(k) is not None]
        if not keys:
            return params, state
        ps = [params[k] for k in keys]
        gs = [grads[k] for k in keys]
        if self.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        if self.momentum != 0.0:
            bufs = [state["momentum_buf"][k] for k in keys]
            torch._foreach_mul_(bufs, self.momentum)
            torch._foreach_add_(bufs, gs)
            gs = bufs
        torch._foreach_add_(ps, gs, alpha=-self.lr)
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
            "step": 0,
            "m": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in params.items()},
            "v": {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in params.items()},
        }

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict):
        state["step"] += 1
        t = state["step"]
        bc1 = 1.0 - self.beta1 ** t
        bc2 = 1.0 - self.beta2 ** t
        keys = [k for k in params if grads.get(k) is not None]
        if not keys:
            return params, state
        ps = [params[k] for k in keys]
        gs = _f32([grads[k] for k in keys])
        ms = [state["m"][k] for k in keys]
        vs = [state["v"][k] for k in keys]
        # m = b1*m + (1-b1)*g ; v = b2*v + (1-b2)*g*g
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, gs, alpha=1.0 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - self.beta2)
        # upd = (m / bc1) / (sqrt(v / bc2) + eps)
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_div_(upd, denom)
        p32 = _f32(ps)
        if self.weight_decay:
            # p - lr*wd*p
            torch._foreach_add_(p32, torch._foreach_mul(p32, self.lr * self.weight_decay), alpha=-1.0)
        torch._foreach_add_(p32, upd, alpha=-self.lr)
        for p, q in zip(ps, p32):
            if q is not p:
                p.copy_(q)
        return params, state


class Adam(AdamW):
    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(lr, betas, eps, weight_decay=0.0)
