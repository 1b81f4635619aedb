"""Derive joint forward+backward traces from registered grad rules.

thunder_tpu/core/vjp_utils.py for the port, over the port's
``augmented_forward_impls`` and ``backward_impls``
(transforms/autodiff.py): given a BoundSymbol whose symbol id has a
registered augmented-forward/backward pair, produce two *traces* — one
computing (outputs, residuals), one computing input grads from
(residuals, cotangents) — so callers (executors, tests, custom transforms)
can inspect or compile the pair independently of the full autodiff pass."""
from __future__ import annotations

from typing import Any, Callable

from .proxies import Proxy, TensorProxy
from .symbol import BoundSymbol
from .trace import TraceCtx, tracectx
from . import prims


def _clone_proxy(p):
    if isinstance(p, TensorProxy):
        return TensorProxy(p.name, shape=p.shape, dtype=p.dtype, device=p.device,
                           requires_grad=p.requires_grad)
    return p


def make_aug_forward_and_backward(bsym: BoundSymbol) -> tuple[Callable, Callable]:
    """Return (aug_fwd_trace_callable, bwd_trace_callable) for a bsym.

    aug_fwd(*args, **kwargs) -> (outputs, residuals)
    bwd(*residuals, *cotangents) -> input grads (one per tensor arg)

    Raises LookupError if no grad rule is registered for the symbol.
    """
    from ..transforms.autodiff import augmented_forward_impls, backward_impls

    aug = augmented_forward_impls.get(bsym.sym.id)
    bwd = backward_impls.get(bsym.sym.id)
    if aug is None or bwd is None:
        raise LookupError(f"no grad rule registered for symbol id {bsym.sym.id!r}")

    # --- augmented forward trace ---
    fwd_trc = TraceCtx(None)
    fwd_trc._name = f"augmented_forward_{_ident(bsym.sym.name)}"
    with tracectx(fwd_trc):
        arg_proxies = tuple(_clone_proxy(a) for a in bsym.args)
        for p in arg_proxies:
            if isinstance(p, Proxy):
                fwd_trc.add_name(p.name)
        fwd_trc.args = tuple(p for p in arg_proxies if isinstance(p, Proxy))
        res = aug(*arg_proxies, **bsym.kwargs)
        prims.python_return((res.out, tuple(res.residuals)))
    residuals = tuple(res.residuals)

    # --- backward trace ---
    bwd_trc = TraceCtx(None)
    bwd_trc._name = f"backward_{_ident(bsym.sym.name)}"
    with tracectx(bwd_trc):
        res_proxies = tuple(_clone_proxy(r) for r in residuals)
        outs = res.out if isinstance(res.out, (tuple, list)) else (res.out,)
        cot_proxies = tuple(
            TensorProxy(f"g{i}", shape=o.shape, dtype=o.dtype, device=o.device)
            if isinstance(o, TensorProxy) else None
            for i, o in enumerate(outs)
        )
        flat_in = [p for p in (*res_proxies, *cot_proxies) if isinstance(p, Proxy)]
        for p in flat_in:
            bwd_trc.add_name(p.name)
        bwd_trc.args = tuple(flat_in)
        cots = [c for c in cot_proxies if c is not None]
        grads = bwd(*res_proxies, *cots)
        prims.python_return(grads if isinstance(grads, tuple) else (grads,))

    return fwd_trc, bwd_trc


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)
