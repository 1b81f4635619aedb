"""User-defined custom operations with optional autodiff.

thunder_tpu/_custom_op.py for the port: users bring a concrete torch
implementation (which may launch a hand-written kernel) plus a shape meta
and an optional VJP, and get a Symbol usable inside traced functions,
claimed by its own operator executor and differentiated through the
trace-level autodiff.

    import thunder_tpu_torch as tt

    @tt.custom_op("mylib.swish4", like=lambda x: x)
    def swish4(x):
        return x * torch.sigmoid(4.0 * x)

    @swish4.register_vjp
    def swish4_vjp(x, g):
        s = torch.sigmoid(4.0 * x)
        return g * (s + 4.0 * x * s * (1 - s))

``like`` gives the output spec: a callable mapping input proxies to an output
proxy/shape-donor proxy (identity for elementwise ops). For full control pass
``meta=`` instead. Implementations run as one call each, on the device of
their tensor arguments; one that reads a tensor on the host cannot run
inside a CUDA graph.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from .core.proxies import TensorProxy
from .core.symbol import Symbol
from .extend import OperatorExecutor, register_executor

# one shared executor hosts all user custom ops (reference custom_op_ex)
custom_op_ex = OperatorExecutor("custom_op")
register_executor(custom_op_ex)


class CustomOp:
    """The object returned by @custom_op: callable symbol + rule hooks."""

    def __init__(self, sym: Symbol, fn: Callable):
        self.sym = sym
        self.fn = fn
        self.__name__ = sym.name

    def __call__(self, *args, **kwargs):
        return self.sym(*args, **kwargs)

    def register_vjp(self, vjp_fn: Callable) -> Callable:
        """vjp_fn(*primal_args, *cotangents) -> grads (one per tensor arg).

        vjp_fn is torch code: it becomes its own custom symbol, claimed by
        the same executor as the forward. Residuals are the primal args."""
        from .transforms.autodiff import VJPResult, register_augmented_forward, register_backward

        sym = self.sym
        vjp_syms: dict[int, Symbol] = {}  # one vjp symbol per call-site arity

        def make_vjp_sym(n_primals: int) -> Symbol:
            bs = vjp_syms.get(n_primals)
            if bs is None:
                def vjp_meta(*args):
                    primals = args[:n_primals]
                    grads = tuple(
                        TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)
                        for a in primals if isinstance(a, TensorProxy)
                    )
                    return grads if len(grads) != 1 else grads[0]

                bs = Symbol(f"{sym.name}_vjp", vjp_meta, id=f"{sym.id}_vjp{n_primals}",
                            is_prim=True, module=sym.module, executor=custom_op_ex)
                custom_op_ex.register_implementation(bs.id, vjp_fn)
                vjp_syms[n_primals] = bs
            return bs

        def aug(*args, **kwargs):
            # arity travels in the residuals so each call site's backward
            # slices primals/cotangents correctly
            return VJPResult(sym(*args, **kwargs), (len(args), *args))

        def bwd(n_primals, *residuals_and_cots):
            return make_vjp_sym(n_primals)(*residuals_and_cots)

        register_augmented_forward(sym.id)(aug)
        register_backward(sym.id)(bwd)
        return vjp_fn

    def register_aug_fwd(self, aug_fn: Callable) -> Callable:
        """Full control: aug_fn(*args) -> VJPResult(out, residuals)."""
        from .transforms.autodiff import register_augmented_forward

        register_augmented_forward(self.sym.id)(aug_fn)
        return aug_fn

    def register_bwd(self, bwd_fn: Callable) -> Callable:
        from .transforms.autodiff import register_backward

        register_backward(self.sym.id)(bwd_fn)
        return bwd_fn


def _meta_from_like(like: Callable) -> Callable:
    def meta(*args, **kwargs):
        donor = like(*args, **kwargs)
        if isinstance(donor, TensorProxy):
            return TensorProxy(shape=donor.shape, dtype=donor.dtype, device=donor.device)
        if isinstance(donor, (tuple, list)):
            return type(donor)(
                TensorProxy(shape=d.shape, dtype=d.dtype, device=d.device) if isinstance(d, TensorProxy) else d
                for d in donor
            )
        return donor

    return meta


def custom_op(qualname: str, *, like: Callable | None = None, meta: Callable | None = None,
              tags: Sequence[str] = ()) -> Callable[[Callable], CustomOp]:
    """Register a torch-implemented custom operation (see module docstring).

    qualname: "namespace.opname" (single names get namespace "custom").
    """
    if (like is None) == (meta is None):
        raise TypeError("custom_op requires exactly one of like= or meta=")
    namespace, _, opname = qualname.rpartition(".")
    namespace = namespace or "custom"
    sym_meta = meta if meta is not None else _meta_from_like(like)

    def deco(fn: Callable) -> CustomOp:
        sym = Symbol(opname, sym_meta, id=qualname if "." in qualname else f"custom.{qualname}",
                     is_prim=True, module=namespace, executor=custom_op_ex, tags=tuple(tags))
        custom_op_ex.register_implementation(sym.id, fn)
        return CustomOp(sym, fn)

    return deco
