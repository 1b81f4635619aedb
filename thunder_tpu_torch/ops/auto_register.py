"""Auto-registered ops: torch callables as opaque single-op symbols.

thunder_tpu/ops/auto_register.py for the port. thunder_tpu registers each
catalog entry as a symbol whose meta comes from ``jax.eval_shape`` over the
proxies, whose implementation is a jax function on jaxex, and whose gradient
is the generic ``jax.vjp`` fallback. Here the design is PyTorch's own:

* the implementation is the torch callable itself, run by torchex on the
  tensors' device;
* the meta runs that callable on ``device="meta"`` tensors of the proxies'
  shapes and dtypes;
* the gradient of a differentiable op is ``torch.func.vjp`` of the callable,
  recorded in the backward trace as the ``torch.auto_vjp`` operator; a
  non-differentiable op passes no gradient.

An op whose output shape depends on its data fails on the meta tensors, at
trace time; one that syncs with the host raises under CUDA-graph capture as
any op does. The catalog (ops/auto_catalog_ext.py) binds thunder_tpu's
catalog names to the torch functions of those names; the torch frontend's
unmapped-op fallback (interop/torch_frontend.py) makes its ops here too."""
from __future__ import annotations

from typing import Callable

import torch

from ..core import devices, dtypes
from ..core.codeutils import flat_proxies
from ..core.proxies import NumberProxy, TensorProxy, pyval, trace_device
from ..core.pytree import tree_flatten, tree_unflatten
from ..core.symbol import Symbol

AUTO_REGISTERED = "auto_registered"

_auto_symbols: dict[str, Symbol] = {}
_auto_fns: dict[str, Callable] = {}
_differentiable: dict[str, bool] = {}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_structure(x, leaf_fn):
    if _is_namedtuple(x):
        # torch.return_types results (median, aminmax, slogdet, ...) are
        # positional in a trace
        return tuple(_map_structure(e, leaf_fn) for e in x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map_structure(e, leaf_fn) for e in x)
    if isinstance(x, dict):
        return {k: _map_structure(v, leaf_fn) for k, v in x.items()}
    return leaf_fn(x)


def _tensor_proxies(x) -> list:
    """The tensor proxies in x, in the order autodiff lists a rule's inputs."""
    return [p for p in flat_proxies(x) if isinstance(p, TensorProxy)]


def _find_device(args):
    """The device of the first tensor proxy in args, else None."""
    ps = _tensor_proxies(args)
    return ps[0].device if ps else None


def _torch_static(x):
    """A trace's static argument as torch takes it: the port's dtypes and
    devices become torch's, static numbers their values."""
    if isinstance(x, dtypes.dtype):
        return dtypes.to_torch_dtype(x)
    if isinstance(x, devices.Device):
        return x.torch_device()
    if isinstance(x, NumberProxy):
        return pyval(x)
    return x


def _call(fn, args, kwargs):
    """fn on (args, kwargs) whose static leaves are made torch's."""
    return fn(*_map_structure(list(args), _torch_static), **_map_structure(dict(kwargs), _torch_static))


def register_auto_op(name: str, fn: Callable, *, differentiable: bool = True, sym_id: str | None = None,
                     module: str = "auto") -> Symbol:
    """Create and register an opaque single-op symbol for a torch callable
    (thunder_tpu/ops/auto_register.py:register_auto_op)."""
    from ..executors import torchex
    from ..transforms import autodiff

    sym_id = sym_id or f"auto.{name}"
    # whether fn takes ``device=``: asked of an op with no tensor argument (a
    # window, a frequency grid, tril_indices), which must make its output on
    # the program's device
    takes_device: list = []

    def meta(*args, **kwargs):
        if kwargs.get("out") is not None:
            raise NotImplementedError(
                f"{sym_id}(..., out=): a program cannot honor out= aliasing; use the result")
        device = _find_device((args, kwargs))

        def to_meta(x):
            if isinstance(x, TensorProxy):
                return torch.empty(tuple(x.shape), dtype=dtypes.to_torch_dtype(x.dtype), device="meta")
            return x

        margs, mkwargs = _map_structure(list(args), to_meta), _map_structure(dict(kwargs), to_meta)
        out = None
        if device is None and "device" not in kwargs and takes_device != [False]:
            try:
                out = _call(fn, margs, {**mkwargs, "device": torch.device("meta")})
                takes_device[:] = [True]
            except TypeError:
                takes_device[:] = [False]
        if out is None:
            out = _call(fn, margs, mkwargs)
        out_device = device if device is not None else trace_device()

        def to_proxy(x):
            if isinstance(x, torch.Tensor):
                return TensorProxy(shape=tuple(x.shape), dtype=dtypes.to_dtype(x.dtype), device=out_device)
            return x

        return _map_structure(out, to_proxy)

    def record_device(bsym) -> None:
        if takes_device == [True] and "device" not in bsym.kwargs and not _tensor_proxies(
                (bsym.args, bsym.kwargs)):
            bsym.kwargs["device"] = _tensor_proxies(bsym.output)[0].device

    meta.__name__ = name
    sym = Symbol(name, meta, id=sym_id, is_prim=True, module=module, tags=(AUTO_REGISTERED,),
                 _bind_postprocess=record_device)
    _auto_symbols[sym_id] = sym
    _auto_fns[sym_id] = fn
    _differentiable[sym_id] = differentiable
    torchex.ex.register_implementation(sym_id, lambda *a, **k: _call(fn, a, k))
    if differentiable:
        autodiff.register_grad(sym_id, _vjp_aug(sym), _vjp_bwd(sym_id))
    else:
        autodiff.register_grad(sym_id, lambda *a, **k: autodiff.VJPResult(sym(*a, **k), ()), lambda *cots: ())
    return sym


# ---------------------------------------------------------------------------
# gradients: torch.func.vjp of the callable, inside the backward trace
# ---------------------------------------------------------------------------


def _vjp_aug(sym):
    from ..transforms.autodiff import VJPResult

    def aug(*args, **kwargs):
        return VJPResult(sym(*args, **kwargs), (args, kwargs))

    return aug


def _vjp_bwd(sym_id: str):
    def bwd(args, kwargs, *cots):
        ins = _tensor_proxies((args, kwargs))
        wanted = [p for p in ins if p.dtype.is_inexact]
        grads = iter(auto_vjp(sym_id, args, kwargs, tuple(cots)) if wanted else ())
        return tuple(next(grads) if p.dtype.is_inexact else None for p in ins)

    return bwd


def _auto_vjp_meta(sym_id, args, kwargs, cots):
    return tuple(TensorProxy(shape=p.shape, dtype=p.dtype, device=p.device)
                 for p in _tensor_proxies((args, kwargs)) if p.dtype.is_inexact)


def _auto_vjp_impl(sym_id, args, kwargs, cots):
    """The gradients of an auto op's float tensor arguments: torch.func.vjp
    of its callable at (args, kwargs), with ``cots`` for its float outputs in
    order (the cotangents autodiff hands a rule)."""
    fn = _auto_fns[sym_id]
    flat, spec = tree_flatten((args, kwargs))
    is_float = [isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex()) for x in flat]

    def of_floats(*fts):
        it = iter(fts)
        a, k = tree_unflatten([next(it) if m else x for x, m in zip(flat, is_float)], spec)
        outs = [o for o in tree_flatten(_map_structure(_call(fn, a, k), lambda x: x))[0]
                if isinstance(o, torch.Tensor) and (o.is_floating_point() or o.is_complex())]
        return tuple(outs)

    with torch.enable_grad():
        _, vjp_fn = torch.func.vjp(of_floats, *[x for x, m in zip(flat, is_float) if m])
        grads = vjp_fn(tuple(cots))
    return tuple(grads)


def _register_vjp_operator():
    from ..executors import torchex

    return torchex.ex.register_operator("auto_vjp", meta=_auto_vjp_meta, fn=_auto_vjp_impl)


auto_vjp = _register_vjp_operator()


def get_auto_symbol(name: str) -> Symbol | None:
    return _auto_symbols.get(f"auto.{name}")


def auto_function(sym: Symbol) -> Callable:
    """The torch callable an auto op runs."""
    return _auto_fns[sym.id]


def is_differentiable(sym: Symbol) -> bool:
    return _differentiable[sym.id]


def list_auto_ops() -> list[str]:
    """The catalog's auto ops, by name."""
    return sorted(s.name for i, s in _auto_symbols.items() if i == f"auto.{s.name}")


def register_catalog() -> int:
    """Bind every catalog entry that names a torch function
    (ops/auto_catalog_ext.py) and return how many auto ops there are."""
    from .auto_catalog_ext import catalog

    for name, (fn, differentiable) in catalog().items():
        if f"auto.{name}" not in _auto_symbols:
            register_auto_op(name, fn, differentiable=differentiable)
    return len(list_auto_ops())


register_catalog()
