"""thunder_tpu_torch: the PyTorch/CUDA port of thunder_tpu.

The same trace compiler — programs acquired by proxy tracing into the
printable trace IR, claimed by a prioritized executor list, compiled into
python callables — with torch tensors as runtime values and CUDA as the
device. Executors, in claim order: ``cuda`` (hand-written Hopper kernels,
executors/cudaex.py), then ``torch`` (one torch call per prim,
executors/torchex.py; the always-executor).

The serving slice brought ``jit`` and ``last_traces`` here, ``nn``,
``models.litgpt``, ``inference`` and ``serving``; the training slice brings
``value_and_grad``/``grad`` (transforms/autodiff.py), ``AutocastTransform``
(transforms/autocast.py), ``jit(module, transforms=...)`` returning a
``ThunderModule``, ``optim`` and ``training.TrainStep``; the distributed
slice brings ``parallel`` (a mesh over torch.distributed process groups,
``ddp`` and ring-attention ``context_parallel``). A program runs where
its tensor inputs live; model and engine constructors take ``device`` and
default to the card (raising when there is none).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .core import dtypes, devices, prims
from .core.dtypes import *  # noqa: F401,F403 — re-export dtype names
from .core.proxies import Proxy, TensorProxy, proxy_from_torch
from .core.pytree import tree_flatten, tree_unflatten
from .core.trace import TraceCtx, tracectx
from .core.transform_common import cse, dce
from .common import CacheEntry, CompileData, CompileStats, apply_effects
from .extend import get_default_executors, resolve_executors, set_default_executors

# importing executors registers them
from .executors import torchex  # noqa: E402
from .executors import cudaex  # noqa: E402
from .ops import ltorch  # noqa: E402  (registers tensor methods)
from .ops import clang  # noqa: E402

set_default_executors([cudaex.ex])

__version__ = "0.1.0"


# ---------------------------------------------------------------------------
# trace acquisition (direct proxy tracing)
# ---------------------------------------------------------------------------


def _is_tensor_like(x) -> bool:
    return isinstance(x, torch.Tensor)


def acquire_trace(fn: Callable, args, kwargs, grad_mask: Sequence[bool] | None = None) -> TraceCtx:
    """Trace fn by calling it with proxies for its tensor leaves. The
    trace's device is its first tensor input's. ``grad_mask`` (one flag per
    leaf) marks the proxies autodiff differentiates. When fn writes buffers
    (nn.update_buffer), the trace returns ``(result, effect values)``, the
    values in the order of ``trace.side_effects``."""
    leaves, treedef = tree_flatten((args, kwargs))
    trc = TraceCtx(fn)
    tensor_mask = [_is_tensor_like(leaf) for leaf in leaves]
    grad_mask = grad_mask or [False] * len(leaves)
    first = next((leaf for leaf, m in zip(leaves, tensor_mask) if m), None)
    if first is not None:
        trc.device = devices.to_device(first.device)
    with tracectx(trc):
        proxy_leaves = [proxy_from_torch(leaf, requires_grad=g) if m else leaf
                        for leaf, m, g in zip(leaves, tensor_mask, grad_mask)]
        trc.args = tuple(p for p, m in zip(proxy_leaves, tensor_mask) if m)
        pargs, pkwargs = tree_unflatten(proxy_leaves, treedef)
        result = fn(*pargs, **pkwargs)
        if trc.side_effects:
            prims.python_return((result, tuple(p for _, _, p in trc.side_effects)))
        else:
            prims.python_return(result)
    return trc


def build_prologue(trc: TraceCtx) -> TraceCtx:
    """Prologue trace validating inputs: a cache hit is a prologue that runs
    without raising."""
    pro = TraceCtx(None, prologue=True)
    pro._name = "prologue"
    with tracectx(pro):
        arg_proxies = []
        for p in trc.args:
            q = TensorProxy(p.name, shape=p.shape, dtype=p.dtype, device=p.device)
            arg_proxies.append(q)
            prims.check_tensor_shape_and_metadata(q, p.shape, p.dtype, str(p.device))
        pro.args = tuple(arg_proxies)
        prims.python_return(tuple(arg_proxies))
    return pro


def _alias_groups(leaves, tensor_mask) -> tuple:
    """Index groups of tensor leaves that share storage: () when all are
    distinct (the common case), so a call with another aliasing structure
    gets its own specialization."""
    by_store: dict = {}
    ti = 0
    for leaf, is_t in zip(leaves, tensor_mask):
        if is_t:
            by_store.setdefault(leaf.untyped_storage().data_ptr(), []).append(ti)
            ti += 1
    return tuple(tuple(g) for g in by_store.values() if len(g) > 1)


def _cache_key(leaves, tensor_mask) -> tuple:
    """Tensors key on (shape, dtype, device), never on values: a 0-d int32
    position is one specialization for every position. Other leaves key on
    their value."""
    key = []
    for leaf, is_t in zip(leaves, tensor_mask):
        if is_t:
            key.append(("T", tuple(leaf.shape), leaf.dtype, leaf.device))
        else:
            try:
                hash(leaf)
                key.append(("S", leaf))
            except TypeError:
                key.append(("S", repr(leaf)))
    groups = _alias_groups(leaves, tensor_mask)
    if groups:
        key.append(("aliases", groups))
    return tuple(key)


class ThunderCompiledFunction:
    """The callable returned by jit(). A program that writes buffers returns
    their new values beside its result; the call replays them onto their
    owners (common.py:apply_effects)."""

    def __init__(self, cd: CompileData):
        self._cd = cd
        self._cs = CompileStats()
        self._cache: dict = {}
        fn = cd.fn
        self.__name__ = getattr(fn, "__name__", type(fn).__name__)

    def _compile(self, args, kwargs, key) -> CacheEntry:
        from .executors.passes import transform_for_execution

        cs = self._cs
        trc = acquire_trace(self._cd.fn, args, kwargs)
        pro = build_prologue(trc)
        traces = [trc]
        for tf in self._cd.transforms:
            pro, trc = tf.transform_traces_pre_autodiff(pro, trc, compile_data=self._cd)
            traces.append(trc)
        dce_trc = dce(trc)
        ex_trc = transform_for_execution(dce_trc, self._cd.executors or get_default_executors())
        for tf in self._cd.transforms:
            ex_trc = tf.transform_trace_post_optimization(ex_trc, compile_data=self._cd)
        cs.last_traces = traces + [dce_trc, ex_trc]
        cs.last_prologue_traces = [pro]
        entry = CacheEntry(prologue_fn=pro.python_callable(),
                           computation_fn=ex_trc.python_callable(),
                           effect_keys=tuple((owner, name) for owner, name, _ in trc.side_effects))
        self._cache[key] = entry
        return entry

    def __call__(self, *args, **kwargs):
        cs = self._cs
        leaves, _ = tree_flatten((args, kwargs))
        tensor_mask = [_is_tensor_like(leaf) for leaf in leaves]
        key = _cache_key(leaves, tensor_mask)
        entry = self._cache.get(key)
        if entry is None:
            cs.cache_misses.add()
            entry = self._compile(args, kwargs, key)
        else:
            cs.cache_hits.add()
        with torch.no_grad():
            flat_inputs = entry.prologue_fn(*[l for l, m in zip(leaves, tensor_mask) if m])
            out = entry.computation_fn(*flat_inputs)
        if entry.effect_keys:
            out, effects = out
            apply_effects(entry.effect_keys, effects)
        return out

    @property
    def cache_hits(self) -> int:
        return int(self._cs.cache_hits)

    @property
    def cache_misses(self) -> int:
        return int(self._cs.cache_misses)


def jit(fn: Callable, *, executors: Sequence | None = None, transforms: Sequence | None = None):
    """Compile a callable into a cached trace program. Its tensor inputs
    decide the device it runs on; calls with new (shape, dtype, device)
    metadata compile a new specialization. A ``torch.nn.Module`` becomes a
    ``ThunderModule`` whose program takes the parameters as inputs;
    ``transforms`` rewrite the acquired trace (e.g. ``AutocastTransform``)."""
    from .nn.module import ThunderModule

    if isinstance(fn, torch.nn.Module):
        return ThunderModule(fn, executors=executors, transforms=transforms)
    cd = CompileData(fn=fn, executors=resolve_executors(executors) if executors is not None else (),
                     transforms=transforms or ())
    return ThunderCompiledFunction(cd)


def _get_cs(cfn) -> CompileStats:
    cs = getattr(cfn, "_cs", None)
    if cs is None:
        raise ValueError(f"{cfn} is not a thunder_tpu_torch-compiled function")
    return cs


def last_traces(cfn) -> list:
    """[acquired trace, after dead-code elimination, after executor claiming]
    of the function's most recent compile."""
    return _get_cs(cfn).last_traces


def last_backward_traces(cfn) -> list:
    """[backward trace, after executor claiming] of the most recent
    value_and_grad (or TrainStep) compile."""
    return _get_cs(cfn).last_backward_traces


def last_prologue_traces(cfn) -> list:
    return _get_cs(cfn).last_prologue_traces


def cache_hits(cfn) -> int:
    return int(_get_cs(cfn).cache_hits)


def cache_misses(cfn) -> int:
    return int(_get_cs(cfn).cache_misses)


def value_and_grad(fn, argnums=0):
    """(value, grads) of a scalar-valued callable (differentiated in its
    ``argnums`` positional arguments), Module or ThunderModule
    (transforms/autodiff.py)."""
    from .transforms.autodiff import value_and_grad as _vag

    return _vag(fn, argnums)


def grad(fn, argnums=0):
    from .transforms.autodiff import grad as _grad

    return _grad(fn, argnums)
