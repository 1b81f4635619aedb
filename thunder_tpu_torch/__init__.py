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
``ddp`` and ring-attention ``context_parallel``); the frontend slice
brings ``interop.torch_frontend`` (plain torch modules traced through
``__torch_function__``), the auto-registered catalog (ops/auto_register.py),
``compile`` with ``recipes`` and ``plugins``; the transform-breadth slice
brings ``jit``'s ``cache=``, ``sharp_edges=`` and ``debug_options=``
(core/options.py) and ``custom_op`` (_custom_op.py). A program runs where
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


def _cache_key(leaves, tensor_mask, fn=None) -> tuple:
    """Tensors key on (shape, dtype, device), never on values: a 0-d int32
    position is one specialization for every position. Other leaves key on
    their value. ``fn.__cache_extra__()``, where fn has one, is part of the
    key: a module's train/eval flags (nn/module.py), which change the traced
    program without changing any input."""
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
    extra = getattr(fn, "__cache_extra__", None)
    if extra is not None:
        key.append(("extra", extra()))
    return tuple(key)


class ThunderCompiledFunction:
    """The callable returned by jit(). A program that writes buffers returns
    their new values beside its result; the call replays them onto their
    owners (common.py:apply_effects)."""

    def __init__(self, cd: CompileData, cuda_graphs: bool = False, graph_pool=None):
        self._cd = cd
        self._cs = CompileStats()
        self._cache: dict = {}
        self._cuda_graphs = cuda_graphs
        self._graph_pool = graph_pool
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
                           effect_keys=tuple((owner, name) for owner, name, _ in trc.side_effects),
                           trace=ex_trc)
        self._cache[key] = entry
        return entry

    def __call__(self, *args, **kwargs):
        cs = self._cs
        leaves, _ = tree_flatten((args, kwargs))
        tensor_mask = [_is_tensor_like(leaf) for leaf in leaves]
        key = _cache_key(leaves, tensor_mask, self._cd.fn)
        entry = self._cache.get(key)
        if entry is None:
            cs.cache_misses.add()
            entry = self._compile(args, kwargs, key)
            if self._cd.cache_option == "no caching":
                # compiled for this call alone: nothing is kept between calls
                self._cache.clear()
        else:
            cs.cache_hits.add()
        with torch.no_grad():
            flat_inputs = entry.prologue_fn(*[l for l, m in zip(leaves, tensor_mask) if m])
            if self._cuda_graphs and self._graphed(flat_inputs):
                if entry.program is None:
                    entry.program = self._program(entry, flat_inputs)
                return entry.program(*flat_inputs)
            out = entry.computation_fn(*flat_inputs)
        if entry.effect_keys:
            out, effects = out
            apply_effects(entry.effect_keys, effects)
        return out

    @staticmethod
    def _graphed(flat_inputs) -> bool:
        """Run as a CUDA graph: the inputs are on the card and no other
        program is being captured (then this one's launches are part of
        that capture)."""
        from .executors import graphex

        return (bool(flat_inputs) and graphex.captures_on(flat_inputs[0].device)
                and graphex.capturing() is None)

    def _program(self, entry: CacheEntry, flat_inputs):
        """The entry's CUDAGraphProgram. In place: the parameters and the
        inputs its trace writes (the pools of write_dead_inputs_in_place);
        the rest is copied into the graph's buffers each call. Buffer writes
        go into the owners' buffers (apply_effects in place)."""
        from .executors import graphex, torchex

        trc = entry.trace
        graphex.check_capturable(trc, self.__name__)
        written = {b.args[0].name for b in trc.bound_symbols if b.impl is torchex.index_put_in_place}
        in_place = [isinstance(t, torch.nn.Parameter) or p.name in written
                    for t, p in zip(flat_inputs, trc.args)]
        computation, effect_keys = entry.computation_fn, entry.effect_keys

        def run(*flat):
            out = computation(*flat)
            if effect_keys:
                out, effects = out
                apply_effects(effect_keys, effects, in_place=True)
            return out

        if self._graph_pool is None:
            self._graph_pool = graphex.GraphPool()
        return graphex.CUDAGraphProgram(run, name=self.__name__, in_place=in_place, pool=self._graph_pool,
                                        stats=self._cs)

    @property
    def cache_hits(self) -> int:
        return int(self._cs.cache_hits)

    @property
    def cache_misses(self) -> int:
        return int(self._cs.cache_misses)


# torch.nn's containers: they hold layers and compute nothing of their own
_CONTAINERS = (torch.nn.Module, torch.nn.Sequential, torch.nn.ModuleList, torch.nn.ModuleDict,
               torch.nn.ParameterList, torch.nn.ParameterDict)


def uses_torch_frontend(module: torch.nn.Module) -> bool:
    """Whether ``jit`` traces ``module`` through the torch frontend
    (interop/torch_frontend.py): its class comes from ``transformers``, or
    its tree holds a layer of ``torch.nn`` other than the containers. A
    module built from the port's own layers (nn/layers.py; every model in
    models/), whose forward is written in the port's ltorch, keeps
    ``ThunderModule``. thunder_tpu's rule (any ``torch.nn`` class in the
    MRO) cannot serve here: every port model is a ``torch.nn.Module``."""
    if any(k.__module__.startswith("transformers") for k in type(module).__mro__):
        return True
    return any(k.__module__.startswith("torch.nn.modules") and k not in _CONTAINERS
               for m in module.modules() for k in type(m).__mro__)


def _check_options(fn, cache, sharp_edges, debug_options) -> str:
    """The cache option's value, after thunder_tpu/__init__.py:jit's checks
    of the options that need a part the port has not yet: the
    bytecode-interpreter frontend (ROADMAP A7) and analysis/ (A6)."""
    from .core.options import CacheOption, DebugOptions, SharpEdgesOption, resolve_cache_option

    cache = resolve_cache_option(cache)
    SharpEdgesOption(sharp_edges)
    if cache in (CacheOption.SYMBOLIC_VALUES, CacheOption.SAME_INPUT) and isinstance(fn, torch.nn.Module):
        raise ValueError(
            f"cache={cache.value!r} is only supported for plain callables "
            f"(modules always take tensor inputs; use 'constant values')")
    if sharp_edges != "allow":
        raise ValueError(
            "sharp_edges checking requires the bytecode-interpreter frontend, "
            "which is not ported yet (ROADMAP A7)")
    if cache in (CacheOption.SYMBOLIC_VALUES, CacheOption.SAME_INPUT):
        raise NotImplementedError(
            f"cache={cache.value!r} rides on the bytecode-interpreter frontend's prologues "
            f"(thunder_tpu's frontend/compiled.py), which is not ported yet (ROADMAP A7)")
    if debug_options is not None:
        if not isinstance(debug_options, DebugOptions):
            raise TypeError(f"debug_options takes a DebugOptions, got {type(debug_options).__name__}")
        if debug_options.check_traces:
            raise NotImplementedError(
                "DebugOptions(check_traces=True) checks every trace with analysis/'s verifier, "
                "which is not ported yet (ROADMAP A6)")
        for name in ("show_interpreter_log", "record_interpreter_history"):
            if getattr(debug_options, name):
                raise NotImplementedError(
                    f"DebugOptions({name}=True) needs the bytecode-interpreter frontend, "
                    f"which is not ported yet (ROADMAP A7)")
    return cache.value


def jit(fn: Callable, *, executors: Sequence | None = None, transforms: Sequence | None = None,
        cache: str = "constant values", sharp_edges: str = "allow", debug_options=None,
        cuda_graphs: bool = False, graph_pool=None):
    """Compile a callable into a cached trace program. Its tensor inputs
    decide the device it runs on; calls with new (shape, dtype, device)
    metadata compile a new specialization. A ``torch.nn.Module`` becomes a
    ``ThunderModule`` whose program takes the parameters as inputs, or,
    when it is written with torch's own layers (``uses_torch_frontend``), a
    ``CompiledTorchModule`` that traces it through ``__torch_function__``;
    ``transforms`` rewrite the acquired trace (e.g. ``AutocastTransform``).

    ``cuda_graphs=True`` runs each specialization on the card as a CUDA
    graph (executors/graphex.py: its first call runs op by op, its second
    captures, later calls replay); CPU tensors always run op by op.
    Non-parameter outputs then come back as clones. Programs given one
    ``graphex.GraphPool`` share its memory and must not run at once.

    ``cache`` (core/options.py): "constant values" (the default) keeps one
    specialization per input metadata; "no caching" compiles every call
    and keeps nothing. "symbolic values" and "same input", ``sharp_edges``
    other than "allow", and ``debug_options`` that check traces raise, as
    the parts they need are not ported yet (thunder_tpu routes them to its
    bytecode-interpreter frontend and analysis/)."""
    from .nn.module import ThunderModule

    cache = _check_options(fn, cache, sharp_edges, debug_options)
    if isinstance(fn, torch.nn.Module) and uses_torch_frontend(fn):
        from .interop.torch_frontend import compile_torch_module

        return compile_torch_module(fn, executors=executors, transforms=transforms, cuda_graphs=cuda_graphs,
                                    graph_pool=graph_pool, cache=cache)
    if isinstance(fn, torch.nn.Module):
        return ThunderModule(fn, executors=executors, transforms=transforms, cuda_graphs=cuda_graphs,
                             graph_pool=graph_pool, cache=cache)
    cd = CompileData(fn=fn, executors=resolve_executors(executors) if executors is not None else (),
                     transforms=transforms or (), cache_option=cache)
    return ThunderCompiledFunction(cd, cuda_graphs=cuda_graphs, graph_pool=graph_pool)


def compile(fn: Callable, *, recipe=None, plugins=None, **kwargs):
    """Compile through a recipe (recipes.py): ``recipe`` is a Recipe, a
    registered name, or None / "auto" (``HFTransformers`` for a transformers
    model, else ``BaseRecipe``); ``plugins`` add to it (plugins.py)."""
    from .recipes import resolve_recipe

    return resolve_recipe(recipe, fn).apply(fn, plugins=plugins, **kwargs)


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


def graph_captures(cfn) -> int:
    """CUDA graphs captured by a compiled function, TrainStep or engine program."""
    return int(_get_cs(cfn).graph_captures)


def graph_replays(cfn) -> int:
    return int(_get_cs(cfn).graph_replays)


def custom_op(qualname, *, like=None, meta=None, tags=()):
    """A torch-implemented custom operation usable inside traced functions
    (_custom_op.py; thunder_tpu/__init__.py:custom_op)."""
    from ._custom_op import custom_op as _custom_op

    return _custom_op(qualname, like=like, meta=meta, tags=tags)


def value_and_grad(fn, argnums=0):
    """(value, grads) of a scalar-valued callable (differentiated in its
    ``argnums`` positional arguments), Module or ThunderModule
    (transforms/autodiff.py)."""
    from .transforms.autodiff import value_and_grad as _vag

    return _vag(fn, argnums)


def grad(fn, argnums=0):
    from .transforms.autodiff import grad as _grad

    return _grad(fn, argnums)
