"""Modules of the port: ``torch.nn.Module`` trees, traced by swapping params.

thunder_tpu owns its module system over jax arrays; the port uses torch's:
models are ``torch.nn.Module``s holding ``torch.nn.Parameter``s, and their
``forward`` is written in the port's ltorch, so calling it under a trace
records ltorch bound symbols. ``functional_params`` swaps proxies in for the
parameters and buffers while a program is traced, so the computation trace
takes them as explicit inputs (thunder_tpu/nn/module.py:functional_params).
``ThunderModule`` is the compiled wrapper ``jit(module)`` returns.

What thunder_tpu's Module adds for its transforms, torch's has already:
``register_parameter`` appends a parameter after the existing ones, so
``named_parameters`` lists it in thunder_tpu's order, and an instance
``forward`` set by a transform (transforms/quantization.py) is the one
``__call__`` runs. What it lacks is ``Module.update_buffer``, the traced
buffer write: here it is the function ``update_buffer(module, name,
value)``."""
from __future__ import annotations

from contextlib import contextmanager

import torch

Module = torch.nn.Module
Parameter = torch.nn.Parameter
ModuleList = torch.nn.ModuleList
Sequential = torch.nn.Sequential


def update_buffer(module: torch.nn.Module, name: str, value) -> None:
    """Write a module buffer (thunder_tpu/nn/module.py:Module.update_buffer).
    Inside a trace, a proxy value is recorded as the side effect ``(module,
    name, value)``, which jit replays onto the module after the call, and is
    also what later reads of the buffer in the same trace see
    (functional_params restores the original when tracing ends). Outside a
    trace it rebinds the buffer."""
    from ..core.proxies import Proxy
    from ..core.trace import get_tracectx

    trc = get_tracectx()
    if trc is not None and isinstance(value, Proxy):
        trc.side_effects.append((module, name, value))
    module._buffers[name] = value


@contextmanager
def functional_params(module: torch.nn.Module, param_map: dict):
    """Temporarily replace parameters AND buffers (by qualified name) with the
    given values. The writes go to the stores directly: torch's
    ``__setattr__`` would refuse a proxy in a parameter's place."""
    saved = []
    for mod_name, mod in module.named_modules():
        for store in (mod._parameters, mod._buffers):
            for name in list(store):
                q = f"{mod_name}.{name}" if mod_name else name
                if q in param_map:
                    saved.append((store, name, store[name]))
                    store[name] = param_map[q]
    try:
        yield
    finally:
        for store, name, orig in saved:
            store[name] = orig


class ThunderModule:
    """Compiled wrapper around a Module (thunder_tpu/nn/module.py:ThunderModule).

    The traced program takes ``(params, args, kwargs)``: every parameter and
    buffer, by qualified name, is an explicit input, pulled fresh from the
    module on every call — an optimizer's in-place updates take effect
    without retracing as long as the metadata matches. Buffers the forward
    writes (update_buffer) are rebound on the module after the call."""

    def __init__(self, module: torch.nn.Module, *, executors=None, transforms=None, cuda_graphs=False,
                 graph_pool=None, cache: str = "constant values"):
        from .. import jit as _jit

        if cache not in ("constant values", "no caching"):
            raise ValueError(
                f"cache={cache!r} is not supported for modules "
                f"(supported: 'constant values', 'no caching')")
        self._module = module

        def _traced(params: dict, args: tuple, kwargs: dict):
            with functional_params(module, params):
                return module(*args, **kwargs)

        _traced.__name__ = f"{type(module).__name__}_forward"
        # train/eval flags change the traced program (BatchNorm's branches)
        # without changing any input, so they are part of the cache key
        # (thunder_tpu/nn/module.py:418-422): a mode flip retraces
        _traced.__cache_extra__ = lambda: tuple(m.training for m in module.modules())
        transforms = list(transforms or ())
        for tf in transforms:
            tf.transform_module(self)
        self._cfn = _jit(_traced, executors=executors, transforms=transforms, cuda_graphs=cuda_graphs,
                         graph_pool=graph_pool, cache=cache)

    @property
    def module(self) -> torch.nn.Module:
        return self._module

    @property
    def _cs(self):
        return self._cfn._cs

    @property
    def _cd(self):
        return self._cfn._cd

    def train(self, mode: bool = True) -> "ThunderModule":
        self._module.train(mode)
        return self

    def eval(self) -> "ThunderModule":
        return self.train(False)

    def get_parameters(self) -> dict:
        return dict(self._module.named_parameters())

    def get_buffers(self) -> dict:
        """Qualified-name buffers — traced as inputs so they are not baked
        into the program as constants."""
        return dict(self._module.named_buffers())

    def __call__(self, *args, **kwargs):
        return self._cfn({**self.get_parameters(), **self.get_buffers()}, args, kwargs)

    _no_sync_active = False

    @contextmanager
    def no_sync(self):
        """Inside this context a TrainStep over this module accumulates
        gradients without the cross-rank sync or the optimizer update
        (``TrainStep.micro_step``); the first step after it folds them in
        (reference ThunderModule.no_sync, thunder/core/module.py:341)."""
        self._no_sync_active = True
        try:
            yield
        finally:
            self._no_sync_active = False

    def state_dict(self) -> dict:
        """Every parameter and buffer by qualified name, each parameter whole
        and unpadded: under a distributed plan (parallel/) a rank holds only
        its block of a sharded parameter, so this gathers the blocks over
        the plan's axes (a collective: every rank calls it) and slices off
        FSDP's dim-0 padding (thunder_tpu/nn/module.py:287-295)."""
        plan = getattr(self, "_dist_plan", None)
        out = {}
        for name, p in self.get_parameters().items():
            t = p.detach()
            if plan is not None:
                from ..parallel.transforms import full_parameter

                t = full_parameter(name, t, plan)
            out[name] = t
        out.update({name: b.detach() for name, b in self.get_buffers().items()})
        return out

    def load_state_dict(self, sd: dict, strict: bool = True) -> None:
        """Copy whole tensors into the parameters and buffers in place: under
        a plan each rank takes its block, re-padding FSDP's indivisible dim
        0 (thunder_tpu/nn/module.py:166-175). A shape that does not match
        raises; ``strict`` also refuses missing and unexpected keys."""
        plan = getattr(self, "_dist_plan", None)
        own = {**self.get_parameters(), **self.get_buffers()}
        if strict:
            missing, unexpected = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
            if missing or unexpected:
                raise KeyError(f"load_state_dict: missing {missing}, unexpected {unexpected}")
        with torch.no_grad():
            for name, t in own.items():
                if name not in sd:
                    continue
                v = torch.as_tensor(sd[name])
                if plan is not None and name in plan.param_strategies:
                    from ..parallel.transforms import local_parameter

                    v = local_parameter(name, v, plan)
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f"state_dict shape mismatch for '{name}': checkpoint "
                                     f"{tuple(v.shape)} vs parameter {tuple(t.shape)}")
                t.copy_(v)
