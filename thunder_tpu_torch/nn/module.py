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
                 graph_pool=None):
        from .. import jit as _jit

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
                         graph_pool=graph_pool)

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
