"""Plugins: string-addressable feature bundles a recipe takes.

thunder_tpu/plugins.py for the port. ``reduce-overhead`` is CUDA-graph
capture (``cuda_graphs=True``, executors/graphex.py): thunder_tpu's plugin
is a no-op only because XLA already compiles its whole program, and its
docstring names CUDA graphs as the GPU's counterpart; graph capture is the
port's whole-program compile. The distributed plugin names (``ddp``,
``fsdp``, ``tp``, ``cp``) live in parallel/plugins.py, registered when one
of them is first asked for."""
from __future__ import annotations


class Plugin:
    def setup_transforms(self, transforms: list) -> list:
        return transforms

    def setup_executors(self, executors: list) -> list:
        return executors

    def setup_config(self, config: dict) -> dict:
        return config


class ReduceOverhead(Plugin):
    """Run the compiled program as a CUDA graph (``cuda_graphs=True``)."""

    def setup_config(self, config: dict) -> dict:
        return {**config, "cuda_graphs": True}


_registry: dict[str, type] = {}


def register_plugin(name: str, cls: type) -> None:
    _registry[name] = cls


register_plugin("reduce-overhead", ReduceOverhead)


def resolve_plugin(p):
    if isinstance(p, Plugin):
        return p
    if isinstance(p, str):
        if p not in _registry:
            from .parallel import plugins as _distributed  # noqa: F401  (registers ddp, fsdp, tp, cp)
        if p in _registry:
            return _registry[p]()
        raise ValueError(f"unknown plugin '{p}' (known: {sorted(_registry)})")
    if isinstance(p, type) and issubclass(p, Plugin):
        return p()
    raise TypeError(f"cannot resolve plugin {p!r}")
