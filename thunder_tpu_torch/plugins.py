"""Plugins: string-addressable feature bundles a recipe takes.

thunder_tpu/plugins.py for the port. ``reduce-overhead`` is CUDA-graph
capture (``cuda_graphs=True``, executors/graphex.py): thunder_tpu's plugin
is a no-op only because XLA already compiles its whole program, and its
docstring names CUDA graphs as the GPU's counterpart; graph capture is the
port's whole-program compile. The distributed plugin names of
thunder_tpu/parallel/plugins.py (``ddp``, ``fsdp``, ``tp``, ``cp``) are
known here and raise: a recipe's plugins over the port's parallel slice are
ROADMAP A3b's."""
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
_DISTRIBUTED = ("ddp", "fsdp", "tp", "cp")


def register_plugin(name: str, cls: type) -> None:
    _registry[name] = cls


register_plugin("reduce-overhead", ReduceOverhead)


def resolve_plugin(p):
    if isinstance(p, Plugin):
        return p
    if isinstance(p, str):
        if p in _registry:
            return _registry[p]()
        if p in _DISTRIBUTED:
            raise NotImplementedError(
                f"plugin '{p}' is not ported: the port's distributed plugins wait for ROADMAP A3b "
                f"(use thunder_tpu_torch.parallel's ddp / context_parallel on a jitted module)")
        raise ValueError(f"unknown plugin '{p}' (known: {sorted(_registry)})")
    if isinstance(p, type) and issubclass(p, Plugin):
        return p()
    raise TypeError(f"cannot resolve plugin {p!r}")
