"""CompileData / CompileStats / CacheEntry and the effect epilogue for jit.

The bookkeeping of thunder_tpu/common.py, without the distributed state:
a distributed plan rides on the ThunderModule (parallel/transforms.py)."""
from __future__ import annotations

import threading
from typing import Callable, Sequence


class _Counter:
    """An integer that concurrent threads may increment (a serving engine's
    loop thread and its callers share one compiled function)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, k: int = 1) -> None:
        with self._lock:
            self._n += k

    def __int__(self) -> int:
        return self._n


class CompileStats:
    """Per-function cache counters and the last compile's traces."""

    def __init__(self):
        self.cache_hits = _Counter()
        self.cache_misses = _Counter()
        self.graph_captures = _Counter()  # CUDA graphs captured (executors/graphex.py)
        self.graph_replays = _Counter()
        self.last_traces: list = []
        self.last_prologue_traces: list = []
        self.last_backward_traces: list = []


class CompileData:
    """Per-function compile configuration."""

    def __init__(self, *, fn: Callable, executors: Sequence = (), transforms: Sequence = ()):
        self.fn = fn
        self.executors = tuple(executors)
        self.transforms = tuple(transforms)


def apply_effects(effect_keys, effects, in_place: bool = False) -> None:
    """The epilogue of a program that writes buffers (thunder_tpu/common.py:
    EpilogueMixin.apply_effects): each ``(owner, name)`` buffer is rebound
    to the value the program computed, or, with ``in_place`` (a program
    run as a CUDA graph), the value is written into the buffer the owner
    holds: a rebinding would hand the owner the graph's output, which the
    next replay overwrites, and leave the graph reading the old buffer."""
    for (owner, name), value in zip(effect_keys, effects):
        if in_place:
            owner._buffers[name].copy_(value)
        else:
            owner._buffers[name] = value


class CacheEntry:
    """One compiled specialization; ``effect_keys`` are the ``(owner,
    name)`` buffers its program writes, in the order of its effect values;
    ``trace`` is the claimed computation trace and ``program`` its CUDA
    graph (executors/graphex.py), made at its first call on the card when
    the function was jitted with ``cuda_graphs=True``."""

    __slots__ = ("prologue_fn", "computation_fn", "effect_keys", "trace", "program")

    def __init__(self, **kw):
        for s in self.__slots__:
            setattr(self, s, kw.get(s))
