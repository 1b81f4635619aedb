"""Option enums + DebugOptions: the layered config system.

thunder_tpu/core/options.py for the port, with the same options registered
(CacheOption, SharpEdgesOption, the dynamically-registrable DebugOptions).
``jit`` (__init__.py) reads them: the caching modes that ride on the
bytecode-interpreter frontend, sharp-edge checks and trace checking raise
there until those parts are ported."""
from __future__ import annotations

from enum import Enum
from typing import Any


class CacheOption(Enum):
    """Reference thunder/core/options.py:45-49."""

    NO_CACHING = "no caching"
    SAME_INPUT = "same input"
    CONSTANT_VALUES = "constant values"
    SYMBOLIC_VALUES = "symbolic values"


def resolve_cache_option(x) -> CacheOption:
    if isinstance(x, CacheOption):
        return x
    if isinstance(x, str):
        for opt in CacheOption:
            if opt.value == x.lower():
                return opt
    raise ValueError(f"unknown cache option {x!r}; expected one of {[o.value for o in CacheOption]}")


class SharpEdgesOption(Enum):
    """Reference thunder/core/options.py:99: what to do when tracing hits a
    construct with load-bearing side effects (global reads, IO, ...)."""

    ALLOW = "allow"
    WARN = "warn"
    ERROR = "error"


class DebugOptions:
    """Typed, dynamically-registrable debug options (reference options.py:144-190)."""

    _registered: dict[str, tuple[type, Any, str]] = {}

    def __init__(self, **kwargs):
        for name, (typ, default, _doc) in self._registered.items():
            setattr(self, name, default)
        for k, v in kwargs.items():
            if k not in self._registered:
                raise ValueError(f"unknown debug option '{k}' (known: {sorted(self._registered)})")
            typ = self._registered[k][0]
            if not isinstance(v, typ):
                raise TypeError(f"debug option '{k}' expects {typ.__name__}, got {type(v).__name__}")
            setattr(self, k, v)

    @classmethod
    def register_option(cls, name: str, typ: type, default, doc: str = "") -> None:
        cls._registered[name] = (typ, default, doc)

    @classmethod
    def show_options(cls) -> str:
        return "\n".join(f"{n}: {t.__name__} = {d!r}  {doc}" for n, (t, d, doc) in cls._registered.items())


DebugOptions.register_option("check_traces", bool, False, "validate every trace with check_trace")
DebugOptions.register_option("show_interpreter_log", bool, False, "print acquisition log")
DebugOptions.register_option("record_interpreter_history", bool, False, "keep per-symbol acquisition history")
