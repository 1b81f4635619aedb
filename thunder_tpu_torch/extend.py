"""Executor/extension system: the pluggable backend registry.

The registry of thunder_tpu/extend.py. Executors claim BoundSymbols at any
level of the hierarchy: OperatorExecutors provide concrete implementations
per symbol id, with an optional checker that decides whether a bound symbol
is claimed, and operator symbols of their own (register_operator) that grad
rules record and that only their executor runs, listed or not.
StatefulExecutors thread a persistent state object into their operators.
Execution transforms and fusion executors wait for the slices that need
them."""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from .core.symbol import BoundSymbol, Symbol


class OperatorExecutor:
    """Concrete implementations per symbol id, each with an optional checker
    that decides, from a bound symbol's arguments, whether it is claimed."""

    def __init__(self, name: str):
        self.name = name
        # symbol id -> (callable the generated code invokes, checker or None)
        self.implmap: dict[Any, tuple[Callable, Optional[Callable]]] = {}

    def __repr__(self) -> str:
        return f"<Executor {self.name}>"

    def register_operator(self, name: str, *, meta: Callable, fn: Callable) -> Symbol:
        """A prim-level Symbol ``<executor>.<name>`` that only this executor
        runs (thunder_tpu/extend.py:OperatorExecutor.register_operator)."""
        sym = Symbol(name, meta, id=f"{self.name}.{name}", is_prim=True, module=self.name, executor=self)
        self.implmap[sym.id] = (fn, None)
        return sym

    def register_implementation(self, sym_or_id, fn: Callable, *, checker=None) -> None:
        sym_id = sym_or_id.id if isinstance(sym_or_id, Symbol) else sym_or_id
        self.implmap[sym_id] = (fn, checker)

    def claim(self, bsym: BoundSymbol) -> Optional[Callable]:
        """The implementation that runs bsym, or None when this executor
        does not claim it (no entry, or its checker declines or raises)."""
        fn, checker = self.implmap.get(bsym.sym.id, (None, None))
        if fn is None or checker is None:
            return fn
        try:
            return fn if checker(*bsym.args, **bsym.kwargs) else None
        except Exception:
            return None


class StatefulExecutor(OperatorExecutor):
    """An executor whose operators carry a persistent state object across
    calls (thunder_tpu/extend.py:StatefulExecutor; TransformerEngine's fp8
    recipe state). ``register_stateful_operator`` binds a state factory; the
    state is made at the operator's first call, kept in ``_states`` under
    the symbol id, and passed as the implementation's first argument."""

    def __init__(self, name: str):
        super().__init__(name)
        self._state_factories: dict = {}
        self._states: dict = {}

    def register_stateful_operator(self, name: str, state_factory: Callable, *, meta: Callable,
                                   fn: Callable) -> Symbol:
        sid = f"{self.name}.{name}"
        self._state_factories[sid] = state_factory

        def bound(*args, **kwargs):
            state = self._states.get(sid)
            if state is None:
                state = self._states[sid] = self._state_factories[sid]()
            return fn(state, *args, **kwargs)

        return self.register_operator(name, meta=meta, fn=bound)


# ---------------------------------------------------------------------------
# global registry
# ---------------------------------------------------------------------------

_executor_registry: dict[str, OperatorExecutor] = {}
_default_executors: list[OperatorExecutor] = []
_always_executors: list[OperatorExecutor] = []


def register_executor(ex: OperatorExecutor) -> OperatorExecutor:
    _executor_registry[ex.name] = ex
    return ex


def get_executor(name: str) -> OperatorExecutor:
    ex = _executor_registry.get(name)
    if ex is None:
        raise LookupError(f"unknown executor '{name}' (known: {sorted(_executor_registry)})")
    return ex


def set_default_executors(exs: Sequence[OperatorExecutor]) -> None:
    _default_executors.clear()
    _default_executors.extend(exs)


def get_default_executors() -> tuple[OperatorExecutor, ...]:
    return tuple(_default_executors)


def get_always_executors() -> tuple[OperatorExecutor, ...]:
    return tuple(_always_executors)


def resolve_executors(executors) -> tuple[OperatorExecutor, ...]:
    if executors is None:
        return get_default_executors()
    out = []
    for e in executors:
        if isinstance(e, OperatorExecutor):
            out.append(e)
        elif isinstance(e, str):
            out.append(get_executor(e))
        else:
            raise TypeError(f"cannot resolve executor {e!r}")
    return tuple(out)


def add_always_executor(ex: OperatorExecutor) -> None:
    if ex not in _always_executors:
        _always_executors.append(ex)
