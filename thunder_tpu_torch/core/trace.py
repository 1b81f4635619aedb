"""TraceCtx: the function-shaped program representation.

The TraceCtx of thunder_tpu/core/trace.py. A trace is a signature plus an
ordered list of BoundSymbols; it prints to real Python source and compiles
to a callable whose ops are bound executor implementations — here one torch
call (or hand-written kernel launch) per bound symbol. ``device`` is the
device of the program's tensor inputs: proxies and factories made without a
device take it, so constants land where the program runs. ``side_effects``
lists the buffer writes recorded while tracing (nn/module.py:update_buffer),
as ``(owner, name, proxy)`` in program order; jit returns their values
beside the result and replays them onto the owners after the call."""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Optional

from . import baseutils
from .codeutils import ContextInterner

_tracectx = ContextVar("tracectx", default=None)


def get_tracectx() -> Optional["TraceCtx"]:
    return _tracectx.get()


@contextmanager
def tracectx(trace: "TraceCtx | None"):
    tok = _tracectx.set(trace)
    try:
        yield trace
    finally:
        _tracectx.reset(tok)


class TraceProvenance:
    """Reference thunder/core/trace.py:25 — 'Constructed by <pass> (took N ms)'."""

    def __init__(self, pss: str):
        self.pss = pss

    def __repr__(self) -> str:
        return f"# Constructed by {self.pss}"


class TraceCtx(baseutils.TraceInterface):
    def __init__(self, fn: Callable | None = None, *, prologue: bool = False):
        self.fn = fn
        self.bound_symbols: list = []
        self.scopes: list[list] = [self.bound_symbols]
        self.args: tuple = ()
        self.kwargs: dict = {}
        self._name = None
        self.names: set[str] = set()
        self._counters: dict[str, int] = {}
        self._provenance: TraceProvenance | None = None
        self.is_prologue = prologue
        self.device = None
        self.side_effects: list = []

    # ---- naming ----
    def make_name(self, prefix: str = "t") -> str:
        while True:
            c = self._counters.get(prefix, -1) + 1
            self._counters[prefix] = c
            name = f"{prefix}{c}"
            if name not in self.names:
                self.names.add(name)
                return name

    def add_name(self, name: str) -> None:
        self.names.add(name)

    def has_name(self, name: str) -> bool:
        return name in self.names

    # ---- recording ----
    def add_bound_symbol(self, bsym) -> None:
        self.scopes[-1].append(bsym)

    @contextmanager
    def push_scope(self):
        scope: list = []
        self.scopes.append(scope)
        try:
            yield scope
        finally:
            popped = self.scopes.pop()
            assert popped is scope

    def set_provenance(self, p: "TraceProvenance | str"):
        self._provenance = p if isinstance(p, TraceProvenance) else TraceProvenance(p)

    # ---- structure ----
    @property
    def output(self):
        """args of the RETURN bsym, if present."""
        from .prims import PrimIDs

        for bsym in reversed(self.bound_symbols):
            if bsym.sym.id == PrimIDs.RETURN:
                return bsym.args[0] if len(bsym.args) == 1 else bsym.args
        return None

    def name_of_fn(self) -> str:
        if self._name:
            return self._name
        base = getattr(self.fn, "__name__", None) or "computation"
        if not base.isidentifier():  # e.g. "<lambda>"
            base = "computation"
        return "prologue" if self.is_prologue else base

    # ---- printing ----
    def python(self, include_decorators: bool = True) -> str:
        interner = ContextInterner()
        lines, _ = self._build_lines(interner)
        sig = ", ".join(p.name for p in self.args)
        header = []
        if self._provenance is not None:
            header.append(repr(self._provenance))
        header.append(f"def {self.name_of_fn()}({sig}):")
        body = [f"  {ln}" for ln in lines] or ["  pass"]
        return "\n".join(header + body)

    def _build_lines(self, interner: ContextInterner):
        lines: list[str] = []
        for i, bsym in enumerate(self.bound_symbols):
            lines.extend(bsym.python_lines(i, interner))
        return lines, interner

    def __repr__(self) -> str:
        return self.python()

    # ---- compiling to a callable ----
    def python_callable(self, **ctx_overrides) -> Callable:
        """exec() the printed source with op implementations bound in the namespace."""
        interner = ContextInterner()
        lines: list[str] = []
        for i, bsym in enumerate(self.bound_symbols):
            lines.extend(bsym.exec_lines(i, interner))
        sig = ", ".join(p.name for p in self.args)
        fname = self.name_of_fn()
        body = [f"  {ln}" for ln in lines] or ["  pass"]
        src = f"def {fname}({sig}):\n" + "\n".join(body)
        ctx = dict(interner.ctx)
        ctx.update(ctx_overrides)
        code = compile(src, f"<thunder_tpu_torch.gen.{fname}>", "exec")
        exec(code, ctx)
        fn = ctx[fname]
        fn.__source__ = src
        fn.__trace__ = self
        return fn


def from_trace(trace: TraceCtx) -> TraceCtx:
    """Empty trace inheriting signature, names and device."""
    t = TraceCtx(trace.fn, prologue=trace.is_prologue)
    t.args = trace.args
    t.kwargs = trace.kwargs
    t.names = set(trace.names)
    t._counters = dict(trace._counters)
    t._name = trace._name
    t.device = trace.device
    t.side_effects = list(trace.side_effects)
    return t
