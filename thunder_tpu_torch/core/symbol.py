"""Symbol and BoundSymbol: the hierarchical IR node.

The IR node of thunder_tpu/core/symbol.py, unchanged but for the eager
escape hatch, which runs through torchex; with it the bind-time autocast
hook (``_autocast_stack``) of transforms/autocast.py:autocast_ctx. A ``Symbol`` is a named
operation with a ``meta`` function that (a) computes output proxies and (b) for
composite symbols, records the decomposition as subsymbols by calling other
symbols. A ``BoundSymbol`` is a symbol bound to concrete args/outputs plus its
recorded ``subsymbols`` — executors claim bsyms at whatever level of the
hierarchy they support (flash-attention claims ``sdpa`` whole; the op-by-op
executor runs flattened prims)."""
from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

from .baseutils import SymbolInterface, check
from .codeutils import ContextInterner, prettyprint, flat_proxies
from .proxies import Proxy, variableify
from .trace import get_tracectx


class _ThreadLocalStack(threading.local):
    """A per-thread stack with list-like append/pop/indexing. Autocast
    policies apply at symbol-bind time, so a process-global list would let
    one tracing thread's ``with autocast_ctx():`` region cast the symbols
    another thread binds (the trace context is a ContextVar already)."""

    def __init__(self):
        self._items: list = []

    def append(self, x) -> None:
        self._items.append(x)

    def pop(self):
        return self._items.pop()

    def __bool__(self) -> bool:
        return bool(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]


# the active in-forward autocast policies (transforms/autocast.py
# autocast_ctx): callables (sym, args, kwargs) -> (args, kwargs), or None
# for an enabled=False region; the innermost is last
_autocast_stack = _ThreadLocalStack()


class OpTags:
    """Reference thunder/core/prims.py:287 OpTags."""

    SHAPE_OP = "shape_op"
    REDUCTION_OP = "reduction_op"
    RANDOM_OP = "random_op"
    ELEMENTWISE = "elementwise"
    DEVICE_SYNC_OP = "device_sync_op"
    DONT_DCE = "dont_dce"
    DONT_FUSE = "dont_fuse"
    IN_PLACE = "in_place"
    COLLECTIVE = "collective"
    RECOMPUTE_IN_BACKWARD = "recompute_in_backward"
    MATMUL_OP = "matmul_op"


class Symbol(SymbolInterface):
    def __init__(
        self,
        name: str,
        meta: Callable | None = None,
        *,
        id: Any = None,
        is_prim: bool = False,
        python_impl: Callable | None = None,
        module: str | None = None,
        tags: Sequence[str] = (),
        print_override: Callable | None = None,
        executor=None,
        _bind_postprocess: Callable | None = None,
    ):
        self.name = name
        self.meta = meta
        self.id = id if id is not None else name
        self.is_prim = is_prim
        self.python_impl = python_impl
        self.module = module
        self.tags = frozenset(tags)
        self.print_override = print_override
        # the executor that owns an operator symbol (extend.py:register_operator)
        self.executor = executor
        self._bind_postprocess = _bind_postprocess

    def __repr__(self) -> str:
        return f"[Symbol {self.module + '.' if self.module else ''}{self.name}]"

    def __hash__(self):
        return hash((self.name, self.id, self.is_prim))

    def __eq__(self, other):
        return isinstance(other, Symbol) and (self.name, self.id) == (other.name, other.id)

    def __call__(self, *args, **kwargs):
        trc = get_tracectx()
        if trc is None:
            # eager escape hatch: execute directly through the always executor
            from ..executors import torchex

            return torchex.eager_execute(self, *args, **kwargs)

        if _autocast_stack:
            # in-forward autocast region: the innermost policy casts
            # matmul-class inputs at bind time, so the casts are ordinary
            # trace bsyms and survive autodiff
            pol = _autocast_stack[-1]
            if pol is not None:
                args, kwargs = pol(self, args, kwargs)

        if self.is_prim:
            out = self.meta(*args, **kwargs)
            bsym = BoundSymbol(self, args, kwargs, out)
        else:
            with trc.push_scope() as sub:
                out = self.meta(*args, **kwargs)
            bsym = BoundSymbol(self, args, kwargs, out, subsymbols=tuple(sub))
        if self._bind_postprocess is not None:
            self._bind_postprocess(bsym)
        trc.add_bound_symbol(bsym)
        return out

    def bind(self, *args, output, subsymbols=(), **kwargs) -> "BoundSymbol":
        return BoundSymbol(self, args, kwargs, output, subsymbols=tuple(subsymbols))


class BoundSymbol:
    __slots__ = ("sym", "args", "kwargs", "output", "subsymbols", "impl", "tags")

    def __init__(self, sym: Symbol, args, kwargs, output, *, subsymbols=(), impl=None, tags=None):
        self.sym = sym
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.output = output
        self.subsymbols = tuple(subsymbols)
        self.impl = impl  # concrete executor callable, set by transform_for_execution
        self.tags = set(tags) if tags else set()

    # ---- dataflow ----
    def flat_proxy_args(self) -> list[Proxy]:
        return flat_proxies((self.args, self.kwargs))

    def flat_proxy_outs(self) -> list[Proxy]:
        return flat_proxies(self.output)

    @property
    def rhs(self):
        """Hashable (op, args) key for CSE (reference symbol.py:749 BoundSymbolRHS)."""
        def freeze(x):
            if isinstance(x, Proxy):
                return variableify(x)
            if isinstance(x, (tuple, list)):
                return tuple(freeze(e) for e in x)
            if isinstance(x, dict):
                return tuple(sorted((k, freeze(v)) for k, v in x.items()))
            if isinstance(x, slice):
                return ("slice", freeze(x.start), freeze(x.stop), freeze(x.step))
            try:
                hash(x)
                return x
            except TypeError:
                return id(x)

        return (self.sym.id, freeze(self.args), freeze(self.kwargs))

    def with_impl(self, impl, executor=None) -> "BoundSymbol":
        b = BoundSymbol(self.sym, self.args, self.kwargs, self.output, subsymbols=self.subsymbols, impl=impl,
                        tags=self.tags)
        return b

    def replace(self, **changes) -> "BoundSymbol":
        kw = dict(sym=self.sym, args=self.args, kwargs=self.kwargs, output=self.output,
                  subsymbols=self.subsymbols, impl=self.impl, tags=self.tags)
        kw.update(changes)
        return BoundSymbol(kw["sym"], kw["args"], kw["kwargs"], kw["output"], subsymbols=kw["subsymbols"],
                           impl=kw["impl"], tags=kw["tags"])

    # ---- printing ----
    def _fmt_output(self, interner) -> str:
        outs = self.output
        if outs is None:
            return "_"
        return prettyprint(outs, interner)

    def _fmt_args(self, interner) -> str:
        parts = [prettyprint(a, interner) for a in self.args]
        parts += [f"{k}={prettyprint(v, interner)}" for k, v in self.kwargs.items()]
        return ", ".join(parts)

    def python_lines(self, idx: int, interner: ContextInterner) -> list[str]:
        """Display form: qualified op names, type comments."""
        from .prims import PrimIDs

        if self.sym.print_override is not None:
            return self.sym.print_override(self, interner)
        if self.sym.id == PrimIDs.RETURN:
            return [f"return {prettyprint(self.args[0] if len(self.args) == 1 else self.args, interner)}"]
        if self.sym.id == PrimIDs.DEL:
            names = ", ".join(p.name for p in self.flat_proxy_args())
            return [f"del {names}"] if names else []
        if self.sym.id == PrimIDs.COMMENT:
            return [f"# {self.args[0]}"]
        if self.sym.id == PrimIDs.UNPACK_TRIVIAL:
            return []
        qual = f"{self.sym.module}.{self.sym.name}" if self.sym.module else self.sym.name
        line = f"{self._fmt_output(interner)} = {qual}({self._fmt_args(interner)})"
        comment = self._type_comment()
        return [line + comment]

    def _type_comment(self) -> str:
        outs = self.flat_proxy_outs()
        from .proxies import TensorProxy

        ts = [o for o in outs if isinstance(o, TensorProxy)]
        if not ts:
            return ""
        return "  # " + "; ".join(f"{t.name}: {t.type_string()}" for t in ts[:3])

    def exec_lines(self, idx: int, interner: ContextInterner) -> list[str]:
        """Executable form: impl callables interned into the namespace."""
        from .prims import PrimIDs

        if self.sym.id == PrimIDs.RETURN:
            return [f"return {prettyprint(self.args[0] if len(self.args) == 1 else self.args, interner)}"]
        if self.sym.id == PrimIDs.DEL:
            names = ", ".join(p.name for p in self.flat_proxy_args())
            return [f"del {names}"] if names else []
        if self.sym.id in (PrimIDs.COMMENT, PrimIDs.UNPACK_TRIVIAL):
            return []
        fn = self.impl
        if fn is None and self.sym.python_impl is not None:
            fn = self.sym.python_impl
        check(
            fn is not None,
            lambda: f"BoundSymbol {self.sym.name} has no implementation — "
            f"did transform_for_execution run? (id={self.sym.id})",
        )
        key = interner.intern(fn, f"{_ident(self.sym.name)}_")
        line = f"{self._fmt_output(interner)} = {key}({self._fmt_args(interner)})"
        return [line]

    def __repr__(self) -> str:
        interner = ContextInterner()
        lines = self.python_lines(0, interner)
        return lines[0] if lines else f"<{self.sym.name}>"


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)
