"""Trace re-interpretation: run an existing trace symbol-by-symbol into a new
trace, substituting or expanding chosen bsyms.

The TraceSubstitutionProcessor of thunder_tpu/core/trace_interpreter.py —
the engine under autocast. Recorded buffer writes are carried over with
their proxies renamed as the re-recorded trace names them, and a bsym's
tags (RECOMPUTE_IN_BACKWARD) onto every bsym that replaces it."""
from __future__ import annotations

from typing import Any, Callable

from .prims import PrimIDs
from .proxies import Proxy
from .trace import TraceCtx, tracectx


class TraceSubstitutionProcessor:
    """Re-record a trace, letting a visitor replace individual bsyms.

    visitor(bsym, call_args, call_kwargs) returns either:
      - None: re-emit the bsym unchanged (its symbol is re-called), or
      - a result pytree: used as the bsym's new output (the visitor is
        expected to have recorded replacement symbols itself).
    """

    def __init__(self, trace: TraceCtx, visitor: Callable):
        self.trace = trace
        self.visitor = visitor
        self.env: dict[str, Any] = {}

    def lookup(self, x):
        if isinstance(x, Proxy):
            return self.env.get(x.name, x)
        if isinstance(x, (tuple, list)):
            return type(x)(self.lookup(e) for e in x)
        if isinstance(x, dict):
            return {k: self.lookup(v) for k, v in x.items()}
        return x

    def map_out(self, old, new):
        if isinstance(old, Proxy):
            self.env[old.name] = new
        elif isinstance(old, (tuple, list)) and isinstance(new, (tuple, list)):
            for o, n in zip(old, new):
                self.map_out(o, n)
        elif isinstance(old, dict) and isinstance(new, dict):
            for k in old:
                self.map_out(old[k], new.get(k))

    def __call__(self) -> TraceCtx:
        from . import prims

        new_trace = TraceCtx(self.trace.fn)
        new_trace.args = self.trace.args
        new_trace._name = self.trace._name
        new_trace.device = self.trace.device
        for p in self.trace.args:
            new_trace.add_name(p.name)
        with tracectx(new_trace):
            for bsym in self.trace.bound_symbols:
                if bsym.sym.id == PrimIDs.RETURN:
                    prims.python_return(self.lookup(bsym.args[0] if len(bsym.args) == 1 else bsym.args))
                    continue
                if bsym.sym.id in (PrimIDs.DEL, PrimIDs.COMMENT, PrimIDs.UNPACK_TRIVIAL):
                    continue
                margs = self.lookup(bsym.args)
                mkwargs = self.lookup(bsym.kwargs)
                scope_start = len(new_trace.bound_symbols)
                replaced = self.visitor(bsym, margs, mkwargs)
                out = bsym.sym(*margs, **mkwargs) if replaced is None else replaced
                if bsym.tags:
                    # tags survive the rewrite: losing RECOMPUTE_IN_BACKWARD
                    # would silently disable activation checkpointing
                    for nb in new_trace.bound_symbols[scope_start:]:
                        nb.tags |= bsym.tags
                self.map_out(bsym.output, out)
        new_trace.side_effects = [(owner, name, self.lookup(p))
                                  for owner, name, p in self.trace.side_effects]
        return new_trace

