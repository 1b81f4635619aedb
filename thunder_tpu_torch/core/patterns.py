"""Declarative pattern matching over BoundSymbol sequences.

thunder_tpu/core/patterns.py for the port, over the port's BoundSymbols
and ``from_trace``, unchanged in behaviour: a ``Pattern`` is a
list of op matchers; ``match`` scans a trace for dataflow-connected bsym
sequences that satisfy them, and ``replace`` rewrites each match via a
user-supplied builder traced into fresh bsyms. Used to recognize fusable
families (e.g. dequant->matmul, rmsnorm chains) before executor claiming.

A matcher step accepts bsyms by symbol id (or a predicate) and may bind
proxies to names so later steps can require dataflow connectivity
(``uses('x')``) and the replacement builder can refer to them.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from .proxies import Proxy, variableify
from .symbol import BoundSymbol
from .trace import TraceCtx, from_trace, tracectx


class MatchState:
    """A partial match: matched bsyms + proxy bindings."""

    def __init__(self):
        self.bsyms: list[BoundSymbol] = []
        self.bindings: dict[str, Any] = {}

    def copy(self) -> "MatchState":
        m = MatchState()
        m.bsyms = list(self.bsyms)
        m.bindings = dict(self.bindings)
        return m

    def __repr__(self):
        return f"<Match of {[b.sym.name for b in self.bsyms]}>"


class OpMatcher:
    def __init__(
        self,
        op,
        *,
        where: Callable[[BoundSymbol, MatchState], bool] | None = None,
        bind_args: Sequence[str | None] = (),
        bind_out: str | None = None,
    ):
        self.ids = tuple(o.id if hasattr(o, "id") else o for o in (op if isinstance(op, (tuple, list)) else (op,)))
        self.where = where
        self.bind_args = tuple(bind_args)
        self.bind_out = bind_out

    def try_match(self, bsym: BoundSymbol, state: MatchState) -> Optional[MatchState]:
        if bsym.sym.id not in self.ids:
            return None
        if self.where is not None and not self.where(bsym, state):
            return None
        ns = state.copy()
        for name, arg in zip(self.bind_args, bsym.args):
            if name is None:
                continue
            # a name bound earlier must re-match the same proxy (dataflow join)
            prev = ns.bindings.get(name)
            if prev is not None and isinstance(prev, Proxy) and isinstance(arg, Proxy):
                if variableify(prev) != variableify(arg):
                    return None
            ns.bindings[name] = arg
        if self.bind_out is not None:
            ns.bindings[self.bind_out] = bsym.output
        ns.bsyms.append(bsym)
        return ns


def uses(name: str) -> Callable[[BoundSymbol, MatchState], bool]:
    """Predicate: the candidate bsym consumes the proxy bound to ``name``."""

    def pred(bsym: BoundSymbol, state: MatchState) -> bool:
        bound = state.bindings.get(name)
        if not isinstance(bound, Proxy):
            return False
        v = variableify(bound)
        return any(variableify(a) == v for a in bsym.flat_proxy_args())

    return pred


class Pattern:
    """An ordered sequence of OpMatchers. Steps must appear in trace order but
    need not be adjacent; interleaved bsyms are allowed as long as they do not
    consume intermediate (non-final) outputs of the match (which would make
    removal unsound)."""

    def __init__(self):
        self._steps: list[OpMatcher] = []

    def match_op(self, op, *, where=None, bind_args=(), bind_out=None) -> "Pattern":
        self._steps.append(OpMatcher(op, where=where, bind_args=bind_args, bind_out=bind_out))
        return self

    # -- scanning --

    def _extend(self, bsyms: Sequence[BoundSymbol], start: int, step_i: int, state: MatchState,
                indices: list[int]) -> Optional[tuple[MatchState, list[int]]]:
        if step_i == len(self._steps):
            return state, indices
        for j in range(start, len(bsyms)):
            ns = self._steps[step_i].try_match(bsyms[j], state)
            if ns is not None:
                found = self._extend(bsyms, j + 1, step_i + 1, ns, indices + [j])
                if found is not None:
                    return found
        return None

    def _intermediates_escape(self, bsyms: Sequence[BoundSymbol], indices: list[int], state: MatchState) -> bool:
        """True if a non-final matched output is consumed outside the match."""
        idxset = set(indices)
        inner_outs = set()
        for i in indices[:-1]:
            for o in bsyms[i].flat_proxy_outs():
                inner_outs.add(variableify(o))
        for j, bsym in enumerate(bsyms):
            if j in idxset:
                continue
            for a in bsym.flat_proxy_args():
                if variableify(a) in inner_outs:
                    return True
        return False

    def match(self, trace: TraceCtx) -> list[tuple[MatchState, list[int]]]:
        """All non-overlapping matches as (state, bsym indices)."""
        bsyms = trace.bound_symbols
        matches: list[tuple[MatchState, list[int]]] = []
        claimed: set[int] = set()
        pos = 0
        while pos < len(bsyms):
            found = self._extend(bsyms, pos, 0, MatchState(), [])
            if found is None:
                break
            state, indices = found
            if any(i in claimed for i in indices) or self._intermediates_escape(bsyms, indices, state):
                pos = indices[0] + 1
                continue
            matches.append((state, indices))
            claimed.update(indices)
            pos = indices[0] + 1
        return matches

    def replace(self, trace: TraceCtx, builder: Callable[..., Any]) -> TraceCtx:
        """Rewrite each match: ``builder(**bindings)`` is traced and must
        return the replacement for the final matched bsym's output. Matched
        bsyms are dropped; the builder's bsyms are spliced at the site of the
        last matched op, and downstream uses of the old output are renamed."""
        matches = self.match(trace)
        if not matches:
            return trace
        new_trace = from_trace(trace)
        drop: set[int] = set()
        splice: dict[int, list[BoundSymbol]] = {}
        replacements: dict[str, Proxy] = {}
        for state, indices in matches:
            old_out_proxies = [p for p in trace.bound_symbols[indices[-1]].flat_proxy_outs()]
            with tracectx(new_trace) as trc:
                with trc.push_scope() as recorded:
                    new_out = builder(**state.bindings)
            new_out_proxies = [p for p in _flat(new_out) if isinstance(p, Proxy)]
            for old, new in zip(old_out_proxies, new_out_proxies):
                replacements[old.name] = new
            drop.update(indices)
            splice[indices[-1]] = list(recorded)

        def sub(x):
            if isinstance(x, Proxy) and x.name in replacements:
                return replacements[x.name]
            if isinstance(x, tuple):
                return tuple(sub(e) for e in x)
            if isinstance(x, list):
                return [sub(e) for e in x]
            if isinstance(x, dict):
                return {k: sub(v) for k, v in x.items()}
            return x

        out_bsyms: list[BoundSymbol] = []
        for i, bsym in enumerate(trace.bound_symbols):
            if i in splice:
                # spliced builder bsyms also need the rename: with chained
                # matches a later builder may consume an earlier match's
                # (now-dropped) output
                out_bsyms.extend(b.replace(args=sub(b.args), kwargs=sub(b.kwargs)) for b in splice[i])
            if i in drop:
                continue
            out_bsyms.append(bsym.replace(args=sub(bsym.args), kwargs=sub(bsym.kwargs)))
        new_trace.bound_symbols = out_bsyms
        new_trace.set_provenance(f"Pattern replacement ({len(matches)} site(s))")
        return new_trace


def _flat(x):
    if isinstance(x, (tuple, list)):
        for e in x:
            yield from _flat(e)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _flat(v)
    else:
        yield x
