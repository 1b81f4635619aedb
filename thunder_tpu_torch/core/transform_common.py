"""Common trace-to-trace passes (dce, cse, flatten_to_prims, del_last_used)
and the ``Transform`` base of the compile pipeline.

The passes and the Transform of thunder_tpu/core/transform_common.py.
"""
from __future__ import annotations

import time

from .prims import PrimIDs
from .proxies import Proxy, variableify
from .symbol import BoundSymbol, OpTags
from .trace import TraceCtx, from_trace


def _has_tag(bsym: BoundSymbol, tag: str) -> bool:
    return tag in bsym.sym.tags or tag in bsym.tags


def dce(trace: TraceCtx) -> TraceCtx:
    """Dead-code elimination: backward mark/sweep from RETURN and DONT_DCE ops
    (reference thunder/core/transform_common.py:145)."""
    start = time.perf_counter()
    needed: set = set()
    out_bsyms: list[BoundSymbol] = []
    for bsym in reversed(trace.bound_symbols):
        keep = _has_tag(bsym, OpTags.DONT_DCE) or bsym.sym.id in (PrimIDs.RETURN, PrimIDs.COMMENT)
        if not keep:
            for o in bsym.flat_proxy_outs():
                if variableify(o) in needed:
                    keep = True
                    break
        if keep:
            out_bsyms.append(bsym)
            for a in bsym.flat_proxy_args():
                needed.add(variableify(a))
    new_trace = from_trace(trace)
    new_trace.bound_symbols = list(reversed(out_bsyms))
    new_trace.set_provenance(f"Dead Code Elimination (took {(time.perf_counter()-start)*1000:.2f} ms)")
    return new_trace


def cse(trace: TraceCtx) -> TraceCtx:
    """Common subexpression elimination over bsym RHS keys
    (reference thunder/core/transform_common.py:292)."""
    start = time.perf_counter()
    seen: dict = {}
    replacements: dict = {}  # var name -> replacement proxy

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

    new_bsyms: list[BoundSymbol] = []
    for bsym in trace.bound_symbols:
        if _has_tag(bsym, OpTags.RANDOM_OP) or _has_tag(bsym, OpTags.DONT_DCE) or _has_tag(bsym, OpTags.COLLECTIVE) \
                or bsym.sym.id in (PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.UNPACK_TRIVIAL):
            new_bsyms.append(bsym.replace(args=sub(bsym.args), kwargs=sub(bsym.kwargs)))
            continue
        nb = bsym.replace(args=sub(bsym.args), kwargs=sub(bsym.kwargs))
        key = nb.rhs
        prev = seen.get(key)
        if prev is not None:
            for old_o, new_o in zip(nb.flat_proxy_outs(), prev.flat_proxy_outs()):
                replacements[old_o.name] = new_o
            continue
        seen[key] = nb
        new_bsyms.append(nb)
    new_trace = from_trace(trace)
    new_trace.bound_symbols = new_bsyms
    new_trace.set_provenance(f"Common Subexpression Elimination (took {(time.perf_counter()-start)*1000:.2f} ms)")
    return new_trace



def flatten_to_prims(trace: TraceCtx, *, keep=None) -> TraceCtx:
    """Expand composite bsyms into their prim subsymbols
    (thunder_tpu/core/transform_common.py:flatten_to_prims). ``keep(bsym)``
    stops the descent (e.g. executor-claimed composites stay whole)."""
    new_bsyms: list[BoundSymbol] = []

    def rec(bsym: BoundSymbol):
        if (keep is not None and keep(bsym)) or not bsym.subsymbols:
            new_bsyms.append(bsym)
            return
        for sub in bsym.subsymbols:
            rec(sub)

    for bsym in trace.bound_symbols:
        rec(bsym)
    new_trace = from_trace(trace)
    new_trace.bound_symbols = new_bsyms
    new_trace.set_provenance("Flatten to prims")
    return new_trace


def del_last_used(trace: TraceCtx) -> TraceCtx:
    """Insert DEL statements after last proxy use so the op-by-op executor
    frees buffers eagerly (reference thunder/executors/passes.py:261). Fused
    whole-trace execution does not need this, but op-by-op debugging does."""
    from . import prims

    start = time.perf_counter()
    seen: set = set()
    out: list[BoundSymbol] = []
    arg_names = {p.name for p in trace.args}
    protected: set = set()
    for bsym in trace.bound_symbols:
        # UNPACK_TRIVIAL prints no code, so its proxies have no local binding
        if bsym.sym.id == PrimIDs.UNPACK_TRIVIAL:
            for p in list(bsym.flat_proxy_args()) + list(bsym.flat_proxy_outs()):
                protected.add(p.name)
    for bsym in reversed(trace.bound_symbols):
        if bsym.sym.id in (PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.COMMENT, PrimIDs.UNPACK_TRIVIAL):
            for p in bsym.flat_proxy_args():
                seen.add(variableify(p))
            out.append(bsym)
            continue
        to_del = []
        for p in bsym.flat_proxy_args():
            v = variableify(p)
            if v not in seen and p.name not in arg_names and p.name not in protected:
                seen.add(v)
                to_del.append(p)
        for p in bsym.flat_proxy_outs():
            seen.add(variableify(p))
        if to_del:
            out.append(prims.python_del.bind(*to_del, output=None))
        out.append(bsym)
    new_trace = from_trace(trace)
    new_trace.bound_symbols = list(reversed(out))
    new_trace.set_provenance(f"Delete Last Used (took {(time.perf_counter()-start)*1000:.2f} ms)")
    return new_trace


class Transform:
    """User-extensible compile-pipeline hook (thunder_tpu/core/transform_common.py:142).

    Subclasses override any of:
      - transform_module(module): eager module rewrite at registration time
      - transform_traces_pre_autodiff(prologue_trc, computation_trc, **kwargs)
      - transform_trace_post_optimization(trc, **kwargs)
    """

    def transform_module(self, module) -> None:
        return None

    def transform_traces_pre_autodiff(self, prologue_trc, computation_trc, *, compile_data=None):
        return prologue_trc, computation_trc

    def transform_trace_post_optimization(self, trc, *, compile_data=None):
        return trc

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"
