"""Execution passes: executor claiming and in-place writes.

The claim pass of thunder_tpu/executors/passes.py: an operator symbol is
run by the executor that owns it; everything else is claimed in priority
order (executor impl at the bsym's level → descend into subsymbols → error
on unclaimed prims), then eager frees. There is no
fusion pass yet: every claimed bsym runs as its own torch call or kernel.

One pass is new: ``write_dead_inputs_in_place``. JAX's arrays are immutable,
so thunder_tpu's serving programs return updated KV pools and the caller
rebinds them. Done out of place in torch, that copies every layer's pool on
every step. Where a program input is read by exactly one ``index_put`` and by
nothing else, the update is made in place on that input instead: the
program's output then IS the caller's tensor, written. This is a difference
from thunder_tpu: such an input is consumed by the call."""
from __future__ import annotations

import time
from typing import Sequence

from ..core.prims import PrimIDs
from ..core.symbol import BoundSymbol
from ..core.trace import TraceCtx, from_trace
from ..core.transform_common import del_last_used
from ..extend import OperatorExecutor, get_always_executors

_STRUCTURAL = (PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.COMMENT, PrimIDs.UNPACK_TRIVIAL)


def transform_for_execution(trace: TraceCtx, executors: Sequence[OperatorExecutor]) -> TraceCtx:
    start = time.perf_counter()
    executors = list(executors)
    for al in get_always_executors():
        if al not in executors:
            executors.append(al)

    out_bsyms: list[BoundSymbol] = []

    def lower(bsym: BoundSymbol):
        if bsym.sym.id in _STRUCTURAL:
            out_bsyms.append(bsym)
            return
        if bsym.sym.python_impl is not None and bsym.impl is None:
            # pure-python symbols (prologue checks) execute directly
            out_bsyms.append(bsym.with_impl(bsym.sym.python_impl))
            return
        for ex in ([bsym.sym.executor] if bsym.sym.executor is not None else executors):
            impl = ex.claim(bsym)
            if impl is not None:
                out_bsyms.append(bsym.with_impl(impl))
                return
        if bsym.subsymbols:
            for sub in bsym.subsymbols:
                lower(sub)
            return
        if not bsym.sym.is_prim:
            # composite that recorded nothing: a pure pass-through (e.g. a
            # full-range getitem) — outputs are existing proxies, nothing to run
            out_names = {o.name for o in bsym.flat_proxy_outs()}
            in_names = {a.name for a in bsym.flat_proxy_args()}
            if out_names <= in_names:
                return
        raise RuntimeError(
            f"no executor can run {bsym.sym.name} (id={bsym.sym.id}); "
            f"tried {[e.name for e in executors]}"
        )

    for bsym in trace.bound_symbols:
        lower(bsym)

    claimed = from_trace(trace)
    claimed.bound_symbols = out_bsyms
    claimed.set_provenance(
        f"Transform for execution (took {(time.perf_counter()-start)*1000:.2f} ms)"
    )
    claimed = write_dead_inputs_in_place(claimed)
    # eager frees for op-by-op execution: a buffer is released right after
    # its last use, which bounds the program's peak memory
    return del_last_used(claimed)


def write_dead_inputs_in_place(trace: TraceCtx) -> TraceCtx:
    """Swap the out-of-place ``index_put`` impl for the in-place one where
    its target is a program input that no other bound symbol reads (so no
    view of it and no later reader can see the write)."""
    from . import torchex

    arg_names = {p.name for p in trace.args}
    readers: dict[str, int] = {}
    for bsym in trace.bound_symbols:
        if bsym.sym.id in _STRUCTURAL and bsym.sym.id != PrimIDs.RETURN:
            continue
        for p in {p.name for p in bsym.flat_proxy_args()}:
            readers[p] = readers.get(p, 0) + 1
    out = []
    for bsym in trace.bound_symbols:
        if bsym.impl is torchex.index_put_out_of_place:
            target = bsym.args[0].name
            if target in arg_names and readers.get(target) == 1:
                bsym = bsym.with_impl(torchex.index_put_in_place)
        out.append(bsym)
    new = from_trace(trace)
    new.bound_symbols = out
    new.set_provenance("Write dead inputs in place")
    return new
