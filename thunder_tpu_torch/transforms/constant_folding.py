"""Constant folding: execute compile-time-constant subgraphs at transform time.

thunder_tpu/transforms/constant_folding.py for the port. Bsyms whose tensor
inputs are all trace constants (tensor_constant / full / iota chains) are
evaluated with torchex's implementations, on the trace's device, and
replaced by a single tensor_constant. The foldable set is thunder_tpu's:
prims only, no random, collective or don't-DCE op, no output above
``_MAX_FOLD_NUMEL`` elements."""
from __future__ import annotations

from ..core import prims
from ..core.prims import PrimIDs
from ..core.proxies import Proxy, TensorProxy, pyval
from ..core.symbol import OpTags
from ..core.trace import TraceCtx, from_trace
from ..core.transform_common import Transform, dce

_FOLDABLE_LEAF_IDS = {PrimIDs.TENSOR_CONSTANT, PrimIDs.FULL, PrimIDs.IOTA}
_MAX_FOLD_NUMEL = 1 << 22  # don't materialize giant constants


class ConstantFolding(Transform):
    def transform_traces_pre_autodiff(self, prologue_trc, computation_trc, *, compile_data=None):
        return prologue_trc, fold_constants(computation_trc)


def fold_constants(trace: TraceCtx) -> TraceCtx:
    from ..executors.torchex import ex as torch_ex

    # proxies with known constant values
    const_values: dict[str, object] = {}
    new_bsyms = []
    changed = False

    for bsym in trace.bound_symbols:
        sid = bsym.sym.id
        if sid in (PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.COMMENT, PrimIDs.UNPACK_TRIVIAL):
            new_bsyms.append(bsym)
            continue
        tensor_args = [a for a in bsym.flat_proxy_args() if isinstance(a, TensorProxy)]
        outs = bsym.flat_proxy_outs()
        foldable = (
            bool(tensor_args)
            and all(a.name in const_values for a in tensor_args)
            and not (OpTags.RANDOM_OP in bsym.sym.tags or OpTags.COLLECTIVE in bsym.sym.tags
                     or OpTags.DONT_DCE in bsym.sym.tags)
            and all(isinstance(o, TensorProxy) and o.numel <= _MAX_FOLD_NUMEL for o in outs)
            and bsym.sym.is_prim
        )
        impl = torch_ex.implmap.get(sid, (None, None))[0]
        if sid in _FOLDABLE_LEAF_IDS and bsym.sym.is_prim and not tensor_args:
            if impl is not None:
                try:
                    val = _run_bsym(bsym, impl, const_values)
                    for o, v in zip(outs, val if isinstance(val, tuple) else (val,)):
                        const_values[o.name] = v
                except Exception:
                    pass
            new_bsyms.append(bsym)
            continue
        if foldable and impl is not None:
            try:
                val = _run_bsym(bsym, impl, const_values)
            except Exception:
                new_bsyms.append(bsym)
                continue
            vals = val if isinstance(val, tuple) else (val,)
            for o, v in zip(outs, vals):
                const_values[o.name] = v
            # replace with tensor_constant bsym(s)
            for o, v in zip(outs, vals):
                new_bsyms.append(prims.tensor_constant.bind(v, output=o))
            changed = True
            continue
        new_bsyms.append(bsym)

    if not changed:
        return trace
    out = from_trace(trace)
    out.bound_symbols = new_bsyms
    out.set_provenance("Constant folding")
    return dce(out)


def _run_bsym(bsym, impl, const_values):
    def sub(x):
        if isinstance(x, TensorProxy) and x.name in const_values:
            return const_values[x.name]
        if isinstance(x, (tuple, list)):
            return type(x)(sub(e) for e in x)
        if isinstance(x, dict):
            return {k: sub(v) for k, v in x.items()}
        if isinstance(x, Proxy):
            return pyval(x)
        return x

    return impl(*sub(bsym.args), **sub(bsym.kwargs))
