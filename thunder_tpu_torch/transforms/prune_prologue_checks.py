"""Remove prologue metadata checks (trusted-input fast path).

thunder_tpu/transforms/prune_prologue_checks.py for the port, against the
prologue ``build_prologue`` (__init__.py) makes."""
from __future__ import annotations

from ..core.prims import PrimIDs
from ..core.trace import from_trace
from ..core.transform_common import Transform

_CHECK_IDS = (PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA, PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
              PrimIDs.CHECK_LITERAL_LIKE)


class PrunePrologueChecks(Transform):
    def transform_traces_pre_autodiff(self, prologue_trc, computation_trc, *, compile_data=None):
        if prologue_trc is None:
            return prologue_trc, computation_trc
        out = from_trace(prologue_trc)
        out.bound_symbols = [b for b in prologue_trc.bound_symbols if b.sym.id not in _CHECK_IDS]
        out.set_provenance("Prune prologue checks")
        return out, computation_trc


class ExtractionOnlyPrologueTransform(PrunePrologueChecks):
    """Keep only extraction (unpack) prims in the prologue (thunder_tpu's
    class of the same name). The prologue's non-check content is exactly
    the unpacks, so this shares the check-pruning implementation; it exists
    as a distinct name so recipes can request that semantics explicitly."""
