"""Autocast: mixed-precision policy as a trace transform.

thunder_tpu/transforms/autocast.py for the port, with the same policy:
matmul-class ops run in the low-precision compute dtype (inputs cast down),
normalizations and softmaxes stay f32. Applied by re-interpreting the
computation trace with casts inserted at op boundaries. The in-forward
``autocast_ctx`` region waits for a later slice."""
from __future__ import annotations

from ..core import dtypes, prims
from ..core.prims import PrimIDs
from ..core.proxies import TensorProxy
from ..core.trace_interpreter import TraceSubstitutionProcessor
from ..core.transform_common import Transform

# ops computed in the autocast dtype (inputs cast down) — both the prim ids
# and the ltorch-level symbol ids (acquired traces record the latter at top
# level). The embedding weight is cast too, which keeps the residual stream
# (the dominant saved-for-backward tensors) low-precision.
_LOW_PRECISION_IDS = {
    PrimIDs.MATMUL,
    PrimIDs.LINEAR,
    PrimIDs.CONVOLUTION,
    PrimIDs.GROUPED_MM,
    "torch.matmul",
    "torch.mm",
    "torch.bmm",
    "torch.einsum",
    "torch.nn.functional.linear",
    "torch.nn.functional.conv2d",
    "torch.nn.functional.conv1d",
    "torch.nn.functional.scaled_dot_product_attention",
    "torch.nn.functional.embedding",
}
# composite ops forced to f32 compute (their decompositions stay f32).
# cross_entropy is not here: its grad rule upcasts internally, while a
# trace-level cast would materialize the full (B*T, vocab) logits in f32.
_F32_IDS = {
    "torch.nn.functional.layer_norm",
    "torch.nn.functional.rms_norm",
    "torch.softmax",
    "torch.log_softmax",
}


class AutocastTransform(Transform):
    def __init__(self, dtype: dtypes.dtype = dtypes.bfloat16):
        self.dtype = dtypes.to_dtype(dtype)

    def _cast(self, x, to):
        if isinstance(x, TensorProxy) and x.dtype.is_float and x.dtype != to:
            return prims.convert_element_type(x, to)
        return x

    def transform_traces_pre_autodiff(self, prologue_trc, computation_trc, *, compile_data=None):
        to = self.dtype

        def visitor(bsym, args, kwargs):
            if bsym.sym.id == "thunder.rope_sdpa":
                # cast only q/k/v: the cos/sin caches stay f32 (bf16 rope
                # angles lose precision at large positions)
                args = tuple(self._cast(a, to) if i < 3 else a for i, a in enumerate(args))
                return bsym.sym(*args, **kwargs)
            if bsym.sym.id in _LOW_PRECISION_IDS:
                args = tuple(self._cast(a, to) for a in args)
                kwargs = {k: self._cast(v, to) for k, v in kwargs.items()}
                return bsym.sym(*args, **kwargs)
            if bsym.sym.id in _F32_IDS:
                args = tuple(self._cast(a, dtypes.float32) for a in args)
                return bsym.sym(*args, **kwargs)
            return None

        new_trc = TraceSubstitutionProcessor(computation_trc, visitor)()
        new_trc.set_provenance(f"Autocast to {to.name}")
        return prologue_trc, new_trc
