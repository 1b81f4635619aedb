"""Autocast: mixed-precision policy as a trace transform.

thunder_tpu/transforms/autocast.py for the port, with the same policy:
matmul-class ops run in the low-precision compute dtype (inputs cast down),
normalizations and softmaxes stay f32. Applied by re-interpreting the
computation trace with casts inserted at op boundaries, or, inside a
forward, by the ``autocast_ctx`` region at symbol-bind time."""
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

    def _policy(self, sym, args, kwargs):
        """(args, kwargs) with this autocast's casts for sym applied."""
        to, sid = self.dtype, sym.id
        if sid == "thunder.rope_sdpa":
            # cast only q/k/v: the cos/sin caches stay f32 (bf16 rope
            # angles lose precision at large positions)
            return tuple(self._cast(a, to) if i < 3 else a for i, a in enumerate(args)), kwargs
        if sid in _LOW_PRECISION_IDS:
            return tuple(self._cast(a, to) for a in args), {k: self._cast(v, to) for k, v in kwargs.items()}
        if sid in _F32_IDS:
            return tuple(self._cast(a, dtypes.float32) for a in args), kwargs
        return args, kwargs

    def transform_traces_pre_autodiff(self, prologue_trc, computation_trc, *, compile_data=None):
        def visitor(bsym, args, kwargs):
            sid = bsym.sym.id
            if sid != "thunder.rope_sdpa" and sid not in _LOW_PRECISION_IDS and sid not in _F32_IDS:
                return None
            args, kwargs = self._policy(bsym.sym, args, kwargs)
            return bsym.sym(*args, **kwargs)

        new_trc = TraceSubstitutionProcessor(computation_trc, visitor)()
        new_trc.set_provenance(f"Autocast to {self.dtype.name}")
        return prologue_trc, new_trc


class autocast_ctx:
    """In-forward autocast region, the torch.amp.autocast analog
    (thunder_tpu/transforms/autocast.py:autocast_ctx):

        def forward(self, x):
            with autocast_ctx(dtypes.bfloat16):
                h = ltorch.linear(x, self.w1)   # runs in bf16
            return ltorch.linear(h, self.w2)    # stays f32

    Applied at symbol-bind time (core/symbol.py's hook) with
    AutocastTransform's policy, so the inserted casts are ordinary trace
    bsyms: they survive autodiff and compose with nesting and
    ``enabled=False`` as torch's context manager does."""

    def __init__(self, dtype=dtypes.bfloat16, enabled: bool = True):
        self.dtype = dtypes.to_dtype(dtype)
        self.enabled = enabled
        self._impl = AutocastTransform(self.dtype)

    def __enter__(self):
        from ..core import symbol as _symbol

        _symbol._autocast_stack.append(self._impl._policy if self.enabled else None)
        return self

    def __exit__(self, *exc):
        from ..core import symbol as _symbol

        _symbol._autocast_stack.pop()
        return False
