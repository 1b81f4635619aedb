"""FP8 inference transform: e4m3 weights with per-channel scales.

thunder_tpu/transforms/fp8_inference.py for the port (the counterpart of
the reference's TransformerEngine inference linears). Each Linear's weight
is stored in float8_e4m3fn with a per-output-channel f32 scale; every call
quantizes x to e4m3 with one per-tensor dynamic scale (current scaling,
``max|x| / 448``, computed on x's device) and multiplies the codes with an
f32 sum, then applies ``acc * (x_scale * scale)``, adds the bias and casts
to x's dtype, in thunder_tpu's order.

thunder_tpu's product is a ``jnp.matmul(..., preferred_element_type=f32)``
outside any Pallas kernel, so on the card it is the library's fp8 product:
``torch._scaled_mm`` on the codes with unit scales and an f32 output. It
wants K and N multiples of 16; a shape it cannot take raises
``FP8ShapeError``, naming the layer's shape. On the CPU the product is the
f32 product of the widened codes (each e4m3 product is exact in f32).
``SCALED_MM_CALLS`` counts the card's products; a CUDA-graph replay adds
its capture's count."""
from __future__ import annotations

import functools

import torch

from ..core.proxies import TensorProxy
from ..core.symbol import OpTags, Symbol
from ..core.transform_common import Transform
from ..executors import graphex
from ..nn.module import Parameter

E4M3_MAX = 448.0

SCALED_MM_CALLS = {"scaled_mm": 0}
graphex.register_counter(SCALED_MM_CALLS, "scaled_mm")


class FP8ShapeError(ValueError):
    """A shape ``torch._scaled_mm`` cannot take: the fp8 linear has no other
    route on the card."""


def quantize_fp8_weight(w: torch.Tensor) -> tuple:
    """w (out, in) -> (e4m3 weights, f32 per-row scales). ``amax / 448``
    is taken in w's dtype and then widened, as thunder_tpu takes it."""
    amax = torch.clamp_min(w.abs().amax(dim=1, keepdim=True), 1e-12)
    scale = (amax / E4M3_MAX).to(torch.float32)
    q = (w.float() / scale).to(torch.float8_e4m3fn)
    return q, scale[:, 0]


def _fp8_linear_meta(x, qweight, scale, bias=None):
    return TensorProxy(shape=x.shape[:-1] + (qweight.shape[0],), dtype=x.dtype, device=x.device)


@functools.lru_cache(maxsize=None)
def _unit_scale(device: torch.device) -> torch.Tensor:
    # one a device, made outside any capture
    return torch.ones((), dtype=torch.float32, device=device)


def _codes_product(xq: torch.Tensor, qweight: torch.Tensor) -> torch.Tensor:
    """(M, K) x (N, K) e4m3 codes -> (M, N) f32 sums."""
    if xq.device.type == "cpu":
        return torch.matmul(xq.float(), qweight.float().t())
    M, K = xq.shape
    N = qweight.shape[0]
    if K % 16 or N % 16:
        raise FP8ShapeError(f"fp8 linear: torch._scaled_mm needs K and N multiples of 16, got "
                            f"x ({M}, {K}) against weights ({N}, {K})")
    SCALED_MM_CALLS["scaled_mm"] += 1
    one = _unit_scale(xq.device)
    # mat2 column-major: the (N, K) row-major weights, transposed
    return torch._scaled_mm(xq, qweight.t(), scale_a=one, scale_b=one, out_dtype=torch.float32,
                            use_fast_accum=False)


def fp8_linear_impl(x, qweight, scale, bias=None):
    """thunder_tpu's _fp8_linear_impl in torch: the per-tensor scale in x's
    dtype, then widened; x divided in f32 and cast to e4m3; the f32 product;
    ``acc * (x_scale * scale)``; the bias; one cast to x's dtype."""
    x_amax = torch.clamp_min(x.abs().amax(), 1e-12)
    x_scale = (x_amax / E4M3_MAX).to(torch.float32)
    xq = (x.float() / x_scale).to(torch.float8_e4m3fn)
    acc = _codes_product(xq.reshape(-1, x.shape[-1]).contiguous(), qweight).reshape(*x.shape[:-1],
                                                                                  qweight.shape[0])
    out = acc * (x_scale * scale[None, :])
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


fp8_linear = Symbol("fp8_linear", _fp8_linear_meta, id="fp8.linear", is_prim=True, module="fp8",
                    tags=(OpTags.MATMUL_OP,))


def _register() -> None:
    from ..executors import torchex

    torchex.ex.register_implementation(fp8_linear.id, fp8_linear_impl)


_register()


class FP8LinearInference(Transform):
    """Swap Linear weights to float8_e4m3 for inference (no backward).
    Layers with a dimension under ``min_features`` stay in high precision:
    they lose more accuracy than time."""

    def __init__(self, target_predicate=None, min_features: int = 64):
        self.target_predicate = target_predicate or (lambda name, mod: True)
        self.min_features = min_features

    def transform_module(self, tmodule) -> None:
        from .. import nn as _nn

        root = tmodule.module if hasattr(tmodule, "module") else tmodule
        for name, mod in list(root.named_modules()):
            if not isinstance(mod, _nn.Linear) or not self.target_predicate(name, mod):
                continue
            w = mod.weight.detach()
            if min(w.shape) < self.min_features:
                continue
            with torch.no_grad():
                q, s = quantize_fp8_weight(w)
            mod._parameters["weight"] = Parameter(q, requires_grad=False)
            mod.register_parameter("fp8_scale", Parameter(s, requires_grad=False))

            def make_fwd(m):
                def forward(x):
                    return fp8_linear(x, m._parameters["weight"], m._parameters["fp8_scale"],
                                      m._parameters.get("bias"))

                return forward

            mod.forward = make_fwd(mod)
