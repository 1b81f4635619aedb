"""FP8 training: delayed-scaling (amax-history) fp8 linears, forward and backward.

The port of thunder_tpu/transforms/fp8_training.py (TransformerEngine's
delayed scaling: the quantization scale of a tensor comes from the running
max of its amax history, so it is known before the tensor is produced).

- The per-linear amax histories of x and w are module BUFFERS, rolled by
  traced buffer writes (nn.update_buffer): jit and TrainStep replay them
  onto the module after the call, and the next step reads them as inputs.
- The recipe's default (history length) is the state object of the
  StatefulExecutor ``fp8_train_ex``; the margin rides each call as a static
  argument, so two models with different recipes do not reconfigure each
  other.
- The forward runs ``cudaex.fp8_linear`` (csrc/fp8_linear.cu: quantize x and
  w to e4m3, the product, the operand amaxes, in one launch) where its
  checker claims the shape: on the card the kernel, on the CPU its plain
  version. A shape the checker declines runs the unfused torch route below.
  The forward saves the e4m3 codes and the scales for the backward.
- The backward quantizes the incoming gradient to e5m2 with current scaling
  and runs two fp8 products, ``gq @ wq`` and ``gqᵀ @ xq``. As in thunder_tpu
  (``jnp.matmul`` outside any Pallas kernel) they are library products: on
  the card ``torch._scaled_mm`` (unit scales, f32 out, no fast
  accumulation) where its shape rules hold (every dimension a multiple of
  16), else — and on the CPU — the f32 product of the widened codes.
  ``BACKWARD_ROUTES`` counts which ran.

The arithmetic keeps the reference's order, so scales and codes are bit
for bit thunder_tpu's: ``fmt_max / safe / 2**margin`` (a true division:
torch's ``float / tensor`` multiplies by a reciprocal), then ``clip(x·s)``,
then the cast; ``acc / (sx·sw)``.
"""
from __future__ import annotations

import torch

from ..core import dtypes
from ..core.proxies import TensorProxy
from ..core.transform_common import Transform
from ..executors import cudaex, graphex
from ..extend import StatefulExecutor, register_executor
from ..nn.module import update_buffer
from .autodiff import VJPResult, register_augmented_forward, register_backward

E4M3_MAX = 448.0
E5M2_MAX = 57344.0

# which backward product ran, counted per product: "scaled_mm" on the card,
# "f32" (widened codes) on the CPU or for shapes _scaled_mm refuses
BACKWARD_ROUTES = {"scaled_mm": 0, "f32": 0}
for _route in BACKWARD_ROUTES:
    graphex.register_counter(BACKWARD_ROUTES, _route)  # a CUDA-graph replay counts its routes


class FP8Recipe:
    """Quantization recipe (TE DelayedScaling): history length, margin (the
    scale backs off by 2**margin); formats fixed e4m3 forward, e5m2 backward
    (the 'hybrid' recipe)."""

    def __init__(self, amax_history_len: int = 16, margin: int = 0):
        self.amax_history_len = amax_history_len
        self.margin = margin


fp8_train_ex = StatefulExecutor("fp8_train_ex")
register_executor(fp8_train_ex)


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """num / t as one rounded division, as jnp computes it."""
    return torch.full_like(t, num) / t


def _scale_from_hist(hist: torch.Tensor, fmt_max: float, margin: int) -> torch.Tensor:
    amax = torch.max(hist).float()
    safe = torch.clamp_min(amax, 1e-12)
    return torch.where(amax > 0.0, _rdiv(fmt_max, safe) / (2.0 ** margin), 1.0)


def _q(x: torch.Tensor, scale, fmt_max: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.clamp(x.float() * scale, -fmt_max, fmt_max).to(dtype)


def _forward(x, w, bias, hist_x, hist_w, margin, save_quantized):
    """(y in x's dtype, [xq, wq, sx, sw,] amax_x, amax_w)."""
    sx = _scale_from_hist(hist_x, E4M3_MAX, margin)
    sw = _scale_from_hist(hist_w, E4M3_MAX, margin)
    if cudaex.fp8_linear_supported(x, w):
        outs = cudaex.fp8_linear(x.contiguous(), w.contiguous(), sx, sw, fmt_max=E4M3_MAX,
                                 save_quantized=save_quantized)
        y, ax, aw = outs[0], outs[-2], outs[-1]
        xq, wq = outs[1:3] if save_quantized else (None, None)
    else:
        xq = _q(x, sx, E4M3_MAX, torch.float8_e4m3fn)
        wq = _q(w, sw, E4M3_MAX, torch.float8_e4m3fn)
        y = torch.matmul(xq.float(), wq.float().t()) / (sx * sw)
        ax = torch.max(torch.abs(x)).float()
        aw = torch.max(torch.abs(w)).float()
    if bias is not None:
        y = y + bias
    y = y.to(x.dtype)
    return (y, xq, wq, sx, sw, ax, aw) if save_quantized else (y, ax, aw)


def _linear_fwd_meta(x, w, bias, hist_x, hist_w, margin=0):
    # the operand amaxes come back as outputs: the kernel reduces them while
    # it quantizes, and the history roll reuses them instead of re-reading
    y = TensorProxy(shape=x.shape[:-1] + (w.shape[0],), dtype=x.dtype, device=x.device)
    ax = TensorProxy(shape=(), dtype=dtypes.float32, device=x.device)
    aw = TensorProxy(shape=(), dtype=dtypes.float32, device=x.device)
    return y, ax, aw


def _linear_fwd_impl(state: FP8Recipe, x, w, bias, hist_x, hist_w, margin=0):
    return _forward(x, w, bias, hist_x, hist_w, margin, False)


def _aug_fwd_meta(x, w, bias, hist_x, hist_w, margin=0):
    y = TensorProxy(shape=x.shape[:-1] + (w.shape[0],), dtype=x.dtype, device=x.device)
    xq = TensorProxy(shape=x.shape, dtype=dtypes.float8_e4m3, device=x.device)
    wq = TensorProxy(shape=w.shape, dtype=dtypes.float8_e4m3, device=x.device)
    # each output its own proxy: a reused proxy would alias sx and sw
    sx = TensorProxy(shape=(), dtype=dtypes.float32, device=x.device)
    sw = TensorProxy(shape=(), dtype=dtypes.float32, device=x.device)
    ax = TensorProxy(shape=(), dtype=dtypes.float32, device=x.device)
    aw = TensorProxy(shape=(), dtype=dtypes.float32, device=x.device)
    return y, xq, wq, sx, sw, ax, aw


def _aug_fwd_impl(state: FP8Recipe, x, w, bias, hist_x, hist_w, margin=0):
    return _forward(x, w, bias, hist_x, hist_w, margin, True)


def _linear_bwd_meta(xq, wq, sx, sw, has_bias, out_dtype, margin, do):
    dt = dtypes.to_dtype(out_dtype)
    dx = TensorProxy(shape=xq.shape, dtype=dt, device=do.device)
    dw = TensorProxy(shape=wq.shape, dtype=dt, device=do.device)
    if has_bias:
        return dx, dw, TensorProxy(shape=(wq.shape[0],), dtype=dt, device=do.device)
    return dx, dw


def _fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) e5m2 @ b (k, n) e4m3 -> (m, n) f32 sums of the exact
    products (see the module docstring for the route)."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type == "cuda" and m % 16 == 0 and k % 16 == 0 and n % 16 == 0:
        BACKWARD_ROUTES["scaled_mm"] += 1
        one = torch.ones((), dtype=torch.float32, device=a.device)
        # mat1 row-major, mat2 column-major
        return torch._scaled_mm(a.contiguous(), b.t().contiguous().t(), scale_a=one, scale_b=one,
                                out_dtype=torch.float32, use_fast_accum=False)
    BACKWARD_ROUTES["f32"] += 1
    return torch.matmul(a.float(), b.float())


def _linear_bwd_impl(state: FP8Recipe, xq, wq, sx, sw, has_bias, out_dtype, margin, do):
    # current-scaling e5m2 quantization of the incoming gradient
    g_amax = torch.clamp_min(torch.max(torch.abs(do)).float(), 1e-12)
    sg = _rdiv(E5M2_MAX, g_amax) / (2.0 ** margin)
    do2 = do.reshape(-1, do.shape[-1])
    gq = _q(do2, sg, E5M2_MAX, torch.float8_e5m2)
    xq2 = xq.reshape(-1, xq.shape[-1])
    dx = _fp8_mm(gq, wq) / (sg * sw)
    dw = _fp8_mm(gq.t(), xq2) / (sg * sx)
    dt = dtypes.to_torch_dtype(dtypes.to_dtype(out_dtype))
    dx = dx.reshape(xq.shape).to(dt)
    dw = dw.to(dt)
    if has_bias:
        return dx, dw, torch.sum(do2, 0).to(dt)
    return dx, dw


def _make_state():
    return FP8Recipe()


fp8_train_linear = fp8_train_ex.register_stateful_operator(
    "train_linear", _make_state, meta=_linear_fwd_meta, fn=_linear_fwd_impl)
_fp8_aug_fwd = fp8_train_ex.register_stateful_operator(
    "train_linear_aug", _make_state, meta=_aug_fwd_meta, fn=_aug_fwd_impl)
_fp8_bwd = fp8_train_ex.register_stateful_operator(
    "train_linear_bwd", _make_state, meta=_linear_bwd_meta, fn=_linear_bwd_impl)


def set_recipe(recipe: FP8Recipe) -> None:
    """Install a recipe on the executor's persistent state slots."""
    for name in ("train_linear", "train_linear_aug", "train_linear_bwd"):
        fp8_train_ex._states[f"fp8_train_ex.{name}"] = recipe


@register_augmented_forward(fp8_train_linear.id)
def _fp8_aug(x, w, bias, hist_x, hist_w, margin=0):
    y, xq, wq, sx, sw, ax, aw = _fp8_aug_fwd(x, w, bias, hist_x, hist_w, margin)
    return VJPResult((y, ax, aw), (xq, wq, sx, sw, bias is not None, x.dtype, margin))


@register_backward(fp8_train_linear.id)
def _fp8_bwd_rule(xq, wq, sx, sw, has_bias, out_dtype, margin, g, g_ax=None, g_aw=None):
    # g_ax, g_aw: cotangents of the amax outputs, which feed only the
    # history roll (buffer writes, not differentiated): zero, and dropped
    outs = _fp8_bwd(xq, wq, sx, sw, has_bias, out_dtype, margin, g)
    if has_bias:
        dx, dw, db = outs
        return dx, dw, db, None, None
    dx, dw = outs
    return dx, dw, None, None, None


class FP8TrainingTransform(Transform):
    """Swap Linear forwards for delayed-scaling fp8 linears (forward and
    backward).

    Composes with AutocastTransform: the fp8 symbol manages its own casts,
    and autocast's policy does not touch unknown symbol ids, so the ops
    around keep the bf16 policy while the targeted linears run fp8. A
    Linear whose smaller side is under ``min_features`` is left alone
    (small layers lose more accuracy than time; TE uses the same guard)."""

    def __init__(self, recipe: FP8Recipe | None = None, target_predicate=None, min_features: int = 256):
        self.recipe = recipe or FP8Recipe()
        self.target_predicate = target_predicate or (lambda name, mod: True)
        self.min_features = min_features

    def transform_module(self, tmodule) -> None:
        from .. import nn as _nn
        from ..ops import ltorch

        H = self.recipe.amax_history_len
        margin = self.recipe.margin
        root = tmodule.module if hasattr(tmodule, "module") else tmodule
        for name, mod in list(root.named_modules()):
            if not isinstance(mod, _nn.Linear) or not self.target_predicate(name, mod):
                continue
            w = mod.weight
            if min(w.shape) < self.min_features:
                continue
            mod.register_buffer("fp8_amax_x_hist", torch.zeros(H, dtype=torch.float32, device=w.device))
            mod.register_buffer("fp8_amax_w_hist", torch.zeros(H, dtype=torch.float32, device=w.device))

            def make_fwd(m):
                def forward(x):
                    hx = m.fp8_amax_x_hist
                    hw = m.fp8_amax_w_hist
                    shape = x.shape
                    x2 = ltorch.reshape(x, (-1, shape[-1])) if x.ndim != 2 else x
                    y, amax_x, amax_w = fp8_train_linear(x2, m._parameters["weight"], m._parameters.get("bias"),
                                                         hx, hw, margin)
                    if x.ndim != 2:
                        y = ltorch.reshape(y, shape[:-1] + (y.shape[-1],))
                    # roll the histories, newest amax at slot 0 (delayed
                    # scaling: the next step's scale sees this step's amax)
                    update_buffer(m, "fp8_amax_x_hist", ltorch.cat([ltorch.reshape(amax_x, (1,)), hx[:-1]], 0))
                    update_buffer(m, "fp8_amax_w_hist", ltorch.cat([ltorch.reshape(amax_w, (1,)), hw[:-1]], 0))
                    return y

                return forward

            mod.forward = make_fwd(mod)
