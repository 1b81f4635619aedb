"""Trace-level autodiff: augmented-forward + backward trace construction.

thunder_tpu/transforms/autodiff.py for the port. The transform walks the
acquired trace top-down: a bsym whose symbol id has a registered VJP rule is
differentiated at that level (this is how executor-claimed grads work — the
cuda executor registers a rule for ``thunder.rope_sdpa`` and is never
decomposed); otherwise the walk descends into subsymbols down to prims. The
result is two traces — augmented forward (returns outputs + saved-for-
backward) and backward (saved + cotangents → input grads) — each claimed by
the executors and run op by op.

Activation checkpointing (transforms/remat.py:checkpoint,
``Config.activation_checkpoint``) tags bsyms RECOMPUTE_IN_BACKWARD. Every
proxy the augmented forward produces for a tagged bsym may be re-derived in
the backward instead of saved: ``_plan_recompute`` swaps the tagged
residuals for the minimal forward subgraph that re-derives them (saving its
external inputs instead), and the backward replays that subgraph lazily,
right before the first grad rule that reads one of its outputs.

Of the ops whose gradient thunder_tpu takes from ``jax.vjp`` of their jax
implementation, most have rules written out here; the rest
(VJP_FALLBACK_OPS: GROUPED_MM, EINSUM, SCATTER) take theirs from
``torch.func.vjp`` of torchex's implementation, recorded in the backward
trace as the ``torch.vjp_fallback`` operator. There is no interpreter
frontend yet: programs are acquired by direct proxy tracing."""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Sequence

import torch

from ..common import apply_effects
from ..core import dtypes, prims
from ..core.codeutils import flat_proxies
from ..core.prims import PrimIDs
from ..core.proxies import AnyProxy, NumberProxy, Proxy, TensorProxy, pyval
from ..core.symbol import OpTags
from ..core.trace import TraceCtx, tracectx
from ..core.transform_common import dce
from ..ops import clang


class VJPResult(NamedTuple):
    out: Any
    residuals: tuple


augmented_forward_impls: dict[Any, Callable] = {}
backward_impls: dict[Any, Callable] = {}


def register_augmented_forward(sym_id):
    def deco(fn):
        augmented_forward_impls[sym_id] = fn
        return fn

    return deco


def register_backward(sym_id):
    def deco(fn):
        backward_impls[sym_id] = fn
        return fn

    return deco


def register_grad(sym_id, aug_fwd, bwd):
    augmented_forward_impls[sym_id] = aug_fwd
    backward_impls[sym_id] = bwd


def has_grad_rule(sym_id) -> bool:
    return sym_id in augmented_forward_impls


# ops whose gradient thunder_tpu takes from jax.vjp of their jax impl
# (JAX_VJP_FALLBACK there) and that have no rule written out here: their
# gradients come from torch.func.vjp of torchex's impl (_fallback_grad
# below). The rest of thunder_tpu's set has explicit rules below
# (convolution, conv_transpose, reduce_window, var, atan2, cumsum, cumprod,
# digamma, copy_with_setitem) and dist.ring_attention in
# parallel/context_parallel.py.
VJP_FALLBACK_OPS: set = {PrimIDs.GROUPED_MM, PrimIDs.EINSUM, PrimIDs.SCATTER}


# ---------------------------------------------------------------------------
# helpers used inside rules
# ---------------------------------------------------------------------------


def _sum_to_shape(g: TensorProxy, shape: tuple) -> TensorProxy:
    """Reduce a broadcasted gradient back to `shape`."""
    if tuple(g.shape) == tuple(shape):
        return g
    # sum leading extra dims
    extra = g.ndim - len(shape)
    if extra > 0:
        g = prims.sum_prim(g, tuple(range(extra)))
    # sum dims that were 1
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    if dims:
        g = prims.sum_prim(g, dims)
        # restore kept dims
        new_shape = tuple(1 if i in dims else s for i, s in enumerate(shape))
        g = prims.reshape(g, new_shape)
    return g


def _zeros_like(t: TensorProxy) -> TensorProxy:
    return clang.full_like(t, 0)


# ---------------------------------------------------------------------------
# elementwise rules
# ---------------------------------------------------------------------------


register_grad(PrimIDs.ADD, lambda a, b: VJPResult(prims.add(a, b), ()),
              lambda g: (g, g))
register_grad(PrimIDs.SUB, lambda a, b: VJPResult(prims.sub(a, b), ()),
              lambda g: (g, prims.neg(g)))


@register_augmented_forward(PrimIDs.MUL)
def _mul_aug(a, b):
    return VJPResult(prims.mul(a, b), (a, b))


@register_backward(PrimIDs.MUL)
def _mul_bwd(a, b, g):
    return prims.mul(g, b), prims.mul(g, a)


@register_augmented_forward(PrimIDs.DIV)
def _div_aug(a, b):
    out = prims.div(a, b)
    return VJPResult(out, (a, b))


@register_backward(PrimIDs.DIV)
def _div_bwd(a, b, g):
    ga = prims.div(g, b)
    gb = prims.neg(prims.div(prims.mul(g, prims.div(a, b)), b))
    return ga, gb


@register_augmented_forward(PrimIDs.POW)
def _pow_aug(a, b):
    out = prims.pow(a, b)
    return VJPResult(out, (a, b, out))


@register_backward(PrimIDs.POW)
def _pow_bwd(a, b, out, g):
    one = clang.full_like(b, 1)
    ga = prims.mul(g, prims.mul(b, prims.pow(a, prims.sub(b, one))))
    # d/db a^b = out * log(a); guard log of nonpositive
    safe_a = prims.maximum(a, clang.full_like(a, 1e-30))
    gb = prims.mul(g, prims.mul(out, prims.log(safe_a)))
    return ga, gb


register_grad(PrimIDs.NEG, lambda a: VJPResult(prims.neg(a), ()), lambda g: prims.neg(g))


@register_augmented_forward(PrimIDs.ABS)
def _abs_aug(a):
    return VJPResult(prims.abs(a), (a,))


@register_backward(PrimIDs.ABS)
def _abs_bwd(a, g):
    return prims.mul(g, prims.sign(a))


@register_augmented_forward(PrimIDs.EXP)
def _exp_aug(a):
    out = prims.exp(a)
    return VJPResult(out, (out,))


@register_backward(PrimIDs.EXP)
def _exp_bwd(out, g):
    return prims.mul(g, out)


@register_augmented_forward(PrimIDs.LOG)
def _log_aug(a):
    return VJPResult(prims.log(a), (a,))


@register_backward(PrimIDs.LOG)
def _log_bwd(a, g):
    return prims.div(g, a)


@register_augmented_forward(PrimIDs.LOG1P)
def _log1p_aug(a):
    return VJPResult(prims.log1p(a), (a,))


@register_backward(PrimIDs.LOG1P)
def _log1p_bwd(a, g):
    return prims.div(g, clang.add(a, 1.0))


@register_augmented_forward(PrimIDs.SQRT)
def _sqrt_aug(a):
    out = prims.sqrt(a)
    return VJPResult(out, (out,))


@register_backward(PrimIDs.SQRT)
def _sqrt_bwd(out, g):
    return prims.div(g, prims.mul(clang.full_like(out, 2.0), out))


@register_augmented_forward(PrimIDs.RSQRT)
def _rsqrt_aug(a):
    out = prims.rsqrt(a)
    return VJPResult(out, (a, out))


@register_backward(PrimIDs.RSQRT)
def _rsqrt_bwd(a, out, g):
    # d rsqrt(a) = -1/2 a^{-3/2} = -0.5 * out / a
    return prims.mul(g, prims.mul(clang.full_like(out, -0.5), prims.div(out, a)))


@register_augmented_forward(PrimIDs.SIN)
def _sin_aug(a):
    return VJPResult(prims.sin(a), (a,))


@register_backward(PrimIDs.SIN)
def _sin_bwd(a, g):
    return prims.mul(g, prims.cos(a))


@register_augmented_forward(PrimIDs.COS)
def _cos_aug(a):
    return VJPResult(prims.cos(a), (a,))


@register_backward(PrimIDs.COS)
def _cos_bwd(a, g):
    return prims.neg(prims.mul(g, prims.sin(a)))


@register_augmented_forward(PrimIDs.TANH)
def _tanh_aug(a):
    out = prims.tanh(a)
    return VJPResult(out, (out,))


@register_backward(PrimIDs.TANH)
def _tanh_bwd(out, g):
    return prims.mul(g, prims.sub(clang.full_like(out, 1.0), prims.mul(out, out)))


@register_augmented_forward(PrimIDs.ERF)
def _erf_aug(a):
    return VJPResult(prims.erf(a), (a,))


@register_backward(PrimIDs.ERF)
def _erf_bwd(a, g):
    c = 2.0 / math.sqrt(math.pi)
    return prims.mul(g, prims.mul(clang.full_like(a, c), prims.exp(prims.neg(prims.mul(a, a)))))


@register_augmented_forward(PrimIDs.ERFINV)
def _erfinv_aug(a):
    out = prims.erfinv(a)
    return VJPResult(out, (out,))


@register_backward(PrimIDs.ERFINV)
def _erfinv_bwd(out, g):
    # d/dx erfinv(x) = sqrt(pi)/2 * exp(erfinv(x)^2)
    c = math.sqrt(math.pi) / 2.0
    return prims.mul(g, prims.mul(clang.full_like(out, c), prims.exp(prims.mul(out, out))))


@register_augmented_forward(PrimIDs.EXPM1)
def _expm1_aug(a):
    out = prims.expm1(a)
    return VJPResult(out, (out,))


@register_backward(PrimIDs.EXPM1)
def _expm1_bwd(out, g):
    return prims.mul(g, clang.add(out, 1.0))


@register_augmented_forward(PrimIDs.RECIPROCAL)
def _recip_aug(a):
    out = prims.reciprocal(a)
    return VJPResult(out, (out,))


@register_backward(PrimIDs.RECIPROCAL)
def _recip_bwd(out, g):
    return prims.neg(prims.mul(g, prims.mul(out, out)))


@register_augmented_forward(PrimIDs.MAXIMUM)
def _maximum_aug(a, b):
    return VJPResult(prims.maximum(a, b), (a, b))


@register_backward(PrimIDs.MAXIMUM)
def _maximum_bwd(a, b, g):
    mask = prims.ge(a, b)
    zero = _zeros_like(g)
    return prims.where(mask, g, zero), prims.where(mask, zero, g)


@register_augmented_forward(PrimIDs.MINIMUM)
def _minimum_aug(a, b):
    return VJPResult(prims.minimum(a, b), (a, b))


@register_backward(PrimIDs.MINIMUM)
def _minimum_bwd(a, b, g):
    mask = prims.le(a, b)
    zero = _zeros_like(g)
    return prims.where(mask, g, zero), prims.where(mask, zero, g)


@register_augmented_forward(PrimIDs.WHERE)
def _where_aug(pred, a, b):
    return VJPResult(prims.where(pred, a, b), (pred,))


@register_backward(PrimIDs.WHERE)
def _where_bwd(pred, g):
    zero = _zeros_like(g)
    return None, prims.where(pred, g, zero), prims.where(pred, zero, g)


@register_augmented_forward(PrimIDs.CONVERT_ELEMENT_TYPE)
def _cvt_aug(a, dtype):
    out = prims.convert_element_type(a, dtype)
    in_dtype = a.dtype if isinstance(a, TensorProxy) else dtypes.to_dtype(type(a))
    return VJPResult(out, (in_dtype,))


@register_backward(PrimIDs.CONVERT_ELEMENT_TYPE)
def _cvt_bwd(in_dtype, g):
    if not in_dtype.is_inexact:
        return None
    return prims.convert_element_type(g, in_dtype)


register_grad(PrimIDs.STOP_GRADIENT, lambda a: VJPResult(prims.stop_gradient(a), ()), lambda g: None)

# piecewise-constant ops: zero gradient almost everywhere
for _pid, _prim in ((PrimIDs.FLOOR, prims.floor), (PrimIDs.CEIL, prims.ceil),
                    (PrimIDs.ROUND, prims.round), (PrimIDs.TRUNC, prims.trunc),
                    (PrimIDs.SIGN, prims.sign)):
    def _const_aug(a, _p=_prim):
        return VJPResult(_p(a), ())

    register_grad(_pid, _const_aug, lambda g: _zeros_like(g))


@register_augmented_forward(PrimIDs.EXP2)
def _exp2_aug(a):
    out = prims.exp2(a)
    return VJPResult(out, (out,))


@register_backward(PrimIDs.EXP2)
def _exp2_bwd(out, g):
    return prims.mul(g, prims.mul(out, clang.full_like(out, math.log(2.0))))


@register_augmented_forward(PrimIDs.LOG2)
def _log2_aug(a):
    return VJPResult(prims.log2(a), (a,))


@register_backward(PrimIDs.LOG2)
def _log2_bwd(a, g):
    return prims.div(g, prims.mul(a, clang.full_like(a, math.log(2.0))))


@register_augmented_forward(PrimIDs.TAN)
def _tan_aug(a):
    out = prims.tan(a)
    return VJPResult(out, (out,))


@register_backward(PrimIDs.TAN)
def _tan_bwd(out, g):
    return prims.mul(g, clang.add(prims.mul(out, out), 1.0))


@register_augmented_forward(PrimIDs.SINH)
def _sinh_aug(a):
    return VJPResult(prims.sinh(a), (a,))


@register_backward(PrimIDs.SINH)
def _sinh_bwd(a, g):
    return prims.mul(g, prims.cosh(a))


@register_augmented_forward(PrimIDs.COSH)
def _cosh_aug(a):
    return VJPResult(prims.cosh(a), (a,))


@register_backward(PrimIDs.COSH)
def _cosh_bwd(a, g):
    return prims.mul(g, prims.sinh(a))


@register_augmented_forward(PrimIDs.ASIN)
def _asin_aug(a):
    return VJPResult(prims.asin(a), (a,))


@register_backward(PrimIDs.ASIN)
def _asin_bwd(a, g):
    return prims.mul(g, prims.rsqrt(clang.sub(1.0, prims.mul(a, a))))


@register_augmented_forward(PrimIDs.ACOS)
def _acos_aug(a):
    return VJPResult(prims.acos(a), (a,))


@register_backward(PrimIDs.ACOS)
def _acos_bwd(a, g):
    return prims.neg(prims.mul(g, prims.rsqrt(clang.sub(1.0, prims.mul(a, a)))))


@register_augmented_forward(PrimIDs.ATAN)
def _atan_aug(a):
    return VJPResult(prims.atan(a), (a,))


@register_backward(PrimIDs.ATAN)
def _atan_bwd(a, g):
    return prims.div(g, clang.add(prims.mul(a, a), 1.0))


@register_augmented_forward(PrimIDs.ASINH)
def _asinh_aug(a):
    return VJPResult(prims.asinh(a), (a,))


@register_backward(PrimIDs.ASINH)
def _asinh_bwd(a, g):
    return prims.mul(g, prims.rsqrt(clang.add(prims.mul(a, a), 1.0)))


@register_augmented_forward(PrimIDs.ACOSH)
def _acosh_aug(a):
    return VJPResult(prims.acosh(a), (a,))


@register_backward(PrimIDs.ACOSH)
def _acosh_bwd(a, g):
    return prims.mul(g, prims.rsqrt(clang.sub(prims.mul(a, a), 1.0)))


@register_augmented_forward(PrimIDs.ATANH)
def _atanh_aug(a):
    return VJPResult(prims.atanh(a), (a,))


@register_backward(PrimIDs.ATANH)
def _atanh_bwd(a, g):
    return prims.div(g, clang.sub(1.0, prims.mul(a, a)))


@register_augmented_forward(PrimIDs.ERFC)
def _erfc_aug(a):
    return VJPResult(prims.erfc(a), (a,))


@register_backward(PrimIDs.ERFC)
def _erfc_bwd(a, g):
    c = -2.0 / math.sqrt(math.pi)
    return prims.mul(g, prims.mul(clang.full_like(a, c), prims.exp(prims.neg(prims.mul(a, a)))))


@register_augmented_forward(PrimIDs.FMOD)
def _fmod_aug(a, b):
    return VJPResult(prims.fmod(a, b), (a, b))


@register_backward(PrimIDs.FMOD)
def _fmod_bwd(a, b, g):
    return g, prims.neg(prims.mul(g, prims.trunc(prims.div(a, b))))


@register_augmented_forward(PrimIDs.REMAINDER)
def _remainder_aug(a, b):
    return VJPResult(prims.remainder(a, b), (a, b))


@register_backward(PrimIDs.REMAINDER)
def _remainder_bwd(a, b, g):
    return g, prims.neg(prims.mul(g, prims.floor(prims.div(a, b))))


# ---------------------------------------------------------------------------
# shape-op rules
# ---------------------------------------------------------------------------


@register_augmented_forward(PrimIDs.RESHAPE)
def _reshape_aug(a, shape):
    return VJPResult(prims.reshape(a, shape), (a.shape,))


@register_backward(PrimIDs.RESHAPE)
def _reshape_bwd(in_shape, g):
    return prims.reshape(g, in_shape)


@register_augmented_forward(PrimIDs.TRANSPOSE)
def _transpose_aug(a, permutation):
    inv = tuple(sorted(range(len(permutation)), key=lambda i: permutation[i]))
    return VJPResult(prims.transpose(a, permutation), (inv,))


@register_backward(PrimIDs.TRANSPOSE)
def _transpose_bwd(inv, g):
    return prims.transpose(g, inv)


@register_augmented_forward(PrimIDs.BROADCAST_IN_DIM)
def _bcast_aug(a, shape, broadcast_dimensions):
    return VJPResult(prims.broadcast_in_dim(a, shape, broadcast_dimensions), (a.shape, tuple(broadcast_dimensions)))


@register_backward(PrimIDs.BROADCAST_IN_DIM)
def _bcast_bwd(in_shape, bdims, g):
    # reduce over dims not in bdims, and over bdims where input had size 1
    reduce_dims = tuple(d for d in range(g.ndim) if d not in bdims)
    reduce_dims += tuple(d for i, d in enumerate(bdims) if in_shape[i] == 1)
    out = prims.sum_prim(g, reduce_dims) if reduce_dims else g
    return prims.reshape(out, in_shape)


@register_augmented_forward(PrimIDs.SLICE)
def _slice_aug(a, start_indices, limit_indices, strides=None):
    return VJPResult(
        prims.slice_prim(a, start_indices, limit_indices, strides),
        (a.shape, tuple(start_indices), tuple(limit_indices), tuple(strides) if strides else None),
    )


@register_backward(PrimIDs.SLICE)
def _slice_bwd(in_shape, starts, limits, strides, g):
    if strides is None:
        strides = (1,) * len(in_shape)
    cfg = []
    for i, (s, l, st) in enumerate(zip(starts, limits, strides)):
        n_out = g.shape[i]
        hi = in_shape[i] - (s + (n_out - 1) * st + 1)
        cfg.append((s, hi, st - 1))
    return prims.pad(g, 0.0, tuple(cfg))


@register_augmented_forward(PrimIDs.SQUEEZE)
def _squeeze_aug(a, dims):
    return VJPResult(prims.squeeze(a, dims), (a.shape,))


@register_backward(PrimIDs.SQUEEZE)
def _squeeze_bwd(in_shape, g):
    return prims.reshape(g, in_shape)


@register_augmented_forward(PrimIDs.CAT)
def _cat_aug(tensors, dim):
    sizes = tuple(t.shape[dim] for t in tensors)
    return VJPResult(prims.cat(tensors, dim), (sizes, dim))


@register_backward(PrimIDs.CAT)
def _cat_bwd(sizes, dim, g):
    grads = []
    ofs = 0
    for s in sizes:
        grads.append(clang.slice_in_dim(g, ofs, ofs + s, dim))
        ofs += s
    return tuple(grads)


@register_augmented_forward(PrimIDs.PAD)
def _pad_aug(a, padding_value, padding_config):
    return VJPResult(prims.pad(a, padding_value, padding_config), (a.shape, tuple(padding_config)))


@register_backward(PrimIDs.PAD)
def _pad_bwd(in_shape, cfg, g):
    starts = tuple(lo for lo, _, _ in cfg)
    strides = tuple(i + 1 for _, _, i in cfg)
    limits = tuple(lo + (n - 1) * st + 1 for (lo, _, _), n, st in zip(cfg, in_shape, strides))
    return prims.slice_prim(g, starts, limits, strides)


@register_augmented_forward(PrimIDs.FLIP)
def _flip_aug(a, dims):
    return VJPResult(prims.flip(a, dims), (dims,))


@register_backward(PrimIDs.FLIP)
def _flip_bwd(dims, g):
    return prims.flip(g, dims)


@register_augmented_forward(PrimIDs.TAKE)
def _take_aug(a, indices, dim):
    return VJPResult(prims.take(a, indices, dim), (a.shape, a.dtype, indices, dim))


@register_backward(PrimIDs.TAKE)
def _take_bwd(in_shape, in_dtype, indices, dim, g):
    zeros = prims.full(in_shape, 0.0, dtype=in_dtype)
    return prims.index_add(zeros, indices, g, dim), None


@register_augmented_forward(PrimIDs.TAKE_ALONG_AXIS)
def _taa_aug(a, indices, dim):
    return VJPResult(prims.take_along_axis(a, indices, dim), (a.shape, a.dtype, indices, dim))


@register_backward(PrimIDs.TAKE_ALONG_AXIS)
def _taa_bwd(in_shape, in_dtype, indices, dim, g):
    zeros = prims.full(in_shape, 0.0, dtype=in_dtype)
    return prims.scatter_add(zeros, indices, g, dim), None


@register_augmented_forward(PrimIDs.INDEX_ADD)
def _index_add_aug(a, indices, value, dim):
    return VJPResult(prims.index_add(a, indices, value, dim), (indices, dim))


@register_backward(PrimIDs.INDEX_ADD)
def _index_add_bwd(indices, dim, g):
    # out = a + scatter(value at indices): da = g, dvalue = gather of g
    return g, None, prims.take(g, indices, dim)


@register_augmented_forward(PrimIDs.SCATTER_ADD)
def _scatter_add_aug(a, indices, value, dim):
    return VJPResult(prims.scatter_add(a, indices, value, dim), (indices, dim))


@register_backward(PrimIDs.SCATTER_ADD)
def _scatter_add_bwd(indices, dim, g):
    return g, None, prims.take_along_axis(g, indices, dim)


@register_augmented_forward(PrimIDs.EMBEDDING)
def _embedding_aug(indices, weight):
    indices = clang.ensure_proxy(indices)
    return VJPResult(prims.embedding(indices, weight), (indices, weight.shape, weight.dtype))


@register_backward(PrimIDs.EMBEDDING)
def _embedding_bwd(indices, w_shape, w_dtype, g):
    indices = clang.ensure_proxy(indices)
    zeros = prims.full(w_shape, 0.0, dtype=w_dtype)
    flat_idx = prims.reshape(indices, (indices.numel,)) if indices.ndim != 1 else indices
    flat_g = prims.reshape(g, (indices.numel, w_shape[1]))
    return None, prims.index_add(zeros, flat_idx, flat_g, 0)


@register_augmented_forward(PrimIDs.TOPK)
def _topk_aug(a, k, dim):
    values, indices = prims.topk(a, k, dim)
    return VJPResult((values, indices), (a.shape, a.dtype, indices, dim))


@register_backward(PrimIDs.TOPK)
def _topk_bwd(in_shape, in_dtype, indices, dim, g_values, g_indices=None):
    zeros = prims.full(in_shape, 0.0, dtype=in_dtype)
    return prims.scatter_add(zeros, indices, g_values, dim)


# ---------------------------------------------------------------------------
# reduction rules
# ---------------------------------------------------------------------------


@register_augmented_forward(PrimIDs.SUM)
def _sum_aug(a, dims, *, output_dtype=None):
    return VJPResult(prims.sum_prim(a, dims, output_dtype=output_dtype), (a.shape, tuple(dims), a.dtype))


@register_backward(PrimIDs.SUM)
def _sum_bwd(in_shape, dims, in_dtype, g):
    kept = tuple(d for d in range(len(in_shape)) if d not in dims)
    g = prims.convert_element_type(g, in_dtype) if g.dtype != in_dtype else g
    return prims.broadcast_in_dim(g, in_shape, kept)


@register_augmented_forward(PrimIDs.PROD)
def _prod_aug(a, dims, *, output_dtype=None):
    out = prims.prod_prim(a, dims, output_dtype=output_dtype)
    return VJPResult(out, (a, out, tuple(dims)))


@register_backward(PrimIDs.PROD)
def _prod_bwd(a, out, dims, g):
    # d prod / d a_i = g * prod_{j != i} a_j, kept finite for zero-containing
    # inputs (torch semantics): one zero in a reduced group -> only that
    # position gets the product of the other elements; two or more -> all 0.
    kept = tuple(d for d in range(len(a.shape)) if d not in dims)
    g_full = prims.broadcast_in_dim(g, a.shape, kept)
    if g_full.dtype != a.dtype:
        g_full = prims.convert_element_type(g_full, a.dtype)
    zero = _zeros_like(a)
    one = clang.full_like(a, 1)
    is_zero = prims.eq(a, zero)
    safe_a = prims.where(is_zero, one, a)
    # product over the reduced dims with zeros replaced by ones
    prod_nz = prims.broadcast_in_dim(prims.prod_prim(safe_a, dims), a.shape, kept)
    nz_dtype = g_full.dtype
    n_zeros = prims.broadcast_in_dim(
        prims.sum_prim(prims.convert_element_type(is_zero, nz_dtype), dims),
        a.shape, kept)
    nz0 = _zeros_like(n_zeros)
    nz1 = clang.full_like(n_zeros, 1)
    grad_no_zero = prims.mul(g_full, prims.div(prod_nz, safe_a))
    grad_one_zero = prims.where(is_zero, prims.mul(g_full, prod_nz), zero)
    grad = prims.where(prims.eq(n_zeros, nz0), grad_no_zero,
                       prims.where(prims.eq(n_zeros, nz1), grad_one_zero, zero))
    return grad


@register_augmented_forward(PrimIDs.LOG10)
def _log10_aug(a):
    return VJPResult(prims.log10(a), (a,))


@register_backward(PrimIDs.LOG10)
def _log10_bwd(a, g):
    return prims.div(g, prims.mul(a, math.log(10.0)))


@register_augmented_forward(PrimIDs.LGAMMA)
def _lgamma_aug(a):
    return VJPResult(prims.lgamma(a), (a,))


@register_backward(PrimIDs.LGAMMA)
def _lgamma_bwd(a, g):
    return prims.mul(g, prims.digamma(a))


@register_augmented_forward(PrimIDs.HYPOT)
def _hypot_aug(a, b):
    out = prims.hypot(a, b)
    return VJPResult(out, (a, b, out))


@register_backward(PrimIDs.HYPOT)
def _hypot_bwd(a, b, out, g):
    return prims.mul(g, prims.div(a, out)), prims.mul(g, prims.div(b, out))


@register_augmented_forward(PrimIDs.COPYSIGN)
def _copysign_aug(a, b):
    out = prims.copysign(a, b)
    return VJPResult(out, (a, out))


@register_backward(PrimIDs.COPYSIGN)
def _copysign_bwd(a, out, g):
    # d|a|·sign(b)/da = sign(a)·sign(b) = sign(out)·sign(a)
    return prims.mul(g, prims.mul(prims.sign(out), prims.sign(a))), None


@register_augmented_forward(PrimIDs.AMAX)
def _amax_aug(a, dims):
    out = prims.amax(a, dims)
    return VJPResult(out, (a, out, tuple(dims)))


def _minmax_bwd(a, out, dims, g):
    kept = tuple(d for d in range(a.ndim) if d not in dims)
    out_b = prims.broadcast_in_dim(out, a.shape, kept)
    g_b = prims.broadcast_in_dim(g, a.shape, kept)
    mask = prims.eq(a, out_b)
    maskf = prims.convert_element_type(mask, a.dtype)
    count = prims.sum_prim(maskf, dims)
    count_b = prims.broadcast_in_dim(count, a.shape, kept)
    return prims.div(prims.mul(maskf, g_b), count_b)


@register_backward(PrimIDs.AMAX)
def _amax_bwd(a, out, dims, g):
    return _minmax_bwd(a, out, dims, g)


@register_augmented_forward(PrimIDs.AMIN)
def _amin_aug(a, dims):
    out = prims.amin(a, dims)
    return VJPResult(out, (a, out, tuple(dims)))


@register_backward(PrimIDs.AMIN)
def _amin_bwd(a, out, dims, g):
    return _minmax_bwd(a, out, dims, g)


# ---------------------------------------------------------------------------
# matmul-family rules
# ---------------------------------------------------------------------------


@register_augmented_forward(PrimIDs.MATMUL)
def _matmul_aug(a, b):
    return VJPResult(prims.matmul(a, b), (a, b))


@register_backward(PrimIDs.MATMUL)
def _matmul_bwd(a, b, g):
    if a.ndim == 1 and b.ndim == 1:
        return prims.mul(g_expand(g, a), b), prims.mul(g_expand(g, a), a)
    if a.ndim == 1:
        # (k) @ (..., k, n) -> (..., n)
        ga = prims.matmul(b, clang.unsqueeze(g, -1))  # (..., k, 1)
        ga = clang.squeeze(ga, -1)
        ga = _sum_to_shape(ga, a.shape)
        gb = prims.matmul(clang.unsqueeze(a, -1), clang.unsqueeze(g, -2))
        gb = _sum_to_shape(gb, b.shape)
        return ga, gb
    if b.ndim == 1:
        ga = prims.matmul(clang.unsqueeze(g, -1), clang.unsqueeze(b, 0))
        ga = _sum_to_shape(ga, a.shape)
        gb = prims.matmul(clang.matrix_transpose(a), clang.unsqueeze(g, -1))
        gb = clang.squeeze(gb, -1)
        gb = _sum_to_shape(gb, b.shape)
        return ga, gb
    ga = prims.matmul(g, clang.matrix_transpose(b))
    gb = prims.matmul(clang.matrix_transpose(a), g)
    return _sum_to_shape(ga, a.shape), _sum_to_shape(gb, b.shape)


def g_expand(g, like):
    return prims.broadcast_in_dim(g, like.shape, ()) if g.ndim == 0 else g


@register_augmented_forward(PrimIDs.LINEAR)
def _linear_aug(a, w, bias=None):
    return VJPResult(prims.linear(a, w, bias), (a, w))


@register_backward(PrimIDs.LINEAR)
def _linear_bwd(a, w, g):
    # a: (..., in), w: (out, in), g: (..., out)
    ga = prims.matmul(g, w)
    batch = 1
    for s in a.shape[:-1]:
        batch *= s
    g2 = prims.reshape(g, (batch, g.shape[-1]))
    a2 = prims.reshape(a, (batch, a.shape[-1]))
    gw = prims.matmul(clang.matrix_transpose(g2), a2)
    return ga, gw


# ---------------------------------------------------------------------------
# convolution, pooling-window, variance and scan rules: thunder_tpu takes
# these from jax.vjp of its jax implementations (JAX_VJP_FALLBACK there);
# here each is written out, and tests/test_torch_vision_grads.py holds it
# against jax.vjp
# ---------------------------------------------------------------------------


def _conv_grads(a, weight, bias, conv, g):
    """(input, weight, bias) gradients of a convolution or transposed
    convolution: torchex's conv_backward_input / conv_backward_weight
    operators (aten.convolution_backward, one gradient each), the bias's
    summed over every dim but channels."""
    from ..executors import torchex

    grads = (torchex.conv_backward_input(g, a, weight, *conv),
             torchex.conv_backward_weight(g, a, weight, *conv))
    if bias:
        grads += (prims.sum_prim(g, (0,) + tuple(range(2, g.ndim))),)
    return grads


@register_augmented_forward(PrimIDs.CONVOLUTION)
def _conv_aug(a, weight, bias, stride, padding, dilation, groups):
    out = prims.convolution(a, weight, bias, stride, padding, dilation, groups)
    conv = (tuple(stride), tuple(padding), tuple(dilation), False, (0,) * (a.ndim - 2), groups)
    return VJPResult(out, (a, weight, bias is not None, conv))


@register_augmented_forward(PrimIDs.CONV_TRANSPOSE)
def _conv_transpose_aug(a, weight, bias, stride, padding, output_padding, dilation, groups):
    out = prims.conv_transpose(a, weight, bias, stride, padding, output_padding, dilation, groups)
    conv = (tuple(stride), tuple(padding), tuple(dilation), True, tuple(output_padding), groups)
    return VJPResult(out, (a, weight, bias is not None, conv))


register_backward(PrimIDs.CONVOLUTION)(_conv_grads)
register_backward(PrimIDs.CONV_TRANSPOSE)(_conv_grads)


def _window_spec(window_dims, strides, padding) -> tuple:
    return (tuple(int(pyval(w)) for w in window_dims), tuple(int(pyval(s)) for s in strides),
            tuple((int(pyval(lo)), int(pyval(hi))) for lo, hi in padding))


@register_augmented_forward(PrimIDs.REDUCE_WINDOW)
def _reduce_window_aug(a, window_dims, strides, padding, *, op="max"):
    out = prims.reduce_window(a, window_dims, strides, padding, op=op)
    spec = _window_spec(window_dims, strides, padding)
    if op == "sum":
        return VJPResult(out, (a.shape, None, spec, op))
    return VJPResult(out, (a, out, spec, op))


@register_backward(PrimIDs.REDUCE_WINDOW)
def _reduce_window_bwd(a, out, spec, op, g):
    if op == "sum":
        return _window_sum_transpose(g, a, *spec)
    return _window_select_transpose(g, a, out, *spec, op)


def _window_sum_transpose(g, in_shape, window, strides, padding):
    """Each window's cotangent spread over the window: g dilated by the
    strides, padded, and summed over stride-1 windows (jax's transpose of
    reduce_window_sum)."""
    cfg = []
    for n, w, s, (lo, _), o in zip(in_shape, window, strides, padding, g.shape):
        before = w - lo - 1
        cfg.append((before, n + w - 1 - ((o - 1) * s + 1) - before, s - 1))
    nd = len(in_shape)
    return prims.reduce_window(prims.pad(g, 0.0, tuple(cfg)), window, (1,) * nd, ((0, 0),) * nd, op="sum")


def _window_select_transpose(g, a, out, window, strides, padding, op):
    """Each window's cotangent to the one element it selected, by jax's
    rule (XLA's SelectAndScatter with >= for max, <= for min): the first
    in-bounds element equal to the window's result, in row-major order over
    the window; padding is never selected. Windows that overlap add. Per
    window offset: the strided slice of the padded input, the elements it
    selects that no earlier offset selected, and their cotangent put back
    where the slice came from (the slice's transpose)."""
    import itertools

    fill = float("-inf") if op == "max" else float("inf")
    pad_cfg = tuple((lo, hi, 0) for lo, hi in padding)
    padded = prims.pad(a, fill, pad_cfg)
    inside = prims.pad(clang.full(a.shape, True, dtype=dtypes.bool8, device=a.device), False, pad_cfg)
    zero = _zeros_like(g)
    taken = None
    acc = None
    for offset in itertools.product(*(range(w) for w in window)):
        limits = tuple(o + (n - 1) * s + 1 for o, n, s in zip(offset, out.shape, strides))
        hit = prims.bitwise_and(prims.eq(prims.slice_prim(padded, offset, limits, strides), out),
                                prims.slice_prim(inside, offset, limits, strides))
        if taken is not None:
            hit = prims.bitwise_and(hit, prims.logical_not(taken))
        taken = hit if taken is None else prims.bitwise_or(taken, hit)
        transpose = tuple((o, pn - lim, s - 1) for o, lim, pn, s in zip(offset, limits, padded.shape, strides))
        back = prims.pad(prims.where(hit, g, zero), 0.0, transpose)
        acc = back if acc is None else prims.add(acc, back)
    return prims.slice_prim(acc, tuple(lo for lo, _ in padding),
                            tuple(lo + n for (lo, _), n in zip(padding, a.shape)))


@register_augmented_forward(PrimIDs.VAR)
def _var_aug(a, dims, *, correction=1):
    return VJPResult(prims.var_prim(a, dims, correction=correction), (a, tuple(dims), correction))


@register_backward(PrimIDs.VAR)
def _var_bwd(a, dims, correction, g):
    n = math.prod(a.shape[d] for d in dims)
    denom = max(0, n - correction)
    kept = tuple(d for d in range(a.ndim) if d not in dims)
    centered = clang.sub(a, clang.mean(a, dims, keepdim=True))
    g_b = prims.broadcast_in_dim(g, a.shape, kept)
    return clang.mul(prims.mul(g_b, centered), 2.0 / denom if denom else float("inf"))


@register_augmented_forward(PrimIDs.ATAN2)
def _atan2_aug(a, b):
    return VJPResult(prims.atan2(a, b), (a, b))


@register_backward(PrimIDs.ATAN2)
def _atan2_bwd(a, b, g):
    r2 = prims.add(prims.mul(a, a), prims.mul(b, b))
    return prims.mul(g, prims.div(b, r2)), prims.neg(prims.mul(g, prims.div(a, r2)))


def _reverse_cumsum(x, dim):
    return prims.flip(prims.cumsum(prims.flip(x, (dim,)), dim), (dim,))


@register_augmented_forward(PrimIDs.CUMSUM)
def _cumsum_aug(a, dim):
    return VJPResult(prims.cumsum(a, dim), (dim % a.ndim,))


@register_backward(PrimIDs.CUMSUM)
def _cumsum_bwd(dim, g):
    return _reverse_cumsum(g, dim)


@register_augmented_forward(PrimIDs.CUMMAX)
def _cummax_aug(a, dim):
    values, indices = prims.cummax(a, dim)
    return VJPResult((values, indices), (a.shape, a.dtype, indices, dim))


@register_backward(PrimIDs.CUMMAX)
def _cummax_bwd(in_shape, in_dtype, indices, dim, g_values, g_indices=None):
    zeros = prims.full(in_shape, 0.0, dtype=in_dtype)
    return prims.scatter_add(zeros, indices, g_values, dim)


@register_augmented_forward(PrimIDs.CUMPROD)
def _cumprod_aug(a, dim):
    out = prims.cumprod(a, dim)
    return VJPResult(out, (a, out, dim % a.ndim))


@register_backward(PrimIDs.CUMPROD)
def _cumprod_bwd(a, out, dim, g):
    """Finite where a holds zeros, as jax's division-free scan gradient:
    before a slice's first zero z, d out_j / d a_i = out_j / a_i (a_i != 0,
    and out_j = 0 from z on); at z, the product of a before z times the sum
    over j >= z of g_j times the product of a over (z, j]; after z, 0."""
    zero, one = _zeros_like(a), clang.full_like(a, 1)
    is_zero = prims.eq(a, zero)
    zeros_so_far = prims.cumsum(prims.convert_element_type(is_zero, a.dtype), dim)
    before = prims.eq(zeros_so_far, zero)
    first = prims.bitwise_and(is_zero, prims.eq(zeros_so_far, one))
    grad_before = prims.where(before, prims.div(_reverse_cumsum(prims.mul(g, out), dim),
                                                prims.where(before, a, one)), zero)
    head = prims.cumprod(prims.where(before, a, one), dim)
    tail = prims.cumprod(prims.where(prims.bitwise_or(before, first), one, a), dim)
    at_first = _reverse_cumsum(prims.where(before, zero, prims.mul(g, tail)), dim)
    return prims.add(grad_before, prims.where(first, prims.mul(head, at_first), zero))


def _trigamma(x):
    """polygamma(1, x) from elementwise prims: for x >= 1/2 six steps of
    the recurrence psi1(y) = 1/y^2 + psi1(y + 1), then the asymptotic series
    at y + 6 >= 6.5 (terms to 1/z^9, the next ~1e-10 there); below 1/2 the
    reflection psi1(x) = pi^2 / sin^2(pi x) - psi1(1 - x)."""
    reflect = prims.lt(x, clang.full_like(x, 0.5))
    y = prims.where(reflect, clang.sub(1.0, x), x)
    acc = None
    for k in range(6):
        yk = clang.add(y, float(k))
        term = prims.reciprocal(prims.mul(yk, yk))
        acc = term if acc is None else prims.add(acc, term)
    iz = prims.reciprocal(clang.add(y, 6.0))
    iz2 = prims.mul(iz, iz)
    series = clang.sub(1.0 / 42, clang.mul(iz2, 1.0 / 30))
    series = clang.sub(1.0 / 30, prims.mul(iz2, series))
    series = clang.sub(1.0 / 6, prims.mul(iz2, series))
    asym = prims.add(prims.add(iz, clang.mul(iz2, 0.5)), prims.mul(prims.mul(iz, iz2), series))
    res = prims.add(acc, asym)
    s = prims.sin(clang.mul(x, math.pi))
    reflected = clang.sub(clang.true_divide(math.pi ** 2, prims.mul(s, s)), res)
    return prims.where(reflect, reflected, res)


@register_augmented_forward(PrimIDs.DIGAMMA)
def _digamma_aug(a):
    return VJPResult(prims.digamma(a), (a,))


@register_backward(PrimIDs.DIGAMMA)
def _digamma_bwd(a, g):
    return prims.mul(g, _trigamma(a))


@register_augmented_forward(PrimIDs.COPY_WITH_SETITEM)
def _setitem_aug(a, key, value):
    n_key_tensors = len(_flat_tensors(key))
    value_shape = value.shape if isinstance(value, TensorProxy) else None
    return VJPResult(prims.copy_with_setitem(a, key, value), (key, n_key_tensors, value_shape))


@register_backward(PrimIDs.COPY_WITH_SETITEM)
def _setitem_bwd(key, n_key_tensors, value_shape, g):
    """a's gradient is g with the written elements zeroed; the value's is
    g at the key, summed over what the write broadcast."""
    ga = prims.copy_with_setitem(g, key, 0.0)
    if value_shape is None:
        return (ga,) + (None,) * n_key_tensors
    return (ga,) + (None,) * n_key_tensors + (_sum_to_shape(clang.getitem(g, key), value_shape),)


# ---------------------------------------------------------------------------
# the vjp fallback: torch.func.vjp of torchex's implementation
# ---------------------------------------------------------------------------


def _vjp_fallback_meta(sym_id, args, kwargs, cots):
    return tuple(TensorProxy(shape=p.shape, dtype=p.dtype, device=p.device)
                 for p in _flat_tensors((args, kwargs)) if _is_diff_dtype(p))


def _vjp_fallback_impl(sym_id, args, kwargs, cots):
    """The gradients of the op's float tensor arguments, in order:
    torch.func.vjp of torchex's implementation of ``sym_id`` at (args,
    kwargs), with the output's cotangent. Everything stays on the device
    (the forward runs again inside the vjp), so a CUDA graph captures it."""
    from ..core.pytree import tree_flatten, tree_unflatten
    from ..executors import torchex

    fn = torchex.ex.implmap[sym_id][0]
    flat, spec = tree_flatten((args, kwargs))
    is_float = [isinstance(x, torch.Tensor) and x.is_floating_point() for x in flat]

    def of_floats(*fts):
        it = iter(fts)
        a, k = tree_unflatten([next(it) if m else x for x, m in zip(flat, is_float)], spec)
        return fn(*a, **k)

    with torch.enable_grad():
        _, vjp_fn = torch.func.vjp(of_floats, *[x for x, m in zip(flat, is_float) if m])
        return tuple(vjp_fn(cots[0]))


_vjp_fallback_op = []


def vjp_fallback(sym_id, args, kwargs, cots):
    """The ``torch.vjp_fallback`` operator, registered on torchex at its
    first use (torchex imports this module)."""
    if not _vjp_fallback_op:
        from ..executors import torchex

        _vjp_fallback_op.append(torchex.ex.register_operator(
            "vjp_fallback", meta=_vjp_fallback_meta, fn=_vjp_fallback_impl))
    return _vjp_fallback_op[0](sym_id, args, kwargs, cots)


def _fallback_grad(pid):
    """(aug, bwd) of an op in VJP_FALLBACK_OPS: the forward saves its
    arguments; the backward hands them and the cotangent to vjp_fallback and
    gives no gradient to an integer input (indices, group sizes)."""
    def aug(*args, **kwargs):
        return VJPResult(prims.get_prim(pid)(*args, **kwargs), (args, kwargs))

    def bwd(args, kwargs, g):
        grads = iter(vjp_fallback(pid, args, kwargs, (g,)))
        return tuple(next(grads) if _is_diff_dtype(p) else None for p in _flat_tensors((args, kwargs)))

    return aug, bwd


for _pid in VJP_FALLBACK_OPS:
    register_grad(_pid, *_fallback_grad(_pid))


# ---------------------------------------------------------------------------
# the transform itself
# ---------------------------------------------------------------------------


class TapeEntry(NamedTuple):
    sym_id: Any
    inputs: tuple  # mapped (aug-fwd) flat tensor input proxies
    outputs: tuple  # mapped flat tensor output proxies
    residuals: tuple


def _flat_tensors(x) -> tuple:
    from ..core.codeutils import flat_proxies

    return tuple(p for p in flat_proxies(x) if isinstance(p, TensorProxy))


def _is_diff_dtype(p) -> bool:
    return isinstance(p, TensorProxy) and p.dtype.is_inexact


def _plan_recompute(fwd: TraceCtx, saved: list, recompute_names: set):
    """Shrink the saved-for-backward list by re-deriving tagged residuals
    (thunder_tpu/transforms/autodiff.py:_plan_recompute).

    Returns (kept_saved, subgraph): subgraph is the minimal ordered list of
    fwd bsyms whose replay in the backward reproduces every dropped residual;
    the external inputs the subgraph needs are appended to kept_saved
    (saving a trace argument costs nothing: the tensor is alive regardless)."""
    if not recompute_names:
        return saved, []
    produced: dict[str, Any] = {}
    for b in fwd.bound_symbols:
        for o in b.flat_proxy_outs():
            produced[o.name] = b

    targets = {s.name for s in saved
               if isinstance(s, TensorProxy) and s.name in recompute_names and s.name in produced}
    if not targets:
        return saved, []

    need = set(targets)
    subgraph: list = []
    for b in reversed(fwd.bound_symbols):
        outs = [o.name for o in b.flat_proxy_outs()]
        if not outs or not any(o in need for o in outs):
            continue
        if all(o in recompute_names for o in outs):
            subgraph.append(b)
            for p in b.flat_proxy_args():
                need.add(p.name)
    subgraph.reverse()

    recomputed = {o.name for b in subgraph for o in b.flat_proxy_outs()}
    # proxies the subgraph consumes but does not itself produce must be saved
    external = []
    ext_seen = set()
    for b in subgraph:
        for p in b.flat_proxy_args():
            if p.name not in recomputed and p.name not in ext_seen:
                ext_seen.add(p.name)
                external.append(p)

    kept = [s for s in saved if s.name not in targets]
    kept_names = {s.name for s in kept}
    for p in external:
        if p.name not in kept_names:
            kept_names.add(p.name)
            kept.append(p)
    return kept, subgraph


def _map_names(x, mirror: dict):
    """x with every proxy replaced by mirror[its name], where there is one."""
    if isinstance(x, Proxy):
        return mirror.get(x.name, x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map_names(e, mirror) for e in x)
    if isinstance(x, dict):
        return {k: _map_names(v, mirror) for k, v in x.items()}
    return x


def _map_into(old, new, mirror: dict) -> None:
    if isinstance(old, Proxy):
        mirror[old.name] = new
    elif isinstance(old, (tuple, list)) and isinstance(new, (tuple, list)):
        for o, n in zip(old, new):
            _map_into(o, n, mirror)
    elif isinstance(old, dict) and isinstance(new, dict):
        for k in old:
            _map_into(old[k], new[k], mirror)


class ForwardBackwardTraces(NamedTuple):
    forward_trace: TraceCtx
    backward_trace: TraceCtx
    n_saved: int
    grad_arg_names: tuple  # names of fwd-trace args receiving grads, in order


def forward_and_backward_traces(trace: TraceCtx, *, grad_all_inexact_args: bool = False) -> ForwardBackwardTraces:
    """Build (augmented forward, backward) traces from an acquired trace."""
    grad_args = [
        p
        for p in trace.args
        if isinstance(p, TensorProxy) and (p.requires_grad or (grad_all_inexact_args and p.dtype.is_inexact))
    ]
    grad_arg_names = tuple(p.name for p in grad_args)

    fwd = TraceCtx(trace.fn)
    fwd.args = trace.args
    fwd._name = "augmented_forward"
    fwd.device = trace.device
    for p in trace.args:
        fwd.add_name(p.name)

    env: dict[str, Any] = {p.name: p for p in trace.args}
    diff: set[str] = set(grad_arg_names)
    tape: list[TapeEntry] = []
    fwd_output = None
    # buffer writes (trace.side_effects): the trace returns (result, effect
    # values); only the result is differentiated, the values ride along
    has_effects = bool(trace.side_effects)
    fwd_effects: tuple = ()
    # proxies produced while processing RECOMPUTE_IN_BACKWARD-tagged bsyms:
    # eligible to be re-derived in the backward instead of saved
    recompute_names: set[str] = set()

    def lookup(x):
        return _map_names(x, env)

    def map_out(old, new):
        _map_into(old, new, env)

    def process(bsym, in_recompute: bool = False):
        tagged = in_recompute or OpTags.RECOMPUTE_IN_BACKWARD in bsym.tags
        scope_start = len(fwd.bound_symbols)
        _process_inner(bsym, tagged)
        if tagged:
            for nb in fwd.bound_symbols[scope_start:]:
                recompute_names.update(o.name for o in nb.flat_proxy_outs())

    def _process_inner(bsym, in_recompute: bool):
        nonlocal fwd_output, fwd_effects
        if bsym.sym.id == PrimIDs.RETURN:
            ret = bsym.args[0] if len(bsym.args) == 1 else bsym.args
            if has_effects:
                ret, effects = ret
                assert len(effects) == len(trace.side_effects), "effect values do not match side_effects"
                fwd_effects = tuple(lookup(e) for e in effects)
            fwd_output = lookup(ret)
            return
        if bsym.sym.id in (PrimIDs.DEL, PrimIDs.COMMENT, PrimIDs.UNPACK_TRIVIAL):
            return
        margs = lookup(bsym.args)
        mkwargs = lookup(bsym.kwargs)
        in_tensors = _flat_tensors((margs, mkwargs))
        needs_grad = any(t.name in diff for t in in_tensors)
        out_is_diff = any(_is_diff_dtype(o) for o in bsym.flat_proxy_outs())

        if needs_grad and out_is_diff and has_grad_rule(bsym.sym.id):
            res = augmented_forward_impls[bsym.sym.id](*margs, **mkwargs)
            if res is not NotImplemented:  # rules may decline (e.g. kernel shape checkers)
                map_out(bsym.output, res.out)
                new_outs = _flat_tensors(res.out)
                tape.append(TapeEntry(bsym.sym.id, in_tensors, new_outs, tuple(res.residuals)))
                for o in new_outs:
                    if _is_diff_dtype(o):
                        diff.add(o.name)
                return
        if needs_grad and out_is_diff and bsym.subsymbols:
            for sub in bsym.subsymbols:
                process(sub, in_recompute)
            # subsymbol processing populated env for the proxies the composite returns
            map_out(bsym.output, lookup(bsym.output))
            return
        if needs_grad and out_is_diff and not bsym.sym.is_prim:
            # composite that recorded nothing: a pure pass-through (e.g. a
            # full-range getitem); outputs are existing proxies
            map_out(bsym.output, lookup(bsym.output))
            return
        if needs_grad and out_is_diff:
            raise NotImplementedError(
                f"no grad rule for {bsym.sym.name} (id={bsym.sym.id}) and no decomposition")
        # non-differentiable: re-emit
        map_out(bsym.output, bsym.sym(*margs, **mkwargs))

    with tracectx(fwd):
        for bsym in trace.bound_symbols:
            process(bsym)
        # saved-for-backward = union of residual proxies, nested ones too (a
        # setitem key's index tensors), deduplicated in trace order
        saved: list[Proxy] = []
        seen: set = set()
        for entry in tape:
            for r in flat_proxies(entry.residuals):
                if r.name not in seen:
                    seen.add(r.name)
                    saved.append(r)
        saved, recompute_subgraph = _plan_recompute(fwd, saved, recompute_names)
        prims.python_return(((fwd_output, fwd_effects) if has_effects else fwd_output, tuple(saved)))

    fwd_out_tensors = _flat_tensors(fwd_output)

    # ---- build backward trace ----
    bwd = TraceCtx(None)
    bwd._name = "backward"
    bwd.device = trace.device
    saved_mirror: dict[str, Proxy] = {}
    bwd_args: list[Proxy] = []
    with tracectx(bwd):
        for p in saved:
            if isinstance(p, TensorProxy):
                m = TensorProxy(None, shape=p.shape, dtype=p.dtype, device=p.device)
            elif isinstance(p, NumberProxy):
                m = NumberProxy(p.value, p.python_type)
            else:
                m = AnyProxy(None)
            saved_mirror[p.name] = m
            bwd_args.append(m)
        cot_map: dict[str, Proxy] = {}
        for o in fwd_out_tensors:
            if _is_diff_dtype(o):
                c = TensorProxy(None, shape=o.shape, dtype=o.dtype, device=o.device)
                cot_map[o.name] = c
                bwd_args.append(c)
        bwd.args = tuple(bwd_args)

        # lazy replay of checkpointed segments: each tagged residual is
        # re-derived right before its first consuming grad rule
        recompute_producer: dict[str, Any] = {}
        for rb in recompute_subgraph:
            for o in rb.flat_proxy_outs():
                recompute_producer[o.name] = rb
        replayed: set = set()

        def materialize(name: str):
            rb = recompute_producer.get(name)
            if rb is None or id(rb) in replayed or name in saved_mirror:
                return
            replayed.add(id(rb))
            for p in rb.flat_proxy_args():
                materialize(p.name)
            new_out = rb.sym(*_map_names(rb.args, saved_mirror), **_map_names(rb.kwargs, saved_mirror))
            _map_into(rb.output, new_out, saved_mirror)

        grad_map: dict[str, Proxy] = dict(cot_map)

        def accumulate(p: TensorProxy, g):
            if g is None:
                return
            if tuple(g.shape) != tuple(p.shape):
                g = _sum_to_shape(g, p.shape)
            if g.dtype != p.dtype and p.dtype.is_inexact:
                g = prims.convert_element_type(g, p.dtype)
            prev = grad_map.get(p.name)
            grad_map[p.name] = g if prev is None else prims.add(prev, g)

        for entry in reversed(tape):
            cots = []
            any_cot = False
            for o in entry.outputs:
                c = grad_map.get(o.name)
                if c is not None:
                    any_cot = True
                else:
                    c = clang.full(o.shape, 0.0, dtype=o.dtype, device=o.device) if _is_diff_dtype(o) else None
                cots.append(c)
            if not any_cot:
                continue
            # fill missing cotangents with zeros for multi-output rules
            cots = [c for c, o in zip(cots, entry.outputs) if _is_diff_dtype(o) or c is not None]
            for r in flat_proxies(entry.residuals):
                materialize(r.name)
            res = tuple(_map_names(r, saved_mirror) for r in entry.residuals)
            grads = backward_impls[entry.sym_id](*res, *cots)
            if not isinstance(grads, tuple):
                grads = (grads,)
            for p, g in zip(entry.inputs, grads):
                if isinstance(p, TensorProxy) and g is not None and _is_diff_dtype(p):
                    accumulate(p, g)

        grads_out = []
        for p in grad_args:
            g = grad_map.get(p.name)
            if g is None:
                g = clang.full(p.shape, 0.0, dtype=p.dtype, device=p.device)
            grads_out.append(g)
        prims.python_return(tuple(grads_out))

    fwd = dce(fwd)
    bwd = dce(bwd)
    fwd.set_provenance("Augmented forward (autodiff)")
    bwd.set_provenance("Backward (autodiff)")
    return ForwardBackwardTraces(fwd, bwd, len(saved), grad_arg_names)


# ---------------------------------------------------------------------------
# runtime wrappers: value_and_grad / grad
# ---------------------------------------------------------------------------


class _VAGEntry(NamedTuple):
    fwd_fn: Callable
    bwd_fn: Callable
    grad_leaf_positions: tuple  # positions (within tensor leaves) receiving grads
    effect_keys: tuple = ()  # (owner, name) of the buffers the forward writes


class ThunderValueAndGrad:
    """Callable returning (value, grads). grads is a pytree matching (args,
    kwargs) with tensors at differentiated tensor leaves and None elsewhere.

    thunder_tpu/transforms/autodiff.py:ThunderValueAndGrad: the API is
    functional — no torch autograd tape is recorded; both programs run under
    ``torch.no_grad()``. Buffer writes of the forward come back beside its
    output, ``((output, effects), saved)``, and are replayed after the
    forward — or, with ``defer_effects`` set, kept for the caller to take
    with ``consume_pending_effects()`` and replay itself (TrainStep does,
    after its optimizer update, so a step's writes land together)."""

    defer_effects = False
    _pending_effects = None

    def __init__(self, fn: Callable, argnums=None, transforms: Sequence = (), executors=None):
        from ..common import CompileStats

        self.fn = fn
        self.argnums = (argnums,) if isinstance(argnums, int) else (tuple(argnums) if argnums is not None else None)
        self.transforms = list(transforms)
        self.executors = executors
        self._cache: dict = {}
        self._cs = CompileStats()

    def _grad_mask(self, args, kwargs) -> list:
        """Per-leaf requires-grad mask: argnums positions (or the leaves'
        own requires_grad flags)."""
        from ..core.pytree import tree_flatten

        if self.argnums is None:
            leaves, _ = tree_flatten((args, kwargs))
            return [bool(getattr(leaf, "requires_grad", False)) for leaf in leaves]
        masks = []
        for i, a in enumerate(args):
            leaves, _ = tree_flatten(a)
            masks.extend([i in self.argnums] * len(leaves))
        leaves, _ = tree_flatten(kwargs)
        masks.extend([False] * len(leaves))
        return masks

    def _compile(self, args, kwargs, grad_mask, key) -> _VAGEntry:
        from .. import acquire_trace
        from ..executors.passes import transform_for_execution
        from ..extend import get_default_executors

        trc = acquire_trace(self.fn, args, kwargs, grad_mask=grad_mask)
        for tf in self.transforms:
            _, trc = tf.transform_traces_pre_autodiff(None, trc, compile_data=None)
        trc = dce(trc)
        fb = forward_and_backward_traces(trc)
        fwd_trc, bwd_trc = fb.forward_trace, fb.backward_trace
        for tf in self.transforms:
            fwd_trc = tf.transform_trace_post_optimization(fwd_trc, compile_data=None)
            bwd_trc = tf.transform_trace_post_optimization(bwd_trc, compile_data=None)
        executors = self.executors or get_default_executors()
        fwd_claimed = transform_for_execution(fwd_trc, executors)
        bwd_claimed = transform_for_execution(bwd_trc, executors)
        self._cs.last_traces = [trc, fwd_trc, fwd_claimed]
        self._cs.last_backward_traces = [bwd_trc, bwd_claimed]
        arg_pos = {p.name: i for i, p in enumerate(trc.args)}
        entry = _VAGEntry(fwd_claimed.python_callable(), bwd_claimed.python_callable(),
                          tuple(arg_pos[n] for n in fb.grad_arg_names),
                          tuple((owner, name) for owner, name, _ in trc.side_effects))
        self._cache[key] = entry
        return entry

    def __call__(self, *args, **kwargs):
        from .. import _cache_key, _is_tensor_like
        from ..core.pytree import tree_flatten, tree_unflatten

        leaves, treedef = tree_flatten((args, kwargs))
        tensor_mask = [_is_tensor_like(leaf) for leaf in leaves]
        grad_mask = self._grad_mask(args, kwargs)
        key = _cache_key(leaves, tensor_mask, self.fn) + (("grad", tuple(grad_mask)),)
        entry = self._cache.get(key)
        if entry is None:
            self._cs.cache_misses.add()
            entry = self._compile(args, kwargs, grad_mask, key)
        else:
            self._cs.cache_hits.add()
        tensor_leaves = [leaf for leaf, m in zip(leaves, tensor_mask) if m]
        with torch.no_grad():
            out, saved = entry.fwd_fn(*tensor_leaves)
            if entry.effect_keys:
                out, effects = out
                if self.defer_effects:
                    self._pending_effects = (entry.effect_keys, effects)
                else:
                    apply_effects(entry.effect_keys, effects)
            # cotangent: scalar loss -> 1
            cot = torch.ones((), dtype=out.dtype, device=out.device)
            grads_flat = entry.bwd_fn(*saved, cot)
        del saved
        by_pos = dict(zip(entry.grad_leaf_positions, grads_flat))
        grad_leaves = []
        ti = 0
        for m in tensor_mask:
            if m:
                grad_leaves.append(by_pos.get(ti))
                ti += 1
            else:
                grad_leaves.append(None)
        return out, tree_unflatten(grad_leaves, treedef)


    def consume_pending_effects(self):
        """The deferred ``(effect_keys, effects)`` of the last call, or None."""
        out, self._pending_effects = self._pending_effects, None
        return out


def value_and_grad(fn, argnums=None):
    """(value, grads) over a callable, a Module, or a compiled function."""
    from .. import ThunderCompiledFunction
    from ..nn.module import Module, ThunderModule

    from ..interop.torch_frontend import CompiledTorchModule

    if isinstance(fn, ThunderModule):
        return ModuleValueAndGrad(fn)
    if isinstance(fn, CompiledTorchModule):
        return TorchModuleValueAndGrad(fn)
    if isinstance(fn, Module):
        from .. import jit

        return value_and_grad(jit(fn))
    if isinstance(fn, ThunderCompiledFunction):
        return ThunderValueAndGrad(fn._cd.fn, argnums, transforms=fn._cd.transforms,
                                   executors=fn._cd.executors)
    return ThunderValueAndGrad(fn, argnums)


def grad(fn, argnums=None):
    vag = value_and_grad(fn, argnums)

    def grad_fn(*args, **kwargs):
        _, g = vag(*args, **kwargs)
        return g

    grad_fn.__wrapped_vag__ = vag
    return grad_fn


class ModuleValueAndGrad:
    """value_and_grad over a ThunderModule: returns (loss, {param_name: grad}).

    The traced wrapper takes (params_dict, args, kwargs); parameters are
    requires_grad leaves, so grads land exactly on them."""

    def __init__(self, tmodule):
        self.tmodule = tmodule
        cd = tmodule._cfn._cd
        self._vag = ThunderValueAndGrad(cd.fn, argnums=None, transforms=cd.transforms,
                                        executors=cd.executors)

    @property
    def _cs(self):
        return self._vag._cs

    def __call__(self, *args, **kwargs):
        # buffers ride as (requires_grad=False) inputs so mutable state is
        # not baked into the trace as constants
        state = {**self.tmodule.get_parameters(), **self.tmodule.get_buffers()}
        loss, grads = self._vag(state, args, kwargs)
        all_grads = grads[0][0]  # grads mirrors ((state, args, kwargs), {})
        param_names = set(self.tmodule.get_parameters())
        return loss, {k: g for k, g in all_grads.items() if k in param_names}


class TorchModuleValueAndGrad(ModuleValueAndGrad):
    """value_and_grad over a CompiledTorchModule (the torch frontend's
    wrapper): ``(loss, {parameter name: grad})`` for the trainable
    parameters, whose live tensors are the program's inputs
    (thunder_tpu/transforms/autodiff.py:TorchModuleValueAndGrad; there every
    parameter gets one: jax arrays carry no requires_grad). It runs op by
    op, as every value_and_grad does."""

    def __call__(self, *args, **kwargs):
        loss, grads = super().__call__(*args, **kwargs)
        return loss, {k: g for k, g in grads.items() if g is not None}

