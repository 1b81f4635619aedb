"""torchex: the op-by-op PyTorch executor — one torch call per prim.

The port's counterpart of thunder_tpu/executors/jaxex.py: the "always"
executor, which runs every prim the port's traces contain, on whatever device
the tensors live on. Where jax and torch disagree on a prim's semantics the
impl follows jax (the reference): dynamic_slice clamps its start, an empty
reduction axis list reduces nothing, integer DIV floors.

It also runs the composite ``ltorch.index_put`` whole, as one torch
``index_put``; executors/passes.py swaps in the in-place form where the
target is a dead program input."""
from __future__ import annotations

import builtins
from numbers import Number

import torch
import torch.nn.functional as F

from ..core import dtypes, prims
from ..core.dtypes import to_torch_dtype
from ..core.prims import PrimIDs
from ..extend import OperatorExecutor, add_always_executor, register_executor

ex = OperatorExecutor("torch")
register_executor(ex)
add_always_executor(ex)


def _reg(pid, fn):
    ex.register_implementation(pid, fn)
    return fn


def _dev(device):
    return None if device is None else device.torch_device()


# ---- structure / checks ----
_reg(PrimIDs.PRINT, print)
_reg(PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA, prims.check_tensor_shape_and_metadata.python_impl)
_reg(PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE, prims.check_number_type_and_value.python_impl)


# ---- dtype/device ----
def _convert_element_type(a, dtype):
    if isinstance(a, Number):
        return dtypes.dtype_to_numbertype(dtype)(a)
    return a.to(to_torch_dtype(dtype))


_reg(PrimIDs.CONVERT_ELEMENT_TYPE, _convert_element_type)
_reg(PrimIDs.DEVICE_PUT, lambda a, device: a.to(_dev(device)))
_reg(PrimIDs.STOP_GRADIENT, lambda a: a.detach())
_reg(PrimIDs.BITCAST, lambda a, dtype: a.view(to_torch_dtype(dtype)))

# ---- factories ----
_reg(PrimIDs.TENSOR_CONSTANT, lambda array: array)


def _full(shape, fill_value, *, device=None, dtype=None):
    return torch.full(tuple(shape), fill_value, dtype=to_torch_dtype(dtype), device=_dev(device))


_reg(PrimIDs.FULL, _full)


def _iota(length, *, start=0, step=1, device=None, dtype=None):
    return torch.arange(start, start + length * step, step, dtype=to_torch_dtype(dtype),
                        device=_dev(device))[:length]


_reg(PrimIDs.IOTA, _iota)

# ---- shape ops ----
_reg(PrimIDs.RESHAPE, lambda a, shape: torch.reshape(a, tuple(shape)))
_reg(PrimIDs.TRANSPOSE, lambda a, permutation: a.permute(tuple(permutation)))


def _broadcast_in_dim(a, shape, broadcast_dimensions):
    view = [1] * len(shape)
    for i, d in enumerate(broadcast_dimensions):
        view[d] = a.shape[i]
    return a.reshape(view).expand(tuple(shape))


_reg(PrimIDs.BROADCAST_IN_DIM, _broadcast_in_dim)


def _slice(a, start_indices, limit_indices, strides=None):
    strides = strides or (1,) * a.ndim
    return a[tuple(builtins.slice(s, l, st) for s, l, st in zip(start_indices, limit_indices, strides))]


_reg(PrimIDs.SLICE, _slice)
_reg(PrimIDs.SQUEEZE, lambda a, dims: a.squeeze(tuple(dims)))
_reg(PrimIDs.CAT, lambda tensors, dim: torch.cat(list(tensors), dim))
_reg(PrimIDs.FLIP, lambda a, dims: torch.flip(a, tuple(dims)))


def _pad(a, padding_value, padding_config):
    """lax.pad: per dim (lo, hi, interior); negative lo/hi crop. The slice
    VJP emits it (transforms/autodiff.py)."""
    grown = [(builtins.max(lo, 0), builtins.max(hi, 0), it) for lo, hi, it in padding_config]
    shape = [lo + hi + s + builtins.max(0, s - 1) * it for s, (lo, hi, it) in zip(a.shape, grown)]
    out = torch.full(shape, padding_value, dtype=a.dtype, device=a.device)
    out[tuple(builtins.slice(lo, lo + builtins.max(0, s - 1) * (it + 1) + builtins.min(s, 1), it + 1)
              for s, (lo, _, it) in zip(a.shape, grown))] = a
    crop = tuple(builtins.slice(-builtins.min(lo, 0), n + builtins.min(hi, 0))
                 for n, (lo, hi, _) in zip(shape, padding_config))
    return out[crop]


_reg(PrimIDs.PAD, _pad)


def _take(a, indices, dim):
    out = torch.index_select(a, dim, indices.reshape(-1))
    return out.reshape(a.shape[:dim] + indices.shape + a.shape[dim + 1:])


_reg(PrimIDs.TAKE, _take)
_reg(PrimIDs.TAKE_ALONG_AXIS, lambda a, indices, dim: torch.take_along_dim(a, indices.long(), dim))


def _index_add(a, indices, value, dim):
    """a.index_add(dim, indices, value). On the card torch's index_add sums
    a repeated index with atomics, in whatever order the threads land, so
    two runs of one f32 step (the embedding gradient) could differ in the
    last bits. index_put with accumulate sorts the indices and sums each
    run of a repeated index in one thread in a fixed order: the same sum
    every run, as thunder_tpu's scatter-add on the TPU."""
    if a.device.type != "cuda":
        return a.index_add(dim, indices, value)
    out = a.movedim(dim, 0).index_put((indices.long(),), value.movedim(dim, 0), accumulate=True)
    return out.movedim(0, dim)


_reg(PrimIDs.INDEX_ADD, _index_add)
_reg(PrimIDs.SCATTER_ADD, lambda a, indices, value, dim: a.scatter_add(dim, indices.long(), value))
_reg(PrimIDs.SCATTER, lambda a, indices, value, dim: a.scatter(dim, indices.long(), value))


def _window(a, start_indices, sizes):
    """Index tensors of the window a[start:start+size] on every dim, starts
    clamped as lax.dynamic_slice clamps them (a start may be a 0-d tensor:
    no host sync, one program for every position)."""
    idx = []
    for d, (start, size) in enumerate(zip(start_indices, sizes)):
        hi = a.shape[d] - size
        if isinstance(start, torch.Tensor):
            start = torch.clamp(start.reshape(()), 0, hi)
        else:
            start = builtins.min(builtins.max(int(start), 0), hi)
        shape = [1] * a.ndim
        shape[d] = size
        idx.append((start + torch.arange(size, device=a.device)).reshape(shape))
    return tuple(idx)


def _dynamic_slice(a, start_indices, slice_sizes):
    sizes = tuple(int(s) for s in slice_sizes)
    return a[_window(a, start_indices, sizes)]


def _dynamic_update_slice(a, update, start_indices):
    out = a.clone()
    out[_window(a, start_indices, tuple(update.shape))] = update
    return out


_reg(PrimIDs.DYNAMIC_SLICE, _dynamic_slice)
_reg(PrimIDs.DYNAMIC_UPDATE_SLICE, _dynamic_update_slice)

# ---- elementwise unary ----
_unary_impls = {
    PrimIDs.ABS: torch.abs, PrimIDs.NEG: torch.neg, PrimIDs.EXP: torch.exp, PrimIDs.EXP2: torch.exp2,
    PrimIDs.EXPM1: torch.expm1, PrimIDs.LOG: torch.log, PrimIDs.LOG1P: torch.log1p, PrimIDs.LOG2: torch.log2,
    PrimIDs.SQRT: torch.sqrt, PrimIDs.RSQRT: torch.rsqrt, PrimIDs.SIN: torch.sin, PrimIDs.COS: torch.cos,
    PrimIDs.TAN: torch.tan, PrimIDs.TANH: torch.tanh, PrimIDs.ASIN: torch.asin, PrimIDs.ACOS: torch.acos,
    PrimIDs.ATAN: torch.atan, PrimIDs.SINH: torch.sinh, PrimIDs.COSH: torch.cosh, PrimIDs.ASINH: torch.asinh,
    PrimIDs.ACOSH: torch.acosh, PrimIDs.ATANH: torch.atanh, PrimIDs.ERF: torch.erf, PrimIDs.ERFC: torch.erfc,
    PrimIDs.ERFINV: torch.erfinv, PrimIDs.FLOOR: torch.floor, PrimIDs.CEIL: torch.ceil,
    PrimIDs.ROUND: torch.round, PrimIDs.TRUNC: torch.trunc, PrimIDs.SIGN: torch.sign,
    PrimIDs.ISFINITE: torch.isfinite, PrimIDs.ISNAN: torch.isnan, PrimIDs.ISINF: torch.isinf,
    PrimIDs.RECIPROCAL: torch.reciprocal, PrimIDs.LOGICAL_NOT: torch.logical_not,
    PrimIDs.BITWISE_NOT: torch.bitwise_not, PrimIDs.REAL: torch.real, PrimIDs.IMAG: torch.imag,
    PrimIDs.LOG10: torch.log10, PrimIDs.LGAMMA: torch.lgamma, PrimIDs.DIGAMMA: torch.digamma,
    PrimIDs.SIGNBIT: torch.signbit,
}
for pid, fn in _unary_impls.items():
    _reg(pid, fn)

# ---- elementwise binary ----
_binary_impls = {
    PrimIDs.ADD: torch.add, PrimIDs.SUB: torch.sub, PrimIDs.MUL: torch.mul,
    PrimIDs.POW: torch.pow, PrimIDs.FMOD: torch.fmod,
    PrimIDs.REMAINDER: torch.remainder, PrimIDs.MAXIMUM: torch.maximum, PrimIDs.MINIMUM: torch.minimum,
    PrimIDs.ATAN2: torch.atan2, PrimIDs.BITWISE_AND: torch.bitwise_and,
    PrimIDs.BITWISE_OR: torch.bitwise_or, PrimIDs.BITWISE_XOR: torch.bitwise_xor,
    PrimIDs.SHIFT_LEFT: torch.bitwise_left_shift, PrimIDs.SHIFT_RIGHT: torch.bitwise_right_shift,
    PrimIDs.EQ: torch.eq, PrimIDs.NE: torch.ne, PrimIDs.LT: torch.lt,
    PrimIDs.LE: torch.le, PrimIDs.GT: torch.gt, PrimIDs.GE: torch.ge,
    PrimIDs.NEXTAFTER: torch.nextafter, PrimIDs.COPYSIGN: torch.copysign, PrimIDs.HYPOT: torch.hypot,
    PrimIDs.GCD: torch.gcd, PrimIDs.LCM: torch.lcm,
}
for pid, fn in _binary_impls.items():
    _reg(pid, fn)


def _div(a, b):
    # float operands arrive pre-promoted (clang.true_divide); integer ones
    # only through clang.floor_divide, whose meta keeps the integer dtype
    if not a.dtype.is_floating_point and not a.dtype.is_complex:
        return torch.div(a, b, rounding_mode="floor")
    return torch.div(a, b)


_reg(PrimIDs.DIV, _div)
_reg(PrimIDs.WHERE, torch.where)


# ---- reductions ----
def _reduce(fn):
    # an empty axis list reduces nothing (jnp semantics); torch would
    # reduce over every axis
    def impl(a, dims, **kw):
        if not dims:
            dt = kw.get("dtype")
            return a if dt is None else a.to(dt)
        return fn(a, tuple(dims), **kw)
    return impl


_sum = _reduce(lambda a, dims, dtype=None: torch.sum(a, dim=dims, dtype=dtype))
_reg(PrimIDs.SUM, lambda a, dims, *, output_dtype=None: _sum(a, dims, dtype=to_torch_dtype(output_dtype)))
_reg(PrimIDs.AMAX, _reduce(lambda a, dims: torch.amax(a, dim=dims)))
_reg(PrimIDs.AMIN, _reduce(lambda a, dims: torch.amin(a, dim=dims)))
_reg(PrimIDs.ANY, _reduce(lambda a, dims: torch.any(a, dim=dims)))


def _prod(a, dims, *, output_dtype=None):
    out = a if output_dtype is None else a.to(to_torch_dtype(output_dtype))
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d)
    return out


_reg(PrimIDs.PROD, _prod)


def _var(a, dims, correction=1):
    n = 1
    for d in dims:
        n *= a.shape[d]
    if not a.dtype.is_floating_point and not a.dtype.is_complex:
        a = a.to(torch.float32)
    centered = a - torch.mean(a, dim=tuple(dims), keepdim=True)
    sq = (centered * centered.conj()).real if a.is_complex() else centered * centered
    # torch divides by max(0, n - correction): inf for over-corrected counts
    return torch.sum(sq, dim=tuple(dims)) / builtins.max(0, n - correction)


_reg(PrimIDs.VAR, _var)
_reg(PrimIDs.ARGMAX, lambda a, dim: torch.argmax(a, dim=dim))
_reg(PrimIDs.ARGMIN, lambda a, dim: torch.argmin(a, dim=dim))
_reg(PrimIDs.CUMSUM, lambda a, dim: torch.cumsum(a, dim, dtype=a.dtype))
_reg(PrimIDs.CUMPROD, lambda a, dim: torch.cumprod(a, dim, dtype=a.dtype))


def _cummax(a, dim):
    """Running max and the index it came from: a tie keeps the later index
    and a NaN propagates with its own, as thunder_tpu's scan does (and
    torch.cummax)."""
    values, indices = torch.cummax(a, dim)
    return values, indices.to(torch.int32)


_reg(PrimIDs.CUMMAX, _cummax)


def _topk(a, k, dim):
    """lax.top_k's order: values descending, equal values lowest index
    first (torch.topk leaves ties in no set order). A stable descending
    sort keeps it, on the CPU and on the card, with no host sync."""
    v, i = torch.sort(a, dim=dim, descending=True, stable=True)
    return v.narrow(dim, 0, k), i.narrow(dim, 0, k).to(torch.int32)


_reg(PrimIDs.TOPK, _topk)
_reg(PrimIDs.ARGSORT, lambda a, dim, descending=False: torch.argsort(
    a, dim=dim, descending=descending, stable=True).to(torch.int32))
_reg(PrimIDs.SORT, lambda a, dim, descending=False: torch.sort(
    a, dim=dim, descending=descending, stable=True).values)

# ---- linear algebra / NN ----
# bf16 products accumulate in f32 and round once, as thunder_tpu's
# preferred_element_type matmuls do
_reg(PrimIDs.MATMUL, torch.matmul)
# the bias is added by ltorch.linear as its own op (thunder_tpu's LINEAR
# prim ignores it too)
_reg(PrimIDs.LINEAR, lambda a, w, bias=None: F.linear(a, w))
_reg(PrimIDs.EMBEDDING, lambda indices, weight: F.embedding(indices, weight))


# Convolutions: thunder_tpu's jaxex computes them with XLA's
# conv_general_dilated (preferred_element_type f32 for bf16, then cast back),
# no Pallas kernel; here one torch call, which sums bf16 products in f32 and
# rounds once (cuDNN on the card). ltorch adds a layer's bias as its own op
# and passes the prim none.
def _convolution(a, weight, bias, stride, padding, dilation, groups):
    return torch.convolution(a, weight, bias, tuple(stride), tuple(padding), tuple(dilation), False,
                             (0,) * (a.ndim - 2), groups)


def _conv_transpose(a, weight, bias, stride, padding, output_padding, dilation, groups):
    """weight (Cin, Cout/groups, *K): torch's conv_transpose layout, and
    thunder_tpu's (jaxex.py:_conv_transpose)."""
    return torch.convolution(a, weight, bias, tuple(stride), tuple(padding), tuple(dilation), True,
                             tuple(output_padding), groups)


_reg(PrimIDs.CONVOLUTION, _convolution)
_reg(PrimIDs.CONV_TRANSPOSE, _conv_transpose)


def _conv_backward(g, a, weight, stride, padding, dilation, transposed, output_padding, groups, which):
    mask = [which == 0, which == 1, False]
    out = torch.ops.aten.convolution_backward(g, a, weight, None, list(stride), list(padding),
                                              list(dilation), transposed, list(output_padding), groups,
                                              mask)
    return out[which]


def _conv_backward_meta(which):
    def meta(g, a, weight, stride, padding, dilation, transposed, output_padding, groups):
        from ..core.proxies import TensorProxy

        like = a if which == 0 else weight
        return TensorProxy(shape=like.shape, dtype=like.dtype, device=like.device)
    return meta


# The grad rules of CONVOLUTION and CONV_TRANSPOSE (transforms/autodiff.py)
# record these two operators: the input's and the weight's gradient, each
# one aten.convolution_backward call (cuDNN's on the card) that computes
# only its own output, so dead-code elimination drops the one no input needs
# (the stem conv's input gradient).
conv_backward_input = ex.register_operator(
    "conv_backward_input", meta=_conv_backward_meta(0),
    fn=lambda g, a, w, *conv: _conv_backward(g, a, w, *conv, 0))
conv_backward_weight = ex.register_operator(
    "conv_backward_weight", meta=_conv_backward_meta(1),
    fn=lambda g, a, w, *conv: _conv_backward(g, a, w, *conv, 1))


# REDUCE_WINDOW (thunder_tpu's pooling prim): padding fills with the op's
# identity, -inf / +inf / 0 (jaxex.py:_reduce_window), integers with their
# extremes. A 4-d window over the last two dims with even pads that torch's
# pooling takes runs as max_pool2d (min as -max_pool2d(-a)) or avg_pool2d
# with divisor 1; any other window as pad + unfold + reduce.
def _window_fill(a, op):
    if op == "sum":
        return 0
    if a.dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(a.dtype)
    return info.min if op == "max" else info.max


def _reduce_window(a, window_dims, strides, padding, *, op="max"):
    window_dims, strides = tuple(int(w) for w in window_dims), tuple(int(s) for s in strides)
    padding = tuple((int(lo), int(hi)) for lo, hi in padding)
    if (a.ndim == 4 and a.dtype.is_floating_point and window_dims[:2] == (1, 1) and strides[:2] == (1, 1)
            and padding[:2] == ((0, 0), (0, 0)) and all(lo == hi and 2 * lo <= w for (lo, hi), w
                                                         in zip(padding[2:], window_dims[2:]))):
        ks, st, pd = window_dims[2:], strides[2:], tuple(lo for lo, _ in padding[2:])
        if op == "max":
            return F.max_pool2d(a, ks, st, pd)
        if op == "min":
            return -F.max_pool2d(-a, ks, st, pd)
        return F.avg_pool2d(a, ks, st, pd, count_include_pad=True, divisor_override=1)
    flat = [p for lo_hi in reversed(padding) for p in lo_hi]
    x = F.pad(a, flat, value=_window_fill(a, op)) if any(flat) else a
    dims = []
    for d, (w, s) in enumerate(zip(window_dims, strides)):
        if w != 1 or s != 1:
            x = x.unfold(d, w, s)
            dims.append(x.ndim - 1)
    if not dims:
        return x.clone()
    if op == "max":
        return torch.amax(x, dim=dims)
    if op == "min":
        return torch.amin(x, dim=dims)
    return torch.sum(x, dim=dims, dtype=a.dtype)


_reg(PrimIDs.REDUCE_WINDOW, _reduce_window)

# ---- memory / interop ----
_reg(PrimIDs.ITEM, lambda a: a.item())


def _copy_with_setitem(a, key, value):
    out = a.clone()
    out[key] = value
    return out


_reg(PrimIDs.COPY_WITH_SETITEM, _copy_with_setitem)
_reg(PrimIDs.UPDATE_ALIASES, lambda tensors: tuple(tensors))


# ---- composite: index_put ----
def index_put_out_of_place(a, indices, values, accumulate=False):
    return a.index_put(tuple(indices), values, accumulate)


def index_put_in_place(a, indices, values, accumulate=False):
    return a.index_put_(tuple(indices), values, accumulate)


def _index_put_supported(a, indices, values, accumulate=False):
    return (len(indices) >= 1 and all(getattr(i, "ndim", None) == 1 for i in indices)
            and values.dtype == a.dtype)


ex.register_implementation("torch.index_put", index_put_out_of_place, checker=_index_put_supported)


# ---- weight-only quantized linears (transforms/quantization.py) ----
# As thunder_tpu's jax impls compute them: the weights are dequantized and
# rounded to bf16 BEFORE the product, whatever x's dtype (the kernels of
# executors/cudaex.py differ: int8 scales after the f32 sum, NF4 rounds to
# x's dtype). The product accumulates in f32 and rounds once to x's dtype.
from ..transforms.quantization import dequantize_nf4, dequantize_nf4_kl  # noqa: E402


def _dequant_linear(x, w, bias):
    out = torch.matmul(x, w.t().to(x.dtype))
    return out if bias is None else out + bias


def _quantized_linear_impl(x, qweight, scale, bias=None):
    w = qweight.to(torch.bfloat16) * scale.to(torch.bfloat16)[:, None]
    return _dequant_linear(x, w, bias)


def _nf4_linear_impl(x, packed, absmax, out_features, in_features, block_size=64, bias=None):
    w = dequantize_nf4(packed, absmax, (out_features, in_features), block_size).to(torch.bfloat16)
    return _dequant_linear(x, w, bias)


def _nf4_linear_kl_impl(x, packed_kl, absmax_kl, out_features, in_features, block_size=64, bias=None):
    w = dequantize_nf4_kl(packed_kl, absmax_kl, (out_features, in_features), block_size)
    return _dequant_linear(x, w.to(torch.bfloat16), bias)


_reg("quant.linear_int8", _quantized_linear_impl)
_reg("quant.linear_nf4", _nf4_linear_impl)
_reg("quant.linear_nf4_kl", _nf4_linear_kl_impl)
_reg("quant.nf4_dequant", lambda packed, absmax, o, i, block_size=64: dequantize_nf4(
    packed, absmax, (o, i), block_size))
_reg("quant.nf4_dequant_kl", lambda packed_kl, absmax_kl, o, i, block_size=64: dequantize_nf4_kl(
    packed_kl, absmax_kl, (o, i), block_size))


# ---------------------------------------------------------------------------
# eager escape hatch: execute a symbol on concrete values by tracing it
# ---------------------------------------------------------------------------


def eager_execute(sym, *args, **kwargs):
    from ..core.proxies import proxy_from_torch
    from ..core.trace import TraceCtx, tracectx
    from .passes import transform_for_execution

    trc = TraceCtx(None)
    flat_concrete = []
    with tracectx(trc):
        def proxify(x):
            if not isinstance(x, torch.Tensor):
                return x
            p = proxy_from_torch(x)
            flat_concrete.append((p, x))
            return p

        pargs = [proxify(a) for a in args]
        pkwargs = {k: proxify(v) for k, v in kwargs.items()}
        if flat_concrete:
            trc.device = flat_concrete[0][0].device
        out = sym(*pargs, **pkwargs)
        prims.python_return(out)
    trc.args = tuple(p for p, _ in flat_concrete)
    trc = transform_for_execution(trc, [ex])
    fn = trc.python_callable()
    with torch.no_grad():
        return fn(*[v for _, v in flat_concrete])
