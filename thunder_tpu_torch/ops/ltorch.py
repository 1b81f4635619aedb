"""Torch-like operation namespace: the user-facing symbol layer.

The ltorch namespace of thunder_tpu/ops/ltorch.py, copied with the same
symbol names and ids, cut to the ops the port's slices trace (the rest of
thunder_tpu's catalog waits for the slices that need it). Each op here is a
composite Symbol whose meta decomposes into clang helpers → prims, giving the
hierarchical bsym IR that executors claim at whatever level they support
(cudaex claims `rms_norm` and `paged_attention` whole; torchex runs the
flattened prims). Tensor methods on TensorProxy resolve here through the
method registry."""
from __future__ import annotations

import builtins
import math
from numbers import Number
from typing import Optional, Sequence

from ..core import dtypes, prims
from ..core.baseutils import canonicalize_dim, check
from ..core.proxies import NumberProxy, TensorProxy, pyval, register_method
from ..core.symbol import OpTags, Symbol
from . import clang

_torch_symbols: dict[str, Symbol] = {}


def torchsymbol(*, name: str, method_names: Sequence[str] = (), id: str | None = None, tags=()):
    """Create a composite Symbol and register tensor methods for it."""

    def decorator(meta):
        sym = Symbol(name, meta, id=id or f"torch.{name}", module="ltorch", tags=tags)
        _torch_symbols[sym.id] = sym
        for m in method_names:
            register_method(m, sym)
        return sym

    return decorator


def get_symbol(id: str) -> Symbol:
    return _torch_symbols[id]


# ---------------------------------------------------------------------------
# elementwise binary
# ---------------------------------------------------------------------------


@torchsymbol(name="add", method_names=("add",))
def add(a, b, *, alpha=None):
    if alpha is not None and pyval(alpha) != 1:
        b = clang.mul(b, alpha)
    return clang.add(a, b)


@torchsymbol(name="sub", method_names=("sub",))
def sub(a, b, *, alpha=None):
    if alpha is not None and pyval(alpha) != 1:
        b = clang.mul(b, alpha)
    return clang.sub(a, b)


@torchsymbol(name="mul", method_names=("mul",))
def mul(a, b):
    return clang.mul(a, b)


@torchsymbol(name="div", method_names=("div", "true_divide"))
def div(a, b):
    return clang.true_divide(a, b)


@torchsymbol(name="floor_divide", method_names=("floor_divide",))
def floor_divide(a, b):
    return clang.floor_divide(a, b)


@torchsymbol(name="pow", method_names=("pow",))
def pow(a, b):
    return clang.pow_(a, b)


@torchsymbol(name="remainder", method_names=("remainder",))
def remainder(a, b):
    return clang.remainder(a, b)


@torchsymbol(name="fmod", method_names=("fmod",))
def fmod(a, b):
    return clang.fmod(a, b)


@torchsymbol(name="maximum", method_names=("maximum",))
def maximum(a, b):
    return clang.maximum(a, b)


@torchsymbol(name="minimum", method_names=("minimum",))
def minimum(a, b):
    return clang.minimum(a, b)


@torchsymbol(name="atan2", method_names=("atan2",))
def atan2(a, b):
    return clang.atan2(a, b)


@torchsymbol(name="eq", method_names=("eq",))
def eq(a, b):
    return clang.eq(a, b)


@torchsymbol(name="ne", method_names=("ne",))
def ne(a, b):
    return clang.ne(a, b)


@torchsymbol(name="lt", method_names=("lt",))
def lt(a, b):
    return clang.lt(a, b)


@torchsymbol(name="le", method_names=("le",))
def le(a, b):
    return clang.le(a, b)


@torchsymbol(name="gt", method_names=("gt",))
def gt(a, b):
    return clang.gt(a, b)


@torchsymbol(name="ge", method_names=("ge",))
def ge(a, b):
    return clang.ge(a, b)


@torchsymbol(name="bitwise_and", method_names=("bitwise_and",))
def bitwise_and(a, b):
    return clang.bitwise_and(a, b)


@torchsymbol(name="bitwise_or", method_names=("bitwise_or",))
def bitwise_or(a, b):
    return clang.bitwise_or(a, b)


@torchsymbol(name="bitwise_xor", method_names=("bitwise_xor",))
def bitwise_xor(a, b):
    return clang.bitwise_xor(a, b)


@torchsymbol(name="logical_and", method_names=("logical_and",))
def logical_and(a, b):
    return clang.logical_and(a, b)


@torchsymbol(name="logical_or", method_names=("logical_or",))
def logical_or(a, b):
    return clang.logical_or(a, b)


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------


def _unary(name, prim, method_names=None, int_to_float=False):
    def meta(a):
        if int_to_float and isinstance(a, TensorProxy) and not a.dtype.is_inexact:
            a = clang.maybe_convert_to_dtype(a, dtypes.float32)
        return prim(a)

    meta.__name__ = name
    sym = Symbol(name, meta, id=f"torch.{name}", module="ltorch")
    _torch_symbols[sym.id] = sym
    for m in method_names or (name,):
        register_method(m, sym)
    return sym


abs = _unary("abs", prims.abs)
neg = _unary("neg", prims.neg)
exp = _unary("exp", prims.exp, int_to_float=True)
exp2 = _unary("exp2", prims.exp2, int_to_float=True)
expm1 = _unary("expm1", prims.expm1, int_to_float=True)
log = _unary("log", prims.log, int_to_float=True)
log1p = _unary("log1p", prims.log1p, int_to_float=True)
log2 = _unary("log2", prims.log2, int_to_float=True)
sqrt = _unary("sqrt", prims.sqrt, int_to_float=True)
rsqrt = _unary("rsqrt", prims.rsqrt, int_to_float=True)
sin = _unary("sin", prims.sin, int_to_float=True)
cos = _unary("cos", prims.cos, int_to_float=True)
tan = _unary("tan", prims.tan, int_to_float=True)
tanh = _unary("tanh", prims.tanh, int_to_float=True)
asin = _unary("asin", prims.asin, int_to_float=True)
acos = _unary("acos", prims.acos, int_to_float=True)
atan = _unary("atan", prims.atan, int_to_float=True)
sinh = _unary("sinh", prims.sinh, int_to_float=True)
cosh = _unary("cosh", prims.cosh, int_to_float=True)
erf = _unary("erf", prims.erf, int_to_float=True)
erfc = _unary("erfc", prims.erfc, int_to_float=True)
floor = _unary("floor", prims.floor)
ceil = _unary("ceil", prims.ceil)
round = _unary("round", prims.round)
trunc = _unary("trunc", prims.trunc)
sign = _unary("sign", prims.sign)
isfinite = _unary("isfinite", prims.isfinite)
isnan = _unary("isnan", prims.isnan)
isinf = _unary("isinf", prims.isinf)
reciprocal = _unary("reciprocal", prims.reciprocal, int_to_float=True)
logical_not = _unary("logical_not", prims.logical_not)
bitwise_not = _unary("bitwise_not", prims.bitwise_not)


@torchsymbol(name="sigmoid", method_names=("sigmoid",))
def sigmoid(a):
    if not a.dtype.is_inexact:
        a = clang.maybe_convert_to_dtype(a, dtypes.float32)
    return clang.true_divide(1.0, clang.add(1.0, prims.exp(prims.neg(a))))


@torchsymbol(name="relu", method_names=("relu",))
def relu(a):
    return clang.maximum(a, 0)


@torchsymbol(name="relu6")
def relu6(a):
    return clang.minimum(clang.maximum(a, 0), 6)


@torchsymbol(name="leaky_relu")
def leaky_relu(a, negative_slope=0.01):
    return clang.where(clang.gt(a, 0), a, clang.mul(a, negative_slope))


@torchsymbol(name="gelu", id="torch.gelu")
def gelu(a, approximate: str = "none"):
    if approximate == "tanh":
        inner = clang.mul(
            math.sqrt(2.0 / math.pi), clang.add(a, clang.mul(0.044715, clang.mul(a, clang.mul(a, a))))
        )
        return clang.mul(clang.mul(0.5, a), clang.add(1.0, prims.tanh(inner)))
    return clang.mul(clang.mul(0.5, a), clang.add(1.0, prims.erf(clang.mul(a, 1.0 / math.sqrt(2.0)))))


@torchsymbol(name="silu")
def silu(a):
    return clang.mul(a, clang.true_divide(1.0, clang.add(1.0, prims.exp(prims.neg(a)))))


@torchsymbol(name="softplus")
def softplus(a, beta=1.0, threshold=20.0):
    scaled = clang.mul(a, beta)
    sp = clang.true_divide(prims.log1p(prims.exp(scaled)), beta)
    return clang.where(clang.gt(scaled, threshold), a, sp)


@torchsymbol(name="mish")
def mish(a):
    return clang.mul(a, prims.tanh(prims.log1p(prims.exp(a))))


@torchsymbol(name="clamp", method_names=("clamp", "clip"))
def clamp(a, min=None, max=None):
    check(min is not None or max is not None,
          lambda: "clamp: at least one of min or max must not be None")
    if min is not None:
        a = clang.maximum(a, min)
    if max is not None:
        a = clang.minimum(a, max)
    return a


@torchsymbol(name="masked_fill", method_names=("masked_fill",))
def masked_fill(a, mask, value):
    mdt = dtypes.to_dtype(getattr(mask, "dtype", None))  # proxy OR concrete dtype
    check(mdt is None or mdt.is_bool,
          lambda: f"masked_fill expects a bool mask, got {mdt.name}")
    return clang.where(mask, value, a)


@torchsymbol(name="where")
def where(pred, a, b):
    return clang.where(pred, a, b)


@torchsymbol(name="tril", method_names=("tril",))
def tril(a, diagonal=0):
    check(a.ndim >= 2, lambda: f"tril expects a tensor with at least 2 dims, got {a.ndim}")
    rows, cols = a.shape[-2], a.shape[-1]
    r = clang.unsqueeze(prims.iota(rows, dtype=dtypes.int32, device=a.device), 1)
    c = clang.unsqueeze(prims.iota(cols, dtype=dtypes.int32, device=a.device), 0)
    mask = clang.ge(clang.sub(clang.add(r, diagonal), c), 0)
    return clang.where(mask, a, clang.full_like(a, 0))


@torchsymbol(name="triu", method_names=("triu",))
def triu(a, diagonal=0):
    check(a.ndim >= 2, lambda: f"triu expects a tensor with at least 2 dims, got {a.ndim}")
    rows, cols = a.shape[-2], a.shape[-1]
    r = clang.unsqueeze(prims.iota(rows, dtype=dtypes.int32, device=a.device), 1)
    c = clang.unsqueeze(prims.iota(cols, dtype=dtypes.int32, device=a.device), 0)
    mask = clang.ge(clang.sub(c, clang.add(r, diagonal)), 0)
    return clang.where(mask, a, clang.full_like(a, 0))


# ---------------------------------------------------------------------------
# dtype/device conversion
# ---------------------------------------------------------------------------


@torchsymbol(name="to", method_names=("to",))
def to(a, dtype_or_device=None, *, dtype=None, device=None):
    from ..core.devices import Device

    if isinstance(dtype_or_device, (dtypes.dtype,)) or dtype_or_device in (float, int, bool):
        dtype = dtype_or_device
    elif dtype_or_device is not None:
        device = dtype_or_device
    out = a
    if dtype is not None and dtypes.to_dtype(dtype) != a.dtype:
        out = prims.convert_element_type(out, dtypes.to_dtype(dtype))
    if device is not None:
        out = prims.device_put(out, device)
    return out


@torchsymbol(name="type_as", method_names=("type_as",))
def type_as(a, b):
    return prims.convert_element_type(a, b.dtype) if a.dtype != b.dtype else a


for _n, _d in (("float", dtypes.float32), ("double", dtypes.float64), ("half", dtypes.float16),
               ("bfloat16", dtypes.bfloat16), ("long", dtypes.int64), ("int", dtypes.int32),
               ("bool", dtypes.bool8)):
    def _mk(dt):
        def meta(a):
            return prims.convert_element_type(a, dt) if a.dtype != dt else a
        return meta
    _s = Symbol(_n, _mk(_d), id=f"torch.{_n}", module="ltorch")
    _torch_symbols[_s.id] = _s
    register_method(_n, _s)


@torchsymbol(name="detach", method_names=("detach",))
def detach(a):
    return prims.stop_gradient(a)


@torchsymbol(name="contiguous", method_names=("contiguous",))
def contiguous(a):
    return a


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------


@torchsymbol(name="full")
def full(shape, fill_value, *, device=None, dtype=None):
    return clang.full(shape, pyval(fill_value), device=device, dtype=dtype)


@torchsymbol(name="zeros")
def zeros(*shape, device=None, dtype=None):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    return clang.full(shape, 0.0 if dtype is None else 0, device=device, dtype=dtype or dtypes.float32)


@torchsymbol(name="ones")
def ones(*shape, device=None, dtype=None):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    return clang.full(shape, 1.0 if dtype is None else 1, device=device, dtype=dtype or dtypes.float32)


@torchsymbol(name="zeros_like")
def zeros_like(a, *, device=None, dtype=None):
    return clang.full_like(a, 0, device=device, dtype=dtype)


@torchsymbol(name="ones_like")
def ones_like(a, *, device=None, dtype=None):
    return clang.full_like(a, 1, device=device, dtype=dtype)


@torchsymbol(name="full_like")
def full_like(a, fill_value, *, device=None, dtype=None):
    return clang.full_like(a, pyval(fill_value), device=device, dtype=dtype)


@torchsymbol(name="arange")
def arange(start, end=None, step=1, *, device=None, dtype=None):
    return clang.arange(start, end, step, device=device, dtype=dtype)


@torchsymbol(name="linspace")
def linspace(start, end, steps, *, device=None, dtype=None):
    dtype = dtypes.to_dtype(dtype) if dtype else dtypes.float32
    i = prims.iota(steps, dtype=dtypes.float32, device=device)
    step = (pyval(end) - pyval(start)) / builtins.max(1, pyval(steps) - 1)
    return clang.maybe_convert_to_dtype(clang.add(clang.mul(i, step), pyval(start)), dtype)


@torchsymbol(name="one_hot")
def one_hot(a, num_classes):
    n = pyval(num_classes)
    if n == -1:
        raise RuntimeError(
            "one_hot: num_classes=-1 (infer from data) needs a data-dependent "
            "output shape XLA cannot express; pass the class count explicitly")
    if n < 1:
        raise RuntimeError(f"one_hot: num_classes must be positive, got {n}")
    c = prims.iota(num_classes, dtype=dtypes.int64 if a.dtype.is_int else a.dtype, device=a.device)
    expanded = clang.unsqueeze(a, -1)
    return clang.maybe_convert_to_dtype(clang.eq(expanded, clang.expand_to(c, expanded.shape[:-1] + (num_classes,))), dtypes.int64)


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------


@torchsymbol(name="reshape", method_names=("reshape", "view"))
def reshape(a, *shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    check(builtins.sum(1 for d in shape if pyval(d) == -1) <= 1,
          lambda: f"reshape can infer (-1) at most one dimension, got {shape}")
    return clang.reshape(a, shape)


@torchsymbol(name="permute", method_names=("permute",))
def permute(a, *dims):
    if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
        dims = tuple(dims[0])
    return clang.permute(a, dims)


@torchsymbol(name="transpose", method_names=("transpose", "swapaxes"))
def transpose(a, dim0, dim1):
    return clang.transpose(a, pyval(dim0), pyval(dim1))


@torchsymbol(name="matrix_transpose", method_names=("matrix_transpose",))
def matrix_transpose(a):
    return clang.matrix_transpose(a)


@torchsymbol(name="t", method_names=("t",))
def t(a):
    check(a.ndim <= 2, lambda: ".t() on >2D tensor")
    return clang.matrix_transpose(a) if a.ndim == 2 else a


@torchsymbol(name="unsqueeze", method_names=("unsqueeze",))
def unsqueeze(a, dim):
    return clang.unsqueeze(a, pyval(dim))


@torchsymbol(name="squeeze", method_names=("squeeze",))
def squeeze(a, dim=None):
    return clang.squeeze(a, dim)


@torchsymbol(name="flatten", method_names=("flatten",))
def flatten(a, start_dim=0, end_dim=-1):
    sd = canonicalize_dim(a.ndim, pyval(start_dim))
    ed = canonicalize_dim(a.ndim, pyval(end_dim))
    check(sd <= ed, lambda: f"flatten: start_dim {sd} must be <= end_dim {ed}")
    return clang.flatten(a, sd, ed)


@torchsymbol(name="expand", method_names=("expand",))
def expand(a, *shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    return clang.expand(a, shape)


@torchsymbol(name="cat")
def cat(tensors, dim=0):
    tensors = list(tensors)
    check(len(tensors) > 0, lambda: "cat expects at least one tensor")
    canonicalize_dim(tensors[0].ndim, pyval(dim))  # dim-range check
    return clang.cat(tensors, dim)


@torchsymbol(name="stack")
def stack(tensors, dim=0):
    tensors = list(tensors)
    check(len(tensors) > 0, lambda: "stack expects at least one tensor")
    first = tuple(tensors[0].shape)
    for t in tensors[1:]:
        check(tuple(t.shape) == first,
              lambda: f"stack expects tensors of the same shape, got {first} and {tuple(t.shape)}")
    return clang.stack(tensors, dim)


@torchsymbol(name="split", method_names=("split",))
def split(a, split_size_or_sections, dim=0):
    d = canonicalize_dim(a.ndim, pyval(dim))
    if isinstance(split_size_or_sections, (list, tuple)):
        total = builtins.sum(pyval(x) for x in split_size_or_sections)
        check(total == a.shape[d],
              lambda: f"split sizes {split_size_or_sections} must sum to dim {d} size {a.shape[d]}, got {total}")
    return clang.split(a, split_size_or_sections, d)


@torchsymbol(name="chunk", method_names=("chunk",))
def chunk(a, chunks, dim=0):
    check(pyval(chunks) > 0, lambda: f"chunk expects a positive number of chunks, got {chunks}")
    return clang.chunk(a, pyval(chunks), pyval(dim))


@torchsymbol(name="flip", method_names=("flip",))
def flip(a, dims):
    return clang.flip(a, dims)


@torchsymbol(name="movedim", method_names=("movedim",))
def movedim(a, source, destination):
    return clang.movedim(a, source, destination)


@torchsymbol(name="repeat", method_names=("repeat",))
def repeat(a, *sizes):
    if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
        sizes = tuple(sizes[0])
    out = a
    # prepend dims
    while out.ndim < len(sizes):
        out = clang.unsqueeze(out, 0)
    tiles = []
    for i, s in enumerate(sizes):
        if s > 1:
            out = clang.cat([out] * s, i)
    return out


@torchsymbol(name="getitem", method_names=("getitem",))
def getitem(a, key):
    return clang.getitem(a, key)


@torchsymbol(name="index_select", method_names=("index_select",))
def index_select(a, dim, index):
    # lowers to the TAKE prim (hand-written grad rule) — a dedicated
    # INDEX_SELECT prim would duplicate it
    check(getattr(index, "ndim", 1) == 1,
          lambda: f"index_select expects a 1-D index vector, got {index.ndim}-D")
    return clang.take(a, index, canonicalize_dim(a.ndim, pyval(dim)))


@torchsymbol(name="gather", method_names=("gather",))
def gather(a, dim, index):
    return clang.take_along_axis(a, index, pyval(dim))


@torchsymbol(name="take_along_dim", method_names=("take_along_dim",))
def take_along_dim(a, indices, dim):
    check(indices.ndim == a.ndim,
          lambda: f"take_along_dim: indices rank {indices.ndim} must match input rank {a.ndim}")
    return clang.take_along_axis(a, indices, pyval(dim))


@torchsymbol(name="index_add", method_names=("index_add",))
def index_add(a, dim, index, source):
    return clang.index_add(a, index, source, pyval(dim))


@torchsymbol(name="scatter_add", method_names=("scatter_add",))
def scatter_add(a, dim, index, src):
    return clang.scatter_add(a, index, src, pyval(dim))


@torchsymbol(name="pad", id="torch.nn.functional.pad")
def pad(a, pad_widths, mode="constant", value=0.0):
    """torch.nn.functional.pad with the (last-dim-first) flat pad list."""
    check(mode == "constant", lambda: f"pad mode {mode} unsupported")
    check(len(pad_widths) % 2 == 0,
          lambda: f"pad expects an even number of pad values (left/right pairs), got {len(pad_widths)}")
    check(len(pad_widths) // 2 <= a.ndim,
          lambda: f"pad: {len(pad_widths)//2} padded dims exceed input rank {a.ndim}")
    cfg = [(0, 0, 0)] * a.ndim
    pairs = [(pyval(pad_widths[i]), pyval(pad_widths[i + 1])) for i in range(0, len(pad_widths), 2)]
    for i, (lo, hi) in enumerate(pairs):
        cfg[a.ndim - 1 - i] = (lo, hi, 0)
    return clang.pad(a, value, cfg)


@torchsymbol(name="roll", method_names=("roll",))
def roll(a, shifts, dims=None):
    if dims is not None and isinstance(shifts, (tuple, list)):
        dlist = (dims,) if isinstance(dims, int) else dims
        check(len(shifts) == len(dlist),
              lambda: f"roll: shifts {shifts} and dims {dlist} must have the same length")
    if dims is None:
        flat = clang.reshape(a, (a.numel,))
        out = roll_1d(flat, pyval(shifts))
        return clang.reshape(out, a.shape)
    shifts = (shifts,) if isinstance(shifts, int) else shifts
    dims = (dims,) if isinstance(dims, int) else dims
    out = a
    for s, d in zip(shifts, dims):
        d = canonicalize_dim(out.ndim, d)
        n = out.shape[d]
        s = pyval(s) % builtins.max(1, n)
        if s == 0:
            continue
        left = clang.slice_in_dim(out, n - s, n, d)
        right = clang.slice_in_dim(out, 0, n - s, d)
        out = clang.cat([left, right], d)
    return out


def roll_1d(a, shift):
    n = a.shape[0]
    shift = shift % builtins.max(1, n)
    if shift == 0:
        return a
    return clang.cat([clang.slice_in_dim(a, n - shift, n, 0), clang.slice_in_dim(a, 0, n - shift, 0)], 0)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


@torchsymbol(name="sum", method_names=("sum",))
def sum(a, dim=None, keepdim=False, *, dtype=None):
    return clang.sum_(a, dim, keepdim, dtype=dtype)


@torchsymbol(name="mean", method_names=("mean",))
def mean(a, dim=None, keepdim=False, *, dtype=None):
    return clang.mean(a, dim, keepdim, dtype=dtype)


@torchsymbol(name="var", method_names=("var",))
def var(a, dim=None, keepdim=False, *, correction=1):
    return clang.var(a, dim, keepdim, correction=correction)


@torchsymbol(name="std", method_names=("std",))
def std(a, dim=None, keepdim=False, *, correction=1):
    return prims.sqrt(clang.var(a, dim, keepdim, correction=correction))


@torchsymbol(name="var_mean")
def var_mean(a, dim=None, keepdim=False, *, correction=1):
    return clang.var_mean(a, dim, keepdim, correction=correction)


@torchsymbol(name="amax", method_names=("amax",))
def amax(a, dim=None, keepdim=False):
    return clang.amax(a, dim, keepdim)


@torchsymbol(name="amin", method_names=("amin",))
def amin(a, dim=None, keepdim=False):
    return clang.amin(a, dim, keepdim)


@torchsymbol(name="max", method_names=("max",))
def max(a, dim=None, keepdim=False):
    if dim is None:
        return clang.amax(a, None, False)
    values = clang.amax(a, dim, keepdim)
    indices = clang.argmax(a, dim, keepdim)
    return values, indices


@torchsymbol(name="min", method_names=("min",))
def min(a, dim=None, keepdim=False):
    if dim is None:
        return clang.amin(a, None, False)
    values = clang.amin(a, dim, keepdim)
    indices = clang.argmin(a, dim, keepdim)
    return values, indices


@torchsymbol(name="argmax", method_names=("argmax",))
def argmax(a, dim=None, keepdim=False):
    return clang.argmax(a, dim, keepdim)


@torchsymbol(name="argmin", method_names=("argmin",))
def argmin(a, dim=None, keepdim=False):
    return clang.argmin(a, dim, keepdim)


@torchsymbol(name="prod", method_names=("prod",))
def prod(a, dim=None, keepdim=False):
    return clang.prod(a, dim, keepdim)


@torchsymbol(name="any", method_names=("any",))
def any(a, dim=None, keepdim=False):
    return clang.any_(a, dim, keepdim)


@torchsymbol(name="all", method_names=("all",))
def all(a, dim=None, keepdim=False):
    return clang.all_(a, dim, keepdim)


@torchsymbol(name="cumsum", method_names=("cumsum",))
def cumsum(a, dim):
    return clang.cumsum(a, pyval(dim))


@torchsymbol(name="topk", method_names=("topk",))
def topk(a, k, dim=-1):
    return prims.topk(a, pyval(k), pyval(dim))


@torchsymbol(name="argsort", method_names=("argsort",))
def argsort(a, dim=-1, descending=False):
    return prims.argsort(a, canonicalize_dim(a.ndim, pyval(dim)), descending)


@torchsymbol(name="sort", method_names=("sort",))
def sort(a, dim=-1, descending=False):
    d = canonicalize_dim(a.ndim, pyval(dim))
    return prims.sort(a, d, descending), prims.argsort(a, d, descending)


@torchsymbol(name="softmax", method_names=("softmax",), id="torch.softmax")
def softmax(a, dim=-1, *, dtype=None):
    if dtype is not None:
        a = clang.maybe_convert_to_dtype(a, dtypes.to_dtype(dtype))
    elif not a.dtype.is_inexact:
        a = clang.maybe_convert_to_dtype(a, dtypes.float32)
    m = clang.amax(a, dim, keepdim=True)
    e = prims.exp(clang.sub(a, m))
    return clang.true_divide(e, clang.sum_(e, dim, keepdim=True))


@torchsymbol(name="log_softmax", method_names=("log_softmax",), id="torch.log_softmax")
def log_softmax(a, dim=-1, *, dtype=None):
    if dtype is not None:
        a = clang.maybe_convert_to_dtype(a, dtypes.to_dtype(dtype))
    elif not a.dtype.is_inexact:
        a = clang.maybe_convert_to_dtype(a, dtypes.float32)
    m = clang.amax(a, dim, keepdim=True)
    shifted = clang.sub(a, m)
    lse = prims.log(clang.sum_(prims.exp(shifted), dim, keepdim=True))
    return clang.sub(shifted, lse)


# ---------------------------------------------------------------------------
# linear algebra & NN ops
# ---------------------------------------------------------------------------


@torchsymbol(name="matmul", method_names=("matmul", "mm", "bmm"))
def matmul(a, b):
    return prims.matmul(a, b)


@torchsymbol(name="einsum_bmm", id="torch.einsum_bmm")
def einsum_bmm(a, b):
    return prims.matmul(a, b)


@torchsymbol(name="grouped_mm", id="torch.grouped_mm")
def grouped_mm(a, b, group_sizes):
    return prims.grouped_mm(a, b, group_sizes)


# einsum (thunder_tpu/ops/ltorch.py's decomposition): pairwise contractions
# as transpose/reshape/matmul/sum prims, whose grad rules exist; the EINSUM
# prim only for a spec with an index repeated inside one operand (a diagonal)

from ..core.einsum_utils import expand_ellipsis as _einsum_expand_ellipsis_impl  # noqa: E402


def _einsum_expand_ellipsis(spec: str, operands):
    return _einsum_expand_ellipsis_impl(spec, [op.ndim for op in operands])


def _einsum_pair(s1, x, s2, y, keep):
    """Contract two einsum operands into one matmul. Size-1 dims broadcast
    against the other operand (ellipsis broadcasting): each shared index
    takes the larger size and size-1 dims are expanded."""
    sizes = {}
    for ch, d in zip(s1, x.shape):
        sizes[ch] = d
    for ch, d in zip(s2, y.shape):
        sizes[ch] = builtins.max(sizes.get(ch, 1), d)
    set1, set2 = set(s1), set(s2)
    if builtins.any(x.shape[i] != sizes[ch] for i, ch in enumerate(s1)):
        x = clang.expand(x, tuple(sizes[ch] for ch in s1))
    if builtins.any(y.shape[i] != sizes[ch] for i, ch in enumerate(s2)):
        y = clang.expand(y, tuple(sizes[ch] for ch in s2))
    # pre-sum indices that appear in only one operand and are not needed later
    drop1 = [ch for ch in s1 if ch not in set2 and ch not in keep]
    if drop1:
        x = clang.sum_(x, tuple(s1.index(ch) for ch in drop1), False)
        s1 = "".join(ch for ch in s1 if ch not in drop1)
        set1 = set(s1)
    drop2 = [ch for ch in s2 if ch not in set1 and ch not in keep]
    if drop2:
        y = clang.sum_(y, tuple(s2.index(ch) for ch in drop2), False)
        s2 = "".join(ch for ch in s2 if ch not in drop2)
        set2 = set(s2)
    batch = [ch for ch in s1 if ch in set2 and ch in keep]
    contract = [ch for ch in s1 if ch in set2 and ch not in keep]
    mdims = [ch for ch in s1 if ch not in set2]
    ndims = [ch for ch in s2 if ch not in set1]
    # permute to (batch, m, contract) and (batch, contract, n)
    perm1 = [s1.index(ch) for ch in batch + mdims + contract]
    perm2 = [s2.index(ch) for ch in batch + contract + ndims]
    if perm1 != list(builtins.range(len(s1))):
        x = clang.permute(x, perm1)
    if perm2 != list(builtins.range(len(s2))):
        y = clang.permute(y, perm2)

    def size(chs):
        return math.prod(sizes[ch] for ch in chs)

    x2 = clang.reshape(x, (size(batch), size(mdims), size(contract)))
    y2 = clang.reshape(y, (size(batch), size(contract), size(ndims)))
    out = prims.matmul(x2, y2)
    out_spec = "".join(batch + mdims + ndims)
    return out_spec, clang.reshape(out, tuple(sizes[ch] for ch in out_spec))


@torchsymbol(name="einsum")
def einsum(equation, *operands):
    """General einsum, decomposed to transpose/reshape/matmul/sum prims
    (their grad rules and the matmul claims apply); the EINSUM prim for a
    spec with a repeated index inside one operand."""
    if len(operands) == 1 and isinstance(operands[0], (tuple, list)):
        operands = tuple(operands[0])
    equation = pyval(equation)
    in_specs, out_spec = _einsum_expand_ellipsis(equation, operands)
    for sub in in_specs:
        if len(set(sub)) != len(sub):
            return prims.einsum(equation, *operands)
    if len(operands) == 1:
        s, x = in_specs[0], operands[0]
        drop = [ch for ch in s if ch not in out_spec]
        if drop:
            x = clang.sum_(x, tuple(s.index(ch) for ch in drop), False)
            s = "".join(ch for ch in s if ch in out_spec)
        perm = [s.index(ch) for ch in out_spec]
        return clang.permute(x, perm) if perm != list(builtins.range(len(s))) else x
    spec, acc = in_specs[0], operands[0]
    for i in builtins.range(1, len(operands)):
        keep = set(out_spec)
        for j in builtins.range(i + 1, len(operands)):
            keep |= set(in_specs[j])
        spec, acc = _einsum_pair(spec, acc, in_specs[i], operands[i], keep)
    drop = [ch for ch in spec if ch not in out_spec]
    if drop:
        acc = clang.sum_(acc, tuple(spec.index(ch) for ch in drop), False)
        spec = "".join(ch for ch in spec if ch in out_spec)
    perm = [spec.index(ch) for ch in out_spec]
    return clang.permute(acc, perm) if perm != list(builtins.range(len(spec))) else acc


@torchsymbol(name="linear", id="torch.nn.functional.linear")
def linear(a, w, bias=None):
    out = prims.linear(a, w, bias)
    if bias is not None:
        out = clang.add(out, bias)
    return out


@torchsymbol(name="embedding", id="torch.nn.functional.embedding")
def embedding(indices, weight):
    return prims.embedding(indices, weight)


@torchsymbol(name="conv2d", id="torch.nn.functional.conv2d")
def conv2d(a, weight, bias=None, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1):
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    padding = (padding, padding) if isinstance(padding, int) else tuple(padding)
    dilation = (dilation, dilation) if isinstance(dilation, int) else tuple(dilation)
    out = prims.convolution(a, weight, None, stride, padding, dilation, groups)
    if bias is not None:
        out = clang.add(out, clang.reshape(bias, (1, bias.shape[0], 1, 1)))
    return out


@torchsymbol(name="conv1d", id="torch.nn.functional.conv1d")
def conv1d(a, weight, bias=None, stride=(1,), padding=(0,), dilation=(1,), groups=1):
    stride = (stride,) if isinstance(stride, int) else tuple(stride)
    padding = (padding,) if isinstance(padding, int) else tuple(padding)
    dilation = (dilation,) if isinstance(dilation, int) else tuple(dilation)
    out = prims.convolution(a, weight, None, stride, padding, dilation, groups)
    if bias is not None:
        out = clang.add(out, clang.reshape(bias, (1, bias.shape[0], 1)))
    return out


@torchsymbol(name="conv3d", id="torch.nn.functional.conv3d")
def conv3d(a, weight, bias=None, stride=(1, 1, 1), padding=(0, 0, 0), dilation=(1, 1, 1), groups=1):
    stride = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    padding = (padding,) * 3 if isinstance(padding, int) else tuple(padding)
    dilation = (dilation,) * 3 if isinstance(dilation, int) else tuple(dilation)
    out = prims.convolution(a, weight, None, stride, padding, dilation, groups)
    if bias is not None:
        out = clang.add(out, clang.reshape(bias, (1, bias.shape[0], 1, 1, 1)))
    return out


def _conv_transpose_nd(a, weight, bias, stride, padding, output_padding, dilation, groups, n):
    stride = (stride,) * n if isinstance(stride, int) else tuple(stride)
    padding = (padding,) * n if isinstance(padding, int) else tuple(padding)
    output_padding = (output_padding,) * n if isinstance(output_padding, int) else tuple(output_padding)
    dilation = (dilation,) * n if isinstance(dilation, int) else tuple(dilation)
    out = prims.conv_transpose(a, weight, None, stride, padding, output_padding, dilation, groups)
    if bias is not None:
        out = clang.add(out, clang.reshape(bias, (1, bias.shape[0]) + (1,) * n))
    return out


@torchsymbol(name="conv_transpose1d", id="torch.nn.functional.conv_transpose1d")
def conv_transpose1d(a, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1, dilation=1):
    return _conv_transpose_nd(a, weight, bias, stride, padding, output_padding, dilation, groups, 1)


@torchsymbol(name="conv_transpose2d", id="torch.nn.functional.conv_transpose2d")
def conv_transpose2d(a, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1, dilation=1):
    return _conv_transpose_nd(a, weight, bias, stride, padding, output_padding, dilation, groups, 2)


@torchsymbol(name="conv_transpose3d", id="torch.nn.functional.conv_transpose3d")
def conv_transpose3d(a, weight, bias=None, stride=1, padding=0, output_padding=0, groups=1, dilation=1):
    return _conv_transpose_nd(a, weight, bias, stride, padding, output_padding, dilation, groups, 3)


# pooling: the reduce_window prim (thunder_tpu/ops/ltorch.py:2203-2282) ------


def _pool_args(kernel_size, stride, padding, n):
    ks = (kernel_size,) * n if isinstance(kernel_size, int) else tuple(pyval(k) for k in kernel_size)
    if stride is None:
        st = ks
    else:
        st = (stride,) * n if isinstance(stride, int) else tuple(pyval(s) for s in stride)
    pd = (padding,) * n if isinstance(padding, int) else tuple(pyval(p) for p in padding)
    return ks, st, pd


def _max_pool(a, kernel_size, stride, padding, n):
    ks, st, pd = _pool_args(kernel_size, stride, padding, n)
    return prims.reduce_window(a, (1, 1) + ks, (1, 1) + st, ((0, 0), (0, 0)) + tuple((p, p) for p in pd),
                               op="max")


@torchsymbol(name="max_pool1d", id="torch.nn.functional.max_pool1d")
def max_pool1d(a, kernel_size, stride=None, padding=0):
    return _max_pool(a, kernel_size, stride, padding, 1)


@torchsymbol(name="max_pool2d", id="torch.nn.functional.max_pool2d")
def max_pool2d(a, kernel_size, stride=None, padding=0):
    return _max_pool(a, kernel_size, stride, padding, 2)


@torchsymbol(name="max_pool3d", id="torch.nn.functional.max_pool3d")
def max_pool3d(a, kernel_size, stride=None, padding=0):
    return _max_pool(a, kernel_size, stride, padding, 3)


def _avg_pool(a, kernel_size, stride, padding, n, count_include_pad):
    ks, st, pd = _pool_args(kernel_size, stride, padding, n)
    check(builtins.all(k > 0 for k in ks), lambda: f"pooling kernel sizes must be positive, got {ks}")
    window, strides = (1, 1) + ks, (1, 1) + st
    pads = ((0, 0), (0, 0)) + tuple((p, p) for p in pd)
    s = prims.reduce_window(a, window, strides, pads, op="sum")
    if count_include_pad or builtins.all(p == 0 for p in pd):
        return clang.true_divide(s, float(math.prod(ks)))
    counts = prims.reduce_window(clang.full_like(a, 1.0), window, strides, pads, op="sum")
    return clang.true_divide(s, counts)


@torchsymbol(name="avg_pool1d", id="torch.nn.functional.avg_pool1d")
def avg_pool1d(a, kernel_size, stride=None, padding=0, count_include_pad=True):
    return _avg_pool(a, kernel_size, stride, padding, 1, count_include_pad)


@torchsymbol(name="avg_pool2d", id="torch.nn.functional.avg_pool2d")
def avg_pool2d(a, kernel_size, stride=None, padding=0, count_include_pad=True):
    return _avg_pool(a, kernel_size, stride, padding, 2, count_include_pad)


@torchsymbol(name="avg_pool3d", id="torch.nn.functional.avg_pool3d")
def avg_pool3d(a, kernel_size, stride=None, padding=0, count_include_pad=True):
    return _avg_pool(a, kernel_size, stride, padding, 3, count_include_pad)


def _adaptive_window(a, output_size, name):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = (pyval(o) for o in output_size)
    H, W = a.shape[-2], a.shape[-1]
    check(H % oh == 0 and W % ow == 0, lambda: f"{name}: {H}x{W} not divisible by {oh}x{ow}")
    return H // oh, W // ow


@torchsymbol(name="adaptive_avg_pool2d", id="torch.nn.functional.adaptive_avg_pool2d")
def adaptive_avg_pool2d(a, output_size):
    k = _adaptive_window(a, output_size, "adaptive_avg_pool2d")
    return _avg_pool(a, k, k, 0, 2, True)


@torchsymbol(name="adaptive_max_pool2d", id="torch.nn.functional.adaptive_max_pool2d")
def adaptive_max_pool2d(a, output_size):
    k = _adaptive_window(a, output_size, "adaptive_max_pool2d")
    return _max_pool(a, k, k, 0, 2)


@torchsymbol(name="adaptive_avg_pool2d_backward", id="torch.ops.aten._adaptive_avg_pool2d_backward")
def adaptive_avg_pool2d_backward(g, a):
    """aten::_adaptive_avg_pool2d_backward for the divisible windows the
    forward takes: each output's gradient spreads evenly over its kh x kw
    window."""
    H, W = a.shape[-2], a.shape[-1]
    oh, ow = g.shape[-2], g.shape[-1]
    check(H % oh == 0 and W % ow == 0,
          lambda: f"adaptive_avg_pool2d_backward: {H}x{W} not divisible by {oh}x{ow}")
    kh, kw = H // oh, W // ow
    lead = tuple(g.shape[:-2])
    nd = len(lead)
    scaled = clang.reshape(clang.true_divide(g, float(kh * kw)), lead + (oh, 1, ow, 1))
    bcast = prims.broadcast_in_dim(scaled, lead + (oh, kh, ow, kw),
                                   tuple(range(nd)) + (nd, nd + 1, nd + 2, nd + 3))
    return clang.reshape(bcast, lead + (H, W))


# batch, group and instance norms: f32 compute, cast back -------------------


def _channel_view(t, ndim):
    return clang.reshape(t, (1, t.shape[0]) + (1,) * (ndim - 2))


def _affine(out, weight, bias, ndim):
    if weight is not None:
        out = clang.mul(out, _channel_view(weight, ndim))
    if bias is not None:
        out = clang.add(out, _channel_view(bias, ndim))
    return out


def _normalize_affine(centered, v, eps, dtype, weight, bias, ndim):
    out = clang.maybe_convert_to_dtype(clang.mul(centered, prims.rsqrt(clang.add(v, eps))), dtype)
    return _affine(out, weight, bias, ndim)


def _f32(a):
    return a if a.dtype == dtypes.float32 else clang.maybe_convert_to_dtype(a, dtypes.float32)


@torchsymbol(name="batch_norm", id="torch.nn.functional.batch_norm")
def batch_norm(a, running_mean=None, running_var=None, weight=None, bias=None, training=False,
               momentum=0.1, eps=1e-5):
    """Batch statistics in training mode (or without running stats), the
    running stats otherwise. The running-stat update is the caller's:
    models/resnet.py's BatchNorm2d writes it through nn.update_buffer."""
    compute = _f32(a)
    if training or running_mean is None:
        dims = (0,) + tuple(builtins.range(2, a.ndim))
        m = clang.mean(compute, dims, keepdim=True)
        centered = clang.sub(compute, m)
        v = clang.mean(clang.mul(centered, centered), dims, keepdim=True)
    else:
        centered = clang.sub(compute, _channel_view(running_mean, a.ndim))
        v = _channel_view(running_var, a.ndim)
    return _normalize_affine(centered, v, eps, a.dtype, weight, bias, a.ndim)


@torchsymbol(name="group_norm", id="torch.nn.functional.group_norm")
def group_norm(a, num_groups, weight=None, bias=None, eps=1e-5):
    N, C = a.shape[0], a.shape[1]
    G = pyval(num_groups)
    check(C % G == 0, lambda: f"group_norm: {C} channels not divisible by {G} groups")
    grouped = clang.reshape(_f32(a), (N, G, C // G) + tuple(a.shape[2:]))
    dims = tuple(builtins.range(2, grouped.ndim))
    m = clang.mean(grouped, dims, keepdim=True)
    centered = clang.sub(grouped, m)
    v = clang.mean(clang.mul(centered, centered), dims, keepdim=True)
    out = clang.reshape(clang.mul(centered, prims.rsqrt(clang.add(v, eps))), a.shape)
    return _affine(clang.maybe_convert_to_dtype(out, a.dtype), weight, bias, a.ndim)


@torchsymbol(name="instance_norm", id="torch.nn.functional.instance_norm")
def instance_norm(a, running_mean=None, running_var=None, weight=None, bias=None, use_input_stats=True,
                  momentum=0.1, eps=1e-5):
    dims = tuple(builtins.range(2, a.ndim))
    compute = _f32(a)
    m = clang.mean(compute, dims, keepdim=True)
    centered = clang.sub(compute, m)
    v = clang.mean(clang.mul(centered, centered), dims, keepdim=True)
    return _normalize_affine(centered, v, eps, a.dtype, weight, bias, a.ndim)


@torchsymbol(name="layer_norm", id="torch.nn.functional.layer_norm")
def layer_norm(a, normalized_shape, weight=None, bias=None, eps=1e-5):
    ndims = len(normalized_shape)
    check(ndims <= a.ndim and tuple(int(d) for d in normalized_shape) == tuple(a.shape[a.ndim - ndims:]),
          lambda: f"layer_norm: normalized_shape {tuple(normalized_shape)} must match the trailing dims of {tuple(a.shape)}")
    dims = tuple(range(a.ndim - ndims, a.ndim))
    compute = a if a.dtype == dtypes.float32 else clang.maybe_convert_to_dtype(a, dtypes.float32)
    m = clang.mean(compute, dims, keepdim=True)
    centered = clang.sub(compute, m)
    v = clang.mean(clang.mul(centered, centered), dims, keepdim=True)
    out = clang.mul(centered, prims.rsqrt(clang.add(v, eps)))
    out = clang.maybe_convert_to_dtype(out, a.dtype)
    if weight is not None:
        out = clang.mul(out, weight)
    if bias is not None:
        out = clang.add(out, bias)
    return out


@torchsymbol(name="rms_norm", id="torch.nn.functional.rms_norm")
def rms_norm(a, normalized_shape, weight=None, eps=1e-6):
    ndims = len(normalized_shape)
    dims = tuple(range(a.ndim - ndims, a.ndim))
    compute = a if a.dtype == dtypes.float32 else clang.maybe_convert_to_dtype(a, dtypes.float32)
    ms = clang.mean(clang.mul(compute, compute), dims, keepdim=True)
    out = clang.mul(compute, prims.rsqrt(clang.add(ms, eps)))
    out = clang.maybe_convert_to_dtype(out, a.dtype)
    if weight is not None:
        out = clang.mul(out, weight)
    return out


@torchsymbol(name="rope_sdpa", id="thunder.rope_sdpa")
def rope_sdpa(q, k, v, cos, sin, is_causal=True, scale=None):
    """Fused half-split RoPE + scaled-dot-product attention.

    q/k arrive PRE-rope; cos/sin are (T, head_dim) duplicated-half caches.
    The cuda executor claims this whole with the flash-RoPE kernels, and
    registers its grad rule (executors/cudaex.py); a shape its checker
    declines runs the decomposition below."""
    hs = q.shape[-1]
    h = hs // 2

    def rope(x):
        x1 = x[..., :h]
        x2 = x[..., h:]
        c = cos[..., :h]
        s_ = sin[..., :h]
        out = cat([x1 * c - x2 * s_, x2 * c + x1 * s_], -1)
        # rope math runs f32 (f32 cos/sin promote), but the attention matmuls
        # must keep the input compute dtype (autocast bf16 would otherwise be
        # silently undone on the unclaimed path)
        return clang.maybe_convert_to_dtype(out, x.dtype)

    return sdpa.meta(rope(q), rope(k), v, is_causal=is_causal, scale=scale,
                     enable_gqa=q.shape[1] != k.shape[1])


@torchsymbol(name="sdpa", id="torch.nn.functional.scaled_dot_product_attention")
def sdpa(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None, enable_gqa=False):
    """Scaled dot-product attention (composite). The cuda executor claims it
    whole with the flash-attention kernels and registers its grad rule
    (executors/cudaex.py); a shape its checker declines runs this
    decomposition."""
    check(q.shape[-1] == k.shape[-1],
          lambda: f"sdpa: q head dim {q.shape[-1]} must match k head dim {k.shape[-1]}")
    check(k.shape[-2] == v.shape[-2],
          lambda: f"sdpa: k length {k.shape[-2]} must match v length {v.shape[-2]}")
    if q.ndim == 4 and k.ndim == 4 and q.shape[1] != k.shape[1]:
        check(k.shape[1] == v.shape[1],
              lambda: f"k has {k.shape[1]} heads but v has {v.shape[1]}")
        if k.shape[1] != 1:
            # GQA: replicate k/v head groups to match q (torch enable_gqa=True).
            # Size-1 kv heads need no flag or replication — matmul broadcasting
            # covers them, matching torch's math-path semantics.
            check(enable_gqa, lambda: f"q has {q.shape[1]} heads but k/v have "
                  f"{k.shape[1]}; pass enable_gqa=True for grouped-query attention")
            check(q.shape[1] % k.shape[1] == 0,
                  lambda: f"GQA requires q heads {q.shape[1]} divisible by kv heads {k.shape[1]}")
            k = repeat_interleave(k, q.shape[1] // k.shape[1], 1)
            v = repeat_interleave(v, q.shape[1] // v.shape[1], 1)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kt = clang.matrix_transpose(k)
    scores = clang.mul(prims.matmul(q, kt), scale)
    if is_causal:
        Lq, Lk = q.shape[-2], k.shape[-2]
        r = clang.unsqueeze(prims.iota(Lq, dtype=dtypes.int32, device=q.device), 1)
        c = clang.unsqueeze(prims.iota(Lk, dtype=dtypes.int32, device=q.device), 0)
        # torch documents a top-left-aligned causal mask (tril diagonal=0)
        # even when Lq != Lk
        causal = clang.ge(r, c)
        scores = clang.where(causal, scores, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype.is_bool:
            scores = clang.where(attn_mask, scores, float("-inf"))
        else:
            scores = clang.add(scores, attn_mask)
    probs = softmax(scores, -1)
    probs = clang.maybe_convert_to_dtype(probs, v.dtype)
    return prims.matmul(probs, v)


@torchsymbol(name="paged_attention", id="thunder.paged_attention")
def paged_attention(q, k_pages, v_pages, page_table, seq_lens, scale=None):
    """Decode-step attention of ONE new token per sequence against a
    block-paged KV pool (vLLM/PagedAttention, SOSP '23).

    q            (B, H, D)           — the current token's query heads
    k_pages/v_pages (P, page_size, Hkv, D) — the shared per-layer page pool
    page_table   (B, n_pages_max) int — per-sequence page ids; entries beyond
                 the sequence's pages point at the reserved null page 0
    seq_lens     (B,) int            — valid tokens per sequence INCLUDING
                 the current one (whose k/v is already written to its page)

    The decomposition below is the gather reference path (shapes the
    kernel's checker declines); the cuda executor claims the symbol whole
    with a hand-written paged decode kernel
    (executors/cudaex.py:paged_attention)."""
    B, H, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    npm = page_table.shape[1]
    T = npm * ps
    check(H % Hkv == 0,
          lambda: f"paged_attention: q heads {H} not divisible by kv heads {Hkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    flat = reshape(page_table, (B * npm,))
    k = clang.take(k_pages, flat, 0)  # (B*npm, ps, Hkv, D)
    v = clang.take(v_pages, flat, 0)
    k = permute(reshape(k, (B, T, Hkv, D)), (0, 2, 1, 3))  # (B, Hkv, T, D)
    v = permute(reshape(v, (B, T, Hkv, D)), (0, 2, 1, 3))
    if H != Hkv:
        k = repeat_interleave(k, H // Hkv, 1)
        v = repeat_interleave(v, H // Hkv, 1)
    qe = reshape(q, (B, H, 1, D))
    scores = clang.mul(prims.matmul(qe, clang.matrix_transpose(k)), scale)  # (B, H, 1, T)
    k_pos = reshape(prims.iota(T, dtype=dtypes.int32, device=q.device), (1, 1, 1, T))
    live = clang.lt(k_pos, reshape(seq_lens, (B, 1, 1, 1)))
    scores = clang.where(live, scores, float("-inf"))
    probs = softmax(scores, -1)
    probs = clang.maybe_convert_to_dtype(probs, v.dtype)
    return reshape(prims.matmul(probs, v), (B, H, D))


@torchsymbol(name="paged_chunk_attention", id="thunder.paged_chunk_attention")
def paged_chunk_attention(q, k_pages, v_pages, page_table, q_pos, scale=None):
    """Multi-query paged attention: T new tokens per sequence attend the
    block-paged pool with PER-QUERY causal coverage (k_pos <= q_pos[b, t]).

    q            (B, H, T, D)        — T new tokens' query heads per sequence
    k_pages/v_pages (P, page_size, Hkv, D) — the shared per-layer page pool
    page_table   (B, n_pages_max) int — per-sequence page ids; entries beyond
                 the sequence's pages point at the reserved null page 0
    q_pos        (B, T) int          — each query's ABSOLUTE position; it
                 attends keys at positions <= its own (whose k/v, including
                 its own token's, are already written to their pages)

    One symbol serves both new paged multi-token programs (serving/runner.py):
    the CHUNKED-PREFILL chunk (B=1, T=chunk tokens, positions start..start+T)
    and the SPECULATIVE-DECODING verify step (T=k+1 proposed tokens per
    packed sequence). Shared (copy-on-write) page tables need nothing
    special here — shared pages simply repeat across rows of `page_table`.
    The decomposition below is the gather reference path (shapes the
    kernel's checker declines; a row with no live key gives NaN here); the
    cuda executor claims the symbol whole with a hand-written paged chunk
    kernel (executors/cudaex.py:paged_chunk_attention)."""
    B, H, T, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    npm = page_table.shape[1]
    S = npm * ps
    check(H % Hkv == 0,
          lambda: f"paged_chunk_attention: q heads {H} not divisible by kv heads {Hkv}")
    check(tuple(q_pos.shape) == (B, T),
          lambda: f"paged_chunk_attention: q_pos {q_pos.shape} must be (B, T)=({B}, {T})")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    flat = reshape(page_table, (B * npm,))
    k = clang.take(k_pages, flat, 0)  # (B*npm, ps, Hkv, D)
    v = clang.take(v_pages, flat, 0)
    k = permute(reshape(k, (B, S, Hkv, D)), (0, 2, 1, 3))  # (B, Hkv, S, D)
    v = permute(reshape(v, (B, S, Hkv, D)), (0, 2, 1, 3))
    if H != Hkv:
        k = repeat_interleave(k, H // Hkv, 1)
        v = repeat_interleave(v, H // Hkv, 1)
    scores = clang.mul(prims.matmul(q, clang.matrix_transpose(k)), scale)  # (B, H, T, S)
    k_pos = reshape(prims.iota(S, dtype=dtypes.int32, device=q.device), (1, 1, 1, S))
    live = clang.le(k_pos, reshape(q_pos, (B, 1, T, 1)))
    scores = clang.where(live, scores, float("-inf"))
    probs = softmax(scores, -1)
    probs = clang.maybe_convert_to_dtype(probs, v.dtype)
    return prims.matmul(probs, v)  # (B, H, T, D)


@torchsymbol(name="grouped_mlp", id="thunder.grouped_mlp")
def grouped_mlp(bins, w_gate, w_up, w_down, group_sizes):
    """Grouped/ragged SwiGLU expert MLP over capacity-packed token bins
    (Switch-Transformer/Mixtral-style capacity routing).

    bins         (E, cap, D) — per-expert token bins; rows at index >=
                 group_sizes[e] are padding and MUST be zero-filled (the
                 dispatch scatter guarantees this), so SwiGLU maps them to
                 exactly zero on every road
    w_gate/w_up  (E, D, H)   — per-expert gate/up projections
    w_down       (E, H, D)   — per-expert down projection
    group_sizes  (E,) int    — valid rows per bin; the grouped kernel skips
                 MXU work for wholly-padding bin blocks, the decomposition
                 ignores it (zero rows already produce zero outputs)

    The decomposition below is the batched-matmul reference path; the
    cuda executor claims the symbol with its grouped expert kernel
    (executors/cudaex.py:grouped_mlp)."""
    check(bins.ndim == 3, lambda: f"grouped_mlp: bins must be (E, cap, D), got {bins.shape}")
    E, cap, D = bins.shape
    check(tuple(w_gate.shape) == (E, D, w_gate.shape[-1]),
          lambda: f"grouped_mlp: w_gate {w_gate.shape} must be (E={E}, D={D}, H)")
    H = w_gate.shape[-1]
    check(tuple(w_up.shape) == (E, D, H),
          lambda: f"grouped_mlp: w_up {w_up.shape} must be ({E}, {D}, {H})")
    check(tuple(w_down.shape) == (E, H, D),
          lambda: f"grouped_mlp: w_down {w_down.shape} must be ({E}, {H}, {D})")
    check(tuple(group_sizes.shape) == (E,),
          lambda: f"grouped_mlp: group_sizes {group_sizes.shape} must be (E={E},)")
    g = prims.matmul(bins, w_gate)   # (E, cap, H)
    u = prims.matmul(bins, w_up)
    h = silu(g) * u
    return prims.matmul(h, w_down)   # (E, cap, D)


@torchsymbol(name="mse_loss", id="torch.nn.functional.mse_loss")
def mse_loss(input, target, reduction="mean"):
    d = clang.sub(input, target)
    sq = clang.mul(d, d)
    if reduction == "none":
        return sq
    if reduction == "sum":
        return clang.sum_(sq)
    return clang.mean(sq)


@torchsymbol(name="cross_entropy", id="torch.nn.functional.cross_entropy")
def cross_entropy(logits, target, weight=None, ignore_index=-100, reduction="mean", label_smoothing=0.0):
    """Composite cross-entropy over class dim 1 / last for 2D (logits (N, C))."""
    check(logits.ndim == 2, lambda: "cross_entropy currently expects (N, C) logits")
    lsm = log_softmax(logits, 1)
    n, c = logits.shape
    tgt = clang.unsqueeze(target, 1)
    picked = clang.squeeze(clang.take_along_axis(lsm, tgt, 1), 1)
    nll = prims.neg(picked)
    if label_smoothing > 0.0:
        smooth = prims.neg(clang.mean(lsm, 1))
        nll = clang.add(clang.mul(nll, 1.0 - label_smoothing), clang.mul(smooth, label_smoothing))
    valid = clang.ne(target, ignore_index)
    nll = clang.where(valid, nll, clang.full_like(nll, 0))
    if reduction == "none":
        return nll
    if reduction == "sum":
        return clang.sum_(nll)
    count = clang.sum_(clang.maybe_convert_to_dtype(valid, nll.dtype))
    return clang.true_divide(clang.sum_(nll), count)


def _register_cross_entropy_grad():
    """Composite-level VJP for cross_entropy (thunder_tpu/ops/ltorch.py:1058):
    forward saves (logits, lse) instead of the full (N, C) log-softmax — for
    an LM head that residual is the single biggest tensor in the step
    (N=B*T, C=vocab) — and the backward recomputes softmax from logits."""
    from ..transforms.autodiff import VJPResult, register_augmented_forward, register_backward

    @register_augmented_forward("torch.nn.functional.cross_entropy")
    def _xent_aug(logits, target, weight=None, ignore_index=-100, reduction="mean",
                  label_smoothing=0.0):
        if weight is not None or logits.ndim != 2:
            return NotImplemented
        n, c = logits.shape
        lg = clang.maybe_convert_to_dtype(logits, dtypes.float32)
        m = clang.amax(lg, 1, keepdim=True)
        lse = clang.add(prims.log(clang.sum_(prims.exp(clang.sub(lg, m)), 1, keepdim=True)), m)
        tgt2 = clang.unsqueeze(target, 1)
        # gather from the original-dtype logits and upcast the picked values
        # (exact for bf16→f32), as thunder_tpu does
        picked = clang.maybe_convert_to_dtype(
            clang.take_along_axis(logits, tgt2, 1), dtypes.float32)
        nll = clang.squeeze(clang.sub(lse, picked), 1)
        if label_smoothing > 0.0:
            # smooth term: -mean(log_softmax) = lse - mean(logits)
            smooth = clang.sub(clang.squeeze(lse, 1), clang.mean(lg, 1))
            nll = clang.add(clang.mul(nll, 1.0 - label_smoothing),
                            clang.mul(smooth, label_smoothing))
        valid = clang.ne(target, ignore_index)
        nll = clang.where(valid, nll, clang.full_like(nll, 0))
        count = clang.sum_(clang.maybe_convert_to_dtype(valid, dtypes.float32))
        if reduction == "none":
            out = nll
        elif reduction == "sum":
            out = clang.sum_(nll)
        else:
            out = clang.true_divide(clang.sum_(nll), count)
        return VJPResult(out, (logits, target, lse, valid, count,
                               reduction, float(label_smoothing), int(c)))

    @register_backward("torch.nn.functional.cross_entropy")
    def _xent_bwd(logits, target, lse, valid, count, reduction, label_smoothing, c, g):
        lg = clang.maybe_convert_to_dtype(logits, dtypes.float32)
        soft = prims.exp(clang.sub(lg, lse))  # softmax recomputed from lse
        onehot = clang.eq(
            clang.unsqueeze(target, 1),
            clang.unsqueeze(prims.iota(c, dtype=dtypes.int64, device=logits.device), 0))
        onehot_f = clang.maybe_convert_to_dtype(onehot, dtypes.float32)
        if label_smoothing > 0.0:
            target_dist = clang.add(clang.mul(onehot_f, 1.0 - label_smoothing),
                                    label_smoothing / c)
        else:
            target_dist = onehot_f
        dlogits = clang.sub(soft, target_dist)
        valid_f = clang.maybe_convert_to_dtype(valid, dtypes.float32)
        if reduction == "mean":
            gi = clang.mul(clang.true_divide(g, count), valid_f)
        else:
            gi = clang.mul(g, valid_f)
        dlogits = clang.mul(dlogits, clang.unsqueeze(gi, 1))
        return (clang.maybe_convert_to_dtype(dlogits, logits.dtype), None)


_register_cross_entropy_grad()


@torchsymbol(name="repeat_interleave", method_names=("repeat_interleave",))
def repeat_interleave(a, repeats, dim=None):
    check(isinstance(repeats, (int, NumberProxy)), lambda: "repeat_interleave: only int repeats supported (static shapes)")
    r = pyval(repeats)
    check(r >= 0, lambda: f"repeat_interleave: repeats must be non-negative, got {r}")
    if dim is None:
        a = clang.reshape(a, (a.numel,))
        d = 0
    else:
        d = canonicalize_dim(a.ndim, pyval(dim))
    expanded = clang.unsqueeze(a, d + 1)
    tiled = clang.cat([expanded] * r, d + 1)
    new_shape = tuple(s * r if i == d else s for i, s in enumerate(a.shape))
    return clang.reshape(tiled, new_shape)


@torchsymbol(name="scatter", method_names=("scatter",))
def scatter(a, dim, index, src):
    if isinstance(src, (int, float, NumberProxy)):
        src = clang.full_like(clang.take_along_axis(a, index, pyval(dim)), pyval(src))
    return prims.scatter(a, index, src, canonicalize_dim(a.ndim, pyval(dim)))


@torchsymbol(name="index_copy", method_names=("index_copy",))
def index_copy(a, dim, index, src):
    return clang.index_copy(a, dim, index, src)


@torchsymbol(name="index_put", method_names=("index_put",))
def index_put(a, indices, values, accumulate=False):
    """a[indices] = values, functionally. torchex runs the whole symbol as
    one torch ``index_put``, and in place when ``a`` is a program input that
    nothing else in the program reads (executors/passes.py:write_dead_inputs_in_place)."""
    return clang.index_put(a, tuple(indices), values, accumulate)



# ---------------------------------------------------------------------------
# the torch frontend's surface (interop/torch_frontend.py): the ops its
# mapping table and its same-name methods reach, as thunder_tpu writes them
# ---------------------------------------------------------------------------

clip = clamp  # torch.clip is torch.clamp: one symbol, as thunder_tpu records it

log10 = _unary("log10", prims.log10, int_to_float=True)
lgamma = _unary("lgamma", prims.lgamma, int_to_float=True)
digamma = _unary("digamma", prims.digamma, int_to_float=True)
erfinv = _unary("erfinv", prims.erfinv, int_to_float=True)
asinh = _unary("asinh", prims.asinh, int_to_float=True)
acosh = _unary("acosh", prims.acosh, int_to_float=True)
atanh = _unary("atanh", prims.atanh, int_to_float=True)
signbit = _unary("signbit", prims.signbit)


@torchsymbol(name="square", method_names=("square",))
def square(a):
    return clang.mul(a, a)


@torchsymbol(name="frac", method_names=("frac",))
def frac(a):
    return clang.sub(a, prims.trunc(a))


@torchsymbol(name="nan_to_num", method_names=("nan_to_num",))
def nan_to_num(a, nan=0.0, posinf=None, neginf=None):
    if posinf is None:
        posinf = dtypes.finfo_max(a.dtype)
    if neginf is None:
        neginf = -dtypes.finfo_max(a.dtype)
    out = clang.where(prims.isnan(a), clang.full_like(a, nan), a)
    out = clang.where(clang.eq(a, float("inf")), clang.full_like(a, posinf), out)
    out = clang.where(clang.eq(a, float("-inf")), clang.full_like(a, neginf), out)
    return out


@torchsymbol(name="hardtanh", id="torch.nn.functional.hardtanh")
def hardtanh(a, min_val=-1.0, max_val=1.0):
    return clang.minimum(clang.maximum(a, min_val), max_val)


@torchsymbol(name="hardswish", id="torch.nn.functional.hardswish")
def hardswish(a):
    return clang.mul(a, clang.true_divide(clang.minimum(clang.maximum(clang.add(a, 3.0), 0.0), 6.0), 6.0))


@torchsymbol(name="hardsigmoid", id="torch.nn.functional.hardsigmoid")
def hardsigmoid(a):
    return clang.true_divide(clang.minimum(clang.maximum(clang.add(a, 3.0), 0.0), 6.0), 6.0)


@torchsymbol(name="elu", id="torch.nn.functional.elu")
def elu(a, alpha=1.0):
    return clang.where(clang.gt(a, 0), a, clang.mul(alpha, prims.expm1(a)))


@torchsymbol(name="logaddexp", method_names=("logaddexp",))
def logaddexp(a, b):
    m = clang.maximum(a, b)
    out = clang.add(m, prims.log1p(prims.exp(prims.neg(prims.abs(clang.sub(a, b))))))
    # a == b (incl. ±inf where a-b is nan): exact result is a + log(2)
    return clang.where(clang.eq(a, b), clang.add(m, math.log(2.0)), out)


@torchsymbol(name="logaddexp2", method_names=("logaddexp2",))
def logaddexp2(a, b):
    m = clang.maximum(a, b)
    inner = prims.exp2(prims.neg(prims.abs(clang.sub(a, b))))
    out = clang.add(m, clang.true_divide(prims.log1p(inner), math.log(2.0)))
    return clang.where(clang.eq(a, b), clang.add(m, 1.0), out)


@torchsymbol(name="hypot", method_names=("hypot",))
def hypot(a, b):
    return clang._elementwise_binary(prims.hypot, a, b)


@torchsymbol(name="copysign", method_names=("copysign",))
def copysign(a, b):
    return clang._elementwise_binary(prims.copysign, a, b)


@torchsymbol(name="xlogy", method_names=("xlogy",))
def xlogy(a, b):
    safe = prims.log(clang.where(clang.eq(a, 0), clang.full_like(b, 1.0), b))
    return clang.where(clang.eq(a, 0), clang.full_like(safe, 0.0), clang.mul(a, safe))


@torchsymbol(name="heaviside", method_names=("heaviside",))
def heaviside(a, values):
    out = clang.where(clang.gt(a, 0), clang.full_like(a, 1.0), clang.full_like(a, 0.0))
    return clang.where(clang.eq(a, 0), values, out)


@torchsymbol(name="clamp_min", method_names=("clamp_min",))
def clamp_min(a, min):
    return clang.maximum(a, min)


@torchsymbol(name="clamp_max", method_names=("clamp_max",))
def clamp_max(a, max):
    return clang.minimum(a, max)


@torchsymbol(name="rsub", method_names=("rsub",))
def rsub(a, b, *, alpha=None):
    if alpha is not None and pyval(alpha) != 1:
        a = clang.mul(a, alpha)
    return clang.sub(b, a)


@torchsymbol(name="logical_xor", method_names=("logical_xor",))
def logical_xor(a, b):
    return clang.ne(clang.to_bool(a), clang.to_bool(b))


@torchsymbol(name="logsumexp", method_names=("logsumexp",))
def logsumexp(a, dim, keepdim=False):
    m = clang.amax(a, dim, keepdim=True)
    m_stopped = prims.stop_gradient(m)
    s = clang.sum_(prims.exp(clang.sub(a, m_stopped)), dim, keepdim=True)
    out = clang.add(prims.log(s), m_stopped)
    if not keepdim:
        dims = clang._reduction_dims(a, dim)
        out = clang.squeeze(out, dims)
    return out


@torchsymbol(name="softmin", id="torch.nn.functional.softmin")
def softmin(a, dim=-1):
    return softmax.meta(prims.neg(a), dim)


@torchsymbol(name="cumprod", method_names=("cumprod",))
def cumprod(a, dim):
    return prims.cumprod(a, canonicalize_dim(a.ndim, pyval(dim)))


@torchsymbol(name="cummax", method_names=("cummax",))
def cummax(a, dim):
    return prims.cummax(a, canonicalize_dim(a.ndim, pyval(dim)))


@torchsymbol(name="count_nonzero", method_names=("count_nonzero",))
def count_nonzero(a, dim=None):
    nz = clang.ne(a, 0)
    return clang.sum_(clang.maybe_convert_to_dtype(nz, dtypes.int64), dim, False)


@torchsymbol(name="nansum", method_names=("nansum",))
def nansum(a, dim=None, keepdim=False):
    cleaned = clang.where(prims.isnan(a), clang.full_like(a, 0), a)
    return clang.sum_(cleaned, dim, keepdim)


@torchsymbol(name="nanmean", method_names=("nanmean",))
def nanmean(a, dim=None, keepdim=False):
    nan_mask = prims.isnan(a)
    cleaned = clang.where(nan_mask, clang.full_like(a, 0), a)
    total = clang.sum_(cleaned, dim, keepdim)
    count = clang.sum_(clang.maybe_convert_to_dtype(prims.logical_not(nan_mask), a.dtype), dim, keepdim)
    return clang.true_divide(total, count)


@torchsymbol(name="aminmax", method_names=("aminmax",))
def aminmax(a, *, dim=None, keepdim=False):
    return clang.amin(a, dim, keepdim), clang.amax(a, dim, keepdim)


@torchsymbol(name="median", method_names=("median",))
def median(a, dim=None, keepdim=False):
    """torch.median: global form returns the lower median value."""
    if dim is None:
        flat = clang.reshape(a, (a.numel,))
        s = prims.sort(flat, 0, False)
        return clang.squeeze(clang.slice_in_dim(s, (a.numel - 1) // 2, (a.numel - 1) // 2 + 1, 0), (0,))
    d = canonicalize_dim(a.ndim, pyval(dim))
    n = a.shape[d]
    sv = prims.sort(a, d, False)
    si = prims.argsort(a, d, False)
    values = clang.slice_in_dim(sv, (n - 1) // 2, (n - 1) // 2 + 1, d)
    indices = clang.slice_in_dim(si, (n - 1) // 2, (n - 1) // 2 + 1, d)
    if not keepdim:
        values = clang.squeeze(values, (d,))
        indices = clang.squeeze(indices, (d,))
    return values, clang.maybe_convert_to_dtype(indices, dtypes.int64)


@torchsymbol(name="norm", method_names=("norm",))
def norm(a, p=2, dim=None, keepdim=False):
    p = pyval(p) if not isinstance(p, str) else p
    check(isinstance(p, (int, float)) or p in ("fro", "inf"),
          lambda: f"norm: ord/p must be a number or 'fro'/'inf', got {p!r}")
    if p == "fro" or p == 2:
        return prims.sqrt(clang.sum_(clang.mul(a, a), dim, keepdim))
    if p == "inf" or p == float("inf"):
        return clang.amax(prims.abs(a), dim, keepdim)
    if p == float("-inf"):
        return clang.amin(prims.abs(a), dim, keepdim)
    if p == 1:
        return clang.sum_(prims.abs(a), dim, keepdim)
    powd = clang.pow_(prims.abs(a), p)
    return clang.pow_(clang.sum_(powd, dim, keepdim), 1.0 / p)


@torchsymbol(name="normalize", id="torch.nn.functional.normalize")
def normalize(a, p=2.0, dim=1, eps=1e-12):
    n = norm.meta(a, pyval(p), pyval(dim), True)
    return clang.true_divide(a, clang.maximum(n, eps))


@torchsymbol(name="cosine_similarity", id="torch.nn.functional.cosine_similarity")
def cosine_similarity(x1, x2, dim=1, eps=1e-8):
    num = clang.sum_(clang.mul(x1, x2), dim, False)
    n1 = prims.sqrt(clang.sum_(clang.mul(x1, x1), dim, False))
    n2 = prims.sqrt(clang.sum_(clang.mul(x2, x2), dim, False))
    return clang.true_divide(num, clang.maximum(clang.mul(n1, n2), eps))


# shape and indexing -----------------------------------------------------------


@torchsymbol(name="narrow", method_names=("narrow",))
def narrow(a, dim, start, length):
    dim = canonicalize_dim(a.ndim, pyval(dim))
    start = pyval(start)
    if start < 0:
        start += a.shape[dim]
    return clang.slice_in_dim(a, start, start + pyval(length), dim)


@torchsymbol(name="select", method_names=("select",))
def select(a, dim, index):
    dim = canonicalize_dim(a.ndim, pyval(dim))
    index = pyval(index)
    if index < 0:
        index += a.shape[dim]
    return clang.squeeze(clang.slice_in_dim(a, index, index + 1, dim), (dim,))


@torchsymbol(name="unbind", method_names=("unbind",))
def unbind(a, dim=0):
    dim = canonicalize_dim(a.ndim, pyval(dim))
    return tuple(select.meta(a, dim, i) for i in builtins.range(a.shape[dim]))


@torchsymbol(name="tile", method_names=("tile",))
def tile(a, *dims):
    if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
        dims = tuple(dims[0])
    out = a
    while out.ndim < len(dims):
        out = clang.unsqueeze(out, 0)
    dims = (1,) * (out.ndim - len(dims)) + tuple(pyval(d) for d in dims)
    for i, d in enumerate(dims):
        check(d >= 0, lambda: f"tile: negative repeat {d} for dim {i}")
        if d == 0:
            out = clang.slice_in_dim(out, 0, 0, i)
        elif d > 1:
            out = clang.cat([out] * d, i)
    return out


@torchsymbol(name="broadcast_to", method_names=("broadcast_to",))
def broadcast_to(a, shape):
    return clang.expand(a, tuple(shape))


@torchsymbol(name="expand_as", method_names=("expand_as",))
def expand_as(a, other):
    return clang.expand(a, other.shape)


@torchsymbol(name="diagonal", method_names=("diagonal",), id="torch.diagonal")
def diagonal_op(a, offset=0, dim1=0, dim2=1):
    d1 = canonicalize_dim(a.ndim, pyval(dim1))
    d2 = canonicalize_dim(a.ndim, pyval(dim2))
    k = pyval(offset)
    n1, n2 = a.shape[d1], a.shape[d2]
    dlen = builtins.max(0, builtins.min(n1, n2 - k) if k >= 0 else builtins.min(n1 + k, n2))
    # move d1,d2 to the end
    order = [i for i in builtins.range(a.ndim) if i not in (d1, d2)] + [d1, d2]
    moved = clang.permute(a, order)
    i = prims.iota(dlen, dtype=dtypes.int32, device=a.device)
    r = clang.add(i, builtins.max(0, -k))
    c = clang.add(i, builtins.max(0, k))
    flat = clang.reshape(moved, moved.shape[:-2] + (n1 * n2,))
    lin = clang.add(clang.mul(r, n2), c)
    lin_b = clang.expand_to(lin, flat.shape[:-1] + (dlen,))
    return clang.take_along_axis(flat, lin_b, flat.ndim - 1)


@torchsymbol(name="diag", method_names=("diag",))
def diag(a, diagonal=0):
    k = pyval(diagonal)
    if a.ndim == 1:
        n = a.shape[0] + builtins.abs(k)
        r = clang.unsqueeze(prims.iota(n, dtype=dtypes.int32, device=a.device), 1)
        c = clang.unsqueeze(prims.iota(n, dtype=dtypes.int32, device=a.device), 0)
        mask = clang.eq(clang.sub(c, r), k)
        # place values: index vector along the diagonal
        src = clang.expand(clang.unsqueeze(a, 0), (n, a.shape[0]))
        idx = clang.sub(c if k >= 0 else r, builtins.abs(k))
        take_idx = clang.maximum(clang.minimum(idx, a.shape[0] - 1), 0)
        vals = clang.take_along_axis(src, clang.expand(take_idx, (n, n)) if take_idx.shape != (n, n) else take_idx, 1)
        zero = clang.full_like(vals, 0)
        return clang.where(mask, vals, zero)
    return diagonal_op.meta(a, offset=k)


@torchsymbol(name="ravel", method_names=("ravel",))
def ravel(a):
    return clang.reshape(a, (a.numel,))


@torchsymbol(name="unflatten", method_names=("unflatten",))
def unflatten(a, dim, sizes):
    dim = canonicalize_dim(a.ndim, pyval(dim))
    sizes = tuple(pyval(s) for s in sizes)
    if -1 not in sizes:
        prod = 1
        for x in sizes:
            prod *= x
        check(prod == a.shape[dim],
              lambda: f"unflatten: sizes {sizes} (product {prod}) must multiply to dim {dim} size {a.shape[dim]}")
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes = tuple(a.shape[dim] // known if s == -1 else s for s in sizes)
    return clang.reshape(a, a.shape[:dim] + sizes + a.shape[dim + 1 :])


@torchsymbol(name="pixel_shuffle", id="torch.nn.functional.pixel_shuffle")
def pixel_shuffle(a, upscale_factor):
    r = pyval(upscale_factor)
    N, C, H, W = a.shape
    check(C % (r * r) == 0, lambda: f"pixel_shuffle: {C} % {r*r}")
    out = clang.reshape(a, (N, C // (r * r), r, r, H, W))
    out = clang.permute(out, (0, 1, 4, 2, 5, 3))
    return clang.reshape(out, (N, C // (r * r), H * r, W * r))


def _pair(v):
    """int-or-(a, b) normalization shared by the im2col family."""
    if isinstance(v, (int, NumberProxy)):
        n = int(pyval(v))
        return n, n
    a, b = v
    return int(pyval(a)), int(pyval(b))


@torchsymbol(name="unfold", id="torch.nn.functional.unfold")
def unfold(a, kernel_size, dilation=1, padding=0, stride=1):
    """F.unfold (im2col): (N, C, H, W) -> (N, C*kh*kw, L), as kh*kw strided
    slices."""
    kh, kw = _pair(kernel_size)
    dh, dw = _pair(dilation)
    ph, pw = _pair(padding)
    sh, sw = _pair(stride)
    N, C, H, W = a.shape
    if ph or pw:
        a = clang.pad(a, 0.0, [(0, 0, 0), (0, 0, 0), (ph, ph, 0), (pw, pw, 0)])
        H, W = H + 2 * ph, W + 2 * pw
    oh = (H - (kh - 1) * dh - 1) // sh + 1
    ow = (W - (kw - 1) * dw - 1) // sw + 1
    patches = []
    for i in builtins.range(kh):
        for j in builtins.range(kw):
            r0, c0 = i * dh, j * dw
            sl = prims.slice_prim(a, (0, 0, r0, c0),
                                  (N, C, r0 + (oh - 1) * sh + 1, c0 + (ow - 1) * sw + 1),
                                  (1, 1, sh, sw))
            patches.append(clang.reshape(sl, (N, C, 1, oh * ow)))
    out = clang.cat(patches, 2)  # (N, C, kh*kw, L)
    return clang.reshape(out, (N, C * kh * kw, oh * ow))


@torchsymbol(name="fold", id="torch.nn.functional.fold")
def fold(a, output_size, kernel_size, dilation=1, padding=0, stride=1):
    """F.fold (col2im): (N, C*kh*kw, L) -> (N, C, H, W), overlaps summed."""
    H, W = _pair(output_size)
    kh, kw = _pair(kernel_size)
    check(a.ndim == 3 and a.shape[1] % (kh * kw) == 0,
          lambda: f"fold expects (N, C*kh*kw, L) input; dim 1 of {tuple(a.shape)} "
                  f"is not divisible by the kernel block size {kh*kw}")
    dh, dw = _pair(dilation)
    ph, pw = _pair(padding)
    sh, sw = _pair(stride)
    N = a.shape[0]
    C = a.shape[1] // (kh * kw)
    Hp, Wp = H + 2 * ph, W + 2 * pw
    oh = (Hp - (kh - 1) * dh - 1) // sh + 1
    ow = (Wp - (kw - 1) * dw - 1) // sw + 1
    cols = clang.reshape(a, (N, C, kh * kw, oh, ow))
    out = clang.full((N, C, Hp, Wp), 0.0, dtype=a.dtype, device=a.device)
    # scatter each kernel position back with stride-interior padding
    for i in builtins.range(kh):
        for j in builtins.range(kw):
            idx = i * kw + j
            piece = clang.squeeze(clang.slice_in_dim(cols, idx, idx + 1, 2), (2,))  # (N,C,oh,ow)
            r0, c0 = i * dh, j * dw
            expanded = clang.pad(piece, 0.0, [
                (0, 0, 0), (0, 0, 0),
                (r0, Hp - r0 - ((oh - 1) * sh + 1), sh - 1),
                (c0, Wp - c0 - ((ow - 1) * sw + 1), sw - 1),
            ])
            out = clang.add(out, expanded)
    if ph or pw:
        out = prims.slice_prim(out, (0, 0, ph, pw), (N, C, ph + H, pw + W), (1, 1, 1, 1))
    return out


@torchsymbol(name="interpolate", id="torch.nn.functional.interpolate")
def interpolate(a, size=None, scale_factor=None, mode="nearest"):
    """Static-shape interpolate: nearest / bilinear (align_corners=False)."""
    n_spatial = a.ndim - 2
    in_sp = a.shape[2:]
    if size is not None:
        out_sp = (size,) * n_spatial if isinstance(size, int) else tuple(pyval(s) for s in size)
    else:
        sf = (scale_factor,) * n_spatial if isinstance(scale_factor, (int, float)) else tuple(scale_factor)
        out_sp = tuple(int(s * f) for s, f in zip(in_sp, sf))
    if mode == "nearest":
        out = a
        for i, (si, so) in enumerate(zip(in_sp, out_sp)):
            dim = 2 + i
            idx_f = clang.mul(clang.add(prims.iota(so, dtype=dtypes.float32, device=a.device), 0.0), si / so)
            idx = clang.maybe_convert_to_dtype(prims.floor(idx_f), dtypes.int32)
            out = clang.take(out, idx, dim)
        return out
    check(mode in ("bilinear", "linear"), lambda: f"interpolate mode {mode} unsupported")
    out = a
    for i, (si, so) in enumerate(zip(in_sp, out_sp)):
        dim = 2 + i
        # align_corners=False source coordinates
        coord = clang.sub(clang.mul(clang.add(prims.iota(so, dtype=dtypes.float32, device=a.device), 0.5), si / so), 0.5)
        coord = clang.maximum(clang.minimum(coord, float(si - 1)), 0.0)
        lo_f = prims.floor(coord)
        w_hi = clang.sub(coord, lo_f)
        lo = clang.maybe_convert_to_dtype(lo_f, dtypes.int32)
        hi = clang.minimum(clang.add(lo, 1), si - 1)
        g_lo = clang.take(out, lo, dim)
        g_hi = clang.take(out, hi, dim)
        shape = [1] * out.ndim
        shape[dim] = so
        w = clang.reshape(w_hi, tuple(shape))
        out = clang.add(clang.mul(g_lo, clang.sub(1.0, w)), clang.mul(g_hi, w))
    return out


# products -------------------------------------------------------------------


@torchsymbol(name="baddbmm", method_names=("baddbmm",))
def baddbmm(input, batch1, batch2, *, beta=1, alpha=1):
    out = prims.matmul(batch1, batch2)
    if pyval(alpha) != 1:
        out = clang.mul(out, alpha)
    if pyval(beta) != 0:
        out = clang.add(out, clang.mul(input, beta) if pyval(beta) != 1 else input)
    return out


@torchsymbol(name="addmm", method_names=("addmm",))
def addmm(input, mat1, mat2, *, beta=1, alpha=1):
    return baddbmm.meta(input, mat1, mat2, beta=beta, alpha=alpha)


@torchsymbol(name="outer", method_names=("outer",))
def outer(a, b):
    check(a.ndim == 1 and b.ndim == 1,
          lambda: f"outer expects 1D vectors, got {a.ndim}-D and {b.ndim}-D")
    return clang.mul(clang.unsqueeze(a, 1), clang.unsqueeze(b, 0))


@torchsymbol(name="mv", method_names=("mv",))
def mv(a, b):
    check(a.ndim == 2 and b.ndim == 1, lambda: "mv expects (2D, 1D)")
    return prims.matmul(a, b)


@torchsymbol(name="dot", method_names=("dot",))
def dot(a, b):
    check(a.ndim == 1 and b.ndim == 1, lambda: "dot expects 1D tensors")
    check(a.shape[0] == b.shape[0],
          lambda: f"dot: 1D tensors must have the same size, got {a.shape[0]} and {b.shape[0]}")
    return prims.matmul(a, b)


@torchsymbol(name="vdot", method_names=("vdot",))
def vdot(a, b):
    return prims.matmul(a, b)


@torchsymbol(name="kron", method_names=("kron",))
def kron(a, b):
    check(a.ndim == b.ndim, lambda: "kron: rank mismatch (pad with reshape first)")
    out = clang.mul(
        clang.reshape(a, tuple(x for s in a.shape for x in (s, 1))),
        clang.reshape(b, tuple(x for s in b.shape for x in (1, s))),
    )
    return clang.reshape(out, tuple(sa * sb for sa, sb in zip(a.shape, b.shape)))


@torchsymbol(name="tensordot", method_names=("tensordot",))
def tensordot(a, b, dims=2):
    if isinstance(dims, int):
        axes_a = list(builtins.range(a.ndim - dims, a.ndim))
        axes_b = list(builtins.range(dims))
    else:
        axes_a = [canonicalize_dim(a.ndim, pyval(d)) for d in dims[0]]
        axes_b = [canonicalize_dim(b.ndim, pyval(d)) for d in dims[1]]
    free_a = [i for i in builtins.range(a.ndim) if i not in axes_a]
    free_b = [i for i in builtins.range(b.ndim) if i not in axes_b]
    pa = clang.permute(a, free_a + axes_a)
    pb = clang.permute(b, axes_b + free_b)
    M = 1
    for i in free_a:
        M *= a.shape[i]
    K = 1
    for i in axes_a:
        K *= a.shape[i]
    N = 1
    for i in free_b:
        N *= b.shape[i]
    out = prims.matmul(clang.reshape(pa, (M, K)), clang.reshape(pb, (K, N)))
    return clang.reshape(out, tuple(a.shape[i] for i in free_a) + tuple(b.shape[i] for i in free_b))


# losses ---------------------------------------------------------------------


def _apply_reduction(loss, reduction):
    if reduction == "none":
        return loss
    if reduction == "sum":
        return clang.sum_(loss)
    return clang.mean(loss)


@torchsymbol(name="l1_loss", id="torch.nn.functional.l1_loss")
def l1_loss(input, target, reduction="mean"):
    return _apply_reduction(prims.abs(clang.sub(input, target)), reduction)


@torchsymbol(name="smooth_l1_loss", id="torch.nn.functional.smooth_l1_loss")
def smooth_l1_loss(input, target, reduction="mean", beta=1.0):
    d = clang.sub(input, target)
    ad = prims.abs(d)
    quad = clang.true_divide(clang.mul(clang.mul(d, d), 0.5), beta)
    lin = clang.sub(ad, 0.5 * beta)
    return _apply_reduction(clang.where(clang.lt(ad, beta), quad, lin), reduction)


@torchsymbol(name="huber_loss", id="torch.nn.functional.huber_loss")
def huber_loss(input, target, reduction="mean", delta=1.0):
    d = clang.sub(input, target)
    ad = prims.abs(d)
    quad = clang.mul(clang.mul(d, d), 0.5)
    lin = clang.mul(delta, clang.sub(ad, 0.5 * delta))
    return _apply_reduction(clang.where(clang.lt(ad, delta), quad, lin), reduction)


@torchsymbol(name="binary_cross_entropy", id="torch.nn.functional.binary_cross_entropy")
def binary_cross_entropy(input, target, weight=None, reduction="mean"):
    eps = 1e-12
    loss = prims.neg(clang.add(
        clang.mul(target, prims.log(clang.maximum(input, eps))),
        clang.mul(clang.sub(1.0, target), prims.log(clang.maximum(clang.sub(1.0, input), eps))),
    ))
    if weight is not None:
        loss = clang.mul(loss, weight)
    return _apply_reduction(loss, reduction)


@torchsymbol(name="binary_cross_entropy_with_logits", id="torch.nn.functional.binary_cross_entropy_with_logits")
def binary_cross_entropy_with_logits(input, target, weight=None, pos_weight=None, reduction="mean"):
    # max(x,0) - x*z + log(1 + exp(-|x|)) — numerically stable
    neg_abs = prims.neg(prims.abs(input))
    loss = clang.add(clang.sub(clang.maximum(input, 0.0), clang.mul(input, target)),
                     prims.log1p(prims.exp(neg_abs)))
    if pos_weight is not None:
        log_sig = prims.neg(clang.add(clang.maximum(prims.neg(input), 0.0),
                                      prims.log1p(prims.exp(neg_abs))))
        log_sig_neg = clang.sub(log_sig, input)
        loss = prims.neg(clang.add(clang.mul(clang.mul(target, pos_weight), log_sig),
                                   clang.mul(clang.sub(1.0, target), log_sig_neg)))
    if weight is not None:
        loss = clang.mul(loss, weight)
    return _apply_reduction(loss, reduction)


@torchsymbol(name="kl_div", id="torch.nn.functional.kl_div")
def kl_div(input, target, reduction="mean", log_target=False):
    if log_target:
        loss = clang.mul(prims.exp(target), clang.sub(target, input))
    else:
        eps_t = clang.maximum(target, 1e-12)
        loss = clang.mul(target, clang.sub(prims.log(eps_t), input))
    if reduction == "batchmean":
        return clang.true_divide(clang.sum_(loss), input.shape[0])
    return _apply_reduction(loss, reduction)


@torchsymbol(name="soft_margin_loss", id="torch.nn.functional.soft_margin_loss")
def soft_margin_loss(input, target, reduction="mean"):
    return _apply_reduction(prims.log1p(prims.exp(prims.neg(clang.mul(input, target)))), reduction)


@torchsymbol(name="hinge_embedding_loss", id="torch.nn.functional.hinge_embedding_loss")
def hinge_embedding_loss(input, target, margin=1.0, reduction="mean"):
    pos = input
    neg = clang.maximum(clang.sub(margin, input), 0.0)
    loss = clang.where(clang.gt(target, 0), pos, neg)
    return _apply_reduction(loss, reduction)


@torchsymbol(name="triplet_margin_loss", id="torch.nn.functional.triplet_margin_loss")
def triplet_margin_loss(anchor, positive, negative, margin=1.0, p=2.0, reduction="mean"):
    dp = norm.meta(clang.sub(anchor, positive), pyval(p), -1, False)
    dn = norm.meta(clang.sub(anchor, negative), pyval(p), -1, False)
    loss = clang.maximum(clang.add(clang.sub(dp, dn), margin), 0.0)
    return _apply_reduction(loss, reduction)


@torchsymbol(name="nll_loss", id="torch.nn.functional.nll_loss")
def nll_loss(log_probs, target, weight=None, ignore_index=-100, reduction="mean"):
    # an ignored row gathers row 0: jax reads a fill value there, torch's
    # gather would raise on the sentinel; the row is masked to 0 below
    valid = clang.ne(target, ignore_index)
    tgt = clang.unsqueeze(clang.where(valid, target, clang.full_like(target, 0)), 1)
    picked = clang.squeeze(clang.take_along_axis(log_probs, tgt, 1), 1)
    nll = prims.neg(picked)
    if weight is not None:
        # per-sample class weights; torch normalizes the mean by their sum
        safe_tgt = clang.where(valid, target, clang.full_like(target, 0))
        w = clang.take(weight, safe_tgt, 0)
        nll = clang.mul(nll, w)
        denom = clang.sum_(clang.where(valid, w, clang.full_like(w, 0)))
    else:
        denom = clang.sum_(clang.maybe_convert_to_dtype(valid, nll.dtype))
    nll = clang.where(valid, nll, clang.full_like(nll, 0))
    if reduction == "none":
        return nll
    if reduction == "sum":
        return clang.sum_(nll)
    return clang.true_divide(clang.sum_(nll), denom)


# registered last, as thunder_tpu registers it: ``a / b`` on a proxy records
# torch.true_divide
@torchsymbol(name="true_divide", method_names=("true_divide",))
def true_divide(a, b):
    return clang.true_divide(a, b)
