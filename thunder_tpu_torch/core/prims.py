"""Primitive operations (the closed op set transforms and executors reason about).

The prim set of thunder_tpu/core/prims.py, unchanged in names, ids and
metas, so both packages print the same traces. Composite ops (softmax,
rms_norm, paged_attention, ...) live in the op namespaces and decompose into
these prims; executors/torchex.py runs each prim as one torch call.

One addition: factories (``full``, ``iota``) made without a device take the
trace's device, and the bound symbol records it, so a constant made inside
a program lands on the program's device.
"""
from __future__ import annotations

from enum import Enum, auto

from . import dtypes
from .baseutils import check, canonicalize_dim, canonicalize_dims
from .devices import to_device
from .proxies import NumberProxy, TensorProxy, pyval
from .symbol import OpTags, Symbol


class PrimIDs(Enum):
    # program structure
    RETURN = auto()
    COMMENT = auto()
    DEL = auto()
    PRINT = auto()
    UNPACK_TRIVIAL = auto()
    # prologue checks (reference prims.py CHECK_* family)
    CHECK_TENSOR_SHAPE_AND_METADATA = auto()
    CHECK_NUMBER_TYPE_AND_VALUE = auto()
    CHECK_LITERAL_LIKE = auto()
    # prologue unpacks (reference prims.py UNPACK_* family) — extract captured
    # values (globals / closure cells / attribute & item chains) at call time
    UNPACK_GLOBAL = auto()
    UNPACK_CLOSURE = auto()
    UNPACK_ATTR = auto()
    UNPACK_ITEM = auto()
    UNPACK_TENSOR_DATA = auto()
    # dtype/device movement
    CONVERT_ELEMENT_TYPE = auto()
    DEVICE_PUT = auto()
    STOP_GRADIENT = auto()
    BITCAST = auto()
    # factories
    TENSOR_CONSTANT = auto()
    FULL = auto()
    IOTA = auto()
    UNIFORM = auto()
    NORMAL = auto()
    RNG_SPLIT = auto()
    RANDINT = auto()
    # shape ops
    RESHAPE = auto()
    TRANSPOSE = auto()
    BROADCAST_IN_DIM = auto()
    SLICE = auto()
    SQUEEZE = auto()
    CAT = auto()
    PAD = auto()
    FLIP = auto()
    VAR = auto()
    TAKE = auto()
    TAKE_ALONG_AXIS = auto()
    INDEX_ADD = auto()
    SCATTER_ADD = auto()
    GETITEM_ADV = auto()
    DYNAMIC_SLICE = auto()
    DYNAMIC_UPDATE_SLICE = auto()
    # elementwise unary
    ABS = auto(); NEG = auto(); EXP = auto(); EXP2 = auto(); EXPM1 = auto(); LOG = auto()
    LOG1P = auto(); LOG2 = auto(); SQRT = auto(); RSQRT = auto(); SIN = auto(); COS = auto()
    TAN = auto(); TANH = auto(); ASIN = auto(); ACOS = auto(); ATAN = auto(); SINH = auto()
    COSH = auto(); ASINH = auto(); ACOSH = auto(); ATANH = auto(); ERF = auto(); ERFC = auto()
    ERFINV = auto(); FLOOR = auto(); CEIL = auto(); ROUND = auto(); TRUNC = auto(); SIGN = auto()
    ISFINITE = auto(); ISNAN = auto(); ISINF = auto(); RECIPROCAL = auto(); LOGICAL_NOT = auto()
    BITWISE_NOT = auto(); REAL = auto(); IMAG = auto()
    LOG10 = auto(); LGAMMA = auto(); DIGAMMA = auto(); SIGNBIT = auto()
    # elementwise binary
    ADD = auto(); SUB = auto(); MUL = auto(); DIV = auto(); POW = auto(); FMOD = auto()
    REMAINDER = auto(); MAXIMUM = auto(); MINIMUM = auto(); ATAN2 = auto()
    BITWISE_AND = auto(); BITWISE_OR = auto(); BITWISE_XOR = auto()
    SHIFT_LEFT = auto(); SHIFT_RIGHT = auto()
    NEXTAFTER = auto(); COPYSIGN = auto(); HYPOT = auto(); GCD = auto(); LCM = auto()
    EQ = auto(); NE = auto(); LT = auto(); LE = auto(); GT = auto(); GE = auto()
    # ternary
    WHERE = auto()
    # reductions
    SUM = auto(); PROD = auto(); AMAX = auto(); AMIN = auto(); ARGMAX = auto(); ARGMIN = auto()
    ANY = auto(); ALL_REDUCE_BOOL = auto()
    CUMSUM = auto(); CUMPROD = auto(); CUMMAX = auto()
    TOPK = auto(); ARGSORT = auto(); SORT = auto()
    REDUCE_WINDOW = auto()
    # linear algebra / NN
    MATMUL = auto()
    LINEAR = auto()
    CONVOLUTION = auto()
    CONV_TRANSPOSE = auto()
    EMBEDDING = auto()
    GROUPED_MM = auto()
    EINSUM = auto()
    SCATTER = auto()
    # memory / interop
    ITEM = auto()
    COPY_WITH_SETITEM = auto()
    UPDATE_ALIASES = auto()
    # autodiff glue (reference prims.py:1847,1877)
    GET_GRAD = auto()
    PUT_GRAD = auto()


_prim_registry: dict[PrimIDs, Symbol] = {}


def get_prim(pid: PrimIDs) -> Symbol:
    return _prim_registry[pid]


def make_prim(pid: PrimIDs, name: str, meta, *, tags=(), python_impl=None, print_override=None,
              _bind_postprocess=None) -> Symbol:
    sym = Symbol(
        name,
        meta,
        id=pid,
        is_prim=True,
        module="prims",
        tags=tags,
        python_impl=python_impl,
        print_override=print_override,
        _bind_postprocess=_bind_postprocess,
    )
    _prim_registry[pid] = sym
    return sym


# ---------------------------------------------------------------------------
# meta helpers
# ---------------------------------------------------------------------------


def _tensor_args(args) -> list[TensorProxy]:
    return [a for a in args if isinstance(a, TensorProxy)]


def _same_shape_meta(*args, dtype_override=None):
    ts = _tensor_args(args)
    check(len(ts) > 0, lambda: "elementwise prim requires at least one tensor arg")
    shape = ts[0].shape
    for t in ts[1:]:
        check(
            t.shape == shape,
            lambda: f"elementwise prim shape mismatch {t.shape} vs {shape} (broadcast in clang layer)",
        )
    dt = dtype_override or ts[0].dtype
    dev = ts[0].device
    return TensorProxy(shape=shape, dtype=dt, device=dev)


def _elementwise_unary_meta(a, **kwargs):
    check(isinstance(a, TensorProxy), lambda: f"expected TensorProxy, got {type(a)}")
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


def _float_unary_meta(a, **kwargs):
    return TensorProxy(shape=a.shape, dtype=dtypes.float_math_dtype(a.dtype), device=a.device)


def _bool_unary_meta(a, **kwargs):
    return TensorProxy(shape=a.shape, dtype=dtypes.bool8, device=a.device)


def _comparison_meta(a, b):
    return _same_shape_meta(a, b, dtype_override=dtypes.bool8)


def _reduction_meta(a, dims, *, output_dtype=None, keepdims=False):
    dims = tuple(canonicalize_dims(a.ndim, dims)) if dims is not None else tuple(range(a.ndim))
    if keepdims:
        shape = tuple(1 if i in dims else s for i, s in enumerate(a.shape))
    else:
        shape = tuple(s for i, s in enumerate(a.shape) if i not in dims)
    return TensorProxy(shape=shape, dtype=output_dtype or a.dtype, device=a.device)


# ---------------------------------------------------------------------------
# program-structure prims
# ---------------------------------------------------------------------------


def _return_meta(*args):
    return None


python_return = make_prim(PrimIDs.RETURN, "python_return", _return_meta, tags=(OpTags.DONT_DCE,))


def _comment_meta(s):
    return None


comment = make_prim(PrimIDs.COMMENT, "comment", _comment_meta, tags=(OpTags.DONT_DCE,))


def _del_meta(*args):
    return None


python_del = make_prim(PrimIDs.DEL, "python_del", _del_meta, tags=(OpTags.DONT_DCE,))


def _print_meta(s):
    return None


python_print = make_prim(
    PrimIDs.PRINT, "python_print", _print_meta, tags=(OpTags.DONT_DCE, OpTags.DONT_FUSE), python_impl=print
)


def _unpack_trivial_meta(x, name=None):
    return x


unpack_trivial = make_prim(PrimIDs.UNPACK_TRIVIAL, "unpack_trivial", _unpack_trivial_meta, tags=(OpTags.DONT_DCE,))


# prologue checks — python_impl runs directly (no executor needed), mirroring
# the reference where the prologue executes under pythonex
def _check_tensor_meta(t, shape, dtype, device_str):
    return None


def _check_tensor_impl(t, shape, dtype, device_str):
    tshape = tuple(t.shape)
    if tshape != tuple(shape):
        raise AssertionError(f"prologue: expected shape {shape}, got {tshape}")
    if dtypes.to_dtype(t.dtype) != dtype:
        raise AssertionError(f"prologue: expected dtype {dtype}, got {t.dtype}")
    return None


check_tensor_shape_and_metadata = make_prim(
    PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA,
    "check_tensor_shape_and_metadata",
    _check_tensor_meta,
    tags=(OpTags.DONT_DCE,),
    python_impl=_check_tensor_impl,
)


def _check_number_meta(n, python_type, value):
    return None


def _check_number_impl(n, python_type, value):
    if not isinstance(n, python_type) or (value is not None and n != value):
        raise AssertionError(f"prologue: expected {python_type.__name__} == {value}, got {n!r}")
    return None


check_number_type_and_value = make_prim(
    PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
    "check_number_type_and_value",
    _check_number_meta,
    tags=(OpTags.DONT_DCE,),
    python_impl=_check_number_impl,
)


# prologue unpacks (reference UNPACK_* prims). The output proxy is created by
# the prologue construction (which holds the concrete captured value at trace time)
# and attached via Symbol.bind(..., output=proxy); python_impls do the real
# extraction at call time.
def _unpack_out_meta(*args):
    return None


def _unpack_global_impl(fn, name):
    return fn.__globals__[name]


def _unpack_closure_impl(fn, name):
    for nm, cell in zip(fn.__code__.co_freevars, fn.__closure__ or ()):
        if nm == name:
            return cell.cell_contents
    raise AssertionError(f"prologue: no closure cell named '{name}'")


def _unpack_attr_impl(obj, name):
    return getattr(obj, name)


def _unpack_item_impl(obj, key):
    return obj[key]


unpack_global = make_prim(PrimIDs.UNPACK_GLOBAL, "unpack_global", _unpack_out_meta,
                          tags=(OpTags.DONT_DCE,), python_impl=_unpack_global_impl)
unpack_closure = make_prim(PrimIDs.UNPACK_CLOSURE, "unpack_closure", _unpack_out_meta,
                           tags=(OpTags.DONT_DCE,), python_impl=_unpack_closure_impl)
unpack_attr = make_prim(PrimIDs.UNPACK_ATTR, "unpack_attr", _unpack_out_meta,
                        tags=(OpTags.DONT_DCE,), python_impl=_unpack_attr_impl)
unpack_item = make_prim(PrimIDs.UNPACK_ITEM, "unpack_item", _unpack_out_meta,
                        tags=(OpTags.DONT_DCE,), python_impl=_unpack_item_impl)


def _unpack_tensor_data_impl(x):
    # Parameter/buffer wrappers -> raw tensor (identity for plain tensors)
    data = getattr(x, "data", None)
    return data if data is not None and hasattr(x, "requires_grad") else x


unpack_tensor_data = make_prim(PrimIDs.UNPACK_TENSOR_DATA, "unpack_tensor_data",
                               _unpack_out_meta, tags=(OpTags.DONT_DCE,),
                               python_impl=_unpack_tensor_data_impl)


# ---------------------------------------------------------------------------
# dtype / device movement
# ---------------------------------------------------------------------------


def _convert_element_type_meta(a, dtype):
    dtype = dtypes.to_dtype(dtype)
    if isinstance(a, TensorProxy):
        return TensorProxy(shape=a.shape, dtype=dtype, device=a.device)
    # number
    return NumberProxy(dtypes.dtype_to_numbertype(dtype)(pyval(a)), dtypes.dtype_to_numbertype(dtype))


convert_element_type = make_prim(PrimIDs.CONVERT_ELEMENT_TYPE, "convert_element_type", _convert_element_type_meta)


def _device_put_meta(a, device):
    device = to_device(device)
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=device)


device_put = make_prim(PrimIDs.DEVICE_PUT, "device_put", _device_put_meta)


def _stop_gradient_meta(a):
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


stop_gradient = make_prim(PrimIDs.STOP_GRADIENT, "stop_gradient", _stop_gradient_meta)


def _bitcast_meta(a, dtype):
    dtype = dtypes.to_dtype(dtype)
    check(dtype.bytes == a.dtype.bytes, lambda: f"bitcast requires same-width dtypes, {a.dtype} -> {dtype}")
    return TensorProxy(shape=a.shape, dtype=dtype, device=a.device)


bitcast = make_prim(PrimIDs.BITCAST, "bitcast", _bitcast_meta)


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------


def _tensor_constant_meta(array):
    return TensorProxy(shape=tuple(array.shape), dtype=dtypes.to_dtype(array.dtype),
                       device=to_device(array.device))


tensor_constant = make_prim(PrimIDs.TENSOR_CONSTANT, "tensor_constant", _tensor_constant_meta)


def _full_meta(shape, fill_value, *, device=None, dtype=None):
    from .proxies import pytype

    # pytype, not pyval: a symbolic NumberProxy fill stays a runtime input
    dtype = dtypes.to_dtype(dtype) if dtype is not None else dtypes.to_dtype(pytype(fill_value))
    device = to_device(device) if device is not None else None
    return TensorProxy(shape=tuple(shape), dtype=dtype, device=device)


def _record_device(bsym) -> None:
    # a factory called without a device ran on the trace's device (the
    # output proxy's); record it so the executor allocates there
    if bsym.kwargs.get("device") is None:
        bsym.kwargs["device"] = bsym.output.device


full = make_prim(PrimIDs.FULL, "full", _full_meta, _bind_postprocess=_record_device)


def _iota_meta(length, *, start=0, step=1, device=None, dtype=None):
    dtype = dtypes.to_dtype(dtype) if dtype is not None else dtypes.int64
    device = to_device(device) if device is not None else None
    return TensorProxy(shape=(int(pyval(length)),), dtype=dtype, device=device)


iota = make_prim(PrimIDs.IOTA, "iota", _iota_meta, _bind_postprocess=_record_device)


def _uniform_meta(shape, minval, maxval, *, key, device=None, dtype=None):
    dtype = dtypes.to_dtype(dtype) if dtype is not None else dtypes.float32
    return TensorProxy(shape=tuple(shape), dtype=dtype, device=key.device if device is None else to_device(device))


uniform = make_prim(PrimIDs.UNIFORM, "uniform", _uniform_meta, tags=(OpTags.RANDOM_OP,))


def _normal_meta(shape, mean, std, *, key, device=None, dtype=None):
    dtype = dtypes.to_dtype(dtype) if dtype is not None else dtypes.float32
    return TensorProxy(shape=tuple(shape), dtype=dtype, device=key.device if device is None else to_device(device))


normal = make_prim(PrimIDs.NORMAL, "normal", _normal_meta, tags=(OpTags.RANDOM_OP,))


def _randint_meta(shape, low, high, *, key, device=None, dtype=None):
    dtype = dtypes.to_dtype(dtype) if dtype is not None else dtypes.int32
    return TensorProxy(shape=tuple(shape), dtype=dtype, device=key.device if device is None else to_device(device))


randint = make_prim(PrimIDs.RANDINT, "randint", _randint_meta, tags=(OpTags.RANDOM_OP,))


def _rng_split_meta(key):
    new_key = TensorProxy(shape=key.shape, dtype=key.dtype, device=key.device)
    subkey = TensorProxy(shape=key.shape, dtype=key.dtype, device=key.device)
    return new_key, subkey


rng_split = make_prim(PrimIDs.RNG_SPLIT, "rng_split", _rng_split_meta, tags=(OpTags.RANDOM_OP,))


# ---------------------------------------------------------------------------
# shape ops
# ---------------------------------------------------------------------------


def _reshape_meta(a, shape):
    shape = tuple(int(pyval(s)) for s in shape)
    n = 1
    for s in shape:
        n *= s
    check(n == a.numel, lambda: f"reshape {a.shape} -> {shape}: element count mismatch")
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


reshape = make_prim(PrimIDs.RESHAPE, "reshape", _reshape_meta, tags=(OpTags.SHAPE_OP,))


def _transpose_meta(a, permutation):
    permutation = tuple(canonicalize_dims(a.ndim, tuple(permutation)))
    check(sorted(permutation) == list(range(a.ndim)), lambda: f"invalid permutation {permutation}")
    shape = tuple(a.shape[i] for i in permutation)
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


transpose = make_prim(PrimIDs.TRANSPOSE, "transpose", _transpose_meta, tags=(OpTags.SHAPE_OP,))


def _broadcast_in_dim_meta(a, shape, broadcast_dimensions):
    shape = tuple(int(pyval(s)) for s in shape)
    bd = tuple(broadcast_dimensions)
    check(len(bd) == a.ndim, lambda: f"broadcast_in_dim dims {bd} must match input rank {a.ndim}")
    for i, d in enumerate(bd):
        check(a.shape[i] in (1, shape[d]), lambda: f"cannot broadcast {a.shape} to {shape} via {bd}")
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


broadcast_in_dim = make_prim(PrimIDs.BROADCAST_IN_DIM, "broadcast_in_dim", _broadcast_in_dim_meta, tags=(OpTags.SHAPE_OP,))


def _slice_meta(a, start_indices, limit_indices, strides=None):
    strides = strides or tuple(1 for _ in a.shape)
    shape = tuple(
        max(0, -(-(int(pyval(l)) - int(pyval(s))) // int(pyval(st))))
        for s, l, st in zip(start_indices, limit_indices, strides)
    )
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


slice_prim = make_prim(PrimIDs.SLICE, "slice_prim", _slice_meta, tags=(OpTags.SHAPE_OP,))


def _squeeze_meta(a, dims):
    dims = tuple(canonicalize_dims(a.ndim, tuple(dims)))
    for d in dims:
        check(a.shape[d] == 1, lambda: f"cannot squeeze dim {d} of shape {a.shape}")
    shape = tuple(s for i, s in enumerate(a.shape) if i not in dims)
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


squeeze = make_prim(PrimIDs.SQUEEZE, "squeeze", _squeeze_meta, tags=(OpTags.SHAPE_OP,))


def _cat_meta(tensors, dim):
    check(len(tensors) > 0, lambda: "cat of zero tensors")
    t0 = tensors[0]
    dim = canonicalize_dim(t0.ndim, pyval(dim))
    total = 0
    for t in tensors:
        check(t.ndim == t0.ndim, lambda: "cat rank mismatch")
        total += t.shape[dim]
    shape = tuple(total if i == dim else s for i, s in enumerate(t0.shape))
    return TensorProxy(shape=shape, dtype=t0.dtype, device=t0.device)


cat = make_prim(PrimIDs.CAT, "cat", _cat_meta, tags=(OpTags.SHAPE_OP,))


def _pad_meta(a, padding_value, padding_config):
    # padding_config: per-dim (lo, hi, interior) like jax.lax.pad
    shape = []
    for s, (lo, hi, interior) in zip(a.shape, padding_config):
        shape.append(int(pyval(lo)) + int(pyval(hi)) + s + max(0, s - 1) * int(pyval(interior)))
    return TensorProxy(shape=tuple(shape), dtype=a.dtype, device=a.device)


pad = make_prim(PrimIDs.PAD, "pad", _pad_meta, tags=(OpTags.SHAPE_OP,))


def _flip_meta(a, dims):
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


flip = make_prim(PrimIDs.FLIP, "flip", _flip_meta, tags=(OpTags.SHAPE_OP,))


def _take_meta(a, indices, dim):
    dim = canonicalize_dim(a.ndim, pyval(dim))
    shape = a.shape[:dim] + indices.shape + a.shape[dim + 1 :]
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


take = make_prim(PrimIDs.TAKE, "take", _take_meta)


def _take_along_axis_meta(a, indices, dim):
    dim = canonicalize_dim(a.ndim, pyval(dim))
    shape = tuple(indices.shape[i] if i == dim else s for i, s in enumerate(a.shape))
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


take_along_axis = make_prim(PrimIDs.TAKE_ALONG_AXIS, "take_along_axis", _take_along_axis_meta)


def _index_add_meta(a, indices, value, dim):
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


index_add = make_prim(PrimIDs.INDEX_ADD, "index_add", _index_add_meta)


def _scatter_add_meta(a, indices, value, dim):
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


scatter_add = make_prim(PrimIDs.SCATTER_ADD, "scatter_add", _scatter_add_meta)


def _dynamic_slice_meta(a, start_indices, slice_sizes):
    return TensorProxy(shape=tuple(int(pyval(s)) for s in slice_sizes), dtype=a.dtype, device=a.device)


dynamic_slice = make_prim(PrimIDs.DYNAMIC_SLICE, "dynamic_slice", _dynamic_slice_meta)


def _dynamic_update_slice_meta(a, update, start_indices):
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


dynamic_update_slice = make_prim(PrimIDs.DYNAMIC_UPDATE_SLICE, "dynamic_update_slice", _dynamic_update_slice_meta)


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------

_unary_same = [
    (PrimIDs.ABS, "abs"), (PrimIDs.NEG, "neg"), (PrimIDs.FLOOR, "floor"), (PrimIDs.CEIL, "ceil"),
    (PrimIDs.ROUND, "round"), (PrimIDs.TRUNC, "trunc"), (PrimIDs.SIGN, "sign"),
    (PrimIDs.BITWISE_NOT, "bitwise_not"),
]
_unary_float = [
    (PrimIDs.EXP, "exp"), (PrimIDs.EXP2, "exp2"), (PrimIDs.EXPM1, "expm1"), (PrimIDs.LOG, "log"),
    (PrimIDs.LOG1P, "log1p"), (PrimIDs.LOG2, "log2"), (PrimIDs.SQRT, "sqrt"), (PrimIDs.RSQRT, "rsqrt"),
    (PrimIDs.SIN, "sin"), (PrimIDs.COS, "cos"), (PrimIDs.TAN, "tan"), (PrimIDs.TANH, "tanh"),
    (PrimIDs.ASIN, "asin"), (PrimIDs.ACOS, "acos"), (PrimIDs.ATAN, "atan"), (PrimIDs.SINH, "sinh"),
    (PrimIDs.COSH, "cosh"), (PrimIDs.ASINH, "asinh"), (PrimIDs.ACOSH, "acosh"), (PrimIDs.ATANH, "atanh"),
    (PrimIDs.ERF, "erf"), (PrimIDs.ERFC, "erfc"), (PrimIDs.ERFINV, "erfinv"),
    (PrimIDs.RECIPROCAL, "reciprocal"),
    (PrimIDs.LOG10, "log10"), (PrimIDs.LGAMMA, "lgamma"), (PrimIDs.DIGAMMA, "digamma"),
]
_unary_bool = [
    (PrimIDs.ISFINITE, "isfinite"), (PrimIDs.ISNAN, "isnan"), (PrimIDs.ISINF, "isinf"),
    (PrimIDs.LOGICAL_NOT, "logical_not"), (PrimIDs.SIGNBIT, "signbit"),
]

_g = globals()
for pid, name in _unary_same:
    _g[name] = make_prim(pid, name, _elementwise_unary_meta, tags=(OpTags.ELEMENTWISE,))
for pid, name in _unary_float:
    _g[name] = make_prim(pid, name, _float_unary_meta, tags=(OpTags.ELEMENTWISE,))
for pid, name in _unary_bool:
    _g[name] = make_prim(pid, name, _bool_unary_meta, tags=(OpTags.ELEMENTWISE,))


def _real_meta(a):
    return TensorProxy(shape=a.shape, dtype=dtypes.corresponding_real_dtype(a.dtype), device=a.device)


real = make_prim(PrimIDs.REAL, "real", _real_meta, tags=(OpTags.ELEMENTWISE,))
imag = make_prim(PrimIDs.IMAG, "imag", _real_meta, tags=(OpTags.ELEMENTWISE,))


# ---------------------------------------------------------------------------
# elementwise binary / ternary
# ---------------------------------------------------------------------------

_binary_same = [
    (PrimIDs.ADD, "add"), (PrimIDs.SUB, "sub"), (PrimIDs.MUL, "mul"), (PrimIDs.DIV, "div"),
    (PrimIDs.POW, "pow"), (PrimIDs.FMOD, "fmod"), (PrimIDs.REMAINDER, "remainder"),
    (PrimIDs.MAXIMUM, "maximum"), (PrimIDs.MINIMUM, "minimum"), (PrimIDs.ATAN2, "atan2"),
    (PrimIDs.BITWISE_AND, "bitwise_and"), (PrimIDs.BITWISE_OR, "bitwise_or"),
    (PrimIDs.BITWISE_XOR, "bitwise_xor"), (PrimIDs.SHIFT_LEFT, "shift_left"),
    (PrimIDs.SHIFT_RIGHT, "shift_right"),
    (PrimIDs.NEXTAFTER, "nextafter"), (PrimIDs.COPYSIGN, "copysign"), (PrimIDs.HYPOT, "hypot"),
    (PrimIDs.GCD, "gcd"), (PrimIDs.LCM, "lcm"),
]
for pid, name in _binary_same:
    _g[name] = make_prim(pid, name, lambda a, b: _same_shape_meta(a, b), tags=(OpTags.ELEMENTWISE,))

_binary_cmp = [
    (PrimIDs.EQ, "eq"), (PrimIDs.NE, "ne"), (PrimIDs.LT, "lt"), (PrimIDs.LE, "le"),
    (PrimIDs.GT, "gt"), (PrimIDs.GE, "ge"),
]
for pid, name in _binary_cmp:
    _g[name] = make_prim(pid, name, _comparison_meta, tags=(OpTags.ELEMENTWISE,))


def _where_meta(pred, a, b):
    ts = _tensor_args((pred, a, b))
    shape = ts[0].shape
    dt = None
    for t in (a, b):
        if isinstance(t, TensorProxy):
            dt = t.dtype
            break
    if dt is None:
        dt = dtypes.to_dtype(type(pyval(a)))
    return TensorProxy(shape=shape, dtype=dt, device=ts[0].device)


where = make_prim(PrimIDs.WHERE, "where", _where_meta, tags=(OpTags.ELEMENTWISE,))


# ---------------------------------------------------------------------------
# reductions / scans
# ---------------------------------------------------------------------------


def _sum_meta(a, dims, *, output_dtype=None):
    return _reduction_meta(a, dims, output_dtype=dtypes.to_dtype(output_dtype) if output_dtype else a.dtype)


sum_prim = make_prim(PrimIDs.SUM, "sum", _sum_meta, tags=(OpTags.REDUCTION_OP,))
prod_prim = make_prim(PrimIDs.PROD, "prod", _sum_meta, tags=(OpTags.REDUCTION_OP,))


def _amax_meta(a, dims):
    return _reduction_meta(a, dims)


amax = make_prim(PrimIDs.AMAX, "amax", _amax_meta, tags=(OpTags.REDUCTION_OP,))


def _var_meta(a, dims, *, correction=1):
    out = _reduction_meta(a, dims)
    if out.dtype.is_complex:
        # variance of complex data is real (jnp.var semantics)
        real_dt = dtypes.float64 if out.dtype == dtypes.complex128 else dtypes.float32
        return TensorProxy(shape=out.shape, dtype=real_dt, device=out.device)
    if not out.dtype.is_inexact:
        return TensorProxy(shape=out.shape, dtype=dtypes.float32, device=out.device)
    return out


var_prim = make_prim(PrimIDs.VAR, "var", _var_meta, tags=(OpTags.REDUCTION_OP,))



amin = make_prim(PrimIDs.AMIN, "amin", _amax_meta, tags=(OpTags.REDUCTION_OP,))


def _argmax_meta(a, dim):
    if dim is None:
        return TensorProxy(shape=(), dtype=dtypes.int64, device=a.device)
    return _reduction_meta(a, (pyval(dim),), output_dtype=dtypes.int64)


argmax = make_prim(PrimIDs.ARGMAX, "argmax", _argmax_meta, tags=(OpTags.REDUCTION_OP,))
argmin = make_prim(PrimIDs.ARGMIN, "argmin", _argmax_meta, tags=(OpTags.REDUCTION_OP,))


def _any_meta(a, dims):
    return _reduction_meta(a, dims, output_dtype=dtypes.bool8)


any_prim = make_prim(PrimIDs.ANY, "any", _any_meta, tags=(OpTags.REDUCTION_OP,))


def _cumsum_meta(a, dim):
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


cumsum = make_prim(PrimIDs.CUMSUM, "cumsum", _cumsum_meta)
cumprod = make_prim(PrimIDs.CUMPROD, "cumprod", _cumsum_meta)


def _cummax_meta(a, dim):
    values = TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)
    indices = TensorProxy(shape=a.shape, dtype=dtypes.int32, device=a.device)
    return values, indices


cummax = make_prim(PrimIDs.CUMMAX, "cummax", _cummax_meta)


def _reduce_window_meta(a, window_dims, strides, padding, *, op="max"):
    """Pooling workhorse (thunder_tpu's reduce_window prim).
    padding: per-dim (lo, hi) pairs."""
    check(op in ("max", "sum", "min"), lambda: f"reduce_window op {op}")
    shape = []
    for s, w, st, (lo, hi) in zip(a.shape, window_dims, strides, padding):
        shape.append((s + int(pyval(lo)) + int(pyval(hi)) - int(pyval(w))) // int(pyval(st)) + 1)
    return TensorProxy(shape=tuple(shape), dtype=a.dtype, device=a.device)


reduce_window = make_prim(PrimIDs.REDUCE_WINDOW, "reduce_window", _reduce_window_meta, tags=(OpTags.REDUCTION_OP,))


def _topk_meta(a, k, dim):
    dim = canonicalize_dim(a.ndim, pyval(dim))
    k = int(pyval(k))
    shape = tuple(k if i == dim else s for i, s in enumerate(a.shape))
    values = TensorProxy(shape=shape, dtype=a.dtype, device=a.device)
    indices = TensorProxy(shape=shape, dtype=dtypes.int32, device=a.device)
    return values, indices


topk = make_prim(PrimIDs.TOPK, "topk", _topk_meta)


def _argsort_meta(a, dim, descending=False):
    return TensorProxy(shape=a.shape, dtype=dtypes.int32, device=a.device)


argsort = make_prim(PrimIDs.ARGSORT, "argsort", _argsort_meta)


def _sort_meta(a, dim, descending=False):
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


sort = make_prim(PrimIDs.SORT, "sort", _sort_meta)


# ---------------------------------------------------------------------------
# linear algebra / NN prims — MXU targets
# ---------------------------------------------------------------------------


def _matmul_meta(a, b):
    # torch.matmul semantics with batching
    check(a.ndim > 0 and b.ndim > 0, lambda: "matmul on 0-d tensor")
    if a.ndim == 1 and b.ndim == 1:
        check(a.shape[0] == b.shape[0], lambda: f"matmul: {a.shape} @ {b.shape}")
        return TensorProxy(shape=(), dtype=a.dtype, device=a.device)
    if a.ndim == 1:
        check(a.shape[0] == b.shape[-2], lambda: f"matmul: {a.shape} @ {b.shape}")
        return TensorProxy(shape=b.shape[:-2] + (b.shape[-1],), dtype=a.dtype, device=a.device)
    if b.ndim == 1:
        check(a.shape[-1] == b.shape[0], lambda: f"matmul: {a.shape} @ {b.shape}")
        return TensorProxy(shape=a.shape[:-1], dtype=a.dtype, device=a.device)
    check(a.shape[-1] == b.shape[-2], lambda: f"matmul: {a.shape} @ {b.shape}")
    batch = _broadcast_shapes(a.shape[:-2], b.shape[:-2])
    shape = batch + (a.shape[-2], b.shape[-1])
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


def _broadcast_shapes(s1, s2):
    out = []
    for i in range(max(len(s1), len(s2))):
        d1 = s1[len(s1) - 1 - i] if i < len(s1) else 1
        d2 = s2[len(s2) - 1 - i] if i < len(s2) else 1
        check(d1 == d2 or d1 == 1 or d2 == 1, lambda: f"cannot broadcast {s1} with {s2}")
        out.append(max(d1, d2))
    return tuple(reversed(out))


matmul = make_prim(PrimIDs.MATMUL, "matmul", _matmul_meta, tags=(OpTags.MATMUL_OP,))


def _linear_meta(a, w, bias=None):
    check(a.shape[-1] == w.shape[-1], lambda: f"linear: {a.shape} x {w.shape} (w is (out,in))")
    shape = a.shape[:-1] + (w.shape[0],)
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


linear = make_prim(PrimIDs.LINEAR, "linear", _linear_meta, tags=(OpTags.MATMUL_OP,))


def _convolution_meta(a, weight, bias, stride, padding, dilation, groups):
    # a: (N, Cin, *spatial), weight: (Cout, Cin/groups, *kernel) — torch layout
    check(a.shape[1] == weight.shape[1] * groups,
          lambda: f"convolution: input channels {a.shape[1]} != weight in-channels "
                  f"{weight.shape[1]} * groups {groups}")
    n_spatial = a.ndim - 2
    stride = tuple(pyval(s) for s in stride)
    padding = tuple(pyval(p) for p in padding)
    dilation = tuple(pyval(d) for d in dilation)
    out_spatial = []
    for i in range(n_spatial):
        k_eff = (weight.shape[2 + i] - 1) * dilation[i] + 1
        out_spatial.append((a.shape[2 + i] + 2 * padding[i] - k_eff) // stride[i] + 1)
    shape = (a.shape[0], weight.shape[0], *out_spatial)
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


convolution = make_prim(PrimIDs.CONVOLUTION, "convolution", _convolution_meta, tags=(OpTags.MATMUL_OP,))


def _conv_transpose_meta(a, weight, bias, stride, padding, output_padding, dilation, groups):
    # a: (N, Cin, *spatial), weight: (Cin, Cout/groups, *kernel) — torch layout
    n_spatial = a.ndim - 2
    stride = tuple(pyval(s) for s in stride)
    padding = tuple(pyval(p) for p in padding)
    output_padding = tuple(pyval(p) for p in output_padding)
    dilation = tuple(pyval(d) for d in dilation)
    out_spatial = []
    for i in range(n_spatial):
        k_eff = (weight.shape[2 + i] - 1) * dilation[i] + 1
        out_spatial.append((a.shape[2 + i] - 1) * stride[i] - 2 * padding[i] + k_eff + output_padding[i])
    shape = (a.shape[0], weight.shape[1] * groups, *out_spatial)
    return TensorProxy(shape=shape, dtype=a.dtype, device=a.device)


conv_transpose = make_prim(PrimIDs.CONV_TRANSPOSE, "conv_transpose", _conv_transpose_meta, tags=(OpTags.MATMUL_OP,))


def _embedding_meta(indices, weight):
    shape = indices.shape + (weight.shape[1],)
    return TensorProxy(shape=shape, dtype=weight.dtype, device=weight.device)


embedding = make_prim(PrimIDs.EMBEDDING, "embedding", _embedding_meta)


def _grouped_mm_meta(a, b, group_sizes):
    """Ragged/grouped matmul for MoE: a (M, K), b (G, K, N), group_sizes (G,) -> (M, N)."""
    check(a.ndim == 2 and b.ndim == 3, lambda: f"grouped_mm: {a.shape} @ {b.shape}")
    return TensorProxy(shape=(a.shape[0], b.shape[2]), dtype=a.dtype, device=a.device)


grouped_mm = make_prim(PrimIDs.GROUPED_MM, "grouped_mm", _grouped_mm_meta, tags=(OpTags.MATMUL_OP,))


def _einsum_meta(spec, *operands):
    from .einsum_utils import output_shape

    spec = pyval(spec)
    shape = output_shape(spec, [op.shape for op in operands])
    return TensorProxy(shape=shape, dtype=operands[0].dtype, device=operands[0].device)


einsum = make_prim(PrimIDs.EINSUM, "einsum", _einsum_meta, tags=(OpTags.MATMUL_OP,))


def _scatter_meta(a, indices, value, dim):
    """put_along_axis-style scatter (torch.scatter with src tensor)."""
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


scatter = make_prim(PrimIDs.SCATTER, "scatter", _scatter_meta)


# ---------------------------------------------------------------------------
# memory / interop
# ---------------------------------------------------------------------------


def _item_meta(a):
    check(a.numel == 1, lambda: f"item() on tensor of shape {a.shape}")
    return NumberProxy(None, dtypes.dtype_to_numbertype(a.dtype))


item = make_prim(PrimIDs.ITEM, "item", _item_meta, tags=(OpTags.DEVICE_SYNC_OP, OpTags.DONT_FUSE))


def _copy_with_setitem_meta(a, key, value):
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


copy_with_setitem = make_prim(PrimIDs.COPY_WITH_SETITEM, "copy_with_setitem", _copy_with_setitem_meta)


def _update_aliases_meta(tensors):
    return tuple(TensorProxy(shape=t.shape, dtype=t.dtype, device=t.device) for t in tensors)


update_aliases = make_prim(PrimIDs.UPDATE_ALIASES, "update_aliases", _update_aliases_meta)


# autodiff glue (used transiently by the grad transform, reference prims.py:1847)
def _get_grad_meta(a):
    return TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device)


get_grad = make_prim(PrimIDs.GET_GRAD, "get_grad", _get_grad_meta)


def _put_grad_meta(a, grad):
    return None


put_grad = make_prim(PrimIDs.PUT_GRAD, "put_grad", _put_grad_meta, tags=(OpTags.DONT_DCE,))
