"""Torch frontend: trace plain torch.nn.Modules into the port's traces.

thunder_tpu/interop/torch_frontend.py for the port. A module written in
PyTorch (``torch.nn.Linear``, ``F.scaled_dot_product_attention``, tensor
methods) is acquired without graph breaks by ``__torch_function__``
interception: its parameters, buffers and inputs are wrapped in data-less
torch tensor subclasses (``TraceTensor``) carrying TensorProxies, and every
torch operation on them dispatches into the port's ltorch symbols, which
record into the ambient trace. The acquired trace is the one a module
written in the port's ltorch gives: the executors claim its SDPA, RMSNorm
and cross-entropy whole (executors/cudaex.py), and it composes with
autodiff, autocast and CUDA-graph capture like any port program.

What differs from thunder_tpu:

* A ``TraceTensor`` answers ``device``, ``is_cuda`` and ``get_device()``
  with its proxy's device (thunder_tpu answers the CPU): code that makes
  tensors ``device=x.device`` or branches on ``x.device.type`` sees the card.
  A program runs on one device: an op that names another device, a concrete
  tensor on another device, or ``.cpu()`` of a card tensor raises.
* A concrete torch tensor met inside traced code (one the module holds as a
  plain attribute, or makes with ``torch.tensor``) becomes a trace constant:
  the program keeps that tensor and reads it on every call. Under CUDA-graph
  capture (``cuda_graphs=True``) the graph reads the tensor that existed at
  capture time, which is intended: a tensor the caller will change belongs
  in a buffer or an input.
* An op the table does not map runs as an auto op made on first use, under
  the id ``torch_eager.<module>.<name>`` (ops/auto_register.py): the torch
  function itself, on the program's device, inside the program; its
  gradient is ``torch.func.vjp``'s. It warns once per function. thunder_tpu
  runs such an op on the host through ``jax.pure_callback``; here there is
  no host round trip.
* ``CompiledTorchModule`` reads the module's live parameters and buffers on
  every call, as ``ThunderModule`` does, where thunder_tpu copies them once
  into jax arrays: an optimizer's in-place updates are seen by the next call.
  A buffer the forward writes in place is replayed onto the torch module's
  own ``_buffers`` after the call (nn/module.py:update_buffer's effect).

Sharp edges, as thunder_tpu's: data-dependent Python control flow on tensor
values raises at trace time; in-place RNG samplers and unmapped in-place
ops raise; training-mode dropout raises."""
from __future__ import annotations

import math
import warnings
from collections.abc import Mapping
from typing import Any, Callable

import torch

from ..core import dtypes as tt_dtypes
from ..core import prims
from ..core.devices import DeviceType, to_device
from ..core.proxies import TensorProxy
from ..core.trace import get_tracectx
from ..ops import clang, ltorch

F = torch.nn.functional


# ---------------------------------------------------------------------------
# the trace tensor
# ---------------------------------------------------------------------------


class TraceTensor(torch.Tensor):
    """Data-less torch.Tensor subclass carrying a TensorProxy, made on the
    proxy's device."""

    proxy: TensorProxy

    @staticmethod
    def __new__(cls, proxy: TensorProxy):
        t = torch.Tensor._make_wrapper_subclass(
            cls,
            tuple(proxy.shape),
            dtype=tt_dtypes.to_torch_dtype(proxy.dtype),
            device=_torch_device(proxy),
            requires_grad=False,
        )
        t.proxy = proxy
        return t

    def __repr__(self):
        return f"TraceTensor({self.proxy})"

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        return dispatch(func, args, kwargs)

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        # __torch_function__ intercepts everything above this level; reaching
        # dispatch means an op slipped through the mapping table
        raise NotImplementedError(
            f"torch frontend: aten-level op {func} reached dispatch — "
            f"add a __torch_function__ mapping for its public API"
        )


def _torch_device(p: TensorProxy) -> torch.device:
    """The proxy's device as torch names it (``cpu``, ``cuda:0``)."""
    if p.device.devicetype is DeviceType.CPU:
        return torch.device("cpu")
    return p.device.torch_device()


def _one_device(device, what: str) -> None:
    """Raise unless ``device`` is the program's (the trace's) device."""
    trc = get_tracectx()
    want = getattr(trc, "device", None)
    if device is None or want is None:
        return
    got = to_device(torch.device("cuda", device) if isinstance(device, int) else device)
    if got != want:
        raise NotImplementedError(
            f"torch frontend: {what} is on {got}, the program on {want}; a program runs on one device "
            f"(nothing is moved between devices on its own)")


def _unwrap(x):
    if isinstance(x, TraceTensor):
        return x.proxy
    if isinstance(x, torch.Tensor):
        # concrete torch tensor mixed into traced code -> trace constant
        _one_device(x.device, "a concrete tensor in traced code")
        return clang.constant(x.detach())
    if isinstance(x, torch.dtype):
        return tt_dtypes.to_dtype(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_unwrap(e) for e in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


def _wrap(x):
    if isinstance(x, TensorProxy):
        return TraceTensor(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_wrap(e) for e in x)
    if isinstance(x, dict):
        return {k: _wrap(v) for k, v in x.items()}
    return x


# ---------------------------------------------------------------------------
# dispatch table: torch callables -> the port's ops
# ---------------------------------------------------------------------------

_EXPLICIT: dict[Any, Callable] = {}


def _register(*funcs):
    def deco(impl):
        for f in funcs:
            _EXPLICIT[f] = impl
        return impl

    return deco


def _device_index(p) -> int:
    return p.device.index if p.device.devicetype is DeviceType.CUDA else -1


# --- metadata accessors handled inline (static Python values at trace time) ---
_PASSTHROUGH_META = {
    torch.Tensor.size: lambda p, dim=None: tuple(p.shape) if dim is None else p.shape[dim],
    torch.Tensor.dim: lambda p: p.ndim,
    torch.Tensor.numel: lambda p: p.numel,
    torch.Tensor.ndimension: lambda p: p.ndim,
    torch.Tensor.nelement: lambda p: p.numel,
    torch.Tensor.element_size: lambda p: p.dtype.bytes,
    torch.Tensor.dim_order: lambda p: tuple(range(p.ndim)),
    torch.Tensor.get_device: _device_index,
    torch.Tensor.is_signed: lambda p: p.dtype.is_signed,
    torch.Tensor.is_conj: lambda p: False,
    torch.Tensor.is_neg: lambda p: False,
    torch.Tensor.is_inference: lambda p: False,
    torch.Tensor.is_contiguous: lambda p, *a, **kw: True,
    torch.Tensor.is_pinned: lambda p: False,
    torch.Tensor.is_shared: lambda p: False,
    torch.Tensor.is_coalesced: lambda p: True,
    torch.Tensor.is_same_size: lambda p, other: tuple(p.shape) == tuple(
        getattr(other, "proxy", other).shape),
    torch.Tensor.retain_grad: lambda p: None,
    torch.is_distributed: lambda p: False,
    torch.Tensor.is_floating_point: lambda p: p.dtype.is_float,
    torch.is_floating_point: lambda p: p.dtype.is_float,
    torch.Tensor.is_complex: lambda p: p.dtype.is_complex,
    torch.is_complex: lambda p: p.dtype.is_complex,
}


@_register(torch.Tensor.cpu)
def _cpu(x, memory_format=None):
    # on the CPU a no-op; from the card a move the program cannot make
    _one_device(torch.device("cpu"), "Tensor.cpu()'s result")
    return x


@_register(torch.Tensor.to_dense)
def _placement_noop(x, *args, **kwargs):
    # functional backend: densification is a no-op on proxies
    return x


@_register(F.linear)
def _linear(x, w, b=None):
    return ltorch.linear(x, w, b)


@_register(F.embedding)
def _embedding(input, weight, padding_idx=None, max_norm=None, norm_type=2.0,
               scale_grad_by_freq=False, sparse=False):
    return ltorch.embedding(input, weight)


@_register(F.layer_norm)
def _layer_norm(input, normalized_shape, weight=None, bias=None, eps=1e-5):
    return ltorch.layer_norm(input, tuple(normalized_shape), weight, bias, eps)


@_register(F.rms_norm)
def _rms_norm(input, normalized_shape, weight=None, eps=None):
    return ltorch.rms_norm(input, tuple(normalized_shape), weight, 1e-6 if eps is None else eps)


@_register(F.scaled_dot_product_attention)
def _sdpa(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None, enable_gqa=False):
    # GQA head replication lives in ltorch.sdpa (gated on enable_gqa, matching
    # torch's semantics — mismatched head counts without the flag raise).
    return ltorch.sdpa(q, k, v, attn_mask, dropout_p, is_causal, scale, enable_gqa=enable_gqa)


@_register(F.cross_entropy)
def _cross_entropy(input, target, weight=None, size_average=None, ignore_index=-100,
                   reduce=None, reduction="mean", label_smoothing=0.0):
    return ltorch.cross_entropy(input, target, weight, ignore_index, reduction, label_smoothing)


@_register(F.gelu)
def _gelu(x, approximate="none"):
    return ltorch.gelu(x, approximate=approximate)


@_register(F.softmax, torch.softmax, torch.Tensor.softmax)
def _softmax(x, dim=None, _stacklevel=3, *, dtype=None):
    return ltorch.softmax(x, -1 if dim is None else dim, dtype=dtype)


@_register(F.log_softmax)
def _log_softmax(x, dim=None, _stacklevel=3, *, dtype=None):
    return ltorch.log_softmax(x, -1 if dim is None else dim, dtype=dtype)


@_register(F.dropout)
def _dropout(x, p=0.5, training=True, inplace=False):
    if not training or p == 0.0:
        return x
    raise NotImplementedError("training-mode dropout through the torch frontend needs rng plumbing")


@_register(F.mse_loss)
def _mse_loss(input, target, size_average=None, reduce=None, reduction="mean", weight=None):
    if weight is not None:
        raise NotImplementedError("mse_loss: weight is unsupported")
    return ltorch.mse_loss(input, target, reduction)


@_register(F.conv2d)
def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return ltorch.conv2d(input, weight, bias, stride, padding, dilation, groups)


@_register(F.silu)
def _silu(x, inplace=False):
    return ltorch.silu(x)


@_register(F.relu, torch.relu)
def _relu(x, inplace=False):
    return ltorch.relu(x)


@_register(F.pad)
def _pad(x, pad, mode="constant", value=None):
    return ltorch.pad(x, tuple(pad), mode, 0.0 if value is None else value)


@_register(torch.cat, torch.concat)
def _cat(tensors, dim=0):
    ts = list(tensors)
    # torch's legacy empty-cat: a 0-element rank-1 tensor (HF DynamicCache's
    # initial state) is dropped when concatenated with higher-rank tensors
    max_rank = max(getattr(t, "ndim", 0) for t in ts)
    ts = [t for t in ts
          if not (getattr(t, "ndim", 0) == 1 and math.prod(getattr(t, "shape", ())) == 0
                  and max_rank > 1)]
    if len(ts) == 1:
        return ts[0]
    return ltorch.cat(ts, dim)


@_register(torch.stack)
def _stack(tensors, dim=0):
    return ltorch.stack(list(tensors), dim)


@_register(torch.Tensor.view, torch.Tensor.reshape, torch.reshape)
def _reshape(x, *shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    return ltorch.reshape(x, shape)


@_register(torch.Tensor.expand)
def _expand(x, *shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    return ltorch.expand(x, shape)


@_register(torch.Tensor.permute, torch.permute)
def _permute(x, *dims):
    if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
        dims = tuple(dims[0])
    return ltorch.permute(x, dims)


@_register(torch.Tensor.transpose, torch.transpose)
def _transpose(x, dim0, dim1):
    return ltorch.transpose(x, dim0, dim1)


@_register(torch.Tensor.contiguous)
def _contiguous(x, **kw):
    return x


@_register(torch.Tensor.to)
def _to(x, *args, **kwargs):
    """Tensor.to: a dtype converts; a device must be the program's own."""
    dtype = kwargs.get("dtype")
    device = kwargs.get("device")
    for a in args:
        if isinstance(a, (torch.dtype, tt_dtypes.dtype)):
            dtype = a
        elif isinstance(a, (torch.device, str, int)):
            device = a
        elif isinstance(a, TensorProxy):
            dtype, device = a.dtype, a.device
    _one_device(device, "Tensor.to()'s target")
    if dtype is None:
        return x
    return ltorch.to(x, dtype if isinstance(dtype, tt_dtypes.dtype) else tt_dtypes.to_dtype(dtype))


@_register(torch.Tensor.float)
def _float(x):
    return ltorch.to(x, tt_dtypes.float32)


@_register(torch.Tensor.type_as)
def _type_as(x, other):
    return ltorch.type_as(x, other)


@_register(torch.Tensor.masked_fill, torch.Tensor.masked_fill_)
def _masked_fill(x, mask, value):
    return ltorch.masked_fill(x, mask, float(value) if isinstance(value, torch.Tensor) else value)


@_register(torch.Tensor.__getitem__)
def _getitem(x, key):
    return clang.getitem(x, key)


def _setitem_dispatch(args, kwargs):
    """y[key] = value — functionalized: the receiver's proxy is rebound to
    the updated tensor (boolean-mask and basic-index forms)."""
    receiver, key, value = args[0], args[1], args[2]
    if not isinstance(receiver, TraceTensor):
        raise NotImplementedError("setitem on a non-traced tensor inside a trace")
    rp = receiver.proxy
    ukey = _unwrap(key)
    uval = _unwrap(value)
    if isinstance(ukey, TensorProxy) and ukey.dtype.is_bool:
        if (isinstance(uval, TensorProxy) and uval.ndim >= 1
                and math.prod(uval.shape) == 1):
            # numel-1 tensors broadcast like scalars in torch (fill semantics)
            uval = ltorch.reshape(uval, ())
        if isinstance(uval, TensorProxy) and uval.ndim >= 1:
            # torch element placement: y[mask] = v with v a 1-D tensor of
            # mask.sum() elements assigned to the selected positions in
            # row-major order. Static-shape lowering: the k-th True position
            # reads v[(cumsum(mask)-1)[pos]]; False lanes keep y. A runtime
            # v-length mismatch (torch raises) cannot be checked at trace
            # time — indices are clamped into v instead.
            if uval.ndim != 1 or tuple(ukey.shape) != tuple(rp.shape):
                raise NotImplementedError(
                    "torch frontend: y[mask] = v supports a scalar v, a "
                    "broadcastable v, or a 1-D v with mask.shape == y.shape "
                    "(element placement); got mask shape "
                    f"{tuple(ukey.shape)}, value shape {tuple(uval.shape)} "
                    f"for receiver {tuple(rp.shape)}")
            if int(uval.shape[0]) == 0:
                # torch: y[mask] = empty v is a no-op iff mask selects nothing
                # (else it raises at runtime — unverifiable at trace time)
                out = rp
            else:
                flat_mask = ltorch.reshape(ukey, -1)
                pos = ltorch.sub(ltorch.cumsum(ltorch.to(flat_mask, tt_dtypes.int32), 0), 1)
                pos = ltorch.clamp(pos, 0, int(uval.shape[0]) - 1)
                gathered = ltorch.index_select(uval, 0, pos)
                flat = ltorch.where(flat_mask, gathered, ltorch.reshape(rp, -1))
                out = ltorch.reshape(flat, tuple(rp.shape))
        else:
            # masked fill: where(mask, value, y)
            out = ltorch.where(ukey, uval, rp)
        out = clang.maybe_convert_to_dtype(out, rp.dtype)
    else:
        out = prims.copy_with_setitem(rp, ukey, uval)
    return _rebind_inplace(receiver, out, "__setitem__")


def _factory_dtype(dtype):
    return tt_dtypes.to_dtype(dtype) if dtype is not None else None


@_register(torch.arange)
def _arange(*args, dtype=None, device=None, **kw):
    _one_device(device, "torch.arange's device")
    return ltorch.arange(*args, dtype=_factory_dtype(dtype))


@_register(torch.matmul, torch.Tensor.matmul, torch.bmm, torch.Tensor.bmm, torch.mm)
def _matmul(a, b):
    return ltorch.matmul(a, b)


@_register(torch.Tensor.split, torch.split)
def _split(x, split_size, dim=0):
    return ltorch.split(x, split_size, dim)


@_register(torch.Tensor.chunk, torch.chunk)
def _chunk(x, chunks, dim=0):
    return ltorch.chunk(x, chunks, dim)


@_register(torch.Tensor.mean, torch.mean)
def _mean(x, dim=None, keepdim=False, **kw):
    return ltorch.mean(x, dim, keepdim)


@_register(torch.Tensor.sum, torch.sum)
def _sum(x, dim=None, keepdim=False, **kw):
    return ltorch.sum(x, dim, keepdim)


@_register(torch.Tensor.unsqueeze, torch.unsqueeze)
def _unsqueeze(x, dim):
    return ltorch.unsqueeze(x, dim)


@_register(torch.Tensor.squeeze, torch.squeeze)
def _squeeze(x, dim=None):
    return ltorch.squeeze(x, dim)


@_register(torch.Tensor.flatten, torch.flatten)
def _flatten(x, start_dim=0, end_dim=-1):
    return ltorch.flatten(x, start_dim, end_dim)


@_register(torch.tril)
def _tril(x, diagonal=0):
    return ltorch.tril(x, diagonal)


@_register(torch.triu)
def _triu(x, diagonal=0):
    return ltorch.triu(x, diagonal)


@_register(torch.where)
def _where(cond, a, b):
    return ltorch.where(cond, a, b)


@_register(torch.outer)
def _outer(a, b):
    return ltorch.outer(a, b)


@_register(torch.topk)
def _topk(x, k, dim=-1, largest=True, sorted=True):
    if not largest:
        raise NotImplementedError("topk(largest=False)")
    return ltorch.topk(x, k, dim)


@_register(torch.addmm, torch.Tensor.addmm)
def _addmm(input, mat1, mat2, *, beta=1, alpha=1):
    return ltorch.addmm(input, mat1, mat2, beta=beta, alpha=alpha)


@_register(torch.baddbmm, torch.Tensor.baddbmm)
def _baddbmm(input, b1, b2, *, beta=1, alpha=1):
    return ltorch.baddbmm(input, b1, b2, beta=beta, alpha=alpha)


@_register(torch.full)
def _full(size, fill_value, *, dtype=None, device=None, **kw):
    _one_device(device, "torch.full's device")
    return ltorch.full(tuple(size), fill_value, dtype=_factory_dtype(dtype))


@_register(torch.ones)
def _ones(*size, dtype=None, device=None, **kw):
    _one_device(device, "torch.ones's device")
    if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
        size = tuple(size[0])
    return ltorch.ones(*size, dtype=_factory_dtype(dtype))


@_register(torch.zeros)
def _zeros(*size, dtype=None, device=None, **kw):
    _one_device(device, "torch.zeros's device")
    if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
        size = tuple(size[0])
    return ltorch.zeros(*size, dtype=_factory_dtype(dtype))


@_register(torch.ones_like)
def _ones_like(x, *, dtype=None, **kw):
    return ltorch.ones_like(x, dtype=_factory_dtype(dtype))


@_register(torch.zeros_like)
def _zeros_like(x, *, dtype=None, **kw):
    return ltorch.zeros_like(x, dtype=_factory_dtype(dtype))


@_register(torch.full_like)
def _full_like(x, fill_value, *, dtype=None, **kw):
    return ltorch.full_like(x, fill_value, dtype=_factory_dtype(dtype))


@_register(torch.Tensor.repeat)
def _repeat(x, *sizes):
    return ltorch.repeat(x, *sizes)


@_register(torch.Tensor.clone)
def _clone(x, **kw):
    return x


@_register(torch.Tensor.item)
def _item(x):
    raise NotImplementedError(
        "tensor.item() inside traced code is a sharp edge (host sync + "
        "data-dependent control flow); restructure the model or keep it out of the traced region"
    )


@_register(torch.tanh, torch.Tensor.tanh)
def _tanh(x):
    return ltorch.tanh(x)


@_register(torch.rsqrt, torch.Tensor.rsqrt)
def _rsqrt(x):
    return ltorch.rsqrt(x)


@_register(torch.sigmoid, torch.Tensor.sigmoid)
def _sigmoid(x):
    return ltorch.sigmoid(x)


@_register(torch.pow, torch.Tensor.pow)
def _pow(x, e):
    return ltorch.pow(x, e)


@_register(torch.einsum)
def _einsum(eq, *operands):
    # common contractions lowered to matmul forms
    if len(operands) == 1 and isinstance(operands[0], (tuple, list)):
        operands = tuple(operands[0])
    eq = eq.replace(" ", "")
    if eq == "i,j->ij":
        return ltorch.outer(*operands)
    if eq in ("bij,bjk->bik", "ij,jk->ik"):
        return ltorch.matmul(*operands)
    raise NotImplementedError(f"torch frontend einsum '{eq}' — add a lowering")


# generic fallbacks: binary/unary methods named the same in ltorch
_GENERIC_NAMES = {
    "add", "sub", "mul", "div", "true_divide", "pow", "neg", "abs", "exp", "log",
    "sqrt", "rsqrt", "sin", "cos", "tanh", "sigmoid", "erf", "floor", "ceil",
    "clamp", "clip", "maximum", "minimum", "eq", "ne", "lt", "le", "gt", "ge",
    "cumsum", "argmax", "argmin", "amax", "amin", "var", "std", "any", "all",
    "gather", "index_select", "roll", "flip", "detach", "sort", "argsort",
    "logical_and", "logical_or", "logical_not", "bitwise_and", "bitwise_or",
    "isnan", "isfinite", "t",
    "square", "log2", "log10", "log1p", "expm1", "exp2", "sign", "trunc",
    "round", "frac", "reciprocal", "asin", "acos", "atan", "sinh", "cosh",
    "asinh", "acosh", "atanh", "erfc", "erfinv", "lgamma", "digamma",
    "logaddexp", "logaddexp2", "hypot", "copysign", "fmod", "remainder",
    "atan2", "logsumexp", "cumprod", "cummax", "count_nonzero", "nansum",
    "nanmean", "nan_to_num", "norm", "narrow", "select", "unbind", "tile",
    "repeat_interleave", "diag", "ravel", "unflatten", "broadcast_to",
    "expand_as", "median", "aminmax", "movedim", "take_along_dim",
    "scatter", "scatter_add", "index_add", "clamp_min", "clamp_max",
    "bitwise_xor", "bitwise_not", "logical_xor", "xlogy", "heaviside",
    "prod", "isinf", "signbit", "kron",
    "tensordot", "dot", "mv", "vdot", "outer", "rsub",
    "soft_margin_loss", "hinge_embedding_loss", "triplet_margin_loss",
    "relu6", "softmin",
}

_DUNDER_MAP = {
    "__add__": ltorch.add, "__radd__": lambda a, b: ltorch.add(b, a),
    "__sub__": ltorch.sub, "__rsub__": lambda a, b: ltorch.sub(b, a),
    "__mul__": ltorch.mul, "__rmul__": lambda a, b: ltorch.mul(b, a),
    "__truediv__": ltorch.div, "__rtruediv__": lambda a, b: ltorch.div(b, a),
    "__pow__": ltorch.pow, "__neg__": ltorch.neg, "__matmul__": ltorch.matmul,
    "__lt__": ltorch.lt, "__le__": ltorch.le, "__gt__": ltorch.gt, "__ge__": ltorch.ge,
    "__eq__": ltorch.eq, "__ne__": ltorch.ne, "__and__": ltorch.bitwise_and,
    "__or__": ltorch.bitwise_or, "__invert__": ltorch.bitwise_not,
    "__mod__": ltorch.remainder,
}


@_register(F.conv1d)
def _conv1d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    return ltorch.conv1d(x, w, b, stride, padding, dilation, groups)


@_register(F.conv3d)
def _conv3d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    return ltorch.conv3d(x, w, b, stride, padding, dilation, groups)


@_register(F.conv_transpose2d)
def _conv_t2d(x, w, b=None, stride=1, padding=0, output_padding=0, groups=1, dilation=1):
    return ltorch.conv_transpose2d(x, w, b, stride, padding, output_padding, groups, dilation)


@_register(F.max_pool2d, torch.max_pool2d)
def _max_pool2d(x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                return_indices=False):
    if dilation not in (1, (1, 1)) or ceil_mode or return_indices:
        raise NotImplementedError("max_pool2d: dilation/ceil_mode/indices unsupported")
    return ltorch.max_pool2d(x, kernel_size, stride, padding)


@_register(F.avg_pool2d)
def _avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
                count_include_pad=True, divisor_override=None):
    if ceil_mode or divisor_override is not None:
        raise NotImplementedError("avg_pool2d: ceil_mode/divisor_override unsupported")
    return ltorch.avg_pool2d(x, kernel_size, stride, padding, count_include_pad)


@_register(F.adaptive_avg_pool2d)
def _adaptive_avg_pool2d(x, output_size):
    return ltorch.adaptive_avg_pool2d(x, output_size)


@_register(F.batch_norm)
def _batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
                momentum=0.1, eps=1e-5):
    return ltorch.batch_norm(x, running_mean, running_var, weight, bias, training, momentum, eps)


@_register(F.group_norm)
def _group_norm(x, num_groups, weight=None, bias=None, eps=1e-5):
    return ltorch.group_norm(x, num_groups, weight, bias, eps)


@_register(F.instance_norm)
def _instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                   use_input_stats=True, momentum=0.1, eps=1e-5):
    if not use_input_stats:
        raise NotImplementedError(
            "instance_norm with running stats (track_running_stats eval mode) "
            "is unsupported — ltorch.instance_norm always uses input statistics")
    return ltorch.instance_norm(x, running_mean, running_var, weight, bias,
                                use_input_stats, momentum, eps)


@_register(F.normalize)
def _normalize(x, p=2.0, dim=1, eps=1e-12, out=None):
    return ltorch.normalize(x, p, dim, eps)


@_register(F.unfold)
def _unfold_f(x, kernel_size, dilation=1, padding=0, stride=1):
    return ltorch.unfold(x, kernel_size, dilation, padding, stride)


@_register(F.fold)
def _fold_f(x, output_size, kernel_size, dilation=1, padding=0, stride=1):
    return ltorch.fold(x, output_size, kernel_size, dilation, padding, stride)


@_register(F.pixel_shuffle)
def _pixel_shuffle(x, upscale_factor):
    return ltorch.pixel_shuffle(x, upscale_factor)


@_register(F.interpolate)
def _interpolate(x, size=None, scale_factor=None, mode="nearest", align_corners=None,
                 recompute_scale_factor=None, antialias=False):
    if align_corners:
        raise NotImplementedError("interpolate: align_corners=True unsupported")
    if antialias:
        raise NotImplementedError("interpolate: antialias=True unsupported")
    return ltorch.interpolate(x, size, scale_factor, mode)


@_register(F.elu)
def _elu(x, alpha=1.0, inplace=False):
    return ltorch.elu(x, alpha)


@_register(F.leaky_relu)
def _leaky_relu(x, negative_slope=0.01, inplace=False):
    return ltorch.leaky_relu(x, negative_slope)


@_register(F.hardswish)
def _hardswish(x, inplace=False):
    return ltorch.hardswish(x)


@_register(F.hardsigmoid)
def _hardsigmoid(x, inplace=False):
    return ltorch.hardsigmoid(x)


@_register(F.hardtanh)
def _hardtanh(x, min_val=-1.0, max_val=1.0, inplace=False):
    return ltorch.hardtanh(x, min_val, max_val)


@_register(F.softplus)
def _softplus(x, beta=1.0, threshold=20.0):
    return ltorch.softplus(x, beta, threshold)


@_register(F.mish)
def _mish(x, inplace=False):
    return ltorch.mish(x)


@_register(F.l1_loss)
def _l1_loss(input, target, size_average=None, reduce=None, reduction="mean"):
    return ltorch.l1_loss(input, target, reduction)


@_register(F.smooth_l1_loss)
def _smooth_l1(input, target, size_average=None, reduce=None, reduction="mean", beta=1.0):
    return ltorch.smooth_l1_loss(input, target, reduction, beta)


@_register(F.huber_loss)
def _huber(input, target, reduction="mean", delta=1.0, weight=None):
    if weight is not None:
        raise NotImplementedError("huber_loss: weight is unsupported")
    return ltorch.huber_loss(input, target, reduction, delta)


@_register(F.binary_cross_entropy)
def _bce(input, target, weight=None, size_average=None, reduce=None, reduction="mean"):
    return ltorch.binary_cross_entropy(input, target, weight, reduction)


@_register(F.binary_cross_entropy_with_logits)
def _bce_logits(input, target, weight=None, size_average=None, reduce=None,
                reduction="mean", pos_weight=None):
    return ltorch.binary_cross_entropy_with_logits(input, target, weight, pos_weight, reduction)


@_register(F.kl_div)
def _kl_div(input, target, size_average=None, reduce=None, reduction="mean", log_target=False):
    return ltorch.kl_div(input, target, reduction, log_target)


@_register(F.nll_loss)
def _nll(input, target, weight=None, size_average=None, ignore_index=-100,
         reduce=None, reduction="mean"):
    return ltorch.nll_loss(input, target, weight, ignore_index, reduction)


@_register(F.cosine_similarity, torch.cosine_similarity)
def _cos_sim(x1, x2, dim=1, eps=1e-8):
    return ltorch.cosine_similarity(x1, x2, dim, eps)


_RNG_SAMPLERS = ("exponential", "uniform", "normal", "cauchy", "geometric", "log_normal", "random",
                 "bernoulli")


def dispatch(func, args, kwargs):
    if get_tracectx() is None:
        raise RuntimeError(
            "TraceTensor used outside a trace — torch-frontend modules must be "
            "called through thunder_tpu_torch.interop.torch_frontend.compile_torch_module"
        )
    name = getattr(func, "__name__", None)
    # tensor property access arrives as <descriptor>.__get__
    if name == "__get__":
        desc = getattr(func, "__self__", None)
        pname = getattr(desc, "__name__", None)
        t = args[0]
        p = t.proxy
        if pname == "shape":
            return torch.Size(p.shape)
        if pname == "dtype":
            return tt_dtypes.to_torch_dtype(p.dtype)
        if pname == "device":
            return _torch_device(p)
        if pname == "ndim":
            return p.ndim
        if pname == "is_cuda":
            return p.device.devicetype is DeviceType.CUDA
        if pname == "is_cpu":
            return p.device.devicetype is DeviceType.CPU
        if pname == "is_complex":
            return p.dtype.is_complex
        if pname in ("is_nested", "is_sparse", "is_quantized", "is_mps", "is_meta", "requires_grad"):
            return False
        if pname == "data":
            return t
        if pname == "grad":
            return None
        if pname == "mT":
            return _wrap(ltorch.matrix_transpose(p))
        if pname == "T":
            return _wrap(ltorch.t(p))
        if pname in ("real", "imag"):
            from ..ops.auto_register import get_auto_symbol

            if pname == "real" and not p.dtype.is_complex:
                return t
            return _wrap(get_auto_symbol(pname)(p))
        raise NotImplementedError(f"torch frontend: tensor property '{pname}' not mapped")
    # metadata accessors
    meta_fn = _PASSTHROUGH_META.get(func)
    if meta_fn is not None:
        uargs = _unwrap(args)
        return meta_fn(*uargs, **_unwrap(kwargs))

    if func is torch.Tensor.__setitem__:
        return _setitem_dispatch(args, kwargs)
    is_inplace = name.endswith("_") and not name.endswith("__")
    impl = _EXPLICIT.get(func)
    if impl is None and name in _DUNDER_MAP:
        impl = _DUNDER_MAP[name]
    if impl is None and name in _GENERIC_NAMES:
        impl = getattr(ltorch, name, None)
    if is_inplace and args and isinstance(args[0], TraceTensor):
        # in-place tensor method (x.add_(y), x.relu_(), x.masked_fill_(...)):
        # run the functional counterpart and REBIND the receiver's proxy.
        # Explicit registrations of the in-place name (e.g. masked_fill_)
        # resolve the impl but must go through the rebind too, or
        # statement-form calls drop the effect.
        base = name[:-1]
        if base in _RNG_SAMPLERS:
            # stateful-RNG samplers: the torch call carries no key, and the
            # key-accepting ltorch variants must not silently fix the seed
            raise NotImplementedError(
                f"in-place RNG sampler Tensor.{name}() draws from torch's "
                f"global generator; use the key-accepting ltorch.{base}(key=...) "
                f"or sample outside the compiled region")
        fimpl = (impl
                 or _EXPLICIT.get(getattr(torch, base, None))
                 or _EXPLICIT.get(getattr(torch.Tensor, base, None))
                 or getattr(ltorch, base, None))
        if fimpl is not None:
            receiver = args[0]
            out = fimpl(*_unwrap(args), **_unwrap(kwargs))
            if isinstance(out, TensorProxy):
                return _rebind_inplace(receiver, out, name)
    if impl is None:
        # auto-registered catalog (the fft/linalg/special long tail)
        impl = _auto_catalog_lookup(func, name)
    if impl is None:
        # no mapping: the torch op itself, as an opaque auto op
        impl = _eager_fallback_symbol(func, name)
    uargs = _unwrap(args)
    ukwargs = _unwrap(kwargs)
    out = impl(*uargs, **ukwargs)
    return _wrap(out)


def _rebind_inplace(receiver: "TraceTensor", out: TensorProxy, name: str) -> "TraceTensor":
    """Functionalized in-place: replace the receiver's proxy with the result.
    Shape/dtype must be preserved (torch rejects dtype-changing in-place ops).
    Module-buffer receivers additionally record a side effect ``(owner
    module, buffer name, value)``, which jit replays onto the module's
    ``_buffers`` after the call, so the mutation persists across calls."""
    if tuple(out.shape) != tuple(receiver.proxy.shape):
        raise NotImplementedError(f"in-place {name} would change the receiver's shape")
    if out.dtype != receiver.proxy.dtype:
        raise NotImplementedError(
            f"in-place {name} would change the receiver's dtype "
            f"({receiver.proxy.dtype.name} -> {out.dtype.name}); torch rejects this")
    owner = getattr(receiver, "_owner", None)
    if owner is not None:
        trc = get_tracectx()
        if trc is not None:
            trc.side_effects.append((owner[0], owner[1], out))
    receiver.proxy = out
    return receiver


# ---------------------------------------------------------------------------
# ops with no mapping: the auto catalog, then the torch op itself
# ---------------------------------------------------------------------------


def _auto_catalog_lookup(func, name: str):
    """Map a torch callable to an auto-registered symbol by qualified name
    (torch.fft.fft -> auto.fft_fft, torch.linalg.inv -> auto.linalg_inv,
    torch.special.* -> auto.special_*, plain torch.<name> -> auto.<name>).
    The catalog binds each name to one torch function; another function of
    that name (``F.<name>`` or ``Tensor.<name>`` beside ``torch.<name>``,
    whose arguments or results may differ) gets an auto op of its own, made
    on first use, so the program runs exactly what the module called."""
    from ..ops.auto_register import auto_function, get_auto_symbol, is_differentiable, register_auto_op

    mod = getattr(func, "__module__", "") or ""
    keys = [name]
    for fam in ("fft", "linalg", "special"):
        if mod.endswith(fam):
            keys.insert(0, f"{fam}_{name}")
    for key in keys:
        sym = get_auto_symbol(key)
        if sym is None:
            continue
        if auto_function(sym) is func:
            return sym
        twin = _catalog_twins.get(func)
        if twin is None:
            where = getattr(func, "__qualname__", name)
            twin = register_auto_op(key, func, differentiable=is_differentiable(sym),
                                    sym_id=f"auto.{key}[{mod or 'torch.Tensor'}.{where}]")
            _catalog_twins[func] = twin
        return twin
    return None


_catalog_twins: dict = {}
_eager_symbols: dict = {}
_eager_warned: set = set()


def _eager_fallback_symbol(func, name: str):
    """The auto op ``torch_eager.<module>.<name>`` running ``func`` itself
    (ops/auto_register.py:register_auto_op): made on first use, on the
    program's device, its gradient torch.func.vjp's. It warns once per
    function. An unmapped in-place op raises (a functional program would
    drop its mutation); so does ``out=`` (register_auto_op's meta), whose
    aliasing a program cannot honor."""
    sym = _eager_symbols.get(func)
    if sym is not None:
        return sym
    if name.endswith("_") and not name.endswith("__"):
        raise NotImplementedError(
            f"torch frontend: in-place op {name} has no mapping and cannot "
            f"run as an opaque torch op (the mutation would be lost); "
            f"register a functionalized lowering in torch_frontend.py")
    module = getattr(func, "__module__", None) or "?"
    if func not in _eager_warned:
        _eager_warned.add(func)
        warnings.warn(
            f"torch frontend: no mapping for {module}.{name}; running it as the opaque torch op "
            f"torch_eager.{module}.{name} on the program's device (consider registering a lowering)")
    from ..ops.auto_register import register_auto_op

    sym = register_auto_op(name, func, sym_id=f"torch_eager.{module}.{name}", module="torch_eager")
    _eager_symbols[func] = sym
    return sym


# ---------------------------------------------------------------------------
# module conversion
# ---------------------------------------------------------------------------


class TorchTracedModule:
    """Makes a torch.nn.Module traceable by the port: its forward runs under
    ``torch.func.functional_call`` with TraceTensor state, under
    __torch_function__ interception. The module is put in eval mode, as
    thunder_tpu's is; its train/eval flags key the compile cache, so a later
    ``.train()`` retraces."""

    def __init__(self, torch_module: torch.nn.Module):
        self.torch_module = torch_module.eval()

    def _owner(self, qualified: str):
        """(submodule, local name) of a qualified buffer name: where a write
        of that buffer lands."""
        mod_name, _, local = qualified.rpartition(".")
        return self.torch_module.get_submodule(mod_name), local

    def __call__(self, params: dict, args: tuple, kwargs: dict):
        def wrap_leaf(v):
            if isinstance(v, TensorProxy):
                _one_device(v.device.torch_device(), "an input")
                return TraceTensor(v)
            # containers recurse: KV caches arrive as tuples-of-tuples of
            # tensors; a raw TensorProxy leaking into torch code would
            # surface the port's dtypes where torch types are expected
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                return type(v)(*(wrap_leaf(e) for e in v))
            if isinstance(v, (tuple, list)):
                return type(v)(wrap_leaf(e) for e in v)
            if isinstance(v, dict):
                return {k: wrap_leaf(e) for k, e in v.items()}
            return v

        wrapped_state = {k: wrap_leaf(v) for k, v in params.items()}
        for k, _ in self.torch_module.named_buffers():
            t = wrapped_state.get(k)
            if isinstance(t, TraceTensor):
                t._owner = self._owner(k)  # in-place writes become side effects
        wargs = tuple(wrap_leaf(a) for a in args)
        wkwargs = {k: wrap_leaf(v) for k, v in kwargs.items()}
        out = torch.func.functional_call(self.torch_module, wrapped_state, wargs, wkwargs)
        return _unwrap_output(out)


def _unwrap_output(x):
    if isinstance(x, TraceTensor):
        return x.proxy
    if isinstance(x, (tuple, list)):
        return type(x)(_unwrap_output(e) for e in x)
    if isinstance(x, dict):
        return {k: _unwrap_output(v) for k, v in x.items()}
    return x


class CompiledTorchModule:
    """The port-compiled wrapper over a torch.nn.Module (the
    ``thunder.jit(torch_module)`` surface). Its program takes ``(state,
    args, kwargs)``: every parameter and buffer by qualified name, read live
    from the module on every call, then the call's arguments. The jit's
    keyword arguments (``transforms``, ``executors``, ``cuda_graphs``,
    ``graph_pool``) pass through."""

    def __init__(self, torch_module: torch.nn.Module, **jit_kwargs):
        from .. import jit as _jit

        self.traced = TorchTracedModule(torch_module)
        module = self.traced.torch_module

        def fn(params, args, kwargs):
            return self.traced(params, args, kwargs)

        fn.__name__ = f"torch_{type(torch_module).__name__}"
        # train/eval flags change the traced program without changing any
        # input, so they are part of the cache key
        fn.__cache_extra__ = lambda: tuple(m.training for m in module.modules())
        self._cfn = _jit(fn, **jit_kwargs)

    @property
    def torch_module(self) -> torch.nn.Module:
        return self.traced.torch_module

    @property
    def _cs(self):
        return self._cfn._cs

    @property
    def _cd(self):
        return self._cfn._cd

    def get_parameters(self) -> dict:
        return dict(self.torch_module.named_parameters())

    def get_buffers(self) -> dict:
        return dict(self.torch_module.named_buffers())

    def __call__(self, *args, **kwargs):
        args, kwargs = same_views((args, kwargs))
        return self._cfn({**self.get_parameters(), **self.get_buffers()}, args, kwargs)


def same_views(x):
    """x with identical views of one storage (same address, shape, strides
    and dtype) made one tensor object, so the jit cache's alias key sees one
    input for them (thunder_tpu/interop/torch_frontend.py:1190-1194); walks
    NamedTuples, lists, tuples and mappings."""
    seen: dict = {}

    def conv(v):
        if isinstance(v, torch.Tensor):
            return seen.setdefault((v.data_ptr(), tuple(v.shape), tuple(v.stride()), v.dtype, v.device), v)
        if isinstance(v, tuple) and hasattr(v, "_fields"):  # NamedTuple
            return type(v)(*(conv(e) for e in v))
        if isinstance(v, (tuple, list)):
            return type(v)(conv(e) for e in v)
        if isinstance(v, Mapping):
            items = {k: conv(e) for k, e in v.items()}
            try:
                return type(v)(items)
            except Exception:
                return items
        return v

    return conv(x)


def compile_torch_module(torch_module: torch.nn.Module, **jit_kwargs) -> CompiledTorchModule:
    """Trace and compile a torch.nn.Module through the frontend; it runs
    where its parameters are."""
    return CompiledTorchModule(torch_module, **jit_kwargs)
