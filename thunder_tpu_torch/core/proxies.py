"""Proxies: abstract values recorded into traces.

The proxy zoo of thunder_tpu/core/proxies.py — TensorProxy
(shape/dtype/device/requires_grad), NumberProxy, CollectionProxy — with
torch tensors as the runtime values. The distributed annotations
(DistParallelType, sharding, FutureTensorProxy) wait for the port's
distributed slice.

Method/operator dispatch on TensorProxy resolves through a method registry the
op namespaces populate at import time (the reference routes this through
language contexts, thunder/core/langctxs.py:1-146).
"""
from __future__ import annotations

from numbers import Number
from typing import Any, Callable, Sequence

from . import dtypes, devices
from .baseutils import ProxyInterface, check


# ---------------------------------------------------------------------------
# method registry (populated by thunder_tpu_torch.ops at import time)
# ---------------------------------------------------------------------------

_tensor_methods: dict[str, Callable] = {}


def register_method(name: str, fn: Callable) -> None:
    _tensor_methods[name] = fn


def get_method(name: str) -> Callable:
    fn = _tensor_methods.get(name)
    if fn is None:
        raise AttributeError(
            f"TensorProxy method '{name}' is not registered; import thunder_tpu_torch.ops first"
        )
    return fn


# ---------------------------------------------------------------------------


def _make_name(prefix: str, name: str | None) -> str:
    from .trace import get_tracectx

    trc = get_tracectx()
    if name is not None:
        if trc is not None:
            trc.add_name(name)
        return name
    if trc is not None:
        return trc.make_name(prefix)
    global _anon_counter
    _anon_counter += 1
    return f"{prefix}{_anon_counter}_anon"


_anon_counter = 0


class Proxy(ProxyInterface):
    _prefix = "p"

    def __init__(self, name: str | None = None):
        self.name = _make_name(self._prefix, name)

    def replace_name(self, name: str) -> "Proxy":
        import copy

        p = copy.copy(self)
        p.name = name
        return p

    def type_string(self) -> str:
        return "Any"

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"


class Variable:
    """Hashable identity wrapper for proxies (reference thunder/core/proxies.py:60 variableify)."""

    __slots__ = ("proxy",)

    def __init__(self, proxy: Proxy):
        self.proxy = proxy

    def __hash__(self) -> int:
        return hash(self.proxy.name)

    def __eq__(self, other) -> bool:
        return isinstance(other, Variable) and other.proxy.name == self.proxy.name

    def __repr__(self) -> str:
        return f"Var({self.proxy.name})"


def variableify(x):
    if isinstance(x, Proxy):
        return Variable(x)
    return x


def unvariableify(x):
    if isinstance(x, Variable):
        return x.proxy
    return x


class NumberProxy(Proxy):
    """A (possibly statically-known) python number in a trace.

    NumberProxies are compile-time constants: a value that changes per call
    (a position) enters a program as a 0-d tensor instead.
    """

    _prefix = "n"

    def __init__(self, value: Number | None, python_type: type = None, name: str | None = None):
        super().__init__(name)
        self.value = value
        self.python_type = python_type or (type(value) if value is not None else float)
        # symbolic numbers are runtime trace inputs: generated code references
        # them by name instead of baking the trace-time value
        self.is_symbolic = False

    @property
    def is_static(self) -> bool:
        return self.value is not None

    def type_string(self) -> str:
        return f"{self.python_type.__name__} {self.value}"

    def _observed(self):
        return self.value

    # numbers behave statically in traces
    def __bool__(self):
        check(self.value is not None, lambda: "cannot branch on a dynamic NumberProxy")
        return bool(self._observed())

    def __int__(self):
        return int(self._observed())

    def __float__(self):
        return float(self._observed())

    def __index__(self):
        return int(self._observed())

    def _num_binop(self, other, op, rop=False):
        ov = other._observed() if isinstance(other, NumberProxy) else other
        if self.value is None or ov is None:
            raise NotImplementedError("symbolic number arithmetic not yet supported")
        sv = self._observed()
        return op(ov, sv) if rop else op(sv, ov)

    def __add__(self, o):
        return self._num_binop(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._num_binop(o, lambda a, b: a + b, rop=True)

    def __sub__(self, o):
        return self._num_binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._num_binop(o, lambda a, b: a - b, rop=True)

    def __mul__(self, o):
        return self._num_binop(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._num_binop(o, lambda a, b: a * b, rop=True)

    def __truediv__(self, o):
        return self._num_binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._num_binop(o, lambda a, b: a / b, rop=True)

    def __floordiv__(self, o):
        return self._num_binop(o, lambda a, b: a // b)

    def __mod__(self, o):
        return self._num_binop(o, lambda a, b: a % b)

    def __neg__(self):
        return -self.value

    def __eq__(self, o):
        return self.value == (o.value if isinstance(o, NumberProxy) else o)

    def __ne__(self, o):
        return not self.__eq__(o)

    def __lt__(self, o):
        return self._num_binop(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._num_binop(o, lambda a, b: a <= b)

    def __gt__(self, o):
        return self._num_binop(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._num_binop(o, lambda a, b: a >= b)

    def __hash__(self):
        return hash(self.name)


def pyval(x):
    """Static python value of a number-or-NumberProxy."""
    if isinstance(x, NumberProxy):
        return x.value
    return x


def pytype(x) -> type:
    """Python type of a number-or-NumberProxy WITHOUT pinning it."""
    if isinstance(x, NumberProxy):
        return x.python_type
    return type(x)



class StringProxy(Proxy):
    _prefix = "s"

    def __init__(self, value: str, name: str | None = None):
        super().__init__(name)
        self.value = value


class CollectionProxy(Proxy):
    """Names a static python collection inside a trace (reference proxies.py CollectionProxy)."""

    _prefix = "C"

    def __init__(self, coll, name: str | None = None):
        super().__init__(name)
        self.coll = coll


class AnyProxy(Proxy):
    _prefix = "a"

    def __init__(self, value: Any = None, name: str | None = None):
        super().__init__(name)
        self.value = value


class TensorProxy(Proxy):
    """The core abstract tensor: shape / dtype / device / requires_grad.
    A proxy made without a device takes its trace's device (the device of
    the program's tensor inputs)."""

    _prefix = "t"

    def __init__(
        self,
        name: str | None = None,
        *,
        shape: Sequence[int],
        dtype: dtypes.dtype,
        device: devices.Device | None = None,
        requires_grad: bool = False,
        tags: frozenset = frozenset(),
    ):
        super().__init__(name)
        self.shape = tuple(int(pyval(s)) for s in shape)
        self.dtype = dtypes.to_dtype(dtype)
        self.device = device if device is not None else trace_device()
        self.requires_grad = requires_grad
        self.tags = tags

    # --- metadata ---
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def size(self, dim: int | None = None):
        if dim is None:
            return self.shape
        return self.shape[dim]

    def dim(self) -> int:
        return self.ndim

    def numel_(self) -> int:
        return self.numel

    def type_string(self) -> str:
        return f'{self.device} {self.dtype.shortname}{list(self.shape)}'

    def replace(self, **changes) -> "TensorProxy":
        kwargs = dict(
            shape=self.shape,
            dtype=self.dtype,
            device=self.device,
            requires_grad=self.requires_grad,
            tags=self.tags,
        )
        name = changes.pop("name", None)
        kwargs.update(changes)
        return TensorProxy(name, **kwargs)

    def __repr__(self) -> str:
        return f'<TensorProxy {self.name}: {self.type_string()}>'

    # --- operator overloads dispatch through the method registry ---
    def __add__(self, o):
        return get_method("add")(self, o)

    def __radd__(self, o):
        return get_method("add")(o, self)

    def __sub__(self, o):
        return get_method("sub")(self, o)

    def __rsub__(self, o):
        return get_method("sub")(o, self)

    def __mul__(self, o):
        return get_method("mul")(self, o)

    def __rmul__(self, o):
        return get_method("mul")(o, self)

    def __truediv__(self, o):
        return get_method("true_divide")(self, o)

    def __rtruediv__(self, o):
        return get_method("true_divide")(o, self)

    def __floordiv__(self, o):
        return get_method("floor_divide")(self, o)

    def __pow__(self, o):
        return get_method("pow")(self, o)

    def __rpow__(self, o):
        return get_method("pow")(o, self)

    def __mod__(self, o):
        return get_method("remainder")(self, o)

    def __neg__(self):
        return get_method("neg")(self)

    def __abs__(self):
        return get_method("abs")(self)

    def __matmul__(self, o):
        return get_method("matmul")(self, o)

    def __rmatmul__(self, o):
        return get_method("matmul")(o, self)

    def __lt__(self, o):
        return get_method("lt")(self, o)

    def __le__(self, o):
        return get_method("le")(self, o)

    def __gt__(self, o):
        return get_method("gt")(self, o)

    def __ge__(self, o):
        return get_method("ge")(self, o)

    def __eq__(self, o):
        return get_method("eq")(self, o)

    def __ne__(self, o):
        return get_method("ne")(self, o)

    def __and__(self, o):
        return get_method("bitwise_and")(self, o)

    def __or__(self, o):
        return get_method("bitwise_or")(self, o)

    def __xor__(self, o):
        return get_method("bitwise_xor")(self, o)

    def __invert__(self):
        return get_method("bitwise_not")(self)

    def __getitem__(self, key):
        return get_method("getitem")(self, key)

    def __setitem__(self, key, value):
        raise TypeError(
            "in-place indexed assignment on a traced tensor is only supported "
            "under the bytecode-interpreter frontend "
            "(jit(..., interpretation='python interpreter'), which rewrites "
            "`x[k] = v` to a functional copy_with_setitem); in directly-traced "
            "code use `x = ltorch.scatter(...)` / `clang.getitem`-style "
            "functional updates instead")

    def __hash__(self):
        return hash(self.name)

    def __getattr__(self, name: str):
        # only called when normal lookup fails: resolve tensor methods
        if name.startswith("__"):
            raise AttributeError(name)
        try:
            method = get_method(name)
        except AttributeError:
            raise AttributeError(f"TensorProxy has no attribute/method '{name}'")
        import functools

        return functools.partial(method, self)

    @property
    def mT(self):
        return get_method("matrix_transpose")(self)

    @property
    def T(self):
        return get_method("t")(self)

    @property
    def real(self):
        return get_method("real")(self)


def proxy_from_torch(x, *, name: str | None = None, requires_grad: bool = False) -> Proxy:
    """Build a proxy describing a concrete runtime value (a torch tensor, a
    python number or a string)."""
    if isinstance(x, Proxy):
        return x
    if isinstance(x, (bool, int, float, complex)):
        return NumberProxy(x, type(x), name)
    if isinstance(x, str):
        return StringProxy(x, name)
    return TensorProxy(name, shape=tuple(x.shape), dtype=dtypes.to_dtype(x.dtype),
                       device=devices.to_device(x.device), requires_grad=requires_grad)


def trace_device() -> devices.Device:
    """The device of the trace being recorded (its tensor inputs' device),
    else the default device."""
    from .trace import get_tracectx

    trc = get_tracectx()
    dev = getattr(trc, "device", None)
    return dev if dev is not None else devices.default_device()
