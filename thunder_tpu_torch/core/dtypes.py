"""Framework-owned dtype lattice with PyTorch interop.

The same lattice as thunder_tpu's (names, widths, promotion), mapped onto
``torch`` dtypes instead of ``jax.numpy`` ones. The framework dtype is what
traces print and what proxies carry; ``to_torch_dtype`` is the one exit to
the runtime."""
from __future__ import annotations

from numbers import Number
from typing import Any

import numpy as np
import torch

__all__ = [
    "dtype",
    "bool8",
    "uint8",
    "int8",
    "int16",
    "int32",
    "int64",
    "bfloat16",
    "float16",
    "float32",
    "float64",
    "complex64",
    "complex128",
    "float8_e4m3",
    "float8_e5m2",
    "all_dtypes",
    "to_torch_dtype",
    "to_dtype",
    "is_float_dtype",
    "is_integer_dtype",
    "is_boolean_dtype",
    "is_complex_dtype",
    "is_inexact_dtype",
    "is_low_precision_dtype",
    "dtype_to_numbertype",
    "numbertype_to_dtype",
    "corresponding_real_dtype",
    "promote_dtypes",
    "float_math_dtype",
]


class dtype:
    """A framework dtype: name, byte width, and kind flags."""

    def __init__(self, name: str, shortname: str, bytes_: int, *, is_float=False, is_int=False,
                 is_bool=False, is_complex=False, is_signed=True):
        self._name = name
        self.shortname = shortname
        self.bytes = bytes_
        self.is_float = is_float
        self.is_int = is_int
        self.is_bool = is_bool
        self.is_complex = is_complex
        self.is_signed = is_signed

    @property
    def name(self) -> str:
        return self._name

    @property
    def is_inexact(self) -> bool:
        return self.is_float or self.is_complex

    def __repr__(self) -> str:
        return f"dtypes.{self._name}"

    def __hash__(self) -> int:
        return hash(self._name)

    def __eq__(self, other) -> bool:
        return isinstance(other, dtype) and other._name == self._name


bool8 = dtype("bool8", "b8", 1, is_bool=True, is_signed=False)
uint8 = dtype("uint8", "u8", 1, is_int=True, is_signed=False)
uint16 = dtype("uint16", "u16", 2, is_int=True, is_signed=False)
uint32 = dtype("uint32", "u32", 4, is_int=True, is_signed=False)
int8 = dtype("int8", "i8", 1, is_int=True)
int16 = dtype("int16", "i16", 2, is_int=True)
int32 = dtype("int32", "i32", 4, is_int=True)
int64 = dtype("int64", "i64", 8, is_int=True)
bfloat16 = dtype("bfloat16", "bf16", 2, is_float=True)
float16 = dtype("float16", "f16", 2, is_float=True)
float32 = dtype("float32", "f32", 4, is_float=True)
float64 = dtype("float64", "f64", 8, is_float=True)
complex64 = dtype("complex64", "c64", 8, is_complex=True)
complex128 = dtype("complex128", "c128", 16, is_complex=True)
float8_e4m3 = dtype("float8_e4m3", "f8e4m3", 1, is_float=True)
float8_e5m2 = dtype("float8_e5m2", "f8e5m2", 1, is_float=True)

all_dtypes = (
    bool8, uint8, uint16, uint32, int8, int16, int32, int64,
    bfloat16, float16, float32, float64, complex64, complex128,
    float8_e4m3, float8_e5m2,
)

_name_to_dtype = {d.name: d for d in all_dtypes}

_torch_of = {
    bool8: torch.bool,
    uint8: torch.uint8,
    uint16: torch.uint16,
    uint32: torch.uint32,
    int8: torch.int8, int16: torch.int16, int32: torch.int32, int64: torch.int64,
    bfloat16: torch.bfloat16, float16: torch.float16, float32: torch.float32, float64: torch.float64,
    complex64: torch.complex64, complex128: torch.complex128,
    float8_e4m3: torch.float8_e4m3fn, float8_e5m2: torch.float8_e5m2,
}
_of_torch = {v: k for k, v in _torch_of.items()}


def to_torch_dtype(d: "dtype | type | None"):
    if d is None:
        return None
    return _torch_of[to_dtype(d)]


_np_kind_map = {
    "b": {1: bool8},
    "u": {1: uint8, 2: uint16, 4: uint32},
    "i": {1: int8, 2: int16, 4: int32, 8: int64},
    "f": {2: float16, 4: float32, 8: float64},
    "c": {8: complex64, 16: complex128},
}


def to_dtype(x: Any) -> dtype | None:
    """Canonicalize anything dtype-ish (torch/numpy dtype, python numbertype,
    tensor) to a framework dtype."""
    if x is None:
        return None
    if isinstance(x, dtype):
        return x
    if x is bool:
        return bool8
    if x is int:
        return int64
    if x is float:
        return float32
    if x is complex:
        return complex64
    if isinstance(x, str):
        return _name_to_dtype[x]
    if isinstance(x, Number):
        return numbertype_to_dtype(type(x))
    d = getattr(x, "dtype", x)
    if isinstance(d, torch.dtype):
        return _of_torch[d]
    name = getattr(d, "name", None)
    if name is not None:
        if name == "bool":
            return bool8
        if name == "float8_e4m3fn":
            return float8_e4m3
        if name in _name_to_dtype:
            return _name_to_dtype[name]
    npd = np.dtype(d) if not hasattr(d, "kind") else d
    try:
        return _np_kind_map[npd.kind][npd.itemsize]
    except (KeyError, AttributeError):
        raise ValueError(f"cannot canonicalize dtype {x!r}")


def is_float_dtype(d) -> bool:
    return to_dtype(d).is_float


def is_integer_dtype(d) -> bool:
    d = to_dtype(d)
    return d.is_int or d.is_bool


def is_boolean_dtype(d) -> bool:
    return to_dtype(d).is_bool


def is_complex_dtype(d) -> bool:
    return to_dtype(d).is_complex


def is_inexact_dtype(d) -> bool:
    return to_dtype(d).is_inexact


def is_low_precision_dtype(d) -> bool:
    d = to_dtype(d)
    return d.is_float and d.bytes <= 2


def dtype_to_numbertype(d) -> type:
    d = to_dtype(d)
    if d.is_bool:
        return bool
    if d.is_int:
        return int
    if d.is_float:
        return float
    if d.is_complex:
        return complex
    raise ValueError(f"no numbertype for {d}")


def numbertype_to_dtype(t: type) -> dtype:
    if issubclass(t, bool):
        return bool8
    if issubclass(t, int):
        return int64
    if issubclass(t, complex) and not issubclass(t, float):
        return complex64
    if issubclass(t, float):
        return float32
    raise ValueError(f"no dtype for numbertype {t}")


def corresponding_real_dtype(d: dtype) -> dtype:
    return {complex64: float32, complex128: float64}.get(d, d)


# ---- type promotion (numpy-style weak scalars, torch-compatible lattice) ----

_promo_order = {
    bool8: 0,
    uint8: 1, int8: 1, int16: 2, uint16: 2, int32: 3, uint32: 3, int64: 4,
    float8_e4m3: 5, float8_e5m2: 5, float16: 6, bfloat16: 6, float32: 7, float64: 8,
    complex64: 9, complex128: 10,
}


def _category(d: dtype) -> int:
    if d.is_bool:
        return 0
    if d.is_int:
        return 1
    if d.is_float:
        return 2
    return 3


def promote_dtypes(*dtypes_or_numbertypes) -> dtype:
    """Two-level promotion: tensor dtypes dominate python-number (weak) types
    within the same category (thunder_tpu's rule, unchanged)."""
    strong: list[dtype] = []
    weak: list[dtype] = []
    for x in dtypes_or_numbertypes:
        if x is None:
            continue
        if isinstance(x, type) and x in (bool, int, float, complex):
            weak.append(numbertype_to_dtype(x))
        else:
            strong.append(to_dtype(x))
    pool = strong if strong else weak
    if not pool:
        raise ValueError("promote_dtypes called with nothing to promote")
    result = pool[0]
    for d in pool[1:]:
        if _category(d) > _category(result) or (
            _category(d) == _category(result) and _promo_order[d] > _promo_order[result]
        ):
            result = d
        elif _category(d) == _category(result) and _promo_order[d] == _promo_order[result] and d != result:
            # bfloat16 + float16 -> float32; int8 + uint8 -> int16 (torch semantics)
            result = float32 if d.is_float else int16
    if strong and weak:
        wcat = max(_category(w) for w in weak)
        if wcat > _category(result):
            if wcat == 2:
                result = float32 if not result.is_complex else result
            if wcat == 3:
                result = complex64 if _promo_order[result] < 8 else complex128
            if wcat <= 1 and result.is_bool:
                result = int64
    return result


def float_math_dtype(d) -> dtype:
    """dtype that float-valued math (exp, sin, ...) produces for an input: ints -> float32."""
    d = to_dtype(d)
    if d.is_float or d.is_complex:
        return d
    return float32


def finfo_max(d) -> float:
    """Largest finite value representable in dtype d (torch.finfo(d).max)."""
    import torch

    tdt = to_torch_dtype(to_dtype(d))
    return float(torch.finfo(tdt).max if tdt.is_floating_point else torch.iinfo(tdt).max)
