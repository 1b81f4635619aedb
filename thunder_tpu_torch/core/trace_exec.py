"""Execution namespace for printed traces.

thunder_tpu/core/trace_exec.py for the port. A printed trace
(``TraceCtx.python()``) references ops by module-qualified name
(``prims.add``, ``ltorch.softmax``, ``clang.reshape``) plus interned
constants. With this namespace the printed source is directly executable:
outside a trace context every Symbol call takes the eager escape hatch
(core/symbol.py) and runs through torchex, on the device of its tensor
arguments. ``torch`` stands where thunder_tpu's namespace has ``jax`` and
``jnp``."""
from __future__ import annotations

from typing import Any


def make_trace_namespace() -> dict[str, Any]:
    import torch

    from . import dtypes, devices, prims
    from ..ops import clang, ltorch
    from ..parallel import prims as dist_prims

    return {
        "prims": prims,
        "ltorch": ltorch,
        "clang": clang,
        "dtypes": dtypes,
        "devices": devices,
        "torch": torch,
        "dist_prims": dist_prims,
    }
