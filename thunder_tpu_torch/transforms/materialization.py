"""Deferred (meta-device) initialization + materialization.

thunder_tpu/transforms/materialization.py for the port. Modules built under
``meta_device()`` carry only shapes: ``core.devices.resolve_device`` answers
torch's ``meta`` device there, so every parameter and buffer a model makes
is a meta tensor and nothing is allocated (thunder_tpu's ``MetaArray`` has
no counterpart: torch's meta tensors are that stand-in).
``MaterializationTransform`` then makes each parameter on its target device
right before first use, which is how a large model is built without first
holding it on the host.

A meta parameter is drawn by its ``init_fn(generator)`` when it has one
(an attribute set on the parameter, the counterpart of ``MetaArray.init_fn``),
else as ``normal * 0.02``, from a ``torch.Generator`` on the target device
seeded by ``seed`` and stepped through the parameters in order (thunder_tpu
folds each parameter's index into its key: the streams differ, and the
tests compare shapes, statistics and outputs, not draws). A buffer on meta
(a rope cache) has no random law: it is made by its own
``init_fn(generator)``, which the model sets where it registers the
buffer, and a meta buffer without one raises.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

import torch

from ..core import devices
from ..core.transform_common import Transform
from ..nn.module import Parameter


@contextmanager
def meta_device():
    """Build modules without allocating: inside, ``resolve_device`` returns
    torch's meta device whatever device is asked for.

    Usage:
        with meta_device():
            model = GPT(big_config)   # instant, no memory
        MaterializationTransform(seed=0).transform_module(tt.jit(model))
    """
    devices._meta_mode[0] = True
    try:
        yield
    finally:
        devices._meta_mode[0] = False


def is_meta_mode() -> bool:
    return devices._meta_mode[0]


class MaterializationTransform(Transform):
    """``device`` is every parameter's target, the card unless the caller
    names one. ``sharding_fn`` keeps thunder_tpu's name; it returns a jax
    sharding there, and the port's sharded materialization waits for ROADMAP
    A3c, so giving it raises."""

    def __init__(self, seed: int = 0, sharding_fn: Optional[Callable] = None, device=None):
        if sharding_fn is not None:
            raise NotImplementedError(
                "MaterializationTransform(sharding_fn=) is not ported: sharded materialization "
                "waits for the GSPMD road of the port's distributed training (ROADMAP A3c)")
        self.seed = seed
        self.device = device

    def transform_module(self, tmodule) -> None:
        root = tmodule.module if hasattr(tmodule, "module") else tmodule
        target = devices.resolve_device(self.device)
        modules = dict(root.named_modules())
        # one stream, seeded by seed: each parameter draws from where the one
        # before it stopped
        gen = torch.Generator(device=target).manual_seed(self.seed)

        for qual, p in [(q, p) for q, p in root.named_parameters() if p.is_meta]:
            owner, _, name = qual.rpartition(".")
            init_fn = getattr(p, "init_fn", None)
            with torch.no_grad():
                if init_fn is not None:
                    arr = init_fn(gen)
                else:
                    arr = torch.empty(p.shape, dtype=p.dtype, device=target).normal_(generator=gen) * 0.02
            modules[owner]._parameters[name] = Parameter(arr.to(device=target, dtype=p.dtype),
                                                         requires_grad=p.requires_grad)
        for qual, b in list(root.named_buffers()):
            if not b.is_meta:
                continue
            owner, _, name = qual.rpartition(".")
            init_fn = getattr(b, "init_fn", None)
            if init_fn is None:
                raise ValueError(f"buffer {qual!r} is on the meta device and has no init_fn: a buffer "
                                 f"has no random law to materialize it by")
            with torch.no_grad():
                modules[owner]._buffers[name] = init_fn(gen).to(
                    device=target, dtype=b.dtype)
