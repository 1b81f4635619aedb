"""Device model of the PyTorch/CUDA port.

thunder_tpu's DeviceType is {CPU, TPU, META}; here the accelerator is a CUDA
card and TPU is gone. Devices map onto ``torch.device``. The port runs on the
card unless a caller names the CPU: ``resolve_device(None)`` raises when no
card is present instead of quietly running on the host."""
from __future__ import annotations

from enum import Enum

import torch


class DeviceType(Enum):
    CPU = "cpu"
    CUDA = "cuda"
    META = "meta"


class Device:
    def __init__(self, devtype: "DeviceType | str" = DeviceType.CUDA, index: int = 0):
        if isinstance(devtype, str):
            devtype, _, idx = devtype.partition(":")
            devtype = DeviceType(devtype)
            if idx:
                index = int(idx)
        self.devicetype = devtype
        self.index = index

    @property
    def type(self) -> str:
        return self.devicetype.value

    def __repr__(self) -> str:
        return f"Device(type='{self.devicetype.value}:{self.index}')"

    def __str__(self) -> str:
        return f"{self.devicetype.value}:{self.index}"

    def __hash__(self) -> int:
        return hash((self.devicetype, self.index))

    def __eq__(self, other) -> bool:
        return isinstance(other, Device) and other.devicetype == self.devicetype and other.index == self.index

    def torch_device(self) -> torch.device:
        return torch.device(self.type, self.index)


cpu = Device(DeviceType.CPU, 0)
meta = Device(DeviceType.META, 0)


def to_device(x) -> Device:
    if x is None:
        return default_device()
    if isinstance(x, Device):
        return x
    if isinstance(x, str):
        return Device(x)
    if isinstance(x, torch.device):
        return Device(DeviceType(x.type), x.index or 0)
    raise ValueError(f"cannot canonicalize device {x!r}")


def default_device() -> Device:
    """The device a program runs on when nothing names one: the card. A trace
    takes its device from its tensor inputs (TraceCtx.device); this is only
    the answer for a program that has none."""
    return Device(DeviceType.CUDA, 0)


# set inside transforms/materialization.py:meta_device(): every device an
# entry point resolves is then torch's meta device
_meta_mode = [False]


def resolve_device(device=None) -> torch.device:
    """An entry point's device: the card unless the caller names another one.
    Raises when no device was named and no card is present. Under
    ``meta_device()`` it is torch's meta device, whatever was named."""
    if _meta_mode[0]:
        return torch.device("meta")
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # "cuda" names the current card; tensors report it with its index
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
