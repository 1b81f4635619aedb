"""ResNet (v1.5) in the port's op language.

thunder_tpu/models/resnet.py as ``torch.nn.Module``s: the same config,
configs, module tree, parameter and buffer names, the same forward in
ltorch. Convolutions run as torchex's convolution prim (cuDNN on the card),
pooling as its reduce_window prim, both with grad rules written out in
transforms/autodiff.py (thunder_tpu takes them from jax.vjp).

BatchNorm2d carries running_mean/running_var buffers. In training mode it
normalizes with the batch statistics and writes the running stats (momentum
0.1, the variance unbiased, as torch's) through ``nn.update_buffer``: the
write is a side effect of the trace, replayed onto the module after the
call (after the optimizer's update in a TrainStep; into the buffers
themselves when the step runs as a CUDA graph). In eval mode it normalizes
with the running stats. The module's train/eval flags are part of jit's
cache key, so ``model.eval()`` retraces.

Weights are random, made on the model's device from ``seed``;
``load_jax_params`` loads thunder_tpu's weights and running stats instead."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import nn
from ..core.devices import resolve_device
from ..ops import ltorch
# thunder_tpu's ResNet weights and BatchNorm running stats load as its GPT's
# weights do: the same names, dtypes and OIHW conv layout, checked one by one
from .litgpt import load_jax_params  # noqa: F401


@dataclass
class ResNetConfig:
    block: str = "bottleneck"  # 'basic' | 'bottleneck'
    layers: tuple = (3, 4, 6, 3)
    num_classes: int = 1000
    width: int = 64
    in_channels: int = 3


configs = {
    "resnet18": ResNetConfig(block="basic", layers=(2, 2, 2, 2)),
    "resnet34": ResNetConfig(block="basic", layers=(3, 4, 6, 3)),
    "resnet50": ResNetConfig(block="bottleneck", layers=(3, 4, 6, 3)),
    "resnet101": ResNetConfig(block="bottleneck", layers=(3, 4, 23, 3)),
    "test": ResNetConfig(block="basic", layers=(1, 1), num_classes=10, width=16),
}


class BatchNorm2d(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32, momentum: float = 0.1, eps: float = 1e-5, *,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones((channels,), dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros((channels,), dtype=dtype, device=device))
        self.momentum = momentum
        self.eps = eps
        self.register_buffer("running_mean", torch.zeros((channels,), dtype=dtype, device=device))
        self.register_buffer("running_var", torch.ones((channels,), dtype=dtype, device=device))

    def forward(self, x):
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            m = ltorch.mean(x, dims)
            centered = x - ltorch.reshape(m, (1, m.shape[0]) + (1,) * (x.ndim - 2))
            v = ltorch.mean(centered * centered, dims)
            # the running variance is unbiased (torch's semantics)
            n = math.prod(x.shape[d] for d in dims)
            unbiased = v * (n / max(1, n - 1))
            mom = self.momentum
            nn.update_buffer(self, "running_mean", (1 - mom) * self.running_mean + mom * m)
            nn.update_buffer(self, "running_var", (1 - mom) * self.running_var + mom * unbiased)
            return ltorch.batch_norm(x, None, None, self.weight, self.bias, training=True, eps=self.eps)
        return ltorch.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                 training=False, eps=self.eps)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, *, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False, dtype=dtype,
                              device=device, generator=generator)
        self.bn = BatchNorm2d(cout, dtype, device=device)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, cout, stride=1, **kw):
        super().__init__()
        self.cbr1 = ConvBN(cin, cout, 3, stride, 1, **kw)
        self.cbr2 = ConvBN(cout, cout, 3, 1, 1, **kw)
        self.down = ConvBN(cin, cout, 1, stride, 0, **kw) if stride != 1 or cin != cout else None

    def forward(self, x):
        idn = x if self.down is None else self.down(x)
        out = ltorch.relu(self.cbr1(x))
        out = self.cbr2(out)
        return ltorch.relu(ltorch.add(out, idn))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, cout, stride=1, **kw):
        super().__init__()
        self.cbr1 = ConvBN(cin, cout, 1, 1, 0, **kw)
        # v1.5: the stride on the 3x3, not the 1x1
        self.cbr2 = ConvBN(cout, cout, 3, stride, 1, **kw)
        self.cbr3 = ConvBN(cout, cout * 4, 1, 1, 0, **kw)
        cexp = cout * 4
        self.down = ConvBN(cin, cexp, 1, stride, 0, **kw) if stride != 1 or cin != cexp else None

    def forward(self, x):
        idn = x if self.down is None else self.down(x)
        out = ltorch.relu(self.cbr1(x))
        out = ltorch.relu(self.cbr2(out))
        out = self.cbr3(out)
        return ltorch.relu(ltorch.add(out, idn))


class ResNet(nn.Module):
    """The model: logits (B, num_classes) of images (B, in_channels, H, W).
    ``device`` defaults to the card (raising when there is none); ``seed``
    seeds the ``torch.Generator`` every weight is drawn from."""

    def __init__(self, cfg: ResNetConfig, dtype=torch.float32, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device, generator=torch.Generator(device=device).manual_seed(seed))
        self.cfg = cfg
        block_cls = BasicBlock if cfg.block == "basic" else Bottleneck
        w = cfg.width
        self.stem = ConvBN(cfg.in_channels, w, 7, 2, 3, **kw)
        cin = w
        self.stages = nn.ModuleList()
        for i, n_blocks in enumerate(cfg.layers):
            cout = w * (2 ** i)
            blocks = []
            for j in range(n_blocks):
                blocks.append(block_cls(cin, cout, (1 if i == 0 else 2) if j == 0 else 1, **kw))
                cin = cout * block_cls.expansion
            self.stages.append(nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, cfg.num_classes, **kw)

    def forward(self, x):
        out = ltorch.relu(self.stem(x))
        out = ltorch.max_pool2d(out, 3, 2, 1)
        for st in self.stages:
            out = st(out)
        out = ltorch.adaptive_avg_pool2d(out, (1, 1))
        out = ltorch.reshape(out, (out.shape[0], out.shape[1]))
        return self.fc(out)


def build(name: str = "resnet50", dtype=torch.float32, *, device=None, seed: int = 0) -> ResNet:
    return ResNet(configs[name], dtype, device=device, seed=seed)
