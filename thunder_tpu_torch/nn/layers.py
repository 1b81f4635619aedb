"""Standard NN layers whose forward is written in the port's ltorch.

The layers of thunder_tpu/nn/layers.py as ``torch.nn.Module``s. Weights are
made on their device from an explicit ``torch.Generator`` with thunder_tpu's
init laws (uniform ±1/sqrt(fan in) for Linear and Conv2d, standard normal
for Embedding); the numbers differ from jax's, so parity tests load
thunder_tpu's weights (models/litgpt.py:load_jax_params)."""
from __future__ import annotations

import math

import torch

from ..core.devices import resolve_device
from ..ops import ltorch
from .module import Module, Parameter


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=resolve_device(device))


class Linear(Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 dtype=torch.float32, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        bound = 1.0 / math.sqrt(in_features)
        # (out, in): the layout of thunder_tpu's Linear and of torch's
        self.weight = Parameter(_empty((out_features, in_features), dtype, device)
                                .uniform_(-bound, bound, generator=generator))
        if bias:
            self.bias = Parameter(_empty((out_features,), dtype, device)
                                  .uniform_(-bound, bound, generator=generator))
        else:
            self.bias = None

    def forward(self, x):
        return ltorch.linear(x, self.weight, self.bias)


class Embedding(Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = Parameter(_empty((num_embeddings, embedding_dim), dtype, device)
                                .normal_(generator=generator))

    def forward(self, idx):
        return ltorch.embedding(idx, self.weight)


class LayerNorm(Module):
    def __init__(self, normalized_shape, eps: float = 1e-5, elementwise_affine: bool = True, *,
                 bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        if elementwise_affine:
            self.weight = Parameter(_empty(self.normalized_shape, dtype, device).fill_(1))
            self.bias = Parameter(_empty(self.normalized_shape, dtype, device).zero_()) if bias else None
        else:
            self.weight = None
            self.bias = None

    def forward(self, x):
        return ltorch.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)


class RMSNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = Parameter(_empty((dim,), dtype, device).fill_(1))

    def forward(self, x):
        return ltorch.rms_norm(x, (self.dim,), self.weight, self.eps)


class Conv2d(Module):
    """OIHW weight (thunder_tpu/nn/layers.py:133, and torch's layout),
    uniform ±1/sqrt(in_channels / groups · kh · kw), bias likewise."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, padding=0, dilation=1,
                 groups: int = 1, bias: bool = True, *, dtype=torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        pair = lambda v: (v, v) if isinstance(v, int) else tuple(v)  # noqa: E731
        ks = pair(kernel_size)
        self.stride, self.padding, self.dilation = pair(stride), pair(padding), pair(dilation)
        self.groups = groups
        bound = 1.0 / math.sqrt(in_channels // groups * ks[0] * ks[1])
        self.weight = Parameter(_empty((out_channels, in_channels // groups, *ks), dtype, device)
                                .uniform_(-bound, bound, generator=generator))
        if bias:
            self.bias = Parameter(_empty((out_channels,), dtype, device)
                                  .uniform_(-bound, bound, generator=generator))
        else:
            self.bias = None

    def forward(self, x):
        return ltorch.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation, self.groups)


class Dropout(Module):
    """Identity in eval mode, at p == 0 or without a key, as thunder_tpu's.
    Dropping needs traced RNG state (ROADMAP A6), which the port does not
    have yet: p > 0 with a key in training mode raises."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p

    def forward(self, x, key=None):
        if not self.training or self.p == 0.0 or key is None:
            return x
        raise NotImplementedError(
            "Dropout(p > 0) with a key requires traced RNG-state plumbing, which thunder_tpu_torch "
            "does not provide yet (ROADMAP A6); pass p=0.0 or no key")


class GELU(Module):
    def __init__(self, approximate: str = "none"):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return ltorch.gelu(x, approximate=self.approximate)


class ReLU(Module):
    def forward(self, x):
        return ltorch.relu(x)


class SiLU(Module):
    def forward(self, x):
        return ltorch.silu(x)


class Tanh(Module):
    def forward(self, x):
        return ltorch.tanh(x)


class Sigmoid(Module):
    def forward(self, x):
        return ltorch.sigmoid(x)
