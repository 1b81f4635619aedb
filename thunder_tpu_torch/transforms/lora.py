"""LoRA: low-rank adaptation of Linear layers as a module transform.

The port of thunder_tpu/transforms/lora.py. The transform freezes the base
weight (and bias) and adds trainable ``lora_A`` (r, in) and ``lora_B``
(out, r) parameters; the forward becomes ``x @ W.T + (alpha/r) * (x @ A.T)
@ B.T``. TrainStep then trains the adapters only: frozen parameters ride
its non-differentiated argument. The adapters are drawn from an explicit
``torch.Generator`` seeded from ``seed``, so their numbers differ from
thunder_tpu's jax.random ones; parity tests carry thunder_tpu's adapters
across (models/litgpt.py:load_jax_params)."""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from ..core.transform_common import Transform
from ..nn.module import Parameter
from ..ops import ltorch


class LORATransform(Transform):
    """Swap matching Linear modules for LoRA-adapted forwards.

    Args:
      r: adapter rank.
      lora_alpha: scaling numerator (effective scale = alpha / r).
      lora_dropout: dropout on the adapter input path; only 0 is supported.
      target_modules: substrings of qualified module names to adapt; empty =
        every Linear.
      seed: seeds the generator the adapters are drawn from.
    """

    def __init__(self, *, r: int = 8, lora_alpha: int = 16, lora_dropout: float = 0.0,
                 target_modules: Sequence[str] = (), seed: int = 0):
        if lora_dropout > 0.0:
            raise NotImplementedError(
                "lora_dropout requires traced RNG-state plumbing, which thunder_tpu_torch does not "
                "provide yet; pass lora_dropout=0.0")
        self.r = r
        self.lora_alpha = lora_alpha
        self.lora_dropout = lora_dropout
        self.target_modules = tuple(target_modules)
        self.seed = seed

    def _matches(self, name: str) -> bool:
        return not self.target_modules or any(t in name for t in self.target_modules)

    def transform_module(self, tmodule) -> None:
        from .. import nn as _nn

        root = tmodule.module if hasattr(tmodule, "module") else tmodule
        gen = None
        n_adapted = 0
        for name, mod in list(root.named_modules()):
            if not isinstance(mod, _nn.Linear) or not self._matches(name):
                continue
            w = mod.weight
            if gen is None:
                gen = torch.Generator(device=w.device).manual_seed(self.seed)
            in_f, out_f = mod.in_features, mod.out_features
            # Kaiming-uniform A, zero B: the adapter starts as the identity
            bound = 1.0 / math.sqrt(in_f)
            lora_a = torch.empty((self.r, in_f), dtype=w.dtype, device=w.device).uniform_(-bound, bound,
                                                                                          generator=gen)
            mod.weight.requires_grad_(False)
            if getattr(mod, "bias", None) is not None:
                mod.bias.requires_grad_(False)
            mod.register_parameter("lora_A", Parameter(lora_a))
            mod.register_parameter("lora_B", Parameter(torch.zeros((out_f, self.r), dtype=w.dtype,
                                                                   device=w.device)))
            mod._lora_scale = self.lora_alpha / self.r
            mod.forward = _make_lora_forward(mod, mod._lora_scale)
            n_adapted += 1
        if n_adapted == 0:
            raise ValueError(f"LORATransform matched no Linear modules (targets={self.target_modules!r})")


def _make_lora_forward(mod, scale: float) -> Callable:
    def forward(x):
        base = ltorch.linear(x, mod._parameters["weight"], mod._parameters.get("bias"))
        down = ltorch.linear(x, mod._parameters["lora_A"], None)
        up = ltorch.linear(down, mod._parameters["lora_B"], None)
        return ltorch.add(base, ltorch.mul(up, scale))

    return forward


def merge_lora_weights(tmodule) -> None:
    """Fold the adapters into the base weights (W += scale · B @ A) for
    adapter-free inference; removes the adapter parameters and restores the
    stock Linear forward."""
    root = tmodule.module if hasattr(tmodule, "module") else tmodule
    for _, mod in list(root.named_modules()):
        params = mod._parameters
        if "lora_A" not in params or "lora_B" not in params:
            continue
        with torch.no_grad():
            w = params["weight"] + getattr(mod, "_lora_scale", 1.0) * (params["lora_B"] @ params["lora_A"])
        params["weight"] = Parameter(w, requires_grad=False)
        del params["lora_A"], params["lora_B"]
        del mod.forward  # the instance forward: the class's Linear.forward runs again
