"""nanoGPT-style GPT-2: learned positional embeddings, tanh-GELU MLP,
LayerNorm with bias, plain causal attention.

thunder_tpu/models/nanogpt.py as ``torch.nn.Module``s: the same config,
configs, module tree and parameter names, the same forward in ltorch. Its
attention is plain ``ltorch.sdpa`` (no RoPE), which the flash-attention
kernels claim (executors/cudaex.py), and ``forward(idx, targets)`` returns
the mean cross-entropy, which the fused cross-entropy kernel claims when the
loss is taken with no gradient.

Weights are random, made on the model's device from ``seed``;
``load_jax_params`` loads thunder_tpu's weights instead."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..core import dtypes
from ..core.devices import resolve_device
from ..ops import ltorch
# thunder_tpu's NanoGPT weights load as its GPT's do: the same names, dtypes
# and (out, in) Linear layout, checked one by one
from .litgpt import load_jax_params  # noqa: F401


@dataclass
class NanoGPTConfig:
    block_size: int = 1024
    vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0
    bias: bool = True


configs = {
    "gpt2": NanoGPTConfig(n_layer=12, n_head=12, n_embd=768),
    "gpt2-medium": NanoGPTConfig(n_layer=24, n_head=16, n_embd=1024),
    "gpt2-large": NanoGPTConfig(n_layer=36, n_head=20, n_embd=1280),
    "gpt2-xl": NanoGPTConfig(n_layer=48, n_head=25, n_embd=1600),
    "test": NanoGPTConfig(block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=64),
}


class NanoCausalSelfAttention(nn.Module):
    def __init__(self, cfg: NanoGPTConfig, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.n_head = cfg.n_head
        self.n_embd = cfg.n_embd
        self.c_attn = nn.Linear(cfg.n_embd, 3 * cfg.n_embd, bias=cfg.bias, dtype=dtype,
                                device=device, generator=generator)
        self.c_proj = nn.Linear(cfg.n_embd, cfg.n_embd, bias=cfg.bias, dtype=dtype,
                                device=device, generator=generator)

    def forward(self, x):
        B, T, C = x.shape
        qkv = self.c_attn(x)
        q, k, v = ltorch.chunk(qkv, 3, -1)
        hs = C // self.n_head
        q = ltorch.permute(ltorch.reshape(q, (B, T, self.n_head, hs)), (0, 2, 1, 3))
        k = ltorch.permute(ltorch.reshape(k, (B, T, self.n_head, hs)), (0, 2, 1, 3))
        v = ltorch.permute(ltorch.reshape(v, (B, T, self.n_head, hs)), (0, 2, 1, 3))
        y = ltorch.sdpa(q, k, v, is_causal=True)
        y = ltorch.reshape(ltorch.permute(y, (0, 2, 1, 3)), (B, T, C))
        return self.c_proj(y)


class NanoMLP(nn.Module):
    def __init__(self, cfg: NanoGPTConfig, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.c_fc = nn.Linear(cfg.n_embd, 4 * cfg.n_embd, bias=cfg.bias, dtype=dtype,
                              device=device, generator=generator)
        self.c_proj = nn.Linear(4 * cfg.n_embd, cfg.n_embd, bias=cfg.bias, dtype=dtype,
                                device=device, generator=generator)

    def forward(self, x):
        return self.c_proj(ltorch.gelu(self.c_fc(x), approximate="tanh"))


class NanoBlock(nn.Module):
    def __init__(self, cfg: NanoGPTConfig, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.n_embd, bias=cfg.bias, dtype=dtype, device=device)
        self.attn = NanoCausalSelfAttention(cfg, dtype, device, generator)
        self.ln_2 = nn.LayerNorm(cfg.n_embd, bias=cfg.bias, dtype=dtype, device=device)
        self.mlp = NanoMLP(cfg, dtype, device, generator)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class NanoGPT(nn.Module):
    """The model. ``device`` defaults to the card (raising when there is
    none); ``seed`` seeds the ``torch.Generator`` every weight is drawn from."""

    def __init__(self, cfg: NanoGPTConfig, dtype=torch.float32, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, dtype=dtype, device=device, generator=gen)
        self.wpe = nn.Embedding(cfg.block_size, cfg.n_embd, dtype=dtype, device=device, generator=gen)
        self.h = nn.ModuleList([NanoBlock(cfg, dtype, device, gen) for _ in range(cfg.n_layer)])
        self.ln_f = nn.LayerNorm(cfg.n_embd, bias=cfg.bias, dtype=dtype, device=device)
        self.lm_head = nn.Linear(cfg.n_embd, cfg.vocab_size, bias=False, dtype=dtype, device=device,
                                 generator=gen)

    def forward(self, idx, targets=None):
        B, T = idx.shape
        pos = ltorch.arange(T, device=idx.device, dtype=dtypes.int32)
        x = self.wte(idx) + self.wpe(pos)
        for block in self.h:
            x = block(x)
        x = self.ln_f(x)
        logits = self.lm_head(x)
        if targets is not None:
            return ltorch.cross_entropy(
                ltorch.reshape(logits, (B * T, self.cfg.vocab_size)),
                ltorch.reshape(targets, (B * T,)),
            )
        return logits

