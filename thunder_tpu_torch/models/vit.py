"""Vision Transformer (ViT-B/16 class) in the port's op language.

thunder_tpu/models/vit.py as ``torch.nn.Module``s: the same config, configs,
module tree and parameter names, the same forward in ltorch. The patchify is
a patch_size-strided Conv2d (torchex's convolution prim, cuDNN on the card);
the attention is ``ltorch.sdpa(..., is_causal=False)`` at T = patches + 1
(197 at 224x224, patch 16), which the flash-attention kernels claim
(executors/cudaex.py: any T, the ragged last tile masked);
``ViTForClassification(x, labels)`` returns the mean cross-entropy, which the
fused cross-entropy kernel claims when the loss is taken with no gradient.

Weights are random, made on the model's device from ``seed`` (thunder_tpu
draws ``pos_embed`` from its own fixed key); ``load_jax_params`` loads
thunder_tpu's weights instead."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..core.devices import resolve_device
from ..ops import ltorch
# thunder_tpu's ViT weights load as its GPT's do: the same names, dtypes and
# (out, in) Linear / OIHW conv layouts, checked one by one
from .litgpt import load_jax_params  # noqa: F401


@dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    channels: int = 3


configs = {
    "vit-b16": ViTConfig(),
    "vit-s16": ViTConfig(dim=384, depth=12, heads=6, mlp_dim=1536),
    "test": ViTConfig(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2, mlp_dim=128),
}


class PatchEmbed(nn.Module):
    """Conv-as-patchify: a patch_size-strided conv over the image."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.proj = nn.Conv2d(cfg.channels, cfg.dim, cfg.patch_size, stride=cfg.patch_size, dtype=dtype,
                              device=device, generator=generator)

    def forward(self, x):
        x = self.proj(x)  # (B, dim, H/p, W/p)
        B, C, H, W = x.shape
        x = ltorch.reshape(x, (B, C, H * W))
        return ltorch.permute(x, (0, 2, 1))  # (B, N, dim)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.heads = cfg.heads
        self.qkv = nn.Linear(cfg.dim, 3 * cfg.dim, dtype=dtype, device=device, generator=generator)
        self.proj = nn.Linear(cfg.dim, cfg.dim, dtype=dtype, device=device, generator=generator)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = ltorch.chunk(self.qkv(x), 3, -1)
        hs = C // self.heads
        q = ltorch.permute(ltorch.reshape(q, (B, N, self.heads, hs)), (0, 2, 1, 3))
        k = ltorch.permute(ltorch.reshape(k, (B, N, self.heads, hs)), (0, 2, 1, 3))
        v = ltorch.permute(ltorch.reshape(v, (B, N, self.heads, hs)), (0, 2, 1, 3))
        y = ltorch.sdpa(q, k, v, is_causal=False)
        y = ltorch.reshape(ltorch.permute(y, (0, 2, 1, 3)), (B, N, C))
        return self.proj(y)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.dim, dtype=dtype, device=device)
        self.attn = ViTAttention(cfg, dtype, device, generator)
        self.norm2 = nn.LayerNorm(cfg.dim, dtype=dtype, device=device)
        self.fc1 = nn.Linear(cfg.dim, cfg.mlp_dim, dtype=dtype, device=device, generator=generator)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.dim, dtype=dtype, device=device, generator=generator)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        h = ltorch.gelu(self.fc1(self.norm2(x)))
        return x + self.fc2(h)


class ViT(nn.Module):
    """The model: logits (B, num_classes) of images (B, channels, H, W).
    ``device`` defaults to the card (raising when there is none); ``seed``
    seeds the ``torch.Generator`` every weight is drawn from."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.cfg = cfg
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = PatchEmbed(cfg, dtype, device, gen)
        self.pos_embed = nn.Parameter(
            torch.empty((1, n_patches + 1, cfg.dim), dtype=dtype, device=device).normal_(generator=gen) * 0.02)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, cfg.dim), dtype=dtype, device=device))
        self.blocks = nn.ModuleList([ViTBlock(cfg, dtype, device, gen) for _ in range(cfg.depth)])
        self.norm = nn.LayerNorm(cfg.dim, dtype=dtype, device=device)
        self.head = nn.Linear(cfg.dim, cfg.num_classes, dtype=dtype, device=device, generator=gen)

    def forward(self, x):
        B = x.shape[0]
        x = self.patch_embed(x)
        cls = ltorch.expand(self.cls_token, (B, 1, self.cfg.dim))
        x = ltorch.cat([cls, x], 1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return self.head(x[:, 0])


class ViTForClassification(nn.Module):
    def __init__(self, cfg: ViTConfig, dtype=torch.float32, *, device=None, seed: int = 0):
        super().__init__()
        self.vit = ViT(cfg, dtype, device=device, seed=seed)

    def forward(self, x, labels):
        return ltorch.cross_entropy(self.vit(x), labels)
