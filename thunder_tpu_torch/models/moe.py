"""Mixture-of-Experts decoder (Mixtral-class) with capacity-routed grouped
expert MLPs.

thunder_tpu/models/moe.py as ``torch.nn.Module``s: the same MoEConfig, the
same module tree and parameter names (``moe.gate.weight``, ``moe.w_gate``,
``moe.w_up``, ``moe.w_down``), the same router and static-shape capacity
dispatch in ltorch. The grouped road's ``ltorch.grouped_mlp`` is claimed by
the cuda executor's grouped expert kernel (executors/cudaex.py); the dense
road multiplies every token through every expert and runs no kernel.

Weights are random, made on the model's device from ``seed`` (thunder_tpu
draws the expert panels from ``PRNGKey(21)``);
``models.litgpt.load_jax_params`` loads thunder_tpu's instead. The three
``moe_*`` routing-health buffers are registered under thunder_tpu's names
and stay zero: thunder_tpu refreshes them only while observability is on,
which the port does not have yet, and with it off thunder_tpu traces no
refresh either."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from .. import nn
from ..core.devices import resolve_device
from ..ops import ltorch
from .litgpt import CausalSelfAttention, Config as GPTConfig, _norm, build_rope_cache


@dataclass
class MoEConfig:
    n_embd: int = 128
    intermediate_size: int = 256
    n_expert: int = 8
    n_expert_per_token: int = 2
    # None = drop-free (capacity N: the worst case of every token routing one
    # of its k choices to the same expert); a float opts into Switch-style
    # drops with cap = ceil(cf * N * K / E) rounded up to a multiple of 8
    capacity_factor: Optional[float] = None
    # "grouped" packs tokens into per-expert capacity bins and runs
    # ltorch.grouped_mlp (the grouped expert kernel claims it); "dense" is the
    # one-hot reference road: every expert multiplies every token, routing
    # handled by combine weights. Both roads share the router and the
    # capacity/drop decision.
    dispatch: str = "grouped"


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts with capacity-based static-shape dispatch.

    Tokens are routed to their top-k experts (ties to the lowest expert
    index, as lax.top_k breaks them); slots are granted FIFO by token index
    (Switch convention) and tokens over an expert's capacity are dropped:
    their combine weight is zeroed on the dense road and they never enter a
    bin on the grouped road."""

    def __init__(self, cfg: MoEConfig, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        d, h, e = cfg.n_embd, cfg.intermediate_size, cfg.n_expert
        device = resolve_device(device)
        self.gate = nn.Linear(d, e, bias=False, dtype=dtype, device=device, generator=generator)
        s = 1.0 / math.sqrt(d)

        def panel(shape, bound):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device)
                                .uniform_(-bound, bound, generator=generator))

        self.w_gate = panel((e, d, h), s)
        self.w_up = panel((e, d, h), s)
        self.w_down = panel((e, h, d), s / 2)
        # routing-health stats (thunder_tpu's moe.* telemetry); never
        # refreshed until the port has observability
        self.register_buffer("moe_expert_load", torch.zeros((e,), dtype=dtype, device=device))
        self.register_buffer("moe_dropped_tokens", torch.zeros((), dtype=dtype, device=device))
        self.register_buffer("moe_router_entropy", torch.zeros((), dtype=dtype, device=device))

    def capacity(self, n_tokens: int) -> int:
        cfg = self.cfg
        if cfg.capacity_factor is None:
            return n_tokens  # drop-free: an expert appears at most once per token
        cap = math.ceil(cfg.capacity_factor * n_tokens * cfg.n_expert_per_token / cfg.n_expert)
        return min(n_tokens, (cap + 7) // 8 * 8)  # thunder_tpu's sublane-tile rounding

    def forward(self, x):
        cfg = self.cfg
        B, T, D = x.shape
        N = B * T
        E, K = cfg.n_expert, cfg.n_expert_per_token
        xf = ltorch.reshape(x, (N, D))

        router_logits = self.gate(xf)  # (N, E)
        probs = ltorch.softmax(router_logits, -1)
        topk_probs, topk_idx = ltorch.topk(probs, K, -1)  # (N, K)
        # normalize the selected probabilities (Mixtral convention)
        topk_probs = topk_probs / ltorch.sum(topk_probs, -1, keepdim=True)

        # capacity/drop decision shared by both roads: a slot's rank within
        # its expert is FIFO by flattened (token, k) index via a cumsum
        cap = self.capacity(N)
        flat_e = ltorch.reshape(topk_idx, (N * K,))
        oh = ltorch.one_hot(flat_e, E)  # (N*K, E) int
        ranks = ltorch.cumsum(oh, 0)
        rank = ltorch.squeeze(ltorch.take_along_dim(ranks, ltorch.unsqueeze(flat_e, 1), 1), 1) - 1
        keep = rank < cap  # (N*K,) bool
        counts = ltorch.sum(oh, 0)  # (E,) assignments per expert
        w = ltorch.reshape(topk_probs, (N * K,)) * keep.to(probs.dtype)

        if cfg.dispatch == "dense":
            # every expert multiplies every token; dropped (token, k) pairs
            # contribute an exact 0 through their weight
            comb = oh.to(probs.dtype) * ltorch.unsqueeze(w, 1)  # (N*K, E)
            combine = ltorch.sum(ltorch.reshape(comb, (N, K, E)), 1)  # (N, E)
            xe = ltorch.expand(ltorch.unsqueeze(xf, 0), (E, N, D))
            g = ltorch.matmul(xe, self.w_gate)
            u = ltorch.matmul(xe, self.w_up)
            h = ltorch.silu(g) * u
            out_e = ltorch.matmul(h, self.w_down)  # (E, N, D)
            combine_t = ltorch.permute(combine, (1, 0))  # (E, N)
            out = ltorch.sum(out_e * ltorch.unsqueeze(combine_t, -1), 0)  # (N, D)
            return ltorch.reshape(out, (B, T, D))

        # grouped road: scatter kept tokens into per-expert capacity bins
        # (dropped tokens land on a trash row sliced off before the MLP),
        # run the grouped MLP over (E, cap, D), gather back by slot
        trash = E * cap
        slot = ltorch.where(keep, flat_e * cap + rank, trash)  # (N*K,)
        xk = ltorch.reshape(ltorch.expand(ltorch.unsqueeze(xf, 1), (N, K, D)), (N * K, D))
        idx = ltorch.expand(ltorch.unsqueeze(slot, 1), (N * K, D))
        zero_bins = ltorch.full((trash + 1, D), 0.0, dtype=x.dtype, device=x.device)
        bins_flat = ltorch.scatter_add(zero_bins, 0, idx, xk)
        bins = ltorch.reshape(bins_flat[:trash], (E, cap, D))
        group_sizes = ltorch.clamp(counts, max=cap)
        y = ltorch.grouped_mlp(bins, self.w_gate, self.w_up, self.w_down, group_sizes)
        zero_row = ltorch.full((1, D), 0.0, dtype=x.dtype, device=x.device)
        y_flat = ltorch.cat([ltorch.reshape(y, (trash, D)), zero_row], 0)
        picked = ltorch.take_along_dim(y_flat, idx, 0)  # (N*K, D)
        out = ltorch.sum(ltorch.reshape(picked * ltorch.unsqueeze(w, 1), (N, K, D)), 1)
        return ltorch.reshape(out, (B, T, D))


class MoEBlock(nn.Module):
    """Attention and an MoE MLP, always as a sequential residual."""

    def __init__(self, gpt_cfg: GPTConfig, moe_cfg: MoEConfig, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_1 = _norm(gpt_cfg, dtype, device)
        self.attn = CausalSelfAttention(gpt_cfg, dtype, device, generator)
        self.norm_2 = _norm(gpt_cfg, dtype, device)
        self.moe = MoEMLP(moe_cfg, dtype, device, generator)

    def forward(self, x, cos, sin):
        x = x + self.attn(self.norm_1(x), cos, sin)
        return x + self.moe(self.norm_2(x))


class MoEGPT(nn.Module):
    """Mixtral-style decoder: GQA attention + MoE MLPs. ``device`` defaults
    to the card (raising when there is none); ``seed`` seeds the
    ``torch.Generator`` every weight is drawn from. ``forward(idx, targets)``
    returns the mean cross-entropy over the B*T positions, as thunder_tpu's."""

    def __init__(self, gpt_cfg: GPTConfig, moe_cfg: MoEConfig, dtype=torch.float32, *, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.cfg = gpt_cfg
        self.wte = nn.Embedding(gpt_cfg.padded_vocab_size, gpt_cfg.n_embd, dtype=dtype, device=device,
                                generator=gen)
        self.h = nn.ModuleList([MoEBlock(gpt_cfg, moe_cfg, dtype, device, gen)
                                for _ in range(gpt_cfg.n_layer)])
        self.ln_f = _norm(gpt_cfg, dtype, device)
        self.lm_head = nn.Linear(gpt_cfg.n_embd, gpt_cfg.padded_vocab_size, bias=False, dtype=dtype,
                                 device=device, generator=gen)
        cos, sin = build_rope_cache(gpt_cfg.block_size, gpt_cfg.rope_n_elem, gpt_cfg.rope_base, dtype,
                                    device)
        self.register_buffer("cos", cos)
        self.register_buffer("sin", sin)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, idx, targets=None):
        B, T = idx.shape
        cos, sin = self.cos[:T], self.sin[:T]
        x = self.wte(idx)
        for blk in self.h:
            x = blk(x, cos, sin)
        x = self.ln_f(x)
        logits = self.lm_head(x)
        if targets is not None:
            V = logits.shape[-1]
            return ltorch.cross_entropy(ltorch.reshape(logits, (B * T, V)),
                                        ltorch.reshape(targets, (B * T,)))
        return logits


def tiny_moe(*, device=None, seed: int = 0) -> MoEGPT:
    gpt_cfg = GPTConfig.from_name("tiny-llama2")
    moe_cfg = MoEConfig(n_embd=gpt_cfg.n_embd, intermediate_size=160, n_expert=4, n_expert_per_token=2)
    return MoEGPT(gpt_cfg, moe_cfg, device=device, seed=seed)
