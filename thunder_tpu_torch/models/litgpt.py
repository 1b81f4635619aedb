"""LitGPT-style configurable transformer in the port's op language.

thunder_tpu/models/litgpt.py as ``torch.nn.Module``s: the same Config and
configs, the same module tree and parameter names, the same forward in
ltorch. Covers RoPE, RMSNorm/LayerNorm, GQA (n_query_groups), GptNeox vs
LLaMA (SwiGLU) MLPs and parallel residuals.

Weights are random, made on the model's device from ``seed``;
``load_jax_params`` loads thunder_tpu's weights instead, and
``load_jax_checkpoint`` a thunder_tpu training checkpoint into a port
``TrainStep``. The attention of
``GPT.forward`` (``ltorch.rope_sdpa``) is claimed by the flash-RoPE kernels
(executors/cudaex.py); traced under context parallelism
(parallel/context_parallel.py) it takes RoPE outside and plain ``sdpa``,
which the transform rewrites into ring attention, and ``rope_slice`` gives
each rank's tokens their global positions. Serving runs the blocks itself
(inference.py, serving/runner.py). ``GPTForCausalLM`` adds the shifted-target loss that
``training.TrainStep`` minimizes."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import nn
from ..core.devices import resolve_device
from ..ops import ltorch
from ..parallel.context_parallel import current_seq_parallel_ctx
from ..transforms import remat


@dataclass
class Config:
    name: str = "tiny"
    block_size: int = 128
    vocab_size: int = 512
    padded_vocab_size: Optional[int] = None
    n_layer: int = 2
    n_head: int = 4
    n_embd: int = 64
    head_size: Optional[int] = None
    n_query_groups: Optional[int] = None
    rotary_percentage: float = 1.0
    parallel_residual: bool = False
    bias: bool = False
    norm_class_name: str = "RMSNorm"
    mlp_class_name: str = "LLaMAMLP"
    intermediate_size: Optional[int] = None
    norm_eps: float = 1e-5
    rope_base: int = 10000
    lm_head_bias: bool = False
    shared_embedding: bool = False
    # recompute each block in the backward instead of saving its
    # activations (GPT.forward wraps the blocks in remat.checkpoint)
    activation_checkpoint: bool = False

    def __post_init__(self):
        if self.padded_vocab_size is None:
            self.padded_vocab_size = _next_multiple(self.vocab_size, 128)
        if self.head_size is None:
            self.head_size = self.n_embd // self.n_head
        if self.n_query_groups is None:
            self.n_query_groups = self.n_head
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.n_embd

    @property
    def rope_n_elem(self) -> int:
        return int(self.rotary_percentage * self.head_size)

    @classmethod
    def from_name(cls, name: str, **overrides) -> "Config":
        cfg = dict(configs[name])
        cfg.update(overrides)
        return cls(**cfg)


def _next_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


configs: dict[str, dict] = {
    "tiny": dict(name="tiny", block_size=128, vocab_size=512, n_layer=2, n_head=4, n_embd=64),
    "tiny-llama2": dict(
        name="tiny-llama2", block_size=256, vocab_size=320, n_layer=3, n_head=4, n_query_groups=2,
        n_embd=128, intermediate_size=352, norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP",
    ),
    "tiny-gptneox": dict(
        name="tiny-gptneox", block_size=128, vocab_size=320, n_layer=2, n_head=4, n_embd=64,
        norm_class_name="LayerNorm", mlp_class_name="GptNeoxMLP", parallel_residual=True, bias=True,
    ),
    # benchmark-class configs (matching LitGPT hyperparameters)
    "nanogpt-124m": dict(
        name="nanogpt-124m", block_size=1024, vocab_size=50257, n_layer=12, n_head=12, n_embd=768,
        norm_class_name="LayerNorm", mlp_class_name="GptNeoxMLP", bias=True,
    ),
    # largest Llama-2-class config that trains on ONE v5e chip (16 GB) with
    # AdamW fp32 state — the single-chip north-star shape (BASELINE.json)
    "llama-350m": dict(
        name="llama-350m", block_size=2048, vocab_size=32000, padded_vocab_size=32000,
        n_layer=24, n_head=16, n_embd=1024, intermediate_size=2816,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP", rope_base=10000,
    ),
    # 1.02B-param Llama-class config (width 2048, head_dim 128, GQA 4 groups,
    # vocab 32k): the largest round shape whose AdamW-f32 state (~12.2 GB)
    # plus remat'd activations trains on one 16 GB chip at B=1, T=2048
    "llama-1b": dict(
        name="llama-1b", block_size=2048, vocab_size=32000, padded_vocab_size=32000,
        n_layer=20, n_head=16, n_query_groups=4, n_embd=2048, intermediate_size=5504,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP", rope_base=10000,
    ),
    "Llama-2-7b-hf": dict(
        name="Llama-2-7b-hf", block_size=4096, vocab_size=32000, padded_vocab_size=32000,
        n_layer=32, n_head=32, n_embd=4096, intermediate_size=11008,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP", rope_base=10000,
    ),
    # Llama-2-7B at full width (4096 / head_dim 128 / MLP 11008 / vocab 32k)
    # truncated to 4 blocks: the deepest 7B-dims stack whose AdamW f32 state
    # fits one 16 GB chip — per-layer compute is EXACTLY the 7B model's, so
    # its MFU is the honest single-chip 7B-shape number (BENCH_7B.json)
    "llama-7b-block4": dict(
        name="llama-7b-block4", block_size=4096, vocab_size=32000, padded_vocab_size=32000,
        n_layer=4, n_head=32, n_embd=4096, intermediate_size=11008,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP", rope_base=10000,
    ),
    "Llama-2-13b-hf": dict(
        name="Llama-2-13b-hf", block_size=4096, vocab_size=32000, padded_vocab_size=32000,
        n_layer=40, n_head=40, n_embd=5120, intermediate_size=13824,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP", rope_base=10000,
    ),
    "Llama-3-8B": dict(
        name="Llama-3-8B", block_size=8192, vocab_size=128000, padded_vocab_size=128256,
        n_layer=32, n_head=32, n_query_groups=8, n_embd=4096, intermediate_size=14336,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP", rope_base=500000,
    ),
    "Llama-3-1B": dict(
        name="Llama-3-1B", block_size=8192, vocab_size=128000, padded_vocab_size=128256,
        n_layer=16, n_head=32, n_query_groups=8, n_embd=2048, intermediate_size=8192,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP", rope_base=500000,
    ),
}


def _norm(cfg: Config, dtype, device):
    if cfg.norm_class_name == "RMSNorm":
        return nn.RMSNorm(cfg.n_embd, eps=cfg.norm_eps, dtype=dtype, device=device)
    return nn.LayerNorm(cfg.n_embd, eps=cfg.norm_eps, dtype=dtype, device=device)


class GptNeoxMLP(nn.Module):
    def __init__(self, cfg: Config, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(bias=cfg.bias, dtype=dtype, device=device, generator=generator)
        self.fc = nn.Linear(cfg.n_embd, cfg.intermediate_size, **kw)
        self.proj = nn.Linear(cfg.intermediate_size, cfg.n_embd, **kw)

    def forward(self, x):
        return self.proj(ltorch.gelu(self.fc(x), approximate="tanh"))


class LLaMAMLP(nn.Module):
    def __init__(self, cfg: Config, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        kw = dict(bias=cfg.bias, dtype=dtype, device=device, generator=generator)
        self.fc_1 = nn.Linear(cfg.n_embd, cfg.intermediate_size, **kw)
        self.fc_2 = nn.Linear(cfg.n_embd, cfg.intermediate_size, **kw)
        self.proj = nn.Linear(cfg.intermediate_size, cfg.n_embd, **kw)

    def forward(self, x):
        return self.proj(ltorch.silu(self.fc_1(x)) * self.fc_2(x))


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: Config, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.n_head + 2 * cfg.n_query_groups) * cfg.head_size
        kw = dict(bias=cfg.bias, dtype=dtype, device=device, generator=generator)
        self.attn = nn.Linear(cfg.n_embd, shape, **kw)
        self.proj = nn.Linear(cfg.n_head * cfg.head_size, cfg.n_embd, **kw)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        B, T, _ = x.shape
        nh, ng, hs = cfg.n_head, cfg.n_query_groups, cfg.head_size
        qkv = self.attn(x)
        # split grouped qkv: (B, T, (nh + 2*ng) * hs)
        q_per_kv = nh // ng
        qkv = ltorch.reshape(qkv, (B, T, ng, q_per_kv + 2, hs))
        q = qkv[:, :, :, : q_per_kv, :]
        k = qkv[:, :, :, q_per_kv: q_per_kv + 1, :]
        v = qkv[:, :, :, q_per_kv + 1:, :]
        q = ltorch.reshape(q, (B, T, nh, hs))
        k = ltorch.reshape(k, (B, T, ng, hs))
        v = ltorch.reshape(v, (B, T, ng, hs))
        q = ltorch.permute(q, (0, 2, 1, 3))  # (B, nh, T, hs)
        k = ltorch.permute(k, (0, 2, 1, 3))
        v = ltorch.permute(v, (0, 2, 1, 3))

        n_elem = cfg.rope_n_elem
        if n_elem == hs and hs % 2 == 0 and current_seq_parallel_ctx() is None:
            # fused rope+attention symbol (GQA included), as thunder_tpu
            # traces it: the cuda executor claims it with the flash-RoPE
            # kernels (csrc/flash_rope_*.cu); ring-attention context
            # parallelism rewrites plain sdpa bsyms, so it takes the
            # decomposed path
            y = ltorch.rope_sdpa(q, k, v, cos, sin, is_causal=True,
                                 scale=1.0 / math.sqrt(hs))
        else:
            q = _apply_rope(q, cos, sin, n_elem)
            k = _apply_rope(k, cos, sin, n_elem)
            if ng != nh:
                k = _repeat_kv(k, q_per_kv)
                v = _repeat_kv(v, q_per_kv)
            y = ltorch.sdpa(q, k, v, is_causal=True, scale=1.0 / math.sqrt(hs))
        y = ltorch.reshape(ltorch.permute(y, (0, 2, 1, 3)), (B, T, nh * hs))
        return self.proj(y)


def _repeat_kv(x, n: int):
    # (B, ng, T, hs) -> (B, ng*n, T, hs)
    B, ng, T, hs = x.shape
    x = ltorch.unsqueeze(x, 2)
    x = ltorch.expand(x, (B, ng, n, T, hs))
    return ltorch.reshape(x, (B, ng * n, T, hs))


def _apply_rope(x, cos, sin, n_elem: int):
    """Half-split RoPE as half-width muls with one final concat (with
    duplicated-half caches cos[:d/2] == cos[d/2:], out1 = x1·c − x2·s and
    out2 = x2·c + x1·s) — thunder_tpu's op sequence, kept so both packages
    trace the same ops."""
    if n_elem <= 0:
        return x
    hs = x.shape[-1]
    h = n_elem // 2
    x1 = x[..., :h]
    x2 = x[..., h:n_elem]
    c = cos[..., :h]
    s = sin[..., :h]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    if n_elem < hs:
        return ltorch.cat([out1, out2, x[..., n_elem:]], -1)
    return ltorch.cat([out1, out2], -1)


class Block(nn.Module):
    def __init__(self, cfg: Config, dtype=torch.float32, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.norm_1 = _norm(cfg, dtype, device)
        self.attn = CausalSelfAttention(cfg, dtype, device, generator)
        self.norm_2 = _norm(cfg, dtype, device)
        self.mlp = {"LLaMAMLP": LLaMAMLP, "GptNeoxMLP": GptNeoxMLP}[cfg.mlp_class_name](
            cfg, dtype, device, generator)

    def forward(self, x, cos, sin):
        h = self.attn(self.norm_1(x), cos, sin)
        if self.cfg.parallel_residual:
            return x + h + self.mlp(self.norm_2(x))
        x = x + h
        return x + self.mlp(self.norm_2(x))


class GPT(nn.Module):
    """The decoder. ``device`` defaults to the card (raising when there is
    none); ``seed`` seeds the ``torch.Generator`` every weight is drawn from."""

    def __init__(self, cfg: Config, dtype=torch.float32, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        # under meta_device() nothing is drawn: a meta tensor ignores the generator
        gen = torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(seed)
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.padded_vocab_size, cfg.n_embd, dtype=dtype, device=device,
                                generator=gen)
        self.h = nn.ModuleList([Block(cfg, dtype, device, gen) for _ in range(cfg.n_layer)])
        self.ln_f = _norm(cfg, dtype, device)
        self.lm_head = nn.Linear(cfg.n_embd, cfg.padded_vocab_size, bias=cfg.lm_head_bias,
                                 dtype=dtype, device=device, generator=gen)
        cos, sin = build_rope_cache(cfg.block_size, cfg.rope_n_elem, cfg.rope_base, dtype, device)
        if device.type == "meta":
            # how MaterializationTransform makes them on the target device
            cos.init_fn = lambda gen: build_rope_cache(cfg.block_size, cfg.rope_n_elem, cfg.rope_base, dtype,
                                                       gen.device)[0]
            sin.init_fn = lambda gen: build_rope_cache(cfg.block_size, cfg.rope_n_elem, cfg.rope_base, dtype,
                                                       gen.device)[1]
        self.register_buffer("cos", cos)
        self.register_buffer("sin", sin)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, idx):
        B, T = idx.shape
        cos, sin = rope_slice(self.cos, self.sin, T)
        x = self.wte(idx)
        for block in self.h:
            if self.cfg.activation_checkpoint:
                x = remat.checkpoint(block)(x, cos, sin)
            else:
                x = block(x, cos, sin)
        x = self.ln_f(x)
        return self.lm_head(x)


class GPTForCausalLM(nn.Module):
    """GPT + cross-entropy loss over (B*T) positions — the pretraining step
    target (thunder_tpu/models/litgpt.py:GPTForCausalLM)."""

    def __init__(self, cfg: Config, dtype=torch.float32, *, device=None, seed: int = 0):
        super().__init__()
        self.gpt = GPT(cfg, dtype, device=device, seed=seed)
        self.cfg = cfg

    def forward(self, idx, targets):
        logits = self.gpt(idx)
        B, T, V = logits.shape
        return ltorch.cross_entropy(
            ltorch.reshape(logits, (B * T, V)), ltorch.reshape(targets, (B * T,)))


def rope_slice(cos_full, sin_full, T: int):
    """Positions [0, T) normally; under context-parallel tracing the rank's
    sequence block [idx*T, (idx+1)*T) — local tokens carry global positions."""
    ctx = current_seq_parallel_ctx()
    if ctx is None:
        return cos_full[:T], sin_full[:T]
    from ..core import prims
    from ..ops import clang
    from ..parallel import prims as dist_prims

    axis, _ = ctx
    n_elem = cos_full.shape[-1]
    offset = dist_prims.axis_index(axis) * T
    cos = prims.dynamic_slice(clang.ensure_proxy(cos_full), (offset, 0), (T, n_elem))
    sin = prims.dynamic_slice(clang.ensure_proxy(sin_full), (offset, 0), (T, n_elem))
    return cos, sin


def build_rope_cache(seq_len: int, n_elem: int, base: int = 10000, dtype=torch.float32,
                     device=None):
    device = resolve_device(device)
    if n_elem <= 0:
        z = torch.zeros((seq_len, 0), dtype=dtype, device=device)
        return z, z
    theta = 1.0 / (base ** (torch.arange(0, n_elem, 2, dtype=torch.float32, device=device) / n_elem))
    seq = torch.arange(seq_len, dtype=torch.float32, device=device)
    idx_theta = torch.outer(seq, theta)  # (T, n_elem/2)
    idx_theta = torch.cat([idx_theta, idx_theta], dim=-1)  # (T, n_elem)
    return torch.cos(idx_theta).to(dtype), torch.sin(idx_theta).to(dtype)


def load_jax_params(model: "GPT | GPTForCausalLM", params: dict) -> None:
    """Load thunder_tpu's weights into the port's model (a GPT, a
    GPTForCausalLM whose names carry the ``gpt.`` prefix, a models.moe.MoEGPT
    or MoEMLP): ``params`` is ``{name: np.asarray(p.data)}`` over the JAX
    model's ``named_parameters()``. Both packages use the same names and the
    (out, in) Linear layout (an MoE layer's router ``moe.gate.weight`` and
    its expert panels ``moe.w_gate`` / ``moe.w_up`` (E, D, H) and
    ``moe.w_down`` (E, H, D) too); the rope buffers are rebuilt by each
    model, not copied, and the MoE routing-health buffers start at zero on
    both sides. A quantized model
    (the same transform applied on both sides) carries its int8 or uint8
    codes and f32 scales as they are; a LoRA model its ``lora_A`` and
    ``lora_B`` adapters (parameters). After FP8TrainingTransform, ``params``
    also holds the ``fp8_amax_x_hist`` / ``fp8_amax_w_hist`` buffers, from
    the JAX model's ``named_buffers()``. Each value must have its
    parameter's (buffer's) dtype and shape: a mismatch raises, nothing is
    cast. The vision models (models/vit.py, models/resnet.py) load here too:
    conv weights are OIHW in both packages, and a ResNet's ``params`` also
    holds its BatchNorm ``running_mean`` / ``running_var`` buffers, from the
    JAX model's ``named_buffers()``."""
    own = dict(model.named_parameters())
    own.update((k, b) for k, b in model.named_buffers() if k.rsplit(".", 1)[-1].startswith("fp8_amax_")
               or k.rsplit(".", 1)[-1] in ("running_mean", "running_var"))
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in own.items():
            a = np.asarray(params[name])
            want = str(p.dtype).replace("torch.", "")
            if a.dtype.name != want:
                raise ValueError(f"{name}: dtype {a.dtype.name} vs {want}")
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(a.shape)} vs {tuple(p.shape)}")
            # numpy has no bfloat16 of its own: bf16 goes through f32, exactly
            v = torch.tensor(a.astype(np.float32) if want == "bfloat16" else a)
            p.copy_(v.to(device=p.device, dtype=p.dtype))


def _key_paths(tree) -> list:
    """The dict keys of ``tree`` in the order jax.tree_util prints them in a
    treedef (sorted at every level, depth first)."""
    if not isinstance(tree, dict):
        return []
    return [x for k in sorted(tree) for x in (k, *_key_paths(tree[k]))]


def load_jax_checkpoint(train_step, stepdir: str, *, loader=None) -> dict:
    """Continue a thunder_tpu run in the port: read one step directory of
    thunder_tpu's ``CheckpointManager`` (robustness/checkpoint_manager.py,
    the flat npz layout of parallel/checkpoint.py) into a port
    ``TrainStep`` whose module has the same parameter names. Written in
    place, as ``CheckpointManager.restore`` writes: the parameters, by
    ``load_jax_params``'s mapping (the same names, dtypes and shapes; the
    fp8 amax histories and BatchNorm running stats among the buffers, the
    rope buffers rebuilt by the model and left alone), the optimizer's
    state (AdamW's m and v, the device step; the step's optimizer state is
    initialized first if it has not run), the step counter and, given a
    ``loader``, its cursor. Returns the checkpoint's meta dict.

    The names are checked against the structure note thunder_tpu writes
    beside the arrays (its treedef, whose dict keys give the flatten
    order). A step directory written through orbax (thunder_tpu with orbax
    installed) or a sharded one has no reader here and raises."""
    import os
    import re

    from ..parallel import checkpoint as ckpt
    from ..robustness.checkpoint_manager import CheckpointError, copy_state_, live_state, read_meta, validate_step

    ok, problems = validate_step(stepdir)
    if not ok:
        raise CheckpointError(f"checkpoint {stepdir} failed validation: {problems}")
    meta = read_meta(stepdir)
    payload = os.path.join(stepdir, "state", "state.npz")
    if not os.path.exists(payload):
        raise CheckpointError(f"{stepdir} holds no state/state.npz: an orbax or sharded layout, which the "
                              f"port does not read (write the checkpoint without orbax)")
    live = live_state(train_step, meta.get("has_opt_state", False))
    with np.load(payload) as data:
        note = str(data["__tt_treedef__"])
    if re.findall(r"'([^']*)':", note) != _key_paths(live):
        raise KeyError(f"{stepdir}: the checkpoint's state tree is not this step's "
                       f"(checkpoint {note[:300]}...)")
    state = ckpt.load(os.path.dirname(payload), like=live)
    kept = {k for k in live["buffers"] if k.rsplit(".", 1)[-1].startswith("fp8_amax_")
            or k.rsplit(".", 1)[-1] in ("running_mean", "running_var")}
    copy_state_({k: v for k, v in live.items() if k != "buffers"},
                {k: v for k, v in state.items() if k != "buffers"})
    copy_state_({k: live["buffers"][k] for k in kept}, {k: state["buffers"][k] for k in kept})
    train_step._step_count = int(meta["step"])
    if loader is not None and meta.get("loader") is not None:
        loader.load_state_dict(meta["loader"])
    return meta


def name_to_config(name: str) -> dict:
    return configs[name]
