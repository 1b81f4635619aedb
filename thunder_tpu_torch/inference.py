"""Dense KV-cached generation, and the block plumbing serving shares.

The port of thunder_tpu/inference.py. ``cached_sdpa``, ``split_qkv_rope``
and ``block_mix`` are the per-block pieces the paged serving runner
(serving/runner.py) reuses, so solo and batched decoding run the same block
math. ``GPTInference.generate`` decodes greedily or, with a temperature,
samples position-keyed draws (serving/sampling.py) that give the serving
engine's stream for the same seed. With ``scan_decode=True`` (the default,
as in thunder_tpu) every greedy decode step of a call is one CUDA graph on
the card (thunder_tpu scans the steps into one XLA program); a sampled call,
and ``False``, loop in Python over the compiled decode step.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .core import dtypes, prims
from .executors import graphex
from .ops import clang, ltorch


@dataclass
class GenerationMetrics:
    """TTFT/TBOT/throughput of one generate() call, plus the margin between
    the top two logits at each greedy choice (where a tie could flip) and,
    for a sampled call, each draw's margin (serving/sampling.sample_tokens:
    how far its uniform lay from the nearer edge of the token's interval,
    as a share of the total probability)."""

    ttft_s: float = 0.0
    tbot_s: float = 0.0
    tokens_per_sec: float = 0.0
    ms_per_token: float = 0.0
    n_new_tokens: int = 0
    top2_gap: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float32))
    sample_margin: np.ndarray = field(default_factory=lambda: np.zeros((0, 0), np.float64))


class KVCache:
    """Per-layer static-shape KV cache (B, Hkv, max_seq, head_dim)."""

    def __init__(self, n_layer: int, batch: int, n_kv_heads: int, max_seq: int, head_dim: int,
                 dtype=torch.bfloat16, device=None):
        shape = (batch, n_kv_heads, max_seq, head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer)]

    def as_tuple(self):
        return tuple(self.k), tuple(self.v)


def cached_sdpa(q, k_cache, v_cache, pos, scale=None):
    """Attention against the cache prefix [0, pos+q_len); pos may be a traced
    0-d tensor so the same compiled decode step serves every position. The
    position vectors are iotas on q's device (thunder_tpu bakes them as
    constant arrays)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kt = clang.matrix_transpose(k_cache)
    scores = ltorch.matmul(q, kt) * scale
    Lq = q.shape[-2]
    Lk = k_cache.shape[-2]
    q_pos = prims.iota(Lq, dtype=dtypes.int32, device=q.device)
    if isinstance(pos, int):
        q_pos = q_pos + pos
    else:
        q_pos = q_pos + ltorch.reshape(pos, (1,))
    k_pos = prims.iota(Lk, dtype=dtypes.int32, device=q.device)
    mask = ltorch.le(clang.unsqueeze(k_pos, 0), clang.unsqueeze(q_pos, 1))
    scores = ltorch.where(mask, scores, float("-inf"))
    probs = ltorch.softmax(scores, -1)
    probs = clang.maybe_convert_to_dtype(probs, v_cache.dtype)
    return ltorch.matmul(probs, v_cache)


def split_qkv_rope(block, cfg, x_n, cos, sin):
    """Project + split + rope one block's q/k/v for T tokens: the per-block
    attention-input plumbing shared by the dense decode engine below and the
    paged serving runner. Returns q (B, nh, T, hs), k/v (B, ng, T, hs)."""
    from .models.litgpt import _apply_rope

    B, T, _ = x_n.shape
    nh, ng, hs = cfg.n_head, cfg.n_query_groups, cfg.head_size
    q_per_kv = nh // ng
    qkv = block.attn.attn(x_n)
    qkv = ltorch.reshape(qkv, (B, T, ng, q_per_kv + 2, hs))
    q = ltorch.reshape(qkv[:, :, :, :q_per_kv, :], (B, T, nh, hs))
    k = ltorch.reshape(qkv[:, :, :, q_per_kv: q_per_kv + 1, :], (B, T, ng, hs))
    v = ltorch.reshape(qkv[:, :, :, q_per_kv + 1:, :], (B, T, ng, hs))
    q = ltorch.permute(q, (0, 2, 1, 3))
    k = ltorch.permute(k, (0, 2, 1, 3))
    v = ltorch.permute(v, (0, 2, 1, 3))
    q = _apply_rope(q, cos, sin, cfg.rope_n_elem)
    k = _apply_rope(k, cos, sin, cfg.rope_n_elem)
    return q, k, v


def block_mix(block, cfg, x, h):
    """Residual + MLP (or MoE) tail of one block (the other half of the
    shared plumbing; see split_qkv_rope). A models.moe.MoEBlock is always a
    sequential residual, whatever cfg.parallel_residual says."""
    mlp = getattr(block, "mlp", None)
    if mlp is None:
        mlp = block.moe
    elif cfg.parallel_residual:
        return x + h + mlp(block.norm_2(x))
    x = x + h
    return x + mlp(block.norm_2(x))


class GPTInference:
    """Generation over a models.litgpt.GPT or a models.moe.MoEGPT
    with a dense KV cache, on the model's device. The blocks run manually
    so attention reads the cache; prefill and decode are two compiled
    programs, and decode takes its position as a 0-d int32 tensor so one
    program serves every step."""

    def __init__(self, gpt, *, max_seq: Optional[int] = None, dtype=torch.bfloat16):
        from . import jit
        from .nn.module import functional_params

        self.gpt = gpt
        self.cfg = gpt.cfg
        self.max_seq = max_seq or self.cfg.block_size
        self.dtype = dtype

        def prefill(params, idx, ks, vs):
            with functional_params(gpt, params):
                return self._forward_cached(idx, ks, vs, 0)

        def decode(params, idx, ks, vs, pos):
            with functional_params(gpt, params):
                return self._forward_cached(idx, ks, vs, pos)

        prefill.__name__ = "prefill"
        decode.__name__ = "decode"
        self._prefill_cfn = jit(prefill)
        self._decode_cfn = jit(decode)
        self._scan_programs: dict = {}  # (steps, batch, dtype) -> graphex.CUDAGraphProgram

    def _forward_cached(self, idx, ks, vs, pos):
        """idx (B, T); ks/vs per-layer cache tuples; pos: start position —
        a python int (prefill) or a 0-d int32 tensor (decode)."""
        from .models.litgpt import _repeat_kv

        cfg = self.cfg
        gpt = self.gpt
        B, T = idx.shape
        n_elem = cfg.rope_n_elem
        cos = prims.dynamic_slice(clang.ensure_proxy(gpt.cos), (pos, 0), (T, n_elem))
        sin = prims.dynamic_slice(clang.ensure_proxy(gpt.sin), (pos, 0), (T, n_elem))
        x = gpt.wte(idx)
        new_ks, new_vs = [], []
        nh, ng = cfg.n_head, cfg.n_query_groups
        q_per_kv = nh // ng
        for li, block in enumerate(gpt.h):
            q, k, v = split_qkv_rope(block, cfg, block.norm_1(x), cos, sin)
            k_cache = prims.dynamic_update_slice(ks[li], k, (0, 0, pos, 0))
            v_cache = prims.dynamic_update_slice(vs[li], v, (0, 0, pos, 0))
            new_ks.append(k_cache)
            new_vs.append(v_cache)
            kq = _repeat_kv(k_cache, q_per_kv) if ng != nh else k_cache
            vq = _repeat_kv(v_cache, q_per_kv) if ng != nh else v_cache
            y = cached_sdpa(q, kq, vq, pos)
            y = ltorch.reshape(ltorch.permute(y, (0, 2, 1, 3)), (B, T, nh * cfg.head_size))
            x = block_mix(block, cfg, x, block.attn.proj(y))
        x = gpt.ln_f(x)
        logits = gpt.lm_head(x[:, -1])  # only the last position is needed
        return logits, tuple(new_ks), tuple(new_vs)

    def _scan_program(self, params: dict, n_steps: int, tok, ks, vs, pos):
        """The whole greedy decode loop as one CUDA graph (thunder_tpu's
        _build_scan_decode; its _scan_sig is the key): n_steps decode
        programs, each followed by its argmax and its top-2 gap, taking the
        first token, the prefill's caches and the first position. Made at
        the first call of a (steps, batch, dtype) signature after one decode
        call on these inputs has compiled and warmed the decode entry
        (outputs dropped; the caches are not written). The caches are
        copied into the graph's own each call, so one graph serves every
        call of its signature; the parameters are read in place."""
        sig = (n_steps, tok.shape[0], tok.dtype)
        prog = self._scan_programs.get(sig)
        if prog is not None:
            return prog
        self._decode_cfn(params, tok[:, None], ks, vs, pos)
        graphex.check_capturable(self._decode_cfn._cs.last_traces[-1], "GPTInference decode")
        names = list(params)
        n_kv = len(ks)

        def scan(tok, pos, *flat):
            ks, vs = flat[:n_kv], flat[n_kv:2 * n_kv]
            p = dict(zip(names, flat[2 * n_kv:]))
            toks, gaps = [], []
            for i in range(n_steps):
                logits, ks, vs = self._decode_cfn(p, tok[:, None], ks, vs, pos + i)
                top2 = torch.topk(logits.float(), 2, dim=-1).values
                gaps.append(top2[:, 0] - top2[:, 1])
                tok = torch.argmax(logits, -1).to(tok.dtype)
                toks.append(tok)
            return torch.stack(toks, dim=1), torch.stack(gaps, dim=1)

        prog = self._scan_programs[sig] = graphex.CUDAGraphProgram(
            scan, name="GPTInference scan_decode", in_place=[False] * (2 + 2 * n_kv) + [True] * len(names),
            pool=graphex.GraphPool(), stats=self._decode_cfn._cs, warmup=0)
        return prog

    def generate(self, prompt, max_new_tokens: int = 32, *, temperature: float = 0.0,
                 seed: Optional[int] = None, scan_decode: bool = True):
        """prompt: (B, T) int tensor or array. Returns (tokens (B, T+max_new)
        on the model's device, metrics). ``scan_decode`` (greedy only):
        on the card all decode steps run as one CUDA graph, one replay a
        call; CPU tensors, and ``scan_decode=False``, loop over the decode
        program in Python.

        ``temperature`` > 0 samples: the token at position p of row b draws
        the Philox uniform of counter (p, b) under key ``seed`` mod 2^32 (0
        when None), so row 0 (and a B=1 call) is the serving engine's stream
        for a request with that seed."""
        from .serving.sampling import canonical_seed, philox_uniform, sample_tokens

        if not temperature >= 0.0:
            raise ValueError(f"temperature={temperature} must be >= 0")
        cfg = self.cfg
        dev = self.gpt.lm_head.weight.device
        prompt = torch.as_tensor(prompt, device=dev)
        B, T = prompt.shape
        if T + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt_len={T} + max_new_tokens={max_new_tokens} exceeds "
                f"max_seq={self.max_seq}; build the engine with a larger max_seq")
        params = {k: p.detach() for k, p in self.gpt.named_parameters()}
        ks, vs = KVCache(cfg.n_layer, B, cfg.n_query_groups, self.max_seq, cfg.head_size,
                         self.dtype, dev).as_tuple()

        sampled = temperature > 0.0
        if sampled:
            key = canonical_seed(seed if seed is not None else 0)
            temps = torch.full((B,), float(temperature), dtype=torch.float32, device=dev)
        t_start = time.perf_counter()
        logits, ks, vs = self._prefill_cfn(params, prompt, ks, vs)
        toks, gaps, margins = [], [], []

        def pick(logits, pos: int):
            """The token at position ``pos`` from the logits before it."""
            top2 = torch.topk(logits.float(), 2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            if sampled:
                u = torch.from_numpy(philox_uniform(key, pos, np.arange(B))).to(dev)
                tok, margin = sample_tokens(logits, u, temps)
                margins.append(margin)
            else:
                tok = torch.argmax(logits, -1)
            toks.append(tok.to(prompt.dtype))
            return toks[-1]

        nxt = pick(logits, T)
        nxt.cpu()  # the first token is out when the host can read it
        ttft = time.perf_counter() - t_start
        t_decode = time.perf_counter()
        n_steps = max_new_tokens - 1
        if scan_decode and not sampled and n_steps > 0 and graphex.captures_on(dev):
            pos = torch.tensor(T, dtype=torch.int32, device=dev)
            prog = self._scan_program(params, n_steps, nxt, ks, vs, pos)
            scan_toks, scan_gaps = prog(nxt, pos, *ks, *vs, *params.values())
            out = torch.cat([prompt, nxt[:, None], scan_toks], dim=1)
            top2_gap = torch.cat([gaps[0][:, None], scan_gaps], dim=1).cpu().numpy()  # waits for the replay
        else:
            for i in range(n_steps):
                pos = torch.tensor(T + i, dtype=torch.int32, device=dev)
                logits, ks, vs = self._decode_cfn(params, nxt[:, None], ks, vs, pos)
                # the step wrote position T + i; its token takes T + i + 1
                nxt = pick(logits, T + i + 1)
            out = torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
            top2_gap = torch.stack(gaps, dim=1).cpu().numpy()  # waits for the last step
        dt = time.perf_counter() - t_decode
        metrics = GenerationMetrics(
            ttft_s=ttft,
            tbot_s=dt / max(1, n_steps),
            tokens_per_sec=B * max_new_tokens / (ttft + dt),
            ms_per_token=1e3 * (ttft + dt) / max_new_tokens,
            n_new_tokens=max_new_tokens,
            top2_gap=top2_gap,
        )
        if sampled:
            metrics.sample_margin = torch.stack(margins, dim=1).cpu().numpy()
        return out, metrics
