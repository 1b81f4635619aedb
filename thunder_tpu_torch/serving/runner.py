"""Paged model programs: bucketed prefill, the packed decode step, chunked
prefill and the speculative verify step; and the weight-only quantization
applied before they are traced (``quantize_for_serving``).

The port of thunder_tpu/serving/runner.py: the GPT module structure is
reused and the blocks run manually under the port's jit, with the KV state
in the shared page pool (kv_pages.py).

* prefill — per prompt-length BUCKET (power of two): dense causal attention
  over the padded prompt, page write-out of the prompt's K/V, logits at the
  true last token. One specialization per bucket.
* decode — ONE program for the whole engine: every active sequence
  contributes one token; k/v land in the pool at (page_table[pos//ps],
  pos%ps) via a batched index_put and attention runs over the pages
  (ltorch.paged_attention, claimed by the cuda executor's kernel).
* chunk_prefill — one CHUNK of a long (or prefix-shared) prompt: page-
  aligned writes starting at an arbitrary page boundary `start_pos`, then
  write-then-attend paged attention (ltorch.paged_chunk_attention, claimed
  by the cuda executor's paged chunk kernel) so the chunk's queries see the
  previously written pages (including pages SHARED from the prefix cache)
  and their own chunk. One specialization per chunk rung.
* verify — the speculative-decoding target step: k+1 tokens per packed
  sequence (the current token plus k draft proposals) in ONE program with
  logits at every position. Rolled-back positions are never committed;
  their page slots hold stale values that the next committed token
  overwrites.

Pools go in and updated pools come out, as in thunder_tpu; the port writes
them in place (executors/passes.py:write_dead_inputs_in_place), so the
returned pools are the tensors passed in: in every program each pool input
is read only by its index_put, and attention reads the index_put's output.
Positions (start_pos, last_rel, pos) are 0-d or 1-d int32 tensors, never
Python ints, so no position recompiles or syncs.

With ``cuda_graphs=True`` every program runs on the card as a CUDA graph
(executors/graphex.py), all of a runner's programs, and those of other
runners given the same ``graph_pool``, in one memory pool: the engine runs
them one at a time. Parameters and pools are read and written in place,
the other inputs are copied into the graphs' buffers, logits come back as
clones.
"""
from __future__ import annotations

from typing import Optional

from ..core import dtypes, prims
from ..inference import block_mix, cached_sdpa, split_qkv_rope
from ..ops import clang, ltorch
from ..transforms.quantization import QuantizeInt8Transform


def quantize_for_serving(gpt, mode: Optional[str]):
    """Apply weight-only quantization to a GPT before its paged programs are
    traced. ``mode``: None/``"none"`` is a no-op; ``"int8"`` swaps every
    Linear's weights for symmetric per-output-channel int8 + f32 scales
    (transforms/quantization.py), so the decode step's linears run the
    int8 kernel (csrc/int8_linear.cu) with the weights int8 in device memory.

    Must run BEFORE PagedGPTRunner traces the programs and before the engine
    snapshots ``named_parameters``: both see the quantized module."""
    if mode in (None, "none"):
        return gpt
    if mode != "int8":
        raise ValueError(f"unknown serving quantization mode: {mode!r}")
    QuantizeInt8Transform().transform_module(gpt)
    return gpt


class PagedGPTRunner:
    """Traces and caches the paged serving programs for one GPT."""

    def __init__(self, gpt, *, page_size: int, cuda_graphs: bool = False, graph_pool=None):
        from .. import jit
        from ..nn.module import functional_params

        self.gpt = gpt
        self.cfg = gpt.cfg
        self.page_size = page_size

        def prefill(params, idx, page_ids, kps, vps, last_pos):
            with functional_params(gpt, params):
                return self._forward_prefill(idx, page_ids, kps, vps, last_pos)

        def decode(params, toks, kps, vps, page_table, pos):
            with functional_params(gpt, params):
                return self._forward_decode(toks, kps, vps, page_table, pos)

        def chunk_prefill(params, idx, page_table_row, kps, vps, start_pos, last_rel):
            with functional_params(gpt, params):
                return self._forward_chunk(idx, page_table_row, kps, vps, start_pos, last_rel)

        def verify(params, toks, kps, vps, page_table, pos):
            with functional_params(gpt, params):
                return self._forward_verify(toks, kps, vps, page_table, pos)

        prefill.__name__ = "serve_prefill"
        decode.__name__ = "serve_decode"
        chunk_prefill.__name__ = "serve_chunk_prefill"
        verify.__name__ = "serve_verify"
        graphs = dict(cuda_graphs=cuda_graphs, graph_pool=graph_pool)
        self.prefill_cfn = jit(prefill, **graphs)
        self.decode_cfn = jit(decode, **graphs)
        self.chunk_cfn = jit(chunk_prefill, **graphs)
        self.verify_cfn = jit(verify, **graphs)

    # -- prefill ----------------------------------------------------------
    def _forward_prefill(self, idx, page_ids, kps, vps, last_pos):
        """idx (1, Lb) bucketed prompt; page_ids (Lb/page_size,) pages to
        write; last_pos 0-d int32 — the true last token. Returns
        (logits (1, V), k pools, v pools). Padding tokens beyond last_pos
        write garbage K/V into the tail pages — causality keeps them out of
        every real token's attention and seq_lens masks them out of later
        paged decode."""
        from ..models.litgpt import _repeat_kv

        cfg = self.cfg
        gpt = self.gpt
        B, T = idx.shape
        ps = self.page_size
        cos = clang.ensure_proxy(gpt.cos)[:T]
        sin = clang.ensure_proxy(gpt.sin)[:T]
        q_per_kv = cfg.n_head // cfg.n_query_groups
        x = gpt.wte(idx)
        new_kps, new_vps = [], []
        for li, block in enumerate(gpt.h):
            q, k, v = split_qkv_rope(block, cfg, block.norm_1(x), cos, sin)
            # page write-out: (1, Hkv, T, hs) -> (T//ps, ps, Hkv, hs) blocks
            k_blocks = ltorch.reshape(ltorch.permute(k, (0, 2, 1, 3)),
                                      (T // ps, ps, cfg.n_query_groups, cfg.head_size))
            v_blocks = ltorch.reshape(ltorch.permute(v, (0, 2, 1, 3)),
                                      (T // ps, ps, cfg.n_query_groups, cfg.head_size))
            new_kps.append(ltorch.index_put(kps[li], (page_ids,), k_blocks))
            new_vps.append(ltorch.index_put(vps[li], (page_ids,), v_blocks))
            kq = _repeat_kv(k, q_per_kv) if cfg.n_query_groups != cfg.n_head else k
            vq = _repeat_kv(v, q_per_kv) if cfg.n_query_groups != cfg.n_head else v
            y = cached_sdpa(q, kq, vq, 0)
            y = ltorch.reshape(ltorch.permute(y, (0, 2, 1, 3)),
                               (B, T, cfg.n_head * cfg.head_size))
            x = block_mix(block, cfg, x, block.attn.proj(y))
        # logits at the TRUE last token (the bucket pads past it)
        x_last = prims.dynamic_slice(x, (0, last_pos, 0), (B, 1, cfg.n_embd))
        logits = gpt.lm_head(gpt.ln_f(x_last))[:, 0]
        return logits, tuple(new_kps), tuple(new_vps)

    # -- decode -----------------------------------------------------------
    def _forward_decode(self, toks, kps, vps, page_table, pos):
        """toks (Bcap, 1) current tokens; page_table (Bcap, n_pages_max)
        int32; pos (Bcap,) int32 — each sequence's write position (= tokens
        already cached; idle slots carry pos 0 and a null-page row).
        Returns (logits (Bcap, V), k pools, v pools). Positions past the
        table's coverage clamp the rope gather and write to the null page."""
        cfg = self.cfg
        gpt = self.gpt
        B, T = toks.shape  # T == 1
        ps = self.page_size
        rope_rows = gpt.cos.shape[0]
        pos_r = ltorch.clamp(pos, max=rope_rows - 1)
        # per-sequence rope rows: gather cos/sin at each slot's position
        cos = ltorch.reshape(clang.take(clang.ensure_proxy(gpt.cos), pos_r, 0),
                             (B, 1, 1, cfg.rope_n_elem))
        sin = ltorch.reshape(clang.take(clang.ensure_proxy(gpt.sin), pos_r, 0),
                             (B, 1, 1, cfg.rope_n_elem))
        npm = page_table.shape[1]
        in_bounds = ltorch.lt(pos, npm * ps)
        page_of = ltorch.gather(page_table, 1, ltorch.reshape(
            ltorch.floor_divide(ltorch.clamp(pos, max=npm * ps - 1), ps),
            (B, 1)))[:, 0]  # (B,) page id
        page_of = ltorch.where(in_bounds, page_of, 0)
        slot = ltorch.remainder(pos, ps)
        seq_lens = pos + 1  # attention covers the token being written
        x = gpt.wte(toks)
        new_kps, new_vps = [], []
        for li, block in enumerate(gpt.h):
            q, k, v = split_qkv_rope(block, cfg, block.norm_1(x), cos, sin)
            k_tok = ltorch.reshape(ltorch.permute(k, (0, 2, 1, 3)),
                                   (B, cfg.n_query_groups, cfg.head_size))
            v_tok = ltorch.reshape(ltorch.permute(v, (0, 2, 1, 3)),
                                   (B, cfg.n_query_groups, cfg.head_size))
            kp = ltorch.index_put(kps[li], (page_of, slot), k_tok)
            vp = ltorch.index_put(vps[li], (page_of, slot), v_tok)
            new_kps.append(kp)
            new_vps.append(vp)
            q3 = ltorch.reshape(q, (B, cfg.n_head, cfg.head_size))
            y = ltorch.paged_attention(q3, kp, vp, page_table, seq_lens)
            y = ltorch.reshape(y, (B, 1, cfg.n_head * cfg.head_size))
            x = block_mix(block, cfg, x, block.attn.proj(y))
        logits = gpt.lm_head(gpt.ln_f(x[:, -1]))
        return logits, tuple(new_kps), tuple(new_vps)

    # -- chunked prefill --------------------------------------------------
    def _forward_chunk(self, idx, page_table_row, kps, vps, start_pos, last_rel):
        """idx (1, Cb) one page-aligned chunk of a prompt (Cb a multiple of
        page_size); page_table_row (1, n_pages_max) the sequence's FULL page
        table; start_pos 0-d int32 (a multiple of page_size) — the chunk's
        absolute first position; last_rel 0-d int32 — the true last prompt
        token RELATIVE to the chunk (only meaningful on the final chunk).
        Returns (logits (1, V), k pools, v pools).

        The chunk WRITES its pages first and then attends the whole table
        with per-query coverage k_pos <= start_pos + t, so it sees every
        previously written page — including pages shared from the prefix
        cache; the chunk itself only ever writes UNSHARED pages, because
        shared coverage always ends at or before the chunk start. The page
        slice clamps its start as jax does: the scheduler keeps every chunk
        inside max_seq (its exact page-aligned fallback), so the clamp never
        moves a write. Pad tokens past `last_rel` on the final chunk write
        garbage K/V into reserved-but-unused slots; every real query masks
        them out by position, and decode overwrites each slot before any
        mask admits it."""
        cfg = self.cfg
        gpt = self.gpt
        B, T = idx.shape  # B == 1
        ps = self.page_size
        n_elem = cfg.rope_n_elem
        cos = prims.dynamic_slice(clang.ensure_proxy(gpt.cos), (start_pos, 0), (T, n_elem))
        sin = prims.dynamic_slice(clang.ensure_proxy(gpt.sin), (start_pos, 0), (T, n_elem))
        chunk_pages = ltorch.reshape(
            prims.dynamic_slice(page_table_row, (0, ltorch.floor_divide(start_pos, ps)),
                                (1, T // ps)), (T // ps,))
        q_pos = ltorch.reshape(
            prims.iota(T, dtype=dtypes.int32, device=idx.device) + start_pos, (1, T))
        x = gpt.wte(idx)
        new_kps, new_vps = [], []
        for li, block in enumerate(gpt.h):
            q, k, v = split_qkv_rope(block, cfg, block.norm_1(x), cos, sin)
            k_blocks = ltorch.reshape(ltorch.permute(k, (0, 2, 1, 3)),
                                      (T // ps, ps, cfg.n_query_groups, cfg.head_size))
            v_blocks = ltorch.reshape(ltorch.permute(v, (0, 2, 1, 3)),
                                      (T // ps, ps, cfg.n_query_groups, cfg.head_size))
            kp = ltorch.index_put(kps[li], (chunk_pages,), k_blocks)
            vp = ltorch.index_put(vps[li], (chunk_pages,), v_blocks)
            new_kps.append(kp)
            new_vps.append(vp)
            y = ltorch.paged_chunk_attention(q, kp, vp, page_table_row, q_pos)
            y = ltorch.reshape(ltorch.permute(y, (0, 2, 1, 3)), (B, T, cfg.n_head * cfg.head_size))
            x = block_mix(block, cfg, x, block.attn.proj(y))
        x_last = prims.dynamic_slice(x, (0, last_rel, 0), (B, 1, cfg.n_embd))
        logits = gpt.lm_head(gpt.ln_f(x_last))[:, 0]
        return logits, tuple(new_kps), tuple(new_vps)

    # -- speculative verify -----------------------------------------------
    def _forward_verify(self, toks, kps, vps, page_table, pos):
        """toks (Bcap, k+1): each sequence's current token followed by its k
        draft proposals; pos (Bcap,) int32 — the position of toks[:, 0].
        Writes k/v for ALL k+1 tokens at positions pos..pos+k and returns
        (logits (Bcap, k+1, V), k pools, v pools) — logits at every
        position, so ONE packed target step scores every proposal.

        Writes past the table's coverage (proposals past the max_seq cap)
        redirect to the null page — several may land on the same null slot,
        which is harmless only because page 0 is never unmasked — and rope
        gathers clamp; those positions' logits are garbage and the accept
        rule never commits them."""
        cfg = self.cfg
        gpt = self.gpt
        B, K1 = toks.shape
        ps = self.page_size
        npm = page_table.shape[1]
        n_elem = cfg.rope_n_elem
        rope_rows = gpt.cos.shape[0]
        offs = prims.iota(K1, dtype=dtypes.int32, device=toks.device)
        pos_mat = ltorch.reshape(pos, (B, 1)) + ltorch.reshape(offs, (1, K1))  # (B, K1)
        flat_pos = ltorch.reshape(ltorch.clamp(pos_mat, max=rope_rows - 1), (B * K1,))
        cos = ltorch.reshape(clang.take(clang.ensure_proxy(gpt.cos), flat_pos, 0),
                             (B, 1, K1, n_elem))
        sin = ltorch.reshape(clang.take(clang.ensure_proxy(gpt.sin), flat_pos, 0),
                             (B, 1, K1, n_elem))
        in_bounds = ltorch.lt(pos_mat, npm * ps)
        page_of = ltorch.gather(page_table, 1, ltorch.floor_divide(
            ltorch.clamp(pos_mat, max=npm * ps - 1), ps))
        page_of = ltorch.where(in_bounds, page_of, 0)
        page_flat = ltorch.reshape(page_of, (B * K1,))
        slot_flat = ltorch.reshape(ltorch.remainder(pos_mat, ps), (B * K1,))
        x = gpt.wte(toks)
        new_kps, new_vps = [], []
        for li, block in enumerate(gpt.h):
            q, k, v = split_qkv_rope(block, cfg, block.norm_1(x), cos, sin)
            k_tok = ltorch.reshape(ltorch.permute(k, (0, 2, 1, 3)),
                                   (B * K1, cfg.n_query_groups, cfg.head_size))
            v_tok = ltorch.reshape(ltorch.permute(v, (0, 2, 1, 3)),
                                   (B * K1, cfg.n_query_groups, cfg.head_size))
            kp = ltorch.index_put(kps[li], (page_flat, slot_flat), k_tok)
            vp = ltorch.index_put(vps[li], (page_flat, slot_flat), v_tok)
            new_kps.append(kp)
            new_vps.append(vp)
            y = ltorch.paged_chunk_attention(q, kp, vp, page_table, pos_mat)
            y = ltorch.reshape(ltorch.permute(y, (0, 2, 1, 3)), (B, K1, cfg.n_head * cfg.head_size))
            x = block_mix(block, cfg, x, block.attn.proj(y))
        logits = gpt.lm_head(gpt.ln_f(x))  # (B, K1, V)
        return logits, tuple(new_kps), tuple(new_vps)
