"""The flash-attention forward's two stages (csrc/flash_fwd_sm90.cu) as
plain PyTorch on the CPU: the prologue (q and k roped in f32 and rounded to
the input dtype) and the core (flash_attention_plain on the roped q and k).
Composed, they must give flash_rope_attention_plain's numbers to the last
bit, in f32 and bf16, and pallasex's flash_rope_attention_forward and
flash_attention_forward in interpret mode at their f32 bar (2e-3, as
test_torch_kernels.py holds the plain version). Also the wrapper's plan of
scratch and blocks, as a function of the shapes."""
import math

import numpy as np
import pytest
import torch

from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models.litgpt import build_rope_cache

PALLAS_TOL = 2e-3
# (Hkv, causal, rope) at B=1, H=4, T=128, D=32: MHA and GQA, causal and full
PALLAS_CASES = [(4, True, True), (2, True, True), (2, False, False), (4, True, False)]
PALLAS_IDS = ["mha-rope", "gqa-rope", "gqa-full", "mha-causal"]


def _numpy_inputs(B, H, Hkv, T, D, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, T, D).astype(np.float32)
    k, v = (rng.randn(B, Hkv, T, D).astype(np.float32) for _ in range(2))
    cos, sin = (a.numpy() for a in build_rope_cache(T, D, 10000, torch.float32, "cpu"))
    return q, k, v, cos, sin


@pytest.fixture(scope="module")
def pallas_out():
    """pallasex's forwards (interpret mode on the CPU, under jax.jit) at
    PALLAS_CASES: case -> (inputs, o, lse)."""
    import jax
    import jax.numpy as jnp

    from thunder_tpu.executors import pallasex

    B, H, T, D = 1, 4, 128, 32
    scale = 1.0 / math.sqrt(D)
    rope_fwd = jax.jit(lambda *a, causal: pallasex.flash_rope_attention_forward(*a, causal=causal, scale=scale),
                       static_argnames="causal")
    fwd = jax.jit(lambda *a, causal: pallasex.flash_attention_forward(*a, causal=causal, scale=scale),
                  static_argnames="causal")
    out = {}
    for i, (Hkv, causal, rope) in enumerate(PALLAS_CASES):
        a = _numpy_inputs(B, H, Hkv, T, D, seed=i)
        j = [jnp.asarray(x) for x in a]
        o, lse = rope_fwd(*j, causal=causal) if rope else fwd(*j[:3], causal=causal)
        out[(Hkv, causal, rope)] = (a, np.asarray(o), np.asarray(lse))
    return out


def _inputs(B, H, Hkv, T, D, dtype, seed=0):
    return tuple(torch.tensor(a).to(dtype) if i < 3 else torch.tensor(a)
                 for i, a in enumerate(_numpy_inputs(B, H, Hkv, T, D, seed)))


def _composed(q, k, v, cos, sin, causal, scale=None):
    """prologue -> core, as the card runs them (no prologue without cos)."""
    if cos is not None:
        q, k = cudaex.flash_forward_prologue_plain(q, k, cos, sin)
    return cudaex.flash_attention_plain(q, k, v, causal, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,T,D,causal", [
    (1, 2, 2, 40, 16, True), (2, 4, 2, 33, 24, False), (1, 4, 1, 17, 32, True)],
    ids=["mha", "gqa-full-d24", "mqa"])
def test_stages_compose_to_the_plain_forward_bit_for_bit(dtype, B, H, Hkv, T, D, causal):
    q, k, v, cos, sin = _inputs(B, H, Hkv, T, D, dtype)
    got = _composed(q, k, v, cos, sin, causal)
    want = cudaex.flash_rope_attention_plain(q, k, v, cos, sin, causal)
    for name, a, b in zip(("o", "lse"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got[0].dtype == dtype


def test_prologue_ropes_q_and_k_once_and_rounds_them():
    q, k, v, cos, sin = _inputs(1, 4, 2, 24, 16, torch.bfloat16, seed=3)
    qr, kr = cudaex.flash_forward_prologue_plain(q, k, cos, sin)
    assert qr.dtype == kr.dtype == torch.bfloat16
    assert torch.equal(qr, cudaex._rope_plain(q.float(), cos, sin).to(torch.bfloat16))
    assert torch.equal(kr, cudaex._rope_plain(k.float(), cos, sin).to(torch.bfloat16))


@pytest.mark.parametrize("Hkv,causal,rope", PALLAS_CASES, ids=PALLAS_IDS)
def test_composition_matches_pallas_interpret(pallas_out, Hkv, causal, rope):
    (q, k, v, cos, sin), jo, jlse = pallas_out[(Hkv, causal, rope)]
    t = [torch.tensor(a) for a in (q, k, v, cos, sin)]
    o, lse = _composed(*t[:3], *(t[3:] if rope else (None, None)), causal, 1.0 / math.sqrt(q.shape[-1]))
    np.testing.assert_allclose(o.numpy(), jo, atol=PALLAS_TOL, rtol=PALLAS_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=PALLAS_TOL, rtol=PALLAS_TOL)


def test_plan_fills_the_card_at_llama_1b_gqa():
    """The persistent core runs one block an SM: llama-1b's GQA shape has 16 x
    16 = 256 tiles of 128 queries, enough for all of the card's 132 SMs."""
    plan = cudaex.flash_forward_plan(1, 16, 4, 2048, 128, torch.bfloat16, rope=True)
    assert plan["tiles"] == 256 and plan["blocks"] == 132


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("args,rope,tiles,blocks,scratch", [
    # llama-350m's training shape: q's 64 slabs, then k's 64, roped
    ((4, 16, 16, 2048, 64, BF16), True, 1024, 132, {"qk_roped": ((128, 2048, 64), BF16)}),
    # llama-1b's GQA shape: 16 q slabs and 4 k slabs
    ((1, 16, 4, 2048, 128, BF16), True, 256, 132, {"qk_roped": ((20, 2048, 128), BF16)}),
    # NanoGPT-124M's sdpa: no RoPE, no prologue, no scratch
    ((8, 12, 12, 1024, 64, BF16), False, 768, 132, {}),
    # fp16 at a ragged T: whole 128-query tiles, fewer than the SMs
    ((2, 4, 2, 77, 96, torch.float16), True, 8, 8, {"qk_roped": ((12, 77, 96), torch.float16)}),
    # f32: the mma.sync/FMA kernel, a block per 64-query tile, roping its own tiles
    ((2, 4, 2, 200, 32, F32), True, 32, 32, {}),
], ids=["llama-350m", "llama-1b-gqa", "nanogpt", "f16-ragged", "f32"])
def test_plan(args, rope, tiles, blocks, scratch):
    plan = cudaex.flash_forward_plan(*args, rope=rope)
    assert (plan["tiles"], plan["blocks"], plan["scratch"]) == (tiles, blocks, scratch)
    assert plan["scratch_bytes"] == sum(math.prod(s) * dt.itemsize for s, dt in scratch.values())


def test_plan_blocks_follow_the_cards_sms():
    assert cudaex.flash_forward_plan(4, 16, 16, 2048, 64, BF16, sms=114)["blocks"] == 114
