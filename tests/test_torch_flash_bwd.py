"""The flash-attention backward's three stages (csrc/flash_bwd_sm90.cu) as
plain PyTorch on the CPU: the prologue (roped q/k rounded to the input
dtype, do rounded to q's dtype, delta = rowsum(do·o) in f32), the products
on the roped q/k in f32, and the epilogue (the RoPE VJP on the f32
accumulators, then rounding). Composed, they must give
flash_rope_attention_backward_plain's numbers to the last bit, in f32 and
bf16, and pallasex's flash_rope_attention_backward in interpret mode at its
f32 bar (5e-3, as test_torch_kernels.py holds the plain version). Also the
wrapper's plan of scratch and blocks, as a function of the shapes."""
import math

import numpy as np
import pytest
import torch

from thunder_tpu_torch.executors import cudaex


@pytest.fixture
def jax_ref():
    """thunder_tpu's Pallas kernels (interpret mode on the CPU)."""
    import jax.numpy as jnp

    from thunder_tpu.executors import pallasex

    return jnp, pallasex


def _inputs(B, H, Hkv, T, D, dtype, causal, seed=0):
    """q, k, v, o, lse (from the plain forward), cos, sin, do; numpy-made."""
    from thunder_tpu_torch.models.litgpt import build_rope_cache

    rng = np.random.RandomState(seed)
    q, k, v = (torch.tensor(rng.randn(B, h, T, D).astype(np.float32)).to(dtype) for h in (H, Hkv, Hkv))
    do = torch.tensor(rng.randn(B, H, T, D).astype(np.float32)).to(dtype)
    cos, sin = build_rope_cache(T, D, 10000, torch.float32, "cpu")
    o, lse = cudaex.flash_rope_attention_plain(q, k, v, cos, sin, causal)
    return q, k, v, o, lse, cos, sin, do


def _composed(q, k, v, o, lse, cos, sin, do, causal):
    """prologue -> the products on roped q/k -> epilogue, as the card runs them."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qr, kr, dor, delta = cudaex.flash_backward_prologue_plain(q, k, o, do, cos, sin)
    qf, kf, s = cudaex._flash_plain_scores(qr, kr, None, None, causal, scale)
    dq, dk, dv = cudaex._flash_backward_f32(qf, kf, v, lse, dor.float(), delta, s, scale)
    return cudaex.flash_backward_epilogue_plain(dq, dk, dv, cos, sin, q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,T,D,causal", [
    (1, 2, 2, 40, 16, True), (2, 4, 2, 33, 24, False), (1, 4, 1, 17, 32, True)],
    ids=["mha", "gqa-full-d24", "mqa"])
def test_stages_compose_to_the_plain_backward_bit_for_bit(dtype, B, H, Hkv, T, D, causal):
    args = _inputs(B, H, Hkv, T, D, dtype, causal)
    got = _composed(*args, causal)
    want = cudaex.flash_rope_attention_backward_plain(*args, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b), name


def test_prologue_rounds_a_wider_cotangent_first():
    """Under autocast do arrives in f32: the prologue rounds it to q's dtype
    before delta, as pallasex casts it before its pallas_call."""
    q, k, v, o, lse, cos, sin, do = _inputs(1, 2, 1, 20, 16, torch.bfloat16, True, seed=3)
    wide = do.float() + 1e-3  # not a bf16 value
    _, _, dor, delta = cudaex.flash_backward_prologue_plain(q, k, o, wide, cos, sin)
    assert dor.dtype == torch.bfloat16 and torch.equal(dor, wide.to(torch.bfloat16))
    torch.testing.assert_close(delta, (dor.float() * o.float()).sum(-1), rtol=0, atol=0)
    got = cudaex.flash_rope_attention_backward(q, k, v, o, lse, cos, sin, wide, True)
    want = cudaex.flash_rope_attention_backward_plain(q, k, v, o, lse, cos, sin, dor, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("Hkv", [4, 2], ids=["mha", "gqa"])
def test_composition_matches_pallas_interpret(jax_ref, Hkv):
    """The same shapes as test_torch_kernels.py's flash-RoPE cases."""
    jnp, pallasex = jax_ref
    B, H, T, D = 1, 4, 128, 32
    rng = np.random.RandomState(Hkv)
    q, do = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, Hkv, T, D).astype(np.float32) for _ in range(2))
    from thunder_tpu_torch.models.litgpt import build_rope_cache

    cos, sin = (a.numpy() for a in build_rope_cache(T, D, 10000, torch.float32, "cpu"))
    scale = 1.0 / math.sqrt(D)
    jo, jlse = pallasex.flash_rope_attention_forward(
        *(jnp.asarray(a) for a in (q, k, v, cos, sin)), causal=True, scale=scale)
    want = pallasex.flash_rope_attention_backward(
        *(jnp.asarray(a) for a in (q, k, v)), jo, jlse, jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(do), causal=True, scale=scale)
    tq, tk, tv, tcos, tsin, tdo = (torch.tensor(a) for a in (q, k, v, cos, sin, do))
    o, lse = cudaex.flash_rope_attention_plain(tq, tk, tv, tcos, tsin, True, scale)
    got = _composed(tq, tk, tv, o, lse, tcos, tsin, tdo, True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3, rtol=5e-3, err_msg=name)


def test_plan_fills_the_card_at_llama_1b_gqa():
    """One core block per (128-key tile, q head, batch): 16 x 16 = 256 at
    llama-1b's GQA shape (132 SMs); one block per kv head gave 64."""
    plan = cudaex.flash_backward_plan(1, 16, 4, 2048, 128, torch.bfloat16, rope=True)
    assert plan["blocks"] == 256 >= 132


def _shapes(plan):
    return {name: (shape, dt) for name, (shape, dt) in plan["scratch"].items()}


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("args,kw,want", [
    # llama-350m's training shape: MHA with RoPE at D = 64 takes dk's VJP in the core
    ((4, 16, 16, 2048, 64, BF16), dict(rope=True),
     {"delta": ((4, 16, 2048), F32), "lse2": ((4, 16, 2048), F32),
      "dq_acc": ((4, 16, 2048, 64), F32), "q_roped": ((4, 16, 2048, 64), BF16),
      "k_roped": ((4, 16, 2048, 64), BF16)}),
    # GQA: dk and dv summed over the group in f32; an f32 cotangent is rounded into scratch
    ((1, 16, 4, 2048, 128, BF16), dict(do_dtype=F32, rope=True),
     {"delta": ((1, 16, 2048), F32), "lse2": ((1, 16, 2048), F32),
      "dq_acc": ((1, 16, 2048, 128), F32), "dk_acc": ((1, 4, 2048, 128), F32),
      "dv_acc": ((1, 4, 2048, 128), F32), "q_roped": ((1, 16, 2048, 128), BF16),
      "k_roped": ((1, 4, 2048, 128), BF16), "do": ((1, 16, 2048, 128), BF16)}),
    # no RoPE, ragged T: delta and lse2 padded to whole tiles (64 queries at D = 96)
    ((2, 4, 4, 77, 96, torch.float16), {},
     {"delta": ((2, 4, 128), F32), "lse2": ((2, 4, 128), F32), "dq_acc": ((2, 4, 77, 96), F32)}),
    # RoPE at D = 96: dk's VJP in the epilogue, from an f32 accumulator
    ((1, 2, 2, 200, 96, BF16), dict(rope=True),
     {"delta": ((1, 2, 256), F32), "lse2": ((1, 2, 256), F32), "dq_acc": ((1, 2, 200, 96), F32),
      "dk_acc": ((1, 2, 200, 96), F32), "q_roped": ((1, 2, 200, 96), BF16),
      "k_roped": ((1, 2, 200, 96), BF16)}),
    # f32: the two-pass kernels need delta only
    ((2, 4, 2, 77, 32, F32), dict(rope=True), {"delta": ((2, 4, 77), F32)}),
], ids=["mha-rope-d64", "gqa-rope-f32-do", "ragged-d96", "rope-d96", "f32"])
def test_plan_scratch(args, kw, want):
    plan = cudaex.flash_backward_plan(*args, **kw)
    assert _shapes(plan) == want
    assert plan["pitch"] == want["delta"][0][-1]  # the row pitch handed to the kernels
    assert plan["scratch_bytes"] == sum(math.prod(s) * dt.itemsize for s, dt in want.values())
