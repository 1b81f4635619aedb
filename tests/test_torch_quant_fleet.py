"""int8 and MoE under every fleet stage: the port's engine against
thunder_tpu's, on the CPU.

The port of tests/test_serving.py:604-630 (every stage composed) with
``quantize="int8"``: prefix sharing, chunked prefill (one-page chunks, so
every prompt is chunked and thunder_tpu compiles the fewest programs),
speculative decoding and preemption with resume in one wave, through

* the int8 engine over a dense GPT, the target as its own draft (quantized
  with it, in place, as thunder_tpu's quantize_for_serving does), and
* the int8 engine over an MoEGPT (drop-free top-2 experts; the router's gate
  Linear is quantized with the attention linears; 2 layers), with a
  1-layer dense draft of the same vocabulary.

Weights are int8-exact (q · 2^-9, tests/test_torch_quant.py): thunder_tpu
declines its int8 kernel off a TPU and computes with the dequantized
weights, the port with the plain int8 product; on these weights the two are
the same f32 product, so the greedy streams must be bit-equal. The chunk,
verify and decode traces must claim thunder.int8_linear on every quantized
Linear, and the MoE ones thunder.grouped_mlp in every block. Sampled
requests through the same engines give the port's solo streams
(GPTInference.generate with the same seed).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu_torch as tt
from thunder_tpu import nn as jnn
from thunder_tpu.models import moe as jmoe
from thunder_tpu.models.litgpt import GPT as JaxGPT
from thunder_tpu.models.litgpt import Config as JaxConfig
from thunder_tpu.serving import ServingEngine as JaxServingEngine
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.inference import GPTInference
from thunder_tpu_torch.models import moe as tmoe
from thunder_tpu_torch.models.litgpt import GPT, Config, load_jax_params
from thunder_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.serve

PS, MAX_SEQ, VOCAB = 8, 64, 320
# tests/test_torch_quant.py's config at one layer: width 256, heads of 64, MLP 448, padded vocab 512
QCFG = dict(name="quant-tiny", block_size=MAX_SEQ, vocab_size=VOCAB, padded_vocab_size=512, n_layer=1,
            n_head=4, n_query_groups=2, n_embd=256, intermediate_size=448)
MOE_KW = dict(intermediate_size=160, n_expert=4, n_expert_per_token=2)
FLEET = dict(max_batch=3, page_size=PS, max_seq=MAX_SEQ, n_pages=13, prefix_sharing=True, chunk_tokens=8,
             spec_k=2, quantize="int8")


def _int8_exact(jmodel, rng):
    """Every 2-d weight but the embedding as q · 2^-9, integer q with a
    per-row max |q| of 127, set in the JAX model (the port takes it across)."""
    for name, mod in jmodel.named_modules():
        for pn, p in list(mod._parameters.items()):
            q_name = f"{name}.{pn}" if name else pn
            if p.data.ndim == 2 and not q_name.startswith("wte"):
                q = rng.randint(-126, 127, size=p.data.shape).astype(np.float64)
                q[:, 0] = 127.0
                mod._parameters[pn] = jnn.Parameter(jnp.asarray((q * 2.0 ** -9).astype(np.float32)))
    return jmodel


def _carry(jmodel, tmodel):
    load_jax_params(tmodel, {k: np.asarray(p.data) for k, p in jmodel.named_parameters()})
    return tmodel


def _dense_pair(n_layer=1):
    jm = _int8_exact(JaxGPT(JaxConfig(**{**QCFG, "n_layer": n_layer}), dtype=jnp.float32),
                     np.random.RandomState(5))
    return jm, _carry(jm, GPT(Config(**{**QCFG, "n_layer": n_layer}), torch.float32, device="cpu"))


def _moe_pair():
    jcfg = JaxConfig.from_name("tiny-llama2", block_size=MAX_SEQ, n_layer=2)
    cfg = Config.from_name("tiny-llama2", block_size=MAX_SEQ, n_layer=2)
    jm = jmoe.MoEGPT(jcfg, jmoe.MoEConfig(n_embd=cfg.n_embd, **MOE_KW), dtype=jnp.float32)
    jm = _int8_exact(jm, np.random.RandomState(6))
    return jm, _carry(jm, tmoe.MoEGPT(cfg, tmoe.MoEConfig(n_embd=cfg.n_embd, **MOE_KW), torch.float32,
                                      device="cpu"))


def _moe_draft_pair():
    jd = JaxGPT(JaxConfig.from_name("tiny-llama2", block_size=MAX_SEQ, n_layer=1), dtype=jnp.float32)
    return jd, _carry(jd, GPT(Config.from_name("tiny-llama2", block_size=MAX_SEQ, n_layer=1), torch.float32,
                              device="cpu"))


def _tokens(rng, n):
    return rng.randint(0, VOCAB, (n,)).astype(np.int32)


def _wave(eng, seed, sampled=()):
    """A batch-lane victim (8 of the pool's 12 pages) that decodes while the
    interactive requests arrive (two share a 16-token system prompt, and
    the first of them retires before the others come; every prompt is
    chunked), so the pool preempts it and it resumes after.
    ``sampled``: (index, temperature, seed) of the requests that sample."""
    rng = np.random.RandomState(seed)
    shared = _tokens(rng, 16)
    specs = [(_tokens(rng, 20), 40, "batch"), (np.concatenate([shared, _tokens(rng, 3)]), 6, "interactive"),
             (np.concatenate([shared, _tokens(rng, 5)]), 6, "interactive"), (_tokens(rng, 30), 6, "interactive"),
             (_tokens(rng, 9), 5, "interactive")]
    temps = {i: (t, s) for i, t, s in sampled}
    sub = lambda i: eng.submit(specs[i][0], specs[i][1], lane=specs[i][2],  # noqa: E731
                               temperature=temps.get(i, (0.0, None))[0], seed=temps.get(i, (0.0, None))[1])
    futs = [sub(0)]
    while eng.stats()["active"] == 0:  # its chunks, then decoding
        eng._step_once()
    futs.append(sub(1))
    while not futs[1].done():  # its pages enter the prefix cache; the victim decodes on
        eng._step_once()
    futs += [sub(i) for i in range(2, len(specs))]
    eng.drain()
    return specs, [f.result().new_tokens for f in futs]


STAGES = ("prefix_hits", "chunk_calls", "verify_calls", "spec_proposed", "preempted", "resumed")


def _stages(eng):
    return {k: getattr(eng, k) for k in STAGES if hasattr(eng, k)}


def _claims(cfn, impl):
    return sum(b.impl is impl for b in tt.last_traces(cfn)[-1].bound_symbols)


@pytest.fixture(scope="module")
def dense_run():
    jm, tm = _dense_pair()
    jeng = JaxServingEngine(jm, dtype=jnp.float32, draft_gpt=jm, **FLEET)
    teng = ServingEngine(tm, dtype=torch.float32, device="cpu", draft_gpt=tm, **FLEET)
    return jeng, teng, _wave(jeng, 0), _wave(teng, 0)


@pytest.fixture(scope="module")
def moe_run():
    jm, tm = _moe_pair()
    jd, td = _moe_draft_pair()
    jeng = JaxServingEngine(jm, dtype=jnp.float32, draft_gpt=jd, **FLEET)
    teng = ServingEngine(tm, dtype=torch.float32, device="cpu", draft_gpt=td, **FLEET)
    return jeng, teng, _wave(jeng, 1), _wave(teng, 1)


@pytest.mark.parametrize("run", ["dense_run", "moe_run"])
def test_int8_fleet_greedy_streams_match_jax(run, request):
    jeng, teng, (_, jstreams), (_, tstreams) = request.getfixturevalue(run)
    for a, b in zip(tstreams, jstreams):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert {k: v for k, v in _stages(teng).items() if k in _stages(jeng)} == _stages(jeng)
    assert teng.preempted >= 1 and teng.resumed >= 1 and teng.prefix_hits >= 1
    assert teng.chunk_calls > 0 and teng.verify_calls > 0 and teng.spec_proposed > 0
    assert teng.cache.allocator.n_used == len(teng.prefix)  # only the prefix cache holds pages


def test_int8_self_draft_is_quantized_with_the_target(dense_run):
    """quantize_for_serving works in place: the draft, being the target, is
    int8 too, and every proposal verifies."""
    _, teng, _, _ = dense_run
    assert teng.draft_gpt is teng.gpt and teng.gpt.h[0].mlp.fc_1.weight.dtype == torch.int8
    assert teng.spec_accepted == teng.spec_proposed


def test_int8_fleet_traces_claim_int8_linear(dense_run):
    """Every quantized Linear (5 a block and lm_head) runs int8_linear in the
    target's chunk and verify programs and its self-draft's chunk and
    decode programs (a speculative engine decodes through verify)."""
    _, teng, _, _ = dense_run
    want = 5 * QCFG["n_layer"] + 1
    for cfn in (teng.runner.chunk_cfn, teng.runner.verify_cfn, teng.draft_runner.chunk_cfn,
                teng.draft_runner.decode_cfn):
        assert _claims(cfn, cudaex._int8_linear_impl) == want, cfn.__name__
    assert _claims(teng.runner.chunk_cfn, cudaex._paged_chunk_attention_impl) == QCFG["n_layer"]


def test_int8_moe_fleet_traces_claim_grouped_mlp_and_int8_linear(moe_run):
    """The MoE target's chunk and verify programs (every prompt is chunked)
    run grouped_mlp in every block, and int8_linear on the 4 attention linears, the router gate
    (N = the expert count) and lm_head; the dense draft is unquantized."""
    _, teng, _, _ = moe_run
    n_layer = teng.cfg.n_layer
    for cfn in (teng.runner.chunk_cfn, teng.runner.verify_cfn):
        assert _claims(cfn, cudaex._grouped_mlp_impl) == n_layer, cfn.__name__
        assert _claims(cfn, cudaex._int8_linear_impl) == 3 * n_layer + 1, cfn.__name__
    assert teng.gpt.h[0].moe.gate.weight.dtype == torch.int8
    assert teng.gpt.h[0].moe.gate.weight.shape[0] == MOE_KW["n_expert"]
    assert _claims(teng.draft_runner.decode_cfn, cudaex._int8_linear_impl) == 0


@pytest.mark.parametrize("run", ["dense_run", "moe_run"])
def test_int8_fleet_sampled_streams_match_solo(run, request):
    """Sampled requests (one above 2^32) through the same quantized fleet
    engine, preemption included: each stream is the port's solo stream of
    the same quantized model with the same seed."""
    _, teng, _, _ = request.getfixturevalue(run)
    sampled = [(0, 0.9, 3), (1, 0.7, 2 ** 32 + 4), (3, 1.0, 5)]
    preempted = teng.preempted
    specs, streams = _wave(teng, 2, sampled)
    assert teng.preempted > preempted
    solo = GPTInference(teng.gpt, max_seq=MAX_SEQ, dtype=torch.float32)
    for i, temp, seed in sampled:
        p, n, _ = specs[i]
        out, _ = solo.generate(torch.from_numpy(p[None]), n, temperature=temp, seed=seed)
        np.testing.assert_array_equal(streams[i], out[0, len(p):].numpy())
