"""The port's serving slice against thunder_tpu, on the CPU.

tiny-llama2 (block_size 64) with thunder_tpu's weights carried across
(models/litgpt.py:load_jax_params), f32 throughout: the model's logits, the
paged runner's prefill and decode programs (logits and pools), and the
continuous-batching engine's greedy streams must match the JAX package's.
On the CPU the cuda executor's wrappers run their plain PyTorch versions;
the traces must still show it claiming rms_norm and paged_attention.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu.inference import GPTInference as JaxGPTInference
from thunder_tpu.models.litgpt import GPT as JaxGPT
from thunder_tpu.models.litgpt import Config as JaxConfig
from thunder_tpu.serving import ServingEngine as JaxServingEngine
from thunder_tpu.serving.runner import PagedGPTRunner as JaxPagedGPTRunner
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.inference import GPTInference
from thunder_tpu_torch.models.litgpt import GPT, Config, load_jax_params
from thunder_tpu_torch.nn import functional_params
from thunder_tpu_torch.serving import ServingEngine
from thunder_tpu_torch.serving.runner import PagedGPTRunner

pytestmark = pytest.mark.serve

PS = 8  # page size
MIXED = [(5, 7), (13, 4), (9, 10), (20, 3), (3, 8), (11, 5)]  # tests/test_serving.py:102


@pytest.fixture(scope="module")
def jgpt():
    return JaxGPT(JaxConfig.from_name("tiny-llama2", block_size=64), dtype=jnp.float32)


@pytest.fixture(scope="module")
def gpt(jgpt):
    g = GPT(Config.from_name("tiny-llama2", block_size=64), torch.float32, device="cpu")
    load_jax_params(g, {k: np.asarray(p.data) for k, p in jgpt.named_parameters()})
    return g


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(1234)
    return [rng.randint(0, 320, (L,)).astype(np.int32) for L, _ in MIXED]


def _params(gpt):
    return {k: p.detach() for k, p in gpt.named_parameters()}


def test_gpt_logits_match_jax(jgpt, gpt):
    idx = np.random.RandomState(0).randint(0, 320, (2, 16)).astype(np.int32)
    ref = np.asarray(tj.jit(jgpt)(jnp.asarray(idx)))

    def fwd(params, idx):
        with functional_params(gpt, params):
            return gpt(idx)

    out = tt.jit(fwd)(_params(gpt), torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_runner_prefill_and_decode_match_jax(jgpt, gpt):
    """One bucketed prefill (L=11 in a 16 bucket) then one packed decode of
    two slots (one idle on the null page): logits and every pool agree."""
    cfg = gpt.cfg
    rng = np.random.RandomState(1)
    n_pages, Hkv, hs = 9, cfg.n_query_groups, cfg.head_size
    pools = [rng.randn(n_pages, PS, Hkv, hs).astype(np.float32) * 0.1 for _ in range(2 * cfg.n_layer)]
    kps_np, vps_np = pools[:cfg.n_layer], pools[cfg.n_layer:]
    jr, tr = JaxPagedGPTRunner(jgpt, page_size=PS), PagedGPTRunner(gpt, page_size=PS)
    jparams = {k: p.data for k, p in jgpt.named_parameters()}
    tparams = _params(gpt)

    idx = np.zeros((1, 16), np.int32)
    idx[0, :11] = rng.randint(0, 320, (11,))
    page_ids = np.asarray([3, 5], np.int32)
    jl, jk, jv = jr.prefill_cfn(jparams, jnp.asarray(idx), jnp.asarray(page_ids),
                                tuple(map(jnp.asarray, kps_np)), tuple(map(jnp.asarray, vps_np)),
                                jnp.asarray(10, jnp.int32))
    tl, tk, tv = tr.prefill_cfn(tparams, torch.from_numpy(idx), torch.from_numpy(page_ids),
                                tuple(map(torch.tensor, kps_np)), tuple(map(torch.tensor, vps_np)),
                                torch.tensor(10, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)

    page_table = np.asarray([[3, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([11, 0], np.int32)
    toks = np.asarray([[7], [0]], np.int32)
    jl, jk, jv = jr.decode_cfn(jparams, jnp.asarray(toks), jk, jv, jnp.asarray(page_table),
                               jnp.asarray(pos))
    tl, tk2, tv2 = tr.decode_cfn(tparams, torch.from_numpy(toks), tk, tv,
                                 torch.from_numpy(page_table), torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], atol=1e-4, rtol=1e-4)
    for a, b in zip(tk2 + tv2, jk + jv):
        np.testing.assert_allclose(a.numpy()[1:], np.asarray(b)[1:], atol=1e-5, rtol=1e-5)
    # the port writes the pools in place: the outputs are the inputs
    assert all(a is b for a, b in zip(tk2 + tv2, tk + tv))


def test_engine_streams_match_jax(jgpt, gpt, prompts):
    """More requests than decode slots, mixed prompt/output lengths: every
    greedy stream equals thunder_tpu's engine's, and every page comes back."""
    kw = dict(max_batch=4, page_size=PS, max_seq=64)
    jeng = JaxServingEngine(jgpt, dtype=jnp.float32, **kw)
    teng = ServingEngine(gpt, dtype=torch.float32, device="cpu", **kw)
    jf = [jeng.submit(p, max_new_tokens=n) for p, (_, n) in zip(prompts, MIXED)]
    tf = [teng.submit(p, max_new_tokens=n) for p, (_, n) in zip(prompts, MIXED)]
    jeng.drain()
    teng.drain()
    for a, b in zip(tf, jf):
        ra, rb = a.result(), b.result()
        np.testing.assert_array_equal(ra.new_tokens, rb.new_tokens)
        assert ra.finish_reason == "length" and ra.ttft_s > 0
    assert teng.cache.allocator.n_used == 0
    assert teng.stats()["page_pool_utilization"] == 0.0


def test_steady_state_never_recompiles(gpt, prompts):
    """Once the decode program and a wave's prefill buckets are compiled, a
    second wave over the same buckets compiles nothing: positions and page
    tables are tensors, not part of any cache key."""
    teng = ServingEngine(gpt, max_batch=4, page_size=PS, max_seq=64, dtype=torch.float32,
                         device="cpu")
    for p in prompts:
        teng.submit(p, max_new_tokens=3)
    teng.drain()
    misses = (tt.cache_misses(teng.runner.prefill_cfn), tt.cache_misses(teng.runner.decode_cfn))
    assert misses[1] == 1
    for p in prompts[::-1]:
        teng.submit(p[::-1].copy(), max_new_tokens=5)
    teng.drain()
    assert (tt.cache_misses(teng.runner.prefill_cfn), tt.cache_misses(teng.runner.decode_cfn)) == misses


def test_background_thread_loop(gpt, prompts):
    teng = ServingEngine(gpt, max_batch=2, page_size=PS, max_seq=64, dtype=torch.float32,
                         device="cpu")
    teng.start()
    try:
        res = teng.submit(prompts[2], max_new_tokens=4).result(timeout=120)
        assert res.n_new_tokens == 4
    finally:
        teng.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        teng.submit(prompts[0], max_new_tokens=2).result(timeout=10)


def test_pages_return_after_each_request(gpt, prompts):
    teng = ServingEngine(gpt, max_batch=2, page_size=PS, max_seq=64, dtype=torch.float32,
                         device="cpu")
    for p in prompts[:3]:
        fut = teng.submit(p, max_new_tokens=4)
        teng.drain()
        assert fut.result().n_new_tokens == 4
        assert teng.cache.allocator.n_used == 0


def test_decode_trace_claims_kernels(gpt, prompts):
    teng = ServingEngine(gpt, max_batch=2, page_size=PS, max_seq=64, dtype=torch.float32,
                         device="cpu")
    teng.submit(prompts[0], max_new_tokens=3)
    teng.drain()
    n_layer = gpt.cfg.n_layer
    for cfn, n_paged in ((teng.runner.decode_cfn, n_layer), (teng.runner.prefill_cfn, 0)):
        ex_trc = tt.last_traces(cfn)[-1]
        rms = [b for b in ex_trc.bound_symbols if b.sym.id == "torch.nn.functional.rms_norm"]
        paged = [b for b in ex_trc.bound_symbols if b.sym.id == "thunder.paged_attention"]
        assert len(rms) == 2 * n_layer + 1 and all(b.impl is cudaex._rms_impl for b in rms)
        assert len(paged) == n_paged
        assert all(b.impl is cudaex._paged_attention_impl for b in paged)
        src = str(ex_trc)
        assert "ltorch.rms_norm" in src
        assert ("ltorch.paged_attention" in src) == bool(n_paged)


def test_dense_generate_matches_jax(jgpt, gpt, prompts):
    p = prompts[1]
    ref, _ = JaxGPTInference(jgpt, dtype=jnp.float32).generate(
        jnp.asarray(p[None, :]), 5, scan_decode=False)
    out, m = GPTInference(gpt, dtype=torch.float32).generate(torch.from_numpy(p[None, :]), 5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert m.top2_gap.shape == (1, 5) and (m.top2_gap >= 0).all()


def test_sampling_is_refused(gpt, prompts):
    """Temperature sampling was refused before it was ported; now a sampled
    request and a sampled generate() run, and with the same seed give the
    same stream (every identity: tests/test_torch_sampling.py)."""
    teng = ServingEngine(gpt, max_batch=2, page_size=PS, max_seq=64, dtype=torch.float32,
                         device="cpu")
    fut = teng.submit(prompts[0], max_new_tokens=3, temperature=0.8, seed=5)
    teng.drain()
    out, m = GPTInference(gpt, dtype=torch.float32).generate(prompts[0][None, :], 3, temperature=0.8,
                                                             seed=5)
    np.testing.assert_array_equal(fut.result().new_tokens, out[0, len(prompts[0]):].numpy())
    assert m.sample_margin.shape == (1, 3)


def test_entry_points_need_a_card_or_a_named_device(monkeypatch, gpt):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.from_name("tiny-llama2", block_size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(gpt, max_batch=2, page_size=PS, max_seq=64)
    assert GPT(cfg, device="cpu").device == torch.device("cpu")
