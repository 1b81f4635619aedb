"""The port's fleet-serving slice against thunder_tpu, on the CPU.

tiny-llama2 (block_size 64) with thunder_tpu's weights carried across, f32,
page_size 8, max_seq 64 (as tests/test_torch_serving.py): the refcounting
allocator and the prefix cache give the same pages and refcounts as
thunder_tpu's on the same calls; the runner's chunk and verify programs give
the same logits (1e-5) and pools (1e-5) as thunder_tpu's PagedGPTRunner;
and the engine's greedy streams equal thunder_tpu's ServingEngine's under
the same settings for prefix sharing, chunked prefill, speculation (random
draft and self-draft), all stages composed, and preemption with resume.
Greedy decoding makes every accept rule exact, so the streams must be
bit-equal. On the CPU the cuda executor's wrappers run their plain PyTorch
versions; the traces must still show it claiming paged_chunk_attention.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu_torch as tt
from thunder_tpu.models.litgpt import GPT as JaxGPT
from thunder_tpu.models.litgpt import Config as JaxConfig
from thunder_tpu.serving import PageAllocator as JaxPageAllocator
from thunder_tpu.serving import PrefixCache as JaxPrefixCache
from thunder_tpu.serving import ServingEngine as JaxServingEngine
from thunder_tpu.serving.runner import PagedGPTRunner as JaxPagedGPTRunner
from thunder_tpu_torch.compile_service.buckets import BucketLadder
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models.litgpt import GPT, Config, load_jax_params
from thunder_tpu_torch.serving import OutOfPages, PageAllocator, PagedKVCache, PrefixCache, ServingEngine
from thunder_tpu_torch.serving.runner import PagedGPTRunner

pytestmark = pytest.mark.serve

PS = 8  # page size
MAX_SEQ = 64
VOCAB = 320


def _port(jmodel):
    g = GPT(Config.from_name("tiny-llama2", block_size=MAX_SEQ), torch.float32, device="cpu")
    load_jax_params(g, {k: np.asarray(p.data) for k, p in jmodel.named_parameters()})
    return g


@pytest.fixture(scope="module")
def jgpt():
    return JaxGPT(JaxConfig.from_name("tiny-llama2", block_size=MAX_SEQ), dtype=jnp.float32)


@pytest.fixture(scope="module")
def gpt(jgpt):
    return _port(jgpt)


@pytest.fixture(scope="module")
def jdraft():
    """A second JAX model: other weights, so some proposals are rejected."""
    return JaxGPT(JaxConfig.from_name("tiny-llama2", block_size=MAX_SEQ), dtype=jnp.float32)


@pytest.fixture(scope="module")
def draft(jdraft):
    return _port(jdraft)


def _engines(jgpt, gpt, *, jdraft=None, draft=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", PS)
    kw.setdefault("max_seq", MAX_SEQ)
    jeng = JaxServingEngine(jgpt, dtype=jnp.float32, draft_gpt=jdraft, **kw)
    teng = ServingEngine(gpt, dtype=torch.float32, device="cpu", draft_gpt=draft, **kw)
    return jeng, teng


COUNTERS = ("prefix_hits", "prefix_tokens_saved", "spec_proposed", "spec_accepted",
            "preempted", "resumed")


def _same_streams(tf, jf):
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a.result().new_tokens, b.result().new_tokens)


def _same_counters(teng, jeng):
    assert {c: getattr(teng, c) for c in COUNTERS} == {c: getattr(jeng, c) for c in COUNTERS}


def _tokens(rng, n):
    return rng.randint(0, VOCAB, (n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# allocator and prefix cache: the same calls give the same pages and counts
# ---------------------------------------------------------------------------


def test_subladder_caps_the_rungs():
    ladder = BucketLadder(8, 64, page_size=8)
    sub = ladder.subladder(32)
    assert sub.rungs == (8, 16, 32) and sub.bucket_for(20) == 32 and sub.bucket_for(40) == 32
    with pytest.raises(ValueError, match="subladder"):
        ladder.subladder(128)


def test_allocator_refcount_incref_fork_match_jax():
    def script(a, errors):
        out = []
        (p,) = a.alloc(1)
        a.incref(p)
        out.append((p, a.refcount(p), a.n_free))
        a.free([p])  # decref: stays allocated
        out.append((a.refcount(p), a.n_free))
        assert a.fork(p) == p  # sole owner writes in place
        a.incref(p)
        q = a.fork(p)  # shared: detached into a fresh page
        out.append((q, a.refcount(p), a.refcount(q), a.n_used))
        a.free([p, q])
        out.append((a.refcount(p), a.n_free))
        with pytest.raises(ValueError, match="double free"):
            a.free([p])
        with pytest.raises(ValueError, match="incref"):
            a.incref(p)
        with pytest.raises(ValueError, match="fork"):
            a.fork(7)
        pages = a.alloc(3)
        a.incref(pages[0])
        a.free([pages[0]])  # one of two owners retires: nothing is free
        with pytest.raises(errors):
            a.alloc(5)
        a.free(pages)
        out.append((a.n_free, a.n_used))
        return out

    from thunder_tpu.serving import OutOfPages as JaxOutOfPages

    assert script(PageAllocator(8), OutOfPages) == script(JaxPageAllocator(8), JaxOutOfPages)


def test_prefix_cache_matches_jax():
    """insert, full match, partial-tail match, a miss, LRU eviction and
    clear: the same page lists, coverage and refcounts as thunder_tpu's."""
    def script(a, c):
        out = []
        prompt = np.arange(10, dtype=np.int32)  # 2 full pages of 4 + a 2-token tail
        pages = a.alloc(3)
        out.append(c.insert(prompt, pages))
        out.append([a.refcount(p) for p in pages])
        out.append(c.match(prompt[:8]))
        out.append([a.refcount(p) for p in pages])
        a.free(out[-2][0])
        out.append(c.match(prompt[:6]))  # partial tail: leading tokens of page 2
        a.free(out[-1][0])
        out.append(c.match(np.asarray([9, 9, 9, 9, 1], np.int32)))  # miss
        other = np.concatenate([prompt[:4], np.asarray([7, 7, 7, 7], np.int32)])
        a.incref(pages[0])
        opages = [pages[0]] + a.alloc(1)
        out.append(c.insert(other, opages))  # shares the first node
        a.free(pages)
        a.free(opages)
        out.append((len(c), a.n_used, [a.refcount(p) for p in pages + opages]))
        out.append(c.evict_until(a.n_free + 1))  # one LRU leaf goes
        out.append((len(c), a.n_used))
        c.clear()
        out.append((len(c), a.n_used, a.n_free))
        return out

    ta, ja = PageAllocator(16), JaxPageAllocator(16)
    assert script(ta, PrefixCache(ta, 4)) == script(ja, JaxPrefixCache(ja, 4))


def test_copy_page_copies_every_layer_pool():
    cache = PagedKVCache(2, 4, PS, 2, 4, torch.float32, "cpu")
    for pool in cache.k_pages + cache.v_pages:
        pool.copy_(torch.randn(pool.shape))
    before = [p.clone() for p in cache.k_pages + cache.v_pages]
    cache.copy_page(1, 3)
    for p, b in zip(cache.k_pages + cache.v_pages, before):
        torch.testing.assert_close(p[3], b[1])
        torch.testing.assert_close(p[:3], b[:3])


# ---------------------------------------------------------------------------
# runner programs: chunk and verify against thunder_tpu's
# ---------------------------------------------------------------------------


def _pools(cfg, n_pages, seed):
    rng = np.random.RandomState(seed)
    pools = [rng.randn(n_pages, PS, cfg.n_query_groups, cfg.head_size).astype(np.float32) * 0.1
             for _ in range(2 * cfg.n_layer)]
    return pools[:cfg.n_layer], pools[cfg.n_layer:]


def _runners(jgpt, gpt):
    return (JaxPagedGPTRunner(jgpt, page_size=PS), PagedGPTRunner(gpt, page_size=PS),
            {k: p.data for k, p in jgpt.named_parameters()},
            {k: p.detach() for k, p in gpt.named_parameters()})


def _check_pools(tk, tv, jk, jv):
    for a, b in zip(tk + tv, jk + jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("start,T,last_rel", [(0, 16, 12), (16, 16, 15), (48, 16, 9)],
                         ids=["start0", "mid", "final-at-max-seq"])
def test_runner_chunk_matches_jax(jgpt, gpt, start, T, last_rel):
    """One chunk over a full page table (pages before the chunk hold earlier
    K/V): logits and every pool agree; the last case ends at max_seq."""
    cfg = gpt.cfg
    kps, vps = _pools(cfg, 12, seed=start)
    jr, tr, jparams, tparams = _runners(jgpt, gpt)
    row = np.asarray([[3, 9, 1, 5, 11, 2, 7, 4]], np.int32)  # 8 pages = max_seq 64
    idx = np.random.RandomState(start + 1).randint(0, VOCAB, (1, T)).astype(np.int32)
    jl, jk, jv = jr.chunk_cfn(jparams, jnp.asarray(idx), jnp.asarray(row),
                              tuple(map(jnp.asarray, kps)), tuple(map(jnp.asarray, vps)),
                              jnp.asarray(start, jnp.int32), jnp.asarray(last_rel, jnp.int32))
    tl, tk, tv = tr.chunk_cfn(tparams, torch.from_numpy(idx), torch.from_numpy(row),
                              tuple(map(torch.tensor, kps)), tuple(map(torch.tensor, vps)),
                              torch.tensor(start, dtype=torch.int32),
                              torch.tensor(last_rel, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    _check_pools(tk, tv, jk, jv)


def test_runner_verify_matches_jax(jgpt, gpt):
    """A packed verify of k+1 = 3 tokens for three slots: one mid-page, one
    whose last position is past the table's coverage (written to the null
    page), one idle slot on the null row."""
    cfg = gpt.cfg
    kps, vps = _pools(cfg, 12, seed=7)
    jr, tr, jparams, tparams = _runners(jgpt, gpt)
    pt = np.asarray([[3, 9, 1, 0, 0, 0, 0, 0],
                     [3, 9, 1, 5, 11, 2, 7, 4],   # shares its first three pages
                     [0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    pos = np.asarray([13, 62, 0], np.int32)
    toks = np.random.RandomState(8).randint(0, VOCAB, (3, 3)).astype(np.int32)
    jl, jk, jv = jr.verify_cfn(jparams, jnp.asarray(toks), tuple(map(jnp.asarray, kps)),
                               tuple(map(jnp.asarray, vps)), jnp.asarray(pt), jnp.asarray(pos))
    tl, tk, tv = tr.verify_cfn(tparams, torch.from_numpy(toks), tuple(map(torch.tensor, kps)),
                               tuple(map(torch.tensor, vps)), torch.from_numpy(pt),
                               torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    _check_pools(tk, tv, jk, jv)


def test_chunk_and_verify_traces_claim_the_kernel(gpt):
    """Both programs run thunder.paged_chunk_attention through the cuda
    claim, and each pool input is read only by its index_put, which then
    writes it in place (the program returns the caller's pools)."""
    from thunder_tpu_torch.executors import torchex

    cfg = gpt.cfg
    tr = PagedGPTRunner(gpt, page_size=PS)
    params = {k: p.detach() for k, p in gpt.named_parameters()}
    kps, vps = (tuple(torch.tensor(a) for a in x) for x in _pools(cfg, 12, seed=1))
    row = torch.tensor([[3, 9, 1, 5, 11, 2, 7, 4]], dtype=torch.int32)
    _, k1, v1 = tr.chunk_cfn(params, torch.zeros(1, 16, dtype=torch.int32), row, kps, vps,
                             torch.tensor(16, dtype=torch.int32), torch.tensor(3, dtype=torch.int32))
    pt = row.expand(2, 8).contiguous()
    _, k2, v2 = tr.verify_cfn(params, torch.zeros(2, 3, dtype=torch.int32), k1, v1, pt,
                              torch.tensor([5, 20], dtype=torch.int32))
    assert all(a is b for a, b in zip(k1 + v1 + k2 + v2, kps + vps + kps + vps))
    for cfn in (tr.chunk_cfn, tr.verify_cfn):
        bsyms = tt.last_traces(cfn)[-1].bound_symbols
        chunk = [b for b in bsyms if b.sym.id == "thunder.paged_chunk_attention"]
        assert len(chunk) == cfg.n_layer
        assert all(b.impl is cudaex._paged_chunk_attention_impl for b in chunk)
        puts = [b for b in bsyms if b.sym.name == "index_put"]
        assert len(puts) == 2 * cfg.n_layer
        assert all(b.impl is torchex.index_put_in_place for b in puts)
        assert "ltorch.paged_chunk_attention" in str(tt.last_traces(cfn)[-1])


# ---------------------------------------------------------------------------
# engine streams: the same settings give thunder_tpu's streams
# ---------------------------------------------------------------------------


def test_prefix_sharing_suffix_prefill_matches_jax(jgpt, gpt):
    """Requests sharing a system prompt map the donor's pages and prefill
    only the unshared suffix."""
    jeng, teng = _engines(jgpt, gpt, prefix_sharing=True)
    rng = np.random.RandomState(0)
    sys_p = _tokens(rng, 16)  # 2 pages
    prompts = [np.concatenate([sys_p, _tokens(rng, 3)]) for _ in range(3)]
    jf = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    tf = [teng.submit(p, max_new_tokens=5) for p in prompts]
    jeng.drain()
    teng.drain()
    _same_streams(tf, jf)
    _same_counters(teng, jeng)
    assert teng.prefix_hits == 2 and teng.prefix_tokens_saved == 2 * 16
    assert teng.cache.allocator.n_used == len(teng.prefix)  # only cache references remain


def test_full_hit_and_partial_tail_match_jax(jgpt, gpt):
    """A full repeat and an 11-token prefix of a cached prompt (a partial-
    tail hit) admit with no prefill; the donor's pages stay intact after
    the copy-on-write forks."""
    jeng, teng = _engines(jgpt, gpt, prefix_sharing=True)
    donor = _tokens(np.random.RandomState(1), 16)
    outs = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        futs = []
        for p in (donor, donor, donor[:11], donor):
            futs.append(eng.submit(p, max_new_tokens=4))
            eng.drain()
        outs[name] = [f.result().new_tokens for f in futs]
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(outs["port"][3], outs["port"][0])  # donor pages intact
    _same_counters(teng, jeng)
    assert teng.prefix_hits == 3 and teng.prefix_tokens_saved == 15 + 10 + 15


def test_chunked_prefill_matches_jax(jgpt, gpt):
    """Prompts of 40 and 23 tokens in 16-token chunks under a 16-token
    budget: 16+16+final rung, and 16+final ending mid-page."""
    jeng, teng = _engines(jgpt, gpt, chunk_tokens=16, prefill_budget=16)
    rng = np.random.RandomState(2)
    specs = [(_tokens(rng, 40), 5), (_tokens(rng, 23), 4)]
    jf = [jeng.submit(p, max_new_tokens=n) for p, n in specs]
    tf = [teng.submit(p, max_new_tokens=n) for p, n in specs]
    jeng.drain()
    teng.drain()
    _same_streams(tf, jf)
    assert teng.chunk_calls == 3 + 2
    assert teng.cache.allocator.n_used == 0


def test_final_chunk_ending_at_max_seq_matches_jax(jgpt, gpt):
    """A one-page prefix hit leaves a 55-token suffix in 32-token chunks:
    the final chunk's rung (32) would cross max_seq, so it falls back to
    the exact page-aligned remainder (24) and ends at 64."""
    jeng, teng = _engines(jgpt, gpt, prefix_sharing=True, chunk_tokens=32)
    rng = np.random.RandomState(3)
    donor = _tokens(rng, 8)
    prompt = np.concatenate([donor, _tokens(rng, 55)])  # 63 tokens + 1 new = max_seq
    assert teng._final_chunk_end(63, 8) == MAX_SEQ
    outs = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        f1 = eng.submit(donor, max_new_tokens=2)
        eng.drain()
        f2 = eng.submit(prompt, max_new_tokens=1)
        eng.drain()
        outs[name] = (f1.result().new_tokens, f2.result().new_tokens)
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(a, b)
    _same_counters(teng, jeng)
    assert teng.chunk_ladder.hits() == {32: 1} and teng.prefix_hits == 1


def test_speculation_random_draft_matches_jax(jgpt, gpt, jdraft, draft):
    """A draft with other weights proposes wrong tokens; the accept and
    rollback rule commits exactly thunder_tpu's stream."""
    jeng, teng = _engines(jgpt, gpt, jdraft=jdraft, draft=draft, spec_k=2)
    rng = np.random.RandomState(4)
    specs = [(_tokens(rng, 9), 6), (_tokens(rng, 14), 9)]
    jf = [jeng.submit(p, max_new_tokens=n) for p, n in specs]
    tf = [teng.submit(p, max_new_tokens=n) for p, n in specs]
    jeng.drain()
    teng.drain()
    _same_streams(tf, jf)
    _same_counters(teng, jeng)
    assert teng.spec_proposed > teng.spec_accepted  # some proposal was rejected
    assert teng.verify_calls > 0 and teng.cache.allocator.n_used == 0


def test_all_stages_composed_match_jax(jgpt, gpt):
    """Sharing + chunking + self-draft speculation at once: every stream
    equals thunder_tpu's, and the self-draft verifies every proposal."""
    jeng, teng = _engines(jgpt, gpt, prefix_sharing=True, chunk_tokens=16, spec_k=3,
                          jdraft=jgpt, draft=gpt)
    rng = np.random.RandomState(5)
    sys_p = _tokens(rng, 24)
    outs = {}
    tails = [_tokens(rng, n) for n in (0, 5, 9, 2)]
    for name, eng in (("jax", jeng), ("port", teng)):
        futs = []
        for tail, n in zip(tails, (6, 7, 4, 5)):
            futs.append(eng.submit(np.concatenate([sys_p, tail]), max_new_tokens=n))
            if not len(tail):
                eng.drain()  # warm the prefix cache before the sharers arrive
        eng.drain()
        outs[name] = [f.result().new_tokens for f in futs]
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(a, b)
    _same_counters(teng, jeng)
    assert teng.prefix_hits > 0 and teng.spec_proposed > 0
    assert teng.spec_accepted == teng.spec_proposed


def test_preemption_spill_resume_matches_jax(jgpt, gpt):
    """A batch-lane victim spilled for a page-starved interactive request
    resumes and finishes with thunder_tpu's (unpreempted) stream."""
    jeng, teng = _engines(jgpt, gpt, n_pages=9)  # 8 usable pages
    rng = np.random.RandomState(6)
    victim_p, inter_p = _tokens(rng, 9), _tokens(rng, 33)
    outs = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        victim = eng.submit(victim_p, max_new_tokens=20, lane="batch")
        eng._step_once()  # admit + a few tokens
        eng._step_once()
        inter = eng.submit(inter_p, max_new_tokens=5)  # needs the whole pool
        eng.drain()
        outs[name] = (victim.result().new_tokens, inter.result().new_tokens)
        assert eng.preempted == 1 and eng.resumed == 1
        assert eng.cache.allocator.n_used == 0
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# leaks, lanes, recompiles, refusals
# ---------------------------------------------------------------------------


def test_no_leak_with_sharing_under_faults(gpt):
    """A failed suffix chunk with sharing live decrefs (never double-frees)
    its shared pages; the retry hits; afterwards only the prefix cache's own
    references remain, and clearing it empties the pool."""
    teng = ServingEngine(gpt, max_batch=4, page_size=PS, max_seq=MAX_SEQ, dtype=torch.float32,
                         device="cpu", prefix_sharing=True)
    rng = np.random.RandomState(7)
    p_shared = _tokens(rng, 16)
    teng.submit(p_shared, max_new_tokens=4)
    teng.drain()
    p2 = np.concatenate([p_shared, _tokens(rng, 5)])
    orig = teng.runner.chunk_cfn
    teng.runner.chunk_cfn = lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("injected chunk failure"))
    f2 = teng.submit(p2, max_new_tokens=4)
    teng.drain()
    with pytest.raises(RuntimeError, match="injected"):
        f2.result(timeout=5)
    teng.runner.chunk_cfn = orig
    f3 = teng.submit(p2, max_new_tokens=4)
    teng.drain()
    assert f3.result().n_new_tokens == 4
    assert teng.prefix_hits == 2  # f2 and f3 both matched
    assert teng.cache.allocator.n_used == len(teng.prefix)
    teng.prefix.clear()
    assert teng.cache.allocator.n_used == 0
    teng.cache.allocator.free(teng.cache.allocator.alloc(teng.cache.n_pages - 1))


def test_lane_validation_and_batch_fifo(gpt):
    teng = ServingEngine(gpt, max_batch=1, page_size=PS, max_seq=MAX_SEQ, dtype=torch.float32,
                         device="cpu")
    p = _tokens(np.random.RandomState(8), 6)
    with pytest.raises(ValueError, match="lane"):
        teng.submit(p, max_new_tokens=2, lane="bulk").result(timeout=5)
    batch = [teng.submit(p, max_new_tokens=2, lane="batch") for _ in range(3)]
    inter = teng.submit(p, max_new_tokens=2)
    done = []
    while teng._outstanding:
        teng._step_once()
        done += [i for i, f in enumerate(batch + [inter]) if f.done() and i not in done]
    assert done == [3, 0, 1, 2]  # interactive first, then the batch lane in order
    assert all(f.result().n_new_tokens == 2 for f in batch)


def test_stop_fails_batch_lane_and_mid_chunk_requests(gpt):
    teng = ServingEngine(gpt, max_batch=1, page_size=PS, max_seq=MAX_SEQ, dtype=torch.float32,
                         device="cpu", chunk_tokens=16)
    rng = np.random.RandomState(9)
    chunked = teng.submit(_tokens(rng, 40), max_new_tokens=2)
    queued = teng.submit(_tokens(rng, 5), max_new_tokens=2, lane="batch")
    teng._step_once()  # one chunk of the first request
    assert len(teng._chunking) == 1
    teng.stop()
    for f in (chunked, queued):
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(timeout=5)
    assert teng.cache.allocator.n_used == 0 and teng._outstanding == 0


def test_mixed_wave_replay_never_recompiles(gpt, draft):
    """benchmark_serving's mixed wave in miniature (shared prefix, a long
    batch-lane prompt, uniform background; sharing, chunking and a draft):
    replayed once, the second pass compiles nothing."""
    teng = ServingEngine(gpt, max_batch=4, page_size=PS, max_seq=MAX_SEQ, dtype=torch.float32,
                         device="cpu", prefix_sharing=True, chunk_tokens=16, draft_gpt=draft,
                         spec_k=2)
    rng = np.random.RandomState(10)
    shared = _tokens(rng, 16)
    specs = [(np.concatenate([shared, _tokens(rng, int(rng.randint(1, 9)))]), "interactive")
             for _ in range(4)]
    specs += [(_tokens(rng, 45), "batch"), (_tokens(rng, 12), "interactive"),
              (_tokens(rng, 20), "interactive")]
    cfns = [teng.runner.prefill_cfn, teng.runner.decode_cfn, teng.runner.chunk_cfn,
            teng.runner.verify_cfn, teng.draft_runner.prefill_cfn, teng.draft_runner.decode_cfn,
            teng.draft_runner.chunk_cfn]
    for p, lane in specs:
        teng.submit(p, 2, lane=lane)
    teng.drain()
    misses = [tt.cache_misses(c) for c in cfns]
    futs = [teng.submit(p, 6, lane=lane) for p, lane in specs]
    teng.drain()
    assert [tt.cache_misses(c) for c in cfns] == misses
    assert all(f.result().n_new_tokens == 6 for f in futs)
    assert teng.prefix_hits > 0 and teng.chunk_calls > 0 and teng.verify_calls > 0


def test_unported_arguments_raise(gpt, draft):
    kw = dict(max_batch=2, page_size=PS, max_seq=MAX_SEQ, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="slo=.*slice 8"):
        ServingEngine(gpt, slo=object(), **kw)
    with pytest.raises(ValueError, match="unknown serving quantization mode: 'fp8'"):
        ServingEngine(gpt, quantize="fp8", **kw)
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(gpt, spec_k=2, **kw)
    with pytest.raises(ValueError, match="chunk_tokens"):
        ServingEngine(gpt, chunk_tokens=12, **kw)
    teng = ServingEngine(gpt, draft_gpt=draft, spec_k=2, **kw)
    with pytest.raises(NotImplementedError, match="threefry"):
        teng.submit(np.zeros(3, np.int32), max_new_tokens=2, temperature=0.5)


def test_fleet_engine_needs_a_card_or_a_named_device(monkeypatch, gpt, draft):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(gpt, max_batch=2, page_size=PS, max_seq=MAX_SEQ, prefix_sharing=True,
                      chunk_tokens=16, draft_gpt=draft, spec_k=2)
