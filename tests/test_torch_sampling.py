"""The port's position-keyed temperature sampling, on the CPU.

serving/sampling.py draws the token at position p of a request with seed s
from one Philox4x32-10 uniform (counter (p, row), key s) by the inverse CDF
of softmax(logits / T). Held here: the numpy Philox against a per-round
pure-Python transcription of its definition (Salmon et al., SC '11) and
Random123's known-answer vectors; the uniforms' distribution (KS); the
sampled tokens' distribution against softmax (chi-square); temperature 0
as the argmax; the margins. Then every stream identity thunder_tpu's
tests/test_serving.py holds for its threefry-keyed sampler, ported: a
sampled request's stream is the same solo (GPTInference.generate with the
same seed) and batched, after a prefix hit, chunked, with a random draft
and with a perfect one (every proposal accepted), after preemption and
resume, and for seeds taken mod 2^32. torch cannot reproduce threefry, so
these streams are held against the port's own solo stream, not against
thunder_tpu's. tiny-llama2 (block_size 64), f32, random weights from a seed.
"""
import numpy as np
import pytest
import torch
from scipy import stats

import thunder_tpu_torch as tt
from thunder_tpu_torch.executors import graphex
from thunder_tpu_torch.inference import GPTInference
from thunder_tpu_torch.models.litgpt import GPT, Config
from thunder_tpu_torch.serving import ServingEngine
from thunder_tpu_torch.serving import sampling
from thunder_tpu_torch.serving.sampling import Sampler, philox4x32, philox_uniform, sample_tokens

pytestmark = pytest.mark.serve

PS = 8
MAX_SEQ = 64
VOCAB = 320

# ---------------------------------------------------------------------------
# Philox4x32-10
# ---------------------------------------------------------------------------


def _philox_reference(ctr, key, rounds=10):
    """Philox4x32 as SC '11 defines it, one round at a time in Python ints:
    (L1', R1', L0', R0') ... with the bijection
    (c0, c1, c2, c3) -> (hi(M1 c2) ^ c1 ^ k0, lo(M1 c2), hi(M0 c0) ^ c3 ^ k1, lo(M0 c0))
    and the key bumped by the Weyl constants before every round but the first."""
    M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
    c, k = list(ctr), list(key)
    for r in range(rounds):
        if r:
            k = [(k[0] + W0) & 0xFFFFFFFF, (k[1] + W1) & 0xFFFFFFFF]
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
    return c


# Random123's kat_vectors, philox4x32 with 10 rounds: (counter, key, output)
KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    ctr, key, want = KAT[case]
    assert _philox_reference(ctr, key) == list(want)
    assert [int(x) for x in philox4x32(ctr, key)] == list(want)


@pytest.mark.parametrize("rounds", [1, 2, 7, 10])
def test_philox_matches_per_round_transcription(rounds):
    rng = np.random.RandomState(rounds)
    ctr = rng.randint(0, 2 ** 32, (4, 256), dtype=np.uint64)
    key = rng.randint(0, 2 ** 32, (2, 256), dtype=np.uint64)
    got = np.stack([np.asarray(w) for w in philox4x32(ctr, key, rounds)])
    want = np.array([_philox_reference([int(x) for x in ctr[:, i]], [int(x) for x in key[:, i]], rounds)
                     for i in range(256)], np.uint64).T
    np.testing.assert_array_equal(got, want)


def test_uniform_counter_layout_and_range():
    """u is Philox's first word of counter (position, row, 0, 0) under key
    (seed mod 2^32, 0), as (x + 0.5) 2^-32, strictly inside (0, 1)."""
    seeds = np.array([0, 7, 2 ** 32 - 1, 12345])
    pos = np.array([0, 1, 2047, 10 ** 6])
    rows = np.array([0, 3, 0, 1])
    u = philox_uniform(seeds, pos, rows)
    for i in range(4):
        x = _philox_reference([int(pos[i]), int(rows[i]), 0, 0], [int(seeds[i]), 0])[0]
        assert u[i] == (x + 0.5) * 2.0 ** -32
    assert ((u > 0) & (u < 1)).all()
    assert philox_uniform(2 ** 32 + 5, 9, 0) == philox_uniform(5, 9, 0)
    assert sampling.canonical_seed(2 ** 32 + 5) == 5 and sampling.canonical_seed(-1) == 2 ** 32 - 1


def test_uniforms_pass_ks_over_1e5_counters():
    u = philox_uniform(42, np.arange(100_000), 0)
    assert stats.kstest(u, "uniform").pvalue > 1e-3
    u_rows = philox_uniform(3, 17, np.arange(100_000))
    assert stats.kstest(u_rows, "uniform").pvalue > 1e-3
    # neighbouring seeds are not the same stream
    assert not np.array_equal(philox_uniform(1, np.arange(64), 0), philox_uniform(2, np.arange(64), 0))


# ---------------------------------------------------------------------------
# sample_tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temp", [0.5, 1.0])
def test_sampled_tokens_follow_softmax(temp):
    V, n = 16, 1 << 15
    logits = torch.from_numpy(np.random.RandomState(0).randn(V).astype(np.float32) * 2)
    u = torch.from_numpy(philox_uniform(9, np.arange(n), 0))
    tok, margin = sample_tokens(logits.expand(n, V), u, torch.full((n,), temp))
    counts = np.bincount(tok.numpy(), minlength=V)
    p = torch.softmax(logits.double() / temp, -1).numpy()
    assert stats.chisquare(counts, p * n).pvalue > 1e-3
    assert (margin.numpy() >= 0).all() and (margin.numpy() <= 0.5).all()


def test_temperature_zero_rows_take_the_argmax():
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(6, 50).astype(np.float32))
    temps = torch.tensor([0.0, 0.7, 0.0, 1.0, 0.0, 2.0])
    tok, margin = sample_tokens(logits, torch.from_numpy(philox_uniform(3, np.arange(6), 0)), temps)
    greedy = torch.argmax(logits, -1)
    for r in (0, 2, 4):
        assert tok[r] == greedy[r] and margin[r] == float("inf")
    assert torch.isfinite(margin[[1, 3, 5]]).all()
    # bf16 logits: the argmax of the stored values
    lb = logits.to(torch.bfloat16)
    tok_b, _ = sample_tokens(lb, torch.full((6,), 0.5, dtype=torch.float64), torch.zeros(6))
    assert torch.equal(tok_b, torch.argmax(lb, -1))


def test_token_and_margin_against_f64_inverse_cdf():
    """The token is the interval of softmax's f64 cumulative sum holding
    u·total, and the margin the distance to its nearer edge over the total."""
    rng = np.random.RandomState(2)
    R, V = 64, 40
    logits = rng.randn(R, V).astype(np.float32)
    temps = rng.uniform(0.3, 1.5, R).astype(np.float32)
    u = philox_uniform(5, np.arange(R), 0)
    tok, margin = sample_tokens(torch.from_numpy(logits), torch.from_numpy(u), torch.from_numpy(temps))
    p = torch.softmax(torch.from_numpy(logits) / torch.from_numpy(temps)[:, None], -1).double().numpy()
    c = np.cumsum(p, -1)
    for r in range(R):
        t = u[r] * c[r, -1]
        k = int(tok[r])
        lo = c[r, k - 1] if k else 0.0
        assert lo <= t < c[r, k] or (k == V - 1 and t >= lo)
        np.testing.assert_allclose(float(margin[r]), min(t - lo, c[r, k] - t) / c[r, -1], rtol=1e-9, atol=1e-15)


def test_sampler_on_the_cpu_is_sample_tokens():
    """The engine's Sampler draws sample_tokens' tokens (draw_tokens: the
    same draw without the margins the engine never reads)."""
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(4, 30).astype(np.float32))
    u, temps = philox_uniform(1, np.arange(4), 0), np.array([0.8, 0.0, 1.0, 0.5], np.float32)
    s = Sampler("cpu")
    got = s(logits, u, temps)
    want, _ = sample_tokens(logits, torch.from_numpy(u), torch.from_numpy(temps))
    assert torch.equal(got, want)
    assert torch.equal(sampling.draw_tokens(logits, torch.from_numpy(u), torch.from_numpy(temps)), want)
    assert tt.graph_captures(s) == 0 and tt.graph_replays(s) == 0


# ---------------------------------------------------------------------------
# stream identities (ports of tests/test_serving.py's sampled cases)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt():
    return GPT(Config.from_name("tiny-llama2", block_size=MAX_SEQ), torch.float32, device="cpu", seed=11)


@pytest.fixture(scope="module")
def dense(gpt):
    return GPTInference(gpt, max_seq=MAX_SEQ, dtype=torch.float32)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def _engine(gpt, **kw):
    kw.setdefault("max_batch", 4)
    return ServingEngine(gpt, page_size=PS, max_seq=MAX_SEQ, dtype=torch.float32, device="cpu", **kw)


def _tokens(rng, n):
    return rng.randint(0, VOCAB, (n,)).astype(np.int32)


def _solo(dense, p, n, temp, seed):
    out, m = dense.generate(torch.from_numpy(p[None, :]), n, temperature=temp, seed=seed)
    return out[0, len(p):].numpy()


def test_temperature_stream_matches_dense_seeded(gpt, dense, rng):
    engine = _engine(gpt)
    p = _tokens(rng, 7)
    fut = engine.submit(p, max_new_tokens=8, temperature=0.9, seed=42)
    # a concurrent greedy request keeps the batch mixed
    other = engine.submit(_tokens(rng, 12), max_new_tokens=5)
    engine.drain()
    np.testing.assert_array_equal(fut.result().new_tokens, _solo(dense, p, 8, 0.9, 42))
    other.result()
    # the seed matters: another seed draws another stream
    assert not np.array_equal(_solo(dense, p, 8, 0.9, 43), _solo(dense, p, 8, 0.9, 42))


def test_seed_defaults_to_the_request_id(gpt, dense, rng):
    engine = _engine(gpt)
    p = _tokens(rng, 9)
    engine.submit(_tokens(rng, 4), 2)  # request 0
    fut = engine.submit(p, 6, temperature=1.0)  # request 1
    engine.drain()
    assert fut.result().request_id == 1
    np.testing.assert_array_equal(fut.result().new_tokens, _solo(dense, p, 6, 1.0, 1))


def test_seed_canonicalized_mod_2_32(gpt, dense, rng):
    p = _tokens(rng, 6)
    engine = _engine(gpt)
    f_big = engine.submit(p, 6, temperature=1.0, seed=(1 << 32) + 5)
    f_small = engine.submit(p, 6, temperature=1.0, seed=5)
    engine.drain()
    np.testing.assert_array_equal(f_big.result().new_tokens, f_small.result().new_tokens)
    np.testing.assert_array_equal(_solo(dense, p, 6, 1.0, (1 << 32) + 5), _solo(dense, p, 6, 1.0, 5))
    np.testing.assert_array_equal(f_small.result().new_tokens, _solo(dense, p, 6, 1.0, 5))


def test_generate_row_0_is_the_b1_stream(gpt, dense, rng):
    """Row b draws with counter (position, b): row 0 of a batch is the B=1
    stream (and so the engine's), other rows draw their own."""
    p = np.stack([_tokens(rng, 10) for _ in range(3)])
    out, m = dense.generate(torch.from_numpy(p), 6, temperature=0.8, seed=3)
    np.testing.assert_array_equal(out[0, 10:].numpy(), _solo(dense, p[0], 6, 0.8, 3))
    assert m.sample_margin.shape == (3, 6) and (m.sample_margin >= 0).all()
    q = np.stack([p[0], p[0]])
    out2, _ = dense.generate(torch.from_numpy(q), 12, temperature=1.0, seed=3)
    assert not np.array_equal(out2[0].numpy(), out2[1].numpy())  # same prompt, other row's draws


def test_prefix_sharing_suffix_prefill_matches_dense(gpt, dense, rng):
    engine = _engine(gpt, prefix_sharing=True)
    sys_p = _tokens(rng, 16)  # 2 pages
    reqs = []
    for i in range(3):
        p = np.concatenate([sys_p, _tokens(rng, 3)])
        reqs.append((p, engine.submit(p, max_new_tokens=5, temperature=0.7, seed=100 + i)))
    engine.drain()
    for i, (p, fut) in enumerate(reqs):
        np.testing.assert_array_equal(fut.result().new_tokens, _solo(dense, p, 5, 0.7, 100 + i))
    assert engine.prefix_hits == 2 and engine.prefix_tokens_saved == 2 * 16


def test_prefix_full_hit_skips_prefill(gpt, dense, rng):
    engine = _engine(gpt, prefix_sharing=True)
    donor = _tokens(rng, 16)
    f1 = engine.submit(donor, max_new_tokens=4, temperature=0.6, seed=7)
    engine.drain()
    f2 = engine.submit(donor, max_new_tokens=4, temperature=0.6, seed=7)  # exact repeat: both pages hit
    engine.drain()
    np.testing.assert_array_equal(f1.result().new_tokens, f2.result().new_tokens)
    np.testing.assert_array_equal(f1.result().new_tokens, _solo(dense, donor, 4, 0.6, 7))
    assert engine.prefix_hits == 1 and engine.prefix_tokens_saved == 15
    sub = donor[:11]  # partial tail: covered by page 2
    f3 = engine.submit(sub, max_new_tokens=4, temperature=0.5, seed=9)
    engine.drain()
    np.testing.assert_array_equal(f3.result().new_tokens, _solo(dense, sub, 4, 0.5, 9))
    assert engine.prefix_hits == 2


def test_chunked_prefill_matches_dense(gpt, dense, rng):
    engine = _engine(gpt, chunk_tokens=16, prefill_budget=16)
    reqs = []
    for L, n, seed in ((40, 5, 21), (23, 4, 22)):  # 16+16+final rung, 16+final (mid-page end)
        p = _tokens(rng, L)
        reqs.append((p, n, seed, engine.submit(p, max_new_tokens=n, temperature=0.8, seed=seed)))
    engine.drain()
    for p, n, seed, fut in reqs:
        np.testing.assert_array_equal(fut.result().new_tokens, _solo(dense, p, n, 0.8, seed))
    assert engine.chunk_calls > 0 and engine.cache.allocator.n_used == 0


def test_speculative_random_draft_matches_plain(gpt, dense, rng):
    """A draft with other weights: the draft samples its proposals with the
    request's draws at their own positions, the verify step samples its
    k+1 positions, and the accepted prefix is the plain stream."""
    draft = GPT(Config.from_name("tiny-llama2", block_size=MAX_SEQ), torch.float32, device="cpu", seed=12)
    engine = _engine(gpt, draft_gpt=draft, spec_k=2)
    reqs = []
    for L, temp, seed in ((9, 0.9, 31), (14, 0.0, 32), (6, 1.0, 33)):
        p = _tokens(rng, L)
        reqs.append((p, temp, seed, engine.submit(p, max_new_tokens=8, temperature=temp, seed=seed)))
    engine.drain()
    for p, temp, seed, fut in reqs:
        np.testing.assert_array_equal(fut.result().new_tokens, _solo(dense, p, 8, temp, seed))
    assert engine.spec_accepted < engine.spec_proposed  # proposals were rejected and rolled back
    assert engine.cache.allocator.n_used == 0


def test_all_stages_composed_match_dense(gpt, dense, rng):
    """Sharing + chunking + speculation at once, the target as its own draft:
    every proposal verifies (the draft draws what the target draws) and
    every stream is its solo stream."""
    engine = _engine(gpt, prefix_sharing=True, chunk_tokens=16, draft_gpt=gpt, spec_k=3)
    sys_p = _tokens(rng, 24)
    reqs = []
    for tail_len, n, temp, seed in [(0, 6, 0.0, 11), (5, 7, 0.8, 12), (9, 4, 0.0, 13), (2, 5, 0.5, 14)]:
        p = np.concatenate([sys_p, _tokens(rng, tail_len)]) if tail_len else sys_p.copy()
        reqs.append((p, n, temp, seed, engine.submit(p, max_new_tokens=n, temperature=temp, seed=seed)))
        if tail_len == 0:
            engine.drain()  # warm the prefix cache before the sharers arrive
    engine.drain()
    for p, n, temp, seed, fut in reqs:
        np.testing.assert_array_equal(fut.result().new_tokens, _solo(dense, p, n, temp, seed))
    assert engine.prefix_hits > 0 and engine.spec_proposed > 0
    assert engine.spec_accepted == engine.spec_proposed  # perfect draft


def test_preemption_spill_resume_identity(gpt, dense, rng):
    """A sampled batch-lane victim spilled for an interactive admission
    resumes and finishes with the stream it would have drawn unpreempted."""
    engine = _engine(gpt, n_pages=9)  # 8 usable
    victim_p = _tokens(rng, 9)
    victim = engine.submit(victim_p, max_new_tokens=20, temperature=0.9, seed=77, lane="batch")
    engine._step_once()
    engine._step_once()
    inter_p = _tokens(rng, 30)
    inter = engine.submit(inter_p, max_new_tokens=10, temperature=0.7, seed=78)
    engine.drain()
    assert engine.preempted >= 1 and engine.resumed >= 1
    np.testing.assert_array_equal(victim.result().new_tokens, _solo(dense, victim_p, 20, 0.9, 77))
    np.testing.assert_array_equal(inter.result().new_tokens, _solo(dense, inter_p, 10, 0.7, 78))


def test_greedy_batch_runs_no_sampler(gpt, rng, monkeypatch):
    """An all-greedy wave takes the argmax and never calls the sampler; a
    sampled request in the wave calls it."""
    calls = []
    real = Sampler.__call__
    monkeypatch.setattr(Sampler, "__call__", lambda self, *a: calls.append(a[0].shape) or real(self, *a))
    engine = _engine(gpt, draft_gpt=gpt, spec_k=2)
    for L in (5, 9):
        engine.submit(_tokens(rng, L), 4)
    engine.drain()
    assert calls == []
    engine.submit(_tokens(rng, 5), 4, temperature=0.5)
    engine.drain()
    # first token (1 row), draft proposals (max_batch rows), verify (max_batch * 3 rows)
    V = gpt.cfg.padded_vocab_size
    assert {tuple(s) for s in calls} == {(1, V), (4, V), (12, V)}


def _sampling_early(real):
    """The engine's uniforms drawn one position before the token's own."""
    return lambda seeds, positions, rows: real(seeds, np.asarray(positions) - 1, rows)


def _sampling_hotter(real):
    """The engine's sampler drawing at 1.25 times the request's temperature."""
    return lambda self, logits, u, temps: real(self, logits, u, np.asarray(temps) * 1.25)


@pytest.mark.parametrize("fault", [None, "position", "temperature"])
def test_chip_smoke_sampled_rule_fails_a_planted_fault(gpt, dense, rng, monkeypatch, fault):
    """chip_smoke.py's sampled-agreement rule, on the CPU: a speculative
    engine with a random draft and chunks, its draws read by EngineDraws,
    against solo GPTInference. Healthy, every sampled draw is compared and
    nothing fails; with the engine drawing one position early, or at
    another temperature, every sampled stream fails the rule."""
    import chip_smoke
    from thunder_tpu_torch.serving import scheduler

    if fault == "position":
        monkeypatch.setattr(scheduler, "philox_uniform", _sampling_early(scheduler.philox_uniform))
    elif fault == "temperature":
        monkeypatch.setattr(Sampler, "__call__", _sampling_hotter(Sampler.__call__))
    draft = GPT(Config.from_name("tiny-llama2", block_size=MAX_SEQ), torch.float32, device="cpu", seed=12)
    engine = _engine(gpt, draft_gpt=draft, spec_k=2, chunk_tokens=8)
    tap = chip_smoke.EngineDraws(engine)
    specs = [(_tokens(rng, 9), 0.9, 2 ** 32 + 31), (_tokens(rng, 14), 0.0, 32), (_tokens(rng, 20), 0.7, 33),
             (_tokens(rng, 6), 1.0, 34)]
    futs = [engine.submit(p, max_new_tokens=10, temperature=t, seed=sd) for p, t, sd in specs]
    engine.drain()
    tap.remove()
    rows = chip_smoke.solo_rows(dense, [p for p, _, _ in specs], [(t, sd) for _, t, sd in specs],
                                [f.result().new_tokens for f in futs], tap)
    sampled = [r for r in rows if r.get("temperature", 0) > 0]
    failing = chip_smoke.rows_failing(rows)
    if fault is None:
        assert failing == []
        assert all(r["equal"] and r["draws_compared"] == 10 for r in sampled)
        assert chip_smoke.sampled_summary(rows)["max_shift"] < 1e-6
    else:
        assert failing == sampled and all("fault" in r for r in sampled)


def test_bad_temperature_fails_the_request(gpt):
    engine = _engine(gpt)
    fut = engine.submit(np.zeros(3, np.int32), 2, temperature=-1.0)
    with pytest.raises(ValueError, match="temperature"):
        fut.result()
    with pytest.raises(ValueError, match="temperature"):
        GPTInference(gpt, dtype=torch.float32).generate(np.zeros((1, 3), np.int32), 2, temperature=float("nan"))


# ---------------------------------------------------------------------------
# the sampler's captured programs (CUDA graphs stood in for on the CPU)
# ---------------------------------------------------------------------------


def _fake_capture(fn, static, pool):
    """torch.cuda.graph's stand-in (tests/test_torch_graphs.py): the capture
    runs fn once, a replay runs it again on the static inputs."""
    out = fn(*static)
    recorded = torch.utils._pytree.tree_flatten(out)[0]

    def replay():
        with torch.no_grad():
            for o, n in zip(recorded, torch.utils._pytree.tree_flatten(fn(*static))[0]):
                o.copy_(n)

    return replay, out


def test_sampled_wave_after_warmup_captures_nothing(gpt, dense, rng, monkeypatch):
    """warmup captures the sampler's program of every row count the wave
    uses (first token, draft proposals, verify); the sampled wave then only
    replays them, and its streams are the solo streams."""
    monkeypatch.setattr(graphex, "captures_on", lambda device: True)
    monkeypatch.setattr(graphex.CUDAGraphProgram, "_capture_fn", staticmethod(_fake_capture))
    engine = _engine(gpt, draft_gpt=gpt, spec_k=2, prefix_sharing=True, chunk_tokens=16)
    specs = [(_tokens(rng, 20), 0.8, 5), (_tokens(rng, 7), 0.0, 6), (_tokens(rng, 12), 1.0, 7)]
    engine.warmup([len(p) for p, _, _ in specs])
    assert tt.graph_captures(engine.sampler) == 3
    before = tt.graph_captures(engine.sampler), tt.graph_replays(engine.sampler)
    futs = [engine.submit(p, 6, temperature=t, seed=s) for p, t, s in specs]
    engine.drain()
    assert tt.graph_captures(engine.sampler) == before[0]
    assert tt.graph_replays(engine.sampler) > before[1]
    for (p, t, s), f in zip(specs, futs):
        np.testing.assert_array_equal(f.result().new_tokens, _solo(dense, p, 6, t, s))
