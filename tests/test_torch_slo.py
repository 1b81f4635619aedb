"""The port's SLO monitoring against thunder_tpu's, on the CPU.

observability/slo.py is the port's own copy of thunder_tpu's: SLOPolicy's
validation, and SLOMonitor fed the same sample sequences gives the same
status(), burn rates and slo.breach / slo.recovered events (the throughput
target reads the host clock, so both packages' monitors read one pinned
fake clock). Then ports of tests/test_telemetry.py's engine and TrainStep
SLO cases, each held against thunder_tpu's engine or TrainStep under the
same policy: slo_met flags, goodput, stats, breach reasons, the reset after
warmup, cancelled requests left out; burn-rate preemption (an impossible
TTFT target sheds batch-lane sequences while interactive requests wait,
greedy streams unchanged); the serve.* counters of one wave, equal to
thunder_tpu's. tiny-llama2 at one layer (block_size 64), f32, thunder_tpu's
weights carried across.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu import observability as jobs
from thunder_tpu import optim as jopt
from thunder_tpu.models.litgpt import GPT as JaxGPT
from thunder_tpu.models.litgpt import Config as JaxConfig
from thunder_tpu.observability import slo as jslo
from thunder_tpu.serving import ServingEngine as JaxServingEngine
from thunder_tpu.training import TrainStep as JaxTrainStep
from thunder_tpu_torch import nn as tnn
from thunder_tpu_torch import observability as tobs
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.observability import slo as tslo
from thunder_tpu_torch.observability import telemetry as ttel
from thunder_tpu_torch.ops import ltorch as tlt
from thunder_tpu_torch.serving import ServingEngine
from thunder_tpu_torch.training import TrainStep

pytestmark = pytest.mark.serve

PS, MAX_SEQ, VOCAB = 8, 64, 320


@pytest.fixture
def buses():
    """Both packages' event buses on and empty; off and empty after."""
    from thunder_tpu.observability import flight_recorder as fr

    for obs in (jobs, tobs):
        obs.reset()
        obs.enable()
    fr.reset()
    yield
    for obs in (jobs, tobs):
        obs.disable()
        obs.reset()
    fr.reset()


def _slo_events(obs, names=("slo.breach", "slo.recovered")):
    return [(r["name"], r["attrs"]) for r in obs.records() if r["kind"] == "event" and r["name"] in names]


def _counters(obs, prefix):
    return {k: v for k, v in obs.counters().items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the policy, the monitor and percentile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [({}, "at least one target"),
                                      ({"p99_ttft_ms": 1.0, "objective": 1.5}, "objective"),
                                      ({"min_goodput": 1.5}, "min_goodput"),
                                      ({"p99_ttft_ms": 1.0, "window": 1}, "window"),
                                      ({"p99_ttft_ms": 1.0, "min_samples": 0}, "min_samples")])
def test_policy_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match) as t_err:
        tslo.SLOPolicy(**kw)
    with pytest.raises(ValueError) as j_err:
        jslo.SLOPolicy(**kw)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("ttft,tbot", [(5.0, 1.0), (50.0, None), (5.0, 20.0), (50.0, 20.0)])
def test_request_met_matches_jax(ttft, tbot):
    kw = dict(p99_ttft_ms=10.0, p99_tbot_ms=10.0)
    assert tslo.SLOPolicy(**kw).request_met(ttft, tbot) == jslo.SLOPolicy(**kw).request_met(ttft, tbot)


def test_percentile_is_thunder_tpus_nearest_rank():
    from thunder_tpu.observability.telemetry import percentile as jpct

    rng = np.random.RandomState(0)
    for n in (0, 1, 2, 7, 100):
        xs = list(rng.exponential(size=n))
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert ttel.percentile(xs, q) == jpct(xs, q)


def _pin_clock(monkeypatch, ticks):
    """A fake host clock for each package's monitors, the two alike: each
    read advances it by the next of ``ticks`` (cycled)."""
    def fake():
        state = {"t": 100.0, "i": 0}

        def clock():
            state["t"] += ticks[state["i"] % len(ticks)]
            state["i"] += 1
            return state["t"]

        return types.SimpleNamespace(perf_counter=clock)

    monkeypatch.setattr(jslo, "time", fake())
    monkeypatch.setattr(tslo, "time", fake())


SEQUENCES = {
    # latency targets into breach, through a clean window into recovery
    "ttft_breach_recover": (dict(p99_ttft_ms=10.0, window=4, min_samples=2),
                            [("req", 100.0, None, False, 0)] * 6 + [("req", 1.0, None, True, 0)] * 6),
    "tbot_and_goodput": (dict(p99_tbot_ms=5.0, min_goodput=0.75, window=16, min_samples=4),
                         [("req", 1.0, 2.0 + (i % 5) * 1.5, i % 5 < 3, 8) for i in range(40)]),
    "throughput": (dict(min_tokens_per_s=1000.0, window=8, min_samples=4),
                   [("req", 1.0, 1.0, True, 1)] * 6 + [("req", 1.0, 1.0, True, 64)] * 10),
    "train_step_time": (dict(p99_step_ms=20.0, min_tokens_per_s=5e5, tokens_per_step=1024, window=8,
                             min_samples=2),
                        [("step", 10.0 + 3 * i) for i in range(12)] + [("step", 1.0)] * 10),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_monitor_matches_jax_on_the_same_samples(name, buses, monkeypatch):
    """status() after every sample, the breach transitions, and the
    slo.breach / slo.recovered events and counters."""
    _pin_clock(monkeypatch, [0.001, 0.004, 0.002])
    kw, seq = SEQUENCES[name]
    jm, tm = jslo.SLOMonitor(jslo.SLOPolicy(**kw), source="t"), tslo.SLOMonitor(tslo.SLOPolicy(**kw), source="t")
    for sample in seq:
        for m in (jm, tm):
            if sample[0] == "req":
                m.observe_request(ttft_ms=sample[1], tbot_ms=sample[2], met=sample[3], tokens=sample[4])
            else:
                m.observe_step(sample[1])
        assert tm.status() == jm.status()
        assert tm.goodput() == jm.goodput()
    assert tm.breaches == jm.breaches > 0
    assert _slo_events(tobs) == _slo_events(jobs)
    assert _counters(tobs, "slo.") == _counters(jobs, "slo.")


def test_breach_emits_once_then_recovers(buses):
    """A sustained breach emits one transition event; recovery emits
    slo.recovered; events.reset() clears the live monitor's windows."""
    mon = tslo.SLOMonitor(tslo.SLOPolicy(p99_ttft_ms=10.0, window=4, min_samples=2), source="t")
    for _ in range(6):
        mon.observe_request(ttft_ms=100.0, tbot_ms=None, met=False)
    assert len(_slo_events(tobs, ("slo.breach",))) == 1
    for _ in range(6):
        mon.observe_request(ttft_ms=1.0, tbot_ms=None, met=True)
    assert len(_slo_events(tobs, ("slo.recovered",))) == 1 and mon.status()["breached"] == []
    mon.observe_request(ttft_ms=1.0, tbot_ms=None, met=True)
    tobs.reset()
    assert mon.goodput() is None and mon.breaches == 0


# ---------------------------------------------------------------------------
# the engine, against thunder_tpu's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jgpt():
    return JaxGPT(JaxConfig.from_name("tiny-llama2", block_size=MAX_SEQ, n_layer=1), dtype=jnp.float32)


@pytest.fixture(scope="module")
def gpt(jgpt):
    g = tlg.GPT(tlg.Config.from_name("tiny-llama2", block_size=MAX_SEQ, n_layer=1), torch.float32, device="cpu")
    tlg.load_jax_params(g, {k: np.asarray(p.data) for k, p in jgpt.named_parameters()})
    return g


def _engines(jgpt, gpt, jpolicy, tpolicy, **kw):
    kw.setdefault("max_batch", 4)
    kw.update(page_size=PS, max_seq=MAX_SEQ)
    return (JaxServingEngine(jgpt, dtype=jnp.float32, slo=jpolicy, **kw),
            ServingEngine(gpt, dtype=torch.float32, device="cpu", slo=tpolicy, **kw))


def _policies(**kw):
    return jslo.SLOPolicy(**kw), tslo.SLOPolicy(**kw)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (L,)).astype(np.int32) for L in lens]


def _stats_slo(st):
    return {k: st[k] for k in ("requests_retired", "requests_slo_met", "goodput")}


def test_breach_event_and_goodput(jgpt, gpt, buses):
    """An impossible TBOT target: every result carries slo_met=False, both
    engines' monitors breach p99-tbot and goodput with burn rates >= 1, and
    goodput is 0.0 (thunder_tpu's serve.goodput gauge is not ported; the
    engine's goodput() is the same number)."""
    jeng, teng = _engines(jgpt, gpt, *_policies(p99_tbot_ms=1e-4, min_goodput=0.9, window=32, min_samples=2))
    for eng in (jeng, teng):
        futs = [eng.submit(p, max_new_tokens=4) for p in _prompts(0, (5, 9, 12, 7))]
        eng.drain()
        assert all(f.result().slo_met is False for f in futs)
    tev, jev = _slo_events(tobs, ("slo.breach",)), _slo_events(jobs, ("slo.breach",))
    assert {a["reason"] for _, a in tev} == {a["reason"] for _, a in jev} >= {"p99-tbot", "goodput"}
    for _, a in tev:
        assert a["source"] == "serving" and a["burn_rate"] >= 1.0
    assert _counters(tobs, "slo.") == _counters(jobs, "slo.")
    ts, js = teng.stats(), jeng.stats()
    assert _stats_slo(ts) == _stats_slo(js) == {"requests_retired": 4, "requests_slo_met": 0, "goodput": 0.0}
    assert ts["slo"]["targets"]["p99-tbot"]["breached"] is True
    assert ts["slo"]["breached"] == js["slo"]["breached"]
    assert teng.goodput() == jeng.goodput() == 0.0


def test_met_slo_keeps_goodput_at_one(jgpt, gpt, buses):
    jeng, teng = _engines(jgpt, gpt, *_policies(p99_ttft_ms=1e9, p99_tbot_ms=1e9, window=32, min_samples=2))
    for eng in (jeng, teng):
        fut = eng.submit(_prompts(1, (6,))[0], 4)
        eng.drain()
        assert fut.result().slo_met is True
        assert eng.goodput() == 1.0
    assert not _slo_events(tobs) and not _slo_events(jobs)


def test_reset_slo_accounting(jgpt, gpt, buses):
    """warmup traffic is excluded: counters zero, the monitor restarts with
    the same policy, later traffic counts."""
    jp, tp = _policies(p99_ttft_ms=1e9, window=32, min_samples=2)
    jeng, teng = _engines(jgpt, gpt, jp, tp)
    p = _prompts(2, (6,))[0]
    for eng, policy in ((jeng, jp), (teng, tp)):
        eng.submit(p, max_new_tokens=3)
        eng.drain()
        assert eng.requests_retired == 1
        eng.reset_slo_accounting()
        assert eng.requests_retired == 0 and eng.goodput() is None
        assert eng.slo_monitor.policy is policy and eng.slo_monitor.goodput() is None
        eng.submit(p, max_new_tokens=3)
        eng.drain()
        assert eng.goodput() == 1.0
    assert _stats_slo(teng.stats()) == _stats_slo(jeng.stats())


def test_cancelled_requests_excluded_from_goodput(jgpt, gpt, buses):
    jeng, teng = _engines(jgpt, gpt, *_policies(p99_ttft_ms=1e9, window=32, min_samples=2))
    p = _prompts(3, (6,))[0]
    for eng in (jeng, teng):
        f = eng.submit(p, max_new_tokens=30)
        eng._step_once()
        assert f.cancel()
        ok = eng.submit(p, max_new_tokens=3)
        eng.drain()
        assert ok.result().slo_met is True
        assert eng.stats()["requests_retired"] == 1  # the cancel is not counted
    assert _counters(tobs, "serve.cancelled") == _counters(jobs, "serve.cancelled") == {"serve.cancelled": 1}


def _burn_wave(eng):
    """One short request (its retirement breaches the impossible TTFT
    target), two long batch-lane requests, then, once they decode,
    interactive requests that wait while the target burns."""
    first = eng.submit(_prompts(3, (5,))[0], max_new_tokens=2)
    eng.drain()
    longs = [first] + [eng.submit(p, max_new_tokens=12, lane="batch") for p in _prompts(4, (20, 17))]
    for _ in range(3):
        eng._step_once()
    inter = [eng.submit(p, max_new_tokens=4) for p in _prompts(5, (9, 6, 11, 5, 8))]
    eng.drain()
    return [f.result().new_tokens for f in longs + inter]


def test_burn_rate_preemption_matches_jax_and_keeps_streams(jgpt, gpt, buses):
    """An impossible p99 TTFT breaches on the first retirement; while it
    burns and interactive requests wait, each iteration sheds one batch-lane
    sequence (spilled, resumed later). Both engines preempt alike, and every
    greedy stream equals the stream without a policy."""
    kw = dict(max_batch=2)
    jeng, teng = _engines(jgpt, gpt, *_policies(p99_ttft_ms=1e-6, window=8, min_samples=1), **kw)
    _, plain = _engines(jgpt, gpt, None, None, **kw)
    got, want, ref = _burn_wave(teng), _burn_wave(plain), _burn_wave(jeng)
    assert teng.preempted >= 1 and teng.resumed >= 1 and plain.preempted == 0
    assert (teng.preempted, teng.resumed) == (jeng.preempted, jeng.resumed)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    assert "p99-ttft" in {a["reason"] for _, a in _slo_events(tobs, ("slo.breach",))}
    assert _counters(tobs, "serve.preempted") == _counters(jobs, "serve.preempted")


def test_serve_counters_match_jax(jgpt, gpt, buses):
    """The serve.* counters of one wave through prefix sharing, chunks and
    a self-draft: thunder_tpu's counter for counter."""
    jeng = JaxServingEngine(jgpt, dtype=jnp.float32, max_batch=4, page_size=PS, max_seq=MAX_SEQ,
                            prefix_sharing=True, chunk_tokens=16, draft_gpt=jgpt, spec_k=2)
    teng = ServingEngine(gpt, dtype=torch.float32, device="cpu", max_batch=4, page_size=PS, max_seq=MAX_SEQ,
                         prefix_sharing=True, chunk_tokens=16, draft_gpt=gpt, spec_k=2)
    shared = _prompts(6, (16,))[0]
    prompts = [np.concatenate([shared, t]) for t in _prompts(7, (3, 5))] + _prompts(8, (40, 7))
    for eng in (jeng, teng):
        futs = [eng.submit(prompts[0], max_new_tokens=5)]
        eng.drain()  # the shared pages enter the prefix cache
        futs += [eng.submit(p, max_new_tokens=5) for p in prompts[1:]]
        eng.drain()
        [f.result() for f in futs]
    tc, jc = _counters(tobs, "serve."), _counters(jobs, "serve.")
    assert tc == jc and tc["serve.prefix_hits"] >= 1 and tc["serve.retired"] == len(prompts)
    assert tc["serve.spec_proposed"] > 0 and tc["serve.prefill_tokens"] > 0


def test_serve_counters_off_the_bus_record_nothing(gpt):
    assert not tobs.enabled()
    teng = ServingEngine(gpt, max_batch=2, page_size=PS, max_seq=MAX_SEQ, dtype=torch.float32, device="cpu")
    teng.submit(_prompts(9, (5,))[0], 3)
    teng.drain()
    assert tobs.records() == [] and tobs.counters() == {}


# ---------------------------------------------------------------------------
# TrainStep(slo=), against thunder_tpu's
# ---------------------------------------------------------------------------


class _Net(torch.nn.Module):
    """tests/test_telemetry.py's net, in the port."""

    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(8, 4, device="cpu", generator=torch.Generator().manual_seed(0))

    def forward(self, x, y):
        return tlt.mse_loss(self.fc(x), y)


def _jax_step(rng, **kw):
    from thunder_tpu import nn as jnn
    from thunder_tpu.ops import ltorch as jlt

    class Net(jnn.Module):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(8, 4, seed=0)

        def forward(self, x, y):
            return jlt.mse_loss(self.fc(x), y)

    step = JaxTrainStep(tj.jit(Net()), jopt.AdamW(lr=0.05), **kw)
    return step, jnp.asarray(rng.rand(4, 8).astype(np.float32)), jnp.asarray(rng.rand(4, 4).astype(np.float32))


def _port_step(rng, **kw):
    step = TrainStep(tt.jit(_Net()), topt.AdamW(lr=0.05), **kw)
    return step, torch.from_numpy(rng.rand(4, 8).astype(np.float32)), torch.from_numpy(rng.rand(4, 4).astype(np.float32))


def test_train_step_time_and_throughput_breach(buses):
    """Impossible step-time and throughput targets breach with the same
    reasons on both packages' TrainSteps."""
    kw = dict(p99_step_ms=1e-6, min_tokens_per_s=1e15, window=16, min_samples=2, tokens_per_step=1024)
    rng = np.random.RandomState(0)
    for make, policy in ((_jax_step, jslo.SLOPolicy(**kw)), (_port_step, tslo.SLOPolicy(**kw))):
        step, x, y = make(rng, slo=policy)
        for _ in range(5):
            float(step(x, y))
        st = step.slo_monitor.status()
        assert st["source"] == "training" and st["targets"]["p99-step-time"]["breached"] is True
    reasons = lambda obs: {a["reason"] for _, a in _slo_events(obs, ("slo.breach",))}  # noqa: E731
    assert reasons(tobs) == reasons(jobs) == {"p99-step-time", "tokens-per-s"}


def test_train_throughput_target_without_tokens_per_step_rejected():
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError, match="tokens_per_step"):
        _port_step(rng, slo=tslo.SLOPolicy(min_tokens_per_s=40_000))
    with pytest.raises(ValueError, match="tokens_per_step"):
        _jax_step(rng, slo=jslo.SLOPolicy(min_tokens_per_s=40_000))


def test_train_monitor_without_bus_emits_nothing():
    assert not tobs.enabled()
    step, x, y = _port_step(np.random.RandomState(0), slo=tslo.SLOPolicy(p99_step_ms=1e-6, window=16,
                                                                           min_samples=2))
    for _ in range(4):
        float(step(x, y))
    assert step.slo_monitor.status()["targets"]["p99-step-time"]["breached"]
    assert tobs.records() == [] and tobs.counters() == {}
