"""The port's resilient training (thunder_tpu_torch/robustness/) against
thunder_tpu's, on the CPU; on a CUDA card (``-m gpu``) the AdamW kernel's
skip flag and a captured guarded step.

* Fault plans parse, scope and fire as thunder_tpu's do (the same specs,
  the same refusals, the same consumption order).
* Guards on tiny-llama2 (thunder_tpu's weights carried across by
  ``load_jax_params``; the loss times a float ``scale`` input of ones,
  which ``nan_loss`` poisons), f32, AdamW, under one fault plan on both
  sides: skip with its budget, raise, rollback with its budget. Losses
  agree with thunder_tpu's to 1e-5 relative (NaN where thunder_tpu's are
  NaN), the same step raises the same error, and every skipped step
  leaves the parameters, m, v and the device step bit-equal.
* A skipped step gates the forward's buffer writes (BatchNorm running
  stats, SGD with and without momentum) as thunder_tpu's does.
* Bounded retry recovers and its budget is enforced; no guard, no retry.
* CheckpointManager: periodic saves and keep-k, a bit-identical restore
  (also into a step that has not run), a corrupt latest falling back to an
  older save, save failures non-fatal or strict, idle steps doing no work.
* Kill and resume: a subprocess killed by ``die@7`` (os._exit) after its
  step-4 save, a second one restoring it: losses bit-equal to an
  uninterrupted run. Preemption through SIGTERM with a prefetching loader
  (its cursor counts what the step took), escalation, opt-in SIGINT, and
  ``close()`` giving SIGTERM back.
* Format parity both ways: thunder_tpu's ``tools/ckpt_inspect.py`` accepts
  a directory the port wrote (0) and rejects it after one byte of its npz
  is flipped (1); thunder_tpu restores it; a thunder_tpu tiny-llama2
  checkpoint after 3 f32 steps restores into the port
  (``load_jax_checkpoint``) and 3 more steps match thunder_tpu's own
  continuation to 1e-5. ``parallel/checkpoint.py`` flattens in jax's
  order and writes jax's treedef as its structure note; a tree of bf16,
  fp8, f16, int64, None and tuples round-trips bit for bit and crosses
  to thunder_tpu's load and back.
* A planted fault: a gate that is dropped (the update and the step counter
  advance on a NaN step) fails the skip check.
"""
import importlib.util
import json
import os
import signal
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import thunder_tpu_torch as tt
from thunder_tpu_torch import nn as tnn
from thunder_tpu_torch import observability
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.ops import ltorch as tlt
from thunder_tpu_torch.robustness import (
    CheckpointError,
    CheckpointManager,
    GuardPolicy,
    NonFiniteLossError,
    Preempted,
    StepGuard,
    faults,
    list_steps,
    validate_step,
)
from thunder_tpu_torch.robustness.faults import InjectedCheckpointError, InjectedTransientError
from thunder_tpu_torch.training import TrainStep

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture
def jfaults():
    """thunder_tpu's fault plan, disarmed around the test (the card tests
    import no jax: this file imports it only inside CPU tests)."""
    from thunder_tpu.robustness import faults as jf

    jf.clear()
    yield jf
    jf.clear()


@pytest.fixture
def obs():
    observability.reset()
    observability.enable()
    yield
    observability.disable()
    observability.reset()


def _events(name):
    return [r for r in observability.records() if r.get("kind") == "event" and r.get("name") == name]


class _Net(torch.nn.Module):
    """thunder_tpu's tests/test_robustness.py net, in the port."""

    def __init__(self, seed: int = 1):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc1 = tnn.Linear(8, 16, device="cpu", generator=g)
        self.fc2 = tnn.Linear(16, 4, device="cpu", generator=g)

    def forward(self, x, y):
        return tlt.mse_loss(self.fc2(tlt.gelu(self.fc1(x))), y)


def _make_step(guard=None, lr=1e-2):
    step = TrainStep(tt.jit(_Net()), topt.AdamW(lr=lr), guard=guard)
    rng = np.random.RandomState(7)
    return step, torch.tensor(rng.randn(4, 8), dtype=torch.float32), torch.zeros(4, 4)


def _state(step) -> dict:
    """Copies of every tensor the update writes: parameters, buffers and
    the optimizer's state."""
    from thunder_tpu_torch.parallel.checkpoint import flatten

    out = {f"p.{k}": p.detach().clone() for k, p in step.tmodule.get_parameters().items()}
    out.update({f"b.{k}": b.clone() for k, b in step.tmodule.get_buffers().items()})
    if step.opt_state is not None:
        out.update({f"o{i}": t.clone() for i, t in enumerate(flatten(step.opt_state))})
    return out


@torch.no_grad()
def _write_state(step, saved: dict) -> None:
    """``_state``'s copies written back in place."""
    from thunder_tpu_torch.parallel.checkpoint import flatten

    for k, p in step.tmodule.get_parameters().items():
        p.copy_(saved[f"p.{k}"])
    for k, b in step.tmodule.get_buffers().items():
        b.copy_(saved[f"b.{k}"])
    for i, t in enumerate(flatten(step.opt_state)):
        t.copy_(saved[f"o{i}"])


def _assert_state_equal(a: dict, b: dict, what: str = "") -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}{k} changed"


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

SPECS = ["nan_loss@5, transient@7*2,preempt@9", "slow(30)@0*24:host=1", "ckpt_fail@4:host=1",
         "oom@3", "die@7", "nan_loss@2,nan_loss@5*3", "slow@1"]
BAD_SPECS = ["nan_loss5", "frobnicate@3", "nan_loss@5:rank=1", "slow(30@1", "nan_loss@-1", "transient@2*0"]


def _plan_tuple(plan):
    return [(f.kind, f.step, f.count, f.host, f.arg) for f in plan.faults]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_as_thunder_tpu(spec):
    from thunder_tpu.robustness import faults as jfaults

    assert _plan_tuple(faults.FaultPlan.parse(spec)) == _plan_tuple(jfaults.FaultPlan.parse(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_refuses_what_thunder_tpu_refuses(spec):
    from thunder_tpu.robustness import faults as jfaults

    with pytest.raises(ValueError):
        jfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(spec)


def test_fault_plan_fires_in_thunder_tpu_order(monkeypatch, jfaults):
    monkeypatch.setenv("TT_MP_PROC", "1")
    faults._reset_host_index()
    jfaults._reset_host_index()
    try:
        spec = "transient@3*2,nan_loss@2,nan_loss@5*3,slow(7)@1:host=1,oom@0:host=0"
        ours, theirs = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
        for step in range(9):
            for kind in faults.KINDS:
                a, b = ours.consume(kind, step), theirs.consume(kind, step)
                assert (a is None) == (b is None), (kind, step)
                assert a is None or a.arg == b.arg
        # host 0's fault never fires on host 1
        assert [repr(f) for f in ours.pending()] == [repr(f) for f in theirs.pending()] == ["oom@0*1:host=0(fired=0)"]
    finally:
        faults._reset_host_index()
        jfaults._reset_host_index()


def test_inactive_plan_is_one_global_read():
    assert not faults.active() and not faults.should_fire("nan_loss", 0)
    faults.maybe_die(0)  # nothing armed: returns
    x = torch.ones(3)
    assert faults.maybe_poison((x,), {}, 0)[0][0] is x


def test_poison_scales_the_first_float_tensor_and_refuses_token_batches():
    faults.configure("nan_loss@0*2")
    idx, scale = torch.zeros(2, 3, dtype=torch.int32), torch.ones(())
    (i2, s2), kw = faults.maybe_poison((idx, scale), {}, 0)
    assert i2 is idx and torch.isnan(s2) and scale.item() == 1.0
    with pytest.raises(RuntimeError, match="no float"):
        faults.maybe_poison((idx,), {}, 1)


def test_oom_raises_torchs_allocator_error():
    faults.configure("oom@2")
    faults.maybe_oom(1)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="injected oom fault at step 2"):
        faults.maybe_oom(2)


# ---------------------------------------------------------------------------
# guards on tiny-llama2 against thunder_tpu
# ---------------------------------------------------------------------------

B, T, N_BATCHES = 2, 16, 10


class _TScaled(torch.nn.Module):
    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, idx, tgt, scale):
        return tlt.mul(self.lm(idx, tgt), scale)


def _jax_scaled(lm):
    from thunder_tpu import nn as jnn
    from thunder_tpu.ops import ltorch as jlt

    class _JScaled(jnn.Module):
        def __init__(self, lm):
            super().__init__()
            self.lm = lm

        def forward(self, idx, tgt, scale):
            return jlt.mul(self.lm(idx, tgt), scale)

    return _JScaled(lm)


def _llama_batches(vocab: int) -> list:
    rng = np.random.RandomState(3)
    return [(rng.randint(0, vocab, (B, T)).astype(np.int32), rng.randint(0, vocab, (B, T)).astype(np.int32))
            for _ in range(N_BATCHES)]


def _llama_steps(policy: dict, tmp_path=None, every_n_steps=2):
    """Both packages' guarded TrainSteps over the same tiny-llama2 weights,
    f32, AdamW(lr=1e-3), with CheckpointManagers (npz layout, blocking) when
    ``tmp_path`` is given: (jax step, port step)."""
    import thunder_tpu as tj
    from thunder_tpu import optim as jopt
    from thunder_tpu.models import litgpt as jlg
    from thunder_tpu.robustness import CheckpointManager as JManager
    from thunder_tpu.robustness import GuardPolicy as JPolicy
    from thunder_tpu.robustness import StepGuard as JGuard
    from thunder_tpu.training import TrainStep as JaxTrainStep

    jm = _jax_scaled(jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2")))
    tm = _TScaled(tlg.GPTForCausalLM(tlg.Config.from_name("tiny-llama2"), device="cpu"))
    tlg.load_jax_params(tm.lm, {k: np.asarray(p.data) for k, p in jm.lm.named_parameters()})
    js = JaxTrainStep(tj.jit(jm), jopt.AdamW(lr=1e-3), guard=JGuard(JPolicy(**policy)))
    ts = TrainStep(tt.jit(tm), topt.AdamW(lr=1e-3), guard=StepGuard(GuardPolicy(**policy)))
    if tmp_path is not None:
        JManager(str(tmp_path / "jax"), every_n_steps=every_n_steps, keep=3, async_save=False,
                 preemption=False).attach(js)
        CheckpointManager(str(tmp_path / "port"), every_n_steps=every_n_steps, keep=3, async_save=False,
                          preemption=False).attach(ts)
    return js, ts


def _drive_jax(js, batches, spec: str, n: int):
    import jax.numpy as jnp
    from thunder_tpu.robustness import faults as jfaults

    jfaults.configure(spec)
    losses, err = [], None
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for i in range(n):
            idx, tgt = batches[js.step_count]
            try:
                losses.append(float(js(jnp.asarray(idx), jnp.asarray(tgt), jnp.ones((), jnp.float32))))
            except Exception as e:  # thunder_tpu's NonFiniteLossError
                err = (i, type(e).__name__, str(e).split(" (")[0][:40])
                break
    jfaults.clear()
    return losses, err, sum("rolled back" in str(x.message) for x in w)


def _drive_port(ts, batches, spec: str, n: int):
    """The port's run under ``spec``, checking that every non-finite step
    left the state bit-equal: (losses, (index, error) or None, rollbacks)."""
    faults.configure(spec)
    losses, err = [], None
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for i in range(n):
            idx, tgt = batches[ts.step_count]
            before = _state(ts) if ts.opt_state is not None else None
            rollbacks = ts.guard.rollbacks
            try:
                loss = float(ts(torch.tensor(idx), torch.tensor(tgt), torch.ones(())))
            except NonFiniteLossError as e:
                err = (i, type(e).__name__, str(e).split(" (")[0][:40])
                break
            losses.append(loss)
            if not np.isfinite(loss) and before is not None and ts.guard.rollbacks == rollbacks:
                _assert_state_equal(before, _state(ts), f"skipped step {i}: ")
    faults.clear()
    return losses, err, sum("rolled back" in str(x.message) for x in w)


def _assert_losses_match(jl, tl_):
    assert len(jl) == len(tl_)
    jl, tl_ = np.array(jl), np.array(tl_)
    assert (np.isnan(jl) == np.isnan(tl_)).all(), (jl, tl_)
    ok = ~np.isnan(jl)
    np.testing.assert_allclose(tl_[ok], jl[ok], rtol=RTOL, atol=0)


# (policy, fault plan, steps): skip with its budget; raise; rollback with its budget
GUARD_CASES = {
    "skip_and_budget": (dict(on_nonfinite="skip", max_consecutive=3), "nan_loss@2,nan_loss@5*3", 9),
    "raise": (dict(on_nonfinite="raise"), "nan_loss@3", 5),
    "rollback_and_budget": (dict(on_nonfinite="rollback", max_consecutive=2),
                            "nan_loss@3*2,nan_loss@6*20", 12),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_guarded_tiny_llama_matches_thunder_tpu(case, tmp_path, monkeypatch, jfaults):
    from thunder_tpu.parallel import checkpoint as jckpt

    monkeypatch.setattr(jckpt, "_orbax", lambda: None)  # the npz layout, as the port writes
    policy, spec, n = GUARD_CASES[case]
    js, ts = _llama_steps(policy, tmp_path if "rollback" in case else None)
    batches = _llama_batches(tlg.Config.from_name("tiny-llama2").vocab_size)
    jl, jerr, jrb = _drive_jax(js, batches, spec, n)
    tl_, terr, trb = _drive_port(ts, batches, spec, n)
    _assert_losses_match(jl, tl_)
    assert terr == jerr and terr is not None, (terr, jerr)
    # rollback_and_budget: idx 3, 4 bad -> rollback; clean steps; idx 6, 7 bad ->
    # rollback; still bad -> "persisted through a rollback"
    assert trb == jrb == (2 if "rollback" in case else 0)
    assert ts.step_count == js.step_count
    assert (ts.guard.skipped, ts.guard.rollbacks) == (js._guard.skipped, js._guard.rollbacks)
    assert int(ts.opt_state["step"]) == int(js.opt_state["step"])


def test_skip_records_reason_coded_events(obs):
    guard = StepGuard(GuardPolicy(on_nonfinite="skip", max_consecutive=3))
    step, x, y = _make_step(guard=guard)
    step(x, y)
    faults.configure("nan_loss@1")
    assert np.isnan(float(step(x, y)))
    assert observability.counters().get("guard.nonfinite-skip") == 1
    assert [e["attrs"]["reason"] for e in _events("guard")] == ["nonfinite-skip"]
    assert guard.skipped == 1 and guard.consecutive_bad == 1
    step(x, y)
    assert guard.consecutive_bad == 0


def test_skipped_step_resumes_the_clean_trajectory():
    """A skipped step consumed a batch but not an update: the next step
    re-walks the unguarded trajectory bit for bit (thunder_tpu's test)."""
    step, x, y = _make_step(guard=StepGuard(GuardPolicy(on_nonfinite="skip")))
    clean, _, _ = _make_step()
    ref = [float(clean(x, y)) for _ in range(3)]
    faults.configure("nan_loss@1")
    got = [float(step(x, y)) for _ in range(3)]
    assert got[0] == ref[0] and np.isnan(got[1]) and got[2] == ref[1]
    assert int(step.opt_state["step"]) == 2 and step.step_count == 3


def test_rollback_without_manager_raises():
    step, x, y = _make_step(guard=StepGuard(GuardPolicy(on_nonfinite="rollback", max_consecutive=1)))
    step(x, y)
    faults.configure("nan_loss@1")
    with pytest.raises(NonFiniteLossError, match="no CheckpointManager"):
        step(x, y)


def test_guarded_and_unguarded_steps_share_no_trace_or_graph(monkeypatch):
    """The guard's program key is part of the trace cache key and of the
    graph key: the same module under a guarded and an unguarded TrainStep
    gets a trace (and, under capture, a graph) each."""
    import sys as _sys

    graphs_tests = importlib.util.spec_from_file_location("_graphs", ROOT / "tests" / "test_torch_graphs.py")
    mod = importlib.util.module_from_spec(graphs_tests)
    _sys.modules["_graphs"] = mod
    graphs_tests.loader.exec_module(mod)
    from thunder_tpu_torch.executors import graphex

    monkeypatch.setattr(graphex, "captures_on", lambda device: True)
    monkeypatch.setattr(graphex.CUDAGraphProgram, "_capture_fn", staticmethod(mod._fake_capture))
    net = _Net()
    x, y = torch.ones(4, 8), torch.zeros(4, 4)
    a = TrainStep(tt.jit(net), topt.SGD(lr=0.1))
    b = TrainStep(tt.jit(net), topt.SGD(lr=0.1), guard=StepGuard(GuardPolicy(on_nonfinite="skip")))
    for _ in range(3):
        a(x, y)
        b(x, y)
    ka, kb = next(iter(a._programs)), next(iter(b._programs))
    assert ka[:2] == kb[:2] and (ka[3], kb[3]) == ("noguard", "guard(gnorm=True)")
    assert ka[2][-1] == ("extra", ((True, True, True), "noguard"))  # the trace cache key's extra
    assert kb[2][-1] == ("extra", ((True, True, True), "guard(gnorm=True)"))
    assert tt.graph_captures(a) == tt.graph_captures(b) == 1 and tt.graph_replays(b) == 2
    faults.configure("nan_loss@3")
    before = _state(b)
    assert np.isnan(float(b(x * 1.0, y)))  # a replay of the guarded graph
    _assert_state_equal(before, _state(b))
    assert tt.graph_replays(b) == 3


# ---------------------------------------------------------------------------
# buffer effects
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["sgd", "sgd_momentum"])
def test_skip_gates_buffer_effects_as_thunder_tpu(momentum, jfaults):
    """A skipped step writes neither the running stats (computed from the
    NaN forward) nor the SGD parameters and momentum; both packages agree
    at every step."""
    import jax.numpy as jnp
    import thunder_tpu as tj
    from thunder_tpu import nn as jnn
    from thunder_tpu import optim as jopt
    from thunder_tpu.models.resnet import BatchNorm2d as JBN
    from thunder_tpu.ops import ltorch as jlt
    from thunder_tpu.robustness import GuardPolicy as JPolicy
    from thunder_tpu.robustness import StepGuard as JGuard
    from thunder_tpu.training import TrainStep as JaxTrainStep
    from thunder_tpu_torch.models.resnet import BatchNorm2d as TBN

    class JNet(jnn.Module):
        def __init__(self):
            super().__init__()
            self.bn = JBN(3)

        def forward(self, x, y):
            return jlt.mse_loss(self.bn(x), y)

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bn = TBN(3, device="cpu")

        def forward(self, x, y):
            return tlt.mse_loss(self.bn(x), y)

    policy = dict(on_nonfinite="skip", max_consecutive=3)
    jnet, tnet = JNet(), TNet()
    js = JaxTrainStep(tj.jit(jnet), jopt.SGD(lr=0.01, momentum=momentum), guard=JGuard(JPolicy(**policy)))
    ts = TrainStep(tt.jit(tnet), topt.SGD(lr=0.01, momentum=momentum), guard=StepGuard(GuardPolicy(**policy)))
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, 4, 4).astype(np.float32)
    y = (0.1 * rng.randn(4, 3, 4, 4)).astype(np.float32)
    faults.configure("nan_loss@1")
    jfaults.configure("nan_loss@1")
    for i in range(3):
        before = _state(ts) if i else None
        jl = float(js(jnp.asarray(x), jnp.asarray(y)))
        tl_ = float(ts(torch.tensor(x), torch.tensor(y)))
        if i == 1:
            assert np.isnan(jl) and np.isnan(tl_)
            assert "b.bn.running_mean" in before  # the check is not vacuous
            _assert_state_equal(before, _state(ts), "skipped step: ")
        else:
            np.testing.assert_allclose(tl_, jl, rtol=RTOL)
        for k, v in jnet.named_buffers():
            np.testing.assert_allclose(dict(tnet.named_buffers())[k].numpy(), np.asarray(v), rtol=RTOL, atol=1e-7)
        for k, p in jnet.named_parameters():
            np.testing.assert_allclose(dict(tnet.named_parameters())[k].detach().numpy(), np.asarray(p.data),
                                       rtol=RTOL, atol=1e-7)
    assert not torch.equal(before["b.bn.running_mean"], tnet.bn.running_mean)  # the clean step wrote them


# ---------------------------------------------------------------------------
# transient retry
# ---------------------------------------------------------------------------


def test_retry_recovers(obs):
    guard = StepGuard(GuardPolicy(retry_transient=2, retry_backoff_s=0.0))
    step, x, y = _make_step(guard=guard)
    clean, _, _ = _make_step()
    ref = [float(clean(x, y)) for _ in range(3)]
    step(x, y)
    faults.configure("transient@1*2")
    assert [float(step(x, y)), float(step(x, y))] == ref[1:]  # retries did not perturb the trajectory
    assert guard.retries == 2
    assert sum(e["attrs"].get("reason") == "transient-retry" for e in _events("guard")) == 2


def test_retry_budget_exhausted_raises(obs):
    step, x, y = _make_step(guard=StepGuard(GuardPolicy(retry_transient=1, retry_backoff_s=0.0)))
    step(x, y)
    faults.configure("transient@1*5")
    with pytest.raises(InjectedTransientError):
        step(x, y)
    assert any(e["attrs"].get("reason") == "transient-exhausted" for e in _events("guard"))
    assert step.step_count == 1


def test_no_guard_means_no_retry():
    step, x, y = _make_step()
    step(x, y)
    faults.configure("transient@1")
    with pytest.raises(InjectedTransientError):
        step(x, y)


def test_only_the_injected_error_is_transient():
    from thunder_tpu_torch.robustness.guards import transient_errors

    assert transient_errors() == (InjectedTransientError,)
    guard = StepGuard(GuardPolicy(retry_transient=3, retry_backoff_s=0.0))
    calls = []

    def attempt():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        guard.run_with_retry(attempt, step=0)
    assert len(calls) == 1  # a CUDA error is not retried in-process


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------


def test_periodic_save_and_keep_k(tmp_path):
    step, x, y = _make_step()
    mgr = CheckpointManager(str(tmp_path), every_n_steps=2, keep=2, async_save=False,
                            preemption=False).attach(step)
    for _ in range(7):
        step(x, y)
    assert [s for s, _ in list_steps(str(tmp_path))] == [4, 6]  # keep-last-2 pruned step 2
    assert mgr.saves == 3


@pytest.mark.parametrize("async_save", [False, True], ids=["blocking", "async"])
def test_restore_round_trips_bit_identical(tmp_path, async_save):
    step, x, y = _make_step()
    mgr = CheckpointManager(str(tmp_path), async_save=async_save, preemption=False).attach(step)
    for _ in range(3):
        step(x, y)
    want, want_loss = _state(step), float(step.tmodule(x, y))
    mgr.save(step)
    for _ in range(2):
        step(x, y)  # drift (while an async write may be in flight)
    meta = mgr.restore(step)
    assert meta["step"] == 3 and step.step_count == 3
    _assert_state_equal(want, _state(step))
    assert float(step.tmodule(x, y)) == want_loss
    assert mgr.last_save["bytes"] > 0 and mgr.last_restore["seconds"] > 0


def test_restore_into_a_step_that_has_not_run(tmp_path):
    """A fresh TrainStep (another process's) gets its optimizer state made,
    then written; its first step continues the saved run bit for bit."""
    step, x, y = _make_step()
    mgr = CheckpointManager(str(tmp_path), async_save=False, preemption=False).attach(step)
    for _ in range(2):
        step(x, y)
    mgr.save(step)
    fresh = TrainStep(tt.jit(_Net(seed=9)), topt.AdamW(lr=1e-2))
    assert fresh.opt_state is None
    CheckpointManager(str(tmp_path), preemption=False).restore(fresh)
    _assert_state_equal(_state(step), _state(fresh))
    assert float(fresh(x, y)) == float(step(x, y))


def test_idle_steps_are_zero_work(tmp_path, monkeypatch):
    step, x, y = _make_step()
    mgr = CheckpointManager(str(tmp_path), every_n_steps=5, async_save=False, preemption=False).attach(step)
    calls = {"collect": 0, "snapshot": 0}
    orig_collect, orig_snap = mgr._collect, CheckpointManager._snapshot
    monkeypatch.setattr(mgr, "_collect", lambda ts: (calls.__setitem__("collect", calls["collect"] + 1),
                                                     orig_collect(ts))[1])
    monkeypatch.setattr(CheckpointManager, "_snapshot",
                        staticmethod(lambda s: (calls.__setitem__("snapshot", calls["snapshot"] + 1),
                                                orig_snap(s))[1]))
    for _ in range(4):
        step(x, y)
    assert calls == {"collect": 0, "snapshot": 0}
    step(x, y)
    assert calls == {"collect": 1, "snapshot": 1}


def test_corrupt_latest_falls_back_to_older(tmp_path):
    step, x, y = _make_step()
    mgr = CheckpointManager(str(tmp_path), async_save=False, preemption=False).attach(step)
    step(x, y)
    mgr.save(step)
    good = _state(step)
    step(x, y)
    mgr.save(step)
    newest = list_steps(str(tmp_path))[-1][1]
    with open(os.path.join(newest, "state", "state.npz"), "ab") as f:
        f.write(b"corrupt")
    ok, problems = validate_step(newest)
    assert not ok and problems
    step(x, y)
    with pytest.warns(UserWarning, match="skipping invalid checkpoint"):
        meta = mgr.restore(step)
    assert meta["step"] == 1
    _assert_state_equal(good, _state(step))


def test_save_failure_nonfatal_by_default(tmp_path, obs):
    step, x, y = _make_step()
    mgr = CheckpointManager(str(tmp_path), every_n_steps=2, async_save=False, preemption=False).attach(step)
    faults.configure("ckpt_fail@2")
    with pytest.warns(UserWarning, match="non-fatal"):
        for _ in range(4):
            step(x, y)
    assert step.step_count == 4 and mgr.failed_saves == 1 and mgr.saves == 1
    assert _events("checkpoint.save_failed")
    assert observability.counters().get("checkpoint.save_failed") == 1
    assert [s for s, _ in list_steps(str(tmp_path))] == [4]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")]  # the failed write left nothing


def test_save_failure_strict_raises(tmp_path):
    step, x, y = _make_step()
    CheckpointManager(str(tmp_path), every_n_steps=2, async_save=False, strict=True,
                      preemption=False).attach(step)
    faults.configure("ckpt_fail@2")
    step(x, y)
    with pytest.raises(CheckpointError) as e:
        step(x, y)
    assert isinstance(e.value.__cause__, InjectedCheckpointError)


def test_async_save_failure_surfaces_in_strict_wait(tmp_path):
    step, x, y = _make_step()
    mgr = CheckpointManager(str(tmp_path), async_save=True, strict=True, preemption=False).attach(step)
    step(x, y)
    faults.configure("ckpt_fail@1")
    mgr.save(step)
    with pytest.raises(CheckpointError):
        mgr.wait()


def test_distributed_mode_names_a3b(tmp_path):
    """Sharded checkpoints wait for ROADMAP A3c (A3b's second part)."""
    with pytest.raises(NotImplementedError, match="A3c"):
        CheckpointManager(str(tmp_path), distributed=True)


# ---------------------------------------------------------------------------
# kill and resume: two processes
# ---------------------------------------------------------------------------

KILL_SCRIPT = '''
import json, sys
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch import nn as tnn, optim
from thunder_tpu_torch.data import TokenLoader
from thunder_tpu_torch.ops import ltorch
from thunder_tpu_torch.robustness import CheckpointManager
from thunder_tpu_torch.training import TrainStep


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(1)
        self.fc1 = tnn.Linear(8, 16, device="cpu", generator=g)
        self.fc2 = tnn.Linear(16, 4, device="cpu", generator=g)

    def forward(self, x, y):
        return ltorch.mse_loss(self.fc2(ltorch.gelu(self.fc1(x))), y)


def run(token_path, ckdir, n_steps, resume):
    loader = TokenLoader(token_path, batch_size=4, seq_len=32, seed=3)
    step = TrainStep(tt.jit(Net()), optim.AdamW(lr=1e-2))
    mgr = CheckpointManager(ckdir, every_n_steps=4, async_save=False, loader=loader,
                            preemption=False) if ckdir else None
    if mgr is not None:
        mgr.attach(step)
        if resume:
            mgr.restore(step)
    losses = {}
    while step.step_count < n_steps:
        xi, _ = loader.next_batch()
        x = torch.tensor(xi[:, :8], dtype=torch.float32) / 1000.0
        i = step.step_count
        losses[i] = float(step(x, torch.zeros(4, 4)))
        print(json.dumps({i: losses[i]}), flush=True)
    return losses


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4] == "resume")
'''


def _token_file(tmp_path, name="tok.bin", n=5000, vocab=1000):
    from thunder_tpu_torch.data import write_token_file

    path = str(tmp_path / name)
    write_token_file(path, np.random.RandomState(99).randint(0, vocab, n), token_bytes=2)
    return path


def test_kill_and_resume_two_processes_is_bit_identical(tmp_path):
    """die@7 kills the first process by os._exit inside step 7 (after the
    step-4 save, before the step-8 one); a second process restores step 4,
    loader cursor included, and runs to 12: losses of steps 4-11 bit-equal
    to an uninterrupted run."""
    script = tmp_path / "kill_resume.py"
    script.write_text(KILL_SCRIPT)
    tokens, ckdir = _token_file(tmp_path), str(tmp_path / "ckpts")
    ns = {"__name__": "kill_resume"}
    exec(compile(KILL_SCRIPT, str(script), "exec"), ns)
    ref = ns["run"](tokens, "", 12, False)
    env = dict(os.environ, PYTHONPATH=str(ROOT), TT_FAULT="die@7")
    env.pop("TT_OBS", None)
    first = subprocess.run([sys.executable, str(script), tokens, ckdir, "12", "fresh"], env=env,
                           capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert first.returncode == faults.DIE_EXIT_CODE, first.stderr[-2000:]
    died = {int(k): v for ln in first.stdout.splitlines() for k, v in json.loads(ln).items()}
    assert sorted(died) == list(range(7))
    assert [s for s, _ in list_steps(ckdir)] == [4]
    env.pop("TT_FAULT")
    second = subprocess.run([sys.executable, str(script), tokens, ckdir, "12", "resume"], env=env,
                            capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert second.returncode == 0, second.stderr[-2000:]
    resumed = {int(k): v for ln in second.stdout.splitlines() for k, v in json.loads(ln).items()}
    assert sorted(resumed) == list(range(4, 12))
    assert all(died[i] == ref[i] for i in died)
    assert all(resumed[i] == ref[i] for i in resumed), (resumed, ref)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------


def _loader_batch(batch):
    xi, _ = batch
    return xi[:, :8].float() / 1000.0, torch.zeros(xi.shape[0], 4)


def test_preempt_drains_and_resumes_bit_identical_through_a_prefetcher(tmp_path):
    """SIGTERM after step 5 (the preempt fault): the final save is durable,
    Preempted carries it, and a fresh step and loader restored from it
    continue bit for bit. The loader runs behind a prefetcher that pulls
    batches ahead; the checkpoint's cursor is the prefetcher's, which counts
    the batches the step took."""
    from thunder_tpu_torch.data import TokenLoader

    tokens, ckdir = _token_file(tmp_path), str(tmp_path / "ckpts")

    def fresh():
        loader = TokenLoader(tokens, batch_size=4, seq_len=32, seed=3, native=False)
        return loader, loader.prefetched(size=3, device="cpu"), _make_step()[0]

    loader, batches, step = fresh()
    ref = [float(step(*_loader_batch(next(batches)))) for _ in range(10)]
    batches.close()
    loader.close()

    loader, batches, step = fresh()
    prev = signal.getsignal(signal.SIGTERM)
    mgr = CheckpointManager(ckdir, every_n_steps=2, loader=batches).attach(step)
    assert signal.getsignal(signal.SIGTERM) != prev
    faults.configure("preempt@5")
    got = []
    try:
        with pytest.raises(Preempted) as e:
            for _ in range(10):
                got.append(float(step(*_loader_batch(next(batches)))))
    finally:
        mgr.close()
        batches.close()
        loader.close()
    assert signal.getsignal(signal.SIGTERM) == prev  # close() gave SIGTERM back
    assert e.value.step == 6 and os.path.isdir(e.value.checkpoint_path)
    assert got == ref[:5]

    loader, batches, step = fresh()
    batches.close()
    meta = CheckpointManager(ckdir, loader=loader, preemption=False).restore(step)
    assert meta["step"] == 6 and meta["loader"]["served"] == 6
    batches = loader.prefetched(size=3, device="cpu")
    post = [float(step(*_loader_batch(next(batches)))) for _ in range(4)]
    batches.close()
    loader.close()
    assert post == ref[6:]


def test_second_sigterm_escalates_without_rechaining(tmp_path, obs):
    chained = {"n": 0}

    def prev_handler(signum, frame):
        chained["n"] += 1

    old = signal.signal(signal.SIGTERM, prev_handler)
    step, x, y = _make_step()
    mgr = CheckpointManager(str(tmp_path), async_save=False).attach(step)
    try:
        signal.raise_signal(signal.SIGTERM)
        signal.raise_signal(signal.SIGTERM)
        assert mgr._preempt.escalated.is_set() and chained["n"] == 1
        with pytest.raises(Preempted, match="escalated"):
            step(x, y)
        assert mgr.saves == 1
        assert any(e["attrs"].get("reason") == "preempt-escalated" for e in _events("guard"))
        assert observability.counters().get("guard.preempt-escalated") == 1
    finally:
        mgr.close()
        signal.signal(signal.SIGTERM, old)


def test_opt_in_sigint_drains_like_sigterm(tmp_path):
    step, x, y = _make_step()
    old_int = signal.getsignal(signal.SIGINT)
    mgr = CheckpointManager(str(tmp_path), async_save=False,
                            signals=(signal.SIGTERM, signal.SIGINT)).attach(step)
    try:
        signal.raise_signal(signal.SIGINT)
        with pytest.raises(Preempted):
            step(x, y)
        assert mgr.saves == 1
    finally:
        mgr.close()
    assert signal.getsignal(signal.SIGINT) == old_int


def test_failing_step_while_preempted_finalizes_the_drain(tmp_path):
    """A step that dies while the manager is draining finalizes the
    preemption from the last completed step instead of surfacing the
    error."""
    step, x, y = _make_step()
    mgr = CheckpointManager(str(tmp_path), async_save=False).attach(step)
    try:
        step(x, y)
        mgr._preempt.preempted.set()
        faults.configure("transient@1")
        with pytest.raises(Preempted) as e:
            step(x, y)
        assert e.value.step == 1 and mgr.saves == 1
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# format parity with thunder_tpu
# ---------------------------------------------------------------------------


def _ckpt_inspect():
    spec = importlib.util.spec_from_file_location("ckpt_inspect", ROOT / "tools" / "ckpt_inspect.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ckpt_inspect_accepts_the_ports_directory_and_rejects_a_flipped_byte(tmp_path, capsys):
    tm = tlg.GPTForCausalLM(tlg.Config.from_name("tiny-llama2"), device="cpu")
    step = TrainStep(tt.jit(tm), topt.AdamW(lr=1e-3))
    rng = np.random.RandomState(0)
    idx = torch.tensor(rng.randint(0, 320, (2, 16)).astype(np.int32))
    step(idx, idx)
    mgr = CheckpointManager(str(tmp_path), async_save=False, preemption=False).attach(step)
    mgr.save(step)
    mod = _ckpt_inspect()
    assert mod.inspect_dir(str(tmp_path)) == 0
    assert "latest restorable step: 1" in capsys.readouterr().out
    payload = Path(list_steps(str(tmp_path))[0][1]) / "state" / "state.npz"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    assert mod.inspect_dir(str(tmp_path)) == 1
    assert "INVALID" in capsys.readouterr().out


def _mixed_tree():
    """A state tree with every dtype the npz carries specially (bf16, fp8)
    and the structures jax flattens (nested dicts out of key order, lists,
    tuples, None, a 0-d leaf)."""
    g = torch.Generator().manual_seed(0)
    return {"params": {"z.w": torch.randn(3, 5, generator=g), "a.b": torch.randn(4, generator=g).bfloat16()},
            "opt_state": {"step": torch.tensor(7, dtype=torch.int32), "m": None,
                          "hist": [torch.randn(2, generator=g).to(torch.float8_e4m3fn),
                                   (torch.arange(3, dtype=torch.int64), torch.randn(2, generator=g).half())]},
            "buffers": {}}


def test_flatten_order_and_structure_note_are_jaxs():
    import jax

    from thunder_tpu_torch.parallel import checkpoint as ckpt

    tree = _mixed_tree()
    as_np = ckpt.unflatten(tree, [i for i, _ in enumerate(ckpt.flatten(tree))])
    leaves, treedef = jax.tree_util.tree_flatten(as_np)
    assert leaves == list(range(len(ckpt.flatten(tree))))  # jax visits the leaves in the port's order
    assert ckpt.treedef_note(tree) == str(treedef)


@pytest.mark.parametrize("rank0_only", [False, True])
def test_save_load_round_trip_and_thunder_tpu_reads_it(tmp_path, rank0_only, monkeypatch):
    """save/load keep every leaf's bits and dtype (bf16 and fp8 as void bytes
    with their names); thunder_tpu's numpy-fallback load reads the port's
    file, and the port reads thunder_tpu's."""
    import jax
    from thunder_tpu.parallel import checkpoint as jckpt
    from thunder_tpu_torch.parallel import checkpoint as ckpt

    monkeypatch.setattr(jckpt, "_orbax", lambda: None)
    tree = _mixed_tree()
    ckpt.save(tree, str(tmp_path / "port"), options=ckpt.StateDictOptions(rank0_only=rank0_only))
    back = ckpt.load(str(tmp_path / "port"), like=tree)
    for a, b in zip(ckpt.flatten(tree), ckpt.flatten(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dtype.itemsize == 1 else a, b.view(torch.uint8)
                           if b.dtype.itemsize == 1 else b)
    like = jax.tree_util.tree_map(lambda t: np.zeros(tuple(t.shape)), tree)
    theirs = jckpt.load(str(tmp_path / "port"), like=like)
    for a, b in zip(ckpt.flatten(tree), jax.tree_util.tree_leaves(theirs)):
        assert np.asarray(b).dtype.name == str(a.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(b).astype(np.float64), a.double().numpy())
    jckpt.save(theirs, str(tmp_path / "jax"))
    again = ckpt.load(str(tmp_path / "jax"), like=tree)
    for a, b in zip(ckpt.flatten(tree), ckpt.flatten(again)):
        assert a.dtype == b.dtype and torch.equal(a.double(), b.double())


def test_model_state_dict_round_trip(tmp_path):
    from thunder_tpu_torch.parallel import checkpoint as ckpt

    step, x, y = _make_step()
    step(x, y)
    full = ckpt.get_model_state_dict(step.tmodule, ckpt.StateDictOptions(full_state_dict=True))
    assert all(v.device.type == "cpu" for v in full.values())
    ckpt.save_checkpoint(step, str(tmp_path), tmodule=step.tmodule, opt_state=step.opt_state)
    fresh = tt.jit(_Net(seed=5))
    like = {"params": ckpt.get_model_state_dict(fresh), "opt_state": step.opt_state}
    ckpt.load_model_state_dict(ckpt.load(str(tmp_path), like=like)["params"], fresh)
    for k, v in full.items():
        assert torch.equal(fresh.get_parameters()[k].detach(), v)
    with pytest.raises(ValueError, match="fc1.weight"):
        ckpt.load_model_state_dict({"fc1.weight": torch.zeros(3)}, fresh)


def _jax_llama_step():
    import thunder_tpu as tj
    from thunder_tpu import optim as jopt
    from thunder_tpu.models import litgpt as jlg
    from thunder_tpu.training import TrainStep as JaxTrainStep

    jm = jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2"))
    return jm, JaxTrainStep(tj.jit(jm), jopt.AdamW(lr=1e-3))


def test_thunder_tpu_restores_the_ports_checkpoint(tmp_path, monkeypatch):
    """The other way: thunder_tpu's CheckpointManager reads a step the port
    wrote (bf16 parameters among them, as void bytes with their names)."""
    import jax.numpy as jnp
    from thunder_tpu.parallel import checkpoint as jckpt
    from thunder_tpu.robustness import CheckpointManager as JManager

    monkeypatch.setattr(jckpt, "_orbax", lambda: None)
    jm, js = _jax_llama_step()
    tm = tlg.GPTForCausalLM(tlg.Config.from_name("tiny-llama2"), device="cpu")
    with torch.no_grad():
        tm.gpt.h[0].norm_1.weight.data = tm.gpt.h[0].norm_1.weight.data.to(torch.bfloat16)
    jm.gpt.h[0].norm_1.weight.data = jnp.asarray(jm.gpt.h[0].norm_1.weight.data, jnp.bfloat16)
    ts = TrainStep(tt.jit(tm), topt.AdamW(lr=1e-3))
    rng = np.random.RandomState(0)
    for _ in range(2):
        idx = rng.randint(0, 320, (2, 16)).astype(np.int32)
        ts(torch.tensor(idx), torch.tensor(idx))
    CheckpointManager(str(tmp_path), async_save=False, preemption=False).attach(ts).save(ts)
    idx = jnp.asarray(rng.randint(0, 320, (2, 16)).astype(np.int32))
    js(idx, idx)  # builds its optimizer state
    meta = JManager(str(tmp_path), preemption=False).restore(js)
    assert meta["step"] == 2 and js.step_count == 2
    for k, p in tm.named_parameters():
        got = np.asarray(dict(jm.named_parameters())[k].data)
        assert got.dtype.name == str(p.dtype).replace("torch.", ""), k
        np.testing.assert_array_equal(got.astype(np.float32), p.detach().float().numpy(), err_msg=k)
    for name in ("m", "v"):
        for k, t in ts.opt_state[name].items():
            np.testing.assert_array_equal(np.asarray(js.opt_state[name][k]), t.numpy(), err_msg=k)
    assert int(js.opt_state["step"]) == 2


def test_thunder_tpu_checkpoint_continues_in_the_port(tmp_path, monkeypatch):
    """A thunder_tpu tiny-llama2 run checkpointed after 3 f32 steps (its
    loader cursor too) restores into a fresh port TrainStep; 3 more steps
    match thunder_tpu's own continuation to 1e-5."""
    import jax.numpy as jnp
    from thunder_tpu.data import TokenLoader as JLoader
    from thunder_tpu.parallel import checkpoint as jckpt
    from thunder_tpu.robustness import CheckpointManager as JManager
    from thunder_tpu_torch.data import TokenLoader

    monkeypatch.setattr(jckpt, "_orbax", lambda: None)
    tokens = _token_file(tmp_path, n=20000, vocab=320)
    jloader = JLoader(tokens, batch_size=2, seq_len=16, seed=4, native=False)
    jm, js = _jax_llama_step()
    mgr = JManager(str(tmp_path / "ck"), async_save=False, preemption=False, loader=jloader).attach(js)
    for _ in range(3):
        x, y = jloader.next_batch()
        js(jnp.asarray(x), jnp.asarray(y))
    path = mgr.save(js, block=True)
    want = []
    for _ in range(3):
        x, y = jloader.next_batch()
        want.append(float(js(jnp.asarray(x), jnp.asarray(y))))
    jloader.close()

    tm = tlg.GPTForCausalLM(tlg.Config.from_name("tiny-llama2"), device="cpu", seed=11)
    ts = TrainStep(tt.jit(tm), topt.AdamW(lr=1e-3))
    loader = TokenLoader(tokens, batch_size=2, seq_len=16, seed=0, native=False)
    meta = tlg.load_jax_checkpoint(ts, path, loader=loader)
    assert meta["step"] == 3 and ts.step_count == 3 and int(ts.opt_state["step"]) == 3
    got = []
    for _ in range(3):
        x, y = loader.next_batch()
        got.append(float(ts(torch.tensor(x), torch.tensor(y))))
    loader.close()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_load_jax_checkpoint_refuses_another_models_tree(tmp_path, monkeypatch):
    from thunder_tpu.parallel import checkpoint as jckpt
    from thunder_tpu.robustness import CheckpointManager as JManager
    import jax.numpy as jnp

    monkeypatch.setattr(jckpt, "_orbax", lambda: None)
    jm, js = _jax_llama_step()
    idx = jnp.zeros((2, 16), jnp.int32)
    js(idx, idx)
    path = JManager(str(tmp_path), async_save=False, preemption=False).attach(js).save(js, block=True)
    other = TrainStep(tt.jit(_TScaled(tlg.GPTForCausalLM(tlg.Config.from_name("tiny-llama2"), device="cpu"))),
                      topt.AdamW(lr=1e-3))
    with pytest.raises(KeyError, match="not this step's"):
        tlg.load_jax_checkpoint(other, path)


# ---------------------------------------------------------------------------
# a planted fault: the gate dropped
# ---------------------------------------------------------------------------


def test_planted_dropped_gate_fails_the_skip_check(monkeypatch):
    """With the skip flag ignored (the step advances and AdamW updates on a
    NaN step), the bit-equality check of a skipped step fails."""
    from thunder_tpu_torch import optim as optim_mod

    plain = cudaex.adamw_plain
    monkeypatch.setattr(optim_mod, "_advance", lambda state, finite: state["step"].add_(1))
    monkeypatch.setattr(cudaex, "adamw_plain", lambda *a, finite=None, **kw: plain(*a, **kw))
    step, x, y = _make_step(guard=StepGuard(GuardPolicy(on_nonfinite="skip", check_grad_norm=False)))
    step(x, y)
    faults.configure("nan_loss@1")
    before = _state(step)
    assert np.isnan(float(step(x, y)))
    with pytest.raises(AssertionError, match="changed"):
        _assert_state_equal(before, _state(step))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_adamw_skip_flag_writes_nothing_and_replays(cuda):
    """Flag 0: p, m, v bit-equal, launched and inside a CUDA graph; flag 1:
    bit-equal to the unflagged launch."""
    g = torch.Generator(device=cuda).manual_seed(0)
    shapes = [(1000, 257), (65536 * 3 + 5,), (131,)]
    hyper = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)

    def make():
        g.manual_seed(0)
        return ([torch.randn(s, device=cuda, generator=g) * 0.02 for s in shapes],
                [torch.randn(s, device=cuda, generator=g) * 1e-3 for s in shapes],
                [torch.randn(s, device=cuda, generator=g) * 1e-4 for s in shapes],
                [torch.rand(s, device=cuda, generator=g) * 1e-6 for s in shapes])

    flag = torch.zeros((), dtype=torch.int32, device=cuda)
    step = torch.ones((), dtype=torch.int32, device=cuda)
    ps, gs, ms, vs = a = make()
    before = [t.clone() for ts in (ps, ms, vs) for t in ts]
    n0 = cudaex.adamw_update.launches
    cudaex.adamw_update(ps, gs, ms, vs, step=step, finite=flag, **hyper)
    torch.cuda.synchronize()
    assert cudaex.adamw_update.launches == n0 + 1
    assert all(torch.equal(x, y) for x, y in zip(before, [t for ts in (ps, ms, vs) for t in ts]))
    flag.fill_(1)
    cudaex.adamw_update(ps, gs, ms, vs, step=step, finite=flag, **hyper)
    b = make()
    cudaex.adamw_update(b[0], b[1], b[2], b[3], step=step, **hyper)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for xs, ys in zip((a[0], a[2], a[3]), (b[0], b[2], b[3])) for x, y in zip(xs, ys))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cudaex.adamw_update(ps, gs, ms, vs, step=step, finite=flag, **hyper)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cudaex.adamw_update(ps, gs, ms, vs, step=step, finite=flag, **hyper)
    flag.fill_(0)
    before = [t.clone() for ts in (ps, ms, vs) for t in ts]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(before, [t for ts in (ps, ms, vs) for t in ts]))
    flag.fill_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(before[0], ps[0])


@pytest.mark.gpu
def test_card_captured_guarded_step_skips_and_rolls_back_in_place(cuda, tmp_path):
    """tiny-llama2 (f32) on the card, captured: a skipped step (a replay)
    leaves every tensor of the graph bit-equal; a rollback restores in place,
    so the next replay's loss is the loss the restored state gives."""
    tm = tlg.GPTForCausalLM(tlg.Config.from_name("tiny-llama2"), device=cuda)
    guard = StepGuard(GuardPolicy(on_nonfinite="rollback", max_consecutive=1))
    ts = TrainStep(tt.jit(_TScaled(tm)), topt.AdamW(lr=1e-3), guard=guard)
    mgr = CheckpointManager(str(tmp_path), every_n_steps=2, keep=3, async_save=True,
                            preemption=False).attach(ts)
    rng = np.random.RandomState(0)
    batches = [(torch.tensor(rng.randint(0, 320, (2, 64)).astype(np.int32), device=cuda),) * 2
               for _ in range(6)]
    one = torch.ones((), device=cuda)
    for i in range(4):  # op by op, capture, replays; saves at 2 and 4
        ts(*batches[i], one)
    mgr.wait()
    assert tt.graph_captures(ts) == 1 and tt.graph_replays(ts) == 3  # the capturing call replays too
    saved = _state(ts)
    want = float(ts(*batches[4], one))  # the step after the step-4 save
    _write_state(ts, saved)
    ts._step_count = 4
    _assert_state_equal(saved, _state(ts))
    faults.configure("nan_loss@4")
    with pytest.warns(UserWarning, match="rolled back"):
        assert np.isnan(float(ts(*batches[4], one)))
    faults.clear()
    mgr.wait()
    assert ts.step_count == 4 and guard.rollbacks == 1
    _assert_state_equal(saved, _state(ts), "rollback: ")
    assert float(ts(*batches[4], one)) == want
    assert tt.graph_captures(ts) == 1
    guard.policy.on_nonfinite = "skip"
    guard.policy.max_consecutive = 3
    before = _state(ts)
    faults.configure("nan_loss@5")
    assert np.isnan(float(ts(*batches[5], one)))
    _assert_state_equal(before, _state(ts), "skipped replay: ")
    assert tt.graph_captures(ts) == 1 and tt.graph_replays(ts) >= 5
    mgr.close()
