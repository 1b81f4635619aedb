"""The port's TrainStep, autocast and optimizers against thunder_tpu's, on the CPU.

tiny-llama2 (3 layers, GQA 4 q heads over 2 kv heads), B=2, T=64, with
thunder_tpu's initial weights carried across by ``load_jax_params`` and one
fixed batch from numpy:

* f32, AdamW(lr=1e-3), 10 steps: the per-step losses agree to 1e-4
  relative and the final parameters to 1e-4 absolute. Both sides compute in
  f32; what differs is summation order (XLA's fused reductions against
  torch's), which moves a gradient by ~1e-7, and AdamW's normalized update
  carries that into the parameters at a few 1e-5 after 10 steps of lr 1e-3
  (measured 7.0e-5 at most).
* bf16 autocast, 3 steps: losses and parameters to 2e-2. Both round the
  same ops to bf16, but at other places inside fused regions, so the bf16
  roundings differ.
* the optimizers' ``update`` on random dicts: to 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu import optim as jopt
from thunder_tpu.models import litgpt as jlg
from thunder_tpu.training import TrainStep as JaxTrainStep
from thunder_tpu.transforms.autocast import AutocastTransform as JaxAutocast
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.training import TrainStep
from thunder_tpu_torch.transforms.autocast import AutocastTransform

B, T = 2, 64


def _run(n_steps: int, autocast: bool):
    """Both packages' TrainSteps from the same weights and batch: (jax
    losses, port losses, jax params, port params, port step)."""
    jm = jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2"))
    cfg = tlg.Config.from_name("tiny-llama2")
    tm = tlg.GPTForCausalLM(cfg, device="cpu")
    tlg.load_jax_params(tm, {k: np.asarray(p.data) for k, p in jm.named_parameters()})
    rng = np.random.RandomState(0)
    idx = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    js = JaxTrainStep(tj.jit(jm, transforms=[JaxAutocast()] if autocast else None),
                      jopt.AdamW(lr=1e-3))
    ts = TrainStep(tt.jit(tm, transforms=[AutocastTransform()] if autocast else None),
                   topt.AdamW(lr=1e-3))
    jl = [float(js(jnp.asarray(idx), jnp.asarray(tgt))) for _ in range(n_steps)]
    tl_ = [float(ts(torch.tensor(idx), torch.tensor(tgt))) for _ in range(n_steps)]
    jp = {k: np.asarray(p.data, dtype=np.float32) for k, p in jm.named_parameters()}
    tp = {k: p.detach().float().numpy() for k, p in tm.named_parameters()}
    return np.array(jl), np.array(tl_), jp, tp, ts


@pytest.fixture(scope="module")
def f32_run():
    return _run(10, autocast=False)


@pytest.fixture(scope="module")
def bf16_run():
    return _run(3, autocast=True)


def test_f32_losses_match_jax(f32_run):
    jl, tl_, *_ = f32_run
    np.testing.assert_allclose(tl_, jl, rtol=1e-4, atol=0)
    assert tl_[-1] < tl_[0]


def test_f32_params_match_jax(f32_run):
    _, _, jp, tp, _ = f32_run
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-4, rtol=0, err_msg=k)


def test_step_traces_claim_the_flash_kernels(f32_run):
    """Each of the 3 layers' attention is one rope_flash_fwd in the forward
    program and one rope_flash_bwd in the backward program."""
    ts = f32_run[-1]
    fwd = [b.sym.id for b in tt.last_traces(ts)[-1].bound_symbols]
    bwd = [b.sym.id for b in tt.last_backward_traces(ts)[-1].bound_symbols]
    assert fwd.count("cuda.rope_flash_fwd") == 3
    assert bwd.count("cuda.rope_flash_bwd") == 3
    assert ts.step_count == 10


def test_bf16_autocast_matches_jax(bf16_run):
    jl, tl_, jp, tp, ts = bf16_run
    np.testing.assert_allclose(tl_, jl, rtol=2e-2, atol=0)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2e-2, rtol=0, err_msg=k)
    # master weights stay f32; the attention kernels see bf16 q/k/v
    claimed = [b for b in tt.last_traces(ts)[-1].bound_symbols if b.sym.id == "cuda.rope_flash_fwd"]
    assert claimed and all(b.args[0].dtype.name == "bfloat16" for b in claimed)
    assert all(b.args[3].dtype.name == "float32" for b in claimed)  # cos stays f32


def _random_dicts(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    shapes = {"w": (4, 6), "b": (6,), "e": (3, 2, 5)}
    params = {k: rng.randn(*s).astype(dtype) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(dtype) for k, s in shapes.items()} for _ in range(3)]
    grads[1]["b"] = None  # a parameter without a gradient is left alone
    return params, grads


@pytest.mark.parametrize("make", [
    lambda m: m.AdamW(lr=1e-2, weight_decay=0.1),
    lambda m: m.Adam(lr=1e-2),
    lambda m: m.SGD(lr=0.1, momentum=0.9, weight_decay=0.01),
    lambda m: m.SGD(lr=0.1),
], ids=["adamw", "adam", "sgd_momentum", "sgd"])
def test_optimizer_updates_match_jax(make):
    params, grads = _random_dicts(0)
    jo, to = make(jopt), make(topt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jp, {k: None if v is None else jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts = to.update(tp, {k: None if v is None else torch.tensor(v) for k, v in g.items()}, ts)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6, err_msg=k)
    assert ts["step"] == int(js["step"]) == 3


def test_adamw_keeps_f32_state_for_bf16_params():
    params, grads = _random_dicts(1)
    tp = {k: torch.tensor(v).to(torch.bfloat16) for k, v in params.items()}
    opt = topt.AdamW(lr=1e-2)
    state = opt.init(tp)
    opt.update(tp, {k: torch.tensor(v).to(torch.bfloat16) for k, v in grads[0].items()}, state)
    assert all(m.dtype == torch.float32 for m in state["m"].values())
    assert all(p.dtype == torch.bfloat16 for p in tp.values())
    np.testing.assert_allclose(float(topt.global_norm({"a": torch.ones(4), "b": None})), 2.0)


@pytest.mark.parametrize("arg", ["mesh_plan", "guard", "slo", "buckets", "bucket_pad"])
def test_unported_train_step_options_raise(arg):
    """mesh_plan, guard and slo raise NotImplementedError naming the
    argument. buckets and bucket_pad are ported (tests/test_torch_buckets.py):
    a value of the wrong type raises TypeError naming the argument."""
    model = tlg.GPTForCausalLM(tlg.Config.from_name("tiny"), device="cpu")
    err = TypeError if arg in ("buckets", "bucket_pad") else NotImplementedError
    with pytest.raises(err, match=arg):
        TrainStep(model, topt.AdamW(), **{arg: object()})
    with pytest.raises(NotImplementedError, match="micro_step"):
        TrainStep(model, topt.AdamW()).micro_step()
