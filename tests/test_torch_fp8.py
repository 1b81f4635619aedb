"""The port's low-precision training slice against thunder_tpu's, on the CPU:
delayed-scaling fp8 linears (transforms/fp8_training.py, cudaex.fp8_linear)
and LoRA (transforms/lora.py).

The same numpy inputs and weights go through both packages. Tolerances:

* scales and e4m3/e5m2 codes: bit for bit (the same f32 operations in the
  same order, round-to-nearest-even casts on both sides);
* the fp8 linear's plain version against pallasex.fp8_linear_fused in
  interpret mode: codes and amaxes exact, y within rtol 1e-5, atol 1e-4
  (the reference's own split-K bar, tests/test_mfu_levers.py): both sum
  exact e4m3 products in f32, in another order;
* amax histories after two jit calls: exact where the linear's input is the
  program's input, rtol 1e-6 behind another linear (an f32 product summed
  in another order feeds the next amax);
* fp8 TrainSteps, 3 steps (measured on this file's inputs in brackets):
  TinyNet (d=256, f32, SGD) losses within 1e-5 relative (1.1e-7),
  parameters within 1e-5 (1.9e-9), histories within 1e-5 relative (equal).
  tiny-llama2 with bf16 autocast and ``min_features=64`` (AdamW): losses
  within 1e-3 relative (1.8e-4), parameters within 2e-2 (5.9e-3; the bf16
  autocast bar of tests/test_torch_training.py: both round the same ops to
  bf16 at other places), histories within 1e-1 relative (4.2e-2: an
  activation's amax is one element, which inherits those bf16 differences);
* LoRA on tiny-llama2, f32, AdamW, 3 steps: losses within 1e-4 relative
  (7.9e-8), adapters within 1e-4 (1.8e-5; tests/test_torch_training.py's
  f32 bars), the frozen base bit for bit unchanged, merged logits within
  1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu import nn as jnn
from thunder_tpu import optim as jopt
from thunder_tpu.executors.pallasex import fp8_linear_fused
from thunder_tpu.models import litgpt as jlg
from thunder_tpu.ops import ltorch as jlt
from thunder_tpu.training import TrainStep as JaxTrainStep
from thunder_tpu.transforms import fp8_training as jfp8
from thunder_tpu.transforms.autocast import AutocastTransform as JaxAutocast
from thunder_tpu.transforms.lora import LORATransform as JaxLORA
from thunder_tpu.transforms.lora import merge_lora_weights as jax_merge
from thunder_tpu_torch import nn as tnn
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.ops import ltorch as tlt
from thunder_tpu_torch.training import TrainStep
from thunder_tpu_torch.transforms import fp8_training as tfp8
from thunder_tpu_torch.transforms.autocast import AutocastTransform
from thunder_tpu_torch.transforms.lora import LORATransform, merge_lora_weights

D = 256


def _codes(a) -> np.ndarray:
    """The bytes of a float8 array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hist", [[2.0, 4.0, 0.0, 0.0], [0.0] * 4, [3.3e-5, 0.7, 1.7e3, 9.1],
                                  [1e-14, 0.0, 0.0, 0.0]], ids=["amax4", "empty", "spread", "tiny"])
@pytest.mark.parametrize("margin", [0, 1, 3])
def test_scale_from_hist_bit_equal(hist, margin):
    h = np.asarray(hist, np.float32)
    for fmt in (tfp8.E4M3_MAX, tfp8.E5M2_MAX):
        want = np.asarray(jfp8._scale_from_hist(jnp.asarray(h), fmt, margin))
        got = tfp8._scale_from_hist(torch.tensor(h), fmt, margin).numpy()
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), (got, want)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_quantize_codes_bit_equal(fmt):
    rng = np.random.RandomState(0)
    # magnitudes across the formats' range, subnormals and saturation
    x = (rng.randn(64, 96) * np.exp2(rng.randint(-20, 12, (64, 96)))).astype(np.float32)
    fmax, jdt, tdt = ((tfp8.E4M3_MAX, jnp.float8_e4m3fn, torch.float8_e4m3fn) if fmt == "e4m3"
                      else (tfp8.E5M2_MAX, jnp.float8_e5m2, torch.float8_e5m2))
    for scale in (1.0, 3.7, 448.0 / 1234.5):
        sc = np.float32(scale)
        want = jfp8._q(jnp.asarray(x), jnp.asarray(sc), fmax, jdt)
        got = tfp8._q(torch.tensor(x), torch.tensor(sc), fmax, tdt)
        np.testing.assert_array_equal(_codes(got), _codes(want))


# ---------------------------------------------------------------------------
# the fp8 linear: plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K", [(64, 128, 1024), (16, 256, 512)])
def test_fp8_linear_plain_matches_pallas(monkeypatch, x_dtype, M, N, K):
    monkeypatch.setenv("TT_FP8_FUSED", "force")
    rng = np.random.RandomState(M + K)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(N, K) * 0.05).astype(np.float32)
    sx = np.float32(tfp8.E4M3_MAX / np.abs(x).max() / 2)
    sw = np.float32(tfp8.E4M3_MAX / np.abs(w).max())
    jx = jnp.asarray(x).astype(jnp.dtype(x_dtype))
    y, xq, wq, ax, aw = fp8_linear_fused(jx, jnp.asarray(w), sx, sw, fmt_max=tfp8.E4M3_MAX,
                                         save_quantized=True)
    tx = torch.tensor(x).to(getattr(torch, x_dtype))
    assert cudaex.fp8_linear_supported(tx, torch.tensor(w))
    ty, txq, twq, tax, taw = cudaex.fp8_linear(tx, torch.tensor(w), torch.tensor(sx), torch.tensor(sw),
                                               save_quantized=True)
    np.testing.assert_array_equal(_codes(txq), _codes(xq))
    np.testing.assert_array_equal(_codes(twq), _codes(wq))
    assert float(tax) == float(ax) and float(taw) == float(aw)
    assert ty.dtype == tx.dtype
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(y, np.float32), rtol=1e-5, atol=1e-4)
    # without the codes: the same y and amaxes
    ty2, tax2, taw2 = cudaex.fp8_linear(tx, torch.tensor(w), torch.tensor(sx), torch.tensor(sw))
    assert torch.equal(ty2, ty) and float(tax2) == float(tax) and float(taw2) == float(taw)


def test_fp8_linear_checker_is_hoppers():
    x, w = torch.zeros(8, 96), torch.zeros(40, 96)
    assert cudaex.fp8_linear_supported(x, w)  # the TPU gate wants K and N % 128
    assert not cudaex.fp8_linear_supported(torch.zeros(8, 80), torch.zeros(40, 80))  # K % 32
    assert not cudaex.fp8_linear_supported(x, torch.zeros(36, 96))  # N % 8
    assert not cudaex.fp8_linear_supported(x.half(), w)
    assert not cudaex.fp8_linear_supported(torch.zeros(2, 8, 96), w)


# ---------------------------------------------------------------------------
# TinyNet (tests/test_fp8_training.py) in both packages
# ---------------------------------------------------------------------------


class JaxTinyNet(jnn.Module):
    def __init__(self, d=D):
        super().__init__()
        self.fc1 = jnn.Linear(d, d, seed=0)
        self.fc2 = jnn.Linear(d, d, seed=1)

    def forward(self, x, y):
        return jlt.mse_loss(self.fc2(jlt.relu(self.fc1(x))), y)


class TinyNet(tnn.Module):
    def __init__(self, d=D):
        super().__init__()
        self.fc1 = tnn.Linear(d, d, device="cpu")
        self.fc2 = tnn.Linear(d, d, device="cpu")

    def forward(self, x, y):
        return tlt.mse_loss(self.fc2(tlt.relu(self.fc1(x))), y)


def _tiny_pair():
    jm, tm = JaxTinyNet(), TinyNet()
    with torch.no_grad():
        for k, p in tm.named_parameters():
            p.copy_(torch.tensor(np.asarray(dict(jm.named_parameters())[k].data)))
    return jm, tm


def _tiny_batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((32, D)).astype(np.float32),
            rng.standard_normal((32, D)).astype(np.float32))


def _hists(named_buffers) -> dict:
    return {k: np.asarray(b) if not isinstance(b, torch.Tensor) else b.numpy()
            for k, b in named_buffers if "fp8_amax" in k}


def test_amax_histories_roll_as_thunder_tpu():
    jm, tm = _tiny_pair()
    jf = tj.jit(jm, transforms=[jfp8.FP8TrainingTransform()])
    tf = tt.jit(tm, transforms=[tfp8.FP8TrainingTransform()])
    x, y = _tiny_batch()
    assert all((h == 0).all() for h in _hists(tm.named_buffers()).values())
    for call in range(2):
        jl = float(jf(jnp.asarray(x), jnp.asarray(y)))
        tl_ = float(tf(torch.tensor(x), torch.tensor(y)))
        np.testing.assert_allclose(tl_, jl, rtol=1e-5)
        jh, th = _hists(jm.named_buffers()), _hists(tm.named_buffers())
        assert set(jh) == set(th) == {f"fc{i}.fp8_amax_{r}_hist" for i in (1, 2) for r in "xw"}
        for k in th:
            assert th[k].dtype == np.float32 and th[k].shape == (16,)
            if k.startswith("fc1") or k.endswith("w_hist"):
                np.testing.assert_array_equal(th[k], jh[k], err_msg=k)
            else:  # fc2's input is fc1's output
                np.testing.assert_allclose(th[k], jh[k], rtol=1e-6, err_msg=k)
            assert (th[k][: call + 1] > 0).all() and (th[k][call + 1:] == 0).all()
        # the newest amax at slot 0; the weights did not change between calls
        assert th["fc1.fp8_amax_x_hist"][0] == np.abs(x).max()
        assert th["fc1.fp8_amax_w_hist"][call] == th["fc1.fp8_amax_w_hist"][0]


def test_forward_trace_saves_float8_residuals():
    _, tm = _tiny_pair()
    step = TrainStep(tt.jit(tm, transforms=[tfp8.FP8TrainingTransform()]), topt.SGD(lr=0.05))
    x, y = _tiny_batch()
    step(torch.tensor(x), torch.tensor(y))
    fwd = tt.last_traces(step)[-1]
    (out, effects), saved = fwd.output
    assert len(effects) == 4  # two histories for each of the two linears
    f8 = [p for p in saved if getattr(p, "dtype", None) is not None and p.dtype.name == "float8_e4m3"]
    assert len(f8) == 4 and {tuple(p.shape) for p in f8} == {(32, D), (D, D)}
    ids = [b.sym.id for b in fwd.bound_symbols]
    assert ids.count("fp8_train_ex.train_linear_aug") == 2
    bwd_ids = [b.sym.id for b in tt.last_backward_traces(step)[-1].bound_symbols]
    assert bwd_ids.count("fp8_train_ex.train_linear_bwd") == 2


def test_stateful_executor_binds_state_at_first_call():
    from thunder_tpu_torch.extend import StatefulExecutor

    made, seen = [], []
    ex = StatefulExecutor("test_stateful")
    sym = ex.register_stateful_operator(
        "op", lambda: made.append(object()) or made[-1],
        meta=lambda a: tt.TensorProxy(shape=a.shape, dtype=a.dtype, device=a.device),
        fn=lambda state, a: seen.append(state) or a + 1)
    assert sym.executor is ex and not made
    cf = tt.jit(lambda a: sym(a))
    for _ in range(2):
        torch.testing.assert_close(cf(torch.zeros(3)), torch.ones(3))
    assert len(made) == 1 and seen == [made[0], made[0]]


def test_recipe_rides_the_stateful_executor():
    saved = dict(tfp8.fp8_train_ex._states)
    try:
        tfp8.fp8_train_ex._states.clear()
        _, tm = _tiny_pair()
        tf = tt.jit(tm, transforms=[tfp8.FP8TrainingTransform()])
        x, y = _tiny_batch()
        tf(torch.tensor(x), torch.tensor(y))
        # the state is made at the operator's first call
        state = tfp8.fp8_train_ex._states["fp8_train_ex.train_linear"]
        assert isinstance(state, tfp8.FP8Recipe) and state.amax_history_len == 16
        r = tfp8.FP8Recipe(amax_history_len=8, margin=1)
        tfp8.set_recipe(r)
        tf(torch.tensor(x), torch.tensor(y))
        for name in ("train_linear", "train_linear_aug", "train_linear_bwd"):
            assert tfp8.fp8_train_ex._states[f"fp8_train_ex.{name}"] is r
    finally:
        tfp8.fp8_train_ex._states.clear()
        tfp8.fp8_train_ex._states.update(saved)


@pytest.fixture(scope="module")
def tiny_steps():
    x, y = _tiny_batch(1)
    jm, tm = _tiny_pair()
    js = JaxTrainStep(tj.jit(jm, transforms=[jfp8.FP8TrainingTransform()]), jopt.SGD(lr=0.05))
    ts = TrainStep(tt.jit(tm, transforms=[tfp8.FP8TrainingTransform()]), topt.SGD(lr=0.05))
    jl = [float(js(jnp.asarray(x), jnp.asarray(y))) for _ in range(3)]
    tl_ = [float(ts(torch.tensor(x), torch.tensor(y))) for _ in range(3)]
    return jm, tm, jl, tl_


def test_tinynet_fp8_train_step_matches_jax(tiny_steps):
    jm, tm, jl, tl_ = tiny_steps
    np.testing.assert_allclose(tl_, jl, rtol=1e-5)
    assert tl_[-1] < tl_[0]
    jp = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[k], atol=1e-5, rtol=0, err_msg=k)
    jh, th = _hists(jm.named_buffers()), _hists(tm.named_buffers())
    for k in th:
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-5, err_msg=k)
        assert (th[k][:3] > 0).all()


def _llama_pair(transforms_j, transforms_t, cfg_name="tiny-llama2"):
    jm = jlg.GPTForCausalLM(jlg.Config.from_name(cfg_name))
    tm = tlg.GPTForCausalLM(tlg.Config.from_name(cfg_name), device="cpu")
    jt = tj.jit(jm, transforms=transforms_j)
    tj_ = tt.jit(tm, transforms=transforms_t)
    state = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    state.update((k, np.asarray(b)) for k, b in jm.named_buffers() if "fp8_amax" in k)
    tlg.load_jax_params(tm, state)
    return jm, tm, jt, tj_


def _llama_batch(vocab, B=2, T=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, T)).astype(np.int32), rng.randint(0, vocab, (B, T)).astype(np.int32))


@pytest.fixture(scope="module")
def llama_fp8_steps():
    jm, tm, jt, tj_ = _llama_pair([JaxAutocast(), jfp8.FP8TrainingTransform(min_features=64)],
                                  [AutocastTransform(), tfp8.FP8TrainingTransform(min_features=64)])
    idx, tgt = _llama_batch(tm.cfg.vocab_size)
    js = JaxTrainStep(jt, jopt.AdamW(lr=1e-3))
    ts = TrainStep(tj_, topt.AdamW(lr=1e-3))
    jl = [float(js(jnp.asarray(idx), jnp.asarray(tgt))) for _ in range(3)]
    tl_ = [float(ts(torch.tensor(idx), torch.tensor(tgt))) for _ in range(3)]
    return jm, tm, jl, tl_, ts


def test_tiny_llama_fp8_autocast_train_step_matches_jax(llama_fp8_steps):
    jm, tm, jl, tl_, ts = llama_fp8_steps
    np.testing.assert_allclose(tl_, jl, rtol=1e-3)
    jp = {k: np.asarray(p.data, np.float32) for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), jp[k], atol=2e-2, rtol=0, err_msg=k)
    jh, th = _hists(jm.named_buffers()), _hists(tm.named_buffers())
    # every Linear of the 3 layers (5 each) and lm_head: two histories each
    assert set(th) == set(jh) and len(th) == 2 * (3 * 5 + 1)
    for k in th:
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-1, err_msg=k)
        assert (th[k][:3] > 0).all() and (th[k][3:] == 0).all()


def test_tiny_llama_fp8_step_runs_the_fp8_linear_everywhere(llama_fp8_steps):
    ts = llama_fp8_steps[-1]
    fwd = [b for b in tt.last_traces(ts)[-1].bound_symbols if b.sym.id == "fp8_train_ex.train_linear_aug"]
    bwd = [b for b in tt.last_backward_traces(ts)[-1].bound_symbols
           if b.sym.id == "fp8_train_ex.train_linear_bwd"]
    assert len(fwd) == len(bwd) == 3 * 5 + 1
    # under autocast the master weights reach the symbol in f32
    assert all(b.args[1].dtype.name == "float32" for b in fwd)


def test_load_jax_params_carries_amax_histories():
    jm, tm, jt, _ = _llama_pair([jfp8.FP8TrainingTransform(min_features=64)],
                                [tfp8.FP8TrainingTransform(min_features=64)])
    idx, tgt = _llama_batch(tm.cfg.vocab_size, seed=3)
    jt(jnp.asarray(idx), jnp.asarray(tgt))
    state = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    hists = {k: np.asarray(b) for k, b in jm.named_buffers() if "fp8_amax" in k}
    assert all(h[0] > 0 for h in hists.values())
    tlg.load_jax_params(tm, {**state, **hists})
    for k, b in tm.named_buffers():
        if "fp8_amax" in k:
            np.testing.assert_array_equal(b.numpy(), hists[k], err_msg=k)
    with pytest.raises(KeyError, match="fp8_amax"):
        tlg.load_jax_params(tm, state)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lora_steps():
    jm, tm, jt, tj_ = _llama_pair([JaxLORA(r=8, lora_alpha=16)], [LORATransform(r=8, lora_alpha=16)])
    # B starts at zero on both sides: give it values, so the first step's
    # adapter path is live, and carry them across
    rng = np.random.RandomState(5)
    jparams = dict(jm.named_parameters())
    for k, p in jparams.items():
        if k.endswith("lora_B"):
            p.data = jnp.asarray((rng.randn(*p.shape) * 0.01).astype(np.float32))
    jparams0 = {k: np.asarray(p.data) for k, p in jparams.items()}
    tlg.load_jax_params(tm, jparams0)
    # the transform freezes the Linears it adapts; the embedding and the
    # norms keep their flag in both packages, and a LoRA user freezes them
    for (k, jp), (_, tp) in zip(sorted(jparams.items()), sorted(tm.named_parameters())):
        if "lora" not in k:
            assert jp.requires_grad == tp.requires_grad == ("norm" in k or "ln_f" in k or "wte" in k), k
            jp.requires_grad = False
            tp.requires_grad_(False)
    base0 = {k: p.detach().clone() for k, p in tm.named_parameters() if "lora" not in k}
    idx, tgt = _llama_batch(tm.cfg.vocab_size, seed=1)
    js = JaxTrainStep(jt, jopt.AdamW(lr=1e-3))
    ts = TrainStep(tj_, topt.AdamW(lr=1e-3))
    jl = [float(js(jnp.asarray(idx), jnp.asarray(tgt))) for _ in range(3)]
    tl_ = [float(ts(torch.tensor(idx), torch.tensor(tgt))) for _ in range(3)]
    return jm, tm, jl, tl_, base0, jparams0, (idx, tgt)


def test_lora_trains_only_adapters_like_thunder_tpu(lora_steps):
    jm, tm, jl, tl_, base0, jparams0, _ = lora_steps
    np.testing.assert_allclose(tl_, jl, rtol=1e-4)
    assert tl_[-1] < tl_[0]
    names = [k for k, _ in tm.named_parameters()]
    assert sum(k.endswith("lora_A") for k in names) == 3 * 5 + 1
    jp = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        if "lora" in k:
            assert p.requires_grad
            assert not np.array_equal(p.detach().numpy(), jparams0[k]), k
            np.testing.assert_allclose(p.detach().numpy(), jp[k], atol=1e-4, rtol=0, err_msg=k)
        else:
            assert torch.equal(p.detach(), base0[k]), k


def test_lora_merge_gives_the_same_logits(lora_steps):
    jm, tm, _, _, _, _, (idx, _) = lora_steps
    jlogits = np.asarray(tj.jit(jm.gpt)(jnp.asarray(idx)))
    tlogits = tt.jit(tm.gpt)(torch.tensor(idx)).numpy()
    jax_merge(jm)
    merge_lora_weights(tm)
    assert not any("lora" in k for k, _ in tm.named_parameters())
    jm_logits = np.asarray(tj.jit(jm.gpt)(jnp.asarray(idx)))
    tm_logits = tt.jit(tm.gpt)(torch.tensor(idx)).numpy()
    np.testing.assert_allclose(tm_logits, jm_logits, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tm_logits, tlogits, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(jm_logits, jlogits, atol=1e-4, rtol=1e-4)


def test_lora_options():
    with pytest.raises(NotImplementedError, match="lora_dropout"):
        LORATransform(lora_dropout=0.1)
    tm = tlg.GPTForCausalLM(tlg.Config.from_name("tiny-llama2"), device="cpu")
    LORATransform(r=4, target_modules=("attn.attn",)).transform_module(tm)
    adapted = sorted(k for k, _ in tm.named_parameters() if k.endswith("lora_A"))
    assert adapted == [f"gpt.h.{i}.attn.attn.lora_A" for i in range(3)]
    assert tuple(tm.gpt.h[0].attn.attn.lora_A.shape) == (4, 128)
    with pytest.raises(ValueError, match="matched no Linear"):
        LORATransform(target_modules=("nothing",)).transform_module(
            tlg.GPTForCausalLM(tlg.Config.from_name("tiny-llama2"), device="cpu"))
