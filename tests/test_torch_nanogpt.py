"""The port's NanoGPT, plain flash attention and fused cross-entropy against
thunder_tpu's, on the CPU.

NanoGPT's ``test`` config (2 layers, 2 heads of 32, vocab 256), B=2, T=64,
thunder_tpu's initial weights carried across by ``load_jax_params``, one
fixed batch from numpy:

* forward logits to 1e-5 and the loss to 1e-6 relative (f32 both sides,
  another summation order).
* f32 TrainStep, AdamW(lr=1e-3), 10 steps: losses to 1e-4 relative and
  parameters to 1e-4 absolute, the bars of tests/test_torch_training.py
  (measured 1.8e-6 and 3e-5), but for the keys' bias, whose gradient is 0
  up to rounding (see the test). bf16 autocast, 3 steps: 2e-2, as there.
  thunder_tpu drops the gradient of an embedding whose indices are a
  constant array (its NanoGPT takes ``jnp.arange(T)`` for the positions,
  so ``wpe`` never trains: ``test_reference_drops_the_constant_index_
  embedding_grad``). The port traces the positions as an iota and trains
  ``wpe``. So the training comparisons hold the port against thunder_tpu's
  NanoGPT with the positions passed in as an input (``_JaxNanoGPT``): the
  same module math, with that gradient kept.
* The Hopper checker claims T = 64, which thunder_tpu's (T >= 1024) does
  not: the port runs the plain flash version where thunder_tpu runs the
  composite sdpa. Both are the same f32 math in another order, well inside
  the bars above.
* The plain flash forward/backward against pallasex's kernels in interpret
  mode, at tests/test_pallas.py's bars: forward f32 2e-3, bf16 3e-2;
  backward f32 5e-3, bf16 1e-1.
* The plain cross-entropy against pallasex's kernel in interpret mode: f32
  1e-5, bf16 logits 1e-4 (both upcast the same bf16 values; lse in another
  order).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu import optim as jopt
from thunder_tpu.executors import pallasex
from thunder_tpu.models import nanogpt as jn
from thunder_tpu.ops import ltorch as jlt
from thunder_tpu.training import TrainStep as JaxTrainStep
from thunder_tpu.transforms.autocast import AutocastTransform as JaxAutocast
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import nanogpt as tn
from thunder_tpu_torch.training import TrainStep
from thunder_tpu_torch.transforms.autocast import AutocastTransform

B, T = 2, 64


class _JaxNanoGPT(jn.NanoGPT):
    """thunder_tpu's NanoGPT with the positions as an input, so its
    autodiff keeps the ``wpe`` gradient (see the module docstring)."""

    def forward(self, idx, targets, pos):
        b, t = idx.shape
        x = self.wte(idx) + self.wpe(pos)
        for block in self.h:
            x = block(x)
        logits = self.lm_head(self.ln_f(x))
        return jlt.cross_entropy(jlt.reshape(logits, (b * t, self.cfg.vocab_size)),
                                 jlt.reshape(targets, (b * t,)))


def _pair(jax_cls=jn.NanoGPT):
    jm = jax_cls(jn.configs["test"])
    tm = tn.NanoGPT(tn.configs["test"], device="cpu")
    tn.load_jax_params(tm, {k: np.asarray(p.data) for k, p in jm.named_parameters()})
    return jm, tm


def _batch():
    rng = np.random.RandomState(0)
    V = tn.configs["test"].vocab_size
    return (rng.randint(0, V, (B, T)).astype(np.int32), rng.randint(0, V, (B, T)).astype(np.int32))


def _params(jm, tm):
    jp = {k: np.asarray(p.data, dtype=np.float32) for k, p in jm.named_parameters()}
    tp = {k: p.detach().float().numpy() for k, p in tm.named_parameters()}
    return jp, tp


def _train(n_steps: int, autocast: bool):
    jm, tm = _pair(_JaxNanoGPT)
    idx, tgt = _batch()
    js = JaxTrainStep(tj.jit(jm, transforms=[JaxAutocast()] if autocast else None),
                      jopt.AdamW(lr=1e-3))
    ts = TrainStep(tt.jit(tm, transforms=[AutocastTransform()] if autocast else None),
                   topt.AdamW(lr=1e-3))
    pos = jnp.arange(T, dtype=jnp.int32)
    jl = [float(js(jnp.asarray(idx), jnp.asarray(tgt), pos)) for _ in range(n_steps)]
    tl_ = [float(ts(torch.tensor(idx), torch.tensor(tgt))) for _ in range(n_steps)]
    return np.array(jl), np.array(tl_), *_params(jm, tm), ts


@pytest.fixture(scope="module")
def f32_run():
    return _train(10, autocast=False)


@pytest.fixture(scope="module")
def bf16_run():
    return _train(3, autocast=True)


def test_param_names_and_shapes_match_jax():
    jm, tm = _pair()
    assert [(k, tuple(p.shape)) for k, p in jm.named_parameters()] == \
        [(k, tuple(p.shape)) for k, p in tm.named_parameters()]
    assert tn.configs["gpt2"] == tn.NanoGPTConfig(n_layer=12, n_head=12, n_embd=768, vocab_size=50304)


def test_forward_logits_and_loss_match_jax():
    jm, tm = _pair()
    idx, tgt = _batch()
    jlogits = np.asarray(tj.jit(jm)(jnp.asarray(idx)))
    tlogits = tt.jit(tm)(torch.tensor(idx)).numpy()
    np.testing.assert_allclose(tlogits, jlogits, atol=1e-5, rtol=0)
    jloss = float(tj.jit(jm)(jnp.asarray(idx), jnp.asarray(tgt)))
    tloss = float(tt.jit(tm)(torch.tensor(idx), torch.tensor(tgt)))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)


def test_forward_loss_claims_flash_and_cross_entropy():
    """With no grad, sdpa and cross_entropy are claimed whole by cudaex (the
    plain versions run on CPU tensors)."""
    _, tm = _pair()
    idx, tgt = _batch()
    fn = tt.jit(tm)
    fn(torch.tensor(idx), torch.tensor(tgt))
    impls = [b.impl for b in tt.last_traces(fn)[-1].bound_symbols]
    assert impls.count(cudaex._sdpa_impl) == 2
    assert impls.count(cudaex._cross_entropy_impl) == 1


def test_f32_losses_and_params_match_jax(f32_run):
    """Every parameter to 1e-4 but the k third of each c_attn.bias: adding
    a constant to every key shifts each score row by one constant, which
    the softmax ignores, so that gradient is 0 up to rounding, and AdamW
    steps each element by up to ±lr on the rounding's sign: those elements
    are held to 2 lr a step (up to 8.2e-5 apart measured, where every other
    element is within 3e-5)."""
    jl, tl_, jp, tp, _ = f32_run
    np.testing.assert_allclose(tl_, jl, rtol=1e-4, atol=0)
    assert tl_[-1] < tl_[0]
    assert set(jp) == set(tp)
    C = tn.configs["test"].n_embd
    for k in jp:
        if k.endswith("attn.c_attn.bias"):
            kb = slice(C, 2 * C)
            np.testing.assert_allclose(tp[k][kb], jp[k][kb], atol=2 * 1e-3 * 10, rtol=0, err_msg=k)
            tp[k][kb] = jp[k][kb]
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-4, rtol=0, err_msg=k)


def test_step_traces_claim_the_flash_kernels(f32_run):
    """Each layer's attention is one flash_attention_fwd in the forward
    program and one flash_attention_bwd in the backward program; the loss
    trains through cross_entropy's composite grad rule, as in thunder_tpu."""
    ts = f32_run[-1]
    fwd = [b.sym.id for b in tt.last_traces(ts)[-1].bound_symbols]
    bwd = [b.sym.id for b in tt.last_backward_traces(ts)[-1].bound_symbols]
    assert fwd.count("cuda.flash_attention_fwd") == 2
    assert bwd.count("cuda.flash_attention_bwd") == 2
    assert "torch.nn.functional.cross_entropy" not in fwd


def test_bf16_autocast_matches_jax(bf16_run):
    jl, tl_, jp, tp, ts = bf16_run
    np.testing.assert_allclose(tl_, jl, rtol=2e-2, atol=0)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=2e-2, rtol=0, err_msg=k)
    claimed = [b for b in tt.last_traces(ts)[-1].bound_symbols if b.sym.id == "cuda.flash_attention_fwd"]
    assert claimed and all(b.args[0].dtype.name == "bfloat16" for b in claimed)


def test_reference_drops_the_constant_index_embedding_grad():
    """thunder_tpu's NanoGPT gives wpe a zero gradient; the port's equals
    thunder_tpu's with the positions passed as an input."""
    jm, tm = _pair()
    jm2, _ = _pair(_JaxNanoGPT)
    for (_, p), (_, q) in zip(jm.named_parameters(), jm2.named_parameters()):
        q.data = p.data
    idx, tgt = _batch()
    _, jg = tj.value_and_grad(tj.jit(jm))(jnp.asarray(idx), jnp.asarray(tgt))
    _, jg2 = tj.value_and_grad(tj.jit(jm2))(jnp.asarray(idx), jnp.asarray(tgt),
                                            jnp.arange(T, dtype=jnp.int32))
    _, tg = tt.value_and_grad(tt.jit(tm))(torch.tensor(idx), torch.tensor(tgt))
    assert not np.asarray(jg["wpe.weight"]).any()
    np.testing.assert_allclose(tg["wpe.weight"].numpy(), np.asarray(jg2["wpe.weight"]), atol=1e-7)
    assert np.abs(tg["wpe.weight"].numpy()).max() > 1e-4


# ---------------------------------------------------------------------------
# plain flash attention against pallasex's kernels (interpret mode)
# ---------------------------------------------------------------------------

FLASH_FWD_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
FLASH_BWD_TOL = {"float32": 5e-3, "bfloat16": 1e-1}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("Hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("D", [32, 64])
def test_flash_plain_matches_pallas(D, Hkv, causal, dtype):
    rng = np.random.RandomState(D + Hkv)
    H, Tq = 4, 128
    q, do = (rng.randn(1, H, Tq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, Hkv, Tq, D).astype(np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype=dtype) for a in (q, k, v, do))
    jo, jlse = pallasex.flash_attention_forward(jq, jk, jv, causal=causal, scale=scale)
    jdq, jdk, jdv = pallasex.flash_attention_backward(jq, jk, jv, jo, jlse, jdo, causal=causal,
                                                      scale=scale)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.tensor(a).to(tdt) for a in (q, k, v, do))
    o, lse = cudaex.flash_attention(tq, tk, tv, causal, scale)
    ft, bt = FLASH_FWD_TOL[dtype], FLASH_BWD_TOL[dtype]
    f32 = lambda a: np.asarray(a, dtype=np.float32)  # noqa: E731
    np.testing.assert_allclose(o.float().numpy(), f32(jo), atol=ft, rtol=ft)
    np.testing.assert_allclose(lse.numpy(), f32(jlse), atol=ft, rtol=ft)
    grads = cudaex.flash_attention_backward(tq, tk, tv, o, lse, tdo, causal, scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), f32(want), atol=bt, rtol=bt, err_msg=name)


def test_flash_autograd_function_on_cpu():
    """FlashAttention.apply runs the plain versions on CPU tensors; its
    gradients match torch.autograd through the plain forward (GQA)."""
    rng = np.random.RandomState(3)
    q = torch.tensor(rng.randn(1, 4, 40, 32).astype(np.float32))
    k, v = (torch.tensor(rng.randn(1, 2, 40, 32).astype(np.float32)) for _ in range(2))
    do = torch.tensor(rng.randn(1, 4, 40, 32).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    cudaex.FlashAttention.apply(*leaves, True, None).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    cudaex.flash_attention_plain(*ref, True, None)[0].backward(do)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)


def _proxy(*shape, dt=dtypes.bfloat16):
    return TensorProxy(shape=shape, dtype=dt, device=tt.devices.cpu)


def test_flash_checker_is_hoppers():
    """Claims what pallasex's checker declines (T < 1024, T not a multiple
    of 512, GQA at T = 100); declines a mask, dropout, D > 128, an odd D,
    T != Tk and mixed dtypes."""
    def ok(H=4, Hkv=2, T_=100, Tk=None, D=64, dt=dtypes.bfloat16, **kw):
        Tk = T_ if Tk is None else Tk
        args = (_proxy(1, H, T_, D, dt=dt), _proxy(1, Hkv, Tk, D, dt=dt), _proxy(1, Hkv, Tk, D, dt=dt))
        return cudaex.flash_attention_supported(*args, **kw), pallasex.flash_attention_supported(*args, **kw)

    for case in (dict(), dict(T_=1), dict(T_=1024, D=128, Hkv=4), dict(D=16, dt=dtypes.float32),
                 dict(is_causal=True)):
        assert ok(**case)[0], case
    assert ok()[1] is False and ok(T_=1000)[1] is False
    assert ok(T_=1024, Hkv=4)[1] is True  # a shape both claim
    for case in (dict(attn_mask=_proxy(100, 100)), dict(dropout_p=0.1), dict(D=136), dict(D=130),
                 dict(D=34), dict(Tk=64), dict(Hkv=3), dict(dt=dtypes.int32)):
        assert not ok(**case)[0], case


def test_sdpa_declined_shape_runs_the_decomposition():
    """D = 136 (> 128): the sdpa bsym is not claimed and trains through the
    composite rules."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.tensor(rng.randn(1, 2, 8, 136).astype(np.float32)) for _ in range(3))
    from thunder_tpu_torch.ops import ltorch

    def f(q, k, v):
        return ltorch.sum(ltorch.sdpa(q, k, v, is_causal=True))

    vag = tt.value_and_grad(f, argnums=(0, 1, 2))
    val, _ = vag(q, k, v)
    ids = [b.sym.id for b in tt.last_traces(vag)[-1].bound_symbols]
    assert "cuda.flash_attention_fwd" not in ids
    ref = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True).sum()
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-5)


# ---------------------------------------------------------------------------
# plain cross-entropy against pallasex's kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)], ids=["f32", "bf16"])
def test_cross_entropy_plain_matches_pallas(dtype, tol):
    """N = 16 rows, V = 200 (not a multiple of 128), rows 3 and 11 at
    ignore_index: per-row loss and lse, and the claimed mean."""
    rng = np.random.RandomState(7)
    N, V = 16, 200
    logits = (3 * rng.randn(N, V)).astype(np.float32)
    tgt = rng.randint(0, V, N).astype(np.int32)
    tgt[[3, 11]] = -100
    jlogits = jnp.asarray(logits, dtype=dtype)
    jloss, jlse = pallasex.fused_cross_entropy_forward(jlogits, jnp.asarray(tgt))
    tlogits = torch.tensor(logits).to(getattr(torch, dtype))
    loss, lse = cudaex.cross_entropy(tlogits, torch.tensor(tgt))
    assert loss.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=tol, rtol=tol)
    np.testing.assert_allclose(loss.numpy()[[3, 11]], lse.numpy()[[3, 11]])  # picked 0
    jmean = float(pallasex._xent_impl(jlogits, jnp.asarray(tgt)))
    tmean = float(cudaex._cross_entropy_impl(tlogits, torch.tensor(tgt)))
    np.testing.assert_allclose(tmean, jmean, rtol=tol)


def test_cross_entropy_checker_is_hoppers():
    """Claims N and V that pallasex's checker declines (N % 8, V % 128:
    GPT-2's 50304 = 393 x 128 passes both, Llama's 32000 too, 200 and N = 13
    only Hopper's); declines weight, smoothing, a sum, 3-d logits and float
    targets."""
    def ok(N=13, V=200, dt=dtypes.bfloat16, tdt=dtypes.int64, **kw):
        args = (_proxy(N, V, dt=dt), _proxy(N, dt=tdt))
        return cudaex.cross_entropy_supported(*args, **kw), pallasex._xent_supported(*args, **kw)

    assert ok() == (True, False) and ok(N=16) == (True, False) and ok(N=13, V=256) == (True, False)
    assert ok(N=8192, V=50304) == (True, True) and ok(N=8192, V=32000, dt=dtypes.float32) == (True, True)
    for case in (dict(weight=_proxy(200)), dict(label_smoothing=0.1), dict(reduction="sum"),
                 dict(tdt=dtypes.float32)):
        assert not ok(**case)[0], case
    assert not cudaex.cross_entropy_supported(_proxy(2, 13, 200), _proxy(2, 13, dt=dtypes.int64))
