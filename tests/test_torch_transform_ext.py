"""The port's transform breadth against thunder_tpu's, on the CPU.

* ConstantFolding (transforms/constant_folding.py): the same folded trace
  (symbol ids, in order) from the same prim program, and outputs within
  1e-6 (f32).
* PrunePrologueChecks / ExtractionOnlyPrologueTransform: no check prim left
  in the prologue (tests/test_quantization.py's assertion) and the program
  still runs.
* meta_device / MaterializationTransform (transforms/materialization.py):
  nothing is allocated under meta (every parameter and buffer a meta
  tensor); materialized, the parameters have the model's shapes, dtypes and
  target device, the normal(0.02) statistics (std and mean each within 4
  standard errors of a sample of the tensor's size), an ``init_fn`` route,
  the rope buffers equal to an
  eager build's, and one seed gives one set of weights. The RNG streams are
  not compared (ROADMAP ground rule 4): thunder_tpu's weights are carried
  in with load_jax_params and the loss agrees within 1e-5 relative.
* autocast_ctx (transforms/autocast.py): nested regions and enabled=False
  cast the same ops as thunder_tpu's (output dtypes equal), values within
  1e-2 of the largest (bf16: the same ops rounded, each to one bf16 ulp of
  2^-8) and gradients through value_and_grad within 2e-2 of the largest.
* FP8LinearInference (transforms/fp8_inference.py): e4m3 codes and scales
  bit-equal to thunder_tpu's quantize_fp8_weight, the quantized net's
  outputs within 1e-5 of the largest of thunder_tpu's (f32: the same codes,
  the f32 product summed in another order), bf16 within 2^-7 relative, and
  chip_smoke.py's fp8 bound holding on the port's linear and failing on a
  planted wrong x scale.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu import nn as jnn
from thunder_tpu.ops import ltorch as jl
from thunder_tpu_torch import nn as tnn
from thunder_tpu_torch.ops import ltorch as tl

TOL = 1e-6


# ---------------------------------------------------------------------------
# constant folding
# ---------------------------------------------------------------------------


def _folding_program(prims, dtypes):
    def f(x):
        c = prims.full((4,), 2.0, dtype=dtypes.float32)
        i = prims.iota(4, start=1, step=2, dtype=dtypes.float32)
        d = prims.mul(prims.exp(c), prims.add(i, c))  # constant: folds to one tensor
        return prims.add(x, d), prims.mul(x, x)

    return f


def test_constant_folding_matches_thunder_tpu():
    from thunder_tpu.core import dtypes as jd, prims as jp
    from thunder_tpu.transforms.constant_folding import ConstantFolding as JFold, fold_constants as jfold
    from thunder_tpu_torch.core import dtypes as td, prims as tp
    from thunder_tpu_torch.transforms.constant_folding import ConstantFolding, fold_constants

    x = np.random.RandomState(0).rand(4).astype(np.float32)
    jtrc, *_ = tj.acquire_trace(_folding_program(jp, jd), (jnp.asarray(x),), {})
    ttrc = tt.acquire_trace(_folding_program(tp, td), (torch.tensor(x),), {})
    jids = [b.sym.id.name for b in jfold(jtrc).bound_symbols]
    tids = [b.sym.id.name for b in fold_constants(ttrc).bound_symbols]
    assert tids == jids
    assert tids.count("TENSOR_CONSTANT") == 1 and "EXP" not in tids
    jout = tj.jit(_folding_program(jp, jd), transforms=[JFold()])(jnp.asarray(x))
    cf = tt.jit(_folding_program(tp, td), transforms=[ConstantFolding()])
    tout = cf(torch.tensor(x))
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    ex_ids = [b.sym.id for b in tt.last_traces(cf)[-1].bound_symbols]
    assert tp.PrimIDs.EXP not in ex_ids


# ---------------------------------------------------------------------------
# prologue pruning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["PrunePrologueChecks", "ExtractionOnlyPrologueTransform"])
def test_pruned_prologue_has_no_check_prims(name):
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.transforms import prune_prologue_checks

    net = tnn.Linear(64, 32, device="cpu")
    tm = tt.jit(net, transforms=[getattr(prune_prologue_checks, name)()])
    x = torch.rand(2, 64)
    torch.testing.assert_close(tm(x), torch.nn.functional.linear(x, net.weight, net.bias), rtol=0, atol=TOL)
    pro = tt.last_prologue_traces(tm)[-1]
    check_ids = {PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA, PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE,
                 PrimIDs.CHECK_LITERAL_LIKE}
    assert not [b for b in pro.bound_symbols if b.sym.id in check_ids]
    unpruned = tt.jit(tnn.Linear(64, 32, device="cpu"))
    unpruned(x)
    assert [b for b in tt.last_prologue_traces(unpruned)[-1].bound_symbols if b.sym.id in check_ids]


# ---------------------------------------------------------------------------
# meta device and materialization
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def materialized():
    from thunder_tpu_torch.models import litgpt as tlg
    from thunder_tpu_torch.transforms.materialization import (MaterializationTransform, is_meta_mode,
                                                               meta_device)

    cfg = tlg.Config.from_name("tiny-llama2")
    with meta_device():
        assert is_meta_mode()
        model = tlg.GPTForCausalLM(cfg)
    assert not is_meta_mode()
    meta_state = {k: (tuple(t.shape), t.dtype, t.is_meta) for k, t in
                  [*model.named_parameters(), *model.named_buffers()]}
    calls = []

    def init_ones(gen):
        calls.append(gen.device)
        return torch.ones(tuple(model.gpt.ln_f.weight.shape), device=gen.device)

    model.gpt.ln_f.weight.init_fn = init_ones
    tm = tt.jit(model)
    MaterializationTransform(seed=0, device="cpu").transform_module(tm)
    return cfg, model, tm, meta_state, calls


def test_nothing_is_allocated_under_meta_device(materialized):
    *_, meta_state, _ = materialized
    assert meta_state and all(is_meta for _, _, is_meta in meta_state.values())


def test_materialized_shapes_dtypes_devices_and_init_fn(materialized):
    from thunder_tpu_torch.models import litgpt as tlg

    cfg, model, _, meta_state, calls = materialized
    eager = tlg.GPTForCausalLM(cfg, device="cpu")
    assert {k: (tuple(p.shape), p.dtype) for k, p in model.named_parameters()} == \
        {k: (tuple(p.shape), p.dtype) for k, p in eager.named_parameters()}
    assert all(t.device.type == "cpu" for t in [*model.parameters(), *model.buffers()])
    assert all(p.requires_grad for p in model.parameters())
    assert calls == [torch.device("cpu")]
    assert torch.equal(model.gpt.ln_f.weight, torch.ones_like(model.gpt.ln_f.weight))
    for name in ("cos", "sin"):
        assert torch.equal(getattr(model.gpt, name), getattr(eager.gpt, name))


def test_materialized_statistics_and_seed(materialized):
    from thunder_tpu_torch.models import litgpt as tlg
    from thunder_tpu_torch.transforms.materialization import MaterializationTransform, meta_device

    cfg, model, *_ = materialized
    for k, p in model.named_parameters():
        if k == "gpt.ln_f.weight":
            continue
        n = p.numel()
        # 4 standard errors of a sample of n normal(0, 0.02) values
        assert abs(p.std().item() - 0.02) <= 4 * 0.02 / math.sqrt(2 * n), k
        assert abs(p.mean().item()) <= 4 * 0.02 / math.sqrt(n), k
    again = []
    for seed in (0, 0, 1):
        with meta_device():
            m = tlg.GPTForCausalLM(cfg)
        MaterializationTransform(seed=seed, device="cpu").transform_module(m)
        again.append(m.gpt.wte.weight.detach())
    assert torch.equal(again[0], again[1]) and not torch.equal(again[0], again[2])
    assert torch.equal(again[0], model.gpt.wte.weight.detach())


def test_materialized_model_runs_thunder_tpus_weights(materialized):
    from thunder_tpu.models import litgpt as jlg
    from thunder_tpu_torch.models import litgpt as tlg

    cfg, model, tm, *_ = materialized
    jm = jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2"))
    tlg.load_jax_params(model, {k: np.asarray(p.data) for k, p in jm.named_parameters()})
    rng = np.random.RandomState(0)
    idx = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tgt = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want = float(tj.jit(jm)(jnp.asarray(idx), jnp.asarray(tgt)))
    got = float(tm(torch.tensor(idx), torch.tensor(tgt)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_meta_buffer_without_init_fn_raises():
    from thunder_tpu_torch.transforms.materialization import MaterializationTransform

    m = torch.nn.Module()
    m.register_buffer("stats", torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="no init_fn"):
        MaterializationTransform(device="cpu").transform_module(m)


def test_sharding_fn_raises_naming_the_distributed_slice():
    """thunder_tpu's hook returns a jax sharding; the port has no sharded
    materialization yet, so the option raises instead of placing anything."""
    from thunder_tpu_torch.transforms.materialization import MaterializationTransform

    with pytest.raises(NotImplementedError, match="A3c"):
        MaterializationTransform(seed=0, sharding_fn=lambda name, shape: None)


# ---------------------------------------------------------------------------
# autocast_ctx
# ---------------------------------------------------------------------------


def _autocast_program(ltorch, autocast_ctx, dtypes):
    def f(x, w1, w2, w3):
        with autocast_ctx(dtypes.bfloat16):
            h = ltorch.linear(x, w1)  # bf16
            with autocast_ctx(enabled=False):
                e = ltorch.linear(x, w3)  # stays f32
            with autocast_ctx(dtypes.bfloat16):
                h = ltorch.silu(ltorch.linear(h, w2))  # nested: bf16
        y = ltorch.linear(ltorch.to(h, dtypes.float32), w2)  # after the region: f32
        return ltorch.sum(y * y) + ltorch.sum(e), (h, e, y)

    return f


def test_autocast_ctx_matches_thunder_tpu_through_a_backward():
    from thunder_tpu.core import dtypes as jd
    from thunder_tpu.transforms.autocast import autocast_ctx as jctx
    from thunder_tpu.transforms.autodiff import ThunderValueAndGrad as JVAG
    from thunder_tpu_torch.core import dtypes as td
    from thunder_tpu_torch.transforms.autocast import autocast_ctx

    rng = np.random.RandomState(1)
    arrays = [rng.randn(4, 16).astype(np.float32), rng.randn(16, 16).astype(np.float32) / 4,
              rng.randn(16, 16).astype(np.float32) / 4, rng.randn(8, 16).astype(np.float32) / 4]
    jf, tf = _autocast_program(jl, jctx, jd), _autocast_program(tl, autocast_ctx, td)
    jouts = tj.jit(jf)(*[jnp.asarray(a) for a in arrays])[1]
    touts = tt.jit(tf)(*[torch.tensor(a) for a in arrays])[1]
    assert [str(t.dtype) for t in touts] == ["torch.bfloat16", "torch.float32", "torch.float32"]
    assert [str(t.dtype) for t in jouts] == ["bfloat16", "float32", "float32"]
    for g, w in zip(touts, jouts):
        w = np.asarray(w, dtype=np.float32)
        assert np.abs(g.float().numpy() - w).max() <= 1e-2 * np.abs(w).max()
    argnums = (0, 1, 2, 3)
    jv, jg = JVAG(lambda *a: jf(*a)[0], argnums=argnums)(*[jnp.asarray(a) for a in arrays])
    tv, tg = tt.value_and_grad(lambda *a: tf(*a)[0], argnums=argnums)(*[torch.tensor(a) for a in arrays])
    assert abs(float(tv) - float(jv)) <= 1e-2 * abs(float(jv))
    for i in argnums:
        w = np.asarray(jg[0][i], dtype=np.float32)
        assert tg[0][i].dtype == torch.float32
        assert np.abs(tg[0][i].numpy() - w).max() <= 2e-2 * np.abs(w).max(), i


def test_autocast_ctx_restores_the_stack():
    from thunder_tpu_torch.core import symbol
    from thunder_tpu_torch.transforms.autocast import autocast_ctx

    with pytest.raises(RuntimeError):
        with autocast_ctx():
            with autocast_ctx(enabled=False):
                assert len(symbol._autocast_stack) == 2 and symbol._autocast_stack[-1] is None
                raise RuntimeError("inside")
    assert not symbol._autocast_stack


# ---------------------------------------------------------------------------
# fp8 inference
# ---------------------------------------------------------------------------


def _fp8_nets():
    """thunder_tpu's test _Net (64 -> 32 -> 8) on both packages, the same
    weights."""
    class JNet(jnn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(64, 32, seed=1)
            self.fc2 = jnn.Linear(32, 8, seed=2)

        def forward(self, x):
            return self.fc2(jl.relu(self.fc1(x)))

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = tnn.Linear(64, 32, device="cpu")
            self.fc2 = tnn.Linear(32, 8, device="cpu")

        def forward(self, x):
            return self.fc2(tl.relu(self.fc1(x)))

    jnet, tnet = JNet(), TNet()
    with torch.no_grad():
        for k, p in tnet.named_parameters():
            p.copy_(torch.tensor(np.asarray(dict(jnet.named_parameters())[k].data)))
    return jnet, tnet


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_fp8_weight_bit_equal(dtype):
    from thunder_tpu.transforms.fp8_inference import quantize_fp8_weight as jq
    from thunder_tpu_torch.transforms.fp8_inference import quantize_fp8_weight

    w = (np.random.RandomState(2).randn(48, 80) * np.logspace(-3, 2, 48)[:, None]).astype(np.float32)
    w[5] = 0.0  # an all-zero row: amax clamps to 1e-12
    jqw, js = jq(jnp.asarray(w, dtype=dtype))
    tqw, ts = quantize_fp8_weight(torch.tensor(w).to(getattr(torch, dtype)))
    assert np.array_equal(tqw.view(torch.uint8).numpy(), np.asarray(jqw).view(np.uint8))
    assert np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2.0 ** -7)])
def test_fp8_linear_inference_matches_thunder_tpu(dtype, tol):
    from thunder_tpu.transforms.fp8_inference import FP8LinearInference as JFP8
    from thunder_tpu_torch.transforms.fp8_inference import FP8LinearInference

    jnet, tnet = _fp8_nets()
    jm = tj.jit(jnet, transforms=[JFP8(min_features=8)])
    tm = tt.jit(tnet, transforms=[FP8LinearInference(min_features=8)])
    assert tnet.fc1.weight.dtype == torch.float8_e4m3fn and tnet.fc2.fp8_scale.dtype == torch.float32
    x = np.random.RandomState(3).randn(5, 64).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x, dtype=dtype)), dtype=np.float32)
    got = tm(torch.tensor(x).to(getattr(torch, dtype))).float().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    ids = [b.sym.id for b in tt.last_traces(tm)[-1].bound_symbols]
    assert ids.count("fp8.linear") == 2


def test_fp8_min_features_keeps_small_layers():
    from thunder_tpu_torch.transforms.fp8_inference import FP8LinearInference

    _, tnet = _fp8_nets()
    tt.jit(tnet, transforms=[FP8LinearInference()])  # min_features=64: neither layer has both dims >= 64
    assert tnet.fc1.weight.dtype == torch.float32 and tnet.fc2.weight.dtype == torch.float32


def test_chip_smoke_fp8_bound_holds_and_catches_a_wrong_x_scale(monkeypatch):
    """chip_smoke.py's fp8_inference check: the port's linear against the
    written-out plain version on the same x within FP8_ACC_EPS·Σ|terms| plus
    one ulp of the cast; with x's scale off by 1/64 the codes change and the
    check fails."""
    import chip_smoke
    from thunder_tpu_torch.transforms import fp8_inference

    rng = torch.Generator().manual_seed(0)
    x = (torch.randn(32, 256, generator=rng) * 3).to(torch.bfloat16)
    w = torch.randn(128, 256, generator=rng) * 0.05
    q, s = fp8_inference.quantize_fp8_weight(w)
    y = fp8_inference.fp8_linear_impl(x, q, s)
    assert chip_smoke.fp8_inference_err(x, q, s, None, y) <= 1.0
    monkeypatch.setattr(fp8_inference, "E4M3_MAX", fp8_inference.E4M3_MAX * (1 + 1 / 64))
    bad = fp8_inference.fp8_linear_impl(x, q, s)
    assert chip_smoke.fp8_inference_err(x, q, s, None, bad) > 1.0
