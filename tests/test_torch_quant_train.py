"""Training with frozen int8/NF4 linears, against thunder_tpu's, on the CPU;
and the card routes this slice adds, on the card.

CPU (jax imported inside the fixtures, so the card tests below run with
``--noconftest`` and no jax):

* tiny-llama2 at 2 layers with its MLP widened to 512 (so every mlp.proj
  takes NF4's kernel layout) and every mlp.fc_1/fc_2 int8 (int8-exact weights: codes
  times 2^-9, on which thunder_tpu's CPU route, the weights dequantized to
  bf16, and the port's, the int8 sum then the scale, compute one product),
  every mlp.proj NF4: 3 f32 AdamW steps of the port's TrainStep against
  thunder_tpu's from the same weights and batch. Losses and trainable
  parameters within 1e-5; the codes, scales and absmax bit-equal to
  thunder_tpu's and to their start. The frozen linears' backward rounds
  the gradient and the weight to bf16 (thunder_tpu's rule, on both sides),
  and XLA and torch sum that bf16 product in other orders, so an input
  gradient can land one bf16 ulp apart. At AdamW's default eps (1e-8) the
  step is lr·sign(g) for small g, and such a gap flips the step of a
  near-zero gradient by 2·lr (measured: 3e-3 at lr 1e-3); eps = 0.1 makes
  the step continuous in g (it moves by at most lr/eps times the gap:
  measured 9.5e-7) while every tensor still moves by more than 5x the
  bound (the norms' least: 9.3e-5). The rounding itself is held by the
  next case.
* the frozen linears' input gradient (int8, NF4 canonical and kernel
  layouts) against thunder_tpu's: equal but for one bf16 ulp where the sums
  straddle a rounding boundary (at most 1 % of the elements), and apart
  from the unrounded f32 product, which a port without the rounding would
  give.
* thunder_tpu's test_quantized_bias_trains shape (tests/test_quantization.py):
  a quantized fc2 keeps a trainable bias, which must move as thunder_tpu's
  does (within 1e-5).

On the card (``gpu``):

* fp8 inference's torch._scaled_mm route against thunder_tpu's function
  written out (chip_smoke.py's fp8_inference_err: the f32 accumulation, the
  tensor cores' FP8_MMA_EPS and the final cast), and the same bound failing
  the CPU test's planted fault (x's scale off by 1/64); a shape it cannot
  take raises FP8ShapeError.
* a tiny quantized Llama's captured TrainStep: every frozen linear claimed
  by its kernel, the kernels launched, frozen tensors bit-equal, losses
  finite and falling.
* the frozen linears' f32 route (``split``) at quant_train's two shapes
  (int8 fc_1, NF4 mlp.proj, 512 rows): within chip_smoke.py's
  KERNEL_TOL["float32"] of the plain version, a rerun bit-equal, and each
  launch counted on the split route.
"""
import numpy as np
import pytest
import torch

import thunder_tpu_torch as tt
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.training import TrainStep
from thunder_tpu_torch.transforms.quantization import QuantizeInt8Transform, QuantizeNF4Transform

B, T, STEPS = 2, 32, 3
TOL = 1e-5
ADAMW = dict(lr=1e-3, eps=0.1)


def _is_int8(name, mod):
    return name.endswith(("mlp.fc_1", "mlp.fc_2"))


def _is_nf4(name, mod):
    return name.endswith("mlp.proj")


def _int8_exact(params: dict, suffixes=("mlp.fc_1.weight", "mlp.fc_2.weight"), seed: int = 0) -> dict:
    """Every weight named with one of ``suffixes`` as q · 2^-9, integer q
    in [-126, 126] and q[:, 0] = 127: int8 quantization recovers q and the
    scale 2^-9."""
    rng = np.random.RandomState(seed)
    out = dict(params)
    for k, v in params.items():
        if k.endswith(suffixes):
            q = rng.randint(-126, 127, v.shape)
            q[:, 0] = 127
            out[k] = (q * 2.0 ** -9).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def quant_runs():
    import jax.numpy as jnp

    import thunder_tpu as tj
    from thunder_tpu import optim as jopt
    from thunder_tpu.models import litgpt as jlg
    from thunder_tpu.training import TrainStep as JTrainStep
    from thunder_tpu.transforms.quantization import (QuantizeInt8Transform as JInt8,
                                                     QuantizeNF4Transform as JNF4)

    jm = jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2", intermediate_size=512, n_layer=2))
    start = _int8_exact({k: np.asarray(p.data) for k, p in jm.named_parameters()})
    for k, p in jm.named_parameters():
        p.data = jnp.asarray(start[k])
    cfg = tlg.Config.from_name("tiny-llama2", intermediate_size=512, n_layer=2)
    tm = tlg.GPTForCausalLM(cfg, device="cpu")
    tlg.load_jax_params(tm, start)
    rng = np.random.RandomState(0)
    idx = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    tgt = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    js = JTrainStep(tj.jit(jm, transforms=[JInt8(target_predicate=_is_int8), JNF4(target_predicate=_is_nf4)]),
                    jopt.AdamW(**ADAMW))
    ts = TrainStep(tt.jit(tm, transforms=[QuantizeInt8Transform(target_predicate=_is_int8),
                                          QuantizeNF4Transform(target_predicate=_is_nf4)]),
                   topt.AdamW(**ADAMW))
    frozen0 = {k: p.detach().clone() for k, p in tm.named_parameters() if not p.requires_grad}
    jl = [float(js(jnp.asarray(idx), jnp.asarray(tgt))) for _ in range(STEPS)]
    tl_ = [float(ts(torch.tensor(idx), torch.tensor(tgt))) for _ in range(STEPS)]
    jp = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    tp = {k: p.detach() for k, p in tm.named_parameters()}
    return dict(jl=np.array(jl), tl=np.array(tl_), jp=jp, tp=tp, frozen0=frozen0, step=ts, cfg=cfg, start=start)


def test_quantized_train_losses_match_thunder_tpu(quant_runs):
    r = quant_runs
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=TOL, atol=0)
    assert r["tl"][-1] < r["tl"][0]


def test_quantized_train_params_match_thunder_tpu(quant_runs):
    r = quant_runs
    assert set(r["tp"]) == set(r["jp"])
    trainable = [k for k in r["tp"] if k not in r["frozen0"]]
    assert len(trainable) == 3 + 4 * r["cfg"].n_layer  # wte, ln_f, lm_head; norms, qkv, attn proj
    for k in trainable:
        np.testing.assert_allclose(r["tp"][k].numpy(), r["jp"][k], rtol=0, atol=TOL, err_msg=k)
        assert np.abs(r["tp"][k].numpy() - r["start"][k]).max() > 5 * TOL, k


def test_frozen_tensors_bit_equal_to_thunder_tpu_and_their_start(quant_runs):
    r = quant_runs
    kinds = {k.rsplit(".", 1)[-1] for k in r["frozen0"]}
    assert kinds == {"weight", "scale", "absmax"}
    assert len(r["frozen0"]) == 6 * r["cfg"].n_layer  # fc_1, fc_2: weight + scale; proj: weight + absmax
    for k, v in r["frozen0"].items():
        assert torch.equal(r["tp"][k], v), k
        assert np.array_equal(r["tp"][k].numpy(), r["jp"][k]), k


def test_quantized_step_records_the_frozen_linears_and_their_rules(quant_runs):
    ts, cfg = quant_runs["step"], quant_runs["cfg"]
    fwd = [b for b in tt.last_traces(ts)[-1].bound_symbols if str(b.sym.id).startswith("quant.")]
    assert [b.sym.id for b in fwd].count("quant.linear_int8") == 2 * cfg.n_layer
    assert [b.sym.id for b in fwd].count("quant.linear_nf4_kl") == cfg.n_layer
    impls = {b.sym.id: b.impl for b in fwd}
    assert impls == {"quant.linear_int8": cudaex._int8_linear_impl, "quant.linear_nf4_kl": cudaex._nf4_kl_impl}
    bwd = tt.last_backward_traces(ts)[-1].bound_symbols
    assert sum(b.sym.id == "quant.nf4_dequant_kl" for b in bwd) == cfg.n_layer


@pytest.mark.parametrize("kind", ["int8", "nf4", "nf4_kernel_layout"])
def test_frozen_linear_input_gradient_rounds_as_thunder_tpus(kind):
    import jax.numpy as jnp

    from thunder_tpu.ops import ltorch as jlt
    from thunder_tpu.transforms import quantization as jq
    from thunder_tpu.transforms.autodiff import ThunderValueAndGrad as JVAG
    from thunder_tpu_torch.ops import ltorch
    from thunder_tpu_torch.transforms import quantization as tq

    out_f, in_f = (128, 256) if kind == "nf4_kernel_layout" else (96, 192)
    rng = np.random.RandomState(4)
    w = (rng.randn(out_f, in_f) * 0.05).astype(np.float32)
    x = rng.randn(16, in_f).astype(np.float32)
    r = rng.randn(16, out_f).astype(np.float32)
    if kind == "int8":
        jargs, targs = jq.quantize_int8(jnp.asarray(w)), tq.quantize_int8(torch.tensor(w))
        jsym, tsym = jq.quantized_linear, tq.quantized_linear
    else:
        jargs, targs = jq.quantize_nf4(jnp.asarray(w)), tq.quantize_nf4(torch.tensor(w))
        jsym, tsym = jq.nf4_linear, tq.nf4_linear
        if kind == "nf4_kernel_layout":
            from thunder_tpu.executors.pallasex import pack_nf4_kernel_layout

            jargs = pack_nf4_kernel_layout(*jargs, (out_f, in_f))
            targs = tq.pack_nf4_kernel_layout(*targs, (out_f, in_f))
            jsym, tsym = jq.nf4_linear_kl, tq.nf4_linear_kl
        jargs, targs = (*jargs, out_f, in_f, 64), (*targs, out_f, in_f, 64)
    for a, b in zip(jargs, targs):
        assert np.array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)
    _, jg = JVAG(lambda x, r, *q: jlt.sum(jlt.mul(jsym(x, *q), r)), argnums=0)(
        jnp.asarray(x), jnp.asarray(r), *jargs)
    _, tg = tt.value_and_grad(lambda x, r, *q: ltorch.sum(ltorch.mul(tsym(x, *q), r)), argnums=0)(
        torch.tensor(x), torch.tensor(r), *targs)
    got, want = tg[0][0].numpy(), np.asarray(jg[0][0])
    apart = got != want
    assert apart.mean() <= 0.01
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want)[apart] <= ulp[apart]).all()
    # the unrounded f32 product r · W, W as the forward dequantizes it
    w_deq = tsym(torch.eye(in_f), *targs).t() if kind != "int8" else \
        targs[0].float() * targs[1][:, None]
    unrounded = (torch.tensor(r) @ w_deq.float()).numpy()
    assert (got != unrounded).mean() > 0.1


class _Head(torch.nn.Module):
    """thunder_tpu's test _Net (64 -> 32 -> 8) under an MSE loss."""

    def __init__(self):
        from thunder_tpu_torch import nn

        super().__init__()
        self.fc1 = nn.Linear(64, 32, device="cpu")
        self.fc2 = nn.Linear(32, 8, device="cpu")

    def forward(self, x, y):
        from thunder_tpu_torch.ops import ltorch

        return ltorch.mse_loss(self.fc2(ltorch.relu(self.fc1(x))), y)


def test_quantized_bias_trains_as_thunder_tpus():
    import jax.numpy as jnp

    import thunder_tpu as tj
    from thunder_tpu import nn as jnn, optim as jopt
    from thunder_tpu.ops import ltorch as jlt
    from thunder_tpu.training import TrainStep as JTrainStep
    from thunder_tpu.transforms.quantization import QuantizeInt8Transform as JInt8

    class JHead(jnn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(64, 32, seed=1)
            self.fc2 = jnn.Linear(32, 8, seed=2)

        def forward(self, x, y):
            return jlt.mse_loss(self.fc2(jlt.relu(self.fc1(x))), y)

    jnet, tnet = JHead(), _Head()
    start = _int8_exact({k: np.asarray(p.data) for k, p in jnet.named_parameters()}, ("fc2.weight",))
    for k, p in jnet.named_parameters():
        p.data = jnp.asarray(start[k])
    with torch.no_grad():
        for k, p in tnet.named_parameters():
            p.copy_(torch.tensor(start[k]))
    pick = lambda n, m: n.endswith("fc2")  # noqa: E731
    js = JTrainStep(tj.jit(jnet, transforms=[JInt8(target_predicate=pick)]), jopt.AdamW(lr=0.05))
    ts = TrainStep(tt.jit(tnet, transforms=[QuantizeInt8Transform(target_predicate=pick)]), topt.AdamW(lr=0.05))
    rng = np.random.RandomState(0)
    x, y = rng.rand(8, 64).astype(np.float32), rng.rand(8, 8).astype(np.float32)
    for _ in range(STEPS):
        jloss = float(js(jnp.asarray(x), jnp.asarray(y)))
        tloss = float(ts(torch.tensor(x), torch.tensor(y)))
        assert abs(tloss - jloss) <= TOL * abs(jloss)
    b_after = tnet.fc2.bias.detach().numpy()
    assert np.abs(b_after - start["fc2.bias"]).max() > 1e-5, "bias froze under quantization"
    np.testing.assert_allclose(b_after, np.asarray(dict(jnet.named_parameters())["fc2.bias"].data),
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(64, 256, 256), (4096, 2048, 8192), (7, 128256, 2048)])
def test_card_fp8_scaled_mm_route_matches_plain(cuda, M, N, K):
    import chip_smoke
    from thunder_tpu_torch.transforms import fp8_inference as f8

    g = torch.Generator(device=cuda).manual_seed(M)
    x = (torch.randn(M, K, device=cuda, generator=g) * 3).to(torch.bfloat16)
    q, s = f8.quantize_fp8_weight(torch.randn(N, K, device=cuda, generator=g) * 0.02)
    n0 = f8.SCALED_MM_CALLS["scaled_mm"]
    y = f8.fp8_linear_impl(x, q, s)
    torch.cuda.synchronize()
    assert f8.SCALED_MM_CALLS["scaled_mm"] == n0 + 1
    # the card's route against the written-out plain version, on the card;
    # the CPU's route (the f32 product of the codes) on the CPU
    assert chip_smoke.fp8_inference_err(x, q, s, None, y) <= 1.0
    y_cpu = f8.fp8_linear_impl(x.cpu(), q.cpu(), s.cpu())
    assert chip_smoke.fp8_inference_err(x.cpu(), q.cpu(), s.cpu(), None, y_cpu) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(64, 256, 256), (4096, 2048, 8192), (7, 128256, 2048)])
def test_card_fp8_bound_catches_a_wrong_x_scale(cuda, M, N, K, monkeypatch):
    """The card's bound, widened by FP8_MMA_EPS for the tensor cores' sums,
    still fails the planted fault of the CPU test
    (test_chip_smoke_fp8_bound_holds_and_catches_a_wrong_x_scale): x's
    scale off by 1/64 changes its codes."""
    import chip_smoke
    from thunder_tpu_torch.transforms import fp8_inference as f8

    g = torch.Generator(device=cuda).manual_seed(M)
    x = (torch.randn(M, K, device=cuda, generator=g) * 3).to(torch.bfloat16)
    q, s = f8.quantize_fp8_weight(torch.randn(N, K, device=cuda, generator=g) * 0.02)
    assert chip_smoke.fp8_inference_err(x, q, s, None, f8.fp8_linear_impl(x, q, s)) <= 1.0
    monkeypatch.setattr(f8, "E4M3_MAX", f8.E4M3_MAX * (1 + 1 / 64))
    assert chip_smoke.fp8_inference_err(x, q, s, None, f8.fp8_linear_impl(x, q, s)) > 1.0


@pytest.mark.gpu
def test_card_fp8_refuses_a_shape_scaled_mm_cannot_take(cuda):
    from thunder_tpu_torch.transforms import fp8_inference as f8

    x = torch.randn(8, 40, device=cuda, dtype=torch.bfloat16)
    q, s = f8.quantize_fp8_weight(torch.randn(64, 40, device=cuda))
    with pytest.raises(f8.FP8ShapeError, match="multiples of 16"):
        f8.fp8_linear_impl(x, q, s)


@pytest.mark.gpu
def test_card_quantized_train_step_claims_and_launches_the_kernels(cuda):
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    cfg = tlg.Config.from_name("tiny-llama2", intermediate_size=512)
    model = tlg.GPTForCausalLM(cfg, device=cuda)
    step = TrainStep(tt.jit(model, transforms=[QuantizeInt8Transform(target_predicate=_is_int8),
                                               QuantizeNF4Transform(target_predicate=_is_nf4),
                                               AutocastTransform()]), topt.AdamW(lr=1e-3))
    frozen0 = {k: p.detach().clone() for k, p in model.named_parameters() if not p.requires_grad}
    rng = np.random.RandomState(0)
    idx, tgt = (torch.tensor(rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32), device=cuda)
                for _ in range(2))
    losses = [float(step(idx, tgt)) for _ in range(2)]  # op by op, then the capture
    n0 = (cudaex.int8_linear.launches, cudaex.nf4_linear.launches)
    losses += [float(step(idx, tgt)) for _ in range(3)]  # replays
    assert (cudaex.int8_linear.launches - n0[0], cudaex.nf4_linear.launches - n0[1]) == \
        (3 * 2 * cfg.n_layer, 3 * cfg.n_layer)
    assert tt.graph_captures(step) == 1 and tt.graph_replays(step) == 4  # the capturing call replays too
    fwd = [b for b in tt.last_traces(step)[-1].bound_symbols if str(b.sym.id).startswith("quant.")]
    assert {b.sym.id: b.impl for b in fwd} == {"quant.linear_int8": cudaex._int8_linear_impl,
                                               "quant.linear_nf4_kl": cudaex._nf4_kl_impl}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    now = dict(model.named_parameters())
    assert all(torch.equal(now[k], v) for k, v in frozen0.items())


@pytest.mark.gpu
@pytest.mark.parametrize("kind,N,K", [("int8", 8192, 2048), ("nf4", 2048, 8192)], ids=["int8-fc_1", "nf4-mlp_proj"])
def test_card_split_route_at_quant_train_shapes(cuda, kind, N, K):
    import chip_smoke

    M = chip_smoke.QUANT_TRAIN_B * chip_smoke.QUANT_TRAIN_T
    g = torch.Generator(device=cuda).manual_seed(N + K)
    if kind == "int8":
        fn, plain, args = cudaex.int8_linear, cudaex.int8_linear_plain, chip_smoke.int8_inputs(
            cuda, g, torch.float32, M, N, K)
    else:
        fn, plain, args = cudaex.nf4_linear, cudaex.nf4_linear_plain, chip_smoke.nf4_inputs(
            cuda, g, torch.float32, M, N, K, True)
    assert cudaex.weight_only_plan(kind, M, N, K, torch.float32)["route"] == "split"
    n0 = fn.routes["split"]
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    assert fn.routes["split"] == n0 + 2 and first.dtype == torch.float32
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    torch.backends.cuda.matmul.allow_tf32 = False
    assert chip_smoke.flash_err(first, plain(*args))[1] <= chip_smoke.KERNEL_TOL["float32"]

