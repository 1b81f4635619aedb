"""The port's torch frontend (thunder_tpu_torch/interop/torch_frontend.py)
against thunder_tpu's (thunder_tpu/interop/torch_frontend.py) and torch eager.

The same torch module, its inputs made with numpy from a seed, goes through
thunder_tpu's ``compile_torch_module`` (jax arrays, on the CPU) and the
port's (CPU tensors); both are held to the module run eagerly in torch.
thunder_tpu's own frontend tests are tests/test_torch_frontend.py; the cases
here are theirs, run on both packages: the MLP, the causal attention block,
the CNN with pooling and norms, the losses and unary surface, in-place
methods done functionally, ``__setitem__`` and buffer writes (which land on
the torch module), metadata, the unmapped-op fallback, the refusals, the fft
route into the auto catalog; then ``value_and_grad`` against thunder_tpu's
``TorchModuleValueAndGrad`` and torch autograd, the six HF_COVERAGE.md models
(with ``transformers``, which the card's machine lacks), ``compile`` and its
recipes and plugins, the route ``jit`` takes for each port model, and
chip_smoke.py's TorchLlama against the port-native model on the same
weights.

Tolerances, f32: outputs within 1e-5 * max(1, |ref|); gradients within 1e-4
of each tensor's largest reference magnitude; the HF models within 1e-4
(logits, absolute; gradients, of each tensor's largest). thunder_tpu runs
its integer results in int32 where torch gives int64: values are compared.

A planted fault (F.softmax mapped over the wrong dim) fails the bound."""
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

import jax.numpy as jnp

import thunder_tpu as jt
import thunder_tpu_torch as pt
from thunder_tpu.interop import torch_frontend as jtf
from thunder_tpu_torch.interop import torch_frontend as ptf

ROOT = Path(__file__).resolve().parents[1]
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
HF_TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def assert_fwd(got, want, what="", rtol=FWD_RTOL):
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}"
    err = np.abs(g - w)
    bound = rtol * np.maximum(1.0, np.abs(w))
    assert np.all(err <= bound), f"{what}: max err {err.max()}"


def assert_grad(got, want, what="", rtol=GRAD_RTOL, floor=1e-30):
    """Within rtol of the reference tensor's largest magnitude, or of
    ``floor`` where that is smaller (a gradient that is 0 but for rounding,
    such as a key projection's bias: softmax ignores a constant shift)."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}"
    scale = max(float(np.max(np.abs(w))), floor) if w.size else 1.0
    assert float(np.max(np.abs(g - w), initial=0.0)) <= rtol * scale, what


def _three(module, *arrays, jax_module=None, **kwargs):
    """(torch eager, thunder_tpu, port) outputs of ``module`` on numpy
    ``arrays`` (and static kwargs)."""
    module = module.eval()
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    with torch.no_grad():
        eager = module(*ts, **kwargs)
    jout = jtf.compile_torch_module(jax_module or module)(*[jnp.asarray(a) for a in arrays], **kwargs)
    pout = ptf.compile_torch_module(module)(*ts, **kwargs)
    return eager, jout, pout


def _check_three(module, *arrays, what="", **kwargs):
    eager, jout, pout = _three(module, *arrays, **kwargs)
    assert_fwd(pout, eager, f"{what} port vs eager")
    assert_fwd(pout, np.asarray(jout), f"{what} port vs thunder_tpu")
    assert_fwd(np.asarray(jout), eager, f"{what} thunder_tpu vs eager", rtol=10 * FWD_RTOL)
    return pout


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# thunder_tpu's frontend cases, on both packages
# ---------------------------------------------------------------------------


class MLP(tnn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(8, 32)
        self.ln = tnn.LayerNorm(32)
        self.fc2 = tnn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(self.ln(F.gelu(self.fc1(x))))


class Block(tnn.Module):
    def __init__(self, d=32, h=4):
        super().__init__()
        self.h = h
        self.qkv = tnn.Linear(d, 3 * d)
        self.proj = tnn.Linear(d, d)
        self.ln = tnn.LayerNorm(d)

    def forward(self, x):
        B, T, C = x.shape
        q, k, v = self.qkv(self.ln(x)).chunk(3, dim=-1)
        q = q.view(B, T, self.h, C // self.h).transpose(1, 2)
        k = k.view(B, T, self.h, C // self.h).transpose(1, 2)
        v = v.view(B, T, self.h, C // self.h).transpose(1, 2)
        y = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        y = y.transpose(1, 2).reshape(B, T, C)
        return x + self.proj(y)


class Net(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2d(3, 8, 3, padding=1)
        self.bn = tnn.BatchNorm2d(8)
        self.fc = tnn.Linear(8, 10)

    def forward(self, x):
        h = F.hardswish(self.bn(self.conv(x)))
        h = F.max_pool2d(h, 2)
        h = F.adaptive_avg_pool2d(h, (1, 1)).flatten(1)
        return F.log_softmax(self.fc(h), dim=-1)


class Losses(tnn.Module):
    def forward(self, x, y):
        return F.huber_loss(torch.log1p(torch.exp2(x).clamp_min(0.1)), y) + torch.logaddexp(x, y).sum()


def test_mlp(rng):
    torch.manual_seed(0)
    _check_three(MLP(), _f(rng, 5, 8), what="mlp")


def test_causal_attention_block(rng):
    torch.manual_seed(1)
    _check_three(Block(), _f(rng, 2, 16, 32), what="attention")


def test_cnn_with_pooling_and_norms(rng):
    torch.manual_seed(2)
    net = Net()
    with torch.no_grad():  # running stats away from their init, so eval mode reads them
        net.bn.running_mean.uniform_(-0.5, 0.5)
        net.bn.running_var.uniform_(0.5, 1.5)
    _check_three(net, _f(rng, 2, 3, 16, 16), what="cnn")


def test_losses_and_unary_surface(rng):
    _check_three(Losses(), _f(rng, 4, 6), _f(rng, 4, 6), what="losses")


def test_fft_routes_to_the_auto_catalog(rng):
    class Weird(tnn.Module):
        def forward(self, x):
            return torch.fft.fft(x).real

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _check_three(Weird(), _f(rng, 8), what="fft")
    assert not any("no mapping" in str(m.message) for m in w)
    fn = ptf.compile_torch_module(Weird())
    fn(torch.from_numpy(_f(rng, 8)))
    assert any(b.sym.id == "auto.fft_fft" for b in pt.last_traces(fn)[0].bound_symbols)


def test_inplace_methods_done_functionally(rng):
    class InplaceNet(tnn.Module):
        def __init__(self):
            super().__init__()
            self.lin = tnn.Linear(8, 8)

        def forward(self, x):
            h = self.lin(x).clone()
            h.relu_()
            h.mul_(2.0)
            h.add_(1.0)
            return h.sum()

    torch.manual_seed(3)
    _check_three(InplaceNet(), _f(rng, 4, 8), what="inplace")


def test_setitem_and_buffer_writes_land_on_the_torch_module():
    class Masked(tnn.Module):
        def forward(self, x):
            y = x.clone()
            y[y > 1] = 0.0
            y[0:1] = 5.0
            return y.sum()

    _check_three(Masked(), np.arange(4.0, dtype=np.float32), what="setitem")

    class Counter(tnn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("step", torch.zeros(()))
            self.inner = tnn.Module()
            self.inner.register_buffer("seen", torch.zeros(3))

        def forward(self, x):
            self.step.add_(1.0)
            self.inner.seen.add_(x)
            return x.sum() + self.step

    m = Counter()
    cm = ptf.compile_torch_module(m)
    xs = torch.ones(3)
    assert [float(cm(xs)) for _ in range(3)] == [4.0, 5.0, 6.0]
    # the writes landed on the module's own buffers (thunder_tpu keeps them
    # in its copies)
    assert float(m.step) == 3.0 and torch.equal(m.inner.seen, torch.full((3,), 3.0))
    jm = jtf.compile_torch_module(Counter())
    assert [float(jm(jnp.ones((3,), jnp.float32))) for _ in range(3)] == [4.0, 5.0, 6.0]

    class MF(tnn.Module):
        def forward(self, x):
            y = x.clone()
            y.masked_fill_(y > 1, 0.0)  # statement form: the effect must persist
            return y.sum()

    _check_three(MF(), np.arange(4.0, dtype=np.float32), what="masked_fill_")

    class DtypeChange(tnn.Module):
        def forward(self, x):
            y = x.clone()
            y.div_(2)  # an int receiver: torch refuses; nothing is cast quietly
            return y.sum()

    with pytest.raises(NotImplementedError, match="dtype"):
        ptf.compile_torch_module(DtypeChange())(torch.arange(4))


def test_masked_setitem_element_placement():
    class Place(tnn.Module):
        def forward(self, x, v):
            y = x.clone()
            y[y > 0] = v
            return y

    x = np.array([[-1.0, 2.0], [3.0, -4.0]], np.float32)
    _check_three(Place(), x, np.array([10.0, 20.0], np.float32), what="place")

    class Fill1(tnn.Module):
        def forward(self, x):
            y = x.clone()
            y[y > 0] = torch.full((1, 1), 5.0)
            return y

    _check_three(Fill1(), x, what="fill1")
    with pytest.raises(NotImplementedError, match="element placement|1-D"):
        ptf.compile_torch_module(Place())(torch.from_numpy(x), torch.ones(2, 2))


def test_tensor_metadata_and_the_proxys_device():
    class Meta(tnn.Module):
        def forward(self, x):
            assert x.ndimension() == 2 and x.nelement() == 6
            assert x.element_size() == 4 and x.is_signed()
            assert not x.is_conj() and x.is_contiguous()
            assert x.is_same_size(x)
            # the port answers with the proxy's own device (thunder_tpu: the CPU always)
            assert x.device == torch.device("cpu") and not x.is_cuda and x.get_device() == -1
            assert x.dtype == torch.float32 and x.shape == (2, 3)
            y = x.cpu().to_dense()
            return y.sum() * x.dim() + torch.arange(3, device=x.device).sum()

    _check_three(Meta(), np.ones((2, 3), np.float32), what="meta")


def test_a_program_runs_on_one_device():
    """Nothing moves between devices on its own: a concrete tensor on another
    device, a factory or a ``.to()`` naming another device raise."""

    class HoldsMeta(tnn.Module):
        def __init__(self):
            super().__init__()
            self.scale = torch.ones(3, device="meta")  # a plain attribute: a trace constant

        def forward(self, x):
            return x * self.scale

    class Factory(tnn.Module):
        def forward(self, x):
            return x + torch.zeros(3, device="meta")

    class To(tnn.Module):
        def forward(self, x):
            return x.to("meta")

    for m in (HoldsMeta(), Factory(), To()):
        with pytest.raises(NotImplementedError, match="one device"):
            ptf.compile_torch_module(m)(torch.ones(3))


def test_unmapped_op_fallback_warns_once_and_matches(rng):
    """torch.lerp with its catalog entry taken away: the opaque
    torch_eager op in the port (jax.pure_callback on the host in
    thunder_tpu); one warning a function; values against eager, gradients
    against thunder_tpu's and torch autograd."""
    from thunder_tpu.ops import auto_register as jar
    from thunder_tpu_torch.ops import auto_register as par

    class Exotic(tnn.Module):
        def __init__(self):
            super().__init__()
            self.lin = tnn.Linear(8, 8)

        def forward(self, x):
            return torch.lerp(self.lin(x), torch.ones(8, 8), 0.25).sum()

    saved = (jar._auto_symbols.pop("auto.lerp"), par._auto_symbols.pop("auto.lerp"))
    for tf in (jtf, ptf):
        tf._eager_symbols.pop(torch.lerp, None)
        tf._eager_warned.discard(torch.lerp)
    try:
        torch.manual_seed(4)
        m = Exotic()
        x = _f(rng, 8, 8)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            cm = ptf.compile_torch_module(m)
            out = cm(torch.from_numpy(x))
            cm(torch.from_numpy(2 * x))
            ptf.compile_torch_module(m)(torch.from_numpy(x))
        msgs = [str(x.message) for x in w if "torch.lerp" in str(x.message)]
        assert len(msgs) == 1 and "torch_eager.torch.lerp" in msgs[0]
        assert any(str(b.sym.id) == "torch_eager.torch.lerp" for b in pt.last_traces(cm)[0].bound_symbols)
        xt = torch.from_numpy(x.copy())
        ref = m(xt)
        assert_fwd(out, ref.detach())
        ref.backward()
        _, pg = pt.value_and_grad(cm)(torch.from_numpy(x))
        _, jg = jt.value_and_grad(jtf.compile_torch_module(m))(jnp.asarray(x))
        for k, p in m.named_parameters():
            assert_grad(pg[k], p.grad, k)
            assert_grad(pg[k], np.asarray(jg[k]), k)
    finally:
        jar._auto_symbols["auto.lerp"], par._auto_symbols["auto.lerp"] = saved
        for tf in (jtf, ptf):
            tf._eager_symbols.pop(torch.lerp, None)


def test_refusals():
    """Unmapped in-place ops, in-place RNG samplers, ``out=`` on an opaque
    op, training-mode dropout and a TraceTensor outside a trace raise."""
    from thunder_tpu_torch.core.proxies import TensorProxy
    from thunder_tpu_torch.core import dtypes

    class UnmappedInplace(tnn.Module):
        def forward(self, x):
            y = x.clone()
            y.lerp_(torch.ones(4), 0.5)
            return y

    class Rng(tnn.Module):
        def forward(self, x):
            y = x.clone()
            y.exponential_()
            return y.sum()

    class Out(tnn.Module):
        def forward(self, x):
            return torch.logcumsumexp(x, 0, out=torch.empty(4))

    class Dropout(tnn.Module):
        def forward(self, x):
            return F.dropout(x, 0.5, training=True)

    for m, match in ((UnmappedInplace(), "in-place op lerp_"), (Rng(), "RNG sampler"),
                     (Out(), "out="), (Dropout(), "dropout")):
        with pytest.raises(NotImplementedError, match=match):
            ptf.compile_torch_module(m)(torch.ones(4))
    t = ptf.TraceTensor(TensorProxy("p", shape=(2,), dtype=dtypes.float32, device=pt.devices.cpu))
    with pytest.raises(RuntimeError, match="outside a trace"):
        t + 1


def test_live_parameters_views_and_structured_inputs():
    """Parameters are read live (an in-place update shows without a
    recompile); keyword, NamedTuple, list and dict inputs are walked; views
    of one storage are one input; a train/eval flip retraces."""
    from collections import namedtuple

    Pair = namedtuple("Pair", "a b")

    class M(tnn.Module):
        def __init__(self):
            super().__init__()
            self.lin = tnn.Linear(3, 3)

        def forward(self, pair, xs, d, *, scale):
            return self.lin(pair.a + pair.b) * scale + xs[0] + d["k"]

    torch.manual_seed(5)
    m = M()
    cm = ptf.compile_torch_module(m)
    a = torch.ones(2, 3)
    args = (Pair(a, a), [a], {"k": a})
    first = cm(*args, scale=2.0)
    assert torch.allclose(first, m(*args, scale=2.0))
    with torch.no_grad():
        m.lin.weight.add_(1.0)
    assert torch.allclose(cm(*args, scale=2.0), m(*args, scale=2.0))
    assert pt.cache_misses(cm) == 1
    # two views of one storage are one input; other views another program
    assert ptf.same_views(((a, a.view(2, 3)),))[0][1] is a
    b = torch.ones(2, 3)
    cm(Pair(a, b), [a], {"k": b}, scale=2.0)
    assert pt.cache_misses(cm) == 2
    m.train()
    cm(*args, scale=2.0)
    assert pt.cache_misses(cm) == 3


def test_planted_fault_wrong_softmax_dim_fails_the_bound(rng, monkeypatch):
    """Ground rule 7: F.softmax mapped over the wrong dim breaks the bound."""

    class S(tnn.Module):
        def forward(self, x):
            return F.softmax(x, dim=-1)

    x = _f(rng, 3, 4)
    _check_three(S(), x, what="softmax")
    monkeypatch.setitem(ptf._EXPLICIT, F.softmax,
                        lambda x, dim=None, _stacklevel=3, *, dtype=None: ptf.ltorch.softmax(x, 0))
    with pytest.raises(AssertionError, match="port vs eager"):
        _check_three(S(), x, what="softmax")


# ---------------------------------------------------------------------------
# value_and_grad over a CompiledTorchModule
# ---------------------------------------------------------------------------


class LossMLP(tnn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = MLP()
        self.frozen = tnn.Linear(4, 4)
        self.frozen.requires_grad_(False)

    def forward(self, x, y):
        return ((self.frozen(self.mlp(x)) - y) ** 2).mean()


def test_value_and_grad_against_thunder_tpu_and_torch_autograd(rng):
    torch.manual_seed(6)
    m = LossMLP()
    x, y = _f(rng, 5, 8), _f(rng, 5, 4)
    loss, grads = pt.value_and_grad(ptf.compile_torch_module(m))(torch.from_numpy(x), torch.from_numpy(y))
    assert type(pt.value_and_grad(ptf.compile_torch_module(m))).__name__ == "TorchModuleValueAndGrad"
    jloss, jgrads = jt.value_and_grad(jtf.compile_torch_module(m))(jnp.asarray(x), jnp.asarray(y))
    ref = m(torch.from_numpy(x), torch.from_numpy(y))
    ref.backward()
    trainable = {k for k, p in m.named_parameters() if p.requires_grad}
    assert set(grads) == trainable
    assert_fwd(loss, ref.detach())
    assert_fwd(loss, float(jloss))
    for k in trainable:
        assert_grad(grads[k], dict(m.named_parameters())[k].grad, k)
        assert_grad(grads[k], np.asarray(jgrads[k]), k)


# ---------------------------------------------------------------------------
# HuggingFace models (HF_COVERAGE.md's six), recipes and plugins
# ---------------------------------------------------------------------------

HF_MODELS = ("gpt2", "llama", "mistral", "qwen2", "gemma", "bert")


@pytest.mark.parametrize("name", HF_MODELS)
def test_hf_model_forward_and_backward(name):
    pytest.importorskip("transformers")
    from transformers import AutoModelForCausalLM, AutoModelForMaskedLM

    from thunder_tpu.benchmarks.hf_coverage import _configs

    cfg, kind = _configs()[name]
    torch.manual_seed(0)
    cls = AutoModelForCausalLM if kind == "causal" else AutoModelForMaskedLM
    model = cls.from_config(cfg).eval()
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16)))
    # hf_coverage's inputs: masked models an all-ones mask, causal ones none
    kw = {"attention_mask": torch.ones_like(ids)} if kind == "masked" else {}
    with torch.no_grad():
        ref = model(input_ids=ids, **kw).logits
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fn = pt.jit(model)
        out = fn(input_ids=ids, **kw)
    assert isinstance(fn, ptf.CompiledTorchModule)
    assert not [str(m.message) for m in w if "no mapping" in str(m.message)]
    assert_fwd(out["logits"], ref, f"{name} logits", rtol=HF_TOL)
    jout = jtf.compile_torch_module(model)(input_ids=jnp.asarray(ids.numpy()),
                                           **{k: jnp.asarray(v.numpy()) for k, v in kw.items()})
    assert_fwd(out["logits"], np.asarray(jout["logits"]), f"{name} logits vs thunder_tpu", rtol=HF_TOL)

    class LossWrap(tnn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, input_ids, attention_mask=None):
            kw = {"attention_mask": attention_mask} if attention_mask is not None else {}
            return self.inner(input_ids=input_ids, **kw).logits.float().pow(2).mean()

    wrap = LossWrap(model)
    args = (ids, kw["attention_mask"]) if kw else (ids,)
    loss_t = wrap(*args)
    loss_t.backward()
    loss, grads = pt.value_and_grad(pt.jit(wrap))(*args)
    assert_fwd(loss, loss_t.detach(), f"{name} loss", rtol=HF_TOL)
    # gradients that are 0 but for rounding are held to 1e-6 of the
    # model's largest gradient instead of their own
    floor = 1e-6 * max(float(p.grad.abs().max()) for p in wrap.parameters() if p.grad is not None)
    for k, p in wrap.named_parameters():
        if p.grad is not None:
            assert_grad(grads[k], p.grad, f"{name} grad {k}", rtol=HF_TOL, floor=floor)


def test_compile_chooses_the_hf_recipe_and_resolves_plugins():
    pytest.importorskip("transformers")
    from transformers import LlamaConfig, LlamaForCausalLM

    from thunder_tpu_torch.plugins import ReduceOverhead, resolve_plugin
    from thunder_tpu_torch.recipes import BaseRecipe, HFTransformers, resolve_recipe

    cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                      num_attention_heads=2, num_key_value_heads=2)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg).eval()
    assert isinstance(resolve_recipe("auto", model), HFTransformers)
    assert isinstance(resolve_recipe(None, MLP()), BaseRecipe)
    assert [e.name for e in BaseRecipe().setup_executors()] == ["cuda", "torch"]
    cm = pt.compile(model)
    assert isinstance(cm, ptf.CompiledTorchModule)
    ids = torch.randint(0, 64, (1, 8))
    with torch.no_grad():
        ref = model(input_ids=ids).logits
    assert_fwd(cm(input_ids=ids)["logits"], ref, "compile", rtol=HF_TOL)
    with pytest.raises(ValueError, match="PreTrainedModel"):
        HFTransformers().apply(MLP())
    # reduce-overhead: CUDA-graph capture (a no-op on CPU tensors)
    assert isinstance(resolve_plugin("reduce-overhead"), ReduceOverhead)
    assert pt.compile(MLP(), plugins="reduce-overhead")._cfn._cuda_graphs is True
    for name in ("ddp", "fsdp", "tp", "cp"):
        with pytest.raises(NotImplementedError, match="A3b"):
            resolve_plugin(name)
    with pytest.raises(ValueError, match="unknown plugin"):
        resolve_plugin("no-such-plugin")
    with pytest.raises(ValueError, match="unknown recipe"):
        resolve_recipe("no-such-recipe", model)


# ---------------------------------------------------------------------------
# which route jit takes
# ---------------------------------------------------------------------------


def _chip_smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def test_port_models_and_wrappers_keep_thunder_module():
    from thunder_tpu_torch.models import litgpt, moe, nanogpt, resnet, vit
    from thunder_tpu_torch.nn.module import ThunderModule
    from thunder_tpu_torch.training import TrainStep
    from thunder_tpu_torch import optim

    cfg = litgpt.Config.from_name("tiny-llama2")
    models = [
        litgpt.GPTForCausalLM(cfg, device="cpu"),
        litgpt.GPT(cfg, device="cpu"),
        nanogpt.NanoGPT(nanogpt.NanoGPTConfig(n_layer=1, n_head=2, n_embd=16, vocab_size=32, block_size=16),
                        device="cpu"),
        moe.MoEGPT(cfg, moe.MoEConfig(n_embd=cfg.n_embd, intermediate_size=32, n_expert=2), device="cpu"),
        vit.ViTForClassification(vit.configs["test"], device="cpu"),
        resnet.ResNet(resnet.ResNetConfig(block="basic", layers=(1, 1), num_classes=4, width=8), device="cpu"),
    ]
    models.append(_chip_smoke().ResNetLoss(models[-1]))
    for m in models:
        assert not pt.uses_torch_frontend(m), type(m).__name__
        assert isinstance(pt.jit(m), ThunderModule), type(m).__name__
    # torch's own layers take the frontend, and TrainStep refuses them (as
    # thunder_tpu's does: TrainStep over the frontend is not a feature)
    assert pt.uses_torch_frontend(MLP()) and pt.uses_torch_frontend(tnn.Sequential(tnn.Linear(2, 2)))
    assert not pt.uses_torch_frontend(tnn.Sequential(tnn.ModuleList()))
    with pytest.raises(TypeError, match="TrainStep expects"):
        TrainStep(LossMLP(), optim.AdamW())
    with pytest.raises(TypeError, match="TrainStep expects"):
        TrainStep(pt.jit(LossMLP()), optim.AdamW())


def test_chip_smoke_torch_llama_is_the_port_models_function(rng):
    """chip_smoke.py's TorchLlama (plain PyTorch) with a port
    GPTForCausalLM's weights: through the frontend its loss and gradients
    equal the port-native model's and torch eager's; SDPA, RMSNorm and the
    cross-entropy are claimed whole and nothing falls back."""
    from thunder_tpu_torch.executors import cudaex
    from thunder_tpu_torch.models.litgpt import Config, GPTForCausalLM

    cs = _chip_smoke()
    cfg = Config.from_name("tiny-llama2")
    port = GPTForCausalLM(cfg, torch.float32, device="cpu", seed=0)
    user = cs.torch_llama_from(port)
    idx = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    fn = pt.jit(user)
    assert isinstance(fn, ptf.CompiledTorchModule)
    loss = fn(idx, tgt)
    assert_fwd(loss, pt.jit(port)(idx, tgt))
    assert_fwd(loss, user(idx, tgt).detach())
    claims = cs.frontend_claims(cudaex, pt.last_traces(fn)[-1])
    assert claims == {"claims": {"sdpa": cfg.n_layer, "rms_norm": 2 * cfg.n_layer + 1, "cross_entropy": 1},
                      "torch_eager": []}
    _, grads = pt.value_and_grad(fn)(idx, tgt)
    _, native = pt.value_and_grad(pt.jit(port))(idx, tgt)
    ref = user(idx, tgt)
    ref.backward()
    for k, p in user.named_parameters():
        assert_grad(grads[k], p.grad, k)
        assert_grad(grads[k], native[k], k)
