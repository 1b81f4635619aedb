"""The port's vision slice against thunder_tpu's, on the CPU: the vision ops
of ltorch (pooling, conv3d and the transposed convs, batch, group and
instance norms), ViT and ResNet.

Inputs come from a numpy seed; thunder_tpu's weights (and BatchNorm running
stats) are carried across by ``load_jax_params``. f32 both sides, the same
math in another summation order. Bars:

* forward: within 1e-5 · max(1, |ref|), elementwise;
* gradients: within 1e-4 of each tensor's largest;
* parameters and running stats after 3 TrainSteps: within 1e-5, but for
  AdamW's flips (PERF.md §2): where a gradient element is near 0 its sign
  may differ between two summation orders, and each step then moves the
  element by up to 2 lr; such elements (|g| <= 1e-4 of its tensor's largest
  at some step, on either side) are held to 2 lr (1 + 1.0013 + 1.0036), at
  lr 1e-4 6.01e-4.

ViT's ``test`` config (32x32 images, patch 8, dim 64, 2 blocks of 2 heads):
logits, loss, every gradient, and 3 AdamW TrainSteps. The port's flash
checker claims its attention (T = 17, non-causal), which thunder_tpu's
(T >= 1024) does not: the port runs the flash kernels' plain versions where
thunder_tpu runs the composite sdpa. ResNet's ``test`` config (basic
blocks) and tests/test_networks.py's bottleneck variant: the train-mode
forward and its running-stat writes, 3 SGD TrainSteps (torchvision's
recipe: lr 0.1, momentum 0.9, weight decay 1e-4) with the running stats,
then the eval forward on those stats.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu import nn as jnn
from thunder_tpu import optim as jopt
from thunder_tpu.models import resnet as jr
from thunder_tpu.models import vit as jv
from thunder_tpu.ops import ltorch as jl
from thunder_tpu.training import TrainStep as JaxTrainStep
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import resnet as tr
from thunder_tpu_torch.models import vit as tv
from thunder_tpu_torch.ops import ltorch as tl
from thunder_tpu_torch.training import TrainStep

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
LR = 1e-4
NEAR_ZERO = 1e-4
ADAMW_FLIP_TOL = 2 * LR * (1 + 1.0013 + 1.0036)


def _assert_fwd(got, want, what=""):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - FWD_TOL * np.maximum(1.0, np.abs(want))
    assert excess.max() <= 0, f"{what}: worst excess {excess.max()}"


def _assert_grad(got, want, what=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= GRAD_TOL * np.abs(want).max(), f"{what}: {err} of {np.abs(want).max()}"


# ---------------------------------------------------------------------------
# the vision ops of ltorch, forward
# ---------------------------------------------------------------------------


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# name -> (fn(L, *arrays), arrays from rng)
OPS = {
    "max_pool1d": (lambda L, a: L.max_pool1d(a, 3, 2, 1), lambda r: [_f(r, 2, 3, 11)]),
    "max_pool2d": (lambda L, a: L.max_pool2d(a, 3, 2, 1), lambda r: [_f(r, 2, 3, 12, 12)]),
    "max_pool2d_no_stride": (lambda L, a: L.max_pool2d(a, 2), lambda r: [_f(r, 2, 3, 8, 8)]),
    "max_pool3d": (lambda L, a: L.max_pool3d(a, (2, 3, 3), (1, 2, 2), (0, 1, 1)),
                   lambda r: [_f(r, 1, 2, 5, 8, 8)]),
    "avg_pool1d": (lambda L, a: L.avg_pool1d(a, 4, 2, 1), lambda r: [_f(r, 2, 3, 11)]),
    "avg_pool2d": (lambda L, a: L.avg_pool2d(a, 3, 2, 1), lambda r: [_f(r, 2, 3, 12, 12)]),
    "avg_pool2d_exclude_pad": (lambda L, a: L.avg_pool2d(a, 3, 2, 1, count_include_pad=False),
                               lambda r: [_f(r, 2, 3, 12, 12)]),
    "avg_pool3d": (lambda L, a: L.avg_pool3d(a, 2, 2, 0, count_include_pad=False),
                   lambda r: [_f(r, 1, 2, 6, 6, 6)]),
    "adaptive_avg_pool2d": (lambda L, a: L.adaptive_avg_pool2d(a, (1, 1)), lambda r: [_f(r, 2, 8, 7, 7)]),
    "adaptive_avg_pool2d_2x3": (lambda L, a: L.adaptive_avg_pool2d(a, (2, 3)), lambda r: [_f(r, 2, 4, 8, 9)]),
    "adaptive_max_pool2d": (lambda L, a: L.adaptive_max_pool2d(a, 2), lambda r: [_f(r, 2, 4, 8, 8)]),
    "adaptive_avg_pool2d_backward": (lambda L, g, a: L.adaptive_avg_pool2d_backward(g, a),
                                     lambda r: [_f(r, 2, 4, 2, 3), _f(r, 2, 4, 8, 9)]),
    "conv3d": (lambda L, a, w, b: L.conv3d(a, w, b, 2, 1),
               lambda r: [_f(r, 1, 2, 6, 7, 8), _f(r, 4, 2, 3, 3, 3), _f(r, 4)]),
    "conv_transpose1d": (lambda L, a, w, b: L.conv_transpose1d(a, w, b, 2, 1, 1),
                         lambda r: [_f(r, 2, 4, 9), _f(r, 4, 3, 4), _f(r, 3)]),
    "conv_transpose2d": (lambda L, a, w, b: L.conv_transpose2d(a, w, b, 2, 1, 1, 2),
                         lambda r: [_f(r, 2, 4, 5, 6), _f(r, 4, 3, 3, 3), _f(r, 6)]),
    "conv_transpose2d_dilation": (lambda L, a, w: L.conv_transpose2d(a, w, None, 1, 0, 0, 1, 2),
                                  lambda r: [_f(r, 2, 3, 5, 5), _f(r, 3, 2, 3, 3)]),
    "conv_transpose3d": (lambda L, a, w, b: L.conv_transpose3d(a, w, b, (1, 2, 2), 1),
                         lambda r: [_f(r, 1, 2, 4, 5, 5), _f(r, 2, 3, 3, 3, 3), _f(r, 3)]),
    "batch_norm_train": (lambda L, a, w, b: L.batch_norm(a, None, None, w, b, training=True),
                         lambda r: [_f(r, 4, 3, 5, 5) * 2 + 1, _f(r, 3), _f(r, 3)]),
    "batch_norm_eval": (lambda L, a, m, v, w, b: L.batch_norm(a, m, v, w, b, training=False, eps=1e-3),
                        lambda r: [_f(r, 4, 3, 5, 5), _f(r, 3), 1 + r.rand(3).astype(np.float32),
                                   _f(r, 3), _f(r, 3)]),
    "batch_norm_1d": (lambda L, a: L.batch_norm(a, None, None, training=True), lambda r: [_f(r, 6, 4, 7)]),
    "group_norm": (lambda L, a, w, b: L.group_norm(a, 2, w, b), lambda r: [_f(r, 2, 6, 5, 5) * 3, _f(r, 6),
                                                                        _f(r, 6)]),
    "instance_norm": (lambda L, a, w, b: L.instance_norm(a, weight=w, bias=b),
                      lambda r: [_f(r, 2, 3, 6, 6) + 2, _f(r, 3), _f(r, 3)]),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_vision_op_forward_matches_jax(name):
    fn, make = OPS[name]
    arrays = make(np.random.RandomState(sorted(OPS).index(name)))
    want = tj.jit(lambda *a: fn(jl, *a))(*[jnp.asarray(a) for a in arrays])
    got = tt.jit(lambda *a: fn(tl, *a))(*[torch.tensor(a) for a in arrays])
    _assert_fwd(got.numpy(), want, name)


def test_batch_norm_stays_f32_inside_under_bf16():
    """A bf16 input normalizes in f32 and comes back bf16, as thunder_tpu's."""
    a = _f(np.random.RandomState(0), 4, 3, 5, 5)
    got = tt.jit(lambda x: tl.batch_norm(x, None, None, training=True))(torch.tensor(a).to(torch.bfloat16))
    want = tj.jit(lambda x: jl.batch_norm(x, None, None, training=True))(jnp.asarray(a, dtype=jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, dtype=np.float32))


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------


def _vit_pair():
    jm = jv.ViTForClassification(jv.configs["test"])
    tm = tv.ViTForClassification(tv.configs["test"], device="cpu")
    tv.load_jax_params(tm, {k: np.asarray(p.data) for k, p in jm.named_parameters()})
    return jm, tm


def _images(n_batches, B=2, size=32, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, 3, size, size).astype(np.float32), rng.randint(0, classes, (B,)).astype(np.int32))
            for _ in range(n_batches)]


@pytest.fixture(scope="module")
def vit_grads():
    jm, tm = _vit_pair()
    x, y = _images(1)[0]
    jloss, jg = tj.value_and_grad(jm)(jnp.asarray(x), jnp.asarray(y))
    vag = tt.value_and_grad(tm)
    tloss, tg = vag(torch.tensor(x), torch.tensor(y))
    return (float(jloss), {k: np.asarray(v) for k, v in jg.items()}), (float(tloss), tg), vag


def test_vit_param_names_and_shapes_match_jax():
    jm, tm = _vit_pair()
    assert [(k, tuple(p.shape)) for k, p in jm.named_parameters()] == \
        [(k, tuple(p.shape)) for k, p in tm.named_parameters()]
    assert tv.configs["vit-b16"] == tv.ViTConfig(image_size=224, patch_size=16, num_classes=1000, dim=768,
                                                 depth=12, heads=12, mlp_dim=3072)


def test_vit_logits_and_loss_match_jax():
    jm, tm = _vit_pair()
    x, y = _images(1, B=3, seed=1)[0]
    want = tj.jit(jm.vit)(jnp.asarray(x))
    cfn = tt.jit(tm.vit)
    _assert_fwd(cfn(torch.tensor(x)).numpy(), want, "logits")
    claimed = [b for b in tt.last_traces(cfn)[-1].bound_symbols if b.impl is cudaex._sdpa_impl]
    assert len(claimed) == tv.configs["test"].depth  # the flash checker takes T = 17, full
    _assert_fwd(float(tt.jit(tm)(torch.tensor(x), torch.tensor(y))),
                float(tj.jit(jm)(jnp.asarray(x), jnp.asarray(y))), "loss")


def test_vit_gradients_match_jax(vit_grads):
    (jloss, jg), (tloss, tg), vag = vit_grads
    _assert_fwd(tloss, jloss, "loss")
    assert sorted(jg) == sorted(tg)
    for k in jg:
        _assert_grad(tg[k].numpy(), jg[k], k)
    bwd = tt.last_backward_traces(vag)[-1].bound_symbols
    assert sum(b.impl is cudaex._flash_bwd_impl for b in bwd) == tv.configs["test"].depth
    assert sum(b.sym.id == "torch.conv_backward_weight" for b in bwd) == 1


def _flip_prone(grads_by_step: list) -> dict:
    """Elements whose gradient, at some step, is within NEAR_ZERO of its
    tensor's largest."""
    out = {}
    for grads in grads_by_step:
        for k, g in grads.items():
            g = np.abs(np.asarray(g, dtype=np.float32))
            near = g <= NEAR_ZERO * g.max()
            out[k] = near | out.get(k, np.zeros_like(near))
    return out


def _assert_params(tm_state: dict, jm_state: dict, prone: dict | None = None):
    for k, want in jm_state.items():
        got = tm_state[k]
        err = np.abs(got - want)
        if prone is not None and k in prone:
            assert err[prone[k]].max(initial=0.0) <= ADAMW_FLIP_TOL, k
            err = err[~prone[k]]
        assert err.max(initial=0.0) <= PARAM_TOL, f"{k}: {err.max()}"


class _Recorder:
    """The port's optimizer, keeping every step's gradients (thunder_tpu's
    update runs inside its step's jax.jit; the two sides' gradients agree
    to 1e-4 of each tensor's largest, test_vit_gradients_match_jax)."""

    def __init__(self, inner):
        self.inner, self.steps = inner, []

    def init(self, params):
        return self.inner.init(params)

    def update(self, params, grads, state):
        self.steps.append({k: g.detach().numpy().copy() for k, g in grads.items() if g is not None})
        return self.inner.update(params, grads, state)


def test_vit_adamw_train_steps_match_jax():
    jm, tm = _vit_pair()
    batches = _images(3, seed=2)
    rec = _Recorder(topt.AdamW(lr=LR))
    js, ts = JaxTrainStep(tj.jit(jm), jopt.AdamW(lr=LR)), TrainStep(tt.jit(tm), rec)
    jl_ = [float(js(jnp.asarray(x), jnp.asarray(y))) for x, y in batches]
    tl_ = [float(ts(torch.tensor(x), torch.tensor(y))) for x, y in batches]
    _assert_fwd(tl_, jl_, "losses")
    prone = _flip_prone(rec.steps)
    _assert_params({k: p.detach().numpy() for k, p in tm.named_parameters()},
                   {k: np.asarray(p.data) for k, p in jm.named_parameters()}, prone)


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

BOTTLENECK = dict(block="bottleneck", layers=(1, 1), num_classes=4, width=8)  # tests/test_networks.py:126


class _JaxHead(jnn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.body = jr.ResNet(cfg)

    def forward(self, x, y):
        return jl.cross_entropy(self.body(x), y)


class _Head(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.body = tr.ResNet(cfg, device="cpu")

    def forward(self, x, y):
        return tl.cross_entropy(self.body(x), y)


def _resnet_pair(which):
    kw = BOTTLENECK if which == "bottleneck" else jr.configs["test"].__dict__
    jm, tm = _JaxHead(jr.ResNetConfig(**kw)), _Head(tr.ResNetConfig(**kw))
    state = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    state.update((k, np.asarray(b)) for k, b in jm.named_buffers())
    tr.load_jax_params(tm, state)
    return jm, tm


def _state(m, jax_side: bool) -> dict:
    if jax_side:
        out = {k: np.asarray(p.data) for k, p in m.named_parameters()}
        out.update((k, np.asarray(b)) for k, b in m.named_buffers())
        return out
    return {k: t.detach().numpy().copy() for k, t in [*m.named_parameters(), *m.named_buffers()]}


@pytest.fixture(scope="module", params=["test", "bottleneck"])
def resnet_run(request):
    """Both packages: one train-mode forward (its running-stat writes), 3
    SGD TrainSteps, then the eval forward."""
    jm, tm = _resnet_pair(request.param)
    classes = jm.body.cfg.num_classes
    batches = _images(5, B=3, classes=classes, seed=3)
    x, y = batches[0]
    out = {"which": request.param, "forward": (float(tj.jit(jm)(jnp.asarray(x), jnp.asarray(y))),
                                               float(tt.jit(tm)(torch.tensor(x), torch.tensor(y))))}
    out["after_forward"] = (_state(jm, True), _state(tm, False))
    js = JaxTrainStep(tj.jit(jm), jopt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
    ts = TrainStep(tt.jit(tm), topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
    out["losses"] = ([float(js(jnp.asarray(x), jnp.asarray(y))) for x, y in batches[1:4]],
                     [float(ts(torch.tensor(x), torch.tensor(y))) for x, y in batches[1:4]])
    out["after_steps"] = (_state(jm, True), _state(tm, False))
    jm.eval()
    tm.eval()
    x, _ = batches[4]
    tfn = tt.jit(tm.body)
    out["eval"] = (np.asarray(tj.jit(jm.body)(jnp.asarray(x))), tfn(torch.tensor(x)).numpy())
    tfn(torch.tensor(x))
    tm.train()
    tfn(torch.tensor(x))
    out["eval_cache"] = (tt.cache_misses(tfn), tt.cache_hits(tfn))
    return out


def test_resnet_names_and_buffers_match_jax():
    for which in ("test", "bottleneck"):
        jm, tm = _resnet_pair(which)
        assert [(k, tuple(p.shape)) for k, p in jm.named_parameters()] == \
            [(k, tuple(p.shape)) for k, p in tm.named_parameters()]
        assert [k for k, _ in jm.named_buffers()] == [k for k, _ in tm.named_buffers()]


def test_resnet_train_forward_and_running_stats_match_jax(resnet_run):
    jloss, tloss = resnet_run["forward"]
    _assert_fwd(tloss, jloss, "loss")
    jst, tst = resnet_run["after_forward"]
    stats = [k for k in jst if k.endswith(("running_mean", "running_var"))]
    assert stats and all(not np.array_equal(jst[k], np.zeros_like(jst[k])) for k in stats
                         if k.endswith("running_mean"))
    for k in stats:
        _assert_fwd(tst[k], jst[k], k)


def test_resnet_sgd_train_steps_match_jax(resnet_run):
    jlosses, tlosses = resnet_run["losses"]
    _assert_fwd(tlosses, jlosses, "losses")
    jst, tst = resnet_run["after_steps"]
    _assert_params(tst, jst)


def test_resnet_eval_forward_matches_jax_and_retraces_once(resnet_run):
    want, got = resnet_run["eval"]
    _assert_fwd(got, want, "eval logits")
    # eval: one trace, a hit; back to train: another trace
    assert resnet_run["eval_cache"] == (2, 1)
