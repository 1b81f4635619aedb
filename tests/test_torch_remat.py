"""Activation checkpointing in the port, against thunder_tpu's, on the CPU.

The cases of thunder_tpu's tests/test_remat.py, run on the port
(tiny-llama2 at 3 layers, B=2, T=64): ``activation_checkpoint=True`` cuts
the saved-for-backward bytes below 0.7x, changes no loss over 3 steps
(1e-5, the reference test's bar), and the RECOMPUTE_IN_BACKWARD tags
survive the autocast rewrite; an inline ``remat.checkpoint`` matches the
unwrapped function. Beside them: the port saves for backward exactly what
thunder_tpu saves (the same count, shapes, dtypes and bytes) and trains to
thunder_tpu's losses, and the backward replays the flash-RoPE forward of
every checkpointed layer.
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
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.core.symbol import OpTags
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.ops import ltorch
from thunder_tpu_torch.training import TrainStep
from thunder_tpu_torch.transforms import remat
from thunder_tpu_torch.transforms.autocast import AutocastTransform

N_LAYER, B, T = 3, 2, 64


def _saved(fwd_trace) -> list:
    """(shape, dtype) of each tensor crossing the fwd/bwd split."""
    saved = fwd_trace.bound_symbols[-1].args[0][1]
    return [(tuple(p.shape), p.dtype.name) for p in saved if hasattr(p, "shape")]


def _bytes(saved) -> int:
    itemsize = {"float32": 4, "int32": 4, "int64": 8, "bfloat16": 2, "bool8": 1}
    return sum(int(np.prod(s)) * itemsize[d] for s, d in saved)


def _port_saved(step) -> list:
    return _saved(tt.last_traces(step)[1])


def _jax_saved(step) -> list:
    return _saved(next(iter(step._vag._cache.values())).fwd_trc)


def _batch(cfg):
    return np.random.RandomState(0).randint(0, cfg.vocab_size, (B, T)).astype(np.int32)


def _port_step(ckpt: bool, autocast: bool = False, params=None):
    cfg = tlg.Config.from_name("tiny-llama2", n_layer=N_LAYER, activation_checkpoint=ckpt)
    model = tlg.GPTForCausalLM(cfg, device="cpu")
    if params is not None:
        tlg.load_jax_params(model, params)
    step = TrainStep(tt.jit(model, transforms=[AutocastTransform()] if autocast else None),
                     topt.AdamW(lr=1e-3))
    return step, torch.tensor(_batch(cfg))


def _jax_params():
    jm = jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2", n_layer=N_LAYER, activation_checkpoint=True))
    return jm, {k: np.asarray(p.data) for k, p in jm.named_parameters()}


@pytest.fixture(scope="module")
def pair():
    """Both packages' TrainSteps with activation_checkpoint=True from the same
    weights, 3 steps each: (jax losses, port losses, jax step, port step)."""
    jm, params = _jax_params()
    js = JaxTrainStep(tj.jit(jm), jopt.AdamW(lr=1e-3))
    ts, idx = _port_step(True, params=params)
    jidx = jnp.asarray(idx.numpy())
    jl = [float(js(jidx, jidx)) for _ in range(3)]
    tl_ = [float(ts(idx, idx)) for _ in range(3)]
    return jl, tl_, js, ts


def test_saved_for_backward_shrinks():
    plain, idx = _port_step(False)
    float(plain(idx, idx))
    ckpt, _ = _port_step(True)
    float(ckpt(idx, idx))
    p, c = _bytes(_port_saved(plain)), _bytes(_port_saved(ckpt))
    assert c < p * 0.7, f"ckpt saved {c} B, plain {p} B: no cut happened"


def test_numerics_exact_across_steps():
    _, params = _jax_params()
    plain, idx = _port_step(False, params=params)
    ckpt, _ = _port_step(True, params=params)
    a = [float(plain(idx, idx)) for _ in range(3)]
    b = [float(ckpt(idx, idx)) for _ in range(3)]
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_tags_survive_autocast_rewrite():
    ckpt, idx = _port_step(True, autocast=True)
    float(ckpt(idx, idx))
    plain, _ = _port_step(False, autocast=True)
    float(plain(idx, idx))
    assert _bytes(_port_saved(ckpt)) < _bytes(_port_saved(plain)) * 0.7


def test_autocast_keeps_recompute_tags_on_replacements():
    """A RECOMPUTE_IN_BACKWARD-tagged linear is rewritten by autocast into
    casts and a bf16 linear: every bsym that replaces it carries the tag."""
    w = torch.randn(8, 16)

    def f(x, w):
        return ltorch.sum(remat.checkpoint(lambda a: ltorch.linear(a, w))(x))

    trc = tt.acquire_trace(f, (torch.randn(4, 16), w), {})
    tagged = [b for b in trc.bound_symbols if OpTags.RECOMPUTE_IN_BACKWARD in b.tags]
    assert [b.sym.id for b in tagged] == ["torch.nn.functional.linear"]
    _, cast = AutocastTransform().transform_traces_pre_autodiff(None, trc)
    tagged = [b.sym.id for b in cast.bound_symbols if OpTags.RECOMPUTE_IN_BACKWARD in b.tags]
    assert tagged.count("torch.nn.functional.linear") == 1 and len(tagged) >= 2, tagged
    untagged = [b.sym.id for b in cast.bound_symbols if OpTags.RECOMPUTE_IN_BACKWARD not in b.tags]
    assert "torch.sum" in untagged


def test_inline_checkpoint_matches_unwrapped():
    rng = np.random.RandomState(0)
    w1 = torch.tensor(rng.randn(16, 32).astype(np.float32))
    w2 = torch.tensor(rng.randn(32, 8).astype(np.float32))

    def block(x):
        return ltorch.gelu(ltorch.matmul(x, w1))

    def f_plain(x):
        return ltorch.sum(ltorch.matmul(block(x), w2))

    def f_ckpt(x):
        return ltorch.sum(ltorch.matmul(remat.checkpoint(block)(x), w2))

    x = torch.tensor(rng.randn(4, 16).astype(np.float32))
    v1, g1 = tt.value_and_grad(f_plain, argnums=0)(x)
    v2, g2 = tt.value_and_grad(f_ckpt, argnums=0)(x)
    np.testing.assert_allclose(float(v1), float(v2), atol=1e-6)
    np.testing.assert_allclose(g1[0][0].numpy(), g2[0][0].numpy(), atol=1e-6)
    assert remat.checkpoint(block)(x).shape == (4, 32)  # outside a trace it just runs


def test_saved_for_backward_equals_thunder_tpus(pair):
    """tiny-llama2 with activation_checkpoint=True: the same residuals cross
    the split in both packages (count, shapes, dtypes, bytes), though the
    port's attention runs the flash-RoPE rule and thunder_tpu's the
    composite at this T: under remat only the segments' external inputs
    are saved."""
    _, _, js, ts = pair
    jsaved, tsaved = _jax_saved(js), _port_saved(ts)
    assert len(tsaved) == len(jsaved)
    assert sorted(tsaved) == sorted(jsaved)
    assert _bytes(tsaved) == _bytes(jsaved)


def test_remat_losses_match_thunder_tpu(pair):
    jl, tl_, _, _ = pair
    np.testing.assert_allclose(tl_, jl, rtol=1e-5)


def test_backward_replays_the_flash_forward(pair):
    """Each checkpointed layer's flash-RoPE forward runs in the forward
    program and once more, replayed, in the backward."""
    ts = pair[-1]
    fwd = [b.sym.id for b in tt.last_traces(ts)[-1].bound_symbols]
    bwd = [b.sym.id for b in tt.last_backward_traces(ts)[-1].bound_symbols]
    assert fwd.count("cuda.rope_flash_fwd") == N_LAYER
    assert bwd.count("cuda.rope_flash_fwd") == N_LAYER
    assert bwd.count("cuda.rope_flash_bwd") == N_LAYER
