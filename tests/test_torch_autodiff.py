"""The port's trace-level autodiff against thunder_tpu's, on the CPU.

Each case is a scalar loss over ops of the llama training path (and their
decompositions); the same numpy inputs go through ``thunder_tpu.value_and_grad``
and the port's ``value_and_grad``, and the values and gradients must agree
to 1e-5 (f32, the same math in another summation order). ``rope_sdpa`` runs
both decomposed (the cuda checker patched to decline) and claimed, where
the port's forward and backward traces must hold ``cuda.rope_flash_fwd`` and
``cuda.rope_flash_bwd`` (on CPU tensors their plain versions run).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu.models.litgpt import build_rope_cache
from thunder_tpu.ops import ltorch as jl
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.ops import ltorch as tl

TOL = 1e-5


def _linear(L, x, w, b, r):
    return L.sum(L.linear(x, w, b) * r)


def _matmul(L, x, w, r):
    return L.sum(L.matmul(x, w) * r)


def _rms_norm(L, x, w, r):
    return L.sum(L.rms_norm(x, (x.shape[-1],), w, 1e-5) * r)


def _rms_parts(L, x, r):
    # rsqrt(mean(x²) + eps), the decomposition RMSNorm's grad walks
    return L.sum(L.rsqrt(L.mean(x * x, -1, keepdim=True) + 1e-5) * x * r)


def _silu_mlp(L, x, w, r):
    return L.sum(L.silu(L.matmul(x, w)) * L.matmul(x, w) * r)


def _softmaxes(L, x, r):
    return L.sum(L.softmax(x, -1) * r) + L.sum(L.log_softmax(x, -1) * r)


def _take_along(L, x, r):
    idx = L.argsort(r, -1)
    return L.sum(L.take_along_dim(x, idx, -1) * r)


def _shapes(L, x, r):
    y = L.permute(L.reshape(x, (2, 3, 8)), (0, 2, 1))  # (2, 8, 3)
    z = L.cat([y[:, :5] * 2.0, y[:, 5:]], 1)
    return L.sum(L.reshape(z, (6, 8)) * r)


def _cross_entropy(L, x, w, tgt):
    return L.cross_entropy(L.matmul(x, w), tgt)


def _embedding(L, w, idx, r):
    return L.sum(L.embedding(idx, w) * r)


def _rope_sdpa(L, q, k, v, cos, sin, r):
    o = L.rope_sdpa(q, k, v, cos, sin, is_causal=True, scale=1.0 / math.sqrt(q.shape[-1]))
    return L.sum(o * r)


def _inputs(name, rng):
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    if name == "linear":
        return [f(6, 8), f(5, 8), f(5), f(6, 5)], (0, 1, 2)
    if name == "matmul":
        return [f(2, 6, 8), f(8, 5), f(2, 6, 5)], (0, 1)
    if name == "rms_norm":
        return [f(6, 16), 1 + 0.1 * f(16), f(6, 16)], (0, 1)
    if name == "rms_parts":
        return [f(6, 16), f(6, 16)], (0,)
    if name == "silu_mlp":
        return [f(6, 8), f(8, 12), f(6, 12)], (0, 1)
    if name == "softmaxes":
        return [f(4, 10), f(4, 10)], (0,)
    if name == "take_along":
        return [f(4, 10), f(4, 10)], (0,)
    if name == "shapes":
        return [f(6, 8), f(6, 8)], (0,)
    if name == "cross_entropy":
        return [f(12, 8), f(8, 20), rng.randint(0, 20, (12,)).astype(np.int64)], (0, 1)
    if name == "embedding":
        return [f(20, 8), rng.randint(0, 20, (3, 5)).astype(np.int64), f(3, 5, 8)], (0,)
    # rope_sdpa: GQA (4 q heads over 2 kv heads), T=16, D=16
    T, D = 16, 16
    cos, sin = (np.asarray(a) for a in build_rope_cache(T, D, 10000, jnp.float32))
    return [f(1, 4, T, D), f(1, 2, T, D), f(1, 2, T, D), cos, sin, f(1, 4, T, D)], (0, 1, 2)


CASES = {
    "linear": _linear, "matmul": _matmul, "rms_norm": _rms_norm, "rms_parts": _rms_parts,
    "silu_mlp": _silu_mlp, "softmaxes": _softmaxes, "take_along": _take_along,
    "shapes": _shapes, "cross_entropy": _cross_entropy, "embedding": _embedding,
    "rope_sdpa_decomposed": _rope_sdpa, "rope_sdpa_claimed": _rope_sdpa,
}


def _both(name, monkeypatch):
    rng = np.random.RandomState(sorted(CASES).index(name))
    arrays, argnums = _inputs(name.replace("_decomposed", "").replace("_claimed", ""), rng)
    fn = CASES[name]
    jval, jgrads = tj.value_and_grad(lambda *a: fn(jl, *a), argnums=argnums)(
        *[jnp.asarray(a) for a in arrays])
    if name == "rope_sdpa_decomposed":
        monkeypatch.setattr(cudaex, "rope_sdpa_supported", lambda *a, **k: False)
    vag = tt.value_and_grad(lambda *a: fn(tl, *a), argnums=argnums)
    tval, tgrads = vag(*[torch.tensor(a) for a in arrays])
    return (jval, jgrads), (tval, tgrads), argnums, vag


@pytest.mark.parametrize("name", sorted(CASES))
def test_value_and_grad_matches_jax(name, monkeypatch):
    (jval, jgrads), (tval, tgrads), argnums, _ = _both(name, monkeypatch)
    np.testing.assert_allclose(float(tval), float(jval), atol=TOL, rtol=TOL)
    for i in argnums:
        np.testing.assert_allclose(tgrads[0][i].numpy(), np.asarray(jgrads[0][i]),
                                   atol=TOL, rtol=TOL, err_msg=f"grad of argument {i}")


@pytest.mark.parametrize("name,claimed", [("rope_sdpa_decomposed", False),
                                          ("rope_sdpa_claimed", True)])
def test_rope_sdpa_claims_the_flash_kernels(name, claimed, monkeypatch):
    *_, vag = _both(name, monkeypatch)
    fwd_ids = {b.sym.id for b in tt.last_traces(vag)[-1].bound_symbols}
    bwd = tt.last_backward_traces(vag)[-1].bound_symbols
    assert ("cuda.rope_flash_fwd" in fwd_ids) == claimed
    assert any(b.sym.id == "cuda.rope_flash_bwd" for b in bwd) == claimed
    if claimed:
        impls = {b.impl for b in bwd if b.sym.id == "cuda.rope_flash_bwd"}
        assert impls == {cudaex._rope_flash_bwd_impl}


def test_unported_fallback_ops_raise_naming_the_op():
    """thunder_tpu takes scatter's gradient from jax.vjp, and no port path
    differentiates it yet; the port raises (var has a rule now:
    tests/test_torch_vision_grads.py)."""
    vag = tt.value_and_grad(lambda x, s: tl.sum(tl.scatter(x, 0, torch.tensor([[1, 0, 2, 1]]), s)),
                            argnums=(0,))
    with pytest.raises(NotImplementedError, match="scatter"):
        vag(torch.rand(3, 4), torch.rand(1, 4))


def test_grad_returns_only_the_gradients():
    x = torch.rand(3, 4)
    g = tt.grad(lambda a: tl.sum(a * a))(x)
    torch.testing.assert_close(g[0][0], 2 * x)
