"""The torch frontend's ops on the port, against thunder_tpu's.

Two families, each on the same numpy inputs (seeded) through thunder_tpu
(jax arrays, on the CPU) and through the port (CPU tensors):

* every ltorch function the frontend's mapping table or its same-name
  methods reach that the port lacked before the frontend (70 of them,
  thunder_tpu_torch/ops/ltorch.py), forward and, where differentiable, the
  gradients of a weighted sum of the outputs;
* every entry of the auto-registered catalog (ops/auto_catalog_ext.py):
  the port's auto op (the torch function of that name) against thunder_tpu's
  (a jax lowering of the same name) and against torch eager, with the
  gradients of torch.func.vjp against thunder_tpu's jax.vjp where the entry
  is differentiable.

Tolerances, f32: outputs within 1e-5 * max(1, |ref|) elementwise; gradients
within 1e-4 of each tensor's largest reference magnitude. The tests run with
jax x64 on (tests/conftest.py); where a jax lowering gives int32 and torch
int64, the values are compared. Samples come from thunder_tpu's own catalog
tests (tests/test_auto_catalog_smoke.py:SAMPLES) where they have one."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import thunder_tpu as jt
import thunder_tpu_torch as pt
from thunder_tpu.ops import auto_register as jar
from thunder_tpu.ops import ltorch as jl
from thunder_tpu_torch.ops import auto_catalog_ext as pcat
from thunder_tpu_torch.ops import auto_register as par
from thunder_tpu_torch.ops import ltorch as pl
from test_auto_catalog_smoke import SAMPLES as JAX_CATALOG_SAMPLES

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _f(r, *s):
    return r.standard_normal(s).astype(np.float32)


def _pos(r, *s):
    return (np.abs(r.standard_normal(s)) + 0.1).astype(np.float32)


def _spd(r, n):
    a = _f(r, n, n)
    return (a @ a.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def _unit(r, *s):
    return r.uniform(0.05, 0.95, s).astype(np.float32)


def _sign(r, *s):
    return np.where(r.standard_normal(s) > 0, 1.0, -1.0).astype(np.float32)


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


def _with_zeros(r, *s):
    x = _f(r, *s)
    x.reshape(-1)[::3] = 0.0
    return x


def _with_nans(r, *s):
    x = _f(r, *s)
    x.reshape(-1)[::4] = np.nan
    return x


# ---------------------------------------------------------------------------
# running one function on both packages
# ---------------------------------------------------------------------------


def _is_array(a) -> bool:
    return isinstance(a, np.ndarray)


def _arrays(args) -> list:
    """The array arguments (program inputs), lists of arrays walked."""
    out = []
    for a in args:
        if _is_array(a):
            out.append(a)
        elif isinstance(a, list):
            out.extend(_arrays(a))
    return out


def _filled(args, tensors):
    """args with its arrays, in _arrays order, replaced by ``tensors``."""
    it = iter(tensors)

    def fill(a):
        if _is_array(a):
            return next(it)
        if isinstance(a, list):
            return [fill(e) for e in a]
        return a

    return [fill(a) for a in args]


def _run_both(jfn, pfn, args, kwargs):
    """(thunder_tpu's outputs, the port's outputs) as numpy leaves; array
    arguments are program inputs, the rest static."""
    arrays = _arrays(args)
    # a CPU tensor pins the port's program to the CPU (a program with no
    # tensor input runs on the card)
    anchor = np.zeros((), np.float32)

    def jcall(_anchor, *ts):
        return jfn(*_filled(args, ts), **kwargs)

    def pcall(_anchor, *ts):
        return pfn(*_filled(args, ts), **kwargs)

    jout = jt.jit(jcall)(jnp.asarray(anchor), *[jnp.asarray(a) for a in arrays])
    pout = pt.jit(pcall)(torch.from_numpy(anchor.copy()), *[torch.from_numpy(a.copy()) for a in arrays])
    return _leaves_np(jout, jax=True), _leaves_np(pout)


def _to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().resolve_conj().resolve_neg()
        if x._is_zerotensor():
            x = torch.zeros(x.shape, dtype=x.dtype)
        return x.float().numpy() if x.dtype in (torch.bfloat16, torch.float16) else x.numpy()
    return np.asarray(x)


def _leaves_np(out, jax=False):
    if jax:
        import jax as _jax

        leaves = _jax.tree_util.tree_leaves(out)
    else:
        leaves = torch.utils._pytree.tree_leaves(out)
    return [_to_np(x) for x in leaves if hasattr(x, "shape")]


def assert_close_fwd(got, want, what):
    """Each output within FWD_RTOL * max(1, |ref|) elementwise (NaN where
    the reference is NaN); integer and bool outputs equal."""
    assert len(got) == len(want), f"{what}: {len(got)} outputs vs {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"{what}[{i}]: shape {g.shape} vs {w.shape}"
        if w.dtype.kind in "fc" or g.dtype.kind in "fc":
            g64, w64 = g.astype(np.complex128), w.astype(np.complex128)
            nan, inf = np.isnan(w64), np.isinf(w64)
            assert np.array_equal(np.isnan(g64), nan), f"{what}[{i}]: NaNs differ"
            assert np.array_equal(g64[inf], w64[inf]), f"{what}[{i}]: infinities differ"
            fin = ~(nan | inf)
            err = np.abs(g64 - w64)[fin]
            bound = (FWD_RTOL * np.maximum(1.0, np.abs(w64)))[fin]
            assert np.all(err <= bound), f"{what}[{i}]: max err {err.max()} over the bound"
        else:
            # thunder_tpu's int32 where torch gives int64 (jax lowerings):
            # the values are compared
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=f"{what}[{i}]")


def assert_close_grad(got, want, what):
    """Within GRAD_RTOL of the reference's largest magnitude (NaN where the
    reference is NaN)."""
    g, w = _to_np(got).astype(np.float64), _to_np(want).astype(np.float64)
    assert g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}"
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan), f"{what}: NaNs differ"
    if not w.size or nan.all():
        return
    scale = max(float(np.max(np.abs(w[~nan]))), 1e-30)
    err = float(np.max(np.abs(g - w)[~nan]))
    assert err <= GRAD_RTOL * scale, f"{what}: max grad err {err} vs {GRAD_RTOL} * {scale}"


def _weights(shape):
    n = max(1, math.prod(shape))
    return np.linspace(-1.0, 1.0, n, dtype=np.float32).reshape(shape)


def _diff_positions(args) -> list:
    return [i for i, a in enumerate(_arrays(args)) if a.dtype.kind == "f"]


def _weighted_loss(lib, fn, args, kwargs, n):
    """sum_i <out_i, w_i> over fn's float outputs, as a function of the
    array arguments then the weights."""
    mod = jl if lib == "j" else pl

    def loss(*xs):
        out = fn(*_filled(args, xs[:n]), **kwargs)
        leaves = jax.tree_util.tree_leaves(out) if lib == "j" else torch.utils._pytree.tree_leaves(out)
        outs = [o for o in leaves if hasattr(o, "shape") and o.dtype.is_inexact]
        total = None
        for o, w in zip(outs, xs[n:]):
            term = mod.sum(mod.mul(o, w))
            total = term if total is None else mod.add(total, term)
        return total

    return loss


def _jax_grads(jfn, args, kwargs, out_shapes) -> list:
    arrays, diff = _arrays(args), _diff_positions(args)
    loss = _weighted_loss("j", jfn, args, kwargs, len(arrays))
    _, g = jt.value_and_grad(loss, argnums=tuple(diff))(*[jnp.asarray(a) for a in arrays],
                                                        *[jnp.asarray(_weights(s)) for s in out_shapes])
    return [g[0][i] for i in diff]


def _port_grads(pfn, args, kwargs, out_shapes) -> list:
    arrays, diff = _arrays(args), _diff_positions(args)
    loss = _weighted_loss("p", pfn, args, kwargs, len(arrays))
    _, g = pt.value_and_grad(loss, argnums=tuple(diff))(*[torch.from_numpy(a.copy()) for a in arrays],
                                                        *[torch.from_numpy(_weights(s)) for s in out_shapes])
    return [g[0][i] for i in diff]


def _torch_grads(fn, args, kwargs, out_shapes) -> list:
    """torch autograd of fn itself, eager, on the same weighted sum."""
    arrays, diff = _arrays(args), _diff_positions(args)
    ts = [torch.from_numpy(a.copy()).requires_grad_(i in diff) for i, a in enumerate(arrays)]
    outs = [o for o in torch.utils._pytree.tree_leaves(fn(*_filled(args, ts), **kwargs))
            if isinstance(o, torch.Tensor) and o.dtype.is_floating_point]
    total = sum((o * torch.from_numpy(_weights(s))).sum() for o, s in zip(outs, out_shapes))
    if not total.requires_grad:  # no float output depends on a float argument
        return [torch.zeros_like(ts[i]) for i in diff]
    gs = torch.autograd.grad(total, [ts[i] for i in diff], allow_unused=True)
    return [torch.zeros_like(ts[i]) if g is None else g for i, g in zip(diff, gs)]


# ---------------------------------------------------------------------------
# the 70 ltorch functions
# ---------------------------------------------------------------------------

# case id -> (function name, sample builder(rng) -> (args, kwargs))
LTORCH_CASES = {
    "acosh": ("acosh", lambda r: ((_pos(r, 3, 4) + 1.0,), {})),
    "addmm": ("addmm", lambda r: ((_f(r, 3, 5), _f(r, 3, 4), _f(r, 4, 5)), {"beta": 0.5, "alpha": 2.0})),
    "aminmax": ("aminmax", lambda r: ((_f(r, 3, 4),), {"dim": 1})),
    "asinh": ("asinh", lambda r: ((_f(r, 3, 4),), {})),
    "atanh": ("atanh", lambda r: ((0.5 * np.tanh(_f(r, 3, 4)),), {})),
    "baddbmm": ("baddbmm", lambda r: ((_f(r, 2, 3, 5), _f(r, 2, 3, 4), _f(r, 2, 4, 5)), {"beta": 0.5, "alpha": 2.0})),
    "binary_cross_entropy": ("binary_cross_entropy", lambda r: ((_unit(r, 3, 4), _unit(r, 3, 4)), {})),
    "binary_cross_entropy_with_logits": ("binary_cross_entropy_with_logits",
                                         lambda r: ((_f(r, 3, 4), _unit(r, 3, 4)), {})),
    "binary_cross_entropy_with_logits[pos_weight]": (
        "binary_cross_entropy_with_logits",
        lambda r: ((_f(r, 3, 4), _unit(r, 3, 4), None, _pos(r, 4)), {"reduction": "sum"})),
    "broadcast_to": ("broadcast_to", lambda r: ((_f(r, 3, 1), (3, 4)), {})),
    "clamp_max": ("clamp_max", lambda r: ((_f(r, 3, 4), 0.3), {})),
    "clamp_min": ("clamp_min", lambda r: ((_f(r, 3, 4), -0.3), {})),
    "clip": ("clip", lambda r: ((_f(r, 3, 4), -0.5, 0.5), {})),
    "copysign": ("copysign", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {})),
    "cosine_similarity": ("cosine_similarity", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {})),
    "count_nonzero": ("count_nonzero", lambda r: ((_with_zeros(r, 3, 4),), {"dim": 1})),
    "cummax": ("cummax", lambda r: ((_f(r, 3, 6), 1), {})),
    "cumprod": ("cumprod", lambda r: ((_f(r, 3, 4), 1), {})),
    "diag": ("diag", lambda r: ((_f(r, 4),), {"diagonal": 1})),
    "diag[2d]": ("diag", lambda r: ((_f(r, 4, 5),), {"diagonal": -1})),
    "digamma": ("digamma", lambda r: ((_pos(r, 3, 4) + 0.5,), {})),
    "dot": ("dot", lambda r: ((_f(r, 5), _f(r, 5)), {})),
    "elu": ("elu", lambda r: ((_f(r, 3, 4), 0.7), {})),
    "erfinv": ("erfinv", lambda r: ((0.8 * np.tanh(_f(r, 3, 4)),), {})),
    "expand_as": ("expand_as", lambda r: ((_f(r, 3, 1), _f(r, 3, 4)), {})),
    "fold": ("fold", lambda r: ((_f(r, 1, 12, 9), (4, 4), 2), {})),
    "frac": ("frac", lambda r: ((3.0 * _f(r, 3, 4),), {})),
    "hardsigmoid": ("hardsigmoid", lambda r: ((4.0 * _f(r, 3, 4),), {})),
    "hardswish": ("hardswish", lambda r: ((4.0 * _f(r, 3, 4),), {})),
    "hardtanh": ("hardtanh", lambda r: ((2.0 * _f(r, 3, 4), -0.5, 0.8), {})),
    "heaviside": ("heaviside", lambda r: ((_with_zeros(r, 6), _f(r, 6)), {})),
    "hinge_embedding_loss": ("hinge_embedding_loss", lambda r: ((_f(r, 3, 4), _sign(r, 3, 4)), {})),
    "huber_loss": ("huber_loss", lambda r: ((2.0 * _f(r, 3, 4), _f(r, 3, 4)), {"delta": 0.5})),
    "hypot": ("hypot", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {})),
    "interpolate[bilinear]": ("interpolate", lambda r: ((_f(r, 1, 2, 4, 4),), {"size": (6, 7), "mode": "bilinear"})),
    "interpolate[nearest]": ("interpolate", lambda r: ((_f(r, 1, 2, 4, 4),), {"scale_factor": 2})),
    "kl_div": ("kl_div", lambda r: ((np.log(_softmax(_f(r, 3, 4))), _softmax(_f(r, 3, 4))),
                                    {"reduction": "batchmean"})),
    "kron": ("kron", lambda r: ((_f(r, 2, 3), _f(r, 3, 2)), {})),
    "l1_loss": ("l1_loss", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {})),
    "lgamma": ("lgamma", lambda r: ((_pos(r, 3, 4) + 0.5,), {})),
    "log10": ("log10", lambda r: ((_pos(r, 3, 4),), {})),
    "logaddexp": ("logaddexp", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {})),
    "logaddexp2": ("logaddexp2", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {})),
    "logical_xor": ("logical_xor", lambda r: ((_f(r, 3, 4) > 0, _f(r, 3, 4) > 0), {})),
    "logsumexp": ("logsumexp", lambda r: ((_f(r, 3, 4), 1), {})),
    "median": ("median", lambda r: ((_f(r, 7),), {})),
    "median[dim]": ("median", lambda r: ((_f(r, 3, 5),), {"dim": 1})),
    "mv": ("mv", lambda r: ((_f(r, 4, 5), _f(r, 5)), {})),
    "nan_to_num": ("nan_to_num", lambda r: ((np.array([[1.0, np.nan, np.inf], [-np.inf, 2.0, -3.0]], np.float32),),
                                            {"nan": 0.5})),
    "nanmean": ("nanmean", lambda r: ((_with_nans(r, 3, 4),), {"dim": 1})),
    "nansum": ("nansum", lambda r: ((_with_nans(r, 3, 4),), {})),
    "narrow": ("narrow", lambda r: ((_f(r, 6, 3), 0, 1, 4), {})),
    "nll_loss": ("nll_loss", lambda r: ((np.log(_softmax(_f(r, 4, 5))), np.array([0, 3, -100, 1])), {})),
    "norm": ("norm", lambda r: ((_f(r, 3, 4),), {})),
    "norm[p3,dim]": ("norm", lambda r: ((_f(r, 3, 4), 3), {"dim": 1})),
    "normalize": ("normalize", lambda r: ((_f(r, 3, 4),), {})),
    "outer": ("outer", lambda r: ((_f(r, 3), _f(r, 4)), {})),
    "pixel_shuffle": ("pixel_shuffle", lambda r: ((_f(r, 1, 8, 3, 3), 2), {})),
    "ravel": ("ravel", lambda r: ((_f(r, 3, 4),), {})),
    "rsub": ("rsub", lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {"alpha": 2.0})),
    "select": ("select", lambda r: ((_f(r, 4, 3), 0, -2), {})),
    "signbit": ("signbit", lambda r: ((_f(r, 3, 4),), {})),
    "smooth_l1_loss": ("smooth_l1_loss", lambda r: ((2.0 * _f(r, 3, 4), _f(r, 3, 4)), {"beta": 0.5})),
    "soft_margin_loss": ("soft_margin_loss", lambda r: ((_f(r, 3, 4), _sign(r, 3, 4)), {})),
    "softmin": ("softmin", lambda r: ((_f(r, 3, 4), 1), {})),
    "square": ("square", lambda r: ((_f(r, 3, 4),), {})),
    "tensordot": ("tensordot", lambda r: ((_f(r, 3, 4), _f(r, 4, 5)), {"dims": 1})),
    "tile": ("tile", lambda r: ((_f(r, 2, 3), (2, 1, 2)), {})),
    "triplet_margin_loss": ("triplet_margin_loss", lambda r: ((_f(r, 4, 6), _f(r, 4, 6), _f(r, 4, 6)), {})),
    "true_divide": ("true_divide", lambda r: ((_f(r, 3, 4), _pos(r, 3, 4)), {})),
    "unbind": ("unbind", lambda r: ((_f(r, 3, 4), 1), {})),
    "unflatten": ("unflatten", lambda r: ((_f(r, 3, 12), 1, (3, -1)), {})),
    "unfold": ("unfold", lambda r: ((_f(r, 1, 3, 5, 5), 2), {"padding": 1, "stride": 2})),
    "vdot": ("vdot", lambda r: ((_f(r, 5), _f(r, 5)), {})),
    "xlogy": ("xlogy", lambda r: ((_with_zeros(r, 3, 4), _pos(r, 3, 4)), {})),
}

# no grad rule for the sort prim in either package: median's gradient raises
LTORCH_NO_GRAD = {"median": "sort", "median[dim]": "sort"}

NEW_LTORCH = (
    "acosh addmm aminmax asinh atanh baddbmm binary_cross_entropy binary_cross_entropy_with_logits "
    "broadcast_to clamp_max clamp_min clip copysign cosine_similarity count_nonzero cummax cumprod diag "
    "digamma dot elu erfinv expand_as fold frac hardsigmoid hardswish hardtanh heaviside "
    "hinge_embedding_loss huber_loss hypot interpolate kl_div kron l1_loss lgamma log10 logaddexp "
    "logaddexp2 logical_xor logsumexp median mv nan_to_num nanmean nansum narrow nll_loss norm normalize "
    "outer pixel_shuffle ravel rsub select signbit smooth_l1_loss soft_margin_loss softmin square "
    "tensordot tile triplet_margin_loss true_divide unbind unflatten unfold vdot xlogy").split()


def test_every_new_ltorch_function_has_a_case():
    assert len(NEW_LTORCH) == 70
    assert sorted({fn for fn, _ in LTORCH_CASES.values()}) == sorted(NEW_LTORCH)
    for name in NEW_LTORCH:
        sym = getattr(pl, name)
        # thunder_tpu's symbol id (clip is clamp's symbol in both packages)
        jsym = getattr(jl, name, None) or jl.clamp
        assert sym.id == jsym.id, name


@pytest.mark.parametrize("case", sorted(LTORCH_CASES))
def test_ltorch_function_matches_thunder_tpu(case):
    name, build = LTORCH_CASES[case]
    args, kwargs = build(np.random.RandomState(1234))
    jfn = getattr(jl, name, None) or jl.clamp
    pfn = getattr(pl, name)
    jout, pout = _run_both(jfn, pfn, args, kwargs)
    assert_close_fwd(pout, jout, case)
    float_outs = [o.shape for o in jout if o.dtype.kind == "f"]
    if not float_outs or not _diff_positions(args):
        return
    if case in LTORCH_NO_GRAD:
        # neither package differentiates it: both raise
        for grads in (_jax_grads, lambda *a: _port_grads(pfn, *a[1:])):
            with pytest.raises(NotImplementedError, match=LTORCH_NO_GRAD[case]):
                grads(jfn, args, kwargs, float_outs)
        return
    for i, jg, pg in zip(_diff_positions(args), _jax_grads(jfn, args, kwargs, float_outs),
                         _port_grads(pfn, args, kwargs, float_outs)):
        assert_close_grad(pg, jg, f"{case} grad of array argument {i}")


# ---------------------------------------------------------------------------
# the auto-registered catalog
# ---------------------------------------------------------------------------

def _tri(r, n):
    return np.linalg.cholesky(_spd(r, n)).astype(np.float32)


def _pooled(r, nd):
    """(values, indices) of a 2-window max pool over nd spatial dims."""
    x = torch.from_numpy(_f(r, 1, 2, *([4] * nd)))
    v, i = getattr(torch.nn.functional, f"max_pool{nd}d")(x, 2, return_indices=True)
    return v.numpy(), i.numpy()


def _lu(r):
    lu, piv = torch.linalg.lu_factor(torch.from_numpy(_spd(r, 4)))
    return lu.numpy(), piv.numpy()


def _rnn_params(r, gates):
    """[w_ih, w_hh, b_ih, b_hh] of one layer: input 3, hidden 4."""
    return [_f(r, gates, 3), _f(r, gates, 4), _f(r, gates), _f(r, gates)]


def _log_probs(r, T, N, C):
    lp = np.log(np.abs(r.standard_normal((T, N, C))) + 0.1)
    return (lp - np.log(np.sum(np.exp(lp), -1, keepdims=True))).astype(np.float32)


def _spectrum(r):
    win = torch.hann_window(16)
    spec = torch.stft(torch.from_numpy(_f(r, 64)), 16, 4, window=win, return_complex=True)
    return spec.numpy(), win.numpy()


# samples for entries thunder_tpu's catalog tests cover by name only (or
# with arguments torch does not take), keyed by catalog name
CATALOG_SAMPLES = {
    "adaptive_max_pool1d": lambda r: ((_f(r, 2, 3, 10), 4), {}),
    "addbmm": lambda r: ((_f(r, 3, 5), _f(r, 2, 3, 4), _f(r, 2, 4, 5)), {}),
    "baddbmm": lambda r: ((_f(r, 2, 3, 5), _f(r, 2, 3, 4), _f(r, 2, 4, 5)), {}),
    "addmm": lambda r: ((_f(r, 3, 5), _f(r, 3, 4), _f(r, 4, 5)), {}),
    "addmv": lambda r: ((_f(r, 3), _f(r, 3, 4), _f(r, 4)), {}),
    "addr": lambda r: ((_f(r, 3, 4), _f(r, 3), _f(r, 4)), {}),
    "addcmul": lambda r: ((_f(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)), {"value": 0.5}),
    "addcdiv": lambda r: ((_f(r, 3, 4), _f(r, 3, 4), _pos(r, 3, 4)), {"value": 0.5}),
    "affine_grid_generator": lambda r: ((_f(r, 1, 2, 3), (1, 1, 4, 4), False), {}),
    "bartlett_window": lambda r: ((8,), {}),
    "blackman_window": lambda r: ((8,), {}),
    "hamming_window": lambda r: ((8,), {}),
    "hann_window": lambda r: ((8,), {}),
    "kaiser_window": lambda r: ((8,), {}),
    "batch_norm_stats": lambda r: ((_f(r, 4, 3, 5), 1e-5), {}),
    "batch_norm_elemt": lambda r: ((_f(r, 4, 3, 5), _pos(r, 3), _f(r, 3), _f(r, 3), _pos(r, 3), 1e-5), {}),
    "batch_norm_update_stats": lambda r: ((_f(r, 4, 3, 5), np.zeros(3, np.float32), np.ones(3, np.float32), 0.1),
                                          {}),
    "batch_norm_gather_stats": lambda r: ((_f(r, 4, 3, 5), _f(r, 2, 3), _pos(r, 2, 3), np.zeros(3, np.float32),
                                           np.ones(3, np.float32), 0.1, 1e-5, 8), {}),
    "batch_norm_gather_stats_with_counts": lambda r: ((_f(r, 4, 3, 5), _f(r, 2, 3), _pos(r, 2, 3),
                                                       np.zeros(3, np.float32), np.ones(3, np.float32), 0.1,
                                                       1e-5, np.array([8.0, 12.0], np.float32)), {}),
    "batch_norm_backward_reduce": lambda r: ((_f(r, 4, 3, 5), _f(r, 4, 3, 5), _f(r, 3), _pos(r, 3), _pos(r, 3),
                                              True, True, True), {}),
    "batch_norm_backward_elemt": lambda r: ((_f(r, 4, 3, 5), _f(r, 4, 3, 5), _f(r, 3), _pos(r, 3), _pos(r, 3),
                                             _f(r, 3), _f(r, 3), np.array([20], np.int32)), {}),
    "bucketize": lambda r: ((_f(r, 6), np.array([-1.0, 0.0, 1.0], np.float32)), {}),
    "searchsorted": lambda r: ((np.array([-1.0, 0.0, 1.0], np.float32), _f(r, 6)), {}),
    "chalf": lambda r: ((_f(r, 3, 4),), {}),
    "cdouble": lambda r: ((_f(r, 3, 4),), {}),
    "cholesky_solve": lambda r: ((_f(r, 3, 2), _tri(r, 3)), {}),
    "cholesky_inverse": lambda r: ((_tri(r, 3),), {}),
    "corrcoef": lambda r: ((_f(r, 3, 6),), {}),
    "cov": lambda r: ((_f(r, 3, 6),), {}),
    "cross": lambda r: ((_f(r, 4, 3), _f(r, 4, 3)), {"dim": -1}),
    "linalg_cross": lambda r: ((_f(r, 4, 3), _f(r, 4, 3)), {}),
    "cummin": lambda r: ((_f(r, 3, 6), 1), {}),
    "diagonal_scatter": lambda r: ((_f(r, 4, 4), _f(r, 4)), {}),
    "empty_permuted": lambda r: (((2, 3), (0, 1)), {}),
    "empty_strided": lambda r: (((2, 3), (3, 1)), {}),
    "new_empty": lambda r: ((_f(r, 2), (3, 2)), {}),
    "geqrf": lambda r: ((_f(r, 4, 3),), {}),
    "ger": lambda r: ((_f(r, 3), _f(r, 4)), {}),
    "grid_sampler": lambda r: ((_f(r, 1, 2, 5, 5), r.uniform(-1, 1, (1, 4, 4, 2)).astype(np.float32), 0, 0, True),
                               {}),
    "grid_sampler_2d": lambda r: ((_f(r, 1, 2, 5, 5), r.uniform(-1, 1, (1, 4, 4, 2)).astype(np.float32), 0, 0,
                                   True), {}),
    "imag": lambda r: ((_f(r, 3) + 1j * _f(r, 3),), {}),
    "real": lambda r: ((_f(r, 3) + 1j * _f(r, 3),), {}),
    "gcd": lambda r: ((np.array([4, 6, 9]), np.array([6, 4, 3])), {}),
    "lcm": lambda r: ((np.array([4, 6, 9]), np.array([6, 4, 3])), {}),
    "ldexp": lambda r: ((_f(r, 4), np.array([1, 2, 0, 3])), {}),
    "linalg_householder_product": lambda r: ((_f(r, 4, 3), _f(r, 3)), {}),
    "orgqr": lambda r: ((_f(r, 4, 3), _f(r, 3)), {}),
    "ormqr": lambda r: ((_f(r, 4, 3), _f(r, 3), _f(r, 4, 2)), {}),
    "linalg_lstsq": lambda r: ((_f(r, 5, 3), _f(r, 5, 2)), {}),
    "linalg_multi_dot": lambda r: (([_f(r, 3, 4), _f(r, 4, 5), _f(r, 5, 2)],), {}),
    "linalg_tensorsolve": lambda r: ((_spd(r, 4).reshape(2, 2, 4), _f(r, 2, 2)), {}),
    "matrix_rank": lambda r: ((_f(r, 4, 3),), {}),
    "moveaxis": lambda r: ((_f(r, 2, 3, 4), 0, 2), {}),
    "swapdims": lambda r: ((_f(r, 2, 3, 4), 0, 2), {}),
    "nanquantile": lambda r: ((_with_nans(r, 3, 5), 0.3), {"dim": 1}),
    "quantile": lambda r: ((_f(r, 3, 5), 0.3), {"dim": 1}),
    "narrow_copy": lambda r: ((_f(r, 6, 3), 0, 1, 4), {}),
    "pixel_shuffle": lambda r: ((_f(r, 1, 8, 3, 3), 2), {}),
    "pixel_unshuffle": lambda r: ((_f(r, 1, 2, 6, 6), 2), {}),
    "channel_shuffle": lambda r: ((_f(r, 1, 6, 2, 2), 3), {}),
    "polygamma": lambda r: ((1, _pos(r, 5) + 0.5), {}),
    "prelu": lambda r: ((_f(r, 2, 3, 4), _pos(r, 3)), {}),
    "renorm": lambda r: ((_f(r, 3, 4), 2.0, 0, 1.0), {}),
    "take": lambda r: ((_f(r, 3, 4), np.array([0, 5, 11])), {}),
    "threshold": lambda r: ((_f(r, 3, 4), 0.1, 20.0), {}),
    "triangular_solve": lambda r: ((_f(r, 3, 2), np.triu(_spd(r, 3)).astype(np.float32)), {"upper": True}),
    "tril_indices": lambda r: ((3, 4), {}),
    "triu_indices": lambda r: ((3, 4), {}),
    "view_as_complex": lambda r: ((_f(r, 3, 2),), {}),
    "view_as_real": lambda r: ((_f(r, 3) + 1j * _f(r, 3),), {}),
    "polar": lambda r: ((_pos(r, 3), _f(r, 3)), {}),
    "complex": lambda r: ((_f(r, 4), _f(r, 4)), {}),
    "fft_ifft": lambda r: ((_f(r, 8),), {}),
    "linalg_eigh": lambda r: ((_spd(r, 3),), {}),
    "linalg_vector_norm": lambda r: ((_f(r, 3, 4),), {}),
    "gaussian_nll_loss": lambda r: ((_f(r, 5), _f(r, 5), _pos(r, 5)), {}),
    "allclose": lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}),
    "equal": lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}),
    "is_same_size": lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}),
    "bmm": lambda r: ((_f(r, 2, 3, 4), _f(r, 2, 4, 5)), {}),
    "linalg_solve": lambda r: ((_spd(r, 3), _f(r, 3, 2)), {}),
    "logit": lambda r: ((_unit(r, 3, 4),), {}),
    "max_unpool1d": lambda r: (_pooled(r, 1) + (2,), {}),
    "max_unpool2d": lambda r: (_pooled(r, 2) + (2,), {}),
    "max_unpool3d": lambda r: (_pooled(r, 3) + (2,), {}),
    "lu_solve": lambda r: ((_f(r, 4, 2),) + _lu(r), {}),
    "linalg_lu_solve": lambda r: (_lu(r) + (_f(r, 4, 2),), {}),
    "lu_unpack": lambda r: (_lu(r), {}),
    "lstm_cell": lambda r: ((_f(r, 2, 3), [_f(r, 2, 4), _f(r, 2, 4)], _f(r, 16, 3), _f(r, 16, 4), _f(r, 16),
                             _f(r, 16)), {}),
    "lstm": lambda r: ((_f(r, 5, 2, 3), [_f(r, 1, 2, 4), _f(r, 1, 2, 4)], _rnn_params(r, 16),
                        True, 1, 0.0, False, False, False), {}),
    "gru": lambda r: ((_f(r, 5, 2, 3), _f(r, 1, 2, 4), _rnn_params(r, 12), True, 1, 0.0, False, False, False),
                      {}),
    "rnn_tanh": lambda r: ((_f(r, 5, 2, 3), _f(r, 1, 2, 4), _rnn_params(r, 4), True, 1, 0.0, False, False,
                            False), {}),
    "rnn_relu": lambda r: ((_f(r, 5, 2, 3), _f(r, 1, 2, 4), _rnn_params(r, 4), True, 1, 0.0, False, False,
                            False), {}),
    "ctc_loss": lambda r: ((_log_probs(r, 12, 3, 5), r.randint(1, 5, (3, 4)), np.array([12, 10, 8]),
                            np.array([4, 3, 2])), {}),
    "istft": lambda r: (_spectrum(r)[:1], {"n_fft": 16, "hop_length": 4}),
}

# generic samples, tried in order on entries with no sample above: the
# first torch takes is the entry's
_GENERIC = (
    lambda r: ((_f(r, 3, 4),), {}),
    lambda r: ((_f(r, 3, 4), _f(r, 3, 4)), {}),
    lambda r: ((_pos(r, 3, 4),), {}),
    lambda r: ((_spd(r, 4),), {}),
    lambda r: ((_f(r, 3, 4), 1), {}),
    lambda r: ((_f(r, 3, 4), _f(r, 3, 4), _f(r, 3, 4)), {}),
    lambda r: ((_f(r, 2, 3, 8), 2), {}),
    lambda r: ((_f(r, 1, 2, 6, 6), 2), {}),
    lambda r: ((_f(r, 8),), {}),
    lambda r: (([_f(r, 3, 4), _f(r, 3, 4)],), {}),
    lambda r: ((_f(r, 3, 4), _f(r, 4, 5)), {}),
)


def _torch_args(x):
    if _is_array(x):
        return torch.from_numpy(x.copy())
    if isinstance(x, list):
        return [_torch_args(e) for e in x]
    return x


def _sample(name):
    """(args, kwargs) for a catalog entry: this file's sample, thunder_tpu's,
    or the first generic one torch's function takes."""
    build = CATALOG_SAMPLES.get(name, JAX_CATALOG_SAMPLES.get(name))
    if build is not None:
        return build(np.random.RandomState(1234))
    fn = par.auto_function(par.get_auto_symbol(name))
    for build in _GENERIC:
        args, kwargs = build(np.random.RandomState(1234))
        try:
            fn(*[_torch_args(a) for a in args], **kwargs)
        except Exception:
            continue
        return args, kwargs
    return None


# Entries whose torch function cannot be traced: the meta runs the function
# on meta tensors, which these refuse, or the result is a host value. Tracing
# one raises, on the CPU and on the card alike.
TRACE_RAISES = {
    "allclose": "returns a Python bool (a host sync)",
    "equal": "returns a Python bool (a host sync)",
    "combinations": "masked_select inside: a data-dependent shape",
    "histogram": "no meta kernel (bins from the data)",
    "histogramdd": "no meta kernel (bins from the data)",
    "gaussian_nll_loss": "checks var >= 0 with .item() (a host sync)",
    "matrix_rank": "removed from torch: the function raises",
    "chalf": "complex32 has no dtype in the port (thunder_tpu's lowering gives complex64)",
    "cov": "checks its weights' values on the host (aten::equal has no meta kernel)",
    "corrcoef": "calls cov, which checks its weights' values on the host",
    "istft": "checks the window's overlap-add on the host (aten::equal has no meta kernel)",
    "ctc_loss": "no meta kernel in torch",
    **{n: "no meta kernel in torch" for n in (
        "native_norm", "fake_quantize_per_tensor_affine", "fake_quantize_per_channel_affine", "geqrf",
        "linalg_lstsq", "batch_norm_stats", "batch_norm_elemt", "batch_norm_gather_stats",
        "batch_norm_gather_stats_with_counts", "batch_norm_backward_reduce", "batch_norm_backward_elemt",
        "batch_norm_update_stats")},
}

# outputs with no defined value: shapes only
UNINITIALIZED = {"empty_permuted", "empty_strided", "new_empty"}
# randomized sketches: the singular values only
RANDOMIZED = {"svd_lowrank", "pca_lowrank"}

# Entries whose thunder_tpu lowering computes something else than the torch
# function of its name on the sample (or refuses torch's call): the port
# (torch's own function) is held to torch eager, and the difference is
# asserted, so the list stays true.
THUNDER_TPU_DIFFERS = {
    "linalg_vector_norm": "the lowering takes ord=2 over a matrix as the spectral norm",
    "nanmedian": "the lowering averages the two middle values; torch takes the lower",
    "triangular_solve": "torch returns (solution, A); the lowering the solution only",
    "cummin": "torch returns (values, indices); the lowering the values only",
    "orgqr": "the lowering returns all m columns of Q; torch the first n",
    "linalg_householder_product": "the lowering returns all m columns of Q; torch the first n",
    "linalg_multi_dot": "the lowering takes the matrices as arguments; torch takes one list (it raises)",
    "ormqr": "the lowering refuses torch's call: (4, 3) reflectors applied to a (4, 2) input (it raises)",
}

# outputs defined up to a sign or a permutation (eigenvectors, singular
# vectors, pivots): compared through what they determine, and their
# gradients against torch autograd only (a weighted sum of sign-ambiguous
# outputs has another gradient under another convention)
DECOMPOSITIONS = {"linalg_eigh", "linalg_eig", "linalg_eigvals", "svd", "linalg_svd", "linalg_qr", "qr",
                  "linalg_lu", "linalg_lu_factor", "linalg_lu_factor_ex", "lu"}

# Gradients that differ from thunder_tpu's. The port's are torch.func.vjp's
# and are held to torch autograd's; the difference is asserted.
GRAD_DIFFERS = {
    "native_layer_norm": "torch passes no gradient through its mean and rstd outputs",
    "cholesky_solve": "torch reads the factor's lower triangle only, so its gradient is lower-triangular",
    "as_strided_scatter": "torch's gradient for the input is the cotangent at the scattered positions and "
                          "zero elsewhere, the reverse of the function's (thunder_tpu's is the function's): "
                          "the port inherits torch's",
    **{n: "torch marks the result non-differentiable (no gradient, zeros); thunder_tpu differentiates its "
          "jax lowering" for n in (
        "special_bessel_j0", "special_bessel_j1", "special_spherical_bessel_j0", "special_modified_bessel_i0",
        "special_modified_bessel_i1", "special_modified_bessel_k0", "special_modified_bessel_k1",
        "special_scaled_modified_bessel_k0", "special_scaled_modified_bessel_k1",
        "special_chebyshev_polynomial_t", "special_chebyshev_polynomial_u", "special_chebyshev_polynomial_v",
        "special_chebyshev_polynomial_w", "special_shifted_chebyshev_polynomial_t",
        "special_shifted_chebyshev_polynomial_u", "special_shifted_chebyshev_polynomial_v",
        "special_shifted_chebyshev_polynomial_w", "special_hermite_polynomial_h",
        "special_hermite_polynomial_he", "special_laguerre_polynomial_l", "special_legendre_polynomial_p")},
}

# thunder_tpu's jax.vjp fallback raises on these (a multi-output lowering
# with integer outputs, or no jax rule): the port is held to torch autograd
JAX_GRAD_RAISES = {
    **{n: "its jax.vjp fallback rejects a cotangent tree of the float outputs only" for n in (
        "cummax", "kthvalue", "frexp", "gradient", "meshgrid", "slogdet", "linalg_slogdet", "linalg_inv_ex",
        "linalg_cholesky_ex", "linalg_solve_ex", "max_pool1d_with_indices", "max_pool2d_with_indices",
        "max_pool3d_with_indices", "adaptive_max_pool1d_with_indices", "adaptive_max_pool2d_with_indices",
        "adaptive_max_pool3d_with_indices")},
    "index_reduce": "jax has no scatter_mul gradient for repeated indices",
    "nextafter": "jax has no nextafter derivative",
}

_CATALOG = sorted(pcat.catalog())
_EXCLUDED = {"cpu", "pin_memory", "true_divide_", "matrix_exp_", "native_batch_norm"}


def test_catalog_takes_thunder_tpus_names_and_differentiable_set():
    """Every catalog name of thunder_tpu is the port's, differentiable alike;
    the ones left unbound are the documented ones."""
    from thunder_tpu.transforms import autodiff as jad

    jnames = set(jar.list_auto_ops())
    assert set(pcat.DIFFERENTIABLE) | set(pcat.NON_DIFFERENTIABLE) == jnames
    assert {n for n in jnames if f"auto.{n}" in jad.JAX_VJP_FALLBACK} == set(pcat.DIFFERENTIABLE)
    assert set(par.list_auto_ops()) == set(_CATALOG)
    unbound = set(pcat.unbound())
    assert _EXCLUDED <= unbound
    # the rest name no torch function at all
    for name in unbound - _EXCLUDED:
        assert not any(callable(getattr(ns, name, None)) for ns in (torch, torch.nn.functional, torch.Tensor)), name
    for name in _CATALOG:
        assert par.auto_function(par.get_auto_symbol(name)) is pcat.resolve(name)


def _torch_grads_or_error(fn, args, kwargs, shapes):
    """torch autograd's gradients, or the error torch raises for them (no
    derivative defined; vander's backward, which fails on its own in-place
    write)."""
    try:
        return _torch_grads(fn, args, kwargs, shapes), None
    except (RuntimeError, NotImplementedError) as e:
        return None, e


@pytest.mark.parametrize("name", _CATALOG)
def test_catalog_entry(name):
    psym, jsym = par.get_auto_symbol(name), jar.get_auto_symbol(name)
    sample = _sample(name)
    if sample is None:
        pytest.fail(f"{name}: no sample that torch's function takes")
    args, kwargs = sample
    arrays = _arrays(args)
    anchor = torch.zeros(())
    prog = pt.jit(lambda _a, *ts: psym(*_filled(args, ts), **kwargs))
    if name in TRACE_RAISES:
        with pytest.raises(Exception):
            prog(anchor, *[torch.from_numpy(a.copy()) for a in arrays])
        return
    pout = _leaves_np(prog(anchor, *[torch.from_numpy(a.copy()) for a in arrays]))
    want = _leaves_np(psym_eager(name, args, kwargs))

    def jax_out():
        return _leaves_np(jt.jit(lambda _a, *ts: jsym(*_filled(args, ts), **kwargs))(
            jnp.zeros(()), *[jnp.asarray(a) for a in arrays]), jax=True)

    if name in UNINITIALIZED:
        assert [p.shape for p in pout] == [w.shape for w in want] == [j.shape for j in jax_out()]
        return
    if name in RANDOMIZED:
        np.testing.assert_allclose(pout[1], want[1], rtol=1e-4, atol=1e-4)  # the singular values
        np.testing.assert_allclose(pout[1], jax_out()[1], rtol=1e-4, atol=1e-4)
        return
    assert_close_fwd(pout, want, f"{name} vs torch eager")
    if name in THUNDER_TPU_DIFFERS:
        try:
            jout = jax_out()
        except Exception:
            return
        same = len(jout) == len(pout) and all(j.shape == p.shape and np.allclose(j, p, atol=1e-5)
                                              for j, p in zip(jout, pout))
        assert not same, f"{name}: thunder_tpu now agrees with torch; take it off THUNDER_TPU_DIFFERS"
        return
    if name in DECOMPOSITIONS:
        _check_decomposition(name, args, pout, jax_out())
    else:
        assert_close_fwd(pout, jax_out(), f"{name} vs thunder_tpu")
    shapes = [o.shape for o in pout if o.dtype.kind == "f"]
    if not (par.is_differentiable(psym) and shapes and _diff_positions(args)):
        return
    want_g, torch_error = _torch_grads_or_error(pcat.resolve(name), args, kwargs, shapes)
    if torch_error is not None:
        # torch has no gradient here: the port's is torch's error
        with pytest.raises(type(torch_error)):
            _port_grads(psym, args, kwargs, shapes)
        return
    port = _port_grads(psym, args, kwargs, shapes)
    for i, pg, tg in zip(_diff_positions(args), port, want_g):
        assert_close_grad(pg, tg, f"{name} grad of array argument {i} vs torch autograd")
    if name in DECOMPOSITIONS:
        return
    if name in JAX_GRAD_RAISES:
        with pytest.raises(Exception):
            _jax_grads(jsym, args, kwargs, shapes)
        return
    jg = _jax_grads(jsym, args, kwargs, shapes)
    if name in GRAD_DIFFERS:
        assert any(not np.allclose(_to_np(p), _to_np(j), rtol=1e-4, atol=1e-4, equal_nan=True)
                   for p, j in zip(port, jg)), f"{name}: the gradients now agree; take it off GRAD_DIFFERS"
        return
    for i, pg, g in zip(_diff_positions(args), port, jg):
        assert_close_grad(pg, g, f"{name} grad of array argument {i} vs thunder_tpu")


def psym_eager(name, args, kwargs):
    """The torch function of the entry, called directly on the sample."""
    return pcat.resolve(name)(*_filled(args, [torch.from_numpy(a.copy()) for a in _arrays(args)]), **kwargs)


def _check_decomposition(name, args, pout, jout):
    a = args[0].astype(np.float64)
    if name == "linalg_eigh":
        for w, v in ((pout[0], pout[1]), (jout[0], jout[1])):
            np.testing.assert_allclose(v @ np.diag(w) @ v.T, a, atol=1e-4)
        np.testing.assert_allclose(pout[0], jout[0], rtol=1e-5, atol=1e-5)
    elif name in ("linalg_eigvals", "linalg_eig"):
        np.testing.assert_allclose(np.sort(np.abs(pout[0])), np.sort(np.abs(jout[0])), atol=1e-4)
    elif name in ("svd", "linalg_svd"):
        np.testing.assert_allclose(pout[1], jout[1], atol=1e-4)
    elif name in ("qr", "linalg_qr"):
        np.testing.assert_allclose(pout[0] @ pout[1], a, atol=1e-4)
        np.testing.assert_allclose(np.abs(pout[1]), np.abs(jout[1]), atol=1e-4)
    else:  # the LU family: pivot conventions differ; reconstructions agree
        if name == "linalg_lu":
            np.testing.assert_allclose(pout[0] @ pout[1] @ pout[2], a, atol=1e-4)
        assert [p.shape for p in pout] == [j.shape for j in jout]


def test_catalog_rnns_and_unpools_against_torch(rng):
    """The entries thunder_tpu's catalog tests cover with dedicated tests:
    the same calls through the port's auto ops, against torch eager."""
    F = torch.nn.functional
    x = torch.from_numpy(_f(rng, 1, 2, 8))
    v, idx = F.max_pool1d(x, 2, return_indices=True)
    sym = par.get_auto_symbol("max_unpool1d")
    got = pt.jit(lambda v, i: sym(v, i, 2))(v, idx)
    torch.testing.assert_close(got, F.max_unpool1d(v, idx, 2), rtol=0, atol=0)

    x, h, c = (torch.from_numpy(_f(rng, *s)) for s in ((2, 3), (2, 4), (2, 4)))
    w_ih, w_hh, b_ih, b_hh = (torch.from_numpy(_f(rng, *s)) for s in ((16, 3), (16, 4), (16,), (16,)))
    cell = par.get_auto_symbol("lstm_cell")
    got = pt.jit(lambda x, h, c, a, b, d, e: cell(x, (h, c), a, b, d, e))(x, h, c, w_ih, w_hh, b_ih, b_hh)
    want = torch.lstm_cell(x, (h, c), w_ih, w_hh, b_ih, b_hh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)

    a = torch.from_numpy(_spd(rng, 4))
    lu, piv = torch.linalg.lu_factor(a)
    b = torch.from_numpy(_f(rng, 4, 2))
    solve = par.get_auto_symbol("linalg_lu_solve")
    got = pt.jit(lambda lu, piv, b: solve(lu, piv, b))(lu, piv, b)
    torch.testing.assert_close(a @ got, b, rtol=1e-4, atol=1e-4)


def test_unmapped_tensor_method_twin_runs_what_was_called():
    """F.<name> beside torch.<name>: the frontend runs the function the
    module called (F.adaptive_max_pool1d returns values only)."""
    from thunder_tpu_torch.interop.torch_frontend import compile_torch_module

    class M(torch.nn.Module):
        def forward(self, x):
            return torch.nn.functional.adaptive_max_pool1d(x, 4)

    x = torch.from_numpy(_f(np.random.RandomState(0), 2, 3, 10))
    torch.testing.assert_close(compile_torch_module(M())(x), M()(x), rtol=0, atol=0)
