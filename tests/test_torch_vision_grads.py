"""The port's grad rules for the ops thunder_tpu differentiates with jax.vjp,
against jax.vjp of thunder_tpu's jax implementations, on the CPU.

thunder_tpu takes the gradients of convolution, conv_transpose,
reduce_window, var, atan2, cumsum, cumprod, digamma and copy_with_setitem
from ``jax.vjp`` of executors/jaxex.py's implementations (its
JAX_VJP_FALLBACK); the port writes each rule out (transforms/autodiff.py).
Each case here is ``sum(prim(inputs) * r)`` for a random cotangent r from a
numpy seed, through the port's ``value_and_grad``, against ``jax.vjp`` of
the jaxex implementation with cotangent r: the value within 1e-5 ·
max(1, |ref|), each gradient within 1e-4 of its tensor's largest (f32, the
same math in another order).

* convolution at ViT's patchify (kernel = stride = 8), ResNet's 7x7 s2 p3,
  3x3 s2 p1 and 1x1 s2, groups=2, dilation=2, a prim-level bias, 1-d and
  3-d; conv_transpose with stride, output_padding, groups and dilation.
* reduce_window max and min by jax's tie rule (XLA's SelectAndScatter: the
  first in-bounds element equal to the window's result, row-major over the
  window; padding never selected), on inputs with planted ties: ReLU'd
  values with all-zero patches, as after ResNet's stem, and values on a
  coarse grid; with padding of -inf, asymmetric pads and 3-d windows. A
  planted fault (the window scanned last to first) must fail the bar.
  reduce_window sum: pooling windows, overlapping and padded.
* var over one and two dims at corrections 0 and 1; atan2; cumsum; cumprod
  with zeros planted (none, one, two, first element); digamma on both sides
  of 0 (the port's trigamma: recurrence, series and reflection);
  copy_with_setitem with slice, integer, index-tensor and broadcast keys.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu_torch as tt
from thunder_tpu.core.prims import PrimIDs as JPrimIDs
from thunder_tpu.executors import jaxex
from thunder_tpu_torch.core import prims
from thunder_tpu_torch.ops import ltorch as tl
from thunder_tpu_torch.transforms import autodiff

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _vjp_pair(prim_name, fn_port, arrays, argnums, static=(), kw=None, cot_seed=0):
    """(port value, port grads) and (jax value, jax grads) of
    sum(prim(*arrays, *static) * r)."""
    kw = kw or {}
    impl = jaxex.ex.get_impl(JPrimIDs[prim_name])
    jins = [jnp.asarray(a) for a in arrays]

    def jfn(*diff):
        full = list(jins)
        for i, d in zip(argnums, diff):
            full[i] = d
        return impl(*full, *static, **kw)

    jout, vjp = jax.vjp(jfn, *[jins[i] for i in argnums])
    r = np.asarray(np.random.RandomState(cot_seed).randn(*jout.shape), dtype=np.float32)
    jgrads = vjp(jnp.asarray(r))
    jval = float(jnp.sum(jout * r))

    def loss(*ins):
        return tl.sum(fn_port(*ins[:-1]) * ins[-1])

    tval, tgrads = tt.value_and_grad(loss, argnums=argnums)(*[torch.tensor(a) for a in arrays],
                                                             torch.tensor(r))
    return (float(tval), [tgrads[0][i].numpy() for i in argnums]), (jval, [np.asarray(g) for g in jgrads])


def _assert_close(port, ref):
    (tval, tgrads), (jval, jgrads) = port, ref
    assert abs(tval - jval) <= VALUE_TOL * max(1.0, abs(jval)), (tval, jval)
    for i, (t, j) in enumerate(zip(tgrads, jgrads)):
        assert t.shape == j.shape, (i, t.shape, j.shape)
        err = np.abs(t - j).max()
        assert err <= GRAD_TOL * max(np.abs(j).max(), 1e-30), f"grad {i}: {err} of {np.abs(j).max()}"


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# convolution and conv_transpose
# ---------------------------------------------------------------------------

# (input shape, weight shape, stride, padding, dilation, groups, bias)
CONV_CASES = {
    "vit_patchify": ((2, 3, 32, 32), (8, 3, 8, 8), (8, 8), (0, 0), (1, 1), 1, False),
    "stem_7x7_s2_p3": ((2, 3, 16, 16), (4, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1, False),
    "3x3_s2_p1": ((2, 4, 9, 9), (6, 4, 3, 3), (2, 2), (1, 1), (1, 1), 1, False),
    "1x1_s2": ((2, 4, 8, 8), (6, 4, 1, 1), (2, 2), (0, 0), (1, 1), 1, False),
    "groups2": ((2, 4, 8, 8), (6, 2, 3, 3), (1, 1), (1, 1), (1, 1), 2, False),
    "dilation2": ((2, 3, 10, 10), (4, 3, 3, 3), (1, 1), (2, 2), (2, 2), 1, False),
    "bias": ((2, 3, 8, 8), (5, 3, 3, 3), (1, 1), (1, 1), (1, 1), 1, True),
    "conv1d": ((2, 3, 17), (4, 3, 5), (2,), (2,), (1,), 1, False),
    "conv3d": ((1, 2, 5, 6, 7), (3, 2, 3, 3, 3), (2, 1, 2), (1, 1, 0), (1, 1, 1), 1, False),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_grad_matches_jax_vjp(case):
    a_shape, w_shape, stride, padding, dilation, groups, bias = CONV_CASES[case]
    rng = np.random.RandomState(sorted(CONV_CASES).index(case))
    arrays = [_f(rng, *a_shape), _f(rng, *w_shape)] + ([_f(rng, w_shape[0])] if bias else [])
    conv = (stride, padding, dilation, groups)

    def port(a, w, b=None):
        return prims.convolution(a, w, b, *conv)

    if bias:
        impl = jaxex.ex.get_impl(JPrimIDs.CONVOLUTION)
        jfn = lambda a, w, b: impl(a, w, b, *conv)  # noqa: E731
        jout, vjp = jax.vjp(jfn, *[jnp.asarray(x) for x in arrays])
        r = np.random.RandomState(0).randn(*jout.shape).astype(np.float32)
        ref = (float(jnp.sum(jout * r)), [np.asarray(g) for g in vjp(jnp.asarray(r))])
        tval, tg = tt.value_and_grad(lambda a, w, b, r: tl.sum(port(a, w, b) * r), argnums=(0, 1, 2))(
            *[torch.tensor(x) for x in arrays], torch.tensor(r))
        _assert_close((float(tval), [tg[0][i].numpy() for i in range(3)]), ref)
        return
    _assert_close(*_vjp_pair("CONVOLUTION", port, arrays, (0, 1), static=(None, *conv)))


# (input shape, weight shape (Cin, Cout/groups, *K), stride, padding, output_padding, dilation, groups)
CONV_T_CASES = {
    "s2_p1_op1": ((2, 4, 5, 5), (4, 3, 3, 3), (2, 2), (1, 1), (1, 1), (1, 1), 1),
    "groups2": ((2, 4, 5, 5), (4, 2, 3, 3), (1, 1), (1, 1), (0, 0), (1, 1), 2),
    "dilation2": ((2, 3, 4, 4), (3, 2, 3, 3), (2, 2), (0, 0), (0, 0), (2, 2), 1),
    "1d": ((2, 3, 7), (3, 4, 4), (3,), (1,), (2,), (1,), 1),
}


@pytest.mark.parametrize("case", sorted(CONV_T_CASES))
def test_conv_transpose_grad_matches_jax_vjp(case):
    a_shape, w_shape, *spec = CONV_T_CASES[case]
    rng = np.random.RandomState(10 + sorted(CONV_T_CASES).index(case))
    arrays = [_f(rng, *a_shape), _f(rng, *w_shape)]
    _assert_close(*_vjp_pair("CONV_TRANSPOSE", lambda a, w: prims.conv_transpose(a, w, None, *spec), arrays,
                             (0, 1), static=(None, *spec)))


# ---------------------------------------------------------------------------
# reduce_window
# ---------------------------------------------------------------------------


def _tied(rng, shape):
    """ReLU'd values on a grid of 0.5 with all-zero 4x4 patches: most
    windows tie, at 0 or at a grid value."""
    x = np.maximum(np.round(rng.randn(*shape) * 2) / 2, 0).astype(np.float32)
    x[..., 2:6, 3:7] = 0
    x[..., -4:, -4:] = 0
    return x


# (op, input maker, window, strides, padding)
WINDOW_CASES = {
    "max_stem_3x3_s2_p1": ("max", lambda r: _tied(r, (2, 3, 12, 12)), (1, 1, 3, 3), (1, 1, 2, 2),
                           ((0, 0), (0, 0), (1, 1), (1, 1))),
    "max_2x2_s1": ("max", lambda r: _tied(r, (1, 2, 9, 9)), (1, 1, 2, 2), (1, 1, 1, 1),
                   ((0, 0),) * 4),
    "max_asymmetric_pad": ("max", lambda r: _tied(r, (1, 2, 10, 11)), (1, 1, 3, 2), (1, 1, 2, 3),
                           ((0, 0), (0, 0), (2, 1), (0, 2))),
    "max_negative_pad_edges": ("max", lambda r: -_tied(r, (1, 2, 9, 9)) - 1.0, (1, 1, 3, 3), (1, 1, 2, 2),
                               ((0, 0), (0, 0), (1, 1), (1, 1))),
    "max_3d": ("max", lambda r: _tied(r, (1, 2, 6, 8, 8)), (1, 1, 2, 3, 3), (1, 1, 2, 2, 2),
               ((0, 0), (0, 0), (0, 0), (1, 1), (1, 1))),
    "max_over_channels": ("max", lambda r: _tied(r, (2, 6, 8, 8)), (1, 3, 1, 2), (1, 2, 1, 2),
                          ((0, 0), (1, 0), (0, 0), (0, 0))),
    "min_3x3_s2_p1": ("min", lambda r: -_tied(r, (2, 3, 12, 12)), (1, 1, 3, 3), (1, 1, 2, 2),
                      ((0, 0), (0, 0), (1, 1), (1, 1))),
    "sum_2x2_s2": ("sum", lambda r: _f(r, 2, 3, 8, 8), (1, 1, 2, 2), (1, 1, 2, 2), ((0, 0),) * 4),
    "sum_3x3_s1_p1": ("sum", lambda r: _f(r, 2, 3, 7, 7), (1, 1, 3, 3), (1, 1, 1, 1),
                      ((0, 0), (0, 0), (1, 1), (1, 1))),
    "sum_3x3_s2_asymmetric": ("sum", lambda r: _f(r, 1, 2, 9, 10), (1, 1, 3, 3), (1, 1, 2, 2),
                              ((0, 0), (0, 0), (0, 2), (1, 0))),
    "sum_global_7x7": ("sum", lambda r: _f(r, 2, 4, 7, 7), (1, 1, 7, 7), (1, 1, 7, 7), ((0, 0),) * 4),
}


def _window_pair(case, cot_seed=0):
    op, make, window, strides, padding = WINDOW_CASES[case]
    x = make(np.random.RandomState(20 + sorted(WINDOW_CASES).index(case)))
    return _vjp_pair("REDUCE_WINDOW", lambda a: prims.reduce_window(a, window, strides, padding, op=op),
                     [x], (0,), static=(window, strides, padding), kw={"op": op}, cot_seed=cot_seed)


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_reduce_window_grad_matches_jax_vjp(case):
    _assert_close(*_window_pair(case))


def test_max_pool_ties_are_planted_and_decide_the_gradient(monkeypatch):
    """The stem case's windows really tie, and the rule's scan order
    matters: scanning each window last to first (a planted fault) puts the
    cotangent elsewhere and fails the bar."""
    op, make, window, strides, padding = WINDOW_CASES["max_stem_3x3_s2_p1"]
    x = make(np.random.RandomState(20 + sorted(WINDOW_CASES).index("max_stem_3x3_s2_p1")))
    xp = np.pad(x, [(0, 0), (0, 0), (1, 1), (1, 1)], constant_values=-np.inf)
    wins = np.lib.stride_tricks.sliding_window_view(xp, (3, 3), axis=(2, 3))[:, :, ::2, ::2]
    ties = (wins == wins.max(axis=(-1, -2), keepdims=True)).sum(axis=(-1, -2))
    assert (ties > 1).mean() > 0.3, (ties > 1).mean()
    _assert_close(*_window_pair("max_stem_3x3_s2_p1"))
    product = itertools.product
    monkeypatch.setattr(itertools, "product", lambda *a: reversed(list(product(*a))))
    with pytest.raises(AssertionError, match="grad 0"):
        _assert_close(*_window_pair("max_stem_3x3_s2_p1"))


# ---------------------------------------------------------------------------
# var, atan2, cumsum, cumprod, digamma, copy_with_setitem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims,correction", [((1,), 1), ((1,), 0), ((0, 2), 1), ((0, 1, 2), 0)])
def test_var_grad_matches_jax_vjp(dims, correction):
    x = _f(np.random.RandomState(len(dims) + correction), 3, 5, 4) * 3 + 1
    _assert_close(*_vjp_pair("VAR", lambda a: prims.var_prim(a, dims, correction=correction), [x], (0,),
                             static=(dims,), kw={"correction": correction}))


def test_atan2_grad_matches_jax_vjp():
    rng = np.random.RandomState(3)
    a, b = _f(rng, 4, 6), _f(rng, 4, 6)
    _assert_close(*_vjp_pair("ATAN2", prims.atan2, [a, b], (0, 1)))


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_cumsum_grad_matches_jax_vjp(dim):
    x = _f(np.random.RandomState(4), 5, 7)
    _assert_close(*_vjp_pair("CUMSUM", lambda a: prims.cumsum(a, dim), [x], (0,), static=(dim,)))


def _with_zeros(kind):
    x = 0.5 + np.random.RandomState(5).rand(4, 6).astype(np.float32)
    if kind == "one_zero":
        x[1, 2] = 0
    elif kind == "two_zeros":
        x[2, 1] = 0
        x[2, 4] = 0
    elif kind == "first_zero":
        x[3, 0] = 0
    x[0] *= -1  # a negative row
    return x


@pytest.mark.parametrize("kind", ["no_zero", "one_zero", "two_zeros", "first_zero"])
@pytest.mark.parametrize("dim", [1, 0])
def test_cumprod_grad_matches_jax_vjp(kind, dim):
    _assert_close(*_vjp_pair("CUMPROD", lambda a: prims.cumprod(a, dim), [_with_zeros(kind)], (0,),
                             static=(dim,)))


def test_digamma_grad_matches_jax_vjp():
    x = np.array([-2.5, -1.3, -0.3, 0.05, 0.2, 0.5, 0.7, 1.0, 1.5, 3.3, 7.0, 40.0, 1e3],
                 dtype=np.float32)
    _assert_close(*_vjp_pair("DIGAMMA", prims.digamma, [x], (0,)))


SETITEM_CASES = {
    "slices": ((slice(1, 3), slice(None)), (2, 6)),
    "int_and_slice": ((2, slice(1, 5)), (4,)),
    "broadcast_value": ((slice(0, 4), slice(2, 4)), (1, 2)),
    "index_tensor": (("index",), (2, 6)),
    "scalar_value": ((slice(1, 2), 3), None),
}


@pytest.mark.parametrize("case", sorted(SETITEM_CASES))
def test_copy_with_setitem_grad_matches_jax_vjp(case):
    """An index tensor in the key is a program input (a proxy in the
    trace), as it is where a model indexes with its data."""
    key, v_shape = SETITEM_CASES[case]
    rng = np.random.RandomState(6)
    a, idx = _f(rng, 5, 6), np.array([0, 3])
    v = _f(rng, *v_shape) if v_shape else 2.5
    impl = jaxex.ex.get_impl(JPrimIDs.COPY_WITH_SETITEM)
    jkey = tuple(jnp.asarray(idx) if k == "index" else k for k in key)
    diff = (0, 1) if v_shape else (0,)
    jout, vjp = jax.vjp(lambda x, *y: impl(x, jkey, *(y or (v,))), jnp.asarray(a),
                        *([jnp.asarray(v)] if v_shape else []))
    r = np.random.RandomState(0).randn(*jout.shape).astype(np.float32)
    ref = (float(jnp.sum(jout * r)), [np.asarray(g) for g in vjp(jnp.asarray(r))])

    def loss(x, y, i, r):
        k = tuple(i if k == "index" else k for k in key)
        return tl.sum(prims.copy_with_setitem(x, k, y if v_shape else v) * r)

    tval, tg = tt.value_and_grad(loss, argnums=diff)(torch.tensor(a), torch.tensor(v), torch.tensor(idx),
                                                     torch.tensor(r))
    _assert_close((float(tval), [tg[0][i].numpy() for i in diff]), ref)


def test_only_unreached_ops_fall_back():
    """thunder_tpu's JAX_VJP_FALLBACK less the nine rules written here and
    dist.ring_attention: the ops whose gradient comes from torch.func.vjp."""
    assert autodiff.VJP_FALLBACK_OPS == {prims.PrimIDs.GROUPED_MM, prims.PrimIDs.EINSUM,
                                         prims.PrimIDs.SCATTER}
    for name in ("CONVOLUTION", "CONV_TRANSPOSE", "REDUCE_WINDOW", "VAR", "ATAN2", "CUMSUM", "CUMPROD",
                 "DIGAMMA", "COPY_WITH_SETITEM"):
        assert autodiff.has_grad_rule(prims.PrimIDs[name]), name
