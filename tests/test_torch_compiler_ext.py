"""The port's compiler-side extension surface against thunder_tpu's, on the CPU.

* core/patterns.py: thunder_tpu's TestPatterns and TestPatternChained cases
  (tests/test_extensions.py) on both packages' traces of the same functions:
  the same matches (ids and positions), and the rewritten programs' outputs
  on the same seeded inputs within 1e-6 of each other (f32, one op order).
* core/vjp_utils.py: the augmented-forward and backward traces of mul, run
  against jax.vjp of thunder_tpu's; a symbol without a rule raises
  LookupError in both.
* tt.custom_op (_custom_op.py): thunder_tpu's TestCustomOp and
  TestCustomOpArity cases with a torch implementation beside thunder_tpu's
  jax one, outputs and gradients within 1e-6; ``like=``/``meta=`` exactly
  one.
* jit's options (core/options.py): the errors thunder_tpu raises without its
  interpreter frontend, raised by the port too; "no caching" compiles every
  call; the parts the port has not yet raise naming them.
* core/trace_exec.py: a printed trace exec'd in make_trace_namespace()
  reproduces the compiled program's outputs bit for bit.
* core/einsum_utils.py: expand_ellipsis and output_shape equal thunder_tpu's
  on a sweep of specs, errors included.
* the vjp fallback (transforms/autodiff.py: GROUPED_MM, EINSUM, SCATTER via
  torch.func.vjp): value and gradients of sum(op(...) * r) against jax.vjp
  of thunder_tpu's jaxex implementations (jitted), value within 1e-5 of
  max(1, |ref|), each gradient within 1e-5 of its tensor's largest (f32, the
  same math in another order); ltorch.einsum's decomposition too.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu.ops import ltorch as jl
from thunder_tpu_torch.ops import ltorch as tl

TOL = 1e-6
VALUE_TOL = 1e-5
GRAD_TOL = 1e-5


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.rand(*s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# patterns
# ---------------------------------------------------------------------------


def _traces(fn, arrays):
    """Both packages' flattened traces of fn on the same inputs."""
    from thunder_tpu.core.transform_common import flatten_to_prims as jflat
    from thunder_tpu_torch.core.transform_common import flatten_to_prims as tflat

    jtrc, *_ = tj.acquire_trace(fn, tuple(jnp.asarray(a) for a in arrays), {})
    ttrc = tt.acquire_trace(fn, tuple(torch.tensor(a) for a in arrays), {})
    return jflat(jtrc), tflat(ttrc)


def _pattern(pkg, **kw):
    patterns = importlib.import_module(f"{pkg}.core.patterns")
    PrimIDs = importlib.import_module(f"{pkg}.core.prims").PrimIDs
    return (patterns.Pattern()
            .match_op(PrimIDs.MUL, bind_out="prod", **kw.get("mul", {}))
            .match_op(PrimIDs.ADD, where=patterns.uses("prod"), **kw.get("add", {})))


def _match_summary(trc, matches):
    return [([trc.bound_symbols[i].sym.id.name for i in idx], idx) for _, idx in matches]


def _escapes(a, b, c):
    prod = a * b
    return prod + c, prod * 2.0  # prod escapes the match


@pytest.mark.parametrize("name,fn,n", [
    ("mul_add_chain", lambda a, b, c: a * b + c, 1),
    ("disconnected", lambda a, b, c: (a * b, c + c), 0),
    ("intermediate_escapes", _escapes, 0),
])
def test_pattern_matches_equal_thunder_tpus(name, fn, n):
    jtrc, ttrc = _traces(fn, _arrays(0, (4,), (4,), (4,)))
    jm = _match_summary(jtrc, _pattern("thunder_tpu").match(jtrc))
    tm = _match_summary(ttrc, _pattern("thunder_tpu_torch").match(ttrc))
    assert tm == jm
    assert len(tm) == n


def _replace_and_run(pkg, trc, arrays, to_value):
    prims = importlib.import_module(f"{pkg}.core.prims")
    dce = importlib.import_module(f"{pkg}.core.transform_common").dce
    passes = importlib.import_module(f"{pkg}.executors.passes")
    extend = importlib.import_module(f"{pkg}.extend")

    def fma(a, b, c, prod=None):
        return prims.add(prims.mul(prims.mul(a, b), 1.0), c)

    p = _pattern(pkg, mul={"bind_args": ("a", "b")}, add={"bind_args": (None, "c")})
    new_trc = p.replace(trc, fma)
    claimed = passes.transform_for_execution(dce(new_trc), extend.resolve_executors(None))
    return np.asarray(claimed.python_callable()(*[to_value(a) for a in arrays]))


@pytest.mark.parametrize("name,fn,n_in", [
    ("replace_preserves_numerics", lambda a, b, c: a * b + c, 3),
    ("chained_matches_rename_into_splices", lambda a, b, c, d, e: (a * b + c) * d + e, 5),
])
def test_pattern_replace_matches_thunder_tpu(name, fn, n_in):
    arrays = _arrays(1, *[(4,)] * n_in)
    jtrc, ttrc = _traces(fn, arrays)
    want = _replace_and_run("thunder_tpu", jtrc, arrays, jnp.asarray)
    got = _replace_and_run("thunder_tpu_torch", ttrc, arrays, torch.tensor)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, fn(*arrays), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# vjp_utils
# ---------------------------------------------------------------------------


def test_make_aug_forward_and_backward_runs_like_jax_vjp():
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.core.transform_common import flatten_to_prims
    from thunder_tpu_torch.core.vjp_utils import make_aug_forward_and_backward
    from thunder_tpu_torch.executors.passes import transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors

    x, y, g = _arrays(2, (3, 4), (3, 4), (3, 4))
    trc = flatten_to_prims(tt.acquire_trace(lambda a, b: tl.mul(a, b), (torch.tensor(x), torch.tensor(y)), {}))
    mul = next(b for b in trc.bound_symbols if b.sym.id == PrimIDs.MUL)
    fwd_trc, bwd_trc = make_aug_forward_and_backward(mul)
    assert "augmented_forward" in fwd_trc.name_of_fn() and "backward" in bwd_trc.name_of_fn()
    assert "def " in str(fwd_trc) and "def " in str(bwd_trc)
    ex = resolve_executors(None)
    out, residuals = transform_for_execution(fwd_trc, ex).python_callable()(torch.tensor(x), torch.tensor(y))
    grads = transform_for_execution(bwd_trc, ex).python_callable()(*residuals, torch.tensor(g))
    jout, vjp = jax.vjp(jnp.multiply, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=TOL)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_missing_rule_raises_lookup_error_in_both():
    from thunder_tpu.core.symbol import Symbol as JSymbol
    from thunder_tpu.core.vjp_utils import make_aug_forward_and_backward as jmake
    from thunder_tpu_torch.core.symbol import Symbol
    from thunder_tpu_torch.core.vjp_utils import make_aug_forward_and_backward

    for sym_cls, make, one in ((JSymbol, jmake, jnp.ones(())), (Symbol, make_aug_forward_and_backward,
                                                                  torch.ones(()))):
        sym = sym_cls("no_rule_op", lambda x: x, id="test.torch_port_no_rule_op", is_prim=True)
        with pytest.raises(LookupError):
            make(sym.bind(one, output=one))


# ---------------------------------------------------------------------------
# custom ops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def swish4():
    """The swish4 op of thunder_tpu's TestCustomOp on both packages."""
    @tj.custom_op("portparity.swish4", like=lambda x: x)
    def jswish(x):
        return x * jax.nn.sigmoid(4.0 * x)

    @jswish.register_vjp
    def jswish_vjp(x, g):
        s = jax.nn.sigmoid(4.0 * x)
        return g * (s + 4.0 * x * s * (1.0 - s))

    @tt.custom_op("portparity.swish4", like=lambda x: x)
    def tswish(x):
        return x * torch.sigmoid(4.0 * x)

    @tswish.register_vjp
    def tswish_vjp(x, g):
        s = torch.sigmoid(4.0 * x)
        return g * (s + 4.0 * x * s * (1.0 - s))

    return jswish, tswish


def test_custom_op_forward_and_vjp_match_thunder_tpu(swish4):
    from thunder_tpu.transforms.autodiff import ThunderValueAndGrad as JVAG

    jswish, tswish = swish4
    x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    jout = np.asarray(tj.jit(lambda x: jswish(x))(jnp.asarray(x)))
    cf = tt.jit(lambda x: tswish(x))
    np.testing.assert_allclose(cf(torch.tensor(x)).numpy(), jout, rtol=0, atol=TOL)
    claimed = [b.impl for b in tt.last_traces(cf)[-1].bound_symbols if b.sym.id == "portparity.swish4"]
    assert claimed == [tswish.fn]
    _, jg = JVAG(lambda x: jl.sum(jswish(x)), argnums=0)(jnp.asarray(x))
    _, tg = tt.value_and_grad(lambda x: tl.sum(tswish(x)), argnums=0)(torch.tensor(x))
    np.testing.assert_allclose(tg[0][0].numpy(), np.asarray(jg[0][0]), rtol=0, atol=TOL)


def test_custom_op_requires_exactly_one_spec():
    for pkg in (tj, tt):
        with pytest.raises(TypeError):
            pkg.custom_op("portparity.bad")(lambda x: x)
        with pytest.raises(TypeError):
            pkg.custom_op("portparity.bad2", like=lambda x: x, meta=lambda x: x)(lambda x: x)


def test_custom_op_optional_arg_two_arities_match_thunder_tpu():
    from thunder_tpu.transforms.autodiff import ThunderValueAndGrad as JVAG

    def vjp(*args):
        g = args[-1]
        if len(args) == 3:
            return g * 2.0, g
        return g * 2.0

    ops = []
    for pkg in (tj, tt):
        @pkg.custom_op("portparity.scale_shift", like=lambda x, s=None: x)
        def scale_shift(x, s=None):
            return x * 2.0 + (s if s is not None else 0.0)

        scale_shift.register_vjp(vjp)
        ops.append(scale_shift)
    x, s = _arrays(4, (4,), (4,))
    _, jg = JVAG(lambda x, s: jl.sum(jl.add(ops[0](x), ops[0](x, s))), argnums=(0, 1))(jnp.asarray(x),
                                                                                        jnp.asarray(s))
    _, tg = tt.value_and_grad(lambda x, s: tl.sum(tl.add(ops[1](x), ops[1](x, s))), argnums=(0, 1))(
        torch.tensor(x), torch.tensor(s))
    for i, want in ((0, 4.0), (1, 1.0)):
        np.testing.assert_allclose(tg[0][i].numpy(), np.asarray(jg[0][i]), rtol=0, atol=0)
        np.testing.assert_allclose(tg[0][i].numpy(), want)


def test_custom_op_aug_fwd_and_bwd_match_thunder_tpu():
    """Full control: register_aug_fwd saves a residual (here the op's
    output), register_bwd computes the input gradient from it."""
    from thunder_tpu.transforms.autodiff import ThunderValueAndGrad as JVAG, VJPResult as JRes
    from thunder_tpu_torch.transforms.autodiff import VJPResult as TRes

    grads = []
    for pkg, lt, res_cls, exp in ((tj, jl, JRes, jnp.exp), (tt, tl, TRes, torch.exp)):
        @pkg.custom_op("portparity.expm", like=lambda x: x)
        def expm(x, _exp=exp):
            return _exp(x) - 1.0

        @expm.register_aug_fwd
        def expm_aug(x, _op=expm, _res=res_cls):
            out = _op(x)
            return _res(out, (out,))

        @expm.register_bwd
        def expm_bwd(out, g, _lt=lt):
            return _lt.mul(g, _lt.add(out, 1.0))

        grads.append((pkg, lt, expm))
    x = np.random.RandomState(12).randn(3, 5).astype(np.float32)
    (_, jlt, jop), (_, tlt, top) = grads
    jv, jg = JVAG(lambda x: jlt.sum(jop(x)), argnums=0)(jnp.asarray(x))
    tv, tg = tt.value_and_grad(lambda x: tlt.sum(top(x)), argnums=0)(torch.tensor(x))
    assert abs(float(tv) - float(jv)) <= TOL * max(1.0, abs(float(jv)))
    np.testing.assert_allclose(tg[0][0].numpy(), np.asarray(jg[0][0]), rtol=0, atol=TOL * np.exp(np.abs(x)).max())
    np.testing.assert_allclose(tg[0][0].numpy(), np.exp(x), rtol=1e-6)


# ---------------------------------------------------------------------------
# jit options
# ---------------------------------------------------------------------------


class _JNet(tj.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = tj.nn.Linear(8, 4, seed=0)

    def forward(self, x):
        return self.fc(x)


def _tnet():
    from thunder_tpu_torch import nn

    return nn.Linear(8, 4, device="cpu")


@pytest.mark.parametrize("kw,exc,match", [
    (dict(sharp_edges="error"), ValueError, "sharp_edges checking requires the bytecode-interpreter frontend"),
    (dict(sharp_edges="warn"), ValueError, "sharp_edges checking requires the bytecode-interpreter frontend"),
], ids=["sharp_edges_error", "sharp_edges_warn"])
def test_jit_raises_where_thunder_tpu_raises(kw, exc, match):
    for pkg in (tj, tt):
        with pytest.raises(exc, match=match):
            pkg.jit(lambda x: x, **kw)


@pytest.mark.parametrize("cache", ["symbolic values", "same input"])
def test_jit_module_refuses_callable_only_cache_modes_as_thunder_tpu(cache):
    for make, pkg in ((_JNet, tj), (_tnet, tt)):
        with pytest.raises(ValueError, match="only supported for plain callables"):
            pkg.jit(make(), cache=cache)


@pytest.mark.parametrize("cache", ["symbolic values", "same input"])
def test_jit_callable_cache_modes_name_the_interpreter_frontend(cache):
    with pytest.raises(NotImplementedError, match="bytecode-interpreter frontend.*ROADMAP A7"):
        tt.jit(lambda x: x, cache=cache)


def test_jit_unknown_cache_option_raises():
    from thunder_tpu.core.options import resolve_cache_option as jresolve
    from thunder_tpu_torch.core.options import resolve_cache_option

    for resolve in (jresolve, resolve_cache_option):
        with pytest.raises(ValueError, match="unknown cache option"):
            resolve("sometimes")
    with pytest.raises(ValueError, match="unknown cache option"):
        tt.jit(lambda x: x, cache="sometimes")


def test_debug_options_registry_and_check_traces():
    from thunder_tpu.core.options import DebugOptions as JDebug
    from thunder_tpu_torch.core.options import DebugOptions

    assert DebugOptions.show_options() == JDebug.show_options()
    for cls in (JDebug, DebugOptions):
        with pytest.raises(ValueError, match="unknown debug option"):
            cls(no_such_option=True)
        with pytest.raises(TypeError, match="expects bool"):
            cls(check_traces="yes")
    f = tt.jit(lambda x: tl.mul(x, 2.0), debug_options=DebugOptions())
    assert torch.equal(f(torch.ones(2)), torch.full((2,), 2.0))
    with pytest.raises(NotImplementedError, match="analysis/.*ROADMAP A6"):
        tt.jit(lambda x: x, debug_options=DebugOptions(check_traces=True))
    with pytest.raises(NotImplementedError, match="interpreter frontend"):
        tt.jit(lambda x: x, debug_options=DebugOptions(show_interpreter_log=True))


def test_no_caching_compiles_every_call_and_matches_thunder_tpu():
    x = np.random.RandomState(5).rand(3, 8).astype(np.float32)
    jm = _JNet()
    jf = tj.jit(jm, cache="no caching")
    tm = _tnet()
    tlg_load = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(tlg_load["fc.weight"]))
        tm.bias.copy_(torch.tensor(tlg_load["fc.bias"]))
    tf = tt.jit(tm, cache="no caching")
    outs = [tf(torch.tensor(x)) for _ in range(3)]
    assert tt.cache_misses(tf) == 3 and tt.cache_hits(tf) == 0
    for o in outs:
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jf(jnp.asarray(x))), rtol=0, atol=TOL)
    g = tt.jit(lambda a: tl.mul(a, 3.0))
    g(torch.tensor(x)), g(torch.tensor(x))
    assert (tt.cache_misses(g), tt.cache_hits(g)) == (1, 1)


# ---------------------------------------------------------------------------
# trace_exec
# ---------------------------------------------------------------------------


def _program(x, w, b):
    h = tl.softmax(tl.linear(x, w, b), -1)
    return tl.sum(tl.reshape(h * h, (-1,)), 0), tl.transpose(h, 0, 1)


def test_printed_trace_reexecutes_in_the_namespace():
    from thunder_tpu_torch.core.codeutils import ContextInterner
    from thunder_tpu_torch.core.trace_exec import make_trace_namespace

    x, w, b = _arrays(6, (5, 8), (3, 8), (3,))
    args = (torch.tensor(x), torch.tensor(w), torch.tensor(b))
    cf = tt.jit(_program)
    want = cf(*args)
    trc = tt.last_traces(cf)[0]
    src = trc.python()
    ns = make_trace_namespace()
    ns.update(trc._build_lines(ContextInterner())[1].ctx)
    exec(compile(src, "<printed>", "exec"), ns)
    got = ns[trc.name_of_fn()](*args)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    jwant = tj.jit(lambda x, w, b: (jl.sum(jl.reshape(jl.softmax(jl.linear(x, w, b), -1) ** 2, (-1,)), 0),
                                    jl.transpose(jl.softmax(jl.linear(x, w, b), -1), 0, 1)))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    for g, w_ in zip(got, jwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# einsum_utils
# ---------------------------------------------------------------------------

EINSUM_SPECS = [
    ("ij,jk->ik", [(2, 3), (3, 4)]),
    ("ij,jk", [(2, 3), (3, 4)]),
    ("...ij,...jk->...ik", [(5, 2, 3), (3, 4)]),
    ("...ij,...jk", [(1, 2, 3), (6, 3, 4)]),
    ("b i j , b j k -> b i k", [(2, 3, 4), (2, 4, 5)]),
    ("ii->i", [(3, 3)]),
    ("ii", [(3, 3)]),
    ("i,j->ij", [(3,), (4,)]),
    ("...,...->...", [(2, 1, 4), (3, 1)]),
    ("a...c,c...->a...", [(2, 5, 6, 3), (3, 5, 6)]),
    ("ij,jk,kl->il", [(2, 3), (3, 4), (4, 5)]),
    ("ij->", [(2, 3)]),
    ("ij,jk->ik", [(2, 3)]),  # too few operands
    ("ijk,jk->i", [(2, 3), (3, 4)]),  # rank mismatch
]


@pytest.mark.parametrize("spec,shapes", EINSUM_SPECS, ids=[f"{i}" for i in range(len(EINSUM_SPECS))])
def test_einsum_utils_match_thunder_tpus(spec, shapes):
    from thunder_tpu.core import einsum_utils as je
    from thunder_tpu_torch.core import einsum_utils as te

    def outcome(mod):
        try:
            return ("ok", mod.expand_ellipsis(spec, [len(s) for s in shapes]), mod.output_shape(spec, shapes))
        except ValueError as e:
            return ("error", str(e))

    assert outcome(te) == outcome(je)


# ---------------------------------------------------------------------------
# the vjp fallback: GROUPED_MM, EINSUM, SCATTER
# ---------------------------------------------------------------------------


def _assert_grads(got_value, got_grads, want_value, want_grads):
    assert abs(got_value - want_value) <= VALUE_TOL * max(1.0, abs(want_value))
    for g, w in zip(got_grads, want_grads):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= GRAD_TOL * max(1.0, np.abs(w).max())


def _jax_ref(impl, arrays, argnums, static_before=(), static_after=(), cot_seed=7):
    """(value, grads) of sum(impl(*static_before, *arrays, *static_after) * r)
    by jax.vjp, jitted."""
    out = impl(*static_before, *[jnp.asarray(a) for a in arrays], *static_after)
    r = np.random.RandomState(cot_seed).randn(*out.shape).astype(np.float32)

    @jax.jit
    def ref(*diff):
        full = [jnp.asarray(a) for a in arrays]
        for i, d in zip(argnums, diff):
            full[i] = d
        o, vjp = jax.vjp(lambda *ds: impl(*static_before, *[
            ds[argnums.index(i)] if i in argnums else full[i] for i in range(len(full))], *static_after),
            *diff)
        return jnp.sum(o * r), vjp(jnp.asarray(r))

    v, gs = ref(*[jnp.asarray(arrays[i]) for i in argnums])
    return float(v), gs, r


def _jaxex(name):
    from thunder_tpu.core.prims import PrimIDs
    from thunder_tpu.executors import jaxex

    return jaxex.ex.get_impl(PrimIDs[name])


@pytest.mark.parametrize("spec,shapes", [
    ("ii->i", [(4, 4)]),
    ("bii,bj->bj", [(2, 3, 3), (2, 5)]),
    ("iij,jk->ik", [(3, 3, 4), (4, 2)]),
], ids=["diag", "batched_trace", "partial_diag"])
def test_einsum_prim_grads_match_jax(spec, shapes):
    from thunder_tpu_torch.core import prims

    arrays = _arrays(8, *shapes)
    argnums = tuple(range(len(arrays)))
    jv, jg, r = _jax_ref(_jaxex("EINSUM"), arrays, argnums, static_before=(spec,))
    vag = tt.value_and_grad(lambda *ops: tl.sum(tl.mul(tl.einsum(spec, *ops[:-1]), ops[-1])),
                            argnums=argnums)
    tv, tg = vag(*[torch.tensor(a) for a in arrays], torch.tensor(r))
    _assert_grads(float(tv), [tg[0][i].numpy() for i in argnums], jv, jg)
    bwd = tt.last_backward_traces(vag)[-1].bound_symbols
    assert any(b.sym.id == "torch.vjp_fallback" and b.args[0] == prims.PrimIDs.EINSUM for b in bwd)


@pytest.mark.parametrize("spec,shapes", [
    ("bij,bjk->bik", [(2, 3, 4), (2, 4, 5)]),
    ("ij,kj->ik", [(3, 4), (5, 4)]),
    ("...ij,jk->...ik", [(2, 3, 4), (4, 5)]),
    ("ij,jk,kl->il", [(2, 3), (3, 4), (4, 5)]),
], ids=["bmm", "transposed", "ellipsis", "chain"])
def test_ltorch_einsum_matches_thunder_tpu(spec, shapes):
    from thunder_tpu.transforms.autodiff import ThunderValueAndGrad as JVAG

    arrays = _arrays(9, *shapes)
    argnums = tuple(range(len(arrays)))
    out = np.einsum(spec, *arrays)
    r = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    jv, jg = JVAG(lambda *ops: jl.sum(jl.mul(jl.einsum(spec, *ops[:-1]), ops[-1])), argnums=argnums)(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(r))
    tv, tg = tt.value_and_grad(lambda *ops: tl.sum(tl.mul(tl.einsum(spec, *ops[:-1]), ops[-1])),
                               argnums=argnums)(*[torch.tensor(a) for a in arrays], torch.tensor(r))
    _assert_grads(float(tv), [tg[0][i].numpy() for i in argnums], float(jv), [jg[0][i] for i in argnums])


def test_scatter_grads_match_jax():
    x, v = _arrays(10, (4, 5), (2, 5))
    idx = np.array([[1, 0, 3, 1, 2], [3, 2, 0, 0, 1]], dtype=np.int64)
    jv, jg, r = _jax_ref(lambda a, val: _jaxex("SCATTER")(a, jnp.asarray(idx), val, 0), [x, v], (0, 1))
    tv, tg = tt.value_and_grad(lambda a, val, r: tl.sum(tl.mul(tl.scatter(a, 0, torch.tensor(idx), val), r)),
                               argnums=(0, 1))(torch.tensor(x), torch.tensor(v), torch.tensor(r))
    _assert_grads(float(tv), [tg[0][0].numpy(), tg[0][1].numpy()], jv, jg)


@pytest.mark.parametrize("sizes", [(2, 0, 3), (1, 2, 2), (3, 1, 0)], ids=["empty_group", "short", "tail_rows"])
def test_grouped_mm_grads_match_jax(sizes):
    a, b = _arrays(11, (7, 4), (3, 4, 5))
    gs = np.array(sizes, dtype=np.int32)
    jv, jg, r = _jax_ref(lambda a_, b_: _jaxex("GROUPED_MM")(a_, b_, jnp.asarray(gs)), [a, b], (0, 1))
    tv, tg = tt.value_and_grad(lambda a_, b_, r_: tl.sum(tl.mul(tl.grouped_mm(a_, b_, torch.tensor(gs)), r_)),
                               argnums=(0, 1))(torch.tensor(a), torch.tensor(b), torch.tensor(r))
    _assert_grads(float(tv), [tg[0][0].numpy(), tg[0][1].numpy()], jv, jg)


def test_chip_smoke_extensions_gradient_bound_catches_a_wrong_fallback(monkeypatch):
    """chip_smoke.py's extensions check, on the CPU: the port's step-1
    gradients of ExtensionsNet against torch autograd's through its
    plain-torch version within EXT_GRAD_RTOL of each tensor's norm; with the
    einsum's gradient scaled by 1.1 in the vjp fallback (the impl it
    differentiates returns the same values) fc1's gradients part past it."""
    import chip_smoke
    from thunder_tpu_torch.core.prims import PrimIDs
    from thunder_tpu_torch.executors import torchex

    rng = np.random.RandomState(0)
    batch = tuple(torch.from_numpy(rng.randn(chip_smoke.EXT_B, chip_smoke.EXT_D).astype(np.float32))
                  for _ in range(2))

    def gaps():
        net = chip_smoke.ExtensionsNet(torch.device("cpu"), 0)
        return chip_smoke.grads_rel(*chip_smoke.extensions_step1_grads(tt, net, batch))

    assert max(gaps().values()) <= chip_smoke.EXT_GRAD_RTOL
    fn, checker = torchex.ex.implmap[PrimIDs.EINSUM]

    def scaled(*args, **kwargs):
        y = fn(*args, **kwargs)
        return y * 1.1 - y.detach() * 0.1

    monkeypatch.setitem(torchex.ex.implmap, PrimIDs.EINSUM, (scaled, checker))
    bad = gaps()
    assert min(bad["fc1.weight"], bad["fc1.bias"]) > chip_smoke.EXT_GRAD_RTOL
