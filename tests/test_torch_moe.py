"""The port's Mixture-of-Experts slice against thunder_tpu, on the CPU.

Weights are carried across from thunder_tpu by ``load_jax_params`` and inputs
drawn with numpy; f32 throughout. On the CPU the cuda executor's
``grouped_mlp`` runs its plain version; the traces must still show the
executor claiming ``thunder.grouped_mlp`` (and its grad rule).

* top-k: equal values lowest index first, as lax.top_k: indices and values
  equal to thunder_tpu's.
* ``MoEMLP`` on both roads against thunder_tpu's, in the four scenarios of
  tests/test_moe_longctx.py:43-85 (drop-free, over capacity, E = 6, and the
  zero router whose ties send every token to expert 0), to 1e-5: the same
  f32 math in another summation order.
* ``grouped_mlp`` forward and grad against pallasex's kernel in interpret
  mode (``TT_GROUPED_KERNEL=1`` on the JAX side, as
  tests/test_moe_longctx.py:101-135 sets it), ragged fill [16, 0, 7, 16],
  atol 1e-5 and rtol 1e-4, the bars of that test; the port's claimed grads
  against its own decomposition at the same bars.
* ``MoEGPT`` (tiny-llama2 widths, E = 4, H = 160) logits to 1e-4 and loss
  to 1e-5 relative, as tests/test_torch_serving.py holds GPT's logits.
* ``GPTInference.generate`` and ``ServingEngine`` greedy streams equal to
  thunder_tpu's (tests/test_inference.py:72, tests/test_serving.py:433).
* 4 f32 TrainSteps on each road (capacity factor 1.0) against
  thunder_tpu's: losses to 1e-5 relative.
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
from thunder_tpu.inference import GPTInference as JaxGPTInference
from thunder_tpu.models import moe as jmoe
from thunder_tpu.models.litgpt import Config as JaxConfig
from thunder_tpu.ops import ltorch as jlt
from thunder_tpu.serving import ServingEngine as JaxServingEngine
from thunder_tpu.training import TrainStep as JaxTrainStep
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.inference import GPTInference
from thunder_tpu_torch.models import moe as tmoe
from thunder_tpu_torch.models.litgpt import Config, load_jax_params
from thunder_tpu_torch.nn import functional_params
from thunder_tpu_torch.ops import ltorch as tlt
from thunder_tpu_torch.serving import ServingEngine
from thunder_tpu_torch.training import TrainStep
from thunder_tpu_torch.transforms.autocast import AutocastTransform

pytestmark = pytest.mark.moe

TOL = 1e-5
MAX_SEQ = 64


def _carry(jmodel, tmodel):
    load_jax_params(tmodel, {k: np.asarray(p.data) for k, p in jmodel.named_parameters()})
    return tmodel


# ---------------------------------------------------------------------------
# top-k tie order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [-1, 0])
@pytest.mark.parametrize("kind", ["zeros", "partly_tied"])
def test_topk_tie_order_matches_jax(kind, dim):
    rng = np.random.RandomState(3)
    a = np.zeros((6, 8), np.float32)
    if kind == "partly_tied":
        a = rng.randint(0, 3, (6, 8)).astype(np.float32)  # many equal values
        a[0, :] = [2.5, 1, 2.5, 0, 2.5, 1, 0, 2.5]
    k = 3
    jv, ji = tj.jit(lambda x: jlt.topk(x, k, dim))(jnp.asarray(a))
    tv, ti = tt.jit(lambda x: tlt.topk(x, k, dim))(torch.tensor(a))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if kind == "zeros":
        assert (ti.numpy() == np.arange(k).reshape((1, k) if dim == -1 else (k, 1))).all()


# ---------------------------------------------------------------------------
# MoEMLP on both roads
# ---------------------------------------------------------------------------

SCENARIOS = {
    "drop_free": dict(n_expert=8, n_expert_per_token=2, capacity_factor=None),
    "over_capacity": dict(n_expert=8, n_expert_per_token=2, capacity_factor=0.5),
    "odd_E": dict(n_expert=6, n_expert_per_token=2, capacity_factor=1.0),
    "zero_router": dict(n_expert=4, n_expert_per_token=1, capacity_factor=0.25),
}


def _mlp_pair(scenario, road):
    kw = dict(n_embd=32, intermediate_size=48, dispatch=road, **SCENARIOS[scenario])
    jm = jmoe.MoEMLP(jmoe.MoEConfig(**kw))
    if scenario == "zero_router":
        sd = {k: np.asarray(v).copy() for k, v in jm.state_dict().items()}
        sd["gate.weight"] = np.zeros_like(sd["gate.weight"])
        jm.load_state_dict(sd)
    tm = _carry(jm, tmoe.MoEMLP(tmoe.MoEConfig(**kw), device="cpu"))
    return jm, tm


@pytest.mark.parametrize("road", ["grouped", "dense"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_moe_mlp_matches_jax(scenario, road):
    jm, tm = _mlp_pair(scenario, road)
    x = np.random.RandomState(0).randn(1, 64, 32).astype(np.float32)
    ref = np.asarray(tj.jit(jm)(jnp.asarray(x)))
    tmod = tt.jit(tm)
    out = tmod(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    ids = {b.sym.id for b in tt.last_traces(tmod)[-1].bound_symbols}
    assert ("thunder.grouped_mlp" in ids) == (road == "grouped")
    if scenario == "zero_router":
        # every token ties and goes to expert 0; capacity(64) = 8 keeps 8
        assert tm.capacity(64) == 8
        assert int(np.all(out[0] == 0.0, axis=-1).sum()) == 56
        assert np.all(out[0, :8] != 0.0, axis=-1).all()


def test_grouped_trace_claims_the_kernel():
    _, tm = _mlp_pair("drop_free", "grouped")
    tmod = tt.jit(tm)
    tmod(torch.tensor(np.random.RandomState(1).randn(2, 8, 32).astype(np.float32)))
    claimed = [b for b in tt.last_traces(tmod)[-1].bound_symbols if b.sym.id == "thunder.grouped_mlp"]
    assert len(claimed) == 1 and claimed[0].impl is cudaex._grouped_mlp_impl
    # drop-free at N = 16: every expert's bin holds all 16 tokens
    assert tuple(claimed[0].args[0].shape) == (8, 16, 32)


# ---------------------------------------------------------------------------
# grouped_mlp against pallasex's kernel (interpret mode)
# ---------------------------------------------------------------------------


def _grouped_args(rng, E=4, cap=16, D=32, H=48, fill=(16, 0, 7, 16)):
    """tests/test_moe_longctx.py:_grouped_args: rows past group_sizes[e]
    zero-filled, as the dispatch scatter leaves them."""
    bins = rng.randn(E, cap, D).astype(np.float32)
    for e, n in enumerate(fill):
        bins[e, n:] = 0.0
    s = 1.0 / math.sqrt(D)
    wg = (rng.rand(E, D, H).astype(np.float32) - 0.5) * 2 * s
    wu = (rng.rand(E, D, H).astype(np.float32) - 0.5) * 2 * s
    wd = (rng.rand(E, H, D).astype(np.float32) - 0.5) * s
    return bins, wg, wu, wd, np.asarray(fill, np.int32)


def test_grouped_mlp_matches_pallas_interpret(monkeypatch):
    args = _grouped_args(np.random.RandomState(0))
    monkeypatch.setenv("TT_GROUPED_KERNEL", "1")
    jfn = tj.jit(lambda *a: jlt.grouped_mlp(*a))
    ref = np.asarray(jfn(*map(jnp.asarray, args)))
    # thunder_tpu ran its Pallas kernel (in interpret mode), not the decomposition
    assert [b.impl for b in tj.last_traces(jfn)[-1].bound_symbols
            if b.sym.id == "thunder.grouped_mlp"] == [pallasex._grouped_mlp_claimed]
    tfn = tt.jit(lambda *a: tlt.grouped_mlp(*a))
    out = tfn(*map(torch.tensor, args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)
    claimed = [b for b in tt.last_traces(tfn)[-1].bound_symbols if b.sym.id == "thunder.grouped_mlp"]
    assert len(claimed) == 1 and claimed[0].impl is cudaex._grouped_mlp_impl
    assert not out[1].any() and not out[2, 7:].any()
    # the plain version zeroes rows past group_sizes even where bins are not zero
    b = torch.tensor(args[0]).clone()
    b[2, 7:] = 1.0
    assert not cudaex.grouped_mlp_plain(b, *map(torch.tensor, args[1:]))[2, 7:].any()


def _grouped_loss(lt):
    return lambda b, wg, wu, wd, gs: lt.sum(lt.grouped_mlp(b, wg, wu, wd, gs) ** 2)


def test_grouped_mlp_grad_rule_matches_pallas_and_decomposition(monkeypatch):
    args = _grouped_args(np.random.RandomState(1))
    monkeypatch.setenv("TT_GROUPED_KERNEL", "1")
    (jg, _) = tj.grad(tj.jit(_grouped_loss(jlt)), argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    vag = tt.value_and_grad(_grouped_loss(tlt), argnums=(0, 1, 2, 3))
    _, (tg, _) = vag(*map(torch.tensor, args))
    assert tg[4] is None
    for a, b in zip(tg[:4], jg[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4)
    fwd = [b for b in tt.last_traces(vag)[-1].bound_symbols if b.sym.id == "cuda.grouped_mlp_fwd"]
    bwd = [b for b in tt.last_backward_traces(vag)[-1].bound_symbols if b.sym.id == "cuda.grouped_mlp_bwd"]
    assert len(fwd) == 1 and len(bwd) == 1 and bwd[0].impl is cudaex.grouped_mlp_backward

    monkeypatch.setattr(cudaex, "grouped_mlp_supported", lambda *a: False)
    dvag = tt.value_and_grad(_grouped_loss(tlt), argnums=(0, 1, 2, 3))
    _, (dg, _) = dvag(*map(torch.tensor, args))
    assert "cuda.grouped_mlp_fwd" not in {b.sym.id for b in tt.last_traces(dvag)[-1].bound_symbols}
    for a, b in zip(tg[:4], dg[:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def _proxies(E=4, cap=12, D=32, H=48, dt=None, gdt=None, **shapes):
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.core.proxies import TensorProxy

    dt = dt or dtypes.bfloat16
    gdt = gdt or dtypes.int64
    sh = dict(bins=(E, cap, D), wg=(E, D, H), wu=(E, D, H), wd=(E, H, D), gs=(E,))
    sh.update(shapes)
    return [TensorProxy(shape=sh[k], dtype=gdt if k == "gs" else dt, device="cpu")
            for k in ("bins", "wg", "wu", "wd", "gs")]


def test_grouped_checker_is_hoppers():
    """Claims any cap (pallasex needs cap % 8 == 0) and f32/bf16 with D and
    H multiples of the 16-byte vector; declines f16, mixed dtypes, int
    panels, float group_sizes, misfit shapes and widths off the vector."""
    from thunder_tpu_torch.core import dtypes

    ok = cudaex.grouped_mlp_supported
    assert ok(*_proxies()) and ok(*_proxies(cap=13)) and ok(*_proxies(cap=8, dt=dtypes.float32, D=36, H=20))
    assert ok(*_proxies(gdt=dtypes.int32))
    bad = [_proxies(D=36), _proxies(dt=dtypes.float32, H=22), _proxies(dt=dtypes.int32),
           _proxies(dt=dtypes.float16),
           _proxies(gdt=dtypes.float32), _proxies(wd=(4, 48, 16)), _proxies(gs=(3,)), _proxies(H=0)]
    mixed = _proxies()
    mixed[1] = _proxies(dt=dtypes.float32)[1]
    for args in bad + [mixed]:
        assert not ok(*args)


# chip_smoke.py's GROUPED_SHAPES at Llama-3-1B's widths (E = 8, D = 2048, H =
# 1024): (cap, dtype, route, gate grid, down grid)
GROUPED_PATH_SHAPES = {
    "decode": (8, torch.bfloat16, "decode", (32, 8), (32, 8)),
    "prefill": (1024, torch.bfloat16, "wgmma", (8, 8, 8), (16, 8, 8)),
    "train": (512, torch.float32, "ffma", (16, 4, 8), (16, 4, 8)),
    "ragged_cap": (200, torch.bfloat16, "wgmma", (8, 2, 8), (16, 2, 8)),
}


@pytest.mark.parametrize("case", list(GROUPED_PATH_SHAPES))
def test_grouped_plan_routes_each_path_shape(case):
    """bf16 decode (cap <= 8) streams column slices of the panels, other bf16
    caps take the wgmma tiles, f32 the register-blocked FFMA tiles; the grids
    and the h scratch at the paths' shapes."""
    cap, dt, route, gate, down = GROUPED_PATH_SHAPES[case]
    plan = cudaex.grouped_mlp_plan(8, cap, 2048, 1024, dt)
    assert plan["route"] == route and plan["code"] == {"ffma": 0, "wgmma": 1, "decode": 2}[route]
    assert plan["gate"]["grid"] == gate and plan["down"]["grid"] == down
    assert plan["scratch"] == {"h": ((8, cap, 1024), dt)}
    assert plan["gate"]["threads"] == (384 if route == "wgmma" else 256) == plan["down"]["threads"]


def test_grouped_plan_is_sized_from_cap_not_group_sizes():
    """The plan takes no group_sizes: the grid follows cap (blocks past a
    group's rows exit on the card), so a captured graph replays for any
    sizes. Row blocks are 128 rows; bf16 caps up to 8 take the decode route
    (one block a column slice and expert), f32 never does."""
    import inspect

    assert list(inspect.signature(cudaex.grouped_mlp_plan).parameters) == ["E", "cap", "D", "H", "dtype"]
    for cap in (9, 128, 129, 200, 1024):
        for dt in (torch.bfloat16, torch.float32):
            plan = cudaex.grouped_mlp_plan(3, cap, 64, 96, dt)
            assert plan["gate"]["grid"][1:] == plan["down"]["grid"][1:] == (-(-cap // 128), 3)
            assert plan["gate"]["tile"][0] == 128
    for cap in (1, 8):
        assert cudaex.grouped_mlp_plan(3, cap, 64, 96, torch.bfloat16)["route"] == "decode"
        plan = cudaex.grouped_mlp_plan(3, cap, 64, 96, torch.float32)
        assert plan["route"] == "ffma" and plan["gate"]["grid"] == (2, 1, 3) and plan["down"]["grid"] == (1, 1, 3)
    assert cudaex.grouped_mlp_plan(3, 8, 64, 96, torch.bfloat16)["gate"]["grid"] == (3, 3)


# ---------------------------------------------------------------------------
# MoEGPT: logits, loss, generation, serving, training
# ---------------------------------------------------------------------------

MOE_KW = dict(intermediate_size=160, n_expert=4, n_expert_per_token=2)


def _gpt_pair(n_layer=3, **moe_kw):
    jcfg = JaxConfig.from_name("tiny-llama2", block_size=MAX_SEQ, n_layer=n_layer)
    cfg = Config.from_name("tiny-llama2", block_size=MAX_SEQ, n_layer=n_layer)
    kw = {**MOE_KW, **moe_kw}
    jm = jmoe.MoEGPT(jcfg, jmoe.MoEConfig(n_embd=cfg.n_embd, **kw), dtype=jnp.float32)
    tm = tmoe.MoEGPT(cfg, tmoe.MoEConfig(n_embd=cfg.n_embd, **kw), torch.float32, device="cpu")
    return jm, _carry(jm, tm)


@pytest.fixture(scope="module")
def gpt_pair():
    return _gpt_pair()


def test_moegpt_logits_and_loss_match_jax(gpt_pair):
    jm, tm = gpt_pair
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 320, (2, 16)).astype(np.int32)
    tgt = rng.randint(0, 320, (2, 16)).astype(np.int32)
    ref = np.asarray(tj.jit(jm)(jnp.asarray(idx)))
    ref_loss = float(tj.jit(jm)(jnp.asarray(idx), jnp.asarray(tgt)))

    def fwd(params, *a):
        with functional_params(tm, params):
            return tm(*a)

    params = {k: p.detach() for k, p in tm.named_parameters()}
    out = tt.jit(fwd)(params, torch.tensor(idx)).numpy()
    loss = float(tt.jit(fwd)(params, torch.tensor(idx), torch.tensor(tgt)))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(loss, ref_loss, rtol=TOL)


def test_moe_generate_matches_jax(gpt_pair):
    jm, tm = gpt_pair
    prompt = np.random.RandomState(2).randint(0, 320, (2, 8)).astype(np.int32)
    ref, _ = JaxGPTInference(jm, dtype=jnp.float32).generate(jnp.asarray(prompt), 5, scan_decode=False)
    out, _ = GPTInference(tm, dtype=torch.float32).generate(torch.tensor(prompt), 5)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_moe_engine_streams_match_jax(gpt_pair):
    """More requests than decode slots, mixed lengths: every greedy stream
    equals thunder_tpu's engine's and the port's solo GPTInference's; both
    serving programs claim the grouped kernel."""
    jm, tm = gpt_pair
    rng = np.random.RandomState(4)
    specs = [(rng.randint(0, 320, (L,)).astype(np.int32), n) for L, n in ((5, 7), (13, 4), (9, 6), (3, 5))]
    kw = dict(max_batch=2, page_size=8, max_seq=MAX_SEQ)
    jeng = JaxServingEngine(jm, dtype=jnp.float32, **kw)
    teng = ServingEngine(tm, dtype=torch.float32, device="cpu", **kw)
    jf = [jeng.submit(p, max_new_tokens=n) for p, n in specs]
    tf = [teng.submit(p, max_new_tokens=n) for p, n in specs]
    jeng.drain()
    teng.drain()
    solo = GPTInference(tm, dtype=torch.float32)
    for (p, n), a, b in zip(specs, tf, jf):
        np.testing.assert_array_equal(a.result().new_tokens, b.result().new_tokens)
        want, _ = solo.generate(torch.tensor(p[None]), n)
        np.testing.assert_array_equal(a.result().new_tokens, want[0, len(p):].numpy())
    for cfn in (teng.runner.prefill_cfn, teng.runner.decode_cfn):
        impls = [b.impl for b in tt.last_traces(cfn)[-1].bound_symbols if b.sym.id == "thunder.grouped_mlp"]
        assert impls == [cudaex._grouped_mlp_impl] * tm.cfg.n_layer


@pytest.mark.parametrize("road", ["grouped", "dense"])
def test_moe_train_steps_match_jax(road):
    jm, tm = _gpt_pair(n_layer=2, capacity_factor=1.0, dispatch=road)
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 320, (2, 32)).astype(np.int32)
    tgt = rng.randint(0, 320, (2, 32)).astype(np.int32)
    js = JaxTrainStep(tj.jit(jm), jopt.AdamW(lr=1e-3))
    ts = TrainStep(tt.jit(tm), topt.AdamW(lr=1e-3))
    jl = [float(js(jnp.asarray(idx), jnp.asarray(tgt))) for _ in range(4)]
    tl_ = [float(ts(torch.tensor(idx), torch.tensor(tgt))) for _ in range(4)]
    np.testing.assert_allclose(tl_, jl, rtol=TOL, atol=0)
    assert tl_[-1] < tl_[0]
    fwd = [b.sym.id for b in tt.last_traces(ts)[-1].bound_symbols]
    bwd = [b.sym.id for b in tt.last_backward_traces(ts)[-1].bound_symbols]
    n = 2 if road == "grouped" else 0
    assert fwd.count("cuda.grouped_mlp_fwd") == n and bwd.count("cuda.grouped_mlp_bwd") == n


def test_autocast_leaves_the_grouped_mlp_f32():
    """Neither package lists grouped_mlp for autocast and both keep rms_norm
    in f32, so the bins reach the kernel in f32 beside the f32 master
    panels, while the router's linear runs in bf16."""
    _, tm = _gpt_pair(n_layer=2, capacity_factor=1.0)
    ts = TrainStep(tt.jit(tm, transforms=[AutocastTransform()]), topt.AdamW(lr=1e-3))
    rng = np.random.RandomState(6)
    loss = ts(*(torch.tensor(rng.randint(0, 320, (1, 32)).astype(np.int32)) for _ in range(2)))
    assert np.isfinite(float(loss))
    bsyms = tt.last_traces(ts)[-1].bound_symbols
    claimed = [b for b in bsyms if b.sym.id == "cuda.grouped_mlp_fwd"]
    assert len(claimed) == 2
    assert all(a.dtype.name == "float32" for b in claimed for a in b.args[:4])


def test_load_jax_params_carries_tiny_moe_and_refuses_mismatches():
    _carry(jmoe.tiny_moe(), tmoe.tiny_moe(device="cpu"))  # same names, dtypes and shapes
    jm, tm = _gpt_pair(n_layer=1)
    good = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    with pytest.raises(KeyError, match="h.0.moe.w_up"):
        load_jax_params(tm, {k: v for k, v in good.items() if k != "h.0.moe.w_up"})
    with pytest.raises(ValueError, match="h.0.moe.w_gate: dtype"):
        load_jax_params(tm, {**good, "h.0.moe.w_gate": good["h.0.moe.w_gate"].astype(np.float16)})
    with pytest.raises(ValueError, match="h.0.moe.gate.weight: shape"):
        load_jax_params(tm, {**good, "h.0.moe.gate.weight": good["h.0.moe.gate.weight"][:3]})
