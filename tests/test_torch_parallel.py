"""The port's distributed slice against thunder_tpu's, on the CPU.

The port's ranks are real processes: one module-scoped ``LocalCluster`` of
4 Gloo workers (thunder_tpu_torch/parallel/multiprocess.py), each bounded
by a 120 s timeout that turns a hang into a failure. thunder_tpu runs in
this process on its virtual CPU mesh (tests/conftest.py gives jax 8
devices). Weights are carried across by ``load_jax_params`` and inputs
come from numpy seeds.

Tolerances:
* the ring steps' plain versions against pallasex's kernels in interpret
  mode: 1e-5 absolute (f32; the same log2-unit math, other summation
  order);
* ring attention at sp=4 against thunder_tpu's ``_ring_attention_impl``
  under shard_map and its ``jax.grad``: 2e-5 forward and 1e-4 gradients,
  the bars of tests/test_moe_longctx.py's ring tests;
* ``ddp`` on LossMLP: losses within 1e-4 of thunder_tpu's single-device and
  ``ddp`` runs (tests/test_distributed.py's bar);
* ``test_context_parallel_gpt_exact``: 1e-4 relative, its own bar;
* tiny-llama2 TrainSteps (f32, AdamW, 3 steps): losses within 1e-4
  relative and parameters within 1e-4 absolute, the bars
  tests/test_torch_training.py holds f32 TrainSteps to; the ranks'
  parameters bit-equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu import nn as jnn
from thunder_tpu import optim as jopt
from thunder_tpu.models import litgpt as jlg
from thunder_tpu.ops import ltorch as jlt
from thunder_tpu.parallel import ddp as jddp
from thunder_tpu.parallel import make_mesh as jmake_mesh
from thunder_tpu.parallel.context_parallel import context_parallel as jcontext_parallel
from thunder_tpu.training import TrainStep as JaxTrainStep
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.parallel import context_parallel, ddp, make_mesh
from thunder_tpu_torch.parallel.multiprocess import ClusterError, LocalCluster
from thunder_tpu_torch.training import TrainStep

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")

WORLD = 4


@pytest.fixture(scope="module")
def cluster():
    with LocalCluster(WORLD, timeout_s=120.0) as c:
        yield c


# ---------------------------------------------------------------------------
# the ring steps: plain versions against pallasex's kernels (interpret mode)
# ---------------------------------------------------------------------------

B1, H1, HKV1, T1, D1 = 1, 4, 2, 32, 16
STEP_OFFSETS = {"past": (32, 0), "diagonal": (32, 32), "future": (0, 32)}


def _step_inputs(seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B1, H1, T1, D1).astype(np.float32)
    kb = rng.randn(B1, HKV1, T1, D1).astype(np.float32)
    vb = rng.randn(B1, HKV1, T1, D1).astype(np.float32)
    o = rng.randn(B1, H1, T1, D1).astype(np.float32)
    m = (2.0 * rng.randn(B1, H1, T1, 1)).astype(np.float32)
    l = (1.0 + rng.rand(B1, H1, T1, 1)).astype(np.float32)
    do = rng.randn(B1, H1, T1, D1).astype(np.float32)
    # a global lse at or above this shard's own log-sum-exp (the other
    # shards add to it), so every recomputed p is at most 1, as in a ring
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(kb, H1 // HKV1, 1)) / math.sqrt(D1)
    own = np.log(np.exp(s).sum(-1, keepdims=True))
    lse = (own + np.abs(rng.randn(B1, H1, T1, 1))).astype(np.float32)
    delta = rng.randn(B1, H1, T1, 1).astype(np.float32)
    return q, kb, vb, o, m, l, do, lse, delta


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("where", list(STEP_OFFSETS))
def test_ring_step_plain_matches_pallas(where, causal):
    from thunder_tpu.executors import pallasex

    q_off, k_off = STEP_OFFSETS[where]
    q, kb, vb, o, m, l, *_ = _step_inputs(q_off + 2 * k_off + int(causal))
    scale = 1.0 / math.sqrt(D1)
    want = pallasex.ring_flash_step(*map(jnp.asarray, (q, kb, vb, o, m, l)), q_off, k_off,
                                    causal=causal, scale=scale, block_q=16, block_k=16,
                                    interpret=True)
    got = cudaex.ring_flash_step(*map(torch.tensor, (q, kb, vb, o, m, l)), q_off, k_off,
                                 causal, scale)
    for name, g, w in zip("oml", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("where", list(STEP_OFFSETS))
def test_ring_bwd_step_plain_matches_pallas(where, causal):
    from thunder_tpu.executors import pallasex

    q_off, k_off = STEP_OFFSETS[where]
    q, kb, vb, _, _, _, do, lse, delta = _step_inputs(7 + q_off + 2 * k_off + int(causal))
    scale = 1.0 / math.sqrt(D1)
    want = pallasex.ring_flash_bwd_step(*map(jnp.asarray, (q, kb, vb, do, lse, delta)), q_off,
                                        k_off, causal=causal, scale=scale, block_q=16,
                                        block_k=16, interpret=True)
    got = cudaex.ring_flash_bwd_step(*map(torch.tensor, (q, kb, vb, do, lse, delta)), q_off,
                                     k_off, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)
    if where == "future" and causal:
        assert not any(g.any() for g in got)


def test_future_step_leaves_accumulators_as_they_are():
    q, kb, vb, o, m, l, *_ = map(torch.tensor, _step_inputs(3))
    out = cudaex.ring_flash_step(q, kb, vb, o, m, l, 0, T1, True)
    assert all(a is b for a, b in zip(out, (o, m, l)))


def test_ring_flash_checker_is_hoppers():
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt)  # noqa: E731
    ok = cudaex.ring_flash_supported
    assert ok(z(1, 16, 8192, 64), z(1, 16, 8192, 64), z(1, 16, 8192, 64))
    assert ok(z(1, 16, 77, 128), z(1, 4, 77, 128), z(1, 4, 77, 128))  # GQA, ragged T
    assert ok(z(1, 4, 32, 16, dt=torch.float32), *(z(1, 2, 32, 16, dt=torch.float32),) * 2)
    assert not ok(z(1, 4, 32, 16), z(1, 4, 16, 16), z(1, 4, 16, 16))  # unequal shards
    assert not ok(z(1, 6, 32, 16), z(1, 4, 32, 16), z(1, 4, 32, 16))  # H % Hkv
    assert not ok(z(1, 4, 32, 16), z(1, 4, 32, 16, dt=torch.float32), z(1, 4, 32, 16))
    assert not ok(z(1, 4, 32, 136), z(1, 4, 32, 136), z(1, 4, 32, 136))  # D > 128
    assert not ok(z(1, 4, 32, 12), z(1, 4, 32, 12), z(1, 4, 32, 12))  # not 16-byte rows
    assert not ok(*(z(1, 4, 32, 16, dt=torch.int32),) * 3)


# ---------------------------------------------------------------------------
# ring attention at sp=4: the port's Gloo ring against thunder_tpu's
# ---------------------------------------------------------------------------

RING_SRC = '''
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch.parallel import make_mesh
from thunder_tpu_torch.extend import resolve_executors
from thunder_tpu_torch.parallel.context_parallel import ring_attention
from thunder_tpu_torch.transforms.autodiff import ThunderValueAndGrad


def ring(q, k, v, causal, road):
    mesh = make_mesh({"sp": 4})
    r, T = mesh.coordinate("sp"), q.shape[2] // 4
    blk = lambda a: torch.tensor(a[:, :, r * T:(r + 1) * T])

    def loss(q, k, v):
        o = ring_attention(q, k, v, axis="sp", causal=causal, world_size=4)
        return (o * o).sum(), o

    ex = None if road == "cuda" else resolve_executors(["torch"])
    vag = ThunderValueAndGrad(lambda q, k, v: loss(q, k, v)[0], argnums=(0, 1, 2), executors=ex)
    out = tt.jit(lambda q, k, v: loss(q, k, v)[1], executors=ex)(blk(q), blk(k), blk(v))
    _, grads = vag(blk(q), blk(k), blk(v))
    claimed = [b.impl.__module__ for b in vag._cs.last_traces[-1].bound_symbols
               if b.sym.id == "dist.ring_attention_fwd"]
    return out.numpy(), [g.numpy() for g in grads[0]], claimed
'''


@pytest.fixture(scope="module")
def ring_ref():
    """thunder_tpu's pure ring under shard_map on 4 devices and its jax.grad
    (of the sum over ranks of sum(o²)), on the global arrays. Both under
    jax.jit: run eagerly, the shard_map's grad dispatches op by op (25 s of
    the module's set-up on an 8-core CPU, against 1.5 s compiled)."""
    from jax.sharding import Mesh, PartitionSpec as P

    from thunder_tpu.parallel.context_parallel import _ring_attention_impl
    from thunder_tpu.training import _shard_map_compat

    rng = np.random.RandomState(5)
    q = rng.randn(1, 4, 32, 16).astype(np.float32)
    k = rng.randn(1, 2, 32, 16).astype(np.float32)
    v = rng.randn(1, 2, 32, 16).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("sp",))
    spec = P(None, None, "sp")
    out = {}
    for causal in (True, False):
        def body(q, k, v, causal=causal):
            return _ring_attention_impl(q, k, v, axis="sp", causal=causal, world_size=4)

        ring = jax.jit(_shard_map_compat(body, mesh, (spec, spec, spec), spec))

        def loss(q, k, v, causal=causal):
            def inner(q, k, v):
                o = body(q, k, v)
                return jax.lax.psum(jnp.sum(o * o), "sp")
            return _shard_map_compat(inner, mesh, (spec, spec, spec), P())(q, k, v)

        jq, jk, jv = map(jnp.asarray, (q, k, v))
        grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
        out[causal] = (np.asarray(ring(jq, jk, jv)), [np.asarray(g) for g in grad(jq, jk, jv)])
    return (q, k, v), out


@pytest.mark.parametrize("road", ["cuda", "torch"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_matches_jax(cluster, ring_ref, road, causal):
    """The claimed ring (cudaex's impls: the ring driver over the step
    wrappers, which take their plain versions on CPU tensors) and the torch
    executor's (the driver over the plain steps), forward and grad rule, at
    sp=4 over Gloo, against thunder_tpu's ring and jax.grad."""
    (q, k, v), ref = ring_ref
    want_o, want_g = ref[causal]
    res = cluster.call(RING_SRC, "ring", q, k, v, causal, road)
    T = q.shape[2] // WORLD
    for r, (o, grads, claimed) in enumerate(res):
        blk = slice(r * T, (r + 1) * T)
        np.testing.assert_allclose(o, want_o[:, :, blk], atol=2e-5, rtol=0)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want_g):
            np.testing.assert_allclose(g, w[:, :, blk], atol=1e-4, rtol=0, err_msg=name)
        want_mod = ("thunder_tpu_torch.executors.cudaex" if road == "cuda"
                    else "thunder_tpu_torch.parallel.context_parallel")
        assert claimed == [want_mod]


# ---------------------------------------------------------------------------
# the collective prims at world size 4
# ---------------------------------------------------------------------------

PRIMS_SRC = '''
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch.parallel import make_mesh, prims as dp
from thunder_tpu_torch.transforms.autodiff import ThunderValueAndGrad

RING = tuple((j, (j + 1) % 4) for j in range(4))


def apply(name, x):
    if name == "all_reduce":
        return dp.all_reduce(x, "sp")
    if name == "all_reduce_2d":
        return dp.all_reduce(x, ("dp", "sp"))
    if name == "pmean":
        return dp.pmean(x, "sp", world_size=4)
    if name == "synchronize":
        return dp.synchronize(x, "sp")
    return dp.ppermute(x, "sp", RING)


def prim(name, xs, ws):
    mesh = make_mesh({"dp": 2, "sp": 2} if name == "all_reduce_2d" else {"sp": 4})
    r = mesh.rank
    x, w = torch.tensor(xs[r]), torch.tensor(ws[r])
    y = tt.jit(lambda x: apply(name, x))(x)
    _, g = ThunderValueAndGrad(lambda x, w: (apply(name, x) * w).sum(), argnums=0)(x, w)
    idx = tt.jit(lambda x: x + dp.axis_index("sp"))(torch.zeros((), dtype=torch.int32))
    return y.numpy(), g[0][0].numpy(), int(idx)
'''


@pytest.mark.parametrize("name", ["all_reduce", "all_reduce_2d", "pmean", "synchronize",
                                  "ppermute"])
def test_collective_prims_values_and_grads(cluster, name):
    rng = np.random.RandomState(3)
    xs = rng.randn(WORLD, 3, 5).astype(np.float32)
    ws = rng.randn(WORLD, 3, 5).astype(np.float32)
    res = cluster.call(PRIMS_SRC, "prim", name, xs, ws)
    for r, (y, g, idx) in enumerate(res):
        if name == "all_reduce_2d":
            want_y, want_g = xs.sum(0), ws[r]
            assert idx == r % 2
        else:
            assert idx == r
            want_y, want_g = {
                "all_reduce": (xs.sum(0), ws[r]),  # bwd: g passes through
                "pmean": (xs.mean(0), ws[r] / WORLD),
                "synchronize": (xs[r], ws.sum(0)),  # bwd: all-reduce of g
                "ppermute": (xs[(r - 1) % WORLD], ws[(r + 1) % WORLD]),  # bwd: inverse perm
            }[name]
        np.testing.assert_allclose(y, want_y, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(g, want_g, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# ddp on thunder_tpu's LossMLP (tests/test_distributed.py)
# ---------------------------------------------------------------------------


class JaxLossMLP(jnn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(16, 64, seed=1)
        self.fc2 = jnn.Linear(64, 8, seed=2)

    def forward(self, x, y):
        return jlt.mse_loss(self.fc2(jlt.gelu(self.fc1(x))), y)


DDP_SRC = '''
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch import nn, optim
from thunder_tpu_torch.ops import ltorch
from thunder_tpu_torch.parallel import ddp, make_mesh
from thunder_tpu_torch.training import TrainStep


class LossMLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 64, device="cpu")
        self.fc2 = nn.Linear(64, 8, device="cpu")

    def forward(self, x, y):
        return ltorch.mse_loss(self.fc2(ltorch.gelu(self.fc1(x))), y)


def run(params, x, y, steps):
    m = LossMLP()
    with torch.no_grad():
        for k, p in m.named_parameters():
            # rank 0's weights are thunder_tpu's; the others start elsewhere
            # and ddp's broadcast must make them equal
            p.copy_(torch.tensor(params[k]) + (0.0 if torch.distributed.get_rank() == 0 else 1.0))
    tm = tt.jit(m)
    ddp(tm, make_mesh({"dp": 4}))
    step = TrainStep(tm, optim.AdamW(lr=1e-2))
    losses = [float(step(torch.tensor(x), torch.tensor(y))) for _ in range(steps)]
    return losses, {k: p.detach().numpy() for k, p in m.named_parameters()}
'''


def test_ddp_lossmlp_matches_jax(cluster):
    rng = np.random.RandomState(0)
    x = rng.randn(16, 16).astype(np.float32)
    y = np.zeros((16, 8), np.float32)
    m = JaxLossMLP()
    params = {k: np.asarray(p.data).copy() for k, p in m.named_parameters()}
    single = JaxTrainStep(m, jopt.AdamW(lr=1e-2))
    want = [float(single(jnp.asarray(x), jnp.asarray(y))) for _ in range(4)]
    m2 = JaxLossMLP()
    tm2 = tj.jit(m2)
    jddp(tm2, jmake_mesh({"dp": 8}))
    jax_ddp = JaxTrainStep(tm2, jopt.AdamW(lr=1e-2))
    want_ddp = [float(jax_ddp(jnp.asarray(x), jnp.asarray(y))) for _ in range(4)]
    res = cluster.call(DDP_SRC, "run", params, x, y, 4)
    for losses, ps in res:
        np.testing.assert_allclose(losses, want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(losses, want_ddp, atol=1e-4, rtol=0)
        for k in ps:
            assert np.array_equal(ps[k], res[0][1][k]), k  # the ranks stay bit-equal


# ---------------------------------------------------------------------------
# test_context_parallel_gpt_exact (tests/test_distributed.py) in both packages
# ---------------------------------------------------------------------------

PROBE_SRC = '''
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch import nn, optim
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.ops import ltorch
from thunder_tpu_torch.parallel import context_parallel, make_mesh
from thunder_tpu_torch.training import TrainStep


class Probe(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.gpt = tlg.GPT(cfg, device="cpu")

    def forward(self, idx, w):
        return ltorch.mean(self.gpt(idx) * w)


def run(params, idx, w, cp):
    cfg = tlg.Config.from_name("tiny", block_size=128, n_layer=1)
    m = Probe(cfg)
    tlg.load_jax_params(m, params)
    tm = tt.jit(m)
    if cp:
        context_parallel(tm, make_mesh({"sp": 4}))
    return float(TrainStep(tm, optim.SGD(lr=0.0))(torch.tensor(idx), torch.tensor(w)))
'''


def test_context_parallel_gpt_exact_both_packages(cluster):
    rng = np.random.RandomState(0)
    cfg = jlg.Config.from_name("tiny", block_size=128, n_layer=1)

    class Probe(jnn.Module):
        def __init__(self):
            super().__init__()
            self.gpt = jlg.GPT(cfg)

        def forward(self, idx, w):
            return jlt.mean(self.gpt(idx) * w)

    idx = rng.randint(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    w = rng.randn(2, 128, cfg.padded_vocab_size).astype(np.float32)
    m0 = Probe()
    params = {k: np.asarray(p.data).copy() for k, p in m0.named_parameters()}
    sd = {k: np.asarray(v).copy() for k, v in m0.state_dict().items()}
    ref = float(JaxTrainStep(m0, jopt.SGD(lr=0.0))(jnp.asarray(idx), jnp.asarray(w)))
    m1 = Probe()
    m1.load_state_dict(sd)
    tm1 = tj.jit(m1)
    jcontext_parallel(tm1, jmake_mesh({"sp": 4}))
    jax_cp = float(JaxTrainStep(tm1, jopt.SGD(lr=0.0))(jnp.asarray(idx), jnp.asarray(w)))
    plain = cluster.call(PROBE_SRC, "run", params, idx, w, False)
    cp = cluster.call(PROBE_SRC, "run", params, idx, w, True)
    for got in cp:
        assert abs(got - plain[0]) / max(1e-9, abs(plain[0])) < 1e-4
        assert abs(got - jax_cp) / max(1e-9, abs(jax_cp)) < 1e-4
        assert abs(got - ref) / max(1e-9, abs(ref)) < 1e-4


# ---------------------------------------------------------------------------
# tiny-llama2 TrainSteps under context parallelism, sp=4 and dp=2 × sp=2
# ---------------------------------------------------------------------------

LLAMA_SRC = '''
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch import optim
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.parallel import context_parallel, ddp, make_mesh
from thunder_tpu_torch.training import TrainStep


def run(params, idx, tgt, shape, steps):
    m = tlg.GPTForCausalLM(tlg.Config.from_name("tiny-llama2"), device="cpu")
    tlg.load_jax_params(m, params)
    tm = tt.jit(m)
    mesh = make_mesh(shape)
    if "dp" in shape:
        ddp(tm, mesh)
    if "sp" in shape:
        context_parallel(tm, mesh)
    step = TrainStep(tm, optim.AdamW(lr=1e-3))
    losses = [float(step(torch.tensor(idx), torch.tensor(tgt))) for _ in range(steps)]
    fwd = [b.sym.id for b in tt.last_traces(step)[-1].bound_symbols]
    bwd = [b.sym.id for b in tt.last_backward_traces(step)[-1].bound_symbols]
    return (losses, {k: p.detach().numpy() for k, p in m.named_parameters()},
            fwd.count("dist.ring_attention_fwd"), bwd.count("dist.ring_attention_bwd"),
            fwd.count("thunder.rope_sdpa") + fwd.count("cuda.rope_flash_fwd"))


def rope_positions(T_local):
    from thunder_tpu_torch.models.litgpt import build_rope_cache, rope_slice
    from thunder_tpu_torch.parallel.context_parallel import seq_parallel_tracing

    make_mesh({"sp": 4})
    cos, sin = build_rope_cache(4 * T_local, 16, device="cpu")

    def f(cos, sin):
        with seq_parallel_tracing("sp", 4):
            return rope_slice(cos, sin, T_local)

    c, s = tt.jit(f)(cos, sin)
    return c.numpy(), s.numpy(), cos.numpy(), sin.numpy()


def uneven(params, idx, tgt, shape):
    try:
        run(params, idx, tgt, shape, 1)
    except ValueError as e:
        return str(e)
    return None
'''

LLAMA_B, LLAMA_T, LLAMA_STEPS = 2, 64, 3


@pytest.fixture(scope="module")
def llama_ref():
    """thunder_tpu's tiny-llama2 at sp=4: initial weights, batch, 3 f32
    AdamW losses and the final parameters."""
    cfg = jlg.Config.from_name("tiny-llama2")
    m = jlg.GPTForCausalLM(cfg)
    init = {k: np.asarray(p.data).copy() for k, p in m.named_parameters()}
    rng = np.random.RandomState(0)
    idx = rng.randint(0, cfg.vocab_size, (LLAMA_B, LLAMA_T)).astype(np.int32)
    tgt = rng.randint(0, cfg.vocab_size, (LLAMA_B, LLAMA_T)).astype(np.int32)
    tm = tj.jit(m)
    jcontext_parallel(tm, jmake_mesh({"sp": 4}))
    step = JaxTrainStep(tm, jopt.AdamW(lr=1e-3))
    losses = [float(step(jnp.asarray(idx), jnp.asarray(tgt))) for _ in range(LLAMA_STEPS)]
    final = {k: np.asarray(p.data, dtype=np.float32) for k, p in m.named_parameters()}
    return init, idx, tgt, np.array(losses), final


@pytest.mark.parametrize("shape", [{"sp": 4}, {"dp": 2, "sp": 2}], ids=["sp4", "dp2xsp2"])
def test_cp_trainstep_matches_jax(cluster, llama_ref, shape):
    init, idx, tgt, want_losses, want = llama_ref
    res = cluster.call(LLAMA_SRC, "run", init, idx, tgt, shape, LLAMA_STEPS)
    n_layer = jlg.Config.from_name("tiny-llama2").n_layer
    for losses, params, n_fwd, n_bwd, n_rope_sdpa in res:
        np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=0)
        assert losses[-1] < losses[0]
        for k in want:
            np.testing.assert_allclose(params[k], want[k], atol=1e-4, rtol=0, err_msg=k)
            assert np.array_equal(params[k], res[0][1][k]), k  # bit-equal across the ranks
        # every layer's attention is the ring, none the fused rope_sdpa
        assert (n_fwd, n_bwd, n_rope_sdpa) == (n_layer, n_layer, 0)


def test_rope_slice_gives_global_positions(cluster):
    for r, (c, s, cos, sin) in enumerate(cluster.call(LLAMA_SRC, "rope_positions", 8)):
        np.testing.assert_array_equal(c, cos[8 * r:8 * (r + 1)])
        np.testing.assert_array_equal(s, sin[8 * r:8 * (r + 1)])


@pytest.mark.parametrize("shape,B,T,axis", [({"dp": 4}, 3, 32, "data-parallel"),
                                            ({"sp": 4}, 2, 30, "sequence-parallel")],
                         ids=["batch", "sequence"])
def test_uneven_batch_refused_loudly(cluster, llama_ref, shape, B, T, axis):
    init = llama_ref[0]
    rng = np.random.RandomState(1)
    idx = rng.randint(0, 256, (B, T)).astype(np.int32)
    errs = cluster.call(LLAMA_SRC, "uneven", init, idx, idx, shape)
    for e in errs:
        assert e is not None and "not divisible" in e and axis in e


def test_cluster_reports_a_failing_rank(cluster):
    src = "import torch\ndef f():\n    if torch.distributed.get_rank() == 2:\n" \
          "        raise RuntimeError('rank two fails')\n    return 1\n"
    with pytest.raises(ClusterError, match="rank two fails"):
        cluster.call(src, "f")
    assert cluster.call(src.replace("== 2", "== 9"), "f") == [1] * WORLD  # restarted clean


# ---------------------------------------------------------------------------
# in this process: one-rank plans, dtypes under autocast, refusals
# ---------------------------------------------------------------------------


def _llama_pair():
    cfg = tlg.Config.from_name("tiny-llama2")
    jm = jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2"))
    params = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    a, b = (tlg.GPTForCausalLM(cfg, device="cpu") for _ in range(2))
    tlg.load_jax_params(a, params)
    tlg.load_jax_params(b, params)
    rng = np.random.RandomState(2)
    idx = torch.tensor(rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    tgt = torch.tensor(rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32))
    return jm, a, b, idx, tgt


@pytest.mark.parametrize("plan", ["ddp", "context_parallel"])
def test_one_rank_plan_equals_no_plan(plan):
    """A plan over a one-rank mesh (no process group: the collectives are
    identities) trains as no plan: losses within 1e-6
    (test_distributed.py:449-474). ddp runs the same program, so its
    parameters agree to 1e-6; context parallelism takes RoPE outside the
    kernel and the ring in place of the fused attention, another summation
    order, so its parameters are held to the f32 TrainStep bar, 1e-4."""
    _, a, b, idx, tgt = _llama_pair()
    tm = tt.jit(a)
    if plan == "ddp":
        ddp(tm, make_mesh({"dp": 1}))
    else:
        context_parallel(tm, make_mesh({"sp": 1}))
    s_plan, s_ref = TrainStep(tm, topt.AdamW(lr=1e-3)), TrainStep(tt.jit(b), topt.AdamW(lr=1e-3))
    for _ in range(2):
        assert abs(float(s_plan(idx, tgt)) - float(s_ref(idx, tgt))) < 1e-6
    atol = 1e-6 if plan == "ddp" else 1e-4
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p, q, atol=atol, rtol=0, msg=k)


def test_autocast_ring_dtypes_match_jax():
    """Under AutocastTransform the ring op sees the dtypes thunder_tpu's
    trace gives it: bf16 q/k/v (autocast casts sdpa's inputs first, then the
    context-parallel transform rewrites sdpa)."""
    from thunder_tpu.transforms.autocast import AutocastTransform as JaxAutocast
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    jm, a, _, idx, tgt = _llama_pair()
    jtm = tj.jit(jm, transforms=[JaxAutocast()])
    jcontext_parallel(jtm, jmake_mesh({"sp": 1}))
    jstep = JaxTrainStep(jtm, jopt.AdamW(lr=1e-3))
    jstep(jnp.asarray(idx.numpy()), jnp.asarray(tgt.numpy()))
    tm = tt.jit(a, transforms=[AutocastTransform()])
    context_parallel(tm, make_mesh({"sp": 1}))
    step = TrainStep(tm, topt.AdamW(lr=1e-3))
    step(idx, tgt)

    def ring_dtypes(trc):
        return [tuple(str(x.dtype).rpartition(".")[2] for x in b.args[:3])
                for b in trc.bound_symbols if b.sym.id == "dist.ring_attention"]

    want = ring_dtypes(jstep._vag._cs.last_traces[0])
    got = ring_dtypes(step._cs.last_traces[0])
    assert want and got == want
    assert set(got) == {("bfloat16",) * 3}


def test_distributed_step_refuses_buffer_writes():
    from thunder_tpu_torch import nn
    from thunder_tpu_torch.nn.module import update_buffer
    from thunder_tpu_torch.ops import ltorch

    class Counting(nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4, device="cpu")
            self.register_buffer("seen", torch.zeros(()))

        def forward(self, x):
            update_buffer(self, "seen", self.seen + 1.0)
            return ltorch.mean(self.fc(x))

    m = Counting()
    w0 = m.fc.weight.detach().clone()
    tm = tt.jit(m)
    ddp(tm, make_mesh({"dp": 1}))
    with pytest.raises(NotImplementedError, match="buffer mutations"):
        TrainStep(tm, topt.SGD(lr=0.1))(torch.ones(2, 4))
    assert torch.equal(m.fc.weight, w0)  # refused before the update


def test_unported_options_raise():
    """What the port still refuses under a plan (ROADMAP A3c); ddp's
    bucket_mb, once refused, now appends the bucketing transform."""
    from thunder_tpu_torch.parallel import GradBucketingTransform

    _, a, _, _, _ = _llama_pair()
    tm = ddp(tt.jit(a), make_mesh({"dp": 1}), bucket_mb=25)
    assert [t.bucket_bytes for t in tm._cd.transforms if isinstance(t, GradBucketingTransform)] == [25 << 20]
    from thunder_tpu_torch.robustness import StepGuard

    with pytest.raises(NotImplementedError, match="guard.*A3c"):  # an all-rank verdict
        TrainStep(ddp(tt.jit(a), make_mesh({"dp": 1})), topt.AdamW(lr=1e-3), guard=StepGuard())
    with pytest.raises(NotImplementedError, match="mesh_plan.*rides on the module"):
        TrainStep(tt.jit(a), topt.AdamW(lr=1e-3), mesh_plan=object())
    with pytest.raises(ValueError, match="mesh wants 4 devices, have 1"):
        make_mesh({"sp": 4})
