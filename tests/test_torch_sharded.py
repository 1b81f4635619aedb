"""The port's sharded training (FSDP, tensor and expert parallelism,
bucketing, no_sync windows) against thunder_tpu's, on the CPU.

The port's ranks are one module-scoped ``LocalCluster`` of 4 Gloo workers
(120 s timeout on every call and collective), as tests/test_torch_parallel.py
runs them; thunder_tpu runs in this process on its virtual CPU devices.
Weights are carried across by ``load_jax_params`` (or the JAX module's
``named_parameters``) and inputs come from numpy seeds.

Tolerances:
* the new collective prims at world 4 against thunder_tpu's prim impls
  under shard_map and ``jax.grad``: 1e-5 in f32 (a sum of 4 terms in
  another order);
* ``fsdp`` (zero 2 and 3), ``column_parallel``/``row_parallel`` at tp=4 and
  ``ddp(bucket_mb=)`` on LossMLP: losses within 1e-4 of thunder_tpu's
  single-device and sharded runs (tests/test_distributed.py:24-67's bar);
  under plain SGD too (fsdp, tp), whose update shows a gradient's scale;
* OddMLP's padded shards: the unpadded ``state_dict`` within 1e-5 of
  thunder_tpu's after 4 AdamW steps (f32, summation order only);
* dryrun_multichip's phase 1 on a 2 × 2 dp × fsdp mesh and tiny-llama2's
  MLPs at tp=2 (f32, AdamW, 3 steps, then a no_sync window): losses within
  1e-4 relative, parameters within 1e-4 absolute, the bars
  tests/test_torch_training.py holds f32 TrainSteps to; the ranks' whole
  parameters bit-equal;
* ``moe_ep_forward`` at ep=4 and ep=2 × dp=2: outputs and gradients within
  1e-5 of thunder_tpu's (f32), routing stats within 1e-5;
* single-device ``micro_step`` windows: losses within 1e-5 relative,
  parameters within 1e-5 of thunder_tpu's;
* a plan over one rank (no process group: every collective an identity)
  trains bit-equal to no plan.

Three planted faults show each bar catches its fault: a reduce-scatter that
averages where it should sum, an unpad slice one row short, and an
all_to_all gradient sent back to the wrong rank. Each is a mutation of the
port's own result handed to the test's checker, which must refuse it.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu import nn as jnn
from thunder_tpu import optim as jopt
from thunder_tpu.models import litgpt as jlg
from thunder_tpu.ops import ltorch as jlt
from thunder_tpu.parallel import ddp as jddp
from thunder_tpu.parallel import fsdp as jfsdp
from thunder_tpu.parallel import make_mesh as jmake_mesh
from thunder_tpu.parallel.tensor_parallel import column_parallel as jcolumn_parallel
from thunder_tpu.parallel.tensor_parallel import row_parallel as jrow_parallel
from thunder_tpu.training import TrainStep as JaxTrainStep
from thunder_tpu.training import _shard_map_compat
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.parallel import (GradBucketingTransform, column_parallel, ddp, fsdp, make_mesh,
                                        row_parallel)
from thunder_tpu_torch.parallel.multiprocess import LocalCluster
from thunder_tpu_torch.training import TrainStep

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")

WORLD = 4
PRIM_TOL = 1e-5
LOSS_TOL = 1e-4
EP_TOL = 1e-5


@pytest.fixture(scope="module")
def cluster():
    with LocalCluster(WORLD, timeout_s=120.0) as c:
        yield c


def _devices(n):
    return jax.devices()[:n]


# ---------------------------------------------------------------------------
# the new collective prims at world size 4
# ---------------------------------------------------------------------------

PRIMS_SRC = '''
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch.parallel import make_mesh, prims as dp
from thunder_tpu_torch.transforms.autodiff import ThunderValueAndGrad


def apply(name, x):
    if name == "all_gather":
        return dp.all_gather(x, "sp", world_size=4)
    if name == "reduce_scatter":
        return dp.reduce_scatter(x, "sp", world_size=4)
    if name == "tp_input":
        return dp.synchronize_tensor_parallel_input(x, "sp")
    if name == "tp_output":
        return dp.synchronize_tensor_parallel_output(x, "sp")
    if name == "all_to_all":
        return dp.all_to_all(x, "sp", 0, 0, world_size=4)
    if name == "all_to_all_1_0":
        return dp.all_to_all(x, "sp", 1, 0, world_size=4)
    if name == "wait":
        return dp.wait(x)
    return dp.broadcast(x, "sp", 1)


def prim(name, xs, ws):
    mesh = make_mesh({"sp": 4})
    x, w = torch.tensor(xs[mesh.rank]), torch.tensor(ws[mesh.rank])
    y = tt.jit(lambda x: apply(name, x))(x)
    if name == "broadcast":  # no grad rule (thunder_tpu has none either)
        return y.numpy(), None
    _, g = ThunderValueAndGrad(lambda x, w: (apply(name, x) * w).sum(), argnums=0)(x, w)
    return y.numpy(), g[0][0].numpy()
'''

PRIM_SHAPES = {"all_gather": ((3, 5), (12, 5)), "reduce_scatter": ((8, 5), (2, 5)),
               "tp_input": ((3, 5), (3, 5)), "tp_output": ((3, 5), (3, 5)),
               "all_to_all": ((8, 5), (8, 5)), "all_to_all_1_0": ((2, 8), (8, 2)),
               "broadcast": ((3, 5), (3, 5)), "wait": ((3, 5), (3, 5))}


def _jax_prim(name):
    """thunder_tpu's prim inside shard_map over 4 devices: its value on the
    stacked per-rank inputs, and the gradient of sum(prim(x) * w) through
    thunder_tpu's value_and_grad (its grad rules) on each device."""
    from jax.sharding import Mesh, PartitionSpec as P

    from thunder_tpu.parallel import prims as jp
    from thunder_tpu.transforms.autodiff import ThunderValueAndGrad as JaxVAG

    f = {"all_gather": lambda x: jp.all_gather(x, "sp", world_size=4),
         "reduce_scatter": lambda x: jp.reduce_scatter(x, "sp", world_size=4),
         "tp_input": lambda x: jp.synchronize_tensor_parallel_input(x, "sp"),
         "tp_output": lambda x: jp.synchronize_tensor_parallel_output(x, "sp"),
         "all_to_all": lambda x: jp.all_to_all(x, "sp", 0, 0, world_size=4),
         "all_to_all_1_0": lambda x: jp.all_to_all(x, "sp", 1, 0, world_size=4),
         "broadcast": lambda x: jp.broadcast(x, "sp", 1),
         "wait": jp.wait}[name]
    mesh = Mesh(np.asarray(_devices(4)), ("sp",))
    spec = P("sp")
    fwd = jax.jit(_shard_map_compat(tj.jit(f), mesh, (spec,), spec))

    def grad_body(x, w):
        _, g = JaxVAG(lambda x, w: jlt.sum(jlt.mul(f(x), w)), argnums=0)(x, w)
        return g[0][0]

    return fwd, jax.jit(_shard_map_compat(grad_body, mesh, (spec, spec), spec))


def _prim_case(name):
    (sx, sy) = PRIM_SHAPES[name]
    rng = np.random.RandomState(3)
    xs = rng.randn(WORLD, *sx).astype(np.float32)
    ws = rng.randn(WORLD, *sy).astype(np.float32)
    return xs, ws


def _prim_want(name, xs, ws):
    fwd, grad = _jax_prim(name)
    x, w = (jnp.asarray(a.reshape(-1, *a.shape[2:])) for a in (xs, ws))
    y = np.asarray(fwd(x))
    g = None if name == "broadcast" else np.asarray(grad(x, w)).reshape(WORLD, -1, *xs.shape[2:])
    return y.reshape(WORLD, -1, *y.shape[1:]), g


def check_prim(name, res, want_y, want_g):
    """The ranks' values and grads against thunder_tpu's."""
    for r, (y, g) in enumerate(res):
        np.testing.assert_allclose(y, want_y[r], atol=PRIM_TOL, rtol=0, err_msg=f"{name} value, rank {r}")
        if g is not None:
            np.testing.assert_allclose(g, want_g[r], atol=PRIM_TOL, rtol=0, err_msg=f"{name} grad, rank {r}")


@pytest.fixture(scope="module")
def prim_results(cluster):
    out = {}
    for name in PRIM_SHAPES:
        xs, ws = _prim_case(name)
        out[name] = cluster.call(PRIMS_SRC, "prim", name, xs, ws), _prim_want(name, xs, ws)
    return out


@pytest.mark.parametrize("name", list(PRIM_SHAPES))
def test_new_prims_values_and_grads_match_jax(prim_results, name):
    res, (want_y, want_g) = prim_results[name]
    check_prim(name, res, want_y, want_g)


def test_planted_reduce_scatter_that_averages_fails(prim_results):
    """A reduce-scatter that averages where it should sum: its values are
    the true ones over 4, and the prim check refuses them."""
    res, (want_y, want_g) = prim_results["reduce_scatter"]
    check_prim("reduce_scatter", res, want_y, want_g)
    mutated = [(y / WORLD, g) for y, g in res]
    with pytest.raises(AssertionError, match="reduce_scatter value"):
        check_prim("reduce_scatter", mutated, want_y, want_g)


def test_planted_all_to_all_grad_to_the_wrong_rank_fails(prim_results):
    """An all_to_all whose gradient goes back to the wrong rank: rank r
    receives rank r+1's gradient; the prim check refuses it."""
    res, (want_y, want_g) = prim_results["all_to_all"]
    mutated = [(res[r][0], res[(r + 1) % WORLD][1]) for r in range(WORLD)]
    with pytest.raises(AssertionError, match="all_to_all grad"):
        check_prim("all_to_all", mutated, want_y, want_g)


# ---------------------------------------------------------------------------
# LossMLP / OddMLP (tests/test_distributed.py) under fsdp, tp and ddp(bucket_mb)
# ---------------------------------------------------------------------------


class JaxLossMLP(jnn.Module):
    def __init__(self, hidden=64):
        super().__init__()
        self.fc1 = jnn.Linear(16, hidden, seed=1)
        self.fc2 = jnn.Linear(hidden, 8, seed=2)

    def forward(self, x, y):
        return jlt.mse_loss(self.fc2(jlt.gelu(self.fc1(x))), y)


SGD_LR = 0.5
MLP_SRC = f"SGD_LR = {SGD_LR}\n" + '''
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch import nn, optim
from thunder_tpu_torch.ops import ltorch
from thunder_tpu_torch.parallel import column_parallel, ddp, fsdp, make_mesh, row_parallel
from thunder_tpu_torch.training import TrainStep


class LossMLP(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.fc1 = nn.Linear(16, hidden, device="cpu")
        self.fc2 = nn.Linear(hidden, 8, device="cpu")

    def forward(self, x, y):
        return ltorch.mse_loss(self.fc2(ltorch.gelu(self.fc1(x))), y)


def run(params, x, y, strategy, hidden, steps, window=(), sgd=False):
    m = LossMLP(hidden)
    with torch.no_grad():
        for k, p in m.named_parameters():
            # rank 0 holds thunder_tpu's weights; the broadcast must spread them
            p.copy_(torch.tensor(params[k]) + (0.0 if torch.distributed.get_rank() == 0 else 1.0))
    tm = tt.jit(m)
    kind, _, zero = strategy.partition(":")
    if kind == "fsdp":
        fsdp(tm, make_mesh({"fsdp": 4}), min_shard_numel=1, zero=int(zero))
    elif kind == "tp":
        mesh = make_mesh({"tp": 4})
        column_parallel(tm, mesh, ["fc1"])
        row_parallel(tm, mesh, ["fc2"])
    else:
        ddp(tm, make_mesh({"dp": 4}), bucket_mb=float(zero))
    local = {k: tuple(p.shape) for k, p in m.named_parameters()}
    step = TrainStep(tm, optim.SGD(lr=SGD_LR) if sgd else optim.AdamW(lr=1e-2))
    losses = [float(step(torch.tensor(x), torch.tensor(y))) for _ in range(steps)]
    if window:  # micro-batches inside no_sync, then the step that folds them
        with tm.no_sync():
            losses += [float(step(torch.tensor(xw), torch.tensor(y))) for xw in window[:-1]]
        losses.append(float(step(torch.tensor(window[-1]), torch.tensor(y))))
    fwd = [b.sym.id for b in tt.last_traces(step)[-1].bound_symbols]
    bwd = [b.sym.id for b in tt.last_backward_traces(step)[-1].bound_symbols]
    sd = tm.state_dict()
    reloaded = None
    if kind == "fsdp":  # the unpadded state_dict into a fresh plan: each rank re-pads its block
        tm2 = tt.jit(LossMLP(hidden))
        fsdp(tm2, make_mesh({"fsdp": 4}), min_shard_numel=1, zero=int(zero))
        tm2.load_state_dict(sd)
        reloaded = all(torch.equal(p, q) for p, q in zip(tm2.module.parameters(), m.parameters()))
    return dict(losses=losses, local=local, sd={k: v.numpy() for k, v in sd.items()}, fwd=fwd, bwd=bwd,
                reloaded=reloaded)
'''


def _mlp_batch():
    rng = np.random.RandomState(0)
    return rng.randn(16, 16).astype(np.float32), np.zeros((16, 8), np.float32)


def _jax_mlp_run(hidden, strategy, steps=4, sgd=False):
    x, y = _mlp_batch()
    m = JaxLossMLP(hidden)
    init = {k: np.asarray(p.data).copy() for k, p in m.named_parameters()}
    tm = tj.jit(m)
    if strategy == "fsdp":
        jfsdp(tm, jmake_mesh({"fsdp": 4}, devices=_devices(4)), min_shard_numel=1)
    elif strategy == "tp":
        mesh = jmake_mesh({"tp": 4}, devices=_devices(4))
        jcolumn_parallel(tm, mesh, ["fc1"])
        jrow_parallel(tm, mesh, ["fc2"])
    step = JaxTrainStep(tm if strategy else m, jopt.SGD(lr=SGD_LR) if sgd else jopt.AdamW(lr=1e-2))
    losses = [float(step(jnp.asarray(x), jnp.asarray(y))) for _ in range(steps)]
    sd = {k: np.asarray(v) for k, v in tm.state_dict().items()} if strategy else None
    return init, np.array(losses), sd


@pytest.fixture(scope="module")
def mlp_ref():
    """thunder_tpu's LossMLP (hidden 64) single-device, fsdp and tp runs and
    OddMLP's (hidden 30: dim 0 indivisible by 4) fsdp run and state_dict."""
    init, single, _ = _jax_mlp_run(64, None)
    _, j_fsdp, _ = _jax_mlp_run(64, "fsdp")
    _, j_tp, _ = _jax_mlp_run(64, "tp")
    odd_init, odd_losses, odd_sd = _jax_mlp_run(30, "fsdp")
    _, sgd, _ = _jax_mlp_run(64, None, sgd=True)
    return dict(init=init, single=single, fsdp=j_fsdp, tp=j_tp, odd_init=odd_init, odd_losses=odd_losses,
                odd_sd=odd_sd, sgd=sgd)


@pytest.mark.parametrize("strategy", ["fsdp:2", "fsdp:3", "tp", "ddp:0.0001"])
def test_lossmlp_strategies_match_jax(cluster, mlp_ref, strategy):
    x, y = _mlp_batch()
    res = cluster.call(MLP_SRC, "run", mlp_ref["init"], x, y, strategy, 64, 4)
    want = mlp_ref["tp"] if strategy == "tp" else (mlp_ref["fsdp"] if strategy.startswith("fsdp")
                                                  else mlp_ref["single"])
    for r in res:
        np.testing.assert_allclose(r["losses"], mlp_ref["single"], atol=LOSS_TOL, rtol=0)
        np.testing.assert_allclose(r["losses"], want, atol=LOSS_TOL, rtol=0)
        for k, v in r["sd"].items():
            assert np.array_equal(v, res[0]["sd"][k]), k  # the ranks' whole parameters agree
    if strategy.startswith("fsdp"):  # each rank holds a quarter of every parameter
        assert res[0]["local"] == {"fc1.weight": (16, 16), "fc1.bias": (16,), "fc2.weight": (2, 64),
                                   "fc2.bias": (2,)}
    if strategy == "tp":  # column fc1 on out, row fc2 on in; fc2's bias whole
        assert res[0]["local"] == {"fc1.weight": (16, 16), "fc1.bias": (16,), "fc2.weight": (8, 16),
                                   "fc2.bias": (8,)}
        assert res[0]["fwd"].count("dist.synchronize_tensor_parallel_output") == 1  # fc2's all-reduce
    if strategy.startswith("ddp"):  # 4 gradient all-reduces, one bucket each at 100 B
        assert res[0]["bwd"].count("dist.pack") == 0 and res[0]["bwd"].count("dist.all_reduce") == 4


@pytest.mark.parametrize("strategy", ["fsdp:3", "tp"])
def test_lossmlp_sgd_matches_jax(cluster, mlp_ref, strategy):
    """Plain SGD moves each weight by lr·g, so a gradient scaled wrong (a
    reduce-scatter or all-reduce that averages where it should sum) shows
    in the losses, which AdamW's scale-invariant update would hide."""
    x, y = _mlp_batch()
    res = cluster.call(MLP_SRC, "run", mlp_ref["init"], x, y, strategy, 64, 4, (), True)
    assert mlp_ref["sgd"][-1] < mlp_ref["sgd"][0] - 10 * LOSS_TOL  # the steps move the loss
    for r in res:
        np.testing.assert_allclose(r["losses"], mlp_ref["sgd"], atol=LOSS_TOL, rtol=0)


def test_ddp_bucketing_packs_the_gradient_all_reduces(cluster, mlp_ref):
    x, y = _mlp_batch()
    res = cluster.call(MLP_SRC, "run", mlp_ref["init"], x, y, "ddp:1", 64, 4)
    for r in res:
        np.testing.assert_allclose(r["losses"], mlp_ref["single"], atol=LOSS_TOL, rtol=0)
        assert (r["bwd"].count("dist.pack"), r["bwd"].count("dist.unpack"), r["bwd"].count("dist.all_reduce")) \
            == (1, 1, 1)


def test_ddp_window_matches_jax_single_device_window(cluster, mlp_ref):
    """A no_sync window at dp=4 (2 micro-steps and a step on the global
    batches) against thunder_tpu's single-device micro_step window on the
    same batches: the window's gradient is the sum of the micro-batches'
    mean-loss gradients either way."""
    x, y = _mlp_batch()
    rng = np.random.RandomState(5)
    window = [rng.randn(16, 16).astype(np.float32) for _ in range(3)]
    jm = JaxLossMLP(64)
    jstep = JaxTrainStep(jm, jopt.AdamW(lr=1e-2))
    want = [float(jstep(jnp.asarray(x), jnp.asarray(y))) for _ in range(2)]
    want += [float(jstep.micro_step(jnp.asarray(xw), jnp.asarray(y))) for xw in window[:-1]]
    want.append(float(jstep(jnp.asarray(window[-1]), jnp.asarray(y))))
    final = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    res = cluster.call(MLP_SRC, "run", mlp_ref["init"], x, y, "ddp:1", 64, 2, window)
    for r in res:
        np.testing.assert_allclose(r["losses"], want, atol=LOSS_TOL, rtol=0)
        for k in final:
            np.testing.assert_allclose(r["sd"][k], final[k], atol=1e-5, rtol=0, err_msg=k)


def check_state_dict(got: dict, want: dict, atol=1e-5):
    """The port's unpadded state_dict against thunder_tpu's."""
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, f"{k}: shape {got[k].shape} vs {want[k].shape}"
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def odd_runs(cluster, mlp_ref):
    x, y = _mlp_batch()
    return {z: cluster.call(MLP_SRC, "run", mlp_ref["odd_init"], x, y, f"fsdp:{z}", 30, 4) for z in (2, 3)}


@pytest.mark.parametrize("zero", [2, 3])
def test_fsdp_padded_shards_state_dict_matches_jax(mlp_ref, odd_runs, zero):
    """OddMLP: fc1's 30 rows and fc2's 30 columns... fc1.weight (30, 16) pads
    to 32 rows, 8 a rank; the state_dict comes back unpadded, equal to
    thunder_tpu's; ZeRO-3's backward re-gathers, ZeRO-2's does not."""
    res = odd_runs[zero]
    for r in res:
        np.testing.assert_allclose(r["losses"], mlp_ref["odd_losses"], atol=LOSS_TOL, rtol=0)
        check_state_dict(r["sd"], mlp_ref["odd_sd"])
    assert res[0]["local"]["fc1.weight"] == (8, 16) and res[0]["local"]["fc1.bias"] == (8,)
    # load_state_dict re-pads: every rank's stored (padded) block comes back bit for bit
    assert all(r["reloaded"] for r in res)
    n_regather = res[0]["bwd"].count("dist.all_gather")
    assert (n_regather > 0) if zero == 3 else (n_regather == 0)


def test_planted_unpad_one_row_short_fails(mlp_ref, odd_runs):
    """An unpad slice one row short gives fc1 29 rows; the state_dict check
    refuses it."""
    got = dict(odd_runs[3][0]["sd"])
    check_state_dict(got, mlp_ref["odd_sd"])
    got["fc1.weight"] = got["fc1.weight"][:-1]
    with pytest.raises(AssertionError, match="fc1.weight: shape"):
        check_state_dict(got, mlp_ref["odd_sd"])


# ---------------------------------------------------------------------------
# tiny-llama2: dryrun_multichip's phase 1 (dp × fsdp) and the MLPs at tp=2
# ---------------------------------------------------------------------------

LLAMA_SRC = '''
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch import optim
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.parallel import (GradBucketingTransform, column_parallel, ddp, fsdp, make_mesh,
                                        row_parallel)
from thunder_tpu_torch.training import TrainStep


def run(params, idx, tgt, plan, steps, window):
    cfg = tlg.Config.from_name("tiny-llama2", n_layer=3, block_size=64, vocab_size=330,
                               padded_vocab_size=330)
    m = tlg.GPTForCausalLM(cfg, device="cpu")
    tlg.load_jax_params(m, params)
    if plan == "dpxfsdp":
        tm = tt.jit(m, transforms=[GradBucketingTransform(1)])
        mesh = make_mesh({"dp": 2, "fsdp": 2})
        ddp(tm, mesh)
        fsdp(tm, mesh, min_shard_numel=1)
    else:
        tm = tt.jit(m)
        mesh = make_mesh({"dp": 2, "tp": 2})
        ddp(tm, mesh)
        mlps = [f"gpt.h.{i}.mlp" for i in range(cfg.n_layer)]
        column_parallel(tm, mesh, [f"{q}.{n}" for q in mlps for n in ("fc_1", "fc_2")])
        row_parallel(tm, mesh, [f"{q}.proj" for q in mlps])
    step = TrainStep(tm, optim.AdamW(lr=1e-3))
    losses = [float(step(torch.tensor(idx), torch.tensor(tgt))) for _ in range(steps)]
    bwd = [b.sym.id for b in tt.last_backward_traces(step)[-1].bound_symbols]
    if window:
        with tm.no_sync():
            losses.append(float(step(torch.tensor(idx), torch.tensor(tgt))))
        losses.append(float(step(torch.tensor(idx), torch.tensor(tgt))))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    return losses, {k: sd[k] for k, _ in m.named_parameters()}, bwd
'''

LLAMA_CFG = dict(n_layer=3, block_size=64, vocab_size=330, padded_vocab_size=330)
LLAMA_B, LLAMA_T, LLAMA_STEPS = 4, 32, 3


def _llama_batch(cfg):
    rng = np.random.RandomState(0)
    idx = rng.randint(0, cfg.vocab_size, (LLAMA_B, LLAMA_T)).astype(np.int32)
    tgt = rng.randint(0, cfg.vocab_size, (LLAMA_B, LLAMA_T)).astype(np.int32)
    return idx, tgt


@pytest.fixture(scope="module")
def llama_ref():
    """dryrun_multichip's phase 1 in thunder_tpu on a 2 × 2 dp × fsdp mesh:
    tiny-llama2 at n_layer=3, vocab 330 (padded shards), bucketing, AdamW,
    3 steps, then a no_sync window of one micro-step and a step; and the
    same model's 3 single-device steps (the tp=2 road's reference)."""
    from thunder_tpu.parallel.bucketing import GradBucketingTransform as JaxBucketing

    cfg = jlg.Config.from_name("tiny-llama2", **LLAMA_CFG)
    idx, tgt = _llama_batch(cfg)
    jidx, jtgt = jnp.asarray(idx), jnp.asarray(tgt)
    m = jlg.GPTForCausalLM(cfg)
    init = {k: np.asarray(p.data).copy() for k, p in m.named_parameters()}
    tm = tj.jit(m, transforms=[JaxBucketing(bucket_size_in_mb=1)])
    mesh = jmake_mesh({"dp": 2, "fsdp": 2}, devices=_devices(4))
    jddp(tm, mesh)
    jfsdp(tm, mesh, min_shard_numel=1)
    step = JaxTrainStep(tm, jopt.AdamW(lr=1e-3))
    losses = [float(step(jidx, jtgt)) for _ in range(LLAMA_STEPS)]
    with tm.no_sync():
        losses.append(float(step(jidx, jtgt)))
    losses.append(float(step(jidx, jtgt)))
    final = {k: np.asarray(v, dtype=np.float32) for k, v in tm.state_dict().items()
             if k in init}
    m1 = jlg.GPTForCausalLM(cfg)
    for k, p in m1.named_parameters():
        p.data = jnp.asarray(init[k])
    step1 = JaxTrainStep(m1, jopt.AdamW(lr=1e-3))
    single = [float(step1(jidx, jtgt)) for _ in range(LLAMA_STEPS)]
    single_final = {k: np.asarray(p.data, dtype=np.float32) for k, p in m1.named_parameters()}
    return dict(init=init, idx=idx, tgt=tgt, losses=np.array(losses), final=final,
                single=np.array(single), single_final=single_final)


def test_dp_x_fsdp_bucketed_trainstep_and_window_match_jax(cluster, llama_ref):
    ref = llama_ref
    res = cluster.call(LLAMA_SRC, "run", ref["init"], ref["idx"], ref["tgt"], "dpxfsdp", LLAMA_STEPS, True)
    for losses, params, bwd in res:
        np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_TOL, atol=0)
        for k in ref["final"]:
            np.testing.assert_allclose(params[k], ref["final"][k], atol=1e-4, rtol=0, err_msg=k)
            assert np.array_equal(params[k], res[0][1][k]), k  # bit-equal across the ranks
        # every gradient reduce-scattered over fsdp, then bucketed over dp
        assert bwd.count("dist.reduce_scatter") == len(ref["final"])
        assert bwd.count("dist.pack") >= 1
    assert res[0][1]["gpt.lm_head.weight"].shape == (330, 128)  # unpadded (330 rows pad to 332)


def test_tiny_llama_mlps_at_tp2_match_jax(cluster, llama_ref):
    ref = llama_ref
    res = cluster.call(LLAMA_SRC, "run", ref["init"], ref["idx"], ref["tgt"], "dpxtp", LLAMA_STEPS, False)
    for losses, params, bwd in res:
        np.testing.assert_allclose(losses, ref["single"], rtol=LOSS_TOL, atol=0)
        for k in ref["single_final"]:
            np.testing.assert_allclose(params[k], ref["single_final"][k], atol=1e-4, rtol=0, err_msg=k)
            assert np.array_equal(params[k], res[0][1][k]), k
        # per layer: fc_1's and fc_2's input syncs reduce in the backward
        assert bwd.count("dist.all_reduce") >= 2 * LLAMA_CFG["n_layer"]


# ---------------------------------------------------------------------------
# expert parallelism at ep=4 and ep=2 × dp=2
# ---------------------------------------------------------------------------

EP_SRC = '''
import numpy as np, torch
import thunder_tpu_torch as tt
from thunder_tpu_torch.parallel import make_mesh, prims as dp
from thunder_tpu_torch.parallel.expert_parallel import moe_ep_forward
from thunder_tpu_torch.transforms.autodiff import ThunderValueAndGrad


def run(params, x, shape, cf):
    mesh = make_mesh(shape)
    n_ep = shape["ep"]
    dp_axis = "dp" if "dp" in shape else None
    tok_axes = ("dp", "ep") if dp_axis else ("ep",)
    r = mesh.coordinate(tok_axes)
    e = mesh.coordinate("ep")
    n_loc = x.shape[0] // mesh.size(tok_axes)
    E = params["gate_w"].shape[1]
    e_loc = E // n_ep
    mine = {"gate_w": torch.tensor(params["gate_w"])}
    for k in ("w_gate", "w_up", "w_down"):
        mine[k] = torch.tensor(params[k][e * e_loc:(e + 1) * e_loc])
    xl = torch.tensor(x[r * n_loc:(r + 1) * n_loc])
    N, D = x.shape

    def fwd(p, x):
        return moe_ep_forward(p, x, mesh=mesh, dp_axis=dp_axis, n_expert_per_token=2,
                              capacity_factor=cf, return_stats=True)

    def loss(p, x):
        out = fwd(p, x)[0]
        return dp.all_reduce((out * out).sum(), tok_axes) / float(N * D)

    out, stats = tt.jit(fwd)(mine, xl)
    lval, g = ThunderValueAndGrad(loss, argnums=(0, 1))(mine, xl)
    gp, gx = g[0]
    return (out.numpy(), {k: v.numpy() for k, v in stats.items()}, float(lval),
            {k: v.numpy() for k, v in gp.items()}, gx.numpy(), (r, e, e_loc, n_loc))
'''

EP_E, EP_D, EP_H, EP_N = 8, 16, 32, 32


def _ep_inputs():
    rng = np.random.RandomState(0)
    params = {"gate_w": (rng.randn(EP_D, EP_E) * 0.1).astype(np.float32),
              "w_gate": (rng.randn(EP_E, EP_D, EP_H) * 0.1).astype(np.float32),
              "w_up": (rng.randn(EP_E, EP_D, EP_H) * 0.1).astype(np.float32),
              "w_down": (rng.randn(EP_E, EP_H, EP_D) * 0.1).astype(np.float32)}
    return params, rng.randn(EP_N, EP_D).astype(np.float32)


def _jax_ep(params, x, shape, cf):
    from thunder_tpu.parallel.expert_parallel import moe_ep_forward as jmoe

    mesh = jmake_mesh(shape, devices=_devices(4))
    dp_axis = "dp" if "dp" in shape else None
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def fwd(p, x):
        return jmoe(p, x, mesh=mesh, dp_axis=dp_axis, n_expert_per_token=2, capacity_factor=cf,
                    return_stats=True)

    def loss(p, x):
        out = fwd(p, x)[0]
        return jnp.mean(out * out)

    out, stats = jax.jit(fwd)(jp, jnp.asarray(x))
    lval, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    return (np.asarray(out), {k: np.asarray(v) for k, v in stats.items()}, float(lval),
            {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx))


def check_ep(res, want):
    """Each rank's outputs, stats, loss and gradients against thunder_tpu's
    blocks of the global ones."""
    w_out, w_stats, w_loss, w_gp, w_gx = want
    for out, stats, lval, gp, gx, (r, e, e_loc, n_loc) in res:
        rows, experts = slice(r * n_loc, (r + 1) * n_loc), slice(e * e_loc, (e + 1) * e_loc)
        np.testing.assert_allclose(out, w_out[rows], atol=EP_TOL, rtol=0, err_msg="out")
        for k in w_stats:
            np.testing.assert_allclose(stats[k], w_stats[k], atol=EP_TOL, rtol=0, err_msg=k)
        assert abs(lval - w_loss) <= EP_TOL
        np.testing.assert_allclose(gx, w_gx[rows], atol=EP_TOL, rtol=0, err_msg="grad x")
        np.testing.assert_allclose(gp["gate_w"], w_gp["gate_w"], atol=EP_TOL, rtol=0, err_msg="grad gate_w")
        for k in ("w_gate", "w_up", "w_down"):
            np.testing.assert_allclose(gp[k], w_gp[k][experts], atol=EP_TOL, rtol=0, err_msg=f"grad {k}")


@pytest.fixture(scope="module")
def ep_runs(cluster):
    params, x = _ep_inputs()
    out = {}
    for sid, shape in (("ep4", {"ep": 4}), ("ep2xdp2", {"dp": 2, "ep": 2})):
        for cf in (None, 0.5):
            out[sid, cf] = (cluster.call(EP_SRC, "run", params, x, shape, cf), _jax_ep(params, x, shape, cf))
    return out


@pytest.mark.parametrize("cf", [None, 0.5], ids=["drop_free", "drops"])
@pytest.mark.parametrize("shape", ["ep4", "ep2xdp2"])
def test_moe_ep_forward_matches_jax(ep_runs, shape, cf):
    res, want = ep_runs[shape, cf]
    check_ep(res, want)
    if cf is not None:
        assert want[1]["dropped_tokens"] > 0  # the capacity bites
    else:
        assert want[1]["dropped_tokens"] == 0


def test_planted_ep_grad_to_the_wrong_rank_fails(ep_runs):
    """The token gradients of moe_ep_forward sent back to the wrong rank
    (rank r's dx to rank r+1): the EP check refuses them."""
    res, want = ep_runs["ep4", None]
    mutated = [(*res[r][:4], res[(r + 1) % WORLD][4], res[r][5]) for r in range(WORLD)]
    with pytest.raises(AssertionError, match="grad x"):
        check_ep(mutated, want)


# ---------------------------------------------------------------------------
# in this process: micro_step, one-rank plans, plugins, refusals
# ---------------------------------------------------------------------------


def _mlp_pair():
    x, y = _mlp_batch()
    jm = JaxLossMLP()
    params = {k: np.asarray(p.data).copy() for k, p in jm.named_parameters()}
    return jm, params, torch.tensor(x), torch.tensor(y)


class _TorchMLP(torch.nn.Module):
    def __init__(self, params):
        from thunder_tpu_torch import nn
        from thunder_tpu_torch.ops import ltorch

        super().__init__()
        self.fc1 = nn.Linear(16, 64, device="cpu")
        self.fc2 = nn.Linear(64, 8, device="cpu")
        self._lt = ltorch
        with torch.no_grad():
            for k, p in self.named_parameters():
                p.copy_(torch.tensor(params[k]))

    def forward(self, x, y):
        lt = self._lt
        return lt.mse_loss(self.fc2(lt.gelu(self.fc1(x))), y)


def test_single_device_micro_step_matches_jax():
    """Two windows of 2 micro-steps and a step each (the middle one through
    no_sync), against thunder_tpu's TrainStep.micro_step."""
    jm, params, x, y = _mlp_pair()
    rng = np.random.RandomState(4)
    xs = [rng.randn(16, 16).astype(np.float32) for _ in range(6)]
    jstep = JaxTrainStep(jm, jopt.AdamW(lr=1e-2))
    m = _TorchMLP(params)
    tm = tt.jit(m)
    step = TrainStep(tm, topt.AdamW(lr=1e-2))
    want, got = [], []
    for i, xi in enumerate(xs):
        jx, tx = jnp.asarray(xi), torch.tensor(xi)
        if i % 3 == 0:
            want.append(float(jstep.micro_step(jx, jnp.asarray(y.numpy()))))
            got.append(float(step.micro_step(tx, y)))
        elif i % 3 == 1:
            want.append(float(jstep.micro_step(jx, jnp.asarray(y.numpy()))))
            with tm.no_sync():
                got.append(float(step(tx, y)))
        else:
            want.append(float(jstep(jx, jnp.asarray(y.numpy()))))
            got.append(float(step(tx, y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    for k, p in m.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(dict(jm.named_parameters())[k].data),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert step.step_count == 2 and not step._acc_open


def _tiny_llama(cfg):
    m = tlg.GPTForCausalLM(cfg, device="cpu")
    return m


ONE_RANK_PLANS = ["fsdp:2", "fsdp:3", "dpxfsdp_bucketed", "ddp_bucketed", "tp"]


def _apply_plan(tm, plan, cfg):
    if plan.startswith("fsdp"):
        fsdp(tm, make_mesh({"fsdp": 1}), zero=int(plan[-1]))
    elif plan == "dpxfsdp_bucketed":
        mesh = make_mesh({"dp": 1, "fsdp": 1})
        ddp(tm, mesh)
        fsdp(tm, mesh, min_shard_numel=1)
    elif plan == "ddp_bucketed":
        ddp(tm, make_mesh({"dp": 1}), bucket_mb=1)
    else:
        mesh = make_mesh({"tp": 1})
        mlps = [f"gpt.h.{i}.mlp" for i in range(cfg.n_layer)]
        column_parallel(tm, mesh, [f"{q}.{n}" for q in mlps for n in ("fc_1", "fc_2")])
        row_parallel(tm, mesh, [f"{q}.proj" for q in mlps])


@pytest.mark.parametrize("plan", ONE_RANK_PLANS)
def test_one_rank_sharded_plan_equals_no_plan(plan):
    """On a one-rank mesh (no process group) every collective is an identity
    and pack/unpack only move data: 3 steps, then (for DDP and FSDP) a
    no_sync window of 2 micro-steps and a step, bit-equal to no plan."""
    cfg = tlg.Config.from_name("tiny-llama2", **LLAMA_CFG)
    jm = jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2", **LLAMA_CFG))
    params = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    idx, tgt = (torch.tensor(a) for a in _llama_batch(cfg))
    window = plan != "tp"
    runs = []
    for with_plan in (False, True):
        m = _tiny_llama(cfg)
        tlg.load_jax_params(m, params)
        tm = tt.jit(m, transforms=[GradBucketingTransform(1)] if plan == "dpxfsdp_bucketed" and with_plan
                    else None)
        if with_plan:
            _apply_plan(tm, plan, cfg)
        step = TrainStep(tm, topt.AdamW(lr=1e-3))
        losses = [float(step(idx, tgt)) for _ in range(3)]
        if window:
            with tm.no_sync():
                losses += [float(step(idx, tgt)) for _ in range(2)]
            losses.append(float(step(idx, tgt)))
        runs.append((losses, tm.state_dict(), step))
    (ref_l, ref_sd, _), (got_l, got_sd, step) = runs
    assert got_l == ref_l
    assert all(torch.equal(got_sd[k], ref_sd[k]) for k in ref_sd)
    bwd = [b.sym.id for b in tt.last_backward_traces(step)[-1].bound_symbols]
    if plan == "dpxfsdp_bucketed":
        assert bwd.count("dist.pack") >= 1
    if plan.startswith("fsdp"):
        assert (bwd.count("dist.all_gather") > 0) == (plan == "fsdp:3")


def test_zero3_saves_no_gathered_parameter_under_autocast():
    """Under autocast the backward reads the weights' bf16 copies: ZeRO-3
    re-gathers and re-casts them (the forward saves only shards), ZeRO-2
    saves them; the difference is those copies' bytes exactly, and ZeRO-3
    saves nothing that ZeRO-2 does not."""
    from thunder_tpu_torch.transforms.autocast import AutocastTransform

    cfg = tlg.Config.from_name("tiny-llama2", **LLAMA_CFG)
    idx, tgt = (torch.tensor(a) for a in _llama_batch(cfg))
    saved = {}
    for zero in (2, 3):
        m = _tiny_llama(cfg)
        tm = tt.jit(m, transforms=[AutocastTransform()])
        fsdp(tm, make_mesh({"fsdp": 1}), zero=zero)
        step = TrainStep(tm, topt.AdamW(lr=1e-3))
        step(idx, tgt)
        fwd = tt.last_traces(step)[1]
        inputs = {p.name for p in fwd.args}
        saved[zero] = {p.name: p for p in fwd.bound_symbols[-1].args[0][1]
                       if hasattr(p, "shape") and p.name not in inputs}
    extra = {n: p for n, p in saved[2].items() if n not in saved[3]}
    nbytes = sum(int(np.prod(p.shape)) * p.dtype.bytes for p in extra.values())
    # the matmul weights' bf16 copies: every Linear (the embedding's gradient
    # needs no weight, and no RMSNorm weight is saved under either)
    linears = [p for k, p in m.named_parameters() if p.ndim == 2 and "wte" not in k]
    assert nbytes == sum(p.numel() * 2 for p in linears)
    assert not [n for n in saved[3] if n not in saved[2]]


def test_plugins_resolve_and_apply():
    from thunder_tpu_torch.parallel import plugins as pp
    from thunder_tpu_torch.plugins import resolve_plugin

    assert [type(resolve_plugin(n)) for n in ("ddp", "fsdp", "tp", "cp")] == [
        pp.DDP, pp.FSDP, pp.TensorParallel, pp.ContextParallel]
    cfg = tlg.Config.from_name("tiny-llama2", **LLAMA_CFG)
    tm = tt.jit(_tiny_llama(cfg))
    pp.FSDP(mesh=make_mesh({"dp": 1, "fsdp": 1})).apply_to(tm)  # hybrid: ddp over dp, then fsdp
    chains = {tuple(s.kind for s in v) for v in tm._dist_plan.param_strategies.values()}
    assert chains == {("replicate", "shard0")}
    tm2 = tt.jit(_tiny_llama(cfg))
    pp.TensorParallel(column=["gpt.h.0.mlp.fc_1"], row=["gpt.h.0.mlp.proj"]).apply_to(tm2)
    st = tm2._dist_plan.param_strategies
    assert [s.kind for s in st["gpt.h.0.mlp.fc_1.weight"]] == ["column"]
    assert [s.kind for s in st["gpt.h.0.mlp.proj.weight"]] == ["row"] and tm2._dist_plan.tp_axis == "tp"
    # compile(plugins=) lays the plan on the jitted module (one rank: no process group)
    tm3 = tt.compile(_tiny_llama(cfg), plugins=["fsdp"])
    assert {s.kind for v in tm3._dist_plan.param_strategies.values() for s in v} == {"shard0"}


def test_window_refusals():
    cfg = tlg.Config.from_name("tiny-llama2", **LLAMA_CFG)
    idx, tgt = (torch.tensor(a) for a in _llama_batch(cfg))
    tm = tt.jit(_tiny_llama(cfg))
    column_parallel(tm, make_mesh({"tp": 1}), ["gpt.h.0.mlp.fc_1"])
    with pytest.raises(NotImplementedError, match="tensor- and context-parallel"):
        TrainStep(tm, topt.AdamW(lr=1e-3)).micro_step(idx, tgt)
    from thunder_tpu_torch.robustness import StepGuard

    with pytest.raises(NotImplementedError, match="guards"):
        TrainStep(tt.jit(_tiny_llama(cfg)), topt.AdamW(lr=1e-3), guard=StepGuard()).micro_step(idx, tgt)
    with pytest.raises(ValueError, match="zero must be 2 or 3"):
        fsdp(tt.jit(_tiny_llama(cfg)), make_mesh({"fsdp": 1}), zero=1)
