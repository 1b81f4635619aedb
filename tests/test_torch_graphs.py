"""Whole-program capture (executors/graphex.py): jit(cuda_graphs=True), the
one-graph TrainStep, GPTInference's scan_decode and ServingEngine.warmup.

On the CPU a CUDA graph cannot be made, so the ``fake_graphs`` fixture
stands in for ``torch.cuda.graph``: its capture runs the program once to
record the outputs and then restores every input (a capture executes
nothing), and its replay runs the program again on the same inputs and
writes the results into the recorded outputs. Everything around the graph
is the real code: which inputs are read in place and which are copied, the
clones of the outputs, the counters' replay, the in-place buffer writes,
the capturability check. Tolerances:

* captured against op by op on the CPU: bit for bit (the same CPU ops in
  the same order);
* against thunder_tpu (tiny-llama2 f32, weights carried across): losses
  1e-4 relative and parameters 1e-4 absolute, tests/test_torch_training.py's
  f32 bars; the fp8 TinyNet and its amax histories at
  tests/test_torch_fp8.py's 1e-5; AdamW at tests/test_torch_rms_adamw.py's
  1e-6 of each tensor's largest value; greedy tokens equal.

Planted faults show that the checks can fail: a replay that does not
refresh its copied inputs, an AdamW whose step stays at 1, a capturable
trace judged so.

A TrainStep over a conv + BatchNorm + max-pool model runs train mode, then
eval mode: one program and one graph a mode, the running stats written in
place, bit for bit against op by op.

On the card (``-m gpu``; jax and thunder_tpu are imported only inside the
CPU tests' fixtures, so ``python -m pytest --noconftest -m gpu
tests/test_torch_graphs.py`` runs there): an f32 TrainStep captured against
op by op, bit for bit over 3 steps, and so a tiny ViT and ResNet step
(cuDNN deterministic) and the torch frontend's tiny Llama (chip_smoke.py's
TorchLlama, plain PyTorch: equal launches too); index_add (the embedding gradient)
the same sum every run; a greedy bf16 engine wave captured
against op by op, equal streams, equal launch counts, the pools the
caller's own tensors, no capture or compile after ``warmup``; two
back-to-back calls of one captured program; and the flash backward, ring
backward and cross-entropy kernels replayed in a CUDA graph against eager
(f32 bit for bit; bf16 backwards within an ulp: they sum with atomics).
"""
import numpy as np
import pytest
import torch

import thunder_tpu_torch as tt
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.core import prims
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.executors import cudaex, graphex, torchex
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.ops import ltorch as tlt
from thunder_tpu_torch.training import TrainStep


def _fake_capture(fn, static, pool):
    """torch.cuda.graph's stand-in on the CPU (see the module docstring)."""
    snap = [t.clone() for t in static]
    out = fn(*static)
    with torch.no_grad():
        for t, s in zip(static, snap):
            t.copy_(s)
    recorded = tree_flatten(out)[0]

    def replay():
        before = graphex._read_counters()  # a real replay runs no Python
        with torch.no_grad():
            for o, n in zip(recorded, tree_flatten(fn(*static))[0]):
                if isinstance(o, torch.Tensor) and o is not n:
                    o.copy_(n)
        graphex._add_counters([a - b for a, b in zip(before, graphex._read_counters())])

    return replay, out


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(graphex, "captures_on", lambda device: True)
    monkeypatch.setattr(graphex.CUDAGraphProgram, "_capture_fn", staticmethod(_fake_capture))


# ---------------------------------------------------------------------------
# the capturability rule (xlaex's _fusible)
# ---------------------------------------------------------------------------


def _item_fn(x):
    return x * prims.item(tlt.sum(x))


def test_trace_with_item_is_not_capturable_and_names_it(fake_graphs):
    cfn = tt.jit(_item_fn, cuda_graphs=True)
    with pytest.raises(RuntimeError, match="item"):
        cfn(torch.ones(4))
    bad = graphex.uncapturable(tt.last_traces(cfn)[-1])
    assert bad is not None and bad.sym.id == prims.PrimIDs.ITEM


def test_capturable_trace_passes_the_rule():
    """The planted contrast: the same function without ITEM is capturable,
    so the rule does not refuse every trace."""
    cfn = tt.jit(lambda x: x * tlt.sum(x))
    cfn(torch.ones(4))
    assert graphex.uncapturable(tt.last_traces(cfn)[-1]) is None
    graphex.check_capturable(tt.last_traces(cfn)[-1], "f")


# ---------------------------------------------------------------------------
# CUDAGraphProgram's input, output and counter rules
# ---------------------------------------------------------------------------


def test_outputs_survive_the_next_call_and_written_inputs_come_back(fake_graphs):
    """Two back-to-back calls: the first call's outputs keep their values;
    an input the trace writes in place (index_put on a dead input) is the
    caller's own tensor, written."""

    def f(pool, idx, val):
        return tlt.index_put(pool, (idx,), val), val * 2.0

    cfn = tt.jit(f, cuda_graphs=True)
    pool = torch.zeros(6, 3)
    outs = []
    for i in range(4):
        new_pool, dbl = cfn(pool, torch.tensor([i], dtype=torch.int64), torch.full((1, 3), float(i + 1)))
        assert new_pool is pool
        outs.append(dbl)
    for i, o in enumerate(outs):
        assert torch.equal(o, torch.full((1, 3), 2.0 * (i + 1)))
    assert torch.equal(pool[:4, 0], torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert (tt.graph_captures(cfn), tt.graph_replays(cfn)) == (1, 3)


def test_jit_module_with_cuda_graphs_replays_its_forward(fake_graphs):
    """jit(module, cuda_graphs=True): the ThunderModule's program captures,
    its Parameters read in place, and the replays equal op by op."""
    _, tm = _tinynets()
    rng = np.random.RandomState(3)
    batches = [tuple(torch.tensor(rng.standard_normal((4, D)).astype(np.float32)) for _ in range(2))
               for _ in range(3)]
    graphed, plain = tt.jit(tm, cuda_graphs=True), tt.jit(tm)
    for x, y in batches:
        assert torch.equal(graphed(x, y), plain(x, y))
    assert (tt.graph_captures(graphed), tt.graph_replays(graphed)) == (1, 2)


def test_replayed_counters_equal_op_by_op(fake_graphs, monkeypatch):
    counts = {"n": 0}
    monkeypatch.setattr(graphex, "_COUNTERS", [(counts, "n")])

    def fn(x):
        counts["n"] += 3
        return x + 1

    prog = graphex.CUDAGraphProgram(fn, name="f", in_place=[False], pool=graphex.GraphPool())
    for _ in range(5):
        prog(torch.zeros(2))
    assert counts["n"] == 15  # 1 eager, 4 replays; the capture's own count undone


def test_a_written_copied_input_is_refused():
    prog = graphex.CUDAGraphProgram(lambda x: x.add_(1), name="f", in_place=[False], pool=graphex.GraphPool())
    with pytest.raises(RuntimeError, match="in_place"):
        prog(torch.zeros(2))


# ---------------------------------------------------------------------------
# TrainStep as one graph
# ---------------------------------------------------------------------------


def _tiny_llama(seed=0):
    cfg = tlg.Config.from_name("tiny-llama2")
    torch.manual_seed(seed)
    m = tlg.GPTForCausalLM(cfg, device="cpu")
    return cfg, m


def _batches(cfg, n, B=2, T=64, seed=0):
    rng = np.random.RandomState(seed)
    return [(torch.tensor(rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)),
             torch.tensor(rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int64))) for _ in range(n)]


def _train(cuda_graphs: bool, batches, device="cpu"):
    cfg, m = _tiny_llama()
    m = m.to(device)
    step = TrainStep(tt.jit(m), topt.AdamW(lr=1e-3), cuda_graphs=cuda_graphs)
    losses = [step(x.to(device), y.to(device)).item() for x, y in batches]
    return losses, {k: p.detach().cpu().clone() for k, p in m.named_parameters()}, step


def test_train_step_graph_is_op_by_op_bit_for_bit(fake_graphs):
    cfg, _ = _tiny_llama()
    batches = _batches(cfg, 3)
    ref_l, ref_p, _ = _train(False, batches)
    got_l, got_p, step = _train(True, batches)
    assert got_l == ref_l
    assert all(torch.equal(got_p[k], ref_p[k]) for k in ref_p)
    assert (tt.graph_captures(step), tt.graph_replays(step)) == (1, 2)
    assert int(step.opt_state["step"]) == 3


def test_train_step_fault_stale_batch_is_caught(fake_graphs, monkeypatch):
    """A replay that leaves the first batch in the graph's buffers."""
    cfg, _ = _tiny_llama()
    batches = _batches(cfg, 3)
    ref_l, _, _ = _train(False, batches)
    replay = graphex._Captured.replay

    def stale(self, tensors):
        copied, self.copied = self.copied, []
        try:
            return replay(self, tensors)
        finally:
            self.copied = copied

    monkeypatch.setattr(graphex._Captured, "replay", stale)
    got_l, _, _ = _train(True, batches)
    assert got_l[0] == ref_l[0] and got_l[2] != ref_l[2]


def test_train_step_on_the_cpu_never_captures():
    cfg, _ = _tiny_llama()
    _, _, step = _train(True, _batches(cfg, 2))
    assert (tt.graph_captures(step), tt.graph_replays(step)) == (0, 0)


class _ConvBNLoss(torch.nn.Module):
    """A ResNet stem in miniature (conv, BatchNorm with its running-stat
    writes, ReLU, max pool) under a cross-entropy."""

    def __init__(self):
        super().__init__()
        from thunder_tpu_torch import nn as tnn
        from thunder_tpu_torch.models.resnet import ConvBN

        g = torch.Generator().manual_seed(0)
        self.cbn = ConvBN(3, 4, 3, 2, 1, device="cpu", generator=g)
        self.fc = tnn.Linear(4 * 16, 5, device="cpu", generator=g)

    def forward(self, x, y):
        h = tlt.max_pool2d(tlt.relu(self.cbn(x)), 3, 2, 1)
        return tlt.cross_entropy(self.fc(tlt.reshape(h, (x.shape[0], 4 * 16))), y)


def _bn_run(cuda_graphs: bool, batches):
    model = _ConvBNLoss()
    step = TrainStep(model, topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4), cuda_graphs=cuda_graphs)
    losses = [step(*b).item() for b in batches[:4]]
    model.eval()
    losses += [step(*b).item() for b in batches[4:]]
    state = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return losses, {k: t.detach().clone() for k, t in state.items()}, step


def test_train_step_graphs_are_keyed_per_mode_and_replay_buffer_writes(fake_graphs):
    """Train mode, then eval mode: each mode its own program and graph
    (a flip retraces; the eval step reads the running stats the train
    steps wrote into the module's buffers, in place), captured against op
    by op bit for bit, parameters and running stats included."""
    rng = np.random.RandomState(0)
    batches = [(torch.tensor(rng.standard_normal((2, 3, 16, 16)).astype(np.float32)),
                torch.tensor(rng.randint(0, 5, (2,)))) for _ in range(7)]
    ref_l, ref_s, _ = _bn_run(False, batches)
    got_l, got_s, step = _bn_run(True, batches)
    assert got_l == ref_l
    assert all(torch.equal(got_s[k], ref_s[k]) for k in ref_s)
    assert len(step._programs) == 2 and tt.cache_misses(step) == 2
    assert (tt.graph_captures(step), tt.graph_replays(step)) == (2, 5)  # a capture replays too
    assert not torch.equal(ref_s["cbn.bn.running_var"], torch.ones(4))


class _ItemLoss(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))

    def forward(self, x):
        return tlt.sum(x * self.w) * prims.item(tlt.sum(x))


def test_train_step_trace_with_item_is_not_captured_and_names_it(fake_graphs):
    """The warm-up step runs op by op; the call that would capture raises,
    naming ITEM, and leaves the parameters as the first step left them."""
    model = _ItemLoss()
    step = TrainStep(model, topt.AdamW(lr=1e-3))
    step(torch.ones(4))
    after_one = model.w.detach().clone()
    with pytest.raises(RuntimeError, match="item"):
        step(torch.ones(4))
    assert torch.equal(model.w.detach(), after_one)
    assert tt.graph_captures(step) == 0


def test_collective_captures_only_in_a_one_rank_nccl_group(fake_graphs, monkeypatch):
    """With no NCCL group (the CPU) a trace holding a collective is refused,
    naming it and ROADMAP A3c; where collectives capture, the same trace
    passes (the planted contrast)."""
    from thunder_tpu_torch.parallel import prims as dist_prims

    cfn = tt.jit(lambda x: dist_prims.all_reduce(x, ("sp",)) * 2.0, cuda_graphs=True)
    with pytest.raises(NotImplementedError, match="all_reduce.*A3c"):
        cfn(torch.ones(4))
    bad = graphex.uncapturable(tt.last_traces(cfn)[-1])
    assert bad is not None and bad.sym.id == dist_prims.all_reduce.id
    monkeypatch.setattr(graphex, "collectives_capture", lambda: True)
    assert graphex.uncapturable(tt.last_traces(cfn)[-1]) is None


@pytest.fixture(scope="module")
def jax_llama():
    import thunder_tpu as tj
    from thunder_tpu import optim as jopt
    from thunder_tpu.models import litgpt as jlg
    from thunder_tpu.training import TrainStep as JaxTrainStep

    return tj, jopt, jlg, JaxTrainStep


def test_graphed_train_step_matches_thunder_tpu(fake_graphs, jax_llama):
    import jax.numpy as jnp

    tj, jopt, jlg, JaxTrainStep = jax_llama
    jm = jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2"))
    cfg = tlg.Config.from_name("tiny-llama2")
    tm = tlg.GPTForCausalLM(cfg, device="cpu")
    tlg.load_jax_params(tm, {k: np.asarray(p.data) for k, p in jm.named_parameters()})
    js = JaxTrainStep(tj.jit(jm), jopt.AdamW(lr=1e-3))
    ts = TrainStep(tt.jit(tm), topt.AdamW(lr=1e-3))
    jl, tl_ = [], []
    for x, y in _batches(cfg, 3, seed=3):
        jl.append(float(js(jnp.asarray(x.numpy()), jnp.asarray(y.numpy().astype(np.int32)))))
        tl_.append(float(ts(x, y)))
    np.testing.assert_allclose(tl_, jl, rtol=1e-4, atol=0)
    jp = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[k], atol=1e-4, rtol=0, err_msg=k)
    assert tt.graph_replays(ts) == 2


# ---------------------------------------------------------------------------
# buffer writes under capture: fp8 amax histories
# ---------------------------------------------------------------------------

D = 256


def _tinynets():
    from thunder_tpu import nn as jnn
    from thunder_tpu.ops import ltorch as jlt

    from thunder_tpu_torch import nn as tnn

    class JaxTinyNet(jnn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(D, D, seed=0)
            self.fc2 = jnn.Linear(D, D, seed=1)

        def forward(self, x, y):
            return jlt.mse_loss(self.fc2(jlt.relu(self.fc1(x))), y)

    class TinyNet(tnn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = tnn.Linear(D, D, device="cpu")
            self.fc2 = tnn.Linear(D, D, device="cpu")

        def forward(self, x, y):
            return tlt.mse_loss(self.fc2(tlt.relu(self.fc1(x))), y)

    jm, tm = JaxTinyNet(), TinyNet()
    with torch.no_grad():
        for k, p in tm.named_parameters():
            p.copy_(torch.tensor(np.asarray(dict(jm.named_parameters())[k].data)))
    return jm, tm


def test_effects_in_place_keep_buffers_and_amax_histories_match_thunder_tpu(fake_graphs, jax_llama):
    import jax.numpy as jnp
    from thunder_tpu.transforms import fp8_training as jfp8

    from thunder_tpu_torch.transforms import fp8_training as tfp8

    tj, jopt, _, JaxTrainStep = jax_llama
    jm, tm = _tinynets()
    js = JaxTrainStep(tj.jit(jm, transforms=[jfp8.FP8TrainingTransform()]), jopt.SGD(lr=0.05))
    ts = TrainStep(tt.jit(tm, transforms=[tfp8.FP8TrainingTransform()]), topt.SGD(lr=0.05))
    rng = np.random.RandomState(1)
    x, y = (rng.standard_normal((32, D)).astype(np.float32) for _ in range(2))
    jl, tl_ = [], []
    ids = None
    for _ in range(3):
        jl.append(float(js(jnp.asarray(x), jnp.asarray(y))))
        tl_.append(float(ts(torch.tensor(x), torch.tensor(y))))
        now = {k: id(b) for k, b in tm.named_buffers() if "fp8_amax" in k}
        assert ids is None or now == ids  # written in place, never rebound
        ids = now
    assert len(ids) == 4 and tt.graph_replays(ts) == 2
    np.testing.assert_allclose(tl_, jl, rtol=1e-5)
    jh = {k: np.asarray(b) for k, b in jm.named_buffers() if "fp8_amax" in k}
    for k, b in tm.named_buffers():
        if "fp8_amax" in k:
            np.testing.assert_allclose(b.numpy(), jh[k], rtol=1e-5, err_msg=k)
            assert (b[:3] > 0).all()


# ---------------------------------------------------------------------------
# AdamW with its step on the device
# ---------------------------------------------------------------------------


def _adamw_five_steps(step_fault: bool = False):
    import jax.numpy as jnp
    from thunder_tpu import optim as jopt

    rng = np.random.RandomState(2)
    shapes = {"w": (33, 17), "b": (17,), "s": ()}
    params = {k: np.asarray(0.05 * rng.randn(*s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(1e-2 * rng.randn(*s), np.float32) for k, s in shapes.items()} for _ in range(5)]
    jo, to = jopt.AdamW(lr=1e-2, weight_decay=0.1), topt.AdamW(lr=1e-2, weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        to.update(tp, {k: torch.tensor(v) for k, v in g.items()}, ts)
        if step_fault:
            ts["step"].fill_(0)  # every update replays step 1's corrections
    return jp, js, tp, ts


@pytest.mark.parametrize("fault", [False, True], ids=["device_step", "fault_step_stuck"])
def test_adamw_device_step_matches_thunder_tpu_over_five_steps(fault):
    jp, js, tp, ts = _adamw_five_steps(fault)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    worst = 0.0
    for k in jp:
        for a, b in ((jp[k], tp[k]), (js["m"][k], ts["m"][k]), (js["v"][k], ts["v"][k])):
            a = np.asarray(a, np.float32)
            worst = max(worst, np.abs(b.numpy() - a).max() / max(np.abs(a).max(), 1e-30))
    if fault:
        assert worst > 1e-6
    else:
        assert int(ts["step"]) == 5 and worst <= 1e-6


def test_adamw_corrections_are_f32_from_the_step():
    bc1, bc2 = cudaex.adamw_corrections(torch.tensor(3, dtype=torch.int32), 0.9, 0.999)
    assert bc1.dtype == bc2.dtype == torch.float32
    assert float(bc1) == np.float32(1.0) - np.float32(0.9) ** np.float32(3)


# ---------------------------------------------------------------------------
# GPTInference.generate(scan_decode=True)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_generate():
    import jax.numpy as jnp
    from thunder_tpu.inference import GPTInference as JaxInference
    from thunder_tpu.models import litgpt as jlg

    from thunder_tpu_torch.inference import GPTInference

    jg = jlg.GPT(jlg.Config.from_name("tiny-llama2"))
    cfg = tlg.Config.from_name("tiny-llama2")
    tg = tlg.GPT(cfg, torch.float32, device="cpu")
    tlg.load_jax_params(tg, {k: np.asarray(p.data) for k, p in jg.named_parameters()})
    prompt = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jout, _ = JaxInference(jg, max_seq=40, dtype=jnp.float32).generate(jnp.asarray(prompt), 9,
                                                                       scan_decode=True)
    return np.asarray(jout), prompt, lambda: GPTInference(tg, max_seq=40, dtype=torch.float32)


@pytest.mark.parametrize("graphed", [False, True], ids=["cpu_loop", "graph"])
def test_scan_decode_gives_thunder_tpus_tokens(request, jax_generate, graphed):
    jout, prompt, make = jax_generate
    if graphed:
        request.getfixturevalue("fake_graphs")
    eng = make()
    for _ in range(2):  # the second call replays the signature's graph
        out, m = eng.generate(torch.tensor(prompt), 9, scan_decode=True)
        np.testing.assert_array_equal(out.numpy(), jout)
        assert m.top2_gap.shape == (2, 9)
    want = (1, 2) if graphed else (0, 0)
    assert (tt.graph_captures(eng._decode_cfn), tt.graph_replays(eng._decode_cfn)) == want
    loop, _ = eng.generate(torch.tensor(prompt), 9, scan_decode=False)
    np.testing.assert_array_equal(loop.numpy(), jout)


def test_scan_decode_fault_frozen_position_is_caught(fake_graphs, jax_generate, monkeypatch):
    """A decode loop that writes every step at the first position."""
    jout, prompt, make = jax_generate
    eng = make()
    decode = eng._decode_cfn

    class Frozen:
        _cs = decode._cs

        def __call__(self, p, t, ks, vs, pos):
            return decode(p, t, ks, vs, pos * 0 + 12)

    monkeypatch.setattr(eng, "_decode_cfn", Frozen())
    out, _ = eng.generate(torch.tensor(prompt), 9, scan_decode=True)
    assert not np.array_equal(out.numpy(), jout)


# ---------------------------------------------------------------------------
# ServingEngine(cuda_graphs=True) and warmup
# ---------------------------------------------------------------------------


def _engine(graphs: bool, **kw):
    from thunder_tpu_torch.serving import ServingEngine

    cfg = tlg.Config.from_name("tiny-llama2")
    gpt = tlg.GPT(cfg, torch.float32, device="cpu", seed=0)
    return ServingEngine(gpt, max_batch=4, page_size=16, max_seq=128, dtype=torch.float32, device="cpu",
                         cuda_graphs=graphs, **kw), cfg


def _engine_cfns(engine):
    runners = [engine.runner] + ([engine.draft_runner] if engine.draft_runner is not None else [])
    return [getattr(r, n) for r in runners for n in ("prefill_cfn", "decode_cfn", "chunk_cfn", "verify_cfn")]


def _wave(engine, prompts, n_new=6):
    futs = [engine.submit(p, n_new) for p in prompts]
    engine.drain()
    return [f.result().new_tokens.tolist() for f in futs]


@pytest.mark.parametrize("stages", [{}, dict(prefix_sharing=True, chunk_tokens=32, spec_k=2)],
                         ids=["plain", "fleet"])
def test_engine_graphs_match_op_by_op_and_warmup_captures_all(fake_graphs, stages):
    rng = np.random.RandomState(5)
    lens = (9, 20, 40, 70)
    prompts = [rng.randint(0, 200, (n,)).astype(np.int32) for n in lens]
    streams = []
    for graphs in (False, True):
        kw = dict(stages)
        if kw.get("spec_k"):
            kw["draft_gpt"] = tlg.GPT(tlg.Config.from_name("tiny-llama2"), torch.float32, device="cpu", seed=1)
        engine, _ = _engine(graphs, **kw)
        engine.warmup(lens)
        pools = tuple(engine.cache.k_pages) + tuple(engine.cache.v_pages)
        before = [(tt.cache_misses(c), tt.graph_captures(c)) for c in _engine_cfns(engine)]
        streams.append(_wave(engine, prompts))
        after = [(tt.cache_misses(c), tt.graph_captures(c)) for c in _engine_cfns(engine)]
        assert after == before  # the wave compiles and captures nothing
        assert all(a is b for a, b in zip(pools, tuple(engine.cache.k_pages) + tuple(engine.cache.v_pages)))
        replays = sum(tt.graph_replays(c) for c in _engine_cfns(engine))
        assert (replays > 0) == graphs
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_f32_train_step_captured_is_op_by_op_bit_for_bit(cuda):
    """tiny-llama2 f32 (the flash-RoPE f32 kernels, the AdamW kernel), a new
    batch each step: losses and parameters bit-equal over 3 steps."""
    cfg, _ = _tiny_llama()
    batches = _batches(cfg, 3)
    ref_l, ref_p, ref = _train(False, batches, cuda)
    got_l, got_p, step = _train(True, batches, cuda)
    assert got_l == ref_l
    assert all(torch.equal(got_p[k], ref_p[k]) for k in ref_p)
    assert (tt.graph_captures(step), tt.graph_replays(step)) == (1, 2)
    assert int(step.opt_state["step"]) == int(ref.opt_state["step"]) == 3


def _vision_step(kind: str, cuda_graphs: bool, device):
    """A tiny f32 vision TrainStep on ``device``: ViT's ``test`` config
    under AdamW (the flash pair at T = 17, full; the AdamW kernel) or
    ResNet's bottleneck variant under torchvision's SGD (cuDNN convs, the
    max pool, BatchNorm running-stat writes)."""
    from thunder_tpu_torch.models import resnet as tr
    from thunder_tpu_torch.models import vit as tv

    if kind == "vit":
        model = tv.ViTForClassification(tv.configs["test"], device=device, seed=0)
        opt = topt.AdamW(lr=1e-3)
    else:
        model = _ResNetLoss(tr.ResNet(tr.ResNetConfig(block="bottleneck", layers=(1, 1), num_classes=4,
                                                      width=8), device=device, seed=0))
        opt = topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    return TrainStep(model, opt, cuda_graphs=cuda_graphs), model


class _ResNetLoss(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, y):
        return tlt.cross_entropy(self.net(x), y)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["vit", "resnet"])
def test_card_vision_train_step_captured_is_op_by_op_bit_for_bit(cuda, kind):
    """f32, a new batch each of 3 steps, cuDNN's deterministic algorithms
    (its weight-gradient algorithms may sum with atomics otherwise):
    losses, parameters and running stats bit-equal, captured against op by
    op; the captured step replays."""
    rng = np.random.RandomState(2)
    batches = [(torch.tensor(rng.standard_normal((2, 3, 32, 32)).astype(np.float32), device=cuda),
                torch.tensor(rng.randint(0, 4, (2,)), device=cuda)) for _ in range(3)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for graphs in (False, True):
            step, model = _vision_step(kind, graphs, cuda)
            losses = [step(*b).item() for b in batches]
            state = {k: t.detach().clone() for k, t in [*model.named_parameters(), *model.named_buffers()]}
            runs.append((losses, state, step))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (ref_l, ref_s, _), (got_l, got_s, step) = runs
    assert got_l == ref_l
    assert all(torch.equal(got_s[k], ref_s[k]) for k in ref_s)
    assert (tt.graph_captures(step), tt.graph_replays(step)) == (1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [0, 1])
def test_card_index_add_sums_repeated_indices_in_a_fixed_order(cuda, dim):
    """torchex's index_add (the embedding gradient) on the card: 8,192
    slices into 64, each index ~128 times, f32: five runs bit-equal, and
    within 1e-5 of max |ref| of the CPU's index_add (another order)."""
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 64, (8192,), generator=gen, dtype=torch.int32)
    src = torch.randn(8192, 256, generator=gen).movedim(0, dim).contiguous()
    zeros = torch.zeros(64, 256).movedim(0, dim).contiguous()
    ref = zeros.index_add(dim, idx, src)
    runs = [torchex._index_add(zeros.to(cuda), idx.to(cuda), src.to(cuda), dim).cpu() for _ in range(5)]
    assert all(torch.equal(r, runs[0]) for r in runs)
    assert (runs[0] - ref).abs().max() <= 1e-5 * ref.abs().max()


def _card_engine(cuda, graphs: bool):
    from thunder_tpu_torch.serving import ServingEngine

    cfg = tlg.Config.from_name("tiny-llama2")
    gpt = tlg.GPT(cfg, torch.bfloat16, device=cuda, seed=0)
    return ServingEngine(gpt, max_batch=4, page_size=16, max_seq=256, dtype=torch.bfloat16, device=cuda,
                         cuda_graphs=graphs)


def _frontend_llama(device, graphs: bool):
    """chip_smoke.py's TorchLlama (plain PyTorch) at tiny-llama2, f32, with
    a port GPTForCausalLM's seeded weights, jitted: the torch frontend."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    cfg = tlg.Config.from_name("tiny-llama2")
    user = chip_smoke.torch_llama_from(tlg.GPTForCausalLM(cfg, torch.float32, device=device, seed=0))
    return cfg, tt.jit(user, cuda_graphs=graphs)


def _frontend_runs(device):
    """The frontend Llama's losses and kernel launches over 3 new batches,
    op by op and captured; the captured program."""
    from thunder_tpu_torch.interop.torch_frontend import CompiledTorchModule

    counters = (cudaex.flash_attention, cudaex.rms_norm, cudaex.cross_entropy)
    runs = []
    for graphs in (False, True):
        cfg, fn = _frontend_llama(device, graphs)
        assert isinstance(fn, CompiledTorchModule)
        rng = np.random.RandomState(9)
        n0 = [c.launches for c in counters]
        losses = [fn(*(torch.tensor(rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32), device=device)
                       for _ in range(2))).item() for _ in range(3)]
        runs.append((losses, [c.launches - n for c, n in zip(counters, n0)], fn))
    return runs


def test_frontend_module_captured_equals_op_by_op(fake_graphs):
    """jit of a plain-PyTorch module (the torch frontend) with cuda_graphs:
    the captured program replays, bit for bit with op by op."""
    (ref, ref_n, _), (got, got_n, fn) = _frontend_runs(torch.device("cpu"))
    assert got == ref and got_n == ref_n
    assert (tt.graph_captures(fn), tt.graph_replays(fn)) == (1, 2)


@pytest.mark.gpu
def test_card_frontend_llama_captured_is_op_by_op_bit_for_bit(cuda):
    """The frontend Llama (flash forward, RMSNorm and cross-entropy kernels
    claimed from F.* calls), f32, 3 new batches: losses bit-equal captured
    and op by op, and equal launches of each kernel."""
    (ref, ref_n, _), (got, got_n, fn) = _frontend_runs(cuda)
    assert got == ref
    assert got_n == ref_n and all(ref_n)
    assert (tt.graph_captures(fn), tt.graph_replays(fn)) == (1, 2)


@pytest.mark.gpu
def test_card_engine_wave_captured_equals_op_by_op(cuda):
    """A greedy bf16 wave: equal streams and equal rms_norm / paged-attention
    launch counts captured and op by op; after warmup the wave compiles and
    captures nothing; the pools come back as the caller's tensors."""
    rng = np.random.RandomState(7)
    lens = (5, 30, 70, 130)
    prompts = [rng.randint(0, 200, (n,)).astype(np.int32) for n in lens]
    streams, counts = [], []
    for graphs in (False, True):
        engine = _card_engine(cuda, graphs)
        engine.warmup(lens)
        pools = tuple(engine.cache.k_pages) + tuple(engine.cache.v_pages)
        before = [(tt.cache_misses(c), tt.graph_captures(c)) for c in _engine_cfns(engine)]
        cudaex.rms_norm.launches = cudaex.paged_attention.launches = 0
        streams.append(_wave(engine, prompts, 12))
        torch.cuda.synchronize()
        counts.append((cudaex.rms_norm.launches, cudaex.paged_attention.launches))
        assert [(tt.cache_misses(c), tt.graph_captures(c)) for c in _engine_cfns(engine)] == before
        assert all(a is b for a, b in zip(pools, tuple(engine.cache.k_pages) + tuple(engine.cache.v_pages)))
        assert (sum(tt.graph_replays(c) for c in _engine_cfns(engine)) > 0) == graphs
    assert streams[0] == streams[1]
    assert counts[0] == counts[1] and all(counts[0])


@pytest.mark.gpu
def test_card_back_to_back_calls_keep_the_first_outputs(cuda):
    def f(pool, idx, val):
        return tlt.index_put(pool, (idx,), val), val * 2.0

    cfn = tt.jit(f, cuda_graphs=True)
    pool = torch.zeros(6, 3, device=cuda)
    outs = []
    for i in range(4):
        new_pool, dbl = cfn(pool, torch.tensor([i], device=cuda), torch.full((1, 3), float(i + 1), device=cuda))
        assert new_pool is pool
        outs.append(dbl)
    torch.cuda.synchronize()
    for i, o in enumerate(outs):
        assert torch.equal(o.cpu(), torch.full((1, 3), 2.0 * (i + 1)))
    assert torch.equal(pool[:4, 0].cpu(), torch.tensor([1.0, 2.0, 3.0, 4.0]))
    assert (tt.graph_captures(cfn), tt.graph_replays(cfn)) == (1, 3)


def _replayed(run, inputs, refill):
    """run() eager, then captured and replayed on rewritten inputs: pairs of
    (replayed outputs, eager outputs on the same inputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    pairs = []
    for seed in (21, 22):
        refill(inputs, seed)
        graph.replay()
        torch.cuda.synchronize()
        pairs.append(([o.clone() for o in outs], run()))
    torch.cuda.synchronize()
    return pairs


def _refill_randn(inputs, seed):
    g = torch.Generator(device=inputs[0].device).manual_seed(seed)
    for t in inputs:
        t.copy_(torch.randn(t.shape, device=t.device, generator=g))


def _assert_replay(pairs, dtype):
    for got, want in pairs:
        for a, b in zip(got, want):
            if dtype == torch.float32:
                assert torch.equal(a, b)
            else:  # bf16 backwards sum with atomics: an ulp apart at most
                assert torch.allclose(a.float(), b.float(), rtol=2 ** -7, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_backward_in_a_cuda_graph_equals_eager(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, 300, 64, device=cuda, generator=g).to(dtype) for _ in range(4))
    o, lse = cudaex.flash_attention(q, k, v, True)
    run = lambda: cudaex.flash_attention_backward(q, k, v, o, lse, do, True)  # noqa: E731
    _assert_replay(_replayed(run, [q, k, v, do], _refill_randn), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ring_backward_in_a_cuda_graph_equals_eager(cuda, dtype):
    """The diagonal ring step's backward (GQA), lse and delta from the plain
    forward step."""
    g = torch.Generator(device=cuda).manual_seed(4)
    B, H, Hkv, T, D = 1, 4, 2, 256, 64
    q, do = (torch.randn(B, H, T, D, device=cuda, generator=g).to(dtype) for _ in range(2))
    kb, vb = (torch.randn(B, Hkv, T, D, device=cuda, generator=g).to(dtype) for _ in range(2))
    o = torch.zeros(B, H, T, D, device=cuda)
    m = torch.full((B, H, T, 1), cudaex.NEG_INF, device=cuda)
    l = torch.zeros(B, H, T, 1, device=cuda)
    o, m, l = cudaex.ring_flash_step_plain(q, kb, vb, o, m, l, T, T, True)
    lse = ((m + torch.log2(l)) * cudaex.LN2).contiguous()
    delta = (do.float() * (o / l)).sum(-1, keepdim=True).contiguous()
    run = lambda: cudaex.ring_flash_bwd_step(q, kb, vb, do, lse, delta, T, T, True)  # noqa: E731
    _assert_replay(_replayed(run, [q, kb, vb, do], _refill_randn), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cross_entropy_in_a_cuda_graph_equals_eager(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    logits = torch.randn(513, 32000, device=cuda, generator=g).to(dtype)
    targets = torch.randint(0, 32000, (513,), device=cuda, generator=g)
    targets[::97] = -100
    run = lambda: cudaex.cross_entropy(logits, targets)  # noqa: E731
    _assert_replay(_replayed(run, [logits], _refill_randn), torch.float32)  # f32 outputs, no atomics
