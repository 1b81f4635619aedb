"""RMSNorm's launch plan and the one-pass AdamW update: on the CPU, and on a
CUDA card (``-m gpu``) the kernels against their plain versions.

On the CPU:

* ``cudaex.rms_norm_plan`` for N from 0 to 4,096 rows at every route: the
  grid's row groups walk every row exactly once, a row's lanes hold all its
  vectors, and no block passes 512 threads.
* AdamW's tables: the chunk table covers every element of every updated
  tensor exactly once, the tensor table lists each tensor's addresses,
  numel and dtypes, and a None gradient leaves its tensor out.
* A NumPy f32 emulation of csrc/adamw.cu's per-element sequence (each step
  one f32 operation: fused multiply-adds where torch's add-with-alpha and
  addcmul fuse, true division and square root) against ``adamw_plain``
  (the ``torch._foreach_*`` chain) over three steps, p in f32 and bf16,
  weight decay on and off, on inputs that cancel in m: bit for bit with the
  CPU build's square root, within one ulp with IEEE's (the kernel's; p's ulp
  taken at the larger of its values before and after the step).
* ``optim.AdamW`` against ``thunder_tpu.optim.AdamW`` over three steps: f32
  p, m and v within 1e-6 of each tensor's largest |value| (both take each
  step in f32, XLA with its own fusion; thunder_tpu computes 1 - 0.999^t in
  f32, 1.3e-5 off the port's at t = 1, which moves an update by ~6e-6 of
  lr); bf16 p within one bf16 ulp a step (3): that shift can turn a step's
  rounding to bf16 the other way, and the next steps carry it.
* A planted fault fails each bar: a plan one block short, a chunk table
  that loses a tensor's last chunk, an emulation that rounds (1-b1)·g before
  the add, and an update that decays after the step.

On the card (``python -m pytest --noconftest -m gpu
tests/test_torch_rms_adamw.py``; this file imports no jax at module level):
rms_norm against its plain version for N in {0, 1, 3, 8, 129, 512, 1024},
bf16, f16 and f32, D from 64 to the checker's largest (KERNEL_TOL: an ulp
in bf16/f16, 1e-5 in f32), every flag of the plan bit-equal to the default
launch, and a CUDA-graph replay bit-equal to the eager call; the AdamW
kernel against ``adamw_plain`` over two updates (the second on the cached
tables) with mixed p and g dtypes, odd numels, misaligned views, empty and
0-d tensors and None gradients: m, v and f32 p within 1e-6 of the largest
|value| of their tensor (the card's chain may take a product unfused or a
quotient through a reciprocal: an ulp), bf16 p within 2^-7 and f16 within
2^-10 of it (one ulp at the largest value)."""
import numpy as np
import pytest
import torch

from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.executors import cudaex

HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8)


# ---------------------------------------------------------------------------
# rms_norm_plan
# ---------------------------------------------------------------------------


def _plan_rows(plan: dict, N: int) -> np.ndarray:
    """How many times csrc/rms_norm.cu's grid visits each of the N rows:
    group g of block b takes row b * rows_per_block + g."""
    rows = np.arange(plan["blocks"] * plan["rows_per_block"])
    return np.bincount(rows[rows < N], minlength=N)


def _plan_ok(plan: dict, N: int, D: int, dtype) -> None:
    nvec = D // cudaex._vec(dtype)
    assert (_plan_rows(plan, N) == 1).all()
    assert plan["vpl"] in (1, 2, 4, 8) and plan["vpl"] * 32 * plan["wpr"] >= nvec
    assert plan["threads"] == 32 * plan["wpr"] * plan["rows_per_block"] <= 512
    assert plan["wpr"] <= 16 and (plan["wpr"] == 1 or plan["rows_per_block"] <= 15)
    assert plan["blocks"] == -(-N // plan["rows_per_block"])


@pytest.mark.parametrize("D,dtype", [(64, torch.bfloat16), (2048, torch.bfloat16), (2048, torch.float32),
                                     (4096, torch.bfloat16), (32768, torch.bfloat16), (16384, torch.float32)],
                         ids=["64bf16", "2048bf16", "2048f32", "4096bf16", "max-bf16", "max-f32"])
def test_rms_plan_visits_every_row_once(D, dtype):
    for N in range(0, 4097):
        _plan_ok(cudaex.rms_norm_plan(N, D, dtype), N, D, dtype)


def test_rms_plan_routes():
    bf = torch.bfloat16
    assert cudaex.rms_norm_plan(8, 2048, bf) == {"route": "decode", "vpl": 2, "wpr": 4, "rows_per_block": 1,
                                                 "threads": 128, "blocks": 8, "flags": cudaex.RMS_PDL}
    assert cudaex.rms_norm_plan(512, 2048, bf) == {"route": "prefill", "vpl": 2, "wpr": 4, "rows_per_block": 2,
                                                   "threads": 256, "blocks": 256, "flags": cudaex.RMS_PDL}
    assert cudaex.rms_norm_plan(512, 2048, torch.float32)["wpr"] == 8
    wide = cudaex.rms_norm_plan(300, 32768, bf)
    assert (wide["wpr"], wide["vpl"], wide["rows_per_block"]) == (16, 8, 1)


def test_rms_plan_fault_one_block_short_is_caught():
    plan = dict(cudaex.rms_norm_plan(513, 2048, torch.bfloat16))
    plan["blocks"] -= 1
    with pytest.raises(AssertionError):
        _plan_ok(plan, 513, 2048, torch.bfloat16)


def test_rms_checker_accepts_every_width_it_did():
    """Every D the checker takes has a plan (the kernel's range is the
    checker's: up to 4,096 vectors of 16 bytes)."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        v = cudaex._vec(dtype)
        for D in range(v, cudaex._RMS_MAX_VECS * v + 1, v):
            plan = cudaex.rms_norm_plan(3, D, dtype)
            assert plan["vpl"] * 32 * plan["wpr"] >= D // v and plan["wpr"] <= 16


# ---------------------------------------------------------------------------
# AdamW tables
# ---------------------------------------------------------------------------

NUMELS = [0, 1, 7, 65535, 65536, 65537, 200_003, 3 * 65536]


def _coverage(chunks: torch.Tensor, numels: list) -> list:
    """Per tensor, how many times the chunk table's chunks cover each element."""
    seen = [np.zeros(n, np.int64) for n in numels]
    for c in chunks.tolist():
        t, i = c >> 32, c & 0xFFFFFFFF
        seen[t][i * cudaex._ADAMW_CHUNK:(i + 1) * cudaex._ADAMW_CHUNK] += 1
    return seen


def test_adamw_chunks_cover_every_element_once():
    seen = _coverage(cudaex.adamw_chunks(NUMELS), NUMELS)
    assert all((s == 1).all() for s in seen)
    assert cudaex.adamw_chunks([]).numel() == 0


def test_adamw_chunks_fault_losing_a_last_chunk_is_caught():
    chunks = cudaex.adamw_chunks(NUMELS)
    bad = torch.cat([chunks[:3], chunks[4:]])  # tensor 3's (65535 elements) only chunk
    assert not all((s == 1).all() for s in _coverage(bad, NUMELS))


def test_adamw_entries_list_addresses_numel_and_dtypes():
    ps = [torch.zeros(n) for n in (3, 5)]
    gs = [torch.zeros(3, dtype=torch.bfloat16), torch.zeros(5, dtype=torch.float16)]
    ms, vs = [torch.zeros(3), torch.zeros(5)], [torch.zeros(3), torch.zeros(5)]
    rows = cudaex.adamw_entries(ps, gs, ms, vs).tolist()
    assert rows == [[ps[0].data_ptr(), gs[0].data_ptr(), ms[0].data_ptr(), vs[0].data_ptr(), 3, 0 | 1 << 4],
                    [ps[1].data_ptr(), gs[1].data_ptr(), ms[1].data_ptr(), vs[1].data_ptr(), 5, 0 | 2 << 4]]


def test_adamw_update_skips_none_gradients(monkeypatch):
    seen = {}
    monkeypatch.setattr(cudaex, "adamw_plain", lambda ps, gs, ms, vs, **kw: seen.update(ps=ps, gs=gs))
    ps = [torch.ones(3), torch.ones(4), torch.ones(5)]
    gs = [torch.ones(3), None, torch.ones(5)]
    cudaex.adamw_update(ps, gs, [torch.zeros(3), torch.zeros(4), torch.zeros(5)],
                        [torch.zeros(3), torch.zeros(4), torch.zeros(5)], weight_decay=0.0, step=1, **HYPER)
    assert [p.numel() for p in seen["ps"]] == [3, 5] and [g.numel() for g in seen["gs"]] == [3, 5]
    seen.clear()
    cudaex.adamw_update(ps[1:2], gs[1:2], [torch.zeros(4)], [torch.zeros(4)], weight_decay=0.0, step=1, **HYPER)
    assert not seen


# ---------------------------------------------------------------------------
# The kernel's per-element sequence, emulated in NumPy f32
# ---------------------------------------------------------------------------

f32 = np.float32


def _fma(a, b, c):
    """f32 fused multiply-add: the product exact in f64, one rounding."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(f32)


def _cpu_sqrt(a: np.ndarray) -> np.ndarray:
    """torch's square root on the CPU (this build's differs from IEEE's in
    the last bit at ~0.6 % of inputs)."""
    return torch.sqrt(torch.from_numpy(a)).numpy()


def _emulate(p, g, m, v, *, lr, beta1, beta2, eps, weight_decay, step, sqrt=np.sqrt, fused_m=True):
    """csrc/adamw.cu's step on f32 arrays (p given in f32; the caller rounds
    to p's dtype), with IEEE square roots (np.sqrt) unless told otherwise.
    fused_m=False is a planted fault: (1-b1)·g rounded before the add."""
    b1, a1, b2, a2 = f32(beta1), f32(1.0 - beta1), f32(beta2), f32(1.0 - beta2)
    # the bias corrections in f32 from the step, as the chain and the kernel take them
    bc1, bc2 = (f32(c) for c in cudaex.adamw_corrections(step, beta1, beta2))
    m = _fma(a1, g, m * b1) if fused_m else (m * b1 + a1 * g).astype(f32)
    v = _fma(a2 * g, g, v * b2)
    upd = (m / bc1) / (sqrt(v / bc2) + f32(eps))
    if weight_decay:
        p = p - p * f32(lr * weight_decay)
    return _fma(f32(-lr), upd, p), m, v


def _ulp(x: np.ndarray, dtype) -> np.ndarray:
    """The spacing of dtype's values at |x| (x given in f32)."""
    sp = np.spacing(np.abs(x).astype(f32))
    return sp * 2.0 ** 16 if dtype == torch.bfloat16 else sp


def _cancelling_inputs(rng, n=200_000):
    m = (1e-3 * rng.randn(n)).astype(f32)
    # half the gradients cancel b1·m in m's update
    g = np.where(rng.rand(n) < 0.5, -9 * m * (1 + 1e-3 * rng.randn(n)), 1e-3 * rng.randn(n)).astype(f32)
    v = (1e-6 * rng.rand(n)).astype(f32)
    p = (0.02 * rng.randn(n)).astype(f32)
    return p, g, m, v


def _emulation_ulps(p_dtype, wd, sqrt=np.sqrt, fused_m=True) -> dict:
    """Three steps of adamw_plain, each emulated from the chain's state
    before it: the largest gap in ulps of p, m and v, m and v at their value,
    p at its step's largest operand (p before, p after or lr·upd: a step
    that nearly cancels p makes a result whose own ulp no operand carries)."""
    rng = np.random.RandomState(0)
    p, g, m, v = _cancelling_inputs(rng)
    state = [torch.tensor(p).to(p_dtype)], [torch.tensor(m)], [torch.tensor(v)]
    worst = dict(p=0.0, m=0.0, v=0.0)
    for step in (1, 2, 3):
        gs = g * f32(1 + 0.1 * step)
        p0, m0, v0 = (t[0].float().numpy().copy() for t in state)
        cudaex.adamw_plain(state[0], [torch.tensor(gs)], state[1], state[2], weight_decay=wd, step=step, **HYPER)
        p, m, v = _emulate(p0, gs, m0, v0, weight_decay=wd, step=step, sqrt=sqrt, fused_m=fused_m, **HYPER)
        p = torch.tensor(p).to(p_dtype).float().numpy()
        moved = np.abs(p0 - _emulate(p0, gs, m0, v0, weight_decay=0.0, step=step, sqrt=sqrt, **HYPER)[0])
        p_scale = np.maximum(np.maximum(np.abs(p0), np.abs(p)), moved)
        for name, got, want, scale, dt in (("p", p, state[0][0].float().numpy(), p_scale, p_dtype),
                                           ("m", m, state[1][0].numpy(), m, torch.float32),
                                           ("v", v, state[2][0].numpy(), v, torch.float32)):
            gap = np.abs(got.astype(np.float64) - want) / np.maximum(_ulp(scale, dt), np.finfo(f32).tiny)
            worst[name] = max(worst[name], float(gap.max()))
    return worst


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no_decay", "decay"])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_sequence_is_the_chain_bit_for_bit_with_its_sqrt(p_dtype, wd):
    """With the CPU build's square root, the kernel's sequence gives the
    chain's bits: the same operations, roundings and fusions in the same
    order."""
    assert _emulation_ulps(p_dtype, wd, sqrt=_cpu_sqrt) == dict(p=0.0, m=0.0, v=0.0)


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no_decay", "decay"])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_sequence_with_ieee_sqrt_moves_only_the_quotient(p_dtype, wd):
    """With IEEE square roots (the kernel's __fsqrt_rn; torch's on the card)
    m and v stay bit-equal to the CPU chain, and p within 2.5 ulps of its
    step's largest operand: the CPU build's root, an ulp off at ~0.6 % of
    inputs, moves upd by up to two ulps, and lr·upd with it."""
    worst = _emulation_ulps(p_dtype, wd)
    assert worst["m"] == worst["v"] == 0.0 and worst["p"] <= 2.5


@pytest.mark.parametrize("sqrt", [np.sqrt, _cpu_sqrt], ids=["ieee", "cpu"])
def test_emulation_fault_unfused_m_is_caught(sqrt):
    assert _emulation_ulps(torch.float32, 0.01, sqrt=sqrt, fused_m=False)["m"] > 2.5


# ---------------------------------------------------------------------------
# optim.AdamW against thunder_tpu.optim.AdamW
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_optim():
    import jax.numpy as jnp

    from thunder_tpu import optim as jopt

    return jnp, jopt


SHAPES = {"w": (37, 65), "b": (65,), "s": ()}


def _jax_vs_port(jax_optim, p_dtype, wd, port_update=None):
    jnp, jopt = jax_optim
    rng = np.random.RandomState(1)
    params = {k: np.asarray(0.05 * rng.randn(*s), f32) for k, s in SHAPES.items()}
    grads = [{k: np.asarray(1e-2 * rng.randn(*s), f32) for k, s in SHAPES.items()} for _ in range(3)]
    jdt = jnp.float32 if p_dtype == torch.float32 else jnp.bfloat16
    kw = dict(lr=HYPER["lr"], betas=(HYPER["beta1"], HYPER["beta2"]), eps=HYPER["eps"], weight_decay=wd)
    jo, to = jopt.AdamW(**kw), topt.AdamW(**kw)
    jp = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    tp = {k: torch.tensor(v).to(p_dtype) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    if port_update is not None:
        to.update = port_update.__get__(to)
    for g in grads:
        jp, js = jo.update(jp, {k: jnp.asarray(v, jdt) for k, v in g.items()}, js)
        tp, ts = to.update(tp, {k: torch.tensor(v).to(p_dtype) for k, v in g.items()}, ts)
    out = {}
    for k in SHAPES:
        for name, a, b in (("p", jp[k], tp[k]), ("m", js["m"][k], ts["m"][k]), ("v", js["v"][k], ts["v"][k])):
            a = np.asarray(a, f32)
            b = b.float().numpy()
            out[f"{name}.{k}"] = (a, b)
    return out


def _assert_matches_jax(out, p_dtype):
    for key, (a, b) in out.items():
        if key.startswith("p.") and p_dtype == torch.bfloat16:
            assert (np.abs(b - a) <= 3 * _ulp(a, torch.bfloat16)).all(), key
        else:
            assert np.abs(b - a).max(initial=0.0) <= 1e-6 * np.abs(a).max(initial=0.0), key


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no_decay", "decay"])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_adamw_matches_thunder_tpu_over_three_steps(jax_optim, p_dtype, wd):
    _assert_matches_jax(_jax_vs_port(jax_optim, p_dtype, wd), p_dtype)


def test_adamw_fault_decay_after_the_step_is_caught(jax_optim):
    @torch.no_grad()
    def decay_last(self, params, grads, state):
        state["step"] += 1
        keys = list(params)
        cudaex.adamw_plain([params[k] for k in keys], [grads[k] for k in keys], [state["m"][k] for k in keys],
                           [state["v"][k] for k in keys], lr=self.lr, beta1=self.beta1, beta2=self.beta2,
                           eps=self.eps, weight_decay=0.0, step=state["step"])
        for k in keys:
            params[k].mul_(1 - self.lr * self.weight_decay)
        return params, state

    with pytest.raises(AssertionError):
        _assert_matches_jax(_jax_vs_port(jax_optim, torch.float32, 0.5, decay_last), torch.float32)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
RMS_D = {torch.float32: (64, 136, 1000, 2048, 4096, 16384), torch.bfloat16: (64, 136, 1000, 2048, 4096, 32768),
         torch.float16: (64, 136, 1000, 2048, 4096, 32768)}


def _rms_card_inputs(cuda, N, D, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(N, D, device=cuda, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(D, device=cuda, generator=g)).to(dtype)
    return x, w


@pytest.mark.gpu
@pytest.mark.parametrize("N", [0, 1, 3, 8, 129, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "f16", "f32"])
def test_rms_kernel_matches_plain_at_every_width(cuda, N, dtype):
    for D in RMS_D[dtype]:
        x, w = _rms_card_inputs(cuda, N, D, dtype, seed=N + D)
        n0 = cudaex.rms_norm.launches
        out = cudaex.rms_norm(x, w, 1e-5)
        torch.cuda.synchronize()
        assert cudaex.rms_norm.launches == n0 + (N > 0)
        assert out.shape == (N, D)
        tol = RMS_TOL[dtype]
        torch.testing.assert_close(out.float(), cudaex.rms_norm_plain(x, w, 1e-5).float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("N,D,dtype", [(8, 2048, torch.bfloat16), (1024, 2048, torch.bfloat16),
                                       (512, 2048, torch.float32), (300, 32768, torch.float16)])
def test_rms_every_launch_matches_plain_and_flags_keep_the_bits(cuda, N, D, dtype):
    """Every launch the kernel takes (vectors a lane, warps a row, rows a
    block) against the plain version; with and without programmatic
    dependent launch, and at any rows a block, a row's bits are the same
    (its warps and lanes sum in the same order)."""
    x, w = _rms_card_inputs(cuda, N, D, dtype)
    want = cudaex.rms_norm_plain(x, w, 1e-5).float()
    nvec = D // cudaex._vec(dtype)
    tol = RMS_TOL[dtype]
    for wpr in (1, 2, 4, 8, 16):
        vpl = next((v for v in (1, 2, 4, 8) if v * 32 * wpr >= nvec), None)
        if vpl is None:
            continue
        first = None
        for rows in (1, 2, 4, 8):
            if 32 * wpr * rows > 512:
                continue
            for flags in (0, cudaex.RMS_PDL):
                y = torch.full_like(x, float("nan"))
                cudaex._rms_launch(x, w, y, 1e-5, dict(vpl=vpl, wpr=wpr, rows_per_block=rows, flags=flags))
                torch.cuda.synchronize()
                torch.testing.assert_close(y.float(), want, atol=tol, rtol=tol)
                first = y if first is None else first
                assert torch.equal(y, first), (wpr, rows, flags)


@pytest.mark.gpu
def test_rms_refuses_a_launch_that_leaves_part_of_a_row(cuda):
    x, w = _rms_card_inputs(cuda, 4, 2048, torch.bfloat16)
    y = torch.empty_like(x)
    with pytest.raises(RuntimeError, match="rms_norm"):
        cudaex._rms_launch(x, w, y, 1e-5, dict(vpl=1, wpr=4, rows_per_block=1, flags=0))


@pytest.mark.gpu
@pytest.mark.parametrize("N,D,dtype", [(4, 2048, torch.bfloat16), (512, 2048, torch.bfloat16),
                                       (512, 2048, torch.float32), (40, 16384, torch.float32)])
def test_rms_in_a_cuda_graph_equals_eager(cuda, N, D, dtype):
    x, w = _rms_card_inputs(cuda, N, D, dtype)
    want = cudaex.rms_norm(x, w, 1e-5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cudaex.rms_norm(x, w, 1e-5)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = cudaex.rms_norm(x, w, 1e-5)
    for _ in range(3):
        y.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want)
    x2, _ = _rms_card_inputs(cuda, N, D, dtype, seed=7)
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, cudaex.rms_norm(x2, w, 1e-5))


ADAMW_TOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}


def _adamw_card_case(cuda):
    """Tensors with mixed p and g dtypes, odd numels, misaligned views, an
    empty and a 0-d tensor, and a None gradient: lists (ps, gs, ms, vs)."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(shape, scale, dtype=torch.float32):
        return (scale * torch.randn(shape, device=cuda, generator=g)).to(dtype)

    specs = [((1000, 257), torch.float32, torch.float32), ((65536 * 3 + 5,), torch.bfloat16, torch.bfloat16),
             ((999,), torch.float16, torch.float32), ((4097, 33), torch.float32, torch.bfloat16),
             ((0,), torch.float32, torch.float32), ((), torch.float32, torch.float32),
             ((131,), torch.bfloat16, torch.float16), ((70000,), torch.float32, None)]
    ps, gs, ms, vs = [], [], [], []
    for i, (shape, pdt, gdt) in enumerate(specs):
        n = int(np.prod(shape))
        if i in (0, 2):  # misaligned views: one element into a larger buffer
            p = r((n + 1,), 0.02, pdt)[1:].view(shape)
            m = r((n + 3,), 1e-4)[3:].view(shape)
        else:
            p, m = r(shape, 0.02, pdt), r(shape, 1e-4)
        ps.append(p)
        ms.append(m)
        vs.append(torch.rand(shape, device=cuda, generator=g) * 1e-6)
        gs.append(None if gdt is None else r(shape, 1e-3, gdt))
    return ps, gs, ms, vs


@pytest.mark.gpu
@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no_decay", "decay"])
def test_adamw_kernel_matches_plain_over_two_updates(cuda, wd):
    ker = _adamw_card_case(cuda)
    ref = tuple([None if t is None else t.clone() for t in ts] for ts in ker)
    frozen = [t.clone() for t in (ker[0][-1], ker[2][-1], ker[3][-1])]
    n0 = cudaex.adamw_update.launches
    for step in (1, 2):
        grads = [None if g is None else g * (1 + 0.5 * step) for g in ker[1]]
        cudaex.adamw_update(ker[0], grads, ker[2], ker[3], weight_decay=wd, step=step, **HYPER)
        kept = [i for i, g in enumerate(grads) if g is not None]
        cudaex.adamw_plain(*([ts[i] for i in kept] for ts in (ref[0], grads, ref[2], ref[3])),
                           weight_decay=wd, step=step, **HYPER)
        if step == 1:
            tables = (dict(cudaex._adamw_tensor_tables), dict(cudaex._adamw_chunk_tables))
    torch.cuda.synchronize()
    assert cudaex.adamw_update.launches == n0 + 2
    # the second update found its chunk table cached
    assert set(tables[1]) <= set(cudaex._adamw_chunk_tables)
    for i in range(len(ker[0])):
        if not ker[0][i].numel():
            continue
        for got, want, tol in ((ker[0][i], ref[0][i], ADAMW_TOL[ker[0][i].dtype]),
                               (ker[2][i], ref[2][i], 1e-6), (ker[3][i], ref[3][i], 1e-6)):
            scale = want.float().abs().max().item()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * scale, (i, err, scale)
    # the None gradient's parameter and moments did not move
    assert all(torch.equal(a, b) for a, b in zip(frozen, (ker[0][-1], ker[2][-1], ker[3][-1])))


@pytest.mark.gpu
def test_adamw_wrapper_refuses_bad_inputs(cuda):
    p = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        cudaex.adamw_update([p], [torch.zeros(8, device=cuda)], [torch.zeros(8, device=cuda, dtype=torch.bfloat16)],
                            [torch.zeros(8, device=cuda)], weight_decay=0.0, step=1, **HYPER)
    with pytest.raises(ValueError, match="shapes"):
        cudaex.adamw_update([p], [torch.zeros(9, device=cuda)], [torch.zeros(8, device=cuda)],
                            [torch.zeros(8, device=cuda)], weight_decay=0.0, step=1, **HYPER)
    with pytest.raises(ValueError, match="device"):
        cudaex.adamw_update([p], [torch.zeros(8)], [torch.zeros(8, device=cuda)], [torch.zeros(8, device=cuda)],
                            weight_decay=0.0, step=1, **HYPER)
