"""The port's kernel modules: plain versions against thunder_tpu's Pallas
kernels (interpret mode on the CPU), wrapper and checker behavior, and — on
a CUDA card only (``-m gpu``) — each hand-written kernel against its plain
version. The card-only tests need neither jax nor this directory's
conftest (which imports jax): on the card, run
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.

Tolerances: f32 at 1e-5 (the same f32 math in another summation order). bf16
RMSNorm at 2e-2: both sides compute in f32 and round once to bf16, so they
differ by at most one bf16 ulp (2^-8 relative, ~1.6e-2 at |y| = 4). bf16
paged attention at 2e-2, the bar thunder_tpu's own kernel test uses
(tests/test_inference.py:279). On the card, f32 paged attention at 1e-4:
the kernel's exp2 with log2(e) folded into the scale against the plain
version's exp. Flash-RoPE plain versions against the Pallas kernels at
test_pallas.py's f32 bars, 2e-3 forward and 5e-3 backward; on the card the
kernels against their plain versions at 1e-4 (f32: exp2 against exp, other
summation order) and 2e-2 (bf16: the kernels round the probabilities and
ds to bf16 before their products, as the TPU kernels do), absolute plus
relative. Paged chunk attention at the paged bars: plain against the
Pallas kernel at f32 1e-5 and bf16 2e-2 (both round p to bf16 before p·v,
at other running maxima); on the card the kernel against its plain version
at f32 1e-4 and bf16 2e-2, as paged attention. The weight-only int8 and
NF4 linears (plain versions against pallasex in tests/test_torch_quant.py,
their routes' arithmetic in tests/test_torch_quant_kernel.py) against their
plain versions on the card at f32 1e-4 (the split route: exact products
of bf16 pieces summed in f32, in another order) and bf16 2e-2 (one rounding
of f32 sums taken in another order: an ulp, 2^-8 relative), on every route
of cudaex.weight_only_plan; a rerun and three CUDA-graph replays bit-equal
to the eager call (the K splits' sum order is fixed and their counters
reset; the split route's pieces are scratch of the call).
"""
import math

import numpy as np
import pytest
import torch

import thunder_tpu_torch as tt
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.ops import ltorch

RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rms_inputs(N, D, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(N, D).astype(np.float32), (1.0 + 0.1 * rng.randn(D)).astype(np.float32)


def _paged_fixture(rng, B=3, H=4, Hkv=2, D=16, ps=8, P=12, npm=4):
    """tests/test_inference.py:206-216: ragged page tables, partially
    filled last pages, null-page entries, GQA."""
    k_pages = rng.randn(P, ps, Hkv, D).astype(np.float32)
    v_pages = rng.randn(P, ps, Hkv, D).astype(np.float32)
    seq_lens = np.asarray([5, 17, 24], np.int32)  # partial, partial, full
    pt = np.zeros((B, npm), np.int32)
    pt[0, :1] = [3]
    pt[1, :3] = [1, 4, 7]
    pt[2, :3] = [2, 5, 9]
    q = rng.randn(B, H, D).astype(np.float32)
    return q, k_pages, v_pages, pt, seq_lens


@pytest.fixture
def jax_ref():
    """thunder_tpu's Pallas kernels, imported here so the card-only tests
    below run where jax is not installed."""
    import jax.numpy as jnp

    from thunder_tpu.executors import pallasex

    return jnp, pallasex


def _torch(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


# ---------------------------------------------------------------------------
# RMSNorm: plain version against pallasex.fused_rms_norm and the decomposition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_plain_matches_pallas(jax_ref, dtype):
    jnp, pallasex = jax_ref
    x, w = _rms_inputs(16, 256)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(pallasex.fused_rms_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1e-5),
                     dtype=np.float32)
    out = cudaex.rms_norm(_torch(x, dtype), _torch(w, dtype), 1e-5).float().numpy()
    tol = RMS_TOL[dtype]
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_plain_any_rows_matches_decomposition(dtype):
    """N=13 (not a multiple of 8, which the TPU grid needed) against the
    port's own ltorch decomposition, run unclaimed through torchex."""
    x, w = _rms_inputs(13, 128, seed=1)
    xt, wt = _torch(x, dtype), _torch(w, dtype)
    decomp = tt.jit(lambda a, w: ltorch.rms_norm(a, (128,), w, 1e-6), executors=["torch"])
    ref = decomp(xt, wt).float().numpy()
    out = cudaex.rms_norm(xt, wt, 1e-6).float().numpy()
    tol = RMS_TOL[dtype]
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def test_rms_claim_follows_the_hopper_checker():
    """D a multiple of the 16-byte vector is claimed whole (no TPU % 128
    rule); D=102 in f32 is not, and runs as the decomposition."""
    fn = lambda a, w: ltorch.rms_norm(a, (a.shape[-1],), w, 1e-6)  # noqa: E731
    for D, claimed in ((136, True), (102, False)):
        cfn = tt.jit(fn)
        x, w = _rms_inputs(4, D)
        out = cfn(_torch(x), _torch(w))
        ids = {b.sym.id for b in tt.last_traces(cfn)[-1].bound_symbols}
        assert ("torch.nn.functional.rms_norm" in ids) == claimed
        np.testing.assert_allclose(out.numpy(), cudaex.rms_norm_plain(_torch(x), _torch(w), 1e-6).numpy(),
                                   atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Paged attention: plain version against pallasex.paged_attention_decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_paged_plain_matches_pallas(jax_ref, dtype, tol):
    jnp, pallasex = jax_ref
    q, kp, vp, pt, sl = _paged_fixture(np.random.RandomState(1234))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(pallasex.paged_attention_decode(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(pt), jnp.asarray(sl), interpret=True), dtype=np.float32)
    out = cudaex.paged_attention(_torch(q, dtype), _torch(kp, dtype), _torch(vp, dtype),
                                 _torch(pt), _torch(sl)).float().numpy()
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def test_paged_plain_matches_decomposition_and_empty_rows():
    """Against the ltorch gather decomposition through torchex; a sequence
    with seq_len 0 gives zeros (the kernel's l == 0 guard)."""
    q, kp, vp, pt, sl = _paged_fixture(np.random.RandomState(7))
    args = [_torch(a) for a in (q, kp, vp, pt, sl)]
    decomp = tt.jit(lambda *a: ltorch.paged_attention(*a), executors=["torch"])
    np.testing.assert_allclose(cudaex.paged_attention(*args).numpy(), decomp(*args).numpy(),
                               atol=1e-5, rtol=1e-5)
    args[4] = torch.tensor([0, 17, 24], dtype=torch.int32)
    assert not cudaex.paged_attention(*args)[0].any()


def test_wrappers_run_plain_only_on_cpu():
    """CPU tensors take the plain versions without counting a launch;
    tensors on any other non-CUDA device are refused, never computed."""
    before = (cudaex.rms_norm.launches, cudaex.paged_attention.launches)
    x, w = _rms_inputs(2, 64)
    cudaex.rms_norm(_torch(x), _torch(w), 1e-6)
    q, kp, vp, pt, sl = _paged_fixture(np.random.RandomState(0))
    cudaex.paged_attention(*[_torch(a) for a in (q, kp, vp, pt, sl)])
    assert (cudaex.rms_norm.launches, cudaex.paged_attention.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        cudaex.rms_norm(torch.empty(2, 64, device="meta"), torch.empty(64, device="meta"), 1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        cudaex.paged_attention(*[_torch(a).to("meta") for a in (q, kp, vp, pt, sl)])


# ---------------------------------------------------------------------------
# Paged chunk attention: plain version against pallasex.paged_chunk_decode
# ---------------------------------------------------------------------------


def _chunk_fixture(rng, B=3, H=4, Hkv=2, T=5, D=16, ps=8, P=14, npm=5):
    """Ragged per-query positions, shared pages (page 4 in rows 0 and 1),
    null-page entries past each sequence's pages, and a query past the
    table's coverage (row 2 reaches position npm * ps)."""
    k_pages = rng.randn(P, ps, Hkv, D).astype(np.float32)
    v_pages = rng.randn(P, ps, Hkv, D).astype(np.float32)
    pt = np.zeros((B, npm), np.int32)
    pt[0, :2] = [3, 4]
    pt[1, :4] = [4, 1, 9, 12]
    pt[2, :5] = [2, 5, 7, 13, 6]
    start = np.asarray([8, 20, npm * ps - T + 1], np.int32)
    q_pos = (start[:, None] + np.arange(T, dtype=np.int32)[None, :]).astype(np.int32)
    q_pos[1] = [20, 21, 22, 2, 3]  # not monotone: each query keeps its own bound
    q = rng.randn(B, H, T, D).astype(np.float32)
    return q, k_pages, v_pages, pt, q_pos


@pytest.mark.parametrize("Hkv", [4, 2], ids=["g1", "g2"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_paged_chunk_plain_matches_pallas(jax_ref, Hkv, dtype, tol):
    jnp, pallasex = jax_ref
    q, kp, vp, pt, qp = _chunk_fixture(np.random.RandomState(Hkv), Hkv=Hkv)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(pallasex.paged_chunk_decode(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt), jnp.asarray(pt),
        jnp.asarray(qp), interpret=True), dtype=np.float32)
    out = cudaex.paged_chunk_attention(_torch(q, dtype), _torch(kp, dtype), _torch(vp, dtype),
                                       _torch(pt), _torch(qp)).float().numpy()
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def test_paged_chunk_plain_matches_decomposition_and_empty_rows():
    """Against the ltorch gather decomposition through torchex; a query
    with no live key (q_pos -1) gives zeros (the kernel's l == 0 guard),
    where the decomposition gives NaN."""
    q, kp, vp, pt, qp = _chunk_fixture(np.random.RandomState(11))
    args = [_torch(a) for a in (q, kp, vp, pt, qp)]
    decomp = tt.jit(lambda *a: ltorch.paged_chunk_attention(*a), executors=["torch"])
    np.testing.assert_allclose(cudaex.paged_chunk_attention(*args).numpy(), decomp(*args).numpy(),
                               atol=1e-5, rtol=1e-5)
    args[4] = args[4].clone()
    args[4][0, 1] = -1
    out = cudaex.paged_chunk_attention(*args)
    assert not out[0, :, 1].any() and out[0, :, 0].abs().sum() > 0
    assert torch.isnan(decomp(*args)[0, :, 1]).all()


def test_paged_chunk_claim_follows_the_hopper_checker():
    """Claimed whole for any T and page size with D a multiple of the
    16-byte vector up to 128; D=136, int q_pos other than int32, or H not a
    multiple of Hkv run as the decomposition."""
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.core.proxies import TensorProxy

    def ok(B=2, H=4, Hkv=2, T=3, D=64, ps=16, dt=dtypes.bfloat16, pdt=dtypes.int32):
        p = lambda *s, d=dt: TensorProxy(shape=s, dtype=d, device=tt.devices.cpu)  # noqa: E731
        return cudaex.paged_chunk_attention_supported(
            p(B, H, T, D), p(9, ps, Hkv, D), p(9, ps, Hkv, D), p(B, 4, d=dtypes.int32),
            p(B, T, d=pdt))

    assert ok() and ok(T=256, ps=8) and ok(T=1, D=128) and ok(D=4, dt=dtypes.float32)
    assert not ok(D=136) and not ok(D=36) and not ok(Hkv=3) and not ok(pdt=dtypes.int64)
    cfn = tt.jit(lambda *a: ltorch.paged_chunk_attention(*a))
    q, kp, vp, pt, qp = _chunk_fixture(np.random.RandomState(12))
    for qpos, claimed in ((_torch(qp), True), (_torch(qp).long(), False)):
        out = cfn(_torch(q), _torch(kp), _torch(vp), _torch(pt), qpos)
        ids = {b.sym.id for b in tt.last_traces(cfn)[-1].bound_symbols}
        assert ("thunder.paged_chunk_attention" in ids) == claimed
        np.testing.assert_allclose(
            out.numpy(), cudaex.paged_chunk_attention_plain(
                *[_torch(a) for a in (q, kp, vp, pt, qp)]).numpy(), atol=1e-5, rtol=1e-5)


def test_paged_chunk_wrapper_runs_plain_only_on_cpu():
    n0 = cudaex.paged_chunk_attention.launches
    args = [_torch(a) for a in _chunk_fixture(np.random.RandomState(13))]
    cudaex.paged_chunk_attention(*args)
    assert cudaex.paged_chunk_attention.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        cudaex.paged_chunk_attention(*[a.to("meta") for a in args])


# ---------------------------------------------------------------------------
# Flash attention with RoPE: plain versions against pallasex's kernels
# ---------------------------------------------------------------------------

FLASH_CASES = [(1, 4, 4, 128, 32), (1, 4, 2, 128, 64), (1, 4, 2, 128, 32), (1, 4, 4, 128, 64)]
FLASH_IDS = ["mha-d32", "gqa-d64", "gqa-d32", "mha-d64"]


def _flash_inputs(B, H, Hkv, T, D, seed=0):
    """numpy q, k, v, cos, sin, do; no jax, so the card tests can use it."""
    from thunder_tpu_torch.models.litgpt import build_rope_cache

    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, T, D).astype(np.float32)
    k = rng.randn(B, Hkv, T, D).astype(np.float32)
    v = rng.randn(B, Hkv, T, D).astype(np.float32)
    do = rng.randn(B, H, T, D).astype(np.float32)
    cos, sin = (a.numpy() for a in build_rope_cache(T, D, 10000, torch.float32, "cpu"))
    return q, k, v, cos, sin, do


@pytest.mark.parametrize("B,H,Hkv,T,D", FLASH_CASES, ids=FLASH_IDS)
def test_flash_rope_plain_matches_pallas(jax_ref, B, H, Hkv, T, D):
    jnp, pallasex = jax_ref
    q, k, v, cos, sin, do = _flash_inputs(B, H, Hkv, T, D)
    scale = 1.0 / math.sqrt(D)  # a python float: jax keeps the f32 kernels f32
    jo, jlse = pallasex.flash_rope_attention_forward(
        *(jnp.asarray(a) for a in (q, k, v, cos, sin)), causal=True, scale=scale)
    jdq, jdk, jdv = pallasex.flash_rope_attention_backward(
        *(jnp.asarray(a) for a in (q, k, v)), jo, jlse, jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(do), causal=True, scale=scale)
    tq, tk, tv, tcos, tsin, tdo = (_torch(a) for a in (q, k, v, cos, sin, do))
    o, lse = cudaex.flash_rope_attention(tq, tk, tv, tcos, tsin, True, scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-3, rtol=2e-3)
    grads = cudaex.flash_rope_attention_backward(tq, tk, tv, o, lse, tcos, tsin, tdo, True, scale)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (jdq, jdk, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3, rtol=5e-3, err_msg=name)


def test_flash_rope_checker_is_hoppers():
    """Any T (no TPU % 512 or T >= 1024 rule); D up to 128, even, a
    multiple of the 16-byte vector; H % Hkv == 0; cos/sin (T, D)."""
    from thunder_tpu_torch.core.proxies import TensorProxy
    from thunder_tpu_torch.core import dtypes

    def ok(B=1, H=4, Hkv=2, T=100, D=64, dt=dtypes.bfloat16, cs=None):
        p = lambda *s, d=dt: TensorProxy(shape=s, dtype=d, device=tt.devices.cpu)  # noqa: E731
        cs = cs or (T, D)
        return cudaex.rope_sdpa_supported(p(B, H, T, D), p(B, Hkv, T, D), p(B, Hkv, T, D),
                                          p(*cs, d=dtypes.float32), p(*cs, d=dtypes.float32))

    assert ok() and ok(T=1) and ok(T=2048, D=128) and ok(D=4, dt=dtypes.float32)
    assert not ok(D=136) and not ok(D=36) and not ok(Hkv=3) and not ok(cs=(64, 64))
    assert not ok(D=8, dt=dtypes.int32)


def test_flash_rope_autograd_function_on_cpu():
    """FlashRopeAttention.apply runs the plain versions on CPU tensors; its
    gradients match torch.autograd through the plain forward."""
    q, k, v, cos, sin, do = (_torch(a) for a in _flash_inputs(1, 4, 2, 40, 32, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    cudaex.FlashRopeAttention.apply(*leaves, cos, sin, True, None).backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    cudaex.flash_rope_attention_plain(*ref, cos, sin, True, None)[0].backward(do)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("N,D", [(8, 2048), (512, 2048), (13, 136), (3, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rms_kernel_matches_plain(cuda, N, D, dtype):
    g = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(N, D, device=cuda, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(D, device=cuda, generator=g)).to(dtype)
    n0 = cudaex.rms_norm.launches
    out = cudaex.rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert cudaex.rms_norm.launches == n0 + 1
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(out.float(), cudaex.rms_norm_plain(x, w, 1e-5).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_paged_kernel_matches_plain(cuda, dtype, tol):
    q, kp, vp, pt, sl = _paged_fixture(np.random.RandomState(3))
    args = [_torch(a, dtype).to(cuda) for a in (q, kp, vp, pt, sl)]
    n0 = cudaex.paged_attention.launches
    out = cudaex.paged_attention(*args)
    torch.cuda.synchronize()
    assert cudaex.paged_attention.launches == n0 + 1
    torch.testing.assert_close(out.float(), cudaex.paged_attention_plain(*args).float(),
                               atol=tol, rtol=tol)


def _chunk_card_inputs(cuda, dtype, B, H, Hkv, T, D, ps, npm, q_pos, seed):
    """Pools of 1 + B * npm pages; each row's table a random permutation of
    pool pages covering its largest position, null page 0 past it; rows 0
    and 1 share their first pages (prefix sharing)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    P = 1 + B * npm
    kp = torch.randn(P, ps, Hkv, D, device=cuda, generator=g).to(dtype)
    vp = torch.randn(P, ps, Hkv, D, device=cuda, generator=g).to(dtype)
    q = torch.randn(B, H, T, D, device=cuda, generator=g).to(dtype)
    perm = (torch.randperm(P - 1, device=cuda, generator=g) + 1).to(torch.int32)
    pt = torch.zeros(B, npm, dtype=torch.int32, device=cuda)
    used = 0
    for b in range(B):
        n = min(npm, int(q_pos[b].max()) // ps + 1)
        pt[b, :n] = perm[used:used + n]
        used += n
    if B > 1:
        n = int((pt[1] > 0).sum())
        pt[1, :n // 2] = pt[0, :n // 2]
    return q, kp, vp, pt, q_pos.to(cuda)


CHUNK_CASES = {
    # (B, H, Hkv, T, D, ps, npm, q_pos)
    "chunk-start0": (1, 32, 8, 256, 64, 16, 128, torch.arange(256)[None]),
    "chunk-start1792": (1, 32, 8, 256, 64, 16, 128, 1792 + torch.arange(256)[None]),
    "chunk-d128-ragged-T": (1, 16, 4, 50, 128, 16, 64, 700 + torch.arange(50)[None]),
    "verify": (8, 32, 8, 3, 64, 16, 128,
               torch.tensor([1, 17, 300, 1024, 2046, 16, 777, 1500])[:, None] + torch.arange(3)),
    "verify-d128": (4, 16, 4, 3, 128, 16, 16,
                    torch.tensor([0, 90, 254, 41])[:, None] + torch.arange(3)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CHUNK_CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_paged_chunk_kernel_matches_plain(cuda, case, dtype, tol):
    """The chunk and verify shapes of Llama-3-1B (one verify query of each
    verify case past the table's coverage: 2046 + 2 = 2048 of 2048 and
    254 + 2 = 256 of 256), D=128, and T=50 (g·T = 200 rows: not a multiple
    of the 64-row tile)."""
    B, H, Hkv, T, D, ps, npm, qp = CHUNK_CASES[case]
    args = _chunk_card_inputs(cuda, dtype, B, H, Hkv, T, D, ps, npm, qp.to(torch.int32), seed=T)
    n0 = cudaex.paged_chunk_attention.launches
    out = cudaex.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    assert cudaex.paged_chunk_attention.launches == n0 + 1
    torch.testing.assert_close(out.float(), cudaex.paged_chunk_attention_plain(*args).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
def test_paged_chunk_kernel_empty_rows_give_zeros(cuda):
    q, kp, vp, pt, qp = _chunk_card_inputs(cuda, torch.float32, 2, 4, 2, 5, 64, 16, 8,
                                           torch.tensor([[-1] * 5, [3, 4, -1, 6, 7]],
                                                        dtype=torch.int32), seed=1)
    out = cudaex.paged_chunk_attention(q, kp, vp, pt, qp)
    torch.cuda.synchronize()
    assert not out[0].any() and not out[1, :, 2].any() and out[1, :, 3].abs().sum() > 0


# fp16 at bf16's bar: the kernels round p and ds to fp16, whose 3 more
# mantissa bits keep its error well below bf16's.
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
# The backward's dq, dk and dv are held on three measures, each within
# FLASH_GRAD_TOL: max |err| / max |ref| and ||err||_2 / ||ref||_2, as the
# ring steps are (RING_TOL), and the worst row's ||err||_2 / ||ref||_2, which
# a kernel that drops some keys' share of a few rows cannot pass: a
# gradient is ~4 in the first causal rows and ~0.03 past a few hundred keys,
# so a bar scaled by the tensor alone is as large as a late row. FLASH_TOL's
# |err| <= tol·max(1, |ref|) is an absolute 2e-2 below 1. 2^-6 is 8 bf16
# ulps: the kernels round p and ds to the input dtype before their products,
# the plain versions do not; on the CPU that rounding reads at most 6.9e-3
# (bf16) and 9e-4 (fp16) on any measure at FLASH_BWD_CASES' shapes. A
# reference (or row) whose largest element (or rms) is below
# FLASH_GRAD_FLOOR is held at that scale: where one key carries almost all
# of a row's P, dS = P·(dP - delta) is a difference of f32 sums of size ~8,
# ~1e-6 apart in any two summation orders (a causal row 0, one key, is only
# that); at a floor of 2^-10 an H100 read such f32 rows at up to 2.6e-4, and
# T = 1 at 4.4e-4. Late rows' gradients are ~0.03 to 0.05, above the floor.
# FLASH_TOL's elementwise bar holds as well.
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -6}
FLASH_GRAD_FLOOR = 2.0 ** -6


def _grad_errors(got, want):
    """(max |err| / max |ref|, ||err||_2 / ||ref||_2, the worst row's
    ||err||_2 / ||ref||_2), the reference's max and rms (of the tensor or
    the row) taken as at least FLASH_GRAD_FLOOR."""
    if not want.numel():
        return 0.0, 0.0, 0.0
    d, w = got.float() - want.float(), want.float()
    root = math.sqrt(w.shape[-1])
    rows = d.norm(dim=-1) / w.norm(dim=-1).clamp(min=FLASH_GRAD_FLOOR * root)
    return (d.abs().max().item() / max(w.abs().max().item(), FLASH_GRAD_FLOOR),
            d.norm().item() / max(w.norm().item(), FLASH_GRAD_FLOOR * math.sqrt(w.numel())),
            rows.max().item())


def _assert_grads_close(got, want, dtype):
    """dq, dk, dv within FLASH_GRAD_TOL on all three measures."""
    tol = FLASH_GRAD_TOL[dtype]
    errs = {n: _grad_errors(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    assert all(max(e) <= tol for e in errs.values()), (tol, errs)


def _planted_backward(q, k, v, o, lse, cos, sin, do, fault):
    """The bf16 backward as the card computes it, in plain PyTorch on the
    CPU (causal): roped q/k rounded to bf16, p and ds rounded to bf16 before
    their products; with one fault planted: ``skip_keys`` drops 32 keys'
    share of dq (half a warpgroup's reduce-add) in the last 128 rows;
    ``dq_tile`` drops a 128-key tile's share of dq in those rows;
    ``dv_rows`` drops the last 64 queries' share of dv; ``vjp_sign`` flips
    sin in dk's RoPE VJP; ``rope_sign`` ropes q the wrong way round in the
    prologue."""
    B, H, T, D = q.shape
    g = H // k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qsin = -sin if fault == "rope_sign" else sin
    qr = cudaex._rope_plain(q.float(), cos, qsin).to(q.dtype).float()
    kr = cudaex._rope_plain(k.float(), cos, sin).to(k.dtype).float().repeat_interleave(g, 1)
    dof = do.float()
    delta = (dof * o.float()).sum(-1)
    s = torch.matmul(qr, kr.transpose(-1, -2)) * scale
    s = torch.where(torch.ones(T, T, dtype=torch.bool).tril(), s, float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dof, v.float().repeat_interleave(g, 1).transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    p = p.to(q.dtype).float()
    ds_q = ds.clone()
    if fault == "skip_keys":
        ds_q[..., T - 128:, 96:128] = 0
    if fault == "dq_tile":
        ds_q[..., T - 128:, 128:256] = 0
    if fault == "dv_rows":
        p[..., T - 64:, :] = 0
    dq = torch.matmul(ds_q, kr)
    dk = torch.matmul(ds.transpose(-1, -2), qr).reshape(B, -1, g, T, D).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), dof).reshape(B, -1, g, T, D).sum(2)
    dq = cudaex._rope_vjp_plain(dq, cos, sin)
    dk = cudaex._rope_vjp_plain(dk, cos, -sin if fault == "vjp_sign" else sin)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("fault", [None, "skip_keys", "dq_tile", "dv_rows", "vjp_sign",
                                   "rope_sign"])
def test_grad_bar_passes_the_roundings_and_fails_each_planted_fault(fault):
    """The card tests' and chip_smoke.py's bar for the backward, on the CPU
    plain versions at a GQA shape with RoPE, bf16 (T = 512, D = 64): the
    kernels' own roundings (p and ds to bf16) pass it; each planted fault
    fails it."""
    dt = torch.bfloat16
    q, k, v, cos, sin, do = (_torch(a) for a in _flash_inputs(1, 4, 2, 512, 64, seed=7))
    q, k, v, do = (t.to(dt) for t in (q, k, v, do))
    o, lse = cudaex.flash_rope_attention_plain(q, k, v, cos, sin, True)
    want = cudaex.flash_rope_attention_backward_plain(q, k, v, o, lse, cos, sin, do, True)
    got = _planted_backward(q, k, v, o, lse, cos, sin, do, fault)
    if fault is None:
        _assert_grads_close(got, want, dt)
    else:
        with pytest.raises(AssertionError):
            _assert_grads_close(got, want, dt)
# The forward's o is held on _grad_errors' three measures at FLASH_GRAD_TOL,
# and its lse on max |err| at FLASH_LSE_TOL, beside FLASH_TOL's elementwise
# bar: a late causal row of o is ~0.02, so an absolute 2e-2 passes a kernel
# that drops a 64-key tile there, and lse is ~8, so FLASH_TOL's relative bar
# is ~0.16 while a dropped tile moves lse by ~0.03. The kernels round p to
# the input dtype before p·v and the plain version does not: on the CPU that
# reads at most 4.2e-3 on o's measures at the planted test's shape (the
# worst row), and 9.5e-7 on lse (l sums the unrounded p); the planted faults
# read 0.81 to 3.1 (the row measure, or lse for lse left in log2 units).
# lse is a sum of f32 exp2s against the plain version's logsumexp, the
# kernels roping q and k with its roundings: an H100 80GB HBM3 (700 W) read
# at most 1.9e-6 in bf16, fp16 and f32 at FLASH_BWD_CASES' shapes and
# chip_smoke.py's; 2^-12 is ~128x that.
FLASH_LSE_TOL = 2.0 ** -12


def _fwd_errors(o, lse, ro, rlse):
    """o's three measures (_grad_errors) and lse's max |err|."""
    return (*_grad_errors(o, ro), (lse.float() - rlse.float()).abs().max().item() if lse.numel() else 0.0)


def _assert_fwd_close(o, lse, ro, rlse, dtype):
    """o within FLASH_GRAD_TOL on the three measures, lse within
    FLASH_LSE_TOL; the readings are printed first."""
    errs = _fwd_errors(o, lse, ro, rlse)
    print("fwd errors [max/max, l2/l2, worst row l2/l2, lse max abs]:", errs)
    assert max(errs[:3]) <= FLASH_GRAD_TOL[dtype] and errs[3] <= FLASH_LSE_TOL, (
        FLASH_GRAD_TOL[dtype], FLASH_LSE_TOL, errs)


def _planted_forward(q, k, v, cos, sin, fault):
    """The bf16 forward as the card computes it, in plain PyTorch on the CPU
    (causal): q and k roped in f32 and rounded to bf16, a base-2 online
    softmax over 128-key tiles, p rounded to bf16 before p·v; with one fault
    planted: ``drop_tile`` skips keys 128..191 (a 64-key tile) in the last
    128 rows; ``mask_shift`` lets each row see one key past the diagonal;
    ``rope_sign`` ropes k with −sin; ``skip_corr`` leaves o unrescaled on
    the second tile; ``lse_log2`` leaves lse in log2 units."""
    B, H, T, D = q.shape
    dt, g = q.dtype, H // k.shape[1]
    scale2 = cudaex.LOG2E / math.sqrt(D)
    qr = cudaex._rope_plain(q.float(), cos, sin).to(dt).float()
    kr = cudaex._rope_plain(k.float(), cos, -sin if fault == "rope_sign" else sin).to(dt).float()
    kr, vf = kr.repeat_interleave(g, 1), v.float().repeat_interleave(g, 1)
    rows = torch.arange(T)[:, None]
    m = torch.full((B, H, T), -1e30)
    l, o = torch.zeros(B, H, T), torch.zeros(B, H, T, D)
    for k0 in range(0, T, 128):
        keys = torch.arange(k0, min(k0 + 128, T))[None, :]
        live = keys <= rows + (1 if fault == "mask_shift" else 0)
        if fault == "drop_tile" and k0 == 128:
            live = live & ~((rows >= T - 128) & (keys < 192))
        s = torch.matmul(qr, kr[..., k0:k0 + 128, :].transpose(-1, -2)) * scale2
        s = torch.where(live, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp2(s - m_new[..., None])
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1)
        if not (fault == "skip_corr" and k0 == 128):
            o = o * corr[..., None]
        o = o + torch.matmul(p.to(dt).float(), vf[..., k0:k0 + 128, :])
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    lse = m + torch.log2(l_safe)
    return (o / l_safe[..., None]).to(dt), lse if fault == "lse_log2" else lse * math.log(2)


@pytest.mark.parametrize("fault", [None, "drop_tile", "mask_shift", "rope_sign", "skip_corr",
                                   "lse_log2"])
def test_fwd_bar_passes_the_roundings_and_fails_each_planted_fault(fault):
    """The card tests' and chip_smoke.py's bar for the forward, on the CPU
    plain versions at a GQA shape with RoPE, bf16 (T = 512, D = 64): the
    kernels' own rounding (p to bf16) passes it; each planted fault fails
    it."""
    dt = torch.bfloat16
    q, k, v, cos, sin, _ = (_torch(a) for a in _flash_inputs(1, 4, 2, 512, 64, seed=11))
    q, k, v = (t.to(dt) for t in (q, k, v))
    ro, rlse = cudaex.flash_rope_attention_plain(q, k, v, cos, sin, True)
    o, lse = _planted_forward(q, k, v, cos, sin, fault)
    if fault is None:
        _assert_fwd_close(o, lse, ro, rlse, dt)
    else:
        with pytest.raises(AssertionError):
            _assert_fwd_close(o, lse, ro, rlse, dt)


FLASH_DTYPES = dict(argnames="dtype", argvalues=[torch.float32, torch.bfloat16, torch.float16],
                    ids=["f32", "bf16", "f16"])
# The backward's shapes: D of 16, 24, 32, 64, 96, 128; GQA groups of 1, 2,
# 4, 8; T of 1, 33, 64, 77, 200, 256, 1000 (ragged against the core's 64-
# and 128-row tiles); causal and full; B of 1 to 3.
FLASH_BWD_CASES = [
    (2, 4, 4, 200, 64, True), (1, 8, 2, 256, 128, True), (1, 4, 2, 77, 32, False),
    (1, 2, 1, 64, 16, True), (1, 4, 2, 33, 24, True), (1, 8, 1, 1000, 96, False),
    (2, 8, 2, 77, 128, True), (1, 8, 8, 1, 64, True), (3, 4, 2, 1000, 16, False),
    (1, 8, 2, 200, 96, True)]
FLASH_BWD_IDS = ["mha-ragged", "gqa-d128", "gqa-full-d32", "mqa-d16", "gqa-d24",
                 "g8-full-d96-t1000", "g4-d128-t77-b2", "mha-t1", "g2-full-d16-t1000-b3",
                 "g4-d96-t200"]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,T,D,causal", FLASH_BWD_CASES, ids=FLASH_BWD_IDS)
@pytest.mark.parametrize(**FLASH_DTYPES)
def test_flash_rope_kernels_match_plain(cuda, B, H, Hkv, T, D, causal, dtype):
    """The RoPE flash kernels against their plain versions: o and lse at
    FLASH_TOL, o at FLASH_GRAD_TOL and lse at FLASH_LSE_TOL, the gradients
    at FLASH_TOL and FLASH_GRAD_TOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, cos, sin, do = (_torch(a).to(cuda) for a in _flash_inputs(B, H, Hkv, T, D, seed=T))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    n0 = (cudaex.flash_rope_attention.launches, cudaex.flash_rope_attention_backward.launches)
    o, lse = cudaex.flash_rope_attention(q, k, v, cos, sin, causal)
    grads = cudaex.flash_rope_attention_backward(q, k, v, o, lse, cos, sin, do, causal)
    torch.cuda.synchronize()
    assert (cudaex.flash_rope_attention.launches, cudaex.flash_rope_attention_backward.launches) == (
        n0[0] + 1, n0[1] + 1)
    tol = FLASH_TOL[dtype]
    ro, rlse = cudaex.flash_rope_attention_plain(q, k, v, cos, sin, causal)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=tol, rtol=tol)
    _assert_fwd_close(o, lse, ro, rlse, dtype)
    ref = cudaex.flash_rope_attention_backward_plain(q, k, v, o, lse, cos, sin, do, causal)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, msg=name)
    _assert_grads_close(grads, ref, dtype)


@pytest.mark.gpu
def test_flash_rope_autograd_matches_autograd_through_plain(cuda):
    """FlashRopeAttention (both kernels) against torch.autograd through the
    plain forward, in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, cos, sin, do = (_torch(a).to(cuda) for a in _flash_inputs(2, 4, 2, 150, 64, seed=5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = cudaex.FlashRopeAttention.apply(*leaves, cos, sin, True, None)
    out.backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    rout = cudaex.flash_rope_attention_plain(*ref, cos, sin, True, None)[0]
    rout.backward(do)
    torch.testing.assert_close(out, rout, atol=1e-4, rtol=1e-4)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,T,D,causal", FLASH_BWD_CASES + [(2, 12, 12, 128, 64, True)],
                         ids=FLASH_BWD_IDS + ["nanogpt-heads"])
@pytest.mark.parametrize(**FLASH_DTYPES)
def test_flash_kernels_match_plain(cuda, B, H, Hkv, T, D, causal, dtype):
    """The RoPE-free flash kernels (sdpa's claim) against their plain
    versions: o and lse at FLASH_TOL, o at FLASH_GRAD_TOL and lse at
    FLASH_LSE_TOL, the gradients at FLASH_TOL and FLASH_GRAD_TOL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _, _, do = (_torch(a).to(cuda) for a in _flash_inputs(B, H, Hkv, T, D, seed=T))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    n0 = (cudaex.flash_attention.launches, cudaex.flash_attention_backward.launches)
    o, lse = cudaex.flash_attention(q, k, v, causal)
    grads = cudaex.flash_attention_backward(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert (cudaex.flash_attention.launches, cudaex.flash_attention_backward.launches) == (
        n0[0] + 1, n0[1] + 1)
    tol = FLASH_TOL[dtype]
    ro, rlse = cudaex.flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=tol, rtol=tol)
    _assert_fwd_close(o, lse, ro, rlse, dtype)
    ref = cudaex.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, msg=name)
    _assert_grads_close(grads, ref, dtype)


# ViT-B/16's attention (models/vit.py): full, 12 heads of 64, T = patches +
# 1, ragged against the cores' 64- and 128-row tiles.
VIT_RAGGED_T = (50, 197, 257)


@pytest.mark.gpu
@pytest.mark.parametrize("T", VIT_RAGGED_T)
@pytest.mark.parametrize(**FLASH_DTYPES)
def test_flash_kernels_match_plain_at_vits_ragged_full_attention(cuda, T, dtype):
    """The RoPE-free flash pair at ViT's heads, full (non-causal) attention
    over a T that is no multiple of a tile, against the plain versions at
    the bars of test_flash_kernels_match_plain."""
    test_flash_kernels_match_plain(cuda, 2, 12, 12, T, 64, False, dtype)


@pytest.mark.gpu
def test_flash_autograd_matches_autograd_through_plain(cuda):
    """FlashAttention (both RoPE-free kernels) against torch.autograd through
    the plain forward, in f32, GQA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _, _, do = (_torch(a).to(cuda) for a in _flash_inputs(2, 4, 2, 150, 64, seed=6))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = cudaex.FlashAttention.apply(*leaves, True, None)
    out.backward(do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    rout = cudaex.flash_attention_plain(*ref, True, None)[0]
    rout.backward(do)
    torch.testing.assert_close(out, rout, atol=1e-4, rtol=1e-4)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize(**FLASH_DTYPES)
def test_flash_forward_never_takes_the_plain_route_on_the_card(cuda, monkeypatch, dtype):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")

    q, k, v, cos, sin, _ = (_torch(a).to(cuda) for a in _flash_inputs(1, 4, 2, 130, 64, seed=9))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    want = (cudaex.flash_rope_attention_plain(q, k, v, cos, sin, True), cudaex.flash_attention_plain(q, k, v, False))
    monkeypatch.setattr(cudaex, "flash_rope_attention_plain", refuse)
    monkeypatch.setattr(cudaex, "flash_attention_plain", refuse)
    n0 = (cudaex.flash_rope_attention.launches, cudaex.flash_attention.launches)
    got = (cudaex.flash_rope_attention(q, k, v, cos, sin, True), cudaex.flash_attention(q, k, v, False))
    torch.cuda.synchronize()
    assert (cudaex.flash_rope_attention.launches, cudaex.flash_attention.launches) == (n0[0] + 1, n0[1] + 1)
    for (o, lse), (ro, rlse) in zip(got, want):
        _assert_fwd_close(o, lse, ro, rlse, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "plain"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_forward_in_a_cuda_graph_equals_eager(cuda, rope, dtype):
    """The forward (with RoPE: its prologue, scratch and core) captured in a
    CUDA graph and replayed gives the eager call's bits (it adds nothing
    atomically), on inputs rewritten between the replays."""
    q, k, v, cos, sin, _ = (_torch(a).to(cuda) for a in _flash_inputs(2, 8, 2, 300, 128, seed=12))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    run = ((lambda: cudaex.flash_rope_attention(q, k, v, cos, sin, True)) if rope  # noqa: E731
           else (lambda: cudaex.flash_attention(q, k, v, True)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = run()
    for seed in (13, 14):
        g = torch.Generator(device=cuda).manual_seed(seed)
        for t in (q, k, v):
            t.copy_(torch.randn(t.shape, device=cuda, generator=g))
        graph.replay()
        torch.cuda.synchronize()
        eo, elo = run()
        torch.cuda.synchronize()
        assert torch.equal(o, eo) and torch.equal(lse, elo)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_flash_forward_kernels_refuse_scratch_they_would_read_past(cuda, monkeypatch, dtype):
    """flash_forward_plan states the roped q/k scratch once; the kernels
    refuse fewer rows than B·(H + Hkv)·T rather than write and read past
    them."""
    q, k, v, cos, sin, _ = (_torch(a).to(cuda) for a in _flash_inputs(1, 4, 2, 64, 64, seed=2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    plan = cudaex.flash_forward_plan

    def short_plan(*a, **kw):
        out = plan(*a, **kw)
        (shape, dt), = out["scratch"].values()
        return {**out, "scratch": {"qk_roped": ((shape[0] - 1, *shape[1:]), dt)}}

    monkeypatch.setattr(cudaex, "flash_forward_plan", short_plan)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        cudaex.flash_rope_attention(q, k, v, cos, sin, True)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (2^(floor(log2 |x|) - 7)), 0 where x is 0."""
    m = x.abs()
    return torch.where(m > 0, torch.exp2(torch.floor(torch.log2(m.clamp(min=1e-38))) - 7),
                       torch.zeros_like(m))


def _flash_backward_twice(cuda, dtype, rope, B, H, Hkv, T, D):
    q, k, v, cos, sin, do = (_torch(a).to(cuda) for a in _flash_inputs(B, H, Hkv, T, D, seed=T))
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    if rope:
        o, lse = cudaex.flash_rope_attention(q, k, v, cos, sin, True)
        run = lambda: cudaex.flash_rope_attention_backward(q, k, v, o, lse, cos, sin, do, True)  # noqa: E731
    else:
        o, lse = cudaex.flash_attention(q, k, v, True)
        run = lambda: cudaex.flash_attention_backward(q, k, v, o, lse, do, True)  # noqa: E731
    first = run()
    second = run()
    torch.cuda.synchronize()
    return first, second


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "plain"])
@pytest.mark.parametrize("B,H,Hkv,T,D", [(1, 16, 4, 1000, 128), (2, 8, 8, 1000, 64)],
                         ids=["gqa-d128", "mha-d64"])
def test_flash_backward_bf16_runs_differ_by_at_most_an_ulp(cuda, rope, B, H, Hkv, T, D):
    """dq (and dk, dv with GQA) are sums of f32 reduce-adds whose order
    changes from run to run, so two runs on the same inputs may round an
    element to neighbouring bf16 values: at most one ulp of its magnitude,
    the magnitude taken as at least 2^-16 of the tensor's largest. Below
    that the f32 sums' own reorder error (2^-24 of their terms) is the
    spread. Measured on an H100 80GB HBM3 (700 W), five pairs of runs at
    these shapes and at T=2048: up to 4.6e-5 of the elements differ, by one
    ulp where |x| > 1e-6; elements near 1e-7, where their f32 sums cancel,
    by up to 16 ulps of their own magnitude, which is at most 2.5e-9 of
    the tensor's largest element."""
    first, second = _flash_backward_twice(cuda, torch.bfloat16, rope, B, H, Hkv, T, D)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        a, b = a.float(), b.float()
        m = torch.maximum(a.abs(), b.abs())
        bound = _bf16_ulp(m.clamp(min=2.0 ** -16 * m.max().item()))
        assert ((a - b).abs() <= bound).all(), name


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "plain"])
def test_flash_backward_f32_is_bit_reproducible(cuda, rope):
    """The f32 route (the two-pass kernels) adds nothing atomically."""
    first, second = _flash_backward_twice(cuda, torch.float32, rope, 2, 8, 2, 300, 64)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


XENT_TOL = 1e-5  # f32 sums of exp2 against logsumexp, in another order


@pytest.mark.gpu
@pytest.mark.parametrize("N,V", [(64, 50304), (37, 32000), (16, 200), (5, 77)],
                         ids=["gpt2-vocab", "llama-vocab", "v200", "v77-unvectorized"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_cross_entropy_kernel_matches_plain(cuda, N, V, dtype):
    """Rows 1 and 3 at ignore_index (-100) and row 2 past V: their picked
    logit is 0; V = 77 is not a whole number of 16-byte vectors."""
    g = torch.Generator(device=cuda).manual_seed(V)
    logits = (3 * torch.randn(N, V, device=cuda, generator=g)).to(dtype)
    tgt = torch.randint(0, V, (N,), device=cuda, generator=g)
    tgt[1], tgt[3], tgt[2] = -100, -100, V + 3
    n0 = cudaex.cross_entropy.launches
    loss, lse = cudaex.cross_entropy(logits, tgt.to(torch.int32))
    torch.cuda.synchronize()
    assert cudaex.cross_entropy.launches == n0 + 1
    rloss, rlse = cudaex.cross_entropy_plain(logits, tgt)
    torch.testing.assert_close(lse, rlse, atol=XENT_TOL, rtol=XENT_TOL)
    torch.testing.assert_close(loss, rloss, atol=XENT_TOL, rtol=XENT_TOL)
    assert torch.equal(loss[[1, 2, 3]], lse[[1, 2, 3]])
    tgt = tgt.where(tgt != V + 3, -100)  # the mean below counts ignore_index rows only
    lib = torch.nn.functional.cross_entropy(logits.float(), tgt)
    torch.testing.assert_close(cudaex._cross_entropy_impl(logits, tgt), lib, atol=XENT_TOL, rtol=XENT_TOL)


@pytest.mark.gpu
def test_nanogpt_on_the_card_launches_its_kernels(cuda):
    """NanoGPT's test config on the card: a forward loss launches the flash
    forward (one a layer) and the cross-entropy kernel; a TrainStep step the
    flash forward and backward (the loss trains through the composite)."""
    from thunder_tpu_torch import optim
    from thunder_tpu_torch.models import nanogpt
    from thunder_tpu_torch.training import TrainStep

    cfg = nanogpt.configs["test"]
    model = nanogpt.NanoGPT(cfg, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    idx, tgt = (torch.randint(0, cfg.vocab_size, (2, 64), device=cuda, generator=g) for _ in range(2))
    n0 = (cudaex.flash_attention.launches, cudaex.cross_entropy.launches)
    with torch.no_grad():
        loss = tt.jit(model)(idx, tgt)
    ref = torch.nn.functional.cross_entropy(tt.jit(model)(idx).reshape(-1, cfg.vocab_size), tgt.reshape(-1))
    torch.testing.assert_close(loss, ref, atol=1e-5, rtol=1e-5)
    assert (cudaex.flash_attention.launches, cudaex.cross_entropy.launches) == (n0[0] + 4, n0[1] + 1)
    step = TrainStep(tt.jit(model), optim.AdamW(lr=1e-3))
    n0 = (cudaex.flash_attention.launches, cudaex.flash_attention_backward.launches)
    assert math.isfinite(float(step(idx, tgt)))
    assert (cudaex.flash_attention.launches, cudaex.flash_attention_backward.launches) == (
        n0[0] + 2, n0[1] + 2)


@pytest.mark.gpu
def test_flash_and_xent_wrappers_refuse_bad_inputs(cuda):
    q = torch.randn(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cudaex.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 2, 16, 136, device=cuda)
        cudaex.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="does not fit"):
        cudaex.flash_attention(q, q[:, :, :8].contiguous(), q[:, :, :8].contiguous())
    qb = q.bfloat16()
    o, lse = cudaex.flash_attention(qb, qb, qb)
    with pytest.raises(ValueError, match="o must be q's dtype"):  # the prologue reads o as q's dtype
        cudaex.flash_attention_backward(qb, qb, qb, o.float(), lse, qb)
    with pytest.raises(ValueError, match="float"):
        cudaex.cross_entropy(torch.zeros(4, 8, dtype=torch.int32, device=cuda),
                             torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="targets"):
        cudaex.cross_entropy(torch.zeros(4, 8, device=cuda), torch.zeros(3, dtype=torch.int64, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,T,D,short", [(torch.bfloat16, 256, 64, 128), (torch.bfloat16, 200, 64, 56),
                                             (torch.float32, 77, 64, 1)],
                         ids=["bf16-short-of-T", "bf16-not-whole-tiles", "f32-not-T"])
def test_flash_backward_kernels_refuse_a_pitch_they_would_read_past(cuda, monkeypatch, dtype, T, D, short):
    """flash_backward_plan states the scratch's row pitch once; the kernels
    refuse one shorter than T, not a whole number of the core's query tiles
    (bf16/fp16), or other than T (f32), rather than read past it."""
    q = torch.randn(1, 2, T, D, device=cuda).to(dtype)
    o, lse = cudaex.flash_attention(q, q, q)
    plan = cudaex.flash_backward_plan

    def short_plan(*a, **kw):
        out = plan(*a, **kw)
        return {**out, "pitch": out["pitch"] - short}

    monkeypatch.setattr(cudaex, "flash_backward_plan", short_plan)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        cudaex.flash_attention_backward(q, q, q, o, lse, q)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_bad_inputs(cuda):
    x = torch.randn(4, 256, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cudaex.rms_norm(x.t().contiguous().t(), torch.ones(4, device=cuda), 1e-6)
    with pytest.raises(ValueError, match="dtype"):
        cudaex.rms_norm(x, torch.ones(256, device=cuda, dtype=torch.bfloat16), 1e-6)
    q, kp, vp, pt, qp = _chunk_card_inputs(cuda, torch.bfloat16, 2, 4, 2, 3, 64, 16, 4,
                                           torch.tensor([[0, 1, 2], [5, 6, 7]],
                                                        dtype=torch.int32), seed=2)
    with pytest.raises(ValueError, match="int32"):
        cudaex.paged_chunk_attention(q, kp, vp, pt, qp.long())
    with pytest.raises(ValueError, match="dtype"):
        cudaex.paged_chunk_attention(q, kp.float(), vp, pt, qp)
    with pytest.raises(ValueError, match="head dim"):
        cudaex.paged_chunk_attention(*(torch.zeros(*t.shape[:-1], 136, dtype=t.dtype, device=cuda)
                                       for t in (q, kp, vp)), pt, qp)
    with pytest.raises(ValueError, match="contiguous"):
        cudaex.paged_chunk_attention(q.transpose(2, 3).contiguous().transpose(2, 3), kp, vp, pt, qp)


# ---------------------------------------------------------------------------
# Weight-only quantized linears on the card: int8 and NF4
# ---------------------------------------------------------------------------

QUANT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _int8_card_inputs(cuda, dtype, M, N, K, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(M, K, device=cuda, generator=g).to(dtype)
    q = torch.randint(-127, 128, (N, K), device=cuda, generator=g, dtype=torch.int8)
    s = torch.rand(N, device=cuda, generator=g) * 5e-4 + 1e-4
    return x, q, s


def _nf4_card_inputs(cuda, dtype, M, N, K, seed):
    from thunder_tpu_torch.transforms.quantization import pack_nf4_kernel_layout, quantize_nf4

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(M, K, device=cuda, generator=g).to(dtype)
    w = torch.randn(N, K, device=cuda, generator=g) * 0.02
    return (x, *pack_nf4_kernel_layout(*quantize_nf4(w), (N, K)))


QUANT_M = [1, 4, 8, 16, 17, 40, 256, 512]


def _expected_route(M, K, dtype, kind="int8"):
    """f32 x: split (NF4 at M <= 16: fma); bf16 decode (M <= 16, K in whole
    128-k chunks): stream; other bf16: wgmma."""
    if dtype == torch.float32:
        return "fma" if kind == "nf4" and M <= 16 else "split"
    return "stream" if M <= 16 and K % 128 == 0 else "wgmma"


@pytest.mark.gpu
@pytest.mark.parametrize("M", QUANT_M)
@pytest.mark.parametrize("N,K", [(2048, 2048), (200, 2064), (96, 8192), (2048, 8192)],
                         ids=["2048x2048", "N200-ragged-K2064", "96x8192", "2048x8192-split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_linear_kernel_matches_plain(cuda, M, N, K, dtype):
    """Decode (M <= 16: the stream route, 16-row blocks over all of K, or
    K split at K = 8192) and prefill buckets (17 ... 512: the wgmma route,
    64- and 128-token tiles, K split where the tiles leave SMs idle); N not
    a multiple of any tile, and K = 2064 ends in a partial 64-byte unit
    (the wgmma route at every M: the decode route's boxes take whole 128-k
    chunks)."""
    x, q, s = _int8_card_inputs(cuda, dtype, M, N, K, seed=M + K)
    plan = cudaex.weight_only_plan("int8", M, N, K, dtype)
    assert plan["route"] == _expected_route(M, K, dtype)
    n0 = cudaex.int8_linear.launches
    out = cudaex.int8_linear(x, q, s)
    torch.cuda.synchronize()
    assert cudaex.int8_linear.launches == n0 + 1 and out.dtype == dtype
    tol = QUANT_TOL[dtype]
    torch.testing.assert_close(out.float(), cudaex.int8_linear_plain(x, q, s).float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("M", QUANT_M)
@pytest.mark.parametrize("N,K", [(2048, 2048), (200, 768), (128, 8192), (2048, 8192)],
                         ids=["2048x2048", "N200-slice256", "128x8192", "2048x8192-split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_nf4_linear_kernel_matches_plain(cuda, M, N, K, dtype):
    """Slice widths 512 (K 2048, 8192) and 256 (K 768); N not a multiple of
    the block; both bf16 routes, with and without K splits. NF4's K is a
    multiple of 256, so it has no ragged tail."""
    x, pk, ak = _nf4_card_inputs(cuda, dtype, M, N, K, seed=M + K)
    plan = cudaex.weight_only_plan("nf4", M, N, K, dtype)
    assert plan["route"] == _expected_route(M, K, dtype, "nf4")
    n0 = cudaex.nf4_linear.launches
    out = cudaex.nf4_linear(x, pk, ak)
    torch.cuda.synchronize()
    assert cudaex.nf4_linear.launches == n0 + 1 and out.dtype == dtype
    tol = QUANT_TOL[dtype]
    torch.testing.assert_close(out.float(), cudaex.nf4_linear_plain(x, pk, ak).float(), atol=tol, rtol=tol)


def _quant_call(cuda, kind, M, N, K, seed, dtype=torch.bfloat16):
    if kind == "int8":
        return cudaex.int8_linear, _int8_card_inputs(cuda, dtype, M, N, K, seed)
    return cudaex.nf4_linear, _nf4_card_inputs(cuda, dtype, M, N, K, seed)


# (M, N, K): stream with K splits, stream without, wgmma with, wgmma without
QUANT_SPLIT_CASES = [(8, 2048, 8192), (4, 8192, 2048), (256, 2048, 8192), (512, 8192, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "nf4"])
@pytest.mark.parametrize("M,N,K", QUANT_SPLIT_CASES)
def test_weight_only_rerun_is_bit_equal(cuda, kind, M, N, K):
    """The K splits are summed in split order by whichever block finishes
    last: a rerun gives the same bits."""
    fn, args = _quant_call(cuda, kind, M, N, K, seed=7)
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "nf4"])
@pytest.mark.parametrize("M,N,K", QUANT_SPLIT_CASES)
def test_weight_only_cuda_graph_replays_match_eager(cuda, kind, M, N, K):
    """Three replays of a captured call equal the eager call: the split
    counters are back at zero after every launch."""
    fn, args = _quant_call(cuda, kind, M, N, K, seed=9)
    eager = fn(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


# (M, N, K) of the split route (f32 x): K split at a decode M and at a
# prefill M, and not (quant_train's fc_1 / mlp_proj at 512 rows)
QUANT_F32_CASES = [(8, 2048, 8192), (40, 2048, 2048), (512, 8192, 2048), (512, 2048, 8192)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "nf4"])
@pytest.mark.parametrize("M,N,K", QUANT_F32_CASES)
def test_weight_only_f32_routes_captured_and_rerun_bit_equal(cuda, kind, M, N, K):
    """f32 x on the split route (NF4 at M = 8: fma): a rerun and three
    replays of a captured call (x's pieces and the partial sums allocated
    inside the capture) equal the eager call bit for bit."""
    fn, args = _quant_call(cuda, kind, M, N, K, seed=13, dtype=torch.float32)
    assert cudaex.weight_only_plan(kind, M, N, K, torch.float32)["route"] == _expected_route(M, K, torch.float32,
                                                                                           kind)
    eager = fn(*args)
    assert torch.equal(fn(*args).view(torch.int32), eager.view(torch.int32))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int32), eager.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_quant_declined_shape_runs_the_decomposition(cuda, kind):
    """More than 512 rows on the card: the checker declines, the trace
    holds the torchex decomposition (bf16 weights, one torch.matmul) and no
    kernel launches; the plain version is never taken on a CUDA tensor."""
    from thunder_tpu_torch.executors import torchex
    from thunder_tpu_torch.transforms import quantization as tq

    torch.backends.cuda.matmul.allow_tf32 = False
    if kind == "int8":
        x, q, s = _int8_card_inputs(cuda, torch.bfloat16, 600, 256, 512, seed=1)
        cfn = tt.jit(lambda x, q, s: tq.quantized_linear(x, q, s))
        args, decomp, counter = (x, q, s), torchex._quantized_linear_impl, cudaex.int8_linear
    else:
        x, pk, ak = _nf4_card_inputs(cuda, torch.bfloat16, 600, 256, 512, seed=2)
        cfn = tt.jit(lambda x, p, a: tq.nf4_linear_kl(x, p, a, 256, 512, 64))
        args, counter = (x, pk, ak), cudaex.nf4_linear
        decomp = lambda x, p, a: torchex._nf4_linear_kl_impl(x, p, a, 256, 512, 64)  # noqa: E731
    n0 = counter.launches
    out = cfn(*args)
    torch.cuda.synchronize()
    assert counter.launches == n0
    impls = {b.impl for b in tt.last_traces(cfn)[-1].bound_symbols if str(b.sym.id).startswith("quant.")}
    assert impls and not impls & {cudaex._int8_linear_impl, cudaex._nf4_kl_impl}
    torch.testing.assert_close(out, decomp(*args), atol=0, rtol=0)
    small = cfn(*(a[:8] if a is args[0] else a for a in args))
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1 and small.shape[0] == 8


@pytest.mark.gpu
def test_quant_wrappers_refuse_bad_inputs(cuda):
    x, q, s = _int8_card_inputs(cuda, torch.bfloat16, 8, 64, 256, seed=3)
    with pytest.raises(ValueError, match="multiple of 16"):
        cudaex.int8_linear(x[:, :40].contiguous(), q[:, :40].contiguous(), s)
    with pytest.raises(ValueError, match="int8"):
        cudaex.int8_linear(x, q.view(torch.uint8), s)
    with pytest.raises(ValueError, match="f32 or bf16"):
        cudaex.int8_linear(x.half(), q, s)
    xn, pk, ak = _nf4_card_inputs(cuda, torch.bfloat16, 4, 128, 512, seed=4)
    with pytest.raises(ValueError, match="no kernel layout"):
        cudaex.nf4_linear(xn[:, :448].contiguous(), pk, ak)
    with pytest.raises(ValueError, match="absmax f32"):
        cudaex.nf4_linear(xn, pk, ak.to(torch.bfloat16))


# fp8_linear (plain version against pallasex in tests/test_torch_fp8.py): the
# codes and amaxes equal the plain version's; y to |err| / max(1, |plain|) at
# f32 1e-5 (the same exact e4m3 products summed in f32 in another order) and
# bf16 2e-2 (one rounding to bf16 of those sums: an ulp).
FP8_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _fp8_card_inputs(cuda, x_dtype, w_dtype, M, N, K, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(M, K, device=cuda, generator=g).to(x_dtype)
    w = (torch.randn(N, K, device=cuda, generator=g) * 0.02).to(w_dtype)
    sx = torch.full((), 448.0, device=cuda) / x.float().abs().amax() / 2
    sw = torch.full((), 448.0, device=cuda) / w.float().abs().amax()
    return x, w, sx, sw


def _fp8_check(out, ref, x_dtype):
    assert torch.equal(out[1].view(torch.uint8), ref[1].view(torch.uint8))
    assert torch.equal(out[2].view(torch.uint8), ref[2].view(torch.uint8))
    assert out[3].item() == ref[3].item() and out[4].item() == ref[4].item()
    d = (out[0].float() - ref[0].float()).abs() / ref[0].float().abs().clamp(min=1.0)
    assert out[0].dtype == x_dtype and d.max().item() <= FP8_TOL[x_dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(100, 40, 64), (256, 128, 1024), (300, 264, 4096), (1, 8, 32)],
                         ids=["ragged", "tiles", "deep_ragged", "one_row"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16], ids=["w_f32", "w_bf16"])
def test_fp8_linear_kernel_matches_plain(cuda, M, N, K, x_dtype, w_dtype):
    x, w, sx, sw = _fp8_card_inputs(cuda, x_dtype, w_dtype, M, N, K, seed=M + K)
    n0 = cudaex.fp8_linear.launches
    out = cudaex.fp8_linear(x, w, sx, sw, save_quantized=True)
    torch.cuda.synchronize()
    assert cudaex.fp8_linear.launches == n0 + 1
    _fp8_check(out, cudaex.fp8_linear_plain(x, w, sx, sw, save_quantized=True), x_dtype)
    y, ax, aw = cudaex.fp8_linear(x, w, sx, sw)
    assert torch.equal(y, out[0]) and ax.item() == out[3].item() and aw.item() == out[4].item()


@pytest.mark.gpu
def test_fp8_linear_in_a_cuda_graph(cuda):
    """The wrapper zeroes the amaxes on the stream, so a replayed graph
    reduces them afresh."""
    x, w, sx, sw = _fp8_card_inputs(cuda, torch.bfloat16, torch.float32, 256, 256, 512, seed=9)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cudaex.fp8_linear(x, w, sx, sw, save_quantized=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cudaex.fp8_linear(x, w, sx, sw, save_quantized=True)
    for scale in (1.0, 0.5):
        x.mul_(scale)
        graph.replay()
        torch.cuda.synchronize()
        _fp8_check(out, cudaex.fp8_linear_plain(x, w, sx, sw, save_quantized=True), torch.bfloat16)


@pytest.mark.gpu
def test_fp8_declined_shape_runs_the_unfused_route(cuda):
    """N = 36 is not whole 8-column slices: the stateful operator's forward
    runs the unfused torch route, launches nothing, and agrees with it."""
    from thunder_tpu_torch.transforms import fp8_training as tfp8

    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, _, _ = _fp8_card_inputs(cuda, torch.float32, torch.float32, 64, 36, 64, seed=4)
    hx = torch.full((16,), 3.0, device=cuda)
    hw = torch.full((16,), 0.05, device=cuda)
    assert not cudaex.fp8_linear_supported(x, w)
    n0 = cudaex.fp8_linear.launches
    y, xq, wq, sx, sw, ax, aw = tfp8._forward(x, w, None, hx, hw, 0, True)
    torch.cuda.synchronize()
    assert cudaex.fp8_linear.launches == n0
    want = cudaex.fp8_linear_plain(x, w, sx, sw, save_quantized=True)
    assert torch.equal(xq.view(torch.uint8), want[1].view(torch.uint8)) and ax.item() == want[3].item()
    torch.testing.assert_close(y, want[0], atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_fp8_backward_products_on_the_card(cuda):
    """The backward's products go to torch._scaled_mm where every dimension
    is a multiple of 16, else to the f32 product of the widened codes.
    cuBLAS's fp8 GEMM keeps fewer bits in its sums than f32: within 1e-3 of
    the largest |sum|."""
    from thunder_tpu_torch.transforms import fp8_training as tfp8

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(256, 512, device=cuda, generator=g).to(torch.float8_e5m2)
    b = torch.randn(512, 128, device=cuda, generator=g).to(torch.float8_e4m3fn)
    routes = dict(tfp8.BACKWARD_ROUTES)
    got = tfp8._fp8_mm(a, b)
    want = torch.matmul(a.float(), b.float())
    assert tfp8.BACKWARD_ROUTES["scaled_mm"] == routes["scaled_mm"] + 1
    assert got.dtype == torch.float32 and (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    odd = tfp8._fp8_mm(a[:, :40], b[:40])
    assert tfp8.BACKWARD_ROUTES["f32"] == routes["f32"] + 1
    torch.testing.assert_close(odd, torch.matmul(a[:, :40].float(), b[:40].float()), atol=0, rtol=0)


@pytest.mark.gpu
def test_fp8_wrapper_refuses_bad_inputs(cuda):
    x, w, sx, sw = _fp8_card_inputs(cuda, torch.bfloat16, torch.float32, 16, 64, 96, seed=6)
    with pytest.raises(ValueError, match="multiple of 32"):
        cudaex.fp8_linear(x[:, :80].contiguous(), w[:, :80].contiguous(), sx, sw)
    with pytest.raises(ValueError, match="f32 or bf16"):
        cudaex.fp8_linear(x.half(), w, sx, sw)
    with pytest.raises(ValueError, match="f32 scalars"):
        cudaex.fp8_linear(x, w, sx.double(), sw)
    with pytest.raises(ValueError, match="CUDA device"):
        cudaex.fp8_linear(x, w.cpu(), sx, sw)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(300, 264, 2816), (130, 40, 32), (256, 32000, 1024), (129, 136, 160)],
                         ids=["k2816", "k32", "lm_head_width", "k160"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["x_f32", "x_bf16"])
def test_fp8_linear_kernel_edges_match_plain(cuda, M, N, K, x_dtype):
    """The product's edges: M past the 128-row tiles, N a multiple of 8 but
    not of the 128-column tile, K = 32 (one promotion group, the rest of the
    stage zero-filled by TMA), K = 2816 and 160 (a k tail past whole 128-byte
    tiles), and lm_head's width N = 32000. The stages' plain versions give
    the same codes and amaxes."""
    x, w, sx, sw = _fp8_card_inputs(cuda, x_dtype, torch.float32, M, N, K, seed=M + N + K)
    out = cudaex.fp8_linear(x, w, sx, sw, save_quantized=True)
    torch.cuda.synchronize()
    _fp8_check(out, cudaex.fp8_linear_plain(x, w, sx, sw, save_quantized=True), x_dtype)
    xq, wq, ax, aw = cudaex.fp8_quantize_plain(x, w, sx, sw)
    assert torch.equal(out[1].view(torch.uint8), xq.view(torch.uint8)) and out[3].item() == ax.item()
    y = cudaex.fp8_gemm_plain(out[1], out[2], sx, sw, x_dtype)
    d = (out[0].float() - y.float()).abs() / y.float().abs().clamp(min=1.0)
    assert d.max().item() <= FP8_TOL[x_dtype]


@pytest.mark.gpu
def test_fp8_linear_f32_in_a_cuda_graph_with_new_inputs(cuda):
    """Both kernels (quantize, product) replay in a graph: new x and w values
    and new scales, copied into the captured tensors, give the plain
    version's codes, amaxes and y."""
    x, w, sx, sw = _fp8_card_inputs(cuda, torch.float32, torch.float32, 200, 136, 288, seed=10)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cudaex.fp8_linear(x, w, sx, sw, save_quantized=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cudaex.fp8_linear(x, w, sx, sw, save_quantized=True)
    for seed in (11, 12):
        for dst, src in zip((x, w, sx, sw), _fp8_card_inputs(cuda, torch.float32, torch.float32, 200, 136, 288,
                                                             seed=seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        _fp8_check(out, cudaex.fp8_linear_plain(x, w, sx, sw, save_quantized=True), torch.float32)


# grouped_mlp (plain version against pallasex in tests/test_torch_moe.py)
# against its plain version on the card, max |kernel - plain| within
# GROUPED_TOL · max |plain|: the outputs are far below 1, so the limit follows
# their own scale. f32 to 1e-4 (FFMAs against cuBLAS's f32 GEMM: another
# summation order over D and H), bf16 to 2^-6, two bf16 ulps of the largest
# output (both round h and y to bf16 from f32 sums taken in another order: an
# output moves by at most its own ulp, which is at most 2^-7 of the largest).
GROUPED_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def _assert_grouped_close(out, want, dtype):
    err = (out.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= GROUPED_TOL[dtype] * scale, (err, scale)


GROUPED_CASES = {
    # (E, cap, D, H, group_sizes)
    "decode": (8, 8, 256, 128, [3, 0, 8, 1, 2, 0, 1, 1]),  # cap below one mma tile, empty experts
    "partial-block": (4, 128, 128, 64, [128, 70, 0, 64]),
    "ragged-cap": (3, 100, 64, 96, [100, 37, 99]),
    "narrow": (2, 20, 40, 24, [20, 5]),  # D, H not multiples of the 64-column tile
}


def _grouped_card_inputs(cuda, dtype, E, cap, D, H, gs, seed):
    """Bins with nonzero rows past group_sizes: the kernel and the plain
    version must give zeros there whatever the bins hold."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    bins = torch.randn(E, cap, D, device=cuda, generator=g).to(dtype)
    s = 1.0 / math.sqrt(D)
    wg = (torch.rand(E, D, H, device=cuda, generator=g) * 2 - 1).mul(s).to(dtype)
    wu = (torch.rand(E, D, H, device=cuda, generator=g) * 2 - 1).mul(s).to(dtype)
    wd = (torch.rand(E, H, D, device=cuda, generator=g) * 2 - 1).mul(s / 2).to(dtype)
    return bins, wg, wu, wd, torch.tensor(gs, dtype=torch.int64, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GROUPED_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_mlp_kernel_matches_plain(cuda, case, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    E, cap, D, H, gs = GROUPED_CASES[case]
    args = _grouped_card_inputs(cuda, dtype, E, cap, D, H, gs, seed=cap + D)
    n0 = cudaex.grouped_mlp.launches
    out = cudaex.grouped_mlp(*args)
    torch.cuda.synchronize()
    assert cudaex.grouped_mlp.launches == n0 + 1 and out.dtype == dtype
    _assert_grouped_close(out, cudaex.grouped_mlp_plain(*args), dtype)
    for e, n in enumerate(gs):
        assert not out[e, n:].any()


@pytest.mark.gpu
def test_grouped_mlp_cuda_never_takes_the_plain_route(cuda, monkeypatch):
    args = _grouped_card_inputs(cuda, torch.bfloat16, *GROUPED_CASES["decode"], seed=1)

    def refuse(*a):
        raise AssertionError("the plain route ran on a CUDA tensor")

    monkeypatch.setattr(cudaex, "grouped_mlp_plain", refuse)
    n0 = cudaex.grouped_mlp.launches
    cudaex.grouped_mlp(*args)
    torch.cuda.synchronize()
    assert cudaex.grouped_mlp.launches == n0 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_mlp_rows_are_independent_of_their_block(cuda, dtype):
    """A row's output is bit-equal whatever the other rows of its block hold
    and however many of them are live: the engine's batched decode must
    equal solo decoding."""
    bins, wg, wu, wd, _ = _grouped_card_inputs(cuda, dtype, 2, 64, 128, 64, [64, 64], seed=3)
    full = cudaex.grouped_mlp(bins, wg, wu, wd, torch.tensor([64, 64], device=cuda))
    other = bins.clone()
    other[:, 1:] = torch.randn_like(other[:, 1:].float()).to(dtype)
    alone = cudaex.grouped_mlp(other[:, :8].contiguous(), wg, wu, wd, torch.tensor([1, 1], device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(full[:, 0], alone[:, 0]) and not alone[:, 1:].any()


@pytest.mark.gpu
def test_grouped_mlp_in_a_cuda_graph(cuda):
    """group_sizes is read on the device: a replayed graph follows new
    sizes written into the same tensor."""
    bins, wg, wu, wd, gs = _grouped_card_inputs(cuda, torch.bfloat16, *GROUPED_CASES["partial-block"], seed=4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cudaex.grouped_mlp(bins, wg, wu, wd, gs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cudaex.grouped_mlp(bins, wg, wu, wd, gs)
    for sizes in ([128, 70, 0, 64], [1, 0, 128, 65]):
        gs.copy_(torch.tensor(sizes, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        _assert_grouped_close(out, cudaex.grouped_mlp_plain(bins, wg, wu, wd, gs), torch.bfloat16)


@pytest.mark.gpu
def test_grouped_mlp_wrapper_refuses_bad_inputs(cuda):
    bins, wg, wu, wd, gs = _grouped_card_inputs(cuda, torch.bfloat16, *GROUPED_CASES["narrow"], seed=5)
    with pytest.raises(ValueError, match=r"unsupported inputs .*w_gate \(2, 40, 24\) torch.float32"):
        cudaex.grouped_mlp(bins, wg.float(), wu, wd, gs)
    with pytest.raises(ValueError, match=r"unsupported inputs bins \(2, 20, 40\) torch.float16"):
        cudaex.grouped_mlp(*(t.half() for t in (bins, wg, wu, wd)), gs)
    with pytest.raises(ValueError, match=r"unsupported inputs .*w_down \(2, 8, 40\)"):
        cudaex.grouped_mlp(bins, wg, wu, wd[:, :8].contiguous(), gs)
    with pytest.raises(ValueError, match=r"unsupported inputs bins \(2, 20, 36\)"):
        cudaex.grouped_mlp(bins[..., :36].contiguous(), wg[:, :36].contiguous(), wu[:, :36].contiguous(),
                           wd[..., :36].contiguous(), gs)
    with pytest.raises(ValueError, match="CUDA device"):
        cudaex.grouped_mlp(bins, wg, wu, wd, gs.cpu())


GROUPED_EDGE_CASES = {
    # (E, cap, D, H, group_sizes)
    "cap1": (4, 1, 128, 64, [1, 0, 1, 1]),
    "cap8_at_cap": (4, 8, 128, 64, [8, 0, 3, 8]),
    "cap200": (3, 200, 128, 96, [200, 0, 250]),  # one at cap, one empty, one past cap
    "all_empty": (3, 64, 128, 64, [0, 0, 0]),
    "at_cap": (2, 128, 64, 64, [128, 128]),
    "one_expert": (1, 40, 96, 32, [29]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GROUPED_EDGE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_mlp_edges_match_plain(cuda, case, dtype):
    """Each route (cudaex.grouped_mlp_plan: f32 ffma, bf16 decode for cap <=
    8, bf16 wgmma) at cap 1, an expert at exactly cap and one past it, every
    expert empty, E = 1; rows past group_sizes are zero."""
    torch.backends.cuda.matmul.allow_tf32 = False
    E, cap, D, H, gs = GROUPED_EDGE_CASES[case]
    args = _grouped_card_inputs(cuda, dtype, E, cap, D, H, gs, seed=cap + D + E)
    out = cudaex.grouped_mlp(*args)
    torch.cuda.synchronize()
    _assert_grouped_close(out, cudaex.grouped_mlp_plain(*args), dtype)
    for e, n in enumerate(gs):
        assert not out[e, n:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,cap", [(torch.float32, 100), (torch.bfloat16, 100), (torch.bfloat16, 8)],
                         ids=["ffma", "wgmma", "decode"])
def test_grouped_mlp_launches_the_planned_route(cuda, dtype, cap):
    from torch.profiler import ProfilerActivity, profile

    args = _grouped_card_inputs(cuda, dtype, 3, cap, 128, 64, [cap, 1, 0], seed=7)
    route = cudaex.grouped_mlp_plan(3, cap, 128, 64, dtype)["route"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cudaex.grouped_mlp(*args)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "grouped_mlp_" in e.key]
    assert len(names) == 2 and all(f"grouped_mlp_{route}<" in k for k in names), names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,cap,sizes", [(torch.float32, 128, ([128, 70, 0, 64], [1, 0, 128, 65])),
                                             (torch.bfloat16, 8, ([8, 0, 3, 1], [0, 8, 1, 2]))],
                         ids=["ffma", "decode"])
def test_grouped_mlp_routes_in_a_cuda_graph(cuda, dtype, cap, sizes):
    """The ffma and decode routes replay too (the wgmma route is
    test_grouped_mlp_in_a_cuda_graph's): new sizes and new bins copied into
    the captured tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bins, wg, wu, wd, gs = _grouped_card_inputs(cuda, dtype, 4, cap, 128, 64, list(sizes[0]), seed=8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cudaex.grouped_mlp(bins, wg, wu, wd, gs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cudaex.grouped_mlp(bins, wg, wu, wd, gs)
    for seed, s in enumerate(sizes):
        gs.copy_(torch.tensor(s, device=cuda))
        bins.copy_(_grouped_card_inputs(cuda, dtype, 4, cap, 128, 64, list(s), seed=20 + seed)[0])
        graph.replay()
        torch.cuda.synchronize()
        _assert_grouped_close(out, cudaex.grouped_mlp_plain(bins, wg, wu, wd, gs), dtype)
        for e, n in enumerate(s):
            assert not out[e, n:].any()


# ---------------------------------------------------------------------------
# Ring attention's step kernels on the card (plain versions against
# pallasex's interpret kernels in tests/test_torch_parallel.py)
# ---------------------------------------------------------------------------

RING_CASES = {"mha-ragged": (1, 4, 4, 200, 64), "gqa-d128": (1, 8, 2, 256, 128),
              "gqa-ragged-d32": (2, 4, 2, 77, 32), "mqa-d16": (1, 2, 1, 64, 16)}
# (q_off, k_off) in units of T: the step kinds of a rank's ring
RING_STEPS = {"diagonal": (1, 1), "past": (1, 0), "future": (0, 1)}
# chip_smoke.py's RING_TOL: each tensor within tol on max |err| / max |ref|
# and on ||err|| / ||ref|| (|o/l| and dq span ~0.03 to ~4 across rows, so a
# bar scaled by the largest value alone is as large as a typical one); a
# zero reference (a future step's backward) admits no error.
RING_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -6}


def _assert_ring_close(got, want, dtype, name):
    d = (got.float() - want.float()).abs()
    w = want.float()
    tol = RING_TOL[dtype]
    assert d.max() <= tol * w.abs().max() and d.norm() <= tol * w.norm(), (
        name, d.max().item(), w.abs().max().item(), d.norm().item(), w.norm().item())


def _ring_card_inputs(cuda, dtype, B, H, Hkv, T, D, seed):
    """q, kb, vb, do in dtype, and the (o, m, l) a diagonal step leaves from
    the empty state (plain version, f32): the state a later step finds."""
    q, kb, vb, _, _, do = (_torch(a).to(cuda) for a in _flash_inputs(B, H, Hkv, T, D, seed=seed))
    q, kb, vb, do = (t.to(dtype) for t in (q, kb, vb, do))
    o = torch.zeros(B, H, T, D, device=cuda)
    m = torch.full((B, H, T, 1), cudaex.NEG_INF, device=cuda)
    l = torch.zeros(B, H, T, 1, device=cuda)
    o, m, l = cudaex.ring_flash_step_plain(q, kb, vb, o, m, l, T, T, True)
    return q, kb, vb, do, o.contiguous(), m.contiguous(), l.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("step", list(RING_STEPS))
@pytest.mark.parametrize("case", list(RING_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["f32", "bf16", "f16"])
def test_ring_step_kernels_match_plain(cuda, case, step, causal, dtype):
    """Both ring kernels against their plain versions within RING_TOL (o/l,
    m, l; dq, dk, dv), from the state a diagonal step leaves, with GQA,
    ragged T and each step kind."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, H, Hkv, T, D = RING_CASES[case]
    q, kb, vb, do, o, m, l = _ring_card_inputs(cuda, dtype, B, H, Hkv, T, D, seed=T + D)
    q_off, k_off = (T * x for x in RING_STEPS[step])
    want = cudaex.ring_flash_step_plain(q, kb, vb, o, m, l, q_off, k_off, causal)
    n0 = (cudaex.ring_flash_step.launches, cudaex.ring_flash_bwd_step.launches)
    got = cudaex.ring_flash_step(q, kb, vb, o.clone(), m.clone(), l.clone(), q_off, k_off, causal)
    # the global lse of the carried state after this step, and delta
    lse = (want[1] + torch.log2(want[2])) * cudaex.LN2
    delta = (do.float() * (want[0] / want[2])).sum(-1, keepdim=True)
    grads = cudaex.ring_flash_bwd_step(q, kb, vb, do, lse, delta, q_off, k_off, causal)
    torch.cuda.synchronize()
    assert (cudaex.ring_flash_step.launches, cudaex.ring_flash_bwd_step.launches) == (
        n0[0] + 1, n0[1] + 1)
    for name, g, w in zip(("o/l", "m", "l"), (got[0] / got[2], got[1], got[2]),
                          (want[0] / want[2], want[1], want[2])):
        _assert_ring_close(g, w, dtype, name)
    ref = cudaex.ring_flash_bwd_step_plain(q, kb, vb, do, lse, delta, q_off, k_off, causal)
    for name, g, w in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == torch.float32
        _assert_ring_close(g, w, dtype, name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ring_future_step_leaves_accumulators_bit_unchanged(cuda, dtype):
    q, kb, vb, do, o, m, l = _ring_card_inputs(cuda, dtype, *RING_CASES["gqa-ragged-d32"], seed=1)
    before = [t.clone() for t in (o, m, l)]
    T = q.shape[2]
    out = cudaex.ring_flash_step(q, kb, vb, o, m, l, 0, T, True)
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(out, (o, m, l)))  # updated in place
    for a, b in zip((o, m, l), before):
        assert torch.equal(a, b)
    lse = torch.zeros_like(m)
    for g in cudaex.ring_flash_bwd_step(q, kb, vb, do, lse, lse, 0, T, True):
        assert not g.any()


def _ring_backward_twice(cuda, dtype, B, H, Hkv, T, D, step):
    q, kb, vb, do, o, m, l = _ring_card_inputs(cuda, dtype, B, H, Hkv, T, D, seed=T + H)
    lse = (m + torch.log2(l)) * cudaex.LN2
    delta = (do.float() * (o / l)).sum(-1, keepdim=True)
    q_off, k_off = (T * x for x in RING_STEPS[step])
    run = lambda: cudaex.ring_flash_bwd_step(q, kb, vb, do, lse, delta, q_off, k_off, True)  # noqa: E731
    first = run()
    second = run()
    torch.cuda.synchronize()
    return first, second


@pytest.mark.gpu
@pytest.mark.parametrize("step", ["diagonal", "past"])
@pytest.mark.parametrize("B,H,Hkv,T,D", [(1, 16, 4, 1000, 128), (1, 16, 16, 2048, 64)],
                         ids=["gqa-d128", "mha-d64"])
def test_ring_backward_bf16_runs_differ_by_at_most_an_ulp(cuda, B, H, Hkv, T, D, step):
    """On the flash backward's core, dq (and dk, dv with GQA) are sums of f32
    reduce-adds whose order changes from run to run: two runs may differ by
    one bf16 ulp of an element once rounded to the input dtype (as the ring
    rounds its sums), the magnitude taken as at least 2^-16 of the tensor's
    largest, as test_flash_backward_bf16_runs_differ_by_at_most_an_ulp
    holds the flash backward."""
    first, second = _ring_backward_twice(cuda, torch.bfloat16, B, H, Hkv, T, D, step)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        m = torch.maximum(a.abs(), b.abs())
        bound = _bf16_ulp(m.clamp(min=2.0 ** -16 * m.max().item()))
        assert ((a - b).abs() <= bound).all(), name


@pytest.mark.gpu
def test_ring_backward_f32_is_bit_reproducible(cuda):
    """The f32 route (csrc/ring_flash_bwd.cu's two passes) adds nothing
    atomically."""
    first, second = _ring_backward_twice(cuda, torch.float32, 1, 8, 2, 300, 64, "diagonal")
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("short", [128, 56], ids=["short-of-T", "not-whole-tiles"])
def test_ring_backward_refuses_a_pitch_it_would_read_past(cuda, monkeypatch, short):
    q = torch.randn(1, 2, 256, 64, device=cuda).to(torch.bfloat16)
    lse = torch.zeros(1, 2, 256, 1, device=cuda)
    plan = cudaex.flash_backward_plan

    def short_plan(*a, **kw):
        out = plan(*a, **kw)
        return {**out, "pitch": out["pitch"] - short}

    monkeypatch.setattr(cudaex, "flash_backward_plan", short_plan)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        cudaex.ring_flash_bwd_step(q, q, q, q, lse, lse, 0, 0, True)


@pytest.mark.gpu
def test_ring_wrappers_never_take_the_plain_route_on_the_card(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(cudaex, "ring_flash_step_plain", refuse)
    monkeypatch.setattr(cudaex, "ring_flash_bwd_step_plain", refuse)
    q = torch.randn(1, 2, 64, 32, device=cuda)
    o, m, l = torch.zeros_like(q), torch.full((1, 2, 64, 1), -1e30, device=cuda), torch.zeros(1, 2, 64, 1, device=cuda)
    n0 = cudaex.ring_flash_step.launches
    cudaex.ring_flash_step(q, q, q, o, m, l, 0, 0, True)
    cudaex.ring_flash_bwd_step(q, q, q, q, l, l, 0, 0, True)
    torch.cuda.synchronize()
    assert cudaex.ring_flash_step.launches == n0 + 1
    with pytest.raises(ValueError, match="f32"):
        cudaex.ring_flash_step(q, q, q, o.bfloat16(), m, l, 0, 0, True)
    with pytest.raises(ValueError, match="does not fit"):
        cudaex.ring_flash_step(q, q[:, :, :32].contiguous(), q[:, :, :32].contiguous(), o, m, l, 0, 0)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 2, 64, 136, device=cuda)
        cudaex.ring_flash_step(z, z, z, z, m, l, 0, 0)


@pytest.mark.gpu
def test_ring_checker_on_card_tensors(cuda):
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt, device=cuda)  # noqa: E731
    assert cudaex.ring_flash_supported(z(1, 16, 2048, 64), z(1, 16, 2048, 64), z(1, 16, 2048, 64))
    assert cudaex.ring_flash_supported(z(1, 16, 2048, 128), z(1, 4, 2048, 128), z(1, 4, 2048, 128))
    assert not cudaex.ring_flash_supported(z(1, 16, 2048, 64), z(1, 16, 1024, 64), z(1, 16, 1024, 64))
    assert not cudaex.ring_flash_supported(z(1, 16, 64, 256), z(1, 16, 64, 256), z(1, 16, 64, 256))
