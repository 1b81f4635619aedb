"""The paged-attention decode kernel's two stages (csrc/paged_attention.cu)
as plain PyTorch on the CPU: the split kernel's per-split unnormalised (o,
m, l) and the combine. Composed, they must give paged_attention_plain within
1e-6 in f32, and pallasex.paged_attention_decode in interpret mode at
tests/test_torch_kernels.py's bars (f32 1e-5, bf16 2e-2: thunder_tpu's own
kernel test's). Also the wrapper's plan (splits, scratch, blocks) as a
function of the shapes, and the Hopper checker. On a CUDA card only (``-m
gpu``): the kernel against its plain version in bf16, fp16 and f32, under
CUDA-graph replay, and never through the plain route. On the card, run
``python -m pytest --noconftest -m gpu tests/test_torch_paged.py``.

Card tolerances: f32 1e-4 (exp2 with scale·log2(e) folded into q against
the plain version's exp, sums in another order), bf16 2e-2 (the repo's
paged bar: one rounding of the output, an ulp at |o| ~ 2), fp16 1e-2 (three
more mantissa bits)."""
import numpy as np
import pytest
import torch

import thunder_tpu_torch as tt
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.ops import ltorch

# seq_lens: a partial page, an exact page, one slot past it, a long ragged
# one and the full table; one long sequence beside short ones; empty rows
CASES = {"ragged": [1, 16, 17, 300, 2048], "long-one-short-rest": [2048, 1, 1, 1, 1, 1, 1, 1],
         "empty-rows": [0, 300, 5, 0]}


def _inputs(lens, H=4, Hkv=2, D=16, ps=16, npm=128, seed=0):
    """numpy q (B, H, D), pools (P, ps, Hkv, D), page_table (B, npm) with
    each sequence's pages drawn without replacement (null page 0 past its
    end) and seq_lens."""
    rng = np.random.RandomState(seed)
    B = len(lens)
    P = 1 + B * npm
    kp, vp = (rng.randn(P, ps, Hkv, D).astype(np.float32) for _ in range(2))
    q = rng.randn(B, H, D).astype(np.float32)
    perm = rng.permutation(P - 1) + 1
    pt = np.zeros((B, npm), np.int32)
    used = 0
    for b, L in enumerate(lens):
        n = -(-L // ps)
        pt[b, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, pt, np.asarray(lens, np.int32)


def _torch_args(args, dtype, device="cpu"):
    return [torch.tensor(a).to(dtype if a.dtype == np.float32 else torch.int32).to(device) for a in args]


def _composed(q, kp, vp, pt, sl):
    B, H, D = q.shape
    P, ps, Hkv, _ = kp.shape
    npm = pt.shape[1]
    plan = cudaex.paged_attention_plan(B, H, Hkv, D, ps, npm, q.dtype)
    part = cudaex.paged_attention_split_plain(q, kp, vp, pt, sl, plan["pages_per_split"])
    assert tuple(part.shape) == (B, H, plan["n_split"], D + 2)
    return cudaex.paged_attention_combine_plain(part, sl, plan["split_tokens"], npm * ps, q.dtype)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ps", [16, 8])
def test_split_and_combine_compose_to_the_plain_version(case, ps):
    args = _torch_args(_inputs(CASES[case], ps=ps, npm=2048 // ps), torch.float32)
    got = _composed(*args)
    want = cudaex.paged_attention_plain(*args)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert not got[torch.tensor(CASES[case]) == 0].any()  # a row with no live slot gives zeros


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
def test_split_and_combine_match_pallas(case, dtype, tol):
    import jax.numpy as jnp

    from thunder_tpu.executors import pallasex

    np_args = _inputs(CASES[case], seed=3)
    args = _torch_args(np_args, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    # the same rounded inputs on both sides
    j = [jnp.asarray(a.float().numpy(), jdt) if a.is_floating_point() else jnp.asarray(a.numpy())
         for a in args]
    want = np.asarray(pallasex.paged_attention_decode(*j, interpret=True), dtype=np.float32)
    np.testing.assert_allclose(_composed(*args).float().numpy(), want, atol=tol, rtol=tol)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("shape,want", [
    # Llama-3-1B decode at max_seq=2048: 128-token splits, 16 of them; one
    # warp per (b, h) combines
    ((8, 32, 8, 64, 16, 128, BF16),
     dict(pages_per_split=8, split_tokens=128, n_split=16, blocks=1024, combine_blocks=64,
          scratch={"partials": ((8, 32, 16, 66), F32)})),
    # a table of one split: no combine, no scratch (the split kernel writes o)
    ((4, 8, 8, 128, 16, 8, F32),
     dict(pages_per_split=8, split_tokens=128, n_split=1, blocks=32, combine_blocks=0, scratch={})),
    # a ragged last split: ceil(npm / pages_per_split)
    ((2, 4, 2, 64, 32, 9, torch.float16),
     dict(pages_per_split=4, split_tokens=128, n_split=3, blocks=12, combine_blocks=2,
          scratch={"partials": ((2, 4, 3, 66), F32)})),
    # pages larger than a split: one page a split
    ((1, 8, 1, 64, 256, 4, BF16),
     dict(pages_per_split=1, split_tokens=256, n_split=4, blocks=4, combine_blocks=2,
          scratch={"partials": ((1, 8, 4, 66), F32)})),
], ids=["llama-3-1b-decode", "one-split", "ragged-last-split", "big-pages"])
def test_plan(shape, want):
    plan = cudaex.paged_attention_plan(*shape)
    assert {k: plan[k] for k in want} == want
    assert plan["scratch_bytes"] == sum(
        int(np.prod(s)) * dt.itemsize for s, dt in want["scratch"].values())


def test_plan_fills_the_card_at_the_decode_shape():
    """A 1,024-token sequence spreads over 8 split blocks a kv head: 512
    live blocks at B=8 x Hkv=8 for 132 SMs, where one block per (sequence,
    kv head) gave 64; the split block's shared memory leaves room for
    several on an SM."""
    plan = cudaex.paged_attention_plan(8, 32, 8, 64, 16, 128, BF16)
    live = 8 * 8 * -(-1024 // plan["split_tokens"])
    assert live == 512 >= 3 * 132
    assert plan["smem_bytes"] * 4 <= 227 * 1024


def test_claim_follows_the_hopper_checker():
    """Claimed for up to 8 query heads a kv head, D a multiple of the 16-byte
    vector up to 32 vectors and up to 128 splits a table; more, or H not a
    multiple of Hkv, run as the decomposition."""
    from thunder_tpu_torch.core import dtypes
    from thunder_tpu_torch.core.proxies import TensorProxy

    def ok(B=2, H=8, Hkv=2, D=64, ps=16, npm=4, dt=dtypes.bfloat16):
        p = lambda *s, d=dt: TensorProxy(shape=s, dtype=d, device=tt.devices.cpu)  # noqa: E731
        return cudaex.paged_attention_supported(
            p(B, H, D), p(9, ps, Hkv, D), p(9, ps, Hkv, D), p(B, npm, d=dtypes.int32),
            p(B, d=dtypes.int32))

    assert ok() and ok(H=16) and ok(H=14) and ok(D=256) and ok(D=128, dt=dtypes.float32)
    assert ok(D=8) and ok(H=2, Hkv=2, ps=1) and ok(npm=1024) and ok(ps=256, npm=128)
    assert not ok(H=18) and not ok(H=32) and not ok(D=264) and not ok(D=132, dt=dtypes.float32)
    assert not ok(D=36) and not ok(H=6, Hkv=4) and not ok(npm=1032) and not ok(ps=256, npm=129)
    cfn = tt.jit(lambda *a: ltorch.paged_attention(*a))
    for H, claimed in ((4, True), (36, False)):
        args = _torch_args(_inputs([5, 40], H=H, Hkv=2, npm=4), F32)
        out = cfn(*args)
        ids = {b.sym.id for b in tt.last_traces(cfn)[-1].bound_symbols}
        assert ("thunder.paged_attention" in ids) == claimed
        torch.testing.assert_close(out, cudaex.paged_attention_plain(*args), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}
# (seq_lens, H, Hkv, D): Llama-3-1B's decode heads at page 16, and a D=128 pool
CARD_CASES = {**{k: (v, 32, 8, 64) for k, v in CASES.items()},
              "d128-ragged": (CASES["ragged"], 16, 4, 128), "d128-g1": ([700, 2048, 3], 4, 4, 128)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_kernel_matches_plain(cuda, case, dtype):
    lens, H, Hkv, D = CARD_CASES[case]
    args = _torch_args(_inputs(lens, H=H, Hkv=Hkv, D=D, seed=len(lens) + D), dtype, cuda)
    assert cudaex.paged_attention_plan(len(lens), H, Hkv, D, 16, 128, dtype)["n_split"] > 1
    n0 = cudaex.paged_attention.launches
    out = cudaex.paged_attention(*args)
    torch.cuda.synchronize()
    assert cudaex.paged_attention.launches == n0 + 1
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(out.float(), cudaex.paged_attention_plain(*args).float(),
                               atol=tol, rtol=tol)
    assert not out[args[4] == 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_on_a_table_of_one_split(cuda, dtype):
    """n_split == 1: no combine; the split kernel writes every row, zeros for
    seq_len 0."""
    args = _torch_args(_inputs([0, 5, 128, 77], H=8, Hkv=2, D=64, npm=8), dtype, cuda)
    assert cudaex.paged_attention_plan(4, 8, 2, 64, 16, 8, dtype)["n_split"] == 1
    out = cudaex.paged_attention(*args)
    torch.cuda.synchronize()
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(out.float(), cudaex.paged_attention_plain(*args).float(),
                               atol=tol, rtol=tol)
    assert not out[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_in_a_cuda_graph_equals_eager(cuda, dtype):
    """Captured once, replayed after q, the pools' contents and seq_lens
    change in place: the launch reads seq_lens on the device only."""
    args = _torch_args(_inputs(CASES["ragged"], H=32, Hkv=8, D=64, seed=5), dtype, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cudaex.paged_attention(*args)  # build and warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cudaex.paged_attention(*args)
    new = _torch_args(_inputs([2048, 1, 700, 16, 0], H=32, Hkv=8, D=64, seed=6), dtype, cuda)
    for a, b in zip(args, new):
        a.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    eager = cudaex.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    tol = CARD_TOL[dtype]
    torch.testing.assert_close(out.float(), cudaex.paged_attention_plain(*args).float(),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
def test_kernel_never_takes_the_plain_route(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain version ran for CUDA tensors")

    for name in ("paged_attention_plain", "paged_attention_split_plain",
                 "paged_attention_combine_plain"):
        monkeypatch.setattr(cudaex, name, refuse)
    args = _torch_args(_inputs(CASES["ragged"], H=32, Hkv=8, D=64), torch.bfloat16, cuda)
    n0 = cudaex.paged_attention.launches
    out = cudaex.paged_attention(*args)
    torch.cuda.synchronize()
    assert cudaex.paged_attention.launches == n0 + 1 and out.isfinite().all()
    with pytest.raises(ValueError, match="unsupported"):
        wide = _torch_args(_inputs([5], H=32, Hkv=2, D=64), torch.bfloat16, cuda)  # 16 > 8
        cudaex.paged_attention(*wide)
