"""Paged chunk attention on paged_chunk_plan's routes: the flash forward's
wgmma core in paged mode (csrc/flash_fwd_sm90.cu; bf16 and fp16 chunks), or
a split kernel over the keys (csrc/paged_chunk_attention.cu; verify, f32
and page sizes the core cannot take), then the combine of
csrc/paged_combine.cuh.

On the CPU: ``cudaex.paged_chunk_plan`` (routes, splits, blocks, scratch,
from shapes alone); the split stage's and the combine's plain versions,
composed, against ``paged_chunk_attention_plain`` (f32, 1e-6) and
pallasex.paged_chunk_decode in interpret mode (f32 1e-5, bf16 2e-2:
tests/test_torch_kernels.py's bars) at chunk and verify shapes, with a
verify row past the table and a row with no live key (zeros). A split that
loses its last page fails the bar. On a CUDA card only (``-m gpu``; no
jax): the kernel against its plain version at chunk starts 0, 1024 and
1792 and ragged verify rows, page sizes 16 and 8, in bf16, fp16 and f32;
CUDA-graph replay; no plain route. On the card: ``python -m pytest
--noconftest -m gpu tests/test_torch_chunk.py``.

Card tolerances, as tests/test_torch_kernels.py's chunk tests (atol and
rtol): f32 1e-4 (exp2 with scale·log2(e) folded in against the plain
version's exp, sums in another order), bf16 and fp16 2e-2 (p rounded to the
pool dtype against a split's running max, not the row's, and one rounding of
the output)."""
import functools
import inspect

import numpy as np
import pytest
import torch

from thunder_tpu_torch.executors import cudaex

F32, BF16 = torch.float32, torch.bfloat16


def _inputs(q_pos, H=4, Hkv=2, D=16, ps=8, npm=24, seed=0):
    """numpy q (B, H, T, D), pools (P, ps, Hkv, D), a page table of pages
    drawn without replacement covering each row's largest position (null
    page 0 past it; rows 0 and 1 share their first pages) and q_pos."""
    rng = np.random.RandomState(seed)
    q_pos = np.asarray(q_pos, np.int32)
    B, T = q_pos.shape
    P = 1 + B * npm
    kp, vp = (rng.randn(P, ps, Hkv, D).astype(np.float32) for _ in range(2))
    q = rng.randn(B, H, T, D).astype(np.float32)
    perm = rng.permutation(P - 1) + 1
    pt = np.zeros((B, npm), np.int32)
    used = 0
    for b in range(B):
        n = min(npm, max(0, int(q_pos[b].max())) // ps + 1)
        pt[b, :n] = perm[used:used + n]
        used += n
    if B > 1:
        pt[1, :2] = pt[0, :2]
    return q, kp, vp, pt, q_pos


def _torch_args(args, dtype):
    return [torch.tensor(a).to(dtype) if a.dtype == np.float32 else torch.tensor(a) for a in args]


TABLE = 24 * 8  # _inputs' table: 192 tokens
# (q_pos, Hkv): chunks of 24 queries (g·T = 48 rows, the chunk route) from
# position 0 and near the table's end; verify rows of 3 (g·T = 6, the verify
# route) with ragged positions, one reaching past the table; the same with a
# row that sees no key
CASES = {"chunk-start0": (np.arange(24)[None], 2),
         "chunk-start150": (150 + np.arange(24)[None], 2),
         "chunk-g1": (100 + np.arange(24)[None], 4),
         "verify": (np.asarray([1, 17, 130, 190])[:, None] + np.arange(3), 2),
         "verify-no-live-key": (np.asarray([[-1, -1, -1], [40, 41, 42], [7, 8, 9]]), 2)}


def _composed(q, kp, vp, pt, qp, split=None, split_fn=None):
    B, H, T, D = q.shape
    P, ps, Hkv, _ = kp.shape
    npm = pt.shape[1]
    plan = cudaex.paged_chunk_plan(B, H, Hkv, T, D, ps, npm, q.dtype)
    split = split or plan["split_tokens"]
    part = (split_fn or cudaex.paged_chunk_split_plain)(q, kp, vp, pt, qp, split)
    assert tuple(part.shape) == (B, H, T, -(-npm * ps // split), D + 2)
    return cudaex.paged_chunk_combine_plain(part, qp, split, npm * ps, q.dtype)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("split", [None, 64], ids=["plan", "split64"])
@pytest.mark.parametrize("ps", [8, 16])
def test_split_and_combine_compose_to_the_plain_version(case, split, ps):
    pos, Hkv = CASES[case]
    args = _torch_args(_inputs(pos, Hkv=Hkv, ps=ps, npm=TABLE // ps), F32)
    got = _composed(*args, split=split)
    torch.testing.assert_close(got, cudaex.paged_chunk_attention_plain(*args), atol=1e-6, rtol=1e-6)
    dead = torch.tensor(pos) < 0
    assert not got.permute(0, 2, 1, 3)[dead].any()  # a row with no live key gives zeros


def test_bf16_splits_round_against_their_own_max():
    """In bf16 the split stage rounds p against its split's max: composed,
    it stays within the repo's bf16 bar of the unsplit plain version (which
    rounds against the row's), and is not equal to it."""
    pos, Hkv = CASES["chunk-start150"]
    args = _torch_args(_inputs(pos, Hkv=Hkv, seed=4), BF16)
    got = _composed(*args, split=64).float()
    want = cudaex.paged_chunk_attention_plain(*args).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2, rtol=2e-2)
    assert not torch.equal(got, want)


def _drops_last_page(q, kp, vp, pt, qp, split, scale=None):
    """A faulty split stage: the last page of every split reads the null
    page in place of its own."""
    pt = pt.clone()
    pps = split // kp.shape[1]
    pt[:, pps - 1::pps] = 0
    return cudaex.paged_chunk_split_plain(q, kp, vp, pt, qp, split, scale)


@pytest.mark.parametrize("case", ["chunk-start150", "verify"])
def test_planted_fault_fails_the_bar(case):
    pos, Hkv = CASES[case]
    args = _torch_args(_inputs(pos, Hkv=Hkv, seed=2), F32)
    bad = _composed(*args, split=64, split_fn=_drops_last_page)
    assert not torch.allclose(bad, cudaex.paged_chunk_attention_plain(*args), atol=1e-3, rtol=1e-3)


@pytest.fixture(scope="module")
def pallas_chunk():
    import jax
    import jax.numpy as jnp

    from thunder_tpu.executors import pallasex

    decode = jax.jit(functools.partial(pallasex.paged_chunk_decode, interpret=True))

    def run(args, dtype):
        jdt = jnp.float32 if dtype == F32 else jnp.bfloat16
        j = [jnp.asarray(a.float().numpy(), jdt) if a.is_floating_point() else jnp.asarray(a.numpy())
             for a in args]
        return torch.tensor(np.asarray(decode(*j), dtype=np.float32))

    return run


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype,tol", [(F32, 1e-5), (BF16, 2e-2)], ids=["f32", "bf16"])
def test_composition_matches_pallas(pallas_chunk, case, dtype, tol):
    """Every row with a live key against pallasex's kernel; a row with none
    gives zeros here, where the TPU kernel's finite sentinel gives exp2(0)
    weights (tests/test_torch_kernels.py's chunk tests hold the same)."""
    pos, Hkv = CASES[case]
    args = _torch_args(_inputs(pos, Hkv=Hkv, seed=len(case)), dtype)
    got = _composed(*args).float()
    want = pallas_chunk(args, dtype)
    live = (torch.tensor(pos) >= 0)[:, None, :, None].expand_as(got)
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(), atol=tol, rtol=tol)
    assert not got[~live].any()


F16 = torch.float16


@pytest.mark.parametrize("shape,want", [
    # the fleet's chunk program: Llama-3-1B heads, 256-token chunks, a
    # 2,048-token table, bf16: the flash forward's core in paged mode, one
    # item per 128 queries of a q head, no split
    ((1, 32, 8, 256, 64, 16, 128, BF16),
     dict(route="wgmma", rows_per_block=128, split_tokens=2048, n_split=1, blocks=64,
          combine_blocks=0, scratch={}, smem_bytes=99400)),
    # the same in f32 (the agreements): 512-key splits, 512 blocks (two
    # waves on 132 SMs)
    ((1, 32, 8, 256, 64, 16, 128, F32),
     dict(route="chunk", rows_per_block=64, split_tokens=512, n_split=4, blocks=512,
          combine_blocks=2048, scratch={"partials": ((1, 32, 256, 4, 66), F32)})),
    # its verify program: max_batch 8, spec_k 2 (g·T = 12 rows): the decode's
    # 128-token splits
    ((8, 32, 8, 3, 64, 16, 128, BF16),
     dict(route="verify", rows_per_block=16, split_tokens=128, n_split=16, blocks=1024,
          combine_blocks=192, scratch={"partials": ((8, 32, 3, 16, 66), F32)})),
    # enough row tiles without a split: one split, no scratch, no combine
    ((1, 32, 8, 2048, 64, 16, 128, F32),
     dict(route="chunk", rows_per_block=64, split_tokens=2048, n_split=1, blocks=1024,
          combine_blocks=0, scratch={})),
    # a long table: the splits grow until the combine's 128 take it
    ((8, 32, 8, 3, 128, 16, 2048, F16),
     dict(route="verify", rows_per_block=16, split_tokens=256, n_split=128, blocks=8192,
          combine_blocks=192, scratch={"partials": ((8, 32, 3, 128, 130), F32)})),
    # pages the core's boxes cannot take (12 slots): the split route; a
    # ragged table: splits of whole 64-key tiles
    ((1, 4, 2, 24, 16, 12, 16, BF16),
     dict(route="chunk", rows_per_block=64, split_tokens=128, n_split=2, blocks=4,
          combine_blocks=24, scratch={"partials": ((1, 4, 24, 2, 18), F32)})),
    # D=128 on the core: 192 KB of two Q buffers and two K/V stages
    ((1, 16, 4, 100, 128, 8, 256, torch.float16),
     dict(route="wgmma", rows_per_block=128, split_tokens=2048, n_split=1, blocks=16, smem_bytes=197704)),
], ids=["fleet-chunk", "fleet-chunk-f32", "fleet-verify", "long-chunk", "long-table", "odd-pages",
        "d128-core"])
def test_plan(shape, want):
    plan = cudaex.paged_chunk_plan(*shape)
    assert {k: plan[k] for k in want} == want
    assert plan["scratch_bytes"] == sum(int(np.prod(s)) * dt.itemsize for s, dt in plan["scratch"].values())
    assert plan["split_tokens"] % 64 == 0 and plan["smem_bytes"] <= 227 * 1024


def test_plan_reads_no_positions():
    """The plan takes shapes and the table's width, never q_pos: the same
    launches serve any positions, so a CUDA graph can replay them. The split
    route fills two waves with little scratch; the core's route needs none."""
    assert "q_pos" not in inspect.signature(cudaex.paged_chunk_plan).parameters
    split = cudaex.paged_chunk_plan(1, 32, 8, 256, 64, 16, 128, F32)
    assert split["blocks"] >= 2 * cudaex.H100_SMS and split["scratch_bytes"] < 9e6
    core = cudaex.paged_chunk_plan(1, 32, 8, 256, 64, 16, 128, BF16)
    assert core["n_split"] == 1 and core["scratch"] == {} and core["blocks"] <= cudaex.H100_SMS


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_TOL = {F32: 1e-4, BF16: 2e-2, F16: 2e-2}
# (q_pos, H, Hkv, D) at the fleet's pool (npm 128 of 16 or 256 of 8): chunks
# of 256 from 0, 1024 and 1792; ragged verify rows, one past the table; a
# row with no live key
CARD_CASES = {**{f"chunk-start{s}": (s + np.arange(256)[None], 32, 8, 64) for s in (0, 1024, 1792)},
              "verify": (np.asarray([1, 17, 300, 1024, 2046, 16, 777, 1500])[:, None] + np.arange(3),
                         32, 8, 64),
              "verify-no-live-key": (np.asarray([[-1, -1, -1], [900, 901, 902]]), 32, 8, 64),
              "chunk-d128": (600 + np.arange(100)[None], 16, 4, 128)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_args(case, ps, dtype, dev, seed=0):
    pos, H, Hkv, D = CARD_CASES[case]
    return [a.to(dev) for a in _torch_args(_inputs(pos, H=H, Hkv=Hkv, D=D, ps=ps, npm=2048 // ps,
                                                   seed=seed), dtype)]


def _assert_near(out, want, tol):
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
@pytest.mark.parametrize("ps", [16, 8])
@pytest.mark.parametrize("dtype", [F32, BF16, F16], ids=["f32", "bf16", "f16"])
def test_kernel_matches_plain(cuda, case, ps, dtype):
    args = _card_args(case, ps, dtype, cuda, seed=ps)
    n0 = cudaex.paged_chunk_attention.launches
    out = cudaex.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    assert cudaex.paged_chunk_attention.launches == n0 + 1
    _assert_near(out, cudaex.paged_chunk_attention_plain(*args), CARD_TOL[dtype])
    dead = (args[4] < 0)[:, None, :].expand(out.shape[:3])
    assert not out[dead].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["chunk-start1792", "verify"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_kernel_in_a_cuda_graph_equals_eager(cuda, case, dtype):
    """Captured once, replayed after q, the pools, the table and q_pos
    change in place: the launches read the positions on the device only."""
    args = _card_args(case, 16, dtype, cuda, seed=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cudaex.paged_chunk_attention(*args)  # build and warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cudaex.paged_chunk_attention(*args)
    new = _card_args(case, 16, dtype, cuda, seed=6)
    new[4] = (new[4] - 700).clamp(min=-1).to(torch.int32)  # other positions, some with no key
    for a, b in zip(args, new):
        a.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    eager = cudaex.paged_chunk_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    _assert_near(out, cudaex.paged_chunk_attention_plain(*args), CARD_TOL[dtype])


@pytest.mark.gpu
def test_kernel_never_takes_the_plain_route(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain version ran for CUDA tensors")

    for name in ("paged_chunk_attention_plain", "paged_chunk_split_plain", "paged_chunk_combine_plain",
                 "paged_attention_combine_plain"):
        monkeypatch.setattr(cudaex, name, refuse)
    for case in ("chunk-start1792", "verify"):
        args = _card_args(case, 16, BF16, cuda)
        n0 = cudaex.paged_chunk_attention.launches
        out = cudaex.paged_chunk_attention(*args)
        torch.cuda.synchronize()
        assert cudaex.paged_chunk_attention.launches == n0 + 1 and out.isfinite().all()
    with pytest.raises(ValueError, match="unsupported"):
        wide = _card_args("verify", 16, BF16, cuda)
        wide[0] = torch.zeros(8, 32, 3, 136, dtype=BF16, device=cuda)
        wide[1] = wide[2] = torch.zeros(5, 16, 8, 136, dtype=BF16, device=cuda)
        cudaex.paged_chunk_attention(*wide)
