"""The ring forward step on the flash forward's wgmma/TMA core
(csrc/flash_fwd_sm90.cu in ring mode; csrc/ring_flash_fwd.cu in f32).

On the CPU: ``cudaex.ring_forward_plan``'s key-tile walk against
``cudaex.ring_visible`` over random (T, q_off, k_off) (every visible key in
a walked tile, no walked tile past the last visible one, a mask wherever a
walked tile holds a hidden key, none on a past shard, no item for a future
shard, at most one block an SM), and the core's ring-mode arithmetic written
out in f32 (``_core_ring_f32``: the plan's tiles, the mask only where the
plan runs it, the carried l seeded into one of a quad's four shares) against
``ring_flash_step_plain`` and pallasex.ring_flash_step in interpret mode.
Planted faults (the carried l in all four shares, a shift off by one) fail
those bars. On a CUDA card only (``-m gpu``; no jax): the kernel against
``ring_flash_step_plain`` at diagonal, past, future and GQA D=128 steps in
bf16, fp16 and f32 within chip_smoke.py's RING_TOL, a future shard leaving
o, m, l bit-unchanged, a three-step ring, CUDA-graph replay, and no plain
route. On the card: ``python -m pytest --noconftest -m gpu
tests/test_torch_ring_fwd.py``."""
import functools
import math

import numpy as np
import pytest
import torch

from thunder_tpu_torch.executors import cudaex

TILE = 128  # the core's query and key tiles (csrc/flash_fwd_sm90.cu: kBQ, kBK)


def _walk_faults(plan, T, q_off, k_off, causal=True) -> list:
    """What is wrong with a plan's walk at these offsets: a visible key in
    no walked tile, a walked tile past the tile's last visible key, a hidden
    key in a walked tile the plan does not mask, a live tile left out or a
    dead one walked."""
    vis = cudaex.ring_visible(T, T, q_off, k_off) if causal else torch.ones(T, T, dtype=torch.bool)
    faults, seen = [], set()
    for q0, n_kt, masked in plan.get("tiles", []):
        rows = vis[q0:min(q0 + TILE, T)]
        seen.add(q0)
        cols = rows.any(0).nonzero()
        if not len(cols):
            faults.append(f"tile {q0}: walked, no row sees a key")
            continue
        if int(cols.max()) // TILE >= n_kt:
            faults.append(f"tile {q0}: visible key {int(cols.max())} past {n_kt} key tiles")
        if (n_kt - 1) * TILE > int(cols.max()):
            faults.append(f"tile {q0}: key tile {n_kt - 1} past the last visible key")
        for n in range(n_kt):
            hidden = (~rows[:, n * TILE:(n + 1) * TILE]).any() or (n + 1) * TILE > T
            if hidden and n not in masked:
                faults.append(f"tile {q0}: key tile {n} holds a hidden key, unmasked")
    for q0 in range(0, T, TILE):
        if vis[q0:q0 + TILE].any() and q0 not in seen:
            faults.append(f"tile {q0}: live, not walked")
    return faults


def _random_offsets(seed):
    rng = np.random.RandomState(seed)
    T = int(rng.choice([64, 128, 200, 256, 384, 500]))
    q_off = int(rng.randint(0, 4)) * T
    # equal shards, as the ring's, or any shift within two shards
    k_off = int(rng.randint(0, 4)) * T if seed % 2 else q_off + int(rng.randint(-2 * T, 2 * T))
    return T, q_off, k_off


@pytest.mark.parametrize("seed", range(24))
def test_plan_walk_matches_ring_visible(seed):
    T, q_off, k_off = _random_offsets(seed)
    B, H = 2, 3
    plan = cudaex.ring_forward_plan(B, H, 3, T, 64, torch.bfloat16, q_off, k_off)
    assert _walk_faults(plan, T, q_off, k_off) == []
    future = k_off > q_off + T - 1
    assert plan["future"] == future and (plan["items"] == 0) == future
    assert plan["items"] == len(plan["tiles"]) * B * H and plan["blocks"] <= cudaex.H100_SMS
    n_kts = [n for _, n, _ in plan["tiles"]]
    assert n_kts == sorted(n_kts, reverse=True)  # heaviest first
    if k_off + T - 1 <= q_off:  # a past shard: the mask runs only at a ragged edge
        assert all(m == ((n - 1,) if T % TILE else ()) for _, n, m in plan["tiles"])


@pytest.mark.parametrize("where,q_off,k_off", [("diagonal", 512, 512), ("past", 512, 0),
                                               ("future", 0, 512)])
def test_plan_full_attention_walks_every_key(where, q_off, k_off):
    plan = cudaex.ring_forward_plan(1, 4, 4, 512, 64, torch.float16, q_off, k_off, causal=False)
    assert not plan["future"] and plan["items"] == 16 and _walk_faults(plan, 512, q_off, k_off, False) == []


def test_plan_at_cp_train_shape():
    """cp_train's diagonal step: 64 query tiles x 16 heads on 132 blocks; the
    f32 route keeps one block per 64-row tile."""
    plan = cudaex.ring_forward_plan(1, 16, 16, 8192, 64, torch.bfloat16, 0, 0)
    assert (plan["items"], plan["blocks"]) == (1024, 132)
    assert plan["tiles"][0] == (8064, 64, (63,)) and plan["tiles"][-1] == (0, 1, (0,))
    f32 = cudaex.ring_forward_plan(1, 16, 16, 8192, 64, torch.float32, 0, 0)
    assert f32 == {"future": False, "items": 2048, "blocks": 2048}
    assert cudaex.ring_forward_plan(1, 16, 16, 8192, 64, torch.float32, 0, 8192)["blocks"] == 0


@pytest.mark.parametrize("q_off,k_off,fault", [
    (0, 127, -1),  # tile 0's last row sees key 0 only; tile 1's last row key 128
    (0, 128, +1),  # tile 0 sees no key
    (126, 0, +1),  # row 0 sees keys <= 126: key tile 0 needs its mask
], ids=["drops-visible-keys", "walks-a-dead-tile", "skips-a-mask"])
def test_planted_off_by_one_shift_fails_the_walk(q_off, k_off, fault):
    assert _walk_faults(cudaex.ring_forward_plan(1, 1, 1, 256, 64, torch.bfloat16, q_off, k_off),
                        256, q_off, k_off) == []
    bad = cudaex.ring_forward_plan(1, 1, 1, 256, 64, torch.bfloat16, q_off + fault, k_off)
    assert _walk_faults(bad, 256, q_off, k_off)


# ---------------------------------------------------------------------------
# the core's ring-mode arithmetic, written out in f32
# ---------------------------------------------------------------------------


def _core_ring_f32(q, kb, vb, o, m, l, q_off, k_off, causal=True, seeded_shares=1, shift_fault=0):
    """csrc/flash_fwd_sm90.cu's core in ring mode, in f32 on the CPU: the
    items of ring_forward_plan (its offsets moved by shift_fault), each
    starting from the carried o and m and the carried l seeded into
    ``seeded_shares`` of the four per-thread shares of a row (thread c of a
    quad sums the keys 8j + 2c, 8j + 2c + 1), 128-key tiles with raw scores
    set to -1e30 only on the tiles the plan masks, the online softmax in
    log2 units, and the shares summed at the end. -> (o, m, l)."""
    B, H, T, D = q.shape
    g = H // kb.shape[1]
    plan = cudaex.ring_forward_plan(B, H, kb.shape[1], T, D, torch.bfloat16, q_off + shift_fault,
                                    k_off, causal)
    o, m, l = o.clone(), m[..., 0].clone(), l[..., 0].clone()
    if plan["future"]:
        return o, m[..., None], l[..., None]
    vis = cudaex.ring_visible(T, T, q_off + shift_fault, k_off) if causal else None
    kr, vr = kb.float().repeat_interleave(g, 1), vb.float().repeat_interleave(g, 1)
    scale2 = cudaex.LOG2E / math.sqrt(D)
    share = (torch.arange(TILE) % 8) // 2  # the quad thread that sums each key of a tile
    for q0, n_kt, masked in plan["tiles"]:
        rows = slice(q0, min(q0 + TILE, T))
        acc, mm = o[:, :, rows], m[:, :, rows]
        shares = torch.zeros(*mm.shape, 4)
        shares[..., :seeded_shares] = l[:, :, rows, None]
        for n in range(n_kt):
            keys = slice(n * TILE, min((n + 1) * TILE, T))
            s = torch.matmul(q[:, :, rows].float(), kr[:, :, keys].transpose(-1, -2))
            if n in masked and causal:
                s = torch.where(vis[rows, keys], s, cudaex.NEG_INF)
            s = s * scale2
            m_new = torch.maximum(mm, s.amax(-1))
            corr = torch.exp2(mm - m_new)
            p = torch.exp2(s - m_new[..., None])
            sums = torch.stack([p[..., share[:p.shape[-1]] == c].sum(-1) for c in range(4)], -1)
            shares = shares * corr[..., None] + sums
            acc = acc * corr[..., None] + torch.matmul(p, vr[:, :, keys])
            mm = m_new
        o[:, :, rows], m[:, :, rows], l[:, :, rows] = acc, mm, shares.sum(-1)
    return o, m[..., None], l[..., None]


def _state(rng, B, H, T, D):
    o = torch.tensor(rng.randn(B, H, T, D), dtype=torch.float32)
    m = torch.tensor(2.0 * rng.randn(B, H, T, 1), dtype=torch.float32)
    l = torch.tensor(1.0 + rng.rand(B, H, T, 1), dtype=torch.float32)
    return o, m, l


def _step_inputs(seed, B=1, H=4, Hkv=2, T=320, D=16):
    rng = np.random.RandomState(seed)
    q, kb, vb = (torch.tensor(rng.randn(B, h, T, D), dtype=torch.float32) for h in (H, Hkv, Hkv))
    return (q, kb, vb, *_state(rng, B, H, T, D))


def _close(got, want, rtol=1e-5) -> bool:
    return all(bool((g - w).abs().max() <= rtol * w.abs().max().clamp(min=1.0)) for g, w in zip(got, want))


# a ragged T of three query tiles: the diagonal, past and future shards of
# the ring, and shifts that cut a tile (only the first tiles live)
STEPS = {"diagonal": (320, 320), "past": (320, 0), "future": (0, 320), "shift-200": (0, 200),
         "shift+77": (77, 0)}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("step", list(STEPS))
def test_core_ring_mode_matches_the_plain_step(step, causal):
    q_off, k_off = STEPS[step]
    args = _step_inputs(len(step) + causal)
    want = cudaex.ring_flash_step_plain(*args, q_off, k_off, causal)
    assert _close(_core_ring_f32(*args, q_off, k_off, causal), want)


@pytest.mark.parametrize("step", ["diagonal", "past", "shift-200"])
def test_planted_faults_fail_the_core_bar(step):
    """The carried l seeded into all four shares of a row, or the shift off
    by one, no longer gives the plain step."""
    q_off, k_off = STEPS[step]
    args = _step_inputs(3)
    want = cudaex.ring_flash_step_plain(*args, q_off, k_off, True)
    assert not _close(_core_ring_f32(*args, q_off, k_off, seeded_shares=4), want)
    if step != "past":  # a past shard sees every key whatever the shift
        assert not _close(_core_ring_f32(*args, q_off, k_off, shift_fault=1), want)


@pytest.fixture(scope="module")
def pallas_step():
    import jax
    import jax.numpy as jnp

    from thunder_tpu.executors import pallasex

    @functools.partial(jax.jit, static_argnames=("causal", "scale"))
    def step(q, kb, vb, o, m, l, q_off, k_off, causal, scale):
        return pallasex.ring_flash_step(q, kb, vb, o, m, l, q_off, k_off, causal=causal, scale=scale,
                                        block_q=64, block_k=64, interpret=True)

    def run(args, q_off, k_off, causal):
        out = step(*(jnp.asarray(a.numpy()) for a in args), q_off, k_off, causal=causal,
                   scale=1.0 / math.sqrt(args[0].shape[-1]))
        return [torch.tensor(np.asarray(x)) for x in out]

    return run


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("step", ["diagonal", "past", "future"])
def test_core_ring_mode_matches_pallas(pallas_step, step, causal):
    q_off, k_off = {"diagonal": (256, 256), "past": (256, 0), "future": (0, 256)}[step]
    args = _step_inputs(5 + causal, T=256)
    want = pallas_step(args, q_off, k_off, causal)
    assert _close(_core_ring_f32(*args, q_off, k_off, causal), want)


def test_ring_of_core_steps_matches_the_plain_ring():
    """A three-rank ring for rank 1, diagonal first, from the sentinel state:
    the core's steps compose as the plain steps do."""
    rng = np.random.RandomState(9)
    T, n = 192, 3
    q = torch.tensor(rng.randn(1, 4, T, 16), dtype=torch.float32)
    k, v = (torch.tensor(rng.randn(1, 2, n * T, 16), dtype=torch.float32) for _ in range(2))
    got = want = (torch.zeros(1, 4, T, 16), torch.full((1, 4, T, 1), cudaex.NEG_INF), torch.zeros(1, 4, T, 1))
    for src in (1, 0, 2):
        kb, vb = k[:, :, src * T:(src + 1) * T], v[:, :, src * T:(src + 1) * T]
        got = _core_ring_f32(q, kb, vb, *got, T, src * T)
        want = cudaex.ring_flash_step_plain(q, kb, vb, *want, T, src * T)
    assert _close(got, want) and _close((got[0] / got[2],), (want[0] / want[2],))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# chip_smoke.py's RING_TOL on max |err| / max |ref| and ||err|| / ||ref||:
# in 16-bit types the kernel rounds p before p·v (the plain version does
# not) at other running maxima; f32 runs FMA products in another order
RING_TOL = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -6, torch.float32: 1e-4}
CARD_STEPS = {"diagonal": (1024, 1024), "past": (1024, 0), "future": (0, 1024), "shift-300": (0, 300)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(dev, dtype, B=1, H=8, Hkv=8, T=1024, D=64, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, kb, vb = (torch.randn(B, h, T, D, device=dev, generator=gen).to(dtype) for h in (H, Hkv, Hkv))
    # carried state from a diagonal step of another shard: finite m, l >= 1
    o, m, l = cudaex.ring_flash_step_plain(
        q, torch.randn(B, Hkv, T, D, device=dev, generator=gen).to(dtype),
        torch.randn(B, Hkv, T, D, device=dev, generator=gen).to(dtype),
        torch.zeros(B, H, T, D, device=dev), torch.full((B, H, T, 1), cudaex.NEG_INF, device=dev),
        torch.zeros(B, H, T, 1, device=dev), 0, 0, True)
    return q, kb, vb, o.contiguous(), m.contiguous(), l.contiguous()


def _rel(got, want) -> float:
    d = (got.float() - want.float())
    return max((d.abs().max() / want.abs().max()).item(), (d.norm() / want.norm()).item())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["mha-d64", "gqa-d128"])
@pytest.mark.parametrize("step", list(CARD_STEPS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=["bf16", "f16", "f32"])
def test_kernel_matches_plain(cuda, dtype, step, shape):
    kw = dict(H=16, Hkv=4, D=128) if shape == "gqa-d128" else {}
    q_off, k_off = CARD_STEPS[step]
    q, kb, vb, o, m, l = _card_inputs(cuda, dtype, seed=len(step), **kw)
    want = cudaex.ring_flash_step_plain(q, kb, vb, o.clone(), m.clone(), l.clone(), q_off, k_off)
    before = (o.clone(), m.clone(), l.clone())
    n0 = cudaex.ring_flash_step.launches
    got = cudaex.ring_flash_step(q, kb, vb, o, m, l, q_off, k_off)
    torch.cuda.synchronize()
    assert cudaex.ring_flash_step.launches == n0 + 1 and all(g is t for g, t in zip(got, (o, m, l)))
    if step == "future":
        assert all(torch.equal(a, b) for a, b in zip(got, before))
        return
    errs = {"o/l": _rel(o / l, want[0] / want[2]), "m": _rel(m, want[1]), "l": _rel(l, want[2])}
    assert max(errs.values()) <= RING_TOL[dtype], errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_three_step_ring_matches_the_plain_ring(cuda, dtype):
    T, n = 1024, 3
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(1, 8, T, 64, device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn(1, 2, n * T, 64, device=cuda, generator=gen).to(dtype) for _ in range(2))
    init = lambda: (torch.zeros(1, 8, T, 64, device=cuda),  # noqa: E731
                    torch.full((1, 8, T, 1), cudaex.NEG_INF, device=cuda), torch.zeros(1, 8, T, 1, device=cuda))
    got, want = init(), init()
    for src in (1, 0, 2):
        kb, vb = k[:, :, src * T:(src + 1) * T].contiguous(), v[:, :, src * T:(src + 1) * T].contiguous()
        got = cudaex.ring_flash_step(q, kb, vb, *got, T, src * T)
        want = cudaex.ring_flash_step_plain(q, kb, vb, *want, T, src * T)
    torch.cuda.synchronize()
    assert _rel(got[0] / got[2], want[0] / want[2]) <= RING_TOL[dtype]
    assert _rel(got[1], want[1]) <= RING_TOL[dtype] and _rel(got[2], want[2]) <= RING_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_in_a_cuda_graph_equals_eager(cuda, dtype):
    """Captured once, replayed on new contents of the same tensors: the
    launch reads nothing on the host but the offsets it was given."""
    q, kb, vb, o, m, l = _card_inputs(cuda, dtype, seed=7)
    state = (o.clone(), m.clone(), l.clone())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cudaex.ring_flash_step(q, kb, vb, o, m, l, 1024, 1024)  # build and warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cudaex.ring_flash_step(q, kb, vb, o, m, l, 1024, 1024)
    new = _card_inputs(cuda, dtype, seed=8)
    for a, b in zip((q, kb, vb, *state), new):
        a.copy_(b)
    for a, b in zip((o, m, l), state):
        a.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    replayed = (o.clone(), m.clone(), l.clone())
    eager = cudaex.ring_flash_step(q, kb, vb, *(t.clone() for t in state), 1024, 1024)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(replayed, eager))


@pytest.mark.gpu
def test_kernel_never_takes_the_plain_route(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a plain version ran for CUDA tensors")

    monkeypatch.setattr(cudaex, "ring_flash_step_plain", refuse)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, kb, vb = (torch.randn(1, 4, 256, 64, device=cuda, generator=gen).to(torch.bfloat16) for _ in range(3))
    o, m, l = torch.zeros(1, 4, 256, 64, device=cuda), torch.zeros(1, 4, 256, 1, device=cuda), \
        torch.ones(1, 4, 256, 1, device=cuda)
    n0 = cudaex.ring_flash_step.launches
    cudaex.ring_flash_step(q, kb, vb, o, m, l, 256, 0)
    torch.cuda.synchronize()
    assert cudaex.ring_flash_step.launches == n0 + 1 and o.isfinite().all() and (l > 1).all()
    with pytest.raises(ValueError, match="unsupported"):
        bad = torch.zeros(1, 4, 256, 136, device=cuda, dtype=torch.bfloat16)
        cudaex.ring_flash_step(bad, bad, bad, torch.zeros(1, 4, 256, 136, device=cuda), m, l, 0, 0)
