"""The weight-only int8 and NF4 linears' bf16 routes (csrc/weight_only_linear.cuh),
on the CPU: cudaex.weight_only_plan, and a torch emulation of each route's
arithmetic held against the plain versions and pallasex's kernels.

The emulation follows the kernels' fragments. For every lane position of a
route (stream: 128-byte stage units, their 64-byte halves, lane c's 16
bytes, mma steps q; wgmma: 64-byte units, k16 slices j, lane c) it takes the
weight side from the stored bytes as the kernel reads them (int8: a word's
bytes (0, 2) and (1, 3) as i8pair takes them, or bytes 2c, 2c+1 as the PRMT
brings them; NF4: a byte's (high, low) nibbles through the 256-entry pair
table, each times the absmax of the 64-group the kernel loads for it) and the
x side from the kernel's x addressing (the chunk of k_of(unit) and the PRMT
pairs of x). If the two disagree on a k, the sums are wrong. The K splits'
f32 sums are added in split order and the int8 scale is applied after the
sum, once, as the kernels do.

Bars: the decoded weights are bit-equal to the plain versions' (int8 widened;
NF4 round_bf16(code · absmax)); y (f32, before rounding) within 1e-6 ·
max(1, |y|) of the plain version's f32 product (both sum f32 products in
another order); bf16 y within one bf16 ulp (+1e-6) of pallasex's kernels in
interpret mode, the bar of tests/test_torch_quant.py. Each planted fault
(the pair table's hi and lo swapped, the neighbouring group's absmax, the
scale applied to each split before the sum and rounded to bf16, a split
summed twice, the k + block_k/2 half dropped) fails the 1e-6 bar.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.executors import pallasex
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.transforms import quantization as tq

SMS = cudaex.H100_SMS
# Llama-3-1B's decode linears (N, K), chip_smoke.py's QUANT_SHAPES
LLAMA = {"attn": (3072, 2048), "attn_proj": (2048, 2048), "fc_1": (8192, 2048), "fc_2": (8192, 2048),
         "mlp_proj": (2048, 8192), "lm_head": (128256, 2048)}
CODE = tq.NF4_CODE.float()


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _bf16_ulp(ref):
    mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _int8_inputs(seed, M, N, K):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.randint(-128, 128, (N, K)).astype(np.int8))
    s = torch.from_numpy((np.abs(rng.randn(N)) * 5e-4 + 1e-4).astype(np.float32))
    return x, q, s


def _nf4_inputs(seed, M, N, K):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(N, K).astype(np.float32) * 0.02)
    pk, ak = tq.pack_nf4_kernel_layout(*tq.quantize_nf4(w), (N, K))
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(torch.bfloat16)
    return x, pk, ak


# ---------------------------------------------------------------------------
# the emulation: slots (weight byte, nibble, x k, split) of each route
# ---------------------------------------------------------------------------


def _k_of(kind, b, hb):
    """csrc/weight_only_linear.cuh Fmt::k_of: the k of byte b's (high
    nibble's) weight; the low nibble's is + hb."""
    return b if kind == "int8" else (b // hb) * 2 * hb + b % hb


def _stream_slots(kind, K, hb, ups):
    """The stream route's pairs: (byte of the row, nibble (0 high / 1 low;
    int8 0), k of x it multiplies, unit of 128 bytes) for every fragment
    element, as stream_kernel reads them: stage unit t, half h, lane c's 16
    bytes at 64h + 16c, mma steps q."""
    row_bytes = K if kind == "int8" else K // 2
    out = []
    for t in range(row_bytes // 128):
        k0 = _k_of(kind, (t // ups) * ups * 128, hb)  # the block's x chunk 0
        for h in range(2):
            kh = _k_of(kind, 128 * t + 64 * h, hb)
            ch = (kh - k0) // 64  # the half's 64-k chunk of the block's x
            for c in range(4):
                base = 128 * t + 64 * h + 16 * c  # lane c's 16 bytes
                # xh words: chunks 2c and 2c + 1 of the chunk's 128-byte token row, 2 k a word
                xk = [k0 + 64 * ch + 16 * c + 2 * wd for wd in range(8)]  # first k of xh[wd]
                if kind == "int8":
                    for q in range(4):
                        word = [base + 4 * q + i for i in range(4)]
                        even, odd = (word[0], word[2]), (word[1], word[3])  # i8pair(w), i8pair(w >> 8)
                        # b[0] = prmt(xh[2q], xh[2q+1], 0x5410): low halves; b[1]: high halves
                        b0 = (xk[2 * q], xk[2 * q + 1])
                        b1 = (xk[2 * q] + 1, xk[2 * q + 1] + 1)
                        for e in range(2):
                            out.append((even[e], 0, b0[e], t))
                            out.append((odd[e], 0, b1[e], t))
                else:
                    for q in range(8):
                        for e, byte in enumerate((base + 2 * q, base + 2 * q + 1)):  # a[0]: byte 2q; a[2]: 2q + 1
                            # b = prmt(xh[q], xl[q], 0x5410 / 0x7632): (x[kh-chunk], x[+ hb]) of element e
                            out.append((byte, 0, xk[q] + e, t))
                            out.append((byte, 1, xk[q] + e + hb, t))
    return out


def _wgmma_slots(kind, K, hb):
    """The wgmma route's pairs, as wgmma_kernel reads them: unit u (64
    bytes), k16 slice j, lane c's bytes 2c, 2c + 1 and 2c + 8, 2c + 9 of the
    slice (the PRMT's selector), x's tile at k_of(unit) (NF4: and + hb) in
    natural order (wgmma's B)."""
    row_bytes = K if kind == "int8" else K // 2
    out = []
    for u in range(row_bytes // 64):
        kh = _k_of(kind, 64 * u, hb)
        for j in range(4):
            for c in range(4):
                for off in (0, 8):  # a[0] / a[2]: logical k 2c (+ 8)
                    for e in range(2):
                        byte = 64 * u + 16 * j + 2 * c + off + e
                        if kind == "int8":
                            out.append((byte, 0, kh + 16 * j + 2 * c + off + e, u))
                        else:
                            out.append((byte, 0, kh + 16 * j + 2 * c + off + e, u))
                            out.append((byte, 1, kh + hb + 16 * j + 2 * c + off + e, u))
    return out


def _decode(kind, stored, aux, slots, K, hb, fault=None):
    """(N, slots) f32 weights the kernels feed the products: int8 widened
    exactly (the base - sub bit trick), NF4 round_bf16(pair-table code ·
    absmax of the group of the unit's half, as the kernels load it)."""
    byte = torch.tensor([s[0] for s in slots])
    nib = torch.tensor([s[1] for s in slots])
    if kind == "int8":
        b = stored.view(torch.uint8)[:, byte].to(torch.int32)
        base = 128 + (b & 127)  # bf16 (w & 0x007F007F) | 0x43004300
        sub = torch.where((b & 128) != 0, 256, 128)  # bf16 (w & 0x00800080) | 0x43004300
        return (base - sub).float()
    b = stored[:, byte].to(torch.int64)
    table = torch.stack([CODE[torch.arange(256) >> 4], CODE[torch.arange(256) & 15]], dim=1)  # (256, 2)
    if fault == "table_swapped":
        table = table.flip(1)
    code = table[b, nib]
    # the group the kernel loads: k_of(unit's half start) / 64, + hb / 64 for the low nibble
    half_start = (byte // 64) * 64
    g = torch.tensor([_k_of(kind, int(hs), hb) // 64 for hs in half_start]) + nib * (hb // 64)
    if fault == "neighbour_group":
        g = torch.where(g + 1 < aux.shape[1], g + 1, g - 1)
    w = _bf16(code * aux[:, g])
    if fault == "low_half_dropped":
        w = torch.where(nib == 1, torch.zeros_like(w), w)
    return w


def emulate(kind, route, x, stored, aux, plan, fault=None):
    """(y f32 before rounding, y in x's dtype, the decoded weights placed at
    the k of x each multiplies (N, K)) on the route the plan names."""
    K = x.shape[-1]
    hb = (tq.nf4_kernel_block_k(K) or 0) // 2
    slots = _stream_slots(kind, K, hb, plan["units_per_split"]) if route == "stream" else _wgmma_slots(kind, K, hb)
    w = _decode(kind, stored, aux, slots, K, hb, fault)
    kx = torch.tensor([s[2] for s in slots])
    unit = torch.tensor([s[3] for s in slots])
    split = unit // plan["units_per_split"]
    xs = x.float().double()[:, kx]  # (M, slots)
    partials = []
    for sp in range(plan["splits"]):
        on = split == sp
        partials.append((xs[:, on] @ w[:, on].double().t()).float())  # a split's f32 sums
    if fault == "split_twice":
        partials.append(partials[0])
    if kind == "int8" and fault == "scale_each_split":
        y = torch.zeros_like(partials[0])
        for p in partials:
            y = y + _bf16(p * aux)
    else:
        y = torch.zeros_like(partials[0])
        for p in partials:  # in split order
            y = y + p
        if kind == "int8":
            y = y * aux  # the scale after the sum, once
    placed = torch.zeros(stored.shape[0], K)
    placed[:, kx] = w
    return y, y.to(x.dtype), placed


def _plain_f32(kind, x, stored, aux):
    """The plain versions' f32 sum (before the one rounding) and their
    decoded weights."""
    if kind == "int8":
        w = stored.float()
        return torch.matmul(x.float(), w.t()) * aux, w
    N, K = stored.shape[0], x.shape[-1]
    w = _bf16(tq.dequantize_nf4_kl(stored, aux, (N, K)))
    return torch.matmul(x.float(), w.t()), w


def _inputs(kind, seed, M, N, K):
    return _int8_inputs(seed, M, N, K) if kind == "int8" else _nf4_inputs(seed, M, N, K)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int8", "nf4"])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 40, 256, 512])
def test_plan_routes_by_dtype_and_rows(kind, M):
    N, K = LLAMA["fc_1"]
    assert cudaex.weight_only_plan(kind, M, N, K, torch.float32)["route"] == "f32"
    plan = cudaex.weight_only_plan(kind, M, N, K, torch.bfloat16)
    assert plan["route"] == ("stream" if M <= 16 else "wgmma")
    assert plan["tile_m"] == ((8 if M <= 8 else 16) if M <= 16 else (64 if M <= 64 else 128))
    # a ragged int8 K (not whole 128-k chunks) takes the wgmma route at any M
    assert cudaex.weight_only_plan("int8", M, 200, 2064, torch.bfloat16)["route"] == "wgmma"


@pytest.mark.parametrize("kind", ["int8", "nf4"])
@pytest.mark.parametrize("shape", list(LLAMA))
@pytest.mark.parametrize("M", [4, 8])
def test_plan_fills_the_card_at_llama_decode_shapes(kind, shape, M):
    """Every Llama-3-1B decode shape: 16-row blocks (every SM one or more,
    where the layer's 16-row tiles allow) in one wave of resident blocks,
    or 64-row blocks where those give every SM two or the 16-row grid
    would not be one wave; K split only where x for a block would pass
    2,048 k (at K = 8192)."""
    N, K = LLAMA[shape]
    plan = cudaex.weight_only_plan(kind, M, N, K, torch.bfloat16)
    assert plan["route"] == "stream" and plan["rows"] in (16, 64)
    assert (plan["splits"] > 1) == (K > cudaex._STREAM_X_K)
    ups, tile_m = plan["units_per_split"], plan["tile_m"]
    if plan["rows"] == 16:
        assert plan["blocks"] >= min(SMS, -(-N // 16) * plan["splits"])
        assert plan["blocks"] <= cudaex._stream_per_sm(kind, 16, tile_m, plan["stages"], ups) * SMS
    else:
        assert (-(-N // 64) * plan["splits"] >= 2 * SMS
                or -(-N // 16) * plan["splits"] > cudaex._stream_per_sm(kind, 16, tile_m, 2, ups) * SMS)
    assert plan["splits"] * plan["units_per_split"] * 128 >= (K if kind == "int8" else K // 2)
    assert (plan["scratch"] != {}) == (plan["splits"] > 1)


@pytest.mark.parametrize("M", [40, 256, 512])
@pytest.mark.parametrize("shape", list(LLAMA))
def test_plan_splits_prefill_only_below_a_wave(M, shape):
    N, K = LLAMA[shape]
    plan = cudaex.weight_only_plan("int8", M, N, K, torch.bfloat16)
    tiles = -(-M // plan["tile_m"]) * -(-N // 128)
    assert plan["blocks"] == tiles * plan["splits"] and plan["grid"] == (min(plan["blocks"], SMS),)
    assert plan["splits"] == 1 or tiles * plan["splits"] <= SMS
    assert plan["counters"] == (tiles if plan["splits"] > 1 else 0)


def test_plan_reads_only_shapes():
    """The plan is a function of ints and a dtype: the same shapes give the
    same plan, and no tensor is read (the launch is safe under CUDA-graph
    capture)."""
    for kind in ("int8", "nf4"):
        for M in (1, 8, 40, 512):
            for N, K in LLAMA.values():
                a = cudaex.weight_only_plan(kind, M, N, K, torch.bfloat16)
                b = cudaex.weight_only_plan(kind, int(M), int(N), int(K), torch.bfloat16)
                assert a == b
    orig = torch.Tensor.item
    try:
        torch.Tensor.item = lambda self: (_ for _ in ()).throw(AssertionError("the plan read a tensor"))
        cudaex.weight_only_plan("nf4", 4, 8192, 2048, torch.bfloat16)
    finally:
        torch.Tensor.item = orig


# ---------------------------------------------------------------------------
# the emulation against the plain versions and pallasex
# ---------------------------------------------------------------------------

# (M, N, K): stream without and with a K split (K > 2,048), wgmma with (a few
# tiles) and without (30 tiles)
EMU_CASES = [(1, 96, 512), (8, 96, 768), (16, 80, 1024), (4, 64, 4096), (17, 96, 512), (40, 96, 768),
             (40, 96, 1024), (130, 136, 512), (300, 1280, 256)]


@pytest.mark.parametrize("kind", ["int8", "nf4"])
@pytest.mark.parametrize("M,N,K", EMU_CASES)
def test_emulation_matches_plain(kind, M, N, K):
    x, stored, aux = _inputs(kind, M + K, M, N, K)
    plan = cudaex.weight_only_plan(kind, M, N, K, torch.bfloat16)
    y, _, placed = emulate(kind, plan["route"], x, stored, aux, plan)
    ref, w = _plain_f32(kind, x, stored, aux)
    assert torch.equal(placed, w), "decoded weights differ from the plain version's"
    err = (y - ref).abs() / ref.abs().clamp(min=1.0)
    assert err.max().item() <= 1e-6, err.max().item()


def test_emulation_cases_cover_every_route_and_split():
    seen = set()
    for kind in ("int8", "nf4"):
        for M, N, K in EMU_CASES:
            plan = cudaex.weight_only_plan(kind, M, N, K, torch.bfloat16)
            seen.add((kind, plan["route"], plan["splits"] > 1))
    assert seen == {(k, r, s) for k in ("int8", "nf4") for r in ("stream", "wgmma") for s in (False, True)}


@pytest.mark.parametrize("kind", ["int8", "nf4"])
@pytest.mark.parametrize("M,N,K", [(8, 128, 512), (40, 128, 1024)], ids=["stream", "wgmma"])
def test_emulation_matches_pallas(kind, M, N, K):
    x, stored, aux = _inputs(kind, 3 * M + K, M, N, K)
    plan = cudaex.weight_only_plan(kind, M, N, K, torch.bfloat16)
    _, got, _ = emulate(kind, plan["route"], x, stored, aux, plan)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    if kind == "int8":
        ref = pallasex.int8_linear(xj, jnp.asarray(stored.numpy()), jnp.asarray(aux.numpy()))
    else:
        ref = pallasex.nf4_linear(xj, jnp.asarray(stored.numpy()), jnp.asarray(aux.numpy()))
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    bound = _bf16_ulp(np.maximum(np.abs(ref), np.abs(got))) + 1e-6
    assert (np.abs(got - ref) <= bound).all()


# (fault, kind, M, N, K): each must fail the 1e-6 bar against the plain version
FAULTS = [("table_swapped", "nf4", 8, 96, 512), ("neighbour_group", "nf4", 8, 96, 1024),
          ("low_half_dropped", "nf4", 40, 96, 512), ("scale_each_split", "int8", 4, 64, 4096),
          ("scale_each_split", "int8", 40, 96, 768), ("split_twice", "int8", 4, 64, 4096),
          ("split_twice", "nf4", 40, 96, 1024)]


@pytest.mark.parametrize("fault,kind,M,N,K", FAULTS)
def test_planted_faults_fail(fault, kind, M, N, K):
    x, stored, aux = _inputs(kind, 11 * M + K, M, N, K)
    plan = cudaex.weight_only_plan(kind, M, N, K, torch.bfloat16)
    if fault in ("scale_each_split", "split_twice"):
        assert plan["splits"] > 1
    y, _, _ = emulate(kind, plan["route"], x, stored, aux, plan, fault=fault)
    ref, _ = _plain_f32(kind, x, stored, aux)
    err = (y - ref).abs() / ref.abs().clamp(min=1.0)
    assert err.max().item() > 1e-6
