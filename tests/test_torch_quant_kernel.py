"""The weight-only int8 and NF4 linears' routes (csrc/weight_only_linear.cuh),
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

The split route (f32 x: int8 at every M, NF4 above M = 16; NF4 at M <= 16
keeps the FMA kernel, route fma) is the wgmma route's kernel over x's three
bf16 pieces; its emulation (emulate_split) takes the wgmma route's slots, splits
x and, for NF4, the f32 weight code · absmax into three bf16 pieces each as
the kernels do (round to bf16, subtract in f32, twice more), and sums the
products the kernel issues (int8: x0, x1, x2 against the code; NF4: x_i ·
w_j, i + j <= 2) exactly, rounded to f32 once a K split: the split
arithmetic, with the tensor cores' f32 summation order (the route's only
freedom) left to the card's tests. Held: the pieces sum to x bit for bit
(but the sign of zero) from 2^-100 to 2^100 and wherever x's lowest bit is
at least 2^-133, bf16's least subnormal (every |x| >= 2^-110; below it the
lost bits are < 2^-133 absolute); the pass products are exact; NF4's
weight pieces sum to the plain version's f32 weight; NF4's three dropped
products, each at most 2^-24 |x_k w_k| (|x1| <= 2^-8 |x|, |x2| <= 2^-16
|x|), move y by at most 2^-23 Σ|x_k w_k|. y is held to the exact (f64)
product of x and the f32 weights within 1e-6 · max(1, |y|): one f32
rounding a split, the splits' adds and the dropped products, ~u·|y| (u =
2^-24) for random signs, more where the splits' partial sums are larger
than y; measured at most 6.6e-7 on these data (int8, 8 K splits). The plain
versions' f32 sums and pallasex's kernels (interpret mode) stray from that
product by up to the f32 summation bound γ_K·Σ|x_k w_k| (γ_K = K·u / (1 -
K·u); held), so the emulation is held to each within 1e-6 · max(1, |y|)
plus that bound. Each planted fault (x2 dropped, NF4's (1,1) or (0,2)
product dropped, the int8 scale applied to each pass and rounded to bf16,
a K split summed twice) moves y by 3.9e-6 of max(1, |y|) or more and fails
the 1e-6 bar.
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


def _int8_inputs(seed, M, N, K, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.randint(-128, 128, (N, K)).astype(np.int8))
    s = torch.from_numpy((np.abs(rng.randn(N)) * 5e-4 + 1e-4).astype(np.float32))
    return x, q, s


def _nf4_inputs(seed, M, N, K, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(N, K).astype(np.float32) * 0.02)
    pk, ak = tq.pack_nf4_kernel_layout(*tq.quantize_nf4(w), (N, K))
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dtype)
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


def _decode(kind, stored, aux, slots, K, hb, fault=None, round_w=True):
    """(N, slots) f32 weights the kernels feed the products: int8 widened
    exactly (the base - sub bit trick), NF4 round_bf16(pair-table code ·
    absmax of the group of the unit's half, as the kernels load it); with
    round_w False (the split route) NF4's f32 code · absmax unrounded."""
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
    w = code * aux[:, g]
    if round_w:
        w = _bf16(w)
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


def _pieces(v):
    """v (f32) as its three bf16 pieces (f32 tensors), as the kernels split
    it: round to bf16, subtract in f32 (exact), twice more."""
    out = []
    for _ in range(3):
        out.append(_bf16(v))
        v = v - out[-1]
    return out


# The products the split route issues (x piece, w piece): int8 x0, x1, x2
# against the code; NF4 x_i · w_j with i + j <= 2
SPLIT_PAIRS = {"int8": ((0, 0), (1, 0), (2, 0)), "nf4": ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))}


def emulate_split(kind, x, stored, aux, plan, fault=None, pairs=None):
    """y (f32) on the split route (f32 x): the wgmma route's slots, x split
    into three bf16 pieces and NF4's f32 weight code · absmax into three,
    the route's products of pieces summed exactly within a K split and
    rounded to f32 once, the splits added in split order, the int8 scale
    once after the sum. Faults: ``x2_dropped``, ``nf4_11_dropped``,
    ``nf4_02_dropped``, ``scale_each_pass`` (int8: each pass's sum scaled
    and rounded to bf16), ``split_twice``."""
    K = x.shape[-1]
    hb = (tq.nf4_kernel_block_k(K) or 0) // 2
    slots = _wgmma_slots(kind, K, hb)
    w = _decode(kind, stored, aux, slots, K, hb, round_w=False)
    kx = torch.tensor([sl[2] for sl in slots])
    split = torch.tensor([sl[3] for sl in slots]) // plan["units_per_split"]
    xp = _pieces(x.float()[:, kx])
    wp = _pieces(w) if kind == "nf4" else [w]
    if fault == "x2_dropped":
        xp[2] = torch.zeros_like(xp[2])
    pairs = [pq for pq in (pairs or SPLIT_PAIRS[kind])
             if not (fault == "nf4_11_dropped" and pq == (1, 1)) and not (fault == "nf4_02_dropped" and pq == (0, 2))]
    partials = []
    for sp in range(plan["splits"]):
        on = split == sp
        terms = [(xp[i][:, on].double() @ wp[j][:, on].double().t()) for i, j in pairs]
        if kind == "int8" and fault == "scale_each_pass":
            partials.append(sum(_bf16((t.float() * aux)) for t in terms))
        else:
            partials.append(sum(terms).float())  # a split's f32 sums
    if fault == "split_twice":
        partials.append(partials[0])
    y = torch.zeros_like(partials[0])
    for part in partials:  # in split order
        y = y + part
    if kind == "int8" and fault != "scale_each_pass":
        y = y * aux  # the scale after the sum, once
    return y


def _plain_f32(kind, x, stored, aux):
    """The plain versions' f32 sum (before the one rounding) and their
    decoded weights (NF4: rounded to x's dtype, as nf4_linear_plain)."""
    if kind == "int8":
        w = stored.float()
        return torch.matmul(x.float(), w.t()) * aux, w
    N, K = stored.shape[0], x.shape[-1]
    w = tq.dequantize_nf4_kl(stored, aux, (N, K)).to(x.dtype).float()
    return torch.matmul(x.float(), w.t()), w


def _inputs(kind, seed, M, N, K, dtype=torch.bfloat16):
    return _int8_inputs(seed, M, N, K, dtype) if kind == "int8" else _nf4_inputs(seed, M, N, K, dtype)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int8", "nf4"])
@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 40, 256, 512])
def test_plan_routes_by_dtype_and_rows(kind, M):
    N, K = LLAMA["fc_1"]
    f32 = cudaex.weight_only_plan(kind, M, N, K, torch.float32)
    if kind == "nf4" and M <= 16:  # the FMA kernel: the split route is slower there
        assert f32["route"] == "fma" and f32["scratch"] == {} and f32["grid"] == (N // 16, 1)
    else:
        assert f32["route"] == "split" and f32["rows"] == 128
        assert f32["tile_m"] == (16 if M <= 16 else 64 if M <= 64 or kind == "nf4" else 128)
        assert f32["scratch"]["pieces"] == ((3, M, K), torch.bfloat16)
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


@pytest.mark.parametrize("kind", ["int8", "nf4"])
@pytest.mark.parametrize("shape", ["fc_1", "mlp_proj", "attn"])
@pytest.mark.parametrize("M", [8, 17, 256, 512])
def test_plan_split_tiles_and_k_splits(kind, shape, M):
    """The split route (f32 x; NF4 above M = 16) takes the wgmma route's
    tiles and K-split rule: 128 weight rows by 16 tokens (int8 at M <= 16),
    64 (NF4, and int8 at M <= 64) or 128,
    K split while the tiles leave SMs idle, never below 4 units a split;
    x's pieces and (with splits) the partial sums as scratch."""
    N, K = LLAMA[shape]
    plan = cudaex.weight_only_plan(kind, M, N, K, torch.float32)
    if kind == "nf4" and M <= 16:
        assert plan["route"] == "fma"
        return
    tile_m = 16 if M <= 16 else 64 if M <= 64 or kind == "nf4" else 128
    tiles = -(-M // tile_m) * -(-N // 128)
    units = -(-(K if kind == "int8" else K // 2) // 64)
    assert plan["route"] == "split" and plan["code"] == cudaex._WOL_ROUTES["split"] and plan["tile_m"] == tile_m
    assert plan["blocks"] == tiles * plan["splits"] and plan["grid"] == (min(plan["blocks"], SMS),)
    assert plan["splits"] * plan["units_per_split"] >= units > (plan["splits"] - 1) * plan["units_per_split"]
    assert plan["splits"] == 1 or (tiles * plan["splits"] <= SMS and plan["units_per_split"] >= 4)
    assert plan["stages"] == cudaex._WGMMA_STAGES[("split", kind, tile_m)]
    assert plan["counters"] == (tiles if plan["splits"] > 1 else 0)
    want = {"pieces": ((3, M, K), torch.bfloat16)}
    if plan["splits"] > 1:
        want["partial"] = ((plan["splits"], M, N), torch.float32)
    assert plan["scratch"] == want
    # quant_train's shapes: int8 fc_1 in 256 tiles, NF4 mlp_proj in 128, neither split
    if M == 512 and (kind, shape) in (("int8", "fc_1"), ("nf4", "mlp_proj")):
        assert plan["splits"] == 1 and tiles == {"fc_1": 256, "mlp_proj": 128}[shape]


def test_plan_reads_only_shapes():
    """The plan is a function of ints and a dtype: the same shapes give the
    same plan, and no tensor is read (the launch is safe under CUDA-graph
    capture)."""
    for kind in ("int8", "nf4"):
        for M in (1, 8, 40, 512):
            for N, K in LLAMA.values():
                for dt in (torch.bfloat16, torch.float32):
                    a = cudaex.weight_only_plan(kind, M, N, K, dt)
                    b = cudaex.weight_only_plan(kind, int(M), int(N), int(K), dt)
                    assert a == b
    orig = torch.Tensor.item
    try:
        torch.Tensor.item = lambda self: (_ for _ in ()).throw(AssertionError("the plan read a tensor"))
        cudaex.weight_only_plan("nf4", 4, 8192, 2048, torch.bfloat16)
        cudaex.weight_only_plan("int8", 512, 8192, 2048, torch.float32)
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


# ---------------------------------------------------------------------------
# the split route (f32 x)
# ---------------------------------------------------------------------------


def _wide_f32(seed, n, lo=-100, hi=100):
    """f32 values with random 24-bit significands and signs at exponents
    from lo to hi, beside values exact in bf16 and zeros."""
    rng = np.random.RandomState(seed)
    sig = 1.0 + rng.randint(0, 2 ** 23, n) / 2.0 ** 23
    v = (sig * np.exp2(rng.randint(lo, hi + 1, n)) * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    exact = (np.round(rng.randn(n) * 64) / 64).astype(np.float32)  # |v| < 2^9 in steps of 2^-6: 8 bits or fewer
    exact = exact[np.abs(exact) < 4]
    return torch.from_numpy(np.concatenate([v, exact, np.zeros(4, np.float32)]))


def test_split_pieces_sum_to_x_bit_for_bit():
    """Bit for bit but for the sign of zero: -0 splits into -0, +0, +0."""
    x = _wide_f32(0, 20000)
    x0, x1, x2 = _pieces(x)
    back = (x0 + x1) + x2
    nz = x != 0
    assert torch.equal(back[nz].view(torch.int32), x[nz].view(torch.int32)) and not back[~nz].any()
    assert torch.equal(x0.double() + x1.double() + x2.double(), x.double())
    assert (x1.abs() <= x.abs() * 2.0 ** -8).all() and (x2.abs() <= x.abs() * 2.0 ** -16).all()
    small = x[nz & (x.abs() < 4) & (x.abs() > 2.0 ** -6)]
    exact_bf16 = small[_bf16(small) == small]
    assert exact_bf16.numel() > 1000
    assert torch.equal(_pieces(exact_bf16)[0], exact_bf16) and not _pieces(exact_bf16)[1].any()
    # exact wherever the lowest significand bit is >= 2^-133 (bf16's least
    # subnormal): every |x| >= 2^-110 ...
    low = _wide_f32(1, 5000, -110, -100)
    assert torch.equal(sum(_pieces(low)), low)
    # ... and below, the bits under 2^-133 are lost (< 2^-133 absolute)
    tiny = torch.tensor([2.0 ** -120 * (1 + 2.0 ** -23)], dtype=torch.float32)
    lost = (sum(_pieces(tiny)) - tiny).abs().item()
    assert 0 < lost < 2.0 ** -133


@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_split_products_are_exact(kind):
    """A product of two pieces (int8: a piece and a code) has at most 16
    significant bits: the f32 product equals the exact one."""
    x = _wide_f32(2, 4000, -60, 60)[:4000]  # products of pieces stay normal f32
    rng = np.random.RandomState(3)
    if kind == "int8":
        ws = [torch.from_numpy(rng.randint(-128, 128, 4000).astype(np.float32))]
    else:
        code = CODE[torch.from_numpy(rng.randint(0, 16, 4000))]
        ws = _pieces(code * torch.from_numpy(np.abs(rng.randn(4000)).astype(np.float32) * 0.05 + 1e-3))
    for xi in _pieces(x):
        for wj in ws:
            assert torch.equal((xi * wj).double(), xi.double() * wj.double())


@pytest.mark.parametrize("M,N,K", [(24, 96, 512), (300, 256, 1024)])
def test_split_nf4_weight_pieces_sum_to_the_plain_weight(M, N, K):
    """NF4's f32 weight code · absmax, decoded as the kernel loads it, split
    into three bf16 pieces that sum back to the plain version's f32 weight
    bit for bit."""
    _, pk, ak = _nf4_inputs(M + K, M, N, K, torch.float32)
    hb = tq.nf4_kernel_block_k(K) // 2
    slots = _wgmma_slots("nf4", K, hb)
    w = _decode("nf4", pk, ak, slots, K, hb, round_w=False)
    placed = torch.zeros(N, K)
    placed[:, torch.tensor([sl[2] for sl in slots])] = (lambda p: (p[0] + p[1]) + p[2])(_pieces(w))
    assert torch.equal(placed, tq.dequantize_nf4_kl(pk, ak, (N, K)))


# (kind, M, N, K) at f32 x on the split route: K split (a few tiles) and not
# (30-50 tiles), int8's 16-token tiles (M <= 16)
SPLIT_CASES = [(kind, M, N, K) for kind in ("int8", "nf4")
               for M, N, K in [(1, 96, 768), (8, 96, 512), (17, 96, 512), (40, 96, 1024), (130, 136, 512),
                               (300, 1280, 256), (20, 256, 2048)] if kind == "int8" or M > 16]
# The emulation against the exact product (f64): one f32 rounding a K split,
# the splits' f32 adds and NF4's dropped products (~u·|y| for random signs).
SPLIT_TOL = 1e-6
F32_U = 2.0 ** -24


def _exact(kind, x, stored, aux):
    """(y in f64 from the f32 weights, Σ|x_k w_k| (times the int8 scale))."""
    if kind == "int8":
        w = stored.double()
        return (x.double() @ w.t()) * aux.double(), (x.double().abs() @ w.abs().t()) * aux.double()
    w = tq.dequantize_nf4_kl(stored, aux, (stored.shape[0], x.shape[-1])).double()
    return x.double() @ w.t(), x.double().abs() @ w.abs().t()


def _f32_sum_bound(K, mag):
    """An f32 sum of K products (each rounded, then K - 1 adds) strays from
    the exact one by at most γ_K · Σ|x_k w_k|, γ_K = K·u / (1 - K·u)."""
    return K * F32_U / (1 - K * F32_U) * mag


def _split_err(kind, M, N, K, seed, fault=None):
    """(max |emulation - exact| / max(1, |exact|), max |emulation - plain| /
    (SPLIT_TOL·max(1, |exact|) + the plain f32 sum's bound), plan)."""
    x, stored, aux = _inputs(kind, seed, M, N, K, torch.float32)
    plan = cudaex.weight_only_plan(kind, M, N, K, torch.float32)
    y = emulate_split(kind, x, stored, aux, plan, fault).double()
    exact, mag = _exact(kind, x, stored, aux)
    ref = _plain_f32(kind, x, stored, aux)[0].double()
    scale = exact.abs().clamp(min=1.0)
    assert ((ref - exact).abs() <= _f32_sum_bound(K, mag)).all()  # the plain version's own bar
    to_plain = ((y - ref).abs() / (SPLIT_TOL * scale + _f32_sum_bound(K, mag))).max().item()
    return ((y - exact).abs() / scale).max().item(), to_plain, plan


@pytest.mark.parametrize("kind,M,N,K", SPLIT_CASES)
def test_split_emulation_matches_plain(kind, M, N, K):
    err, to_plain, plan = _split_err(kind, M, N, K, seed=M + K)
    assert plan["route"] == "split"
    assert err <= SPLIT_TOL and to_plain <= 1.0, (err, to_plain)


@pytest.mark.parametrize("M,N,K", [(24, 96, 1024), (40, 136, 512)])
def test_split_nf4_dropped_products_within_their_bound(M, N, K):
    """The three products NF4's split route drops move y by at most 2^-23
    Σ|x_k w_k| (each at most 2^-24 |x_k w_k|)."""
    x, pk, ak = _nf4_inputs(5 * M + K, M, N, K, torch.float32)
    plan = cudaex.weight_only_plan("nf4", M, N, K, torch.float32)
    plan = dict(plan, splits=1, units_per_split=K)  # one exact sum: the difference is the dropped products'
    all9 = tuple((i, j) for i in range(3) for j in range(3))
    six = emulate_split("nf4", x, pk, ak, plan).double()
    nine = emulate_split("nf4", x, pk, ak, plan, pairs=all9).double()
    w = tq.dequantize_nf4_kl(pk, ak, (N, K)).double()
    mag = x.double().abs() @ w.abs().t()
    assert ((six - nine).abs() <= 2.0 ** -23 * mag + 2.0 ** -24 * nine.abs()).all()
    assert (six - nine).abs().max().item() > 0  # the dropped products are not all zero


def test_split_cases_cover_k_splits_and_tiles():
    seen = set()
    for kind, M, N, K in SPLIT_CASES:
        plan = cudaex.weight_only_plan(kind, M, N, K, torch.float32)
        seen.add((kind, plan["splits"] > 1, plan["tile_m"]))
    assert seen == {("int8", True, 16), ("int8", True, 64), ("int8", True, 128), ("int8", False, 128),
                    ("nf4", True, 64), ("nf4", False, 64)}


@pytest.mark.parametrize("kind,M,N,K", [("int8", 8, 128, 512), ("int8", 40, 256, 1024), ("nf4", 24, 128, 512),
                                        ("nf4", 40, 256, 1024)])
def test_split_emulation_matches_pallas(kind, M, N, K):
    x, stored, aux = _inputs(kind, 3 * M + K, M, N, K, torch.float32)
    plan = cudaex.weight_only_plan(kind, M, N, K, torch.float32)
    got = emulate_split(kind, x, stored, aux, plan).numpy()
    xj = jnp.asarray(x.numpy())
    if kind == "int8":
        ref = pallasex.int8_linear(xj, jnp.asarray(stored.numpy()), jnp.asarray(aux.numpy()))
    else:
        ref = pallasex.nf4_linear(xj, jnp.asarray(stored.numpy()), jnp.asarray(aux.numpy()))
    ref = torch.from_numpy(np.array(ref, np.float32)).double()
    exact, mag = _exact(kind, x, stored, aux)
    assert ((ref - exact).abs() <= _f32_sum_bound(K, mag)).all()
    bar = SPLIT_TOL * exact.abs().clamp(min=1.0) + _f32_sum_bound(K, mag)
    assert ((torch.from_numpy(got).double() - ref).abs() <= bar).all()


# (fault, kind, M, N, K): each must fail SPLIT_TOL against the plain version
SPLIT_FAULTS = [("x2_dropped", "int8", 40, 96, 512), ("x2_dropped", "nf4", 24, 96, 512),
                ("nf4_11_dropped", "nf4", 40, 96, 1024), ("nf4_02_dropped", "nf4", 24, 96, 512),
                ("scale_each_pass", "int8", 300, 256, 256), ("split_twice", "int8", 17, 96, 512),
                ("split_twice", "nf4", 40, 96, 1024)]


@pytest.mark.parametrize("fault,kind,M,N,K", SPLIT_FAULTS)
def test_split_planted_faults_fail(fault, kind, M, N, K):
    err, _, plan = _split_err(kind, M, N, K, seed=11 * M + K, fault=fault)
    assert plan["route"] == "split"
    if fault == "split_twice":
        assert plan["splits"] > 1
    assert err > SPLIT_TOL, err
