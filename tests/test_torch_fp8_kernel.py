"""The fp8 linear's two stages in plain PyTorch (csrc/fp8_linear.cu: a
quantize pass writing the e4m3 codes and the amaxes, then the product of the
codes with its sums promoted into f32 every 32 of k): their composition
against cudaex.fp8_linear_plain and against thunder_tpu's Pallas kernel in
interpret mode, at small shapes that include K = 32 (one promotion group), a
K that is not a multiple of 128 and ragged M and N; and planted faults that
the bar must catch.

The bar: codes and amaxes bit-equal; f32 y within rtol 1e-5 / atol 1e-4
(the bar of tests/test_torch_fp8.py: both sides sum the same exact e4m3
products in f32, in another order); bf16 y within one bf16 ulp, at most
2^-7 of |y| (each side rounds its f32 sum once, and sums taken in another
order can straddle a rounding boundary, as one does at K = 1024 here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.executors.pallasex import fp8_linear_fused
from thunder_tpu_torch.executors import cudaex
from thunder_tpu_torch.transforms import fp8_training as tfp8

FMT_MAX = tfp8.E4M3_MAX
Y_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-4)}
# (M, N, K)
SHAPES = {"k32": (16, 24, 32), "k160": (40, 72, 160), "ragged": (36, 40, 96), "k1024": (64, 128, 1024)}


def _inputs(M, N, K, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(N, K) * 0.05).astype(np.float32)
    sx = np.float32(FMT_MAX / np.abs(x).max() / 2)
    sw = np.float32(FMT_MAX / np.abs(w).max())
    return x, w, sx, sw


def _torch_args(x, w, sx, sw, x_dtype):
    return torch.tensor(x).to(x_dtype), torch.tensor(w), torch.tensor(sx), torch.tensor(sw)


def _composed(x, w, sx, sw, quantize=None, gemm=None):
    """(y, xq, wq, amax_x, amax_w) through the two stages' plain versions."""
    xq, wq, ax, aw = (quantize or cudaex.fp8_quantize_plain)(x, w, sx, sw, fmt_max=FMT_MAX)
    return (gemm or cudaex.fp8_gemm_plain)(xq, wq, sx, sw, x.dtype), xq, wq, ax, aw


def _codes(t) -> np.ndarray:
    """The bytes of a float8 array or tensor."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _meets_bar(got, want) -> bool:
    y, xq, wq, ax, aw = got
    wy, wxq, wwq, wax, waw = want
    wy = wy.float().numpy() if isinstance(wy, torch.Tensor) else np.asarray(wy, np.float32)
    return (np.array_equal(_codes(xq), _codes(wxq)) and np.array_equal(_codes(wq), _codes(wwq))
            and float(ax) == float(wax) and float(aw) == float(waw)
            and np.allclose(y.float().numpy(), wy, **Y_TOL[y.dtype]))


X_DTYPES = dict(argnames="x_dtype", argvalues=[torch.float32, torch.bfloat16], ids=["x_f32", "x_bf16"])


@pytest.mark.parametrize(**X_DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_stages_compose_to_the_plain_version(shape, x_dtype):
    args = _torch_args(*_inputs(*SHAPES[shape], seed=1), x_dtype)
    got = _composed(*args)
    assert got[0].dtype == x_dtype and tuple(got[0].shape) == SHAPES[shape][:2]
    assert _meets_bar(got, cudaex.fp8_linear_plain(*args, fmt_max=FMT_MAX, save_quantized=True))


@pytest.mark.parametrize(**X_DTYPES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_stages_compose_to_the_pallas_kernel(monkeypatch, shape, x_dtype):
    monkeypatch.setenv("TT_FP8_FUSED", "force")
    x, w, sx, sw = _inputs(*SHAPES[shape], seed=2)
    jdt = jnp.float32 if x_dtype == torch.float32 else jnp.bfloat16
    want = fp8_linear_fused(jnp.asarray(x).astype(jdt), jnp.asarray(w), sx, sw, fmt_max=FMT_MAX,
                            save_quantized=True)
    assert _meets_bar(_composed(*_torch_args(x, w, sx, sw, x_dtype)), want)


def test_promotion_groups_are_32_deep():
    """The product's plain version adds one f32 sum per 32 of k: at K = 32 it
    is a single product, and it equals the widened codes' f32 product
    summed group by group."""
    assert cudaex.FP8_PROMOTE_K == 32
    x, w, sx, sw = _torch_args(*_inputs(8, 16, 96, seed=3), torch.float32)
    xq, wq, _, _ = cudaex.fp8_quantize_plain(x, w, sx, sw, fmt_max=FMT_MAX)
    groups = [torch.matmul(xq[:, k:k + 32].float(), wq[:, k:k + 32].float().t()) for k in (0, 32, 64)]
    want = ((groups[0] + groups[1]) + groups[2]) / (sx * sw)
    assert torch.equal(cudaex.fp8_gemm_plain(xq, wq, sx, sw, torch.float32), want)


def _drop_a_group(xq, wq, sx, sw, dtype):
    """Planted fault: the product skips k's second 32-deep group."""
    codes = xq.view(torch.uint8).clone()
    codes[:, 32:64] = 0
    return cudaex.fp8_gemm_plain(codes.view(torch.float8_e4m3fn), wq, sx, sw, dtype)


def _round_toward_zero(x, w, sx, sw, fmt_max):
    """Planted fault: codes rounded toward zero instead of to nearest even."""
    def rtz(t, s):
        v = torch.clamp(t.float() * s, -fmt_max, fmt_max)
        q = v.to(torch.float8_e4m3fn)
        bits = q.view(torch.uint8)
        away = (q.float().abs() > v.abs()) & (bits & 0x7F != 0)
        return torch.where(away, bits - 1, bits).view(torch.float8_e4m3fn)
    return rtz(x, sx), rtz(w, sw), x.abs().max().float(), w.abs().max().float()


def _amax_of_codes(x, w, sx, sw, fmt_max):
    """Planted fault: the amaxes of the scaled operands, not of x and w."""
    xq, wq, _, _ = cudaex.fp8_quantize_plain(x, w, sx, sw, fmt_max=fmt_max)
    return xq, wq, (x.float() * sx).abs().max(), (w.float() * sw).abs().max()


@pytest.mark.parametrize("fault", ["drop_a_group", "round_toward_zero", "amax_of_codes"])
@pytest.mark.parametrize("shape", ["k160", "k1024"])
def test_the_bar_fails_each_planted_fault(shape, fault):
    args = _torch_args(*_inputs(*SHAPES[shape], seed=4), torch.float32)
    want = cudaex.fp8_linear_plain(*args, fmt_max=FMT_MAX, save_quantized=True)
    assert _meets_bar(_composed(*args), want)
    planted = {"drop_a_group": dict(gemm=_drop_a_group), "round_toward_zero": dict(quantize=_round_toward_zero),
               "amax_of_codes": dict(quantize=_amax_of_codes)}[fault]
    assert not _meets_bar(_composed(*args, **planted), want)
