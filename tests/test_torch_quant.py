"""The port's weight-only quantization against thunder_tpu's, on the CPU.

The same numpy weights and inputs go through thunder_tpu and the port:

* ``quantize_int8``, ``quantize_nf4`` and the NF4 kernel layout give the
  same codes, scales and absmax bit for bit, in f32 and bf16;
* the kernels' plain versions (``cudaex.int8_linear_plain``,
  ``cudaex.nf4_linear_plain``) against pallasex's kernels in interpret mode:
  f32 within 1e-5 · max(1, |ref|) (the same f32 math in another summation
  order), bf16 within one bf16 ulp of the larger of the two (both round one
  f32 sum, which another order can move across a rounding boundary) plus
  1e-6 (near 0 that order's own f32 error exceeds a bf16 ulp);
* the torchex decompositions against thunder_tpu's jax impls (which
  dequantize to bf16 before the product): f32 within 1e-5, bf16 one ulp;
* the VJP rules' dx against thunder_tpu's value_and_grad: both cast g and
  the weights to bf16, so dx is held to one bf16 ulp (2^-8 relative);
* ``load_jax_params`` on quantized models; the transforms' parameters,
  their names and order;
* the slice: the port's ``ServingEngine(quantize="int8")`` against
  thunder_tpu's on int8-exact weights, and the port's NF4 ``GPTInference``
  against thunder_tpu's on the same float weights, token for token, f32.

Which route each side takes on the CPU (read in last_traces): the port's
cuda executor claims ``quant.linear_int8`` and ``quant.linear_nf4_kl`` up to
512 rows and runs the plain versions (the kernels' semantics: int8 scales
after the f32 sum; NF4 rounds weights to x's dtype). thunder_tpu declines
its int8 kernel off a TPU (no TT_INT8_PALLAS_CPU) and runs its
decomposition, which dequantizes to bf16 first; on int8-exact weights
(integer codes times a power-of-two scale) the two are the same numbers.
thunder_tpu's NF4 kernel has no such gate: its decode and prefill run the
Pallas kernel in interpret mode, the port's the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu as tj
import thunder_tpu_torch as tt
from thunder_tpu import nn as jnn
from thunder_tpu.executors import pallasex
from thunder_tpu.inference import GPTInference as JaxGPTInference
from thunder_tpu.models.litgpt import GPT as JaxGPT
from thunder_tpu.models.litgpt import Config as JaxConfig
from thunder_tpu.ops import ltorch as jl
from thunder_tpu.serving import ServingEngine as JaxServingEngine
from thunder_tpu.transforms import quantization as jq
from thunder_tpu_torch.core import dtypes
from thunder_tpu_torch.core.proxies import TensorProxy
from thunder_tpu_torch.executors import cudaex, torchex
from thunder_tpu_torch.inference import GPTInference
from thunder_tpu_torch.models.litgpt import GPT, Config, load_jax_params
from thunder_tpu_torch.ops import ltorch as tl
from thunder_tpu_torch.serving import ServingEngine
from thunder_tpu_torch.transforms import quantization as tq

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DT_IDS = ["f32", "bf16"]
# n_embd 256, heads of 64 (attn out 512), MLP 448, padded vocab 512: the
# attention linears and lm_head take NF4's kernel layout (out % 128 == 0, a
# slice width for K = 256); fc_1/fc_2 (out 448) and proj (K = 448, no slice
# width) keep the canonical layout, so one model covers both routes.
QCFG = dict(name="quant-tiny", block_size=64, vocab_size=320, padded_vocab_size=512, n_layer=2,
            n_head=4, n_query_groups=2, n_embd=256, intermediate_size=448)


def _np(a):
    return np.asarray(a, dtype=np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


def _bf16_ulp(ref):
    """One bf16 ulp at |ref| (8 significant bits)."""
    mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_close(got, ref, dtype):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if dtype == torch.float32:
        bound = 1e-5 * np.maximum(1.0, np.abs(ref))
    else:
        # either side of a binade edge; near 0 the f32 sums' order shows
        bound = _bf16_ulp(np.maximum(np.abs(ref), np.abs(got))) + 1e-6
    err = np.abs(got - ref)
    assert (err <= bound).all(), f"max err {err.max()}, worst excess {(err - bound).max()}"


def _weights(rng, N, K, scale=0.02):
    w = rng.randn(N, K).astype(np.float32) * scale
    w[1] = 0.0                               # an all-zero row: scale 1, absmax 1e-12
    w[2, :16] = tq.NF4_CODE.numpy()          # exact code values
    w[3, 0] = 7.0                            # one large value dominates its row / block
    return w


# ---------------------------------------------------------------------------
# quantizers and layout: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=DT_IDS)
def test_quantize_int8_is_bit_equal(dtype):
    w = _weights(np.random.RandomState(0), 96, 320)
    jq_, js = jq.quantize_int8(jnp.asarray(w, JDT[dtype]))
    q, s = tq.quantize_int8(_t(w, dtype))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=DT_IDS)
def test_quantize_nf4_is_bit_equal(dtype, monkeypatch):
    """Bit-equal codes and absmax, with the distance tensor built in chunks
    of 5 blocks (the port's cut of the reference's one-shot broadcast)."""
    w = _weights(np.random.RandomState(1), 64, 256)
    jp, ja = jq.quantize_nf4(jnp.asarray(w, JDT[dtype]))
    monkeypatch.setattr(tq, "_NF4_CHUNK_BLOCKS", 5)
    p, a = tq.quantize_nf4(_t(w, dtype))
    assert p.dtype == torch.uint8 and a.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tq.dequantize_nf4(p, a, (64, 256)).numpy(),
                                  np.asarray(jq.dequantize_nf4(jp, ja, (64, 256))))


@pytest.mark.parametrize("K", [256, 512, 768, 1024])
def test_kernel_layout_is_bit_equal(K):
    """pack_nf4_kernel_layout and dequantize_nf4_kl against pallasex's and
    thunder_tpu's, at slice widths 256 (K=256, 768) and 512."""
    N = 128
    w = _weights(np.random.RandomState(K), N, K)
    jp, ja = jq.quantize_nf4(jnp.asarray(w))
    p, a = tq.quantize_nf4(_t(w))
    assert tq.nf4_kernel_block_k(K) == pallasex.nf4_kernel_block_k(K)
    jk, jka = pallasex.pack_nf4_kernel_layout(jp, ja, (N, K))
    k, ka = tq.pack_nf4_kernel_layout(p, a, (N, K))
    assert k.dtype == torch.uint8 and tuple(k.shape) == (N, K // 2) and tuple(ka.shape) == (N, K // 64)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ka.numpy(), np.asarray(jka))
    np.testing.assert_array_equal(tq.dequantize_nf4_kl(k, ka, (N, K)).numpy(),
                                  np.asarray(jq.dequantize_nf4_kl(jk, jka, (N, K))))


def test_kernel_block_width_rule_matches():
    for K in (64, 128, 256, 384, 448, 512, 768, 1000, 1536, 2048, 2816, 8192):
        assert tq.nf4_kernel_block_k(K) == pallasex.nf4_kernel_block_k(K), K
    with pytest.raises(ValueError, match="no kernel block width"):
        tq.pack_nf4_kernel_layout(torch.zeros(64, dtype=torch.uint8), torch.ones(2), (1, 128))


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _int8_inputs(rng, M, N, K):
    x = rng.randn(M, K).astype(np.float32)
    q = rng.randint(-127, 128, (N, K)).astype(np.int8)
    # a Llama-sized row (|w| up to ~0.06): outputs of order 1
    s = (np.abs(rng.randn(N)) * 5e-4 + 1e-4).astype(np.float32)
    return x, q, s


@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=DT_IDS)
def test_int8_plain_matches_pallas(dtype, M):
    x, q, s = _int8_inputs(np.random.RandomState(M), M, 256, 512)
    ref = pallasex.int8_linear(jnp.asarray(x, JDT[dtype]), jnp.asarray(q), jnp.asarray(s))
    got = cudaex.int8_linear(_t(x, dtype), _t(q), _t(s))
    assert got.dtype == dtype
    _assert_close(got.float().numpy(), _np(ref), dtype)


def _nf4_inputs(rng, M, N, K):
    w = _weights(rng, N, K)
    p, a = tq.quantize_nf4(_t(w))
    pk, ak = tq.pack_nf4_kernel_layout(p, a, (N, K))
    return rng.randn(M, K).astype(np.float32), pk.numpy(), ak.numpy()


@pytest.mark.parametrize("M", [1, 4, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=DT_IDS)
def test_nf4_plain_matches_pallas(dtype, M):
    x, pk, ak = _nf4_inputs(np.random.RandomState(M), M, 256, 1024)
    ref = pallasex.nf4_linear(jnp.asarray(x, JDT[dtype]), jnp.asarray(pk), jnp.asarray(ak))
    got = cudaex.nf4_linear(_t(x, dtype), _t(pk), _t(ak))
    assert got.dtype == dtype
    _assert_close(got.float().numpy(), _np(ref), dtype)


def test_wrappers_run_plain_only_on_cpu():
    """CPU tensors take the plain versions without counting a launch;
    tensors on any other non-CUDA device are refused, never computed."""
    x, q, s = _int8_inputs(np.random.RandomState(0), 4, 128, 64)
    xn, pk, ak = _nf4_inputs(np.random.RandomState(1), 4, 128, 256)
    before = (cudaex.int8_linear.launches, cudaex.nf4_linear.launches)
    cudaex.int8_linear(_t(x), _t(q), _t(s))
    cudaex.nf4_linear(_t(xn), _t(pk), _t(ak))
    assert (cudaex.int8_linear.launches, cudaex.nf4_linear.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        cudaex.int8_linear(*(_t(a).to("meta") for a in (x, q, s)))
    with pytest.raises(ValueError, match="CUDA"):
        cudaex.nf4_linear(*(_t(a).to("meta") for a in (xn, pk, ak)))


# ---------------------------------------------------------------------------
# decompositions against thunder_tpu's jax impls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=DT_IDS)
def test_decompositions_match_reference_impls(dtype):
    rng = np.random.RandomState(2)
    M, N, K = 6, 128, 512
    x, q, s = _int8_inputs(rng, M, N, K)
    bias = rng.randn(N).astype(np.float32)
    jx, tx = jnp.asarray(x, JDT[dtype]), _t(x, dtype)
    jb, tb = jnp.asarray(bias, JDT[dtype]), _t(bias, dtype)
    _assert_close(torchex._quantized_linear_impl(tx, _t(q), _t(s), tb).float().numpy(),
                  _np(jq._quantized_linear_impl(jx, jnp.asarray(q), jnp.asarray(s), jb)), dtype)

    w = _weights(rng, N, K)
    jp, ja = jq.quantize_nf4(jnp.asarray(w))
    p, a = tq.quantize_nf4(_t(w))
    _assert_close(torchex._nf4_linear_impl(tx, p, a, N, K, 64, tb).float().numpy(),
                  _np(jq._nf4_linear_impl(jx, jp, ja, N, K, 64, jb)), dtype)
    jk, jka = pallasex.pack_nf4_kernel_layout(jp, ja, (N, K))
    k, ka = tq.pack_nf4_kernel_layout(p, a, (N, K))
    _assert_close(torchex._nf4_linear_kl_impl(tx, k, ka, N, K, 64, None).float().numpy(),
                  _np(jq._nf4_linear_kl_impl(jx, jk, jka, N, K, 64, None)), dtype)


def test_decomposition_and_kernel_semantics_differ_as_documented():
    """f32 x: the decompositions round weights to bf16 before the product,
    the kernels' plain versions do not — a difference far above f32
    rounding on random scales."""
    rng = np.random.RandomState(3)
    x, q, s = _int8_inputs(rng, 4, 128, 256)
    tx = _t(x)
    d = (torchex._quantized_linear_impl(tx, _t(q), _t(s)) - cudaex.int8_linear_plain(tx, _t(q), _t(s)))
    assert d.abs().max() > 1e-4
    _, pk, ak = _nf4_inputs(rng, 4, 128, 256)
    d = (torchex._nf4_linear_kl_impl(tx, _t(pk), _t(ak), 128, 256)
         - cudaex.nf4_linear_plain(tx, _t(pk), _t(ak)))
    assert d.abs().max() > 1e-4


# ---------------------------------------------------------------------------
# VJP rules: dx (and the bias grad) against thunder_tpu's value_and_grad
# ---------------------------------------------------------------------------


def _vjp_case(kind, rng):
    """(symbol args as numpy, extra python args) for one quantized linear
    with bias; the int8 weights are int8-exact (power-of-two scales), so the
    two packages' forward routes give the same value."""
    M, N, K = 6, 128, 256
    x = rng.randn(2, M // 2, K).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    r = rng.randn(2, M // 2, N).astype(np.float32)
    if kind == "int8":
        q = rng.randint(-127, 128, (N, K)).astype(np.int8)
        s = np.exp2(rng.randint(-9, -5, N)).astype(np.float32)
        return [x, q, s, b, r], ()
    p, a = tq.quantize_nf4(_t(_weights(rng, N, K)))
    if kind == "nf4_kl":
        p, a = tq.pack_nf4_kernel_layout(p, a, (N, K))
    return [x, p.numpy(), a.numpy(), b, r], (N, K, 64)


VJP_SYMS = {"int8": ("quantized_linear", "quant.linear_int8", None),
            "nf4": ("nf4_linear", "quant.linear_nf4", "quant.nf4_dequant"),
            "nf4_kl": ("nf4_linear_kl", "quant.linear_nf4_kl", "quant.nf4_dequant_kl")}


@pytest.mark.parametrize("kind", sorted(VJP_SYMS))
def test_vjp_dx_matches_jax(kind):
    arrays, extra = _vjp_case(kind, np.random.RandomState(sorted(VJP_SYMS).index(kind)))
    name, fwd_id, dequant_id = VJP_SYMS[kind]
    jsym, tsym = getattr(jq, name), getattr(tq, name)
    jval, jgrads = tj.value_and_grad(
        lambda x, w, sc, b, r: jl.sum(jsym(x, w, sc, *extra, b) * r), argnums=(0, 3))(
        *[jnp.asarray(a) for a in arrays])
    vag = tt.value_and_grad(lambda x, w, sc, b, r: tl.sum(tsym(x, w, sc, *extra, b) * r), argnums=(0, 3))
    tval, tgrads = vag(*[_t(a) for a in arrays])
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5, atol=1e-4)
    for i in (0, 3):
        want = np.asarray(jgrads[0][i], np.float32)
        got = tgrads[0][i].numpy()
        assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-6).all(), f"grad of argument {i}"
    assert fwd_id in {b.sym.id for b in tt.last_traces(vag)[-1].bound_symbols}
    bwd = {b.sym.id for b in tt.last_backward_traces(vag)[-1].bound_symbols}
    assert dequant_id is None or dequant_id in bwd


# ---------------------------------------------------------------------------
# checkers and claims
# ---------------------------------------------------------------------------


def _p(*shape, dt=dtypes.bfloat16):
    return TensorProxy(shape=shape, dtype=dt, device=tt.devices.cpu)


def test_int8_checker_is_hoppers():
    """int8 weights only (uint8 would be read as signed), f32/bf16 x, K % 16,
    f32 scale, any N, at most QUANT_MAX_M rows."""
    def ok(M=8, N=250, K=48, xdt=dtypes.bfloat16, wdt=dtypes.int8, sdt=dtypes.float32):
        return cudaex.int8_linear_supported(_p(M, K, dt=xdt), _p(N, K, dt=wdt), _p(N, dt=sdt))

    assert ok() and ok(M=512) and ok(xdt=dtypes.float32) and ok(N=128256, K=2048)
    assert cudaex.int8_linear_supported(_p(2, 4, 64), _p(32, 64, dt=dtypes.int8), _p(32, dt=dtypes.float32))
    assert not ok(M=513) and not ok(K=40) and not ok(wdt=dtypes.uint8)
    assert not ok(xdt=dtypes.float16) and not ok(sdt=dtypes.bfloat16)


def test_nf4_checker_is_hoppers():
    def ok(M=4, N=200, K=512, bs=64, xdt=dtypes.bfloat16):
        return cudaex.nf4_linear_supported(_p(M, K, dt=xdt), _p(N, K // 2, dt=dtypes.uint8),
                                           _p(N, K // 64, dt=dtypes.float32), N, K, bs)

    assert ok() and ok(M=512) and ok(K=256) and ok(K=768) and ok(xdt=dtypes.float32)
    assert not ok(M=513) and not ok(K=128) and not ok(K=448) and not ok(bs=32)
    assert not ok(xdt=dtypes.float16)


# kind -> (symbol, cuda impl, its plain version, torchex decomposition)
CLAIMS = {"int8": (tq.quantized_linear, cudaex._int8_linear_impl, cudaex.int8_linear_plain,
                   torchex._quantized_linear_impl),
          "nf4": (tq.nf4_linear_kl, cudaex._nf4_kl_impl, cudaex.nf4_linear_plain,
                  torchex._nf4_linear_kl_impl)}


@pytest.mark.parametrize("kind", sorted(CLAIMS))
def test_claims_follow_the_checker(kind):
    """At most 512 rows: the cuda executor claims the prim (its plain
    version runs on CPU tensors); 600 rows: the torchex decomposition, as
    thunder_tpu's prefill above its kernel's M bound."""
    rng = np.random.RandomState(4)
    N, K = 128, 256
    sym, impl, plain, decomp = CLAIMS[kind]
    if kind == "int8":
        args, extra = tuple(_t(a) for a in _int8_inputs(rng, 1, N, K)[1:]), ()
    else:
        args, extra = tuple(_t(a) for a in _nf4_inputs(rng, 1, N, K)[1:]), (N, K, 64)
    cfn = tt.jit(lambda x, w, s: sym(x, w, s, *extra))
    for M, want in ((8, impl), (512, impl), (600, decomp)):
        x = _t(rng.randn(M, K).astype(np.float32))
        out = cfn(x, *args)
        impls = [b.impl for b in tt.last_traces(cfn)[-1].bound_symbols if b.sym.id == sym.id]
        assert impls == [want], (M, impls)
        ref = plain(x, *args) if want is impl else decomp(x, *args, *extra)
        torch.testing.assert_close(out, ref, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# transforms, parameters and load_jax_params
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_float_params():
    jgpt = JaxGPT(JaxConfig(**QCFG), dtype=jnp.float32)
    return {k: np.asarray(p.data) for k, p in jgpt.named_parameters()}


def _both_models(params):
    jgpt = JaxGPT(JaxConfig(**QCFG), dtype=jnp.float32)
    for name, mod in jgpt.named_modules():
        for pn in list(mod._parameters):
            q = f"{name}.{pn}" if name else pn
            mod._parameters[pn] = jnn.Parameter(jnp.asarray(params[q]))
    gpt = GPT(Config(**QCFG), torch.float32, device="cpu")
    load_jax_params(gpt, params)
    return jgpt, gpt


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_transforms_give_the_references_parameters(jax_float_params, mode):
    """Same names, order, dtypes, shapes and values after each transform,
    and load_jax_params carries a quantized JAX model's parameters across
    exactly (a fresh port model quantized from other weights takes them)."""
    jgpt, gpt = _both_models(jax_float_params)
    jtf, ttf = ((jq.QuantizeInt8Transform(), tq.QuantizeInt8Transform()) if mode == "int8"
                else (jq.QuantizeNF4Transform(), tq.QuantizeNF4Transform()))
    jtf.transform_module(jgpt)
    ttf.transform_module(gpt)
    jp = {k: np.asarray(p.data) for k, p in jgpt.named_parameters()}
    tp = dict(gpt.named_parameters())
    assert list(tp) == list(jp)
    for k in jp:
        assert str(tp[k].dtype).replace("torch.", "") == jp[k].dtype.name, k
        np.testing.assert_array_equal(tp[k].detach().numpy(), jp[k], err_msg=k)
    if mode == "nf4":  # both routes present: kernel-layout attention, canonical MLP
        assert tp["h.0.attn.attn.weight"].shape == (512, 128)
        assert tp["h.0.mlp.fc_1.weight"].shape == (448 * 256 // 2,)

    other = GPT(Config(**QCFG), torch.float32, device="cpu", seed=7)
    ttf.transform_module(other)
    load_jax_params(other, jp)
    for k, p in other.named_parameters():
        assert p.dtype == tp[k].dtype
        np.testing.assert_array_equal(p.detach().numpy(), jp[k], err_msg=k)


def test_load_jax_params_refuses_a_dtype_mismatch(jax_float_params):
    gpt = GPT(Config(**QCFG), torch.float32, device="cpu")
    tq.QuantizeInt8Transform().transform_module(gpt)
    params = {k: p.detach().numpy() for k, p in gpt.named_parameters()}
    params["h.0.attn.attn.weight"] = params["h.0.attn.attn.weight"].astype(np.float32)
    with pytest.raises(ValueError, match="h.0.attn.attn.weight: dtype float32 vs int8"):
        load_jax_params(gpt, params)
    with pytest.raises(ValueError, match="dtype int8 vs float32"):
        load_jax_params(GPT(Config(**QCFG), torch.float32, device="cpu"),
                        {**jax_float_params, "lm_head.weight": np.zeros((512, 256), np.int8)})


def test_transform_sets_the_forward_that_call_runs():
    """An instance forward set by the transform is what Module.__call__
    runs: the traced program holds quant.linear_int8 where nn.Linear was."""
    lin = tt.nn.Linear(64, 128, bias=True, device="cpu")
    tq.QuantizeInt8Transform().transform_module(lin)
    assert [n for n, _ in lin.named_parameters()] == ["weight", "bias", "scale"]
    tm = tt.jit(lin)
    x = torch.randn(3, 64)
    out = tm(x)
    assert any(b.sym.id == "quant.linear_int8" for b in tt.last_traces(tm)[0].bound_symbols)
    torch.testing.assert_close(out, cudaex.int8_linear_plain(x, lin.weight, lin.scale) + lin.bias)


# ---------------------------------------------------------------------------
# the slice: int8 serving and NF4 inference against thunder_tpu
# ---------------------------------------------------------------------------


def _int8_exact(params, rng):
    """Every Linear weight (2-d, not the embedding) as q · 2^-9 with integer
    q and a per-row max |q| of 127 (tests/test_mfu_levers.py:_make_int8_exact):
    quantize_int8 recovers q and the scale exactly and q · 2^-9 is exact in
    bf16, so both packages' routes see the same weights."""
    out = dict(params)
    for k, v in params.items():
        if v.ndim == 2 and not k.startswith("wte"):
            q = rng.randint(-126, 127, size=v.shape).astype(np.float64)
            q[:, 0] = 127.0
            out[k] = (q * 2.0 ** -9).astype(np.float32)
    return out


def test_int8_serving_engine_streams_match_jax(jax_float_params):
    params = _int8_exact(jax_float_params, np.random.RandomState(5))
    jgpt, gpt = _both_models(params)
    kw = dict(max_batch=3, page_size=8, max_seq=64)
    jeng = JaxServingEngine(jgpt, dtype=jnp.float32, quantize="int8", **kw)
    teng = ServingEngine(gpt, dtype=torch.float32, device="cpu", quantize="int8", **kw)
    assert gpt.h[0].mlp.fc_1.weight.dtype == torch.int8
    assert set(teng.params) == {k for k, _ in jgpt.named_parameters()}
    rng = np.random.RandomState(6)
    specs = [(rng.randint(0, 320, (L,)).astype(np.int32), n) for L, n in ((5, 6), (13, 4), (9, 7), (20, 3))]
    jf = [jeng.submit(p, max_new_tokens=n) for p, n in specs]
    tf = [teng.submit(p, max_new_tokens=n) for p, n in specs]
    jeng.drain()
    teng.drain()
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(a.result().new_tokens, np.asarray(b.result().new_tokens))
    decode = tt.last_traces(teng.runner.decode_cfn)[-1].bound_symbols
    assert sum(b.impl is cudaex._int8_linear_impl for b in decode) == 5 * QCFG["n_layer"] + 1


def test_nf4_inference_streams_match_jax(jax_float_params):
    jgpt, gpt = _both_models(jax_float_params)
    jq.QuantizeNF4Transform().transform_module(jgpt)
    tq.QuantizeNF4Transform().transform_module(gpt)
    prompt = np.random.RandomState(7).randint(0, 320, (2, 8)).astype(np.int32)
    jout, _ = JaxGPTInference(jgpt, max_seq=32, dtype=jnp.float32).generate(jnp.asarray(prompt), 6)
    eng = GPTInference(gpt, max_seq=32, dtype=torch.float32)
    tout, m = eng.generate(torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert m.top2_gap.shape == (2, 6)
    decode = tt.last_traces(eng._decode_cfn)[-1].bound_symbols
    # attention qkv and proj and lm_head on the kernel; the MLP canonical
    assert sum(b.impl is cudaex._nf4_kl_impl for b in decode) == 2 * QCFG["n_layer"] + 1
    assert sum(b.sym.id == "quant.linear_nf4" for b in decode) == 3 * QCFG["n_layer"]
