"""Weight-only quantization: int8 per-channel and NF4 (4-bit normal float).

The port of thunder_tpu/transforms/quantization.py. Each transform swaps a
Linear's weight for its quantized form (plus the f32 ``scale`` or
``absmax`` it needs, registered as a parameter after the existing ones) and
sets an instance ``forward`` that records one ``quant.*`` prim. The prims'
decompositions are executors/torchex.py's; the cuda executor claims
``quant.linear_int8`` (csrc/int8_linear.cu) and ``quant.linear_nf4_kl``
(csrc/nf4_linear.cu) at decode shapes.

The quantized parameters are the reference's bit for bit: ``quantize_int8``
takes ``amax / 127`` in the weight's dtype and rounds half to even;
``quantize_nf4`` picks the first nearest code on a tie; the NF4 transform
stores the kernel layout exactly where thunder_tpu does. The layout helpers
``nf4_kernel_block_k`` and ``pack_nf4_kernel_layout`` are copies of
thunder_tpu/executors/pallasex.py's (they define the stored layout).
"""
from __future__ import annotations

import functools

import torch

from ..core import dtypes, prims
from ..core.proxies import TensorProxy, pyval
from ..core.symbol import OpTags, Symbol
from ..core.transform_common import Transform
from ..nn.module import Parameter
from ..ops import clang
from .autodiff import VJPResult, register_augmented_forward, register_backward


def _root(tmodule):
    return tmodule.module if hasattr(tmodule, "module") else tmodule


# ---------------------------------------------------------------------------
# int8: symmetric per-output-channel
# ---------------------------------------------------------------------------


def quantize_int8(w: torch.Tensor) -> tuple:
    """w (out, in) -> (int8 weights, f32 per-row scales). ``amax / 127`` is
    taken in w's dtype and then widened, as thunder_tpu takes it."""
    amax = w.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax == 0, 1.0, amax / 127.0).float()
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _quantized_linear_meta(x, qweight, scale, bias=None):
    return TensorProxy(shape=x.shape[:-1] + (qweight.shape[0],), dtype=x.dtype, device=x.device)


quantized_linear = Symbol(
    "quantized_linear", _quantized_linear_meta, id="quant.linear_int8", is_prim=True, module="quant",
    tags=(OpTags.MATMUL_OP,),
)


@register_augmented_forward(quantized_linear.id)
def _qlin_aug(x, qweight, scale, bias=None):
    return VJPResult(quantized_linear(x, qweight, scale, bias), (qweight, scale, bias is not None))


@register_backward(quantized_linear.id)
def _qlin_bwd(qweight, scale, has_bias, g):
    # weight frozen: dx through the dequantized matmul; bias stays trainable
    wq = prims.convert_element_type(qweight, dtypes.bfloat16)
    w = prims.mul(wq, clang.expand_to(clang.unsqueeze(prims.convert_element_type(scale, dtypes.bfloat16), 1),
                                      wq.shape))
    gx = prims.matmul(prims.convert_element_type(g, dtypes.bfloat16), w)
    gx = prims.convert_element_type(gx, g.dtype)
    if has_bias:
        gbias = prims.sum_prim(g, tuple(range(g.ndim - 1))) if g.ndim > 1 else g
        # tensor-order grads: (x, qweight, scale, bias)
        return gx, None, None, gbias
    return gx, None, None


class QuantizeInt8Transform(Transform):
    """Swap every (selected) Linear's weight for int8 + an f32 ``scale``
    and route its forward through ``quant.linear_int8``."""

    def __init__(self, target_predicate=None):
        self.target_predicate = target_predicate or (lambda name, mod: True)

    def transform_module(self, tmodule) -> None:
        from .. import nn as _nn

        for name, mod in list(_root(tmodule).named_modules()):
            if not isinstance(mod, _nn.Linear) or not self.target_predicate(name, mod):
                continue
            with torch.no_grad():
                q, s = quantize_int8(mod.weight.detach())
            mod._parameters["weight"] = Parameter(q, requires_grad=False)
            mod.register_parameter("scale", Parameter(s, requires_grad=False))

            def make_fwd(m):
                def forward(x):
                    return quantized_linear(x, m._parameters["weight"], m._parameters["scale"],
                                            m._parameters.get("bias"))

                return forward

            mod.forward = make_fwd(mod)


# ---------------------------------------------------------------------------
# NF4: 16-entry normal-float codebook, two codes a byte, per-64-block absmax
# ---------------------------------------------------------------------------

# bitsandbytes NF4 codebook (quantiles of a standard normal, public constant)
NF4_CODE = torch.tensor([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
    0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
], dtype=torch.float32)

# blocks whose (rows, 64, 16) distance tensor is built at once: 256 MB of f32.
# thunder_tpu builds it for the whole weight, ~16.8 GB for a 128256 x 2048 head.
_NF4_CHUNK_BLOCKS = 1 << 16


@functools.lru_cache(maxsize=None)
def _code(device: torch.device) -> torch.Tensor:
    # one copy a device: a host-to-device copy cannot run inside CUDA-graph capture
    return NF4_CODE.to(device)


def quantize_nf4(w: torch.Tensor, block_size: int = 64) -> tuple:
    """w (out, in) -> (packed uint8 codes (out*in//2,), f32 absmax per block).

    in-dim must be divisible by block_size. Each value takes the nearest
    code of its block-normalized value (the first on a tie); even positions
    go to the high nibble."""
    flat = w.float().reshape(-1, block_size)
    absmax = torch.clamp_min(flat.abs().amax(dim=1, keepdim=True), 1e-12)
    code = _code(w.device)
    codes = torch.empty(flat.shape, dtype=torch.uint8, device=w.device)
    for r0 in range(0, flat.shape[0], _NF4_CHUNK_BLOCKS):
        normed = flat[r0:r0 + _NF4_CHUNK_BLOCKS] / absmax[r0:r0 + _NF4_CHUNK_BLOCKS]
        codes[r0:r0 + _NF4_CHUNK_BLOCKS] = torch.argmin((normed[..., None] - code).abs(), dim=-1)
    codes = codes.reshape(-1)
    packed = (codes[0::2] << 4) | codes[1::2]
    return packed, absmax[:, 0]


def dequantize_nf4(packed, absmax, shape, block_size: int = 64):
    codes = torch.stack([(packed >> 4) & 0xF, packed & 0xF], dim=1).reshape(-1)
    vals = _code(packed.device)[codes.long()].reshape(-1, block_size) * absmax[:, None]
    return vals.reshape(tuple(shape))


def nf4_kernel_block_k(K: int, block_size: int = 64):
    """Largest K-slice width the kernel layout supports for this K: a
    divisor of K, multiple of 2*block_size (nibble halves stay block-aligned)
    and of 256, capped at 512. None when no such width exists (e.g. K=2816
    -> 256; K=1000 -> None). thunder_tpu/executors/pallasex.py's rule."""
    for bk in (512, 384, 256, 128):
        if bk <= K and K % bk == 0 and bk % (2 * block_size) == 0 and (bk // 2) % 128 == 0:
            return bk
    return None


def pack_nf4_kernel_layout(packed, absmax, shape, block_size: int = 64):
    """Canonical NF4 (flat hi/lo interleave) -> kernel layout ((N, K/2)
    uint8, (N, K/block_size) absmax): within each block_k slice of a row,
    byte j holds column j (high nibble) and column j + block_k/2 (low)."""
    N, K = shape
    bk = nf4_kernel_block_k(K, block_size)
    if bk is None:
        raise ValueError(f"no kernel block width for K={K} (see nf4_kernel_block_k)")
    codes = torch.stack([(packed >> 4) & 0xF, packed & 0xF], dim=1).reshape(N, K // bk, bk)
    kl = (codes[..., : bk // 2] << 4) | codes[..., bk // 2:]
    return kl.reshape(N, K // 2).to(torch.uint8), absmax.reshape(N, K // block_size)


def _nf4_linear_meta(x, packed, absmax, out_features, in_features, block_size=64, bias=None):
    return TensorProxy(shape=x.shape[:-1] + (int(pyval(out_features)),), dtype=x.dtype, device=x.device)


nf4_linear = Symbol(
    "nf4_linear", _nf4_linear_meta, id="quant.linear_nf4", is_prim=True, module="quant",
    tags=(OpTags.MATMUL_OP,),
)


@register_augmented_forward(nf4_linear.id)
def _nf4_aug(x, packed, absmax, out_features, in_features, block_size=64, bias=None):
    return VJPResult(nf4_linear(x, packed, absmax, out_features, in_features, block_size, bias),
                     (packed, absmax, out_features, in_features, block_size, bias is not None))


@register_backward(nf4_linear.id)
def _nf4_bwd(packed, absmax, out_features, in_features, block_size, has_bias, g):
    w = nf4_dequant_sym(packed, absmax, out_features, in_features, block_size)
    gx = prims.matmul(prims.convert_element_type(g, dtypes.bfloat16),
                      prims.convert_element_type(w, dtypes.bfloat16))
    gx = prims.convert_element_type(gx, g.dtype)
    if has_bias:
        gbias = prims.sum_prim(g, tuple(range(g.ndim - 1))) if g.ndim > 1 else g
        # tensor-order grads: (x, packed, absmax, bias)
        return gx, None, None, gbias
    return gx, None, None


def _nf4_dequant_meta(packed, absmax, out_features, in_features, block_size=64):
    return TensorProxy(shape=(int(pyval(out_features)), int(pyval(in_features))),
                       dtype=dtypes.float32, device=packed.device)


nf4_dequant_sym = Symbol("nf4_dequant", _nf4_dequant_meta, id="quant.nf4_dequant", is_prim=True,
                         module="quant")


class QuantizeNF4Transform(Transform):
    """4-bit NF4 weight-only quantization of Linear layers. A layer whose
    in-dim block_size does not divide stays full precision. With
    block_size 64, out % 128 == 0 and a kernel block width for in, the
    weights are stored in the kernel layout and the forward records
    ``quant.linear_nf4_kl``; otherwise the canonical layout and
    ``quant.linear_nf4``."""

    def __init__(self, target_predicate=None, block_size: int = 64):
        self.target_predicate = target_predicate or (lambda name, mod: True)
        self.block_size = block_size

    def transform_module(self, tmodule) -> None:
        from .. import nn as _nn

        for name, mod in list(_root(tmodule).named_modules()):
            if not isinstance(mod, _nn.Linear) or not self.target_predicate(name, mod):
                continue
            w = mod.weight.detach()
            out_f, in_f = w.shape
            if in_f % self.block_size:
                continue  # non-divisible layers stay full precision
            with torch.no_grad():
                packed, absmax = quantize_nf4(w, self.block_size)
            kernel_ok = (
                self.block_size == 64 and out_f % 128 == 0
                and nf4_kernel_block_k(in_f, self.block_size) is not None
            )
            if kernel_ok:
                # the kernel's layout, stored once: decode steps read the
                # 4-bit weights as they are, with no repack a step
                packed, absmax = pack_nf4_kernel_layout(packed, absmax, (out_f, in_f), self.block_size)
            mod._parameters["weight"] = Parameter(packed, requires_grad=False)
            mod.register_parameter("absmax", Parameter(absmax, requires_grad=False))
            sym = nf4_linear_kl if kernel_ok else nf4_linear

            def make_fwd(m, s, o, i, bs):
                def forward(x):
                    return s(x, m._parameters["weight"], m._parameters["absmax"], o, i, bs,
                             m._parameters.get("bias"))

                return forward

            mod.forward = make_fwd(mod, sym, out_f, in_f, self.block_size)


# ---------------------------------------------------------------------------
# kernel-layout NF4 linear: weights stored in the kernel's halves-per-slice
# packing at transform time
# ---------------------------------------------------------------------------


def dequantize_nf4_kl(packed_kl, absmax_kl, shape, block_size: int = 64, block_k=None):
    """Kernel-layout NF4 -> full f32 weights (within each block_k slice of a
    row, the high nibbles cover the first half)."""
    N, K = shape
    bk = block_k or nf4_kernel_block_k(K, block_size)
    code = _code(packed_kl.device)
    byts = packed_kl.reshape(N, K // bk, bk // 2).long()
    w = torch.cat([code[(byts >> 4) & 0xF], code[byts & 0xF]], dim=-1).reshape(N, K)
    return w * absmax_kl.reshape(N, K // block_size).repeat_interleave(block_size, dim=1)


def _nf4_linear_kl_meta(x, packed_kl, absmax_kl, out_features, in_features, block_size=64, bias=None):
    return TensorProxy(shape=x.shape[:-1] + (int(pyval(out_features)),), dtype=x.dtype, device=x.device)


nf4_linear_kl = Symbol(
    "nf4_linear_kl", _nf4_linear_kl_meta, id="quant.linear_nf4_kl", is_prim=True,
    module="quant", tags=(OpTags.MATMUL_OP,),
)


@register_augmented_forward(nf4_linear_kl.id)
def _nf4_kl_aug(x, packed_kl, absmax_kl, out_features, in_features, block_size=64, bias=None):
    return VJPResult(
        nf4_linear_kl(x, packed_kl, absmax_kl, out_features, in_features, block_size, bias),
        (packed_kl, absmax_kl, out_features, in_features, block_size, bias is not None))


@register_backward(nf4_linear_kl.id)
def _nf4_kl_bwd(packed_kl, absmax_kl, out_features, in_features, block_size, has_bias, g):
    w = dequant_nf4_kl_sym(packed_kl, absmax_kl, out_features, in_features, block_size)
    wb = prims.convert_element_type(w, dtypes.bfloat16)
    gx = prims.matmul(prims.convert_element_type(g, dtypes.bfloat16), wb)
    gx = prims.convert_element_type(gx, g.dtype)
    if has_bias:
        gbias = prims.sum_prim(g, tuple(range(g.ndim - 1))) if g.ndim > 1 else g
        return gx, None, None, None, None, None, gbias
    return gx, None, None, None, None, None


def _dequant_nf4_kl_meta(packed_kl, absmax_kl, out_features, in_features, block_size=64):
    return TensorProxy(shape=(int(pyval(out_features)), int(pyval(in_features))),
                       dtype=dtypes.float32, device=packed_kl.device)


dequant_nf4_kl_sym = Symbol("nf4_dequant_kl", _dequant_nf4_kl_meta,
                            id="quant.nf4_dequant_kl", is_prim=True, module="quant")
