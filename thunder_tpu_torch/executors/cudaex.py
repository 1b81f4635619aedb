"""cudaex: hand-written Hopper kernels for the hot ops of the serving and
training paths.

The port's counterpart of thunder_tpu/executors/pallasex.py. It claims seven
composite ltorch symbols whole and two quantized-linear prims:

* ``torch.nn.functional.rms_norm`` → ``rms_norm`` (csrc/rms_norm.cu), which
  replaces pallasex.fused_rms_norm;
* ``thunder.paged_attention`` → ``paged_attention`` (csrc/paged_attention.cu),
  which replaces pallasex.paged_attention_decode;
* ``thunder.paged_chunk_attention`` → ``paged_chunk_attention``
  (csrc/paged_chunk_attention.cu), which replaces pallasex.paged_chunk_decode;
* ``thunder.rope_sdpa`` → ``flash_rope_attention`` (csrc/flash_fwd_sm90.cu:
  in bf16 and fp16 a RoPE prologue and one wgmma/TMA core, in f32 the
  kernel of csrc/flash_rope_fwd.cu), which replaces
  pallasex.flash_rope_attention_forward;
* ``torch.nn.functional.scaled_dot_product_attention`` → ``flash_attention``
  (the same core without the prologue), which replaces
  pallasex.flash_attention_forward;
* ``torch.nn.functional.cross_entropy`` (forward only: training takes the
  composite grad rule, as in thunder_tpu) → ``cross_entropy``
  (csrc/cross_entropy.cu), which replaces pallasex.fused_cross_entropy_forward;
* ``thunder.grouped_mlp`` → ``grouped_mlp`` (csrc/grouped_mlp.cu), which
  replaces pallasex.grouped_mlp_fused;
* ``quant.linear_int8`` → ``int8_linear`` (csrc/int8_linear.cu), which
  replaces pallasex.int8_linear;
* ``quant.linear_nf4_kl`` → ``nf4_linear`` (csrc/nf4_linear.cu), which
  replaces pallasex.nf4_linear.

It claims the three ``dist.*`` operators of ring-attention context
parallelism (parallel/context_parallel.py) — ``dist.ring_attention`` and
the ``dist.ring_attention_fwd``/``_bwd`` pair its grad rule records — and
runs their rings (``_ring_flash_fwd_impl``, ``_ring_flash_bwd_impl``: that
module's ring driver, the loops of pallasex's ring with
``torch.distributed`` point-to-point transfers) through ``ring_flash_step``
(in bf16 and fp16 the flash forward's wgmma core of csrc/flash_fwd_sm90.cu
in ring mode, in f32 csrc/ring_flash_fwd.cu), which replaces
pallasex.ring_flash_step, and ``ring_flash_bwd_step`` (in bf16 and
fp16 the flash backward's wgmma core of csrc/flash_bwd_sm90.cu at the step's
global offsets, in f32 the two passes of csrc/ring_flash_bwd.cu), which
replaces pallasex.ring_flash_bwd_step.

It also holds ``fp8_linear`` (csrc/fp8_linear.cu), which replaces
pallasex.fp8_linear_fused; transforms/fp8_training.py's stateful operators
call it at run time, where its checker claims the shape. And it holds
``adamw_update`` (csrc/adamw.cu), the port's one-pass AdamW update, which
optim.AdamW calls: thunder_tpu has no kernel for it (XLA fuses the update
into the train step), and its plain version ``adamw_plain`` is the
``torch._foreach_*`` chain the port ran before.

It registers the grad rules of ``thunder.rope_sdpa`` and of sdpa as pallasex
does: the augmented forward records ``cuda.rope_flash_fwd``
(``cuda.flash_attention_fwd``), the forward kernel, which also returns the
softmax's lse, and the backward ``cuda.rope_flash_bwd``
(``cuda.flash_attention_bwd``): ``flash_rope_attention_backward``
(``flash_attention_backward``), which replaces
pallasex.flash_rope_attention_backward (flash_attention_backward) and its
fused single pass: in bf16 and fp16 one wgmma pass
(csrc/flash_bwd_sm90.cu) between a prologue and an epilogue kernel, in f32
the two-pass kernels of csrc/flash_rope_bwd.cu. ``FlashRopeAttention`` and
``FlashAttention`` are the same pairs as ``torch.autograd.Function``s. The grad rule of
``thunder.grouped_mlp`` records ``cuda.grouped_mlp_fwd`` (the kernel) and
``cuda.grouped_mlp_bwd``: the SwiGLU chain rule as batched products, as
pallasex's rule takes it outside any kernel.

The kernels are CUDA C++ for sm_90a with a plain C interface, compiled by
``nvcc`` at first use into one shared library under ``build/thunder_tpu_torch/``
and loaded with ctypes. A failed build or launch raises.

Beside each kernel wrapper is its plain PyTorch version. A wrapper runs the
plain version only for tensors on the CPU (the tests); for a CUDA tensor it
launches the kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``.

The checkers are Hopper's, not the TPU's: a shape they decline runs as the
ltorch decomposition, and the trace shows that."""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..core import dtypes
from ..core.dtypes import to_torch_dtype
from ..core.proxies import TensorProxy
from ..extend import OperatorExecutor, register_executor
from ..transforms.autodiff import VJPResult, register_augmented_forward, register_backward
from ..transforms.quantization import dequantize_nf4_kl, nf4_kernel_block_k
from . import graphex

ex = OperatorExecutor("cuda")
register_executor(ex)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "thunder_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
LOG2E = 1.4426950408889634
NEG_INF = -1e30  # csrc/flash_common.cuh kNegInf: the TPU kernels' finite sentinel
H100_SMS = 132  # the plans' default: blocks a wave, one an SM
# csrc/flash_fwd_sm90.cu: queries a work item of the core (kBQ);
# csrc/flash_rope_fwd.cu (f32): queries a block
_FWD_TILE_Q = 128
_FWD_TILE_Q_F32 = 64


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                           "the port's kernels are built from thunder_tpu_torch/csrc at first use")
    return str(path)


def build() -> Path:
    """Compile csrc/*.cu into one shared library, one nvcc per source, all
    started together; the library is named by the sources' hash, so an
    unchanged tree reuses it. ``build.log`` beside it keeps ptxas's
    per-kernel registers and shared memory. Raises on any compiler error."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode() + f.read_bytes())
    lib = BUILD_DIR / f"libtt_kernels-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{s.stem}-{os.getpid()}.o" for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    (BUILD_DIR / "build.log").write_text("".join(logs))
    failed = [s.name for s, p in zip(sources, procs) if p.returncode]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tt_rms_norm.argtypes = [p, p, p, i, i, f, i, i, i, i, i, p]
        lib.tt_rms_norm.restype = i
        lib.tt_empty.argtypes = [p]
        lib.tt_empty.restype = i
        lib.tt_adamw.argtypes = [p, p, i, p, p] + [f] * 7 + [i, p]
        lib.tt_adamw.restype = i
        lib.tt_paged_attention.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
        lib.tt_paged_attention.restype = i
        lib.tt_paged_chunk_attention.argtypes = [p] * 7 + [i] * 10 + [f, i, p]
        lib.tt_paged_chunk_attention.restype = i
        lib.tt_flash_rope_fwd.argtypes = [p] * 8 + [i] * 7 + [f, i, p]
        lib.tt_flash_rope_fwd.restype = i
        lib.tt_flash_rope_bwd.argtypes = [p] * 19 + [i] * 7 + [f, i, i, p]
        lib.tt_flash_rope_bwd.restype = i
        lib.tt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, p]
        lib.tt_flash_fwd.restype = i
        lib.tt_flash_bwd.argtypes = [p] * 15 + [i] * 7 + [f, i, i, p]
        lib.tt_flash_bwd.restype = i
        lib.tt_cross_entropy.argtypes = [p, p, p, p, i, i, i, p]
        lib.tt_cross_entropy.restype = i
        lib.tt_int8_linear.argtypes = [p] * 7 + [i] * 11 + [p]
        lib.tt_int8_linear.restype = i
        lib.tt_nf4_linear.argtypes = [p] * 7 + [i] * 12 + [p]
        lib.tt_nf4_linear.restype = i
        lib.tt_fp8_linear.argtypes = [p] * 10 + [i] * 5 + [f, p]
        lib.tt_fp8_linear.restype = i
        lib.tt_grouped_mlp.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.tt_grouped_mlp.restype = i
        lib.tt_ring_flash_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, i, p]
        lib.tt_ring_flash_fwd.restype = i
        lib.tt_ring_flash_bwd.argtypes = [p] * 11 + [i] * 9 + [f, i, p]
        lib.tt_ring_flash_bwd.restype = i
        _lib = lib
    return _lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(name: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        _require(t.device == dev and t.device.type == "cuda",
                 f"{name}: every tensor must be on one CUDA device, got {[str(x.device) for x in tensors]}")
        _require(t.is_contiguous(), f"{name}: tensors must be contiguous")
        _require(t.data_ptr() % 16 == 0, f"{name}: tensors must be 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _vec(dtype: torch.dtype) -> int:
    return 16 // dtype.itemsize


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

_RMS_MAX_VECS = 4 * 1024  # csrc/rms_norm.cu: 8 vectors a lane x 32 lanes x 16 warps a row
_RMS_DECODE_ROWS = 16  # at most this many rows: the decode launch
# Vectors a lane aimed at, and rows a block for decode and prefill, chosen by
# tools/rms_adamw_ab.py --sweep on an H100 (PERF.md §6): two vectors a lane
# won at every timed shape, one row a block at decode.
_RMS_LANE_VECS = 2
_RMS_ROWS = {"decode": 1, "prefill": 2}
RMS_PDL = 1  # csrc/rms_norm.cu's flag: programmatic dependent launch
# The flag under a graphex capture: off. In a captured decode step the kernel
# before each norm never triggers its dependents early, and the launch with
# PDL cost 0.11-1.01 us more (chip_smoke.py's graphs_pdl, PERF.md §6).
RMS_PDL_CAPTURED = 0


def rms_norm_plan(N: int, D: int, dtype: torch.dtype) -> dict:
    """How rms_norm launches csrc/rms_norm.cu for x (N, D), from the shapes
    and dtype alone (no tensor is read, so the launch is safe to capture in
    a CUDA graph):

    * ``route``: ``decode`` (N <= 16) or ``prefill``;
    * ``wpr``: warps a row, the fewest (at most 16) that leave a lane at
      most two vectors of 16 bytes; ``vpl``: the vectors a lane holds (1,
      2, 4 or 8);
    * ``rows_per_block``, ``threads`` (at most 512), ``blocks`` =
      ceil(N / rows_per_block): a row group (wpr warps) a row;
    * ``flags``: RMS_PDL (the block loads w before it waits for the
      previous kernel); the wrapper launches with RMS_PDL_CAPTURED while
      graphex captures."""
    nvec = D // _vec(dtype)
    route = "decode" if N <= _RMS_DECODE_ROWS else "prefill"
    wpr = min(16, max(1, -(-nvec // (32 * _RMS_LANE_VECS))))
    vpl = next(v for v in (1, 2, 4, 8) if v * 32 * wpr >= nvec)
    rows_per_block = max(1, min(_RMS_ROWS[route], 512 // (32 * wpr)))
    return {"route": route, "vpl": vpl, "wpr": wpr, "rows_per_block": rows_per_block,
            "threads": 32 * wpr * rows_per_block, "blocks": -(-N // rows_per_block), "flags": RMS_PDL}


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 math, weight applied in
    f32, one cast at the end (pallasex._rms_kernel's order)."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def _rms_launch(x, w, y, eps, plan) -> None:
    N, D = x.shape
    _raise_on(_library().tt_rms_norm(x.data_ptr(), w.data_ptr(), y.data_ptr(), N, D, float(eps),
                                     _DTYPE_CODE[x.dtype], plan["vpl"], plan["wpr"], plan["rows_per_block"],
                                     plan["flags"], _stream(x)), "rms_norm")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (N, D), w (D,) of one dtype -> (N, D): x * rsqrt(mean(x²) + eps) * w,
    on rms_norm_plan's launch."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, w, eps)
    N, D = x.shape
    _check_cuda("rms_norm", x, w)
    _require(x.dtype in _DTYPE_CODE and w.dtype == x.dtype,
             f"rms_norm: x and w must share a float dtype, got {x.dtype} and {w.dtype}")
    _require(w.shape == (D,), f"rms_norm: w {tuple(w.shape)} must be ({D},)")
    _require(D % _vec(x.dtype) == 0 and D // _vec(x.dtype) <= _RMS_MAX_VECS,
             f"rms_norm: D={D} unsupported for {x.dtype}")
    y = torch.empty_like(x)
    if N:
        plan = rms_norm_plan(N, D, x.dtype)
        if graphex.capturing() is not None:
            plan["flags"] = RMS_PDL_CAPTURED
        _rms_launch(x, w, y, eps, plan)
        rms_norm.launches += 1
    return y


rms_norm.launches = 0


def empty_kernel(device: torch.device) -> None:
    """Launches csrc/rms_norm.cu's empty kernel on the current stream: the
    launch floor the kernels' timings are read against."""
    _raise_on(_library().tt_empty(torch.cuda.current_stream(device).cuda_stream), "empty")


def _rms_supported(a, normalized_shape, weight=None, eps=1e-6) -> bool:
    if weight is None or len(normalized_shape) != 1 or a.ndim < 1:
        return False
    tdt = to_torch_dtype(a.dtype)
    D = a.shape[-1]
    return (tdt in _DTYPE_CODE and weight.dtype == a.dtype and tuple(weight.shape) == (D,)
            and D % _vec(tdt) == 0 and D // _vec(tdt) <= _RMS_MAX_VECS)


def _rms_impl(a, normalized_shape, weight=None, eps=1e-6):
    D = a.shape[-1]
    out = rms_norm(a.reshape(-1, D).contiguous(), weight.contiguous(), eps)
    return out.reshape(a.shape)


ex.register_implementation("torch.nn.functional.rms_norm", _rms_impl, checker=_rms_supported)


# ---------------------------------------------------------------------------
# AdamW (a port-side kernel: thunder_tpu's update is fused by XLA in the step)
# ---------------------------------------------------------------------------

_ADAMW_CHUNK = 1 << 16  # csrc/adamw.cu: kChunkLog2
_ADAMW_CACHE = 4  # tensor and chunk tables kept, newest last
_adamw_tensor_tables: dict = {}
_adamw_chunk_tables: dict = {}


def adamw_corrections(step, beta1: float, beta2: float) -> tuple:
    """The bias corrections 1 - beta**t of step t (an int or a 0-d integer
    tensor), as 0-d f32 tensors on the step's device, in f32 as
    thunder_tpu/optim.py:AdamW.update takes them (csrc/adamw.cu computes
    the same from the step it reads on the card)."""
    t = torch.as_tensor(step).to(torch.float32)
    return tuple(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32, device=t.device), t)
                 for b in (beta1, beta2))


@torch.no_grad()
def adamw_plain(ps: list, gs: list, ms: list, vs: list, *, lr: float, beta1: float, beta2: float,
                eps: float, weight_decay: float, step, finite=None) -> None:
    """The kernel's function as torch._foreach_* passes (optim.AdamW's chain):
    updates the parameters ps and the f32 moments ms, vs in place from the
    gradients gs; `step` is the step being taken (1 first), an int or a 0-d
    integer tensor (read on the host: the plain version runs on the CPU).
    ``finite``: None, or the skip flag (a 0-d tensor, or a bool): when it is
    0 nothing is written, as the kernel does."""
    if finite is not None and not bool(finite):
        return
    bc1, bc2 = (float(c) for c in adamw_corrections(step, beta1, beta2))
    gs = [g if g.dtype == torch.float32 else g.float() for g in gs]
    # m = b1*m + (1-b1)*g ; v = b2*v + (1-b2)*g*g
    torch._foreach_mul_(ms, beta1)
    torch._foreach_add_(ms, gs, alpha=1.0 - beta1)
    torch._foreach_mul_(vs, beta2)
    torch._foreach_addcmul_(vs, gs, gs, value=1.0 - beta2)
    # upd = (m / bc1) / (sqrt(v / bc2) + eps)
    denom = torch._foreach_div(vs, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(ms, bc1)
    torch._foreach_div_(upd, denom)
    p32 = [p if p.dtype == torch.float32 else p.float() for p in ps]
    if weight_decay:
        # p - lr*wd*p
        torch._foreach_add_(p32, torch._foreach_mul(p32, lr * weight_decay), alpha=-1.0)
    torch._foreach_add_(p32, upd, alpha=-lr)
    for p, q in zip(ps, p32):
        if q is not p:
            p.copy_(q)


def adamw_chunks(numels: list) -> torch.Tensor:
    """csrc/adamw.cu's chunk table for tensors of these numels: one int64 a
    64K-element chunk, (tensor index << 32) | chunk index, tensors in order;
    an empty tensor has none."""
    counts = torch.tensor([-(-n // _ADAMW_CHUNK) for n in numels], dtype=torch.int64)
    owner = torch.repeat_interleave(torch.arange(len(numels), dtype=torch.int64), counts)
    first = torch.cumsum(counts, 0) - counts
    index = torch.arange(int(counts.sum()), dtype=torch.int64) - torch.repeat_interleave(first, counts)
    return (owner << 32) | index


def adamw_entries(ps: list, gs: list, ms: list, vs: list) -> torch.Tensor:
    """csrc/adamw.cu's tensor table: a row of six int64 a tensor (p, g, m and v
    addresses, numel, p's dtype code | g's << 4)."""
    return torch.tensor([[p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                          _DTYPE_CODE[p.dtype] | _DTYPE_CODE[g.dtype] << 4]
                         for p, g, m, v in zip(ps, gs, ms, vs)], dtype=torch.int64).reshape(-1, 6)


def _cached(cache: dict, key, make):
    if key in cache:
        cache[key] = cache.pop(key)  # newest last
    else:
        cache[key] = make()
        while len(cache) > _ADAMW_CACHE:
            cache.pop(next(iter(cache)))
    return cache[key]


def adamw_tables(ps: list, gs: list, ms: list, vs: list) -> tuple:
    """(tensor table, chunk table) on the tensors' device, built once per set
    of addresses (the update works in place, so p, m and v keep theirs; a
    gradient that moves rebuilds only the small tensor table) and per set of
    numels, and uploaded from pinned memory without a stream sync. Under
    CUDA-graph capture the gradients sit in the graph's pool: the tensor
    table for their addresses is filled right after the capture ends
    (graphex.device_table; no host-to-device copy enters the graph), and
    both tables live as long as the graph."""
    dev = ps[0].device
    key = (dev, tuple((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(), p.dtype, g.dtype)
                      for p, g, m, v in zip(ps, gs, ms, vs)))
    make_entries = lambda: graphex.device_table(adamw_entries(ps, gs, ms, vs), dev)  # noqa: E731
    entries = make_entries() if graphex.capturing() else _cached(_adamw_tensor_tables, key, make_entries)
    numels = tuple(p.numel() for p in ps)
    chunks = _cached(_adamw_chunk_tables, (dev, numels),
                     lambda: graphex.device_table(adamw_chunks(list(numels)), dev))
    graphex.keep(entries, chunks)
    return entries, chunks


def adamw_update(ps: list, gs: list, ms: list, vs: list, *, lr: float, beta1: float, beta2: float,
                 eps: float, weight_decay: float, step, finite=None) -> None:
    """AdamW's update of parameters ps and f32 moments ms, vs in place from
    gradients gs (a None gradient leaves its parameter and moments as they
    are), as adamw_plain computes it: on the CPU adamw_plain itself, on a
    card one launch of csrc/adamw.cu over every tensor. ``step`` is the
    step being taken: a 0-d int32 tensor on the card, which the kernel
    reads there (so a captured update replays with each step's bias
    corrections), or an int. ``finite`` is the skip flag of a guarded step:
    None (always update), or a 0-d int32 tensor on the card that the kernel
    reads there, writing nothing where it is 0 (no host sync, and a
    captured step replays the gate)."""
    keep = [i for i, g in enumerate(gs) if g is not None]
    ps, gs, ms, vs = ([t[i] for i in keep] for t in (ps, gs, ms, vs))
    if not ps:
        return
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay, step=step)
    if ps[0].device.type == "cpu":
        return adamw_plain(ps, gs, ms, vs, finite=finite, **hyper)
    dev = ps[0].device
    gs = [g if g.is_contiguous() else g.contiguous() for g in gs]
    for p, g, m, v in zip(ps, gs, ms, vs):
        _require(all(t.device == dev for t in (p, g, m, v)) and dev.type == "cuda",
                 f"adamw_update: every tensor must be on one CUDA device, got {p.device}, {g.device}, "
                 f"{m.device}, {v.device}")
        _require(p.dtype in _DTYPE_CODE and g.dtype in _DTYPE_CODE,
                 f"adamw_update: p and g must be f32, bf16 or f16, got {p.dtype} and {g.dtype}")
        _require(m.dtype == v.dtype == torch.float32, f"adamw_update: m and v must be f32, got {m.dtype}")
        _require(g.shape == m.shape == v.shape == p.shape,
                 f"adamw_update: shapes differ: p {tuple(p.shape)}, g {tuple(g.shape)}, m {tuple(m.shape)}, "
                 f"v {tuple(v.shape)}")
        _require(p.is_contiguous() and m.is_contiguous() and v.is_contiguous(),
                 "adamw_update: p, m and v must be contiguous")
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(step, dtype=torch.int32, device=dev)
    _require(step.device == dev and step.dtype == torch.int32 and step.dim() == 0,
             f"adamw_update: step must be a 0-d int32 tensor on {dev}, got {step.dtype} {tuple(step.shape)} "
             f"on {step.device}")
    if finite is not None:
        # the message reads metadata only: a tensor's repr would sync, which a capture refuses
        got = (f"{finite.dtype} {tuple(finite.shape)} on {finite.device}" if isinstance(finite, torch.Tensor)
               else type(finite).__name__)
        _require(isinstance(finite, torch.Tensor) and finite.device == dev and finite.dtype == torch.int32
                 and finite.dim() == 0, f"adamw_update: the skip flag must be a 0-d int32 tensor on {dev}, got {got}")
    entries, chunks = adamw_tables(ps, gs, ms, vs)
    if not chunks.numel():
        return
    _raise_on(_library().tt_adamw(entries.data_ptr(), chunks.data_ptr(), chunks.numel(), step.data_ptr(),
                                  None if finite is None else finite.data_ptr(), beta1,
                                  1.0 - beta1, beta2, 1.0 - beta2, eps, lr * weight_decay, -lr,
                                  int(bool(weight_decay)), torch.cuda.current_stream(dev).cuda_stream), "adamw")
    adamw_update.launches += 1


adamw_update.launches = 0


# ---------------------------------------------------------------------------
# Paged-attention decode
# ---------------------------------------------------------------------------

# csrc/paged_attention.cu: 128-thread blocks with 8 cp.async slots of 16
# bytes a thread for K and V each; query groups of up to 8 rows, padded to
# 1, 2, 4 or 8; a token read by at most 32 lanes of 16 bytes; at most 128
# splits a table (the combine's kMaxSplitLanes warps' worth). The largest
# such block needs under 65 KB of shared memory, within a Hopper block's 227 KB.
_PAGED_THREADS, _PAGED_STAGES, _PAGED_MAX_G, _PAGED_MAX_VECS, _PAGED_MAX_SPLITS = 128, 8, 8, 32, 128
_PAGED_SPLIT_TOKENS = 128  # tokens a split block owns, where the page allows


def _paged_group_pad(g: int) -> int:
    return next(p for p in (1, 2, 4, 8) if g <= p)


def _paged_pages_per_split(ps: int) -> int:
    return max(1, _PAGED_SPLIT_TOKENS // ps)


def _paged_smem_bytes(g: int, D: int, ps: int) -> int:
    # csrc/paged_attention.cu:split_smem_bytes (the kernel sets the limit above 48 KB)
    warps = _PAGED_THREADS // 32
    return (_PAGED_STAGES * 2 * _PAGED_THREADS * 16 + 4 * warps * _paged_group_pad(g) * (D + 2)
            + 4 * _paged_pages_per_split(ps))


def paged_attention_plan(B, H, Hkv, D, ps, npm, dtype) -> dict:
    """What the paged decode's wrapper allocates and launches for these
    shapes, from the table's width alone (no read of seq_lens, so the launch
    is safe to capture in a CUDA graph): ``pages_per_split`` (a split block
    owns that many pages of its sequence: 128 tokens where the page size
    allows, one page when a page holds more), ``split_tokens``, ``n_split``
    = ceil(npm / pages_per_split), the ``blocks`` of the split kernel (B x
    Hkv x n_split), the ``combine_blocks`` (one warp per (b, h), four a
    block; none when n_split is 1: the split kernel then writes o itself),
    the ``scratch`` (name -> (shape, dtype): the f32 partials (B, H,
    n_split, D + 2) of o, m and l) and the split block's ``smem_bytes``.
    The plan is the same for every dtype. csrc/paged_attention.cu takes the
    splits it is given."""
    pps = _paged_pages_per_split(ps)
    n_split = -(-npm // pps)
    scratch = {"partials": ((B, H, n_split, D + 2), torch.float32)} if n_split > 1 else {}
    nbytes = sum(math.prod(shape) * dt.itemsize for shape, dt in scratch.values())
    return {"pages_per_split": pps, "split_tokens": pps * ps, "n_split": n_split,
            "blocks": B * Hkv * n_split,
            "combine_blocks": -(-B * H // (_PAGED_THREADS // 32)) if n_split > 1 else 0,
            "scratch": scratch, "scratch_bytes": nbytes,
            "smem_bytes": _paged_smem_bytes(H // Hkv, D, ps)}


def _paged_shape_ok(dtype, H, Hkv, D, ps, npm) -> bool:
    return (H % Hkv == 0 and 1 <= H // Hkv <= _PAGED_MAX_G and D % _vec(dtype) == 0
            and D // _vec(dtype) <= _PAGED_MAX_VECS
            and -(-npm // _paged_pages_per_split(ps)) <= _PAGED_MAX_SPLITS)


def paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens, scale=None):
    """The kernel's function in plain PyTorch, in f32: gather each
    sequence's pages, mask slots at or past seq_len, softmax, p·v; a row
    with no live slot gives zeros (the kernel's l == 0 guard)."""
    B, H, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    npm = page_table.shape[1]
    T = npm * ps
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    pt = page_table.long()
    k = k_pages[pt].float().reshape(B, T, Hkv, D).permute(0, 2, 1, 3)  # (B, Hkv, T, D)
    v = v_pages[pt].float().reshape(B, T, Hkv, D).permute(0, 2, 1, 3)
    qg = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.matmul(qg, k.transpose(-1, -2)) * scale  # (B, Hkv, g, T)
    live = (torch.arange(T, device=q.device)[None, :] < seq_lens.long()[:, None])[:, None, None, :]
    s = torch.where(live, s, float("-inf"))
    m = torch.where(live.any(-1, keepdim=True), s.amax(-1, keepdim=True), 0.0)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    o = torch.matmul(e, v) / torch.where(l == 0, 1.0, l)
    return o.reshape(B, H, D).to(q.dtype)


def paged_attention_split_plain(q, k_pages, v_pages, page_table, seq_lens, pages_per_split,
                                scale=None):
    """The split kernel's function in plain PyTorch, in f32: for each split
    s of pages_per_split pages, each (b, h) row's unnormalised o over the
    live slots of [s·split, (s + 1)·split), its max score m (log2 units,
    scale·log2(e) folded in) and l = Σ exp2(score − m) -> partials (B, H,
    n_split, D + 2) (o, then m, then l). A split with no live slot holds
    (0, NEG_INF, 0)."""
    B, H, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    npm = page_table.shape[1]
    split, n_split = pages_per_split * ps, -(-npm // pages_per_split)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    pt = page_table.long()
    pt = torch.cat([pt, pt.new_zeros(B, n_split * pages_per_split - npm)], 1)  # null page 0
    T = n_split * split
    k = k_pages[pt].float().reshape(B, T, Hkv, D).permute(0, 2, 1, 3)  # (B, Hkv, T, D)
    v = v_pages[pt].float().reshape(B, n_split, split, Hkv, D).permute(0, 3, 1, 2, 4)
    qg = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.matmul(qg, k.transpose(-1, -2)) * (scale * LOG2E)  # (B, Hkv, g, T)
    live = torch.arange(T, device=q.device)[None, :] < seq_lens.long().clamp(max=npm * ps)[:, None]
    live = live[:, None, None, :].reshape(B, 1, 1, n_split, split)
    s = torch.where(live, s.reshape(B, Hkv, -1, n_split, split), NEG_INF)
    m = s.amax(-1)
    e = torch.where(live, torch.exp2(s - m[..., None]), 0.0)
    o = torch.einsum("bhgnt,bhntd->bhgnd", e, v)
    return torch.cat([o, m[..., None], e.sum(-1)[..., None]], -1).reshape(B, H, n_split, D + 2)


def paged_attention_combine_plain(partials, seq_lens, split_tokens, max_tokens, dtype):
    """The combine kernel's function in plain PyTorch: each row's live
    splits (ceil(min(seq_len, max_tokens) / split_tokens) of them) rescaled
    to their common max, o = Σ o_s·w_s / Σ l_s·w_s, rounded to dtype; a row
    with no live split gives zeros."""
    B, H, n_split, D2 = partials.shape
    D = D2 - 2
    n_live = -(-seq_lens.long().clamp(min=0, max=max_tokens) // split_tokens)
    live = (torch.arange(n_split, device=partials.device)[None, :] < n_live[:, None])[:, None, :]
    m = torch.where(live, partials[..., D], NEG_INF)
    w = torch.where(live, torch.exp2(m - m.amax(-1, keepdim=True)), 0.0)
    l = (partials[..., D + 1] * w).sum(-1)
    o = (partials[..., :D] * w[..., None]).sum(-2)
    return (o / torch.where(l == 0, 1.0, l)[..., None]).to(dtype)


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, scale=None):
    """q (B, H, D) against the paged pools (P, page_size, Hkv, D) through
    page_table (B, n_pages_max) int32 and seq_lens (B,) int32 -> (B, H, D).
    seq_lens counts the current token, whose k/v is already in its page;
    page ids must lie in [0, P). On the card: paged_attention_plan's split
    kernel and, with more than one split, its combine; one launch count
    covers both."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table, seq_lens, scale)
    B, H, D = q.shape
    P, ps, Hkv, Dk = k_pages.shape
    npm = page_table.shape[1]
    _check_cuda("paged_attention", q, k_pages, v_pages, page_table, seq_lens)
    _require(q.dtype in _DTYPE_CODE and k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
             "paged_attention: q and the pools must share a float dtype")
    _require(tuple(v_pages.shape) == tuple(k_pages.shape) and Dk == D and H % Hkv == 0,
             f"paged_attention: q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    _require(page_table.dtype == torch.int32 and seq_lens.dtype == torch.int32
             and page_table.shape == (B, npm) and seq_lens.shape == (B,),
             "paged_attention: page_table (B, n_pages_max) and seq_lens (B,) must be int32")
    _require(_paged_shape_ok(q.dtype, H, Hkv, D, ps, npm),
             f"paged_attention: D={D}, {H // Hkv} query heads a kv head, {npm} pages of {ps} unsupported")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    if B:
        plan = paged_attention_plan(B, H, Hkv, D, ps, npm, q.dtype)
        part = [torch.empty(shape, dtype=dt, device=q.device) for shape, dt in plan["scratch"].values()]
        _raise_on(_library().tt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr(), part[0].data_ptr() if part else None, B, Hkv,
            H // Hkv, D, ps, npm, plan["pages_per_split"], float(scale * LOG2E),
            _DTYPE_CODE[q.dtype], _stream(q)), "paged_attention")
        paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_supported(q, k_pages, v_pages, page_table, seq_lens, scale=None) -> bool:
    if getattr(q, "ndim", 0) != 3 or getattr(k_pages, "ndim", 0) != 4:
        return False
    B, H, D = q.shape
    P, ps, Hkv, Dk = k_pages.shape
    tdt = to_torch_dtype(q.dtype)
    return (
        tdt in _DTYPE_CODE and k_pages.dtype == q.dtype and v_pages.dtype == q.dtype
        and tuple(v_pages.shape) == tuple(k_pages.shape) and D == Dk
        and page_table.ndim == 2 and _paged_shape_ok(tdt, H, Hkv, D, ps, page_table.shape[1]) and page_table.shape[0] == B and to_torch_dtype(page_table.dtype) == torch.int32
        and seq_lens.ndim == 1 and seq_lens.shape[0] == B and to_torch_dtype(seq_lens.dtype) == torch.int32
    )


def _paged_attention_impl(q, k_pages, v_pages, page_table, seq_lens, scale=None):
    return paged_attention(q.contiguous(), k_pages, v_pages, page_table, seq_lens, scale)


ex.register_implementation("thunder.paged_attention", _paged_attention_impl,
                           checker=paged_attention_supported)


# ---------------------------------------------------------------------------
# Paged chunk attention: T queries per sequence (chunked prefill, verify)
# ---------------------------------------------------------------------------

_CHUNK_MAX_D = 128  # csrc/paged_chunk_attention.cu instantiates padded head dims 32, 64, 128
# csrc/paged_chunk_attention.cu: keys a gathered tile; query rows a block on
# each route (a split block of one warp, of four warps, or the flash
# forward core's 128-query item); the verify route's split (the decode's)
# and the chunk route's smallest
_CHUNK_TILE_K, _CHUNK_MIN_SPLIT = 64, 128
_CHUNK_ROWS = {"verify": 16, "chunk": 64, "wgmma": _FWD_TILE_Q}
_CHUNK_MAX_SPLITS = 128  # csrc/paged_combine.cuh: kMaxSplitLanes warps' worth


def paged_chunk_plan(B, H, Hkv, T, D, ps, npm, dtype, sms=H100_SMS) -> dict:
    """What paged chunk attention's wrapper allocates and launches for these
    shapes, from the table's width alone (no read of q_pos, so the launches
    are safe to capture in a CUDA graph). ``route``: ``verify`` when a kv
    head's g·T query rows fit one 16-row tile (a split kernel of one-warp
    blocks over the decode's 128-token splits); else ``wgmma`` in bf16 and
    fp16 with pages of a multiple of 8 slots dividing 128 (the flash
    forward's core in paged mode, csrc/flash_fwd_sm90.cu: one item per 128
    queries of a q head, every key of the row walked, one TMA copy a page;
    no split); else ``chunk`` (64-row split blocks of four warps, and the
    largest split from the whole table down to 128 tokens, in halves, that
    gives two waves of ``blocks`` on ``sms`` SMs). ``rows_per_block``,
    ``split_tokens`` (a multiple of the 64-key tile, doubled while the
    splits exceed the combine's 128; the whole table for ``wgmma``),
    ``n_split`` = ceil(npm·ps / split_tokens), ``blocks`` (the split
    kernel's n_split x row tiles x Hkv x B; the core's, one an SM at most),
    ``combine_blocks`` (one warp per (b, h, t), four a block; none when
    n_split is 1: the first kernel then writes o itself), ``scratch`` (name
    -> (shape, dtype): the f32 partials (B, H, T, n_split, D + 2) of o, m
    and l), ``scratch_bytes`` and a block's ``smem_bytes``.
    csrc/paged_chunk_attention.cu takes the route and split it is given."""
    g, S = H // Hkv, npm * ps
    size, dp = dtype.itemsize, 32 if D <= 32 else (64 if D <= 64 else 128)
    if g * T <= _CHUNK_ROWS["verify"]:
        route = "verify"
    elif size == 2 and ps % 8 == 0 and _FWD_TILE_Q % ps == 0:
        route = "wgmma"
    else:
        route = "chunk"
    rows = _CHUNK_ROWS[route]
    if route == "wgmma":  # csrc/flash_fwd_sm90.cu: Smem<DP>, two Q buffers, two K/V stages
        tile_bytes = max(dp, 64) // 64 * _FWD_TILE_Q * 128
        items = -(-T // _FWD_TILE_Q) * H * B
        return {"route": route, "rows_per_block": rows, "split_tokens": S, "n_split": 1,
                "blocks": min(items, sms), "combine_blocks": 0, "scratch": {}, "scratch_bytes": 0,
                "smem_bytes": 6 * tile_bytes + 8 * 8 + 8 + 1024}
    tiles = -(-g * T // rows) * Hkv * B
    ceil_tile = lambda n: -(-n // _CHUNK_TILE_K) * _CHUNK_TILE_K  # noqa: E731
    split = _CHUNK_MIN_SPLIT
    if route == "chunk":
        split = max(split, ceil_tile(S))
        while split > _CHUNK_MIN_SPLIT and tiles * -(-S // split) < 2 * sms:
            split = max(_CHUNK_MIN_SPLIT, ceil_tile(split // 2))
    while -(-S // split) > _CHUNK_MAX_SPLITS:
        split *= 2
    n_split = max(1, -(-S // split))
    scratch = {"partials": ((B, H, T, n_split, D + 2), torch.float32)} if n_split > 1 else {}
    nbytes = sum(math.prod(shape) * dt.itemsize for shape, dt in scratch.values())
    pad, stages = 16 // size, 1 if size == 4 else 2
    probs = rows * (_CHUNK_TILE_K + pad) if size == 4 else 0  # 16-bit p stays in registers
    smem = (size * ((rows + 2 * stages * _CHUNK_TILE_K) * (dp + pad) + probs)
            + 4 * (-(-split // ps) + 1))  # and the split's page ids
    return {"route": route, "rows_per_block": rows, "split_tokens": split, "n_split": n_split,
            "blocks": tiles * n_split,
            "combine_blocks": -(-B * H * T // (_PAGED_THREADS // 32)) if n_split > 1 else 0,
            "scratch": scratch, "scratch_bytes": nbytes, "smem_bytes": smem}


def paged_chunk_attention_plain(q, k_pages, v_pages, page_table, q_pos, scale=None):
    """The kernel's function in plain PyTorch, in f32: gather each
    sequence's pages, mask keys past each query's position, softmax with the
    probabilities rounded to the pool dtype before p·v (l sums the unrounded
    ones, as the kernel and pallasex do); a row with no live key gives
    zeros (the kernel's l == 0 guard)."""
    B, H, T, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    npm = page_table.shape[1]
    S = npm * ps
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    pt = page_table.long()
    k = k_pages[pt].float().reshape(B, S, Hkv, D).permute(0, 2, 1, 3)  # (B, Hkv, S, D)
    v = v_pages[pt].float().reshape(B, S, Hkv, D).permute(0, 2, 1, 3)
    qg = q.float().reshape(B, Hkv, g * T, D)  # row j * T + t: query t of head j
    s = torch.matmul(qg, k.transpose(-1, -2)) * scale  # (B, Hkv, g*T, S)
    live = torch.arange(S, device=q.device)[None, None, :] <= q_pos.long()[:, :, None]  # (B, T, S)
    live = live[:, None, None].expand(B, 1, g, T, S).reshape(B, 1, g * T, S)
    s = torch.where(live, s, float("-inf"))
    m = torch.where(live.any(-1, keepdim=True), s.amax(-1, keepdim=True), 0.0)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    o = torch.matmul(e.to(q.dtype).float(), v) / torch.where(l == 0, 1.0, l)
    return o.reshape(B, H, T, D).to(q.dtype)


def paged_chunk_split_plain(q, k_pages, v_pages, page_table, q_pos, split_tokens, scale=None):
    """The split kernel's function in plain PyTorch, in f32: for each split
    s of split_tokens keys, each (b, h, t) row's unnormalised o over its
    live keys in [s·split, (s + 1)·split) (positions <= q_pos[b, t], within
    the table), its max score m (log2 units, scale·log2(e) folded in) and l
    = Σ exp2(score − m) -> partials (B, H, T, n_split, D + 2) (o, then m,
    then l). As the kernel, the probabilities are rounded to q's dtype
    before p·v against the split's max, not the row's (the kernel's running
    max within the split ends there); l sums the unrounded ones. A split
    with no live key of a row holds (0, NEG_INF, 0)."""
    B, H, T, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    npm = page_table.shape[1]
    S, g = npm * ps, H // Hkv
    n_split = max(1, -(-S // split_tokens))
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    pt = page_table.long()
    k = k_pages[pt].float().reshape(B, S, Hkv, D).permute(0, 2, 1, 3)  # (B, Hkv, S, D)
    v = v_pages[pt].float().reshape(B, S, Hkv, D).permute(0, 2, 1, 3)
    pad = n_split * split_tokens - S  # keys past the table: never live
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (k, v))
    qg = q.float().reshape(B, Hkv, g * T, D)  # row j * T + t: query t of head j
    s = torch.matmul(qg, k.transpose(-1, -2)) * (scale * LOG2E)  # (B, Hkv, g*T, S + pad)
    keys = torch.arange(n_split * split_tokens, device=q.device)
    live = (keys[None, None, :] <= q_pos.long()[:, :, None]) & (keys < S)  # (B, T, S + pad)
    live = live[:, None, None].expand(B, 1, g, T, -1).reshape(B, 1, g * T, n_split, split_tokens)
    s = torch.where(live, s.reshape(B, Hkv, g * T, n_split, split_tokens), NEG_INF)
    m = s.amax(-1)
    e = torch.where(live, torch.exp2(s - m[..., None]), 0.0)
    o = torch.einsum("bhrnt,bhntd->bhrnd", e.to(q.dtype).float(),
                     v.reshape(B, Hkv, n_split, split_tokens, D))
    part = torch.cat([o, m[..., None], e.sum(-1)[..., None]], -1)  # (B, Hkv, g*T, n_split, D + 2)
    return part.reshape(B, H, T, n_split, D + 2)


def paged_chunk_combine_plain(partials, q_pos, split_tokens, max_tokens, dtype):
    """The combine kernel's function for chunk attention in plain PyTorch:
    paged_attention_combine_plain over each (b, t)'s rows, with the live
    length q_pos + 1 -> (B, H, T, D) in dtype."""
    B, H, T, n_split, D2 = partials.shape
    rows = partials.permute(0, 2, 1, 3, 4).reshape(B * T, H, n_split, D2)
    o = paged_attention_combine_plain(rows, q_pos.reshape(B * T) + 1, split_tokens, max_tokens, dtype)
    return o.reshape(B, T, H, D2 - 2).permute(0, 2, 1, 3)


def paged_chunk_attention(q, k_pages, v_pages, page_table, q_pos, scale=None):
    """q (B, H, T, D) against the paged pools (P, page_size, Hkv, D) through
    page_table (B, n_pages_max) int32, query (b, ·, t) attending the key
    positions <= q_pos[b, t] (q_pos (B, T) int32) -> (B, H, T, D). Each
    query's own k/v is already in its page; page ids must lie in [0, P). On
    the card: paged_chunk_plan's split kernel on its route and, with more
    than one split, the combine; one launch count covers both."""
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(q, k_pages, v_pages, page_table, q_pos, scale)
    B, H, T, D = q.shape
    P, ps, Hkv, Dk = k_pages.shape
    npm = page_table.shape[1]
    _check_cuda("paged_chunk_attention", q, k_pages, v_pages, page_table, q_pos)
    _require(q.dtype in _DTYPE_CODE and k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
             "paged_chunk_attention: q and the pools must share a float dtype")
    _require(tuple(v_pages.shape) == tuple(k_pages.shape) and Dk == D and H % Hkv == 0,
             f"paged_chunk_attention: q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    _require(page_table.dtype == torch.int32 and q_pos.dtype == torch.int32
             and page_table.shape == (B, npm) and q_pos.shape == (B, T),
             "paged_chunk_attention: page_table (B, n_pages_max) and q_pos (B, T) must be int32")
    _require(D % _vec(q.dtype) == 0 and D <= _CHUNK_MAX_D,
             f"paged_chunk_attention: head dim {D} unsupported for {q.dtype}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    if q.numel():
        plan = paged_chunk_plan(B, H, Hkv, T, D, ps, npm, q.dtype)
        part = [torch.empty(shape, dtype=dt, device=q.device) for shape, dt in plan["scratch"].values()]
        _raise_on(_library().tt_paged_chunk_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), part[0].data_ptr() if part else None, B, H, Hkv, T,
            D, P, ps, npm, plan["rows_per_block"], plan["split_tokens"], float(scale * LOG2E),
            _DTYPE_CODE[q.dtype], _stream(q)), "paged_chunk_attention")
        paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0


def paged_chunk_attention_supported(q, k_pages, v_pages, page_table, q_pos, scale=None) -> bool:
    """Hopper's checker: 4-d q and pools of one float dtype, H % Hkv == 0,
    a head dim that is a multiple of the 16-byte vector and at most 128, and
    int32 page_table (B, n_pages_max) and q_pos (B, T). Any T and page size:
    the kernel gathers key rows one by one and masks the ragged edges; the
    plan doubles its split until the combine takes the table."""
    if getattr(q, "ndim", 0) != 4 or getattr(k_pages, "ndim", 0) != 4:
        return False
    B, H, T, D = q.shape
    P, ps, Hkv, Dk = k_pages.shape
    tdt = to_torch_dtype(q.dtype)
    return (
        tdt in _DTYPE_CODE and k_pages.dtype == q.dtype and v_pages.dtype == q.dtype
        and tuple(v_pages.shape) == tuple(k_pages.shape) and D == Dk and H % Hkv == 0
        and D % _vec(tdt) == 0 and D <= _CHUNK_MAX_D
        and page_table.ndim == 2 and page_table.shape[0] == B
        and to_torch_dtype(page_table.dtype) == torch.int32
        and tuple(q_pos.shape) == (B, T) and to_torch_dtype(q_pos.dtype) == torch.int32
    )


def _paged_chunk_attention_impl(q, k_pages, v_pages, page_table, q_pos, scale=None):
    return paged_chunk_attention(q.contiguous(), k_pages, v_pages, page_table.contiguous(),
                                 q_pos.contiguous(), scale)


ex.register_implementation("thunder.paged_chunk_attention", _paged_chunk_attention_impl,
                           checker=paged_chunk_attention_supported)


# ---------------------------------------------------------------------------
# Flash attention with RoPE applied in the kernel: forward and backward
# ---------------------------------------------------------------------------

_FLASH_MAX_D = 128  # the flash kernels instantiate padded head dims up to 128


def _rope_plain(x, cos, sin):
    """Half-split RoPE in f32: x·cos + rotate_half(x)·sin."""
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], -1) * sin


def _rope_vjp_plain(dxr, cos, sin):
    """VJP of _rope_plain: dxr·cos + rotate_halfᵀ(dxr·sin)."""
    h = dxr.shape[-1] // 2
    ds = dxr * sin
    return dxr * cos + torch.cat([ds[..., h:], -ds[..., :h]], -1)


def _flash_plain_scores(q, k, cos, sin, causal, scale):
    """Roped q/k (in f32, rounded to the input dtype as the kernels round
    them; q/k as they are when cos is None), k repeated over the GQA group,
    and the masked scores."""
    B, H, T, D = q.shape
    g = H // k.shape[1]
    if cos is None:
        qr, kr = q.float(), k.float()
    else:
        cos, sin = cos.float(), sin.float()
        qr = _rope_plain(q.float(), cos, sin).to(q.dtype).float()
        kr = _rope_plain(k.float(), cos, sin).to(k.dtype).float()
    kr = kr.repeat_interleave(g, 1)
    s = torch.matmul(qr, kr.transpose(-1, -2)) * scale
    if causal:
        live = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(live, s, float("-inf"))
    return qr, kr, s


def flash_rope_attention_plain(q, k, v, cos, sin, causal=True, scale=None):
    """The forward kernel's function in plain PyTorch, f32 step by step:
    rope, masked softmax, natural-log lse. -> (o in q's dtype, lse f32)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    g = q.shape[1] // k.shape[1]
    _, _, s = _flash_plain_scores(q, k, cos, sin, causal, scale)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    o = torch.matmul(p, v.float().repeat_interleave(g, 1))
    return o.to(q.dtype), lse


def flash_rope_attention_backward_plain(q, k, v, o, lse, cos, sin, do, causal=True, scale=None):
    """The backward kernels' function in plain PyTorch, f32 step by step:
    P from the saved lse, dP = dO·Vᵀ, dS = P·(dP − delta)·scale with delta =
    rowsum(dO·O), dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO (summed over the GQA
    group), then the RoPE VJP on dQ and dK (none when cos is None).
    -> (dq, dk, dv)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype).float()
    qr, kr, s = _flash_plain_scores(q, k, cos, sin, causal, scale)
    delta = (do * o.float()).sum(-1)
    dqr, dkr, dv = _flash_backward_f32(qr, kr, v, lse, do, delta, s, scale)
    if cos is not None:
        cos, sin = cos.float(), sin.float()
        dqr, dkr = _rope_vjp_plain(dqr, cos, sin), _rope_vjp_plain(dkr, cos, sin)
    return dqr.to(q.dtype), dkr.to(k.dtype), dv.to(v.dtype)


def _flash_backward_f32(qr, kr, v, lse, do, delta, s, scale):
    """The products of the backward in f32 from the (roped) q and the (roped,
    group-repeated) k, both f32, the masked scores s and delta: -> (dq, dk,
    dv) in f32 before any RoPE VJP, dk and dv summed over the GQA group."""
    B, H, T, D = qr.shape
    Hkv = v.shape[1]
    g = H // Hkv
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(do, v.float().repeat_interleave(g, 1).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dqr = torch.matmul(ds, kr)
    dkr = torch.matmul(ds.transpose(-1, -2), qr).reshape(B, Hkv, g, T, D).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), do).reshape(B, Hkv, g, T, D).sum(2)
    return dqr, dkr, dv


def flash_backward_prologue_plain(q, k, o, do, cos=None, sin=None):
    """The backward prologue kernel's function (csrc/flash_bwd_sm90.cu,
    flash_bwd_prologue) in plain PyTorch: -> (q and k roped in f32 and
    rounded to their dtype (as they are without cos), do rounded to q's
    dtype, delta = rowsum(do·o) in f32 (B, H, T))."""
    do = do.to(q.dtype)
    delta = (do.float() * o.float()).sum(-1)
    if cos is None:
        return q, k, do, delta
    cos, sin = cos.float(), sin.float()
    return (_rope_plain(q.float(), cos, sin).to(q.dtype), _rope_plain(k.float(), cos, sin).to(k.dtype),
            do, delta)


def flash_backward_epilogue_plain(dq_acc, dk_acc, dv_acc, cos, sin, dtype):
    """The backward epilogue kernel's function (flash_bwd_epilogue) in plain
    PyTorch: the RoPE VJP on the f32 dq and dk accumulators (none when cos
    is None), then dq, dk, dv rounded to dtype."""
    if cos is not None:
        cos, sin = cos.float(), sin.float()
        dq_acc, dk_acc = _rope_vjp_plain(dq_acc, cos, sin), _rope_vjp_plain(dk_acc, cos, sin)
    return dq_acc.to(dtype), dk_acc.to(dtype), dv_acc.to(dtype)


def flash_forward_prologue_plain(q, k, cos, sin):
    """The forward prologue kernel's function (csrc/flash_fwd_sm90.cu,
    flash_fwd_prologue) in plain PyTorch: q and k roped in f32 and rounded
    to their dtype. The core (flash_attention_plain) then takes them as
    they are."""
    cos, sin = cos.float(), sin.float()
    return _rope_plain(q.float(), cos, sin).to(q.dtype), _rope_plain(k.float(), cos, sin).to(k.dtype)




def flash_forward_plan(B, H, Hkv, T, D, dtype, rope=False, sms=H100_SMS) -> dict:
    """What the flash forward's wrapper allocates and launches for these
    shapes on a card of ``sms`` SMs: ``scratch`` (name -> (shape, dtype),
    each allocated with torch.empty and handed to the kernels), its total
    ``scratch_bytes``, the ``tiles`` of queries the kernel that does the
    products works through and its ``blocks``.

    bf16/fp16 run the persistent wgmma/TMA core (csrc/flash_fwd_sm90.cu):
    one block an SM, at most one per tile (128 queries of one q head and
    batch); with RoPE its prologue first ropes q and k into ``qk_roped``,
    q's B·H slabs of (T, D) then k's B·Hkv (the kernels refuse fewer rows).
    f32 runs csrc/flash_rope_fwd.cu: one block per tile of 64 queries,
    roping its tiles itself; no scratch."""
    f32 = dtype == torch.float32
    tiles = -(-T // (_FWD_TILE_Q_F32 if f32 else _FWD_TILE_Q)) * H * B
    scratch = {}
    if rope and not f32:
        scratch["qk_roped"] = ((B * (H + Hkv), T, D), dtype)
    nbytes = sum(math.prod(shape) * dt.itemsize for shape, dt in scratch.values())
    return {"tiles": tiles, "blocks": tiles if f32 else min(tiles, sms), "scratch": scratch,
            "scratch_bytes": nbytes}


def ring_forward_plan(B, H, Hkv, T, D, dtype, q_off, k_off, causal=True, sms=H100_SMS) -> dict:
    """What one forward ring step launches for these shapes and offsets (no
    tensor read: the launch is safe to capture in a CUDA graph): ``future``
    (a causal shard wholly in the future: nothing is launched and the
    accumulators stay as they are), ``items``, ``blocks`` and, for bf16 and
    fp16, ``tiles``: the flash forward core's walk in ring mode
    (csrc/flash_fwd_sm90.cu: item_at), one entry per live 128-query tile in
    the order the items come, each ``(q0, key_tiles, masked)`` with the
    128-key tiles it walks (from tile 0) and those among them on which the
    mask runs (the shifted diagonal's or the ragged edge's). Query q_off + i
    sees key k_off + j iff j <= i + (q_off − k_off). f32 runs
    csrc/ring_flash_fwd.cu: one block per 64-query tile, head and batch
    (a block with no visible key returns at once); no ``tiles``."""
    future = bool(causal) and k_off > q_off + T - 1
    if dtype == torch.float32:
        n = 0 if future else -(-T // _FWD_TILE_Q_F32) * H * B
        return {"future": future, "items": n, "blocks": n}
    shift, tq = q_off - k_off, _FWD_TILE_Q
    n_qt = n_kt_all = -(-T // tq)
    qt0 = -shift // tq if causal and shift < 0 else 0
    tiles = []
    for qi in range(0 if future else n_qt - qt0):
        q0 = (n_qt - 1 - qi if causal else qi) * tq
        n_kt = min(n_kt_all, -(-(min(q0 + tq, T) + shift) // tq)) if causal else n_kt_all
        masked = tuple(n for n in range(n_kt) if (n + 1) * tq > T or (
            causal and any((n + 1) * tq - 1 > q0 + 64 * wg + shift for wg in (0, 1))))
        tiles.append((q0, n_kt, masked))
    items = len(tiles) * H * B
    return {"future": future, "items": items, "blocks": min(items, sms), "tiles": tiles}


def _flash_forward(name, q, k, v, cos, sin, causal, scale):
    """The card's flash forward (RoPE when cos is given): allocates
    flash_forward_plan's scratch and launches tt_flash_rope_fwd or
    tt_flash_fwd. -> (o, lse)."""
    _check_flash(name, q, k, v, cos, sin)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if not q.numel():
        return o, lse
    plan = flash_forward_plan(B, H, Hkv, T, D, q.dtype, rope=cos is not None)
    shape = (B, H, Hkv, T, D, int(bool(causal)), float(scale * LOG2E), _DTYPE_CODE[q.dtype],
             _stream(q))
    lib = _library()
    if cos is None:
        rc = lib.tt_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                              *shape)
    else:
        buf = [torch.empty(shp, dtype=dt, device=q.device) for shp, dt in plan["scratch"].values()]
        ptr, rows = (buf[0].data_ptr(), buf[0].numel() // D) if buf else (None, 0)
        rc = lib.tt_flash_rope_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
                                   sin.data_ptr(), o.data_ptr(), lse.data_ptr(), ptr, rows, *shape)
    _raise_on(rc, name)
    return o, lse


# csrc/flash_bwd_sm90.cu: keys per block; queries per streamed tile (128 at
# head dims up to 64, else 64: its tile_queries, which refuses a pitch that
# is not a whole number of them)
_BWD_TILE_K = 128


def _bwd_tile_q(D: int) -> int:
    return 128 if D <= 64 else 64


def flash_backward_plan(B, H, Hkv, T, D, dtype, do_dtype=None, rope=False, ring=False) -> dict:
    """What the flash backward's wrapper allocates and launches for these
    shapes: ``scratch`` (name -> (shape, dtype), each allocated with
    torch.empty and handed to the kernels), its total ``scratch_bytes``, the
    row ``pitch`` of delta and lse2 (handed to the kernels, which refuse one
    they would read past) and the ``blocks`` of the kernels that do the
    products. This is the one statement of these rules: the kernels take the
    scratch they are given.

    bf16/fp16 run the one-pass wgmma core (csrc/flash_bwd_sm90.cu): one block
    per (128-key tile, q head, batch); delta and lse·log2(e) padded to a
    whole tile of queries (128 at D <= 64, else 64); an f32 dq accumulator;
    dk's and dv's f32 accumulators with GQA (the group's heads add into
    them), dk's also with RoPE at a head dim other than 64 or 128 (the
    epilogue takes its VJP; at 64 and 128 the core does); the roped q and k
    with RoPE; do rounded to q's dtype when it is wider. f32 runs the
    two-pass kernels (csrc/flash_rope_bwd.cu: 64-row dq blocks and 64-key
    dk/dv blocks) and needs delta only.

    With ``ring`` it is one ring backward step's (tt_ring_flash_bwd): bf16
    and fp16 run the same core at the step's offsets, from a prologue that
    copies the caller's lse·log2(e) and delta into the padded rows; the f32
    dq, dk, dv outputs are the core's accumulators, so nothing else is
    scratch. f32 runs csrc/ring_flash_bwd.cu's two passes (the same blocks
    as the flash f32 route) on the caller's lse and delta: no scratch."""
    f32 = torch.float32
    do_dtype = do_dtype or dtype
    if ring:
        pitch = T if dtype == f32 else -(-T // _bwd_tile_q(D)) * _bwd_tile_q(D)
        scratch = {} if dtype == f32 else {"delta": ((B, H, pitch), f32), "lse2": ((B, H, pitch), f32)}
        blocks = (-(-T // 64) * H * B + -(-T // 64) * Hkv * B if dtype == f32
                  else -(-T // _BWD_TILE_K) * H * B)
    elif dtype == f32:
        pitch = T
        scratch = {"delta": ((B, H, T), f32)}
        blocks = -(-T // 64) * H * B + -(-T // 64) * Hkv * B
    else:
        g = H // Hkv
        pitch = -(-T // _bwd_tile_q(D)) * _bwd_tile_q(D)
        scratch = {"delta": ((B, H, pitch), f32), "lse2": ((B, H, pitch), f32),
                   "dq_acc": ((B, H, T, D), f32)}
        if g > 1 or (rope and D not in (64, 128)):  # else dk's VJP is taken in the core
            scratch["dk_acc"] = ((B, Hkv, T, D), f32)
        if g > 1:
            scratch["dv_acc"] = ((B, Hkv, T, D), f32)
        if rope:
            scratch["q_roped"] = ((B, H, T, D), dtype)
            scratch["k_roped"] = ((B, Hkv, T, D), dtype)
        if do_dtype != dtype:
            scratch["do"] = ((B, H, T, D), dtype)
        blocks = -(-T // _BWD_TILE_K) * H * B
    nbytes = sum(math.prod(shape) * dt.itemsize for shape, dt in scratch.values())
    return {"blocks": blocks, "scratch": scratch, "scratch_bytes": nbytes, "pitch": pitch}


def _flash_backward(name, q, k, v, o, lse, do, cos, sin, causal, scale):
    """The card's flash backward (RoPE when cos is given): allocates
    flash_backward_plan's scratch and launches tt_flash_rope_bwd or
    tt_flash_bwd, which take delta and the rest in their prologue."""
    if do.dtype != q.dtype and do.dtype != torch.float32:
        do = do.to(q.dtype)
    do = do.contiguous()
    _check_flash_backward(name, q, k, v, o, lse, do, cos, sin)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if not q.numel():
        return dq, dk, dv
    plan = flash_backward_plan(B, H, Hkv, T, D, q.dtype, do.dtype, rope=cos is not None)
    buf = {n: torch.empty(shape, dtype=dt, device=q.device) for n, (shape, dt) in plan["scratch"].items()}
    ptr = lambda n: buf[n].data_ptr() if n in buf else None  # noqa: E731
    scratch = [ptr(n) for n in ("delta", "lse2", "dq_acc", "dk_acc", "dv_acc")]
    shape = (B, H, Hkv, T, D, plan["pitch"], int(bool(causal)), float(scale),
             _DTYPE_CODE[q.dtype], _DTYPE_CODE[do.dtype], _stream(q))
    lib = _library()
    if cos is None:
        rc = lib.tt_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                              lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *scratch,
                              ptr("do"), *shape)
    else:
        rc = lib.tt_flash_rope_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   do.data_ptr(), lse.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *scratch,
                                   ptr("q_roped"), ptr("k_roped"), ptr("do"), *shape)
    _raise_on(rc, name)
    return dq, dk, dv


def _check_flash(name, q, k, v, cos=None, sin=None) -> None:
    B, H, T, D = q.shape
    _check_cuda(name, q, k, v, *(() if cos is None else (cos, sin)))
    _require(q.dtype in _DTYPE_CODE and k.dtype == q.dtype and v.dtype == q.dtype,
             f"{name}: q, k and v must share a float dtype")
    _require(k.ndim == 4 and tuple(k.shape) == tuple(v.shape) and k.shape[0] == B
             and k.shape[2] == T and k.shape[3] == D and H % k.shape[1] == 0,
             f"{name}: q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    _require(D % 2 == 0 and D % _vec(q.dtype) == 0 and D <= _FLASH_MAX_D,
             f"{name}: head dim {D} unsupported for {q.dtype}")
    _require(cos is None or (cos.dtype == torch.float32 and tuple(cos.shape) == (T, D)
                             and tuple(sin.shape) == (T, D) and sin.dtype == torch.float32),
             f"{name}: cos/sin must be f32 ({T}, {D})")


def _check_flash_backward(name, q, k, v, o, lse, do, cos=None, sin=None) -> None:
    _check_flash(name, q, k, v, cos, sin)
    _check_cuda(name, q, o, lse, do)
    _require(tuple(o.shape) == tuple(q.shape) and tuple(do.shape) == tuple(q.shape)
             and tuple(lse.shape) == tuple(q.shape[:3]) and lse.dtype == torch.float32,
             f"{name}: o/do must be q's shape and lse f32 (B, H, T)")
    _require(o.dtype == q.dtype and do.dtype in (q.dtype, torch.float32),
             f"{name}: o must be q's dtype and do q's dtype or f32")


def flash_rope_attention(q, k, v, cos, sin, causal=True, scale=None):
    """q (B, H, T, D), k/v (B, Hkv, T, D) pre-RoPE, cos/sin (T, D)
    duplicated-half caches -> (o (B, H, T, D) in q's dtype, lse (B, H, T)
    f32, natural log). kv head = q head // (H // Hkv)."""
    if q.device.type == "cpu":
        return flash_rope_attention_plain(q, k, v, cos, sin, causal, scale)
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    out = _flash_forward("flash_rope_attention", q, k, v, cos, sin, causal, scale)
    if q.numel():
        flash_rope_attention.launches += 1
    return out


flash_rope_attention.launches = 0


def flash_rope_attention_backward(q, k, v, o, lse, cos, sin, do, causal=True, scale=None):
    """dq, dk, dv of flash_rope_attention for the cotangent do of o. A wider
    cotangent (f32 under autocast) is rounded to q's dtype first, as
    pallasex does; delta = rowsum(do·o) is taken in f32 before the
    products, as pallasex takes it outside its pallas_call: on the card by
    the kernels' prologue (csrc/flash_bwd_sm90.cu)."""
    if q.device.type == "cpu":
        return flash_rope_attention_backward_plain(q, k, v, o, lse, cos, sin, do, causal, scale)
    cos, sin = cos.float().contiguous(), sin.float().contiguous()
    out = _flash_backward("flash_rope_attention_backward", q, k, v, o, lse, do, cos, sin, causal,
                          scale)
    if q.numel():
        flash_rope_attention_backward.launches += 1
    return out


flash_rope_attention_backward.launches = 0


def rope_sdpa_supported(q, k, v, cos, sin, is_causal=True, scale=None) -> bool:
    """Hopper's checker: the q/k/v that flash_attention_supported claims,
    and cos/sin (T, D) of a float dtype (pallasex.rope_sdpa_supported
    builds on its sdpa checker the same way)."""
    if not flash_attention_supported(q, k, v):
        return False
    T, D = q.shape[2], q.shape[3]
    return (tuple(cos.shape) == (T, D) and tuple(sin.shape) == (T, D)
            and cos.dtype.is_float and sin.dtype.is_float)


def _rope_sdpa_impl(q, k, v, cos, sin, is_causal=True, scale=None):
    o, _ = flash_rope_attention(q.contiguous(), k.contiguous(), v.contiguous(), cos, sin,
                                is_causal, scale)
    return o


def _rope_flash_fwd_impl(q, k, v, cos, sin, causal, scale):
    return flash_rope_attention(q.contiguous(), k.contiguous(), v.contiguous(), cos, sin,
                                causal, scale)


def _rope_flash_bwd_impl(q, k, v, o, lse, cos, sin, causal, scale, do):
    return flash_rope_attention_backward(q.contiguous(), k.contiguous(), v.contiguous(), o, lse,
                                         cos, sin, do, causal, scale)


ex.register_implementation("thunder.rope_sdpa", _rope_sdpa_impl, checker=rope_sdpa_supported)

rope_flash_fwd = ex.register_operator(
    "rope_flash_fwd",
    meta=lambda q, k, v, cos, sin, causal, scale: (
        TensorProxy(shape=q.shape, dtype=q.dtype, device=q.device),
        TensorProxy(shape=q.shape[:-1], dtype=dtypes.float32, device=q.device),
    ),
    fn=_rope_flash_fwd_impl,
)
rope_flash_bwd = ex.register_operator(
    "rope_flash_bwd",
    meta=lambda q, k, v, o, lse, cos, sin, causal, scale, do: (
        TensorProxy(shape=q.shape, dtype=q.dtype, device=q.device),
        TensorProxy(shape=k.shape, dtype=k.dtype, device=k.device),
        TensorProxy(shape=v.shape, dtype=v.dtype, device=v.device),
    ),
    fn=_rope_flash_bwd_impl,
)


@register_augmented_forward("thunder.rope_sdpa")
def _rope_sdpa_aug(q, k, v, cos, sin, is_causal=True, scale=None):
    if not rope_sdpa_supported(q, k, v, cos, sin, is_causal, scale):
        return NotImplemented  # decompose: the composite rope + sdpa rules apply
    o, lse = rope_flash_fwd(q, k, v, cos, sin, bool(is_causal), scale)
    return VJPResult(o, (q, k, v, o, lse, cos, sin, bool(is_causal), scale))


@register_backward("thunder.rope_sdpa")
def _rope_sdpa_bwd(q, k, v, o, lse, cos, sin, causal, scale, g):
    dq, dk, dv = rope_flash_bwd(q, k, v, o, lse, cos, sin, causal, scale, g)
    return dq, dk, dv, None, None, None, None


class FlashRopeAttention(torch.autograd.Function):
    """flash_rope_attention with flash_rope_attention_backward as its
    gradient, for tensor-level use: ``FlashRopeAttention.apply(q, k, v,
    cos, sin, causal, scale)`` -> o. cos/sin get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, causal=True, scale=None):
        o, lse = flash_rope_attention(q.contiguous(), k.contiguous(), v.contiguous(), cos, sin,
                                      causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, cos, sin)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, cos, sin = ctx.saved_tensors
        dq, dk, dv = flash_rope_attention_backward(q.contiguous(), k.contiguous(), v.contiguous(),
                                                   o, lse, cos, sin, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# Flash attention without RoPE (scaled_dot_product_attention): forward and
# backward
# ---------------------------------------------------------------------------


def flash_attention_plain(q, k, v, causal=True, scale=None):
    """The forward kernel's function in plain PyTorch, f32 step by step:
    masked softmax, natural-log lse. -> (o in q's dtype, lse f32)."""
    return flash_rope_attention_plain(q, k, v, None, None, causal, scale)


def flash_attention_backward_plain(q, k, v, o, lse, do, causal=True, scale=None):
    """The backward kernels' function in plain PyTorch (the RoPE-free case
    of flash_rope_attention_backward_plain). -> (dq, dk, dv)."""
    return flash_rope_attention_backward_plain(q, k, v, o, lse, None, None, do, causal, scale)


def flash_attention(q, k, v, causal=True, scale=None):
    """q (B, H, T, D), k/v (B, Hkv, T, D) -> (o (B, H, T, D) in q's dtype,
    lse (B, H, T) f32, natural log). kv head = q head // (H // Hkv); the
    causal mask keeps key <= query from position 0 of both."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    out = _flash_forward("flash_attention", q, k, v, None, None, causal, scale)
    if q.numel():
        flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_backward(q, k, v, o, lse, do, causal=True, scale=None):
    """dq, dk, dv of flash_attention for the cotangent do of o; dk/dv are
    summed over the GQA group. A wider cotangent (f32 under autocast) is
    rounded to q's dtype first, and delta = rowsum(do·o) is taken in f32
    before the products, as pallasex.flash_attention_backward does: on the
    card by the kernels' prologue."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal, scale)
    out = _flash_backward("flash_attention_backward", q, k, v, o, lse, do, None, None, causal, scale)
    if q.numel():
        flash_attention_backward.launches += 1
    return out


flash_attention_backward.launches = 0


def flash_attention_supported(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None,
                              enable_gqa=False) -> bool:
    """Hopper's checker for scaled_dot_product_attention: no mask and no
    dropout; 4-d q/k/v of one float dtype, k and v of one shape, T == Tk
    (pallasex.flash_attention_supported's rule), H % Hkv == 0, an even D that
    is a multiple of the 16-byte vector and at most 128; causal or full. Any
    T: the kernels mask the ragged edge (the TPU's T >= 1024 and % 512 rules
    are its launch amortization and tiling). Everything else runs as the
    ltorch decomposition."""
    if attn_mask is not None or dropout_p:
        return False
    if getattr(q, "ndim", 0) != 4 or getattr(k, "ndim", 0) != 4 or getattr(v, "ndim", 0) != 4:
        return False
    B, H, T, D = q.shape
    tdt = to_torch_dtype(q.dtype)
    return (
        tdt in _DTYPE_CODE and k.dtype == q.dtype and v.dtype == q.dtype
        and tuple(k.shape) == tuple(v.shape) and k.shape[0] == B and k.shape[2] == T
        and k.shape[3] == D and H % k.shape[1] == 0
        and D % 2 == 0 and D % _vec(tdt) == 0 and D <= _FLASH_MAX_D
    )


def _sdpa_impl(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None, enable_gqa=False):
    o, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), is_causal, scale)
    return o


def _flash_fwd_impl(q, k, v, causal, scale):
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal, scale)


def _flash_bwd_impl(q, k, v, o, lse, causal, scale, do):
    return flash_attention_backward(q.contiguous(), k.contiguous(), v.contiguous(), o, lse, do,
                                    causal, scale)


ex.register_implementation("torch.nn.functional.scaled_dot_product_attention", _sdpa_impl,
                           checker=flash_attention_supported)

flash_attention_fwd = ex.register_operator(
    "flash_attention_fwd",
    meta=lambda q, k, v, causal, scale: (
        TensorProxy(shape=q.shape, dtype=q.dtype, device=q.device),
        TensorProxy(shape=q.shape[:-1], dtype=dtypes.float32, device=q.device),
    ),
    fn=_flash_fwd_impl,
)
flash_attention_bwd = ex.register_operator(
    "flash_attention_bwd",
    meta=lambda q, k, v, o, lse, causal, scale, do: (
        TensorProxy(shape=q.shape, dtype=q.dtype, device=q.device),
        TensorProxy(shape=k.shape, dtype=k.dtype, device=k.device),
        TensorProxy(shape=v.shape, dtype=v.dtype, device=v.device),
    ),
    fn=_flash_bwd_impl,
)


@register_augmented_forward("torch.nn.functional.scaled_dot_product_attention")
def _sdpa_aug(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None, enable_gqa=False):
    if not flash_attention_supported(q, k, v, attn_mask, dropout_p, is_causal, scale):
        return NotImplemented  # decompose: the composite sdpa rules apply
    o, lse = flash_attention_fwd(q, k, v, bool(is_causal), scale)
    return VJPResult(o, (q, k, v, o, lse, bool(is_causal), scale))


@register_backward("torch.nn.functional.scaled_dot_product_attention")
def _sdpa_bwd(q, k, v, o, lse, causal, scale, g):
    return flash_attention_bwd(q, k, v, o, lse, causal, scale, g)


class FlashAttention(torch.autograd.Function):
    """flash_attention with flash_attention_backward as its gradient, for
    tensor-level use: ``FlashAttention.apply(q, k, v, causal, scale)`` -> o."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, scale=None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# Fused cross-entropy forward
# ---------------------------------------------------------------------------


def cross_entropy_plain(logits, targets):
    """The kernel's function in plain PyTorch, in f32: per row lse and lse −
    logits[target]; a target outside [0, V) picks 0 (pallasex._xent_kernel's
    one-hot). -> (loss (N,) f32, lse (N,) f32)."""
    lg = logits.float()
    V = lg.shape[1]
    lse = torch.logsumexp(lg, 1)
    t = targets.long()
    valid = (t >= 0) & (t < V)
    picked = torch.where(valid, lg.gather(1, t.clamp(0, V - 1)[:, None])[:, 0], 0.0)
    return lse - picked, lse


def cross_entropy(logits, targets):
    """logits (N, V) f32, bf16 or f16 and integer targets (N,) -> (loss,
    lse), both f32 (N,)."""
    if logits.device.type == "cpu":
        return cross_entropy_plain(logits, targets)
    N, V = logits.shape
    targets = targets.to(torch.int64).contiguous()
    _check_cuda("cross_entropy", logits, targets)
    _require(logits.dtype in _DTYPE_CODE, f"cross_entropy: logits dtype {logits.dtype} is not a float")
    _require(tuple(targets.shape) == (N,), f"cross_entropy: targets {tuple(targets.shape)} must be ({N},)")
    loss = torch.empty(N, dtype=torch.float32, device=logits.device)
    lse = torch.empty(N, dtype=torch.float32, device=logits.device)
    if N and V:
        _raise_on(_library().tt_cross_entropy(logits.data_ptr(), targets.data_ptr(), loss.data_ptr(),
                                              lse.data_ptr(), N, V, _DTYPE_CODE[logits.dtype],
                                              _stream(logits)), "cross_entropy")
        cross_entropy.launches += 1
    return loss, lse


cross_entropy.launches = 0


def cross_entropy_supported(logits, target, weight=None, ignore_index=-100, reduction="mean",
                            label_smoothing=0.0) -> bool:
    """Hopper's checker: 2-d float logits (N, V), integer targets (N,), no
    weight, no smoothing, the mean. Any N and V: pallasex's N % 8 and
    V % 128 rules are TPU tiling (GPT-2's V = 50304 and Llama's 32000 both
    pass)."""
    if weight is not None or label_smoothing or reduction != "mean":
        return False
    if getattr(logits, "ndim", 0) != 2 or getattr(target, "ndim", 0) != 1:
        return False
    return (to_torch_dtype(logits.dtype) in _DTYPE_CODE and not target.dtype.is_inexact
            and target.shape[0] == logits.shape[0])


def _cross_entropy_impl(logits, target, weight=None, ignore_index=-100, reduction="mean",
                        label_smoothing=0.0):
    """pallasex._xent_impl: the kernel's per-row loss, ignore_index masked,
    the mean over the valid rows (f32)."""
    loss, _ = cross_entropy(logits.contiguous(), target)
    valid = target != ignore_index
    loss = torch.where(valid, loss, 0.0)
    return loss.sum() / valid.sum().float().clamp(min=1.0)


ex.register_implementation("torch.nn.functional.cross_entropy", _cross_entropy_impl,
                           checker=cross_entropy_supported)


# ---------------------------------------------------------------------------
# Weight-only quantized linears: int8 and NF4 (transforms/quantization.py)
# ---------------------------------------------------------------------------

# Rows of x (tokens) the checkers claim: the decode steps (M = the batch) and
# prefill buckets up to 512, pallasex's bound. Larger M runs as the
# decomposition: dequantized bf16 weights and one torch.matmul.
QUANT_MAX_M = 512
_QUANT_X_DTYPES = (torch.float32, torch.bfloat16)
# csrc/weight_only_linear.cuh: units of a weight row's bytes. The stream
# route's blocks own 16 rows where ceil(N / 64) leaves an SM without two
# 64-row blocks and the 16-row grid fits one wave (their warps split K), else
# 64 rows, over all of K or, where x would pass
# _STREAM_X_K, a K split; x for the block's k range comes in one TMA box, then
# a ring of 1 to 16 stages each holds a unit: 128 bytes of each row (128 k of
# int8, 256 k of NF4) and NF4's absmax. Registers hold it to 4 blocks an SM
# (3 with 16 tokens), shared memory (228 KB an SM, 1 KB of it reserved a
# block) may hold it to fewer. The wgmma route's tiles are 128 rows by 64 or
# 128 tokens; its unit is 64 bytes of each row, its stages (route, kind,
# tokens) -> count, and it splits K where its tiles leave SMs idle. The split
# route (f32 x) is the wgmma route's kernel over x's three bf16 pieces (3, M,
# K), which a pass writes to scratch first: int8 at every M (16-token tiles
# at M <= 16), NF4 above M = 16 (64-token tiles), where it beats the FMA
# kernel (route fma: NF4 at M <= 16).
# Every route sums K splits in scratch, the last block of a slice or tile to
# finish adding them in split order.
_WOL_ROUTES = {"split": 0, "stream": 1, "wgmma": 2, "fma": 3}
_WOL_UNIT = {"stream": 128, "wgmma": 64, "split": 64, "fma": 64}
_STREAM_STAGES, _STREAM_MAX_M, _STREAM_X_K = (1, 2, 4, 6, 8, 12, 16), 16, 2048
_SM_SMEM = 228 * 1024
_WGMMA_ROWS = 128
_WGMMA_STAGES = {("wgmma", "int8", 64): 6, ("wgmma", "int8", 128): 6, ("wgmma", "nf4", 64): 4,
                 ("wgmma", "nf4", 128): 3, ("split", "int8", 16): 8, ("split", "int8", 64): 6,
                 ("split", "int8", 128): 4, ("split", "nf4", 64): 3}
_SPLIT_PIECES = 3  # bf16 pieces of an f32 x (csrc/weight_only_linear.cuh kSplitPieces)
_WGMMA_MIN_UNITS = 4  # a K split of the wgmma route holds at least this many units
_WOL_COUNTERS = 4096  # the persistent split counters a device (one a split slice or tile)


def _stream_smem(kind: str, rows: int, tile_m: int, stages: int, ups: int) -> int:
    """csrc/weight_only_linear.cuh stream_smem: a stream block's dynamic
    shared memory (x for `ups` units, the ring, NF4's absmax and table)."""
    nf4 = kind == "nf4"
    x = ups * (4 if nf4 else 2) * tile_m * 128
    ring = max(stages * rows * 128, 128 * 16 * 4)
    return x + ring + (stages * 4 * rows * 4 + 256 * 16 * 8 if nf4 else 0) + (2 * stages + 1) * 8 + 8 + 1024


def _stream_per_sm(kind: str, rows: int, tile_m: int, stages: int, ups: int) -> int:
    """Stream blocks an SM holds at once: the launch bound's 4 (3 with 16
    tokens) or what shared memory allows."""
    return min(4 if tile_m == 8 else 3, _SM_SMEM // (_stream_smem(kind, rows, tile_m, stages, ups) + 1024))


def _rows(shape) -> int:
    return math.prod(int(d) for d in shape[:-1])


def _balanced_splits(units: int, want: int) -> tuple[int, int]:
    """(splits, units a split) for at least `want` splits of `units`, none
    empty: ceil(units / ups) splits of ups = ceil(units / want) units."""
    ups = -(-units // max(1, min(want, units)))
    return -(-units // ups), ups


def weight_only_plan(kind, M, N, K, dtype, block_k=None, sms=H100_SMS) -> dict:
    """What int8_linear (kind "int8") or nf4_linear ("nf4") launches for x
    (M, K) against weights (N, K), from the shapes and x's dtype alone (no
    tensor is read, so the launch is safe to capture in a CUDA graph):

    * ``route``: ``fma`` (f32 x, NF4 at M <= 16: the FMA kernel, 16 x 16
      blocks; the split route is slower there), ``split`` (other f32 x: x's
      three bf16 pieces, then the wgmma route's tiles with a product a pair
      of pieces; 16-token tiles at M <= 16, else 64 for NF4 and for int8 at
      M <= 64, else 128), ``stream``
      (bf16, M <= 16, K a multiple of 128: blocks of ``rows`` weight rows, 16
      where ceil(N / 64) < 2 · sms and the 16-row grid is one wave of
      resident blocks, else 64 (16-row blocks' 8 warps split K), over
      all of K or a K split where x for it would pass 2,048 k; x in one TMA
      box, the weights through ``stages`` ring stages, filled by one TMA box
      a group of min(4, stages / 2)) or ``wgmma`` (bf16,
      other M, which the checkers claim up to QUANT_MAX_M: persistent
      TMA/wgmma tiles of 128 rows by ``tile_m`` tokens, K split while the
      tiles leave SMs idle); its ``code`` for csrc/weight_only_linear.cuh;
    * ``rows``: weight rows a block or tile; ``tile_m``: tokens (stream: 8
      or 16, the n8 tiles; wgmma: 64 or 128; split: 16, 64 or 128; fma: 16);
    * ``splits`` and ``units_per_split`` (units of a row's bytes: 128 on
      the stream route, 64 on the others);
    * ``grid``: the launch grid; ``blocks``: blocks (or, for wgmma and
      split, work items) it runs; ``stages``;
    * ``scratch``: name -> (shape, dtype) of what the wrapper allocates:
      ``partial``, the f32 partial sums (splits, M, N) when K is split, and
      ``pieces``, x's bf16 pieces (3, M, K) on the split route;
      ``counters``: the split counters the launch uses (zero without).

    block_k is NF4's slice width (nf4_kernel_block_k(K) by default)."""
    _require(kind in ("int8", "nf4"), f"weight_only_plan: kind {kind!r} is not int8 or nf4")
    if kind == "nf4":
        block_k = block_k or nf4_kernel_block_k(K)
        _require(block_k is not None and K % block_k == 0, f"weight_only_plan: no NF4 slice width for K={K}")
    row_bytes = K if kind == "int8" else K // 2
    if dtype == torch.float32 and kind == "nf4" and M <= _STREAM_MAX_M:
        grid = (-(-N // 16), -(-M // 16))
        return {"route": "fma", "code": _WOL_ROUTES["fma"], "rows": 16, "tile_m": 16, "splits": 1,
                "units_per_split": -(-row_bytes // _WOL_UNIT["fma"]), "grid": grid, "blocks": grid[0] * grid[1],
                "stages": 0, "scratch": {}, "counters": 0}
    if dtype != torch.float32 and M <= _STREAM_MAX_M and row_bytes % _WOL_UNIT["stream"] == 0:
        # (int8: K in whole 128-k chunks)
        route, tile_m = "stream", 8 if M <= 8 else 16
        units = -(-row_bytes // _WOL_UNIT[route])
        splits, ups = _balanced_splits(units, -(-K // _STREAM_X_K))
        if kind == "nf4" and splits > 1:  # a split holds whole slices of the kernel layout
            step = block_k // 2 // _WOL_UNIT[route] or 1
            ups = -(-ups // step) * step
            splits = -(-units // ups)
        # 16-row blocks where 64-row ones leave SMs without two blocks and the
        # 16-row grid is one wave of resident blocks
        rows = 16 if (-(-N // 64) * splits < 2 * sms
                      and -(-N // 16) * splits <= _stream_per_sm(kind, 16, tile_m, 2, ups) * sms) else 64
        tiles = -(-N // rows)
        blocks = tiles * splits
        grid = (tiles, splits)
        # stages (a multiple of _stream_group's fill group): 8 for 16-row
        # blocks, 2 for 64-row ones (tools/quant_ab.py --sweep), no more than
        # the units, and fewer where that makes the grid one wave of resident
        # blocks
        stages = max(d for d in _STREAM_STAGES if d <= min(ups, 8 if rows == 16 else 2))
        while (stages > 1 and blocks <= _stream_per_sm(kind, rows, tile_m, 1, ups) * sms
               and _stream_per_sm(kind, rows, tile_m, stages, ups) * sms < blocks):
            stages = max(d for d in _STREAM_STAGES if d < stages)
    else:
        route, rows = "split" if dtype == torch.float32 else "wgmma", _WGMMA_ROWS
        tile_m = 64 if M <= 64 or (route, kind) == ("split", "nf4") else 128
        if route == "split" and M <= _STREAM_MAX_M:  # m64n16k16: a quarter of 64's padded products
            tile_m = 16
        units = -(-row_bytes // _WOL_UNIT[route])
        tiles = -(-M // tile_m) * -(-N // rows)
        splits, ups = _balanced_splits(units, max(1, min(sms // tiles, units // _WGMMA_MIN_UNITS)))
        blocks, stages = tiles * splits, _WGMMA_STAGES[(route, kind, tile_m)]
        grid = (min(blocks, sms),)
    scratch = {"partial": ((splits, M, N), torch.float32)} if splits > 1 else {}
    if route == "split":
        scratch["pieces"] = ((_SPLIT_PIECES, M, K), torch.bfloat16)
    return {"route": route, "code": _WOL_ROUTES[route], "rows": rows, "tile_m": tile_m, "splits": splits,
            "units_per_split": ups, "grid": grid, "blocks": blocks, "stages": stages, "scratch": scratch,
            "counters": tiles if splits > 1 else 0}


_wol_counters = {}


def _wol_scratch(plan, device) -> dict:
    """The plan's scratch (torch.empty: the partial sums, x's pieces) and,
    under ``counters``, the device's persistent split counters (zeros, made
    once outside any CUDA-graph capture; each launch that splits leaves its
    counters at zero), where it has them."""
    out = {name: torch.empty(shape, dtype=dt, device=device) for name, (shape, dt) in plan["scratch"].items()}
    if plan["counters"]:
        cnt = _wol_counters.get(device)
        if cnt is None:
            _require(not torch.cuda.is_current_stream_capturing(),
                     "weight-only linear: the split counters are made at the first split launch, which must "
                     "not be under CUDA-graph capture")
            cnt = _wol_counters[device] = torch.zeros(_WOL_COUNTERS, dtype=torch.int32, device=device)
        _require(plan["counters"] <= _WOL_COUNTERS, f"weight-only linear: {plan['counters']} split counters needed")
        out["counters"] = cnt
    return out


def _wol_args(plan, scratch: dict, M, N, K, *rest) -> tuple:
    """The C entry points' arguments after x, the weights and y."""
    ptr = [scratch[k].data_ptr() if k in scratch else None for k in ("partial", "counters", "pieces")]
    return (*ptr, M, N, K, *rest, plan["code"], plan["rows"], plan["tile_m"], plan["splits"],
            plan["units_per_split"], plan["grid"][0], plan["stages"])


def int8_linear_plain(x, qweight, scale):
    """The kernel's function in plain PyTorch: the int8 weights widened, the
    product summed in f32, the f32 per-row scale applied to the sum, one
    cast to x's dtype (pallasex._int8_linear_kernel's order)."""
    acc = torch.matmul(x.float(), qweight.float().t())
    return (acc * scale.float()).to(x.dtype)


def int8_linear(x, qweight, scale):
    """x (..., K) f32 or bf16, qweight (N, K) int8, scale (N,) f32 -> (..., N)
    in x's dtype: (x · qweightᵀ) · scale, on weight_only_plan's route."""
    if x.device.type == "cpu":
        return int8_linear_plain(x, qweight, scale)
    N, K = qweight.shape
    _require(x.shape[-1] == K, f"int8_linear: x {tuple(x.shape)} does not fit weights {tuple(qweight.shape)}")
    x2 = x.reshape(-1, K).contiguous()
    _check_cuda("int8_linear", x2, qweight, scale)
    _require(x.dtype in _QUANT_X_DTYPES, f"int8_linear: x dtype {x.dtype} is not f32 or bf16")
    _require(qweight.dtype == torch.int8 and scale.dtype == torch.float32 and tuple(scale.shape) == (N,),
             "int8_linear: weights must be int8 (N, K) and scale f32 (N,)")
    _require(K % 16 == 0, f"int8_linear: K={K} is not a multiple of 16")
    _require(x2.data_ptr() % 16 == 0, "int8_linear: x must be 16-byte aligned")
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M and N:
        plan = weight_only_plan("int8", M, N, K, x.dtype)
        scratch = _wol_scratch(plan, x.device)  # held until the launch is enqueued
        _raise_on(_library().tt_int8_linear(x2.data_ptr(), qweight.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                            *_wol_args(plan, scratch, M, N, K, _DTYPE_CODE[x.dtype]),
                                            _stream(x)),
                  "int8_linear")
        int8_linear.launches += 1
        int8_linear.routes[plan["route"]] += 1
    return y.reshape(*x.shape[:-1], N)


int8_linear.launches = 0
int8_linear.routes = dict.fromkeys(_WOL_ROUTES, 0)  # launches by weight_only_plan's route (zero it in place)


def int8_linear_supported(x, qweight, scale, bias=None) -> bool:
    """Hopper's checker: int8 weights (uint8 would be read as signed), f32 or
    bf16 x, K a multiple of 16 (every lane's weight load is 16 bytes), f32
    scale (N,), any N, and at most QUANT_MAX_M rows of x. pallasex's N and K
    % 128 rules are TPU tiling, and its TPU-only gate a CPU speed choice."""
    if getattr(qweight, "ndim", 0) != 2 or getattr(x, "ndim", 0) < 1:
        return False
    N, K = qweight.shape
    return (
        to_torch_dtype(qweight.dtype) == torch.int8
        and to_torch_dtype(x.dtype) in _QUANT_X_DTYPES and x.shape[-1] == K and K % 16 == 0
        and tuple(scale.shape) == (N,) and to_torch_dtype(scale.dtype) == torch.float32
        and _rows(x.shape) <= QUANT_MAX_M
    )


def _int8_linear_impl(x, qweight, scale, bias=None):
    out = int8_linear(x, qweight, scale)
    return out if bias is None else out + bias


ex.register_implementation("quant.linear_int8", _int8_linear_impl, checker=int8_linear_supported)


def nf4_linear_plain(x, packed_kl, absmax_kl, block_size: int = 64):
    """The kernel's function in plain PyTorch: W = NF4_CODE[code] · absmax
    in f32, rounded to x's dtype, the product summed in f32, one cast."""
    w = dequantize_nf4_kl(packed_kl, absmax_kl, (packed_kl.shape[0], x.shape[-1]), block_size)
    return torch.matmul(x.float(), w.to(x.dtype).float().t()).to(x.dtype)


def nf4_linear(x, packed_kl, absmax_kl, block_size: int = 64):
    """x (..., K) f32 or bf16 against kernel-layout NF4 weights (packed
    (N, K/2) uint8, absmax (N, K/64) f32; transforms/quantization.py:
    pack_nf4_kernel_layout) -> (..., N) in x's dtype, on weight_only_plan's
    route."""
    if x.device.type == "cpu":
        return nf4_linear_plain(x, packed_kl, absmax_kl, block_size)
    K = x.shape[-1]
    N = packed_kl.shape[0]
    bk = nf4_kernel_block_k(K, block_size)
    _require(block_size == 64 and bk is not None,
             f"nf4_linear: no kernel layout for K={K}, block_size={block_size}")
    x2 = x.reshape(-1, K).contiguous()
    _check_cuda("nf4_linear", x2, packed_kl, absmax_kl)
    _require(x.dtype in _QUANT_X_DTYPES, f"nf4_linear: x dtype {x.dtype} is not f32 or bf16")
    _require(packed_kl.dtype == torch.uint8 and tuple(packed_kl.shape) == (N, K // 2)
             and absmax_kl.dtype == torch.float32 and tuple(absmax_kl.shape) == (N, K // 64),
             f"nf4_linear: packed must be uint8 ({N}, {K // 2}) and absmax f32 ({N}, {K // 64})")
    _require(x2.data_ptr() % 16 == 0, "nf4_linear: x must be 16-byte aligned")
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M and N:
        plan = weight_only_plan("nf4", M, N, K, x.dtype, bk)
        scratch = _wol_scratch(plan, x.device)  # held until the launch is enqueued
        _raise_on(_library().tt_nf4_linear(x2.data_ptr(), packed_kl.data_ptr(), absmax_kl.data_ptr(),
                                           y.data_ptr(),
                                           *_wol_args(plan, scratch, M, N, K, bk, _DTYPE_CODE[x.dtype]),
                                           _stream(x)),
                  "nf4_linear")
        nf4_linear.launches += 1
        nf4_linear.routes[plan["route"]] += 1
    return y.reshape(*x.shape[:-1], N)


nf4_linear.launches = 0
nf4_linear.routes = dict.fromkeys(_WOL_ROUTES, 0)  # launches by weight_only_plan's route (zero it in place)


def nf4_linear_supported(x, packed_kl, absmax_kl, out_features, in_features, block_size=64,
                         bias=None) -> bool:
    """Hopper's checker: block_size 64 with a kernel slice width for K,
    f32 or bf16 x, uint8 (N, K/2) codes and f32 (N, K/64) absmax, any N, and
    at most QUANT_MAX_M rows of x."""
    try:
        N, K, bs = int(out_features), int(in_features), int(block_size)
    except (TypeError, ValueError):
        return False
    if getattr(x, "ndim", 0) < 1 or getattr(packed_kl, "ndim", 0) != 2:
        return False
    return (
        bs == 64 and nf4_kernel_block_k(K, bs) is not None
        and to_torch_dtype(x.dtype) in _QUANT_X_DTYPES and x.shape[-1] == K
        and to_torch_dtype(packed_kl.dtype) == torch.uint8 and tuple(packed_kl.shape) == (N, K // 2)
        and to_torch_dtype(absmax_kl.dtype) == torch.float32 and tuple(absmax_kl.shape) == (N, K // 64)
        and _rows(x.shape) <= QUANT_MAX_M
    )


def _nf4_kl_impl(x, packed_kl, absmax_kl, out_features, in_features, block_size=64, bias=None):
    out = nf4_linear(x, packed_kl, absmax_kl, int(block_size))
    return out if bias is None else out + bias


ex.register_implementation("quant.linear_nf4_kl", _nf4_kl_impl, checker=nf4_linear_supported)


# ---------------------------------------------------------------------------
# Delayed-scaling fp8 linear (transforms/fp8_training.py)
# ---------------------------------------------------------------------------

_FP8_DTYPES = (torch.float32, torch.bfloat16)


def fp8_linear_plain(x, w, sx, sw, *, fmt_max: float = 448.0, save_quantized: bool = False):
    """The kernel's function in plain PyTorch: both operands scaled in f32,
    clipped to ±fmt_max and cast to e4m3; the codes widened and multiplied
    in f32; the sum divided by sx·sw and cast once to x's dtype; the amaxes
    of the unquantized operands (pallasex._fp8_matmul_kernel's order)."""
    xq = torch.clamp(x.float() * sx, -fmt_max, fmt_max).to(torch.float8_e4m3fn)
    wq = torch.clamp(w.float() * sw, -fmt_max, fmt_max).to(torch.float8_e4m3fn)
    y = (torch.matmul(xq.float(), wq.float().t()) / (sx * sw)).to(x.dtype)
    ax, aw = x.abs().max().float(), w.abs().max().float()
    return (y, xq, wq, ax, aw) if save_quantized else (y, ax, aw)


# csrc/fp8_linear.cu's product adds each 32-deep e4m3 tensor-core sum into
# f32 accumulators, in k order (Hopper's fp8 sums keep fewer bits than f32).
FP8_PROMOTE_K = 32


def fp8_quantize_plain(x, w, sx, sw, *, fmt_max: float = 448.0):
    """The kernel's first stage in plain PyTorch: (xq, wq, amax_x, amax_w),
    the e4m3 codes of both operands scaled in f32 and clipped to ±fmt_max,
    and the amaxes of the unquantized operands."""
    xq = torch.clamp(x.float() * sx, -fmt_max, fmt_max).to(torch.float8_e4m3fn)
    wq = torch.clamp(w.float() * sw, -fmt_max, fmt_max).to(torch.float8_e4m3fn)
    return xq, wq, x.abs().max().float(), w.abs().max().float()


def fp8_gemm_plain(xq, wq, sx, sw, dtype):
    """The kernel's second stage in plain PyTorch: the codes xq (M, K) and
    wq (N, K) widened to f32, each FP8_PROMOTE_K-deep slice of k multiplied
    on its own and added into f32 sums in k order, the sums divided by
    sx·sw and cast once to dtype."""
    acc = torch.zeros((xq.shape[0], wq.shape[0]), dtype=torch.float32, device=xq.device)
    for k0 in range(0, xq.shape[1], FP8_PROMOTE_K):
        acc += torch.matmul(xq[:, k0:k0 + FP8_PROMOTE_K].float(), wq[:, k0:k0 + FP8_PROMOTE_K].float().t())
    return (acc / (sx * sw)).to(dtype)


def fp8_linear(x, w, sx, sw, *, fmt_max: float = 448.0, save_quantized: bool = False):
    """x (M, K) and w (N, K), f32 or bf16, with the delayed scales sx, sw
    (0-d f32 tensors on x's device: no host sync) -> (y (M, N) in x's dtype,
    amax_x, amax_w), or (y, xq, wq, amax_x, amax_w) with ``save_quantized``
    (the e4m3 codes of x and w). On the card two kernels: the quantize pass
    writes the codes (into scratch without ``save_quantized``), the e4m3
    product reads them."""
    if x.device.type == "cpu":
        return fp8_linear_plain(x, w, sx, sw, fmt_max=fmt_max, save_quantized=save_quantized)
    _require(x.ndim == 2 and w.ndim == 2 and x.shape[1] == w.shape[1],
             f"fp8_linear: x {tuple(x.shape)} does not fit w {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[0]
    _check_cuda("fp8_linear", x, w, sx, sw)
    _require(x.dtype in _FP8_DTYPES and w.dtype in _FP8_DTYPES,
             f"fp8_linear: x and w must be f32 or bf16, got {x.dtype} and {w.dtype}")
    _require(sx.dtype == torch.float32 and sw.dtype == torch.float32 and sx.numel() == 1 and sw.numel() == 1,
             "fp8_linear: the scales must be f32 scalars")
    _require(K % 32 == 0 and N % 8 == 0, f"fp8_linear: K={K} must be a multiple of 32 and N={N} of 8")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    amax = torch.zeros(2, dtype=torch.float32, device=x.device)
    xq = torch.empty((M, K), dtype=torch.float8_e4m3fn, device=x.device)
    wq = torch.empty((N, K), dtype=torch.float8_e4m3fn, device=x.device)
    if M and N:
        xh = torch.empty((M, K), dtype=torch.float16, device=x.device)
        wh = torch.empty((N, K), dtype=torch.float16, device=x.device)
        _raise_on(_library().tt_fp8_linear(
            x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), y.data_ptr(), xq.data_ptr(), wq.data_ptr(),
            xh.data_ptr(), wh.data_ptr(), amax.data_ptr(), M, N, K, _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
            float(fmt_max), _stream(x)), "fp8_linear")
        fp8_linear.launches += 1
    ax, aw = amax[0], amax[1]
    return (y, xq, wq, ax, aw) if save_quantized else (y, ax, aw)


fp8_linear.launches = 0


def fp8_linear_supported(x, w) -> bool:
    """Hopper's checker: 2-d x (M, K) and w (N, K), each f32 or bf16, K a
    multiple of 32 (one e4m3 product's depth; it also keeps the codes' rows
    16-byte aligned, as TMA needs) and N of 8 (whole 8-column slices), M and
    N not 0. pallasex's K and N % 128 rules are TPU tiling: TMA zero-fills
    the tiles' ragged edges."""
    if getattr(x, "ndim", 0) != 2 or getattr(w, "ndim", 0) != 2:
        return False
    M, K = x.shape
    N = w.shape[0]
    return (to_torch_dtype(x.dtype) in _FP8_DTYPES and to_torch_dtype(w.dtype) in _FP8_DTYPES
            and w.shape[1] == K and K % 32 == 0 and N % 8 == 0 and M > 0 and N > 0)


# ---------------------------------------------------------------------------
# Grouped-expert SwiGLU MLP (models/moe.py's grouped road)
# ---------------------------------------------------------------------------

_GROUPED_DTYPES = (torch.float32, torch.bfloat16)
_GROUPED_BM = 128  # csrc/grouped_mlp.cu: rows a block of the ffma and wgmma routes
_GROUPED_DECODE_ROWS = 8  # csrc/grouped_mlp.cu dec::ROWS: the decode route's largest cap
_GRID_MAX = 65535  # a grid's y and z extents
# csrc/grouped_mlp.cu's routes: (code, gate tile, down tile, threads a block);
# a tile of None rows spans every bin row
_GROUPED_ROUTES = {"ffma": (0, (128, 64), (128, 128), 256), "wgmma": (1, (128, 128), (128, 128), 384),
                   "decode": (2, (None, 32), (None, 64), 256)}


def grouped_mlp_plan(E, cap, D, H, dtype) -> dict:
    """What grouped_mlp launches for these shapes, from (E, cap, D, H) and
    the dtype alone (no read of group_sizes, so the launch is safe to
    capture in a CUDA graph): the ``route`` (f32: ``ffma``, register-blocked
    FFMA tiles; bf16 with cap up to 8: ``decode``, column slices of the
    panels streamed over all of K for the few rows; other bf16: ``wgmma``,
    the TMA-fed warpgroup product), its ``code`` for csrc/grouped_mlp.cu,
    and for the ``gate`` (x -> h) and ``down`` (h -> y) stages the ``tile``
    (rows, columns) of output a block computes, the ``grid`` of blocks
    (column tiles, row blocks, experts; the decode route's blocks span the
    bin: column slices, experts) and the ``threads`` a block; the
    ``scratch`` h (E, cap, H) in the dtype. Blocks wholly past a group's
    rows exit on the card."""
    route = "ffma" if dtype == torch.float32 else ("decode" if cap <= _GROUPED_DECODE_ROWS else "wgmma")
    code, gate_tile, down_tile, threads = _GROUPED_ROUTES[route]
    stages = {}
    for name, (bm, bn), n in (("gate", gate_tile, H), ("down", down_tile, D)):
        grid = (-(-n // bn), E) if bm is None else (-(-n // bn), -(-cap // bm), E)
        stages[name] = {"tile": (cap if bm is None else bm, bn), "grid": grid, "threads": threads}
    return {"route": route, "code": code, **stages, "scratch": {"h": ((E, cap, H), dtype)}}


def grouped_mlp_plain(bins, w_gate, w_up, w_down, group_sizes):
    """The kernel's function in plain PyTorch: per expert, g = x·Wg and u =
    x·Wu summed in f32, h = (g · 1/(1 + exp(−g))) · u in f32 rounded to the
    weights' dtype, y = h·Wd summed in f32 and rounded to the bins' dtype;
    rows at or past group_sizes[e] are zeros (pallasex._grouped_mlp_kernel's
    order)."""
    x = bins.float()
    g = torch.bmm(x, w_gate.float())
    u = torch.bmm(x, w_up.float())
    h = (g * (1.0 / (1.0 + torch.exp(-g))) * u).to(w_down.dtype).float()
    y = torch.bmm(h, w_down.float())
    rows = torch.arange(bins.shape[1], device=bins.device)
    live = rows[None, :] < group_sizes.to(bins.device, torch.int64)[:, None]
    return torch.where(live[..., None], y, 0.0).to(bins.dtype)


def grouped_mlp(bins, w_gate, w_up, w_down, group_sizes):
    """bins (E, cap, D), w_gate and w_up (E, D, H), w_down (E, H, D), all f32
    or all bf16, integer group_sizes (E,) on the same device -> y (E, cap,
    D): each expert's SwiGLU MLP over its first group_sizes[e] bin rows,
    zeros below them. group_sizes is read on the device: no host sync."""
    if bins.device.type == "cpu":
        return grouped_mlp_plain(bins, w_gate, w_up, w_down, group_sizes)
    args = {"bins": bins, "w_gate": w_gate, "w_up": w_up, "w_down": w_down, "group_sizes": group_sizes}
    _require(grouped_mlp_supported(bins, w_gate, w_up, w_down, group_sizes),
             "grouped_mlp: unsupported inputs "
             + ", ".join(f"{k} {tuple(t.shape)} {t.dtype}" for k, t in args.items())
             + ": it takes bins (E, cap, D) and panels (E, D, H), (E, D, H), (E, H, D) of one dtype, f32 or "
             "bf16, D and H multiples of the 16-byte vector, and integer group_sizes (E,)")
    E, cap, D = bins.shape
    H = w_gate.shape[-1]
    gs = group_sizes.to(torch.int32).contiguous()
    _check_cuda("grouped_mlp", bins, w_gate, w_up, w_down, gs)
    y = torch.empty_like(bins)
    if E and cap:
        plan = grouped_mlp_plan(E, cap, D, H, bins.dtype)
        shape, dt = plan["scratch"]["h"]
        h = torch.empty(shape, dtype=dt, device=bins.device)
        _raise_on(_library().tt_grouped_mlp(
            bins.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), gs.data_ptr(),
            h.data_ptr(), y.data_ptr(), E, cap, D, H, _DTYPE_CODE[bins.dtype], plan["code"], _stream(bins)),
            "grouped_mlp")
        grouped_mlp.launches += 1
    return y


grouped_mlp.launches = 0


def grouped_mlp_supported(bins, w_gate, w_up, w_down, group_sizes) -> bool:
    """Hopper's checker: 3-d bins (E, cap, D) and panels (E, D, H), (E, D,
    H), (E, H, D) of one float dtype (f32 or bf16), integer
    group_sizes (E,), D and H multiples of the 16-byte vector. Any cap: the
    kernel masks a ragged one (pallasex's cap % 8 rule is the TPU's sublane
    tile, its VMEM budget the TPU's scratch)."""
    if any(getattr(t, "ndim", 0) != 3 for t in (bins, w_gate, w_up, w_down)):
        return False
    E, cap, D = bins.shape
    H = w_gate.shape[-1]
    tdt, gdt = to_torch_dtype(bins.dtype), to_torch_dtype(group_sizes.dtype)
    return (
        tdt in _GROUPED_DTYPES and all(w.dtype == bins.dtype for w in (w_gate, w_up, w_down))
        and tuple(w_gate.shape) == (E, D, H) and tuple(w_up.shape) == (E, D, H)
        and tuple(w_down.shape) == (E, H, D)
        and getattr(group_sizes, "ndim", 0) == 1 and group_sizes.shape[0] == E
        and not gdt.is_floating_point and not gdt.is_complex and gdt != torch.bool
        and D > 0 and H > 0 and D % _vec(tdt) == 0 and H % _vec(tdt) == 0
        and E <= _GRID_MAX and -(-cap // _GROUPED_BM) <= _GRID_MAX
    )


def _grouped_mlp_impl(bins, w_gate, w_up, w_down, group_sizes):
    return grouped_mlp(bins.contiguous(), w_gate.contiguous(), w_up.contiguous(), w_down.contiguous(),
                       group_sizes)


def grouped_mlp_backward(bins, w_gate, w_up, w_down, group_sizes, do):
    """d(bins), d(w_gate), d(w_up), d(w_down) of grouped_mlp for the
    cotangent do: pallasex's bwd_impl, the SwiGLU chain rule over the same
    bins as batched products (the zero rows past group_sizes add nothing to
    any weight's gradient), each cast to its input's dtype. A cotangent of
    another dtype is cast to the bins' first."""
    do = do.to(bins.dtype)
    g = torch.bmm(bins, w_gate)
    u = torch.bmm(bins, w_up)
    sg = torch.sigmoid(g)
    h = g * sg * u
    dh = torch.bmm(do, w_down.transpose(1, 2))
    dwd = torch.bmm(h.transpose(1, 2), do)
    du = dh * (g * sg)
    dg = dh * u * (sg * (1.0 + g * (1.0 - sg)))
    dbins = torch.bmm(dg, w_gate.transpose(1, 2)) + torch.bmm(du, w_up.transpose(1, 2))
    dwg = torch.bmm(bins.transpose(1, 2), dg)
    dwu = torch.bmm(bins.transpose(1, 2), du)
    return (dbins.to(bins.dtype), dwg.to(w_gate.dtype), dwu.to(w_up.dtype), dwd.to(w_down.dtype))


ex.register_implementation("thunder.grouped_mlp", _grouped_mlp_impl, checker=grouped_mlp_supported)

grouped_mlp_fwd = ex.register_operator(
    "grouped_mlp_fwd",
    meta=lambda bins, w_gate, w_up, w_down, group_sizes: TensorProxy(
        shape=bins.shape, dtype=bins.dtype, device=bins.device),
    fn=_grouped_mlp_impl,
)
grouped_mlp_bwd = ex.register_operator(
    "grouped_mlp_bwd",
    meta=lambda bins, w_gate, w_up, w_down, group_sizes, do: tuple(
        TensorProxy(shape=t.shape, dtype=t.dtype, device=t.device) for t in (bins, w_gate, w_up, w_down)),
    fn=grouped_mlp_backward,
)


@register_augmented_forward("thunder.grouped_mlp")
def _grouped_mlp_aug(bins, w_gate, w_up, w_down, group_sizes):
    if not grouped_mlp_supported(bins, w_gate, w_up, w_down, group_sizes):
        return NotImplemented  # decompose: the batched-matmul grad rules apply
    out = grouped_mlp_fwd(bins, w_gate, w_up, w_down, group_sizes)
    return VJPResult(out, (bins, w_gate, w_up, w_down, group_sizes))


@register_backward("thunder.grouped_mlp")
def _grouped_mlp_bwd(bins, w_gate, w_up, w_down, group_sizes, g):
    dbins, dwg, dwu, dwd = grouped_mlp_bwd(bins, w_gate, w_up, w_down, group_sizes, g)
    return dbins, dwg, dwu, dwd, None


# ---------------------------------------------------------------------------
# Ring attention (context parallelism): the forward and backward ring steps
# and the ring loops
# ---------------------------------------------------------------------------

LN2 = 0.6931471805599453


def ring_visible(T, Tk, q_off, k_off, device=None):
    """(T, Tk) bool: local query i sees local key j under the causal mask at
    global offsets, k_off + j <= q_off + i (the kernels test j > i + (q_off
    − k_off))."""
    qp = q_off + torch.arange(T, device=device)
    kp = k_off + torch.arange(Tk, device=device)
    return kp[None, :] <= qp[:, None]


def _ring_scores2(q, kb, q_off, k_off, causal, scale):
    """q·kbᵀ·scale·log2(e) in f32 (kb repeated over the GQA group), NEG_INF
    where the global causal mask hides a key."""
    T, Tk = q.shape[2], kb.shape[2]
    g = q.shape[1] // kb.shape[1]
    s = torch.matmul(q.float(), kb.float().repeat_interleave(g, 1).transpose(-1, -2)) * (scale * LOG2E)
    if causal:
        s = torch.where(ring_visible(T, Tk, q_off, k_off, q.device), s, NEG_INF)
    return s


def ring_bwd_prologue_plain(lse, delta, pitch):
    """The bf16/fp16 ring step's prologue in plain PyTorch: lse·log2(e) and
    delta (B, H, T, 1) f32 copied into rows of ``pitch`` (flash_backward_plan
    with ring=True), zero past T -> (lse2, delta) (B, H, pitch). (It also
    zeroes the f32 dq output, and dk, dv under GQA or for a shard wholly in
    the future: torch.zeros here.)"""
    B, H, T, _ = lse.shape
    lse2 = lse.new_zeros(B, H, pitch)
    dl = delta.new_zeros(B, H, pitch)
    lse2[..., :T] = lse[..., 0].float() * LOG2E
    dl[..., :T] = delta[..., 0].float()
    return lse2, dl


def ring_flash_step_plain(q, kb, vb, o, m, l, q_off, k_off, causal=True, scale=None):
    """The forward step kernel's function in plain PyTorch, f32, in the same
    log2 units: fold the shard kb/vb into (o, m, l) with the online softmax
    (m_new = max(m, rowmax s), p = exp2(s − m_new), l·exp2(m − m_new) + Σp,
    o·exp2(m − m_new) + p·v) -> new (o, m, l). A shard wholly in the
    future under the causal mask returns the accumulators as they are, as
    the kernel leaves them."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if causal and k_off > q_off + q.shape[2] - 1:
        return o, m, l
    g = q.shape[1] // kb.shape[1]
    s = _ring_scores2(q, kb, q_off, k_off, causal, scale)
    m_new = torch.maximum(m[..., 0], s.amax(-1))
    p = torch.exp2(s - m_new[..., None])
    corr = torch.exp2(m[..., 0] - m_new)
    l_new = l[..., 0] * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.matmul(p, vb.float().repeat_interleave(g, 1))
    return o_new, m_new[..., None], l_new[..., None]


def ring_flash_bwd_step_plain(q, kb, vb, do, lse, delta, q_off, k_off, causal=True, scale=None):
    """The backward step kernels' function in plain PyTorch, f32: p from the
    global lse (B, H, T, 1, natural log), ds = p·(dp − delta)·scale ->
    (dq (B, H, T, D), dk, dv (B, Hkv, Tk, D)) f32, dk/dv summed over the
    GQA group."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    B, H, T, D = q.shape
    Hkv, Tk = kb.shape[1], kb.shape[2]
    g = H // Hkv
    s = _ring_scores2(q, kb, q_off, k_off, causal, scale)
    p = torch.exp2(s - lse.float() * LOG2E)
    dof = do.float()
    kr, vr = kb.float().repeat_interleave(g, 1), vb.float().repeat_interleave(g, 1)
    ds = p * (torch.matmul(dof, vr.transpose(-1, -2)) - delta.float()) * scale
    dq = torch.matmul(ds, kr)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).reshape(B, Hkv, g, Tk, D).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), dof).reshape(B, Hkv, g, Tk, D).sum(2)
    return dq, dk, dv


def _check_ring(name, q, kb, vb, *f32) -> None:
    B, H, T, D = q.shape
    _check_cuda(name, q, kb, vb, *f32)
    _require(q.dtype in _DTYPE_CODE and kb.dtype == q.dtype and vb.dtype == q.dtype,
             f"{name}: q, kb and vb must share a float dtype")
    _require(kb.ndim == 4 and tuple(kb.shape) == tuple(vb.shape) and kb.shape[0] == B
             and kb.shape[2] == T and kb.shape[3] == D and H % kb.shape[1] == 0,
             f"{name}: q {tuple(q.shape)} does not fit the shard {tuple(kb.shape)} "
             f"(equal shards: T == T_blk)")
    _require(D % 2 == 0 and D % _vec(q.dtype) == 0 and D <= _FLASH_MAX_D,
             f"{name}: head dim {D} unsupported for {q.dtype}")
    _require(all(t.dtype == torch.float32 for t in f32), f"{name}: the accumulators must be f32")


def ring_flash_step(q, kb, vb, o, m, l, q_off, k_off, causal=True, scale=None):
    """One forward ring step: fold the arriving K/V shard kb/vb (B, Hkv, T,
    D) into the carried f32 accumulators o (B, H, T, D), m and l (B, H, T,
    1) — log2 units, o unnormalized — for local queries q (B, H, T, D).
    q_off and k_off are the global positions of the queries' and the
    shard's first rows. On the card the kernel updates o, m and l IN PLACE
    and returns them: bf16 and fp16 run the flash forward's wgmma/TMA core
    in ring mode (ring_forward_plan's walk), f32 csrc/ring_flash_fwd.cu's
    kernel. A shard wholly in the future launches nothing and leaves them
    untouched; the step still counts a launch, so the ring's count is its
    steps."""
    if q.device.type == "cpu":
        return ring_flash_step_plain(q, kb, vb, o, m, l, q_off, k_off, causal, scale)
    _check_ring("ring_flash_step", q, kb, vb, o, m, l)
    B, H, T, D = q.shape
    _require(tuple(o.shape) == (B, H, T, D) and tuple(m.shape) == (B, H, T, 1)
             and tuple(l.shape) == (B, H, T, 1),
             "ring_flash_step: o must be (B, H, T, D), m and l (B, H, T, 1)")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.numel():
        _raise_on(_library().tt_ring_flash_fwd(
            q.data_ptr(), kb.data_ptr(), vb.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, H, kb.shape[1], T, D, int(q_off), int(k_off), int(bool(causal)),
            float(scale * LOG2E), _DTYPE_CODE[q.dtype], _stream(q)), "ring_flash_step")
        ring_flash_step.launches += 1
    return o, m, l


ring_flash_step.launches = 0


def ring_flash_bwd_step(q, kb, vb, do, lse, delta, q_off, k_off, causal=True, scale=None):
    """One backward ring step: the local queries' f32 dq contribution (B, H,
    T, D) and the shard's f32 dk/dv contributions (B, Hkv, T, D), summed
    over the GQA group, from the global lse and delta (B, H, T, 1) f32 and
    do in q's dtype. On the card bf16 and fp16 run the flash backward's
    wgmma core at the step's offsets after a prologue (flash_backward_plan
    with ring=True names the scratch), f32 the two-pass kernels; one launch
    count covers the step's kernels (a shard wholly in the future runs the
    prologue alone, which writes the zeros)."""
    if q.device.type == "cpu":
        return ring_flash_bwd_step_plain(q, kb, vb, do, lse, delta, q_off, k_off, causal, scale)
    _check_ring("ring_flash_bwd_step", q, kb, vb, lse, delta)
    _check_cuda("ring_flash_bwd_step", q, do)
    B, H, T, D = q.shape
    Hkv = kb.shape[1]
    _require(do.dtype == q.dtype and tuple(do.shape) == tuple(q.shape)
             and tuple(lse.shape) == (B, H, T, 1) and tuple(delta.shape) == (B, H, T, 1),
             "ring_flash_bwd_step: do must be q's dtype and shape, lse and delta (B, H, T, 1)")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq = torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
    dk = torch.empty(kb.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(kb.shape, dtype=torch.float32, device=q.device)
    if q.numel():
        plan = flash_backward_plan(B, H, Hkv, T, D, q.dtype, ring=True)
        buf = {n: torch.empty(shape, dtype=dt, device=q.device) for n, (shape, dt) in plan["scratch"].items()}
        ptr = lambda n: buf[n].data_ptr() if n in buf else None  # noqa: E731
        _raise_on(_library().tt_ring_flash_bwd(
            q.data_ptr(), kb.data_ptr(), vb.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr("lse2"), ptr("delta"),
            B, H, Hkv, T, D, plan["pitch"], int(q_off), int(k_off), int(bool(causal)), float(scale),
            _DTYPE_CODE[q.dtype], _stream(q)), "ring_flash_bwd_step")
        ring_flash_bwd_step.launches += 1
    return dq, dk, dv


ring_flash_bwd_step.launches = 0


def ring_flash_supported(q, k, v, *args, **kwargs) -> bool:
    """Hopper's checker for the ring kernels (in place of pallasex's VMEM
    budget): 4-d q/k/v of one float dtype, k and v of one shape, equal
    shards (T == T_blk, as the TPU rule has), H % Hkv == 0, an even D that
    is a multiple of the 16-byte vector and at most 128. Any T: the kernels
    mask the ragged edge. Everything else runs parallel/context_parallel.py's
    ring over the plain steps on the torch executor."""
    if getattr(q, "ndim", 0) != 4 or getattr(k, "ndim", 0) != 4 or getattr(v, "ndim", 0) != 4:
        return False
    B, H, T, D = q.shape
    tdt = to_torch_dtype(q.dtype)
    return (
        tdt in _DTYPE_CODE and k.dtype == q.dtype and v.dtype == q.dtype
        and tuple(k.shape) == tuple(v.shape) and k.shape[0] == B and k.shape[2] == T
        and k.shape[3] == D and H % k.shape[1] == 0
        and D % 2 == 0 and D % _vec(tdt) == 0 and D <= _FLASH_MAX_D
    )


def _ring_flash_fwd_impl(q, k, v, **kw):
    """The forward ring of parallel/context_parallel.py through the step
    kernel (pallasex._ring_flash_fwd_impl)."""
    from ..parallel.context_parallel import ring_attention_forward

    return ring_attention_forward(q, k, v, step=ring_flash_step, **kw)


def _ring_flash_bwd_impl(q, k, v, out, lse, do, **kw):
    """The backward ring of parallel/context_parallel.py through the
    backward step kernels (pallasex._ring_flash_bwd_impl)."""
    from ..parallel.context_parallel import ring_attention_backward

    return ring_attention_backward(q, k, v, out, lse, do, step=ring_flash_bwd_step, **kw)


def _ring_attention_impl(q, k, v, **kw):
    return _ring_flash_fwd_impl(q, k, v, **kw)[0]


# dist.ring_attention (no gradient) and the two operators of its grad rule
# (parallel/context_parallel.py): a declined shape runs the ring over the
# plain steps
ex.register_implementation("dist.ring_attention", _ring_attention_impl, checker=ring_flash_supported)
ex.register_implementation("dist.ring_attention_fwd", _ring_flash_fwd_impl,
                           checker=ring_flash_supported)
ex.register_implementation("dist.ring_attention_bwd", _ring_flash_bwd_impl,
                           checker=ring_flash_supported)

# A CUDA-graph replay runs no Python: each counter gets its capture's count
# back on every replay (executors/graphex.py).
for _wrapper in (rms_norm, adamw_update, paged_attention, paged_chunk_attention, flash_rope_attention,
                 flash_rope_attention_backward, flash_attention, flash_attention_backward, cross_entropy,
                 int8_linear, nf4_linear, fp8_linear, grouped_mlp, ring_flash_step, ring_flash_bwd_step):
    graphex.register_counter(_wrapper)
for _wrapper in (int8_linear, nf4_linear):  # and the weight-only linears' launches by route
    for _route in _WOL_ROUTES:
        graphex.register_counter(_wrapper.routes, _route)
