"""Context (sequence) parallelism: ring attention over the `sp` mesh axis.

thunder_tpu/parallel/context_parallel.py for the port: a trace transform
swaps every `sdpa` bsym for the ``dist.ring_attention`` operator, which
rotates the K/V blocks around the ranks of the axis while a flash-style
online softmax accumulates the partial attention (Liu et al., Ring
Attention with Blockwise Transformers, 2023).

Per-rank view: q/k/v arrive sequence-split (B, H, T/n, D) — rank r holds
positions [r·T, (r+1)·T). Each of the n ring steps folds the shard it
holds in and hands it to the next rank (parallel/prims.py:ring_shift).

Who runs what: one ring driver (``ring_attention_forward``,
``ring_attention_backward``) runs the ring with a step function. The cuda
executor claims ``dist.ring_attention`` and the two operators of its grad
rule with its Hopper checker and passes the hand-written step kernels'
wrappers (executors/cudaex.py: ring_flash_step, ring_flash_bwd_step). A
shape the checker declines runs the same driver on the torch executor with
the steps' plain versions (cudaex.ring_flash_step_plain,
ring_flash_bwd_step_plain): f32, log2 units, the finite ``NEG_INF``
sentinel, diagonal first. The gradient is an explicit rule, where
thunder_tpu takes ``jax.vjp`` of its scan (the op is in
``JAX_VJP_FALLBACK``): the augmented forward records
``dist.ring_attention_fwd`` (out and the natural-log lse) and saves (q, k,
v, out, lse); the backward records ``dist.ring_attention_bwd``."""
from __future__ import annotations

from contextvars import ContextVar

import torch

from ..core import dtypes
from ..core.proxies import TensorProxy
from ..core.symbol import OpTags, Symbol
from ..core.trace_interpreter import TraceSubstitutionProcessor
from ..core.transform_common import Transform
from ..executors.cudaex import LN2, NEG_INF, ring_flash_bwd_step_plain, ring_flash_step_plain
from ..executors.torchex import ex as torch_ex
from ..transforms.autodiff import VJPResult, register_augmented_forward, register_backward
from . import mesh as _mesh
from .mesh import SP_AXIS
from .prims import ring_shift

_TAGS = (OpTags.COLLECTIVE, OpTags.DONT_FUSE)


def _like(t: TensorProxy, dtype=None, shape=None) -> TensorProxy:
    return TensorProxy(shape=t.shape if shape is None else shape,
                       dtype=t.dtype if dtype is None else dtype, device=t.device)


def _ring_attention_meta(q, k, v, *, axis, causal=True, scale=None, world_size=1):
    return _like(q)


def _ring_fwd_meta(q, k, v, *, axis, causal=True, scale=None, world_size=1):
    return _like(q), _like(q, dtypes.float32, q.shape[:-1])


def _ring_bwd_meta(q, k, v, out, lse, do, *, axis, causal=True, scale=None, world_size=1):
    return _like(q), _like(k), _like(v)


def ring_attention_forward(q, k, v, *, axis, causal=True, scale=None, world_size=1,
                           step=ring_flash_step_plain):
    """The forward ring (pallasex._ring_flash_fwd_impl; thunder_tpu's
    _ring_attention_impl computes the same function) on local q (B, H, T, D)
    and k/v (B, Hkv, T, D): the diagonal shard first, then each rank's shard
    as it arrives from the previous rank, folded into f32 (o, m, l) in log2
    units by ``step`` (the plain step here; cudaex passes its kernel's
    wrapper). The next transfer is posted before the current step and
    waited on after it. At one rank nothing moves.
    -> (out in q's dtype, lse (B, H, T) f32, natural log)."""
    q, kb, vb = q.contiguous(), k.contiguous(), v.contiguous()
    B, H, T, D = q.shape
    n, my = world_size, _mesh.active_mesh().coordinate(axis)
    o = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T, 1), dtype=torch.float32, device=q.device)
    for i in range(n):
        src = (my - i) % n  # the rank whose shard this is
        if i + 1 < n:
            (k_next, v_next), wait = ring_shift([kb, vb], axis)
        o, m, l = step(q, kb, vb, o, m, l, my * T, src * T, causal, scale)
        if i + 1 < n:
            wait()
            kb, vb = k_next, v_next
    l1 = l[..., 0]
    l_safe = torch.where(l1 == 0.0, 1.0, l1)
    out = (o / l_safe[..., None]).to(q.dtype)
    return out, (m[..., 0] + torch.log2(l_safe)) * LN2


def ring_attention_backward(q, k, v, out, lse, do, *, axis, causal=True, scale=None,
                            world_size=1, step=ring_flash_bwd_step_plain):
    """The backward ring (pallasex._ring_flash_bwd_impl): delta = Σ do·out in
    f32, then per step ``step`` gives the shard's dq, dk, dv contributions
    from the global lse; dq adds up locally, the dk/dv accumulators travel
    with their shard and after n transfers they are home. A wider cotangent
    is cast to q's dtype first. -> (dq, dk, dv) in the inputs' dtypes."""
    q, kb, vb = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.to(q.dtype).contiguous()
    T = q.shape[2]
    n, my = world_size, _mesh.active_mesh().coordinate(axis)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    lse1 = lse.float().unsqueeze(-1).contiguous()
    dq = dkb = dvb = None
    for i in range(n):
        src = (my - i) % n
        if i + 1 < n:
            (k_next, v_next), wait = ring_shift([kb, vb], axis)
        dq_c, dk_c, dv_c = step(q, kb, vb, do, lse1, delta, my * T, src * T, causal, scale)
        dq = dq_c if dq is None else dq.add_(dq_c)
        dkb = dk_c if dkb is None else dkb.add_(dk_c)
        dvb = dv_c if dvb is None else dvb.add_(dv_c)
        (dkb, dvb), wait_acc = ring_shift([dkb, dvb], axis)
        if i + 1 < n:
            wait()
            kb, vb = k_next, v_next
        wait_acc()
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


def _ring_attention_impl(q, k, v, *, axis, causal=True, scale=None, world_size=1):
    return ring_attention_forward(q, k, v, axis=axis, causal=causal, scale=scale,
                                  world_size=world_size)[0]


ring_attention = Symbol("ring_attention", _ring_attention_meta, id="dist.ring_attention",
                        is_prim=True, module="dist", tags=_TAGS)
ring_attention_fwd = Symbol("ring_attention_fwd", _ring_fwd_meta, id="dist.ring_attention_fwd",
                            is_prim=True, module="dist", tags=_TAGS)
ring_attention_bwd = Symbol("ring_attention_bwd", _ring_bwd_meta, id="dist.ring_attention_bwd",
                            is_prim=True, module="dist", tags=_TAGS)
torch_ex.register_implementation(ring_attention.id, _ring_attention_impl)
torch_ex.register_implementation(ring_attention_fwd.id, ring_attention_forward)
torch_ex.register_implementation(ring_attention_bwd.id, ring_attention_backward)


@register_augmented_forward(ring_attention.id)
def _ring_attention_aug(q, k, v, *, axis, causal=True, scale=None, world_size=1):
    out, lse = ring_attention_fwd(q, k, v, axis=axis, causal=causal, scale=scale,
                                  world_size=world_size)
    return VJPResult(out, (q, k, v, out, lse, axis, causal, scale, world_size))


@register_backward(ring_attention.id)
def _ring_attention_bwd(q, k, v, out, lse, axis, causal, scale, world_size, g):
    return ring_attention_bwd(q, k, v, out, lse, g, axis=axis, causal=causal, scale=scale,
                              world_size=world_size)


# ambient sequence-parallel tracing context: set while the model is traced
# under context parallelism so position-dependent code (rope caches) can
# offset by the rank's sequence-block index.
_seq_parallel_ctx: ContextVar = ContextVar("seq_parallel_ctx", default=None)


def current_seq_parallel_ctx():
    """(axis, world_size) when tracing under context parallelism, else None."""
    return _seq_parallel_ctx.get()


class seq_parallel_tracing:
    def __init__(self, axis: str, world_size: int):
        self.value = (axis, world_size)

    def __enter__(self):
        self._tok = _seq_parallel_ctx.set(self.value)
        return self

    def __exit__(self, *exc):
        _seq_parallel_ctx.reset(self._tok)


class ContextParallelTransform(Transform):
    """Swap every sdpa bsym for ring_attention over the `sp` axis."""

    def __init__(self, axis: str = SP_AXIS, world_size: int = 1):
        self.axis = axis
        self.world_size = world_size

    def transform_traces_pre_autodiff(self, prologue_trc, computation_trc, *, compile_data=None):
        axis, n = self.axis, self.world_size

        def repl(q, k, v, attn_mask=None, dropout_p=0.0, is_causal=False, scale=None,
                 enable_gqa=False):
            assert attn_mask is None, "context parallel sdpa does not support explicit masks yet"
            return ring_attention(q, k, v, axis=axis, causal=is_causal, scale=scale, world_size=n)

        def visitor(bsym, args, kwargs):
            if bsym.sym.id == "torch.nn.functional.scaled_dot_product_attention":
                return repl(*args, **kwargs)
            return None

        new_trc = TraceSubstitutionProcessor(computation_trc, visitor)()
        new_trc.set_provenance(f"Context parallel (ring attention over '{axis}')")
        return prologue_trc, new_trc


def context_parallel(tmodule, mesh, *, axis: str = SP_AXIS):
    """Enable ring-attention context parallelism on a ThunderModule: the batch
    sequence dim is split over `axis` and attention runs blockwise around
    the ring. Compose with ddp for 2-D (data × sequence) meshes."""
    from .transforms import (DistPlan, ParamStrategy, _get_plan, _set_plan, add_transform,
                             broadcast_replicated)

    n = mesh.size(axis)
    plan = _get_plan(tmodule) or DistPlan(mesh)
    new = DistPlan(mesh, {}, (), seq_axes=(axis,))
    for name in tmodule.get_parameters():
        new.param_strategies.setdefault(name, [ParamStrategy("replicate", axis)])
    plan = plan.merge(new)
    _set_plan(tmodule, plan)
    broadcast_replicated(tmodule, mesh, axis)
    add_transform(tmodule, ContextParallelTransform(axis, n))
    return tmodule
