"""Gradient bucketing: pack many small grad all-reduces into few big ones.

thunder_tpu/parallel/bucketing.py for the port (reference
thunder/distributed/bucketing.py and the PACK/UNPACK prims of
thunder/distributed/prims.py:21-37). The transform rewrites the backward
trace: N same-axis, same-dtype gradient all-reduces whose results flow only
to RETURN become pack → one all_reduce → unpack, placed where the last of
them was, so one NCCL call moves a bucket of up to ``bucket_size_in_mb``.
pack and unpack only move data, and the reduction is the same elementwise
sum over the same ranks, so on one rank the bucketed program is bit-equal
to the unbucketed one."""
from __future__ import annotations

import math

import torch

from ..core.prims import PrimIDs
from ..core.proxies import TensorProxy
from ..core.symbol import BoundSymbol, Symbol
from ..core.trace import TraceCtx, from_trace, tracectx
from ..core.transform_common import Transform
from ..executors.torchex import ex as torch_ex

# ---------------------------------------------------------------------------
# pack / unpack prims
# ---------------------------------------------------------------------------


def _pack_meta(tensors):
    t0 = tensors[0]
    return TensorProxy(shape=(sum(math.prod(t.shape) for t in tensors),), dtype=t0.dtype, device=t0.device)


def _pack_impl(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unpack_meta(buf, shapes):
    return tuple(TensorProxy(shape=tuple(s), dtype=buf.dtype, device=buf.device) for s in shapes)


def _unpack_impl(buf, shapes):
    # views of the reduced buffer: the gradients the optimizer reads
    return tuple(t.view(s) for t, s in zip(buf.split([math.prod(s) for s in shapes]), shapes))


pack = Symbol("pack", _pack_meta, id="dist.pack", is_prim=True, module="dist")
unpack = Symbol("unpack", _unpack_meta, id="dist.unpack", is_prim=True, module="dist")
torch_ex.register_implementation(pack.id, _pack_impl)
torch_ex.register_implementation(unpack.id, _unpack_impl)


# ---------------------------------------------------------------------------
# the bucketing pass
# ---------------------------------------------------------------------------


def _axis_of(bsym):
    return bsym.args[1] if len(bsym.args) > 1 else bsym.kwargs.get("axis")


class GradBucketingTransform(Transform):
    """Bucket grad all-reduces in the backward trace (bucket_size_in_mb like
    reference thunder.distributed.ddp's bucket_size_in_mb)."""

    def __init__(self, bucket_size_in_mb: float = 25.0):
        self.bucket_bytes = int(bucket_size_in_mb * 1024 * 1024)

    def transform_trace_post_optimization(self, trc: TraceCtx, *, compile_data=None) -> TraceCtx:
        from . import prims as dist_prims

        bsyms = trc.bound_symbols
        consumed: set = set()  # proxies read anywhere but RETURN
        for bsym in bsyms:
            if bsym.sym.id != PrimIDs.RETURN:
                consumed.update(p.name for p in bsym.flat_proxy_args())
        # candidates: an all_reduce whose one tensor output flows only to RETURN
        groups: dict = {}
        for i, bsym in enumerate(bsyms):
            if bsym.sym.id != dist_prims.all_reduce.id:
                continue
            outs = bsym.flat_proxy_outs()
            if len(outs) != 1 or not isinstance(outs[0], TensorProxy) or outs[0].name in consumed:
                continue
            axis = _axis_of(bsym)
            akey = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
            groups.setdefault((akey, outs[0].dtype), []).append(i)

        buckets: list = []
        for (_akey, dt), idxs in groups.items():
            cur, cur_bytes = [], 0
            for i in idxs:
                nbytes = math.prod(bsyms[i].flat_proxy_outs()[0].shape) * dt.bytes
                if cur and cur_bytes + nbytes > self.bucket_bytes:
                    buckets.append(cur)
                    cur, cur_bytes = [], 0
                cur.append(i)
                cur_bytes += nbytes
            buckets.append(cur)
        buckets = [b for b in buckets if len(b) >= 2]
        if not buckets:
            return trc

        new_trace = from_trace(trc)
        drop: set = set()
        splice: dict = {}  # index -> the bsyms emitted there
        rename: dict = {}
        for bucket in buckets:
            ins = [bsyms[i].args[0] for i in bucket]
            outs = [bsyms[i].flat_proxy_outs()[0] for i in bucket]
            with tracectx(new_trace) as ctx:
                with ctx.push_scope() as recorded:
                    red = dist_prims.all_reduce(pack(ins), _axis_of(bsyms[bucket[0]]))
                    unpacked = unpack(red, tuple(tuple(t.shape) for t in ins))
            for old, new in zip(outs, unpacked):
                rename[old.name] = new
            drop.update(bucket)
            splice[bucket[-1]] = list(recorded)

        def sub(x):
            if isinstance(x, TensorProxy) and x.name in rename:
                return rename[x.name]
            if isinstance(x, (tuple, list)):
                return type(x)(sub(e) for e in x)
            if isinstance(x, dict):
                return {k: sub(v) for k, v in x.items()}
            return x

        out_bsyms: list[BoundSymbol] = []
        for i, bsym in enumerate(bsyms):
            out_bsyms.extend(splice.get(i, ()))
            if i not in drop:
                out_bsyms.append(bsym.replace(args=sub(bsym.args), kwargs=sub(bsym.kwargs)))
        new_trace.bound_symbols = out_bsyms
        new_trace.set_provenance(
            f"Gradient bucketing ({len(buckets)} bucket(s) over {sum(len(b) for b in buckets)} all-reduces)")
        return new_trace
