"""Collective primitives: IR symbols whose impls call torch.distributed.

thunder_tpu/parallel/prims.py for the port: the same ``dist.*`` symbols,
metas and grad rules. thunder_tpu lowers them to XLA collectives over the
mesh axes of a ``shard_map`` program; here the torch executor runs each as
one ``torch.distributed`` call on the process group of the axis (or axes)
on the active mesh (parallel/mesh.py). Every impl is out of place: a value
of the trace is never written. On an axis of size 1 without a process
group a collective is an identity.

  all_reduce:   fwd sum over the axis        / bwd identity
  pmean:        fwd mean over the axis       / bwd g / N
  synchronize:  fwd identity (a DDP marker)  / bwd all_reduce(sum)
  axis_index:   this rank's coordinate along the axis (0-d int32)
  ppermute:     fwd send to perm's target    / bwd the inverse permutation

``ring_shift`` is the point-to-point step of the ring attention loops:
one ``batch_isend_irecv`` to the next rank of an axis and from the
previous one, posted together (no blocking send waits on its receive).

all_gather, reduce_scatter, all_to_all, broadcast, wait and the tensor-
parallel syncs are not ported yet (ROADMAP A3b)."""
from __future__ import annotations

import torch

from ..core import devices, dtypes
from ..core.proxies import TensorProxy
from ..core.symbol import OpTags, Symbol
from ..executors.torchex import ex as torch_ex
from ..ops import clang
from ..transforms.autodiff import VJPResult, register_augmented_forward, register_backward
from . import mesh as _mesh

_COLL_TAGS = (OpTags.COLLECTIVE,)


def _make_coll(name: str, meta, impl) -> Symbol:
    sym = Symbol(name, meta, id=f"dist.{name}", is_prim=True, module="dist", tags=_COLL_TAGS)
    torch_ex.register_implementation(sym.id, impl)
    return sym


def _identity_meta(x: TensorProxy, axis, **kw):
    return TensorProxy(shape=x.shape, dtype=x.dtype, device=x.device)


def _all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    import torch.distributed as dist

    group = _mesh.active_mesh().group(axis)
    y = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(y, group=group)
    return y


# ---------------------------------------------------------------------------
# all_reduce (psum) / pmean
# ---------------------------------------------------------------------------

all_reduce = _make_coll("all_reduce", _identity_meta, _all_reduce)


@register_augmented_forward(all_reduce.id)
def _all_reduce_aug(x, axis):
    return VJPResult(all_reduce(x, axis), (axis,))


@register_backward(all_reduce.id)
def _all_reduce_bwd(axis, g):
    # out_i = sum_j x_j ; replicated cotangent flows straight through
    return g


def _pmean_impl(x, axis, *, world_size):
    return _all_reduce(x, axis) / world_size


def _pmean_meta(x, axis, *, world_size):
    return TensorProxy(shape=x.shape, dtype=x.dtype, device=x.device)


pmean = _make_coll("pmean", _pmean_meta, _pmean_impl)


@register_augmented_forward(pmean.id)
def _pmean_aug(x, axis, *, world_size):
    return VJPResult(pmean(x, axis, world_size=world_size), (world_size,))


@register_backward(pmean.id)
def _pmean_bwd(world_size, g):
    # out = (1/N) sum_i x_i: each local input sees g/N
    return clang.true_divide(g, float(world_size))


# ---------------------------------------------------------------------------
# synchronize — the DDP parameter marker: fwd identity, bwd all-reduce of
# the gradient
# ---------------------------------------------------------------------------


synchronize = _make_coll("synchronize", _identity_meta, lambda x, axis: x)


@register_augmented_forward(synchronize.id)
def _sync_aug(x, axis):
    return VJPResult(synchronize(x, axis), (axis,))


@register_backward(synchronize.id)
def _sync_bwd(axis, g):
    return all_reduce(g, axis)


# ---------------------------------------------------------------------------
# axis_index — the rank's coordinate along a mesh axis
# ---------------------------------------------------------------------------


def _axis_index_meta(axis):
    return TensorProxy(shape=(), dtype=dtypes.int32, device=devices.to_device("cpu"))


def _axis_index_impl(axis):
    # a 0-d host tensor: it enters device arithmetic as a scalar, no copy
    return torch.tensor(_mesh.active_mesh().coordinate(axis), dtype=torch.int32)


axis_index = _make_coll("axis_index", _axis_index_meta, _axis_index_impl)


# ---------------------------------------------------------------------------
# ppermute — send along a permutation of an axis's coordinates
# ---------------------------------------------------------------------------


def _ppermute_meta(x: TensorProxy, axis, perm):
    return TensorProxy(shape=x.shape, dtype=x.dtype, device=x.device)


def _ppermute_impl(x, axis, perm):
    """Coordinate src sends x to dst for every (src, dst) of perm; a
    coordinate no pair targets receives zeros (lax.ppermute's rule)."""
    import torch.distributed as dist

    m = _mesh.active_mesh()
    me, ranks = m.coordinate(axis), m.ranks(axis)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    group = m.group(axis)
    for d in dsts:
        if d == me:
            out.copy_(x)
        else:
            ops.append(dist.P2POp(dist.isend, x, ranks[d], group))
    for s in srcs:
        if s != me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


ppermute = _make_coll("ppermute", _ppermute_meta, _ppermute_impl)


@register_augmented_forward(ppermute.id)
def _ppermute_aug(x, axis, perm):
    return VJPResult(ppermute(x, axis, perm), (axis, tuple(perm)))


@register_backward(ppermute.id)
def _ppermute_bwd(axis, perm, g):
    inv = tuple((dst, src) for (src, dst) in perm)
    return ppermute(g, axis, inv)


# ---------------------------------------------------------------------------
# the ring step of the ring attention loops
# ---------------------------------------------------------------------------


def ring_shift(tensors, axis):
    """Post the transfer of each tensor to the next coordinate of ``axis``
    (c -> c + 1 mod n) and the receive of its successor from the previous
    one, into fresh buffers, as one ``batch_isend_irecv``. Returns
    ``(received, wait)``: the buffers hold the data once ``wait()`` has
    returned (on the card: once the current stream has been made to wait
    for the transfers, so the caller may run kernels in between). Every
    rank of the axis must post the same list in the same order. Each
    tensor rides under its own tag, so Gloo matches them one to one."""
    import torch.distributed as dist

    m = _mesh.active_mesh()
    n, me, ranks, group = m.size(axis), m.coordinate(axis), m.ranks(axis), m.group(axis)
    if n == 1:
        return list(tensors), lambda: None
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    sent = [t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in sent]
    ops = []
    for i, (t, r) in enumerate(zip(sent, recv)):
        ops.append(dist.P2POp(dist.isend, t, nxt, group, tag=i))
        ops.append(dist.P2POp(dist.irecv, r, prv, group, tag=i))
    works = dist.batch_isend_irecv(ops)

    def wait():
        for w in works:
            w.wait()
        sent.clear()

    return recv, wait

