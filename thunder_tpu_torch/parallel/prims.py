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
  all_gather:   fwd gather along dim 0       / bwd reduce_scatter(sum)
  reduce_scatter: fwd sum, scatter dim 0     / bwd all_gather
  synchronize_tensor_parallel_input:  fwd identity   / bwd all_reduce
  synchronize_tensor_parallel_output: fwd all_reduce / bwd identity
  all_to_all:   fwd split one dim over the ranks, concatenate another
                                             / bwd the inverse exchange
  broadcast:    fwd the root coordinate's value (no grad rule)
  wait:         identity (the calls are synchronous on the stream)

``ring_shift`` is the point-to-point step of the ring attention loops:
one ``batch_isend_irecv`` to the next rank of an axis and from the
previous one, posted together (no blocking send waits on its receive).

Each of all_gather, reduce_scatter, all_to_all and broadcast is one
out-of-place call (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``broadcast`` of a copy). A collective on CUDA
tensors needs the axis's group to be NCCL's: without one it raises, so a
plan never runs a card's step as if it were alone.

thunder_tpu's ``FutureTensorProxy`` and its ``wait`` exist for XLA's
scheduler; here every call is enqueued on the current stream, in trace
order, and ``wait`` is kept for the API."""
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


def _group(x: torch.Tensor, axis):
    """The process group of ``axis`` on the active mesh (None: no process
    group, every axis of size 1). CUDA tensors need an NCCL group."""
    import torch.distributed as dist

    group = _mesh.active_mesh().group(axis)
    if x.device.type == "cuda" and (group is None or dist.get_backend(group) != "nccl"):
        raise RuntimeError(
            f"a collective over {axis!r} on CUDA tensors needs an NCCL process group "
            f"(multiprocess.initialize), have {'none' if group is None else dist.get_backend(group)}")
    return group


def _all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    import torch.distributed as dist

    group = _group(x, axis)
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
    group = _group(x, axis)
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
    n, me, ranks = m.size(axis), m.coordinate(axis), m.ranks(axis)
    if n == 1:
        return list(tensors), lambda: None
    group = _group(tensors[0], axis)
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



# ---------------------------------------------------------------------------
# all_gather / reduce_scatter — the FSDP unshard and its gradient sync
# ---------------------------------------------------------------------------


def _all_gather_meta(x: TensorProxy, axis, *, world_size: int):
    return TensorProxy(shape=(x.shape[0] * world_size,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)


def _all_gather_impl(x, axis, *, world_size: int):
    """The ranks' blocks stacked along dim 0 in coordinate order."""
    import torch.distributed as dist

    group = _group(x, axis)
    x = x.contiguous()
    if group is None:
        return x.clone()
    out = torch.empty((x.shape[0] * world_size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


all_gather = _make_coll("all_gather", _all_gather_meta, _all_gather_impl)


@register_augmented_forward(all_gather.id)
def _all_gather_aug(x, axis, *, world_size):
    return VJPResult(all_gather(x, axis, world_size=world_size), (axis, world_size))


@register_backward(all_gather.id)
def _all_gather_bwd(axis, world_size, g):
    return reduce_scatter(g, axis, world_size=world_size)


def _reduce_scatter_meta(x: TensorProxy, axis, *, world_size: int):
    assert x.shape[0] % world_size == 0, f"reduce_scatter dim0 {x.shape[0]} % {world_size}"
    return TensorProxy(shape=(x.shape[0] // world_size,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)


def _reduce_scatter_impl(x, axis, *, world_size: int):
    """This rank's block of dim 0 of the ranks' sum."""
    import torch.distributed as dist

    group = _group(x, axis)
    x = x.contiguous()
    if group is None:
        return x.clone()
    out = torch.empty((x.shape[0] // world_size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


reduce_scatter = _make_coll("reduce_scatter", _reduce_scatter_meta, _reduce_scatter_impl)


@register_augmented_forward(reduce_scatter.id)
def _reduce_scatter_aug(x, axis, *, world_size):
    return VJPResult(reduce_scatter(x, axis, world_size=world_size), (axis, world_size))


@register_backward(reduce_scatter.id)
def _reduce_scatter_bwd(axis, world_size, g):
    return all_gather(g, axis, world_size=world_size)


# ---------------------------------------------------------------------------
# the tensor-parallel boundary syncs (Megatron's f and g)
# ---------------------------------------------------------------------------

synchronize_tensor_parallel_input = _make_coll("synchronize_tensor_parallel_input", _identity_meta,
                                               lambda x, axis: x)


@register_augmented_forward(synchronize_tensor_parallel_input.id)
def _tp_in_aug(x, axis):
    return VJPResult(synchronize_tensor_parallel_input(x, axis), (axis,))


@register_backward(synchronize_tensor_parallel_input.id)
def _tp_in_bwd(axis, g):
    return all_reduce(g, axis)


synchronize_tensor_parallel_output = _make_coll("synchronize_tensor_parallel_output", _identity_meta,
                                                _all_reduce)


@register_augmented_forward(synchronize_tensor_parallel_output.id)
def _tp_out_aug(x, axis):
    return VJPResult(synchronize_tensor_parallel_output(x, axis), (axis,))


@register_backward(synchronize_tensor_parallel_output.id)
def _tp_out_bwd(axis, g):
    return g


# ---------------------------------------------------------------------------
# all_to_all — the expert-parallel token exchange
# ---------------------------------------------------------------------------


def _all_to_all_meta(x: TensorProxy, axis, split_axis: int, concat_axis: int, *, world_size: int):
    shape = list(x.shape)
    assert shape[split_axis] % world_size == 0, f"all_to_all dim {split_axis} {shape[split_axis]} % {world_size}"
    shape[split_axis] //= world_size
    shape[concat_axis] *= world_size
    return TensorProxy(shape=tuple(shape), dtype=x.dtype, device=x.device)


def _all_to_all_impl(x, axis, split_axis, concat_axis, *, world_size):
    """lax.all_to_all(tiled=True): block i of ``split_axis`` goes to
    coordinate i; the blocks received are concatenated along
    ``concat_axis`` in the senders' coordinate order."""
    import torch.distributed as dist

    group = _group(x, axis)
    n = world_size
    send = torch.stack(x.chunk(n, split_axis)) if split_axis else x.reshape((n, -1) + tuple(x.shape[1:]))
    send = send.contiguous()
    if group is None:
        recv = send.clone()
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), concat_axis) if concat_axis else recv.reshape(
        (-1,) + tuple(recv.shape[2:]))


all_to_all = _make_coll("all_to_all", _all_to_all_meta, _all_to_all_impl)


@register_augmented_forward(all_to_all.id)
def _all_to_all_aug(x, axis, split_axis, concat_axis, *, world_size):
    return VJPResult(all_to_all(x, axis, split_axis, concat_axis, world_size=world_size),
                     (axis, split_axis, concat_axis, world_size))


@register_backward(all_to_all.id)
def _all_to_all_bwd(axis, split_axis, concat_axis, world_size, g):
    # the inverse exchange: what came from coordinate j goes back to it
    return all_to_all(g, axis, concat_axis, split_axis, world_size=world_size)


# ---------------------------------------------------------------------------
# broadcast / wait
# ---------------------------------------------------------------------------


def _broadcast_impl(x, axis, root=0):
    """Every rank of the axis takes coordinate ``root``'s value."""
    import torch.distributed as dist

    group = _group(x, axis)
    y = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.broadcast(y, src=_mesh.active_mesh().ranks(axis)[root], group=group)
    return y


broadcast = _make_coll("broadcast", lambda x, axis, root=0: _identity_meta(x, axis), _broadcast_impl)
wait = _make_coll("wait", lambda x: TensorProxy(shape=x.shape, dtype=x.dtype, device=x.device),
                  lambda x: x)


@register_augmented_forward(wait.id)
def _wait_aug(x):
    return VJPResult(wait(x), ())


@register_backward(wait.id)
def _wait_bwd(g):
    return g
