"""The training step: forward + backward + optimizer update, one call.

thunder_tpu/training.py:TrainStep, single-device path. thunder_tpu traces the
whole step — prologue-checked forward, backward, optimizer update — into one
``jax.jit`` program that donates the parameters and optimizer state. Here
the step is the forward and backward programs that autodiff builds
(transforms/autodiff.py), then the optimizer's in-place update (optim.py).
The parameters live in the module and are written in place, so
``step(*batch) -> loss`` leaves the module trained. Buffers the forward
writes (fp8 amax histories) are replayed onto the module after the update,
as thunder_tpu replays the step's effect outputs; buffers ride in the frozen
argument, read fresh each step.

On the card the whole step is one CUDA graph (``cuda_graphs=True``, the
default; executors/graphex.py), the counterpart of thunder_tpu's one
``jax.jit``: the first call of a batch signature runs op by op, the second
captures forward, backward, the update and the buffer writes (written into
the module's buffers), later calls replay. Parameters, buffers and the
optimizer state are read and written in place; the batch is copied into
the graph's buffers; the loss comes back as the caller's tensor. CPU
tensors run op by op. ``buckets=`` (a ``BucketLadder``) pads each batch
leaf along ``bucket_axis`` to its rung (``compile_service.pad_to_bucket``,
fill values from ``bucket_pad``, e.g. -100 for targets), so every length in
a rung is one program and one graph.

Distributed plans (parallel/): a module wrapped by ``ddp`` and/or
``context_parallel`` carries a ``_dist_plan``, and its step is one program
per rank, as thunder_tpu's step is one ``shard_map`` program per device.
The caller passes the global batch on every rank; each rank takes its own
block by thunder_tpu's ``_batch_pspec`` rule (dim 0 over the data axes,
dim 1 over the sequence axes, the latter for leaves of rank >= 2). The
traced step inserts each parameter's collectives (``synchronize``: the
gradient all-reduce), traces the model under ``seq_parallel_tracing`` when
the plan has a sequence axis, and returns ``all_reduce(local loss) /
loss_world_size`` — the loss every rank gets back. The plan rides on the
module, so ``mesh_plan=`` (which thunder_tpu stores and never reads)
raises NotImplementedError naming ``ddp``/``context_parallel``.

A distributed step is captured too when its collectives capture on the
rank: a one-rank NCCL group's do. Asking for capture of a step over a
multi-rank group raises NotImplementedError naming ROADMAP A3b (pass
``cuda_graphs=False``); over Gloo (the CPU) it runs op by op. Before a
capture the forward and backward traces are checked as ``jit``'s are
(graphex.check_capturable): a host sync or host-side effect raises, naming
the symbol.

Not ported yet: the step guard, SLO monitoring, the AOT executable cache
and no_sync gradient accumulation (``micro_step``). Asking for one of the
arguments or for ``micro_step`` raises NotImplementedError naming it."""
from __future__ import annotations

import contextlib

import torch

from .common import apply_effects
from .compile_service.buckets import BucketLadder, pad_to_bucket
from .core.pytree import tree_flatten, tree_unflatten
from .executors import graphex
from .nn.module import ThunderModule


class TrainStep:
    """step(*batch) -> loss; updates module parameters in place.

    loss_module: a Module (or the ThunderModule of one) whose forward(*batch)
    returns a scalar loss."""

    def __init__(self, loss_module, optimizer, *, mesh_plan=None, guard=None, slo=None,
                 buckets=None, bucket_pad=None, bucket_axis: int = 1, cuda_graphs: bool = True):
        from . import jit as _jit

        if mesh_plan is not None:
            raise NotImplementedError(
                "TrainStep(mesh_plan=...) is not read: the distributed plan rides on the "
                "module (parallel.ddp / parallel.context_parallel)")
        for name, value in (("guard", guard), ("slo", slo)):
            if value is not None:
                raise NotImplementedError(f"TrainStep({name}=...) is not ported yet")
        if buckets is not None and not isinstance(buckets, BucketLadder):
            raise TypeError(f"TrainStep(buckets=...) takes a BucketLadder, got {type(buckets).__name__}")
        if bucket_pad is not None and not isinstance(bucket_pad, dict):
            raise TypeError(f"TrainStep(bucket_pad=...) takes a dict of fill values by argument, "
                            f"got {type(bucket_pad).__name__}")
        if isinstance(loss_module, torch.nn.Module):
            loss_module = _jit(loss_module)
        if not isinstance(loss_module, ThunderModule):
            raise TypeError("TrainStep expects a Module or ThunderModule computing a scalar loss")
        self.tmodule = loss_module
        self.optimizer = optimizer
        self.opt_state = None
        self._vag = None
        self._pairs = None
        self._step_count = 0
        self.buckets = buckets
        self.bucket_pad = dict(bucket_pad or {})
        self.bucket_axis = bucket_axis
        self.cuda_graphs = cuda_graphs
        self._programs: dict = {}  # batch signature -> graphex.CUDAGraphProgram
        self._pool = graphex.GraphPool()

    @property
    def _cs(self):
        """The compile stats of the step's programs: ``last_traces(step)``
        and ``last_backward_traces(step)`` read them."""
        if self._vag is None:
            raise ValueError("TrainStep has not run yet")
        return self._vag._cs

    @property
    def step_count(self) -> int:
        return self._step_count

    def _split(self):
        """(trainable params, frozen params and buffers) by qualified name;
        the name → Parameter pairs are walked once."""
        if self._pairs is None:
            params = self.tmodule.get_parameters()
            self._pairs = tuple(params.items())
        trainable = {k: p for k, p in self._pairs if p.requires_grad}
        frozen = {k: p for k, p in self._pairs if not p.requires_grad}
        frozen.update(self.tmodule.get_buffers())
        return trainable, frozen

    @property
    def _plan(self):
        return getattr(self.tmodule, "_dist_plan", None)

    def _build(self):
        from .transforms.autodiff import ThunderValueAndGrad

        inner = self.tmodule._cd.fn
        plan = self._plan
        if plan is None:
            traced = inner
        else:
            from .ops import ltorch
            from .parallel import prims as dist_prims
            from .parallel.context_parallel import seq_parallel_tracing
            from .parallel.transforms import apply_param_collectives

            def traced(params: dict, args: tuple, kwargs: dict):
                seq_axes = tuple(plan.seq_axes)
                cp_ctx = (seq_parallel_tracing(seq_axes[0], plan.world_size(seq_axes[0]))
                          if seq_axes else contextlib.nullcontext())
                full_params = apply_param_collectives(params, plan)
                with cp_ctx:
                    local_loss = inner(full_params, args, kwargs)
                if plan.loss_axes:
                    s = dist_prims.all_reduce(local_loss, plan.loss_axes)
                    return ltorch.div(s, float(plan.loss_world_size))
                return local_loss

        # frozen (requires_grad=False) params and buffers ride as a separate,
        # non-differentiated argument
        def traced_split(tparams: dict, frozen: dict, args: tuple, kwargs: dict):
            return traced({**frozen, **tparams}, args, kwargs)

        traced_split.__name__ = getattr(inner, "__name__", "step")
        traced_split.__cache_extra__ = getattr(inner, "__cache_extra__", None)
        cd = self.tmodule._cd
        self._vag = ThunderValueAndGrad(traced_split, argnums=0, transforms=cd.transforms,
                                        executors=cd.executors)
        self._vag.defer_effects = True  # replayed by __call__ after the update

    def _bucketize(self, args, kwargs):
        """Pad batch leaves to the ladder's rung (thunder_tpu's _bucketize):
        every length in a rung then has one cache key, one program and one
        graph. The rung's traffic is recorded as the serving engine records
        its prefill buckets."""
        if self.buckets is None:
            return args, kwargs
        for a in args:
            shape = getattr(a, "shape", None)
            if shape is not None and len(shape) > self.bucket_axis:
                self.buckets.touch(int(shape[self.bucket_axis]))
                break
        return pad_to_bucket(args, kwargs, self.buckets, axis=self.bucket_axis, pad_values=self.bucket_pad)

    def __call__(self, *args, **kwargs):
        args, kwargs = self._bucketize(args, kwargs)
        tparams, frozen = self._split()
        plan = self._plan
        if plan is not None:
            from .parallel.mesh import set_active_mesh

            set_active_mesh(plan.mesh)
            args, kwargs = _local_batch(plan, args, kwargs)
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(tparams)
        if self._vag is None:
            self._build()
        first = next(iter(tparams.values()), None)
        if self.cuda_graphs and first is not None and graphex.captures_on(first.device):
            loss = self._graphed(tparams, frozen, args, kwargs)
        else:
            loss = self._step(tparams, frozen, args, kwargs, in_place=False)
        self._step_count += 1
        return loss

    def _step(self, tparams, frozen, args, kwargs, in_place: bool):
        """Forward, backward, the update, then the forward's buffer writes
        (into the module's buffers when ``in_place``: a CUDA graph's)."""
        loss, grads = self._vag(tparams, frozen, args, kwargs)
        pending = self._vag.consume_pending_effects()
        if self._plan is not None and pending is not None:
            raise NotImplementedError(
                "buffer mutations (e.g. BatchNorm running stats) inside a "
                "distributed TrainStep are not supported yet — stats would "
                "need a cross-replica mean; freeze the buffers (module.eval()) "
                "or train without a mesh plan")
        self.optimizer.update(tparams, grads[0][0], self.opt_state)
        if pending is not None:
            apply_effects(*pending, in_place=in_place)
        return loss

    def _graphed(self, tparams, frozen, args, kwargs):
        """The step as one CUDA graph per batch signature. Inputs: the
        parameters, buffers and optimizer state (in place), then the batch's
        tensors (copied into the graph's buffers)."""
        from . import _cache_key

        leaves, treedef = tree_flatten((args, kwargs))
        is_t = [isinstance(x, torch.Tensor) for x in leaves]
        state = [t for t in tree_flatten(self.opt_state)[0] if isinstance(t, torch.Tensor)]
        resident = [*tparams.values(), *frozen.values(), *state]
        key = (tuple(tparams), tuple(frozen), _cache_key(leaves, is_t, self._vag.fn))
        prog = self._programs.get(key)
        if prog is None:
            nt, nf, nr = len(tparams), len(frozen), len(resident)

            def step(*flat):
                tp = dict(zip(tparams, flat[:nt]))
                fz = dict(zip(frozen, flat[nt:nt + nf]))
                batch = iter(flat[nr:])
                a, kw = tree_unflatten([next(batch) if t else x for x, t in zip(leaves, is_t)], treedef)
                return self._step(tp, fz, a, kw, in_place=True)

            prog = self._programs[key] = graphex.CUDAGraphProgram(
                step, name="TrainStep", in_place=[True] * nr + [False] * sum(is_t), pool=self._pool,
                stats=self._vag._cs, check=self._check_capturable)
        return prog(*resident, *(x for x, t in zip(leaves, is_t) if t))

    def _check_capturable(self):
        """The forward and backward traces of the last compile hold nothing
        a graph cannot (graphex.check_capturable raises, naming it)."""
        graphex.check_capturable(self._cs.last_traces[-1], "TrainStep forward")
        graphex.check_capturable(self._cs.last_backward_traces[-1], "TrainStep backward")

    def micro_step(self, *args, **kwargs):
        raise NotImplementedError("TrainStep.micro_step (no_sync gradient accumulation) is not "
                                  "ported yet")


def _local_batch(plan, args: tuple, kwargs: dict):
    """This rank's block of the global batch (thunder_tpu's _batch_pspec):
    tensor leaves split along dim 0 over the data axes and, from rank 2 up,
    along dim 1 over the sequence axes; 0-d leaves whole."""
    mesh = plan.mesh
    cuts = []
    if plan.data_axes:
        cuts.append((0, tuple(plan.data_axes), "data-parallel"))
    if plan.seq_axes:
        cuts.append((1, tuple(plan.seq_axes), "sequence-parallel"))
    leaves, treedef = tree_flatten((args, kwargs))
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            for dim, axes, kind in cuts:
                if leaf.ndim <= dim:
                    continue
                n = mesh.size(axes)
                if leaf.shape[dim] % n:
                    raise ValueError(
                        f"batch dim {dim} ({leaf.shape[dim]}) is not divisible by the "
                        f"{kind} world size {n} (axes {axes}); pad or resize the batch")
                b = leaf.shape[dim] // n
                leaf = leaf.narrow(dim, mesh.coordinate(axes) * b, b)
            leaf = leaf.contiguous()
        out.append(leaf)
    return tree_unflatten(out, treedef)
