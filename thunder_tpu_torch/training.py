"""The training step: forward + backward + optimizer update, one call.

thunder_tpu/training.py:TrainStep, single-device path. thunder_tpu traces the
whole step — prologue-checked forward, backward, optimizer update — into one
``jax.jit`` program that donates the parameters and optimizer state. Here
the step runs op by op: the forward and backward programs that autodiff
builds (transforms/autodiff.py), then the optimizer's in-place update
(optim.py). The parameters live in the module and are written in place, so
``step(*batch) -> loss`` leaves the module trained. Buffers the forward
writes (fp8 amax histories) are replayed onto the module after the update,
as thunder_tpu replays the step's effect outputs; buffers ride in the frozen
argument, read fresh each step. Capturing the step in a CUDA graph (the
counterpart of the jit) is later work.

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

Not ported yet: the step guard, SLO monitoring, bucketed lowering, the AOT
executable cache and no_sync gradient accumulation (``micro_step``).
Asking for one of the arguments or for ``micro_step`` raises
NotImplementedError naming it."""
from __future__ import annotations

import contextlib

import torch

from .common import apply_effects
from .core.pytree import tree_flatten, tree_unflatten
from .nn.module import ThunderModule


class TrainStep:
    """step(*batch) -> loss; updates module parameters in place.

    loss_module: a Module (or the ThunderModule of one) whose forward(*batch)
    returns a scalar loss."""

    def __init__(self, loss_module, optimizer, *, mesh_plan=None, guard=None, slo=None,
                 buckets=None, bucket_pad=None):
        from . import jit as _jit

        if mesh_plan is not None:
            raise NotImplementedError(
                "TrainStep(mesh_plan=...) is not read: the distributed plan rides on the "
                "module (parallel.ddp / parallel.context_parallel)")
        for name, value in (("guard", guard), ("slo", slo), ("buckets", buckets),
                            ("bucket_pad", bucket_pad)):
            if value is not None:
                raise NotImplementedError(f"TrainStep({name}=...) is not ported yet")
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
        cd = self.tmodule._cd
        self._vag = ThunderValueAndGrad(traced_split, argnums=0, transforms=cd.transforms,
                                        executors=cd.executors)
        self._vag.defer_effects = True  # replayed by __call__ after the update

    def __call__(self, *args, **kwargs):
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
        loss, grads = self._vag(tparams, frozen, args, kwargs)
        pending = self._vag.consume_pending_effects()
        if plan is not None and pending is not None:
            raise NotImplementedError(
                "buffer mutations (e.g. BatchNorm running stats) inside a "
                "distributed TrainStep are not supported yet — stats would "
                "need a cross-replica mean; freeze the buffers (module.eval()) "
                "or train without a mesh plan")
        self.optimizer.update(tparams, grads[0][0], self.opt_state)
        if pending is not None:
            apply_effects(*pending)
        self._step_count += 1
        return loss

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
