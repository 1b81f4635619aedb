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

Not ported yet: distributed plans (``mesh_plan``), the step guard, SLO
monitoring, bucketed lowering, the AOT executable cache and no_sync
gradient accumulation (``micro_step``). Asking for one of the arguments or
for ``micro_step`` raises NotImplementedError naming it."""
from __future__ import annotations

import torch

from .common import apply_effects
from .nn.module import ThunderModule


class TrainStep:
    """step(*batch) -> loss; updates module parameters in place.

    loss_module: a Module (or the ThunderModule of one) whose forward(*batch)
    returns a scalar loss."""

    def __init__(self, loss_module, optimizer, *, mesh_plan=None, guard=None, slo=None,
                 buckets=None, bucket_pad=None):
        from . import jit as _jit

        for name, value in (("mesh_plan", mesh_plan), ("guard", guard), ("slo", slo),
                            ("buckets", buckets), ("bucket_pad", bucket_pad)):
            if value is not None:
                raise NotImplementedError(
                    f"TrainStep({name}=...) is not ported yet: the port's TrainStep is the "
                    f"single-device path")
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

    def _build(self):
        from .transforms.autodiff import ThunderValueAndGrad

        inner = self.tmodule._cd.fn

        # frozen (requires_grad=False) params and buffers ride as a separate,
        # non-differentiated argument
        def traced_split(tparams: dict, frozen: dict, args: tuple, kwargs: dict):
            return inner({**frozen, **tparams}, args, kwargs)

        traced_split.__name__ = getattr(inner, "__name__", "step")
        cd = self.tmodule._cd
        self._vag = ThunderValueAndGrad(traced_split, argnums=0, transforms=cd.transforms,
                                        executors=cd.executors)
        self._vag.defer_effects = True  # replayed by __call__ after the update

    def __call__(self, *args, **kwargs):
        tparams, frozen = self._split()
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(tparams)
        if self._vag is None:
            self._build()
        loss, grads = self._vag(tparams, frozen, args, kwargs)
        self.optimizer.update(tparams, grads[0][0], self.opt_state)
        pending = self._vag.consume_pending_effects()
        if pending is not None:
            apply_effects(*pending)
        self._step_count += 1
        return loss

    def micro_step(self, *args, **kwargs):
        raise NotImplementedError("TrainStep.micro_step (no_sync gradient accumulation) is not "
                                  "ported yet")
