"""thunder_tpu_torch.robustness: fault-tolerant training for the port.

thunder_tpu/robustness/ for the port's single-process path: preemption-safe
checkpoint/resume (``CheckpointManager``, restored in place into a
captured step), SIGTERM draining (``PreemptionHandler`` / ``Preempted``),
NaN/rollback/retry step guards (``StepGuard`` / ``GuardPolicy``, gated
inside the step: csrc/adamw.cu's skip flag), and the deterministic
fault-injection harness (``faults``, the TT_FAULT env knob) that keeps every
recovery path covered by tests. The distributed half (sharded checkpoints,
all-rank guard verdicts, ``DesyncError``/``check_in_sync``) is not ported
yet (ROADMAP A3c).

Quick start::

    from thunder_tpu_torch.robustness import CheckpointManager, GuardPolicy, StepGuard

    guard = StepGuard(GuardPolicy(on_nonfinite="skip", retry_transient=2))
    step = TrainStep(tm, optim.AdamW(1e-3), guard=guard)
    batches = loader.prefetched()
    mgr = CheckpointManager("ckpts/", every_n_steps=500, loader=batches).attach(step)
    try:
        for x, y in batches:
            step(x, y)
    except robustness.Preempted:
        pass                      # final checkpoint is durable; exit cleanly
    # fresh process: CheckpointManager("ckpts/", loader=loader).restore(step)
"""
from __future__ import annotations

from . import faults  # noqa: F401
from .checkpoint_manager import (  # noqa: F401
    CheckpointError,
    CheckpointManager,
    list_steps,
    read_meta,
    validate_step,
)
from .guards import GuardPolicy, NonFiniteLossError, StepGuard  # noqa: F401
from .preemption import Preempted, PreemptionHandler  # noqa: F401
