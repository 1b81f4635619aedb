"""Step guards: NaN/Inf detection, skip/rollback policies, bounded retry.

thunder_tpu/robustness/guards.py for the port. A run that hits one NaN
loss at step 90k must not silently optimize into garbage — and must not
necessarily die either. The guard machinery has two halves:

* **in-step** (built by ``TrainStep`` when a guard is attached): the step
  computes ``finite = isfinite(loss) [& isfinite(global_norm(grads))]`` as a
  0-d tensor on the card, inside the step's CUDA graph, and hands it to the
  optimizer. thunder_tpu gates its functional update with ``where(finite,
  new, old)``; the port updates parameters and moments in place, so the
  gate has to sit where the writes are: csrc/adamw.cu reads the flag and
  writes nothing when it is 0 (``cudaex.adamw_update(finite=...)``), SGD
  writes ``where(finite, new, old)``, the device step advances by
  ``finite``, and the buffer writes of the forward (BatchNorm running
  stats, fp8 amax histories) are gated the same way. By the time the host
  could react, the old values exist nowhere else.
* **host-side** (``StepGuard.after_step``): reads the finite flag (one host
  sync — guards are opt-in precisely because of this), counts consecutive
  bad steps, and applies the policy: ``raise`` / ``skip`` (with escalation
  after ``max_consecutive``) / ``rollback`` to the attached
  ``CheckpointManager``'s last checkpoint, restored in place.

Transient errors get bounded retry-with-backoff (``StepGuard.run_with_retry``):
the port treats ``faults.InjectedTransientError`` as transient, and nothing
else. A CUDA error is not retried in-process: a sticky one (an illegal
address, a launch failure) poisons the CUDA context, and every later call
in the process fails; torch raises it as a plain ``RuntimeError`` (or
``torch.AcceleratorError``) that no type tells apart from a non-sticky
one. The recovery for those is a new process and ``CheckpointManager
.restore``. Every intervention is a reason-coded bus event (``guard``
events + ``guard.<action>`` counters).

Guards under a distributed plan (an all-rank verdict reduced across the
mesh, and its agreement counters) are not ported yet (ROADMAP A3c):
``TrainStep`` refuses a guard on a module under any distributed plan.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import Optional

from ..observability import metrics as _obs_metrics

ON_NONFINITE = ("raise", "skip", "rollback")


class NonFiniteLossError(RuntimeError):
    """Loss or gradient norm went NaN/Inf and the policy said raise."""


def transient_errors() -> tuple:
    """Exception types treated as transient/retryable runtime failures: the
    injected one only (see the module docstring for why no CUDA error is)."""
    from .faults import InjectedTransientError

    return (InjectedTransientError,)


@dataclass
class GuardPolicy:
    """What to do when a step goes bad.

    on_nonfinite:     "raise" | "skip" | "rollback"
                      skip: the in-step gate already kept params/opt-state
                      unchanged; training continues on the next batch.
                      rollback: after ``max_consecutive`` bad steps, restore
                      the attached CheckpointManager's last checkpoint.
    max_consecutive:  bad-step budget before skip/rollback escalates
                      (skip escalates to raise; rollback restores, and raises
                      if a second budget is exhausted after restoring).
    check_grad_norm:  also compute/check the global gradient norm in-step.
    retry_transient:  bounded retries for transient runtime errors (0 = off).
    retry_backoff_s:  initial backoff, doubled per retry.
    """

    on_nonfinite: str = "raise"
    max_consecutive: int = 3
    check_grad_norm: bool = True
    retry_transient: int = 0
    retry_backoff_s: float = 0.05

    def __post_init__(self):
        if self.on_nonfinite not in ON_NONFINITE:
            raise ValueError(
                f"on_nonfinite must be one of {ON_NONFINITE}, got {self.on_nonfinite!r}")
        if self.max_consecutive < 1:
            raise ValueError("max_consecutive must be >= 1")


class StepGuard:
    """Host-side half of the guard; attach via ``TrainStep(..., guard=...)``."""

    def __init__(self, policy: Optional[GuardPolicy] = None):
        self.policy = policy or GuardPolicy()
        self.consecutive_bad = 0
        self.skipped = 0
        self.rollbacks = 0
        self.retries = 0
        # rollbacks since the last finite step: a persistent NaN source
        # (corrupt data replayed from the same restored cursor) must raise
        # on the second exhausted budget, not livelock restoring forever
        self._rollbacks_since_good = 0

    def program_key(self) -> str:
        """The part of the guard config that changes the step's program (its
        trace cache key and its CUDA graph's key)."""
        return f"guard(gnorm={self.policy.check_grad_norm})"

    # -- nonfinite policy ---------------------------------------------------

    def after_step(self, train_step, loss, metrics) -> None:
        """Called by TrainStep.__call__ after the step returns. ``metrics``
        is the (finite, grad_norm) pair the step computed on the device."""
        finite, gnorm = metrics
        rec = _obs_metrics.record_intervention
        if bool(finite):  # host sync: the price of guarding
            self.consecutive_bad = 0
            self._rollbacks_since_good = 0
            return
        self.consecutive_bad += 1
        pol = self.policy
        step = train_step._step_count
        gnorm_f = float(gnorm) if pol.check_grad_norm else None
        if pol.on_nonfinite == "raise":
            rec("nonfinite-raise", step=step, grad_norm=gnorm_f)
            raise NonFiniteLossError(
                f"non-finite loss/grad at step {step} "
                f"(loss={float(loss)!r}, grad_norm={gnorm_f!r})")
        if pol.on_nonfinite == "skip":
            self.skipped += 1
            rec("nonfinite-skip", step=step, consecutive=self.consecutive_bad,
                grad_norm=gnorm_f)
            if self.consecutive_bad >= pol.max_consecutive:
                rec("nonfinite-raise", step=step, after_skips=self.consecutive_bad)
                raise NonFiniteLossError(
                    f"{self.consecutive_bad} consecutive non-finite steps "
                    f"(budget {pol.max_consecutive}); last at step {step}")
            return
        # rollback
        self.skipped += 1
        rec("nonfinite-skip", step=step, consecutive=self.consecutive_bad,
            grad_norm=gnorm_f)
        if self.consecutive_bad < pol.max_consecutive:
            return
        mgr = getattr(train_step, "_ckpt_manager", None)
        if mgr is None:
            rec("nonfinite-raise", step=step, rollback="no-manager")
            raise NonFiniteLossError(
                f"{self.consecutive_bad} consecutive non-finite steps and no "
                f"CheckpointManager attached to roll back to (step {step})")
        if self._rollbacks_since_good >= 1:
            rec("nonfinite-raise", step=step, rollback="budget-exhausted")
            raise NonFiniteLossError(
                f"non-finite steps persisted through a rollback (step {step}); "
                f"the fault is deterministic (bad data/model), not transient — "
                f"refusing to livelock restoring the same checkpoint")
        restored = mgr.restore(train_step)
        self.rollbacks += 1
        self._rollbacks_since_good += 1
        self.consecutive_bad = 0
        rec("rollback", step=step, restored_step=restored.get("step"))
        warnings.warn(
            f"rolled back to checkpoint step {restored.get('step')} after "
            f"{self.policy.max_consecutive} consecutive non-finite steps",
            stacklevel=2)

    # -- transient retry ----------------------------------------------------

    def run_with_retry(self, attempt, *, step: int):
        """Run ``attempt()`` with bounded retry-with-backoff on transient
        errors. The retry budget is per-call (per step), the backoff doubles
        per retry. Other errors propagate at once.

        A retry runs the step again from the same inputs. That is safe where
        the failure came before the update, which writes parameters, moments
        and buffers in place at the step's end: an injected transient error
        is raised before the step's first launch."""
        errs = transient_errors()
        retries = self.policy.retry_transient
        backoff = self.policy.retry_backoff_s
        for i in range(retries + 1):
            try:
                return attempt()
            except errs as e:
                if i >= retries:
                    _obs_metrics.record_intervention(
                        "transient-exhausted", step=step, attempts=i + 1,
                        error=f"{type(e).__name__}: {e}"[:200])
                    raise
                self.retries += 1
                _obs_metrics.record_intervention(
                    "transient-retry", step=step, attempt=i + 1,
                    backoff_s=round(backoff, 4),
                    error=f"{type(e).__name__}: {e}"[:200])
                if backoff > 0:
                    time.sleep(backoff)
                backoff *= 2
