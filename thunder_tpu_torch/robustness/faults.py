"""Deterministic fault injection: every recovery path is exercised, not trusted.

thunder_tpu/robustness/faults.py for the port, with the same plan syntax,
kinds and firing rules. A fault-tolerance layer that is only ever executed
by real outages silently rots; this module injects each fault class the
robustness stack recovers from at an exact step index, so each policy's
observable outcome is pinned by tests:

  nan_loss    scale the first floating tensor leaf of the step's batch by
              NaN, on whatever device it is, so the loss is genuinely NaN
              (exercises the in-step finite gate and StepGuard's policies;
              a token batch has no float leaf and raises)
  transient   raise ``InjectedTransientError`` at dispatch time, N times
              (exercises bounded retry-with-backoff)
  ckpt_fail   raise ``InjectedCheckpointError`` inside the checkpoint write
              (exercises non-fatal save failures / strict mode)
  preempt     deliver a real SIGTERM to this process after the step completes
              (exercises the PreemptionHandler -> final save -> Preempted path)
  die         kill THIS process abruptly (``os._exit``) at dispatch time —
              no atexit, no finally, no final checkpoint; the real shape of
              a host lost mid-step (exercises kill-and-resume)
  slow        sleep ``ms`` milliseconds at the step boundary (a straggling
              host); ``slow(30)@0*24`` makes 24 steps ~30 ms slower, each
              firing a ``data_stall`` bus event when the bus is on
  oom         raise ``torch.cuda.OutOfMemoryError`` at dispatch time, with
              the allocator's message shape (thunder_tpu raises its
              RESOURCE_EXHAUSTED XlaRuntimeError; the OOM post-mortem
              bundle is not ported yet: ROADMAP A6)

  ``:host=<p>`` scopes any fault to one process of a multi-process run;
  unscoped faults fire on every process. The process index resolves
  lazily: the TT_MP_PROC env var, else ``parallel.multiprocess
  .process_index()`` (torch.distributed's rank once a group is joined,
  else 0), read the first time a scoped fault is consulted.

Enablement:
  TT_FAULT=nan_loss@5,transient@7*2,preempt@9    env knob, parsed at import
  faults.configure("ckpt_fail@4:host=1")         the same, programmatically
  faults.clear()                                 disarm (tests)

``<kind>@<step>`` fires once at 0-based step index ``step``; ``*<count>``
makes it fire at ``count`` consecutive opportunities starting there
(``nan_loss@5*3`` poisons steps 5,6,7; ``transient@5*2`` fails the first two
dispatch attempts of step 5 — retries within one step re-consult the plan).
Kinds that take a parameter write it in parens: ``slow(30)@0*10`` (the
argument defaults per kind — 50 ms for ``slow``).

Zero-overhead discipline: with no plan configured (the default), the hot-path
check is a single module-global ``is None`` test (``active()``), mirroring the
disabled observability bus.
"""
from __future__ import annotations

import os
import signal
from typing import Optional

KINDS = ("nan_loss", "transient", "ckpt_fail", "preempt", "die", "slow", "oom")

# default per-step delay for a bare `slow@N` fault (no explicit `(ms)` arg)
DEFAULT_SLOW_MS = 50.0

# exit status of an injected `die` fault: distinct from every python/pytest
# code so the multi-process harness can assert the host died BY INJECTION
DIE_EXIT_CODE = 77


class InjectedTransientError(RuntimeError):
    """A simulated transient executor/runtime failure (retryable)."""


class InjectedCheckpointError(OSError):
    """A simulated checkpoint-write failure."""


class _Fault:
    __slots__ = ("kind", "step", "count", "fired", "host", "arg")

    def __init__(self, kind: str, step: int, count: int = 1,
                 host: Optional[int] = None, arg: Optional[float] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; expected one of {KINDS}")
        if step < 0 or count < 1:
            raise ValueError(f"fault {kind}@{step}*{count}: step must be >= 0, count >= 1")
        if host is not None and host < 0:
            raise ValueError(f"fault {kind}@{step}: host index must be >= 0, got {host}")
        if arg is not None and arg < 0:
            raise ValueError(f"fault {kind}@{step}: argument must be >= 0, got {arg}")
        self.kind = kind
        self.step = step
        self.count = count
        self.fired = 0
        self.host = host
        self.arg = arg

    def __repr__(self) -> str:
        param = "" if self.arg is None else f"({self.arg:g})"
        scope = "" if self.host is None else f":host={self.host}"
        return f"{self.kind}{param}@{self.step}*{self.count}{scope}(fired={self.fired})"


# lazily-resolved process index for host-scoped faults: None until a scoped
# fault is actually consulted, so arming a plan never touches distributed
# state. TT_MP_PROC (a harness env) wins over the joined group's rank.
_HOST_INDEX: Optional[int] = None


def _host_index() -> int:
    global _HOST_INDEX
    if _HOST_INDEX is None:
        env = os.environ.get("TT_MP_PROC")
        if env is not None:
            _HOST_INDEX = int(env)
        else:
            from ..parallel import multiprocess

            _HOST_INDEX = multiprocess.process_index()
    return _HOST_INDEX


def _reset_host_index() -> None:
    """Test seam: re-resolve the process index (the cache would otherwise
    leak a host index across tests that monkeypatch TT_MP_PROC)."""
    global _HOST_INDEX
    _HOST_INDEX = None


class FaultPlan:
    """Parsed TT_FAULT spec: an ordered list of armed faults."""

    def __init__(self, faults: list[_Fault]):
        self.faults = faults

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "@" not in part:
                raise ValueError(
                    f"bad TT_FAULT entry {part!r}: expected "
                    f"<kind>@<step>[*<count>][:host=<p>]")
            kind, _, rest = part.partition("@")
            kind = kind.strip()
            arg = None
            if "(" in kind:
                kind, _, argtxt = kind.partition("(")
                argtxt = argtxt.strip()
                if not argtxt.endswith(")"):
                    raise ValueError(
                        f"bad TT_FAULT entry {part!r}: unclosed '(' in kind "
                        f"argument (expected <kind>(<arg>)@<step>)")
                arg = float(argtxt[:-1])
            host = None
            if ":" in rest:
                rest, _, scope = rest.partition(":")
                skey, _, sval = scope.partition("=")
                if skey.strip() != "host" or not sval:
                    raise ValueError(
                        f"bad TT_FAULT scope {scope!r} in {part!r}: "
                        f"expected :host=<process index>")
                host = int(sval)
            count = 1
            if "*" in rest:
                rest, _, cnt = rest.partition("*")
                count = int(cnt)
            faults.append(_Fault(kind, int(rest), count, host=host, arg=arg))
        return cls(faults)

    def consume(self, kind: str, step: int) -> Optional[_Fault]:
        """The armed fault of `kind` due at this step, with one firing
        consumed — or None. A fault with count K fires at K consecutive
        opportunities starting at its step index; a host-scoped fault fires
        only in the process whose index matches (and is never consumed
        elsewhere, so a spec shared via env across a whole cluster stays
        deterministic). Returning the fault (not a bool) lets parameterized
        kinds read their argument (``slow(30)`` -> f.arg == 30.0)."""
        for f in self.faults:
            if f.kind != kind or f.fired >= f.count:
                continue
            if f.host is not None and f.host != _host_index():
                continue
            if step >= f.step:
                f.fired += 1
                return f
        return None

    def should_fire(self, kind: str, step: int) -> bool:
        """True (and consumes one firing) if a fault of `kind` is armed for
        this step."""
        return self.consume(kind, step) is not None

    def pending(self) -> list[_Fault]:
        return [f for f in self.faults if f.fired < f.count]

    def __repr__(self) -> str:
        return f"FaultPlan({self.faults})"


# module-global plan: None (the default) keeps every injection site at a
# single global read — the same zero-work discipline as the disabled bus
_PLAN: Optional[FaultPlan] = None


def configure(spec: Optional[str]) -> Optional[FaultPlan]:
    """Arm a fault plan from a TT_FAULT-style spec (None/"" disarms)."""
    global _PLAN
    _PLAN = FaultPlan.parse(spec) if spec else None
    return _PLAN


def clear() -> None:
    configure(None)


def plan() -> Optional[FaultPlan]:
    return _PLAN


def active() -> bool:
    """Hot-path gate: one module-global read."""
    return _PLAN is not None


def should_fire(kind: str, step: int) -> bool:
    return _PLAN is not None and _PLAN.should_fire(kind, step)


def maybe_raise(kind: str, step: int, exc_type=None) -> None:
    """Raise the injected error for `kind` if armed for this step."""
    if _PLAN is None or not _PLAN.should_fire(kind, step):
        return
    if exc_type is None:
        exc_type = (InjectedCheckpointError if kind == "ckpt_fail"
                    else InjectedTransientError)
    raise exc_type(f"injected {kind} fault at step {step}")


def maybe_poison(args: tuple, kwargs: dict, step: int):
    """nan_loss site: scale the first floating tensor leaf of the batch by
    NaN (a new tensor, on the leaf's own device) so the loss is genuinely
    non-finite (the in-step finite gate and the guard's host check both see
    the real thing, not a host-side fake)."""
    if _PLAN is None or not _PLAN.should_fire("nan_loss", step):
        return args, kwargs
    import torch

    from ..core.pytree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten((args, kwargs))
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            leaves[i] = leaf * float("nan")
            return tree_unflatten(leaves, treedef)
    raise RuntimeError(
        "nan_loss fault: the batch has no float array leaf to poison "
        "(integer token batches cannot carry a NaN; poison a float input)")


def maybe_die(step: int) -> None:
    """die site: kill THIS process the way a lost host dies — ``os._exit``,
    no atexit hooks, no finally blocks, no draining checkpoint. Peers block
    in their next collective until the runtime surfaces the dead peer. The
    distinct exit code lets the harness assert the death was the injection,
    not a crash."""
    if _PLAN is None or not _PLAN.should_fire("die", step):
        return
    import sys

    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(DIE_EXIT_CODE)


def maybe_sleep(step: int) -> None:
    """slow site: stall THIS process `f.arg` milliseconds at the step
    boundary — the deterministic stand-in for a straggling host. Emits a
    ``data_stall`` event first (when the bus is on) so the fleet straggler
    detector's cause triage names the slowdown instead of guessing; the
    observability import is deferred so an armed-but-never-fired plan keeps
    this module free of the dependency."""
    if _PLAN is None:
        return
    f = _PLAN.consume("slow", step)
    if f is None:
        return
    ms = DEFAULT_SLOW_MS if f.arg is None else float(f.arg)
    try:
        from ..observability import events as _events

        if _events.enabled():
            _events.event("data_stall", ms=round(ms, 3), step=int(step),
                          injected=True)
    except Exception:
        pass
    import time

    time.sleep(ms / 1e3)


def maybe_oom(step: int) -> None:
    """oom site: raise ``torch.cuda.OutOfMemoryError`` at dispatch time,
    the type and message shape of PyTorch's caching allocator, so an OOM
    handler is exercised against what a real run throws."""
    if _PLAN is None or not _PLAN.should_fire("oom", step):
        return
    import torch

    raise torch.cuda.OutOfMemoryError(
        f"CUDA out of memory. Tried to allocate 16.00 GiB. "
        f"[injected oom fault at step {step}]")


def maybe_preempt(step: int) -> None:
    """preempt site: deliver a REAL SIGTERM to this process, exercising the
    installed signal handler exactly as a scheduler's preemption notice would."""
    if _PLAN is None or not _PLAN.should_fire("preempt", step):
        return
    signal.raise_signal(signal.SIGTERM)


# env-driven arming at import (mirrors TT_OBS)
_env_spec = os.environ.get("TT_FAULT")
if _env_spec:
    configure(_env_spec)
