"""Robustness interventions, SLO breaches and serving traffic over the bus.

thunder_tpu/observability/metrics.py for the port, limited to what the
port's code calls: ``record_intervention`` (robustness/guards.py,
robustness/checkpoint_manager.py), ``record_slo_breach`` (slo.py) and
``record_serve`` (serving/scheduler.py), with the same counter and event
vocabulary (so tools/obs_summary.py reads the port's dumps). The cache,
recompile, fusion, fleet and distributed recorders come with the slices
whose code calls them (ROADMAP A6, A3c).
"""
from __future__ import annotations

from . import events

# Robustness-layer intervention reason codes (consumed by tools/obs_summary.py):
#
#   nonfinite-skip       a NaN/Inf step's update was gated off in-program
#   nonfinite-raise      the guard policy (or an exhausted skip budget) raised
#   rollback             N consecutive bad steps restored the last checkpoint
#   transient-retry      a transient runtime error was retried with backoff
#   transient-exhausted  the retry budget ran out; the error propagated
#   preempt              SIGTERM drained into a final checkpoint
#   preempt-escalated    a SECOND SIGTERM during the drain window forced an
#                        immediate blocking save (no courtesy waits)
INTERVENTION_CODES = ("nonfinite-skip", "nonfinite-raise", "rollback",
                      "transient-retry", "transient-exhausted", "preempt",
                      "preempt-escalated")


def record_intervention(reason: str, **attrs) -> None:
    """A robustness-layer intervention (guard skip/raise/rollback, transient
    retry, preemption drain), reason-coded so the CLI can name it: counter
    ``guard.<reason>`` plus one ``guard`` timeline event."""
    if not events.enabled():
        return
    events.inc(f"guard.{reason}")
    events.event("guard", reason=reason, **attrs)


def record_slo_breach(reason: str, **attrs) -> None:
    """An SLO target crossed into violation (slo.py; reason in
    slo.BREACH_CODES). Counter ``slo.breach.<reason>`` + one reason-coded
    ``slo.breach`` timeline event carrying value/target/burn_rate."""
    if not events.enabled():
        return
    events.inc(f"slo.breach.{reason}")
    events.event("slo.breach", reason=reason, **attrs)


def record_serve(outcome: str, delta: int = 1, event: bool = False, **attrs) -> None:
    """Serving-engine traffic: bumps ``serve.<outcome>`` and, for the
    low-rate lifecycle outcomes (``event=True``: prefills, preemptions,
    resumptions, retirements, failures), records a ``serve_<outcome>``
    timeline event carrying the request's tags. High-rate outcomes
    (decode_steps, tokens, spec_proposed/spec_accepted, prefill_tokens)
    stay counter-only."""
    if not events.enabled():
        return
    events.inc(f"serve.{outcome}", delta)
    if event:
        events.event(f"serve_{outcome}", **attrs)
