"""Declarative SLO monitoring: sliding-window targets, burn rates, breaches.

The port's own copy of thunder_tpu/observability/slo.py (the same policy,
windows, burn rates and event vocabulary; it imports nothing of
thunder_tpu). ``SLOPolicy`` states what the service promises — "p99 TBOT
under 12 ms", "99% of requests meet their latency targets", "at least 40k
tokens/s" — and ``SLOMonitor`` evaluates it over a sliding window of the
most recent samples, computing a **burn rate** for each target: how fast
the error budget is being spent (1.0 = exactly on budget, 2.0 = burning
twice as fast as the objective allows; the Google SRE-workbook framing).

A target crossing into violation emits ONE reason-coded ``slo.breach``
bus event + ``slo.breach.<reason>`` counter (and ``slo.recovered`` on the
way back), so a sustained breach doesn't flood the timeline; the live
state is always readable from ``status()``. Breach reason codes:

  p99-ttft       windowed p99 time-to-first-token over target
  p99-tbot       windowed p99 time-between-output-tokens over target
  p99-step-time  windowed p99 train-step wall time over target
  goodput        fraction of requests meeting their per-request targets
                 below ``min_goodput``
  tokens-per-s   windowed throughput below ``min_tokens_per_s``

Monitors are explicit opt-in (``ServingEngine(..., slo=policy)``, which
also sheds batch-lane sequences while a target burns, and
``TrainStep(..., slo=policy)``): with no policy attached the hot paths pay
one ``is None`` test; with one attached the window bookkeeping always runs
(the operator asked for it) while event/counter emission still requires
the bus, like every other record.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Optional

from . import events as _events
from . import metrics as _metrics
from .telemetry import percentile as _pct

# every live monitor, weakly held, so events.reset() can clear all sliding
# windows without owning references to engine/trainer internals
_registry_lock = threading.Lock()
_monitors: "weakref.WeakSet[SLOMonitor]" = weakref.WeakSet()


def reset_windows() -> None:
    """Clear every live monitor's sliding windows and breach state (policy
    and source stay). events.reset() calls this so a reset between
    benchmark phases doesn't carry one phase's breach latches — and the
    breach-transition counts they'd re-emit — into the next phase's
    incident view."""
    with _registry_lock:
        monitors = list(_monitors)
    for m in monitors:
        m.reset_window()

BREACH_P99_TTFT = "p99-ttft"
BREACH_P99_TBOT = "p99-tbot"
BREACH_P99_STEP = "p99-step-time"
BREACH_GOODPUT = "goodput"
BREACH_TOKENS_PER_S = "tokens-per-s"

BREACH_CODES = (BREACH_P99_TTFT, BREACH_P99_TBOT, BREACH_P99_STEP,
                BREACH_GOODPUT, BREACH_TOKENS_PER_S)


@dataclass(frozen=True)
class SLOPolicy:
    """What the service promises. Any subset of targets may be set; unset
    targets are not evaluated. ``objective`` is the percentile the latency
    targets bind (0.99 → the p99 must sit under the target, i.e. a 1%
    error budget feeds the burn-rate computation)."""

    p99_ttft_ms: Optional[float] = None
    p99_tbot_ms: Optional[float] = None
    p99_step_ms: Optional[float] = None
    min_goodput: Optional[float] = None        # fraction in [0, 1]
    min_tokens_per_s: Optional[float] = None
    objective: float = 0.99
    window: int = 256                          # sliding-window samples
    min_samples: int = 16                      # don't judge a cold window
    tokens_per_step: Optional[int] = None      # training throughput accounting

    def __post_init__(self):
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"objective must be in (0, 1), got {self.objective}")
        if self.min_goodput is not None and not (0.0 < self.min_goodput <= 1.0):
            raise ValueError(f"min_goodput must be in (0, 1], got {self.min_goodput}")
        if self.window < 2 or self.min_samples < 1:
            raise ValueError("window must be >= 2 and min_samples >= 1")
        if not any((self.p99_ttft_ms, self.p99_tbot_ms, self.p99_step_ms,
                    self.min_goodput, self.min_tokens_per_s)):
            raise ValueError("SLOPolicy needs at least one target")

    def request_met(self, ttft_ms: float, tbot_ms: Optional[float]) -> bool:
        """The per-request SLO-met flag stamped at retirement (the goodput
        numerator). A one-token request has no between-token interval, so
        only its TTFT binds (tbot_ms=None)."""
        if self.p99_ttft_ms is not None and ttft_ms > self.p99_ttft_ms:
            return False
        if (self.p99_tbot_ms is not None and tbot_ms is not None
                and tbot_ms > self.p99_tbot_ms):
            return False
        return True


class SLOMonitor:
    """Sliding-window evaluator for one SLOPolicy. Thread-safe: the serving
    loop thread and a caller thread reading ``status()`` may interleave."""

    def __init__(self, policy: SLOPolicy, *, source: str = "serving"):
        self.policy = policy
        self.source = source
        w = policy.window
        self._lock = threading.Lock()
        self._ttft: deque = deque(maxlen=w)
        self._tbot: deque = deque(maxlen=w)
        self._step: deque = deque(maxlen=w)
        self._met: deque = deque(maxlen=w)      # per-request SLO-met flags
        self._tok: deque = deque(maxlen=w)      # (t_wall, tokens) pairs
        self._breached: dict[str, bool] = {}
        self.breaches = 0                       # breach *transitions* seen
        self._n_obs = 0
        # full evaluation sorts each window (O(window log window)): quiet
        # healthy samples only pay it every _eval_every observations, while
        # a sample that violates its own target — or any currently-breached
        # state — evaluates immediately, so transition latency stays at one
        # sample where it matters
        self._eval_every = max(1, policy.min_samples // 4)
        with _registry_lock:
            _monitors.add(self)

    def reset_window(self) -> None:
        """Drop the sliding windows and breach latches (module
        ``reset_windows()`` fans this out to every live monitor)."""
        with self._lock:
            self._ttft.clear()
            self._tbot.clear()
            self._step.clear()
            self._met.clear()
            self._tok.clear()
            self._breached.clear()
            self.breaches = 0
            self._n_obs = 0

    # -- recording ---------------------------------------------------------

    def observe_request(self, *, ttft_ms: float, tbot_ms: Optional[float],
                        met: bool, tokens: int = 0) -> None:
        """One retired request (serving side)."""
        p = self.policy
        with self._lock:
            self._ttft.append(float(ttft_ms))
            if tbot_ms is not None:
                self._tbot.append(float(tbot_ms))
            self._met.append(bool(met))
            if tokens:
                self._tok.append((time.perf_counter(), int(tokens)))
        hot = (not met
               or (p.p99_ttft_ms is not None and ttft_ms > p.p99_ttft_ms)
               or (p.p99_tbot_ms is not None and tbot_ms is not None
                   and tbot_ms > p.p99_tbot_ms))
        self._maybe_check(hot)

    def observe_step(self, step_ms: float, tokens: Optional[int] = None) -> None:
        """One training/decode step (training side)."""
        p = self.policy
        if tokens is None:
            tokens = p.tokens_per_step
        with self._lock:
            self._step.append(float(step_ms))
            if tokens:
                self._tok.append((time.perf_counter(), int(tokens)))
        self._maybe_check(p.p99_step_ms is not None and step_ms > p.p99_step_ms)

    def _maybe_check(self, hot: bool) -> None:
        self._n_obs += 1
        if hot or any(self._breached.values()) \
                or self._n_obs % self._eval_every == 0:
            self._check()

    # -- evaluation --------------------------------------------------------

    def _latency_target(self, xs: list, target: Optional[float],
                        reason: str, out: dict) -> None:
        p = self.policy
        if target is None or len(xs) < p.min_samples:
            return
        value = _pct(xs, p.objective)
        over = sum(1 for x in xs if x > target)
        # burn rate: fraction of the window over target vs the error budget
        # the objective allows (p99 target -> 1% budget). 1.0 = on budget.
        burn = (over / len(xs)) / (1.0 - p.objective)
        out[reason] = {"value": round(value, 3), "target": target,
                       "breached": value > target, "burn_rate": round(burn, 2),
                       "samples": len(xs)}

    def _evaluate_locked(self) -> dict[str, dict]:
        p = self.policy
        out: dict[str, dict] = {}
        self._latency_target(list(self._ttft), p.p99_ttft_ms, BREACH_P99_TTFT, out)
        self._latency_target(list(self._tbot), p.p99_tbot_ms, BREACH_P99_TBOT, out)
        self._latency_target(list(self._step), p.p99_step_ms, BREACH_P99_STEP, out)
        if p.min_goodput is not None and len(self._met) >= p.min_samples:
            good = sum(self._met) / len(self._met)
            budget = 1.0 - p.min_goodput
            burn = ((1.0 - good) / budget) if budget > 0 else (
                0.0 if good >= 1.0 else float("inf"))
            out[BREACH_GOODPUT] = {
                "value": round(good, 4), "target": p.min_goodput,
                "breached": good < p.min_goodput, "burn_rate": round(burn, 2),
                "samples": len(self._met)}
        if p.min_tokens_per_s is not None and len(self._tok) >= max(2, p.min_samples):
            # the same cold-window gate as every other target: a single
            # inter-step gap (sync compile, checkpoint save) must not fire
            # a spurious throughput breach on the second step of a run
            ts = [t for t, _ in self._tok]
            span = ts[-1] - ts[0]
            if span > 0:
                # the first sample's tokens landed before the window opened
                tps = sum(n for _, n in list(self._tok)[1:]) / span
                out[BREACH_TOKENS_PER_S] = {
                    "value": round(tps, 2), "target": p.min_tokens_per_s,
                    "breached": tps < p.min_tokens_per_s,
                    "burn_rate": round(p.min_tokens_per_s / tps, 2) if tps > 0
                    else float("inf"),
                    "samples": len(self._tok)}
        return out

    def _check(self) -> None:
        with self._lock:
            results = self._evaluate_locked()
            transitions = []
            for reason, r in results.items():
                was = self._breached.get(reason, False)
                if r["breached"] and not was:
                    self._breached[reason] = True
                    self.breaches += 1
                    transitions.append(("breach", reason, r))
                elif was and not r["breached"]:
                    self._breached[reason] = False
                    transitions.append(("recovered", reason, r))
        # emit outside the monitor lock (events.inc takes the bus lock)
        for kind, reason, r in transitions:
            if kind == "breach":
                _metrics.record_slo_breach(
                    reason, source=self.source, value=r["value"],
                    target=r["target"], burn_rate=r["burn_rate"],
                    samples=r["samples"])
            else:
                _events.event("slo.recovered", reason=reason,
                              source=self.source, value=r["value"],
                              target=r["target"])

    # -- read side ---------------------------------------------------------

    def status(self) -> dict:
        """Live view: per-target value/target/breached/burn_rate plus the
        windowed goodput (None until any request carried a met flag)."""
        with self._lock:
            results = self._evaluate_locked()
            good = (sum(self._met) / len(self._met)) if self._met else None
        return {"source": self.source, "targets": results,
                "goodput": None if good is None else round(good, 4),
                "breached": sorted(r for r, b in self._breached.items() if b),
                "breach_transitions": self.breaches}

    def goodput(self) -> Optional[float]:
        with self._lock:
            return (sum(self._met) / len(self._met)) if self._met else None
