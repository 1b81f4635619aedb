"""thunder_tpu_torch.observability: the structured event bus and its metrics.

thunder_tpu/observability/ for the port, limited to what is ported: the bus
(``events``: spans, events, counters, ``summary``, ``dump``) and the
metrics vocabulary over it (``metrics``). The robustness layer reports its
interventions here. The flight recorder, memory watch, live telemetry,
SLO monitors, the fleet view and the profiler hooks are not ported yet
(ROADMAP A6).

Quick start::

    from thunder_tpu_torch import observability
    observability.enable("run.jsonl")       # or TT_OBS=1 / TT_OBS_FILE=...
    ...                                      # train with a StepGuard
    observability.counters()                 # {"guard.nonfinite-skip": 1, ...}
"""
from __future__ import annotations

from .events import (  # noqa: F401
    counters,
    disable,
    dump,
    enable,
    enabled,
    event,
    inc,
    key_digest,
    records,
    reset,
    span,
    summary,
)
from .metrics import INTERVENTION_CODES, record_intervention  # noqa: F401
