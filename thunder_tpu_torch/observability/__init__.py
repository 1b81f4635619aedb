"""thunder_tpu_torch.observability: the structured event bus, its metrics
and the SLO monitors.

thunder_tpu/observability/ for the port, limited to what is ported: the bus
(``events``: spans, events, counters, ``summary``, ``dump``), the metrics
vocabulary over it (``metrics``), the SLO policy and its sliding-window
monitor (``slo``; ``ServingEngine(slo=)`` and ``TrainStep(slo=)``) and the
nearest-rank ``telemetry.percentile`` they read. The robustness layer
reports its interventions here, the serving engine its ``serve.*``
traffic. The flight recorder, memory watch, the rest of live telemetry,
request trace ids, the fleet view and the profiler hooks are not ported
yet (ROADMAP A6).

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
from . import slo  # noqa: F401
from .metrics import INTERVENTION_CODES, record_intervention  # noqa: F401
from .slo import SLOMonitor, SLOPolicy  # noqa: F401
