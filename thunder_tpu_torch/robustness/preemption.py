"""Preemption handling: turn SIGTERM into a drained step + final checkpoint.

thunder_tpu/robustness/preemption.py for the port. Cluster schedulers
preempt; a preemption notice arrives as SIGTERM with a grace window. The
handler here does the minimum safe thing inside the signal context — set a
flag — and lets the training loop finish its in-flight step;
``CheckpointManager.on_step`` then forces a final blocking save and raises
``Preempted``. ``Preempted`` propagating uncaught is deliberate: it reaches
``sys.excepthook``, so a crash hook still sees it — recovery is debuggable,
not magical. ``CheckpointManager.close()`` uninstalls the handler, giving
SIGTERM back to whatever held it before.
"""
from __future__ import annotations

import signal
import threading
import warnings
from typing import Optional

from ..observability import events as _obs


class Preempted(RuntimeError):
    """Raised (from the step loop, never the signal context) after the final
    checkpoint of a preempted run is durable. Carries ``checkpoint_path``."""

    def __init__(self, message: str, *, step: Optional[int] = None,
                 checkpoint_path: Optional[str] = None):
        super().__init__(message)
        self.step = step
        self.checkpoint_path = checkpoint_path


class PreemptionHandler:
    """Chainable SIGTERM/SIGINT trap exposing ``preempted``/``escalated``.

    The handler body only sets the event and emits a bus event — signal
    context is the wrong place for checkpoint IO or exceptions. A previously
    installed *callable* handler is chained after ours (default/ignore
    dispositions are NOT chained: the default SIGTERM disposition kills the
    process instantly, which is exactly what a drained shutdown must avoid).
    ``install`` outside the main thread degrades gracefully: signals cannot
    be trapped there, but ``preempted`` can still be set programmatically.

    A SECOND signal during the drain window means the fleet scheduler is
    impatient: it sets ``escalated`` (CheckpointManager then skips every
    courtesy wait and goes straight to an immediate blocking save) and does
    NOT re-chain the previous handler — re-entering foreign signal handlers
    on a repeat signal mid-drain is how drains wedge.

    SIGINT coverage is opt-in: ``PreemptionHandler(signals=(signal.SIGTERM,
    signal.SIGINT))`` (or ``CheckpointManager(signals=...)``) gives Ctrl-C
    the same drain-and-save semantics interactive runs want.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.preempted = threading.Event()
        self.escalated = threading.Event()
        self._prev: dict = {}
        self._installed = False

    def _handler(self, signum, frame):
        first = not self.preempted.is_set()
        self.preempted.set()
        if not first:
            # repeat signal during the drain: escalate, never re-enter
            self.escalated.set()
            if _obs.enabled():
                _obs.event("preempt_signal", signum=int(signum), escalated=True)
            return
        if _obs.enabled():
            _obs.event("preempt_signal", signum=int(signum))
        prev = self._prev.get(signum)
        # default_int_handler is SIGINT's "default disposition as a callable":
        # chaining it would raise KeyboardInterrupt inside the drain window —
        # exactly the instant death opt-in SIGINT coverage exists to avoid
        if callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        except ValueError:  # not the main thread: polling-only mode
            warnings.warn(
                "PreemptionHandler.install() outside the main thread cannot "
                "trap signals; preemption must be signalled via "
                "handler.preempted.set()", stacklevel=2)
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev if prev is not None else signal.SIG_DFL)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        self._installed = False
