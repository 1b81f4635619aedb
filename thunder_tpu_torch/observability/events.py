"""Low-overhead structured event bus: nested spans, events, counters.

thunder_tpu/observability/events.py for the port, whole but for the
modules it resets and summarises that are not ported yet (the flight
recorder, memory watch and live telemetry: ROADMAP A6). The
robustness layer (robustness/) reports every intervention here: guard
skips, raises and rollbacks, transient retries, checkpoint saves, restores
and failures, preemption drains. Process-global and thread-safe; span
nesting is tracked per-thread so concurrent threads (the checkpoint
writer) interleave without corrupting each other's parent links.

Three record kinds share one JSON-lines schema (docs/observability.md):

  span     {"kind":"span","name",...,"ts_ms","dur_ms","span","parent","thread","attrs"}
  event    {"kind":"event","name","ts_ms","span","thread","attrs"}
  counter  {"kind":"counter","name","ts_ms","delta","value","attrs"}

Disabled (the default) the bus records nothing: ``event``/``inc`` return
after one attribute check, and ``span`` objects still *measure* (the compile
driver reads their durations for ``last_compile_report`` — compiles are rare
so two clock reads are free) but never touch the buffer or the export file.

Enablement:
  TT_OBS=1           enable at import (in-memory ring buffer only)
  TT_OBS_FILE=path   enable + stream every record to `path` as JSON lines
  observability.enable(path=None)   the same, programmatically
"""
from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Optional

_TRUTHY = ("1", "true", "yes", "on")


class _Bus:
    """Process-global event sink. All mutation happens under ``lock``; the
    hot-path fast exit is the unlocked ``enabled`` read."""

    def __init__(self, maxlen: int = 50_000):
        self.enabled = False
        self.lock = threading.RLock()
        self.records: deque = deque(maxlen=maxlen)
        self.counters: dict[str, int] = {}
        self.file = None
        self.path: Optional[str] = None
        self.t0 = time.perf_counter()
        self.ids = itertools.count(1)
        self.local = threading.local()  # .stack — per-thread open-span ids

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def now_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def emit(self, rec: dict) -> None:
        # pid disambiguates multi-process timelines (bench phases append to
        # one artifact; span ids/ts_ms/counters all restart per process)
        rec["pid"] = os.getpid()
        with self.lock:
            self.records.append(rec)
            if self.file is not None:
                try:
                    self.file.write(json.dumps(rec) + "\n")
                    self.file.flush()
                except (OSError, ValueError):  # closed/full file: drop export
                    self.file = None


_BUS = _Bus()


def _proc_shard_path(path: str) -> str:
    """In a multi-process run, suffix the export path with the process index
    (``trace.jsonl`` → ``trace.p1.jsonl``): two hosts appending to one file
    interleave half-written lines. tools/obs_summary.py already namespaces
    multiple shard files per invocation, so readers just pass every shard.
    Process identity comes from the TT_MP_* harness env first, then from an
    initialized torch.distributed group (parallel/multiprocess.py)."""
    proc = os.environ.get("TT_MP_PROC")
    nprocs = os.environ.get("TT_MP_NPROCS")
    try:
        if proc is None or nprocs is None or int(nprocs) <= 1:
            proc = None
    except ValueError:
        proc = None
    if proc is None:
        from ..parallel import multiprocess

        if multiprocess.process_count() > 1:
            proc = str(multiprocess.process_index())
    if proc is None:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{proc}{ext}"


def enable(path: Optional[str] = None, *, append: bool = False) -> None:
    """Turn recording on; ``path`` streams records as JSON lines (suffixed
    per process index in multi-process runs — see ``_proc_shard_path``)."""
    with _BUS.lock:
        if path:
            path = _proc_shard_path(path)
            if _BUS.file is not None:
                try:
                    _BUS.file.close()
                except OSError:
                    pass
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            _BUS.file = open(path, "a" if append else "w")
            _BUS.path = path
        _BUS.enabled = True


def disable() -> None:
    with _BUS.lock:
        _BUS.enabled = False
        if _BUS.file is not None:
            try:
                _BUS.file.close()
            except OSError:
                pass
            _BUS.file = None
            _BUS.path = None


def enabled() -> bool:
    return _BUS.enabled


def reset() -> None:
    """Clear recorded state (tests; keeps enabled/export settings), and
    every live SLO monitor's sliding windows and breach latches, so one
    reset between phases carries no breach state into the next."""
    with _BUS.lock:
        _BUS.records.clear()
        _BUS.counters.clear()
    from . import slo  # deferred: slo imports this module

    slo.reset_windows()


def records() -> list[dict]:
    with _BUS.lock:
        return list(_BUS.records)


class Span:
    """A timed region. Always measures (``dur_ms`` is read by
    ``last_compile_report`` even with the bus off); records only when the
    bus is enabled. Use as a context manager; ``set(**attrs)`` adds tags."""

    __slots__ = ("name", "attrs", "dur_ms", "_t0", "_id", "_parent")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.dur_ms = None
        self._t0 = 0.0
        self._id = None
        self._parent = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = _BUS.stack()
        self._parent = stack[-1] if stack else None
        self._id = next(_BUS.ids)
        stack.append(self._id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        self.dur_ms = (t1 - self._t0) * 1e3
        stack = _BUS.stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        elif self._id in stack:  # mismatched exit (exception unwound children)
            del stack[stack.index(self._id):]
        if _BUS.enabled:
            if exc_type is not None:
                self.attrs.setdefault("error", exc_type.__name__)
            _BUS.emit({
                "kind": "span",
                "name": self.name,
                "ts_ms": round((self._t0 - _BUS.t0) * 1e3, 3),
                "dur_ms": round(self.dur_ms, 3),
                "span": self._id,
                "parent": self._parent,
                "thread": threading.get_ident(),
                "attrs": self.attrs,
            })
        return False


def span(name: str, **attrs) -> Span:
    """Open a (nested) span: ``with span("acquisition", trace="t0") as sp:``"""
    return Span(name, attrs)


def event(name: str, **attrs) -> None:
    """Record a point-in-time event under the current span."""
    if not _BUS.enabled:
        return
    stack = _BUS.stack()
    _BUS.emit({
        "kind": "event",
        "name": name,
        "ts_ms": round(_BUS.now_ms(), 3),
        "span": stack[-1] if stack else None,
        "thread": threading.get_ident(),
        "attrs": attrs,
    })


def inc(name: str, delta: int = 1, **attrs) -> None:
    """Bump a named counter (and record the increment on the timeline)."""
    if not _BUS.enabled:
        return
    with _BUS.lock:
        # emit under the same lock so records carry monotonically
        # increasing `value`s (last-record-wins consumers rely on it)
        value = _BUS.counters.get(name, 0) + delta
        _BUS.counters[name] = value
        _BUS.emit({
            "kind": "counter",
            "name": name,
            "ts_ms": round(_BUS.now_ms(), 3),
            "delta": delta,
            "value": value,
            "attrs": attrs,
        })


def counters() -> dict[str, int]:
    with _BUS.lock:
        return dict(_BUS.counters)


def summary() -> dict:
    """Aggregate view of everything recorded so far: per-span-name call
    counts and total durations, counters, reason-coded recompiles and the
    serving traffic (``serve.*`` counters). thunder_tpu's summary adds the
    live telemetry's gauges and histograms, which the port has not yet
    (ROADMAP A6)."""
    spans: dict[str, dict] = {}
    events_by_name: dict[str, int] = {}
    recompiles: list[dict] = []
    for rec in records():
        if rec["kind"] == "span":
            agg = spans.setdefault(rec["name"], {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] = round(agg["total_ms"] + rec["dur_ms"], 3)
            agg["max_ms"] = max(agg["max_ms"], rec["dur_ms"])
        elif rec["kind"] == "event":
            events_by_name[rec["name"]] = events_by_name.get(rec["name"], 0) + 1
            if rec["name"] == "recompile":
                recompiles.append(rec)
    snap = counters()
    return {
        "spans": spans,
        "events": events_by_name,
        "counters": snap,
        "recompiles": recompiles,
        "serving": {k: v for k, v in snap.items() if k.startswith("serve.")},
    }


def key_digest(key) -> str:
    """Short stable digest of a cache key for tagging records without
    dumping the full key into the timeline."""
    import hashlib

    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


def dump(path: str) -> str:
    """Write the in-memory buffer (plus a final counters snapshot) to
    ``path`` as JSON lines — for timelines gathered without TT_OBS_FILE."""
    with open(path, "w") as f:
        for rec in records():
            f.write(json.dumps(rec) + "\n")
        snap = counters()
        if snap:
            f.write(json.dumps({"kind": "snapshot", "ts_ms": round(_BUS.now_ms(), 3),
                                "pid": os.getpid(), "counters": snap}) + "\n")
    return path


def _close_export() -> None:
    with _BUS.lock:
        if _BUS.file is not None:
            snap = counters()
            if snap:
                try:
                    _BUS.file.write(json.dumps(
                        {"kind": "snapshot", "ts_ms": round(_BUS.now_ms(), 3),
                         "pid": os.getpid(), "counters": snap}) + "\n")
                except (OSError, ValueError):
                    pass
            try:
                _BUS.file.close()
            except OSError:
                pass
            _BUS.file = None


atexit.register(_close_export)

# env-driven enablement at import: TT_OBS=1 records in memory,
# TT_OBS_FILE=path additionally streams JSON lines to `path`
_env_file = os.environ.get("TT_OBS_FILE")
if os.environ.get("TT_OBS", "").lower() in _TRUTHY or _env_file:
    enable(_env_file)
