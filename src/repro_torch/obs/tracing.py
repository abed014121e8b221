"""Span tracing with Chrome trace-event JSON export.

Port of ``repro.obs.tracing``.  Spans are wall-clock intervals recorded
into a bounded in-process buffer and exported as Chrome trace-event JSON
(the ``[{"ph": "X", ...}]`` array format), loadable in Perfetto
(ui.perfetto.dev) or ``chrome://tracing``.

Track model: one process (``pid`` 0), one thread-track per subsystem --
``serve`` (tid 1) carries ``serve.tick`` spans with nested
admit/prepare/decode phases, ``train`` (tid 2) carries ``train.step``,
``bench`` (tid 3) harness sections.  Kernel launches are *instant*
events (``ph: "i"``) on the ``kernels`` track (tid 10): one per launch
of a CUDA kernel wrapper, stamped when the host enqueues it (the device
runs it later, so it has no duration here) -- its payload (family,
grid, analytic HBM bytes / FLOPs) rides in ``args``.

A span measures host wall time.  CUDA launches return before the device
finishes, so a span around eager work that ends in no synchronisation
measures the enqueue; the engine's ``serve.tick`` ends in the host's
read of the sampled tokens, which waits for the device.

Like metrics, the disabled path is a no-op: :func:`span` returns the
shared null context manager and :func:`instant` returns immediately.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Optional

from . import metrics as _m

TRACK_SERVE = 1
TRACK_TRAIN = 2
TRACK_BENCH = 3
TRACK_KERNELS = 10

_TRACK_NAMES = {
    TRACK_SERVE: "serve",
    TRACK_TRAIN: "train",
    TRACK_BENCH: "bench",
    TRACK_KERNELS: "kernels",
}

_MAX_EVENTS = 65536


class TraceBuffer:
    """Bounded buffer of Chrome trace events (oldest dropped first)."""

    def __init__(self, maxlen: int = _MAX_EVENTS):
        self._events: Deque[Dict[str, Any]] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.dropped = 0

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def add(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def complete(self, name: str, ts_us: float, dur_us: float,
                 tid: int, args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
              "pid": 0, "tid": tid}
        if args:
            ev["args"] = args
        self.add(ev)

    def instant(self, name: str, tid: int,
                args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "ph": "i", "ts": self.now_us(), "s": "t",
              "pid": 0, "tid": tid}
        if args:
            ev["args"] = args
        self.add(ev)

    def chrome_trace(self, metadata: Optional[Dict[str, Any]] = None,
                     ) -> Dict[str, Any]:
        """Full trace document: ``{"traceEvents": [...], "metadata":
        {...}}`` with thread-name metadata events prepended."""
        meta_events = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "repro"}},
        ]
        for tid, tname in sorted(_TRACK_NAMES.items()):
            meta_events.append(
                {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": tname}})
        with self._lock:
            events = meta_events + list(self._events)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "metadata": dict(metadata or {})}
        if self.dropped:
            doc["metadata"]["dropped_events"] = self.dropped
        return doc

    def write(self, path: str, metadata: Optional[Dict[str, Any]] = None,
              ) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(metadata), f)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0
            self._t0 = time.perf_counter()

    def __len__(self) -> int:
        return len(self._events)


_BUFFER = TraceBuffer()


def buffer() -> TraceBuffer:
    return _BUFFER


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("name", "tid", "args", "_start")

    def __init__(self, name: str, tid: int, args: Optional[Dict] = None):
        self.name = name
        self.tid = tid
        self.args = args
        self._start = 0.0

    def __enter__(self):
        self._start = _BUFFER.now_us()
        return self

    def __exit__(self, *exc):
        end = _BUFFER.now_us()
        _BUFFER.complete(self.name, self._start, end - self._start,
                         self.tid, self.args)
        return False


def span(name: str, tid: int = TRACK_SERVE,
         args: Optional[Dict[str, Any]] = None):
    """``with span("serve.tick", args={...}):`` -- no-op when disabled."""
    if not _m.enabled():
        return _m.NULL_SPAN
    return _Span(name, tid, args)


def instant(name: str, tid: int = TRACK_KERNELS,
            args: Optional[Dict[str, Any]] = None) -> None:
    if not _m.enabled():
        return
    _BUFFER.instant(name, tid, args)
