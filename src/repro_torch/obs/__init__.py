"""Process-wide telemetry: metrics, spans, kernel-launch accounting.

Port of ``repro.obs``.  Quickstart::

    from repro_torch import obs
    obs.enable()
    ... run serve / train ...
    obs.export.write_trace("trace.json")       # load in ui.perfetto.dev
    print(obs.export.prometheus_text())
    snap = obs.export.snapshot()

Telemetry is OFF by default and costs one branch per instrumentation
site when off (:mod:`.metrics` returns shared no-op stubs; a kernel
wrapper tests one flag of ``repro_torch.analysis.contracts``).
:func:`enable` flips the registry live and registers the launch hook on
``repro_torch.analysis.contracts``, so every kernel launch on the card
while enabled is accounted (family, grid, analytic HBM bytes and FLOPs
-- see :mod:`.traffic`).  The CLIs expose this as ``--telemetry`` /
``--trace-out`` / ``--prom-out`` / ``--metrics-jsonl``.
"""
from __future__ import annotations

from ..analysis import contracts
from . import export, metrics, tracing, traffic
from .metrics import (NULL_COUNTER, NULL_GAUGE, NULL_HISTOGRAM, NULL_SPAN,
                      Histogram, counter, enabled, gauge, histogram,
                      registry)
from .tracing import (TRACK_BENCH, TRACK_KERNELS, TRACK_SERVE, TRACK_TRAIN,
                      instant, span)

__all__ = [
    "enable", "disable", "enabled", "reset",
    "counter", "gauge", "histogram", "span", "instant",
    "registry", "Histogram",
    "metrics", "tracing", "traffic", "export",
    "NULL_COUNTER", "NULL_GAUGE", "NULL_HISTOGRAM", "NULL_SPAN",
    "TRACK_SERVE", "TRACK_TRAIN", "TRACK_BENCH", "TRACK_KERNELS",
]


def enable() -> None:
    """Turn telemetry on and hook kernel-launch accounting."""
    metrics._set_enabled(True)
    contracts.add_launch_hook(traffic.on_launch)


def disable() -> None:
    """Turn telemetry off (hot paths revert to the one-branch no-op).
    Collected metrics/trace events are kept until :func:`reset`."""
    metrics._set_enabled(False)
    contracts.remove_launch_hook(traffic.on_launch)


def reset() -> None:
    """Clear all collected metrics and trace events (enabled state is
    unchanged)."""
    metrics.registry().reset()
    tracing.buffer().reset()
