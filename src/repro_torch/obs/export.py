"""Export surfaces: snapshot dict, Prometheus text, JSONL, trace files.

Port of ``repro.obs.export``, with the same schema tag
(``repro.obs.snapshot/1``), field names and validators, so that
documents from either package read the same.  Four ways out of the
in-process registry/trace buffer:

* :func:`snapshot` -- one JSON-able dict: metrics (counters / gauges /
  histogram summaries), the kernel build state (:func:`tuning_snapshot`)
  and trace-buffer stats.
* :func:`prometheus_text` -- Prometheus text exposition (0.0.4):
  ``repro_``-prefixed names with dots flattened to underscores,
  histograms as cumulative ``_bucket{le=...}`` series.
* :class:`JsonlEmitter` -- appends a snapshot line to a file at most
  once per ``period_s`` (drive it from any loop; ``emit()`` forces).
* :func:`write_trace` -- Chrome trace-event JSON via the tracing
  buffer, with a metadata header carrying the backend, the device and
  the kernels' digest, so every trace pins what produced it.

The ``validate_*`` functions are the pinned schemas: the tests and
``chip_smoke.py`` call the same code, so the exporters cannot drift from
what they check.
"""
from __future__ import annotations

import collections
import json
import math
import re
import time
from typing import Any, Dict, List, Optional

import torch

from ..kernels._build import kernels_digest  # noqa: F401 (re-exported)
from . import metrics as _m
from . import tracing as _t


def tuning_snapshot() -> Dict[str, Any]:
    """The reference's ``tuning`` section from the process's launch policy
    (``kernels.tuning.get_policy``): its backend (``cuda`` when a card is
    present, else ``cpu``), :meth:`~repro_torch.kernels.tuning.KernelPolicy.tuning_digest`
    (the defaults, the tables and :func:`kernels_digest`) and the decision
    log aggregated to {family: {source: count}}."""
    from ..kernels.tuning import get_policy
    p = get_policy()
    agg: Dict[str, Dict[str, int]] = collections.defaultdict(
        lambda: collections.defaultdict(int))
    for d in p.decisions:
        agg[d["family"]][d["source"]] += 1
    return {
        "backend": p.backend,
        "tuning_digest": p.tuning_digest(),
        "decisions": {f: dict(s) for f, s in sorted(agg.items())},
        "decision_log_len": len(p.decisions),
    }


def trace_metadata() -> Dict[str, Any]:
    """The header every trace carries: enough to know what environment
    produced it.  ``xla_flags`` stays, empty, so that the reference's
    validator reads the port's traces."""
    ts = tuning_snapshot()
    return {
        "backend": ts["backend"],
        "tuning_digest": ts["tuning_digest"],
        "xla_flags": "",
        "device": (torch.cuda.get_device_name() if torch.cuda.is_available()
                   else "cpu"),
    }


def snapshot() -> Dict[str, Any]:
    return {
        "schema": "repro.obs.snapshot/1",
        "enabled": _m.enabled(),
        "metrics": _m.registry().snapshot(),
        "tuning": tuning_snapshot(),
        "trace": {"events": len(_t.buffer()),
                  "dropped": _t.buffer().dropped},
    }


# -- Prometheus text exposition ----------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "repro_" + _NAME_OK.sub("_", name)


def _prom_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return "{" + inner + "}"


def _prom_float(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def prometheus_text() -> str:
    """Prometheus text-format exposition of the whole registry."""
    by_name: Dict[str, List[Any]] = collections.defaultdict(list)
    for (name, _lk), m in _m.registry():
        by_name[name].append(m)
    lines: List[str] = []
    for name in sorted(by_name):
        ms = by_name[name]
        pname = _prom_name(name)
        kind = type(ms[0]).__name__
        if kind == "Counter":
            lines.append(f"# TYPE {pname} counter")
            for m in ms:
                lines.append(
                    f"{pname}_total{_prom_labels(m.labels)} {m.value}")
        elif kind == "Gauge":
            lines.append(f"# TYPE {pname} gauge")
            for m in ms:
                lines.append(
                    f"{pname}{_prom_labels(m.labels)} "
                    f"{_prom_float(m.value)}")
        else:
            lines.append(f"# TYPE {pname} histogram")
            for m in ms:
                base = dict(m.labels)
                for edge, cum in m.cumulative():
                    lab = _prom_labels(dict(base, le=_prom_float(edge)))
                    lines.append(f"{pname}_bucket{lab} {cum}")
                lines.append(f"{pname}_sum{_prom_labels(base)} "
                             f"{_prom_float(m.sum)}")
                lines.append(f"{pname}_count{_prom_labels(base)} "
                             f"{m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text())


def write_trace(path: str,
                extra_metadata: Optional[Dict[str, Any]] = None) -> None:
    md = trace_metadata()
    if extra_metadata:
        md.update(extra_metadata)
    _t.buffer().write(path, metadata=md)


def write_snapshot(path: str) -> None:
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=1, sort_keys=True)


class JsonlEmitter:
    """Appends one snapshot JSON line to ``path`` at most every
    ``period_s`` seconds of wall clock.  Call :meth:`maybe_emit` from
    any loop (its first call always emits); :meth:`emit` writes
    unconditionally (use it once at shutdown so short runs still produce
    a line)."""

    def __init__(self, path: str, period_s: float = 10.0):
        self.path = path
        self.period_s = float(period_s)
        # None, not 0.0: time.monotonic() counts from an arbitrary point
        # (the host's boot), so a zero mark skips the first call on a
        # host up for less than period_s
        self._last: Optional[float] = None
        self.emitted = 0

    def maybe_emit(self) -> bool:
        now = time.monotonic()
        if self._last is not None and now - self._last < self.period_s:
            return False
        self._last = now
        self.emit()
        return True

    def emit(self) -> None:
        line = dict(snapshot(), unix_time=time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(line, sort_keys=True) + "\n")
        self.emitted += 1


# -- pinned schemas (shared by the tests and chip_smoke.py) -----------------

def validate_snapshot(doc: Dict[str, Any]) -> List[str]:
    """Schema errors for a snapshot dict ([] when valid)."""
    errs: List[str] = []
    if doc.get("schema") != "repro.obs.snapshot/1":
        errs.append(f"bad schema tag: {doc.get('schema')!r}")
    m = doc.get("metrics")
    if not isinstance(m, dict):
        errs.append("metrics: not a dict")
    else:
        for sec in ("counters", "gauges", "histograms"):
            if not isinstance(m.get(sec), dict):
                errs.append(f"metrics.{sec}: not a dict")
        for k, h in (m.get("histograms") or {}).items():
            for field in ("count", "sum", "buckets"):
                if field not in h:
                    errs.append(f"histogram {k}: missing {field!r}")
    t = doc.get("tuning")
    if not isinstance(t, dict):
        errs.append("tuning: not a dict")
    else:
        for field in ("backend", "tuning_digest", "decisions"):
            if field not in t:
                errs.append(f"tuning: missing {field!r}")
        dig = t.get("tuning_digest", "")
        if not re.fullmatch(r"[0-9a-f]{12}", str(dig)):
            errs.append(f"tuning_digest not 12-hex: {dig!r}")
    return errs


def validate_chrome_trace(doc: Dict[str, Any],
                          require_kernel_traffic: bool = False,
                          ) -> List[str]:
    """Schema errors for a Chrome trace-event document ([] when valid).

    Pins the Perfetto-loadable shape: a ``traceEvents`` array whose
    entries carry ``ph``; ``X`` events need name/ts/dur/pid/tid; the
    metadata header must carry backend + tuning_digest (12-hex) +
    xla_flags.  With ``require_kernel_traffic``, at least one
    ``kernel.launch`` instant event must carry the analytic
    ``hbm_read_bytes``/``hbm_write_bytes``/``flops`` args.
    """
    errs: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents: missing or empty"]
    md = doc.get("metadata")
    if not isinstance(md, dict):
        errs.append("metadata: not a dict")
    else:
        for field in ("backend", "tuning_digest", "xla_flags"):
            if field not in md:
                errs.append(f"metadata: missing {field!r}")
        if not re.fullmatch(r"[0-9a-f]{12}",
                            str(md.get("tuning_digest", ""))):
            errs.append("metadata.tuning_digest not 12-hex")
    saw_traffic = False
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E", "C"):
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        if ph == "X":
            for field in ("name", "ts", "dur", "pid", "tid"):
                if field not in ev:
                    errs.append(f"event {i} ({ev.get('name')}): "
                                f"X missing {field!r}")
            if ev.get("dur", 0) < 0:
                errs.append(f"event {i}: negative dur")
        if ph == "i" and ev.get("name") == "kernel.launch":
            args = ev.get("args", {})
            need = ("family", "hbm_read_bytes", "hbm_write_bytes",
                    "flops")
            if all(k in args for k in need):
                saw_traffic = True
            else:
                errs.append(f"event {i}: kernel.launch missing "
                            f"traffic args {need}")
    if require_kernel_traffic and not saw_traffic:
        errs.append("no kernel.launch event with analytic traffic args")
    return errs


_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
    r"[-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|Inf|NaN)$")


def validate_prometheus_text(text: str,
                             require_metrics: tuple = (),
                             ) -> List[str]:
    """Schema errors for a Prometheus exposition ([] when valid)."""
    errs: List[str] = []
    seen: set = set()
    for ln, line in enumerate(text.splitlines(), 1):
        if not line or line.startswith("#"):
            continue
        if not _PROM_LINE.match(line):
            errs.append(f"line {ln}: not prometheus text format: "
                        f"{line!r}")
            continue
        seen.add(line.split("{")[0].split(" ")[0])
    for name in require_metrics:
        if name not in seen:
            errs.append(f"required metric missing: {name}")
    return errs
