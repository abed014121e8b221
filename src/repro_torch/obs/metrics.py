"""Process-wide metrics registry: counters, gauges, histograms.

Port of ``repro.obs.metrics`` (pure Python; the port keeps its own copy
so that it imports nothing of the JAX package).  Telemetry is OFF by
default.  Every accessor (:func:`counter`, :func:`gauge`,
:func:`histogram`) returns a process-wide NO-OP stub when telemetry is
disabled -- the same singleton object every time, so the disabled hot
path pays one branch and one no-op method call, never a dict lookup or
an allocation (``tests/test_torch_obs.py`` pins the object identity and
bounds the per-call overhead).

Naming convention: dotted lower-case ``subsystem.noun[_unit]`` names
(``serve.ttft_s``, ``pool.prefix_hits``, ``kernel.hbm_read_bytes``);
dimensions ride as labels (``counter("kernel.launches",
family="decode_attend")``), never baked into the name.  Units are
explicit suffixes: ``_s`` seconds, ``_bytes`` bytes, ``_ticks`` engine
ticks; unsuffixed metrics are plain event or object counts.

Histograms have FIXED bucket boundaries chosen at construction (first
call wins) so merging/exposition never re-buckets.  They additionally
retain up to ``keep_samples`` raw observations: quantiles are EXACT
while every observation is retained, and fall back to linear
interpolation inside the fixed buckets once the reservoir overflows.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# default histogram boundaries: exponential, ~microseconds..minutes when
# observing seconds, also serviceable for counts
DEFAULT_BUCKETS = tuple(
    float(f"{m}e{e}") for e in range(-6, 3) for m in (1, 2.5, 5))
DEFAULT_KEEP_SAMPLES = 1024

_ENABLED = False
_LOCK = threading.Lock()


def _labels_key(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return "{" + inner + "}"


class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, Any]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Dict[str, Any]):
        self.name = name
        self.labels = dict(labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-boundary histogram with a small exact-sample reservoir.

    ``boundaries`` are the inclusive upper edges of the finite buckets
    (ascending); observations above the last edge land in the implicit
    +Inf bucket.  Usable standalone (the benchmark harnesses construct
    private instances) or through the registry.
    """

    def __init__(self, name: str = "", labels: Optional[Dict] = None,
                 boundaries: Sequence[float] = DEFAULT_BUCKETS,
                 keep_samples: int = DEFAULT_KEEP_SAMPLES):
        bs = [float(b) for b in boundaries]
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(
                f"histogram boundaries must be non-empty ascending: {bs}")
        self.name = name
        self.labels = dict(labels or {})
        self.boundaries = bs
        self.counts = [0] * (len(bs) + 1)     # last = +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._keep = int(keep_samples)
        self._samples: List[float] = []

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.boundaries, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._samples) < self._keep:
            self._samples.append(v)

    @property
    def exact(self) -> bool:
        """True while every observation is still in the reservoir (all
        quantiles exact)."""
        return self.count == len(self._samples)

    def quantile(self, q: float) -> float:
        """q in [0, 1].  Exact (linear-interpolated order statistic)
        while the reservoir holds every observation; bucket-interpolated
        after overflow.  NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        if self.exact:
            xs = sorted(self._samples)
            pos = q * (len(xs) - 1)
            lo = int(math.floor(pos))
            hi = min(lo + 1, len(xs) - 1)
            return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
        # bucket interpolation: find the bucket holding the q-th obs
        target = q * self.count
        acc = 0.0
        for i, c in enumerate(self.counts):
            if acc + c >= target and c > 0:
                lo = (self.min if i == 0
                      else self.boundaries[i - 1])
                hi = (self.max if i == len(self.boundaries)
                      else self.boundaries[i])
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                frac = (target - acc) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            acc += c
        return self.max

    def cumulative(self) -> List[Tuple[float, int]]:
        """Prometheus-style cumulative (upper_edge, count) pairs ending
        with the +Inf bucket."""
        out = []
        acc = 0
        for b, c in zip(self.boundaries, self.counts):
            acc += c
            out.append((b, acc))
        out.append((math.inf, acc + self.counts[-1]))
        return out


# -- no-op stubs -------------------------------------------------------------

class _NullCounter:
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()

    def observe(self, v: float) -> None:
        pass


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()
NULL_SPAN = _NullSpan()


# -- registry ----------------------------------------------------------------

class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[Tuple[str, str], Any] = {}
        # bumped by reset(): a caller holding metric objects across calls
        # (the kernel-launch hook) knows when they left the registry
        self.generation = 0

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw):
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with _LOCK:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, labels, **kw)
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r}{_labels_key(labels)} already registered "
                f"as {type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, labels: Dict[str, Any]) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Dict[str, Any]) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Dict[str, Any],
                  boundaries: Sequence[float] = DEFAULT_BUCKETS,
                  ) -> Histogram:
        return self._get(Histogram, name, labels, boundaries=boundaries)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view: {"counters": {...}, "gauges": {...},
        "histograms": {...}} keyed by ``name{label=value,...}``."""
        counters: Dict[str, int] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Any] = {}
        for (name, lk), m in sorted(self._metrics.items()):
            key = name + lk
            if isinstance(m, Counter):
                counters[key] = m.value
            elif isinstance(m, Gauge):
                gauges[key] = m.value
            elif isinstance(m, Histogram):
                hists[key] = {
                    "count": m.count,
                    "sum": m.sum,
                    "min": None if m.count == 0 else m.min,
                    "max": None if m.count == 0 else m.max,
                    "p50": None if m.count == 0 else m.quantile(0.5),
                    "p99": None if m.count == 0 else m.quantile(0.99),
                    "buckets": [[b, c] for b, c in m.cumulative()],
                }
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def reset(self) -> None:
        self._metrics.clear()
        self.generation += 1

    def __iter__(self):
        return iter(sorted(self._metrics.items()))


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def enabled() -> bool:
    return _ENABLED


def _set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def counter(name: str, **labels):
    """A live :class:`Counter` when telemetry is enabled, else the
    process-wide no-op stub (one branch on the disabled path)."""
    if not _ENABLED:
        return NULL_COUNTER
    return _REGISTRY.counter(name, labels)


def gauge(name: str, **labels):
    if not _ENABLED:
        return NULL_GAUGE
    return _REGISTRY.gauge(name, labels)


def histogram(name: str, boundaries: Sequence[float] = DEFAULT_BUCKETS,
              **labels):
    if not _ENABLED:
        return NULL_HISTOGRAM
    return _REGISTRY.histogram(name, labels, boundaries=boundaries)
